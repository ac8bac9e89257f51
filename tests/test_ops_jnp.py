"""jnp kernels (XLA path, CPU backend) vs ground truth."""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.core.patterns import PatternSet
from smatcher.engines import make_engine


def make_case(sigma, m, p_size, n, seed, frac_present=0.6):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p_size, m, ab, frac_present=frac_present, seed=seed + 1)
    return text, pats


CASES = [
    (2, 8, 16, 40_000),
    (4, 8, 64, 50_000),
    (4, 16, 32, 50_000),
    (4, 32, 16, 40_000),
    (20, 8, 48, 40_000),
    (20, 16, 24, 40_000),
    (128, 8, 16, 40_000),
]

TILE = 1 << 12     # small tile to exercise the fori_loop tiling on test sizes


@pytest.mark.parametrize("sigma,m,p_size,n", CASES)
@pytest.mark.parametrize("engine", ["ac", "sh", "sbom", "wm"])
def test_engine_counts(engine, sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=7 * sigma + m)
    expected = datagen.count_matches(text, pats)
    eng = make_engine(engine, pats, lanes=64, tile=TILE)
    assert eng.count(text) == expected


@pytest.mark.parametrize("sigma,m,p_size,n", [c for c in CASES if c[1] in (8, 16, 32)])
def test_sog_counts(sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=9 * sigma + m)
    expected = datagen.count_matches(text, pats)
    eng = make_engine(f"sog{m}", pats, tile=TILE)
    assert eng.count(text) == expected


@pytest.mark.parametrize("q", [2, 4])
def test_ac_multistep(q):
    text, pats = make_case(4, 8, 64, 50_000, seed=77)
    expected = datagen.count_matches(text, pats)
    eng = make_engine("ac", pats, lanes=64, q=q)
    assert eng.count(text) == expected


@pytest.mark.parametrize("lanes", [1, 8, 1024])
def test_ac_lane_invariance(lanes):
    text, pats = make_case(4, 16, 32, 30_000, seed=5)
    expected = datagen.count_matches(text, pats)
    eng = make_engine("ac", pats, lanes=lanes)
    assert eng.count(text) == expected


def test_ac_match_ends_positions():
    text, pats = make_case(4, 8, 32, 20_000, seed=13)
    starts = datagen.match_starts(text, pats)
    eng = make_engine("ac", pats, lanes=32)
    ends = eng.match_ends(text)
    assert ends.shape == (len(text),)
    got_starts = np.zeros_like(starts)
    idx = np.nonzero(ends)[0] - (pats.m - 1)
    got_starts[idx] = True
    assert np.array_equal(got_starts, starts)


def test_tile_boundary_exactness():
    """Matches straddling tile boundaries are counted exactly once."""
    ab = Alphabet.dna()
    m = 8
    pat = ab.encode(b"ACGTACGT")
    text = datagen.generate_text(4 * TILE, ab, seed=3)
    # plant across the first tile boundary and at corpus edges
    for s in (0, TILE - 7, TILE - 1, TILE, 2 * TILE - 4, 4 * TILE - m):
        text = datagen.plant(text, pat, [s])
    pats = PatternSet(pat[None, :], ab)
    expected = datagen.count_matches(text, pats)
    for name in ("wm", "sog8", "sh", "sbom"):
        eng = make_engine(name, pats, tile=TILE)
        assert eng.count(text) == expected, name
    eng = make_engine("ac", pats, lanes=64)
    assert eng.count(text) == expected


def test_empty_and_short_text():
    ab = Alphabet.dna()
    pats = PatternSet(np.zeros((2, 8), np.uint8), ab)
    for name in ("ac", "sh", "sbom", "wm", "sog8"):
        eng = make_engine(name, pats, tile=TILE)
        assert eng.count(np.zeros(0, np.uint8)) == 0
        assert eng.count(np.zeros(5, np.uint8)) == 0
