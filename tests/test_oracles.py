"""Conformance: every oracle counts exactly the ground-truth number of text
positions with >=1 pattern occurrence (the property the reference relies on
for correctness — equal counts across its CPU + 5 GPU implementations)."""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.oracles.reference import (
    oracle_ac, oracle_sh, oracle_sbom, oracle_wm,
    oracle_sog, ORACLES,
)


def make_case(sigma, m, p_size, n, seed, frac_present=0.6):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p_size, m, ab, frac_present=frac_present, seed=seed + 1)
    return text, pats


CASES = [
    # (sigma, m, p_size, n)
    (2, 8, 16, 4000),     # binary like the reference's random S2 corpus
    (4, 8, 32, 5000),     # DNA
    (4, 16, 24, 5000),
    (4, 32, 16, 5000),
    (20, 8, 32, 5000),    # protein
    (20, 16, 16, 4000),
    (128, 8, 16, 4000),   # english-ish
    (256, 8, 16, 4000),
]


@pytest.mark.parametrize("sigma,m,p_size,n", CASES)
def test_oracles_match_ground_truth(sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=sigma * 100 + m)
    expected = datagen.count_matches(text, pats)
    assert expected > 0, "test case should contain planted hits"

    got = {
        "ac": oracle_ac(text, pats.codes, sigma),
        "sh": oracle_sh(text, pats.codes, sigma),
        "sbom": oracle_sbom(text, pats.codes, sigma),
        "wm": oracle_wm(text, pats.codes, sigma),
    }
    if m in (8, 16, 32):
        got[f"sog{m}"] = oracle_sog(text, pats.codes, sigma, width=m)
    for name, count in got.items():
        assert count == expected, f"{name}: {count} != ground truth {expected}"


def test_debug_corpus_binary():
    """A tiny n=100 binary fixture like the reference's debug corpus (main.c:111-118)."""
    rng = np.random.default_rng(0)
    text = rng.integers(0, 2, size=100, dtype=np.uint8)
    pats = np.array([[0, 1] * 4, [1] * 8], dtype=np.uint8)
    expected = datagen.count_matches(text, pats)
    assert oracle_ac(text, pats, 2) == expected
    assert oracle_sh(text, pats, 2) == expected
    assert oracle_sbom(text, pats, 2) == expected
    assert oracle_wm(text, pats, 2) == expected
    assert oracle_sog(text, pats, 2, width=8) == expected


def test_duplicate_and_overlapping_patterns():
    """Duplicate patterns and self-overlapping patterns still count <=1 per position."""
    ab = Alphabet.dna()
    text = ab.encode(b"AAAAAAAAAACGCGCGCGCG")
    pats = np.stack([
        ab.encode(b"AAAA"),
        ab.encode(b"AAAA"),          # duplicate
        ab.encode(b"CGCG"),
        ab.encode(b"GCGC"),
    ])
    expected = datagen.count_matches(text, pats)
    for name in ("ac", "sh", "sbom", "wm"):
        assert ORACLES[name](text, pats, 4) == expected, name


def test_no_matches():
    ab = Alphabet.dna()
    text = np.zeros(500, np.uint8)                  # all 'A'
    pats = np.tile(ab.encode(b"CGTTGCAA"), (3, 1))  # never occurs
    for name in ("ac", "sh", "sbom", "wm", "sog8"):
        assert ORACLES[name](text, pats, 4) == 0, name


def test_planted_positions_counted_once():
    ab = Alphabet.dna()
    text = datagen.generate_text(2000, ab, seed=7)
    pat = ab.encode(b"ACGTACGT")
    text = datagen.plant(text, pat, [0, 100, 200, 1992])
    pats = pat[None, :]
    expected = datagen.count_matches(text, pats)
    assert expected >= 4
    for name in ("ac", "sh", "sbom", "wm", "sog8"):
        assert ORACLES[name](text, pats, 4) == expected, name
