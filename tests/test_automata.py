"""Table builders + dense numpy scan blueprints vs oracles/ground truth."""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.automata import (
    build_ac, build_sh, build_sbom, build_wm, build_sog, build_verify,
)
from smatcher.automata.ac import multi_step_tables
from smatcher.ops import numpy_ref as nref
from smatcher.oracles.reference import oracle_ac


def make_case(sigma, m, p_size, n, seed, frac_present=0.6):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p_size, m, ab, frac_present=frac_present, seed=seed + 1)
    return text, pats


CASES = [
    (2, 8, 16, 6000),
    (4, 8, 64, 8000),
    (4, 16, 32, 8000),
    (4, 32, 16, 6000),
    (20, 8, 48, 6000),
    (20, 16, 24, 6000),
    (128, 8, 16, 6000),
]


@pytest.mark.parametrize("sigma,m,p_size,n", CASES)
def test_ac_tables_and_scans(sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=11 * sigma + m)
    expected = datagen.count_matches(text, pats)
    ac = build_ac(pats.codes, sigma)
    # completed-DFA lane scan
    assert nref.scan_ac_np(text, ac, lanes=16) == expected
    assert nref.scan_ac_np(text, ac, lanes=1) == expected
    # flat-ABI failure-chain scan (small slice — slow python loop)
    assert nref.scan_ac_flat_np(text[:1500], ac) == oracle_ac(text[:1500], pats.codes, sigma)
    # table invariants
    assert ac.transition[0].min() >= 0          # root row has no -1
    assert (ac.delta >= 0).all() and (ac.delta < ac.n_states).all()
    assert ac.final[0] == 0
    assert (ac.delta[:, sigma] == 0).all()      # pad column resets to root


@pytest.mark.parametrize("q", [2, 3, 4])
def test_ac_multistep_counts(q):
    sigma = 4
    text, pats = make_case(sigma, 8, 32, 4096, seed=5)
    expected = datagen.count_matches(text, pats)
    ac = build_ac(pats.codes, sigma)
    table, cbits = multi_step_tables(ac, q)
    sig_p = sigma + 1
    # pad text to a multiple of q with the reset symbol and scan q chars/step
    n = len(text)
    steps = -(-n // q)
    padded = np.full(steps * q, sigma, np.uint8)
    padded[:n] = text
    digits = padded.reshape(steps, q).astype(np.int64)
    grams = np.zeros(steps, dtype=np.int64)
    for j in range(q):
        grams = grams * sig_p + digits[:, j]
    s = 0
    count = 0
    flat = table.reshape(ac.n_states, -1)
    for t in range(steps):
        v = int(flat[s, grams[t]])
        count += v & ((1 << cbits) - 1)
        s = v >> cbits
    assert count == expected


@pytest.mark.parametrize("sigma,m,p_size,n", CASES)
def test_sh_dense_scan(sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=23 * sigma + m)
    expected = datagen.count_matches(text, pats)
    sh = build_sh(pats.codes, sigma)
    assert nref.scan_sh_np(text, sh) == expected


@pytest.mark.parametrize("sigma,m,p_size,n", CASES)
def test_sbom_dense_scan(sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=31 * sigma + m)
    expected = datagen.count_matches(text, pats)
    sb = build_sbom(pats.codes, sigma)
    vt = build_verify(pats.codes, sigma)
    assert nref.scan_sbom_np(text, sb, vt) == expected


@pytest.mark.parametrize("sigma,m,p_size,n", CASES)
def test_wm_dense_scan(sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=41 * sigma + m)
    expected = datagen.count_matches(text, pats)
    wm = build_wm(pats.codes, sigma)
    vt = build_verify(pats.codes, sigma)
    assert nref.scan_wm_np(text, wm, vt) == expected


@pytest.mark.parametrize("sigma,m,p_size,n", [c for c in CASES if c[1] in (8, 16, 32)])
def test_sog_dense_scan(sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=53 * sigma + m)
    expected = datagen.count_matches(text, pats)
    sog = build_sog(pats.codes, sigma)
    vt = build_verify(pats.codes, sigma)
    assert nref.scan_sog_np(text, sog, vt) == expected


def test_adversarial_shared_suffix():
    """Many patterns sharing the last 3-gram stress the bucket padding."""
    ab = Alphabet.dna()
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, size=(40, 8)).astype(np.uint8)
    base[:, 5:] = ab.encode(b"ACG")          # all share last gram
    text = datagen.generate_text(6000, ab, seed=4)
    text = datagen.plant(text, base[7], [100, 200, 300])
    expected = datagen.count_matches(text, base)
    wm = build_wm(base, 4)
    vt = build_verify(base, 4)
    assert vt.lmax >= 30
    assert nref.scan_wm_np(text, wm, vt) == expected
    sb = build_sbom(base, 4)
    assert nref.scan_sbom_np(text, sb, vt) == expected
    sog = build_sog(base, 4)
    assert nref.scan_sog_np(text, sog, vt) == expected


def test_text_shorter_than_pattern():
    pats = np.zeros((2, 8), np.uint8)
    ac = build_ac(pats, 4)
    assert nref.scan_ac_np(np.zeros(5, np.uint8), ac) == 0
