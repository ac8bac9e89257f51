"""KMP / BM preprocessing parity (reference kmp/kmp.c:140-158, bm/bm.c:19-29)."""

import numpy as np
import pytest

from smatcher.automata.kmp import pre_kmp, kmp_count
from smatcher.automata.bm import pre_bm_bc
from smatcher.automata import build_sh


def _border(p, i):
    """Length of the longest proper border of p[:i]."""
    for b in range(i - 1, -1, -1):
        if (p[:b] == p[i - b:i]).all():
            return b
    return 0


def _naive_next(p):
    """Optimized KMP next table computed from the definition: next[i] is the
    longest proper border b of p[:i] with p[b] != p[i], chained; -1 if the
    chain empties (next[m] is the plain border length)."""
    m = len(p)
    nxt = np.empty(m + 1, np.int64)
    nxt[0] = -1
    for i in range(1, m + 1):
        b = _border(p, i)
        while i < m and b >= 0 and p[b] == p[i]:
            b = _border(p, b) if b > 0 else -1
        nxt[i] = b
    return nxt


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sigma", [2, 4, 20])
def test_pre_kmp_matches_definition(seed, sigma):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 24))
    p = rng.integers(0, sigma, m).astype(np.uint8)
    got = pre_kmp(p)
    want = _naive_next(p)
    np.testing.assert_array_equal(got, want)


def test_pre_kmp_known():
    # classic example: p = "ababaa" over {a=0, b=1}
    p = np.array([0, 1, 0, 1, 0, 0], np.uint8)
    np.testing.assert_array_equal(pre_kmp(p), [-1, 0, -1, 0, -1, 3, 1])


@pytest.mark.parametrize("seed", range(5))
def test_kmp_count_matches_naive(seed):
    rng = np.random.default_rng(100 + seed)
    sigma = int(rng.choice([2, 4]))
    m = int(rng.integers(1, 9))
    p = rng.integers(0, sigma, m).astype(np.uint8)
    t = rng.integers(0, sigma, 4000).astype(np.uint8)
    naive = sum(1 for i in range(len(t) - m + 1) if (t[i:i + m] == p).all())
    assert kmp_count(p, t) == naive


def test_pre_bm_bc_matches_definition():
    rng = np.random.default_rng(7)
    sigma, p, m = 20, 50, 12
    pats = rng.integers(0, sigma, (p, m)).astype(np.uint8)
    got = pre_bm_bc(pats, sigma)
    want = np.full(sigma, m, np.int64)
    for j in range(p):
        for i in range(m - 1):
            want[pats[j, i]] = min(want[pats[j, i]], m - 1 - i)
    np.testing.assert_array_equal(got, want)


def test_sh_tables_carry_bm_bc():
    rng = np.random.default_rng(9)
    pats = rng.integers(0, 4, (20, 8)).astype(np.uint8)
    sh = build_sh(pats, 4)
    np.testing.assert_array_equal(sh.bmBc, pre_bm_bc(pats, 4))


def test_pattern_set_from_fasta(tmp_path):
    from smatcher.core.alphabet import Alphabet
    from smatcher.core.patterns import PatternSet
    fa = tmp_path / "p.fa"
    fa.write_bytes(b">a\nACGT\nACGT\n>b\nTTTTACGT\n>c desc\nacgtacgt\n")
    ps = PatternSet.from_fasta(str(fa), Alphabet.dna())
    assert ps.p_size == 3 and ps.m == 8
    np.testing.assert_array_equal(ps.codes[2], [0, 1, 2, 3, 0, 1, 2, 3])
