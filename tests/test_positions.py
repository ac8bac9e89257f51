"""Match-position reporting (FastScanner.positions) vs the numpy oracle."""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.engines import make_fast


def _positions_oracle(text, pats):
    return np.nonzero(np.asarray(datagen.match_starts(text, pats)))[0].astype(np.int64)


@pytest.mark.parametrize("sigma,m", [(4, 8), (2, 12)])
def test_positions_exact_tier(sigma, m):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(60_000, ab, seed=31)
    pats = datagen.generate_patterns(text, 40, m, ab, frac_present=0.6, seed=32)
    eng = make_fast(pats, backend="triton", interpret=True, tile=1 << 12)
    assert eng.ft.exact
    got = eng.positions(text)
    np.testing.assert_array_equal(got, _positions_oracle(text, pats))


@pytest.mark.parametrize("sigma,m", [(4, 16), (20, 32)])
def test_positions_fp_tier(sigma, m):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(60_000, ab, seed=33)
    pats = datagen.generate_patterns(text, 60, m, ab, frac_present=0.6, seed=34)
    eng = make_fast(pats, backend="triton", interpret=True, tile=1 << 12)
    assert not eng.ft.exact
    got = eng.positions(text)
    np.testing.assert_array_equal(got, _positions_oracle(text, pats))


def test_positions_unbounded_dense():
    """Every window matches (all-zero text + all-zero pattern): positions
    must stream ALL of them by splitting pieces past the device cap — the
    reference corpora it mirrors (random2) carry millions of matches."""
    ab = Alphabet.dna()
    text = np.zeros(8_192, np.uint8)
    pats_codes = np.zeros((1, 8), np.uint8)
    from smatcher.core.patterns import PatternSet
    pats = PatternSet(pats_codes, ab)
    eng = make_fast(pats, backend="triton", interpret=True, cap=256)
    got = eng.positions(text)
    np.testing.assert_array_equal(got, np.arange(8_192 - 7, dtype=np.int64))


@pytest.mark.parametrize("sigma,m", [(4, 8), (20, 32)])
def test_positions_xla_backend(sigma, m):
    """positions() on the plain XLA path (both tiers)."""
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(60_000, ab, seed=36)
    pats = datagen.generate_patterns(text, 50, m, ab, frac_present=0.6,
                                     seed=37)
    eng = make_fast(pats, backend="xla")
    got = eng.positions(text)
    np.testing.assert_array_equal(got, _positions_oracle(text, pats))


def test_positions_xla_dense_chunked():
    ab = Alphabet.of_size(2)
    text = np.zeros(20_000, np.uint8)
    from smatcher.core.patterns import PatternSet
    pats = PatternSet(np.zeros((1, 12), np.uint8), ab)
    eng = make_fast(pats, backend="xla", cap=512)
    got = eng.positions(text, chunk=700)
    np.testing.assert_array_equal(got, np.arange(20_000 - 11, dtype=np.int64))


def test_positions_short_text():
    ab = Alphabet.dna()
    pats = datagen.generate_patterns(
        datagen.generate_text(100, ab, seed=1), 4, 8, ab, seed=2)
    eng = make_fast(pats, backend="triton", interpret=True)
    assert eng.positions(np.zeros(3, np.uint8)).size == 0


def test_engine_positions_via_fastpath():
    from smatcher.engines import make_engine
    ab = Alphabet.dna()
    text = datagen.generate_text(40_000, ab, seed=35)
    pats = datagen.generate_patterns(text, 40, 8, ab, frac_present=0.6, seed=36)
    want = _positions_oracle(text, pats)
    for name in ("ac", "wm", "sog8"):
        eng = make_engine(name, pats, backend="triton", interpret=True)
        np.testing.assert_array_equal(eng.positions(text), want)


def test_engine_positions_fp_tier():
    from smatcher.engines import make_engine
    ab = Alphabet.protein()
    text = datagen.generate_text(40_000, ab, seed=37)
    pats = datagen.generate_patterns(text, 40, 32, ab, frac_present=0.6, seed=38)
    want = _positions_oracle(text, pats)
    for name in ("sh", "wm"):
        eng = make_engine(name, pats, backend="triton", interpret=True)
        np.testing.assert_array_equal(eng.positions(text), want)


def test_engine_positions_unbounded_dense():
    """Engine positions past the device cap must go through the shared
    split-on-overflow pipeline and enumerate EVERYTHING — the reference
    engines' column loops are unbounded (cuda_wm.cu:136-176).  Covers both
    tiers."""
    from smatcher.core.patterns import PatternSet
    from smatcher.engines import make_engine
    for sigma, m in ((4, 8), (20, 32)):           # exact tier / fp tier
        ab = Alphabet.of_size(sigma)
        text = np.zeros(6_000, np.uint8)          # every start matches
        pats = PatternSet(np.zeros((1, m), np.uint8), ab)
        eng = make_engine("wm", pats, backend="triton", interpret=True,
                          cap=512)                # far below the matches
        got = eng.positions(text)
        np.testing.assert_array_equal(
            got, np.arange(6_000 - m + 1, dtype=np.int64))


def test_positions_file_streaming():
    """positions_file = positions of the whole file, streamed in (m-1)-halo
    pieces (including a boundary-straddling match and a piece-boundary
    dense region) — the file analogue of count_file."""
    import os
    import tempfile
    ab = Alphabet.dna()
    text = datagen.generate_text(50_000, ab, seed=61)
    pats = datagen.generate_patterns(text, 40, 8, ab, frac_present=0.6,
                                     seed=62)
    # plant a match straddling the 13_000-byte piece boundary
    text = datagen.plant(text, pats.codes[0], [12_997, 25_999])
    want = _positions_oracle(text, pats)
    with tempfile.NamedTemporaryFile(delete=False) as fh:
        fh.write(np.asarray(text).tobytes())
        path = fh.name
    try:
        eng = make_fast(pats, backend="xla")
        np.testing.assert_array_equal(eng.positions_file(path, chunk=13_000),
                                      want)
        from smatcher.engines import make_engine
        wm = make_engine("wm", pats, backend="triton", interpret=True, tile=1 << 12)
        np.testing.assert_array_equal(wm.positions_file(path, chunk=13_000),
                                      want)
    finally:
        os.unlink(path)


def test_matches_attribution():
    """matches() returns (positions, pattern_ids); smallest id on duplicate
    patterns; every id's pattern equals the window at its position."""
    from smatcher.core.patterns import PatternSet
    ab = Alphabet.dna()
    text = datagen.generate_text(40_000, ab, seed=71)
    pats = datagen.generate_patterns(text, 30, 8, ab, frac_present=0.7,
                                     seed=72)
    # duplicate pattern 3 at the end: ids must still report 3, not 30
    codes = np.vstack([pats.codes, pats.codes[3:4]])
    pats = PatternSet(codes, ab)
    text = np.asarray(datagen.plant(text, codes[3], [123]))
    eng = make_fast(pats, backend="xla")
    pos, ids = eng.matches(text)
    np.testing.assert_array_equal(pos, _positions_oracle(text, pats))
    win = text[np.asarray(pos)[:, None] + np.arange(8)]
    np.testing.assert_array_equal(win, codes[ids])
    assert ids.max() < 30                      # duplicate reports min id
    assert 123 in pos and ids[list(pos).index(123)] == 3

    from smatcher.engines import make_engine
    wm = make_engine("wm", pats, backend="triton", interpret=True)
    pos2, ids2 = wm.matches(text)
    np.testing.assert_array_equal(pos2, pos)
    np.testing.assert_array_equal(ids2, ids)

    non_match = next(i for i in range(1000) if i not in set(pos.tolist()))
    with pytest.raises(ValueError):
        datagen.match_ids(text, np.array([non_match]), pats)


def test_distributed_positions():
    """Per-shard compaction + global offsets equals the oracle positions."""
    from smatcher.parallel import make_mesh
    from smatcher.parallel.dist import DistributedPositions
    mesh = make_mesh(4)
    # small corpora: the interpreted kernel per shard is slow, and
    # straggling shards can trip XLA's collective-rendezvous timeout in CI
    for sigma, m, n in [(4, 8, 12_005), (20, 32, 4_005)]:
        ab = Alphabet.of_size(sigma)
        text = datagen.generate_text(n, ab, seed=45)
        pats = datagen.generate_patterns(text, 30, m, ab, frac_present=0.6,
                                         seed=46)
        fast = make_fast(pats, backend="triton", interpret=True)
        dp = DistributedPositions(fast, mesh)
        np.testing.assert_array_equal(dp.positions(text),
                                      _positions_oracle(text, pats))


@pytest.mark.parametrize("sigma,m,n", [(4, 8, 40_005), (20, 32, 40_005),
                                       (256, 8, 20_003)])
def test_distributed_positions_xla_eight_devices(sigma, m, n):
    """DistributedPositions on the 8-device mesh with the plain XLA piece
    scan (no interpreter anywhere): global positions == the oracle."""
    from smatcher.parallel import make_mesh
    from smatcher.parallel.dist import DistributedPositions
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=m + sigma)
    pats = datagen.generate_patterns(text, 40, m, ab, frac_present=0.6,
                                     seed=m + sigma + 1)
    per = -(-n // 8)
    text = datagen.plant(text, pats.codes[0], [per - m // 2, n - m])
    dp = DistributedPositions(make_fast(pats, backend="xla"), make_mesh(8))
    np.testing.assert_array_equal(dp.positions(text),
                                  _positions_oracle(text, pats))


def test_engine_matches_device_route_xla():
    """Engine positions/matches/per-pattern counts go through the engine's
    device scanner (a FastScanner over its codes) on the XLA backend too,
    and agree with the fast engine."""
    from smatcher.engines import make_engine
    from smatcher.ops.common import engine_scanner
    from smatcher.ops.fast import FastScanner
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(30_000, ab, seed=93)
    pats = datagen.generate_patterns(text, 30, 12, ab, frac_present=0.7,
                                     seed=94)
    want_pos, want_ids = make_fast(pats, backend="xla").matches(text)
    for name in ("ac", "sbom", "sh"):
        eng = make_engine(name, pats, backend="xla")
        pos, ids = eng.matches(text)
        assert isinstance(engine_scanner(eng), FastScanner)
        np.testing.assert_array_equal(pos, want_pos)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(eng.positions(text), want_pos)
        assert eng.count_per_pattern(text).sum() == len(want_pos)


def test_distributed_positions_unbounded_dense():
    """Dense matches exceed the per-device cap: pieces must split and the
    full match set still streams out (no global cap)."""
    from smatcher.core.patterns import PatternSet
    from smatcher.parallel import make_mesh
    from smatcher.parallel.dist import DistributedPositions
    mesh = make_mesh(4)
    ab = Alphabet.dna()
    text = np.zeros(8_192, np.uint8)
    pats = PatternSet(np.zeros((1, 8), np.uint8), ab)
    fast = make_fast(pats, backend="triton", interpret=True, cap=256)
    dp = DistributedPositions(fast, mesh)
    got = dp.positions(text)
    np.testing.assert_array_equal(got, np.arange(8_192 - 7, dtype=np.int64))


def test_distributed_positions_sigma256_wrap():
    """Byte alphabet: wrap/pad junk positions (global start >= n-m+1) are
    filtered; true positions — including one at the last valid start —
    survive."""
    from smatcher.core.patterns import PatternSet
    from smatcher.parallel import make_mesh
    from smatcher.parallel.dist import DistributedPositions
    mesh = make_mesh(4)
    sigma, m, n = 256, 8, 4_003           # uneven: exercises the 0-pad too
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=49)
    pats = datagen.generate_patterns(text, 20, m, ab, frac_present=0.6,
                                     seed=50)
    text = datagen.plant(text, pats.codes[0], [n - m])
    fast = make_fast(pats, backend="triton", interpret=True)
    dp = DistributedPositions(fast, mesh)
    got = dp.positions(text)
    np.testing.assert_array_equal(got, _positions_oracle(text, pats))
    assert (n - m) in got


def test_distributed_positions_chunked():
    from smatcher.parallel import make_mesh
    from smatcher.parallel.dist import DistributedPositions
    mesh = make_mesh(4)
    ab = Alphabet.of_size(4)
    text = datagen.generate_text(12_005, ab, seed=47)
    pats = datagen.generate_patterns(text, 30, 8, ab, frac_present=0.6,
                                     seed=48)
    fast = make_fast(pats, backend="triton", interpret=True, cap=1024)
    dp = DistributedPositions(fast, mesh)
    np.testing.assert_array_equal(dp.positions(text, chunk=700),
                                  _positions_oracle(text, pats))


def test_count_per_pattern():
    """count_per_pattern() is the matches() histogram: sums to count(),
    equals a brute-force per-pattern occurrence count (duplicates credited
    to the smallest id), and works on engines and mixed sets."""
    from smatcher.core.patterns import PatternSet
    ab = Alphabet.dna()
    text = datagen.generate_text(40_000, ab, seed=81)
    pats = datagen.generate_patterns(text, 25, 8, ab, frac_present=0.7,
                                     seed=82)
    eng = make_fast(pats, backend="xla")
    per = eng.count_per_pattern(text)
    assert per.shape == (25,) and per.sum() == eng.count(text)
    # brute force: occurrences of each pattern as a window (duplicates
    # would be credited to the smallest id; this set has none)
    win = np.lib.stride_tricks.sliding_window_view(np.asarray(text), 8)
    for i, pat in enumerate(pats.codes):
        assert per[i] == int((win == pat).all(axis=1).sum())

    from smatcher.engines import make_engine
    wm = make_engine("wm", pats, backend="triton", interpret=True)
    np.testing.assert_array_equal(wm.count_per_pattern(text), per)


def test_count_per_pattern_mixed():
    from smatcher.core.patterns import MixedPatternSet
    from smatcher.engines import make_mixed
    ab = Alphabet.dna()
    text = datagen.generate_text(30_000, ab, seed=83)
    rng = np.random.default_rng(84)
    rows = []
    for m in (5, 8, 11):
        for _ in range(6):
            s = rng.integers(0, len(text) - m + 1)
            rows.append(np.asarray(text[s:s + m], np.uint8))
    order = rng.permutation(len(rows))
    mx = MixedPatternSet.from_rows([rows[i] for i in order], ab)
    sc = make_mixed(mx, backend="xla")
    per = sc.count_per_pattern(text)
    assert per.shape == (18,) and per.sum() == sc.count(text)
    for i, pat in enumerate([rows[j] for j in order]):
        m = len(pat)
        win = np.lib.stride_tricks.sliding_window_view(np.asarray(text), m)
        brute = int((win == pat).all(axis=1).sum())
        # duplicates inside a length group credit the smallest global id
        dup = [j for j, q in enumerate([rows[k] for k in order])
               if len(q) == m and np.array_equal(q, pat)]
        if dup[0] == i:
            assert per[i] == brute
        else:
            assert per[i] == 0


def test_count_per_pattern_dense_wid_histogram():
    """Match-dense exact-tier corpora route count_per_pattern through the
    enumeration-free wid-histogram path (fast._exact_hist: one device sort
    of the window ids, counts pushed through the wid->pid table) instead
    of cap-sized attribution pieces — 61 s -> 0.48 s on the reference's
    13.4M-match A_thaliana.fna p=8000 cell.  Parity with both the piece
    path and the host oracle, including duplicate-pattern credit."""
    ab = Alphabet.dna()
    text = datagen.generate_text(100_000, ab, seed=91)
    pats = datagen.generate_patterns(text, 400, 8, ab, frac_present=0.9,
                                     seed=92)
    # duplicate a pattern: credit must go to the smallest original id
    codes = np.array(pats.codes)
    codes[37] = codes[11]
    from smatcher.core.patterns import PatternSet
    pats = PatternSet(codes, ab)
    truth = datagen.count_matches(text, pats)
    dense = make_fast(pats, backend="xla", tile=1 << 13, cap=256)
    assert truth > dense.cap // 2          # the dense branch is taken
    per = dense.count_per_pattern(text)
    assert int(per.sum()) == truth
    assert per[37] == 0                    # duplicate credited to id 11
    sparse = make_fast(pats, backend="xla", tile=1 << 13)
    np.testing.assert_array_equal(
        np.asarray(sparse.count_per_pattern(text)), np.asarray(per))
    starts = np.nonzero(datagen.match_starts(text, pats))[0]
    ids = datagen.match_ids(text, starts, pats)
    want = np.zeros(pats.p_size, np.int64)
    np.add.at(want, ids, 1)
    np.testing.assert_array_equal(np.asarray(per), want)
