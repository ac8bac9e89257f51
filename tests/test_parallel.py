"""Distributed scans on the virtual 8-device CPU mesh: halo exchange over the
mesh axis + psum count reduction must be exact for every engine."""

import numpy as np
import pytest
import jax

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.core.patterns import PatternSet
from smatcher.engines import make_distributed
from smatcher.parallel import make_mesh


def make_case(sigma, m, p_size, n, seed):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p_size, m, ab, frac_present=0.6, seed=seed + 1)
    return text, pats


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("engine", ["ac", "wm", "sog8", "sh", "sbom"])
def test_distributed_count_exact(engine):
    sigma, m = 4, 8
    text, pats = make_case(sigma, m, 64, 200_000, seed=3)
    expected = datagen.count_matches(text, pats)
    mesh = make_mesh(8)
    dc = make_distributed(engine, pats, mesh, lanes=64, tile=1 << 12)
    assert dc.count(text) == expected


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_mesh_size_invariance(n_devices):
    text, pats = make_case(4, 16, 32, 120_000, seed=9)
    expected = datagen.count_matches(text, pats)
    mesh = make_mesh(n_devices)
    dc = make_distributed("ac", pats, mesh, lanes=32)
    assert dc.count(text) == expected


def test_boundary_straddling_matches():
    """Matches exactly straddling shard boundaries ride the halo exchange."""
    ab = Alphabet.dna()
    m = 8
    n = 80_000
    per = n // 8
    pat = ab.encode(b"ACGTTGCA")
    text = datagen.generate_text(n, ab, seed=17)
    plant_at = []
    for b in range(1, 8):
        plant_at += [b * per - m + 1, b * per - 1, b * per]
    plant_at.append(n - m)
    text = datagen.plant(text, pat, plant_at)
    pats = PatternSet(pat[None, :], ab)
    expected = datagen.count_matches(text, pats)
    # overlapping plants at one boundary overwrite each other; at least the
    # last plant per boundary + the corpus-end plant survive
    assert expected >= 8
    mesh = make_mesh(8)
    for engine in ("ac", "wm", "sbom"):
        dc = make_distributed(engine, pats, mesh, lanes=16, tile=1 << 12)
        assert dc.count(text) == expected, engine


def test_uneven_text_length():
    """n not divisible by the mesh: sigma-padding must not change counts."""
    text, pats = make_case(4, 8, 32, 100_003, seed=21)
    expected = datagen.count_matches(text, pats)
    mesh = make_mesh(8)
    dc = make_distributed("wm", pats, mesh, tile=1 << 12)
    assert dc.count(text) == expected


def test_distributed_count_async_pipelined():
    """count_async/scan_many keep the psum pair on device until result();
    batches equal per-text counts, including in sigma=256 wrap mode."""
    text, pats = make_case(4, 8, 32, 100_000, seed=27)
    expected = datagen.count_matches(text, pats)
    mesh = make_mesh(8)
    dc = make_distributed("wm", pats, mesh, tile=1 << 12)
    assert dc.scan_many([text, text]) == [expected, expected]
    f = dc.count_async(text)
    assert f.result() == expected

    text2, pats2 = make_case(256, 8, 16, 50_003, seed=28)
    expected2 = datagen.count_matches(text2, pats2)
    dc2 = make_distributed("wm", pats2, mesh, tile=1 << 12)
    assert dc2.scan_many([text2]) == [expected2]


@pytest.mark.parametrize("engine,n", [("wm", 100_003), ("fast", 100_003),
                                      ("ac", 80_000)])
def test_sigma256_wrap_correction(engine, n):
    """Byte alphabet: no out-of-alphabet pad exists — the cyclic-halo wrap
    overcount must be subtracted exactly (dist._wrap_overcount), including
    0-pad tails (uneven n) and matches at the very end of the corpus."""
    sigma, m = 256, 8
    text, pats = make_case(sigma, m, 32, n, seed=33)
    # plant a match flush against the corpus end (reads no pad, but its
    # window is the last valid start) and one one byte earlier
    text = datagen.plant(text, pats.codes[0], [n - m, n - m - 3])
    expected = datagen.count_matches(text, pats)
    assert expected >= 1
    mesh = make_mesh(8)
    dc = make_distributed(engine, pats, mesh, tile=1 << 12)
    assert dc.count(text) == expected


def test_sigma256_wrap_false_positive_subtracted():
    """A pattern that matches ONLY across the shard-0-wrap (tail ++ head)
    or in the 0-pad must not be counted: plant the wrap string's content
    as a pattern and check the subtraction removes it."""
    sigma, m = 256, 8
    ab = Alphabet.of_size(sigma)
    n = 80_000                        # divisible by 8: pure wrap, no pad
    text = datagen.generate_text(n, ab, seed=44)
    # pattern = last 4 bytes ++ first 4 bytes (the wrapped window at
    # global start n - 4): matches the cyclic view, not the corpus
    wrap_pat = np.concatenate([text[-4:], text[:4]]).astype(np.uint8)
    pats = PatternSet(wrap_pat[None, :], ab)
    expected = datagen.count_matches(text, pats)
    mesh = make_mesh(8)
    dc = make_distributed("wm", pats, mesh, tile=1 << 12)
    assert dc.count(text) == expected


def test_sigma256_explicit_n_on_numpy_input():
    """An explicit n= must win over the array length for numpy inputs: a
    host-side pre-padded byte corpus whose seam (text ++ 0-pad) spells a
    pattern must not count it (regression: n= was silently overwritten)."""
    sigma, m = 256, 8
    ab = Alphabet.of_size(sigma)
    n_true = 10_003
    text = datagen.generate_text(n_true, ab, seed=66)
    padded = np.zeros(10_008, np.uint8)
    padded[:n_true] = text
    seam_pat = np.concatenate([text[-3:], np.zeros(5, np.uint8)])
    pats = PatternSet(seam_pat[None, :].astype(np.uint8), ab)
    expected = datagen.count_matches(text, pats)        # over the TRUE text
    mesh = make_mesh(8)
    dc = make_distributed("wm", pats, mesh, tile=1 << 12)
    assert dc.count(padded, n=n_true) == expected

    from smatcher.engines import make_fast
    from smatcher.parallel.dist import DistributedPositions
    dp = DistributedPositions(make_fast(pats, backend="triton",
                                        interpret=True), mesh)
    got = dp.positions(padded, n=n_true)
    want = np.nonzero(datagen.match_starts(text, pats))[0]
    np.testing.assert_array_equal(got, want)


def test_sigma256_zero_pad_pattern_subtracted():
    """All-zero patterns match inside the 0-pad tail; the wrap correction
    must remove exactly those."""
    sigma, m = 256, 8
    ab = Alphabet.of_size(sigma)
    n = 100_003                       # 8 devices -> 101 pad bytes of 0
    text = datagen.generate_text(n, ab, seed=55)
    zero_pat = np.zeros((1, m), np.uint8)
    text = datagen.plant(text, zero_pat[0], [500, n - m])   # real zeros too
    pats = PatternSet(zero_pat, ab)
    expected = datagen.count_matches(text, pats)
    assert expected >= 2
    mesh = make_mesh(8)
    dc = make_distributed("wm", pats, mesh, tile=1 << 12)
    assert dc.count(text) == expected


def test_distributed_total_on_match_dense_overflow():
    """A match-dense corpus that trips the default candidate cap must count
    EXACTLY through the distributed retry ladder — no OverflowError (the
    reference's MPI_Reduce sums unconditionally at any density,
    main.c:656).  The raw flag stays observable via count_with_overflow."""
    from smatcher.engines import make_fast
    from smatcher.parallel.dist import DistributedCounter
    ab = Alphabet.of_size(4)
    text = datagen.generate_text(160_000, ab, seed=31)
    pats = datagen.generate_patterns(text, 32, 16, ab, frac_present=0.5,
                                     seed=32)
    # ~250 matches per 20K-start shard: past a 128-candidate cap (the
    # overflow flag), so the ladder splits each shard into pieces
    text = datagen.plant(text, pats.codes[0],
                         list(range(0, 160_000 - 16, 80)))
    expected = datagen.count_matches(text, pats)
    assert expected > 8 * 128       # dense enough to overflow cap=128
    mesh = make_mesh(8)
    fast = make_fast(pats, backend="triton", interpret=True, cap=128)
    dc = DistributedCounter(fast.core, mesh, m=pats.m, sigma=pats.sigma,
                            fast=fast)
    c, o = dc.count_with_overflow(text)
    assert o, "the raw flag must report the shard overflow"
    assert dc.count(text) == expected
    # without a ladder the legacy behavior (raise) is preserved
    dc_raw = DistributedCounter(fast.core, mesh, m=pats.m, sigma=pats.sigma)
    with pytest.raises(OverflowError):
        dc_raw.count(text)


def test_distributed_total_piece_fallback():
    """Density so extreme the dense shard pass also overflows: the piece
    loop (ladder step 2) must still produce the exact total."""
    from smatcher.engines import make_fast
    from smatcher.parallel.dist import DistributedCounter
    ab = Alphabet.dna()
    pats = PatternSet(np.zeros((1, 16), np.uint8), ab)       # 'A'*16
    text = np.zeros(120_000, np.uint8)                       # all matches
    expected = 120_000 - 15
    mesh = make_mesh(8)
    fast = make_fast(pats, backend="triton", interpret=True, cap=1024)
    dc = DistributedCounter(fast.core, mesh, m=pats.m, sigma=pats.sigma,
                            fast=fast)
    assert dc.count(text) == expected
