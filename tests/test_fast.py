"""Fast backend (ops/fast.py + ops/triton_filter.py) vs ground truth."""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.core.patterns import PatternSet
from smatcher.engines import make_fast
from smatcher.ops.fast import build_fast, exact_wid_supported


def make_case(sigma, m, p_size, n, seed):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p_size, m, ab, frac_present=0.6, seed=seed + 1)
    return text, pats


CASES = [
    (2, 8, 16, 120_000),     # exact tier (2^8 ids)
    (2, 16, 16, 120_000),    # exact tier (2^16 ids)
    (4, 8, 200, 120_000),    # exact tier (4^8 ids)
    (4, 16, 64, 120_000),    # fp tier
    (4, 32, 32, 120_000),    # fp tier
    (20, 8, 64, 120_000),    # fp tier
    (128, 8, 32, 120_000),   # fp tier
]


@pytest.mark.parametrize("sigma,m,p_size,n", CASES)
def test_fast_xla_counts(sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=3 * sigma + m)
    expected = datagen.count_matches(text, pats)
    eng = make_fast(pats, tile=1 << 14, cap=1 << 12, backend="xla")
    assert eng.ft.exact == exact_wid_supported(sigma, m)
    assert eng.count(text) == expected


@pytest.mark.parametrize("sigma,m,p_size,n", [(4, 8, 64, 40_000), (4, 16, 32, 40_000)])
def test_fast_pallas_interpret(sigma, m, p_size, n):
    """The Triton kernel in interpreter mode (CPU) — tiny sizes."""
    text, pats = make_case(sigma, m, p_size, n, seed=99)
    expected = datagen.count_matches(text, pats)
    eng = make_fast(pats, cap=1 << 12, backend="triton", interpret=True)
    assert eng.count(text) == expected


def test_overflow_flag():
    """A degenerate corpus (all matches) must flag overflow on the raw
    (count, overflow) API — never a silent undercount — while the public
    count() falls back to budget-sized pieces and still counts exactly."""
    ab = Alphabet.dna()
    pats = PatternSet(np.zeros((1, 16), np.uint8), ab)   # 'A'*16
    text = np.zeros(40_000, np.uint8)                    # everything matches
    eng = make_fast(pats, tile=1 << 14, cap=1 << 8, backend="xla")
    c, o = eng.count_with_overflow(text)
    assert o, "overflow must be reported"
    assert eng.count(text) == 40_000 - 15


def test_exact_tier_degenerate_ok():
    """Exact tier has no cap: degenerate corpora still count exactly."""
    ab = Alphabet.dna()
    pats = PatternSet(np.zeros((1, 8), np.uint8), ab)
    text = np.zeros(40_000, np.uint8)
    expected = datagen.count_matches(text, pats.codes)
    eng = make_fast(pats, backend="xla")
    assert eng.ft.exact
    assert eng.count(text) == expected


def test_fast_distributed_core():
    """Fast core composes with the distribution layer."""
    import jax
    from smatcher.parallel import make_mesh
    from smatcher.parallel.dist import DistributedCounter
    text, pats = make_case(4, 8, 64, 150_000, seed=31)
    expected = datagen.count_matches(text, pats)
    eng = make_fast(pats, tile=1 << 14, backend="xla")
    mesh = make_mesh(8)
    dc = DistributedCounter(eng.core, mesh, m=pats.m, sigma=pats.sigma)
    assert dc.count(text) == expected


def test_stage_budget_reachable():
    """Enough derived stages are built that filtering always reaches the
    candidate budget, even on the largest supported scan (the stage count
    is chosen by a cost model, so per-stage fill may exceed the old 0.30
    bound — what must hold is that the stage PRODUCT gets there)."""
    import numpy as np
    from smatcher.ops.fast import build_fast, stages_for, DEFAULT_CAP
    rng = np.random.default_rng(5)
    for p in (100, 2048, 10_000):
        pats = rng.integers(0, 20, (p, 16)).astype(np.uint8)
        ft = build_fast(pats, 20)
        assert 0 < ft.density < 0.9
        # all-stage filtering reaches the budget even for a 1 GiB corpus
        k = stages_for(ft, 1 << 30, DEFAULT_CAP)
        assert (1 << 30) * ft.density ** k <= DEFAULT_CAP / 4
        # the per-row occupancy criterion holds too
        assert ft.density ** k <= 1 / 256


def test_count_file_streaming(tmp_path):
    """Chunked file scan equals the in-memory count (halo'd chunk split)."""
    import numpy as np
    from smatcher.core.alphabet import Alphabet
    from smatcher.core import datagen
    from smatcher.engines import make_fast
    ab = Alphabet.dna()
    text = datagen.generate_text(100_003, ab, seed=41)
    pats = datagen.generate_patterns(text, 60, 8, ab, frac_present=0.6, seed=42)
    path = tmp_path / "c.bin"
    text.tofile(path)
    eng = make_fast(pats, backend="xla", tile=1 << 12)
    want = datagen.count_matches(text, pats)
    assert eng.count_file(str(path), chunk=1 << 14) == want
    assert eng.count_file(str(path), chunk=1 << 20) == want   # single chunk


def test_long_patterns_fall_back_to_xla(tmp_path):
    """m = 200 (past the kernel's unrolled fingerprint loop) counts
    exactly on both backends."""
    import numpy as np
    from smatcher.core.alphabet import Alphabet
    from smatcher.core import datagen
    from smatcher.engines import make_fast
    ab = Alphabet.protein()
    text = datagen.generate_text(30_000, ab, seed=43)
    pats = datagen.generate_patterns(text, 20, 200, ab, frac_present=0.6, seed=44)
    eng = make_fast(pats, backend="triton", interpret=True, tile=1 << 12)
    assert eng.count(text) == datagen.count_matches(text, pats)
    assert make_fast(pats, backend="xla", tile=1 << 12).count(text) == \
        datagen.count_matches(text, pats)


def test_slot_overflow_falls_back_exact():
    """Dense-match corpora overflow the candidate cap; the async path must
    transparently retry to an exact count (never undercount)."""
    ab = Alphabet.protein()   # sigma=20: fp tier even at m=8
    pats = PatternSet(np.zeros((1, 8), np.uint8), ab)
    text = np.zeros(50_000, np.uint8)                 # every window matches
    eng = make_fast(pats, backend="triton", interpret=True, cap=1 << 12)
    assert eng.count_async(text).result() == 50_000 - 7


def test_flat_layout_multi_view_long_m():
    """m > 64: the kernel's fingerprint loop runs as a fori_loop."""
    for m in (130, 256):
        text, pats = make_case(4, m, 16, 70_000, seed=24)
        eng = make_fast(pats, backend="triton", interpret=True)
        assert eng.count(text) == datagen.count_matches(text, pats)


def _wide_case(frac_present, n=1 << 16, p=3000, m=32, seed=5):
    """A pattern set dense enough against a forced 32768-bit stage space
    that the candidate budget is tight — the CPU-scale stand-in for the
    reference's saturating p >= 30k sets (main.c:372-373)."""
    from smatcher.ops.fast import build_fast
    ab = Alphabet.of_size(4)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p, m, ab,
                                     frac_present=frac_present, seed=seed + 1)
    ft = build_fast(pats.codes, pats.sigma, stage_bits=32768)
    return text, pats, ft


def test_cascade_scanner_routing_and_fallback():
    """A saturating stage space: the sparse corpus counts exactly with no
    retry; a match-dense one overflows the candidate cap and the retry
    ladder still returns the exact count (totality)."""
    from smatcher.ops.fast import FastScanner
    text, pats, ft = _wide_case(frac_present=0.02)
    eng = FastScanner(ft, cap=1 << 14, backend="triton", interpret=True)
    assert eng.count(text) == datagen.count_matches(text, pats)
    assert eng._retries == 0
    text2, pats2, ft2 = _wide_case(frac_present=0.5)
    eng2 = FastScanner(ft2, cap=1 << 10, backend="triton", interpret=True)
    assert eng2.count(text2) == datagen.count_matches(text2, pats2)
    assert eng2._retries == 1


def test_count_stack_parity():
    """A batch of equal-length texts through scan_many == per-text counts
    across tiers, including a planted straddler across two rows (which
    must NOT count: rows are separate texts)."""
    ab = Alphabet.of_size(4)
    nsh, k = 30_000, 3
    texts = [datagen.generate_text(nsh, ab, seed=s) for s in (1, 2, 3)]
    batch = np.stack(texts)
    for m, p in ((8, 100), (16, 64)):
        pats = datagen.generate_patterns(np.concatenate(texts), p, m, ab,
                                         frac_present=0.3, seed=9 + m)
        truth = [datagen.count_matches(t, pats) for t in texts]
        eng = make_fast(pats, backend="triton", interpret=True)
        assert eng.scan_many(batch) == truth
    pats = datagen.generate_patterns(np.concatenate(texts), 64, 16, ab,
                                     frac_present=0.3, seed=77)
    t2 = batch.copy()
    t2[0, -8:] = pats.codes[0][:8]
    t2[1, :8] = pats.codes[0][8:]
    truth = [datagen.count_matches(t2[i], pats) for i in range(k)]
    assert make_fast(pats, backend="triton",
                     interpret=True).scan_many(t2) == truth
    assert make_fast(pats, backend="xla").scan_many(t2) == truth


def test_count_repeat_async():
    """reps back-to-back scans in one dispatch return the count of one
    scan, on both tiers (a summed count would wrap int32 on a match-dense
    corpus at bench.py's rep counts)."""
    import jax.numpy as jnp
    for m in (8, 16):
        text, pats = make_case(4, m, 64, 50_000, seed=31)
        truth = datagen.count_matches(text, pats)
        eng = make_fast(pats, backend="triton", interpret=True)
        t = jnp.asarray(text)
        assert eng.count_repeat_async(t, 1).result() == truth
        assert eng.count_repeat_async(t, 3).result() == truth
