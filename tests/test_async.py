"""Pipelined scanning API: count_async / scan_many / pipelined count_file.

The reference amortizes per-kernel timing across reps on the device
(cuda/cuda_wm.cu:269-302); here the analogous production need is hiding the
host round-trip: results stay on device until ScanFuture.result()."""

import os
import tempfile

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.engines import make_engine, make_fast


@pytest.fixture(scope="module")
def fp_case():
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(60_000, ab, seed=5)
    pats = datagen.generate_patterns(text, 80, 12, ab, frac_present=0.5,
                                     seed=6)
    return text, pats, datagen.count_matches(text, pats)


@pytest.fixture(scope="module")
def exact_case():
    ab = Alphabet.dna()
    text = datagen.generate_text(50_000, ab, seed=7)
    pats = datagen.generate_patterns(text, 64, 8, ab, frac_present=0.5,
                                     seed=8)
    return text, pats, datagen.count_matches(text, pats)


def test_scan_many_xla_fp(fp_case):
    text, pats, truth = fp_case
    eng = make_fast(pats, backend="xla")
    got = eng.scan_many([text, text[:30_000]])
    assert got == [truth, datagen.count_matches(text[:30_000], pats)]


def test_count_async_pallas_interpret_fp(fp_case):
    text, pats, truth = fp_case
    eng = make_fast(pats, backend="triton", interpret=True)
    assert eng.count_async(text).result() == truth


def test_scan_many_exact_both_backends(exact_case):
    text, pats, truth = exact_case
    assert make_fast(pats, backend="triton",
                     interpret=True).scan_many([text]) == [truth]
    assert make_fast(pats, backend="xla").scan_many([text]) == [truth]


def test_engine_async_fastpath_and_fallback(exact_case):
    text, pats, truth = exact_case
    assert make_engine("wm", pats, backend="triton", interpret=True).scan_many([text]) == [truth]
    assert make_engine("ac", pats).scan_many([text]) == [truth]


def test_count_async_overflow_retries_to_exact(fp_case):
    """A tiny cap overflows the single device pass; result() must fall back
    to the synchronous retry path — which chunks past persistent overflow —
    and still return the exact count."""
    text, pats, truth = fp_case
    eng = make_fast(pats, backend="xla", cap=32)
    f = eng.count_async(text)
    assert f.result() == truth


def test_count_file_pipelined(exact_case):
    text, pats, truth = exact_case
    eng = make_fast(pats, backend="xla")
    with tempfile.NamedTemporaryFile(delete=False) as fh:
        fh.write(np.asarray(text).tobytes())
        path = fh.name
    try:
        assert eng.count_file(path, chunk=13_000) == truth
        assert eng.count_file(path, chunk=13_000, depth=1) == truth
    finally:
        os.unlink(path)


def test_engine_count_file(exact_case):
    """Every engine streams files through the shared (m-1)-halo pipeline
    (common.stream_count_file) on its device scanner."""
    text, pats, truth = exact_case
    with tempfile.NamedTemporaryFile(delete=False) as fh:
        fh.write(np.asarray(text).tobytes())
        path = fh.name
    try:
        wm = make_engine("wm", pats, backend="triton", interpret=True, tile=1 << 12)
        assert wm.count_file(path, chunk=13_000) == truth
        ac = make_engine("ac", pats)
        assert ac.count_file(path, chunk=13_000) == truth
        sog = make_engine("sog8", pats, tile=1 << 12)
        assert sog.count_file(path, chunk=13_000, depth=1) == truth
    finally:
        os.unlink(path)


def test_async_retry_adds_filter_stages():
    """An FP-driven overflow retry must still return the exact count (via
    the sync ladder) and bump the scanner's extra-stage count — bounded —
    so an adversarial pattern set converges to a harder filter instead of
    retrying every scan.  The corpus here is match-SPARSE (matches far
    below cap/4) so the bump branch is exercised."""
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(300_000, ab, seed=15)
    pats = datagen.generate_patterns(text, 80, 12, ab, frac_present=0.2,
                                     seed=16)
    truth = datagen.count_matches(text, pats)
    assert truth * 16384 / (len(text) - 11) <= 8     # sparse premise
    eng = make_fast(pats, backend="triton", interpret=True)
    assert eng._k_extra == 0
    assert eng._async_retry(text) == truth        # exact count via ladder
    assert eng._k_extra == 1
    assert eng.count_async(text).result() == truth  # retraced, still exact
    for _ in range(6):
        eng._async_retry(text)
    assert eng._k_extra == 4                      # bounded
    assert eng.count_async(text).result() == truth


def test_async_retry_match_dense_switch(fp_case):
    """A MATCH-driven overflow (true matches alone exceed cap/4) must NOT
    bump the stage count — stages cannot reject matches; each useless bump
    forces a full retrace — and later scans keep counting exactly."""
    text, pats, truth = fp_case
    cap = 64
    assert truth > cap // 4                       # match-dense vs the cap
    eng = make_fast(pats, backend="triton", interpret=True, cap=cap)
    assert eng._async_retry(text) == truth
    assert eng._k_extra == 0
    f = eng.count_async(text)
    assert f.result() == truth
    assert eng.count_async(text).result() == truth


def test_chunked_verify_matches_full_verify():
    """verify_chunked must equal the single full-cap verify_at for every
    candidate count — in particular when candidates spill past the first
    cond chunk (n_cand > cap/VERIFY_CHUNKS), where the gated chunks must
    actually execute."""
    import jax.numpy as jnp
    from smatcher.core.alphabet import Alphabet
    from smatcher.core import datagen
    from smatcher.ops.fast import verify_at, verify_chunked
    ab = Alphabet(4)
    text = datagen.generate_text(50_000, ab, seed=3)
    pats = datagen.generate_patterns(text, 400, 16, ab, frac_present=0.8,
                                     seed=4)
    eng = make_fast(pats, backend="triton", interpret=True)
    ft = eng.ft
    n = len(text)
    n_starts = n - ft.m + 1
    tw = jnp.asarray(text)
    cap = 1024                       # 256-candidate chunks
    for n_fill in (0, 100, 300, 900, 1024):   # spans 1..4 live chunks
        idxs = np.full(cap, -1, np.int32)
        idxs[:n_fill] = np.arange(0, n_fill * 7, 7)[:n_fill] % n_starts
        full = int(verify_at(tw, jnp.asarray(idxs), ft.bucket_ids,
                             ft.packed, ft.bucket_fp2, m=ft.m,
                             words=ft.words, lmax=ft.lmax, eb=ft.eb,
                             n_starts=n_starts, slot_ok=ft.slot_ok))
        chunked = int(verify_chunked(tw, jnp.asarray(idxs),
                                     jnp.int32(n_fill), ft,
                                     n_starts=n_starts))
        assert chunked == full, (n_fill, chunked, full)


def test_engine_async_match_dense_adapts():
    """An engine's async path on a match-dense corpus: every scan that
    overflows the device cap retries to the exact count, and the
    repeat-scan primitive runs on the same device scanner."""
    from smatcher.engines import make_engine
    from smatcher.ops.common import engine_scanner
    ab = Alphabet.dna()
    text = datagen.generate_text(120_000, ab, seed=61)
    pats = datagen.generate_patterns(text, 32, 12, ab, frac_present=0.5,
                                     seed=62)
    text = datagen.plant(text, pats.codes[0], list(range(0, 119_000, 150)))
    truth = datagen.count_matches(text, pats)
    eng = make_engine("wm", pats, backend="triton", interpret=True,
                      cap=256)         # force the device scan to overflow
    fs = engine_scanner(eng)
    assert eng.count_async(text).result() == truth      # first: retries
    assert fs._retries == 1 and fs._k_extra == 0        # match-driven
    assert eng.count_async(text).result() == truth
    assert fs.count_repeat_async(text, 2).result() == truth
