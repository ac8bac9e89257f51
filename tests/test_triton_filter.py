"""The fingerprint-tier Triton kernel (ops/triton_filter.py) in interpret
mode vs a numpy model of the same filter, the plain XLA scan and the numpy
oracle — plus the one backend choice and the card-only check."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.engines import make_fast
from smatcher.ops import fast as F
from smatcher.ops.triton_filter import BLOCK, fp_candidates


def _filter_np(text, ft, k):
    """Window starts passing the first k derived stages (numpy model)."""
    m = ft.m
    win = datagen.sliding_windows(np.asarray(text), m)
    fps = [F._fp_keys_np(win, F.FP_MULTS[s]) for s in range(3)]
    keep = np.ones(len(win), bool)
    for s, (c, d) in enumerate(ft.cd(k)):
        key = (fps[0] + c * fps[1] + d * fps[2]) & (ft.stage_bits - 1)
        words = np.asarray(ft.bitmaps[s]).reshape(-1).view(np.uint32)
        keep &= ((words[key >> 5] >> (key & 31).astype(np.uint32)) & 1) == 1
    return np.nonzero(keep)[0]


def _case(sigma, m, p, n, seed):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p, m, ab, frac_present=0.5,
                                     seed=seed + 1)
    return text, pats


# n sits on, just past and just short of a block boundary, so the last
# block's halo reads clamp at the text end
CASES = [(20, 8, 300, 3 * BLOCK), (20, 8, 300, 3 * BLOCK + 1),
         (4, 16, 200, 4 * BLOCK - 5), (4, 32, 100, 2 * BLOCK + 31),
         (128, 12, 64, 5000), (4, 100, 20, 3000)]


@pytest.mark.parametrize("sigma,m,p,n", CASES)
def test_candidates_match_filter_model(sigma, m, p, n):
    text, pats = _case(sigma, m, p, n, seed=m + n)
    ft = F.build_fast(pats.codes, sigma)
    assert not ft.exact
    for k in (1, 3):
        k = min(k, len(ft.bitmaps))
        idxs, n_cand = fp_candidates(jnp.asarray(text), ft.bitmaps[:k],
                                     m=m, cd=ft.cd(k), cap=1 << 14,
                                     interpret=True)
        got = np.asarray(idxs)
        want = _filter_np(text, ft, k)
        assert int(n_cand) == len(want)
        assert np.array_equal(np.sort(got[got >= 0]), want)
        assert (got[len(want):] == -1).all()        # densely packed


@pytest.mark.parametrize("sigma,m,p,n", CASES)
def test_counts_match_xla_and_oracle(sigma, m, p, n):
    text, pats = _case(sigma, m, p, n, seed=2 * m + n)
    # plant a match at the last start and across a block boundary
    text = datagen.plant(text, pats.codes[0], [n - m, BLOCK - m // 2])
    truth = datagen.count_matches(text, pats)
    tri = make_fast(pats, backend="triton", interpret=True)
    xla = make_fast(pats, backend="xla", tile=1 << 12)
    assert tri.count(text) == xla.count(text) == truth
    np.testing.assert_array_equal(
        tri.positions(text), np.nonzero(datagen.match_starts(text, pats))[0])


def test_cap_overflow_is_flagged():
    """Past the cap the counter keeps the TRUE total, exactly cap slots
    hold candidates from the true set, and the scanner still counts
    exactly through its retry ladder."""
    text, pats = _case(4, 16, 400, 4 * BLOCK, seed=9)
    ft = F.build_fast(pats.codes, 4)
    want = _filter_np(text, ft, 1)
    cap = len(want) // 2
    idxs, n_cand = fp_candidates(jnp.asarray(text), ft.bitmaps[:1], m=16,
                                 cd=ft.cd(1), cap=cap, interpret=True)
    got = np.asarray(idxs)
    assert int(n_cand) == len(want) > cap
    assert (got >= 0).all() and set(got.tolist()) <= set(want.tolist())
    truth = datagen.count_matches(text, pats)
    s = F.FastScanner(ft, cap=truth // 2, backend="triton", interpret=True)
    assert s.count_with_overflow(text)[1]      # matches alone pass the cap
    assert s.count(text) == truth


def test_short_text_has_no_candidates():
    _, pats = _case(20, 8, 50, 1000, seed=3)
    ft = F.build_fast(pats.codes, 20)
    idxs, n_cand = fp_candidates(jnp.zeros((5,), jnp.uint8), ft.bitmaps[:1],
                                 m=8, cd=ft.cd(1), cap=64, interpret=True)
    assert int(n_cand) == 0 and (np.asarray(idxs) == -1).all()


def test_default_backend_is_chosen_once(monkeypatch):
    """xla on this CPU; triton when the first device is a GPU; FastScanner
    takes it when no backend is named and refuses unknown names."""
    assert F.default_backend() == "xla"

    class _Gpu:
        platform = "gpu"

    monkeypatch.setattr(F.jax, "devices", lambda *a: [_Gpu()])
    assert F.default_backend() == "triton"
    monkeypatch.undo()
    _, pats = _case(4, 8, 20, 1000, seed=5)
    assert make_fast(pats).backend == "xla"
    with pytest.raises(ValueError):
        make_fast(pats, backend="pallas")


def test_exact_tier_stays_xla_on_triton_backend():
    """The exact tier (sigma^m <= 2^16) is one bitmap gather per window:
    it runs the plain XLA scan on every backend."""
    text, pats = _case(4, 8, 100, 20_000, seed=13)
    s = make_fast(pats, backend="triton", interpret=True)
    assert s.ft.exact and not s._triton
    assert s.count(text) == datagen.count_matches(text, pats)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu):
    """The compiled kernel (no interpreter) on the card vs the oracle."""
    text, pats = _case(4, 32, 10_000, 1 << 22, seed=17)
    s = make_fast(pats)
    assert s.backend == "triton"
    assert s.count(jax.device_put(text)) == datagen.count_matches(
        text, pats, prefer_native=True)
