"""Regression: exact-tier pad-symbol aliasing and distributed overflow.

For power-of-two sigma the out-of-alphabet pad symbol (value sigma) needs
one more bit than real chars, so `(key << bits) | char` bleeds its overflow
bit into the neighboring field — a pad-contaminated window's packed id can
ALIAS a real pattern's id, and the exact tier has no verification stage to
reject it.  Distribution pads shard tails and the last halo with sigma
(parallel/mesh.py, parallel/dist.py), so every distributed exact-tier scan
was exposed.  Fixed by the window-max pad guard (ops/keys.py:max_keys).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from smatcher.core.alphabet import Alphabet
from smatcher.core.patterns import PatternSet
from smatcher.core import datagen
from smatcher.engines import make_engine, make_fast
from smatcher.parallel import make_mesh
from smatcher.parallel.dist import DistributedCounter


def _aliasing_case():
    """text of 16 zeros; the pattern aliases the pad window [0]*7 + [4]:
    wid([0]*6+[1,0]) == wid([0]*7+[4]) under 2-bit packing."""
    ab = Alphabet.dna()
    pat = np.array([[0, 0, 0, 0, 0, 0, 1, 0]], np.uint8)
    pats = PatternSet(pat, ab)
    text = np.zeros(16, np.uint8)
    return text, pats                     # true count: 0


def test_distributed_exact_fast_no_pad_alias():
    text, pats = _aliasing_case()
    mesh = make_mesh(2)
    fast = make_fast(pats, backend="xla")
    dc = DistributedCounter(fast.core, mesh, m=8, sigma=4)
    assert dc.count(text) == 0


def test_distributed_exact_pallas_core_no_pad_alias():
    text, pats = _aliasing_case()
    mesh = make_mesh(2)
    fast = make_fast(pats, backend="triton", interpret=True)
    dc = DistributedCounter(fast.core, mesh, m=8, sigma=4)
    assert dc.count(text) == 0


def test_distributed_engine_fastpath_no_pad_alias():
    from smatcher.ops.common import engine_scanner
    text, pats = _aliasing_case()
    mesh = make_mesh(2)
    eng = make_engine("ac", pats, backend="triton", interpret=True)
    dc = DistributedCounter(engine_scanner(eng).core, mesh, m=8, sigma=4)
    assert dc.count(text) == 0


def test_single_device_pallas_count_no_pad_alias():
    text, pats = _aliasing_case()
    fast = make_fast(pats, backend="triton", interpret=True)
    assert fast.count(text) == 0
    assert fast.positions(text).size == 0


def test_engine_positions_guard_out_of_alphabet_text():
    """Single-device EXACT-tier positions on text containing an
    out-of-alphabet byte: the aliased window must not be reported, and the
    engine's device positions must agree with FastScanner.positions."""
    text, pats = _aliasing_case()
    text = text.copy()
    text[15] = 4                        # window [8:16] = [0]*7+[4]: aliases
    fast = make_fast(pats, backend="triton", interpret=True)
    eng = make_engine("ac", pats, backend="triton", interpret=True)
    np.testing.assert_array_equal(fast.positions(text), eng.positions(text))
    assert eng.positions(text).size == 0


def test_engine_fastpath_count_total_on_dense_matches():
    """Engine count/scan_many stay TOTAL when matches alone exceed the
    device cap (the device scanner finishes via budget pieces)."""
    ab = Alphabet.of_size(20)
    m = 12                              # fp tier (20^12 >> 2^16)
    text = np.zeros(2_600, np.uint8)    # every start matches
    pats = PatternSet(np.zeros((1, m), np.uint8), ab)
    truth = len(text) - m + 1
    eng = make_engine("wm", pats, backend="triton", interpret=True,
                      cap=1024)         # far below the 2,589 matches
    assert eng.count(text) == truth
    assert eng.scan_many([text]) == [truth]


def test_exact_still_counts_real_matches_with_guard():
    ab = Alphabet.dna()
    text = datagen.generate_text(30_000, ab, seed=81)
    pats = datagen.generate_patterns(text, 50, 8, ab, frac_present=0.6, seed=82)
    truth = datagen.count_matches(text, pats)
    mesh = make_mesh(4)
    fast = make_fast(pats, backend="triton", interpret=True)
    dc = DistributedCounter(fast.core, mesh, m=8, sigma=4)
    assert dc.count(text) == truth


def test_distributed_overflow_raises():
    """A shard whose candidates exceed the cap must raise, not undercount."""
    ab = Alphabet.protein()
    text = np.zeros(8_192, np.uint8)       # every window a candidate+match
    pats = PatternSet(np.zeros((1, 32), np.uint8), ab)
    mesh = make_mesh(2)
    fast = make_fast(pats, backend="xla", cap=64, tile=1 << 12)
    dc = DistributedCounter(fast.core, mesh, m=32, sigma=20)
    with pytest.raises(OverflowError):
        dc.count(text)


def test_dense_matches_handled_by_row_slot_retry():
    """Dense-match workloads (every window a candidate) count exactly;
    counts are TOTAL — a corpus whose candidates exceed the cap falls back
    to budget-sized pieces and counts exactly."""
    ab = Alphabet.protein()
    text = np.zeros(4_096, np.uint8)
    pats = PatternSet(np.zeros((1, 32), np.uint8), ab)
    truth = 4_096 - 32 + 1
    eng = make_fast(pats, backend="triton", interpret=True)
    assert eng.count(text) == truth
    tight = make_fast(pats, backend="triton", interpret=True, cap=1024)
    assert tight.count(text) == truth      # 4065 candidates > cap=1024:
    # piece fallback, never an undercount or a density-dependent error
