"""Adversarial fp-collision workloads: adaptation must CONVERGE.

FP_COLLISION_D satisfies sum(d_j * mult^j) == 0 mod 2^16 for all three
base fingerprint multipliers (scripts/find_fp_collision.py), so a planted
window x passes every derived filter stage of pattern x+d and extra stages
can never reject it.  The scanner's async adaptation ladder (_async_retry:
k_extra bumps -> terminal dense-pass switch) must reach a state where
scans stop retrying, with every intermediate count exact.
"""
import jax.numpy as jnp
import numpy as np

from smatcher.core.alphabet import Alphabet
from smatcher.core.patterns import PatternSet
from smatcher.core import datagen
from smatcher.engines import make_fast
from smatcher.ops.fast import FP_MULTS, _fp_keys_np

FP_COLLISION_D = np.array([0, 1, 0, -3, 1, 2, -3, 2, 2, -3, 2, 1,
                           -3, 0, 1, 0], np.int64)


def _planted(n=1 << 16, stride=96, n_pat=120, seed=5):
    ab = Alphabet.dna()
    rng = np.random.default_rng(seed)
    lo = np.maximum(0, -FP_COLLISION_D)
    hi = np.minimum(3, 3 - FP_COLLISION_D)
    xs = np.stack([rng.integers(lo, hi + 1) for _ in range(n_pat)]
                  ).astype(np.uint8)
    ys = (xs + FP_COLLISION_D[None, :]).astype(np.uint8)
    text = np.asarray(datagen.generate_text(n, ab, seed=seed + 1)).copy()
    for i, s in enumerate(range(0, n - 16, stride)):
        text[s:s + 16] = xs[i % len(xs)]
    return text, PatternSet(ys, ab)


def test_collision_vector_is_total():
    lo = np.maximum(0, -FP_COLLISION_D)
    hi = np.minimum(3, 3 - FP_COLLISION_D)
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(lo, hi + 1) for _ in range(8)]).astype(np.uint8)
    y = (x + FP_COLLISION_D[None, :]).astype(np.uint8)
    assert y.min() >= 0 and y.max() <= 3
    for s in range(3):
        assert np.array_equal(_fp_keys_np(x, FP_MULTS[s]),
                              _fp_keys_np(y, FP_MULTS[s]))


def test_adversarial_adaptation_converges():
    text, pats = _planted()
    truth = int(datagen.count_matches(text, pats))
    s = make_fast(pats, backend="triton", interpret=True)
    tdev = jnp.asarray(text)
    counts = [s.count(tdev) for _ in range(7)]
    assert counts == [truth] * 7          # exact on EVERY scan
    mid = s._retries
    assert mid <= 6                       # bounded ladder, not per-scan
    for _ in range(2):
        assert s.count(tdev) == truth
    assert s._retries == mid              # steady state: no more retraces


def test_adversarial_positions_and_attr_exact():
    text, pats = _planted(n=1 << 15, n_pat=60)
    s = make_fast(pats, backend="triton", interpret=True)
    tdev = jnp.asarray(text)
    pos = s.positions(tdev)
    want = np.nonzero(np.asarray(datagen.match_starts(text, pats)))[0]
    assert np.array_equal(pos, want)
    per = s.count_per_pattern(tdev)
    assert int(per.sum()) == len(want)
