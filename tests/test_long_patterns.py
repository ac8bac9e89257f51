"""Long patterns on the fast path.  The reference kernels take any m
(cuda/cuda_wm.cu:67-70); the Triton kernel's fingerprint loop runs as a
fori_loop past m = 64, and verification gathers the m window bytes of each
candidate, so no length limit applies."""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.engines import make_engine, make_fast


@pytest.mark.parametrize("m", [150, 512, 1024, 2048])
def test_long_pattern_fast_path_parity(m):
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(30_000, ab, seed=11)
    pats = datagen.generate_patterns(text, 20, m, ab, frac_present=0.5,
                                     seed=m)
    truth = datagen.count_matches(text, pats)
    eng = make_fast(pats, backend="triton", interpret=True)
    assert eng.count(text) == truth
    oracle = np.nonzero(np.asarray(datagen.match_starts(text, pats)))[0]
    np.testing.assert_array_equal(eng.positions(text), oracle)


def test_long_pattern_engine_fast_path():
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(20_000, ab, seed=12)
    pats = datagen.generate_patterns(text, 15, 200, ab, frac_present=0.5,
                                     seed=13)
    truth = datagen.count_matches(text, pats)
    assert make_engine("wm", pats, backend="triton", interpret=True).count(text) == truth


def test_beyond_max_falls_back():
    """m = 4104 — past any fixed layout — through count, the distribution
    core and a 2-device mesh."""
    ab = Alphabet.of_size(20)
    m = 4104
    # text sized off the cap: the 2-device mesh below needs per-shard
    # length >= m-1 for the one-hop halo
    text = datagen.generate_text(3 * m, ab, seed=14)
    pats = datagen.generate_patterns(text, 8, m, ab, frac_present=0.5,
                                     seed=15)
    truth = datagen.count_matches(text, pats)
    eng = make_fast(pats, backend="triton", interpret=True)
    assert eng.count(text) == truth

    # the distribution core takes the same scan
    import jax
    import jax.numpy as jnp
    c, o = jax.jit(eng.core)(jnp.asarray(text, jnp.uint8))
    assert (int(c), int(o)) == (truth, 0)

    from smatcher.parallel import make_mesh
    from smatcher.parallel.dist import DistributedCounter
    dc = DistributedCounter(eng.core, make_mesh(2), m=m, sigma=pats.sigma)
    assert dc.count(text) == truth


@pytest.mark.parametrize("m", [257, 513])
def test_long_pattern_max_byte_fp_accumulation(m):
    """Near-max bytes (sigma=256) over long windows: fingerprint sums must
    stay exact integers mod 2^16 (any rounding would silently REJECT true
    matches, the one invariant a filter must never break).  The kernel
    accumulates in int32."""
    from smatcher.core.patterns import PatternSet
    ab = Alphabet(256)
    rng = np.random.default_rng(5)
    n = 1 << 14
    text = rng.choice(np.array([254, 255], np.uint8), n)
    starts = rng.integers(0, n - m, 64)
    pats = PatternSet(np.stack([text[s:s + m] for s in starts]), ab)
    truth = datagen.count_matches(text, pats)
    assert truth >= 64                       # every planted window matches
    eng = make_fast(pats, backend="triton", interpret=True)
    assert eng.count(text) == truth
    assert len(eng.positions(text)) == truth
