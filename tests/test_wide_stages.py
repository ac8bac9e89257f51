"""WIDE filter stages (stage_bits > 2^16) — the large-pattern-set regime.

The reference accepts up to p = 100,000 patterns (main.c:372-373); at that
scale the 16-bit fingerprint space saturates (fill ~0.78 per stage) and
build_fast widens the stage keyspace to 2^17/2^18 bits, deriving every
stage with the triple-mixed STAGE_CD[2:] constants (fp0 alone cannot reach
bits >= 2^16).  These tests force wide tables on small pattern sets via
build_fast(stage_bits=) so the whole path runs in CPU test time.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.ops import fast as F


@pytest.fixture(scope="module")
def corpus():
    ab = Alphabet.dna()
    text = datagen.generate_text(1 << 17, ab, seed=11)
    pats = datagen.generate_patterns(text, 400, 16, ab, frac_present=0.5,
                                     seed=12)
    truth = datagen.count_matches(text, pats)
    return text, pats, truth


@pytest.mark.parametrize("sb", [131072, 262144])
def test_wide_build_shape(corpus, sb):
    _, pats, _ = corpus
    ft = F.build_fast(pats.codes, 4, stage_bits=sb)
    assert ft.stage_bits == sb
    assert ft.bitmaps[0].shape == (sb // 32,)
    # every wide stage must mix fp1 with C >= 2^(b-16) to reach all bits
    assert all(c >= sb >> 16 for c, _ in ft.stage_cd)
    assert F.STAGE_CD[0] not in ft.stage_cd
    # fills must reflect the wider space (p=400 over >= 2^17 bits)
    assert all(f < 0.01 for f in ft.stage_fills)


@pytest.mark.parametrize("backend,interpret", [("xla", False),
                                               ("triton", True)])
@pytest.mark.parametrize("sb", [131072, 262144])
def test_wide_count_and_positions(corpus, sb, backend, interpret):
    text, pats, truth = corpus
    ft = F.build_fast(pats.codes, 4, stage_bits=sb)
    s = F.FastScanner(ft, backend=backend, interpret=interpret)
    t = jnp.asarray(text)
    assert s.count(t) == truth
    pos = s.positions(t)
    ref = F.FastScanner(F.build_fast(pats.codes, 4), backend=backend,
                        interpret=interpret).positions(t)
    assert np.array_equal(pos, ref)


def test_wide_cost_model_picks_wide_when_saturated():
    # at p >> 2^16 the 16-bit space saturates and the measured cost model
    # must widen (this is the p=100k regime at DNA pattern scale)
    rng = np.random.default_rng(0)
    codes = np.unique(rng.integers(0, 4, (120_000, 16), dtype=np.uint8),
                      axis=0)
    ft = F.build_fast(codes, 4)
    assert ft.stage_bits > F.BITMAP_BITS
    assert ft.density < 0.65       # 2^17: fill 1-e^(-p/2^17) ~ 0.60 at p=120k


def test_wide_checkpoint_roundtrip(tmp_path, corpus):
    text, pats, truth = corpus
    from smatcher.core.checkpoint import save_tables, load_tables
    ft = F.build_fast(pats.codes, 4, stage_bits=131072)
    path = tmp_path / "wide.npz"
    save_tables(str(path), ft)
    ft2 = load_tables(str(path))
    assert ft2.stage_bits == 131072
    assert ft2.cd(3) == ft.cd(3)          # deep-tupled (jit-static safe)
    assert all(isinstance(p, tuple) for p in ft2.cd(3))
    s = F.FastScanner(ft2, backend="xla")
    assert s.count(jnp.asarray(text)) == truth
