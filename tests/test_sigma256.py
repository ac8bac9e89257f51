"""sigma=256 (byte alphabet) semantics: no out-of-alphabet uint8 pad exists,
so jnp tile paths mask by position and distribution rejects it cleanly."""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core.patterns import PatternSet
from smatcher.core import datagen
from smatcher.engines import make_engine, make_fast
from smatcher.parallel import make_mesh, shard_text
from smatcher.parallel.dist import DistributedCounter


def _case():
    ab = Alphabet.byte()
    # adversarial: pattern of zero bytes — the wrapped pad (256 -> 0) used to
    # match it in padded tails
    text = np.full(1001, 0xFF, np.uint8)
    pats = PatternSet(np.zeros((1, 8), np.uint8), ab)
    return text, pats                      # true count: 0


def test_single_device_jnp_engines_no_pad_wrap():
    text, pats = _case()
    for name in ("wm", "sh", "sbom", "sog8", "ac"):
        eng = make_engine(name, pats, tile=1 << 8)
        assert eng.count(text) == 0, name


def test_jnp_ac_byte_alphabet_positional_mask():
    """The jnp AC scan masks finals by position: exact at sigma=256, where
    the lane pad wraps to the REAL byte 255 (ops/ac.py:segment)."""
    ab = Alphabet.byte()
    text = np.full(1001, 0xFF, np.uint8)
    # all-255 pattern: the pad value itself — fake finals on padded tails
    # would overcount without the positional mask
    pats = PatternSet(np.full((1, 8), 255, np.uint8), ab)
    eng = make_engine("ac", pats, lanes=64)
    assert eng.count(text) == 1001 - 7
    assert int(eng.match_ends(text).sum()) == 1001 - 7

    text2 = datagen.generate_text(20_000, ab, seed=91)
    pats2 = datagen.generate_patterns(text2, 30, 8, ab, frac_present=0.6,
                                      seed=92)
    truth = datagen.count_matches(text2, pats2)
    eng2 = make_engine("ac", pats2, lanes=64)
    assert eng2.count(text2) == truth

    # q>1 composed tables still need the sentinel — documented raise
    eng3 = make_engine("ac", pats2, lanes=64, q=2)
    with pytest.raises(ValueError):
        eng3.count(text2)


def test_single_device_counts_real_matches():
    ab = Alphabet.byte()
    text = datagen.generate_text(20_000, ab, seed=91)
    pats = datagen.generate_patterns(text, 30, 8, ab, frac_present=0.6, seed=92)
    truth = datagen.count_matches(text, pats)
    for name in ("wm", "sh"):
        eng = make_engine(name, pats, tile=1 << 10)
        assert eng.count(text) == truth, name
    assert make_fast(pats, backend="xla", tile=1 << 10).count(text) == truth


def test_distribution_sigma256_wrap_mode():
    """The byte alphabet distributes: shard_text 0-pads, the halo wraps
    cyclically, and the count subtracts the exact wrap/pad overcount
    (dist._wrap_overcount) — exact counts, no pad symbol needed."""
    text, pats = _case()
    mesh = make_mesh(4)
    sharded, n = shard_text(text, mesh, sigma=256)
    assert n == len(text)
    assert (np.asarray(sharded)[n:] == 0).all()
    eng = make_fast(pats, backend="xla")
    dc = DistributedCounter(eng.core, mesh, m=8, sigma=256)
    assert dc.count(text) == datagen.count_matches(text, pats)


def test_tiny_shard_raises_clearly():
    ab = Alphabet.dna()
    text = np.zeros(32, np.uint8)
    pats = PatternSet(np.zeros((1, 8), np.uint8), ab)
    mesh = make_mesh(8)                    # per=4 < m-1=7
    eng = make_fast(pats, backend="xla")
    dc = DistributedCounter(eng.core, mesh, m=8, sigma=4)
    with pytest.raises(ValueError, match="fewer devices"):
        dc.count(text)
