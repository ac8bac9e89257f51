"""Engines and their device scanner vs the numpy ground truth.

Each engine counts with its own scan; its pipelined counts, positions and
matches run on one FastScanner over the same codes (ops/common.py:
engine_scanner), here with the Triton kernel in interpret mode.  Every
route must equal the oracle.
"""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.engines import make_engine

CASES = [
    # sigma, m, engines (sog width == m)
    (4, 8, ["ac", "sh", "sbom", "wm", "sog8"]),       # exact tier
    (4, 16, ["ac", "sh", "sbom", "wm", "sog16"]),     # fp tier, suffix-8
    (20, 32, ["ac", "sh", "sbom", "wm", "sog32"]),    # fp tier, protein
    (2, 16, ["ac", "sh", "wm", "sog16"]),             # exact tier, binary
]


@pytest.mark.parametrize("sigma,m,engines", CASES)
def test_engine_fastpath_parity(sigma, m, engines):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(50_000, ab, seed=61)
    pats = datagen.generate_patterns(text, 50, m, ab, frac_present=0.6, seed=62)
    truth = datagen.count_matches(text, pats)
    for name in engines:
        eng = make_engine(name, pats, backend="triton", interpret=True,
                          tile=1 << 12)
        got = eng.count(text)           # the engine's own scan
        assert got == truth, f"{name}: {got} != {truth}"
        # the device scanner agrees too
        assert eng.count_async(text).result() == truth, name


def test_fastpath_core_traceable():
    import jax
    import jax.numpy as jnp
    ab = Alphabet.dna()
    text = datagen.generate_text(20_000, ab, seed=63)
    pats = datagen.generate_patterns(text, 30, 8, ab, seed=64)
    from smatcher.ops.common import engine_scanner
    eng = make_engine("wm", pats, backend="triton", interpret=True)
    c, o = jax.jit(engine_scanner(eng).core)(jnp.asarray(text))
    assert int(o) == 0
    assert int(c) == datagen.count_matches(text, pats)


def test_fastpath_overflow_total_count():
    """Engine counts are TOTAL: a dense-match corpus whose candidates
    exceed the device scanner's cap must still count exactly, never raise
    or undercount."""
    from smatcher.core.patterns import PatternSet
    ab = Alphabet.protein()
    text = np.zeros(8_192, np.uint8)
    pats = PatternSet(np.zeros((1, 32), np.uint8), ab)
    eng = make_engine("wm", pats, backend="triton", interpret=True, cap=256)
    assert eng.count(text) == 8_192 - 32 + 1
    assert eng.count_async(text).result() == 8_192 - 32 + 1


def test_byte_alphabet_and_long_patterns():
    """sigma=256 (raw bytes) and m=64 coverage through the fast paths."""
    ab = Alphabet.of_size(256)
    text = datagen.generate_text(40_000, ab, seed=71)
    pats = datagen.generate_patterns(text, 40, 16, ab, frac_present=0.6, seed=72)
    truth = datagen.count_matches(text, pats)
    for name in ("wm", "ac", "sog16"):
        eng = make_engine(name, pats, backend="triton", interpret=True, tile=1 << 12)
        assert eng.count(text) == truth, name

    ab2 = Alphabet.protein()
    text2 = datagen.generate_text(40_000, ab2, seed=73)
    pats2 = datagen.generate_patterns(text2, 30, 64, ab2, frac_present=0.6, seed=74)
    truth2 = datagen.count_matches(text2, pats2)
    from smatcher.engines import make_fast
    assert make_fast(pats2, backend="triton", interpret=True).count(text2) == truth2
    assert make_engine("sh", pats2, backend="triton", interpret=True, tile=1 << 12).count(text2) == truth2


def test_engine_async_fp_tier_slots():
    """The engine async path (fp tier, the Triton kernel) must count
    exactly."""
    ab = Alphabet.protein()
    text = datagen.generate_text(60_000, ab, seed=81)
    pats = datagen.generate_patterns(text, 40, 32, ab, frac_present=0.6,
                                     seed=82)
    truth = datagen.count_matches(text, pats)
    for name in ("wm", "ac"):
        eng = make_engine(name, pats, backend="triton", interpret=True)
        assert eng.scan_many([text]) == [truth], name
