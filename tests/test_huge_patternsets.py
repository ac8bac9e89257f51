"""Very large pattern sets on the fp tier: when even all built derived
stages cannot meet the candidate budget (the 16-bit fingerprint space
saturates around p ~ 100k — the reference caps p at texture-memory scale,
main.c:372-373), the scanner overflows the candidate cap and scans in
(m-1)-halo pieces sized to the budget instead of raising."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.engines import make_fast


def test_budget_shortfall_chunks_and_counts_exactly():
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(60_000, ab, seed=21)
    pats = datagen.generate_patterns(text, 300, 16, ab, frac_present=0.5,
                                     seed=22)
    truth = datagen.count_matches(text, pats)
    eng = make_fast(pats, backend="triton", interpret=True, cap=8192)
    # simulate stage saturation by truncating the built stages
    eng.ft = dataclasses.replace(eng.ft, bitmaps=eng.ft.bitmaps[:2])
    got, o = eng.count_with_overflow(jnp.asarray(text, jnp.uint8))
    assert o or got == truth                   # raw flag: never silent
    assert eng.count(text) == truth


def test_saturated_filter_terminates():
    """When the filter SATURATES (density**k > 0.5), budget pieces pin at
    cap//2 and each piece still exceeds the candidate budget — the piece
    path must finish via the dense pass / _count_chunked, not recurse
    (regression: count() died with RecursionError because each piece's
    overflow retry re-entered the identical piece path forever)."""
    ab = Alphabet.of_size(4)
    text = datagen.generate_text(20_000, ab, seed=25)
    pats = datagen.generate_patterns(text, 3_000, 12, ab, frac_present=0.3,
                                     seed=26)
    truth = datagen.count_matches(text, pats)
    eng = make_fast(pats, backend="triton", interpret=True, cap=4096)
    # force saturation: keep only one stage and pin its density near 1
    eng.ft = dataclasses.replace(eng.ft, bitmaps=eng.ft.bitmaps[:1],
                                 density=0.95)
    assert eng.count(text) == truth
    assert eng.count_async(jnp.asarray(text, jnp.uint8)).result() == truth


def test_p100k_exact_tier():
    """p=100k at m=8 DNA stays on the exact tier (p-independent)."""
    ab = Alphabet.dna()
    text = datagen.generate_text(200_000, ab, seed=23)
    pats = datagen.generate_patterns(text, 100_000, 8, ab, frac_present=0.3,
                                     seed=24)
    truth = datagen.count_matches(text, pats)
    assert make_fast(pats, backend="xla").count(text) == truth
