"""Dense-match corpora on the fingerprint tier: counts must be total
functions of the input — when candidates exceed every cap trial, the fast
path scans in budget-sized pieces, and engine counts run their capless
jnp scans.  The reference counts millions
of matches per corpus (main.c:656); density must never be an error."""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core.patterns import PatternSet
from smatcher.core import datagen
from smatcher.engines import make_engine, make_fast


@pytest.fixture(scope="module")
def dense_case():
    ab = Alphabet.of_size(20)
    text = np.zeros(40_000, np.uint8)
    pats = PatternSet(np.zeros((1, 32), np.uint8), ab)   # every window hits
    return text, pats, 40_000 - 31


def test_fast_xla_dense(dense_case):
    text, pats, truth = dense_case
    eng = make_fast(pats, backend="xla", cap=1024)
    assert eng.count(text) == truth
    assert eng.count_async(text).result() == truth


def test_fast_pallas_dense(dense_case):
    text, pats, truth = dense_case
    eng = make_fast(pats, backend="triton", interpret=True, cap=1024)
    assert eng.count(text) == truth


def test_engine_falls_back_to_jnp(dense_case):
    text, pats, truth = dense_case
    eng = make_engine("wm", pats, backend="triton", interpret=True,
                      tile=1 << 12, cap=1024)
    assert eng.count(text) == truth
    assert eng.count_async(text).result() == truth


def test_mixed_density(dense_case):
    text, pats, _ = dense_case
    ab = Alphabet.of_size(20)
    text2 = np.concatenate([np.zeros(20_000, np.uint8),
                            datagen.generate_text(20_000, ab, seed=3)])
    truth = datagen.count_matches(text2, pats)
    assert make_fast(pats, backend="xla", cap=1024).count(text2) == truth
    assert make_fast(pats, backend="triton", interpret=True,
                     cap=1024).count(text2) == truth
