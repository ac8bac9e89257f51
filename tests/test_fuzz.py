"""Randomized conformance fuzz: every engine path vs the numpy ground truth
over random (sigma, m, p, n, planted-fraction) configurations.

The reference's correctness methodology is cross-implementation agreement
(SURVEY.md §4); this drives it at scale across the config space, covering
exact/fingerprint tiers, engine-specific stages, and the XLA path.
"""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.engines import make_engine, make_fast

SIGMAS = [2, 4, 8, 20, 128]
MS = [4, 8, 12, 16, 24, 32, 48]


def _config(rng):
    sigma = int(rng.choice(SIGMAS))
    m = int(rng.choice(MS))
    p = int(rng.integers(1, 120))
    n = int(rng.integers(m, 30_000))
    frac = float(rng.uniform(0, 1))
    return sigma, m, p, n, frac


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_fast_both_backends(seed):
    rng = np.random.default_rng(1000 + seed)
    sigma, m, p, n, frac = _config(rng)
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p, m, ab, frac_present=frac,
                                     seed=seed + 1)
    truth = datagen.count_matches(text, pats)
    xla = make_fast(pats, backend="xla", tile=1 << 12)
    assert xla.count(text) == truth, (sigma, m, p, n)
    pal = make_fast(pats, backend="triton", interpret=True)
    assert pal.count(text) == truth, (sigma, m, p, n)
    want = np.nonzero(np.asarray(datagen.match_starts(text, pats)))[0]
    np.testing.assert_array_equal(pal.positions(text), want)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_engines(seed):
    rng = np.random.default_rng(2000 + seed)
    sigma, m, p, n, frac = _config(rng)
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p, m, ab, frac_present=frac,
                                     seed=seed + 1)
    truth = datagen.count_matches(text, pats)
    names = ["wm", "sh", "sbom"] + (["ac"] if sigma < 256 else [])
    if m in (8, 16, 32):
        names.append(f"sog{m}")
    for name in names:
        eng = make_engine(name, pats, backend="triton", interpret=True, tile=1 << 12)
        assert eng.count(text) == truth, (name, sigma, m, p, n)
