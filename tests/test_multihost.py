"""Multi-host corpus loading (per-device file ranges, no full-text gather)
exercised on the 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.engines import make_fast
from smatcher.parallel import make_mesh
from smatcher.parallel.dist import DistributedCounter
from smatcher.parallel.multihost import load_corpus_shards, host_shard_ranges


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    ab = Alphabet.dna()
    text = datagen.generate_text(100_003, ab, seed=51)   # non-divisible length
    pats = datagen.generate_patterns(text, 80, 8, ab, frac_present=0.6, seed=52)
    path = tmp_path_factory.mktemp("mh") / "corpus.bin"
    text.tofile(path)
    return str(path), text, pats


def test_load_matches_file(corpus):
    path, text, _ = corpus
    mesh = make_mesh(8)
    arr, n = load_corpus_shards(path, mesh, sigma=4)
    assert n == len(text)
    back = np.asarray(arr)
    np.testing.assert_array_equal(back[:n], text)
    assert (back[n:] == 4).all()           # out-of-alphabet padding


def test_ranges_cover_disjointly(corpus):
    path, text, _ = corpus
    mesh = make_mesh(8)
    ranges = host_shard_ranges(len(text), mesh)
    spans = sorted(r for v in ranges.values() for r in v)
    assert spans[0][0] == 0
    assert spans[-1][1] == len(text)
    for (a, b), (c, d) in zip(spans, spans[1:]):
        assert b == c                       # contiguous, no overlap on disk


def test_distributed_count_from_file_shards(corpus):
    path, text, pats = corpus
    mesh = make_mesh(8)
    arr, n = load_corpus_shards(path, mesh, sigma=pats.sigma)
    eng = make_fast(pats, backend="xla", tile=1 << 12)
    dc = DistributedCounter(eng.core, mesh, m=pats.m, sigma=pats.sigma)
    got = dc.count(arr)
    assert got == datagen.count_matches(text, pats)


def test_distributed_count_from_file_shards_sigma256(tmp_path):
    """Byte-alphabet file shards: 0-padded blocks, the true length threads
    through count(n=) for the wrap correction."""
    ab = Alphabet.of_size(256)
    text = datagen.generate_text(50_003, ab, seed=61)    # non-divisible
    m = 8
    pats = datagen.generate_patterns(text, 40, m, ab, frac_present=0.6,
                                     seed=62)
    text = datagen.plant(text, pats.codes[0], [len(text) - m])
    text = datagen.plant(text, np.zeros(m, np.uint8), [1000])  # zeros in-corpus
    path = tmp_path / "bytes.bin"
    text.tofile(path)
    mesh = make_mesh(8)
    arr, n = load_corpus_shards(str(path), mesh, sigma=256)
    assert n == len(text)
    eng = make_fast(pats, backend="xla", tile=1 << 12)
    dc = DistributedCounter(eng.core, mesh, m=m, sigma=256)
    assert dc.count(arr, n=n) == datagen.count_matches(text, pats)
