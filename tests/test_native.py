"""Native (C++) builders vs pure-python builders: bit-identical tables."""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher import native
from smatcher.automata import build_ac, build_sh, build_sbom

pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="native library unavailable")


def case(sigma, m, p, seed=0):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(50_000, ab, seed=seed)
    return datagen.generate_patterns(text, p, m, ab, seed=seed + 1).codes


@pytest.mark.parametrize("sigma,m,p", [(4, 8, 200), (4, 32, 64), (20, 16, 100), (2, 16, 50)])
def test_ac_native_matches_python(sigma, m, p):
    pats = case(sigma, m, p, seed=sigma + m)
    a = build_ac(pats, sigma, native=True)
    b = build_ac(pats, sigma, native=False)
    assert a.n_states == b.n_states
    assert np.array_equal(a.transition, b.transition)
    assert np.array_equal(a.supply, b.supply)
    assert np.array_equal(a.final, b.final)
    assert np.array_equal(a.delta, b.delta)


@pytest.mark.parametrize("sigma,m,p", [(4, 8, 200), (20, 16, 100)])
def test_sh_native_matches_python(sigma, m, p):
    pats = case(sigma, m, p, seed=7)
    a = build_sh(pats, sigma, native=True)
    b = build_sh(pats, sigma, native=False)
    assert a.n_states == b.n_states
    assert np.array_equal(a.transition, b.transition)
    assert np.array_equal(a.final, b.final)
    assert np.array_equal(a.bmBc, b.bmBc)


@pytest.mark.parametrize("sigma,m,p", [(4, 8, 200), (20, 16, 100), (4, 32, 64)])
def test_sbom_native_matches_python(sigma, m, p):
    pats = case(sigma, m, p, seed=9)
    a = build_sbom(pats, sigma, native=True)
    b = build_sbom(pats, sigma, native=False)
    assert a.n_states == b.n_states
    assert np.array_equal(a.transition, b.transition)
    assert np.array_equal(a.final_count, b.final_count)
    assert np.array_equal(a.final_ids, b.final_ids)


def test_sbom_duplicate_patterns():
    pats = np.tile(np.array([[0, 1, 2, 3]], np.uint8), (3, 1))
    a = build_sbom(pats, 4, native=True)
    b = build_sbom(pats, 4, native=False)
    assert np.array_equal(a.final_ids, b.final_ids)
    assert a.final_ids.shape[1] == 3


def test_native_rejects_out_of_range():
    pats = np.full((2, 8), 5, np.uint8)
    with pytest.raises(ValueError):
        build_ac(pats, 4, native=True)


def test_native_fasta_encoder_matches_python(tmp_path):
    import numpy as np
    from smatcher.core.alphabet import Alphabet
    from smatcher.core import corpus
    from smatcher import native as nat

    fasta = (b">chr1 test header\n"
             b"ACGTacgtNNRY\n"
             b"GGCC AATT\n"          # interior space dropped
             b">chr2\nTTTT\r\nacgt\n")
    p = tmp_path / "t.fa"
    p.write_bytes(fasta)
    ab = Alphabet.dna()

    c = corpus.load_fasta(str(p), ab)
    # python reference computed inline (headers/whitespace removed, encode)
    seq = b"ACGTacgtNNRYGGCCAATTTTTTacgt"
    want = ab.encode(seq)
    np.testing.assert_array_equal(c.codes, want)

    raw = np.frombuffer(fasta, np.uint8)
    got = nat.encode_fasta_native(raw, corpus._fasta_lut(ab))
    if got is not None:            # native available
        np.testing.assert_array_equal(got, want)


def test_native_cpu_count_matches_numpy():
    import numpy as np
    from smatcher.core.alphabet import Alphabet
    from smatcher.core import datagen
    from smatcher import native as nat
    rng = np.random.default_rng(3)
    for sigma, m, p, n in [(4, 8, 50, 40_000), (20, 32, 40, 30_000),
                           (2, 16, 30, 20_000), (256, 12, 25, 20_000),
                           (4, 1, 2, 5_000)]:
        ab = Alphabet.of_size(sigma)
        text = datagen.generate_text(n, ab, seed=int(rng.integers(1e6)))
        if m == 1:
            pats_codes = rng.integers(0, sigma, (p, 1)).astype(np.uint8)
            want = int(np.isin(text, pats_codes.ravel()).sum())
            got = nat.count_cpu_native(text, pats_codes)
        else:
            pats = datagen.generate_patterns(text, p, m, ab,
                                             frac_present=0.6,
                                             seed=int(rng.integers(1e6)))
            want = datagen.count_matches(text, pats)          # numpy oracle
            got = datagen.count_matches(text, pats, prefer_native=True)
        if got is None:
            import pytest
            pytest.skip("native library unavailable")
        assert got == want, (sigma, m, p, n)


def test_native_sbom_rejects_out_of_range_bytes():
    import numpy as np
    import pytest
    from smatcher import native as nat
    if nat.load() is None:
        pytest.skip("native library unavailable")
    bad = np.array([[200, 1, 2, 3]], np.uint8)
    with pytest.raises(ValueError):
        nat.build_sbom_native(bad, 4)


def test_native_wm_tables_match_python():
    import numpy as np
    import pytest
    from smatcher import native as nat
    from smatcher.automata.wu import build_wm
    if nat.load() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(17)
    for sigma, m, p in [(4, 8, 60), (20, 32, 45), (2, 5, 20), (128, 12, 30)]:
        pats = rng.integers(0, sigma, (p, m)).astype(np.uint8)
        py = build_wm(pats, sigma, native=False)
        na = build_wm(pats, sigma, native=True)
        np.testing.assert_array_equal(py.shift, na.shift)
        np.testing.assert_array_equal(py.prefix_size, na.prefix_size)
        np.testing.assert_array_equal(py.prefix_value, na.prefix_value)
        np.testing.assert_array_equal(py.prefix_index, na.prefix_index)
        assert py.lmax == na.lmax


def test_native_sog_tables_match_python():
    import numpy as np
    import pytest
    from smatcher import native as nat
    from smatcher.automata.sog import build_sog
    if nat.load() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(18)
    for sigma, width in [(4, 8), (20, 16), (8, 32)]:
        pats = rng.integers(0, sigma, (40, width)).astype(np.uint8)
        py = build_sog(pats, sigma, width, native=False)
        na = build_sog(pats, sigma, width, native=True)
        np.testing.assert_array_equal(py.T, na.T)


def test_native_match_enum_parity():
    """sm_match_enum == numpy attribution (positions sorted, smallest id
    on byte-identical duplicates) — the ground truth of matches()."""
    from smatcher import native
    from smatcher.core.datagen import match_ids
    if native.load() is None:
        pytest.skip("native toolchain unavailable")
    ab = Alphabet.dna()
    text = datagen.generate_text(200_000, ab, seed=51)
    pats = datagen.generate_patterns(text, 200, 9, ab, frac_present=0.8,
                                     seed=52)
    codes = np.concatenate([pats.codes, pats.codes[:5]], axis=0)  # dups
    pos, ids = native.match_enum_native(text, codes)
    assert len(pos) == datagen.count_matches(text, pats)
    assert np.all(np.diff(pos) > 0)
    assert np.array_equal(ids, match_ids(text, pos, codes))


def test_scanner_matches_native_offtpu():
    """Engine matches() on a CPU backend (no active fast path) routes
    through the native enumerator and agrees with ground truth."""
    from smatcher import native
    from smatcher.engines import make_engine
    if native.load() is None:
        pytest.skip("native toolchain unavailable")
    ab = Alphabet.dna()
    text = datagen.generate_text(120_000, ab, seed=53)
    pats = datagen.generate_patterns(text, 64, 8, ab, frac_present=0.7,
                                     seed=54)
    eng = make_engine("wm", pats)    # pure jnp + native attr
    pos, ids = eng.matches(text)
    assert len(pos) == datagen.count_matches(text, pats)
    from smatcher.core.datagen import match_ids
    assert np.array_equal(np.asarray(ids),
                          match_ids(text, np.asarray(pos), pats.codes))
