"""Table checkpoint round-trips: build -> save -> load -> identical scans."""

import dataclasses

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.core.checkpoint import save_tables, load_tables
from smatcher.automata import (
    build_ac, build_sh, build_sbom, build_wm, build_sog, build_verify)
from smatcher.ops.fast import build_fast, FastScanner


@pytest.fixture(scope="module")
def setup():
    ab = Alphabet.dna()
    text = datagen.generate_text(20_000, ab, seed=11)
    pats = datagen.generate_patterns(text, 50, 8, ab, seed=12)
    return text, pats


def _assert_equal_dc(a, b):
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if hasattr(va, "shape"):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        elif isinstance(va, tuple):
            assert len(va) == len(vb)
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("builder", [
    lambda c, s: build_ac(c, s),
    lambda c, s: build_sh(c, s),
    lambda c, s: build_sbom(c, s),
    lambda c, s: build_wm(c, s),
    lambda c, s: build_sog(c, s, 8),
    lambda c, s: build_verify(c, s),
])
def test_roundtrip_each_class(tmp_path, setup, builder):
    _, pats = setup
    tb = builder(pats.codes, pats.sigma)
    p = tmp_path / "t.npz"
    save_tables(p, tb)
    _assert_equal_dc(tb, load_tables(p))


def test_roundtrip_fast_tables_and_scan(tmp_path, setup):
    text, pats = setup
    ft = build_fast(pats.codes, pats.sigma)
    p = tmp_path / "fast.npz"
    save_tables(p, ft)
    ft2 = load_tables(p)
    want = datagen.count_matches(text, pats)
    got = FastScanner(ft2, tile=1 << 12, backend="xla").count(text)
    assert got == want


def test_roundtrip_fingerprint_fast_tables(tmp_path):
    ab = Alphabet.protein()
    text = datagen.generate_text(20_000, ab, seed=21)
    pats = datagen.generate_patterns(text, 40, 16, ab, seed=22)
    ft = build_fast(pats.codes, pats.sigma)
    assert not ft.exact
    p = tmp_path / "fast_fp.npz"
    save_tables(p, ft)
    ft2 = load_tables(p)
    want = datagen.count_matches(text, pats)
    got = FastScanner(ft2, tile=1 << 12, backend="xla").count(text)
    assert got == want


def test_roundtrip_dict(tmp_path, setup):
    _, pats = setup
    d = {"ac": build_ac(pats.codes, pats.sigma),
         "wm": build_wm(pats.codes, pats.sigma)}
    p = tmp_path / "multi.npz"
    save_tables(p, d)
    out = load_tables(p)
    assert set(out) == {"ac", "wm"}
    _assert_equal_dc(d["ac"], out["ac"])
    _assert_equal_dc(d["wm"], out["wm"])


def test_roundtrip_wide_stages_and_attribution(tmp_path):
    """Round-4 FastTables fields survive the npz round trip: wide-stage
    derivation constants (stage_cd as JSON lists -> cd() re-tuples them)
    and the device-side attribution tables (orig_ids / wid_pids /
    n_orig), so a loaded scanner's count_per_pattern matches the
    builder's exactly."""
    import numpy as np
    ab = Alphabet.dna()
    text = datagen.generate_text(1 << 16, ab, seed=31)
    pats = datagen.generate_patterns(text, 300, 16, ab, frac_present=0.5,
                                     seed=32)
    truth = datagen.count_matches(text, pats)
    ft = build_fast(pats.codes, 4, stage_bits=131072)
    p = tmp_path / "wide.npz"
    save_tables(p, ft)
    ft2 = load_tables(p)
    assert ft2.stage_bits == 131072
    assert ft2.cd(4) == ft.cd(4)
    s1 = FastScanner(ft, backend="xla", tile=1 << 12)
    s2 = FastScanner(ft2, backend="xla", tile=1 << 12)
    assert s1.count(text) == s2.count(text) == truth
    h1, h2 = s1.count_per_pattern(text), s2.count_per_pattern(text)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    assert int(np.asarray(h2).sum()) == truth
