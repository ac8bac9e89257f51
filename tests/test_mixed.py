"""Mixed-length pattern sets (MixedPatternSet + engines.make_mixed).

The reference's contract is one shared pattern length per run
(/root/reference/main.c:456-459 indexes pattern2[p*m]; its generator emits
fixed-m sets).  MixedScanner lifts that: one sub-scanner per distinct
length over the same device text, counts summed — provably identical to
running the reference once per length group.
"""

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.core.patterns import MixedPatternSet, PatternSet
from smatcher.engines import make_mixed


def _mixed_set(text, lengths, per_len, ab, seed=0):
    """Patterns sampled from text windows (guaranteed hits) plus random
    rows, across several lengths, as one shuffled mixed set."""
    rng = np.random.default_rng(seed)
    rows = []
    for m in lengths:
        for _ in range(per_len):
            if rng.random() < 0.6:
                s = rng.integers(0, len(text) - m + 1)
                rows.append(np.asarray(text[s:s + m], np.uint8))
            else:
                rows.append(rng.integers(0, ab.size, size=m, dtype=np.uint8))
    order = rng.permutation(len(rows))
    return MixedPatternSet.from_rows([rows[i] for i in order], ab), \
        [rows[i] for i in order]


def _oracle_count(text, mixed):
    return sum(int(datagen.count_matches(text, g)) for g in mixed.groups)


def test_grouping_and_global_ids():
    ab = Alphabet.dna()
    rows = [np.zeros(8, np.uint8), np.ones(4, np.uint8),
            np.full(8, 2, np.uint8), np.full(4, 3, np.uint8)]
    mx = MixedPatternSet.from_rows(rows, ab)
    assert mx.lengths == (4, 8)
    assert mx.p_size == 4
    # every original row is findable at its global id
    for g, gids in zip(mx.groups, mx.ids):
        for row, gid in zip(g.codes, gids):
            np.testing.assert_array_equal(row, rows[gid])


def test_mixed_count_matches_per_length_oracle():
    ab = Alphabet.dna()
    text = datagen.generate_text(50_000, ab, seed=11)
    mx, _ = _mixed_set(text, (5, 8, 12), 20, ab, seed=12)
    eng = make_mixed(mx, backend="xla")
    assert eng.count(text) == _oracle_count(text, mx)


def test_mixed_positions_and_matches():
    ab = Alphabet.dna()
    text = datagen.generate_text(30_000, ab, seed=21)
    mx, rows = _mixed_set(text, (6, 9), 15, ab, seed=22)
    eng = make_mixed(mx, backend="xla")

    starts, lens = eng.positions(text)
    exp = []
    for g in mx.groups:
        for p in np.nonzero(datagen.match_starts(text, g))[0]:
            exp.append((int(p), g.m))
    exp.sort()
    assert list(zip(starts.tolist(), lens.tolist())) == exp

    # matches(): global ids; each reported id's pattern occurs at its start
    mstarts, mids = eng.matches(text)
    for s, i in zip(mstarts.tolist(), mids.tolist()):
        row = rows[i]
        np.testing.assert_array_equal(np.asarray(text[s:s + len(row)]), row)


def test_mixed_scan_many():
    ab = Alphabet.of_size(8)
    texts = [datagen.generate_text(20_000, ab, seed=s) for s in (31, 32, 33)]
    mx, _ = _mixed_set(texts[0], (4, 7), 12, ab, seed=34)
    eng = make_mixed(mx, backend="xla")
    assert eng.scan_many(texts) == [_oracle_count(t, mx) for t in texts]


def test_mixed_count_file_short_groups_tail(tmp_path):
    """Chunked streaming must cover the tail starts that only the SHORT
    lengths own (grid by m_min, not m_max)."""
    ab = Alphabet.dna()
    text = datagen.generate_text(20_000, ab, seed=41)
    mx, _ = _mixed_set(text, (4, 64), 10, ab, seed=42)
    path = tmp_path / "corpus.bin"
    path.write_bytes(text.tobytes())
    eng = make_mixed(mx, backend="xla")
    got = eng.count_file(str(path), chunk=4096)
    assert got == _oracle_count(text, mx) == eng.count(text)


def test_mixed_engine_family():
    """Mixed wrapper composes the named engines too (one WM per length)."""
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(20_000, ab, seed=51)
    mx, _ = _mixed_set(text, (5, 10), 10, ab, seed=52)
    eng = make_mixed(mx, engine="wm")
    assert eng.count(text) == _oracle_count(text, mx)


def test_mixed_rejects_uniform_set():
    ab = Alphabet.dna()
    pats = PatternSet(np.zeros((2, 8), np.uint8), ab)
    with pytest.raises(TypeError):
        make_mixed(pats)


def test_mixed_cli_fasta(tmp_path, capsys):
    """CLI: a mixed-length FASTA pattern file routes through MixedScanner,
    agrees with ground truth, and writes (start, length) positions."""
    import json
    from smatcher import cli
    ab = Alphabet.dna()
    text = datagen.generate_text(30_000, ab, seed=61)
    tpath = tmp_path / "corpus.bin"
    np.asarray(text, np.uint8).tofile(tpath)
    rng = np.random.default_rng(62)
    chars = b"ACGT"
    fa = tmp_path / "pats.fa"
    with open(fa, "w") as f:
        for i in range(20):
            m = int(rng.choice([5, 9]))
            s = int(rng.integers(0, len(text) - m + 1))
            f.write(f">p{i}\n" +
                    "".join(chr(chars[c]) for c in text[s:s + m]) + "\n")
    pos_path = tmp_path / "pos.npy"
    cli.main(["--text", str(tpath), "--patterns", str(fa), "--m", "8",
              "--alphabet", "4", "--algo", "fast", "--backend", "xla",
              "--verify", "--positions", str(pos_path), "--json"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["matches"] == r["ground_truth"]
    pos = np.load(pos_path)
    assert pos.ndim == 2 and pos.shape[1] == 2
    assert pos.shape[0] == r["matches"]
    for s, m in pos[:20]:
        win = bytes(text[s:s + m])
        # the reported window must equal some pattern of that length
        recs = [l.strip() for l in open(fa) if not l.startswith(">")]
        assert any(len(rec) == m and
                   ab.encode(rec.encode()).tobytes() == win for rec in recs)


def test_mixed_ids_group_count_mismatch():
    """A too-short ids tuple must fail at construction, not later in
    matches() global-id attribution (ADVICE r2)."""
    ab = Alphabet.dna()
    g5 = PatternSet(np.zeros((2, 5), np.uint8), ab)
    g8 = PatternSet(np.zeros((3, 8), np.uint8), ab)
    with pytest.raises(ValueError, match="one entry per group"):
        MixedPatternSet((g5, g8), (np.arange(2),), ab)


def test_mixed_groups_alphabet_char_map_checked():
    """Groups must share the full alphabet (size AND char map), not just
    the size (ADVICE r2)."""
    plain4 = Alphabet(4)             # same size as dna(), different chars
    g = PatternSet(np.zeros((2, 5), np.uint8), Alphabet.dna())
    with pytest.raises(ValueError, match="alphabet"):
        MixedPatternSet((g,), (np.arange(2),), plain4)


def test_mixed_cli_algo_all_skips_sog(tmp_path, capsys):
    """--algo all with a mixed set runs every per-length-capable engine,
    skips SOG with a note, cross-checks, and exits 0 (ADVICE r2: this
    used to crash mid-run with an unhandled ValueError)."""
    import json
    from smatcher import cli
    ab = Alphabet.dna()
    text = datagen.generate_text(20_000, ab, seed=71)
    tpath = tmp_path / "corpus.bin"
    np.asarray(text, np.uint8).tofile(tpath)
    chars = b"ACGT"
    fa = tmp_path / "pats.fa"
    rng = np.random.default_rng(72)
    with open(fa, "w") as f:
        for i, m in enumerate([5, 8, 8, 11]):
            s = int(rng.integers(0, len(text) - m + 1))
            f.write(f">p{i}\n" +
                    "".join(chr(chars[c]) for c in text[s:s + m]) + "\n")
    cli.main(["--text", str(tpath), "--patterns", str(fa), "--m", "8",
              "--alphabet", "4", "--algo", "all", "--verify", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    names = {r["engine"] for r in out}
    assert names == {"ac", "sh", "sbom", "wm", "fast"}   # no sog8
    assert len({r["matches"] for r in out}) == 1
    assert all(r["matches"] == r["ground_truth"] for r in out)


def test_mixed_cli_explicit_sog_clear_exit(tmp_path):
    """Explicit --algo sog8 on a mixed set exits with a clear message
    instead of an unhandled ValueError (ADVICE r2)."""
    from smatcher import cli
    ab = Alphabet.dna()
    text = datagen.generate_text(5_000, ab, seed=73)
    tpath = tmp_path / "corpus.bin"
    np.asarray(text, np.uint8).tofile(tpath)
    fa = tmp_path / "pats.fa"
    with open(fa, "w") as f:
        f.write(">a\nACGTA\n>b\nACGTACGT\n")
    with pytest.raises(SystemExit, match="mixes lengths"):
        cli.main(["--text", str(tpath), "--patterns", str(fa), "--m", "8",
                  "--alphabet", "4", "--algo", "sog8"])
