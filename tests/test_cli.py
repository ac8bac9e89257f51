"""CLI driver: the smatcher-style surface (main.c:20-30 analogue),
including the --stream disk pipeline."""

import json

import numpy as np
import pytest

from smatcher import cli
from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen


@pytest.fixture(scope="module")
def corpus_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ab = Alphabet.dna()
    text = datagen.generate_text(60_000, ab, seed=11)
    pats = datagen.generate_patterns(text, 40, 8, ab, frac_present=0.6,
                                     seed=12)
    tpath = d / "corpus.bin"
    np.asarray(text, np.uint8).tofile(tpath)
    ppath = pats.save(str(d / "pats.npz"))
    truth = datagen.count_matches(text, pats)
    return str(tpath), str(ppath), truth, d


def _last_json(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_cli_text_run(corpus_files, capsys):
    tpath, ppath, truth, d = corpus_files
    cli.main(["--text", tpath, "--patterns", ppath, "--m", "8",
              "--alphabet", "4", "--algo", "fast", "--backend", "xla",
              "--json"])
    r = _last_json(capsys)
    assert r["matches"] == truth


def test_cli_stream(corpus_files, capsys):
    """--stream scans the corpus from disk in (m-1)-halo pieces and writes
    positions without ever loading the file."""
    tpath, ppath, truth, d = corpus_files
    pos_path = str(d / "pos.npy")
    cli.main(["--stream", "--text", tpath, "--patterns", ppath, "--m", "8",
              "--alphabet", "4", "--algo", "fast", "--backend", "xla",
              "--chunk", "25000", "--verify", "--positions", pos_path,
              "--json"])
    r = _last_json(capsys)
    assert r["matches"] == truth and r["ground_truth"] == truth
    assert np.load(pos_path).size == truth


def test_cli_stream_requires_patterns(corpus_files):
    tpath, ppath, truth, d = corpus_files
    with pytest.raises(SystemExit):
        cli.main(["--stream", "--text", tpath, "--m", "8", "--p-size", "10",
                  "--alphabet", "4"])


def test_cli_per_pattern(corpus_files, tmp_path, capsys):
    tpath, ppath, truth, _ = corpus_files
    out = tmp_path / "per.npy"
    cli.main(["--text", tpath, "--patterns", ppath, "--m", "8",
              "--alphabet", "4", "--algo", "fast", "--backend", "xla",
              "--per-pattern", str(out), "--json"])
    r = _last_json(capsys)
    per = np.load(out)
    assert per.sum() == r["matches"] == truth
