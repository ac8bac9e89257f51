"""Corpus I/O.

Replaces the reference's hard-coded ``n -> data file`` table
(``/root/reference/main.c:32-123``, ``select_data_file``) and the missing
``load_files`` helper with explicit loading: raw pre-encoded files (like the
reference's data-cuda-multi corpora), ASCII/FASTA files encoded through an
Alphabet, and synthetic corpora.  Per-host offset loading
lives in parallel/multihost.py (load_corpus_shards), so a multi-host run
never materializes the full text on one host (the reference's rank-0
``textFull`` load, ``main.c:386,453``, does — a scaling bug we avoid).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from smatcher.core.alphabet import Alphabet


@dataclasses.dataclass(frozen=True)
class Corpus:
    codes: np.ndarray       # (n,) uint8 encoded text
    alphabet: Alphabet
    name: str = ""

    @property
    def n(self) -> int:
        return int(self.codes.shape[0])


def load_raw(path: str, alphabet: Alphabet, name: str = "") -> Corpus:
    """Load a whole pre-encoded or mappable byte file."""
    with open(path, "rb") as f:
        raw = f.read()
    return Corpus(alphabet.encode(raw), alphabet, name or os.path.basename(path))


def _fasta_lut(alphabet: Alphabet) -> np.ndarray:
    """Raw byte -> code LUT for the native encoder: alphabet chars (upper and
    lower case) to their codes, whitespace to the skip marker 255, anything
    else to 0 (matching Alphabet.encode's wildcard handling)."""
    lut = np.zeros(256, np.uint8)
    for code, ch in enumerate(alphabet.chars):
        lut[ch] = code
        if 65 <= ch <= 90:
            lut[ch + 32] = code
    for ws in b"\n\r\t ":
        lut[ws] = 255
    return lut


def load_fasta(path: str, alphabet: Alphabet, name: str = "") -> Corpus:
    """Load a FASTA file: skip '>' header lines, drop whitespace, encode.

    Uses the native C encoder (native/builders.cpp:sm_encode_fasta) when the
    alphabet has a char map; pure-python fallback otherwise."""
    name = name or os.path.basename(path)
    if alphabet.chars is not None:
        from smatcher import native as nat
        raw = np.fromfile(path, dtype=np.uint8)
        codes = nat.encode_fasta_native(raw, _fasta_lut(alphabet))
        if codes is not None:
            return Corpus(codes, alphabet, name)
    chunks = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                continue
            chunks.append(b"".join(line.split()))
    return Corpus(alphabet.encode(b"".join(chunks)), alphabet, name)
