"""Pattern sets: ``p_size`` fixed-length-``m`` patterns.

The reference stores patterns as a flattened ``pattern2[p_size * m]`` byte
array (``/root/reference/main.c:456-459``) and every engine assumes all
patterns share one length ``m``.  We keep that contract: a PatternSet is a
dense ``(p_size, m)`` uint8 array of code points plus its alphabet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from smatcher.core.alphabet import Alphabet


@dataclasses.dataclass(frozen=True)
class PatternSet:
    codes: np.ndarray          # (p_size, m) uint8, values < alphabet.size
    alphabet: Alphabet

    def __post_init__(self):
        codes = np.ascontiguousarray(np.asarray(self.codes, dtype=np.uint8))
        if codes.ndim != 2:
            raise ValueError("patterns must be a (p_size, m) array")
        object.__setattr__(self, "codes", codes)
        self.alphabet.validate(codes)

    @property
    def p_size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def m(self) -> int:
        return int(self.codes.shape[1])

    @property
    def sigma(self) -> int:
        return self.alphabet.size

    @staticmethod
    def from_strings(strings, alphabet: Alphabet) -> "PatternSet":
        rows = [alphabet.encode(s.encode() if isinstance(s, str) else s) for s in strings]
        lens = {len(r) for r in rows}
        if len(lens) != 1:
            raise ValueError(f"all patterns must share one length, got {sorted(lens)}")
        return PatternSet(np.stack(rows), alphabet)

    @staticmethod
    def from_fasta(path: str, alphabet: Alphabet) -> "PatternSet":
        """One pattern per FASTA record; all records must share one length
        (use MixedPatternSet.from_fasta for mixed-length records)."""
        return PatternSet.from_strings(_fasta_records(path), alphabet)

    def flat(self) -> np.ndarray:
        """Flattened ``pattern2``-style view (p_size * m,)."""
        return self.codes.reshape(-1)

    def save(self, path: str) -> str:
        """Save as .npz; returns the path actually written (np.savez appends
        '.npz' itself, which would silently diverge from the argument)."""
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez_compressed(path, codes=self.codes, sigma=self.alphabet.size,
                            chars=np.frombuffer(self.alphabet.chars, np.uint8) if self.alphabet.chars else np.zeros(0, np.uint8))
        return path

    @staticmethod
    def load(path: str) -> "PatternSet":
        z = np.load(path)
        chars = bytes(z["chars"].tobytes()) if z["chars"].size else None
        return PatternSet(z["codes"], Alphabet(int(z["sigma"]), chars))


def _fasta_records(path: str) -> list:
    """Raw byte sequences, one per FASTA record."""
    seqs = []
    cur = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if cur:
                    seqs.append(b"".join(cur))
                    cur = []
            else:
                cur.append(b"".join(line.split()))
    if cur:
        seqs.append(b"".join(cur))
    if not seqs:
        raise ValueError(f"no FASTA records in {path}")
    return seqs


@dataclasses.dataclass(frozen=True)
class MixedPatternSet:
    """Patterns of MIXED lengths: one PatternSet per distinct length plus
    the original (global) pattern id of every row.

    The reference's contract is one shared length ``m`` per run (its
    generator emits fixed-m sets, ``/root/reference/main.c:48-50``, and
    every engine indexes ``pattern2[p*m]``); real pattern sets are not
    uniform, so this groups by length and a MixedScanner (engines.py) runs
    one sub-scan per group over the same device-resident text.  Counting
    semantics: each length contributes its own windows-with-a-match count
    (a start matching patterns of two lengths counts twice — exactly what
    two reference runs, one per length, would report)."""

    groups: tuple          # tuple[PatternSet, ...], ascending m, all same alphabet
    ids: tuple             # tuple[np.ndarray, ...] global id per group row
    alphabet: Alphabet

    def __post_init__(self):
        if not self.groups:
            raise ValueError("MixedPatternSet needs at least one pattern")
        ms = [g.m for g in self.groups]
        if ms != sorted(set(ms)):
            raise ValueError("groups must have distinct, ascending lengths")
        if len(self.ids) != len(self.groups):
            raise ValueError(
                f"ids must have one entry per group: {len(self.ids)} id "
                f"arrays for {len(self.groups)} groups")
        for g, gid in zip(self.groups, self.ids):
            if (g.alphabet.size != self.alphabet.size
                    or g.alphabet.chars != self.alphabet.chars):
                raise ValueError("all groups must share one alphabet "
                                 "(size and character map)")
            if len(gid) != g.p_size:
                raise ValueError("ids must align with group rows")

    @property
    def p_size(self) -> int:
        return sum(g.p_size for g in self.groups)

    @property
    def lengths(self) -> tuple:
        return tuple(g.m for g in self.groups)

    @property
    def sigma(self) -> int:
        return self.alphabet.size

    @staticmethod
    def from_rows(rows, alphabet: Alphabet) -> "MixedPatternSet":
        """rows: iterable of encoded uint8 sequences (any lengths)."""
        rows = [np.asarray(r, dtype=np.uint8) for r in rows]
        if not rows:
            raise ValueError("no patterns")
        by_m: dict = {}
        for i, r in enumerate(rows):
            if r.ndim != 1 or r.size == 0:
                raise ValueError(f"pattern {i} must be a non-empty 1-D array")
            by_m.setdefault(r.size, []).append((i, r))
        groups, ids = [], []
        for m in sorted(by_m):
            idx, rs = zip(*by_m[m])
            groups.append(PatternSet(np.stack(rs), alphabet))
            ids.append(np.asarray(idx, np.int64))
        return MixedPatternSet(tuple(groups), tuple(ids), alphabet)

    @staticmethod
    def from_strings(strings, alphabet: Alphabet) -> "MixedPatternSet":
        rows = [alphabet.encode(s.encode() if isinstance(s, str) else s)
                for s in strings]
        return MixedPatternSet.from_rows(rows, alphabet)

    @staticmethod
    def from_fasta(path: str, alphabet: Alphabet) -> "MixedPatternSet":
        """One pattern per FASTA record, any mix of lengths."""
        return MixedPatternSet.from_strings(_fasta_records(path), alphabet)
