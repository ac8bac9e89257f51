"""Synthetic corpus + pattern generation with planted hits.

The reference relies on an out-of-repo helper
``create_multiple_pattern_with_hits(m, n, 100000, text, pattern)``
(``/root/reference/main.c:48-50``, declared in the missing ``helper2.h``)
to produce pattern files with a known number of hits per corpus.  This module
is our own self-contained equivalent: random texts over an alphabet, pattern
sets drawn as a mix of text windows (guaranteed hits) and random strings, and
an exact ground-truth counter used as the conformance oracle's oracle.
"""

from __future__ import annotations

import numpy as np

from smatcher.core.alphabet import Alphabet
from smatcher.core.patterns import PatternSet


def generate_text(n: int, alphabet: Alphabet, seed: int = 0) -> np.ndarray:
    """Uniform random encoded text of length n over the alphabet."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, alphabet.size, size=n, dtype=np.uint8)


def generate_patterns(
    text: np.ndarray,
    p_size: int,
    m: int,
    alphabet: Alphabet,
    frac_present: float = 0.5,
    seed: int = 1,
) -> PatternSet:
    """p_size patterns of length m: ~frac_present sampled from text windows
    (guaranteed to occur), the rest uniform random (hits only by chance)."""
    rng = np.random.default_rng(seed)
    n = len(text)
    if n < m:
        raise ValueError("text shorter than pattern length")
    if not 0.0 <= frac_present <= 1.0:
        raise ValueError(f"frac_present must be in [0, 1], got {frac_present}")
    n_present = int(round(p_size * frac_present))
    starts = rng.integers(0, n - m + 1, size=n_present)
    present = np.stack([text[s:s + m] for s in starts]) if n_present else np.zeros((0, m), np.uint8)
    random_part = rng.integers(0, alphabet.size, size=(p_size - n_present, m), dtype=np.uint8)
    codes = np.concatenate([present, random_part], axis=0)
    rng.shuffle(codes, axis=0)
    return PatternSet(codes, alphabet)


def plant(text: np.ndarray, pattern: np.ndarray, positions) -> np.ndarray:
    """Overwrite text with `pattern` at each start position; returns a copy."""
    out = text.copy()
    m = len(pattern)
    for s in positions:
        out[s:s + m] = pattern
    return out


def sliding_windows(text: np.ndarray, m: int) -> np.ndarray:
    """(n - m + 1, m) zero-copy view of all length-m windows."""
    return np.lib.stride_tricks.sliding_window_view(np.ascontiguousarray(text), m)


def match_starts(text: np.ndarray, patterns: PatternSet | np.ndarray) -> np.ndarray:
    """Ground truth: boolean array over window starts, True where the window
    equals at least one pattern.  All five engines count exactly
    ``match_starts(...).sum()`` (see SURVEY.md §7: with equal-length patterns
    the reference's per-position <=1 counting semantics coincide across
    AC/SH/SBOM/WM/SOG)."""
    codes = patterns.codes if isinstance(patterns, PatternSet) else np.asarray(patterns, np.uint8)
    p, m = codes.shape
    n = len(text)
    if n < m:
        return np.zeros(0, dtype=bool)
    win = sliding_windows(text, m)
    # Pack windows and patterns into fixed-size byte keys for set membership.
    win_keys = np.ascontiguousarray(win).view([("k", f"V{m}")]).reshape(-1)
    pat_keys = np.ascontiguousarray(codes).view([("k", f"V{m}")]).reshape(-1)
    return np.isin(win_keys, pat_keys)


def match_ids(text: np.ndarray, positions: np.ndarray,
              patterns: PatternSet | np.ndarray) -> np.ndarray:
    """Pattern id matching at each of `positions` (which must all be true
    match starts, e.g. from scanner.positions()); the smallest id when
    duplicate patterns share the window.  Host-side attribution: the
    reference's verify loops identify the matching pattern (wu/wu.c:184-201,
    sbom/sbom.c:176-190) but only count — here the attribution is a
    first-class output.  O(N log p) via sorted void-key search."""
    codes = patterns.codes if isinstance(patterns, PatternSet) else np.asarray(patterns, np.uint8)
    p, m = codes.shape
    positions = np.asarray(positions, np.int64)
    if positions.size == 0:
        return np.empty(0, np.int64)
    text = np.asarray(text, np.uint8)
    win = text[positions[:, None] + np.arange(m)]
    win_keys = np.ascontiguousarray(win).view([("k", f"V{m}")]).reshape(-1)
    pat_keys = np.ascontiguousarray(codes).view([("k", f"V{m}")]).reshape(-1)
    order = np.argsort(pat_keys, kind="stable")   # stable: ties keep min id
    srt = pat_keys[order]
    idx = np.searchsorted(srt, win_keys, side="left")
    if (idx >= p).any() or (srt[np.minimum(idx, p - 1)] != win_keys).any():
        raise ValueError("positions contain a non-matching window start")
    return order[idx].astype(np.int64)


def count_matches(text: np.ndarray, patterns: PatternSet | np.ndarray,
                  prefer_native: bool = False) -> int:
    """Ground-truth total match count (one per position with >=1 match).

    prefer_native uses the C scanner (native/builders.cpp:sm_count_cpu,
    the reference's multiwm2 CPU-path analogue) — required for full-scale
    corpora where the numpy oracle would materialize gigabytes of windows;
    it is validated against the numpy path in tests/test_native.py."""
    if prefer_native:
        from smatcher import native as nat
        codes = patterns.codes if isinstance(patterns, PatternSet) else np.asarray(patterns, np.uint8)
        c = nat.count_cpu_native(np.asarray(text, np.uint8), codes)
        if c is not None:
            return c
    return int(match_starts(text, patterns).sum())
