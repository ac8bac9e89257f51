"""Knuth-Morris-Pratt preprocessing (reference parity for kmp/kmp.c).

The reference ships KMP but only its table builder is live code: ``preKmp``
(kmp/kmp.c:140-158) builds the *optimized* next table (failure entries are
compressed through equal-character chains, the ``next[i] = next[j]`` branch);
the search routines are commented out and never called (SURVEY.md §2.1 C7).
We provide the same surface: the table builder, plus a straightforward scan
that consumes it so the table's semantics are testable.

KMP is single-pattern and inherently sequential, so there is no device kernel
for it — the framework's multi-pattern engines subsume it.  ``kmp_count`` is
a host-side numpy routine used by tests and the CLI's single-pattern path.
"""

from __future__ import annotations

import numpy as np


def pre_kmp(pattern: np.ndarray) -> np.ndarray:
    """Optimized KMP next table over a single pattern.

    pattern: (m,) uint8.  Returns (m+1,) int32 with next[0] = -1; entry i is
    the resume position after a mismatch at pattern position i, with the
    standard optimization that chains through positions holding the same
    character (kmp/kmp.c:140-158 semantics; next[m] is the plain border
    length of the full pattern, usable for whole-match restarts).
    """
    p = np.asarray(pattern, np.uint8)
    m = len(p)
    nxt = np.empty(m + 1, np.int32)
    nxt[0] = -1
    j = -1
    for i in range(m):
        while j >= 0 and p[i] != p[j]:
            j = nxt[j]
        j += 1
        if i + 1 < m and p[i + 1] == p[j]:
            nxt[i + 1] = nxt[j]
        else:
            nxt[i + 1] = j
    return nxt


def kmp_count(pattern: np.ndarray, text: np.ndarray) -> int:
    """Occurrences of `pattern` in `text` via the pre_kmp table (may overlap).

    Matches the counting convention of the framework's engines restricted to
    a single pattern: one count per end position whose suffix equals the
    pattern.
    """
    p = np.asarray(pattern, np.uint8)
    t = np.asarray(text, np.uint8)
    m, n = len(p), len(t)
    if m == 0 or n < m:
        return 0
    nxt = pre_kmp(p)
    count = 0
    j = 0
    for i in range(n):
        while j >= 0 and t[i] != p[j]:
            j = nxt[j]
        j += 1
        if j == m:
            count += 1
            j = nxt[j]
            if j < 0:
                j = 0
    return count
