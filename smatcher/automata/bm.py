"""Boyer-Moore-family bad-character preprocessing (reference bm/bm.c parity).

The reference's live BM surface is exactly one function: the multi-pattern
Horspool bad-character table ``preBmBc`` (bm/bm.c:19-29) consumed by the Set
Horspool engine; the good-suffix code is commented out (SURVEY.md §2.1
C8-C10).  ``pre_bm_bc`` is the vectorized equivalent:

    bmBc[c] = min over patterns j and positions i < m-1 of (m - 1 - i)
              where pattern[j][i] == c, else m.

The dense SH scan evaluates every window end instead of skipping by
bmBc (skipped ends provably cannot match, so counts are identical —
SURVEY.md §7), but the table remains part of the SH engine ABI and of the
CPU-style scans/tests.
"""

from __future__ import annotations

import numpy as np


def pre_bm_bc(patterns: np.ndarray, sigma: int) -> np.ndarray:
    """patterns: (p, m) uint8 codes in [0, sigma). Returns (sigma,) int32."""
    patterns = np.asarray(patterns, np.uint8)
    _, m = patterns.shape
    bmBc = np.full(sigma, m, dtype=np.int32)
    if m > 1:
        shifts = (m - 1 - np.arange(m - 1)).astype(np.int32)
        for pat in patterns:
            np.minimum.at(bmBc, pat[: m - 1], shifts)
    return bmBc
