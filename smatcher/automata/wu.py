"""Wu-Manber table builder.

B=3 block hashing with 2-bit shifts in the reference's exact hash space
(wu/wu.c:64-67, sizes from wu_determine_shiftsize:18-47): for each pattern
position q in [B, m], SHIFT[hash] = min(SHIFT[hash], m - q), initialized to
m - B + 1 (main.c:444-449).  PREFIX lists (patterns whose last 3-gram hashes
to h, with their 2-char prefix hash) become padded (H, Lmax) matrices for the
dense device scan.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from smatcher.oracles.reference import WM_B, WM_BITS_IN_SHIFT, wm_shiftsize


@dataclasses.dataclass
class WMTables:
    shift: np.ndarray          # (H,) int32
    prefix_value: np.ndarray   # (H, Lmax) int32, -1 padded
    prefix_index: np.ndarray   # (H, Lmax) int32, -1 padded
    prefix_size: np.ndarray    # (H,) int32
    shiftsize: int
    lmax: int
    sigma: int
    m: int


def hash3_np(c0, c1, c2):
    """Vectorized reference block hash ((c0<<2)+c1<<2)+c2 (wu/wu.c:163-169)."""
    return ((c0.astype(np.int32) << WM_BITS_IN_SHIFT) + c1.astype(np.int32)
            << WM_BITS_IN_SHIFT) + c2.astype(np.int32)


def build_wm(patterns: np.ndarray, sigma: int,
             native: bool | str = "auto") -> WMTables:
    patterns = np.asarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    if m < WM_B:
        raise ValueError(f"Wu-Manber requires m >= {WM_B}")
    H = wm_shiftsize(sigma)
    if native:
        from smatcher import native as nat
        r = nat.build_wm_native(patterns, sigma, H)
        if r is not None:
            shift, prefix_value, prefix_index, prefix_size, lmax = r
            return WMTables(shift, prefix_value, prefix_index, prefix_size,
                            H, lmax, sigma, m)
        if native is True:
            raise RuntimeError("native builder requested but unavailable")
    shift = np.full(H, m - WM_B + 1, dtype=np.int32)

    # All (pattern, q) gram hashes vectorized: q in [B, m], gram chars at
    # q-3, q-2, q-1 (0-based), shiftlen = m - q.
    qs = np.arange(WM_B, m + 1)
    h_all = hash3_np(patterns[:, qs - 3], patterns[:, qs - 2], patterns[:, qs - 1])  # (p, len(qs))
    shiftlen = (m - qs).astype(np.int32)                                             # (len(qs),)
    np.minimum.at(shift, h_all.reshape(-1), np.broadcast_to(shiftlen, h_all.shape).reshape(-1))

    # PREFIX lists for shiftlen == 0 (q == m): last-gram hash per pattern.
    h_last = h_all[:, -1]
    prefix_hash = (patterns[:, 0].astype(np.int32) << WM_BITS_IN_SHIFT) + patterns[:, 1].astype(np.int32)
    prefix_size = np.bincount(h_last, minlength=H).astype(np.int32)
    lmax = max(1, int(prefix_size.max(initial=0)))
    prefix_value = np.full((H, lmax), -1, dtype=np.int32)
    prefix_index = np.full((H, lmax), -1, dtype=np.int32)
    slot = np.zeros(H, dtype=np.int64)
    for j in range(p):                      # preserves reference insertion order
        h = int(h_last[j])
        prefix_value[h, slot[h]] = int(prefix_hash[j])
        prefix_index[h, slot[h]] = j
        slot[h] += 1
    return WMTables(shift, prefix_value, prefix_index, prefix_size, H, lmax, sigma, m)
