"""Shared exact-verification tables for the filter-based engines (WM/SOG/SBOM).

The reference verifies candidates three different ways — WM walks PREFIX
lists + memcmp (wu/wu.c:184-201), SOG binary-searches sorted Rabin-Karp
hashes + memcmp (sog/sog8.c:51-95), SBOM memcmps the reached oracle state's
pattern list (sbom/sbom.c:176-190).  All three decide the same predicate:
"does the window equal at least one pattern?" (every comparison path is
gated on a value that any true match necessarily produces).

The dense-scan equivalent is one structure: bucket the patterns by their
*last 3-gram* in a collision-free base-sigma key (any pattern matching a
window shares the window's last gram), pad the buckets to Lmax, and pack the
pattern bytes into little-endian int32 words so a full-window compare is
ceil(m/4) int compares instead of m byte compares.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VerifyTables:
    packed: np.ndarray        # (p, W) int32 — LE-packed pattern bytes, 0-padded
    bucket_ids: np.ndarray    # (H, Lmax) int32 — pattern ids, -1 padded
    bucket_size: np.ndarray   # (H,) int32
    lmax: int
    words: int                # W = ceil(m / 4)
    sigma: int
    m: int

    @property
    def h_size(self) -> int:
        return int(self.bucket_ids.shape[0])


def pack_rows(rows: np.ndarray) -> np.ndarray:
    """(k, m) uint8 -> (k, ceil(m/4)) int32, little-endian, zero padded."""
    rows = np.asarray(rows, np.uint8)
    k, m = rows.shape
    W = -(-m // 4)
    padded = np.zeros((k, W * 4), dtype=np.uint32)
    padded[:, :m] = rows
    words = (padded[:, 0::4]
             | (padded[:, 1::4] << 8)
             | (padded[:, 2::4] << 16)
             | (padded[:, 3::4] << 24))
    return words.astype(np.int32)  # bit-identical reinterpret for compares


def gram_key(c0, c1, c2, sigma: int):
    """Collision-free base-sigma 3-gram key (vectorized)."""
    return (np.asarray(c0, np.int64)
            + np.asarray(c1, np.int64) * sigma
            + np.asarray(c2, np.int64) * sigma * sigma)


def build_verify(patterns: np.ndarray, sigma: int) -> VerifyTables:
    patterns = np.asarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    if m < 3:
        raise ValueError("verification keys need m >= 3")
    H = sigma ** 3
    keys = gram_key(patterns[:, m - 3], patterns[:, m - 2], patterns[:, m - 1], sigma)
    size = np.bincount(keys, minlength=H).astype(np.int32)
    lmax = max(1, int(size.max(initial=0)))
    bucket_ids = np.full((H, lmax), -1, dtype=np.int32)
    slot = np.zeros(H, dtype=np.int64)
    for j in range(p):
        h = int(keys[j])
        bucket_ids[h, slot[h]] = j
        slot[h] += 1
    return VerifyTables(pack_rows(patterns), bucket_ids, size, lmax, -(-m // 4), sigma, m)
