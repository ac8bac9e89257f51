"""SOG (shift-or with q-grams) table builder.

The reference's T8/T16/T32 tables are 2^24-entry arrays indexed by a
byte-packed little-endian 3-gram (GET3GRAM, smatcher.h:80), with bit i
cleared iff some pattern contains that 3-gram at offset i
(sog/sog8.c:140-147).  Since our text bytes are code points < sigma, we remap
the gram index to base-sigma (g = c0 + c1*sigma + c2*sigma^2) — an injective
relabeling of the populated entries — shrinking the table from 16M entries to
sigma^3 (64 for DNA), small enough to stay cache-resident on the device.

The filter semantics (branchless form used by the kernel): position s is a
candidate iff bit i of T[gram(s+i)] is 0 for ALL i in 0..m-B, which equals
the reference's E-register condition E & (1 << (m-B)) == 0 after warmup.
Verification is exact window membership (the reference's Rabin-Karp hash +
bitmap + binary search + memcmp covers the full window, sog/sog8.c:51-95).
"""

from __future__ import annotations

import dataclasses

import numpy as np

SOG_B = 3


@dataclasses.dataclass
class SOGTables:
    T: np.ndarray          # (sigma^3,) uint32 — bit i set = gram NOT at offset i
    width: int             # state register width: 8, 16, or 32 (m == width)
    checkbit: int          # m - B
    sigma: int
    m: int


def build_sog(patterns: np.ndarray, sigma: int, width: int | None = None,
              native: bool | str = "auto") -> SOGTables:
    patterns = np.asarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    if width is None:
        width = m
    if width not in (8, 16, 32) or m != width:
        raise ValueError("SOG requires m == width in {8, 16, 32}")
    if native:
        from smatcher import native as nat
        T = nat.build_sog_native(patterns, sigma, width)
        if T is not None:
            return SOGTables(T, width, m - SOG_B, sigma, m)
        if native is True:
            raise RuntimeError("native builder requested but unavailable")
    full = np.uint32((1 << width) - 1)
    T = np.full(sigma ** 3, full, dtype=np.uint32)
    # grams at offsets i in [0, m-B]: g = c_i + c_{i+1}*sigma + c_{i+2}*sigma^2
    offs = np.arange(m - SOG_B + 1)
    g = (patterns[:, offs].astype(np.int64)
         + patterns[:, offs + 1].astype(np.int64) * sigma
         + patterns[:, offs + 2].astype(np.int64) * sigma * sigma)     # (p, m-B+1)
    bits = np.uint32(1) << offs.astype(np.uint32)                       # (m-B+1,)
    clear = np.broadcast_to(bits, g.shape)
    np.bitwise_and.at(T, g.reshape(-1), (full ^ clear).reshape(-1))
    return SOGTables(T, width, m - SOG_B, sigma, m)
