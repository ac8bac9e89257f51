"""Aho-Corasick scan kernels (jnp / XLA path).

Design (vs the reference's cuda/cuda_ac.cu):
  - The failure-link while-loop per byte (cuda_ac.cu:90-94) is resolved at
    build time into a completed DFA — one gather per byte.
  - The per-thread decomposition with (m-1)-char fresh-state warmup
    (cuda_ac.cu:34-46) becomes lane parallelism: the text is split into
    `lanes` segments with (m-1)-byte halos; all lanes step their DFA in
    lockstep under `lax.scan`, so each step is one (lanes,)-wide gather from
    the (cache-sized) packed table.  A depth-m terminal can't fire within a
    lane's first m-1 steps, so per-lane counts partition exactly.
  - `q`-char stepping uses composed transition tables that pack
    (next_state, #terminals visited) — q bytes per serial gather, exact
    counts (automata.ac.multi_step_tables).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from smatcher.automata.ac import ACTables, multi_step_tables
from smatcher.ops.common import EngineDeviceAPI, cdiv

#: parallel DFA lanes: the scan takes n/lanes sequential steps, each a
#: (lanes,)-wide gather.  On an H200 (700 W) 65536 lanes scanned 256 MiB of
#: DNA (m=8, p=10k) in 48.6 ms against 570 ms for 8192 (PERF.md).
AC_LANES = 65536


def segment(text: jnp.ndarray, n: int, *, lanes: int, m: int, sigma: int) -> jnp.ndarray:
    """(lanes, seg + m - 1) uint8 overlapped segments, right-padded.

    The pad value is the out-of-alphabet sentinel where one exists
    (sigma <= 255); for the byte alphabet it wraps to 255 (a real char) and
    the scan cores mask pad positions by GLOBAL POSITION instead — pads are
    always a suffix of a lane's stream, so a final firing at a real
    position can never have consumed a pad byte."""
    seg = max(1, cdiv(n, lanes))
    pad = min(sigma, 255)
    padded = jnp.full((lanes * seg + m - 1,), pad, jnp.uint8).at[:n].set(text[:n])
    main = padded[: lanes * seg].reshape(lanes, seg)
    halo_idx = (jnp.arange(lanes) * seg)[:, None] + seg + jnp.arange(m - 1)[None, :]
    halo = padded[halo_idx.reshape(-1)].reshape(lanes, m - 1)
    return jnp.concatenate([main, halo], axis=1)


def ac_count_core(text: jnp.ndarray, dp_flat: jnp.ndarray, *, sig_p: int, m: int,
                  lanes: int) -> jnp.ndarray:
    """Traceable core (usable under jit and shard_map): total match count.
    dp_flat: (S * sig_p,) int32 packed next*2|final.

    Finals are masked by global position (< n): exact for every sigma
    including 256, where no out-of-alphabet uint8 pad symbol exists
    (pads are a per-lane suffix, so they can't influence real windows)."""
    n = text.shape[0]
    if n < m:
        return jnp.int32(0)
    tiles = segment(text, n, lanes=lanes, m=m, sigma=sig_p - 1).T  # (T, lanes)
    seg = max(1, cdiv(n, lanes))
    lane_base = jnp.arange(lanes, dtype=jnp.int32) * seg           # (lanes,)

    def step(carry, chars):
        state, t = carry
        v = dp_flat[state * sig_p + chars]
        valid = (lane_base + t) < n
        c = jnp.sum(jnp.where(valid, v & 1, 0), dtype=jnp.int32)
        return (v >> 1, t + 1), c

    _, counts = jax.lax.scan(step, (jnp.zeros((lanes,), jnp.int32),
                                    jnp.int32(0)), tiles.astype(jnp.int32))
    return jnp.sum(counts, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("sig_p", "m", "lanes", "n"))
def ac_count(text: jnp.ndarray, dp_flat: jnp.ndarray, *, sig_p: int, m: int,
             lanes: int, n: int) -> jnp.ndarray:
    """Total match count. dp_flat: (S * sig_p,) int32 packed next*2|final."""
    return ac_count_core(text[:n], dp_flat, sig_p=sig_p, m=m, lanes=lanes)


@functools.partial(jax.jit, static_argnames=("sig_p", "m", "lanes", "n", "q", "cbits"))
def ac_count_q(text: jnp.ndarray, tq_flat: jnp.ndarray, *, sig_p: int, m: int,
               lanes: int, n: int, q: int, cbits: int) -> jnp.ndarray:
    """q-char-per-step scan using a composed table.

    tq_flat: (S * sig_p**q,) int32 packing next_state << cbits | visits."""
    if n < m:
        return jnp.int32(0)
    tiles = segment(text, n, lanes=lanes, m=m, sigma=sig_p - 1)    # (lanes, T)
    T = tiles.shape[1]
    steps = cdiv(T, q)
    pad = steps * q - T
    if pad:
        tiles = jnp.concatenate(
            [tiles, jnp.full((tiles.shape[0], pad), sig_p - 1, jnp.uint8)], axis=1)
    digits = tiles.reshape(tiles.shape[0], steps, q).astype(jnp.int32)
    grams = jnp.zeros(digits.shape[:2], jnp.int32)
    for j in range(q):                       # gram = c0*sig_p^{q-1} + ... + c_{q-1}
        grams = grams * sig_p + digits[:, :, j]
    grams = grams.T                          # (steps, lanes)
    G = sig_p ** q
    cmask = (1 << cbits) - 1

    def step(state, g):
        v = tq_flat[state * G + g]
        return v >> cbits, jnp.sum(v & cmask, dtype=jnp.int32)

    _, counts = jax.lax.scan(step, jnp.zeros((lanes,), jnp.int32), grams)
    return jnp.sum(counts, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("sig_p", "m", "lanes", "n"))
def ac_match_ends(text: jnp.ndarray, dp_flat: jnp.ndarray, *, sig_p: int, m: int,
                  lanes: int, n: int) -> jnp.ndarray:
    """Per-position match indicators (uint8, 1 where a window *ends* with a
    match), length n.  The reference computes these internally but only
    counts; we expose them (match positions API)."""
    if n < m:
        return jnp.zeros((n,), jnp.uint8)
    tiles = segment(text, n, lanes=lanes, m=m, sigma=sig_p - 1).T

    def step(state, chars):
        v = dp_flat[state * sig_p + chars]
        return v >> 1, (v & 1).astype(jnp.uint8)

    _, bits = jax.lax.scan(step, jnp.zeros((tiles.shape[1],), jnp.int32),
                           tiles.astype(jnp.int32))               # (T, lanes)
    lanes_n = tiles.shape[1]
    seg = max(1, cdiv(n, lanes_n))
    bits = bits.T                                                  # (lanes, T)
    # owned region of lane i: local t in [m-1, seg+m-1) -> global i*seg + t
    owned = bits[:, m - 1:]                                        # (lanes, seg)
    flat = jnp.zeros((lanes_n * seg,), jnp.uint8)
    flat = flat.at[m - 1:].set(owned.reshape(-1)[: lanes_n * seg - (m - 1)])
    return flat[:n]


class ACScanner(EngineDeviceAPI):
    """Device-resident AC engine: builds/holds tables, exposes count/ends."""

    def __init__(self, ac: ACTables, *, lanes: int = AC_LANES, q: int = 1):
        self.m = ac.m
        self.sigma = ac.sigma
        self.sig_p = ac.sigma + 1
        self.lanes = lanes
        self.q = q
        if q == 1:
            self.dp = jnp.asarray(ac.delta_packed.reshape(-1))
            self.tq = None
            self.cbits = 0
        else:
            tq, cbits = multi_step_tables(ac, q)
            if tq.dtype == np.int64 and not jax.config.jax_enable_x64:
                # jnp.asarray would silently truncate the packed
                # next-state|count fields to int32, corrupting the scan
                raise ValueError(
                    f"q={q} composed AC table needs int64 entries for this "
                    "pattern set (packed next|count exceeds int32); use a "
                    "smaller q or enable jax_enable_x64")
            self.tq = jnp.asarray(tq.reshape(-1))
            self.cbits = cbits
            self.dp = jnp.asarray(ac.delta_packed.reshape(-1))

    def count(self, text) -> int:
        from smatcher.ops.common import check_count32
        text = jnp.asarray(text, jnp.uint8)
        n = int(text.shape[0])
        check_count32(n)      # int32 accumulators (CLAUDE.md invariant)
        if self.q == 1:
            return int(ac_count(text, self.dp, sig_p=self.sig_p, m=self.m,
                                lanes=self.lanes, n=n))
        self._check_pad()
        return int(ac_count_q(text, self.tq, sig_p=self.sig_p, m=self.m,
                              lanes=self.lanes, n=n, q=self.q, cbits=self.cbits))

    def core(self, ext: jnp.ndarray) -> jnp.ndarray:
        """Traceable per-shard count (for shard_map distribution)."""
        return ac_count_core(ext, self.dp, sig_p=self.sig_p, m=self.m,
                             lanes=self.lanes)

    def _check_pad(self):
        if self.sig_p > 256:
            raise ValueError(
                "the q-step composed AC scan pads partial grams with the "
                "out-of-alphabet symbol sigma, which does not fit uint8 for "
                "sigma=256; use q=1 (positionally masked) or the fast "
                "scanner for the byte alphabet")

    def match_ends(self, text) -> np.ndarray:
        text = jnp.asarray(text, jnp.uint8)
        n = int(text.shape[0])
        return np.asarray(ac_match_ends(text, self.dp, sig_p=self.sig_p,
                                        m=self.m, lanes=self.lanes, n=n))
