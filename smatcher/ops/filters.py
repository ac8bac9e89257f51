"""Filter-engine scan kernels (jnp / XLA path): Wu-Manber, SOG, SH, SBOM.

Each engine is a dense masked evaluation over all window positions — the
dense rewrite of the reference's skip loops (count-preserving, see
SURVEY.md §7 and ops/numpy_ref.py):

  WM   (cuda/cuda_wm.cu:136-176): last-3-gram hash -> SHIFT==0 filter,
       exact bucket verification replaces PREFIX+memcmp.
  SOG  (cuda/cuda_sog.cu:204-213): per-start AND of shifted T-table bit
       streams replaces the sequential E register (identical fire set after
       warmup), exact verification replaces the RK binary search.
  SH   (cuda/cuda_sh.cu:93-101): m-step backward reversed-trie walk at every
       end position; terminal == match (no verification needed).
  SBOM (cuda/cuda_sbom.cu:93-117): m-step backward factor-oracle walk; full
       walks gate exact verification.

All kernels process the text in `tile`-start chunks under lax.fori_loop so
device memory stays O(tile), and right-pad with the out-of-alphabet symbol.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from smatcher.automata.sh import SHTables
from smatcher.automata.sbom import SBOMTables
from smatcher.automata.wu import WMTables
from smatcher.automata.sog import SOGTables, SOG_B
from smatcher.automata.verify import VerifyTables
from smatcher.ops.common import (EngineDeviceAPI, pad_col, tiled_count,
                                     verify_starts)

DEFAULT_TILE = 1 << 20


def _slice(chunk, off, size):
    return jax.lax.dynamic_slice(chunk, (off,), (size,))


def _starts_iota(tile: int):
    return jax.lax.broadcasted_iota(jnp.int32, (tile, 1), 0).reshape(-1)


# ---------------------------------------------------------------------------
# Wu-Manber
# ---------------------------------------------------------------------------

def wm_count_core(text, shift_ext, packed, bucket_ids_flat, *, sigma, m, lmax, tile):
    """shift_ext: SHIFT extended to the (sigma+1)-char hash space so pad
    windows hash to non-candidate (init-value) slots."""
    n = text.shape[0]
    if n < m:
        return jnp.int32(0)
    from smatcher.oracles.reference import WM_BITS_IN_SHIFT
    b = 1 << WM_BITS_IN_SHIFT  # reference 2-bit block hash (wu/wu.c:64-67)

    def per_tile(chunk, limit):
        c0 = _slice(chunk, m - 3, tile).astype(jnp.int32)
        c1 = _slice(chunk, m - 2, tile).astype(jnp.int32)
        c2 = _slice(chunk, m - 1, tile).astype(jnp.int32)
        h = (c0 * b + c1) * b + c2
        cand = (shift_ext[h] == 0) & (_starts_iota(tile) < limit)
        matched = verify_starts(chunk, cand, packed=packed,
                                bucket_ids_flat=bucket_ids_flat,
                                lmax=lmax, sigma=sigma, m=m)
        return jnp.sum(matched, dtype=jnp.int32)

    return tiled_count(per_tile, text, n, tile=tile, m=m, sigma=sigma)


@functools.partial(jax.jit, static_argnames=("sigma", "m", "lmax", "tile", "n"))
def wm_count(text, shift_ext, packed, bucket_ids_flat, *, sigma, m, lmax, tile, n):
    return wm_count_core(text[:n], shift_ext, packed, bucket_ids_flat,
                         sigma=sigma, m=m, lmax=lmax, tile=tile)


# ---------------------------------------------------------------------------
# SOG
# ---------------------------------------------------------------------------

def sog_count_core(text, t_table, packed, bucket_ids_flat, *, sigma, m, lmax, tile):
    """t_table: (sigma**3,) uint32.  Pad grams clip into the table; any false
    candidate they produce is killed by exact verification."""
    n = text.shape[0]
    if n < m:
        return jnp.int32(0)

    def per_tile(chunk, limit):
        L = chunk.shape[0]                     # tile + m - 1
        n_grams = L - 2
        g = (_slice(chunk, 0, n_grams).astype(jnp.int32)
             + _slice(chunk, 1, n_grams).astype(jnp.int32) * sigma
             + _slice(chunk, 2, n_grams).astype(jnp.int32) * (sigma * sigma))
        v = t_table[jnp.minimum(g, t_table.shape[0] - 1)]          # (n_grams,) uint32
        acc = jnp.zeros((tile,), jnp.uint32)
        for i in range(m - SOG_B + 1):
            acc = acc | ((jax.lax.dynamic_slice(v, (i,), (tile,)) >> np.uint32(i))
                         & np.uint32(1))
        cand = (acc == 0) & (_starts_iota(tile) < limit)
        matched = verify_starts(chunk, cand, packed=packed,
                                bucket_ids_flat=bucket_ids_flat,
                                lmax=lmax, sigma=sigma, m=m)
        return jnp.sum(matched, dtype=jnp.int32)

    return tiled_count(per_tile, text, n, tile=tile, m=m, sigma=sigma)


@functools.partial(jax.jit, static_argnames=("sigma", "m", "lmax", "tile", "n"))
def sog_count(text, t_table, packed, bucket_ids_flat, *, sigma, m, lmax, tile, n):
    return sog_count_core(text[:n], t_table, packed, bucket_ids_flat,
                          sigma=sigma, m=m, lmax=lmax, tile=tile)


# ---------------------------------------------------------------------------
# SH / SBOM backward walks
# ---------------------------------------------------------------------------

def _backward_walk(chunk, trans_flat, sig_p, m, tile):
    """Run the m-step backward walk for every window end in the tile.

    Returns (state, alive): final state reached (last live state) and whether
    all m steps succeeded."""
    state = jnp.zeros((tile,), jnp.int32)
    alive = jnp.ones((tile,), bool)
    # window ends at local position m-1+s for start s; step i reads char end-i
    for i in range(m):
        c = _slice(chunk, m - 1 - i, tile).astype(jnp.int32)
        nxt = trans_flat[state * sig_p + c]
        step = alive & (nxt >= 0)
        state = jnp.where(step, nxt, state)
        alive = step
    return state, alive


def sh_count_core(text, trans_flat, final, *, sigma, m, tile):
    """trans_flat: (S*(sigma+1),) int32 reversed-trie transitions with -1
    missing and a -1 pad column.  Terminal states are exactly full-pattern
    walks, so no verification is needed."""
    n = text.shape[0]
    if n < m:
        return jnp.int32(0)
    sig_p = sigma + 1

    def per_tile(chunk, limit):
        state, _ = _backward_walk(chunk, trans_flat, sig_p, m, tile)
        valid = _starts_iota(tile) < limit
        return jnp.sum(jnp.where(valid, final[state], 0), dtype=jnp.int32)

    return tiled_count(per_tile, text, n, tile=tile, m=m, sigma=sigma)


@functools.partial(jax.jit, static_argnames=("sigma", "m", "tile", "n"))
def sh_count(text, trans_flat, final, *, sigma, m, tile, n):
    return sh_count_core(text[:n], trans_flat, final, sigma=sigma, m=m, tile=tile)


def sbom_count_core(text, trans_flat, final_count, packed, bucket_ids_flat, *,
                    sigma, m, lmax, tile):
    n = text.shape[0]
    if n < m:
        return jnp.int32(0)
    sig_p = sigma + 1

    def per_tile(chunk, limit):
        state, alive = _backward_walk(chunk, trans_flat, sig_p, m, tile)
        cand = alive & (final_count[state] > 0) & (_starts_iota(tile) < limit)
        matched = verify_starts(chunk, cand, packed=packed,
                                bucket_ids_flat=bucket_ids_flat,
                                lmax=lmax, sigma=sigma, m=m)
        return jnp.sum(matched, dtype=jnp.int32)

    return tiled_count(per_tile, text, n, tile=tile, m=m, sigma=sigma)


@functools.partial(jax.jit, static_argnames=("sigma", "m", "lmax", "tile", "n"))
def sbom_count(text, trans_flat, final_count, packed, bucket_ids_flat, *,
               sigma, m, lmax, tile, n):
    return sbom_count_core(text[:n], trans_flat, final_count, packed,
                           bucket_ids_flat, sigma=sigma, m=m, lmax=lmax, tile=tile)


# ---------------------------------------------------------------------------
# Device-resident engine wrappers
# ---------------------------------------------------------------------------

class _FilterScanner(EngineDeviceAPI):
    """Shared device-resident wrapper: count() is a subclass's capless jnp
    scan (_count_jnp); positions, matches and pipelined counts come from
    EngineDeviceAPI."""

    def count(self, text) -> int:
        from smatcher.ops.common import check_count32
        text = jnp.asarray(text, jnp.uint8)
        n = int(text.shape[0])
        check_count32(n)      # int32 accumulators (CLAUDE.md invariant)
        return int(self._count_jnp(text, n))


class WMScanner(_FilterScanner):
    def __init__(self, wm: WMTables, vt: VerifyTables, *, tile: int = DEFAULT_TILE):
        self.m, self.sigma, self.tile, self.lmax = wm.m, wm.sigma, tile, vt.lmax
        # extend SHIFT to cover hashes containing the pad char (value sigma)
        from smatcher.automata.wu import hash3_np
        ext_size = int(hash3_np(np.int32(wm.sigma), np.int32(wm.sigma),
                                np.int32(wm.sigma))) + 1
        shift_ext = np.full(ext_size, wm.m - 3 + 1, np.int32)
        shift_ext[:wm.shiftsize] = wm.shift
        self.shift_ext = jnp.asarray(shift_ext)
        self.packed = jnp.asarray(vt.packed)
        self.bucket_ids = jnp.asarray(vt.bucket_ids.reshape(-1))

    def _count_jnp(self, text, n):
        return wm_count(text, self.shift_ext, self.packed, self.bucket_ids,
                        sigma=self.sigma, m=self.m, lmax=self.lmax,
                        tile=self.tile, n=n)

    def core(self, ext):
        return wm_count_core(ext, self.shift_ext, self.packed, self.bucket_ids,
                             sigma=self.sigma, m=self.m, lmax=self.lmax, tile=self.tile)


class SOGScanner(_FilterScanner):
    def __init__(self, sog: SOGTables, vt: VerifyTables, *, tile: int = DEFAULT_TILE):
        self.m, self.sigma, self.tile, self.lmax = sog.m, sog.sigma, tile, vt.lmax
        self.t_table = jnp.asarray(sog.T)
        self.packed = jnp.asarray(vt.packed)
        self.bucket_ids = jnp.asarray(vt.bucket_ids.reshape(-1))

    def _count_jnp(self, text, n):
        return sog_count(text, self.t_table, self.packed, self.bucket_ids,
                         sigma=self.sigma, m=self.m, lmax=self.lmax,
                         tile=self.tile, n=n)

    def core(self, ext):
        return sog_count_core(ext, self.t_table, self.packed, self.bucket_ids,
                              sigma=self.sigma, m=self.m, lmax=self.lmax, tile=self.tile)


class SHScanner(_FilterScanner):
    def __init__(self, sh: SHTables, *, tile: int = DEFAULT_TILE):
        self.m, self.sigma, self.tile = sh.m, sh.sigma, tile
        self.trans = jnp.asarray(pad_col(sh.transition, -1).reshape(-1))
        self.final = jnp.asarray(sh.final.astype(np.int32))

    def _count_jnp(self, text, n):
        return sh_count(text, self.trans, self.final, sigma=self.sigma,
                        m=self.m, tile=self.tile, n=n)

    def core(self, ext):
        return sh_count_core(ext, self.trans, self.final,
                             sigma=self.sigma, m=self.m, tile=self.tile)


class SBOMScanner(_FilterScanner):
    def __init__(self, sb: SBOMTables, vt: VerifyTables, *, tile: int = DEFAULT_TILE):
        self.m, self.sigma, self.tile, self.lmax = sb.m, sb.sigma, tile, vt.lmax
        self.trans = jnp.asarray(pad_col(sb.transition, -1).reshape(-1))
        self.final_count = jnp.asarray(sb.final_count)
        self.packed = jnp.asarray(vt.packed)
        self.bucket_ids = jnp.asarray(vt.bucket_ids.reshape(-1))

    def _count_jnp(self, text, n):
        return sbom_count(text, self.trans, self.final_count, self.packed,
                          self.bucket_ids, sigma=self.sigma, m=self.m,
                          lmax=self.lmax, tile=self.tile, n=n)

    def core(self, ext):
        return sbom_count_core(ext, self.trans, self.final_count, self.packed,
                               self.bucket_ids, sigma=self.sigma, m=self.m,
                               lmax=self.lmax, tile=self.tile)
