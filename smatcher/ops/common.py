"""Shared kernel-side utilities (jnp).

Padding convention: kernels right-pad text with the out-of-alphabet symbol
``sigma``.  Tables consumed by kernels are extended so the pad symbol is
always safe (resets AC to root, kills SH/SBOM walks, lands WM hashes in
non-candidate slots); filter-engine false candidates on pad windows are
killed by exact verification (a pad byte can never equal a pattern byte).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def engine_scanner(scanner):
    """The device scanner behind an engine's positions, matches and
    pipelined counts: one FastScanner over the engine's own pattern codes,
    built on first use.  Every engine counts the same windows (the shared
    semantics invariant), so its match set is the engine's.  Options for
    it (cap=, backend=, interpret=) come from scanner.fast_opts."""
    fs = getattr(scanner, "_fast", None)
    if fs is None:
        codes = getattr(scanner, "pattern_codes", None)
        if codes is None:
            raise ValueError(
                "this engine needs its pattern codes for device positions, "
                "matches and pipelined counts; construct it via "
                "make_engine, or set scanner.pattern_codes = patterns.codes")
        from smatcher.ops.fast import FastScanner, build_fast
        fs = FastScanner(build_fast(codes, scanner.sigma),
                         **getattr(scanner, "fast_opts", {}))
        scanner._fast = fs
    return fs


class EngineDeviceAPI:
    """The surface every named engine shares beyond its own count(): match
    positions, pattern attribution and pipelined counts, all on the device
    through engine_scanner(self)."""

    def positions(self, text):
        return engine_scanner(self).positions(text)

    def positions_file(self, path: str, *, chunk: int = 1 << 28):
        return engine_scanner(self).positions_file(path, chunk=chunk)

    def matches(self, text):
        return engine_scanner(self).matches(text)

    def count_per_pattern(self, text):
        return engine_scanner(self).count_per_pattern(text)

    def count_async(self, text):
        return engine_scanner(self).count_async(text)

    def scan_many(self, texts):
        return engine_scanner(self).scan_many(texts)

    def count_file(self, path: str, *, chunk: int = 1 << 28,
                   depth: int = 3) -> int:
        return engine_scanner(self).count_file(path, chunk=chunk,
                                               depth=depth)


def stream_count_file(count_async, m: int, path: str, *,
                      chunk: int = 1 << 28, depth: int = 3) -> int:
    """Stream a pre-encoded corpus file through `count_async` without
    loading it fully: piece i is scanned over [i*chunk, (i+1)*chunk + m - 1)
    so every window start belongs to exactly one piece — the reference's
    (m-1)-halo rank partition (main.c:463-477) applied to disk IO.  Up to
    `depth` pieces stay in flight so disk reads, host->device copies and
    device scans overlap.  The single implementation behind
    FastScanner.count_file and every engine's count_file."""
    import os
    size = os.path.getsize(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    total = 0
    inflight = []
    for start in range(0, max(size - m + 1, 1), chunk):
        stop = min(size, start + chunk + m - 1)
        inflight.append(count_async(np.asarray(mm[start:stop])))
        if len(inflight) >= depth:
            total += inflight.pop(0).result()
    for f in inflight:
        total += f.result()
    return total


def stream_positions_file(positions_fn, m: int, path: str, *,
                          chunk: int = 1 << 28) -> np.ndarray:
    """All match start positions of a pre-encoded corpus file, sorted,
    without loading it fully: the same (m-1)-halo piece partition as
    stream_count_file (each piece owns starts [i*chunk, (i+1)*chunk)), with
    `positions_fn` enumerating each piece (itself pipelined and unbounded —
    ops/fast.py FastScanner.positions).  Because pieces are int32-sized
    internally but offsets accumulate in int64, files >= 2^31 bytes stream
    fine — the reference only ever counts its positions (SURVEY.md: the
    column loops in cuda_*); here they are a first-class streaming output."""
    import os
    size = os.path.getsize(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out = []
    for start in range(0, max(size - m + 1, 1), chunk):
        stop = min(size, start + chunk + m - 1)
        pos = positions_fn(np.asarray(mm[start:stop]))
        if pos.size:
            out.append(pos.astype(np.int64) + start)
    if not out:
        return np.empty((0,), np.int64)
    return np.concatenate(out)


def check_count32(n: int) -> None:
    """Counts are int32 end-to-end (per-tile accumulators, the candidate
    counter, psum); a single scan over >= 2^31 window starts could wrap.  Callers
    split such corpora (FastScanner.count_file) or shard across devices."""
    if n >= (1 << 31):
        raise ValueError(
            f"text length {n} >= 2^31: counts are int32 — scan in pieces "
            "(count_file) or shard across devices")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_col(table: np.ndarray, value: int) -> np.ndarray:
    """Append one column (the pad symbol's) with a constant value."""
    S = table.shape[0]
    return np.concatenate([table, np.full((S, 1), value, table.dtype)], axis=1)


def word_streams(chunk: jnp.ndarray, m: int, n_starts: int) -> jnp.ndarray:
    """(n_starts, W) int32 little-endian packed windows of chunk.

    Word w of window s packs chunk[s+4w .. s+4w+nb) (nb = min(4, m-4w)),
    zero-padded — bit-identical to automata.verify.pack_rows.  Built from
    shifted slices only (no gathers)."""
    t = chunk.astype(jnp.int32)
    W = cdiv(m, 4)
    streams = []
    for w in range(W):
        nb = min(4, m - 4 * w)
        acc = jnp.zeros((n_starts,), jnp.int32)
        for k in range(nb):
            off = 4 * w + k
            acc = acc | (jax.lax.dynamic_slice(t, (off,), (n_starts,)) << (8 * k))
        streams.append(acc)
    return jnp.stack(streams, axis=1)


def verify_starts(chunk: jnp.ndarray, cand: jnp.ndarray, *, packed: jnp.ndarray,
                  bucket_ids_flat: jnp.ndarray, lmax: int, sigma: int, m: int) -> jnp.ndarray:
    """Exact verification of candidate window starts.

    chunk: (L,) uint8; cand: (n_starts,) bool over starts [0, n_starts).
    Returns bool (n_starts,): window equals >= 1 pattern.  Dense
    replacement for the reference's three verification paths (WM PREFIX
    lists wu/wu.c:184-201, SOG RK binary search sog/sog8.c:51-95, SBOM
    state lists sbom/sbom.c:176-190): last-gram buckets padded to lmax,
    word-packed full-window compares, <=1 count per position."""
    n_starts = cand.shape[0]
    win = word_streams(chunk, m, n_starts)                      # (n_starts, W)
    c0 = jax.lax.dynamic_slice(chunk, (m - 3,), (n_starts,)).astype(jnp.int32)
    c1 = jax.lax.dynamic_slice(chunk, (m - 2,), (n_starts,)).astype(jnp.int32)
    c2 = jax.lax.dynamic_slice(chunk, (m - 1,), (n_starts,)).astype(jnp.int32)
    key = c0 + c1 * sigma + c2 * (sigma * sigma)                # clipped gathers OK
    key = jnp.minimum(key, bucket_ids_flat.shape[0] // lmax - 1)

    def body(l, matched):
        pid = bucket_ids_flat[key * lmax + l]                   # (n_starts,)
        live = cand & (pid >= 0) & ~matched
        rows = jnp.take(packed, jnp.maximum(pid, 0), axis=0)    # (n_starts, W)
        eq = jnp.all(rows == win, axis=1)
        return matched | (live & eq)

    matched = jnp.zeros((n_starts,), bool)
    return jax.lax.fori_loop(0, lmax, body, matched)


def tiled_count(per_tile, text: jnp.ndarray, n: int, *, tile: int, m: int,
                sigma: int) -> jnp.ndarray:
    """Sum per_tile(chunk, limit) over tiles of `tile` owned starts each.

    per_tile receives a (tile + m - 1,) chunk plus the number of VALID starts
    in it (windows beyond `limit` overlap this function's own tail padding
    and must not count — positional masking, not a pad sentinel, so it also
    holds for sigma=256 where no out-of-alphabet uint8 value exists)."""
    num_tiles = max(1, cdiv(max(n - m + 1, 1), tile))
    padded_len = num_tiles * tile + m - 1
    pad_sym = min(sigma, 255)
    padded = jnp.full((padded_len,), pad_sym, jnp.uint8).at[:n].set(text[:n])
    n_valid_total = max(n - m + 1, 0)

    def body(i, acc):
        chunk = jax.lax.dynamic_slice(padded, (i * tile,), (tile + m - 1,))
        limit = jnp.clip(n_valid_total - i * tile, 0, tile)
        return acc + per_tile(chunk, limit)

    return jax.lax.fori_loop(0, num_tiles, body, jnp.int32(0))
