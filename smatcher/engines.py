"""Engine facade: build tables + device-resident scanner per algorithm.

The user-facing equivalent of the reference's per-algorithm
preproc_*/search_* pairs (smatcher.h:89-133) — one constructor per engine,
sharing the PatternSet/alphabet contract.
"""

from __future__ import annotations

import numpy as np

from smatcher.core.patterns import PatternSet
from smatcher.automata import (
    build_ac, build_sh, build_sbom, build_wm, build_sog, build_verify,
)
from smatcher.ops.ac import AC_LANES, ACScanner
from smatcher.ops.filters import WMScanner, SOGScanner, SHScanner, SBOMScanner, DEFAULT_TILE

ENGINE_NAMES = ("ac", "sh", "sbom", "wm", "sog8", "sog16", "sog32")


def _codes(patterns) -> tuple[np.ndarray, int]:
    if isinstance(patterns, PatternSet):
        return patterns.codes, patterns.sigma
    raise TypeError("make_engine expects a PatternSet")


def build_tables(name: str, patterns: PatternSet) -> dict:
    """Preprocessing only: the named engine's table dataclasses, as a dict
    suitable for core.checkpoint.save_tables (keys: 'main' and, for the
    verifying engines, 'verify').  name may also be 'fast'."""
    codes, sigma = _codes(patterns)
    if name == "ac":
        return {"main": build_ac(codes, sigma)}
    if name == "sh":
        return {"main": build_sh(codes, sigma)}
    if name == "sbom":
        return {"main": build_sbom(codes, sigma),
                "verify": build_verify(codes, sigma)}
    if name == "wm":
        return {"main": build_wm(codes, sigma),
                "verify": build_verify(codes, sigma)}
    if name in ("sog8", "sog16", "sog32"):
        return {"main": build_sog(codes, sigma, int(name[3:])),
                "verify": build_verify(codes, sigma)}
    if name == "fast":
        from smatcher.ops.fast import build_fast
        return {"main": build_fast(codes, sigma)}
    raise ValueError(f"unknown engine {name!r}; expected one of {ENGINE_NAMES}")


def make_engine_from_tables(name: str, tables: dict, *, lanes: int = AC_LANES,
                            q: int = 1, tile: int = DEFAULT_TILE, **opts):
    """Construct the named engine from prebuilt tables (see build_tables /
    core.checkpoint.load_tables) — production scans skip preprocessing."""
    main = tables["main"]
    if name == "ac":
        return ACScanner(main, lanes=lanes, q=q)
    if name == "sh":
        return SHScanner(main, tile=tile)
    if name == "sbom":
        return SBOMScanner(main, tables["verify"], tile=tile)
    if name == "wm":
        return WMScanner(main, tables["verify"], tile=tile)
    if name in ("sog8", "sog16", "sog32"):
        return SOGScanner(main, tables["verify"], tile=tile)
    if name == "fast":
        from smatcher.ops.fast import FastScanner
        return FastScanner(main, tile=tile, **opts)
    raise ValueError(f"unknown engine {name!r}; expected one of {ENGINE_NAMES}")


def make_engine(name: str, patterns: PatternSet, *, lanes: int = AC_LANES,
                q: int = 1, tile: int = DEFAULT_TILE, **fast_opts):
    """Build the named engine over the pattern set.

    name: one of ac, sh, sbom, wm, sog8, sog16, sog32.
    lanes/q apply to ac; tile to the filter engines.  count() runs the
    engine's own scan; positions, matches and pipelined counts run on the
    device through a FastScanner over the same codes (ops/common.py:
    engine_scanner), which takes fast_opts (cap=, backend=, interpret=)."""
    eng = make_engine_from_tables(name, build_tables(name, patterns),
                                  lanes=lanes, q=q, tile=tile)
    eng.pattern_codes = np.asarray(patterns.codes, np.uint8)
    eng.fast_opts = fast_opts
    return eng


def make_fast(patterns: PatternSet, **opts):
    """The shared fast backend (ops/fast.py): same counts as every engine,
    at production speed (fingerprint filter kernel + sparse verify)."""
    from smatcher.ops.fast import FastScanner, build_fast
    codes, sigma = _codes(patterns)
    n_stages = opts.pop("n_stages", None)
    s = FastScanner(build_fast(codes, sigma, n_stages=n_stages), **opts)
    s.pattern_codes = np.asarray(codes, np.uint8)
    return s


def make_distributed(name: str, patterns: PatternSet, mesh, **opts):
    """Distributed engine over a 1-D device mesh: tables replicated, text
    sharded with a halo exchange, count psum-reduced (parallel/dist.py).
    The per-shard scan is the engine's own core; a FastScanner over the
    same codes rides along as the exact overflow ladder, so distributed
    counts are TOTAL at any match density (every engine counts the same
    windows — the shared semantics invariant)."""
    from smatcher.parallel.dist import DistributedCounter
    from smatcher.ops.common import engine_scanner
    if name == "fast":
        eng = fast = make_fast(patterns, **opts)
    else:
        eng = make_engine(name, patterns, **opts)
        fast = engine_scanner(eng)
    return DistributedCounter(eng.core, mesh, m=patterns.m,
                              sigma=patterns.sigma, fast=fast)


def _device_u8(text):
    """One uint8 device array shared by every length group's sub-scan —
    without pulling an already-device-resident text back to host."""
    import jax.numpy as jnp
    text = jnp.asarray(text)
    return text if text.dtype == jnp.uint8 else text.astype(jnp.uint8)


class _MixedFuture:
    """In-flight mixed-length scan: one sub-future per length group; the
    host fetch happens only at result()."""

    def __init__(self, futures):
        self._futures = futures

    def result(self) -> int:
        return sum(f.result() for f in self._futures)


class MixedScanner:
    """Mixed-length pattern matching: one sub-scanner per distinct pattern
    length, all scanning the same device-resident text, results combined.

    The reference (and every uniform engine here) requires one shared
    length m per run (main.c:456-459 indexes pattern2[p*m]); this wrapper
    lifts that restriction.  count() is the sum of each length's
    windows-with-a-match count (identical to running the reference once per
    length); positions()/matches() merge the per-length enumerations with
    global pattern ids.  Sub-scans are dispatched async, so the G length
    groups pipeline on device and pay one host fetch each, not G round
    trips per group."""

    def __init__(self, patterns, scanners):
        self.patterns = patterns
        self.scanners = list(scanners)
        self.lengths = patterns.lengths

    def count_async(self, text) -> _MixedFuture:
        text = _device_u8(text)
        return _MixedFuture([s.count_async(text) for s in self.scanners])

    def count(self, text) -> int:
        return self.count_async(text).result()

    def scan_many(self, texts) -> list:
        futures = [self.count_async(t) for t in texts]
        return [f.result() for f in futures]

    def positions(self, text):
        """(starts, lengths): every match start with the matched pattern
        length, sorted by (start, length).  A start matching two lengths
        appears once per length."""
        text = _device_u8(text)
        starts, lens = [], []
        for m, s in zip(self.lengths, self.scanners):
            pos = np.asarray(s.positions(text), np.int64)
            starts.append(pos)
            lens.append(np.full(pos.shape, m, np.int64))
        starts = np.concatenate(starts)
        lens = np.concatenate(lens)
        order = np.lexsort((lens, starts))
        return starts[order], lens[order]

    def matches(self, text):
        """(starts, pattern_ids): global ids into the original mixed set,
        sorted by (start, id); duplicates-by-length enumerate separately."""
        text = _device_u8(text)
        starts, ids = [], []
        for gids, s in zip(self.patterns.ids, self.scanners):
            pos, local = s.matches(text)
            starts.append(np.asarray(pos, np.int64))
            ids.append(gids[np.asarray(local, np.int64)])
        starts = np.concatenate(starts)
        ids = np.concatenate(ids)
        order = np.lexsort((ids, starts))
        return starts[order], ids[order]

    def count_per_pattern(self, text) -> np.ndarray:
        """(p_size,) int64 match-start counts per ORIGINAL pattern id
        (duplicates within a length group credit the smallest id, as in
        matches()); sums to count(text)."""
        _, ids = self.matches(text)
        return np.bincount(np.asarray(ids, np.int64),
                           minlength=self.patterns.p_size).astype(np.int64)

    def count_file(self, path: str, *, chunk: int = 1 << 28,
                   depth: int = 3) -> int:
        """Stream a disk corpus once: piece i spans [i*chunk, i*chunk +
        chunk + m_g - 1) PER GROUP g, so each group's starts partition
        exactly (the (m-1)-halo scheme of common.stream_count_file), while
        the file is read a single time at the largest length's halo."""
        import os
        size = os.path.getsize(path)
        m_min, m_max = self.lengths[0], self.lengths[-1]
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        total = 0
        inflight = []
        # Grid by the SHORTEST length: shorter groups own starts past the
        # longest group's final piece (size - m_max < start <= size - m_min).
        for start in range(0, max(size - m_min + 1, 1), chunk):
            piece = np.asarray(mm[start:min(size, start + chunk + m_max - 1)])
            # one host->device upload per piece, shared by every length
            # group's sub-scan (a per-group jnp.asarray(piece[:end]) would
            # re-transfer ~chunk bytes G times to the device)
            pdev = _device_u8(piece)
            for m, s in zip(self.lengths, self.scanners):
                if start > size - m:
                    continue                 # no starts left for this length
                end = min(piece.shape[0], chunk + m - 1)
                inflight.append(s.count_async(pdev[:end]))
                if len(inflight) >= depth * len(self.scanners):
                    total += inflight.pop(0).result()
        for f in inflight:
            total += f.result()
        return total

    def positions_file(self, path: str, *, chunk: int = 1 << 28):
        """(starts, lengths) streamed from disk: the count_file piece grid
        (by the shortest length), each piece enumerated per group, offsets
        accumulated in int64 so files >= 2^31 bytes stream fine."""
        import os
        size = os.path.getsize(path)
        m_min, m_max = self.lengths[0], self.lengths[-1]
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        out_s, out_l = [], []
        for start in range(0, max(size - m_min + 1, 1), chunk):
            piece = np.asarray(mm[start:min(size, start + chunk + m_max - 1)])
            pdev = _device_u8(piece)         # shared upload (see count_file)
            for m, s in zip(self.lengths, self.scanners):
                if start > size - m:
                    continue
                end = min(piece.shape[0], chunk + m - 1)
                pos = np.asarray(s.positions(pdev[:end]), np.int64)
                if pos.size:
                    out_s.append(pos + start)
                    out_l.append(np.full(pos.shape, m, np.int64))
        if not out_s:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        starts = np.concatenate(out_s)
        lens = np.concatenate(out_l)
        order = np.lexsort((lens, starts))
        return starts[order], lens[order]


def make_mixed(patterns, engine: str = "fast", **opts) -> MixedScanner:
    """Scanner over a MixedPatternSet (core.patterns): `engine` names the
    sub-scanner family ('fast' or any ENGINE_NAMES entry), built once per
    distinct pattern length."""
    from smatcher.core.patterns import MixedPatternSet
    if not isinstance(patterns, MixedPatternSet):
        raise TypeError("make_mixed expects a MixedPatternSet "
                        "(PatternSet sets are uniform — use make_engine)")
    make = (make_fast if engine == "fast"
            else lambda g, **kw: make_engine(engine, g, **kw))
    return MixedScanner(patterns, [make(g, **opts) for g in patterns.groups])
