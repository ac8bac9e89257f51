"""Distributed scans: shard_map + halo exchange + psum reduction.

The reference's distribution is exactly four MPI collectives (SURVEY.md §2.2):
Scatterv of the text with an (m-1)-byte halo per rank (main.c:467-489),
Bcast of the patterns (main.c:492), and two Reduces (count + timings,
main.c:654-661).  Here:

  - the text lives sharded on a 1-D mesh ('data' axis);
  - each device pulls its (m-1)-byte halo from its right neighbor with a
    single cyclic `lax.ppermute` over the device interconnect (the last shard's halo is replaced
    by the out-of-alphabet pad, since it has no right neighbor);
  - tables are replicated (closed over in the shard_map body);
  - every device scans its shard + halo with any engine core and the global
    count is one `lax.psum`.

Exactness: device i owns window starts [i*per, (i+1)*per); a window starting
in shard i ends within shard i + its halo, and every start belongs to exactly
one shard — the same partition argument as the reference's rank decomposition.

Byte alphabet (sigma = 256): no out-of-alphabet uint8 pad exists, so the
last shard's halo keeps the cyclic ppermute result (shard 0's head) and the
divisibility pad is 0 — both in-alphabet, so the device psum OVERCOUNTS by
exactly the matches among the invalid global starts [n-m+1, k*per).  Those
windows read precisely the bytes of the tiny string
W' = padded[n-m+1 : k*per] ++ padded[0 : m-1] (length pad + 2(m-1) <
mesh size + 2m), so one single-device run of the same core over W' computes
the overcount exactly and count() subtracts it — no pad symbol needed, no
approximation (`_wrap_overcount`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from smatcher.parallel.mesh import DATA_AXIS, make_mesh, shard_text


class _DistFuture:
    """In-flight distributed scan: the psum-ed [count, overflow] pair stays
    on device until result().  On overflow, result() transparently re-runs
    the exact distributed retry ladder when one is attached (counts are
    TOTAL, like single-chip — the reference's MPI path cannot fail on
    match density: MPI_Reduce sums unconditionally, main.c:656); without a
    ladder (cores with no overflow fallback) it raises.  A wrap-mode
    correction callable (sigma = 256) runs at fetch time either way."""

    __slots__ = ("_co", "_corr", "_retry")

    def __init__(self, co_dev, corr, retry=None):
        self._co = co_dev
        self._corr = corr
        self._retry = retry

    def result_with_overflow(self) -> tuple[int, bool]:
        """The RAW (count, overflow) of the single-dispatch scan — no
        retry; an overflowed count is a truncation lower bound.  The
        wrap-mode correction still applies (it is exact independently)."""
        import numpy as np
        if self._co is None:                 # degenerate: n < m
            return 0, False
        co = np.asarray(self._co)
        c = int(co[0])
        if self._corr is not None:
            c -= self._corr()
        return c, bool(co[1])

    def result(self) -> int:
        import numpy as np
        if self._co is None:                 # degenerate: n < m
            return 0
        co = np.asarray(self._co)
        if co[1]:
            if self._retry is None:
                raise OverflowError(
                    "candidate cap exceeded on some shard; raise "
                    "cap=/row_slots=")
            c = self._retry()
        else:
            c = int(co[0])
        if self._corr is not None:
            c -= self._corr()
        return c


class DistributedCounter:
    """Wrap a single-device traceable count core into a mesh-distributed one.

    core_fn(local_text_with_halo) -> int32 count over starts
    [0, len - m + 1) of its argument, or (count, overflow) — the overflow
    flag (candidate-cap truncation in the sparse-verify paths) rides the
    psum; on overflow count() re-runs the exact retry ladder (fast=) so
    distributed counts are TOTAL, mirroring the reference's
    unconditional MPI_Reduce (main.c:656).  Must be shard_map-traceable.
    """

    def __init__(self, core_fn, mesh, *, m: int, sigma: int,
                 axis: str = DATA_AXIS, fast=None):
        """fast: optional FastScanner over the same pattern set — enables
        the exact distributed OVERFLOW LADDER (counts become TOTAL like
        single-chip: dense per-shard re-dispatch, then budget-sized piece
        scanning; every engine counts the same windows, so the fast tables
        are a valid fallback for any core).  Without it, a shard overflow
        raises (portable jnp cores have no overflow and never need it)."""
        self.mesh = mesh
        self._core_fn = core_fn
        self._jcore = None            # lazy: wrap-correction jit (sigma=256)
        self.m = m
        self.sigma = sigma
        self.axis = axis
        self.fast = fast
        self._dense_fn = None         # lazy: ladder step 1 (fast core)
        self._piece_fns = {}          # (per, owned) -> ladder step 2 fn
        k = mesh.shape[axis]
        halo = m - 1

        def local_count(local):                        # (per,) on each device
            ext = exchange_halo(local, axis=axis, k=k, halo=halo, sigma=sigma)
            res = core_fn(ext)
            c, o = res if isinstance(res, tuple) else (res, jnp.int32(0))
            return jax.lax.psum(jnp.stack([jnp.int32(c), jnp.int32(o)]), axis)

        # check_vma=False: engine cores initialize lax.scan carries with
        # fresh (unvarying) zeros, which is sound here — every device runs
        # the identical program on its own shard.
        self._fn = jax.jit(shard_map(
            local_count, mesh=mesh,
            in_specs=P(axis), out_specs=P(), check_vma=False))

    def count(self, text, *, n: int | None = None) -> int:
        """text: numpy array (host) or already-sharded device array.

        `n`: true corpus length of a pre-sharded PADDED array (e.g. from
        multihost.load_corpus_shards) — only consulted in wrap mode
        (sigma = 256), where the 0-pad is in-alphabet and the wrap
        correction must know where the corpus ends; defaults to the full
        array length.  sigma <= 255 pre-sharded arrays are sigma-padded,
        which self-masks."""
        return self.count_async(text, n=n).result()

    def count_async(self, text, *, n: int | None = None):
        """Dispatch a mesh-wide scan and return immediately; the psum-ed
        [count, overflow] pair stays on device until result().  Queue many
        scans to amortize the host round-trip, like FastScanner.count_async.
        (In wrap mode the sigma=256 overcount correction runs at result()
        time — it is itself a host sync.)"""
        import numpy as np
        if isinstance(text, np.ndarray):
            sharded, n_text = shard_text(text, self.mesh, sigma=self.sigma,
                                         axis=self.axis)
            # an explicit n= wins: the numpy array may itself carry host-side
            # padding (e.g. a pre-padded byte-alphabet corpus)
            n = n_text if n is None else int(n)
        else:
            sharded = text
            n = int(sharded.shape[0]) if n is None else int(n)
        from smatcher.ops.common import check_count32
        check_count32(int(sharded.shape[0]))
        per = sharded.shape[0] // self.mesh.shape[self.axis]
        if per < self.m - 1:
            raise ValueError(
                f"shard size {per} < m-1 = {self.m - 1}: the one-hop halo "
                "exchange cannot cover a window; use fewer devices or a "
                "longer text")
        if self.sigma >= 256:
            if n < self.m:
                return _DistFuture(None, None)
            if not sharded.is_fully_addressable:
                raise ValueError(
                    "sigma=256 wrap correction needs a fully-addressable "
                    "array (single-process mesh): the corpus edge bytes are "
                    "fetched to the host.  Multi-process byte-alphabet runs "
                    "must exchange the edges out of band.")
        co_dev = self._fn(sharded)
        corr = (functools.partial(self._wrap_overcount, sharded, n)
                if self.sigma >= 256 else None)
        retry = (functools.partial(self._retry_total, sharded)
                 if self.fast is not None else None)
        return _DistFuture(co_dev, corr, retry)

    def scan_many(self, texts) -> list[int]:
        """Pipelined batch counts over the mesh: all scans dispatch before
        any result is fetched (mirrors FastScanner.scan_many)."""
        return [f.result() for f in [self.count_async(t) for t in texts]]

    def count_with_overflow(self, text, *, n: int | None = None
                            ) -> tuple[int, bool]:
        """The RAW single-dispatch (count, overflow flag) — no retry
        ladder.  An overflowed count is a truncation lower bound; callers
        wanting totality use count()."""
        return self.count_async(text, n=n).result_with_overflow()

    def _retry_total(self, sharded) -> int:
        """Exact distributed count after a shard overflow — the
        distributed lift of FastScanner's retry ladder (ops/fast.py): the
        single-chip path made counts TOTAL long ago, and the reference's
        MPI path cannot fail at any match density (MPI_Reduce sums
        unconditionally, main.c:656), so a match-dense corpus must count
        exactly on 8 chips just as it does on one.

        Step 1: re-dispatch with the fast scanner's own core under the
        same halo exchange (a core with no cap, or a scan whose overflow
        came from an engine core, finishes here).  Step 2 (dense matches):
        scan the shards in budget-sized pieces SPMD, splitting any piece
        that still overflows — pieces of <= cap/4 starts cannot (same
        termination argument as FastScanner._count_chunked)."""
        import numpy as np
        fast, axis = self.fast, self.axis
        k = self.mesh.shape[axis]
        halo = self.m - 1
        sigma = self.sigma
        if self._dense_fn is None:
            dense = fast.core

            def local_dense(local):
                ext = exchange_halo(local, axis=axis, k=k, halo=halo,
                                    sigma=sigma)
                c, o = dense(ext)
                return jax.lax.psum(jnp.stack([jnp.int32(c), jnp.int32(o)]),
                                    axis)

            self._dense_fn = jax.jit(shard_map(
                local_dense, mesh=self.mesh,
                in_specs=P(axis), out_specs=P(), check_vma=False))
        co = np.asarray(self._dense_fn(sharded))
        if not co[1]:
            return int(co[0])
        return self._count_pieces(sharded)

    def _piece_fn(self, per: int, owned: int):
        """shard_map fn counting piece starts [off, off+owned) of every
        device's shard with the fast scanner's core; per-device (count, overflow)
        returned along the mesh axis (summed on the host — a second
        collective would make slow shards trip the rendezvous timeout,
        see DistributedPositions)."""
        if (per, owned) in self._piece_fns:
            return self._piece_fns[(per, owned)]
        fast, axis = self.fast, self.axis
        k = self.mesh.shape[axis]
        halo = self.m - 1
        sigma = self.sigma

        dense = fast.core

        def local_piece(local, off):
            ext = exchange_halo(local, axis=axis, k=k, halo=halo,
                                sigma=sigma)
            piece = jax.lax.dynamic_slice(ext, (off,), (owned + halo,))
            c, o = dense(piece)
            return (jnp.reshape(jnp.int32(c), (1,)),
                    jnp.reshape(jnp.int32(o), (1,)))

        fn = jax.jit(shard_map(
            local_piece, mesh=self.mesh, in_specs=(P(axis), P()),
            out_specs=(P(axis), P(axis)), check_vma=False))
        self._piece_fns[(per, owned)] = fn
        return fn

    def _count_pieces(self, sharded, *, depth: int = 4) -> int:
        """Ladder step 2: every device scans its shard in (owned + halo)
        pieces SPMD (all devices at the same offsets), overflowing pieces
        split until they fit (<= cap/4 starts cannot overflow)."""
        import numpy as np
        per = sharded.shape[0] // self.mesh.shape[self.axis]
        min_chunk = max(self.fast.cap // 4, 1)
        work = [(0, per)]
        inflight, total = [], 0
        while work or inflight:
            while work and len(inflight) < depth:
                off, owned = work.pop()
                fn = self._piece_fn(per, owned)
                c_d, o_d = fn(sharded, jnp.int32(off))
                inflight.append((off, owned, c_d, o_d))
            off, owned, c_d, o_d = inflight.pop(0)
            if int(np.asarray(o_d).sum()):
                if owned <= min_chunk:
                    raise AssertionError(
                        "distributed count piece overflowed below the "
                        "guaranteed size — this is a bug")
                split = max(min_chunk, owned // 2)
                for s in range(off, off + owned, split):
                    work.append((s, min(split, off + owned - s)))
            else:
                total += int(np.asarray(c_d).sum())
        return total

    def _wrap_overcount(self, sharded, n: int) -> int:
        """Exact matches among the invalid global starts [n-m+1, N) in wrap
        mode (sigma = 256): their windows read the bytes of
        W' = padded[n-m+1 : N] ++ padded[0 : m-1] — tail starts on the last
        device wrap into shard 0's head via the cyclic ppermute, earlier
        invalid starts read the in-place 0-pad; both appear verbatim in W'.
        W' has exactly N - (n-m+1) window starts, so one single-device run
        of the same core over W' is the overcount, computed exactly.

        Assumes a fully-addressable sharded array (single-process mesh):
        the two tiny edge slices are fetched to the host.  Multi-process
        byte-alphabet runs would need the edge bytes exchanged out of band
        (each process can read its own file edges — multihost layout)."""
        import numpy as np
        N = int(sharded.shape[0])
        m = self.m
        lo = n - m + 1                                 # first invalid start
        if lo >= N:
            return 0                                   # m == 1, no pad
        head = (np.asarray(sharded[:m - 1]) if m > 1
                else np.empty((0,), np.uint8))
        wrap = np.concatenate([np.asarray(sharded[lo:N]), head])
        if self._jcore is None:
            self._jcore = jax.jit(self._core_fn)
        res = self._jcore(jnp.asarray(wrap, jnp.uint8))
        co = res if isinstance(res, tuple) else (res, jnp.int32(0))
        c, o = int(np.asarray(co[0])), int(np.asarray(co[1]))
        if o:
            if self.fast is not None:     # total, via the single-chip ladder
                return self.fast._count_retry(jnp.asarray(wrap, jnp.uint8))
            raise OverflowError(
                "candidate cap exceeded in the wrap-correction scan")
        return c


def exchange_halo(local, *, axis: str, k: int, halo: int, sigma: int):
    """Append the right neighbor's first `halo` bytes to this shard (one
    cyclic ppermute); the last shard gets the out-of-alphabet pad.

    For sigma = 256 no such pad exists: the last shard keeps the cyclic
    result (shard 0's head) and the caller subtracts the wrap overcount
    exactly (DistributedCounter._wrap_overcount)."""
    if halo <= 0:
        return local
    edge = jax.lax.slice(local, (0,), (halo,))
    perm = [((i + 1) % k, i) for i in range(k)]
    recv = jax.lax.ppermute(edge, axis, perm)
    if sigma < 256:
        idx = jax.lax.axis_index(axis)
        recv = jnp.where(idx == k - 1,
                         jnp.full((halo,), sigma, local.dtype), recv)
    return jnp.concatenate([local, recv])


class DistributedPositions:
    """Mesh-distributed match-position reporting over the shared fast path —
    UNBOUNDED, like FastScanner.positions.

    Each device scans its shard in pieces (all devices scan the same piece
    offsets — SPMD) with the fast scanner's own piece scan
    (FastScanner.piece_matches: filter, compaction and exact verification),
    converting local starts to global positions (device i owns starts
    [i*per, (i+1)*per)); per-device (cap,) position arrays concatenate
    along the mesh axis and stream to the host.  Any piece whose matches
    exceed the per-device cap is split and rescanned (pieces of <= cap/2
    starts cannot overflow), so dense corpora enumerate fully.  Overflow
    flags return per-device and are summed on the host, not psum-ed — an
    extra all-reduce would make straggling shards trip XLA's
    collective-rendezvous timeout.
    """

    def __init__(self, fast, mesh, *, axis: str = DATA_AXIS):
        self.fast = fast
        self.mesh = mesh
        self.m = fast.m
        self.sigma = fast.sigma
        self.axis = axis
        self.k = mesh.shape[axis]
        self._fns = {}                  # (per, owned) -> jitted piece fn

    def _piece_fn(self, per: int, owned: int):
        """shard_map fn: positions of piece starts [off, off+owned) of each
        device's shard (off dynamic, owned static)."""
        if (per, owned) in self._fns:
            return self._fns[(per, owned)]
        fast = self.fast
        axis, k, halo = self.axis, self.k, self.m - 1

        def local_piece(local, off):
            ext = exchange_halo(local, axis=axis, k=k, halo=halo,
                                sigma=self.sigma)
            piece = jax.lax.dynamic_slice(ext, (off,), (owned + halo,))
            idxs, _, o = fast.piece_matches(piece)
            base = jax.lax.axis_index(axis) * local.shape[0] + off
            pos = jnp.where(idxs >= 0, idxs + base, -1)
            return pos, jnp.reshape(jnp.int32(o), (1,))

        fn = jax.jit(shard_map(
            local_piece, mesh=self.mesh, in_specs=(P(self.axis), P()),
            out_specs=(P(self.axis), P(self.axis)), check_vma=False))
        self._fns[(per, owned)] = fn
        return fn

    def positions(self, text, *, chunk: int | None = None,
                  depth: int = 4, n: int | None = None):
        import numpy as np
        if isinstance(text, np.ndarray):
            sharded, n_text = shard_text(text, self.mesh, sigma=self.sigma,
                                         axis=self.axis)
            n = n_text if n is None else int(n)   # explicit n= wins
        else:
            sharded = text
            n = int(sharded.shape[0]) if n is None else int(n)
        from smatcher.ops.common import check_count32
        check_count32(int(sharded.shape[0]))   # positions ride int32
        per = sharded.shape[0] // self.k
        min_chunk = max(self.fast.cap // 2, 1)
        work = []                        # (off, owned) in shard coordinates
        if chunk is None:
            work.append((0, per))
        else:
            chunk = max(int(chunk), min_chunk)
            work.extend((s, min(chunk, per - s))
                        for s in range(0, per, chunk))
        work.reverse()
        inflight, out = [], []
        while work or inflight:
            while work and len(inflight) < depth:
                off, owned = work.pop()
                fn = self._piece_fn(per, owned)
                pos_d, o_d = fn(sharded, jnp.int32(off))
                inflight.append((off, owned, pos_d, o_d))
            off, owned, pos_d, o_d = inflight.pop(0)
            if int(np.asarray(o_d).sum()):
                if owned <= min_chunk:
                    raise AssertionError(
                        "distributed positions piece overflowed below the "
                        "guaranteed size — this is a bug")
                split = max(min_chunk, owned // 2)
                for s in range(off, off + owned, split):
                    work.append((s, min(split, off + owned - s)))
                continue
            pos = np.asarray(pos_d)
            pos = pos[pos >= 0]
            if self.sigma >= 256:
                # wrap mode: every pad/wrap-contaminated start is an invalid
                # global start >= n - m + 1 — drop them here (the count path
                # subtracts their count via _wrap_overcount instead)
                pos = pos[pos < n - self.m + 1]
            if pos.size:
                out.append(pos.astype(np.int64))
        if not out:
            return np.empty((0,), np.int64)
        return np.sort(np.concatenate(out))
