"""Multi-host corpus loading: per-host file offsets, no full-text gather.

The reference loads the ENTIRE corpus on rank 0 and MPI_Scatterv's shards to
every rank (main.c:386,451-489) — an O(n) memory + network hotspot on the
root that cannot scale.  Here every host reads only the byte ranges its own
devices own (np.memmap windows into the corpus file), places one block per
local device, and assembles the logical sharded array with
`jax.make_array_from_single_device_arrays`.  The (m-1)-byte halo is NOT read
from disk — DistributedCounter exchanges it over the interconnect with
`lax.ppermute`
(parallel/dist.py), which is the point: disk IO stays disjoint and the
overlap rides the interconnect.

Single-process meshes (tests, one host with several GPUs) work identically: all devices are
local, so all blocks are read by this process.

Typical multi-host entry:

    init_distributed("host0:1234", 2, rank)  # jax.distributed.initialize()
    mesh = make_mesh()                    # 1-D over all global devices
    text, n = load_corpus_shards("corpus.bin", mesh, sigma=4)
    dc = DistributedCounter(engine.core, mesh, m=m, sigma=4)
    total = dc.count(text)                # psum over the mesh
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from smatcher.parallel.mesh import DATA_AXIS


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """jax.distributed.initialize wrapper (no-op if already initialized).

    Pass the coordinator (`host:port`), the process count and this
    process's id; with no arguments JAX must detect a cluster environment,
    and fails where none is set.  The reference's MPI_Init equivalent
    (main.c:327)."""
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:               # already initialized
        # jax raises "distributed.initialize should only be called once."
        msg = str(e).lower()
        if "once" not in msg and "already" not in msg:
            raise


def load_corpus_shards(path: str, mesh: Mesh, *, sigma: int,
                       axis: str = DATA_AXIS, n: int | None = None):
    """Assemble the corpus as a mesh-sharded array, each host reading only
    its own devices' byte ranges from `path`.

    The file must hold pre-encoded codes (bytes < sigma).  Shards are
    right-padded with the out-of-alphabet symbol `sigma` (pad windows can
    never match); for the byte alphabet (sigma = 256) the pad is 0 and the
    returned corpus length must be passed to DistributedCounter.count(n=...)
    so its wrap correction knows where the corpus ends.
    Returns (global sharded array, corpus length)."""
    file_n = os.path.getsize(path)
    if n is None:
        n = file_n
    if n > file_n:
        raise ValueError(f"requested n={n} > file size {file_n}")
    devs = list(mesh.devices.reshape(-1))
    k = len(devs)
    per = -(-max(n, 1) // k)
    sharding = NamedSharding(mesh, P(axis))
    mm = np.memmap(path, dtype=np.uint8, mode="r")

    local = []
    for i, d in enumerate(devs):
        if d.process_index != jax.process_index():
            continue
        start = i * per
        stop = min(n, (i + 1) * per)
        block = np.full(per, sigma if sigma < 256 else 0, dtype=np.uint8)
        if stop > start:
            block[:stop - start] = mm[start:stop]
        local.append(jax.device_put(block, d))
    global_shape = (per * k,)
    arr = jax.make_array_from_single_device_arrays(global_shape, sharding, local)
    return arr, n


def host_shard_ranges(n: int, mesh: Mesh) -> dict:
    """Byte ranges each process reads — for provisioning/debugging."""
    devs = list(mesh.devices.reshape(-1))
    per = -(-max(n, 1) // len(devs))
    out = {}
    for i, d in enumerate(devs):
        out.setdefault(d.process_index, []).append(
            (i * per, min(n, (i + 1) * per)))
    return out
