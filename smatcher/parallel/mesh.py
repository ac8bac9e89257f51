"""Device mesh setup and text sharding.

Replaces the reference's MPI machinery (MPI_Init/Comm_size, main.c:327-333;
Scatterv with per-rank (m-1)-halo displacements, main.c:463-489) with a 1-D
`jax.sharding.Mesh` over the devices: the text is sharded on the 'data' axis,
preprocessing tables are replicated, halos ride the device interconnect via `lax.ppermute`
(parallel/dist.py), and count reduction is a `lax.psum`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_text(text: np.ndarray, mesh: Mesh, *, sigma: int,
               axis: str = DATA_AXIS):
    """Place text sharded along the mesh axis, right-padded to divisibility.

    For sigma <= 255 the pad is the out-of-alphabet symbol sigma (pad
    windows can never match).  For the full byte alphabet (sigma = 256) no
    out-of-alphabet uint8 value exists: the pad is 0 and the distributed
    layer subtracts the exactly-computable overcount of the pad/wrap
    region instead (parallel/dist.py wrap correction).

    Returns (sharded array, original length)."""
    k = mesh.shape[axis]
    n = len(text)
    per = -(-max(n, 1) // k)
    padded = np.full(per * k, sigma if sigma < 256 else 0, dtype=np.uint8)
    padded[:n] = text
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(padded, sharding), n


def replicated(arr, mesh: Mesh):
    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P()))
