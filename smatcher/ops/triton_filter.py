"""Fingerprint-tier filter + candidate compaction: one Pallas kernel on the
Triton route.

The XLA fingerprint scan (ops/fast.py:fast_count_core) materializes the
three base fingerprints, a candidate mask and a cumsum over every position
before it scatters the few survivors.  This kernel does the whole filter in
registers instead: each block of BLOCK window starts

  1. computes fp0/fp1/fp2 (the 16-bit polynomial fingerprints of
     ops/keys.py) with integer multiply-adds over the window bytes — no
     `pl.dot`, so no reduced-precision matrix unit can enter;
  2. tests the k derived stages (STAGE_CD: key_s = fp0 + C_s*fp1 + D_s*fp2
     mod stage_bits) by gathers into the stage bitmaps, each gather masked
     to the lanes still alive;
  3. appends its surviving starts to one candidate list: an in-block
     exclusive cumsum ranks them and ONE scalar atomic_add on a counter
     reserves their slots.

Candidate order is arbitrary (blocks race for the counter); every caller
either sums the verified matches or sorts the positions.  The counter ends
at the TRUE candidate total, so `n_cand > cap` is the overflow flag and the
retry ladder of FastScanner is unchanged.  Verification stays in XLA
(fast.verify_chunked).

Both outputs are aliased from freshly initialized inputs (counter 0, slots
-1): an output that is not aliased starts uninitialized.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

#: window starts per program (a power of two, as Triton requires)
BLOCK = 1024
NUM_WARPS = 4
#: patterns up to this length unroll the fingerprint loop at trace time
UNROLL_M = 64


def _fingerprints(text_ref, pos, *, n, m, mults):
    """16-bit fingerprints sum(c[pos+i] * mult^i) mod 2^16 for each mult.
    Reads are clamped to the text: windows past n_starts are masked by the
    caller, so their values do not matter."""
    zero = jnp.zeros(pos.shape, jnp.int32)

    def step(j, fps, powers):
        c = text_ref[jnp.minimum(pos + j, n - 1)].astype(jnp.int32)
        return tuple(f + c * r for f, r in zip(fps, powers))

    if m <= UNROLL_M:
        fps = (zero,) * len(mults)
        for j in range(m):
            fps = step(j, fps, [pow(u, j, 1 << 16) for u in mults])
    else:
        def body(j, carry):
            fps, powers = carry
            return (step(j, fps, powers),
                    tuple((r * u) & 0xFFFF for r, u in zip(powers, mults)))
        fps, _ = jax.lax.fori_loop(
            0, m, body, ((zero,) * len(mults),
                         tuple(jnp.int32(1) for _ in mults)))
    return [f & 0xFFFF for f in fps]


def _filter_kernel(text_ref, bitmaps_ref, count_in, slots_in, count_ref,
                   slots_ref, *, n, n_starts, m, cd, stage_words, mults,
                   cap):
    del count_in, slots_in                      # aliased to the outputs
    pos = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    fps = _fingerprints(text_ref, pos, n=n, m=m, mults=mults)
    smask = stage_words * 32 - 1
    cand = pos < n_starts
    for s, (c, d) in enumerate(cd):
        key = fps[0]
        if c:
            key = key + c * fps[1]
        if d:
            key = key + d * fps[2]
        key = key & smask
        word = plt.load(bitmaps_ref.at[s * stage_words + (key >> 5)],
                        mask=cand, other=0)
        cand = cand & (((word >> (key & 31)) & 1) == 1)
    hits = cand.astype(jnp.int32)
    total = jnp.sum(hits)

    @pl.when(total > 0)
    def _():
        first = plt.atomic_add(count_ref, 0, total)
        slot = first + jnp.cumsum(hits) - hits
        plt.store(slots_ref.at[slot], pos, mask=cand & (slot < cap))


def fp_candidates(text, bitmaps, *, m: int, cd: tuple, cap: int,
                  interpret: bool = False):
    """Traceable: (idxs (cap,) int32 candidate starts of `text`, in no
    particular order, -1 padded; n_cand, the TRUE candidate total, which
    exceeds cap exactly when candidates were dropped).

    bitmaps: the first len(cd) stage bitmaps of a FastTables (int32
    words); cd: their (C, D) derivation constants."""
    from smatcher.ops.fast import FP_MULTS
    n = int(text.shape[0])
    n_starts = n - m + 1
    if n_starts <= 0:
        return jnp.full((cap,), -1, jnp.int32), jnp.int32(0)
    stage_words = int(bitmaps[0].size)
    table = jnp.concatenate([b.reshape(-1) for b in bitmaps[:len(cd)]])
    n_fp = 3 if any(d for _, d in cd) else 2 if any(c for c, _ in cd) else 1
    kernel = functools.partial(
        _filter_kernel, n=n, n_starts=n_starts, m=m, cd=tuple(cd),
        stage_words=stage_words, mults=FP_MULTS[:n_fp], cap=cap)
    count, slots = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n_starts, BLOCK),),
        out_shape=(jax.ShapeDtypeStruct((1,), jnp.int32),
                   jax.ShapeDtypeStruct((cap,), jnp.int32)),
        input_output_aliases={2: 0, 3: 1},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="fp_filter_compact",
    )(text, table, jnp.zeros((1,), jnp.int32),
      jnp.full((cap,), -1, jnp.int32))
    return slots, count[0]
