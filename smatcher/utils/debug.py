"""In-kernel debug printing — the cuPrintf analogue.

The reference vendors NVIDIA's cuPrintf ring-buffer printf for in-kernel
debugging (cuda/cuPrintf.cu, hooks commented out at cuda/cuda_ac.cu:1036-1043;
SURVEY.md §2.4 C17).  In JAX the capability is built into the stack:
``jax.debug.print`` inside traced code and ``pl.debug_print`` inside Pallas
kernels.  ``dprint`` is a single entry point that dispatches on context so
engine code can sprinkle one call form everywhere.
"""

from __future__ import annotations


def dprint(fmt: str, *args) -> None:
    """Print from traced JAX code or from inside a Pallas kernel.

    Uses pl.debug_print when called under a Pallas trace (detected via the
    dynamic grid env), jax.debug.print otherwise.  No-op cost outside
    debugging: calls are simply removed from production kernels rather than
    gated by a runtime flag (they serialize the kernel).
    """
    import jax
    try:
        from jax.experimental import pallas as pl
        from jax._src.pallas import core as pl_core
        # set for the duration of kernel tracing (jax 0.9: grid_env_stack is
        # only populated around index-map evaluation, so test grid_context)
        in_pallas = pl_core._pallas_tracing_env.grid_context is not None
    except Exception:
        pl = None
        in_pallas = False
    if in_pallas and pl is not None:
        pl.debug_print(fmt, *args)
    else:
        jax.debug.print(fmt, *args)
