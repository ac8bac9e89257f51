"""Profiling & tracing: the reference's three timing mechanisms, in JAX.

Reference surface (SURVEY.md §5):
  (a) MPI_Wtime bracketing of read/scatter/scan/reduce phases
      (main.c:338-671)                          -> PhaseTimer
  (b) CUDA event timers around each kernel, averaged across ranks
      (cuda/cuda_wm.cu:269-302, main.c:659-670) -> time_jit (device-synced
      wall clock via block_until_ready around one jitted call)
  (c) nvprof counter runs (profile.sh)          -> trace (jax.profiler traces
      viewable in TensorBoard/Perfetto: per-kernel device time on the GPU)

Plus structured metrics: emit_jsonl appends one JSON object per line —
replacing the reference's printf-to-stdout observability (main.c:663-671).
"""

from __future__ import annotations

import contextlib
import json
import time


class PhaseTimer:
    """Named wall-clock phases; start/stop or context-manager style.

    >>> pt = PhaseTimer()
    >>> with pt.phase("read"): ...
    >>> pt.report()  # {"read_s": 0.12, ...}
    Re-entering a phase accumulates (like the reference's summed kernel
    times across reps).
    """

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self, ndigits: int = 4) -> dict:
        return {f"{k}_s": round(v, ndigits) for k, v in self.seconds.items()}


def time_jit(fn, *args, reps: int = 5, warmup: int = 1, bytes_scanned: int | None = None):
    """Device-synchronized timing of a jitted callable — the counterpart of
    the reference's cudaEventRecord/ElapsedTime bracket: host clock around
    jax.block_until_ready.  Returns a dict with best/mean seconds and,
    when bytes_scanned is given, bytes_per_s.
    """
    import jax

    for _ in range(max(warmup, 0)):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    best = min(times)
    out = {"best_s": best, "mean_s": sum(times) / len(times), "reps": len(times)}
    if bytes_scanned is not None:
        out["bytes_per_s"] = bytes_scanned / best
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (open in TensorBoard / Perfetto).

    The replacement for profile.sh's nvprof counter sweeps: the trace
    timeline exposes per-kernel device time and fusion boundaries.
    """
    import jax
    with jax.profiler.trace(logdir):
        yield


def emit_jsonl(path: str, record: dict) -> None:
    """Append one structured metrics record (creates the file if missing)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
