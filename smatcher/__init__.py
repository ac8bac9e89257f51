"""smatcher: multi-pattern string matching on an accelerator (NVIDIA GPU).

A from-scratch JAX/XLA/Pallas framework with the capabilities of the CUDA+MPI
reference `iassael/cuda-aho-corasick-wu-manber` (arXiv:1407.2889): exact
multi-pattern matching of `p_size` fixed-length-`m` patterns over large
corpora, via five engines — Aho-Corasick, Set Horspool, SBOM factor oracle,
Wu-Manber, and SOG bit-parallel shift-or — each re-designed as a dense,
branchless, data-parallel device scan instead of the reference's branchy
skip loops (see SURVEY.md §7 for the count-preservation argument).

Layers (bottom-up):
  core/      alphabets, pattern sets, corpora, planted-hit generation
  oracles/   exact reference-semantics numpy implementations (conformance)
  automata/  flat table builders (AC DFA, SH trie, SBOM oracle, WM, SOG)
  ops/       device scans (jnp, one Pallas kernel on the Triton route)
  parallel/  mesh setup, halo-sharded distributed scans, psum reduction
  cli.py     smatcher-style command line driver
"""

__version__ = "0.1.0"

from smatcher.core.alphabet import Alphabet
from smatcher.core.patterns import PatternSet, MixedPatternSet


def scan(text, patterns, *, engine: str = "fast", reps: int = 1, **opts) -> dict:
    """One-call scan: build the engine, count, return structured metrics.

    The library-level form of the reference's printf report (main.c:663-671;
    SURVEY.md §5 observability): {engine, matches, bytes, preproc_s, scan_s,
    bytes_per_s}.  `patterns` is a PatternSet; `engine` one of
    engines.ENGINE_NAMES or "fast"; extra opts go to the engine constructor.
    """
    import time

    import numpy as np

    from smatcher.engines import make_engine, make_fast

    t0 = time.perf_counter()
    eng = make_fast(patterns, **opts) if engine == "fast" else \
        make_engine(engine, patterns, **opts)
    t_build = time.perf_counter() - t0
    count = eng.count(text)                  # first call: includes compile
    times = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        count = eng.count(text)
        times.append(time.perf_counter() - t0)
    t_scan = min(times)
    n = int(np.asarray(text).shape[0])
    return {"engine": engine, "matches": int(count), "bytes": n,
            "preproc_s": round(t_build, 4), "scan_s": round(t_scan, 4),
            "bytes_per_s": round(n / t_scan, 1)}


__all__ = ["Alphabet", "PatternSet", "MixedPatternSet", "scan",
           "__version__"]
