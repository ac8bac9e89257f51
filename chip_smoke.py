"""Check, in one command, that the scan path runs on an NVIDIA GPU at the
sizes users run, against the independent C reference with zero tolerance.

    python3 chip_smoke.py            # one card: every phase below
    python3 chip_smoke.py --mesh4    # four cards: the sharded path only

Phases (one process; without --mesh4 only jax.devices()[0] is used):

  exact     DNA sigma=4, n=2^28 (256 MiB), m=8, p=10,000 — the exact tier
  fp        the same corpus, m=32, p=10,000 and p=100,000 (wide stages)
  protein   swiss-prot shape: sigma=20, n=177,649,920, m=8, p=8,000
  engines   ac/sh/sbom/wm/sog8 at m=8 and ac/sh/sbom/wm/sog32 at m=32,
            p=10,000: each engine's own count, plus positions and matches
            through its device scanner
  edge      dense positions (1M matches), sigma=256, mixed lengths 5/8/16,
            long patterns, the adversarial fingerprint-collision set, a
            match-driven cap overflow
  mesh1     DistributedCounter and DistributedPositions on a 1-device mesh
  cli       `smatcher.cli --synthetic --n 268435456 --m 8 --p-size 10000
            --alphabet 4 --algo all --verify`, in this process
  gpu_tests the tests marked `gpu` (compiled kernels), in this process
  mesh4     (--mesh4 only) 1 GiB sigma=4 corpus over 4 cards, m=8 and
            m=32 at p=10,000, and a sigma=256 corpus through the cyclic-wrap
            correction, each vs the one-card count and the C reference

Each phase prints its wall time, compile time, compiled memory analysis and
the device's peak bytes in use.  Any mismatch or error ends the run with a
non-zero exit and no result line.  The last line is one JSON object naming
the device.  Counts and positions are integers: the tolerance is zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import smatcher  # noqa: F401  (fails outside a checkout of the repo)

ROOT = os.path.dirname(os.path.abspath(__file__))
N_DNA = 1 << 28
N_PROTEIN = 177_649_920


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, got, want) -> None:
    """Exact equality or the run ends here."""
    same = (np.array_equal(got, want) if isinstance(got, np.ndarray)
            else got == want)
    if not same:
        raise AssertionError(f"{name}: got {_short(got)}, want {_short(want)}")
    log(f"  ok {name}: {_short(got)}")


def _short(v):
    if isinstance(v, np.ndarray):
        return f"array(len={v.size}, sum={int(v.sum()) if v.size else 0})"
    return v


def gpu_lines() -> list[str]:
    """Card name and power limit, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=120, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def require_gpus(n: int) -> str | None:
    """Why this process cannot run (no GPU, too few), or None."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        return f"no GPU: JAX's first device is {devs[0].platform}"
    if len(devs) < n:
        return f"need {n} GPUs, JAX sees {len(devs)}"
    return None


class Phases:
    """Per-phase wall time, compile time and device memory."""

    def __init__(self, device):
        self.device = device

    def run(self, name, fn, *args):
        log(f"phase {name}")
        t0 = time.perf_counter()
        fn(*args)
        stats = self.device.memory_stats() or {}
        log(f"phase {name} done: wall {time.perf_counter() - t0:.3f}s, "
            f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def compiled_scan(scanner, tdev):
    """Compile the scanner's device count for tdev; log compile time and
    the compiled memory analysis."""
    import jax
    t0 = time.perf_counter()
    exe = jax.jit(scanner._device_count).lower(tdev).compile()
    ma = exe.memory_analysis()
    log(f"  compile {time.perf_counter() - t0:.3f}s backend={scanner.backend}"
        f" memory: argument {ma.argument_size_in_bytes} output "
        f"{ma.output_size_in_bytes} temp {ma.temp_size_in_bytes} bytes")
    return exe


def timed(name, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"  {name}: {time.perf_counter() - t0:.3f}s")
    return out


def matches_of(text, pats):
    from smatcher import native
    return timed("C reference matches", native.match_enum_native, text,
                 pats.codes)


def scanner_surfaces(tag, fast, text, tdev, pats, tmpdir, *,
                     want_pos, want_ids):
    """count (device and host corpus), count_async/scan_many, positions,
    matches and count_file of one FastScanner vs the C reference."""
    truth = len(want_pos)
    exe = compiled_scan(fast, tdev)
    c, o = exe(tdev)
    check(f"{tag} compiled scan (count, overflow)", (int(c), int(o)),
          (truth, 0))
    check(f"{tag} count, device corpus", timed("count", fast.count, tdev),
          truth)
    check(f"{tag} count, host corpus", timed("count host", fast.count, text),
          truth)
    half = tdev[: len(text) // 2]
    check(f"{tag} scan_many", timed("scan_many", fast.scan_many,
                                    [tdev, half, tdev]),
          [truth, int(np.count_nonzero(want_pos <= len(text) // 2
                                       - pats.m)), truth])
    check(f"{tag} count_async", fast.count_async(tdev).result(), truth)
    check(f"{tag} positions", timed("positions", fast.positions, tdev),
          want_pos)
    pos, ids = timed("matches", fast.matches, tdev)
    check(f"{tag} matches positions", pos, want_pos)
    check(f"{tag} matches ids", ids, want_ids)
    path = os.path.join(tmpdir, "corpus.bin")
    text.tofile(path)
    check(f"{tag} count_file", timed("count_file", fast.count_file, path,
                                     chunk=1 << 26), truth)
    os.unlink(path)


def phase_exact(ctx):
    from smatcher.core import datagen
    from smatcher.engines import make_fast
    text, tdev, ab = ctx["dna"]
    pats = datagen.generate_patterns(text, 10_000, 8, ab, seed=8)
    want_pos, want_ids = matches_of(text, pats)
    fast = make_fast(pats)
    assert fast.ft.exact
    scanner_surfaces("exact m=8 p=10k", fast, text, tdev, pats,
                     ctx["tmp"], want_pos=want_pos, want_ids=want_ids)
    check("exact count_per_pattern", fast.count_per_pattern(tdev),
          np.bincount(want_ids, minlength=10_000))
    ctx["pats8"] = pats
    ctx["want8"] = (want_pos, want_ids)


def phase_fp(ctx):
    from smatcher.core import datagen
    from smatcher.engines import make_fast
    text, tdev, ab = ctx["dna"]
    for p in (10_000, 100_000):
        pats = datagen.generate_patterns(text, p, 32, ab, seed=40)
        want_pos, want_ids = matches_of(text, pats)
        fast = timed("build", make_fast, pats)
        assert not fast.ft.exact
        log(f"  stage_bits {fast.ft.stage_bits}, stages built "
            f"{len(fast.ft.bitmaps)}, cap {fast.cap}")
        scanner_surfaces(f"fp m=32 p={p}", fast, text, tdev, pats,
                         ctx["tmp"], want_pos=want_pos, want_ids=want_ids)
        if p == 10_000:
            ctx["pats32"] = pats
            ctx["want32"] = (want_pos, want_ids)


def phase_protein(ctx):
    import jax
    from smatcher.core.alphabet import Alphabet
    from smatcher.core import datagen
    from smatcher.engines import make_fast
    ab = Alphabet.protein()
    text = timed("generate", datagen.generate_text, N_PROTEIN, ab, 11)
    tdev = jax.device_put(text, ctx["device"])
    pats = datagen.generate_patterns(text, 8_000, 8, ab, seed=12)
    want_pos, _ = matches_of(text, pats)
    fast = make_fast(pats)
    assert not fast.ft.exact                # 20^8 > 2^16: fp tier at m=8
    compiled_scan(fast, tdev)
    check("protein count", timed("count", fast.count, tdev), len(want_pos))
    check("protein positions", timed("positions", fast.positions, tdev),
          want_pos)


def phase_engines(ctx):
    from smatcher.engines import make_engine
    from smatcher.ops.common import engine_scanner
    text, tdev, _ = ctx["dna"]
    for m, pats, (want_pos, want_ids) in ((8, ctx["pats8"], ctx["want8"]),
                                          (32, ctx["pats32"],
                                           ctx["want32"])):
        for name in ("ac", "sh", "sbom", "wm", f"sog{m}"):
            eng = make_engine(name, pats)
            check(f"{name} m={m} count",
                  timed(f"{name} count", eng.count, tdev), len(want_pos))
            check(f"{name} m={m} device positions",
                  timed(f"{name} positions", eng.positions, tdev), want_pos)
            pos, ids = timed(f"{name} matches", eng.matches, tdev)
            check(f"{name} m={m} device matches positions", pos, want_pos)
            check(f"{name} m={m} device matches ids", ids, want_ids)
            assert engine_scanner(eng).backend == ctx["backend"]


def phase_edge(ctx):
    import jax
    from smatcher.core.alphabet import Alphabet
    from smatcher.core import datagen
    from smatcher.core.patterns import MixedPatternSet, PatternSet
    from smatcher.engines import make_fast, make_mixed
    dev = ctx["device"]

    # dense positions: every one of ~1M windows matches
    dna = Alphabet.dna()
    dense = np.zeros(1 << 20, np.uint8)
    dfast = make_fast(PatternSet(np.zeros((1, 8), np.uint8), dna), cap=4096)
    check("dense positions (1M matches)",
          timed("positions", dfast.positions, jax.device_put(dense, dev)),
          np.arange((1 << 20) - 7, dtype=np.int64))

    # byte alphabet, single device
    b256 = Alphabet.of_size(256)
    btext = datagen.generate_text((1 << 21) + 3, b256, seed=15)
    bpats = datagen.generate_patterns(btext, 100, 8, b256, seed=16)
    bpos, _ = matches_of(btext, bpats)
    bfast = make_fast(bpats)
    check("sigma=256 count", bfast.count(jax.device_put(btext, dev)),
          len(bpos))
    check("sigma=256 positions", bfast.positions(btext), bpos)

    # mixed lengths: one sub-scanner per length on one device-resident text
    mtext = datagen.generate_text(1 << 22, dna, seed=17)
    rng = np.random.default_rng(18)
    rows = [np.asarray(mtext[s:s + m]) for m in (5, 8, 16)
            for s in rng.integers(0, (1 << 22) - 16, 40)]
    mx = MixedPatternSet.from_rows(rows, dna)
    mtruth = sum(datagen.count_matches(mtext, g, True) for g in mx.groups)
    meng = make_mixed(mx)
    mdev = jax.device_put(mtext, dev)
    check("mixed 5/8/16 count", meng.count(mdev), mtruth)
    starts, _ = meng.positions(mdev)
    check("mixed 5/8/16 positions", int(starts.size), mtruth)

    # long patterns: the kernel's fingerprint loop past its unrolled length
    prot = Alphabet.protein()
    ltext = datagen.generate_text(1 << 22, prot, seed=13)
    ldev = jax.device_put(ltext, dev)
    for m, p in ((256, 50), (1024, 20)):
        lpats = datagen.generate_patterns(ltext, p, m, prot, seed=14 + m)
        check(f"long patterns m={m} count", make_fast(lpats).count(ldev),
              datagen.count_matches(ltext, lpats, True))

    # adversarial set: planted windows share all three base fingerprints
    # with a pattern (sum(d_j * mult^j) == 0 mod 2^16 for every mult), so
    # no filter stage can reject them; counts stay exact on every scan and
    # the adaptation stops retrying
    d = np.array([0, 1, 0, -3, 1, 2, -3, 2, 2, -3, 2, 1, -3, 0, 1, 0],
                 np.int64)
    arng = np.random.default_rng(23)
    lo, hi = np.maximum(0, -d), np.minimum(3, 3 - d)
    xs = np.stack([arng.integers(lo, hi + 1) for _ in range(300)]
                  ).astype(np.uint8)
    apats = PatternSet((xs + d[None, :]).astype(np.uint8), dna)
    atext = np.asarray(datagen.generate_text(1 << 21, dna, seed=24)).copy()
    for i, s in enumerate(range(0, (1 << 21) - 16, 96)):
        atext[s:s + 16] = xs[i % len(xs)]
    atruth = datagen.count_matches(atext, apats, True)
    afast = make_fast(apats)
    adev = jax.device_put(atext, dev)
    check("adversarial counts (8 scans)",
          [afast.count(adev) for _ in range(8)], [atruth] * 8)
    settled = afast._retries
    for _ in range(3):
        afast.count(adev)
    check("adversarial retries converged", afast._retries, settled)

    # match-driven overflow: true matches alone pass the cap, so the
    # scanner finishes in pieces and adds no filter stage
    s20 = Alphabet.of_size(20)
    dtext = datagen.generate_text(1 << 21, s20, seed=21)
    dpats = datagen.generate_patterns(dtext, 4000, 8, s20, frac_present=0.9,
                                      seed=22)
    dtruth = datagen.count_matches(dtext, dpats, True)
    assert dtruth > 1024
    mfast = make_fast(dpats, cap=1024)
    ddev = jax.device_put(dtext, dev)
    check("match-dense counts (x2)", (mfast.count(ddev), mfast.count(ddev)),
          (dtruth, dtruth))
    check("match-dense adds no stage", mfast._k_extra, 0)


def phase_mesh1(ctx):
    from smatcher.core.alphabet import Alphabet
    from smatcher.core import datagen
    from smatcher.engines import make_fast
    from smatcher.parallel import make_mesh
    from smatcher.parallel.dist import (DistributedCounter,
                                            DistributedPositions)
    mesh = make_mesh(1)
    text, _, _ = ctx["dna"]
    pats = ctx["pats32"]
    want_pos, _ = ctx["want32"]
    fast = make_fast(pats)
    dc = DistributedCounter(fast.core, mesh, m=pats.m, sigma=pats.sigma,
                            fast=fast)
    check("mesh(1) sigma=4 count", timed("count", dc.count, text),
          len(want_pos))
    check("mesh(1) sigma=4 positions",
          timed("positions", DistributedPositions(fast, mesh).positions,
                text), want_pos)
    b256 = Alphabet.of_size(256)
    btext = datagen.generate_text((1 << 24) + 3, b256, seed=15)
    bpats = datagen.generate_patterns(btext, 100, 8, b256, seed=16)
    bpos, _ = matches_of(btext, bpats)
    bfast = make_fast(bpats)
    bdc = DistributedCounter(bfast.core, mesh, m=8, sigma=256, fast=bfast)
    check("mesh(1) sigma=256 count", bdc.count(btext), len(bpos))
    check("mesh(1) sigma=256 positions",
          DistributedPositions(bfast, mesh).positions(btext), bpos)


def phase_cli(ctx):
    from smatcher import cli
    argv = ["--synthetic", "--n", str(N_DNA), "--m", "8", "--p-size",
            "10000", "--alphabet", "4", "--algo", "all", "--verify"]
    log(f"  smatcher.cli {' '.join(argv)}")
    try:
        cli.main(argv)
    except SystemExit as e:
        if e.code:
            raise AssertionError(f"cli exited {e.code}") from None


def phase_gpu_tests(ctx):
    """pytest -m gpu in this process: one process per card."""
    import pytest
    rc = pytest.main([os.path.join(ROOT, "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider"])
    if rc != 0:
        raise AssertionError(f"pytest -m gpu exited {int(rc)}")


def phase_mesh4(ctx):
    import jax
    from smatcher.core.alphabet import Alphabet
    from smatcher.core import datagen
    from smatcher.engines import make_fast
    from smatcher.parallel import make_mesh
    from smatcher.parallel.dist import (DistributedCounter,
                                            DistributedPositions)
    mesh = make_mesh(4)
    dna = Alphabet.dna()
    text = timed("generate 1 GiB", datagen.generate_text, 4 * N_DNA, dna, 7)
    one = jax.device_put(text, jax.devices()[0])
    for m in (8, 32):
        pats = datagen.generate_patterns(text, 10_000, m, dna, seed=8 + m)
        want_pos, _ = matches_of(text, pats)
        # a large cap keeps the m=8 enumeration (~150M matches) to a few
        # hundred pieces
        fast = make_fast(pats, cap=1 << 20)
        check(f"one-card count m={m}", timed("count", fast.count, one),
              len(want_pos))
        dc = DistributedCounter(fast.core, mesh, m=m, sigma=4, fast=fast)
        check(f"mesh(4) count m={m}", timed("count", dc.count, text),
              len(want_pos))
        check(f"mesh(4) positions m={m}",
              timed("positions", DistributedPositions(fast, mesh).positions,
                    text), want_pos)
    del one
    b256 = Alphabet.of_size(256)
    btext = datagen.generate_text(N_DNA + 3, b256, seed=15)
    bpats = datagen.generate_patterns(btext, 100, 8, b256, seed=16)
    bpos, _ = matches_of(btext, bpats)
    bfast = make_fast(bpats)
    check("one-card sigma=256 count",
          bfast.count(jax.device_put(btext, jax.devices()[0])), len(bpos))
    bdc = DistributedCounter(bfast.core, mesh, m=8, sigma=256, fast=bfast)
    check("mesh(4) sigma=256 wrap count", bdc.count(btext), len(bpos))
    check("mesh(4) sigma=256 positions",
          DistributedPositions(bfast, mesh).positions(btext), bpos)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)
    if not args.mesh4:
        # one card: the process must not reserve memory on the others
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    cards = gpu_lines()
    import jax
    from smatcher import native
    from smatcher.ops.fast import default_backend
    from smatcher.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    n_dev = 4 if args.mesh4 else 1
    missing = require_gpus(n_dev)
    if missing:
        log(missing)
        return 2
    if native.load() is None:
        log("the native C reference did not build (make, g++)")
        return 2
    log(f"compile cache: {enable_compile_cache()}")
    log(f"backend: {default_backend()}, devices: {jax.devices()[:n_dev]}")
    phases = Phases(dev)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        ctx = {"device": dev, "tmp": tmp, "backend": default_backend()}
        if args.mesh4:
            phases.run("mesh4", phase_mesh4, ctx)
        else:
            from smatcher.core.alphabet import Alphabet
            from smatcher.core import datagen
            ab = Alphabet.dna()
            text = timed("generate 256 MiB DNA", datagen.generate_text,
                         N_DNA, ab, 7)
            ctx["dna"] = (text, jax.device_put(text, dev), ab)
            for name, fn in (("exact", phase_exact), ("fp", phase_fp),
                             ("protein", phase_protein),
                             ("engines", phase_engines),
                             ("edge", phase_edge), ("mesh1", phase_mesh1),
                             ("cli", phase_cli),
                             ("gpu_tests", phase_gpu_tests)):
                phases.run(name, fn, ctx)
    for line in cards[:n_dev]:
        log(line)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()[:n_dev])}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
