"""smatcher-style command line driver.

The counterpart of the reference's `./smatcher <alg> -m -p_size -n
-alphabet [-c]` (main.c:20-30, 324-718): explicit corpus/pattern paths or
synthetic generation (no hard-coded n -> file table), engine selection that
actually takes effect (the reference ignores argv[1] in its live path,
main.c:534), per-phase wall timings mirroring the reference's
read/scatter/CPU/gather report (main.c:663-671), and a structured JSON
result line.

Examples:
  python -m smatcher.cli --synthetic --n 1000000 --m 8 --p-size 1000 \
      --alphabet 4 --algo fast
  python -m smatcher.cli --text corpus.bin --patterns pats.npz --algo wm
  python -m smatcher.cli --synthetic --n 100000 --m 8 --p-size 100 \
      --alphabet 4 --algo ac --devices 4 --verify
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from smatcher.ops.ac import AC_LANES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smatcher",
        description="multi-pattern string matching on an accelerator "
                    "(AC / SH / SBOM / WM / SOG / shared fast path)")
    p.add_argument("--algo", default="fast",
                   choices=["ac", "sh", "sbom", "wm", "sog8", "sog16",
                            "sog32", "fast", "all"],
                   help="engine; 'fast' = shared fast path, "
                        "'all' = run every engine and cross-check counts")
    p.add_argument("--m", type=int, required=True, help="pattern length")
    p.add_argument("--p-size", type=int, default=0, help="number of patterns")
    p.add_argument("--alphabet", type=int, default=4,
                   help="alphabet size (2/4/8/20/128/256)")
    src = p.add_argument_group("corpus")
    src.add_argument("--text", help="pre-encoded corpus file (bytes < sigma)")
    src.add_argument("--fasta", help="FASTA corpus file (encoded via alphabet)")
    src.add_argument("--synthetic", action="store_true",
                     help="generate a uniform random corpus")
    src.add_argument("--n", type=int, default=0,
                     help="corpus length (required with --synthetic)")
    src.add_argument("--seed", type=int, default=0)
    pat = p.add_argument_group("patterns")
    pat.add_argument("--patterns", help="pattern file: .npz (PatternSet.save), "
                                        ".fa/.fasta (one record per pattern), "
                                        "or raw fixed-width records")
    pat.add_argument("--frac-present", type=float, default=0.5,
                     help="synthetic patterns: fraction sampled from the text")
    pat.add_argument("--save-patterns", metavar="OUT.npz",
                     help="write the (possibly generated) pattern set to disk "
                          "— the reference's -c dataset-creation workflow "
                          "(main.c:48-50)")
    src.add_argument("--save-corpus", metavar="OUT.bin",
                     help="write the (possibly generated) encoded corpus")
    run = p.add_argument_group("execution")
    run.add_argument("--backend", default=None, choices=["triton", "xla"],
                     help="fast-path backend (default: ops.fast."
                          "default_backend — triton on a GPU, xla elsewhere)")
    run.add_argument("--devices", type=int, default=1,
                     help="run distributed over a 1-D mesh of this many devices")
    run.add_argument("--lanes", type=int, default=AC_LANES,
                     help="AC scan lanes")
    run.add_argument("--q", type=int, default=1,
                     help="AC jnp path: chars consumed per composed-table step")
    run.add_argument("--tile", type=int, default=1 << 20,
                     help="filter-engine tile (window starts per tile)")
    run.add_argument("--reps", type=int, default=1, help="timed repetitions")
    run.add_argument("--stream", action="store_true",
                     help="stream the --text corpus from disk (count_file / "
                          "positions_file) instead of loading it — for "
                          "corpora larger than host memory; requires "
                          "--patterns and a single device")
    run.add_argument("--chunk", type=int, default=1 << 28,
                     help="streamed piece size in bytes (--stream)")
    run.add_argument("--verify", action="store_true",
                     help="cross-check against the host ground truth "
                          "(loads the corpus windows on host; small corpora)")
    run.add_argument("--json", action="store_true",
                     help="print only the JSON result line")
    ckpt = p.add_argument_group("tables checkpoint")
    ckpt.add_argument("--save-tables", metavar="PATH",
                      help="serialize the engine's preprocessing tables to "
                           ".npz after building (core.checkpoint)")
    ckpt.add_argument("--tables", metavar="PATH",
                      help="load prebuilt tables instead of preprocessing "
                           "(single-engine runs)")
    run.add_argument("--positions", metavar="OUT.npy",
                     help="also write match start positions to a .npy "
                          "file")
    run.add_argument("--per-pattern", metavar="OUT.npy",
                     help="also write per-pattern match-start counts "
                          "((p,) int64, sums to the total; single device, "
                          "in-memory corpus) to a .npy file")
    prof = p.add_argument_group("profiling")
    prof.add_argument("--profile", metavar="LOGDIR",
                      help="record a jax.profiler trace of the timed scans "
                           "(view in TensorBoard/Perfetto)")
    return p


def load_inputs(args):
    from smatcher.core.alphabet import Alphabet
    from smatcher.core.patterns import PatternSet
    from smatcher.core import corpus, datagen

    ab = Alphabet.of_size(args.alphabet)
    t0 = time.time()
    if args.stream:
        # corpus stays on disk: scanned piecewise by count_file /
        # positions_file (the reference must fit its shard in GPU memory,
        # main.c:386 — here the corpus can exceed HOST memory)
        if not args.text:
            sys.exit("--stream requires --text (a pre-encoded corpus file)")
        if not args.patterns:
            sys.exit("--stream requires --patterns (patterns cannot be "
                     "sampled from an unloaded corpus)")
        if args.devices > 1:
            sys.exit("--stream is single-device; shard big corpora with "
                     "parallel.multihost.load_corpus_shards instead")
        text = None
    elif args.synthetic:
        if not args.n:
            sys.exit("--synthetic requires --n")
        text = datagen.generate_text(args.n, ab, seed=args.seed)
    elif args.text:
        text = corpus.load_raw(args.text, Alphabet(args.alphabet)).codes
    elif args.fasta:
        text = corpus.load_fasta(args.fasta, ab).codes
    else:
        sys.exit("one of --synthetic/--text/--fasta is required")

    if args.patterns:
        if args.patterns.endswith(".npz"):
            pats = PatternSet.load(args.patterns)
        elif args.patterns.endswith((".fa", ".fasta")):
            # detect mixed lengths structurally (one record read), not by
            # matching PatternSet's error text — a rewording there must not
            # silently disable mixed-length support
            from smatcher.core.patterns import MixedPatternSet, _fasta_records
            records = _fasta_records(args.patterns)
            if len({len(r) for r in records}) == 1:
                pats = PatternSet.from_strings(records, ab)
            else:
                # mixed-length records: one sub-scanner per length
                pats = MixedPatternSet.from_strings(records, ab)
                print(f"mixed-length pattern set: lengths {pats.lengths} "
                      f"({pats.p_size} patterns)", file=sys.stderr)
        else:
            raw = np.fromfile(args.patterns, dtype=np.uint8)
            if raw.size % args.m:
                sys.exit(f"pattern file size {raw.size} not a multiple of m={args.m}")
            pats = PatternSet(raw.reshape(-1, args.m), ab)
    else:
        if not args.p_size:
            sys.exit("--p-size (or --patterns) is required")
        pats = datagen.generate_patterns(text, args.p_size, args.m, ab,
                                         frac_present=args.frac_present,
                                         seed=args.seed + 1)
    if args.save_patterns:
        if not hasattr(pats, "save"):
            sys.exit("--save-patterns supports uniform-length sets only "
                     "(mixed sets load directly from FASTA)")
        written = pats.save(args.save_patterns)
        if written != args.save_patterns:
            print(f"patterns written to {written}", file=sys.stderr)
    if args.save_corpus and text is not None:
        np.asarray(text, np.uint8).tofile(args.save_corpus)
    return text, pats, time.time() - t0


def _from_tables(name, tables, pats, args):
    """A scanner from prebuilt tables; named engines also get their pattern
    codes and backend for the device scanner (ops/common.py)."""
    from smatcher.engines import make_engine_from_tables
    if name == "fast":
        return make_engine_from_tables(name, tables, tile=1 << 24,
                                       backend=args.backend)
    scanner = make_engine_from_tables(
        name, tables, lanes=args.lanes, q=args.q if name == "ac" else 1,
        tile=args.tile)
    scanner.pattern_codes = np.asarray(pats.codes, np.uint8)
    scanner.fast_opts = {"backend": args.backend}
    return scanner


def run_engine(name, text, pats, args):
    import jax
    import jax.numpy as jnp
    from smatcher.engines import (
        make_engine, make_engine_from_tables, make_fast, make_distributed)
    from smatcher.parallel import make_mesh
    from smatcher.parallel.dist import DistributedCounter

    from smatcher.core.patterns import MixedPatternSet
    mixed = isinstance(pats, MixedPatternSet)
    t0 = time.time()
    if mixed:
        if args.devices > 1:
            raise SystemExit("mixed-length pattern sets run single-device")
        if args.tables or args.save_tables:
            raise SystemExit("--tables/--save-tables need a uniform-length "
                             "set (checkpoints hold one engine's tables)")
        from smatcher.engines import make_mixed
        opts = ({"backend": args.backend} if name == "fast"
                else {"lanes": args.lanes, "tile": args.tile,
                      "backend": args.backend})
        scanner = make_mixed(pats, engine=name, **opts)
    elif args.devices > 1:
        if args.tables or args.save_tables:
            raise SystemExit(
                "--tables/--save-tables are single-device options; they were "
                "previously ignored silently with --devices > 1 — run the "
                "checkpoint step with --devices 1")
        mesh = make_mesh(args.devices)
        if name == "fast":
            eng = make_fast(pats, backend=args.backend)
            scanner = DistributedCounter(eng.core, mesh, m=pats.m,
                                         sigma=pats.sigma, fast=eng)
        else:
            scanner = make_distributed(name, pats, mesh, lanes=args.lanes,
                                       tile=args.tile, backend=args.backend)
    elif args.tables:
        if args.algo == "all":
            raise SystemExit(
                "--tables holds ONE engine's checkpoint; --algo all would "
                "feed it to every engine — pass the matching --algo")
        from smatcher.core.checkpoint import load_tables
        scanner = _from_tables(name, load_tables(args.tables), pats, args)
    elif args.save_tables:
        # build once, save, construct from the same tables (no rebuild)
        from smatcher.core.checkpoint import save_tables
        from smatcher.engines import build_tables
        tables = build_tables(name, pats)
        path = args.save_tables
        if args.algo == "all":           # one file per engine, not overwrite
            base = path[:-4] if path.endswith(".npz") else path
            path = f"{base}.{name}.npz"
        save_tables(path, tables)
        scanner = _from_tables(name, tables, pats, args)
    elif name == "fast":
        scanner = make_fast(pats, backend=args.backend)
    else:
        scanner = make_engine(name, pats, lanes=args.lanes, tile=args.tile,
                              q=args.q if name == "ac" else 1,
                              backend=args.backend)
    t_build = time.time() - t0

    if text is None:                     # --stream: corpus stays on disk
        import os
        size = os.path.getsize(args.text)
        t0 = time.time()
        count = scanner.count_file(args.text, chunk=args.chunk)
        t_first = time.time() - t0
        t_scan = t_first
        if args.reps > 1:
            times = []
            for _ in range(args.reps):
                t0 = time.time()
                count = scanner.count_file(args.text, chunk=args.chunk)
                times.append(time.time() - t0)
            t_scan = min(times)
        if args.positions:
            pos = scanner.positions_file(args.text, chunk=args.chunk)
            if isinstance(pos, tuple):       # mixed: (starts, lengths)
                pos = np.stack(pos, axis=1)
            np.save(args.positions, pos)
            if not args.json:
                print(f"[{name:5s}] {len(pos)} match positions -> "
                      f"{args.positions}")
        return {
            "engine": name,
            "matches": int(count),
            "time_preproc_s": round(t_build, 4),
            "time_first_scan_s": round(t_first, 4),
            "time_scan_s": round(t_scan, 4),
            "bytes_per_s": round(size / t_scan, 1),
            "device_bytes_per_s": round(size / t_scan, 1),
        }

    count_kw = {}
    if args.devices == 1:
        tdev = jax.device_put(jnp.asarray(text))
    else:
        # shard once before timing (re-sharding per rep would time the
        # host->device transfer, not the scan); the true length rides along
        # so the sigma=256 wrap correction knows where the corpus ends
        from smatcher.parallel.mesh import shard_text
        tdev, n_true = shard_text(text, scanner.mesh, sigma=pats.sigma)
        count_kw = {"n": n_true}
    t0 = time.time()
    count = scanner.count(tdev, **count_kw)
    t_first = time.time() - t0           # includes compile
    t_scan = t_scan_dev = t_first
    if args.reps > 1:
        import contextlib
        from smatcher.utils import trace
        ctx = trace(args.profile) if args.profile else contextlib.nullcontext()
        with ctx:
            times = []
            for _ in range(args.reps):
                t0 = time.time()
                count = scanner.count(tdev, **count_kw)
                times.append(time.time() - t0)
        t_scan = min(times)
        t_scan_dev = t_scan
        # device (steady-state) rate: queue reps scans, fetch once — the
        # per-call rate above includes one host round-trip per scan
        if hasattr(scanner, "count_async"):
            q = max(args.reps, 5)
            t0 = time.time()
            fs = [scanner.count_async(tdev, **count_kw) for _ in range(q)]
            fs[-1].result()
            t_many = time.time() - t0
            t0 = time.time()
            scanner.count_async(tdev, **count_kw).result()
            t_one = time.time() - t0
            d = (t_many - t_one) / (q - 1)
            if d > 1e-5:
                t_scan_dev = d
    if args.positions:
        if args.devices > 1:
            # every engine counts the same windows: distributed positions
            # run on the counter's fast scanner (its overflow ladder)
            from smatcher.parallel.dist import DistributedPositions
            pos = DistributedPositions(scanner.fast, scanner.mesh).positions(
                tdev, **count_kw)
        else:
            pos = scanner.positions(tdev)
        if isinstance(pos, tuple):           # mixed: (starts, lengths)
            pos = np.stack(pos, axis=1)
        np.save(args.positions, pos)
        if not args.json:
            print(f"[{name:5s}] {len(pos)} match positions -> {args.positions}")
    if args.per_pattern:
        per = scanner.count_per_pattern(tdev)
        np.save(args.per_pattern, per)
        if not args.json:
            print(f"[{name:5s}] per-pattern counts (sum {per.sum()}) -> "
                  f"{args.per_pattern}")

    return {
        "engine": name,
        "matches": int(count),
        "time_preproc_s": round(t_build, 4),
        "time_first_scan_s": round(t_first, 4),
        "time_scan_s": round(t_scan, 4),
        "bytes_per_s": round(len(text) / t_scan, 1),
        "device_bytes_per_s": round(len(text) / t_scan_dev, 1),
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.per_pattern and (args.stream or args.devices > 1):
        sys.exit("--per-pattern needs an in-memory corpus on one device "
                 "(drop --stream / --devices)")
    from smatcher.utils.cache import enable_compile_cache
    enable_compile_cache()
    text, pats, t_read = load_inputs(args)

    from smatcher.core.patterns import MixedPatternSet
    mixed = isinstance(pats, MixedPatternSet)
    if args.algo == "all":
        names = ["ac", "sh", "sbom", "wm", "fast"]
        if mixed:
            # SOG widths are per-length (m == 8/16/32); a mixed set would
            # build one sogN sub-scanner per length group and crash on any
            # group with m != N — skip it so 'all' degrades gracefully
            print("skipping sog engines: SOG requires one shared pattern "
                  "length in {8, 16, 32}, pattern set mixes lengths "
                  f"{pats.lengths}", file=sys.stderr)
        elif args.m in (8, 16, 32):
            names.append(f"sog{args.m}")
    else:
        if mixed and args.algo.startswith("sog"):
            sys.exit(f"--algo {args.algo} needs every pattern to have "
                     f"length {args.algo[3:]}; this set mixes lengths "
                     f"{pats.lengths} — use fast/ac/sh/sbom/wm (one "
                     "sub-scanner per length)")
        names = [args.algo]

    results = []
    for name in names:
        r = run_engine(name, text, pats, args)
        r["time_read_s"] = round(t_read, 4)
        results.append(r)
        if not args.json:
            print(f"[{r['engine']:5s}] matches={r['matches']}  "
                  f"preproc {r['time_preproc_s']*1e3:.1f}ms  "
                  f"scan {r['time_scan_s']*1e3:.1f}ms  "
                  f"({r['bytes_per_s']/1e9:.3f} GB/s)", flush=True)

    exit_code = 0
    if args.algo == "all":
        counts = {r["matches"] for r in results}
        agree = len(counts) == 1
        if not args.json:
            print("cross-check:", "ALL ENGINES AGREE" if agree
                  else f"MISMATCH {sorted(counts)}")
        if not agree:
            exit_code = 2

    if args.verify:
        from smatcher.core import datagen
        from smatcher.core.patterns import MixedPatternSet
        if text is None:                 # --stream: memmap for ground truth
            text = np.memmap(args.text, dtype=np.uint8, mode="r")
        if isinstance(pats, MixedPatternSet):
            truth = sum(datagen.count_matches(text, g, prefer_native=True)
                        for g in pats.groups)
        else:
            truth = datagen.count_matches(text, pats, prefer_native=True)
        ok = all(r["matches"] == truth for r in results)
        for r in results:
            r["ground_truth"] = int(truth)
        if not args.json:
            print(f"ground truth: {truth} -> {'OK' if ok else 'FAILED'}")
        if not ok and not exit_code:
            exit_code = 3

    # always emit the JSON result line — on disagreement it carries the
    # per-engine counts a consumer needs to diagnose; exit code still signals
    print(json.dumps(results if len(results) > 1 else results[0]))
    if exit_code:
        sys.exit(exit_code)


if __name__ == "__main__":
    main()
