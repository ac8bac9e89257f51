"""True two-process jax.distributed validation (CPU, gloo collectives).

Spawns 2 worker processes, each owning 2 virtual CPU devices; they
initialize against a local coordinator, memmap-read disjoint corpus
ranges, and run DistributedCounter (halo ppermute + psum) ACROSS the
process boundary — the reference's mpirun -np 2 layout (main.c:327-333).
Skips cleanly when the environment lacks CPU cross-process collectives.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen

M = 9
SEED = 77


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_count(tmp_path):
    ab = Alphabet.dna()
    text = np.asarray(datagen.generate_text(40_000, ab, seed=SEED))
    corpus = tmp_path / "corpus.bin"
    text.tofile(corpus)
    pats = datagen.generate_patterns(text, 50, M, ab, frac_present=0.6,
                                     seed=SEED)
    truth = datagen.count_matches(text, pats)

    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(port), str(corpus), str(M),
         str(SEED)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("two-process workers timed out")
        outs.append((p.returncode, out, err))

    for rc, out, err in outs:
        if "SKIP" in out:
            pytest.skip(f"cross-process CPU collectives unavailable: "
                        f"{out.strip()}")
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
    counted = [line for rc, out, _ in outs for line in out.splitlines()
               if line.startswith("COUNT ")]
    assert counted, f"no COUNT line: {outs}"
    assert int(counted[0].split()[1]) == truth
