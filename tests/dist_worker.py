"""Worker for the two-process jax.distributed test (test_multiprocess.py).

Each process owns 2 virtual CPU devices (4 global), initializes the
coordinator, memmap-reads ONLY its own devices' byte ranges of the corpus
(multihost.load_corpus_shards), and runs the full DistributedCounter
pipeline — halo ppermute + psum — across the process boundary.  Process 0
prints "COUNT <n>" for the parent to check.

The reference's analogue is mpirun -np 2 with MPI_Scatterv/Reduce
(main.c:327-333,488-492,654-657) — except no rank ever loads the full text.
"""
import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]
corpus = sys.argv[3]
m = int(sys.argv[4])
seed = int(sys.argv[5])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception as e:                      # collectives impl not selectable
    print(f"SKIP no gloo: {e}", flush=True)
    sys.exit(0)

try:
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=2, process_id=pid)
except Exception as e:
    print(f"SKIP distributed init failed: {e}", flush=True)
    sys.exit(0)

import numpy as np

from smatcher.core.alphabet import Alphabet
from smatcher.core import datagen
from smatcher.engines import make_fast
from smatcher.parallel import make_mesh
from smatcher.parallel.dist import DistributedCounter
from smatcher.parallel.multihost import load_corpus_shards

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()

ab = Alphabet.dna()
# identical patterns rebuilt per process — the reference's per-rank preproc
# (main.c:534), minus the truncated-Bcast bug
full = np.fromfile(corpus, dtype=np.uint8)
pats = datagen.generate_patterns(full, 50, m, ab, frac_present=0.6,
                                 seed=seed)

mesh = make_mesh()                           # 1-D over all 4 global devices
text, n = load_corpus_shards(corpus, mesh, sigma=ab.size)
eng = make_fast(pats, backend="xla", tile=1 << 12)
dc = DistributedCounter(eng.core, mesh, m=m, sigma=ab.size)
count = dc.count(text)
if pid == 0:
    print(f"COUNT {count}", flush=True)
jax.distributed.shutdown()
