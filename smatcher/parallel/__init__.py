from smatcher.parallel.mesh import make_mesh, shard_text
from smatcher.parallel.dist import DistributedCounter, DistributedPositions
from smatcher.parallel.multihost import (
    init_distributed, load_corpus_shards, host_shard_ranges)

__all__ = ["make_mesh", "shard_text", "DistributedCounter",
           "DistributedPositions",
           "init_distributed", "load_corpus_shards", "host_shard_ranges"]
