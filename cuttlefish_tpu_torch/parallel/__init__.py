"""Device mesh: the block batch split over devices (counterpart of
``cuttlefish_tpu/parallel``).

The reference's only concurrency is a thread pool over block-encode jobs
(`lib/src/Converter.cpp:508-593`).  As in the JAX package, the port's
counterpart is pure data parallelism: blocks are independent, so the
batch is cut into contiguous shards, one per entry of a mesh, each
encoded on its entry's device with no collective on the hot path, and the
words come back in raster order.  A mesh is an ordered list of torch
devices; an entry may repeat, so one card (or the CPU, in the tests) can
hold several shards.  Under ``init_distributed`` each process encodes its
own rank's shard and the shards are all-gathered.
"""

from cuttlefish_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    default_mesh,
    gather_words,
    get_mesh,
    init_distributed,
    set_mesh,
    shard_blocks,
    use_mesh,
)
