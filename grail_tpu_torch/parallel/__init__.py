"""dp x sp sharding and the sharded serving tick over torch.distributed
(sharded.py). Not imported by the package itself: torch.distributed is slow
to load."""

from .sharded import (make_mesh, sharded_pipeline, sharded_stream_tick_fn,
                      synthesize_block_sp)

__all__ = ["make_mesh", "sharded_pipeline", "sharded_stream_tick_fn",
           "synthesize_block_sp"]
