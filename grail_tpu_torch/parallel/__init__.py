"""dp x sp sharding over torch.distributed (sharded.py). Not imported by the
package itself: torch.distributed is slow to load."""

from .sharded import make_mesh, sharded_pipeline, synthesize_block_sp

__all__ = ["make_mesh", "sharded_pipeline", "synthesize_block_sp"]
