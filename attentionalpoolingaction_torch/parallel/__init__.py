"""The mesh over processes and the multi-process runtime, over
``torch.distributed`` (the JAX package's ``parallel/``)."""

from attentionalpoolingaction_torch.parallel import multihost
from attentionalpoolingaction_torch.parallel.mesh import (
    make_mesh,
    model_axis_of,
    shard_batch,
    shard_batches,
    state_shardings,
)

__all__ = ["make_mesh", "model_axis_of", "multihost", "shard_batch",
           "shard_batches", "state_shardings"]
