from tpu_asr_torch.parallel.mesh import (batch_sharding, initialize_distributed,
                                         make_mesh, replicated, shard_batch)
from tpu_asr_torch.parallel.sharding import gather_params, shard_params

__all__ = ["make_mesh", "batch_sharding", "replicated", "shard_batch",
           "initialize_distributed", "shard_params", "gather_params"]
