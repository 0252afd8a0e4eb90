from repro_torch.sharding.ctx import (ShardCtx, get_ctx, maybe_gather_params,
                                      mesh_axis_size, shard, spec, use_ctx)
from repro_torch.sharding.specs import Stacked

__all__ = ["ShardCtx", "Stacked", "get_ctx", "maybe_gather_params", "mesh_axis_size",
           "shard", "spec", "use_ctx"]
