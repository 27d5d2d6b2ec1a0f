from dynam3d_torch.parallel.mesh import (
    Mesh,
    data_sharding,
    make_mesh,
    phi3_param_specs,
    policy_param_specs,
    replicated_specs,
    shard_tree,
    split_qkv_params,
    unshard_tree,
)

__all__ = [
    "Mesh",
    "data_sharding",
    "make_mesh",
    "phi3_param_specs",
    "policy_param_specs",
    "replicated_specs",
    "shard_tree",
    "split_qkv_params",
    "unshard_tree",
]
