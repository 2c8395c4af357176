from diffusion_model_tpu_torch.parallel.mesh import (
    Layout,
    Mesh,
    dp_batch_sharding,
    init_single,
    launch,
    make_hybrid_mesh,
    make_mesh,
    node_sharding,
    replicate,
    shard_graph_batch,
)

__all__ = [
    "Layout",
    "Mesh",
    "dp_batch_sharding",
    "init_single",
    "launch",
    "make_hybrid_mesh",
    "make_mesh",
    "node_sharding",
    "replicate",
    "shard_graph_batch",
]
