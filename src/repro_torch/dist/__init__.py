"""Distribution layer: the data plane under the simulated control plane,
the process-group start-up, the placement rules its reshard uses, and the
activation constraints and mesh context of the dry-run."""
from repro_torch.dist.dataplane import (
    ReshardReport,
    SimDataPlane,
    TorchDataPlane,
    default_dataplane,
    init_from_env,
    make_dataplane,
)
from repro_torch.dist.sharding import (
    batch_specs,
    cache_specs,
    gather_fsdp,
    param_specs,
    sanitize_spec,
    shard_activations,
    shard_heads,
)

__all__ = ["ReshardReport", "SimDataPlane", "TorchDataPlane", "batch_specs", "cache_specs",
           "default_dataplane", "gather_fsdp", "init_from_env", "make_dataplane",
           "param_specs", "sanitize_spec", "shard_activations", "shard_heads"]
