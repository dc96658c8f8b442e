"""Distribution layer: the data plane under the simulated control plane,
the process-group start-up, and the placement rules its reshard uses."""
from repro_torch.dist.dataplane import (
    ReshardReport,
    SimDataPlane,
    TorchDataPlane,
    default_dataplane,
    init_from_env,
    make_dataplane,
)
from repro_torch.dist.sharding import param_specs, sanitize_spec

__all__ = ["ReshardReport", "SimDataPlane", "TorchDataPlane", "default_dataplane",
           "init_from_env", "make_dataplane", "param_specs", "sanitize_spec"]
