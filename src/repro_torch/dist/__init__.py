"""Distribution layer: the data plane under the simulated control plane
(sharding rules come with the multi-card slice)."""
from repro_torch.dist.dataplane import (
    SimDataPlane,
    TorchDataPlane,
    default_dataplane,
    make_dataplane,
)

__all__ = ["SimDataPlane", "TorchDataPlane", "default_dataplane", "make_dataplane"]
