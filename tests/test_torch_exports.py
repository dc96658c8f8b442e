"""Each subpackage of the port exports what the JAX package's exports.

For every subpackage, the port's ``__all__`` must hold the reference's
``__all__`` minus the names still queued in ROADMAP.md, which are listed
here by name. A queued name that the port comes to export must leave the
list, so the list stays the port's true gap.
"""
import importlib

import pytest

pytest.importorskip("torch")

SUBPACKAGES = ("checkpoint", "configs", "core", "data", "dist", "kernels", "models",
               "mpi", "optim", "serve")

# reference names the port does not export yet, by subpackage
QUEUED = {
    # the mesh manager and the in-program liveness psum (multi-card)
    "core": {"CompileCache", "DevicePool", "MeshManager", "liveness_psum"},
    # placement (dist/sharding.py) and the MoE/enc-dec sharding helpers
    "dist": {"param_specs", "cache_specs", "batch_specs", "sanitize_spec",
             "shard_activations", "shard_heads", "gather_fsdp"},
    "optim": {"make_compressor"},
    # their counterparts are CUDA entry points with names of their own
    "kernels": {"flash_attention_pallas", "ssd_scan_pallas", "quantize_int8_pallas"},
}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_the_reference_names(sub):
    ref = importlib.import_module(f"repro.{sub}")
    port = importlib.import_module(f"repro_torch.{sub}")
    ref_all = set(ref.__all__)
    port_all = set(getattr(port, "__all__", ()))
    queued = QUEUED.get(sub, set())
    assert queued <= ref_all, f"{sub}: queued names the reference lacks: {queued - ref_all}"
    missing = ref_all - queued - port_all
    assert not missing, f"repro_torch.{sub} lacks {sorted(missing)}"
    exported_now = queued & port_all
    assert not exported_now, f"repro_torch.{sub} now exports {sorted(exported_now)}: unqueue"
    absent = sorted(n for n in port_all if not hasattr(port, n))
    assert not absent, f"repro_torch.{sub}.__all__ names undefined {absent}"
