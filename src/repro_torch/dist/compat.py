"""Mesh constructors and the current-mesh context.

The JAX package's ``dist/compat.py`` papers over jax releases; here the
three names map onto ``torch.distributed``:

- :func:`make_mesh` is ``init_device_mesh`` over the process group that is
  already initialised (a real one, or torch's ``fake`` backend for the
  dry-run). It starts no group itself.
- :func:`abstract_mesh` carries a mesh's ``shape`` and ``mesh_dim_names``
  and nothing else: no devices, no process group. The placement rules of
  ``dist/sharding.py`` read only those two attributes.
- :func:`use_mesh` makes a mesh the current one, the one
  ``dist.sharding.current_mesh`` returns and the activation helpers
  constrain to; the JAX package's ``set_mesh`` / ``with mesh:``.

``shard_map`` has no counterpart: the port's in-program collectives
(``core/agreement.py``, ``core/collectives.py``) take the mesh's process
groups (``mesh.get_group``) directly.
"""
from __future__ import annotations

import contextvars
from contextlib import contextmanager
from dataclasses import dataclass

_CURRENT = contextvars.ContextVar("repro_torch_current_mesh", default=None)


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's ``shape`` and ``mesh_dim_names``, with no devices."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and names {self.mesh_dim_names} differ in rank")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group (its world size must be the product of ``shape``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def abstract_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> AbstractMesh:
    """A mesh of ``shape`` named ``axes`` carrying no devices."""
    return AbstractMesh(tuple(shape), tuple(axes))


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh for the block."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)
