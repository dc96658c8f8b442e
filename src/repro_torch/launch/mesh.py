"""Production mesh definitions.

Axis conventions (shared with ``repro_torch.dist.sharding``):

  single-pod : ("data", "model")          = (16, 16)   -> 256 cards
  multi-pod  : ("pod", "data", "model")   = (2, 16, 16) -> 512 cards

``model`` carries tensor parallelism; ``data`` (joined by ``pod`` in
multi-pod mode) carries batch data-parallelism and FSDP param sharding.

Everything here is a function, never a module-level constant: importing
this module touches no process group. A mesh is built over the group that
is already initialised; the dry-run starts torch's ``fake`` backend of 256
or 512 ranks first.
"""
from __future__ import annotations

import math

from repro_torch.dist.compat import make_mesh


def production_shape(*, multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape, axes = production_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device=device)


def make_named_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device: str = "cuda"):
    """Arbitrary mesh (tests / small dry-runs)."""
    return make_mesh(shape, axes, device=device)


def mesh_chips(mesh) -> int:
    return math.prod(tuple(mesh.shape))


def describe(mesh) -> str:
    dims = "x".join(str(s) for s in tuple(mesh.shape))
    return f"{dims} ({','.join(mesh.mesh_dim_names)}) = {mesh_chips(mesh)} chips"
