"""The data-plane seam: what moves the payload bytes under the simulated control plane.

``HierarchicalCollectives`` (the §V schedule executor) decides who reduces
to whom, the stage list and the alpha-beta charge; it routes exactly four
payload operations through a data plane:

| hop class                | call                       | sim                         | torch                                   |
|--------------------------|----------------------------|-----------------------------|-----------------------------------------|
| reduce fold (any level)  | ``reduce(parts, op)``      | sequential numpy fold       | the same fold in torch ops on the device |
| bcast root payload       | ``bcast_payload(p)``       | identity                    | the payload as a device tensor          |
| result gather            | ``gather_arrays(vs)``      | identity                    | the payloads as device tensors          |
| cross-legion compression | ``compress(g, scheme, f)`` | numpy twins                 | absmax + quantize kernels / stable top-k |

plus ``asarray`` (a payload the plane can carry: a numpy array on sim, a
tensor on the plane's device on torch), ``register_state`` /
``reshard_registered`` (post-repair state redistribution) and ``name``.

Both planes fold *sequentially*, ``acc = op(acc, p)`` in the order the
schedule passes the parts. Elementwise IEEE f32 operations in the same order
give the same bits, so the torch plane's results equal the sim plane's byte
for byte on any f32 payload, not only on integer-exact ones; the
compression hop is bit-equal too (see ``optim.compression``). The torch
plane takes ``np.add`` / ``np.maximum`` / ``np.minimum`` and raises on any
other op: it never drops to the host for a call.

On one card the torch plane's bcast and gather keep the payload where it
is, and ``reshard_registered`` records the state and returns ``None``;
collectives across cards and resharding over a device mesh come with the
multi-card slice.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim import compression as C

_TORCH_OPS = {np.add: torch.add, np.maximum: torch.maximum, np.minimum: torch.minimum}


def _fold(parts: list, op: Callable) -> Any:
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc


class SimDataPlane:
    """The numpy simulator: payloads are host arrays, folds are numpy ops,
    compression runs the numpy twins."""

    name = "sim"

    def asarray(self, x) -> np.ndarray:
        return np.asarray(x)

    def reduce(self, parts: list, op: Callable) -> Any:
        return _fold(parts, op)

    def bcast_payload(self, payload):
        return payload

    def gather_arrays(self, values: list) -> list:
        return list(values)

    def compress(self, g: np.ndarray, scheme: str, fraction: float) -> np.ndarray:
        """Compress-then-decompress round trip: what the receiver sees."""
        if scheme == "int8":
            return C.decompress_int8_np(C.compress_int8_np(g))
        if scheme == "topk":
            return C.decompress_topk_np(C.compress_topk_np(g, fraction), g.shape)
        raise ValueError(f"unknown compression scheme {scheme!r}")

    def register_state(self, name: str, getter: Callable[[], Any],
                       setter: Callable[[Any], None] | None = None) -> None:
        """Placement is virtual in the simulator: nothing to redistribute."""

    def reshard_registered(self, view) -> None:
        return None


class TorchDataPlane:
    """Payloads are torch tensors on one device (``"cuda"`` by default);
    every fold, bcast, gather and compression stays on it."""

    name = "torch"

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.registered: dict[str, tuple[Callable, Callable | None]] = {}

    def asarray(self, x) -> torch.Tensor:
        """``x`` as a tensor on the plane's device. A host array (or scalar,
        or list) is copied there once; a tensor on another device raises."""
        if isinstance(x, torch.Tensor):
            if x.device.type != self.device.type:
                raise ValueError(f"payload on {x.device}, data plane on {self.device}")
            return x
        return torch.as_tensor(np.asarray(x), device=self.device)

    def reduce(self, parts: list, op: Callable) -> torch.Tensor:
        fn = _TORCH_OPS.get(op)
        if fn is None:
            raise ValueError(f"torch data plane: unsupported reduce op "
                             f"{getattr(op, '__name__', op)!r} (add, maximum, minimum)")
        return _fold([self.asarray(p) for p in parts], fn)

    def bcast_payload(self, payload) -> torch.Tensor:
        return self.asarray(payload)

    def gather_arrays(self, values: list) -> list:
        return [self.asarray(v) for v in values]

    def compress(self, g: torch.Tensor, scheme: str, fraction: float) -> torch.Tensor:
        """Compress-then-decompress round trip on the device: int8 through the
        absmax and quantize kernels (their plain versions on a CPU plane)."""
        g = self.asarray(g)
        if scheme == "int8":
            return C.decompress_int8(C.compress_int8(g))
        if scheme == "topk":
            return C.decompress_topk(C.compress_topk(g, fraction), g.shape)
        raise ValueError(f"unknown compression scheme {scheme!r}")

    def register_state(self, name: str, getter: Callable[[], Any],
                       setter: Callable[[Any], None] | None = None) -> None:
        self.registered[name] = (getter, setter)

    def reshard_registered(self, view) -> None:
        """One device holds every node's state: nothing moves."""
        return None


_DEFAULT = SimDataPlane()


def default_dataplane() -> SimDataPlane:
    """The plane of a ``HierarchicalCollectives`` built without a cluster:
    the shared sim plane, so a bare schedule stays numpy-only."""
    return _DEFAULT


def make_dataplane(policy, device: str | torch.device = "cuda"):
    """The plane ``policy.data_plane`` names: ``torch`` on ``device``,
    ``sim``, or ``auto`` (torch when more than one CUDA device is visible,
    else sim)."""
    kind = policy.data_plane
    if kind == "auto":
        kind = "torch" if torch.cuda.device_count() > 1 else "sim"
    if kind == "torch":
        return TorchDataPlane(device)
    if kind == "sim":
        return SimDataPlane()
    raise ValueError(f"unknown data_plane {policy.data_plane!r}")
