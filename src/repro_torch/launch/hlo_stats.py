"""Per-device costs of a step run on DTensors, and the roofline terms.

The JAX package's ``launch/hlo_stats.py`` parses compiled HLO text. The
port has no HLO: the dry-run runs the step once on DTensors of ``meta``
blocks over torch's fake process group, and :class:`CostMode` reads the
local (per-device) ops DTensor runs:

  * FLOPs: every local op that ``torch.utils.flop_counter`` has a formula
    for (``FlopCounterMode``'s registry: mm, bmm, addmm, baddbmm,
    convolutions, attention), on the local shard's shapes;
  * bytes: operand + result bytes of every local op that is not a view,
    the "every op round-trips HBM" model of the reference's unfused
    count (eager torch fuses nothing);
  * collectives: each functional collective DTensor emits
    (``torch.ops._c10d_functional``), its count, operand bytes and a ring
    wire-bytes estimate with the reference's factors (all-gather (g-1)x
    the shard, all-reduce 2(g-1)/g, reduce-scatter / all-to-all (g-1)/g,
    anything else 1x), where g is the size of the collective's group.

Nothing is scaled by loop trips: every layer runs, so every op is seen.
The HLO-text parser (``analyze``, ``contributors``) has no torch input and
is not ported; its torch counterpart (an op-level profile of the fake
step) is queued with ``kernel_roofline``.

:func:`roofline_terms` and :func:`model_flops` are the reference's, as is.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# functional collective (torch.ops._c10d_functional.<name>) -> the
# reference's HLO opcode name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclass
class CollectiveStats:
    counts: dict[str, float] = field(default_factory=dict)
    operand_bytes: dict[str, float] = field(default_factory=dict)
    wire_bytes: dict[str, float] = field(default_factory=dict)

    def add(self, kind: str, count: float, op_bytes: float, wire: float) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + count
        self.operand_bytes[kind] = self.operand_bytes.get(kind, 0) + op_bytes
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0) + wire

    @property
    def total_operand_bytes(self) -> float:
        return sum(self.operand_bytes.values())

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def to_json(self) -> dict:
        return {
            "counts": {k: round(v, 1) for k, v in self.counts.items()},
            "operand_bytes": {k: round(v) for k, v in self.operand_bytes.items()},
            "wire_bytes": {k: round(v) for k, v in self.wire_bytes.items()},
            "total_operand_bytes": round(self.total_operand_bytes),
            "total_wire_bytes": round(self.total_wire_bytes),
        }


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: CollectiveStats = field(default_factory=CollectiveStats)


def wire_factor(op: str, g: int) -> float:
    """Ring wire bytes per operand byte of collective ``op`` over ``g`` ranks."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return float(g - 1)
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op in ("reduce-scatter", "all-to-all"):
        return float(g - 1) / g
    return 1.0


def _tensor_bytes(tree) -> int:
    total = 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(name).size()


class CostMode(TorchDispatchMode):
    """Counts the per-device FLOPs, bytes and collectives of the local ops
    run inside it (module docstring); the total is in ``self.cost``.

    A DTensor op is passed on (``NotImplemented``) so DTensor runs first and
    the mode sees the local ops and collectives it emits."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.cost = Cost()
        self._flops = flop_registry

    def __enter__(self):
        from torch._guards import active_fake_mode

        # DTensor infers an op's output shapes by running it on global-shape
        # stand-ins under a FakeTensorMode of its own: those ops are not the
        # device's, and are told apart by the fake mode they run under
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_on_entry:
            return out
        packet = func._overloadpacket
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                op_bytes = _tensor_bytes(args[0])
                g = _group_size(args)
                self.cost.coll.add(kind, 1.0, op_bytes, op_bytes * wire_factor(kind, g))
                self.cost.bytes += op_bytes + _tensor_bytes(out)
            return out
        if packet in self._flops:
            self.cost.flops += self._flops[packet](*args, **kwargs, out_val=out)
        if not func.is_view and ns == "aten":
            self.cost.bytes += _tensor_bytes(args) + _tensor_bytes(out)
        return out


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    wire_bytes_per_device: float,
    *,
    chip=None,
) -> dict:
    from repro_torch.launch.hw import DEFAULT_CHIP
    chip = chip or DEFAULT_CHIP
    compute_s = flops_per_device / chip.peak_flops_bf16
    memory_s = bytes_per_device / chip.hbm_bw
    collective_s = wire_bytes_per_device / chip.ici_bw
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["step_lower_bound_s"] = bound
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    return terms


def model_flops(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) — the 'useful' FLOPs yardstick."""
    n = cfg.active_params() if cfg.is_moe else cfg.total_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch
