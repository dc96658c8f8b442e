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
Ops that DTensor runs only to work out a placement are not the device's
and are not counted: those under a ``FakeTensorMode`` of its own, and
those its sharding propagation runs on a cache miss (a decomposition
strategy runs an op's decomposition on meta tensors under a dispatch mode
of its own; :func:`in_sharding_prop`). So a cell counts the same cold or
after another cell has warmed the cache.
The HLO-text parser has no torch input and is not ported: the dry-run's
total (``CostMode.cost``) stands for ``analyze``'s.

Attribution (``CostMode(attribute=True)``, off by default) is the
counterpart of ``contributors``: each counted op adds its calls, bytes,
FLOPs and wire bytes to a row keyed by its site (the innermost frame under
``repro_torch/models/`` as ``module.function``, the counterpart of XLA's
``op_name``), its aten op and its output's shape. An op that autograd's
backward runs has no model frame on the stack: it takes the site of the
forward op whose gradient it computes, which a ``TorchFunctionMode`` wrote
into that op's autograd node. :func:`contributors` returns the rows as the
reference's does; summed, they give ``CostMode.cost`` exactly.

:func:`roofline_terms` and :func:`model_flops` are the reference's, as is.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import torch
from torch.overrides import TorchFunctionMode
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


# ---------------------------------------------------------------------------
# Attribution: where each counted op comes from
# ---------------------------------------------------------------------------

_MODELS = f"{os.sep}repro_torch{os.sep}models{os.sep}"
_PORT = f"{os.sep}repro_torch{os.sep}"
# code object -> (2 model frame | 1 other frame of the port | 0 elsewhere, site)
_FRAME_KIND: dict = {}


def _frame_kind(code) -> tuple[int, str]:
    kind = _FRAME_KIND.get(code)
    if kind is None:
        path = code.co_filename
        site = f"{os.path.splitext(os.path.basename(path))[0]}.{code.co_name}"
        kind = _FRAME_KIND[code] = (2 if _MODELS in path else
                                    1 if _PORT in path and path != __file__ else 0, site)
    return kind


def _frame_site() -> tuple[str | None, str | None]:
    """(the innermost model frame's site, the innermost port frame's) on the
    caller's stack; None where there is none."""
    f, port = sys._getframe(2), None
    while f is not None:
        kind, site = _frame_kind(f.f_code)
        if kind == 2:
            return site, port
        if kind == 1 and port is None:
            port = site
        f = f.f_back
    return None, port


_SHARDING_PROP = "/torch/distributed/tensor/_sharding_prop.py"


def in_sharding_prop() -> bool:
    """Whether DTensor's sharding propagation is on the stack: on a cache
    miss it runs ops that work out a placement, which no device runs."""
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code.co_filename.replace(os.sep, "/").endswith(_SHARDING_PROP):
            return True
        frame = frame.f_back
    return False


class _SiteMode(TorchFunctionMode):
    """Writes the model site of each torch call into the autograd nodes it
    made (the outputs' ``grad_fn`` and the nodes behind it back to the
    inputs'), so the backward's ops can be attributed to it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        site = _frame_site()[0]
        if site is not None:
            stack = [t.grad_fn for t in torch.utils._pytree.tree_leaves(out)
                     if isinstance(t, torch.Tensor) and t.grad_fn is not None]
            while stack:
                node = stack.pop()
                if node is None or "site" in node.metadata:
                    continue
                node.metadata["site"] = site
                stack.extend(n for n, _ in node.next_functions)
        return out


def _site() -> str:
    """Where the op being counted comes from: the innermost model frame; in
    autograd's backward, the site written into the running node; else the
    innermost frame of the port."""
    site, port = _frame_site()
    if site is not None:
        return site
    node = torch._C._current_autograd_node()
    if node is not None and "site" in node.metadata:
        return node.metadata["site"]
    return port or "?"


_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float64: "f64", torch.int64: "s64", torch.int32: "s32",
                torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


def _shape_text(out) -> str:
    """The output's shape as HLO prints one (``bf16[4,512,1024]``); a tuple
    of them in parentheses."""
    ts = [t for t in torch.utils._pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
    text = ",".join(f"{_DTYPE_NAMES.get(t.dtype, str(t.dtype))}[{','.join(map(str, t.shape))}]"
                    for t in ts)
    return text if len(ts) == 1 else f"({text})"


class CostMode(TorchDispatchMode):
    """Counts the per-device FLOPs, bytes and collectives of the local ops
    run inside it (module docstring); the total is in ``self.cost``, and
    with ``attribute`` the rows of :func:`contributors` in ``self.rows``.

    A DTensor op is passed on (``NotImplemented``) so DTensor runs first and
    the mode sees the local ops and collectives it emits."""

    def __init__(self, attribute: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.cost = Cost()
        self._flops = flop_registry
        # (site, aten op, output shape) -> [calls, bytes, flops, wire, opcode]
        self.rows: dict | None = {} if attribute else None
        self._sites = _SiteMode() if attribute else None

    def __enter__(self):
        from torch._guards import active_fake_mode

        # DTensor infers an op's output shapes by running it on global-shape
        # stand-ins under a FakeTensorMode of its own: those ops are not the
        # device's, and are told apart by the fake mode they run under
        self._fake_on_entry = active_fake_mode()
        if self._sites is not None:
            self._sites.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if self._sites is not None:
            self._sites.__exit__(*exc)
        return out

    def _attribute(self, func, opcode: str, out, nbytes: float, flops: float,
                   wire: float) -> None:
        key = (_site(), str(func), _shape_text(out))
        row = self.rows.get(key)
        if row is None:
            row = self.rows[key] = [0, 0.0, 0.0, 0.0, opcode]
        row[0] += 1
        row[1] += nbytes
        row[2] += flops
        row[3] += wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_on_entry or in_sharding_prop():
            return out
        packet = func._overloadpacket
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                op_bytes = _tensor_bytes(args[0])
                wire = op_bytes * wire_factor(kind, _group_size(args))
                nbytes = op_bytes + _tensor_bytes(out)
                self.cost.coll.add(kind, 1.0, op_bytes, wire)
                self.cost.bytes += nbytes
                if self.rows is not None:
                    self._attribute(func, kind, out, nbytes, 0.0, wire)
            return out
        flops = nbytes = 0
        if packet in self._flops:
            flops = self._flops[packet](*args, **kwargs, out_val=out)
            self.cost.flops += flops
        if not func.is_view and ns == "aten":
            nbytes = _tensor_bytes(args) + _tensor_bytes(out)
            self.cost.bytes += nbytes
        if self.rows is not None and (flops or nbytes):
            self._attribute(func, packet.__name__, out, nbytes, flops, 0.0)
        return out


def contributors(mode: CostMode, top: int | None = 30) -> list[dict]:
    """The attributed rows of ``mode`` (a :class:`CostMode` run with
    ``attribute=True``) with the reference's keys, the largest first by
    bytes + 10 x wire bytes, as the reference sorts them: ``comp`` and
    ``meta`` the site, ``name`` the aten op, ``opcode`` its name or the
    collective's, ``shape`` the output's, ``scale`` the calls (every call
    is run, none scaled by a loop trip count), and the row's ``bytes``,
    ``flops`` and ``wire`` summed over its calls. ``top=None`` keeps every
    row."""
    if mode.rows is None:
        raise ValueError("the CostMode ran without attribute=True")
    rows = [{"comp": site, "name": name, "opcode": opcode, "shape": shape, "scale": calls,
             "bytes": nbytes, "flops": flops, "wire": wire, "meta": site}
            for (site, name, shape), (calls, nbytes, flops, wire, opcode) in mode.rows.items()]
    rows.sort(key=lambda r: -(r["bytes"] + r["wire"] * 10))
    return rows if top is None else rows[:top]


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
