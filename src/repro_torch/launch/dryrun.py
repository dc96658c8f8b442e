"""Multi-pod dry-run: run every (arch × shape × mesh) cell once on stand-ins.

The proof that the distribution config is coherent without the hardware:
torch's ``fake`` process group of 256 or 512 ranks stands in for one or
two pods of cards, the full-size model's inputs are DTensors placed by
``cell_shardings`` whose blocks are ``meta`` tensors (shapes only: nothing
is allocated), and the step runs once inside ``use_mesh`` — forward,
backward and AdamW for train — as rank 0 of the mesh would run it. DTensor
emits the collectives its placements need; the fake group completes them
without moving data. The blocks are meta tensors rather than tensors of a
``FakeTensorMode`` around the step: DTensor computes the offsets of a
strided shard from index tensors it makes itself, and an ambient fake mode
turns those into fakes whose values it cannot read.

What it records, per device (rank 0's blocks):
  * argument bytes: the sum of the local input shards (``steps.argument_bytes``),
    beside the sum the specs alone give (``steps.spec_bytes``);
  * peak bytes: ``torch.distributed._tools.mem_tracker.MemTracker`` over
    the step, the inputs included;
  * FLOPs, bytes accessed and collectives: ``hlo_stats.CostMode``;
  * the roofline terms on ``hw.DEFAULT_CHIP`` (the H100) and the useful
    FLOP ratio against ``hlo_stats.model_flops``.

The record keeps the reference's keys where they mean the same thing. Its
``lower_s`` / ``compile_s`` become ``run_s`` (the fake step's seconds), and
the keys with no torch meaning are dropped: ``temp_bytes`` and
``alias_bytes`` (no compiled buffer assignment; the peak is tracked
directly), ``xla_flops_unscaled`` and ``xla_bytes_unscaled``.

The model runs its plain paths (``use_pallas`` is off in every config), as
the reference's dry-run does: the hand-written kernels take no DTensor.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

The fake group is started by :func:`run_cell` / :func:`main`, never at
import.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import SHAPES, ShapeSpec, TrainConfig, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape
from repro_torch.dist.compat import use_mesh
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import describe, make_production_mesh, production_shape
from repro_torch.launch.steps import (
    argument_bytes,
    cell_shardings,
    input_specs,
    spec_bytes,
    step_fn_for,
)


def fake_group(world: int) -> None:
    """Make torch's ``fake`` backend of ``world`` ranks the default process
    group (this process is rank 0), replacing another default group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _zip_map(fn, tree, shard_tree):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shard_tree[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, s) for v, s in zip(tree, shard_tree)))
    return fn(tree, shard_tree)


def place_inputs(specs: dict, in_sh: dict, device: str | torch.device = "meta") -> dict:
    """The stand-ins as DTensors placed by ``in_sh``: each leaf is made whole
    on ``device`` (``meta``: shapes only) and sliced to this rank's block.
    Host ints stay."""
    from torch.distributed.tensor import distribute_tensor

    def place(leaf, sh):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        whole = torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
        return distribute_tensor(whole, sh.mesh, sh.placements, src_data_rank=None)

    return {k: _zip_map(place, v, in_sh[k]) for k, v in specs.items()}


def _local_tensors(tree) -> list:
    from torch.distributed.tensor import DTensor

    out = []
    for leaf in torch.utils._pytree.tree_leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _device_tracker():
    """``MemTracker`` counting only this device's blocks. DTensor infers an
    op's output shapes by running it on global-shape stand-ins under a
    ``FakeTensorMode`` of its own; newer releases' tracker skips those ops,
    older ones count them as allocations. This one skips them in every
    release: the stand-ins here are ``meta`` tensors, so any op that runs
    under a fake mode is DTensor's. It skips too the ops DTensor's sharding
    propagation runs on a cache miss (``hlo_stats.in_sharding_prop``)."""
    from torch._guards import active_fake_mode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class DeviceMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if (active_fake_mode() is not None or hlo_stats.in_sharding_prop()) and \
                    not any(issubclass(t, DTensor) for t in types):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return DeviceMemTracker()


def dryrun_step(cfg, shape: ShapeSpec, mesh, *, device: str = "meta",
                tc: TrainConfig | None = None, attribute: bool = False) -> dict:
    """Run one cell's step on stand-in DTensors over ``mesh``; returns the
    measurements (argument bytes, their sum from the specs, output and peak
    bytes, the ``Cost``, seconds) and the ``CostMode`` itself, whose rows
    ``hlo_stats.contributors`` reads when ``attribute`` is on."""
    from torch.distributed.tensor.experimental import implicit_replication

    specs = input_specs(cfg, shape)
    in_sh, _ = cell_shardings(cfg, shape, mesh, specs)
    fn = step_fn_for(cfg, shape, tc or TrainConfig())
    t0 = time.perf_counter()
    args = place_inputs(specs, in_sh, device)
    arg_bytes = argument_bytes(args)
    tracker = _device_tracker()
    tracker.track_external(*_local_tensors(args))
    cost_mode = hlo_stats.CostMode(attribute=attribute)
    with use_mesh(mesh), implicit_replication(), tracker, cost_mode:
        out = fn(**args)
    peak = sum(snap.get("Total", 0)
               for snap in tracker.get_tracker_snapshot("peak").values())
    out_bytes = argument_bytes(out)
    return {"argument_bytes": arg_bytes, "spec_bytes": spec_bytes(specs, in_sh),
            "output_bytes": out_bytes, "peak_bytes": peak, "cost": cost_mode.cost,
            "cost_mode": cost_mode, "run_s": time.perf_counter() - t0}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: dict | None = None, verbose: bool = True) -> dict:
    """Run one cell on the production mesh; returns the JSON-able record."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True, "reason": reason}

    fake_group(math.prod(production_shape(multi_pod=multi_pod)[0]))
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    record = cell_record(cfg, shape, mesh, verbose=verbose)
    record.update(arch=arch, shape=shape_name, multi_pod=multi_pod, overrides=overrides or {})
    return record


def cell_record(cfg, shape: ShapeSpec, mesh, *, verbose: bool = True) -> dict:
    """:func:`dryrun_step`'s measurements as the record the CLI writes."""
    n_dev = math.prod(tuple(mesh.shape))
    m = dryrun_step(cfg, shape, mesh)
    cost = m["cost"]
    coll = cost.coll
    terms = hlo_stats.roofline_terms(cost.flops, cost.bytes, coll.total_wire_bytes)
    mflops = hlo_stats.model_flops(cfg, shape)
    record = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": describe(mesh),
        "n_devices": n_dev,
        "step_kind": shape.kind,
        "skipped": False,
        "run_s": m["run_s"],
        "memory_analysis": {
            "argument_bytes": m["argument_bytes"],
            "spec_argument_bytes": m["spec_bytes"],
            "output_bytes": m["output_bytes"],
            "peak_bytes_per_device": m["peak_bytes"],
        },
        "cost_analysis": {
            "flops_per_device": cost.flops,
            "bytes_accessed_per_device": cost.bytes,
        },
        "collectives": coll.to_json(),
        "model_flops_global": mflops,
        "model_flops_per_device": mflops / n_dev,
        "useful_flops_ratio": (mflops / n_dev) / cost.flops if cost.flops else 0.0,
        "roofline": terms,
    }
    if verbose:
        ma = record["memory_analysis"]
        print(f"  run {m['run_s']:.1f}s | args {ma['argument_bytes']/2**30:.2f} GiB "
              f"peak {ma['peak_bytes_per_device']/2**30:.2f} GiB/dev")
        print(f"  flops/dev {cost.flops:.3e}  bytes/dev {cost.bytes:.3e}  "
              f"wire/dev {coll.total_wire_bytes:.3e}  counts {coll.counts}")
        print(f"  roofline: compute {terms['compute_s']*1e3:.2f} ms | "
              f"memory {terms['memory_s']*1e3:.2f} ms | "
              f"collective {terms['collective_s']*1e3:.2f} ms  "
              f"-> {terms['dominant']}-bound, "
              f"useful-FLOP ratio {record['useful_flops_ratio']:.2f}")
    return record


def cell_list(args) -> list[tuple[str, str]]:
    if args.all:
        return [(arch, shape_name) for arch in ARCH_IDS for shape_name in SHAPES]
    if not args.arch or not args.shape:
        print("need --arch and --shape (or --all)", file=sys.stderr)
        sys.exit(2)
    return [(args.arch, args.shape)]


def parse_overrides(items: list[str]) -> dict:
    """``key=value`` strings as config overrides, each value an int, a float
    or else the string."""
    overrides = {}
    for ov in items:
        k, v = ov.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v
    return overrides


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="every (arch x shape) cell")
    ap.add_argument("--multi-pod", action="store_true",
                    help="(2,16,16) pod/data/model mesh instead of (16,16)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun",
                    help="artifact directory (JSON per cell)")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (repeatable), e.g. act_shard=batch_seq")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    args = ap.parse_args(argv)
    # DTensor notes each multi-step redistribution; a sweep would print thousands
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    overrides = parse_overrides(args.override)
    meshes = [True, False] if args.both_meshes else [args.multi_pod]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    failures, n_ok, n_skip = [], 0, 0
    for arch, shape_name in cell_list(args):
        for mp in meshes:
            mesh_tag = "pod2" if mp else "pod1"
            name = f"{arch}_{shape_name}_{mesh_tag}"
            if args.tag:
                name += f"_{args.tag}"
            print(f"[dryrun] {name}", flush=True)
            try:
                rec = run_cell(arch, shape_name, multi_pod=mp,
                               overrides=overrides or None)
            except Exception:
                traceback.print_exc()
                failures.append(name)
                continue
            (outdir / f"{name}.json").write_text(json.dumps(rec, indent=1))
            if rec.get("skipped"):
                n_skip += 1
                print(f"  SKIP: {rec['reason']}")
            else:
                n_ok += 1

    print(f"\n[dryrun] ok={n_ok} skipped={n_skip} failed={len(failures)}")
    for f in failures:
        print(f"  FAILED: {f}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
