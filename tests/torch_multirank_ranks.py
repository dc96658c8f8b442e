"""Rank programs of tests/test_torch_multirank.py: one process per rank.

    python tests/torch_multirank_ranks.py CASE RANK WORLD WORKDIR

Each rank joins a gloo group through a file rendezvous in WORKDIR (no TCP
port is fixed; ``world1`` and ``train1`` start through ``init_from_env``
from the environment the test sets), reads the inputs from
WORKDIR/inputs.npz, runs CASE on the CPU and pickles what it saw to
WORKDIR/CASE.rankRANK.pkl for the test to compare. It imports torch, numpy
and the port only; the tests import its campaign functions
(:func:`campaigns`, :func:`run_campaign`) to run the same campaigns through
the JAX package's ``Session``, and its training runs (:data:`TRAIN_RUNS`,
:func:`drive`, :func:`port_trainer`) to run them through the JAX package's
trainer and the port's on one rank.
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import FaultInjector, LegioPolicy  # noqa: E402
from repro_torch.mpi import Session  # noqa: E402

CAMPAIGN_FAULTS = [(2, 9), (4, 0)]          # tests/test_dataplane.py: a member, then a master
CAMPAIGN_MODES = {
    "shrink": {"recovery_mode": "shrink"},
    "substitute": {"recovery_mode": "substitute", "spare_nodes": 2},
    "overlap": {"recovery_mode": "shrink", "repair_overlap": True},
}
STEPS = 7
ALL_OPS = ("allreduce", "bcast", "reduce", "gather")


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _result(res) -> dict:
    return {"stages": list(res.stages), "sim_seconds": res.sim_seconds,
            "data": {n: _np(v) for n, v in res.data.items()}}


def campaigns(inputs: dict) -> dict:
    """The world-4 campaigns, over 16 nodes in legions of 4 through
    CAMPAIGN_FAULTS: name -> (policy kwargs, payload(step, node), ops,
    whether to record the compression residuals)."""
    def integer_exact(step, m):
        return (np.arange(8, dtype=np.float32) % 5.0) * (m + 1) - step

    g, g_f32 = inputs["g_int"], inputs["g_f32"]
    out = {mode: (kw, integer_exact, ALL_OPS, False) for mode, kw in CAMPAIGN_MODES.items()}
    out["int8"] = ({"grad_compression": "int8"}, lambda step, m: g * np.float32(m % 3 + 1),
                   ("allreduce",), True)
    out["f32"] = ({}, lambda step, m: g_f32[(step * 16 + m + 1) % 64], ("allreduce", "reduce"),
                  False)
    return out


def run_campaign(core, mpi, spec, *, policy_extra=None, session_extra=None) -> list[dict]:
    """One campaign through ``mpi.Session`` of package ``core``/``mpi`` (the
    port's or the JAX package's): per step, the topology, what each op
    returned, the residuals if asked, and the repair rounds so far."""
    kw, payload, ops, residuals = spec
    sess = mpi.Session(16, policy=core.LegioPolicy(legion_size=4, **kw, **(policy_extra or {})),
                       injector=core.FaultInjector.at(list(CAMPAIGN_FAULTS)),
                       **(session_extra or {}))
    records = []
    for step in range(STEPS):
        sess.advance(step)
        cl, comm = sess.cluster, sess.world
        live = [m for m in comm.members if m not in cl.failed]
        contrib = {m: payload(step, m) for m in live}
        out = {"step": step, "nodes": list(cl.topo.nodes)}
        root = sorted(comm.members)[0]
        for op in ops:
            if op == "allreduce":
                out[op] = _result(comm.allreduce(contrib))
            elif op == "bcast":
                out[op] = _result(comm.bcast(payload(step, -1), root=root))
            elif op == "reduce":
                out[op] = _result(comm.reduce(contrib, root=root))
            else:
                out[op] = {n: _np(v) for n, v in comm.gather(contrib).items()}
        if residuals:
            out["residuals"] = {m: _np(r) for m, r in cl.compress_residuals.items()}
        out["repair_rounds"] = comm.stats.repair_rounds
        records.append(out)
    return records


def case_campaign(rank: int, world: int, inputs: dict) -> dict:
    """World 4: every campaign on the torch plane over the group, and on the
    sim plane in the same process; the auto plane; the trainer built and
    stepped over the four ranks."""
    from repro_torch import core, mpi
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import VirtualCluster
    from repro_torch.core.trainer import ResilientTrainer
    from repro_torch.dist.dataplane import TorchDataPlane, make_dataplane

    out = {"campaigns": {
        name: {plane: run_campaign(core, mpi, spec, policy_extra={"data_plane": plane},
                                   session_extra={"device": "cpu"})
               for plane in ("torch", "sim")}
        for name, spec in campaigns(inputs).items()}}
    plane = make_dataplane(LegioPolicy(data_plane="auto"), "cpu")
    out["auto"] = (type(plane).__name__, plane.world, plane.rank)
    out["plane_is_torch"] = isinstance(plane, TorchDataPlane)
    cl = VirtualCluster(4, policy=LegioPolicy(legion_size=2), device="cpu")
    trainer = ResilientTrainer(get_smoke_config("llama3.2-3b"), TrainConfig(), cl,
                               per_shard_batch=1, seq_len=16)
    out["trainer"] = {"distributed": trainer.distributed,
                      "reports": [report_record(trainer.run_step()) for _ in range(2)]}
    return out


def _holder_session(faults, state):
    sess = Session(8, policy=LegioPolicy(legion_size=4, data_plane="torch"),
                   injector=FaultInjector.at(faults), device="cpu")
    holder = {"state": state}
    sess.register_sharded_state("params", lambda: holder["state"],
                                lambda s: holder.update(state=s))
    return sess, holder


def _leaves_seen(tree) -> dict:
    seen = {}
    for name, leaf in tree.items():
        seen[name] = {"placements": [repr(p) for p in leaf.placements],
                      "shape": tuple(leaf.shape), "local": _np(leaf.to_local()),
                      "coord": leaf.device_mesh.get_coordinate(),
                      "mesh_ranks": leaf.device_mesh.mesh.tolist()}
    return seen


def _run_steps(sess, steps):
    cl = sess.cluster
    for step in range(steps):
        sess.advance(step)
        sess.world.allreduce({m: np.ones(4, np.float32) for m in sess.world.members
                              if m not in cl.failed})


def case_reshard(rank: int, world: int, inputs: dict) -> dict:
    """World 8: tests/test_dataplane.py's reshard case, a second campaign
    that reshards twice (7 then 6 ranks), and the in-program functions."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core.agreement import agree_bitmap_inprogram
    from repro_torch.core.collectives import (
        hierarchical_psum_scatter,
        make_hierarchical_allreduce,
    )
    from repro_torch.dist.sharding import placements

    out = {}
    sess, holder = _holder_session([(1, 3)], {k: torch.from_numpy(inputs[k])
                                             for k in ("wq", "bias")})
    cl = sess.cluster
    t0 = cl.clock.sim_seconds
    _run_steps(sess, 3)
    out["one"] = {"nodes": list(cl.topo.nodes), "reshards": list(cl.reshards),
                  "t0": t0, "t1": cl.clock.sim_seconds, "leaves": _leaves_seen(holder["state"]),
                  "sim_seconds": cl.clock.sim_seconds}

    sess2, holder2 = _holder_session([(1, 3), (3, 5)], {k: torch.from_numpy(inputs[k])
                                                       for k in ("w_in", "wo", "embed", "norm")})
    _run_steps(sess2, 5)
    out["two"] = {"nodes": list(sess2.cluster.topo.nodes), "reshards": list(sess2.cluster.reshards),
                  "leaves": _leaves_seen(holder2["state"])}

    # the in-program functions on meshes of the eight ranks
    ranks = torch.arange(world)
    bitmaps = torch.from_numpy(inputs["bitmaps"])
    meshes = {"data8": DeviceMesh("cpu", ranks, mesh_dim_names=("data",)),
              "pod2_data4": DeviceMesh("cpu", ranks.reshape(2, 4), mesh_dim_names=("pod", "data")),
              "model8": DeviceMesh("cpu", ranks, mesh_dim_names=("model",))}
    out["agree"] = {name: agree_bitmap_inprogram(m, bitmaps) for name, m in meshes.items()}
    out["allreduce"] = {}
    for name, shape, names, spec in (
            ("pod_data_model", (2, 4, 1), ("pod", "data", "model"), (("pod", "data"),)),
            ("data_model", (8, 1), ("data", "model"), ("data",))):
        mesh = DeviceMesh("cpu", ranks.reshape(shape), mesh_dim_names=names)
        x = distribute_tensor(torch.from_numpy(inputs["x_allreduce"]), mesh,
                              placements(spec, mesh), src_data_rank=None)
        out["allreduce"][name] = _np(make_hierarchical_allreduce(mesh, spec)(x).to_local())
    m24 = meshes["pod2_data4"]
    pod, data = m24.get_group("pod"), m24.get_group("data")
    x0 = torch.from_numpy(inputs["x_scatter0"])
    x1 = torch.from_numpy(inputs["x_scatter1"])
    r0, r1 = x0.shape[0] // world, x1.shape[0] // world
    out["psum_scatter"] = {
        0: _np(hierarchical_psum_scatter(x0[rank * r0:(rank + 1) * r0], pod, data)),
        1: _np(hierarchical_psum_scatter(x1[rank * r1:(rank + 1) * r1], pod, data,
                                         scatter_dim=1))}
    return out


def case_world1(rank: int, world: int, inputs: dict) -> dict:
    """init_from_env("cpu") at world size 1: the int8 campaign through the
    group's path, then with the group destroyed through the one-rank path."""
    from repro_torch.dist.dataplane import init_from_env

    def run():
        sess = Session(16, policy=LegioPolicy(legion_size=4, grad_compression="int8"),
                       injector=FaultInjector.at(CAMPAIGN_FAULTS), device="cpu")
        sess.register_sharded_state("x", lambda: {"w_in": torch.ones(4, 4)})
        results = []
        for step in range(STEPS):
            sess.advance(step)
            contrib = {m: inputs["g_f32"][(step * 16 + m) % 64] for m in sess.world.members
                       if m not in sess.cluster.failed}
            results.append(_result(sess.world.allreduce(contrib)))
        plane = sess.cluster.dataplane
        return {"distributed": plane.distributed, "world": plane.world,
                "reshards": list(sess.cluster.reshards), "results": results}

    device = init_from_env("cpu")
    out = {"device": str(device), "backend": dist.get_backend(), "group": run()}
    dist.destroy_process_group()
    out["one"] = run()
    return out


# ---- the trainer over ranks (tests/test_torch_multirank_train.py) ----------
TRAIN_NODES, TRAIN_LEGION, PER_SHARD_BATCH, SEQ_LEN = 8, 4, 2, 32
TRAIN_TC = dict(learning_rate=3e-2, total_steps=8, warmup_steps=2, grad_clip=1.0)
CHECKPOINT_EVERY = 2
# name -> faults (step, node), policy knobs, steps, and for "checkpoint" the
# member restored after the steps (legion, node) and the steps run after it.
# Node n lives on rank n % 4: after (2, 1) and (4, 5) rank 1 holds no node.
TRAIN_RUNS = {
    "shrink": dict(faults=[(2, 1), (4, 5)], policy={}, steps=6),
    "rebalance": dict(faults=[(2, 1), (4, 5)], policy={"batch_policy": "rebalance"}, steps=6),
    "checkpoint": dict(faults=[(2, 5)], policy={}, steps=5, restore=(0, 1), after=2),
}


def report_record(r) -> dict:
    """A TrainerReport's fields but its measured seconds (the repair's wall
    time masked in its summary)."""
    import re

    return {"step": r.step, "loss": r.loss, "grad_norm": r.grad_norm,
            "active_shards": r.active_shards, "grad_scale": r.grad_scale,
            "recompiled": r.recompiled, "metrics": dict(r.metrics),
            "repair": None if r.repair is None else re.sub(r"wall=\S+", "wall=*",
                                                            r.repair.summary())}


def drive(trainer, spec: dict, ckpt=None, observe=None) -> list:
    """``spec``'s steps through any package's trainer (``observe(trainer,
    report)`` after each), then, where the spec says, the restore of one
    member from ``ckpt`` and the steps after it. Returns the reports."""
    reports = []
    for _ in range(spec["steps"]):
        reports.append(trainer.run_step())
        if observe is not None:
            observe(trainer, reports[-1])
    if "restore" in spec:
        ckpt.wait()
        if observe is not None:
            observe(trainer, "before restore")
        trainer.restore_from(ckpt, *spec["restore"])
        if observe is not None:
            observe(trainer, "restored")
        for _ in range(spec["after"]):
            reports.append(trainer.run_step())
            if observe is not None:
                observe(trainer, reports[-1])
    return reports


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict of the ``prefix``-ed, "/"-joined keys of ``flat``."""
    tree: dict = {}
    for key, value in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = value
    return tree


def port_trainer(cfg, spec: dict, init: dict, plane: str, ckpt=None):
    """The port's trainer on the CPU for run ``spec``, its weights the
    reference's ``init`` (a numpy tree) and fresh AdamW moments."""
    from repro_torch import core as P
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.convert import params_from_reference
    from repro_torch.optim import adamw_init

    cl = P.VirtualCluster(TRAIN_NODES, policy=P.LegioPolicy(legion_size=TRAIN_LEGION,
                                                            data_plane=plane, **spec["policy"]),
                          injector=P.FaultInjector.at(spec["faults"]), device="cpu")
    tc = TrainConfig(**TRAIN_TC, checkpoint_every=CHECKPOINT_EVERY if ckpt else 0)
    tr = P.ResilientTrainer(cfg, tc, cl, per_shard_batch=PER_SHARD_BATCH, seq_len=SEQ_LEN,
                            checkpointer=ckpt)
    tr.params = params_from_reference(cfg, init, device="cpu")
    tr.opt = adamw_init(tr.params)
    return tr


def _named_leaves(trainer) -> list:
    """("params/...", "mu/...", "nu/..." path, leaf) of the trainer's state,
    in one order on every rank."""
    out = []
    for name, tree in (("params", trainer.params), ("mu", trainer.opt.mu),
                       ("nu", trainer.opt.nu)):
        stack = [((name,), tree)]
        while stack:
            path, node = stack.pop(0)
            if isinstance(node, dict):
                stack[:0] = [(path + (k,), node[k]) for k in sorted(node)]
            else:
                out.append(("/".join(path), node))
    return out


def _state_seen(trainer) -> dict:
    """Every leaf of params, mu and nu: its placements, local block, mesh
    coordinate and ranks (``_leaves_seen``'s record) where it is placed,
    and the whole tensor, assembled over the world (a collective)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import assemble

    seen = {}
    for name, leaf in _named_leaves(trainer):
        rec = _leaves_seen({name: leaf})[name] if isinstance(leaf, DTensor) else \
            {"placements": None, "shape": tuple(leaf.shape)}
        if "local" in rec:      # copies: the step updates the state in place
            rec["local"] = rec["local"].copy()
        rec["whole"] = _np(assemble(leaf)).copy()
        seen[name] = rec
    return seen


def case_train(rank: int, world: int, inputs: dict) -> dict:
    """World 4: every TRAIN_RUNS run on the torch plane over the group: each
    step's report, every leaf's placement after each repair and around the
    restore, the whole params at each save and at the end, this rank's
    shards and tokens at the last step."""
    import json

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import LegionCheckpointer

    workdir = Path(inputs["workdir"].item())
    cfg = ModelConfig(**json.loads(inputs["fields"].item()))
    init = unflatten(inputs, "init/")
    out = {}
    for name, spec in TRAIN_RUNS.items():
        ckpt = LegionCheckpointer(str(workdir / f"ckpt_{name}")) if "restore" in spec else None
        tr = port_trainer(cfg, spec, init, "torch", ckpt)
        rec = {"distributed": tr.distributed, "after_repair": {}, "saved": {}}

        def observe(trainer, report, rec=rec):
            if isinstance(report, str):
                rec[report] = _state_seen(trainer)
                return
            if report.repair is not None:
                rec["after_repair"][report.step] = _state_seen(trainer)
            if ckpt is not None and report.step > 0 and report.step % CHECKPOINT_EVERY == 0:
                rec["saved"][report.step] = {k: v["whole"] for k, v in _state_seen(trainer).items()}

        rec["reports"] = [report_record(r) for r in drive(tr, spec, ckpt, observe)]
        if ckpt is not None:
            ckpt.close()
        last = tr.step - 1
        shards = tr._rank_shards()
        rec["last_shards"] = shards
        rec["last_tokens"] = _np(tr._batch_of(last, shards)["tokens"]) if shards else None
        rec["final"] = {k: v["whole"] for k, v in _state_seen(tr).items() if k.startswith("params")}
        rec["live_nodes"] = list(tr.cluster.live_nodes)
        rec["reshards"] = [(r.n_devices, r.mesh_shape, r.leaves) for r in tr.cluster.reshards]
        out[name] = rec
    return out


def case_train1(rank: int, world: int, inputs: dict) -> dict:
    """``init_from_env("cpu")`` at world size 1: the "shrink" run through the
    trainer's step over the group, then with the group destroyed through
    the one-rank step; each run's reports and final params."""
    import json

    from repro_torch.configs.base import ModelConfig
    from repro_torch.dist.dataplane import init_from_env

    cfg = ModelConfig(**json.loads(inputs["fields"].item()))
    init = unflatten(inputs, "init/")

    def run():
        tr = port_trainer(cfg, TRAIN_RUNS["shrink"], init, "torch")
        reports = [report_record(r) for r in drive(tr, TRAIN_RUNS["shrink"])]
        return {"distributed": tr.distributed, "reports": reports,
                "final": {k: _np(v).copy() for k, v in _named_leaves(tr)
                          if k.startswith("params")}}

    device = init_from_env("cpu")
    out = {"device": str(device), "group": run()}
    dist.destroy_process_group()
    out["one"] = run()
    return out


# ---------------------------------------------------------------------------
# the placement helpers and the steps on DTensors of real values
# ---------------------------------------------------------------------------

PLACED_STEPS = (("llama3.2-3b", "train"), ("llama3.2-3b", "prefill"), ("llama3.2-3b", "decode"),
                ("mamba2-130m", "train"), ("mamba2-130m", "prefill"),
                ("hymba-1.5b", "decode"))


def _placed_step_args(cfg, specs, rng_seed: int) -> dict:
    """Real values for a step's stand-ins: the params of ``api.init_params``
    (seed 0), the optimizer state of ``adamw_init``, token ids and small
    normals from numpy (seed ``rng_seed``), the same on every rank."""
    from repro_torch.launch import steps
    from repro_torch.models import api

    params = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(rng_seed)

    def fill(leaf):
        if isinstance(leaf, dict):
            return {k: fill(v) for k, v in leaf.items()}
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if leaf.dtype == torch.int32:
            return torch.from_numpy(rng.integers(0, cfg.vocab_size, leaf.shape, dtype=np.int32))
        return torch.from_numpy(rng.standard_normal(leaf.shape).astype(np.float32)
                                ).to(leaf.dtype) * 0.1

    args = {k: fill(v) for k, v in specs.items() if k not in ("params", "opt")}
    args["params"] = params
    if "opt" in specs:
        args["opt"] = steps.adamw_init(params)
    if "cache" in args:
        args["cache"]["pos"] = specs["cache"]["k"].shape[2] - 2 if "k" in specs["cache"] else 5
    return args


def _whole(tree) -> list:
    from torch.distributed.tensor import DTensor

    leaves = torch.utils._pytree.tree_leaves(tree)
    return [(leaf.full_tensor() if isinstance(leaf, DTensor) else leaf).detach().float().numpy()
            for leaf in leaves if isinstance(leaf, torch.Tensor)]


def case_helpers(rank: int, world: int, inputs: dict) -> dict:
    """On a (2, 2) ``("data", "model")`` mesh of gloo ranks: each vocab- and
    head-parallel helper of ``dist.sharding`` on DTensors of the inputs'
    values, and each step of :data:`PLACED_STEPS` (fp32 smoke configs) on
    inputs placed by ``cell_shardings``. Every entry is (the whole result
    over the mesh, the plain op's on whole tensors)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeSpec, TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist import sharding
    from repro_torch.dist.compat import make_mesh, use_mesh
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import _zip_map
    from repro_torch.models.attention import blocked_attention, decode_attention
    from repro_torch.models.ssd import ssd_chunked_reference

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    t = {k: torch.from_numpy(v) for k, v in inputs.items() if v.dtype.kind in "fiub"}

    def put(name, spec, grad=False):
        d = distribute_tensor(t[name].clone(), mesh, sharding.placements(spec, mesh),
                              src_data_rank=None)
        return d.requires_grad_() if grad else d

    def whole(x):
        return x.full_tensor().detach().numpy()

    out = {}
    with use_mesh(mesh), implicit_replication():
        # vocab-parallel reads of logits: even (16 over 2) and uneven (15:
        # blocks of 8 and 7); the ties sit across the two blocks
        for name in ("logits", "logits15"):
            x = put(name, ("data", None, "model"))
            y = put("labels15" if name == "logits15" else "labels", ("data",))
            out[f"take_last/{name}"] = (whole(sharding.take_last(x, y)), torch.gather(
                t[name], -1, t["labels15" if name == "logits15" else "labels"][..., None].long()
            )[..., 0].numpy())
            out[f"argmax_last/{name}"] = (whole(sharding.argmax_last(x)),
                                          torch.argmax(t[name], dim=-1).numpy())
        # vocab-parallel lookup, forward and the table's gradient
        for name in ("table", "table15"):
            tab = put(name, ("model",), grad=True)
            ids = put("ids15" if name == "table15" else "ids", ("data",))
            rows = sharding.take_rows(tab, ids)
            (rows * t["row_w"]).sum().backward()
            plain = t[name].clone().requires_grad_()
            prow = plain[t["ids15" if name == "table15" else "ids"]]
            (prow * t["row_w"]).sum().backward()
            out[f"take_rows/{name}"] = (whole(rows), prow.detach().numpy())
            out[f"take_rows_grad/{name}"] = (whole(tab.grad), plain.grad.numpy())
        # heads split off a model-parallel last dim: 4 heads split in place,
        # 3 heads gathered first (3 does not divide 2); the gradient back
        for heads in (4, 3):
            x = put("proj", ("data", None, "model"), grad=True)
            y = sharding.split_last(x, heads, 12 // heads)
            (y * t["proj_w"].reshape(y.shape)).sum().backward()
            px = t["proj"].clone().requires_grad_()
            py = px.reshape(*px.shape[:-1], heads, 12 // heads)
            (py * t["proj_w"].reshape(py.shape)).sum().backward()
            out[f"split_last/{heads}"] = (whole(y), py.detach().numpy())
            out[f"split_last_grad/{heads}"] = (whole(x.grad), px.grad.numpy())
        # heads merged back (the attention output), its gradient split
        o = put("heads_out", ("data", None, "model"), grad=True)
        z = sharding.merge_last(o) @ t["merge_w"]
        z.sum().backward()
        po = t["heads_out"].clone().requires_grad_()
        pz = po.reshape(*po.shape[:-2], -1) @ t["merge_w"]
        pz.sum().backward()
        out["merge_last"] = (whole(z), pz.detach().numpy())
        out["merge_last_grad"] = (whole(o.grad), po.grad.numpy())
        # per_shard: attention and the SSD scan on each device's blocks
        q, k, v = (put(n, ("data",)) for n in ("q", "k", "v"))
        out["blocked_attention"] = (
            whole(blocked_attention(q, k, v, causal=True, block_q=4, block_k=4,
                                    head_shard="batch")),
            blocked_attention(t["q"], t["k"], t["v"], causal=True, block_q=4,
                              block_k=4).numpy())
        dq, kc, vc = (put(n, ("data",)) for n in ("dq", "kc", "vc"))
        valid = t["valid"]
        out["decode_attention"] = (
            whole(decode_attention(dq, kc, vc, valid, head_shard="batch")),
            decode_attention(t["dq"], t["kc"], t["vc"], valid).numpy())
        names = ("ssd_x", "ssd_dt", "ssd_A", "ssd_B", "ssd_C")
        ssd_in = [put(n, ("data",) if n != "ssd_A" else ()) for n in names]
        h0 = put("ssd_h0", ("data",))
        y, h = ssd_chunked_reference(*ssd_in, chunk=4, initial_state=h0, head_shard="batch")
        py, ph = ssd_chunked_reference(*(t[n] for n in names), chunk=4,
                                       initial_state=t["ssd_h0"])
        out["ssd/y"] = (whole(y), py.numpy())
        out["ssd/state"] = (whole(h), ph.numpy())
        # the state (B, H, P, N): batch over data, heads (x's dim 3) at dim 1
        out["ssd/state_heads_dim"] = (
            np.asarray([p.dim if isinstance(p, Shard) else -1 for p in h.placements]),
            np.asarray([0, 1]))

    # the steps on inputs placed by cell_shardings, against the plain steps
    for arch, kind in PLACED_STEPS:
        cfg = get_smoke_config(arch).replace(n_layers=2, dtype="float32",
                                             param_dtype="float32")
        shape = ShapeSpec(kind, 16, 4, kind)
        specs = steps.input_specs(cfg, shape)
        in_sh, _ = steps.cell_shardings(cfg, shape, mesh, specs)
        fn = steps.step_fn_for(cfg, shape, TrainConfig())
        plain = _whole(fn(**_placed_step_args(cfg, specs, 11)))
        args = _placed_step_args(cfg, specs, 11)
        placed = {k: _zip_map(lambda leaf, sh: distribute_tensor(
            leaf, mesh, sh.placements, src_data_rank=None)
            if isinstance(leaf, torch.Tensor) else leaf, v, in_sh[k]) for k, v in args.items()}
        with use_mesh(mesh), implicit_replication():
            got = _whole(fn(**placed))
        out[f"step/{arch}/{kind}"] = (got, plain)
    return out


CASES = {"campaign": case_campaign, "reshard": case_reshard, "world1": case_world1,
         "train": case_train, "train1": case_train1,
         "helpers": case_helpers}


def main(argv: list[str]) -> int:
    case, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    torch.set_num_threads(1)
    inputs = dict(np.load(workdir / "inputs.npz"), workdir=np.asarray(str(workdir)))
    if case not in ("world1", "train1"):
        dist.init_process_group("gloo", init_method=f"file://{workdir / f'{case}.rdzv'}",
                                rank=rank, world_size=world)
    out = CASES[case](rank, world, inputs)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    with open(workdir / f"{case}.rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
