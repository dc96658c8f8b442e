"""Collective operations over the legion topology (paper §V classes).

The runtime schedules of the paper's operation classes (one-to-one,
one-to-all, all-to-one, all-to-all, comm-creator, file, local-only) with
their hierarchical execution plans (Fig. 4): a Bcast runs in the root's
local_comm, then the global_comm, then the other local_comms in parallel;
a Reduce is the reverse; an AllReduce is reduce-then-bcast. The schedules
both (a) actually move data on the virtual cluster (every survivor receives
the root's payload / the full sum) and (b) produce an alpha-beta time
estimate, so the paper's Fig. 5-9 overhead benchmarks have a deterministic
analogue.

The schedules sit on a **data-plane seam** (:mod:`repro_torch.dist.dataplane`):
the schedule walk — who reduces to whom, the stage list, the alpha-beta
charge, the error-feedback residual update and the compression hop's wire
bytes — is backend-independent control plane, and works on whatever payload
the plane carries (numpy arrays on the sim plane, device tensors on the
torch plane); the payload motion (the fold behind a reduce stage, the
broadcast payload hop, the compression round-trip) delegates to the
injected plane. Stage lists and timing are identical on both by
construction.

Alpha-beta model: a collective over x participants moving m bytes per rank
costs ``ceil(log2 x) * (alpha + m / beta)`` (binomial tree). Intra-legion
hops ride fast links; the cross-legion (global_comm) hop rides slow links.
``LinkModel``'s defaults are the JAX package's (an order of magnitude
between the two link classes), kept so that both packages charge the same
simulated seconds; they are a model, not a measurement of any card.

The in-program two-stage all-reduce (the JAX package's ``hierarchical_psum``
family under ``shard_map``) needs a multi-device process group and comes
with the multi-card slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.hierarchy import LegionTopology

# Operation classes (paper §V)
ONE_TO_ONE = "one_to_one"
ONE_TO_ALL = "one_to_all"
ALL_TO_ONE = "all_to_one"
ALL_TO_ALL = "all_to_all"
COMM_CREATOR = "comm_creator"
FILE_OP = "file"
LOCAL_ONLY = "local_only"

def payload_nbytes(x) -> int:
    """Bytes of one payload: a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.nbytes


def as_float32(x):
    """A numpy payload as a float32 copy, a tensor in float32 (the tensor
    itself when it already is one: the caller's add makes the new one)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return x.astype(np.float32)


@dataclass(frozen=True)
class LinkModel:
    """alpha (s) / beta (B/s) per link class. Defaults: the JAX package's
    intra-pod / cross-pod constants, cross an order of magnitude slower —
    why the hierarchical schedule confines bulk traffic to fast links.

    ``level_slowdown`` is the per-level cost accounting knob for depth >= 3
    topologies: a hop at level ℓ >= 1 is ``level_slowdown**(ℓ-1)`` times
    dearer than the first cross hop (rack -> pod -> data-center fabrics each
    slower than the one below). 1.0 (the default) keeps every cross-level
    hop identical — the depth-2 model unchanged."""

    alpha_intra: float = 1.0e-6
    beta_intra: float = 50.0e9        # fast links inside a legion
    alpha_cross: float = 10.0e-6
    beta_cross: float = 5.0e9         # data-center network between legions
    level_slowdown: float = 1.0

    def tree_time(self, participants: int, nbytes: int, cross: bool) -> float:
        if participants <= 1:
            return 0.0
        rounds = math.ceil(math.log2(participants))
        a = self.alpha_cross if cross else self.alpha_intra
        b = self.beta_cross if cross else self.beta_intra
        return rounds * (a + nbytes / b)

    def level_time(self, participants: int, nbytes: int, level: int) -> float:
        """Binomial-tree time for one hop at hierarchy ``level`` — level 0
        rides fast intra-legion links, every level above rides cross links,
        scaled by ``level_slowdown`` per additional level."""
        t = self.tree_time(participants, nbytes, cross=level >= 1)
        if level >= 2 and self.level_slowdown != 1.0:
            t *= self.level_slowdown ** (level - 1)
        return t


@dataclass
class CollectiveResult:
    """Outcome of one scheduled collective on the virtual cluster."""
    op: str
    sim_seconds: float                      # alpha-beta estimate
    data: dict[int, Any]                    # node -> payload after the op
    stages: list[tuple[str, int, float]]    # (comm, participants, seconds)


class HierarchicalCollectives:
    """Executes the paper's §V schedules over a LegionTopology.

    ``compression`` (beyond-paper) applies int8/top-k error-feedback
    compression to the *cross-legion* hop only — the master-to-master stage
    rides the slow links, so that is where volume reduction pays (see
    optim/compression.py). ``residuals`` is the per-master error-feedback
    store; pass a persistent dict (the VirtualCluster owns one) so residuals
    survive across steps — dead masters' residuals are simply abandoned,
    which is safe (their contribution was already incorporated or lost with
    the node, exactly like its batch shard).

    ``dataplane`` selects what moves the payload bytes (see module
    docstring); without one the schedule runs on the shared sim plane.
    """

    def __init__(self, topo: LegionTopology, link: LinkModel | None = None,
                 *, compression: str = "none", topk_fraction: float = 0.05,
                 residuals: dict | None = None, dataplane=None):
        from repro_torch.dist.dataplane import default_dataplane
        self.topo = topo
        self.link = link or LinkModel()
        self.compression = compression
        self.topk_fraction = topk_fraction
        self.residuals = residuals if residuals is not None else {}
        self.dataplane = dataplane if dataplane is not None else default_dataplane()

    def _compress_cross(self, master: int, partial: Any) -> tuple[Any, int]:
        """Error-feedback compress one master's partial for the slow hop.
        Returns (decompressed-at-receiver value, wire bytes). The round-trip
        itself runs on the data plane (numpy twins on sim, the absmax and
        quantize kernels on torch — byte-identical either way); the residual
        update and the wire-byte accounting stay here in the control plane,
        so both backends account the hop identically. The residual store
        holds payloads of the plane's kind (device tensors on torch)."""
        from repro_torch.optim import compression as C
        if self.compression not in ("int8", "topk"):
            return partial, payload_nbytes(partial)
        gf = as_float32(partial) + self.residuals.get(master, 0.0)
        back = self.dataplane.compress(gf, self.compression,
                                       self.topk_fraction)
        self.residuals[master] = gf - back
        nbytes = C.compressed_bytes(gf, self.compression, self.topk_fraction)
        return back, nbytes

    # -- helpers ---------------------------------------------------------------

    def _stage(self, stages, comm, n, nbytes, cross):
        t = self.link.tree_time(n, nbytes, cross)
        stages.append((comm, n, t))
        return t

    def _lstage(self, stages, comm, n, nbytes, level):
        """Stage with per-level cost accounting: level 0 = fast intra links,
        level >= 1 = (progressively) slow cross-level hops."""
        t = self.link.level_time(n, nbytes, level)
        stages.append((comm, n, t))
        return t

    # -- one-to-all (Bcast): the root's chain climbs the levels, then every
    #    subtree propagates downward in parallel (Fig. 4, applied per level) --

    def bcast(self, root: int, payload: Any) -> CollectiveResult:
        topo = self.topo
        # one data-plane hop moves the root's payload (a device tensor on
        # torch, identity on sim); the schedule below fans the result out
        payload = self.dataplane.bcast_payload(payload)
        nbytes = payload_nbytes(payload)
        stages: list[tuple[str, int, float]] = []
        data = {root: payload}
        t_total = 0.0
        if topo.n_legions == 1:
            lg = topo.legions[0]
            t_total += self._stage(stages, "world", len(lg), nbytes, cross=False)
            for n in lg.members:
                data[n] = payload
            return CollectiveResult("bcast", t_total, data, stages)
        root_lg = topo.legion_of(root)
        # 1. up-chain: root's local_comm, then the group containing the root
        #    at every level — each hop hands the payload to that comm's
        #    members (the masters of the level below)
        t_total += self._lstage(stages, f"local_{root_lg.index}",
                                len(root_lg), nbytes, level=0)
        for n in root_lg.members:
            data[n] = payload
        chain = [root_lg.index]                 # group index per level
        for level, groups in enumerate(topo.levels(), start=1):
            g = next(g for g in groups if chain[-1] in g.children)
            t_total += self._lstage(stages, topo.comm_name(level, g.index),
                                    len(g.members), nbytes, level=level)
            for m in g.members:
                data[m] = payload
            chain.append(g.index)
        # 2. down-sweep: levels depth-2 .. 1 then the legions — at each level
        #    every group off the root chain broadcasts within itself, all
        #    groups of a level in parallel (max over the level)
        for level in range(topo.depth - 2, 0, -1):
            t_par = 0.0
            for g in topo.groups(level):
                if g.index == chain[level]:
                    continue                     # delivered by the up-chain
                t = self._lstage(stages, topo.comm_name(level, g.index),
                                 len(g.members), nbytes, level=level)
                t_par = max(t_par, t)
                for m in g.members:
                    data[m] = payload
            t_total += t_par
        t_par = 0.0
        for lg in topo.legions:
            if lg.index == root_lg.index or not lg.members:
                continue
            t = self._lstage(stages, f"local_{lg.index}", len(lg), nbytes,
                             level=0)
            t_par = max(t_par, t)
            for n in lg.members:
                data[n] = payload
        return CollectiveResult("bcast", t_total + t_par, data, stages)

    # -- all-to-one (Reduce): reverse propagation, level by level ---------------

    def reduce(self, root: int, contributions: dict[int, Any],
               op: Callable[[Any, Any], Any] = np.add) -> CollectiveResult:
        topo = self.topo
        sample = next(iter(contributions.values()))
        nbytes = payload_nbytes(sample)
        stages: list[tuple[str, int, float]] = []
        if topo.n_legions == 1:
            lg = topo.legions[0]
            t = self._stage(stages, "world", len(lg), nbytes, cross=False)
            total = self.dataplane.reduce(
                [contributions[n] for n in lg.members if n in contributions], op)
            return CollectiveResult("reduce", t, {root: total}, stages)
        # 1. each local_comm reduces to its master — in parallel
        t_total = 0.0
        t_par = 0.0
        partials: dict[int, Any] = {}
        for lg in topo.legions:
            if not lg.members:
                continue
            parts = [contributions[n] for n in lg.members if n in contributions]
            if not parts:
                # whole legion is silent this step (e.g. a just-spliced spare
                # that has not computed yet) — it simply contributes nothing
                continue
            t = self._lstage(stages, f"local_{lg.index}", len(lg), nbytes,
                             level=0)
            t_par = max(t_par, t)
            partials[lg.master] = self.dataplane.reduce(parts, op)
        t_total += t_par
        if not partials:
            # every contributor has left the topology (e.g. the whole
            # verdict of a drain) — surface a clear collective error, not a
            # bare StopIteration from the level walk below
            raise ValueError(
                "reduce: no surviving contributor is present in the "
                f"topology (epoch {getattr(topo, 'epoch', '?')}, "
                f"{len(contributions)} contribution(s) offered)")
        # 2. every level reduces its groups' member partials to the group
        #    master, groups of a level in parallel. The first cross hop
        #    (level 1) rides the slowest relative gap — compression applies
        #    there (sum-compatible ops only); upper hops carry the already-
        #    reduced partials
        for level, groups in enumerate(topo.levels(), start=1):
            t_par = 0.0
            next_partials: dict[int, Any] = {}
            for g in groups:
                contributing = [m for m in g.members if m in partials]
                if not contributing:
                    continue
                gbytes = nbytes
                if level == 1 and self.compression != "none" and op in (np.add,):
                    sent = [self._compress_cross(m, partials[m])
                            for m in contributing]
                    reduced = self.dataplane.reduce([s[0] for s in sent], op)
                    gbytes = max(s[1] for s in sent)
                else:
                    reduced = self.dataplane.reduce(
                        [partials[m] for m in contributing], op)
                t = self._lstage(stages, topo.comm_name(level, g.index),
                                 len(contributing), gbytes, level=level)
                t_par = max(t_par, t)
                next_partials[g.master] = reduced
            t_total += t_par
            partials = next_partials
        total = next(iter(partials.values()))
        # 3. if the root is not its legion's master, one intra hop delivers it
        root_lg = topo.legion_of(root)
        if root != root_lg.master:
            t_total += self._lstage(stages, f"local_{root_lg.index}", 2,
                                    nbytes, level=0)
        return CollectiveResult("reduce", t_total, {root: total}, stages)

    # -- all-to-all (AllReduce) = all-to-one + one-to-all (paper §V) -----------

    def allreduce(self, contributions: dict[int, Any],
                  op: Callable[[Any, Any], Any] = np.add) -> CollectiveResult:
        topo = self.topo
        root = topo.masters[0] if topo.masters else topo.nodes[0]
        red = self.reduce(root, contributions, op)
        bc = self.bcast(root, red.data[root])
        return CollectiveResult(
            "allreduce", red.sim_seconds + bc.sim_seconds, bc.data,
            red.stages + bc.stages)

    # -- barrier: an allreduce of zero-byte tokens ------------------------------

    def barrier(self) -> CollectiveResult:
        token = self.dataplane.asarray(np.zeros((1,), np.int8))
        contributions = {n: token for n in self.topo.nodes}
        res = self.allreduce(contributions, np.maximum)
        return CollectiveResult("barrier", res.sim_seconds,
                                {n: token for n in self.topo.nodes}, res.stages)

    # -- comm-creator: must run on the ENTIRE communicator (paper §V) -----------

    def comm_create(self) -> CollectiveResult:
        n = self.topo.size
        stages: list[tuple[str, int, float]] = []
        t = self._stage(stages, "world", n, 64, cross=True)
        return CollectiveResult("comm_creator", t, {}, stages)

    # -- file / local ops: bounded to the local_comm (no propagation) -----------

    def file_op(self, node: int, nbytes: int) -> CollectiveResult:
        lg = self.topo.legion_of(node)
        stages: list[tuple[str, int, float]] = []
        t = self._stage(stages, f"local_{lg.index}", len(lg), 0, cross=False)
        return CollectiveResult("file", t, {}, stages)

    def local_op(self, node: int) -> CollectiveResult:
        return CollectiveResult("local_only", 0.0, {}, [])



def _tree_reduce(parts: list, op) -> Any:
    """Sequential fold — the sim data plane's reduction (kept as a module
    helper for direct callers; the schedules go through the seam)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc


def flat_collective_time(link: LinkModel, op: str, n: int, nbytes: int) -> float:
    """Baseline (non-hierarchical) time: one binomial tree over everyone,
    crossing slow links (a flat communicator cannot confine traffic)."""
    if op == ALL_TO_ALL:
        return 2.0 * link.tree_time(n, nbytes, cross=True)
    return link.tree_time(n, nbytes, cross=True)


def agreement_time(link: LinkModel, n: int) -> float:
    """Cost of the post-collective fault agreement (BNP fix): one zero-byte
    allreduce over n participants — Legio's per-call overhead."""
    return 2.0 * link.tree_time(n, 8, cross=True)
