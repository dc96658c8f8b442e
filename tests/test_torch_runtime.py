"""The port's Legio runtime vs the JAX package's, on the CPU.

The JAX package cannot build a ``VirtualCluster`` at HEAD: its data-plane
module ``repro.dist.dataplane`` was never committed. The ``reference``
fixture puts a stand-in into ``sys.modules`` for the length of one test
(never at import time, so the JAX package's own tests fail or pass exactly
as without this file). The stand-in follows the sim contract of
``docs/dataplane.md``: ``reduce`` is the sequential ``op`` fold, bcast and
gather are the identity, ``compress`` is the numpy twins' round trip,
``register_state`` is a no-op and ``reshard_registered`` returns ``None``.

Both packages then run the same seeded fault campaigns through their
``LegioExecutor`` and ``Session``/``Comm`` facades, and everything the
control plane decides must be byte-identical: topology fingerprints and
masters after every step, every ``CollectiveResult``'s stages and
``sim_seconds``, repair reports, recovery actions, clocks and ledger
counts (measured wall seconds excepted). The port runs with
``data_plane="sim"`` for the control-plane cases and with the torch plane on
the CPU (``device="cpu"``, the kernels' plain versions) for the payload
cases, where results must equal the reference's bytes for random f32
payloads too, with and without int8 / top-k compression.
"""
import dataclasses
import enum
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.mpi as RM  # noqa: E402
from repro.optim import compression as RC  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.mpi as PM  # noqa: E402
from repro_torch.dist import dataplane as PD  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VOLATILE = {"wall_seconds", "stage_seconds"}   # measured host time, not decided


# ---------------------------------------------------------------------------
# the reference harness
# ---------------------------------------------------------------------------

class _StandInSimPlane:
    """The sim contract of docs/dataplane.md, over the JAX package's numpy twins."""

    name = "sim"

    def reduce(self, parts, op):
        acc = parts[0]
        for p in parts[1:]:
            acc = op(acc, p)
        return acc

    def bcast_payload(self, payload):
        return payload

    def gather_arrays(self, values):
        return list(values)

    def compress(self, g, scheme, fraction):
        if scheme == "int8":
            return RC.decompress_int8_np(RC.compress_int8_np(g))
        return RC.decompress_topk_np(RC.compress_topk_np(g, fraction), g.shape)

    def register_state(self, name, getter, setter=None):
        pass

    def reshard_registered(self, view):
        return None


def _stand_in_module() -> types.ModuleType:
    mod = types.ModuleType("repro.dist.dataplane")
    shared = _StandInSimPlane()

    def make_dataplane(policy):
        if policy.data_plane != "sim":
            raise ValueError(f"the stand-in has only the sim plane, not {policy.data_plane!r}")
        return _StandInSimPlane()

    mod.SimDataPlane = _StandInSimPlane
    mod.make_dataplane = make_dataplane
    mod.default_dataplane = lambda: shared
    return mod


@pytest.fixture
def reference(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.dist.dataplane", _stand_in_module())


REF = types.SimpleNamespace(core=R, mpi=RM, policy_extra={}, cluster_extra={},
                            to_payload=lambda a: a)
PORT_SIM = types.SimpleNamespace(core=P, mpi=PM, policy_extra={"data_plane": "sim"},
                                 cluster_extra={}, to_payload=lambda a: a)
PORT_TORCH = types.SimpleNamespace(core=P, mpi=PM, policy_extra={"data_plane": "torch"},
                                   cluster_extra={"device": "cpu"},
                                   to_payload=lambda a: torch.from_numpy(np.array(a)))


def norm(x):
    """A comparable, package-free image of a runtime record."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple((f.name, norm(getattr(x, f.name)))
                                        for f in dataclasses.fields(x)
                                        if f.name not in VOLATILE))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, dict):
        return ("dict", tuple(sorted((repr(norm(k)), norm(v)) for k, v in x.items())))
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if isinstance(x, torch.Tensor):
        return norm(x.cpu().numpy())
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        return ("array", a.dtype.str, a.shape, a.tobytes())
    return x


def topo_fingerprint(cl):
    return (tuple(cl.topo.nodes), tuple(cl.topo.masters),
            tuple(sorted((lg.index, tuple(sorted(lg.members)))
                         for lg in cl.topo.legions if lg.members)),
            tuple(sorted(cl.topo.home.items())), cl.topo.epoch)


def clock_state(cl):
    c = cl.clock
    return (c.sim_seconds, c.hidden_seconds, c.residual_seconds)


def assert_traces_equal(a, b, what):
    assert len(a) == len(b), f"{what}: {len(a)} records vs {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, f"{what}: record {i} differs:\n{x}\n!=\n{y}"


def one_terminal_action_per_fault(actions, faults, topo_nodes_ever):
    for _, victim in faults:
        if victim not in topo_nodes_ever:
            continue
        hits = [a for a in actions if victim in a.verdict and a.terminal]
        assert len(hits) <= 1, f"node {victim}: {len(hits)} terminal actions"


# ---------------------------------------------------------------------------
# campaigns (the cases of tests/test_executor.py, test_mpi.py,
# test_dataplane.py, test_overlap.py, test_substitute.py, test_hierarchy*.py)
# ---------------------------------------------------------------------------

EXECUTOR_CASES = {
    "fault_free": dict(n=16, policy=dict(legion_size=4), faults=[], steps=4),
    "worker_fault": dict(n=16, policy=dict(legion_size=4), faults=[(2, 5)], steps=5),
    "master_fault": dict(n=16, policy=dict(legion_size=4), faults=[(1, 0)], steps=4),
    "root_stop": dict(n=8, policy=dict(root_failure_policy="stop"), faults=[(1, 0)],
                      steps=3, final="reduce"),
    "root_ignore": dict(n=8, policy=dict(root_failure_policy="ignore"), faults=[(1, 0)],
                        steps=3, final="reduce"),
    "bcast_final": dict(n=12, policy=dict(legion_size=4), faults=[(1, 7)], steps=3,
                        final="bcast", root=2),
    "heartbeat_only": dict(n=12, policy=dict(legion_size=4), faults=[(1, 5)], steps=5,
                           final="none"),
    "rebalance": dict(n=8, policy=dict(batch_policy="rebalance"), faults=[(1, 3)],
                      steps=3, shards=2),
    "drop": dict(n=8, policy=dict(batch_policy="drop"), faults=[(1, 3)], steps=3),
    "elastic_spares": dict(n=8, policy=dict(spare_nodes=2), faults=[(1, 2)], steps=4),
    "cascading": dict(n=8, policy=dict(), faults=[(i, i) for i in range(6)], steps=7),
    "substitute": dict(n=16, policy=dict(legion_size=4, recovery_mode="substitute",
                                         spare_nodes=2), faults=[(2, 9), (4, 0)], steps=6),
    "substitute_then_shrink": dict(n=16, policy=dict(legion_size=4,
                                                     recovery_mode="substitute_then_shrink",
                                                     spare_fraction=0.5),
                                   faults=[(1, 5), (2, 6), (3, 12)], steps=7),
    "overlap": dict(n=20, policy=dict(legion_size=4, repair_overlap=True),
                    faults=[(2, 9), (3, 0), (4, 13)], steps=8),
    "overlap_nonblocking": dict(n=20, policy=dict(legion_size=4, repair_overlap=True,
                                                  recovery_mode="substitute_then_shrink",
                                                  spare_fraction=0.5),
                                faults=[(2, 4), (3, 17)], steps=8),
    "depth3": dict(n=64, policy=dict(legion_size=4, hierarchy_depth=3),
                   faults=[(1, 20), (3, 0), (3, 33)], steps=5),
    "elastic_refill": dict(n=16, policy=dict(legion_size=4, recovery_mode="substitute_then_shrink",
                                             spare_nodes=1, spare_refill_watermark=1,
                                             spare_provision_delay_steps=1),
                           faults=[(1, 3), (2, 7), (3, 11)], steps=7),
}


def work(node, shard, step):
    """Integer-exact per-shard output, so every fold is exact."""
    return np.array([node + 1.0, shard, step % 3, 1.0], np.float32)


def run_executor(pkg, case):
    cl = pkg.core.VirtualCluster(
        case["n"], policy=pkg.core.LegioPolicy(**case["policy"], **pkg.policy_extra),
        injector=pkg.core.FaultInjector.at(case["faults"]),
        shards_per_node=case.get("shards", 1), **pkg.cluster_extra)
    ex = pkg.core.LegioExecutor(
        cl, lambda n, s, t: pkg.to_payload(work(n, s, t)),
        final_collective=case.get("final", "allreduce"), root=case.get("root", 0))
    trace, actions, ever = [], [], set(cl.topo.nodes)
    for step in range(case["steps"]):
        try:
            rep = ex.run_step(step)
        except pkg.core.RootFailedError as exc:
            trace.append(("RootFailedError", str(exc)))
            break
        actions.extend(rep.actions)
        ever |= set(cl.topo.nodes)
        trace.append((norm(rep), topo_fingerprint(cl), clock_state(cl),
                      norm(cl.plan), norm(cl.pending), norm(cl.backlog)))
    trace.append(("repairs", norm(cl.repairs)))
    one_terminal_action_per_fault(actions, case["faults"], ever)
    return trace


@pytest.mark.parametrize("case", list(EXECUTOR_CASES))
def test_executor_campaign_parity(reference, case):
    """LegioExecutor: step reports, topology, clock, shard plan and repair
    log byte-identical to the JAX package's over the whole campaign."""
    c = EXECUTOR_CASES[case]
    assert_traces_equal(run_executor(REF, c), run_executor(PORT_SIM, c), case)


SESSION_CASES = {
    "shrink": dict(n=16, policy=dict(recovery_mode="shrink"), faults=[(2, 9), (4, 0)]),
    "substitute": dict(n=16, policy=dict(recovery_mode="substitute", spare_nodes=2),
                       faults=[(2, 9), (4, 0)]),
    "overlap": dict(n=16, policy=dict(recovery_mode="shrink", repair_overlap=True),
                    faults=[(2, 9), (4, 0)]),
    "substitute_then_shrink": dict(n=16, policy=dict(recovery_mode="substitute_then_shrink",
                                                     spare_fraction=0.25),
                                   faults=[(1, 5), (3, 6), (3, 13)]),
    "transparent_mpi": dict(n=16, policy=dict(), faults=[(2, 9), (5, 4), (7, 11)]),
    "depth3": dict(n=32, policy=dict(hierarchy_depth=3), faults=[(1, 20), (3, 0)]),
}


def integer_payload(node, step):
    return (np.arange(8, dtype=np.float32) % 5.0) * np.float32(node + 1) + np.float32(step)


def random_payload(node, step, width=37):
    rng = np.random.default_rng(1000 * step + node)
    return (rng.standard_normal(width) * 1e-3).astype(np.float32)


def run_session(pkg, case, payload, steps=7, compression="none"):
    """The Session/Comm loop of an MPI program: allreduce, bcast, reduce,
    barrier, gather and a p2p ring each step; returns the trace and the
    final (sums, size, ring tokens delivered)."""
    sess = pkg.mpi.Session(
        case["n"], policy=pkg.core.LegioPolicy(legion_size=4, grad_compression=compression,
                                               **case["policy"], **pkg.policy_extra),
        injector=pkg.core.FaultInjector.at(case["faults"]), **pkg.cluster_extra)
    comm, cl = sess.world, sess.cluster
    trace, ever, actions = [], set(cl.topo.nodes), []

    def call(fn, *args, **kw):
        try:
            return norm(fn(*args, **kw))
        except pkg.mpi.PeerFailedError as exc:
            return ("PeerFailedError", exc.op, exc.peers)

    for step in range(steps):
        rep = sess.advance(step)
        live = [m for m in comm.members if m not in cl.failed]
        contrib = {m: pkg.to_payload(payload(m, step)) for m in live}
        rec = [norm(rep), call(comm.allreduce, contrib)]
        root = comm.members[0]
        rec.append(call(comm.bcast, pkg.to_payload(payload(root, step + 50)), root=root))
        rec.append(call(comm.reduce, contrib, root=comm.members[-1]))
        if step % 2:
            rec.append(call(comm.barrier))
        rec.append(call(comm.gather, {m: pkg.to_payload(payload(m, 99)) for m in live[:5]},
                        among=live[:5]))
        ring = [m for m in comm.members if m not in cl.failed]
        for i, m in enumerate(ring):
            comm.send(m, ring[(i + 1) % len(ring)], ("token", step, m))
        got = sum(comm.recv(m, ring[i - 1])[0] == "token" for i, m in enumerate(ring))
        actions.extend(sess.take_actions())
        ever |= set(cl.topo.nodes)
        led = comm.ledger
        rec += [got, topo_fingerprint(cl), clock_state(cl), norm(comm.stats),
                (led.posted, led.delivered, led.discarded, led.pending, led.conserved()),
                norm(cl.repairs), sorted((m, norm(r)) for m, r in cl.compress_residuals.items())]
        trace.append(tuple(rec))
    one_terminal_action_per_fault(actions, case["faults"], ever)
    return trace, comm.size


@pytest.mark.parametrize("case", list(SESSION_CASES))
def test_session_campaign_parity(reference, case):
    """Session/Comm: every call's result (stages, sim_seconds, payload
    bytes), repair, clock and ledger count byte-identical to the JAX
    package's, integer-exact payloads, port on the sim plane."""
    c = SESSION_CASES[case]
    ref, ref_size = run_session(REF, c, integer_payload)
    port, port_size = run_session(PORT_SIM, c, integer_payload)
    assert ref_size == port_size
    assert_traces_equal(ref, port, case)


@pytest.mark.parametrize("payload", ["integer", "random_f32"])
@pytest.mark.parametrize("case", ["shrink", "substitute", "overlap", "depth3"])
def test_torch_plane_matches_reference(reference, case, payload):
    """The torch plane (CPU tensors) folds in the schedule's order, so its
    results equal the reference sim contract's byte for byte on any f32
    payload, not only integer-exact ones."""
    fn = integer_payload if payload == "integer" else random_payload
    c = SESSION_CASES[case]
    ref, ref_size = run_session(REF, c, fn)
    port, port_size = run_session(PORT_TORCH, c, fn)
    assert ref_size == port_size
    assert_traces_equal(ref, port, f"{case} {payload}")


@pytest.mark.parametrize("compression", ["int8", "topk"])
@pytest.mark.parametrize("case", ["shrink", "transparent_mpi", "overlap"])
def test_compressed_campaign_matches_reference(reference, case, compression):
    """Compressed cross-legion hop over several steps (the residuals carry):
    results, wire-byte accounting (the stages) and every master's residual
    byte-identical, random f32 payloads, on both of the port's planes."""
    c = SESSION_CASES[case]
    ref, _ = run_session(REF, c, random_payload, steps=6, compression=compression)
    for pkg in (PORT_SIM, PORT_TORCH):
        port, _ = run_session(pkg, c, random_payload, steps=6, compression=compression)
        assert_traces_equal(ref, port, f"{case} {compression} {pkg.policy_extra}")


def transparent_mpi(pkg):
    """examples/transparent_mpi.py's loop: 16 ranks, legions of 4, faults at
    (2, 9), (5, 4) and (7, 11), node 4 a legion master."""
    session = pkg.mpi.Session(16, policy=pkg.core.LegioPolicy(legion_size=4, **pkg.policy_extra),
                              injector=pkg.core.FaultInjector.at([(2, 9), (5, 4), (7, 11)]),
                              **pkg.cluster_extra)
    comm = session.world
    sums = []
    for step in range(10):
        session.advance(step)
        contributions = {rank: pkg.to_payload(np.array([float(rank + 1), 1.0]))
                         for rank in session.cluster.live_nodes}
        res = comm.allreduce(contributions)
        sums.append(norm(res.data[comm.members[0]]))
    members = comm.members
    for i, rank in enumerate(members):
        comm.send(rank, members[(i + 1) % len(members)], f"token-from-{rank}")
    handed = sum(comm.probe(rank, members[i - 1])
                 and comm.recv(rank, members[i - 1]).startswith("token")
                 for i, rank in enumerate(members))
    return sums, comm.size, handed, members, comm.ledger.conserved()


def test_transparent_mpi_loop(reference):
    ref = transparent_mpi(REF)
    assert ref[1] == 13 and ref[2] == 13
    assert transparent_mpi(PORT_SIM) == ref
    assert transparent_mpi(PORT_TORCH) == ref


# ---------------------------------------------------------------------------
# the data plane itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", [np.add, np.maximum, np.minimum], ids=lambda o: o.__name__)
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int8])
def test_plane_reduce_matches_numpy_fold(op, dtype):
    rng = np.random.default_rng(7)
    parts = [(rng.standard_normal(41) * 50).astype(dtype) for _ in range(6)]
    want = _StandInSimPlane().reduce([p.copy() for p in parts], op)
    got = PD.TorchDataPlane("cpu").reduce([torch.from_numpy(p.copy()) for p in parts], op)
    sim = PD.SimDataPlane().reduce([p.copy() for p in parts], op)
    assert got.numpy().dtype == want.dtype
    assert got.numpy().tobytes() == want.tobytes() == sim.tobytes()


def test_plane_folds_in_the_schedules_order():
    """Random f32 parts: the order of the adds decides the last bits; the
    plane must add them in the order the schedule passes them."""
    rng = np.random.default_rng(3)
    parts = [rng.standard_normal(4096).astype(np.float32) for _ in range(15)]
    got = PD.TorchDataPlane("cpu").reduce([torch.from_numpy(p) for p in parts], np.add)
    want = _StandInSimPlane().reduce(parts, np.add)
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_plane_compress_matches_stand_in(scheme):
    for shape, seed in [((4,), 0), ((130,), 1), ((64, 257), 2), ((1000,), 3)]:
        g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
        want = _StandInSimPlane().compress(g, scheme, 0.05)
        got = PD.TorchDataPlane("cpu").compress(torch.from_numpy(g), scheme, 0.05)
        assert got.shape == want.shape
        assert got.numpy().tobytes() == want.tobytes()
        assert PD.SimDataPlane().compress(g, scheme, 0.05).tobytes() == want.tobytes()


def test_plane_bcast_gather_and_asarray():
    plane = PD.TorchDataPlane("cpu")
    x = torch.arange(5, dtype=torch.float32)
    assert plane.bcast_payload(x) is x
    assert all(a is b for a, b in zip(plane.gather_arrays([x, x]), [x, x]))
    assert plane.asarray(np.ones(3, np.int8)).dtype == torch.int8
    assert plane.reshard_registered(None) is None
    plane.register_state("params", lambda: x)
    assert "params" in plane.registered


def test_torch_plane_raises_on_unsupported_op():
    """A callable that is not a predefined MPI reduction raises, naming itself."""
    for op in (np.subtract, lambda a, b: a + b):
        plane = PD.TorchDataPlane("cpu")
        with pytest.raises(ValueError, match=op.__name__):
            plane.reduce([torch.ones(3), torch.ones(3)], op)
        sess = PM.Session(8, policy=P.LegioPolicy(legion_size=4), device="cpu")
        with pytest.raises(ValueError, match=op.__name__):
            sess.world.allreduce({m: torch.ones(2) for m in sess.world.members}, op)


# the predefined MPI reductions beyond add, maximum and minimum
MPI_OPS = [np.multiply, np.logical_and, np.logical_or, np.logical_xor, np.bitwise_and,
           np.bitwise_or, np.bitwise_xor]


def op_payload(node, step):
    """Small int32 values with zeros among them (the logical ops' False)."""
    return np.random.default_rng(100 * step + node).integers(-3, 4, 8).astype(np.int32)


def run_op_session(pkg, op, steps=5):
    """``Session(8)`` through a shrink (a member at step 2, a master at
    step 3): each step an allreduce and a reduce with ``op`` of every live
    member's payload, and an allreduce of one member's alone."""
    sess = pkg.mpi.Session(8, policy=pkg.core.LegioPolicy(legion_size=4, **pkg.policy_extra),
                           injector=pkg.core.FaultInjector.at([(2, 5), (3, 0)]),
                           **pkg.cluster_extra)
    comm, cl = sess.world, sess.cluster
    trace = []
    for step in range(steps):
        rep = sess.advance(step)
        live = [m for m in comm.members if m not in cl.failed]
        contrib = {m: pkg.to_payload(op_payload(m, step)) for m in live}
        trace.append((norm(rep), norm(comm.allreduce(contrib, op)),
                      norm(comm.reduce(contrib, root=comm.members[-1], op=op)),
                      norm(comm.allreduce({live[0]: contrib[live[0]]}, op)),
                      topo_fingerprint(cl)))
    return trace


@pytest.mark.parametrize("op", MPI_OPS, ids=lambda o: o.__name__)
def test_torch_plane_mpi_ops_match_reference(reference, op):
    """The torch plane (CPU tensors) against the reference ``Session`` on
    the sim contract: every result byte-equal, dtypes included (``bool``
    where the fold of two or more parts is a logical op's)."""
    ref = run_op_session(REF, op)
    assert_traces_equal(ref, run_op_session(PORT_TORCH, op), op.__name__)
    assert any(r[1] != r[3] for r in ref)


def test_policy_and_plane_selection():
    assert P.LegioPolicy().data_plane == "torch"
    with pytest.raises(ValueError, match="data_plane"):
        P.LegioPolicy(data_plane="jax")
    assert isinstance(PD.make_dataplane(P.LegioPolicy(data_plane="sim")), PD.SimDataPlane)
    assert isinstance(PD.make_dataplane(P.LegioPolicy(), "cpu"), PD.TorchDataPlane)
    auto = PD.make_dataplane(P.LegioPolicy(data_plane="auto"), "cpu")
    assert auto.name == ("torch" if torch.cuda.device_count() > 1 else "sim")
    assert PD.default_dataplane() is PD.default_dataplane()
    assert PM.Session(4, policy=P.LegioPolicy(data_plane="sim")).data_plane == "sim"
    assert PM.Session(4, device="cpu").data_plane == "torch"


def test_default_plane_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default plane is buildable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.Session(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.VirtualCluster(16, policy=P.LegioPolicy(legion_size=4))


def test_torch_plane_keeps_payloads_tensors_and_refuses_other_devices():
    sess = PM.Session(16, policy=P.LegioPolicy(legion_size=4, grad_compression="int8"),
                      device="cpu")
    res = sess.world.allreduce({m: torch.full((6,), m + 0.5) for m in sess.world.members})
    assert all(isinstance(v, torch.Tensor) for v in res.data.values())
    assert all(isinstance(v, torch.Tensor) for v in sess.cluster.compress_residuals.values())
    with pytest.raises(ValueError, match="payload on"):
        PD.TorchDataPlane("cpu").asarray(torch.ones(2, device="meta"))


def test_replica_snapshots_match_reference():
    """The replicator's host snapshots of a state tree (leaf keys, logical
    dtypes incl. the bf16 bit view, checksums, bytes) from torch tensors
    equal the JAX package's from jax arrays of the same values."""
    import jax.numpy as jnp
    from repro.checkpoint.replicate import ShardReplicator as RRep
    from repro.checkpoint.store import _checksum, _flatten, _to_numpy
    from repro_torch.checkpoint import store as PS
    from repro_torch.checkpoint.replicate import ShardReplicator as PRep

    rng = np.random.default_rng(0)
    w, b, e = (rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2,)))
    i = np.arange(3, dtype=np.int32)
    ref_tree = {"b": {"w": jnp.asarray(w), "bf": jnp.asarray(b).astype(jnp.bfloat16)},
                "a": [jnp.asarray(e), jnp.asarray(i)]}
    port_tree = {"b": {"w": torch.from_numpy(w), "bf": torch.from_numpy(b).to(torch.bfloat16)},
                 "a": [torch.from_numpy(e), torch.from_numpy(i)]}
    ref_flat, port_flat = _flatten(ref_tree), PS._flatten(port_tree)
    assert list(ref_flat) == list(port_flat) == ["a/0", "a/1", "b/bf", "b/w"]
    for key in ref_flat:
        (ra, rd), (pa, pd) = _to_numpy(ref_flat[key]), PS._to_numpy(port_flat[key])
        assert (rd, ra.dtype, ra.tobytes()) == (pd, pa.dtype, pa.tobytes())
        assert _checksum(ra) == PS._checksum(pa)
    topo_r = R.make_topology(list(range(16)), R.LegioPolicy(legion_size=4))
    topo_p = P.make_topology(list(range(16)), P.LegioPolicy(legion_size=4))
    rep_r, rep_p = RRep(), PRep()
    posted = rep_r.push_map(3, topo_r, {(0, 1): ref_tree})
    assert posted == 1 == rep_p.push_map(3, topo_p, {(0, 1): port_tree})
    (state_r, served_r), (state_p, served_p) = (rep_r.restore(1, topo_r, set()),
                                                rep_p.restore(1, topo_p, set()))
    assert norm(served_r) == norm(served_p)
    assert norm(state_r) == norm(state_p)


def test_dataplane_module_is_not_ignored_by_git():
    """``.gitignore`` names ``/dist/`` at the root only, so the port's
    ``src/repro_torch/dist/`` package reaches a commit."""
    git = shutil.which("git")
    if git is None or not (ROOT / ".git").exists():
        pytest.skip("no git work tree")
    rc = subprocess.run([git, "check-ignore", "-q", "src/repro_torch/dist/dataplane.py"],
                        cwd=ROOT, timeout=60).returncode
    assert rc == 1
