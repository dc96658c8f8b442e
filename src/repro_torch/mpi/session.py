"""Session — init/finalize lifecycle for the transparent MPI facade.

A :class:`Session` owns (or adopts) one :class:`~repro_torch.core.executor.
VirtualCluster` and hands out :class:`~repro_torch.mpi.comm.Comm` objects — the
*only* API an application needs. The paper's "zero integration effort"
claim is this module's contract: an app writes an ordinary MPI-shaped loop
(``advance`` the fault-injection clock, compute, call collectives/p2p on a
comm) and every ULFM-analogue mechanism — detection, agreement, strategy
dispatch, topology repair, spare splicing — happens behind the calls.

Step boundaries (``boundary``/``deliver``/``inject``) are the executor's
phase-0 polls packaged once: elastic spare delivery, warmed-up substitute
re-expansion, ground-truth fault arrival, and the sim-clock tick. The
training executor, the serve engine, and standalone facade apps all drive
the same primitives, so their fault behavior cannot drift apart.

Sessions also run the facade-level fault listener: whenever the pipeline
applies a terminal repair, every registered comm's message ledger discards
the in-flight envelopes addressed to the dead nodes (fault-aware
point-to-point reparation — nothing waits on a recv that can never post).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

from repro_torch.core.executor import VirtualCluster
from repro_torch.core.types import (
    FaultEvent,
    FaultSource,
    RecoveryAction,
    RepairReport,
    RepairScope,
)
from repro_torch.mpi.comm import Comm
from repro_torch.mpi.errors import MPISessionError

_ADOPTED_ATTR = "_mpi_session"


@dataclass(frozen=True)
class BoundaryReport:
    """What one step boundary did (the executor's phase 0, surfaced)."""

    step: int
    respawned: tuple[int, ...] = ()                 # provisioner deliveries
    expansions: tuple[RepairReport, ...] = ()       # non-blocking splices
    actions: tuple[RecoveryAction, ...] = ()        # INJECTED-channel drains
    injected: tuple[int, ...] = ()                  # ground-truth arrivals
    reconciled: tuple[RepairScope, ...] = ()        # overlap windows merged

    @property
    def expanded(self) -> tuple[tuple[int, int], ...]:
        """(failed, spare) pairs spliced at this boundary."""
        return tuple(s for r in self.expansions for s in r.substitutions)


class Session:
    """MPI_Init/MPI_Finalize analogue over the Legio runtime."""

    def __init__(self, nodes: "int | VirtualCluster", **cluster_kwargs):
        """``Session(16, policy=..., injector=..., device=...)`` builds a
        fresh VirtualCluster (``device`` is the torch data plane's, "cuda"
        by default; "cpu" runs the plane's plain versions on the host);
        ``Session(cluster)`` adopts an existing one (the executor/serve
        integration path — see :meth:`adopt`)."""
        if isinstance(nodes, VirtualCluster):
            if cluster_kwargs:
                raise TypeError(
                    "cluster kwargs only apply when Session builds the "
                    "cluster; adopt an existing one without them")
            self.cluster = nodes
        else:
            self.cluster = VirtualCluster(nodes, **cluster_kwargs)
        self._comms: list[Comm] = []
        self._actions: list[RecoveryAction] = []
        self._finalized = False
        self._step = 0
        setattr(self.cluster, _ADOPTED_ATTR, self)
        self.cluster.pipeline.add_listener(self._on_terminal_action)
        self.world = Comm(self, None, name="world")

    @classmethod
    def adopt(cls, cluster: VirtualCluster) -> "Session":
        """The session bound to ``cluster`` — created on first use, shared
        thereafter (executor and serve engine on one cluster must share the
        pipeline bookkeeping, not duplicate it)."""
        existing = getattr(cluster, _ADOPTED_ATTR, None)
        if isinstance(existing, Session) and existing.cluster is cluster:
            return existing
        return cls(cluster)

    # -- lifecycle -------------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return not self._finalized

    def ensure_active(self) -> None:
        if self._finalized:
            raise MPISessionError(
                "session is finalized — no MPI call may follow "
                "MPI_Finalize")

    def finalize(self) -> None:
        """Idempotent MPI_Finalize: freeze the facade surface. The cluster
        itself stays readable (reports, metrics, topology post-mortems)."""
        self._finalized = True

    def __enter__(self) -> "Session":
        self.ensure_active()
        return self

    def __exit__(self, *exc) -> None:
        self.finalize()

    # -- step clock ------------------------------------------------------------

    @property
    def step(self) -> int:
        return self._step

    def deliver(self, step: int | None = None) -> BoundaryReport:
        """Boundary half 1: background repair windows the clock has passed
        reconcile (membership merges back — the deferred half of
        revoke-then-repair, always with zero residual here), then elastic
        re-spawned spares arrive and warmed-up non-blocking substitutes
        rejoin. (The serve engine runs this before dispatch and
        :meth:`inject` after — faults land mid-flight.)"""
        self.ensure_active()
        step = self._begin(step)
        cl = self.cluster
        reconciled = tuple(br.scope for br in cl.reconcile_repairs())
        respawned = cl.poll_provisioner(step)
        replicator = getattr(cl, "replicator", None)
        if replicator is not None:
            # settle in-flight replica pushes and re-home replicas whose
            # buddies changed — BEFORE the splices poll, so a replica that
            # arrived during the warmup window serves this boundary's
            # restores in O(shard)
            replicator.tick(cl.topo, cl.failed, step)
        expansions = cl.poll_substitutions(step)
        return BoundaryReport(step=step, respawned=tuple(respawned),
                              expansions=tuple(expansions),
                              reconciled=reconciled)

    def sync(self) -> tuple[RepairScope, ...]:
        """Force-finish every in-flight background repair window *now*,
        charging the unhidden remainder as residual wait — the explicit
        synchronization point (``Comm.barrier`` calls this; so does any
        rooted op whose root is busy repairing). Returns the merged
        scopes; a no-op when nothing is in flight."""
        self.ensure_active()
        return tuple(br.scope
                     for br in self.cluster.reconcile_repairs(force=True))

    def inject(self, step: int | None = None, *,
               charge: bool = True) -> tuple[int, ...]:
        """Boundary half 2: ground-truth faults due this step land and the
        sim clock ticks (what keeps the heartbeat channel live)."""
        self.ensure_active()
        step = self._step if step is None else step
        self._step = step
        events = self.cluster.inject(step)
        if charge:
            self.cluster.clock.charge(self.cluster.policy.step_sim_seconds)
        return tuple(e.node for e in events)

    def boundary(self, step: int | None = None, *,
                 observe_injected: bool = False,
                 charge: bool = True) -> BoundaryReport:
        """One full step boundary: deliver, then inject. With
        ``observe_injected`` the arrivals also feed the pipeline's INJECTED
        channel and drain immediately (the trainer's ground-truth path — a
        sim stand-in for fault notification arriving before any call)."""
        rep = self.deliver(step)
        injected = self.inject(rep.step, charge=charge)
        actions: tuple[RecoveryAction, ...] = ()
        if observe_injected:
            observed = {n for n in injected if n in self.cluster.topo.nodes}
            if observed:
                self.cluster.pipeline.observe(FaultEvent(
                    nodes=tuple(sorted(observed)), step=rep.step,
                    source=FaultSource.INJECTED))
            actions = tuple(self.cluster.pipeline.drain(
                rep.step, sources=(FaultSource.INJECTED,)))
        return BoundaryReport(step=rep.step, respawned=rep.respawned,
                              expansions=rep.expansions, actions=actions,
                              injected=injected, reconciled=rep.reconciled)

    def advance(self, step: int | None = None) -> BoundaryReport:
        """The standalone app's step tick: run the boundary at ``step``
        (default: one past the previous tick), beat every live node's
        heartbeat, and move the internal clock. A plain loop of
        ``advance() ; comm.<op>(...)`` is a complete resilient program."""
        rep = self.boundary(step)
        self.heartbeat()
        self._step = rep.step + 1
        return rep

    def _begin(self, step: int | None) -> int:
        """Start bookkeeping for a step: resolve the step index and clear
        the per-step action buffer consumers drain via take_actions()."""
        step = self._step if step is None else step
        self._step = step
        self._actions.clear()
        return step

    # -- data plane ------------------------------------------------------------

    @property
    def data_plane(self) -> str:
        """Which backend moves collective payloads ("torch" | "sim") — set
        via ``LegioPolicy.data_plane``, resolved by the cluster."""
        return self.cluster.dataplane.name

    def register_sharded_state(self, name: str,
                               getter: Callable[[], object],
                               setter: Callable[[object], None] | None = None
                               ) -> None:
        """Register live state (a pytree getter/setter pair) for
        post-repair redistribution: bookkeeping on one rank and on the sim
        plane; over a process group the torch plane reshards it after every
        repair onto the survivors' ``DeviceMesh`` by ``param_specs`` (the
        trainer's params and AdamW moments ride this). Facade passthrough
        to the cluster — applications never touch the data plane
        directly."""
        self.cluster.register_sharded_state(name, getter, setter)

    # -- fault plumbing shared by every comm ------------------------------------

    def heartbeat(self) -> None:
        """Beat every live node (liveness is not throughput — idle nodes
        beat too)."""
        cl = self.cluster
        for n in cl.live_nodes:
            cl.detector.beat(n, cl.clock.sim_seconds)

    def poll(self, sources: Iterable[FaultSource],
             gate: Callable[[set[int]], None] | None = None
             ) -> list[RecoveryAction]:
        """Drain the given pipeline channels outside any call — the
        executor's straggler sweep and the no-collective heartbeat check."""
        self.ensure_active()
        actions = self.cluster.pipeline.drain(self._step, sources=sources,
                                              gate=gate)
        self._record(actions)
        return actions

    def _record(self, actions: Iterable[RecoveryAction]) -> None:
        self._actions.extend(actions)

    def take_actions(self) -> tuple[RecoveryAction, ...]:
        """Every terminal action recorded since the last boundary/take —
        what the step/round reports surface to the application."""
        out = tuple(self._actions)
        self._actions.clear()
        return out

    def _register(self, comm: Comm) -> None:
        self._comms.append(comm)

    def _unregister(self, comm: Comm) -> None:
        if comm in self._comms:
            self._comms.remove(comm)

    def _on_terminal_action(self, action: RecoveryAction) -> None:
        """Pipeline listener: a repair landed — discard every in-flight
        envelope addressed to the verdict (their recvs can never post)."""
        dead = set(action.verdict)
        for comm in self._comms:
            comm.ledger.discard_to(dead, self._step)

    def __repr__(self) -> str:
        state = "finalized" if self._finalized else "active"
        return (f"Session({state}, step={self._step}, "
                f"nodes={self.cluster.topo.size}, "
                f"comms={len(self._comms)})")
