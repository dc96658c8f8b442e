"""Legio knobs and the optimal-legion-size relations (paper Eq. 1–4).

The paper exposes exactly two knobs (§V): the maximum size of the
local_comms (``k``) and a threshold cluster size above which the
hierarchical organization is used. We add the root-failure policy (§IV:
IGNORE vs STOP) and the batch policy (our DROP/REBALANCE rank-translation
analogue) as first-class settings.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


def optimal_k_linear(s: int) -> int:
    """Eq. 3: s = k(k^2 - 2)/2  ->  k (assumes S(x) linear in x).

    Solves k^3 - 2k - 2s = 0 for the positive real root. The paper's
    Marconi100 runs configure local_comm size with this relation.
    """
    if s <= 2:
        return max(s, 1)
    # Cardano for t^3 + pt + q with p=-2, q=-2s (one real root for s >= 1)
    p, q = -2.0, -2.0 * float(s)
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    root = (-q / 2.0 + math.sqrt(disc)) ** (1.0 / 3.0) \
        - ((q / 2.0 + math.sqrt(disc)) ** (1.0 / 3.0) if (q / 2.0 + math.sqrt(disc)) > 0
           else -(abs(q / 2.0 + math.sqrt(disc)) ** (1.0 / 3.0)))
    k = max(2, round(root))
    # snap to the integer minimizing |s - k(k^2-2)/2|
    best = min((abs(s - kk * (kk * kk - 2) / 2.0), kk) for kk in (k - 1, k, k + 1) if kk >= 2)
    return best[1]


def optimal_k_quadratic(s: int) -> int:
    """Eq. 4: s = sqrt(2 k^2 (2 k^2 - 1) / 3)  ->  k (S(x) quadratic)."""
    if s <= 2:
        return max(s, 1)
    # s^2 = (4k^4 - 2k^2)/3  ->  4k^4 - 2k^2 - 3s^2 = 0
    k2 = (1.0 + math.sqrt(1.0 + 12.0 * float(s) ** 2)) / 4.0
    return max(2, round(math.sqrt(k2)))


def eq3_s_of_k(k: int) -> float:
    return k * (k * k - 2) / 2.0


def eq4_s_of_k(k: int) -> float:
    return math.sqrt(2.0 * k * k * (2.0 * k * k - 1.0) / 3.0)


def optimal_kd(s: int, depth: int) -> int:
    """Generalize Eq. 3/4's optimal-k to the (k, d) pair of the recursive
    N-level topology: with ``depth - 1`` grouping levels of branching
    factor k over s nodes, the levels balance (every comm, legions and
    super-legions alike, has ~k members) at ``k ≈ s^(1/depth)``. For
    depth 2 the paper's Eq. 3 relation is kept verbatim."""
    if depth <= 1:
        return max(s, 1)
    if depth == 2:
        return optimal_k_linear(s)
    if s <= 2:
        return max(s, 1)
    return max(2, round(s ** (1.0 / depth)))


RECOVERY_MODES = ("shrink", "substitute", "substitute_then_shrink",
                  "adaptive")


@dataclass(frozen=True)
class LegioPolicy:
    legion_size: int = 0                # k; 0 = auto via Eq. 3 (paper's setting)
    hierarchical_threshold: int = 12    # paper: hierarchy wins for s > 11 (linear S)
    # levels of the recursive topology including the root comm: 1 = flat,
    # 2 = the paper's legions + global_comm, d >= 3 inserts super-legion
    # levels (masters grouped k at a time) between legions and root.
    # 0 = auto: 2 in the paper's regime, one level deeper every time the
    # master comm itself outgrows hierarchical_threshold (the paper's own
    # rule applied recursively to the comm it creates).
    hierarchy_depth: int = 0
    root_failure_policy: str = "ignore" # ignore | stop (paper §IV)
    batch_policy: str = "drop"          # drop | rebalance
    straggler_threshold: float = 3.0    # x median step latency; 0 disables
    heartbeat_timeout: float = 10.0     # sim seconds
    grad_compression: str = "none"      # none | int8 | topk (cross-legion hop)
    topk_fraction: float = 0.05
    spare_nodes: int = 0                # standby pool for elastic regrow
    # --- substitution recovery (beyond-paper: Ashraf et al. "Shrink or
    # Substitute"): shrink discards capacity, substitute splices a warm
    # spare into the failed node's legion slot. substitute_then_shrink
    # falls back to shrink once the pool is exhausted; bare substitute
    # treats exhaustion as fatal (SparePoolExhausted).
    recovery_mode: str = "shrink"       # shrink | substitute |
                                        # substitute_then_shrink | adaptive
    spare_fraction: float = 0.0         # provision ceil(f * n) warm spares
    # --- adaptive recovery (CostModelStrategy): recovery_mode="adaptive"
    # scores shrink / substitute / nonblocking / restart-from-checkpoint per
    # fault from the engines' cost models plus per-stage pipeline latencies
    # fitted online (EWMA over FaultPipeline.traces, keyed by verdict size)
    # and dispatches the winner. adaptive_ewma_horizon is the EWMA window in
    # drains (alpha = 2/(h+1)); adaptive_horizon_steps amortizes a shrink's
    # lost capacity over the steps the run is expected to keep going.
    adaptive_ewma_horizon: int = 8
    adaptive_horizon_steps: int = 24
    # --- peer-replicated shard checkpoints (checkpoint.replicate): every
    # async checkpoint also pushes each member's host shard to its POV-ring
    # buddy, so a substituted spare warm-starts from the surviving buddy in
    # O(shard) — the store read remains the correlated-loss fallback.
    peer_replication: bool = True
    # non-blocking flavor (Bouteiller & Bosilca): after the fault step,
    # spare_warmup_steps steps run shrunk while the substitute warms up;
    # the topology then re-expands at the next step boundary.
    nonblocking_substitution: bool = False
    spare_warmup_steps: int = 1
    # --- background (overlapped) repair: revoke-then-repair. The structural
    # repair still lands inside the drain, but its clock charge is deferred
    # to a BackgroundRepair window — healthy subtrees keep issuing
    # collectives on their pinned epoch while the torn scope's survivors
    # stay busy (excluded from schedules) until the window's finish_sim
    # passes; membership reconciles at the next Session boundary. Applies
    # to every recovery_mode whose strategy declares overlap_safe.
    repair_overlap: bool = False
    # baseline simulated seconds charged per step — this is what makes the
    # heartbeat channel live: with no collective (final_collective="none")
    # the sim clock still advances, so a silent node eventually crosses
    # heartbeat_timeout and the pipeline's detect stage picks it up.
    step_sim_seconds: float = 1.0
    # --- elastic spare re-spawn (the MPI_Comm_spawn analogue): when the
    # warm pool drains below the watermark, the SpareProvisioner schedules
    # replacement spares that come up after a provisioning delay and feed
    # back through the SparePool. watermark=0 disables the provisioner.
    spare_refill_watermark: int = 0
    spare_provision_delay_steps: int = 2
    spare_churn_cap: int = 0            # max re-spawned spares; 0 = unlimited
    # --- serving (repro_torch.serve): per-node micro-batch size drained from a
    # legion queue each round, and the redelivery ceiling for a request that
    # keeps landing on dying nodes (0 = retry forever; the at-least-once
    # guarantee holds either way — a request that hits the ceiling is parked
    # in ServeMetrics.parked, never silently dropped).
    serve_microbatch: int = 4
    serve_max_attempts: int = 0
    # --- continuous batching (repro_torch.serve, PR 7): per-node in-flight window
    # (micro-batch slots a node works concurrently — admission refills a slot
    # the tick after its batch completes, per legion, independent of other
    # legions' progress or in-flight repairs), SLO-aware admission control
    # ("none" admits everything; "shed" rejects a request at the door when
    # the target legion's backlog already makes its deadline infeasible —
    # recorded in ServeMetrics.shed; "park" records it in .parked instead),
    # and decode-state migration (a request that dies mid-decode keeps its
    # decode progress on redelivery instead of restarting from prefill).
    serve_window: int = 1
    serve_admission: str = "none"        # none | shed | park
    serve_admission_slack: float = 0.0   # extra headroom (sim s) required
    serve_slo_seconds: float = 0.0       # default deadline; 0 = no deadline
    serve_migrate_decode: bool = True
    # --- correlated-failure scenarios (repro_torch.core.faultmodel): knobs the
    # named presets read when generating seeded chaos campaigns.
    chaos_fault_fraction: float = 0.125  # independent: fraction of nodes hit
    chaos_partition_fence: bool = True   # fence the minority side of a split
    chaos_flap_delay_steps: int = 2      # steps between repair-out and return
    chaos_cascade_victims: int = 2       # secondary stragglers per cascade
    chaos_cascade_slowdown: float = 4.0  # latency multiplier on secondaries
    # --- data plane (repro_torch.dist.dataplane): what actually moves the bytes
    # behind the scheduled collectives. "torch" (the default) keeps every
    # payload on the cluster's device as a torch tensor and runs the
    # compression hop through the hand-written kernels on a CUDA device;
    # "sim" is the numpy simulator (sequential fold, numpy compressors),
    # the JAX package's default plane; "auto" picks torch when more than one
    # CUDA device is visible, sim otherwise. The control plane (schedules,
    # stage lists, alpha-beta clock charges) is backend-independent.
    data_plane: str = "torch"            # torch | sim | auto

    def __post_init__(self) -> None:
        if self.hierarchy_depth < 0:
            raise ValueError("hierarchy_depth must be >= 0 (0 = auto)")
        if self.recovery_mode not in RECOVERY_MODES:
            raise ValueError(
                f"recovery_mode must be one of {RECOVERY_MODES}, "
                f"got {self.recovery_mode!r}")
        if self.adaptive_ewma_horizon < 1:
            raise ValueError("adaptive_ewma_horizon must be >= 1")
        if self.adaptive_horizon_steps < 1:
            raise ValueError("adaptive_horizon_steps must be >= 1")
        if self.spare_refill_watermark < 0:
            raise ValueError("spare_refill_watermark must be >= 0")
        if self.spare_provision_delay_steps < 0:
            raise ValueError("spare_provision_delay_steps must be >= 0")
        if self.spare_churn_cap < 0:
            raise ValueError("spare_churn_cap must be >= 0")
        if self.serve_microbatch <= 0:
            raise ValueError("serve_microbatch must be positive")
        if self.serve_max_attempts < 0:
            raise ValueError("serve_max_attempts must be >= 0")
        if self.serve_window < 1:
            raise ValueError("serve_window must be >= 1")
        if self.serve_admission not in ("none", "shed", "park"):
            raise ValueError(
                "serve_admission must be one of ('none', 'shed', 'park'), "
                f"got {self.serve_admission!r}")
        if self.serve_admission_slack < 0:
            raise ValueError("serve_admission_slack must be >= 0")
        if self.serve_slo_seconds < 0:
            raise ValueError("serve_slo_seconds must be >= 0")
        if not 0.0 <= self.chaos_fault_fraction <= 1.0:
            raise ValueError("chaos_fault_fraction must be in [0, 1]")
        if self.chaos_flap_delay_steps < 1:
            raise ValueError("chaos_flap_delay_steps must be >= 1")
        if self.chaos_cascade_victims < 0:
            raise ValueError("chaos_cascade_victims must be >= 0")
        if self.chaos_cascade_slowdown <= 0:
            raise ValueError("chaos_cascade_slowdown must be positive")
        if self.data_plane not in ("sim", "torch", "auto"):
            raise ValueError(
                "data_plane must be one of ('sim', 'torch', 'auto'), "
                f"got {self.data_plane!r}")

    def choose_k(self, s: int) -> int:
        if self.legion_size > 0:
            return min(self.legion_size, s)
        return min(optimal_k_linear(s), s)

    def choose_depth(self, s: int) -> int:
        """How many levels the topology gets for an s-node cluster. Explicit
        ``hierarchy_depth`` wins; auto applies the paper's threshold rule
        recursively — whenever the comm of masters a level creates is itself
        big enough that hierarchy would win inside it, add a level."""
        if self.hierarchy_depth > 0:
            return self.hierarchy_depth if s > 1 else 1
        if not self.use_hierarchical(s):
            return 1
        k = max(self.choose_k(s), 2)
        depth, top = 2, math.ceil(s / k)
        while top > self.hierarchical_threshold:
            nxt = math.ceil(top / k)
            if nxt <= 1:
                break
            depth, top = depth + 1, nxt
        return depth

    def choose_kd(self, s: int) -> tuple[int, int]:
        """The (legion size, depth) pair the topology builder uses —
        Eq. 3's optimal-k generalized to the recursive layout. With an
        explicit ``legion_size`` the depth adapts around it; with both
        knobs on auto, depth is chosen first and k balances the levels
        (``optimal_kd``)."""
        depth = self.choose_depth(s)
        if depth <= 1:
            return max(s, 1), 1
        if self.legion_size > 0:
            return min(self.legion_size, s), depth
        return min(optimal_kd(s, depth), s), depth

    def use_hierarchical(self, s: int) -> bool:
        return s > self.hierarchical_threshold

    def spare_count(self, n_nodes: int) -> int:
        """Warm spares to provision for an n-node cluster: the larger of the
        absolute knob and the fractional one."""
        return max(self.spare_nodes,
                   math.ceil(self.spare_fraction * n_nodes))

    @property
    def substitution_enabled(self) -> bool:
        return self.recovery_mode != "shrink"

    @property
    def strategy_key(self) -> str:
        """Registry key of the RecoveryStrategy this policy composes
        (see :mod:`repro_torch.core.strategy`). New strategies register under new
        keys; the ladder this replaces lived in ``VirtualCluster.repair``."""
        if self.recovery_mode == "adaptive":
            return "adaptive"
        if not self.substitution_enabled:
            return "shrink"
        if self.nonblocking_substitution:
            return "substitute_nonblocking"
        return "substitute"

    @property
    def elastic_spares(self) -> bool:
        return self.spare_refill_watermark > 0
