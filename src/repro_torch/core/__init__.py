"""Legio core — the paper's contribution as a composable runtime, in PyTorch.

Layering (paper section -> module):
  §V  hierarchy      legions / masters / POVs / ring, topology epochs + views
  §III detector      heartbeats, noticing semantics (BNP), stragglers
  §IV agreement      fault agreement (BNP fix)
  §IV pipeline       detect → notice → agree → plan → apply fault pipeline
  —   strategy       RecoveryStrategy registry (shrink / substitute / …)
  §V  shrink         S(x) cost model, Eq. 1-4, Fig. 3 repair plans
  —   substitute     warm spare pool, substitution repair, elastic provisioner
  §V  collectives    hierarchical op schedules over the data-plane seam
  §IV batch          DROP / REBALANCE shard reassignment
  §IV executor       transparent orchestration draining the pipeline
  §VII cr            per-legion checkpoint/restart (restart-only-failed)
  —   trainer        resilient data-parallel training
  —   faultmodel     seeded correlated-failure campaigns (rack, partition, …)
  —   chaos          ChaosHarness: campaigns against train/serve, invariants

The control plane is numpy and host Python, carried over from the JAX
package; payloads ride the data plane (``repro_torch.dist.dataplane``),
device tensors on the torch plane. Applications program against
:mod:`repro_torch.mpi` (Session/Comm); everything here is the machinery
behind it. The mesh manager comes with the multi-card slice.
"""
from repro_torch.core.agreement import agree_fault, agreement_rounds
from repro_torch.core.batch import (
    BatchPlan,
    gradient_scale,
    initial_assignment,
    reassign,
    restore_rank,
    substitute_assign,
    validate_plan,
)
from repro_torch.core.chaos import (
    ChaosHarness,
    ChaosReport,
    InvariantCheck,
    check_topology_coherence,
)
from repro_torch.core.collectives import (
    CollectiveResult,
    HierarchicalCollectives,
    LinkModel,
    agreement_time,
    flat_collective_time,
)
from repro_torch.core.cr import LegionCheckpointer, RestartRecord
from repro_torch.core.detector import (
    FaultInjector,
    HeartbeatDetector,
    StragglerDetector,
    notice_fault,
)
from repro_torch.core.executor import (
    LegioExecutor,
    RootFailedError,
    StepReport,
    VirtualCluster,
)
from repro_torch.core.faultmodel import ChaosEvent, FaultCampaign, FaultModel
from repro_torch.core.hierarchy import (
    Legion,
    LegionTopology,
    LevelGroup,
    StaleLegionError,
    TopologyTornError,
    TopologyView,
    make_topology,
)
from repro_torch.core.pipeline import FaultPipeline
from repro_torch.core.policy import (
    RECOVERY_MODES,
    LegioPolicy,
    eq3_s_of_k,
    eq4_s_of_k,
    optimal_k_linear,
    optimal_k_quadratic,
    optimal_kd,
)
from repro_torch.core.shrink import ShrinkCostModel, ShrinkEngine, failures_by_legion
from repro_torch.core.strategy import (
    AdaptiveDecision,
    CostModelStrategy,
    NonblockingSubstituteStrategy,
    RecoveryStrategy,
    ShrinkStrategy,
    SubstituteStrategy,
    available_strategies,
    make_strategy,
    register_strategy,
)
from repro_torch.core.substitute import (
    PendingSubstitution,
    RestoreOutcome,
    SparePool,
    SparePoolExhausted,
    SpareProvisioner,
    SubstituteCostModel,
    SubstituteEngine,
    UnfilledSlot,
    restore_for_substitute,
    restore_member_state,
)
from repro_torch.core.trainer import ResilientTrainer, TrainerReport, make_train_step
from repro_torch.core.types import (
    ChaosAction,
    FailureEvent,
    FailureKind,
    FaultEvent,
    FaultSource,
    NodeState,
    OpStatus,
    PipelineTrace,
    RecoveryAction,
    RepairReport,
    RepairScope,
    RepairStep,
)

__all__ = [
    "AdaptiveDecision", "BatchPlan", "ChaosAction", "ChaosEvent",
    "ChaosHarness", "ChaosReport", "CollectiveResult",
    "CostModelStrategy", "FailureEvent", "FailureKind", "FaultCampaign",
    "FaultEvent", "FaultInjector", "FaultModel", "FaultPipeline",
    "FaultSource", "HeartbeatDetector", "HierarchicalCollectives",
    "InvariantCheck", "Legion", "LegionCheckpointer", "LegionTopology",
    "LegioExecutor",
    "LegioPolicy", "LevelGroup", "LinkModel", "NodeState",
    "NonblockingSubstituteStrategy", "OpStatus", "PendingSubstitution",
    "PipelineTrace", "RECOVERY_MODES", "RecoveryAction", "RecoveryStrategy",
    "RepairReport", "RepairScope", "RepairStep", "ResilientTrainer",
    "RestartRecord", "RestoreOutcome", "RootFailedError", "ShrinkCostModel", "ShrinkEngine", "ShrinkStrategy",
    "SparePool", "SparePoolExhausted", "SpareProvisioner", "StaleLegionError",
    "StepReport", "StragglerDetector", "SubstituteCostModel",
    "SubstituteEngine", "SubstituteStrategy", "TopologyTornError",
    "TopologyView", "TrainerReport", "UnfilledSlot", "VirtualCluster", "agree_fault",
    "agreement_rounds", "agreement_time", "available_strategies",
    "check_topology_coherence",
    "eq3_s_of_k", "eq4_s_of_k", "failures_by_legion", "flat_collective_time",
    "gradient_scale", "initial_assignment", "make_strategy", "make_topology",
    "make_train_step",
    "notice_fault", "optimal_k_linear", "optimal_k_quadratic", "optimal_kd",
    "reassign", "register_strategy", "restore_for_substitute",
    "restore_member_state", "restore_rank", "substitute_assign",
    "validate_plan",
]
