"""Per-legion checkpoint/restart records (paper §VII direction).

This slice carries only :class:`RestartRecord`, which the substitution
restore ladder (``core.substitute.restore_member_state``) appends to an
attached checkpointer's log. ``LegionCheckpointer`` and the on-disk store
come with the trainer slice; until then clusters run with
``checkpointer=None`` and restores come from peer replicas or nowhere.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RestartRecord:
    node: int
    legion: int
    step: int
    source: str            # "checkpoint" (store read) | "peer" (ring replica)
