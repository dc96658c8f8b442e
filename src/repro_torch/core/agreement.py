"""Fault agreement — the BNP fix (paper §IV) and ULFM ``MPIX_Comm_agree``.

After a collective on a faulty communicator only *some* survivors hold a
PROC_FAILED verdict (the Broadcast Notification Problem, P.3). Legio runs an
agreement that "combines the results obtained by all the processes into a
single one equal for all". :func:`agree_fault` is the runtime-level form:
the union of per-observer suspicion sets, which all survivors adopt (what
the repair path consumes).

The agreement itself must tolerate faults (ULFM guarantees this); here the
union over live observers is trivially fault-tolerant because dead observers
simply contribute nothing. The in-program liveness bitmap all-reduce (the
JAX package's ``liveness_psum`` / ``agree_bitmap_inprogram``) needs a
multi-device process group and comes with the multi-card slice.
"""
from __future__ import annotations

import numpy as np


def agree_fault(observations: dict[int, set[int]], live: list[int]) -> set[int]:
    """Union of suspicion sets across live observers -> single verdict.

    ``observations[i]`` is the set of nodes that observer ``i`` noticed as
    failed; observers not in ``live`` are ignored (they may be dead).
    The result is what every survivor adopts — identical everywhere,
    resolving the BNP.
    """
    verdict: set[int] = set()
    for obs, seen in observations.items():
        if obs in live:
            verdict |= seen
    return verdict


def agreement_rounds(n_participants: int) -> int:
    """Tree-agreement depth — used by the repair cost model (log2 rounds)."""
    return max(1, int(np.ceil(np.log2(max(n_participants, 2)))))
