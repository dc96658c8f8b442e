"""repro_torch.mpi — the transparent MPI session facade (PMPI-style interposition).

The paper's headline property is *transparency*: Legio lives behind the MPI
calls, so an embarrassingly parallel application needs zero integration
effort. This package is that seam for the simulated runtime — the only API
applications (and the rest of this repo: trainer, executor, serve engine,
launch drivers, examples) see:

  * :class:`Session` — MPI_Init/Finalize lifecycle over a VirtualCluster,
    step-boundary primitives (spare delivery, fault injection, clock), and
    the facade-level fault listener;
  * :class:`Comm` — the MPI-shaped surface (``bcast`` / ``reduce`` /
    ``allreduce`` / ``barrier`` / ``gather`` / ``send`` / ``recv`` /
    ``sendrecv`` / ``comm_split`` / ``comm_dup`` / rank / size) where every
    call traps the simulated ``MPIX_ERR_PROC_FAILED``, drains the
    FaultPipeline, applies the configured RecoveryStrategy, and retries on
    the repaired communicator — the caller sees a fault only when it *was*
    the dead node's dependent (root/peer), as a clean
    :class:`PeerFailedError` with discard semantics;
  * :class:`MessageLedger` — fault-aware point-to-point matching (Rocco &
    Palermo's non-collective follow-up): no message lost, none delivered
    twice, and no recv ever deadlocks on a dead peer.

See docs/api.md for the paper-style call-mapping table.
"""
from repro_torch.mpi.comm import CALL_SOURCES, Comm, InterpositionStats
from repro_torch.mpi.errors import (
    MPISessionError,
    PeerFailedError,
    RecvWouldDeadlockError,
)
from repro_torch.mpi.ledger import Envelope, MessageLedger, MsgState
from repro_torch.mpi.session import BoundaryReport, Session

__all__ = [
    "BoundaryReport", "CALL_SOURCES", "Comm", "Envelope",
    "InterpositionStats", "MPISessionError", "MessageLedger", "MsgState",
    "PeerFailedError", "RecvWouldDeadlockError", "Session",
]
