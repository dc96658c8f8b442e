"""Errors the MPI facade surfaces to applications.

The interposition layer's contract (paper §IV, applied at the call seam):
an application-visible error exists only when the *caller itself* depended
on the dead process — its op's root, or its point-to-point peer. Every
other fault is repaired behind the call and the op retried, so the caller
never sees it. :class:`PeerFailedError` is that one visible case, carrying
the paper's discard semantics: the op's result for this caller is
discarded, nothing was delivered, and the communicator has already been
repaired — the *next* call proceeds on the healed structure.
"""
from __future__ import annotations


class MPISessionError(RuntimeError):
    """Misuse of the session lifecycle (op after finalize, double init)."""


class PeerFailedError(RuntimeError):
    """The caller's root/peer was in the agreed verdict of this call.

    Raised *after* the repair has been applied: catching it and issuing the
    next call is always safe — the topology underneath is already healed.
    ``peers`` names the dead nodes the caller depended on; ``op`` the MPI
    call that surfaced them. ``discarded`` is True when an in-flight
    point-to-point payload was discarded with the peer (the paper's
    discard-and-continue outcome, never a deadlock).
    """

    def __init__(self, message: str, *, op: str = "",
                 peers: tuple[int, ...] = (), discarded: bool = False):
        super().__init__(message)
        self.op = op
        self.peers = tuple(peers)
        self.discarded = discarded


class RecvWouldDeadlockError(RuntimeError):
    """A ``recv`` found no matching message and the sender is *alive*.

    In the step-driven simulation a send must happen-before its recv; a
    recv that would block on a healthy peer is a program-order bug, not a
    fault — surfaced eagerly instead of hanging the driver loop. (A recv
    blocking on a *dead* peer is the fault case and raises
    :class:`PeerFailedError` after draining the pipeline.)
    """
