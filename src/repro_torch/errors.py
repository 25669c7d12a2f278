"""Lifecycle states and the typed errors of the query session.

:class:`Status` is the lifecycle enum shared by session results and, in
later slices, serving futures.  It subclasses :class:`str`, so
``Status.DONE == "done"`` holds.
"""
from __future__ import annotations

import enum


class Status(str, enum.Enum):
    """Lifecycle of a submitted request (query or graph update).

    ``PENDING`` -> queued, not yet picked up by the scheduler;
    ``RUNNING`` -> popped into an executing batch;
    terminal states: ``DONE`` (query answered), ``DEAD_LETTER`` (query
    quarantined after retries + bisection), ``DEADLINE`` (latency budget
    expired before service), ``APPLIED`` (delta landed), ``FAILED``
    (delta rolled back).
    """

    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    DEAD_LETTER = "dead_letter"
    DEADLINE = "deadline"
    APPLIED = "applied"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        """True once a future carrying this status will never change."""
        return self not in (Status.PENDING, Status.RUNNING)

    def __str__(self) -> str:  # repr-friendly: "done", not "Status.DONE"
        return self.value


class NoCudaDevice(RuntimeError):
    """The session was asked for the card (the default) but PyTorch sees
    no CUDA device.  The port never falls back to the CPU on its own: a
    caller that wants the CPU passes ``device="cpu"``."""

    def __init__(self):
        super().__init__(
            "repro_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to "
            "run on the CPU")


class ServingError(Exception):
    """Base class of every typed serving failure.  ``permanent`` is the
    retry contract: retrying the same operation cannot succeed when True.
    ``status`` is the terminal :class:`Status` a future resolves to when
    this error is its outcome."""

    permanent = False
    status = Status.FAILED


class DeltaApplyFailed(ServingError):
    """A graph delta failed mid-apply and the fragmentation and its caches
    were rolled back to the pre-delta snapshot (``arrays_version`` and
    ``cache_version`` unchanged; queries keep answering against the
    pre-delta graph).  ``cause`` is the underlying failure."""

    status = Status.FAILED

    def __init__(self, cause: BaseException):
        self.cause = cause
        self.rolled_back = True
        self.permanent = getattr(cause, "permanent", False)
        super().__init__("graph delta failed and was rolled back "
                         f"(pre-delta cache intact): {cause!r}")
