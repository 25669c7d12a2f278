"""Lifecycle states and the typed errors of the session and the serving
stack.

:class:`Status` is the lifecycle enum shared by session results, serving
futures (:mod:`repro_torch.serve.engine`) and the error taxonomy here (each
terminal failure class carries the ``status`` it resolves a future to).
It subclasses :class:`str`, so ``Status.DONE == "done"`` holds.

Every failure the server surfaces to a client is a :class:`ServingError`;
its ``permanent`` attribute is the retry contract: the scheduler retries
transient failures with capped backoff and gives up at once on permanent
ones.  A fault of the device or of a kernel (:func:`is_device_fault`) is
none of these: the serving stack never retries it, never quarantines a
request for it, and raises it to its caller.
"""
from __future__ import annotations

import enum

import torch


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


class KernelError(RuntimeError):
    """A CUDA kernel of the port failed to build or to launch."""


def is_device_fault(exc: BaseException) -> bool:
    """True for a failure of the card or of a kernel, which no retry of
    the same request can mend and which must not pass for a bad request:
    :class:`KernelError`, a CUDA out-of-memory error, and every error that
    PyTorch raises from the CUDA runtime."""
    if isinstance(exc, (KernelError, torch.cuda.OutOfMemoryError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and any(
        tag in str(exc) for tag in ("CUDA error", "CUDA driver error"))


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


class QueryTooExpensive(ServingError):
    """Admission control rejected a RED-lane query at ``submit`` time.

    Carries the cost estimate and the limit it exceeded so clients can
    split the query, raise their limit, or route it elsewhere."""

    permanent = True

    def __init__(self, kind: str, estimate: float, limit: float):
        self.kind = kind
        self.estimate = float(estimate)
        self.limit = float(limit)
        super().__init__(
            f"{kind} query cost estimate {self.estimate:.0f} exceeds the "
            f"red-lane admission limit {self.limit:.0f} semiring ops")


class DeadlineExceeded(ServingError):
    """The request's latency budget expired before it was served; the
    server fails it fast instead of computing an answer nobody waits
    for."""

    permanent = True
    status = Status.DEADLINE

    def __init__(self, message: str = "request deadline exceeded"):
        super().__init__(message)


class DeadLetterError(ServingError):
    """A request kept failing after retries and batch bisection and was
    quarantined into the server's ``dead_letters``.  ``cause`` is the last
    underlying failure."""

    permanent = True
    status = Status.DEAD_LETTER

    def __init__(self, attempts: int, cause: BaseException):
        self.attempts = int(attempts)
        self.cause = cause
        super().__init__(f"request dead-lettered after {self.attempts} "
                         f"attempts: {cause!r}")


class InjectedFault(ServingError):
    """Raised by :class:`repro_torch.serve.faults.FaultInjector` at an
    injection site.  ``permanent=True`` models a poison input that fails on
    every attempt; the default models a transient fault that retries can
    outlive."""

    def __init__(self, site: str, detail: str = "", permanent: bool = False):
        self.site = site
        self.permanent = bool(permanent)
        msg = f"injected fault at {site!r}"
        super().__init__(msg + (f": {detail}" if detail else ""))
