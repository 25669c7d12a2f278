"""What one run records: every read and delta of the window with its
times and answer, the set-up split, the memory peak, and in a traced run
the layer probes and the device trace.  The metric readers read this.

Every time is ``time.monotonic`` seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .data.generate import Delta, Read


@dataclasses.dataclass
class ReadRec:
    """One read: when it was due, sent and answered, what it answered and
    against which version of the graph (the number of deltas applied)."""

    read: Read
    due: float
    sent: float
    done: Optional[float] = None   # None: never answered
    ok: bool = False               # answered with status done
    value: object = None
    version: Optional[int] = None
    error: str = ""

    def latency_s(self, give_up: float) -> float:
        """Due to answer; a read that never came or failed counts until
        ``give_up``."""
        return ((self.done if self.ok else give_up) - self.due)


@dataclasses.dataclass
class DeltaRec:
    """One delta: due, sent, committed (its future resolved)."""

    delta: Delta
    due: float
    sent: float
    done: Optional[float] = None
    ok: bool = False
    mode: str = ""
    error: str = ""

    def latency_s(self, give_up: float) -> float:
        """Due to committed and readable; a delta that failed or never
        committed counts until ``give_up``."""
        return ((self.done if self.ok else give_up) - self.due)


@dataclasses.dataclass
class Layers:
    """The layer probes of a traced run (host milliseconds and counts)."""

    session_ms: List[float] = dataclasses.field(default_factory=list)
    batch_m: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    repair_ms: List[float] = dataclasses.field(default_factory=list)
    local_ms: List[float] = dataclasses.field(default_factory=list)
    evaldg_ms: List[float] = dataclasses.field(default_factory=list)
    nb: int = 0                    # the closure's side, for the rooflines


@dataclasses.dataclass
class Run:
    cell: str
    seed: int
    seconds: float
    config: dict
    traffic: dict
    graph: object = None           # bench.data.generate.GraphData
    t0: float = 0.0                # the window opens
    t_end: float = 0.0             # the window closes
    give_up: float = 0.0           # when the run stopped waiting
    setup_s: float = 0.0
    setup_split: Dict[str, float] = dataclasses.field(default_factory=dict)
    reads: List[ReadRec] = dataclasses.field(default_factory=list)
    deltas: List[DeltaRec] = dataclasses.field(default_factory=list)
    warm_deltas: List[DeltaRec] = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    batches_run: int = 0           # server batches in the window
    batch_size: int = 0
    gc_pauses: List = dataclasses.field(default_factory=list)
    layers: Optional[Layers] = None
    trace: object = None           # bench.trace.DeviceTrace
    spans: object = None           # bench.trace.Spans

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0
