"""The device trace of a traced run: ``torch.profiler`` with CUDA activity
alone, over the whole measured window, reduced to what the per-layer
readers and the result line need.

* busy time: the union of every kernel, copy and fill on the card;
* the traced window: from a marker kernel launched as the window opens to
  one launched once every answer is in, so that busy over window is the
  device's busy share of the run;
* device time by kernel name;
* idle gaps, labelled by the harness's host spans that cover them (what
  the host was doing while the card waited).

Host spans are taken on ``time.monotonic``; the trace's clock is mapped to
it by the first marker (the launch latency, some microseconds, is the
error of that mapping).
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: idle gaps shorter than this (seconds) are not labelled one by one
GAP_MIN_S = 20e-6


class Spans:
    """Host spans recorded by the harness's wrappers: ``(label, start,
    end)`` on ``time.monotonic``, from any thread."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    def add(self, label: str, start: float, end: float) -> None:
        self.items.append((label, start, end))   # list.append is atomic


class DeviceTrace:
    """Start before the window opens, stop after the last answer."""

    def __init__(self):
        self._prof = None
        self._marks: List[int] = []     # monotonic ns at each marker launch
        self.events: List[Tuple[str, int, int]] = []   # name, start, end ns
        self.offset_ns = 0

    def _mark(self) -> None:
        torch.cuda.synchronize()
        self._marks.append(time.monotonic_ns())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._mark()

    def stop(self) -> None:
        self._mark()
        self._prof.stop()
        cuda = torch._C._autograd.DeviceType.CUDA
        evs = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            start = e.start_ns()
            evs.append((e.name(), start, start + e.duration_ns()))
        self._prof = None
        evs.sort(key=lambda e: e[1])
        self.events = evs
        if len(evs) >= 2:
            self.offset_ns = evs[0][1] - self._marks[0]

    # -- reductions ----------------------------------------------------------

    @property
    def window(self) -> Tuple[int, int]:
        """The traced window in trace ns: first marker's start to the last
        marker's end."""
        return self.events[0][1], self.events[-1][2]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, a, b in self.events:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e9

    def kernel_s(self, name_part: str) -> float:
        """Device seconds of every event whose name contains ``name_part``."""
        return sum(b - a for n, a, b in self.events if name_part in n) / 1e9

    def top_ops(self, count: int = 10) -> List[list]:
        by: Dict[str, int] = collections.defaultdict(int)
        for n, a, b in self.events:
            by[n] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:count]
        return [[n[:200], v / 1e9] for n, v in top]

    def idle_gaps(self, spans: Sequence[Tuple[str, float, float]]
                  ) -> List[Tuple[str, float, float]]:
        """Every idle gap of at least :data:`GAP_MIN_S` inside the window:
        ``(label, start_monotonic_s, seconds)``, the label that of the
        shortest host span covering the gap's middle, or ``"no span"``."""
        busy = self.busy_intervals()
        spans_ns = sorted(((lbl, int(a * 1e9) + self.offset_ns,
                            int(b * 1e9) + self.offset_ns)
                           for lbl, a, b in spans), key=lambda s: s[1])
        out = []
        nxt, active = 0, []          # a sweep: gaps come in time order
        for (_, b0), (a1, _) in zip(busy, busy[1:]):
            if (a1 - b0) / 1e9 < GAP_MIN_S:
                continue
            mid = (a1 + b0) // 2
            while nxt < len(spans_ns) and spans_ns[nxt][1] <= mid:
                active.append(spans_ns[nxt])
                nxt += 1
            active = [s for s in active if s[2] >= mid]
            best: Optional[Tuple[str, int, int]] = min(
                active, key=lambda s: s[2] - s[1], default=None)
            label = best[0] if best is not None else "no span"
            out.append((label, (b0 - self.offset_ns) / 1e9, (a1 - b0) / 1e9))
        return out


def gap_summary(gaps, count: int = 10) -> List[list]:
    """Idle seconds by what the host was doing, largest first."""
    by: Dict[str, float] = collections.defaultdict(float)
    for label, _, sec in gaps:
        by[label] += sec
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:count]]
