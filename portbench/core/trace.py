"""The profiler over the measured window of a ``--trace 1`` run: the card's
activity alone (tracing the host's operators too slows the host-bound loop
the window measures), after a warm-up step in which the profiler's first
kernels are taken (it can drop a profile's first ones); frozen from the
port's card script (``device_rows``), which reads isolated calls the same
way.

Read from it: every device operation (kernels, copies, fills) with its
start and end, the seconds in which one ran (intervals merged), the
window's length, the operations that took most time by name, and the
longest gaps in which none ran, named by the harness span the host was in.
The profiler stamps events on the host's wall clock (``time.time_ns``), so
a span taken on ``time.perf_counter`` maps onto it by one offset.
"""
from __future__ import annotations

import sys
import time


class Trace:
    def __init__(self, torch, enabled: bool):
        self.torch = torch
        self.enabled = enabled
        self.events = []            # (name, start_ns, end_ns), sorted
        self.window_s = None
        self.busy_s = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile, schedule
            torch = self.torch
            self._prof = profile(activities=[ProfilerActivity.CUDA],
                                 schedule=schedule(wait=0, warmup=1, active=1),
                                 on_trace_ready=self._collect)
            self._prof.__enter__()
            torch.ones(16, device="cuda").add_(1)      # the warm-up step
            torch.cuda.synchronize()
            self._prof.step()
        self.pc0 = time.perf_counter()
        self.ns0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self.torch.cuda.synchronize()
        self.pc1 = time.perf_counter()
        self.ns1 = self.ns0 + int((self.pc1 - self.pc0) * 1e9)
        if self.enabled:
            self._prof.step()
            self._prof.__exit__(*exc)
            self.window_s = self.pc1 - self.pc0
            self._reduce()
            print(f"portbench: trace of {len(self.events)} device operations"
                  f" read in {time.perf_counter() - self.pc1:.1f} s",
                  file=sys.stderr)
        return False

    def _collect(self, prof):
        from torch.autograd import DeviceType
        t0 = time.perf_counter()
        events = prof.profiler.kineto_results.events()
        print(f"portbench: profiler stopped {t0 - self.pc1:.1f} s after the "
              f"window, {len(events)} events listed in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        out = []
        for e in events:
            if e.device_type() == DeviceType.CPU or e.duration_ns() <= 0:
                continue
            if e.name().startswith("ProfilerStep"):
                continue
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        out.sort(key=lambda x: x[1])
        self.events = out

    def ns(self, pc: float) -> int:
        """A ``perf_counter`` reading on the profiler's clock."""
        return self.ns0 + int((pc - self.pc0) * 1e9)

    def _reduce(self):
        merged = []
        for _, a, b in self.events:
            a, b = max(a, self.ns0), min(b, self.ns1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.merged = merged
        self.busy_s = sum(b - a for a, b in merged) / 1e9

    def calls(self, pattern: str) -> list:
        """(start_ns, end_ns) of the device operations whose name holds
        ``pattern``, in order."""
        return [(a, b) for n, a, b in self.events if pattern in n]

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, a, b in self.events:
            by[name[:120]] = by.get(name[:120], 0.0) + (b - a) / 1e9
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, spans: list, n: int = 10) -> list:
        """The ``n`` longest gaps with nothing on the device, each named by
        the host span (``(name, t0, t1)`` on ``perf_counter``) around its
        middle and its start in seconds from the window's start."""
        edges = [self.ns0] + [x for ab in self.merged for x in ab] \
            + [self.ns1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [(self.ns(t0), self.ns(t1), name) for name, t0, t1 in spans]
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) // 2
            what = next((name for s, e, name in named if s <= mid < e),
                        "harness")
            out.append([f"{what}@{(a - self.ns0) / 1e9:.3f}s",
                        (b - a) / 1e9])
        return out
