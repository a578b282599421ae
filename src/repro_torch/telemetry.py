"""Spans inside the serving engine's step and the training step.

A span is a named interval on ``time.perf_counter`` (the clock the engine
stamps requests with), with its parent span, the request it served (or
None) and a few integer attributes. ``Engine.step`` and ``train_step`` ask
:func:`session` once each whether to record; beneath them that answer is
passed down, so with recording off a step makes one call here and records
nothing.

Recording is on inside :func:`recording`, and while ``torch.profiler`` is
recording on the calling thread (``torch.autograd._profiler_enabled``), so
a profiled window holds the spans of the steps it profiled. Each time
recording goes from off to on a new :class:`Session` starts, and
:func:`last` gives the newest. A session keeps at most ``CAPACITY`` spans in
memory and counts the ones it dropped; nothing is written out.

On a CUDA device ``train_step`` and the expert layer also record a CUDA
event at each phase edge (one event per edge, shared by the phases on
either side, never synchronised); :meth:`Session.device_ms` resolves a
span's device milliseconds when it is read. :meth:`Session.host_ms` and
:meth:`Session.phase_ms` give the per-span host and per-step device
milliseconds that the benchmark's readers take percentiles of.

Spans (parent > children; ``rid`` the request's id):

* serving, one per ``Engine.step``: ``step`` (``tick``, and at the step's
  start ``residents``, ``queue_len``, ``pages_in_use``) > ``admit`` >
  ``prefill`` (``rid``, ``tokens``; a one-shot prefill or one chunk) >
  ``prefill.launch``, ``prefill.wait`` (the seed token's read-back);
  ``step`` > ``decode`` or ``spec`` > ``*.launch``, ``*.wait``
  (the read-backs), ``*.emit`` (the host loop over the lanes); ``step`` >
  ``retire`` (with the immune ``end_tick``); and per request ``queue``
  (``rid``, no parent), from ``submit`` to its first admission;
* training, one per ``train_step``: ``train_step`` > ``forward``,
  ``backward`` (the gradients), ``optimizer`` (the global norm and AdamW in
  place), ``router`` (MoE only), in that order (forward and backward once
  per microbatch); an MoE step's span holds the step's counters as
  attributes (device tensors: ``fill``, ``drop``, ``load_cv``);
* the expert layer, once per MoE layer of the forward pass (not in remat's
  recompute, which runs under ``backward``): ``forward`` > ``moe``
  (``layer``) > ``moe.route``, ``moe.dispatch``, ``moe.experts`` (``live``:
  the buffer rows holding an assignment, a device tensor), ``moe.combine``
  (with the layer's counters).
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch

CAPACITY = 1 << 18          # spans a session keeps; later ones are dropped


class Span:
    __slots__ = ("index", "name", "t0", "t1", "parent", "rid", "attrs",
                 "ev0", "ev1")

    def __init__(self, index, name, t0, t1, parent, rid, attrs, ev0=None,
                 ev1=None):
        self.index, self.name, self.t0, self.t1 = index, name, t0, t1
        self.parent, self.rid, self.attrs = parent, rid, attrs
        self.ev0, self.ev1 = ev0, ev1

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _event(device: torch.device) -> Optional[torch.cuda.Event]:
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Session:
    """The spans of one recording, in the order they were opened or added.
    A span's ``parent`` is the index of the span open around it, -1 for
    none; ``t1`` is None while it is open."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans: list[Span] = []
        self.dropped = 0
        self.capacity = capacity
        self._open: list[int] = []      # indices of the open spans, inner last
        self._phases: list[bool] = []   # whether each open span is a phase
        self._kids = None

    # -- recording -----------------------------------------------------------
    def _put(self, name, t0, t1, parent, rid, attrs, ev0=None) -> int:
        if len(self.spans) >= self.capacity:
            self.dropped += 1
            return -1
        i = len(self.spans)
        self.spans.append(Span(i, name, t0, t1, parent, rid, attrs or None,
                               ev0))
        return i

    def _parent(self) -> int:
        return self._open[-1] if self._open else -1

    def begin(self, name: str, rid=None, root: bool = False, t=None,
              ev=None, **attrs) -> None:
        """Open a span inside the innermost open one (``root``: a step's own
        span, which closes whatever an exception left open)."""
        if root:
            self._open.clear()
            self._phases.clear()
        t = time.perf_counter() if t is None else t
        self._open.append(self._put(name, t, None, self._parent(), rid, attrs,
                                    ev))
        self._phases.append(False)

    def end(self, t=None, ev=None) -> None:
        """Close the innermost open span."""
        i = self._open.pop()
        self._phases.pop()
        t = time.perf_counter() if t is None else t
        if i >= 0:
            self.spans[i].t1, self.spans[i].ev1 = t, ev

    def add(self, name: str, t0: float, t1: float, rid=None,
            root: bool = False) -> None:
        """A span whose ends were read already, inside the innermost open
        one (``root``: inside none)."""
        self._put(name, t0, t1, -1 if root else self._parent(), rid, None)

    def phase(self, name: Optional[str], device: torch.device,
              **attrs) -> None:
        """A phase edge: close the open phase (if any) and open ``name`` (if
        not None) beside it, at one clock reading and, on a CUDA
        ``device``, one event."""
        t = time.perf_counter()
        ev = _event(device)
        if self._phases and self._phases[-1]:
            self.end(t, ev)
        if name is not None:
            self.begin(name, t=t, ev=ev, **attrs)
            self._phases[-1] = True

    def open(self, name: str, device: torch.device, **attrs) -> None:
        """Open a span with an event at its start, for phases inside it."""
        self.begin(name, ev=_event(device), **attrs)

    def close(self, device: torch.device) -> None:
        """Close the open phase (if any) and the span around it, at one
        clock reading and one event."""
        t = time.perf_counter()
        ev = _event(device)
        if self._phases[-1]:
            self.end(t, ev)
        self.end(t, ev)

    def innermost(self) -> Optional[str]:
        """The name of the innermost open span (None if none, or if the
        session was full when it opened)."""
        i = self._open[-1] if self._open else -1
        return self.spans[i].name if i >= 0 else None

    def note(self, **attrs) -> None:
        """Set attributes of the innermost open span."""
        i = self._open[-1] if self._open else -1
        if i >= 0:
            span = self.spans[i]
            span.attrs = {**(span.attrs or {}), **attrs}

    # -- reading -------------------------------------------------------------
    def named(self, name: str, t0: float = -float("inf"),
              t1: float = float("inf")) -> list[Span]:
        """The closed spans called ``name`` that end inside [t0, t1], in
        order."""
        return [s for s in self.spans if s.name == name
                and s.t1 is not None and t0 <= s.t1 <= t1]

    def children(self, span: Span) -> list[Span]:
        if self._kids is None or self._kids[0] != len(self.spans):
            kids: dict[int, list[int]] = {}
            for s in self.spans:
                kids.setdefault(s.parent, []).append(s.index)
            self._kids = (len(self.spans), kids)
        return [self.spans[i] for i in self._kids[1].get(span.index, ())]

    def descendants(self, span: Span) -> list[Span]:
        out, todo = [], self.children(span)
        while todo:
            s = todo.pop()
            out.append(s)
            todo += self.children(s)
        return out

    def host_ms(self, name: str, t0: float = -float("inf"),
                t1: float = float("inf"), less: Optional[str] = None
                ) -> list[float]:
        """Host milliseconds of each closed span called ``name`` that ends
        inside [t0, t1], less the spans beneath it whose names end in
        ``less`` (if given), in order."""
        out = []
        for s in self.named(name, t0, t1):
            sec = s.seconds
            if less is not None:
                sec -= sum(d.seconds for d in self.descendants(s)
                           if d.name.endswith(less))
            out.append(sec * 1e3)
        return out

    def phase_ms(self, phase: str, t0: float = -float("inf"),
                 t1: float = float("inf")) -> Optional[list[float]]:
        """Device milliseconds of ``phase`` in each ``train_step`` that ends
        inside [t0, t1], summed over the step's microbatches, in order;
        None where a step has no such phase or it has no device times."""
        out = []
        for step in self.named("train_step", t0, t1):
            ms = [self.device_ms(c) for c in self.children(step)
                  if c.name == phase]
            if not ms or None in ms:
                return None
            out.append(sum(ms))
        return out

    def device_ms(self, span: Span) -> Optional[float]:
        """The device milliseconds between the span's edge events (waits for
        its end event); None for a span without them."""
        if span.ev0 is None or span.ev1 is None:
            return None
        span.ev1.synchronize()
        return span.ev0.elapsed_time(span.ev1)


class _Switch:
    """Whether recording is on, and the newest session."""

    def __init__(self):
        self.depth = 0              # recording() blocks entered
        self.on = False             # as of the last read
        self.last: Optional[Session] = None


_SWITCH = _Switch()


def session() -> Optional[Session]:
    """The switch, read once per step: the session to record into, or None
    with recording off. A new session starts where recording went from off
    to on since the last read."""
    sw = _SWITCH
    on = sw.depth > 0 or torch.autograd._profiler_enabled()
    if on and not sw.on:
        sw.last = Session()
    sw.on = on
    return sw.last if on else None


@contextlib.contextmanager
def recording() -> Iterator[Session]:
    """Record inside this block, whether or not the profiler is on."""
    _SWITCH.depth += 1
    try:
        yield session()
    finally:
        _SWITCH.depth -= 1
        session()


def last() -> Optional[Session]:
    """The newest session (being recorded, or the last one recorded)."""
    return _SWITCH.last
