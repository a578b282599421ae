"""Deterministic fault injection for the multi-replica serving fleet (PyTorch
port of ``repro/serve/faults.py``, pure Python: the port keeps its own copy).

Fault tolerance is a core evaluation axis for dynamic load balancers (Mandal
& Pal, arXiv:1109.1650), and the immune metaphor's headline property is
resilience, not speed: regulation, tolerance, and memory exist so the system
keeps functioning while components die or misbehave. This module makes that
claim measurable: a :class:`FaultPlan` is a *seeded, tick-exact script* of
replica failures; a :class:`FaultInjector` applies it to a
``serve.router.Router`` fleet while the router's health machine
(healthy -> suspect -> dead from missed step deadlines) detects and recovers.
Everything is host-side and tick-driven, so a given ``(trace, plan, policy)``
triple replays identically — which is what lets the benchmark assert that
every *surviving* request's tokens are bitwise identical to the fault-free
run.

Fault kinds (``FaultEvent.kind``):

  * ``"crash"``    — the replica stops stepping, permanently, with no
    goodbye: its queue and resident slots are stranded until the router's
    missed-deadline health machine declares it dead and evacuates them onto
    survivors (fail-stop, detected not announced).
  * ``"slow"``     — for ``duration`` ticks the replica steps only once
    every ``factor`` fleet ticks (a straggler: thermal throttling, a noisy
    neighbour, a background compaction).
  * ``"stall"``    — for ``duration`` ticks the replica does not step at all,
    then resumes on its own (a GC pause / network partition that heals). If
    the stall outlives the router's ``dead_after`` deadline the replica is
    declared dead and *fenced* — real systems cannot un-declare a death, so
    a late-healing stall rejoins only via an explicit ``rejoin`` event.
  * ``"pressure"`` — ``pages`` KV pages are seized from the replica's pool
    for ``duration`` ticks (host memory reclaim / a co-tenant ballooning);
    the allocator's conservation invariant holds throughout
    (``PageAllocator.seize`` / ``restore``).
  * ``"rejoin"``   — a crashed (or fenced) replica returns as a *fresh*
    process: a new ``Engine`` with a cold pinned prefix cache and blank
    immune state, built by the injector's ``engine_factory``. The router
    re-admits it at full health; prefix-affinity traffic rewarms its cache.

Beyond the per-replica kinds, two *fleet-wide* kinds script a full power
loss (``FLEET_FAULT_KINDS``):

  * ``"poweroff"`` — fail-stop of the ENTIRE fleet, router included: every
    replica, every in-flight request, every byte of device state is gone at
    once. The injector signals it by raising :class:`PowerLoss`; nothing
    in-process survives to "handle" it — recovery happens out-of-band from
    the write-ahead journal + warm snapshot (``serve.durability.run_durable``
    catches the exception, truncates the journal to its last fsync'd byte,
    and rebuilds a fresh fleet via ``Router.recover``).
  * ``"restart"`` — the tick at which the rebuilt fleet resumes serving.
    Optional (a plan may power off forever); when present it must follow a
    ``poweroff``, validated exactly like crash/rejoin pairing. On the
    post-recovery injector the event is a no-op marker: the recovery it
    names has already happened by the time the tick is reached.

Fleet-wide events take no ``:rN`` field (``replica`` is the ``-1``
sentinel). Window state for per-replica faults (slow/stall/pressure) is
in-RAM and dies with the process: a window straddling a poweroff does not
resume after recovery — real machines forget their throttling too.

Plan spec grammar (the ``launch/serve --faults`` format), whitespace- or
comma-separated events::

    kind@tick[+duration]:rREPLICA[:xFACTOR][:pPAGES]
    poweroff@tick  restart@tick

    crash@40:r1  rejoin@90:r1  slow@10+30:r0:x3  stall@15+4:r2
    pressure@20+10:r0:p4  poweroff@30 restart@34
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

FAULT_KINDS = ("crash", "slow", "stall", "pressure", "rejoin")
FLEET_FAULT_KINDS = ("poweroff", "restart")
_ALL_KINDS = FAULT_KINDS + FLEET_FAULT_KINDS


class PowerLoss(Exception):
    """Raised by :meth:`FaultInjector.begin_tick` when a ``poweroff`` event
    fires: the whole fleet fail-stops at ``tick``. ``restart_tick`` is the
    plan's next scheduled ``restart`` (None = off forever). In-process
    state must be treated as lost; only the journal's fsync'd prefix and
    the last completed snapshot survive."""

    def __init__(self, tick: int, restart_tick: Optional[int] = None):
        super().__init__(f"fleet power loss at tick {tick}"
                         + (f", restart at {restart_tick}"
                            if restart_tick is not None else ""))
        self.tick = tick
        self.restart_tick = restart_tick


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: ``kind`` fires at fleet tick ``tick`` on
    ``replica``. ``duration`` bounds the slow/stall/pressure window;
    ``factor`` is the slow replica's step divisor; ``pages`` the pressure
    shock's seized page count."""

    tick: int
    kind: str
    replica: int = -1          # -1 = fleet-wide (poweroff / restart)
    duration: int = 0
    factor: int = 2
    pages: int = 0

    def __post_init__(self):
        if self.kind not in _ALL_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_ALL_KINDS}")
        if self.kind in FLEET_FAULT_KINDS:
            if self.tick < 0:
                raise ValueError(f"fault tick must be >= 0: {self}")
            if self.replica != -1:
                raise ValueError(f"{self.kind} is fleet-wide and takes no "
                                 f"replica: {self}")
            return
        if self.tick < 0 or self.replica < 0:
            raise ValueError(f"fault tick/replica must be >= 0: {self}")
        if self.kind in ("slow", "stall", "pressure") and self.duration < 1:
            raise ValueError(f"{self.kind} fault needs duration >= 1: {self}")
        if self.kind == "slow" and self.factor < 2:
            raise ValueError(f"slow fault needs factor >= 2: {self}")
        if self.kind == "pressure" and self.pages < 1:
            raise ValueError(f"pressure fault needs pages >= 1: {self}")


class FaultPlan:
    """An ordered, validated script of :class:`FaultEvent`. Plans are data:
    build programmatically, or parse the compact CLI spec with
    :meth:`parse`."""

    def __init__(self, events: List[FaultEvent]):
        self.events = sorted(events, key=lambda e: (e.tick, e.replica,
                                                    _ALL_KINDS.index(e.kind)))
        down: set = set()
        fleet_down = False
        for e in self.events:
            if e.kind == "crash":
                if e.replica in down:
                    raise ValueError(f"replica r{e.replica} crashed twice "
                                     f"without a rejoin (tick {e.tick})")
                down.add(e.replica)
            elif e.kind == "rejoin":
                if e.replica not in down:
                    raise ValueError(f"rejoin of r{e.replica} at tick "
                                     f"{e.tick} without a prior crash")
                down.discard(e.replica)
            elif e.kind == "poweroff":
                if fleet_down:
                    raise ValueError(f"fleet powered off twice without a "
                                     f"restart (tick {e.tick})")
                fleet_down = True
            elif e.kind == "restart":
                if not fleet_down:
                    raise ValueError(f"restart at tick {e.tick} without a "
                                     f"prior poweroff")
                fleet_down = False

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    def events_at(self, tick: int) -> List[FaultEvent]:
        return [e for e in self.events if e.tick == tick]

    def max_replica(self) -> int:
        return max((e.replica for e in self.events), default=-1)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the CLI grammar (module docstring): e.g.
        ``"crash@40:r1 rejoin@90:r1 slow@10+30:r0:x3"``."""
        events = []
        for tok in spec.replace(",", " ").split():
            try:
                head, _, rest = tok.partition(":")
                kind, _, when = head.partition("@")
                tick, _, dur = when.partition("+")
                if kind in FLEET_FAULT_KINDS:
                    if rest or dur:
                        raise ValueError(f"{kind} is fleet-wide: bare "
                                         f"{kind}@tick only")
                    events.append(FaultEvent(tick=int(tick), kind=kind))
                    continue
                fields = rest.split(":")
                if not fields or not fields[0].startswith("r"):
                    raise ValueError("missing :rN replica field")
                kw = dict(tick=int(tick), kind=kind,
                          replica=int(fields[0][1:]))
                if dur:
                    kw["duration"] = int(dur)
                for f in fields[1:]:
                    if f.startswith("x"):
                        kw["factor"] = int(f[1:])
                    elif f.startswith("p"):
                        kw["pages"] = int(f[1:])
                    else:
                        raise ValueError(f"unknown modifier {f!r}")
                events.append(FaultEvent(**kw))
            except (ValueError, IndexError) as err:
                raise ValueError(f"bad fault spec token {tok!r}: {err}") \
                    from None
        return cls(events)

    @classmethod
    def crash_of_one(cls, replica: int, at: int,
                     rejoin_at: Optional[int] = None) -> "FaultPlan":
        """The benchmark's canonical plan: one replica crashes at ``at``,
        optionally rejoining (cold) at ``rejoin_at``."""
        events = [FaultEvent(tick=at, kind="crash", replica=replica)]
        if rejoin_at is not None:
            events.append(FaultEvent(tick=rejoin_at, kind="rejoin",
                                     replica=replica))
        return cls(events)

    @classmethod
    def poweroff_at(cls, at: int,
                    restart_at: Optional[int] = None) -> "FaultPlan":
        """The durability benchmark's canonical plan: the whole fleet
        fail-stops at ``at``, optionally resuming (post-recovery) at
        ``restart_at``."""
        events = [FaultEvent(tick=at, kind="poweroff")]
        if restart_at is not None:
            events.append(FaultEvent(tick=restart_at, kind="restart"))
        return cls(events)

    def restart_after(self, tick: int) -> Optional[int]:
        """Tick of the first ``restart`` event strictly after ``tick``
        (None if the plan stays dark)."""
        for e in self.events:
            if e.kind == "restart" and e.tick > tick:
                return e.tick
        return None


class FaultInjector:
    """Applies a :class:`FaultPlan` to a router fleet, one call per fleet
    tick (``Router.step`` drives it). The injector *causes* faults — it
    never tells the router about them: crash detection is the router's own
    missed-deadline health machine, exactly as it would be across a real IPC
    boundary. ``engine_factory() -> Engine`` builds the fresh replica a
    ``rejoin`` event swaps in (required only if the plan contains one)."""

    def __init__(self, plan: FaultPlan,
                 engine_factory: Optional[Callable] = None):
        self.plan = plan
        self.engine_factory = engine_factory
        if engine_factory is None and any(e.kind == "rejoin" for e in plan):
            raise ValueError("plan contains a rejoin event: the injector "
                             "needs an engine_factory to build the fresh "
                             "replica")
        self.crashed: set = set()
        self._slow: dict = {}        # replica -> (start, until, factor)
        self._stalled: dict = {}     # replica -> until
        self._pressured: dict = {}   # replica -> (until, alloc, npages)
        self.crashes = 0
        self.rejoins = 0
        self.stalls = 0
        self.slowdowns = 0
        self.pressure_shocks = 0
        self.pages_seized = 0
        self.poweroffs = 0

    def begin_tick(self, router) -> None:
        """Fire this tick's events and expire elapsed windows. Called by
        ``Router.step`` before placement, so a tick-T fault is visible to
        tick-T scheduling decisions exactly like a real failure would be."""
        t = router.tick
        for i, (until, alloc, n) in list(self._pressured.items()):
            if t >= until:
                alloc.restore(n)
                del self._pressured[i]
        for i, until in list(self._stalled.items()):
            if t >= until:
                del self._stalled[i]
        for i, (_, until, _) in list(self._slow.items()):
            if t >= until:
                del self._slow[i]
        for e in self.plan.events_at(t):
            if e.kind == "poweroff":
                # the lights go out mid-tick: no cleanup, no goodbye — the
                # caller's process state is dead and recovery is out-of-band
                # (journal + snapshot via serve.durability)
                self.poweroffs += 1
                raise PowerLoss(t, self.plan.restart_after(t))
            if e.kind == "restart":
                continue       # recovery already happened before this tick
            if e.replica >= len(router.engines):
                raise ValueError(f"fault targets replica r{e.replica} but "
                                 f"the fleet has {len(router.engines)}")
            if e.kind == "crash":
                self.crashed.add(e.replica)
                self.crashes += 1
            elif e.kind == "rejoin":
                self.crashed.discard(e.replica)
                router.rejoin(e.replica, self.engine_factory())
                self.rejoins += 1
            elif e.kind == "slow":
                self._slow[e.replica] = (t, t + e.duration, e.factor)
                self.slowdowns += 1
            elif e.kind == "stall":
                self._stalled[e.replica] = t + e.duration
                self.stalls += 1
            elif e.kind == "pressure":
                alloc = router.engines[e.replica].alloc
                taken = alloc.seize(e.pages)
                self._pressured[e.replica] = (t + e.duration, alloc, taken)
                self.pressure_shocks += 1
                self.pages_seized += taken

    def can_step(self, i: int, tick: int) -> bool:
        """May replica ``i`` advance this fleet tick? False while crashed or
        stalled; a slow replica steps once every ``factor`` ticks."""
        if i in self.crashed or i in self._stalled:
            return False
        if i in self._slow:
            start, _, factor = self._slow[i]
            return (tick - start) % factor == 0
        return True

    def stats(self) -> dict:
        return {
            "fault_events": len(self.plan),
            "crashes": self.crashes,
            "rejoins": self.rejoins,
            "stalls": self.stalls,
            "slowdowns": self.slowdowns,
            "pressure_shocks": self.pressure_shocks,
            "pages_seized": self.pages_seized,
            "poweroffs": self.poweroffs,
        }
