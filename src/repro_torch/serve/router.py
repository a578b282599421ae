"""Global placement router over N engine replicas — the paper's immune
primitives lifted from per-engine admission to fleet-level load balancing
(PyTorch port of ``repro/serve/router.py``).

A single-process harness holding ``N`` independent ``Engine`` replicas, one
global arrival queue, and a per-tick router step that places each queued
request on a replica before the replicas advance in lockstep (router tick ==
engine tick, so every latency stays in deterministic, machine-independent
ticks). On the card every replica shares the one device and reads one
parameter set; each holds its own K/V page pool. The fleet's control state
(health, queues, journal books, the immune EMAs the policies read) stays on
the host.

Placement policies (``RouterConfig.policy``), the A/B set the routing
benchmark gates:

  * ``"rr"``  — round-robin: the memoryless baseline of the dynamic
    load-balancing taxonomy (Mandal & Pal, arXiv:1109.1650) — placement
    ignores both state and history.
  * ``"jsq"`` — join-shortest-queue: the classic state-but-no-history
    policy; place on the replica with the fewest queued+resident requests.
  * ``"immune"`` — the paper's primitives as a placement policy, three
    signals read straight off each replica's serving state:

      1. **Prefix affinity** (immune memory over KV state): the replica whose
         page pool — live shared chains or the pinned prefix cache — already
         holds the longest resident prefix of the request's prompt wins
         (``Engine.prefix_affinity``); routing there skips exactly that much
         prefill, the fleet-level form of "work the population has already
         seen is recognized and not re-paid". An affinity placement is still
         load-aware: a replica whose backlog exceeds
         ``affinity_queue_cap * num_slots`` forfeits its affinity claim, so a
         hot tenant cannot convoy one replica while the rest idle.
      2. **Anergy draining** (tolerance): a replica whose anergy level for
         the request's class exceeds ``drain_level`` is *drained* — no new
         placements of that class until IL-2 revives it locally. Placing
         there would only have the replica's own admission shed the request;
         the router moves the class's traffic to replicas still tolerant of
         it. If every replica holds the class anergic the least-anergic one
         is used (the request must land somewhere; counted in
         ``drain_overflow``).
      3. **Least remembered cost** (anticipation): with no affinity claim,
         place on the replica with the lowest *remembered* backlog — each
         queued/resident request priced at its class's cost EMA
         (``Engine.class_costs``, floored at ``cost_floor`` so cold classes
         still count as work). Per-class cost EMAs aggregated per replica are
         the load model: a replica holding two requests of a class that
         historically decodes 40 ticks is more loaded than one holding three
         5-tick chatters, which instantaneous queue length (jsq) cannot see.

**Health and failover** (all policies): each replica carries a health state
driven by missed step deadlines — ``healthy`` (eligible for placement),
``suspect`` after ``suspect_after`` consecutive missed fleet ticks (no *new*
placements; in-flight work stays, because a suspect replica usually
recovers), ``dead`` after ``dead_after`` (fenced: never stepped again —
declared deaths are never un-declared, a restarted process must ``rejoin``
as a fresh replica). Declaring a death triggers **failover**: the dead
replica's in-flight and queued requests are evacuated
(``Engine.evacuate``) and re-placed on survivors, where the preemption
machinery recovers them exactly — re-prefill the proven prompt,
replay the recorded tokens through decode (same lane key, same fold
indices). Each re-placement spends one unit of the request's retry budget
(``max_retries``, exponential ``retry_backoff`` between attempts beyond the
first); a request that outlives its budget terminates with
``finish_reason="failed"`` — failure is an accounted outcome, never a
silently dropped rid. Requests keep their original ``arrival`` and
``submit_time`` across re-placement, so victim scoring still sees their true
seniority (a recovering request is never the "latest arrival" to evict
first) and latency accounting spans crash + replay.

**Graceful degradation** (immune replicas): while any replica is dead, the
router injects anergy stimulus for ``degrade_classes`` into every survivor
(``ImmuneAdmission.degrade``) — capacity loss is fleet-wide stress, and the
tolerance machinery sheds the classes the operator marked sheddable before
interactive traffic browns out. When capacity returns the stimulus stops and
IL-2 revives the classes in the next quiet period, the same revival path as
ordinary anergy.

Faults themselves are scripted by ``serve.faults`` (`FaultPlan` /
``FaultInjector``), which *causes* crashes/stalls/slowdowns but never
announces them — detection is this router's missed-deadline machine, as it
would be across a real IPC boundary.

Placement never changes what a request computes — admission, preemption,
replay and failover re-placement inside each replica are untouched — so
per-request tokens are identical across policies, replica counts
*and fault plans* (the engine-vs-oneshot parity oracle lifted one level).

**Durability** (``attach_durability`` / ``recover``): with a
``serve.durability.RequestJournal`` attached, ``submit`` write-ahead-logs
every accepted request (fsync'd before placement — an acknowledged rid is
never lost) and the end of each ``step`` journals the tick's emitted tokens
and terminal outcomes under one group commit, plus a warm snapshot of the
fleet's *learned* state (pinned prefix forests + K/V, immune memories,
health/retry books) every ``snapshot_every`` ticks. After a full-fleet power
loss, :meth:`Router.recover` on a fresh fleet replays the journal's durable
prefix — finished rids are reconstructed, deduplicated and **not** re-run;
unfinished rids re-enter through the prefill-recompute + token-replay path,
identical to an uninterrupted run — and imports the snapshot so the
caches and memories resume warm. See ``serve.durability`` for the formats
and ``run_durable`` for the crash-restart driver.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np

from . import durability as _dur
from . import groups as _groups
from .api import RequestOutput, SamplingParams, ServeRequest
from .engine import Engine

POLICIES = ("immune", "rr", "jsq")

HEALTHY, SUSPECT, DEAD = "healthy", "suspect", "dead"


class RouterConfig(NamedTuple):
    policy: str = "immune"        # "immune" | "rr" | "jsq"
    drain_level: float = 0.5      # anergy level above which a replica is
    #                               drained for that class (immune policy)
    affinity_min_tokens: int = 1  # resident prompt positions before an
    #                               affinity claim beats the load model
    affinity_queue_cap: float = 2.0  # an affinity replica with more than
    #                               cap*num_slots queued+resident requests
    #                               forfeits its claim (anti-convoy)
    cost_floor: float = 1.0       # minimum per-request price in the
    #                               remembered-cost load model (cold classes)
    suspect_after: int = 2        # consecutive missed fleet ticks before a
    #                               replica stops receiving new placements
    dead_after: int = 6           # missed ticks before it is declared dead,
    #                               fenced, and its requests re-placed (must
    #                               exceed any tolerated straggler factor)
    max_retries: int = 3          # crash re-placements per request before a
    #                               terminal finish_reason="failed"
    retry_backoff: int = 2        # ticks of exponential backoff between
    #                               re-placements beyond the first
    degrade_classes: tuple = ()   # classes shed fleet-wide while capacity is
    #                               lost (graceful degradation; empty: off)
    degrade_gain: float = 3.0     # anergy stimulus per fraction of dead
    #                               replicas (3.0: one dead of three -> full)


class Router:
    """One global queue over ``engines``; ``step()`` places then advances the
    fleet one tick. Drive with :meth:`run`, read :meth:`stats`. An optional
    ``injector`` (``serve.faults.FaultInjector``) scripts replica faults;
    health tracking and failover run regardless — a fleet without an
    injector simply never sees a missed deadline."""

    def __init__(self, engines: List[Engine],
                 rcfg: RouterConfig = RouterConfig(),
                 injector=None):
        if not engines:
            raise ValueError("router needs at least one engine replica")
        if rcfg.policy not in POLICIES:
            raise ValueError(f"unknown router policy {rcfg.policy!r}; "
                             f"expected one of {POLICIES}")
        self.engines = list(engines)
        self.rcfg = rcfg
        self.injector = injector
        self.queue: deque[ServeRequest] = deque()
        self.tick = 0
        self.submitted = 0
        self.unsubmitted = 0             # run() arrivals never reached
        self.placements = np.zeros(len(engines), np.int64)
        self.affinity_checks = 0         # immune placements that probed affinity
        self.affinity_hits = 0           # placements decided by prefix affinity
        self.affinity_tokens = 0         # resident prompt positions at those hits
        self.drain_skips = 0             # placements redirected off a drained replica
        self.drain_overflow = 0          # all replicas drained -> least-anergic
        self._rr_next = 0
        # health / failover state
        self.health: list = [HEALTHY] * len(engines)
        self.last_step: list = [-1] * len(engines)   # last fleet tick stepped
        self.fallen: List[Engine] = []   # dead engines replaced by a rejoin —
        #                                  their host books stay so completed
        #                                  requests count; device state freed
        self.failed: list = []           # retry budget exhausted (terminal)
        self._retry: list = []           # backoff heap: (ready_tick, rid, req)
        self.deaths = 0                  # replicas declared dead
        self.rejoins = 0                 # fresh replicas swapped in
        self.death_ticks: list = []      # when each death was declared
        self.replaced_rids: set = set()  # requests ever evacuated by failover
        self.total_retries = 0           # re-placements actually performed
        # durability (attach_durability / recover)
        self.journal = None              # serve.durability.RequestJournal
        self.snapshot_dir: Optional[str] = None
        self.snapshot_every = 0
        self._journal_counts: dict = {}  # rid -> out_tokens already journaled
        self._fin_logged: set = set()    # rids with a terminal record journaled
        self.recovered: list = []        # finished requests reconstructed from
        #                                  the journal at recover() — replayed
        #                                  into the books, never re-run
        self.recovered_open = 0          # unfinished rids re-entered for replay
        self.recovered_pages = 0         # pinned pages restored warm
        self.dedup_drops = 0             # submits dropped: rid already terminal
        self.snapshots = 0               # warm snapshots written this run
        # slot groups (serve.groups): parents expand at submit, members are
        # pinned to one replica, parents assemble when every lane is terminal
        self.group_book = _groups.GroupBook()
        self.group_outputs: list = []    # assembled parent RequestOutputs
        self._group_replica: dict = {}   # gid -> replica index (co-placement)
        self._failed_groups: set = set()  # gids with a retry-exhausted member
        self.groups_submitted = 0
        self.group_coplacements = 0      # members routed by the group pin

    # -- placement -----------------------------------------------------------
    def _load(self, eng: Engine) -> float:
        """Remembered-cost backlog of a replica: every queued/resident request
        priced at its class's cost EMA (anticipation, not instantaneous
        occupancy)."""
        costs = eng.class_costs()
        resident = [r for r in eng.slots if r is not None]
        return float(sum(max(float(costs[r.rclass]), self.rcfg.cost_floor)
                         for r in list(eng.queue) + resident))

    def _eligible(self) -> list:
        """Replica indices placement may use: healthy ones. A suspect replica
        keeps its in-flight work (it usually recovers) but gets nothing new;
        a dead one is fenced. Empty when no replica is healthy — the queue
        then holds until health returns (or a rejoin arrives)."""
        return [i for i, h in enumerate(self.health) if h == HEALTHY]

    def _place_immune(self, req: ServeRequest, eligible: list) -> int:
        # 1) prefix affinity, forfeited by an over-backlogged replica
        self.affinity_checks += 1
        best_aff, best_i = 0, -1
        for i in eligible:
            eng = self.engines[i]
            cap = self.rcfg.affinity_queue_cap * eng.ecfg.num_slots
            if eng.occupancy() > cap:
                continue
            aff = eng.prefix_affinity(req)
            if aff > best_aff:
                best_aff, best_i = aff, i
        if best_aff >= self.rcfg.affinity_min_tokens:
            self.affinity_hits += 1
            self.affinity_tokens += best_aff
            return best_i
        # 2) anergy draining: exclude replicas anergic for this class
        levels = {i: float(self.engines[i].anergy_levels()[req.rclass])
                  if req.rclass < self.engines[i].ecfg.num_classes else 0.0
                  for i in eligible}
        live = [i for i in eligible if levels[i] <= self.rcfg.drain_level]
        if not live:                      # the request must land somewhere
            self.drain_overflow += 1
            live = [min(eligible, key=lambda i: (levels[i], i))]
        elif len(live) < len(eligible):
            self.drain_skips += 1
        # 3) least remembered cost among the live replicas
        return min(live, key=lambda i: (self._load(self.engines[i]), i))

    def _place(self, req: ServeRequest) -> int:
        """Pick the replica index for ``req`` under the configured policy
        (healthy replicas only; -1 when none is). With every replica healthy
        each policy behaves exactly as it did without health tracking.

        Slot-group members are pinned: the first member placed decides the
        replica for the whole group (prefix sharing, cascade preemption and
        joint cancellation are all per-engine machinery — splitting a group
        across replicas would forfeit every one of them). A later member whose
        pinned replica has gone suspect holds in the queue rather than defect;
        a death clears the pin and the group re-places together."""
        if req.group >= 0:
            j = self._group_replica.get(req.group, -1)
            if j >= 0:
                if self.health[j] == HEALTHY:
                    self.group_coplacements += 1
                    return j
                return -1
        i = self._place_policy(req)
        if req.group >= 0 and i >= 0:
            self._group_replica[req.group] = i
        return i

    def _place_policy(self, req: ServeRequest) -> int:
        eligible = self._eligible()
        if not eligible:
            return -1
        if self.rcfg.policy == "rr":
            for _ in range(len(self.engines)):   # skip fenced/suspect slots
                i = self._rr_next
                self._rr_next = (i + 1) % len(self.engines)
                if self.health[i] == HEALTHY:
                    return i
            return eligible[0]
        if self.rcfg.policy == "jsq":
            return min(eligible,
                       key=lambda i: (self.engines[i].occupancy(), i))
        return self._place_immune(req, eligible)

    # -- health / failover ---------------------------------------------------
    def _declare_dead(self, i: int) -> None:
        """Fence replica ``i`` and fail its work over to the survivors. The
        evacuated request objects carry everything recovery needs (prompt +
        recorded tokens); re-admission elsewhere replays them exactly. Each
        evacuation costs a retry; past ``max_retries`` the request terminates
        with ``finish_reason="failed"`` instead of bouncing forever."""
        self.health[i] = DEAD
        self.deaths += 1
        self.death_ticks.append(self.tick)
        for gid, rep in list(self._group_replica.items()):
            if rep == i:               # the group re-places (together) on a
                del self._group_replica[gid]   # survivor
        evacuated = list(self.engines[i].evacuate())
        for req in evacuated:
            self.replaced_rids.add(req.rid)
            req.retries += 1
            if req.retries > self.rcfg.max_retries:
                self._fail(req)
        for req in evacuated:
            if req.finish_reason == "failed":
                continue
            if req.group >= 0 and req.group in self._failed_groups:
                self._fail(req)        # joint retirement: a sibling exhausted
                continue               # its budget, the group fails whole
            self.total_retries += 1
            if req.admit_tick >= 0 and req.preempt_tick < 0:
                # held a slot: its re-queue wait is accounted like a
                # preemption's (requeue_ticks on re-admission)
                req.preempt_tick = self.tick
            delay = 0 if req.retries == 1 else \
                self.rcfg.retry_backoff * (1 << (req.retries - 2))
            if delay > 0:
                heapq.heappush(self._retry,
                               (self.tick + 1 + delay, req.rid, req))
            else:
                self.queue.append(req)

    def _fail(self, req: ServeRequest) -> None:
        """Terminal ``finish_reason="failed"``; a member's failure marks the
        whole group so its siblings fail jointly wherever they currently are
        (evacuation batch, retry backoff, or the router queue)."""
        req.finish_reason = "failed"
        req.finish_tick = self.tick
        self.failed.append(req)
        if req.group >= 0:
            self._failed_groups.add(req.group)

    def _check_health(self) -> None:
        """End-of-tick health transitions from missed step deadlines. Death
        is detected, never announced — a crashed replica just stops stepping,
        and this is the only place the fleet finds out."""
        for i in range(len(self.engines)):
            if self.health[i] == DEAD:
                continue
            missed = self.tick - self.last_step[i]
            if missed >= self.rcfg.dead_after:
                self._declare_dead(i)
            elif missed >= self.rcfg.suspect_after:
                self.health[i] = SUSPECT
            else:
                self.health[i] = HEALTHY

    def _degrade(self) -> None:
        """While capacity is down, shed the operator-marked classes on every
        survivor: anergy stimulus scaled by the dead fraction of the fleet,
        reapplied each tick so the brown-out tracks the outage and IL-2
        revival takes over the moment it ends."""
        if not self.rcfg.degrade_classes:
            return
        dead = sum(1 for h in self.health if h == DEAD)
        if not dead:
            return
        sev = min(1.0, self.rcfg.degrade_gain * dead / len(self.engines))
        for i, eng in enumerate(self.engines):
            if self.health[i] != DEAD and eng.admission is not None:
                eng.admission.degrade(self.rcfg.degrade_classes, sev)

    def rejoin(self, i: int, engine: Engine) -> None:
        """Swap a *fresh* engine into replica slot ``i`` (a restarted
        process: cold pinned cache, blank immune state). A replica is
        replaced, never resumed — whatever the old process held is gone; if
        the health machine had not yet declared the death (a fast restart),
        it is declared now so the old in-flight work is recovered first. The
        newcomer starts healthy with a fresh deadline clock; prefix-affinity
        traffic rewarms its pinned cache from the live traffic stream. The
        replaced engine keeps its host books (its completions stay in
        :meth:`stats`) and frees its device pool."""
        if self.health[i] != DEAD:
            self._declare_dead(i)
        self.engines[i].drop_device_state()
        self.fallen.append(self.engines[i])
        self.engines[i] = engine
        engine.tick = self.tick
        self.health[i] = HEALTHY
        self.last_step[i] = self.tick - 1
        self.rejoins += 1

    # -- driving -------------------------------------------------------------
    def submit(self, req: ServeRequest):
        """Queue a request with the router; it is placed on a replica at the
        next :meth:`step`. With a journal attached the request is
        write-ahead-logged (and fsync'd) before it can be placed, and a rid
        the journal already holds a terminal record for is dropped — the
        exactly-once half of the recovery contract (a re-driven trace can
        never duplicate a completion).

        A group parent (``n``/``best_of`` > 1) expands here: the *members*
        are what the fleet journals, places and schedules; the parent is
        registered with the router's :class:`serve.groups.GroupBook` and its
        output assembles when the last lane lands. Expansion is deterministic
        (member rids derive from the parent rid), so a re-driven trace's
        members dedup against the journal exactly like plain rids."""
        if req.params.group_size > 1 and req.group < 0:
            members = _groups.expand(req)
            if all(m.rid in self._fin_logged for m in members):
                self.dedup_drops += 1
                return
            self.group_book.register(req)
            self.groups_submitted += 1
            for m in members:
                self._submit_one(m, parent=req)
            return
        self._submit_one(req)

    def _submit_one(self, req: ServeRequest,
                    parent: Optional[ServeRequest] = None):
        if self.journal is not None:
            if req.rid in self._fin_logged:
                self.dedup_drops += 1
                return
            if req.rid in self._journal_counts:
                return                 # already recovered open — re-queued by
                #                        recover(), not by re-submission
            self.journal.log_submit(req, parent=parent)
            self._journal_counts[req.rid] = len(req.out_tokens)
        self.queue.append(req)
        self.submitted += 1

    def step(self):
        """One fleet tick: fire scripted faults, release expired retry
        backoffs, place every queued request on a healthy replica, advance
        the non-fenced replicas in lockstep (minus those the injector holds
        back), then run the health machine and the degradation signal."""
        if self.injector is not None:
            self.injector.begin_tick(self)
        while self._retry and self._retry[0][0] <= self.tick:
            self.queue.append(heapq.heappop(self._retry)[2])
        while self.queue:
            req = self.queue[0]
            if req.group >= 0 and req.group in self._failed_groups:
                self.queue.popleft()   # joint retirement: a sibling already
                self._fail(req)        # failed, this lane never re-places
                continue
            i = self._place(req)
            if i < 0:                  # no healthy replica: hold the queue
                break
            self.queue.popleft()
            self.placements[i] += 1
            self.engines[i].submit(req)
        for i, eng in enumerate(self.engines):
            if self.health[i] == DEAD:
                continue               # fenced: a dead replica never steps
            # lockstep clock: even a held-back replica's tick tracks the
            # fleet's, so tick latencies stay fleet-global through stalls,
            # slowdowns and rejoins
            eng.tick = self.tick
            if self.injector is None or self.injector.can_step(i, self.tick):
                eng.step()
                self.last_step[i] = self.tick
        self._check_health()
        self._degrade()
        self._assemble_groups()
        if self.journal is not None:
            self._journal_tick()
        self.tick += 1

    # -- slot groups ---------------------------------------------------------
    def _member_output(self, req: ServeRequest) -> RequestOutput:
        """Terminal RequestOutput for a group member, for parent assembly.
        The fleet drives engines with ``step()`` rather than ``stream()``, so
        member outputs are built here from the retired request objects."""
        done = req.finish_reason in ("stop", "length")
        return RequestOutput(
            rid=req.rid, new_tokens=[], tokens=list(req.out_tokens),
            finished=True, finish_reason=req.finish_reason,
            tick=req.finish_tick, arrival=req.arrival,
            admit_tick=req.admit_tick, finish_tick=req.finish_tick,
            latency_ticks=req.latency if done else None,
            wall_latency_s=req.wall_latency_s if done else None,
            logprobs=list(req.out_logprobs) if req.out_logprobs else None,
            top_logprobs=list(req.out_topk) if req.out_topk else None,
            preemptions=req.preemptions, requeue_ticks=req.requeue_ticks)

    def _assemble_groups(self) -> None:
        """Offer every terminal member the fleet knows about to the group
        book; a parent whose last lane has landed assembles into
        :attr:`group_outputs` (joint finish — an abnormal lane fails the
        whole group). Idempotent: an assembled gid absorbs re-offers
        silently, so scanning the terminal books each tick is safe."""
        if not self.group_book.pending():
            return
        for req in list(self._terminal_requests()) + self.recovered:
            if req.group < 0:
                continue
            done = self.group_book.offer(req, self._member_output(req))
            if done is not None:
                self.group_outputs.append(done)
                self._group_replica.pop(req.group, None)

    def _drained(self) -> bool:
        return not self.queue and not self._retry and all(
            not eng.queue and not eng.jobs
            and all(r is None for r in eng.slots) for eng in self.engines)

    def run(self, requests: list, max_ticks: int = 10_000) -> dict:
        """Open-loop drive mirroring ``Engine.run``: submit each request at
        its ``arrival`` tick, step until the fleet drains (or ``max_ticks``);
        returns :meth:`stats`."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        i = 0
        while True:
            while i < len(pending) and pending[i].arrival <= self.tick:
                self.submit(pending[i])
                i += 1
            self.unsubmitted = len(pending) - i
            if (i == len(pending) and self._drained()) \
                    or self.tick >= max_ticks:
                break
            self.step()
        return self.stats()

    # -- durability ----------------------------------------------------------
    def attach_durability(self, journal, snapshot_dir: Optional[str] = None,
                          snapshot_every: int = 0) -> None:
        """Arm the write-ahead journal (and, optionally, a warm-snapshot
        cadence) on this router. Call before driving; ``run_durable`` does."""
        self.journal = journal
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = int(snapshot_every)

    def _terminal_requests(self):
        """Every request the fleet has retired with a terminal reason —
        completions, sheds, rejections, corruptions across live + fallen
        replicas, plus the router's own retry-exhausted failures."""
        for eng in self.engines + self.fallen:
            yield from eng.completed
            yield from eng.shed
            yield from eng.rejected
            yield from eng.corrupted
        yield from self.failed

    def _journal_emits(self, req: ServeRequest) -> None:
        n = self._journal_counts.get(req.rid, 0)
        for tok in req.out_tokens[n:]:
            self.journal.log_emit(req.rid, int(tok))
        if len(req.out_tokens) > n:
            self._journal_counts[req.rid] = len(req.out_tokens)

    def _journal_tick(self) -> None:
        """End-of-tick journal pass: append this tick's emitted tokens (the
        delta past each rid's journaled count) and any new terminal records,
        then group-commit; every ``snapshot_every`` ticks, also write the
        warm snapshot. Losing an unsynced emit costs replay recompute, never
        correctness — decode re-derives the identical token."""
        for eng in self.engines:
            for req in eng.slots:
                if req is not None and req.rid in self._journal_counts:
                    self._journal_emits(req)
        for req in self._terminal_requests():
            if req.rid in self._fin_logged \
                    or req.rid not in self._journal_counts:
                continue
            self._journal_emits(req)
            self.journal.log_finish(req.rid, req.finish_reason or "stop",
                                    req.finish_tick)
            self._fin_logged.add(req.rid)
        self.journal.commit(self.tick)
        if (self.snapshot_dir and self.snapshot_every
                and self.tick and self.tick % self.snapshot_every == 0):
            self._save_snapshot()

    def _save_snapshot(self) -> None:
        """Snapshot the fleet's learned state + the router's failover books.
        Request state is deliberately absent (the journal owns it); the
        per-rid retry counts ride along so a recovered request keeps its
        spent budget. Export only reads device state — no decode stall."""
        metas, kv = [], []
        for eng in self.engines:
            m, k = eng.export_warm_state()
            metas.append(m)
            kv.extend(k)
        open_reqs = [r for eng in self.engines
                     for r in list(eng.queue)
                     + [j.req for j in eng.jobs]
                     + [s for s in eng.slots if s is not None]] \
            + list(self.queue) + [r for _, _, r in self._retry]
        blob = {
            "tick": self.tick,
            "policy": self.rcfg.policy,
            "replicas": metas,
            "router": {
                "deaths": self.deaths,
                "rejoins": self.rejoins,
                "death_ticks": list(self.death_ticks),
                "replaced_rids": sorted(self.replaced_rids),
                "total_retries": self.total_retries,
                "retries": {str(r.rid): r.retries
                            for r in open_reqs if r.retries},
            },
        }
        _dur.save_snapshot(self.snapshot_dir, self.tick, blob, kv)
        self.snapshots += 1

    def recover(self, journal, snapshot: Optional[str] = None) -> dict:
        """Rebuild this (fresh) fleet from a recovered journal plus the
        newest warm snapshot. Journal-finished rids become reconstructed
        request objects in :attr:`recovered` — in the books, never re-run
        (exactly-once). Unfinished rids are rebuilt with their journaled
        token prefix and re-enqueued in ``(arrival, rid)`` order; admission
        re-prefills their proven prompt and replays the recorded tokens
        through decode, so their eventual streams are identical to a
        run that never lost power. The snapshot re-pins the prefix forest
        (K/V scattered straight back — zero recompute), resumes the immune
        EMAs, and restores the failover books. ``submit_time`` is NOT
        restored: ``perf_counter`` is process-relative, so a pre-loss wall
        clock would be meaningless here."""
        if self.journal is None:
            self.attach_durability(journal)
        sdir = snapshot if snapshot is not None else self.snapshot_dir
        blob, kv, _ = _dur.load_snapshot(sdir) if sdir else (None, [], 0)
        retries: dict = {}
        if blob is not None:
            rb = blob.get("router") or {}
            self.deaths = int(rb.get("deaths") or 0)
            self.rejoins = int(rb.get("rejoins") or 0)
            self.death_ticks = list(rb.get("death_ticks") or [])
            self.replaced_rids = set(rb.get("replaced_rids") or [])
            self.total_retries = int(rb.get("total_retries") or 0)
            retries = {int(k): int(v)
                       for k, v in (rb.get("retries") or {}).items()}
            off = 0
            for i, m in enumerate(blob.get("replicas") or []):
                n = len(m.get("forest") or []) * int(m.get("kv_per_page") or 0)
                if i < len(self.engines):
                    self.recovered_pages += \
                        self.engines[i].import_warm_state(m, kv[off:off + n])
                off += n
            self.tick = max(self.tick, int(blob.get("tick") or 0))
        reopen = []
        for rid, rec in sorted(journal.state.items()):
            req = ServeRequest(
                rid=rid, tokens=np.asarray(rec["tokens"], np.int32),
                params=SamplingParams(**rec["params"]),
                rclass=int(rec.get("rclass") or 0),
                arrival=int(rec.get("arrival") or 0),
                deadline=rec.get("deadline"),
                group=int(rec.get("group", -1)),
                lane=int(rec.get("lane", 0)),
                group_size=int(rec.get("group_size", 1)))
            if req.group >= 0 and not self.group_book.has(req.group):
                # rebuild the parent from the member record's group metadata
                # and re-arm joint-finish assembly across the power loss
                pparams = dataclasses.replace(
                    req.params, n=int(rec.get("gn", 1)),
                    best_of=int(rec.get("gbest", 0)),
                    seed=req.params.seed - req.lane)
                parent = ServeRequest(
                    rid=req.group, tokens=req.tokens, params=pparams,
                    rclass=req.rclass, arrival=req.arrival,
                    deadline=req.deadline)
                self.group_book.register(parent)
                self.groups_submitted += 1
            req.out_tokens = list(rec["out"])
            self._journal_counts[rid] = len(req.out_tokens)
            if rec["fin"] is not None:
                req.finish_reason = rec["fin"]
                req.finish_tick = int(rec.get("fin_tick", -1))
                self._fin_logged.add(rid)
                self.recovered.append(req)
            else:
                req.retries = retries.get(rid, 0)
                reopen.append(req)
        for req in sorted(reopen, key=lambda r: (r.arrival, r.rid)):
            self.queue.append(req)
            self.submitted += 1
        self.recovered_open += len(reopen)
        return {"recovered_open": len(reopen),
                "recovered_finished": len(self.recovered),
                "recovered_pages": self.recovered_pages}

    # -- accounting ----------------------------------------------------------
    @property
    def completed(self) -> list:
        """All completed requests across the fleet — replaced (fallen)
        replicas included, their pre-crash completions are real, as are
        journal-recovered completions from before a power loss — rid
        order."""
        rec = [r for r in self.recovered
               if r.finish_reason in ("stop", "length")]
        return sorted((r for src in ([e.completed for e in
                                      self.engines + self.fallen] + [rec])
                       for r in src), key=lambda r: r.rid)

    def stats(self) -> dict:
        fleet = self.engines + self.fallen
        per = [eng.stats() for eng in self.engines]
        done = self.completed
        lat = np.asarray([r.latency for r in done], np.float64)
        toks = int(sum(len(r.out_tokens) for r in done))
        # journal-recovered completions are judged against the live fleet's
        # (uniform) tick budget; their wall clock did not survive the restart
        in_budget = sum(1 for eng in fleet for r in eng.completed
                        if eng._met_budget(r)) \
            + sum(1 for r in self.recovered
                  if r.finish_reason in ("stop", "length")
                  and self.engines[0]._met_budget(r))
        rec_by = {}
        for r in self.recovered:
            rec_by[r.finish_reason] = rec_by.get(r.finish_reason, 0) + 1
        shed = sum(len(eng.shed) for eng in fleet) + rec_by.get("shed", 0)
        rejected = sum(len(eng.rejected) for eng in fleet) \
            + rec_by.get("rejected", 0)
        corrupted = sum(len(eng.corrupted) for eng in fleet) \
            + rec_by.get("corrupted", 0)
        unserved = int(len(self.queue) + len(self._retry) + self.unsubmitted
                       + sum(p["unserved"] for p in per))
        failed = len(self.failed) + rec_by.get("failed", 0)
        demand = len(done) + shed + rejected + corrupted + unserved + failed
        # recovery: from the first declared death to the last re-placed
        # request's completion — how long the failover took to fully absorb
        redone = [r for r in done if r.rid in self.replaced_rids]
        recovery = (max(r.finish_tick for r in redone)
                    - min(self.death_ticks)) \
            if redone and self.death_ticks else 0
        empty = float("inf")
        place = self.placements
        return {
            "router": self.rcfg.policy,
            "replicas": len(self.engines),
            "ticks": self.tick,
            "completed": len(done),
            "shed": shed,
            "rejected": rejected,
            "corrupted": corrupted,
            "unserved": unserved,
            "failed": failed,
            "tokens": toks,
            "throughput": toks / max(self.tick, 1),
            "p50_latency": float(np.percentile(lat, 50)) if lat.size else empty,
            "p99_latency": float(np.percentile(lat, 99)) if lat.size else empty,
            "max_latency": float(lat.max()) if lat.size else empty,
            "goodput": in_budget / max(demand, 1),
            # placement telemetry: where traffic landed and why
            "placements": [int(c) for c in place],
            "placement_imbalance": float(place.max() / max(place.mean(), 1e-9))
            if place.sum() else 0.0,
            "affinity_checks": self.affinity_checks,
            "affinity_hits": self.affinity_hits,
            "affinity_hit_rate": self.affinity_hits
            / max(self.affinity_checks, 1),
            "affinity_tokens": self.affinity_tokens,
            "drain_skips": self.drain_skips,
            "drain_overflow": self.drain_overflow,
            # health / failover telemetry
            "health": list(self.health),
            "deaths": self.deaths,
            "rejoins": self.rejoins,
            "replaced_requests": len(self.replaced_rids),
            "retries": self.total_retries,
            "recovery_ticks": int(recovery),
            "faults": self.injector.stats()
            if self.injector is not None else None,
            # durability telemetry (None journal -> all-zero block)
            "durability": {
                "journal": self.journal.stats()
                if self.journal is not None else None,
                "recovered_finished": len(self.recovered),
                "recovered_open": self.recovered_open,
                "recovered_pinned_pages": self.recovered_pages,
                "dedup_drops": self.dedup_drops,
                "snapshots": self.snapshots,
            },
            # slot-group telemetry
            "groups": {
                "submitted": self.groups_submitted,
                "assembled": len(self.group_outputs),
                "pending": len(self.group_book.pending()),
                "coplacements": self.group_coplacements,
                "failed_groups": len(self._failed_groups),
            },
            # fleet-aggregated engine telemetry
            "prefill_tokens": sum(p["prefill_tokens"] for p in per),
            "preemptions": sum(p["preemptions"] for p in per),
            "replayed_tokens": sum(p["replayed_tokens"] for p in per),
            "pinned_pages_adopted": sum(p["pinned_pages_adopted"] for p in per),
            "per_replica": per,
        }
