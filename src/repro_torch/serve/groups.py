"""Slot groups: one request owning n engine lanes that share prompt pages
(PyTorch port of ``repro/serve/groups.py``).

A ``ServeRequest`` whose ``SamplingParams.n`` / ``best_of`` exceeds 1 is a
*parent*: it never occupies a slot itself. :func:`expand` turns it into
``group_size`` member requests — identical prompt (the same host array, so
the prefix index sees byte-identical pages and members adopt the lane-0
prefix registration refcount-only, charging the prompt's pages once),
per-lane seeds (lane 0 keeps the parent seed; lane ``i`` uses ``seed + i``),
and ``n=1`` member params so members schedule like ordinary requests
everywhere below the group layer.

Joint lifecycle: the engine admits lane 0 first (it prefills and registers
the shared prefix) and then the sibling lanes, which adopt those pages;
evicting one member cascades to its resident siblings; members finish
individually, but the parent output exists only when every lane is finished
(:class:`GroupBook`), and an abnormal member exit ("shed", "rejected",
"corrupted", "failed") retires the whole group with that reason.

Member rids are carved out of a reserved range (``GROUP_RID_BASE``) so they
never collide with caller-chosen parent rids.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from .api import RequestOutput, SamplingParams, ServeRequest

GROUP_RID_BASE = 1 << 40     # member rid = BASE + parent_rid * LANE_STRIDE + lane
LANE_STRIDE = 256            # hard cap on lanes per group (best_of/n < 256)


def member_rid(parent_rid: int, lane: int) -> int:
    if not 0 <= lane < LANE_STRIDE:
        raise ValueError(f"lane must be in [0, {LANE_STRIDE}), got {lane}")
    return GROUP_RID_BASE + parent_rid * LANE_STRIDE + lane


def is_member_rid(rid: int) -> bool:
    return rid >= GROUP_RID_BASE


def parent_rid_of(rid: int) -> int:
    return (rid - GROUP_RID_BASE) // LANE_STRIDE


def lane_of(rid: int) -> int:
    return (rid - GROUP_RID_BASE) % LANE_STRIDE


def member_params(parent: SamplingParams, lane: int) -> SamplingParams:
    """Per-lane params: n/best_of collapse to 1, the lane folds into the seed
    (lane 0 keeps the parent stream), and ``best_of`` ranking forces
    chosen-logprob recording so lanes are comparable."""
    lp = parent.logprobs
    if parent.best_of:
        lp = max(1, lp)
    return dataclasses.replace(parent, n=1, best_of=0,
                               seed=parent.seed + lane, logprobs=lp)


def expand(req: ServeRequest) -> List[ServeRequest]:
    """Expand a parent request into its member lane requests (idempotent on
    members: a request already carrying ``group >= 0`` or with group_size 1
    expands to ``[req]``)."""
    gs = req.params.group_size
    if gs <= 1 or req.group >= 0:
        return [req]
    return [ServeRequest(rid=member_rid(req.rid, lane), tokens=req.tokens,
                         params=member_params(req.params, lane),
                         rclass=req.rclass, arrival=req.arrival,
                         deadline=req.deadline, patches=req.patches,
                         frames=req.frames, group=req.rid, lane=lane,
                         group_size=gs)
            for lane in range(gs)]


ABNORMAL = ("rejected", "shed", "failed", "corrupted")


def _cum_logprob(req: ServeRequest) -> float:
    return float(sum(req.out_logprobs)) if req.out_logprobs else 0.0


def rank(members: Sequence[ServeRequest]) -> List[int]:
    """Member ordering for parent assembly: cumulative chosen-token logprob
    descending (the ``best_of`` criterion), lane index breaking ties — so
    without logprobs the order is lane order."""
    return sorted(range(len(members)),
                  key=lambda i: (-_cum_logprob(members[i]), members[i].lane))


def assemble(parent: ServeRequest, members: Sequence[ServeRequest],
             member_outs: Sequence[RequestOutput],
             t0: Optional[float] = None) -> RequestOutput:
    """Fold finished member lanes into the parent's terminal output.

    The parent's own stream is the winning lane's (rank 0 of the ``n`` kept
    lanes); ``group_outputs`` carries every kept member output in rank order
    (lane order for plain ``n``). Any abnormal member exit wins over normal
    reasons: a group either completes whole or fails whole."""
    order = rank(members)
    keep = order[:parent.params.n] if parent.params.best_of else \
        sorted(order[:parent.params.n])
    abnormal = next((members[i].finish_reason for i in order
                     if members[i].finish_reason in ABNORMAL), None)
    win = members[keep[0]]
    parent.out_tokens = list(win.out_tokens)
    parent.out_logits = list(win.out_logits)
    parent.out_logprobs = list(win.out_logprobs)
    parent.out_topk = list(win.out_topk)
    parent.finish_reason = abnormal or win.finish_reason
    parent.admit_tick = min((m.admit_tick for m in members
                             if m.admit_tick >= 0), default=-1)
    parent.finish_tick = max(m.finish_tick for m in members)
    parent.preemptions = sum(m.preemptions for m in members)
    parent.replayed_tokens = sum(m.replayed_tokens for m in members)
    parent.requeue_ticks = sum(m.requeue_ticks for m in members)
    parent.prefill_tokens = sum(m.prefill_tokens for m in members)
    parent.submit_time = min((m.submit_time for m in members
                              if m.submit_time >= 0),
                             default=t0 if t0 is not None else -1.0)
    parent.finish_time = max(m.finish_time for m in members)
    out = RequestOutput(
        rid=parent.rid, new_tokens=list(parent.out_tokens),
        tokens=list(parent.out_tokens), finished=True,
        finish_reason=parent.finish_reason,
        tick=parent.finish_tick, arrival=parent.arrival,
        admit_tick=parent.admit_tick, finish_tick=parent.finish_tick,
        latency_ticks=(parent.finish_tick - parent.arrival
                       if parent.finish_tick >= 0 else None),
        wall_latency_s=parent.wall_latency_s,
        preemptions=parent.preemptions, requeue_ticks=parent.requeue_ticks)
    if parent.out_logprobs:
        out.new_logprobs = list(parent.out_logprobs)
        out.logprobs = list(parent.out_logprobs)
    if parent.out_topk:
        out.top_logprobs = list(parent.out_topk)
    out.group_outputs = [member_outs[i] for i in keep]
    return out


class GroupBook:
    """Joint-finish bookkeeping over a stream of member outputs.

    Feed every terminal member ``RequestOutput`` (plus its ``ServeRequest``)
    through :meth:`offer`; when a group's last lane lands, ``offer`` returns
    the assembled parent output. Standalone requests pass through as
    ``None`` (the caller already has their output)."""

    def __init__(self):
        self._parents: Dict[int, ServeRequest] = {}
        self._members: Dict[int, Dict[int, ServeRequest]] = {}
        self._outs: Dict[int, Dict[int, RequestOutput]] = {}

    def register(self, parent: ServeRequest) -> None:
        self._parents[parent.rid] = parent
        self._members.setdefault(parent.rid, {})
        self._outs.setdefault(parent.rid, {})

    def offer(self, req: ServeRequest,
              out: RequestOutput) -> Optional[RequestOutput]:
        if req.group < 0 or not out.finished:
            return None
        gid = req.group
        if gid not in self._parents:
            return None
        self._members[gid][req.lane] = req
        self._outs[gid][req.lane] = out
        parent = self._parents[gid]
        if len(self._members[gid]) < parent.params.group_size:
            return None
        lanes = sorted(self._members[gid])
        members = [self._members[gid][ln] for ln in lanes]
        outs = [self._outs[gid][ln] for ln in lanes]
        del self._parents[gid], self._members[gid], self._outs[gid]
        return assemble(parent, members, outs)

    def has(self, gid: int) -> bool:
        return gid in self._parents

    def pending(self) -> List[int]:
        return sorted(self._parents)
