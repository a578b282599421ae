"""The paper's MIMD layout extractor: seven agent characteristics + immune
load balancing (port of ``repro/core/vlsi/extractor.py``).

Agent types (paper §3.1-3.2) and their load-balancing behaviours:

  0 LAYER_FINDER   raster-scans for unlabelled wire cells. Redundancy:
                   suppressed into a node propagator only by *multi-stage
                   delayed suppression* — when both a node-director mark and
                   propagator presence appear in its receptive field.
  1 NODE_LABELLER  walks its wire writing ``label := max(label, own)``
                   (dominance by scatter-max). Dominated -> layer finder.
                   Complete -> node director (or fet labeller on DIFF).
                   Labels are never reused: ``label = episode * N + id + 1``.
  2 FET_LABELLER   traces DIFF wires marking poly∩diff gate regions.
                   Dominated -> layer finder (the "second generation").
  3 FET_OUTPUT     waits at a marked gate until the poly + both diff-side
                   labels are stable, then emits the FET record and flushes
                   done-flags.
  4 CONTACT_FINDER sits on a contact area until both overlapping layers are
                   labelled and stable, emits the equivalence record.
  5 NODE_DIRECTOR  retraces a completed wire writing director marks — the
                   delayed third-stage signal that suppresses finders.
  6 NODE_PROPAGATOR max-diffuses labels into wire interiors, converts to
                   contact finder / fet output on demand, and heals records
                   a later dominance wave made stale.

Each characteristic is written batched over all N agents (the framework
evaluates every characteristic for every agent and the type selects), with
the reference's expressions in the reference's order, so a run on either
device equals the JAX package's cycle for cycle.

The observer's ``done_fn`` (Swarm's observer) ends a run when every
conductor cell is labelled, the labels are a max-diffusion fixpoint, every
gate / contact region carries a record, and every record agrees with the
fixpoint labels. Its fixpoint test is the hand-written ``grid_step`` kernel
on the four label planes at once (``grid_step_planes``, one launch per test
on the card). The kernel pads the grid's edges with
zeros where the reference's ``_shift_max`` wraps; the two agree because
layouts carry an empty margin, which ``make_grid`` checks.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import immune
from ... import prng
from ...kernels.grid_step import grid_step_planes
from ..agent_model import (AgentCtx, AgentModel, AgentUpdate, as_key,
                           no_writes, uniform_random_agents)
from . import reference
from .layout import CONTACT, DIFF, M1, M2, POLY, PSEL

I32 = torch.int32

# ---------------------------------------------------------------------------
# blackboard channels
# ---------------------------------------------------------------------------
LAB0 = 6                     # 6..9: labels for M1, M2, POLY, DIFF
DIRECTOR_MARK = 10
FET_MARK, FET_DONE, FET_S, FET_D, FET_G = 11, 12, 13, 14, 15
# gate bounding-box record, encoded so every corner is monotone under
# max-combining: IR0 = BIG - min_row, IC0 = BIG - min_col, R1, C1 = max
FET_IR0, FET_IC0, FET_R1, FET_C1 = 16, 17, 18, 19
CON_CLAIM, CON_DONE, CON_A, CON_B = 20, 21, 22, 23
PRESENCE = 24                # 24..30: per-type agent presence ("cytokines")
NUM_CHANNELS = 31
BIG = 1 << 20

# agent types
FINDER, LABELLER, FET_LABELLER, FET_OUTPUT, CONTACT_FINDER, DIRECTOR, \
    PROPAGATOR = range(7)
TYPE_NAMES = ("layer_finder", "node_labeller", "fet_labeller", "fet_output",
              "contact_finder", "node_director", "node_propagator")

# state slots
S_LABEL, S_LAYER, S_TIMER, S_EPISODE, S_HOME_R, S_HOME_C = 0, 1, 2, 3, 4, 5
S_WLAB, S_ELAB, S_MINR, S_MINC, S_MAXR, S_MAXC = 6, 7, 8, 9, 10, 11
S_FLUSH, S_GLAB, S_NLAB, S_SLAB = 12, 13, 14, 15
STATE_SIZE = 16
_SLOTS = {name: i for i, name in enumerate(
    ("LABEL", "LAYER", "TIMER", "EPISODE", "HOME_R", "HOME_C", "WLAB", "ELAB",
     "MINR", "MINC", "MAXR", "MAXC", "FLUSH", "GLAB", "NLAB", "SLAB"))}

K_WRITES = 36
PATIENCE_LAB = 10
PATIENCE_FET = 10
DIRECTOR_STEPS = 14
STABLE_WAIT = 8              # cycles the observed labels must hold first
FET_TIMEOUT = 150
CONTACT_TIMEOUT = 150        # starved contact finders anergize back
ANCESTOR_DAMP = 0.25

# the 3x3 window, flattened row-major: the 4-neighbourhood N, W, E, S is
# cells 1, 3, 5, 7 (a stride-2 slice, so no index tensor is copied to the
# card) and the centre is cell 4
NEIGH = slice(1, 9, 2)
CENTER = 4
# conductor planes in the order of the label channels
C_M1, C_M2, C_POLY, C_DIFF = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# the receptive field, shared by the seven characteristics of one cycle
# ---------------------------------------------------------------------------
class _Field(NamedTuple):
    p: torch.Tensor       # (N, C, 9) flattened patches
    cond: torch.Tensor    # (N, 4, 9) conductor masks M1, M2, POLY, DIFF&~POLY
    labs: torch.Tensor    # (N, 4, 9) label channels
    gate: torch.Tensor    # (N, 9)    poly ∩ diff
    coords: torch.Tensor  # (N, 9, 2) grid coordinates of the window cells


def _field(ctx: AgentCtx) -> _Field:
    f = ctx.memo.get("field")
    if f is None:
        p = ctx.patch.reshape(ctx.patch.shape[0], ctx.patch.shape[1], 9)
        poly = p[:, POLY] > 0
        cond = torch.stack([p[:, M1] > 0, p[:, M2] > 0, poly,
                            (p[:, DIFF] > 0) & ~poly], dim=1)
        o = torch.arange(-1, 2, dtype=I32, device=p.device)
        off = torch.stack([o[:, None].expand(3, 3).reshape(9),
                           o[None, :].expand(3, 3).reshape(9)], dim=1)
        f = ctx.memo["field"] = _Field(
            p=p, cond=cond, labs=p[:, LAB0:LAB0 + 4],
            gate=poly & (p[:, DIFF] > 0), coords=ctx.pos[:, None, :] + off)
    return f


def _layer(x: torch.Tensor, lyr: torch.Tensor) -> torch.Tensor:
    """(N, 4, 9) -> (N, 9): each agent's plane ``lyr`` (clamped to the
    planes, as JAX clamps a gather index)."""
    idx = torch.clamp(lyr.long(), 0, 3)[:, None, None]
    idx = idx.expand(-1, 1, x.shape[2])
    return x.gather(1, idx)[:, 0]


def _take(coords: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """(N, 9, 2), (N,) -> (N, 2): each agent's window cell ``cell``."""
    return coords.gather(1, cell.long()[:, None, None].expand(-1, 1, 2))[:, 0]


def _first_idx(mask: torch.Tensor):
    """Over the last axis: (any, index of the first True — 0 if none)."""
    return mask.any(-1), mask.to(I32).argmax(-1)


def _other_layer_label(cond, labs):
    """Label of the non-m1 conductor under each window cell: (N, 9)."""
    return torch.where(cond[:, 1:4], labs[:, 1:4], 0).amax(1)


def _set(state: torch.Tensor, **slots) -> torch.Tensor:
    """A copy of the (N, S) state with the named slots (``S_<NAME>``) set."""
    st = state.clone()
    for name, v in slots.items():
        st[:, _SLOTS[name]] = v
    return st


class _W:
    """Collects (channel, row, col, value) writes for all N agents, as
    blocks of shape (N, k, 4); value 0 is a no-op."""

    def __init__(self):
        self.blocks = []

    def put_block(self, ch, r, c, v):
        """Tensors broadcastable to one (N, ...) shape, flattened to (N, k)
        writes; ``ch`` may be an int."""
        if not isinstance(ch, torch.Tensor):
            ch = torch.full_like(v, ch)
        parts = torch.broadcast_tensors(ch, r, c, v)
        block = torch.stack([x.to(I32) for x in parts], dim=-1)
        self.blocks.append(block.reshape(block.shape[0], -1, 4))

    def put(self, ch, r, c, v):
        """One write per agent: r, c, v (N,); ``ch`` an int or (N,)."""
        if isinstance(ch, torch.Tensor):
            ch = ch[:, None]
        self.put_block(ch, r[:, None], c[:, None], v[:, None])

    def put_window(self, ch: int, coords, vals):
        """Nine writes per agent, one on each window cell: vals (N, 9)."""
        self.put_block(ch, coords[..., 0], coords[..., 1], vals)

    def pack(self) -> torch.Tensor:
        return torch.cat(self.blocks, dim=1)


def _neigh_offset(k: torch.Tensor) -> torch.Tensor:
    """(N,) neighbour index 0..3 (N, W, E, S) -> (N, 2) grid offset."""
    dr = (k == 3).to(I32) - (k == 0).to(I32)
    dc = (k == 2).to(I32) - (k == 1).to(I32)
    return torch.stack([dr, dc], dim=1)


def _walk_draws(ctx: AgentCtx):
    """Each agent's Pm draws, as the reference takes them: keys (k1, k2, k3)
    = ``split(fold_in(key, 3), 3)``; noise ``uniform(k1, (4,))``, the random
    step ``randint(k2, (), 0, 4)`` and the exploration draw ``uniform(k3)``.
    One threefry pass gives the words of all three keys at counters 0..3:
    k1's are the noise bits, k2's first two are its split for ``randint``,
    k3's first is the uniform's bits. Shared by the walkers of a cycle."""
    d = ctx.memo.get("walk")
    if d is None:
        k = prng.split(prng.fold_in(ctx.key, 3), 3)          # (N, 3, 2)
        y0, y1 = prng.counter_words(k, 4)                    # (N, 3, 4)
        noise = prng.bits_to_uniform(y0[:, 0] ^ y1[:, 0])
        halves = torch.stack([y0[:, 1, :2], y1[:, 1, :2]], dim=-1)
        rnd = prng.randint_from_split(halves, (), 0, 4)
        u = prng.bits_to_uniform(y0[:, 2, 0] ^ y1[:, 2, 0])
        d = ctx.memo["walk"] = (noise, rnd, u)
    return d


def _walk(ctx: AgentCtx, scores: torch.Tensor, eps: float = 0.0):
    """Pm for walkers: move to the best-scoring 4-neighbour (plus noise); stay
    if all scores are <= 0. With probability ``eps`` take a uniformly random
    step instead (ergodic exploration). scores (N, 4) float32 -> (N, 2)."""
    noise, rnd, u = _walk_draws(ctx)
    total = scores + 0.5 * noise
    best = torch.argmax(total, dim=-1)
    stay = scores.amax(-1) <= 0.0
    step = torch.where(stay[:, None], ctx.pos, ctx.pos + _neigh_offset(best))
    if eps > 0.0:
        eps32 = torch.full((), eps, dtype=torch.float32, device=u.device)
        step = torch.where((u < eps32)[:, None],
                           ctx.pos + _neigh_offset(rnd), step)
    return step


def _ones(ctx: AgentCtx) -> torch.Tensor:
    return torch.ones(ctx.n_agents, dtype=torch.float32, device=ctx.pos.device)


def _types(*cases) -> torch.Tensor:
    """Nested ``where`` over (condition, type) pairs and a default type."""
    *pairs, default = cases
    out = default
    for cond, t in reversed(pairs):
        out = torch.where(cond, t, out)
    return out.to(I32)


@functools.lru_cache(maxsize=64)
def make_extractor(n_agents: int, grid_hw: tuple[int, int] | None = None,
                   ancestor_damp: float = ANCESTOR_DAMP,
                   finder_suppression: bool = True,
                   walk_eps: float = 0.35):
    """Build the AgentModel implementing the paper's extraction program.

    ``grid_hw`` fixes the raster-scan wrap limits for the layer finders. The
    keyword knobs exist for the heuristic ablations: ``ancestor_damp=1.0``
    disables limit-cycle damping, ``finder_suppression=False`` removes the
    multi-stage delayed suppression of layer finders, ``walk_eps=0.0``
    removes ergodic exploration."""
    raster_lim = (grid_hw[0] - 2, grid_hw[1] - 2) if grid_hw \
        else (10 ** 6, 10 ** 6)
    damp = ancestor_damp

    def damped(prob, new_type, ctx):
        return immune.damp_ancestor_transition(prob, new_type, ctx.prev_type,
                                               damp)

    def new_label(ctx, episode):
        return episode * ctx.n_agents + ctx.agent_id + 1

    def finder(ctx: AgentCtx) -> AgentUpdate:
        f = _field(ctx)
        n = ctx.n_agents
        unlab = f.cond & (f.labs == 0)
        found, idx = _first_idx(unlab.reshape(n, 36))
        layer, cell = idx // 9, idx % 9

        # multi-stage delayed suppression: director mark + propagator presence
        suppressed = (f.p[:, DIRECTOR_MARK] > 0).any(-1) \
            & (f.p[:, PRESENCE + PROPAGATOR].sum(-1) > 0)
        suppressed = suppressed & finder_suppression

        st = ctx.state
        episode = st[:, S_EPISODE]
        st_lab = _set(st, LABEL=new_label(ctx, episode), LAYER=layer, TIMER=0,
                      EPISODE=episode + 1)

        new_type = _types((found, LABELLER), (suppressed, PROPAGATOR), FINDER)
        prob = torch.where(found, 1.0, 0.5)
        prob = damped(prob, new_type, ctx)
        state = torch.where(found[:, None], st_lab, st)

        # raster scan, stride 3 (window width); labellers start on the cell
        nc = ctx.pos[:, 1] + 3
        over_c = nc > raster_lim[1]
        nr = torch.where(over_c, ctx.pos[:, 0] + 3, ctx.pos[:, 0])
        nc = torch.where(over_c, 1, nc)
        nr = torch.where(nr > raster_lim[0], 1, nr)
        raster = torch.stack([nr, nc], dim=1)
        pos = torch.where(found[:, None], _take(f.coords, cell), raster)
        return AgentUpdate(no_writes(n, pos.device), state, new_type, prob,
                           pos)

    def labeller(ctx: AgentCtx) -> AgentUpdate:
        f = _field(ctx)
        lyr = ctx.state[:, S_LAYER]
        own = ctx.state[:, S_LABEL]
        my_cond, my_labs = _layer(f.cond, lyr), _layer(f.labs, lyr)

        dominated = my_cond[:, CENTER] & (my_labs[:, CENTER] > own)

        w = _W()
        w.put(LAB0 + lyr, ctx.pos[:, 0], ctx.pos[:, 1],
              torch.where(my_cond[:, CENTER], own, 0))
        # diff labellers mark gate regions as they trace
        gate_unmarked = f.gate & (f.p[:, FET_MARK] == 0) \
            & (lyr == C_DIFF)[:, None]
        mark = (ctx.agent_id + 1)[:, None]
        w.put_window(FET_MARK, f.coords, torch.where(gate_unmarked, mark, 0))

        work_left = (my_cond & (my_labs < own[:, None])).any(-1)
        timer = torch.where(work_left, 0, ctx.state[:, S_TIMER] + 1)
        complete = timer > PATIENCE_LAB

        done_type = torch.where(lyr == C_DIFF, FET_LABELLER, DIRECTOR)
        new_type = _types((dominated, FINDER), (complete, done_type),
                          LABELLER)
        st = _set(ctx.state, TIMER=torch.where(complete, 0, timer),
                  FLUSH=torch.where(complete, DIRECTOR_STEPS, 0))
        prob = damped(_ones(ctx), new_type, ctx)
        prob = torch.where(dominated, 1.0, prob)   # dominance losses convert

        n_cond, n_labs = my_cond[:, NEIGH], my_labs[:, NEIGH]
        scores = torch.where(n_cond, 1.0, -1.0) \
            + 2.0 * (n_cond & (n_labs == 0)) \
            + 1.0 * (n_cond & (n_labs < own[:, None]))
        return AgentUpdate(w.pack(), st, new_type,
                           prob, _walk(ctx, scores))

    def fet_labeller(ctx: AgentCtx) -> AgentUpdate:
        f = _field(ctx)
        own = ctx.state[:, S_LABEL]
        my_cond, my_labs = f.cond[:, C_DIFF], f.labs[:, C_DIFF]

        dominated = my_cond[:, CENTER] & (my_labs[:, CENTER] > own)

        w = _W()
        w.put(LAB0 + C_DIFF, ctx.pos[:, 0], ctx.pos[:, 1],
              torch.where(my_cond[:, CENTER], own, 0))
        gate_unmarked = f.gate & (f.p[:, FET_MARK] == 0)
        mark = (ctx.agent_id + 1)[:, None]
        w.put_window(FET_MARK, f.coords, torch.where(gate_unmarked, mark, 0))

        timer = torch.where(gate_unmarked.any(-1), 0,
                            ctx.state[:, S_TIMER] + 1)
        complete = timer > PATIENCE_FET
        new_type = _types((dominated, FINDER), (complete, PROPAGATOR),
                          FET_LABELLER)
        prob = damped(_ones(ctx), new_type, ctx)
        prob = torch.where(dominated, 0.9, prob)   # *most* dominated rebound
        st = _set(ctx.state, TIMER=torch.where(complete, 0, timer))

        scores = torch.where(my_cond[:, NEIGH], 1.0, -1.0)
        return AgentUpdate(w.pack(), st, new_type,
                           prob, _walk(ctx, scores))

    def director(ctx: AgentCtx) -> AgentUpdate:
        f = _field(ctx)
        lyr = ctx.state[:, S_LAYER]
        my_cond = _layer(f.cond, lyr)

        w = _W()
        w.put(DIRECTOR_MARK, ctx.pos[:, 0], ctx.pos[:, 1],
              torch.where(my_cond[:, CENTER], 1, 0))

        flush = ctx.state[:, S_FLUSH] - 1
        done = flush <= 0
        st = _set(ctx.state, FLUSH=torch.clamp(flush, min=0))
        new_type = _types((done, PROPAGATOR), DIRECTOR)

        unmarked = my_cond[:, NEIGH] & (f.p[:, DIRECTOR_MARK, NEIGH] == 0)
        scores = torch.where(my_cond[:, NEIGH], 1.0, -1.0) + 2.0 * unmarked
        return AgentUpdate(w.pack(), st, new_type,
                           _ones(ctx), _walk(ctx, scores))

    def pull_labels(f: _Field, w: _W, pos):
        """Each label plane's max over the conducting 4-neighbours of a
        conducting centre, written on the centre (all four planes)."""
        both = f.cond[:, :, CENTER:CENTER + 1] & f.cond[:, :, NEIGH]  # (N,4,4)
        pull = torch.where(both, f.labs[:, :, NEIGH], 0).amax(-1)    # (N,4)
        ch = torch.arange(LAB0, LAB0 + 4, dtype=I32, device=pos.device)
        w.put_block(ch[None, :], pos[:, 0:1], pos[:, 1:2], pull)
        return both

    def propagator(ctx: AgentCtx) -> AgentUpdate:
        f = _field(ctx)
        p, cond, labs, gate, coords = f
        n = ctx.n_agents

        # Pw: local max-diffusion of all four label planes (respects the
        # diff/gate barrier because diff conductor excludes gate cells)
        w = _W()
        both = pull_labels(f, w, ctx.pos)
        ch = torch.arange(LAB0, LAB0 + 4, dtype=I32, device=ctx.pos.device)
        w.put_block(ch[None, :, None], coords[:, None, NEIGH, 0],
                    coords[:, None, NEIGH, 1],
                    torch.where(both, labs[:, :, CENTER:CENTER + 1], 0))

        # --- staleness detection (healing)
        other_lab = _other_layer_label(cond, labs)
        con_stale = (p[:, CON_A] > 0) & ((p[:, CON_A] < labs[:, C_M1])
                                         | (p[:, CON_B] < other_lab))
        g_stale_cells = (p[:, FET_S] > 0) & (p[:, FET_G] < labs[:, C_POLY])
        rec_s, rec_d = p[:, FET_S].amax(-1), p[:, FET_D].amax(-1)
        side = torch.where(cond[:, C_DIFF, NEIGH], labs[:, C_DIFF, NEIGH], 0)
        side_stale = gate[:, CENTER] & (p[:, FET_DONE, CENTER] > 0) \
            & (rec_s > 0) & ((side > 0) & (side != rec_s[:, None])
                             & (side != rec_d[:, None])).any(-1)
        # bbox staleness: a gate cell visible outside the bbox implied by a
        # visible record
        brec = p[:, FET_R1] > 0
        r1w, c1w = p[:, FET_R1].amax(-1), p[:, FET_C1].amax(-1)
        r0w = BIG - p[:, FET_IR0].amax(-1)
        c0w = BIG - p[:, FET_IC0].amax(-1)
        rows, cols = coords[..., 0], coords[..., 1]
        outside = gate & ((rows > r1w[:, None]) | (rows < r0w[:, None])
                          | (cols > c1w[:, None]) | (cols < c0w[:, None]))
        bbox_stale = brec & (outside.any(-1) & brec.any(-1))[:, None]

        # Pa: convert on demand (contact finder / fet output / healing /
        # relabelling). Contact claims hold only while a contact finder is
        # present (presence = the paper's cytokine signal).
        cf_present = p[:, PRESENCE + CONTACT_FINDER, CENTER] > 0
        on_contact = (p[:, CONTACT, CENTER] > 0) \
            & (((p[:, CON_DONE, CENTER] == 0)
                & ((p[:, CON_CLAIM, CENTER] == 0) | ~cf_present))
               | con_stale[:, CENTER])
        gate_spawn = (gate & (p[:, FET_MARK] > 0) & (p[:, FET_DONE] == 0)) \
            | g_stale_cells | bbox_stale
        gate_spawn[:, CENTER] |= side_stale
        has_gate, gidx = _first_idx(gate_spawn)
        has_gate = has_gate & ~on_contact
        seed = _take(coords, gidx)

        # irrelevancy correction: an unlabelled conductor cell whose window
        # holds no same-layer label cannot be fixed by diffusion
        need_label = cond[:, :, CENTER] & (labs[:, :, CENTER] == 0) \
            & ~(cond & (labs > 0)).any(-1)
        relabel, rl_layer = _first_idx(need_label)
        relabel = relabel & ~on_contact & ~has_gate

        w.put(CON_CLAIM, ctx.pos[:, 0], ctx.pos[:, 1],
              torch.where(on_contact, ctx.agent_id + 1, 0))

        st = ctx.state
        st_con = _set(st, HOME_R=ctx.pos[:, 0], HOME_C=ctx.pos[:, 1], TIMER=0,
                      WLAB=0, ELAB=0)
        st_fet = _set(st, HOME_R=seed[:, 0], HOME_C=seed[:, 1], WLAB=0,
                      ELAB=0, NLAB=0, SLAB=0, GLAB=0, MINR=seed[:, 0],
                      MINC=seed[:, 1], MAXR=seed[:, 0], MAXC=seed[:, 1],
                      TIMER=0, FLUSH=0)
        episode = st[:, S_EPISODE]
        st_lab = _set(st, LABEL=new_label(ctx, episode), LAYER=rl_layer,
                      TIMER=0, EPISODE=episode + 1)
        state = torch.where(on_contact[:, None], st_con,
                            torch.where(has_gate[:, None], st_fet,
                                        torch.where(relabel[:, None], st_lab,
                                                    st)))
        new_type = _types((on_contact, CONTACT_FINDER), (has_gate, FET_OUTPUT),
                          (relabel, LABELLER), PROPAGATOR)
        prob = damped(_ones(ctx), new_type, ctx)
        # work conversions stay damped when they would return the agent to
        # its ancestor type (undamped respawn loops absorb the population)
        prob = torch.where(relabel, 1.0, prob)

        # Pm: toward work; anti-crowding on own type damps limit cycles
        any_cond = cond.any(1)
        any_unlab = (cond & (labs == 0)).any(1)
        contact_todo = (p[:, CONTACT] > 0) & (p[:, CON_DONE] == 0)
        crowd = p[:, PRESENCE + PROPAGATOR, NEIGH].to(torch.float32)
        scores = 0.2 + 1.0 * any_cond[:, NEIGH] + 2.0 * any_unlab[:, NEIGH] \
            + 0.3 * (p[:, DIRECTOR_MARK, NEIGH] > 0) \
            + 2.0 * contact_todo[:, NEIGH] + 2.0 * gate_spawn[:, NEIGH] \
            - 0.5 * crowd
        pos = _walk(ctx, scores, eps=walk_eps)
        pos = torch.where(has_gate[:, None], seed, pos)
        pos = torch.where((on_contact | relabel)[:, None], ctx.pos, pos)
        return AgentUpdate(w.pack(), state, new_type, prob, pos)

    def contact_finder(ctx: AgentCtx) -> AgentUpdate:
        f = _field(ctx)
        p, cond, labs, _, coords = f

        claim = p[:, CON_CLAIM, CENTER]
        # a stale claim from a departed finder must not block us: dominance
        # applies only while another claimant is co-located
        lost = (claim > ctx.agent_id + 1) \
            & (p[:, PRESENCE + CONTACT_FINDER, CENTER] > 1)

        # pull labels into the contact cell for all layers
        w = _W()
        pull_labels(f, w, ctx.pos)

        m1lab = labs[:, C_M1, CENTER]
        olab = _other_layer_label(cond, labs)[:, CENTER]

        # synchronization: emit only after the pair is stable STABLE_WAIT
        changed = (m1lab != ctx.state[:, S_WLAB]) \
            | (olab != ctx.state[:, S_ELAB])
        timer = torch.where(changed, 0, ctx.state[:, S_TIMER] + 1)
        stale_rec = (p[:, CON_A, CENTER] > 0) \
            & ((p[:, CON_A, CENTER] < m1lab) | (p[:, CON_B, CENTER] < olab))
        fresh_done = (p[:, CON_DONE, CENTER] > 0) & ~stale_rec
        # a healing re-emit (stale record) ignores the claim
        ready = (m1lab > 0) & (olab > 0) & (timer >= STABLE_WAIT) \
            & (~lost | stale_rec) & ~fresh_done

        w.put(CON_A, ctx.pos[:, 0], ctx.pos[:, 1],
              torch.where(ready, m1lab, 0))
        w.put(CON_B, ctx.pos[:, 0], ctx.pos[:, 1], torch.where(ready, olab, 0))
        con_cells = p[:, CONTACT] > 0
        w.put_window(CON_DONE, coords,
                     torch.where(ready[:, None] & con_cells, 1, 0))

        st = _set(ctx.state, WLAB=m1lab, ELAB=olab, TIMER=timer)
        # anergy: a finder starved of labels for CONTACT_TIMEOUT cycles
        # reverts to propagator
        starved = (timer > CONTACT_TIMEOUT) & ~ready
        leave = ready | (lost & ~stale_rec) | fresh_done | starved
        new_type = _types((leave, PROPAGATOR), CONTACT_FINDER)
        return AgentUpdate(w.pack(), st, new_type,
                           _ones(ctx), ctx.pos)

    def fet_output(ctx: AgentCtx) -> AgentUpdate:
        f = _field(ctx)
        p, cond, labs, gate, coords = f
        n = ctx.n_agents
        st = ctx.state

        # grow the gate-region bounding box from window gate cells
        big = 10 ** 6
        rows, cols = coords[..., 0], coords[..., 1]
        minr = torch.minimum(st[:, S_MINR],
                             torch.where(gate, rows, big).amin(-1))
        minc = torch.minimum(st[:, S_MINC],
                             torch.where(gate, cols, big).amin(-1))
        maxr = torch.maximum(st[:, S_MAXR],
                             torch.where(gate, rows, -1).amax(-1))
        maxc = torch.maximum(st[:, S_MAXC],
                             torch.where(gate, cols, -1).amax(-1))

        # geometric side-canonical S/D collection (N/W/E/S sides)
        on_gate = gate[:, CENTER]
        sides = torch.where(cond[:, C_DIFF, NEIGH] & on_gate[:, None],
                            labs[:, C_DIFF, NEIGH], 0)
        nlab = torch.maximum(st[:, S_NLAB], sides[:, 0])
        wlab = torch.maximum(st[:, S_WLAB], sides[:, 1])
        elab = torch.maximum(st[:, S_ELAB], sides[:, 2])
        slab = torch.maximum(st[:, S_SLAB], sides[:, 3])
        glab = torch.maximum(st[:, S_GLAB],
                             torch.where(on_gate, labs[:, C_POLY, CENTER], 0))

        changed = (nlab != st[:, S_NLAB]) | (wlab != st[:, S_WLAB]) \
            | (elab != st[:, S_ELAB]) | (slab != st[:, S_SLAB]) \
            | (glab != st[:, S_GLAB]) \
            | (minr != st[:, S_MINR]) | (minc != st[:, S_MINC]) \
            | (maxr != st[:, S_MAXR]) | (maxc != st[:, S_MAXC])
        timer = torch.where(changed, 0, st[:, S_TIMER] + 1)

        we_ok = (wlab > 0) & (elab > 0)
        ns_ok = (nlab > 0) & (slab > 0)
        s_val = torch.where(we_ok, wlab, nlab)
        d_val = torch.where(we_ok, elab, slab)

        flush = st[:, S_FLUSH]
        collecting = flush == 0
        complete = collecting & (we_ok | ns_ok) & (glab > 0) \
            & (timer >= STABLE_WAIT)

        w = _W()
        hr, hc = st[:, S_HOME_R], st[:, S_HOME_C]
        for ch, v in ((FET_S, s_val), (FET_D, d_val), (FET_G, glab),
                      (FET_IR0, BIG - minr), (FET_IC0, BIG - minc),
                      (FET_R1, maxr), (FET_C1, maxc)):
            w.put(ch, hr, hc, torch.where(complete, v, 0))
        flushing = complete | (flush > 0)
        w.put_window(FET_DONE, coords,
                     torch.where(flushing[:, None] & gate, 1, 0))

        new_flush = torch.where(complete, 3, torch.clamp(flush - 1, min=0))
        give_up = collecting & (timer > FET_TIMEOUT)
        done = (flush > 0) & (new_flush == 0)

        # a starved fet output usually means an *unlabelled* diff side —
        # convert straight to a labeller for it
        unlab = cond & (labs == 0)
        can_relabel, uidx = _first_idx(unlab.reshape(n, 36))
        rl_layer, rl_cell = uidx // 9, uidx % 9
        relabel = give_up & can_relabel
        episode = st[:, S_EPISODE]
        new_type = _types((done | give_up,
                           torch.where(relabel, LABELLER, PROPAGATOR)),
                          FET_OUTPUT)

        st = _set(st, MINR=minr, MINC=minc, MAXR=maxr, MAXC=maxc, NLAB=nlab,
                  WLAB=wlab, ELAB=elab, SLAB=slab, GLAB=glab, FLUSH=new_flush,
                  TIMER=timer)
        st_lab = _set(st, LABEL=new_label(ctx, episode), LAYER=rl_layer,
                      TIMER=0, EPISODE=episode + 1)
        st = torch.where(relabel[:, None], st_lab, st)

        scores = torch.where(gate[:, NEIGH], 2.0, -1.0)
        pos = _walk(ctx, scores)
        pos = torch.where(relabel[:, None], _take(coords, rl_cell), pos)
        return AgentUpdate(w.pack(), st, new_type, _ones(ctx),
                           pos)

    behaviors = [finder, labeller, fet_labeller, fet_output, contact_finder,
                 director, propagator]
    return AgentModel(behaviors, NUM_CHANNELS, STATE_SIZE, K_WRITES,
                      presence_channel=PRESENCE)


# ---------------------------------------------------------------------------
# observer: grid construction, termination, harvesting
# ---------------------------------------------------------------------------
def make_grid(layout: np.ndarray, device="cuda") -> torch.Tensor:
    """(6,H,W) layout -> (NUM_CHANNELS,H,W) int32 blackboard on ``device``.

    Raises ``ValueError`` unless every plane is empty on the outer rows and
    columns: the reference relies on that margin (its observer's shifts wrap
    around the edges, the agents' windows stay inside), and it is what makes
    the ``grid_step`` kernel's zero padding equal ``_shift_max``'s wrap."""
    layout = np.asarray(layout)
    if layout.ndim != 3 or layout.shape[1] < 3 or layout.shape[2] < 3:
        raise ValueError(f"layout must be (planes, H, W) with H, W >= 3, got "
                         f"{layout.shape}")
    edges = (layout[:, 0], layout[:, -1], layout[:, :, 0], layout[:, :, -1])
    if any(e.any() for e in edges):
        raise ValueError("layout must have an empty margin: a plane is "
                         "nonzero on the outer rows or columns")
    _, h, w = layout.shape
    grid = np.zeros((NUM_CHANNELS, h, w), np.int32)
    grid[:layout.shape[0]] = layout
    return torch.as_tensor(grid, device=device)


def _shift(x, dr, dc):
    # margins keep wrap-around harmless (border cells are empty)
    return torch.roll(x, (dr, dc), (-2, -1))


def _shift_max(lab, cond):
    """One synchronous max-diffusion step of a label plane within its
    conductor mask, wrapping at the edges (the reference's semantics; the
    plain version of the observer's fixpoint step, which ``done_fn`` runs on
    the ``grid_step`` kernel)."""
    out = lab
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        out = torch.maximum(out, torch.where(_shift(cond, dr, dc) & cond,
                                             _shift(lab, dr, dc), 0))
    return out


def _region_max(x, mask, rounds: int = 8):
    """Max-reduce ``x`` over each connected region of ``mask`` (regions here
    have diameter << rounds), in the reference's order: inside a round the
    four directions update one after another. x, mask (..., H, W): a stack
    of planes is reduced plane by plane."""
    x = torch.where(mask, x, 0)
    links = [(dr, dc, _shift(mask, dr, dc) & mask)
             for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1))]
    for _ in range(rounds):
        for dr, dc, link in links:
            x = torch.maximum(x, torch.where(link, _shift(x, dr, dc), 0))
    return x


def done_fn(grid: torch.Tensor) -> bool:
    """The observer's termination test. Returns after the label and fixpoint
    conjuncts when they fail (the same answer, one host read): the record
    conjuncts run only once the labels are a complete fixpoint."""
    poly = grid[POLY] > 0
    diff_c = (grid[DIFF] > 0) & ~poly
    conds = torch.stack([grid[M1] > 0, grid[M2] > 0, poly, diff_c])
    labs = grid[LAB0:LAB0 + 4]
    ok = (~conds | (labs > 0)).all() \
        & (grid_step_planes(labs, conds.to(I32)) == labs).all()
    if not bool(ok):
        return False

    # FET records: every gate region has one, matching the fixpoint labels;
    # contact records are per-cell exact. The ten region maxima reduce as
    # one stack of planes.
    h, w = grid.shape[1:]
    gates = poly & (grid[DIFF] > 0)
    con = grid[CONTACT] > 0
    dlab = torch.where(diff_c, grid[LAB0 + DIFF], 0)
    rows = torch.arange(h, dtype=I32, device=grid.device)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=I32, device=grid.device)[None, :].expand(h, w)
    rec = grid[FET_S] > 0
    crec = grid[CON_A] > 0
    planes = torch.stack([_shift(dlab, 1, 0), _shift(dlab, 0, 1),
                          _shift(dlab, 0, -1), _shift(dlab, -1, 0),
                          rows, cols, BIG - rows, BIG - cols, rec.to(I32),
                          crec.to(I32)])
    masks = torch.stack([gates] * 9 + [con])
    n_, w_, e_, s_, r1, c1, ir0, ic0, rec_any, crec_any = \
        _region_max(planes, masks).unbind(0)
    we_ok = (w_ > 0) & (e_ > 0)
    sd_hi = torch.where(we_ok, torch.maximum(w_, e_), torch.maximum(n_, s_))
    sd_lo = torch.where(we_ok, torch.minimum(w_, e_), torch.minimum(n_, s_))
    rec_hi = torch.maximum(grid[FET_S], grid[FET_D])
    rec_lo = torch.minimum(grid[FET_S], grid[FET_D])
    ok = (~rec | ((rec_hi == sd_hi) & (rec_lo == sd_lo)
                  & (grid[FET_G] == grid[LAB0 + POLY])
                  & (grid[FET_R1] == r1) & (grid[FET_C1] == c1)
                  & (grid[FET_IR0] == ir0) & (grid[FET_IC0] == ic0))).all()
    ok = ok & (~gates | (rec_any > 0)).all()
    ok = ok & (~gates | (grid[FET_DONE] > 0)).all()

    m2lab = torch.where(conds[1], grid[LAB0 + M2], 0)
    plab = torch.where(poly, grid[LAB0 + POLY], 0)
    olab = torch.maximum(torch.maximum(m2lab, plab), dlab)
    ok = ok & (~crec | ((grid[CON_A] == grid[LAB0 + M1])
                        & (grid[CON_B] == olab))).all()
    ok = ok & (~con | (crec_any > 0)).all()
    ok = ok & (~con | (grid[CON_DONE] > 0)).all()
    return bool(ok)


class SimNetlist(NamedTuple):
    fets: frozenset          # Fet records with sim labels in sd/g node slots
    equivs: frozenset
    label_of: dict           # (layer, oracle_comp) -> set of sim labels on it
    duplicates: int          # redundant records emitted


def harvest(grid, layout: np.ndarray) -> SimNetlist:
    """Read the records the agents wrote to the blackboard and deduplicate
    them by oracle region (the harvester is the 'output file' reader)."""
    if isinstance(grid, torch.Tensor):
        grid = grid.cpu().numpy()
    grid = np.asarray(grid)
    comp = {lyr: reference.label_components(
        reference.conductor_mask(layout, lyr))[0]
        for lyr in reference.CONDUCTORS}
    gate_mask = (layout[POLY] > 0) & (layout[DIFF] > 0)
    gate_comp, _ = reference.label_components(gate_mask)
    con_comp, _ = reference.label_components(layout[CONTACT] > 0)

    dup = 0
    fets_by_gate: dict[int, tuple] = {}
    for r, c in np.argwhere(grid[FET_S] > 0):
        gid = int(gate_comp[r, c])
        l = int(grid[FET_R1, r, c]) - (BIG - int(grid[FET_IR0, r, c])) + 1
        w = int(grid[FET_C1, r, c]) - (BIG - int(grid[FET_IC0, r, c])) + 1
        rec = (int(grid[FET_S, r, c]), int(grid[FET_D, r, c]),
               int(grid[FET_G, r, c]), l, w,
               'p' if layout[PSEL, r, c] > 0 else 'n')
        if gid in fets_by_gate:
            dup += 1
        fets_by_gate[gid] = rec
    fets = frozenset(
        reference.Fet(pol=pol, sd=frozenset({('sim', s), ('sim', d)}),
                      g=('sim', g), l=min(l, w), w=max(l, w))
        for (s, d, g, l, w, pol) in fets_by_gate.values())

    equivs_by_con: dict[int, frozenset] = {}
    for r, c in np.argwhere(grid[CON_A] > 0):
        cid = int(con_comp[r, c])
        pair = frozenset({('sim', int(grid[CON_A, r, c])),
                          ('sim', int(grid[CON_B, r, c]))})
        if cid in equivs_by_con:
            dup += 1
        equivs_by_con[cid] = pair
    equivs = frozenset(reference.Equiv(nodes=p)
                       for p in equivs_by_con.values())

    # oracle-component -> sim-label map (consistent & injective if correct)
    label_of = {}
    for lyr in reference.CONDUCTORS:
        lab_plane = grid[LAB0 + lyr]
        for cid in range(1, comp[lyr].max() + 1):
            label_of[(lyr, cid)] = set(lab_plane[comp[lyr] == cid].tolist())
    return SimNetlist(fets=fets, equivs=equivs, label_of=label_of,
                      duplicates=dup)


def netlists_equivalent(sim: SimNetlist,
                        oracle: reference.Netlist) -> tuple[bool, str]:
    """Check the agent netlist matches the oracle up to node renaming."""
    mapping = {}
    used = set()
    for (lyr, cid), vals in sim.label_of.items():
        if len(vals) != 1:
            return False, f"component ({lyr},{cid}) has labels {vals}"
        v = next(iter(vals))
        if v == 0:
            return False, f"component ({lyr},{cid}) unlabelled"
        if v in used:
            return False, f"sim label {v} reused across components"
        used.add(v)
        mapping[(lyr, cid)] = ('sim', v)

    o_fets = frozenset(
        reference.Fet(pol=f.pol, sd=frozenset(mapping[n] for n in f.sd),
                      g=mapping[f.g], l=f.l, w=f.w)
        for f in oracle.fets)
    if o_fets != sim.fets:
        return False, (f"fets differ: oracle={o_fets - sim.fets} "
                       f"sim={sim.fets - o_fets}")
    o_eq = frozenset(
        reference.Equiv(nodes=frozenset(mapping[n] for n in e.nodes))
        for e in oracle.equivs)
    if o_eq != sim.equivs:
        return False, (f"equivs differ: oracle={o_eq - sim.equivs} "
                       f"sim={sim.equivs - o_eq}")
    return True, "ok"


# ---------------------------------------------------------------------------
# one-call driver
# ---------------------------------------------------------------------------
def run_extraction(layout: np.ndarray, n_agents: int, seed: int = 0,
                   max_steps: int = 4000, record: bool = False,
                   device="cuda"):
    """Run the full extraction on ``device``. Returns ``(grid, steps_taken,
    populations | None, agents)``: the final blackboard and the (steps,
    num_types) populations as numpy arrays, the final ``Agents`` on the
    device. Keys, agents and cycles are the JAX package's for the same
    seed."""
    grid = make_grid(layout, device)
    h, w = grid.shape[1:]
    model = make_extractor(n_agents, (h, w))
    key = as_key(prng.PRNGKey(seed), grid.device)
    ka, kr = prng.split(key, 2).unbind(0)
    agents = uniform_random_agents(ka, n_agents, h, w, STATE_SIZE,
                                   init_type=FINDER, device=grid.device)
    if record:
        grid, agents, steps, pops = model.run_scan(grid, agents, kr,
                                                   max_steps, done_fn=done_fn,
                                                   record=True)
        return grid.cpu().numpy(), steps, pops.cpu().numpy(), agents
    grid, agents, steps = model.run_while(grid, agents, kr, max_steps,
                                          done_fn)
    return grid.cpu().numpy(), steps, None, agents
