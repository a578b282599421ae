"""The Hewes mobile-agent / shared-environment MIMD model (paper §2), batched
over the agents in PyTorch (port of ``repro/core/agent_model.py``).

The paper constrains MIMD programs to a finite set of *agent
characteristics*, each a five-subprogram cycle over a shared blackboard
memory:

    Pr (read receptive field) -> Pu (state update) -> Pw (write) -> Pa (alter
    type) -> Pm (move)

Agents step *synchronously*. Each characteristic is a function of a batched
``AgentCtx`` over all N agents that returns a batched ``AgentUpdate``; every
characteristic is evaluated for every agent and the agent's type selects the
result (what ``lax.switch`` under ``vmap`` computes in the reference). Write
conflicts are resolved with scatter-max (the paper's dominance rule). The
blackboard is a ``(C, H, W)`` int32 tensor whose values are all >= 0;
receptive fields are 3x3 windows.

Randomness comes from explicit threefry keys (``repro_torch.prng``), split and
folded exactly as the reference does, so a run equals the JAX package's
cycle for cycle. The framework is generic; ``repro_torch.core.vlsi.extractor``
instantiates it with the paper's seven agent types.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from .. import prng

I32 = torch.int32


class Agents(NamedTuple):
    """SoA agent population. ``state`` layout is defined by the program."""

    type_id: torch.Tensor    # (N,)   int32
    prev_type: torch.Tensor  # (N,)   int32 -- ancestor type (cycle damping)
    pos: torch.Tensor        # (N, 2) int32 -- (row, col), kept in the interior
    state: torch.Tensor      # (N, S) int32


class AgentCtx(NamedTuple):
    """What every agent may condition on during a cycle, batched over N."""

    agent_id: torch.Tensor   # (N,)       int32
    n_agents: int
    pos: torch.Tensor        # (N, 2)     int32
    state: torch.Tensor      # (N, S)     int32
    prev_type: torch.Tensor  # (N,)       int32
    patch: torch.Tensor      # (N, C, 3, 3) int32 -- receptive field on pos
    key: torch.Tensor        # (N, 2)     threefry key words (int64)
    step: int
    # scratch shared by the characteristics of one cycle: draws that several
    # of them take from the same per-agent keys are made once
    memo: dict


class AgentUpdate(NamedTuple):
    """Result of one Pr->Pu->Pw->Pa->Pm cycle, batched over N agents."""

    writes: torch.Tensor      # (N, K, 4) int32 -- (channel, row, col, value),
                              # max-combined; value 0 is a no-op (the
                              # blackboard's values are >= 0). K <= writes_cap
                              # and may differ between characteristics.
    state: torch.Tensor       # (N, S) int32
    new_type: torch.Tensor    # (N,)   int32 -- proposed characteristic
    trans_prob: torch.Tensor  # (N,)   float32 -- chance the Pa change commits
    pos: torch.Tensor         # (N, 2) int32 -- new receptive-field position


def no_writes(n: int, device=None) -> torch.Tensor:
    return torch.zeros((n, 0, 4), dtype=I32, device=device)


Behavior = Callable[[AgentCtx], AgentUpdate]


def as_key(key, device) -> torch.Tensor:
    """A (2,) uint32 threefry key (numpy, e.g. ``prng.PRNGKey``, or a tensor)
    as the int64 words ``prng`` works on, on ``device``."""
    if isinstance(key, np.ndarray):
        key = key.astype(np.int64)
    return torch.as_tensor(key, dtype=torch.int64, device=device)


class AgentModel:
    """A MIMD program: a finite characteristic set + the shared-environment
    semantics."""

    def __init__(self, behaviors: Sequence[Behavior], num_channels: int,
                 state_size: int, writes_cap: int,
                 presence_channel: int | None = None):
        self.behaviors = tuple(behaviors)
        self.num_types = len(behaviors)
        self.num_channels = num_channels
        self.state_size = state_size
        self.writes_cap = writes_cap
        # presence channels [presence_channel, presence_channel + num_types)
        # are rebuilt every cycle with per-type agent counts -- the "cytokine"
        # by which agents sense neighbouring populations.
        self.presence_channel = presence_channel

    # -- Pr ---------------------------------------------------------------
    @staticmethod
    def _read_patches(grid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """(N, C, 3, 3) receptive fields. Positions are kept in [1, H-2] x
        [1, W-2] so a window never leaves the grid (layouts carry an empty
        margin); the start is clamped as ``lax.dynamic_slice`` clamps it."""
        _, h, w = grid.shape
        off = torch.arange(3, device=grid.device)
        r0 = torch.clamp(pos[:, 0].long() - 1, 0, h - 3)
        c0 = torch.clamp(pos[:, 1].long() - 1, 0, w - 3)
        rows = (r0[:, None] + off)[:, :, None]            # (N, 3, 1)
        cols = (c0[:, None] + off)[:, None, :]            # (N, 1, 3)
        return grid[:, rows, cols].permute(1, 0, 2, 3)    # (N, C, 3, 3)

    def _presence(self, grid: torch.Tensor, agents: Agents) -> torch.Tensor:
        if self.presence_channel is None:
            return grid
        base = self.presence_channel
        grid = grid.clone()
        grid[base:base + self.num_types] = 0
        ch = base + agents.type_id.long()
        ones = torch.ones_like(agents.type_id)
        grid.index_put_((ch, agents.pos[:, 0].long(), agents.pos[:, 1].long()),
                        ones, accumulate=True)
        return grid

    # -- one full cycle for the whole population --------------------------
    def step(self, grid: torch.Tensor, agents: Agents, key: torch.Tensor,
             t: int = 0):
        """One synchronous cycle. ``key`` is this cycle's (2,) key; agent i
        draws from ``fold_in(key, i)``. Returns ``(grid, agents)``; the input
        grid is not modified."""
        n = agents.type_id.shape[0]
        dev = grid.device
        c, h, w = grid.shape
        grid = self._presence(grid, agents)
        patches = self._read_patches(grid, agents.pos)

        ids = torch.arange(n, dtype=I32, device=dev)
        keys = prng.fold_in(key[None, :], ids)
        ctx = AgentCtx(agent_id=ids, n_agents=n, pos=agents.pos,
                       state=agents.state, prev_type=agents.prev_type,
                       patch=patches, key=keys, step=t, memo={})
        upds = [b(ctx) for b in self.behaviors]
        sel = torch.clamp(agents.type_id.long(), 0, self.num_types - 1)
        rows = torch.arange(n, device=dev)

        # -- Pw: dominance semantics — scatter-max, value 0 is the identity,
        # so the writes of every characteristic go into one scatter, each
        # kept only for the agents of its type.
        ws = []
        for b, u in enumerate(upds):
            if u.writes.shape[1] > self.writes_cap:
                raise ValueError(f"characteristic {b} wrote "
                                 f"{u.writes.shape[1]} > {self.writes_cap}")
            if u.writes.shape[1]:
                ws.append(torch.where((sel == b)[:, None, None], u.writes,
                                      torch.zeros((), dtype=I32, device=dev)))
        if ws:
            wr = torch.cat(ws, dim=1).reshape(-1, 4).long()
            ch = torch.clamp(wr[:, 0], 0, c - 1)
            r = torch.clamp(wr[:, 1], 0, h - 1)
            cc = torch.clamp(wr[:, 2], 0, w - 1)
            v = torch.clamp(wr[:, 3], min=0).to(grid.dtype)
            grid = grid.clone()
            grid.view(-1).scatter_reduce_(0, (ch * h + r) * w + cc, v,
                                          reduce="amax", include_self=True)

        def pick(field):
            return torch.stack([getattr(u, field) for u in upds])[sel, rows]

        new_type, trans_prob = pick("new_type"), pick("trans_prob")
        # -- Pa: probabilistic commit (facilitation / inhibition already
        # folded into trans_prob by the behaviours, incl. ancestor damping).
        u = prng.uniform(prng.fold_in(keys, 7), 1)[:, 0]
        commit = (u < trans_prob) & (new_type != agents.type_id)
        type_id = torch.where(commit, new_type, agents.type_id)
        prev_type = torch.where(commit, agents.type_id, agents.prev_type)

        # -- Pm: clip receptive fields to the interior.
        pos = pick("pos")
        pos = torch.stack([torch.clamp(pos[:, 0], 1, h - 2),
                           torch.clamp(pos[:, 1], 1, w - 2)], dim=1)
        return grid, Agents(type_id.to(I32), prev_type.to(I32), pos.to(I32),
                            pick("state").to(I32))

    # -- drivers -----------------------------------------------------------
    def population(self, agents: Agents) -> torch.Tensor:
        """(num_types,) int32 count of agents per type. A comparison sum, not
        ``torch.bincount``, which reads its input's maximum back to the host
        on a CUDA tensor."""
        types = torch.arange(self.num_types, device=agents.type_id.device)
        return (agents.type_id[:, None] == types[None, :]).sum(0).to(I32)

    def run_scan(self, grid, agents: Agents, key, steps: int,
                 done_fn: Callable | None = None, record: bool = True):
        """Fixed-length run that freezes once ``done_fn(grid)`` holds. Returns
        ``(grid, agents, done_at, pops)``: ``done_at`` the first cycle at
        which ``done_fn`` held (``steps`` if never), ``pops`` the (steps,
        num_types) populations after each cycle (frozen rows repeat the last
        population; ``None`` without ``record``). Key schedule as the
        reference's scan: one split per cycle, ``done`` tested before it."""
        # the run's key chain stays on the host: a split of one key is ~150
        # tiny ops, launch-bound on a card; each cycle's key crosses once
        key = as_key(key, "cpu")
        pops = []
        done_at = steps
        for t in range(steps):
            key, sub = prng.split(key, 2).unbind(0)
            if done_fn is not None and bool(done_fn(grid)):
                done_at = t
                break
            grid, agents = self.step(grid, agents, sub.to(grid.device), t)
            if record:
                pops.append(self.population(agents))
        if not record:
            return grid, agents, done_at, None
        # the reference keeps stepping frozen: every later row repeats the
        # population at the freeze
        frozen = self.population(agents)
        pops.extend([frozen] * (steps - len(pops)))
        out = torch.stack(pops) if pops else \
            torch.zeros((0, self.num_types), dtype=I32, device=grid.device)
        return grid, agents, done_at, out

    def run_while(self, grid, agents: Agents, key, max_steps: int,
                  done_fn: Callable):
        """Early-exit driver for completion-time measurements (the paper's
        Fig. 4): steps while ``t < max_steps`` and not ``done_fn(grid)``.
        Returns ``(grid, agents, t)``."""
        key = as_key(key, "cpu")              # host key chain (run_scan)
        t = 0
        while t < max_steps and not bool(done_fn(grid)):
            key, sub = prng.split(key, 2).unbind(0)
            grid, agents = self.step(grid, agents, sub.to(grid.device), t)
            t += 1
        return grid, agents, t


def uniform_random_agents(key, n: int, h: int, w: int, state_size: int,
                          init_type: int = 0, device="cuda") -> Agents:
    """The paper's initial condition: agents uniformly distributed over the
    environment's interior, all of the initial (layer-finder) type."""
    kr, kc = prng.split(as_key(key, device), 2).unbind(0)
    rows = prng.randint(kr, (n,), 1, h - 1)
    cols = prng.randint(kc, (n,), 1, w - 1)
    return Agents(
        type_id=torch.full((n,), init_type, dtype=I32, device=device),
        prev_type=torch.full((n,), -1, dtype=I32, device=device),
        pos=torch.stack([rows, cols], dim=1),
        state=torch.zeros((n, state_size), dtype=I32, device=device),
    )


def agents_from_numpy(agents, device="cuda") -> Agents:
    """An ``Agents`` from any record with host-readable ``type_id``,
    ``prev_type``, ``pos`` and ``state`` fields (e.g. a JAX run's
    population), as int32 tensors on ``device``."""
    def t(x):
        return torch.as_tensor(np.array(x, np.int32), device=device)
    return Agents(t(agents.type_id), t(agents.prev_type), t(agents.pos),
                  t(agents.state))
