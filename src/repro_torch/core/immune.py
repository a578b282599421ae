"""Immune-system load-balancing primitives (Clark 2022) as small state
machines over float32 tensors (PyTorch port of ``repro/core/immune.py``).

  * immunological memory      -> ``ImmuneMemory``      (EMA of observed signals)
  * two-stage delayed
    suppression (T4/T8)       -> ``TwoStageRegulator`` (fast positive response,
                                                        delayed negative feedback)
  * tolerance / anergy
    (+ IL-2 reactivation)     -> ``AnergyGate``        (suppress responses lacking
                                                        co-stimulation; reversible)
  * dominance                 -> ``dominance_scatter_max`` / ``dominance_resolve``

Every state is float32, as in the JAX package, so host-side admission
decisions taken from them match the reference's. The constructors put their
state on ``cuda`` unless the caller passes ``device``; the serving engine
passes ``"cpu"``, because its admission control reads them on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

F32 = torch.float32


def _t(x, device="cpu") -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


# ---------------------------------------------------------------------------
# Immunological memory
# ---------------------------------------------------------------------------
class ImmuneMemory(NamedTuple):
    """EMA memory of a signal. ``decay`` plays the role of cytokine half-life."""

    value: torch.Tensor
    decay: torch.Tensor  # scalar in [0, 1)

    @staticmethod
    def create(shape, decay: float = 0.99, device="cuda") -> "ImmuneMemory":
        return ImmuneMemory(value=torch.zeros(shape, dtype=F32, device=device),
                            decay=_t(decay, device))

    def update(self, observation) -> "ImmuneMemory":
        obs = _t(observation, self.value.device)
        new = self.decay * self.value + (1.0 - self.decay) * obs
        return self._replace(value=new)


# ---------------------------------------------------------------------------
# Two-stage delayed regulation (T4 helper / T8 suppressor)
# ---------------------------------------------------------------------------
class RegulatorState(NamedTuple):
    """``response`` — the fast T4-like population; ``suppressor`` — the T8-like
    population that grows in response to it and only then suppresses it."""

    response: torch.Tensor
    suppressor: torch.Tensor


class TwoStageRegulator(NamedTuple):
    """dr/dt = gain*stimulus + self_excite*r - suppression*s*r - leak_r*r
    ds/dt = couple*r - leak_s*s   (explicit Euler, dt folded into the rates)."""

    gain: torch.Tensor
    self_excite: torch.Tensor
    suppression: torch.Tensor
    couple: torch.Tensor
    leak_r: torch.Tensor
    leak_s: torch.Tensor

    @staticmethod
    def create(gain: float = 1.0, self_excite: float = 0.15,
               suppression: float = 0.9, couple: float = 0.25,
               leak_r: float = 0.05, leak_s: float = 0.1,
               device="cuda") -> "TwoStageRegulator":
        return TwoStageRegulator(
            gain=_t(gain, device), self_excite=_t(self_excite, device),
            suppression=_t(suppression, device), couple=_t(couple, device),
            leak_r=_t(leak_r, device), leak_s=_t(leak_s, device))

    def init(self, shape) -> RegulatorState:
        dev = self.gain.device
        return RegulatorState(torch.zeros(shape, dtype=F32, device=dev),
                              torch.zeros(shape, dtype=F32, device=dev))

    def step(self, state: RegulatorState, stimulus) -> RegulatorState:
        r, s = state.response, state.suppressor
        stim = _t(stimulus, r.device)
        dr = self.gain * stim + self.self_excite * r \
            - self.suppression * s * r - self.leak_r * r
        ds = self.couple * r - self.leak_s * s
        return RegulatorState(torch.clamp_min(r + dr, 0.0),
                              torch.clamp_min(s + ds, 0.0))


# ---------------------------------------------------------------------------
# Tolerance / anergy
# ---------------------------------------------------------------------------
class AnergyState(NamedTuple):
    """Per-unit anergy level in [0, 1]; 1 == fully anergic."""

    level: torch.Tensor


class AnergyGate(NamedTuple):
    """Units whose stimulus arrives without co-stimulation become anergic
    (gated off); an IL-2-like signal revives them."""

    onset: torch.Tensor
    revival: torch.Tensor
    floor: torch.Tensor

    @staticmethod
    def create(onset: float = 0.2, revival: float = 0.5, floor: float = 0.0,
               device="cuda") -> "AnergyGate":
        return AnergyGate(_t(onset, device), _t(revival, device),
                          _t(floor, device))

    def init(self, shape) -> AnergyState:
        return AnergyState(torch.zeros(shape, dtype=F32,
                                       device=self.onset.device))

    def step(self, state: AnergyState, stimulus, costimulus,
             il2: Union[torch.Tensor, float] = 0.0) -> AnergyState:
        dev = state.level.device
        stim = torch.clamp(_t(stimulus, dev), 0.0, 1.0)
        co = torch.clamp(_t(costimulus, dev), 0.0, 1.0)
        uncostimulated = stim * (1.0 - co)
        lvl = state.level + self.onset * uncostimulated * (1.0 - state.level)
        lvl = lvl - self.revival * _t(il2, dev) * lvl
        return AnergyState(torch.clamp(lvl, 0.0, 1.0))

    def gate(self, state: AnergyState, response) -> torch.Tensor:
        scale = 1.0 - (1.0 - self.floor) * state.level
        return _t(response, state.level.device) * scale


# ---------------------------------------------------------------------------
# Dominance
# ---------------------------------------------------------------------------
def dominance_scatter_max(grid: torch.Tensor, rows: torch.Tensor,
                          cols: torch.Tensor, values: torch.Tensor
                          ) -> torch.Tensor:
    """``cell := max(cell, agent_value)`` for every (row, col, value) write;
    contested cells keep the highest value. Returns a new grid."""
    out = grid.clone()
    flat = rows.long() * grid.shape[1] + cols.long()
    out.view(-1).scatter_reduce_(0, flat, values.to(grid.dtype), reduce="amax")
    return out


def dominance_resolve(ids: torch.Tensor, claims: torch.Tensor) -> torch.Tensor:
    """Only the highest claiming id wins a shared scalar resource. Returns a
    bool mask of winners (at most one True)."""
    claim_ids = torch.where(claims, ids, torch.full_like(ids, -1))
    winner = claim_ids.max()
    return (claim_ids == winner) & (winner >= 0)


# ---------------------------------------------------------------------------
# Limit-cycle damping
# ---------------------------------------------------------------------------
def damp_ancestor_transition(p, proposed, ancestor,
                             damping: float = 0.1) -> torch.Tensor:
    """Damp (not forbid) transitions back to an agent's ancestor type."""
    p = torch.as_tensor(p)
    return torch.where(torch.as_tensor(proposed) == torch.as_tensor(ancestor),
                       p * damping, p)


def hysteresis(current, target, up_rate: float,
               down_rate: float) -> torch.Tensor:
    """Asymmetric first-order tracking: fast toward larger targets, slow back."""
    current, target = torch.as_tensor(current), torch.as_tensor(target)
    rate = torch.where(target > current, torch.as_tensor(up_rate),
                       torch.as_tensor(down_rate))
    return current + rate * (target - current)
