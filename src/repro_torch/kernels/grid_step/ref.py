"""Plain PyTorch version of the blackboard max-diffusion kernel (mirrors
``repro/kernels/grid_step/ref.py::grid_step_ref``: zero-padded edges), on a
plane or a stack of planes."""
from __future__ import annotations

import torch


def grid_step_planes_ref(labels, cond):
    """One synchronous step of label := max over 4-neighbours within cond,
    on every (H, W) plane of the last two dims on its own.

    labels, cond: (..., H, W) int -> (..., H, W). A cell with ``cond > 0``
    takes the max of its own label and, for each of the four directions, its
    neighbour's label where that neighbour lies in its plane and has
    ``cond > 0`` (else 0); every other cell keeps its label."""
    c = cond > 0
    out = labels
    zero = torch.zeros((), dtype=labels.dtype, device=labels.device)
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        sh = torch.roll(labels, (dr, dc), (-2, -1))
        sc = torch.roll(c, (dr, dc), (-2, -1))
        # roll wraps: zero out the wrapped row / column
        if dr == -1:
            sh, sc = _zero_row(sh, -1), _zero_row(sc, -1)
        if dr == 1:
            sh, sc = _zero_row(sh, 0), _zero_row(sc, 0)
        if dc == -1:
            sh, sc = _zero_col(sh, -1), _zero_col(sc, -1)
        if dc == 1:
            sh, sc = _zero_col(sh, 0), _zero_col(sc, 0)
        out = torch.maximum(out, torch.where(sc & c, sh, zero))
    return torch.where(c, out, labels)


# one (H, W) plane is the case of no leading dims
grid_step_ref = grid_step_planes_ref


def _zero_row(x, i):
    x = x.clone()
    x[..., i, :] = 0
    return x


def _zero_col(x, j):
    x = x.clone()
    x[..., j] = 0
    return x
