"""Plain PyTorch version of the grouped matmul kernel (mirrors
``repro/kernels/moe_gmm/ref.py::gmm_ref``)."""
from __future__ import annotations

import torch


def gmm_ref(x, w, group_sizes):
    """x: (E, C, D); w: (E, D, F); group_sizes: (E,) int -> (E, C, F) in x's
    type, fp32 math; rows ``>= group_sizes[e]`` are zero."""
    e, c, _ = x.shape
    rows = torch.arange(c, device=x.device)
    mask = rows[None, :, None] < group_sizes.to(x.device)[:, None, None]
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    return torch.where(mask, out, torch.zeros((), device=x.device)).to(x.dtype)
