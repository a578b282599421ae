"""Flash attention: the wrappers around the CUDA kernels
``csrc/flash_attention.cu`` (the forward replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py:flash_attention``; the backward
replaces none, the TPU kernel has no backward).

``flash_attention`` is the serving prefill's forward, which autograd does
not see. ``flash_attention_train`` is training's: an autograd Function whose
forward also keeps each row's log-sum-exp and whose backward is
``flash_attention_bwd`` (three launches, deterministic: no atomics).

Each wrapper checks device, shape, dtype and contiguity against the
kernels' contract for every call; then on CPU tensors it runs the plain
version (``ref.py``) and on CUDA tensors it launches the kernel on the
current stream or raises — there is no fallback. ``flash_attention.launches``
counts forward launches (the serving and the training ones), and
``flash_attention_bwd.launches`` backward calls; ``launches_by_path`` counts
them by the body the kernel library reports it took (``kernel_path``; the
backward has the ``mma`` body alone).
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .. import _build
from .ref import attention_bwd_ref, attention_fwd_ref, attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
# the head dims of the backward kernels (bf16 on the tensor cores)
BWD_HEAD_DIMS = (64, 128)
# the bodies of csrc/flash_attention.cu, by the code its entry point reports
PATHS = ("cuda_core", "mma")


def kernel_path(dtype: torch.dtype, head_dim: int,
                aligned: bool = True) -> str:
    """The body a CUDA call with inputs of ``dtype`` takes: ``"mma"`` (bf16
    on the tensor cores) at a head dim of ``_build.MMA_HEAD_DIMS`` (every
    head dim of ``HEAD_DIMS``), or ``"cuda_core"`` (fp32, and bf16 whose
    pointers are not 16-byte aligned, which cp.async needs). The C entry
    point makes the same choice."""
    return "mma" if dtype == torch.bfloat16 and aligned \
        and head_dim in _build.MMA_HEAD_DIMS else "cuda_core"


def _check(name: str, q, k, v) -> None:
    if k.device != q.device or v.device != q.device \
            or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device (or "
                         f"all on the CPU)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, s, d = q.shape
    bk, hk, sk, dk = k.shape
    if bk != b or sk != s or dk != d or d not in HEAD_DIMS or h % hk:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}; "
                         f"head dim must be in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; need "
                        f"one of float32, bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def _launch(q, k, v, causal: bool, lse=None):
    """The forward kernel on CUDA tensors; ``lse`` (B, H, S) fp32, when
    given, receives each row's log-sum-exp (the mma body's alone)."""
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lib = _build.library()
    path = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, k.shape[1], s, d,
            int(causal), DTYPES[q.dtype], stream, ctypes.byref(path))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_path[PATHS[path.value]] += 1
    return out


def flash_attention(q, k, v, causal: bool = True):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) -> (B, H, S, D) in q's type.
    Any S (the ragged last block is masked)."""
    _check("flash_attention", q, k, v)
    _build.check_no_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    return _launch(q, k, v, causal)


flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (cp.async's unit), copied only
    where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd(q, k, v, o, do, lse):
    """The gradients (dq, dk, dv) of causal ``o = attention(q, k, v)`` for
    the output's gradient ``do`` (q's shape and type), given the forward's
    ``lse`` (B, H, S) fp32. Head dims ``BWD_HEAD_DIMS``; on CUDA tensors
    bf16 alone. Deterministic: two calls give the same bits."""
    _check("flash_attention_bwd", q, k, v)
    b, h, s, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or tuple(lse.shape) != (b, h, s) \
            or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} "
                         f"{o.dtype}, do {tuple(do.shape)} {do.dtype}, lse "
                         f"{tuple(lse.shape)} {lse.dtype} for q "
                         f"{tuple(q.shape)} {q.dtype}")
    if any(t.device != q.device for t in (o, do, lse)) or not all(
            t.is_contiguous() for t in (o, do, lse)):
        raise ValueError("flash_attention_bwd: o, do, lse must be contiguous "
                         "and on q's device")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {d} not in "
                         f"{BWD_HEAD_DIMS}")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, lse)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_bwd: the kernels take bfloat16, "
                        f"not {q.dtype}")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd: inputs must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library()
    path = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1], s, d, stream,
            ctypes.byref(path))
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_path[PATHS[path.value]] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_path = dict.fromkeys(PATHS, 0)


class _FlashAttention(torch.autograd.Function):
    """Causal attention, forward with each row's log-sum-exp kept, backward
    by ``flash_attention_bwd``: the kernels on CUDA tensors, the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            out, lse = attention_fwd_ref(q, k, v)
        else:
            q, k, v = _aligned(q), _aligned(k), _aligned(v)
            lse = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)
            out = _launch(q, k, v, True, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, _aligned(dout), lse)
        return dq, dk, dv


def flash_attention_train(q, k, v):
    """Causal ``flash_attention`` that autograd differentiates: q (B, H, S,
    D), k, v (B, Hkv, S, D) -> (B, H, S, D), head dims ``BWD_HEAD_DIMS``; on
    CUDA tensors bf16 alone (the forward's mma body, which stores the
    log-sum-exp), fp32 or bf16 on the CPU."""
    _check("flash_attention_train", q, k, v)
    if q.shape[-1] not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_train: head dim {q.shape[-1]} not "
                         f"in {BWD_HEAD_DIMS}")
    if q.device.type == "cuda" and q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_train: the kernels train in "
                        f"bfloat16, not {q.dtype}")
    return _FlashAttention.apply(q, k, v)
