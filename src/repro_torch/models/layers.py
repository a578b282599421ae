"""Building-block layers: norms, rotary, attention, MLP (PyTorch port of
``repro/models/layers.py``).

Conventions:
  * parameters live in ``nn.Module``s whose attribute names are the JAX
    package's parameter keys (``wq``, ``w_gate``, ``scale``...); the apply
    functions take the module and plain tensors
  * activations follow ``cfg.dtype``; softmax/normalization in fp32
  * KV caches are dicts of tensors that the attention functions update
    **in place** (``index_put_`` / ``copy_``) and return — where the JAX
    package returns new, donated pools. A caller that needs the old cache
    must copy it first.
  * ``backend`` (``BACKENDS``; carried as ``attn_backend`` by the callers)
    picks the route of every hand-written kernel: ``"kernel"`` (the default
    — the CUDA kernels on CUDA tensors, their plain versions on CPU tensors:
    paged decode and verify, flash prefill, and the MoE grouped matmul for
    the three expert products) or ``"torch"`` (the gather + ``_sdpa``
    attention oracle, mirroring the JAX package's ``"xla"``, and the expert
    einsums in the model dtype, as the JAX package computes them)
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                  local_map)

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention, flash_attention_train
from ..kernels.flash_attention.ops import BWD_HEAD_DIMS
from ..kernels.paged_attention import paged_attention, paged_attention_verify

BACKENDS = ("kernel", "torch")
NEG_INF = -1e30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"choose from {BACKENDS}")


# ---------------------------------------------------------------------------
# mesh-aware activation sharding constraints
# ---------------------------------------------------------------------------
DP = ("pod", "data")   # logical data-parallel axes (filtered to the live mesh)

# Axis names / sizes of the launcher's mesh, and the DeviceMesh itself.
# Launchers (dryrun, train, serve) declare their mesh with set_mesh_axes();
# CPU unit tests leave this empty and every constraint is a no-op.
_MESH_AXES: dict[str, int] = {}
_MESH: Optional[DeviceMesh] = None


def set_mesh_axes(mesh_or_axes, sizes=None) -> None:
    """Record the mesh the constraints read: a ``DeviceMesh`` (names and
    sizes), axis names with ``sizes``, or names alone (sizes unknown: no
    divisibility check); ``None`` or ``()`` clears it. Touches no device."""
    global _MESH_AXES, _MESH
    if isinstance(mesh_or_axes, DeviceMesh):
        _MESH = mesh_or_axes
        _MESH_AXES = dict(zip(mesh_or_axes.mesh_dim_names,
                              mesh_or_axes.shape))
        return
    _MESH = None
    axes = tuple(mesh_or_axes or ())
    if sizes is not None:
        _MESH_AXES = dict(zip(axes, tuple(sizes)))
    else:
        _MESH_AXES = {a: 0 for a in axes}


def _current_axes() -> dict[str, int]:
    return _MESH_AXES


def guard_entry(s, dim: int, axes: dict):
    """One partition-spec entry of the shared axis-drop policy.

    This is THE guard: the activation constraints here and
    ``dist.sharding``'s parameter rules both use it, so the two layouts
    cannot drift. Axis names the mesh doesn't have are dropped; an entry
    whose surviving axes' total size doesn't divide the dim it would split
    is dropped whole. Axis sizes recorded as 0 mean "unknown" and skip the
    divisibility check. Returns None, an axis name, or a tuple of names."""
    if s is None:
        return None
    is_seq = isinstance(s, (tuple, list))
    cand = tuple(a for a in (s if is_seq else (s,)) if a in axes)
    if not cand:
        return None
    size, known = 1, True
    for a in cand:
        if axes[a]:
            size *= axes[a]
        else:
            known = False
    if known and dim % size != 0:
        return None
    return cand if is_seq else cand[0]


def guard_spec(shape, *spec) -> tuple:
    """``spec`` guarded entry by entry against ``shape`` on the current
    mesh."""
    axes = _current_axes()
    return tuple(guard_entry(s, d, axes) for s, d in zip(spec, shape))


def placements(spec, mesh: DeviceMesh) -> tuple:
    """DTensor placements of a (guarded) partition spec: each mesh dim is
    ``Shard(i)`` of the tensor dim whose entry names it, else
    ``Replicate()``. A mesh dim of size 1 holds every tensor whole either
    way, and is ``Replicate()``: DTensor's view rules would otherwise
    refuse to merge a dim "sharded" over it."""
    out = []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        dims = [i for i, s in enumerate(spec) if s is not None
                and name in (s if isinstance(s, (tuple, list)) else (s,))]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The sharding constraint: a no-op outside a mesh and on plain tensors;
    a ``DTensor`` is redistributed to the placements of the guarded
    ``spec`` (an all-``None`` guarded spec leaves it as it is)."""
    if not _MESH_AXES or not isinstance(x, DTensor):
        return x
    filtered = guard_spec(x.shape, *spec)
    if all(s is None for s in filtered):
        return x
    return reshard(x, filtered)


def as_dtensor(x: torch.Tensor, mesh: DeviceMesh, target) -> DTensor:
    """``x`` with the DTensor ``placements`` ``target``: a plain tensor is
    taken as replicated (it is the same on every rank) and sliced locally."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(mesh, tuple(target))


def view(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``; a DTensor's result is pinned (re-wrapped from
    its local tensor), so its backward first redistributes the gradient to
    the forward's layout. A reshape's backward views the incoming gradient
    the other way, and DTensor refuses (or mis-sizes) that view when the
    gradient arrives sharded on a dim the forward left whole."""
    y = x.reshape(*shape)
    if not isinstance(y, DTensor):
        return y
    return DTensor.from_local(y.to_local(), y.device_mesh, y.placements,
                              run_check=False)


def local_apply(fn, args: tuple, specs: tuple, out_specs: tuple):
    """``fn`` on each rank's shards (``local_map``): every tensor of
    ``args`` is put on the placements of its guarded spec in ``specs``
    (a plain tensor taken as replicated; ``None`` args pass through) and
    the outputs are assembled with ``out_specs``. For math that is local
    once its batch and head dims are split, which DTensor's own
    propagation would otherwise split unevenly."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    ins = tuple(None if a is None else placements(sp, mesh)
                for a, sp in zip(args, specs))
    args = tuple(None if a is None else as_dtensor(a, mesh, p)
                 for a, p in zip(args, ins))
    outs = tuple(placements(sp, mesh) for sp in out_specs)
    return local_map(fn, out_placements=outs, in_placements=ins,
                     device_mesh=mesh)(*args)


def reshard(x: torch.Tensor, spec) -> torch.Tensor:
    """A DTensor redistributed to exactly the placements of the guarded
    ``spec`` (all-``None`` replicates it); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return as_dtensor(x, x.device_mesh, placements(spec, x.device_mesh))


def under_mesh():
    """The context the model runs in: with a mesh recorded, plain tensors
    the model makes (positions, masks, RoPE frequencies) meet DTensors as
    replicated ones (``implicit_replication``); else nothing."""
    if _MESH is None:
        return contextlib.nullcontext()
    return implicit_replication()


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _param(t: torch.Tensor) -> nn.Parameter:
    """A frozen parameter: serving records no autograd graph. The trainer
    turns gradients on for its own model (``train_step.init_train_state``)."""
    return nn.Parameter(t, requires_grad=False)


def _normal(gen: Optional[torch.Generator], shape, std: float, dtype,
            device) -> torch.Tensor:
    """N(0, std^2) drawn in fp32 on the generator's device, then cast and
    placed; ``gen=None`` leaves the tensor uninitialised (to be filled).
    Scaled in place, so a leaf costs one fp32 draw beside the model, not
    two (kimi-k2's 22.5 GB expert leaves: one layer in fp32 fits a card)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device).mul_(std)
    return w.to(device=device, dtype=dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device) -> torch.Tensor:
    return _normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype,
                   device)


def embed_init(gen, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    return _normal(gen, (vocab, dim), 0.02, dtype, device)


class RMSNorm(nn.Module):
    """Zero-initialised scale applied as ``(1 + scale)``."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.scale = _param(torch.zeros(dim, dtype=torch.float32,
                                        device=device))


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = dtype_of(cfg)
        d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = _param(dense_init(gen, d, h * hd, dt, device))
        self.wk = _param(dense_init(gen, d, hk * hd, dt, device))
        self.wv = _param(dense_init(gen, d, hk * hd, dt, device))
        self.wo = _param(dense_init(gen, h * hd, d, dt, device))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device)
            self.k_norm = RMSNorm(hd, device)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = dtype_of(cfg)
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _param(dense_init(gen, d, f, dt, device))
        self.w_up = _param(dense_init(gen, d, f, dt, device))
        self.w_down = _param(dense_init(gen, f, d, dt, device))


# ---------------------------------------------------------------------------
# RMSNorm / rotary
# ---------------------------------------------------------------------------
def rmsnorm(params: RMSNorm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + cfg.norm_eps)
    return (xf * (params.scale + 1.0)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                     exps)
    angles = positions[..., :, None, None].float() * freq
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _heads(y: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd) under the constraint (DP, None,
    'model', None). The projection takes the guarded head entry before the
    reshape: a DTensor cannot unflatten a dim split unevenly over the heads
    (GSPMD pads such a split; here the guard has already dropped it)."""
    b, s, _ = y.shape
    spec = guard_spec((b, s, n, hd), DP, None, "model", None)
    y = reshard(y, spec[:3]) if _MESH_AXES else y
    return constrain(view(y, b, s, n, hd), DP, None, "model", None)


def _qkv(params: Attention, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    b, s, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # heads shard over 'model' where they divide it; kv heads follow q heads
    q = _heads(x @ params.wq, h, hd)
    k = _heads(x @ params.wk, hk, hd)
    v = _heads(x @ params.wv, hk, hd)
    if cfg.qk_norm:
        q = rmsnorm(params.q_norm, q, cfg)
        k = rmsnorm(params.k_norm, k, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _group_heads(q: torch.Tensor, hk: int) -> torch.Tensor:
    """q (B, S, H, D) ready to view as (B, S, Hk, G, D): under a mesh its
    heads shard over 'model' exactly where the kv heads do (GQA groups stay
    co-located); a DTensor cannot split a head dim sharded wider than Hk."""
    if not (_MESH_AXES and isinstance(q, DTensor)):
        return q
    b, s, h, hd = q.shape
    spec = guard_spec((b, s, hk, h // hk, hd), DP, None, "model", None, None)
    return reshard(q, spec[:3] + (None,))


def _sdpa(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D); mask: (B|1, Sq, Skv) bool
    (True = attend). Probabilities are cast to v's type before the PV
    product, as in the JAX package."""
    b, sq, h, hd = q.shape
    hk = k.shape[2]
    g = h // hk
    q = view(_group_heads(q, hk), b, sq, hk, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return view(out, b, sq, h * hd)


def _window_prefix(m: torch.Tensor, qpos: torch.Tensor, kpos: torch.Tensor,
                   window: Optional[int],
                   prefix_len: Optional[int]) -> torch.Tensor:
    """A causal mask ``m`` narrowed to the last ``window`` positions and
    opened to bidirectional attention within the first ``prefix_len``
    positions (prefix-LM, PaliGemma's image prefix)."""
    if window is not None:
        m = m & (kpos > qpos - window)
    if prefix_len is not None:
        m = m | ((qpos < prefix_len) & (kpos < prefix_len))
    return m


def _block_mask(q0: int, k0: int, cq: int, ckv: int, window: Optional[int],
                prefix_len: Optional[int], device) -> torch.Tensor:
    """(cq, ckv) mask for a (q-chunk, kv-chunk) block at offsets."""
    qpos = q0 + torch.arange(cq, device=device)[:, None]
    kpos = k0 + torch.arange(ckv, device=device)[None, :]
    return _window_prefix(kpos <= qpos, qpos, kpos, window, prefix_len)


def _block_live(q0: int, q1: int, k0: int, k1: int, window: Optional[int],
                prefix_len: Optional[int]) -> bool:
    """Whether any (q, k) of the block [q0, q1) x [k0, k1) is attended: the
    causal band 0 <= q - k < window meets the block, or both lie in the
    prefix."""
    band = k0 <= q1 - 1 and (window is None or k1 - 1 > q0 - window)
    return band or (prefix_len is not None and q0 < prefix_len
                    and k0 < prefix_len)


def _sdpa_chunked(q, k, v, cfg: ModelConfig, window: Optional[int] = None,
                  prefix_len: Optional[int] = None, q_chunk: int = 1024,
                  kv_chunk: int = 1024) -> torch.Tensor:
    """Online softmax over KV chunks inside a loop over Q chunks — never
    materializes the (S, S) score matrix. The JAX package scans chunks of
    the largest power of two dividing S (4 at a 2,500-token prompt, which a
    Python loop cannot afford); here the chunks are ``q_chunk`` /
    ``kv_chunk`` long with a ragged last one, and KV chunks no query of the
    Q chunk attends are skipped (they would add exact zeros)."""
    b, s, h, hd = q.shape
    hk = k.shape[2]
    g = h // hk
    cq, ckv = min(q_chunk, s), min(kv_chunk, s)
    qt = view(_group_heads(q, hk), b, s, hk, g, hd) \
        .permute(0, 2, 3, 1, 4)                                # (B,K,G,S,D)
    kt = k.permute(0, 2, 1, 3)                                 # (B,K,S,D)
    vt = v.permute(0, 2, 1, 3)
    scale = 1.0 / math.sqrt(hd)
    blocks = []
    for q0 in range(0, s, cq):
        q1 = min(q0 + cq, s)
        qc = qt[:, :, :, q0:q1]
        m_run = torch.full((b, hk, g, q1 - q0), -math.inf, device=q.device)
        l_run = torch.zeros((b, hk, g, q1 - q0), device=q.device)
        acc = torch.zeros((b, hk, g, q1 - q0, hd), device=q.device)
        for k0 in range(0, s, ckv):
            k1 = min(k0 + ckv, s)
            if not _block_live(q0, q1, k0, k1, window, prefix_len):
                continue
            kc, vc = kt[:, :, k0:k1], vt[:, :, k0:k1]
            s_blk = torch.einsum("bkgqd,bktd->bkgqt", qc, kc).float() * scale
            mask = _block_mask(q0, k0, q1 - q0, k1 - k0, window, prefix_len,
                               q.device)
            s_blk = torch.where(mask, s_blk,
                                torch.tensor(NEG_INF, device=q.device))
            m_new = torch.maximum(m_run, s_blk.amax(-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] \
                + torch.einsum("bkgqt,bktd->bkgqd", p, vc.float())
            m_run = m_new
        blocks.append(acc / l_run.clamp_min(1e-30)[..., None])
    out = torch.cat(blocks, dim=3)                             # (B,K,G,S,D)
    out = view(out.permute(0, 3, 1, 2, 4), b, s, h * hd)
    return out.to(v.dtype)


_CHUNK_THRESHOLD = 2048  # the torch backend's chunked path beyond this


def _flash(fn, q, k, v) -> torch.Tensor:
    """``fn`` (``flash_attention``, or ``flash_attention_train`` for
    autograd), causal, on q: (B, S, H, D), k, v: (B, S, Hkv, D) in the
    kernels' (B, H, S, D) layout; returns (B, S, H * D)."""
    b, s, h, hd = q.shape
    out = fn(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
             v.transpose(1, 2).contiguous())
    return out.transpose(1, 2).reshape(b, s, h * hd)


def _sdpa_dispatch(q, k, v, cfg: ModelConfig, backend: str,
                   window: Optional[int] = None,
                   prefix_len: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention, causal, optionally sliding-window and / or
    prefix-LM. ``"kernel"`` runs the flash kernel (its plain version on CPU
    tensors) where the mask is plainly causal: like the TPU kernel it takes
    neither a window nor a prefix, so those masks take the torch path on
    either backend. ``"torch"`` is the XLA-path mirror (``_sdpa`` /
    ``_sdpa_chunked``)."""
    check_backend(backend)
    s = q.shape[1]
    if backend == "kernel" and window is None and prefix_len is None:
        return _flash(flash_attention, q, k, v)
    if s > _CHUNK_THRESHOLD:
        return _sdpa_chunked(q, k, v, cfg, window, prefix_len)
    return _sdpa(q, k, v, causal_mask(s, s, window, prefix_len,
                                      device=q.device), cfg)


def causal_mask(sq: int, skv: int, window: Optional[int] = None,
                prefix_len: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(1, sq, skv) causal (optionally sliding-window, optionally prefix-LM)
    mask; sq positions are the last sq of skv."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    return _window_prefix(kpos <= qpos, qpos, kpos, window, prefix_len)[None]


def write_cache_(dst: torch.Tensor, fn, values=(), indices=()):
    """``fn(dst, *values, *indices)`` writes into the cache tensor ``dst`` in
    place. A DTensor cache is written shard by shard: the values take
    ``dst``'s placements (a cache and its new rows share the batch and
    kv-head split), the indices are replicated — the writes are local, and
    no index op needs a sharding rule. ``None`` passes through."""
    if not isinstance(dst, DTensor):          # a plain cache takes values whole
        fn(dst, *[v.full_tensor() if isinstance(v, DTensor) else v
                  for v in values], *indices)
        return dst
    mesh = dst.device_mesh
    rep = (Replicate(),) * mesh.ndim
    fn(dst.to_local(),
       *[as_dtensor(v, mesh, dst.placements).to_local() for v in values],
       *[None if i is None else as_dtensor(i, mesh, rep).to_local()
         for i in indices])
    return dst


def masked_copy_(dst: torch.Tensor, src: torch.Tensor,
                 active: Optional[torch.Tensor]) -> torch.Tensor:
    """dst <- src in place; rows (dim 0) where ``active`` is False keep
    their values — the freeze of inactive slots' slot-row caches (recurrent
    state, ring buffers), which the JAX package applies to the new cache it
    returns."""
    def put(dst, src, active):
        src = src.to(dst.dtype)
        if active is not None:
            src = torch.where(active.reshape((-1,) + (1,) * (src.dim() - 1)),
                              src, dst)
        dst.copy_(src)

    return write_cache_(dst, put, (src,), (active,))


def flash_trains(device_type: str, dtype: torch.dtype, head_dim: int,
                 window: Optional[int], prefix_len: Optional[int],
                 distributed: bool) -> bool:
    """Whether training attention on q of this kind runs through the flash
    kernels (``flash_attention_train``: the forward with its log-sum-exp
    and the deterministic backward): a CUDA tensor that is not a DTensor,
    bf16, a head dim of the backward (``BWD_HEAD_DIMS``), the mask plainly
    causal. Everything else takes the torch route."""
    return (device_type == "cuda" and not distributed
            and dtype == torch.bfloat16 and head_dim in BWD_HEAD_DIMS
            and window is None and prefix_len is None)


def attention(params: Attention, x: torch.Tensor, cfg: ModelConfig,
              window: Optional[int] = None,
              prefix_len: Optional[int] = None) -> torch.Tensor:
    """Full-sequence (training) attention: causal, optionally sliding-window
    and / or prefix-LM. Where ``flash_trains`` says so (bf16 on one card at
    head dim 64 or 128, plainly causal) it runs the flash kernels forward
    and backward; elsewhere the torch route (``_sdpa`` / ``_sdpa_chunked``),
    as the JAX package trains through XLA: the CPU, a mesh's DTensors, fp32,
    other head dims, sliding windows and prefix-LM."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(params, x, cfg, positions)
    if flash_trains(q.device.type, q.dtype, q.shape[-1], window, prefix_len,
                    isinstance(q, DTensor)):
        out = _flash(flash_attention_train, q, k, v)
    else:
        out = _sdpa_dispatch(q, k, v, cfg, "torch", window, prefix_len)
    return out @ params.wo


def attention_prefill(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                      cache: dict, backend: str = "kernel",
                      window: Optional[int] = None,
                      prefix_len: Optional[int] = None):
    """Full-sequence pass that also fills the dense decode cache (in place).
    A sliding-window layer's cache is a ring buffer: past its length the
    last positions land at their ring slots."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(params, x, cfg, positions)
    out = _sdpa_dispatch(q, k, v, cfg, backend, window, prefix_len)
    s_max = cache["k"].shape[1]
    if window is not None and s > s_max:
        def put(dst, new):
            slots = torch.arange(s - s_max, s, device=dst.device) % s_max
            dst[:, slots] = new[:, -s_max:]
    else:
        def put(dst, new):
            dst[:, :min(s, s_max)] = new[:, :s_max]
    write_cache_(cache["k"], put, (k,))
    write_cache_(cache["v"], put, (v,))
    return out @ params.wo, cache


def attention_decode(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                     cache: dict, pos: torch.Tensor,
                     window: Optional[int] = None,
                     active: Optional[torch.Tensor] = None):
    """One-token decode against the dense cache {'k','v': (B, S_max, Hkv, D)}
    (updated in place). ``pos`` is () for a lockstep batch or (B,) when each
    row sits at its own depth. With ``window`` the cache is a ring buffer of
    S_max slots and a row attends its last min(pos + 1, S_max) writes.
    ``active`` (B,) keeps the cache rows of inactive lanes unchanged (their
    output is garbage the caller discards)."""
    b = x.shape[0]
    per_slot = pos.dim() == 1
    positions = pos[:, None] if per_slot else pos.expand(b, 1)
    q, k, v = _qkv(params, x, cfg, positions)
    s_max = cache["k"].shape[1]
    slot = pos.long() % s_max if window is not None else pos.long()
    if per_slot:
        def put(dst, new, slot, active):
            rows = torch.arange(dst.shape[0], device=dst.device)
            new = new[:, 0]
            if active is not None:
                new = torch.where(active[:, None, None], new, dst[rows, slot])
            dst[rows, slot] = new

        for name, new in (("k", k), ("v", v)):
            write_cache_(cache[name], put, (new,), (slot, active))
        qref, sref = pos[:, None], slot[:, None]
    else:
        def put(dst, new, slot):
            dst.index_copy_(1, slot.reshape(1), new)

        write_cache_(cache["k"], put, (k,), (slot,))
        write_cache_(cache["v"], put, (v,), (slot,))
        qref, sref = pos.reshape(1, 1), slot.reshape(1, 1)
    kpos = torch.arange(s_max, device=x.device)[None, :]
    if window is not None:
        # ring buffer: the valid slots are the last min(pos + 1, s_max)
        age = (sref - kpos) % s_max
        mask = age < torch.clamp(qref + 1, max=s_max)
    else:
        mask = kpos <= qref                           # (B|1, S_max)
    out = _sdpa(q, cache["k"], cache["v"], mask[:, None, :], cfg)
    return out @ params.wo, cache


def init_attention_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
                         device) -> dict:
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, s_max, hk, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, s_max, hk, hd), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# paged attention (block-table KV cache — the serving engine's memory plane)
# ---------------------------------------------------------------------------
def init_attention_cache_paged(cfg: ModelConfig, num_pages: int,
                               page_size: int, dtype, device) -> dict:
    """Physical page pool for one attention layer: K/V as (P, page, Hkv, D).
    Page 0 is the null/trash page (see ``serve.paging``)."""
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (num_pages, page_size, hk, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pages: (P, page, Hkv, D); table: (..., maxp) -> (..., maxp*page, Hkv, D)."""
    g = pages[table.long()]
    return g.reshape(*table.shape[:-1], -1, *pages.shape[2:])


def _write_index(table: torch.Tensor, lpos: torch.Tensor,
                 active: Optional[torch.Tensor], page: int):
    """(physical page, offset) of each (lane, row) write at absolute
    positions ``lpos`` (B, S). Inactive lanes and positions at or past the
    table's ``maxp * page`` capacity write to the null page 0."""
    maxp = table.shape[1]
    writable = lpos < maxp * page
    if active is not None:
        writable = writable & active[:, None]
    pidx = torch.gather(table.long(), 1, (lpos // page).clamp(max=maxp - 1))
    return torch.where(writable, pidx, torch.zeros_like(pidx)), lpos % page


def attention_decode_paged(params: Attention, x: torch.Tensor,
                           cfg: ModelConfig, cache: dict, pos: torch.Tensor,
                           table: torch.Tensor, active: torch.Tensor,
                           backend: str = "kernel"):
    """One-token decode against the paged pool {'k','v': (P, page, Hkv, D)}.

    ``pos`` (B,) each slot's cache position; ``table`` (B, maxp) int32 block
    table; ``active`` (B,) routes inactive slots' writes to the null page.
    The new K/V is written into the pool in place; a position at or past the
    table's capacity (a self-speculative draft step near ``max_cache``) is
    routed to the null page too — the JAX package clamps the gather index
    there and writes into a discarded copy, the port writes in place.
    ``backend="kernel"`` runs the paged-decode kernel over the block table
    (its plain version on CPU tensors); ``"torch"`` gathers the pages into a
    dense (B, maxp*page, ...) K/V and runs the masked-softmax oracle."""
    check_backend(backend)
    b = x.shape[0]
    q, k, v = _qkv(params, x, cfg, pos[:, None])
    pidx, off = _write_index(table, pos.long()[:, None], active,
                             cache["k"].shape[1])
    cache["k"].index_put_((pidx[:, 0], off[:, 0]), k[:, 0])
    cache["v"].index_put_((pidx[:, 0], off[:, 0]), v[:, 0])
    if backend == "kernel":
        out = paged_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                              table, (pos + 1).to(torch.int32))
        out = out.reshape(b, 1, -1).to(v.dtype)
    else:
        gk = _gather_pages(cache["k"], table)
        gv = _gather_pages(cache["v"], table)
        kpos = torch.arange(gk.shape[1], device=x.device)[None, :]
        mask = kpos <= pos[:, None]
        out = _sdpa(q, gk, gv, mask[:, None, :], cfg)
    return out @ params.wo, cache


def attention_verify_paged(params: Attention, x: torch.Tensor,
                           cfg: ModelConfig, cache: dict, pos: torch.Tensor,
                           table: torch.Tensor,
                           active: Optional[torch.Tensor],
                           backend: str = "kernel"):
    """Batched Sq-position verify step against the paged pool
    (self-speculative decoding).

    x: (B, Sq, D) — row 0 is the slot's last emitted token at cache position
    ``pos``, rows 1..Sq-1 the draft tokens at ``pos+1..pos+Sq-1``. Every row
    writes its K/V at its own position, in place (inactive lanes and
    positions past the table's capacity write to the null page), then attends
    causally up to itself. Per row this is the computation
    ``attention_decode_paged`` runs at that position with that K/V prefix
    resident — the JAX package holds the two bitwise equal; here they agree
    within rounding (a 5-row and a 1-row projection sum in different orders
    on the card). Positions the accept loop rejects keep draft K/V; they are
    read only masked and are overwritten before they become visible.
    ``backend="kernel"`` runs the verify kernel (its plain version on CPU
    tensors); ``"torch"`` gathers the pages and runs ``_sdpa`` with a
    (B, Sq, S) mask."""
    check_backend(backend)
    b, sq, _ = x.shape
    lpos = pos.long()[:, None] + torch.arange(sq, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, lpos)
    pidx, off = _write_index(table, lpos, active, cache["k"].shape[1])
    cache["k"].index_put_((pidx, off), k)
    cache["v"].index_put_((pidx, off), v)
    if backend == "kernel":
        out = paged_attention_verify(q.contiguous(), cache["k"], cache["v"],
                                     table, pos.to(torch.int32))
        out = out.reshape(b, sq, -1).to(v.dtype)
    else:
        gk = _gather_pages(cache["k"], table)
        gv = _gather_pages(cache["v"], table)
        kpos = torch.arange(gk.shape[1], device=x.device)[None, None, :]
        out = _sdpa(q, gk, gv, kpos <= lpos[:, :, None], cfg)
    return out @ params.wo, cache


def attention_prefill_paged(params: Attention, x: torch.Tensor,
                            cfg: ModelConfig, cache: dict,
                            table_row: torch.Tensor, p0: int):
    """One prefill chunk (batch of 1) written straight into the slot's pages.
    x: (1, C, D); ``table_row`` (maxp,); ``p0`` the chunk's first absolute
    position. Queries attend over the gathered pages (masked)."""
    _, c, _ = x.shape
    lpos = p0 + torch.arange(c, device=x.device)
    q, k, v = _qkv(params, x, cfg, lpos[None, :])
    page = cache["k"].shape[1]
    pidx = table_row.long()[lpos // page]
    cache["k"].index_put_((pidx, lpos % page), k[0])
    cache["v"].index_put_((pidx, lpos % page), v[0])
    gk = _gather_pages(cache["k"], table_row)[None]
    gv = _gather_pages(cache["v"], table_row)[None]
    kpos = torch.arange(gk.shape[1], device=x.device)[None, :]
    mask = (kpos <= lpos[:, None])[None]
    out = _sdpa(q, gk, gv, mask, cfg)
    return out @ params.wo, cache


def attention_prefill_paged_multi(params: Attention, x: torch.Tensor,
                                  cfg: ModelConfig, cache: dict,
                                  tables: torch.Tensor, p0s: torch.Tensor):
    """``J`` concurrent prefill chunks, one per lane. x: (J, C, D); ``tables``
    (J, maxp); ``p0s`` (J,). Padding lanes carry all-null tables, so their
    writes land on the trash page."""
    j, c, _ = x.shape
    lpos = p0s.long()[:, None] + torch.arange(c, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, lpos)
    page = cache["k"].shape[1]
    pidx = torch.gather(tables.long(), 1, lpos // page)
    off = lpos % page
    cache["k"].index_put_((pidx, off), k)
    cache["v"].index_put_((pidx, off), v)
    gk = _gather_pages(cache["k"], tables)
    gv = _gather_pages(cache["v"], tables)
    kpos = torch.arange(gk.shape[1], device=x.device)[None, None, :]
    mask = kpos <= lpos[:, :, None]
    out = _sdpa(q, gk, gv, mask, cfg)
    return out @ params.wo, cache


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
def mlp(params: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = x @ params.w_gate
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate, approximate="tanh")
    return constrain(act * (x @ params.w_up), DP, None, "model") \
        @ params.w_down
