"""Sharding rules for the production meshes, as DTensor placements (PyTorch
port of ``repro/dist/sharding.py``).

Layout policy (mirrors the activation constraints in ``models/layers.py``):

  * **Tensor parallel ('model' axis)** — attention heads and FFN hidden dims
    are split over 'model'; embeddings split the vocab; MoE expert banks
    split the expert dim when ``pcfg.expert_parallel``.
  * **FSDP ('data' axis)** — when ``pcfg.fsdp``, the *other* matrix dim of
    each weight (and its optimizer moments) is additionally sharded over
    'data', ZeRO-3 style. The 'pod' axis (multi-pod mesh) stays pure
    data-parallel.
  * **Batches** — the batch dim shards over ('pod', 'data'); with
    ``pcfg.seq_shard`` the sequence dim of tokens/frames also shards over
    'model' (long-context prefill).
  * **Decode caches** — batch over ('pod', 'data'); KV heads over 'model'
    (or the sequence dim when ``pcfg.seq_shard``).

Every rule passes through the guard ``layers.constrain`` applies
(``models.layers.guard_entry``, one implementation): an axis the mesh lacks,
or that does not divide the dim it would split, is dropped. Leaves with no
rule are replicated.

The rules read the JAX package's layout: ``models.model.param_layout``
names, with stacked leaves (R, ...). Each function returns a tree of
:class:`P` (a tuple of partition-spec entries, compared with JAX's
``PartitionSpec`` entry for entry) shaped like its input tree. ``mesh`` is a
``DeviceMesh`` or a ``{axis: size}`` dict (the specs need only the sizes).
:func:`place` puts a tree on a mesh with those specs; a :class:`Model`'s
per-layer ``nn.Parameter`` takes its stacked leaf's spec without the leading
depth entry.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from ..configs.base import ModelConfig, ParallelConfig
from ..models import model as model_lib
from ..models.layers import guard_entry, placements  # noqa: F401 (re-export)

_DP = ("pod", "data")          # pure data-parallel axes, filtered to the mesh


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name, or a
    tuple of axis names); ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _axes(mesh) -> dict[str, int]:
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def _guard(spec: tuple, shape: tuple, axes: dict[str, int]) -> P:
    """Drop axis names the mesh lacks or that don't divide their dim — the
    ``models.layers.guard_entry`` policy the activation constraints apply."""
    return P(*(guard_entry(s, dim, axes) for s, dim in zip(spec, shape)))


def _is_leaf(node) -> bool:
    return hasattr(node, "shape") and not isinstance(node, (dict, list))


def _map_with_names(fn, tree, names=()):
    """``fn(names, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples; ``names`` are the string dict keys on the leaf's path
    (list and NamedTuple positions carry none, as in the JAX package)."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(list(names), tree)
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + ((k,) if isinstance(k, str)
                                                  else ()))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_with_names(fn, v, names) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, names) for v in tree)
    return fn(list(names), tree)


def _param_candidate(names: list[str],
                     pcfg: ParallelConfig) -> Optional[tuple]:
    """Unguarded trailing-dims spec for a param leaf, or None to replicate.

    ``names`` are the dict keys on the leaf's path (e.g. [..., 'mixer',
    'wq']); leading stack dims (depth) are padded with None by the caller.
    """
    if not names:
        return None
    last = names[-1]
    fsdp = "data" if pcfg.fsdp else None
    if last in ("embed", "head", "frontend_proj"):
        return ("model", fsdp)                      # (vocab|in, d_model)
    if "moe" in names:
        ep = "model" if pcfg.expert_parallel else None
        if last in ("w_gate", "w_up"):              # (E, d_model, d_ff)
            return (ep, fsdp, None if pcfg.expert_parallel else "model")
        if last == "w_down":                        # (E, d_ff, d_model)
            return (ep, fsdp if pcfg.expert_parallel else "model", None)
        if last == "w_router":                      # (d_model, E)
            return (fsdp, None)
    if last in ("wq", "wk", "wv"):                  # (d_model, heads*head_dim)
        return (fsdp, "model")
    if last == "wo":                                # (heads*head_dim, d_model)
        return ("model", fsdp)
    if last in ("w_gate", "w_up", "w_gate_branch", "w_x_branch"):
        return (fsdp, "model")                      # (d_model, d_ff|lru_width)
    if last in ("w_down", "w_out"):                 # (d_ff|width, d_model)
        return ("model", fsdp)
    if last == "in_proj":                           # ssm: (d_model, fused_inner)
        return (fsdp, "model")
    if last == "out_proj":                          # ssm: (d_inner, d_model)
        return ("model", fsdp)
    return None


def _param_spec(names: list[str], shape: tuple, mesh,
                pcfg: ParallelConfig, trim: int = 0) -> P:
    """Full guarded spec for one leaf. ``trim`` re-derives factored-moment
    specs: 1 drops the rule's last dim (Adafactor 'row'), 2 drops the last
    two and keeps the final one ('col')."""
    cand = _param_candidate(names, pcfg)
    if cand is None:
        return P()
    if trim == 1:
        cand = cand[:-1]
    elif trim == 2:
        cand = cand[:-2] + cand[-1:]
    full = (None,) * (len(shape) - len(cand)) + tuple(cand)
    if len(full) != len(shape):                     # rule arity mismatch
        return P()
    return _guard(full, shape, _axes(mesh))


def _layout(tree, cfg: ModelConfig):
    """A :class:`Model` as its JAX-layout tree of ``ParamLeaf`` s."""
    if isinstance(tree, model_lib.Model):
        return model_lib.param_layout(tree, cfg)
    return tree


def param_shardings(params: Any, cfg: ModelConfig, mesh,
                    pcfg: ParallelConfig = ParallelConfig()) -> Any:
    """Spec tree matching the JAX-layout parameter tree of ``params`` (a
    :class:`Model`, or that tree with anything that has a ``shape`` at the
    leaves)."""
    return _map_with_names(
        lambda names, x: _param_spec(names, tuple(x.shape), mesh, pcfg),
        _layout(params, cfg))


def train_state_shardings(state: Any, cfg: ModelConfig, mesh,
                          pcfg: ParallelConfig = ParallelConfig()) -> Any:
    """Spec tree matching a ``train_step.TrainState`` (its params as the
    JAX-layout tree). Optimizer moments follow their parameter's layout;
    Adafactor's factored second moments ('row'/'col' dicts) inherit the
    matching slice of it. The immune router state and step counters are
    tiny and replicated."""
    def leaf(names, x):
        if names and names[-1] in ("row", "col"):
            trim = 1 if names[-1] == "row" else 2
            return _param_spec(names[:-1], tuple(x.shape), mesh, pcfg,
                               trim=trim)
        return _param_spec(names, tuple(x.shape), mesh, pcfg)
    return _map_with_names(leaf, state._replace(
        params=_layout(state.params, cfg)))


def batch_shardings(batch: Any, mesh,
                    pcfg: ParallelConfig = ParallelConfig()) -> Any:
    """Batch dim over ('pod','data'); sequence over 'model' with
    seq_shard."""
    def leaf(names, x):
        nd = len(x.shape)
        seq = "model" if (pcfg.seq_shard and names
                          and names[-1] in ("tokens", "frames")) else None
        spec = (_DP, seq) + (None,) * (nd - 2) if nd >= 2 else (_DP,)
        return _guard(spec[:nd], tuple(x.shape), _axes(mesh))
    return _map_with_names(leaf, batch)


def cache_shardings(cache: Any, cfg: ModelConfig, mesh,
                    pcfg: ParallelConfig = ParallelConfig()) -> Any:
    """Decode-cache layout: (depth, batch, seq, kv_heads, head_dim) KV leaves
    shard batch over ('pod','data') and KV heads (or the sequence, under
    seq_shard) over 'model'; SSM/rglru recurrent states shard batch only."""
    def leaf(names, x):
        nd = len(x.shape)
        if names and names[-1] in ("k", "v") and nd == 5:
            if pcfg.seq_shard:
                spec = (None, _DP, "model", None, None)
            else:
                spec = (None, _DP, None, "model", None)
        elif nd >= 2:
            spec = (None, _DP) + (None,) * (nd - 2)
        else:
            return P()                              # 'pos' scalar
        return _guard(spec, tuple(x.shape), _axes(mesh))
    return _map_with_names(leaf, cache)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def _distribute(t: torch.Tensor, spec, mesh: DeviceMesh):
    """``t`` as a DTensor of ``spec``'s placements. Every rank holds the
    same full tensor (built from the same seed), so each keeps its own
    slice: nothing is sent."""
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def _place_model(model: nn.Module, layout: dict, specs: dict,
                 mesh: DeviceMesh) -> nn.Module:
    """Swap every Parameter of ``model`` for a DTensor Parameter of its
    leaf's spec (a stacked leaf's without the depth entry), in place."""
    owner = {id(p): name for name, p in model.named_parameters()}

    def put(leaf, spec):
        sub = spec[1:] if leaf.stacked and len(spec) else spec
        for p in leaf.params:
            mod_name, _, attr = owner[id(p)].rpartition(".")
            mod = model.get_submodule(mod_name)
            new = nn.Parameter(_distribute(p.detach(), sub, mesh),
                               requires_grad=p.requires_grad)
            setattr(mod, attr, new)

    def walk(lay, sp):
        if isinstance(lay, dict):
            for k in lay:
                walk(lay[k], sp[k])
        elif isinstance(lay, list):
            for a, b in zip(lay, sp):
                walk(a, b)
        else:
            put(lay, sp)

    walk(layout, specs)
    return model


def place(tree: Any, specs: Any, mesh: DeviceMesh,
          cfg: Optional[ModelConfig] = None) -> Any:
    """``tree`` on ``mesh`` with the spec tree ``specs`` (as the functions
    above return it): tensors become DTensors (``distribute_tensor``); a
    :class:`Model` (``cfg`` given) has its Parameters swapped in place and
    is returned."""
    if isinstance(tree, model_lib.Model):
        return _place_model(tree, model_lib.param_layout(tree, cfg), specs,
                            mesh)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return _distribute(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh, cfg) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[place(v, s, mesh, cfg)
                            for v, s in zip(tree, specs)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s, mesh, cfg) for v, s in zip(tree, specs))
    return tree
