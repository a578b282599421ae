"""Meta-device dry-run: run every (arch x shape x mesh) cell's sharded step
on the production meshes (256 / 512 ranks of a ``fake`` process group, the
tensors on the ``meta`` device) and emit the roofline terms (PyTorch port
of ``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all     # 40 cells x 2 meshes

Per-cell results are appended as JSON lines to ``--out``. A cell builds its
params, train state and cache on ``meta``, places them with the
``dist.sharding`` trees on the production mesh, and runs one
``train_step``, ``prefill`` or ``serve_step`` under the mesh while
:class:`StepRecorder` reads the per-device work: each ``c10d_functional``
collective's per-device output bytes (times ``_COLL_FACTOR``) and the FLOPs
of the local ops (``torch.utils.flop_counter``'s formulas). The layers run
in a Python loop, so every layer's collectives are recorded as they run:
there is no scan to multiply. Any redistribution DTensor inserts is in the
collective bytes.

The analytic terms (``launch.roofline``) stay the primary numbers, as in the
JAX package. The constants are NVIDIA's data-sheet figures for the H100 SXM5
(``DEVICE``). The mesh keeps the JAX package's shapes and names so the
records line up: a 16-wide 'model' axis spans two 8-GPU NVLink domains, so
the collective term is a lower bound.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.serve.decode import serve_step
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

# NVIDIA H100 SXM5 data-sheet figures, per card
DEVICE = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
LINK_BW = 450e9            # NVLink 4 bytes/s, one direction
HBM_BYTES = 80e9           # 80 GB

# wire-traffic multiplier per op kind (ring algorithms, result-shape
# accounting); the kinds carry the JAX package's record names
_COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
_COLL_KIND = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
              "all_reduce_coalesced": "all-reduce",
              "all_gather_into_tensor": "all-gather",
              "all_gather_into_tensor_coalesced": "all-gather",
              "reduce_scatter_tensor": "reduce-scatter",
              "reduce_scatter_tensor_coalesced": "reduce-scatter",
              "all_to_all_single": "all-to-all",
              "shard_dim_alltoall": "all-to-all",
              "broadcast": "collective-permute"}
_COLL_NS = ("_c10d_functional", "_dtensor")


def start_world(world: int) -> None:
    """The fake process group of ``world`` ranks every cell's mesh lives in
    (the counterpart of the JAX dry-run's forced host device count). Its
    collectives move nothing; their shapes are the real ones."""
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _card_alltoall() -> None:
    """On a CPU mesh DTensor runs a shard-to-shard move as all-gather +
    chunk (gloo has no all-to-all); the card's NCCL mesh runs one
    all-to-all. The dry-run models the card, so it takes the card's path
    (the fake group accepts an all-to-all)."""
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import placement_types as pt

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    for mod in (cu, pt):
        if hasattr(mod, "shard_dim_alltoall"):
            mod.shard_dim_alltoall = shard_dim_alltoall


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class StepRecorder(TorchDispatchMode):
    """Per-device work of the ops a step runs: DTensor ops pass through
    (``NotImplemented``) to their local ops, which are counted — the FLOPs
    by ``torch.utils.flop_counter``'s formulas, each collective's output
    bytes times ``_COLL_FACTOR`` by kind. The fake-tensor ops of DTensor's
    sharding propagation run on global shapes and are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.coll_bytes = 0.0
        self.by_kind: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out        # DTensor's sharding propagation, not the step
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace in _COLL_NS:
            kind = _COLL_KIND.get(packet.__name__)
            if kind is not None:
                eff = _nbytes(out) * _COLL_FACTOR[kind]
                self.coll_bytes += eff
                self.by_kind[kind] = self.by_kind.get(kind, 0.0) + eff
                self.calls[kind] = self.calls.get(kind, 0) + 1
        return out


_DTYPES = {"int32": torch.int32, "float32": torch.float32}


def _meta_batch(cfg, shape) -> dict:
    return {k: torch.empty(s.shape, dtype=_DTYPES[s.dtype], device="meta")
            for k, s in configs.input_specs(cfg, shape).items()}


def _local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensors (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for leaf in _leaves(tree):
        t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        total += t.numel() * t.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               pcfg: ParallelConfig = ParallelConfig(),
               opt_dtype: str = "float32", factored: bool = False) -> dict:
    """Run one (arch, shape, mesh) cell on ``meta``; return its record."""
    cfg = configs.get_config(arch)
    if pcfg.remat != "none":
        cfg = dataclasses.replace(cfg, remat=pcfg.remat)
    if pcfg.capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=pcfg.capacity_factor)
    shape = configs.get_shape(shape_name)
    okay, why = configs.cell_supported(cfg, shape)
    if not okay:
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_name(multi_pod), "status": "skipped",
                "reason": why}

    start_world(512 if multi_pod else 256)
    _card_alltoall()
    mesh = make_production_mesh(multi_pod=multi_pod)
    layers.set_mesh_axes(mesh)
    n_chips = mesh.size()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, dispatch_groups=n_chips
                                  // mesh["model"].size())
    meta = torch.device("meta")
    params = model_lib.Model(cfg, None, meta)
    n_params = model_lib.param_count(params)
    n_active = model_lib.active_param_count(params, cfg)
    batch = _meta_batch(cfg, shape)
    batch = shd.place(batch, shd.batch_shardings(batch, mesh, pcfg), mesh)
    rec = StepRecorder()
    t0 = time.time()

    try:
        if shape.kind == "train":
            tcfg = TrainConfig()
            params.requires_grad_(True)
            state = ts.TrainState(
                params=params,
                opt=opt.init_opt_state(
                    model_lib.param_layout(params, cfg),
                    state_dtype=getattr(torch, opt_dtype), factored=factored),
                router=ts.init_router(cfg, meta),
                step=torch.zeros((), dtype=torch.int32, device=meta))
            state = shd.place(state, shd.train_state_shardings(
                state, cfg, mesh, pcfg), mesh, cfg)
            args = (state, batch)
            with layers.under_mesh(), rec:
                out = ts.train_step(state, batch, cfg, tcfg)
            out_bytes = _local_bytes(out[1])
            tokens = shape.global_batch * shape.seq_len
        else:
            shd.place(params, shd.param_shardings(params, cfg, mesh, pcfg),
                      mesh, cfg)
            bias = (shd.place(torch.zeros((cfg.num_layers, cfg.num_experts),
                                          device=meta), shd.P(), mesh)
                    if cfg.num_experts else None)
            cache = model_lib.init_cache(cfg, shape.global_batch,
                                         shape.seq_len, meta)
            cache = shd.place(cache, shd.cache_shardings(cache, cfg, mesh,
                                                         pcfg), mesh)
            args = (params, batch, cache, bias)
            with torch.no_grad(), layers.under_mesh(), rec:
                if shape.kind == "prefill":
                    logits, _ = model_lib.prefill(params, cfg, batch, cache,
                                                  attn_backend="torch",
                                                  router_bias=bias)
                else:
                    logits, _ = serve_step(params, cfg, batch, cache,
                                           router_bias=bias)
            out_bytes = _local_bytes(logits)     # the cache is updated in place
            tokens = shape.global_batch * (shape.seq_len
                                           if shape.kind == "prefill" else 1)
    finally:
        layers.set_mesh_axes(None)
    run_s = time.time() - t0

    arg_bytes = _local_bytes(args)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    terms = roofline.analytic_terms(cfg, shape, pcfg, n_params, n_active,
                                    n_chips, opt_dtype=opt_dtype,
                                    factored=factored, peak_flops=PEAK_FLOPS,
                                    hbm_bw=HBM_BW)
    t_coll = rec.coll_bytes / LINK_BW
    dominant = max(("compute", terms.t_compute), ("memory", terms.t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    bound = max(terms.t_compute, terms.t_memory, t_coll)
    return {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "status": "ok",
        "pcfg": {"fsdp": pcfg.fsdp, "seq_shard": pcfg.seq_shard,
                 "expert_parallel": pcfg.expert_parallel, "remat": pcfg.remat,
                 "capacity_factor": pcfg.capacity_factor,
                 "opt_dtype": opt_dtype, "factored": factored},
        "chips": int(n_chips), "device": DEVICE,
        "params": n_params, "active_params": n_active,
        "tokens_per_step": tokens,
        # analytic roofline terms (see launch/roofline.py for the model)
        "flops_per_device": terms.flops_per_device,
        "hbm_bytes_per_device": terms.hbm_bytes_per_device,
        "state_bytes_per_device": terms.state_bytes_per_device,
        "collective_bytes_per_device": rec.coll_bytes,
        "collective_by_kind": rec.by_kind, "collective_calls": rec.calls,
        "t_compute_s": terms.t_compute, "t_memory_s": terms.t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_total": model_flops,
        "useful_flops_frac": model_flops / max(terms.flops_total, 1.0),
        "roofline_frac": (model_flops / n_chips / PEAK_FLOPS)
        / max(bound, 1e-12),
        # the local ops' FLOPs as run (a secondary observable)
        "torch_flops_per_device": float(rec.flops),
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "total_nonaliased": arg_bytes + out_bytes},
        "fits_hbm": terms.state_bytes_per_device <= 0.9 * HBM_BYTES,
        # wall seconds of the meta-device run (there is no compile)
        "compile_s": run_s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun.jsonl")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--no-expert-parallel", action="store_true")
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--opt-dtype", default="float32")
    ap.add_argument("--factored", action="store_true")
    args = ap.parse_args(argv)

    pcfg = ParallelConfig(fsdp=not args.no_fsdp, seq_shard=args.seq_shard,
                          expert_parallel=not args.no_expert_parallel,
                          remat=args.remat,
                          capacity_factor=args.capacity_factor)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    cells = []
    if args.all:
        for arch in sorted(configs.ARCHS):
            for shape in ("train_4k", "prefill_32k", "decode_32k",
                          "long_500k"):
                for mp in (False, True):
                    cells.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        cells.append((args.arch, args.shape, args.multi_pod))

    records = []
    for arch, shape, mp in cells:
        try:
            rec = lower_cell(arch, shape, mp, pcfg,
                             opt_dtype=args.opt_dtype, factored=args.factored)
        except Exception as e:  # a failing cell is a bug — record it loudly
            rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(mp),
                   "status": "error",
                   "error": f"{type(e).__name__}: {e}"[:2000]}
        records.append(rec)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if rec["status"] == "ok":
            print(f"{arch:24s} {shape:12s} {rec['mesh']:8s} OK "
                  f"compute={rec['t_compute_s']:.3e}s "
                  f"memory={rec['t_memory_s']:.3e}s "
                  f"coll={rec['t_collective_s']:.3e}s "
                  f"dom={rec['dominant']:10s} roof={rec['roofline_frac']:.2f} "
                  f"fits={rec['fits_hbm']} run={rec['compile_s']:.0f}s",
                  flush=True)
        else:
            print(f"{arch:24s} {shape:12s} {rec['mesh']:8s} "
                  f"{rec['status'].upper()}: "
                  f"{rec.get('reason', rec.get('error'))}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return records


if __name__ == "__main__":
    main()
