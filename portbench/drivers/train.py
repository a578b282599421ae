"""Training through the port's step (``repro_torch.train.train_step``) on
its data pipeline (``repro_torch.data.pipeline.sample_batch``).

Set-up builds one training state from the seed's weights and drives it
through its first three steps, on the window's own call and feed; the same
state then trains through the window. Of those three steps the check keeps
what the program reports and holds (each step's loss, the first clipped
gradient as the optimizer's first moment holds it, the weights' change
over the three), and after the window, with the program's state freed, the
plain reference follows the same three steps from the same weights on the
same batches.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import math
import time

from ..core import report, weights
from ..reference import transformer as reference

FOLLOWED = 3          # steps the reference follows


def data_seed(seed: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}/data".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFE


def tree_leaves(tree, path=()):
    """(path, tensor) of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (str(i),))
    else:
        yield path, tree


def leaf_name(path: tuple) -> str:
    """A leaf of the optimizer's tree by the weights' naming: the stack's
    ``stack/<segment>/<position>/mixer/wq`` is ``mixer.wq``."""
    if path and path[0] == "stack":
        path = path[3:]
    return ".".join(path)


class Train:
    def __init__(self, cell, seed: int, seconds: float, device: str = "cuda"):
        import torch
        self.torch = torch
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.device = device
        self.m = cell.config["model"]
        self.t = cell.config["train"]
        self.r = cell.config.get("router", {})
        self.batch = cell.traffic["batch"]
        self.seq = cell.traffic["seq"]

    def setup(self):
        torch = self.torch
        from repro_torch.configs.base import ModelConfig, TrainConfig
        from repro_torch.core import router as irouter
        from repro_torch.data import pipeline
        from repro_torch.models import model as model_lib
        from repro_torch.train import optimizer, train_step
        self.pipeline, self.ts = pipeline, train_step
        self.cfg = ModelConfig(**{**self.m, "remat": self.t["remat"]})
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        self.tcfg = TrainConfig(**{k: v for k, v in self.t.items()
                                   if k in fields})
        self.rcfg = irouter.RouterConfig(**self.r)
        model = model_lib.Model(self.cfg, None, torch.device(self.device))
        weights.load_into(model, self.m, self.seed)
        model.requires_grad_(True)
        state_dtype = {"float32": torch.float32,
                       "bfloat16": torch.bfloat16}[self.t["moment_dtype"]]
        self.state = train_step.TrainState(
            params=model,
            opt=optimizer.init_opt_state(model_lib.param_layout(model, self.cfg),
                                         state_dtype=state_dtype),
            router=train_step.init_router(self.cfg, self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device))
        self.data = pipeline.init_data_state(self.device)
        self.dseed = data_seed(self.seed)
        self.batches, self.losses = [], []
        for step in range(1, FOLLOWED + 1):
            batch, self.data = pipeline.sample_batch(
                self.cfg, self.batch, self.seq, self.data, seed=self.dseed)
            self.batches.append(batch["tokens"].clone())
            self.state, met = train_step.train_step(self.state, batch,
                                                    self.cfg, self.tcfg,
                                                    self.rcfg)
            self.losses.append(float(met.loss))
            if step == 1:
                self.grad_norms = self._first_grads()
        self.change = self._change()
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def _first_grads(self) -> dict:
        """Each leaf's norm of the clipped gradient of step 1, from the
        optimizer's first moment (``(1 - beta1) * g`` after one step)."""
        b1 = self.t["beta1"]
        return {leaf_name(p): float(t.double().norm()) / (1 - b1)
                for p, t in tree_leaves(self.state.opt.mu)}

    def _change(self) -> dict:
        """Each leaf's norm of its weights' change since the start, the
        starting weights drawn again tensor by tensor."""
        sq = {}
        with self.torch.no_grad():
            for name, p in self.state.params.named_parameters():
                p0 = weights.one(self.m, self.seed, name, p.device)
                d = float((p.detach().double() - p0.double()).square().sum())
                leaf = reference.leaf_of(name)
                sq[leaf] = sq.get(leaf, 0.0) + d
                del p0
        return {k: math.sqrt(v) for k, v in sq.items()}

    def window(self, run: report.Run):
        torch = self.torch
        losses, steps = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.seconds:
            s0 = time.perf_counter()
            batch, self.data = self.pipeline.sample_batch(
                self.cfg, self.batch, self.seq, self.data, seed=self.dseed)
            s1 = time.perf_counter()
            self.state, met = self.ts.train_step(self.state, batch, self.cfg,
                                                 self.tcfg, self.rcfg)
            s2 = time.perf_counter()
            run.spans.append(("sample_batch", s0, s1))
            run.spans.append(("train_step", s1, s2))
            losses.append(met.loss.detach())
            steps += 1
        if self.device == "cuda":
            torch.cuda.synchronize()
        run.window_s = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack(losses)) if losses else None
        run.attempted = steps
        run.failed = 0 if finite is None else int((~finite).sum())
        run.counters.update(steps=steps,
                            tokens=steps * self.batch * self.seq,
                            batch=self.batch, seq=self.seq)

    def release(self):
        self.state = None
        gc.collect()
        if self.device == "cuda":
            self.torch.cuda.synchronize()
            self.torch.cuda.empty_cache()


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers: the worst step's loss gap, and by the worst
    leaf the gap of the first gradient's norm and of the change's norm,
    each against the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left out
    of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    g_ref = ref["grad_norms"]
    med_g = sorted(g_ref.values())[len(g_ref) // 2]

    def worst(p, r, keys, med):
        return max(abs(p[k] - r[k]) / max(r[k], med) for k in keys)

    grad = worst(prog["grad_norms"], g_ref, g_ref, med_g)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
    c_ref = ref["change"]
    med_c = sorted(c_ref[k] for k in moved)[len(moved) // 2]
    change = worst(prog["change"], c_ref, moved, med_c)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def follow(m: dict, t: dict, r: dict, seed: int, batches: list, device: str,
           quant: str = None) -> dict:
    """The reference's three steps (``quant``: the control's precision)."""
    import torch
    w = dict(weights.make(m, seed, device, dtype=torch.float32))
    out = reference.train(m, t, r, w, [b.to(device).long() for b in batches],
                          quant=quant)
    sq = {}
    with torch.no_grad():
        for name in list(w):
            p0 = weights.one(m, seed, name, device).float()
            leaf = reference.leaf_of(name)
            sq[leaf] = sq.get(leaf, 0.0) + float((w[name].double()
                                                  - p0.double()).square().sum())
            del p0
    out["change"] = {k: math.sqrt(v) for k, v in sq.items()}
    del w
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        clock) -> report.Run:
    import torch
    from ..core import peaks
    from ..core.trace import Trace
    tr_ = Train(cell, seed, seconds, device)
    tr_.setup()
    tr = Trace(torch, trace and device == "cuda")
    r = report.Run(cell, device, tr)
    r.setup_s = clock()
    with tr:
        tr_.window(r)
    if device == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()
        r.device_kind = torch.cuda.get_device_name(0)
        r.peaks = peaks.peak(r.device_kind)
    prog = {"losses": tr_.losses, "grad_norms": tr_.grad_norms,
            "change": tr_.change}
    rows = [b.shape[0] for b in tr_.batches]
    distinct = sum(len({tuple(x.tolist()) for x in b}) for b in tr_.batches)
    batches = tr_.batches
    tr_.release()
    t_check = time.perf_counter()
    ref = follow(tr_.m, tr_.t, tr_.r, seed, batches, device)
    lim = cell.limits
    for k, v in gaps(prog, ref).items():
        if k in lim:                  # a number with no upper reading is
            r.checks[k] = {"value": v, "limit": lim[k]}   # not compared
    r.checks["repeated_rows"] = {"value": float(sum(rows) - distinct),
                                 "limit": 0}
    r.check_s = time.perf_counter() - t_check
    return r
