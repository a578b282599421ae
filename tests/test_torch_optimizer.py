"""The port's AdamW and schedules (``repro_torch.train.optimizer``) against
the JAX package's on the CPU, and the rule they share: weight decay
(``ndim >= 2``) and factoring are decided on the leaves of the JAX
package's parameter tree, where every leaf inside the stack carries its
segment's repeat count R in front — so a stacked norm scale (R, D) is
decayed, and factored when R > 1, while ``final_norm``'s (D,) is not.

Tolerances: fp32 parameters and moments within 1e-6 of each leaf's max-abs
after five steps (the two packages reduce the norms and factored means in
another order); bf16 leaves within one bf16 ulp of that max."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.dist.checkpoint import flatten
from repro_torch.models import model as model_lib
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

TOL = {"float32": 1e-6, "bfloat16": 2 ** -7}


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = b.double().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _params(rng):
    """A stacked matrix (R=3), a stacked norm scale (R=3), a segment of one
    repeat's scale (R=1: 2-D, decayed, not factorable) and a 1-D leaf."""
    return {"stack": [[{"w": rng.normal(size=(3, 8, 5)),
                        "scale": rng.normal(size=(3, 8))}],
                      [{"scale": rng.normal(size=(1, 8))}]],
            "final": rng.normal(size=(8,))}


def _to_torch(tree, dtype=torch.float32):
    return model_lib.tree_map(lambda a: torch.tensor(a, dtype=dtype), tree)


def _to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(factored, state_dtype):
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    kw = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=20)
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    jp, tp = _to_jax(p0), _to_torch(p0)
    js = jopt.init_opt_state(jp, state_dtype=jnp.dtype(state_dtype),
                             factored=factored)
    ts = opt.init_opt_state(tp, state_dtype=getattr(torch, state_dtype),
                            factored=factored)
    for _ in range(5):
        g = jax.tree.map(lambda a: 3 * rng.normal(size=a.shape), p0)
        jp, js, jn = jopt.adamw_update(_to_jax(g), js, jp, jcfg)
        tp, ts, tn = opt.adamw_update(_to_torch(g), ts, tp, cfg)
        assert abs(float(jn) - float(tn)) <= 1e-6 * float(jn)
    ja, tb = jax.tree.leaves((jp, js)), flatten((tp, ts))[0]
    assert len(ja) == len(tb)
    for a, b in zip(ja, tb):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        tol = TOL["bfloat16" if b.dtype == torch.bfloat16 else "float32"]
        assert _rel(np.asarray(a, np.float32), b.float()) <= tol
    assert int(ts.step) == int(js.step) == 5


def test_factored_layout_follows_the_stacked_leaves():
    """The stacked (3, 8) scale is factored into (3,) / (8,); the (1, 8)
    segment's is not (a dimension of 1), nor is the 1-D leaf."""
    st = opt.init_opt_state(_to_torch(_params(np.random.default_rng(0))),
                            factored=True)
    seg0, seg1 = st.nu["stack"]
    assert tuple(seg0[0]["scale"]["row"].shape) == (3,)
    assert tuple(seg0[0]["scale"]["col"].shape) == (8,)
    assert tuple(seg0[0]["w"]["row"].shape) == (3, 8)
    assert tuple(seg1[0]["scale"].shape) == (1, 8)
    assert tuple(st.nu["final"].shape) == (8,)


def test_stacked_norm_scales_are_decayed():
    """With a zero gradient only weight decay moves a leaf: every leaf of
    two or more dims (the stacked norm scales among them) shrinks, the 1-D
    leaf stays."""
    p0 = _to_torch(_params(np.random.default_rng(1)))
    zeros = model_lib.tree_map(torch.zeros_like, p0)
    cfg = TrainConfig(learning_rate=0.1, warmup_steps=0, weight_decay=0.5)
    new, _, _ = opt.adamw_update(zeros, opt.init_opt_state(p0), p0, cfg)
    for key in ("w", "scale"):
        a, b = p0["stack"][0][0][key], new["stack"][0][0][key]
        assert (b.abs() < a.abs()).all()
    assert (new["stack"][1][0]["scale"].abs()
            < p0["stack"][1][0]["scale"].abs()).all()
    assert torch.equal(new["final"], p0["final"])


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_moments_update_in_place(factored, state_dtype):
    """The new state holds the old state's moment tensors, updated (one
    copy of the moments a step), with JAX's values after one step; the
    parameters passed in stay as they were."""
    rng = np.random.default_rng(2)
    p0 = _params(rng)
    g = jax.tree.map(lambda a: 3 * rng.normal(size=a.shape), p0)
    dt = getattr(torch, state_dtype)
    tp = _to_torch(p0)
    st = opt.init_opt_state(tp, state_dtype=dt, factored=factored)
    before = flatten(st)[0]
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=0)
    _, new, _ = opt.adamw_update(_to_torch(g), st, tp, cfg)
    after = flatten(new)[0]
    assert len(after) == len(before)
    assert all(a is b for a, b in zip(after[1:], before[1:]))   # [0]: step
    assert all(bool(a.abs().max() > 0) for a in after[1:])
    assert all(torch.equal(a, b) for a, b in
               zip(flatten(tp)[0], flatten(_to_torch(p0))[0]))
    js = jopt.init_opt_state(_to_jax(p0), state_dtype=jnp.dtype(state_dtype),
                             factored=factored)
    _, js, _ = jopt.adamw_update(_to_jax(g), js, _to_jax(p0),
                                 JTrainConfig(learning_rate=1e-2,
                                              warmup_steps=0))
    for a, b in zip(jax.tree.leaves(js)[1:], after[1:], strict=True):
        assert _rel(np.asarray(a, np.float32), b.float()) <= TOL[state_dtype]


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("factored", [False, True])
def test_model_opt_state_matches_jax_layout(arch, factored):
    """``init_opt_state`` over the Model's ``param_layout`` builds the JAX
    package's moment tree leaf for leaf (shape and dtype): the hybrid's
    tail segment of one repeat included."""
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = configs.get_config(arch).smoke()
    jst = jopt.init_opt_state(jmodel.init_params(jax.random.PRNGKey(0), jcfg),
                              factored=factored)
    model = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    st = opt.init_opt_state(model_lib.param_layout(model, cfg),
                            factored=factored)
    ja, tb = jax.tree.leaves(jst), flatten(st)[0]
    assert [tuple(a.shape) for a in ja] == [tuple(b.shape) for b in tb]
    assert all(str(a.dtype) == str(b.dtype).removeprefix("torch.")
               for a, b in zip(ja, tb))


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
@pytest.mark.parametrize("warmup,decay", [(0, 100), (10, 100), (5, 8)])
def test_schedule_matches_jax(kind, warmup, decay):
    kw = dict(learning_rate=1e-3, warmup_steps=warmup, decay_steps=decay,
              schedule=kind, stable_frac=0.8)
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    for s in range(0, decay + 12):
        ref = float(jopt.schedule(jcfg, jnp.asarray(s, jnp.int32)))
        got = float(opt.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        # within 1e-6 of the peak rate: cosine's 1 + cos(pi * frac) cancels
        # near the end, where the two libraries' cos round differently
        assert got == pytest.approx(ref, rel=0, abs=1e-6 * cfg.learning_rate)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(2)
    g = _params(rng)
    jn = float(jopt.global_norm(_to_jax(g)))
    assert float(opt.global_norm(_to_torch(g))) == pytest.approx(jn,
                                                                 rel=1e-6)
    jc, _ = jopt.clip_by_global_norm(_to_jax(g), 0.5)
    tc, tn = opt.clip_by_global_norm(_to_torch(g), 0.5)
    assert float(tn) == pytest.approx(jn, rel=1e-6)
    for a, b in zip(jax.tree.leaves(jc), flatten(tc)[0]):
        assert _rel(a, b) <= 1e-6
    bf = _to_torch(g, torch.bfloat16)
    clipped, _ = opt.clip_by_global_norm(bf, 0.5)
    assert all(x.dtype == torch.bfloat16 for x in flatten(clipped)[0])


class TestOptimizer:
    """Port copies of ``tests/test_train.py::TestOptimizer``."""

    def _rosenbrockish(self, factored):
        params = {"w": torch.tensor([[2.0, -3.0], [1.5, 0.5]])}
        cfg = TrainConfig(learning_rate=0.05, warmup_steps=0,
                          decay_steps=10000, weight_decay=0.0, grad_clip=1e9)
        state = opt.init_opt_state(params, factored=factored)

        def loss(p):
            return ((p["w"] - 1.0) ** 2).sum()

        for _ in range(300):
            w = params["w"].clone().requires_grad_(True)
            (g,) = torch.autograd.grad(loss({"w": w}), [w])
            params, state, _ = opt.adamw_update({"w": g}, state, params, cfg)
        return float(loss(params))

    def test_adamw_converges(self):
        assert self._rosenbrockish(factored=False) < 1e-3

    def test_factored_adamw_converges(self):
        assert self._rosenbrockish(factored=True) < 1e-2

    def test_grad_clip(self):
        g = {"w": torch.full((4,), 100.0)}
        clipped, norm = opt.clip_by_global_norm(g, 1.0)
        assert float(norm) == pytest.approx(200.0)
        assert float(opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)

    def test_wsd_schedule_shape(self):
        cfg = TrainConfig(learning_rate=1.0, warmup_steps=10, decay_steps=100,
                          schedule="wsd", stable_frac=0.8)
        lr = [float(opt.schedule(cfg, torch.tensor(s))) for s in range(110)]
        assert lr[0] == 0.0 and lr[10] == pytest.approx(1.0)
        assert lr[50] == pytest.approx(1.0)
        assert lr[79] == pytest.approx(1.0)
        assert lr[90] < 0.7 and lr[100] < 0.05

    def test_cosine_schedule_endpoints(self):
        cfg = TrainConfig(learning_rate=1.0, warmup_steps=0, decay_steps=100,
                          schedule="cosine")
        assert float(opt.schedule(cfg, torch.tensor(100))) == \
            pytest.approx(0.0, abs=1e-6)

    def test_factored_state_is_small(self):
        params = {"w": torch.zeros((256, 512))}
        full = opt.init_opt_state(params, factored=False)
        fact = opt.init_opt_state(params, factored=True)
        full_nu = sum(x.numel() for x in flatten(full.nu)[0])
        fact_nu = sum(x.numel() for x in flatten(fact.nu)[0])
        assert fact_nu < full_nu / 100


def test_param_layout_shapes_are_the_jax_leaves():
    """``ParamLeaf`` reports the JAX leaf's shape: a norm scale inside the
    stack is (R, D), ``final_norm``'s (D,)."""
    cfg = dataclasses.replace(configs.get_config("smollm-360m").smoke(),
                              num_layers=3)
    model = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    layout = model_lib.param_layout(model, cfg)
    assert layout["stack"][0][0]["norm1"]["scale"].shape == (3, cfg.d_model)
    assert layout["final_norm"]["scale"].shape == (cfg.d_model,)
    assert layout["stack"][0][0]["mixer"]["wq"].shape == \
        (3, cfg.d_model, cfg.num_heads * cfg.head_dim)
