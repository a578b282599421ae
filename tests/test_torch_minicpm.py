"""minicpm-2b (MHA at head dim 64, tied embeddings, the WSD schedule)
against the JAX package on the CPU, and a CPU rehearsal of
``chip_smoke.py``'s phase 15.

The config is minicpm-2b's own cut to 2 layers, d_model 512, 8 / 8 heads at
head_dim 64 (MHA, as published; ``.smoke()`` would make it GQA 4 / 2 at 16),
d_ff 1,024 and vocab 512, in fp32. Both packages get the same weights (the
JAX tree with every RMSNorm scale drawn away from its zero init, converted
by ``params_from_numpy``) and the same numpy tokens. Training parity (the
loss, gradients and a WSD train step) is in ``test_torch_train_loss.py`` and
``test_torch_train_step.py``.

Tolerances: prefill and decode logits within 1e-5; engine tokens exactly
equal; the WSD learning rates of both packages within 1e-9 of each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.serve import traces as jtraces
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.configs import minicpm_2b
from repro_torch.configs.base import TrainConfig
from repro_torch.models import model
from repro_torch.serve import api, engine, traces
from repro_torch.train import optimizer as opt

from _torch_rehearsal import (KERNEL_PATHS, StandIn, chip_smoke_on_cpu,
                              counting_wrappers)

torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

ARCH = "minicpm-2b"
TOL = 1e-5
SHAPE = dict(num_layers=2, d_model=512, num_heads=8, num_kv_heads=8,
             head_dim=64, d_ff=1024, vocab_size=512, dtype="float32")


def _with_scales(tree, seed=11):
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if getattr(path[-1], "key", None) != "scale":
            return x
        return (0.5 * rng.standard_normal(x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH), **SHAPE)
    cfg = dataclasses.replace(configs.get_config(ARCH), **SHAPE)
    tree = _with_scales(jax.tree.map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg)))
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        model.params_from_numpy(tree, cfg, "cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def test_config_is_minicpm_mha_at_head_dim_64(pair):
    jcfg, cfg, jp, tp = pair
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    full = configs.get_config(ARCH)
    assert (full.num_heads, full.num_kv_heads, full.head_dim, full.num_layers,
            full.d_ff, full.vocab_size) == (36, 36, 64, 40, 5760, 122_753)
    assert minicpm_2b.TRAIN_SCHEDULE == "wsd"
    assert not cfg.qk_norm and cfg.tie_embeddings
    assert tp.blocks[0].mixer.wk.shape[-1] == 8 * 64
    assert model.param_count(tp) == jmodel.param_count(jp)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("b,s", [(2, 37), (1, 70)])
def test_prefill_matches_jax(pair, backend, b, s):
    """Prefill logits and the dense cache it fills, both backends."""
    jcfg, cfg, jp, tp = pair
    toks = _tokens(s, (b, s), cfg.vocab_size)
    jl, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            jmodel.init_cache(jcfg, b, 80))
    tl, tc = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                           model.init_cache(cfg, b, 80, "cpu"),
                           attn_backend=backend)
    _close(tl, jl)
    for tseg, jseg in zip(tc["layers"], jc["layers"]):
        for tpos, jpos in zip(tseg, jseg):
            for name in ("k", "v"):
                _close(tpos[name], jpos[name])


def test_decode_step_paged_matches_jax(pair):
    """Three paged decode steps on the kernel backend: two slots over
    scattered pages, one inactive lane writing to the null page."""
    jcfg, cfg, jp, tp = pair
    page, maxp, num_pages = 8, 6, 16
    table = np.zeros((3, maxp), np.int32)
    table[0, :4] = [5, 2, 9, 14]
    table[1, :2] = [7, 3]
    jpool = jmodel.init_slot_cache_paged(jcfg, 3, page * maxp, num_pages,
                                         page)
    tpool = model.init_slot_cache_paged(cfg, 3, page * maxp, num_pages, page,
                                        "cpu")
    for slot, plen in ((0, 29), (1, 9)):
        toks = _tokens(slot, (1, plen), cfg.vocab_size)
        _, jone = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                 jmodel.init_cache(jcfg, 1, page * maxp))
        _, tone = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                                model.init_cache(cfg, 1, page * maxp, "cpu"),
                                attn_backend="kernel")
        jpool = jmodel.insert_slot_cache_paged(jpool, jone, jcfg, slot,
                                               jnp.asarray(table[slot]))
        tpool = model.insert_slot_cache_paged(tpool, tone, cfg, slot,
                                              torch.as_tensor(table[slot]))
    active = np.asarray([True, True, False])
    for step in range(3):
        nxt = _tokens(50 + step, (3, 1), cfg.vocab_size)
        jl, jpool = jmodel.decode_step(
            jp, jcfg, {"token": jnp.asarray(nxt)}, jpool,
            table=jnp.asarray(table), active=jnp.asarray(active))
        tl, tpool = model.decode_step(
            tp, cfg, {"token": torch.as_tensor(nxt)}, tpool,
            table=torch.as_tensor(table), active=torch.as_tensor(active),
            attn_backend="kernel")
        _close(tl[:2], jl[:2])


def test_engine_matches_jax_engine(pair):
    """A 5-request ``synthetic_trace`` (one lane sampled) on 2 slots: the
    port's engine emits the JAX engine's tokens exactly."""
    jcfg, cfg, jp, tp = pair

    def trace(mod, c):
        reqs = mod.synthetic_trace(c, num_requests=5, seed=1,
                                   prompt_lens=(9, 20), light_tokens=6,
                                   heavy_tokens=10, heavy_prompt=33)
        reqs[2].params = dataclasses.replace(reqs[2].params,
                                             temperature=0.8)
        return reqs

    ekw = dict(num_slots=2, max_cache=48, page_size=8, num_classes=3)
    jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**ekw))
    jeng.run(trace(jtraces, jcfg), max_ticks=300)
    teng = engine.Engine(tp, cfg, engine.EngineConfig(**ekw), device="cpu")
    assert teng.run(trace(traces, cfg), max_ticks=300)["completed"] == 5
    assert {r.rid: r.out_tokens for r in teng.completed} == \
        {r.rid: r.out_tokens for r in jeng.completed}


def test_wsd_schedule_of_phase15_matches_jax(monkeypatch):
    """Phase 15 (b)'s WSD config puts its three steps in the warmup, on the
    plateau and in the decay tail, at the JAX package's learning rates."""
    cs = chip_smoke_on_cpu(monkeypatch)
    tcfg = cs["wsd_config"](0)
    jt = JTrainConfig(**dataclasses.asdict(tcfg))
    lrs = [float(opt.schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(1, cs["WSD_STEPS"] + 1)]
    jlrs = [float(jopt.schedule(jt, jnp.asarray(s, jnp.int32)))
            for s in range(1, cs["WSD_STEPS"] + 1)]
    np.testing.assert_allclose(lrs, jlrs, rtol=0, atol=1e-9)
    assert lrs[0] < lrs[1] > lrs[2] > 0
    assert lrs[1] == pytest.approx(tcfg.learning_rate, rel=1e-7)
    assert isinstance(tcfg, TrainConfig) and tcfg.schedule == "wsd"


def test_phase15_rehearsal_on_cpu(monkeypatch):
    """``chip_smoke.minicpm_phase`` on the CPU (as the phase 14 rehearsal)
    with a bf16 minicpm-shaped smoke config, MHA 4 / 4 at head_dim 64: both
    backends serve their 8 requests, flash once a layer a prefill and paged
    decode once a layer a tick on ``mma``; three WSD train steps at the
    CPU schedule's rates; the smoke step held card (here CPU) to CPU."""
    cs = chip_smoke_on_cpu(monkeypatch)
    counters = counting_wrappers(monkeypatch)
    cfg = dataclasses.replace(configs.get_config(ARCH).smoke(),
                              dtype="bfloat16", num_heads=4, num_kv_heads=4,
                              head_dim=64)
    rep = cs["minicpm_phase"](torch, StandIn({ARCH: cfg}), engine, traces,
                              model, api, 0, counters, KERNEL_PATHS)
    k = rep["kernel"]
    assert k["requests"] == 8 and k["prefills"] == 8
    assert k["launches"] == {
        "paged_attention": 2 * k["decode_ticks"], "paged_attention_verify": 0,
        "flash_attention": 2 * k["prefills"], "moe_gmm": 0}
    assert all(p["cuda_core"] == 0 for p in k["paths"].values())
    assert rep["torch"]["launches"] == dict.fromkeys(counters, 0)
    steps = rep["train"]["steps"]
    assert [s["step"] for s in steps] == [1, 2, 3]
    assert all(s["lr"] == s["cpu_lr"] for s in steps)
    assert rep["parity_fp32"]["loss_abs_err"] <= 1e-5
