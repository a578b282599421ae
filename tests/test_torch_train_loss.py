"""The port's training forward (``model.train_loss`` through
``transformer.apply_stack`` / ``apply_block`` and ``layers.attention``) and
its gradients against ``jax.value_and_grad(model.train_loss)`` on the CPU,
on every family's ``.smoke()`` config; rematerialisation; the parameter
layout (``params_to_numpy``); and the boundary between training and the
kernels: the wrappers refuse inputs that require grad, training reaches no
wrapper, serving runs a model whose parameters require grad.

Tolerances: loss within 1e-5, each gradient leaf within 1e-5 of its
max-abs (fp32)."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grid_step import grid_step
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_verify)
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.serve import decode, traces
from repro_torch.serve import engine as eng_mod
from repro_torch.train import train_step as ts

torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

LOSS_TOL, GRAD_TOL = 1e-5, 1e-5
WRAPPERS = (flash_attention, paged_attention, paged_attention_verify,
            moe_gmm, grid_step)
# (arch, config overrides): every family, MoE under both router modes that
# change the loss, the hybrid with a window shorter than the sequence, and
# the two dense configs with their own paths (qwen3-4b's qk-norm, minicpm-2b)
CASES = [("smollm-360m", {}),
         ("granite-moe-3b-a800m", {}),
         ("granite-moe-3b-a800m", {"router_mode": "aux"}),
         ("mamba2-130m", {}),
         ("recurrentgemma-9b", {"local_window": 8}),
         ("paligemma-3b", {}),
         ("musicgen-medium", {}),
         ("qwen3-4b", {}),
         ("minicpm-2b", {})]


def _pair(arch, over):
    return (dataclasses.replace(jconfigs.get_config(arch).smoke(), **over),
            dataclasses.replace(configs.get_config(arch).smoke(), **over))


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = b.double().numpy()
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _setup(arch, over, seed=0, batch=2, seq=16):
    jcfg, cfg = _pair(arch, over)
    params = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    b, _ = jpipe.sample_batch(jcfg, batch, seq, jpipe.init_data_state())
    bias = None
    if jcfg.num_experts:
        rng = np.random.default_rng(seed)
        bias = (0.1 * rng.standard_normal(
            (jcfg.num_layers, jcfg.num_experts))).astype(np.float32)
    model = model_lib.params_from_numpy(jax.tree.map(np.asarray, params),
                                        cfg, "cpu").requires_grad_(True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    tbias = None if bias is None else torch.from_numpy(bias)
    return jcfg, cfg, params, b, bias, model, tb, tbias


@pytest.mark.parametrize("arch,over", CASES,
                         ids=[f"{a}{'-' + '-'.join(o) if o else ''}"
                              for a, o in CASES])
def test_train_loss_and_grads_match_jax(arch, over):
    jcfg, cfg, params, b, bias, model, tb, tbias = _setup(arch, over)

    def loss_fn(p):
        out = jmodel.train_loss(p, jcfg, b, router_bias=None if bias is None
                                else jnp.asarray(bias))
        return out.loss, out

    (jl, jout), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    loss, stats, grads = ts.loss_and_grads(model, cfg, tb, tbias)
    assert abs(float(jl) - float(loss)) <= LOSS_TOL
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for a, g in zip(jleaves, grads):
        assert tuple(a.shape) == tuple(g.shape)
        assert _rel(a, g) <= GRAD_TOL
    assert abs(float(jout.aux_loss) - float(stats["aux"])) <= LOSS_TOL
    assert abs(float(jout.drop_frac) - float(stats["drop"])) <= LOSS_TOL
    if jcfg.num_experts:
        np.testing.assert_allclose(stats["load_frac"].numpy(),
                                   np.asarray(jout.load_frac), atol=1e-7)
    out = model_lib.train_loss(model, cfg, tb, router_bias=tbias)
    assert abs(float(out.logits_mean_abs) - float(jout.logits_mean_abs)) \
        <= LOSS_TOL


def test_aux_mode_adds_the_aux_term():
    """router_mode "aux": the loss is the cross-entropy plus
    aux_loss_coef * aux; "immune" leaves the aux term out."""
    _, cfg, _, _, _, model, tb, tbias = _setup("granite-moe-3b-a800m",
                                               {"router_mode": "aux"})
    with torch.no_grad():
        aux = model_lib.train_loss(model, cfg, tb, router_bias=tbias)
        imm = model_lib.train_loss(model, dataclasses.replace(
            cfg, router_mode="immune"), tb, router_bias=tbias)
    assert float(aux.aux_loss) > 0
    assert float(aux.loss) == pytest.approx(
        float(imm.loss) + cfg.aux_loss_coef * float(aux.aux_loss), abs=1e-6)


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_loss_and_grads(arch, remat):
    """``cfg.remat`` recomputes in the backward what it did not keep: the
    loss and every gradient equal the run without it."""
    _, cfg, _, _, _, model, tb, tbias = _setup(arch, {})
    plain = ts.loss_and_grads(model, cfg, tb, tbias)
    again = ts.loss_and_grads(model, dataclasses.replace(cfg, remat=remat),
                              tb, tbias)
    assert torch.equal(plain[0], again[0])
    for a, b in zip(plain[2], again[2]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)


def test_dots_remat_saves_only_the_plain_matmuls():
    """The "dots" policy keeps ``mm`` / ``addmm`` (``x @ W``) and
    recomputes the rest, the attention's batched products included."""
    ops = torch.ops.aten
    assert transformer._save_dots(None, ops.mm.default) == \
        torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    for op in (ops.bmm.default, ops._softmax.default, ops.mul.Tensor):
        assert transformer._save_dots(None, op) == \
            torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_apply_stack_layer_order_and_stats(arch):
    """``apply_stack`` is ``apply_block`` over the layers in depth order,
    each MoE layer routed with its own bias row; its stats are the layers'
    load fractions stacked and the means of aux and drop."""
    _, cfg, _, _, _, model, tb, tbias = _setup(arch, {})
    x, _ = model_lib._inputs(model, cfg, tb)
    with torch.no_grad():
        y, load, aux, drop = transformer.apply_stack(model.blocks, x, cfg,
                                                     bias=tbias)
        stats = []
        for li, blk in enumerate(model.blocks):
            x, st = transformer.apply_block(
                blk, x, cfg, None if tbias is None else tbias[li])
            stats.append(st)
    assert torch.equal(x, y)
    if cfg.num_experts:
        assert torch.equal(load, torch.stack([s.load_frac for s in stats]))
        assert torch.equal(aux, torch.stack([s.aux_loss
                                             for s in stats]).mean())
        assert torch.equal(drop, torch.stack([s.drop_frac
                                              for s in stats]).mean())
    else:
        assert load is None and float(aux) == 0 and float(drop) == 0


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m", "paligemma-3b"])
def test_params_to_numpy_is_the_jax_tree(arch):
    """``params_to_numpy`` inverts ``params_from_numpy``: the JAX
    package's tree back, leaf for leaf (structure, shape, dtype, values)."""
    jcfg, cfg = _pair(arch, {})
    params = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(3), jcfg))
    back = model_lib.params_to_numpy(
        model_lib.params_from_numpy(params, cfg, "cpu"), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_params_to_numpy_bf16_round_trip():
    cfg = dataclasses.replace(configs.get_config("smollm-360m").smoke(),
                              dtype="bfloat16")
    model = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    tree = model_lib.params_to_numpy(model, cfg)
    assert tree["embed"].dtype.name == "bfloat16"
    again = model_lib.params_from_numpy(tree, cfg, "cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_params_from_numpy_refuses_a_wrong_shape():
    jcfg, cfg = _pair("smollm-360m", {})
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0),
                                                       jcfg))
    tree["final_norm"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_norm.scale"):
        model_lib.params_from_numpy(tree, cfg, "cpu")


class TestKernelBoundary:
    def test_training_functions_take_no_backend(self):
        for fn in (model_lib.train_loss, transformer.apply_stack,
                   transformer.apply_block, ts.loss_and_grads, ts.train_step):
            params = inspect.signature(fn).parameters
            assert "backend" not in params and "attn_backend" not in params

    @pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
    def test_train_loss_reaches_no_kernel_wrapper(self, arch, monkeypatch):
        """No wrapper is called on the training path (on the CPU a wrapper
        runs its plain version and counts nothing, so each is replaced by
        a raiser)."""
        from repro_torch.models import layers, moe

        def boom(*a, **k):
            raise AssertionError("a kernel wrapper was called in training")

        for mod, name in ((layers, "flash_attention"),
                          (layers, "paged_attention"),
                          (layers, "paged_attention_verify"),
                          (moe, "moe_gmm")):
            monkeypatch.setattr(mod, name, boom)
        _, cfg, _, _, _, model, tb, tbias = _setup(arch, {})
        before = [w.launches for w in WRAPPERS]
        ts.loss_and_grads(model, cfg, tb, tbias)
        assert [w.launches for w in WRAPPERS] == before

    @pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                      "paged_attention_verify", "moe_gmm"])
    def test_wrappers_refuse_inputs_that_require_grad(self, name):
        """The kernels have no backward: under grad mode a wrapper refuses
        an input that requires grad, on the CPU as on the card; under
        no_grad it runs."""
        def t(*shape):
            return torch.randn(shape).requires_grad_(True)

        table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
        one = torch.tensor([20], dtype=torch.int32)
        call = {
            "flash_attention": lambda: flash_attention(
                t(1, 4, 9, 16), t(1, 2, 9, 16), t(1, 2, 9, 16)),
            "paged_attention": lambda: paged_attention(
                t(1, 4, 16), t(5, 8, 2, 16), t(5, 8, 2, 16), table, one),
            "paged_attention_verify": lambda: paged_attention_verify(
                t(1, 3, 4, 16), t(5, 8, 2, 16), t(5, 8, 2, 16), table, one),
            "moe_gmm": lambda: moe_gmm(t(2, 4, 8), t(2, 8, 16),
                                       torch.tensor([3, 0],
                                                    dtype=torch.int32)),
        }[name]
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()

    @pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
    def test_serving_a_model_that_requires_grad(self, arch):
        """A trained model keeps requires_grad; the engine and one-shot
        ``generate`` serve it (under no-grad, through the kernel wrappers)
        and give the tokens of the same weights without it."""
        cfg = configs.get_config(arch).smoke()
        model = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu").requires_grad_(True)
        frozen = model_lib.params_from_numpy(
            model_lib.params_to_numpy(model, cfg), cfg, "cpu")
        bias = torch.zeros((cfg.num_layers, cfg.num_experts)) \
            if cfg.num_experts else None
        prompts = {"tokens": torch.randint(0, cfg.vocab_size, (2, 9),
                                           generator=torch.Generator()
                                           .manual_seed(1))}
        a, _ = decode.generate(model, cfg, prompts, max_cache=32, steps=6,
                               router_bias=bias)
        b, _ = decode.generate(frozen, cfg, prompts, max_cache=32, steps=6,
                               router_bias=bias)
        assert torch.equal(a, b)
        ecfg = eng_mod.EngineConfig(num_slots=2, max_cache=64, page_size=8,
                                    prefill_chunk=8)
        trace = traces.synthetic_trace(cfg, num_requests=4, heavy_tokens=8)
        eng = eng_mod.Engine(model, cfg, ecfg, device="cpu",
                             router_bias=bias)
        stats = eng.run(trace, max_ticks=400)
        assert stats["completed"] == len(trace)
        assert all(p.grad is None for p in model.parameters())
