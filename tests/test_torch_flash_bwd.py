"""Training through flash attention on the CPU: the plain versions of the
backward (``attention_bwd_ref``) and of the autograd Function
(``flash_attention_train``) against ``torch.autograd`` of ``attention_ref``
and of the torch route's ``_sdpa``, in fp32 and bf16; the route predicate of
``layers.attention`` (``flash_trains``); and a training loss through the
Function's plain version against the torch route.

Tolerances, as ||got - want|| / max(||want||, sqrt(numel)) per gradient
(inputs drawn N(0, 1), so a gradient's entries are of order 1 unless it is
zero, as dq and dk are at S = 1, where the floor reads the RMS error):
fp32 1e-5 (measured <= 7e-7: summation order); bf16 1e-2 (measured <=
4.7e-3: the backward rounds P and dS to bf16 as the operands of its
products, ``_sdpa`` rounds S, P and its einsums' outputs)."""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_fwd_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_train)
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.data import pipeline
from repro_torch.train import train_step as ts

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
HEADS = [(4, 4, 64), (8, 2, 128)]          # (H, Hkv, D): MHA, GQA
SEQS = [1, 65, 383, 1000]
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(h, hk, d, s, dtype, seed=0, b=2):
    g = torch.Generator().manual_seed(seed * 7919 + s * 31 + d + h)

    def t(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    return t(b, h, s, d), t(b, hk, s, d), t(b, hk, s, d), t(b, h, s, d)


def _autograd(reference, q, k, v, do):
    """(dq, dk, dv) by torch.autograd of ``attention_ref`` or of ``_sdpa``
    (the torch route's attention, on the (B, S, H, D) layout)."""
    b, h, s, d = q.shape
    if reference == "attention_ref":
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = attention_ref(*leaves)
        return torch.autograd.grad(out, leaves, do)
    leaves = [x.transpose(1, 2).contiguous().requires_grad_()
              for x in (q, k, v)]
    out = layers._sdpa(*leaves, layers.causal_mask(s, s), None)
    grads = torch.autograd.grad(out, leaves,
                                do.transpose(1, 2).reshape(b, s, h * d))
    return [x.transpose(1, 2) for x in grads]


def _close(got, want, dtype):
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == w.dtype == dtype
        err = (a.float() - w.float()).norm() / max(w.float().norm(),
                                                  w.numel() ** 0.5)
        assert err <= TOL[dtype], f"d{name}: {float(err)}"


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("h,hk,d", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reference", ["attention_ref", "sdpa"])
def test_bwd_ref_matches_autograd(reference, dtype, h, hk, d, s):
    q, k, v, do = _inputs(h, hk, d, s, dtype)
    out, lse = attention_fwd_ref(q, k, v)
    assert torch.equal(out, attention_ref(q, k, v))
    assert lse.shape == (2, h, s) and lse.dtype == torch.float32
    _close(attention_bwd_ref(q, k, v, out, do, lse),
           _autograd(reference, q, k, v, do), dtype)


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("h,hk,d", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reference", ["attention_ref", "sdpa"])
def test_function_cpu_path_matches_autograd(reference, dtype, h, hk, d, s):
    """The Function's forward is ``attention_ref``; its backward, reached
    by autograd, gives the gradients of the reference and counts no
    launch on the CPU."""
    q, k, v, do = _inputs(h, hk, d, s, dtype, seed=1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    n0, b0 = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention_train(*leaves)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), attention_ref(q, k, v))
    _close(torch.autograd.grad(out, leaves, do),
           _autograd(reference, q, k, v, do), dtype)
    assert (flash_attention.launches, flash_attention_bwd.launches) == \
        (n0, b0)


def test_lse_is_the_rows_log_sum_exp():
    q, k, v, _ = _inputs(8, 2, 128, 65, torch.float32)
    _, lse = attention_fwd_ref(q, k, v)
    scores = torch.einsum("bhsd,bhtd->bhst", q,
                          k.repeat_interleave(4, dim=1)) / 128 ** 0.5
    scores = scores.masked_fill(~torch.ones(65, 65, dtype=torch.bool).tril(),
                                float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("d", [16, 32, 112, 256])
def test_function_refuses_head_dims_without_a_backward(d):
    q = torch.randn(1, 2, 9, d)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_train(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q, q, q, q, q, torch.zeros(1, 2, 9))


def test_bwd_refuses_mismatched_lse():
    q = torch.randn(1, 2, 9, 64)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, q, q, torch.zeros(1, 2, 8))


# ---------------------------------------------------------------------------
# the route of layers.attention
# ---------------------------------------------------------------------------
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("device,dtype,d,window,prefix,dist,want", [
    ("cuda", BF, 64, None, None, False, True),
    ("cuda", BF, 128, None, None, False, True),
    ("cpu", BF, 64, None, None, False, False),
    ("cpu", F32, 64, None, None, False, False),
    ("cuda", BF, 64, None, None, True, False),      # a mesh's DTensor
    ("cuda", F32, 64, None, None, False, False),
    ("cuda", F32, 128, None, None, False, False),
    ("cuda", BF, 112, None, None, False, False),
    ("cuda", BF, 256, None, None, False, False),
    ("cuda", BF, 16, None, None, False, False),
    ("cuda", BF, 64, 2048, None, False, False),     # sliding window
    ("cuda", BF, 128, None, 256, False, False),     # prefix-LM
    ("meta", BF, 64, None, None, False, False),
])
def test_flash_trains_predicate(device, dtype, d, window, prefix, dist, want):
    assert layers.flash_trains(device, dtype, d, window, prefix, dist) is want


def _model(arch, dtype="float32", remat="none", **over):
    cfg = dataclasses.replace(configs.get_config(arch).smoke(), dtype=dtype,
                              remat=remat, head_dim=64, **over)
    model = model_lib.init_params(cfg, torch.Generator().manual_seed(3),
                                  "cpu").requires_grad_(True)
    batch, _ = pipeline.sample_batch(cfg, 2, 40,
                                      pipeline.init_data_state("cpu"))
    return cfg, model, batch


def test_attention_on_the_cpu_takes_the_torch_route(monkeypatch):
    """A bf16 model at head dim 64 on CPU tensors trains on the torch
    route: the Function is never reached."""
    def boom(*a, **k):
        raise AssertionError("flash_attention_train reached on the CPU")

    monkeypatch.setattr(layers, "flash_attention_train", boom)
    cfg, model, batch = _model("minicpm-2b", dtype="bfloat16")
    loss, _, grads = ts.loss_and_grads(model, cfg, batch)
    assert torch.isfinite(loss) and len(grads) > 0


@pytest.mark.parametrize("arch,remat", [("minicpm-2b", "none"),
                                        ("minicpm-2b", "full"),
                                        ("smollm-360m", "full"),
                                        ("qwen3-4b", "dots")])
def test_training_through_the_function_matches_the_torch_route(
        monkeypatch, arch, remat):
    """The route taken on the CPU (``flash_trains`` forced true; the
    Function's plain versions): loss and every gradient leaf as on the
    torch route in fp32, under each remat, with MHA and GQA heads."""
    cfg, model, batch = _model(arch, remat=remat)
    loss_t, _, grads_t = ts.loss_and_grads(model, cfg, batch)
    calls = []
    real = layers.flash_attention_train

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(layers, "flash_trains", lambda *a: True)
    monkeypatch.setattr(layers, "flash_attention_train", counted)
    loss_f, _, grads_f = ts.loss_and_grads(model, cfg, batch)
    recomputed = 1 if remat == "none" else 2    # remat reruns the forward
    assert len(calls) == recomputed * cfg.num_layers
    assert abs(float(loss_f) - float(loss_t)) <= 1e-5
    for a, b in zip(grads_f, grads_t, strict=True):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * max(b.abs().max().item(), 1e-30))
