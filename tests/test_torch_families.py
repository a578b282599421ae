"""The port's SSM, hybrid, VLM and audio families against the JAX package's
on the CPU: the smoke configs of ``mamba2-130m``, ``recurrentgemma-9b``
(RG-LRU + sliding-window attention, window 32), ``paligemma-3b`` (8 patches
as a prefix-LM prefix) and ``musicgen-medium`` (frames added to the token
embeddings), fp32, on the JAX package's weights (``params_from_numpy``),
inputs drawn with numpy.

Model level: prefill and decode logits against JAX within 1e-5, on both
kernel backends, with a prompt past the hybrid's window (the ring buffer
wraps in prefill); prefill plus one decode step equal to the prefill of the
whole sequence (the port's copy of tests/test_models.py's decode-consistency
check, on its seven architectures); a decode tick leaves an inactive lane's
slot-row state (recurrent state, ring buffer) untouched. Engine level (the
port alone; the JAX engine comparison is in test_torch_families_engine.py):
mamba's chunked prefill against the one-shot oracle (six chunks, as in
tests/test_serve_engine.py), a request admitted into a retired slot equal to
the same request served alone, and speculative decoding, prefix sharing and
batched prefill streams refused for these families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.models import model, transformer
from repro_torch.serve import api, engine, traces

torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
ARCHS = ("mamba2-130m", "recurrentgemma-9b", "paligemma-3b",
         "musicgen-medium")


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def _pair(arch, **kw):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(), **kw)
    cfg = dataclasses.replace(configs.get_config(arch).smoke(), **kw)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _batch(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _step_batch(cfg, rng, b):
    step = {"token": rng.integers(0, cfg.vocab_size, (b, 1)).astype(
        np.int32)}
    if cfg.family == "audio":
        step["frame"] = rng.standard_normal(
            (b, 1, cfg.frontend_dim)).astype(np.float32)
    return step


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_prefill_and_decode_logits_match_jax(pair, backend):
    """A 40-token prompt (past the hybrid's window of 32) and four decode
    steps; the caches' slot-row leaves against JAX's after them."""
    jcfg, cfg, jp, tp = pair
    b, s, smax = 2, 40, 64
    batch = _batch(cfg, 1, b, s)
    jl, jc = jmodel.prefill(jp, jcfg, _j(batch),
                            jmodel.init_cache(jcfg, b, smax))
    tl, tc = model.prefill(tp, cfg, _t(batch),
                           model.init_cache(cfg, b, smax, "cpu"),
                           attn_backend=backend)
    _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"])
    rng = np.random.default_rng(2)
    for _ in range(4):
        step = _step_batch(cfg, rng, b)
        jl, jc = jmodel.decode_step(jp, jcfg, _j(step), jc)
        tl, tc = model.decode_step(tp, cfg, _t(step), tc,
                                   attn_backend=backend)
        _close(tl, jl)
    for tseg, jseg in zip(tc["layers"], jc["layers"]):
        for tpos, jpos in zip(tseg, jseg):
            for name in tpos:
                _close(tpos[name], jpos[name])


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-4b", "mamba2-130m",
                                  "recurrentgemma-9b", "granite-moe-3b-a800m",
                                  "musicgen-medium", "gemma-7b",
                                  "paligemma-3b"])
def test_prefill_plus_decode_matches_full_sequence(arch):
    """Prefill of S - 1 positions, then a decode step of the last token (and
    frame), gives the last-position logits of prefilling all S."""
    cfg = configs.get_config(arch).smoke()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    tp = model.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    bias = torch.zeros(cfg.num_layers, cfg.num_experts) \
        if cfg.num_experts else None
    b, s = 2, 33
    batch = _t(_batch(cfg, 7, b, s))
    full, _ = model.prefill(tp, cfg, batch, model.init_cache(cfg, b, 64,
                                                             "cpu"),
                            router_bias=bias)
    pre = {k: (v[:, :-1] if k in ("tokens", "frames") else v)
           for k, v in batch.items()}
    _, cache = model.prefill(tp, cfg, pre, model.init_cache(cfg, b, 64, "cpu"),
                             router_bias=bias)
    dec = {"token": batch["tokens"][:, -1:]}
    if cfg.family == "audio":
        dec["frame"] = batch["frames"][:, -1:]
    logits, _ = model.decode_step(tp, cfg, dec, cache, router_bias=bias)
    _close(logits, full.numpy())


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_inactive_lane_slot_row_state_unchanged_by_a_tick(arch):
    """On the engine's paged pool, a decode step with lane 1 inactive leaves
    lane 1's recurrent states and ring buffers as they were, and advances
    lane 0's."""
    cfg = configs.get_config(arch).smoke()
    tp = model.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    pool = model.init_slot_cache_paged(cfg, 2, 32, 9, 8, "cpu")
    gen = torch.Generator().manual_seed(2)
    for seg in pool["layers"]:
        for leaf in seg:
            for t in leaf.values():
                t.normal_(generator=gen)
    pool["pos"][:] = torch.tensor([5, 9], dtype=torch.int32)
    before = [[{k: v.clone() for k, v in leaf.items()} for leaf in seg]
              for seg in pool["layers"]]
    table = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
    model.decode_step(tp, cfg, {"token": torch.tensor([[3], [4]])}, pool,
                      table=table, active=torch.tensor([True, False]))
    kinds = dict(zip(range(len(pool["layers"])), transformer.segments(cfg)))
    checked = 0
    for si, seg in enumerate(pool["layers"]):
        for pi, leaf in enumerate(seg):
            if kinds[si][0][pi] in transformer.PAGED_KINDS:
                continue
            for name, t in leaf.items():
                assert torch.equal(t[:, 1], before[si][pi][name][:, 1]), name
                assert not torch.equal(t[:, 0], before[si][pi][name][:, 0])
                checked += 1
    assert checked >= 2


def test_mamba_chunked_prefill_oracle():
    """Aligned prompts of 16 and 8 at chunk 8 take six chunks in all and
    emit exactly the one-shot ``generate`` tokens (the slot's state row
    threaded across chunks, and across other lanes' ticks)."""
    cfg = configs.get_config("mamba2-130m").smoke()
    tp = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    reqs = [api.ServeRequest(
        rid=rid, tokens=rng.integers(0, cfg.vocab_size, (16, 8)[rid % 2])
        .astype(np.int32),
        params=api.SamplingParams(max_new_tokens=(4, 6)[rid % 2]),
        rclass=rid % 2, arrival=rid) for rid in range(4)]
    eng = engine.Engine(tp, cfg, engine.EngineConfig(
        num_slots=2, max_cache=48, policy="fifo", prefill_chunk=8,
        page_size=8), device="cpu")
    stats = eng.run(reqs, max_ticks=300)
    assert stats["completed"] == 4
    assert stats["chunked_prefill_chunks"] == 6
    assert stats["mid_stream_admissions"] >= 1
    for req in eng.completed:
        out = api.generate(tp, cfg, api.ServeRequest(
            rid=req.rid, tokens=req.tokens, params=req.params), max_cache=48)
        assert out.tokens == req.out_tokens, req.rid


def _engine(cfg, tp, **kw):
    base = dict(num_slots=1, max_cache=96, page_size=8, capture_logits=True)
    return engine.Engine(tp, cfg, engine.EngineConfig(**{**base, **kw}),
                         device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_request_in_a_retired_slot_equals_it_served_alone(arch):
    """One slot: request B enters the slot request A retired from. Its
    stream and logits equal B served alone — retirement wiped the slot's
    recurrent state and ring buffer."""
    cfg = configs.get_config(arch).smoke()
    tp = model.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    trace = traces.synthetic_trace(cfg, num_requests=2, prompt_lens=(40, 16),
                                   heavy_frac=0.0, light_tokens=6, seed=4)
    for req in trace:
        req.arrival = 0
    prefill_chunk = 8 if cfg.family == "ssm" else 0
    eng = _engine(cfg, tp, prefill_chunk=prefill_chunk)
    eng.run(trace, max_ticks=200)
    served = {r.rid: r for r in eng.completed}
    assert len(served) == 2 and served[1].admit_tick > served[0].admit_tick
    late = served[1]
    alone = dataclasses.replace(late, arrival=0, out_tokens=[],
                                out_logits=[], admit_tick=-1, finish_tick=-1,
                                slot=-1, submit_time=-1.0, finish_time=-1.0)
    eng2 = _engine(cfg, tp, prefill_chunk=prefill_chunk)
    eng2.run([alone], max_ticks=200)
    assert alone.out_tokens == late.out_tokens
    for a, b in zip(alone.out_logits, late.out_logits):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_sharing_and_multi_prefill_refused(arch):
    """Speculative decoding, prefix sharing and batched prefill streams need
    an attention-only, frontend-free stack: configured on, they stay off
    (no spec tick, no adopted page, no batched call) and every request is
    served."""
    cfg = configs.get_config(arch).smoke()
    tp = model.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    eng = _engine(cfg, tp, num_slots=2, prefill_chunk=8, prefix_sharing=True,
                  prefill_streams=2, spec_decode=2, spec_draft_layers=1)
    assert not (eng._spec_ok or eng._share_ok or eng._multi_prefill)
    trace = traces.shared_prefix_trace(cfg, num_requests=4, prefix_len=16,
                                       decode_lens=(4, 5))
    stats = eng.run(trace, max_ticks=300)
    assert stats["completed"] == 4
    assert stats["spec_ticks"] == 0
    assert stats["shared_pages_adopted"] == 0
    assert stats["prefill_batch_calls"] == 0
