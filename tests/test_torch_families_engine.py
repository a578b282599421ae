"""The port's serving engine on the SSM, hybrid, VLM and audio families
against the JAX package's engine on the CPU (smoke configs, fp32, the JAX
package's weights through ``params_from_numpy``), and the serving launcher
on each of them.

Both engines serve the same trace (the port's ``serve.traces`` draws the JAX
package's prompts, patches and frames, in the same order): per request the
port's tokens equal the JAX engine's and the port's own one-shot
``api.generate``'s, and the admission and paging counters are equal. The
traces take mamba's aligned prompts through chunked prefill (its prompt of
13 one-shot), a hybrid prompt of 40 past the smoke window of 32 (the ring
buffer wraps in prefill), the VLM's patch prefix into the page reservation,
and audio's frames into one-shot and chunked prefill.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.serve import traces as jtraces
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model
from repro_torch.serve import api, engine, traces

torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

COUNTERS = ("completed", "shed", "rejected", "ticks", "mid_stream_admissions",
            "concurrency_hw", "pages_hw", "chunked_prefill_chunks",
            "shared_pages_adopted", "prefill_tokens", "preemptions",
            "p50_latency", "p99_latency", "goodput")


def _trace(mod, cfg):
    """Six bursty requests, prompts of 8 / 13 and heavy ones of 40,
    two lanes sampled at temperature 0.8."""
    reqs = mod.synthetic_trace(cfg, num_requests=6, seed=3,
                               prompt_lens=(8, 13), heavy_prompt=40,
                               heavy_frac=0.3, light_tokens=4,
                               heavy_tokens=7, burst_size=3, burst_every=4)
    for req in reqs:
        if req.rid in (1, 4):
            req.params = type(req.params)(temperature=0.8,
                                          seed=req.params.seed,
                                          max_new_tokens=5)
    return reqs


@pytest.mark.parametrize("arch,chunk", [("mamba2-130m", 8),
                                        ("recurrentgemma-9b", 8),
                                        ("paligemma-3b", 0),
                                        ("musicgen-medium", 8),
                                        ("musicgen-medium", 0)])
def test_engine_matches_jax_engine_and_oneshot(arch, chunk):
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = configs.get_config(arch).smoke()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    ekw = dict(num_slots=3, max_cache=96, page_size=8, prefill_chunk=chunk,
               num_classes=3)
    jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**ekw))
    jstats = jeng.run(_trace(jtraces, jcfg), max_ticks=400)
    teng = engine.Engine(tp, cfg, engine.EngineConfig(**ekw), device="cpu")
    tstats = teng.run(_trace(traces, cfg), max_ticks=400)
    assert tstats["completed"] == 6
    assert {r.rid: r.out_tokens for r in teng.completed} == \
        {r.rid: r.out_tokens for r in jeng.completed}
    for key in COUNTERS:
        assert tstats[key] == jstats[key], (key, tstats[key], jstats[key])
    if arch == "mamba2-130m":
        assert tstats["chunked_prefill_chunks"] > 0 and tstats["prefills"] > 0
    for req in teng.completed:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params, patches=req.patches,
                                 frames=req.frames)
        out = api.generate(tp, cfg, probe, max_cache=96)
        assert out.tokens == req.out_tokens, req.rid


def test_traces_attach_the_jax_packages_modality_inputs():
    """Every trace draws the JAX package's patches and frames, in the same
    generator order as its prompts."""
    for arch in ("paligemma-3b", "musicgen-medium"):
        jcfg = jconfigs.get_config(arch).smoke()
        cfg = configs.get_config(arch).smoke()
        for name in ("synthetic_trace", "contention_trace",
                     "shared_prefix_trace", "agentic_trace"):
            ours = getattr(traces, name)(cfg, seed=2)
            ref = getattr(jtraces, name)(jcfg, seed=2)
            assert len(ours) == len(ref)
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(a.tokens, b.tokens)
                for field in ("patches", "frames"):
                    x, y = getattr(a, field), getattr(b, field)
                    assert (x is None) == (y is None)
                    if x is not None:
                        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b",
                                  "paligemma-3b", "musicgen-medium"])
def test_launcher_serves_each_family_on_the_cpu(arch, capsys):
    stats = launch_serve.main(["--arch", arch, "--smoke", "--stream",
                               "--device", "cpu", "--requests", "4",
                               "--slots", "2", "--steps", "6",
                               "--show-stream", "1"])
    assert stats["completed"] == 4 and not stats["rejected"]
    assert "4 completed" in capsys.readouterr().out
