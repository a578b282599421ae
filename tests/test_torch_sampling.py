"""Sampling and one-shot decoding of the port against the JAX package's on
the CPU: ``sample_tokens`` (temperature / top-k / top-p / Gumbel draw keyed
by ``fold_in``), the penalties, chosen-token logprobs, and
``decode.generate`` / ``api.generate`` on the converted smoke weights.

Tokens must be equal (greedy and seeded); logits and logprobs within 1e-5
(fp32, summation order differs); penalized logits exactly equal (the same
elementwise IEEE operations on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve import api as japi
from repro.serve import decode as jdecode
from repro_torch import configs
from repro_torch.models import model
from repro_torch.serve import api, decode

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get_config("smollm-360m").smoke()
    cfg = configs.get_config("smollm-360m").smoke()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


LANES = [  # temperature, top_k, top_p, rep, pres, freq, seed
    (0.0, 0, 1.0, 1.0, 0.0, 0.0, 0),
    (0.8, 0, 1.0, 1.0, 0.0, 0.0, 3),
    (1.0, 20, 1.0, 1.0, 0.0, 0.0, 4),
    (0.7, 0, 0.9, 1.0, 0.0, 0.0, 5),
    (1.3, 40, 0.8, 1.2, 0.5, 0.1, 6),
    (0.0, 0, 1.0, 1.5, 0.0, 0.3, 7),
]


def _specs(lanes):
    cols = list(zip(*lanes))
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in cols[6]])
    jspec = jmodel.SamplingSpec(
        keys=jnp.asarray(keys), temperature=jnp.asarray(cols[0], jnp.float32),
        top_k=jnp.asarray(cols[1], jnp.int32),
        top_p=jnp.asarray(cols[2], jnp.float32),
        rep_penalty=jnp.asarray(cols[3], jnp.float32),
        pres_penalty=jnp.asarray(cols[4], jnp.float32),
        freq_penalty=jnp.asarray(cols[5], jnp.float32))
    tspec = model.SamplingSpec(
        keys=torch.as_tensor(keys.astype(np.int64)),
        temperature=torch.tensor(cols[0], dtype=torch.float32),
        top_k=torch.tensor(cols[1], dtype=torch.int64),
        top_p=torch.tensor(cols[2], dtype=torch.float32),
        rep_penalty=torch.tensor(cols[3], dtype=torch.float32),
        pres_penalty=torch.tensor(cols[4], dtype=torch.float32),
        freq_penalty=torch.tensor(cols[5], dtype=torch.float32))
    return jspec, tspec


class TestSampleTokens:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("with_counts", [False, True])
    def test_tokens_equal_jax(self, seed, with_counts):
        rng = np.random.default_rng(seed)
        b, v = len(LANES), 512
        logits = (rng.standard_normal((b, 1, v)) * 3).astype(np.float32)
        logits[0, 0, 7] = logits[0, 0, 9] = logits[0, 0].max() + 1  # a tie
        steps = rng.integers(0, 50, size=b).astype(np.int32)
        counts = rng.integers(0, 3, size=(b, v)).astype(np.int32) \
            if with_counts else None
        jspec, tspec = _specs(LANES)
        ref = jmodel.sample_tokens(
            jnp.asarray(logits), jspec, jnp.asarray(steps),
            counts=None if counts is None else jnp.asarray(counts))
        ours = model.sample_tokens(
            torch.as_tensor(logits), tspec, torch.as_tensor(steps),
            counts=None if counts is None else torch.as_tensor(counts))
        assert ours.dtype == torch.int32 and ours.shape == (b, 1)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))

    def test_penalties_exact(self):
        rng = np.random.default_rng(9)
        lg = rng.standard_normal((len(LANES), 64)).astype(np.float32)
        counts = rng.integers(0, 4, size=lg.shape).astype(np.int32)
        jspec, tspec = _specs(LANES)
        ref = jmodel.penalize_logits(jnp.asarray(lg), jspec,
                                     jnp.asarray(counts))
        ours = model.penalize_logits(torch.as_tensor(lg), tspec,
                                     torch.as_tensor(counts))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        # neutral lanes come back bitwise unchanged
        np.testing.assert_array_equal(ours[:4].numpy(), lg[:4])

    def test_chosen_logprob(self):
        rng = np.random.default_rng(2)
        lg = rng.standard_normal((3, 1, 128)).astype(np.float32)
        tok = np.asarray([[1], [50], [127]], np.int32)
        np.testing.assert_allclose(
            model.chosen_logprob(torch.as_tensor(lg), torch.as_tensor(tok)),
            np.asarray(jmodel.chosen_logprob(jnp.asarray(lg),
                                             jnp.asarray(tok))),
            rtol=TOL, atol=TOL)


class TestGenerate:
    def test_greedy_tokens_and_logits(self, pair):
        jcfg, cfg, jp, tp = pair
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
        jt, _, jl, jlp = jdecode.generate(
            jp, jcfg, {"tokens": jnp.asarray(toks)}, max_cache=32, steps=10,
            return_logits=True, return_logprobs=True)
        tt, _, tl, tlp = decode.generate(
            tp, cfg, {"tokens": torch.as_tensor(toks)}, max_cache=32, steps=10,
            return_logits=True, return_logprobs=True)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=TOL,
                                   atol=TOL)

    @pytest.mark.parametrize("use_penalties", [False, True])
    def test_seeded_tokens_equal(self, pair, use_penalties):
        jcfg, cfg, jp, tp = pair
        lanes = LANES[1:5] if not use_penalties else LANES[2:]
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, size=(len(lanes), 7)).astype(np.int32)
        jspec, tspec = _specs(lanes)
        jt, _, (jv, ji) = jdecode.generate(
            jp, jcfg, {"tokens": jnp.asarray(toks)}, max_cache=32, steps=12,
            sampling=jspec, use_penalties=use_penalties, return_topk=3)
        tt, _, (tv, ti) = decode.generate(
            tp, cfg, {"tokens": torch.as_tensor(toks)}, max_cache=32,
            steps=12, sampling=tspec, use_penalties=use_penalties,
            return_topk=3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL,
                                   atol=TOL)

    @pytest.mark.parametrize("backend", ["kernel", "torch"])
    def test_api_facade_equals_jax(self, pair, backend):
        jcfg, cfg, jp, tp = pair
        rng = np.random.default_rng(3)
        for rid, sp in enumerate([
                dict(max_new_tokens=8),
                dict(temperature=0.9, top_p=0.9, top_k=30, seed=11,
                     max_new_tokens=8, logprobs=2),
                dict(temperature=0.6, seed=2, repetition_penalty=1.3,
                     max_new_tokens=6)]):
            prompt = rng.integers(0, cfg.vocab_size, size=10).astype(np.int32)
            jr = japi.ServeRequest(rid=rid, tokens=prompt,
                                   params=japi.SamplingParams(**sp))
            tr = api.ServeRequest(rid=rid, tokens=prompt,
                                  params=api.SamplingParams(**sp))
            jo = japi.generate(jp, jcfg, jr, max_cache=32, capture_logits=True)
            to = api.generate(tp, cfg, tr, max_cache=32, capture_logits=True,
                              attn_backend=backend)
            assert to.tokens == jo.tokens
            assert to.finish_reason == jo.finish_reason == "length"
            np.testing.assert_allclose(np.stack(tr.out_logits),
                                       np.stack(jr.out_logits), rtol=TOL,
                                       atol=TOL)
            if sp.get("logprobs"):
                np.testing.assert_allclose(to.logprobs, jo.logprobs,
                                           rtol=TOL, atol=TOL)
                assert [i for i, _ in to.top_logprobs] == \
                    [i for i, _ in jo.top_logprobs]

    def test_stop_chosen_by_first_occurrence(self, pair):
        """The smoke model repeats tokens, so a stop id is chosen at its first
        occurrence in the free-running stream; the output is cut there,
        stop token kept, exactly as the JAX facade cuts it."""
        jcfg, cfg, jp, tp = pair
        prompt = np.arange(10, dtype=np.int32)
        free = api.generate(tp, cfg, api.ServeRequest(
            rid=0, tokens=prompt, params=api.SamplingParams(max_new_tokens=12)),
            max_cache=32).tokens
        idx = next(i for i in range(1, len(free)) if free.index(free[i]) == i)
        sp = dict(max_new_tokens=12, stop=(free[idx],))
        to = api.generate(tp, cfg, api.ServeRequest(
            rid=0, tokens=prompt, params=api.SamplingParams(**sp)),
            max_cache=32)
        jo = japi.generate(jp, jcfg, japi.ServeRequest(
            rid=0, tokens=prompt, params=japi.SamplingParams(**sp)),
            max_cache=32)
        assert to.tokens == free[:idx + 1] == jo.tokens
        assert to.finish_reason == jo.finish_reason == "stop"


class TestSamplingParams:
    def test_validation_matches_reference(self):
        for bad in (dict(temperature=-1), dict(top_p=0.0), dict(top_k=-1),
                    dict(max_new_tokens=0), dict(repetition_penalty=0.0),
                    dict(logprobs=-1)):
            with pytest.raises(ValueError):
                api.SamplingParams(**bad)
            with pytest.raises(ValueError):
                japi.SamplingParams(**bad)
        sp = api.SamplingParams(temperature=0.5, stop=[3, 4], seed=9)
        assert sp.stop == (3, 4) and not sp.is_greedy
        np.testing.assert_array_equal(sp.key(),
                                      np.asarray(jax.random.PRNGKey(9)))

    @pytest.mark.parametrize("kw", [dict(n=2), dict(best_of=3)])
    def test_slot_groups_wait_for_slice_2(self, kw):
        """Slot groups arrived with slice 2: ``n=2`` and ``best_of=3`` are
        accepted, size their group as the reference does, and the one-shot
        facade assembles the parent from its lanes."""
        sp = api.SamplingParams(temperature=0.8, seed=2, max_new_tokens=3,
                                **kw)
        ref = japi.SamplingParams(temperature=0.8, seed=2, max_new_tokens=3,
                                  **kw)
        assert sp.group_size == ref.group_size == max(kw.values())
        req = api.ServeRequest(rid=5, tokens=np.arange(6, dtype=np.int32),
                               params=sp)
        params = model.init_params(configs.get_config("smollm-360m").smoke(),
                                   torch.Generator().manual_seed(0), "cpu")
        out = api.generate(params, configs.get_config("smollm-360m").smoke(),
                           req, max_cache=16)
        assert out.rid == 5 and out.finished
        assert len(out.group_outputs) == sp.n
        assert out.tokens == out.group_outputs[0].tokens

    def test_spec_for_rows(self):
        ps = [api.SamplingParams(), api.SamplingParams(temperature=0.7,
                                                       top_k=5, seed=3)]
        spec = api.spec_for(ps, "cpu")
        ref = japi.spec_for([japi.SamplingParams(),
                             japi.SamplingParams(temperature=0.7, top_k=5,
                                                 seed=3)])
        for f in model.SamplingSpec._fields:
            np.testing.assert_array_equal(
                getattr(spec, f).numpy(),
                np.asarray(getattr(ref, f)).astype(getattr(spec, f).numpy()
                                                   .dtype))

    def test_replace_keeps_validation(self):
        sp = api.SamplingParams()
        with pytest.raises(ValueError):
            dataclasses.replace(sp, top_p=2.0)
