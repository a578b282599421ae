"""The port's dense model against the JAX package's on the CPU: the same
smoke-size fp32 weights (the JAX tree converted by ``params_from_numpy``),
the same token inputs drawn with numpy, both attention backends.

Tolerance: logits within 1e-5 (measured ~3e-7: both sides run the same fp32
operations, in a different summation order). The port's pool writes are in
place, so each comparison of pools reads the port's tensors after the call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.models import layers, model

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
BACKENDS = ("kernel", "torch")


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get_config("smollm-360m").smoke()
    cfg = configs.get_config("smollm-360m").smoke()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def _pools_close(tpool, jpool):
    for tseg, jseg in zip(tpool["layers"], jpool["layers"]):
        for tpos, jpos in zip(tseg, jseg):
            for name in ("k", "v"):
                _close(tpos[name], jpos[name])
    np.testing.assert_array_equal(_np(tpool["pos"]), _np(jpool["pos"]))


class TestParams:
    def test_converted_tree_equals_reference(self, pair):
        jcfg, cfg, jp, tp = pair
        assert model.param_count(tp) == jmodel.param_count(jp)
        blk = jp["stack"][0][0]
        np.testing.assert_array_equal(tp.embed.numpy(), np.asarray(jp["embed"]))
        for li, b in enumerate(tp.blocks):
            np.testing.assert_array_equal(b.mixer.wq.numpy(),
                                          np.asarray(blk["mixer"]["wq"][li]))
            np.testing.assert_array_equal(b.mlp.w_down.numpy(),
                                          np.asarray(blk["mlp"]["w_down"][li]))

    def test_init_params_is_seeded_and_shaped(self, pair):
        _, cfg, _, tp = pair
        a = model.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        b = model.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        for (na, pa), (nb, pb), (nt, pt) in zip(a.named_parameters(),
                                                b.named_parameters(),
                                                tp.named_parameters()):
            assert na == nb == nt
            assert torch.equal(pa, pb) and pa.shape == pt.shape
            assert pa.dtype == pt.dtype == torch.float32

    def test_bf16_tree_converts(self, pair):
        jcfg, cfg, _, _ = pair
        jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        jp = jmodel.init_params(jax.random.PRNGKey(2), jcfg)
        tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
        assert tp.embed.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp.embed.float().numpy(),
            np.asarray(jp["embed"].astype(jnp.float32)))

    def test_entry_points_default_to_cuda(self):
        import inspect
        for fn in (model.init_params, model.params_from_numpy):
            assert inspect.signature(fn).parameters["device"].default == "cuda"


class TestConfigs:
    def test_registry_and_input_specs_match(self):
        assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
        for arch in configs.ARCHS:
            ours_cfg, ref_cfg = configs.get_config(arch), \
                jconfigs.get_config(arch)
            assert dataclasses.asdict(ours_cfg) == dataclasses.asdict(ref_cfg)
            for shape in ("train_4k", "decode_32k"):
                ours = configs.input_specs(ours_cfg, configs.get_shape(shape))
                ref = jconfigs.input_specs(ref_cfg, jconfigs.get_shape(shape))
                assert ours.keys() == ref.keys()
                for k in ours:
                    assert tuple(ours[k].shape) == tuple(ref[k].shape)
                    assert ours[k].dtype == str(ref[k].dtype)

    @pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
    def test_full_config_param_count_matches_jax(self, arch):
        """Every architecture at its published size, built on the meta
        device (no allocation): exactly the JAX package's parameter count,
        taken abstractly with ``jax.eval_shape``."""
        abs_params = jax.eval_shape(lambda: jmodel.init_params(
            jax.random.PRNGKey(0), jconfigs.get_config(arch)))
        want = sum(int(x.size) for x in jax.tree.leaves(abs_params))
        ours = model.Model(configs.get_config(arch), None,
                           torch.device("meta"))
        assert model.param_count(ours) == want


class TestLogits:
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("b,s", [(2, 13), (1, 32)])
    def test_prefill(self, pair, backend, b, s):
        jcfg, cfg, jp, tp = pair
        toks = _tokens(s, (b, s), cfg.vocab_size)
        jl, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                jmodel.init_cache(jcfg, b, 48))
        tl, tc = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                               model.init_cache(cfg, b, 48, "cpu"),
                               attn_backend=backend)
        assert tl.shape == (b, 1, cfg.vocab_size) and tl.dtype == torch.float32
        _close(tl, jl)
        _pools_close(tc, jc)

    @pytest.mark.parametrize("per_slot", [False, True])
    def test_decode_step_dense(self, pair, per_slot):
        jcfg, cfg, jp, tp = pair
        toks = _tokens(3, (2, 11), cfg.vocab_size)
        _, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                               jmodel.init_cache(jcfg, 2, 32))
        _, tc = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                              model.init_cache(cfg, 2, 32, "cpu"))
        if per_slot:
            jc["pos"] = jnp.asarray([11, 11], jnp.int32)
            tc["pos"] = torch.tensor([11, 11], dtype=torch.int32)
        for step in range(3):
            nxt = _tokens(100 + step, (2, 1), cfg.vocab_size)
            jl, jc = jmodel.decode_step(jp, jcfg, {"token": jnp.asarray(nxt)},
                                        jc)
            tl, tc = model.decode_step(tp, cfg, {"token": torch.as_tensor(nxt)},
                                       tc)
            _close(tl, jl)
        _pools_close(tc, jc)

    def test_serve_step_matches_jax(self, pair):
        """``serve.decode.serve_step`` (the decode dry-run target) against
        the JAX package's: the torch route on the dense cache, three tokens
        after a prefill, logits within 1e-5 and the caches alike."""
        from repro.serve import decode as jdecode
        from repro_torch.serve import decode
        jcfg, cfg, jp, tp = pair
        toks = _tokens(5, (2, 9), cfg.vocab_size)
        _, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                               jmodel.init_cache(jcfg, 2, 16))
        _, tc = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                              model.init_cache(cfg, 2, 16, "cpu"))
        for step in range(3):
            nxt = _tokens(200 + step, (2, 1), cfg.vocab_size)
            jl, jc = jdecode.serve_step(jp, jcfg, {"token": jnp.asarray(nxt)},
                                        jc)
            tl, tc = decode.serve_step(tp, cfg,
                                       {"token": torch.as_tensor(nxt)}, tc)
            _close(tl, jl)
        _pools_close(tc, jc)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_decode_step_paged(self, pair, backend):
        """Two slots at different depths over scattered pages, one inactive
        lane whose write must land on the null page."""
        jcfg, cfg, jp, tp = pair
        page, maxp, num_pages = 8, 4, 12
        table = np.zeros((3, maxp), np.int32)
        table[0, :3] = [5, 2, 9]
        table[1, :2] = [7, 3]
        jpool = jmodel.init_slot_cache_paged(jcfg, 3, page * maxp, num_pages,
                                             page)
        tpool = model.init_slot_cache_paged(cfg, 3, page * maxp, num_pages,
                                            page, "cpu")
        for slot, plen in ((0, 19), (1, 9)):
            toks = _tokens(slot, (1, plen), cfg.vocab_size)
            _, jone = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                     jmodel.init_cache(jcfg, 1, page * maxp))
            _, tone = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                                    model.init_cache(cfg, 1, page * maxp,
                                                     "cpu"))
            jpool = jmodel.insert_slot_cache_paged(
                jpool, jone, jcfg, slot, jnp.asarray(table[slot]))
            tpool = model.insert_slot_cache_paged(
                tpool, tone, cfg, slot, torch.as_tensor(table[slot]))
        _pools_close(tpool, jpool)
        active = np.asarray([True, True, False])
        for step in range(4):
            nxt = _tokens(50 + step, (3, 1), cfg.vocab_size)
            jl, jpool = jmodel.decode_step(
                jp, jcfg, {"token": jnp.asarray(nxt)}, jpool,
                table=jnp.asarray(table), active=jnp.asarray(active))
            tl, tpool = model.decode_step(
                tp, cfg, {"token": torch.as_tensor(nxt)}, tpool,
                table=torch.as_tensor(table), active=torch.as_tensor(active),
                attn_backend=backend)
            _close(tl[:2], jl[:2])
        # the inactive lane's write went to the null page (trash on both
        # sides); every other page and the positions must agree
        np.testing.assert_array_equal(_np(tpool["pos"]), _np(jpool["pos"]))
        for tseg, jseg in zip(tpool["layers"], jpool["layers"]):
            for tpos, jpos in zip(tseg, jseg):
                for name in ("k", "v"):
                    _close(tpos[name][:, 1:], np.asarray(jpos[name])[:, 1:])

    def test_prefill_chunk_matches_and_lands_in_pages(self, pair):
        jcfg, cfg, jp, tp = pair
        page, maxp, chunk = 8, 4, 8
        toks = _tokens(7, (21,), cfg.vocab_size)
        row = np.asarray([4, 1, 6, 0], np.int32)
        jpool = jmodel.init_slot_cache_paged(jcfg, 2, page * maxp, 8, page)
        tpool = model.init_slot_cache_paged(cfg, 2, page * maxp, 8, page,
                                            "cpu")
        for p0 in range(0, 24, chunk):
            seg = np.zeros((1, chunk), np.int32)
            part = toks[p0:p0 + chunk]
            seg[0, :len(part)] = part
            last = min(max(len(toks) - 1 - p0, 0), chunk - 1)
            jl, jpool = jmodel.prefill_chunk(
                jp, jcfg, {"tokens": jnp.asarray(seg)}, jpool,
                jnp.asarray(row), jnp.asarray(p0), jnp.asarray(last),
                jnp.asarray(0))
            tl, tpool = model.prefill_chunk(
                tp, cfg, {"tokens": torch.as_tensor(seg)}, tpool,
                torch.as_tensor(row), p0, last)
            _close(tl, jl)
        _pools_close(tpool, jpool)
        # the final chunk's logits are the one-shot prefill's
        ol, _ = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks[None])},
                              model.init_cache(cfg, 1, page * maxp, "cpu"))
        _close(tl, ol)

    def test_prefill_chunk_multi_with_padding_lane(self, pair):
        jcfg, cfg, jp, tp = pair
        page, maxp, chunk = 8, 4, 8
        tables = np.asarray([[3, 5, 0, 0], [2, 0, 0, 0], [0, 0, 0, 0]],
                            np.int32)
        toks = _tokens(9, (3, chunk), cfg.vocab_size)
        p0s = np.asarray([8, 0, 0], np.int32)
        last = np.asarray([5, 7, 0], np.int32)
        jpool = jmodel.init_slot_cache_paged(jcfg, 3, page * maxp, 8, page)
        tpool = model.init_slot_cache_paged(cfg, 3, page * maxp, 8, page,
                                            "cpu")
        jl, jpool = jmodel.prefill_chunk_multi(
            jp, jcfg, {"tokens": jnp.asarray(toks)}, jpool,
            jnp.asarray(tables), jnp.asarray(p0s), jnp.asarray(last))
        tl, tpool = model.prefill_chunk_multi(
            tp, cfg, {"tokens": torch.as_tensor(toks)}, tpool,
            torch.as_tensor(tables), torch.as_tensor(p0s),
            torch.as_tensor(last))
        _close(tl[:2], jl[:2])
        for tseg, jseg in zip(tpool["layers"], jpool["layers"]):
            for tpos, jpos in zip(tseg, jseg):
                for name in ("k", "v"):
                    _close(tpos[name][:, 1:], np.asarray(jpos[name])[:, 1:])

    def test_copy_page_paged(self, pair):
        jcfg, cfg, _, _ = pair
        rng = np.random.default_rng(0)
        tpool = model.init_slot_cache_paged(cfg, 2, 32, 6, 8, "cpu")
        for seg in tpool["layers"]:
            for pos in seg:
                for t in pos.values():
                    t.copy_(torch.as_tensor(rng.standard_normal(t.shape),
                                            dtype=t.dtype))
        before = {n: t.clone() for n, t in tpool["layers"][0][0].items()}
        model.copy_page_paged(tpool, cfg, 2, 4)
        for n, t in tpool["layers"][0][0].items():
            assert torch.equal(t[:, 4], before[n][:, 2])
            assert torch.equal(t[:, :4], before[n][:, :4])


class TestAttentionPaths:
    """The torch backend's chunked path (``_sdpa_chunked``) against the JAX
    package's, at sizes that exercise several q and kv chunks."""

    def test_sdpa_chunked_matches_jax(self, pair):
        jcfg, cfg, _, _ = pair
        rng = np.random.default_rng(4)
        q = rng.standard_normal((1, 48, 4, 16)).astype(np.float32)
        k = rng.standard_normal((1, 48, 2, 16)).astype(np.float32)
        v = rng.standard_normal((1, 48, 2, 16)).astype(np.float32)
        ours = layers._sdpa_chunked(*map(torch.as_tensor, (q, k, v)), cfg,
                                    q_chunk=16, kv_chunk=8)
        ref = jlayers._sdpa_chunked(*map(jnp.asarray, (q, k, v)), jcfg, None,
                                    None, q_chunk=16, kv_chunk=8)
        _close(ours, ref)
        full = jlayers._sdpa(*map(jnp.asarray, (q, k, v)),
                             jlayers.causal_mask(48, 48), jcfg)
        _close(ours, full)

    @pytest.mark.parametrize("s,window,plen", [(50, None, None),
                                               (50, 12, None),
                                               (50, None, 20),
                                               (61, 16, 9)])
    def test_sdpa_chunked_window_and_prefix_match_jax(self, pair, s, window,
                                                      plen):
        """Ragged chunks (16 q, 8 kv rows), sliding windows and prefix-LM
        prefixes: the JAX package's full masked ``_sdpa``."""
        jcfg, cfg, _, _ = pair
        rng = np.random.default_rng(s)
        q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
        ours = layers._sdpa_chunked(*map(torch.as_tensor, (q, k, v)), cfg,
                                    window, plen, q_chunk=16, kv_chunk=8)
        ref = jlayers._sdpa(*map(jnp.asarray, (q, k, v)),
                            jlayers.causal_mask(s, s, window, plen), jcfg)
        _close(ours, ref)
        assert torch.equal(layers.causal_mask(s, s, window, plen),
                           torch.as_tensor(np.array(
                               jlayers.causal_mask(s, s, window, plen))))

    def test_unknown_backend_rejected(self, pair):
        with pytest.raises(ValueError, match="backend"):
            layers.check_backend("xla")
