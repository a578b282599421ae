"""The port's data pipeline (``repro_torch.data.pipeline``) and
``prng.normal`` against the JAX package on the CPU.

Tokens are bitwise the JAX package's at every step for every family.
``prng.normal`` writes out XLA's single-precision erfinv (and the log1p and
log under it); it agrees with ``jax.random.normal`` within 2 ulp, bitwise
away from the tails: the draws that part sit at |z| > 2.9, in the branch of
the polynomial that takes a square root (measured: 28 of 1.2 M draws)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro_torch import configs, prng
from repro_torch.data import pipeline

torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["smollm-360m", "granite-moe-3b-a800m", "mamba2-130m",
         "recurrentgemma-9b", "paligemma-3b", "musicgen-medium"]
NORMAL_ULP = 2
TAIL = 2.9       # |z| beyond which a draw may part from JAX's (by <= 2 ulp)


def _key(seed):
    return torch.as_tensor(prng.PRNGKey(seed).astype(np.int64))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _check_normal(ref: np.ndarray, got: np.ndarray) -> None:
    assert got.dtype == np.float32 and got.shape == ref.shape
    d = _ulps(ref, got)
    assert d.max() <= NORMAL_ULP
    assert (np.abs(ref[d > 0]) > TAIL).all()


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (1, (4, 8, 32)),
                                        (1234, (3, 64, 48)),
                                        (2 ** 31 - 1, (2, 5))])
def test_normal_matches_jax(seed, shape):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                       jnp.float32))
    _check_normal(ref, prng.normal(_key(seed), shape).numpy())


def test_normal_over_a_batch_of_keys():
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    ref = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (7, 3)))(keys))
    got = prng.normal(torch.as_tensor(np.asarray(keys).astype(np.int64)),
                      (7, 3)).numpy()
    _check_normal(ref, got)


def test_normal_tails_within_two_ulp_over_many_draws():
    """2 M draws reach |z| ~ 5: the sqrt branch of the polynomial."""
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.random.normal(key, (1 << 21,), jnp.float32))
    got = prng.normal(_key(11), (1 << 21,)).numpy()
    assert np.abs(ref).max() > 4.5
    _check_normal(ref, got)


def test_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    got = prng.erfinv_xla(x).numpy()
    ref = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x.numpy())))
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    assert np.array_equal(np.sign(got), np.sign(ref))
    fin = np.isfinite(ref)
    assert _ulps(ref[fin], got[fin]).max() <= NORMAL_ULP


@pytest.mark.parametrize("arch", ARCHS)
def test_sample_batch_matches_jax_at_every_step(arch):
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = configs.get_config(arch).smoke()
    jst, st = jpipe.init_data_state(), pipeline.init_data_state("cpu")
    for _ in range(3):
        jb, jst = jpipe.sample_batch(jcfg, 4, 24, jst)
        b, st = pipeline.sample_batch(cfg, 4, 24, st)
        assert sorted(b) == sorted(jb)
        tok = b["tokens"].numpy()
        assert tok.dtype == np.int32
        np.testing.assert_array_equal(tok, np.asarray(jb["tokens"]))
        for k in ("patches", "frames"):
            if k in jb:
                _check_normal(np.asarray(jb[k]), b[k].numpy())
    assert int(st.step) == int(jst.step) == 3
    assert st.step.dtype == torch.int32


def test_full_vocab_tokens_match_jax():
    """The bigram table at smollm-360m's vocabulary of 49,152."""
    jcfg = jconfigs.get_config("smollm-360m")
    cfg = configs.get_config("smollm-360m")
    jb, _ = jpipe.sample_batch(jcfg, 2, 16,
                               jpipe.DataState(step=jnp.asarray(5, jnp.int32)))
    b, _ = pipeline.sample_batch(cfg, 2, 16, pipeline.DataState(
        step=torch.tensor(5, dtype=torch.int32)))
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))


class TestData:
    """Port copies of ``tests/test_train.py::TestData``."""

    def _cfg(self):
        return configs.get_config("smollm-360m").smoke()

    def test_deterministic_and_stateless(self):
        st = pipeline.init_data_state("cpu")
        b1, st1 = pipeline.sample_batch(self._cfg(), 4, 32, st)
        b2, _ = pipeline.sample_batch(self._cfg(), 4, 32, st)
        assert torch.equal(b1["tokens"], b2["tokens"])
        b3, _ = pipeline.sample_batch(self._cfg(), 4, 32, st1)
        assert not torch.equal(b1["tokens"], b3["tokens"])

    def test_resume_from_step_counter(self):
        st = pipeline.init_data_state("cpu")
        seen = []
        for _ in range(3):
            b, st = pipeline.sample_batch(self._cfg(), 2, 16, st)
            seen.append(b["tokens"])
        resumed = pipeline.DataState(step=torch.tensor(1, dtype=torch.int32))
        b, _ = pipeline.sample_batch(self._cfg(), 2, 16, resumed)
        assert torch.equal(b["tokens"], seen[1])

    def test_tokens_follow_the_bigram_table(self):
        cfg = dataclasses.replace(self._cfg(), vocab_size=64)
        b, _ = pipeline.sample_batch(cfg, 3, 20,
                                     pipeline.init_data_state("cpu"))
        table = pipeline._bigram_table(64, 1234, "cpu")
        tok = b["tokens"].long()
        for t in range(19):
            allowed = table[tok[:, t]]
            assert (allowed == tok[:, t + 1, None]).any(dim=1).all()
