"""The port's threefry PRNG against ``jax.random`` on the CPU: keys, fold_in,
bits and uniforms equal bit for bit; Gumbel noise within one float32 ulp of
the logarithm (the two libraries' ``log`` may round differently); the
categorical draw equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")


def _key(seed):
    return torch.as_tensor(prng.PRNGKey(seed).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 1234, 2 ** 31 - 1, 2 ** 32 - 1])
def test_prngkey_equal(seed):
    assert (np.asarray(jax.random.PRNGKey(seed)) == prng.PRNGKey(seed)).all()


def test_prngkey_rejects_out_of_range():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)


@pytest.mark.parametrize("seed,data", [(0, 0), (42, 1), (42, 99_999),
                                       (2 ** 31 - 1, 2 ** 32 - 1)])
def test_fold_in_equal(seed, data):
    ref = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    assert (ref.astype(np.int64) == prng.fold_in(_key(seed), data).numpy()).all()


def test_batched_fold_in_equal():
    seeds, steps = [3, 5, 8, 13], [0, 1, 2, 40]
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    ref = np.asarray(jax.vmap(jax.random.fold_in)(keys, jnp.asarray(steps)))
    got = prng.fold_in(torch.stack([_key(s) for s in seeds]),
                       torch.as_tensor(steps))
    assert (ref.astype(np.int64) == got.numpy()).all()


@pytest.mark.parametrize("n", [1, 7, 256, 1000])
def test_bits_and_uniform_equal(n):
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 4)
    tk = prng.fold_in(_key(9), 4)
    bits = np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64)
    assert (bits == prng.random_bits(tk, n).numpy()).all()
    assert (np.asarray(jax.random.uniform(jk, (n,)))
            == prng.uniform(tk, n).numpy()).all()


def test_gumbel_within_one_ulp():
    jk = jax.random.fold_in(jax.random.PRNGKey(11), 2)
    ref = np.asarray(jax.random.gumbel(jk, (4096,)))
    got = prng.gumbel(prng.fold_in(_key(11), 2), 4096).numpy()
    np.testing.assert_allclose(got, ref, rtol=2.5e-7, atol=2.5e-7)


def test_categorical_equal():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 256)).astype(np.float32)
    logits[:, ::7] = -np.inf                      # masked entries
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(s), s + 1)
                      for s in range(16)])
    ref = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                      jnp.asarray(logits)))
    got = prng.categorical(torch.as_tensor(np.asarray(keys).astype(np.int64)),
                           torch.as_tensor(logits))
    assert (ref == got.numpy()).all()


@pytest.mark.parametrize("seed,num", [(0, 2), (1, 3), (42, 5),
                                      (2 ** 32 - 1, 2)])
def test_split_equal(seed, num):
    ref = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    assert (ref.astype(np.int64) == prng.split(_key(seed), num).numpy()).all()


def test_split_batched_equal():
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(
        jnp.arange(6))
    ref = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys))
    got = prng.split(torch.as_tensor(np.asarray(keys).astype(np.int64)), 3)
    assert got.shape == (6, 3, 2)
    assert (ref.astype(np.int64) == got.numpy()).all()


@pytest.mark.parametrize("shape", [(), (4,), (175,)])
@pytest.mark.parametrize("lo,hi", [(0, 4), (1, 39), (1, 79)])
@pytest.mark.parametrize("seed", [0, 5])
def test_randint_equal(shape, lo, hi, seed):
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo,
                                        hi, jnp.int32))
    got = prng.randint(_key(seed), shape, lo, hi)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    assert (ref == got.numpy()).all()


def test_randint_batched_scalar_draws_equal():
    """Per-agent scalar draws (the extractor's random walk step)."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(9), i))(
        jnp.arange(64))
    ref = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 4))(keys))
    got = prng.randint(torch.as_tensor(np.asarray(keys).astype(np.int64)), (),
                       0, 4)
    assert got.shape == (64,) and (ref == got.numpy()).all()


def test_randint_empty_span_returns_minval():
    got = prng.randint(_key(0), (8,), 5, 5)
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (8,), 5, 5))
    assert (got.numpy() == 5).all() and (ref == 5).all()
