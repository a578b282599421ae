"""The port's kernel packages on the CPU: each kernel's plain PyTorch version
against the JAX package's Pallas kernel (interpret mode) and its jnp oracle,
and the wrappers' contract checks and CPU dispatch. The kernels: paged
decode, the paged verify step of self-speculative decoding, flash attention,
the MoE grouped matmul, the blackboard grid step (exact, int32).

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances (as in tests/test_kernels.py): paged 1e-5 fp32, flash 5e-5 fp32,
5e-2 bf16; grouped matmul 2e-4 fp32, 2e-1 bf16. The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.core.vlsi import extractor as jax_extractor
from repro.kernels.grid_step import grid_step as jax_grid_step
from repro.kernels.grid_step import grid_step_ref as jax_grid_step_ref
from repro.kernels.moe_gmm import gmm_ref as jax_gmm_ref
from repro.kernels.moe_gmm import moe_gmm as jax_gmm
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention import paged_attention_ref as jax_paged_ref
from repro.kernels.paged_attention import \
    paged_attention_verify as jax_verify
from repro.kernels.paged_attention import \
    paged_attention_verify_ref as jax_verify_ref
from repro_torch.core.vlsi import extractor, layout
from repro_torch.kernels import flash_attention as flash_pkg
from repro_torch.kernels import grid_step as grid_pkg
from repro_torch.kernels import moe_gmm as gmm_pkg
from repro_torch.kernels import paged_attention as paged_pkg
from repro_torch.kernels._build import MMA_HEAD_DIMS
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.grid_step import (grid_step, grid_step_planes,
                                           grid_step_planes_ref,
                                           grid_step_ref)
from repro_torch.kernels.moe_gmm import gmm_ref, moe_gmm
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref,
                                                 paged_attention_verify,
                                                 paged_attention_verify_ref)

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")


def paged_fixture(seed, b, h, hk, d, page, maxp):
    """Random pools, a valid block table with ragged per-row page counts and
    a +-1e4 null page (never read live)."""
    rng = np.random.default_rng(seed)
    num_pages = b * maxp + 1
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, page, hk, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, hk, d)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    lengths = rng.integers(1, maxp * page + 1, size=b).astype(np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    table = np.zeros((b, maxp), np.int32)
    for i in range(b):
        for j in range(-(-int(lengths[i]) // page)):
            table[i, j] = free.pop()
    return q, kp, vp, table, lengths


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("b,h,hk,d", [
    (3, 4, 4, 32),      # MHA
    (2, 8, 2, 64),      # GQA 4:1
    (2, 15, 5, 64),     # GQA 3:1 (smollm-360m's ratio)
    (2, 8, 1, 128),     # MQA
    (2, 8, 1, 256),     # paligemma-3b's MQA at D = 256
    (2, 16, 2, 112),    # kimi-k2's D = 112, GQA 8:1
])
@pytest.mark.parametrize("page,maxp", [(8, 4), (16, 3)])
def test_paged_plain_matches_jax(b, h, hk, d, page, maxp):
    """fp32, tolerance 1e-5 against both the interpret-mode Pallas kernel and
    the JAX oracle."""
    arrs = paged_fixture(b * 10 + page, b, h, hk, d, page, maxp)
    out = paged_attention_ref(*_t(*arrs)).numpy()
    jarrs = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(out, np.asarray(jax_paged_ref(*jarrs)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jax_paged(*jarrs,
                                                         interpret=True)),
                               rtol=1e-5, atol=1e-5)


def test_paged_plain_bf16_matches_jax():
    """bf16 inputs, fp32 math: tolerance 5e-2."""
    q, kp, vp, table, lengths = paged_fixture(3, 2, 8, 2, 64, 8, 4)
    kp[0], vp[0] = 0.0, 0.0
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, kp, vp))
    out = paged_attention_ref(tq, tk, tv, torch.as_tensor(table),
                              torch.as_tensor(lengths)).float().numpy()
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp))
    ref = jax_paged_ref(jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths))
    np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


def test_paged_ignores_dirty_null_page():
    """Unmapped table entries point at page 0; its contents never leak."""
    q, kp, vp, table, lengths = paged_fixture(5, 2, 4, 2, 32, 8, 3)
    dirty = paged_attention(*_t(q, kp, vp, table, lengths))
    kp[0], vp[0] = 0.0, 0.0
    clean = paged_attention(*_t(q, kp, vp, table, lengths))
    assert torch.equal(dirty, clean)


def verify_fixture(seed, b, sq, h, hk, d, page, maxp):
    """Verify-step inputs: ragged first positions (one lane at a page
    boundary, one whose last rows run past the table's capacity), every page
    a row can reach mapped, the rest on a +-1e4 null page."""
    rng = np.random.default_rng(seed)
    num_pages = b * maxp + 1
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, page, hk, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, hk, d)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    pos = rng.integers(0, maxp * page - sq + 1, size=b).astype(np.int32)
    pos[0] = page                               # first row opens a page
    pos[-1] = maxp * page - max(sq - 2, 1)      # rows past the capacity
    free = list(rng.permutation(np.arange(1, num_pages)))
    table = np.zeros((b, maxp), np.int32)
    for i in range(b):
        for j in range(min(maxp, -(-(int(pos[i]) + sq) // page))):
            table[i, j] = free.pop()
    return q, kp, vp, table, pos


@pytest.mark.parametrize("b,h,hk,d", [
    (3, 4, 4, 32),      # MHA
    (2, 15, 5, 64),     # GQA 3:1 (smollm-360m's ratio)
    (2, 8, 1, 128),     # MQA
    (2, 8, 1, 256),     # paligemma-3b's MQA at D = 256
    (2, 16, 2, 112),    # kimi-k2's D = 112
])
@pytest.mark.parametrize("sq", [1, 3, 5])
def test_verify_plain_matches_jax(b, h, hk, d, sq):
    """fp32, tolerance 1e-5 against the interpret-mode Pallas verify kernel
    and the JAX oracle; the wrapper on CPU tensors is the plain version."""
    arrs = verify_fixture(b * 7 + sq, b, sq, h, hk, d, 8, 4)
    out = paged_attention_verify_ref(*_t(*arrs))
    assert torch.equal(paged_attention_verify(*_t(*arrs)), out)
    jarrs = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_verify_ref(*jarrs)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_verify(*jarrs, interpret=True)),
                               rtol=1e-5, atol=1e-5)


def test_verify_plain_bf16_matches_jax():
    """bf16 inputs, fp32 math: tolerance 5e-2."""
    q, kp, vp, table, pos = verify_fixture(11, 2, 5, 15, 5, 64, 8, 4)
    kp[0], vp[0] = 0.0, 0.0
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, kp, vp))
    out = paged_attention_verify_ref(tq, tk, tv, torch.as_tensor(table),
                                     torch.as_tensor(pos)).float().numpy()
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp))
    ref = jax_verify_ref(jq, jk, jv, jnp.asarray(table), jnp.asarray(pos))
    np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("sq", [1, 5])
def test_verify_rows_are_decode_rows(sq):
    """Row ``r`` of the verify step is the decode step at lengths
    ``pos + r + 1`` (Sq = 1: the decode step itself)."""
    q, kp, vp, table, pos = _t(*verify_fixture(3, 3, sq, 15, 5, 64, 8, 4))
    out = paged_attention_verify_ref(q, kp, vp, table, pos)
    for r in range(sq):
        dec = paged_attention_ref(q[:, r].contiguous(), kp, vp, table,
                                  pos + r + 1)
        np.testing.assert_allclose(out[:, r].numpy(), dec.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_verify_ignores_dirty_null_page():
    q, kp, vp, table, pos = verify_fixture(5, 2, 3, 4, 2, 32, 8, 3)
    dirty = paged_attention_verify(*_t(q, kp, vp, table, pos))
    kp[0], vp[0] = 0.0, 0.0
    assert torch.equal(dirty, paged_attention_verify(*_t(q, kp, vp, table,
                                                         pos)))


LOG2E = 1.4426950408889634


def split_merge_model(q, kp, vp, table, first, nsplit, pps):
    """Plain model of the CUDA kernels' split-K over pages: the dense
    reference's positions cut at split boundaries (``pps`` pages each,
    capped at the table), each split's running max m (log2 domain), sum l
    and unnormalised accumulator formed over the positions a row attends,
    then merged per row in split order, 8 splits at a time (16 where there
    are more than 8) into a running state, skipping the splits that hold no
    live position of that row, as the merge kernel does. q: (B, Sq, H, D)
    fp32; first: (B,) int32 first query positions -> (B, Sq, H, D)."""
    chunk = 16 if nsplit > 8 else 8
    b, sq, h, d = q.shape
    _, page, hk, _ = kp.shape
    maxp = table.shape[1]
    cap, width = maxp * page, pps * page
    idx = table.long()
    k = kp[idx].reshape(b, cap, hk, d)
    v = vp[idx].reshape(b, cap, hk, d)
    qf = q.reshape(b, sq, hk, h // hk, d) * (LOG2E / d ** 0.5)
    s = torch.einsum("bqkgd,btkd->bkqgt", qf, k)
    lim = (first.long()[:, None] + torch.arange(sq)).clamp(max=cap - 1)
    live = torch.arange(cap) <= lim[:, None, :, None, None]
    parts = []
    for i in range(nsplit):
        cut = slice(i * width, min((i + 1) * width, cap))
        sv = torch.where(live[..., cut], s[..., cut], torch.tensor(-1e30))
        m = sv.amax(-1)
        p = torch.where(live[..., cut], torch.exp2(sv - m[..., None]),
                        torch.tensor(0.0))
        parts.append((m, p.sum(-1),
                      torch.einsum("bkqgt,btkd->bkqgd", p, v[:, cut]),
                      live[..., cut].any(-1)))
    mx = torch.full_like(parts[0][0], -1e30)
    den, num = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
    for c0 in range(0, nsplit, chunk):
        group = parts[c0:c0 + chunk]
        mn = mx
        for m, _, _, has in group:
            mn = torch.where(has, torch.maximum(mn, m), mn)
        corr = torch.exp2(mx - mn)
        den, num, mx = den * corr, num * corr[..., None], mn
        for m, l, acc, has in group:
            a = torch.where(has, torch.exp2(m - mx), torch.tensor(0.0))
            den = den + a * l
            num = num + a[..., None] * acc
    out = num / den.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(b, sq, h, d)


def _splits(kind, b, hk, maxp, page):
    """(nsplit, pages_per_split): the wrapper's rule, one page a split, or
    three pages a split (not a whole tile)."""
    if kind == "rule":
        return paged_pkg.split_rule(b, hk, maxp, page)
    pps = 1 if kind == "page" else 3
    return -(-maxp // pps), pps


def _table_for(rng, b, maxp, page, reach):
    """A block table mapping the pages of positions < reach[i], null past."""
    free = list(rng.permutation(np.arange(1, b * maxp + 1)))
    table = np.zeros((b, maxp), np.int32)
    for i in range(b):
        for j in range(min(maxp, -(-int(reach[i]) // page))):
            table[i, j] = free.pop()
    return table


@pytest.mark.parametrize("grp", [1, 3])
@pytest.mark.parametrize("kind", ["rule", "page", "ragged"])
def test_split_merge_model_is_the_decode_reference(grp, kind):
    """Decode at lengths on every edge of the split (1, page - 1, page, page
    + 1, width - 1, width, width + 1, the capacity): the split-then-merge
    model equals the plain version and the interpret-mode Pallas kernel at
    1e-5 in fp32."""
    b, hk, d, page, maxp = 8, 2, 32, 8, 24
    nsplit, pps = _splits(kind, b, hk, maxp, page)
    width, cap = pps * page, maxp * page
    assert nsplit > 1
    lengths = np.array([1, page - 1, page, page + 1, width - 1, width,
                        width + 1, cap], np.int32)
    rng = np.random.default_rng(grp * 10 + pps)
    q = rng.standard_normal((b, hk * grp, d)).astype(np.float32)
    kp = rng.standard_normal((b * maxp + 1, page, hk, d)).astype(np.float32)
    vp = rng.standard_normal((b * maxp + 1, page, hk, d)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    table = _table_for(rng, b, maxp, page, lengths)
    arrs = (q, kp, vp, table, lengths)
    tq, tk, tv, tt, tl = _t(*arrs)
    out = split_merge_model(tq[:, None], tk, tv, tt, tl - 1, nsplit,
                            pps)[:, 0].numpy()
    np.testing.assert_allclose(out, paged_attention_ref(*_t(*arrs)).numpy(),
                               rtol=1e-5, atol=1e-5)
    jarrs = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(out, np.asarray(jax_paged(*jarrs,
                                                         interpret=True)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq", [1, 2, 5, 7])
@pytest.mark.parametrize("kind", ["rule", "page", "ragged"])
def test_split_merge_model_is_the_verify_reference(sq, kind):
    """Verify with rows straddling page and split edges, one lane ending on
    the capacity and one running past it: the split-then-merge model equals
    the plain version and the interpret-mode Pallas kernel at 1e-5 in
    fp32."""
    b, hk, grp, d, page, maxp = 8, 2, 3, 32, 8, 24
    nsplit, pps = _splits(kind, b, hk, maxp, page)
    width, cap = pps * page, maxp * page
    pos = np.clip([0, page - 1, page, width - sq // 2 - 1, width - 1, width,
                   cap - sq, cap - max(sq - 2, 1)], 0, cap - 1)
    pos = pos.astype(np.int32)
    rng = np.random.default_rng(sq * 10 + pps)
    q = rng.standard_normal((b, sq, hk * grp, d)).astype(np.float32)
    kp = rng.standard_normal((b * maxp + 1, page, hk, d)).astype(np.float32)
    vp = rng.standard_normal((b * maxp + 1, page, hk, d)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    table = _table_for(rng, b, maxp, page, pos + sq)
    arrs = (q, kp, vp, table, pos)
    tq, tk, tv, tt, tp = _t(*arrs)
    out = split_merge_model(tq, tk, tv, tt, tp, nsplit, pps).numpy()
    np.testing.assert_allclose(
        out, paged_attention_verify_ref(*_t(*arrs)).numpy(), rtol=1e-5,
        atol=1e-5)
    jarrs = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(out,
                               np.asarray(jax_verify(*jarrs, interpret=True)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,hk,s,d", [
    (2, 4, 2, 256, 64),     # GQA, whole 128-blocks
    (1, 15, 5, 128, 64),    # smollm-360m width
    (1, 8, 1, 384, 128),    # MQA, 3 x 128 blocks
    (1, 8, 1, 256, 256),    # paligemma-3b's heads at D = 256
    (1, 8, 2, 128, 112),    # D = 112 (kimi-k2)
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_kernel(b, h, hk, s, d, causal):
    """fp32 against the interpret-mode Pallas kernel (whose S must be a
    multiple of its block): tolerance 5e-5."""
    rng = np.random.default_rng(s + h)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    out = attention_ref(*_t(q, k, v), causal=causal).numpy()
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, bq=64, bkv=128, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("s", [1, 17, 100, 383])
@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_matches_jax_ref(s, dtype, tol, causal):
    """Engine prompts have any length: ragged S against the JAX oracle."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((1, 15, s, 64)).astype(np.float32)
    k = rng.standard_normal((1, 5, s, 64)).astype(np.float32)
    v = rng.standard_normal((1, 5, s, 64)).astype(np.float32)
    tdt = getattr(torch, dtype)
    out = attention_ref(*(torch.as_tensor(a).to(tdt) for a in (q, k, v)),
                        causal=causal).float().numpy()
    jdt = getattr(jnp, dtype)
    ref = jax_attention_ref(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                            causal=causal)
    np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def gmm_fixture(seed, e, c, d, f, masked=True):
    """Inputs, weights and seeded group sizes that include 0 and C; with
    ``masked`` the rows past each group are zeroed (the TPU kernel's
    caller contract), otherwise they hold live-looking values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    sizes = rng.integers(0, c + 1, size=e).astype(np.int32)
    sizes[0], sizes[-1] = 0, c
    if masked:
        x = np.where(np.arange(c)[None, :, None] < sizes[:, None, None], x,
                     0.0).astype(np.float32)
    return x, w, sizes


@pytest.mark.parametrize("e,c,d,f", [(8, 64, 32, 64), (4, 128, 128, 256),
                                     (6, 32, 64, 32), (3, 96, 96, 96)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 2e-1)])
def test_gmm_plain_matches_jax(e, c, d, f, dtype, tol):
    """The shapes of tests/test_kernels.py: the plain version against the
    interpret-mode Pallas kernel and the JAX oracle."""
    x, w, sizes = gmm_fixture(e * c + f, e, c, d, f)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = gmm_ref(torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt),
                  torch.as_tensor(sizes))
    assert out.dtype == tdt
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    for ref in (jax_gmm(jx, jw, jnp.asarray(sizes), bc=32, bf=32, bd=32,
                        interpret=True),
                jax_gmm_ref(jx, jw, jnp.asarray(sizes))):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
    assert not out[0].any(), "an empty group is not exactly zero"


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 2e-1)])
def test_gmm_ragged_dead_rows_are_zero_whatever_they_hold(dtype, tol):
    """C, D, F multiples of no tile, and nonzero input past every group:
    the output there is exactly 0 (the JAX oracle's contract; the TPU kernel
    asserts divisibility and zeroes only whole blocks)."""
    x, w, sizes = gmm_fixture(11, 5, 37, 45, 23, masked=False)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = moe_gmm(torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt),
                  torch.as_tensor(sizes))
    ref = jax_gmm_ref(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                      jnp.asarray(sizes))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    dead = np.arange(37)[None, :] >= sizes[:, None]
    assert dead.any() and np.abs(x[dead]).max() > 0
    assert (out.float().numpy()[dead] == 0.0).all()
    assert (out.float().numpy()[~dead] != 0.0).all()


class TestWrappers:
    """CPU tensors take the plain version (no launch counted); the kernel
    contract is checked on every call."""

    def test_cpu_dispatch_counts_no_launch(self):
        q, kp, vp, table, lengths = _t(*paged_fixture(0, 2, 4, 2, 32, 8, 3))
        n0 = paged_attention.launches
        assert torch.equal(paged_attention(q, kp, vp, table, lengths),
                           paged_attention_ref(q, kp, vp, table, lengths))
        assert paged_attention.launches == n0
        x = torch.randn(1, 4, 9, 32)
        y = torch.randn(1, 2, 9, 32)
        f0 = flash_attention.launches
        assert torch.equal(flash_attention(x, y, y), attention_ref(x, y, y))
        assert flash_attention.launches == f0

    @pytest.mark.parametrize("dtype,aligned,want", [
        (torch.bfloat16, True, "mma"), (torch.bfloat16, False, "cuda_core"),
        (torch.float32, True, "cuda_core"),
        (torch.float32, False, "cuda_core")])
    def test_flash_path_is_a_function_of_dtype(self, dtype, aligned, want):
        assert flash_pkg.kernel_path(dtype, 64, aligned) == want
        assert want in flash_pkg.ops.PATHS

    @pytest.mark.parametrize("dtype,aligned,want", [
        (torch.bfloat16, True, "mma"), (torch.bfloat16, False, "cuda_core"),
        (torch.float32, True, "cuda_core"),
        (torch.float32, False, "cuda_core")])
    def test_paged_path_is_a_function_of_dtype(self, dtype, aligned, want):
        """Decode and verify, any rows: one rule for both entries."""
        assert paged_pkg.kernel_path(dtype, 64, aligned) == want
        assert want in paged_pkg.ops.PATHS

    @pytest.mark.parametrize("d", [16, 32, 64, 112, 128, 256])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_paths_by_head_dim(self, d, dtype):
        """Every head dim the configs use is taken; bf16 runs on the tensor
        cores at ``MMA_HEAD_DIMS`` and on CUDA cores at the others, fp32 on
        CUDA cores at all of them — one rule for the paged entries and
        flash."""
        assert d in paged_pkg.ops.HEAD_DIMS and d in flash_pkg.ops.HEAD_DIMS
        want = "mma" if dtype == torch.bfloat16 and d in MMA_HEAD_DIMS \
            else "cuda_core"
        for pkg in (paged_pkg, flash_pkg):
            assert pkg.kernel_path(dtype, d) == want
            assert pkg.kernel_path(dtype, d, aligned=False) == "cuda_core"

    @pytest.mark.parametrize("b,hk,maxp,page,want", [
        (8, 5, 96, 16, (12, 8)),     # smollm decode: 480 CTAs
        (8, 5, 32, 16, (8, 4)),      # smollm verify at max_cache 512
        (8, 8, 96, 16, (8, 12)),     # granite decode
        (8, 5, 6, 16, (2, 4)),
        (3, 4, 6, 8, (1, 8)),        # one split: the output written directly
        (1, 1, 4096, 16, (512, 8)),
        (64, 8, 4096, 16, (8, 512)),  # capped at MAX_SPLIT_PAGES
        (8, 5, 20, 12, (4, 5))])     # a page that does not divide a tile
    def test_paged_split_is_a_function_of_shapes(self, b, hk, maxp, page,
                                                 want):
        """Every page of the table in exactly one split, each split a whole
        number of tiles (or the cap), and no more than about TARGET_CTAS
        CTAs unless a split is already one tile or the cap."""
        nsplit, pps = paged_pkg.split_rule(b, hk, maxp, page)
        assert (nsplit, pps) == want
        assert (nsplit - 1) * pps < maxp <= nsplit * pps
        tile_pages = max(1, paged_pkg.ops.TILE_TOKENS // page)
        assert pps % tile_pages == 0 or pps == paged_pkg.ops.MAX_SPLIT_PAGES
        assert b * hk * nsplit <= 2 * paged_pkg.ops.TARGET_CTAS or \
            pps in (tile_pages, paged_pkg.ops.MAX_SPLIT_PAGES)

    @pytest.mark.parametrize("dtype,d,f,aligned,want", [
        (torch.bfloat16, 1536, 512, True, "mma"),      # decode gate / up
        (torch.bfloat16, 512, 1536, True, "mma"),      # decode down
        (torch.bfloat16, 96, 80, True, "mma"),
        (torch.bfloat16, 45, 23, True, "cuda_core"),   # 16-byte rows fail
        (torch.bfloat16, 96, 20, True, "cuda_core"),
        (torch.bfloat16, 36, 80, True, "cuda_core"),
        (torch.bfloat16, 1536, 512, False, "cuda_core"),
        (torch.float32, 1536, 512, True, "cuda_core")])
    def test_gmm_path_is_a_function_of_dtype_and_shape(self, dtype, d, f,
                                                       aligned, want):
        assert gmm_pkg.kernel_path(dtype, d, f, aligned) == want
        assert want in gmm_pkg.ops.PATHS

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_cpu_path_runs_plain_and_counts_no_body(self, dtype):
        """On CPU tensors both wrappers return their plain version's result
        and count neither a launch nor a launch by body, whatever the
        dtype."""
        rng = np.random.default_rng(3)
        q = torch.as_tensor(rng.standard_normal((1, 6, 65, 16)),
                            dtype=torch.float32).to(dtype)
        kv = torch.as_tensor(rng.standard_normal((1, 2, 65, 16)),
                             dtype=torch.float32).to(dtype)
        f0, fp0 = flash_attention.launches, dict(
            flash_attention.launches_by_path)
        assert torch.equal(flash_attention(q, kv, kv),
                           attention_ref(q, kv, kv))
        assert flash_attention.launches == f0
        assert flash_attention.launches_by_path == fp0
        x, w, sizes = (torch.as_tensor(a) for a in
                       gmm_fixture(3, 3, 20, 16, 8, masked=False))
        x, w = x.to(dtype), w.to(dtype)
        g0, gp0 = moe_gmm.launches, dict(moe_gmm.launches_by_path)
        assert torch.equal(moe_gmm(x, w, sizes), gmm_ref(x, w, sizes))
        assert moe_gmm.launches == g0
        assert moe_gmm.launches_by_path == gp0

    def test_paged_rejects_what_the_kernel_cannot_take(self):
        q, kp, vp, table, lengths = _t(*paged_fixture(0, 2, 4, 2, 32, 8, 3))
        with pytest.raises(TypeError):
            paged_attention(q.half(), kp.half(), vp.half(), table, lengths)
        with pytest.raises(ValueError, match="int32"):
            paged_attention(q, kp, vp, table.long(), lengths)
        with pytest.raises(ValueError, match="head dim"):
            paged_attention(q[..., :24].contiguous(), kp[..., :24].contiguous(),
                            vp[..., :24].contiguous(), table, lengths)
        with pytest.raises(ValueError, match="contiguous"):
            paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                            kp, vp, table, lengths)
        with pytest.raises(ValueError, match="device"):
            paged_attention(q.to("meta"), kp, vp, table, lengths)

    def test_verify_counts_no_launch_and_checks_contract(self):
        q, kp, vp, table, pos = _t(*verify_fixture(0, 2, 3, 4, 2, 32, 8, 3))
        n0 = paged_attention_verify.launches
        paged_attention_verify(q, kp, vp, table, pos)
        assert paged_attention_verify.launches == n0
        with pytest.raises(ValueError, match="bad shapes"):
            paged_attention_verify(q[:, 0], kp, vp, table, pos)
        with pytest.raises(ValueError, match="int32"):
            paged_attention_verify(q, kp, vp, table, pos.long())
        with pytest.raises(TypeError):
            paged_attention_verify(q.half(), kp.half(), vp.half(), table, pos)
        with pytest.raises(ValueError, match="contiguous"):
            paged_attention_verify(q.transpose(1, 2).contiguous()
                                   .transpose(1, 2), kp, vp, table, pos)
        # any number of rows a kv head: the kernels take them in row blocks
        big = torch.zeros(2, 64, 32, 128)
        pages = torch.zeros(3, 64, 8, 128)
        assert paged_attention_verify(big, pages, pages, table % 3,
                                      pos).shape == big.shape

    def test_flash_rejects_what_the_kernel_cannot_take(self):
        x = torch.randn(1, 4, 9, 32)
        y = torch.randn(1, 2, 9, 32)
        with pytest.raises(TypeError):
            flash_attention(x.half(), y.half(), y.half())
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(torch.randn(1, 4, 9, 24), torch.randn(1, 2, 9, 24),
                            torch.randn(1, 2, 9, 24))
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention(x.transpose(2, 3).contiguous().transpose(2, 3),
                            y, y)
        with pytest.raises(ValueError, match="device"):
            flash_attention(x.to("meta"), y, y)

    def test_grid_step_counts_no_launch_and_checks_contract(self):
        lab, cond = (torch.as_tensor(a) for a in grid_fixture(0, 6, 5))
        n0 = grid_step.launches
        assert torch.equal(grid_step(lab, cond, band=3),
                           grid_step_ref(lab, cond))
        assert grid_step.launches == n0
        with pytest.raises(TypeError, match="int32"):
            grid_step(lab.long(), cond)
        with pytest.raises(TypeError, match="int32"):
            grid_step(lab, cond.bool())
        with pytest.raises(ValueError, match="bad shapes"):
            grid_step(lab[None], cond[None])
        with pytest.raises(ValueError, match="bad shapes"):
            grid_step(lab, cond[:, :4].contiguous())
        with pytest.raises(ValueError, match="contiguous"):
            grid_step(lab.t(), cond.t())
        with pytest.raises(ValueError, match="device"):
            grid_step(lab.to("meta"), cond)

    def test_grid_step_planes_counts_no_launch_and_checks_contract(self):
        lab, cond = (torch.as_tensor(a) for a in grid_stack(0, 3, 6, 5))
        n0, by0 = grid_step.launches, dict(grid_step.launches_by_path)
        assert torch.equal(grid_step_planes(lab, cond),
                           grid_step_planes_ref(lab, cond))
        assert grid_step.launches == n0
        assert grid_step.launches_by_path == by0
        with pytest.raises(TypeError, match="int32"):
            grid_step_planes(lab.long(), cond)
        with pytest.raises(TypeError, match="int32"):
            grid_step_planes(lab, cond.bool())
        with pytest.raises(ValueError, match="bad shapes"):
            grid_step_planes(lab[0], cond[0])
        with pytest.raises(ValueError, match="bad shapes"):
            grid_step_planes(lab[None], cond[None])
        with pytest.raises(ValueError, match="bad shapes"):
            grid_step_planes(lab, cond[:2].contiguous())
        with pytest.raises(ValueError, match="bad shapes"):
            grid_step_planes(lab, cond[:, :, :4].contiguous())
        with pytest.raises(ValueError, match="contiguous"):
            grid_step_planes(lab.transpose(1, 2), cond.transpose(1, 2))
        with pytest.raises(ValueError, match="contiguous"):
            grid_step_planes(lab[:, ::2], cond[:, ::2])
        with pytest.raises(ValueError, match="device"):
            grid_step_planes(lab.to("meta"), cond)
        with pytest.raises(ValueError, match="device"):
            grid_step_planes(lab.to("meta"), cond.to("meta"))

    def test_gmm_counts_no_launch_and_checks_contract(self):
        x, w, sizes = (torch.as_tensor(a)
                       for a in gmm_fixture(0, 3, 10, 8, 6, masked=False))
        n0 = moe_gmm.launches
        assert torch.equal(moe_gmm(x, w, sizes), gmm_ref(x, w, sizes))
        assert moe_gmm.launches == n0
        with pytest.raises(TypeError):
            moe_gmm(x.half(), w.half(), sizes)
        with pytest.raises(TypeError):
            moe_gmm(x, w.to(torch.bfloat16), sizes)
        with pytest.raises(TypeError, match="int32"):
            moe_gmm(x, w, sizes.long())
        with pytest.raises(ValueError, match="bad shapes"):
            moe_gmm(x, w[:, :5].contiguous(), sizes)
        with pytest.raises(ValueError, match="bad shapes"):
            moe_gmm(x, w, sizes[:2])
        with pytest.raises(ValueError, match="contiguous"):
            moe_gmm(x.transpose(1, 2).contiguous().transpose(1, 2), w, sizes)
        with pytest.raises(ValueError, match="device"):
            moe_gmm(x.to("meta"), w, sizes)


def grid_fixture(seed, h, w, p_cond=0.6, lo=0, hi=50):
    """Labels in [lo, hi) and a conductor mask; labels zeroed off the mask
    when ``lo`` is 0 (as the extractor's planes are)."""
    rng = np.random.default_rng(seed)
    cond = (rng.random((h, w)) < p_cond).astype(np.int32)
    lab = rng.integers(lo, hi, (h, w)).astype(np.int32)
    if lo == 0:
        lab = lab * cond
    return lab, cond


def grid_stack(seed, planes, h, w, **kw):
    """``planes`` different ``grid_fixture`` planes, stacked."""
    pairs = [grid_fixture(seed * 101 + p, h, w, **kw) for p in range(planes)]
    return (np.stack([lab for lab, _ in pairs]),
            np.stack([cond for _, cond in pairs]))


@pytest.mark.parametrize("planes", [1, 4])
@pytest.mark.parametrize("h,w", [(1, 7), (7, 1), (33, 16), (40, 32),
                                 (80, 128)])
def test_grid_step_planes_matches_jax_per_plane(planes, h, w):
    """A stack of different planes stepped at once equals the Pallas kernel
    (interpret mode) on each plane alone: nothing crosses a plane edge."""
    lab, cond = grid_stack(h * w + planes, planes, h, w, hi=99)
    assert planes == 1 or not np.array_equal(lab[0], lab[1])
    out = grid_step_planes(torch.as_tensor(lab), torch.as_tensor(cond))
    assert out.dtype == torch.int32 and out.shape == (planes, h, w)
    for p in range(planes):
        ref = np.asarray(jax_grid_step(jnp.asarray(lab[p]),
                                       jnp.asarray(cond[p]), interpret=True))
        assert np.array_equal(out[p].numpy(), ref), p


@pytest.mark.parametrize("planes,h,w", [(4, 1, 7), (4, 7, 1), (3, 7, 5),
                                        (4, 33, 16), (2, 40, 30)])
def test_grid_step_planes_ref_any_int32_matches_jax_ref(planes, h, w):
    """Negative labels and cond values outside {0, 1}, plane by plane."""
    rng = np.random.default_rng(planes * 1000 + h * w)
    lab = rng.integers(-50, 100, (planes, h, w)).astype(np.int32)
    cond = rng.integers(-3, 4, (planes, h, w)).astype(np.int32)
    out = grid_step_planes_ref(torch.as_tensor(lab), torch.as_tensor(cond))
    for p in range(planes):
        ref = jax_grid_step_ref(jnp.asarray(lab[p]), jnp.asarray(cond[p]))
        assert np.array_equal(out[p].numpy(), np.asarray(ref)), p


@pytest.mark.parametrize("w,offset,path", [(128, 0, "vec4"), (32, 0, "vec4"),
                                           (4, 0, "vec4"), (30, 0, "scalar"),
                                           (7, 0, "scalar"), (1, 0, "scalar"),
                                           (128, 1, "scalar"),
                                           (32, 2, "scalar"),
                                           (32, 4, "vec4")])
def test_grid_step_kernel_path(w, offset, path):
    """The 16-byte body needs W a multiple of 4 and 16-byte-aligned inputs;
    a stack viewed ``offset`` words into a buffer is aligned only when
    ``offset`` is a multiple of 4."""
    buf = torch.zeros(4 * 3 * w + offset, dtype=torch.int32)
    view = buf[offset:].view(4, 3, w)
    assert view.is_contiguous()
    aligned = view.data_ptr() % 16 == 0
    assert aligned == (offset % 4 == 0)
    assert grid_pkg.kernel_path(w, aligned=aligned) == path


@pytest.mark.parametrize("h,w,band", [(16, 32, 8), (40, 32, 8), (33, 16, 8),
                                      (64, 128, 16), (8, 256, 8)])
def test_grid_step_plain_matches_jax(h, w, band):
    """The shapes of tests/test_kernels.py: exact against the Pallas kernel
    (interpret mode) and the JAX oracle."""
    lab, cond = grid_fixture(h * w, h, w)
    out = grid_step(torch.as_tensor(lab), torch.as_tensor(cond), band=band)
    assert out.dtype == torch.int32
    ref = np.asarray(jax_grid_step(jnp.asarray(lab), jnp.asarray(cond),
                                   band=band, interpret=True))
    assert np.array_equal(out.numpy(), ref)
    assert np.array_equal(out.numpy(), np.asarray(
        jax_grid_step_ref(jnp.asarray(lab), jnp.asarray(cond))))


@pytest.mark.parametrize("h,w", [(1, 7), (7, 1), (33, 16)])
def test_grid_step_any_int32_matches_jax_ref(h, w):
    """Negative labels and cond values outside {0, 1} (the test is cond >
    0); degenerate planes."""
    rng = np.random.default_rng(h + w)
    lab = rng.integers(-50, 100, (h, w)).astype(np.int32)
    cond = rng.integers(-3, 4, (h, w)).astype(np.int32)
    out = grid_step_ref(torch.as_tensor(lab), torch.as_tensor(cond))
    ref = jax_grid_step_ref(jnp.asarray(lab), jnp.asarray(cond))
    assert np.array_equal(out.numpy(), np.asarray(ref))


def test_grid_step_reaches_fixpoint_like_components():
    """Iterating the step floods each conductor component with its max
    label."""
    cond = torch.zeros((16, 16), dtype=torch.int32)
    cond[2, 2:10] = 1
    cond[8:14, 5] = 1
    lab = torch.zeros((16, 16), dtype=torch.int32)
    lab[2, 3], lab[10, 5] = 7, 9
    for _ in range(20):
        lab = grid_step(lab, cond)
    assert (lab[2, 2:10] == 7).all() and (lab[8:14, 5] == 9).all()
    assert int((lab != 0).sum()) == 8 + 6


@hypothesis.settings(deadline=None, max_examples=12)
@hypothesis.given(seed=st.integers(0, 10_000), h=st.sampled_from([8, 24, 40]),
                  w=st.sampled_from([16, 32]))
def test_grid_step_matches_pallas_and_monotone(seed, h, w):
    """As tests/test_properties.py: equal to the Pallas kernel (interpret
    mode), monotone, non-conductor cells unchanged."""
    lab, cond = grid_fixture(seed, h, w, p_cond=0.55, hi=99)
    out = grid_step(torch.as_tensor(lab), torch.as_tensor(cond)).numpy()
    ref = np.asarray(jax_grid_step(jnp.asarray(lab), jnp.asarray(cond),
                                   interpret=True))
    assert np.array_equal(out, ref)
    assert (out >= lab).all(), "max-diffusion must be monotone"
    assert (out[cond == 0] == lab[cond == 0]).all(), \
        "non-conductor cells must not change"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wrap_shift_max_matches_jax_and_kernel_on_margins(seed):
    """The extractor's own wrap step equals JAX's ``_shift_max`` on any
    plane, and equals the zero-padded kernel step where the mask leaves the
    outer rows and columns empty (the margin every layout carries)."""
    lab, cond = grid_fixture(seed, 24, 20)
    mask = cond > 0
    ref = np.asarray(jax_extractor._shift_max(jnp.asarray(lab),
                                              jnp.asarray(mask)))
    got = extractor._shift_max(torch.as_tensor(lab), torch.as_tensor(mask))
    assert np.array_equal(got.numpy(), ref)

    lay = layout.nand_layout()
    rng = np.random.default_rng(seed)
    for plane in (layout.M1, layout.POLY, layout.DIFF):
        mask = torch.as_tensor(lay[plane] > 0)
        lab = torch.as_tensor(rng.integers(0, 40, mask.shape).astype(
            np.int32)) * mask
        assert torch.equal(extractor._shift_max(lab, mask),
                           grid_step(lab, mask.to(torch.int32)))
