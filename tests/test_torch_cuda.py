"""Card-only tests of the port: each CUDA kernel against its plain version
(paged decode, paged verify, flash, the MoE grouped matmul, the blackboard
grid step), the verify kernel at Sq = 1 against the decode kernel, the
engine (plain and speculative, dense and MoE) on the card against its own
one-shot oracle, a fleet under a crash against its fault-free run, a warm
snapshot's K/V round trip, the VLSI extraction on the card against the
port's CPU run, the wrappers' refusal of inputs that require grad, a
killed training run resuming bitwise on the card, and training through the
flash kernels (the backward against its plain version, bitwise repeatable,
a train step's gradients against the torch route).

Marked ``cuda``; each test decides inside itself whether a card is visible
and skips otherwise (never at import time). This file imports no JAX, so it
also runs on the machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py
    python -m pytest -m cuda tests/test_torch_cuda.py -k "paged or verify"
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import scheduler
from repro_torch.core.vlsi import extractor, layout, reference
from repro_torch.kernels import flash_attention as flash_pkg
from repro_torch.kernels import moe_gmm as gmm_pkg
from repro_torch.kernels import paged_attention as paged_pkg
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_fwd_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_train)
from repro_torch.kernels import grid_step as grid_pkg
from repro_torch.kernels.grid_step import (grid_step, grid_step_planes,
                                           grid_step_planes_ref,
                                           grid_step_ref)
from repro_torch.kernels.moe_gmm import gmm_ref, moe_gmm
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref,
                                                 paged_attention_verify,
                                                 paged_attention_verify_ref)
from repro_torch.models import model
from repro_torch.serve import api, durability, router, spec, traces
from repro_torch.serve import engine as eng_mod
from repro_torch.serve.faults import FaultInjector, FaultPlan

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# The worst (batch, head, row) of ||out - ref|| / ||ref|| over the head dim
# (chip_smoke.py's PAGED_ROW_TOL and FLASH_ROW_TOL): a late row's values over
# ~1,000 positions are ~0.03, below the absolute bf16 limit, so a split lost
# or mis-weighted in the merge shows only here.
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _row_rel_err(out, ref, floor=1e-30):
    o, r = out.float(), ref.float()
    return ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(floor)
            ).max().item()


def _paged_inputs(seed, b, h, hk, d, page, maxp, dtype, device,
                  lengths=None):
    rng = np.random.default_rng(seed)
    num_pages = b * maxp + 1
    q = torch.as_tensor(rng.standard_normal((b, h, d)), dtype=torch.float32)
    kp = torch.as_tensor(rng.standard_normal((num_pages, page, hk, d)),
                         dtype=torch.float32)
    vp = torch.as_tensor(rng.standard_normal((num_pages, page, hk, d)),
                         dtype=torch.float32)
    kp[0], vp[0] = 1e4, -1e4
    if lengths is None:
        lengths = rng.integers(1, maxp * page + 1, size=b)
    lengths = np.asarray(lengths, np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    table = np.zeros((b, maxp), np.int32)
    for i in range(b):
        for j in range(-(-int(lengths[i]) // page)):
            table[i, j] = free.pop()
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            torch.as_tensor(table, device=device),
            torch.as_tensor(lengths, device=device))


def _run_counted(fn, args, path):
    """Call a paged wrapper; assert it counted one launch, under ``path``."""
    n0, p0 = fn.launches, dict(fn.launches_by_path)
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert fn.launches_by_path[path] == p0[path] + 1, fn.launches_by_path
    return out


@pytest.mark.parametrize("b,h,hk,d", [(3, 4, 4, 64), (8, 15, 5, 64),
                                      (2, 8, 1, 128), (2, 4, 2, 16),
                                      (2, 8, 1, 256), (2, 16, 16, 256),
                                      (2, 64, 8, 112)])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_paged_kernel_matches_plain(card, b, h, hk, d, page, dtype, tol):
    """Within ``tol`` absolute and ``ROW_TOL`` by row; the launch counted
    under the body ``kernel_path`` names: the tensor cores in bf16 at every
    head dim (D = 112 too), CUDA cores in fp32."""
    path = paged_pkg.kernel_path(dtype, head_dim=d)
    assert path == ("mma" if dtype == torch.bfloat16 else "cuda_core")
    args = _paged_inputs(b + page, b, h, hk, d, page, 6, dtype, card)
    out = _run_counted(paged_attention, args, path)
    ref = paged_attention_ref(*args)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert _row_rel_err(out, ref) <= ROW_TOL[dtype]


def _verify_inputs(seed, b, sq, h, hk, d, page, maxp, dtype, device,
                   pos=None):
    """Ragged first positions, one lane at a page boundary and one whose
    last rows run past the table's capacity (or ``pos``); a +-1e4 null
    page."""
    rng = np.random.default_rng(seed)
    num_pages = b * maxp + 1
    q = torch.as_tensor(rng.standard_normal((b, sq, h, d)),
                        dtype=torch.float32)
    kp = torch.as_tensor(rng.standard_normal((num_pages, page, hk, d)),
                         dtype=torch.float32)
    vp = torch.as_tensor(rng.standard_normal((num_pages, page, hk, d)),
                         dtype=torch.float32)
    kp[0], vp[0] = 1e4, -1e4
    if pos is None:
        pos = rng.integers(0, maxp * page - sq + 1, size=b)
        pos[0] = page
        pos[-1] = maxp * page - max(sq - 2, 1)
    pos = np.asarray(pos, np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    table = np.zeros((b, maxp), np.int32)
    for i in range(b):
        for j in range(min(maxp, -(-(int(pos[i]) + sq) // page))):
            table[i, j] = free.pop()
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            torch.as_tensor(table, device=device),
            torch.as_tensor(pos, device=device))


@pytest.mark.parametrize("b,h,hk,d", [(3, 4, 4, 64), (8, 15, 5, 64),
                                      (2, 8, 1, 128), (2, 8, 1, 256),
                                      (2, 16, 16, 256), (2, 64, 8, 112)])
@pytest.mark.parametrize("sq", [1, 2, 5, 7])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_verify_kernel_matches_plain(card, b, h, hk, d, sq, dtype, tol):
    """Within ``tol`` absolute and ``ROW_TOL`` by row; the launch counted
    under the body ``kernel_path`` names: the tensor cores in bf16 at every
    head dim (D = 112 too), CUDA cores in fp32."""
    path = paged_pkg.kernel_path(dtype, head_dim=d)
    assert path == ("mma" if dtype == torch.bfloat16 else "cuda_core")
    args = _verify_inputs(b * 10 + sq, b, sq, h, hk, d, 16, 6, dtype, card)
    out = _run_counted(paged_attention_verify, args, path)
    ref = paged_attention_verify_ref(*args)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert _row_rel_err(out, ref) <= ROW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_kernel_sq1_is_the_decode_kernel(card, dtype):
    q, kp, vp, table, pos = _verify_inputs(7, 8, 1, 15, 5, 64, 16, 6, dtype,
                                           card)
    out = paged_attention_verify(q, kp, vp, table, pos)
    dec = paged_attention(q[:, 0].contiguous(), kp, vp, table, pos + 1)
    torch.cuda.synchronize()
    assert torch.equal(out[:, 0], dec)


def _split_edges(b, hk, maxp, page):
    """The split width of ``split_rule`` at these shapes and the capacity."""
    nsplit, pps = paged_pkg.split_rule(b, hk, maxp, page)
    return pps * page, maxp * page


@pytest.mark.parametrize("maxp", [6, 32, 96, 128])
@pytest.mark.parametrize("grp", [1, 3, 8])
@pytest.mark.parametrize("d", paged_pkg.ops.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_split_edges(card, maxp, grp, d, dtype):
    """Decode at lengths 1, page - 1, page, page + 1, a split's width +- 1
    and the table's capacity; tables of 6-128 pages; G of 1, 3 and 8:
    within the absolute and row limits, the body ``kernel_path`` names, and
    the +-1e4 null page never read."""
    b, hk, page = 8, 2, 16
    width, cap = _split_edges(b, hk, maxp, page)
    lengths = [min(max(n, 1), cap) for n in (1, page - 1, page, page + 1,
                                             width - 1, width, width + 1,
                                             cap)]
    q, kp, vp, table, lens = _paged_inputs(maxp * 31 + grp * 7 + d, b,
                                           hk * grp, hk, d, page, maxp,
                                           dtype, card, lengths)
    out = _run_counted(paged_attention, (q, kp, vp, table, lens),
                       paged_pkg.kernel_path(dtype, head_dim=d))
    ref = paged_attention_ref(q, kp, vp, table, lens)
    assert (out.float() - ref.float()).abs().max().item() <= PAGED_TOL[dtype]
    assert _row_rel_err(out, ref) <= ROW_TOL[dtype]
    kp[0], vp[0] = 0.0, 0.0
    assert torch.equal(paged_attention(q, kp, vp, table, lens), out)


@pytest.mark.parametrize("maxp", [6, 32, 96, 128])
@pytest.mark.parametrize("grp", [1, 3, 8])
@pytest.mark.parametrize("sq", [1, 2, 5, 7])
@pytest.mark.parametrize("d", paged_pkg.ops.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_split_edges(card, maxp, grp, sq, d, dtype):
    """Verify with rows straddling page and split edges (first positions 0,
    page - 1, page, a split's width - Sq / 2, width - 1, width), one lane
    ending on the capacity and one whose last rows run past it: within the
    absolute and row limits, the body ``kernel_path`` names, the null page
    never read, and each row bitwise the decode kernel at its position."""
    b, hk, page = 8, 2, 16
    width, cap = _split_edges(b, hk, maxp, page)
    pos = [min(max(p0, 0), cap - 1) for p0 in (
        0, page - 1, page, width - sq // 2 - 1, width - 1, width, cap - sq,
        cap - max(sq - 2, 1))]
    q, kp, vp, table, p = _verify_inputs(maxp * 37 + grp * 5 + sq + d, b, sq,
                                         hk * grp, hk, d, page, maxp, dtype,
                                         card, pos)
    out = _run_counted(paged_attention_verify, (q, kp, vp, table, p),
                       paged_pkg.kernel_path(dtype, head_dim=d))
    ref = paged_attention_verify_ref(q, kp, vp, table, p)
    assert (out.float() - ref.float()).abs().max().item() <= PAGED_TOL[dtype]
    assert _row_rel_err(out, ref) <= ROW_TOL[dtype]
    for r in range(sq):             # a row past the capacity stops at it
        dec = paged_attention(q[:, r].contiguous(), kp, vp, table,
                              (p + r + 1).clamp(max=cap))
        assert torch.equal(out[:, r], dec), r
    kp[0], vp[0] = 0.0, 0.0
    assert torch.equal(paged_attention_verify(q, kp, vp, table, p), out)


@pytest.mark.parametrize("which", ["q", "pages"])
@pytest.mark.parametrize("sq", [0, 5])
def test_paged_misaligned_bf16_takes_cuda_core(card, which, sq):
    """bf16 decode (G = 8) and verify (5 x 3 rows) with a query or the page
    pools offset by one element from a 16-byte boundary take the CUDA-core
    body and agree with the plain version."""
    if sq:
        args = list(_verify_inputs(3, 4, sq, 15, 5, 64, 16, 32,
                                   torch.bfloat16, card))
        fn, ref_fn = paged_attention_verify, paged_attention_verify_ref
    else:
        args = list(_paged_inputs(4, 4, 8, 1, 64, 16, 32, torch.bfloat16,
                                  card))
        fn, ref_fn = paged_attention, paged_attention_ref
    assert paged_pkg.kernel_path(torch.bfloat16, 64) == "mma"
    if which == "q":
        args[0] = _misaligned(args[0])
    else:
        args[1], args[2] = _misaligned(args[1]), _misaligned(args[2])
    assert paged_pkg.kernel_path(torch.bfloat16, 64, False) == "cuda_core"
    out = _run_counted(fn, args, "cuda_core")
    ref = ref_fn(*args)
    assert (out.float() - ref.float()).abs().max().item() <= 5e-2
    assert _row_rel_err(out, ref) <= ROW_TOL[torch.bfloat16]


@pytest.mark.parametrize("d", flash_pkg.ops.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 17, 64, 65, 128, 383, 1000])
@pytest.mark.parametrize("b,hk,grp", [(1, 2, 1), (1, 2, 3), (2, 2, 1),
                                      (2, 2, 3), (1, 5, 3)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol,row_tol", [(torch.float32, 5e-5, 1e-4),
                                               (torch.bfloat16, 5e-2, 2e-2)])
def test_flash_kernel_matches_plain(card, d, s, b, hk, grp, causal, dtype,
                                    tol, row_tol):
    """Every head dim, both tile edges (64, 65) and whole tiles (128), a
    ragged tail, MHA, GQA 3:1 and smollm's 15 / 5 heads, one and two
    sequences; within ``tol`` absolute and, on every (batch, head, row),
    ``row_tol`` of ||out - ref|| / ||ref|| (a late row's values at S = 1000
    are ~0.03, below the absolute bf16 limit, so a lost KV tile shows only
    there). The launch is counted under the body that ``kernel_path`` names
    (bf16: tensor cores, fp32: CUDA cores)."""
    _check_flash(card, s * 1009 + d * 7 + b + grp, b, hk * grp, hk, s, d,
                 causal, dtype, tol, row_tol)


@pytest.mark.parametrize("s", [65, 383])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol,row_tol", [(torch.float32, 5e-5, 1e-4),
                                               (torch.bfloat16, 5e-2, 2e-2)])
def test_flash_kernel_gemma_7b_heads(card, s, causal, dtype, tol, row_tol):
    """gemma-7b's prefill heads, 16 / 16 at D = 256 (MHA, 32-row KV tiles
    in bf16), a tile edge (65) and a ragged tail (383): the limits and the
    body of ``test_flash_kernel_matches_plain``."""
    _check_flash(card, s * 31 + 256, 1, 16, 16, s, 256, causal, dtype, tol,
                 row_tol)


# kimi-k2's in-flight lengths in chip_smoke.py's phase 13 (its trace is
# gemma-7b's: prompts 100 / 383 / 1,000 and 16 tokens of decode)
KIMI_LENGTHS = [116, 399, 1016, 130, 391, 102, 403, 1016]


@pytest.mark.parametrize("kernel", ["paged", "verify", "flash"])
def test_kimi_k2_heads_take_the_mma_body(card, kernel):
    """kimi-k2's 64 / 8 heads at D = 112 in bf16, at phase 13's shapes:
    decode over its 96-page table at the trace's lengths, verify (Sq = 5)
    from those positions, flash over a 1,000-token prompt. ``kernel_path``
    names the tensor-core body, the launch is counted under it, and the
    output holds the limits of the tests above."""
    dtype, d = torch.bfloat16, 112
    assert paged_pkg.kernel_path(dtype, d) == flash_pkg.kernel_path(
        dtype, d) == "mma"
    if kernel == "flash":
        _check_flash(card, 1000 + d, 1, 64, 8, 1000, d, True, dtype, 5e-2,
                     ROW_TOL[dtype])
        return
    if kernel == "paged":
        fn, ref_fn = paged_attention, paged_attention_ref
        args = _paged_inputs(d, 8, 64, 8, d, 16, 96, dtype, card,
                             KIMI_LENGTHS)
    else:
        fn, ref_fn = paged_attention_verify, paged_attention_verify_ref
        args = _verify_inputs(d, 8, 5, 64, 8, d, 16, 96, dtype, card,
                              KIMI_LENGTHS)
    out = _run_counted(fn, args, "mma")
    ref = ref_fn(*args)
    assert (out.float() - ref.float()).abs().max().item() <= PAGED_TOL[dtype]
    assert _row_rel_err(out, ref) <= ROW_TOL[dtype]


# qwen3-4b's heads (GQA 32 / 8 at D = 128) and minicpm-2b's (MHA 36 / 36 at
# D = 64) at chip_smoke.py's phase 14 and 15 shapes: decode over the 96-page
# table at the in-flight lengths above, verify (Sq = 5, qwen3-4b's spec run)
# from those positions, flash over a 1,000-token prompt
@pytest.mark.parametrize("kernel,h,hk,d", [
    ("paged", 32, 8, 128), ("verify", 32, 8, 128), ("flash", 32, 8, 128),
    ("paged", 36, 36, 64), ("flash", 36, 36, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qwen3_and_minicpm_heads_take_their_body(card, kernel, h, hk, d,
                                                 dtype):
    """The launch is counted under the body ``kernel_path`` names (bf16 on
    the tensor cores, fp32 on CUDA cores) and the output holds the limits
    of the tests above."""
    path = paged_pkg.kernel_path(dtype, d)
    assert path == flash_pkg.kernel_path(dtype, d) == \
        ("mma" if dtype == torch.bfloat16 else "cuda_core")
    if kernel == "flash":
        _check_flash(card, h + d, 1, h, hk, 1000, d, True, dtype,
                     5e-2 if dtype == torch.bfloat16 else 5e-5,
                     ROW_TOL[dtype])
        return
    if kernel == "paged":
        fn, ref_fn = paged_attention, paged_attention_ref
        args = _paged_inputs(h + d, 8, h, hk, d, 16, 96, dtype, card,
                             KIMI_LENGTHS)
    else:
        fn, ref_fn = paged_attention_verify, paged_attention_verify_ref
        args = _verify_inputs(h + d, 8, 5, h, hk, d, 16, 96, dtype, card,
                              KIMI_LENGTHS)
    out = _run_counted(fn, args, path)
    ref = ref_fn(*args)
    assert (out.float() - ref.float()).abs().max().item() <= PAGED_TOL[dtype]
    assert _row_rel_err(out, ref) <= ROW_TOL[dtype]


def _check_flash(card, seed, b, h, hk, s, d, causal, dtype, tol, row_tol):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=g, device=card).to(dtype)
    k = torch.randn(b, hk, s, d, generator=g, device=card).to(dtype)
    v = torch.randn(b, hk, s, d, generator=g, device=card).to(dtype)
    n0 = flash_attention.launches
    p0 = dict(flash_attention.launches_by_path)
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    path = flash_pkg.kernel_path(dtype, head_dim=d)
    assert path == ("mma" if dtype == torch.bfloat16 else "cuda_core")
    assert flash_attention.launches_by_path[path] == p0[path] + 1
    ref = attention_ref(q, k, v, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    diff = (out.float() - ref.float()).norm(dim=-1)
    assert (diff / ref.float().norm(dim=-1)).max().item() <= row_tol


@pytest.mark.parametrize("e,c,d,f", [(40, 64, 1536, 512), (40, 64, 512, 1536),
                                     (40, 252, 1536, 512),
                                     (40, 320, 1536, 512), (3, 37, 96, 80),
                                     (5, 130, 45, 23)])
@pytest.mark.parametrize("fill", ["seeded", "nan_dead", "empty", "full"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-1)])
def test_gmm_kernel_matches_plain(card, e, c, d, f, fill, dtype, tol):
    """granite-moe widths (decode gate / up and down, prefill, verify) and
    ragged shapes; group sizes seeded with 0 and C (``seeded``, and
    ``nan_dead`` with NaN in every dead row of x), all 0 (``empty``) or all
    C (``full``). Dead rows must come out exactly 0, and the launch is
    counted under the body that ``kernel_path`` names."""
    g = torch.Generator(device=card).manual_seed(e * c + f)
    x = torch.randn(e, c, d, generator=g, device=card).to(dtype)
    w = (torch.randn(e, d, f, generator=g, device=card) / d ** 0.5).to(dtype)
    sizes = torch.randint(0, c + 1, (e,), generator=g, device=card,
                          dtype=torch.int32)
    sizes[0], sizes[-1] = 0, c
    if fill == "empty":
        sizes.zero_()
    elif fill == "full":
        sizes.fill_(c)
    dead = torch.arange(c, device=card)[None, :] >= sizes[:, None]
    if fill == "nan_dead":
        x[dead] = float("nan")
    n0 = moe_gmm.launches
    p0 = dict(moe_gmm.launches_by_path)
    out = moe_gmm(x, w, sizes)
    torch.cuda.synchronize()
    assert moe_gmm.launches == n0 + 1
    path = gmm_pkg.kernel_path(dtype, d, f)
    assert moe_gmm.launches_by_path[path] == p0[path] + 1
    ref = gmm_ref(x, w, sizes)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert (out[dead] == 0).all()


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_kernel_paths_by_dtype_and_shape(card):
    """bf16 aligned calls take the tensor-core body, fp32 calls and bf16
    calls the 16-byte copies cannot serve (misaligned pointers, D or F not
    a multiple of 8) the CUDA-core body, and each agrees with its plain
    version."""
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(1, 6, 65, 64, generator=g, device=card)
    kv = torch.randn(1, 2, 65, 64, generator=g, device=card)
    cases = [(q, kv, "cuda_core"), (q.bfloat16(), kv.bfloat16(), "mma"),
             (_misaligned(q.bfloat16()), kv.bfloat16(), "cuda_core")]
    for qq, kk, want in cases:
        aligned = qq.data_ptr() % 16 == 0
        assert flash_pkg.kernel_path(qq.dtype, 64, aligned) == want
        p0 = dict(flash_attention.launches_by_path)
        out = flash_attention(qq, kk, kk)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_path[want] == p0[want] + 1
        err = (out.float() - attention_ref(qq, kk, kk).float()).abs().max()
        assert err.item() <= (5e-2 if qq.dtype == torch.bfloat16 else 5e-5)
    sizes = torch.tensor([3, 0, 17], dtype=torch.int32, device=card)
    for (d, f, dtype, misalign, want) in [
            (64, 48, torch.bfloat16, False, "mma"),
            (64, 48, torch.float32, False, "cuda_core"),
            (45, 48, torch.bfloat16, False, "cuda_core"),
            (64, 23, torch.bfloat16, False, "cuda_core"),
            (64, 48, torch.bfloat16, True, "cuda_core")]:
        x = torch.randn(3, 20, d, generator=g, device=card).to(dtype)
        w = (torch.randn(3, d, f, generator=g, device=card) / 8).to(dtype)
        if misalign:
            x = _misaligned(x)
        assert gmm_pkg.kernel_path(dtype, d, f, x.data_ptr() % 16 == 0) \
            == want
        p0 = dict(moe_gmm.launches_by_path)
        out = moe_gmm(x, w, sizes)
        torch.cuda.synchronize()
        assert moe_gmm.launches_by_path[want] == p0[want] + 1
        torch.testing.assert_close(out.float(), gmm_ref(x, w, sizes).float(),
                                   rtol=2e-1, atol=2e-1)


def test_moe_engine_on_card_matches_oneshot(card):
    """Smoke-size fp32 granite-moe engine with the kernels on the card and a
    nonzero router bias emits exactly the one-shot ``generate`` tokens; the
    grouped matmul runs three times per layer per prefill and tick."""
    cfg = configs.get_config("granite-moe-3b-a800m").smoke()
    params = model.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                               device=card)
    bias = 0.5 * torch.randn(cfg.num_layers, cfg.num_experts,
                             generator=torch.Generator().manual_seed(1))
    trace = traces.synthetic_trace(cfg, num_requests=6)
    eng = eng_mod.Engine(params, cfg,
                         eng_mod.EngineConfig(num_slots=3, max_cache=96),
                         device=card, router_bias=bias)
    n0 = moe_gmm.launches
    stats = eng.run(trace, max_ticks=400)
    assert len(eng.completed) == len(trace)
    assert moe_gmm.launches - n0 == 3 * cfg.num_layers * (
        stats["decode_ticks"] + stats["prefills"])
    for req in eng.completed:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
        assert api.generate(params, cfg, probe, max_cache=96,
                            router_bias=bias.to(card)).tokens \
            == req.out_tokens


def test_engine_on_card_matches_oneshot(card):
    """Smoke-size fp32 engine with the kernels on the card emits exactly the
    one-shot ``generate`` tokens, greedy and seeded."""
    cfg = configs.get_config("smollm-360m").smoke()
    params = model.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                               device=card)
    trace = traces.synthetic_trace(cfg, num_requests=6, temperature=0.8,
                                   sample_seed=3)
    eng = eng_mod.Engine(params, cfg,
                         eng_mod.EngineConfig(num_slots=3, max_cache=96),
                         device=card)
    eng.run(trace, max_ticks=400)
    assert len(eng.completed) == len(trace)
    for req in eng.completed:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
        assert api.generate(params, cfg, probe, max_cache=96).tokens \
            == req.out_tokens


def _fleet_engine(params, cfg, card):
    return eng_mod.Engine(params, cfg, eng_mod.EngineConfig(
        num_slots=2, max_cache=64, page_size=16, prefill_chunk=16,
        num_classes=3, latency_budget=64.0, pin_pages=4), device=card)


def test_fleet_on_card_crash_equals_fault_free(card):
    """A 2-replica smoke fleet on the card under a crash + rejoin (and a
    pressure shock) completes every rid with its fault-free tokens; the
    replaced replica's pool is freed."""
    cfg = configs.get_config("smollm-360m").smoke()
    params = model.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                               device=card)

    def trace():
        return traces.fleet_trace(cfg, tenants=3, num_requests=12,
                                  prefix_len=32, suffix_lens=(4,),
                                  decode_lens=(6,), burst_every=4,
                                  burst_size=3)

    clean = router.Router([_fleet_engine(params, cfg, card)
                           for _ in range(2)])
    clean.run(trace(), max_ticks=400)
    ref = {r.rid: r.out_tokens for r in clean.completed}
    fleet = router.Router(
        [_fleet_engine(params, cfg, card) for _ in range(2)],
        injector=FaultInjector(
            FaultPlan.parse("crash@4:r1 rejoin@14:r1 pressure@2+4:r0:p2"),
            engine_factory=lambda: _fleet_engine(params, cfg, card)))
    s = fleet.run(trace(), max_ticks=400)
    assert s["deaths"] == 1 and s["rejoins"] == 1 and s["unserved"] == 0
    assert s["replaced_requests"] > 0
    assert {r.rid: r.out_tokens for r in fleet.completed} == ref
    assert len(ref) == 12 and fleet.fallen[0].pool is None


def test_warm_snapshot_round_trips_kv_bit_for_bit(card, tmp_path):
    """Export a warm bf16 engine's pinned forest, write it as a snapshot,
    read it back and import it into a fresh engine: every pinned page's K/V
    is the exported one bit for bit."""
    cfg = dataclasses.replace(configs.get_config("smollm-360m").smoke(),
                              dtype="bfloat16")
    params = model.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                               device=card)
    eng = _fleet_engine(params, cfg, card)
    eng.run(traces.returning_tenant_trace(cfg, prefix_len=48, bursts=1),
            max_ticks=400)
    meta, kv = eng.export_warm_state()
    assert kv and kv[0].dtype == torch.bfloat16
    durability.save_snapshot(str(tmp_path), 3, {"replicas": [meta]}, kv)
    blob, back, step = durability.load_snapshot(str(tmp_path))
    fresh = _fleet_engine(params, cfg, card)
    n = fresh.import_warm_state(blob["replicas"][0], back)
    assert n == len(meta["forest"]) > 0 and step == 3
    meta2, kv2 = fresh.export_warm_state()
    assert [e["tokens"] for e in meta2["forest"]] == \
        [e["tokens"] for e in meta["forest"]]
    for a, b in zip(kv, kv2):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_spec_engine_on_card_matches_oneshot(card):
    """Smoke-size fp32 spec engine with the kernels on the card: the verify
    kernel runs, and every stream is the one-shot ``generate``'s."""
    cfg = configs.get_config("smollm-360m").smoke()
    params = spec.make_draft_friendly(
        model.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                          device=card), cfg, 1)
    trace = traces.agentic_trace(cfg, sessions=2, turns=3, base_prompt=16,
                                 grow_lens=(4, 6), decode_lens=(6, 8),
                                 turn_gap=2)
    eng = eng_mod.Engine(params, cfg, eng_mod.EngineConfig(
        num_slots=2, max_cache=96, prefill_chunk=8, spec_decode=4,
        spec_draft_layers=1), device=card)
    n0 = paged_attention_verify.launches
    stats = eng.run(trace, max_ticks=400)
    assert stats["completed"] == len(trace) and stats["spec_ticks"] > 0
    assert paged_attention_verify.launches - n0 == \
        cfg.num_layers * stats["spec_ticks"]
    for req in eng.completed:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
        assert api.generate(params, cfg, probe, max_cache=96).tokens \
            == req.out_tokens


def _grid_inputs(dev, shape, seed, offset=0):
    """Any-int32 labels and cond of ``shape`` (negative labels, cond values
    outside {0, 1}), as views ``offset`` words into fresh buffers."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = int(np.prod(shape)) + offset
    lab = torch.randint(-50, 100, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    cond = torch.randint(-3, 4, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    return lab[offset:].view(shape), cond[offset:].view(shape)


def _one_launch(fn, lab, cond, path):
    """``fn(lab, cond)`` after a sync; asserts one launch, on ``path``."""
    n0, p0 = grid_step.launches, grid_step.launches_by_path[path]
    out = fn(lab, cond)
    torch.cuda.synchronize()
    assert grid_step.launches == n0 + 1
    assert grid_step.launches_by_path[path] == p0 + 1
    return out


@pytest.mark.parametrize("planes", [0, 1, 4])
@pytest.mark.parametrize("h,w", [(16, 32), (40, 32), (33, 16), (64, 128),
                                 (8, 256), (1, 7), (7, 1), (80, 128),
                                 (4096, 4096)])
def test_grid_step_kernel_matches_plain(card, h, w, planes):
    """The extraction path's shape (80, 128), ragged and degenerate shapes
    and a large plane, on one plane (``grid_step``, planes = 0) and as
    stacks of 1 and 4 different planes (``grid_step_planes``): exact
    equality, including negative labels and cond values outside {0, 1}, one
    launch a call on the body ``kernel_path`` predicts."""
    shape = (h, w) if planes == 0 else (planes, h, w)
    fn = grid_step if planes == 0 else grid_step_planes
    lab, cond = _grid_inputs(card, shape, h * 7919 + w + planes)
    out = _one_launch(fn, lab, cond, grid_pkg.kernel_path(w))
    assert torch.equal(out, grid_step_planes_ref(lab, cond))
    if planes:
        for p in range(planes):
            assert torch.equal(out[p], grid_step_ref(lab[p], cond[p]))
    n0 = grid_step.launches
    empty = torch.zeros((0, *shape[1:]), dtype=torch.int32, device=card)
    assert fn(empty, empty).shape == empty.shape
    assert grid_step.launches == n0


@pytest.mark.parametrize("shape,offset", [((4, 40, 30), 0), ((3, 7, 5), 0),
                                          ((4, 40, 32), 1), ((4, 80, 128), 2),
                                          ((2, 33, 16), 3), ((5, 9, 11), 1),
                                          ((1, 262148, 130), 0)])
def test_grid_step_scalar_body_inputs(card, shape, offset):
    """Stacks the 16-byte body cannot take: W not a multiple of 4, an odd
    H * W (planes at odd word offsets), and views that start 1-3 words past
    a 16-byte boundary. Each takes the scalar body, exactly. The last plane
    is too tall for one 4-row chunk a band within grid.y's limit, so its
    bands run two chunks."""
    lab, cond = _grid_inputs(card, shape, sum(shape) + offset, offset)
    assert grid_pkg.kernel_path(shape[-1], aligned=offset == 0) == "scalar"
    out = _one_launch(grid_step_planes, lab, cond, "scalar")
    assert torch.equal(out, grid_step_planes_ref(lab, cond))
    if offset:   # the same planes, aligned, on the 16-byte body where W allows
        path = grid_pkg.kernel_path(shape[-1])
        assert torch.equal(_one_launch(grid_step_planes, lab.clone(),
                                       cond.clone(), path), out)


@pytest.mark.parametrize("seed", [1])
def test_vlsi_nand_on_card_equals_cpu(card, seed):
    """The NAND extraction (64 agents) on the card equals the port's CPU run
    bit for bit (blackboard, cycles, agents); the observer's fixpoint test
    launches the grid-step kernel once (its four label planes as one stack)
    before every cycle and once more at the end, on the 16-byte body."""
    lay = layout.nand_layout()
    n0, v0 = grid_step.launches, grid_step.launches_by_path["vec4"]
    grid, steps, _, agents = extractor.run_extraction(lay, 64, seed=seed,
                                                      device=card)
    assert grid_step.launches - n0 == steps + 1
    assert grid_step.launches_by_path["vec4"] - v0 == steps + 1
    hgrid, hsteps, _, hagents = extractor.run_extraction(lay, 64, seed=seed,
                                                         device="cpu")
    assert steps == hsteps < 4000
    assert np.array_equal(grid, hgrid)
    for f in agents._fields:
        assert torch.equal(getattr(agents, f).cpu(), getattr(hagents, f)), f
    ok, msg = extractor.netlists_equivalent(extractor.harvest(grid, lay),
                                            reference.extract(lay))
    assert ok, msg


def test_scheduler_on_card_matches_cpu(card):
    rng = np.random.default_rng(0)
    trace = np.clip(1.0 + 0.05 * rng.standard_normal((200, 16)), 1e-3, None)
    trace[:, 0] *= 0.3
    trace = trace.astype(np.float32)
    for static in (False, True):
        got = scheduler.simulate(trace, static=static, device=card).cpu()
        ref = scheduler.simulate(trace, static=static, device="cpu")
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the serving kernels have no backward; training runs without them, but for
# attention, which trains through the flash backward in bf16
# ---------------------------------------------------------------------------
def _wrapper_calls(device, requires_grad: bool) -> dict:
    """One call of each kernel wrapper at a small shape, the float inputs
    made to require grad when asked."""
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.float32):
        x = torch.randn(shape, generator=g, dtype=dtype).to(device)
        return x.requires_grad_(requires_grad)

    table = torch.arange(1, 5, dtype=torch.int32, device=device)[None]
    lengths = torch.tensor([30], dtype=torch.int32, device=device)
    pos = torch.tensor([20], dtype=torch.int32, device=device)
    sizes = torch.tensor([3, 0], dtype=torch.int32, device=device)
    return {
        "flash_attention": lambda: flash_attention(t(1, 4, 9, 16),
                                                   t(1, 2, 9, 16),
                                                   t(1, 2, 9, 16)),
        "paged_attention": lambda: paged_attention(
            t(1, 4, 16), t(5, 8, 2, 16), t(5, 8, 2, 16), table, lengths),
        "paged_attention_verify": lambda: paged_attention_verify(
            t(1, 3, 4, 16), t(5, 8, 2, 16), t(5, 8, 2, 16), table, pos),
        "moe_gmm": lambda: moe_gmm(t(2, 4, 8), t(2, 8, 16), sizes),
    }


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "paged_attention_verify", "moe_gmm"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(card, name):
    """On CUDA tensors a wrapper would return an output with no grad_fn:
    under grad mode it raises instead; under no_grad, or without
    requires_grad, it launches."""
    with pytest.raises(RuntimeError, match="no backward"):
        _wrapper_calls(card, True)[name]()
    with torch.no_grad():
        _wrapper_calls(card, True)[name]()
    _wrapper_calls(card, False)[name]()
    torch.cuda.synchronize()


def test_trainer_on_card_resumes_bitwise_without_kernels(card, tmp_path):
    """A killed smoke run resumes bitwise on the card, and training
    launches no kernel."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    cfg = configs.get_config("granite-moe-3b-a800m").smoke()
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, decay_steps=100)
    wrappers = (flash_attention, paged_attention, paged_attention_verify,
                moe_gmm, grid_step)
    before = [w.launches for w in wrappers]

    def mk(sub, **kw):
        return Trainer(cfg=cfg, tcfg=tcfg, workdir=str(tmp_path / sub),
                       batch=4, seq=32, ckpt_every=4, device="cuda", **kw)

    state_a = mk("a").train(10)
    with pytest.raises(RuntimeError, match="injected node failure"):
        mk("b", failure_at=6).train(10)
    state_b = mk("b").train(10)
    la, _ = ckpt.flatten(ts.state_tree(state_a, cfg))
    lb, _ = ckpt.flatten(ts.state_tree(state_b, cfg))
    assert all(torch.equal(a, b) for a, b in zip(la, lb, strict=True))
    assert [w.launches for w in wrappers] == before


def test_host_mesh_and_placement_on_card(card):
    """The host mesh on the card is a one-rank NCCL ('data', 'model') mesh;
    the smoke params placed on it by the sharding rules are CUDA DTensors
    whose local shards equal the plain leaves, and ``serve_step`` on them
    gives the plain model's logits bit for bit."""
    import copy
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.serve import decode
    mesh = make_host_mesh()
    assert mesh.device_type == "cuda" and mesh.mesh_dim_names == \
        ("data", "model")
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    cfg = configs.get_config("smollm-360m").smoke()
    plain = model.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(0))
    placed = copy.deepcopy(plain)
    layers.set_mesh_axes(mesh)
    try:
        shd.place(placed, shd.param_shardings(placed, cfg, mesh), mesh, cfg)
        for (name, p), q in zip(placed.named_parameters(),
                                plain.parameters()):
            assert isinstance(p, DTensor) and p.device.type == "cuda", name
            assert torch.equal(p.to_local(), q), name
        tok = torch.randint(0, cfg.vocab_size, (2, 1), device="cuda")
        want, _ = decode.serve_step(plain, cfg, {"token": tok},
                                    model.init_cache(cfg, 2, 8, "cuda"))
        cache = model.init_cache(cfg, 2, 8, "cuda")
        cache = shd.place(cache, shd.cache_shardings(cache, cfg, mesh), mesh)
        batch = shd.place({"token": tok}, shd.batch_shardings(
            {"token": tok}, mesh), mesh)
        got, _ = decode.serve_step(placed, cfg, batch, cache)
        assert torch.equal(got.full_tensor(), want)
    finally:
        layers.set_mesh_axes(None)


def test_telemetry_records_under_the_harness_profiler(card):
    """The benchmark's traced window (``torch.profiler`` over the card's
    activity alone, one warm-up step, then the active one) turns the
    tracer on from its active step, and a training step recorded there
    times its phases on the card."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import telemetry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import pipeline
    from repro_torch.train import train_step as ts
    cfg = configs.get_config("smollm-360m").smoke()
    tcfg = TrainConfig()
    state = ts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                                device="cuda")
    batch, _ = pipeline.sample_batch(cfg, 2, 32,
                                     pipeline.init_data_state("cuda"), seed=1)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        torch.ones(16, device="cuda").add_(1)          # the warm-up step
        torch.cuda.synchronize()
        assert telemetry.session() is None
        prof.step()
        assert telemetry.session() is not None
        state, _ = ts.train_step(state, batch, cfg, tcfg)
        torch.cuda.synchronize()
        prof.step()
    assert telemetry.session() is None
    s = telemetry.last()
    (step,) = s.named("train_step")
    phases = {c.name: s.device_ms(c) for c in s.children(step)}
    assert set(phases) == {"forward", "backward", "optimizer"}
    assert all(ms > 0 for ms in phases.values()), phases


# ---------------------------------------------------------------------------
# training through flash: the forward with its lse and the backward
# ---------------------------------------------------------------------------
# minicpm-2b's training shape (its benchmark cell) and qwen3-4b's heads, then
# ragged tails and a GQA group of 3 at both head dims
BWD_SHAPES = [(2, 36, 36, 2048, 64), (2, 32, 8, 1000, 128), (1, 4, 4, 1, 64),
              (1, 4, 4, 65, 64), (2, 8, 2, 383, 128), (1, 6, 2, 200, 64),
              (2, 24, 8, 513, 64)]


# a gradient row's norm is floored here (chip_smoke.py's
# FLASH_BWD_ROW_FLOOR): the first query's dq row is zero, where the
# kernel's round-off would divide by nothing
BWD_ROW_FLOOR = 1e-2


def _bwd_inputs(card, b, h, hk, s, d, seed=0):
    g = torch.Generator(device=card).manual_seed(seed + 7 * s + d + h)

    def t(*shape):
        return torch.randn(*shape, generator=g, device=card).bfloat16()

    return t(b, h, s, d), t(b, hk, s, d), t(b, hk, s, d), t(b, h, s, d)


@pytest.mark.parametrize("b,h,hk,s,d", BWD_SHAPES)
def test_flash_train_kernels_match_plain(card, b, h, hk, s, d):
    """Through the autograd Function: the forward's output and lse against
    ``attention_fwd_ref``, each gradient's worst row against
    ``attention_bwd_ref`` on the same output and lse (ROW_TOL's bf16
    limit, chip_smoke.py's FLASH_BWD_ROW_TOL), one launch of each on
    ``mma``."""
    q, k, v, do = _bwd_inputs(card, b, h, hk, s, d)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    fm = flash_attention.launches_by_path["mma"]
    bm = flash_attention_bwd.launches_by_path["mma"]
    out = flash_attention_train(*leaves)
    lse = out.grad_fn.saved_tensors[4]
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == \
        (f0 + 1, b0 + 1)
    assert flash_attention.launches_by_path["mma"] == fm + 1
    assert flash_attention_bwd.launches_by_path["mma"] == bm + 1
    ref_out, ref_lse = attention_fwd_ref(q, k, v)
    assert _row_rel_err(out.detach(), ref_out) <= ROW_TOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= 1e-5 * max(
        ref_lse.abs().max().item(), 1.0)
    plain = attention_bwd_ref(q, k, v, out.detach(), do, lse)
    for got, want in zip(grads, plain, strict=True):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.isfinite(got).all()
        assert _row_rel_err(got, want, BWD_ROW_FLOOR) <= \
            ROW_TOL[torch.bfloat16]


@pytest.mark.parametrize("b,h,hk,s,d", BWD_SHAPES[:2])
def test_flash_bwd_is_bitwise_repeatable(card, b, h, hk, s, d):
    """No atomics: two calls give the same bits."""
    q, k, v, do = _bwd_inputs(card, b, h, hk, s, d, seed=1)
    lse = torch.empty(b, h, s, device=card)
    out = flash_pkg.ops._launch(q, k, v, True, lse)
    first = flash_attention_bwd(q, k, v, out, do, lse)
    for _ in range(2):
        again = flash_attention_bwd(q, k, v, out, do, lse)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_flash_train_refuses_fp32_on_the_card(card):
    q = torch.randn(1, 4, 9, 64, device=card)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_train(q, q, q)


# a gradient leaf through flash against the torch route, both bf16, as
# ||flash - torch|| / ||torch||: the torch route rounds S, P and its
# einsums' outputs to bf16, the kernels P and dS alone
TRAIN_GRAD_REL = 5e-2


def test_train_step_through_flash_matches_the_torch_route(card, monkeypatch):
    """A 2-layer bf16 minicpm-2b smoke model at head dim 64 (MHA 4 / 4),
    one 4 x 128 batch: its gradients (``loss_and_grads``) through flash
    match the torch route's within TRAIN_GRAD_REL, leaf by leaf, the loss
    within 1e-2 of itself; one ``train_step`` launches the flash forward
    and backward once a layer."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import pipeline
    from repro_torch.models import layers
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(configs.get_config("minicpm-2b").smoke(),
                              dtype="bfloat16", head_dim=64)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, decay_steps=10)
    state = ts.init_train_state(torch.Generator(device=card).manual_seed(5),
                                cfg, tcfg, device=card)
    batch, _ = pipeline.sample_batch(cfg, 4, 128,
                                     pipeline.init_data_state(card))
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    loss_f, _, grads_f = ts.loss_and_grads(state.params, cfg, batch)
    torch.cuda.synchronize()
    assert (flash_attention.launches - f0, flash_attention_bwd.launches - b0) \
        == (cfg.num_layers, cfg.num_layers)
    with monkeypatch.context() as m:
        m.setattr(layers, "flash_trains", lambda *a: False)
        loss_t, _, grads_t = ts.loss_and_grads(state.params, cfg, batch)
    assert abs(float(loss_f) - float(loss_t)) <= 1e-2 * abs(float(loss_t))
    for a, b in zip(grads_f, grads_t, strict=True):
        rel = (a.float() - b.float()).norm() / b.float().norm().clamp_min(
            1e-30)
        assert rel.item() <= TRAIN_GRAD_REL
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    state, met = ts.train_step(state, batch, cfg, tcfg)
    torch.cuda.synchronize()
    assert torch.isfinite(met.loss)
    assert (flash_attention.launches - f0, flash_attention_bwd.launches - b0) \
        == (cfg.num_layers, cfg.num_layers)


def test_trainer_through_flash_resumes_bitwise(card, tmp_path):
    """A killed bf16 run whose attention trains through flash resumes
    bitwise on the card: the backward is deterministic."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(configs.get_config("smollm-360m").smoke(),
                              dtype="bfloat16", head_dim=64)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, decay_steps=100)
    b0 = flash_attention_bwd.launches

    def mk(sub, **kw):
        return Trainer(cfg=cfg, tcfg=tcfg, workdir=str(tmp_path / sub),
                       batch=4, seq=64, ckpt_every=4, device="cuda", **kw)

    state_a = mk("a").train(10)
    with pytest.raises(RuntimeError, match="injected node failure"):
        mk("b", failure_at=6).train(10)
    state_b = mk("b").train(10)
    assert flash_attention_bwd.launches - b0 == cfg.num_layers * (10 + 6 + 6)
    la, _ = ckpt.flatten(ts.state_tree(state_a, cfg))
    lb, _ = ckpt.flatten(ts.state_tree(state_b, cfg))
    assert all(torch.equal(a, b) for a, b in zip(la, lb, strict=True))


# the granite cell's state at the published depth: bf16 weights and
# gradients 6.6 GB each, fp32 moments 26.4 GB; with the update in place and
# its temporaries near 1 GB, activations (one recomputed layer, the 8,192 x
# 49,155 fp32 logits) leave the peak well under this
GRANITE_PEAK_BYTES = 60e9


def test_granite_train_step_at_full_depth_fits_one_card(card):
    """granite-moe-3b-a800m at its published widths and all 32 layers, the
    benchmark cell's batch (4 x 2,048), full remat, fp32 moments: two train
    steps peak under GRANITE_PEAK_BYTES with finite losses."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import pipeline
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(configs.get_config("granite-moe-3b-a800m"),
                              remat="full")
    assert (cfg.num_layers, cfg.num_experts, cfg.d_model) == (32, 40, 1536)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=0, decay_steps=10000,
                       schedule="cosine")
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_train_state(torch.Generator(device=card).manual_seed(7),
                                cfg, tcfg, device=card)
    data = pipeline.init_data_state(card)
    for _ in range(2):
        batch, data = pipeline.sample_batch(cfg, 4, 2048, data)
        state, met = ts.train_step(state, batch, cfg, tcfg)
        assert torch.isfinite(met.loss)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"granite train step peak {peak / 1e9:.2f} GB")
    assert peak < GRANITE_PEAK_BYTES
