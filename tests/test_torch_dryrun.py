"""The port's meta-device dry-run (``repro_torch.launch.dryrun``) on the CPU:
its per-device recorder on known ops (the counterpart of
``tests/test_properties.py::TestCollectiveParser``), one cell in a fresh
subprocess, and both production meshes (``slow``, as
``tests/test_system.py::test_multi_device_dryrun_subprocess`` is).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.launch import dryrun

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the JAX dry-run's record keys; the port's ``torch_flops_per_device``
# takes the place of its xla_* observables
RECORD_KEYS = {"arch", "shape", "mesh", "status", "pcfg", "chips", "params",
               "active_params", "tokens_per_step", "flops_per_device",
               "hbm_bytes_per_device", "state_bytes_per_device",
               "collective_bytes_per_device", "collective_by_kind",
               "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
               "model_flops_total", "useful_flops_frac", "roofline_frac",
               "memory", "fits_hbm", "compile_s"}


@pytest.fixture
def mesh22():
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


class TestRecorder:
    def test_all_gather_and_ring_all_reduce_bytes(self, mesh22):
        a = DTensor.from_local(torch.ones(4, 6), mesh22,
                               (Shard(0), Replicate()), run_check=False)
        p = DTensor.from_local(torch.ones(4, 4), mesh22,
                               (Replicate(), Partial()), run_check=False)
        rec = dryrun.StepRecorder()
        with rec:
            a.redistribute(mesh22, (Replicate(), Replicate()))
            p.redistribute(mesh22, (Replicate(), Replicate()))
        # ag: the gathered (8, 6) fp32 = 192 bytes (x1); ar: (4, 4) fp32 =
        # 64 bytes x 2 (ring)
        assert rec.by_kind == {"all-gather": 192.0, "all-reduce": 128.0}
        assert rec.calls == {"all-gather": 1, "all-reduce": 1}
        assert rec.coll_bytes == 320.0

    def test_shard_to_shard_is_one_all_to_all(self, mesh22, monkeypatch):
        from torch.distributed.tensor import _collective_utils as cu
        from torch.distributed.tensor import placement_types as pt
        for mod in (cu, pt):                # restored after the test
            monkeypatch.setattr(mod, "shard_dim_alltoall",
                                mod.shard_dim_alltoall)
        dryrun._card_alltoall()
        x = DTensor.from_local(torch.ones(4, 8), mesh22,
                               (Replicate(), Shard(0)), run_check=False)
        rec = dryrun.StepRecorder()
        with rec:
            y = x.redistribute(mesh22, (Replicate(), Shard(1)))
        assert y.to_local().shape == (8, 4)
        assert rec.by_kind == {"all-to-all": 128.0}

    def test_local_flops_and_dtensor_ops_pass_through(self, mesh22):
        a = DTensor.from_local(torch.ones(4, 8), mesh22,
                               (Shard(0), Replicate()), run_check=False)
        b = DTensor.from_local(torch.ones(8, 2), mesh22,
                               (Replicate(), Replicate()), run_check=False)
        rec = dryrun.StepRecorder()
        with rec:
            c = a @ b
        assert isinstance(c, DTensor)
        assert rec.flops == 2 * 4 * 8 * 2          # the local (4, 8) @ (8, 2)
        assert rec.coll_bytes == 0.0


def test_import_touches_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
            "print(dist.is_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "False"


def test_constants_are_the_h100s():
    assert dryrun.DEVICE == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW,
            dryrun.HBM_BYTES) == (989e12, 3.35e12, 450e9, 80e9)


def _run(tmp_path, extra):
    out = tmp_path / "dry.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-360m", "--shape", "decode_32k", "--out", str(out)] + extra,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return [json.loads(line) for line in open(out)]


def test_one_cell_subprocess(tmp_path):
    (rec,) = _run(tmp_path, [])
    assert rec["status"] == "ok", rec
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert RECORD_KEYS <= set(rec)
    assert not any(k.startswith("xla_") for k in rec)
    assert rec["collective_bytes_per_device"] > 0
    assert rec["collective_bytes_per_device"] == pytest.approx(
        sum(rec["collective_by_kind"].values()))
    assert rec["torch_flops_per_device"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["params"] == 361821120 and rec["tokens_per_step"] == 128


@pytest.mark.slow
def test_both_meshes_subprocess(tmp_path):
    recs = _run(tmp_path, []) + _run(tmp_path, ["--multi-pod"])
    assert {rec["mesh"] for rec in recs} == {"16x16", "2x16x16"}
    assert all(rec["status"] == "ok" for rec in recs)
    assert all(rec["chips"] in (256, 512) for rec in recs)
