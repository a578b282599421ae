"""Helpers of the port's mesh tests (``test_torch_mesh_parallel.py``,
``test_torch_mesh_train.py``): a ``LocalTensorMode`` world, the global value
of a DTensor, and the smoke-size parity setup (JAX params converted to the
port).
"""
import contextlib
import dataclasses

import jax
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed._local_tensor import LocalTensor, LocalTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.models import layers
from repro_torch.models import model as model_lib

TOL = 1e-5
ARCHS = ("smollm-360m", "granite-moe-3b-a800m")


@contextlib.contextmanager
def local_world(shape):
    """A ``fake`` group of prod(shape) ranks, all run here, and its
    ('data', 'model') mesh recorded for the constraints."""
    n = int(np.prod(shape))
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        with LocalTensorMode(n):
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            layers.set_mesh_axes(mesh)
            yield mesh
    finally:
        layers.set_mesh_axes(None)
        dist.destroy_process_group()


def _full(x) -> torch.Tensor:
    """A DTensor's global value, checked equal on every rank."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, LocalTensor):
        vals = list(x._local_tensors.values())
        for v in vals[1:]:
            assert torch.equal(v, vals[0])
        x = vals[0]
    return x.detach()


def _close(a, b, tol=TOL):
    a = _full(a).double().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float64)
    b = _full(b).double().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _rel(a, b) -> float:
    a = _full(a).double().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float64)
    b = _full(b).double().numpy()
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _setup(arch, batch=4, seq=8):
    """JAX params converted to the port; dispatch groups = DP size 2."""
    over = {"dispatch_groups": 2} if "moe" in arch else {}
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(), **over)
    cfg = dataclasses.replace(configs.get_config(arch).smoke(), **over)
    assert cfg.dtype == "float32"
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model_lib.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    b, _ = jpipe.sample_batch(jcfg, batch, seq, jpipe.init_data_state())
    bias = None
    if jcfg.num_experts:
        bias = (0.1 * np.random.default_rng(0).standard_normal(
            (jcfg.num_layers, jcfg.num_experts))).astype(np.float32)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    return jcfg, cfg, jp, tp, b, tb, bias


def _place_batch(batch, mesh):
    return shd.place(batch, shd.batch_shardings(batch, mesh), mesh)
