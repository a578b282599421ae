"""Mesh construction (PyTorch port of ``repro/launch/mesh.py``). Functions,
not module constants: importing this module touches no device and no
process group.

``make_production_mesh`` lays the production meshes over the world that is
up (the dry-run starts a ``fake`` process group of 256 / 512 ranks);
``make_host_mesh`` builds a mesh over this process's devices, starting a
one-rank group over a ``HashStore`` when none is up.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """16x16 = 256 ranks ('data', 'model'); 2 pods = 512 ranks ('pod',
    'data', 'model'). Needs a process group of that world size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device=None) -> DeviceMesh:
    """('data', 'model') over this process's world. ``device`` defaults to
    ``cuda``: a one-rank NCCL group is started here if none is up, and no
    visible card is an error. ``"cpu"`` (as the tests ask) uses ``gloo``."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device is visible "
                           "(pass device='cpu')")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    model_axis = min(model_axis, n)
    return init_device_mesh(dev.type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
