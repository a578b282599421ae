"""Helpers for CPU rehearsals of ``chip_smoke.py``'s phases: its source
exec'd with every ``"cuda"`` read as ``"cpu"``, the ``torch.cuda`` sync and
memory calls and the profiler stubbed, and the kernel wrappers counted as
the card counts them (one launch a call, under the body ``kernel_path``
names; on CPU tensors a wrapper runs its plain version and counts
nothing)."""
from pathlib import Path

import torch

from repro_torch.kernels import flash_attention as flash_pkg
from repro_torch.kernels import moe_gmm as gmm_pkg
from repro_torch.kernels import paged_attention as paged_pkg
from repro_torch.models import layers, moe

ROOT = Path(__file__).resolve().parents[1]
KERNEL_PATHS = {"paged": paged_pkg.kernel_path,
                "flash": flash_pkg.kernel_path,
                "gmm": gmm_pkg.kernel_path}


def chip_smoke_on_cpu(monkeypatch) -> dict:
    """The namespace of ``chip_smoke.py`` run on the CPU."""
    src = (ROOT / "chip_smoke.py").read_text().replace('"cuda"', '"cpu"')
    cs = {"__name__": "chip_smoke_on_cpu",
          "__file__": str(ROOT / "chip_smoke.py")}
    exec(compile(src, str(ROOT / "chip_smoke.py"), "exec"), cs)
    cs["FLASH_TRAINING"] = False     # the CPU trains through the torch route
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)

    def device_rows(torch, warm, run):
        warm()
        run()
        return 1.0, []

    cs["device_rows"] = device_rows
    return cs


def _counting(real, path_of):
    def fn(*args, **kw):
        out = real(*args, **kw)
        fn.launches += 1
        fn.launches_by_path[path_of(args)] += 1
        return out

    fn.launches = 0
    fn.launches_by_path = dict.fromkeys(flash_pkg.ops.PATHS, 0)
    return fn


def counting_wrappers(monkeypatch) -> dict:
    """The four attention / expert wrappers, counted, patched into the
    model modules that call them."""
    def attn_path(args):
        return paged_pkg.kernel_path(args[0].dtype, args[0].shape[-1])

    counters = {
        "paged_attention": _counting(layers.paged_attention, attn_path),
        "paged_attention_verify": _counting(layers.paged_attention_verify,
                                            attn_path),
        "flash_attention": _counting(layers.flash_attention, attn_path),
        "moe_gmm": _counting(moe.moe_gmm, lambda a: gmm_pkg.kernel_path(
            a[0].dtype, a[0].shape[-1], a[1].shape[-1]))}
    for mod, name in ((layers, "paged_attention"),
                      (layers, "paged_attention_verify"),
                      (layers, "flash_attention"), (moe, "moe_gmm")):
        monkeypatch.setattr(mod, name, counters[name])
    return counters


class StandIn:
    """A ``configs`` module whose ``get_config`` returns ``cfgs[name]``."""

    def __init__(self, cfgs: dict):
        self.cfgs = cfgs

    def get_config(self, name):
        return self.cfgs[name]
