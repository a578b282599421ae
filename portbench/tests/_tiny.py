"""Tiny stand-ins of the cells for CPU rehearsals: the same harness, run code
and reference on a two-layer model of small widths in float32, with the
kernels' plain versions."""
import atexit
import functools
import importlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.core import report, spec  # noqa: E402

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=96, vocab_size=256, dtype="float32")


def shrink(cell, wide: bool = False):
    """``wide``: a d_model of 1,024 with two layers, whose logits spread as
    the full model's do (the embedding's scale grows with the width), for
    checks whose limits are in logit units."""
    m = cell.config["model"]
    m.update(TINY)
    if wide:
        m.update(d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
                 d_ff=512)
    if m.get("num_experts"):
        m.update(num_experts=8, experts_per_token=2)
    t = cell.traffic
    if t["kind"] == "serve":
        t.update(prompt=dict(t["prompt"], median=48, min=24, max=80),
                 answer={"min": 4, "max": 8}, rate_per_s=4.0)
        t["engine"] = dict(t["engine"], num_slots=4, max_cache=96,
                           num_pages=24)
        t["warmup"] = dict(t["warmup"], pages=16)
        t["check"] = dict(t["check"], requests=3)
    else:
        t.update(batch=2, seq=32)
    return cell


# cells prepared in files but not in BENCHMARK.json (PERF.md, open
# questions); rehearsed under a benchmarked cell's limits from a root whose
# BENCHMARK.json also holds them
PREPARED = {"granite-moe-3b.train": {"config": "granite-moe-3b-a800m",
                                     "traffic": "pretrain_4x2048",
                                     "limits": "minicpm-2b.train"}}


@functools.lru_cache(maxsize=None)
def prepared_root() -> Path:
    """A temporary root: BENCHMARK.json with the prepared cells added, and
    ``portbench`` linked to this checkout's."""
    root = Path(tempfile.mkdtemp(prefix="portbench-prepared-"))
    atexit.register(shutil.rmtree, root, True)
    (root / "portbench").symlink_to(ROOT / "portbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, p in PREPARED.items():
        if p["config"] not in [c["name"] for c in bench["configs"]]:
            bench["configs"].append({
                "name": p["config"], "source": "prepared",
                "file": f"portbench/configs/{p['config']}.json",
                "reduced": [], "why": "prepared"})
        bench["workloads"].append({"name": name, "config": p["config"],
                                   "traffic": p["traffic"], "chips": 1,
                                   "why": "prepared"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def tiny_cell(name: str, root=ROOT, wide: bool = False):
    if name in PREPARED:
        cell = spec.Cell(name, prepared_root())
        cell.limits = spec.Cell(PREPARED[name]["limits"], root).limits
    else:
        cell = spec.Cell(name, root)
    return shrink(cell, wide)


def run_cpu(cell, seed: int = 2 ** 31 + 77, seconds: float = 2.0,
            trace: bool = False) -> dict:
    """One rehearsal run; returns the result line as printed, parsed."""
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['kind']}")
    t0 = time.perf_counter()
    run = driver.run(cell, seed, seconds, trace, "cpu",
                     lambda: time.perf_counter() - t0)
    return json.loads(json.dumps(report.result(run, trace)))
