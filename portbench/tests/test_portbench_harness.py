"""The harness on the CPU: cells, mixes and metrics found by name, a cell
added as files alone, the arithmetic of percentiles, rates and counts, a
rehearsal of every cell, and what the measuring process may load."""
import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from _tiny import ROOT, run_cpu, shrink, tiny_cell

from portbench.core import guard, spec, stats

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH_NAMES = [w["name"] for w in BENCH["workloads"]]
CELLS = BENCH_NAMES + ["granite-moe-3b.train"]      # prepared, see _tiny


def test_cell_finds_config_mix_metrics_and_limits_by_name():
    cell = spec.Cell("minicpm-2b.docqa")
    assert cell.config["model"]["d_model"] == 2304
    assert cell.traffic["kind"] == "serve"
    assert "logit_gap" in cell.limits
    names = [m["name"] for m in cell.metrics(trace=False)]
    assert names == ["ttft_p90_ms", "setup_s"]
    traced = [m["name"] for m in cell.metrics(trace=True)]
    assert "flash_roofline.serve" in traced and "mfu.train" not in traced
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(cell.reader(m["name"]))
    with pytest.raises(KeyError):
        spec.Cell("no-such-cell")


def test_every_named_file_exists():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.Cell(BENCH_NAMES[0]).reader_path(m["name"]).is_file()


def test_a_cell_added_as_files_only_runs(tmp_path):
    """A new configuration, mix and metric as new files and new entries of
    BENCHMARK.json: no file that was there changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((ROOT / "portbench/configs/minicpm-2b.json").read_text())
    base["model"].update(name="tiny-dense", num_layers=2, d_model=32,
                         num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
                         vocab_size=128, dtype="float32")
    (tmp_path / "portbench/configs/tiny-dense.json").write_text(
        json.dumps(base))
    mix = json.loads((ROOT / "portbench/traffic/docqa.json").read_text())
    mix.update(rate_per_s=3.0, prompt=dict(mix["prompt"], median=20, min=10,
                                           max=40),
               answer={"min": 2, "max": 5}, check={"requests": 2})
    mix["engine"].update(num_slots=2, max_cache=64, num_pages=16)
    mix["warmup"]["pages"] = 12
    (tmp_path / "portbench/traffic/shortqa.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/requests_seen.tiny.py").write_text(
        "def read(run):\n    return run.counters['requests']\n")
    (tmp_path / "portbench/limits/tiny-dense.shortqa.json").write_text(
        json.dumps({"logit_gap": 1.0}))
    bench["configs"].append({"name": "tiny-dense", "source": "test",
                             "file": "portbench/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-dense.shortqa",
                               "config": "tiny-dense", "traffic": "shortqa",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_seen.tiny", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "load generator",
                               "moves": "ttft_p90_ms",
                               "workloads": ["tiny-dense.shortqa"]})
    for m in bench["end_to_end"]:
        if m["name"] == "ttft_p90_ms":
            m["workloads"].append("tiny-dense.shortqa")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("tiny-dense.shortqa", tmp_path)
    out = run_cpu(cell, seconds=2.0)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"ttft_p90_ms", "setup_s"}
    traced = run_cpu(spec.Cell("tiny-dense.shortqa", tmp_path), seconds=2.0,
                     trace=True)
    assert traced["metrics"]["requests_seen.tiny"]["value"] == 6


def test_percentile_is_nearest_rank_and_missing_sorts_last():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile([5.0], 99) == 5.0
    assert math.isnan(stats.percentile([], 50))
    # ten refused of 100: the 90th percentile is the last finite value ...
    with_missing = list(range(1, 91)) + [math.inf] * 10
    assert stats.percentile(with_missing, 90) == 90
    # ... and one more refused makes it missing
    assert stats.percentile(list(range(1, 90)) + [math.inf] * 11, 90) \
        == math.inf


def test_ttft_reader_counts_refused_as_missing():
    cell = spec.Cell("minicpm-2b.docqa")

    class R:
        samples = {"ttft_s": [0.1] * 8 + [math.inf] * 2}
        window_s = 40.0

    R.cell = cell
    read = cell.reader("ttft_p90_ms")
    assert read(R) == (40.0 + cell.traffic["drain_s"]) * 1e3
    R.samples = {"ttft_s": [0.1] * 9 + [math.inf]}
    assert read(R) == pytest.approx(100.0)


def test_rate_and_spread():
    assert stats.rate(8192 * 10, 20.0) == 4096.0
    assert math.isnan(stats.rate(5, 0.0))
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    # exclusive quartiles of five: 92.5 and 107.5
    assert stats.spread([90, 95, 100, 105, 110]) == pytest.approx(0.15)


def test_flash_counts_against_hand_counts():
    fa = spec.Cell("minicpm-2b.docqa").count("flash_attention")
    # B 1, H 2, S 4, D 8, causal: 10 kept pairs a head, 2 products of
    # 2 * 8 operations each -> 2 * 10 * 32 = 640
    assert fa.flops(1, 2, 4, 8) == 640
    assert fa.flops(1, 2, 4, 8, causal=False) == 1024
    # q and out 2*4*8 each, k and v 1*4*8 each (Hkv 1), bf16
    assert fa.nbytes(1, 2, 1, 4, 8) == (64 + 64 + 32 + 32) * 2


def test_model_flops_against_hand_counts():
    mf = spec.Cell("minicpm-2b.docqa").count("model_flops")
    m = {"num_layers": 1, "d_model": 4, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 2, "d_ff": 3, "vocab_size": 10}
    # projections 2*4*2*(4+2)=96, ffn 6*4*3=72, attention 4*2*2*ctx=16 ctx
    assert mf.layer_flops(m, 0) == 168
    assert mf.layer_flops(m, 3) == 168 + 48
    assert mf.head_flops(m) == 80
    # a prefill of 3: contexts 1+2+3, logits at the last token
    assert mf.prefill(m, 3) == 3 * 168 + 16 * 6 + 80
    assert mf.train_step(m, 2, 3) == 3 * 2 * (3 * 168 + 16 * 6 + 3 * 80)
    moe = dict(m, num_experts=4, experts_per_token=2)
    assert mf.layer_flops(moe, 0) == 96 + 2 * 4 * 4 + 2 * 72


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_prints_the_contract_line(name, capsys):
    from portbench.core import report
    out = run_cpu(tiny_cell(name), seconds=2.0)
    assert out["correct"] is True
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(out)[-1] == "checks"
    if name in BENCH_NAMES:
        e2e = {m["name"] for m in spec.Cell(name).metrics(trace=False)}
        assert set(out["metrics"]) == e2e
    assert out["attempted"] > 0 and out["failed"] == 0
    report.emit(out)
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == out
    assert printed.err.strip().splitlines()[-1].startswith("check ")


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["repro_torch", "repro_torch.serve"]) == []
    assert guard.forbidden_loaded(["repro.models"]) == ["repro"]
    assert guard.forbidden_loaded(["jaxlib.xla", "numpy"]) == ["jaxlib"]


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src', "
        "sys.argv[1] + '/portbench/tests']\n"
        "import _tiny\n"
        "from portbench.core import guard\n"
        "from portbench.tools import calibrate, sweep\n"
        "for name in ('minicpm-2b.docqa', 'granite-moe-3b.train'):\n"
        "    _tiny.run_cpu(_tiny.tiny_cell(name), seconds=1.0)\n"
        "print(guard.forbidden_loaded())\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_command_refuses_without_a_card(tmp_path):
    """No CUDA card here: exit code other than 0 and no result line; the
    same in a directory holding only BENCHMARK.json and the paths."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                           "--workload", "minicpm-2b.docqa", "--seed",
                           str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "minicpm-2b.docqa", "--seed", "1", "--seconds",
                           "1", "--trace", "0"], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_every_seed_serves_the_same_sizes_at_the_same_times():
    """The seed draws the prompts' ids; sizes, their order and the arrival
    times are the mix's own."""
    from portbench.drivers import serve
    mix = json.loads((ROOT / "portbench/traffic/docqa.json").read_text())
    a = serve.requests(mix, 2 ** 31 + 1, 40, 1000)
    b = serve.requests(mix, 2 ** 31 + 2, 40, 1000)
    assert [len(r["prompt"]) for r in a] == [len(r["prompt"]) for r in b]
    assert [r["answer"] for r in a] == [r["answer"] for r in b]
    assert [r["due"] for r in a] == [r["due"] for r in b]
    assert any((r["prompt"] != q["prompt"]).any() for r, q in zip(a, b))
    assert len({len(r["prompt"]) for r in a[:20]}) > 10    # not sorted
    assert max(r["due"] for r in a) < 40
    assert all(1024 <= len(r["prompt"]) <= 3584 for r in a)


def test_page_pool_peak_is_read_after_each_step():
    """The traced rehearsal reports the pool's peak share; it stays within
    the pool, and matches the counters it is read from."""
    out = run_cpu(tiny_cell("minicpm-2b.docqa"), seconds=2.0, trace=True)
    share = out["metrics"]["pages_peak_share.serve"]["value"]
    assert 0 < share <= 100
    usable = tiny_cell("minicpm-2b.docqa").traffic["engine"]["num_pages"] - 1
    assert round(share * usable / 100) in range(1, usable + 1)
