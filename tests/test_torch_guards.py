"""Boundaries of the PyTorch port that no parity test sees.

* The port imports neither JAX nor the JAX package: every ``repro_torch``
  module is imported in a fresh interpreter and ``sys.modules`` is checked,
  and an AST scan finds no such import in the port or in ``chip_smoke.py``.
* ``chip_smoke.py`` has no CPU fallback: without a card it exits non-zero
  and prints no ``"ok": true`` line, in the repository and alone in an
  empty directory.
* Entry points run on ``cuda`` unless the caller asks for the CPU, and the
  serving CLI serves a trace with ``--device cpu``.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import engine

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _port_modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_every_port_module_imports_without_jax_or_reference():
    code = ("import importlib, json, sys\n"
            f"mods = {_port_modules()!r}\n"
            "for m in mods: importlib.import_module(m)\n"
            "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0]"
            f" in {FORBIDDEN!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(_port_modules()) > 20


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: chip_smoke.py would run for real")
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120, cwd=cwd, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


class TestDevices:
    def test_entry_points_default_to_cuda(self):
        import inspect
        from repro_torch.launch.serve import build_parser
        from repro_torch.models import model
        assert inspect.signature(engine.Engine).parameters["device"] \
            .default == "cuda"
        assert inspect.signature(model.init_params).parameters["device"] \
            .default == "cuda"
        assert build_parser().get_default("device") == "cuda"

    def test_cli_refuses_cuda_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        with pytest.raises(SystemExit):
            launch_serve.main(["--arch", "smollm-360m", "--smoke", "--stream"])

    @pytest.mark.parametrize("flag", ["--replicas", "--faults", "--journal",
                                      "--restore"])
    def test_later_slices_rejected(self, flag, capsys):
        with pytest.raises(SystemExit):
            launch_serve.main(["--arch", "smollm-360m", "--smoke", "--stream",
                               "--device", "cpu", flag, "x"])
        assert "not ported yet" in capsys.readouterr().err

    def test_spec_decode_waits_for_slice_2(self):
        """Speculative decoding arrived with slice 2: a spec engine builds
        on the CPU when asked, and still validates its draft depth."""
        from repro_torch import configs
        from repro_torch.models import model
        cfg = configs.get_config("smollm-360m").smoke()
        params = model.init_params(cfg, torch.Generator(), "cpu")
        eng = engine.Engine(params, cfg, engine.EngineConfig(
            spec_decode=2, spec_draft_layers=1), device="cpu")
        assert eng.stats()["spec_decode"] == 2
        assert eng.device == torch.device("cpu")
        with pytest.raises(ValueError, match="spec_draft_layers"):
            engine.Engine(params, cfg, engine.EngineConfig(spec_decode=2),
                          device="cpu")

    def test_kernel_build_needs_nvcc(self, monkeypatch, tmp_path):
        """Nothing is built at import; building here, without the CUDA
        toolkit, raises instead of falling back, and leaves nothing."""
        if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
            pytest.skip("the CUDA toolkit is installed here")
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build()
        assert not (tmp_path / "kernels").exists()
        assert _build.library_path().name.startswith("libreprokernels_")


@pytest.mark.parametrize("trace", ["bursty", "shared-prefix", "contention"])
def test_cli_serves_a_trace_on_cpu(trace, capsys):
    stats = launch_serve.main(["--arch", "smollm-360m", "--smoke", "--stream",
                               "--device", "cpu", "--requests", "6",
                               "--slots", "3", "--trace", trace,
                               "--steps", "8"])
    assert stats["completed"] + stats["shed"] + stats["rejected"] == 6
    assert stats["completed"] >= 1 and stats["attn_backend"] == "kernel"
    assert "completed" in capsys.readouterr().out
