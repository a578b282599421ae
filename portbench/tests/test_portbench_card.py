"""On the card (``-m cuda``): the controls and the faults at the cells'
own sizes come out not correct under the committed limits, while the
program on the same seed comes out correct. Each cell: one seed, a short
window for serving (``tools/calibrate.py`` reads them over many)."""
import json

import pytest

from _tiny import ROOT

from portbench.core import spec

pytestmark = pytest.mark.cuda
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at full width")
    return torch


def over(readings: dict, limits: dict) -> list:
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_and_faults_fail_where_the_program_passes(card, name):
    from portbench.tools import calibrate
    cell = spec.Cell(name)
    lim = cell.limits
    if cell.traffic["kind"] == "serve":
        out = calibrate.serve_seed(cell, 2 ** 31 + 901, 8.0, True, "cuda")
        assert out["logit_gap"] <= lim["logit_gap"]
        assert out["control_float8"] > lim["logit_gap"]
        assert out["fault_token_altered"] > lim["logit_gap"]
    else:
        out = calibrate.train_seed(cell, 2 ** 31 + 901, True, "cuda")
        assert not over({k: out[k] for k in lim}, lim)
        assert over(out["control_float8"], lim)
        assert over(out["fault_half_batch"], lim)
