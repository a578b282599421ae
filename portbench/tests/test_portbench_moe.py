"""The expert layer's side of the benchmark on the CPU: the live-row count
of the expert products (``counts/moe_experts.py``) against hand counts, and
each reader of the expert layer's per-layer metrics on a rehearsal of
``granite-moe-3b.train``: a number where the run records the program's
spans and counters, nothing where it records none."""
import contextlib
import math
import time

import pytest

from _tiny import tiny_cell

from portbench.core import spec


def test_expert_counts_against_hand_counts():
    me = spec.Cell("granite-moe-3b.train").count("moe_experts")
    # D 4, F 3, 5 live rows: gate and up 2*4*3 each, down 2*3*4 -> 72 a row
    assert me.flops(4, 3, 5) == 360
    # 5 rows in and out (2 * 5 * 4) and 2 experts' three 4 x 3 matrices,
    # bf16
    assert me.nbytes(4, 3, 2, 5) == (40 + 72) * 2
    assert me.flops(4, 3, 0) == 0


# -- the expert layer's readers on a rehearsal of the MoE cell ----------------
MOE_READERS = ["moe_fwd_ms_p50.train", "experts_roofline.train",
               "router_ms_p50.train", "expert_fill.train",
               "drop_share.train", "load_cv.train"]


class _HostEvent:
    """A CUDA event's stand-in on the CPU, stamped on the host's clock, so
    a rehearsal's spans carry device times for the readers to read."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _moe_rehearsal(record: bool):
    from portbench.core import peaks
    from portbench.drivers import train
    from repro_torch import telemetry
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(telemetry, "_event", lambda device: _HostEvent())
        t0 = time.perf_counter()
        with telemetry.recording() if record else contextlib.nullcontext():
            run = train.run(tiny_cell("granite-moe-3b.train"), 2 ** 31 + 77,
                            1.0, True, "cpu", lambda: time.perf_counter() - t0)
    run.peaks = peaks.peak("NVIDIA H100 80GB HBM3")
    return run


@pytest.fixture(scope="module")
def moe_runs():
    return {"recorded": _moe_rehearsal(True),
            "unrecorded": _moe_rehearsal(False)}


@pytest.mark.parametrize("metric", MOE_READERS)
def test_moe_reader_reads_a_rehearsal_that_records(metric, moe_runs):
    run = moe_runs["recorded"]
    value = run.cell.reader(metric)(run)
    assert value is not None and math.isfinite(value) and value >= 0
    if metric == "expert_fill.train":        # at most T k / (E C) = 80%
        assert 0 < value <= 80
    if metric.endswith("roofline.train") or metric == "drop_share.train":
        assert value < 100


@pytest.mark.parametrize("metric", MOE_READERS)
def test_moe_reader_reads_nothing_where_the_run_records_nothing(metric,
                                                               moe_runs):
    run = moe_runs["unrecorded"]
    assert run.cell.reader(metric)(run) is None
