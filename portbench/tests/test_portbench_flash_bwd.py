"""The flash backward's roofline share on the CPU: its operations and bytes
against hand counts, and its reader on a made-up trace: the share from the
``flash_bwd*`` calls, nothing where the count of dK / dV launches is not
layers x steps (the parent program's torch route launches none), nothing
without the card's peaks."""
import pytest

from _tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)

from portbench.core import peaks, spec
from portbench.core.trace import Trace

CELL = "minicpm-2b.train"


def test_backward_counts_against_hand_counts():
    fb = spec.Cell(CELL).count("flash_attention_bwd")
    # B 1, H 2, S 4, D 8, causal: 10 kept pairs a head, 4 products of
    # 2 * 8 operations each -> 2 * 10 * 64 = 1280
    assert fb.flops(1, 2, 4, 8) == 1280
    # q, o, dO, dq 2*4*8 each, k, v, dk, dv 1*4*8 each (Hkv 1) in bf16,
    # lse 2*4 fp32
    assert fb.nbytes(1, 2, 1, 4, 8) == (4 * 64 + 4 * 32) * 2 + 4 * 8


class _Run:
    def __init__(self, cell, events, steps=3, with_peaks=True):
        import torch
        self.cell = cell
        self.model = cell.config["model"]
        self.counters = {"steps": steps, "batch": cell.traffic["batch"],
                         "seq": cell.traffic["seq"]}
        self.peaks = peaks.peak("NVIDIA H100 80GB HBM3") if with_peaks \
            else None
        self.trace = Trace(torch, enabled=False)
        self.trace.events = events
        self.trace.busy_s = 1.0


def _backwards(n, ns_each):
    """n backwards of three launches each, ``ns_each`` ns a launch."""
    names = ("void flash_bwd_delta_kernel<64>(...)",
             "void flash_bwd_dkdv_kernel<64>(...)",
             "void flash_bwd_dq_kernel<64>(...)")
    out, t = [], 0
    for _ in range(n):
        for name in names:
            out.append((name, t, t + ns_each))
            t += ns_each + 10
    return out


def test_reader_reads_the_least_time_over_the_backwards_time():
    cell = spec.Cell(CELL)
    read = cell.reader("flash_bwd_roofline.train")
    m, t = cell.config["model"], cell.traffic
    steps = 3
    n = m["num_layers"] * steps
    fb = cell.count("flash_attention_bwd")
    least, _ = peaks.bound_s(
        fb.nbytes(t["batch"], m["num_heads"], m["num_kv_heads"], t["seq"],
                  m["head_dim"]),
        fb.flops(t["batch"], m["num_heads"], t["seq"], m["head_dim"]),
        989e12, 3.35e12)
    # forward launches and other kernels are not read
    events = _backwards(n, 200_000) + [("void flash_mma_kernel<64>()", 0, 9)]
    share = read(_Run(cell, events, steps))
    assert share == pytest.approx(100.0 * n * least / (n * 3 * 200e-6))
    # at the bound itself the share reads 100%
    ns = int(least * 1e9 / 3)
    assert read(_Run(cell, _backwards(n, ns), steps)) == pytest.approx(
        100.0, rel=1e-4)


@pytest.mark.parametrize("events,steps,with_peaks", [
    ([], 3, True),                                  # the torch route
    ("one_short", 3, True),                         # a launch lost
    ("whole", 0, True),                             # no step in the window
    ("whole", 3, False),                            # a card without peaks
])
def test_reader_reads_nothing_where_the_count_is_off(events, steps,
                                                     with_peaks):
    cell = spec.Cell(CELL)
    n = cell.config["model"]["num_layers"] * 3
    ev = events if isinstance(events, list) else \
        {"one_short": _backwards(n, 1000)[:-2],
         "whole": _backwards(n, 1000)}[events]
    assert cell.reader("flash_bwd_roofline.train")(
        _Run(cell, ev, steps, with_peaks)) is None
