"""The port's immune straggler scheduler against the JAX package's on the
CPU: ``simulate`` step times on tests/test_scheduler.py's heterogeneous
trace and on the three scenarios of benchmarks/scheduler_bench.py, the
even-count median, and the port's copies of the fleet edge cases (all dead,
single worker, mass revival).

Times agree within a relative 1e-6, not bit for bit: the float32 sums over
the workers (the normalisations of the shares) are taken in another order
than XLA's, which moves the last bit of a share from the first step on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scheduler as jsch
from repro_torch.core import scheduler as sch

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"


def _hetero_trace(t=200, w=8, seed=0, straggler_slow=0.25):
    rng = np.random.default_rng(seed)
    speeds = np.ones((t, w)) + 0.05 * rng.standard_normal((t, w))
    speeds[:, 0] *= straggler_slow          # persistent straggler
    return np.clip(speeds, 1e-3, None).astype(np.float32)


def _bench_scenarios(t=400, w=16, seed=0):
    """benchmarks/scheduler_bench.py's three fleets."""
    rng = np.random.default_rng(seed)
    base = 1.0 + 0.05 * rng.standard_normal((t, w))
    persistent = base.copy()
    persistent[:, 0] *= 0.3
    hiccup = base.copy()
    for s in range(20, t, 60):                 # 5-step transient stalls
        hiccup[s:s + 5, rng.integers(w)] *= 0.2
    death = base.copy()
    death[t // 4: 3 * t // 4, :2] = 0.0        # two nodes die, then recover
    return {name: np.clip(tr, 1e-3, None).astype(np.float32)
            for name, tr in (("persistent_straggler", persistent),
                             ("transient_hiccups", hiccup),
                             ("death_and_recovery", death))}


def _close(trace, static):
    ref = np.asarray(jsch.simulate(jnp.asarray(trace), static=static))
    got = sch.simulate(trace, static=static, device=CPU)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    return got


@pytest.mark.parametrize("slow", [0.25, 1.0])
@pytest.mark.parametrize("static", [False, True])
def test_simulate_equals_jax_on_hetero_trace(slow, static):
    _close(_hetero_trace(straggler_slow=slow), static)


@pytest.mark.parametrize("name", ["persistent_straggler", "transient_hiccups",
                                  "death_and_recovery"])
def test_simulate_equals_jax_on_bench_scenarios(name):
    trace = _bench_scenarios()[name]
    t_imm = float(_close(trace, False).sum())
    t_static = float(_close(trace, True).sum())
    assert t_imm < t_static, (name, t_imm, t_static)


@pytest.mark.parametrize("vals", [
    [1.0, 3.0, np.nan, 2.0, 8.0],           # even live count: mean of 2, 3
    [4.0, np.nan, 1.0],                     # even
    [5.0, 1.0, 2.0],                        # odd
    [np.nan, np.nan],                       # none live
    [2.5],
])
def test_nanmedian_and_nanmax_equal_jax(vals):
    x = np.asarray(vals, np.float32)
    got = sch._nanmedian(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.nanmedian(x)))
    np.testing.assert_array_equal(sch._nanmax(torch.as_tensor(x)).numpy(),
                                  np.asarray(jnp.nanmax(x)))


def test_observe_with_even_live_count_equals_jax():
    """One dead worker in four: three live (odd); two dead: two live (even,
    the median averages the middle pair)."""
    speeds = np.asarray([1.0, 0.6, 0.0, 0.0], np.float32)
    js, st = jsch.init_scheduler(4), sch.init_scheduler(4, device=CPU)
    for _ in range(40):
        js, st = jsch.observe(js, jnp.asarray(speeds)), sch.observe(st, speeds)
    assert np.asarray(js.anergic).tolist() == st.anergic.tolist() \
        == [False, False, True, True]
    np.testing.assert_allclose(st.mem.numpy(), np.asarray(js.mem), rtol=1e-6)
    np.testing.assert_allclose(st.frac.numpy(), np.asarray(js.frac),
                               rtol=1e-6)


def _all_anergic(w: int = 4) -> sch.SchedulerState:
    return sch.init_scheduler(w, device=CPU)._replace(
        anergic=torch.ones((w,), dtype=torch.bool),
        frac=torch.zeros((w,)), mem=torch.zeros((w,)))


class TestFleetEdgeCases:
    def test_all_anergic_step_time_is_inf(self):
        assert float(sch.step_time(_all_anergic(), torch.ones(4))) \
            == float("inf")

    def test_all_anergic_then_one_alive_is_finite(self):
        state = _all_anergic()
        assert not torch.isfinite(sch.step_time(state, torch.full((4,), 2.0)))
        state = state._replace(
            anergic=torch.tensor([False, True, True, True]),
            frac=torch.tensor([1.0, 0.0, 0.0, 0.0]))
        assert torch.isfinite(sch.step_time(state, torch.ones(4)))

    def test_single_worker_fleet(self):
        state = sch.init_scheduler(1, device=CPU)
        for thr in (1.0, 0.5, 0.0, 0.0, 0.0, 1.0):
            state = sch.observe(state, [thr])
            assert not bool(state.anergic[0])
            np.testing.assert_allclose(float(state.frac[0]), 1.0, rtol=1e-6)
        assert float(sch.step_time(state, [2.0])) > 0.0

    def test_mass_simultaneous_revival(self):
        state = _all_anergic(4)
        for _ in range(sch.SchedulerConfig().revival_steps):
            state = sch.observe(state, torch.ones(4))
        assert not bool(state.anergic.any()), "mass revival failed"
        frac = state.frac.numpy()
        assert (frac > 0).all()
        np.testing.assert_allclose(frac.sum(), 1.0, rtol=1e-5)
        np.testing.assert_allclose(frac, 0.25, atol=1e-3)

    def test_dead_worker_anergized_and_revived(self):
        state = sch.init_scheduler(4, device=CPU)
        for _ in range(80):
            state = sch.observe(state, [1.0, 1.0, 1.0, 0.0])
        assert bool(state.anergic[3]) and float(state.frac[3]) == 0.0
        for _ in range(10):
            state = sch.observe(state, torch.ones(4))
        assert not bool(state.anergic[3]), "recovered worker not revived"


def test_simulate_on_empty_trace():
    assert sch.simulate(np.zeros((0, 3), np.float32), device=CPU).shape == (0,)
