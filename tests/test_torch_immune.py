"""The port's immune primitives: the units of tests/test_immune.py on the
PyTorch states, plus trajectories held against the JAX package's on the
same inputs (float32 on both sides: equal to 1e-6, since admission
decisions are taken from these values)."""
import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import immune as jimmune
from repro_torch.core import immune

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")


class TestImmuneMemory:
    def test_ema_converges_to_constant_signal(self):
        mem = immune.ImmuneMemory.create((4,), decay=0.9, device="cpu")
        for _ in range(200):
            mem = mem.update(torch.full((4,), 3.0))
        np.testing.assert_allclose(mem.value.numpy(), 3.0, atol=1e-3)

    @hypothesis.given(decay=st.floats(0.0, 0.99), x=st.floats(-10, 10))
    @hypothesis.example(decay=0.3021891507847941, x=8.626301665806825)
    @hypothesis.settings(deadline=None, max_examples=20)
    def test_ema_bounded_by_signal_range(self, decay, x):
        """Bounded by the signal's float32 value, up to float32 resolution:
        an absolute 1e-6 is finer than one ulp at |x| ~ 8.6 (~9.5e-7), and
        the pinned example lands 1e-6 above float64 x in both packages."""
        mem = immune.ImmuneMemory.create((1,), decay=decay, device="cpu")
        for _ in range(50):
            mem = mem.update([x])
        bound = abs(np.float32(x)) * (1 + 4 * np.finfo(np.float32).eps)
        assert abs(float(mem.value[0])) <= bound

    def test_ema_equals_jax_on_the_pinned_example(self):
        decay, x = 0.3021891507847941, 8.626301665806825
        mem = immune.ImmuneMemory.create((1,), decay=decay, device="cpu")
        jmem = jimmune.ImmuneMemory.create((1,), decay=decay)
        for _ in range(50):
            mem = mem.update([x])
            jmem = jmem.update(jnp.asarray([x], jnp.float32))
        assert float(mem.value[0]) == float(jmem.value[0])

    def test_values_stay_float32(self):
        mem = immune.ImmuneMemory.create((3,), decay=0.8, device="cpu")
        mem = mem.update(np.asarray([1.0, 2.0, 3.0], np.float64))
        assert mem.value.dtype == torch.float32


class TestTwoStageRegulator:
    def test_fast_rise_then_delayed_suppression(self):
        reg = immune.TwoStageRegulator.create(device="cpu")
        state = reg.init(())
        trace = []
        for _ in range(300):
            state = reg.step(state, 1.0)
            trace.append(float(state.response))
        trace = np.asarray(trace)
        peak = trace.argmax()
        assert trace[peak] > trace[-1] * 1.2, "no overshoot-then-suppress"
        assert peak < 150, "rise was not fast"
        assert trace[-1] > 0.1, "suppression killed the response entirely"

    def test_bounded_no_runaway(self):
        reg = immune.TwoStageRegulator.create(self_excite=0.3, device="cpu")
        state = reg.init((8,))
        for _ in range(2000):
            state = reg.step(state, torch.ones(8))
        assert bool(torch.isfinite(state.response).all())
        assert float(state.response.max()) < 1e3

    @hypothesis.given(stim=st.floats(0.0, 5.0))
    @hypothesis.settings(deadline=None, max_examples=15)
    def test_nonnegative_states(self, stim):
        reg = immune.TwoStageRegulator.create(device="cpu")
        state = reg.init(())
        for _ in range(100):
            state = reg.step(state, stim)
        assert float(state.response) >= 0 and float(state.suppressor) >= 0


class TestAnergy:
    def test_uncostimulated_becomes_anergic_and_revives(self):
        gate = immune.AnergyGate.create(onset=0.5, revival=0.5, device="cpu")
        state = gate.init(())
        for _ in range(20):
            state = gate.step(state, stimulus=1.0, costimulus=0.0)
        assert float(state.level) > 0.9
        assert float(gate.gate(state, 1.0)) < 0.1
        for _ in range(20):
            state = gate.step(state, 0.0, 0.0, il2=1.0)
        assert float(state.level) < 0.1

    def test_costimulated_stays_active(self):
        gate = immune.AnergyGate.create(device="cpu")
        state = gate.init(())
        for _ in range(50):
            state = gate.step(state, 1.0, 1.0)
        assert float(state.level) < 1e-6


class TestDominance:
    def test_scatter_max_resolves_conflicts(self):
        grid = torch.zeros((4, 4), dtype=torch.int32)
        out = immune.dominance_scatter_max(grid, torch.tensor([1, 1, 2]),
                                           torch.tensor([1, 1, 3]),
                                           torch.tensor([5, 9, 2]))
        assert int(out[1, 1]) == 9 and int(out[2, 3]) == 2
        assert int(grid.sum()) == 0, "the input grid is left untouched"

    @hypothesis.given(st.lists(st.booleans(), min_size=1, max_size=16))
    @hypothesis.settings(deadline=None, max_examples=25)
    def test_at_most_one_winner(self, claims):
        winners = immune.dominance_resolve(torch.arange(len(claims)),
                                           torch.tensor(claims))
        assert int(winners.sum()) == (1 if any(claims) else 0)
        if any(claims):
            assert bool(winners[max(i for i, c in enumerate(claims) if c)])


class TestLimitCycleDamping:
    def test_ancestor_transitions_damped_others_untouched(self):
        assert float(immune.damp_ancestor_transition(1.0, 2, 2, damping=0.1)) \
            == pytest.approx(0.1)
        assert float(immune.damp_ancestor_transition(1.0, 2, 3, damping=0.1)) \
            == pytest.approx(1.0)

    def test_hysteresis_asymmetric(self):
        assert float(immune.hysteresis(0.0, 1.0, 0.5, 0.1)) \
            == pytest.approx(0.5)
        assert float(immune.hysteresis(1.0, 0.0, 0.5, 0.1)) \
            == pytest.approx(0.9)


class TestAgainstJax:
    """The same input sequences through both packages' states."""

    def test_regulator_and_memory_trajectories(self):
        rng = np.random.default_rng(0)
        stims = rng.uniform(0, 2, size=(200, 3)).astype(np.float32)
        reg, jreg = immune.TwoStageRegulator.create(device="cpu"), \
            jimmune.TwoStageRegulator.create()
        s, js = reg.init((3,)), jreg.init((3,))
        mem = immune.ImmuneMemory.create((3,), decay=0.8, device="cpu")
        jmem = jimmune.ImmuneMemory.create((3,), decay=0.8)
        for x in stims:
            s, js = reg.step(s, torch.as_tensor(x)), jreg.step(js, jnp.asarray(x))
            mem, jmem = mem.update(x), jmem.update(jnp.asarray(x))
            np.testing.assert_allclose(s.response.numpy(),
                                       np.asarray(js.response), rtol=1e-6)
            np.testing.assert_allclose(s.suppressor.numpy(),
                                       np.asarray(js.suppressor), rtol=1e-6)
        np.testing.assert_allclose(mem.value.numpy(), np.asarray(jmem.value),
                                   rtol=1e-6)

    def test_anergy_trajectory(self):
        rng = np.random.default_rng(1)
        gate = immune.AnergyGate.create(onset=0.34, revival=0.3, device="cpu")
        jgate = jimmune.AnergyGate.create(onset=0.34, revival=0.3)
        s, js = gate.init((4,)), jgate.init((4,))
        for _ in range(100):
            stim = (rng.random(4) < 0.6).astype(np.float32)
            co = (rng.random(4) < 0.3).astype(np.float32)
            il2 = float(rng.random() < 0.2)
            s = gate.step(s, stim, co, il2=il2)
            js = jgate.step(js, jnp.asarray(stim), jnp.asarray(co), il2=il2)
            np.testing.assert_allclose(s.level.numpy(), np.asarray(js.level),
                                       atol=1e-6)
