"""The port's VLSI extraction pipeline against the JAX package on the CPU:
the serial oracle's counts, the margin precondition, single extractor steps
from JAX mid-run states bit for bit (one JAX step build, NAND, 64 agents),
random tilings against the serial oracle, and the extraction CLI. Whole NAND runs against JAX:
tests/test_torch_vlsi_runs.py; the DFF tile and the Fig. 3 shape:
tests/test_torch_vlsi_fig3.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent_model as jam
from repro.core.vlsi import extractor as jx
from repro_torch.core import agent_model as am
from repro_torch.core.vlsi import extractor, layout, reference
from repro_torch.launch import vlsi as launch_vlsi

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")

N_AGENTS = 64


class TestOracle:
    def test_nand_netlist(self):
        net = reference.extract(layout.nand_layout())
        assert len(net.fets) == 4
        pfets = [f for f in net.fets if f.pol == "p"]
        nfets = [f for f in net.fets if f.pol == "n"]
        assert len(pfets) == 2 and len(nfets) == 2
        # parallel pull-ups share one node; series pull-downs chain
        assert len({n for f in pfets for n in f.sd}) == 3
        assert len(net.equivs) == 7

    def test_dff_tile_counts(self):
        net = reference.extract(layout.dff_layout())
        assert len(net.fets) == 32
        assert len(net.equivs) == 56

    def test_inverter(self):
        net = reference.extract(layout._with_margin(layout.inverter_cell()))
        assert len(net.fets) == 2
        assert {f.pol for f in net.fets} == {"n", "p"}


class TestMargin:
    def test_make_grid_raises_without_margin(self):
        with pytest.raises(ValueError, match="margin"):
            extractor.make_grid(layout.nand_cell(), device="cpu")

    @pytest.mark.parametrize("edge", ["top", "bottom", "left", "right"])
    def test_make_grid_raises_on_any_edge(self, edge):
        lay = layout.nand_layout()
        r, c = {"top": (0, 5), "bottom": (-1, 5), "left": (5, 0),
                "right": (5, -1)}[edge]
        lay[layout.CONTACT, r, c] = 1
        with pytest.raises(ValueError, match="margin"):
            extractor.make_grid(lay, device="cpu")

    def test_layouts_with_margin_make_the_reference_grid(self):
        lays = [layout.nand_layout(), layout.nand_layout(False),
                layout.dff_layout(),
                layout._with_margin(layout.inverter_cell()),
                layout.random_layout(np.random.default_rng(3), 1, 2)]
        for lay in lays:
            grid = extractor.make_grid(lay, device="cpu")
            assert grid.dtype == torch.int32
            assert np.array_equal(grid.numpy(), np.asarray(jx.make_grid(lay)))


def test_steps_from_jax_mid_run_states_are_bitwise():
    """Step the JAX extractor through 150 cycles of a NAND run; from each
    JAX state (carried across as numpy) one port step equals JAX's next
    state in grid, type, prev_type, pos and state."""
    lay = layout.nand_layout()
    jgrid = jx.make_grid(lay)
    h, w = jgrid.shape[1:]
    jmodel = jx.make_extractor(N_AGENTS, (h, w))
    model = extractor.make_extractor(N_AGENTS, (h, w))
    ja = jam.uniform_random_agents(jax.random.PRNGKey(11), N_AGENTS, h, w,
                                   jx.STATE_SIZE, init_type=jx.FINDER)
    base = jax.random.PRNGKey(12)
    for t in range(150):
        key = jax.random.fold_in(base, t)
        grid = torch.as_tensor(np.array(jgrid))
        agents = am.agents_from_numpy(ja, device="cpu")
        jgrid, ja = jmodel.step(jgrid, ja, key, jnp.int32(t))
        grid, agents = model.step(grid, agents,
                                  am.as_key(np.asarray(key), "cpu"), t)
        assert np.array_equal(np.asarray(jgrid), grid.numpy()), t
        for f in am.Agents._fields:
            assert np.array_equal(np.asarray(getattr(ja, f)),
                                  getattr(agents, f).numpy()), (t, f)
    # the sampled states covered the paper's population phases
    assert set(np.asarray(ja.type_id).tolist()) != {jx.FINDER}


@pytest.mark.parametrize("seed", [3, 7])
def test_random_tiling_extracts_correctly(seed):
    lay = layout.random_layout(np.random.default_rng(seed), rows=1, cols=2)
    grid, steps, _, _ = extractor.run_extraction(lay, n_agents=96, seed=seed,
                                                 max_steps=5000, device="cpu")
    assert steps < 5000
    ok, msg = extractor.netlists_equivalent(extractor.harvest(grid, lay),
                                            reference.extract(lay))
    assert ok, msg


def test_cli_extracts_the_nand_on_cpu(capsys):
    """The CLI's statements and Fig. 3 table; the JAX package's seed-1 run
    takes 267 cycles (tests/test_torch_vlsi_runs.py)."""
    out = launch_vlsi.main(["--layout", "nand", "--agents", "64", "--seed",
                            "1", "--device", "cpu"])
    assert out == {"steps": 267, "equivalent": True, "duplicates": 8,
                   "fets": 4, "equivs": 7}
    text = capsys.readouterr().out
    assert "EQUIVALENT to oracle" in text and "population dynamics" in text
    assert text.count("FET ") == 4 and text.count("Contact: Node") == 7


def test_cli_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        launch_vlsi.main(["--layout", "nand", "--agents", "8"])


def test_done_fn_one_stacked_step_equals_per_plane_form(monkeypatch):
    """The observer steps its four label planes as one stack
    (``grid_step_planes``); with the step taken plane by plane instead,
    ``done_fn`` gives the same answer on a NAND grid mid-run, on the
    converged one, and on the converged one with one label lowered (labels
    all set, but no fixpoint). The stacked step equals the per-plane steps
    on each."""
    from repro_torch.kernels.grid_step import grid_step, grid_step_planes

    def per_plane(labs, conds):
        return torch.stack([grid_step(lab, cond)
                            for lab, cond in zip(labs, conds)])

    lay = layout.nand_layout()
    early, _, _, _ = extractor.run_extraction(lay, N_AGENTS, seed=1,
                                              max_steps=60, device="cpu")
    done, steps, _, _ = extractor.run_extraction(lay, N_AGENTS, seed=1,
                                                 device="cpu")
    assert steps == 267
    lowered = done.copy()
    m1 = extractor.LAB0 + extractor.M1
    r, c = np.argwhere(lowered[m1] > 1)[0]
    lowered[m1, r, c] = 1
    grids = [torch.as_tensor(g) for g in (early, done, lowered)]
    stacked = [extractor.done_fn(g) for g in grids]
    assert stacked == [False, True, False]
    with monkeypatch.context() as m:
        m.setattr(extractor, "grid_step_planes", per_plane)
        assert [extractor.done_fn(g) for g in grids] == stacked
    for g in grids:
        labs = g[extractor.LAB0:extractor.LAB0 + 4]
        conds = (g[[extractor.M1, extractor.M2, extractor.POLY,
                    extractor.DIFF]] > 0).to(torch.int32)
        assert torch.equal(grid_step_planes(labs, conds),
                           per_plane(labs, conds))
