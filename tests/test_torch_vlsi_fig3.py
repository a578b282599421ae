"""The port's extraction at the paper's Fig. 3 scale on the CPU: the DFF
tile (32 transistors) with 175 agents, 200 cycles of ``run_scan`` equal to
the JAX package's in blackboard, agents and populations; then the Fig. 3
population shape and more agents against the serial oracle (the checks of
tests/test_vlsi.py, on the port alone)."""
import jax
import numpy as np
import torch

from repro.core import agent_model as jam
from repro.core.vlsi import extractor as jx
from repro_torch import prng
from repro_torch.core import agent_model as am
from repro_torch.core.vlsi import extractor, layout, reference

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")


def test_dff_scan_equals_jax():
    """200 cycles from the paper's initial condition (175 finders, seed 0):
    the same blackboard, agents and (200, 7) populations."""
    lay = layout.dff_layout()
    n, steps = 175, 200
    jgrid = jx.make_grid(lay)
    h, w = jgrid.shape[1:]
    ka, kr = jax.random.split(jax.random.PRNGKey(0))
    ja = jam.uniform_random_agents(ka, n, h, w, jx.STATE_SIZE,
                                   init_type=jx.FINDER)
    jg, ja, jdone, jpops = jx.make_extractor(n, (h, w)).run_scan(
        jgrid, ja, kr, steps, done_fn=jx.done_fn, record=True)

    grid = extractor.make_grid(lay, device="cpu")
    ka, kr = prng.split(am.as_key(prng.PRNGKey(0), "cpu"), 2).unbind(0)
    agents = am.uniform_random_agents(ka, n, h, w, extractor.STATE_SIZE,
                                      init_type=extractor.FINDER,
                                      device="cpu")
    g, agents, done, pops = extractor.make_extractor(n, (h, w)).run_scan(
        grid, agents, kr, steps, done_fn=extractor.done_fn, record=True)
    assert done == int(jdone) == steps          # still running at 200
    assert np.array_equal(np.asarray(jpops), pops.numpy())
    assert np.array_equal(np.asarray(jg), g.numpy())
    for f in am.Agents._fields:
        assert np.array_equal(np.asarray(getattr(ja, f)),
                              getattr(agents, f).numpy()), f
    # the paper's early dynamics: 75 finders and 100 labellers at cycle 0
    assert pops[0, extractor.FINDER] + pops[0, extractor.LABELLER] == n
    assert pops[:50, extractor.LABELLER].max() >= pops[0, extractor.LABELLER]


def test_population_dynamics_shape():
    """Fig. 3 qualitative shape: finder crash, labeller spike, propagator
    steady state (NAND, 96 agents, seed 0)."""
    lay = layout.nand_layout()
    _, steps, pops, _ = extractor.run_extraction(lay, n_agents=96, seed=0,
                                                 max_steps=4000, record=True,
                                                 device="cpu")
    assert pops.shape == (4000, 7)
    finders = pops[:, extractor.FINDER]
    labellers = pops[:, extractor.LABELLER]
    props = pops[:, extractor.PROPAGATOR]
    late = min(steps, 3999) - 1
    assert finders[late] < finders[:30].max() / 4
    assert labellers[:50].max() >= labellers[0], "labeller spike missing"
    assert labellers[late] == 0, "labellers must die out"
    assert props[late] == 96, "steady state must be all node propagators"
    assert props[0] < 96 / 2, "propagators cannot dominate at start"
    # the frozen rows repeat the population at completion
    assert (pops[steps:] == pops[steps - 1]).all()


def test_more_agents_do_not_break_correctness():
    lay = layout.nand_layout()
    grid, steps, _, _ = extractor.run_extraction(lay, n_agents=192, seed=0,
                                                 device="cpu")
    assert steps < 4000
    ok, msg = extractor.netlists_equivalent(extractor.harvest(grid, lay),
                                            reference.extract(lay))
    assert ok, msg
