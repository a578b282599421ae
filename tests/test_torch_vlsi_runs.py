"""Whole NAND extraction runs of the port against the JAX package on the
CPU (64 agents, seeds 1 and 2: same cycle count, same final blackboard,
netlists equivalent to the serial oracle), the observer's answer on run
states, and the deduplication check of tests/test_vlsi.py. One JAX
extractor build (NAND, 64 agents) serves the file."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.vlsi import extractor as jx
from repro_torch.core.vlsi import extractor, layout, reference

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")

N_AGENTS = 64


@pytest.fixture(scope="module")
def nand_runs():
    """Whole NAND runs, seeds 1 and 2, in both packages (one JAX build)."""
    lay = layout.nand_layout()
    return {seed: (jx.run_extraction(lay, n_agents=N_AGENTS, seed=seed,
                                     max_steps=4000),
                   extractor.run_extraction(lay, n_agents=N_AGENTS, seed=seed,
                                            max_steps=4000, device="cpu"))
            for seed in (1, 2)}


@pytest.mark.parametrize("seed", [1, 2])
def test_nand_run_equals_jax_and_oracle(nand_runs, seed):
    lay = layout.nand_layout()
    (jgrid, jsteps, _), (grid, steps, pops, agents) = nand_runs[seed]
    assert pops is None and agents.type_id.shape == (N_AGENTS,)
    assert steps == int(jsteps) < 4000
    assert np.array_equal(grid, np.asarray(jgrid))
    ok, msg = extractor.netlists_equivalent(extractor.harvest(grid, lay),
                                            reference.extract(lay))
    assert ok, msg


def test_redundant_statements_are_emitted_and_deduplicated():
    """Paper: multiple contacts between one node pair produce redundant
    equivalence statements; the harvester deduplicates them by region."""
    lay = layout.nand_layout(double_contacts=True)
    grid, steps, _, _ = extractor.run_extraction(lay, n_agents=N_AGENTS,
                                                 seed=0, device="cpu")
    sim = extractor.harvest(grid, lay)
    assert steps < 4000 and sim.duplicates > 0
    # the two disjoint input contacts hit the same (m1, poly) node pairs
    assert len(sim.equivs) < 9
    ok, msg = extractor.netlists_equivalent(sim, reference.extract(lay))
    assert ok, msg


def test_done_fn_equals_jax_on_run_states(nand_runs):
    """The observer's answer (kernel fixpoint step, early return) equals
    JAX's on an unfinished and on a finished blackboard."""
    lay = layout.nand_layout()
    early, _, _, _ = extractor.run_extraction(lay, n_agents=N_AGENTS, seed=1,
                                              max_steps=40, device="cpu")
    done = nand_runs[1][1][0]
    for g in (early, done):
        assert extractor.done_fn(torch.as_tensor(g)) \
            == bool(jx.done_fn(jnp.asarray(g)))
    assert extractor.done_fn(torch.as_tensor(done))
    assert not extractor.done_fn(torch.as_tensor(early))
