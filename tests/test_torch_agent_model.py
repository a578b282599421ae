"""The port's generic MIMD agent framework against the JAX package's on the
CPU: dominance writes, presence channels, the scan and its freeze, interior
clipping — each on a batched copy of tests/test_agent_model.py's two-type
counting model, equal to the JAX model's outputs bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import agent_model as jam
from repro_torch import prng
from repro_torch.core import agent_model as am

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")


def _jax_count_model():
    """tests/test_agent_model.py's model: type 0 writes its id+1 at its cell
    and converts to type 1 when it reads a value above its own; type 1
    idles."""

    def writer(ctx):
        w = jnp.zeros((2, 4), jnp.int32)
        w = w.at[0].set(jnp.stack([jnp.int32(0), ctx.pos[0], ctx.pos[1],
                                   ctx.agent_id + 1]))
        dominated = ctx.patch[0, 1, 1] > ctx.agent_id + 1
        return jam.AgentUpdate(w, ctx.state,
                               jnp.where(dominated, 1, 0).astype(jnp.int32),
                               jnp.float32(1.0), ctx.pos)

    def idler(ctx):
        return jam.AgentUpdate(jnp.zeros((2, 4), jnp.int32), ctx.state,
                               jnp.int32(1), jnp.float32(1.0), ctx.pos)

    return jam.AgentModel([writer, idler], num_channels=4, state_size=2,
                          writes_cap=2, presence_channel=2)


def _count_model():
    """The same model, each characteristic batched over all N agents."""

    def writer(ctx):
        n = ctx.n_agents
        w = torch.zeros((n, 2, 4), dtype=torch.int32)
        w[:, 0, 1], w[:, 0, 2] = ctx.pos[:, 0], ctx.pos[:, 1]
        w[:, 0, 3] = ctx.agent_id + 1
        dominated = ctx.patch[:, 0, 1, 1] > ctx.agent_id + 1
        return am.AgentUpdate(w, ctx.state,
                              torch.where(dominated, 1, 0).to(torch.int32),
                              torch.ones(n), ctx.pos)

    def idler(ctx):
        n = ctx.n_agents
        return am.AgentUpdate(am.no_writes(n), ctx.state,
                              torch.ones(n, dtype=torch.int32),
                              torch.ones(n), ctx.pos)

    return am.AgentModel([writer, idler], num_channels=4, state_size=2,
                         writes_cap=2, presence_channel=2)


def _same(jgrid, jagents, grid, agents):
    assert np.array_equal(np.asarray(jgrid), grid.numpy())
    for f in am.Agents._fields:
        assert np.array_equal(np.asarray(getattr(jagents, f)),
                              getattr(agents, f).numpy()), f


def _key(k):
    return am.as_key(np.asarray(k), "cpu")


def test_scatter_max_dominance_and_transitions():
    jmodel, model = _jax_count_model(), _count_model()
    jgrid = jnp.zeros((4, 8, 8), jnp.int32)
    # two agents on the same cell: the higher id must win, the loser converts
    ja = jam.Agents(type_id=jnp.zeros(2, jnp.int32),
                    prev_type=jnp.full(2, -1, jnp.int32),
                    pos=jnp.asarray([[3, 3], [3, 3]], jnp.int32),
                    state=jnp.zeros((2, 2), jnp.int32))
    grid, a = torch.as_tensor(np.array(jgrid)), am.agents_from_numpy(
        ja, device="cpu")
    key = jax.random.PRNGKey(0)
    for t in range(2):
        jgrid, ja = jmodel.step(jgrid, ja, key, jnp.int32(t))
        grid, a = model.step(grid, a, _key(key), t)
        _same(jgrid, ja, grid, a)
    assert int(grid[0, 3, 3]) == 2          # max(id 0 + 1, id 1 + 1)
    assert a.type_id.tolist() == [1, 0]     # agent 0 read 2 > 1: dominated
    assert int(a.prev_type[0]) == 0         # ancestor recorded


def test_presence_channels_rebuilt_each_step():
    jmodel, model = _jax_count_model(), _count_model()
    jgrid = jnp.zeros((4, 8, 8), jnp.int32)
    ja = jam.Agents(type_id=jnp.asarray([0, 1], jnp.int32),
                    prev_type=jnp.full(2, -1, jnp.int32),
                    pos=jnp.asarray([[2, 2], [5, 5]], jnp.int32),
                    state=jnp.zeros((2, 2), jnp.int32))
    grid, a = torch.as_tensor(np.array(jgrid)), am.agents_from_numpy(
        ja, device="cpu")
    for t in range(2):
        key = jax.random.PRNGKey(t)
        jgrid, ja = jmodel.step(jgrid, ja, key, jnp.int32(t))
        grid, a = model.step(grid, a, _key(key), t)
        _same(jgrid, ja, grid, a)
        if t == 0:
            assert int(grid[2, 2, 2]) == 1 and int(grid[3, 5, 5]) == 1
    # presence follows the *current* population
    assert int(grid[2 + int(a.type_id[0]), 2, 2]) == 1


def test_run_scan_freezes_after_done():
    jmodel, model = _jax_count_model(), _count_model()
    jgrid = jnp.zeros((4, 8, 8), jnp.int32)
    ja = jam.uniform_random_agents(jax.random.PRNGKey(2), 4, 8, 8, 2)
    a = am.uniform_random_agents(prng.PRNGKey(2), 4, 8, 8, 2, device="cpu")
    _same(jgrid, ja, torch.as_tensor(np.array(jgrid)), a)
    jg, ja, jsteps, jpops = jmodel.run_scan(
        jgrid, ja, jax.random.PRNGKey(3), 10,
        done_fn=lambda g: (g[0] > 0).sum() >= 1, record=True)
    g, a, steps, pops = model.run_scan(
        torch.zeros((4, 8, 8), dtype=torch.int32), a, prng.PRNGKey(3), 10,
        done_fn=lambda g: (g[0] > 0).sum() >= 1, record=True)
    assert steps == int(jsteps) and steps <= 2
    assert pops.shape == (10, 2)
    assert np.array_equal(np.asarray(jpops), pops.numpy())
    _same(jg, ja, g, a)


def test_positions_stay_interior():
    jmodel, model = _jax_count_model(), _count_model()
    jgrid = jnp.zeros((4, 6, 6), jnp.int32)
    ja = jam.uniform_random_agents(jax.random.PRNGKey(4), 16, 6, 6, 2)
    grid = torch.zeros((4, 6, 6), dtype=torch.int32)
    a = am.uniform_random_agents(prng.PRNGKey(4), 16, 6, 6, 2, device="cpu")
    for t in range(5):
        key = jax.random.fold_in(jax.random.PRNGKey(5), t)
        jgrid, ja = jmodel.step(jgrid, ja, key, jnp.int32(t))
        grid, a = model.step(grid, a, _key(key), t)
        _same(jgrid, ja, grid, a)
    assert bool(((a.pos >= 1) & (a.pos <= 4)).all())
