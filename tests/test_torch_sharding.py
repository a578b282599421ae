"""The port's sharding rules (``repro_torch.dist.sharding``) against the JAX
package's on the CPU: every case of ``tests/test_sharding.py`` on the port,
then the spec trees entry for entry against JAX's — params, train state,
batch and cache, for every arch at smoke size and full size, on the
(16, 16) and (2, 16, 16) production meshes (JAX's as an ``AbstractMesh``,
the port's as axis sizes), with ``fsdp``, ``expert_parallel`` and
``seq_shard`` each on and off — and the one axis-drop policy
(``layers.guard_entry``) on a table of cases against JAX's.
"""
import functools
import itertools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.dist import sharding as jshd
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.configs.base import ParallelConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P
from repro_torch.models import layers, model
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")

MESH11 = {"data": 1, "model": 1}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PCFGS = [dict(fsdp=f, expert_parallel=e, seq_shard=s)
         for f, e, s in itertools.product((True, False), repeat=3)]
META = torch.device("meta")


def _pid(p):
    return "-".join(k for k, v in p.items() if v) or "none"


class TestGuard:
    def test_drops_unknown_and_nondividing_axes(self):
        axes = {"data": 4, "model": 8}
        assert shd._guard(("model", "data"), (16, 8), axes) == P("model", "data")
        assert shd._guard(("model", None), (12, 8), axes) == P(None, None)
        assert shd._guard(("ghost", "data"), (16, 8), axes) == P(None, "data")
        assert shd._guard((("pod", "data"), None), (8, 3), axes) == \
            P(("data",), None)
        assert shd._guard((("pod", "data"), None), (6, 3), axes) == P(None, None)

    def test_guard_is_the_constrain_policy(self):
        assert shd._guard is not layers.guard_entry
        assert shd.guard_entry is layers.guard_entry
        axes = {"data": 4, "model": 8}
        for spec, dim in [("model", 16), ("model", 12), ("ghost", 16),
                          (("pod", "data"), 8), (("pod", "data"), 6),
                          (None, 7)]:
            assert shd._guard((spec,), (dim,), axes) == \
                P(layers.guard_entry(spec, dim, axes))
        assert layers.guard_entry("model", 12, {"model": 0}) == "model"
        assert layers.guard_entry(["pod", "data"], 8, axes) == ("data",)


GUARD_CASES = [(s, d, a) for s in (None, "model", "data", "ghost",
                                   ("pod", "data"), ["pod", "data"],
                                   ("data", "model"), ("pod",))
               for d in (1, 6, 8, 12, 16, 15, 32)
               for a in ({"data": 4, "model": 8}, {"model": 16},
                         {"pod": 2, "data": 16, "model": 16},
                         {"data": 0, "model": 8}, {"model": 0}, {})]


@pytest.mark.parametrize("chunk", range(8))
def test_guard_entry_table_matches_jax(chunk):
    """The shared guard on a table of (spec, dim, axes) cases, size 0
    (unknown) included: the port's entry equals JAX's."""
    for spec, dim, axes in GUARD_CASES[chunk::8]:
        assert layers.guard_entry(spec, dim, axes) == \
            jlayers.guard_entry(spec, dim, axes), (spec, dim, axes)


class TestMeshAxes:
    def test_set_mesh_axes_records_names_and_sizes(self):
        try:
            layers.set_mesh_axes(("data", "model"), (4, 8))
            assert layers._current_axes() == {"data": 4, "model": 8}
            layers.set_mesh_axes(("data", "model"))
            assert layers._current_axes() == {"data": 0, "model": 0}
            x = torch.ones(3, 5)
            assert layers.constrain(x, "data", "model") is x   # plain: no-op
        finally:
            layers.set_mesh_axes(None)
        assert layers._current_axes() == {} and layers._MESH is None


class TestParamLayout:
    def test_dense_policy(self):
        cfg = configs.get_config("smollm-360m").smoke()
        params = model.Model(cfg, None, META)
        sh = shd.param_shardings(params, cfg, MESH11, ParallelConfig())
        assert sh["embed"] == P("model", "data")
        blk = sh["stack"][0][0]
        assert blk["mixer"]["wq"] == P(None, "data", "model")
        assert blk["mixer"]["wo"] == P(None, "model", "data")
        assert blk["mlp"]["w_gate"] == P(None, "data", "model")
        assert blk["mlp"]["w_down"] == P(None, "model", "data")
        assert blk["norm1"]["scale"] == P()
        sh2 = shd.param_shardings(params, cfg, MESH11, ParallelConfig(fsdp=False))
        assert sh2["stack"][0][0]["mixer"]["wq"] == P(None, None, "model")

    def test_moe_expert_parallel_policy(self):
        cfg = configs.get_config("granite-moe-3b-a800m").smoke()
        params = model.Model(cfg, None, META)
        sh = shd.param_shardings(params, cfg, MESH11, ParallelConfig())
        moe = sh["stack"][0][0]["moe"]
        assert moe["w_gate"] == P(None, "model", "data", None)
        assert moe["w_down"] == P(None, "model", "data", None)
        sh2 = shd.param_shardings(params, cfg, MESH11,
                                  ParallelConfig(expert_parallel=False))
        assert sh2["stack"][0][0]["moe"]["w_gate"] == \
            P(None, None, "data", "model")

    def test_train_state_factored_moments_follow_params(self):
        cfg = configs.get_config("smollm-360m").smoke()
        state = _state(cfg, factored=True)
        sh = shd.train_state_shardings(state, cfg, MESH11, ParallelConfig())
        blk = sh.opt.mu["stack"][0][0]
        assert blk["mlp"]["w_down"] == P(None, "model", "data")
        nu = sh.opt.nu["stack"][0][0]["mlp"]["w_down"]
        assert nu["row"] == P(None, "model")
        assert nu["col"] == P(None, "data")
        assert sh.step == P()

    def test_batch_and_cache_policy(self):
        cfg = configs.get_config("smollm-360m").smoke()
        batch = {"tokens": torch.zeros((8, 64), dtype=torch.int32)}
        bs = shd.batch_shardings(batch, MESH11, ParallelConfig())
        assert bs["tokens"] == P(("data",), None)
        bs2 = shd.batch_shardings(batch, MESH11, ParallelConfig(seq_shard=True))
        assert bs2["tokens"] == P(("data",), "model")
        cache = model.init_cache(cfg, 4, 32, META)
        cs = shd.cache_shardings(cache, cfg, MESH11, ParallelConfig())
        assert cs["layers"][0][0]["k"] == P(None, ("data",), None, "model",
                                            None)
        assert cs["pos"] == P()

    def test_placements_of_a_spec(self):
        class Mesh:                 # only the dim names and sizes are read
            mesh_dim_names = ("pod", "data", "model")
            shape = (2, 16, 16)
        from torch.distributed.tensor import Replicate, Shard
        assert layers.placements(P(("pod", "data"), None, "model"), Mesh) == \
            (Shard(0), Shard(0), Shard(2))
        assert layers.placements(P(None, "data"), Mesh) == \
            (Replicate(), Shard(1), Replicate())
        assert layers.placements(P(), Mesh) == (Replicate(),) * 3

        class Host:                 # a 1 x 1 mesh holds every tensor whole
            mesh_dim_names = ("data", "model")
            shape = (1, 1)
        assert layers.placements(P("data", "model"), Host) == \
            (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# spec parity, entry for entry, against the JAX package's trees
# ---------------------------------------------------------------------------
def _state(cfg, factored=False):
    params = model.Model(cfg, None, META)
    return ts.TrainState(
        params=params,
        opt=opt.init_opt_state(model.param_layout(params, cfg),
                               factored=factored),
        router=ts.init_router(cfg, META),
        step=torch.zeros((), dtype=torch.int32, device=META))


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch, smoke, factored):
    cfg = jconfigs.get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    params = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                       cfg))
    state = jax.eval_shape(lambda: jts.init_train_state(
        jax.random.PRNGKey(0), cfg, JTrainConfig(), factored=factored))
    cache = jax.eval_shape(lambda: jmodel.init_cache(cfg, 32, 64))
    return cfg, params, state, cache


def _norm(spec) -> tuple:
    """Entries as JAX's ``PartitionSpec`` compares them: a one-axis tuple
    is that axis."""
    return tuple(e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                 else (tuple(e) if isinstance(e, list) else e) for e in spec)


def _specs_equal(port, jax_tree, where="root"):
    """Walk the port's spec tree beside JAX's NamedSharding tree."""
    if isinstance(port, P):
        spec = jax_tree.spec if hasattr(jax_tree, "spec") else jax_tree
        assert _norm(port) == _norm(spec), f"{where}: {port} != {spec}"
        return 1
    if port is None:
        assert jax_tree is None, where
        return 0
    if isinstance(port, dict):
        assert sorted(port) == sorted(jax_tree), where
        return sum(_specs_equal(port[k], jax_tree[k], f"{where}/{k}")
                   for k in port)
    assert len(port) == len(jax_tree), where
    return sum(_specs_equal(a, b, f"{where}[{i}]")
               for i, (a, b) in enumerate(zip(port, jax_tree)))


def _check_arch(arch, smoke, mesh_name, pcfg_kw, factored=False):
    shape, names = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, names)
    axes = dict(zip(names, shape))
    jcfg, jparams, jstate, jcache = _jax_abstract(arch, smoke, factored)
    cfg = configs.get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    jp, tp = JParallelConfig(**pcfg_kw), ParallelConfig(**pcfg_kw)
    state = _state(cfg, factored)
    n = _specs_equal(shd.param_shardings(state.params, cfg, axes, tp),
                     jshd.param_shardings(jparams, jcfg, jmesh, jp), "params")
    n += _specs_equal(shd.train_state_shardings(state, cfg, axes, tp),
                      jshd.train_state_shardings(jstate, jcfg, jmesh, jp),
                      "state")
    tcache = model.init_cache(cfg, 32, 64, META)
    n += _specs_equal(shd.cache_shardings(tcache, cfg, axes, tp),
                      jshd.cache_shardings(jcache, jcfg, jmesh, jp), "cache")
    for shp in ("train_4k", "decode_32k"):
        jb = jconfigs.input_specs(jcfg, jconfigs.get_shape(shp))
        tb = configs.input_specs(cfg, configs.get_shape(shp))
        n += _specs_equal(shd.batch_shardings(tb, axes, tp),
                          jshd.batch_shardings(jb, jmesh, jp), shp)
    assert n > 10
    return n


@pytest.mark.parametrize("pcfg", PCFGS, ids=_pid)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_smoke_specs_match_jax(arch, mesh, pcfg):
    _check_arch(arch, True, mesh, pcfg)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_full_size_specs_match_jax(arch, mesh):
    """The published widths, where the 16-way guard keeps most axes."""
    _check_arch(arch, False, mesh, {})


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m",
                                  "mamba2-130m"])
def test_factored_moment_specs_match_jax(arch):
    _check_arch(arch, True, "16x16", {}, factored=True)
    _check_arch(arch, False, "16x16", {}, factored=True)

