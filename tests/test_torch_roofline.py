"""The port's analytic roofline (``repro_torch.launch.roofline``) against the
JAX package's: every function's result exactly equal (``==``), for every
arch x shape, a few ``ParallelConfig`` s, 256 and 512 chips, and both
optimizer-state layouts."""
import dataclasses

import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.launch import roofline as jroof
from repro_torch import configs
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch import roofline as roof
from repro_torch.models import model as model_lib

torch.set_num_threads(1)

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
PCFGS = [{}, {"fsdp": False}, {"remat": "full"}, {"capacity_factor": 2.0},
         {"seq_shard": True, "expert_parallel": False, "remat": "dots"}]
KINDS = ("attn", "local", "moe", "ssm", "rglru")
RATES = dict(peak_flops=989e12, hbm_bw=3.35e12)


def _counts(arch):
    params = model_lib.Model(configs.get_config(arch), None,
                             torch.device("meta"))
    return (model_lib.param_count(params),
            model_lib.active_param_count(params, configs.get_config(arch)))


@pytest.mark.parametrize("pcfg", PCFGS, ids=lambda p: "-".join(
    f"{k}={v}" for k, v in p.items()) or "default")
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_every_term_equals_jax(arch, pcfg):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jp, tp = JParallelConfig(**pcfg), ParallelConfig(**pcfg)
    n_params, n_active = _counts(arch)
    for kind in KINDS:
        for ctx in (1.0, 2048.0, 16384.5):
            assert roof.layer_flops_per_token(cfg, kind, ctx, tp) == \
                jroof.layer_flops_per_token(jcfg, kind, ctx, jp)
    for opt_dtype in ("float32", "bfloat16"):
        for factored in (False, True):
            assert roof.opt_bytes_per_param(opt_dtype, factored) == \
                jroof.opt_bytes_per_param(opt_dtype, factored)
    for name in SHAPES:
        jshape, shape = jconfigs.get_shape(name), configs.get_shape(name)
        assert roof.step_flops_total(cfg, shape, tp) == \
            jroof.step_flops_total(jcfg, jshape, jp)
        cache = roof.cache_bytes_total(cfg, shape)
        assert cache == jroof.cache_bytes_total(jcfg, jshape)
        for chips in (256, 512):
            for obp in (0.0, 8.0, 4.08):
                assert roof.state_bytes_per_device(
                    cfg, shape, tp, n_params, chips, obp, cache) == \
                    jroof.state_bytes_per_device(
                        jcfg, jshape, jp, n_params, chips, obp, cache)
                assert roof.step_hbm_bytes_per_device(
                    cfg, shape, tp, n_params, n_active, chips, obp, cache) == \
                    jroof.step_hbm_bytes_per_device(
                        jcfg, jshape, jp, n_params, n_active, chips, obp,
                        cache)
            for opt_dtype, factored in (("float32", False),
                                        ("bfloat16", True)):
                got = roof.analytic_terms(cfg, shape, tp, n_params, n_active,
                                          chips, opt_dtype=opt_dtype,
                                          factored=factored, **RATES)
                want = jroof.analytic_terms(jcfg, jshape, jp, n_params,
                                            n_active, chips,
                                            opt_dtype=opt_dtype,
                                            factored=factored, **RATES)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_rates_are_arguments():
    """The port carries no hardware rate of its own: the caller passes
    them (the dry-run passes the H100's)."""
    cfg, shape = configs.get_config("smollm-360m"), configs.get_shape(
        "decode_32k")
    with pytest.raises(TypeError):
        roof.analytic_terms(cfg, shape, ParallelConfig(), 1, 1, 256)
