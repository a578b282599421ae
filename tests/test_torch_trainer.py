"""The port's trainer (``repro_torch.train.trainer``) on the CPU: training
checkpoints crossing between the packages in both directions, auto-resume
(bitwise after an injected failure), the scheduler's snapshots beside the
train state, and port copies of the JAX package's trainer and end-to-end
tests. Temp files are made inside each test body."""
import dataclasses
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.dist import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import scheduler as ischeduler
from repro_torch.dist import checkpoint as ckpt
from repro_torch.models import model as model_lib
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")


def _tiny(vocab=128, d=32, ff=64):
    return dataclasses.replace(configs.get_config("smollm-360m").smoke(),
                               num_layers=2, d_model=d, num_heads=2,
                               num_kv_heads=1, head_dim=16, d_ff=ff,
                               vocab_size=vocab)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,factored", [("smollm-360m", False),
                                          ("granite-moe-3b-a800m", True),
                                          ("recurrentgemma-9b", False)])
def test_jax_checkpoint_restores_in_the_port(arch, factored):
    """A JAX ``TrainState`` saved by the JAX package (its moments and
    router state filled with random values) restores in the port leaf for
    leaf, bit for bit."""
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = configs.get_config(arch).smoke()
    js = jts.init_train_state(jax.random.PRNGKey(0), jcfg, JTrainConfig(),
                              factored=factored)
    rng = np.random.default_rng(0)

    def fill(x):
        return np.asarray(rng.standard_normal(x.shape), x.dtype) \
            if x.dtype.kind == "f" else np.full(x.shape, 3, x.dtype)

    js = js._replace(opt=jax.tree.map(fill, js.opt),
                     router=jax.tree.map(fill, js.router),
                     step=np.asarray(3, np.int32))
    like = ts.init_train_state(torch.Generator().manual_seed(1), cfg,
                               TrainConfig(), factored=factored, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, js, step=1)
        tree, step = ckpt.restore(d, ts.state_tree(like, cfg))
    assert step == 1 and tree is not None
    state = ts.load_state_tree(like, tree, cfg)
    assert int(state.step) == 3
    got, _ = ckpt.flatten(ts.state_tree(state, cfg))
    want = jax.tree.leaves(js)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if jcfg.num_experts:
        assert state.router.bias.abs().max() > 0


@pytest.mark.parametrize("arch,factored,dtype", [
    ("smollm-360m", False, "float32"),
    ("granite-moe-3b-a800m", True, "float32"),
    ("smollm-360m", False, "bfloat16")])
def test_port_checkpoint_restores_in_jax(arch, factored, dtype):
    """A port ``TrainState`` (bf16 model included) restores in the JAX
    package against its own ``init_train_state``, bit for bit."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(), dtype=dtype)
    cfg = dataclasses.replace(configs.get_config(arch).smoke(), dtype=dtype)
    tt = TrainConfig(warmup_steps=0)
    state = ts.init_train_state(torch.Generator().manual_seed(0), cfg, tt,
                                factored=factored, device="cpu")
    from repro_torch.data import pipeline
    batch, _ = pipeline.sample_batch(cfg, 2, 8,
                                     pipeline.init_data_state("cpu"))
    state, _ = ts.train_step(state, batch, cfg, tt)
    like = jts.init_train_state(jax.random.PRNGKey(1), jcfg,
                                JTrainConfig(), factored=factored)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, ts.state_tree(state, cfg), step=1)
        restored, step = jckpt.restore(d, like)
    assert step == 1 and restored is not None
    got = jax.tree.leaves(restored)
    want, _ = ckpt.flatten(ts.state_tree(state, cfg))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = model_lib.to_numpy(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == b.tobytes()


def test_scalar_leaves_keep_their_shape():
    """A 0-d leaf (the step counters) restores 0-d."""
    state = {"step": torch.tensor(7, dtype=torch.int32),
             "bf": torch.tensor(1.5, dtype=torch.bfloat16)}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, state, step=3)
        back, _ = ckpt.restore(d, state)
        raw, _ = ckpt.restore_raw(d)
    assert back["step"].shape == () and int(back["step"]) == 7
    assert back["bf"].shape == () and back["bf"].dtype == torch.bfloat16
    assert [tuple(t.shape) for t in raw] == [(), ()]


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
class TestTrainerFaultTolerance:
    """Port copies of ``tests/test_train.py::TestTrainerFaultTolerance``."""

    def _mk(self, workdir, **kw):
        tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5,
                           decay_steps=1000)
        return Trainer(cfg=_tiny(), tcfg=tcfg, workdir=workdir, batch=4,
                       seq=32, ckpt_every=10, log_every=5, device="cpu", **kw)

    def test_loss_decreases(self):
        with tempfile.TemporaryDirectory() as d:
            tr = self._mk(d)
            tr.train(40)
        first, last = tr.history[0]["loss"], tr.history[-1]["loss"]
        assert last < first - 0.2, (first, last)

    def test_failure_recovery_is_bitwise_identical(self):
        with tempfile.TemporaryDirectory() as d:
            state_a = self._mk(os.path.join(d, "a")).train(30)
            tr_b = self._mk(os.path.join(d, "b"), failure_at=17)
            with pytest.raises(RuntimeError, match="injected node failure"):
                tr_b.train(30)
            tr_b2 = self._mk(os.path.join(d, "b"))
            state_b = tr_b2.train(30)
        assert tr_b2.history[0]["step"] == 10
        la, _ = ckpt.flatten(ts.state_tree(state_a, _tiny()))
        lb, _ = ckpt.flatten(ts.state_tree(state_b, _tiny()))
        assert len(la) == len(lb)
        assert all(torch.equal(a, b) for a, b in zip(la, lb))


def test_trainer_resumes_a_jax_run_and_matches_it():
    """A run checkpointed by the JAX trainer resumes in the port's from its
    step, and the two trainers' losses at that step agree within 1e-5."""
    from repro.train.trainer import Trainer as JTrainer
    kw = dict(learning_rate=3e-3, warmup_steps=2, decay_steps=100)
    jcfg = dataclasses.replace(jconfigs.get_config("smollm-360m").smoke(),
                               num_layers=2, d_model=32, num_heads=2,
                               num_kv_heads=1, head_dim=16, d_ff=64,
                               vocab_size=128)
    with tempfile.TemporaryDirectory() as d:
        jt = JTrainer(cfg=jcfg, tcfg=JTrainConfig(**kw), workdir=d, batch=4,
                      seq=16, ckpt_every=4, log_every=1)
        jt.train(6)
        tr = Trainer(cfg=_tiny(), tcfg=TrainConfig(**kw), workdir=d,
                     batch=4, seq=16, ckpt_every=4, log_every=1,
                     device="cpu")
        _, step = tr.init_or_restore()
        assert step == 6
        tr.train(7)
        jt2 = JTrainer(cfg=jcfg, tcfg=JTrainConfig(**kw),
                       workdir=os.path.join(d, "jax"), batch=4, seq=16,
                       ckpt_every=100, log_every=1)
        jt2.train(7)
    assert tr.history[0]["step"] == 6
    assert abs(tr.history[0]["loss"] - jt2.history[6]["loss"]) <= 1e-5


def test_step_label_disagreement_trusts_the_state_leaf(caplog):
    cfg = _tiny()
    tcfg = TrainConfig(warmup_steps=0)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg=cfg, tcfg=tcfg, workdir=d, batch=2, seq=8,
                     ckpt_every=3, device="cpu")
        state = tr.train(3)
        ckpt.save(d, ts.state_tree(state, cfg), step=9)   # label != leaf
        tr2 = Trainer(cfg=cfg, tcfg=tcfg, workdir=d, batch=2, seq=8,
                      device="cpu")
        _, step = tr2.init_or_restore()
    assert step == 3
    assert "resuming from the state leaf" in caplog.text


def test_scheduler_snapshot_falls_back_to_an_older_one():
    """The scheduler restore takes the snapshot of the train state's step,
    failing that the newest one not newer."""
    cfg = _tiny()
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg=cfg, tcfg=TrainConfig(), workdir=d, batch=2, seq=8,
                     ckpt_every=2, num_workers=3, device="cpu",
                     heartbeats=lambda s, t: np.array([1.0, 2.0, 3.0],
                                                      np.float32))
        tr.train(4)
        with open(os.path.join(d, "sched", "step_00000004",
                               "leaf_00000.npy"), "wb") as f:
            f.write(b"garbage")
        tr2 = Trainer(cfg=cfg, tcfg=TrainConfig(), workdir=d, batch=2, seq=8,
                      num_workers=3, device="cpu")
        _, step = tr2.init_or_restore()
        sched2, _ = ckpt.restore(os.path.join(d, "sched"), tr2.scheduler,
                                 step=2)
    assert step == 4
    assert torch.equal(tr2.scheduler.mem, sched2.mem)
    assert not torch.equal(tr2.scheduler.mem, torch.ones(3))


def test_num_workers_defaults_to_the_world_size():
    tr = Trainer(cfg=_tiny(), tcfg=TrainConfig(), workdir="unused",
                 device="cpu")
    assert tr.num_workers == 1 and tuple(tr.worker_fracs().shape) == (1,)
    assert Trainer(cfg=_tiny(), tcfg=TrainConfig(), workdir="unused",
                   num_workers=4, device="cpu").worker_fracs().sum() == \
        pytest.approx(1.0)


# ---------------------------------------------------------------------------
# port copies of tests/test_system.py's training tests
# ---------------------------------------------------------------------------
def test_end_to_end_training_learns_bigram_structure():
    """The corpus is a 4-way bigram chain: optimal loss ~= ln(4), uniform
    init ~= ln(vocab). A tiny model must close most of that gap."""
    cfg = dataclasses.replace(_tiny(vocab=64, d=64, ff=128), num_heads=4,
                              num_kv_heads=2)
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=10, decay_steps=5000)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg=cfg, tcfg=tcfg, workdir=d, batch=8, seq=64,
                     ckpt_every=1000, log_every=20, device="cpu")
        tr.train(150)
    final = tr.history[-1]["loss"]
    assert final < 0.5 * np.log(64) + 0.5 * np.log(4), final


def test_moe_end_to_end_with_immune_balancing():
    cfg = configs.get_config("granite-moe-3b-a800m").smoke()
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, decay_steps=5000)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg=cfg, tcfg=tcfg, workdir=d, batch=4, seq=32,
                     ckpt_every=1000, log_every=10, device="cpu")
        tr.train(60)
    assert tr.history[-1]["loss"] < tr.history[0]["loss"] - 0.2
    assert tr.history[-1]["load_cv"] < 2.0


def test_anergy_checkpoint_restore_revival_loop():
    """A worker stops heartbeating and is anergized; the run crashes and
    auto-resumes from the checkpoint with the scheduler's memory, so the
    dead worker stays excluded; its returning heartbeat revives it."""
    cfg = _tiny()
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, decay_steps=1000)
    scfg = ischeduler.SchedulerConfig(mem_decay=0.5, anergy_floor=0.1,
                                      revival_steps=3)
    dead = 2

    def heartbeats(step, tput):
        hb = np.ones((4,), np.float32)
        if step >= 3:
            hb[dead] = 0.0
        return hb

    with tempfile.TemporaryDirectory() as d:
        def mk(**kw):
            return Trainer(cfg=cfg, tcfg=tcfg, workdir=d, batch=4, seq=32,
                           ckpt_every=10, log_every=5, num_workers=4,
                           scfg=scfg, device="cpu", **kw)

        tr = mk(heartbeats=heartbeats, failure_at=13)
        with pytest.raises(RuntimeError, match="injected node failure"):
            tr.train(30)
        assert bool(tr.scheduler.anergic[dead]), "worker never anergized"
        assert float(tr.scheduler.frac[dead]) == 0.0
        tr2 = mk(heartbeats=lambda step, tput: np.ones((4,), np.float32))
        _, step = tr2.init_or_restore()
        assert step == 10
        assert bool(tr2.scheduler.anergic[dead]), \
            "anergy verdict lost across checkpoint restore"
        tr2.train(30)
    assert not bool(tr2.scheduler.anergic[dead]), "worker never revived"
    assert float(tr2.scheduler.frac[dead]) > 0.05
    assert tr2.history[-1]["anergic_workers"] == 0
