"""The port's checkpoints (``repro_torch.dist.checkpoint``) against the JAX
package's ``repro.dist.checkpoint``, on the CPU.

The format is shared: a checkpoint written by either package restores in
the other, bf16 leaves included (written as their raw 16-bit patterns under
the same ``.npy`` header, restored bit for bit), and leaves go in
``jax.tree.leaves`` order, so a dict whose keys were inserted unsorted
restores each leaf to its own key. Then the JAX package's semantics on the
port alone: atomic rename with a directory fsync after it, newest-first
fallback past corrupt or mismatched checkpoints, ``.tmp`` sweeps and
``.old`` recovery, retention, pinned steps and manifest-driven raw restore.
"""
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import checkpoint as jckpt
from repro_torch.dist import checkpoint as ckpt

jax.config.update("jax_platform_name", "cpu")

DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16),
          ("int32", torch.int32, jnp.int32),
          ("uint8", torch.uint8, jnp.uint8),
          ("bool", torch.bool, jnp.bool_)]


class Pair(NamedTuple):
    first: object
    second: object


def _values(name, shape, seed):
    rng = np.random.default_rng(seed)
    if name == "bool":
        return rng.random(shape) < 0.5
    if name in ("int32", "uint8"):
        return rng.integers(0, 200, size=shape).astype(name)
    return rng.standard_normal(shape).astype(np.float32)


def _torch(vals, tdt):
    return torch.as_tensor(vals).to(tdt)


def _jax(vals, jdt):
    return jnp.asarray(vals).astype(jdt)


def _bits(t: torch.Tensor) -> np.ndarray:
    """Exact comparison form of a leaf (bf16 as its 16-bit patterns)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tree(make, seed=0):
    """Nested state with unsorted dict keys, a NamedTuple, a list, a tuple
    and a None — every container ``jax.tree.leaves`` knows."""
    return {"zeta": make((2, 3), seed), "alpha": [make((4,), seed + 1),
                                                 None, make((1, 2), seed + 2)],
            "mid": Pair(make((3,), seed + 3), (make((2, 2), seed + 4),)),
            "beta": {"y": make((5,), seed + 5), "x": make((2,), seed + 6)}}


class TestFlatten:
    def test_leaf_order_is_jax_tree_leaves_order(self):
        tree = _tree(lambda shape, s: np.full(shape, s, np.float32))
        ours, treedef = ckpt.flatten(tree)
        ref = jax.tree.leaves(tree)
        assert [float(x.flat[0]) for x in ours] == \
            [float(x.flat[0]) for x in ref]
        back = ckpt.unflatten(treedef, ours)
        assert list(back) == sorted(tree) and back["mid"].second[0] is \
            tree["mid"].second[0] and back["alpha"][1] is None


class TestRoundTrip:
    @pytest.mark.parametrize("name,tdt,jdt", DTYPES)
    def test_port_round_trip(self, tmp_path, name, tdt, jdt):
        state = _tree(lambda shape, s: _torch(_values(name, shape, s), tdt))
        d = str(tmp_path / "ck")
        ckpt.save(d, state, step=3)
        like = _tree(lambda shape, s: torch.zeros(shape, dtype=tdt), 9)
        got, step = ckpt.restore(d, like)
        assert step == 3
        for a, b in zip(ckpt.flatten(state)[0], ckpt.flatten(got)[0]):
            assert b.dtype == tdt and np.array_equal(_bits(a), _bits(b))
        assert got["beta"]["y"].shape == (5,) and got["alpha"][1] is None

    @pytest.mark.parametrize("name,tdt,jdt", DTYPES)
    def test_port_checkpoint_restores_in_jax(self, tmp_path, name, tdt, jdt):
        state = _tree(lambda shape, s: _torch(_values(name, shape, s), tdt))
        d = str(tmp_path / "ck")
        ckpt.save(d, state, step=4)
        like = _tree(lambda shape, s: jnp.zeros(shape, jdt))
        got, step = jckpt.restore(d, like)
        assert step == 4
        for a, b in zip(ckpt.flatten(state)[0], jax.tree.leaves(got)):
            assert np.asarray(b).dtype.name == name
            assert np.array_equal(_bits(a), _jbits(b))

    @pytest.mark.parametrize("name,tdt,jdt", DTYPES)
    def test_jax_checkpoint_restores_in_port(self, tmp_path, name, tdt, jdt):
        state = _tree(lambda shape, s: _jax(_values(name, shape, s), jdt))
        d = str(tmp_path / "ck")
        jckpt.save(d, state, step=5)
        like = _tree(lambda shape, s: torch.zeros(shape, dtype=tdt))
        got, step = ckpt.restore(d, like)
        assert step == 5
        for a, b in zip(jax.tree.leaves(state), ckpt.flatten(got)[0]):
            assert b.dtype == tdt and np.array_equal(_jbits(a), _bits(b))

    @pytest.mark.parametrize("name,tdt,jdt", DTYPES)
    def test_leaf_files_are_byte_identical(self, tmp_path, name, tdt, jdt):
        vals = _values(name, (3, 4), 7)
        ckpt.save(str(tmp_path / "a"), [_torch(vals, tdt)], step=1)
        jckpt.save(str(tmp_path / "b"), [_jax(vals, jdt)], step=1)
        for f in ("leaf_00000.npy", "manifest.json"):
            assert (tmp_path / "a" / "step_00000001" / f).read_bytes() == \
                (tmp_path / "b" / "step_00000001" / f).read_bytes(), f

    def test_unsorted_insertion_restores_each_key(self, tmp_path):
        """Same-shaped leaves under keys inserted out of order: each comes
        back under its own key, in both directions."""
        state = {"b": torch.full((2,), 2.0), "a": torch.full((2,), 1.0),
                 "c": torch.full((2,), 3.0)}
        d = str(tmp_path / "ck")
        ckpt.save(d, state, step=1)
        like = {"c": torch.zeros(2), "a": torch.zeros(2), "b": torch.zeros(2)}
        got, _ = ckpt.restore(d, like)
        assert {k: float(v[0]) for k, v in got.items()} == \
            {"a": 1.0, "b": 2.0, "c": 3.0}
        jgot, _ = jckpt.restore(d, {"a": jnp.zeros(2), "c": jnp.zeros(2),
                                    "b": jnp.zeros(2)})
        assert {k: float(v[0]) for k, v in jgot.items()} == \
            {"a": 1.0, "b": 2.0, "c": 3.0}
        jckpt.save(str(tmp_path / "j"), {"b": jnp.full(2, 2.0),
                                         "a": jnp.full(2, 1.0)}, step=1)
        got, _ = ckpt.restore(str(tmp_path / "j"),
                              {"b": torch.zeros(2), "a": torch.zeros(2)})
        assert (float(got["a"][0]), float(got["b"][0])) == (1.0, 2.0)


class TestSemantics:
    def test_dir_fsync_after_rename(self, tmp_path, monkeypatch):
        events, dirs = [], {}
        real_rename, real_open, real_fsync = os.rename, os.open, os.fsync

        def spy_rename(src, dst):
            events.append(("rename", dst))
            return real_rename(src, dst)

        def spy_open(path, flags, *a, **kw):
            fd = real_open(path, flags, *a, **kw)
            if os.path.isdir(path):
                dirs[fd] = path
            return fd

        def spy_fsync(fd):
            if fd in dirs:
                events.append(("dirsync", dirs[fd]))
            return real_fsync(fd)

        monkeypatch.setattr(os, "rename", spy_rename)
        monkeypatch.setattr(os, "open", spy_open)
        monkeypatch.setattr(os, "fsync", spy_fsync)
        d = str(tmp_path / "ck")
        ckpt.save(d, [torch.arange(4)], step=1)
        renames = [i for i, (k, _) in enumerate(events) if k == "rename"]
        syncs = [i for i, (k, v) in enumerate(events)
                 if k == "dirsync" and v == d]
        assert renames and syncs and max(syncs) > max(renames), events

    @pytest.mark.parametrize("fault", ["garbage_leaf", "torn_manifest",
                                       "wrong_dtype", "wrong_shape"])
    def test_falls_back_past_a_bad_checkpoint(self, tmp_path, fault):
        d = str(tmp_path / "ck")
        ckpt.save(d, {"w": torch.ones(3)}, step=1)
        if fault == "wrong_dtype":
            ckpt.save(d, {"w": torch.ones(3, dtype=torch.int32)}, step=2)
        elif fault == "wrong_shape":
            ckpt.save(d, {"w": torch.ones(4)}, step=2)
        else:
            ckpt.save(d, {"w": torch.full((3,), 2.0)}, step=2)
            name = "leaf_00000.npy" if fault == "garbage_leaf" \
                else "manifest.json"
            with open(os.path.join(d, "step_00000002", name), "wb") as f:
                f.write(b"garbage")
        got, step = ckpt.restore(d, {"w": torch.zeros(3)})
        assert step == 1 and torch.equal(got["w"], torch.ones(3))
        assert ckpt.restore(d, {"w": torch.zeros(3)}, step=2) == (None, 0)
        assert ckpt.restore(str(tmp_path / "none"), {"w": torch.zeros(3)}) \
            == (None, 0)

    def test_tmp_swept_and_old_aside_recovered(self, tmp_path):
        d = str(tmp_path / "ck")
        ckpt.save(d, [torch.ones(2)], step=1)
        os.makedirs(os.path.join(d, "step_00000002.tmp.crash"))
        # a crash between the two renames of a re-save of step 1
        os.rename(os.path.join(d, "step_00000001"),
                  os.path.join(d, "step_00000001.old.crash"))
        assert ckpt.all_steps(d) == []
        got, step = ckpt.restore(d, [torch.zeros(2)])       # read in place
        assert step == 1 and torch.equal(got[0], torch.ones(2))
        ckpt.save(d, [torch.full((2,), 3.0)], step=5)
        assert sorted(os.listdir(d)) == ["step_00000001", "step_00000005"]
        assert ckpt.latest_step(d) == 5

    def test_retention_and_resave(self, tmp_path):
        d = str(tmp_path / "ck")
        for s in range(1, 6):
            ckpt.save(d, [torch.full((2,), float(s))], step=s, keep=2)
        assert ckpt.all_steps(d) == [4, 5]
        ckpt.save(d, [torch.full((2,), 9.0)], step=5, keep=2)
        got, step = ckpt.restore(d, [torch.zeros(2)])
        assert step == 5 and float(got[0][0]) == 9.0
        assert not [n for n in os.listdir(d) if ".old." in n or ".tmp." in n]

    def test_restore_raw_is_manifest_driven(self, tmp_path):
        d = str(tmp_path / "ck")
        leaves = [torch.as_tensor(np.frombuffer(b'{"a":1}', np.uint8).copy()),
                  torch.ones((2, 3)), torch.arange(5),
                  torch.arange(6, dtype=torch.float32).to(torch.bfloat16)]
        ckpt.save(d, leaves, step=7)
        got, step = ckpt.restore_raw(d)
        assert step == 7 and [g.dtype for g in got] == \
            [t.dtype for t in leaves]
        assert all(np.array_equal(_bits(a), _bits(b))
                   for a, b in zip(leaves, got))
        with open(os.path.join(d, "step_00000007", "manifest.json")) as f:
            assert json.load(f)["leaves"][3]["dtype"] == "bfloat16"
        jgot, _ = jckpt.restore_raw(d)
        assert np.array_equal(_jbits(jgot[3]), _bits(leaves[3]))
        assert ckpt.restore_raw(str(tmp_path / "none")) == (None, 0)
