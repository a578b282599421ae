"""Atomic pytree checkpoints in the JAX package's on-disk format (PyTorch port
of ``repro/dist/checkpoint.py``).

Directory layout (one checkpoint per step)::

    <ckpt_dir>/
      step_00000010/
        manifest.json          # {"step": 10, "leaves": [{"shape": ..., "dtype": ...}]}
        leaf_00000.npy         # leaves in flatten() order
        ...

Semantics, as in the JAX package:

  * **Atomicity** — a checkpoint is written into a ``step_XXXXXXXX.tmp.*``
    scratch directory and renamed into place once every leaf and the
    manifest are on disk (the manifest last), then the parent directory is
    fsync'd. A crash mid-save leaves a ``.tmp.*`` directory that ``restore``
    never reads and the next ``save`` sweeps; a crash between the two
    renames of a same-step re-save leaves the only copy in a ``.old.*``
    aside directory, which ``restore`` reads in place and ``save`` renames
    back.
  * **Corruption fallback** — ``restore`` walks checkpoints newest-first and
    returns the first that fully loads and matches ``like``.
  * **Retention** — ``save(..., keep=k)`` prunes all but the newest ``k``.
  * **Leaf order** — :func:`flatten` is ``jax.tree.leaves`` order: dict
    values by sorted key, list / tuple / NamedTuple items in order, ``None``
    no leaf. So one checkpoint restores in either package, and a dict whose
    keys were inserted unsorted still restores each leaf to its own key.
  * **bfloat16 without ml_dtypes** — a bf16 tensor is written as its raw
    16-bit pattern under the same ``.npy`` header the JAX package writes
    (``'<V2'``) and recorded as ``"bfloat16"`` in the manifest; restore views
    the raw buffer back as ``torch.bfloat16``.

Leaves are gathered to the host before writing; ``restore`` puts each leaf
on the device of the corresponding ``like`` tensor (sharding arrives with
the port's distribution slice).
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{8})$")
_MANIFEST = "manifest.json"
_BF16 = "bfloat16"

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# pytree flatten in jax.tree.leaves order
# ---------------------------------------------------------------------------
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)`` in ``jax.tree.leaves`` order: dict values by
    sorted key, list / tuple / NamedTuple items in order, ``None`` holds no
    leaf, anything else is a leaf."""
    leaves: list = []

    def walk(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if _is_namedtuple(node):
            return ("namedtuple", type(node), [walk(v) for v in node])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, [walk(v) for v in node])
        leaves.append(node)
        return ("leaf",)

    treedef = walk(tree)
    return leaves, treedef


def unflatten(treedef: Any, leaves: list) -> Any:
    """Inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "namedtuple":
            return d[1](*[build(c) for c in d[2]])
        items = [build(c) for c in d[1]]
        return items if kind == "list" else tuple(items)

    return build(treedef)


# ---------------------------------------------------------------------------
# leaves on and off the host
# ---------------------------------------------------------------------------
def _dtype_name(x) -> str:
    """The manifest's dtype name of a leaf (numpy's names; bf16 as
    ``"bfloat16"``, as ``ml_dtypes`` names it)."""
    if isinstance(x, torch.Tensor):
        return _BF16 if x.dtype == torch.bfloat16 \
            else str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _host(x) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array (bf16 as its raw uint16 pattern) and its
    manifest dtype name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), _dtype_name(t)
    arr = np.asarray(x)
    return arr, arr.dtype.name


def _write_leaf(f, arr: np.ndarray, dtype: str) -> None:
    if dtype == _BF16:
        # the header the JAX package's np.save writes for an ml_dtypes bf16
        # array, then the raw 16-bit patterns
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())
    else:
        np.save(f, arr, allow_pickle=False)


def _read_leaf(path: str, entry: dict) -> torch.Tensor:
    """One leaf file as a host tensor of the manifest's dtype and shape."""
    raw = np.load(path, allow_pickle=False)
    dtype = entry["dtype"]
    if tuple(raw.shape) != tuple(entry["shape"]):
        raise ValueError(f"{os.path.basename(path)}: shape {raw.shape} != "
                         f"manifest {entry['shape']}")
    if dtype == _BF16:
        if raw.dtype.itemsize != 2:
            raise ValueError(f"{os.path.basename(path)}: {raw.dtype} is not "
                             f"a 16-bit buffer")
        # np.array, not np.ascontiguousarray: the latter makes a 0-d leaf
        # (a step counter) 1-d
        return torch.from_numpy(
            np.array(raw, order="C").view(np.int16)).view(torch.bfloat16)
    if raw.dtype != np.dtype(dtype):
        raw = raw.view(np.dtype(dtype))
    return torch.from_numpy(np.array(raw, order="C"))


# ---------------------------------------------------------------------------
# directories
# ---------------------------------------------------------------------------
def _fsync_dir(path: str) -> None:
    """fsync a directory: durably commit the rename that just landed in it
    (best effort on filesystems that refuse directory fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _leaf_file(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def all_steps(ckpt_dir: str) -> list[int]:
    """Sorted steps with a (structurally) complete checkpoint directory. A
    checkpoint orphaned in a ``.old.`` aside directory is not listed."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.isfile(os.path.join(ckpt_dir, name, _MANIFEST)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def save(ckpt_dir: str, state: Any, step: int, keep: Optional[int] = None) -> str:
    """Write ``state`` as ``<ckpt_dir>/step_XXXXXXXX``; returns the final
    path. Atomic (temp dir + rename + directory fsync); an existing
    checkpoint at the same step is replaced; ``keep`` prunes to the newest
    ``keep`` checkpoints, counted from ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _sweep_tmp(ckpt_dir)
    leaves, _ = flatten(state)
    host = [_host(x) for x in leaves]

    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp.", dir=ckpt_dir)
    try:
        manifest = {"step": int(step), "leaves": []}
        for i, (arr, dtype) in enumerate(host):
            manifest["leaves"].append({"shape": list(arr.shape),
                                       "dtype": dtype})
            with open(os.path.join(tmp, _leaf_file(i)), "wb") as f:
                _write_leaf(f, arr, dtype)
                f.flush()
                os.fsync(f.fileno())
        # the manifest is written last: its presence marks the leaves complete
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = _step_dir(ckpt_dir, step)
        # re-saving a step: move the old copy aside before the rename, so no
        # instant holds zero valid copies of this step
        aside = None
        if os.path.isdir(final):
            aside = tempfile.mkdtemp(prefix=f"step_{step:08d}.old.",
                                     dir=ckpt_dir)
            os.rmdir(aside)
            os.rename(final, aside)
        os.rename(tmp, final)
        _fsync_dir(ckpt_dir)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    if keep is not None and keep > 0:
        # prune relative to the step just written, not the newest on disk: a
        # corrupt newer checkpoint must never get the good ones deleted
        older = [s for s in all_steps(ckpt_dir) if s < step]
        for old in older[:max(0, len(older) - (keep - 1))]:
            shutil.rmtree(_step_dir(ckpt_dir, old), ignore_errors=True)
    return final


def restore(ckpt_dir: str, like: Any,
            step: Optional[int] = None) -> tuple[Any, int]:
    """Restore the newest checkpoint that loads cleanly against ``like``,
    which supplies the tree structure and each leaf's shape and dtype (a
    dtype change is a mismatch, not a cast); each leaf lands on its ``like``
    tensor's device (host otherwise). Returns ``(state, step)``, or ``(None,
    0)`` when nothing usable is there. ``step`` pins one checkpoint (no
    fallback)."""
    like_leaves, treedef = flatten(like)
    dirs = _candidate_dirs(ckpt_dir)
    candidates = [step] if step is not None else sorted(dirs, reverse=True)
    for s in candidates:
        path = dirs.get(s)
        if path is None:
            continue
        try:
            leaves = _load_step(path, like_leaves)
        except Exception as e:            # corrupt / torn / mismatched
            log.warning("skipping checkpoint %s: %s: %s",
                        path, type(e).__name__, e)
            continue
        return unflatten(treedef, leaves), s
    if step is None and dirs:
        log.warning("no usable checkpoint among steps %s in %s (all skipped)",
                    sorted(dirs), ckpt_dir)
    return None, 0


def restore_raw(ckpt_dir: str,
                step: Optional[int] = None) -> tuple[Optional[list], int]:
    """Restore the newest checkpoint as a flat list of host tensors, driven by
    its manifest (no ``like`` tree: the serving snapshot's leaf count varies
    run to run). Returns ``(leaves, step)`` or ``(None, 0)``; corrupt
    checkpoints fall back newest-first."""
    dirs = _candidate_dirs(ckpt_dir)
    candidates = [step] if step is not None else sorted(dirs, reverse=True)
    for s in candidates:
        path = dirs.get(s)
        if path is None:
            continue
        try:
            with open(os.path.join(path, _MANIFEST)) as f:
                manifest = json.load(f)
            return [_read_leaf(os.path.join(path, _leaf_file(i)), entry)
                    for i, entry in enumerate(manifest["leaves"])], s
        except Exception as e:
            log.warning("skipping checkpoint %s: %s: %s",
                        path, type(e).__name__, e)
    return None, 0


def _candidate_dirs(ckpt_dir: str) -> dict[int, str]:
    """step -> directory, preferring final ``step_X`` dirs; an orphaned
    ``step_X.old.*`` aside (final dir missing) is readable in place."""
    out: dict[int, str] = {}
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if ".old." not in name:
            continue
        stem = name.split(".old.")[0]
        m = _STEP_RE.match(stem)
        if (m and not os.path.isdir(os.path.join(ckpt_dir, stem))
                and os.path.isfile(os.path.join(ckpt_dir, name, _MANIFEST))):
            out.setdefault(int(m.group(1)), os.path.join(ckpt_dir, name))
    for s in all_steps(ckpt_dir):
        out[s] = _step_dir(ckpt_dir, s)
    return out


def _load_step(step_dir: str, like_leaves: list) -> list:
    with open(os.path.join(step_dir, _MANIFEST)) as f:
        entries = json.load(f)["leaves"]
    if len(entries) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(entries)} leaves, expected {len(like_leaves)}")
    out = []
    for i, (entry, like_leaf) in enumerate(zip(entries, like_leaves)):
        t = _read_leaf(os.path.join(step_dir, _leaf_file(i)), entry)
        if tuple(t.shape) != tuple(np.shape(like_leaf)):
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != like "
                             f"{tuple(np.shape(like_leaf))}")
        if entry["dtype"] != _dtype_name(like_leaf):
            raise ValueError(f"leaf {i}: dtype {entry['dtype']} != like "
                             f"{_dtype_name(like_leaf)}")
        out.append(_place_like(t, like_leaf))
    return out


def _place_like(t: torch.Tensor, like_leaf) -> torch.Tensor:
    """A host tensor on the device of ``like_leaf`` (host for a non-tensor)."""
    if isinstance(like_leaf, torch.Tensor):
        return t.to(device=like_leaf.device)
    return t


def _sweep_tmp(ckpt_dir: str) -> None:
    """Clean up after a crash mid-save: drop ``.tmp.`` scratch dirs, and drop
    or recover ``.old.`` aside dirs (a crash between the two renames of a
    same-step re-save leaves the only valid copy aside: put it back)."""
    for name in os.listdir(ckpt_dir):
        stem = name.split(".tmp.")[0] if ".tmp." in name else \
            name.split(".old.")[0] if ".old." in name else None
        if stem is None or not _STEP_RE.match(stem):
            continue
        path = os.path.join(ckpt_dir, name)
        if ".old." in name and not os.path.isdir(os.path.join(ckpt_dir, stem)):
            os.rename(path, os.path.join(ckpt_dir, stem))
            _fsync_dir(ckpt_dir)
        else:
            shutil.rmtree(path, ignore_errors=True)
