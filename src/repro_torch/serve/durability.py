"""Durable serving: write-ahead request journal + crash-consistent snapshots
(PyTorch port of ``repro/serve/durability.py``; the journal and snapshot
formats are the JAX package's, so either package reads the other's files).

Two persistence planes, split by what each is authoritative for:

  * the **write-ahead journal** (:class:`RequestJournal`) owns *requests*:
    every accepted prompt, every emitted token, every terminal outcome, in
    arrival order. Append-only, length-prefixed + CRC-checksummed records,
    fsync'd on a group-commit cadence (accepted-request records are fsync'd
    at once: a request the fleet acknowledged is never lost). On open, a torn
    tail from a crash mid-write is truncated back to the last complete
    record.
  * the **warm snapshot** owns what was *learned* from requests: the pinned
    prefix-cache forest (token keys, adoption-value EMAs, and the pages'
    K/V), per-class ``ImmuneMemory`` cost EMAs, anergy levels, and the
    router's health / retry books, written every ``snapshot_every`` ticks
    through ``dist.checkpoint``'s atomic leaf-per-file machinery, so a
    snapshot is wholly present or wholly absent; taking one only reads
    device state.

Recovery composes the two: ``Router.recover(journal, snapshot)`` replays the
journal's fsync'd prefix — finished rids are reconstructed and not re-run
(exactly-once by journal dedup), unfinished rids re-enter through the
prefill-recompute + token-replay path, so their streams equal an
uninterrupted run's — then imports the snapshot so the pinned cache and the
immune memories resume warm. Tokens emitted after the last group commit are
re-derived: losing an unsynced emit record costs recompute, never
correctness.

:func:`run_durable` is the crash-restart driver: it runs a router fleet
against a trace and, on the ``poweroff`` fleet fault
(``serve.faults.PowerLoss``), drops the fleet, truncates the journal to its
last fsync'd byte (the simulated page-cache loss), builds a fresh fleet,
recovers, and resumes at the plan's ``restart`` tick.

Journal record format (little-endian)::

    +--------+--------+----------------------+
    | u32 len| u32 crc| payload (len bytes)  |   crc = zlib.crc32(payload)
    +--------+--------+----------------------+

Payloads are compact JSON, one of::

    {"t":"s","rid":R,"tokens":[...],"params":{...},"rclass":C,
     "arrival":A,"deadline":D}                      # submitted
    {"t":"e","rid":R,"tok":T}                       # emitted
    {"t":"f","rid":R,"reason":"stop","tick":K}      # finished

Slot-group member records also carry ``"group"`` / ``"lane"`` /
``"group_size"`` and the parent's ``"gn"`` / ``"gbest"`` (n / best_of): what
``Router.recover`` needs to re-register the parent for joint-finish assembly.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional

import numpy as np

from ..dist import checkpoint
from .api import ServeRequest
from .faults import PowerLoss

_HDR = struct.Struct("<II")          # (payload length, crc32(payload))


class RequestJournal:
    """Append-only write-ahead log of request lifecycle records.

    Opening scans any existing file, truncates a torn tail (a record whose
    header, payload, checksum, or JSON is incomplete — the footprint of a
    crash mid-write) back to the last complete record, and folds the
    surviving records into :attr:`state` for ``Router.recover``.

    Durability contract: ``log_submit`` fsyncs immediately (an acknowledged
    request is durable before anything computes on it); ``log_emit`` /
    ``log_finish`` buffer and are fsync'd by :meth:`commit` every
    ``sync_every`` ticks (group commit — one fsync amortized over a tick
    window's records). ``_synced_bytes`` tracks the durable prefix;
    :meth:`simulate_power_loss` truncates the file to it, modeling the
    kernel page cache dying with the machine."""

    def __init__(self, path: str, sync_every: int = 1):
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        self.path = path
        self.sync_every = sync_every
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.state: dict = {}        # rid -> folded record (see _fold)
        self.records = 0             # complete records found at open
        self.truncated_bytes = 0     # torn tail dropped at open
        self._recover_tail()
        self._f = open(path, "ab")
        self._synced_bytes = self._f.tell()
        self._dirty = False
        self._last_commit_tick: Optional[int] = None
        self.appends = 0
        self.syncs = 0
        self.closed = False

    # -- open-time recovery --------------------------------------------------
    def _recover_tail(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            buf = f.read()
        good = 0
        while True:
            if len(buf) - good < _HDR.size:
                break
            length, crc = _HDR.unpack_from(buf, good)
            start, end = good + _HDR.size, good + _HDR.size + length
            if end > len(buf):
                break                            # torn payload
            payload = buf[start:end]
            if zlib.crc32(payload) != crc:
                break                            # torn/corrupt record
            try:
                rec = json.loads(payload)
            except ValueError:
                break
            self._fold(rec)
            self.records += 1
            good = end
        if good < len(buf):
            self.truncated_bytes = len(buf) - good
            with open(self.path, "r+b") as f:
                f.truncate(good)

    def _fold(self, rec: dict) -> None:
        """Fold one journal record into the per-rid recovery state."""
        rid = rec["rid"]
        if rec["t"] == "s":
            self.state.setdefault(rid, {
                "tokens": rec["tokens"], "params": rec["params"],
                "rclass": rec.get("rclass", 0),
                "arrival": rec.get("arrival", 0),
                "deadline": rec.get("deadline"),
                "group": rec.get("group", -1),
                "lane": rec.get("lane", 0),
                "group_size": rec.get("group_size", 1),
                "gn": rec.get("gn", 1), "gbest": rec.get("gbest", 0),
                "out": [], "fin": None, "fin_tick": -1})
        elif rec["t"] == "e":
            if rid in self.state:
                self.state[rid]["out"].append(rec["tok"])
        elif rec["t"] == "f":
            if rid in self.state:
                self.state[rid]["fin"] = rec["reason"]
                self.state[rid]["fin_tick"] = rec.get("tick", -1)

    # -- write path ----------------------------------------------------------
    def _append(self, rec: dict) -> None:
        if self.closed:
            raise ValueError("journal is closed")
        payload = json.dumps(rec, separators=(",", ":")).encode()
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self._dirty = True
        self.appends += 1

    def log_submit(self, req: ServeRequest,
                   parent: Optional[ServeRequest] = None) -> None:
        """Journal an accepted request; fsync'd before returning, so an
        acknowledged rid can never be lost (the 'zero lost rids' half of the
        recovery contract). A slot-group member (``req.group >= 0``) is
        journaled with its group coordinates and the parent's n/best_of, so
        recovery can re-register the parent for joint-finish assembly."""
        p = req.params
        rec = {
            "t": "s", "rid": req.rid,
            "tokens": [int(t) for t in np.asarray(req.tokens).ravel()],
            "params": {"temperature": p.temperature, "top_p": p.top_p,
                       "top_k": p.top_k, "seed": p.seed,
                       "max_new_tokens": p.max_new_tokens,
                       "stop": list(p.stop), "logprobs": p.logprobs,
                       "repetition_penalty": p.repetition_penalty,
                       "presence_penalty": p.presence_penalty,
                       "frequency_penalty": p.frequency_penalty},
            "rclass": req.rclass, "arrival": req.arrival,
            "deadline": req.deadline}
        if req.group >= 0:
            rec["group"] = req.group
            rec["lane"] = req.lane
            rec["group_size"] = req.group_size
            gp = parent.params if parent is not None else p
            rec["gn"] = gp.n
            rec["gbest"] = gp.best_of
        self._append(rec)
        self.sync()

    def log_emit(self, rid: int, tok: int) -> None:
        self._append({"t": "e", "rid": rid, "tok": int(tok)})

    def log_finish(self, rid: int, reason: str, tick: int) -> None:
        self._append({"t": "f", "rid": rid, "reason": reason,
                      "tick": int(tick)})

    def commit(self, tick: int) -> bool:
        """Group commit: fsync the buffered records if ``sync_every`` ticks
        have elapsed since the last sync (always, at cadence 1). Returns
        whether a sync happened."""
        if not self._dirty:
            self._last_commit_tick = tick
            return False
        if (self._last_commit_tick is not None
                and tick - self._last_commit_tick < self.sync_every):
            return False
        self.sync()
        self._last_commit_tick = tick
        return True

    def sync(self) -> None:
        """flush + fsync; everything appended so far becomes durable."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self._synced_bytes = self._f.tell()
        self._dirty = False
        self.syncs += 1

    def close(self) -> None:
        if not self.closed:
            self.sync()
            self._f.close()
            self.closed = True

    def simulate_power_loss(self) -> None:
        """Model the machine dying: buffered + page-cache bytes (everything
        past the last fsync) vanish. The file is truncated to the durable
        prefix and the journal object becomes unusable — reopen the path to
        recover, exactly as a restarted process would."""
        try:
            self._f.close()                # flushes; the truncate below
        except OSError:                    # discards what fsync never covered
            pass
        with open(self.path, "r+b") as f:
            f.truncate(self._synced_bytes)
        self.closed = True

    def stats(self) -> dict:
        return {"records": self.records + self.appends,
                "appends": self.appends, "syncs": self.syncs,
                "synced_bytes": self._synced_bytes,
                "truncated_bytes": self.truncated_bytes,
                "sync_every": self.sync_every}


# ---------------------------------------------------------------------------
# warm snapshots — JSON meta blob + K/V leaves through dist.checkpoint
# ---------------------------------------------------------------------------
def save_snapshot(snapshot_dir: str, step: int, meta: dict, kv: list,
                  keep: int = 2) -> str:
    """Write one warm snapshot: ``meta`` (JSON-able dict — pinned forests,
    immune state, router bookkeeping) serialized into a uint8 leaf, followed
    by the pinned pages' K/V (host tensors), through ``checkpoint.save``'s
    atomic temp-dir + rename + dir-fsync path. ``keep=2`` retains the
    previous snapshot as the fallback ``restore_raw`` walks to on
    corruption."""
    blob = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    return checkpoint.save(snapshot_dir, [blob] + list(kv), step, keep=keep)


def load_snapshot(snapshot_dir: str) -> tuple[Optional[dict], list, int]:
    """Newest loadable snapshot as ``(meta, kv_leaves, step)`` (host
    tensors) — ``(None, [], 0)`` when the directory holds nothing usable.
    Driven by the manifest (``checkpoint.restore_raw``): the leaf count
    varies with how many pages were pinned."""
    leaves, step = checkpoint.restore_raw(snapshot_dir)
    if not leaves:
        return None, [], 0
    meta = json.loads(leaves[0].numpy().tobytes())
    return meta, leaves[1:], step


# ---------------------------------------------------------------------------
# crash-restart driver
# ---------------------------------------------------------------------------
def run_durable(router_factory, requests: list, journal_path: str, *,
                snapshot_dir: Optional[str] = None, snapshot_every: int = 0,
                sync_every: int = 1, max_ticks: int = 10_000,
                max_restarts: int = 8) -> tuple:
    """Drive a fleet through ``requests`` surviving any scripted power loss.

    Each generation: open (and tail-recover) the journal, build a fresh
    fleet via ``router_factory()`` (which must return a ``Router``, injector
    and all — nothing in-process is reused across a power loss), attach
    durability, ``recover`` from the journal + newest snapshot, and run the
    rids the journal has never seen. A ``PowerLoss`` from the fault plan
    truncates the journal to its durable prefix and loops; the next
    generation resumes at the plan's ``restart`` tick (power-loss tick + 1
    when the plan names none). Returns ``(router, stats)`` of the final
    generation; ``stats["restarts"]`` counts the power losses survived.

    A lost fleet is unreachable before the next is built: the caught
    ``PowerLoss`` (whose traceback holds the fleet's frames) is dropped and
    the name cleared, so the old replicas' device pools are freed first and
    peak memory does not grow with each restart."""
    restarts = 0
    resume_tick = 0
    while True:
        journal = RequestJournal(journal_path, sync_every=sync_every)
        router = router_factory()
        router.attach_durability(journal, snapshot_dir=snapshot_dir,
                                 snapshot_every=snapshot_every)
        if journal.state:
            router.recover(journal, snapshot_dir)
        router.tick = max(router.tick, resume_tick)
        fresh = [r for r in requests if r.rid not in journal.state]
        try:
            stats = router.run(fresh, max_ticks=max_ticks)
            journal.close()
            stats["restarts"] = restarts
            return router, stats
        except PowerLoss as pl:
            restarts += 1
            journal.simulate_power_loss()
            if restarts > max_restarts:
                raise
            resume_tick = (pl.restart_tick if pl.restart_tick is not None
                           else pl.tick + 1)
        router = None
