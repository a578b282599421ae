"""Continuous-batching serving engine governed by the paper's immune
primitives, over a paged KV cache with chunked prefill (PyTorch port of
``repro/serve/engine.py``).

The engine keeps a fixed pool of decode **slots** and admits requests
mid-stream; finished sequences retire and their slot is reused. Every tick
runs ONE batched decode step over all slots (inactive lanes compute a
garbage token the host discards, and their K/V writes go to the null page).

Memory plane: each attention layer's K/V is a physical page pool
``(num_pages, page_size, Hkv, D)`` (stacked over depth); page 0 is the
null/trash page. The host-side ``serve.paging.PageAllocator`` maps each
slot's logical pages to physical ones and hands the device a dense
``(num_slots, max_cache // page_size)`` block table per tick, which the
paged-decode kernel walks directly. Admission charges pages under
``"preempt"`` (current footprint; decode growth acquires pages on demand and
preempts the lowest-immune-priority resident when the pool runs dry — the
victim re-prefills and replays its recorded tokens bitwise) or
``"reserve"`` (worst case up front). Prefix sharing (refcounted prompt pages,
copy-on-write forks of a partial last page) and the pinned prefix cache
work as in the reference.

Compute plane: one-shot prefill (``prefill_chunk == 0``, the default) runs
the whole prompt through the flash-attention kernel into a dense batch-of-1
cache and splices it into the slot's pages; chunked prefill
(``prefill_chunk > 0``) lands one chunk per tick straight into the pages
(``prefill_streams > 1`` batches several jobs per call). Decode runs the
paged attention through ``EngineConfig.attn_backend``: ``"kernel"`` (the
CUDA kernels on the card) or ``"torch"`` (the gather oracle); the same switch
picks the MoE expert products (the grouped-matmul kernel or einsums).

Families: attention stacks (dense, MoE) chunk and share prompt prefixes;
SSM stacks chunk a prompt when it and the chunk align to ``ssm_chunk`` (the
slot's recurrent state threads through its cache row between chunks); the
VLM (prefix-LM over a patch prefix that counts toward the prompt's pages)
and the RG-LRU hybrid prefill one-shot. Recurrent and ring-buffer caches
are slot rows: a tick advances only the active slots' rows, retirement
wipes them. Audio lanes decode with zero frames, as the one-shot oracle
does.

MoE (``router_bias``, the (num_layers, E) immune router bias): the decode
tick runs every slot, occupied or not, and expert capacity is contended
across whatever shares the batch, so decode, draft and verify run at a
dropless capacity (``cfg_decode``): a garbage lane never displaces a real
request's token. One-shot prefill keeps the configured capacity — it is a
batch-of-1 call, the same as one-shot ``generate``'s. Chunked prefill is
exact against one-shot prefill only when dropless, so an MoE engine chunks
only at ``capacity_factor * k >= E`` (``Engine._chunkable``).

Self-speculative decoding (``EngineConfig.spec_decode = k > 0``): while every
resident is greedy with no penalties and no logprobs, a tick drafts ``k``
tokens through the first ``spec_draft_layers`` layers of the same weights and
scores them in one batched paged verify step (``serve.spec``); the host
accepts the longest agreeing draft prefix plus the bonus token.

Slot groups (``SamplingParams.n`` / ``best_of`` > 1, ``serve.groups``): a
parent expands into member lanes at ``submit``; lane 0 prefills and
registers the shared prompt, its siblings adopt those pages; a group is
rejected whole, preempted as a unit, cancelled whole on an abnormal exit,
and assembled into one parent output by ``stream()``.

Admission is the immune loop applied to serving — schedule on remembered
cost, not instantaneous load:

  * ``ImmuneMemory``      — EMA of per-class decode cost (slot-ticks);
                            candidates are ordered by remembered cost.
  * ``TwoStageRegulator`` — admission-burst throttle with delayed negative
                            feedback, damping convoys.
  * ``AnergyGate``        — classes that keep blowing their latency budget
                            without co-stimulation are shed; IL-2 revives
                            them when queue pressure drops.

Fleet hooks (``serve.router``): placement telemetry read on the host
(``class_costs``, ``anergy_levels``, ``prefix_affinity``, ``occupancy``),
``evacuate`` for failover, ``drop_device_state`` for a fenced replica, and
the warm-state snapshot (``export_warm_state`` / ``import_warm_state``).

Spans (``repro_torch.telemetry``): ``step`` reads the tracer's switch once
and keeps the answer in ``_tr`` for the helpers beneath it; with recording
off nothing more is read or recorded.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from .. import telemetry
from ..configs.base import ModelConfig
from ..core import immune
from ..models import layers, model, transformer
from . import groups
from . import spec as specdec
from .api import RequestOutput, ServeRequest, spec_for
from .decode import greedy, null_spec, topk_logprobs
from .paging import OutOfPages, PageAllocator, pages_for


class EngineConfig(NamedTuple):
    num_slots: int = 4
    max_cache: int = 96               # per-slot logical KV capacity (tokens)
    policy: str = "immune"            # "immune" | "fifo"
    num_classes: int = 4
    # latency_budget is engine TICKS, compared only against tick latencies; a
    # ServeRequest.deadline is wall-clock SECONDS, compared only against
    # wall-clock latencies (see Engine._slo)
    latency_budget: float = 32.0
    mem_decay: float = 0.8            # cost-memory EMA decay
    reg_threshold: float = 2.0        # admission pauses while response exceeds this
    shed_level: float = 0.5           # anergy level above which a class is shed
    low_pressure: float = 0.5         # queue_len < low_pressure*num_slots -> IL-2
    anergy_onset: float = 0.34
    anergy_revival: float = 0.3
    # -- paged KV plane ------------------------------------------------------
    page_size: int = 16               # tokens per physical page
    num_pages: Optional[int] = None   # pool size incl. the null page; None ->
    #                                   fully provisioned (slots*maxp + 1)
    prefill_chunk: int = 0            # >0: chunked prefill, one chunk per tick
    prefix_sharing: bool = True       # refcounted prompt-prefix page sharing
    attn_backend: str = "kernel"      # "kernel" | "torch"
    prefill_streams: int = 1          # >1: batch that many prefill jobs/tick
    capture_logits: bool = False      # record per-token logits rows
    admission_mode: str = "preempt"   # "preempt" | "reserve"
    pin_pages: int = 0                # persistent prefix-cache budget (pages)
    # -- self-speculative decoding -------------------------------------------
    spec_decode: int = 0              # k: draft tokens proposed per spec tick
    #                                   (0 = off); spec ticks run only on
    #                                   all-greedy resident batches with no
    #                                   penalties/logprobs
    spec_draft_layers: int = 0        # draft depth: leading layers of the
    #                                   same weights; in (0, num_layers)


@dataclass
class _PrefillJob:
    """An in-flight chunked prefill; ``p0`` starts past any shared prefix."""
    req: ServeRequest
    slot: int
    p0: int          # next chunk's first absolute position
    total: int       # padded prompt end (p0 grid aligned to prefill_chunk)
    length: int      # true prompt length
    share: bool = False   # register this prompt's full pages on completion


# ---------------------------------------------------------------------------
# slot-pool steps (the JAX package's jitted helpers; here eager, in place)
# ---------------------------------------------------------------------------
def _prefill_one(params, cfg: ModelConfig, prompts: dict, max_cache: int,
                 attn_backend: str, router_bias):
    """Prefill a batch-of-1 prompt into a fresh dense cache; returns
    (last-position logits, cache) — the first stage of ``decode.generate``."""
    cache = model.init_cache(cfg, 1, max_cache, prompts["tokens"].device)
    return model.prefill(params, cfg, prompts, cache,
                         attn_backend=attn_backend, router_bias=router_bias)


def _seed_token(logits, spec, do_sample: bool) -> torch.Tensor:
    """First emitted token: exact argmax, or the request's sampling lane at
    fold index 0 — the draw one-shot ``decode.generate`` takes first."""
    return model.sample_tokens(logits, spec, 0) if do_sample \
        else greedy(logits)


def _decode_tick(params, cfg: ModelConfig, pool, last, active, table,
                 router_bias, frames, spec, steps_done, pen_counts,
                 attn_backend: str, do_sample: bool, return_logits: bool,
                 return_logprobs: bool, use_penalties: bool,
                 return_topk: int):
    """One token for every slot (occupied or not). Inactive slots advance
    neither position, nor last token, nor slot-row state; their paged writes
    land on the null page. ``frames`` is audio's (S, 1, Fd) decode input.
    Sampling lanes fold each slot's emitted-token count into its key.
    ``ok`` flags lanes whose logits are all finite (the NaN/Inf guard)."""
    batch = {"token": last}
    if cfg.family == "audio":
        batch["frame"] = frames
    logits, new_pool = model.decode_step(params, cfg, batch, pool,
                                         table=table, active=active,
                                         attn_backend=attn_backend,
                                         router_bias=router_bias)
    nxt = model.sample_tokens(logits, spec, steps_done,
                              counts=pen_counts if use_penalties else None) \
        if do_sample else greedy(logits)
    pos = torch.where(active, new_pool["pos"], pool["pos"])
    last = torch.where(active[:, None], nxt, last)
    ok = torch.isfinite(logits).flatten(1).all(dim=1)
    topk = topk_logprobs(logits, return_topk) if return_topk else None
    return (nxt, last, {"layers": new_pool["layers"], "pos": pos}, ok,
            logits if return_logits else None,
            model.chosen_logprob(logits, nxt) if return_logprobs else None,
            topk)


def _tick_spans(tr, name: str, t0: float, t_launch: float, t_wait: float,
                t1: float) -> None:
    """A decode (or spec) tick's span and its launch, read-back and emit
    parts, from the tick's clock readings."""
    tr.begin(name, t=t0)
    tr.add(name + ".launch", t0, t_launch)
    tr.add(name + ".wait", t_launch, t_wait)
    tr.add(name + ".emit", t_wait, t1)
    tr.end(t=t1)


# ---------------------------------------------------------------------------
# immune admission controller
# ---------------------------------------------------------------------------
class ImmuneAdmission:
    """Host-side admission controller over the three immune primitives.

    Per tick: completions feed the cost memory and the anergy
    stimulus/co-stimulus counters; ``end_tick`` advances the regulator (with
    the tick's admissions as stimulus) and the anergy gate (with IL-2
    flowing when queue pressure is low)."""

    def __init__(self, ecfg: EngineConfig):
        self.ecfg = ecfg
        c = ecfg.num_classes
        # host control state: every admission decision reads it on the CPU
        self.memory = immune.ImmuneMemory.create((c,), decay=ecfg.mem_decay,
                                                 device="cpu")
        self.regulator = immune.TwoStageRegulator.create(device="cpu")
        self.reg_state = self.regulator.init(())
        self.gate = immune.AnergyGate.create(onset=ecfg.anergy_onset,
                                             revival=ecfg.anergy_revival,
                                             device="cpu")
        self.anergy = self.gate.init((c,))
        self._blown = np.zeros(c, np.float32)
        self._ok = np.zeros(c, np.float32)

    def remembered_cost(self, rclass: int) -> float:
        return float(self.memory.value[rclass])

    def observe_completion(self, rclass: int, cost: float, latency: float,
                           budget: Optional[float] = None):
        # per-class EMA: observing `value` for the untouched classes leaves
        # them unchanged under decay*v + (1-decay)*obs
        obs = self.memory.value.clone()
        obs[rclass] = cost
        self.memory = self.memory.update(obs)
        if budget is None:
            budget = self.ecfg.latency_budget
        if latency > budget:
            self._blown[rclass] += 1.0
        else:
            self._ok[rclass] += 1.0

    def admissible(self, rclass: int) -> bool:
        return float(self.anergy.level[rclass]) <= self.ecfg.shed_level

    def throttled(self) -> bool:
        return float(self.reg_state.response) > self.ecfg.reg_threshold

    def degrade(self, classes, severity: float):
        """Fleet capacity loss as an immune stress signal (graceful
        degradation): antigen without co-stimulation for ``classes``, scaled
        by ``severity`` (the router's share of dead replicas), drives them
        toward shedding on this replica; once capacity returns the stimulus
        stops and IL-2 revives them, as with ordinary anergy."""
        c = self.ecfg.num_classes
        stim = np.zeros(c, np.float32)
        for k in classes:
            if 0 <= k < c:
                stim[k] = min(max(float(severity), 0.0), 1.0)
        self.anergy = self.gate.step(self.anergy, stimulus=stim,
                                     costimulus=np.zeros(c, np.float32),
                                     il2=0.0)

    def end_tick(self, admitted: int, queue_len: int,
                 queued_demand: np.ndarray, predicted_cost: np.ndarray):
        """Advance the regulator and anergy gate one tick. Anergy stimulus is
        anticipatory: a class with queued demand whose predicted cost already
        exceeds the latency budget will blow its SLO — antigen without
        co-stimulation. In-budget completions are the co-stimulation."""
        stim = admitted / max(self.ecfg.num_slots, 1)
        self.reg_state = self.regulator.step(self.reg_state, stim)
        il2 = 1.0 if queue_len < self.ecfg.low_pressure * self.ecfg.num_slots \
            else 0.0
        will_blow = (queued_demand > 0) & \
            (predicted_cost > self.ecfg.latency_budget)
        self.anergy = self.gate.step(
            self.anergy,
            stimulus=((self._blown > 0) | will_blow).astype(np.float32),
            costimulus=(self._ok > 0).astype(np.float32),
            il2=il2)
        self._blown[:] = 0.0
        self._ok[:] = 0.0

    # -- durability ----------------------------------------------------------
    def export_state(self) -> dict:
        """JSON-able learned state: the per-class cost EMA, the regulator
        populations, the anergy levels and the tick-local SLO counters (the
        JAX package's format). Configuration comes from the EngineConfig."""
        return {"memory": self.memory.value.tolist(),
                "regulator": [x.tolist() for x in self.reg_state],
                "anergy": [x.tolist() for x in self.anergy],
                "blown": self._blown.tolist(), "ok": self._ok.tolist()}

    def import_state(self, d: dict) -> None:
        """Restore :meth:`export_state` output: the memories resume warm."""
        def put(state, vals):
            return type(state)(*[
                torch.as_tensor(np.asarray(v, np.float32)).reshape(x.shape)
                for x, v in zip(state, vals)])
        self.memory = self.memory._replace(
            value=torch.as_tensor(np.asarray(d["memory"], np.float32)))
        self.reg_state = put(self.reg_state, d["regulator"])
        self.anergy = put(self.anergy, d["anergy"])
        self._blown = np.asarray(d["blown"], np.float32)
        self._ok = np.asarray(d["ok"], np.float32)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class Engine:
    """Continuous-batching decode over a paged slot pool with queue admission.
    ``params`` must already live on ``device``; an MoE model needs
    ``router_bias`` (num_layers, E), which is moved there."""

    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig,
                 device="cuda", router_bias=None):
        if ecfg.max_cache % ecfg.page_size:
            raise ValueError(f"max_cache {ecfg.max_cache} must be a multiple "
                             f"of page_size {ecfg.page_size}")
        if ecfg.prefill_chunk and ecfg.max_cache % ecfg.prefill_chunk:
            raise ValueError(f"max_cache {ecfg.max_cache} must be a multiple "
                             f"of prefill_chunk {ecfg.prefill_chunk}")
        layers.check_backend(ecfg.attn_backend)
        if ecfg.admission_mode not in ("preempt", "reserve"):
            raise ValueError(f"unknown admission_mode {ecfg.admission_mode!r}")
        if ecfg.spec_decode < 0:
            raise ValueError(f"spec_decode must be >= 0, got {ecfg.spec_decode}")
        if ecfg.spec_decode and not 0 < ecfg.spec_draft_layers < cfg.num_layers:
            raise ValueError(
                f"spec_draft_layers must be in (0, {cfg.num_layers}), got "
                f"{ecfg.spec_draft_layers}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if params.device != self.device:
            raise ValueError(f"params live on {params.device}, engine device "
                             f"is {self.device}")
        self.params, self.cfg, self.ecfg = params, cfg, ecfg
        self.router_bias = None if router_bias is None else torch.as_tensor(
            router_bias, dtype=torch.float32, device=self.device)
        # MoE: decode, draft and verify at dropless capacity (module doc)
        self.cfg_decode = cfg if not cfg.num_experts else dataclasses.replace(
            cfg, capacity_factor=float(max(cfg.num_experts,
                                           cfg.capacity_factor)))
        s = ecfg.num_slots
        self.maxp = ecfg.max_cache // ecfg.page_size
        num_pages = ecfg.num_pages if ecfg.num_pages is not None \
            else s * self.maxp + 1
        self.alloc = PageAllocator(
            num_pages, ecfg.page_size, s, self.maxp,
            share_prefix=ecfg.prefix_sharing, pin_pages=ecfg.pin_pages,
            num_classes=ecfg.num_classes, pin_decay=ecfg.mem_decay,
            require_reservation=(ecfg.admission_mode == "reserve"))
        self._kinds = set(transformer.layer_kinds(cfg))
        attention_only = self._kinds <= set(transformer.PAGED_KINDS)
        frontend = bool(cfg.frontend_dim or cfg.frontend_tokens)
        # prefix sharing needs a position's K/V to be a pure function of the
        # token prefix and a chunked tail prefill to land only the unshared
        # suffix: text-only attention / dropless-MoE stacks (per request:
        # _sharable)
        self._share_ok = (ecfg.prefix_sharing and ecfg.prefill_chunk > 0
                          and attention_only and not frontend)
        # batched prefill streams need lanes with no slot-row state and no
        # per-position frontend inputs
        self._multi_prefill = (ecfg.prefill_streams > 1 and attention_only
                               and not frontend)
        # self-speculative decoding needs the verify path (attention stacks,
        # no frontend inputs, no slot-row state) and one segment for the
        # truncated-depth draft slice; the per-tick gate in step()
        # additionally requires every resident greedy with no penalties or
        # logprobs
        self._spec_ok = (ecfg.spec_decode > 0 and attention_only
                         and len(transformer.segments(cfg)) == 1
                         and not frontend)
        dev = self.device
        self.pool = model.init_slot_cache_paged(cfg, s, ecfg.max_cache,
                                                num_pages, ecfg.page_size, dev)
        self.last = torch.zeros((s, 1), dtype=torch.int32, device=dev)
        self.active = torch.zeros((s,), dtype=torch.bool, device=dev)
        # audio: every lane decodes with a zero frame (the one-shot oracle's)
        self.frames = (torch.zeros((s, 1, cfg.frontend_dim),
                                   dtype=torch.float32, device=dev)
                       if cfg.family == "audio" else None)
        self.slots: list[Optional[ServeRequest]] = [None] * s
        self.jobs: deque[_PrefillJob] = deque()
        self.pos_host = np.zeros(s, np.int64)      # per-slot next write index
        self.active_host = np.zeros(s, bool)
        # per-slot tokens computed since (re-)admission, seed included — the
        # decode fold_in index; diverges from len(out_tokens) only while a
        # preempted request replays its recorded history
        self.emitted = np.zeros(s, np.int64)
        self.samp_keys = np.zeros((s, 2), np.uint32)
        self.samp_temp = np.zeros((s,), np.float32)
        self.samp_topk = np.zeros((s,), np.int64)
        self.samp_topp = np.ones((s,), np.float32)
        self.samp_rep = np.ones((s,), np.float32)
        self.samp_pres = np.zeros((s,), np.float32)
        self.samp_freq = np.zeros((s,), np.float32)
        # per-slot generated-token counts over the vocab (penalty state)
        self.tok_counts = np.zeros((s, cfg.vocab_size), np.int32)
        self._spec_cache = None
        self._null_spec = null_spec(s, dev)
        self.queue: deque[ServeRequest] = deque()
        self.tick = 0
        self.completed: list[ServeRequest] = []
        self.shed: list[ServeRequest] = []
        self.rejected: list[ServeRequest] = []
        self.corrupted: list[ServeRequest] = []
        self._reported_rejected = 0
        self._reported_shed = 0
        self._reported_corrupted = 0
        self.admission = ImmuneAdmission(ecfg) if ecfg.policy == "immune" \
            else None
        self.mid_stream_admissions = 0
        self.unsubmitted = 0
        self.concurrency_hw = 0
        self.chunked_prefill_chunks = 0
        self.prefill_batch_calls = 0
        self.shared_pages_adopted = 0
        self.prefill_positions_skipped = 0
        self.sharable_prompt_pages = 0
        self.preemptions = 0
        self.preempted_rids: set = set()
        self.replayed_tokens = 0
        self.nowrite_adoptions = 0
        self.prefill_tokens = 0
        self.prefills = 0                  # one-shot prefill calls
        self.decode_ticks = 0              # batched decode steps run
        self.decode_seconds = 0.0          # host clock inside decode steps
        # self-speculative decode telemetry
        self.spec_ticks = 0                # fused draft+verify ticks run
        self.spec_drafted = 0              # draft tokens proposed (k per lane)
        self.spec_accepted = 0             # draft tokens accepted and emitted
        self.spec_emitted = 0              # tokens emitted by spec ticks
        self.spec_seconds = 0.0            # host clock inside spec ticks
        # slot groups: parents submitted here assemble their output here
        self.group_book = groups.GroupBook()
        self.groups_submitted = 0
        # groups whose shared prompt pages are registered (lane 0's prefill
        # landed): sibling lanes defer admission until then, so the prompt's
        # pages are charged once and adopted n-1 times
        self._group_ready: set = set()
        self._admitted_this_tick = 0
        self._decoding_before_admit = False
        self._tr: Optional[telemetry.Session] = None    # this step's, or None

    def _dev(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=self.device)

    # -- queue ---------------------------------------------------------------
    def submit(self, req: ServeRequest):
        """Queue a request. One whose prompt + decode budget can never fit a
        slot is rejected (recorded, counted against goodput), not raised."""
        if self.admission is not None and not 0 <= req.rclass < \
                self.ecfg.num_classes:
            raise ValueError(f"request {req.rid}: rclass {req.rclass} outside "
                             f"[0, {self.ecfg.num_classes})")
        if req.submit_time < 0:
            req.submit_time = time.perf_counter()
        if req.params.group_size > 1 and req.group < 0:
            # slot-group parent: members are identical but for their seeds,
            # so one probe decides the whole group — admitted whole or
            # rejected whole; the parent itself never holds a slot
            members = groups.expand(req)
            probe = members[0]
            need = len(probe.tokens) + self.cfg.frontend_tokens \
                + probe.max_new_tokens
            if need > self.ecfg.max_cache \
                    or self._need_pages(probe) > self.alloc.usable_pages:
                req.finish_reason = "rejected"
                self.rejected.append(req)
                return
            self.groups_submitted += 1
            self.group_book.register(req)
            for m in members:
                m.submit_time = req.submit_time
                self.queue.append(m)
            return
        need = len(req.tokens) + self.cfg.frontend_tokens + req.max_new_tokens
        if need > self.ecfg.max_cache \
                or self._need_pages(req) > self.alloc.usable_pages:
            req.finish_reason = "rejected"
            self.rejected.append(req)
            return
        self.queue.append(req)

    # -- sampling lanes ------------------------------------------------------
    def _pool_spec(self) -> model.SamplingSpec:
        """The pool's per-lane sampling rows (re-uploaded only after an
        admission or retirement changed them)."""
        if self._spec_cache is None:
            self._spec_cache = model.SamplingSpec(
                keys=self._dev(self.samp_keys.astype(np.int64)),
                temperature=self._dev(self.samp_temp),
                top_k=self._dev(self.samp_topk),
                top_p=self._dev(self.samp_topp),
                rep_penalty=self._dev(self.samp_rep),
                pres_penalty=self._dev(self.samp_pres),
                freq_penalty=self._dev(self.samp_freq))
        return self._spec_cache

    def _seed_slot(self, req: ServeRequest, logits) -> torch.Tensor:
        """Draw the request's first token from its prefill logits and bind
        its sampling lane to the slot."""
        p = req.params
        self.samp_keys[req.slot] = p.key()
        self.samp_temp[req.slot] = p.temperature
        self.samp_topk[req.slot] = p.top_k
        self.samp_topp[req.slot] = p.top_p
        self.samp_rep[req.slot] = p.repetition_penalty
        self.samp_pres[req.slot] = p.presence_penalty
        self.samp_freq[req.slot] = p.frequency_penalty
        self.tok_counts[req.slot] = 0
        self._spec_cache = None
        if self.ecfg.capture_logits and not req.out_tokens:
            req.out_logits.append(logits[0, -1].cpu().numpy().copy())
        return _seed_token(logits, spec_for([p], self.device),
                           do_sample=not p.is_greedy)

    def _emit_seed(self, req: ServeRequest, logits, first) -> None:
        """Record the prefill-seeded first token (a resuming request already
        holds it: the re-derived seed is not re-recorded)."""
        tr = self._tr
        if tr is not None:
            tr.begin("prefill.wait")
        tok = int(first[0, 0])
        if tr is not None:
            tr.end()
        if req.params.has_penalties:
            self.tok_counts[req.slot, tok] += 1
        if req.out_tokens:
            self.replayed_tokens += 1
            req.replayed_tokens += 1
            return
        req.out_tokens.append(tok)
        if req.params.logprobs:
            req.out_logprobs.append(
                float(model.chosen_logprob(logits, first)[0, 0]))
            tv, ti = topk_logprobs(logits, req.params.logprobs)
            req.out_topk.append(([int(x) for x in ti[0].cpu()],
                                 [float(x) for x in tv[0].cpu()]))

    # -- paging --------------------------------------------------------------
    def _chunkable(self, req: ServeRequest) -> bool:
        """Chunked prefill only where it is exact against one-shot prefill:
        attention stacks always; MoE only at dropless expert capacity
        (capacity is per call, so a finite capacity factor can drop other
        tokens per chunking): cf * k >= E; SSM when the prompt and the chunk
        align to ``ssm_chunk`` (the state resume keeps the scan's op order);
        the VLM (prefix-LM over the patch prefix) and RG-LRU hybrids (a split
        scan regroups the rounding) prefill one-shot."""
        c = self.ecfg.prefill_chunk
        if not c or self.cfg.frontend_tokens:        # the VLM's prefix
            return False
        kinds = self._kinds
        if "moe" in kinds and self.cfg.capacity_factor \
                * self.cfg.experts_per_token < self.cfg.num_experts:
            return False
        if kinds <= set(transformer.PAGED_KINDS):
            return True
        if kinds == {"ssm"}:
            return len(req.tokens) % c == 0 and c % self.cfg.ssm_chunk == 0
        return False

    def _sharable(self, req: ServeRequest) -> bool:
        """Prefix sharing needs both: K/V a pure function of the token prefix
        (``_share_ok``) and a chunked tail prefill (``_chunkable``)."""
        return self._share_ok and self._chunkable(req)

    def _match(self, req: ServeRequest):
        """Prefix-index match for ``req``, capped so the padded chunk tail
        stays inside ``max_cache``. Returns ``(full_hits, partial,
        shared_len)``."""
        if not self._sharable(req):
            return [], None, 0
        full, partial = self.alloc.match_prefix(req.tokens)
        plen = len(req.tokens)
        c, ps = self.ecfg.prefill_chunk, self.ecfg.page_size

        def padded_end(sl):
            return sl + -(-(plen - sl) // c) * c

        sl = len(full) * ps + (partial[1] if partial else 0)
        while sl and padded_end(sl) > self.ecfg.max_cache:
            if partial is not None:
                partial = None
            else:
                full = full[:-1]
            sl = len(full) * ps
        return full, partial, sl

    def _need_pages(self, req: ServeRequest, shared_len: int = 0) -> int:
        """Worst-case pages this request can ever hold: prompt (+ chunk
        padding of the unshared tail) plus its full decode budget; a VLM's
        patch prefix counts toward the prompt."""
        plen = len(req.tokens) + self.cfg.frontend_tokens
        cover = plen + req.max_new_tokens
        if self._chunkable(req):
            c = self.ecfg.prefill_chunk
            cover = max(cover, shared_len + -(-(plen - shared_len) // c) * c)
        return pages_for(cover, self.ecfg.page_size)

    def _table_row(self, slot: int) -> torch.Tensor:
        return self._dev(self.alloc.table()[slot])

    # -- admission -----------------------------------------------------------
    def _admit_into(self, req: ServeRequest, slot: int) -> bool:
        """Try to admit ``req`` into ``slot``; False = not enough pages after
        prefix-share credit (the caller defers the request). A preempted
        request re-enters here unchanged: it re-prefills its prompt and
        replays its recorded tokens through decode."""
        full, partial, sl = self._match(req)
        plen = len(req.tokens) + self.cfg.frontend_tokens
        c, ps = self.ecfg.prefill_chunk, self.ecfg.page_size
        chunkable = self._chunkable(req)
        # no-write last page: the only write into the shared page is the
        # final prompt token, bitwise what the page already holds
        nowrite = (partial is not None and chunkable
                   and sl == plen - 1 and plen % ps == 0)
        if self.ecfg.admission_mode == "reserve":
            base = self._need_pages(req, sl)
        else:
            cover = sl + -(-(plen - sl) // c) * c if chunkable else plen
            # a resumed request is admitted only once its replay fits
            cover = max(cover, plen + len(req.out_tokens))
            base = pages_for(cover, ps)
        charge = base - len(full) - (1 if nowrite else 0)
        matched = full + ([partial[0]] if partial else [])
        avail = self.alloc.available() - self.alloc.pinned_among(matched)
        if charge > min(avail, self.maxp):
            return False
        if full:
            self.alloc.adopt(slot, full, rclass=req.rclass)
        if self.ecfg.admission_mode == "reserve":
            self.alloc.reserve(slot, charge)
        if self._sharable(req):
            self.sharable_prompt_pages += pages_for(plen, ps)
            self.shared_pages_adopted += len(full) + (1 if partial else 0)
            self.prefill_positions_skipped += sl
        req.slot = slot
        if req.admit_tick < 0:
            req.admit_tick = self.tick
            if self._tr is not None and req.submit_time >= 0:
                self._tr.add("queue", req.submit_time, time.perf_counter(),
                             rid=req.rid, root=True)
        if req.preempt_tick >= 0:
            req.requeue_ticks += self.tick - req.preempt_tick
            req.preempt_tick = -1
        self.slots[slot] = req
        if self._decoding_before_admit:
            self.mid_stream_admissions += 1
        self._admitted_this_tick += 1
        if chunkable:
            if partial is not None:
                self.alloc.adopt(slot, [partial[0]], rclass=req.rclass)
                if nowrite:
                    self.nowrite_adoptions += 1
                else:
                    # the unshared tail starts mid-page: copy-on-write fork
                    src, dst = self.alloc.cow_fork(slot, len(full))
                    model.copy_page_paged(self.pool, self.cfg, src, dst)
            total = sl + -(-(plen - sl) // c) * c
            self.jobs.append(_PrefillJob(req=req, slot=slot, p0=sl,
                                         total=total, length=plen,
                                         share=self._sharable(req)))
            return True
        tr = self._tr
        if tr is not None:
            tr.begin("prefill", rid=req.rid, tokens=plen)
            tr.begin("prefill.launch")
        logits, one = _prefill_one(self.params, self.cfg,
                                   req.prompts(self.device),
                                   self.ecfg.max_cache, self.ecfg.attn_backend,
                                   self.router_bias)
        self.prefills += 1
        first = self._seed_slot(req, logits)
        self.alloc.ensure(slot, pages_for(plen, ps))
        model.insert_slot_cache_paged(self.pool, one, self.cfg, slot,
                                      self._table_row(slot))
        self.last[slot] = first[0]
        self.active[slot] = True
        self.active_host[slot] = True
        self.pos_host[slot] = plen
        self.emitted[slot] = 1
        req.prefill_tokens += plen
        self.prefill_tokens += plen
        if tr is not None:
            tr.end()
        self._emit_seed(req, logits, first)
        if tr is not None:
            tr.end()
        return True

    # -- preemption ----------------------------------------------------------
    def _victim_score(self, req: ServeRequest) -> tuple:
        """Preemption priority, highest evicted first: anergic classes, then
        classes over their latency budget, then the highest remembered cost,
        then the latest arrival (the oldest resident always runs to
        completion), then least progress / rid. A group member's progress is
        its resident group's: evicting one member evicts them all."""
        over = 1.0 if self._over_budget_now(req) else 0.0
        if self.admission is not None:
            anergy = float(self.admission.anergy.level[req.rclass])
            cost = self.admission.remembered_cost(req.rclass)
        else:
            anergy = cost = 0.0
        progress = len(req.out_tokens)
        if req.group >= 0:
            progress = sum(len(r.out_tokens) for r in self.slots
                           if r is not None and r.group == req.group)
        return (anergy, over, cost, req.arrival, -progress, req.rid)

    def _pick_victim(self) -> Optional[int]:
        best, best_score = None, None
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            score = self._victim_score(req)
            if best_score is None or score > best_score:
                best, best_score = slot, score
        return best

    def _free_slot(self, slot: int) -> None:
        """Return ``slot`` to the pool: release its pages (refcount--), wipe
        its slot-row (recurrent / ring) state and reset its decode state and
        sampling lane to the free-slot argmax row."""
        self.slots[slot] = None
        model.release_slot_cache_paged(self.pool, self.cfg, slot)
        self.active[slot] = False
        self.alloc.release(slot)
        self.active_host[slot] = False
        self.pos_host[slot] = 0
        self.emitted[slot] = 0
        self.samp_temp[slot] = 0.0
        self.samp_topk[slot] = 0
        self.samp_topp[slot] = 1.0
        self.samp_rep[slot] = 1.0
        self.samp_pres[slot] = 0.0
        self.samp_freq[slot] = 0.0
        self.tok_counts[slot] = 0
        self._spec_cache = None

    def _preempt_one(self, slot: int) -> None:
        """Evict ``slot``'s request: drop its pages and any in-flight prefill
        job, and re-queue it at the front for exact re-entry."""
        req = self.slots[slot]
        self.jobs = deque(j for j in self.jobs if j.slot != slot)
        self._free_slot(slot)
        req.slot = -1
        req.preemptions += 1
        req.preempt_tick = self.tick
        self.preemptions += 1
        self.preempted_rids.add(req.rid)
        if req.group >= 0:
            # eviction may drop the shared chain's last refcount: the ready
            # bit is stale until some lane's re-prefill registers it again
            self._group_ready.discard(req.group)
        self.queue.appendleft(req)

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``'s request and, for a slot-group member, its
        resident siblings with it, in descending lane order so lane 0 ends
        at the queue front and re-registers the shared prefix first."""
        req = self.slots[slot]
        targets = [slot]
        if req.group >= 0:
            targets = [s for _, s in sorted(
                ((r.lane, s) for s, r in enumerate(self.slots)
                 if r is not None and r.group == req.group), reverse=True)]
        for s in targets:
            self._preempt_one(s)

    def _acquire(self, slot: int, npages: int) -> bool:
        """Grow ``slot`` to ``npages``, resolving page exhaustion by
        preemption. Returns False when the slot's own request was the
        lowest-priority resident and preempted itself."""
        if self.ecfg.admission_mode == "reserve":
            self.alloc.ensure(slot, npages)
            return True
        req = self.slots[slot]
        while True:
            # a victim's group cascade may have evicted this slot's own
            # request as a sibling: the caller must stop driving the slot
            if req is not None and self.slots[slot] is not req:
                return False
            try:
                self.alloc.ensure(slot, npages)
                return True
            except OutOfPages:
                victim = self._pick_victim()
                if victim is None or victim == slot:
                    self._preempt(slot)
                    return False
                self._preempt(victim)

    def _admit(self):
        self._admitted_this_tick = 0
        self._decoding_before_admit = any(r is not None for r in self.slots)
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free or not self.queue:
            return
        if self.admission is None:                      # FIFO baseline
            while free and self.queue:
                if self._deferred_member(self.queue[0]) \
                        or not self._admit_into(self.queue[0], free[0]):
                    break     # strict FIFO: an unfit head blocks the line
                self.queue.popleft()
                free.pop(0)
            return
        adm = self.admission
        # tolerance turned shedding: anergic classes are rejected outright;
        # shedding one group member sheds its group
        for req in [r for r in self.queue if not adm.admissible(r.rclass)]:
            if req not in self.queue:
                continue                  # already cancelled with its group
            self.queue.remove(req)
            req.finish_reason = "shed"
            self.shed.append(req)
            req.finish_tick = self.tick
            req.finish_time = time.perf_counter()
            if req.group >= 0:
                self._cancel_group(req.group, "shed")
        if adm.throttled():                             # delayed suppression
            return
        # anticipation: order by remembered class cost; a candidate the pool
        # cannot hold yet is skipped (deferred), never blocking smaller ones
        cost = self._predicted_costs()
        candidates = sorted(self.queue,
                            key=lambda r: (cost[r.rclass], r.arrival, r.rid))
        for req in candidates:
            if not free:
                break
            if self._deferred_member(req) or not self._admit_into(req,
                                                                  free[0]):
                continue
            self.queue.remove(req)
            free.pop(0)

    def _deferred_member(self, req: ServeRequest) -> bool:
        """Sibling lanes of a group wait (under prefix sharing) until a
        member's prompt pages are registered, so they adopt them instead of
        each paying a full prefill. The wait holds only while a lower lane is
        still queued or mid-prefill: otherwise nobody will register the chain
        and the lane admits now."""
        if req.group < 0 or req.lane == 0 or not self._sharable(req):
            return False
        if req.group in self._group_ready:
            return False
        return (any(q.group == req.group and q.lane < req.lane
                    for q in self.queue)
                or any(j.req.group == req.group and j.req.lane < req.lane
                       for j in self.jobs))

    def _cancel_group(self, gid: int, reason: str) -> None:
        """One member shed or corrupted takes its siblings with it: resident
        lanes release their slots, queued lanes leave the queue, all with the
        member's ``reason``. A group completes whole or fails whole."""
        sink = {"shed": self.shed, "corrupted": self.corrupted,
                "rejected": self.rejected}[reason]
        for slot, r in enumerate(self.slots):
            if r is None or r.group != gid:
                continue
            self.jobs = deque(j for j in self.jobs if j.slot != slot)
            self._free_slot(slot)
            r.slot = -1
            r.finish_reason = reason
            r.finish_tick = self.tick
            r.finish_time = time.perf_counter()
            sink.append(r)
        for r in [q for q in self.queue if q.group == gid]:
            self.queue.remove(r)
            r.finish_reason = reason
            r.finish_tick = self.tick
            r.finish_time = time.perf_counter()
            sink.append(r)
        self._group_ready.discard(gid)

    def _predicted_costs(self) -> np.ndarray:
        """Per-class cost estimate: the EMA memory, floored by the ticks
        running requests have already held."""
        cost = self.admission.memory.value.numpy().astype(np.float64)
        for r in self.slots:
            if r is not None:
                cost[r.rclass] = max(cost[r.rclass], self.tick - r.admit_tick)
        return cost

    # -- chunked prefill ------------------------------------------------------
    def _finish_job(self, job: _PrefillJob, logits):
        """Final chunk landed: draw the first token, activate the slot, and
        register a sharable prompt's full pages in the prefix index."""
        first = self._seed_slot(job.req, logits)
        self.pool["pos"][job.slot] = job.length
        self.last[job.slot] = first[0]
        self.active[job.slot] = True
        self.active_host[job.slot] = True
        self.pos_host[job.slot] = job.length
        self.emitted[job.slot] = 1
        self._emit_seed(job.req, logits, first)
        if job.share:
            self.alloc.register_prefix(job.slot, job.req.tokens,
                                       rclass=job.req.rclass)
            if job.req.group >= 0:
                self._group_ready.add(job.req.group)

    def _prefill_tick(self):
        """Land one chunk of up to ``prefill_streams`` front prefill jobs
        (one batched call), while the other slots keep decoding."""
        if not self.jobs:
            return
        c, page = self.ecfg.prefill_chunk, self.ecfg.page_size
        if self._multi_prefill:
            j = self.ecfg.prefill_streams
            take: list[_PrefillJob] = []
            while self.jobs and len(take) < j:
                job = self.jobs.popleft()
                if not self._acquire(job.slot, pages_for(job.p0 + c, page)):
                    continue          # the job's own request self-preempted
                take = [t for t in take if self.slots[t.slot] is t.req]
                take.append(job)
            if not take:
                return
            toks = np.zeros((j, c), np.int64)
            tables = np.zeros((j, self.maxp), np.int32)   # padding lanes: null
            p0s = np.zeros((j,), np.int64)
            last_idxs = np.zeros((j,), np.int64)
            for lane, job in enumerate(take):
                seg = job.req.tokens[job.p0:min(job.p0 + c,
                                                len(job.req.tokens))]
                toks[lane, :len(seg)] = seg
                p0s[lane] = job.p0
                last_idxs[lane] = min(max(job.length - 1 - job.p0, 0), c - 1)
                job.req.prefill_tokens += len(seg)
                self.prefill_tokens += len(seg)
            tbl = self.alloc.table()
            for lane, job in enumerate(take):
                tables[lane] = tbl[job.slot]
            tr = self._tr
            if tr is not None:
                tr.begin("prefill", tokens=sum(
                    max(0, min(c, len(t.req.tokens) - t.p0)) for t in take))
                tr.begin("prefill.launch")
            logits_j, self.pool = model.prefill_chunk_multi(
                self.params, self.cfg, {"tokens": self._dev(toks)}, self.pool,
                self._dev(tables), self._dev(p0s), self._dev(last_idxs),
                attn_backend=self.ecfg.attn_backend,
                router_bias=self.router_bias)
            if tr is not None:
                tr.end()
            self.chunked_prefill_chunks += len(take)
            self.prefill_batch_calls += 1
            unfinished = []
            for lane, job in enumerate(take):
                job.p0 += c
                if job.p0 >= job.total:
                    self._finish_job(job, logits_j[lane:lane + 1])
                else:
                    unfinished.append(job)
            for job in reversed(unfinished):      # keep front-of-queue order
                self.jobs.appendleft(job)
            if tr is not None:
                tr.end()
            return
        job = self.jobs[0]
        end = job.p0 + c
        if not self._acquire(job.slot, pages_for(end, page)):
            return                    # the job's request was requeued
        toks = np.zeros((c,), np.int64)
        seg = job.req.tokens[job.p0:min(end, len(job.req.tokens))]
        toks[:len(seg)] = seg
        job.req.prefill_tokens += len(seg)
        self.prefill_tokens += len(seg)
        chunk = {"tokens": self._dev(toks)[None]}
        if self.cfg.family == "audio":
            fr = np.zeros((c, self.cfg.frontend_dim), np.float32)
            fseg = job.req.frames[job.p0:min(end, len(job.req.frames))]
            fr[:len(fseg)] = fseg
            chunk["frames"] = self._dev(fr)[None]
        last_idx = min(max(job.length - 1 - job.p0, 0), c - 1)
        tr = self._tr
        if tr is not None:
            tr.begin("prefill", rid=job.req.rid, tokens=len(seg))
            tr.begin("prefill.launch")
        logits, self.pool = model.prefill_chunk(
            self.params, self.cfg, chunk, self.pool,
            self._table_row(job.slot), job.p0, last_idx, slot=job.slot,
            attn_backend=self.ecfg.attn_backend, router_bias=self.router_bias)
        if tr is not None:
            tr.end()
        self.chunked_prefill_chunks += 1
        job.p0 = end
        if end >= job.total:
            self.jobs.popleft()
            self._finish_job(job, logits)
        if tr is not None:
            tr.end()

    # -- retirement ----------------------------------------------------------
    def _slo(self, req: ServeRequest) -> tuple:
        """``(latency, bar)`` in ONE unit: a declared ``deadline`` is judged
        against wall-clock latency, otherwise tick latency against the
        engine's tick budget."""
        if req.deadline is not None and req.wall_latency_s is not None:
            return req.wall_latency_s, float(req.deadline)
        return float(req.latency), float(self.ecfg.latency_budget)

    def _met_budget(self, req: ServeRequest) -> bool:
        lat, bar = self._slo(req)
        return lat <= bar

    def _over_budget_now(self, req: ServeRequest) -> bool:
        """Mid-flight over-budget signal (victim scoring), same units."""
        if req.deadline is not None:
            return req.submit_time >= 0 and \
                time.perf_counter() - req.submit_time > req.deadline
        return (self.tick - req.arrival) > self.ecfg.latency_budget

    def _finished(self, req: ServeRequest) -> bool:
        """Stop token (kept) or token budget; records ``finish_reason``."""
        p = req.params
        if p.stop and req.out_tokens and req.out_tokens[-1] in p.stop:
            req.finish_reason = "stop"
            return True
        if len(req.out_tokens) >= p.max_new_tokens:
            req.finish_reason = "length"
            return True
        return False

    def _retire(self):
        for slot, req in enumerate(self.slots):
            if req is None or not self.active_host[slot] \
                    or not self._finished(req):
                continue
            req.finish_tick = self.tick
            req.finish_time = time.perf_counter()
            self.completed.append(req)
            self._free_slot(slot)
            if self.admission is not None:
                # cost = slot-ticks consumed, replayed tokens included
                lat, bar = self._slo(req)
                self.admission.observe_completion(
                    req.rclass,
                    cost=float(len(req.out_tokens) + req.replayed_tokens),
                    latency=lat, budget=bar)

    def _retire_corrupted(self, slot: int) -> None:
        """Retire a lane whose decode logits came back non-finite (no cost
        observation: corruption is not a workload signal), and its group.

        Before its pages return to the pool, the K and V of every layer are
        zeroed on each page the lane owns alone and that no prefix chain
        indexes, and on the null page (where its writes past capacity land).
        A later owner of such a page reads the lane's stale positions masked,
        and 0 * NaN in the PV product — in the kernels, their plain versions
        and the torch backend alike — would poison that owner too. Shared
        and indexed pages hold prefill K/V written for another lane or before
        the fault, which is finite. The reference frees the pages unscrubbed
        and keeps this fault (src/repro/serve/engine.py:1301)."""
        req = self.slots[slot]
        req.finish_reason = "corrupted"
        req.finish_tick = self.tick
        req.finish_time = time.perf_counter()
        self.corrupted.append(req)
        private = [p for p in self.alloc.owned(slot)
                   if self.alloc.refcount(p) == 1
                   and not self.alloc.is_indexed(p)]
        model.scrub_pages_paged(self.pool, self.cfg, [0] + private)
        self._free_slot(slot)
        if req.group >= 0:
            self._cancel_group(req.group, "corrupted")

    # -- decode ticks --------------------------------------------------------
    def _plain_step(self, do_sample: bool, use_penalties: bool,
                    want_lp: bool, want_k: int) -> None:
        """One decode tick: one token for every active slot. Its two clock
        readings bound the ``decode`` span and give ``decode_seconds``."""
        t0 = time.perf_counter()
        tr = self._tr
        counts = self._dev(self.emitted, torch.int64)
        spec = self._pool_spec() if do_sample else self._null_spec
        pen = self._dev(self.tok_counts) if use_penalties else None
        nxt, self.last, self.pool, ok, logits, lps, topk = _decode_tick(
            self.params, self.cfg_decode, self.pool, self.last, self.active,
            self._dev(self.alloc.table()), self.router_bias, self.frames, spec,
            counts, pen, attn_backend=self.ecfg.attn_backend,
            do_sample=do_sample,
            return_logits=self.ecfg.capture_logits, return_logprobs=want_lp,
            use_penalties=use_penalties, return_topk=want_k)
        if tr is not None:
            t_launch = time.perf_counter()
        nxt_host = nxt[:, 0].cpu().numpy()
        ok_host = ok.cpu().numpy()
        lg_host = logits[:, -1].cpu().numpy() if logits is not None else None
        lp_host = lps[:, 0].cpu().numpy() if lps is not None else None
        tv_host, ti_host = (topk[0].cpu().numpy(), topk[1].cpu().numpy()) \
            if topk is not None else (None, None)
        if tr is not None:
            t_wait = time.perf_counter()
        self.decode_ticks += 1
        bad: list[int] = []
        for slot, req in enumerate(self.slots):
            if req is None or not self.active_host[slot] \
                    or self._finished(req):
                continue
            if not ok_host[slot]:
                bad.append(slot)    # poisoned lane: token is garbage
                continue
            if self.emitted[slot] >= len(req.out_tokens):
                req.out_tokens.append(int(nxt_host[slot]))
                if lg_host is not None:
                    req.out_logits.append(lg_host[slot].copy())
                if lp_host is not None and req.params.logprobs:
                    req.out_logprobs.append(float(lp_host[slot]))
                if tv_host is not None and req.params.logprobs:
                    k = req.params.logprobs
                    req.out_topk.append(
                        ([int(x) for x in ti_host[slot][:k]],
                         [float(x) for x in tv_host[slot][:k]]))
            else:
                self.replayed_tokens += 1   # replaying recorded history
                req.replayed_tokens += 1
            if req.params.has_penalties:
                self.tok_counts[slot, int(nxt_host[slot])] += 1
            self.emitted[slot] += 1
        self.pos_host[self.active_host] += 1
        for slot in bad:
            self._retire_corrupted(slot)
        t1 = time.perf_counter()
        self.decode_seconds += t1 - t0
        if tr is not None:
            _tick_spans(tr, "decode", t0, t_launch, t_wait, t1)

    def _spec_step(self) -> None:
        """One self-speculative tick: fused draft+verify, then the host-side
        greedy accept loop. Per lane: accept the longest draft prefix where
        ``d_j == argmax(row j-1)`` plus the bonus token ``argmax(row a)``,
        stopping early at the request's stop/budget boundary. Its two clock
        readings bound the ``spec`` span and give ``spec_seconds``."""
        t0 = time.perf_counter()
        tr = self._tr
        k = self.ecfg.spec_decode
        drafts, am, ok, logits, new_pool = specdec.spec_tick(
            self.params, self.cfg_decode, self.pool, self.last, self.active,
            self._dev(self.alloc.table()), k=k,
            depth=self.ecfg.spec_draft_layers,
            attn_backend=self.ecfg.attn_backend,
            return_logits=self.ecfg.capture_logits,
            router_bias=self.router_bias)
        if tr is not None:
            t_launch = time.perf_counter()
        drafts_h = drafts.cpu().numpy()
        am_h = am.cpu().numpy()
        ok_h = ok.cpu().numpy()
        lg_h = logits.cpu().numpy() if logits is not None else None
        last_h = self.last.cpu().numpy().copy()
        if tr is not None:
            t_wait = time.perf_counter()
        self.spec_ticks += 1
        bad: list[int] = []
        for slot, req in enumerate(self.slots):
            if req is None or not self.active_host[slot] \
                    or self._finished(req):
                continue
            if not ok_h[slot]:
                bad.append(slot)
                continue
            a = specdec.accept_length(drafts_h[slot], am_h[slot], k)
            self.spec_drafted += k
            emitted_now = 0
            for j in range(a + 1):
                tok = int(drafts_h[slot, j]) if j < a else int(am_h[slot, a])
                if self.emitted[slot] >= len(req.out_tokens):
                    req.out_tokens.append(tok)
                    if lg_h is not None:
                        req.out_logits.append(lg_h[slot, j].copy())
                else:
                    self.replayed_tokens += 1
                    req.replayed_tokens += 1
                self.emitted[slot] += 1
                emitted_now += 1
                last_h[slot, 0] = tok
                if self._finished(req):
                    break               # stop/budget: the rest is never real
            self.spec_accepted += min(emitted_now, a)
            self.spec_emitted += emitted_now
            # pos advances by exactly what was emitted: verify wrote K/V for
            # positions pos..pos+k, of which pos..pos+emitted_now-1 hold what
            # sequential decode would have written; the stale tail is read
            # only masked and is overwritten before it becomes visible
            self.pos_host[slot] += emitted_now
        self.last = self._dev(last_h)
        self.pool = {"layers": new_pool["layers"],
                     "pos": self._dev(self.pos_host, torch.int32)}
        for slot in bad:
            self._retire_corrupted(slot)
        t1 = time.perf_counter()
        self.spec_seconds += t1 - t0
        if tr is not None:
            _tick_spans(tr, "spec", t0, t_launch, t_wait, t1)

    # -- one tick ------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One engine tick: admit into free slots, land a prefill chunk,
        decode one token for every active slot, retire finished sequences,
        advance the immune states. Under no-grad: the model may be one a
        trainer left with gradients on, and the serving kernels have no
        backward."""
        tr = self._tr = telemetry.session()
        if tr is not None:
            tr.begin("step", root=True, tick=self.tick,
                     residents=sum(r is not None for r in self.slots),
                     queue_len=len(self.queue),
                     pages_in_use=self.alloc.pages_in_use)
            tr.begin("admit")
        self._admit()
        if tr is not None:
            tr.end()
        self._prefill_tick()
        self.concurrency_hw = max(self.concurrency_hw,
                                  sum(r is not None for r in self.slots))
        use_penalties = any(r is not None and r.params.has_penalties
                            for r in self.slots)
        do_sample = use_penalties or any(
            r is not None and not r.params.is_greedy for r in self.slots)
        want_lp = any(r is not None and r.params.logprobs
                      for r in self.slots)
        want_k = max((r.params.logprobs for r in self.slots
                      if r is not None), default=0)
        # a spec tick only while every resident is greedy with no penalty or
        # logprob state to advance per emitted token
        use_spec = self._spec_ok and not do_sample and not want_lp
        lookahead = self.ecfg.spec_decode if use_spec else 0
        page = self.ecfg.page_size
        for slot in np.flatnonzero(self.active_host):
            slot = int(slot)
            if not self.active_host[slot]:
                continue              # preempted by an earlier slot's growth
            # decode writes at pos (a spec tick at pos..pos+k, clamped to the
            # slot's capacity: writes past it go to the null page and belong
            # to tokens the budget never emits): append pages at the
            # boundary, preempting the lowest-priority resident if dry
            cover = min(int(self.pos_host[slot]) + 1 + lookahead,
                        self.ecfg.max_cache)
            self._acquire(slot, pages_for(cover, page))
        if self.active_host.any():
            if use_spec:
                self._spec_step()
            else:
                self._plain_step(do_sample, use_penalties, want_lp, want_k)
        if tr is not None:
            tr.begin("retire")
        self._retire()
        if self.admission is not None:
            demand = np.zeros(self.ecfg.num_classes, np.float64)
            for r in self.queue:
                demand[r.rclass] += 1.0
            self.admission.end_tick(self._admitted_this_tick, len(self.queue),
                                    demand, self._predicted_costs())
        if tr is not None:
            tr.end()
            tr.end()
        self.tick += 1

    # -- open-loop serving ---------------------------------------------------
    def _output_for(self, req: ServeRequest, tick: int, new_tokens: list,
                    finished: bool,
                    reason: Optional[str] = None) -> RequestOutput:
        done = finished and reason is None
        new_lp = full_lp = topk = None
        if req.params.logprobs:
            n = len(req.out_tokens)
            new_lp = list(req.out_logprobs[n - len(new_tokens):n])
            full_lp = list(req.out_logprobs)
            topk = list(req.out_topk)
        return RequestOutput(
            rid=req.rid, new_tokens=new_tokens, tokens=list(req.out_tokens),
            finished=finished,
            finish_reason=reason if reason is not None
            else (req.finish_reason if done else None),
            tick=tick, arrival=req.arrival, admit_tick=req.admit_tick,
            finish_tick=req.finish_tick,
            latency_ticks=req.latency if done else None,
            wall_latency_s=req.wall_latency_s if done else None,
            deadline_met=self._met_budget(req) if done else None,
            new_logprobs=new_lp, logprobs=full_lp, top_logprobs=topk,
            preemptions=req.preemptions, requeue_ticks=req.requeue_ticks)

    def _report(self, req: ServeRequest, out: RequestOutput) -> Iterator:
        """A member's terminal output, then its group's assembled parent
        output when it was the group's last lane."""
        yield out
        done = self.group_book.offer(req, out)
        if done is not None:
            yield done

    def stream(self, requests: Optional[list] = None,
               max_ticks: int = 10_000) -> Iterator[RequestOutput]:
        """Open-loop drive as an iterator: submit each request at its
        ``arrival`` tick, step until everything completes (or
        ``max_ticks``), and yield a ``RequestOutput`` per request per tick of
        progress (``new_tokens`` = the delta since its previous output).
        Refusals ("rejected" / "shed" / "corrupted") are reported too, and
        requests still held when the backstop fires get a final
        ``finish_reason="timeout"`` output with ``finished=False``. A
        slot-group parent's assembled output follows its last member's
        terminal output."""
        pending = sorted(requests or [], key=lambda r: (r.arrival, r.rid))
        i = 0
        sent: dict = {}                      # rid -> tokens already yielded
        while True:
            while i < len(pending) and pending[i].arrival <= self.tick:
                self.submit(pending[i])
                i += 1
            self.unsubmitted = len(pending) - i
            t = self.tick
            for req in self.rejected[self._reported_rejected:]:
                yield from self._report(req, self._output_for(
                    req, t, [], True, reason="rejected"))
            self._reported_rejected = len(self.rejected)
            drained = (i == len(pending) and not self.queue
                       and all(r is None for r in self.slots))
            if drained or t >= max_ticks:
                if not drained:              # backstop: account for the rest
                    live = [r for r in self.slots if r is not None]
                    for req in live + list(self.queue):
                        k = sent.get(req.rid, 0)
                        yield self._output_for(
                            req, t, list(req.out_tokens[k:]), False,
                            reason="timeout")
                break
            ndone = len(self.completed)
            self.step()
            for req in self.shed[self._reported_shed:]:
                yield from self._report(req, self._output_for(
                    req, t, [], True, reason="shed"))
            self._reported_shed = len(self.shed)
            for req in self.corrupted[self._reported_corrupted:]:
                yield from self._report(req, self._output_for(
                    req, t, [], True, reason="corrupted"))
            self._reported_corrupted = len(self.corrupted)
            live = [r for r in self.slots if r is not None]
            for req in live + self.completed[ndone:]:
                n = len(req.out_tokens)
                k = sent.get(req.rid, 0)
                finished = req.finish_tick == t
                if n == k and not finished:
                    continue
                sent[req.rid] = n
                yield from self._report(req, self._output_for(
                    req, t, list(req.out_tokens[k:n]), finished))

    def run(self, requests: list, max_ticks: int = 10_000) -> dict:
        """``stream()`` with the outputs discarded; returns ``stats()``."""
        for _ in self.stream(requests, max_ticks=max_ticks):
            pass
        return self.stats()

    def stats(self) -> dict:
        lat = np.asarray([r.latency for r in self.completed], np.float64)
        wall = np.asarray([r.wall_latency_s for r in self.completed
                           if r.wall_latency_s is not None], np.float64) * 1e3
        toks = int(sum(len(r.out_tokens) for r in self.completed))
        in_budget = sum(1 for r in self.completed if self._met_budget(r))
        in_flight = sum(r is not None for r in self.slots)
        # every request the trace produced, wherever it ended up: the goodput
        # denominator
        demand = (len(self.completed) + len(self.shed) + len(self.rejected)
                  + len(self.corrupted) + len(self.queue) + in_flight
                  + self.unsubmitted)
        empty = float("inf")
        return {
            "policy": self.ecfg.policy,
            "ticks": self.tick,
            "completed": len(self.completed),
            "shed": len(self.shed),
            "rejected": len(self.rejected),
            "corrupted": len(self.corrupted),
            "unserved": len(self.queue) + in_flight + self.unsubmitted,
            "tokens": toks,
            "throughput": toks / max(self.tick, 1),
            "p50_latency": float(np.percentile(lat, 50)) if lat.size else empty,
            "p99_latency": float(np.percentile(lat, 99)) if lat.size else empty,
            "max_latency": float(lat.max()) if lat.size else empty,
            "goodput": in_budget / max(demand, 1),
            "mid_stream_admissions": self.mid_stream_admissions,
            "page_size": self.ecfg.page_size,
            "pages_budget": self.alloc.usable_pages,
            "pages_in_use": self.alloc.pages_in_use,
            "pages_hw": self.alloc.high_water,
            "concurrency_hw": self.concurrency_hw,
            "chunked_prefill_chunks": self.chunked_prefill_chunks,
            "prefill_batch_calls": self.prefill_batch_calls,
            "attn_backend": self.ecfg.attn_backend,
            "prefix_sharing": bool(self.ecfg.prefix_sharing),
            "shared_pages_adopted": self.shared_pages_adopted,
            "cow_forks": self.alloc.cow_forks,
            "prefill_positions_skipped": self.prefill_positions_skipped,
            "prefix_hit_rate": self.shared_pages_adopted
            / max(self.sharable_prompt_pages, 1),
            "prefill_tokens": self.prefill_tokens,
            "nowrite_adoptions": self.nowrite_adoptions,
            "admission_mode": self.ecfg.admission_mode,
            "pin_pages": self.alloc.pin_pages,
            "pages_pinned": self.alloc.pages_pinned,
            "pins": self.alloc.pins,
            "pinned_pages_adopted": self.alloc.pinned_hits,
            "pin_evictions": self.alloc.evictions,
            "pinned_hit_rate": self.alloc.pinned_hits
            / max(self.sharable_prompt_pages, 1),
            "preemptions": self.preemptions,
            "preempted_requests": len(self.preempted_rids),
            "replayed_tokens": self.replayed_tokens,
            "p50_wall_ms": float(np.percentile(wall, 50)) if wall.size
            else empty,
            "p99_wall_ms": float(np.percentile(wall, 99)) if wall.size
            else empty,
            "sampled_requests": sum(1 for r in self.completed
                                    if not r.params.is_greedy),
            "deadline_requests": sum(1 for r in self.completed
                                     if r.deadline is not None),
            "penalized_requests": sum(1 for r in self.completed
                                      if r.params.has_penalties),
            # self-speculative decoding: accept rate over proposed drafts and
            # how much of the emitted stream came out of spec ticks
            "spec_decode": self.ecfg.spec_decode,
            "spec_ticks": self.spec_ticks,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_emitted": self.spec_emitted,
            "spec_accept_rate": self.spec_accepted / max(self.spec_drafted, 1),
            # slot groups
            "groups_submitted": self.groups_submitted,
            "group_members_completed": sum(1 for r in self.completed
                                           if r.group >= 0),
            # port instrumentation: kernel launch accounting + host time
            # inside plain decode ticks and inside spec ticks
            "prefills": self.prefills,
            "decode_ticks": self.decode_ticks,
            "decode_seconds": self.decode_seconds,
            "spec_seconds": self.spec_seconds,
        }

    # -- placement telemetry (read by serve.router, all host reads) ----------
    def class_costs(self) -> np.ndarray:
        """Per-class remembered decode cost (the ``ImmuneMemory`` slot-tick
        EMA): the router's load model. Zeros under FIFO (no memory)."""
        if self.admission is None:
            return np.zeros(self.ecfg.num_classes, np.float64)
        return self.admission.memory.value.numpy().astype(np.float64)

    def anergy_levels(self) -> np.ndarray:
        """Per-class anergy levels; a router drains a replica for the classes
        it holds anergic."""
        if self.admission is None:
            return np.zeros(self.ecfg.num_classes, np.float64)
        return self.admission.anergy.level.numpy().astype(np.float64)

    def prefix_affinity(self, req: ServeRequest) -> int:
        """Prompt positions of ``req`` already resident in this engine's page
        pool (live shared or pinned chains): the prefill a placement here
        skips."""
        return self._match(req)[2]

    def pinned_chain_keys(self) -> list:
        """Token-content keys of this engine's pinned prefix-cache pages."""
        return self.alloc.pinned_chain_keys()

    def occupancy(self) -> int:
        """Queued + resident (incl. mid-prefill) requests: the
        join-shortest-queue load signal."""
        return len(self.queue) + sum(r is not None for r in self.slots)

    # -- failover -------------------------------------------------------------
    def evacuate(self) -> list:
        """Strip every in-flight and queued request for re-placement on
        another replica (the router calls this when it declares this replica
        dead). The request objects carry what re-admission elsewhere needs
        for exact recovery: the prompt and the recorded tokens, which are
        re-prefilled and replayed. Every slot is freed, on the host and on
        the device, so the books stay consistent; the caller fences this
        engine. Returns residents in slot order, then the queue in order."""
        lost = []
        for req in self.slots:
            if req is not None:
                req.slot = -1
                lost.append(req)
        lost.extend(self.queue)
        self.queue.clear()
        self.jobs.clear()
        for slot in range(self.ecfg.num_slots):
            self._free_slot(slot)
        return lost

    def drop_device_state(self) -> None:
        """Free a fenced replica's device memory (its K/V pool and slot
        tensors; the weights are shared). The host books that ``stats()``
        and the router's accounting read stay; the engine can never step
        again."""
        self.pool = self.last = self.active = self.frames = None
        self._spec_cache = self._null_spec = None

    # -- durability: warm-state snapshot export / import ---------------------
    def export_warm_state(self) -> tuple[dict, list]:
        """Snapshot this engine's learned state: the indexed prefix forest
        (token keys and the pages' K/V) and the immune memories. Returns
        ``(meta, kv)``: a JSON-able dict and host K/V tensors, page-major
        then leaf-major (k then v of every paged layer, segment order),
        ``meta["kv_per_page"]`` tensors a page, each (reps, page, Hkv, D): the
        JAX package's layout. All exported pages are gathered with one
        ``index_select`` a paged cache leaf and copied to the host once a
        leaf. In-flight request state is not here: the journal owns it.
        Reads device state, never writes it."""
        forest = self.alloc.export_pinned()
        pages = [e.pop("page") for e in forest]
        leaves: list[torch.Tensor] = []
        if pages:
            idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)

            def gather(kind, full_d):
                if kind in transformer.PAGED_KINDS:
                    for name in ("k", "v"):
                        leaves.append(full_d[name].index_select(1, idx).cpu())
                return full_d

            transformer.map_block_caches(self.cfg, gather, self.pool["layers"])
        kv = [leaf[:, i] for i in range(len(pages)) for leaf in leaves]
        meta = {
            "forest": forest,
            "kv_per_page": len(leaves),
            "pin_memory": self.alloc.pin_memory_state().tolist(),
            "admission": (self.admission.export_state()
                          if self.admission is not None else None),
        }
        return meta, kv

    def import_warm_state(self, meta: dict, kv: list) -> int:
        """Rebuild :meth:`export_warm_state` output into this (fresh) engine:
        pinned chains re-index under newly allocated pages, their K/V is
        scattered back with one ``index_copy_`` a paged cache leaf (zero
        recompute), and the immune memories resume. Returns the number of
        pinned pages restored."""
        if meta.get("pin_memory") is not None:
            self.alloc.set_pin_memory_state(meta["pin_memory"])
        if self.admission is not None and meta.get("admission"):
            self.admission.import_state(meta["admission"])
        placed = self.alloc.import_pinned(meta.get("forest") or [])
        per = int(meta.get("kv_per_page") or 0)
        if not placed or not per:
            return len(placed)
        pages = torch.as_tensor([p for _, p in placed], dtype=torch.long,
                                device=self.device)
        lane = iter(range(per))

        def scatter(kind, full_d):
            if kind in transformer.PAGED_KINDS:
                for name in ("k", "v"):
                    j = next(lane)
                    src = torch.stack([torch.as_tensor(kv[i * per + j])
                                       for i, _ in placed], dim=1)
                    full = full_d[name]
                    if src.dtype != full.dtype:
                        raise ValueError(f"snapshot K/V is {src.dtype}, the "
                                         f"pool {full.dtype}")
                    full.index_copy_(1, pages, src.to(self.device))
            return full_d

        transformer.map_block_caches(self.cfg, scatter, self.pool["layers"])
        return len(placed)
