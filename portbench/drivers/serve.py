"""Open-loop serving of a traffic mix through the port's engine
(``repro_torch.serve.engine.Engine``: ``submit`` and ``step``).

The mix file gives the arrival rate, the prompt and answer lengths, the
request classes and the engine's settings. Every seed serves the same
requests' sizes at the same arrival times, in the same order (one Poisson
trace of the mix, fixed by the mix's ``arrival_key``); the seed draws the
prompts' ids and the weights. So two seeds differ in what is computed, not
in how much or when, and the spread of a cell's runs is the host's.

Each request is timed from when it was due. Its first token is out when
the ``step`` that produced it returns; a request refused, shed or never
answered has no first token, and counts as missing. After the window
closes nothing more is submitted, and the engine steps on (up to
``drain_s``) until every request due in the window has its answer; the
latency counts that wait. Then the program's state is freed and a sample
of the answers, drawn from the seed with the longest among them, is judged
against the plain reference.
"""
from __future__ import annotations

import gc
import hashlib
import math
import statistics
import time

import numpy as np

from ..core import report, weights


def _rng(seed: int, what: str) -> np.random.Generator:
    digest = hashlib.sha256(f"{int(seed)}/{what}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:16], "little"))


def requests(traffic: dict, seed: int, seconds: float, vocab: int) -> list:
    """The window's requests as dicts: ``due`` (s from the window's start),
    ``prompt`` (int32 ids), ``answer`` (tokens asked), ``rclass``."""
    n = max(1, round(traffic["rate_per_s"] * seconds))
    u = (np.arange(n) + 0.5) / n                 # the same quantiles each seed
    nd = statistics.NormalDist()
    p = traffic["prompt"]
    z = np.asarray([nd.inv_cdf(x) for x in u])
    plen = np.clip(np.round(np.exp(math.log(p["median"]) + p["sigma"] * z)),
                   p["min"], p["max"]).astype(np.int64)
    a = traffic["answer"]
    alen = (a["min"] + np.floor(u * (a["max"] - a["min"] + 1))).astype(np.int64)
    # one Poisson arrival trace for the mix (exponential gaps at the same
    # quantiles, in an order fixed by the mix's own key), and the sizes in
    # an order fixed by the same key: every seed meets the same requests
    gaps = -np.log1p(-u) / traffic["rate_per_s"]
    key = traffic.get("arrival_key", 0)
    gaps = _rng(key, "arrivals").permutation(gaps)
    rng = _rng(key, "order")
    plen, alen = rng.permutation(plen), rng.permutation(alen)
    # arrivals span the window: the last one is due before it closes
    due = np.cumsum(gaps) * seconds / (gaps.sum() + gaps.mean())
    edges = np.quantile(plen, [0.25, 0.5, 0.75])
    ids = _rng(seed, "ids")
    return [{"rid": i, "due": float(due[i]), "answer": int(alen[i]),
             "prompt": ids.integers(0, vocab, size=int(plen[i]),
                                    dtype=np.int64).astype(np.int32),
             "rclass": int(np.searchsorted(edges, plen[i], side="right"))}
            for i in range(n)]


class Serve:
    """One run of a serving cell: ``setup``, ``window``, ``drain``,
    ``check``. ``device="cpu"`` runs the plain versions of the kernels
    (rehearsals and tests only; the command refuses to run without a card)."""

    def __init__(self, cell, seed: int, seconds: float, device: str = "cuda"):
        import torch
        self.torch = torch
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.device = device
        self.traffic = cell.traffic
        self.m = cell.config["model"]

    # -- set-up --------------------------------------------------------------
    def setup(self):
        torch = self.torch
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import model as model_lib
        from repro_torch.serve import api
        from repro_torch.serve import engine as eng_mod
        self.api, self.eng_mod = api, eng_mod
        if self.device == "cuda":
            from repro_torch.kernels import _build
            _build.library()                   # built once per checkout
        self.cfg = ModelConfig(**self.m)
        self.params = model_lib.Model(self.cfg, None, torch.device(self.device))
        weights.load_into(self.params, self.m, self.seed)
        e = self.m.get("num_experts", 0)
        self.bias = torch.zeros(self.m["num_layers"], e, device=self.device) \
            if e else None
        self.ecfg = eng_mod.EngineConfig(**self.traffic["engine"])
        self.reqs = requests(self.traffic, self.seed, self.seconds,
                             self.m["vocab_size"])
        self._warm()
        self.engine = eng_mod.Engine(self.params, self.cfg, self.ecfg,
                                     device=self.device,
                                     router_bias=self.bias)
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # what set-up made lives for the whole run: the collector's full
        # passes over the window skip it, as a serving process's would
        gc.collect()
        gc.freeze()

    def _warm(self):
        """The shapes the mix uses, on an engine of its own with a small
        pool: the longest and the shortest prompt's one-shot prefill, and
        decode ticks of every slot, so nothing is first met in the window."""
        w = self.traffic["warmup"]
        ecfg = self.ecfg._replace(num_pages=w["pages"])
        eng = self.eng_mod.Engine(self.params, self.cfg, ecfg,
                                  device=self.device, router_bias=self.bias)
        lens = (self.traffic["prompt"]["max"], self.traffic["prompt"]["min"])
        for i, n in enumerate(lens):
            eng.submit(self.api.ServeRequest(
                rid=-1 - i, tokens=np.full(n, 7, np.int32),
                params=self.api.SamplingParams(max_new_tokens=w["tokens"])))
        for _ in range(w["tokens"] + 2):
            eng.step()
        if self.device == "cuda":
            self.torch.cuda.synchronize()
        del eng

    # -- the window ----------------------------------------------------------
    def _submit(self, r, now: float):
        req = self.api.ServeRequest(
            rid=r["rid"], tokens=r["prompt"], rclass=r["rclass"],
            arrival=self.engine.tick,
            params=self.api.SamplingParams(max_new_tokens=r["answer"]))
        r.update(req=req, lag=now - r["due"], seen_out=0, seen_prefill=0)
        self.engine.submit(req)
        self.live.append(r)

    def _after_step(self, t_end: float, in_window: bool):
        """Read each live request after a step: its first token, its
        admission, the prefills and decode passes the step ran for it."""
        plens, decode_ctx, decode_n = [], 0, 0
        still = []
        for r in self.live:
            req = r["req"]
            if "first" not in r and req.out_tokens:
                r["first"] = t_end
            if "admit" not in r and req.admit_tick >= 0:
                r["admit"] = t_end
            k = 0
            if req.prefill_tokens > r["seen_prefill"]:
                k = (req.prefill_tokens - r["seen_prefill"]) // len(req.tokens)
                plens += [len(req.tokens)] * k
                r["seen_prefill"] = req.prefill_tokens
            # a prefill emits (or, resuming, re-derives) one token itself;
            # every other token this step came out of a decode pass
            done = len(req.out_tokens) + req.replayed_tokens
            passes = done - r["seen_out"] - k
            if passes > 0:
                decode_n += passes
                decode_ctx += passes * (len(req.tokens) + len(req.out_tokens))
            r["seen_out"] = done
            if req.finish_reason is None:
                still.append(r)
        self.live = still
        if in_window:
            self.prefill_lens += plens
            self.decode_tokens += decode_n
            self.decode_ctx += decode_ctx

    def window(self, run: report.Run):
        eng = self.engine
        self.live, self.prefill_lens = [], []
        self.decode_tokens = self.decode_ctx = 0
        self.pages_peak = 0
        queue_depth = []
        reqs, n, i = self.reqs, len(self.reqs), 0
        t0 = time.perf_counter()
        self.t0 = t0
        while True:
            now = time.perf_counter() - t0
            if now >= self.seconds:
                break
            s0 = time.perf_counter()
            while i < n and reqs[i]["due"] <= now:
                self._submit(reqs[i], now)
                i += 1
            idle = not eng.queue and not eng.jobs and \
                all(s is None for s in eng.slots)
            if idle:
                nxt = reqs[i]["due"] if i < n else self.seconds
                time.sleep(max(0.0, min(nxt, self.seconds) - now))
                run.spans.append(("idle", s0, time.perf_counter()))
                continue
            s1 = time.perf_counter()
            eng.step()
            s2 = time.perf_counter()
            run.spans.append(("submit", s0, s1))
            run.spans.append(("engine.step", s1, s2))
            self._after_step(s2 - t0, True)
            self.pages_peak = max(self.pages_peak, eng.alloc.pages_in_use)
            run.spans.append(("harness", s2, time.perf_counter()))
            queue_depth.append(len(eng.queue))
        self.window_end = time.perf_counter() - t0
        now = self.window_end
        while i < n:                       # due in the window, not yet sent
            self._submit(reqs[i], now)
            i += 1
        self.queue_depth = queue_depth
        run.window_s = self.window_end

    def drain(self):
        """Step on until every request due in the window is answered, for
        up to ``drain_s`` from here (a traced run reads its trace first)."""
        eng = self.engine
        limit = time.perf_counter() + self.traffic["drain_s"]
        while self.live and time.perf_counter() < limit:
            eng.step()
            self._after_step(time.perf_counter() - self.t0, False)

    # -- readings ------------------------------------------------------------
    def readings(self, run: report.Run):
        inf = math.inf
        ttft, lag, wait = [], [], []
        refused = unanswered = 0
        for r in self.reqs:
            req = r["req"]
            lag.append(r["lag"])
            ttft.append(r["first"] - r["due"] if "first" in r else inf)
            if r.get("admit", math.inf) <= self.window_end:
                wait.append(r["admit"] - r["due"])
            if req.finish_reason in ("rejected", "shed", "corrupted"):
                refused += 1
            elif req.finish_reason is None:
                unanswered += 1
        run.samples.update(ttft_s=ttft, gen_lag_s=lag, queue_wait_s=wait,
                           step_s=run.span_seconds("engine.step"),
                           prefill_lens=self.prefill_lens,
                           queue_depth=self.queue_depth)
        run.counters.update(decode_tokens=self.decode_tokens,
                            decode_ctx=self.decode_ctx,
                            refused=refused, unanswered=unanswered,
                            preemptions=self.engine.preemptions,
                            pages_peak=self.pages_peak,
                            pages_usable=self.engine.alloc.usable_pages,
                            requests=len(self.reqs))
        run.attempted = len(self.reqs)
        run.failed = sum(1 for r in self.reqs
                         if r["req"].finish_reason not in ("length", "stop"))
        run.checks["unanswered"] = {"value": float(unanswered), "limit": 0}

    def sample(self) -> list:
        """Finished requests to judge: drawn from the seed, with the one that
        served the longest sequence among them."""
        done = [r for r in self.reqs if r["req"].finish_reason == "length"]
        if not done:
            return []
        k = min(self.traffic["check"]["requests"], len(done))
        longest = max(done, key=lambda r: len(r["prompt"]) + r["answer"])
        rest = [r for r in done if r is not longest]
        pick = _rng(self.seed, "check").choice(len(rest), size=k - 1,
                                               replace=False) if k > 1 else []
        return [longest] + [rest[j] for j in sorted(pick)]

    def release(self):
        """Free the program's state before the reference runs."""
        torch = self.torch
        self.engine = None
        self.params = None
        self.bias = None
        gc.unfreeze()
        gc.collect()
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def served(r: dict) -> tuple:
    """(prompt ids, served ids) of a judged request."""
    return r["prompt"], list(r["req"].out_tokens)


def logit_gaps(m: dict, seed: int, seqs: list, device: str,
               quant: str = None) -> tuple[float, int]:
    """The widest gap, over every served token of the judged requests, by
    which the token's logit lies below the reference's best at its
    position, and the number of tokens judged; ``seqs`` holds (prompt ids,
    served ids) pairs. With ``quant`` the control:
    the gap of the token the lower-precision reference puts first."""
    import torch
    from ..reference.transformer import Reference
    w = dict(weights.make(m, seed, device, dtype=torch.float32))
    ref = Reference(m, w)
    low = Reference(m, w, quant) if quant else None
    worst, n = 0.0, 0
    with torch.no_grad():
        for prompt, out in seqs:
            seq = torch.as_tensor(np.concatenate([prompt, out[:-1]]),
                                  dtype=torch.long, device=device)[None]
            L = len(prompt)
            x, _ = ref.hidden(seq)
            lg = ref.head(x[0, L - 1:])                    # (len(out), V)
            if low is None:
                tok = torch.as_tensor(out, dtype=torch.long, device=device)
            else:
                xl, _ = low.hidden(seq)
                tok = low.head(xl[0, L - 1:]).argmax(dim=-1)
            gap = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            n += len(out)
            del x, lg
    return worst, n


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        clock) -> report.Run:
    """One run of the cell; ``clock()`` gives the seconds since the process
    started."""
    import torch
    from ..core import peaks
    from ..core.trace import Trace
    s = Serve(cell, seed, seconds, device)
    s.setup()
    tr = Trace(torch, trace and device == "cuda")
    r = report.Run(cell, device, tr)
    r.setup_s = clock()
    with tr:
        s.window(r)
    s.drain()
    s.readings(r)
    if device == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()
        r.device_kind = torch.cuda.get_device_name(0)
        r.peaks = peaks.peak(r.device_kind)
    judged = s.sample()
    s.release()
    t_check = time.perf_counter()
    lim = cell.limits
    if judged:
        gap, ntok = logit_gaps(s.m, s.seed, [served(j) for j in judged],
                               device)
        r.counters["judged_tokens"] = ntok
        r.checks["logit_gap"] = {"value": gap, "limit": lim["logit_gap"]}
    else:
        r.checks["logit_gap"] = {"value": math.inf, "limit": lim["logit_gap"]}
    r.check_s = time.perf_counter() - t_check
    return r
