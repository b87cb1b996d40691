"""The serving engine: paged decode ticks and prefill chunks driven by
a scheduler (counterpart of the reference's `serve/engine.py`).

Two device steps serve every request mix:

- `decode tick` — all engine slots advance one token in one forward
  (B = slots, k = 1, per-slot positions); dead slots ride along with
  valid=False, their writes routed to the scratch page and their
  sampled tokens ignored by the host.
- `prefill chunk` — one slot advances `prefill_chunk` prompt tokens
  (B = 1, k = chunk, padded). The LAST chunk of a prompt also yields the
  request's first generated token.

Sampling is greedy. MoE models serve through `token_forward`'s MoE
branch (every expert, no drop; the expert weights stay float32 under
int8 decode weights). The host loop (`run`) is the reference's, one
scheduler iteration per pass: sweep deadlines/cancellations -> enforce
the queue bound -> admit -> at most one prefill chunk -> one decode tick
over every decoding slot; the per-iteration state digest is chained into
`state_crc` exactly as the reference does, so the two engines can be
held to equal schedules.

Not ported yet, and refused loudly: speculative decoding (lookup and
draft), prefix sharing with copy-on-write, the host spill tier, the SLO
scheduler, cross-engine page adoption, fault injection, and the metrics
registry / tick sink.
"""

from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np
import torch

from .._device import resolve_device
from ..models.generate import (
    CACHE_DTYPES,
    pick_cache_dtype,
    pick_weights_dtype,
)
from ..models.transformer import TransformerLM
from ..ops.gemv import quantize_decode_params, tree_to
from .paged_cache import PagedKVCache, init_paged_cache, paged_forward
from .pool import PagePool
from .prefix_cache import empty_prefix_fields
from .scheduler import (
    ContinuousScheduler,
    Request,
    StaticScheduler,
    scheduler_digest,
    tenant_block,
)

def request_record(r: Request, mode: str) -> dict:
    """One request as an obs `request` field dict (the reference's
    shape). Aborted requests carry null latencies where the moment never
    happened."""
    return {
        "id": r.rid,
        "mode": mode,
        "status": r.status,
        "tenant": r.tenant or "default",
        "prompt_tokens": int(r.prompt.size),
        "max_new_tokens": int(r.max_new_tokens),
        "output_tokens": len(r.out),
        "ttft_ms": (None if r.first_token_at is None
                    else round(1e3 * (r.first_token_at - r.arrival), 3)),
        "latency_ms": (None if r.finished_at is None
                       else round(1e3 * (r.finished_at - r.arrival), 3)),
        "arrival_s": round(r.arrival, 4),
        "queue_wait_ms": (None if r.admitted_at is None
                          else round(1e3 * (r.admitted_at - r.arrival), 3)),
        "queue_wait_quota_ms": round(1e3 * r.quota_wait_s, 3),
        "preemptions": r.preemptions,
        **({"reason": r.fail_reason} if r.fail_reason else {}),
    }


@dataclasses.dataclass
class ServeResult:
    """One engine run: every submitted request in a terminal status plus
    the aggregate counters the bench reports."""

    mode: str
    requests: list[Request]
    decode_ticks: int
    prefill_chunks: int
    preemptions: int
    duration_s: float
    events: list[dict] = dataclasses.field(default_factory=list)
    watchdog_slow_ticks: int = 0
    # Always zero here (sharing and speculation are not ported), kept so
    # the summary carries the reference's keys.
    prefix: dict = dataclasses.field(default_factory=empty_prefix_fields)
    spec: dict = dataclasses.field(default_factory=lambda: {
        "spec_rounds": 0, "spec_proposed": 0, "spec_accepted": 0})
    # crc32 chained over every iteration's scheduler state digest.
    state_crc: int = 0

    @property
    def finished_requests(self) -> list[Request]:
        return [r for r in self.requests if r.status == "finished"]

    @property
    def output_tokens(self) -> int:
        return sum(len(r.out) for r in self.requests)

    @property
    def tokens_per_s(self) -> float:
        return self.output_tokens / max(self.duration_s, 1e-9)

    def status_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for r in self.requests:
            counts[r.status] = counts.get(r.status, 0) + 1
        return counts

    def ttft_ms(self) -> list[float]:
        return [1e3 * (r.first_token_at - r.arrival)
                for r in self.finished_requests]

    def tpot_ms(self) -> list[float]:
        return [
            1e3 * (r.finished_at - r.first_token_at) / max(len(r.out) - 1, 1)
            for r in self.finished_requests
        ]

    def request_records(self) -> list[dict]:
        return [request_record(r, self.mode)
                for r in sorted(self.requests, key=lambda r: r.rid)]

    def summary(self) -> dict:
        from ..obs.metrics import pct_nearest

        ttft, tpot = self.ttft_ms(), self.tpot_ms()
        return {
            "mode": self.mode,
            "requests": len(self.requests),
            "statuses": self.status_counts(),
            "output_tokens": self.output_tokens,
            "decode_ticks": self.decode_ticks,
            "prefill_chunks": self.prefill_chunks,
            "preemptions": self.preemptions,
            "watchdog_slow_ticks": self.watchdog_slow_ticks,
            "duration_s": round(self.duration_s, 4),
            "tokens_per_s": round(self.tokens_per_s, 2),
            "state_crc": self.state_crc,
            "ttft_p50_ms": pct_nearest(ttft, 50),
            "ttft_p99_ms": pct_nearest(ttft, 99),
            "tpot_p50_ms": pct_nearest(tpot, 50),
            "tpot_p99_ms": pct_nearest(tpot, 99),
            **self.prefix,
            **self.spec,
            "tenants": tenant_block(self.requests),
        }


def _refuse(**options) -> None:
    """Raise NotImplementedError naming every set option this package
    does not serve yet."""
    on = sorted(name for name, val in options.items() if val)
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: not ported to the PyTorch engine yet "
            "(see ROADMAP.md)")


class PagedEngine:
    """Greedy serving engine over a paged KV cache.

    slots bounds the decode batch; num_pages * page_size tokens is the
    TOTAL cache budget shared by all in-flight sequences (page 0 is
    scratch); max_len bounds any one sequence and sizes the block table.
    `attn_kernel` picks the paged read ("gather" or "cuda"),
    `weights_dtype` converts the decode weights once at construction
    ("auto" routes via pick_weights_dtype). `device` defaults to CUDA;
    pass "cpu" to run on the CPU (every kernel wrapper then takes its
    plain version).
    """

    def __init__(self, model: TransformerLM, params, *, slots: int = 4,
                 num_pages: int = 64, page_size: int = 16,
                 prefill_chunk: int = 32, cache_dtype="float32",
                 max_len: int | None = None, attn_kernel: str = "gather",
                 weights_dtype: str = "float32", spec: str = "off",
                 draft_model: TransformerLM | None = None,
                 device: str | torch.device | None = None):
        _refuse(spec=spec != "off", draft_model=draft_model is not None)
        self.device = resolve_device(device)
        self.model = model
        self.slots = slots
        self.page_size = page_size
        self.num_pages = num_pages
        self.prefill_chunk = prefill_chunk
        self.weights_dtype = pick_weights_dtype(
            weights_dtype, heads=model.heads, kv_heads=model.n_kv)
        # One-time conversion: the hot loop only ever reads this form.
        self.params = quantize_decode_params(tree_to(params, self.device),
                                             self.weights_dtype)
        self.attn_kernel = attn_kernel
        if isinstance(cache_dtype, str):
            cache_dtype = CACHE_DTYPES[pick_cache_dtype(
                cache_dtype, heads=model.heads, kv_heads=model.n_kv)]
        self.cache_dtype = cache_dtype
        self.max_len = min(max_len or model.max_seq, model.max_seq)
        self._cache = init_paged_cache(
            model, slots=slots, num_pages=num_pages, page_size=page_size,
            dtype=cache_dtype, max_len=self.max_len, kernel=attn_kernel,
            device=self.device)
        self._table_width = self._cache.block_table.shape[1]
        self._chunk_offsets = torch.arange(prefill_chunk, device=self.device,
                                           dtype=torch.int32)

    # -- host-side helpers ------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _cache_view(self, table: np.ndarray) -> PagedKVCache:
        return dataclasses.replace(self._cache,
                                   block_table=self._tensor(table))

    def _emit(self, slot, tok: int, now: float) -> None:
        req = slot.req
        req.out.append(tok)
        if req.first_token_at is None:
            req.first_token_at = now

    @torch.no_grad()
    def run_prefill_chunk(self, slot):
        """Advance `slot`'s prefill by one chunk. Returns (rows written,
        next-token argmax of the chunk's last valid row as a 0-d device
        tensor — the first generated token iff this chunk completes the
        prefill). The caller converts it only on the completing chunk."""
        ctx = np.concatenate(
            [slot.req.prompt, np.asarray(slot.req.out, np.int32)])
        n = min(self.prefill_chunk, slot.target - slot.cached)
        toks = np.zeros((1, self.prefill_chunk), np.int64)
        toks[0, :n] = ctx[slot.cached: slot.cached + n]
        table = np.zeros((1, self._table_width), np.int32)
        table[0, : len(slot.pages)] = slot.pages
        positions = (slot.cached + self._chunk_offsets)[None, :]
        valid = (self._chunk_offsets < n)[None, :]
        logits, _ = paged_forward(self.model, self.params, self._tensor(toks),
                                  positions, valid, self._cache_view(table))
        return n, torch.argmax(logits[0, max(n - 1, 0)])

    @torch.no_grad()
    def run_decode_tick(self, dslots) -> np.ndarray:
        """One batched decode tick over `dslots` (every other engine row
        rides along dead). Returns the per-row sampled tokens (index by
        slot.idx); cached/emit bookkeeping is the caller's."""
        toks = np.zeros((self.slots, 1), np.int64)
        pos = np.zeros((self.slots, 1), np.int32)
        live = np.zeros((self.slots, 1), bool)
        table = np.zeros((self.slots, self._table_width), np.int32)
        for s in dslots:
            toks[s.idx, 0] = s.req.out[-1]
            pos[s.idx, 0] = s.cached
            live[s.idx, 0] = True
            table[s.idx, : len(s.pages)] = s.pages
        logits, _ = paged_forward(self.model, self.params, self._tensor(toks),
                                  self._tensor(pos), self._tensor(live),
                                  self._cache_view(table))
        # One host transfer per batched tick.
        return torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()

    def run(self, requests: list[Request], *, mode: str = "continuous",
            time_fn=time.perf_counter, max_queue: int | None = None,
            watchdog_s: float = 0.0, sleep_fn=time.sleep, faults=None,
            registry=None, tick_sink=None, prefix: bool = False,
            policy=None, spec: bool = False,
            host_pages: int = 0) -> ServeResult:
        """Serve `requests` to a terminal status each; return ServeResult.

        Requests are mutated in place (out/timestamps/status); arrivals
        and deadlines are seconds relative to run start on `time_fn`'s
        clock — the loop idles (sleep_fn) until the next arrival when
        there is nothing admitted to work on. watchdog_s > 0 counts
        iterations slower than that budget."""
        _refuse(faults=faults is not None, registry=registry is not None,
                tick_sink=tick_sink is not None, prefix=prefix,
                policy=policy is not None, spec=spec, host_pages=host_pages)
        pool = PagePool(self.num_pages)
        sched_kw = dict(slots=self.slots, pool=pool,
                        page_size=self.page_size, max_len=self.max_len,
                        max_queue=max_queue)
        if mode == "continuous":
            sched = ContinuousScheduler(**sched_kw)
        elif mode == "static":
            sched = StaticScheduler(**sched_kw)
        else:
            raise ValueError(f"mode {mode!r}: want 'continuous' or 'static'")
        sched.submit(requests)
        n_reqs = sched.unfinished
        decode_ticks = prefill_chunks = 0
        state_chain = 0
        events: list[dict] = []
        failed_logged: set[int] = set()  # rids with a request_failed event
        watchdog_slow = 0
        tick_idx = 0
        t0 = time_fn()
        while sched.unfinished:
            iter_t0 = time_fn()
            now = time_fn() - t0
            for r in sched.sweep(now):
                events.append({"kind": f"request_{r.status}", "id": r.rid,
                               "mode": mode, "t_rel": round(now, 4)})
            sched.admit(now)
            # Backpressure AFTER admission: the bound applies to what
            # remains waiting once free slots have been filled.
            for r in sched.enforce_queue_bound(now):
                events.append({"kind": "request_rejected", "id": r.rid,
                               "mode": mode, "t_rel": round(now, 4)})
            progressed = False

            # At most ONE prefill chunk per iteration: long prompts
            # advance without starving in-flight decodes.
            slot = sched.prefill_slot()
            if slot is not None:
                n, nxt = self.run_prefill_chunk(slot)
                slot.cached += n
                prefill_chunks += 1
                progressed = True
                if slot.cached >= slot.target:
                    # Prefill complete: the chunk's last valid logits
                    # give the first generated token now. Continuous
                    # batching releases a request done at its first
                    # token; static holds it until the batch drains.
                    self._emit(slot, int(nxt), time_fn() - t0)
                    if slot.req.done and isinstance(sched,
                                                    ContinuousScheduler):
                        sched.finish(slot, time_fn() - t0)

            dslots = sched.grow_for_decode(time_fn() - t0)
            for r in sched.dropped:
                # admit/grow_for_decode may have failed a livelocked
                # request; log each rid once.
                if r.status == "failed" and r.rid not in failed_logged:
                    failed_logged.add(r.rid)
                    events.append({"kind": "request_failed", "id": r.rid,
                                   "mode": mode, "reason": r.fail_reason})
            if dslots:
                nxt = self.run_decode_tick(dslots)
                decode_ticks += 1
                now = time_fn() - t0
                for s in dslots:
                    s.cached += 1
                    self._emit(s, int(nxt[s.idx]), now)
                    if s.req.done and isinstance(sched, ContinuousScheduler):
                        sched.finish(s, now)
                progressed = True

            if isinstance(sched, StaticScheduler) and sched.batch_done():
                sched.drain(time_fn() - t0)
                progressed = True

            # The watchdog window closes before the idle wait below.
            busy_s = time_fn() - iter_t0

            if not progressed and sched.unfinished:
                nxt_arrival = sched.next_arrival()
                now = time_fn() - t0
                if nxt_arrival is None:
                    raise RuntimeError("scheduler stalled with no queue")
                if nxt_arrival <= now:
                    raise RuntimeError(
                        f"request {sched.queue[0].rid} cannot be "
                        f"admitted into an idle engine — page pool "
                        f"({self.num_pages} pages of {self.page_size})"
                        " too small"
                    )
                sleep_fn(min(nxt_arrival - now, 0.05))
            if watchdog_s > 0 and busy_s > watchdog_s:
                watchdog_slow += 1
                events.append({
                    "kind": "watchdog_slow_tick", "tick": tick_idx,
                    "mode": mode, "seconds": round(busy_s, 4),
                })
            # The reference's per-iteration bookkeeping order: drain the
            # preemption/blocked logs, then digest and chain.
            sched.drain_preempted()
            sched.drain_blocked()
            state_crc = scheduler_digest(sched, extra=(0, 0))
            state_chain = zlib.crc32(state_crc.to_bytes(4, "little"),
                                     state_chain)
            sched.check()
            tick_idx += 1

        sched.check()
        terminal = sched.finished + sched.dropped
        if len(terminal) != n_reqs:
            raise RuntimeError(
                f"run lost requests: {len(terminal)} of {n_reqs} reached "
                "a terminal status"
            )
        assert sched.pool.free_pages == sched.pool.usable, "pages leaked"
        return ServeResult(
            mode=mode, requests=terminal, decode_ticks=decode_ticks,
            prefill_chunks=prefill_chunks, preemptions=sched.preemptions,
            duration_s=time_fn() - t0, events=events,
            watchdog_slow_ticks=watchdog_slow, state_crc=state_chain,
        )
