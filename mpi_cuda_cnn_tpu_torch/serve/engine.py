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

A speculative engine (spec="lookup"/"draft") adds a third step, the
batched verify block: every slot's k candidate rows at per-slot positions
through the same `paged_forward`, rows past a slot's round width riding
along valid=False. `serve/spec.py` proposes and accepts; the scheduler
grows pages toward k and rolls rejected rows' pages back. The draft
model proposes through a sliding window (`DraftProposer`: one (slots, W)
forward a proposal step) or its own paged cache (`PagedDraftProposer`).

Sampling is greedy. MoE models serve through `token_forward`'s MoE
branch (every expert, no drop; the expert weights stay float32 under
int8 decode weights). The host loop (`run`) is the reference's, one
scheduler iteration per pass: faults at "serve.tick" -> sweep deadlines/
cancellations -> admit -> enforce the queue bound -> at most one prefill
chunk (after its copy-on-write page copy, under prefix sharing) -> one
decode tick or speculative round over every decoding slot; the
per-iteration state digest is chained into `state_crc` exactly as the
reference does, so the two engines can be held to equal schedules.
Prefix sharing, the host spill tier (`serve/host_tier.py`), the SLO
scheduler, injected faults, the metrics registry and the per-tick record
sink are all `run` options. `adopt_pages` copies pages across engines,
for the fleet's prefill-to-decode handoff (`serve/fleet.py`).
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
from .host_tier import TIER_SPILL_SITE, HostTier
from .paged_cache import PagedKVCache, init_paged_cache, paged_forward
from .pool import PagePool, pages_for
from .prefix_cache import PrefixCache, empty_prefix_fields
from .scheduler import (
    ContinuousScheduler,
    Request,
    SLOPolicy,
    SLOScheduler,
    StaticScheduler,
    scheduler_digest,
    tenant_block,
    terminal_fields,
)
from .spec import SPEC_MODES, LookupProposer, empty_spec_fields, run_round

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
    # Prefix-cache and host-tier counters, zeros with sharing off.
    prefix: dict = dataclasses.field(default_factory=empty_prefix_fields)
    # Speculative rounds run, draft tokens proposed and accepted.
    spec: dict = dataclasses.field(default_factory=empty_spec_fields)
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




def _observe_request(registry, r: Request) -> None:
    """Fold one terminal request into the registry: a per-status counter
    plus the latency histograms (ServeResult's formulas). Null moments
    are skipped. A tagged tenant also lands in `serve.tenant.<name>.*`
    twins of every metric."""
    prefixes = ["serve."]
    if r.tenant is not None:
        prefixes.append(f"serve.tenant.{r.tenant}.")
    for p in prefixes:
        registry.inc(f"{p}requests_{r.status}")
        if r.admitted_at is not None:
            registry.observe(f"{p}queue_wait_ms",
                             1e3 * (r.admitted_at - r.arrival))
        if r.quota_wait_s > 0:
            # The SLO scheduler's skip-over share of the wait, observed
            # only when nonzero.
            registry.observe(f"{p}queue_wait_quota_ms",
                             1e3 * r.quota_wait_s)
        if r.status != "finished":
            continue
        registry.observe(f"{p}ttft_ms",
                         1e3 * (r.first_token_at - r.arrival))
        registry.observe(
            f"{p}tpot_ms",
            1e3 * (r.finished_at - r.first_token_at) / max(len(r.out) - 1, 1),
        )


class DraftProposer:
    """The window draft: a cheap draft model proposes each slot's
    candidate tokens by greedy argmax over a sliding WINDOW of the
    request's committed context, with no cache of its own. Proposal step
    i runs ONE (batch, W) forward of `TransformerLM.apply` for every slot
    at once (its weight products through `qmatmul`, so int8 weights take
    the int8 kernel) and one host transfer. `forwards` counts them."""

    def __init__(self, model: TransformerLM, params, *, window: int = 32,
                 batch: int = 1, device: torch.device):
        self.model = model
        self.window = min(window, model.max_seq)
        self.batch = batch
        self.params = params
        self.device = device
        self.forwards = 0

    @torch.no_grad()
    def _step(self, toks: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
        # Full causal forward over the padded windows; each row's pick is
        # the argmax after its last VALID position (the causal mask keeps
        # the pad tail out of that logit).
        logits = self.model.apply(
            self.params, torch.from_numpy(toks).to(self.device),
            moe_inference=True)
        self.forwards += 1
        picks = torch.argmax(logits, dim=-1)                 # (B, W)
        idx = torch.from_numpy(np.maximum(n_valid - 1, 0)).to(self.device)
        return picks.gather(1, idx[:, None])[:, 0].cpu().numpy()

    def propose_batch(self, ctxs, n_props):
        """Per-slot proposals for one round, drafted in lockstep (rows
        past a slot's own width ride along; their picks are dropped)."""
        n_max = max(n_props, default=0)
        if n_max == 0:
            return [np.empty(0, np.int32) for _ in ctxs]
        if len(ctxs) > self.batch:
            raise ValueError(
                f"{len(ctxs)} draft contexts exceed batch {self.batch}")
        w = self.window
        bufs = [[int(t) for t in c[-w:]] for c in ctxs]
        outs = [[] for _ in ctxs]
        for step_i in range(n_max):
            toks = np.zeros((self.batch, w), np.int64)
            n_valid = np.ones((self.batch,), np.int64)
            for i, buf in enumerate(bufs):
                win = buf[-w:]
                toks[i, : len(win)] = win
                n_valid[i] = max(len(win), 1)
            picks = self._step(toks, n_valid)
            for i, buf in enumerate(bufs):
                if step_i < n_props[i]:
                    t = int(picks[i])
                    outs[i].append(t)
                    buf.append(t)
        return [np.asarray(o, np.int32) for o in outs]


class PagedDraftProposer:
    """The paged draft: the draft model keeps its own PagePool and
    per-slot block tables, growing and rolling back in lockstep with the
    target's `commit_spec`.

    Per round and slot it runs CATCH-UP (the tokens committed since its
    last round, in batched chunks) plus n single-token proposal steps
    against its own pages, then TRIMS each slot's pages back to the
    committed context, so a rejected draft token's KV is never live.
    Proposal rows inside the kept partial page are overwritten before
    they are read (writes land first; the causal mask hides the rest).

    After a slot's round the draft holds exactly pages_for(committed
    rows) pages; a slot's state persists across release and resets on
    the next rid change or context shrink; the pool is sized to slots x
    pages_for(max_len) + 1, so the serving schedule never depends on it.
    `forwards` counts its paged forwards (catch-up chunks and steps)."""

    # run_round feeds slot identities and every slot's context.
    needs_slots = True

    def __init__(self, model: TransformerLM, params, *, slots: int,
                 page_size: int, max_len: int, cache_dtype=torch.float32,
                 chunk: int = 32, attn_kernel: str = "gather",
                 device: torch.device):
        self.model = model
        self.params = params
        self.slots = slots
        self.page_size = page_size
        self.max_len = min(max_len, model.max_seq)
        self.table_width = pages_for(self.max_len, page_size)
        self.chunk = chunk
        self.device = device
        self.forwards = 0
        self.pool = PagePool(slots * self.table_width + 1)
        self._cache = init_paged_cache(
            model, slots=slots, num_pages=slots * self.table_width + 1,
            page_size=page_size, dtype=cache_dtype, max_len=self.max_len,
            kernel=attn_kernel, device=device)
        self._offsets = torch.arange(chunk, device=device, dtype=torch.int32)
        # Per-slot state, indexed by ENGINE slot idx: the rid the rows
        # belong to, committed rows held, physical pages.
        self._rid: list = [None] * slots
        self._cached = [0] * slots
        self._spages: list[list[int]] = [[] for _ in range(slots)]

    @property
    def tracked(self) -> int:
        """Slots carrying draft-cache state (the digest's count)."""
        return sum(1 for r in self._rid if r is not None)

    def _owner(self, idx: int) -> tuple:
        return ("draft", idx)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _reset(self, idx: int, rid) -> None:
        if self._spages[idx]:
            self.pool.free(self._spages[idx], self._owner(idx))
        self._rid[idx] = rid
        self._cached[idx] = 0
        self._spages[idx] = []

    def _ensure_pages(self, idx: int, rows: int) -> None:
        need = pages_for(rows, self.page_size) - len(self._spages[idx])
        if need > 0:
            got = self.pool.try_alloc(need, self._owner(idx))
            assert got is not None, "draft pool sized to full coverage"
            self._spages[idx].extend(got)

    def _trim(self, idx: int, rows: int) -> None:
        keep = pages_for(rows, self.page_size)
        extra = self._spages[idx][keep:]
        if extra:
            self.pool.free(extra, self._owner(idx))
            del self._spages[idx][keep:]

    def end_run(self) -> None:
        """Release every slot's draft pages and prove the pool clean."""
        for idx in range(self.slots):
            if self._spages[idx]:
                self.pool.free(self._spages[idx], self._owner(idx))
            self._rid[idx] = None
            self._cached[idx] = 0
            self._spages[idx] = []
        self.pool.check()
        assert self.pool.free_pages == self.pool.usable, \
            "draft pages leaked"

    @torch.no_grad()
    def propose_batch(self, ctxs, n_props, dslots):
        """One paged draft round over this tick's decoding slots: reset
        stale state, grow each table to cover catch-up + proposal rows,
        run batched catch-up chunks then n single-token steps, and trim
        every slot back to its committed rows."""
        outs = [np.empty(0, np.int32) for _ in ctxs]
        work = []       # (idx, ctx, n, committed_rows)
        for s, ctx, n in zip(dslots, ctxs, n_props):
            idx = s.idx
            rows = len(ctx) - 1     # committed KV rows the draft holds
            if self._rid[idx] != s.req.rid or self._cached[idx] > rows:
                self._reset(idx, s.req.rid)
            self._ensure_pages(idx, rows + max(n, 0))
            work.append((idx, ctx, n, rows))
        table = np.zeros((self.slots, self.table_width), np.int32)
        for idx, _, _, _ in work:
            table[idx, : len(self._spages[idx])] = self._spages[idx]
        cache = dataclasses.replace(self._cache,
                                    block_table=self._tensor(table))
        # Batched catch-up: every behind slot advances `chunk` rows per
        # forward until all hold their committed rows.
        while True:
            toks = np.zeros((self.slots, self.chunk), np.int64)
            pos0 = np.zeros((self.slots, 1), np.int32)
            n_valid = np.zeros((self.slots, 1), np.int32)
            behind = False
            for idx, ctx, _, rows in work:
                got = self._cached[idx]
                if got >= rows:
                    continue
                n = min(self.chunk, rows - got)
                toks[idx, :n] = ctx[got : got + n]
                pos0[idx] = got
                n_valid[idx] = n
                self._cached[idx] = got + n
                behind = True
            if not behind:
                break
            pos0_t = self._tensor(pos0)
            paged_forward(self.model, self.params, self._tensor(toks),
                          pos0_t + self._offsets[None, :],
                          self._offsets[None, :] < self._tensor(n_valid),
                          cache)
            self.forwards += 1
        # n proposal steps, batched across slots: step t feeds the
        # previous pick (step 1: the last committed token) at position
        # rows + t - 1, writing that row and reading the prefix below.
        n_max = max(n_props, default=0)
        if n_max > 0:
            cur = np.zeros((self.slots, 1), np.int64)
            pos = np.zeros((self.slots, 1), np.int32)
            for idx, ctx, n, rows in work:
                cur[idx] = ctx[-1]
                pos[idx] = rows
            for t in range(n_max):
                live = np.zeros((self.slots, 1), bool)
                for idx, ctx, n, rows in work:
                    live[idx] = t < n
                logits, _ = paged_forward(
                    self.model, self.params, self._tensor(cur),
                    self._tensor(pos), self._tensor(live), cache)
                self.forwards += 1
                # The sanctioned sync: one host transfer per batched
                # draft step (every slot's pick in one array).
                # mctpu: disable=MCT007
                picks = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
                for i, (idx, ctx, n, rows) in enumerate(work):
                    if t < n:
                        outs[i] = np.append(outs[i], np.int32(picks[idx]))
                        cur[idx] = picks[idx]
                        pos[idx] += 1
        # Roll back to committed rows (commit_spec's twin).
        for idx, ctx, n, rows in work:
            self._trim(idx, rows)
            self._cached[idx] = rows
        return [np.asarray(o, np.int32) for o in outs]


class PagedEngine:
    """Greedy serving engine over a paged KV cache.

    slots bounds the decode batch; num_pages * page_size tokens is the
    TOTAL cache budget shared by all in-flight sequences (page 0 is
    scratch); max_len bounds any one sequence and sizes the block table.
    `attn_kernel` picks the paged read ("gather" or "cuda"),
    `weights_dtype` converts the decode weights once at construction
    ("auto" routes via pick_weights_dtype). `spec` ("off", "lookup",
    "draft") sets up the verify block of `spec_k` rows; "draft" needs
    `draft_model` + `draft_params` (same vocab), proposing through a
    sliding window (`draft_cache="window"`) or its own paged cache
    ("paged"). `device` defaults to CUDA; pass "cpu" to run on the CPU
    (every kernel wrapper then takes its plain version).
    """

    def __init__(self, model: TransformerLM, params, *, slots: int = 4,
                 num_pages: int = 64, page_size: int = 16,
                 prefill_chunk: int = 32, cache_dtype="float32",
                 max_len: int | None = None, attn_kernel: str = "gather",
                 weights_dtype: str = "float32", spec: str = "off",
                 spec_k: int = 8, spec_ngram: int = 2,
                 draft_model: TransformerLM | None = None,
                 draft_params=None, draft_cache: str = "window",
                 device: str | torch.device | None = None):
        if spec not in SPEC_MODES:
            raise ValueError(f"spec {spec!r}: want one of {SPEC_MODES}")
        if draft_cache not in ("window", "paged"):
            raise ValueError(
                f"draft_cache {draft_cache!r}: want 'window' or 'paged'")
        if spec != "off" and spec_k < 2:
            raise ValueError(
                f"spec_k must be >= 2 (k={spec_k} would propose nothing)")
        if spec == "draft":
            if draft_model is None or draft_params is None:
                raise ValueError(
                    "spec='draft' needs draft_model + draft_params")
            if draft_model.vocab != model.vocab:
                raise ValueError(
                    f"target vocab {model.vocab} != draft vocab "
                    f"{draft_model.vocab}")
        self.device = resolve_device(device)
        self.spec_mode = spec
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.draft_cache = draft_cache
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
        self._spec_offsets = torch.arange(spec_k, device=self.device,
                                          dtype=torch.int32)
        self._draft_proposer = None
        if spec == "draft":
            dparams = quantize_decode_params(
                tree_to(draft_params, self.device), self.weights_dtype)
            if draft_cache == "paged":
                self._draft_proposer = PagedDraftProposer(
                    draft_model, dparams, slots=slots, page_size=page_size,
                    max_len=self.max_len, cache_dtype=cache_dtype,
                    chunk=prefill_chunk, attn_kernel=attn_kernel,
                    device=self.device)
            else:
                self._draft_proposer = DraftProposer(
                    draft_model, dparams, batch=slots, device=self.device)

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
    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate page `src` into page `dst` in every
        layer's pools (keys and values, int8 scales included). The
        caller releases the shared source's reference afterwards
        (scheduler.cow_complete)."""
        for c in self._cache.pages:
            for t in c.values():
                t[dst].copy_(t[src])

    def spill_page(self, page: int) -> list[dict]:
        """One device page's KV rows (every layer's keys/values and int8
        scales) copied to host memory: HostTier's spill_fn, called before
        the pool frees the page."""
        return [{name: t[page].to("cpu", copy=True) for name, t in c.items()}
                for c in self._cache.pages]

    @torch.no_grad()
    def readmit_page(self, page: int, payload: list[dict]) -> None:
        """Restore a spilled page's host rows into device page `page`:
        HostTier's readmit_fn, called only after the CRC check accepted
        the entry."""
        for c, h in zip(self._cache.pages, payload):
            for name, t in c.items():
                t[page].copy_(h[name])

    @torch.no_grad()
    def adopt_pages(self, src_engine: PagedEngine, src_pages,
                    dst_pages) -> None:
        """Adopt KV page content from another engine's pools (the fleet's
        prefill-to-decode handoff): the sender's rows at `src_pages` land
        at this engine's `dst_pages`, every layer's keys and values (and
        int8 scales) together, as one indexed copy per pool tensor on the
        device. Both engines must share the cache geometry; the fleet
        builds every replica from one model and configuration, which is
        also what makes the handed-off decode equal the unified one."""
        if (src_engine.page_size != self.page_size
                or src_engine.cache_dtype != self.cache_dtype
                or len(src_engine._cache.pages) != len(self._cache.pages)):
            src_dtype = str(src_engine.cache_dtype).removeprefix("torch.")
            dtype = str(self.cache_dtype).removeprefix("torch.")
            raise ValueError(
                "adopt_pages across mismatched cache geometries "
                f"(page_size {src_engine.page_size} vs {self.page_size}, "
                f"dtype {src_dtype} vs {dtype})"
            )
        if len(src_pages) != len(dst_pages):
            raise ValueError(
                f"adopt_pages: {len(src_pages)} source pages vs "
                f"{len(dst_pages)} destinations"
            )
        if not src_pages:
            return
        src = torch.tensor(list(src_pages), dtype=torch.long,
                           device=src_engine.device)
        dst = torch.tensor(list(dst_pages), dtype=torch.long,
                           device=self.device)
        for c, sc in zip(self._cache.pages, src_engine._cache.pages):
            for name, t in c.items():
                t.index_copy_(0, dst, sc[name].index_select(0, src).to(
                    t.device))

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
        # The sanctioned sync: one host transfer per batched tick.
        # mctpu: disable=MCT007
        return torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()

    @torch.no_grad()
    def run_spec_tick(self, rounds):
        """ONE batched speculative verify over this tick's rounds
        (spec.run_round's [(slot, u, width)]): each slot's inputs land in
        its own engine row at positions [cached, cached + width); rows
        past a slot's width, and every dead slot, ride along valid=False
        with their writes routed to the scratch page. Returns each
        slot's per-row greedy picks."""
        kk = self.spec_k
        toks = np.zeros((self.slots, kk), np.int64)
        pos = np.zeros((self.slots, 1), np.int32)
        valid = np.zeros((self.slots, kk), bool)
        table = np.zeros((self.slots, self._table_width), np.int32)
        for s, u, w in rounds:
            toks[s.idx, :w] = u
            pos[s.idx] = s.cached
            valid[s.idx, :w] = True
            table[s.idx, : len(s.pages)] = s.pages
        positions = self._tensor(pos) + self._spec_offsets[None, :]
        logits, _ = paged_forward(self.model, self.params, self._tensor(toks),
                                  positions, self._tensor(valid),
                                  self._cache_view(table))
        # The sanctioned sync: one host transfer per batched verify
        # round.
        # mctpu: disable=MCT007
        picks = torch.argmax(logits, dim=-1).cpu().numpy()
        return [picks[s.idx, :w] for s, _, w in rounds]

    def run(self, requests: list[Request], *, mode: str = "continuous",
            time_fn=time.perf_counter, faults=None,
            max_queue: int | None = None, watchdog_s: float = 0.0,
            sleep_fn=time.sleep, registry=None, tick_sink=None,
            prefix: bool = False, policy: SLOPolicy | None = None,
            spec: bool = False, host_pages: int = 0) -> ServeResult:
        """Serve `requests` to a terminal status each; return ServeResult.

        Requests are mutated in place (out/timestamps/status); arrivals
        and deadlines are seconds relative to run start on `time_fn`'s
        clock — the loop idles (sleep_fn) until the next arrival when
        there is nothing admitted to work on. `faults` (a
        faults.FaultInjector) fires at "serve.tick" with the iteration
        index (squeeze steals pages for a window of ticks, slow stalls
        the tick, crash and io raise) and polls "tier.spill" with the
        spill sequence (kv_corrupt); watchdog_s > 0 counts iterations
        slower than that budget. `registry` (obs.metrics.MetricsRegistry)
        gets per-tick gauges and per-request histograms; `tick_sink`
        gets each iteration's tick record.

        `prefix=True` puts a PrefixCache over the run's pool (a request
        sharing cached prefix pages prefills only its suffix);
        `host_pages > 0` (with prefix) spills reclaimed prefix pages to a
        host tier of that many pages and readmits them on a later hit;
        `policy` upgrades continuous batching to the SLOScheduler;
        `spec=True` (on an engine built with spec="lookup"/"draft")
        replaces the decode tick with a speculative round. All four are
        iteration-level: continuous batching only.
        """
        if spec and self.spec_mode == "off":
            raise ValueError(
                "run(spec=True) on an engine constructed with "
                "spec='off' — pass spec='lookup' or 'draft' at "
                "construction (the verify program compiles there)"
            )
        if spec and mode != "continuous":
            raise ValueError(
                "speculative decoding is iteration-level — continuous "
                "batching only (static is the one-token-per-tick "
                "reservation baseline)"
            )
        if host_pages > 0 and not prefix:
            raise ValueError(
                "host_pages > 0 without prefix=True — the host tier "
                "spills prefix-cache pages; there is nothing to spill"
            )
        if host_pages == 0 and faults is not None:
            # Without a host tier no spill ever happens, so a tier.spill
            # fault would silently never fire.
            inert = [f"{f.kind}@{f.site}"
                     for f in faults.pending(TIER_SPILL_SITE)]
            if inert:
                raise ValueError(
                    f"fault(s) {', '.join(sorted(set(inert)))} need a "
                    "host tier (--spill / host_pages > 0) — without one "
                    "they would silently never fire"
                )
        pool = PagePool(self.num_pages)
        tier = None
        if host_pages > 0:
            tier = HostTier(
                host_pages, spill_fn=self.spill_page,
                readmit_fn=self.readmit_page,
                fault_poll=((lambda seq: faults.poll(TIER_SPILL_SITE, seq))
                            if faults is not None else None),
            )
        pcache = PrefixCache(pool, self.page_size, tier) if prefix else None
        proposer = None
        if spec:
            proposer = (self._draft_proposer if self.spec_mode == "draft"
                        else LookupProposer(self.spec_ngram))
        draft_paged = isinstance(proposer, PagedDraftProposer)
        spec_rounds = spec_proposed = spec_accepted = 0
        sched_kw = dict(slots=self.slots, pool=pool,
                        page_size=self.page_size, max_len=self.max_len,
                        max_queue=max_queue, prefix=pcache)
        if mode == "continuous":
            if policy is not None:
                sched = SLOScheduler(policy=policy, **sched_kw)
            else:
                sched = ContinuousScheduler(**sched_kw)
        elif mode == "static":
            if prefix or policy is not None:
                raise ValueError(
                    "prefix sharing / SLO policy apply to continuous "
                    "batching only — static is the reservation baseline"
                )
            sched = StaticScheduler(**{**sched_kw, "prefix": None})
        else:
            raise ValueError(f"mode {mode!r}: want 'continuous' or 'static'")
        sched.submit(requests)
        n_reqs = sched.unfinished
        decode_ticks = prefill_chunks = 0
        state_chain = 0
        # Digest framing: spec off (0, 0), lookup or window draft (1, k);
        # a paged draft extends it with its pool state each tick.
        spec_extra = (1, self.spec_k) if spec else (0, 0)
        events: list[dict] = []
        failed_logged: set[int] = set()  # rids with a request_failed event
        watchdog_slow = 0
        squeezes: list[dict] = []  # {"pages": [...], "until": tick}
        tick_idx = 0
        want_ticks = registry is not None or tick_sink is not None
        # Each tick record names the rids whose arrival fell due since
        # the last one.
        arrivals = sorted((r.arrival, r.rid) for r in requests)
        arr_cursor = 0
        # sched.finished / sched.dropped are append-only: the new tail
        # since the last iteration is this tick's terminal set.
        n_fin_seen = n_drop_seen = 0
        t0 = time_fn()
        while sched.unfinished:
            iter_t0 = time_fn()
            if faults is not None:
                for f in faults.fire("serve.tick", tick_idx):
                    if f.kind == "squeeze":
                        # Steal up to `pages` pages for `ticks` ticks,
                        # ownership-checked like any sequence's.
                        want = int(f.arg("pages", 1))
                        got = sched.pool.try_alloc(
                            min(want, sched.pool.free_pages),
                            f"_fault_squeeze_{tick_idx}",
                        ) or []
                        squeezes.append({
                            "pages": got,
                            "owner": f"_fault_squeeze_{tick_idx}",
                            "until": tick_idx + int(f.arg("ticks", 1)),
                        })
                    elif f.kind == "slow":
                        faults.sleep(float(f.arg("s", 0.05)))
                events.extend(faults.drain_events())
            for sq in [s for s in squeezes if s["until"] <= tick_idx]:
                if sq["pages"]:
                    sched.pool.free(sq["pages"], sq["owner"])
                squeezes.remove(sq)
            now = time_fn() - t0
            for r in sched.sweep(now):
                events.append({"kind": f"request_{r.status}", "id": r.rid,
                               "mode": mode, "t_rel": round(now, 4)})
            admitted = [[s.idx, s.req.rid] for s in sched.admit(now)]
            # Backpressure AFTER admission: the bound applies to what
            # remains waiting once free slots have been filled.
            for r in sched.enforce_queue_bound(now):
                events.append({"kind": "request_rejected", "id": r.rid,
                               "mode": mode, "t_rel": round(now, 4)})
            progressed = False
            prefill_rec = None

            # At most ONE prefill chunk per iteration: long prompts
            # advance without starving in-flight decodes.
            slot = sched.prefill_slot()
            if slot is not None:
                if slot.cow is not None:
                    # Copy the partially matched shared page into the
                    # slot's private page BEFORE its first write there.
                    self.copy_page(*slot.cow)
                    sched.cow_complete(slot)
                n, nxt = self.run_prefill_chunk(slot)
                slot.cached += n
                prefill_chunks += 1
                prefill_rec = [slot.idx, slot.req.rid, n]
                progressed = True
                if slot.cached >= slot.target:
                    # Prefill complete: the prompt's pages become
                    # adoptable into the prefix tree, and the chunk's
                    # last valid logits give the first generated token.
                    # Continuous batching releases a request done at its
                    # first token; static holds it until the batch
                    # drains.
                    sched.note_prefill_complete(slot)
                    # The sanctioned sync: int() only on the completing
                    # chunk, where the token is emitted; mid-prompt
                    # chunks leave the device tensor untouched.
                    # mctpu: disable=MCT007
                    self._emit(slot, int(nxt), time_fn() - t0)
                    prefill_rec.append("emit")
                    if slot.req.done and isinstance(sched,
                                                    ContinuousScheduler):
                        sched.finish(slot, time_fn() - t0)

            dslots = sched.grow_for_decode(
                time_fn() - t0, spec_k=self.spec_k if spec else 1)
            decoded = [[s.idx, s.req.rid] for s in dslots]
            for r in sched.dropped:
                # admit/grow_for_decode may have failed a livelocked
                # request; log each rid once.
                if r.status == "failed" and r.rid not in failed_logged:
                    failed_logged.add(r.rid)
                    events.append({"kind": "request_failed", "id": r.rid,
                                   "mode": mode, "reason": r.fail_reason})
            spec_rec = None
            emitted_decode = 0
            if dslots and spec:
                # Speculative round: propose per slot, ONE batched
                # verify block, greedy acceptance; each slot commits
                # 1..k tokens and commit_spec rolls rejected pages back.
                widths = [sched.spec_width(s, self.spec_k) for s in dslots]
                results = run_round(dslots, widths, proposer,
                                    self.run_spec_tick)
                decode_ticks += 1
                now = time_fn() - t0
                spec_rec = []
                for s, w, j, toks_out in results:
                    sched.commit_spec(s, j)
                    for t in toks_out:
                        self._emit(s, t, now)
                    emitted_decode += j
                    spec_rec.append([s.req.rid, w - 1, j - 1])
                    spec_rounds += 1
                    spec_proposed += w - 1
                    spec_accepted += j - 1
                    if registry is not None:
                        registry.observe("serve.spec.accepted", j - 1)
                    if s.req.done and isinstance(sched, ContinuousScheduler):
                        sched.finish(s, now)
                progressed = True
            elif dslots:
                nxt = self.run_decode_tick(dslots)
                decode_ticks += 1
                now = time_fn() - t0
                for s in dslots:
                    s.cached += 1
                    self._emit(s, int(nxt[s.idx]), now)
                    if s.req.done and isinstance(sched, ContinuousScheduler):
                        sched.finish(s, now)
                emitted_decode = len(dslots)
                progressed = True

            if isinstance(sched, StaticScheduler) and sched.batch_done():
                sched.drain(time_fn() - t0)
                progressed = True

            # The watchdog window closes before the idle wait below.
            busy_s = time_fn() - iter_t0

            if not progressed and sched.unfinished:
                nxt_arrival = sched.next_arrival()
                now = time_fn() - t0
                if squeezes:
                    # An injected squeeze holds the pages the next step
                    # needs: idle one tick until it lifts.
                    sleep_fn(0.001)
                elif nxt_arrival is None:
                    raise RuntimeError("scheduler stalled with no queue")
                elif nxt_arrival <= now:
                    raise RuntimeError(
                        f"request {sched.queue[0].rid} cannot be "
                        f"admitted into an idle engine — page pool "
                        f"({self.num_pages} pages of {self.page_size})"
                        " too small"
                    )
                else:
                    sleep_fn(min(nxt_arrival - now, 0.05))
            if watchdog_s > 0 and busy_s > watchdog_s:
                watchdog_slow += 1
                if registry is not None:
                    registry.inc("serve.watchdog_slow_ticks")
                events.append({
                    "kind": "watchdog_slow_tick", "tick": tick_idx,
                    "mode": mode, "seconds": round(busy_s, 4),
                })
            # The reference's per-iteration bookkeeping order: drain the
            # preemption/blocked logs and the prefix tick, then digest
            # and chain.
            preempted_pairs = sched.drain_preempted()
            preempted = [v for v, _ in preempted_pairs]
            blocked = sched.drain_blocked()
            prefix_tick = pcache.drain_tick() if pcache is not None else None
            if draft_paged:
                spec_extra = (1, self.spec_k, 1,
                              proposer.pool.free_pages, proposer.tracked)
            state_crc = scheduler_digest(sched, extra=spec_extra)
            state_chain = zlib.crc32(state_crc.to_bytes(4, "little"),
                                     state_chain)
            if not want_ticks:
                sched.check()
                tick_idx += 1
                continue
            # The tick record: this iteration's scheduling moments and
            # end-of-iteration gauges, built only when asked for.
            new_fin = sched.finished[n_fin_seen:]
            new_drop = sched.dropped[n_drop_seen:]
            n_fin_seen, n_drop_seen = len(sched.finished), len(sched.dropped)
            now = time_fn() - t0
            arrived_now = []
            while arr_cursor < len(arrivals) and \
                    arrivals[arr_cursor][0] <= now:
                arrived_now.append(arrivals[arr_cursor][1])
                arr_cursor += 1
            arrived_waiting = sum(1 for r in sched.queue if r.arrival <= now)
            running = sum(1 for s in sched.slots if not s.free)
            prefilling = sum(1 for s in sched.slots
                             if s.prefilling and not s.req.terminal)
            backlog = sched.prefill_backlog()
            tick_rec = {
                "tick": tick_idx, "now": round(now, 4), "mode": mode,
                "queue": arrived_waiting, "running": running,
                "prefilling": prefilling,
                "free_pages": sched.pool.free_pages, "backlog": backlog,
                "arrived": arrived_now,
                "admitted": admitted, "prefill": prefill_rec,
                "decoded": decoded,
                "finished": [r.rid for r in new_fin],
                "aborted": [[r.rid, r.status] for r in new_drop],
                "preempted": preempted,
                "blocked": [[rid, reason, holders]
                            for rid, reason, holders in blocked],
                "preempted_for": [[v, b] for v, b in preempted_pairs
                                  if b is not None],
                "terminal": [terminal_fields(r) for r in new_fin + new_drop],
                "state_crc": state_crc,
            }
            if squeezes:
                tick_rec["squeezed"] = sum(len(sq["pages"])
                                           for sq in squeezes)
            if spec_rec is not None:
                # [rid, proposed, accepted] per slot.
                tick_rec["spec"] = spec_rec
            if prefix_tick is not None:
                tick_rec["prefix_hits"] = prefix_tick["hits"]
                tick_rec["prefix"] = {
                    "shared_pages": pcache.shared_pages,
                    "retained_pages": pcache.retained_pages(),
                    **pcache.stats,
                }
                if tier is not None:
                    tick_rec["prefix"].update(tier.stats)
                    tick_rec["prefix"]["host_used"] = tier.host_used
                    tick_rec["prefix_readmits"] = prefix_tick["readmits"]
            if tick_sink is not None:
                tick_sink(tick_rec)
            if registry is not None:
                registry.set("serve.queue_depth", arrived_waiting)
                registry.set("serve.running_slots", running)
                registry.set("serve.prefilling_slots", prefilling)
                registry.set("serve.free_pages", sched.pool.free_pages)
                registry.set("serve.prefill_backlog", backlog)
                if decoded:
                    registry.inc("serve.decode_ticks")
                if prefill_rec is not None:
                    registry.inc("serve.prefill_chunks")
                emitted = emitted_decode + (1 if prefill_rec is not None
                                            and prefill_rec[-1] == "emit"
                                            else 0)
                if emitted:
                    registry.inc("serve.tokens_emitted", emitted)
                if spec_rec:
                    registry.inc("serve.spec.rounds", len(spec_rec))
                    registry.inc("serve.spec.proposed",
                                 sum(p for _, p, _ in spec_rec))
                    registry.inc("serve.spec.accepted_total",
                                 sum(a for _, _, a in spec_rec))
                if preempted:
                    registry.inc("serve.preemptions", len(preempted))
                if prefix_tick is not None:
                    if prefix_tick["hits"]:
                        registry.inc("serve.prefix.hits",
                                     len(prefix_tick["hits"]))
                        registry.inc("serve.prefix.hit_tokens",
                                     sum(m for _, m in prefix_tick["hits"]))
                    for key in ("cow", "evictions", "inserts"):
                        if prefix_tick[key]:
                            registry.inc(f"serve.prefix.{key}",
                                         prefix_tick[key])
                    registry.set("serve.prefix.shared_pages",
                                 pcache.shared_pages)
                    registry.set("serve.prefix.retained_pages",
                                 pcache.retained_pages())
                    if tier is not None:
                        # The tier accumulates; the gauges mirror it.
                        for key, val in tier.stats.items():
                            registry.set(f"serve.tier.{key}", val)
                        registry.set("serve.tier.host_used",
                                     tier.host_used)
                for r in new_fin + new_drop:
                    _observe_request(registry, r)
            sched.check()
            tick_idx += 1

        # Release any squeeze that outlived the workload, evict every
        # retained prefix page (teardown never spills), then prove the
        # pool clean.
        for sq in squeezes:
            if sq["pages"]:
                sched.pool.free(sq["pages"], sq["owner"])
        prefix_fields = empty_prefix_fields()
        if pcache is not None:
            prefix_fields = pcache.summary_fields()
            pcache.clear()
        if draft_paged:
            proposer.end_run()
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
            watchdog_slow_ticks=watchdog_slow, prefix=prefix_fields,
            spec={"spec_rounds": spec_rounds, "spec_proposed": spec_proposed,
                  "spec_accepted": spec_accepted},
            state_crc=state_chain,
        )
