"""Batched speculative decoding policy, the host half (a copy of the JAX
package's `serve/spec.py`, numpy only).

Per tick every decoding slot proposes up to k - 1 draft tokens, ONE
batched verify forward scores every slot's k candidate rows, and greedy
acceptance commits 1..k tokens per slot. This module holds the proposal
(prompt lookup over the request's committed context), the acceptance
law and the round scaffold `run_round`; the verify forward is the
engine's (`PagedEngine.run_spec_tick`) and the page accounting the
scheduler's (`grow_for_decode(spec_k=)`, `spec_width`, `commit_spec`).

At temperature 0 (the engine's only sampling) the emitted stream is the
target's own greedy continuation for ANY proposer, so spec-on outputs
equal spec-off outputs per request wherever the verify block's logits
equal the decode tick's.
"""

from __future__ import annotations

import numpy as np

# "off" (one token per slot per tick), "lookup" (draft-free prompt
# lookup), "draft" (a cheap draft model behind the same interface).
SPEC_MODES = ("off", "lookup", "draft")

_EMPTY = np.empty(0, np.int32)


def empty_spec_fields() -> dict:
    """The zero-valued speculative summary block a spec-off run stamps,
    so every summary carries the same keys."""
    return {"spec_rounds": 0, "spec_proposed": 0, "spec_accepted": 0}


def accept_len(u: np.ndarray, y: np.ndarray) -> int:
    """The greedy acceptance law: u holds the w verify inputs (u[0] the
    slot's current committed token, u[1:] the proposals), y the target's
    per-row greedy picks (y[i] = argmax of the logits after input i).
    Accept the longest prefix where proposal u[i+1] equals y[i]; the
    emitted count is j = 1 + that prefix (row j-1 is the first-reject
    replacement or the fully-accepted bonus row)."""
    w = len(u)
    j = 1
    while j < w and u[j] == y[j - 1]:
        j += 1
    return j


def lookup_propose(ctx: np.ndarray, n_props: int, ngram: int = 2) -> np.ndarray:
    """Draft-free prompt-lookup proposal over the committed context
    (prompt + emitted tokens): the n_props tokens that followed the MOST
    RECENT earlier occurrence of the context's ngram-token tail. No
    earlier occurrence: repeat the current token; a match too close to
    the end pads by repeating the last available token."""
    if n_props <= 0:
        return _EMPTY
    ctx = np.asarray(ctx, np.int32).reshape(-1)
    n = ctx.size
    cur = ctx[-1]
    if n <= ngram:
        return np.full(n_props, cur, np.int32)
    # Candidate match ends j in [ngram-1, n-2]: the ngram ending at j
    # equals the ngram ending at n-1 (the tail itself is excluded).
    ok = ctx[ngram - 1 : n - 1] == cur
    for d in range(1, ngram):
        ok &= ctx[ngram - 1 - d : n - 1 - d] == ctx[n - 1 - d]
    rev = ok[::-1]
    i = int(np.argmax(rev))       # first True from the END = most recent
    if not rev[i]:
        return np.full(n_props, cur, np.int32)
    j = (ngram - 1) + (ok.size - 1 - i)
    props = ctx[j + 1 : j + 1 + n_props]
    if props.size < n_props:
        pad_tok = props[-1] if props.size else cur
        props = np.concatenate(
            [props, np.full(n_props - props.size, pad_tok, np.int32)]
        )
    return props.astype(np.int32)


class LookupProposer:
    """The draft-free per-slot proposer: stateless and host-side."""

    def __init__(self, ngram: int = 2):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1 (got {ngram})")
        self.ngram = ngram

    def propose_batch(self, ctxs, n_props):
        """The batched proposer interface `run_round` drives."""
        return [lookup_propose(c, n, self.ngram)
                for c, n in zip(ctxs, n_props)]


def context_tokens(req) -> np.ndarray:
    """The request's committed context (prompt + emitted tokens) as one
    int32 array, cached incrementally on the request: a private growing
    buffer appends only the tokens emitted since the last call, and any
    shrink of `out` rebuilds it. Callers treat the view as read-only."""
    out = req.out
    n = req.prompt.size + len(out)
    buf = getattr(req, "_spec_ctx", None)
    filled = getattr(req, "_spec_ctx_fill", 0)
    if buf is None or buf.shape[0] < n or filled > n:
        cap = max(2 * n, 64)
        buf = np.empty(cap, np.int32)
        buf[: req.prompt.size] = req.prompt
        filled = req.prompt.size
        req._spec_ctx = buf
    if filled < n:
        buf[filled:n] = out[filled - req.prompt.size :]
    req._spec_ctx_fill = n
    return buf[:n]


def run_round(dslots, widths, proposer, verify):
    """One speculative round over the tick's decoding slots:

    1. per slot, propose width-1 draft tokens from its committed context
       and assemble the verify inputs u = [current token, proposals]
       (a width-1 slot verifies just its current token: the spec-off
       tick for that slot);
    2. `verify(rounds)` scores ALL slots' inputs in ONE batched forward
       (rounds: [(slot, u, width)]) and returns each slot's per-row
       greedy picks;
    3. greedy acceptance (`accept_len`) per slot.

    Returns [(slot, width, j, emitted tokens)]; the caller emits, commits
    through `scheduler.commit_spec` and finishes done requests. A
    proposer with `needs_slots = True` (the paged draft) gets the slot
    handles too, and every slot's real context even at zero proposals
    (its cache must track the committed stream)."""
    need = [w - 1 for w in widths]
    if getattr(proposer, "needs_slots", False):
        ctxs = [context_tokens(s.req) for s in dslots]
        props_list = proposer.propose_batch(ctxs, need, dslots)
    else:
        ctxs = [context_tokens(s.req) if n > 0 else _EMPTY
                for s, n in zip(dslots, need)]
        props_list = proposer.propose_batch(ctxs, need)
    rounds = []
    for s, w, props in zip(dslots, widths, props_list):
        u = np.empty(w, np.int32)
        u[0] = s.req.out[-1]
        u[1:] = props
        rounds.append((s, u, w))
    ys = verify(rounds)
    out = []
    for (s, u, w), y in zip(rounds, ys):
        j = accept_len(u, y)
        out.append((s, w, j, [int(y[i]) for i in range(j)]))
    return out
