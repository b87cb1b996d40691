"""Prefix-sharing KV cache: a hash-keyed prefix tree over pages with
copy-on-write and LRU retention.

A copy of the JAX package's `serve/prefix_cache.py` without the fleet's
routing keys. The continuous schedulers hold one when the engine runs
with `prefix=True`, and its stat tuple (with the host tier's, when one
is attached) enters the per-tick state digest.

The tree: one node per FULL page of prompt tokens, keyed by
(parent, tokens-bytes). Matching walks full chunks of the prompt; at the
first non-exact chunk the best longest-common-prefix child is shared
copy-on-write. Tree pages are owned by the cache (`PREFIX_OWNER`),
frozen read-only at adoption, reference-counted per reader, and evicted
in LRU order once no reader holds them. With a host tier
(`serve/host_tier.py`) an evicted page spills to host memory instead of
being discarded, and a later walk that misses in the tree readmits it.
Everything here is host-side and deterministic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .host_tier import empty_tier_fields
from .pool import PagePool

PREFIX_OWNER = "__prefix__"


class PrefixNode:
    """One shared page of prompt KV: `tokens` are the page_size prompt
    tokens it covers, `page` the physical page index, `children` the
    continuations keyed by their tokens-bytes. `path` is the CUMULATIVE
    prefix bytes root..this node inclusive: the host tier's spill key,
    which a later request computes from its own prompt alone."""

    __slots__ = ("node_id", "tokens", "page", "children", "parent_map",
                 "key", "last_used", "path")

    def __init__(self, node_id: int, tokens: np.ndarray, page: int,
                 parent_map: dict, key: bytes, path: bytes = b""):
        self.node_id = node_id
        self.tokens = tokens
        self.page = page
        self.children: dict[bytes, PrefixNode] = {}
        self.parent_map = parent_map
        self.key = key
        self.last_used = 0
        self.path = path


@dataclasses.dataclass
class Acquisition:
    """One admission's prefix match: `nodes` are the fully matched
    pages (reader references held, in position order), `cow` the
    partially matched page to copy-on-write (a transient reference is
    held until the copy completes or the slot releases), `cow_valid`
    how many of its tokens match, `matched` the total matched tokens
    (= len(nodes) * page_size + cow_valid)."""

    nodes: list[PrefixNode]
    cow: PrefixNode | None
    cow_valid: int
    matched: int


def _lcp(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.size, b.size)
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class PrefixCache:
    """The prefix tree + its policy: acquire (match & reference),
    insert (adopt a finished prefill's full prompt pages), release,
    and LRU reclaim. One instance per scheduler/pool pair — per
    replica in the fleet (each replica owns its pool)."""

    def __init__(self, pool: PagePool, page_size: int, tier=None):
        self.pool = pool
        self.page_size = page_size
        # Optional host spill tier; None discards on reclaim.
        self.tier = tier
        self.root_children: dict[bytes, PrefixNode] = {}
        self.nodes: dict[int, PrefixNode] = {}     # node_id -> node
        self._next_id = 0
        self._clock = 0
        self.stats = {"hits": 0, "misses": 0, "hit_tokens": 0,
                      "cow_copies": 0, "inserts": 0, "evictions": 0}
        # Per-tick telemetry, drained by the engine each iteration.
        self._tick_hits: list[list[int]] = []
        self._tick_readmits: list[list[int]] = []
        self._tick_deltas = {"cow": 0, "evictions": 0, "inserts": 0}

    @property
    def shared_pages(self) -> int:
        return len(self.nodes)

    def retained_pages(self) -> int:
        """Refcount-0 resident tree pages (the LRU-reclaimable set)."""
        return sum(1 for n in self.nodes.values()
                   if self.pool.refs(n.page) == 0)

    def drain_tick(self) -> dict:
        """This tick's prefix moments: hits [[rid, matched_tokens]],
        cow/eviction/insert deltas since the last drain and, with a host
        tier, the readmissions [[rid, prefix_tokens]]."""
        out = {"hits": self._tick_hits, **self._tick_deltas}
        if self.tier is not None:
            out["readmits"] = self._tick_readmits
            self._tick_readmits = []
        self._tick_hits = []
        self._tick_deltas = {"cow": 0, "evictions": 0, "inserts": 0}
        return out

    # -- bookkeeping helpers --------------------------------------------

    def _touch(self, node: PrefixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    # -- matching -------------------------------------------------------

    def acquire(self, prompt: np.ndarray, rid, *,
                max_tokens: int) -> Acquisition:
        """Match `prompt` against the tree and take reader references
        on every shared page. The match is capped at `max_tokens`
        (callers pass context-1: at least one token must always be
        computed so the completing prefill chunk yields the first
        generated token)."""
        ps = self.page_size
        toks = np.asarray(prompt, np.int32).reshape(-1)
        nodes: list[PrefixNode] = []
        children = self.root_children
        cow: PrefixNode | None = None
        j = 0
        i = 0
        while True:
            chunk = toks[i * ps:(i + 1) * ps]
            if chunk.size == ps:
                node = children.get(chunk.tobytes())
                if node is None and self.tier is not None \
                        and (i + 1) * ps <= max_tokens:
                    node = self._readmit(toks, i, chunk, children, rid)
                if node is not None:
                    nodes.append(node)
                    children = node.children
                    i += 1
                    continue
            # Divergent or partial final chunk: best-lcp child becomes
            # the copy-on-write source (deterministic tie-break on key).
            best, bestj = None, 0
            for key in sorted(children):
                cand = children[key]
                n = _lcp(chunk, cand.tokens)
                if n > bestj:
                    best, bestj = cand, n
            if bestj > 0:
                cow, j = best, bestj
            break
        matched = len(nodes) * ps + j
        if matched > max_tokens:
            target = max(max_tokens, 0)
            f2, j2 = divmod(target, ps)
            if j2 > 0:
                cow = nodes[f2] if f2 < len(nodes) else cow
                j = j2
            else:
                cow, j = None, 0
            nodes = nodes[:f2]
            matched = target
        if cow is not None and j == 0:
            cow = None
        for node in nodes:
            self.pool.share(node.page, rid)
            self._touch(node)
        if cow is not None:
            self.pool.share(cow.page, ("cow", rid))
            self._touch(cow)
        return Acquisition(nodes=nodes, cow=cow, cow_valid=j,
                           matched=matched)

    def _readmit(self, toks: np.ndarray, i: int, chunk: np.ndarray,
                 children: dict, rid) -> PrefixNode | None:
        """The tier consult on a tree miss at chunk i: look the
        cumulative prefix up in the host tier, CRC-verify it against the
        requesting prompt's chunk, allocate a fresh read-only device
        page, restore the KV rows and re-insert the node. None on a host
        miss, a CRC refusal (counted by the tier) or a dry device pool
        (readmission never preempts live work)."""
        ps = self.page_size
        key = toks[:(i + 1) * ps].tobytes()
        entry = self.tier.lookup(key, chunk)
        if entry is None:
            return None
        pages = self.pool.try_alloc(1, PREFIX_OWNER)
        if pages is None:
            return None
        page = pages[0]
        self.pool.freeze(page, PREFIX_OWNER)
        self.tier.take(entry, page)
        self._next_id += 1
        node = PrefixNode(self._next_id, chunk.copy(), page,
                          children, chunk.tobytes(), key)
        children[node.key] = node
        self.nodes[node.node_id] = node
        self._tick_readmits.append([rid, (i + 1) * ps])
        return node

    def note_admitted(self, acq: Acquisition, rid) -> None:
        """Count one ADMITTED acquisition (the scheduler calls this at
        bind time, not at acquire time): hits + misses equals
        admissions, and a page-blocked head retried every tick leaves
        no phantom counts behind."""
        if acq.matched > 0:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += acq.matched
            self._tick_hits.append([rid, acq.matched])
        else:
            self.stats["misses"] += 1

    def release(self, nodes: list[PrefixNode], rid) -> None:
        """Return a slot's reader references (slot release/preempt).
        Pages stay resident — refcount-0 nodes are retained for future
        hits until reclaim evicts them."""
        for node in nodes:
            self.pool.unshare(node.page, rid)
            self._touch(node)

    def cow_done(self, node: PrefixNode, rid) -> None:
        """The engine copied the shared page into the slot's private
        page: drop the transient source reference and count the copy."""
        self.pool.unshare(node.page, ("cow", rid))
        self._touch(node)
        self.stats["cow_copies"] += 1
        self._tick_deltas["cow"] += 1

    def cow_abandon(self, node: PrefixNode, rid) -> None:
        """The slot released before its first write (preempt/abort):
        drop the transient source reference without counting a copy."""
        self.pool.unshare(node.page, ("cow", rid))
        self._touch(node)

    # -- insertion ------------------------------------------------------

    def insert(self, prompt: np.ndarray, slot) -> None:
        """Adopt the slot's full PROMPT pages into the tree at prefill
        completion. Pages already matched (the slot's refs) are walked
        through; a chunk whose node exists under a different physical
        page (two same-prefix requests prefilled concurrently) keeps
        the slot's private duplicate and continues under the existing
        node; a new chunk's private page is adopted read-only, the
        slot becomes its first reader."""
        ps = self.page_size
        toks = np.asarray(prompt, np.int32).reshape(-1)
        rid = slot.req.rid
        children = self.root_children
        for c in range(toks.size // ps):
            chunk = toks[c * ps:(c + 1) * ps]
            key = chunk.tobytes()
            node = children.get(key)
            if node is None:
                page = slot.pages[c]
                if self.pool.is_shared(page):
                    # The slot's page at this position is already a
                    # tree page (its node sits on another path after a
                    # COW branch) — never re-adopt someone's page.
                    break
                self.pool.adopt(page, rid, PREFIX_OWNER, readonly=True)
                self.pool.share(page, rid)
                self._next_id += 1
                node = PrefixNode(self._next_id, chunk.copy(), page,
                                  children, key,
                                  toks[:(c + 1) * ps].tobytes())
                children[key] = node
                self.nodes[node.node_id] = node
                slot.refs.append(page)
                slot.prefix_nodes.append(node)
                self.stats["inserts"] += 1
                self._tick_deltas["inserts"] += 1
            self._touch(node)
            children = node.children

    # -- reclaim --------------------------------------------------------

    def reclaim(self, n: int) -> int:
        """Free up to `n` pages by evicting refcount-0 LEAF nodes in
        LRU order (oldest last_used first, node_id tie-break). Only
        unreferenced pages are ever freed — a page a live slot reads
        through its block table always holds a reference. Returns the
        number of pages actually freed."""
        freed = 0
        while freed < n:
            cands = [node for node in self.nodes.values()
                     if not node.children and self.pool.refs(node.page) == 0]
            if not cands:
                break
            victim = min(cands, key=lambda nd: (nd.last_used, nd.node_id))
            self._evict(victim)
            freed += 1
        return freed

    def _evict(self, node: PrefixNode, *, spill: bool = True) -> None:
        if spill and self.tier is not None:
            # Spill BEFORE the device page is freed, while its content
            # is still addressable.
            self.tier.spill(node.path, node.tokens, node.page)
        self.pool.free([node.page], PREFIX_OWNER)
        del node.parent_map[node.key]
        del self.nodes[node.node_id]
        self.stats["evictions"] += 1
        self._tick_deltas["evictions"] += 1

    def clear(self) -> int:
        """Evict every reclaimable node (end-of-run: hand all retained
        pages back so the pool's all-free exit invariant holds). Not
        allocation pressure: nothing spills.
        Returns pages freed; raises if any node is still referenced."""
        freed = 0
        while self.nodes:
            cands = [node for node in self.nodes.values()
                     if not node.children
                     and self.pool.refs(node.page) == 0]
            if not cands:
                break
            victim = min(cands, key=lambda nd: (nd.last_used, nd.node_id))
            self._evict(victim, spill=False)
            freed += 1
        if self.nodes:
            raise RuntimeError(
                f"{len(self.nodes)} prefix page(s) still referenced at "
                "clear() — a slot leaked its reader references"
            )
        return freed

    def digest_tuple(self) -> tuple:
        """The prefix cache's contribution to the per-tick state digest
        (scheduler.scheduler_digest): seven ints in the reference's
        order, plus the host tier's five when one is attached."""
        t = (len(self.nodes), self.stats["hits"], self.stats["misses"],
             self.stats["hit_tokens"], self.stats["cow_copies"],
             self.stats["inserts"], self.stats["evictions"])
        if self.tier is not None:
            t += self.tier.digest_tuple()
        return t

    def summary_fields(self) -> dict:
        """Cumulative stats as the flat serve-summary keys, plus the
        host-tier counters (zeros with no tier)."""
        return {
            "prefix_hits": self.stats["hits"],
            "prefix_misses": self.stats["misses"],
            "prefix_hit_tokens": self.stats["hit_tokens"],
            "prefix_cow": self.stats["cow_copies"],
            "prefix_inserts": self.stats["inserts"],
            "prefix_evictions": self.stats["evictions"],
            **(self.tier.summary_fields() if self.tier is not None
               else empty_tier_fields()),
        }


def empty_prefix_fields() -> dict:
    """The zero-valued summary block a sharing-off run stamps."""
    return {"prefix_hits": 0, "prefix_misses": 0, "prefix_hit_tokens": 0,
            "prefix_cow": 0, "prefix_inserts": 0, "prefix_evictions": 0,
            **empty_tier_fields()}
