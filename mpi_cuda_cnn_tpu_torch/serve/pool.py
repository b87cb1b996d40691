"""Host-side page accounting for the paged KV cache.

A copy of the JAX package's `serve/pool.py`: pure Python, no tensors.
The scheduler and the prefix cache allocate through it; the device-side
pools live in `serve/paged_cache.py`.
"""

from __future__ import annotations


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold `tokens` cache entries (ceil)."""
    return -(-tokens // page_size)


class PagePool:
    """Host-side page accounting: which physical page belongs to which
    owner. Page 0 is the reserved scratch page and is never issued.

    The pool is the safety layer under the scheduler: alloc hands out
    each page exactly once, free verifies ownership (a double free or a
    free of someone else's page raises instead of silently corrupting a
    neighbor sequence), and `check()` asserts the global invariant
    free + allocated == usable after any admit/finish/preempt sequence
    (tests/test_serve.py drives it through all three).

    Prefix sharing adds REFCOUNTED READ-ONLY pages on top of
    the exclusive-owner model: `adopt(..., readonly=True)` transfers a
    full prompt page to the prefix cache and freezes it, `share`/
    `unshare` grant and return per-reader references, and `free`
    refuses any page with live readers. `check()` now also proves
    refcount conservation (every reader entry sits on an owned,
    read-only page, no duplicate grants) and that no writable page is
    ever shared — the copy-on-write safety story in one invariant.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"num_pages {num_pages} < 2 (page 0 is scratch)")
        self.num_pages = num_pages
        # Pop from the end -> pages issue in ascending order
        # (deterministic layouts for tests and debugging).
        self._free = list(range(num_pages - 1, 0, -1))
        self._owner: dict[int, object] = {}
        self._readers: dict[int, list] = {}   # page -> live reader refs
        self._ro: set[int] = set()            # read-only (shareable) pages

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def owned_by(self, owner) -> list[int]:
        return [p for p, o in self._owner.items() if o == owner]

    def try_alloc(self, n: int, owner) -> list[int] | None:
        """n pages for `owner`, or None (and no change) if the pool
        cannot cover the request — admission control's primitive."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = owner
        return pages

    def free(self, pages: list[int], owner) -> None:
        for p in pages:
            got = self._owner.get(p)
            if got is None:
                raise RuntimeError(f"double free of page {p} (owner {owner})")
            if got != owner:
                raise RuntimeError(
                    f"page {p} is owned by {got}, not {owner} — refusing "
                    "to free another sequence's page"
                )
            if self._readers.get(p):
                raise RuntimeError(
                    f"page {p} still has {len(self._readers[p])} live "
                    f"reader(s) — refusing to free a shared page"
                )
        for p in pages:
            del self._owner[p]
            self._ro.discard(p)
            self._free.append(p)

    # -- refcounted sharing -----------------------------------

    def adopt(self, page: int, old_owner, new_owner, *,
              readonly: bool = False) -> None:
        """Transfer one page's ownership (slot -> prefix cache at
        insert time). readonly=True freezes it: from here on it can be
        shared but never written or handed to a writer again."""
        got = self._owner.get(page)
        if got != old_owner:
            raise RuntimeError(
                f"page {page} is owned by {got}, not {old_owner} — "
                "refusing the ownership transfer"
            )
        self._owner[page] = new_owner
        if readonly:
            self._ro.add(page)

    def freeze(self, page: int, owner) -> None:
        """Mark an owned page read-only WITHOUT an ownership transfer —
        the host-tier readmission primitive: the prefix
        cache allocates a fresh device page under its own owner and
        freezes it before restoring spilled content, so the page enters
        the shareable set under the same no-writable-page-shared
        invariant adopt(readonly=True) provides at insert time."""
        got = self._owner.get(page)
        if got != owner:
            raise RuntimeError(
                f"page {page} is owned by {got}, not {owner} — "
                "refusing to freeze it"
            )
        self._ro.add(page)

    def share(self, page: int, reader) -> None:
        """Grant `reader` one reference on a read-only page. Sharing a
        writable page is the corruption this layer exists to prevent —
        it raises."""
        if page not in self._owner:
            raise RuntimeError(f"cannot share unowned page {page}")
        if page not in self._ro:
            raise RuntimeError(
                f"page {page} is writable — refusing to share it "
                "(adopt it read-only first)"
            )
        rl = self._readers.setdefault(page, [])
        if reader in rl:
            raise RuntimeError(
                f"reader {reader} already holds a reference on page {page}"
            )
        rl.append(reader)

    def unshare(self, page: int, reader) -> None:
        """Return `reader`'s reference on a shared page (ownership-
        checked like free: a foreign or double unshare raises)."""
        rl = self._readers.get(page)
        if rl is None or reader not in rl:
            raise RuntimeError(
                f"reader {reader} holds no reference on page {page}"
            )
        rl.remove(reader)
        if not rl:
            del self._readers[page]

    def refs(self, page: int) -> int:
        return len(self._readers.get(page, ()))

    def is_shared(self, page: int) -> bool:
        return page in self._ro

    def check(self) -> None:
        """The no-leak / no-double-book invariant, extended
        with refcount conservation and the no-writable-shared-page
        guarantee."""
        assert len(self._free) + len(self._owner) == self.usable, (
            f"page leak: {len(self._free)} free + {len(self._owner)} "
            f"owned != {self.usable} usable"
        )
        assert not (set(self._free) & set(self._owner)), "page double-booked"
        assert 0 not in self._owner and 0 not in self._free, (
            "scratch page 0 entered circulation"
        )
        # Refcount conservation: every reader entry sits on an owned
        # page, lists are non-empty (emptied lists are deleted), and no
        # reader holds two references on one page.
        for p, rl in self._readers.items():
            assert p in self._owner, f"readers on unowned page {p}"
            assert rl, f"empty reader list retained for page {p}"
            assert len(rl) == len({id(r) if isinstance(r, (list, dict))
                                   else r for r in rl}), (
                f"duplicate reader reference on page {p}"
            )
        # No writable page is ever shared; read-only pages are owned.
        assert set(self._readers) <= self._ro, "writable page shared"
        assert self._ro <= set(self._owner), "read-only page not owned"
