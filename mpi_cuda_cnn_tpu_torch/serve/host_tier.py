"""Host-memory spill tier for refcount-0 prefix pages (a copy of the JAX
package's `serve/host_tier.py` without the fleet's routing keys).

- SPILL: when LRU pressure evicts a refcount-0 leaf of the prefix tree,
  the page's token chunk, an integrity stamp and (under an engine) the
  device page's KV rows move to the host tier before the device page is
  freed, keyed by the CUMULATIVE token prefix the page covers.
- READMIT: a prefix walk that misses in the device tree consults the
  tier; a hit allocates a device page, restores the KV rows, re-inserts
  the tree node, and the walk goes on sharing.
- REFUSE: each spill stamps the crc32 of the int32 token ids the page
  covers; readmission recomputes it from the REQUESTING prompt and
  refuses on a mismatch (`kv_corrupt@tier.spill` models a torn spill):
  the entry is dropped and counted, and the request re-prefills.

The tier holds at most `host_pages` entries with its own LRU; spilling
into a full tier evicts the oldest entry (counted). Host-side and
deterministic; its counters enter the per-tick state digest.
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = ["HostTier", "TIER_SPILL_SITE", "chunk_crc", "empty_tier_fields"]

# The polled fault site: trigger value = the tier's own spill sequence
# number; kind kv_corrupt flips the stamped CRC.
TIER_SPILL_SITE = "tier.spill"

# Flip known bits so the verify arithmetic, not luck, refuses.
_CORRUPT_MASK = 0x5A5A5A5A


def chunk_crc(tokens: np.ndarray) -> int:
    """One page's integrity stamp: crc32 over the int32 token ids whose
    KV rows the page holds."""
    return zlib.crc32(np.asarray(tokens, np.int32).tobytes())


def empty_tier_fields() -> dict:
    """The zero-valued summary block a spill-off run stamps."""
    return {"tier_spills": 0, "tier_readmits": 0, "tier_refusals": 0,
            "tier_host_evictions": 0}


class _Entry:
    """One spilled page: its prefix-path key, the chunk's token ids, the
    seal-time CRC and the opaque host KV payload (None for a tier with
    no callbacks)."""

    __slots__ = ("key", "tokens", "crc", "payload", "seq")

    def __init__(self, key: bytes, tokens: np.ndarray, crc: int,
                 payload, seq: int):
        self.key = key
        self.tokens = tokens
        self.crc = crc
        self.payload = payload
        self.seq = seq


class HostTier:
    """The bounded host tier, one per scheduler/pool pair.

    `spill_fn(page) -> payload` fetches a device page's KV rows to host
    memory at spill time; `readmit_fn(page, payload)` restores them into
    a freshly allocated device page. Both None: pure accounting.
    `fault_poll(seq) -> faults` is the injection hook
    (FaultInjector.poll("tier.spill", seq)); kv_corrupt flips the stored
    stamp."""

    def __init__(self, host_pages: int, *, spill_fn=None, readmit_fn=None,
                 fault_poll=None):
        if host_pages < 1:
            raise ValueError(f"host_pages must be >= 1 (got {host_pages})")
        self.host_pages = host_pages
        self.spill_fn = spill_fn
        self.readmit_fn = readmit_fn
        self.fault_poll = fault_poll
        self._entries: dict[bytes, _Entry] = {}
        self._seq = 0          # spill sequence number (the fault trigger)
        self._clock = 0        # host-LRU clock
        self.stats = {"spills": 0, "readmits": 0, "refusals": 0,
                      "host_evictions": 0}

    @property
    def host_used(self) -> int:
        return len(self._entries)

    def spill(self, path_key: bytes, tokens: np.ndarray, page: int) -> None:
        """Accept one evicted page: seal (stamp + device fetch), store
        under the cumulative prefix key, evicting the host-LRU entry
        first when full. Called BEFORE the device page is freed."""
        crc = chunk_crc(tokens)
        if self.fault_poll is not None:
            for f in self.fault_poll(self._seq):
                if f.kind != "kv_corrupt":
                    raise ValueError(
                        f"fault kind {f.kind!r} is inert at tier.spill"
                    )
                crc ^= _CORRUPT_MASK
        self._seq += 1
        payload = self.spill_fn(page) if self.spill_fn is not None else None
        if path_key in self._entries:
            # Re-spill after a readmission: the newer seal replaces the
            # entry in place (occupancy unchanged).
            del self._entries[path_key]
        elif len(self._entries) >= self.host_pages:
            victim = min(self._entries.values(), key=lambda e: e.seq)
            del self._entries[victim.key]
            self.stats["host_evictions"] += 1
        self._clock += 1
        self._entries[path_key] = _Entry(path_key, tokens.copy(), crc,
                                         payload, self._clock)
        self.stats["spills"] += 1

    def lookup(self, path_key: bytes, expected: np.ndarray):
        """The entry under `path_key`, CRC-verified against the
        requesting prompt's chunk. A miss returns None; a stamp mismatch
        drops the entry, counts a refusal and returns None (the request
        re-prefills, the payload is never decoded)."""
        entry = self._entries.get(path_key)
        if entry is None:
            return None
        if entry.crc != chunk_crc(expected):
            del self._entries[entry.key]
            self.stats["refusals"] += 1
            return None
        return entry

    def take(self, entry: _Entry, page: int) -> None:
        """Complete a readmission: restore the payload into the freshly
        allocated device `page` and drop the host entry."""
        if self.readmit_fn is not None and entry.payload is not None:
            self.readmit_fn(page, entry.payload)
        del self._entries[entry.key]
        self.stats["readmits"] += 1

    def digest_tuple(self) -> tuple:
        """The tier's five ints of the per-tick state digest."""
        return (self.stats["spills"], self.stats["readmits"],
                self.stats["refusals"], self.stats["host_evictions"],
                self.host_used)

    def summary_fields(self) -> dict:
        return {"tier_spills": self.stats["spills"],
                "tier_readmits": self.stats["readmits"],
                "tier_refusals": self.stats["refusals"],
                "tier_host_evictions": self.stats["host_evictions"]}
