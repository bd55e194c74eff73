"""Page-granular prefix cache over the paged KV pool — a copy of
``paddle_tpu/inference/prefix_cache.py`` (pure Python; the port keeps its
own copy and imports nothing of the JAX package).

Requests that share a system prompt share its KV pages. The cache indexes
FULL prompt pages by a **chained page hash** — ``h_j = blake2b(h_{j-1} ||
tokens[j·ps:(j+1)·ps])`` — so a hit at chain position j proves (to a
128-bit hash plus an exact token comparison of page j) that the whole
prefix matches, and the matched pages can be mapped straight into a new
request's block table:

  * **match** — walk the arriving prompt's full pages down the chain;
    every hit takes one allocator reference (``PageAllocator.share``) and
    the scheduler prefills ONLY the unshared suffix.
  * **insert** — after a prefill the request's full prompt pages enter the
    index, each under one CACHE reference of its own, so they outlive the
    request and the next admission hits them.
  * **evict** — entries nobody maps (allocator refcount 1 == the cache's
    own hold) are LRU-evicted past the capacity and reclaimed on allocator
    pressure (``reclaim``), so the cache borrows idle pool capacity
    instead of competing with live requests.

Shared pages are READ-ONLY by convention; the scheduler copy-on-writes any
shared page sitting in a burst's write window before dispatch
(``serving._grow_for_burst``), so a full-prompt hit (decode resumes at the
last prompt token) first copies the tail page it writes into.

Differences from the JAX module: the ``serve.prefix_evict`` chaos site and
the ``serve.prefix_*`` metrics are not here — they wait for the port of
``distributed/resilience/chaos.py`` and ``observability/metrics.py``
(ROADMAP Queue 1 item 5). Everything else, the lock included (the JAX
engine's HTTP handler threads probe the index), is the same.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

__all__ = ["PrefixCache", "chain_hashes", "iter_chain_hashes"]


def iter_chain_hashes(tokens, page_size: int):
    """Yield one 128-bit chained digest per FULL page of ``tokens``: hash
    j covers every token in pages [0, j] — deterministic across processes,
    unlike Python's salted ``hash()``. A generator, so a match walk stops
    hashing at its first miss (a long prompt stalled at the queue head
    re-matches every scheduler step)."""
    ps = int(page_size)
    h = b""
    for j in range(len(tokens) // ps):
        page = ",".join(str(int(t)) for t in tokens[j * ps:(j + 1) * ps])
        h = hashlib.blake2b(h + b"|" + page.encode(),
                            digest_size=16).digest()
        yield h


def chain_hashes(tokens, page_size: int) -> list[bytes]:
    """The full chain as a list (insert side / tests)."""
    return list(iter_chain_hashes(tokens, page_size))


class PrefixCache:
    """cache = PrefixCache(allocator, page_size, capacity_pages)

    ``capacity_pages`` bounds how many pages the index may hold; entries
    still mapped by live requests never evict (they are alive regardless),
    so the bound really limits the IDLE pages the cache pins."""

    def __init__(self, alloc, page_size: int, capacity_pages: int):
        if int(capacity_pages) < 1:
            raise ValueError("capacity_pages must be >= 1 (0 disables the "
                             "cache at the engine, not here)")
        self._alloc = alloc
        self._ps = int(page_size)
        self._cap = int(capacity_pages)
        self._lk = threading.Lock()
        # chain hash -> {"page": physical id, "tokens": this page's tokens};
        # OrderedDict order IS the LRU order (move_to_end on every hit)
        self._entries: OrderedDict[bytes, dict] = OrderedDict()
        # hit/miss accounting lives in the SCHEDULER
        # (serving._prefix_hit_account), which counts once per admission:
        # match() runs once per scheduler step for a stalled queue head
        self.stats = {"inserts": 0, "evictions": 0, "reclaimed": 0}

    # ------------------------------------------------------------- reads
    @property
    def cached_pages(self) -> int:
        return len(self._entries)

    def cached_page_ids(self) -> list[int]:
        """The physical pages the index holds, in LRU order."""
        with self._lk:
            return [e["page"] for e in self._entries.values()]

    def evictable_pages(self) -> int:
        """Pages only the cache holds (allocator refcount 1): capacity an
        admission decision may treat as free, because ``reclaim`` can turn
        them into free pages without touching any live request."""
        with self._lk:
            return sum(1 for e in self._entries.values()
                       if self._alloc.refcount(e["page"]) == 1)

    def match_pages(self, prompt) -> int:
        """How many leading full pages of ``prompt`` the index holds (no
        references taken; the admit-time :meth:`match` re-checks under its
        lock)."""
        with self._lk:
            return len(self._walk(prompt))

    # ----------------------------------------------------------- matching
    def _touch_chain(self, hashes: list) -> None:
        """Caller holds the lock: refresh LRU recency for a just-used (or
        just-inserted) chain in REVERSE page order, so within one chain the
        ROOT page is always the most recently used. Evicting a root first
        would strand its descendants: entries no match can reach again
        that still pin pool pages."""
        for h in reversed(hashes):
            self._entries.move_to_end(h)

    def _walk(self, prompt) -> list[int]:
        """Caller holds the lock: matched physical pages, longest verified
        chain, stopping at the first miss (hashing stops there too).
        Verification compares the stored page's tokens exactly, so a
        128-bit chain collision would still need a token-identical final
        page to corrupt anything."""
        pages: list[int] = []
        hits: list[bytes] = []
        ps = self._ps
        prompt = list(prompt)
        for j, h in enumerate(iter_chain_hashes(prompt, ps)):
            e = self._entries.get(h)
            if e is None \
                    or e["tokens"] != tuple(prompt[j * ps:(j + 1) * ps]):
                break
            pages.append(e["page"])
            hits.append(h)
        self._touch_chain(hits)
        return pages

    def match(self, prompt) -> tuple[list[int], int]:
        """(shared physical pages, matched token count) for the longest
        indexed prefix of ``prompt``; each returned page carries ONE new
        allocator reference the caller now owns (its block table frees
        them like any other page). Empty on a miss."""
        with self._lk:
            pages = self._walk(prompt)
            if pages:
                self._alloc.share(pages)
            return pages, len(pages) * self._ps

    # ---------------------------------------------------------- insertion
    def insert(self, prompt, page_table) -> int:
        """Index every full page of ``prompt`` not already present, where
        logical page j lives at physical ``page_table[j]``. Each new entry
        takes one CACHE reference; over-capacity inserts first evict LRU
        idle entries and STOP (skipping the remainder) when nothing is
        evictable. Returns the number of entries added."""
        added = 0
        with self._lk:
            prompt = list(prompt)
            chain: list[bytes] = []
            for j, h in enumerate(iter_chain_hashes(prompt, self._ps)):
                if j >= len(page_table):
                    break
                if h in self._entries:
                    chain.append(h)
                    continue
                if len(self._entries) >= self._cap \
                        and not self._evict_lru():
                    break
                page = int(page_table[j])
                self._alloc.share([page])
                self._entries[h] = {
                    "page": page,
                    "tokens": tuple(prompt[j * self._ps:(j + 1) * self._ps]),
                }
                chain.append(h)
                added += 1
            # reverse-order touch: the chain ROOT ends up most recent, so
            # LRU eviction eats chains from the TAIL (see _touch_chain)
            self._touch_chain(chain)
            self.stats["inserts"] += added
        return added

    # ----------------------------------------------------------- eviction
    def _evict_lru(self) -> bool:
        """Caller holds the lock: free the least-recently-used IDLE entry
        (allocator refcount 1: only the cache holds it)."""
        for h, e in list(self._entries.items()):
            if self._alloc.refcount(e["page"]) != 1:
                continue   # mapped by a live request: alive regardless
            del self._entries[h]
            self._alloc.free([e["page"]])
            self.stats["evictions"] += 1
            return True
        return False

    def drop_page(self, page: int) -> bool:
        """Un-index ONE page (dropping the cache's reference) if this cache
        holds it — the zero-copy COW fallback: when the pool cannot supply
        a copy target for a shared page whose ONLY other holder is the
        index itself, releasing the entry makes the page private with no
        allocation at all (the writer keeps decoding; future admits just
        miss). Returns True when an entry was dropped."""
        page = int(page)
        with self._lk:
            key = next((h for h, e in self._entries.items()
                        if e["page"] == page), None)
            if key is None:
                return False
            del self._entries[key]
            self._alloc.free([page])
            self.stats["evictions"] += 1
            return True

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` idle entries for allocator pressure (a new
        admission or a COW copy needs pages the free list cannot cover).
        Returns how many pages actually went back; callers treat a
        shortfall as an ordinary full pool (stall / preempt)."""
        got = 0
        with self._lk:
            while got < int(n) and self._evict_lru():
                got += 1
            self.stats["reclaimed"] += got
        return got
