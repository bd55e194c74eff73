"""Host-side page accounting for the paged KV cache — a copy of
``paddle_tpu/inference/paging.py`` (pure Python; the port keeps its own
copy and imports nothing of the JAX package).

The device side (``models/llama_paged.py``) sees only a page pool and
block tables; WHICH physical page holds which request's tokens is host
metadata, managed here. Pages are interchangeable, so the allocator is a
plain LIFO free list.

Physical page 0 is reserved as the SCRATCH page: retired/idle slots point
their whole block-table row at it so their frozen in-flight writes land
somewhere no live request reads. ``PageAllocator`` therefore never hands
out page 0; ``usable`` is ``num_pages - 1``.

Refcounts: a page may be mapped by several holders. ``alloc`` hands out
pages at refcount 1, ``share`` adds references, and ``free`` returns a
page to the free list only when its count reaches zero, so
``free_pages`` / ``pages_in_use`` count a shared page once. Mutations
take the allocator lock.
"""
from __future__ import annotations

import threading
from typing import Sequence

__all__ = ["PageAllocator", "SCRATCH_PAGE", "default_page_buckets",
           "pages_for", "pages_for_budget"]

SCRATCH_PAGE = 0


def pages_for(n_positions: int, page_size: int) -> int:
    """Pages needed to hold positions [0, n_positions)."""
    if n_positions <= 0:
        return 0
    return (int(n_positions) - 1) // int(page_size) + 1


def pages_for_budget(hbm_bytes: int, bytes_per_page: int) -> int:
    """Pool size (page COUNT, scratch page included) a device byte budget
    buys at ``bytes_per_page`` (``models/llama_paged.py:page_bytes``).
    Floors at 2 — one scratch page plus one usable page is the smallest
    pool the allocator accepts."""
    return max(2, int(hbm_bytes) // max(1, int(bytes_per_page)))


def default_page_buckets(max_pages: int) -> tuple:
    """Powers-of-two page counts up to (and always including) max_pages —
    the same executable-inventory/bandwidth trade as prompt buckets: a
    burst compiles per bucket, and reads scale with the bucket instead of
    the worst case."""
    max_pages = int(max_pages)
    out, b = [], 1
    while b < max_pages:
        out.append(b)
        b *= 2
    out.append(max_pages)
    return tuple(sorted(set(out)))


class PageAllocator:
    """LIFO free list over ``num_pages`` physical pages (page 0 reserved),
    with per-page refcounts.

    ``alloc`` is all-or-nothing: a partially satisfiable request returns
    None and leaves the free list untouched, so callers can treat "not
    enough pages" as one atomic admission/growth decision. Allocated
    pages start at refcount 1; ``share`` adds holders (a prefix-cache hit
    mapping the page into another block table, or the cache index
    itself); ``free`` decrements and recycles at zero — so every byte of
    a shared prefix is accounted exactly once however many requests map
    it.
    """

    def __init__(self, num_pages: int):
        num_pages = int(num_pages)
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        self._lk = threading.Lock()
        # low page ids first: keeps early traffic in a compact prefix,
        # which makes pool dumps human-readable
        self._free = list(range(num_pages - 1, SCRATCH_PAGE, -1))
        self._ref = [0] * num_pages

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.usable - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[int(page)]

    def alloc(self, n: int) -> list | None:
        if n < 0:
            raise ValueError(f"alloc({n})")
        with self._lk:
            if n > len(self._free):
                return None
            out = [self._free.pop() for _ in range(n)]
            for p in out:
                self._ref[p] = 1
            return out

    def share(self, page_ids: Sequence[int], n: int = 1) -> None:
        """Add ``n`` references to each page — a prefix-cache hit mapping
        shared pages into one more block table (or the cache index taking
        its own hold). Only live pages can gain holders."""
        with self._lk:
            for p in page_ids:
                p = int(p)
                if p == SCRATCH_PAGE or p >= self.num_pages \
                        or self._ref[p] <= 0:
                    raise ValueError(f"sharing unallocated page {p}")
            for p in page_ids:
                self._ref[int(p)] += int(n)

    def free(self, page_ids: Sequence[int]) -> None:
        """Drop one reference per page; a page recycles to the free list
        when its last holder lets go. Freeing a page nobody holds is the
        double-free it always was."""
        with self._lk:
            for p in page_ids:
                p = int(p)
                if p == SCRATCH_PAGE or p >= self.num_pages:
                    raise ValueError(f"freeing invalid page {p}")
                if self._ref[p] <= 0:
                    raise RuntimeError(
                        f"double free: page {p} has no holders")
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._free.append(p)
            if len(self._free) > self.usable:
                raise RuntimeError("double free: free list exceeds pool")
