"""Host-side paged-KV bookkeeping: page allocator + per-slot page table —
`repro.serving.pages`, copied as it is (NumPy only).

The device-side pool (`serving.paged_kv`) is a fixed tensor of
``num_pages`` pages; which page holds which request's tokens is pure host
metadata, kept here in numpy so admission control can reason about memory
without touching the device.  Page 0 is reserved as the *null page*: the
allocator never hands it out, batch-padding slots gather and scatter
through it, and unmapped page-table entries point at it — so every device
index is always in range and garbage only ever lands where nothing reads.

Invariants (property-tested in tests/test_torch_serving.py):
* a page is owned by at most one slot at a time (no cross-request
  aliasing);
* ``free + sum(owned)`` is conserved (no leaks across admit/evict cycles);
* the table row of a freed slot is reset to the null page.
"""
from __future__ import annotations

import dataclasses

import numpy as np

NULL_PAGE = 0


class OutOfPages(RuntimeError):
    """Allocation would exceed the pool — admission control must refuse."""


class PageAllocator:
    """Free-list allocator over pages ``1..num_pages-1`` (0 is reserved).

    LIFO free list: recently-freed pages are re-issued first, which keeps
    the working set of the device pool compact under churn.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() yields 1 first
        self._owned: set[int] = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free of "
                f"{self.num_pages - 1} allocatable")
        pages = [self._free.pop() for _ in range(n)]
        self._owned.update(pages)
        return pages

    def free(self, pages) -> None:
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("page 0 is reserved and never allocated")
            if p not in self._owned:
                raise ValueError(f"double free of page {p}")
            self._owned.discard(p)
            self._free.append(p)


@dataclasses.dataclass
class PageTable:
    """``table[slot, j]`` = pool page holding tokens
    ``j*page_size .. (j+1)*page_size - 1`` of the request in ``slot``.

    ``length[slot]`` counts tokens actually written, so
    ``ceil(length/page_size)`` leading entries are live; the rest stay at
    the null page.  Slots are recycled through a free list like pages.
    """
    max_slots: int
    max_pages_per_slot: int
    page_size: int

    def __post_init__(self):
        self.table = np.full((self.max_slots, self.max_pages_per_slot),
                             NULL_PAGE, np.int32)
        self.length = np.zeros((self.max_slots,), np.int32)
        self._free_slots = list(range(self.max_slots - 1, -1, -1))

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def acquire_slot(self) -> int:
        if not self._free_slots:
            raise OutOfPages(f"all {self.max_slots} slots are live")
        return self._free_slots.pop()

    def map_pages(self, slot: int, pages: list[int]) -> None:
        """Append ``pages`` to the slot's mapped prefix."""
        start = int((self.table[slot] != NULL_PAGE).sum())
        if start + len(pages) > self.max_pages_per_slot:
            raise OutOfPages(
                f"slot {slot}: {start}+{len(pages)} pages exceeds the "
                f"per-slot cap {self.max_pages_per_slot}")
        self.table[slot, start:start + len(pages)] = pages

    def release_slot(self, slot: int, alloc: PageAllocator) -> None:
        live = [int(p) for p in self.table[slot] if p != NULL_PAGE]
        alloc.free(live)
        self.table[slot] = NULL_PAGE
        self.length[slot] = 0
        self._free_slots.append(slot)

    def advance(self, slot: int, n_tokens: int) -> None:
        self.length[slot] += n_tokens
        need = self.pages_for(int(self.length[slot]))
        have = int((self.table[slot] != NULL_PAGE).sum())
        if need > have:
            raise RuntimeError(
                f"slot {slot} advanced past its mapped pages "
                f"({need} needed, {have} mapped) — admission must map the "
                "full request budget up front")
