"""Continuous-batching request scheduler (admission, chunking, interleave)
— `repro.serving.scheduler`, copied as it is (NumPy only).

Policy (deterministic — same submissions in the same order always produce
the same tick sequence, asserted by tests/test_torch_serving.py):

* **Admission control**: a waiting request is admitted only when a slot is
  free and the allocator can cover its *whole* budget
  (``ceil((prompt + max_new_tokens) / page_size)`` pages) up front.
  Reserving the full budget at admit time means a running request can
  never deadlock mid-generation waiting for pages — the classic
  continuous-batching livelock.  FIFO order; admission never overtakes.
* **Prefill chunking**: prompts enter the cache ``prefill_chunk`` tokens
  per tick through the same chunked decode step the runtime uses for
  generation (``models/*.decode_step`` with ``s > 1``), so one long
  prompt never blocks the decode batch for its full prefill.
* **Interleave**: ticks alternate prefill / decode whenever both kinds of
  work exist — decode latency stays bounded while prompts stream in.
  Prefill ticks group requests with the *same* next-chunk width so the
  batch is rectangular (no ragged padding inside a chunk).

The scheduler is pure bookkeeping — it owns no device state.  The engine
(`serving.engine`) asks it *what to run next* and reports back what
happened (tokens appended, request finished/quarantined).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from .pages import OutOfPages, PageAllocator, PageTable

WAITING = "waiting"
PREFILL = "prefill"      # admitted, prompt not yet fully cached
DECODE = "decode"        # generating
FINISHED = "finished"
QUARANTINED = "quarantined"   # evicted by the per-request NaN guard


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [plen] int32
    max_new_tokens: int
    arrival: float = 0.0                # traffic-sim submit time (seconds)
    state: str = WAITING
    slot: int = -1
    pos: int = 0                        # tokens cached so far
    last_token: int = -1                # next decode input
    out_tokens: list = dataclasses.field(default_factory=list)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def plen(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def budget_tokens(self) -> int:
        # prompt rows + one row per fed-back token; the final sampled
        # token is streamed but never cached (greedy_generate's bound)
        return self.plen + self.max_new_tokens - 1

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


class Scheduler:
    def __init__(self, table: PageTable, alloc: PageAllocator, *,
                 prefill_chunk: int, max_batch: int):
        self.table = table
        self.alloc = alloc
        self.prefill_chunk = prefill_chunk
        self.max_batch = max_batch
        self.waiting: deque[Request] = deque()
        self.live: dict[int, Request] = {}          # rid -> admitted request
        self.done: list[Request] = []
        self._last_kind = "decode"                  # alternation state
        self._next_rid = 0

    # -- submission / admission -------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               arrival: float = 0.0) -> Request:
        req = Request(rid=self._next_rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, arrival=arrival)
        if self.table.pages_for(req.budget_tokens) > \
                self.table.max_pages_per_slot:
            # can never be served: admitting it would crash map_pages, and
            # leaving it waiting would livelock the FIFO queue behind it
            raise ValueError(
                f"request budget {req.budget_tokens} tokens exceeds the "
                f"per-slot capacity "
                f"{self.table.max_pages_per_slot * self.table.page_size}")
        self._next_rid += 1
        self.waiting.append(req)
        return req

    def admit(self) -> list[Request]:
        """FIFO admit while a slot + the full page budget are available."""
        admitted = []
        while self.waiting:
            req = self.waiting[0]
            pages_needed = self.table.pages_for(req.budget_tokens)
            if (self.table.free_slots == 0
                    or pages_needed > self.alloc.free_pages
                    or len(self.live) >= self.max_batch):
                break       # FIFO: never let a smaller request overtake
            self.waiting.popleft()
            req.slot = self.table.acquire_slot()
            self.table.map_pages(req.slot, self.alloc.alloc(pages_needed))
            req.state = PREFILL
            self.live[req.rid] = req
            admitted.append(req)
        return admitted

    # -- tick planning -----------------------------------------------------

    def next_work(self) -> Optional[tuple[str, list[Request], int]]:
        """``("prefill", reqs, chunk)`` or ``("decode", reqs, 1)`` or None.

        Alternates kinds when both have work; prefill groups by identical
        next-chunk width (smallest width first for determinism).
        """
        pre = sorted((r for r in self.live.values() if r.state == PREFILL),
                     key=lambda r: r.rid)
        dec = sorted((r for r in self.live.values() if r.state == DECODE),
                     key=lambda r: r.rid)
        want = "decode" if (dec and (not pre or self._last_kind == "prefill")) \
            else ("prefill" if pre else None)
        if want is None:
            return None
        self._last_kind = want
        if want == "decode":
            return ("decode", dec[:self.max_batch], 1)
        widths = {}
        for r in pre:
            c = min(self.prefill_chunk, r.plen - r.pos)
            widths.setdefault(c, []).append(r)
        chunk = min(widths)
        return ("prefill", widths[chunk][:self.max_batch], chunk)

    # -- outcome reporting -------------------------------------------------

    def on_prefill(self, req: Request, chunk: int) -> None:
        self.table.advance(req.slot, chunk)
        req.pos += chunk
        if req.pos >= req.plen:
            req.state = DECODE

    def on_token(self, req: Request, token: int, now: float = 0.0) -> None:
        """Stream one generated token; cache-position bookkeeping for the
        row the *next* step will write (the token just fed back)."""
        if req.state == DECODE and req.out_tokens:
            # the fed-back previous token occupied one cache row this step
            self.table.advance(req.slot, 1)
            req.pos += 1
        if req.first_token_at is None:
            req.first_token_at = now
        req.out_tokens.append(int(token))
        req.last_token = int(token)
        if req.done:
            self._retire(req, FINISHED, now)

    def quarantine(self, req: Request, now: float = 0.0) -> None:
        self._retire(req, QUARANTINED, now)

    def _retire(self, req: Request, state: str, now: float) -> None:
        req.state = state
        req.finished_at = now
        self.table.release_slot(req.slot, self.alloc)
        req.slot = -1
        del self.live[req.rid]
        self.done.append(req)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.live
