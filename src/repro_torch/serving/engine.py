"""Continuous-batching serving engine on the paged plane-layout KV pool —
counterpart of `repro.serving.engine`.

One ``tick`` = admit waiting requests, ask the scheduler for the next
rectangular batch (a decode step or a prefill chunk — `serving.scheduler`
interleaves them), and run ONE step function:

    gather pages -> contiguous plane view -> bundle.decode_step (x ksteps)
    -> extract written rows -> scatter back into the pool

The live batch is padded to the next power of two, so the number of
distinct step shapes is O(log max_batch * chunk widths) no matter how the
live set churns — padding slots gather/scatter through the reserved null
page and their logits rows are ignored.  The *model* is untouched: prefill
chunks and decode steps are both ``models/*.decode_step`` (``s >= 1``);
with ``cache_update="scatter"`` every one of them writes its KV rows into
the view through the `kernels.kv_cache_update` kernel.

Per-request NaN guard: after every step the engine checks row-wise logits
finiteness; a poisoned request is quarantined — evicted, its pages wiped
and freed, an event recorded — while the rest of the batch keeps serving.

Exactness: the gather is a copy and the extract/scatter moves exactly the
rows the step wrote, so a paged run's logits are bitwise equal to a
contiguous-cache run of the same schedule and padded width.  A contiguous
engine IS the degenerate config ``page_size == view width`` (one page per
slot) — `contiguous_engine` builds it.

The reference's jitted steps and its ``lax.scan`` decode fusion become
plain Python step functions cached per (batch bucket, chunk, ksteps); a
fused decode tick runs ``ksteps`` decode steps in a loop that feeds the
argmax back on the device, and each tick reads its tokens and finite
flags to the host once.

``mesh`` (a `launch.mesh.LiveMesh`, the bundle built on it) places the
pool as the reference's ``mesh=`` does, by `paged_kv.paged_pool_specs`:
each rank holds its block of the pool planes.  Every rank runs the same
schedule (the scheduler is deterministic; `serving.traffic` keeps the
ranks' clocks in lock step) and builds the same host indices; a step
gathers the rank's block of the view (its planes of the model's
``cache_specs``) from the ranks that hold those pages, runs the live
``decode_step`` and sends each written row to the ranks that hold its
page (`paged_kv.gather_view_live` / `scatter_rows_live`).  The logits
come whole to every rank (the model's vocab ``all_reduce``), so the
tokens and finite flags, and with them each quarantine, agree.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import TRANSFORMER_FAMILIES
from ..models.transformer import KV_DTYPE
from . import paged_kv
from .pages import NULL_PAGE, PageAllocator, PageTable
from .scheduler import DECODE, PREFILL, Request, Scheduler


class ServingEngine:
    def __init__(self, bundle, params, *, num_pages: int, page_size: int,
                 max_slots: int, max_pages_per_slot: int,
                 prefill_chunk: int = 8, mesh=None,
                 record_logits: bool = False,
                 step_cache: Optional[dict] = None):
        cfg = bundle.cfg
        if cfg.family not in TRANSFORMER_FAMILIES:
            raise ValueError(
                f"paged serving covers the transformer families "
                f"{TRANSFORMER_FAMILIES}; {cfg.family} caches O(1) state, "
                "not KV rows — paging it is meaningless")
        self.bundle = bundle
        self.params = params
        self.device = bundle.device
        self.kh = cfg.n_kv_heads
        self.view_pages = max_pages_per_slot
        self.page_size = page_size
        self.decode_fuse = 8        # max decode steps fused per tick
        self.mesh = mesh
        self.pool_planes = num_pages * self.kh
        self.pool = paged_kv.init_pool(cfg.n_layers, num_pages, self.kh,
                                       page_size, cfg.head_dim,
                                       dtype=KV_DTYPE, device=self.device,
                                       mesh=mesh)
        self.table = PageTable(max_slots, max_pages_per_slot, page_size)
        self.alloc = PageAllocator(num_pages)
        self.sched = Scheduler(self.table, self.alloc,
                               prefill_chunk=prefill_chunk,
                               max_batch=max_slots)
        self.events: list[dict] = []
        # on a mesh, one entry a tick: (now, kind, request ids, chunk,
        # fused steps), the ranks' lock step compared by it
        self.ticks: Optional[list[tuple]] = [] if mesh is not None else None
        self.logits_trace: dict[int, list] = {} if record_logits else None
        # engines with identical geometry (the parity replay + the timed
        # run) can share step functions: pass the same dict to both
        self._steps: dict[tuple, Callable] = \
            step_cache if step_cache is not None else {}

    # -- request API -------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               arrival: float = 0.0) -> Request:
        req = self.sched.submit(np.asarray(prompt, np.int32),
                                max_new_tokens, arrival)
        budget = req.budget_tokens
        cap = self.view_pages * self.page_size
        if budget > cap:
            raise ValueError(
                f"request needs {budget} cache rows; the per-slot budget "
                f"is {self.view_pages} pages x {self.page_size} = {cap}")
        return req

    def warmup(self, chunk_widths=(1,)) -> int:
        """Run the step for every (pow-2 batch bucket, chunk width, fused
        decode steps) the scenario can hit, off the timed path (the first
        call of a shape pays for the library's one-time set-up).  On a
        mesh a fused decode step is made, not run: it is ``ksteps`` calls
        of the one-step decode's shapes, which leave it no set-up to pay,
        and each of its forwards would cost the ranks' collectives.
        All-padding batches (every slot -1) make the calls side-effect
        free: gather and scatter touch only the reserved null page.
        Returns the number of step functions now resident."""
        buckets, b = [], 1
        while b < self.sched.max_batch:
            buckets.append(b)
            b <<= 1
        buckets.append(b)
        fuse, k = [], 1
        while k <= self.decode_fuse:
            fuse.append(k)
            k <<= 1
        keys = [(c, 1) for c in sorted(set(chunk_widths)) if c != 1] \
            + [(1, k) for k in fuse]
        for chunk, ksteps in keys:
            for b in buckets:
                if ksteps > 1 and self.mesh is not None:
                    self._step_fn(b, chunk, ksteps)
                    continue
                _, toks, _ = self._run_step(b, chunk, ksteps,
                                            np.zeros((b, chunk), np.int32),
                                            np.zeros(b, np.int32), [-1] * b,
                                            chunk * ksteps)
                toks.cpu()
        return len(self._steps)

    def run(self) -> None:
        """Serve until every submitted request retires."""
        while not self.sched.idle:
            if not self.tick():
                break       # only unadmittable work left: caller's problem

    # -- one engine tick ---------------------------------------------------

    def tick(self, now: float = 0.0) -> bool:
        self.sched.admit()
        work = self.sched.next_work()
        if work is None:
            return False
        kind, reqs, chunk = work
        n = len(reqs)
        b = 1 << max(n - 1, 0).bit_length()         # pow-2 batch bucket
        if kind == "decode":
            # fuse while the live set is provably stable: greedy budgets
            # make every finish deterministic, so min remaining steps is a
            # sound horizon; pow-2-floor it to bound the step keys
            rem = min(r.max_new_tokens - len(r.out_tokens) for r in reqs)
            ksteps = 1 << (min(rem, self.decode_fuse).bit_length() - 1)
        else:
            ksteps = 1
        if self.ticks is not None:
            self.ticks.append((now, kind, [r.rid for r in reqs], chunk,
                               ksteps))
        slots = [r.slot for r in reqs] + [-1] * (b - n)
        clen = np.array([r.pos for r in reqs] + [0] * (b - n), np.int32)
        toks = np.zeros((b, chunk), np.int32)
        for i, r in enumerate(reqs):
            toks[i] = (r.prompt[r.pos:r.pos + chunk] if kind == "prefill"
                       else [r.last_token])
        rows = chunk if kind == "prefill" else ksteps
        logits, toks_out, finite = self._run_step(b, chunk, ksteps, toks,
                                                  clen, slots, rows)
        # the one per-tick host sync: tokens and finite flags, [K, B] each
        # (logits stay on the device unless a parity trace asked for them)
        host = torch.stack((toks_out, finite.long())).cpu().numpy()
        toks_out, bad = host[0], host[1] == 0
        rec = (logits.float().cpu().numpy()
               if self.logits_trace is not None else None)
        self._absorb(kind, reqs, chunk, ksteps, toks_out, bad, rec, now)
        return True

    def _run_step(self, b: int, chunk: int, ksteps: int, toks: np.ndarray,
                  clen: np.ndarray, slots: list, rows: int) -> tuple:
        """Build the step's indices on the host, move them to the device
        (on a mesh the exchanges route by the host's) and run the cached
        step function (which updates the pool)."""
        gplanes = paged_kv.gather_planes(self.table, slots, self.kh,
                                         self.view_pages)
        splanes, srows = paged_kv.scatter_indices(self.table, slots, clen,
                                                  self.kh, rows)
        dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        if self.mesh is None:
            gplanes, splanes, srows = dev(gplanes), dev(splanes), dev(srows)
        return self._step_fn(b, chunk, ksteps)(
            self.params, self.pool, dev(toks).long(), dev(clen).long(),
            gplanes, splanes, srows)

    def _absorb(self, kind: str, reqs: list[Request], chunk: int,
                ksteps: int, toks: np.ndarray, bad: np.ndarray,
                logits: Optional[np.ndarray], now: float) -> None:
        gone: set[int] = set()
        for k in range(ksteps):
            for i, r in enumerate(reqs):
                if r.rid in gone:
                    continue
                if kind == "prefill":
                    self.sched.on_prefill(r, chunk)
                    if r.state != DECODE:
                        continue        # prompt not finished: logits unused
                if bad[k, i]:
                    # wipe before the pages go back on the free list: a
                    # poisoned request leaves non-finite cache rows, and a
                    # masked NaN still poisons attention (0 * NaN)
                    self._wipe_slot(r)
                    self.sched.quarantine(r, now)
                    self.events.append({"event": "request_quarantine",
                                        "rid": r.rid, "at": kind,
                                        "pos": int(r.pos)})
                    gone.add(r.rid)
                    continue
                if logits is not None:
                    self.logits_trace.setdefault(r.rid, []).append(
                        logits[k, i])
                self.sched.on_token(r, int(toks[k, i]), now)
                if r.state not in (PREFILL, DECODE):
                    gone.add(r.rid)     # retired at its deterministic step

    def _wipe_slot(self, r: Request) -> None:
        """Zero the request's pool planes (on a mesh, those of the rank's
        block)."""
        pages = [int(p) for p in self.table.table[r.slot] if p != NULL_PAGE]
        planes = np.array([p * self.kh + h for p in pages
                           for h in range(self.kh)], np.int64)
        if self.mesh is not None:
            p0, m = paged_kv.plane_block(self.mesh, self.pool_planes)
            planes = planes[(planes >= p0) & (planes < p0 + m)] - p0
        if not planes.size:
            return
        planes = torch.from_numpy(planes).to(self.device)
        for leaf in self.pool.values():
            leaf[:, planes] = 0

    # -- the step, cached per (batch bucket, chunk, fused steps) -----------

    def _step_fn(self, b: int, chunk: int, ksteps: int = 1) -> Callable:
        """One gather -> decode^ksteps -> scatter.

        ``ksteps > 1`` (decode only, ``chunk == 1``) chains the greedy
        argmax feedback *on the device*: one host sync covers ``ksteps``
        generated tokens.  Updates ``pool`` in place and returns
        ``(logits [K,B,vocab], tokens [K,B], finite [K,B])``.
        """
        key = (b, chunk, ksteps)
        if key not in self._steps:
            assert ksteps == 1 or chunk == 1, "fusion is decode-only"
            decode_step, kh = self.bundle.decode_step, self.kh
            mesh, n_pool = self.mesh, self.pool_planes
            rows = chunk * ksteps
            # the rank's view planes (on one device, all of them)
            p0, n = (0, b * kh) if mesh is None else \
                paged_kv.plane_block(mesh, b * kh)

            @torch.no_grad()
            def step(params, pool, tokens, clen, gplanes, splanes, srows):
                if mesh is None:
                    cache = {k: paged_kv.gather_view(leaf, gplanes)
                             for k, leaf in pool.items()}
                else:
                    cache = paged_kv.gather_view_live(pool, gplanes, mesh,
                                                      n_pool)
                lg, tk, fin = [], [], []
                tok, cl = tokens, clen
                for _ in range(ksteps):
                    logits, cache = decode_step(
                        params, {"tokens": tok, "cache_len": cl}, cache)
                    nxt = logits.argmax(dim=-1)
                    lg.append(logits)
                    tk.append(nxt)
                    fin.append(torch.isfinite(logits).all(dim=-1))
                    tok, cl = nxt[:, None], cl + 1
                clen_rep = clen.repeat_interleave(kh)[p0:p0 + n]
                # nan_to_num is the identity on healthy rows (exactness
                # kept) and keeps the pool finite while a poisoned request
                # is in flight: batch-padding rows gather unmapped pages,
                # and a masked NaN would still poison attention through
                # 0 * NaN
                new = {k: torch.nan_to_num(
                    paged_kv.extract_rows(cache[k], clen_rep, rows))
                    for k in pool}
                if mesh is None:
                    for k, leaf in pool.items():
                        paged_kv.scatter_rows(leaf, new[k], splanes, srows)
                else:
                    paged_kv.scatter_rows_live(pool, new, splanes, srows,
                                               mesh, n_pool)
                return torch.stack(lg), torch.stack(tk), torch.stack(fin)

            self._steps[key] = step
        return self._steps[key]


def contiguous_engine(bundle, params, *, max_slots: int, max_len: int,
                      prefill_chunk: int = 8, mesh=None,
                      **kw) -> ServingEngine:
    """The degenerate paged engine: one ``max_len``-row page per slot —
    a contiguous per-slot cache running the *identical* schedule and step
    functions.  The parity baseline for the paged A/B."""
    return ServingEngine(bundle, params, num_pages=max_slots + 1,
                         page_size=max_len, max_slots=max_slots,
                         max_pages_per_slot=1, prefill_chunk=prefill_chunk,
                         mesh=mesh, **kw)
