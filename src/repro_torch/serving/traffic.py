"""Traffic generation + latency accounting for the serving benchmark —
counterpart of `repro.serving.traffic` (the scenario and the metrics are
its NumPy code as it is; the static loop runs the port's model).

Seeded and deterministic end to end: Poisson arrivals (exponential
inter-arrival gaps), mixed prompt lengths and generation budgets drawn
from a seeded generator, so a scenario replays bit-identically — the
scheduler is deterministic (`serving.scheduler`), so the whole serving
trace is too, and the paged-vs-contiguous parity diff is meaningful.

Two drivers at *equal load* (same request set, same arrival clock):

* `run_continuous` — the `serving.engine` continuous-batching runtime:
  requests are admitted the tick after they arrive, finished requests
  retire immediately and their slots/pages are recycled mid-flight.
* `run_static` — the pre-runtime baseline (`launch.serve.greedy_generate`
  style): arrivals queue into fixed-size batches grouped by prompt
  length; every batch decodes ``max(max_new)`` steps, so short requests
  pay for the longest one and nothing is admitted mid-batch.

Latency is wall-clock against the simulated arrival times; ``tok/s
(sustained)`` counts only *useful* generated tokens over the span from
first arrival to last retirement.  The host clock is read after each
tick's tokens reached the host (each engine tick and each static batch's
first and last tokens sync), so it measures the device's work too.

On a live mesh (`launch.mesh.LiveMesh`: the engine's ``mesh``, or
`run_static`'s) every rank runs the loop, and each decision (what has
arrived, whether to wait, a batch's shape) must be the same on every
rank, or the ranks' collectives would part: a hang or a wrong answer.  So
rank 0's clock decides: each reading of the clock is rank 0's, sent to
every rank (`Clock`, one ``broadcast`` of a float64 a reading, counted in
`distributed.sharding.COLLECTIVES`).  On one process nothing changes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..distributed import sharding as shd
from ..models.api import merge_prefill_cache


class Clock:
    """Seconds since the clock was made: this process's monotonic clock,
    or on a live ``mesh`` of more than one rank rank 0's, broadcast to
    every rank at each reading (every rank reads it at the same points of
    the same schedule)."""

    def __init__(self, mesh=None):
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.t0 = time.monotonic()

    def __call__(self) -> float:
        now = time.monotonic() - self.t0
        if self.mesh is None:
            return now
        t = torch.tensor([now], dtype=torch.float64)
        torch.distributed.broadcast(t, 0)
        shd.COLLECTIVES.record("broadcast", t.element_size())
        return float(t[0])


def poisson_arrivals(n: int, rate_per_s: float, rng: np.random.Generator
                     ) -> np.ndarray:
    """Cumulative arrival times (seconds) of ``n`` Poisson events."""
    return np.cumsum(rng.exponential(1.0 / rate_per_s, n))


def make_requests(n: int, rng: np.random.Generator, *, vocab: int,
                  prompt_lens=(8, 16), gen_steps=(4, 16)) -> list[dict]:
    """Mixed-shape request set: each draws a prompt length and a
    generation budget independently (the mix is what static batching
    handles worst)."""
    reqs = []
    for _ in range(n):
        plen = int(rng.choice(prompt_lens))
        reqs.append({
            "prompt": rng.integers(0, vocab, plen).astype(np.int32),
            "max_new_tokens": int(rng.choice(gen_steps)),
        })
    return reqs


def percentiles(xs) -> dict:
    xs = np.asarray(xs, np.float64)
    if xs.size == 0:
        return {"p50": None, "p99": None, "mean": None}
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)),
            "mean": float(xs.mean())}


def _metrics(reqs, wall_s: float) -> dict:
    lat = [r["finished_at"] - r["arrival"] for r in reqs]
    ttft = [r["first_token_at"] - r["arrival"] for r in reqs
            if r["first_token_at"] is not None]
    toks = int(sum(r["n_tokens"] for r in reqs))
    return {"requests": len(reqs), "generated_tokens": toks,
            "wall_s": wall_s,
            "sustained_tok_per_s": toks / max(wall_s, 1e-9),
            "latency_s": percentiles(lat),
            "ttft_s": percentiles(ttft)}


def run_continuous(engine, requests: list[dict], arrivals: np.ndarray) -> dict:
    """Feed ``requests`` at their arrival times; serve until drained (on
    the engine's live mesh, by rank 0's clock: `Clock`)."""
    clock = Clock(engine.mesh)
    i, n = 0, len(requests)
    while i < n or not engine.sched.idle:
        now = clock()
        while i < n and arrivals[i] <= now:
            engine.submit(requests[i]["prompt"],
                          requests[i]["max_new_tokens"], arrival=arrivals[i])
            i += 1
        if not engine.tick(now=now) and i < n:
            time.sleep(min(arrivals[i] - now, 0.001))
    wall = clock()
    done = sorted(engine.sched.done, key=lambda r: r.rid)
    rows = [{"arrival": r.arrival, "finished_at": r.finished_at,
             "first_token_at": r.first_token_at,
             "n_tokens": len(r.out_tokens), "state": r.state}
            for r in done]
    out = _metrics(rows, wall)
    out["quarantined"] = sum(r.state == "quarantined" for r in done)
    return out


def run_static(bundle, params, requests: list[dict], arrivals: np.ndarray,
               *, batch: int, max_len: int, mesh=None) -> dict:
    """Static-loop baseline: batches of ``batch`` grouped by prompt
    length, FIFO; each batch decodes to its longest request's budget (on
    a live ``mesh``, the bundle built on it, by rank 0's clock)."""
    device = bundle.device
    clock = Clock(mesh)
    queue: list[int] = []
    rows: list[dict | None] = [None] * len(requests)
    i, n = 0, len(requests)
    while i < n or queue:
        now = clock()
        while i < n and arrivals[i] <= now:
            queue.append(i)
            i += 1
        if not queue:
            time.sleep(min(arrivals[i] - now, 0.001))
            continue
        plen = requests[queue[0]]["prompt"].shape[0]
        take = [j for j in queue
                if requests[j]["prompt"].shape[0] == plen][:batch]
        # a static loop cannot serve a partial batch efficiently, but it
        # must not deadlock either: flush a short tail once the queue has
        # no more same-length peers arriving imminently
        if len(take) < batch and i < n:
            time.sleep(min(arrivals[i] - now, 0.001))
            continue
        queue = [j for j in queue if j not in take]
        # fixed-shape batch: pad a short tail by repeating the last prompt
        # (outputs ignored) — the defining static-loop property
        pad = [take[-1]] * (batch - len(take))
        prompts = np.stack([requests[j]["prompt"] for j in take + pad])
        steps = max(requests[j]["max_new_tokens"] for j in take)
        with torch.no_grad():
            logits, pfc = bundle.prefill(
                params, {"tokens": torch.from_numpy(prompts).to(device)})
            cache = merge_prefill_cache(bundle.init_cache(batch, max_len),
                                        pfc)
            toks = logits.argmax(dim=-1)[:, None]
            toks.cpu()                      # the first tokens reach the host
            first_t = clock()
            outs = [toks]
            clen = torch.full((batch,), plen, dtype=torch.long,
                              device=device)
            for _ in range(steps - 1):
                logits, cache = bundle.decode_step(
                    params, {"tokens": toks, "cache_len": clen}, cache)
                toks = logits.argmax(dim=-1)[:, None]
                clen = clen + 1
                outs.append(toks)
            torch.cat(outs, dim=1).cpu()
        fin = clock()
        for j in take:       # every request waits for the whole batch
            rows[j] = {"arrival": arrivals[j], "finished_at": fin,
                       "first_token_at": first_t,
                       "n_tokens": requests[j]["max_new_tokens"]}
    return _metrics([r for r in rows if r is not None], clock())
