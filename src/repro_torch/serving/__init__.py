"""Continuous-batching serving runtime on a paged plane-layout KV cache —
counterpart of `repro.serving`:

* `pages`     — host-side page allocator + per-slot page table (NumPy)
* `paged_kv`  — device pool ``[L, num_pages*KH, page_size, dh]`` and the
                gather-view / extract-rows / scatter-back ops
* `scheduler` — deterministic admission control, prefill chunking,
                prefill/decode interleave, streaming bookkeeping (NumPy)
* `engine`    — `ServingEngine`: one step function per (pow-2 batch
                bucket, chunk width, fused decode steps); per-request NaN
                quarantine
* `traffic`   — seeded Poisson scenarios + the static-loop baseline
"""
from .engine import ServingEngine, contiguous_engine          # noqa: F401
from .pages import OutOfPages, PageAllocator, PageTable       # noqa: F401
from .scheduler import Request, Scheduler                     # noqa: F401
