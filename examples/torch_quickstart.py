"""Quickstart of the PyTorch/CUDA port: the Sense co-design in 60 lines.

    PYTHONPATH=src python examples/torch_quickstart.py              # GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. balanced-prune a weight matrix (equal NZE per output row),
2. run the balanced-sparse CUDA kernel (its plain version on the CPU)
   against the dense result,
3. ask the analytical systolic model what the balance buys on hardware,
4. pick the DRAM-optimal dataflow for a layer (Adaptive Dataflow Config).
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.clustering import clustering_report
from repro_torch.core.dataflow import LayerSpec, choose_dataflow
from repro_torch.core.pruning import balanced_prune_rows, to_balanced_sparse
from repro_torch.core.systolic import SystolicConfig, layer_perf
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # 1 — load-balancing weight pruning (paper §III-A) ---------------------
    w = torch.randn((64, 256), generator=gen, device=dev)
    w_pruned, mask = balanced_prune_rows(w, sparsity=0.5)
    nze = (mask != 0).sum(dim=1)
    print(f"pruned to {int(nze[0])} NZE per kernel (all equal: "
          f"{bool((nze == nze[0]).all())}) — the balance invariant")

    # 2 — the balanced-sparse kernel (CUDA; its plain version on the CPU) --
    sp = to_balanced_sparse(w_pruned, k=int(nze[0]))
    x = torch.randn((8, 256), generator=gen, device=dev)
    y_sparse = ops.balanced_spmm(x, sp.values, sp.indices, n_in=256,
                                 impl="cuda")
    y_dense = x @ w_pruned.T
    print(f"balanced_spmm on {dev.type} matches dense: "
          f"{bool(torch.allclose(y_sparse, y_dense, atol=1e-4))}")

    # 3 — what the balance buys on a systolic array (paper Fig.3/Fig.4) ---
    layer = LayerSpec(name="conv", kind="conv", h_i=28, w_i=28, c_i=256,
                      c_o=512, h_k=3, w_k=3, padding=1,
                      ifm_sparsity=0.45, w_sparsity=0.5)
    sense = layer_perf(layer, "sense", SystolicConfig(),
                       np.random.default_rng(0))
    swallow = layer_perf(layer, "swallow", SystolicConfig(),
                         np.random.default_rng(0))
    print(f"layer cycles: sense={sense.cycles:,} swallow="
          f"{swallow.cycles:,} -> {swallow.cycles / sense.cycles:.2f}x from "
          "load balance")

    # channel clustering on a real (ReLU) feature map
    fmap = torch.relu(torch.randn((256, 28, 28), generator=gen, device=dev))
    rep = clustering_report(fmap, group=32)
    print(f"channel clustering: {rep.cycles_natural:,} -> "
          f"{rep.cycles_clustered:,} cycles ({rep.speedup:.3f}x)")

    # 4 — Adaptive Dataflow Configuration (paper §V-C) ---------------------
    ch = choose_dataflow(layer, weight_buffer_bits=160 * 36 * 1024)
    print(f"dataflow: {ch.mode} (RIF={ch.d_mem_rif:,}b RWF="
          f"{ch.d_mem_rwf:,}b) -> "
          f"{max(ch.d_mem_rif, ch.d_mem_rwf) / ch.d_mem_bits:.2f}x DRAM "
          "saved vs worst fixed choice")


if __name__ == "__main__":
    main()
