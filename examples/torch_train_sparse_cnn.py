"""End-to-end example of the PyTorch/CUDA port: train a CNN, then run the
paper's load-balancing prune -> retrain flow (Fig. 5) and check "little
accuracy loss".

    PYTHONPATH=src python examples/torch_train_sparse_cnn.py              # GPU
    PYTHONPATH=src python examples/torch_train_sparse_cnn.py --device cpu

Pipeline: synthetic labeled images -> dense training (300 steps) ->
balanced pruning at the paper's CONV 50% per kernel / FC 80% ratios (the
fc layers by magnitude, unbalanced, so they stay dense) -> masked
retraining (150 steps; the pruned convs run the balanced-sparse CUDA
kernels forward, their plain versions on the CPU) -> accuracy + the
systolic-model speedup.  Fails unless the final sparse accuracy is within
0.05 of the dense one.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core.dataflow import LayerSpec
from repro_torch.core.pruning import balanced_prune_conv, random_prune
from repro_torch.core.systolic import SystolicConfig, network_perf
from repro_torch.data import SyntheticImageData
from repro_torch.models.cnn import (SmallCNNConfig, smallcnn_accuracy,
                                    smallcnn_init, smallcnn_train)
from repro_torch.optim import apply_masks


def run(*, device, steps: int = 300, retrain_steps: int = 150,
        on_retrain_step=None, log=print) -> dict:
    """The whole flow on ``device``; ``on_retrain_step(s, params, loss,
    masks)`` is called after each retraining step.  Returns the accuracies, the
    modeled speedup, the masks and the retrained params."""
    dev = resolve_device(device)
    cfg = SmallCNNConfig()
    data = SyntheticImageData(batch=64, device=dev)
    params = smallcnn_init(cfg, torch.Generator(device=dev).manual_seed(0))

    log("[1/3] dense training")
    t0 = time.time()
    params = smallcnn_train(cfg, params, data, steps, log=log)
    acc_dense = smallcnn_accuracy(cfg, params, data)
    log(f"  dense accuracy: {acc_dense:.3f}  ({time.time() - t0:.0f}s)")

    log("[2/3] load-balancing pruning (CONV 50% per kernel, FC 80%)")
    masks = {}
    for i in range(len(cfg.channels)):
        _, masks[f"conv{i}"] = balanced_prune_conv(params[f"conv{i}"], 0.5)
    for name in ("fc1", "fc2"):
        _, masks[name] = random_prune(params[name], 0.8)
    pruned = apply_masks(params, masks)
    acc_pruned = smallcnn_accuracy(cfg, pruned, data, masks=masks)
    # the balance invariant on every conv kernel
    for i in range(len(cfg.channels)):
        m = masks[f"conv{i}"]
        counts = (m.reshape(m.shape[0], -1) != 0).sum(dim=1)
        if not bool((counts == counts[0]).all()):
            raise AssertionError(f"conv{i}: balance invariant violated")
    log(f"  post-prune accuracy (no retrain): {acc_pruned:.3f}")

    log("[3/3] masked retraining (paper Fig.5)")
    retrained = smallcnn_train(cfg, pruned, data, retrain_steps, masks=masks,
                               lr=3e-4, start_step=steps,
                               on_step=None if on_retrain_step is None
                               else lambda s, p, loss: on_retrain_step(
                                   s, p, loss, masks), log=log)
    acc_final = smallcnn_accuracy(cfg, retrained, data, masks=masks)
    log(f"  final sparse accuracy: {acc_final:.3f} "
        f"(dense {acc_dense:.3f}, loss {acc_dense - acc_final:+.3f})")

    # what the pruning buys on the systolic array
    layers = [LayerSpec(name=f"conv{i}", kind="conv",
                        h_i=cfg.img // (2 ** i), w_i=cfg.img // (2 ** i),
                        c_i=((3,) + cfg.channels)[i],
                        c_o=cfg.channels[i], h_k=3, w_k=3, padding=1,
                        ifm_sparsity=0.45, w_sparsity=0.5)
              for i in range(len(cfg.channels))]
    sense = network_perf(layers, "sense", SystolicConfig())
    dense = network_perf(layers, "dense", SystolicConfig())
    speedup = dense.total_cycles / sense.total_cycles
    log(f"  systolic model: {speedup:.2f}x speedup from the co-design on "
        "this net")
    if acc_final < acc_dense - 0.05:
        raise AssertionError(f"accuracy loss exceeds 5%: dense {acc_dense}, "
                             f"sparse {acc_final}")
    return {"acc_dense": acc_dense, "acc_pruned": acc_pruned,
            "acc_final": acc_final, "systolic_speedup": speedup,
            "cfg": cfg, "data": data, "masks": masks, "params": retrained}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--retrain-steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device, steps=args.steps,
        retrain_steps=args.retrain_steps)
    print("OK")


if __name__ == "__main__":
    main()
