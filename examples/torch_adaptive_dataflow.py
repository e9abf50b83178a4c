"""Adaptive Dataflow Configuration walkthrough of the PyTorch/CUDA port
(paper §V-C, Fig.15/22).

    PYTHONPATH=src python examples/torch_adaptive_dataflow.py              # GPU
    PYTHONPATH=src python examples/torch_adaptive_dataflow.py --device cpu

Walks ResNet-50 layer by layer, showing I_mem/W_mem, the RIF and RWF DRAM
costs, which mode the adaptive configuration picks, and the network totals
vs Swallow's fixed compute-in-row (RIF) dataflow.  Then builds an
*executable* layer plan for the small CNN (`engine.plan`) to show the same
per-layer decisions — dataflow mode, kernel impl, block sizes — attached
to weights that actually run, and runs it once.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.dataflow import choose_dataflow, network_dram_access
from repro_torch.core.pruning import balanced_prune_conv, balanced_prune_rows
from repro_torch.core.systolic import SystolicConfig
from repro_torch.engine.plan import plan_smallcnn
from repro_torch.models.cnn import (SmallCNNConfig, network_layers,
                                    smallcnn_apply, smallcnn_init)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = SystolicConfig()
    layers = network_layers("resnet50", "sense")
    print(f"{'layer':16s} {'I_mem(Kb)':>10s} {'W_mem(Kb)':>10s} "
          f"{'RIF(Kb)':>10s} {'RWF(Kb)':>10s} {'mode':>8s}")
    shown = 0
    for ls in layers:
        ch = choose_dataflow(ls, n_is=cfg.n_is, n_pe=cfg.n_pe,
                             weight_buffer_bits=cfg.weight_buffer_bits)
        if ch.mode != "ON_CHIP" and shown < 14:
            print(f"{ls.name:16s} {ch.i_mem/1e3:10.0f} {ch.w_mem/1e3:10.0f} "
                  f"{ch.d_mem_rif/1e3:10.0f} {ch.d_mem_rwf/1e3:10.0f} "
                  f"{ch.mode:>8s}")
            shown += 1
    for net in ("alexnet", "vgg16", "resnet50", "googlenet"):
        ls = network_layers(net, "sense")
        kw = dict(n_is=cfg.n_is, n_pe=cfg.n_pe,
                  weight_buffer_bits=cfg.weight_buffer_bits)
        a = network_dram_access(ls, adaptive=True, **kw)
        f = network_dram_access(ls, adaptive=False, **kw)
        print(f"{net:10s}: adaptive {a['total_bits']/8e6:8.1f} MB  "
              f"fixed-RIF {f['total_bits']/8e6:8.1f} MB  "
              f"reduction {f['total_bits']/a['total_bits']:.2f}x  "
              f"(RWF on {a['frac_rwf']*100:.0f}% of layers)")

    # the same decisions as an executable plan (engine.plan): prune the
    # small CNN, build its layer plan on the device, print the mode/impl
    # decisions the path dispatches on, and run one batch through it
    scfg = SmallCNNConfig()
    params = smallcnn_init(scfg, torch.Generator(device=dev).manual_seed(0))
    masks = {}
    for i in range(len(scfg.channels)):
        _, masks[f"conv{i}"] = balanced_prune_conv(params[f"conv{i}"], 0.5)
    for name in ("fc1", "fc2"):
        _, masks[name] = balanced_prune_rows(params[name], 0.8)
    plan = plan_smallcnn(scfg, params, masks,
                         weight_buffer_bits=cfg.weight_buffer_bits)
    print(f"\nexecutable layer plan (smallcnn, engine.plan, {dev.type}):")
    print(plan.summary())
    x = torch.randn((8, scfg.img, scfg.img, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        logits = smallcnn_apply(scfg, params, x, plan=plan)
    print(f"logits {tuple(logits.shape)}, finite: "
          f"{bool(torch.isfinite(logits).all())}")


if __name__ == "__main__":
    main()
