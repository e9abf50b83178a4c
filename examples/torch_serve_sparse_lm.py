"""Serve a small LM with batched requests through the Sense sparse path —
the PyTorch/CUDA port's twin of ``examples/serve_sparse_lm.py``.

    PYTHONPATH=src python examples/torch_serve_sparse_lm.py              # GPU
    PYTHONPATH=src python examples/torch_serve_sparse_lm.py --device cpu

Wraps `repro_torch.launch.serve` on the olmo-1b smoke config: one offline
pass balanced-prunes the projections, picks each layer's dataflow mode
(§V-C) and kernel impl (§VI-F) and pre-encodes the weights; prefill and
decode then execute the plan — on a GPU every planned projection runs the
hand-written CUDA kernels (their launches counted), on the CPU the eager
twin — and the sparse plan is held against its masked-dense reference.
Reports dense-vs-sparse tokens/s, the per-layer mode / impl mix and the
compressed weight footprint.  Any further arguments go to ``serve``.
"""
import argparse

from repro_torch.launch import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args, rest = ap.parse_known_args(argv)
    device = [] if args.device is None else ["--device", args.device]
    return serve.main(["--arch", "olmo-1b", "--smoke", "--batch", "8",
                       "--prompt-len", "32", "--gen-steps", "32",
                       "--sparsity", "0.5", *device, *rest])


if __name__ == "__main__":
    main()
