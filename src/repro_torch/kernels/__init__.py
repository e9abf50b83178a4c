"""Tile-local balanced-sparse format, the hand-written CUDA kernels
(`balanced_spmm`, sources in ``csrc/``) and their public wrappers (`ops`)."""
