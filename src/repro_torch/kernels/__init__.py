"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(port of `repro.kernels`). Importing this package builds nothing: a kernel
is compiled by `build.py` at its first launch."""
