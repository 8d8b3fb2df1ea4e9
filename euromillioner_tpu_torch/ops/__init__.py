"""Hand-written CUDA kernels for Hopper (sources in ../csrc/), each with
its plain PyTorch version beside it."""
