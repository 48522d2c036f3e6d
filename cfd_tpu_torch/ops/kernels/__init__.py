"""Hand-written CUDA kernels and their plain PyTorch versions
(counterpart of `cfd_tpu/ops/pallas/`)."""
