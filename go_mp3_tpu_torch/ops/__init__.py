"""The granule DSP chain: plain PyTorch version (granule), CUDA kernel
wrappers (kernels), tables, and the kernel build (_build)."""
