"""Hand-written CUDA kernels of the port (sources in ``csrc/``).

Each module holds one kernel's wrapper and, beside it, the plain PyTorch
version of the same function.  A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.
"""
