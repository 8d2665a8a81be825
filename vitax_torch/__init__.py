"""vitax_torch — the PyTorch/CUDA port of vitax for NVIDIA Hopper (H100).

A second package beside `vitax/`, with vitax's module names and parameter
layouts. It imports torch and numpy, never jax or vitax. Its hand-written
CUDA kernels live in `csrc/` and are built at first use
(`vitax_torch.kernels.build`).
"""
