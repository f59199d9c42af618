"""RAP (Runtime Adaptive Pruning) in PyTorch, for NVIDIA Hopper GPUs.

The port of the JAX package ``repro`` (which stays the reference): the same
module layout, the JAX layouts at public functions, and hand-written CUDA
kernels in place of the Pallas TPU kernels (``repro_torch.kernels``).
Nothing here imports JAX or ``repro``.
"""
