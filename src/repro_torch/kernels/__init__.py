"""Hand-written CUDA kernels for RAP's hot spots on Hopper.

Each kernel ships a CUDA source (``csrc/<name>.cu``, built by
``build.py`` at first use), its plain PyTorch version and launch wrapper in
``<name>.py``, and a dispatch entry with a launch counter in ``ops.py``.
"""
