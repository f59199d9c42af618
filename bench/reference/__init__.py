"""The plain reference: the served decoders (``model``) and the RAP
controller's arithmetic (``controller``) in plain PyTorch, float32 with
TF32 off, computed layer by layer so that they fit beside the weights.

It imports nothing of the program (``repro_torch``), of the JAX package
(``repro``) or of JAX; it reads the weights the benchmark drew, and the
program's outputs only to judge them.
"""
