"""Multi-GPU execution: the sharding rules (``sharding``), the mesh policy
the model code reads (``activation``), the tensor-parallel collectives
(``tp``) and the compressed DP all-reduce (``compression``)."""
from repro_torch.parallel.sharding import (P, batch_pspecs, cache_pspecs,
                                           gather_leaf, param_pspecs,
                                           serve_slot_pspec,
                                           serve_state_pspecs, shard_leaf)

__all__ = ["P", "param_pspecs", "batch_pspecs", "cache_pspecs",
           "serve_state_pspecs", "serve_slot_pspec", "shard_leaf",
           "gather_leaf"]
