"""Serving and training launchers."""


def resolve_device(name: str):
    """The torch device an entry point's ``--device`` names: ``cuda`` (the
    default; raises without a GPU) or ``cpu`` (the kernels' plain
    versions)."""
    import torch
    if name != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu to run "
                           "the plain versions on the CPU")
    return torch.device(name)
