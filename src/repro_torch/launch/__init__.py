"""Serving and training launchers, and the analysis tools (``dryrun``,
``rap_sweep``) that count the port's steps at the production mesh."""


def resolve_device(name: str):
    """The torch device an entry point's ``--device`` names: ``cuda`` (the
    default; raises without a GPU) or ``cpu`` (the kernels' plain
    versions)."""
    import torch
    if name != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu to run "
                           "the plain versions on the CPU")
    return torch.device(name)
