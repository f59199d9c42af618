"""Training launcher.

  python -m repro_torch.launch.train --arch llama2-7b --smoke \
      --steps 200 --ckpt-dir /path/to/ckpt [--device cpu]

Trains ``--arch`` (``--smoke``: its reduced config) on the synthetic
corpus with AdamW (a vision-language model with zero ``vision_embeds``
prepended, an encoder-decoder model on zero ``frames``, as JAX's
launcher does), checkpointing in the JAX package's format every
``--ckpt-every`` steps. The trainer resumes from the latest checkpoint
automatically: rerunning the same command after a crash (or with more
``--steps``) continues the run and prints "resumed from checkpoint at step
N". Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on
the CPU instead. ``--mesh`` trains on JAX's host mesh, (world, 1) ("data",
"model") over the running world — one process per card under
``torchrun --nproc-per-node N -m repro_torch.launch.train --mesh``, a
world of one without torchrun — with NCCL on the card and gloo on the CPU.
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", action="store_true",
                    help="train on a (world, 1) data-parallel mesh over the "
                         "running world (torchrun's ranks, else one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def extra_inputs(cfg, batch: int, device) -> Optional[dict]:
    """The stub frontends' inputs every batch carries, zeros in the model
    dtype as in JAX's launcher: a ``vlm`` model's ``vision_embeds [batch,
    n_vision_tokens, d_model]`` (prepended to the tokens), an
    encoder-decoder model's ``frames [batch, n_audio_frames, d_model]``;
    None for the others."""
    import torch
    if cfg.family == "vlm":
        return {"vision_embeds": torch.zeros(
            batch, cfg.n_vision_tokens, cfg.d_model,
            dtype=cfg.torch_dtype(), device=device)}
    if cfg.is_encoder_decoder:
        return {"frames": torch.zeros(
            batch, cfg.n_audio_frames, cfg.d_model, dtype=cfg.torch_dtype(),
            device=device)}
    return None


def main(argv: Optional[List[str]] = None) -> dict:
    """Parse ``argv``, train, print the log; returns ``Trainer.run``'s
    summary."""
    args = _parser().parse_args(argv)
    from repro_torch.launch import resolve_device
    device = resolve_device(args.device)
    if not args.mesh:
        return _train(args, device, None)
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy_distributed, make_host_mesh
    started = not dist.is_initialized()
    try:
        mesh = make_host_mesh(device=device)
        print(f"mesh: {dict(mesh.shape)} over {mesh.size} ranks")
        return _train(args, device, mesh)
    finally:
        if started:
            destroy_distributed()


def _train(args, device, mesh) -> dict:
    """Train on ``mesh`` (None: meshless) and print the log."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticCorpus, batch_iterator
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = registry.build(cfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
    trainer = Trainer(
        model,
        adamw.AdamWConfig(lr=args.lr, total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, seed=args.seed,
                      log_every=max(args.steps // 20, 1)),
        on_log=lambda s, m: print(
            f"step {s:5d}  loss {m['loss']:.4f}  ppl {m['ppl']:.2f}  "
            f"gnorm {m['grad_norm']:.3f}", flush=True),
        device=device, mesh=mesh)
    start = trainer.step if trainer.maybe_restore() else 0
    if start:
        print(f"resumed from checkpoint at step {start}")
    batches = batch_iterator(corpus, args.batch, args.seq, start=start,
                             extra=extra_inputs(cfg, args.batch, device))
    summary = trainer.run(batches)
    print(f"done at step {summary['final_step']}; "
          f"stragglers observed: {len(summary['straggler_events'])}")
    return summary


if __name__ == "__main__":
    main()
