"""End-to-end training on the PyTorch port, with the fault-tolerance
plumbing: a step-indexed data pipeline, async checkpoints in the JAX
package's format, crash-resume (kill it mid-run and rerun the same
command), straggler logging, and a final held-out evaluation.

  PYTHONPATH=src python examples/train_e2e_torch.py --size small --steps 300
  PYTHONPATH=src python examples/train_e2e_torch.py --size 100m --steps 300
  PYTHONPATH=src python examples/train_e2e_torch.py --size smoke --steps 4 \
      --device cpu

The twin of ``examples/train_e2e.py`` on ``repro_torch``. ``small`` is
the ~13M-parameter RAP subject, ``100m`` the same family at ~100M
parameters (24 layers x 512), ``smoke`` the 2-layer SMOKE config.
Checkpoints go to ``--ckpt-dir`` (default ``experiments/rap_e2e_ckpt_torch``
beside ``src/``).
"""
import argparse
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.llama2_7b import RAP_SUBJECT
from repro_torch.data import SyntheticCorpus, batch_iterator
from repro_torch.launch import resolve_device
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer, TrainerConfig

SIZES = {
    "smoke": get_smoke_config("llama2-7b"),
    # ~13M
    "small": RAP_SUBJECT,
    # ~100M of the same family (24L × 512d), the few-hundred-step target
    "100m": RAP_SUBJECT.replace(name="subject-100m", n_layers=24,
                                d_model=512, n_heads=8, n_kv_heads=8,
                                head_dim=64, d_ff=1536, vocab_size=8192,
                                vocab_round_to=512),
}
CKPT_DIR = Path(__file__).resolve().parents[1] / "experiments" / \
    "rap_e2e_ckpt_torch"


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=SIZES, default="small")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = SIZES[args.size]
    model = registry.build(cfg)
    n = cfg.total_params()
    print(f"model: {cfg.name}  ~{n/1e6:.1f}M params on {device}")
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)

    trainer = Trainer(
        model,
        adamw.AdamWConfig(lr=1e-3, total_steps=args.steps,
                          warmup_steps=min(30, args.steps)),
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=50, log_every=min(25, args.steps)),
        on_log=lambda s, m: print(f"step {s:5d}  loss {m['loss']:.4f}  "
                                  f"ppl {m['ppl']:8.2f}  lr {m['lr']:.2e}",
                                  flush=True),
        on_straggler=lambda s, dt: print(f"  !! straggler at step {s}: "
                                         f"{dt:.2f}s"),
        device=device)
    resumed = trainer.maybe_restore()
    if resumed:
        print(f"resuming from step {trainer.step}")
    batches = batch_iterator(corpus, args.batch, args.seq,
                             start=trainer.step)
    summary = trainer.run(batches)

    # held-out evaluation
    ev = {k: torch.from_numpy(v).to(device) for k, v in corpus.batch(
        8, args.seq, split="eval").items()}
    with torch.no_grad():
        loss, aux = model.loss(trainer.params, ev)
    ppl = float(aux["ppl"])
    print(f"\nfinal: step {summary['final_step']}  "
          f"held-out ppl {ppl:.2f}  "
          f"stragglers {len(summary['straggler_events'])}")
    return {"summary": summary, "resumed": resumed, "heldout_ppl": ppl,
            "loss": float(loss)}


if __name__ == "__main__":
    main()
