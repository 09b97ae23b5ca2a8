"""End-to-end training on the PyTorch / H100 port: a ~100M-parameter LM,
the twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py                  # the card
    PYTHONPATH=src python examples/train_lm_torch.py --quick --device cpu

Demonstrates the full substrate: the deterministic data pipeline, AdamW +
warmup-cosine, async checkpointing (resume with the same command), the
straggler watchdog, loss logging.  The weights come from a
``torch.Generator`` seeded with 0, so the losses are not ``train_lm.py``'s.
"""
import argparse
import json
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig, param_count
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.quick:
        cfg = ModelConfig(
            name="lm-10m", family="dense", n_layers=4, d_model=256,
            n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=8192, head_dim=64,
        )
        steps = args.steps or 50
        batch, seq = 4, 128
    else:
        # ~100M params: 12L x 512, 32k vocab
        cfg = ModelConfig(
            name="lm-100m", family="dense", n_layers=12, d_model=512,
            n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=32768, head_dim=64,
        )
        steps = args.steps or 200
        batch, seq = 4, 256

    device = resolve_device(args.device, "train_lm_torch")  # raises without a GPU on cuda
    tcfg = TrainerConfig(
        steps=steps, ckpt_every=max(steps // 4, 1), log_every=5,
        ckpt_dir=args.ckpt_dir, batch=batch, seq_len=seq,
    )
    opt = AdamWConfig(lr=6e-4, schedule=warmup_cosine(steps // 10, steps))
    trainer = Trainer(cfg, tcfg, opt, device=device)
    state = trainer.resume_or_init()
    print(f"{cfg.name}: {param_count(state.params) / 1e6:.1f}M params, "
          f"resuming at step {state.step}/{steps}")
    state = trainer.train(state)
    for h in trainer.history:
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in h.items()}))
    first = trainer.history[0]["loss"] if trainer.history else float("nan")
    last = trainer.history[-1]["loss"] if trainer.history else float("nan")
    print(f"loss {first:.3f} -> {last:.3f} over {state.step} steps")


if __name__ == "__main__":
    main()
