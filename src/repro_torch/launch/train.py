"""Training launcher: the port's ``Trainer`` from the command line.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --steps 50
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --device cpu

The port of ``repro.launch.train``: the same flags and output lines
(``arch=… params=…M resume_step=…``, one JSON line per logged step,
``done @ step N; stragglers=K``), plus ``--device {cuda,cpu}`` (default
``cuda``; exit 2 without a card).  ``--smoke`` selects the reduced config;
without it the full config.  It restarts from the latest checkpoint in
``--ckpt-dir``.  The weights are drawn from a ``torch.Generator`` seeded
with ``--seed`` on the device, so the losses are not ``repro``'s.
"""
import argparse
import json
import os
import sys
import tempfile

from repro_torch.launch import no_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if no_device(args.device):
        return 2

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models.common import param_count
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, log_every=args.log_every,
        ckpt_dir=args.ckpt_dir, seed=args.seed, batch=args.batch,
        seq_len=args.seq_len,
    )
    opt = AdamWConfig(lr=args.lr, schedule=warmup_cosine(args.steps // 10, args.steps))
    trainer = Trainer(cfg, tcfg, opt, device=args.device)
    state = trainer.resume_or_init()
    n = param_count(state.params)
    print(f"arch={cfg.name} params={n / 1e6:.1f}M resume_step={state.step}")
    state = trainer.train(state)
    for h in trainer.history:
        print(json.dumps(h))
    print(f"done @ step {state.step}; stragglers={len(trainer.watchdog.events)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
