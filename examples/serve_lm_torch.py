"""Batched serving on the PyTorch / H100 port: prefill + decode with a KV
cache, the twin of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch llama3-8b   # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
(the reduced smoke config; the weights come from a ``torch.Generator``
seeded with 0, so the tokens are not ``serve_lm.py``'s)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import api
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    device = resolve_device(args.device, "serve_lm_torch")  # raises without a GPU on cuda
    params = api.init_model(cfg, generator=torch.Generator(device).manual_seed(0),
                            device=device)
    eng = ServeEngine(
        cfg, params,
        ServeConfig(max_new_tokens=args.tokens, temperature=args.temperature),
        device=device,
    )
    prompts = np.random.default_rng(0).integers(
        3, cfg.vocab_size, (args.batch, 8)
    ).astype(np.int32)
    t0 = time.time()
    out = eng.generate(prompts)
    dt = time.time() - t0
    print(f"{cfg.name}: {out.size} tokens in {dt:.2f}s ({out.size / dt:.1f} tok/s)")
    for r, row in enumerate(out):
        print(f"  seq{r}: {row.tolist()}")


if __name__ == "__main__":
    main()
