"""Serving launcher: batched LM generation on the port's ``ServeEngine``.

    python -m repro_torch.launch.serve --arch llama3-8b --smoke --batch 4 --tokens 16
    python -m repro_torch.launch.serve --arch llama3-8b --smoke --device cpu

The port of ``repro.launch.serve``: the same flags and output lines
(``arch=… batch=… new_tokens=…``, ``generated … tok/s``, the first rows,
``metrics=…`` with ``--metrics-json``), plus ``--device {cuda,cpu}``
(default ``cuda``).  The weights are drawn from a ``torch.Generator``
seeded with ``--seed`` on the device, so the tokens are not ``repro``'s.
"""
import argparse
import sys
import time

from repro_torch.launch import no_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-json", default="", metavar="OUT.json",
                    help="write the engine's metrics-registry snapshot "
                         "(request/token counters, prefill and decode-step "
                         "latency histograms) to OUT.json after the run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if no_device(args.device):
        return 2

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models import api
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = api.init_model(
        cfg, generator=torch.Generator(args.device).manual_seed(args.seed),
        device=args.device)
    eng = ServeEngine(
        cfg, params,
        ServeConfig(max_new_tokens=args.tokens, temperature=args.temperature),
        device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(3, cfg.vocab_size, (args.batch, args.prompt_len)).astype(
        np.int32
    )
    t0 = time.time()
    out = eng.generate(prompts)
    dt = time.time() - t0
    total = out.size
    print(f"arch={cfg.name} batch={args.batch} new_tokens={args.tokens}")
    print(f"generated {total} tokens in {dt:.2f}s = {total / dt:.1f} tok/s")
    for row in out[: min(4, len(out))]:
        print("  ", row.tolist())
    if args.metrics_json:
        import json

        with open(args.metrics_json, "w") as f:
            json.dump(eng.registry.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"metrics={args.metrics_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
