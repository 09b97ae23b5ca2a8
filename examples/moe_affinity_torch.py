"""MoE router analysis with the PyTorch / H100 port's similarity engine,
the twin of ``examples/moe_affinity.py``: which experts see similar token
populations?

Routes a synthetic batch through a smoke-scale MoE, builds per-expert
token-histogram profile vectors, and runs all-pairs Czekanowski similarity
over experts: a high c2 means two experts serve near-identical token
distributions (a sign of redundancy or collapsed routing).

    PYTHONPATH=src python examples/moe_affinity_torch.py             # the card
    PYTHONPATH=src python examples/moe_affinity_torch.py --device cpu

The weights come from a ``torch.Generator`` seeded with 0, so the pairs
and loads are not ``moe_affinity.py``'s.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.twoway import CometConfig, czek2_distributed
from repro_torch.models import api
from repro_torch.parallel.mesh import make_comet_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "moe_affinity_torch")  # raises without a GPU

    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = api.init_model(cfg, generator=torch.Generator(device).manual_seed(0),
                            device=device)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (8, 64)), dtype=torch.int32,
                             device=device)

    # router logits of layer 0
    with torch.no_grad():
        x = params.embed[tokens.long()]
        logits = x.float() @ params.layers[0].moe.router
        _, expert_ids = torch.topk(torch.softmax(logits, dim=-1), cfg.experts_per_token)
    expert_ids = expert_ids.cpu().numpy().reshape(-1, cfg.experts_per_token)
    flat_tokens = tokens.cpu().numpy().reshape(-1)

    # per-expert token histogram profiles (hashed)
    H = 256
    V = np.zeros((H, cfg.n_experts), np.float32)
    for t, row in zip(flat_tokens, expert_ids):
        for e in row:
            V[t % H, e] += 1.0

    out = czek2_distributed(V, make_comet_mesh(1, 1, 1, devices=[device]),
                            CometConfig(out_dtype="float32"))
    pairs = [(i, j, w) for I, J, W in out.entries() for i, j, w in zip(I, J, W)]
    pairs.sort(key=lambda t: -t[2])
    print(f"{cfg.n_experts} experts, top-{cfg.experts_per_token} routing")
    print("most similar expert pairs (token-population overlap):")
    for i, j, w in pairs[:5]:
        print(f"  expert{i} ~ expert{j}: c2={w:.3f}")
    loads = V.sum(axis=0)
    print("expert loads:", loads.astype(int).tolist())


if __name__ == "__main__":
    main()
