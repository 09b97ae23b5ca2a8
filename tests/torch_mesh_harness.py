"""Process groups and meshes for the port's mesh tests.

* ``gloo_mesh(dir)``: a one-rank gloo group opened in the test's own
  process (a ``file://`` store, no network) and its ``DeviceMesh``, the
  group destroyed on exit;
* ``run_on_ranks(case, shape, *args)``: ``case(mesh, *args)`` on
  prod(shape) gloo ranks, each a process started by this file run as a
  script, and rank 0's result;
* the cases: ``lm_case`` (the loss and every gradient of a smoke config,
  then a prefill and a decode step, on the mesh against no mesh).

Run as a script by ``run_on_ranks`` only.
"""
from __future__ import annotations

import contextlib
import math
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def gloo_mesh(directory, shape=(1, 1), names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{directory}/pg_store",
                            world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def run_on_ranks(case: str, shape: tuple, *args, timeout: int = 240):
    """``case(mesh, *args)`` on a ("data", "model") mesh of ``shape``, one
    gloo rank a process; returns rank 0's result."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, "..", "src"),
                                         env.get("PYTHONPATH", "")])
    env.setdefault("OMP_NUM_THREADS", "2")
    world = math.prod(shape)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "job.pkl"), "wb") as f:
            pickle.dump((case, tuple(shape), args), f)
        procs = [subprocess.Popen([sys.executable, __file__, d, str(r), str(world)], env=env)
                 for r in range(world)]
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(rcs):
            raise RuntimeError(f"ranks exited {rcs}")
        with open(os.path.join(d, "out.pkl"), "rb") as f:
            return pickle.load(f)


def _batch(cfg, B: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    batch = {"labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model),
                                                                   dtype=np.float32))
        batch["tokens"] = toks
    elif cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model),
                                                               dtype=np.float32))
    else:
        batch["tokens"] = toks
    return batch, toks


def lm_case(mesh, arch: str, B: int = 4, S: int = 16):
    """Max differences, mesh against no mesh, of a smoke config's loss,
    gradients (each leaf gathered whole) and prefill / decode logits."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import api
    from repro_torch.optim.adamw import named_params
    from repro_torch.parallel.sharding import full_tensor, place_batch, use_mesh

    cfg = get_smoke_config(arch)
    batch, toks = _batch(cfg, B, S, seed=1)

    def place(t):
        return place_batch(t, mesh)

    out = {}
    for use in (False, True):
        model = api.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        b = {k: place(v) for k, v in batch.items()} if use else batch
        if use:
            api.distribute_model(cfg, model, mesh)
        with use_mesh(mesh if use else None):
            named = named_params(model)
            loss = api.model_loss(cfg, model, b)
            grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                        materialize_grads=True)
            res = {"loss": full_tensor(loss).detach(),
                   "grads": {n: full_tensor(g) for n, g in zip(named, grads)}}
            if cfg.family != "encdec":
                with torch.no_grad():
                    cache = api.init_cache(cfg, model, B, 2 * S)
                    t = place(toks[:, :8]) if use else toks[:, :8]
                    lg0, cache = api.decode_step(cfg, model, cache, t, 0)
                    t1 = place(toks[:, 8:9]) if use else toks[:, 8:9]
                    lg1, cache = api.decode_step(cfg, model, cache, t1, 8)
                res["logits"] = torch.cat([full_tensor(lg0), full_tensor(lg1)], dim=1)
        out[use] = res
    plain, meshed = out[False], out[True]
    errs = {n: float((plain["grads"][n] - meshed["grads"][n]).abs().max())
            for n in plain["grads"]}
    worst = max(errs, key=errs.get)
    diff = {"loss": float((plain["loss"] - meshed["loss"]).abs()), "grad": errs[worst],
            "worst": worst, "worst_scale": float(plain["grads"][worst].abs().max())}
    if "logits" in plain:
        diff["logits"] = float((plain["logits"] - meshed["logits"]).abs().max())
    return diff


def lm_cases(mesh, archs):
    return {a: lm_case(mesh, a) for a in archs}


CASES = {"lm_case": lm_case, "lm_cases": lm_cases}


def _main(directory: str, rank: int, world: int):
    from torch.distributed.device_mesh import init_device_mesh

    with open(os.path.join(directory, "job.pkl"), "rb") as f:
        case, shape, args = pickle.load(f)
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    dist.init_process_group("gloo", init_method=f"file://{directory}/pg_store",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        result = CASES[case](mesh, *args)
        if rank == 0:
            with open(os.path.join(directory, "out.pkl"), "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
