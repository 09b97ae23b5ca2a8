"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on meta tensors,
the port of ``repro.launch.dryrun``.

For each cell this:
  1. opens a fake process group of 256 (or 512) ranks in this process and
     builds the production mesh ((16, 16) single-pod / (2, 16, 16)
     multi-pod);
  2. builds the step function and its meta DTensor inputs, placed by the
     sharding rules;
  3. runs the step once on meta tensors under the mesh, as rank 0 of the
     fake group (no memory, no communication: ``lower_s`` is this trace;
     there is no compile, ``compile_s`` is null), counting the local work
     of one device (``roofline.counts.CostCounter``);
  4. derives the H100 roofline terms (``roofline.analysis``), a model of a
     cluster the port never ran on;
  5. writes the result to one JSON a cell (incremental across runs).

A comet cell is counted from its plan (``launch.specs.build_comet_cell``).

Usage:
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/dryrun]

results/dryrun is regenerable scratch (git-ignored).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from contextlib import contextmanager

from repro_torch.launch import specs

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "../../../results/dryrun")


def _cell_path(out_dir, arch, shape, multi_pod):
    mesh_tag = "multipod_2x16x16" if multi_pod else "pod_16x16"
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_tag}.json")


@contextmanager
def fake_process_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0:
    collectives on meta tensors return at once and nothing is sent.  The
    group is this process's default one while open."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _param_stats(arch):
    """(total_params, active_fraction) for MODEL_FLOPS."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api

    cfg = get_config(arch)
    named = dict(api.init_model(cfg, device="meta").named_parameters())
    total = sum(p.numel() for p in named.values())
    expert = sum(p.numel() for n, p in named.items()
                 if "moe" in n.split(".") and "router" not in n.split("."))
    if cfg.family == "moe" and expert:
        active = total - expert + expert * cfg.experts_per_token / cfg.n_experts
        return total, active / total
    return total, 1.0


def _leaves(tree):
    import torch

    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _local(t):
    from repro_torch.parallel.sharding import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def _memory(args, out, temp_bytes: int) -> dict:
    """``repro``'s memory record from the local shards: the step's inputs,
    its outputs (``alias_bytes`` those written in place into an input) and
    the peak of the storages made during the step."""
    def nbytes(t):
        return t.numel() * t.element_size()

    arg_local = [_local(t) for t in _leaves(args)]
    held = {id(t.untyped_storage()) for t in arg_local}
    out_local = [_local(t) for t in _leaves(out)]
    argument = sum(nbytes(t) for t in arg_local)
    output = sum(nbytes(t) for t in out_local)
    alias = sum(nbytes(t) for t in out_local if id(t.untyped_storage()) in held)
    return {
        "argument_bytes": argument,
        "output_bytes": output,
        "temp_bytes": temp_bytes,
        "alias_bytes": alias,
        "peak_bytes_est": argument + output + temp_bytes - alias,
    }


def _trace(arch, shape, mesh, multi_pod, overrides):
    """(terms, meta): one step of the cell, counted on one device."""
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.roofline.analysis import analyze
    from repro_torch.roofline.counts import CostCounter

    n_dev = mesh.size()
    if arch.startswith("comet"):
        count, _, meta = specs.build_comet_cell(arch, mesh, multi_pod, overrides)
        costs, memory = count()
        return analyze(costs, n_dev, memory=memory), meta
    fn, args, meta = specs.build_cell(arch, shape, mesh, overrides)
    with use_mesh(mesh), CostCounter() as cc:
        out = fn(*args)
    return analyze(cc.costs, n_dev, memory=_memory(args, out, cc.costs.peak_bytes)), meta


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             force: bool = False, tag: str = "", overrides=None) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline.analysis import model_flops

    path = _cell_path(out_dir, arch, shape, multi_pod)
    if tag:
        path = path.replace(".json", f"__{tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    with fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        terms, meta = _trace(arch, shape, mesh, multi_pod, overrides)
        t_lower = time.time() - t0
    if overrides:
        meta = dict(meta, overrides={k: str(v) for k, v in overrides.items()})

    print(f"== {arch} x {shape} ({'2x16x16' if multi_pod else '16x16'}) ==")
    print(terms["memory"])
    print({"flops": terms["flops_per_device"], "bytes accessed": terms["bytes_per_device"]})
    if "work_fraction" in meta:
        # comet: rescale the every-slot counts to the rank's round-robin
        # share (the ring's hops run on every rank)
        wf = meta["work_fraction"]
        terms["t_compute_static"] = terms["t_compute"]
        terms["t_memory_static"] = terms["t_memory"]
        terms["t_compute"] *= wf
        terms["t_memory"] *= wf
        terms["bottleneck"] = max(
            ("compute", terms["t_compute"]),
            ("memory", terms["t_memory"]),
            ("collective", terms["t_collective"]),
            key=lambda kv: kv[1],
        )[0]
        tb = max(terms["t_compute"], terms["t_memory"], terms["t_collective"])
        terms["roofline_fraction"] = terms["t_compute"] / tb if tb else 0.0
    result = dict(meta)
    result.update(
        multi_pod=multi_pod,
        mesh="2x16x16" if multi_pod else "16x16",
        lower_s=t_lower,
        compile_s=None,
        roofline=terms,
    )
    if not arch.startswith("comet"):
        n_params, active_frac = _param_stats(arch)
        tokens = meta["batch"] * (meta["seq"] if meta["kind"] != "decode" else 1)
        mf = model_flops(n_params, tokens, meta["kind"], active_frac)
        total = terms["flops_per_device"] * terms["n_devices"]
        result.update(
            n_params=n_params,
            active_fraction=active_frac,
            model_flops=mf,
            useful_flops_ratio=(mf / total) if total else 0.0,
        )
    else:
        # comparisons for the paper's metric: unique pairs / triples * n_f
        n_v = meta["n_v"]
        if meta["kind"] == "comet2way":
            comps = n_v * (n_v - 1) / 2 * meta["n_f"]
        else:
            comps = n_v * (n_v - 1) * (n_v - 2) / 6 * meta["n_f"] / meta["n_st"]
        result["elementwise_comparisons"] = comps
    with open(path, "w") as f:
        json.dump(result, f, indent=2, default=str)
    print(json.dumps({k: result[k] for k in ("arch", "shape", "mesh", "lower_s")},
                     default=str))
    print(f"  terms: compute={terms['t_compute']:.4e}s memory={terms['t_memory']:.4e}s"
          f" collective={terms['t_collective']:.4e}s -> {terms['bottleneck']}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", default="paper")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.normpath(DEFAULT_OUT))
    ap.add_argument("--tag", default="", help="suffix for experiment variants")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (repeatable)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        overrides[k] = v

    if args.list:
        for arch, shape in specs.cells():
            print(f"{arch:28s} {shape}")
        return 0

    todo = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        for arch, shape in specs.cells():
            for mp in meshes:
                todo.append((arch, shape, mp))
    else:
        if not args.arch:
            ap.error("--arch required (or --all)")
        for mp in meshes:
            todo.append((args.arch, args.shape, mp))

    failures = []
    for arch, shape, mp in todo:
        try:
            run_cell(arch, shape, mp, args.out, force=args.force, tag=args.tag,
                     overrides=overrides or None)
        except Exception:
            traceback.print_exc()
            failures.append((arch, shape, mp))
    if failures:
        print("FAILED CELLS:", failures)
        return 1
    print(f"all {len(todo)} cells OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
