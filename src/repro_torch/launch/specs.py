"""Input structs and step builders for every (arch x shape) dry-run cell, the
port of ``repro.launch.specs``.

Shapes:
    train_4k     seq=4096,   global_batch=256   -> train_step
    prefill_32k  seq=32768,  global_batch=32    -> prefill (cache fill)
    decode_32k   seq=32768,  global_batch=128   -> serve step (1 new token)
    long_500k    seq=524288, global_batch=1     -> serve step; SSM / hybrid only

``long_500k`` is skipped for pure full-attention archs (quadratic attention
at 524k) and runs for mamba2 (SSM) and zamba2 (hybrid).

``repro`` returns ``ShapeDtypeStruct``s that XLA lowers against; the port
returns meta DTensors placed by the sharding rules (no memory), which the
dry-run runs the step on eagerly under a fake process group.  A comet cell
cannot run on meta (its kernels launch through ``ctypes``): it is counted
from its plan (``build_comet_cell``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import api
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel.sharding import distribute, named_sharding, use_mesh
from repro_torch.roofline.counts import Costs
from repro_torch.train.step import make_train_step

DATA = ("pod", "data")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

LM_ARCHS = [
    "qwen1.5-0.5b",
    "llama3-8b",
    "command-r-plus-104b",
    "deepseek-67b",
    "qwen2-vl-2b",
    "grok-1-314b",
    "granite-moe-3b-a800m",
    "zamba2-1.2b",
    "mamba2-1.3b",
    "seamless-m4t-large-v2",
]
COMET_ARCHS = ["comet_2way", "comet_3way", "comet_2way_mxu", "comet_3way_mxu"]


def applicable(arch: str, shape: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "full quadratic attention at 524k seq — skipped (DESIGN §5)"
    return True, ""


def cells(include_comet: bool = True):
    """All runnable (arch, shape) dry-run cells."""
    out = []
    for arch in LM_ARCHS:
        for shape in SHAPES:
            ok, _ = applicable(arch, shape)
            if ok:
                out.append((arch, shape))
    if include_comet:
        out += [(a, "paper") for a in COMET_ARCHS]
    return out


def _prep_cfg(cfg: ModelConfig, kind: str) -> ModelConfig:
    # production settings: bf16 compute, remat for training
    return cfg.replace(
        compute_dtype="bfloat16",
        param_dtype="float32",
        remat="full" if kind == "train" else "none",
    )


def _md(mesh, shape, dtype, *spec):
    """A meta DTensor of ``shape`` placed by ``spec`` (filtered)."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    return distribute(t, mesh, named_sharding(mesh, *spec, shape=shape).placements)


def param_structs(cfg: ModelConfig, mesh):
    """The model on meta, each parameter a DTensor placed by the rules."""
    return api.distribute_model(cfg, api.init_model(cfg, device="meta"), mesh)


def opt_structs(cfg: ModelConfig, params, mesh):
    """AdamW moments placed as their parameters (``count`` a plain scalar,
    replicated where it meets them)."""
    return adamw_init(params)


def batch_structs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    B, S = shape.batch, shape.seq
    i32, bf16 = torch.int32, torch.bfloat16
    data = ("data", "model") if cfg.dp_only else DATA
    batch = {"labels": _md(mesh, (B, S), i32, data, None)}
    if cfg.family == "encdec":
        batch["src_embeds"] = _md(mesh, (B, S, cfg.d_model), bf16, data, None, None)
        batch["tokens"] = _md(mesh, (B, S), i32, data, None)
    elif cfg.family == "vlm":
        batch["embeds"] = _md(mesh, (B, S, cfg.d_model), bf16, data, None, None)
    else:
        batch["tokens"] = _md(mesh, (B, S), i32, data, None)
    return batch


def cache_structs(cfg: ModelConfig, params, batch: int, max_len: int, mesh):
    specs = api.cache_specs(cfg)
    if cfg.family == "encdec":
        # built by hand: init_cache runs the encoder, which the dry-run skips
        kv_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {
            "enc": _md(mesh, (batch, max_len, cfg.d_model), cfg.cdt, *specs["enc"]),
            "kv": {k: _md(mesh, kv_shape, cfg.cdt, *specs["kv"][k]) for k in ("k", "v")},
        }
    with use_mesh(mesh):
        return api.init_cache(cfg, params, batch, max_len)


def build_cell(arch: str, shape_name: str, mesh, overrides=None):
    """Returns (step_fn, args, meta): ``step_fn(*args)`` is one step on meta
    DTensors, to run under ``use_mesh(mesh)``."""
    shape = SHAPES[shape_name]
    cfg = _prep_cfg(get_config(arch), shape.kind)
    if overrides:
        cfg = cfg.replace(**overrides)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "seq": shape.seq, "batch": shape.batch}

    if shape.kind == "train":
        opt_cfg = AdamWConfig(schedule=warmup_cosine(2000, 100000))
        step = make_train_step(cfg, opt_cfg)
        if cfg.dp_only:
            from repro_torch.parallel.sharding import dp_only_mode

            inner = step

            def step(params, opt_state, batch):
                with dp_only_mode():
                    return inner(params, opt_state, batch)

        params = param_structs(cfg, mesh)
        opt = opt_structs(cfg, params, mesh)
        batch = batch_structs(cfg, shape, mesh)
        return step, (params, opt, batch), meta

    params = param_structs(cfg, mesh)
    cache = cache_structs(cfg, params, shape.batch, shape.seq, mesh)
    if shape.kind == "prefill":
        toks = _md(mesh, (shape.batch, shape.seq), torch.int32, DATA, None)
        idx = 0
    else:
        toks = _md(mesh, (shape.batch, 1), torch.int32, DATA, None)
        idx = shape.seq - 1

    @torch.no_grad()
    def serve(params, cache, tokens):
        return api.decode_step(cfg, params, cache, tokens, idx)

    return serve, (params, cache, toks), meta


# ------------------------------------------------------------- comet ----


def _block_costs(costs: Costs, ccfg, pairs: int, operands: int, out_entries: int):
    """One contraction of ``pairs`` result entries over n_f / n_pf fields,
    priced as the port's kernels price it (``obs.roofline``): min-plus, 2
    fp32 instructions a comparison; the level path, 2 b1 ops a (pair, plane,
    field).  Bytes: each operand block read once, the result written once."""
    from repro_torch.obs import roofline

    fields = ccfg.n_f // ccfg.n_pf
    if ccfg.levels:
        ops, unit = roofline.plane_ops(pairs, ccfg.levels, fields)
    else:
        ops, unit = roofline.value_ops(pairs * fields)
    costs.add_flops(float(ops), "vpu" if unit == "fp32" else unit)
    ring_bytes = torch.empty((), dtype=getattr(torch, ccfg.ring_dtype)).element_size()
    out_bytes = torch.empty((), dtype=getattr(torch, ccfg.out_dtype)).element_size()
    moved = operands * fields * ccfg.n_vp * ring_bytes + out_entries * out_bytes
    costs.bytes += moved
    costs.bytes_upper += moved


def build_comet_cell(arch: str, mesh, multi_pod: bool, overrides=None):
    """Returns (count, (), meta): ``count()`` gives one rank's ``Costs``,
    counted from the plan, and its memory record.  As ``repro``'s static cost analysis prices every
    round-robin branch, the counts cover every slot of the schedule (the
    dry-run rescales compute and memory by ``work_fraction``); the ring's
    hops move the rank's payload, a collective-permute each."""
    import dataclasses

    from repro_torch.core.plan2 import TwoWayPlan
    from repro_torch.core.plan3 import ThreeWayPlan

    ccfg = get_config(arch)
    if overrides:
        ccfg = dataclasses.replace(ccfg, **overrides)
    chips = mesh.size()
    n_pf, n_pv, n_pr = ccfg.decomposition(chips, multi_pod)
    n_v = ccfg.n_vp * n_pv
    m = ccfg.n_vp
    if ccfg.way == 2:
        plan = TwoWayPlan(n_pv, n_pr)
        work_fraction = plan.slots_per_rank / plan.n_steps
    else:
        plan = ThreeWayPlan(n_pv, n_pr, ccfg.n_st)
        work_fraction = plan.slots_per_rank / plan.items_per_slab
    ring_bytes = torch.empty((), dtype=getattr(torch, ccfg.ring_dtype)).element_size()
    payload = (ccfg.n_f // n_pf) * m * ring_bytes

    def count() -> tuple[Costs, dict]:
        costs = Costs()
        if ccfg.way == 2:
            for d in range(plan.n_steps):
                pairs = m * (m - 1) // 2 if d == 0 else m * m
                _block_costs(costs, ccfg, pairs, 1 if d == 0 else 2, pairs)
        else:
            L = m // (6 * ccfg.n_st)
            for _ in range(plan.items_per_slab):
                # the slice (L, m, m) and its three pair terms
                _block_costs(costs, ccfg, L * m * m, 3, L * m * m)
                _block_costs(costs, ccfg, 2 * L * m + m * m, 0, 2 * L * m + m * m)
        hops = plan.ring_steps
        if hops:
            costs.operand_bytes["collective-permute"] += hops * payload
            costs.wire_bytes["collective-permute"] += hops * payload
            costs.counts["collective-permute"] += hops
            costs.bytes += 2 * hops * payload
            costs.bytes_upper += 2 * hops * payload
        return costs, memory

    meta = {
        "arch": arch, "shape": "paper", "kind": f"comet{ccfg.way}way",
        "n_f": ccfg.n_f, "n_v": n_v, "n_pf": n_pf, "n_pv": n_pv, "n_pr": n_pr,
        "n_st": ccfg.n_st, "impl": ccfg.impl, "work_fraction": work_fraction,
    }
    # the rank's payload, its slots of results, the carried ring payloads
    out_bytes = torch.empty((), dtype=getattr(torch, ccfg.out_dtype)).element_size()
    block = m * m if ccfg.way == 2 else (m // (6 * ccfg.n_st)) * m * m
    memory = {
        "argument_bytes": payload,
        "output_bytes": plan.slots_per_rank * block * out_bytes,
        "temp_bytes": (1 if ccfg.way == 2 else 2) * payload,
        "alias_bytes": 0,
    }
    memory["peak_bytes_est"] = (memory["argument_bytes"] + memory["output_bytes"]
                                + memory["temp_bytes"])
    return count, (), meta
