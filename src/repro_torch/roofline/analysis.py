"""Three-term roofline of a dry-run cell, the counterpart of
``repro.roofline.analysis``.

``repro`` prices a compiled XLA module against TPU v5e constants; the port
prices ``counts.CostCounter``'s per-device counts of an eager step against
H100 SXM constants, all from ``repro_torch.obs.roofline`` (one source,
the data-sheet numbers ``chip_smoke.py``'s bounds use too):

* bf16 tensor cores 989e12 FLOP/s, fp32 matmuls on the CUDA cores 67e12
  FLOP/s (an FFMA counting 2), min-plus 33.5e12 instructions/s (``repro``'s
  "VPU" term), b1 plane ops 1.024e16 ops/s, int8 1,979e12 ops/s;
* HBM 3.35e12 B/s;
* one 50e9 B/s link a card (NDR 400 Gb/s InfiniBand: a 16 x 16 mesh spans
  32 hosts of 8 cards).

The terms are per device and per step: ``t_compute`` the flops over their
unit's rate, ``t_memory`` the modeled bytes over HBM, ``t_collective`` the
modeled wire bytes over one link.  They model a cluster the port never ran
on; no number here was measured.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.obs import roofline as _obs
from repro_torch.roofline.counts import Costs

__all__ = ["Hardware", "HW_H100", "analyze", "unit_seconds", "model_flops"]


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float  # bf16 FLOP/s per card (tensor cores, dense)
    vpu_ops: float  # fp32 instructions/s per card (CUDA cores): min-plus
    hbm_bw: float  # bytes/s per card
    link_bw: float  # bytes/s per link
    fp32_flops: float  # fp32 matmul FLOP/s (CUDA cores, an FFMA counting 2)
    int8_ops: float  # int8 tensor-core ops/s
    b1_ops: float  # b1 plane ops/s


HW_H100 = Hardware(
    name="h100_sxm", peak_flops=_obs.BF16_FLOPS_PER_S, vpu_ops=_obs.FP32_INSTR_PER_S,
    hbm_bw=_obs.HBM_BYTES_PER_S, link_bw=_obs.LINK_BYTES_PER_S,
    fp32_flops=2 * _obs.FP32_INSTR_PER_S, int8_ops=_obs.INT8_OPS_PER_S,
    b1_ops=_obs.B1_OPS_PER_S,
)


def unit_seconds(flops_by_unit: dict, hw: Hardware = HW_H100) -> float:
    """Seconds of ``{unit: flops}`` at each unit's peak rate."""
    rate = {"bf16": hw.peak_flops, "fp32": hw.fp32_flops, "vpu": hw.vpu_ops,
            "int8": hw.int8_ops, "b1": hw.b1_ops}
    return sum(v / rate[u] for u, v in flops_by_unit.items())


def analyze(costs: Costs, n_devices: int, hw: Hardware = HW_H100,
            memory: dict | None = None) -> dict:
    """Roofline terms (seconds per step, per card) with ``repro``'s keys.
    ``xla_flops_once`` / ``xla_bytes_once`` (XLA's own loop-blind count)
    have no counterpart and are None."""
    flops = float(costs.flops)
    t_compute = unit_seconds(costs.flops_by_unit, hw)
    t_memory = float(costs.bytes) / hw.hbm_bw
    t_collective = costs.total_wire_bytes / hw.link_bw
    terms = {
        "hw": hw.name,
        "n_devices": n_devices,
        "flops_per_device": flops,
        "bytes_per_device": float(costs.bytes),
        "bytes_upper_per_device": float(costs.bytes_upper),
        "xla_flops_once": None,
        "xla_bytes_once": None,
        "vpu_fraction": costs.flops_by_unit.get("vpu", 0.0) / flops if flops else 0.0,
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_collective": t_collective,
        "t_collective_operand_spec": costs.total_operand_bytes / hw.link_bw,
        "collectives": costs.collectives_dict(),
        "memory": dict(memory or {}),
    }
    terms["bottleneck"] = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    t_bound = max(t_compute, t_memory, t_collective)
    terms["roofline_fraction"] = (t_compute / t_bound) if t_bound > 0 else 0.0
    return terms


def model_flops(arch_params: int, tokens: int, kind: str,
                active_fraction: float = 1.0) -> float:
    """MODEL_FLOPS: 6*N*D train (N_active for MoE), 2*N*D forward-only."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * arch_params * active_fraction * tokens
