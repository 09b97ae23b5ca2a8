"""The port's dry-run (``repro_torch.launch.{specs,dryrun,mesh}``,
``repro_torch.roofline``) against ``repro``'s.

* the cells, shapes and archs, and ``--list``;
* ``model_flops`` and ``_param_stats`` (``repro``'s in a subprocess: its
  dry-run module sets ``XLA_FLAGS`` when imported);
* the counter: exact matmul flops, a Python loop counted each pass, the
  Megatron pair's per-device flops and all-reduce on a 16 x 16 fake mesh,
  ``repro``'s wire factors;
* cells in a subprocess under a fake group: a smoke config's train cell on a
  (2, 2) mesh, the full-size ``qwen1.5-0.5b decode_32k`` cell, and the four
  comet cells, whose plan fields equal the committed ``results/comet``;
* a failed cell: exit 1 and ``FAILED CELLS:``, as ``repro``'s.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.launch import specs as jspecs
from repro.roofline.analysis import model_flops as j_model_flops
from repro.roofline.hlo import _wire_factor as j_wire_factor
from repro_torch.launch import dryrun, specs
from repro_torch.roofline.analysis import model_flops
from repro_torch.roofline.counts import CostCounter, _wire_factor

HERE = os.path.dirname(os.path.abspath(__file__))
COMET_DIR = os.path.join(HERE, "..", "results", "comet")
PLAN_FIELDS = ("n_v", "n_pf", "n_pv", "n_pr", "n_st", "work_fraction",
               "elementwise_comparisons")
#: ``repro``'s ``analyze_compiled`` keys
TERMS_KEYS = {"hw", "n_devices", "flops_per_device", "bytes_per_device",
              "bytes_upper_per_device", "xla_flops_once", "xla_bytes_once", "vpu_fraction",
              "t_compute", "t_memory", "t_collective", "t_collective_operand_spec",
              "collectives", "memory", "bottleneck", "roofline_fraction"}
LM_KEYS = {"arch", "shape", "kind", "seq", "batch", "multi_pod", "mesh", "lower_s",
           "compile_s", "roofline", "n_params", "active_fraction", "model_flops",
           "useful_flops_ratio"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_bytes_est"}


def _run(code: str, timeout: int = 240, env=None) -> dict:
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, "..", "src"), HERE,
                                       e.get("PYTHONPATH", "")])
    e.update(env or {})
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=e,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cells_shapes_and_archs_are_repros():
    assert specs.cells() == jspecs.cells()
    assert specs.cells(include_comet=False) == jspecs.cells(include_comet=False)
    assert len(specs.cells(include_comet=False)) == 32 and len(specs.cells()) == 36
    assert specs.LM_ARCHS == jspecs.LM_ARCHS and specs.COMET_ARCHS == jspecs.COMET_ARCHS
    for name, shape in jspecs.SHAPES.items():
        got = specs.SHAPES[name]
        assert (got.name, got.kind, got.seq, got.batch) == (
            shape.name, shape.kind, shape.seq, shape.batch)
    for arch in specs.LM_ARCHS:
        for shape in specs.SHAPES:
            assert specs.applicable(arch, shape) == jspecs.applicable(arch, shape)


def test_list_prints_the_36_cells(capsys):
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [tuple(line.split()) for line in lines] == [tuple(c) for c in jspecs.cells()]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_is_repros(kind):
    for n, tokens, frac in [(494_032_768, 1_048_576, 1.0), (3_300_000_000, 131_072, 0.27),
                            (1, 1, 0.5), (314_000_000_000, 128, 0.25)]:
        assert model_flops(n, tokens, kind, frac) == j_model_flops(n, tokens, kind, frac)


def test_param_stats_of_the_ten_configs_are_repros():
    want = _run("""
        import json
        from repro.launch import dryrun, specs
        print(json.dumps({a: list(dryrun._param_stats(a)) for a in specs.LM_ARCHS}))
    """, env={"JAX_PLATFORMS": "cpu"})
    for arch in specs.LM_ARCHS:
        assert list(dryrun._param_stats(arch)) == want[arch], arch


def test_wire_factors_are_repros():
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for n in (1, 2, 3, 16, 256, 512):
            assert _wire_factor(op, n) == j_wire_factor(op, n)


def test_counter_counts_matmul_flops_exactly_and_every_loop_pass():
    a = torch.empty(64, 96, device="meta")
    b = torch.empty(96, 80, device="meta")
    x = torch.empty(3, 64, 96, device="meta")
    with CostCounter() as cc:
        a @ b
    assert cc.costs.flops == 2 * 64 * 96 * 80
    with CostCounter() as cc:
        torch.bmm(x, b.expand(3, 96, 80))
        torch.einsum("bij,jk->bik", x, b)
    assert cc.costs.flops == 2 * (2 * 3 * 64 * 96 * 80)
    with CostCounter() as cc:
        for _ in range(10):
            a @ b
    assert cc.costs.flops == 10 * 2 * 64 * 96 * 80
    assert cc.costs.flops_by_unit == {"fp32": 10 * 2 * 64 * 96 * 80}
    with CostCounter() as cc:
        a.bfloat16() @ b.bfloat16()
    assert dict(cc.costs.flops_by_unit) == {"bf16": 2 * 64 * 96 * 80}
    assert cc.costs.bytes_upper > 0 and cc.costs.peak_bytes >= 64 * 80 * 2


def test_megatron_pair_counts_the_local_flops_on_a_16x16_fake_mesh():
    """(256, 4096) x (4096, 14336) x (14336, 4096), column- then
    row-parallel: one device's flops are 2 * 16 * 4096 * 896 twice, not the
    logical 60,129,542,144; the Partial sum is one all-reduce over 16."""
    got = _run("""
        import json, torch
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.launch.dryrun import fake_process_group
        from repro_torch.roofline.counts import CostCounter
        with fake_process_group(256):
            mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
            x = distribute_tensor(torch.empty(256, 4096, device="meta"), mesh,
                                  [Shard(0), Replicate()])
            w1 = distribute_tensor(torch.empty(4096, 14336, device="meta"), mesh,
                                   [Replicate(), Shard(1)])
            w2 = distribute_tensor(torch.empty(14336, 4096, device="meta"), mesh,
                                   [Replicate(), Shard(0)])
            with CostCounter() as cc:
                y = ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])
            print(json.dumps([cc.costs.flops, cc.costs.collectives_dict()]))
    """)
    flops, coll = got
    assert flops == 234_881_024 == 2 * (2 * 16 * 4096 * 896)
    assert coll["counts"] == {"all-reduce": 1}
    operand = 16 * 4096 * 4
    assert coll["operand_bytes"] == {"all-reduce": operand}
    assert coll["wire_bytes"] == {"all-reduce": operand * 2 * 15 / 16}


def test_cells_under_a_fake_group(tmp_path):
    """A smoke config's train cell on a (2, 2) fake mesh, the full-size
    qwen1.5-0.5b decode_32k cell, and the four comet cells, written as
    ``repro``'s JSON."""
    got = _run(f"""
        import json, os
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import registry
        from repro_torch.launch import dryrun, specs
        out = {{}}
        real = specs.get_config
        specs.get_config = registry.get_smoke_config
        with dryrun.fake_process_group(4):
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
            terms, meta = dryrun._trace("llama3-8b", "train_4k", mesh, False, None)
            out["smoke"] = [terms, meta]
        specs.get_config = real
        out["decode"] = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", False, "{tmp_path}")
        for arch in specs.COMET_ARCHS:
            out[arch] = dryrun.run_cell(arch, "paper", False, "{tmp_path}")
        out["files"] = sorted(os.listdir("{tmp_path}"))
        print(json.dumps(out))
    """)
    terms, meta = got["smoke"]
    assert set(terms) == TERMS_KEYS and set(terms["memory"]) == MEMORY_KEYS
    assert terms["n_devices"] == 4 and terms["flops_per_device"] > 0
    assert terms["xla_flops_once"] is None and terms["xla_bytes_once"] is None
    assert terms["collectives"]["counts"], "a (2, 2) train step communicates"
    assert meta["kind"] == "train"
    dec = got["decode"]
    assert set(dec) == LM_KEYS and set(dec["roofline"]) == TERMS_KEYS
    assert dec["compile_s"] is None and dec["lower_s"] > 0
    assert dec["mesh"] == "16x16" and dec["roofline"]["n_devices"] == 256
    assert 0 < dec["useful_flops_ratio"] <= 1.0
    assert dec["model_flops"] == model_flops(dec["n_params"], 128, "decode", 1.0)
    for arch in specs.COMET_ARCHS:
        with open(os.path.join(COMET_DIR, f"{arch}__paper__pod_16x16.json")) as f:
            want = json.load(f)
        cell = got[arch]
        assert set(cell) == set(want), arch
        assert set(cell["roofline"]) == set(want["roofline"]), arch
        assert {k: cell[k] for k in PLAN_FIELDS} == {k: want[k] for k in PLAN_FIELDS}, arch
        assert cell["roofline"]["hw"] == "h100_sxm" and cell["compile_s"] is None
    assert "qwen1.5-0.5b__decode_32k__pod_16x16.json" in got["files"]
    assert len(got["files"]) == 5


def test_a_failed_cell_exits_1_with_failed_cells(capsys, tmp_path):
    """As ``repro``'s: the error is printed, the run goes on, and the exit
    code is 1 with the failed cells listed; the fake group is closed."""
    import torch.distributed as dist

    assert dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 1
    out = capsys.readouterr()
    assert "FAILED CELLS: [('no-such-arch', 'train_4k', False)]" in out.out
    assert "KeyError" in out.err
    assert not dist.is_initialized()
