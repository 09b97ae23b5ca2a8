"""The port's CLIs held against repro's on the CPU (``--device cpu``).

``repro_torch.launch.dataset`` and ``repro_torch.launch.similarity`` print
``repro``'s lines on the same arguments: the manifest and ``checksum=``
lines of every subcommand, the campaign's ``metric=`` / ``checksum=`` lines
(from values, a dataset or a PLINK fileset), ``--dry-run`` and
``--list-metrics``, and the ``streamed chunks=`` / ``delta n_old=`` lines of
streamed (``--streaming``, ``--max-host-bytes``, several shards) and delta
(``--delta-from``) campaigns, and ``--trace``'s phase table, ``obs`` line
and trace file; errors exit 2 with ``repro``'s message, and 2-way and
3-way decompositions over ``--devices N`` print ``repro``'s lines.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.launch.dataset as jdataset
import repro.launch.similarity as jsim
import repro_torch.launch.dataset as tdataset
import repro_torch.launch.similarity as tsim
from repro.api import SimilarityResult
from repro.core.synthetic import random_integer_vectors
from test_torch_store import _genotypes, write_bed

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _both(jmain, tmain, argv, capsys, *, port_argv=()):
    """(rc, stdout, stderr) of repro's main and of the port's on argv (the
    port also gets ``port_argv``)."""
    return (_run(jmain, list(argv), capsys),
            _run(tmain, list(argv) + list(port_argv), capsys))


def _campaign_lines(out: str) -> list:
    """The lines of a campaign's output that do not depend on its timing."""
    return [line for line in out.splitlines() if not line.startswith("results=")]


# -- dataset CLI ---------------------------------------------------------------


@pytest.mark.parametrize("source", ["synthetic", "synthetic 3 shards", "npy",
                                    "bed zero", "bed drop"])
def test_dataset_encode_lines_equal_repro(tmp_path, capsys, source):
    if source.startswith("synthetic"):
        args = ["--synthetic", "--n-f", "45", "--n-v", "13", "--max-value", "3",
                "--seed", "2", "--shards", "3" if "3" in source else "1"]
    elif source == "npy":
        np.save(tmp_path / "V.npy", random_integer_vectors(30, 9, max_value=2, seed=1))
        args = ["--input", str(tmp_path / "V.npy")]
    else:
        prefix = write_bed(str(tmp_path / "cohort"),
                           _genotypes(11, 21, seed=4, missing_snps=(2, 7)))
        args = ["--bed", prefix, "--missing", source.split()[1]]
    (jrc, jout, _), (trc, tout, _) = (
        _run(jdataset.main, ["encode", *args, "--out", str(tmp_path / "j")], capsys),
        _run(tdataset.main, ["encode", *args, "--out", str(tmp_path / "t"), *CPU],
             capsys))
    assert jrc == trc == 0
    assert tout.replace(str(tmp_path / "t"), "DS") == \
        jout.replace(str(tmp_path / "j"), "DS")
    assert "checksum=sha256:" in tout
    # and the two directories hold the same bytes
    for name in sorted(os.listdir(tmp_path / "j")):
        if name.endswith(".npy"):
            assert (tmp_path / "t" / name).read_bytes() == \
                (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("sub", ["inspect", "validate"])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_dataset_inspect_validate_equal_repro(tmp_path, capsys, sub, writer):
    ds = str(tmp_path / "ds")
    argv = ["encode", "--synthetic", "--n-f", "61", "--n-v", "10", "--shards", "2",
            "--out", ds]
    if writer == "repro":
        assert jdataset.main(argv) == 0
    else:
        assert tdataset.main(argv + CPU) == 0
    capsys.readouterr()
    (jrc, jout, _), (trc, tout, _) = _both(
        jdataset.main, tdataset.main, [sub, ds], capsys,
        port_argv=CPU if sub == "validate" else ())
    assert jrc == trc == 0 and tout == jout


@pytest.mark.parametrize("new", ["synthetic", "npy"])
def test_dataset_append_lines_equal_repro(tmp_path, capsys, new):
    outs = []
    for main, name, extra in ((jdataset.main, "j", []), (tdataset.main, "t", CPU)):
        ds = str(tmp_path / name)
        assert main(["encode", "--synthetic", "--n-f", "37", "--n-v", "8",
                     "--out", ds, *extra]) == 0
        if new == "npy":
            np.save(tmp_path / "W.npy", random_integer_vectors(37, 5, max_value=2, seed=9))
            args = ["--input", str(tmp_path / "W.npy")]
        else:
            args = ["--synthetic", "--n-v", "6", "--seed", "3"]
        capsys.readouterr()
        rc, out, _ = _run(main, ["append", "--to", ds, *args,
                                 "--out", ds + "2", *extra], capsys)
        assert rc == 0
        outs.append(out.replace(ds, "DS"))
    assert outs[0] == outs[1]
    assert "parent_checksum=sha256:" in outs[1]


@pytest.mark.parametrize("case", ["two sources", "no source", "missing calls",
                                  "bad levels", "append both", "corrupt"])
def test_dataset_errors_equal_repro(tmp_path, capsys, case):
    prefix = write_bed(str(tmp_path / "c"), _genotypes(4, 9, seed=2, missing_snps=(1,)))
    ds = str(tmp_path / "ds")
    tdataset.main(["encode", "--synthetic", "--n-f", "16", "--n-v", "4",
                   "--out", ds, *CPU])
    capsys.readouterr()
    argv, port = {
        "two sources": (["encode", "--synthetic", "--bed", prefix, "--out", ds], CPU),
        "no source": (["encode", "--out", ds], CPU),
        "missing calls": (["encode", "--bed", prefix, "--out", ds], CPU),
        "bad levels": (["encode", "--synthetic", "--max-value", "3", "--levels",
                        "2", "--out", ds], CPU),
        "append both": (["append", "--to", ds, "--synthetic", "--input", "x.npy"],
                        CPU),
        "corrupt": (["validate", str(tmp_path)], CPU),
    }[case]
    (jrc, _, jerr), (trc, _, terr) = _both(jdataset.main, tdataset.main, argv,
                                           capsys, port_argv=port)
    assert jrc == trc == 2
    assert terr == jerr and terr.startswith("error: ")


# -- similarity CLI ------------------------------------------------------------


CAMPAIGNS = {
    "2-way xla": ["--n-f", "40", "--n-v", "21"],
    "2-way pallas": ["--impl", "pallas", "--n-f", "40", "--n-v", "21"],
    "2-way levels": ["--impl", "levels", "--max-value", "2", "--n-f", "29",
                     "--n-v", "17"],
    "2-way levels values": ["--impl", "levels", "--max-value", "3", "--levels",
                            "3", "--encoding", "none", "--n-f", "29", "--n-v", "17"],
    "2-way sorenson": ["--metric", "sorenson", "--impl", "levels", "--levels", "1",
                       "--max-value", "1", "--n-f", "33", "--n-v", "15"],
    "2-way ccc bf16": ["--metric", "ccc", "--out-dtype", "bfloat16", "--n-f", "24",
                       "--n-v", "12"],
    "3-way levels all stages": ["--way", "3", "--impl", "levels", "--max-value",
                                "2", "--n-st", "2", "--stage", "-1", "--n-f", "32",
                                "--n-v", "14"],
    "3-way pallas stage 1": ["--way", "3", "--impl", "pallas", "--n-st", "2",
                             "--stage", "1", "--n-f", "25", "--n-v", "13"],
}


@pytest.mark.parametrize("case", sorted(CAMPAIGNS))
def test_similarity_lines_equal_repro(capsys, case):
    (jrc, jout, _), (trc, tout, _) = _both(jsim.main, tsim.main, CAMPAIGNS[case],
                                           capsys, port_argv=CPU)
    assert jrc == trc == 0
    assert _campaign_lines(tout) == _campaign_lines(jout)
    assert any(line.startswith("checksum=0x") for line in tout.splitlines())
    results = [line.split()[0] for line in tout.splitlines()
               if line.startswith("results=")]
    assert results == [line.split()[0] for line in jout.splitlines()
                       if line.startswith("results=")]


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("way", [2, 3])
def test_similarity_from_dataset_equals_repro(tmp_path, capsys, way, levels):
    """encode with the port's dataset CLI, then a campaign from it in both
    packages: the same lines, and the value-input checksum."""
    ds = str(tmp_path / "ds")
    assert tdataset.main(["encode", "--synthetic", "--n-f", "37", "--n-v", "18",
                          "--max-value", str(levels), "--out", ds, *CPU]) == 0
    capsys.readouterr()
    argv = ["--way", str(way), "--dataset", ds]
    if way == 3:
        argv += ["--n-st", "2", "--stage", "-1"]
    (jrc, jout, _), (trc, tout, _) = _both(jsim.main, tsim.main, argv, capsys,
                                           port_argv=CPU)
    assert jrc == trc == 0
    assert _campaign_lines(tout) == _campaign_lines(jout)
    values = argv[:2] + argv[4:] + ["--impl", "levels", "--levels", str(levels),
                                    "--n-f", "37", "--n-v", "18",
                                    "--max-value", str(levels)]
    rc, vout, _ = _run(tsim.main, values + CPU, capsys)
    assert rc == 0
    assert _campaign_lines(vout)[-1] == _campaign_lines(tout)[-1]


def test_similarity_from_bed_dataset_equals_repro(tmp_path, capsys):
    """The GWAS workflow: dataset encode --bed, then similarity --dataset."""
    prefix = write_bed(str(tmp_path / "cohort"), _genotypes(19, 45, seed=7))
    outs = []
    for dmain, smain, name, extra in ((jdataset.main, jsim.main, "j", []),
                                      (tdataset.main, tsim.main, "t", CPU)):
        ds = str(tmp_path / name)
        assert dmain(["encode", "--bed", prefix, "--out", ds, *extra]) == 0
        capsys.readouterr()
        rc, out, _ = _run(smain, ["--dataset", ds, *extra], capsys)
        assert rc == 0
        outs.append(_campaign_lines(out))
    assert outs[0] == outs[1]


DRY_RUNS = {
    "xla": ["--n-f", "16", "--n-v", "8"],
    "pallas": ["--impl", "pallas", "--n-f", "16", "--n-v", "8"],
    "levels": ["--impl", "levels", "--max-value", "2", "--n-f", "16", "--n-v", "8"],
    "levels not leveled": ["--impl", "levels", "--max-value", "5", "--n-f", "16",
                           "--n-v", "8"],
    "ccc levels": ["--metric", "ccc", "--impl", "levels", "--n-f", "16", "--n-v", "8"],
    "3-way levels": ["--way", "3", "--impl", "levels", "--max-value", "2",
                     "--n-st", "2", "--n-f", "16", "--n-v", "12"],
    "3-way levels none": ["--way", "3", "--impl", "levels", "--max-value", "2",
                          "--encoding", "none", "--n-f", "16", "--n-v", "12"],
    "dataset": ["--dataset", "DS"],
    "dataset 3-way": ["--dataset", "DS", "--way", "3"],
    "sharded dataset off": ["--dataset", "DS4", "--streaming", "off"],
    "bad stage": ["--way", "3", "--n-st", "2", "--stage", "5"],
    "dataset xla": ["--dataset", "DS", "--impl", "xla"],
    # decompositions: repro's path strings and reasons under n_pf > 1
    "n_pf 2 levels": ["--impl", "levels", "--max-value", "2", "--n-pf", "2",
                      "--n-pv", "2", "--n-f", "16", "--n-v", "8"],
    "n_pf 2 pallas": ["--impl", "pallas", "--n-pf", "2", "--n-f", "16", "--n-v", "8"],
    "n_pf 2 sharded dataset": ["--dataset", "DS4", "--n-pf", "2", "--n-pr", "2"],
}


@pytest.mark.parametrize("case", sorted(DRY_RUNS))
def test_similarity_dry_run_equals_repro(tmp_path, capsys, case):
    ds, ds4 = str(tmp_path / "ds"), str(tmp_path / "ds4")
    tdataset.main(["encode", "--synthetic", "--n-f", "40", "--n-v", "12",
                   "--out", ds, *CPU])
    tdataset.main(["encode", "--synthetic", "--n-f", "64", "--n-v", "12",
                   "--shards", "4", "--out", ds4, *CPU])
    capsys.readouterr()
    argv = [{"DS": ds, "DS4": ds4}.get(a, a) for a in DRY_RUNS[case]] + ["--dry-run"]
    (jrc, jout, jerr), (trc, tout, terr) = _both(jsim.main, tsim.main, argv,
                                                 capsys, port_argv=CPU)
    assert trc == jrc
    assert tout == jout and terr == jerr
    if case == "dataset":
        assert tout.splitlines()[0] == "path=fused-levels"


BATCHED = {
    "metrics, levels": ["--metrics", "czekanowski,sorenson,ccc", "--impl", "levels",
                        "--max-value", "2", "--n-f", "40", "--n-v", "18"],
    "metrics and subsets, pallas": ["--metrics", "ccc,czekanowski", "--subsets",
                                    "a=0:12:3;b=11,2,5,9", "--impl", "pallas",
                                    "--n-f", "40", "--n-v", "18"],
    "subsets only": ["--subsets", "odd=1:18:2", "--max-value", "2", "--n-f", "33",
                     "--n-v", "18"],
    "3-way, all stages": ["--way", "3", "--n-st", "2", "--stage", "-1", "--metrics",
                          "czekanowski,ccc", "--subsets", "a=0:9;b=13,4,8",
                          "--impl", "levels", "--max-value", "2", "--n-f", "24",
                          "--n-v", "14"],
    "popcount": ["--metrics", "sorenson,czekanowski", "--impl", "levels", "--levels",
                 "1", "--max-value", "1", "--n-f", "40", "--n-v", "12"],
    "dataset": ["--dataset", "DS", "--metrics", "czekanowski,sorenson,ccc",
                "--subsets", "a=0:10:3;b=11,2,5"],
    "one metric is not a batch": ["--metrics", "czekanowski", "--n-f", "16",
                                  "--n-v", "8"],
}


@pytest.mark.parametrize("dry_run", [False, True], ids=["run", "dry-run"])
@pytest.mark.parametrize("case", sorted(BATCHED))
def test_batched_similarity_lines_equal_repro(tmp_path, capsys, case, dry_run):
    """--metrics / --subsets: the batch's lines, one ``campaign`` line (or
    ``--dry-run`` row) per (metric, subset), equal repro's but for time=."""
    ds = str(tmp_path / "ds")
    tdataset.main(["encode", "--synthetic", "--n-f", "40", "--n-v", "12",
                   "--max-value", "2", "--out", ds, *CPU])
    capsys.readouterr()
    argv = [ds if a == "DS" else a for a in BATCHED[case]]
    argv += ["--dry-run"] if dry_run else []
    (jrc, jout, jerr), (trc, tout, terr) = _both(jsim.main, tsim.main, argv,
                                                 capsys, port_argv=CPU)
    assert jrc == trc == 0 and terr == jerr
    lines = [line for line in _campaign_lines(tout) if not line.startswith("time=")]
    assert lines == [line for line in _campaign_lines(jout)
                     if not line.startswith("time=")]
    batched = case != "one metric is not a batch"
    assert any(line.startswith("campaign metric=") for line in lines) == batched


def test_batched_similarity_out_dirs_load_in_repro(tmp_path, capsys):
    """--out saves one directory per campaign, named as repro names them;
    each loads in repro with the checksum the port printed."""
    argv = ["--metrics", "czekanowski,ccc", "--subsets", "a=0:6;b=9,1", "--impl",
            "levels", "--max-value", "2", "--n-f", "30", "--n-v", "12"]
    assert jsim.main(argv + ["--out", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    rc, out, _ = _run(tsim.main, argv + ["--out", str(tmp_path / "t"), *CPU], capsys)
    assert rc == 0
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "ccc__a", "ccc__b", "czekanowski__a", "czekanowski__b"]
    printed = [line.split("checksum=")[1] for line in out.splitlines()
               if line.startswith("campaign ")]
    loaded = [hex(SimilarityResult.load(str(tmp_path / "t" / n)).checksum())
              for n in ("czekanowski__a", "czekanowski__b", "ccc__a", "ccc__b")]
    assert loaded == printed


def test_list_metrics_equals_repro(capsys):
    (jrc, jout, _), (trc, tout, _) = _both(jsim.main, tsim.main,
                                           ["--list-metrics"], capsys)
    assert jrc == trc == 0 and tout == jout
    assert "czekanowski" in tout and "sorenson" in tout


def test_similarity_input_out_and_append(tmp_path, capsys):
    """--input and --out: the saved result loads in repro; --append grows the
    dataset as repro's does, and the campaign after it is repro's."""
    np.save(tmp_path / "V.npy", random_integer_vectors(26, 11, max_value=2, seed=5))
    np.save(tmp_path / "W.npy", random_integer_vectors(26, 4, max_value=2, seed=6))
    rc, out, _ = _run(tsim.main, ["--input", str(tmp_path / "V.npy"), "--impl",
                                  "pallas", "--out", str(tmp_path / "res"), *CPU],
                      capsys)
    assert rc == 0
    loaded = SimilarityResult.load(str(tmp_path / "res"))
    assert f"checksum={hex(loaded.checksum())}" in out.splitlines()
    outs = []
    for dmain, smain, name, extra in ((jdataset.main, jsim.main, "j", []),
                                      (tdataset.main, tsim.main, "t", CPU)):
        ds = str(tmp_path / name)
        assert dmain(["encode", "--input", str(tmp_path / "V.npy"), "--out", ds,
                      *extra]) == 0
        capsys.readouterr()
        rc, out, _ = _run(smain, ["--dataset", ds, "--append",
                                  str(tmp_path / "W.npy"), *extra], capsys)
        assert rc == 0
        outs.append([line.replace(ds, "DS") for line in _campaign_lines(out)])
    assert outs[0] == outs[1]
    assert outs[1][0] == "appended 4 vector(s): DS now n_v=15 (v2)"


UNPORTED = {  # the flags that once exited 2 as unported, each with its ranks
    "n-pf": ["--n-pf", "2", "--devices", "2"],
    "n-pv": ["--n-pv", "2", "--devices", "2"],
    "n-pr 3-way": ["--way", "3", "--n-pr", "2", "--devices", "2"],
    "devices": ["--devices", "4"],
}


def _repro_cli(argv) -> tuple:
    """(rc, stdout, stderr) of repro's similarity CLI in a process of its
    own, where ``--devices N`` can still set jax's device count."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "repro.launch.similarity", *argv],
                          capture_output=True, text=True, env=env, timeout=300)
    return proc.returncode, proc.stdout, proc.stderr


STREAMED_AND_DELTA = {
    "streaming on": ["--dataset", "DS", "--streaming", "on"],
    "max-host-bytes": ["--dataset", "DS", "--max-host-bytes", "4096"],
    "multi-shard auto": ["--dataset", "DS4"],
    "multi-shard auto dry run": ["--dataset", "DS4", "--dry-run"],
    "batched multi-shard auto": ["--dataset", "DS4", "--metrics",
                                 "czekanowski,sorenson"],
    "delta-from": ["--dataset", "DS", "--delta-from", "PRIOR"],
}


@pytest.mark.parametrize("case", sorted(STREAMED_AND_DELTA))
def test_streamed_and_delta_flags_print_repros_lines(tmp_path, capsys, case):
    """The streaming and delta flags run: exit 0 with repro's lines (a
    streamed campaign's ``streamed chunks=`` line, a delta's ``delta
    n_old=``, a dry run's ``path=streamed-*``), time and rate aside."""
    ds, ds4 = str(tmp_path / "ds"), str(tmp_path / "ds4")
    tdataset.main(["encode", "--synthetic", "--n-f", "16", "--n-v", "8",
                   "--out", ds, *CPU])
    tdataset.main(["encode", "--synthetic", "--n-f", "64", "--n-v", "8",
                   "--shards", "4", "--out", ds4, *CPU])
    prior = str(tmp_path / "prior")
    if case == "delta-from":  # a prior of 8 vectors, then 3 appended
        assert tsim.main(["--dataset", ds, "--out", prior, *CPU]) == 0
        assert tdataset.main(["append", "--to", ds, "--synthetic", "--n-v", "3",
                              "--seed", "1", *CPU]) == 0
    capsys.readouterr()
    argv = [{"DS": ds, "DS4": ds4, "PRIOR": prior}.get(a, a)
            for a in STREAMED_AND_DELTA[case]]
    (jrc, jout, jerr), (trc, tout, terr) = _both(jsim.main, tsim.main, argv,
                                                 capsys, port_argv=CPU)
    assert jrc == trc == 0 and terr == jerr
    lines = [line for line in _campaign_lines(tout) if not line.startswith("time=")]
    assert lines == [line for line in _campaign_lines(jout)
                     if not line.startswith("time=")]
    if case == "delta-from":
        assert any(line.startswith("delta n_old=8 n_new=3 ") for line in lines)
    elif case == "multi-shard auto dry run":
        assert lines[0].startswith("path=streamed-fused-levels")
        assert "streaming=on max_host_bytes=0" in lines
    elif case.startswith("batched"):
        assert sum(line.startswith("campaign metric=") for line in lines) == 2
    else:
        assert any(line.startswith("streamed chunks=") for line in lines)


TRACED = {
    "2-way": ["--n-f", "40", "--n-v", "12", "--max-value", "2", "--impl", "levels"],
    "3-way": ["--way", "3", "--n-st", "2", "--stage", "-1", "--n-f", "24",
              "--n-v", "12", "--max-value", "2", "--impl", "pallas"],
    "streamed": ["--dataset", "DS4"],
    "delta": ["--dataset", "DS", "--delta-from", "PRIOR"],
    "batched": ["--n-f", "30", "--n-v", "10", "--max-value", "2", "--metrics",
                "czekanowski,sorenson,ccc", "--subsets", "a=0:6;b=7,3,5"],
}


def _phase_rows(out: str) -> list:
    """(phase, count) of each row of the phase table in ``out``."""
    lines = out.splitlines()
    start = lines.index("phase            count     seconds    share")
    rows = []
    for line in lines[start + 1:]:
        if line.startswith("obs "):
            break
        name, count, _seconds, _share = line.split()
        rows.append((name, int(count)))
    return rows


@pytest.mark.parametrize("case", sorted(TRACED))
def test_trace_prints_repros_phase_rows(tmp_path, capsys, case):
    """--trace exits 0, prints repro's phase rows (names and counts; seconds
    aside), an ``obs`` line with repro's ``comparisons=`` and a bound, and
    writes a trace file that validates."""
    from repro.obs import trace as jtrace
    from repro_torch.obs import trace as ttrace

    ds, ds4 = str(tmp_path / "ds"), str(tmp_path / "ds4")
    tdataset.main(["encode", "--synthetic", "--n-f", "16", "--n-v", "8",
                   "--out", ds, *CPU])
    tdataset.main(["encode", "--synthetic", "--n-f", "64", "--n-v", "8",
                   "--shards", "4", "--out", ds4, *CPU])
    prior = str(tmp_path / "prior")
    if case == "delta":  # a prior of 8 vectors, then 3 appended
        assert tsim.main(["--dataset", ds, "--out", prior, *CPU]) == 0
        assert tdataset.main(["append", "--to", ds, "--synthetic", "--n-v", "3",
                              "--seed", "1", *CPU]) == 0
    capsys.readouterr()
    argv = [{"DS": ds, "DS4": ds4, "PRIOR": prior}.get(a, a) for a in TRACED[case]]
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    (jrc, jout, _), (trc, tout, terr) = (
        _run(jsim.main, argv + ["--trace", jpath], capsys),
        _run(tsim.main, argv + ["--trace", tpath, *CPU], capsys))
    assert jrc == trc == 0, terr
    assert not ttrace.enabled() and not jtrace.enabled()
    rows = _phase_rows(tout)
    assert rows == _phase_rows(jout)
    assert [name for name, _ in rows[:6]] == list(ttrace.CANONICAL_PHASES)
    jobs = next(line for line in jout.splitlines() if line.startswith("obs "))
    tobs = next(line for line in tout.splitlines() if line.startswith("obs "))
    assert tobs.split()[1] == jobs.split()[1]  # comparisons=...
    assert " bound_seconds=" in tobs and " utilization=" in tobs
    with open(tpath) as f:
        events = ttrace.validate_chrome_trace(json.load(f))
    assert f"trace={tpath} events={events}" in tout.splitlines()
    checks = [line for line in tout.splitlines()
              if line.startswith(("checksum=", "campaign metric="))]
    assert checks and checks == [line for line in jout.splitlines()
                                 if line.startswith(("checksum=", "campaign metric="))]


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_flags_exit_2_naming_their_item(tmp_path, capsys, case):
    """A 2-way or 3-way decomposition over ``--devices N`` CPU ranks (and
    ``--devices`` alone) exits 0 with repro's lines on as many devices,
    time and rate aside: no flag is left unported."""
    argv = UNPORTED[case] + ["--n-f", "33", "--n-v", "13"]
    rc, out, err = _run(tsim.main, argv + CPU, capsys)
    jrc, jout, jerr = _repro_cli(argv)
    assert jrc == rc == 0 and err == "", jerr[-2000:]
    assert _campaign_lines(out) == _campaign_lines(jout)  # decomp=, checksum=
    assert out.splitlines()[1].split()[0] == jout.splitlines()[1].split()[0]


@pytest.mark.parametrize("case", ["unknown metric", "input and dataset",
                                  "append without dataset", "bad stage",
                                  "not a dataset", "metric way",
                                  "subsets malformed", "subsets bad index spec",
                                  "metrics empty", "unknown batched metric",
                                  "subset out of range"])
def test_similarity_errors_equal_repro(tmp_path, capsys, case):
    argv = {
        "unknown metric": ["--metric", "nope", "--n-f", "8", "--n-v", "4"],
        "subsets malformed": ["--subsets", "a"],
        "subsets bad index spec": ["--subsets", "a=1:2:3:4"],
        "metrics empty": ["--metrics", " , "],
        "unknown batched metric": ["--metrics", "czekanowski,nope", "--n-f", "8",
                                   "--n-v", "4"],
        "subset out of range": ["--subsets", "a=0,9", "--n-f", "8", "--n-v", "4"],
        "input and dataset": ["--input", "x.npy", "--dataset", str(tmp_path)],
        "append without dataset": ["--append", "x.npy"],
        "bad stage": ["--way", "3", "--n-st", "2", "--stage", "3"],
        "not a dataset": ["--dataset", str(tmp_path)],
        "metric way": ["--metric", "sorenson", "--way", "4"],
    }[case]
    if case == "metric way":  # argparse's own refusal: exit status 2
        for main in (jsim.main, tsim.main):
            with pytest.raises(SystemExit) as info:
                main(argv)
            assert info.value.code == 2
        return
    (jrc, _, jerr), (trc, _, terr) = _both(jsim.main, tsim.main, argv, capsys,
                                           port_argv=CPU)
    assert jrc == trc == 2
    assert terr == jerr and terr.startswith("error: ")


def test_clis_run_on_the_card_by_default(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((tsim.main, ["--n-f", "8", "--n-v", "4"]),
                       (tdataset.main, ["encode", "--synthetic", "--out",
                                        str(tmp_path / "ds")]),
                       (tdataset.main, ["validate", str(tmp_path / "ds")])):
        rc, out, err = _run(main, argv, capsys)
        assert rc == 2 and out == ""
        assert "no CUDA device" in err and "--device cpu" in err
    assert not (tmp_path / "ds").exists()


def test_clis_as_modules_without_jax_or_repro(tmp_path):
    """``python -m repro_torch.launch.*`` with jax and repro unimportable:
    encode a dataset, validate it and run a campaign from it."""
    ds = str(tmp_path / "ds")
    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = sys.argv[1:]\n"
        "runpy.run_module(sys.argv[0], run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    lines = []
    for argv in (["repro_torch.launch.dataset", "encode", "--synthetic", "--n-f",
                  "24", "--n-v", "9", "--out", ds, *CPU],
                 ["repro_torch.launch.dataset", "validate", ds, *CPU],
                 ["repro_torch.launch.similarity", "--dataset", ds, *CPU]):
        out = subprocess.run([sys.executable, "-c", code, *argv], env=env,
                             cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        lines += out.stdout.splitlines()
    assert lines[1].startswith("checksum=sha256:")
    assert lines[2] == f"{ds}: OK (1 shard(s), {lines[1].split('=')[1]})"
    assert lines[-1].startswith("checksum=0x")
