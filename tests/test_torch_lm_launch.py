"""The port's LM CLIs (``repro_torch.launch.serve`` / ``.train``) and
their example twins (``examples/serve_lm_torch.py``, ``train_lm_torch.py``,
``moe_affinity_torch.py``) against ``repro``'s, on the CPU.  Their weights
are drawn from a ``torch.Generator``, so the tokens, losses and pairs are
not ``repro``'s and are not compared: the output lines' form, the
``--metrics-json`` keys and the logged keys are."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import serve as j_cli
from repro.launch import train as j_train
from repro_torch.launch import serve as t_cli
from repro_torch.launch import train as t_train

REPO = Path(__file__).resolve().parents[1]

_HEAD = re.compile(r"^arch=\S+ batch=\d+ new_tokens=\d+$")
_RATE = re.compile(r"^generated \d+ tokens in \d+\.\d\ds = \d+\.\d tok/s$")
_ROW = re.compile(r"^   \[\d+(, \d+)*\]$")


def _keys(tree):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-1.3b"])
def test_cli_prints_repros_lines_and_metrics_keys(arch, tmp_path, capsys):
    args = ["--arch", arch, "--smoke", "--batch", "3", "--tokens", "5"]
    assert j_cli.main([*args, "--metrics-json", str(tmp_path / "j.json")]) == 0
    want = capsys.readouterr().out.splitlines()
    assert t_cli.main([*args, "--device", "cpu", "--metrics-json",
                       str(tmp_path / "t.json")]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 6
    for lines, out in ((want, "j.json"), (got, "t.json")):
        assert _HEAD.match(lines[0]) and _RATE.match(lines[1]), lines
        assert all(_ROW.match(line) for line in lines[2:5]), lines
        assert lines[5] == f"metrics={tmp_path / out}"
    assert got[0] == want[0]
    snaps = [json.loads((tmp_path / f).read_text()) for f in ("j.json", "t.json")]
    assert _keys(snaps[1]) == _keys(snaps[0])
    assert snaps[1]["tokens_generated"] == snaps[0]["tokens_generated"] == 15


def test_cli_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_cli.main(["--arch", "llama3-8b", "--smoke"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


_BLOCKED = (
    "import runpy, sys\n"
    "for name in ('jax', 'jaxlib', 'repro'):\n"
    "    sys.modules[name] = None\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(path, run_name='__main__')\n"
)


def _run(args, *, blocked):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.setdefault("JAX_PLATFORMS", "cpu")
    cmd = [sys.executable, "-c", _BLOCKED, *args] if blocked else [sys.executable, *args]
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_example_twin_prints_the_form_of_repros_example():
    """``--device cpu`` with jax and repro blocked: the lines of
    ``serve_lm.py``, one a sequence; without ``--device`` it fails here."""
    args = ["--arch", "zamba2-1.2b", "--batch", "3", "--tokens", "6"]
    want = _run([str(REPO / "examples" / "serve_lm.py"), *args], blocked=False)
    got = _run([str(REPO / "examples" / "serve_lm_torch.py"), *args, "--device", "cpu"],
               blocked=True)
    assert want.returncode == 0 and got.returncode == 0, got.stderr
    form = [re.compile(r"^zamba2-1\.2b-smoke: 18 tokens in \d+\.\d\ds \(\d+\.\d tok/s\)$")]
    form += [re.compile(rf"^  seq{r}: \[\d+(, \d+){{5}}\]$") for r in range(3)]
    for out in (want.stdout, got.stdout):
        lines = out.splitlines()
        assert len(lines) == len(form) and all(f.match(s) for f, s in zip(form, lines)), lines
    if not torch.cuda.is_available():
        card = _run([str(REPO / "examples" / "serve_lm_torch.py")], blocked=True)
        assert card.returncode != 0 and "no CUDA device" in card.stderr


_TRAIN_HEAD = re.compile(r"^arch=\S+ params=\d+\.\dM resume_step=\d+$")
_DONE = re.compile(r"^done @ step \d+; stragglers=\d+$")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b"])
def test_train_cli_prints_repros_lines(arch, tmp_path, capsys):
    """The head line (the parameter count equal), one JSON line a logged
    step with ``repro``'s keys in its order, the done line; a second run on
    the same ``--ckpt-dir`` resumes from its last step, as ``repro``'s."""
    args = ["--arch", arch, "--smoke", "--steps", "10", "--batch", "2", "--seq-len", "16",
            "--log-every", "5", "--ckpt-every", "5"]
    outs = {}
    for who, main, extra in (("j", j_train.main, []), ("t", t_train.main, ["--device", "cpu"])):
        assert main([*args, "--ckpt-dir", str(tmp_path / who), *extra]) == 0
        outs[who] = capsys.readouterr().out.splitlines()
    want, got = outs["j"], outs["t"]
    assert len(got) == len(want) == 4
    assert got[0] == want[0] and _TRAIN_HEAD.match(got[0]), got[0]
    for g, w in zip(got[1:3], want[1:3]):
        g, w = json.loads(g), json.loads(w)
        assert list(g) == list(w) == ["step", "time", "grad_norm", "loss", "lr"]
        assert g["step"] == w["step"] and g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert [json.loads(x)["step"] for x in got[1:3]] == [5, 10]
    assert _DONE.match(got[3]) and got[3].startswith("done @ step 10;")
    assert t_train.main([*args, "--steps", "12", "--ckpt-dir", str(tmp_path / "t"),
                         "--device", "cpu"]) == 0
    again = capsys.readouterr().out.splitlines()
    assert again[0].endswith("resume_step=10") and again[-1].startswith("done @ step 12;")


def test_train_cli_without_a_card_exits_2(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_train.main(["--arch", "qwen1.5-0.5b", "--smoke",
                         "--ckpt-dir", str(tmp_path)]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_train_example_twin_prints_the_form_of_repros_example(tmp_path):
    """``--quick --steps 10 --device cpu`` with jax and repro blocked: the
    lines of ``train_lm.py``; without ``--device`` it fails without a card."""
    common = ["--quick", "--steps", "10"]
    want = _run([str(REPO / "examples" / "train_lm.py"), *common,
                 "--ckpt-dir", str(tmp_path / "j")], blocked=False)
    got = _run([str(REPO / "examples" / "train_lm_torch.py"), *common,
                "--ckpt-dir", str(tmp_path / "t"), "--device", "cpu"], blocked=True)
    assert want.returncode == 0 and got.returncode == 0, got.stderr
    w, g = want.stdout.splitlines(), got.stdout.splitlines()
    assert len(g) == len(w) == 4
    assert g[0] == w[0] == "lm-10m: 8.1M params, resuming at step 0/10"
    for a, b in zip(g[1:3], w[1:3]):
        assert list(json.loads(a)) == list(json.loads(b))
    assert re.match(r"^loss \d+\.\d{3} -> \d+\.\d{3} over 10 steps$", g[3]), g[3]
    if not torch.cuda.is_available():
        card = _run([str(REPO / "examples" / "train_lm_torch.py"), "--quick",
                     "--ckpt-dir", str(tmp_path / "c")], blocked=True)
        assert card.returncode != 0 and "no CUDA device" in card.stderr


def test_moe_affinity_twin_prints_the_form_of_repros_example():
    want = _run([str(REPO / "examples" / "moe_affinity.py")], blocked=False)
    got = _run([str(REPO / "examples" / "moe_affinity_torch.py"), "--device", "cpu"],
               blocked=True)
    assert want.returncode == 0 and got.returncode == 0, got.stderr
    form = [re.compile(r"^5 experts, top-2 routing$"),
            re.compile(r"^most similar expert pairs \(token-population overlap\):$")]
    form += [re.compile(r"^  expert[0-4] ~ expert[0-4]: c2=\d\.\d{3}$")] * 5
    form += [re.compile(r"^expert loads: \[\d+(, \d+){4}\]$")]
    for out in (want.stdout, got.stdout):
        lines = out.splitlines()
        assert len(lines) == len(form) and all(f.match(x) for f, x in zip(form, lines)), lines
    loads = [json.loads(out.splitlines()[-1].split(": ", 1)[1]) for out in (want.stdout,
                                                                            got.stdout)]
    assert sum(loads[0]) == sum(loads[1]) == 8 * 64 * 2  # every token routed to 2 experts
    if not torch.cuda.is_available():
        card = _run([str(REPO / "examples" / "moe_affinity_torch.py")], blocked=True)
        assert card.returncode != 0 and "no CUDA device" in card.stderr
