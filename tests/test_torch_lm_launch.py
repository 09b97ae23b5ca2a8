"""The port's LM serving CLI (``repro_torch.launch.serve``) and its example
twin (``examples/serve_lm_torch.py``) against ``repro``'s, on the CPU.
Their weights are drawn from a ``torch.Generator``, so the tokens are not
``repro``'s and are not compared: the output lines' form and the
``--metrics-json`` keys are."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import serve as j_cli
from repro_torch.launch import serve as t_cli

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
