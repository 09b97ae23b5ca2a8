"""The LM stack on a gloo ``DeviceMesh`` against the run without one: the
loss, every gradient (gathered whole) and the prefill / decode logits of
the smoke configs (``tests/torch_mesh_harness.py`` ``lm_case``).

* one rank, a process of its own: bit for bit, on the families the
  one-rank ``Trainer`` / ``ServeEngine`` tests of
  ``tests/test_torch_sharding.py`` leave out (hybrid SSM, 8-expert MoE,
  encoder-decoder);
* two ranks, a process each: (2, 1) data parallel and (1, 2) tensor
  parallel within the LM tolerances the port holds against ``repro``
  (1e-5 on the loss and gradients, 1e-4 on logits): the reductions add in
  another order.  granite's MoE pads its capacity to split over "data";
  qwen2-vl's 3 heads on a 2-wide "model" axis take the batch-parallel
  attention; zamba2 scans per batch and head shard, its B / C gradients
  partial across them.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import pytest

from torch_mesh_harness import run_on_ranks

GRAD_TOL, LOGIT_TOL = 1e-5, 1e-4
NUMERIC = ("loss", "grad", "logits")


ONE_RANK = ("zamba2-1.2b", "grok-1-314b", "seamless-m4t-large-v2")
TWO_RANKS = {(2, 1): ("granite-moe-3b-a800m", "zamba2-1.2b"),
             (1, 2): ("qwen2-vl-2b", "zamba2-1.2b")}


@pytest.fixture(scope="module")
def runs():
    """The three runs, started together (their ranks are processes of
    their own): the one-rank one and the two two-rank ones."""
    jobs = {(1, 1): ONE_RANK, **TWO_RANKS}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {shape: pool.submit(run_on_ranks, "lm_cases", shape, list(archs))
                   for shape, archs in jobs.items()}
        return {shape: f.result() for shape, f in futures.items()}


def test_one_rank_mesh_bitwise(runs):
    for arch in ONE_RANK:
        got = runs[(1, 1)][arch]
        assert all(got.get(k, 0.0) == 0.0 for k in NUMERIC), (arch, got)


@pytest.mark.parametrize("shape", list(TWO_RANKS))
def test_two_gloo_ranks_within_tolerance(shape, runs):
    for arch in TWO_RANKS[shape]:
        d = runs[shape][arch]
        assert d["loss"] <= GRAD_TOL and d["grad"] <= GRAD_TOL, (arch, d)
        assert d.get("logits", 0.0) <= LOGIT_TOL, (arch, d)
