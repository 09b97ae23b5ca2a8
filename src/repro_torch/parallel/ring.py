"""Single-controller counterparts of ``shard_map``'s collectives.

``repro``'s 2-way programs run under ``shard_map`` over a ``("pf", "pv",
"pr")`` mesh: the payload is cut by ``in_specs``, ``ppermute`` over "pv"
moves the ring, ``psum`` over "pf" adds numerator and stat partials, and
``out_specs`` stitches the ranks' blocks together.  Here one process
drives every rank of a ``CometMesh``, and these functions do the same
moves between the ranks' devices:

* ``shard``: the payload cut as ``P("pf", "pv")`` (values, (n_fp / n_pf,
  m) a rank) or ``P(None, "pf", "pv")`` (packed planes, (levels, kb /
  n_pf, m) a rank), replicated over "pr", each shard on its rank's device;
* ``ppermute_pv``: the ring shift ``src (i + 1) % n_pv -> dst i``, a real
  copy onto the destination rank's device even where two ranks share one;
* ``psum_pf``: the pf ranks' tensors added in pf order on the pf = 0 rank;
* ``gather_blocks``: the (pv, pr) ranks' blocks on the host as
  ``out_specs=P("pv", "pr", ...)`` lays them out, slots a rank never
  computes left as zeros.

Nothing here synchronizes: launches on several cards overlap, and copies
between cards are ordered by PyTorch's cross-device copies.

Ranks are addressed ``parts[pf][pv][pr]``; a ring-carried tensor that
lives on the pf = 0 ranks only (the stats) is ``[[...]]``, one pf entry.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["place", "shard", "ppermute_pv", "psum_pf", "gather_blocks"]


def place(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` with its columns contiguous (a column slice of
    a payload is copied once; a tensor already so placed is returned)."""
    t = t.to(device, non_blocking=True)
    return t if t.is_contiguous() else t.contiguous()


def shard(payload: torch.Tensor, mesh, *, planes: bool) -> list:
    """``payload`` cut over the mesh: ``[pf][pv][pr]`` shards.

    ``payload`` is the padded (n_fp, n_v) value block, or the padded
    (levels, kb, n_v) packed planes (``planes=True``); its field (byte) and
    vector axes must divide by n_pf and n_pv.  The pr replicas of a shard
    on one device share one tensor; nothing writes a shard in place."""
    n_pf, n_pv, n_pr = mesh.shape
    fax = 1 if planes else 0
    nf = payload.shape[fax] // n_pf
    m = payload.shape[-1] // n_pv
    out = []
    for pf in range(n_pf):
        rows = payload.narrow(fax, pf * nf, nf)
        out.append([])
        for pv in range(n_pv):
            block = rows.narrow(-1, pv * m, m)
            placed = {}
            reps = []
            for pr in range(n_pr):
                dev = mesh.device(pf, pv, pr)
                if dev not in placed:
                    placed[dev] = place(block, dev)
                reps.append(placed[dev])
            out[pf].append(reps)
    return out


def ppermute_pv(parts: list, mesh) -> list:
    """One ring hop over "pv": rank (pf, i, pr) receives rank (pf, (i + 1)
    % n_pv, pr)'s tensor, copied onto its own device (``copy=True``: a
    received tensor never aliases the sender's, whichever device each is
    on)."""
    n_pv = len(parts[0])
    return [
        [
            [parts[pf][(i + 1) % n_pv][pr].to(mesh.device(pf, i, pr), copy=True,
                                             non_blocking=True)
             for pr in range(len(parts[pf][i]))]
            for i in range(n_pv)
        ]
        for pf in range(len(parts))
    ]


def psum_pf(tensors) -> torch.Tensor:
    """The pf ranks' tensors (pf order) summed onto the first's device, in
    pf order; one tensor is returned as it is."""
    acc = tensors[0]
    for t in tensors[1:]:
        acc = acc + t.to(acc.device, non_blocking=True)
    return acc


def gather_blocks(blocks: dict, shape: tuple, dtype: np.dtype) -> np.ndarray:
    """``{(pv, pr, slot): block}`` on the ranks' devices -> the host array
    ``shape`` = (n_pv, n_pr, slots, ...) of ``dtype``, zeros where no block
    was computed.  Each block is copied straight into its slot; a 2-byte
    ``dtype`` (bfloat16 bits as uint16) is copied through int16 views."""
    out = np.zeros(shape, dtype)
    view = out.view(np.int16) if dtype.itemsize == 2 and dtype.kind == "u" else out
    for key, t in blocks.items():
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        torch.from_numpy(view[key]).copy_(t)
    return out
