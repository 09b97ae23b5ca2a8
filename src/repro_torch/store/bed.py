"""PLINK 1 binary genotype ingest (.bed/.bim/.fam) -> leveled matrix.

The port of ``repro.store.bed``: the same ``(V, info)`` and the same errors.
PLINK's ``.bed`` (Chang et al., arXiv:1410.4803) is a 2-bit packed genotype
format: after a 3-byte header (magic ``0x6c 0x1b`` and mode ``0x01`` for
SNP-major) each variant is ``ceil(n_samples / 4)`` bytes, two bits per
sample, LSB-first pairs: sample ``s`` lives in byte ``s // 4`` at bit offset
``2 * (s % 4)``.  The 2-bit codes map to A1-allele dosage:

    | code  | genotype          | dosage |
    |-------|-------------------|--------|
    | ``00``| homozygous A1     | 2      |
    | ``01``| missing           | policy |
    | ``10``| heterozygous      | 1      |
    | ``11``| homozygous A2     | 0      |

Dosages are the ``{0, 1, 2}`` / ``levels=2`` encoding the plane campaigns
run on.  Missing-genotype policy: ``"error"`` (default) raises naming the
count and the first SNP with a missing call; ``"zero"`` codes missing as
dosage 0; ``"drop"`` drops every SNP with a missing call.

Orientation: ``vectors="snps"`` (default) returns ``(n_f=n_samples,
n_v=n_snps)``, SNPs being the compared vectors; ``vectors="samples"`` keeps
the SNP-major layout ``(n_f=n_snps, n_v=n_samples)``.

The host reads the header and the payload bytes; the 2-bit decode, the
missing-call policy and the transpose run on ``device`` (None means
``"cuda"`` and raises without a GPU; ``device="cpu"`` runs the same code on
the CPU), and ``V`` comes back as a numpy array.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["read_bed", "bed_paths", "BED_MAGIC"]

BED_MAGIC = b"\x6c\x1b"
_MODE_SNP_MAJOR = 0x01
#: 2-bit code -> A1 dosage; 255 is the internal missing sentinel
_DOSAGE = np.array([2, 255, 1, 0], np.uint8)
#: one packed byte -> the dosages of its four samples, in sample order
_BYTE_DOSAGES = _DOSAGE[(np.arange(256)[:, None] >> np.array([0, 2, 4, 6])) & 3]
MISSING_POLICIES = ("error", "zero", "drop")


def bed_paths(path: str) -> tuple:
    """Accept a fileset prefix or any of its member paths -> (bed, bim, fam)."""
    prefix = path[:-4] if path.endswith((".bed", ".bim", ".fam")) else path
    triple = tuple(prefix + ext for ext in (".bed", ".bim", ".fam"))
    missing = [p for p in triple if not os.path.exists(p)]
    if missing:
        raise ValueError(f"PLINK fileset {prefix!r} incomplete: missing {missing}")
    return triple


def _count_lines(path: str) -> int:
    with open(path, "rb") as f:
        return sum(1 for line in f if line.strip())


def read_bed(
    path: str, *, missing: str = "error", vectors: str = "snps", device=None
) -> tuple:
    """Decode a PLINK fileset into a leveled dosage matrix.

    Returns ``(V, info)``: ``V`` is ``(n_f, n_v)`` uint8 with values in
    ``{0, 1, 2}`` (orientation per ``vectors``); ``info`` records
    ``n_snps`` / ``n_samples`` / ``n_missing`` / ``dropped_snps`` for the
    dataset manifest's provenance block.
    """
    if missing not in MISSING_POLICIES:
        raise ValueError(f"missing policy {missing!r} not in {MISSING_POLICIES}")
    if vectors not in ("snps", "samples"):
        raise ValueError(f"vectors must be 'snps' or 'samples', got {vectors!r}")
    device = resolve_device(device, "read_bed")
    bed, bim, fam = bed_paths(path)
    n_snps = _count_lines(bim)
    n_samples = _count_lines(fam)
    if not n_snps or not n_samples:
        raise ValueError(f"empty fileset: {n_snps} SNPs x {n_samples} samples")

    with open(bed, "rb") as f:
        header = f.read(3)
        if len(header) < 3:
            raise ValueError(f"{bed}: truncated header ({len(header)} bytes)")
        if header[:2] != BED_MAGIC:
            raise ValueError(f"{bed}: bad magic {header[:2]!r} (not a .bed file)")
        if header[2] != _MODE_SNP_MAJOR:
            raise ValueError(
                f"{bed}: individual-major mode (0x00) is unsupported — "
                f"re-export SNP-major (PLINK default since 1.07)"
            )
        raw = np.fromfile(f, np.uint8)
    nb = (n_samples + 3) // 4
    if raw.size != n_snps * nb:
        raise ValueError(
            f"{bed}: {raw.size} payload bytes, expected {n_snps} SNPs x "
            f"{nb} bytes (from {bim} / {fam} line counts)"
        )
    raw = torch.from_numpy(raw).to(device).view(n_snps, nb)
    table = torch.from_numpy(_BYTE_DOSAGES).to(device)
    G = table[raw.long()].view(n_snps, 4 * nb)[:, :n_samples]  # (n_snps, n_samples)

    miss = G == 255
    n_missing = int(miss.sum())
    dropped = 0
    if n_missing:
        snp_missing = miss.any(dim=1)
        if missing == "error":
            snp = int(snp_missing.nonzero()[0, 0])
            raise ValueError(
                f"{bed}: {n_missing} missing genotype(s), first at SNP row "
                f"{snp} — pass an explicit policy (missing='zero'|'drop')"
            )
        if missing == "zero":
            G = G.masked_fill(miss, 0)
        else:  # drop SNPs containing any missing call
            dropped = int(snp_missing.sum())
            G = G[~snp_missing]
    info = {
        "kind": "bed",
        "path": os.path.abspath(bed),
        "n_snps": n_snps,
        "n_samples": n_samples,
        "n_missing": n_missing,
        "dropped_snps": dropped,
        "missing_policy": missing,
        "vectors": vectors,
    }
    V = G.T if vectors == "snps" else G
    return V.contiguous().cpu().numpy(), info
