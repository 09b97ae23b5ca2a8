#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero and no phase
failure is caught):

1. environment: Python / torch / CUDA versions and the card's name and power
   limit from ``nvidia-smi``; TF32 is switched off;
2. build: the CUDA kernels of ``src/repro_torch/csrc`` with ``nvcc`` and,
   all at once beside them, the library of each combine phase combines
   compiles (six combines on int8 and float32 operands: ``combine_set``'s
   five and ``maximum(a, b) + 1``; and ``ring_libraries``, those of (e)
   and (f) on the widened rings), with the build's seconds and each
   kernel's ``ptxas`` registers and spills;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, ``torch.equal`` on integer data, at full width and at ragged
   shapes (every epilogue, fp32 and bf16 out, plane counts 1-3, int8 and
   float32 values, both combines, strided views as the 3-way pipeline
   slices give them, and contiguous copies; row 3 in its split form, its
   contraction split over grid.z and the slabs added by a second pass, and
   in its unsplit form at n_v = 4,000, its split counts printed and both
   forms required); kernel, plain and library
   times at the shapes the main paths give each kernel, the library call
   first checked equal to the kernel's raw numerator.  The value slice
   kernel (row 11) is held against its plain version at L = 4 pipeline
   columns (the plain version loops over columns) and, at full width,
   against the plane slice kernel (row 12) on the same {0,1,2} data and,
   column by column, against the single-column kernel (row 10).  The
   level-decomposition GEMM (row 4) is held on int8 and float32 values that
   are not leveled (negatives, values above ``levels``, halves, NaN and
   +-inf), levels 1-3, 9 and 130 (several plane windows), A a strided
   pipeline view's transpose and a copy, on the scalar and the vector load
   paths, and at full width on {0,1,2} int8 at the value ring's shapes.
   Row 11's CCC product on int8 operands (the tensor-core kernel) is held
   at the whole int8 range (n_f <= 8, so the fp32 plain version is exact),
   at both signs up to 40 (n_f 333-1000), where its hi pass runs, and where
   one product of one stage of one block leaves [0, 255]; row 10's form
   column by column; at full width beside ``torch._int_mm`` of the int8
   fold and the fp32 matmul of the fold.  Rows 1 / 2 and 11 / 10 on the
   CUDA cores (one pipelined main loop) also at the edges of its copies:
   operand views whose row bases and row stride take its 16-, 4- and 1-byte
   copies, k not a multiple of its 32-field stage, m and n not multiples of
   128, signed int8 and quarter-grid (dosage) float32 values; their float32
   forms (row 11 with min and with the CCC product, row 1 at both pair-term
   shapes, whose split contraction must give the same bits on two calls)
   are timed at full width on dosage data beside float32 library calls;
   the ``ptxas`` reports of ``mgemm_rect`` and ``minplus3`` are printed.  The plane slice kernel (rows 12 / 9)
   is also held at the edges of its GEMM form (kb not a multiple of its
   stage or of 4, L = 1 and odd, m and n from 1 to 255, an odd pipeline
   offset, operands that take its 16-byte, 4-byte and byte copies), and
   its ``ptxas`` report is printed.  The rectangular plane kernel (rows 5
   / 7) likewise: kb from 1 to 129 bytes (not a multiple of 4 or of its
   32-byte-row K step), m and n from 1 to 255, levels 1-3, operand views
   at offsets that take its 16-byte, 4-byte and byte copies, every
   epilogue and both out dtypes; its ``ptxas`` report is printed, and it
   is timed at both pair-term shapes, (1536, 1536) and (64, 1536).  The
   triangular plane kernel (rows 6 / 8), on the same b1 main loop, at the
   edges of that form too: kb from 1 to 129 bytes, n_v from 1 to 257 (one
   and several tiles, diagonal tiles, a ragged last tile), levels 1-3,
   every epilogue and both out dtypes, on planes that take its 16-byte,
   4-byte and byte copies; its ``ptxas`` report is printed.  Rows 3 / 6 /
   8 are also timed at the (2,048, 2,048) diagonal block and rows 2 / 5 /
   7 at the (2,048, 2,048) off-diagonal one, the shapes a (1, 4, 1)
   decomposition gives them, each beside its bound (row 3, split there,
   also held to its plain version, beside its library call and its split
   count, which its time at the (8,192) block prints too); rows 12, 9 and 11
   (min and the int8 CCC product) at the shapes a 3-way decomposition
   gives them, (L, m) = (16, 384) at (1, 4, 1) and the ragged (22, 528) at
   (1, 3, 2), on three distinct operands (the pipe a strided view of a
   second block), against their plain versions, beside their bounds;
4. campaigns: the port's main path through ``SimilarityEngine(device="cuda")``
   at full width (n_f = 20,000, the paper's synthetic GWAS vector length;
   n_v = 8,192): Czekanowski under impl pallas / levels (levels=2,
   {0,1,2} data), Sorenson under levels=1 ({0,1} data), CCC under xla /
   pallas; the unfused min-plus references: impl="levels_xla" (the plain
   level decomposition, one fp32 matmul a level) at full width, held to
   impl="xla" (the chunked plain min-plus contraction, 18 s at 8,192) on
   1,024 columns spread over the block (8 windows, one a 1,024, so every
   (1,024)^2 tile pair is sampled).  Launch counts are zeroed just before
   and read just after; every fused run must take its kernel and equal
   its metric's full-width unfused reference bit for bit.
   Each run prints its own ``meta["layer_seconds"]``;
5. checksums across impls at n_v = 1,024 (and a metric without an
   in-kernel epilogue, whose unfused contraction is the min-plus GEMM, row
   1, under impl="pallas" and the level-decomposition GEMM, row 4, under
   impl="levels" with encoding="none") and a float64 oracle check at a
   small size;
6. campaigns3: the 3-way main path at full width, n_f = 20,000 and
   n_v = 1,536 with n_st = 4 and stages=(0,) (pipeline length L = 64; a
   stage holds 6 x 64 x 1536^2 fp32 = 3.6 GB of blocks; the sizing is the
   port's own choice): Czekanowski on {0,1,2} data and Sorenson on {0,1}
   data, each on the plane ring (levels=2 / levels=1: ``fused-levels-ring``
   / ``fused-popcount-ring``) and on values under impl="pallas"
   (``fused-vpu``), each against ``impl="levels_xla"`` on the same data;
   CCC on {0,1,2} data under impl="pallas" against ``impl="xla"``; the
   levels value ring (``fused-levels`` / ``fused-popcount``: values encoded
   to planes per slice, pair terms through row 4): Czekanowski (levels=2)
   and Sorenson (levels=1) with ``encoding="none"`` against the plane
   ring's blocks, and Czekanowski on {0..3} data (``auto`` resolves to
   ``none``) against ``impl="levels_xla"`` on the same data; on dosage data
   (integers in [0, 8] over 4, carried as float32 by resolve's own rule)
   CCC under impl="pallas" against ``impl="xla"`` and Czekanowski under
   impl="pallas" against the plane ring, levels=8, on 4 x the data.
   Counts are zeroed before the phase and read after it: each stage
   launches the slice kernel 6 times and the pair-term kernel 18 times
   (none for CCC, whose pair terms are unused), and the blocks equal the
   reference's;
7. batched: batched campaigns (``metrics`` / ``subsets``), each campaign
   ``np.array_equal`` to its sequential counterpart (the blocks of phases 4
   and 6 where the same request ran there; Sorenson's blocks are
   Czekanowski's on the same data), with exact launch counts that show
   each metric family contracting once: 2-way at n_v = 8,192, (a)
   Czekanowski + Sorenson + CCC under impl="levels", levels=2 (row 6 once,
   raw; CCC on the values of the planes through its fp32 matmul), (b)
   Czekanowski + CCC under impl="pallas" (row 1 once, on the whole block),
   (c) (a) on two overlapping named subsets, one given in reverse; 3-way
   at phase 6's size, (d) Czekanowski + Sorenson on the plane ring (6
   slices + 18 pair terms, as one campaign) and (e) Czekanowski + CCC
   under impl="pallas" (12 slices, 18 pair terms); (f) a mixed-family
   3-way batch on the plane ring with named subsets at n_v = 150, all
   stages (CCC's campaign on the subset given in reverse equals the
   sequential campaign on its columns in ascending order: its fp32
   denominator rounds by the roles of its three vectors, which the batch
   assigns in the union's order, as ``repro``'s does); (h) / (i)
   Sorenson + Czekanowski on {0,1} data at levels=1 (rows 8, 9 and 7),
   2-way at n_v = 8,192 and 3-way at n_v = 150.  Each batch prints its wall, comparisons/s, layer seconds and
   ``meta["batch"]`` beside the sum of its sequential campaigns' walls.
   Then float16 outputs (impl="pallas" and levels=2, n_v = 8,192) equal
   the float32 blocks cast to float16, and bfloat16 and int32 rings under
   impl="pallas" (2-way at n_v = 8,192, 3-way at n_v = 150) equal the
   int8 ring's; row 1 at (8,192, 8,192) and row 6 raw at n_v = 8,192 are
   timed beside their bounds;
8. checksums3: 3-way checksums across impls at n_v = 150 (padded to 156),
   n_f = 20,000, n_st = 2, all stages, impl="pallas" and the levels value
   ring among them; Sorenson equals Czekanowski on binary data; a float64
   ``oracle3`` check at a small size;
9. ccc_tf32: TF32 switched on for the whole process, CCC's unfused 2-way
   campaign (n_v = 1,024) and unfused 3-way slices (n_v = 150) on integers
   up to 4,095 (n_f = 4,000) give the blocks they give with TF32 off, while
   a plain fp32 matmul of the same data changes; the flags are then
   restored;
10. store: the dataset store (``repro_torch.store``) and the CLIs.  Ingest:
   PLINK filesets written here from the phase data (8,192 SNPs x 20,000
   samples, a 41 MB ``.bed``; a copy with 0.1% missing calls, under each
   missing policy; and 8,192 SNPs of other data, written as 4 field
   shards), each read back by ``read_bed``, written by ``write_dataset``
   (planes packed and popcounted on the card), validated, and held against
   the host encoder's checksum and stats, with the seconds of each step.
   Campaigns from disk (``InputSpec(source="planes")``): 2-way Czekanowski
   levels=2 and Sorenson levels=1 at n_v = 8,192 (rows 6 / 8), the 4-shard
   dataset with ``streaming="off"``, and one 3-way plane-ring stage each (n_v = 768)
   (rows 12 / 9 and 5 / 7); counts are zeroed before each and read after
   it, the host encoder is wrapped with a counter that must stay at 0, and
   the blocks must equal the same request on the value matrix, whose layer
   seconds are printed beside.  Then the
   CLIs as a user runs them, as subprocesses: ``dataset encode --bed``,
   then at once ``inspect``, ``validate`` and ``similarity --dataset``
   (and ``--dry-run``) at n_v = 1,024, whose ``checksum=`` line must equal the
   in-process value-input campaign's.  A batched campaign (Czekanowski +
   Sorenson + CCC, one named subset) from the 8,192-SNP dataset runs row 6
   once and no host encode, and equals the same batch on the value matrix;
11. stream: out-of-core streamed campaigns (``repro_torch.stream``) and
   border-block deltas (``repro_torch.core.delta``), each
   ``np.array_equal`` to its in-memory or full-recompute counterpart, with
   counts zeroed before each run and read after it and the host encoder
   counted (0 on every run): (a) the 4-shard 2-way dataset (levels=2)
   under ``streaming="auto"`` (4 chunks, row 6 raw once a chunk) and with
   an 8 MiB ``max_host_bytes`` (10 chunks of 256 bytes across the shard
   boundaries, ``peak_host_bytes`` within the budget, so the prefetch
   thread runs ahead of the pinned copies); (b) Sorenson on the 4-shard
   {0,1} dataset (row 8 raw once a chunk); (c) biobank length, n_f =
   488,377 x n_v = 1,024 int8 written as 8 shards on the card, streamed
   with a 32 MiB budget (8 chunks of 8,192 bytes); (d) one 3-way stage
   (n_v = 768, n_st = 4) from 4 shards, levels=2 and levels=1 (6 slices
   and 18 pair terms a chunk); (e) the 2-way batch Czekanowski + Sorenson
   + CCC with one named subset (row 6 raw once a chunk) and the 3-way
   batch Czekanowski + Sorenson, against the same batches with
   ``streaming="off"``; (f) 512 vectors appended on the card to a copy of
   (a)'s dataset, the delta from the 8,192-vector campaign with
   ``streaming="off"`` (rows 5 and 6 fused once) and streamed with an 8
   MiB budget (rows 5 and 6 raw once a chunk), and under impl="pallas" on
   the value matrices (row 2 once at (8,192, 512), row 3 once at 512),
   each equal, as packed values, to the full recompute at 8,704; (g) the
   CLIs as subprocesses at n_v = 1,024 + 128: ``similarity --streaming on
   --max-host-bytes`` and ``--out`` at once, ``dataset append --synthetic`` and
   ``similarity --delta-from``, whose ``checksum=`` lines equal the
   in-process full recomputes'.  Each run prints its ``meta["stream"]`` /
   ``meta["delta"]`` and layer seconds beside its counterpart's;
12. decomp: 2-way decompositions (``repro_torch.parallel``; the function
    ``check_decomp(V2, V1, refs2, walls2, prior, wrappers)``), every rank
    on ``cuda:0`` (``SimilarityEngine(devices=["cuda:0"] * 8)``), each
    result held bitwise to its (1, 1, 1) run on the same data (``dense()``
    as uint32 bits, ``num_pairs()``) with exact launch counts: from 1-shard
    datasets of the campaigns phase's data, Czekanowski levels=2 at (1, 4, 1), (2, 2, 1), (1, 3, 2) (n_v padded to 8,193, the
    round-robin) and (2, 2, 2); Sorenson levels=1 at (1, 4, 1) and (2, 2,
    1); Czekanowski ``pallas`` at (1, 4, 1) (rows 3 / 2) and (2, 2, 1)
    (row 1, "unfused"); CCC ``pallas`` at (1, 4, 1); ``impl="xla"`` at n_v
    = 1,024, (1, 2, 2) and (2, 2, 1); stream (a) at (2, 2, 1); batch (a)
    at (2, 2, 1); delta (f) in memory at (1, 2, 1) against its (1, 1, 1)
    delta.  Each prints its wall, path, layer seconds and launches;
13. decomp3: 3-way decompositions (the function ``check_decomp3(V2, V1,
    wrappers)``), up to 8 ranks on ``cuda:0``, one stage (n_st = 4, stage
    0) of campaigns3's data: at n_v = 384 each result held bitwise to its
    (1, 1, 1) run (``dense()`` as uint32 bits, ``num_triples()``):
    Czekanowski levels=2 from a 1-shard dataset at (1, 4, 1), (2, 2, 1),
    (1, 3, 2) and (2, 2, 2), Sorenson levels=1 at (1, 4, 1), ``pallas``
    Czekanowski from values at (1, 4, 1), CCC ``pallas`` at (1, 2, 2) and
    (1, 4, 1) (its fp32 denominator rounds by the roles the blocks give a
    triple's vectors, as ``repro``'s does: held within 2^-21 of (1, 1, 1),
    the same cells nonzero) and the levels=2 batch Czekanowski + Sorenson
    + CCC at (1, 4, 1) (CCC bitwise the ``pallas`` run's there); at
    n_v = 768 (``N_V3_SIDE``) Czekanowski levels=2 at (1, 4, 1), (2, 2, 1)
    and (1, 3, 2) (the ragged 264-wide block, L = 11), ``pallas`` at (1, 4, 1),
    the stage streamed from 4 shards at (2, 2, 1) and one request to
    ``SimilarityService(devices=["cuda:0"] * 4)``, each held to the (1, 1,
    1) run by ``num_triples()`` and an order-free digest of (i, j, k,
    value bits) computed on the card (``digest3``).  Every run launches
    exactly one slice a pf rank and item of every slab (and a chunk when
    streamed), and the three pair terms where its family needs them;
14. obs_serve: tracing and serving (``repro_torch.obs``,
    ``repro_torch.serve``; the function ``check_obs_serve(engine, V2,
    prior, wrappers)``).  (a) Four campaigns of the phases before, each
    run untraced and then traced: the 2-way levels=2 campaign from a
    1-shard dataset (n_v = 8,192), one 3-way plane-ring stage from values
    (n_v = 768, half campaigns3's block; n_st = 4), stream (a) and the
    in-memory delta (f) (its
    prior is phase stream's 8,192-vector campaign, checksum taken).  The
    traced blocks equal the untraced, the phase counts are the expected
    ones (``campaign`` / ``validate`` 1; ``ring-step`` 1 and ``encode`` 0
    from the dataset, ``encode`` 1 on the 3-way values; ``ring-step`` ==
    ``prefetch-stage`` == chunks and ``merge`` 1 streamed; ``delta-border``
    1 and ``merge`` 1, no ``ring-step``, for the delta), ``0 <
    utilization <= 1`` (the roofline bound over the measured ``ring-step``
    / ``delta-border`` seconds; above 1 the count would be wrong) and the
    Chrome trace validates; each prints its phase table, ``obs`` line and
    the untraced and traced walls.  (b) ``SimilarityService(device="cuda",
    workers=2)`` on phase stream (g)'s datasets (n_v = 1,024, 1 and 4
    shards): one warmup, four concurrent submits (two duplicates, one
    on values under impl="pallas"), the appended dataset's request (+128)
    as one delta hit; every result's blocks equal the in-process
    engine's (the delta hit's the packed full recompute's), ``stats()`` is
    the expected one and keeps hits + misses + in_flight == submitted;
    ``metrics()`` is printed with the queue-wait and compute p50.  Every
    traced, untraced and served run launches exactly its expected kernels;
15. combines: any registered combine on the value kernels, rows 3, 2, 11
    and 10 running a compiled combine (the function
    ``check_combines(engine, V2, kernels, combines)``): (a) each against its
    plain version under five combines (``combine_set``) on int8 and
    float32, ragged and full width, timed after a warm call beside min
    (``check_combine_kernels``), and row 3 under ``maximum(a, b) + 1``,
    whose combine(0, 0) != 0, split and unsplit at ragged shapes; (b) a
    2-way Bray-Curtis dissimilarity under impl="pallas" at n_v = 8,192,
    and at 2,048 at (1, 2, 1) equal bit for
    bit to its chunked impl="xla" campaign; (c) a 3-way ``maxplus`` stage
    at n_v = 768 equal to the same request on plain slices; (d)
    ``find_near_duplicates`` on the card equal to the CPU's; (b) and (c)
    run no nvcc; (e) rows 3, 2, 11 and 10 on the bfloat16, float16,
    int16 and int32 rings (``check_ring_combines``: ``(a - b) ** 2`` and
    ``a * 0.3 + b`` on the float rings, the wrapping ``a * b`` and ``abs(a
    - b)`` on the int rings) at full width against their plain versions,
    on sparse data whose terms the ring changes and whose fp32 sums stay
    exact, timed beside float32 / int8, and at one field under a clamp
    that meets 0/0, whose NaN must pass; (f) a 2-way Bray-Curtis campaign
    on a bfloat16 ring at n_v = 8,192, held to the port's CPU campaign on
    1,024 of its columns by checksum (``check_ring_campaign``), the CPU
    campaign run after every timed one;
16. lm_serve: the LM stack's inference path and its server
    (``check_lm_serve``): llama3-8b, mamba2-1.3b and granite-moe-3b-a800m
    at their full configs served by ``ServeEngine``, the cached path held
    to one full forward, granite at 2 layers and the smoke configs held to
    the port on the CPU;
17. lm_train: LM training (``check_lm_train``): (a) qwen1.5-0.5b at its
    full config through ``Trainer`` (TRAIN_BATCH x TRAIN_SEQ tokens a step,
    TRAIN_STEPS steps, a checkpoint every TRAIN_CKPT_EVERY), then a run
    that fails at step TRAIN_FAIL_AT and one that resumes: its parameters,
    moments and losses bit for bit the first run's; (b) three
    architectures at full width with 2 layers and (c) every smoke config,
    train steps on the card held to the port on the CPU (loss, grad_norm,
    the updated parameters), (b) also to a second run on the card, bit for
    bit;
18. mesh: the dry-run and runs on a ``DeviceMesh`` (``check_mesh``): (a)
    ``python -m repro_torch.launch.dryrun`` of llama3-8b train_4k on the 16
    x 16 mesh and of comet_2way, CPU processes started before phase 1 and
    run beside the phases (``start_dryruns``), each cell's terms printed,
    the LM cell's useful-flops ratio in (0.3, 1]; (b) qwen1.5-0.5b at its
    full config through ``Trainer`` and its
    ``ServeEngine`` greedy tokens on a one-rank NCCL mesh, bit for bit the
    runs without one;
19. the kernels' JSON line (the float32 forms of rows 1 and 11, and the
    compiled combines of rows 2, 3, 10 and 11 (``[expr]``), as entries of
    their own, launches counted on the dosage campaigns and the widened
    float32 rings, and on phase combines' campaigns; the batches', the
    store's, the streamed and delta campaigns', the decomposed 2-way and
    3-way ones' and obs_serve's added to each row),
    the card line, and the result line.

Bounds (``bound_ms``): the larger of the bytes moved (inputs read once,
output written once; a pipeline view is an input of its own) over HBM
bandwidth and the operations over the card's highest peak rate for their
type.  The peaks and the counts below are ``repro_torch/obs/roofline.py``'s,
which prices a traced campaign's launches the same way
(``meta["obs"]["bound_seconds"]``).  Row 3 (min-plus, fp32 ``min`` + add, no
tensor-core form): 2 fp32 instructions per comparison over the CUDA cores'
issue rate, half the 67 TFLOP/s peak, which counts an FFMA as 2 flops.
Rows 1, 2, 10 and 11 likewise: 2 instructions per comparison for min, 1
(an FFMA) for the CCC product.  Rows 5, 6, 7, 8 (0/1 planes): the
numerator is popcount(a AND b) over the packed bits, which the b1 tensor
cores compute (``mma.sync`` m16n8k256 ``.and.popc``), so 2 ops per (pair,
plane, field) over the b1 rate that ``tools/mma_rates.py`` measured, 5.2x
the int8 peak (the data sheet lists no b1 rate; the int8 bound is printed
beside it); rows 12 and 9 (3-way slices) likewise 2 ops per (pipeline
column, pair, plane, field).  Row 4 (values) packs the indicators [x >= t]
to planes on chip and multiplies them on the b1 tensor cores: 2 ops per
(pair, plane, field) over the b1 rate, the int8 bound beside it.  Row 11's
CCC product on int8 operands: 2 ops per (pipeline column, pair, field) over
the int8 peak.  A compiled combine (``[expr]``): its ops and the add per
comparison over the fp32 issue rate.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_F = 20_000  # the paper's synthetic GWAS vector length
N_V = 8_192
N_V_CHECKSUM = 1_024
# (2,048 before phase combines took its room)
N_V3 = 1_536  # 3-way block: n_st = 4 gives pipeline length 64
N_ST3 = 4
N_V3_CHECKSUM = 150  # C(150, 3) = 551,300 triples; pads to 156 at n_st = 2
# (190 before phase combines took its room)
# the 3-way stages of phases store, stream (d) / (e) and decomp3's staged
# requests (N_V3, 1,536, before phase lm_serve took their room)
N_V3_SIDE = 768
L_PLAIN = 4  # pipeline columns the value slice kernel's plain version runs
SEED = 0
ONE_CALL_MS = 1_000.0  # cuda_ms: a call this long is timed once
# an eighth of a biobank chunk: a 41 MB .bed at N_F samples, which keeps
# the host encoder it is held against near 4 s on the H100 machine's host
# (32,768 SNPs before phase combines took its room, 16,384 before lm_serve)
STORE_SNPS = 8_192
STORE_SHARDS = 4
STREAM_BUDGET = 8 << 20  # staging budget of (a) and (f): 256 / 240-byte chunks
BIOBANK_N_F = 488_377  # UK Biobank's genotyped participants
BIOBANK_N_V = 1_024  # 2,048 before phase lm_serve
BIOBANK_SHARDS = 8
BIOBANK_BUDGET = 32 << 20  # 8 chunks of 8,192 bytes, the last one partial
DELTA_NEW = 512  # vectors appended to the N_V of (f)
CLI_NEW = 128  # vectors appended to the N_V_CHECKSUM of (g)
CLI_BUDGET = 4 << 20
STREAM_COHORT = 3_000  # (e)'s named subset: the first 3,000, reversed
LM_BATCH = 4  # phase lm_serve: prompts a request
LM_PROMPT = 8  # tokens a prompt
LM_NEW = 16  # greedy tokens a request
LM_TOL = 2e-3  # full width on the card: cached path vs lm_forward, card vs CPU
LM_TOL_SMOKE = 1e-4  # smoke configs, the card vs the CPU
TRAIN_BATCH = 4  # phase lm_train (a): qwen1.5-0.5b at its full config
TRAIN_SEQ = 256
TRAIN_STEPS = 6
TRAIN_CKPT_EVERY = 3
TRAIN_FAIL_AT = 4  # the second run fails here and the third resumes from step 3
TRAIN_TWIN_BATCH = 2  # (b): full width, 2 layers, the card against the CPU
TRAIN_TWIN_SEQ = 64
TRAIN_SMOKE_SEQ = 16  # (c): the smoke configs, B = TRAIN_TWIN_BATCH
TRAIN_TWIN_STEPS = 2
# (b) / (c) updated parameters, card vs CPU: most elements move with their
# gradient's last bits (1e-7 relative), but an element whose gradient is a
# near-cancelling sum carries a large relative error on either device, and
# AdamW's second step moves it by lr times that error (its first step is
# lr * sign(g) whatever the error, 2 lr apart if the sign flips), at most
# 1.5 lr a step.  So at most a TRAIN_PARAM_FRAC share of the elements may
# differ by more than TRAIN_PARAM_TOL, and none by more than 3 lr a step.
# (On an H100 the qwen1.5-0.5b smoke config has 14 such elements of
# 99,008, 1.4e-4 of them, within 2.43e-6.)
MESH_STEPS = 3  # phase mesh (b): qwen1.5-0.5b at its full config, Trainer(mesh=)
MESH_BATCH = 4
MESH_SEQ = 256
TRAIN_PARAM_TOL = 1e-6
TRAIN_PARAM_FRAC = 1e-3
TRAIN_GNORM_RTOL = 1e-5

# H100 SXM peaks, one source with a traced campaign's roofline
# (repro_torch.obs.roofline: the data sheet's HBM, fp32 and int8 peaks at
# 700 W, and the b1 rate tools/mma_rates.py measured)
from repro_torch.obs.roofline import (  # noqa: E402
    B1_OPS_PER_S,
    FP32_INSTR_PER_S,
    HBM_BYTES_PER_S,
    INT8_OPS_PER_S,
)


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, repeats: int) -> tuple:
    """(median ms, last result) of ``fn`` timed with CUDA events, after one
    warm-up call.  A first call of ``ONE_CALL_MS`` or more is the time: a
    second's one-time costs are a small share of it, and plain versions of
    many seconds would otherwise run twice or more."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    first = start.elapsed_time(end)
    if first >= ONE_CALL_MS:
        return first, out
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def one_ms(fn) -> tuple:
    """(ms, result) of one call of ``fn`` timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def bound_of(in_bytes: int, out_bytes: int, ops: float, rate: float) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over HBM
    bandwidth and the operations over their peak rate."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def combine_set() -> dict:
    """The registered combines phase combines holds to their plain versions
    (name: callable): ``maximum``, ``abs(a - b)`` (Bray-Curtis's), the
    int8-wrapping ``a * b``, the mixed-dtype ``(a.float() - b) * 0.5`` and
    the five-deep ``a - (b - (a - (b - a)))``."""
    import torch

    def absdiff(a, b):
        return torch.abs(a - b)

    def wrapmul(a, b):  # int8 x int8 wraps, as in torch and jnp
        return a * b

    def mixed(a, b):
        return (a.float() - b) * 0.5

    def deep(a, b):
        return a - (b - (a - (b - a)))

    return {"maximum": torch.maximum, "abs(a - b)": absdiff, "a * b": wrapmul,
            "(a.float() - b) * 0.5": mixed, "a - (b - (a - (b - a)))": deep}


def nonzero_combines() -> dict:
    """A combine with combine(0, 0) != 0, ``maximum(a, b) + 1``, which row
    3x's ragged checks run: the kernel then cuts the stage that holds field
    k to the real fields (``live_rows``), in the split form's last split and
    in the unsplit form."""
    import torch

    def maxplus1(a, b):
        return torch.maximum(a, b) + 1

    return {"maximum(a, b) + 1": maxplus1}


def combine_libraries(combines) -> list:
    """``(name, library)`` of each combine compiled on int8 and on float32
    operands."""
    import torch

    from repro_torch.kernels.mgemm.combine import combine_expr

    return [(name, combine_expr(comb).library(dt)) for name, comb in combines.items()
            for dt in (torch.int8, torch.float32)]


def ring_combines() -> dict:
    """The combines phase combines (e) runs on each widened ring (ring:
    {name: callable}): on the float rings (bfloat16, float16) ``(a - b) **
    2`` and ``a * 0.3 + b``, on the int rings (int16, int32) the wrapping
    ``a * b`` and ``abs(a - b)``.  The same callables run on float32 / int8
    beside them."""
    import torch

    def sqdiff(a, b):
        return (a - b) ** 2

    def scaled(a, b):
        return a * 0.3 + b

    def wrapmul(a, b):  # wraps on int16 and int32, as in torch and jnp
        return a * b

    def absdiff(a, b):
        return torch.abs(a - b)

    floats = {"(a - b) ** 2": sqdiff, "a * 0.3 + b": scaled}
    ints = {"a * b": wrapmul, "abs(a - b)": absdiff}
    return {torch.bfloat16: floats, torch.float16: floats, torch.int16: ints,
            torch.int32: ints}


def base_dtype(ring):
    """The dtype phase combines (e) times a ring's combines on beside it:
    float32 for a float ring, int8 for an int ring."""
    import torch

    return torch.float32 if ring.is_floating_point else torch.int8


def nan_combine():
    """``clamp((a - b) / (a + b), -0.5, 1)``: 0/0 where both fields are 0,
    a NaN that the clamp (a max, then a min) must pass through, as torch's
    does; run on a bfloat16 ring (float min / max are one function on
    every tag)."""
    import torch

    def nan_clamp(a, b):
        return torch.clamp((a - b) / (a + b), min=-0.5, max=1.0)

    return nan_clamp


def ring_libraries() -> list:
    """``(name, library)`` of each ``ring_combines`` combine on its ring and
    on ``base_dtype``, and of ``nan_combine`` and ``abs(a - b)`` (the
    Bray-Curtis campaign of (f)) on bfloat16; built in phase build."""
    import torch

    from repro_torch.kernels.mgemm.combine import combine_expr

    libs = []
    for ring, combines in ring_combines().items():
        for name, comb in combines.items():
            libs += [(f"{name} on {ring}", combine_expr(comb).library(ring)),
                     (f"{name} on {base_dtype(ring)}",
                      combine_expr(comb).library(base_dtype(ring)))]
    absdiff = ring_combines()[torch.int16]["abs(a - b)"]
    libs.append(("abs(a - b) on torch.bfloat16",
                 combine_expr(absdiff).library(torch.bfloat16)))
    libs.append(("clamp((a - b) / (a + b), -0.5, 1) on torch.bfloat16",
                 combine_expr(nan_combine()).library(torch.bfloat16)))
    first = {}
    for name, lib in libs:  # one library serves every callable of its expression
        first.setdefault(lib, name)
    return [(name, lib) for lib, name in first.items()]


def ptxas_report(log: Path) -> list:
    """``(kernel, registers, spill stores, spill loads)`` of each entry
    function in a library's ``ptxas -v`` log, names demangled where
    ``c++filt`` is found and cut to the kernel and its template arguments."""
    import re

    rows, name, spills = [], None, (0, 0)
    for line in log.read_text().splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1)
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit and name:
            spills = (int(hit.group(1)), int(hit.group(2)))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            rows.append([name, int(hit.group(1)), *spills])
            name, spills = None, (0, 0)
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
        for row, full in zip(rows, names):
            full = full.replace("(anonymous namespace)::", "").split("(")[0]
            short = re.sub(r"repro::minplus::(\w+::)?|repro::|^void ", "", full)
            row[0] = short.replace("signed char", "int8")
    return [tuple(r) for r in rows]


def run_clis(commands, env) -> list:
    """Run each command (the arguments after ``python -m``) as a user runs
    it, a subprocess from the checkout's root, all at once: they read
    different files or only read one.  Prints each command with its seconds
    from the common start and its output, in order, and returns each one's
    output lines; raises when one fails, after stopping the others."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", *map(str, argv)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for argv in commands]
    outs = []
    try:
        for argv, proc in zip(commands, procs):
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"{' '.join(map(str, argv[:2]))}: exit "
                                     f"{proc.returncode}: {stderr[-2000:]}")
            print(f"  $ python -m {' '.join(map(str, argv))}  "
                  f"({time.perf_counter() - t0:.2f} s)")
            for line in stdout.splitlines():
                print(f"    {line}")
            outs.append(stdout.splitlines())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def spread_columns(n, n_v):
    """``n`` of ``n_v`` column indices in 8 windows, one an eighth of the
    block and each at its own offset in it, so a campaign on them samples
    every pair of eighths (and tile alignments) of the full block."""
    span, width = n_v // 8, n // 8
    step = span + (span - width) // 8
    return np.concatenate([np.arange(i * step, i * step + width) for i in range(8)])


def minplus_library(Va, Vb=None):
    """One PyTorch call for the min-plus numerator of Va (k, m) and Vb (k, n)
    (Va itself by default): sum_q min(a, b) = (sum a + sum b - sum |a - b|)
    / 2, with cdist(p=1)."""
    import torch

    X = Va.t().to(torch.float32).contiguous()
    Y = X if Vb is None else Vb.t().to(torch.float32).contiguous()
    sx = X.sum(dim=1)
    sy = Y.sum(dim=1)
    return lambda: 0.5 * (sx[:, None] + sy[None, :] - torch.cdist(X, Y, p=1))


def indicators(P):
    """(w, levels*K) int8 rows of the unpacked 0/1 indicators of planes P
    (levels, kb, w)."""
    import torch

    from repro_torch.kernels.mgemm_levels import decode_bitplanes

    return decode_bitplanes(P).reshape(-1, P.shape[-1]).t().contiguous().to(torch.int8)


def planes_library(Pa, Pb):
    """One PyTorch call for the plane numerator sum_t Pa_t^T . Pb_t: an
    exact int8 x int8 -> int32 product of the unpacked 0/1 indicators,
    (m, levels*K) x (levels*K, n)."""
    import torch

    A = indicators(Pa)
    B = A if Pb is Pa else indicators(Pb)
    return lambda: torch._int_mm(A, B.t())


def plane3_library(Pown, PX, Pright):
    """One PyTorch call for the 3-way slice numerator: the pipeline axis
    folded into M, (L*m, levels*K) x (levels*K, n) on the indicators of
    own AND x_t (rows ordered (t, i)) and of right; reshape to (L, m, n)."""
    import torch

    levels, kb, m = Pown.shape
    X = (Pown[:, :, None, :] & PX[:, :, :, None]).reshape(levels, kb, -1)
    A = indicators(X)
    del X
    B = indicators(Pright)
    return lambda: torch._int_mm(A, B.t())


def levels_library(Va, Vb, levels: int):
    """One PyTorch call for the level-decomposition numerator of values Va
    (k, m) and Vb (k, n): an exact int8 x int8 -> int32 product of the 0/1
    indicators [x >= t] stacked along K, (m, levels*k) x (levels*k, n)."""
    import torch

    def stacked(V):
        return torch.cat([V.t() >= t for t in range(1, levels + 1)],
                         dim=1).to(torch.int8).contiguous()

    A = stacked(Va)
    B = A if Vb is Va else stacked(Vb)
    return lambda: torch._int_mm(A, B.t())


def check_equal(name: str, got, want, errs: list) -> None:
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    errs.append(err)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain (max abs err {err})")


def check_equal_nan(name: str, got, want, errs: list) -> int:
    """``check_equal`` where a NaN equals a NaN (its sign and payload are no
    IEEE result: the card's and torch's differ); returns the NaNs."""
    import torch

    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)):
        raise AssertionError(f"{name}: NaNs where the plain version has none, or none "
                             "where it has")
    check_equal(name, got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0), errs)
    return int(nan.sum())


def check_ccc_tf32(engine) -> None:
    """CCC's unfused contraction pins full fp32 products: with TF32 turned
    on for the whole process, the 2-way unfused campaign (n_v = 1,024) and
    the 3-way unfused slices (one product of the folded pipeline, n_v = 150)
    on integers up to 4,095 (TF32 keeps integers exact only to 2,048; n_f =
    4,000 keeps the generator's sums exact) give the same blocks as with
    TF32 off.  A plain fp32 matmul of the same data must change under TF32,
    or the case would not reach it.  The flags are restored."""
    import torch

    from repro_torch.api import SimilarityRequest
    from repro_torch.core.synthetic import random_integer_vectors

    Vt = random_integer_vectors(4_000, N_V_CHECKSUM, max_value=4_095, seed=SEED + 5)
    cases = [("2-way", dict(impl="xla"), Vt),
             ("3-way", dict(way=3, n_st=2, impl="xla"), Vt[:, :N_V3_CHECKSUM])]
    want = {label: engine.run(SimilarityRequest(metric="ccc", **knobs), W).outputs[0].blocks
            for label, knobs, W in cases}
    A = torch.as_tensor(Vt, device=engine.device)
    exact = A.t() @ A
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        if torch.equal(A.t() @ A, exact):
            raise AssertionError("TF32 left a plain fp32 matmul unchanged")
        for label, knobs, W in cases:
            got = engine.run(SimilarityRequest(metric="ccc", **knobs), W).outputs[0].blocks
            if not np.array_equal(got, want[label]):
                raise AssertionError(f"ccc {label} unfused: TF32 on changed the blocks")
            print(f"  ccc {label} unfused, TF32 on: {got.size} values equal TF32 off")
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]
    if (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) != saved:
        raise AssertionError("TF32 flags not restored")


#: A1 dosage (0, 1, 2; 255 = missing) -> PLINK 2-bit code, the inverse of
#: the ``.bed`` decode (codes 0b11, 0b10, 0b00; 0b01 for a missing call)
_PLINK_CODE = np.zeros(256, np.uint8)
_PLINK_CODE[[0, 1, 2, 255]] = [0b11, 0b10, 0b00, 0b01]


def write_plink(prefix: Path, G: np.ndarray, chunk: int = 8_192) -> int:
    """Write the PLINK 1 fileset ``prefix.{bed,bim,fam}`` of dosages G
    (n_snps, n_samples) uint8, SNP-major, ``chunk`` SNPs at a time; returns
    the ``.bed``'s size in bytes."""
    n_snps, n_samples = G.shape
    pad = (-n_samples) % 4
    with open(f"{prefix}.bed", "wb") as f:
        f.write(b"\x6c\x1b\x01")
        for s0 in range(0, n_snps, chunk):
            codes = _PLINK_CODE[G[s0:s0 + chunk]]
            if pad:  # pad bits of a SNP's last byte are zero
                codes = np.pad(codes, ((0, 0), (0, pad)))
            q = codes.reshape(codes.shape[0], -1, 4)
            f.write((q[..., 0] | q[..., 1] << 2 | q[..., 2] << 4
                     | q[..., 3] << 6).astype(np.uint8).tobytes())
    with open(f"{prefix}.bim", "w") as f:
        f.write("".join(f"1\trs{i}\t0\t{i + 1}\tA\tG\n" for i in range(n_snps)))
    with open(f"{prefix}.fam", "w") as f:
        f.write("".join(f"f{i} i{i} 0 0 0 -9\n" for i in range(n_samples)))
    return os.path.getsize(f"{prefix}.bed")


def host_dataset(V: np.ndarray, levels: int, n_shards: int) -> tuple:
    """``(checksum, stats, encode seconds, seconds)`` of the dataset that
    ``write_dataset`` must write for V: each field shard packed by the host
    encoder ``encode_bitplanes_np``, its popcounts by ``POPCOUNT``, the
    sha256 over the shard arrays in rank order."""
    from repro_torch.kernels.mgemm_levels.planes import POPCOUNT, encode_bitplanes_np

    t_all = time.perf_counter()
    n_f, n_v = V.shape
    kbs = -(-n_f // (8 * n_shards))
    h = hashlib.sha256()
    stats = np.zeros((levels, n_v), np.int64)
    t_enc = 0.0
    for r in range(n_shards):
        t0 = time.perf_counter()
        P = encode_bitplanes_np(V[8 * r * kbs:8 * (r + 1) * kbs], levels)
        t_enc += time.perf_counter() - t0
        P = np.pad(P, ((0, 0), (0, kbs - P.shape[1]), (0, 0)))
        stats += POPCOUNT[P].sum(axis=1, dtype=np.int64)
        h.update(np.ascontiguousarray(P))
    return "sha256:" + h.hexdigest(), stats, t_enc, time.perf_counter() - t_all


def ingest(root: Path, name: str, G: np.ndarray, *, n_shards: int = 1):
    """Write G (n_snps, n_samples) as a PLINK fileset, read it back with
    ``read_bed`` on the card, write its dataset on the card and validate it
    there; check the matrix against G and the CPU decode, and the manifest's
    checksum and stats against the host encoder and the CPU recount.
    Returns ``(V, dataset path)``."""
    from repro_torch.store import DatasetReader, read_bed, write_dataset

    size = write_plink(root / name, G)
    t0 = time.perf_counter()
    V, info = read_bed(str(root / name))
    t_read = time.perf_counter() - t0
    if V.shape != G.shape[::-1] or not np.array_equal(V, G.T):
        raise AssertionError(f"{name}: read_bed != the dosages written")
    t0 = time.perf_counter()
    V_cpu, info_cpu = read_bed(str(root / name), device="cpu")
    t_read_cpu = time.perf_counter() - t0
    if not np.array_equal(V_cpu, V) or info_cpu != info:
        raise AssertionError(f"{name}: read_bed on the card != on the CPU")
    del V_cpu
    path = str(root / f"{name}_ds")
    t0 = time.perf_counter()
    manifest = write_dataset(path, V, levels=2, n_shards=n_shards, source=info)
    t_write = time.perf_counter() - t0
    reader = DatasetReader(path)
    t0 = time.perf_counter()
    reader.validate()
    t_val = time.perf_counter() - t0
    t0 = time.perf_counter()
    reader.validate(device="cpu")
    t_val_cpu = time.perf_counter() - t0
    checksum, stats, t_enc, t_host = host_dataset(V, 2, n_shards)
    if manifest["checksum"] != checksum:
        raise AssertionError(f"{name}: card encode's checksum != host encoder's")
    if not np.array_equal(reader.stats(), stats):
        raise AssertionError(f"{name}: card popcounts != host POPCOUNT's")
    print(f"  ingest {G.shape[0]} SNPs x {G.shape[1]} samples ({size} B .bed, "
          f"{n_shards} shard(s)): read_bed on the card {t_read:.3f} s (on the "
          f"CPU {t_read_cpu:.3f} s); write_dataset on the card {t_write:.3f} s; "
          f"validate on the card {t_val:.3f} s (on the CPU {t_val_cpu:.3f} s); "
          f"host encoder encode_bitplanes_np {t_enc:.3f} s ({t_host:.3f} s with "
          f"POPCOUNT and sha256); checksum and stats equal the host encoder's",
          flush=True)
    return V, path


def check_store(engine, V2, V1, wrappers: dict) -> dict:
    """The dataset store on the card: PLINK ingest, campaigns from disk, and
    the CLIs as a user runs them.  ``wrappers`` maps kernel names to the
    wrappers whose launches the plane campaigns must show; returns the
    launches of the planes-input campaigns by kernel name."""
    import repro_torch.kernels.mgemm_levels.planes as planes_mod
    from repro_torch.api import InputSpec, SimilarityRequest
    from repro_torch.store import DatasetReader, read_bed, write_dataset

    root = ROOT / "build" / "store_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        # -- ingest ---------------------------------------------------------
        G2 = np.ascontiguousarray(V2.T, dtype=np.uint8)  # (SNPs, samples)
        _, ds2 = ingest(root, "v2", G2)
        # 0.1% missing calls: 200 samples (1%) in each of 10% of the SNPs
        rng = np.random.default_rng(SEED + 7)
        Gm = G2.copy()
        hit = rng.choice(G2.shape[0], G2.shape[0] // 10, replace=False)
        for snp in hit:
            Gm[snp, rng.choice(G2.shape[1], 200, replace=False)] = 255
        write_plink(root / "missing", Gm)
        n_missing = int((Gm == 255).sum())
        try:
            read_bed(str(root / "missing"))
        except ValueError as e:
            if f"{n_missing} missing genotype(s)" not in str(e):
                raise
        else:
            raise AssertionError("missing calls under 'error' did not raise")
        Vz, _ = read_bed(str(root / "missing"), missing="zero")
        if not np.array_equal(Vz, np.where(Gm == 255, 0, Gm).T):
            raise AssertionError("missing='zero' != the dosages with 0 for missing")
        Vd, info = read_bed(str(root / "missing"), missing="drop")
        keep = np.ones(G2.shape[0], bool)
        keep[hit] = False
        if not np.array_equal(Vd, G2[keep].T) or info["dropped_snps"] != len(hit):
            raise AssertionError("missing='drop' != the SNPs without missing calls")
        print(f"  {n_missing} missing calls ({n_missing / Gm.size:.2%}) in "
              f"{len(hit)} SNPs: 'error' raises, 'zero' and 'drop' "
              f"({Vd.shape[1]} SNPs kept) give the expected matrices")
        del Gm, Vz, Vd
        G65 = np.random.default_rng(SEED + 8).integers(
            0, 3, (STORE_SNPS, G2.shape[1]), dtype=np.uint8)
        ingest(root, "chunk", G65, n_shards=STORE_SHARDS)
        del G65

        # -- campaigns from disk -------------------------------------------
        n3 = N_V3_SIDE
        ds = {"v2": ds2}
        for key, V, levels, n_shards in (("v1", V1, 1, 1),
                                         ("v2x4", V2, 2, STORE_SHARDS),
                                         ("v2_3", V2[:, :n3], 2, 1),
                                         ("v1_3", V1[:, :n3], 1, 1)):
            ds[key] = str(root / f"{key}_ds")
            write_dataset(ds[key], V, levels=levels, n_shards=n_shards)
        stage = dict(way=3, n_st=N_ST3, stages=(0,))
        runs = [
            # (label, dataset, request knobs, value input, launches a run)
            ("czek levels=2", "v2", dict(impl="levels", levels=2), V2,
             {"metric2_levels_tri": 1}),
            ("sorenson levels=1", "v1", dict(metric="sorenson", impl="levels",
                                             levels=1), V1, {"metric2_pop_tri": 1}),
            (f"czek levels=2 {STORE_SHARDS} shards, streaming=off", "v2x4",
             dict(impl="levels", levels=2, streaming="off"), V2,
             {"metric2_levels_tri": 1}),
            ("3-way czek levels=2", "v2_3", dict(impl="levels", levels=2, **stage),
             V2[:, :n3], {"threeway_batch_levels": 6, "metric2_levels": 18}),
            ("3-way sorenson levels=1", "v1_3", dict(metric="sorenson", impl="levels",
                                                     levels=1, **stage),
             V1[:, :n3], {"threeway_batch_pop": 6, "metric2_pop": 18}),
        ]
        encodes = [0]
        host_encoder = planes_mod.encode_bitplanes_np

        def counted(*args, **kwargs):
            encodes[0] += 1
            return host_encoder(*args, **kwargs)

        def layers(res):
            return ", ".join(f"{layer} {sec:.3f}"
                             for layer, sec in res.meta["layer_seconds"].items())

        store_launches = {name: 0 for name in wrappers}
        planes_mod.encode_bitplanes_np = counted
        try:
            for label, key, knobs, V, want in runs:
                encodes[0] = 0
                ref = engine.run(SimilarityRequest(**knobs), V)
                if encodes[0] < 1:
                    raise AssertionError(f"{label}: the value input's host encode "
                                         "was not counted")
                encodes[0] = 0
                for wrapper in wrappers.values():
                    wrapper.launches = 0
                res = engine.run(SimilarityRequest(
                    **knobs, input=InputSpec(source="planes", path=ds[key])))
                ran = {name: w.launches for name, w in wrappers.items()}
                expect = {name: want.get(name, 0) for name in wrappers}
                if ran != expect:
                    raise AssertionError(f"{label}: launches {ran}, expected {expect}")
                if encodes[0]:
                    raise AssertionError(f"{label}: the planes input ran the host "
                                         f"encoder {encodes[0]} time(s)")
                if not np.array_equal(res.outputs[0].blocks, ref.outputs[0].blocks):
                    raise AssertionError(f"{label}: planes-input blocks != value input's")
                if res.meta["dataset"]["checksum"] != \
                        DatasetReader(ds[key]).manifest["checksum"]:
                    raise AssertionError(f"{label}: meta['dataset'] is not the dataset's")
                for name, n in ran.items():
                    store_launches[name] += n
                print(f"  {label}: planes input {res.meta['obs']['seconds']:.3f} s, "
                      f"layers (s): {layers(res)}; value input "
                      f"{ref.meta['obs']['seconds']:.3f} s, layers (s): {layers(ref)}; "
                      f"blocks equal, 0 host encodes, launches "
                      f"{ {n: c for n, c in ran.items() if c} }", flush=True)
                del ref, res
            # a batched campaign with a named subset from the dataset: the
            # union gathered from the planes, one raw diagonal plane kernel
            batch = dict(metric="czekanowski", metrics=("sorenson", "ccc"),
                         impl="levels", levels=2,
                         subsets=(("cohort", tuple(range(2999, -1, -1))),))
            ref = engine.run(SimilarityRequest(**batch), V2)
            encodes[0] = 0
            for wrapper in wrappers.values():
                wrapper.launches = 0
            res = engine.run(SimilarityRequest(
                **batch, input=InputSpec(source="planes", path=ds["v2"])))
            ran = {name: w.launches for name, w in wrappers.items()}
            expect = {name: int(name == "metric2_levels_tri") for name in wrappers}
            if ran != expect or encodes[0]:
                raise AssertionError(f"batched from a dataset: launches {ran}, "
                                     f"{encodes[0]} host encode(s)")
            for (metric, sname, got), (_, _, want) in zip(res, ref, strict=True):
                if not np.array_equal(got.outputs[0].blocks, want.outputs[0].blocks):
                    raise AssertionError(f"batched from a dataset: {metric} {sname} "
                                         "!= the value input's")
            for name, n in ran.items():
                store_launches[name] += n
            print(f"  batch czekanowski + sorenson + ccc, subset cohort (3,000): "
                  f"planes input {res.meta['obs']['seconds']:.3f} s, layers (s): "
                  f"{layers(res)}; value input {ref.meta['obs']['seconds']:.3f} s, "
                  f"layers (s): {layers(ref)}; blocks equal, 0 host encodes, launches "
                  f"{ {n: c for n, c in ran.items() if c} }", flush=True)
            del ref, res
        finally:
            planes_mod.encode_bitplanes_np = host_encoder

        # -- the CLIs as a user runs them ----------------------------------
        W = V2[:, :N_V_CHECKSUM]
        write_plink(root / "cli", np.ascontiguousarray(W.T, dtype=np.uint8))
        cli_ds = str(root / "cli_ds")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        [encoded] = run_clis([("repro_torch.launch.dataset", "encode", "--bed",
                               root / "cli", "--out", cli_ds)], env)
        # the four readers of the encoded dataset, at once
        _, checked, dry, ran = run_clis([
            ("repro_torch.launch.dataset", "inspect", cli_ds),
            ("repro_torch.launch.dataset", "validate", cli_ds),
            ("repro_torch.launch.similarity", "--dataset", cli_ds, "--way", "2", "--dry-run"),
            ("repro_torch.launch.similarity", "--dataset", cli_ds, "--way", "2")], env)
        want = host_dataset(W, 2, 1)[0]
        if encoded[-1] != f"checksum={want}" or checked[-1] != \
                f"{cli_ds}: OK (1 shard(s), {want})":
            raise AssertionError("dataset CLI: checksum != the host encoder's")
        if dry[0] != "path=fused-levels":
            raise AssertionError(f"similarity --dry-run: {dry[0]!r}")
        checksum = engine.run(SimilarityRequest(impl="levels", levels=2), W).checksum()
        if ran[-1] != f"checksum={hex(checksum)}":
            raise AssertionError(f"similarity CLI {ran[-1]!r} != in-process "
                                 f"checksum={hex(checksum)}")
        print(f"  CLI checksum equals the in-process value-input campaign's "
              f"({hex(checksum)})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return store_launches


def check_stream(engine, V2, V1, wrappers) -> tuple:
    """Streamed and delta campaigns on the card (phase ``stream``): each
    result ``np.array_equal`` to its in-memory or full-recompute
    counterpart, with launch counts zeroed before each run and read after
    it, and the host encoder wrapped with a counter that must stay at 0.
    ``wrappers`` maps kernel names to their wrappers; returns the launches
    of the streamed and delta runs by kernel name, and the prior of (f),
    the 8,192-vector campaign with its checksum taken (phase ``obs_serve``
    reuses it)."""
    import repro_torch.kernels.mgemm_levels.planes as planes_mod
    from repro_torch.api import InputSpec, SimilarityRequest
    from repro_torch.core.synthetic import random_integer_vectors
    from repro_torch.store import DatasetReader, append_dataset, write_dataset
    from repro_torch.stream import StreamPlan

    root = ROOT / "build" / "stream_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    total = {name: 0 for name in wrappers}
    encodes = [0]
    host_encoder = planes_mod.encode_bitplanes_np

    def counted(*args, **kwargs):
        encodes[0] += 1
        return host_encoder(*args, **kwargs)

    def planes(path):
        return InputSpec(source="planes", path=str(path))

    def layers(res):
        return ", ".join(f"{layer} {sec:.3f}"
                         for layer, sec in res.meta["layer_seconds"].items())

    def run(label, fn, want):
        """``fn()`` with the counts zeroed before and read after: exactly
        ``want`` launches by kernel name, no host encode."""
        for wrapper in wrappers.values():
            wrapper.launches = 0
        encodes[0] = 0
        planes_mod.encode_bitplanes_np = counted
        try:
            res = fn()
        finally:
            planes_mod.encode_bitplanes_np = host_encoder
        ran = {name: w.launches for name, w in wrappers.items()}
        expect = {name: want.get(name, 0) for name in wrappers}
        if ran != expect:
            raise AssertionError(f"{label}: launches {ran}, expected {expect}")
        if encodes[0]:
            raise AssertionError(f"{label}: the host encoder ran {encodes[0]} time(s)")
        for name, n in ran.items():
            total[name] += n
        return res

    def report(label, res, ref, ref_label="in memory"):
        print(f"  {label}: {res.meta['obs']['seconds']:.3f} s, layers (s): "
              f"{layers(res)}; {ref_label} {ref.meta['obs']['seconds']:.3f} s, "
              f"layers (s): {layers(ref)}; equal", flush=True)
        for key in ("stream", "delta"):
            if key in res.meta:
                print(f"    meta[{key!r}] {json.dumps(res.meta[key])}")

    def same(label, got, want):
        for a, b in zip(got.outputs, want.outputs, strict=True):
            if not np.array_equal(a.blocks, b.blocks):
                raise AssertionError(f"{label}: blocks differ")

    def chunks_of(path, n_v, budget=0):
        """The plan's chunks, checked against the budget arithmetic: two
        buffers of levels x chunk_kb x n_v bytes within the budget."""
        reader = DatasetReader(str(path))
        plan = StreamPlan.for_reader(reader, n_v=n_v, max_host_bytes=budget)
        kbs = reader.kb // reader.n_shards
        want_kb = min(budget // (2 * reader.levels * n_v), reader.kb) if budget \
            else kbs
        if plan.chunk_kb != want_kb or plan.n_chunks != -(-reader.kb // want_kb):
            raise AssertionError(f"{path}: plan {plan}")
        if budget and (plan.peak_host_bytes > budget or plan.n_chunks < 2 or not any(
                len(c.spans) > 1 for c in plan.chunks())):
            raise AssertionError(f"{path}: budgeted chunks do not cross the shards")
        return plan.n_chunks

    czek = dict(impl="levels", levels=2)
    sor = dict(metric="sorenson", impl="levels", levels=1)
    try:
        # -- (a), (b): 2-way under streaming="auto" and a budget -----------
        ds = {}
        for key, V, levels in (("v2x4", V2, 2), ("v1x4", V1, 1),
                               ("v2x4_3", V2[:, :N_V3_SIDE], 2),
                               ("v1x4_3", V1[:, :N_V3_SIDE], 1)):
            ds[key] = root / key
            write_dataset(str(ds[key]), V, levels=levels, n_shards=STORE_SHARDS)
        refs = {}
        for label, key, knobs, kname, budget in (
                ("(a) czekanowski levels=2, auto", "v2x4", czek, "metric2_levels_tri", 0),
                ("(a) czekanowski levels=2, budget", "v2x4", czek, "metric2_levels_tri",
                 STREAM_BUDGET),
                ("(b) sorenson levels=1, auto", "v1x4", sor, "metric2_pop_tri", 0)):
            if key not in refs:
                refs[key] = engine.run(SimilarityRequest(**knobs, streaming="off",
                                                         input=planes(ds[key])))
            n = chunks_of(ds[key], N_V, budget)
            res = run(label, lambda: engine.run(SimilarityRequest(
                **knobs, max_host_bytes=budget, input=planes(ds[key]))), {kname: n})
            if res.meta["stream"]["chunks"] != n or \
                    res.meta["stream"]["peak_host_bytes"] > (budget or 1 << 62):
                raise AssertionError(f"{label}: meta['stream'] {res.meta['stream']}")
            same(label, res, refs[key])
            report(label, res, refs[key])
            del res
        prior = refs.pop("v2x4")  # the 8,192-vector campaign, prior of (f)
        refs.clear()

        # -- (c) biobank length, 8 shards, a 32 MiB budget -----------------
        Vb = np.random.default_rng(SEED + 9).integers(
            0, 3, (BIOBANK_N_F, BIOBANK_N_V), dtype=np.int8)
        t0 = time.perf_counter()
        write_dataset(str(root / "biobank"), Vb, levels=2, n_shards=BIOBANK_SHARDS)
        t_write = time.perf_counter() - t0
        del Vb
        reader = DatasetReader(str(root / "biobank"))
        print(f"  (c) {BIOBANK_N_F} x {BIOBANK_N_V} int8 ({BIOBANK_N_F * BIOBANK_N_V} "
              f"B) written as {BIOBANK_SHARDS} shards on the card in {t_write:.3f} s: "
              f"kb {reader.kb}, kbs {reader.kb // reader.n_shards}, planes "
              f"{reader.levels * reader.kb * reader.n_v} B")
        ref = engine.run(SimilarityRequest(**czek, streaming="off",
                                           input=planes(root / "biobank")))
        n = chunks_of(root / "biobank", BIOBANK_N_V, BIOBANK_BUDGET)
        res = run("(c)", lambda: engine.run(SimilarityRequest(
            **czek, max_host_bytes=BIOBANK_BUDGET, input=planes(root / "biobank"))),
            {"metric2_levels_tri": n})
        same("(c)", res, ref)
        report(f"(c) biobank length, budget {BIOBANK_BUDGET}", res, ref)
        del res, ref
        shutil.rmtree(root / "biobank")

        # -- (d) one streamed 3-way stage ----------------------------------
        stage = dict(way=3, n_st=N_ST3, stages=(0,))
        for label, key, knobs, slice_k, pair_k in (
                ("(d) 3-way czekanowski levels=2", "v2x4_3", czek,
                 "threeway_batch_levels", "metric2_levels"),
                ("(d) 3-way sorenson levels=1", "v1x4_3", sor,
                 "threeway_batch_pop", "metric2_pop")):
            ref = engine.run(SimilarityRequest(**knobs, **stage, streaming="off",
                                               input=planes(ds[key])))
            n = chunks_of(ds[key], N_V3_SIDE)
            res = run(label, lambda: engine.run(SimilarityRequest(
                **knobs, **stage, input=planes(ds[key]))),
                {slice_k: 6 * n, pair_k: 18 * n})
            same(label, res, ref)
            report(label, res, ref)
            del res, ref

        # -- (e) streamed batches ------------------------------------------
        batch2 = dict(metric="czekanowski", metrics=("sorenson", "ccc"), **czek,
                      subsets=(("cohort", tuple(range(STREAM_COHORT - 1, -1, -1))),))
        batch3 = dict(metric="czekanowski", metrics=("sorenson",), **czek, **stage)
        for label, key, knobs, n_v, want in (
                ("(e) batch czekanowski + sorenson + ccc, subset cohort", "v2x4",
                 batch2, N_V, lambda n: {"metric2_levels_tri": n}),
                ("(e) 3-way batch czekanowski + sorenson", "v2x4_3", batch3, N_V3_SIDE,
                 lambda n: {"threeway_batch_levels": 6 * n, "metric2_levels": 18 * n})):
            ref = engine.run(SimilarityRequest(**knobs, streaming="off",
                                               input=planes(ds[key])))
            n = chunks_of(ds[key], n_v)
            res = run(label, lambda: engine.run(SimilarityRequest(
                **knobs, input=planes(ds[key]))), want(n))
            for (metric, sname, got), (_, _, exp) in zip(res, ref, strict=True):
                same(f"{label}: {metric} {sname}", got, exp)
            report(label, res, ref)
            print(f"    meta['batch'] {json.dumps(res.meta['batch'])}")
            del res, ref

        # -- (f) delta: 512 vectors appended to the 8,192 ------------------
        shutil.copytree(ds["v2x4"], root / "grown")
        Vn = random_integer_vectors(N_F, DELTA_NEW, max_value=2, seed=SEED + 10)
        t0 = time.perf_counter()
        append_dataset(str(root / "grown"), Vn)
        print(f"  (f) append_dataset of {DELTA_NEW} vectors on the card: "
              f"{time.perf_counter() - t0:.3f} s")
        full = engine.run(SimilarityRequest(**czek, streaming="off",
                                            input=planes(root / "grown")))
        want = full.outputs[0].pack().blocks
        # meta["delta"] records the prior's checksum, taken on the host over
        # its entries: taken once here, cached on the prior after
        t0 = time.perf_counter()
        prior.checksum()
        print(f"  (f) the prior's checksum ({prior.num_results()} entries, on the "
              f"host): {time.perf_counter() - t0:.3f} s")
        n = chunks_of(root / "grown", N_V + DELTA_NEW, STREAM_BUDGET)
        for label, knobs, launches in (
                ("(f) delta, streaming=off", dict(streaming="off"),
                 {"metric2_levels": 1, "metric2_levels_tri": 1}),
                ("(f) delta, streaming=on, budget", dict(
                    streaming="on", max_host_bytes=STREAM_BUDGET),
                 {"metric2_levels": n, "metric2_levels_tri": n})):
            res = run(label, lambda: engine.run_delta(SimilarityRequest(
                **czek, **knobs, input=planes(root / "grown")), prior), launches)
            if not np.array_equal(res.outputs[0].blocks, want):
                raise AssertionError(f"{label}: merged values != the full recompute's")
            report(label, res, full, "full recompute")
            del res
        del full, want
        # impl="pallas" on the value matrices: row 2 on the (8,192, 512)
        # rectangle, row 3 on the 512 triangle; the prior is the same
        # Czekanowski campaign on V2's columns
        Vg = np.concatenate([V2, Vn], axis=1)
        full = engine.run(SimilarityRequest(impl="pallas"), Vg)
        res = run("(f) pallas", lambda: engine.run_delta(
            SimilarityRequest(impl="pallas"), prior, Vg),
            {"metric2_tiles": 1, "metric2_tri": 1})
        if not np.array_equal(res.outputs[0].blocks, full.outputs[0].pack().blocks):
            raise AssertionError("(f) pallas: merged values != the full recompute's")
        report("(f) delta, impl=pallas, values", res, full, "full recompute")
        del res, full, Vg, Vn

        # -- (g) the CLIs as a user runs them ------------------------------
        W = V2[:, :N_V_CHECKSUM]
        write_dataset(str(root / "cli4"), W, levels=2, n_shards=STORE_SHARDS)
        write_dataset(str(root / "cli"), W, levels=2)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        # the streamed run (cli4) and the prior's (cli) at once; then the
        # append to cli and the delta from the prior, in turn
        streamed, _ = run_clis([
            ("repro_torch.launch.similarity", "--dataset", root / "cli4", "--streaming",
             "on", "--max-host-bytes", CLI_BUDGET),
            ("repro_torch.launch.similarity", "--dataset", root / "cli", "--out",
             root / "prior")], env)
        want = engine.run(SimilarityRequest(**czek), W).checksum()
        if streamed[-1] != f"checksum={hex(want)}" or not any(
                line.startswith("streamed chunks=") for line in streamed):
            raise AssertionError(f"similarity --streaming on: {streamed[-2:]} != "
                                 f"checksum={hex(want)}")
        run_clis([("repro_torch.launch.dataset", "append", "--to", root / "cli",
                   "--synthetic", "--n-v", CLI_NEW, "--seed", "1")], env)
        [delta] = run_clis([("repro_torch.launch.similarity", "--dataset", root / "cli",
                             "--delta-from", root / "prior")], env)
        want = engine.run(SimilarityRequest(**czek, input=planes(root / "cli"))
                          ).checksum()
        if delta[-1] != f"checksum={hex(want)}" or not any(
                line.startswith(f"delta n_old={N_V_CHECKSUM} n_new={CLI_NEW} ")
                for line in delta):
            raise AssertionError(f"similarity --delta-from: {delta[-2:]} != "
                                 f"checksum={hex(want)}")
        print(f"  CLI checksums equal the in-process full recomputes' "
              f"({hex(want)} after the append)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total, prior


def check_decomp(V2, V1, refs2, walls2, prior, wrappers, device="cuda:0") -> dict:
    """2-way decompositions on one card (phase ``decomp``): every rank of a
    decomposition on ``cuda:0`` (``SimilarityEngine(devices=["cuda:0"] *
    8)``), each result held bitwise to its (1, 1, 1) run on this card and
    these data (``refs2``, the campaigns phase's blocks at n_v = N_V, which
    its fused runs equal; a (1, 1, 1) run made here otherwise), through
    ``dense()`` read as uint32 bits, with ``num_pairs()`` and exact launch
    counts (zeroed before each run, read after it).  The levels campaigns
    read V2 / V1 from 1-shard datasets written here, which skips resolve
    and the host encode, and their (1, 1, 1) runs from the same datasets
    give the walls printed beside; ``walls2`` are those of the ``pallas``
    runs.  ``prior`` is phase stream's 8,192-vector campaign (checksum
    taken) for the delta.  Returns the launches by kernel name."""
    from dataclasses import replace

    from repro_torch.api import InputSpec, SimilarityEngine, SimilarityRequest
    from repro_torch.core.synthetic import random_integer_vectors
    from repro_torch.core.tile_executor import TileExecutor
    from repro_torch.core.twoway import TwoWayOutput
    from repro_torch.core.plan2 import TwoWayPlan
    from repro_torch.api import get_metric
    from repro_torch.store import DatasetReader, append_dataset, write_dataset
    from repro_torch.stream import StreamPlan

    root = ROOT / "build" / "decomp_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    engine = SimilarityEngine(devices=[device] * 8)
    total = {name: 0 for name in wrappers}
    dense_refs = {}

    def ref_bits(key, blocks):
        if key not in dense_refs:
            n_v = blocks.shape[-1]
            dense_refs[key] = TwoWayOutput(blocks=blocks, plan=TwoWayPlan(1, 1),
                                           n_v=n_v, n_vp=n_v)
        return dense_refs[key]

    def plane_rows(levels):  # rows 6 / 5, or 8 / 7 on binary planes
        return ("metric2_pop_tri", "metric2_pop") if levels == 1 else \
            ("metric2_levels_tri", "metric2_levels")

    def blocks_of(decomp):
        """(diagonal, off-diagonal) blocks a campaign computes: n_pv and
        the ring's other blocks, each once over n_pf ranks."""
        n_pf, n_pv, n_pr = decomp
        plan = TwoWayPlan(n_pv, n_pr)
        cells = [(pv, d) for d in range(plan.n_steps) for pv in range(n_pv)
                 if plan.rank_computes(pv, d % n_pr, d)]
        diag = sum(1 for _pv, d in cells if d == 0)
        return n_pf * diag, n_pf * (len(cells) - diag)

    def want_of(knobs, decomp, metric):
        """Expected launches by kernel name of one decomposed campaign."""
        diag, off = blocks_of(decomp)
        impl = knobs.get("impl")
        if impl == "levels":
            tri, rect = plane_rows(knobs["levels"])
            return {tri: diag, rect: off}
        if impl == "pallas":
            if decomp[0] > 1:  # "unfused": row 1 on every block
                return {"mgemm": diag + off}
            return {"metric2_tri": diag, "metric2_tiles": off}
        return {}

    def run(label, fn, want):
        for w in wrappers.values():
            w.launches = 0
        res = fn()
        ran = {name: w.launches for name, w in wrappers.items()}
        expect = {name: want.get(name, 0) for name in wrappers}
        if ran != expect:
            raise AssertionError(f"{label}: launches {ran}, expected {expect}")
        for name, n in ran.items():
            total[name] += n
        return res

    seen = {}

    def same(label, res, ref):
        """``dense()`` bitwise and ``num_pairs()`` of a decomposed result
        against its (1, 1, 1) counterpart (whose reading is kept)."""
        if id(ref) not in seen:
            seen[id(ref)] = (ref, ref.dense().view(np.uint32), ref.num_pairs())
        _ref, bits, pairs = seen[id(ref)]
        got = res.outputs[0]
        if got.num_pairs() != pairs:
            raise AssertionError(f"{label}: {got.num_pairs()} pairs, expected {pairs}")
        if not np.array_equal(got.dense().view(np.uint32), bits):
            raise AssertionError(f"{label}: dense() bits differ from (1, 1, 1)")

    def report(label, path, res, ref_wall, ran):
        layers = ", ".join(f"{layer} {sec:.3f}"
                           for layer, sec in res.meta["layer_seconds"].items())
        print(f"  {label}: path={path} {res.meta['obs']['seconds']:.3f} s "
              f"(1,1,1) {ref_wall}; layers (s): {layers}; launches "
              f"{ {k: v for k, v in ran.items() if v} }; equal", flush=True)

    def planes(name):
        return InputSpec(source="planes", path=str(root / name))

    # the levels campaigns read the same data from 1-shard datasets, which
    # skips resolve and the host encode (3-10 s a campaign from values);
    # each decomposition is also held to its (1, 1, 1) run from the dataset
    write_dataset(str(root / "v2"), V2, levels=2)
    write_dataset(str(root / "v1"), V1, levels=1)
    campaigns = [  # (metric, input, knobs, refs2 key, walls2 key of (1, 1, 1))
        ("czekanowski", planes("v2"), dict(impl="levels", levels=2), "czekanowski",
         None, [(1, 4, 1), (2, 2, 1), (1, 3, 2), (2, 2, 2)]),
        ("sorenson", planes("v1"), dict(impl="levels", levels=1), "sorenson",
         None, [(1, 4, 1), (2, 2, 1)]),
        ("czekanowski", V2, dict(impl="pallas"), "czekanowski", "czek pallas",
         [(1, 4, 1), (2, 2, 1)]),
        ("ccc", V2, dict(impl="pallas"), "ccc", "ccc pallas", [(1, 4, 1)]),
    ]
    try:
        for metric, V, knobs, ref_key, wall_key, decomps in campaigns:
            ref = ref_bits(ref_key, refs2[ref_key])
            one_wall = walls2.get(wall_key)  # else its (1, 1, 1) run from here
            for decomp in ([] if wall_key else [(1, 1, 1)]) + decomps:
                req = SimilarityRequest(metric=metric, **knobs, n_pf=decomp[0],
                                        n_pv=decomp[1], n_pr=decomp[2])
                path = TileExecutor(cfg=req.to_comet_config(),
                                    metric=get_metric(metric)).path
                label = f"{metric} {knobs} {decomp}"
                if wall_key is None:
                    label += " from a dataset"
                    req = replace(req, input=V)
                want = want_of(knobs, decomp, metric)
                res = run(label, lambda: engine.run(req, None if wall_key is None
                                                    else V), want)
                if res.outputs[0].blocks.shape[:2] != decomp[1:]:
                    raise AssertionError(f"{label}: blocks {res.outputs[0].blocks.shape}")
                same(label, res, ref)
                report(label, path, res, "-" if one_wall is None else f"{one_wall:.3f} s",
                       want)
                if one_wall is None:
                    one_wall = res.meta["obs"]["seconds"]
                del res
        # impl="xla" at n_v = N_V_CHECKSUM: the unfused plain contraction
        W2 = V2[:, :N_V_CHECKSUM]
        one = engine.run(SimilarityRequest(), W2)
        for decomp in [(1, 2, 2), (2, 2, 1)]:
            req = SimilarityRequest(n_pf=decomp[0], n_pv=decomp[1], n_pr=decomp[2])
            res = run(f"xla {decomp}", lambda: engine.run(req, W2), {})
            same(f"xla {decomp}", res, one.outputs[0])
            report(f"czekanowski xla n_v={N_V_CHECKSUM} {decomp}", "unfused", res,
                   f"{one.meta['obs']['seconds']:.3f} s", {})
            del res
        del one
        # stream (a): the 4-shard dataset at (2, 2, 1), chunks split over pf
        write_dataset(str(root / "v2x4"), V2, levels=2, n_shards=STORE_SHARDS)
        splan = StreamPlan.for_reader(DatasetReader(str(root / "v2x4")), n_v=N_V,
                                      n_pf=2)
        decomp = (2, 2, 1)
        diag, off = blocks_of(decomp)
        req = SimilarityRequest(impl="levels", levels=2, n_pf=2, n_pv=2,
                                input=InputSpec(source="planes",
                                                path=str(root / "v2x4")))
        want = {"metric2_levels_tri": diag * splan.n_chunks,
                "metric2_levels": off * splan.n_chunks}
        res = run("stream (a) (2, 2, 1)", lambda: engine.run(req), want)
        same("stream (a) (2, 2, 1)", res, ref_bits("czekanowski", refs2["czekanowski"]))
        report(f"stream (a), {splan.n_chunks} chunks, (2, 2, 1)",
               "streamed-fused-levels", res, "in memory", want)
        print(f"    meta['stream'] {json.dumps(res.meta['stream'])}")
        del res
        # batch (a): Czekanowski + Sorenson + CCC, levels=2, at (2, 2, 1):
        # the min family's row 6 / 5 raw once a block, CCC through values
        req = SimilarityRequest(metric="czekanowski", metrics=("sorenson", "ccc"),
                                impl="levels", levels=2, n_pf=2, n_pv=2,
                                input=planes("v2"))
        want = {"metric2_levels_tri": diag, "metric2_levels": off}
        res = run("batch (a) (2, 2, 1)", lambda: engine.run(req), want)
        for metric, ref_key in (("czekanowski", "czekanowski"),
                                ("sorenson", "czekanowski"), ("ccc", "ccc")):
            same(f"batch (a) {metric}", res.get(metric),
                 ref_bits(ref_key, refs2[ref_key]))
        report("batch (a) czekanowski + sorenson + ccc from a dataset, (2, 2, 1)",
               "fused-levels", res, "-", want)
        print(f"    meta['batch'] {json.dumps(res.meta['batch'])}")
        del res
        # delta (f) in memory at (1, 2, 1), against its (1, 1, 1) delta
        shutil.copytree(root / "v2x4", root / "grown")
        append_dataset(str(root / "grown"),
                       random_integer_vectors(N_F, DELTA_NEW, max_value=2,
                                              seed=SEED + 10))
        grown = InputSpec(source="planes", path=str(root / "grown"))
        knobs = dict(impl="levels", levels=2, streaming="off", input=grown)
        one = run("delta (f) (1, 1, 1)", lambda: engine.run_delta(
            SimilarityRequest(**knobs), prior),
            {"metric2_levels": 1, "metric2_levels_tri": 1})
        res = run("delta (f) (1, 2, 1)", lambda: engine.run_delta(
            SimilarityRequest(**knobs, n_pv=2), prior),
            {"metric2_levels": 2, "metric2_levels_tri": 1})
        if not np.array_equal(res.outputs[0].blocks.view(np.uint32),
                              one.outputs[0].blocks.view(np.uint32)):
            raise AssertionError("delta (f) (1, 2, 1): merged bits != (1, 1, 1)'s")
        if res.num_results() != one.num_results():
            raise AssertionError("delta (f) (1, 2, 1): entries differ")
        report(f"delta (f) {DELTA_NEW} onto {N_V}, (1, 2, 1)", "fused-levels", res,
               f"{one.meta['obs']['seconds']:.3f} s", {"metric2_levels": 2,
                                                        "metric2_levels_tri": 1})
        print(f"    meta['delta'] {json.dumps(res.meta['delta'])}")
        del res, one
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def check_decomp3_shapes(Q2, Q1, Q3, kernels) -> None:
    """Rows 12 / 9 / 11 at the shapes a 3-way decomposition gives them
    (phase decomp3, n_st = 4): (1, 4, 1)'s 384-wide blocks, L = 16, and
    (1, 3, 2)'s ragged 528, L = 22, cut from campaigns3's full-width
    operands (``Q2`` / ``Q1`` planes, ``Q3`` int8 values).  Three distinct
    operands, as a volume item has them: left its own block, the pipe a
    strided view of a second block (a received buffer), right a third
    block, each a contiguous copy as the ring places it.  Each kernel is
    held to its plain version (errors into ``kernels[name]["errs"]``) and
    timed beside its bound."""
    import torch

    from repro_torch.api import CCC
    from repro_torch.kernels.czek3 import (
        minplus3_plain,
        plane3_plain,
        threeway_batch,
        threeway_batch_levels,
    )
    from repro_torch.kernels.mgemm_levels import slice_planes_vectors
    from repro_torch.kernels.popgemm import threeway_batch_pop, threeway_batch_pop_plain

    m3 = Q3.shape[1]
    for w3 in (m3 // 4, 528):
        L = w3 // (6 * N_ST3)
        offs = (0, (m3 - w3) // 2, m3 - w3)
        O2, J2, K2 = [Q2[:, :, o:o + w3].contiguous() for o in offs]
        O1, J1, K1 = [Q1[:, :, o:o + w3].contiguous() for o in offs]
        O3, J3, K3 = [Q3[:, o:o + w3].contiguous() for o in offs]
        j0 = 3 * L  # a pipeline slice inside the pipe's block
        for name, tag, kern, plain, args, ops, rate in (
                ("threeway_batch_levels", "", threeway_batch_levels, plane3_plain,
                 (O2, slice_planes_vectors(J2, j0, L), K2),
                 2 * L * w3 * w3 * 2 * 8 * Q2.shape[1], B1_OPS_PER_S),
                ("threeway_batch_pop", "", threeway_batch_pop, threeway_batch_pop_plain,
                 (O1, slice_planes_vectors(J1, j0, L), K1),
                 2 * L * w3 * w3 * 8 * Q1.shape[1], B1_OPS_PER_S),
                ("threeway_batch", " min", lambda *a: threeway_batch(
                    *a, combine=torch.minimum),
                 lambda *a: minplus3_plain(*a, combine=torch.minimum),
                 (O3, J3[:, j0:j0 + L], K3), 2 * N_F * L * w3 * w3, FP32_INSTR_PER_S),
                ("threeway_batch", " CCC int8", lambda *a: threeway_batch(
                    *a, combine=CCC.combine),
                 lambda *a: minplus3_plain(*a, combine=CCC.combine),
                 (O3, J3[:, j0:j0 + L], K3), 2 * N_F * L * w3 * w3, INT8_OPS_PER_S)):
            label = f"{name}{tag} at ({L}, {w3}, {w3}), three operands"
            ms, got = cuda_ms(lambda: kern(*args), repeats=5)
            plain_ms, want = cuda_ms(lambda: plain(*args), repeats=1)
            check_equal(label, got, want, kernels[name]["errs"])
            b_ms, b_by = bound_of(nbytes(*args), nbytes(got), ops, rate)
            print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}, {ops:.4g} ops at {rate:.4g}/s)", flush=True)
            del got, want
        del O2, J2, K2, O1, J1, K1, O3, J3, K3, args


def digest3(out, device) -> tuple:
    """``(triples, digest)`` of a ``ThreeWayOutput``, on the card, whatever
    its decomposition: every kept triple's sorted global indices (i < j <
    k) and value bits hashed into two sums modulo 2^31 - 1, so the order
    in which the blocks hold the triples does not enter.  The kept cells
    are ``ThreeWayOutput.entries()``'s (the plan's items, their masks and
    ``< n_v``); float32 values only."""
    import torch

    from repro_torch.core.plan3 import ItemKind

    if out.blocks.dtype != np.float32:
        raise AssertionError(f"digest3 reads float32 blocks, got {out.blocks.dtype}")
    M = 2**31 - 1
    plan, n, m = out.plan, out.n_v, out.n_vp
    L = out.blocks.shape[3]
    li = torch.arange(m, device=device)
    count, h1, h2 = 0, 0, 0
    for p_v in range(plan.n_pv):
        for p_r in range(plan.n_pr):
            for slot, it in enumerate(plan.items_of(p_v, p_r)):
                pipe_b, left_b, right_b = it.roles(*it.blocks(p_v, plan.n_pv))
                lo, _ = plan.sixth_bounds(m, it.slice_idx, out.stage)
                jg = lo + torch.arange(L, device=device)
                gi = (pipe_b * m + jg)[:, None, None]
                gj = (left_b * m + li)[None, :, None]
                gk = (right_b * m + li)[None, None, :]
                mask = (gi < n) & (gj < n) & (gk < n)
                if it.kind == ItemKind.DIAG:
                    mask = mask & (li[None, :, None] < jg[:, None, None]) & (
                        li[None, None, :] > jg[:, None, None])
                elif it.kind == ItemKind.FACE:
                    mask = mask & (li[None, None, :] > jg[:, None, None])
                mask = mask.expand(L, m, m)
                a = torch.minimum(torch.minimum(gi, gj), gk)
                c = torch.maximum(torch.maximum(gi, gj), gk)
                key = ((a * n + (gi + gj + gk - a - c)) * n + c).expand(L, m, m)[mask]
                del a, c
                bits = torch.from_numpy(out.blocks[p_v, p_r, slot]).to(device).view(
                    torch.int32).to(torch.int64)[mask] & 0xFFFFFFFF
                key = key % M
                count += key.numel()
                h1 += int(((key * 48271 + bits) % M).sum())
                h2 += int((key * 16807 % M * (bits % M + 1) % M).sum())
                del key, bits, mask
    return count, h1 % M, h2 % M


def check_decomp3(V2, V1, wrappers, device="cuda:0") -> dict:
    """3-way decompositions on one card (phase ``decomp3``): every rank of
    a decomposition on ``cuda:0`` (``SimilarityEngine(devices=["cuda:0"] *
    8)``), campaigns3's data and n_st = 4.  A stage's sixths subdivide each
    rank's block, so the triples of one stage depend on the block width:
    only the union of the n_st stages is the same at every decomposition,
    and every check here covers all four stages.

    At n_v = 384 (every stage of one request) each result is held bitwise
    to its (1, 1, 1) run through ``dense()`` read as uint32 bits and
    ``num_results()`` (C(384, 3)): Czekanowski levels=2 from a 1-shard
    dataset at (1, 4, 1), (2, 2, 1), (1, 3, 2) and (2, 2, 2); Sorenson
    levels=1 from a dataset at (1, 4, 1); Czekanowski ``pallas`` from
    values at (1, 4, 1); CCC ``pallas`` at (1, 2, 2) and (1, 4, 1), whose
    denominator sqrt((s_p * s_l) * s_r) rounds by the roles (pipe, left,
    right) a decomposition's blocks give a triple's vectors, as
    ``repro``'s does, so it is held within 2^-21 of (1, 1, 1) with the same
    cells nonzero; the levels=2 batch Czekanowski + Sorenson + CCC at (1,
    4, 1) (Sorenson's blocks are Czekanowski's on {0,1,2} data, CCC's the
    ``pallas`` run's at (1, 4, 1), bit for bit).  At n_v =
    N_V3_SIDE = 768 (one request a stage, ``stages=(s,)``) Czekanowski
    levels=2 from a 1-shard dataset at (1, 4, 1), (2, 2, 1) and (1, 3, 2)
    (the ragged block, 264, L = 11), ``pallas`` from values at (1, 4, 1)
    and the stages streamed from a 4-shard dataset at (2, 2, 1) are held to
    the (1, 1, 1) stages from the dataset through ``num_triples()`` summed
    over the stages (C(768, 3)) and ``digest3`` summed over them; one
    stage-0 request to ``SimilarityService(devices=["cuda:0"] * 4)`` at
    (1, 4, 1) equals the engine's blocks.  Every run launches exactly,
    per stage, pf rank and item of every slab, one slice and the three
    pair terms its family needs (a chunk when streamed; counts zeroed
    before each run, read after it).  Returns the launches by kernel
    name."""
    from math import comb

    from repro_torch.api import InputSpec, SimilarityEngine, SimilarityRequest
    from repro_torch.core.plan3 import ThreeWayPlan
    from repro_torch.serve import SimilarityService
    from repro_torch.store import DatasetReader, write_dataset
    from repro_torch.stream import StreamPlan

    root = ROOT / "build" / "decomp3_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    engine = SimilarityEngine(devices=[device] * 8)
    total = {name: 0 for name in wrappers}
    plane2 = ("threeway_batch_levels", "metric2_levels")
    plane1 = ("threeway_batch_pop", "metric2_pop")

    def planes(name):
        return InputSpec(source="planes", path=str(root / name))

    def want_of(kernels, decomp, chunks=1, stages=1):
        """One slice a pf rank and item of every slab, and three pair terms
        where the family needs them, a stage (and a chunk when streamed)."""
        n_pf, n_pv, n_pr = decomp
        items = stages * chunks * n_pf * n_pv * ThreeWayPlan(n_pv, n_pr).items_per_slab
        slice_k, pair_k = kernels
        return {slice_k: items, **({pair_k: 3 * items} if pair_k else {})}

    def run(label, fn, want):
        for w in wrappers.values():
            w.launches = 0
        res = fn()
        ran = {name: w.launches for name, w in wrappers.items()}
        expect = {name: want.get(name, 0) for name in wrappers}
        if ran != expect:
            raise AssertionError(f"{label}: launches {ran}, expected {expect}")
        for name, n in ran.items():
            total[name] += n
        return res

    def report(label, wall, layers, ref_wall, want, check):
        layers = ", ".join(f"{layer} {sec:.3f}" for layer, sec in layers.items())
        print(f"  {label}: {wall:.3f} s (1,1,1) {ref_wall}; layers (s): {layers}; "
              f"launches { {k: v for k, v in want.items() if v} }; {check}", flush=True)

    def request(knobs, decomp, **stages):
        return SimilarityRequest(way=3, n_st=N_ST3, **stages, **knobs, n_pf=decomp[0],
                                 n_pv=decomp[1], n_pr=decomp[2])

    small = N_V3 // 4
    refs = {}

    def same_small(label, res, key, rtol=0.0):
        """``num_results()`` and ``dense()`` equal to ``refs[key]``'s: bit
        for bit, or, with ``rtol``, the same cells nonzero and the values
        within ``rtol``; returns the count of values whose bits differ."""
        bits, triples, _ = refs[key]
        if res.num_results() != triples:
            raise AssertionError(f"{label}: {res.num_results()} triples, expected {triples}")
        got = res.dense().view(np.uint32)
        differ = int((got != bits).sum())
        if differ and not rtol:
            raise AssertionError(f"{label}: dense() bits differ from {key}'s")
        a, b = got.view(np.float32), bits.view(np.float32)
        if not (np.array_equal(a != 0, b != 0) and np.allclose(a, b, rtol=rtol, atol=0)):
            raise AssertionError(f"{label}: dense() beyond rtol {rtol} of {key}'s")
        return differ

    try:
        write_dataset(str(root / "v2s"), V2[:, :small], levels=2)
        write_dataset(str(root / "v1s"), V1[:, :small], levels=1)
        write_dataset(str(root / "v2"), V2[:, :N_V3_SIDE], levels=2)
        write_dataset(str(root / "v2x4"), V2[:, :N_V3_SIDE], levels=2, n_shards=STORE_SHARDS)
        # -- n_v = 384, all stages: bitwise through dense() -----------------
        # CCC's denominator sqrt((s_p * s_l) * s_r) rounds by the roles
        # (pipe, left, right) its three vectors take, which the blocks of a
        # decomposition assign otherwise, as repro's do: bitwise only at one
        # decomposition, within a few ulps across them
        ccc_rtol = 2.0**-21
        campaigns = [  # (label, knobs, data, kernels, decompositions, rtol)
            ("czekanowski levels=2, 1-shard dataset",
             dict(impl="levels", levels=2, input=planes("v2s")), None, plane2,
             [(1, 4, 1), (2, 2, 1), (1, 3, 2), (2, 2, 2)], 0.0),
            ("sorenson levels=1, dataset",
             dict(metric="sorenson", impl="levels", levels=1, input=planes("v1s")),
             None, plane1, [(1, 4, 1)], 0.0),
            ("czekanowski pallas, values", dict(impl="pallas"), V2[:, :small],
             ("threeway_batch", "mgemm"), [(1, 4, 1)], 0.0),
            ("ccc pallas, values", dict(metric="ccc", impl="pallas"), V2[:, :small],
             ("threeway_batch", None), [(1, 2, 2), (1, 4, 1)], ccc_rtol),
        ]
        for label, knobs, V, kernels, decomps, rtol in campaigns:
            for decomp in [(1, 1, 1)] + decomps:
                tag = f"{label} n_v={small} {decomp}"
                want = want_of(kernels, decomp, stages=N_ST3)
                res = run(tag, lambda: engine.run(request(knobs, decomp), V), want)
                if res.outputs[0].blocks.shape[:2] != decomp[1:]:
                    raise AssertionError(f"{tag}: blocks {res.outputs[0].blocks.shape}")
                if decomp == (1, 1, 1):
                    if res.num_results() != comb(small, 3):
                        raise AssertionError(f"{tag}: {res.num_results()} triples")
                    refs[label] = (res.dense().view(np.uint32), res.num_results(),
                                   res.meta["obs"]["seconds"])
                    check = f"reference, {res.num_results()} triples"
                else:
                    differ = same_small(tag, res, label, rtol)
                    check = (f"dense() within rtol {rtol:.3g}, {differ} values' bits "
                             f"differ" if rtol else "dense() bits equal")
                if rtol and decomp == (1, 4, 1):  # the batch's CCC, bitwise
                    refs[f"{label} {decomp}"] = (res.dense().view(np.uint32),
                                                 res.num_results(), 0.0)
                report(tag, res.meta["obs"]["seconds"], res.meta["layer_seconds"],
                       f"{refs[label][2]:.3f} s", want, check)
                del res
        tag = f"batch czekanowski + sorenson + ccc levels=2, dataset, n_v={small} (1, 4, 1)"
        want = want_of(plane2, (1, 4, 1), stages=N_ST3)
        res = run(tag, lambda: engine.run(request(
            dict(metric="czekanowski", metrics=("sorenson", "ccc"), impl="levels",
                 levels=2, input=planes("v2s")), (1, 4, 1))), want)
        for metric, key in (("czekanowski", "czekanowski levels=2, 1-shard dataset"),
                            ("sorenson", "czekanowski levels=2, 1-shard dataset"),
                            ("ccc", "ccc pallas, values (1, 4, 1)")):
            same_small(f"{tag} {metric}", res.get(metric), key)
        report(tag, res.meta["obs"]["seconds"], res.meta["layer_seconds"], "-", want,
               "each campaign's dense() bits equal")
        print(f"    meta['batch'] {json.dumps(res.meta['batch'])}")
        del res
        refs.clear()

        # -- full width, one request a stage: num_triples() and digest3 ------
        def staged(label, make, want, keep=False):
            """Every stage of one campaign, a request each: the summed
            triples and digests, the walls and layers, stage 0's blocks
            when ``keep``."""
            count, h1, h2, wall, layers, kept = 0, 0, 0, 0.0, {}, None
            t_digest = 0.0
            for s in range(N_ST3):
                res = run(f"{label} stage {s}", lambda: make(s), want)
                out = res.outputs[0]
                t0 = time.perf_counter()
                n, d1, d2 = digest3(out, device)
                t_digest += time.perf_counter() - t0
                # num_results(): the stage's num_triples(), which the engine
                # counted for meta["obs"] and keeps
                if n != res.num_results():
                    raise AssertionError(f"{label} stage {s}: digest3 counts {n}, "
                                         f"num_triples() {res.num_results()}")
                count, h1, h2 = count + n, (h1 + d1) % (2**31 - 1), (h2 + d2) % (2**31 - 1)
                wall += res.meta["obs"]["seconds"]
                for layer, sec in res.meta["layer_seconds"].items():
                    layers[layer] = layers.get(layer, 0.0) + sec
                if keep and s == 0:
                    kept = out.blocks
                del res, out
            return (count, h1, h2), wall, layers, kept, t_digest

        knobs = dict(impl="levels", levels=2, input=planes("v2"))
        ref, ref_s, layers, _, t_d = staged(
            "full (1, 1, 1)", lambda s: engine.run(request(knobs, (1, 1, 1), stages=(s,))),
            want_of(plane2, (1, 1, 1)))
        if ref[0] != comb(N_V3_SIDE, 3):
            raise AssertionError(f"full (1, 1, 1): {ref[0]} triples")
        ref_wall = f"{ref_s:.3f} s"
        report(f"czekanowski levels=2, 1-shard dataset, n_v={N_V3_SIDE} (1, 1, 1), "
               f"{N_ST3} stages", ref_s, layers, ref_wall, want_of(plane2, (1, 1, 1)),
               f"{ref[0]} triples, digest {ref[1:]} ({t_d:.2f} s)")

        def same_full(label, make, want, keep=False):
            got, wall, layers, kept, t_d = staged(label, make, want, keep)
            if got != ref:
                raise AssertionError(f"{label}: triples and digest {got}, expected {ref}")
            report(f"{label}, {N_ST3} stages (launches a stage)", wall, layers, ref_wall, want,
                   f"num_triples() and digest equal ({t_d:.2f} s)")
            return kept

        kept = None
        for decomp in [(1, 4, 1), (2, 2, 1), (1, 3, 2)]:
            k = same_full(f"czekanowski levels=2, 1-shard dataset, n_v={N_V3_SIDE} {decomp}",
                          lambda s: engine.run(request(knobs, decomp, stages=(s,))),
                          want_of(plane2, decomp), keep=decomp == (1, 4, 1))
            kept = kept if k is None else k
        same_full(f"czekanowski pallas, values, n_v={N_V3_SIDE} (1, 4, 1)",
                  lambda s: engine.run(request(dict(impl="pallas"), (1, 4, 1),
                                               stages=(s,)), V2[:, :N_V3_SIDE]),
                  want_of(("threeway_batch", "mgemm"), (1, 4, 1)))
        decomp = (2, 2, 1)
        n_vp = -(-N_V3_SIDE // 2)
        n_vp += (-n_vp) % (6 * N_ST3)
        splan = StreamPlan.for_reader(DatasetReader(str(root / "v2x4")), n_v=2 * n_vp,
                                      n_pf=2)
        metas = []

        def streamed(s):
            res = engine.run(request(dict(impl="levels", levels=2, input=planes("v2x4")),
                                     decomp, stages=(s,)))
            metas.append(res.meta["stream"])
            return res

        same_full(f"stream, {splan.n_chunks} chunks from 4 shards, n_v={N_V3_SIDE} {decomp}",
                  streamed, want_of(plane2, decomp, chunks=splan.n_chunks))
        if any(m["chunks"] != splan.n_chunks for m in metas):
            raise AssertionError(f"stream: meta['stream'] {metas}")
        print(f"    meta['stream'] {json.dumps(metas[0])}")
        tag = f"SimilarityService(devices=[{device!r}] * 4), n_v={N_V3_SIDE} (1, 4, 1) stage 0"
        want = want_of(plane2, (1, 4, 1))
        with SimilarityService(devices=[device] * 4) as svc:
            res = run(tag, lambda: svc.submit(request(knobs, (1, 4, 1), stages=(0,))),
                      want)
        if not np.array_equal(res.outputs[0].blocks.view(np.uint32), kept.view(np.uint32)):
            raise AssertionError(f"{tag}: blocks differ from the engine's")
        report(tag, res.meta["obs"]["seconds"], res.meta["layer_seconds"], "-", want,
               "blocks equal the engine's (1, 4, 1) stage 0")
        del res, kept
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def check_obs_serve(engine, V2, prior, wrappers) -> dict:
    """Tracing and serving on the card (phase ``obs_serve``).

    (a) Four campaigns that earlier phases ran untraced, each run untraced
    and then traced here: the 2-way levels campaign from a 1-shard dataset
    (n_v = 8,192), one 3-way plane-ring stage from values (phase
    campaigns3's path at half its block, n_v = 768, n_st = 4, to keep the
    run within its limit), stream (a) and the in-memory delta (f)
    (``prior`` is the 8,192-vector campaign of phase ``stream``).  The
    traced blocks must equal the untraced, the phase counts the expected
    ones, ``0 < utilization <= 1`` (a bound over measured device time
    above 1 means a wrong count) and the Chrome trace must validate; each
    prints its phase table, ``obs`` line and both walls.  (b) ``SimilarityService(device=
    "cuda", workers=2)`` on the n_v = 1,024 (+128) datasets of phase
    stream's (g): one warmup, four concurrent submits (two duplicates),
    the appended dataset's request as one delta hit, every result's blocks
    equal to the in-process engine's (``np.array_equal``; the delta hit
    against the packed full recompute, as in stream's (f)), ``stats()`` as
    expected and consistent.  Counts are zeroed before each run and read
    after it, and must be exactly the expected launches; returns the
    launches by kernel name."""
    import threading

    from repro_torch.api import InputSpec, SimilarityRequest
    from repro_torch.core.synthetic import random_integer_vectors
    from repro_torch.obs import trace
    from repro_torch.serve import SimilarityService
    from repro_torch.store import append_dataset, write_dataset

    root = ROOT / "build" / "obs_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    total = {name: 0 for name in wrappers}

    def planes(path):
        return InputSpec(source="planes", path=str(path))

    def zero():
        for wrapper in wrappers.values():
            wrapper.launches = 0

    def read(label, want):
        """The counts since ``zero()``: exactly ``want`` launches by kernel
        name, none of any other kernel."""
        ran = {name: w.launches for name, w in wrappers.items()}
        expect = {name: want.get(name, 0) for name in wrappers}
        if ran != expect:
            raise AssertionError(f"{label}: launches {ran}, expected {expect}")
        for name, n in ran.items():
            total[name] += n

    def counted(label, fn, want):
        """``fn()`` with the counts zeroed before and read after."""
        zero()
        res = fn()
        read(label, want)
        return res

    czek = dict(impl="levels", levels=2)
    try:
        write_dataset(str(root / "v2"), V2, levels=2)
        write_dataset(str(root / "v2x4"), V2, levels=2, n_shards=STORE_SHARDS)
        shutil.copytree(root / "v2x4", root / "grown")
        append_dataset(str(root / "grown"), random_integer_vectors(
            N_F, DELTA_NEW, max_value=2, seed=SEED + 10))
        base = {"campaign": 1, "validate": 1}
        campaigns = [
            ("2-way levels=2 from a 1-shard dataset",
             lambda: engine.run(SimilarityRequest(**czek, input=planes(root / "v2"))),
             {**base, "ring-step": 1}, {"metric2_levels_tri": 1}),
            ("3-way plane ring, one stage",
             lambda: engine.run(SimilarityRequest(way=3, n_st=N_ST3, stages=(0,),
                                                  **czek), V2[:, :N_V3 // 2]),
             {**base, "encode": 1, "ring-step": 1},
             {"threeway_batch_levels": 6, "metric2_levels": 18}),
            ("stream (a), 4 shards, auto",
             lambda: engine.run(SimilarityRequest(**czek, input=planes(root / "v2x4"))),
             {**base, "ring-step": STORE_SHARDS, "prefetch-stage": STORE_SHARDS,
              "merge": 1}, {"metric2_levels_tri": STORE_SHARDS}),
            ("delta (f), streaming=off",
             lambda: engine.run_delta(SimilarityRequest(
                 **czek, streaming="off", input=planes(root / "grown")), prior),
             {**base, "delta-border": 1, "merge": 1},
             {"metric2_levels": 1, "metric2_levels_tri": 1}),
        ]
        for label, fn, phases, want in campaigns:
            t0 = time.perf_counter()
            plain = counted(label, fn, want)
            wall = time.perf_counter() - t0
            tracer = trace.enable()
            try:
                t0 = time.perf_counter()
                traced = counted(f"{label}, traced", fn, want)
                wall_traced = time.perf_counter() - t0
            finally:
                trace.disable()
            for a, b in zip(traced.outputs, plain.outputs, strict=True):
                if not np.array_equal(a.blocks, b.blocks):
                    raise AssertionError(f"{label}: traced blocks != untraced")
            ob = traced.meta["obs"]
            got = {name: p["count"] for name, p in ob["phases"].items()}
            if got != phases:
                raise AssertionError(f"{label}: phases {got}, expected {phases}")
            util = ob.get("utilization", 0.0)
            if not 0.0 < util <= 1.0:
                raise AssertionError(f"{label}: utilization {util} outside (0, 1]")
            events = trace.validate_chrome_trace(tracer.chrome_trace())
            if events != tracer.event_count():
                raise AssertionError(f"{label}: {events} valid events of "
                                     f"{tracer.event_count()}")
            print(f"  {label}: untraced {wall:.3f} s, traced {wall_traced:.3f} s "
                  f"(campaign {plain.meta['obs']['seconds']:.3f} / "
                  f"{ob['seconds']:.3f} s), blocks equal, {events} valid events")
            for line in trace.format_phase_table(tracer.phase_stats()).splitlines():
                print(f"    {line}")
            print(f"    obs comparisons={ob['comparisons']} "
                  f"bound_seconds={ob['bound_seconds']:.6f} "
                  f"bottleneck={ob['bottleneck']} utilization={util:.4g}", flush=True)
            del plain, traced, tracer
        shutil.rmtree(root / "v2")
        shutil.rmtree(root / "grown")

        # -- (b) SimilarityService, two workers on the card ----------------
        W = V2[:, :N_V_CHECKSUM]
        write_dataset(str(root / "cli"), W, levels=2)
        write_dataset(str(root / "cli4"), W, levels=2, n_shards=STORE_SHARDS)
        req_a = SimilarityRequest(**czek, input=planes(root / "cli"))
        req_b = SimilarityRequest(impl="pallas")
        req_c = SimilarityRequest(**czek, input=planes(root / "cli4"))
        with SimilarityService(device="cuda", workers=2) as svc:
            print(f"  warmup of the dataset request: {svc.warmup(req_a):.3f} s")
            subs = [(req_a, None), (req_a, None), (req_b, W), (req_c, None)]
            futures = [None] * len(subs)

            def submit(i):
                futures[i] = svc.submit_async(*subs[i])

            t0 = time.perf_counter()
            zero()
            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(len(subs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            got = [f.result(timeout=600) for f in futures]
            read("service submits", {"metric2_levels_tri": 1 + STORE_SHARDS,
                                     "metric2_tri": 1})
            print(f"  4 concurrent submits (2 duplicates): "
                  f"{time.perf_counter() - t0:.3f} s")
            if got[0] is not got[1]:
                raise AssertionError("service: duplicate submits computed twice")
            ref_a = engine.run(req_a)  # before the append grows its dataset
            append_dataset(str(root / "cli"), random_integer_vectors(
                N_F, CLI_NEW, max_value=2, seed=SEED + 11))
            t0 = time.perf_counter()
            grown = counted("service delta", lambda: svc.submit(req_a),
                            {"metric2_levels": 1, "metric2_levels_tri": 1})
            print(f"  the appended dataset's request: "
                  f"{time.perf_counter() - t0:.3f} s, meta['delta'] "
                  f"{json.dumps(grown.meta['delta'])}")
            stats, metrics = svc.stats(), svc.metrics()
        want_stats = {"hits": 1, "misses": 4, "cached_results": 4, "delta_hits": 1,
                      "in_flight": 0, "submitted": 5, "warmups": 1, "errors": 0}
        if stats != want_stats or \
                stats["hits"] + stats["misses"] + stats["in_flight"] != stats["submitted"]:
            raise AssertionError(f"service stats {stats}, expected {want_stats}")
        refs = [ref_a, engine.run(req_b, W), engine.run(req_c),
                engine.run(SimilarityRequest(**czek, streaming="off",
                                             input=planes(root / "cli"))).pack()]
        for label, res, ref in zip(("dataset", "values, pallas", "4 shards",
                                    "delta hit"),
                                   (got[0], got[2], got[3], grown), refs):
            for a, b in zip(res.outputs, ref.outputs, strict=True):
                if not np.array_equal(a.blocks, b.blocks):
                    raise AssertionError(f"service {label}: blocks != the engine's")
        print("  service results equal the in-process engine's (blocks; the "
              "delta hit against the packed full recompute)")
        print(f"  stats {json.dumps(stats)}")
        print(f"  queue wait p50 {metrics['queue_wait_seconds']['p50']:.4f} s, "
              f"compute p50 {metrics['compute_seconds']['p50']:.4f} s; "
              f"metrics {json.dumps(metrics)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def check_batched(engine, V2, V1, refs2, walls2, refs3, walls3, wrappers) -> dict:
    """Batched campaigns on the card: each batch's campaigns against their
    sequential counterparts (``np.array_equal``; Sorenson's blocks are
    Czekanowski's on the same data, one stat and one assembly), with the
    launches that show each metric family contracting once, then the
    float16 outputs and the bfloat16 / int32 rings.  ``refs2`` / ``refs3``
    and ``walls2`` / ``walls3`` are the blocks and walls of the phases
    ``campaigns`` and ``campaigns3``; ``wrappers`` maps kernel names to
    wrappers.  Returns the batches' launches by kernel name (the float32
    forms of rows 1 and 11 under their own names)."""
    import torch

    from repro_torch.api import SimilarityRequest
    from repro_torch.core.metric_spec import CZEKANOWSKI
    from repro_torch.core.twoway import resolve_config
    from repro_torch.kernels.mgemm import mgemm
    from repro_torch.kernels.mgemm_levels import (
        encode_bitplanes_np,
        metric2_levels_tri,
        values_from_planes,
    )

    total = {name: 0 for name in wrappers}
    float32_names = {"mgemm": "mgemm float32",
                     "threeway_batch": "threeway_batch min float32"}

    def run(label, req, V, want, *, float32=False):
        """The campaign with its launches, which must be ``want``."""
        before = {name: w.launches for name, w in wrappers.items()}
        res = engine.run(req, V)
        ran = {name: w.launches - before[name] for name, w in wrappers.items()}
        if ran != {name: want.get(name, 0) for name in wrappers}:
            raise AssertionError(f"{label}: launches "
                                 f"{ {n: c for n, c in ran.items() if c} }, "
                                 f"expected {want}")
        for name, n in ran.items():
            name = float32_names.get(name, name) if float32 else name
            total[name] = total.get(name, 0) + n
        return res

    def same(label, got, want):
        if got.shape != want.shape or got.dtype != want.dtype or \
                not np.array_equal(got, want):
            raise AssertionError(f"{label}: blocks differ from the sequential "
                                 "campaign's")

    def symmetric3(res):
        """(n, n, n) values of a one-output 3-way result, each triple at all
        six orderings of its indices."""
        out = np.zeros((res.n_v,) * 3, np.float32)
        for I, J, K, vals in res.outputs[0].entries():
            for a, b, c in itertools.permutations((I, J, K)):
                out[a, b, c] = vals
        return out

    def report(label, res, seq_walls):
        obs = res.meta["obs"]
        layers = ", ".join(f"{layer} {sec:.3f}"
                           for layer, sec in res.meta["layer_seconds"].items())
        print(f"  batch {label}: {obs['seconds']:.3f} s, "
              f"{obs['comparisons_per_s']:.4g} comparisons/s; sequential walls "
              f"{' + '.join(f'{w:.3f}' for w in seq_walls)} = {sum(seq_walls):.3f} s; "
              f"layers (s): {layers}; batch {json.dumps(res.meta['batch'])}",
              flush=True)

    levels2 = dict(impl="levels", levels=2)
    ab = dict(metric="czekanowski", metrics=("sorenson", "ccc"), **levels2)
    # (a) one raw diagonal plane kernel for Czekanowski + Sorenson; CCC on
    # the values of the same planes through its fp32 matmul
    res = run("(a)", SimilarityRequest(**ab), V2, {"metric2_levels_tri": 1})
    for metric, ref in (("czekanowski", "czekanowski"), ("sorenson", "czekanowski"),
                        ("ccc", "ccc")):
        same(f"(a) {metric}", res.get(metric).outputs[0].blocks, refs2[ref])
    # Sorenson's sequential campaign is Czekanowski's request but for the
    # name; CCC's under impl="levels" is its unfused matmul, as under "xla"
    report("(a) czekanowski + sorenson + ccc, levels=2", res,
           [walls2["czek levels"], walls2["czek levels"], walls2["ccc xla"]])
    del res
    # (b) impl="pallas": the min-plus GEMM (row 1) on the whole block
    res = run("(b)", SimilarityRequest(metric="czekanowski", metrics=("ccc",),
                                       impl="pallas"), V2, {"mgemm": 1})
    for metric in ("czekanowski", "ccc"):
        same(f"(b) {metric}", res.get(metric).outputs[0].blocks, refs2[metric])
    report("(b) czekanowski + ccc, pallas", res,
           [walls2["czek pallas"], walls2["ccc pallas"]])
    del res
    # (c) two overlapping named subsets, one given in reverse order
    subsets = (("even", tuple(range(0, N_V, 2))), ("cohort", tuple(range(2999, -1, -1))))
    res = run("(c)", SimilarityRequest(**ab, subsets=subsets), V2,
              {"metric2_levels_tri": 1})
    seq_walls = []
    for sname, idx in subsets:
        W = np.ascontiguousarray(V2[:, list(idx)])
        for metric in ("czekanowski", "ccc"):
            seq = engine.run(SimilarityRequest(metric=metric, **levels2), W)
            seq_walls += [seq.meta["obs"]["seconds"]] * (2 if metric == "czekanowski" else 1)
            for name in (("czekanowski", "sorenson") if metric == "czekanowski"
                         else ("ccc",)):
                same(f"(c) {name} {sname}", res.get(name, sname).outputs[0].blocks,
                     seq.outputs[0].blocks)
            del seq
    report(f"(c) (a) on subsets even ({len(subsets[0][1])}) and cohort "
           f"({len(subsets[1][1])}, reversed)", res, seq_walls)
    del res
    # (d) / (e) 3-way, one stage: each family slices once a pipeline slice
    stage = dict(way=3, n_st=N_ST3, stages=(0,))
    V3b = V2[:, :N_V3]
    res = run("(d)", SimilarityRequest(metric="czekanowski", metrics=("sorenson",),
                                       **levels2, **stage), V3b,
              {"threeway_batch_levels": 6, "metric2_levels": 18})
    for metric in ("czekanowski", "sorenson"):
        same(f"(d) {metric}", res.get(metric).outputs[0].blocks, refs3["czek levels=2"])
    report("(d) 3-way czekanowski + sorenson, levels=2 ring", res,
           [walls3["czek levels=2"]] * 2)
    del res
    res = run("(e)", SimilarityRequest(metric="czekanowski", metrics=("ccc",),
                                       impl="pallas", **stage), V3b,
              {"threeway_batch": 12, "mgemm": 18})
    same("(e) czekanowski", res.get("czekanowski").outputs[0].blocks,
         refs3["czek levels=2"])
    same("(e) ccc", res.get("ccc").outputs[0].blocks, refs3["ccc pallas"])
    report("(e) 3-way czekanowski + ccc, pallas", res,
           [walls3["czek pallas"], walls3["ccc pallas"]])
    del res
    # (f) a mixed-family 3-way batch on the plane ring, all stages, with
    # named subsets: CCC contracts the values of the planes
    W3 = V2[:, :N_V3_CHECKSUM]
    subsets3 = (("even", tuple(range(0, N_V3_CHECKSUM, 2))),
                ("tail", tuple(range(N_V3_CHECKSUM - 1, 59, -1))))
    res = run("(f)", SimilarityRequest(way=3, n_st=2, metric="czekanowski",
                                       metrics=("ccc",), subsets=subsets3, **levels2),
              W3, {"threeway_batch_levels": 12, "metric2_levels": 36})
    seq_walls = []
    for sname, idx in subsets3:
        order = np.argsort(idx)  # the subset's positions in the union's order
        for metric in ("czekanowski", "ccc"):
            seq = engine.run(SimilarityRequest(way=3, metric=metric, **levels2),
                             np.ascontiguousarray(W3[:, list(idx)]))
            seq_walls.append(seq.meta["obs"]["seconds"])
            got, want = symmetric3(res.get(metric, sname)), symmetric3(seq)
            if metric == "czekanowski" or list(idx) == sorted(idx):
                if not np.array_equal(got, want):
                    raise AssertionError(f"(f) {metric} {sname}: differs from the "
                                         "sequential campaign")
                continue
            # CCC's fp32 denominator (s_p * s_l) * s_r rounds by the roles
            # its three vectors take, and the batch gives them their roles
            # in the union's order, as repro's batch does: so the campaign
            # equals the sequential one on the same columns in that order
            asc = engine.run(SimilarityRequest(way=3, metric=metric, **levels2),
                             np.ascontiguousarray(W3[:, list(np.asarray(idx)[order])]))
            if not np.array_equal(got[np.ix_(order, order, order)], symmetric3(asc)):
                raise AssertionError(f"(f) {metric} {sname}: differs from the "
                                     "sequential campaign in the union's order")
            diff = got != want
            ulps = np.abs(got[diff].view(np.int32).astype(np.int64)
                          - want[diff].view(np.int32).astype(np.int64))
            print(f"  (f) {metric} {sname} (reversed): equals the sequential campaign "
                  f"on its columns in ascending order; against the given order "
                  f"{int(diff.sum()) // 6} of {len(idx) * (len(idx) - 1) * (len(idx) - 2) // 6} "
                  f"triples differ, by at most {int(ulps.max()) if ulps.size else 0} ulp",
                  flush=True)
    report("(f) 3-way czekanowski + ccc, levels=2 ring, subsets", res, seq_walls)
    del res
    # (h) / (i) binary data at levels=1: the popcount kernels, row 8 raw
    # on the 2-way block, rows 9 / 7 on the 3-way plane ring
    levels1 = dict(metric="sorenson", metrics=("czekanowski",), impl="levels", levels=1)
    res = run("(h)", SimilarityRequest(**levels1), V1, {"metric2_pop_tri": 1})
    for metric in ("sorenson", "czekanowski"):
        same(f"(h) {metric}", res.get(metric).outputs[0].blocks, refs2["sorenson"])
    report("(h) sorenson + czekanowski, levels=1", res, [walls2["sorenson levels"]] * 2)
    del res
    W1 = V1[:, :N_V3_CHECKSUM]
    res = run("(i)", SimilarityRequest(way=3, n_st=2, **levels1), W1,
              {"threeway_batch_pop": 12, "metric2_pop": 36})
    seq = engine.run(SimilarityRequest(way=3, n_st=2, metric="sorenson", impl="levels",
                                       levels=1), W1)
    for metric in ("sorenson", "czekanowski"):
        for a, b in zip(res.get(metric).outputs, seq.outputs, strict=True):
            same(f"(i) {metric}", a.blocks, b.blocks)
    report("(i) 3-way sorenson + czekanowski, levels=1 ring", res,
           [seq.meta["obs"]["seconds"]] * 2)
    del res, seq

    # the repairs: float16 outputs, and rings other than int8 / float32
    for label, knobs, want in (("pallas", dict(impl="pallas"), {"metric2_tri": 1}),
                               ("levels=2", levels2, {"metric2_levels_tri": 1})):
        res = run(f"float16 {label}", SimilarityRequest(out_dtype="float16", **knobs),
                  V2, want)
        same(f"float16 {label}", res.outputs[0].blocks,
             refs2["czekanowski"].astype(np.float16))
        print(f"  float16 {label}: {res.meta['obs']['seconds']:.3f} s, blocks equal "
              "the float32 blocks cast to float16", flush=True)
        del res
    base3 = engine.run(SimilarityRequest(way=3, n_st=2, impl="pallas"), W3)
    for ring in ("bfloat16", "int32"):
        req = SimilarityRequest(impl="pallas", ring_dtype=ring)
        if resolve_config(req.to_comet_config(), V2, CZEKANOWSKI).ring_dtype != ring:
            raise AssertionError(f"ring {ring}: resolved to another ring")
        res = run(f"ring {ring}", req, V2, {"metric2_tri": 1})
        same(f"ring {ring}", res.outputs[0].blocks, refs2["czekanowski"])
        wall = res.meta["obs"]["seconds"]
        del res
        res = run(f"ring {ring} 3-way",
                  SimilarityRequest(way=3, n_st=2, impl="pallas", ring_dtype=ring),
                  W3, {"threeway_batch": 12, "mgemm": 36}, float32=True)
        for a, b in zip(res.outputs, base3.outputs, strict=True):
            same(f"ring {ring} 3-way", a.blocks, b.blocks)
        print(f"  ring {ring}, pallas: 2-way {wall:.3f} s, 3-way (n_v "
              f"{N_V3_CHECKSUM}, 2 stages) {res.meta['obs']['seconds']:.3f} s; "
              "blocks equal the int8 ring's", flush=True)
        del res

    # row 1 and raw row 6 at the batches' shapes, beside their bounds
    # (the same operation counts as the kernels phase: 2 fp32 instructions a
    # comparison for row 1, 2 b1 ops a (pair, plane, field) for row 6)
    V = torch.as_tensor(V2, dtype=torch.int8, device="cuda")
    ms1, got = cuda_ms(lambda: mgemm(V.t(), V), repeats=3)
    b1, by1 = bound_of(nbytes(V), nbytes(got), 2 * N_F * N_V * N_V, FP32_INSTR_PER_S)
    del got
    P = torch.as_tensor(encode_bitplanes_np(V2, 2), device="cuda")
    s = CZEKANOWSKI.stat(values_from_planes(P))
    ms6, got = cuda_ms(lambda: metric2_levels_tri(P, s, epilogue=None), repeats=5)
    b6, by6 = bound_of(nbytes(P, s), nbytes(got),
                       2 * (N_V * (N_V - 1) // 2) * 2 * 8 * P.shape[1], B1_OPS_PER_S)
    del got
    print(f"  mgemm (row 1) at ({N_V}, {N_V}), int8: {ms1:.3f} ms, bound {b1:.3f} ms "
          f"({by1}); metric2_levels_tri raw (row 6, epilogue=None) at n_v {N_V}: "
          f"{ms6:.3f} ms, bound {b6:.3f} ms ({by6})", flush=True)
    del V, P, s
    torch.cuda.empty_cache()
    return total


def check_combine_kernels(V2, kernels, combines, device="cuda") -> None:
    """Phase combines (a): rows 3, 2, 11 and 10 under each compiled combine
    of ``combines`` (``combine_set``) against their plain versions on the
    card, ``torch.equal``, on int8 and float32 operands: at ragged shapes
    (int8 data over the whole int8 range, so the int8 forms wrap; float32 in
    [-20, 20]) and at full width, n_f = 20,000 of the campaigns' data, row 3
    at the (2,048) diagonal block, row 2 at (2,048, 2,048), row 11 at L = 4
    pipeline columns (a strided view) of (1,536, 1,536) and row 10 at one;
    each timed with CUDA events after a warm call, beside ``min``'s time on
    the same shape and its bound (the combine's ops and the add a comparison
    at the fp32 issue rate).  ``kernels``' four ``[expr]`` entries take the
    numbers of ``abs(a - b)`` on int8, whose library call is
    ``torch.cdist(p=1)``, and every check's error."""
    import torch

    from repro_torch.core.metric_spec import CZEKANOWSKI
    from repro_torch.kernels.czek3 import minplus3_plain, threeway_batch, threeway_step
    from repro_torch.kernels.mgemm import (
        BT,
        metric2_tiles,
        metric2_tiles_plain,
        metric2_tri,
        metric2_tri_plain,
        unpack_tri_tiles,
    )
    from repro_torch.kernels.mgemm.combine import combine_expr

    dev = torch.device(device)

    # ragged shapes
    rng = np.random.default_rng(SEED + 7)
    n_checks = 0
    for cname, comb in combines.items():
        for dt in (torch.int8, torch.float32):
            lo, hi = (-128, 128) if dt == torch.int8 else (-20, 21)
            for k, n_v in [(77, 300), (333, 129), (1000, 5), (40, 257)]:
                V = torch.as_tensor(rng.integers(lo, hi, size=(k, n_v)), dtype=dt,
                                    device=dev)
                s = CZEKANOWSKI.stat(V)
                tag = f"{cname} {dt} k={k} n_v={n_v}"
                check_equal(f"metric2_tri[expr] {tag}",
                            metric2_tri(V, s, combine=comb, epilogue=None),
                            metric2_tri_plain(V, s, combine=comb, epilogue=None),
                            kernels["metric2_tri[expr]"]["errs"])
                m = n_v // 2 + 1
                A, B, sa, sb = V[:, :m].t(), V[:, n_v - m:], s[:m], s[n_v - m:]
                check_equal(f"metric2_tiles[expr] {tag}",
                            metric2_tiles(A, B, sa, sb, combine=comb, epilogue=None),
                            metric2_tiles_plain(A, B, sa, sb, combine=comb, epilogue=None),
                            kernels["metric2_tiles[expr]"]["errs"])
                X = V[:, 1:4]  # a strided view: the pipeline columns
                want = minplus3_plain(V[:, :m], X, V, combine=comb)
                check_equal(f"threeway_batch[expr] {tag}",
                            threeway_batch(V[:, :m], X, V, combine=comb), want,
                            kernels["threeway_batch[expr]"]["errs"])
                check_equal(f"threeway_step[expr] {tag}",
                            threeway_step(V[:, :m], X[:, 1], V, combine=comb), want[1],
                            kernels["threeway_step[expr]"]["errs"])
                n_checks += 4
    # combine(0, 0) != 0 on row 3x: split (the first four shapes) and
    # unsplit (4,000 columns: 528 packed tiles)
    for cname, comb in nonzero_combines().items():
        for dt in (torch.int8, torch.float32):
            lo, hi = (-128, 128) if dt == torch.int8 else (-20, 21)
            for k, n_v in [(77, 300), (333, 129), (1000, 5), (40, 257), (77, 4000)]:
                V = torch.as_tensor(rng.integers(lo, hi, size=(k, n_v)), dtype=dt,
                                    device=dev)
                s = CZEKANOWSKI.stat(V)
                check_equal(f"metric2_tri[expr] {cname} {dt} k={k} n_v={n_v}",
                            metric2_tri(V, s, combine=comb, epilogue=None),
                            metric2_tri_plain(V, s, combine=comb, epilogue=None),
                            kernels["metric2_tri[expr]"]["errs"])
                n_checks += 1
    print(f"  (a) {n_checks} checks at ragged shapes equal their plain versions", flush=True)

    # full width: the campaigns' {0,1,2} data, n_f = N_F
    w, m3, L = N_V // 4, N_V3, L_PLAIN
    Q = torch.as_tensor(V2[:, :2 * w], device=dev).to(torch.int8)
    for dt in (torch.int8, torch.float32):
        Vd = Q.to(dt)
        D, A, B = Vd[:, :w], Vd[:, :w], Vd[:, w:]
        sD, sB = CZEKANOWSKI.stat(D), CZEKANOWSKI.stat(B)
        own, X = Vd[:, :m3], Vd[:, m3:m3 + L]  # X: row stride 2 w, read in place
        pairs = w * (w - 1) // 2
        forms = {
            # name: (kernel(c), plain(c), inputs, comparisons)
            "metric2_tri[expr]": (
                lambda c: metric2_tri(D, sD, combine=c, epilogue=None),
                lambda c: metric2_tri_plain(D, sD, combine=c, epilogue=None),
                (D, sD), N_F * pairs),
            "metric2_tiles[expr]": (
                lambda c: metric2_tiles(A.t(), B, sD, sB, combine=c, epilogue=None),
                lambda c: metric2_tiles_plain(A.t(), B, sD, sB, combine=c, epilogue=None),
                (A, B, sD, sB), N_F * w * w),
            "threeway_batch[expr]": (
                lambda c: threeway_batch(own, X, own, combine=c),
                lambda c: minplus3_plain(own, X, own, combine=c),
                (own, X), N_F * L * m3 * m3),
            "threeway_step[expr]": (
                lambda c: threeway_step(own, X[:, 0], own, combine=c),
                lambda c: minplus3_plain(own, X[:, :1], own, combine=c)[0],
                (own, X[:, 0]), N_F * m3 * m3),
        }
        for name, (kern, plain, inputs, comparisons) in forms.items():
            k = kernels[name]
            min_ms = None
            if dt == torch.int8:
                kern(torch.minimum)
                min_ms, _ = one_ms(lambda: kern(torch.minimum))
            for cname, comb in combines.items():
                kern(comb)  # warm: the first launch loads the combine's library
                ms, got = one_ms(lambda: kern(comb))
                plain_ms, want = one_ms(lambda: plain(comb))
                check_equal(f"{name} full width {cname} {dt}", got, want, k["errs"])
                ops = (combine_expr(comb).function(dt, dt).ops + 1) * comparisons
                b_ms, b_by = bound_of(nbytes(*inputs), nbytes(got), ops, FP32_INSTR_PER_S)
                line = (f"  {name} {cname} {str(dt)[6:]}: kernel {ms:.3f} ms, plain "
                        f"{plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by})")
                if min_ms is not None:
                    line += f"; min on the same shape {min_ms:.3f} ms"
                if cname == "abs(a - b)" and dt == torch.int8:
                    k["ms"], k["plain_ms"] = ms, plain_ms
                    k["bound_ms"], k["bound_by"] = b_ms, b_by
                    call, to_numer = _cdist_absdiff(name, D, A, B, own, X)
                    k["library_ms"], lib = cuda_ms(call, repeats=1)
                    if not torch.equal(to_numer(lib), got if name != "metric2_tri[expr]"
                                       else unpack_tri_tiles(got, w, BT)):
                        raise AssertionError(f"{name}: library numerator != kernel's")
                    line += f", library (cdist, p=1) {k['library_ms']:.3f} ms"
                    del lib, call
                print(line, flush=True)
                del got, want
        del Vd, D, A, B, own, X
        torch.cuda.empty_cache()
    del Q


def check_combines(engine, V2, kernels, combines, ring_libs, device="cuda") -> dict:
    """Phase combines: any registered combine on the value kernels (rows 2,
    3, 10 and 11 running a compiled combine; its library built in phase
    build).

    (a) ``check_combine_kernels``: each form against its plain version on
    the card under every combine of ``combines``, timed.  (b) A 2-way
    Bray-Curtis dissimilarity (``sum |a - b| / sum (a + b)``, registered
    here with a lambda of its own: its expression is (a)'s ``abs(a - b)``,
    so it runs that library, built in phase build) under impl="pallas" at full
    width, n_v = 8,192, its ``meta["obs"]`` and layers printed; at n_v =
    2,048 the same metric's chunked ``impl="xla"`` campaign (the generic
    combine-sum) on 2,048 columns spread over the 8,192 (8 windows, one a
    1,024) equals, bit for bit, the ``pallas`` campaign at (1, 2, 1) on the
    card (rows 3 and 2) and the full-width run's block on those columns.
    (c) 3-way ``maxplus`` (Czekanowski with ``maximum``), one stage at n_v
    = 768, n_st = 4 (L = 32), under impl="pallas": 6 slices on row 11's
    compiled combine and 18 pair terms on row 1 (min, as in ``repro``),
    equal to the same request whose slices run ``minplus3_plain`` on the
    card (at n_v = 1,536 the plain slices alone took 129 s on an H100 80GB
    HBM3, which the run's time limit cannot hold).  (d)
    ``find_near_duplicates`` on the card against the CPU, on
    ``examples/dataset_dedup_torch.py``'s documents.  (e)
    ``check_ring_combines``: the widened rings, whose libraries
    (``ring_libs``) phase build compiled.  (f) ``check_ring_campaign``:
    Bray-Curtis on a bfloat16 ring, held to the CPU campaign, which runs
    after the card's.  Returns the launches of each ``[expr]`` entry on the
    campaign paths (b), (c) and (f); the checks' own launches are not
    counted."""
    import torch
    from dataclasses import replace

    import repro_torch.kernels.czek3 as czek3_pkg
    from repro_torch.api import (
        MetricSpec,
        SimilarityEngine,
        SimilarityRequest,
        get_metric,
        register_metric,
    )
    from repro_torch.core.metric_spec import CZEKANOWSKI
    from repro_torch.core.metrics import safe_denom
    from repro_torch.core.tile_executor import TileExecutor
    from repro_torch.core.twoway import resolve_config
    from repro_torch.data.dedup import find_near_duplicates
    from repro_torch.kernels.czek3 import minplus3_plain, threeway_batch, threeway_step
    from repro_torch.kernels.mgemm import metric2_tiles, metric2_tri, mgemm
    from repro_torch.kernels.mgemm.combine import combine_expr

    dev = torch.device(device)
    names = ("metric2_tri[expr]", "metric2_tiles[expr]", "threeway_batch[expr]",
             "threeway_step[expr]")

    def bc2(n2, si, sj):
        return n2 / safe_denom(si + sj)

    register_metric(MetricSpec(
        name="braycurtis", description="Bray-Curtis dissimilarity: sum |a - b| / "
        "sum (a + b)", ways=(2,), combine=lambda a, b: torch.abs(a - b),
        stat=CZEKANOWSKI.stat, assemble2=bc2, assemble_tile=bc2, uses_mgemm=False),
        overwrite=True)
    register_metric(replace(CZEKANOWSKI, name="maxplus", combine=torch.maximum),
                    overwrite=True)
    check_combine_kernels(V2, kernels, combines, device)
    w = N_V // 4
    built = {lib for _, lib in combine_libraries(combines)}

    wrappers = {"metric2_tri[expr]": metric2_tri, "metric2_tiles[expr]": metric2_tiles,
                "threeway_batch[expr]": threeway_batch, "threeway_step[expr]": threeway_step,
                "mgemm": mgemm}
    launched = {name: 0 for name in names}

    def run(label, req, V, expect, eng=engine):
        before = {name: fn.launches for name, fn in wrappers.items()}
        res = eng.run(req, V)
        ran = {name: fn.launches - before[name] for name, fn in wrappers.items()}
        if ran != {name: expect.get(name, 0) for name in wrappers}:
            raise AssertionError(f"{label}: launches {ran}, expected {expect}")
        for name in names:
            launched[name] += ran[name]
        obs = res.meta["obs"]
        layers = ", ".join(f"{layer} {sec:.3f}"
                           for layer, sec in res.meta["layer_seconds"].items())
        print(f"  {label}: {obs['seconds']:.3f} s {obs['comparisons_per_s']:.4g} "
              f"comparisons/s; obs {json.dumps(obs)}; layers (s): {layers}; launches "
              f"{ {k: v for k, v in ran.items() if v} }", flush=True)
        return res

    # (b) 2-way Bray-Curtis
    for metric in ("braycurtis", "maxplus"):  # (a)'s libraries, built in phase build
        if combine_expr(get_metric(metric).combine).library(torch.int8) not in built:
            raise AssertionError(f"{metric}: its combine is not one phase build compiled")
    req = SimilarityRequest(metric="braycurtis", impl="pallas")
    path = TileExecutor(cfg=req.to_comet_config(), metric=get_metric("braycurtis")).path
    if path != "fused-vpu":
        raise AssertionError(f"braycurtis pallas: path {path!r}")
    full = run(f"(b) braycurtis pallas n_v={N_V}", req, V2, {"metric2_tri[expr]": 1})
    blocks = full.outputs[0].blocks
    if blocks.shape != (1, 1, 1, N_V, N_V) or not np.isfinite(blocks).all():
        raise AssertionError("braycurtis pallas: blocks of the wrong shape or not finite")
    cols = spread_columns(w, N_V)
    sub = blocks[0, 0, 0][np.ix_(cols, cols)]
    del full, blocks
    W = V2[:, cols]
    xla = run(f"(b) braycurtis xla n_v={w}", SimilarityRequest(metric="braycurtis",
                                                                impl="xla"), W, {})
    bits = xla.outputs[0].dense().view(np.uint32)
    if not np.array_equal(xla.outputs[0].blocks[0, 0, 0].view(np.uint32),
                          sub.view(np.uint32)):
        raise AssertionError("braycurtis: the n_v = 8,192 block != xla on 2,048 "
                             "spread columns")
    eng2 = SimilarityEngine(device=device, devices=[f"{dev.type}:{dev.index or 0}"] * 2)
    dec = run(f"(b) braycurtis pallas n_v={w} (1, 2, 1)",
              SimilarityRequest(metric="braycurtis", impl="pallas", n_pv=2), W,
              {"metric2_tri[expr]": 2, "metric2_tiles[expr]": 1}, eng=eng2)
    if not np.array_equal(dec.outputs[0].dense().view(np.uint32), bits):
        raise AssertionError("braycurtis pallas (1, 2, 1) != xla, bitwise")
    print("  (b) pallas at (1, 2, 1) and the full-width block on the spread columns "
          "equal xla bit for bit", flush=True)
    del xla, dec, bits, sub

    # (c) 3-way maxplus, one stage
    req3 = SimilarityRequest(way=3, metric="maxplus", n_st=N_ST3, stages=(0,),
                             impl="pallas")
    V3 = V2[:, :N_V3 // 2]
    cfg3 = resolve_config(req3.to_comet_config(), V3, get_metric("maxplus"))
    if TileExecutor(cfg=cfg3, metric=get_metric("maxplus")).path3 != "fused-vpu":
        raise AssertionError("maxplus pallas: path3 is not fused-vpu")
    got3 = run(f"(c) maxplus 3-way pallas n_v={V3.shape[1]}", req3, V3,
               {"threeway_batch[expr]": 6, "mgemm": 18}).outputs[0].blocks
    kernel_slice = czek3_pkg.threeway_batch
    czek3_pkg.threeway_batch = lambda own, X, right, *, combine: minplus3_plain(
        own, X, right, combine=combine)
    try:
        t0 = time.perf_counter()
        ref3 = engine.run(req3, V3).outputs[0].blocks
        print(f"  (c) the same request, slices through minplus3_plain on the card: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    finally:
        czek3_pkg.threeway_batch = kernel_slice
    if not np.array_equal(got3, ref3):
        raise AssertionError("maxplus 3-way: row 11's compiled combine != minplus3_plain's")
    print("  (c) blocks equal the plain slices'", flush=True)
    del got3, ref3

    # (d) near-duplicate detection on the card
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        from dataset_dedup_torch import documents
    finally:
        sys.path.remove(str(ROOT / "examples"))
    docs, vocab = documents()
    t0 = time.perf_counter()
    hits = find_near_duplicates(docs, vocab, threshold=0.85, device=device)
    card_s = time.perf_counter() - t0
    if hits != find_near_duplicates(docs, vocab, threshold=0.85, device="cpu"):
        raise AssertionError("find_near_duplicates: the card's hits != the CPU's")
    if {(i, j) for i, j, _ in hits} != {(i, 60 + i) for i in range(6)}:
        raise AssertionError(f"find_near_duplicates: hits {hits}")
    print(f"  (d) find_near_duplicates: {len(hits)} hits on the card ({card_s:.3f} s), "
          f"equal to the CPU's", flush=True)

    # (e) and (f): the widened rings
    t0 = time.perf_counter()
    built = {lib for _, lib in ring_libs}
    if combine_expr(get_metric("braycurtis").combine).library(torch.bfloat16) not in built:
        raise AssertionError("braycurtis: its bfloat16 library is not one phase build built")
    check_ring_combines(kernels, device)
    check_ring_campaign(engine, V2, run)
    print(f"  (e) and (f), the widened rings: {time.perf_counter() - t0:.2f} s", flush=True)
    return launched


def _cdist_absdiff(name, D, A, B, own, X):
    """(call, to_numer): one PyTorch call computing the raw numerator of
    ``abs(a - b)`` for the form ``name`` (``torch.cdist(p=1)`` on float32
    rows; for rows 11 / 10 on the fold |own - x_t|, the pipeline axis folded
    into M), and the map of its output to the kernel's raw layout."""
    import torch

    if name == "metric2_tri[expr]":
        R = D.t().float().contiguous()
        return (lambda: torch.cdist(R, R, p=1)), lambda lib: torch.triu(lib, 1)
    if name == "metric2_tiles[expr]":
        Ra, Rb = A.t().float().contiguous(), B.t().float().contiguous()
        return (lambda: torch.cdist(Ra, Rb, p=1)), lambda lib: lib
    cols = X.shape[1] if name == "threeway_batch[expr]" else 1
    fold = (own.t()[None, :, :].float() - X[:, :cols].t()[:, None, :].float()).abs()
    F = fold.reshape(-1, own.shape[0]).contiguous()
    R = own.t().float().contiguous()
    m = own.shape[1]
    if cols == 1:
        return (lambda: torch.cdist(F, R, p=1)), lambda lib: lib
    return (lambda: torch.cdist(F, R, p=1)), lambda lib: lib.reshape(cols, m, m)


RING_FIELDS = 100  # phase combines (e): nonzero fields a vector, at most
RING_INT_SPAN = 200  # the fields an int ring's nonzeros lie in


def ring_values(ring, name: str, way: int):
    """The nonzero values of phase combines (e)'s data for the combine
    ``name`` on ``ring`` in a ``way``-way form: where the ring's rounding
    or wrap changes a term (squares past 256 / 2,048 for bfloat16 /
    float16, products past the int ring's range, int16 differences past
    2^15), from few enough values that ``ring_term_bound`` can try them
    all."""
    import torch

    if ring.is_floating_point:
        if name == "(a - b) ** 2" and way == 3:  # the square of a square
            return np.arange(8, 15)
        return np.arange(100, 201)
    if ring == torch.int16:
        if name == "a * b":
            return np.arange(200, 256)
        v = 20_000 + 256 * np.arange(50)
        return np.concatenate([v, -v])
    if name == "a * b":  # products j1 j2 2^16, past 2^31 for j >= 182
        return 256 * np.arange(182, 256)
    return 2 ** 18 * np.arange(1, 65)  # to 2^24, which fp32 holds exactly


def ring_term_bound(comb, ring, values, way: int) -> tuple:
    """(T, g) over every term the values (and 0) can give: T the largest
    |term|, every term a multiple of 2^g.  A vector has at most
    RING_FIELDS nonzero fields and combine(0, 0) == 0, so a sum holds at
    most ``way`` * RING_FIELDS nonzero terms, each a multiple of 2^g: its
    fp32 sums are exact in any order when that count times T is below
    2^(24 + g)."""
    import torch

    from repro_torch.kernels.mgemm.combine import combine_expr

    ev = combine_expr(comb).evaluate
    v = torch.as_tensor(np.concatenate([[0], values]).astype(np.float32)).to(ring)
    if way == 2:
        terms = ev(v[:, None], v[None, :])
    else:
        terms = ev(ev(v[:, None, None], v[None, :, None]), v[None, None, :])
    t = terms.to(torch.float32).flatten().numpy()
    if not np.isfinite(t).all():
        raise AssertionError(f"{ring}: a term that is not finite")
    t = t[t != 0]
    bits = t.view(np.uint32)
    mant = (bits & 0x7FFFFF) | 0x800000
    low = mant & (~mant + 1)  # the lowest set bit
    g = ((bits >> 23) & 0xFF).astype(np.int64) - 150 + np.log2(low).astype(np.int64)
    return float(np.abs(t).max()), int(g.min())


def ring_data(ring, values, n: int, gen, device):
    """(N_F, n) data of ``ring``: zeros, and in each column RING_FIELDS
    fields at random (repeats allowed, so at most that many) set to random
    ``values``: among all N_F fields on a float ring, among the first
    RING_INT_SPAN on an int ring, so that two columns share ~30 nonzero
    fields, where a product or difference can wrap."""
    import torch

    vals = torch.as_tensor(values.astype(np.float32), device=device)
    span = N_F if ring.is_floating_point else RING_INT_SPAN
    rows = torch.randint(0, span, (RING_FIELDS, n), generator=gen, device=device)
    pick = torch.randint(0, len(values), (RING_FIELDS, n), generator=gen, device=device)
    D = torch.zeros((N_F, n), dtype=torch.float32, device=device)
    D.scatter_(0, rows, vals[pick])
    return D.to(ring)


def changed_terms(comb, own, X, right) -> tuple:
    """(terms the ring changes, terms): ``comb`` evaluated on the ring's
    operands against the same combine on their float32 values, over the
    (fields, rows of own, columns of right) terms, and for X (a column)
    the 3-way terms combine(combine(own, x), right)."""
    import torch

    from repro_torch.kernels.mgemm.combine import combine_expr

    ev = combine_expr(comb).evaluate
    changed = 0
    for q in range(0, own.shape[0], 1_000):
        a = own[q:q + 1_000, :, None]
        b = right[q:q + 1_000, None, :]
        if X is not None:
            x = X[q:q + 1_000, None, None]
            ring = ev(ev(a, x), b).to(torch.float32)
            fp32 = ev(ev(a.float(), x.float()), b.float())
        else:
            ring = ev(a, b).to(torch.float32)
            fp32 = ev(a.float(), b.float())
        changed += int((ring != fp32).sum())
    return changed, own.shape[0] * own.shape[1] * right.shape[1]


def check_ring_combines(kernels, device="cuda") -> dict:
    """Phase combines (e): rows 3, 2, 11 and 10 under ``ring_combines`` on
    each widened ring, against their plain versions on the card,
    ``torch.equal``, at full width, n_f = 20,000: row 3 at the (2,048)
    diagonal block, row 2 at (2,048, 2,048), row 11 at L = 4 pipeline
    columns (a strided view) of (1,536, 1,536) and row 10 at one; the plain
    versions on the first 128 rows of each (their outputs a sub-block of
    the kernels'); first rows 11 / 10 at one field on int32 ``a * b``,
    whose fold ``own * x_t`` passes 2^24 and must reach the product
    exactly, and the four rows at one field under ``nan_combine``, whose
    NaNs must pass its clamp.  The data (``ring_data``, ``ring_values``): sparse, so
    the fp32 sums stay exact (``ring_term_bound``, checked), with values
    whose terms the ring changes (``changed_terms``, counted on 64 x 64
    pairs, > 0 on the float rings).  Each kernel timed with CUDA events
    after a warm call, beside the same combine on float32 (float rings) or
    int8 (int rings) operands of the same shape, and beside its bound (the
    combine's ops and the add a comparison at the fp32 issue rate, the
    ring's bytes); int32 ``abs(a - b)``, which no wrap can reach, also
    beside ``torch.cdist(p=1)``, checked equal first.  Returns {(form,
    ring, combine): numbers}."""
    import torch

    from repro_torch.kernels.czek3 import minplus3_plain, threeway_batch, threeway_step
    from repro_torch.kernels.mgemm import (
        BT,
        metric2_tiles,
        metric2_tiles_plain,
        metric2_tri,
        metric2_tri_plain,
        unpack_tri_tiles,
    )
    from repro_torch.kernels.mgemm.combine import combine_expr

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    w, m3, L, P = N_V // 4, N_V3, L_PLAIN, 128

    # row 11's int32 fold beyond 2^24, which no fp32 holds, carried to the
    # product as its bits: one field, so each output is one term
    wrap = ring_combines()[torch.int32]["a * b"]
    own = torch.randint(4_097, 2 ** 24, (1, 300), generator=gen, device=dev).to(torch.int32)
    right = torch.randint(-7, 8, (1, 200), generator=gen, device=dev).to(torch.int32)
    check_equal("threeway_batch[expr] int32 fold past 2^24",
                threeway_batch(own, own[:, 5:9], right, combine=wrap),
                minplus3_plain(own, own[:, 5:9], right, combine=wrap),
                kernels["threeway_batch[expr]"]["errs"])
    check_equal("threeway_step[expr] int32 fold past 2^24",
                threeway_step(own, own[:, 7], right, combine=wrap),
                minplus3_plain(own, own[:, 7:8], right, combine=wrap)[0],
                kernels["threeway_step[expr]"]["errs"])
    print("  (e) row 11's int32 fold past 2^24 (own * x_t of values from 4,097) equals "
          "the plain version's", flush=True)

    # a NaN into a clamp passes through: one field of {0, 1, 2}, so each
    # output is one term, 0/0 where both fields are 0
    nan = nan_combine()
    D = torch.randint(0, 3, (1, 300), generator=gen, device=dev).to(torch.bfloat16)
    own, X, z = D[:, :200], D[:, 200:204], torch.zeros(300, device=dev)
    A, B = D[:, :150], D[:, 150:]
    pairs = {
        "metric2_tri[expr]": (
            unpack_tri_tiles(metric2_tri(D, z, combine=nan, epilogue=None), 300, BT),
            unpack_tri_tiles(metric2_tri_plain(D, z, combine=nan, epilogue=None), 300, BT)),
        "metric2_tiles[expr]": (
            metric2_tiles(A.t(), B, z[:150], z[150:], combine=nan, epilogue=None),
            metric2_tiles_plain(A.t(), B, z[:150], z[150:], combine=nan, epilogue=None)),
        "threeway_batch[expr]": (threeway_batch(own, X, own, combine=nan),
                                 minplus3_plain(own, X, own, combine=nan)),
        "threeway_step[expr]": (threeway_step(own, X[:, 0], own, combine=nan),
                                minplus3_plain(own, X[:, :1], own, combine=nan)[0]),
    }
    for name, (got, want) in pairs.items():
        if check_equal_nan(f"{name} NaN into a clamp", got, want, kernels[name]["errs"]) < 1:
            raise AssertionError(f"{name}: no 0/0 reached the clamp")
    print("  (e) clamp((a - b) / (a + b), -0.5, 1) on bfloat16 at one field, 0/0 where both "
          "are 0: the NaNs pass the clamp on rows 3x, 2x, 11x and 10x as in the plain "
          "versions", flush=True)

    found = {}
    for ring, combines in ring_combines().items():
        for cname, comb in combines.items():
            vals2, vals3 = (ring_values(ring, cname, way) for way in (2, 3))
            for way, vals in ((2, vals2), (3, vals3)):
                T, g = ring_term_bound(comb, ring, vals, way)
                if way * RING_FIELDS * T >= 2.0 ** (24 + g):
                    raise AssertionError(f"{cname} on {ring}: fp32 sums of {way}-way terms "
                                         f"up to {T} on a 2^{g} grid are not exact")
            D2 = ring_data(ring, vals2, 2 * w, gen, dev)
            D3 = ring_data(ring, vals3, m3 + L, gen, dev)
            ch2 = changed_terms(comb, D2[:, :64], None, D2[:, 64:128])
            ch3 = changed_terms(comb, D3[:, :64], D3[:, m3], D3[:, 64:128])
            if ring.is_floating_point and min(ch2[0], ch3[0]) < 1:
                raise AssertionError(f"{cname} on {ring}: the ring changes no term")
            base = base_dtype(ring)
            fn = combine_expr(comb).function(ring, ring)

            def make_forms(Dd2, Dd3, comb=comb) -> dict:
                """name: (kernel, plain, the kernel's sub-block, inputs,
                comparisons) of each form on (Dd2, Dd3)."""
                D, A, B = Dd2[:, :w], Dd2[:, :w], Dd2[:, w:]
                own, X = Dd3[:, :m3], Dd3[:, m3:m3 + L]  # X: row stride m3 + L
                z, zw = torch.zeros(w, device=dev), torch.zeros(P, device=dev)
                return {
                    "metric2_tri[expr]": (
                        lambda: metric2_tri(D, z, combine=comb, epilogue=None),
                        lambda: unpack_tri_tiles(metric2_tri_plain(
                            D[:, :P], zw, combine=comb, epilogue=None), P, BT),
                        lambda got: unpack_tri_tiles(got, w, BT)[:P, :P],
                        (D,), N_F * (w * (w - 1) // 2)),
                    "metric2_tiles[expr]": (
                        lambda: metric2_tiles(A.t(), B, z, z, combine=comb, epilogue=None),
                        lambda: metric2_tiles_plain(A[:, :P].t(), B, zw, z, combine=comb,
                                                    epilogue=None),
                        lambda got: got[:P], (A, B), N_F * w * w),
                    "threeway_batch[expr]": (
                        lambda: threeway_batch(own, X, own, combine=comb),
                        lambda: minplus3_plain(own[:, :P], X, own, combine=comb),
                        lambda got: got[:, :P], (own, X), N_F * L * m3 * m3),
                    "threeway_step[expr]": (
                        lambda: threeway_step(own, X[:, 0], own, combine=comb),
                        lambda: minplus3_plain(own[:, :P], X[:, :1], own, combine=comb)[0],
                        lambda got: got[:P], (own, X[:, 0]), N_F * m3 * m3),
                }

            forms = {ring: make_forms(D2, D3), base: make_forms(D2.to(base), D3.to(base))}
            for name in forms[ring]:
                kern, plain, block, inputs, comparisons = forms[ring][name]
                kern()  # warm
                ms, got = one_ms(kern)
                check_equal(f"{name} full width {cname} {ring}", block(got), plain(),
                            kernels[name]["errs"])
                bkern = forms[base][name][0]
                bkern()
                base_ms, _ = one_ms(bkern)
                ops = (fn.ops + 1) * comparisons
                b_ms, b_by = bound_of(nbytes(*inputs), nbytes(got), ops, FP32_INSTR_PER_S)
                entry = dict(ms=ms, base_ms=base_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None, changed=ch3 if "threeway" in name else ch2)
                line = (f"  (e) {name} {cname} {str(ring)[6:]}: kernel {ms:.3f} ms, "
                        f"{str(base)[6:]} {base_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
                        f"terms the ring changes {entry['changed'][0]} of "
                        f"{entry['changed'][1]} sampled")
                if ring == torch.int32 and cname == "abs(a - b)":
                    D, A, B = D2[:, :w], D2[:, :w], D2[:, w:]
                    own, X = D3[:, :m3], D3[:, m3:m3 + L]
                    call, to_numer = _cdist_absdiff(name, D, A, B, own, X)
                    entry["library_ms"], lib = cuda_ms(call, repeats=1)
                    if not torch.equal(to_numer(lib), got if name != "metric2_tri[expr]"
                                       else unpack_tri_tiles(got, w, BT)):
                        raise AssertionError(f"{name}: library numerator != kernel's")
                    line += f", library (cdist, p=1) {entry['library_ms']:.3f} ms"
                    del lib, call
                print(line, flush=True)
                found[name, str(ring)[6:], cname] = entry
                del got
            del forms, D2, D3
            torch.cuda.empty_cache()
    return found


def check_ring_campaign(engine, V2, run) -> None:
    """Phase combines (f): a 2-way Bray-Curtis campaign under
    impl="pallas" on a bfloat16 ring at full width, n_v = 8,192 (row 3x
    on the ring's compiled combine), and on 1,024 spread columns of it on
    the card: that block equals the full-width one on those columns bit
    for bit, and its checksum the port's CPU campaign on them, run last,
    so that no timed campaign shares the host with it.  ``run`` is phase
    combines' campaign runner, which counts the launches."""
    from repro_torch.api import SimilarityEngine, SimilarityRequest

    req = SimilarityRequest(metric="braycurtis", impl="pallas", ring_dtype="bfloat16")
    full = run(f"(f) braycurtis bfloat16 pallas n_v={N_V}", req, V2,
               {"metric2_tri[expr]": 1})
    cols = spread_columns(N_V_CHECKSUM, N_V)
    sub = full.outputs[0].blocks[0, 0, 0][np.ix_(cols, cols)]
    del full
    card = run(f"(f) braycurtis bfloat16 pallas n_v={N_V_CHECKSUM}", req, V2[:, cols],
               {"metric2_tri[expr]": 1})
    if not np.array_equal(card.outputs[0].blocks[0, 0, 0].view(np.uint32),
                          sub.view(np.uint32)):
        raise AssertionError("braycurtis bfloat16: the n_v = 8,192 block != the card's "
                             f"campaign on {N_V_CHECKSUM} spread columns")
    t0 = time.perf_counter()
    want = SimilarityEngine(device="cpu").run(req, V2[:, cols]).checksum()
    if card.checksum() != want:
        raise AssertionError(f"braycurtis bfloat16: checksum {card.checksum()} on the "
                             f"card, {want} on the CPU")
    print(f"  (f) the full-width block on {N_V_CHECKSUM} spread columns equals the card's "
          f"campaign on them, whose checksum {want} equals the CPU campaign's "
          f"({time.perf_counter() - t0:.2f} s on the CPU)", flush=True)


def _lm_twin(cfg, model, device):
    """A second module of ``cfg`` on ``device`` holding ``model``'s weights
    (its ``state_dict`` copied across)."""
    from repro_torch.models import api

    twin = api.init_model(cfg, device="meta").to_empty(device=device)
    twin.load_state_dict(model.state_dict())
    return twin


def _lm_teacher_forced(cfg, model, seq, src_embeds=None):
    """Last-position logits (B, S, V) of decode steps that feed ``seq`` (B,
    S) one token at a time from a fresh cache of length S, on the CPU."""
    import torch

    from repro_torch.models import api

    with torch.inference_mode():
        cache = api.init_cache(cfg, model, seq.shape[0], seq.shape[1], src_embeds=src_embeds)
        steps = []
        for i in range(seq.shape[1]):
            logits, cache = api.decode_step(cfg, model, cache, seq[:, i:i + 1], i)
            steps.append(logits[:, -1].float().cpu())
    return torch.stack(steps, dim=1)


def _lm_device_ms(cfg, model, seq, steps=4) -> tuple:
    """(device ms a decode step, its three costliest kernels) from
    ``torch.profiler`` over ``steps`` decode steps fed ``seq``'s tokens
    after one warm step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api

    with torch.inference_mode():
        cache = api.init_cache(cfg, model, seq.shape[0], seq.shape[1])
        _, cache = api.decode_step(cfg, model, cache, seq[:, :1], 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(1, steps + 1):
                _, cache = api.decode_step(cfg, model, cache, seq[:, i:i + 1], i)
            torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps) for e in prof.key_averages()
               if e.self_device_time_total > 0 and str(e.device_type).endswith("CUDA")]
    kernels.sort(key=lambda k: -k[1])
    return sum(ms for _, ms in kernels), kernels[:3]


def _lm_margin(logits):
    """Top-2 margin of each position's logits (B, S)."""
    import torch

    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _lm_tokens_agree(label, got, want, margin, tol, coupled) -> int:
    """``got`` (B, n) equals ``want`` (B, n) in each row up to the first
    step whose top-2 margin (B, n) is 2 * tol or less (two logits each
    within tol may swap there); ``coupled`` (MoE: rows share expert
    capacity) ends every row at the first such step of any row.  Returns
    the count of tokens compared."""
    close = np.asarray(margin) <= 2 * tol
    if coupled:
        close = np.broadcast_to(close.any(axis=0), close.shape)
    upto = np.where(close.any(axis=1), close.argmax(axis=1), close.shape[1])
    for r, n in enumerate(upto):
        if not np.array_equal(np.asarray(got)[r, :n], np.asarray(want)[r, :n]):
            raise AssertionError(f"{label}: row {r}'s tokens {np.asarray(got)[r, :n]} != "
                                 f"{np.asarray(want)[r, :n]}")
    return int(upto.sum())


def _lm_serve(label, cfg, model, prompts, new, device):
    """``ServeEngine.generate`` twice on one model (no stop token, so every
    row runs every step): the same tokens both times.  Returns (tokens,
    the two registry snapshots, the two walls in s)."""
    from repro_torch.serve import ServeConfig, ServeEngine

    outs, snaps, walls = [], [], []
    for _ in range(2):
        engine = ServeEngine(cfg, model, ServeConfig(max_new_tokens=new, eos_id=-1),
                             device=device)
        t0 = time.perf_counter()
        outs.append(engine.generate(prompts))  # ends reading the tokens back
        walls.append(time.perf_counter() - t0)
        snaps.append(engine.registry.snapshot())
    if not np.array_equal(outs[0], outs[1]):
        raise AssertionError(f"{label}: two generate calls gave different tokens")
    if outs[0].shape != (prompts.shape[0], new) or outs[0].min() < 0 or \
            outs[0].max() >= cfg.vocab_size:
        raise AssertionError(f"{label}: tokens of shape {outs[0].shape} outside the vocab")
    return outs[0], snaps, walls


def check_lm_serve(device="cuda") -> dict:
    """The LM stack's inference path and its server on the card (phase
    ``lm_serve``), float32, TF32 off, weights drawn on the card from a
    seeded ``torch.Generator``: (a) llama3-8b and (b) mamba2-1.3b at their
    full configs, each served by ``ServeEngine.generate`` (LM_BATCH
    prompts of LM_PROMPT tokens, LM_NEW greedy tokens) twice with the same
    tokens, its cached path (decode steps fed the prompt and the generated
    tokens, prefill one token a step as the engine does) held within
    LM_TOL of one ``lm_forward`` over the same sequences at every position,
    and each greedy token equal to that forward's argmax wherever its top-2
    margin exceeds 2 LM_TOL; (c) granite-moe-3b-a800m at its full config,
    served twice with the same tokens (a decode step and a full forward
    route under different capacities, C depends on the token count, so
    they do not agree by design), then at full width with 2 layers the
    card against the port on the CPU with the same weights: every decode
    step's logits within LM_TOL, the greedy tokens equal where the margin
    allows, and the MoE dispatch dropping assignments (C = 1 at 2
    tokens); (d) every smoke config, the card against the CPU with the
    same weights: decode logits within LM_TOL_SMOKE and the served greedy
    tokens equal where the margin allows (encdec, which the engine
    refuses, through its decode steps with ``src_embeds``).  Prints for
    (a)-(c) the prefill seconds, the decode step's p50 / p90 from the
    registry, tokens/s and ``torch.cuda.max_memory_allocated``, the card
    line and every max abs logit error.  Returns the errors by check."""
    import gc

    import torch

    import repro_torch.models.mlp as mlp_mod
    from repro_torch.configs.registry import get_config, get_smoke_config, list_archs
    from repro_torch.models import api
    from repro_torch.models.common import param_count

    dev = torch.device(device)
    errs = {}
    print(f"  card: {gpu_line()}")

    def prompts_of(cfg, B, P, seed):
        return np.random.default_rng(seed).integers(3, cfg.vocab_size, (B, P)).astype(np.int32)

    def report(label, cfg, snaps, walls, n_params, t_init):
        warm = snaps[1]
        d = warm["decode_step_seconds"]
        print(f"  {label} {cfg.name}: {n_params} parameters ({4 * n_params / 1e9:.2f} GB "
              f"float32) drawn on the card in {t_init:.3f} s; generate {walls[0]:.3f} s "
              f"cold, {walls[1]:.3f} s warm: prefill {warm['prefill_seconds']['sum']:.4f} s "
              f"(cold {snaps[0]['prefill_seconds']['sum']:.4f}), decode step p50 "
              f"{d['p50'] * 1e3:.3f} ms p90 {d['p90'] * 1e3:.3f} ms over {d['count']} "
              f"steps, {warm['tokens_generated'] / walls[1]:.1f} tokens/s; "
              f"max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)

    def release():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def took(label, t0):
        print(f"  {label}: {time.perf_counter() - t0:.2f} s", flush=True)

    def full_width(label, name, forward):
        cfg = get_config(name)
        release()
        t0 = time.perf_counter()
        model = api.init_model(cfg, generator=torch.Generator(dev).manual_seed(SEED),
                               device=dev)
        torch.cuda.synchronize(dev)
        t_init = time.perf_counter() - t0
        prompts = prompts_of(cfg, LM_BATCH, LM_PROMPT, SEED)
        out, snaps, walls = _lm_serve(label, cfg, model, prompts, LM_NEW, dev)
        report(label, cfg, snaps, walls, param_count(model), t_init)
        seq = torch.from_numpy(np.concatenate([prompts, out], axis=1)).to(dev)
        busy, top = _lm_device_ms(cfg, model, seq)
        p50 = snaps[1]["decode_step_seconds"]["p50"] * 1e3
        print("    torch.profiler, 4 decode steps: " + (
            f"{busy:.3f} device ms a step, {busy / p50:.1%} of the p50 step "
            f"({1 - busy / p50:.1%} idle); costliest: " + "; ".join(
                f"{name[:60]} {ms:.3f} ms" for name, ms in top) if busy else
            "no kernel recorded, device time not measured"), flush=True)
        if forward:
            with torch.inference_mode():
                full = api.model_forward(cfg, model, {"tokens": seq})[0].float().cpu()
            cached = _lm_teacher_forced(cfg, model, seq)
            err = float((cached - full).abs().max())
            if not err <= LM_TOL:
                raise AssertionError(f"{label}: decode logits {err} from lm_forward's, "
                                     f"beyond {LM_TOL}")
            n = _lm_tokens_agree(label, out, full.argmax(-1)[:, LM_PROMPT - 1:-1],
                                 _lm_margin(full)[:, LM_PROMPT - 1:-1], LM_TOL, False)
            errs[label] = err
            print(f"    cached path vs lm_forward over {tuple(seq.shape)}: max abs logit "
                  f"error {err:.3g} (tolerance {LM_TOL}); {n} of {out.size} greedy tokens "
                  f"equal its argmax where the top-2 margin exceeds {2 * LM_TOL}", flush=True)
        del model

    with torch.inference_mode():
        for label, name, forward in (("(a)", "llama3-8b", True), ("(b)", "mamba2-1.3b", True),
                                     ("(c)", "granite-moe-3b-a800m", False)):
            t0 = time.perf_counter()
            full_width(label, name, forward)
            took(label, t0)
    release()

    # (c) at full width, 2 layers: the card against the CPU, drops counted
    t0 = time.perf_counter()
    cfg = get_config("granite-moe-3b-a800m").replace(n_layers=2)
    card = api.init_model(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    cpu = _lm_twin(cfg, card, "cpu")
    prompts = prompts_of(cfg, 2, 4, SEED + 1)
    dropped = [0]
    dispatch = mlp_mod._dispatch

    def counted(cfg_, xt, probs, C, Cp=None):
        res = dispatch(cfg_, xt, probs, C, Cp)
        if xt.device.type == dev.type:
            dropped[0] += int((~res[3]).sum())
        return res

    mlp_mod._dispatch = counted
    try:
        out_card = _lm_serve("(c) 2 layers, card", cfg, card, prompts, 4, dev)[0]
    finally:
        mlp_mod._dispatch = dispatch
    out_cpu = _lm_serve("(c) 2 layers, CPU", cfg, cpu, prompts, 4, "cpu")[0]
    seq = torch.from_numpy(np.concatenate([prompts, out_cpu], axis=1))
    on_cpu = _lm_teacher_forced(cfg, cpu, seq)
    on_card = _lm_teacher_forced(cfg, card, seq.to(dev))
    err = float((on_card - on_cpu).abs().max())
    if not err <= LM_TOL or dropped[0] < 1:
        raise AssertionError(f"(c) 2 layers: card logits {err} from the CPU's (tolerance "
                             f"{LM_TOL}), {dropped[0]} assignments dropped")
    n = _lm_tokens_agree("(c) 2 layers", out_card, out_cpu, _lm_margin(on_cpu)[:, 3:-1],
                         LM_TOL, True)
    errs["(c) 2 layers"] = err
    print(f"  (c) {cfg.name} at 2 layers (B = 2, 4 + 4 tokens, C = 1 a decode step): card "
          f"vs CPU max abs logit error {err:.3g} (tolerance {LM_TOL}); {dropped[0]} "
          f"assignments dropped on the card; {n} of {out_card.size} greedy tokens equal",
          flush=True)
    del cpu, card
    took("(c) 2 layers", t0)

    # (d) every smoke config: the card against the CPU
    t0 = time.perf_counter()
    for name in list_archs(include_comet=False):
        cfg = get_smoke_config(name)
        card = api.init_model(cfg, generator=torch.Generator(dev).manual_seed(SEED),
                              device=dev)
        cpu = _lm_twin(cfg, card, "cpu")
        prompts = prompts_of(cfg, LM_BATCH, LM_PROMPT, SEED + 2)
        if cfg.family == "encdec":
            rng = np.random.default_rng(SEED + 3)
            src = torch.from_numpy(rng.standard_normal((LM_BATCH, 6, cfg.d_model))
                                   .astype(np.float32))
            seq = torch.from_numpy(np.concatenate(
                [prompts, rng.integers(3, cfg.vocab_size, (LM_BATCH, LM_NEW))], axis=1))
            on_cpu = _lm_teacher_forced(cfg, cpu, seq, src)
            on_card = _lm_teacher_forced(cfg, card, seq.to(dev), src.to(dev))
            n = _lm_tokens_agree(name, on_card.argmax(-1), on_cpu.argmax(-1),
                                 _lm_margin(on_cpu), LM_TOL_SMOKE, False)
            how = "decode steps with src_embeds (the engine refuses encdec)"
        else:
            out_card = _lm_serve(f"(d) {name}, card", cfg, card, prompts, LM_NEW, dev)[0]
            out_cpu = _lm_serve(f"(d) {name}, CPU", cfg, cpu, prompts, LM_NEW, "cpu")[0]
            seq = torch.from_numpy(np.concatenate([prompts, out_cpu], axis=1))
            on_cpu = _lm_teacher_forced(cfg, cpu, seq)
            on_card = _lm_teacher_forced(cfg, card, seq.to(dev))
            n = _lm_tokens_agree(name, out_card, out_cpu,
                                 _lm_margin(on_cpu)[:, LM_PROMPT - 1:-1], LM_TOL_SMOKE,
                                 cfg.family == "moe")
            how = "served greedy tokens"
        err = float((on_card - on_cpu).abs().max())
        if not err <= LM_TOL_SMOKE:
            raise AssertionError(f"(d) {name}: card logits {err} from the CPU's, beyond "
                                 f"{LM_TOL_SMOKE}")
        errs[f"(d) {name}"] = err
        print(f"  (d) {cfg.name}: card vs CPU max abs logit error {err:.3g} over "
              f"{tuple(seq.shape)} decode steps; {n} {how} equal", flush=True)
        del cpu, card
    took("(d)", t0)
    release()
    return errs


def _timed_checkpoints(mgr, log: dict):
    """Record on ``log`` the seconds of each of ``mgr``'s saves (the call,
    less the wait for the write before it: the host copy), its writes (the
    writer thread) and restores."""
    save, write, wait, restore = mgr.save, mgr._write, mgr.wait, mgr.restore
    waited = [0.0]

    def timed_wait():
        t0 = time.perf_counter()
        wait()
        waited[0] += time.perf_counter() - t0

    def timed_save(step, tree, blocking=False):
        waited[0] = 0.0
        t0 = time.perf_counter()
        save(step, tree, blocking)
        log.setdefault("save", []).append(time.perf_counter() - t0 - waited[0])

    def timed_write(step, leaves, treedef):
        t0 = time.perf_counter()
        write(step, leaves, treedef)
        log.setdefault("write", []).append(time.perf_counter() - t0)

    def timed_restore(template, step=None):
        t0 = time.perf_counter()
        out = restore(template, step)
        log.setdefault("restore", []).append(time.perf_counter() - t0)
        return out

    mgr.save, mgr._write, mgr.wait, mgr.restore = timed_save, timed_write, timed_wait, \
        timed_restore


def _profile_second_step(trainer, dev) -> dict:
    """Wrap ``trainer``'s step so that its second call runs under
    ``torch.profiler`` (CUDA activity only: recording the CPU side of its
    ~10,000 launches took 12.5 s on an H100's host), synchronized; the dict
    returned gets the profile (``"prof"``) and that step's wall
    (``"wall"``).  The profiler changes no value."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step_fn, calls, out = trainer._step_fn, [0], {}

    def profiled(params, opt_state, batch):
        calls[0] += 1
        if calls[0] != 2:
            return step_fn(params, opt_state, batch)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = step_fn(params, opt_state, batch)
            torch.cuda.synchronize(dev)
        out.update(prof=prof, wall=time.perf_counter() - t0)
        return res

    trainer._step_fn = profiled
    return out


def _states_equal(a, b) -> list:
    """The names of the tensors (parameters, ``mu``, ``nu``, ``count``)
    in which two train states differ."""
    import torch

    pa, pb = dict(a.params.named_parameters()), dict(b.params.named_parameters())
    bad = [n for n in pa if not torch.equal(pa[n], pb[n])]
    bad += [f"{k}.{n}" for k in ("mu", "nu") for n in pa
            if not torch.equal(a.opt_state[k][n], b.opt_state[k][n])]
    if not torch.equal(a.opt_state["count"], b.opt_state["count"]):
        bad.append("count")
    return bad


def _train_twins(label, cfg, card, batch, seq, seed, loss_tol, dev, repeat=False) -> dict:
    """TRAIN_TWIN_STEPS train steps (``make_train_step``, AdamW defaults)
    of ``card`` on ``dev`` and of its CPU twin on the same batches: per
    step the loss within ``loss_tol`` and ``grad_norm`` within
    TRAIN_GNORM_RTOL relative; then the updated parameters as the
    TRAIN_PARAM_* bounds say.  ``repeat``: a second card twin takes the
    same steps and must end bit for bit equal to ``card``.  Returns the
    errors."""
    import torch

    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step

    cpu = _lm_twin(cfg, card, "cpu")
    runs = [("card", card, dev), ("cpu", cpu, "cpu")]
    if repeat:
        runs.append(("again", _lm_twin(cfg, card, dev), dev))
    opt = AdamWConfig()
    step_fn = make_train_step(cfg, opt)
    states = {who: adamw_init(model) for who, model, _ in runs}
    src = SyntheticTokens(cfg.vocab_size, batch, seq, seed=seed, family=cfg.family,
                          d_model=cfg.d_model)
    out = {"loss": 0.0, "grad_norm": 0.0}
    for step in range(TRAIN_TWIN_STEPS):
        host = src.batch_at(step)
        m = {}
        for who, model, where in runs:
            b = {k: torch.from_numpy(v).to(where) for k, v in host.items()}
            m[who] = {k: float(v) for k, v in step_fn(model, states[who], b)[2].items()}
        if not all(np.isfinite(v) for v in (m["card"]["loss"], m["cpu"]["loss"])):
            raise AssertionError(f"{label}: step {step} losses {m}")
        err = abs(m["card"]["loss"] - m["cpu"]["loss"])
        rel = abs(m["card"]["grad_norm"] - m["cpu"]["grad_norm"]) / m["cpu"]["grad_norm"]
        if not (err <= loss_tol and rel <= TRAIN_GNORM_RTOL):
            raise AssertionError(f"{label}: step {step} loss {m['card']['loss']} vs "
                                 f"{m['cpu']['loss']} (tolerance {loss_tol}), grad_norm "
                                 f"{m['card']['grad_norm']} vs {m['cpu']['grad_norm']} "
                                 f"(relative {rel:.3g}, tolerance {TRAIN_GNORM_RTOL})")
        out["loss"] = max(out["loss"], err)
        out["grad_norm"] = max(out["grad_norm"], rel)
    total = beyond = 0
    worst = 0.0
    cap = 3 * opt.lr * TRAIN_TWIN_STEPS
    named_cpu = dict(cpu.named_parameters())
    with torch.no_grad():
        for n, p in card.named_parameters():
            d = (p.cpu() - named_cpu[n]).abs()
            total += d.numel()
            beyond += int((d > TRAIN_PARAM_TOL).sum())
            worst = max(worst, float(d.max()))
    if beyond > TRAIN_PARAM_FRAC * total or worst > cap:
        raise AssertionError(f"{label}: {beyond} of {total} parameters beyond "
                             f"{TRAIN_PARAM_TOL} (at most {TRAIN_PARAM_FRAC:.0e} of them), "
                             f"max abs error {worst:.3g} (cap {cap:.3g})")
    out.update(params=worst, beyond=beyond, total=total)
    if repeat:
        from repro_torch.train.trainer import TrainState

        bad = _states_equal(TrainState(card, states["card"]),
                            TrainState(runs[2][1], states["again"]))
        if bad:
            raise AssertionError(f"{label}: two runs on the card differ in {bad[:5]} "
                                 f"({len(bad)} tensors)")
    return out


def check_lm_train(device="cuda") -> dict:
    """LM training on the card (phase ``lm_train``), float32, TF32 off,
    weights drawn on the card from a seeded ``torch.Generator``, AdamW's
    defaults (lr 3e-4, no schedule).  (a) qwen1.5-0.5b at its full config
    (24 x 1,024, vocab 151,936) through ``Trainer``: TRAIN_BATCH x
    TRAIN_SEQ tokens a step, TRAIN_STEPS steps, a checkpoint every
    TRAIN_CKPT_EVERY into a temporary directory, every loss finite; a
    second run with ``fail_at_step = TRAIN_FAIL_AT`` raises
    ``SimulatedFailure``, a third resumes from step TRAIN_CKPT_EVERY and
    finishes: its parameters, moments and count ``torch.equal`` the first
    run's and its losses equal the first run's at the same steps.  Prints
    the parameter count, step p50 / p90 from ``history``, tokens/s,
    ``max_memory_allocated``, the seconds of each save (the host copy), its
    write and the restore, and the first and last loss.  (b) qwen1.5-0.5b,
    mamba2-1.3b and granite-moe-3b-a800m at full width with 2 layers (and a
    second run on the card, bit for bit the first), and (c) every smoke
    config: TRAIN_TWIN_STEPS train steps on the card and of its CPU twin
    (``_train_twins``).  Returns the errors by check."""
    import gc
    import math
    import tempfile

    import torch

    from repro_torch.configs.registry import get_config, get_smoke_config, list_archs
    from repro_torch.models import api
    from repro_torch.models.common import param_count
    from repro_torch.train.trainer import SimulatedFailure, Trainer, TrainerConfig

    dev = torch.device(device)
    errs = {}
    print(f"  card: {gpu_line()}")

    def release():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def took(label, t0):
        print(f"  {label}: {time.perf_counter() - t0:.2f} s", flush=True)

    # (a) qwen1.5-0.5b at its full config through Trainer, with a restart
    t0 = time.perf_counter()
    cfg = get_config("qwen1.5-0.5b")
    root = tempfile.mkdtemp(prefix="lm_train_")
    try:
        def trainer(ckpt_dir, fail_at=None):
            t = Trainer(cfg, TrainerConfig(
                steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY, log_every=1, ckpt_dir=ckpt_dir,
                seed=SEED, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, fail_at_step=fail_at),
                device=dev)
            log = {}
            _timed_checkpoints(t.ckpt, log)
            return t, log

        release()
        t1, log1 = trainer(os.path.join(root, "a"))
        s1 = t1.train()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [h["loss"] for h in t1.history]
        if [h["step"] for h in t1.history] != list(range(1, TRAIN_STEPS + 1)) or \
                not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"(a) history {t1.history}")
        times = sorted(h["time"] for h in t1.history)
        p50, p90 = statistics.median(times), times[min(len(times) - 1,
                                                       int(0.9 * len(times)))]
        n_params = param_count(s1.params)
        print(f"  (a) {cfg.name}: {n_params} parameters; B = {TRAIN_BATCH}, S = {TRAIN_SEQ}, "
              f"{TRAIN_STEPS} steps: step p50 {p50 * 1e3:.1f} ms p90 {p90 * 1e3:.1f} ms "
              f"(first {t1.history[0]['time'] * 1e3:.1f} ms), "
              f"{TRAIN_BATCH * TRAIN_SEQ / p50:.0f} tokens/s at p50; max_memory_allocated "
              f"{peak / 2**30:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({', '.join(f'{x:.4f}' for x in losses)}); checkpoints "
              f"{t1.ckpt.available_steps()}: save (host copy) "
              f"{', '.join(f'{x:.2f}' for x in log1['save'])} s, write "
              f"{', '.join(f'{x:.2f}' for x in log1['write'])} s", flush=True)

        t2, _ = trainer(os.path.join(root, "b"), fail_at=TRAIN_FAIL_AT)
        try:
            t2.train()
        except SimulatedFailure:
            pass
        else:
            raise AssertionError("(a) the run with fail_at_step did not fail")
        if t2.ckpt.available_steps() != [TRAIN_CKPT_EVERY]:
            raise AssertionError(f"(a) the failed run left {t2.ckpt.available_steps()}")
        del t2
        gc.collect()
        t3, log3 = trainer(os.path.join(root, "b"))
        t_r = time.perf_counter()
        state = t3.resume_or_init()
        torch.cuda.synchronize(dev)
        t_r = time.perf_counter() - t_r
        if state.step != TRAIN_CKPT_EVERY:
            raise AssertionError(f"(a) resumed at {state.step}")
        prof = _profile_second_step(t3, dev)
        s3 = t3.train(state)
        bad = _states_equal(s1, s3)
        again = [h["loss"] for h in t3.history]
        if s3.step != TRAIN_STEPS or bad or again != losses[TRAIN_CKPT_EVERY:]:
            raise AssertionError(f"(a) restart not bit-exact: step {s3.step}, tensors "
                                 f"{bad[:5]} ({len(bad)}), losses {again} vs {losses}")
        print(f"  (a) failed at step {TRAIN_FAIL_AT}, resumed from {TRAIN_CKPT_EVERY}: "
              f"restore {log3['restore'][0]:.2f} s (resume_or_init {t_r:.2f} s with the "
              f"weights drawn); parameters, moments and count torch.equal the "
              f"uninterrupted run's, losses of steps {TRAIN_CKPT_EVERY + 1}-{TRAIN_STEPS} "
              f"equal", flush=True)
        errs["(a) restart"] = 0.0
        kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof["prof"].key_averages()
                   if e.self_device_time_total > 0 and str(e.device_type).endswith("CUDA")]
        kernels.sort(key=lambda k: -k[1])
        busy = sum(ms for _, ms, _ in kernels)
        print("  (a) torch.profiler, the resumed run's second step: " + (
            f"{busy:.3f} device ms, {sum(n for *_, n in kernels)} kernel launches, "
            f"{busy / (p50 * 1e3):.1%} of the p50 step ({1 - busy / (p50 * 1e3):.1%} idle; "
            f"{prof['wall'] * 1e3:.1f} ms of wall with the profiler on); costliest: "
            + "; ".join(f"{name[:60]} {ms:.3f} ms x{n}" for name, ms, n in kernels[:4])
            if busy else "no kernel recorded, device time not measured"), flush=True)
        del s1, s3, state, t1, t3
    finally:
        shutil.rmtree(root, ignore_errors=True)
    took("(a)", t0)
    release()

    # (b) full width, 2 layers: the card against the CPU
    t0 = time.perf_counter()
    for name in ("qwen1.5-0.5b", "mamba2-1.3b", "granite-moe-3b-a800m"):
        cfg = get_config(name).replace(n_layers=2)
        card = api.init_model(cfg, generator=torch.Generator(dev).manual_seed(SEED),
                              device=dev)
        e = _train_twins(f"(b) {name}", cfg, card, TRAIN_TWIN_BATCH, TRAIN_TWIN_SEQ,
                         SEED + 4, LM_TOL, dev, repeat=True)
        errs[f"(b) {name}"] = e
        print(f"  (b) {name} at 2 layers ({param_count(card)} parameters, B = "
              f"{TRAIN_TWIN_BATCH}, S = {TRAIN_TWIN_SEQ}, {TRAIN_TWIN_STEPS} steps): card vs "
              f"CPU loss {e['loss']:.3g} (tolerance {LM_TOL}), grad_norm relative "
              f"{e['grad_norm']:.3g} ({TRAIN_GNORM_RTOL}); parameters max abs "
              f"{e['params']:.3g}, {e['beyond']} of {e['total']} beyond {TRAIN_PARAM_TOL}; "
              f"a second run on the card equal bit for bit", flush=True)
        del card
        release()
    took("(b)", t0)

    # (c) every smoke config: the card against the CPU
    t0 = time.perf_counter()
    for name in list_archs(include_comet=False):
        cfg = get_smoke_config(name)
        card = api.init_model(cfg, generator=torch.Generator(dev).manual_seed(SEED),
                              device=dev)
        e = _train_twins(f"(c) {name}", cfg, card, TRAIN_TWIN_BATCH, TRAIN_SMOKE_SEQ,
                         SEED + 5, LM_TOL_SMOKE, dev)
        errs[f"(c) {name}"] = e
        print(f"  (c) {cfg.name}: card vs CPU loss {e['loss']:.3g} (tolerance "
              f"{LM_TOL_SMOKE}), grad_norm relative {e['grad_norm']:.3g}; parameters max "
              f"abs {e['params']:.3g}, {e['beyond']} of {e['total']} beyond "
              f"{TRAIN_PARAM_TOL}", flush=True)
    took("(c)", t0)
    release()
    return errs


DRYRUN_CELLS = (("llama3-8b", "train_4k"), ("comet_2way", "paper"))


def start_dryruns(work: Path) -> list:
    """Phase mesh (a)'s dry-runs, a CPU process each, started before the
    first phase so that they run beside the others (they do not touch the
    card); ``check_mesh`` reads them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        with open(work / f"{arch}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--out", str(work / "dryrun"), "--force"],
                env=env, cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT))
    return procs


def check_mesh(work: Path, dry: list, device="cuda") -> dict:
    """Phase mesh: the dry-run and runs on a ``DeviceMesh``.  (a) the
    dry-run (``python -m repro_torch.launch.dryrun``) of llama3-8b train_4k
    on the 16 x 16 mesh and of comet_2way, the CPU processes
    ``start_dryruns`` started in ``work``; each cell's JSON has ``repro``'s
    keys and its terms are printed.  (b) qwen1.5-0.5b at its full config
    through ``Trainer``, MESH_STEPS steps of MESH_BATCH x MESH_SEQ, on a
    one-rank NCCL mesh:
    losses and parameters ``torch.equal`` the run without a mesh; its
    ``ServeEngine`` greedy tokens (LM_BATCH prompts) likewise.  Two ranks
    on the one card are not run: NCCL refuses two ranks on one card and
    gloo crashes on DTensor's collectives on CUDA tensors (PERF.md § 6);
    ``tests/test_torch_sharding.py`` holds two gloo ranks on the CPU.
    Returns the errors."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.optim.adamw import named_params
    from repro_torch.parallel.sharding import full_tensor
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device(device)
    errs = {}
    t0 = time.perf_counter()
    # (b) one rank over NCCL on the card, against no mesh
    cfg = get_config("qwen1.5-0.5b")

    def train(mesh, sub):
        t = Trainer(cfg, TrainerConfig(steps=MESH_STEPS, ckpt_every=MESH_STEPS + 1,
                                       log_every=1, batch=MESH_BATCH, seq_len=MESH_SEQ,
                                       seed=SEED, ckpt_dir=str(work / sub)),
                    mesh=mesh, device=dev)
        state = t.train(t.init_state())
        return ([h["loss"] for h in t.history],
                {n: full_tensor(p.detach()) for n, p in named_params(state.params).items()})

    t1 = time.perf_counter()
    losses0, params0 = train(None, "plain")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=LM_NEW, eos_id=-1)
    model = api.init_model(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    toks0 = ServeEngine(cfg, model, scfg, device=dev).generate(prompts)
    print(f"  (b) without a mesh: {time.perf_counter() - t1:.1f} s, losses {losses0}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{work}/pg_store", world_size=1, rank=0)
    try:
        mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
        t1 = time.perf_counter()
        losses1, params1 = train(mesh, "mesh")
        toks1 = ServeEngine(cfg, model, scfg, mesh=mesh, device=dev).generate(prompts)
        print(f"  (b) one-rank {dist.get_backend()} mesh: {time.perf_counter() - t1:.1f} s, "
              f"losses {losses1}")
    finally:
        dist.destroy_process_group()
    differ = [n for n in params0 if not torch.equal(params0[n], params1[n])]
    errs["trainer"] = 0.0 if losses0 == losses1 and not differ else 1.0
    errs["serve"] = 0.0 if np.array_equal(toks0, toks1) else 1.0
    print(f"  (b) Trainer(mesh=) bitwise: losses {losses0 == losses1}, parameters "
          f"{len(params0) - len(differ)} / {len(params0)} equal; ServeEngine(mesh=) "
          f"greedy tokens equal: {np.array_equal(toks0, toks1)} ({toks0.shape})")
    del params0, params1, model
    # (a) the dry-run's two cells
    for (arch, shape), p in zip(DRYRUN_CELLS, dry):
        rc = p.wait(timeout=900)
        log = (work / f"{arch}.log").read_text()
        if rc:
            print(log[-3000:])
            raise RuntimeError(f"phase mesh (a): dry-run {arch} exited {rc}")
        path = work / "dryrun" / f"{arch}__{shape}__pod_16x16.json"
        cell = json.loads(path.read_text())
        rf = cell["roofline"]
        print("  (a) dry-run " + json.dumps({
            "arch": arch, "shape": shape, "lower_s": cell["lower_s"],
            "flops_per_device": rf["flops_per_device"],
            "useful_flops_ratio": cell.get("useful_flops_ratio"),
            "t_compute": rf["t_compute"], "t_memory": rf["t_memory"],
            "t_collective": rf["t_collective"], "bottleneck": rf["bottleneck"],
            "collectives": rf["collectives"]["counts"],
            "temp_bytes": rf["memory"]["temp_bytes"]}))
        if "useful_flops_ratio" in cell and not 0.3 < cell["useful_flops_ratio"] <= 1.0:
            errs[f"dryrun_{arch}"] = cell["useful_flops_ratio"]
    print(f"  phase mesh: {time.perf_counter() - t0:.1f} s of work")
    bad = {k: v for k, v in errs.items() if v}
    if bad:
        raise AssertionError(f"phase mesh: {bad}")
    return errs


def similarity_phases() -> list:
    """Phases environment to combines (1-15 of the docstring); returns the
    kernels' record."""
    import torch

    from dataclasses import replace

    from repro_torch.api import (
        CCC,
        SimilarityEngine,
        SimilarityRequest,
        get_metric,
        register_metric,
    )
    from repro_torch.core.metric_spec import CZEKANOWSKI
    from repro_torch.core.mgemm import mgemm_xla
    from repro_torch.core.metrics import safe_denom
    from repro_torch.core.synthetic import random_integer_vectors
    from repro_torch.core.tile_executor import TileExecutor
    from repro_torch.kernels import build
    from repro_torch.kernels.mgemm import (
        BT,
        metric2_tiles,
        metric2_tiles_plain,
        metric2_tri,
        metric2_tri_plain,
        mgemm,
        unpack_tri_tiles,
    )
    from repro_torch.kernels.mgemm.kernel import tri_splits
    from repro_torch.core.twoway import resolve_config
    from repro_torch.kernels.czek3 import (
        minplus3_plain,
        plane3_plain,
        threeway_batch,
        threeway_batch_levels,
        threeway_step,
    )
    from repro_torch.kernels.mgemm_levels import (
        encode_bitplanes_np,
        metric2_levels,
        metric2_levels_tri,
        mgemm_levels,
        mgemm_levels_xla,
        plane_rect_plain,
        plane_tri_plain,
        slice_planes_vectors,
        values_from_planes,
    )
    from repro_torch.kernels.popgemm import (
        metric2_pop,
        metric2_pop_plain,
        metric2_pop_tri,
        metric2_pop_tri_plain,
        threeway_batch_pop,
        threeway_batch_pop_plain,
    )

    dev = torch.device("cuda")
    czek_tile = CZEKANOWSKI.assemble_tile
    ccc_tile = CCC.assemble_tile

    def custom_tile(acc, sa, sb):  # a user epilogue: raw kernel + torch
        return acc / safe_denom(sa + sb + 1.0)

    with phase("environment"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = gpu_line()
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
        print(f"nvidia-smi: {card}")

    with phase("build"):
        # the fixed sources and every combine phase combines compiles, one
        # nvcc each, all at once, before anything is timed
        registered = combine_set()
        combine_libs = combine_libraries({**registered, **nonzero_combines()})
        ring_libs = ring_libraries()  # the widened rings', for phase combines (e) / (f)
        built = {lib for _, lib in combine_libs}
        combine_libs += [(name, lib) for name, lib in ring_libs if lib not in built]
        t0 = time.perf_counter()
        paths = build.build_all([lib for _, lib in combine_libs])
        print(f"built {sorted(paths)} and {len(combine_libs)} combine libraries "
              f"({len(ring_libs)} of the widened rings) in "
              f"{time.perf_counter() - t0:.2f} s")
        for path in paths.values():
            log = path.with_suffix(".log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas {path.stem}: {line.strip()}")
        for cname, lib in combine_libs:
            path = lib.path()
            print(f"  combine {cname!r} on {lib.dtype}: {path.name}", flush=True)
            for kernel, regs, stores, loads in ptxas_report(path.with_suffix(".log")):
                print(f"    ptxas {kernel}: {regs} registers, {stores} / {loads} bytes "
                      f"spill stores / loads")

    kernels = {
        "mgemm": dict(
            wrapper=mgemm, route="cuda",
            source="src/repro_torch/csrc/mgemm_rect.cu",
            replaces="src/repro/kernels/mgemm/kernel.py:190", errs=[]),
        "metric2_tiles": dict(
            wrapper=metric2_tiles, route="cuda",
            source="src/repro_torch/csrc/mgemm_rect.cu",
            replaces="src/repro/kernels/mgemm/kernel.py:238", errs=[]),
        "metric2_tri": dict(
            wrapper=metric2_tri, route="cuda",
            source="src/repro_torch/csrc/mgemm_tri.cu",
            replaces="src/repro/kernels/mgemm/kernel.py:290", errs=[]),
        "metric2_levels_tri": dict(
            wrapper=metric2_levels_tri, route="cuda",
            source="src/repro_torch/csrc/plane_tri.cu",
            replaces="src/repro/kernels/mgemm_levels/kernel.py:265", errs=[]),
        "metric2_pop_tri": dict(
            wrapper=metric2_pop_tri, route="cuda",
            source="src/repro_torch/csrc/plane_tri.cu",
            replaces="src/repro/kernels/popgemm/kernel.py:213", errs=[]),
        "metric2_levels": dict(
            wrapper=metric2_levels, route="cuda",
            source="src/repro_torch/csrc/plane_rect.cu",
            replaces="src/repro/kernels/mgemm_levels/kernel.py:208", errs=[]),
        "metric2_pop": dict(
            wrapper=metric2_pop, route="cuda",
            source="src/repro_torch/csrc/plane_rect.cu",
            replaces="src/repro/kernels/popgemm/kernel.py:153", errs=[]),
        "threeway_batch_levels": dict(
            wrapper=threeway_batch_levels, route="cuda",
            source="src/repro_torch/csrc/plane3.cu",
            replaces="src/repro/kernels/czek3/kernel.py:258", errs=[]),
        "threeway_batch_pop": dict(
            wrapper=threeway_batch_pop, route="cuda",
            source="src/repro_torch/csrc/plane3.cu",
            replaces="src/repro/kernels/popgemm/kernel.py:306", errs=[]),
        "threeway_step": dict(
            wrapper=threeway_step, route="cuda",
            source="src/repro_torch/csrc/minplus3.cu",
            replaces="src/repro/kernels/czek3/kernel.py:87", errs=[]),
        "threeway_batch": dict(
            wrapper=threeway_batch, route="cuda",
            source="src/repro_torch/csrc/minplus3.cu",
            replaces="src/repro/kernels/czek3/kernel.py:176", errs=[]),
        "mgemm_levels": dict(
            wrapper=mgemm_levels, route="cuda",
            source="src/repro_torch/csrc/mgemm_levels.cu",
            replaces="src/repro/kernels/mgemm_levels/kernel.py:63", errs=[]),
        # the float32 forms of rows 1 and 11 (dosage data): the same
        # wrappers and kernels; launches are counted on the float32 campaigns
        "mgemm float32": dict(
            wrapper=mgemm, route="cuda",
            source="src/repro_torch/csrc/mgemm_rect.cu",
            replaces="src/repro/kernels/mgemm/kernel.py:190", errs=[]),
        "threeway_batch min float32": dict(
            wrapper=threeway_batch, route="cuda",
            source="src/repro_torch/csrc/minplus3.cu",
            replaces="src/repro/kernels/czek3/kernel.py:176", errs=[]),
        "threeway_batch ccc float32": dict(
            wrapper=threeway_batch, route="cuda",
            source="src/repro_torch/csrc/minplus3.cu",
            replaces="src/repro/kernels/czek3/kernel.py:176", errs=[]),
    }
    # any other registered combine: rows 3, 2, 11 and 10 on the combine
    # compiled into its own library (the kernel bodies of these headers,
    # combine_entry.cuh), records of their own; launches are counted on
    # phase combines' campaigns
    for name, row, wrapper, source, line in [
            ("metric2_tri[expr]", "3", metric2_tri, "mgemm_tri.cuh", "mgemm/kernel.py:290"),
            ("metric2_tiles[expr]", "2", metric2_tiles, "mgemm_rect.cuh",
             "mgemm/kernel.py:238"),
            ("threeway_batch[expr]", "11", threeway_batch, "minplus3.cuh",
             "czek3/kernel.py:176"),
            ("threeway_step[expr]", "10", threeway_step, "minplus3.cuh",
             "czek3/kernel.py:87")]:
        kernels[name] = dict(wrapper=wrapper, route="cuda",
                             source=f"src/repro_torch/csrc/{source}",
                             replaces=f"src/repro/kernels/{line}", errs=[])
    expr_forms = ("metric2_tri[expr]", "metric2_tiles[expr]", "threeway_batch[expr]",
                  "threeway_step[expr]")
    float32_forms = ("mgemm float32", "threeway_batch min float32",
                     "threeway_batch ccc float32")
    kernels2 = ("metric2_tri", "metric2_levels_tri", "metric2_pop_tri")
    kernels3 = ("metric2_levels", "metric2_pop", "threeway_batch_levels",
                "threeway_batch_pop", "mgemm", "threeway_batch", "mgemm_levels")
    # entry points of the TPU table that no single-device campaign of the
    # phases before ``stream`` calls: the off-diagonal min-plus block (row
    # 2, whose main-path launch is the delta rectangle under impl="pallas",
    # phase stream) and the single-column 3-way step (row 10, checked and
    # timed only)
    off_path = ("metric2_tiles", "threeway_step")

    with phase("data"):
        V2 = random_integer_vectors(N_F, N_V, max_value=2, seed=SEED)
        V1 = random_integer_vectors(N_F, N_V, max_value=1, seed=SEED + 1)
        V3 = random_integer_vectors(N_F, N_V3, max_value=3, seed=SEED + 4)
        # imputed genotype dosages: the quarter grid {0, 0.25, ..., 2}, which
        # resolve_config carries as float32; every product and partial sum
        # is a multiple of 2^-6 below 2^24 * 2^-6, so fp32 sums are exact
        D = random_integer_vectors(N_F, N_V3, max_value=8, seed=SEED + 6) / 4
        print(f"V2 {V2.shape} in {{0,1,2}}, V1 {V1.shape} in {{0,1}}, "
              f"V3 {V3.shape} in {{0,1,2,3}}, D {D.shape} {D.dtype} in {{0, 0.25, ..., 2}}")

    with phase("kernels"):
        rng = np.random.default_rng(SEED)
        # ragged shapes: n_v not a tile multiple, n_f not a multiple of 8 or
        # 32, an all-zero vector; every epilogue id (+ a user epilogue);
        # fp32 and bf16 out
        epilogues = [("raw", None), ("czek", czek_tile), ("ccc", ccc_tile),
                     ("custom", custom_tile)]
        for n_f, n_v in [(77, 300), (1000, 1), (333, 129)]:
            for levels in (1, 2, 3):
                V = rng.integers(0, levels + 1, size=(n_f, n_v)).astype(np.float32)
                V[:, n_v // 2] = 0
                P = torch.as_tensor(encode_bitplanes_np(V, levels), device=dev)
                s_p = CZEKANOWSKI.stat(values_from_planes(P))
                for (ename, epi) in epilogues:
                    for out in (torch.float32, torch.bfloat16):
                        tag = f"n_f={n_f} n_v={n_v} L={levels} {ename} {out}"
                        if levels == 1:
                            check_equal(
                                f"metric2_pop_tri {tag}",
                                metric2_pop_tri(P, s_p, epilogue=epi, out_dtype=out),
                                metric2_pop_tri_plain(P, s_p, epilogue=epi, out_dtype=out),
                                kernels["metric2_pop_tri"]["errs"])
                        check_equal(
                            f"metric2_levels_tri {tag}",
                            metric2_levels_tri(P, s_p, epilogue=epi, out_dtype=out),
                            plane_tri_plain(P, s_p, epilogue=epi, out_dtype=out),
                            kernels["metric2_levels_tri"]["errs"])
                        for in_dtype in (torch.int8, torch.float32):
                            Vd = torch.as_tensor(V, device=dev).to(in_dtype)
                            for cname, comb, spec in (("min", torch.minimum, CZEKANOWSKI),
                                                      ("mul", CCC.combine, CCC)):
                                s_v = spec.stat(Vd)
                                check_equal(
                                    f"metric2_tri {tag} {cname} {in_dtype}",
                                    metric2_tri(Vd, s_v, combine=comb, epilogue=epi,
                                                out_dtype=out),
                                    metric2_tri_plain(Vd, s_v, combine=comb,
                                                      epilogue=epi, out_dtype=out),
                                    kernels["metric2_tri"]["errs"])
        # row 3 at a ragged shape it does not split: 528 packed tiles fill
        # whole waves of the card's slots, where the few tiles of the shapes
        # above split the contraction over grid.z (slab pass included)
        V = rng.integers(0, 3, size=(77, 4000)).astype(np.float32)
        V[:, 2000] = 0
        for (ename, epi) in epilogues:
            for out in (torch.float32, torch.bfloat16):
                for in_dtype in (torch.int8, torch.float32):
                    Vd = torch.as_tensor(V, device=dev).to(in_dtype)
                    for cname, comb, spec in (("min", torch.minimum, CZEKANOWSKI),
                                              ("mul", CCC.combine, CCC)):
                        s_v = spec.stat(Vd)
                        check_equal(
                            f"metric2_tri n_f=77 n_v=4000 {ename} {out} {cname} {in_dtype}",
                            metric2_tri(Vd, s_v, combine=comb, epilogue=epi, out_dtype=out),
                            metric2_tri_plain(Vd, s_v, combine=comb, epilogue=epi,
                                              out_dtype=out),
                            kernels["metric2_tri"]["errs"])
        tri_forms = {(n_f, n_v, str(dt)[6:]): tri_splits(torch.empty((n_f, n_v), dtype=dt,
                                                                     device=dev))
                     for n_f, n_v in [(77, 300), (1000, 1), (333, 129), (77, 4000)]
                     for dt in (torch.int8, torch.float32)}
        print(f"  metric2_tri splits over grid.z at the ragged shapes: {tri_forms}")
        if {n > 1 for n in tri_forms.values()} != {True, False}:
            raise AssertionError("row 3's ragged checks must run its split and unsplit forms")
        # rows 5/7 and 12/9 at ragged shapes: m, n and L not tile multiples,
        # kb not a multiple of 4, plane counts 1-3; the operands are strided
        # views of one payload, as the 3-way pipeline slices are, and each
        # kernel must also equal itself on contiguous copies
        for n_f, m, n, j0, L in [(77, 300, 129, 17, 37), (1000, 1, 37, 0, 1),
                                 (333, 129, 257, 200, 50)]:
            for levels in (1, 2, 3):
                V = rng.integers(0, levels + 1, size=(n_f, m + n)).astype(np.float32)
                V[:, m // 2] = 0
                P = torch.as_tensor(encode_bitplanes_np(V, levels), device=dev)
                s_p = CZEKANOWSKI.stat(values_from_planes(P))
                Pa, Pb, sa, sb = P[:, :, :m], P[:, :, m:], s_p[:m], s_p[m:]
                rect = [("metric2_levels", metric2_levels, plane_rect_plain)]
                if levels == 1:
                    rect.append(("metric2_pop", metric2_pop, metric2_pop_plain))
                for (ename, epi) in epilogues:
                    for out in (torch.float32, torch.bfloat16):
                        tag = f"n_f={n_f} m={m} n={n} levels={levels} {ename} {out}"
                        for name, kern, plain in rect:
                            want = plain(Pa, Pb, sa, sb, epilogue=epi, out_dtype=out)
                            for a, b in ((Pa, Pb), (Pa.contiguous(), Pb.contiguous())):
                                check_equal(f"{name} {tag}",
                                            kern(a, b, sa, sb, epilogue=epi, out_dtype=out),
                                            want, kernels[name]["errs"])
                slices = [("threeway_batch_levels", threeway_batch_levels, plane3_plain)]
                if levels == 1:
                    slices.append(("threeway_batch_pop", threeway_batch_pop,
                                   threeway_batch_pop_plain))
                PX = slice_planes_vectors(P, j0, L)  # row stride m + n, not L
                for Pr in (P, Pb):
                    tag = f"n_f={n_f} n_vp={m + n} j0={j0} L={L} n={Pr.shape[2]} " \
                          f"levels={levels}"
                    for name, kern, plain in slices:
                        want = plain(P, PX, Pr)
                        for x in (PX, PX.contiguous()):
                            check_equal(f"{name} {tag}", kern(P, x, Pr), want,
                                        kernels[name]["errs"])
        # rows 12/9 at the edges of their GEMM form: kb = 32, 32, 33, 129
        # (not a multiple of the 16-byte-row stage or of 4), L = 1 and odd,
        # m and n in {1, 16, 17, 129, 255}, an odd j0, payload row strides
        # that take the 16-byte, 4-byte and byte copies, own == right (one
        # tensor) and own != right (a view at column m); PX strided and a
        # contiguous copy
        pairs = [(1, 255), (16, 17), (17, 16), (129, 129), (255, 1), (16, 16)]
        shape = 0
        for n_f in (255, 256, 257, 1025):
            for levels in (1, 2, 3):
                for m, n in pairs:
                    align, L = (16, 4, 1)[shape % 3], (1, 3, 7)[shape % 3]
                    shape += 1
                    n_vp = -(-(m + n + 2 * L + 2) // align) * align
                    V = rng.integers(0, levels + 1, size=(n_f, n_vp)).astype(np.float32)
                    P = torch.as_tensor(encode_bitplanes_np(V, levels), device=dev)
                    j0 = 1 + 2 * int(rng.integers(0, (n_vp - L - 1) // 2))
                    PX = slice_planes_vectors(P, j0, L)
                    slices = [("threeway_batch_levels", threeway_batch_levels)]
                    if levels == 1:
                        slices.append(("threeway_batch_pop", threeway_batch_pop))
                    own = P[:, :, :m]
                    for right in (own, P[:, :, m:m + n]):
                        want = plane3_plain(own, PX, right)
                        tag = f"n_f={n_f} n_vp={n_vp} j0={j0} L={L} m={m} " \
                              f"n={right.shape[2]} levels={levels}"
                        for name, kern in slices:
                            for x in (PX, PX.contiguous()):
                                check_equal(f"{name} {tag}", kern(own, x, right), want,
                                            kernels[name]["errs"])
        # rows 5/7 at the edges of their b1 form: kb = 1, 3, 31, 32, 33, 129
        # bytes (not a multiple of 4 or of the 32-byte-row K step), m and n
        # in {1, 16, 17, 129, 255}, levels 1-3; Pa and Pb views of one
        # payload at column offsets and row strides that take the 16-byte,
        # 4-byte and byte copies (the byte copies at an odd offset), and
        # contiguous copies; every epilogue, fp32 and bf16 out
        def ceil_to(x, a):
            return -(-x // a) * a

        shape = 0
        for kb in (1, 3, 31, 32, 33, 129):
            for levels in (1, 2, 3):
                for m, n in pairs:
                    align = (16, 4, 1)[shape % 3]
                    shape += 1
                    a0 = align if align > 1 else 1 + 2 * int(rng.integers(0, 8))
                    b0 = ceil_to(a0 + m, align)
                    n_vp = ceil_to(b0 + n, align)
                    V = rng.integers(0, levels + 1, size=(8 * kb, n_vp)).astype(np.float32)
                    P = torch.as_tensor(encode_bitplanes_np(V, levels), device=dev)
                    s_p = CZEKANOWSKI.stat(values_from_planes(P))
                    Pa, Pb = P[:, :, a0:a0 + m], P[:, :, b0:b0 + n]
                    sa, sb = s_p[a0:a0 + m], s_p[b0:b0 + n]
                    rect = [("metric2_levels", metric2_levels)]
                    if levels == 1:
                        rect.append(("metric2_pop", metric2_pop))
                    for (ename, epi) in epilogues:
                        for out in (torch.float32, torch.bfloat16):
                            tag = f"kb={kb} m={m} n={n} offsets={a0},{b0} n_vp={n_vp} " \
                                  f"levels={levels} {ename} {out}"
                            want = plane_rect_plain(Pa, Pb, sa, sb, epilogue=epi, out_dtype=out)
                            for name, kern in rect:
                                for a, b in ((Pa, Pb), (Pa.contiguous(), Pb.contiguous())):
                                    check_equal(f"{name} {tag}",
                                                kern(a, b, sa, sb, epilogue=epi, out_dtype=out),
                                                want, kernels[name]["errs"])
        # rows 6/8 at the edges of their b1 form: kb = 1, 3, 31, 32, 33, 129
        # bytes, n_v from 1 to 257 (one and several tiles, diagonal tiles,
        # a ragged last tile), levels 1-3, every epilogue, fp32 and bf16
        # out; the planes as allocated (16-byte copies where n_v is a
        # multiple of 16, byte copies where it is odd) and a contiguous copy
        # at a 4-byte offset (4-byte copies where n_v is a multiple of 16)
        def at_offset(P, off):
            buf = torch.empty(P.numel() + off, dtype=torch.uint8, device=P.device)
            Q = buf[off:].view(P.shape)
            Q.copy_(P)
            return Q

        for kb in (1, 3, 31, 32, 33, 129):
            for n_v in (1, 16, 17, 127, 128, 129, 255, 257):
                for levels in (1, 2, 3):
                    V = rng.integers(0, levels + 1, size=(8 * kb, n_v)).astype(np.float32)
                    V[:, n_v // 2] = 0
                    P = torch.as_tensor(encode_bitplanes_np(V, levels), device=dev)
                    s_p = CZEKANOWSKI.stat(values_from_planes(P))
                    tri = [("metric2_levels_tri", metric2_levels_tri)]
                    if levels == 1:
                        tri.append(("metric2_pop_tri", metric2_pop_tri))
                    for (ename, epi) in epilogues:
                        for out in (torch.float32, torch.bfloat16):
                            tag = f"kb={kb} n_v={n_v} levels={levels} {ename} {out}"
                            want = plane_tri_plain(P, s_p, epilogue=epi, out_dtype=out)
                            for name, kern in tri:
                                for off in (0, 4):
                                    check_equal(f"{name} {tag} offset={off}",
                                                kern(at_offset(P, off), s_p, epilogue=epi,
                                                     out_dtype=out),
                                                want, kernels[name]["errs"])
        # rows 1/2 and 11/10 at the same ragged shapes on int8 and float32
        # values: A and B are strided column views of one block (row stride
        # m + n), X a strided pipeline view, own a strided view too; each
        # kernel must equal its plain version on the views and on copies
        combines = [("min", torch.minimum, CZEKANOWSKI), ("mul", CCC.combine, CCC)]
        for n_f, m, n, j0, L in [(77, 300, 129, 17, 37), (1000, 1, 37, 0, 1),
                                 (333, 129, 257, 200, 50)]:
            for max_value in (2, 15):
                V = rng.integers(0, max_value + 1, size=(n_f, m + n)).astype(np.float32)
                V[:, m // 2] = 0
                for in_dtype in (torch.int8, torch.float32):
                    W = torch.as_tensor(V, device=dev).to(in_dtype)
                    A, B, X = W[:, :m], W[:, m:], W[:, j0:j0 + L]
                    tag = f"n_f={n_f} m={m} n={n} max={max_value} {in_dtype}"
                    want = mgemm_xla(A.t(), B)
                    for a, b in ((A, B), (A.contiguous(), B.contiguous())):
                        for at in (a.t(), a.t().contiguous()):  # A (m, k) both ways
                            check_equal(f"mgemm {tag}", mgemm(at, b), want,
                                        kernels["mgemm"]["errs"])
                    for cname, comb, spec in combines:
                        sa, sb = spec.stat(A), spec.stat(B)
                        for (ename, epi) in epilogues:
                            for out in (torch.float32, torch.bfloat16):
                                want = metric2_tiles_plain(A.t(), B, sa, sb, combine=comb,
                                                           epilogue=epi, out_dtype=out)
                                for a, b in ((A, B), (A.contiguous(), B.contiguous())):
                                    check_equal(
                                        f"metric2_tiles {tag} {cname} {ename} {out}",
                                        metric2_tiles(a.t(), b, sa, sb, combine=comb,
                                                      epilogue=epi, out_dtype=out),
                                        want, kernels["metric2_tiles"]["errs"])
                        for right in (W, B):
                            want = minplus3_plain(A, X, right, combine=comb)
                            for own, x in ((A, X), (A.contiguous(), X.contiguous())):
                                check_equal(f"threeway_batch {tag} {cname} j0={j0} L={L} "
                                            f"n={right.shape[1]}",
                                            threeway_batch(own, x, right, combine=comb),
                                            want, kernels["threeway_batch"]["errs"])
                                for t in {0, L - 1}:
                                    check_equal(f"threeway_step {tag} {cname} t={t}",
                                                threeway_step(own, x[:, t], right,
                                                              combine=comb),
                                                want[t], kernels["threeway_step"]["errs"])
        # rows 1/2 and 11/10 at the edges of their pipelined main loop: A and
        # B column views whose row bases and row stride take its 16-, 4- and
        # 1-byte copies (float32 has no 1-byte form), k not a multiple of the
        # 32-field stage, m and n not multiples of 128; signed int8 (min) and
        # quarter-grid float32 values; X a view at an odd column
        def dosage_like(k_, w):
            return rng.integers(0, 9, size=(k_, w)).astype(np.float32) / 4

        for k_ in (1, 31, 33, 97):
            for m_, n_, L in ((1, 1, 1), (64, 129, 3), (130, 257, 7)):
                for align in (16, 4, 1):
                    for in_dtype in (torch.int8, torch.float32):
                        if in_dtype == torch.float32 and align == 1:
                            continue
                        es = 1 if in_dtype == torch.int8 else 4
                        ae = max(align // es, 1)  # the alignment in elements
                        a0 = ae if align > 1 else 1 + 2 * int(rng.integers(0, 4))
                        b0 = -(-(a0 + m_) // ae) * ae
                        width = -(-(b0 + n_ + 2) // ae) * ae
                        if align == 4 and (width * es) % 16 == 0:
                            width += ae
                        if align == 1 and width % 2 == 0:
                            width += 1
                        f32 = in_dtype == torch.float32
                        V = dosage_like(k_, width) if f32 else \
                            rng.integers(-3, 9, size=(k_, width)).astype(np.float32)
                        tag = f"k={k_} m={m_} n={n_} L={L} {in_dtype} align={align}"
                        suffix = " float32" if f32 else ""
                        for cname, comb, spec in combines:
                            # signed int8 under min; CCC's root needs sums >= 0
                            W = torch.as_tensor(V if cname == "min" else np.abs(V),
                                                device=dev).to(in_dtype)
                            A, B = W[:, a0:a0 + m_], W[:, b0:b0 + n_]
                            X = W[:, a0 + 1:a0 + 1 + L]
                            if cname == "min":
                                check_equal(f"mgemm edges {tag}", mgemm(A.t(), B),
                                            mgemm_xla(A.t(), B),
                                            kernels["mgemm" + suffix]["errs"])
                            sa, sb = spec.stat(A), spec.stat(B)
                            check_equal(f"metric2_tiles edges {tag} {cname}",
                                        metric2_tiles(A.t(), B, sa, sb, combine=comb,
                                                      epilogue=spec.assemble_tile),
                                        metric2_tiles_plain(A.t(), B, sa, sb, combine=comb,
                                                            epilogue=spec.assemble_tile),
                                        kernels["metric2_tiles"]["errs"])
                            if not f32 and cname == "mul":
                                continue  # the tensor-core kernel, checked below
                            name = f"threeway_batch {cname.replace('mul', 'ccc')} float32" \
                                if f32 else "threeway_batch"
                            want = minplus3_plain(A, X, B, combine=comb)
                            check_equal(f"threeway_batch edges {tag} {cname}",
                                        threeway_batch(A, X, B, combine=comb), want,
                                        kernels[name]["errs"])
                            check_equal(f"threeway_step edges {tag} {cname}",
                                        threeway_step(A, X[:, L - 1], B, combine=comb),
                                        want[L - 1], kernels["threeway_step"]["errs"])
        # row 4 on values that are not leveled: negatives, values above
        # levels, halves, NaN and +-inf (float32), at ragged m, n and k; A is
        # the transpose of a strided column view (row stride of the block)
        # and of a contiguous copy.  The last two shapes (widths, offsets
        # and row strides multiples of 16) take the 16-byte load path, the
        # others the scalar one
        shapes = [(m_, n_, 3) for m_ in (1, 17, 130) for n_ in (1, 17, 130)]
        shapes += [(64, 144, 16), (16, 128, 32)]
        for k_ in (1, 31, 520):
            for m_, n_, off in shapes:
                for levels in (1, 2, 3):
                    V = rng.integers(-3, levels + 4,
                                     size=(k_, off + m_ + n_ + 16)).astype(np.float32)
                    Vf = V.copy()
                    Vf[rng.random(V.shape) < 0.1] += 0.5
                    for special in (np.nan, np.inf, -np.inf):
                        Vf[rng.random(V.shape) < 0.05] = special
                    for W in (torch.as_tensor(V, device=dev).to(torch.int8),
                              torch.as_tensor(Vf, device=dev)):
                        A, B = W[:, off:off + m_], W[:, off + m_:off + m_ + n_]
                        want = mgemm_levels_xla(A.t(), B, levels=levels)
                        for a in (A.t(), A.t().contiguous()):
                            check_equal(f"mgemm_levels k={k_} m={m_} n={n_} levels={levels} "
                                        f"{W.dtype}", mgemm_levels(a, B, levels=levels),
                                        want, kernels["mgemm_levels"]["errs"])
        # row 4 at levels 9 and 130 (several plane windows; on int8 the
        # planes past 127 are zero) on a small shape, both dtypes, A a
        # strided view's transpose and a copy's
        for levels in (9, 130):
            V = rng.integers(-3, levels + 4, size=(333, 3 + 40 + 70)).astype(np.float32)
            Vf = V.copy()
            Vf[rng.random(V.shape) < 0.1] += 0.5
            for special in (np.nan, np.inf, -np.inf):
                Vf[rng.random(V.shape) < 0.05] = special
            for W in (torch.as_tensor(np.clip(V, -128, 127), device=dev).to(torch.int8),
                      torch.as_tensor(Vf, device=dev)):
                A, B = W[:, 3:43], W[:, 43:]
                want = mgemm_levels_xla(A.t(), B, levels=levels)
                for a in (A.t(), A.t().contiguous()):
                    check_equal(f"mgemm_levels k=333 m=40 n=70 levels={levels} {W.dtype}",
                                mgemm_levels(a, B, levels=levels), want,
                                kernels["mgemm_levels"]["errs"])
        # row 11's CCC form on int8 (the tensor-core kernel): the whole int8
        # range at n_f <= 8 (every sum below 2^24, so the fp32 plain version
        # is exact) and both signs up to 40 at n_f 333-1000, where products
        # leave [0, 255] and the hi pass runs; {0,1,2} data where one product
        # of one stage of one block leaves it; ragged m, n, L, strided
        # views and copies, and row 10 column by column
        ccc_cases = [(n_f, -128, 127) for n_f in (1, 5, 8)]
        ccc_cases += [(n_f, -40, 40) for n_f in (333, 640, 1000)]
        for n_f, lo, hi in ccc_cases:
            for m_, n_, j0, L in ((1, 1, 0, 1), (64, 128, 3, 4), (65, 257, 17, 7),
                                  (130, 129, 1, 9)):
                W = torch.as_tensor(rng.integers(lo, hi + 1, size=(n_f, m_ + n_ + 20)),
                                    dtype=torch.int8, device=dev)
                W[0, :2] = torch.tensor([lo, hi], dtype=torch.int8)
                own, X, right = W[:, :m_], W[:, j0:j0 + L], W[:, m_:m_ + n_]
                want = minplus3_plain(own, X, right, combine=CCC.combine)
                tag = f"n_f={n_f} [{lo}, {hi}] m={m_} n={n_} L={L}"
                for o, x, r in ((own, X, right), (own.contiguous(), X.contiguous(),
                                                  right.contiguous())):
                    check_equal(f"threeway_batch CCC int8 {tag}",
                                threeway_batch(o, x, r, combine=CCC.combine), want,
                                kernels["threeway_batch"]["errs"])
                for t in range(L):
                    check_equal(f"threeway_step CCC int8 {tag} t={t}",
                                threeway_step(own, X[:, t], right, combine=CCC.combine),
                                want[t], kernels["threeway_step"]["errs"])
        # {0,1,2} data (hi 0 everywhere) but for one value of 17, in own
        # column 70 and in pipeline column 2 (x0 = 68): 17 x 17 leaves [0,
        # 255] in one stage (fields 640-767) of one block (pipeline columns
        # 0-3, own columns 64-127, the one right tile); x0 = 0 has no hi
        W = torch.as_tensor(rng.integers(0, 3, size=(1000, 300)), dtype=torch.int8, device=dev)
        W[700, 70] = 17
        for x0 in (68, 0):
            X = W[:, x0:x0 + 4]
            check_equal(f"threeway_batch CCC int8 one hi stage, x from column {x0}",
                        threeway_batch(W, X, W[:, 172:], combine=CCC.combine),
                        minplus3_plain(W, X, W[:, 172:], combine=CCC.combine),
                        kernels["threeway_batch"]["errs"])
        for name, k in kernels.items():
            if name not in expr_forms:  # checked in phase combines
                print(f"  {name}: {len(k['errs'])} ragged-shape checks equal the plain "
                      "version")
        # the tensor-core plane kernels' registers, spills and shared memory
        for lib in ("plane3", "plane_rect", "plane_tri", "minplus3", "mgemm_rect",
                    "mgemm_levels"):
            for line in paths[lib].with_suffix(".log").read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {lib}: {line.strip()}")
        # full width: the shapes the main paths give each kernel.  2-way:
        # the (N_V, N_V) diagonal block.  3-way (N_V3 block, pipeline length
        # L3): the slice kernel on a strided pipeline view, and the
        # pair-term kernel at its largest shape, (m, m) left x right.
        m = N_V
        pairs = m * (m - 1) // 2
        Vd = torch.as_tensor(V2.astype(np.int8), device=dev)
        s_v = CZEKANOWSKI.stat(Vd)
        P2 = torch.as_tensor(encode_bitplanes_np(V2, 2), device=dev)
        P1 = torch.as_tensor(encode_bitplanes_np(V1, 1), device=dev)
        s_2 = CZEKANOWSKI.stat(values_from_planes(P2))
        s_1 = CZEKANOWSKI.stat(values_from_planes(P1))
        m3, L3 = N_V3, N_V3 // (6 * N_ST3)
        Q2 = torch.as_tensor(encode_bitplanes_np(V2[:, :m3], 2), device=dev)
        Q1 = torch.as_tensor(encode_bitplanes_np(V1[:, :m3], 1), device=dev)
        z3 = torch.zeros(m3, device=dev)
        X2, X1 = slice_planes_vectors(Q2, 0, L3), slice_planes_vectors(Q1, 0, L3)
        # the 3-way value payload (int8 on {0,1,2} data), its stage-0 slice-0
        # pipeline view (row stride m3) and one pipeline column; the two
        # blocks of an off-diagonal 2-way block at n_pv = 2
        Q3 = Vd[:, :m3].contiguous()
        Xs, x0 = Q3[:, :L3], Q3[:, 0]
        h = m // 2
        Va2, Vb2 = Vd[:, :h].contiguous(), Vd[:, h:].contiguous()
        sa2, sb2 = s_v[:h], s_v[h:]

        def tri_numer(raw):
            return lambda: unpack_tri_tiles(raw(), m, BT)

        def upper(lib):
            return lib.to(torch.float32).triu(1)

        def dense(lib):
            return lib.to(torch.float32)

        def slab(lib):
            return lib.to(torch.float32).reshape(L3, m3, m3)

        # name -> (kernel, plain, raw numerator, library call builder,
        # library -> numerator, distinct inputs, operations, rate); bytes
        # count each distinct input once and the output once
        full = {
            "mgemm": (  # the (m, m) left x right pair term
                lambda: mgemm(Q3.t(), Q3),
                lambda: mgemm_xla(Q3.t(), Q3),
                lambda: mgemm(Q3.t(), Q3),
                lambda: minplus_library(Q3), dense, (Q3,),
                2 * N_F * m3 * m3, FP32_INSTR_PER_S,
            ),
            "metric2_tiles": (
                lambda: metric2_tiles(Va2.t(), Vb2, sa2, sb2, combine=torch.minimum,
                                      epilogue=czek_tile),
                lambda: metric2_tiles_plain(Va2.t(), Vb2, sa2, sb2,
                                            combine=torch.minimum, epilogue=czek_tile),
                lambda: metric2_tiles(Va2.t(), Vb2, sa2, sb2, combine=torch.minimum,
                                      epilogue=None),
                lambda: minplus_library(Va2, Vb2), dense, (Va2, Vb2, sa2, sb2),
                2 * N_F * h * h, FP32_INSTR_PER_S,
            ),
            "threeway_step": (
                lambda: threeway_step(Q3, x0, Q3, combine=torch.minimum),
                lambda: minplus3_plain(Q3, x0[:, None], Q3, combine=torch.minimum)[0],
                lambda: threeway_step(Q3, x0, Q3, combine=torch.minimum),
                lambda: minplus_library(torch.minimum(Q3, x0[:, None]), Q3), dense,
                (Q3, x0), 2 * N_F * m3 * m3, FP32_INSTR_PER_S,
            ),
            "metric2_tri": (
                lambda: metric2_tri(Vd, s_v, combine=torch.minimum,
                                    epilogue=czek_tile),
                lambda: metric2_tri_plain(Vd, s_v, combine=torch.minimum,
                                          epilogue=czek_tile),
                tri_numer(lambda: metric2_tri(Vd, s_v, combine=torch.minimum,
                                              epilogue=None)),
                lambda: minplus_library(Vd), upper, (Vd, s_v),
                2 * N_F * pairs, FP32_INSTR_PER_S,
            ),
            "metric2_levels_tri": (
                lambda: metric2_levels_tri(P2, s_2, epilogue=czek_tile),
                lambda: plane_tri_plain(P2, s_2, epilogue=czek_tile),
                tri_numer(lambda: metric2_levels_tri(P2, s_2, epilogue=None)),
                lambda: planes_library(P2, P2), upper, (P2, s_2),
                2 * pairs * 2 * 8 * P2.shape[1], B1_OPS_PER_S,
            ),
            "metric2_pop_tri": (
                lambda: metric2_pop_tri(P1, s_1, epilogue=czek_tile),
                lambda: metric2_pop_tri_plain(P1, s_1, epilogue=czek_tile),
                tri_numer(lambda: metric2_pop_tri(P1, s_1, epilogue=None)),
                lambda: planes_library(P1, P1), upper, (P1, s_1),
                2 * pairs * 1 * 8 * P1.shape[1], B1_OPS_PER_S,
            ),
            "metric2_levels": (
                lambda: metric2_levels(Q2, Q2, z3, z3, epilogue=None),
                lambda: plane_rect_plain(Q2, Q2, z3, z3, epilogue=None),
                lambda: metric2_levels(Q2, Q2, z3, z3, epilogue=None),
                lambda: planes_library(Q2, Q2), dense, (Q2, z3),
                2 * m3 * m3 * 2 * 8 * Q2.shape[1], B1_OPS_PER_S,
            ),
            "metric2_pop": (
                lambda: metric2_pop(Q1, Q1, z3, z3, epilogue=None),
                lambda: metric2_pop_plain(Q1, Q1, z3, z3, epilogue=None),
                lambda: metric2_pop(Q1, Q1, z3, z3, epilogue=None),
                lambda: planes_library(Q1, Q1), dense, (Q1, z3),
                2 * m3 * m3 * 1 * 8 * Q1.shape[1], B1_OPS_PER_S,
            ),
            "threeway_batch_levels": (
                lambda: threeway_batch_levels(Q2, X2, Q2),
                lambda: plane3_plain(Q2, X2, Q2),
                lambda: threeway_batch_levels(Q2, X2, Q2),
                lambda: plane3_library(Q2, X2, Q2), slab, (Q2, X2),
                2 * L3 * m3 * m3 * 2 * 8 * Q2.shape[1], B1_OPS_PER_S,
            ),
            "mgemm_levels": (  # the (m, m) left x right pair term, levels=2
                lambda: mgemm_levels(Q3.t(), Q3, levels=2),
                lambda: mgemm_levels_xla(Q3.t(), Q3, levels=2),
                lambda: mgemm_levels(Q3.t(), Q3, levels=2),
                lambda: levels_library(Q3, Q3, 2), dense, (Q3,),
                2 * 2 * N_F * m3 * m3, B1_OPS_PER_S,
            ),
            "threeway_batch_pop": (
                lambda: threeway_batch_pop(Q1, X1, Q1),
                lambda: threeway_batch_pop_plain(Q1, X1, Q1),
                lambda: threeway_batch_pop(Q1, X1, Q1),
                lambda: plane3_library(Q1, X1, Q1), slab, (Q1, X1),
                2 * L3 * m3 * m3 * 1 * 8 * Q1.shape[1], B1_OPS_PER_S,
            ),
        }
        for name, (kern, plain, numer, library, to_numer, inputs, ops,
                   rate) in full.items():
            k = kernels[name]
            k["ms"], got = cuda_ms(kern, repeats=5)
            k["plain_ms"], want = cuda_ms(plain, repeats=1)
            check_equal(f"{name} full width", got, want, k["errs"])
            k["bound_ms"], k["bound_by"] = bound_of(nbytes(*inputs), nbytes(got), ops,
                                                    rate)
            # plane rows: the int8 bound too (the same 0/1 product as bytes)
            int8 = "" if rate != B1_OPS_PER_S else \
                f", int8 bound {bound_of(nbytes(*inputs), nbytes(got), ops, INT8_OPS_PER_S)[0]:.3f} ms"
            del got, want
            # the library call must give the kernel's exact raw numerator
            want = numer()
            call = library()
            k["library_ms"], lib = cuda_ms(call, repeats=3)
            if not torch.equal(to_numer(lib), want):
                raise AssertionError(f"{name}: library numerator != kernel's")
            del want, lib, call
            torch.cuda.empty_cache()
            split = f", {tri_splits(Vd)} split(s)" if name == "metric2_tri" else ""
            print(f"  {name}: kernel {k['ms']:.3f} ms{split}, plain {k['plain_ms']:.1f} ms, "
                  f"library {k['library_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms "
                  f"({k['bound_by']}, {ops:.4g} ops at {rate:.4g}/s){int8}", flush=True)
        # row 2 against row 1 followed by assemble2, at full width
        check_equal("metric2_tiles full width vs mgemm + assemble2",
                    metric2_tiles(Va2.t(), Vb2, sa2, sb2, combine=torch.minimum,
                                  epilogue=czek_tile),
                    CZEKANOWSKI.assemble2(mgemm(Va2.t(), Vb2), sa2[:, None],
                                          sb2[None, :]),
                    kernels["metric2_tiles"]["errs"])
        # row 1 at the (L, m) pair-term shape: A is the pipeline view's
        # transpose, read in place; 12 output tiles on 132 SMs
        ms, got = cuda_ms(lambda: mgemm(Xs.t(), Q3), repeats=5)
        check_equal("mgemm (L, m) full width", got, mgemm_xla(Xs.t(), Q3),
                    kernels["mgemm"]["errs"])
        lib_ms, lib = cuda_ms(minplus_library(Xs, Q3), repeats=3)
        if not torch.equal(lib, got):
            raise AssertionError("mgemm (L, m): library numerator != kernel's")
        b_ms, b_by = bound_of(nbytes(Q3, Xs), nbytes(got), 2 * N_F * L3 * m3,
                              FP32_INSTR_PER_S)
        print(f"  mgemm at ({L3}, {m3}): kernel {ms:.3f} ms, library {lib_ms:.3f} ms, "
              f"bound {b_ms:.3f} ms ({b_by})", flush=True)
        # the shapes a decomposition gives (phase decomp, n_pv = 4): each
        # rank's (w, w) diagonal block and (w, w) off-diagonal blocks, w =
        # N_V / 4, contiguous shards as parallel.ring.shard places them
        w = N_V // 4
        Vw, Vx = Vd[:, :w].contiguous(), Vd[:, w:2 * w].contiguous()
        sw, sx = s_v[:w].contiguous(), s_v[w:2 * w].contiguous()
        P2w, P2x = P2[:, :, :w].contiguous(), P2[:, :, w:2 * w].contiguous()
        P1w, P1x = P1[:, :, :w].contiguous(), P1[:, :, w:2 * w].contiguous()
        s2w, s2x = s_2[:w].contiguous(), s_2[w:2 * w].contiguous()
        s1w, s1x = s_1[:w].contiguous(), s_1[w:2 * w].contiguous()
        tri_w, kb = w * (w - 1) // 2, P2.shape[1]
        for name, kind, fn, inputs, ops, rate in (
                ("metric2_tri", "diagonal", lambda: metric2_tri(
                    Vw, sw, combine=torch.minimum, epilogue=czek_tile),
                 (Vw, sw), 2 * N_F * tri_w, FP32_INSTR_PER_S),
                ("metric2_tiles", "off-diagonal", lambda: metric2_tiles(
                    Vw.t(), Vx, sw, sx, combine=torch.minimum, epilogue=czek_tile),
                 (Vw, Vx, sw, sx), 2 * N_F * w * w, FP32_INSTR_PER_S),
                ("metric2_levels_tri", "diagonal", lambda: metric2_levels_tri(
                    P2w, s2w, epilogue=czek_tile), (P2w, s2w),
                 2 * tri_w * 2 * 8 * kb, B1_OPS_PER_S),
                ("metric2_levels", "off-diagonal", lambda: metric2_levels(
                    P2w, P2x, s2w, s2x, epilogue=czek_tile), (P2w, P2x, s2w, s2x),
                 2 * w * w * 2 * 8 * kb, B1_OPS_PER_S),
                ("metric2_pop_tri", "diagonal", lambda: metric2_pop_tri(
                    P1w, s1w, epilogue=czek_tile), (P1w, s1w),
                 2 * tri_w * 8 * P1.shape[1], B1_OPS_PER_S),
                ("metric2_pop", "off-diagonal", lambda: metric2_pop(
                    P1w, P1x, s1w, s1x, epilogue=czek_tile), (P1w, P1x, s1w, s1x),
                 2 * w * w * 8 * P1.shape[1], B1_OPS_PER_S)):
            w_ms, out = cuda_ms(fn, repeats=5)
            w_bound, w_by = bound_of(nbytes(*inputs), nbytes(out), ops, rate)
            extra = ""
            if name == "metric2_tri":
                # the split form at full width: its plain version, and the
                # library call held to its raw numerator
                check_equal(f"metric2_tri w = {w}", out, metric2_tri_plain(
                    Vw, sw, combine=torch.minimum, epilogue=czek_tile),
                    kernels["metric2_tri"]["errs"])
                lib_w, numer_w = cuda_ms(minplus_library(Vw), repeats=3)
                if not torch.equal(numer_w.triu(1), unpack_tri_tiles(metric2_tri(
                        Vw, sw, combine=torch.minimum, epilogue=None), w, BT)):
                    raise AssertionError(f"metric2_tri w = {w}: library numerator != kernel's")
                del numer_w
                extra = f", {tri_splits(Vw)} split(s), library {lib_w:.3f} ms"
            print(f"  {name} at the decomposed {kind} block (w = {w}): kernel "
                  f"{w_ms:.3f} ms, bound {w_bound:.3f} ms ({w_by}){extra}", flush=True)
        del Vw, Vx, P2w, P2x, P1w, P1x, out
        check_decomp3_shapes(Q2, Q1, Q3, kernels)
        del got, lib
        # rows 5/7 at the (L, m) pair-term shape: the left operand is the
        # pipeline view, read in place
        zx = torch.zeros(L3, device=dev)
        for name, kern, plain, X, Q in (("metric2_levels", metric2_levels, plane_rect_plain,
                                         X2, Q2),
                                        ("metric2_pop", metric2_pop, metric2_pop_plain, X1,
                                         Q1)):
            ms, got = cuda_ms(lambda: kern(X, Q, zx, z3, epilogue=None), repeats=5)
            check_equal(f"{name} ({L3}, {m3}) full width", got,
                        plain(X, Q, zx, z3, epilogue=None), kernels[name]["errs"])
            lib_ms, lib = cuda_ms(planes_library(X, Q), repeats=3)
            if not torch.equal(dense(lib), got):
                raise AssertionError(f"{name} ({L3}, {m3}): library numerator != kernel's")
            ops = 2 * L3 * m3 * 8 * Q.shape[0] * Q.shape[1]
            b_ms, b_by = bound_of(nbytes(Q, X), nbytes(got), ops, B1_OPS_PER_S)
            print(f"  {name} at ({L3}, {m3}): kernel {ms:.4f} ms, library {lib_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)
            del got, lib
        # row 4 at the value ring's other shapes: levels=1 (Sorenson) and the
        # (L, m) pair terms, whose A is the pipeline view's transpose
        for a, lv in ((Q3, 1), (Xs, 2), (Xs, 1)):
            ms, got = cuda_ms(lambda: mgemm_levels(a.t(), Q3, levels=lv), repeats=5)
            plain_ms, want = cuda_ms(lambda: mgemm_levels_xla(a.t(), Q3, levels=lv),
                                     repeats=1)
            check_equal(f"mgemm_levels {tuple(got.shape)} levels={lv} full width", got,
                        want, kernels["mgemm_levels"]["errs"])
            lib_ms, lib = cuda_ms(levels_library(a, Q3, lv), repeats=3)
            if not torch.equal(dense(lib), got):
                raise AssertionError("mgemm_levels: library numerator != kernel's")
            in_bytes = nbytes(Q3) + (0 if a is Q3 else nbytes(a))
            ops = 2 * lv * N_F * a.shape[1] * m3
            b_ms, b_by = bound_of(in_bytes, nbytes(got), ops, B1_OPS_PER_S)
            i8_ms = bound_of(in_bytes, nbytes(got), ops, INT8_OPS_PER_S)[0]
            print(f"  mgemm_levels at {tuple(got.shape)} levels={lv}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.3f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}, b1), int8 bound {i8_ms:.4f} ms", flush=True)
            del got, want, lib
        # row 11 at one full-width slice (stage 0, slice 0), min and the
        # CCC product.  Its plain version loops over the L columns (each an
        # mgemm_xla of the whole block), so it is held at L_PLAIN columns;
        # the whole slice is held against the plane slice kernel (row 12:
        # on {0,1,2} data sum min equals the plane numerator) and, column
        # by column, against the single-column kernel (row 10)
        k = kernels["threeway_batch"]
        k["ms"], got = cuda_ms(lambda: threeway_batch(Q3, Xs, Q3, combine=torch.minimum),
                               repeats=3)
        k["plain_ms"], want = cuda_ms(
            lambda: minplus3_plain(Q3, Xs[:, :L_PLAIN], Q3, combine=torch.minimum),
            repeats=1)
        check_equal(f"threeway_batch full width, first {L_PLAIN} columns",
                    got[:L_PLAIN], want, k["errs"])
        check_equal("threeway_batch full width vs threeway_batch_levels", got,
                    threeway_batch_levels(Q2, X2, Q2), k["errs"])
        for t in (0, L3 // 2, L3 - 1):
            check_equal(f"threeway_batch full width column {t} vs threeway_step",
                        got[t], threeway_step(Q3, Xs[:, t], Q3, combine=torch.minimum),
                        k["errs"])
        ops = 2 * N_F * L3 * m3 * m3
        k["bound_ms"], k["bound_by"] = bound_of(nbytes(Q3, Xs), nbytes(got), ops,
                                                FP32_INSTR_PER_S)
        fold = torch.minimum(Q3[:, None, :], Xs[:, :, None]).reshape(N_F, L3 * m3)
        call = minplus_library(fold, Q3)  # rows of the folded X ordered (t, i)
        del fold
        k["library_ms"], lib = cuda_ms(call, repeats=1)
        if not torch.equal(slab(lib), got):
            raise AssertionError("threeway_batch: library numerator != kernel's")
        del got, want, lib, call
        torch.cuda.empty_cache()
        print(f"  threeway_batch: kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.1f} ms "
              f"at L={L_PLAIN}, library {k['library_ms']:.3f} ms, bound "
              f"{k['bound_ms']:.3f} ms ({k['bound_by']}, {ops:.4g} ops)", flush=True)
        # the CCC product on int8 operands runs on the int8 tensor cores: 2
        # ops per (column, pair, field) over the int8 peak (twice that where
        # the hi pass runs); libraries: _int_mm of the int8 fold (exact: the
        # fold of {0,1,2} data is at most 4) and the fp32 matmul of the fold
        ms, got = cuda_ms(lambda: threeway_batch(Q3, Xs, Q3, combine=CCC.combine),
                          repeats=3)
        plain_ms, want = cuda_ms(lambda: minplus3_plain(Q3, Xs, Q3, combine=CCC.combine),
                                 repeats=1)
        check_equal("threeway_batch CCC full width", got, want, k["errs"])
        del want
        fold8 = (Q3[:, None, :] * Xs[:, :, None]).reshape(N_F, L3 * m3).t().contiguous()
        Qt8 = Q3.t().contiguous()
        i8_ms, lib = cuda_ms(lambda: torch._int_mm(fold8, Qt8.t()), repeats=3)
        if not torch.equal(slab(lib), got):
            raise AssertionError("threeway_batch CCC: _int_mm numerator != kernel's")
        del lib, fold8, Qt8
        fold = CCC.combine(Q3[:, None, :], Xs[:, :, None]).reshape(N_F, L3 * m3)
        Qf = Q3.to(torch.float32)
        lib_ms, lib = cuda_ms(lambda: torch.matmul(fold.t(), Qf), repeats=3)
        if not torch.equal(slab(lib), got):
            raise AssertionError("threeway_batch CCC: library numerator != kernel's")
        b_ms, b_by = bound_of(nbytes(Q3, Xs), nbytes(got), ops, INT8_OPS_PER_S)
        print(f"  threeway_batch CCC int8: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"library {i8_ms:.3f} ms (_int_mm) / {lib_ms:.3f} ms (fp32 matmul), bound "
              f"{b_ms:.3f} ms ({b_by}, int8; {2 * b_ms:.3f} ms with the hi pass)",
              flush=True)
        del got, lib, fold, Qf
        # float32 operands (the dosage data, stage 0's slice 0 of its 3-way
        # campaign): rows 11 and 1 on the CUDA cores, fp32-issue bounds;
        # libraries on float32 too: for min cdist(p=1) + the affine fix (row
        # 11 on the folded X), for the CCC product the full-precision fp32
        # matmul of the float32 fold
        Df = torch.as_tensor(D, device=dev)
        Xf = Df[:, :L3]  # the pipeline view, row stride m3
        for name, comb, per in (("threeway_batch ccc float32", CCC.combine, 1),
                                ("threeway_batch min float32", torch.minimum, 2)):
            k = kernels[name]
            k["ms"], got = cuda_ms(lambda: threeway_batch(Df, Xf, Df, combine=comb),
                                   repeats=3)
            k["plain_ms"], want = cuda_ms(
                lambda: minplus3_plain(Df, Xf[:, :L_PLAIN], Df, combine=comb), repeats=1)
            check_equal(f"{name} full width, first {L_PLAIN} columns", got[:L_PLAIN], want,
                        k["errs"])
            ops = per * N_F * L3 * m3 * m3
            k["bound_ms"], k["bound_by"] = bound_of(nbytes(Df, Xf), nbytes(got), ops,
                                                    FP32_INSTR_PER_S)
            fold = comb(Df[:, None, :], Xf[:, :, None]).reshape(N_F, L3 * m3)
            if per == 1:
                call = lambda: torch.matmul(fold.t(), Df)  # noqa: E731
            else:
                call, fold = minplus_library(fold, Df), None
            k["library_ms"], lib = cuda_ms(call, repeats=1 if per == 2 else 3)
            if not torch.equal(slab(lib), got):
                raise AssertionError(f"{name}: library numerator != kernel's")
            del got, want, lib, call, fold
            torch.cuda.empty_cache()
            print(f"  {name}: kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.1f} ms at "
                  f"L={L_PLAIN}, library {k['library_ms']:.3f} ms, bound "
                  f"{k['bound_ms']:.3f} ms ({k['bound_by']}, {ops:.4g} ops)", flush=True)
        # row 1 on float32 at both pair-term shapes; its split contraction
        # adds per-split slabs in order, so two calls give the same bits
        k = kernels["mgemm float32"]
        for A in (Df, Xf):
            ms, got = cuda_ms(lambda: mgemm(A.t(), Df), repeats=5)
            plain_ms, want = cuda_ms(lambda: mgemm_xla(A.t(), Df), repeats=1)
            tag = f"({A.shape[1]}, {m3})"
            check_equal(f"mgemm float32 {tag} full width", got, want, k["errs"])
            if not torch.equal(mgemm(A.t(), Df), got):
                raise AssertionError(f"mgemm float32 {tag}: two calls differ")
            lib_ms, lib = cuda_ms(minplus_library(A, Df), repeats=3)
            if not torch.equal(lib, got):
                raise AssertionError(f"mgemm float32 {tag}: library numerator != kernel's")
            ops = 2 * N_F * A.shape[1] * m3
            in_bytes = nbytes(Df) + (0 if A is Df else nbytes(A))
            b_ms, b_by = bound_of(in_bytes, nbytes(got), ops, FP32_INSTR_PER_S)
            if A is Df:  # the record keeps the (m, m) shape, as row 1's int8 entry
                k.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms)
            print(f"  mgemm float32 at {tag}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
                  f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); two calls "
                  "equal", flush=True)
            del got, want, lib
        del Df, Xf
        del Vd, P2, P1, Q2, Q1, X2, X1, X, Q, Q3, Xs, x0, Va2, Vb2, full, kern, plain, numer, library
        torch.cuda.empty_cache()

    engine = SimilarityEngine(device="cuda")
    # the unfused min-plus campaigns under impl="xla" (a chunked plain
    # contraction, 18 s at n_v = 8,192) run on N_V_CHECKSUM columns spread
    # over the block; the full blocks are held to impl="levels_xla", the
    # plain level decomposition (one fp32 matmul a level)
    windows = spread_columns(N_V_CHECKSUM, N_V)
    runs = [
        # (label, metric, data, request knobs, expected path, kernel); a run
        # with no kernel is a reference, held to by every fused run of its
        # metric: on the windows' sub-block for impl="xla", in full else
        ("czek xla", "czekanowski", V2[:, windows], dict(impl="xla"), "unfused", None),
        ("czek levels_xla", "czekanowski", V2, dict(impl="levels_xla", levels=2),
         "unfused", None),
        ("czek pallas", "czekanowski", V2, dict(impl="pallas"), "fused-vpu",
         "metric2_tri"),
        ("czek levels", "czekanowski", V2, dict(impl="levels", levels=2),
         "fused-levels", "metric2_levels_tri"),
        ("sorenson xla", "sorenson", V1[:, windows], dict(impl="xla"), "unfused", None),
        ("sorenson levels_xla", "sorenson", V1, dict(impl="levels_xla", levels=1),
         "unfused", None),
        ("sorenson levels", "sorenson", V1, dict(impl="levels", levels=1),
         "fused-popcount", "metric2_pop_tri"),
        ("ccc xla", "ccc", V2, dict(impl="xla"), "unfused", None),
        ("ccc pallas", "ccc", V2, dict(impl="pallas"), "fused-vpu", "metric2_tri"),
    ]
    walls2, walls3 = {}, {}  # each campaign's wall, beside the batches'
    with phase("campaigns"):
        for k in kernels.values():
            k["wrapper"].launches = 0
        refs, sampled = {}, {}
        for label, metric, V, knobs, path, kname in runs:
            req = SimilarityRequest(metric=metric, **knobs)
            ex = TileExecutor(cfg=req.to_comet_config(), metric=get_metric(metric))
            if ex.path != path:
                raise AssertionError(f"{label}: path {ex.path!r}, expected {path!r}")
            before = kernels[kname]["wrapper"].launches if kname else 0
            res = engine.run(req, V)
            obs = res.meta["obs"]
            walls2[label] = obs["seconds"]
            layers = ", ".join(f"{layer} {sec:.3f}"
                               for layer, sec in res.meta["layer_seconds"].items())
            print(f"  {label}: path={path} {obs['seconds']:.3f} s "
                  f"{obs['comparisons_per_s']:.4g} comparisons/s; layers (s): "
                  f"{layers}", flush=True)
            blocks = res.outputs[0].blocks
            n_v = V.shape[1]
            if blocks.shape != (1, 1, 1, n_v, n_v):
                raise AssertionError(f"{label}: blocks {blocks.shape}")
            if kname is None:
                if not np.isfinite(blocks).all():
                    raise AssertionError(f"{label}: non-finite values")
                if n_v < N_V:
                    sampled[metric] = blocks[0, 0, 0]
                else:
                    refs[metric] = blocks
                    if metric in sampled and not np.array_equal(
                            blocks[0, 0, 0][np.ix_(windows, windows)], sampled.pop(metric)):
                        raise AssertionError(f"{label}: blocks differ from impl='xla' "
                                             "on the windows")
            else:
                if kernels[kname]["wrapper"].launches <= before:
                    raise AssertionError(f"{label}: {kname} was not launched")
                if not np.array_equal(blocks, refs[metric]):
                    raise AssertionError(f"{label}: blocks differ from the reference's")
            del res, blocks
        launches = {name: k["wrapper"].launches for name, k in kernels.items()}
        launches.update({name: 0 for name in expr_forms})  # phase combines' own
        print(f"  launches on the 2-way main path: "
              f"{ {name: launches[name] for name in kernels2} }")
        for name in kernels2:
            if launches[name] < 1:
                raise AssertionError(f"{name} was launched no time on the main path")
        # the blocks the batched and decomp phases hold their runs to: the
        # unfused references' (impl="xla" for CCC, impl="levels_xla" for the
        # min-plus metrics)
        refs2 = {metric: refs[metric] for metric in ("czekanowski", "sorenson", "ccc")}
        del refs

    with phase("checksums"):
        W2 = V2[:, :N_V_CHECKSUM]
        W1 = V1[:, :N_V_CHECKSUM]
        grid = [
            ("czekanowski", W2, [dict(impl="xla"), dict(impl="levels_xla"),
                                 dict(impl="pallas"), dict(impl="levels"),
                                 dict(impl="pallas", packed=True)]),
            ("sorenson", W1, [dict(impl="xla"), dict(impl="levels", levels=1),
                              dict(impl="pallas", out_dtype="bfloat16")]),
            ("ccc", W2, [dict(impl="xla"), dict(impl="pallas")]),
            # no in-kernel epilogue: impl="pallas" takes the unfused path,
            # whose contraction is the min-plus GEMM (row 1); impl="levels" on
            # the value payload the level-decomposition GEMM (row 4)
            ("no-epilogue", W2, [dict(impl="xla"), dict(impl="pallas"),
                                 dict(impl="levels", encoding="none")]),
        ]
        register_metric(replace(CZEKANOWSKI, name="no-epilogue", assemble_tile=None))
        by_metric = {}
        for metric, W, variants in grid:
            sums = {}
            for knobs in variants:
                before = mgemm_levels.launches
                res = engine.run(SimilarityRequest(metric=metric, **knobs), W)
                if metric == "no-epilogue" and knobs.get("encoding") == "none" \
                        and mgemm_levels.launches == before:
                    raise AssertionError("no-epilogue levels: mgemm_levels not launched")
                sums.setdefault(knobs.get("out_dtype", "float32"), set()).add(
                    res.checksum())
                print(f"  {metric} {knobs}: {hex(res.checksum())}", flush=True)
            for dt, got in sums.items():
                if len(got) != 1:
                    raise AssertionError(f"{metric} {dt}: checksums differ across impls")
            by_metric[metric] = sums["float32"]
        if by_metric["no-epilogue"] != by_metric["czekanowski"]:
            raise AssertionError("no-epilogue != czekanowski: assemble2 differs from "
                                 "the in-kernel epilogue")
        # sorenson is czekanowski restricted to {0, 1}: identical checksums
        czek1 = engine.run(SimilarityRequest(impl="pallas"), W1).checksum()
        sor1 = engine.run(SimilarityRequest(metric="sorenson", impl="levels",
                                            levels=1), W1).checksum()
        if czek1 != sor1:
            raise AssertionError("sorenson != czekanowski on binary data")
        # the float64 numpy oracles at a small size
        Vs = random_integer_vectors(200, 64, max_value=2, seed=SEED + 2)
        for metric, knobs in [("czekanowski", dict(impl="pallas")),
                              ("czekanowski", dict(impl="levels")),
                              ("sorenson", dict(impl="levels", levels=1)),
                              ("ccc", dict(impl="pallas"))]:
            data = (Vs > 0).astype(np.float32) if metric == "sorenson" else Vs
            got = engine.run(SimilarityRequest(metric=metric, **knobs), data).dense()
            want = get_metric(metric).oracle2(data)
            np.fill_diagonal(want, 0.0)
            if not np.allclose(got, want, rtol=1e-6, atol=0):
                raise AssertionError(f"{metric} {knobs}: differs from the oracle")
            print(f"  oracle {metric} {knobs}: ok")

    runs3 = [
        # (label, metric, data, request knobs, expected path3, slice kernel,
        # pair-term kernel, the run whose blocks it must equal); a run with no
        # such run is a reference
        ("czek levels_xla", "czekanowski", V2[:, :N_V3],
         dict(impl="levels_xla", levels=2), "unfused", None, None, None),
        ("czek levels=2", "czekanowski", V2[:, :N_V3],
         dict(impl="levels", levels=2), "fused-levels-ring",
         "threeway_batch_levels", "metric2_levels", "czek levels_xla"),
        ("czek pallas", "czekanowski", V2[:, :N_V3], dict(impl="pallas"),
         "fused-vpu", "threeway_batch", "mgemm", "czek levels_xla"),
        # the levels value ring: planes encoded per slice, pair terms row 4
        ("czek levels=2 values", "czekanowski", V2[:, :N_V3],
         dict(impl="levels", levels=2, encoding="none"), "fused-levels",
         "threeway_batch_levels", "mgemm_levels", "czek levels=2"),
        ("sorenson levels_xla", "sorenson", V1[:, :N_V3],
         dict(impl="levels_xla", levels=1), "unfused", None, None, None),
        ("sorenson levels=1", "sorenson", V1[:, :N_V3],
         dict(impl="levels", levels=1), "fused-popcount-ring",
         "threeway_batch_pop", "metric2_pop", "sorenson levels_xla"),
        ("sorenson pallas", "sorenson", V1[:, :N_V3], dict(impl="pallas"),
         "fused-vpu", "threeway_batch", "mgemm", "sorenson levels_xla"),
        ("sorenson levels=1 values", "sorenson", V1[:, :N_V3],
         dict(impl="levels", levels=1, encoding="none"), "fused-popcount",
         "threeway_batch_pop", "mgemm_levels", "sorenson levels=1"),
        # data outside [0, levels]: "auto" resolves to the value ring, and
        # levels_xla has the same clamped semantics
        ("czek levels_xla {0..3}", "czekanowski", V3,
         dict(impl="levels_xla", levels=2), "unfused", None, None, None),
        ("czek levels=2 {0..3}", "czekanowski", V3, dict(impl="levels", levels=2),
         "fused-levels", "threeway_batch_levels", "mgemm_levels",
         "czek levels_xla {0..3}"),
        ("ccc xla", "ccc", V2[:, :N_V3], dict(impl="xla"), "unfused", None, None,
         None),
        # CCC's assembly needs no pair terms: no pair-term launches
        ("ccc pallas", "ccc", V2[:, :N_V3], dict(impl="pallas"), "fused-vpu",
         "threeway_batch", None, "ccc xla"),
        # dosage data, carried as float32: CCC against the unfused product;
        # Czekanowski against the same campaign on 4 x dosage (the integers
        # in [0, 8] it was drawn as) on the bit-plane ring, levels=8: a power
        # of two scales the numerators, the sums and 1.5 * n3 / d3 exactly.
        # (impl="levels_xla" at levels=8 decodes one slice's folded planes
        # to 58.6 GiB of fp32, past the card; the plane ring is exact on
        # integers, and its kernels are held to their plain versions above)
        ("ccc xla dosage", "ccc", D, dict(impl="xla"), "unfused", None, None, None),
        ("ccc pallas dosage", "ccc", D, dict(impl="pallas"), "fused-vpu",
         "threeway_batch", None, "ccc xla dosage"),
        ("czek levels=8 4 x dosage", "czekanowski", 4 * D, dict(impl="levels", levels=8),
         "fused-levels-ring", "threeway_batch_levels", "metric2_levels", None),
        ("czek pallas dosage", "czekanowski", D, dict(impl="pallas"), "fused-vpu",
         "threeway_batch", "mgemm", "czek levels=8 4 x dosage"),
    ]
    # keep a run's blocks (3.6 GB on the host) only until its last reader,
    # and those the batched phase holds its 3-way batches to
    last_read = {run[7]: i for i, run in enumerate(runs3) if run[7]}
    refs3_labels = ("czek levels=2", "ccc pallas")
    with phase("campaigns3"):
        for k in kernels.values():
            k["wrapper"].launches = 0
        f32_ran = {name: 0 for name in float32_forms}
        kept = {}
        for i, (label, metric, V, knobs, path3, kslice, kpair, ref) in enumerate(runs3):
            req = SimilarityRequest(way=3, metric=metric, n_st=N_ST3, stages=(0,),
                                    **knobs)
            spec = get_metric(metric)
            cfg = resolve_config(req.to_comet_config(), V, spec)
            ex = TileExecutor(cfg=cfg, metric=spec)
            if ex.path3 != path3:
                raise AssertionError(f"{label}: path3 {ex.path3!r}, expected {path3!r}")
            if V is D and cfg.ring_dtype != "float32":
                raise AssertionError(f"{label}: payload {cfg.ring_dtype}, expected float32")
            before = {name: kernels[name]["wrapper"].launches for name in kernels3}
            res = engine.run(req, V)
            ran = {name: kernels[name]["wrapper"].launches - before[name]
                   for name in kernels3}
            if V is D:  # the float32 forms' own launches
                f32_ran["mgemm float32"] += ran["mgemm"]
                f32_ran[f"threeway_batch {metric.replace('czekanowski', 'min')} float32"] += \
                    ran["threeway_batch"]
            obs = res.meta["obs"]
            walls3[label] = obs["seconds"]
            layers = ", ".join(f"{layer} {sec:.3f}"
                               for layer, sec in res.meta["layer_seconds"].items())
            print(f"  3-way {label}: path3={path3} {obs['seconds']:.3f} s "
                  f"{obs['comparisons']} comparisons, "
                  f"{obs['comparisons_per_s']:.4g} comparisons/s; launches {ran}; "
                  f"layers (s): {layers}", flush=True)
            blocks = res.outputs[0].blocks
            L3 = N_V3 // (6 * N_ST3)
            if blocks.shape != (1, 1, 6, L3, N_V3, N_V3):
                raise AssertionError(f"{label}: blocks {blocks.shape}")
            want = {name: 0 for name in kernels3}
            if kslice is not None:
                want[kslice] = 6  # per stage: one launch per slice
            if kpair is not None:
                want[kpair] = 18  # per stage: 3 pair terms per slice
            if ran != want:
                raise AssertionError(f"{label}: launches {ran}, expected {want}")
            if ref is None:
                if not np.isfinite(blocks).all():
                    raise AssertionError(f"{label}: non-finite values")
            elif not np.array_equal(blocks, kept[ref]):
                raise AssertionError(f"{label}: blocks differ from {ref!r}'s")
            if last_read.get(label, -1) > i or label in refs3_labels:
                kept[label] = blocks
            for done in [name for name, j in last_read.items() if j == i]:
                if done not in refs3_labels:
                    kept.pop(done, None)
            del res, blocks
        launches.update({name: kernels[name]["wrapper"].launches for name in kernels3})
        launches.update(f32_ran)
        for name in off_path:  # launched on no main path: expected 0
            launches[name] += kernels[name]["wrapper"].launches
        print(f"  launches on the 3-way main path: "
              f"{ {name: launches[name] for name in kernels3 + float32_forms} }")
        for name in kernels3 + float32_forms:
            if launches[name] < 1:
                raise AssertionError(f"{name} was launched no time on the main path")
        refs3 = {label: kept[label] for label in refs3_labels}
        del kept

    with phase("batched"):
        wrappers = {name: k["wrapper"] for name, k in kernels.items()
                    if name not in float32_forms + expr_forms}
        ran = check_batched(engine, V2, V1, refs2, walls2, refs3, walls3, wrappers)
        for name, n in ran.items():
            launches[name] += n
        print(f"  launches on the batched path: "
              f"{ {name: n for name, n in ran.items() if n} }")
        del refs3  # refs2 serves phase decomp too

    with phase("checksums3"):
        W2 = V2[:, :N_V3_CHECKSUM]
        W1 = V1[:, :N_V3_CHECKSUM]
        grid = [
            ("czekanowski", W2, [dict(impl="xla"), dict(impl="levels_xla"),
                                 dict(impl="levels"), dict(impl="pallas"),
                                 dict(impl="levels", encoding="none")]),
            ("sorenson", W1, [dict(impl="xla"), dict(impl="levels", levels=1),
                              dict(impl="pallas"),
                              dict(impl="levels", levels=1, encoding="none"),
                              dict(impl="xla", out_dtype="bfloat16"),
                              dict(impl="levels", levels=1, out_dtype="bfloat16"),
                              dict(impl="pallas", out_dtype="bfloat16")]),
            ("ccc", W2, [dict(impl="xla"), dict(impl="levels_xla"),
                         dict(impl="pallas")]),
        ]
        sums3 = {}
        for metric, W, variants in grid:
            for knobs in variants:
                res = engine.run(SimilarityRequest(way=3, metric=metric, n_st=2,
                                                   **knobs), W)
                key = (metric, knobs.get("out_dtype", "float32"))
                sums3.setdefault(key, set()).add(res.checksum())
                print(f"  3-way {metric} {knobs}: {res.num_results()} triples "
                      f"{hex(res.checksum())}", flush=True)
        for key, got in sums3.items():
            if len(got) != 1:
                raise AssertionError(f"3-way {key}: checksums differ across impls")
        czek1 = engine.run(SimilarityRequest(way=3, n_st=2, impl="levels", levels=1),
                           W1).checksum()
        if {czek1} != sums3[("sorenson", "float32")]:
            raise AssertionError("3-way sorenson != czekanowski on binary data")
        # the float64 numpy oracles at a small size, at every i < j < k
        Vs = random_integer_vectors(200, 40, max_value=2, seed=SEED + 3)
        i, j, k = np.meshgrid(*[np.arange(40)] * 3, indexing="ij")
        upper = (i < j) & (j < k)
        for metric, knobs in [("czekanowski", dict(impl="levels")),
                              ("czekanowski", dict(impl="pallas")),
                              ("sorenson", dict(impl="levels", levels=1)),
                              ("ccc", dict(impl="xla")), ("ccc", dict(impl="pallas"))]:
            data = (Vs > 0).astype(np.float32) if metric == "sorenson" else Vs
            got = engine.run(SimilarityRequest(way=3, metric=metric, n_st=2, **knobs),
                             data).dense()
            want = get_metric(metric).oracle3(data)
            if not np.allclose(got[upper], want[upper], rtol=1e-6, atol=0):
                raise AssertionError(f"3-way {metric} {knobs}: differs from the oracle")
            print(f"  oracle3 {metric} {knobs}: ok")

    with phase("ccc_tf32"):
        check_ccc_tf32(engine)

    with phase("store"):
        names = kernels2 + ("metric2_levels", "metric2_pop", "threeway_batch_levels",
                            "threeway_batch_pop")
        ran = check_store(engine, V2, V1,
                          {name: kernels[name]["wrapper"] for name in names})
        for name, n in ran.items():
            launches[name] += n
        print(f"  launches on the store path: {ran}")

    with phase("stream"):
        ran, prior = check_stream(engine, V2, V1,
                                  {name: k["wrapper"] for name, k in kernels.items()
                                   if name not in float32_forms + expr_forms})
        for name, n in ran.items():
            launches[name] += n
        print(f"  launches on the streamed and delta paths: "
              f"{ {name: n for name, n in ran.items() if n} }")
        if ran["metric2_tiles"] < 1:
            raise AssertionError("metric2_tiles was launched no time on the delta path")

    with phase("decomp"):
        ran = check_decomp(V2, V1, refs2, walls2, prior,
                           {name: k["wrapper"] for name, k in kernels.items()
                            if name not in float32_forms + expr_forms})
        del refs2
        for name, n in ran.items():
            launches[name] += n
        print(f"  launches on the decomposed paths: "
              f"{ {name: n for name, n in ran.items() if n} }")
        for name in ("mgemm", "metric2_tiles", "metric2_tri", "metric2_levels",
                     "metric2_levels_tri", "metric2_pop", "metric2_pop_tri"):
            if ran[name] < 1:
                raise AssertionError(f"{name} was launched no time on the "
                                     f"decomposed paths")

    with phase("decomp3"):
        ran = check_decomp3(V2, V1, {name: k["wrapper"] for name, k in kernels.items()
                                     if name not in float32_forms + expr_forms})
        for name, n in ran.items():
            launches[name] += n
        print(f"  launches on the decomposed 3-way paths: "
              f"{ {name: n for name, n in ran.items() if n} }")
        for name in ("threeway_batch_levels", "metric2_levels", "threeway_batch_pop",
                     "metric2_pop", "threeway_batch", "mgemm"):
            if ran[name] < 1:
                raise AssertionError(f"{name} was launched no time on the "
                                     f"decomposed 3-way paths")

    with phase("obs_serve"):
        ran = check_obs_serve(engine, V2, prior,
                              {name: k["wrapper"] for name, k in kernels.items()
                               if name not in float32_forms + expr_forms})
        del prior
        for name, n in ran.items():
            launches[name] += n
        print(f"  launches on the traced and served paths: "
              f"{ {name: n for name, n in ran.items() if n} }")

    with phase("combines"):
        ran = check_combines(engine, V2, kernels, registered, ring_libs)
        launches.update(ran)
        print(f"  launches of the compiled combines on the campaign paths: {ran}")
        for name in expr_forms:
            if ran[name] < 1 and name != "threeway_step[expr]":
                raise AssertionError(f"{name} was launched no time on the campaign paths")

    record = []
    for name, k in kernels.items():
        record.append({
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": launches[name],
            "max_abs_err": max(k["errs"]),
            "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    return record


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="mesh_smoke_", dir=ROOT / "build"))
    dry = start_dryruns(work)
    try:
        return run_phases(work, dry)
    finally:
        for p in dry:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


def run_phases(work: Path, dry: list) -> int:
    import gc
    import threading

    import torch

    record = similarity_phases()
    # every tensor of the phases before is released with their frame
    gc.collect()
    torch.cuda.empty_cache()
    with phase("lm_serve"):
        print(f"  {torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated on the card "
              f"before the phase; {threading.active_count()} threads, "
              f"{len(gc.get_objects())} objects tracked by gc")
        check_lm_serve()
    gc.collect()
    torch.cuda.empty_cache()
    with phase("lm_train"):
        check_lm_train()
    gc.collect()
    torch.cuda.empty_cache()
    with phase("mesh"):
        check_mesh(work, dry)
    print(json.dumps({"kernels": record}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
