"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``core``, ``kernels``, ``api``) so
each module's counterpart is easy to find, and it is held against ``repro``
by exact campaign checksums (paper §5).  It imports ``torch`` and numpy
only: never ``jax`` and never a module of ``repro``.

Ported so far, on one device: the 2-way campaign under ``impl`` in
{"xla", "levels_xla", "pallas", "levels"} and the 3-way campaign (any
``n_st`` and ``stages``) under the same impls, on the plane ring and on the
levels value ring, and the stand-alone contractions
(``repro_torch.core.mgemm.mgemm`` / ``mgemm_vt_v``), with hand-written CUDA
kernels (``csrc/``) for all 12 of ``repro``'s Pallas kernels: the min-plus
value kernels (triangular, rectangular and the 3-way slice,
``impl="pallas"``), the packed bit-plane kernels (triangular, rectangular
and the 3-way slice, ``impl="levels"``) and the int8 tensor-core
level-decomposition GEMM (``impl="levels"`` on values); batched campaigns;
the dataset store and its CLIs; out-of-core streamed campaigns
(``repro_torch.stream``) and border-block delta campaigns
(``repro_torch.core.delta``); tracing with an analytic H100 roofline
(``repro_torch.obs``) and the campaign server ``SimilarityService``
(``repro_torch.serve``); every 2-way and 3-way entry point at any
decomposition (n_pf, n_pv, n_pr) on a single-controller mesh of ranks
(``repro_torch.parallel``; several ranks may share one card); and the LM
stack, which has no Pallas kernel in ``repro`` to port: every model
family's forward, loss, gradients (autograd, activation checkpointing
under ``cfg.remat``) and decode step (``repro_torch.models``), the ten LM
configs, ``ServeEngine`` and ``python -m repro_torch.launch.serve``, and
training: AdamW, schedules and gradient compression (``optim``), the
synthetic token pipeline (``data.tokens``), checkpoints in ``repro``'s
layout (``checkpoint``), the fault-tolerant ``Trainer`` (``train``) and
``python -m repro_torch.launch.train``; and the LM stack on a
``DeviceMesh``: ``repro``'s sharding rules as DTensor placements
(``parallel.sharding``), ``Trainer`` / ``ServeEngine`` on a mesh, and the
dry-run (``python -m repro_torch.launch.dryrun``) with its per-device
counts and H100 roofline (``roofline``).

    from repro_torch.api import SimilarityEngine, SimilarityRequest

    engine = SimilarityEngine()            # device="cuda"; raises without a GPU
    result = engine.run(SimilarityRequest(impl="pallas"), V)
    tri = engine.run(SimilarityRequest(way=3, n_st=2, impl="pallas"), V)
    ring = SimilarityEngine(devices=["cuda:0"] * 4).run(
        SimilarityRequest(n_pv=4, impl="pallas"), V)   # four ranks, one card
    ring3 = SimilarityEngine(devices=["cuda:0"] * 4).run(
        SimilarityRequest(way=3, n_pv=4, impl="levels"), V)

    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config("llama3-8b")
    model = api.init_model(cfg, generator=torch.Generator("cuda").manual_seed(0))
    tokens = ServeEngine(cfg, model, ServeConfig(max_new_tokens=16)).generate(prompts)

    from repro_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(get_config("qwen1.5-0.5b"), TrainerConfig(steps=100))
    state = trainer.train()                # resumes from its latest checkpoint
"""


def unported(what: str, item: str) -> NotImplementedError:
    """The error for a part of ``repro`` this port does not run yet; ``item``
    names its ROADMAP.md queue entry."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


def resolve_device(device, who: str):
    """``device`` as a ``torch.device``; None means ``"cuda"``, which raises
    RuntimeError naming ``who`` when no GPU is available: nothing moves to
    the CPU unless the caller asks for it."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; pass device='cpu' to run "
            f"on the CPU"
        )
    return device
