"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

One subpackage per ``repro.kernels`` family (``mgemm``, ``mgemm_levels``,
``popgemm``, ``czek3``); CUDA sources live in ``repro_torch/csrc`` and are built by
``build``.  Every wrapper runs its plain version on a CPU tensor and
launches its kernel (or raises) on a CUDA tensor, and counts its launches in
``<wrapper>.launches``."""
