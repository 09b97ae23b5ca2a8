"""repro_torch.launch: the port's command-line entry points.

    python -m repro_torch.launch.dataset {encode,append,inspect,validate} ...
    python -m repro_torch.launch.similarity --way 2 --dataset ds/ ...
    python -m repro_torch.launch.serve --arch llama3-8b --smoke
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke

The same flags, defaults and printed lines as ``repro.launch``'s CLIs of
the same names, plus ``--device {cuda,cpu}`` (default ``cuda``): the card
unless the caller asks for the CPU.
"""
import sys


def no_device(device: str) -> bool:
    """Print the error line and return True when ``device`` is "cuda" and
    no CUDA device is available (the CLIs then exit 2)."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is available; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return True
    return False
