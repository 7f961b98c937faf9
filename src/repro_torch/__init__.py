"""PyTorch/CUDA port of ``repro``: RecLLM's serving path and its
data-parallel training step with gradient compression, on GPUs.

The package mirrors ``src/repro/`` module by module and imports nothing of
it (nor ``jax``): what it needs from the JAX package's jax-free modules is
copied here.  Plain tensor code is PyTorch; the TPU kernels on the ported
paths are hand-written CUDA C++ kernels under ``kernels/csrc/``.

Entry points (``init_params``, ``init_recllm``, ``make_backend``,
``NativeBackend``, ``serve``, the launchers) run on ``cuda`` unless the
caller passes ``device="cpu"``.  Without CUDA they raise; they never fall
back to the CPU on their own.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and is
    not available, instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
