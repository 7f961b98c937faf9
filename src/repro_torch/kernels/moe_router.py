"""Fused MoE router: the wrapper of ``csrc/moe_router.cu``.

Port of the Pallas TPU kernel ``repro/kernels/moe_router.py`` (paper
section III.A.c): softmax over each token's E expert logits in float32,
k rounds of max-and-mask with the first-occurrence tie-break (the lowest
expert index among equal maxima), and the k gates renormalized by
``max(sum, 1e-9)``.  The kernel's design notes are at the top of the CUDA
source.

CPU tensors go to the plain version (:func:`repro_torch.kernels.ref
.moe_router`); CUDA tensors launch the kernel or raise.  The wrapper counts
its launches in ``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_EXPERTS = 128      # one warp, 4 values a lane (csrc); the TPU kernel's
                       # single 128-lane tile


def moe_router(logits, k: int):
    """logits (T, E) -> (gates (T, k) f32, idx (T, k) int32, probs (T, E)
    f32)."""
    _build.refuse_grad("moe_router", logits)
    if logits.dim() != 2:
        raise ValueError(f"moe_router: logits {tuple(logits.shape)} (want "
                         "(T, E))")
    T, E = logits.shape
    if E > MAX_EXPERTS:
        raise ValueError(f"moe_router: E={E} experts > {MAX_EXPERTS}, the "
                         "widest row the kernel keeps in one warp")
    if not 1 <= k <= E:
        raise ValueError(f"moe_router: k={k} outside [1, E={E}]")
    if logits.device.type == "cpu":
        return ref.moe_router(logits, k)
    x = logits.to(torch.float32).contiguous()
    _build.check_dense("moe_router", (x, torch.float32))
    gates = torch.empty((T, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=x.device)
    probs = torch.empty((T, E), dtype=torch.float32, device=x.device)
    err = _build.entry("repro_moe_router")(
        x.data_ptr(), gates.data_ptr(), idx.data_ptr(), probs.data_ptr(), T,
        E, k, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("moe_router", err)
    moe_router.launches += 1
    return gates, idx, probs


moe_router.launches = 0      # kernel launches since the last reset
