"""Fused AdamW update: the wrapper of ``csrc/fused_adamw.cu``.

Port of the Pallas TPU kernel ``repro/kernels/fused_adamw.py``: one pass
that reads p, g, m, v and writes p', m', v' (7 streams, where the
elementwise graph of ``optimizer/adamw.py`` makes about 15 passes).  The
hyperparameters travel as one (8,) f32 tensor on the leaf's device,
``(lr, b1, b2, eps, wd, bc1, bc2, 0)``, as the TPU kernel's (1, 8)
operand: :func:`hyper` builds it from device scalars and fills, so a step
never waits on the host for them.  The kernel takes any N (the TPU
kernel's tiling asserts on some); its design notes are at the top of the
CUDA source.

CPU tensors go to the plain version (:func:`repro_torch.kernels.ref
.adamw_update`, with the hyperparameters as f32 values); CUDA tensors
launch the kernel or raise.  The wrapper counts its launches in
``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def hyper(lr, bc1, bc2, *, b1: float, b2: float, eps: float, wd: float,
          device) -> torch.Tensor:
    """(8,) f32 on ``device``: (lr, b1, b2, eps, wd, bc1, bc2, 0).  Tensor
    values are copied on the device, Python numbers filled there."""
    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32).reshape(())
        return torch.full((), x, dtype=torch.float32, device=device)

    return torch.stack([f32(x) for x in (lr, b1, b2, eps, wd, bc1, bc2,
                                         0.0)])


def adamw_update(p, g, m, v, hyper_t):
    """p, g, m, v flat (N,) f32, hyper_t (8,) f32 -> (p', m', v'), new
    tensors."""
    _build.refuse_grad("adamw_update", p, g, m, v)
    if p.dim() != 1 or any(t.shape != p.shape for t in (g, m, v)) \
            or hyper_t.shape != (8,):
        shapes = [tuple(t.shape) for t in (p, g, m, v, hyper_t)]
        raise ValueError(f"adamw_update: shapes {shapes} (want four (N,) "
                         "and (8,))")
    if p.device.type == "cpu":
        h = hyper_t
        return ref.adamw_update(p, g, m, v, lr=h[0], b1=h[1], b2=h[2],
                                eps=h[3], wd=h[4], bc1=h[5], bc2=h[6])
    _build.check_dense("adamw_update", *((t, torch.float32)
                                         for t in (p, g, m, v, hyper_t)))
    p1, m1, v1 = (torch.empty_like(p) for _ in range(3))
    err = _build.entry("repro_adamw_update")(
        hyper_t.data_ptr(), p.data_ptr(), g.data_ptr(), m.data_ptr(),
        v.data_ptr(), p1.data_ptr(), m1.data_ptr(), v1.data_ptr(),
        p.shape[0], torch.cuda.current_stream(p.device).cuda_stream)
    _build.check("adamw_update", err)
    adamw_update.launches += 1
    return p1, m1, v1


adamw_update.launches = 0    # kernel launches since the last reset
