"""1-bit (EF-signSGD) gradient compression: the wrappers of
``csrc/grad_compress.cu``.

Ports of the Pallas TPU kernels ``repro/kernels/grad_compress.py`` (paper
Eq. 10).  Layout: the flat gradient of N floats viewed as (8, M), M =
N / 8; bit j of ``packed[c]`` is the sign of ``g2d[j, c]`` (``x >= 0``
packs 1, so an exact zero dequantizes to +scale); one float32 mean |g| per
(8, block) tile of columns.  The kernels' design notes are at the top of
the CUDA source.

CPU tensors go to the plain versions (:mod:`repro_torch.kernels.ref`);
CUDA tensors launch the kernel or raise.  Each wrapper counts its launches
in ``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def onebit_quantize(g2d, block: int = 512):
    """g2d (8, M) f32 -> (packed (M,) uint8, scales (M / block,) f32)."""
    _build.refuse_grad("onebit_quantize", g2d)
    rows, M = g2d.shape
    if rows != 8 or M % block:
        raise ValueError(f"onebit_quantize: shape {tuple(g2d.shape)} (want "
                         f"(8, M) with M a multiple of block={block})")
    if g2d.device.type == "cpu":
        return ref.onebit_quantize(g2d, block)
    _build.check_dense("onebit_quantize", (g2d, torch.float32))
    packed = torch.empty((M,), dtype=torch.uint8, device=g2d.device)
    scales = torch.empty((M // block,), dtype=torch.float32,
                         device=g2d.device)
    err = _build.entry("repro_onebit_quantize")(
        g2d.data_ptr(), packed.data_ptr(), scales.data_ptr(), M, block,
        torch.cuda.current_stream(g2d.device).cuda_stream)
    _build.check("onebit_quantize", err)
    onebit_quantize.launches += 1
    return packed, scales


def onebit_dequantize(packed, scales, block: int = 512):
    """packed (M,) or (R, M) uint8 and scales (M / block,) or (R, M /
    block) f32 -> (8, M) or (R, 8, M) f32.  R payloads (the ranks'
    gathered ones) take one launch."""
    _build.refuse_grad("onebit_dequantize", packed, scales)
    M = packed.shape[-1]
    if M % block or scales.shape != packed.shape[:-1] + (M // block,):
        raise ValueError(f"onebit_dequantize: packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, block={block}")
    if packed.device.type == "cpu":
        return ref.onebit_dequantize(packed, scales, block)
    _build.check_dense("onebit_dequantize", (packed, torch.uint8),
                       (scales, torch.float32))
    R = packed.shape[0] if packed.dim() == 2 else 1
    out = torch.empty(packed.shape[:-1] + (8, M), dtype=torch.float32,
                      device=packed.device)
    err = _build.entry("repro_onebit_dequantize")(
        packed.data_ptr(), scales.data_ptr(), out.data_ptr(), R, M, block,
        torch.cuda.current_stream(packed.device).cuda_stream)
    _build.check("onebit_dequantize", err)
    onebit_dequantize.launches += 1
    return out


# kernel launches since the last reset
onebit_quantize.launches = 0
onebit_dequantize.launches = 0
