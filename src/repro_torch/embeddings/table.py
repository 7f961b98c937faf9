"""Embedding-table specs and init (port of the unsharded part of
``repro/embeddings/table.py``).

Only what :func:`repro_torch.recsys.model.init_recllm` needs: the table
spec and its scaled-normal init.  The placement plans and their cost model
wait for the sparse-embedding slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EmbedSpec:
    """One logical table: ``rows`` ids x ``dim`` features."""

    name: str
    rows: int
    dim: int
    init_scale: float = 0.02
    dtype: str = "float32"

    @property
    def bytes(self) -> int:
        return self.rows * self.dim * getattr(torch, self.dtype).itemsize


def init_table(generator: torch.Generator, spec: EmbedSpec,
               device=None) -> torch.Tensor:
    """Full-table init, normal * ``init_scale`` (the CF-factor convention),
    drawn in float32 on the generator's device.  The draws are not JAX's:
    parity tests convert the JAX init instead."""
    x = torch.randn((spec.rows, spec.dim), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (x * spec.init_scale).to(device=device,
                                    dtype=getattr(torch, spec.dtype))
