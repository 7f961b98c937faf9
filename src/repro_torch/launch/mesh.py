"""Meshes over the ``torch.distributed`` world (port of
``repro/launch/mesh.py``'s ``make_host_mesh``).

The world is initialised first (``torchrun``, or a world of one); the mesh
names its ranks by axis, row-major over ``pod, data, model, stage``
(:func:`repro_torch.core.hierarchical.make_mesh`).
"""
from __future__ import annotations

from repro_torch.core.hierarchical import DPMesh, make_mesh


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   stage: int = 0) -> DPMesh:
    """A ``(pod?, data, model, stage?)`` mesh over the world, whose size
    must be ``max(pod, 1) * data * model * max(stage, 1)``.  ``pod > 0``
    adds the pod axis; ``stage > 0`` appends the pipeline-stage axis (the
    pipelined DP x TP x stage step), last, as JAX's ``make_host_mesh``
    does."""
    shape = (({"pod": pod} if pod else {}) | {"data": data, "model": model}
             | ({"stage": stage} if stage else {}))
    return make_mesh(shape)
