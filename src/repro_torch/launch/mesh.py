"""Meshes over the ``torch.distributed`` world (port of
``repro/launch/mesh.py``'s ``make_host_mesh``).

The world is initialised first (``torchrun``, or a world of one); the mesh
names its ranks by axis, row-major over ``pod, data, model``
(:func:`repro_torch.core.hierarchical.make_mesh`).
"""
from __future__ import annotations

from repro_torch.core.hierarchical import DPMesh, make_mesh


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   stage: int = 0) -> DPMesh:
    """A ``(pod?, data, model)`` mesh over the world, whose size must be
    ``max(pod, 1) * data * model``.  ``pod > 0`` adds the pod axis;
    ``stage > 0`` (the pipelined step's axis) is not ported yet."""
    if stage:
        raise NotImplementedError(
            "a 'stage' axis (the pipelined step) is not ported yet "
            "(ROADMAP.md)")
    shape = ({"pod": pod} if pod else {}) | {"data": data, "model": model}
    return make_mesh(shape)
