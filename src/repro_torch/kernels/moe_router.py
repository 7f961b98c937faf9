"""Fused MoE router and route: the wrappers of ``csrc/moe_router.cu``.

Port of the Pallas TPU kernel ``repro/kernels/moe_router.py`` (paper
section III.A.c): softmax over each token's E expert logits in float32,
k rounds of max-and-mask with the first-occurrence tie-break (the lowest
expert index among equal maxima), and the k gates renormalized by
``max(sum, 1e-9)``.  :func:`moe_route` is the same kernel's second entry
point: that routing plus everything the MoE FFN builds from it before the
expert products (the capacity places, the dispatch and combine tensors,
the loads), in one launch.  The kernel's design notes are at the top of
the CUDA source.

CPU tensors go to the plain versions (:func:`repro_torch.kernels.ref
.moe_router`, :func:`repro_torch.kernels.ref.moe_route`); CUDA tensors
launch the kernel or raise.  Each wrapper counts its launches in
``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_EXPERTS = 128      # one warp, 4 values a lane (csrc); the TPU kernel's
                       # single 128-lane tile
MAX_GROUP = 1024       # moe_route: a group's tokens in one block (csrc)
ROUTE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def moe_route(logits, k: int, C: int, live=None, dtype=torch.float32):
    """logits (g, G, E) -> :class:`repro_torch.kernels.ref.Route`: the
    router on every token, then in each group of G tokens the slot-major
    queue places, the capacity-C dispatch and combine tensors in ``dtype``
    and the loads; ``live`` (g, G) masks dead tokens out of the queues."""
    _build.refuse_grad("moe_route", logits)
    if logits.dim() != 3:
        raise ValueError(f"moe_route: logits {tuple(logits.shape)} (want "
                         "(g, G, E))")
    g, G, E = logits.shape
    if E > MAX_EXPERTS:
        raise ValueError(f"moe_route: E={E} experts > {MAX_EXPERTS}, the "
                         "widest row the kernel keeps in one warp")
    if G > MAX_GROUP:
        raise ValueError(f"moe_route: group of G={G} tokens > {MAX_GROUP}, "
                         "the most one block places")
    if not 1 <= k <= E:
        raise ValueError(f"moe_route: k={k} outside [1, E={E}]")
    if C < 1 or E * C >= 2 ** 31:
        raise ValueError(f"moe_route: capacity C={C}")
    if dtype not in ROUTE_DTYPES:
        raise ValueError(f"moe_route: dtype {dtype} (want float32|bfloat16|"
                         "float16)")
    if live is not None:
        live = live.reshape(g, G)
    if logits.device.type == "cpu":
        return ref.moe_route(logits, k, C, live, dtype)
    x = logits.to(torch.float32).contiguous()
    _build.check_dense("moe_route", (x, torch.float32))
    dev = x.device
    if live is not None:                # read as bytes: nonzero is live
        live = live.to(dev)
        if live.dtype not in (torch.bool, torch.uint8):
            live = live != 0
        live = live.contiguous()
    gates = torch.empty((g, G, k), dtype=torch.float32, device=dev)
    idx = torch.empty((g, G, k), dtype=torch.int32, device=dev)
    probs = torch.empty((g, G, E), dtype=torch.float32, device=dev)
    place = torch.empty((g, G, k), dtype=torch.int32, device=dev)
    dispatch = torch.empty((g, G, E, C), dtype=dtype, device=dev)
    combine = torch.empty((g, G, E, C), dtype=dtype, device=dev)
    # per group the loads and top-1 counts, then (row g) their totals
    counts = torch.empty((2, g + 1, E), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.entry("repro_moe_route")(
        x.data_ptr(), None if live is None else live.data_ptr(),
        gates.data_ptr(), idx.data_ptr(), probs.data_ptr(), place.data_ptr(),
        dispatch.data_ptr(), combine.data_ptr(), counts.data_ptr(),
        _ticket(dev, stream).data_ptr(), g, G, E, k, C, ROUTE_DTYPES[dtype],
        stream)
    _build.check("moe_route", err)
    moe_route.launches += 1
    return ref.Route(dispatch, combine, gates, idx, probs, place,
                     counts[1, g], counts[0, g])


_tickets = {}     # (device, stream) -> its ticket; kept for the process,
                  # as the kernel's protocol needs the same zeroed int


def _ticket(dev, stream: int):
    """The route kernel's ticket for launches on ``stream`` of ``dev``: one
    int32, 0 between launches (the kernel's last block to finish resets
    it), made once.  One a stream, so launches that may overlap never share
    one; a launch that stops between taking and resetting it has faulted,
    and a fault ends the CUDA context with every later launch."""
    t = _tickets.get((dev, stream))
    if t is None:
        t = _tickets[dev, stream] = torch.zeros(1, dtype=torch.int32,
                                                device=dev)
    return t


moe_router.launches = 0      # kernel launches since the last reset
moe_route.launches = 0
