"""RWKV-6 (Finch) layers: the data-dependent-decay time-mix and the
channel-mix (port of the rwkv6 half of ``repro/models/ssm.py``; Mamba is
not ported yet, ``ROADMAP.md``).

The WKV recurrence runs three ways, as in the JAX package:

* the one-token decode step (``T == 1``): a single sequential update of the
  per-head (hs, hs) state;
* :func:`_wkv6_chunked`, the model's plain path for ``T > 1``: the state is
  carried once per chunk and the intra-chunk terms go through decay
  matrices whose exponents are all <= 0 (no overflow);
* with ``use_kernel`` and no incoming state (the no-cache forward, and the
  serving prefill from a zero state), the CUDA kernel
  :func:`repro_torch.kernels.ops.wkv6_chunked`, which also returns the final
  state.  The chunk is ``gcd(wkv_chunk, T)``, as the plain path picks it.

Serving hooks: ``true_len`` freezes the pads of a right-padded prompt (``w =
1`` and ``k = 0``), so the returned state and shift are exactly those after
``true_len`` real tokens; :func:`scatter_slot_state` writes one request's
states into its slot row, in place (the JAX package returns a new tree).

Training under a sharding plan (``tp``, :class:`repro_torch.core.sharding.
TPHooks`; what GSPMD places by JAX's ``tmix``/``cmix`` rules): both blocks
take the whole sequence through ``tp.enter`` before the token shift, work
on this rank's heads or ``d_ff`` columns and leave through ``tp.exit``.
The WKV then runs :func:`_wkv6_chunked` on the rank's heads (the kernel
has no backward).  With ``tp`` None every call computes what it did
before.
"""
from __future__ import annotations

import math
import types
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.kernels import ref
from repro_torch.models import layers

_LN_X = types.SimpleNamespace(norm_type="layernorm")   # ln_x: full-d layernorm


def _to_bhts(*ts):
    return tuple(t.transpose(1, 2) for t in ts)


def _wkv6_scan(r, k, v, w, u):
    """Sequential WKV recurrence (oracle) from a zero state.  r, k, v, w
    (B, T, H, hs), w the decay in (0, 1); u (H, hs) -> (out (B, T, H, hs)
    f32, final S (B, H, hs, hs) f32)."""
    o, S = ref.wkv6_scan(*_to_bhts(r, k, v, w), u)
    return o.transpose(1, 2), S


def _wkv6_chunked(r, k, v, w, u, S0=None, chunk: int = 32):
    """Chunked WKV (the train/prefill path) from ``S0`` (zeros when None);
    a chunk that does not divide T falls back to gcd(chunk, T).  Layout
    (B, T, H, hs) -> (out (B, T, H, hs) f32, final S (B, H, hs, hs) f32);
    the math is :func:`repro_torch.kernels.ref.wkv6_chunked_state`."""
    T = r.shape[1]
    chunk = min(chunk, T)
    if T % chunk:
        chunk = math.gcd(chunk, T)
    o, S = ref.wkv6_chunked_state(*_to_bhts(r, k, v, w), u, chunk, S0=S0)
    return o.transpose(1, 2), S


def rwkv6_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                  state: Dict = None, wkv_chunk: int = 32, true_len=None,
                  use_kernel: bool = False, tp=None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Time-mix block.  x (B, T, d); state {'last': (B, d), 'wkv': (B, H,
    hs, hs)} or None.  Returns (out (B, T, d), {'last', 'wkv'}).

    ``true_len`` (serving prefill): pad positions get ``w = 1`` (log-decay
    0) and ``k = 0``, so the WKV recurrence is frozen past the true prompt
    end.  ``use_kernel``: a ``T > 1`` call with no incoming state runs the
    WKV through the CUDA kernel (its plain version on CPU tensors).

    ``tp`` (training): ``x`` is this rank's part of the residual stream
    and ``p`` its shards (``H / tp`` heads); the returned state covers
    those heads."""
    if tp is not None:
        x = tp.enter(x)
        # used on the whole input to form only this rank's columns: their
        # gradients are partial, summed over model
        p = {**p, "mix": tp.copy(p["mix"]),
             "w_lora_a": tp.copy(p["w_lora_a"])}
    B, T, d_in = x.shape
    d = p["Wr"].shape[-1]                   # this rank's channels
    hs = cfg.rwkv_head_size
    H = d // hs
    last = (x.new_zeros((B, 1, d_in)) if state is None
            else state["last"][:, None])
    x_prev = torch.cat([last, x[:, :-1]], dim=1)           # token shift
    xf, pf = x.float(), x_prev.float()

    def mixed(i):
        m = p["mix"][i]
        return (xf * m + pf * (1 - m)).to(x.dtype)

    r = (mixed(0) @ p["Wr"]).reshape(B, T, H, hs).float()
    k = (mixed(1) @ p["Wk"]).reshape(B, T, H, hs).float()
    v = (mixed(2) @ p["Wv"]).reshape(B, T, H, hs).float()
    wx = mixed(3)
    g = F.silu(mixed(4) @ p["Wg"])
    w_delta = torch.tanh(wx @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(p["w_base"] + w_delta.float()))
    w = w.reshape(B, T, H, hs)
    if true_len is not None:
        live = (torch.arange(T, device=x.device)
                < true_len)[None, :, None, None]
        w = torch.where(live, w, 1.0)
        k = k * live

    S0 = None if state is None else state["wkv"]
    if T == 1:
        # decode: one sequential step (no chunk machinery)
        S = S0 if S0 is not None else r.new_zeros((B, H, hs, hs))
        kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]
        o = torch.einsum("bhk,bhkv->bhv", r[:, 0], S + p["u"][..., None] * kv)
        S_f = w[:, 0, :, :, None] * S + kv
        out = o[:, None]
    elif use_kernel and S0 is None:
        from repro_torch.kernels import ops
        chunk = min(wkv_chunk, T)
        if T % chunk:
            chunk = math.gcd(chunk, T)
        # the kernel reads the transposed views through their strides and
        # lays o out as r: (B, T, H, hs) in memory, so no copy either way
        o, S_f = ops.wkv6_chunked(*_to_bhts(r, k, v, w), p["u"], chunk=chunk,
                                  return_state=True)
        out = o.transpose(1, 2)
    else:
        out, S_f = _wkv6_chunked(r, k, v, w, p["u"], S0, chunk=wkv_chunk)

    out = out.reshape(B, T, d).to(x.dtype)
    if tp is None:
        out = layers.apply_norm(_LN_X, p["ln_x"], out)
    else:                                   # a layer norm over all d
        out = tp.channel_norm(_LN_X, p["ln_x"], out)
    out = (out * g) @ p["Wo"]
    if tp is not None:
        out = tp.exit(out)
    last = x[:, -1] if true_len is None else x[:, true_len - 1]
    return out, {"last": last, "wkv": S_f}


def init_rwkv6_state(cfg: ArchConfig, batch: int, device=None) -> Dict:
    d, hs = cfg.d_model, cfg.rwkv_head_size
    return {"last": torch.zeros((batch, d), dtype=getattr(torch, cfg.dtype),
                                device=device),
            "wkv": torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32,
                               device=device)}


def rwkv_cmix_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor, state=None,
                      true_len=None, tp=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV channel-mix (the FFN counterpart, with token shift and a
    receptance gate).  x (B, T, d); state (B, d) or None.  Returns (out,
    the shift state: the input at the last real position).

    ``tp`` (training): ``Wk``/``Wv`` are this rank's ``d_ff`` shards.
    Every rank computes the whole gate from the replicated ``Wr`` and
    applies it to its partial output, so the sum over ``model`` is the
    gated sum and the gate's gradient, partial like the rest, is summed
    over ``model`` (``copy``)."""
    if tp is not None:
        x = tp.enter(x)
        p = {**p, "mix": tp.copy(p["mix"]), "Wr": tp.copy(p["Wr"])}
    B, T, d = x.shape
    last = x.new_zeros((B, 1, d)) if state is None else state[:, None]
    x_prev = torch.cat([last, x[:, :-1]], dim=1)
    xf, pf = x.float(), x_prev.float()
    xk = (xf * p["mix"][0] + pf * (1 - p["mix"][0])).to(x.dtype)
    xr = (xf * p["mix"][1] + pf * (1 - p["mix"][1])).to(x.dtype)
    k = torch.square(F.relu(xk @ p["Wk"]))
    out = torch.sigmoid(xr @ p["Wr"]) * (k @ p["Wv"])
    if tp is not None:
        out = tp.exit(out)
    shift = x[:, -1] if true_len is None else x[:, true_len - 1]
    return out, shift


def scatter_slot_state(states: Dict, update: Dict, slot: int,
                       batch_axis: int) -> Dict:
    """Write one request's state rows into slot ``slot`` of a slot-indexed
    state dict, in place.  ``update`` entries match ``states`` entries but
    for a size-1 dim at ``batch_axis`` (the single prefilled request)."""
    for key, dst in states.items():
        dst.select(batch_axis, slot).copy_(update[key].select(batch_axis, 0))
    return states
