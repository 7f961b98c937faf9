"""Parameters for the port: converted from the JAX init, or drawn anew.

:func:`params_from_numpy` takes the JAX ``transformer.init_params`` pytree,
or RecLLM's ``recsys.model.init_recllm`` tree (``lm``, ``cf_user``,
``cf_item``, ``fusion_gate``), as numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns the port's dict: the same keys, the same ``(in,
out)`` weight orientation (no permutation: RoPE is split-half in both
packages), stacked ``blocks`` leaves kept ``(L, ...)``.

:func:`init_params` draws a fresh dict with the shapes and scales of the
JAX init (``transformer.init_params``, ``layers.init_dense`` /
``init_embedding`` / ``init_norm``) from a ``torch.Generator``;
:func:`repro_torch.recsys.model.init_recllm` adds RecLLM's CF tables and
gate.  The draws are not JAX's: parity tests convert JAX params instead.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ArchConfig
from repro_torch.models import layers
from repro_torch.models.transformer import check_ported, family

# Leaves the JAX init keeps in float32 whatever the model dtype (norm
# parameters, the MoE router and the qk-norm scales, rwkv6's token-shift
# mixes, decay base and bonus, RecLLM's CF tables and fusion gate); every
# other floating leaf is in the model dtype.
_F32_LEAVES = ("scale", "bias", "router", "q_norm", "k_norm", "mix",
               "w_base", "u", "cf_user", "cf_item", "fusion_gate")


def _to_tensor(x: np.ndarray, key: str, device, dtype) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":       # ml_dtypes: torch cannot take it
        t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(x))        # a writable copy
    if dtype is not None and t.is_floating_point() and key not in _F32_LEAVES:
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Dict, device=None,
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """JAX pytree of numpy arrays -> the port's dict of tensors on
    ``device`` (``cuda`` unless asked otherwise).  ``dtype``, when given,
    casts the model-dtype leaves (the norm parameters stay float32, as in
    the JAX init); ``None`` keeps every leaf's own dtype."""
    dev = resolve_device(device)

    def conv(node, key=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        return _to_tensor(node, key, dev, dtype)

    return conv(tree)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Fresh parameters for ``cfg`` from ``generator``: normal(0, 1) draws
    scaled by ``1/sqrt(in)`` for dense and expert weights (``d**-0.5`` for
    the float32 MoE router) and by 0.02 for the embedding, zeros for the
    RMSNorm and qk-norm scales, ones and zeros for layernorm, and rwkv6's
    constants (mixes 0.5, decay base -6, bonus 0), with the JAX init's
    shapes and key names.  Drawn in float32 on the generator's device one
    layer at a time (a whole stacked expert leaf in float32 would be a
    temporary of gigabytes), then cast to the model dtype on ``device``."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    L, d = cfg.num_layers, cfg.d_model

    def draw(shape, scale, out_dtype):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * scale).to(device=dev, dtype=out_dtype)

    def stacked(*shape, scale, out_dtype=dtype):
        out = torch.empty((L,) + shape, dtype=out_dtype, device=dev)
        for i in range(L):
            out[i] = draw(shape, scale, out_dtype)
        return out

    def dense(in_dim, out_dim):
        return stacked(in_dim, out_dim, scale=in_dim ** -0.5)

    def expert(in_dim, out_dim):
        return stacked(cfg.num_experts, in_dim, out_dim, scale=in_dim ** -0.5)

    def norm():
        return {k: v.expand(L, *v.shape).clone()
                for k, v in layers.init_norm(cfg, device=dev).items()}

    def const(value, *shape):
        return torch.full((L,) + shape, value, dtype=torch.float32,
                          device=dev)

    params = {"embed": draw((cfg.padded_vocab, d), 0.02, dtype),
              "final_norm": layers.init_norm(cfg, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = draw((d, cfg.padded_vocab), d ** -0.5, dtype)
    if family(cfg) == "rwkv6":          # ssm.init_rwkv6 / init_rwkv_cmix
        hs, f = cfg.rwkv_head_size, cfg.d_ff
        lora = max(32, d // 32)
        tmix = {"mix": const(0.5, 5, d),
                **{n: dense(d, d) for n in ("Wr", "Wk", "Wv", "Wg", "Wo")},
                "w_base": const(-6.0, d),
                "w_lora_a": dense(d, lora), "w_lora_b": dense(lora, d),
                "u": const(0.0, d // hs, hs), "ln_x": norm()}
        cmix = {"mix": const(0.5, 2, d), "Wk": dense(d, f),
                "Wv": dense(f, d), "Wr": dense(d, d)}
        params["blocks"] = {"tmix": tmix, "cmix": cmix, "norm1": norm(),
                            "norm2": norm()}
        return params
    attn = {"norm": norm(), "wq": dense(d, cfg.q_dim),
            "wk": dense(d, cfg.kv_dim), "wv": dense(d, cfg.kv_dim),
            "wo": dense(cfg.q_dim, d)}
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            attn[name] = torch.zeros((L, cfg.head_dim), dtype=torch.float32,
                                     device=dev)
    f = cfg.d_ff
    mats = ((("wi_gate", d, f), ("wi_up", d, f)) if cfg.mlp_gated
            else (("wi", d, f),)) + (("wo", f, d),)
    ffn = {"norm": norm()}
    if cfg.is_moe:
        ffn["moe"] = {"router": stacked(d, cfg.num_experts, scale=d ** -0.5,
                                        out_dtype=torch.float32),
                      **{n: expert(i, o) for n, i, o in mats}}
    else:
        ffn["mlp"] = {n: dense(i, o) for n, i, o in mats}
    params["blocks"] = {"attn": attn, "ffn": ffn}
    return params
