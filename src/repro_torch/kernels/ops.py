"""Public entry points of the attention kernels (port of ``repro/kernels/ops.py``).

``impl="kernel"`` runs the kernel wrapper, which launches the CUDA kernel
for CUDA tensors and runs the plain version for CPU tensors; ``impl="ref"``
forces the plain version.  :func:`decode_attention` is the one decode entry
point keyed off a :class:`~repro_torch.cache_layout.CacheLayout`; this
slice serves the dense 16-bit layout (other layouts raise).
"""
from __future__ import annotations

from repro_torch.cache_layout import require_dense16
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import flash_decode_attention
from repro_torch.kernels.flash_attention import flash_attention as _flash


def _check_impl(impl: str) -> None:
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl {impl!r} (want kernel|ref)")


# -- flash attention ---------------------------------------------------------

def flash_attention_bhsd(q, k, v, *, causal=True, window=0,
                         softmax_scale=None, impl="kernel"):
    """Layout (B, H, S, D)."""
    _check_impl(impl)
    if impl == "ref":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softmax_scale=softmax_scale)
    return _flash(q, k, v, causal=causal, window=window,
                  softmax_scale=softmax_scale)


def flash_attention(q, k, v, *, causal=True, window=0, softmax_scale=None,
                    impl="kernel"):
    """Layout (B, S, H, D) -- the model-stack layout.  The kernel reads the
    transposed views through their strides; nothing is copied."""
    o = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window,
                             softmax_scale=softmax_scale, impl=impl)
    return o.transpose(1, 2)


# -- flash-decode attention ---------------------------------------------------

def decode_attention(q, cache, lengths, *, layout, softmax_scale=None,
                     q_lens=None):
    """THE decode-attention entry point, keyed off one CacheLayout.  ``cache``
    is ``{"k", "v"}`` with (B, S, Hk, D) per-slot rows; ``layout.impl``
    selects the plain oracle (``ref``), the dense einsum (``dense``) or the
    CUDA flash-decode kernel (``flash``); ``layout.window``/``layout.ring``
    the masking variant; ``q_lens`` (B,) the live draft rows of a k-row
    verify."""
    require_dense16(layout)
    k, v = cache["k"], cache["v"]
    if layout.impl == "ref":
        return ref.decode_attention(q, k, v, lengths, window=layout.window,
                                    ring=layout.ring,
                                    softmax_scale=softmax_scale,
                                    q_lens=q_lens)
    if layout.impl == "dense":
        from repro_torch.models import attention
        return attention.decode_attention(
            q, k, v, lengths, window=layout.window, ring=layout.ring,
            softmax_scale=softmax_scale, impl="dense", q_lens=q_lens)
    return flash_decode_attention(q, k, v, lengths, window=layout.window,
                                  ring=layout.ring,
                                  softmax_scale=softmax_scale, q_lens=q_lens)


def flash_decode(q, k_cache, v_cache, lengths, *, window=0, ring=False,
                 softmax_scale=None, impl="kernel", q_lens=None):
    """Decode over per-slot live cache prefixes.  q (B, Sq, H, D); caches
    (B, S, Hk, D); lengths (B,); q_lens (B,) live draft rows when Sq > 1."""
    _check_impl(impl)
    if impl == "ref":
        return ref.decode_attention(q, k_cache, v_cache, lengths,
                                    window=window, ring=ring,
                                    softmax_scale=softmax_scale,
                                    q_lens=q_lens)
    return flash_decode_attention(q, k_cache, v_cache, lengths,
                                  window=window, ring=ring,
                                  softmax_scale=softmax_scale, q_lens=q_lens)
