"""Port kernels against the JAX Pallas kernels (interpret mode on the CPU).

The same numpy inputs go through ``repro.kernels.ops`` (the Pallas kernel,
interpreted) and ``repro_torch.kernels.ops`` (on CPU tensors: the plain
version each CUDA wrapper runs there).  Tolerance 1e-5 absolute in float32:
both sides compute in float32 and differ only in summation order.  The
cases use head_dim 32, a width the CUDA kernels take: ``chip_smoke.py``
runs every one of them through the kernels on the GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.cache_layout import CacheLayout
from repro_torch.kernels import ops as tops

torch.set_num_threads(2)

TOL = 1e-5

# (B, H, Hk, S, causal, window): G = 1 and 4; S not a block multiple
PREFILL_CASES = [
    (1, 2, 2, 40, True, 0),
    (2, 4, 1, 40, True, 8),
    (1, 4, 1, 33, True, 0),
    (1, 2, 2, 24, False, 0),
    (1, 4, 2, 37, False, 5),
]

# (B, Sq, H, Hk, S, lengths, q_lens, window, ring)
DECODE_CASES = [
    (4, 1, 2, 2, 40, [0, 1, 40, 17], None, 0, False),       # len 0 / 1 / S
    (4, 1, 8, 2, 40, [0, 1, 40, 23], None, 0, False),       # GQA G=4
    (4, 1, 2, 2, 40, [0, 1, 5, 40], None, 16, False),       # window > len
    (4, 1, 2, 2, 16, [0, 3, 16, 29], None, 12, True),       # ring wraps
    (4, 3, 2, 2, 40, [0, 5, 20, 38], [3, 1, 2, 3], 0, False),   # k rows
    (4, 2, 8, 2, 16, [1, 7, 16, 25], [2, 1, 2, 2], 12, True),   # k rows, ring
    (3, 3, 2, 2, 40, [2, 30, 38], [3, 2, 1], 6, False),     # k rows, window
]

D = 32
BLOCK = 16


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _prefill_inputs(case, seed=0):
    B, H, Hk, S, causal, window = case
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, H, S, D), _rand(rng, B, Hk, S, D),
            _rand(rng, B, Hk, S, D)), dict(causal=causal, window=window)


def _decode_inputs(case, seed=0):
    B, Sq, H, Hk, S, lengths, q_lens, window, ring = case
    rng = np.random.default_rng(seed)
    arrs = (_rand(rng, B, Sq, H, D), _rand(rng, B, S, Hk, D),
            _rand(rng, B, S, Hk, D), np.asarray(lengths, np.int32),
            None if q_lens is None else np.asarray(q_lens, np.int32))
    return arrs, dict(window=window, ring=ring)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_flash_attention_matches_pallas(case):
    (q, k, v), kw = _prefill_inputs(case)
    want = np.asarray(jops.flash_attention_bhsd(
        _j(q), _j(k), _j(v), block_q=BLOCK, block_k=BLOCK, impl="kernel",
        **kw))
    got = tops.flash_attention_bhsd(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # the (B, S, H, D) model-layout entry point reads the same numbers
    qs, ks, vs = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                  for x in (q, k, v))
    got_bshd = tops.flash_attention(_t(qs), _t(ks), _t(vs), **kw)
    np.testing.assert_allclose(got_bshd.numpy(), want.transpose(0, 2, 1, 3),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_matches_pallas(case):
    (q, k, v, lengths, q_lens), kw = _decode_inputs(case)
    want = np.asarray(jops.flash_decode(
        _j(q), _j(k), _j(v), _j(lengths), block_k=BLOCK, impl="kernel",
        q_lens=_j(q_lens), **kw))
    got = tops.flash_decode(_t(q), _t(k), _t(v), _t(lengths),
                            q_lens=_t(q_lens), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # empty slots and dead draft rows are exact zeros
    B, Sq = q.shape[:2]
    ql = q_lens if q_lens is not None else np.full(B, Sq)
    for b in range(B):
        for j in range(Sq):
            if j >= ql[b] or lengths[b] + j == 0:
                assert not got[b, j].any()
    # the layout-keyed entry point: flash (plain on CPU) == ref == dense
    cache = {"k": _t(k), "v": _t(v)}
    outs = [tops.decode_attention(
        _t(q), cache, _t(lengths), q_lens=_t(q_lens),
        layout=CacheLayout(impl=impl, **kw)) for impl in ("flash", "ref",
                                                          "dense")]
    torch.testing.assert_close(outs[0], got, atol=0, rtol=0)
    torch.testing.assert_close(outs[1], got, atol=0, rtol=0)
    np.testing.assert_allclose(outs[2].numpy(), want, atol=TOL, rtol=0)


def test_ref_impl_equals_default_on_cpu():
    (q, k, v), kw = _prefill_inputs(PREFILL_CASES[1], seed=3)
    a = tops.flash_attention_bhsd(_t(q), _t(k), _t(v), **kw)
    b = tops.flash_attention_bhsd(_t(q), _t(k), _t(v), impl="ref", **kw)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    (q, k, v, lengths, q_lens), kw = _decode_inputs(DECODE_CASES[5], seed=3)
    a = tops.flash_decode(_t(q), _t(k), _t(v), _t(lengths),
                          q_lens=_t(q_lens), **kw)
    b = tops.flash_decode(_t(q), _t(k), _t(v), _t(lengths),
                          q_lens=_t(q_lens), impl="ref", **kw)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_unported_layouts_raise():
    q = torch.zeros(1, 1, 2, D)
    cache = {"k": torch.zeros(1, 8, 2, D), "v": torch.zeros(1, 8, 2, D)}
    for layout in (CacheLayout(kind="paged"), CacheLayout(kv_bits=8)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tops.decode_attention(q, cache, torch.ones(1, dtype=torch.int32),
                                  layout=layout)
