"""The port's gradient-compression kernels against the JAX Pallas kernels
(interpret mode on the CPU) and the JAX package's plain versions.

The same numpy inputs go through ``repro.kernels.ops`` and
``repro_torch.kernels.ops``; on CPU tensors each port wrapper runs the
plain version of its CUDA kernel (``chip_smoke.py`` holds the kernels
against those plain versions on the GPU).  Tolerances: packed bytes and
top-k kept/residual, the top-k sync's selection and its residual exactly
(sign tests, max/compare and copies only); 1-bit scales 1e-6 relative (a
mean of 8 * block magnitudes, summed in another order); dequantized
values 1e-6.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import compression
from repro_torch.kernels import grad_compress, ops as tops, ref as tref
from repro_torch.kernels import topk_sparsify as tk

torch.set_num_threads(2)

ONEBIT_GRID = [(8 * 512, 512), (8 * 2048, 512), (8 * 1024, 1024)]
TOPK_GRID = [(4096, 512, 8), (8192, 2048, 32), (2048, 256, 1)]
# Motivation's tie case: |5| twice, then 3: the kernel's threshold is the
# 2nd largest distinct magnitude (3), the sort's the 2nd largest (5)
TIE_ROW = [5.0, -5.0, 3.0, 1.0, 0.5, -0.25, 0.125, 0.0]
# the top-k sync's selection: (nb, block, k) of the flat sync (block 2048,
# k 32), the cf_user row compressor (D = 64, k 8) and k = 1
SELECT_GRID = [(4, 2048, 32), (3, 64, 8), (2, 256, 1)]
TIED = (0.0, 0.5, -0.5, 1.0, -1.0, 2.0)   # magnitudes that tie within a row
# one row of 4 distinct magnitudes with k = 6: the sparsifier keeps it all
FEW_DISTINCT_ROW = [2.0, -2.0, 1.0, 0.0, 0.5, -1.0, 2.0, -0.0]


def _normal(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("N,block", ONEBIT_GRID)
def test_onebit_matches_pallas(N, block):
    g = _normal(N)
    jp, js = jops.onebit_quantize(jnp.asarray(g), block)
    for impl in ("kernel", "ref"):
        tp, ts = tops.onebit_quantize(torch.from_numpy(g), block, impl=impl)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        jd = jops.onebit_dequantize(jp, js, block)
        td = tops.onebit_dequantize(tp, ts, block, impl=impl)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6,
                                   rtol=1e-6)


def test_onebit_strided_layout_and_zero_is_positive():
    """Bit j of packed[c] is the sign of flat[j * M + c]; an exact zero
    packs 1 and comes back as +scale (residual -scale), as in JAX."""
    N, block = 8 * 512, 512
    g = _normal(N, 1)
    g[::7] = 0.0
    tp, ts = tops.onebit_quantize(torch.from_numpy(g), block)
    M = N // 8
    bits = (tp.numpy()[None, :] >> np.arange(8)[:, None]) & 1
    np.testing.assert_array_equal(bits.reshape(-1), (g >= 0).astype(int))
    d = tops.onebit_dequantize(tp, ts, block).numpy()
    scale_of = ts.numpy()[np.arange(N) % M // block]
    np.testing.assert_array_equal(d[g == 0], scale_of[g == 0])
    jd = jops.onebit_dequantize(*jops.onebit_quantize(jnp.asarray(g),
                                                      block), block)
    np.testing.assert_array_equal(np.sign(d), np.sign(np.asarray(jd)))


def test_onebit_dequantize_takes_a_batch_of_payloads():
    block, R = 512, 3
    packed, scales = zip(*(tops.onebit_quantize(
        torch.from_numpy(_normal(8 * 1024, s)), block) for s in range(R)))
    batch = tops.onebit_dequantize(torch.stack(packed), torch.stack(scales),
                                   block)
    assert batch.shape == (R, 8 * 1024)
    for r in range(R):
        torch.testing.assert_close(
            batch[r], tops.onebit_dequantize(packed[r], scales[r], block),
            rtol=0, atol=0)


@pytest.mark.parametrize("N,block,k", TOPK_GRID)
def test_topk_matches_pallas_on_tie_free_data(N, block, k):
    g = _normal(N)
    jk, jr = jops.topk_sparsify(jnp.asarray(g), k, block)
    for impl in ("kernel", "ref"):
        tk_, tr = tops.topk_sparsify(torch.from_numpy(g), k, block,
                                     impl=impl)
        np.testing.assert_array_equal(tk_.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("k", [1, 2, 3, 7, 8])
def test_topk_tie_semantics_follow_each_reference(k):
    """impl="kernel" has the Pallas kernel's distinct-magnitude threshold
    (checked against interpret mode), impl="ref" the sort of JAX's ref."""
    g = np.array(TIE_ROW * 2, np.float32)
    g[8:] = 0.0                          # a block of one distinct magnitude
    jk, jr = jops.topk_sparsify(jnp.asarray(g), k, 8)
    tk_, tr = tops.topk_sparsify(torch.from_numpy(g), k, 8)
    np.testing.assert_array_equal(tk_.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    jk2, jr2 = jref.topk_sparsify(jnp.asarray(g.reshape(2, 8)), k)
    tk2, tr2 = tops.topk_sparsify(torch.from_numpy(g), k, 8, impl="ref")
    np.testing.assert_array_equal(tk2.numpy(), np.asarray(jk2).reshape(-1))
    np.testing.assert_array_equal(tr2.numpy(), np.asarray(jr2).reshape(-1))
    if k == 2:
        np.testing.assert_array_equal(tk_.numpy()[:3], [5.0, -5.0, 3.0])
        np.testing.assert_array_equal(tk2.numpy()[:3], [5.0, -5.0, 0.0])


def test_topk_indices_follow_lax_top_k_ties():
    """The wire payload's indices: largest magnitude first, ties to the
    lowest index, exactly as ``lax.top_k``."""
    rng = np.random.default_rng(3)
    x = rng.choice([0.0, 0.5, -0.5, 1.0, -2.0, 2.0], size=(16, 64))
    x = x.astype(np.float32)
    _, jidx = lax.top_k(jnp.abs(jnp.asarray(x)), 9)
    tidx, _, _ = tref.topk_select(torch.from_numpy(x), 9)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def _select_input(nb, block, kind, seed=0):
    if kind == "normal":
        return _normal(nb * block, seed).reshape(nb, block)
    rng = np.random.default_rng(seed)
    return np.asarray(TIED, np.float32)[rng.integers(0, len(TIED),
                                                     (nb, block))]


def _jax_select(x2d, k, impl):
    """The JAX sync's payload (``repro/core/compression.py:topk_sync``):
    ``lax.top_k`` over |kept| of the sparsifier ``impl``, the signed kept
    values there, and x minus them scattered back."""
    nb, block = x2d.shape
    x = jnp.asarray(x2d)
    kept, _ = jops.topk_sparsify(x.reshape(-1), k, block, impl=impl)
    kept2d = kept.reshape(nb, block)
    _, idx = lax.top_k(jnp.abs(kept2d), k)
    vals = jnp.take_along_axis(kept2d, idx, axis=-1)
    sent = jnp.zeros((nb, block), jnp.float32) \
        .at[jnp.arange(nb)[:, None], idx].add(vals)
    return np.asarray(idx), np.asarray(vals), np.asarray(x - sent)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("nb,block,k,kind", [
    *[(nb, block, k, kind) for nb, block, k in SELECT_GRID
      for kind in ("normal", "tied")],
    (1, 8, 6, "few_distinct")])
def test_topk_select_matches_jax_sync_payload(nb, block, k, kind, impl):
    """The plain selection (what the wrapper runs on CPU tensors, and what
    the kernel is held to on the card) against JAX's, after either JAX
    sparsifier: the Pallas kernel in interpret mode or the sort."""
    x = (np.asarray([FEW_DISTINCT_ROW], np.float32) if kind == "few_distinct"
         else _select_input(nb, block, kind))
    jidx, jvals, jres = _jax_select(x, k, impl)
    for got in (tref.topk_select(torch.from_numpy(x), k),
                tk.topk_select(torch.from_numpy(x), k)):
        idx, vals, res = got
        assert idx.shape == vals.shape == (nb, k) and idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), jidx)
        np.testing.assert_array_equal(vals.numpy(), jvals)
        np.testing.assert_array_equal(res.numpy(), jres)
    if kind == "few_distinct":
        np.testing.assert_array_equal(jidx[0], [0, 1, 6, 2, 5, 4])


def _sync_before_select(grads, residual, block, k, use_kernel):
    """``topk_sync`` as it was before the selection moved into the kernel,
    on a world of one: sparsify, pick k from |kept|, gather, scatter,
    subtract."""
    flat, meta, npad = compression._padded(grads, residual)
    kept, _ = tops.topk_sparsify(flat, k, block,
                                 impl="kernel" if use_kernel else "ref")
    kept2d = kept.reshape(-1, block)
    bits = torch.abs(kept2d).view(torch.int32).to(torch.int64)
    rev = block - 1 - torch.arange(block)
    idx = torch.topk((bits << 32) | rev, k, dim=-1).indices
    vals = torch.gather(kept2d, -1, idx)
    sent = torch.zeros_like(kept2d).scatter_(-1, idx, vals)
    acc = torch.zeros_like(kept2d).scatter_add_(-1, idx, vals)
    n = flat.shape[0] - npad
    return (compression._unflatten(acc.reshape(-1)[:n], meta),
            flat - sent.reshape(-1))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kind", ["normal", "tied"])
def test_topk_sync_takes_the_plain_select_on_cpu(kind, use_kernel,
                                                 monkeypatch):
    """On CPU tensors ``topk_sync`` goes through the plain selection (no
    launch) and gives what it gave before the selection moved into the
    kernel, on a world of one."""
    block, k = 256, 8
    flat = _select_input(1, 3 * 700 + 50, kind, seed=4).reshape(-1)
    grads = {"w": torch.from_numpy(flat[:2100].reshape(3, 700)),
             "b": torch.from_numpy(flat[2100:])}
    residual = torch.from_numpy(_normal(9 * block, 5) * 1e-2)
    mesh = SimpleNamespace(shape={"data": 1})
    monkeypatch.setattr(compression, "all_gather",
                        lambda x, mesh, axis: x[None])
    calls = []
    plain = tref.topk_select
    monkeypatch.setattr(tref, "topk_select",
                        lambda x2d, kk: calls.append(kk) or plain(x2d, kk))
    launches = tk.topk_select.launches
    got, new_res = compression.topk_sync(grads, residual, mesh=mesh,
                                         block=block, k=k,
                                         use_kernel=use_kernel)
    want, want_res = _sync_before_select(grads, residual, block, k,
                                         use_kernel)
    assert calls == [k] and tk.topk_select.launches == launches
    for name in ("w", "b"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    torch.testing.assert_close(new_res, want_res, rtol=0, atol=0)


@pytest.mark.parametrize("call", [
    lambda x: grad_compress.onebit_quantize(x.reshape(8, -1), 512),
    lambda x: tk.topk_sparsify(x.reshape(-1, 512), 4),
    lambda x: tk.topk_select(x.reshape(-1, 512), 4),
    lambda x: grad_compress.onebit_dequantize(
        torch.zeros(512, dtype=torch.uint8), x[:1]),
], ids=["onebit_quantize", "topk_sparsify", "topk_select",
        "onebit_dequantize"])
def test_compression_wrappers_refuse_autograd(call):
    x = torch.from_numpy(_normal(8 * 512)).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        call(x)
    with torch.no_grad():
        call(x)


def test_wrappers_count_kernel_launches_only():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    before = (grad_compress.onebit_quantize.launches,
              grad_compress.onebit_dequantize.launches,
              tk.topk_sparsify.launches, tk.topk_select.launches)
    g = torch.from_numpy(_normal(8 * 512))
    tops.onebit_dequantize(*tops.onebit_quantize(g, 512), 512)
    tops.topk_sparsify(g, 4, 512)
    tops.topk_select(g, 4, 512)
    assert (grad_compress.onebit_quantize.launches,
            grad_compress.onebit_dequantize.launches,
            tk.topk_sparsify.launches, tk.topk_select.launches) == before
