"""The port's int8 KV cache against the JAX package's ``models/kvquant.py``.

The same numpy inputs go through both.  Quantization is compared exactly:
both round half to even and divide by the same f32 scale, and on these
inputs no int8 value differs (0 cases of +-1; the test would name them).
Attention and logits compare at 1e-5 / 1e-4 absolute in float32 (summation
order only); greedy tokens must be equal.  Reduced RecLLM-base, JAX params
converted into the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache_layout import CacheLayout as JLayout
from repro.config import get_arch as jget_arch
from repro.config import reduced as jreduced
from repro.models import kvquant as jkq
from repro.models import transformer as jtf
from repro.serving import engine as jeng
from repro_torch import convert
from repro_torch.cache_layout import CacheLayout
from repro_torch.config import get_arch, reduced
from repro_torch.models import kvquant as tkq
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as teng

torch.set_num_threads(2)

ARCH = "recllm-base"


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(jget_arch(ARCH)), dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch(ARCH)), dtype="float32")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return jcfg, jparams, tcfg, tparams


def _int8_mismatches(a, b):
    d = np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)
    return int((d != 0).sum()), int(np.abs(d).max(initial=0))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_kv_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 24, 3, 32))
         * rng.uniform(0.01, 10, (4, 24, 3, 1))).astype(np.float32)
    # a row with amax 127 (scale exactly 1) and values on .5 boundaries:
    # both sides round half to even
    x[0, 0, 0, :8] = [127.0, 2.5, 3.5, -0.5, -2.5, 0.5, 1.5, -1.5]
    jq, js = jkq.quantize_kv(jnp.asarray(x))
    tq, ts = tkq.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert _int8_mismatches(tq.numpy(), jq) == (0, 0)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, 0, :8].tolist() == [127, 2, 4, 0, -2, 0, 2, -2]
    deq = tkq.dequantize_kv(tq, ts, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jkq.dequantize_kv(jq, js, jnp.float32)))


# (B, Sq, H, Hk, S, lengths, q_lens); lengths past S are free serving slots
CASES = [
    (4, 1, 2, 2, 24, [0, 1, 24, 9], None),
    (4, 1, 4, 1, 24, [3, 30, 0, 17], None),
    (3, 3, 2, 2, 24, [0, 7, 21], [3, 2, 1]),
]


@pytest.mark.parametrize("case", CASES)
def test_decode_attention_quant_dense_matches_jax(case):
    B, Sq, H, Hk, S, lengths, q_lens = case
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, Sq, H, 16)).astype(np.float32)
    k_q, k_s = jkq.quantize_kv(jnp.asarray(
        rng.standard_normal((B, S, Hk, 16)).astype(np.float32)))
    v_q, v_s = jkq.quantize_kv(jnp.asarray(
        rng.standard_normal((B, S, Hk, 16)).astype(np.float32)))
    lens = np.asarray(lengths, np.int32)
    ql = None if q_lens is None else np.asarray(q_lens, np.int32)
    want = np.asarray(jkq.decode_attention_quant(
        jnp.asarray(q), k_q, k_s, v_q, v_s, jnp.asarray(lens),
        impl="dense", q_lens=None if ql is None else jnp.asarray(ql)))
    t = [torch.from_numpy(np.array(a)) for a in (q, k_q, k_s, v_q, v_s,
                                                 lens)]
    tql = None if ql is None else torch.from_numpy(ql)
    for impl in ("dense", "flash"):     # flash: the plain version on CPU
        got = tkq.decode_attention_quant(*t, impl=impl, q_lens=tql)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _tokens(rng, n, vocab):
    return rng.integers(3, vocab, (1, n)).astype(np.int32)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_int8_backends_match_jax(model, kind, impl):
    """Two prompts prefilled into the int8 cache, then four decode steps
    (one slot free, so its length runs past the cache): logits within 1e-4,
    equal greedy tokens, and the int8 caches equal value for value."""
    jcfg, jparams, tcfg, tparams = model
    n_slots, max_len, bs = 3, 16, 4
    lay = dict(kind=kind, kv_bits=8, impl=impl, block_size=bs)
    if kind == "paged":
        jb = jeng.PagedInt8Backend(jcfg, jparams, layout=JLayout(**lay))
        tb = teng.PagedInt8Backend(tcfg, tparams, layout=CacheLayout(**lay),
                                   device="cpu")
    else:
        jb = jeng.Int8KVBackend(jcfg, jparams, decode_impl=impl)
        tb = teng.Int8KVBackend(tcfg, tparams, decode_impl=impl,
                                device="cpu")
    jc, tc = jb.init_slots(n_slots, max_len), tb.init_slots(n_slots, max_len)
    # slots 0 and 2 map two private blocks each; slot 1 stays free (null)
    tables = np.array([[1, 2, 0, 0], [0, 0, 0, 0], [3, 4, 0, 0]], np.int32)
    if kind == "paged":
        jc = jb.set_tables(jc, tables, tables)
        tc = tb.set_tables(tc, tables, tables)
    rng = np.random.default_rng(5)
    for slot, n in ((0, 5), (2, 3)):
        toks = np.zeros((1, 8), np.int32)
        toks[:, :n] = _tokens(rng, n, jcfg.vocab_size)
        jrow, jc = jb.prefill(jc, toks, n, slot)
        trow, tc = tb.prefill(tc, toks, n, slot)
        np.testing.assert_allclose(trow.numpy(), np.asarray(jrow),
                                   atol=1e-4, rtol=0)
    tc["len"][1] = max_len - 1          # a free slot about to run past S
    jc["len"] = jc["len"].at[1].set(max_len - 1)
    nxt = np.full((n_slots, 1), 7, np.int32)
    for _ in range(4):
        jl, jc = jb.decode(jc, jnp.asarray(nxt))
        tl, tc = tb.decode(tc, torch.from_numpy(nxt.astype(np.int64)))
        live = [0, 2]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=1e-4, rtol=0)
        tn = tl[:, 0].argmax(-1).numpy()
        jn = np.asarray(jl[:, 0].argmax(-1))
        assert (tn[live] == jn[live]).all()
        nxt = jn[:, None].astype(np.int32)
    names = ("k_q", "v_q")
    if kind == "paged":                 # block 0 is the null sink: skip it
        for n in names:
            assert _int8_mismatches(tc[n][:, 1:].numpy(),
                                    np.asarray(jc[n])[:, 1:]) == (0, 0)
    else:
        for n in names:
            assert _int8_mismatches(tc[n][:, [0, 2]].numpy(),
                                    np.asarray(jc[n])[:, [0, 2]]) == (0, 0)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()


def test_quant_prefill_kv_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    toks = _tokens(np.random.default_rng(9), 12, jcfg.vocab_size)
    jl, jquant = jkq.quant_prefill_kv(jcfg, jparams,
                                      {"tokens": jnp.asarray(toks)})
    tl, tquant = tkq.quant_prefill_kv(
        tcfg, tparams, {"tokens": torch.from_numpy(toks.astype(np.int64))},
        ttf.ModelCtx(attn_chunk=8))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for i in (0, 2):                    # int8 values: exact
        assert _int8_mismatches(tquant[i].numpy(), jquant[i]) == (0, 0)
    for i in (1, 3):                    # scales: f32 amax of equal K/V
        np.testing.assert_allclose(tquant[i].numpy(), np.asarray(jquant[i]),
                                   rtol=1e-5, atol=0)
