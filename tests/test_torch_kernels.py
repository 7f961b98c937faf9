"""Port kernels against the JAX Pallas kernels (interpret mode on the CPU).

The same numpy inputs go through ``repro.kernels.ops`` (the Pallas kernel,
interpreted) and ``repro_torch.kernels.ops`` (on CPU tensors: the plain
version each CUDA wrapper runs there).  Tolerance 1e-5 absolute in float32:
both sides compute in float32 and differ only in summation order.  The
cases use head_dim 32, a width the CUDA kernels take: ``chip_smoke.py``
runs every one of them through the kernels on the GPU.

The CUDA decode kernels split each slot's KV range into spans and merge
the spans' partials; ``ref.decode_attention_splits`` does that step for
step, and is held to the four plain decode versions here (1e-6 in float32
of the largest plain |value|, floored at 1: the int8 cases' outputs reach
~6, where 1e-6 is two float32 ulps; exact zeros where they give zeros) on
these cases and on cases across the kernel's 64-key spans, at spans of 1,
8, 64 and more than S.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdk
from repro.kernels import ops as jops
from repro_torch.cache_layout import CacheLayout
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

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

# int8 caches: (B, Sq, H, Hk, S, lengths, q_lens); lengths past S are the
# free serving slots, which keep counting (S a multiple of BLOCK there: the
# Pallas kernel pads S up to its block and would attend the pad rows)
QUANT_CASES = [
    (4, 1, 2, 2, 40, [0, 1, 40, 17], None),
    (4, 1, 8, 2, 48, [0, 49, 53, 7], None),                 # GQA, len > S
    (4, 3, 2, 2, 40, [0, 5, 20, 38], [3, 1, 2, 3]),         # k rows
]

# paged caches: (B, Sq, H, Hk, nb, bs, lengths, q_lens, window, ring);
# virtual space nb * bs, shuffled physical blocks, dead entries null
PAGED_CASES = [
    (4, 1, 2, 2, 5, 8, [0, 1, 40, 17], None, 0, False),     # len 0 / 1 / S
    (4, 1, 8, 2, 5, 8, [0, 0, 0, 0], None, 0, False),       # all empty, GQA
    (4, 1, 2, 2, 5, 8, [0, 1, 5, 40], None, 16, False),     # window > len
    (4, 1, 2, 2, 2, 8, [0, 3, 16, 29], None, 12, True),     # ring wraps
    (4, 3, 2, 2, 5, 8, [0, 5, 20, 38], [3, 1, 2, 3], 0, False),  # k rows
    (4, 2, 8, 2, 4, 4, [1, 7, 16, 25], [2, 1, 2, 2], 12, True),  # k, ring
    (3, 3, 2, 2, 5, 8, [2, 30, 38], [3, 2, 1], 6, False),   # k, window
]

# across the CUDA decode kernel's 64-key spans (the cases chip_smoke.py adds
# on the card), each with its head dim: ((B, Sq, H, Hk, S, lengths, q_lens,
# window, ring), D)
DECODE_SPLIT_CASES = [
    ((4, 1, 2, 2, 192, [64, 65, 0, 192], None, 0, False), 32),  # on a span
    #                         border, one key past it, len 0 beside full
    ((3, 1, 4, 2, 192, [100, 150, 191], None, 40, False), 64),  # window band
    #                         starting inside a later span
    ((3, 1, 2, 2, 160, [170, 230, 100], None, 70, True), 32),   # ring wraps
    #                         across span borders
    ((4, 3, 16, 2, 200, [63, 64, 0, 130], [3, 2, 3, 1], 0, False), 64),
    #                         Sq = 3 draft rows, G = 8
    ((2, 1, 8, 2, 256, [129, 256], None, 0, False), 128),       # D = 128
    ((2, 2, 8, 1, 130, [64, 127], [2, 2], 30, True), 128),      # G 8, ring
    ((2, 1, 4, 2, 1100, [1030, 1100], None, 0, False), 64),     # 18 spans
]
QUANT_SPLIT_CASES = [  # ((B, Sq, H, Hk, S, lengths, q_lens), D)
    ((4, 1, 2, 2, 192, [64, 65, 0, 192], None), 32),
    ((4, 3, 16, 2, 200, [63, 64, 0, 130], [3, 2, 3, 1]), 64),
    ((2, 1, 8, 2, 256, [129, 300], None), 128),                 # len > S
]
# ((B, Sq, H, Hk, nb, bs, lengths, q_lens, window, ring), D)
PAGED_SPLIT_CASES = [
    ((4, 1, 2, 2, 48, 4, [64, 65, 0, 192], None, 0, False), 32),   # bs 4
    ((4, 1, 2, 2, 12, 16, [64, 65, 0, 192], None, 0, False), 32),  # bs 16
    ((3, 1, 4, 2, 12, 16, [100, 150, 191], None, 40, False), 64),
    ((3, 1, 2, 2, 40, 4, [170, 230, 100], None, 70, True), 32),
    ((4, 3, 16, 2, 13, 16, [63, 64, 0, 130], [3, 2, 3, 1], 0, False), 64),
    ((2, 1, 8, 2, 16, 16, [129, 256], None, 0, False), 128),
    ((2, 1, 4, 2, 69, 16, [1030, 1100], None, 0, False), 64),   # 18 spans
]
# The 18-span cases run in 16-bit only: over 1,100 int8 keys (values to
# ~6) the plain float32 version is itself ~4e-6 from a float64 sum, above
# SPLIT_TOL; chip_smoke.py holds the int8 kernels there at 1e-4.
LONG = 1000
SPANS = (1, 8, 64, 1000)          # 1000: one span longer than any S here
SPLIT_TOL = 1e-6

D = 32
BLOCK = 16


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _prefill_inputs(case, seed=0):
    B, H, Hk, S, causal, window = case
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, H, S, D), _rand(rng, B, Hk, S, D),
            _rand(rng, B, Hk, S, D)), dict(causal=causal, window=window)


def _decode_inputs(case, seed=0, d=D):
    B, Sq, H, Hk, S, lengths, q_lens, window, ring = case
    rng = np.random.default_rng(seed)
    arrs = (_rand(rng, B, Sq, H, d), _rand(rng, B, S, Hk, d),
            _rand(rng, B, S, Hk, d), np.asarray(lengths, np.int32),
            None if q_lens is None else np.asarray(q_lens, np.int32))
    return arrs, dict(window=window, ring=ring)


def _quant_inputs(case, seed=0, d=D):
    B, Sq, H, Hk, S, lengths, q_lens = case
    rng = np.random.default_rng(seed)

    def vals():
        return rng.integers(-127, 128, (B, S, Hk, d)).astype(np.int8)

    def scales():
        return rng.uniform(0.005, 0.05, (B, S, Hk)).astype(np.float32)

    return (_rand(rng, B, Sq, H, d), vals(), scales(), vals(), scales(),
            np.asarray(lengths, np.int32),
            None if q_lens is None else np.asarray(q_lens, np.int32))


def paged_tables(lengths, q_lens, nb, bs, ring, seed=0):
    """(B, nb) tables over a shuffled pool: each slot's live blocks get
    distinct physical ids from a permutation of 1..N-1; dead entries (past
    the last live position) point at the null block 0.  Returns (tables,
    N) with N = B * nb + 4 (spare blocks and block 0 hold garbage)."""
    B = len(lengths)
    N = B * nb + 4
    perm = np.random.default_rng(seed).permutation(np.arange(1, N))
    tables = np.zeros((B, nb), np.int32)
    for b, n in enumerate(lengths):
        last = n + (1 if q_lens is None else q_lens[b]) - 1
        live = min(-(-min(last, nb * bs) // bs), nb)
        tables[b, :live] = perm[b * nb:b * nb + live]
    return tables, N


def _paged_inputs(case, seed=0, quant=False, d=D):
    B, Sq, H, Hk, nb, bs, lengths, q_lens, window, ring = case
    rng = np.random.default_rng(seed)
    tables, N = paged_tables(lengths, q_lens, nb, bs, ring, seed)
    q = _rand(rng, B, Sq, H, d)
    if quant:
        pools = (rng.integers(-127, 128, (N, bs, Hk, d)).astype(np.int8),
                 rng.uniform(0.005, 0.05, (N, bs, Hk)).astype(np.float32),
                 rng.integers(-127, 128, (N, bs, Hk, d)).astype(np.int8),
                 rng.uniform(0.005, 0.05, (N, bs, Hk)).astype(np.float32))
    else:
        # blocks no table maps (block 0 and the spares) hold large garbage
        unused = ~np.isin(np.arange(N), tables[tables > 0])
        pools = tuple(_rand(rng, N, bs, Hk, d) * np.where(unused, 10.0, 1.0)[
            :, None, None, None].astype(np.float32) for _ in range(2))
    return (q, pools, tables, np.asarray(lengths, np.int32),
            None if q_lens is None else np.asarray(q_lens, np.int32))


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


@pytest.mark.parametrize("case", QUANT_CASES)
def test_flash_decode_quant_matches_pallas(case):
    q, k_q, k_s, v_q, v_s, lengths, q_lens = _quant_inputs(case)
    want = np.asarray(jdk.flash_decode_attention_quant(
        *(_j(x) for x in (q, k_q, k_s, v_q, v_s, lengths)), block_k=BLOCK,
        interpret=True, q_lens=_j(q_lens)))
    args = [_t(x) for x in (q, k_q, k_s, v_q, v_s, lengths)]
    got = tops.flash_decode_quant(*args, q_lens=_t(q_lens))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # the layout-keyed entry point: flash (plain on CPU) == ref == dense
    cache = dict(zip(("k_q", "k_s", "v_q", "v_s"), args[1:5]))
    for impl in ("flash", "ref", "dense"):
        out = tops.decode_attention(args[0], cache, args[5],
                                    q_lens=_t(q_lens),
                                    layout=CacheLayout(kv_bits=8, impl=impl))
        np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_flash_decode_paged_matches_pallas(case):
    window, ring = case[-2:]
    q, (kp, vp), tables, lengths, q_lens = _paged_inputs(case)
    want = np.asarray(jdk.flash_decode_attention_paged(
        *(_j(x) for x in (q, kp, vp, tables, lengths)), window=window,
        ring=ring, interpret=True, q_lens=_j(q_lens)))
    got = tops.decode_attention(
        _t(q), {"k": _t(kp), "v": _t(vp), "block_table": _t(tables)},
        _t(lengths), q_lens=_t(q_lens),
        layout=CacheLayout(kind="paged", impl="flash", block_size=case[5],
                           window=window, ring=ring))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    for impl in ("ref", "dense"):
        out = tops.decode_attention(
            _t(q), {"k": _t(kp), "v": _t(vp), "block_table": _t(tables)},
            _t(lengths), q_lens=_t(q_lens),
            layout=CacheLayout(kind="paged", impl=impl, window=window,
                               ring=ring))
        np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", [c for c in PAGED_CASES if not c[-2]])
def test_flash_decode_paged_quant_matches_pallas(case):
    q, pools, tables, lengths, q_lens = _paged_inputs(case, quant=True)
    want = np.asarray(jdk.flash_decode_attention_paged_quant(
        _j(q), *(_j(x) for x in pools), _j(tables), _j(lengths),
        interpret=True, q_lens=_j(q_lens)))
    cache = dict(zip(("k_q", "k_s", "v_q", "v_s"), map(_t, pools)),
                 block_table=_t(tables))
    for impl in ("flash", "ref", "dense"):
        out = tops.decode_attention(
            _t(q), cache, _t(lengths), q_lens=_t(q_lens),
            layout=CacheLayout(kind="paged", kv_bits=8, impl=impl,
                               block_size=case[5]))
        np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=0)


def test_unported_layouts_raise():
    """Every (kind, kv_bits, impl) cell of the layout matrix is served now;
    what the int8 kernels do not take still raises, as in the JAX package:
    an int8 layout with a window or ring mask."""
    q = torch.zeros(1, 1, 2, D)
    cache = {"k_q": torch.zeros(1, 8, 2, D, dtype=torch.int8),
             "k_s": torch.ones(1, 8, 2), "v_q": torch.zeros(
                 1, 8, 2, D, dtype=torch.int8), "v_s": torch.ones(1, 8, 2),
             "block_table": torch.zeros(1, 1, dtype=torch.int32)}
    for layout in (CacheLayout(kv_bits=8, window=4),
                   CacheLayout(kind="paged", kv_bits=8, window=4, ring=True,
                               block_size=8)):
        with pytest.raises(ValueError, match="full-cache masking"):
            tops.decode_attention(q, cache, torch.ones(1, dtype=torch.int32),
                                  layout=layout)


def _hold_split(got, want):
    """got within SPLIT_TOL of want's largest magnitude (at least 1), and
    exactly 0 on every row want zeroes (empty slots, dead draft rows)."""
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=SPLIT_TOL * scale, rtol=0)
    dead = ~want.reshape(-1, want.shape[-1]).any(-1)
    assert not got.reshape(-1, got.shape[-1])[dead].any()


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("case,d", [(c, D) for c in DECODE_CASES]
                         + DECODE_SPLIT_CASES)
def test_split_merge_matches_plain_decode(case, d, span):
    (q, k, v, lengths, q_lens), kw = _decode_inputs(case, d=d)
    args = (_t(q), _t(k), _t(v), _t(lengths))
    want = ref.decode_attention(*args, q_lens=_t(q_lens), **kw)
    _hold_split(ref.decode_attention_splits(*args, span=span,
                                            q_lens=_t(q_lens), **kw), want)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("case,d", [(c, D) for c in QUANT_CASES]
                         + QUANT_SPLIT_CASES)
def test_split_merge_matches_plain_decode_quant(case, d, span):
    q, k_q, k_s, v_q, v_s, lengths, q_lens = map(_t, _quant_inputs(case,
                                                                  d=d))
    want = ref.decode_attention_quant(q, k_q, k_s, v_q, v_s, lengths,
                                      q_lens=q_lens)
    _hold_split(ref.decode_attention_splits(
        q, k_q, v_q, lengths, span=span, q_lens=q_lens, k_s=k_s, v_s=v_s),
        want)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("case,d", [(c, D) for c in PAGED_CASES]
                         + PAGED_SPLIT_CASES)
def test_split_merge_matches_plain_decode_paged(case, d, span):
    window, ring = case[-2:]
    q, pools, tables, lengths, q_lens = _paged_inputs(case, d=d)
    q, kp, vp, tables, lengths, q_lens = map(
        _t, (q, *pools, tables, lengths, q_lens))
    want = ref.decode_attention_paged(q, kp, vp, tables, lengths,
                                      window=window, ring=ring, q_lens=q_lens)
    _hold_split(ref.decode_attention_splits(
        q, ref.paged_gather(kp, tables), ref.paged_gather(vp, tables),
        lengths, span=span, window=window, ring=ring, q_lens=q_lens), want)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("case,d", [(c, D) for c in PAGED_CASES if not c[-2]]
                         + [c for c in PAGED_SPLIT_CASES
                            if not c[0][-2] and max(c[0][6]) < LONG])
def test_split_merge_matches_plain_decode_paged_quant(case, d, span):
    q, pools, tables, lengths, q_lens = _paged_inputs(case, quant=True, d=d)
    q, tables, lengths, q_lens = map(_t, (q, tables, lengths, q_lens))
    k_q, k_s, v_q, v_s = (ref.paged_gather(_t(x), tables) for x in pools)
    want = ref.decode_attention_paged_quant(q, *map(_t, pools), tables,
                                            lengths, q_lens=q_lens)
    _hold_split(ref.decode_attention_splits(
        q, k_q, v_q, lengths, span=span, q_lens=q_lens, k_s=k_s, v_s=v_s),
        want)
