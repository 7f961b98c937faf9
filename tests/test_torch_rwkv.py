"""The port's rwkv6 slice against the JAX package: the WKV plain versions
against the Pallas kernel (interpret mode) and the model's chunked scan,
the time-mix and channel-mix layers, the whole forward of reduced rwkv6
(2 layers, d_model 64, head size 16), the slot prefill and decode step,
and the serving engine under the dense and paged layouts.

The same numpy inputs go through both packages; params are the JAX init
converted into the port.  Everything runs at float32 on the CPU, where the
WKV kernel wrapper runs its plain version (the chunked recurrence).
Tolerances: WKV outputs atol 5e-4 + rtol 5e-4 against the Pallas kernel,
as ``tests/test_kernels.py`` holds it to its oracle; final states and layer
outputs 1e-5 absolute + 1e-5 relative (float32 sums taken in another
order); logits 1e-4 (summation order over the stack); greedy streams,
scheduler records and summaries equal.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache_layout import CacheLayout as JLayout
from repro.config import get_arch as jget_arch
from repro.config import reduced as jreduced
from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serving import engine as jeng
from repro.serving import roofline as jroofline
from repro.serving import traffic as jtraffic
from repro_torch import convert
from repro_torch.cache_layout import CacheLayout
from repro_torch.config import get_arch, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as wkv6_kernel
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as teng
from repro_torch.serving import roofline as troofline
from repro_torch.serving import traffic as ttraffic

torch.set_num_threads(2)

ARCH = "rwkv6-1.6b"
KERNEL_TOL = dict(atol=5e-4, rtol=5e-4)
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = 1e-4
TRAFFIC = dict(n_requests=6, rate=80.0, prompt_max=14, new_tokens_max=5,
               vocab_size=256, seed=3)
LAYOUTS = {"dense": dict(), "paged": dict(kind="paged", block_size=8)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(jget_arch(ARCH)), dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch(ARCH)), dtype="float32")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return jcfg, jparams, tcfg, tparams


def _streams(B, H, T, hs, seed=0):
    """r, k, v, w (B, H, T, hs) f32 and u (H, hs), as the JAX kernel test
    draws them: w = exp(-exp(2 n - 2)) spans fast to slow decay."""
    rng = np.random.default_rng(seed)
    r, k, v, n = (rng.standard_normal((B, H, T, hs)).astype(np.float32)
                  for _ in range(4))
    w = np.exp(-np.exp(n * 2 - 2)).astype(np.float32)
    u = (rng.standard_normal((H, hs)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


# -- the WKV kernel's plain versions ------------------------------------------

@pytest.mark.parametrize("B,H,T,hs,chunk,decay", [
    (2, 2, 64, 16, 16, None), (1, 4, 32, 8, 8, None),
    (2, 1, 96, 32, 32, None), (1, 2, 32, 8, 8, 1e-6),
    (1, 4, 48, 64, 16, None), (1, 4, 48, 64, 16, 1e-6),
    (2, 3, 80, 64, 16, None),
])
def test_plain_wkv6_matches_pallas(B, H, T, hs, chunk, decay):
    """The sequential scan, the chunked recurrence, ``ops.wkv6_chunked``
    (both impls) and the kernel wrapper on CPU tensors against the Pallas
    kernel in interpret mode: the JAX test cases and its near-total decay
    (w = 1e-6), rwkv6-1.6b's head width at its 48-token serve prefill, and
    a length the CUDA kernel cuts into 32-token tiles with a ragged last
    one.  The wrapper also takes r, k, v, w as transposed (B, T, H, hs)
    views, as the model passes them, and gives the contiguous result."""
    r, k, v, w, u = _streams(B, H, T, hs)
    if decay is not None:
        w = np.full_like(w, decay)
    want = np.asarray(jops.wkv6_chunked(*map(jnp.asarray, (r, k, v, w, u)),
                                        chunk=chunk))
    tr, tk, tv, tw, tu = _t(r, k, v, w, u)
    views = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
             .transpose(1, 2) for x in (r, k, v, w)]
    got = {"scan": ref.wkv6_chunked(tr, tk, tv, tw, tu),
           "chunked": ref.wkv6_chunked_state(tr, tk, tv, tw, tu, chunk)[0],
           "ops_ref": ops.wkv6_chunked(tr, tk, tv, tw, tu, chunk=chunk,
                                       impl="ref"),
           "ops_kernel": ops.wkv6_chunked(tr, tk, tv, tw, tu, chunk=chunk),
           "wrapper": wkv6_kernel.wkv6_chunked(tr, tk, tv, tw, tu,
                                               chunk=chunk)[0]}
    o_views, S_views = wkv6_kernel.wkv6_chunked(*views, tu, chunk=chunk)
    o_dense, S_dense = wkv6_kernel.wkv6_chunked(tr, tk, tv, tw, tu,
                                                chunk=chunk)
    np.testing.assert_allclose(o_views.numpy(), o_dense.numpy(),
                               **STATE_TOL)
    np.testing.assert_allclose(S_views.numpy(), S_dense.numpy(),
                               **STATE_TOL)
    for name, o in got.items():
        assert np.isfinite(o.numpy()).all(), name
        np.testing.assert_allclose(o.numpy(), want, **KERNEL_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("true_len", [None, 21])
def test_final_state_matches_jax_chunked(chunk, true_len):
    """The final state of the wrapper, the chunked recurrence and the scan
    against JAX ``ssm._wkv6_chunked``'s ``S_f``; with ``true_len`` the pads
    are frozen (w = 1, k = 0) and the state equals the unpadded prompt's."""
    B, H, T, hs = 2, 3, 32, 16
    r, k, v, w, u = _streams(B, H, T, hs, seed=1)
    if true_len is not None:
        w[:, :, true_len:] = 1.0
        k[:, :, true_len:] = 0.0
    _, jS = jssm._wkv6_chunked(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (r, k, v, w)),
        jnp.asarray(u), chunk=chunk)
    jS = np.asarray(jS)
    tr, tk, tv, tw, tu = _t(r, k, v, w, u)
    for name, S in (
            ("wrapper", wkv6_kernel.wkv6_chunked(tr, tk, tv, tw, tu,
                                                 chunk=chunk)[1]),
            ("chunked", ref.wkv6_chunked_state(tr, tk, tv, tw, tu,
                                               chunk)[1]),
            ("scan", ref.wkv6_scan(tr, tk, tv, tw, tu)[1])):
        assert S.shape == (B, H, hs, hs) and S.dtype == torch.float32
        np.testing.assert_allclose(S.numpy(), jS, **STATE_TOL, err_msg=name)
    if true_len is not None:
        cut = _t(*(x[:, :, :true_len] for x in (r, k, v, w)))
        _, S_cut = ref.wkv6_scan(*cut, tu)
        np.testing.assert_allclose(
            wkv6_kernel.wkv6_chunked(tr, tk, tv, tw, tu, chunk=chunk)[1]
            .numpy(), S_cut.numpy(), **STATE_TOL)


def test_model_scan_and_chunked_match_jax():
    """``ssm._wkv6_scan`` and ``ssm._wkv6_chunked`` (model layout, from an
    incoming state, a chunk that does not divide T) against JAX's."""
    B, T, H, hs = 2, 24, 2, 8
    rng = np.random.default_rng(2)
    r, k, v, n = (rng.standard_normal((B, T, H, hs)).astype(np.float32)
                  for _ in range(4))
    w = np.exp(-np.exp(n - 1)).astype(np.float32)
    u = (rng.standard_normal((H, hs)) * 0.1).astype(np.float32)
    S0 = rng.standard_normal((B, H, hs, hs)).astype(np.float32)
    j = [jnp.asarray(x) for x in (r, k, v, w, u)]
    t = _t(r, k, v, w, u)
    for jout, tout in ((jssm._wkv6_scan(*j), tssm._wkv6_scan(*t)),
                       (jssm._wkv6_chunked(*j, jnp.asarray(S0), chunk=16),
                        tssm._wkv6_chunked(*t, torch.from_numpy(S0),
                                           chunk=16))):
        for a, b in zip(tout, jout):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **STATE_TOL)


# -- the layers --------------------------------------------------------------

def _layer_params(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("true_len", [None, 13])
def test_rwkv6_forward_matches_jax(model, true_len, use_kernel):
    """Time-mix from a zero state (the kernel's path when ``use_kernel``),
    then one decode step from the returned state."""
    jcfg, jparams, tcfg, tparams = model
    jp = _layer_params(jparams["blocks"]["tmix"])
    tp = ttf._layer(tparams["blocks"], 0)["tmix"]
    x = np.random.default_rng(3).standard_normal((2, 16, 64)).astype(
        np.float32)
    jout, jst = jssm.rwkv6_forward(jcfg, jp, jnp.asarray(x),
                                   true_len=true_len)
    tout, tst = tssm.rwkv6_forward(tcfg, tp, torch.from_numpy(x),
                                   true_len=true_len, use_kernel=use_kernel)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **STATE_TOL)
    for key in ("last", "wkv"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   **STATE_TOL, err_msg=key)
    x1 = np.random.default_rng(4).standard_normal((2, 1, 64)).astype(
        np.float32)
    jout, jst = jssm.rwkv6_forward(jcfg, jp, jnp.asarray(x1), state=jst)
    tout, tst = tssm.rwkv6_forward(tcfg, tp, torch.from_numpy(x1), state=tst,
                                   use_kernel=use_kernel)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **STATE_TOL)
    np.testing.assert_allclose(tst["wkv"].numpy(), np.asarray(jst["wkv"]),
                               **STATE_TOL)


@pytest.mark.parametrize("true_len", [None, 5])
def test_cmix_forward_matches_jax(model, true_len):
    jcfg, jparams, tcfg, tparams = model
    jp = _layer_params(jparams["blocks"]["cmix"], 1)
    tp = ttf._layer(tparams["blocks"], 1)["cmix"]
    x = np.random.default_rng(5).standard_normal((2, 8, 64)).astype(
        np.float32)
    state = np.random.default_rng(6).standard_normal((2, 64)).astype(
        np.float32)
    for st in (None, state):
        jout, jsh = jssm.rwkv_cmix_forward(
            jcfg, jp, jnp.asarray(x), None if st is None else jnp.asarray(st),
            true_len=true_len)
        tout, tsh = tssm.rwkv_cmix_forward(
            tcfg, tp, torch.from_numpy(x),
            None if st is None else torch.from_numpy(st), true_len=true_len)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   **STATE_TOL)
        np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_matches_jax(model, use_kernels):
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(6).integers(3, jcfg.vocab_size, (2, 24))
    jl, jaux, jkv = jtf.forward(jcfg, jparams,
                                {"tokens": jnp.asarray(toks, jnp.int32)},
                                jtf.ModelCtx(attn_chunk=8))
    tl, taux, tkv = ttf.forward(tcfg, tparams,
                                {"tokens": torch.from_numpy(toks)},
                                ttf.ModelCtx(attn_chunk=8,
                                             use_kernels=use_kernels))
    assert tkv is None and jkv is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    assert taux.keys() == jaux.keys()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_slot_prefill_and_decode_match_jax(model, use_kernels):
    """One padded prompt into slot 1 of 3, then two decode steps: logits
    and every state row against JAX's ``prefill_into_slot`` /
    ``decode_step``; the other slots' rows stay as the decode leaves
    them, as in JAX."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(7)
    toks = np.zeros((1, 16), np.int64)
    toks[0, :11] = rng.integers(3, jcfg.vocab_size, 11)
    jcache = jtf.init_slots(jcfg, 3, 32)
    tcache = ttf.init_slots(tcfg, 3, 32, device="cpu")
    jrow, jcache = jtf.prefill_into_slot(
        jcfg, jparams, jcache, jnp.asarray(toks, jnp.int32), 11, 1,
        jtf.ModelCtx(attn_chunk=8))
    ctx = ttf.ModelCtx(attn_chunk=8, use_kernels=use_kernels)
    trow, tcache = ttf.prefill_into_slot(tcfg, tparams, tcache,
                                         torch.from_numpy(toks), 11, 1, ctx)
    np.testing.assert_allclose(trow.numpy(), np.asarray(jrow),
                               atol=LOGIT_TOL, rtol=0)
    nxt = np.array([[5], [int(np.argmax(np.asarray(jrow)))], [9]])
    for _ in range(2):
        jl, jcache = jtf.decode_step(jcfg, jparams, jcache,
                                     jnp.asarray(nxt, jnp.int32))
        tl, tcache = ttf.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(nxt), ctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        nxt = np.asarray(np.argmax(np.asarray(jl), -1))
    for key in ("tmix_last", "wkv", "cmix_last"):
        np.testing.assert_allclose(tcache["states"][key].numpy(),
                                   np.asarray(jcache["states"][key]),
                                   **STATE_TOL, err_msg=key)
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))


# -- serving -----------------------------------------------------------------

def _clock(traffic_mod):
    return traffic_mod.Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02)


@pytest.fixture(scope="module")
def jax_runs(model):
    """The JAX engine's run per layout (the slow half of the engine
    test: each prefill bucket compiles)."""
    jcfg, jparams, _, _ = model
    return {name: jeng.serve(
        jcfg, jparams, jtraffic.generate(jtraffic.TrafficConfig(**TRAFFIC)),
        jeng.EngineConfig(layout=JLayout(**kw), n_slots=3, max_len=32),
        jtf.ModelCtx(attn_chunk=8), clock=_clock(jtraffic))
        for name, kw in LAYOUTS.items()}


def _same(a, b):
    """Equality that takes NaN == NaN (empty-sample percentiles)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_matches_jax(model, jax_runs, layout, use_kernels):
    """Greedy streams, every RequestRecord and the whole summary (the
    paged block accounting and modeled state bytes included) equal the
    JAX engine's under a pinned clock."""
    _, _, tcfg, tparams = model
    jout, jrecs, jsum = jax_runs[layout]
    tout, trecs, tsum = teng.serve(
        tcfg, tparams, ttraffic.generate(ttraffic.TrafficConfig(**TRAFFIC)),
        teng.EngineConfig(layout=CacheLayout(**LAYOUTS[layout]), n_slots=3,
                          max_len=32),
        ttf.ModelCtx(attn_chunk=8, use_kernels=use_kernels),
        clock=_clock(ttraffic), device="cpu")
    assert tout == jout
    assert [dataclasses.asdict(r) for r in trecs] == \
        [dataclasses.asdict(r) for r in jrecs]
    assert _same(tsum, jsum), (tsum, jsum)


def test_paged_layout_is_the_identity_composition(model):
    """rwkv6 pages nothing: block tables beside the recurrent states, no
    pool, and the paged backend's streams equal the dense one's."""
    _, _, tcfg, tparams = model
    backend = teng.make_backend(tcfg, tparams,
                                layout=CacheLayout(kind="paged",
                                                   block_size=8),
                                device="cpu")
    assert isinstance(backend, teng.PagedSlots)
    state = backend.init_slots(3, 32)
    assert set(state) == {"states", "len", "block_table", "write_table"}
    assert tuple(state["block_table"].shape) == (3, 4)


def test_int8_and_speculative_decode_refused(model):
    """The reference's ValueErrors: int8 KV does not apply to a family
    without KV, and a recurrent state cannot rewind a rejected draft."""
    _, _, tcfg, tparams = model
    for layout in (CacheLayout(kv_bits=8),
                   CacheLayout(kind="paged", kv_bits=8)):
        with pytest.raises(ValueError, match="carries no KV cache"):
            teng.make_backend(tcfg, tparams, layout=layout, device="cpu")
    backend = teng.make_backend(tcfg, tparams, device="cpu")
    with pytest.raises(ValueError, match="recurrent per-token state"):
        teng.ServingEngine(backend, teng.EngineConfig(spec_k=2))


def test_decode_state_bytes_match_jax():
    for arch in (ARCH, "recllm-base"):
        for n in (0, 37, 512):
            assert troofline.decode_state_bytes(get_arch(arch), n) == \
                jroofline.decode_state_bytes(jget_arch(arch), n)


# -- conversion, the wrapper's refusals, the launcher ------------------------

def test_init_params_matches_the_jax_tree():
    """Same keys, shapes and dtypes as ``jax.eval_shape(tf.init_params)``
    in bf16, and the JAX init's constants; conversion of a bf16 JAX tree
    keeps the mixes, decay base, bonus and norms in float32."""
    jcfg = jreduced(jget_arch(ARCH))
    tcfg = reduced(get_arch(ARCH))
    want = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    got = convert.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    flat_w = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g.keys() == flat_w.keys()
    for key, w in flat_w.items():
        g = flat_g[key]
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), key
    tmix = got["blocks"]["tmix"]
    assert bool((tmix["mix"] == 0.5).all() and (tmix["w_base"] == -6).all()
                and (tmix["u"] == 0).all())
    assert tmix["w_lora_a"].shape[-1] == max(32, tcfg.d_model // 32)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0),
                                                 jcfg)),
        device="cpu", dtype=torch.bfloat16)
    blocks = tparams["blocks"]
    for leaf in (blocks["tmix"]["mix"], blocks["tmix"]["w_base"],
                 blocks["tmix"]["u"], blocks["tmix"]["ln_x"]["scale"],
                 blocks["cmix"]["mix"], blocks["norm1"]["bias"]):
        assert leaf.dtype == torch.float32
    assert blocks["tmix"]["Wr"].dtype == torch.bfloat16


def test_wkv6_wrapper_refusals():
    r, k, v, w, u = _t(*_streams(1, 2, 16, 8))
    before = wkv6_kernel.wkv6_chunked.launches
    with pytest.raises(ValueError, match="chunk=6 must divide T=16"):
        wkv6_kernel.wkv6_chunked(r, k, v, w, u, chunk=6)
    with pytest.raises(ValueError, match="chunk=128"):
        wkv6_kernel.wkv6_chunked(*_t(*_streams(1, 1, 128, 8))[:4],
                                 u[:1], chunk=128)
    big = torch.zeros(1, 1, 8, 128)
    with pytest.raises(ValueError, match="head size 128"):
        wkv6_kernel.wkv6_chunked(big, big, big, big, torch.zeros(1, 128),
                                 chunk=8)
    with pytest.raises(ValueError, match="u"):
        wkv6_kernel.wkv6_chunked(r, k, v, w, u[:1], chunk=8)
    r.requires_grad_()
    with pytest.raises(RuntimeError, match="wkv6_chunked: .*no backward"):
        wkv6_kernel.wkv6_chunked(r, k, v, w, u, chunk=8)
    with torch.no_grad():
        wkv6_kernel.wkv6_chunked(r, k, v, w, u, chunk=8)
    assert wkv6_kernel.wkv6_chunked.launches == before


def test_launcher_serves_reduced_rwkv6_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
            "--reduced", "--device", "cpu", "--requests", "4",
            "--no-warmup"]
    out = subprocess.run(base + ["--kernels", "--cache-layout", "paged"],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "kernels=True" in out.stdout and "4/4 requests" in out.stdout
    out = subprocess.run(base + ["--kv", "int8"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    assert "carries no KV cache" in out.stderr
