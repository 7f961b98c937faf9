"""The port's MoE slice against the JAX package: the router (Pallas kernel
in interpret mode), ``router_topk``, ``moe_ffn``, the whole forward of
the reduced MoE archs, and the serving engine under every cache layout.

The same numpy inputs go through both packages; params are the JAX init
converted into the port.  Everything runs at float32 on the CPU, where the
router wrapper runs its plain version.  Tolerances: router probs and gates
atol 1e-6 + rtol 1e-6 and equal expert indices (the plain softmax and the
TPU kernel's differ by rounding only); ``moe_ffn`` out 1e-5, lb/z losses
1e-6, expert loads equal; logits 1e-4 (summation order over the stack);
greedy streams and scheduler records equal.

The bf16 cases hold the port's rounding to JAX's: ``moe_ffn`` and the
whole forward in bf16, every element within 2^-8 of the largest |value|
(about one bf16 ulp there) and at most 0.5% of them differing at all
(both packages round the same float32 sums once, where JAX rounds; a sum
taken in another order may round across a boundary, and that one flip
moves what is computed from it).  JAX runs them op by op: under ``jit``
XLA's CPU fusions skip some bf16 roundings of the eager program.

The int8 layouts run at ``moe_capacity_factor=8.0``: the JAX package's
fused int8 prefill (``kvquant.quant_prefill_kv``) routes pad tokens, so at
a tight capacity its streams depend on the padding; the port masks them
(``test_moe_prefill_independent_of_pad_contents``).
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
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import engine as jeng
from repro.serving import traffic as jtraffic
from repro_torch import convert
from repro_torch.cache_layout import CacheLayout
from repro_torch.config import get_arch, reduced
from repro_torch.kernels import moe_router as router_kernel
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as teng
from repro_torch.serving import traffic as ttraffic

torch.set_num_threads(2)

ARCHS = ("moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b")
ROUTER_TOL = dict(atol=1e-6, rtol=1e-6)
TRAFFIC = dict(n_requests=6, rate=80.0, prompt_max=14, new_tokens_max=5,
               vocab_size=256, seed=3)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(arch, **kw):
    j = dataclasses.replace(jreduced(jget_arch(arch)), dtype="float32", **kw)
    t = dataclasses.replace(reduced(get_arch(arch)), dtype="float32", **kw)
    return j, t


def _convert(jparams):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, _convert(jparams)


def _logits(T, E, seed=0):
    return np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32)


def _tied(E, k):
    """Rows of equal logits and of duplicated maxima."""
    rows = np.zeros((4, E), np.float32)                # all equal
    rows[1] = np.linspace(-1, 1, E)
    rows[1, [3, E - 2, E // 2]] = 2.0                  # three equal maxima
    rows[2, ::2] = 1.5                                 # half the row ties
    rows[3] = -3.0
    rows[3, [E - 1, 1]] = 0.5                          # ties at both ends
    return rows


def _check_router(got, want):
    (tg, ti, tp), (jg, ji, jp) = got, want
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **ROUTER_TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **ROUTER_TOL)


# -- the router --------------------------------------------------------------

@pytest.mark.parametrize("T,E,k", [(64, 8, 2), (128, 64, 6), (96, 128, 8),
                                   (1100, 8, 2)])
def test_router_matches_pallas(T, E, k):
    """The plain version and the wrapper on CPU tensors against the Pallas
    kernel (interpret mode); 1100 rows run past one 1024-row TPU block."""
    x = np.concatenate([_logits(T, E), _tied(E, k)])
    want = jops.moe_router(jnp.asarray(x), k)
    for fn in (ref.moe_router, ops.moe_router, router_kernel.moe_router):
        _check_router(fn(torch.from_numpy(x), k), want)


@pytest.mark.parametrize("E,k", [(8, 2), (64, 6), (128, 8)])
def test_router_tie_break_is_first_occurrence(E, k):
    gates, idx, _ = ops.moe_router(torch.from_numpy(_tied(E, k)), k)
    assert idx[0].tolist() == list(range(k))
    np.testing.assert_allclose(gates[0].numpy(), np.full(k, 1.0 / k),
                               **ROUTER_TOL)
    assert idx[1].tolist()[:3] == [3, E // 2, E - 2][:k]
    assert idx[2].tolist() == list(range(0, 2 * k, 2))
    assert idx[3, :2].tolist() == [1, E - 1]


def test_router_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="E=129"):
        ops.moe_router(torch.zeros(4, 129), 2)
    with pytest.raises(ValueError, match="k=9"):
        ops.moe_router(torch.zeros(4, 8), 9)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_router_topk_matches_jax(use_kernel):
    """Batched leading dims kept; ties (equal logits) in lax.top_k's
    lower-index-first order on both branches."""
    x = np.concatenate([_logits(30, 16, seed=2), _tied(16, 4),
                        np.zeros((2, 16), np.float32)]).reshape(3, 12, 16)
    jg, ji, jp = jmoe.router_topk(jnp.asarray(x), 4, use_kernel)
    tg, ti, tp = tmoe.router_topk(torch.from_numpy(x), 4, use_kernel)
    assert tg.shape == (3, 12, 4) and tp.shape == x.shape
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **ROUTER_TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **ROUTER_TOL)


# -- the MoE FFN -------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("capacity", [1.25, 0.5])
@pytest.mark.parametrize("arch,E,k", [("moonshot-v1-16b-a3b", 8, 2),
                                      ("qwen3-moe-30b-a3b", 16, 4)])
def test_moe_ffn_matches_jax(arch, E, k, capacity, masked, use_kernel):
    """Two groups of 64 tokens (B=2, S=64, group 64); capacity 0.5 drops
    (some expert gets more than C of a group's tokens); the live mask takes
    the last 21 positions of row 0 and 2 of row 1 out of routing."""
    jcfg, tcfg = _cfgs(arch, num_experts=E, experts_per_token=k)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    tp = _convert(jp)
    x = np.random.default_rng(4).standard_normal((2, 64, 64)).astype(
        np.float32)
    live = None
    if masked:
        live = np.ones((2, 64), bool)
        live[0, 43:] = False
        live[1, 62:] = False
    kw = dict(capacity_factor=capacity, group_size=64, use_kernel=use_kernel)
    jout, jaux = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x), **kw,
                              live=None if live is None else jnp.asarray(live))
    tout, taux = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x), **kw,
                              live=None if live is None
                              else torch.from_numpy(live))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))
    if capacity < 1:
        C = tmoe._capacity(64, k, E, capacity)
        assert float(taux["expert_load"].max()) > 2 * C
    if masked:
        dead = ~live
        assert np.abs(tout.numpy()[dead]).max() == 0.0
        assert float(taux["expert_load"].sum()) == k * live.sum()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_matches_jax(model, use_kernels):
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(6).integers(3, jcfg.vocab_size, (2, 24))
    jctx = jtf.ModelCtx(attn_chunk=8, use_kernels=use_kernels)
    tctx = ttf.ModelCtx(attn_chunk=8, use_kernels=use_kernels)
    jl, jaux, _ = jtf.forward(jcfg, jparams,
                              {"tokens": jnp.asarray(toks, jnp.int32)}, jctx)
    tl, taux, _ = ttf.forward(tcfg, tparams,
                              {"tokens": torch.from_numpy(toks)}, tctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    assert taux.keys() == jaux.keys()
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))


# -- bf16 --------------------------------------------------------------------

class _F32DotJnp:
    """``jax.numpy`` for the JAX MoE module, but an einsum asked for a
    float32 result from 16-bit operands takes float32 operands: XLA's CPU
    runtime cannot run the bf16 x bf16 -> f32 dot it makes of the expert
    products ("Unsupported element type for DotThunk").  It is the same
    product: bf16 -> f32 is exact, and so is a bf16 x bf16 product in
    f32."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(eq, *operands, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32) for o in operands]
        return jnp.einsum(eq, *operands,
                          preferred_element_type=preferred_element_type,
                          **kw)


@pytest.fixture
def jax_f32_dots(monkeypatch):
    monkeypatch.setattr(jmoe, "jnp", _F32DotJnp())


BF16_ATOL = 2.0 ** -8         # of the largest |value|: ~ one bf16 ulp there
BF16_MAX_DIFFERING = 0.005


def _assert_bf16_close(got, want):
    """Every element within ``BF16_ATOL`` of the largest magnitude of JAX's
    values, and at most ``BF16_MAX_DIFFERING`` of them differing at
    all."""
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got - want)
    atol = BF16_ATOL * np.abs(want).max()
    assert diff.max() <= atol, (
        f"largest difference {diff.max()} > {atol}")
    assert (diff > 0).mean() <= BF16_MAX_DIFFERING, (
        f"{(diff > 0).mean():.1%} of the elements differ from JAX's")


@pytest.mark.parametrize("capacity", [1.25, 0.5])
@pytest.mark.parametrize("arch,E,k", [("moonshot-v1-16b-a3b", 8, 2),
                                      ("qwen3-moe-30b-a3b", 16, 4)])
def test_moe_ffn_bf16_matches_jax(jax_f32_dots, arch, E, k, capacity):
    """bf16 weights and inputs: the gate/up products and the combine keep
    float32 results, rounded once where JAX rounds (after the activation,
    after the combine)."""
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), num_experts=E,
                               experts_per_token=k)
    tcfg = dataclasses.replace(reduced(get_arch(arch)), num_experts=E,
                               experts_per_token=k)
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    tp = _convert(jp)
    x = np.random.default_rng(4).standard_normal((2, 64, 64)).astype(
        np.float32)
    kw = dict(capacity_factor=capacity, group_size=64)
    jout, jaux = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x, jnp.bfloat16), **kw)
    tout, taux = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x).to(
        torch.bfloat16), **kw)
    assert tout.dtype == torch.bfloat16
    _assert_bf16_close(tout, jout)
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_jax(jax_f32_dots, arch):
    """The reduced arch's whole forward in bf16 (its config's own dtype)
    against JAX's, run op by op."""
    jcfg, tcfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = _convert(jparams)
    toks = np.random.default_rng(6).integers(3, jcfg.vocab_size, (2, 24))
    with jax.disable_jit():
        jl, _, _ = jtf.forward(jcfg, jparams,
                               {"tokens": jnp.asarray(toks, jnp.int32)},
                               jtf.ModelCtx(attn_chunk=8))
    tl, _, _ = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                           ttf.ModelCtx(attn_chunk=8))
    assert tl.dtype == torch.bfloat16
    _assert_bf16_close(tl, jl)


# -- serving -----------------------------------------------------------------

def _same(a, b):
    """Equality that takes NaN == NaN (empty-sample percentiles)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def _clock(traffic_mod):
    return traffic_mod.Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02)


@pytest.mark.parametrize("layout", [
    dict(), dict(kind="paged", block_size=8), dict(kv_bits=8),
    dict(kind="paged", kv_bits=8, block_size=8),
], ids=["dense", "paged", "int8", "paged_int8"])
def test_engine_matches_jax(model, layout):
    """Greedy streams, every RequestRecord and the whole summary equal the
    JAX engine's under a pinned clock; the int8 layouts at capacity 8.0 (no
    token drops, so the reference's pad routing cannot show)."""
    jcfg, jparams, tcfg, tparams = model
    cap = 8.0 if layout.get("kv_bits") == 8 else 1.25
    ecfg = dict(n_slots=3, max_len=32)
    jout, jrecs, jsum = jeng.serve(
        jcfg, jparams, jtraffic.generate(jtraffic.TrafficConfig(**TRAFFIC)),
        jeng.EngineConfig(layout=JLayout(**layout), **ecfg),
        jtf.ModelCtx(attn_chunk=8, moe_capacity_factor=cap),
        clock=_clock(jtraffic))
    tout, trecs, tsum = teng.serve(
        tcfg, tparams, ttraffic.generate(ttraffic.TrafficConfig(**TRAFFIC)),
        teng.EngineConfig(layout=CacheLayout(**layout), **ecfg),
        ttf.ModelCtx(attn_chunk=8, moe_capacity_factor=cap, use_kernels=True),
        clock=_clock(ttraffic), device="cpu")
    assert tout == jout
    assert [dataclasses.asdict(r) for r in trecs] == \
        [dataclasses.asdict(r) for r in jrecs]
    assert _same(tsum, jsum), (tsum, jsum)


@pytest.mark.parametrize("layout", [
    dict(), dict(kind="paged", block_size=8), dict(kv_bits=8),
    dict(kind="paged", kv_bits=8, block_size=8),
], ids=["dense", "paged", "int8", "paged_int8"])
def test_moe_prefill_independent_of_pad_contents(model, layout):
    """Port of the JAX test of the same name to every cache layout of the
    port: pad positions are masked out of MoE routing, so at a tight
    capacity (0.5) and a wide pad region the prefill logits and the next
    three greedy tokens are identical whatever the padding holds (the JAX
    package's int8 layouts fail this: ``ROADMAP.md``, section 3)."""
    _, _, tcfg, tparams = model
    ctx = ttf.ModelCtx(attn_chunk=8, moe_capacity_factor=0.5)
    backend = teng.make_backend(tcfg, tparams, ctx,
                                layout=CacheLayout(**layout), device="cpu")
    rng = np.random.default_rng(3)
    plen, s_pad = 9, 32
    prompt = rng.integers(3, tcfg.vocab_size, plen)
    outs = []
    for fill in (0, 1):                      # pad with zeros vs garbage
        padded = np.zeros((1, s_pad), np.int64)
        if fill:
            padded[0] = rng.integers(3, tcfg.vocab_size, s_pad)
        padded[0, :plen] = prompt
        cache = backend.init_slots(1, 32)
        if layout.get("kind") == "paged":
            tbl = np.arange(1, 5, dtype=np.int32)[None]
            cache = backend.set_tables(cache, tbl, tbl)
        lg, cache = backend.prefill(cache, padded, plen, 0)
        toks = [int(torch.argmax(lg))]
        for _ in range(3):
            lg2, cache = backend.decode(cache, torch.tensor([[toks[-1]]]))
            toks.append(int(torch.argmax(lg2[0, 0])))
        outs.append((lg.numpy(), toks))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


# -- conversion, autograd, launcher -------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_the_jax_tree(arch):
    """Same keys, shapes and dtypes as ``jax.eval_shape(tf.init_params)``
    in bf16; conversion of a bf16 JAX tree keeps the router and qk-norm
    scales in float32."""
    jcfg = jreduced(jget_arch(arch))
    tcfg = reduced(get_arch(arch))
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
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0),
                                                 jcfg)),
        device="cpu", dtype=torch.bfloat16)
    blocks = tparams["blocks"]
    assert blocks["ffn"]["moe"]["router"].dtype == torch.float32
    assert blocks["ffn"]["moe"]["wi_gate"].dtype == torch.bfloat16
    if jcfg.qk_norm:
        assert blocks["attn"]["q_norm"].dtype == torch.float32
        assert blocks["attn"]["k_norm"].dtype == torch.float32


def test_router_wrapper_refuses_autograd():
    x = torch.from_numpy(_logits(8, 16)).requires_grad_()
    before = router_kernel.moe_router.launches
    with pytest.raises(RuntimeError, match="moe_router: .*no backward"):
        router_kernel.moe_router(x, 2)
    with torch.no_grad():
        router_kernel.moe_router(x, 2)
    assert router_kernel.moe_router.launches == before


def test_launcher_serves_a_reduced_moe_arch_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "moonshot-v1-16b-a3b", "--reduced", "--device", "cpu",
         "--kernels", "--requests", "4", "--no-warmup"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "kernels=True" in out.stdout
    assert "4/4 requests" in out.stdout


def test_capacity_matches_jax():
    for group, k, E, f in ((16, 2, 8, 1.25), (32, 6, 64, 1.25),
                           (256, 8, 128, 0.5), (1, 6, 64, 1.25)):
        assert tmoe._capacity(group, k, E, f) == \
            jmoe._capacity(group, k, E, f)


# -- the fused route (router, capacity places, dispatch, combine) ------------

def _jax_dispatch(gates, idx, E, C, live, dtype):
    """``src/repro/models/moe.py``'s ``moe_ffn`` from the one-hot of the
    routing to the combine tensor, with its aux counts, written out in jnp
    and fed a given routing (gates, idx (g, G, k) of E experts): (place,
    keep, dispatch, combine, top-1 share, load)."""
    g, G, k = idx.shape
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    if live is not None:
        onehot = onehot * live.reshape(g, G).astype(jnp.float32)[..., None,
                                                                 None]
    flat = onehot.transpose(0, 2, 1, 3).reshape(g, k * G, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = pos.reshape(g, k, G, E).transpose(0, 2, 1, 3)
    place = jnp.sum(pos * onehot, axis=-1)
    keep = place < C
    pos_in_e = jnp.where(keep, place, 0).astype(jnp.int32)
    gates_k = gates * keep
    poshot = jax.nn.one_hot(pos_in_e, C, dtype=jnp.float32) * keep[..., None]
    dispatch = jnp.einsum("gtke,gtkc->gtec", onehot, poshot).astype(dtype)
    combine = jnp.einsum("gtke,gtkc->gtec", onehot * gates_k[..., None],
                         poshot).astype(dtype)
    return (place, keep, dispatch, combine,
            jnp.mean(onehot[..., 0, :], axis=(0, 1)),
            jnp.sum(onehot, axis=(0, 1, 2)))


ROUTE_CASES = [  # (g, G, E, k, capacity factor, dead share, dtype)
    (8, 1, 64, 6, 1.25, 0.0, "bfloat16"),      # Moonlight decode
    (8, 1, 128, 8, 1.25, 0.0, "bfloat16"),     # Qwen3 decode
    (8, 1, 8, 2, 1.25, 0.5, "float32"),
    (40, 1, 64, 6, 1.25, 0.3, "bfloat16"),     # decode, more than 32 slots
    (3, 7, 8, 2, 0.5, 0.3, "float32"),
    (3, 7, 64, 6, 1.25, 0.3, "bfloat16"),
    (1, 7, 128, 8, 0.5, 0.0, "float32"),
    (2, 64, 64, 6, 1.25, 0.0, "bfloat16"),
    (2, 64, 64, 6, 0.5, 0.5, "float32"),
    (2, 64, 128, 8, 0.5, 0.0, "bfloat16"),
    (2, 64, 8, 2, 0.5, 0.3, "bfloat16"),
    (2, 64, 128, 8, 1.25, 0.3, "float32"),
    (1, 256, 64, 6, 1.25, 0.3, "bfloat16"),
    (1, 256, 128, 8, 0.5, 0.5, "float32"),
    (2, 256, 8, 2, 1.25, 0.0, "float32"),
    (1, 256, 8, 2, 0.5, 0.0, "bfloat16"),
]


def _route_inputs(g, G, E, dead, seed):
    """Logits with a per-expert skew (hot experts, so capacity drops), the
    first token's row all equal (experts 0..k-1), and a live mask with
    ``dead`` of the tokens out (None when 0)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((g, G, E))
         + 1.5 * rng.standard_normal(E)).astype(np.float32)
    x[0, 0] = 0.0
    live = rng.random((g, G)) >= dead if dead else None
    return x, live


@pytest.mark.parametrize("g,G,E,k,capacity,dead,dtype", ROUTE_CASES)
def test_route_matches_the_reference_dispatch(g, G, E, k, capacity, dead,
                                              dtype):
    """``ops.moe_route`` on CPU tensors (the wrapper's plain version)
    against the reference's dispatch in jnp fed the same routing: places,
    keep, dispatch and combine (in the model dtype), loads equal; the
    routing is ``ref.moe_router``'s, the top-1 shares within 1e-7."""
    x, live = _route_inputs(g, G, E, dead, seed=G * E + k)
    C = tmoe._capacity(G, k, E, capacity)
    tdt = getattr(torch, dtype)
    r = ops.moe_route(torch.from_numpy(x), k, C,
                      None if live is None else torch.from_numpy(live), tdt)
    gates, idx, probs = ref.moe_router(torch.from_numpy(x).reshape(-1, E), k)
    assert torch.equal(r.gates.reshape(-1, k), gates)
    assert torch.equal(r.idx.reshape(-1, k), idx)
    assert torch.equal(r.probs.reshape(-1, E), probs)
    assert r.idx[0, 0].tolist() == list(range(k))
    place, keep, disp, comb, top1, load = _jax_dispatch(
        jnp.asarray(r.gates.numpy()), jnp.asarray(r.idx.numpy()), E, C,
        None if live is None else jnp.asarray(live), jnp.dtype(dtype))
    assert r.place.dtype == torch.int32
    np.testing.assert_array_equal(r.place.numpy(), np.asarray(place))
    np.testing.assert_array_equal((r.place < C).numpy(), np.asarray(keep))
    assert r.dispatch.dtype == r.combine.dtype == tdt
    assert r.dispatch.shape == (g, G, E, C)
    for got, want in ((r.dispatch, disp), (r.combine, comb)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(r.load.numpy(), np.asarray(load))
    np.testing.assert_allclose(r.top1.numpy(), np.asarray(top1), atol=1e-7,
                               rtol=0)
    alive = np.ones((g, G), bool) if live is None else live
    if capacity < 1 and G >= 64:        # hot experts overflow their queues
        assert (~np.asarray(keep) & alive[..., None]).any()
    assert float(r.load.sum()) == k * alive.sum()


def test_route_refuses_what_the_kernel_cannot_take():
    before = router_kernel.moe_route.launches
    with pytest.raises(ValueError, match="G=1025"):
        ops.moe_route(torch.zeros(1, 1025, 8), 2, 8)
    with pytest.raises(ValueError, match="E=129"):
        ops.moe_route(torch.zeros(2, 4, 129), 2, 8)
    x = torch.zeros(2, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="moe_route: .*no backward"):
        ops.moe_route(x, 2, 8)
    with torch.no_grad():
        ops.moe_route(x, 2, 8)
    assert router_kernel.moe_route.launches == before
