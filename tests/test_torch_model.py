"""The port's uniform transformer against the JAX one on reduced RecLLM-base.

JAX params (``transformer.init_params``) go through
``convert.params_from_numpy``; the same numpy tokens go through both
stacks in float32.  Tolerance 1e-4 max abs on logits (the stacks differ
only in summation order); greedy tokens must be equal.  Each case runs the
JAX package's defaults against the port's plain paths, and the JAX Pallas
kernels (interpreted) against the port's kernel paths (plain versions on
the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.config import reduced as jreduced
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.config import get_arch, reduced
from repro_torch.models import transformer as ttf

torch.set_num_threads(2)

TOL = 1e-4
ARCH = "recllm-base"

# (JAX ModelCtx, port ModelCtx): plain paths, then the kernel paths
CTXS = {
    "plain": (jtf.ModelCtx(attn_chunk=8), ttf.ModelCtx(attn_chunk=8)),
    "kernels": (jtf.ModelCtx(attn_chunk=8, attn_impl="pallas",
                             decode_impl="flash"),
                ttf.ModelCtx(attn_chunk=8, attn_impl="flash",
                             decode_impl="flash")),
}


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(jget_arch(ARCH)), dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch(ARCH)), dtype="float32")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.params_from_numpy(tree, device="cpu")
    return jcfg, jparams, tcfg, tparams, tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_config_copy_matches(model):
    jcfg, _, tcfg, _, _ = model
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    full_j, full_t = jget_arch(ARCH), get_arch(ARCH)
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert full_t.padded_vocab == 63232


def test_convert_and_init_keep_the_jax_layout(model):
    _, _, tcfg, tparams, tree = model
    flat_np, flat_t = _flat(tree), _flat(tparams)
    assert flat_np.keys() == flat_t.keys()
    for k, v in flat_np.items():
        assert tuple(flat_t[k].shape) == v.shape, k
        np.testing.assert_array_equal(flat_t[k].numpy(), v, err_msg=k)
    fresh = _flat(convert.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    assert fresh.keys() == flat_np.keys()
    for k, v in flat_np.items():
        assert tuple(fresh[k].shape) == v.shape, k
        assert fresh[k].dtype == flat_t[k].dtype, k
    # bf16 leaves (the model dtype at full width) convert through float32;
    # norm scales stay float32 under a dtype cast, as in the JAX init
    bf = jnp.asarray([[1.5, -2.25]], jnp.bfloat16)
    conv = convert.params_from_numpy(
        {"w": np.asarray(bf), "norm": {"scale": np.zeros(2, np.float32)}},
        device="cpu", dtype=torch.bfloat16)
    assert conv["w"].dtype == torch.bfloat16
    assert conv["w"].float().tolist() == [[1.5, -2.25]]
    assert conv["norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("which", sorted(CTXS))
def test_forward_logits_match(model, which):
    jcfg, jparams, tcfg, tparams, _ = model
    jctx, tctx = CTXS[which]
    tokens = np.random.default_rng(1).integers(0, 256, (2, 19))
    want, _, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                             jctx)
    got, _, _ = ttf.forward(tcfg, tparams,
                            {"tokens": torch.from_numpy(tokens)}, tctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("which", sorted(CTXS))
def test_prefill_and_decode_match(model, which):
    """Two slots prefilled (ragged prompts, one slot left free), then six
    greedy decode steps: logits, tokens and the cache agree."""
    jcfg, jparams, tcfg, tparams, _ = model
    jctx, tctx = CTXS[which]
    n_slots, max_len = 3, 32
    jprefill = jax.jit(jtf.prefill_into_slot, static_argnums=(0, 6))
    jdecode = jax.jit(jtf.decode_step, static_argnums=(0, 4))
    jcache = jtf.init_slots(jcfg, n_slots, max_len)
    tcache = ttf.init_slots(tcfg, n_slots, max_len, device="cpu")
    rng = np.random.default_rng(2)
    nxt = np.zeros((n_slots, 1), np.int64)
    for slot, true_len in ((0, 13), (2, 5)):
        toks = np.zeros((1, 16 if true_len > 8 else 8), np.int64)
        toks[0, :true_len] = rng.integers(3, 256, true_len)
        jrow, jcache = jprefill(
            jcfg, jparams, jcache, jnp.asarray(toks, jnp.int32),
            jnp.int32(true_len), jnp.int32(slot), jctx)
        trow, tcache = ttf.prefill_into_slot(
            tcfg, tparams, tcache, torch.from_numpy(toks), true_len, slot,
            tctx)
        np.testing.assert_allclose(trow.numpy(), np.asarray(jrow), atol=TOL,
                                   rtol=0)
        nxt[slot, 0] = int(np.argmax(np.asarray(jrow)))
        assert int(torch.argmax(trow)) == nxt[slot, 0]
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))

    for _ in range(6):
        jlogits, jcache = jdecode(
            jcfg, jparams, jcache, jnp.asarray(nxt, jnp.int32), jctx)
        tlogits, tcache = ttf.decode_step(tcfg, tparams, tcache,
                                          torch.from_numpy(nxt), tctx)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=TOL, rtol=0)
        want_tok = np.argmax(np.asarray(jlogits)[:, 0], axis=-1)
        np.testing.assert_array_equal(
            torch.argmax(tlogits[:, 0], dim=-1).numpy(), want_tok)
        nxt = want_tok[:, None].astype(np.int64)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=TOL, rtol=0)
    # every slot's length advanced, the free one included
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))


def test_unported_configs_raise():
    learned = dataclasses.replace(reduced(get_arch(ARCH)),
                                  pos_type="learned")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttf.init_slots(learned, 2, 16, device="cpu")
    ring = dataclasses.replace(reduced(get_arch(ARCH)),
                               local_global_pattern=2, sliding_window=8)
    with pytest.raises(NotImplementedError, match="gemma"):
        convert.init_params(ring, torch.Generator(), device="cpu")
