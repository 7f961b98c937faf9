"""The port's training math against the JAX package, on reduced RecLLM-base
(2 layers, float32, the dataset at scale 0.005, the vocab at n_items + 3).

JAX params (``recsys.model.init_recllm``) go through
``convert.params_from_numpy``; the same numpy batches go through both
packages.  Tolerances: gradients within 1e-5 of each leaf's largest |g|
(the packages sum in other orders); losses and logits 1e-4 absolute;
AdamW state 1e-6 relative over 3 steps, bf16 params within one bf16 ulp
of JAX's, and through the fused AdamW kernels 1e-6 absolute + 1e-5
relative (the Pallas kernel's own tolerance); the schedule 1e-7 relative;
HR/NDCG and dataset arrays exactly.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as jget_arch
from repro.config import reduced as jreduced
from repro.embeddings import dedup_ids as jdedup_ids
from repro.kernels import ops as jops
from repro.models import transformer as jtf
from repro.optimizer import adamw as jadamw
from repro.optimizer import schedule as jschedule
from repro.recsys import dataset as jdataset
from repro.recsys import metrics as jmetrics
from repro.recsys import model as jrec
from repro_torch import convert
from repro_torch.cache_layout import CacheLayout
from repro_torch.config import TrainConfig, get_arch, reduced
from repro_torch.embeddings import dedup_ids
from repro_torch.kernels import ops as tops
from repro_torch.models import attention, transformer as ttf
from repro_torch.optimizer import adamw, schedule
from repro_torch.recsys import dataset, metrics, model as trec
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCALE = 0.005


@pytest.fixture(scope="module")
def setup():
    ds = jdataset.generate(scale=SCALE, seed=0)
    jcfg = dataclasses.replace(jreduced(jget_arch("recllm-base"), layers=2),
                               vocab_size=ds.n_items + 3, dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch("recllm-base"), layers=2),
                               vocab_size=ds.n_items + 3, dtype="float32")
    jparams = jrec.init_recllm(jax.random.PRNGKey(0), jcfg, ds.n_users)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.params_from_numpy(tree, device="cpu")
    batch = next(jdataset.seq_batches(ds, 8, 16, steps=1, seed=7))
    # users with repeats, so the dedup lookup and its gradient are used
    batch["user"] = np.random.default_rng(0).integers(
        0, ds.n_users, 8).astype(np.int32)
    batch["user"][4:] = batch["user"][:4]
    return ds, jcfg, tcfg, jparams, tparams, batch


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _grads(loss_fn, params):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(leaves)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(leaves))


def _assert_grads(jgrads, tgrads):
    flat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    assert len(flat) == len(tgrads)
    for (path, jg), tg in zip(flat, tgrads):
        jg = np.asarray(jg)
        err = np.abs(jg - tg.numpy()).max()
        assert err <= 1e-5 * np.abs(jg).max(), (jax.tree_util.keystr(path),
                                                err, np.abs(jg).max())


def test_recllm_loss_and_gradients_match_jax(setup):
    _, jcfg, tcfg, jparams, tparams, batch = setup
    jctx, tctx = jtf.ModelCtx(attn_chunk=8), ttf.ModelCtx(attn_chunk=8)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jrec.recllm_loss(jcfg, p, _jax(batch), jctx)[0]))(jparams)
    tloss, tgrads = _grads(
        lambda p: trec.recllm_loss(tcfg, p, _torch(batch), tctx)[0], tparams)
    assert abs(float(jloss) - float(tloss)) <= 1e-4
    _assert_grads(jgrads, tgrads)


def test_lm_loss_fn_chunked_ce_matches_jax(setup):
    """``loss_fn`` through ``chunked_ce`` with a chunk that does not divide
    S (12 tokens, chunk 8 -> gcd 4), and the JAX custom backward passes of
    the embedding and the NLL."""
    _, jcfg, tcfg, jparams, tparams, batch = setup
    b = {k: batch[k][:, :12] for k in ("tokens", "targets", "mask")}
    jctx, tctx = jtf.ModelCtx(attn_chunk=8), ttf.ModelCtx(attn_chunk=8)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, _jax(b), jctx)[0]))(jparams["lm"])
    tloss, tgrads = _grads(
        lambda p: ttf.loss_fn(tcfg, p, _torch(b), tctx)[0], tparams["lm"])
    assert abs(float(jloss) - float(tloss)) <= 1e-4
    _assert_grads(jgrads, tgrads)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((24, 16)).astype(np.float32),
            "b": {"scale": rng.standard_normal((16,)).astype(np.float32)},
            "e": rng.standard_normal((40, 8)).astype(np.float32)}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_adamw_apply_matches_jax_over_three_steps(bf16):
    """With clipping active (global norm far above 1) and, for bf16, the
    params kept in bf16 beside an f32 master."""
    p0 = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = tree_map(torch.from_numpy, p0)
    if bf16:
        jp = {**jp, "w": jp["w"].astype(jnp.bfloat16)}
        tp = {**tp, "w": tp["w"].to(torch.bfloat16)}
    jt = JTrainConfig(weight_decay=0.1, grad_clip=1.0)
    tt = TrainConfig(weight_decay=0.1, grad_clip=1.0)
    jo, to = jadamw.init_opt_state(jp), adamw.init_opt_state(tp)
    for s in range(3):
        g = tree_map(lambda x: 10 * x, _opt_tree(10 + s))
        lr = 1e-2 * (s + 1)
        jp, jo = jadamw.adamw_apply(jp, jax.tree.map(jnp.asarray, g), jo, lr,
                                    jt)
        tp, to = adamw.adamw_apply(tp, tree_map(torch.from_numpy, g), to, lr,
                                   tt)
        for key in ("master", "m", "v"):
            for a, b in zip(jax.tree.leaves(jo[key]), tree_leaves(to[key])):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-6, atol=1e-7)
        assert int(jo["step"]) == int(to["step"]) == s + 1
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            a = np.asarray(a.astype(jnp.float32))
            b = b.float().numpy()
            rtol = 2 ** -8 if bf16 else 1e-6      # one bf16 ulp
            np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-7)
    assert to["master"]["w"].dtype == torch.float32
    assert tp["w"].dtype == (torch.bfloat16 if bf16 else torch.float32)


def test_update_rule_matches_jax():
    """``make_update_rule``'s (init, apply), its warmup-cosine LR and
    ``lr_scale`` over 3 steps: master, m, v and params 1e-6 relative."""
    from repro.runtime import trainer as jtrainer
    from repro_torch.runtime import trainer as ttrainer
    kw = dict(steps=10, learning_rate=1e-2, warmup_steps=2,
              weight_decay=0.1, grad_clip=1.0)
    jinit, japply = jtrainer.make_update_rule(JTrainConfig(**kw))
    tinit, tapply = ttrainer.make_update_rule(TrainConfig(**kw))
    jp = jax.tree.map(jnp.asarray, _opt_tree(0))
    tp = tree_map(torch.from_numpy, _opt_tree(0))
    jo, to = jinit(jp), tinit(tp)
    for s, scale in enumerate((1.0, 0.5, 0.25)):
        g = tree_map(lambda x: 10 * x, _opt_tree(20 + s))
        jp, jo = japply(jp, jo, jax.tree.map(jnp.asarray, g), scale)
        tp, to = tapply(tp, to, tree_map(torch.from_numpy, g), scale)
        for a, b in zip(jax.tree.leaves({**jo, "step": jp}),
                        tree_leaves({**to, "step": tp})):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
        assert int(jo["step"]) == int(to["step"]) == s + 1


# the fused AdamW kernel's plain version against the Pallas kernel, held
# as tests/test_kernels.py holds the Pallas kernel to its oracle (the
# kernel computes (1 - b2) * g * g, the oracle (1 - b2) * g**2)
ADAMW_TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("N", [8 * 2048, 8 * 4096])
def test_adamw_update_matches_pallas(N):
    rng = np.random.default_rng(N)
    p, g, m, v = (rng.standard_normal(N).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    step = 3
    bc1, bc2 = 1 - 0.9 ** step, 1 - 0.95 ** step
    want = jops.adamw_update(*map(jnp.asarray, (p, g, m, v)), 1e-3, bc1, bc2)
    for impl in ("kernel", "ref"):
        got = tops.adamw_update(*map(torch.from_numpy, (p, g, m, v)), 1e-3,
                                bc1, bc2, impl=impl)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **ADAMW_TOL)


def _reduced_tree(seed):
    """RecLLM's parameter shapes at 2 layers, d_model 64, 962 users and a
    vocab of 256: every leaf the kernel route takes has a shape the Pallas
    kernel's tiling accepts, so JAX's own kernel route can run."""
    cfg = dataclasses.replace(jreduced(jget_arch("recllm-base"), layers=2),
                              vocab_size=256, dtype="float32")
    shapes = jax.eval_shape(lambda: jrec.init_recllm(jax.random.PRNGKey(0),
                                                     cfg, 962))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)


def test_adamw_apply_kernel_route_matches_jax_on_recllm():
    """``use_kernel=True`` on both sides over 3 steps with clipping: the
    leaves whose size is a multiple of 1024 take the fused kernels (the
    Pallas one in interpret mode, the port's plain version on the CPU),
    the rest the elementwise update."""
    p0 = _reduced_tree(0)
    jp, tp = jax.tree.map(jnp.asarray, p0), convert.params_from_numpy(
        p0, device="cpu")
    jt = JTrainConfig(weight_decay=0.1, grad_clip=1.0)
    tt = TrainConfig(weight_decay=0.1, grad_clip=1.0)
    jo, to = jadamw.init_opt_state(jp), adamw.init_opt_state(tp)
    routed = [x.size for x in jax.tree.leaves(p0) if x.size % 1024 == 0]
    assert len(routed) == 9 and len(jax.tree.leaves(p0)) == 14
    for s in range(3):
        g = jax.tree.map(lambda x: 10 * x, _reduced_tree(10 + s))
        lr = 1e-2 * (s + 1)
        jp, jo = jadamw.adamw_apply(jp, jax.tree.map(jnp.asarray, g), jo, lr,
                                    jt, use_kernel=True)
        tp, to = adamw.adamw_apply(tp, convert.params_from_numpy(
            g, device="cpu"), to, lr, tt, use_kernel=True)
        for key in ("master", "m", "v"):
            for a, b in zip(jax.tree.leaves(jo[key]), tree_leaves(to[key])):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           **ADAMW_TOL)


@pytest.mark.parametrize("N", [17_408, 20_480], ids=["17408", "cf_item"])
def test_adamw_kernel_route_takes_leaves_the_pallas_kernel_rejects(N):
    """N / 8 above 2048 and not a multiple of it: JAX's kernel route
    asserts (17,408; and 20,480, the scale-0.005 RecLLM's ``cf_item`` and
    ``embed``), the port's kernel takes any N and computes the update JAX
    computes without the kernel."""
    rng = np.random.default_rng(1)
    p0 = {"w": rng.standard_normal(N).astype(np.float32)}
    g = {"w": rng.standard_normal(N).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p0)
    jt, tt = JTrainConfig(), TrainConfig()
    with pytest.raises(AssertionError):
        jadamw.adamw_apply(jp, jax.tree.map(jnp.asarray, g),
                           jadamw.init_opt_state(jp), 1e-3, jt,
                           use_kernel=True)
    jp1, jo1 = jadamw.adamw_apply(jp, jax.tree.map(jnp.asarray, g),
                                  jadamw.init_opt_state(jp), 1e-3, jt)
    tp = tree_map(torch.from_numpy, p0)
    tp1, to1 = adamw.adamw_apply(tp, tree_map(torch.from_numpy, g),
                                 adamw.init_opt_state(tp), 1e-3, tt,
                                 use_kernel=True)
    for key in ("master", "m", "v"):
        np.testing.assert_allclose(to1[key]["w"].numpy(),
                                   np.asarray(jo1[key]["w"]), **ADAMW_TOL)


def test_warmup_cosine_and_constant_match_jax():
    steps = np.arange(0, 60)
    for warm, total in ((5, 50), (0, 20), (10, 10)):
        j = np.asarray(jschedule.warmup_cosine(jnp.asarray(steps), 3e-3,
                                               warm, total))
        t = schedule.warmup_cosine(torch.from_numpy(steps), 3e-3, warm, total)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-10)
    assert float(schedule.constant(7, 0.5)) == float(
        jschedule.constant(7, 0.5))


def test_hr_ndcg_and_history_exclusion_match_jax():
    rng = np.random.default_rng(1)
    scores = rng.standard_normal((32, 50)).astype(np.float32)
    gold = rng.integers(3, 50, 32).astype(np.int32)
    toks = rng.integers(0, 50, (32, 6)).astype(np.int32)
    excl = metrics.history_exclusion(toks, 50)
    np.testing.assert_array_equal(excl, jmetrics.history_exclusion(toks, 50))
    for ex in (None, excl):
        j = jmetrics.hr_ndcg_at_k(jnp.asarray(scores), jnp.asarray(gold),
                                  k=10, exclude=None if ex is None
                                  else jnp.asarray(ex))
        t = metrics.hr_ndcg_at_k(torch.from_numpy(scores),
                                 torch.from_numpy(gold), k=10,
                                 exclude=None if ex is None
                                 else torch.from_numpy(ex))
        np.testing.assert_allclose([float(x) for x in t],
                                   [float(x) for x in j], rtol=1e-6)


def test_score_users_matches_jax(setup):
    """Including a full-window history (lens == S), clamped to S - 1."""
    ds, jcfg, tcfg, jparams, tparams, _ = setup
    toks, gold, lens = jdataset.eval_examples(ds, seq_len=16, max_users=24)
    lens = lens.copy()
    lens[0] = 16
    users = np.arange(toks.shape[0], dtype=np.int32) % 5
    jctx, tctx = jtf.ModelCtx(attn_chunk=8), ttf.ModelCtx(attn_chunk=8)
    j = jrec.score_users(jcfg, jparams, jnp.asarray(toks), jnp.asarray(users),
                         jnp.asarray(lens), jctx)
    with torch.no_grad():
        t = trec.score_users(tcfg, tparams, torch.from_numpy(toks),
                             torch.from_numpy(users), torch.from_numpy(lens),
                             tctx)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


def test_dataset_arrays_equal_the_jax_package():
    a, b = dataset.generate(scale=SCALE, seed=3), jdataset.generate(
        scale=SCALE, seed=3)
    assert (a.n_users, a.n_items, a.split) == (b.n_users, b.n_items, b.split)
    for f in ("user", "item", "time"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for x, y in zip(dataset.seq_batches(a, 4, 8, steps=3, seed=5),
                    jdataset.seq_batches(b, 4, 8, steps=3, seed=5)):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    for x, y in zip(dataset.eval_examples(a, 8, max_users=64),
                    jdataset.eval_examples(b, 8, max_users=64)):
        np.testing.assert_array_equal(x, y)


def test_dedup_ids_pad_like_jnp_unique():
    ids = np.array([[7, 3, 7], [9, 3, 3]], np.int32)
    for cap in (None, 8):
        ju, jinv = jdedup_ids(jnp.asarray(ids), cap)
        tu, tinv = dedup_ids(torch.from_numpy(ids), cap)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    with pytest.raises(ValueError, match="cap"):
        dedup_ids(torch.from_numpy(ids), 2)


def test_init_recllm_keeps_the_jax_tree(setup):
    ds, _, tcfg, _, tparams, _ = setup
    fresh = trec.init_recllm(tcfg, ds.n_users,
                             torch.Generator().manual_seed(0), device="cpu")
    assert fresh.keys() == tparams.keys()
    for a, b in zip(tree_leaves(fresh), tree_leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for key in ("cf_user", "cf_item"):
        assert abs(float(fresh[key].std()) - 0.02) < 2e-3
    assert float(fresh["fusion_gate"]) == 0.0


def _attention_calls():
    """wrapper name -> call(q, k, v) through the public entry points."""
    lengths = torch.tensor([5])
    table = torch.tensor([[1, 2]], dtype=torch.int32)

    def pool(x):                      # (1, 8, 2, D) -> (3, 4, 2, D) pool
        return torch.cat([torch.zeros_like(x[0, :4])[None],
                          x.reshape(2, 4, *x.shape[2:])])

    def quant(x):
        return x.round(), x.abs().amax(-1)

    return {
        "flash_attention": lambda q, k, v: attention.attention(
            q, k, v, impl="flash"),
        "flash_decode_attention": lambda q, k, v: tops.flash_decode(
            q[:, :1], k, v, lengths),
        "flash_decode_attention_quant":
            lambda q, k, v: tops.flash_decode_quant(
                q[:, :1], *quant(k), *quant(v), lengths),
        "flash_decode_attention_paged": lambda q, k, v: tops.decode_attention(
            q[:, :1], {"k": pool(k), "v": pool(v), "block_table": table},
            lengths, layout=CacheLayout(kind="paged", impl="flash",
                                        block_size=4)),
        "flash_decode_attention_paged_quant":
            lambda q, k, v: tops.decode_attention(
            q[:, :1], {"k_q": pool(k), "k_s": pool(k).abs().amax(-1),
                       "v_q": pool(v), "v_s": pool(v).abs().amax(-1),
                       "block_table": table}, lengths,
            layout=CacheLayout(kind="paged", kv_bits=8, impl="flash",
                               block_size=4)),
    }


@pytest.mark.parametrize("name", list(_attention_calls()))
def test_attention_wrappers_refuse_autograd(name):
    """The repaired fault: the CUDA attention wrappers fill their outputs
    through raw pointers, so a training caller would get no gradient.
    Every wrapper raises when autograd would record it, on the CPU too;
    under no_grad (serving) it runs.  (The compression wrappers:
    ``test_torch_compress.py``.)"""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 32))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    call = _attention_calls()[name]
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
        call(q, k, v)
    with torch.no_grad():
        call(q, k, v)


def test_train_recsys_launcher_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_recsys", "--device",
         "cpu", "--steps", "2", "--scale", str(SCALE), "--grad-sync",
         "topk"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "HR@10" in out.stdout.splitlines()[-1], out.stdout

