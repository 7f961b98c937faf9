"""MoE training in the port against JAX (float32, reduced configs: 4
experts top 2; Qwen3 with 2 q and 2 kv heads, as JAX's hybrid check has
it; params converted from the JAX init, batches from a numpy seed).

* ``moe_ffn``'s output, aux and the gradients of a scalar of them (the
  router, every expert leaf, the input) against ``jax.grad`` of JAX's
  ``moe_ffn``, at capacity factor 1.25 (tokens dropped) and 64 (none):
  within rtol 1e-5, atol 1e-6 (outputs) and 1e-5 of the largest element
  (gradients).
* ``loss_fn``'s total, ``ce``, ``lb_loss``, ``z_loss``, ``expert_load``
  and every parameter's gradient on the whole reduced model: the same
  tolerances.
* The hybrid step on a world of one (gloo, in this process) against JAX's
  step on one device, 3 steps, micro-batches 1 and 2, remat off and on:
  losses and ``grad_norm`` within rtol 1e-5, AdamW's m and v after 3
  steps within rtol 1e-5, atol 1e-6, params and master within rtol 1e-5,
  atol 1e-5 (1% of one step of lr 1e-3); remat changes nothing.
* The specs of the full-size Qwen3-30B-A3B and Moonlight-16B-A3B at tp 1,
  2 and 4 (with 2 data ranks: the FSDP-expert rule) against JAX's, spec
  for spec, and ``auto_plan``'s choices and ``model_flops`` likewise.
* The refusals: experts that do not split over ``model``; MoE under the
  pipelined step.

``tests/test_torch_moe_train_2x2.py`` holds the step on a 2 x 2 world.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_hybrid import _flat, _nest, _np

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5          # of the largest element of the reference gradient
PARAM_ATOL = 1e-5        # params and master after 3 AdamW steps of lr 1e-3
STEPS, BATCH = 3, 8
ARCHS = {"qwen3": "qwen3-moe-30b-a3b", "moonlight": "moonshot-v1-16b-a3b"}
# case -> (arch, seq, micro-batches, FSDP experts forced on): the 2 x 2
# world's cases; at seq 32 auto_plan turns SP on over model 2, at 16 off
CASES = {
    "qwen3_sp": ("qwen3", 32, 2, False),
    "qwen3": ("qwen3", 16, 2, False),
    "moonlight_sp": ("moonlight", 32, 2, False),
    "moonlight": ("moonlight", 16, 2, False),
    "qwen3_fsdp": ("qwen3", 32, 2, True),
    "moonlight_fsdp": ("moonlight", 16, 2, True),
}
# the world of one's cases: micro-batches 1 and 2
CASES1 = {f"{a}_m{m}": (a, 32, m, False) for a in ARCHS for m in (1, 2)}


def _cfg(config_mod, arch):
    cfg = dataclasses.replace(config_mod.reduced(config_mod.get_arch(
        ARCHS[arch])), dtype="float32")
    if arch == "qwen3":
        cfg = dataclasses.replace(cfg, num_heads=2, num_kv_heads=2)
    return cfg


def _tcfg(config_mod):
    return config_mod.TrainConfig(steps=20, learning_rate=1e-3,
                                  warmup_steps=1, grad_clip=1.0,
                                  checkpoint_every=0)


def _plan(config_mod, hybrid, cfg, mesh, case, cases):
    _, seq, micro, _ = cases[case]
    return hybrid.auto_plan(cfg, mesh, config_mod.ShapeConfig(
        "t", seq, BATCH, "train"), config_mod.ParallelConfig(
            microbatches=micro))


def _batches(seq, vocab):
    """STEPS global batches; each row's mask keeps a different prefix."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        lens = rng.integers(seq // 4, seq + 1, BATCH)
        out.append({
            "tokens": rng.integers(3, vocab, (BATCH, seq)).astype(np.int32),
            "targets": rng.integers(3, vocab, (BATCH, seq)).astype(np.int32),
            "mask": (np.arange(seq)[None] < lens[:, None]).astype(
                np.float32)})
    return out


def init(cases):
    """Each arch's JAX init (PRNGKey(0)), flattened."""
    import jax
    from repro import config
    from repro.models import transformer as tf
    archs = sorted({cases[c][0] for c in cases})
    return {a: _flat(jax.tree.map(np.asarray, tf.init_params(
        jax.random.PRNGKey(0), _cfg(config, a)))) for a in archs}


def _jax_key(case, cases):
    """Cases that share JAX's run: the FSDP layout is the port's alone."""
    arch, seq, micro, _ = cases[case]
    return (arch, seq, micro)


def run_jax(mesh, inits, cases):
    """{case: (losses, grad_norms, flat params, flat opt)} from JAX's
    hybrid step (one run for the cases that differ only in the port's
    layout)."""
    import jax
    import jax.numpy as jnp
    from repro import config
    from repro.core import hybrid
    from repro.optimizer import adamw
    from repro.runtime import trainer
    done, out = {}, {}
    for case in cases:
        key = _jax_key(case, cases)
        if key not in done:
            arch, seq, _, _ = cases[case]
            cfg = _cfg(config, arch)
            plan = _plan(config, hybrid, cfg, mesh, case, cases)
            params = jax.tree.map(jnp.asarray, _nest(inits[arch]))
            opt = adamw.init_opt_state(params)
            batches = [jax.tree.map(jnp.asarray, b)
                       for b in _batches(seq, cfg.vocab_size)]
            _, jitted, _ = trainer.make_hybrid_train_step(cfg, plan,
                                                          _tcfg(config))
            fn = jitted(jax.eval_shape(lambda: params), batches[0])
            losses, norms = [], []
            for b in batches:
                params, opt, m = fn(params, opt, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            done[key] = (losses, norms, _flat(params), _flat(opt))
        out[case] = done[key]
    return out


def run_port(mesh, inits, cases, remat=None):
    """The same from the port on this rank (FSDP experts forced on where
    the case says), plus the largest difference between a local shard and
    its slice of the gathered full array, the last step's aux and whether
    the plan sharded the experts' d_ff over the dp axes."""
    from repro_torch import config, convert
    from repro_torch.core import hybrid, sharding
    from repro_torch.runtime import trainer
    out = {}
    for case in cases:
        arch, seq, _, fsdp = cases[case]
        cfg = _cfg(config, arch)
        saved = sharding.FSDP_EXPERT_BYTES
        if fsdp:
            sharding.FSDP_EXPERT_BYTES = 0.0
        try:
            plan = _plan(config, hybrid, cfg, mesh, case, cases)
            if remat is not None:
                plan = dataclasses.replace(plan, remat=remat)
            full = convert.params_from_numpy(_nest(inits[arch]),
                                             device="cpu")
            batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                       for b in _batches(seq, cfg.vocab_size)]
            step, shardings_for = trainer.make_hybrid_train_step(
                cfg, plan, _tcfg(config), params_shape=full)
            psh, osh, _ = shardings_for(full, batches[0])
            params = sharding.device_put(full, psh)
            opt = trainer.init_hybrid_opt(cfg, plan, params, full)
            losses, norms = [], []
            for b in batches:
                params, opt, m = step(params, opt, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            fp, fo = sharding.gather(params, psh), sharding.gather(opt, osh)
            err = 0.0
            for loc, whole, sh in zip(*(_leaves(t) for t in (
                    (params, opt), (fp, fo), (psh, osh)))):
                err = max(err, float((loc - sh.shard(whole)).abs().max()))
            spec = plan.sharding.param_specs(cfg, full)[
                "blocks"]["ffn"]["moe"]["wi_gate"]
            aux = {k: v.numpy().copy() for k, v in m["aux"].items()}
            out[case] = (losses, norms, _flat(_np(fp)), _flat(_np(fo)), err,
                         aux, spec[-1] is not None)
        finally:
            sharding.FSDP_EXPERT_BYTES = saved
    return out


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return tree_leaves(tree)


def assert_same(port, ref, what=""):
    """Losses and norms within RTOL; AdamW's m and v within RTOL, ATOL;
    params and master within RTOL, PARAM_ATOL (1% of one AdamW step of
    lr 1e-3: AdamW divides by sqrt(v), so an element whose gradient is
    near 0 turns float32 noise into a visible part of its step)."""
    pl, pn, pp, po = port[:4]
    jl, jn, jp, jo = ref[:4]
    np.testing.assert_allclose(pl, jl, rtol=RTOL, err_msg=what)
    np.testing.assert_allclose(pn, jn, rtol=RTOL, err_msg=what)
    for tree, jtree in ((pp, jp), (po, jo)):
        assert tree.keys() == jtree.keys(), what
        for k in tree:
            atol = ATOL if k.startswith(("m/", "v/")) else PARAM_ATOL
            np.testing.assert_allclose(tree[k], jtree[k], rtol=RTOL,
                                       atol=atol, err_msg=f"{what} {k}")


def _grads_close(got, want, what):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= GRAD_TOL * scale, (what, err, scale)


# -- (i) moe_ffn and its gradients --------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 64.0])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_ffn_grads_match_jax(arch, cf):
    """Output, aux and ``jax.grad`` of ``sum(out * r) + 0.01 lb + 1e-3 z``
    over the router, every expert leaf and the input.  A shared direction
    in every token makes some experts hot, so capacity factor 1.25 drops
    tokens (asserted) and 64 drops none."""
    import jax
    import jax.numpy as jnp
    from repro import config as jconfig
    from repro.models import moe as jmoe
    from repro_torch import config as tconfig, convert
    from repro_torch.kernels import ref
    from repro_torch.models import moe as tmoe
    jcfg, tcfg = _cfg(jconfig, arch), _cfg(tconfig, arch)
    B, S, group = 2, 64, 32
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, S, jcfg.d_model))
         + 2.0 * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)

    def jscalar(p, xx):
        out, aux = jmoe.moe_ffn(jcfg, p, xx, capacity_factor=cf,
                                group_size=group)
        s = jnp.sum(out * r) + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
        return s, (out, aux)

    (js, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jscalar, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_ffn(tcfg, tp, tx, capacity_factor=cf,
                            group_size=group)
    s = torch.sum(out * torch.from_numpy(r)) + 0.01 * aux["lb_loss"] \
        + 1e-3 * aux["z_loss"]
    s.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    for k in ("lb_loss", "z_loss", "expert_load"):
        np.testing.assert_allclose(aux[k].detach().numpy(),
                                   np.asarray(jaux[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(float(s.detach()), float(js), rtol=RTOL)
    for k in tp:
        _grads_close(tp[k].grad.numpy(), np.asarray(jgp[k]), k)
    _grads_close(tx.grad.numpy(), np.asarray(jgx), "x")
    # the drops are there at 1.25 and absent at 64
    with torch.no_grad():
        logits = tx.reshape(-1, group, tcfg.d_model) @ tp["router"]
        C = tmoe._capacity(group, tcfg.experts_per_token, tcfg.num_experts,
                           cf)
        route = ref.moe_dispatch(*tmoe.router_topk(
            logits, tcfg.experts_per_token), C)
        dropped = int((route.place >= C).sum())
    assert (dropped > 0) == (cf < 2), dropped


def test_router_gets_gradient_through_gates_and_probs():
    """With the aux weights at 0 the router's gradient comes through the
    kept gates in combine alone; with the output's weight at 0, through
    probs in the load-balance loss alone: both non-zero, and both JAX's."""
    import jax
    import jax.numpy as jnp
    from repro import config as jconfig
    from repro.models import moe as jmoe
    from repro_torch import config as tconfig, convert
    from repro_torch.models import moe as tmoe
    jcfg, tcfg = _cfg(jconfig, "qwen3"), _cfg(tconfig, "qwen3")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    jp = jmoe.init_moe(jax.random.PRNGKey(2), jcfg)
    for w_out, w_lb in ((1.0, 0.0), (0.0, 1.0)):
        def jscalar(p):
            out, aux = jmoe.moe_ffn(jcfg, p, jnp.asarray(x), group_size=16)
            return w_out * jnp.sum(out) + w_lb * aux["lb_loss"]
        jg = jax.grad(jscalar)(jp)["router"]
        tp = {k: v.requires_grad_() for k, v in convert.params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu").items()}
        out, aux = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x),
                                group_size=16)
        (w_out * out.sum() + w_lb * aux["lb_loss"]).backward()
        g = tp["router"].grad.numpy()
        assert np.abs(g).max() > 0, (w_out, w_lb)
        _grads_close(g, np.asarray(jg), f"router {w_out} {w_lb}")


# -- (ii) the whole reduced model's loss --------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_fn_and_grads_match_jax(arch):
    import jax
    import jax.numpy as jnp
    from repro import config as jconfig
    from repro.models import transformer as jtf
    from repro_torch import config as tconfig, convert
    from repro_torch.models import transformer as ttf
    jcfg, tcfg = _cfg(jconfig, arch), _cfg(tconfig, arch)
    batch = {k: v[:2] for k, v in _batches(32, jcfg.vocab_size)[0].items()}
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jctx = jtf.ModelCtx(moe_group=16, attn_chunk=8)

    def jloss(p):
        return jtf.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch), jctx)

    (jtotal, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    leaves = _leaves(tparams)
    for t in leaves:
        t.requires_grad_()
    total, aux = ttf.loss_fn(tcfg, tparams,
                             {k: torch.from_numpy(v) for k, v in
                              batch.items()},
                             ttf.ModelCtx(moe_group=16, attn_chunk=8))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=RTOL)
    for k in ("ce", "lb_loss", "z_loss", "expert_load"):
        np.testing.assert_allclose(aux[k].detach().numpy(),
                                   np.asarray(jaux[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert float(aux["lb_loss"].detach()) > 0 \
        and float(aux["z_loss"].detach()) > 0
    got = _flat(tree_grads(tparams))
    want = _flat(jax.tree.map(np.asarray, jg))
    assert got.keys() == want.keys()
    for k in want:
        _grads_close(got[k], want[k], k)


def tree_grads(tree):
    return {k: tree_grads(v) if isinstance(v, dict) else v.grad.numpy()
            for k, v in tree.items()}


# -- (iii) the hybrid step on a world of one ----------------------------------

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    from repro_torch.launch.mesh import make_host_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("moe1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield make_host_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_world1():
    from repro import compat
    inits = init(CASES1)
    return inits, run_jax(compat.make_mesh((1, 1), ("data", "model")),
                          inits, CASES1)


@pytest.mark.parametrize("case", list(CASES1))
def test_hybrid_step_world_of_one_matches_jax(world1, jax_world1, case):
    """Remat off and on give the same losses and states, both JAX's; the
    step's aux is the one micro-batch mean of the global values."""
    inits, ref = jax_world1
    one = {case: CASES1[case]}
    off = run_port(world1, inits, one, remat=False)[case]
    on = run_port(world1, inits, one, remat=True)[case]
    assert on[0] == off[0], case
    for part in (2, 3):
        for k in on[part]:
            np.testing.assert_array_equal(on[part][k], off[part][k])
    assert_same(off, ref[case], case)
    aux = off[5]
    assert set(aux) == {"ce", "lb_loss", "z_loss", "expert_load"}
    # every token's 2 slots in each of the 2 layers, a micro-batch's rows
    _, seq, micro, _ = CASES1[case]
    assert np.isclose(aux["expert_load"].sum(),
                      BATCH // micro * seq * 2 * 2), aux


# -- (vi) specs and the planner at full size ----------------------------------

@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_full_size_specs_match_jax(arch, tp):
    """param_specs and opt_specs at published shapes (JAX's eval_shape,
    no weights) on a (data 2, model tp) mesh: spec for spec; the FSDP
    rule is on exactly where the expert bytes a device pass the
    threshold."""
    from test_torch_sharding import _plans, _same, _shapes, _tuples
    from repro.config import get_arch as jarch
    from repro_torch.config import get_arch as tarch
    from repro_torch.core import sharding as tsh
    name = ARCHS[arch]
    jplan, tplan = _plans({"data": 2, "model": tp})
    params = _shapes(name)
    _same(_tuples(jplan.param_specs(jarch(name), params)),
          tplan.param_specs(tarch(name), params))
    _same(_tuples(jplan.opt_specs(jarch(name), params)),
          tplan.opt_specs(tarch(name), params))
    cfg = tarch(name)
    mats = 3 if cfg.mlp_gated else 2
    per_dev = (cfg.num_layers * cfg.num_experts * mats * cfg.d_model
               * cfg.d_ff * 2 / tp)
    assert tplan.fsdp_experts(cfg) == (per_dev > tsh.FSDP_EXPERT_BYTES)
    wo = tplan.param_specs(cfg, params)["blocks"]["ffn"]["moe"]["wo"]
    assert wo == ((None, "model", "data", None) if tplan.fsdp_experts(cfg)
                  else (None, "model", None, None))


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_auto_plan_and_flops_match_jax(arch, tp):
    """auto_plan turns dp_heavy off for MoE and counts active expert
    FLOPs, as JAX's does: the plan's choices and notes and
    ``model_flops`` equal JAX's."""
    from test_torch_sharding import _meshes, _plan_fields
    from repro import config as jconfig
    from repro.core import hybrid as jhy
    from repro_torch import config as tconfig
    from repro_torch.core import hybrid as thy
    name = ARCHS[arch]
    jm, tm = _meshes({"data": 2, "model": tp})
    for shape in ("train_4k", "prefill_32k"):
        jp = jhy.auto_plan(jconfig.get_arch(name), jm, jconfig.SHAPES[shape])
        tp_ = thy.auto_plan(tconfig.get_arch(name), tm, tconfig.SHAPES[shape])
        assert _plan_fields(tp_) == _plan_fields(jp), (shape, tp_.notes)
        assert not tp_.sharding.dp_heavy
    for seq in (512, 4096):
        assert thy.model_flops(tconfig.get_arch(name), seq, 8) == \
            jhy.model_flops(jconfig.get_arch(name), seq, 8)


# -- refusals -----------------------------------------------------------------

def test_experts_that_do_not_split_over_model_are_refused():
    """JAX's guard replicates experts that do not divide over ``model``;
    the port refuses them, naming ROADMAP.md."""
    from repro_torch import config
    from repro_torch.core import sharding
    from repro_torch.core.hierarchical import DPMesh
    cfg = dataclasses.replace(_cfg(config, "moonlight"), num_experts=6)
    mesh = DPMesh(shape={"data": 1, "model": 4},
                  coords={"data": 0, "model": 0}, groups={})
    plan = sharding.make_plan(mesh, config.ParallelConfig())
    with pytest.raises(NotImplementedError, match="num_experts.*ROADMAP"):
        sharding.TPHooks(plan, cfg, seq_len=16, rows=8)
    ok = dataclasses.replace(cfg, num_experts=8)
    hooks = sharding.TPHooks(plan, ok, seq_len=16, rows=8)
    assert hooks.experts == (0, 2)


def test_pipelined_step_keeps_refusing_moe():
    from repro_torch import config, convert
    from repro_torch.models import transformer as tf
    cfg = _cfg(config, "qwen3")
    params = convert.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    with pytest.raises(NotImplementedError, match="MoE aux"):
        tf.pp_partition_params(cfg, params, [0, 1, 2])
