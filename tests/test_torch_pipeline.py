"""The port's pipeline pieces that run in one process against JAX's
(float32, reduced configs):

* the host side, equal to JAX's exactly: ``schedule_tables`` (fwd, bwd,
  depth) and ``schedule_cost`` for S in 1..4, M in 1..8 under both
  schedules; ``microbatch``/``pad_batch``; ``load_balance``'s functions;
  ``stage_tick_times``, ``rebalance_from_trace`` and
  ``synthesize_pipeline_ticks``; ``pp_stage_specs`` and
  ``pp_residual_size``; ``modeled_parallel_step`` with JAX's module
  constants set to the H100's;
* the stage functions: slice/unstack/remap/partition/merge round trips,
  and ``make_stage_fn``/``make_last_fn`` with their gradients on uneven
  bounds ``[0, 2, 5]`` of 5 layers (a pad slot runs);
* a world of one (an in-process gloo group): the executor under both
  schedules, ``gpipe_value_and_grad`` and ``make_pipeline_loss`` against
  JAX's on one device, and the one-stage pipelined train step against
  JAX's ``make_pp_train_step`` and against the port's own hybrid step on
  the same batches (the check ``chip_smoke.py`` makes on the card).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

RTOL, ATOL = 1e-5, 1e-6
ACT_ATOL = 1e-5     # O(1) activations after a few float32 layers
GRAD_ATOL = 2e-4    # JAX's own stage-gradient tolerance (distributed_checks)


def _cfg(config_mod, arch="olmo-1b", layers=5):
    return dataclasses.replace(config_mod.reduced(config_mod.get_arch(arch)),
                               num_layers=layers, dtype="float32")


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _assert_trees(got, want, rtol=RTOL, atol=ATOL, what=""):
    got, want = _tree_np(got), _tree_np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got), set(want))
        for k in want:
            _assert_trees(got[k], want[k], rtol, atol, f"{what}/{k}")
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# -- the host side -------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("sched", ["1f1b", "gpipe"])
def test_schedule_tables_and_cost_match_jax(sched, S):
    from repro.core import pipeline as jp
    from repro_torch.core import pipeline as tp
    for M in range(1, 9):
        jf, jb, jd = jp.schedule_tables(sched, S, M)
        tf_, tb, td = tp.schedule_tables(sched, S, M)
        assert td == jd and tf_.dtype == jf.dtype
        np.testing.assert_array_equal(tf_, jf)
        np.testing.assert_array_equal(tb, jb)
        assert tp.schedule_cost(sched, S, M) == jp.schedule_cost(sched, S, M)
        assert tp.schedule_cost(sched, S, M, 1.5, 2.5) == jp.schedule_cost(
            sched, S, M, 1.5, 2.5)
    with pytest.raises(ValueError):
        tp.schedule_tables("zb", S, 2)


def test_microbatch_and_pad_batch_match_jax():
    import jax.numpy as jnp
    from repro.core import pipeline as jp
    from repro_torch.core import pipeline as tp
    x = np.arange(6 * 3 * 2, dtype=np.float32).reshape(6, 3, 2)
    for n, pad in ((2, False), (3, False), (4, True), (5, True)):
        np.testing.assert_array_equal(
            tp.microbatch(_t(x), n, pad=pad).numpy(),
            np.asarray(jp.microbatch(jnp.asarray(x), n, pad=pad)))
        np.testing.assert_array_equal(tp.pad_batch(_t(x), n).numpy(),
                                      np.asarray(jp.pad_batch(
                                          jnp.asarray(x), n)))
    with pytest.raises(ValueError, match="pad=True"):
        tp.microbatch(_t(x), 4)


@pytest.mark.parametrize("seed", range(4))
def test_load_balance_matches_jax(seed):
    from repro.core import load_balance as jlb
    from repro_torch.core import load_balance as tlb
    rng = np.random.default_rng(seed)
    L = int(rng.integers(4, 13))
    costs = rng.uniform(0.5, 3.0, L)
    for S in range(1, min(L, 5) + 1):
        b = tlb.balance_stages(costs, S)
        assert b == jlb.balance_stages(costs, S)
        np.testing.assert_array_equal(tlb.stage_costs(costs, b),
                                      jlb.stage_costs(costs, b))
        times = rng.uniform(0.1, 2.0, S)
        np.testing.assert_array_equal(
            tlb.layer_costs_from_stage_times(times, b),
            jlb.layer_costs_from_stage_times(times, b))
        assert tlb.rebalance_stages(times, b) == \
            jlb.rebalance_stages(times, b)
    load = rng.uniform(0, 10, 8)
    ta, tperm = tlb.rebalance_experts(load, 4)
    ja, jperm = jlb.rebalance_experts(load, 4)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tperm, jperm)
    assert tlb.balance_quality(load, ta, 4) == jlb.balance_quality(load, ja,
                                                                    4)
    speeds = rng.uniform(0.5, 2.0, 5)
    np.testing.assert_array_equal(tlb.adaptive_batch_allocation(speeds, 37),
                                  jlb.adaptive_batch_allocation(speeds, 37))
    order = rng.permutation(5)
    np.testing.assert_array_equal(tlb.straggler_dropk_weights(order, 2),
                                  jlb.straggler_dropk_weights(order, 2))


def test_rebalance_moe_params_on_tensors_and_arrays():
    from repro_torch.core import load_balance as tlb
    rng = np.random.default_rng(0)
    layer = {"router": rng.standard_normal((3, 8, 4)),
             "wi_gate": rng.standard_normal((3, 4, 8, 5)),
             "wo": rng.standard_normal((3, 4, 5, 8))}
    perm = np.array([2, 0, 3, 1])
    a = tlb.rebalance_moe_params(layer, perm)
    b = tlb.rebalance_moe_params({k: _t(v) for k, v in layer.items()}, perm)
    for k in layer:
        np.testing.assert_array_equal(b[k].numpy(), a[k])
    np.testing.assert_array_equal(a["router"], layer["router"][..., perm])
    np.testing.assert_array_equal(a["wo"], layer["wo"][:, perm])


def _ticks(tracer_mod, S, rng):
    tr = tracer_mod.Tracer()
    for s in range(S):
        for it in range(3):
            t0 = float(rng.uniform(0, 5))
            tr.complete("stage_tick", t0, t0 + float(rng.uniform(0.1, 2)),
                        track=f"stage{s}", stage=s, phase="fwd", iter=it)
    tr.complete("other", 0.0, 9.0, stage=0)
    return tr.events


def test_stage_ticks_and_trace_rebalance_match_jax():
    from repro.core import load_balance as jlb
    from repro.obs import timeline as jtl
    from repro.obs import trace as jtrace
    from repro_torch.core import load_balance as tlb
    from repro_torch.obs import timeline as ttl
    from repro_torch.obs import trace as ttrace
    for S, bounds in ((2, [0, 1, 6]), (3, [0, 2, 3, 7])):
        ev = _ticks(ttrace, S, np.random.default_rng(S))
        jev = _ticks(jtrace, S, np.random.default_rng(S))
        assert ev == jev
        assert ttl.stage_tick_times(ev, S) == jtl.stage_tick_times(jev, S)
        assert ttl.stage_tick_times(ev) == jtl.stage_tick_times(jev)
        assert tlb.rebalance_from_trace(ev, bounds) == \
            jlb.rebalance_from_trace(jev, bounds)


@pytest.mark.parametrize("sched", ["1f1b", "gpipe"])
def test_synthesize_pipeline_ticks_matches_jax(sched):
    from repro.obs import timeline as jtl
    from repro.obs import trace as jtrace
    from repro_torch.obs import timeline as ttl
    from repro_torch.obs import trace as ttrace
    tt, jt = ttrace.Tracer(), jtrace.Tracer()
    end = ttl.synthesize_pipeline_ticks(tt, sched, 3, 5, [1.0, 2.5, 0.5],
                                        t0=1.0)
    assert end == jtl.synthesize_pipeline_ticks(jt, sched, 3, 5,
                                                [1.0, 2.5, 0.5], t0=1.0)
    assert tt.events == jt.events and len(tt.events) == 2 * 3 * 5


def test_pp_stage_specs_and_residual_size_match_jax():
    """Specs at full width (JAX's ``eval_shape``) on (data, model, stage)
    meshes, GQA-replicated kv included, and the residual's local size."""
    import dataclasses as dc
    import jax
    from repro import config as jconfig
    from repro.core import sharding as jsh
    from repro.models import transformer as jtf
    from repro.runtime import trainer as jtr
    from repro_torch import config as tconfig
    from repro_torch.core import sharding as tsh
    from repro_torch.core.hierarchical import DPMesh
    from repro_torch.runtime import trainer as ttr

    @dc.dataclass(frozen=True)
    class JMesh:
        shape: dict
        axis_names: tuple

    def norm(spec):
        return tuple(spec)

    for arch, shape in (("olmo-1b", (2, 2, 2)), ("internlm2-20b", (1, 4, 2)),
                        ("deepseek-7b", (1, 1, 4))):
        axes = ("data", "model", "stage")
        sh = dict(zip(axes, shape))
        jm = JMesh(sh, axes)
        tm = DPMesh(shape=sh, coords={a: 0 for a in axes}, groups={})
        cfg = jconfig.get_arch(arch)
        L = cfg.num_layers
        bounds = [round(i * L / shape[2]) for i in range(shape[2] + 1)]
        pp = jax.eval_shape(lambda: jtf.pp_partition_params(
            cfg, jtf.init_params(jax.random.PRNGKey(0), cfg), bounds))
        js = jsh.pp_stage_specs(cfg, pp["stage"], jm)
        ts = tsh.pp_stage_specs(tconfig.get_arch(arch), pp["stage"], tm)
        flat_j = jax.tree_util.tree_flatten_with_path(
            js, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for path, spec in flat_j[0]:
            node = ts
            for k in path:
                node = node[k.key]
            assert tsh.P(*node) == tsh.P(*norm(spec)), (arch, path)
        for mode in ("onebit", "topk"):
            j = jtr.pp_residual_size(cfg, pp, jm,
                                     jtr.DPSyncConfig(mode=mode))
            t = ttr.pp_residual_size(tconfig.get_arch(arch), pp, tm,
                                     ttr.DPSyncConfig(mode=mode))
            assert t == j, (arch, mode)


def test_modeled_parallel_step_matches_jax_on_h100_constants(monkeypatch):
    from repro import config as jconfig
    from repro.core import hybrid as jhy
    from repro_torch import config as tconfig
    from repro_torch.core import hybrid as thy
    monkeypatch.setattr(jhy, "PEAK_FLOPS_BF16", tconfig.H100_PEAK_FLOPS_BF16)
    monkeypatch.setattr(jhy, "ICI_BW_PER_LINK", tconfig.H100_NVLINK_BW)
    monkeypatch.setattr(jhy, "HBM_BYTES_PER_CHIP", tconfig.H100_HBM_BYTES)
    for arch in ("olmo-1b", "internlm2-20b"):
        for dp, tp, pp, sched in ((1, 1, 1, "1f1b"), (8, 1, 1, "1f1b"),
                                  (2, 2, 2, "1f1b"), (1, 4, 4, "gpipe"),
                                  (2, 8, 4, "1f1b")):
            kw = dict(dp=dp, tp=tp, pp=pp, n_micro=8, schedule=sched)
            assert thy.modeled_parallel_step(
                tconfig.get_arch(arch), tconfig.SHAPES["train_4k"], **kw) \
                == jhy.modeled_parallel_step(
                    jconfig.get_arch(arch), jconfig.SHAPES["train_4k"], **kw)


# -- the stage functions ---------------------------------------------------------

def _init(arch="olmo-1b", layers=5):
    import jax
    from repro import config
    from repro.models import transformer as jtf
    cfg = _cfg(config, arch, layers)
    return cfg, jax.tree.map(np.asarray, jtf.init_params(
        jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-7b"])
def test_stage_param_round_trips_match_jax(arch):
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jtf
    from repro_torch import config, convert
    from repro_torch.models import transformer as ttf
    _, params = _init(arch)
    cfg = _cfg(config, arch)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = convert.params_from_numpy(params, device="cpu")
    for bounds in ([0, 5], [0, 2, 5], [0, 1, 2, 5]):
        jpp = jtf.pp_partition_params(cfg, jparams, bounds)
        tpp = ttf.pp_partition_params(cfg, tparams, bounds)
        _assert_trees(tpp, jpp, 0, 0, f"partition {bounds}")
        _assert_trees(ttf.pp_merge_params(cfg, tpp, bounds), params, 0, 0,
                      "merge")
        for new in ([0, 3, 5], [0, 4, 5]):
            if len(new) != len(bounds):
                continue
            _assert_trees(ttf.remap_stage_params(tpp["stage"], bounds, new),
                          jtf.remap_stage_params(jpp["stage"], bounds, new),
                          0, 0, f"remap {bounds} -> {new}")
        _assert_trees(ttf.unstack_stage_params(tpp["stage"], bounds),
                      params["blocks"], 0, 0, "unstack")
    with pytest.raises(ValueError, match="empty stage"):
        ttf.stage_slice_params(cfg, tparams["blocks"], [0, 0, 5])


def test_stage_and_last_fn_match_jax():
    """Each stage of ``[0, 2, 5]`` (stage 0 pads a slot) and the head,
    outputs and gradients against ``jax.vjp``."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jtf
    from repro_torch import config, convert
    from repro_torch.models import transformer as ttf
    from repro_torch.tree import tree_leaves, tree_map
    _, params = _init()
    cfg = _cfg(config)
    bounds = [0, 2, 5]
    jpp = jtf.pp_partition_params(cfg, jax.tree.map(jnp.asarray, params),
                                  bounds)
    tpp = ttf.pp_partition_params(
        cfg, convert.params_from_numpy(params, device="cpu"), bounds)
    jctx, tctx = jtf.ModelCtx(attn_chunk=8), ttf.ModelCtx(attn_chunk=8)
    jstage, tstage = jtf.make_stage_fn(cfg, jctx), ttf.make_stage_fn(cfg,
                                                                     tctx)
    jlast, tlast = jtf.make_last_fn(cfg, jctx), ttf.make_last_fn(cfg, tctx)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    tgt = rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)
    mask = (rng.uniform(size=(2, 16)) < 0.8).astype(np.float32)
    for s in range(2):
        jp = jax.tree.map(lambda a, s=s: a[s], jpp["stage"])
        tp = tree_map(lambda a, s=s: a[s].clone().requires_grad_(),
                      tpp["stage"]["blocks"])
        tp = {"blocks": tp, "mask": tpp["stage"]["mask"][s]}
        jy, vjp = jax.vjp(jstage, jp, jnp.asarray(x))
        tx = _t(x).requires_grad_()
        ty = tstage(tp, tx)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   rtol=RTOL, atol=ACT_ATOL)
        jg, jgx = vjp(jnp.asarray(ct))
        leaves = tree_leaves(tp["blocks"])
        got = torch.autograd.grad(ty, leaves + [tx], _t(ct))
        for a, b in zip(got[:-1], jax.tree.leaves(jg["blocks"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=GRAD_ATOL)
        np.testing.assert_allclose(got[-1].numpy(), np.asarray(jgx),
                                   rtol=1e-4, atol=GRAD_ATOL)
    jl = jlast(jpp["last"], jnp.asarray(x), jnp.asarray(tgt),
               jnp.asarray(mask))
    tl = tlast(tpp["last"], _t(x), _t(tgt), _t(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)


# -- the world of one -----------------------------------------------------------

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("pp1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _micro(cfg, M=4, B=6, S=16, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = rng.integers(4, S + 1, B)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.float32)
    return h, tgt, mask


def test_executor_and_gpipe_match_jax_on_one_stage(world1):
    """The executor (both schedules), the autograd GPipe oracle and the
    pipelined loss against JAX's on one device: loss, stage, head and
    input gradients."""
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.core import pipeline as jpl
    from repro.models import transformer as jtf
    from repro_torch import config, convert
    from repro_torch.core import pipeline as tpl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as ttf
    _, params = _init(layers=3)
    cfg = _cfg(config, layers=3)
    bounds, M = [0, 3], 4
    jpp = jtf.pp_partition_params(cfg, jax.tree.map(jnp.asarray, params),
                                  bounds)
    tpp = ttf.pp_partition_params(
        cfg, convert.params_from_numpy(params, device="cpu"), bounds)
    ctx_j, ctx_t = jtf.ModelCtx(attn_chunk=8), ttf.ModelCtx(attn_chunk=8)
    jstage, jlast = jtf.make_stage_fn(cfg, ctx_j), jtf.make_last_fn(cfg,
                                                                    ctx_j)
    tstage, tlast = ttf.make_stage_fn(cfg, ctx_t), ttf.make_last_fn(cfg,
                                                                     ctx_t)
    h, tgt, mask = _micro(cfg)
    jm = compat.make_mesh((1,), ("stage",))
    tm = make_host_mesh(stage=1)
    args = [tpl.microbatch(_t(a), M, pad=True) for a in (h, tgt, mask)]
    jargs = [jnp.asarray(a.numpy()) for a in args]
    jl, (jgs, jgl, jgx) = jax.jit(jpl.gpipe_value_and_grad(
        jstage, jlast, jm, 1, M))(jpp["stage"], jpp["last"], *jargs)
    for sched in ("1f1b", "gpipe"):
        tl, (tgs, tgl, tgx) = tpl.make_pipeline_value_and_grad(
            tstage, tlast, tm, 1, M, schedule=sched)(
            tpp["stage"], tpp["last"], *args)
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
        _assert_trees(tgs["blocks"], jgs["blocks"], 1e-4, 1e-6, sched)
        _assert_trees(tgl, jgl, 1e-4, 1e-6, sched)
        np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-4,
                                   atol=1e-6)
        assert not tgs["mask"].any()
    al, (ags, agl, agx) = tpl.gpipe_value_and_grad(tstage, tlast, tm, 1, M)(
        tpp["stage"], tpp["last"], *args)
    np.testing.assert_allclose(float(al), float(jl), rtol=RTOL)
    _assert_trees(ags["blocks"], jgs["blocks"], 1e-4, 1e-6, "autograd")
    _assert_trees(agl, jgl, 1e-4, 1e-6, "autograd")
    np.testing.assert_allclose(agx.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6)
    y = tpl.gpipe(tstage, tm, 1, M)(tpp["stage"], args[0])
    jy = jax.jit(jpl.gpipe(jstage, jm, 1, M))(jpp["stage"], jargs[0])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ACT_ATOL)

    def jlast3(lp, yy, tt):
        return jlast(lp, yy, tt, jnp.ones(tt.shape)) / tt.size

    def tlast3(lp, yy, tt):
        return tlast(lp, yy, tt, torch.ones(tt.shape)) / tt.numel()
    jloss = jpl.make_pipeline_loss(jstage, jlast3, jm, 1, M)(
        jpp["stage"], jpp["last"], jargs[0], jargs[1])
    tloss = tpl.make_pipeline_loss(tstage, tlast3, tm, 1, M)(
        tpp["stage"], tpp["last"], args[0], args[1])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)


@pytest.mark.parametrize("sched", ["1f1b", "gpipe"])
def test_one_stage_pp_step_matches_jax_and_the_hybrid_step(world1, sched):
    """The pipelined step at ``stage`` 1 (what a one-card world runs)
    against JAX's on a one-device mesh, 3 steps with grad_clip 1.0 and a
    remainder batch; and against the port's hybrid step on the same
    batches within rtol 2e-4, atol 1e-5 (JAX's own pipelined-vs-DP
    tolerance, ``tests/distributed_checks.py``)."""
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro import config as jconfig
    from repro.models import transformer as jtf
    from repro.optimizer import adamw as jadamw
    from repro.runtime import trainer as jtr
    from repro_torch import config, convert
    from repro_torch.core import hybrid, sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as ttf
    from repro_torch.optimizer import adamw
    from repro_torch.runtime import trainer as ttr
    _, params = _init(layers=3)
    cfg = _cfg(config, layers=3)
    bounds, M = [0, 3], 4
    tcfg = dict(steps=20, learning_rate=1e-3, warmup_steps=1, grad_clip=1.0,
                checkpoint_every=0)
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(3, cfg.vocab_size, (6, 16)).astype(
        np.int32), "targets": rng.integers(3, cfg.vocab_size, (6, 16)).astype(
        np.int32)} for _ in range(3)]
    # JAX
    jm = compat.make_mesh((1, 1, 1), ("data", "model", "stage"))
    jpp = jtf.pp_partition_params(cfg, jax.tree.map(jnp.asarray, params),
                                  bounds)
    jshape = jax.eval_shape(lambda: jpp)
    scfg = jtr.DPSyncConfig()
    jstate = [jpp, jadamw.init_opt_state(jtr.pp_trainable(jpp, True)),
              jnp.zeros((1, 1, 1, jtr.pp_residual_size(cfg, jshape, jm,
                                                       scfg)))]
    jstep = jtr.make_pp_train_step(cfg, jm, jconfig.TrainConfig(**tcfg),
                                   bounds, jshape, n_micro=M,
                                   pp_schedule=sched)
    jl = []
    for b in batches:
        *jstate, loss = jstep(*jstate, jax.tree.map(jnp.asarray, b))
        jl.append(float(loss))
    # the port, pipelined
    tm = make_host_mesh(stage=1)
    full = convert.params_from_numpy(params, device="cpu")
    tpp = ttf.pp_partition_params(cfg, full, bounds)
    state = {"params": tpp, "opt": adamw.init_opt_state(
        ttr.pp_trainable(tpp, True)), "residual": torch.zeros(1, 1, 1, 0)}
    step = ttr.make_pp_train_step(cfg, tm, config.TrainConfig(**tcfg),
                                  bounds, tpp, n_micro=M, pp_schedule=sched)
    tb = [{k: _t(v) for k, v in b.items()} for b in batches]
    tl = ttr.train_loop(state, iter(tb), step,
                        config.TrainConfig(**tcfg)).losses
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    _assert_trees(state["params"], jstate[0], RTOL, ATOL, "params")
    _assert_trees({k: v for k, v in state["opt"].items() if k != "step"},
                  {k: v for k, v in jstate[1].items() if k != "step"},
                  RTOL, ATOL, "opt")
    # the port's hybrid step on the same batches (its micro-batches need
    # a divisor: 6 rows in 2)
    hm = make_host_mesh()
    plan = hybrid.auto_plan(cfg, hm, config.ShapeConfig("t", 16, 6, "train"),
                            config.ParallelConfig(microbatches=2))
    hfull = convert.params_from_numpy(params, device="cpu")
    hstep, shardings_for = ttr.make_hybrid_train_step(
        cfg, plan, config.TrainConfig(**tcfg), params_shape=hfull,
        ctx=ttf.ModelCtx(attn_chunk=8))
    psh, _, _ = shardings_for(hfull, tb[0])
    hp = sharding.device_put(hfull, psh)
    hstate = {"params": hp, "opt": ttr.init_hybrid_opt(cfg, plan, hp,
                                                       hfull)}
    hl = ttr.train_loop(hstate, iter(tb), hstep,
                        config.TrainConfig(**tcfg)).losses
    np.testing.assert_allclose(tl, hl, rtol=2e-4, atol=1e-5)


def test_train_launcher_takes_jax_pipelined_flags():
    from repro_torch.launch import train
    a = train.parse_args(["--device", "cpu"])
    assert (a.pp_stages, a.pp_micro, a.pp_schedule, a.pp_rebalance_every,
            a.grad_sync) == (1, 4, "1f1b", 0, "flat")
    a = train.parse_args(["--pp-stages", "4", "--pp-schedule", "gpipe",
                          "--pp-rebalance-every", "5", "--grad-sync", "topk"])
    assert (a.pp_stages, a.pp_schedule, a.pp_rebalance_every,
            a.grad_sync) == (4, "gpipe", 5, "topk")
    for bad in (["--pp-schedule", "zb"], ["--grad-sync", "sparse"]):
        with pytest.raises(SystemExit):
            train.parse_args(bad)
