"""rwkv6 training through the port's hybrid step against JAX's
``make_hybrid_train_step`` (float32, reduced rwkv6-1.6b: 2 layers, d_model
64, 4 heads of 16, d_ff 96; params converted from the JAX init, batches
from a numpy seed, 3 steps of lr 1e-3, grad_clip 1.0).

* A world of one (gloo, in this process) against JAX's step on a 1 x 1
  mesh: seq 64 (two WKV chunks) in one micro-batch and seq 32 in two,
  remat off and on.  Held (:func:`assert_close`): losses within rtol
  1e-5, ``grad_norm`` within rtol 1e-5 at steps 1 and 2 and 5e-5 at step
  3 (``LATE_NORM_RTOL``), AdamW's m and v within rtol 1e-5, atol 1e-6,
  params and master within rtol 1e-5, atol 1e-5 (1% of one step); remat
  changes nothing.
* The blocks under ``TPHooks`` at tp 1 compute what the serving blocks
  compute, bit for bit.
* The launcher: ``--arch rwkv6-1.6b --reduced`` trains on the hybrid
  path, checkpoints and resumes to the losses of the run it continues;
  ``--pp-stages 2`` raises JAX's stage-slicing refusal.
* The refusals: rwkv6 heads that do not split over ``model``, and the
  mamba family under the hybrid step.

``tests/test_torch_rwkv_train_2x2.py`` holds the step on worlds of four.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_hybrid import _flat, _nest, _np
from test_torch_moe_train import RTOL, _batches, _leaves, _tcfg, assert_same

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "rwkv6-1.6b"
TIMEOUT_S = 240
# case -> (seq, micro-batches, plan kind, SP): "megatron" is make_plan with
# dp_heavy off and seq_shard as given, "dp_heavy" with it on
CASES1 = {"s64_m1": (64, 1, "megatron", False),
          "s32_m2": (32, 2, "megatron", False)}
# grad_norm at step 3: JAX's own step under two layouts of one computation
# (2 x 2 SP and dp_heavy, seq 32) parts there by 1.06e-5 relative (by
# 3e-7 at steps 1 and 2): the params after two clipped steps differ in
# float32 noise, which the reduced rwkv6's curvature (a gradient norm of
# ~375 at init) amplifies
LATE_NORM_RTOL = 5e-5


def _cfg(config_mod):
    return dataclasses.replace(config_mod.reduced(config_mod.get_arch(ARCH)),
                               dtype="float32")


def _plan(config_mod, hybrid, sharding, mesh, case):
    _, micro, kind, sp = case
    pcfg = config_mod.ParallelConfig(microbatches=micro)
    return hybrid.Plan(sharding=sharding.make_plan(
        mesh, pcfg, seq_shard=sp, dp_heavy=kind == "dp_heavy"), pcfg=pcfg,
        remat=False, grad_sync="auto")


def init():
    """JAX's init (PRNGKey(0)) of reduced rwkv6, flattened."""
    import jax
    from repro import config
    from repro.models import transformer as tf
    return _flat(jax.tree.map(np.asarray, tf.init_params(
        jax.random.PRNGKey(0), _cfg(config))))


def run_jax(mesh, flat, cases):
    """{case: (losses, grad_norms, flat params, flat opt)} from JAX's
    hybrid step."""
    import jax
    import jax.numpy as jnp
    from repro import config
    from repro.core import hybrid, sharding
    from repro.optimizer import adamw
    from repro.runtime import trainer
    cfg = _cfg(config)
    out = {}
    for name, case in cases.items():
        plan = _plan(config, hybrid, sharding, mesh, case)
        params = jax.tree.map(jnp.asarray, _nest(flat))
        opt = adamw.init_opt_state(params)
        batches = [jax.tree.map(jnp.asarray, b)
                   for b in _batches(case[0], cfg.vocab_size)]
        _, jitted, _ = trainer.make_hybrid_train_step(cfg, plan,
                                                      _tcfg(config))
        fn = jitted(jax.eval_shape(lambda: params), batches[0])
        losses, norms = [], []
        for b in batches:
            params, opt, m = fn(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = (losses, norms, _flat(params), _flat(opt))
    return out


def run_port(mesh, flat, cases, remat=None):
    """The same from the port on this rank, plus the largest difference
    between a local shard and its slice of the gathered full array."""
    from repro_torch import config, convert
    from repro_torch.core import hybrid, sharding
    from repro_torch.runtime import trainer
    cfg = _cfg(config)
    out = {}
    for name, case in cases.items():
        plan = _plan(config, hybrid, sharding, mesh, case)
        if remat is not None:
            plan = dataclasses.replace(plan, remat=remat)
        full = convert.params_from_numpy(_nest(flat), device="cpu")
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in _batches(case[0], cfg.vocab_size)]
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
        out[name] = (losses, norms, _flat(_np(fp)), _flat(_np(fo)), err)
    return out


def assert_close(port, ref, what=""):
    """``assert_same`` (losses, m, v, params and master), with the
    grad_norm of steps after the second within ``LATE_NORM_RTOL``."""
    assert_same((port[0], port[1][:2], *port[2:4]),
                (ref[0], ref[1][:2], *ref[2:4]), what)
    np.testing.assert_allclose(port[1][2:], ref[1][2:], rtol=LATE_NORM_RTOL,
                               err_msg=what)
    assert len(port[1]) == len(ref[1]) and RTOL < LATE_NORM_RTOL


# -- the world of one ---------------------------------------------------------

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    from repro_torch.launch.mesh import make_host_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("rwkv1") / "store"),
                           1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield make_host_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_world1():
    from repro import compat
    flat = init()
    return flat, run_jax(compat.make_mesh((1, 1), ("data", "model")), flat,
                         CASES1)


@pytest.mark.parametrize("case", list(CASES1))
def test_rwkv_hybrid_step_world_of_one_matches_jax(world1, jax_world1, case):
    """Remat off and on give the same losses and states, both JAX's."""
    flat, ref = jax_world1
    one = {case: CASES1[case]}
    off = run_port(world1, flat, one, remat=False)[case]
    on = run_port(world1, flat, one, remat=True)[case]
    assert on[0] == off[0], case
    for part in (2, 3):
        for k in on[part]:
            np.testing.assert_array_equal(on[part][k], off[part][k])
    assert off[4] == 0.0
    assert_close(off, ref[case], case)


def test_blocks_under_tp_of_one_are_the_serving_blocks(world1):
    """Under the hooks of a world of one the time and channel mixes give
    the serving blocks' outputs and gradients to the bit (the hooks are
    identities there: no collective, no copy)."""
    from repro_torch import config, convert
    from repro_torch.core import sharding
    from repro_torch.models import ssm, transformer
    cfg = _cfg(config)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    blk = transformer._layer(params["blocks"], 0)
    hooks = sharding.TPHooks(sharding.make_plan(world1,
                                                config.ParallelConfig()),
                             cfg, seq_len=32, rows=2)
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    for fn, p in ((ssm.rwkv6_forward, blk["tmix"]),
                  (ssm.rwkv_cmix_forward, blk["cmix"])):
        outs = []
        for tp in (None, hooks):
            leaves = {k: (v if isinstance(v, dict) else
                          v.detach().requires_grad_())
                      for k, v in p.items()}
            out, _ = fn(cfg, leaves, x, tp=tp)
            out.square().sum().backward()
            outs.append((out.detach(), {k: v.grad for k, v in leaves.items()
                                        if not isinstance(v, dict)}))
        assert torch.equal(outs[0][0], outs[1][0])
        for k in outs[0][1]:
            assert torch.equal(outs[0][1][k], outs[1][1][k]), k


# -- the launcher -------------------------------------------------------------

def _launch(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", ARCH, "--reduced", "--batch", "8", "--seq", "32", *argv],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith(f"{ARCH}: 0.1M params on mesh data=1 model=1 "
                               "stage=1; plan notes: ()")
    assert re.fullmatch(r"done: \d+ steps, host throughput \d+\.\d "
                        r"samples/s, final loss \d+\.\d{4}", lines[-1])
    return {int(k): float(v) for k, v in re.findall(
        r"^step (\d+): loss (\d+\.\d+)$", out.stdout, re.M)}


def test_launcher_trains_rwkv6_and_resumes(tmp_path):
    """12 steps (a checkpoint at step 10, as ``max(steps // 4, 10)``
    places it; the loss falls), then ``--resume``: it restores step 10 and
    runs steps 11 and 12 on the batches of seed 10, as JAX's launcher
    does.  Its step-11 loss is the restored params' loss on that batch."""
    from repro_torch import config, convert
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.data import pipeline
    from repro_torch.models import transformer as tf
    from repro_torch.optimizer import adamw
    ck = str(tmp_path / "ck")
    straight = _launch("--steps", "12", "--ckpt-dir", ck)
    assert sorted(straight) == list(range(1, 13))
    assert straight[12] < straight[1]
    assert ckpt.list_steps(ck) == [10]
    resumed = _launch("--steps", "12", "--ckpt-dir", ck, "--resume")
    assert sorted(resumed) == [11, 12]
    cfg = _cfg(config)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    state = ckpt.restore(ck, 10, {"params": params,
                                  "opt": adamw.init_opt_state(params)})
    batch = next(pipeline.synthetic_lm_batches(cfg.vocab_size, 8, 32, 2,
                                               seed=10))
    with torch.no_grad():
        loss, _ = tf.loss_fn(cfg, state["params"], {
            k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - resumed[11]) <= 5e-5, (float(loss), resumed)


def test_launcher_refuses_rwkv6_on_the_pipelined_path():
    """``--pp-stages 2`` raises JAX's own refusal, before any world."""
    import jax
    from repro import config as jconfig
    from repro.models import transformer as jtf
    from repro_torch.launch import train
    jcfg = _cfg(jconfig)
    with pytest.raises(NotImplementedError) as want:
        jtf.pp_partition_params(jcfg, jtf.init_params(
            jax.random.PRNGKey(0), jcfg), [0, 1, 2])
    with pytest.raises(NotImplementedError) as got:
        train.run(train.parse_args(["--device", "cpu", "--arch", ARCH,
                                    "--reduced", "--pp-stages", "2"]))
    assert str(got.value) == str(want.value)
    assert not dist.is_initialized() or dist.get_world_size() == 1


# -- refusals -----------------------------------------------------------------

def test_indivisible_rwkv_heads_and_mamba_are_refused():
    """rwkv6 heads that do not split over ``model`` and the mamba family
    under the hybrid step raise, naming ROADMAP.md."""
    from repro_torch import config
    from repro_torch.core import hybrid, sharding
    from repro_torch.core.hierarchical import DPMesh
    from repro_torch.runtime import trainer
    cfg = _cfg(config)
    for tp, ok in ((2, True), (4, True), (8, False)):
        mesh = DPMesh(shape={"data": 1, "model": tp},
                      coords={"data": 0, "model": 0}, groups={})
        plan = sharding.make_plan(mesh, config.ParallelConfig())
        if ok:
            assert sharding.TPHooks(plan, cfg, seq_len=16, rows=8).tp == tp
            continue
        with pytest.raises(NotImplementedError,
                           match="num_heads, the rwkv6 heads.*ROADMAP"):
            sharding.TPHooks(plan, cfg, seq_len=16, rows=8)
    mamba = dataclasses.replace(cfg, ssm_type="mamba")
    mesh = DPMesh(shape={"data": 1, "model": 1},
                  coords={"data": 0, "model": 0}, groups={})
    pcfg = config.ParallelConfig()
    plan = hybrid.Plan(sharding=sharding.make_plan(mesh, pcfg), pcfg=pcfg,
                       remat=False, grad_sync="auto")
    with pytest.raises(NotImplementedError, match="mamba.*ROADMAP"):
        trainer.make_hybrid_train_step(mamba, plan, _tcfg(config),
                                       params_shape={})
