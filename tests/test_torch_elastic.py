"""The port's elastic resharding (``runtime/elastic.py``) against the JAX
package's, on the CPU: four gloo ranks (subprocesses of this file, a
``FileStore``) beside JAX on four host devices (one subprocess with
``--xla_force_host_platform_device_count=4``), all started by the first
test that needs them, each with its own timeout, in this order:

* ``make_mesh_for(3, model=2)``: a 1 x 2 ``(data, model)`` mesh over ranks
  0 and 1 (JAX's devices 0 and 1); ranks 2 and 3 get ``None``;
* the array round trip: 8 x 8 over ``data`` 4, resharded onto the 2
  survivors of ``make_mesh_for(2)``: each survivor's block equal to JAX's
  shard on its device, the other two ranks get ``None``;
* live state: the hybrid step on ``test_torch_hybrid.py``'s ``recllm``
  case (reduced RecLLM-base, float32, ZeRO over ``data``) on a 2 x 2
  world for 2 steps, resharded (params and AdamW state) onto
  ``make_mesh_for(2, model=2)``, the batch cut by ``shrink_batch``, one
  more step; losses, gradient norms, params and ``m``/``v``/``master``
  within ``test_torch_hybrid.py``'s tolerance of JAX doing the same.  The
  ranks outside the new mesh exit after the reshard.

``shrink_batch`` is also held to JAX's in this process.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_hybrid import (N_USERS, _assert_same, _batches, _cfg, _flat,
                               _leaves, _nest, _np, _plan, _tcfg)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
CASE = "recllm"
STEPS_BEFORE = 2          # steps on the 2 x 2 world before the reshard


def _x():
    return np.arange(64, dtype=np.float32).reshape(8, 8)


@pytest.mark.parametrize("b,new_dp", [(8, 3), (8, 2), (5, 4), (3, 4)])
def test_shrink_batch_equals_jax(b, new_dp):
    from repro.runtime import elastic as jel
    from repro_torch.runtime import elastic as tel
    rng = np.random.default_rng(b)
    batch = {"tokens": rng.integers(0, 9, (b, 4)).astype(np.int32),
             "user": rng.integers(0, 9, b).astype(np.int32)}
    want = jel.shrink_batch(batch, new_dp, 4)
    got = tel.shrink_batch({k: torch.from_numpy(v) for k, v in
                            batch.items()}, new_dp, 4)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].shape[0] % new_dp == 0


# -- the two sides -----------------------------------------------------------

def run_jax(out_path, init_path):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import config
    from repro.core import hybrid, sharding
    from repro.models.transformer import ModelCtx
    from repro.optimizer import adamw
    from repro.recsys import model as jrec
    from repro.runtime import elastic, trainer
    out = {}
    mesh3 = elastic.make_mesh_for(3, model=2)
    out["mesh3|shape"] = np.asarray(mesh3.devices.shape)
    out["mesh3|ids"] = np.asarray([d.id for d in mesh3.devices.flat])

    devs = np.asarray(jax.devices()[:4]).reshape(4, 1)
    mesh4 = jax.sharding.Mesh(devs, ("data", "model"))
    xs = jax.device_put(_x(), NamedSharding(mesh4, P("data")))
    ys = elastic.reshard({"x": xs}, {"x": NamedSharding(
        elastic.make_mesh_for(2), P("data"))})
    out["roundtrip|devices"] = np.asarray(sorted(
        d.id for d in ys["x"].sharding.device_set))
    for s in ys["x"].addressable_shards:
        out[f"roundtrip|{s.device.id}"] = np.asarray(s.data)

    init = dict(np.load(init_path))
    cfg = _cfg(config, "recllm-base")
    ctx = ModelCtx(attn_chunk=8)

    def loss_fn(p, b):
        return jrec.recllm_loss(cfg, p, b, ctx)

    batches = [jax.tree.map(jax.numpy.asarray, b)
               for b in _batches(CASE, cfg.vocab_size)]
    mesh22 = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                               ("data", "model"))
    params = jax.tree.map(jax.numpy.asarray, _nest(init))
    opt = adamw.init_opt_state(params)
    losses, norms = [], []

    def run(mesh, params, opt, batches):
        plan = _plan(config, hybrid, sharding, cfg, mesh, CASE)
        _, jitted, shardings_for = trainer.make_hybrid_train_step(
            cfg, plan, _tcfg(config), loss_fn=loss_fn)
        shape = jax.eval_shape(lambda: params)
        psh, osh, _ = shardings_for(shape, batches[0])
        params, opt = elastic.reshard((params, opt), (psh, osh))
        fn = jitted(shape, batches[0])
        for b in batches:
            params, opt, m = fn(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return params, opt

    params, opt = run(mesh22, params, opt, batches[:STEPS_BEFORE])
    new = elastic.make_mesh_for(2, model=2)
    batch = elastic.shrink_batch(batches[STEPS_BEFORE], new.shape["data"],
                                 2)
    params, opt = run(new, params, opt, [batch])
    out["live|devices"] = np.asarray(sorted(
        d.id for d in jax.tree.leaves(params)[0].sharding.device_set))
    out["live|losses"] = np.asarray(losses)
    out["live|norms"] = np.asarray(norms)
    for part, tree in (("p", params), ("o", opt)):
        for k, v in _flat(jax.tree.map(np.asarray, tree)).items():
            out[f"live|{part}|{k}"] = v
    np.savez(out_path, **out)


def run_port(out_path, init_path, rank, store):
    from repro_torch import config, convert
    from repro_torch.core import hybrid, sharding
    from repro_torch.core.sharding import NamedSharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import ModelCtx
    from repro_torch.optimizer import adamw
    from repro_torch.recsys import model as trec
    from repro_torch.runtime import elastic, trainer
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    out = {}
    try:
        mesh3 = elastic.make_mesh_for(3, model=2)
        out["mesh3|none"] = np.asarray(mesh3 is None)
        if mesh3 is not None:
            out["mesh3|shape"] = np.asarray([mesh3.shape["data"],
                                             mesh3.shape["model"]])
            out["mesh3|coords"] = np.asarray([mesh3.coords["data"],
                                              mesh3.coords["model"]])

        mesh4 = make_host_mesh(data=4)
        old = {"x": NamedSharding(mesh4, ("data",))}
        blocks = {"x": old["x"].shard(torch.from_numpy(_x()))}
        mesh2 = elastic.make_mesh_for(2)
        new = None if mesh2 is None else {"x": NamedSharding(mesh2,
                                                             ("data",))}
        ys = elastic.reshard(blocks, new, old)
        out["roundtrip|none"] = np.asarray(ys is None)
        if ys is not None:
            out["roundtrip|x"] = ys["x"].numpy()

        init = dict(np.load(init_path))
        cfg = _cfg(config, "recllm-base")
        ctx = ModelCtx(attn_chunk=8)

        def loss_fn(p, b, c):
            return trec.recllm_loss(cfg, p, b, c)

        full = convert.params_from_numpy(_nest(init), device="cpu")
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in _batches(CASE, cfg.vocab_size)]
        mesh22 = make_host_mesh(data=2, model=2)
        plan = _plan(config, hybrid, sharding, cfg, mesh22, CASE)
        step, shardings_for = trainer.make_hybrid_train_step(
            cfg, plan, _tcfg(config), loss_fn, params_shape=full, ctx=ctx)
        psh, osh, _ = shardings_for(full, batches[0])
        params = sharding.device_put(full, psh)
        opt = sharding.device_put(adamw.init_opt_state(full), osh)
        losses, norms = [], []
        for b in batches[:STEPS_BEFORE]:
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))

        new = elastic.make_mesh_for(2, model=2)
        if new is None:
            # this rank left: it takes part in the reshard's gathers over
            # the old mesh, then in nothing of the new one
            got = [elastic.reshard(params, None, psh),
                   elastic.reshard(opt, None, osh)]
            out["live|none"] = np.asarray(got == [None, None])
            return
        plan2 = _plan(config, hybrid, sharding, cfg, new, CASE)
        step2, shardings_for2 = trainer.make_hybrid_train_step(
            cfg, plan2, _tcfg(config), loss_fn, params_shape=full, ctx=ctx)
        batch = elastic.shrink_batch(batches[STEPS_BEFORE],
                                     new.shape["data"], 2)
        psh2, osh2, _ = shardings_for2(full, batch)
        params = elastic.reshard(params, psh2, psh)
        opt = elastic.reshard(opt, osh2, osh)
        params, opt, m = step2(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        # every block is its slice of the full state on the new mesh
        fp, fo = sharding.gather(params, psh2), sharding.gather(opt, osh2)
        err = 0.0
        for loc, whole, sh in zip(*(_leaves(t) for t in (
                (params, opt), (fp, fo), (psh2, osh2)))):
            err = max(err, float((loc - sh.shard(whole)).abs().max()))
        out["live|none"] = np.asarray(False)
        out["live|err"] = np.asarray(err)
        out["live|losses"] = np.asarray(losses)
        out["live|norms"] = np.asarray(norms)
        for part, tree in (("p", fp), ("o", fo)):
            for k, v in _flat(_np(tree)).items():
                out[f"live|{part}|{k}"] = v
    finally:
        np.savez(out_path, **out)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic4")
    np.savez(tmp / "init.npz", **_init_recllm())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cmds = [["jax", str(tmp / "jax.npz"), str(tmp / "init.npz")]] + [
        ["torch", str(tmp / f"r{r}.npz"), str(tmp / "init.npz"), str(r),
         str(tmp / "store")] for r in range(4)]
    procs = [subprocess.Popen([sys.executable, __file__, *c], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        for p in procs:
            try:
                log = p.communicate(timeout=TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                pytest.fail(f"{p.args[2]} still running after {TIMEOUT_S} s")
            assert p.returncode == 0, log[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"r{r}.npz")) for r in range(4)])


def _init_recllm():
    """The ``recllm`` case's JAX init (``test_torch_hybrid._init``'s)."""
    import jax
    from repro import config
    from repro.recsys import model as jrec
    params = jrec.init_recllm(jax.random.PRNGKey(0),
                              _cfg(config, "recllm-base"), N_USERS)
    return _flat(jax.tree.map(np.asarray, params))


def test_mesh_for_three_survivors_is_1x2(world4):
    ref, ranks = world4
    assert list(ref["mesh3|shape"]) == [1, 2]
    assert list(ref["mesh3|ids"]) == [0, 1]
    for r, got in enumerate(ranks):
        assert bool(got["mesh3|none"]) == (r >= 2), r
        if r < 2:
            assert list(got["mesh3|shape"]) == [1, 2]
            assert list(got["mesh3|coords"]) == [0, r]


def test_roundtrip_onto_two_survivors(world4):
    ref, ranks = world4
    assert list(ref["roundtrip|devices"]) == [0, 1]
    for r, got in enumerate(ranks):
        assert bool(got["roundtrip|none"]) == (r >= 2), r
        if r < 2:
            np.testing.assert_array_equal(got["roundtrip|x"],
                                          ref[f"roundtrip|{r}"])
            np.testing.assert_array_equal(got["roundtrip|x"],
                                          _x()[4 * r:4 * r + 4])


def test_live_state_onto_two_survivors_matches_jax(world4):
    ref, ranks = world4
    assert list(ref["live|devices"]) == [0, 1]
    assert len(ref["live|losses"]) == STEPS_BEFORE + 1

    def entry(d):
        flat = {part: {k.split("|", 2)[2]: v for k, v in d.items()
                       if k.startswith(f"live|{part}|")} for part in "po"}
        return (list(d["live|losses"]), list(d["live|norms"]), flat["p"],
                flat["o"])

    want = entry(ref)
    for r, got in enumerate(ranks):
        assert bool(got["live|none"]) == (r >= 2), r
        if r < 2:
            assert float(got["live|err"]) == 0.0
            _assert_same({CASE: entry(got)}, {CASE: want})


if __name__ == "__main__":
    side, out, init, *rest = sys.argv[1:]
    if side == "jax":
        run_jax(out, init)
    else:
        run_port(out, init, int(rest[0]), rest[1])
