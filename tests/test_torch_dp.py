"""The port's data-parallel train step against JAX's ``make_dp_train_step``
on reduced RecLLM-base (2 layers, float32, dataset scale 0.005).

* World of one: an in-process gloo group (a ``FileStore`` under the test's
  temporary directory, set up once for the module) against JAX on a
  one-device ``data`` mesh, every sync mode and every case of
  ``EMBED_CASES`` (cf_user synced rows-touched under flat and top-k sync,
  with ``zero_opt``, and the fused AdamW switch), 3 steps.
* World of two: two gloo ranks in subprocesses against JAX on a two-device
  ``data`` mesh (a subprocess with
  ``--xla_force_host_platform_device_count=2``), hierarchical, onebit and
  topk, and the embed cases flat, top-k and ``zero_opt`` (962 users
  split over two ranks), 2 steps.
* Two pods of two: four gloo ranks laid out ``(pod, data)`` against JAX on
  a 2x2 ``("pod", "data")`` mesh, the same modes with ``inter_axis="pod"``
  (hierarchical: reduce-scatter in the pod, all-reduce across pods,
  all-gather in the pod; onebit/topk: the compressed sync in the pod, then
  a mean across pods), and the embed cases flat and top-k (the rows
  gathered over ``data``, then ``pod``), 2 steps.

Every subprocess has its own timeout, so a hung rendezvous fails the test;
the store is a file, so no port is shared between test workers.

The same JAX init (converted) and numpy batches feed both packages; the
global batch is split on dim 0 in the mesh's device order.  Tolerances:
losses 1e-5 and params and residuals 1e-5 absolute per step (the packages
sum in other orders; observed differences are ~1e-7).  1-bit is exact in
its bits except for elements within float noise of zero, whose sign can
flip between the packages: :func:`test_onebit_sync_bits_match_jax` holds
the bits where ``|x| > 1e-6 max|x|``, and a flipped sign in the
trajectories would move one weight by ~2 lr and fail their tolerance
(none flips on these inputs).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCALE = 0.005
BATCH, SEQ, LR = 8, 16, 1e-2
MODES = ("flat", "hierarchical", "onebit", "topk")
WORLDN_MODES = ("hierarchical", "onebit", "topk")   # worlds of 2 and 4
# The step under embed_sync (cf_user synced rows-touched) and the fused
# AdamW switch: case -> its settings.  "embed" holds the EmbedSyncConfig
# options beyond id_fns, "jax_embed" the JAX side's where they differ,
# "clip" the grad_clip (default 1.0).  JAX's zero_opt clip sums the
# top-level values of the grads and cannot take RecLLM's nested "lm"
# (AttributeError): its zero_opt runs without clipping, and the port's
# zero_opt with clipping is held to JAX's replicated optimizer.
EMBED_CASES = {
    "embed_flat": dict(mode="flat", embed={}),
    "embed_flat_plain": dict(mode="flat", embed={"use_kernel": False}),
    "embed_topk": dict(mode="topk", embed={"compress": "topk", "k": 8}),
    "embed_zero": dict(mode="flat", embed={"zero_opt": True}, clip=0.0),
    "embed_zero_clip": dict(mode="flat", embed={"zero_opt": True},
                            jax_embed={}),
    "adamw_kernel": dict(mode="flat", adamw_kernel=True),
}
# cases per (pods, data) world; zero_opt needs the 962 users to divide
# over the ranks, which 4 does not
WORLD_CASES = {
    (1, 2): WORLDN_MODES + ("embed_flat", "embed_topk", "embed_zero",
                            "embed_zero_clip"),
    (2, 2): WORLDN_MODES + ("embed_flat", "embed_topk"),
}
TOL = 1e-5
TIMEOUT_S = 240


def _batches(n_items, n_users, steps):
    """Global numpy batches; users with repeats, so the dedup lookup runs."""
    from repro_torch.recsys import dataset
    ds = dataset.generate(scale=SCALE, seed=0)
    assert (ds.n_items, ds.n_users) == (n_items, n_users)
    out = []
    for i, b in enumerate(dataset.seq_batches(ds, BATCH, SEQ, steps=steps,
                                              seed=7)):
        b["user"] = np.random.default_rng(i).integers(
            0, ds.n_users, BATCH).astype(np.int32)
        b["user"][BATCH // 2:] = b["user"][:BATCH // 2]
        out.append(b)
    return out


def _train_kw(clip=1.0):
    return dict(steps=50, learning_rate=LR, warmup_steps=2, weight_decay=0.0,
                grad_clip=clip, checkpoint_every=0)


def _case(name):
    return EMBED_CASES.get(name, {"mode": name})


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(tree[k])
    return out


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# -- the two sides, each in the process (or subprocess) that runs it ---------

def run_port(mesh, params_np, n_items, n_users, cases, steps,
             use_kernel=True, inter_axis=None):
    """{case: [(loss, flat params, residual) per step]} from the port;
    a case is a sync mode or a name in EMBED_CASES."""
    from repro_torch import convert
    from repro_torch.config import TrainConfig, get_arch, reduced
    from repro_torch.models.transformer import ModelCtx
    from repro_torch.optimizer import adamw
    from repro_torch.recsys import model as trec
    from repro_torch.runtime import trainer
    cfg = dataclasses.replace(reduced(get_arch("recllm-base"), layers=2),
                              vocab_size=n_items + 3, dtype="float32")
    ctx = ModelCtx(attn_chunk=8)
    out = {}
    for name in cases:
        case = _case(name)
        params = convert.params_from_numpy(_nest(params_np), device="cpu")
        opt = adamw.init_opt_state(params)
        scfg = trainer.DPSyncConfig(mode=case["mode"], use_kernel=use_kernel,
                                    inter_axis=inter_axis)
        esync = None
        if "embed" in case:
            esync = trainer.EmbedSyncConfig(id_fns=trec.embed_id_fns(),
                                            **case["embed"])
            if esync.zero_opt:
                opt = trainer.shard_embed_opt(opt, esync, mesh, scfg)
        resid = torch.zeros(trainer.residual_size(
            params, scfg, exclude=esync.exclude if esync else ()))
        step = trainer.make_dp_train_step(
            lambda p, b: trec.recllm_loss(cfg, p, b, ctx)[0], mesh,
            TrainConfig(**_train_kw(case.get("clip", 1.0))), scfg,
            embed_sync=esync, params_shape=params,
            adamw_kernel=case.get("adamw_kernel", False))
        out[name] = []
        for b in _batches(n_items, n_users, steps):
            params, opt, resid, loss = step(
                params, opt, resid, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
            out[name].append((float(loss), _flat(_torch_np(params)),
                              resid.numpy().copy()))
    return out


def _torch_np(tree):
    if isinstance(tree, dict):
        return {k: _torch_np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def run_jax(mesh, params_np, n_items, n_users, cases, steps,
            inter_axis=None):
    """The same from JAX; residuals as (P, N_pad), row ``data * pods +
    pod`` (the batch's shard order over ``("data", "pod")``).  The
    adamw_kernel case runs JAX's step, which has no such switch."""
    import jax
    import jax.numpy as jnp
    from repro.config import TrainConfig, get_arch, reduced
    from repro.models.transformer import ModelCtx
    from repro.optimizer import adamw
    from repro.recsys import model as jrec
    from repro.runtime import trainer
    cfg = dataclasses.replace(reduced(get_arch("recllm-base"), layers=2),
                              vocab_size=n_items + 3, dtype="float32")
    ctx = ModelCtx(attn_chunk=8)
    P = mesh.size
    out = {}
    for name in cases:
        case = _case(name)
        params = jax.tree.map(jnp.asarray, _nest(params_np))
        opt = adamw.init_opt_state(params)
        scfg = trainer.DPSyncConfig(mode=case["mode"], inter_axis=inter_axis)
        esync = None
        if "embed" in case:
            esync = trainer.EmbedSyncConfig(
                id_fns=jrec.embed_id_fns(),
                **case.get("jax_embed", case["embed"]))
        resid = jnp.zeros((P, trainer.residual_size(
            params, scfg, exclude=esync.exclude if esync else ())))
        step = trainer.make_dp_train_step(
            lambda p, b: jrec.recllm_loss(cfg, p, b, ctx)[0], mesh,
            TrainConfig(**_train_kw(case.get("clip", 1.0))), scfg,
            embed_sync=esync,
            params_shape=jax.eval_shape(lambda: params))
        out[name] = []
        for b in _batches(n_items, n_users, steps):
            params, opt, resid, loss = step(
                params, opt, resid, {k: jnp.asarray(v) for k, v in b.items()})
            out[name].append((float(loss), _flat(params),
                              np.asarray(resid)))
    return out


def _assert_same(port, ref, row=0):
    for mode, steps in port.items():
        for i, ((tl, tp, tr), (jl, jp, jr)) in enumerate(zip(steps,
                                                             ref[mode])):
            where = f"{mode} step {i}"
            assert abs(tl - jl) <= TOL, (where, tl, jl)
            assert tp.keys() == jp.keys()
            for k in tp:
                err = np.abs(tp[k] - jp[k]).max()
                assert err <= TOL, (where, k, err)
            err = np.abs(tr - jr[row]).max()
            assert err <= TOL, (where, "residual", err)


# -- world of one ------------------------------------------------------------

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    from repro_torch.core import hierarchical
    store = dist.FileStore(str(tmp_path_factory.mktemp("dp1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield hierarchical.make_dp_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def init():
    import jax
    from repro.config import get_arch, reduced
    from repro.recsys import dataset, model as jrec
    ds = dataset.generate(scale=SCALE, seed=0)
    cfg = dataclasses.replace(reduced(get_arch("recllm-base"), layers=2),
                              vocab_size=ds.n_items + 3, dtype="float32")
    params = jrec.init_recllm(jax.random.PRNGKey(0), cfg, ds.n_users)
    return _flat(jax.tree.map(np.asarray, params)), ds.n_items, ds.n_users


@pytest.mark.parametrize("mode", MODES)
def test_dp_step_world_of_one_matches_jax(world1, init, mode):
    from repro import compat
    params_np, n_items, n_users = init
    port = run_port(world1, params_np, n_items, n_users, (mode,), 3)
    ref = run_jax(compat.make_mesh((1,), ("data",)), params_np, n_items,
                  n_users, (mode,), 3)
    _assert_same(port, ref)


@pytest.mark.parametrize("case", list(EMBED_CASES))
def test_dp_step_embed_sync_world_of_one_matches_jax(world1, init, case):
    """Rows-touched cf_user sync (flat, plain row ops, top-k with its row
    compressor and the residual without the table, zero_opt with and
    without clipping) and the fused AdamW switch, 3 steps."""
    from repro import compat
    params_np, n_items, n_users = init
    port = run_port(world1, params_np, n_items, n_users, (case,), 3)
    ref = run_jax(compat.make_mesh((1,), ("data",)), params_np, n_items,
                  n_users, (case,), 3)
    _assert_same(port, ref)


def test_embed_sync_world_of_one_is_the_dense_sync(world1, init):
    """On one rank the rows-touched sync is the dense gradient, so the
    embed_sync step equals the flat step bit for bit (what chip_smoke.py
    holds on the card at full width)."""
    params_np, n_items, n_users = init
    out = run_port(world1, params_np, n_items, n_users,
                   ("flat", "embed_flat", "embed_flat_plain"), 2)
    for name in ("embed_flat", "embed_flat_plain"):
        for (l0, p0, _), (l1, p1, _) in zip(out["flat"], out[name]):
            assert l0 == l1
            for k in p0:
                np.testing.assert_array_equal(p0[k], p1[k])


def test_zero_opt_refuses_rows_that_do_not_divide(world1):
    from repro_torch.config import TrainConfig
    from repro_torch.runtime import trainer
    esync = trainer.EmbedSyncConfig(id_fns={"t": lambda b: b["u"]},
                                    zero_opt=True)
    with pytest.raises(ValueError, match="params_shape"):
        trainer.make_dp_train_step(None, world1, TrainConfig(),
                                   embed_sync=esync)
    mesh2 = dataclasses.replace(world1, shape={"pod": 1, "data": 2})
    with pytest.raises(ValueError, match="7 rows do not divide over 2"):
        trainer.make_dp_train_step(None, mesh2, TrainConfig(),
                                   embed_sync=esync,
                                   params_shape={"t": torch.zeros(7, 2)})


@pytest.mark.parametrize("mode", ["onebit", "topk"])
def test_plain_sync_matches_kernel_sync(world1, init, mode):
    """use_kernel=False (the plain versions, and top-k's sort threshold)
    against the kernel path, as chip_smoke.py holds them on the card."""
    params_np, n_items, n_users = init
    a = run_port(world1, params_np, n_items, n_users, (mode,), 2)
    b = run_port(world1, params_np, n_items, n_users, (mode,), 2,
                 use_kernel=False)
    _assert_same(a, {m: [(lo, p, r[None]) for lo, p, r in s]
                     for m, s in b.items()})


def test_onebit_sync_bits_match_jax(world1, init):
    """One step's gradient through both syncs: packed bits equal where
    |x| > 1e-6 max|x|, and the mean and residual there within 1e-6."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro import compat
    from repro.core import compression as jcomp
    from repro.kernels import ops as jops
    from repro_torch.core import compression as tcomp
    from repro_torch.kernels import ops as tops
    params_np, _, _ = init
    rng = np.random.default_rng(0)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-3
             for k, v in params_np.items()}
    grads["fusion_gate"] = np.zeros((), np.float32)      # an exact zero
    n = sum(v.size for v in grads.values())
    npad = n + (-n) % (8 * 512)
    resid = np.zeros(npad, np.float32)
    resid[:n] = rng.standard_normal(n).astype(np.float32) * 1e-4
    mesh = compat.make_mesh((1,), ("data",))
    sync = shard_map(lambda g, r: (lambda o: (o[0], o[1][None]))(
        jcomp.onebit_sync(g, r[0], axis="data", block=512)), mesh=mesh,
        in_specs=(P(), P("data")), out_specs=(P(), P("data")),
        check_rep=False)
    jg, jr = sync(jax.tree.map(jnp.asarray, _nest(grads)),
                  jnp.asarray(resid)[None])
    tg, tr = tcomp.onebit_sync(
        _nest({k: torch.from_numpy(v) for k, v in grads.items()}),
        torch.from_numpy(resid), mesh=world1, block=512)
    x = np.concatenate([grads[k].reshape(-1) for k in sorted(grads)])
    x = np.concatenate([x, np.zeros(npad - n, np.float32)]) + resid
    live = np.abs(x) > 1e-6 * np.abs(x).max()
    jbits, _ = jops.onebit_quantize(jnp.asarray(x), 512)
    tbits, _ = tops.onebit_quantize(torch.from_numpy(x), 512)
    unpack = lambda p: ((np.asarray(p)[None] >> np.arange(8)[:, None])  # noqa
                        & 1).reshape(-1)
    np.testing.assert_array_equal(unpack(tbits.numpy())[live],
                                  unpack(jbits)[live])
    np.testing.assert_allclose(tr.numpy()[live], np.asarray(jr)[0][live],
                               atol=1e-6)
    tflat = np.concatenate([_flat(_torch_np(tg))[k].reshape(-1)
                            for k in sorted(grads)])
    jflat = np.concatenate([_flat(jg)[k].reshape(-1) for k in sorted(grads)])
    np.testing.assert_allclose(tflat[live[:n]], jflat[live[:n]], atol=1e-6)


# -- worlds of two and four ------------------------------------------------

def _spawn(tmp, params_np, n_items, n_users, pods, data):
    """JAX on a (pods, data) mesh of host devices and pods * data gloo
    ranks, each a subprocess of this file writing its result under
    ``tmp``."""
    world = pods * data
    np.savez(tmp / "init.npz", **params_np)
    common = [str(tmp / "init.npz"), str(n_items), str(n_users), str(pods),
              str(data)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={world}")
    cmds = [["jax", str(tmp / "jax.npz"), *common]] + [
        ["torch", str(tmp / f"r{rank}.npz"), *common, str(rank),
         str(tmp / "store")] for rank in range(world)]
    return [subprocess.Popen([sys.executable, __file__, *c], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for c in cmds]


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate()


def _check_world(tmp, procs, pods, data):
    """Every rank against JAX (its residual against JAX's row for its
    shard), and the replicas bit-identical."""
    for p in procs:
        try:
            log = p.communicate(timeout=TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            pytest.fail(f"{p.args[2:4]} still running after {TIMEOUT_S} s")
        assert p.returncode == 0, log[-3000:]
    ref = _load(tmp / "jax.npz")
    ranks = [_load(tmp / f"r{r}.npz") for r in range(pods * data)]
    for rank, port in enumerate(ranks):
        _assert_same(port, ref, (rank % data) * pods + rank // data)
    for mode in WORLD_CASES[pods, data]:
        for other in ranks[1:]:
            for (_, p0, _), (_, p1, _) in zip(ranks[0][mode], other[mode]):
                for k in p0:
                    np.testing.assert_array_equal(p0[k], p1[k])


@pytest.fixture(scope="module", autouse=True)
def world2_runs(init, tmp_path_factory):
    """Start the world-of-two subprocesses (JAX on two devices, two gloo
    ranks) with the module, so they run beside the world-of-one tests;
    :func:`test_dp_step_world_of_two_matches_jax` collects them."""
    tmp = tmp_path_factory.mktemp("dp2")
    procs = _spawn(tmp, *init, pods=1, data=2)
    try:
        yield tmp, procs
    finally:
        _stop(procs)


def test_dp_step_world_of_two_matches_jax(world2_runs):
    _check_world(*world2_runs, pods=1, data=2)


def test_dp_step_two_pods_of_two_matches_jax(init, tmp_path):
    """The pod axis: ``make_dp_mesh(pods=2)``'s pod groups, the cross-pod
    all-reduce of hierarchical sync and the cross-pod mean after a
    compressed sync.  Started after the world of two has finished, so the
    two worlds' processes do not share the CPU."""
    procs = _spawn(tmp_path, *init, pods=2, data=2)
    try:
        _check_world(tmp_path, procs, pods=2, data=2)
    finally:
        _stop(procs)


def _save(path, out):
    arrays = {}
    for mode, steps in out.items():
        for i, (loss, params, resid) in enumerate(steps):
            arrays[f"{mode}|{i}|loss"] = np.float64(loss)
            arrays[f"{mode}|{i}|resid"] = resid
            for k, v in params.items():
                arrays[f"{mode}|{i}|p|{k}"] = v
    np.savez(path, **arrays)


def _load(path):
    data = np.load(path)
    out = {}
    for key in data.files:
        mode, i, kind, *rest = key.split("|")
        steps = out.setdefault(mode, {})
        entry = steps.setdefault(int(i), [None, {}, None])
        if kind == "loss":
            entry[0] = float(data[key])
        elif kind == "resid":
            entry[2] = data[key]
        else:
            entry[1][rest[0]] = data[key]
    return {m: [tuple(s[i]) for i in sorted(s)] for m, s in out.items()}


def _subprocess_main(argv):
    side, out_path, init_path, n_items, n_users, pods, data, *rest = argv
    params_np = dict(np.load(init_path))
    n_items, n_users, pods, data = map(int, (n_items, n_users, pods, data))
    inter_axis = "pod" if pods > 1 else None
    if side == "jax":
        from repro import compat
        mesh = (compat.make_mesh((pods, data), ("pod", "data")) if inter_axis
                else compat.make_mesh((data,), ("data",)))
        out = run_jax(mesh, params_np, n_items, n_users,
                      WORLD_CASES[pods, data], 2, inter_axis=inter_axis)
    else:
        from repro_torch.core import hierarchical
        rank, store_path = int(rest[0]), rest[1]
        torch.set_num_threads(max(1, 4 // (pods * data)))
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, pods * data), rank=rank,
            world_size=pods * data)
        try:
            out = run_port(hierarchical.make_dp_mesh(pods), params_np,
                           n_items, n_users, WORLD_CASES[pods, data], 2,
                           inter_axis=inter_axis)
        finally:
            dist.destroy_process_group()
    _save(out_path, out)


if __name__ == "__main__":
    _subprocess_main(sys.argv[1:])
