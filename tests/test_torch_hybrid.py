"""The port's hybrid TP x DP train step against JAX's
``make_hybrid_train_step`` (float32, reduced configs, 3 steps, grad_clip
1.0, masks that differ between rows).

* A 2 x 2 ``(data, model)`` world: four gloo ranks (subprocesses of this
  file, a ``FileStore``) against JAX on a 2 x 2 mesh of host devices (one
  subprocess with ``--xla_force_host_platform_device_count=4``), run
  concurrently, each with its own timeout, in four cases:
  - ``sp``: olmo-1b at seq 32, where ``auto_plan`` turns Megatron-SP on,
    two micro-batches;
  - ``dp_heavy``: the same under ``make_plan(..., dp_heavy=True)``: the
    batch over every axis, the weights gathered at use;
  - ``gqa``: internlm2-20b (4 q heads, 1 kv head) at seq 16 (no SP): k/v
    replicated over ``model``, an untied vocab-parallel head;
  - ``recllm``: RecLLM-base through ``recllm_loss`` with replicated CF
    tables, two micro-batches.
  Held: the loss and ``grad_norm`` per step within rtol 1e-5, the full
  params and ``m``/``v``/``master`` after 3 steps within rtol 1e-5, atol
  1e-6, and every rank's shard equal to its slice of the full array by
  the port's spec.
* A world of one in this process: the flash backward against autograd
  through ``chunked_attention`` and JAX's ``_flash`` VJP, and the hybrid
  step (``flash_vjp`` on, as at tp 1) with remat on and off against JAX's
  step on one device.
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
STEPS, BATCH, N_USERS = 3, 8, 40
RTOL, ATOL = 1e-5, 1e-6
TIMEOUT_S = 240
# case -> (arch, seq, micro-batches, plan): "auto" is auto_plan's plan for
# the shape, "dp_heavy" make_plan(..., dp_heavy=True)
CASES = {
    "sp": ("olmo-1b", 32, 2, "auto"),
    "dp_heavy": ("olmo-1b", 32, 2, "dp_heavy"),
    "gqa": ("internlm2-20b", 16, 1, "auto"),
    "recllm": ("recllm-base", 16, 2, "auto"),
}


def _cfg(config_mod, arch):
    cfg = config_mod.reduced(config_mod.get_arch(arch))
    return dataclasses.replace(cfg, dtype="float32")


def _tcfg(config_mod):
    return config_mod.TrainConfig(steps=20, learning_rate=1e-3,
                                  warmup_steps=1, grad_clip=1.0,
                                  checkpoint_every=0)


def _plan(config_mod, hybrid, sharding, cfg, mesh, name):
    arch, seq, micro, kind = CASES[name]
    pcfg = config_mod.ParallelConfig(microbatches=micro)
    if kind == "dp_heavy":
        return hybrid.Plan(sharding=sharding.make_plan(mesh, pcfg,
                                                       dp_heavy=True),
                           pcfg=pcfg, remat=False, grad_sync="auto")
    return hybrid.auto_plan(cfg, mesh, config_mod.ShapeConfig(
        "t", seq, BATCH, "train"), pcfg)


def _batches(name, vocab):
    """STEPS global batches; each row's mask keeps a different prefix."""
    _, seq, _, _ = CASES[name]
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        lens = rng.integers(seq // 4, seq + 1, BATCH)
        out.append({
            "tokens": rng.integers(3, vocab, (BATCH, seq)).astype(np.int32),
            "targets": rng.integers(3, vocab, (BATCH, seq)).astype(np.int32),
            "mask": (np.arange(seq)[None] < lens[:, None]).astype(
                np.float32),
            "user": rng.integers(0, N_USERS, BATCH).astype(np.int32)})
        if name != "recllm":
            del out[-1]["user"]
    return out


def _flat(tree, prefix=""):
    """{path: array}; an empty dict (olmo's parameter-free norms) is kept
    as its path with a trailing ``/``."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/") if tree[k]
                       else {f"{prefix}{k}/": np.zeros(0)})
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
        if leaf:
            node[leaf] = v
    return tree


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.detach().numpy().copy()
            for k, v in tree.items()}


# -- the two sides -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_donated_adamw_equals_the_functional_update(monkeypatch, dtype):
    """The hybrid step's in-place AdamW (chunks of DONATE_CHUNK elements,
    the clip folded in as ``grad_scale``) gives the functional update's
    params and state bit for bit, over chunk borders."""
    from repro_torch.config import TrainConfig
    from repro_torch.optimizer import adamw
    from repro_torch.tree import tree_map
    monkeypatch.setattr(adamw, "DONATE_CHUNK", 7)
    g = torch.Generator().manual_seed(0)

    def tree():
        return {"a": torch.randn(5, 6, generator=g).to(dtype),
                "b": {"c": torch.randn(17, generator=g).to(dtype)}}
    params, grads = tree(), tree()
    opt = adamw.init_opt_state(params)
    opt["m"] = tree_map(lambda x: x.float(), tree())
    opt["v"] = tree_map(torch.square, opt["m"])
    tc, lr, scale = TrainConfig(grad_clip=0.0), torch.tensor(3e-3), \
        torch.tensor(0.37)
    want = adamw.adamw_apply(params, grads, opt, lr, tc, grad_scale=scale)
    mine = tree_map(torch.clone, {"p": params, "o": opt})
    got = adamw.adamw_apply(mine["p"], grads, mine["o"], lr, tc,
                            donate=True, grad_scale=scale)
    assert got[0] is mine["p"] and got[1]["m"] is mine["o"]["m"]
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def run_jax(mesh, init, names=tuple(CASES)):
    """{case: (losses, grad_norms, flat params, flat opt)} from JAX."""
    import jax
    import jax.numpy as jnp
    from repro import config
    from repro.core import hybrid, sharding
    from repro.models.transformer import ModelCtx
    from repro.optimizer import adamw
    from repro.recsys import model as jrec
    from repro.runtime import trainer
    out = {}
    for name in names:
        cfg = _cfg(config, CASES[name][0])
        plan = _plan(config, hybrid, sharding, cfg, mesh, name)
        loss_fn = None
        if name == "recllm":
            ctx = ModelCtx(attn_chunk=8)
            loss_fn = lambda p, b, cfg=cfg, ctx=ctx: (  # noqa: E731
                jrec.recllm_loss(cfg, p, b, ctx))
        params = jax.tree.map(jnp.asarray, _nest(init[name]))
        opt = adamw.init_opt_state(params)
        batches = [jax.tree.map(jnp.asarray, b)
                   for b in _batches(name, cfg.vocab_size)]
        _, jitted, _ = trainer.make_hybrid_train_step(cfg, plan,
                                                      _tcfg(config),
                                                      loss_fn=loss_fn)
        fn = jitted(jax.eval_shape(lambda: params), batches[0])
        losses, norms = [], []
        for b in batches:
            params, opt, m = fn(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = (losses, norms, _flat(params), _flat(opt))
    return out


def run_port(mesh, init, names=tuple(CASES), remat=None):
    """The same from the port on this rank, plus the largest difference
    between a local shard and its slice of the gathered full array."""
    from repro_torch import config, convert
    from repro_torch.core import hybrid, sharding
    from repro_torch.models.transformer import ModelCtx
    from repro_torch.optimizer import adamw
    from repro_torch.recsys import model as trec
    from repro_torch.runtime import trainer
    out = {}
    for name in names:
        cfg = _cfg(config, CASES[name][0])
        plan = _plan(config, hybrid, sharding, cfg, mesh, name)
        if remat is not None:
            plan = dataclasses.replace(plan, remat=remat)
        loss_fn, ctx = None, None
        if name == "recllm":
            ctx = ModelCtx(attn_chunk=8)
            loss_fn = lambda p, b, c, cfg=cfg: (  # noqa: E731
                trec.recllm_loss(cfg, p, b, c))
        full = convert.params_from_numpy(_nest(init[name]), device="cpu")
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in _batches(name, cfg.vocab_size)]
        step, shardings_for = trainer.make_hybrid_train_step(
            cfg, plan, _tcfg(config), loss_fn, params_shape=full, ctx=ctx)
        psh, osh, _ = shardings_for(full, batches[0])
        params = sharding.device_put(full, psh)
        opt = sharding.device_put(adamw.init_opt_state(full), osh)
        # the launcher's init: the same state from the shards alone
        opt_err = max(float((a - b).abs().max()) for a, b in zip(
            _leaves(opt), _leaves(trainer.init_hybrid_opt(cfg, plan, params,
                                                          full))))
        losses, norms = [], []
        for b in batches:
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        fp, fo = sharding.gather(params, psh), sharding.gather(opt, osh)
        err = opt_err
        for loc, whole, sh in zip(*(_leaves(t) for t in (
                (params, opt), (fp, fo), (psh, osh)))):
            err = max(err, float((loc - sh.shard(whole)).abs().max()))
        out[name] = (losses, norms, _flat(_np(fp)), _flat(_np(fo)), err)
    return out


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return tree_leaves(tree)


def _assert_same(port, ref):
    for name, (pl, pn, pp, po, *_rest) in port.items():
        jl, jn, jp, jo = ref[name]
        np.testing.assert_allclose(pl, jl, rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(pn, jn, rtol=RTOL, err_msg=name)
        for tree, jtree in ((pp, jp), (po, jo)):
            assert tree.keys() == jtree.keys(), name
            for k in tree:
                np.testing.assert_allclose(tree[k], jtree[k], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{name} {k}")


def _save(path, out):
    arrays = {}
    for name, (losses, norms, fp, fo, *err) in out.items():
        arrays[f"{name}|losses"] = np.asarray(losses)
        arrays[f"{name}|norms"] = np.asarray(norms)
        if err:
            arrays[f"{name}|err"] = np.float64(err[0])
        for part, flat in (("p", fp), ("o", fo)):
            for k, v in flat.items():
                arrays[f"{name}|{part}|{k}"] = v
    np.savez(path, **arrays)


def _load(path):
    data = np.load(path)
    out = {}
    for key in data.files:
        name, kind, *rest = key.split("|")
        entry = out.setdefault(name, {"p": {}, "o": {}})
        if rest:
            entry[kind][rest[0]] = data[key]
        else:
            entry[kind] = data[key]
    return {n: (list(e["losses"]), list(e["norms"]), e["p"], e["o"],
                float(e.get("err", 0.0))) for n, e in out.items()}


def _init():
    """Each case's JAX init (PRNGKey(0)), flattened."""
    import jax
    from repro import config
    from repro.models import transformer as tf
    from repro.recsys import model as jrec
    out = {}
    for name, (arch, *_rest) in CASES.items():
        cfg = _cfg(config, arch)
        key = jax.random.PRNGKey(0)
        params = (jrec.init_recllm(key, cfg, N_USERS) if name == "recllm"
                  else tf.init_params(key, cfg))
        out[name] = _flat(jax.tree.map(np.asarray, params))
    return out


# -- the world of one ------------------------------------------------------------

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    from repro_torch.launch.mesh import make_host_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("hy1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield make_host_mesh()
    dist.destroy_process_group()


def test_device_put_on_one_rank_copies_nothing(world1):
    """A spec over axes of one rank shards nothing: the leaf itself comes
    back, so a one-card launcher does not hold its state twice."""
    from repro_torch.core.sharding import NamedSharding
    x = torch.zeros(4, 6)
    for spec in [("model", None), (None, ("data", "model")), ()]:
        sh = NamedSharding(world1, spec)
        assert sh.shard(x) is x and sh.gather(x) is x


@pytest.mark.parametrize("window", [0, 8])
def test_flash_vjp_matches_autograd_and_jax(window):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(window)
    B, S, H, Hk, D = 2, 32, 4, 2, 16
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, D), (B, S, Hk, D), (B, S, Hk, D), (B, S, H, D)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_chunked_attention(tq, tk, tv, window=window, chunk=8)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    ref_out = tattn.chunked_attention(tq, tk, tv, window=window, chunk=8)
    want = torch.autograd.grad(ref_out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(),
                               ref_out.detach().numpy(), atol=1e-6)
    _, vjp = jax.vjp(lambda a, b, c: jattn.flash_chunked_attention(
        a, b, c, window=window, chunk=8), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    for g, w, j in zip(got, want, jgrads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5)


def test_hybrid_world_of_one_remat_and_flash_match_jax(world1):
    """tp 1 sets flash_vjp; remat on and off give equal losses and
    states, both held to JAX's step on one device."""
    from repro import compat
    init = {n: v for n, v in _init().items() if n in ("sp", "recllm")}
    jmesh = compat.make_mesh((1, 1), ("data", "model"))
    ref = run_jax(jmesh, init, names=tuple(init))
    on = run_port(world1, init, names=tuple(init), remat=True)
    off = run_port(world1, init, names=tuple(init), remat=False)
    for name in init:
        assert on[name][0] == off[name][0], name
        for part in (2, 3):
            for k in on[name][part]:
                np.testing.assert_array_equal(on[name][part][k],
                                              off[name][part][k])
    _assert_same(on, ref)


# -- the 2 x 2 world -----------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def world4_procs(tmp_path_factory):
    """Start the 2 x 2 world's subprocesses with the module, so they run
    beside the world-of-one tests; :func:`world4` collects them."""
    tmp = tmp_path_factory.mktemp("hybrid4")
    init = _init()
    np.savez(tmp / "init.npz", **{f"{n}|{k}": v for n, flat in init.items()
                                  for k, v in flat.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cmds = [["jax", str(tmp / "jax.npz"), str(tmp / "init.npz")]] + [
        ["torch", str(tmp / f"r{r}.npz"), str(tmp / "init.npz"), str(r),
         str(tmp / "store")] for r in range(4)]
    procs = [subprocess.Popen([sys.executable, __file__, *c], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        yield tmp, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def world4(world4_procs):
    tmp, procs = world4_procs
    for p in procs:
        try:
            log = p.communicate(timeout=TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            pytest.fail(f"{p.args[2]} still running after {TIMEOUT_S} s")
        assert p.returncode == 0, log[-3000:]
    return (_load(tmp / "jax.npz"),
            [_load(tmp / f"r{r}.npz") for r in range(4)])


@pytest.mark.parametrize("name", list(CASES))
def test_hybrid_step_2x2_matches_jax(world4, name):
    ref, ranks = world4
    jl, jn, jp, jo, _ = ref[name]
    _assert_same({name: ranks[0][name]}, {name: (jl, jn, jp, jo)})


@pytest.mark.parametrize("name", list(CASES))
def test_hybrid_shards_are_their_slices(world4, name):
    """Every rank's shard of params and opt is its slice of the full
    array by the port's spec; every rank gathers the same full arrays."""
    _, ranks = world4
    for r, port in enumerate(ranks):
        assert port[name][4] == 0.0, (r, port[name][4])
        for part in (2, 3):
            for k, v in port[name][part].items():
                np.testing.assert_array_equal(v, ranks[0][name][part][k])


def test_plans_are_the_ones_named():
    """The cases exercise what their names say: SP on for ``sp`` (and off
    at seq 16), dp_heavy for ``dp_heavy``, kv replicated and an untied
    head for ``gqa``."""
    from repro_torch import config
    from repro_torch.core import hybrid, sharding
    from repro_torch.core.hierarchical import DPMesh
    mesh = DPMesh(shape={"data": 2, "model": 2},
                  coords={"data": 0, "model": 0}, groups={})
    plans = {n: _plan(config, hybrid, sharding, _cfg(config, CASES[n][0]),
                      mesh, n) for n in CASES}
    assert plans["sp"].sharding.seq_shard and not plans["sp"].sharding.dp_heavy
    assert plans["dp_heavy"].sharding.dp_heavy
    assert not plans["gqa"].sharding.seq_shard
    gqa = _cfg(config, "internlm2-20b")
    assert gqa.num_kv_heads % 2 and not gqa.tie_embeddings
    assert all(not p.remat for p in plans.values())


def _subprocess_main(argv):
    side, out_path, init_path, *rest = argv
    data = np.load(init_path)
    init = {}
    for key in data.files:
        name, path = key.split("|")
        init.setdefault(name, {})[path] = data[key]
    if side == "jax":
        from repro import compat
        out = run_jax(compat.make_mesh((2, 2), ("data", "model")), init)
    else:
        from repro_torch.launch.mesh import make_host_mesh
        rank, store_path = int(rest[0]), rest[1]
        torch.set_num_threads(1)
        dist.init_process_group("gloo",
                                store=dist.FileStore(store_path, 4),
                                rank=rank, world_size=4)
        try:
            out = run_port(make_host_mesh(data=2, model=2), init)
        finally:
            dist.destroy_process_group()
    _save(out_path, out)


if __name__ == "__main__":
    _subprocess_main(sys.argv[1:])
