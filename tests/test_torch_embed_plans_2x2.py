"""The port's sharded CF-table plans on a 2 x 2 ``(data, model)`` world,
against the JAX package's on a 2 x 2 mesh, on the CPU.

Four gloo ranks (subprocesses of this file, a ``FileStore`` under pytest's
temporary directory) run beside JAX on four host devices (one subprocess
with ``--xla_force_host_platform_device_count=4``), all started together
by the first test that needs them, each with its own timeout, writing
their results to files:

* each plan's lookup and gradient (rows 96, dim 16, 48 ids, atol 1e-6);
* ``CachedLookup`` under every plan bit-exact with hits, and after
  ``update_rows``, its summary JAX's, with the default cache knobs and
  with others;
* the hybrid step on reduced RecLLM-base (float32, 4 steps) under
  ``embed_plans`` row, col, row_col (and row_col under ``dp_heavy``): its
  CF-table specs equal to JAX's and its losses and gradient norms within
  rtol 1e-4 / atol 1e-6 of JAX's step with the same plan and of the
  replicated plan's;
* a checkpoint round trip under ``row``.

The inputs and the lookups' drivers are ``test_torch_embed_plans.py``'s.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_embed_plans import (ATOL, DIM, KNOBS, PLANS, ROOT, ROWS,
                                    _cached_runs, _lookup_inputs, _zipf_ids,
                                    jax_lookups, port_lookups)

# the hybrid step: reduced RecLLM-base, float32
HY_STEPS, HY_BATCH, HY_SEQ, N_USERS = 4, 8, 16, 64
HY_RTOL, HY_ATOL = 1e-4, 1e-6
# case -> (embed plan kind or None, dp_heavy)
HY_CASES = {"replicated": (None, False), "row": ("row", False),
            "col": ("col", False), "row_col": ("row_col", False),
            "row_col_dp_heavy": ("row_col", True)}
# the cached lookups: result key -> cache knobs (besides rows=24)
CACHES = {"cache": {}, "cache_slow": KNOBS["slow"]}
CKPT_STEPS = 2
TIMEOUT_S = 240


def _hy_cfg(config_mod):
    return dataclasses.replace(config_mod.reduced(
        config_mod.get_arch("recllm-base")), dtype="float32")


def _hy_tcfg(config_mod, **kw):
    return config_mod.TrainConfig(steps=20, learning_rate=1e-3,
                                  warmup_steps=1, grad_clip=1.0,
                                  checkpoint_every=0, **kw)


def _hy_plan(config_mod, hybrid, sharding, rec, cfg, mesh, case):
    kind, dp_heavy = HY_CASES[case]
    eplans = rec.embed_plans(kind) if kind else None
    pcfg = config_mod.ParallelConfig(microbatches=2)
    if dp_heavy:
        return hybrid.Plan(sharding=sharding.make_plan(
            mesh, pcfg, dp_heavy=True, embed_plans=eplans), pcfg=pcfg,
            remat=False, grad_sync="auto")
    return hybrid.auto_plan(cfg, mesh, config_mod.ShapeConfig(
        "t", HY_SEQ, HY_BATCH, "train"), pcfg, embed_plans=eplans)


def _hy_batches(vocab):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(HY_STEPS):
        lens = rng.integers(HY_SEQ // 4, HY_SEQ + 1, HY_BATCH)
        out.append({
            "tokens": rng.integers(3, vocab, (HY_BATCH, HY_SEQ)).astype(
                np.int32),
            "targets": rng.integers(3, vocab, (HY_BATCH, HY_SEQ)).astype(
                np.int32),
            "mask": (np.arange(HY_SEQ)[None] < lens[:, None]).astype(
                np.float32),
            "user": rng.integers(0, N_USERS, HY_BATCH).astype(np.int32)})
    return out


def _flat(tree, prefix=""):
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


def _init_recllm():
    import jax
    from repro import config
    from repro.recsys import model as jrec
    return _flat(jax.tree.map(np.asarray, jrec.init_recllm(
        jax.random.PRNGKey(0), _hy_cfg(config), N_USERS)))


def _spec_str(spec):
    return json.dumps([list(d) if isinstance(d, tuple) else d
                       for d in spec])


def run_jax(out_path, init):
    import jax
    import jax.numpy as jnp
    from repro import compat, config
    from repro.core import hybrid, sharding
    from repro.embeddings import (CacheConfig, CachedLookup, EmbedSpec,
                                  make_plan)
    from repro.models.transformer import ModelCtx
    from repro.optimizer import adamw
    from repro.recsys import model as jrec
    from repro.runtime import trainer
    mesh = compat.make_mesh((2, 2), ("data", "model"))
    res = {}
    for kind, (out, g) in jax_lookups(mesh).items():
        res[f"lookup|{kind}|out"], res[f"lookup|{kind}|grad"] = out, g
    table = _lookup_inputs()[0]
    ids = _zipf_ids(160, ROWS, seed=7)
    for kind in PLANS:
        for name, kw in CACHES.items():
            lk = CachedLookup(EmbedSpec("cf_item", ROWS, DIM),
                              make_plan(kind), table, mesh=mesh,
                              cache=CacheConfig(rows=24, **kw))
            got = _cached_runs(lambda lk=lk: lk, table, ids)
            for k, v in got.items():
                res[f"{name}|{kind}|{k}"] = (np.asarray(json.dumps(v))
                                             if k == "summary" else v)
    cfg = _hy_cfg(config)
    batches = [jax.tree.map(jnp.asarray, b)
               for b in _hy_batches(cfg.vocab_size)]
    ctx = ModelCtx(attn_chunk=8)
    for case in HY_CASES:
        plan = _hy_plan(config, hybrid, sharding, jrec, cfg, mesh, case)
        params = jax.tree.map(jnp.asarray, _nest(init))
        specs = plan.sharding.param_specs(cfg, jax.eval_shape(
            lambda: params))
        for t in ("cf_user", "cf_item"):
            res[f"hy|{case}|spec|{t}"] = np.asarray(_spec_str(
                tuple(specs[t])))
        _, jitted, _ = trainer.make_hybrid_train_step(
            cfg, plan, _hy_tcfg(config), loss_fn=lambda p, b: (
                jrec.recllm_loss(cfg, p, b, ctx)))
        fn = jitted(jax.eval_shape(lambda: params), batches[0])
        opt = adamw.init_opt_state(params)
        losses, norms = [], []
        for b in batches:
            params, opt, m = fn(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        res[f"hy|{case}|losses"] = np.asarray(losses)
        res[f"hy|{case}|norms"] = np.asarray(norms)
        for part, tree in (("p", params), ("m", opt["m"]), ("v", opt["v"])):
            for t in ("cf_user", "cf_item", "fusion_gate"):
                res[f"hy|{case}|{part}|{t}"] = np.asarray(tree[t])
    np.savez(out_path, **res)


def run_port(out_path, init, rank, store_path, tmp):
    from repro_torch import config, convert
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import hybrid, sharding
    from repro_torch.embeddings import (CacheConfig, CachedLookup,
                                        EmbedSpec, make_plan)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import ModelCtx
    from repro_torch.optimizer import adamw
    from repro_torch.recsys import model as trec
    from repro_torch.runtime import trainer
    from repro_torch.tree import tree_leaves
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                            rank=rank, world_size=4)
    res = {}
    try:
        mesh = make_host_mesh(data=2, model=2)
        for kind, (out, g, kern) in port_lookups(mesh).items():
            res[f"lookup|{kind}|out"], res[f"lookup|{kind}|grad"] = out, g
            res[f"lookup|{kind}|kern"] = kern
        table = _lookup_inputs()[0]
        ids = _zipf_ids(160, ROWS, seed=7)
        for kind in PLANS:
            for name, kw in CACHES.items():
                got = _cached_runs(lambda kind=kind, kw=kw: CachedLookup(
                    EmbedSpec("cf_item", ROWS, DIM), make_plan(kind), table,
                    device="cpu", mesh=mesh,
                    cache=CacheConfig(rows=24, **kw)), table, ids)
                for k, v in got.items():
                    res[f"{name}|{kind}|{k}"] = (np.asarray(json.dumps(v))
                                                 if k == "summary" else v)
        cfg = _hy_cfg(config)
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in _hy_batches(cfg.vocab_size)]
        ctx = ModelCtx(attn_chunk=8)

        def loss_fn(p, b, c):
            return trec.recllm_loss(cfg, p, b, c)

        def fresh(case, tcfg):
            plan = _hy_plan(config, hybrid, sharding, trec, cfg, mesh, case)
            full = convert.params_from_numpy(_nest(init), device="cpu")
            step, shardings_for = trainer.make_hybrid_train_step(
                cfg, plan, tcfg, loss_fn, params_shape=full, ctx=ctx)
            psh, osh, _ = shardings_for(full, batches[0])
            params = sharding.device_put(full, psh)
            state = {"params": params,
                     "opt": trainer.init_hybrid_opt(cfg, plan, params, full)}
            specs = plan.sharding.param_specs(cfg, full)
            return step, state, {"params": psh, "opt": osh}, specs

        for case in HY_CASES:
            step, state, shs, specs = fresh(case, _hy_tcfg(config))
            for t in ("cf_user", "cf_item"):
                res[f"hy|{case}|spec|{t}"] = np.asarray(_spec_str(specs[t]))
            losses, norms = [], []
            params, opt = state["params"], state["opt"]
            for b in batches:
                params, opt, m = step(params, opt, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            res[f"hy|{case}|losses"] = np.asarray(losses)
            res[f"hy|{case}|norms"] = np.asarray(norms)
            whole = {"p": sharding.gather(params, shs["params"]),
                     "m": sharding.gather(opt["m"], shs["opt"]["m"]),
                     "v": sharding.gather(opt["v"], shs["opt"]["v"])}
            for part, tree in whole.items():
                for t in ("cf_user", "cf_item", "fusion_gate"):
                    res[f"hy|{case}|{part}|{t}"] = tree[t].numpy()
            res[f"hy|{case}|local|cf_user"] = np.asarray(
                tuple(params["cf_user"].shape))

        # a checkpoint round trip under row: save after CKPT_STEPS steps,
        # restore into a fresh state by the plan's specs, run on
        tcfg = _hy_tcfg(config, checkpoint_dir=str(tmp / "ck"))
        step, state, shs, _ = fresh("row", tcfg)
        trainer.train_loop(state, iter(batches[:CKPT_STEPS]), step, tcfg)
        ckpt.save(tcfg.checkpoint_dir, CKPT_STEPS, state, shardings=shs)
        _, blank, _, _ = fresh("row", tcfg)
        start, back = trainer.resume_or_init(blank, tcfg, shs)
        bad = [i for i, (a, b) in enumerate(zip(tree_leaves(back),
                                                tree_leaves(state)))
               if a.shape != b.shape or not torch.equal(a, b)]
        ahead = trainer.train_loop(state, iter(batches[CKPT_STEPS:]), step,
                                   tcfg).losses
        resumed = trainer.train_loop(back, iter(batches[CKPT_STEPS:]), step,
                                     tcfg, start_step=start).losses
        res["ckpt|start"] = np.asarray(start)
        res["ckpt|bad"] = np.asarray(bad, np.int64)
        res["ckpt|ahead"] = np.asarray(ahead)
        res["ckpt|resumed"] = np.asarray(resumed)
        res["ckpt|saved_cf_user"] = np.load(os.path.join(
            tcfg.checkpoint_dir, f"step_{CKPT_STEPS:010d}",
            "arrays.npz"))["params/cf_user"]
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Run the 2 x 2 world's five subprocesses (JAX and four gloo ranks)
    together, each with a timeout, and load what each wrote."""
    tmp = tmp_path_factory.mktemp("embed4")
    np.savez(tmp / "init.npz", **_init_recllm())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cmds = [["jax", str(tmp / "jax.npz"), str(tmp)]] + [
        ["torch", str(tmp / f"r{r}.npz"), str(tmp), str(r)]
        for r in range(4)]
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
    load = lambda name: dict(np.load(tmp / name))  # noqa: E731
    yield load("jax.npz"), [load(f"r{r}.npz") for r in range(4)]


@pytest.mark.parametrize("kind", PLANS)
def test_lookup_2x2_matches_jax(world4, kind):
    """Every rank's lookup made whole is ``table[ids]`` bit for bit (its
    forward through the ``gather_rows`` wrapper too) and JAX's; its
    gradient, summed and gathered, is JAX's within 1e-6."""
    ref, ranks = world4
    table, ids, _ = _lookup_inputs()
    for r, port in enumerate(ranks):
        for k in ("out", "kern"):
            np.testing.assert_array_equal(port[f"lookup|{kind}|{k}"],
                                          table[ids], err_msg=f"{r} {k}")
        np.testing.assert_array_equal(port[f"lookup|{kind}|out"],
                                      ref[f"lookup|{kind}|out"])
        np.testing.assert_allclose(port[f"lookup|{kind}|grad"],
                                   ref[f"lookup|{kind}|grad"], atol=ATOL,
                                   err_msg=f"rank {r}")


def _same_cached(world4, name, kind):
    ref, ranks = world4
    table = _lookup_inputs()[0]
    ids = _zipf_ids(160, ROWS, seed=7)
    want = {k: ref[f"{name}|{kind}|{k}"] for k in
            ("rows", "touched", "stale", "fresh", "miss")}
    for r, port in enumerate(ranks):
        np.testing.assert_array_equal(port[f"{name}|{kind}|rows"],
                                      table[ids])
        for k, v in want.items():
            np.testing.assert_array_equal(port[f"{name}|{kind}|{k}"], v,
                                          err_msg=f"rank {r} {k}")
        summary = json.loads(str(port[f"{name}|{kind}|summary"]))
        assert summary == json.loads(str(ref[f"{name}|{kind}|summary"]))
        assert summary["hits"] > 0
    np.testing.assert_array_equal(want["fresh"], 7.5)
    np.testing.assert_array_equal(want["miss"], -1.25)


@pytest.mark.parametrize("kind", PLANS)
def test_cached_lookup_2x2_matches_jax(world4, kind):
    """SPMD: every rank, given the same ids, returns ``table[ids]`` bit for
    bit with cache hits, serves the stale replica after an update without
    the refresh and the new rows after it, and its summary (hits, misses,
    ``exchanged_ids``) is JAX's on the 2 x 2 mesh."""
    _same_cached(world4, "cache", kind)


@pytest.mark.parametrize("kind", PLANS)
def test_cached_lookup_knobs_2x2_match_jax(world4, kind):
    """The same with ``decay`` 0.9, a head re-elected every third lookup
    and a miss quantum of 3 (buckets of 6, 12, 24, ... ids over the two
    ``data`` ranks)."""
    _same_cached(world4, "cache_slow", kind)


@pytest.mark.parametrize("case", list(HY_CASES))
def test_hybrid_embed_plans_2x2_match_jax(world4, case):
    """The CF tables' specs are JAX's; losses and gradient norms (which a
    gradient off by a factor of |model| or |data| moves through the clip)
    within rtol 1e-4 / atol 1e-6 of JAX's step with the same plan and of
    the replicated plan's; the CF tables, their m and v and the fusion
    gate after 4 steps within the same tolerance of JAX's; every rank
    the same."""
    ref, ranks = world4
    kind, _ = HY_CASES[case]
    for t in ("cf_user", "cf_item"):
        spec = json.loads(str(ranks[0][f"hy|{case}|spec|{t}"]))
        assert spec == json.loads(str(ref[f"hy|{case}|spec|{t}"]))
    want_spec = {None: [None, None], "row": ["model", None],
                 "col": [None, "data"], "row_col": ["model", "data"]}[kind]
    assert json.loads(str(ranks[0][f"hy|{case}|spec|cf_user"])) == want_spec
    port = ranks[0]
    for what in ("losses", "norms"):
        for other in (ref[f"hy|{case}|{what}"],
                      port[f"hy|replicated|{what}"]):
            np.testing.assert_allclose(port[f"hy|{case}|{what}"], other,
                                       rtol=HY_RTOL, atol=HY_ATOL,
                                       err_msg=what)
    for part in ("p", "m", "v"):
        for t in ("cf_user", "cf_item", "fusion_gate"):
            k = f"hy|{case}|{part}|{t}"
            np.testing.assert_allclose(port[k], ref[k], rtol=HY_RTOL,
                                       atol=HY_ATOL, err_msg=k)
    for r, other in enumerate(ranks[1:], 1):
        for k in port:
            if k.startswith(f"hy|{case}|") and "local" not in k:
                np.testing.assert_array_equal(other[k], port[k],
                                              err_msg=f"rank {r} {k}")


def test_hybrid_row_and_col_shards_are_local(world4):
    """Each rank holds its shard of ``cf_user`` (64 x 64) under the plan:
    half the rows under row, half the columns under col, a quarter under
    row_col; whole under replicated."""
    _, ranks = world4
    want = {"replicated": (64, 64), "row": (32, 64), "col": (64, 32),
            "row_col": (32, 32), "row_col_dp_heavy": (32, 32)}
    for port in ranks:
        for case, shape in want.items():
            assert tuple(port[f"hy|{case}|local|cf_user"]) == shape, case


def test_checkpoint_round_trip_under_row_2x2(world4):
    """A row-sharded state saved from four ranks holds the full logical
    table (JAX's topology-free checkpoints); restored by the plan's specs,
    every leaf is bit-equal to the saved state and the resumed steps'
    losses equal the uninterrupted run's."""
    _, ranks = world4
    for port in ranks:
        assert int(port["ckpt|start"]) == CKPT_STEPS
        assert port["ckpt|bad"].size == 0, port["ckpt|bad"]
        assert list(port["ckpt|resumed"]) == list(port["ckpt|ahead"])
        assert port["ckpt|saved_cf_user"].shape == (N_USERS, 64)
        np.testing.assert_array_equal(port["ckpt|saved_cf_user"],
                                      ranks[0]["ckpt|saved_cf_user"])


def _subprocess_main(argv):
    side, out_path, tmp, *rest = argv
    tmp = pathlib.Path(tmp)
    init = dict(np.load(tmp / "init.npz"))
    if side == "jax":
        run_jax(out_path, init)
    else:
        rank = int(rest[0])
        run_port(out_path, init, rank, str(tmp / "store"), tmp)


if __name__ == "__main__":
    _subprocess_main(sys.argv[1:])
