"""The port's sharded CF-table plans (``row``, ``col``, ``row_col``) against
the JAX package's, on the CPU.

* Placement arithmetic, no devices: ``shard_shape``, ``shard_bytes``,
  ``exchange_bytes``, ``sparse_exchange_bytes``, ``plan_summary`` and
  ``cf_lookup_bytes`` equal JAX's (floats exactly) for every plan on the
  meshes {data 2, model 4} and {data 8, model 4}, with JAX's
  ``ValueError``s; ``param_specs``/``opt_specs`` of full-width RecLLM
  under ``embed_plans`` and ``auto_plan``'s notes equal JAX's.
* A gloo world of one in this process: every plan's lookup bit-equal to
  the replicated gather with JAX's gradient (JAX on a 1 x 1 mesh), and
  refused through the kernel where autograd would record it;
  ``CachedLookup`` against JAX's on that mesh (rows, hits, misses,
  ``exchanged_ids``, the rows-touched refresh), with the default cache
  knobs and with other ``decay``/``elect_every``/``miss_quantum``; the
  CF head with those knobs and other axes against JAX's; the serving
  engine on reduced RecLLM-base with a sharded CF head, cached and
  uncached, whose streams and scores equal the replicated head's; the
  launchers' flags.

The 2 x 2 world (four gloo ranks beside JAX on four host devices) is in
``test_torch_embed_plans_2x2.py``, which takes its inputs from here.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLANS = ("replicated", "row", "col", "row_col")
SHARDED = ("row", "col", "row_col")
MESHES = ({"data": 2, "model": 4}, {"data": 8, "model": 4})
# the lookups (JAX's distributed check: rows 96, dim 16, 48 ids)
ROWS, DIM, N_IDS, ATOL = 96, 16, 48, 1e-6
# cache knobs other than the defaults (decay 0.98, elect_every 1,
# miss_quantum 8); elect_every 0 never elects a head
KNOBS = {"slow": dict(decay=0.9, elect_every=3, miss_quantum=3),
         "never": dict(decay=0.5, elect_every=0, miss_quantum=1)}


def _mesh_id(shape):
    return "x".join(f"{a}{n}" for a, n in shape.items())


# ---------------------------------------------------------------------------
# placement arithmetic
# ---------------------------------------------------------------------------

SPECS = (("t", 128, 64, "float32"), ("t", 16384, 64, "float32"),
         ("cf_user", 10_000, 16, "float32"), ("e", 1024, 32, "bfloat16"))


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("kind", PLANS)
def test_table_math_matches_jax(kind, mesh):
    from repro import embeddings as J
    from repro_torch import embeddings as T
    jplan, tplan = J.make_plan(kind), T.make_plan(kind)
    assert dataclasses.astuple(tplan) == dataclasses.astuple(jplan)
    assert T.pspec(tplan) == tuple(J.pspec(jplan))
    for name, rows, dim, dtype in SPECS:
        js, ts = J.EmbedSpec(name, rows, dim, dtype=dtype), \
            T.EmbedSpec(name, rows, dim, dtype=dtype)
        assert ts.bytes == js.bytes
        assert T.shard_shape(ts, tplan, mesh) == \
            J.shard_shape(js, jplan, mesh)
        assert T.shard_bytes(ts, tplan, mesh) == \
            J.shard_bytes(js, jplan, mesh)
        for b in (1, 16, 128):
            for dp_axis in ("data", "model"):
                assert T.exchange_bytes(ts, tplan, mesh, b, dp_axis) == \
                    J.exchange_bytes(js, jplan, mesh, b, dp_axis)
                assert T.sparse_exchange_bytes(ts, mesh, b, dp_axis) == \
                    J.sparse_exchange_bytes(js, mesh, b, dp_axis)
            assert T.plan_summary(ts, tplan, mesh, b) == \
                J.plan_summary(js, jplan, mesh, b)


@pytest.mark.parametrize("kind", PLANS)
def test_cf_lookup_bytes_matches_jax(kind):
    from repro.embeddings import EmbedSpec as JSpec, make_plan as jplan
    from repro.serving import cf_lookup_bytes as jbytes
    from repro_torch.embeddings import EmbedSpec, make_plan
    from repro_torch.serving import cf_lookup_bytes
    for mesh in MESHES:
        for rows, dim in ((1024, 32), (10_000, 16)):
            for batch, rate in ((17, 0.0), (17, 0.6), (1, 1.0)):
                got = cf_lookup_bytes(EmbedSpec("cf_item", rows, dim),
                                      make_plan(kind), mesh, batch, rate)
                want = jbytes(JSpec("cf_item", rows, dim), jplan(kind),
                              mesh, batch, rate)
                assert got == want
    with pytest.raises(ValueError) as e:
        cf_lookup_bytes(EmbedSpec("t", 8, 8), make_plan(kind), MESHES[0],
                        17, hit_rate=1.5)
    with pytest.raises(ValueError) as je:
        jbytes(JSpec("t", 8, 8), jplan(kind), MESHES[0], 17, hit_rate=1.5)
    assert str(e.value) == str(je.value)


def _raises(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_table_errors_match_jax():
    """JAX's ``ValueError``s, message for message: plan validation, dims
    that do not divide, a column axis other than the DP axis."""
    from repro import embeddings as J
    from repro_torch import embeddings as T
    cases = [
        lambda m: m.EmbedPlan(kind="row"),
        lambda m: m.EmbedPlan(kind="replicated", row_axis="model"),
        lambda m: m.EmbedPlan(kind="col", row_axis="model"),
        lambda m: m.EmbedPlan(kind="bogus"),
        lambda m: m.shard_shape(m.EmbedSpec("t", 100, 64), m.make_plan(
            "row", row_axis="model"), {"model": 8}),
        lambda m: m.shard_bytes(m.EmbedSpec("t", 96, 20),
                                m.make_plan("row_col"), MESHES[1]),
        lambda m: m.plan_summary(m.EmbedSpec("t", 10, 64),
                                 m.make_plan("row"), MESHES[0], 4),
        lambda m: m.make_sharded_lookup(None, m.EmbedSpec("t", 8, 8),
                                        m.make_plan("col",
                                                    col_axis="model")),
    ]
    for fn in cases:
        assert _raises(lambda: fn(T)) == _raises(lambda: fn(J))


# -- the sharding plan under embed_plans (no devices) -------------------------

@dataclasses.dataclass(frozen=True)
class _JaxMesh:
    """What ``repro.core.sharding``/``hybrid`` read of a mesh."""
    shape: dict
    axis_names: tuple
    size: int


def _meshes(shape):
    from repro_torch.core.hierarchical import DPMesh
    jm = _JaxMesh(dict(shape), tuple(shape), math.prod(shape.values()))
    tm = DPMesh(shape=dict(shape), coords={a: 0 for a in shape}, groups={})
    return jm, tm


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix: tuple(d[0] if isinstance(d, tuple) and len(d) == 1
                          else d for d in tree)}


@pytest.mark.parametrize("n_users", [10_000, 1001])
@pytest.mark.parametrize("shape", [{"data": 2, "model": 2},
                                   {"data": 8, "model": 4},
                                   {"pod": 2, "data": 2, "model": 2}],
                         ids=_mesh_id)
@pytest.mark.parametrize("kind", PLANS)
def test_param_and_opt_specs_under_embed_plans_match_jax(kind, shape,
                                                          n_users):
    """Full-width RecLLM-base (shapes from JAX's ``eval_shape``): the
    specs of every leaf, the CF tables' from the plan (replicated where
    1001 users do not divide), ZeRO-1's opt specs, and ``auto_plan``'s
    notes, equal JAX's."""
    import jax
    from repro import config as jconfig
    from repro.core import hybrid as jhy
    from repro.recsys import model as jrec
    from repro_torch import config as tconfig
    from repro_torch.core import hybrid as thy
    from repro_torch.recsys import model as trec
    jm, tm = _meshes(shape)
    jcfg, tcfg = jconfig.get_arch("recllm-base"), \
        tconfig.get_arch("recllm-base")
    params = jax.eval_shape(lambda: jrec.init_recllm(
        jax.random.PRNGKey(0), jcfg, n_users))
    jp = jhy.auto_plan(jcfg, jm, jconfig.SHAPES["train_4k"],
                       embed_plans=jrec.embed_plans(kind))
    tp = thy.auto_plan(tcfg, tm, tconfig.SHAPES["train_4k"],
                       embed_plans=trec.embed_plans(kind))
    assert [n for n in tp.notes if not n.startswith("remat")] == \
        [n for n in jp.notes if not n.startswith("remat")]
    for fn in ("param_specs", "opt_specs"):
        jspecs = _flat_specs(jax.tree.map(
            tuple, getattr(jp.sharding, fn)(jcfg, params),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        assert _flat_specs(getattr(tp.sharding, fn)(tcfg, params)) == \
            jspecs, fn


@pytest.mark.parametrize("kind,axes", [
    ("col", dict(col_axis="pod")), ("row_col", dict(col_axis="pod")),
    ("row", dict(row_axis="data"))], ids=["col_pod", "row_col_pod",
                                         "row_data"])
def test_embed_plan_axes_match_jax(kind, axes):
    """``embed_plans(kind, row_axis=, col_axis=)`` with other axes on the
    (pod 2, data 2, model 2) mesh: the CF tables' specs equal JAX's.  The
    hybrid step looks a table up over a column axis that is a dp axis
    (``pod``) and refuses a row axis other than ``model``."""
    import jax
    from repro import config as jconfig
    from repro.core import hybrid as jhy
    from repro.recsys import model as jrec
    from repro_torch import config as tconfig
    from repro_torch.core import hybrid as thy
    from repro_torch.embeddings.lookup import embed_table_plans
    from repro_torch.recsys import model as trec
    jm, tm = _meshes({"pod": 2, "data": 2, "model": 2})
    jcfg, tcfg = jconfig.get_arch("recllm-base"), \
        tconfig.get_arch("recllm-base")
    params = jax.eval_shape(lambda: jrec.init_recllm(
        jax.random.PRNGKey(0), jcfg, 10_000))
    jp = jhy.auto_plan(jcfg, jm, jconfig.SHAPES["train_4k"],
                       embed_plans=jrec.embed_plans(kind, **axes))
    tp = thy.auto_plan(tcfg, tm, tconfig.SHAPES["train_4k"],
                       embed_plans=trec.embed_plans(kind, **axes))
    jspecs = jp.sharding.param_specs(jcfg, params)
    tspecs = tp.sharding.param_specs(tcfg, params)
    tables = {t: tspecs[t] for t in ("cf_user", "cf_item")}
    for t, spec in tables.items():
        assert spec == tuple(jspecs[t]), t
    if "row_axis" in axes:
        with pytest.raises(ValueError, match="row axis 'data'"):
            embed_table_plans(tp.sharding, tables)
    else:
        got = embed_table_plans(tp.sharding, tables)
        assert {p.col_axis for p in got.values()} == {"pod"}


# ---------------------------------------------------------------------------
# a world of one, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    from repro_torch.launch.mesh import make_host_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("ep1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield make_host_mesh()
    dist.destroy_process_group()


def _lookup_inputs():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(ROWS, DIM)).astype(np.float32)
    ids = rng.integers(0, ROWS, size=N_IDS).astype(np.int32)
    tgt = rng.normal(size=(N_IDS, DIM)).astype(np.float32)
    return table, ids, tgt


def _zipf_ids(n, rows, seed=0, a=1.3):
    rng = np.random.default_rng(seed)
    return np.clip(rng.zipf(a, size=n), 1, rows) - 1


def jax_lookups(mesh):
    """{kind: (out, grad)} of JAX's ``make_sharded_lookup`` on ``mesh``:
    ``0.5 * mean((lookup - tgt)^2)``'s gradient, JAX's check's loss."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from repro import embeddings as J
    table, ids, tgt = _lookup_inputs()
    out = {}
    for kind in PLANS:
        plan = J.make_plan(kind)
        lk = J.make_sharded_lookup(mesh, J.EmbedSpec("t", ROWS, DIM), plan)
        t_sh = jax.device_put(jnp.asarray(table),
                              J.named_sharding(mesh, plan))
        i_sh = jax.device_put(jnp.asarray(ids),
                              NamedSharding(mesh, PartitionSpec("data")))
        g = jax.grad(lambda t: 0.5 * jnp.mean((lk(t, i_sh) - tgt) ** 2))(
            t_sh)
        out[kind] = (np.asarray(lk(t_sh, i_sh)), np.asarray(g))
    return out


def port_lookups(mesh):
    """The same from the port on this rank, made whole: the output
    gathered over ``data``, the gradient summed over ``data`` where the
    shard is replicated there (each rank saw its slice of the batch) and
    gathered by the plan's spec.  Also the forward under ``no_grad``
    through the ``gather_rows`` wrapper (``use_kernel``)."""
    from repro_torch import embeddings as T
    from repro_torch.core import hierarchical as hier
    from repro_torch.core.sharding import NamedSharding
    table, ids, tgt = (torch.from_numpy(x) for x in _lookup_inputs())
    n, i = mesh.shape["data"], mesh.coords["data"]
    b = N_IDS // n
    out = {}
    for kind in PLANS:
        plan = T.make_plan(kind)
        place = T.named_sharding(mesh, plan)
        shard = place.shard(table).clone().requires_grad_()
        lk = T.make_sharded_lookup(mesh, T.EmbedSpec("t", ROWS, DIM), plan)
        blk = lk(shard, ids)
        loss = 0.5 * torch.sum((blk - tgt[i * b:(i + 1) * b]) ** 2) \
            / tgt.numel()
        (g,) = torch.autograd.grad(loss, shard)
        if plan.col_axis != "data":
            g = hier.all_reduce_sum(g, mesh, ("data",))
        with torch.no_grad():
            kern = T.make_sharded_lookup(mesh, T.EmbedSpec("t", ROWS, DIM),
                                         plan, use_kernel=True)(shard, ids)
        rows = NamedSharding(mesh, ("data", None))
        out[kind] = (rows.gather(blk.detach()).numpy(),
                     place.gather(g).numpy(), rows.gather(kern).numpy())
    return out


@pytest.mark.parametrize("kind", PLANS)
def test_lookup_world_of_one_matches_jax(world1, kind):
    from repro import compat
    jm = compat.make_mesh((1, 1), ("data", "model"))
    table, ids, _ = _lookup_inputs()
    want_out, want_g = jax_lookups(jm)[kind]
    out, g, kern = port_lookups(world1)[kind]
    np.testing.assert_array_equal(out, table[ids])
    np.testing.assert_array_equal(kern, table[ids])
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_allclose(g, want_g, atol=ATOL)


@pytest.mark.parametrize("kind", PLANS)
def test_lookup_through_the_kernel_refuses_a_recorded_gradient(world1,
                                                                kind):
    """``use_kernel=True`` always goes through the ``gather_rows`` wrapper:
    with grad mode on, a table that needs no gradient is gathered (by the
    kernel's plain version here), and one that does raises, as the kernel
    has no backward; there is no quiet fallback to plain indexing."""
    from repro_torch import embeddings as T
    table, ids, _ = (torch.from_numpy(x) for x in _lookup_inputs())
    plan = T.make_plan(kind)
    shard = T.named_sharding(world1, plan).shard(table).clone()
    lk = T.make_sharded_lookup(world1, T.EmbedSpec("t", ROWS, DIM), plan,
                               use_kernel=True)
    assert torch.is_grad_enabled()
    np.testing.assert_array_equal(lk(shard, ids).numpy(),
                                  table[ids].numpy())
    with pytest.raises(RuntimeError, match="no backward"):
        lk(shard.requires_grad_(), ids)


def _cached_runs(make, table, ids):
    """Rows of a lookup over ``ids`` in chunks of 32, then of the hot rows
    after an update without and with the refresh; the lookup's
    summary."""
    lk = make()
    rows = [lk(ids[lo:lo + 32])[0] for lo in range(0, len(ids), 32)]
    held = (np.asarray(lk.cache.ids) if lk.cache is not None
            and lk.n_cached else np.unique(ids))
    hot = held[:8]
    new = np.full((len(hot), table.shape[1]), 7.5, np.float32)
    touched = lk.update_rows(hot, new, refresh=False)
    stale, _ = lk(hot)
    lk.refresh_touched(hot)
    fresh, _ = lk(hot)
    cold = np.setdiff1d(np.arange(table.shape[0]), held)[:3]
    lk.update_rows(cold, np.full((3, table.shape[1]), -1.25, np.float32))
    miss, _ = lk(cold)
    return {"rows": np.concatenate(rows), "touched": np.asarray(touched),
            "stale": stale, "fresh": fresh, "miss": miss,
            "summary": lk.summary()}


@pytest.mark.parametrize("cache_rows", [0, 24])
@pytest.mark.parametrize("kind", PLANS)
def test_cached_lookup_world_of_one_matches_jax(world1, kind, cache_rows):
    """Against JAX's ``CachedLookup`` on a 1 x 1 mesh, cache on and off:
    rows (equal to ``table[ids]``), hits, misses and ``exchanged_ids``
    (the miss bucket's padding) equal; after an update, the stale replica
    without the refresh and the new rows with it, as JAX's."""
    from repro import compat
    from repro.embeddings import (CacheConfig as JCache,
                                  CachedLookup as JLookup,
                                  EmbedSpec as JSpec, make_plan as jplan)
    from repro_torch.embeddings import (CacheConfig, CachedLookup,
                                        EmbedSpec, make_plan)
    jm = compat.make_mesh((1, 1), ("data", "model"))
    table = _lookup_inputs()[0]
    ids = _zipf_ids(150, ROWS, seed=7)
    got = _cached_runs(lambda: CachedLookup(
        EmbedSpec("cf_item", ROWS, DIM), make_plan(kind), table,
        device="cpu", mesh=world1, cache=CacheConfig(rows=cache_rows)),
        table, ids)
    want = _cached_runs(lambda: JLookup(
        JSpec("cf_item", ROWS, DIM), jplan(kind), table, mesh=jm,
        cache=JCache(rows=cache_rows)), table, ids)
    np.testing.assert_array_equal(got["rows"], table[ids])
    for k in ("rows", "touched", "stale", "fresh", "miss"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["fresh"], 7.5)
    np.testing.assert_array_equal(got["miss"], -1.25)
    if cache_rows:
        assert got["summary"]["hits"] > 0
        assert not np.array_equal(got["stale"], got["fresh"])
    assert got["summary"] == want["summary"]


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("kind", PLANS)
def test_cached_lookup_knobs_world_of_one_match_jax(world1, kind, knobs):
    """``decay``, ``elect_every`` (every third lookup; never) and
    ``miss_quantum`` (3; 1) other than the defaults: rows, refreshes and
    the summary (hits, misses, ``exchanged_ids``) equal JAX's."""
    from repro import compat
    from repro.embeddings import (CacheConfig as JCache,
                                  CachedLookup as JLookup,
                                  EmbedSpec as JSpec, make_plan as jplan)
    from repro_torch.embeddings import (CacheConfig, CachedLookup,
                                        EmbedSpec, make_plan)
    jm = compat.make_mesh((1, 1), ("data", "model"))
    table = _lookup_inputs()[0]
    ids = _zipf_ids(150, ROWS, seed=11)
    kw = KNOBS[knobs]
    got = _cached_runs(lambda: CachedLookup(
        EmbedSpec("cf_item", ROWS, DIM), make_plan(kind), table,
        device="cpu", mesh=world1, cache=CacheConfig(rows=24, **kw)),
        table, ids)
    want = _cached_runs(lambda: JLookup(
        JSpec("cf_item", ROWS, DIM), jplan(kind), table, mesh=jm,
        cache=JCache(rows=24, **kw)), table, ids)
    np.testing.assert_array_equal(got["rows"], table[ids])
    for k in ("rows", "touched", "stale", "fresh", "miss"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["summary"] == want["summary"]
    assert (got["summary"]["hits"] > 0) == (kw["elect_every"] > 0)


@pytest.mark.parametrize("cfg", [
    dict(plan="row", cache_rows=16, **KNOBS["slow"]),
    dict(plan="col", cache_rows=16, **KNOBS["never"]),
    dict(plan="row_col", cache_rows=0, miss_quantum=5),
    dict(plan="row", cache_rows=16, row_axis="data"),
    dict(plan="col", col_axis="model"),
], ids=["row_slow", "col_never", "row_col_q5", "row_on_data",
        "col_on_model"])
def test_cf_head_config_matches_jax(world1, cfg):
    """``CFConfig``'s cache knobs and axes reach the head's lookups as in
    JAX's head on a 1 x 1 mesh: scores, rankings and the summary equal
    JAX's over 12 requests (gate 0, where the fused scores are exact); a
    column axis other than the DP axis raises JAX's ``ValueError``."""
    from repro import compat
    from repro.serving import CFConfig as JCFConfig, CFHead as JCFHead
    from repro_torch.serving import CFConfig, CFHead
    rng = np.random.default_rng(5)
    u = rng.normal(size=(40, 8)).astype(np.float32)
    it = rng.normal(size=(ROWS, 8)).astype(np.float32)
    jm = compat.make_mesh((1, 1), ("data", "model"))

    def make(head, conf, mesh, **kw):
        return head(u, it, cfg=conf(**cfg), mesh=mesh, **kw)

    if cfg.get("col_axis") == "model":
        assert _raises(lambda: make(CFHead, CFConfig, world1,
                                    device="cpu")) == \
            _raises(lambda: make(JCFHead, JCFConfig, jm))
        return
    head = make(CFHead, CFConfig, world1, device="cpu")
    jhead = make(JCFHead, JCFConfig, jm)
    for r in range(12):
        cands = list(_zipf_ids(10, ROWS, seed=100 + r))
        lm = rng.normal(size=ROWS).astype(np.float32)
        got = head.score(r % 40, cands, torch.from_numpy(lm))
        want = jhead.score(r % 40, cands, lm)
        for k in ("cf", "fused", "ranking"):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
        assert (got["hits"], got["misses"]) == \
            (want["hits"], want["misses"])
    assert json.dumps(head.summary(), sort_keys=True, default=float) == \
        json.dumps(jhead.summary(), sort_keys=True, default=float)


@pytest.mark.parametrize("kind,axes", [
    ("row", dict(row_axis="data")), ("row_col", dict(row_axis="data",
                                                     col_axis="model"))],
    ids=["row_on_data", "col_on_model"])
def test_make_cached_lookup_axes_match_jax(world1, kind, axes):
    """``make_cached_lookup``'s axes reach the plan as in JAX's: a row
    shard over ``data`` looks up what JAX's does on a 1 x 1 mesh; a
    column axis other than the DP axis raises JAX's ``ValueError``."""
    from repro import compat
    from repro.embeddings import make_cached_lookup as jmake
    from repro_torch.embeddings import make_cached_lookup
    jm = compat.make_mesh((1, 1), ("data", "model"))
    table = _lookup_inputs()[0]
    if axes.get("col_axis") == "model":
        assert _raises(lambda: make_cached_lookup(
            "t", table, kind, device="cpu", mesh=world1, **axes)) == \
            _raises(lambda: jmake("t", table, kind, mesh=jm, **axes))
        return
    lk = make_cached_lookup("t", table, kind, device="cpu", mesh=world1,
                            **axes)
    jlk = jmake("t", table, kind, mesh=jm, **axes)
    assert dataclasses.astuple(lk.plan) == dataclasses.astuple(jlk.plan)
    ids = _zipf_ids(40, ROWS, seed=3)
    got = lk(ids)[0]
    np.testing.assert_array_equal(got, jlk(ids)[0])
    np.testing.assert_array_equal(got, table[ids])
    assert lk.summary() == jlk.summary()


# -- the serving engine with a sharded CF head -------------------------------

CF_TRAFFIC = dict(n_requests=10, rate=200.0, vocab_size=256, n_users=100,
                  candidates=12, prompt_max=16, new_tokens_max=6, seed=2)
CF_ECFG = dict(n_slots=3, max_len=32)


@pytest.fixture(scope="module")
def cf_model():
    import jax
    from repro.config import get_arch as jget_arch, reduced as jreduced
    from repro.models import transformer as jtf
    from repro.serving import CFHead as JCFHead
    from repro_torch import convert
    from repro_torch.config import get_arch, reduced
    jcfg = dataclasses.replace(jreduced(jget_arch("recllm-base")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch("recllm-base")),
                               dtype="float32")
    tparams = convert.params_from_numpy(jax.tree.map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg)),
        device="cpu")
    jhead = JCFHead.build(n_users=100, n_items=256, cf_dim=8)
    tables = (jhead.lookups["cf_user"]._host, jhead.lookups["cf_item"]._host)
    return tcfg, tparams, tables


def _serve(cf_model, mesh, plan, rows):
    from repro_torch.serving import CFConfig, CFHead
    from repro_torch.serving import engine as teng
    from repro_torch.serving import traffic as ttraffic
    tcfg, tparams, (u, it) = cf_model
    head = CFHead(u, it, fusion_gate=0.3,
                  cfg=CFConfig(plan=plan, cache_rows=rows), device="cpu",
                  mesh=mesh)
    eng = teng.ServingEngine(teng.make_backend(tcfg, tparams, device="cpu"),
                             teng.EngineConfig(**CF_ECFG),
                             ttraffic.Clock(0.01, 0.05, None, 0.002),
                             cf_head=head)
    out = eng.run(ttraffic.generate(ttraffic.TrafficConfig(**CF_TRAFFIC)))
    return eng, out


@pytest.fixture(scope="module")
def cf_replicated(world1, cf_model):
    return _serve(cf_model, None, "replicated", 0)


@pytest.mark.parametrize("rows", [0, 32])
@pytest.mark.parametrize("kind", SHARDED)
def test_engine_cf_head_world_of_one(world1, cf_model, cf_replicated, kind,
                                     rows):
    """A sharded head, cached and uncached: token streams, records and
    cf / fused / ranking equal the replicated head's bit for bit; the
    head's summary equals JAX's head, on a 1 x 1 mesh, replaying the
    scored requests' lookups in scoring order."""
    from repro import compat
    from repro.serving import CFHead as JCFHead, CFConfig as JCFConfig
    from repro_torch.serving import traffic as ttraffic
    eng_r, (out_r, recs_r, _) = cf_replicated
    eng, (out, recs, summary) = _serve(cf_model, world1, kind, rows)
    assert out == out_r
    assert [dataclasses.asdict(r) for r in recs] == \
        [dataclasses.asdict(r) for r in recs_r]
    assert eng.cf_results.keys() == eng_r.cf_results.keys()
    for rid, res in eng.cf_results.items():
        for k in ("cf", "fused", "ranking"):
            np.testing.assert_array_equal(res[k], eng_r.cf_results[rid][k])
    _, _, (u, it) = cf_model
    jhead = JCFHead(u, it, fusion_gate=0.3,
                    cfg=JCFConfig(plan=kind, cache_rows=rows),
                    mesh=compat.make_mesh((1, 1), ("data", "model")))
    by_rid = {r.rid: r for r in ttraffic.generate(
        ttraffic.TrafficConfig(**CF_TRAFFIC))}
    for rid in eng.cf_results:
        r = by_rid[rid]
        want = jhead.score(r.user_id, list(r.candidates))
        np.testing.assert_array_equal(eng.cf_results[rid]["cf"], want["cf"])
    assert eng.cf_head.summary() == jhead.summary()
    assert summary["cf"]["plan"] == kind
    assert (summary["cf"]["hits"] > 0) == (rows > 0)


@pytest.mark.parametrize("kind", SHARDED)
def test_serve_launcher_mounts_a_sharded_head(world1, kind, capsys):
    """``--cf-plan row|col|row_col`` serves (on the world this process
    holds: the launcher makes its own world of one only when none is
    initialised)."""
    from repro_torch.launch import serve
    assert serve.main(["--reduced", "--device", "cpu", "--requests", "6",
                       "--candidates", "8", "--cf-plan", kind,
                       "--cf-cache-rows", "16", "--no-warmup"]) == 0
    assert f"cf head: plan={kind} scored=6" in capsys.readouterr().out


def test_serve_launcher_makes_its_world_of_one(tmp_path):
    """A process with no world: the launcher initialises a gloo world of
    one for a sharded plan and serves."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "4", "--candidates", "8",
         "--cf-plan", "row_col", "--no-warmup"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "cf head: plan=row_col scored=4" in proc.stdout


@pytest.mark.parametrize("kind", PLANS)
def test_train_recsys_prints_each_tables_plan_summary(kind, capsys):
    """``--embed-plan``/``--embed-mesh``: JAX's example's lines, from
    ``plan_summary`` of each CF table (skipped where dims do not
    divide)."""
    import argparse
    from repro import embeddings as J
    from repro_torch.config import get_arch, reduced
    from repro_torch.launch import train_recsys
    cfg = dataclasses.replace(reduced(get_arch("recllm-base"), layers=4),
                              vocab_size=1003, vocab_pad_to=64)
    train_recsys.print_embed_plan(cfg, 4001, argparse.Namespace(
        embed_plan=kind, embed_mesh="8,4", batch=32))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    plan, mesh = J.make_plan(kind), {"data": 8, "model": 4}
    for line, (name, rows) in zip(lines, (("cf_user", 4001),
                                          ("cf_item", cfg.padded_vocab))):
        spec = J.EmbedSpec(name, rows, 64)
        assert line.startswith(f"embed[{name}] plan {kind}")
        try:
            s = J.plan_summary(spec, plan, mesh, 4)
        except ValueError as e:
            assert line.endswith(f"skipped ({e})")
            continue
        assert f"shard ({s['shard_rows']},{s['shard_cols']})" in line
        assert f"exchange {s['modeled_exchange_bytes']['total']/1e6:.3f}" \
            in line
