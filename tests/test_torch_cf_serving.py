"""The port's CF head serving against the JAX package on the CPU.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``:
the hot-row cache pieces fed one id stream (counts, elected ids, rows,
hits and misses equal; rows bit-equal to ``table[ids]``), ``CFHead.score``
with the JAX head's tables carried over (everything exactly equal at
``fusion_gate=0.0``; at 0.3 ``fused`` within rtol = atol = 1e-6 and the
ranking equal), and the serving engine with a CF head on reduced
RecLLM-base in float32 under a pinned clock (token streams, the CF scores,
rankings and counts, the summary, and the traced events and registry
exactly; the fused scores, which add each package's own LM logits, within
1e-5).  On CPU tensors the miss gathers run the ``gather_rows`` kernel's
plain version; ``chip_smoke.py`` runs the CUDA kernel on this path on the
GPU.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.config import reduced as jreduced
from repro.embeddings import CacheConfig as JCacheConfig
from repro.embeddings import CachedLookup as JCachedLookup
from repro.embeddings import EmbedSpec as JEmbedSpec
from repro.embeddings import FreqTracker as JFreqTracker
from repro.embeddings import HotRowCache as JHotRowCache
from repro.embeddings import init_table as jinit_table
from repro.embeddings import make_plan as jmake_plan
from repro.models import transformer as jtf
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.serving import CFHead as JCFHead
from repro.serving import engine as jeng
from repro.serving import traffic as jtraffic
from repro_torch import convert
from repro_torch.config import get_arch, reduced
from repro_torch.embeddings import (CacheConfig, CachedLookup, EmbedSpec,
                                    FreqTracker, HotRowCache, make_plan)
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving import CFConfig, CFHead
from repro_torch.serving import engine as teng
from repro_torch.serving import traffic as ttraffic

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS, DIM = 96, 16


@pytest.fixture(scope="module")
def table():
    return np.asarray(jinit_table(jax.random.PRNGKey(0),
                                  JEmbedSpec("cf_item", rows=ROWS, dim=DIM)))


def _zipf_ids(n, rows, seed=0, a=1.3):
    rng = np.random.default_rng(seed)
    return np.clip(rng.zipf(a, size=n), 1, rows) - 1


def _same(a, b):
    """Equality over nested dicts that takes NaN == NaN."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


# ---------------------------------------------------------------------------
# (a) FreqTracker / HotRowCache / CachedLookup against the reference's
# ---------------------------------------------------------------------------

def test_freq_tracker_matches_reference():
    ids = _zipf_ids(400, 40, seed=2)
    tr, jtr = FreqTracker(40, decay=0.9), JFreqTracker(40, decay=0.9)
    for lo in range(0, len(ids), 25):
        tr.observe(ids[lo:lo + 25])
        jtr.observe(ids[lo:lo + 25])
        np.testing.assert_array_equal(tr.counts, jtr.counts)
        for k in (0, 1, 5, 40):
            np.testing.assert_array_equal(tr.top_k(k), jtr.top_k(k))


def test_hot_row_cache_matches_reference(table):
    cache, jcache = HotRowCache(ROWS, 12), JHotRowCache(ROWS, 12)
    stale = table.copy()
    stale[::3] += 1.0
    for step, lo in enumerate(range(0, 320, 32)):
        chunk = _zipf_ids(320, ROWS, seed=4)[lo:lo + 32]
        for c in (cache, jcache):
            c.tracker.observe(chunk)
            c.refresh(stale if step % 2 else table)
        np.testing.assert_array_equal(cache.ids, jcache.ids)
        np.testing.assert_array_equal(cache.rows, jcache.rows)
        hit, slots = cache.plan_lookup(chunk)
        jhit, jslots = jcache.plan_lookup(chunk)
        np.testing.assert_array_equal(hit, jhit)
        np.testing.assert_array_equal(slots, jslots)
    for c in (cache, jcache):
        c.refresh_touched(np.arange(0, ROWS, 3), table)
    np.testing.assert_array_equal(cache.rows, jcache.rows)
    assert (cache.hits, cache.misses) == (jcache.hits, jcache.misses)


@pytest.mark.parametrize("rows", [0, 24])
def test_cached_lookup_matches_reference(table, rows):
    spec = EmbedSpec("cf_item", rows=ROWS, dim=DIM)
    lk = CachedLookup(spec, make_plan("replicated"), table, device="cpu",
                      cache=CacheConfig(rows=rows))
    jlk = JCachedLookup(JEmbedSpec("cf_item", rows=ROWS, dim=DIM),
                        jmake_plan("replicated"), table,
                        cache=JCacheConfig(rows=rows))
    ids = _zipf_ids(256, ROWS)
    for lo in range(0, len(ids), 32):
        chunk = ids[lo:lo + 32]
        got, stats = lk(chunk)
        want, jstats = jlk(chunk)
        assert stats == jstats
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, table[chunk])
        np.testing.assert_array_equal(lk.cache.ids if rows else [],
                                      jlk.cache.ids if rows else [])
    assert lk.summary() == jlk.summary()
    assert (lk.hits > 0) == (rows > 0)


def test_update_rows_staleness_matches_reference(table):
    spec = EmbedSpec("cf_item", rows=ROWS, dim=DIM)
    ids = _zipf_ids(128, ROWS, seed=3)
    lk = CachedLookup(spec, make_plan("replicated"), table, device="cpu",
                      cache=CacheConfig(rows=24))
    jlk = JCachedLookup(JEmbedSpec("cf_item", rows=ROWS, dim=DIM),
                        jmake_plan("replicated"), table,
                        cache=JCacheConfig(rows=24))
    lk(ids)
    jlk(ids)
    hot = np.asarray(jlk.cache.ids)
    np.testing.assert_array_equal(lk.cache.ids, hot)
    new_rows = np.full((hot.size, DIM), 7.5, np.float32)
    # refresh=False: cached rows stay stale across lookups and elections
    touched = lk.update_rows(hot, new_rows, refresh=False)
    jtouched = jlk.update_rows(hot, new_rows, refresh=False)
    np.testing.assert_array_equal(touched, jtouched)
    got, _ = lk(hot)
    want, _ = jlk(hot)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, new_rows)
    # the rows-touched refresh restores exactness
    lk.refresh_touched(hot)
    jlk.refresh_touched(hot)
    got, _ = lk(hot)
    want, _ = jlk(hot)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, new_rows)
    # refresh=True is exact at once; a miss reads the updated device table
    fresh = np.full((2, DIM), -1.25, np.float32)
    cold = np.setdiff1d(np.arange(ROWS), hot)[:2]
    lk.update_rows(np.concatenate([hot[:2], cold]),
                   np.concatenate([fresh, fresh]))
    got, _ = lk(np.concatenate([hot[:2], cold]))
    np.testing.assert_array_equal(got, np.concatenate([fresh, fresh]))


# ---------------------------------------------------------------------------
# (b) CFHead.score against the JAX head, tables carried over
# ---------------------------------------------------------------------------

def _heads(gate, cache_rows, n_users=100, n_items=64, cf_dim=8):
    jhead = JCFHead.build(n_users=n_users, n_items=n_items, cf_dim=cf_dim,
                          plan="replicated", cache_rows=cache_rows,
                          fusion_gate=gate)
    head = CFHead(jhead.lookups["cf_user"]._host,
                  jhead.lookups["cf_item"]._host, fusion_gate=gate,
                  cfg=CFConfig(cache_rows=cache_rows), device="cpu")
    return jhead, head


@pytest.mark.parametrize("gate", [0.0, 0.3])
@pytest.mark.parametrize("cache_rows", [0, 32])
def test_cf_head_score_matches_reference(gate, cache_rows):
    jhead, head = _heads(gate, cache_rows)
    rng = np.random.default_rng(7)
    for i in range(12):
        user = int(rng.integers(0, 100))
        cand = _zipf_ids(10, 64, seed=100 + i)
        row = rng.standard_normal(64).astype(np.float32)
        lm = None if i % 4 == 3 else row
        got = head.score(user, cand, None if lm is None
                         else torch.from_numpy(lm))
        want = jhead.score(user, cand, lm)
        np.testing.assert_array_equal(got["cf"], want["cf"])
        assert (got["hits"], got["misses"]) == \
            (want["hits"], want["misses"])
        if gate == 0.0:
            np.testing.assert_array_equal(got["fused"], want["fused"])
        else:
            np.testing.assert_allclose(got["fused"], want["fused"],
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["ranking"], want["ranking"])
        assert sorted(got["ranking"]) == sorted(cand)
    assert _same(head.summary(), jhead.summary())


# ---------------------------------------------------------------------------
# (c) the engine with a CF head against the JAX engine, pinned clock
# ---------------------------------------------------------------------------

ARCH = "recllm-base"
CF_TRAFFIC = dict(n_requests=10, rate=200.0, vocab_size=256, n_users=100,
                  candidates=12, prompt_max=16, new_tokens_max=6, seed=2)
CF_ECFG = dict(n_slots=3, max_len=32)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(jget_arch(ARCH)), dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch(ARCH)), dtype="float32")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return jcfg, jparams, tcfg, tparams


def _clock(traffic_mod):
    return traffic_mod.Clock(0.01, 0.05, None, 0.002)


def _serve_jax(model, head, traced):
    jcfg, jparams, _, _ = model
    tracer, reg = (JTracer(), JRegistry()) if traced else (None, None)
    eng = jeng.ServingEngine(jeng.make_backend(jcfg, jparams),
                             jeng.EngineConfig(**CF_ECFG), _clock(jtraffic),
                             tracer=tracer, metrics=reg, cf_head=head)
    out = eng.run(jtraffic.generate(jtraffic.TrafficConfig(**CF_TRAFFIC)))
    return eng, out, tracer, reg


def _serve_port(model, head, traced):
    _, _, tcfg, tparams = model
    tracer, reg = (Tracer(), MetricsRegistry()) if traced else (None, None)
    eng = teng.ServingEngine(teng.make_backend(tcfg, tparams, device="cpu"),
                             teng.EngineConfig(**CF_ECFG), _clock(ttraffic),
                             tracer=tracer, metrics=reg, cf_head=head)
    out = eng.run(ttraffic.generate(ttraffic.TrafficConfig(**CF_TRAFFIC)))
    return eng, out, tracer, reg


def _same_results(a, b):
    """CF scores, rankings and counts exactly; the fused scores within
    1e-5: they add the two packages' float32 LM logits, which agree to
    float32 rounding, not bit for bit."""
    assert a.keys() == b.keys()
    for rid in a:
        for k in ("cf", "ranking"):
            np.testing.assert_array_equal(a[rid][k], b[rid][k])
        np.testing.assert_allclose(a[rid]["fused"], b[rid]["fused"],
                                   rtol=1e-5, atol=1e-5)
        assert (a[rid]["hits"], a[rid]["misses"]) == \
            (b[rid]["hits"], b[rid]["misses"])


def _same_events(got, want, tol=1e-12):
    assert len(got) == len(want)
    for e, f in zip(got, want):
        assert (e["ph"], e["name"], e["track"]) == \
            (f["ph"], f["name"], f["track"])
        assert e["args"] == f["args"], (e, f)
        assert e["ts"] == pytest.approx(f["ts"], abs=tol)
        if e["ph"] == "X":
            assert e["dur"] == pytest.approx(f["dur"], abs=tol)
            assert e["depth"] == f["depth"]


@pytest.fixture(scope="module")
def cf_runs(model):
    runs = {}
    for rows in (0, 32):
        jhead, head = _heads(0.3, rows, n_users=100, n_items=256, cf_dim=8)
        traced = rows > 0
        runs[rows] = (_serve_jax(model, jhead, traced),
                      _serve_port(model, head, traced))
    return runs


@pytest.mark.parametrize("rows", [0, 32])
def test_engine_cf_matches_jax(cf_runs, rows):
    (jeng_, (jout, jrecs, jsum), jtr, jreg), \
        (teng_, (tout, trecs, tsum), ttr, treg) = cf_runs[rows]
    assert tout == jout
    assert [dataclasses.asdict(r) for r in trecs] == \
        [dataclasses.asdict(r) for r in jrecs]
    _same_results(teng_.cf_results, jeng_.cf_results)
    assert teng_.cf_scored == jeng_.cf_scored == CF_TRAFFIC["n_requests"]
    assert _same(tsum["cf"], jsum["cf"])
    assert _same(tsum, jsum), (tsum, jsum)
    if rows:
        assert tsum["cf"]["hits"] > 0
        _same_events(ttr.events, jtr.events)
        assert _same(treg.snapshot(), jreg.snapshot())
    else:
        assert tsum["cf"]["hits"] == 0 and "obs" not in tsum


def test_engine_cf_cached_equals_uncached(cf_runs):
    (_, _, _, _), (eng_u, (out_u, _, _), _, _) = cf_runs[0]
    (_, _, _, _), (eng_c, (out_c, _, sum_c), tracer, reg) = cf_runs[32]
    assert out_c == out_u
    for rid, ru in eng_u.cf_results.items():
        rc = eng_c.cf_results[rid]
        for k in ("cf", "fused", "ranking"):
            np.testing.assert_array_equal(rc[k], ru[k])
    counters = reg.snapshot()["counters"]
    head = eng_c.cf_head
    assert counters["cf_cache.hits"] + counters["cf_cache.misses"] == \
        head.hits + head.misses
    # the CF time lands inside req.prefill: TTFT still equals the spans
    spans = {}
    for e in tracer.events:
        if e["ph"] == "X" and "rid" in e["args"]:
            spans.setdefault(e["args"]["rid"], {})[e["name"]] = e
    for r in eng_c.records:
        if r.finished is None:
            continue
        sp = spans[r.rid]
        cf, pf = sp["cf.lookup"], sp["req.prefill"]
        assert pf["ts"] <= cf["ts"]
        assert cf["ts"] + cf["dur"] <= pf["ts"] + pf["dur"] + 1e-9
        ttft = sp["req.queue_wait"]["dur"] + pf["dur"]
        assert ttft == pytest.approx(r.ttft, abs=1e-9)
    assert sum_c["obs"]["span_counts"]["cf.lookup"] == \
        CF_TRAFFIC["n_requests"]


def test_engine_without_candidates_skips_cf(model):
    _, _, tcfg, tparams = model
    head = CFHead.build(n_users=100, n_items=256, cf_dim=8, device="cpu")
    reqs = ttraffic.generate(ttraffic.TrafficConfig(
        **dict(CF_TRAFFIC, candidates=0, n_requests=4)))
    eng = teng.ServingEngine(teng.make_backend(tcfg, tparams, device="cpu"),
                             teng.EngineConfig(**CF_ECFG), _clock(ttraffic),
                             cf_head=head)
    _, _, summary = eng.run(reqs)
    assert eng.cf_results == {}
    assert summary["cf"]["requests_scored"] == 0


# ---------------------------------------------------------------------------
# (g) the launcher's CF and trace flags on the CPU
# ---------------------------------------------------------------------------

def test_launcher_cf_and_trace_flags(tmp_path):
    out = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--candidates", "8", "--cf-plan", "replicated",
         "--trace-out", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "cf head: plan=replicated scored=32" in proc.stdout
    events = json.loads(out.read_text())["traceEvents"]
    assert sum(e["name"] == "cf.lookup" for e in events) == 32
    for e in events:
        assert {"ph", "ts", "pid", "tid"} <= set(e)
