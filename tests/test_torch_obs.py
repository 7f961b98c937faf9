"""The port's observability layer and engine wiring against the JAX package
on the CPU, and the dense uniform archs it brings along.

* Unit parity: the same calls into both packages' ``Tracer``,
  ``MetricsRegistry`` and exporters give equal events, snapshots and
  Chrome-trace objects.
* Engine spans on reduced olmo-1b (float32, paged, 8-row blocks) under a
  pinned clock, on the workload of ``tests/test_obs.py`` and on one that
  fires every scheduler instant (rejects, a shed, pushbacks,
  copy-on-write): the port's tracer events equal the JAX engine's event
  for event (names, tracks and args exactly; ``ts``/``dur`` within
  1e-12), the registry snapshots are equal, and spans reconcile with
  TTFT/TPOT.  An untraced summary has no ``obs``.
* Greedy engine streams, records and summaries equal JAX's for reduced
  deepseek-7b, internlm2-20b and olmo-1b (JAX params converted).
"""
import dataclasses
import gc
import json
import math
import weakref

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.cache_layout import CacheLayout as JLayout
from repro.config import get_arch as jget_arch
from repro.config import reduced as jreduced
from repro.models import transformer as jtf
from repro.serving import engine as jeng
from repro.serving import traffic as jtraffic
from repro_torch import convert
from repro_torch.cache_layout import CacheLayout
from repro_torch.config import get_arch, reduced
from repro_torch.serving import engine as teng
from repro_torch.serving import traffic as ttraffic

torch.set_num_threads(2)


def _same(a, b):
    """Equality over nested dicts/lists that takes NaN == NaN."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


# ---------------------------------------------------------------------------
# (d) tracer / registry / exporter unit parity
# ---------------------------------------------------------------------------

def _drive(obs, capacity):
    """One script of calls into a package's obs layer."""
    clk = obs.ManualClock(1.5)
    tr = obs.Tracer(capacity=capacity, clock=clk)
    reg = obs.MetricsRegistry(clock=clk)
    with tr.span("outer", track="t", step=1):
        clk.advance(0.25)
        with tr.span("inner", track="t"):
            clk.advance(0.125)
            tr.instant("sched.admit", track="sched", rid=3, slot=0)
        reg.gauge("pool.used_blocks").set(4)
        clk.advance(0.5)
    tr.complete("req.prefill", 0.5, 2.0, track="slot0", rid=3)
    tr.complete("backwards", 3.0, 2.0, track="slot1")
    off = obs.Tracer(enabled=False, clock=clk)
    assert off.span("x") is obs.Tracer(enabled=False).span("y")
    off.instant("x")
    off.complete("x", 0.0, 1.0)
    assert off.events == [] and obs.or_null(None) is obs.NULL_TRACER
    reg.counter("pool.cow_events").inc()
    reg.counter("pool.cow_events").inc(2)
    reg.gauge("pool.used_blocks").set(1, t=9.0)
    h = reg.histogram("engine.ttft_window", max_samples=4)
    for x in (0.3, 0.1, 0.7, 0.2, 5.0, 0.05):
        h.observe(x)
    wide = reg.histogram("lat")
    for x in np.random.default_rng(0).exponential(0.01, 50):
        wide.observe(x)
    reg.histogram("empty")
    pct = [obs.percentile([0.3, 0.1, 0.7, 0.2], q) for q in (0, 37, 50, 99)]
    bucket = [h.percentile(q) for q in (10, 50, 90)]
    return tr, reg, pct + bucket + [tr.span_names(), tr.capacity]


@pytest.mark.parametrize("capacity", [3, 64])
def test_tracer_registry_and_export_match_reference(capacity, tmp_path):
    ttr, treg, tvals = _drive(tobs, capacity)
    jtr, jreg, jvals = _drive(jobs, capacity)
    assert ttr.events == jtr.events
    assert _same(treg.snapshot(), jreg.snapshot())
    assert _same(tvals, jvals)
    assert tobs.DEFAULT_BOUNDS == jobs.DEFAULT_BOUNDS
    assert tobs.chrome_trace(ttr, treg) == jobs.chrome_trace(jtr, jreg)
    assert tobs.chrome_trace(ttr) == jobs.chrome_trace(jtr)
    for suffix in (".json", ".jsonl"):
        a, b = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
        assert tobs.write_trace(str(a), ttr, treg) == \
            jobs.write_trace(str(b), jtr, jreg)
        assert a.read_text() == b.read_text()
    json.loads((tmp_path / "t.json").read_text())


# ---------------------------------------------------------------------------
# (e) engine spans on reduced olmo-1b, paged, against the JAX engine
# ---------------------------------------------------------------------------

def _models(arch):
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def olmo():
    return _models("olmo-1b")


def _span_requests(traffic_mod, vocab):
    """The workload of ``tests/test_obs.py``'s engine span test."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(6):
        reqs.append(traffic_mod.Request(
            rid=i, user_id=i,
            prompt=tuple(int(t) for t in
                         rng.integers(3, vocab, int(rng.integers(4, 12)))),
            max_new_tokens=int(rng.integers(3, 8)),
            arrival=0.002 * i))
    return reqs


def _pressure_requests(traffic_mod, vocab):
    """Every scheduler instant: shared 20-token prompts (prefix hits and
    copy-on-write), a pool too small for them all (pushback), a bounded
    queue (queue_full rejects, an interactive arrival shedding a batch
    one) and a prompt longer than the window."""
    rng = np.random.default_rng(1)
    shared = tuple(int(t) for t in rng.integers(3, vocab, 20))
    reqs = [traffic_mod.Request(rid=i, user_id=i, prompt=shared,
                                max_new_tokens=6, arrival=0.0)
            for i in range(4)]
    reqs += [traffic_mod.Request(
        rid=4 + i, user_id=4 + i,
        prompt=tuple(int(t) for t in rng.integers(3, vocab, 9)),
        max_new_tokens=5, arrival=0.0,
        slo=traffic_mod.INTERACTIVE_TIER if i == 3 else
        traffic_mod.BATCH_TIER) for i in range(4)]
    reqs.append(traffic_mod.Request(rid=8, user_id=8,
                                    prompt=tuple(range(3, 70)),
                                    max_new_tokens=2, arrival=0.001))
    return reqs


WORKLOADS = {
    "spans": (_span_requests, dict(kind="paged", block_size=8),
              dict(n_slots=2, max_len=64)),
    "pressure": (_pressure_requests,
                 dict(kind="paged", block_size=8, num_blocks=7),
                 dict(n_slots=3, max_len=64, queue_capacity=5)),
}


@pytest.fixture(scope="module", params=sorted(WORKLOADS))
def traced_runs(olmo, request):
    jcfg, jparams, tcfg, tparams = olmo
    make_reqs, layout_kw, ecfg_kw = WORKLOADS[request.param]
    out = {}
    for pkg, eng, traffic, obs, layout_cls, cfg, params, kw in (
            ("jax", jeng, jtraffic, jobs, JLayout, jcfg, jparams, {}),
            ("torch", teng, ttraffic, tobs, CacheLayout, tcfg, tparams,
             {"device": "cpu"})):
        layout = layout_cls(**layout_kw)
        tracer, registry = obs.Tracer(), obs.MetricsRegistry()
        engine = eng.ServingEngine(
            eng.make_backend(cfg, params, layout=layout, **kw),
            eng.EngineConfig(layout=layout, **ecfg_kw),
            clock=traffic.Clock(fixed_decode_s=1e-3, fixed_prefill_s=5e-3),
            tracer=tracer, metrics=registry)
        outputs, records, summary = engine.run(
            make_reqs(traffic, cfg.vocab_size))
        out[pkg] = (outputs, records, summary, tracer, registry)
    out["workload"] = request.param
    return out


def test_engine_events_match_jax(traced_runs):
    jout, jrecs, jsum, jtr, jreg = traced_runs["jax"]
    tout, trecs, tsum, ttr, treg = traced_runs["torch"]
    assert tout == jout
    assert [dataclasses.asdict(r) for r in trecs] == \
        [dataclasses.asdict(r) for r in jrecs]
    assert len(ttr.events) == len(jtr.events)
    for e, f in zip(ttr.events, jtr.events):
        assert (e["ph"], e["name"], e["track"]) == \
            (f["ph"], f["name"], f["track"])
        assert e["args"] == f["args"], (e, f)
        assert e["ts"] == pytest.approx(f["ts"], abs=1e-12)
        if e["ph"] == "X":
            assert e["dur"] == pytest.approx(f["dur"], abs=1e-12)
            assert e["depth"] == f["depth"]
    assert _same(treg.snapshot(), jreg.snapshot())
    assert _same(tsum, jsum), (tsum, jsum)
    names = ttr.span_names()
    want = ["sched.admit", "req.prefill", "decode_step"]
    if traced_runs["workload"] == "pressure":
        want += ["sched.reject", "sched.shed", "sched.pushback", "pool.cow"]
    for name in want:
        assert names.get(name, 0) > 0, (name, names)


def test_engine_spans_reconcile_with_ttft_tpot(traced_runs):
    _, records, summary, tracer, registry = traced_runs["torch"]
    spans = {}
    for e in tracer.events:
        if e["ph"] == "X" and e["name"].startswith("req."):
            spans.setdefault(e["args"]["rid"], {})[e["name"]] = e
    finished = [r for r in records if r.finished is not None]
    assert finished
    for r in finished:
        sp = spans[r.rid]
        assert set(sp) == {"req.queue_wait", "req.prefill", "req.decode"}
        ttft = sp["req.queue_wait"]["dur"] + sp["req.prefill"]["dur"]
        assert ttft == pytest.approx(r.ttft, abs=1e-12)
        if r.tpot is not None:
            tpot = sp["req.decode"]["dur"] / (r.tokens_out - 1)
            assert tpot == pytest.approx(r.tpot, abs=1e-12)
        assert len({e["track"] for e in sp.values()}) == 1
    steps = [e for e in tracer.events if e["name"] == "decode_step"]
    assert len(steps) == summary["decode_steps"]
    assert steps[0]["args"]["attn_read_bytes"] > 0
    assert steps[0]["args"]["model_flops"] > 0
    snap = registry.snapshot()
    assert snap["gauges"]["pool.used_blocks"]["peak"] > 0
    assert snap["gauges"]["engine.active_slots"]["peak"] == \
        summary["max_concurrent_slots"]
    for e in tobs.chrome_trace(tracer, registry)["traceEvents"]:
        assert {"ph", "ts", "pid", "tid"} <= set(e)


def test_untraced_engine_summary_has_no_obs(olmo):
    _, _, tcfg, tparams = olmo
    reqs = [ttraffic.Request(rid=0, user_id=0, prompt=(5, 6, 7),
                             max_new_tokens=3, arrival=0.0)]
    engine = teng.ServingEngine(teng.make_backend(tcfg, tparams,
                                                  device="cpu"),
                                teng.EngineConfig(n_slots=1, max_len=32))
    _, _, summary = engine.run(reqs)
    assert "obs" not in summary
    assert not engine.tracer.enabled


def test_untraced_engine_leaves_the_shared_tracer_alone(olmo):
    """An engine without a tracer does not rebind the shared no-op
    tracer's clock, so the tracer holds no reference to a dropped engine
    (its KV cache and tables would stay allocated)."""
    _, _, tcfg, tparams = olmo
    clock = tobs.NULL_TRACER.clock
    engine = teng.ServingEngine(teng.make_backend(tcfg, tparams,
                                                  device="cpu"),
                                teng.EngineConfig(n_slots=1, max_len=32))
    engine.run([ttraffic.Request(rid=0, user_id=0, prompt=(5, 6, 7),
                                 max_new_tokens=2, arrival=0.0)])
    assert engine.tracer is tobs.NULL_TRACER
    assert tobs.NULL_TRACER.clock is clock
    ref = weakref.ref(engine)
    del engine
    gc.collect()
    assert ref() is None


# ---------------------------------------------------------------------------
# (f) the dense uniform archs: greedy engine streams equal JAX's
# ---------------------------------------------------------------------------

TRAFFIC = dict(n_requests=6, rate=80.0, prompt_max=14, new_tokens_max=6,
               vocab_size=256, seed=5)


@pytest.mark.parametrize("arch", ["deepseek-7b", "internlm2-20b",
                                  "olmo-1b"])
def test_dense_arch_streams_match_jax(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    ecfg = dict(n_slots=3, max_len=32)
    jout, jrecs, jsum = jeng.serve(
        jcfg, jparams, jtraffic.generate(jtraffic.TrafficConfig(**TRAFFIC)),
        jeng.EngineConfig(**ecfg),
        clock=jtraffic.Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02))
    tout, trecs, tsum = teng.serve(
        tcfg, tparams, ttraffic.generate(ttraffic.TrafficConfig(**TRAFFIC)),
        teng.EngineConfig(**ecfg),
        clock=ttraffic.Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02),
        device="cpu")
    assert tout == jout
    assert [dataclasses.asdict(r) for r in trecs] == \
        [dataclasses.asdict(r) for r in jrecs]
    assert _same(tsum, jsum), (tsum, jsum)
