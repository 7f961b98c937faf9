"""The port's serving engine against the JAX engine under a pinned clock.

With ``Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02)`` the schedule is a
pure function of the workload, so the port's ``serve(...)`` on the CPU must
equal the JAX engine's exactly: token streams, every ``RequestRecord``
field, ``decode_steps``/``prefills`` and the whole summary dict (``paged``
and ``kv_bytes_per_step`` included).  Reduced RecLLM-base in float32, JAX
params converted into the port; every cache layout (dense / paged x 16-bit
/ int8) under both decode impls.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

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

ARCH = "recllm-base"
TRAFFIC = dict(n_requests=7, rate=80.0, prompt_max=14, new_tokens_max=6,
               vocab_size=256, seed=3)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(jget_arch(ARCH)), dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch(ARCH)), dtype="float32")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return jcfg, jparams, tcfg, tparams


def _clock(traffic_mod):
    return traffic_mod.Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02)


def _same(a, b):
    """Equality that takes NaN == NaN (empty-sample percentiles)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@pytest.mark.parametrize("cfg", [
    dict(n_requests=24),
    dict(n_requests=24, process="bursty", candidates=4, vocab_size=300,
         interactive_fraction=0.5, seed=7),
])
def test_traffic_is_the_same_workload(cfg):
    jreqs = jtraffic.generate(jtraffic.TrafficConfig(**cfg))
    treqs = ttraffic.generate(ttraffic.TrafficConfig(**cfg))
    assert [dataclasses.asdict(r) for r in treqs] == \
        [dataclasses.asdict(r) for r in jreqs]


@pytest.mark.parametrize("refill", ["continuous", "static"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_engine_matches_jax_under_pinned_clock(model, refill, impl):
    jcfg, jparams, tcfg, tparams = model
    jout, jrecs, jsum = jeng.serve(
        jcfg, jparams, jtraffic.generate(jtraffic.TrafficConfig(**TRAFFIC)),
        jeng.EngineConfig(n_slots=3, max_len=32, refill=refill,
                          layout=JLayout(impl=impl)),
        clock=_clock(jtraffic))
    tout, trecs, tsum = teng.serve(
        tcfg, tparams, ttraffic.generate(ttraffic.TrafficConfig(**TRAFFIC)),
        teng.EngineConfig(n_slots=3, max_len=32, refill=refill,
                          layout=CacheLayout(impl=impl)),
        clock=_clock(ttraffic), device="cpu")
    assert tout == jout
    assert [dataclasses.asdict(r) for r in trecs] == \
        [dataclasses.asdict(r) for r in jrecs]
    assert (tsum["decode_steps"], tsum["prefills"]) == \
        (jsum["decode_steps"], jsum["prefills"])
    assert _same(tsum, jsum), (tsum, jsum)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("layout", [
    dict(kind="paged", block_size=8),
    dict(kv_bits=8),
    dict(kind="paged", kv_bits=8, block_size=8),
], ids=["paged", "int8", "paged_int8"])
def test_layouts_match_jax_under_pinned_clock(model, layout, impl):
    jcfg, jparams, tcfg, tparams = model
    ecfg = dict(n_slots=3, max_len=32)
    jout, jrecs, jsum = jeng.serve(
        jcfg, jparams, jtraffic.generate(jtraffic.TrafficConfig(**TRAFFIC)),
        jeng.EngineConfig(layout=JLayout(impl=impl, **layout), **ecfg),
        clock=_clock(jtraffic))
    tout, trecs, tsum = teng.serve(
        tcfg, tparams, ttraffic.generate(ttraffic.TrafficConfig(**TRAFFIC)),
        teng.EngineConfig(layout=CacheLayout(impl=impl, **layout), **ecfg),
        clock=_clock(ttraffic), device="cpu")
    assert tout == jout
    assert [dataclasses.asdict(r) for r in trecs] == \
        [dataclasses.asdict(r) for r in jrecs]
    assert ("paged" in tsum) == (layout.get("kind") == "paged")
    assert _same(tsum, jsum), (tsum, jsum)


def test_outside_the_slice_raises(model):
    """Paged and int8 layouts, speculative decode, the CF head and the
    metrics registry are served now; sampled decode (with or without
    speculation), streaming prefill (alone or through the int8/paged
    compositions) and engine roles still raise, naming ROADMAP.md."""
    _, _, tcfg, tparams = model
    reqs = ttraffic.generate(ttraffic.TrafficConfig(**TRAFFIC))
    sampled = [dataclasses.replace(reqs[0], temperature=0.7)]
    for ecfg in (teng.EngineConfig(), teng.EngineConfig(spec_k=2)):
        with pytest.raises(NotImplementedError, match="sampled"):
            teng.serve(tcfg, tparams, sampled, ecfg, device="cpu")
    _, _, summary = teng.serve(
        tcfg, tparams, reqs, teng.EngineConfig(max_len=32, spec_k=2),
        device="cpu")
    assert summary["finished"] == len(reqs) and summary["spec"]["k"] == 2
    for ecfg in (teng.EngineConfig(prefill_chunk=8),
                 teng.EngineConfig(prefill_chunk=8,
                                   layout=CacheLayout(kind="paged")),
                 teng.EngineConfig(prefill_chunk=8,
                                   layout=CacheLayout(kv_bits=8))):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            teng.serve(tcfg, tparams, reqs, ecfg, device="cpu")
    for layout in (CacheLayout(kind="paged"), CacheLayout(kv_bits=8)):
        teng.serve(tcfg, tparams, reqs[:1],
                   teng.EngineConfig(n_slots=1, max_len=32, layout=layout),
                   device="cpu")
    backend = teng.make_backend(tcfg, tparams, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        teng.ServingEngine(backend, teng.EngineConfig(), role="prefill")
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import CFHead
    teng.ServingEngine(backend, teng.EngineConfig(),
                       cf_head=CFHead.build(n_users=4, n_items=8,
                                            device="cpu"),
                       metrics=MetricsRegistry())
