"""The port's straggler harness (``runtime/straggler.py``) against the JAX
package's: host-side numpy on the same seeds, so every number is equal.

* ``StragglerSim.speeds`` and ``run_policy`` for seeds x policies x
  ``drop_k`` (and a reallocation period), ``compare_policies``;
* the registry equivalence of ``tests/test_obs.py`` (a caller-held
  ``MetricsRegistry`` and ``ManualClock`` see the reported numbers);
* the policy ordering of ``tests/test_core.py``.
"""
import numpy as np
import pytest

from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.trace import ManualClock as JClock
from repro.runtime import straggler as jst
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import ManualClock
from repro_torch.runtime import straggler as tst

SEEDS = (0, 3, 11)
POLICIES = ("uniform", "adaptive", "dropk")


def _sims(seed, **kw):
    args = dict(n_workers=6, hetero_cv=0.4, flaky_prob=0.1, seed=seed, **kw)
    return tst.StragglerSim(**args), jst.StragglerSim(**args)


@pytest.mark.parametrize("seed", SEEDS)
def test_speeds_equal_jax(seed):
    ours, ref = _sims(seed)
    np.testing.assert_array_equal(ours.speeds(40), ref.speeds(40))


@pytest.mark.parametrize("drop_k", [0, 1, 2])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_run_policy_equals_jax(seed, policy, drop_k):
    ours, ref = _sims(seed)
    got = tst.run_policy(ours, 240, 50, policy, drop_k=drop_k,
                         realloc_every=7)
    want = jst.run_policy(ref, 240, 50, policy, drop_k=drop_k,
                          realloc_every=7)
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_compare_policies_equals_jax(seed):
    ours, ref = _sims(seed)
    assert (tst.compare_policies(ours, global_batch=512, steps=120)
            == jst.compare_policies(ref, global_batch=512, steps=120))


def test_straggler_metrics_registry_equivalence():
    sim = tst.StragglerSim(n_workers=4, seed=3)
    base = tst.run_policy(sim, 256, 20, "adaptive")
    reg, clk = MetricsRegistry(), ManualClock()
    out = tst.run_policy(sim, 256, 20, "adaptive", metrics=reg, clock=clk)
    assert out == base                       # same math, caller-held registry
    hist = reg.histogram("straggler.step_time_s")
    assert hist.count == 20
    # the simulated clock ends at the total simulated duration
    assert clk.now == pytest.approx(hist.total)
    assert reg.gauge("straggler.slowest_worker_t").peak > 0
    assert len(reg.gauge("straggler.slowest_worker_t").series) == 20
    # ... and the registry holds what JAX's does
    jreg, jclk = JRegistry(), JClock()
    jst.run_policy(jst.StragglerSim(n_workers=4, seed=3), 256, 20,
                   "adaptive", metrics=jreg, clock=jclk)
    assert clk.now == jclk.now
    assert (list(reg.gauge("straggler.slowest_worker_t").series)
            == list(jreg.gauge("straggler.slowest_worker_t").series))
    assert (reg.counter("straggler.useful_samples").value
            == jreg.counter("straggler.useful_samples").value)


def test_straggler_policies_ordering():
    sim = tst.StragglerSim(n_workers=8, hetero_cv=0.4, flaky_prob=0.1)
    out = tst.compare_policies(sim, global_batch=1024, steps=300)
    # adaptive allocation beats uniform under heterogeneity
    assert out["adaptive"]["throughput"] > out["uniform"]["throughput"]
    # dropk trades useful samples for speed but throughput >= uniform
    assert out["dropk"]["throughput"] > out["uniform"]["throughput"]
    assert out["dropk"]["useful_frac"] < 1.0
    assert out == jst.compare_policies(
        jst.StragglerSim(n_workers=8, hetero_cv=0.4, flaky_prob=0.1),
        global_batch=1024, steps=300)
