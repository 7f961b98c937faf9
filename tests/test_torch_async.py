"""The port's asynchronous DP simulator (``core/async_dp.py``, Eq. 12)
against the JAX package's, on the CPU.

* ``_staleness_schedule`` equal to JAX's for each staleness process;
* ``tests/test_core.py``'s quadratic: the losses of every staleness
  process x tau in {0, 2, 6} x compensated / naive, and of the sync
  baseline, within rtol 1e-5 of JAX's (and an absolute 1e-5 of the run's
  first loss: the linear term carries the loss through 0, where no
  relative tolerance holds; the two packages' dot products round in
  another order);
* both of JAX's property tests, ported (compensated beats naive; zero
  staleness is the sync run);
* reduced RecLLM-base in float32 with params converted from the JAX init:
  sync and tau 2 (straggler, compensated) over 6 batches within rtol 1e-5
  of JAX's losses;
* the ring of snapshots: tau > 0 runs part from the tau = 0 run, and no
  update writes into a snapshot (``params0`` comes back unchanged).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_dp as jad
from repro_torch.core import async_dp as tad

torch.set_num_threads(2)

MODES = ("fixed", "random", "straggler")
TAUS = (0, 2, 6)
RTOL = 1e-5
LR = 0.15


def quad_problem(seed=1):
    """JAX's quadratic (``tests/test_core.py``) and its torch twin on the
    same A and stream."""
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.normal(size=(8, 8)), jnp.float32)
    A = A @ A.T / 8 + jnp.eye(8)
    stream = [jnp.asarray(rng.normal(size=8) * 0.01, jnp.float32)
              for _ in range(60)]
    tA = torch.from_numpy(np.array(A))

    def jloss(p, b):
        return 0.5 * p @ A @ p + b @ p

    def tloss(p, b):
        return 0.5 * p @ tA @ p + b @ p

    return (jloss, stream), (tloss, [torch.from_numpy(np.array(b))
                                     for b in stream])


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * abs(want[0]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tau,workers,seed", [(0, 4, 0), (2, 4, 1),
                                               (6, 3, 2), (5, 8, 7)])
def test_staleness_schedule_equals_jax(mode, tau, workers, seed):
    kw = dict(n_workers=workers, max_staleness=tau, staleness=mode)
    got = tad._staleness_schedule(tad.AsyncConfig(**kw), 50,
                                  np.random.default_rng(seed))
    want = jad._staleness_schedule(jad.AsyncConfig(**kw), 50,
                                   np.random.default_rng(seed))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_staleness_schedule_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        tad._staleness_schedule(tad.AsyncConfig(staleness="poisson"), 4,
                                np.random.default_rng(0))


@pytest.mark.parametrize("compensate", [True, False])
@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("mode", MODES)
def test_async_quadratic_matches_jax(mode, tau, compensate):
    (jloss, jstream), (tloss, tstream) = quad_problem()
    kw = dict(max_staleness=tau, compensate=compensate, lr=LR,
              staleness=mode)
    _, want = jad.simulate_async_sgd(jloss, jnp.ones(8), jstream,
                                     jad.AsyncConfig(**kw))
    p0 = torch.ones(8)
    params, got = tad.simulate_async_sgd(tloss, p0, tstream,
                                         tad.AsyncConfig(**kw))
    _close(got, want)
    assert params.shape == (8,) and torch.equal(p0, torch.ones(8))


def test_sync_quadratic_matches_jax():
    (jloss, jstream), (tloss, tstream) = quad_problem()
    jp, want = jad.simulate_sync_sgd(jloss, jnp.ones(8), jstream, LR)
    tp, got = tad.simulate_sync_sgd(tloss, torch.ones(8), tstream, LR)
    _close(got, want)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=1e-6)


def test_delay_compensation_beats_naive_async():
    _, (loss, stream) = quad_problem()
    p0 = torch.ones(8)
    cfg_c = tad.AsyncConfig(max_staleness=6, compensate=True, lr=LR,
                            staleness="straggler")
    cfg_n = tad.AsyncConfig(max_staleness=6, compensate=False, lr=LR,
                            staleness="straggler")
    _, l_comp = tad.simulate_async_sgd(loss, p0, stream, cfg_c)
    _, l_naive = tad.simulate_async_sgd(loss, p0, stream, cfg_n)
    _, l_sync = tad.simulate_sync_sgd(loss, p0, stream, LR)
    # paper's qualitative ordering: sync <= compensated < naive
    assert l_comp[-1] < l_naive[-1]
    assert l_sync[-1] <= l_comp[-1] + 1e-3


def test_async_converges_with_zero_staleness():
    _, (loss, stream) = quad_problem(2)
    p0 = torch.ones(8)
    cfg = tad.AsyncConfig(max_staleness=0, compensate=True, lr=LR)
    _, l_async = tad.simulate_async_sgd(loss, p0, stream, cfg)
    _, l_sync = tad.simulate_sync_sgd(loss, p0, stream, LR)
    np.testing.assert_allclose(l_async[-1], l_sync[-1], atol=1e-5)
    assert l_async == l_sync               # one snapshot: the sync run


@pytest.mark.parametrize("mode", MODES)
def test_stale_runs_part_from_the_fresh_run(mode):
    """A live ring: the tau > 0 runs' losses part from tau 0's (an aliased
    snapshot would make every stale gradient a fresh one).  The ring's
    slot ``(t - tau) % (S + 1)`` holds the params after update
    ``t - tau``, so a gradient of staleness tau >= 1 is taken tau - 1
    updates back (tau 0: S back), as in JAX: ``fixed`` at S = 2 (tau 1
    throughout), uncompensated, is the fresh run."""
    _, (loss, stream) = quad_problem()
    fresh = tad.simulate_async_sgd(loss, torch.ones(8), stream,
                                   tad.AsyncConfig(max_staleness=0, lr=LR))[1]
    for tau in TAUS[1:]:
        for compensate in (True, False):
            cfg = tad.AsyncConfig(max_staleness=tau, compensate=compensate,
                                  lr=LR, staleness=mode)
            stale = tad.simulate_async_sgd(loss, torch.ones(8), stream,
                                           cfg)[1]
            if (mode, tau, compensate) == ("fixed", 2, False):
                assert stale == fresh
            else:
                assert stale != fresh, (tau, compensate)


def test_snapshots_are_not_written_in_place():
    """Tree params: each snapshot keeps the values its update returned
    (checked through the params0 leaves, which the ring holds first)."""
    _, (loss, stream) = quad_problem()
    p0 = {"a": torch.ones(4), "b": {"c": torch.ones(4)}}
    before = {"a": p0["a"].clone(), "c": p0["b"]["c"].clone()}

    def tree_loss(p, b):
        return loss(torch.cat([p["a"], p["b"]["c"]]), b)

    params, losses = tad.simulate_async_sgd(
        tree_loss, p0, stream, tad.AsyncConfig(max_staleness=6, lr=LR,
                                               staleness="straggler"))
    assert torch.equal(p0["a"], before["a"])
    assert torch.equal(p0["b"]["c"], before["c"])
    flat = torch.cat([params["a"], params["b"]["c"]])
    _, want = tad.simulate_async_sgd(loss, torch.ones(8), stream,
                                     tad.AsyncConfig(max_staleness=6, lr=LR,
                                                     staleness="straggler"))
    assert losses == want and flat.shape == (8,)


# -- reduced RecLLM-base ---------------------------------------------------------

N_USERS, BATCH, SEQ, STEPS = 24, 4, 12, 6


def _recllm():
    from repro import config as jconfig
    from repro.models.transformer import ModelCtx as JCtx
    from repro.recsys import model as jrec
    from repro_torch import config as tconfig, convert
    from repro_torch.models.transformer import ModelCtx as TCtx
    from repro_torch.recsys import model as trec
    jcfg = dataclasses.replace(jconfig.reduced(
        jconfig.get_arch("recllm-base")), dtype="float32")
    tcfg = dataclasses.replace(tconfig.reduced(
        tconfig.get_arch("recllm-base")), dtype="float32")
    jparams = jrec.init_recllm(jax.random.PRNGKey(0), jcfg, N_USERS)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(STEPS):
        lens = rng.integers(SEQ // 3, SEQ + 1, BATCH)
        batches.append({
            "tokens": rng.integers(3, jcfg.vocab_size, (BATCH, SEQ)),
            "targets": rng.integers(3, jcfg.vocab_size, (BATCH, SEQ)),
            "mask": (np.arange(SEQ)[None] < lens[:, None]),
            "user": rng.integers(0, N_USERS, BATCH)})
    batches = [{k: v.astype(np.float32 if k == "mask" else np.int32)
                for k, v in b.items()} for b in batches]
    jctx, tctx = JCtx(attn_chunk=4), TCtx(attn_chunk=4)

    def jloss(p, b):
        return jrec.recllm_loss(jcfg, p, b, jctx)[0]

    def tloss(p, b):
        return trec.recllm_loss(tcfg, p, b, tctx)[0]

    return ((jloss, jparams, [jax.tree.map(jnp.asarray, b) for b in batches]),
            (tloss, tparams, [{k: torch.from_numpy(v) for k, v in b.items()}
                              for b in batches]))


@pytest.fixture(scope="module")
def recllm():
    return _recllm()


@pytest.mark.parametrize("run", ["sync", "straggler_tau2"])
def test_recllm_matches_jax(recllm, run):
    (jloss, jparams, jb), (tloss, tparams, tb) = recllm
    if run == "sync":
        _, want = jad.simulate_sync_sgd(jloss, jparams, jb, 1e-3)
        _, got = tad.simulate_sync_sgd(tloss, tparams, tb, 1e-3)
    else:
        kw = dict(max_staleness=2, compensate=True, lr=1e-3,
                  staleness="straggler")
        _, want = jad.simulate_async_sgd(jloss, jparams, jb,
                                         jad.AsyncConfig(**kw))
        _, got = tad.simulate_async_sgd(tloss, tparams, tb,
                                        tad.AsyncConfig(**kw))
    assert len(got) == STEPS and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)
