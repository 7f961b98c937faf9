"""The port's speculative decode against the JAX package on the CPU.

* ``ngram_draft``, ``verify_greedy`` and ``SlotTables.ensure_writable_span``
  equal JAX's on seeded inputs.
* ``decode_spec`` / ``quant_decode_spec`` from the same caches (dense and
  paged, 16-bit and int8; mixed ``q_lens`` with 1, drafts that match and
  drafts that do not, rows past ``max_len``, a slot past the cache end):
  logits within 1e-5 of the largest, ``accepts``, ``len`` and the written
  caches equal JAX's; the flash path (its plain version on the CPU) equal
  to the dense path.
* The engine at ``spec_k`` 4 on reduced recllm-base and olmo-1b under the
  four layouts and on reduced moonshot-v1-16b-a3b under dense and paged,
  Zipf prompts, pinned clock: streams, records and the summary
  (``summary["spec"]`` included) equal JAX's spec engine, streams equal
  the port's one-token engine, the paged pool drains.
* The toy-backend cases of ``tests/test_serving_engine.py`` (EOS inside
  an accepted span, the budget cap, a mixed workload), the traced
  ``decode_step`` spans and ``engine.spec_tokens`` against JAX's, the
  launcher with ``--spec-k 4`` and the refusals.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.cache_layout import CacheLayout as JLayout
from repro.config import get_arch as jget_arch
from repro.config import reduced as jreduced
from repro.models import kvquant as jkv
from repro.models import transformer as jtf
from repro.serving import block_pool as jbp
from repro.serving import engine as jeng
from repro.serving import traffic as jtraffic
from repro_torch import convert
from repro_torch.cache_layout import CacheLayout
from repro_torch.config import get_arch, reduced
from repro_torch.models import kvquant as tkv
from repro_torch.models import transformer as ttf
from repro_torch.serving import block_pool as tbp
from repro_torch.serving import engine as teng
from repro_torch.serving import traffic as ttraffic

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGIT_RTOL = 1e-5


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


_MODELS = {}


def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params): reduced, float32, the
    JAX init converted into the port."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(jreduced(jget_arch(arch)),
                                   dtype="float32")
        tcfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32")
        jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = convert.params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu")
        _MODELS[arch] = (jcfg, jparams, tcfg, tparams)
    return _MODELS[arch]


# ---------------------------------------------------------------------------
# ngram_draft, verify_greedy, ensure_writable_span
# ---------------------------------------------------------------------------

def test_ngram_draft_matches_jax():
    cases = [([1, 2, 3, 9, 1, 2], 3), ([5, 6, 7, 6], 2), ([1, 2, 3, 4], 3),
             ([1], 3), ([1, 2, 3], 0), ([], 2), ([4, 4, 4, 4], 3)]
    assert teng.ngram_draft([1, 2, 3, 9, 1, 2], 3) == [3, 9, 1]
    assert teng.ngram_draft([5, 6, 7, 6], 2) == [7, 6]
    assert teng.ngram_draft([1, 2, 3, 4], 3) == []
    assert teng.ngram_draft([1], 3) == []
    assert teng.ngram_draft([1, 2, 3], 0) == []
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(0, 120))
        vocab = int(rng.choice([3, 6, 20, 500]))
        hist = [int(t) for t in np.minimum(rng.zipf(1.3, n), vocab)]
        cases.append((hist, int(rng.integers(-1, 8))))
    for hist, need in cases:
        for lookback in (64, 5):
            assert teng.ngram_draft(hist, need, lookback) == \
                jeng.ngram_draft(hist, need, lookback), (hist, need)


@pytest.mark.parametrize("seed", range(4))
def test_verify_greedy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, k, V = 9, 1 + seed % 4 + 1, 11
    logits = rng.standard_normal((B, k, V)).astype(np.float32)
    g = logits.argmax(-1)
    tokens = rng.integers(0, V, (B, k))
    # half the slots draft what the model emits, up to a random row
    for b in range(0, B, 2):
        upto = int(rng.integers(1, k + 1))
        tokens[b, 1:upto] = g[b, :upto - 1]
    q_lens = rng.integers(1, k + 1, B)
    want = np.asarray(jtf.verify_greedy(jnp.asarray(tokens, jnp.int32),
                                        jnp.asarray(logits),
                                        jnp.asarray(q_lens, jnp.int32)))
    got = ttf.verify_greedy(torch.as_tensor(tokens), torch.as_tensor(logits),
                            torch.as_tensor(q_lens, dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 1).all() and (want <= q_lens).all() and want.max() > 1


def test_ensure_writable_span_matches_jax():
    """The same admit / span / release sequence (shared prefixes, tails,
    copy-on-write across spans of 1 to 5 rows) on both packages' tables:
    pairs, tables, refcounts and debts equal, refcounts drained."""
    rng = np.random.default_rng(0)
    bs, n_slots, bpslot = 4, 3, 6
    pools = [m.BlockPool(n_slots * bpslot + 1, bs) for m in (jbp, tbp)]
    tabs = [m.SlotTables(p, n_slots, bpslot)
            for m, p in zip((jbp, tbp), pools)]
    prompts = [(1, 2, 3, 4, 5, 6), (1, 2, 3, 4, 5, 6), (7, 8, 9)]
    lens = [0] * n_slots
    live = [False] * n_slots
    for step in range(120):
        s = int(rng.integers(n_slots))
        if not live[s]:
            prompt = prompts[int(rng.integers(len(prompts)))]
            outs = []
            for m, t in zip((jbp, tbp), tabs):
                keys, tail = m.prefix_keys(list(prompt), bs)
                outs.append(t.admit(s, keys, tail, 5))
                if outs[-1]:
                    t.seal_prompt(s)
            assert outs[0] == outs[1]
            if outs[0]:
                live[s], lens[s] = True, len(prompt)
        elif rng.random() < 0.15 or lens[s] >= 5 * bs - 1:
            for t in tabs:
                t.release(s)
            live[s] = False
        else:
            count = int(rng.integers(1, 6))
            count = min(count, 5 * bs - lens[s])
            pairs = [t.ensure_writable_span(s, lens[s], count) for t in tabs]
            assert pairs[0] == pairs[1]
            lens[s] += int(rng.integers(1, count + 1))
        for a, b in ((tabs[0].read, tabs[1].read),
                     (tabs[0].write, tabs[1].write),
                     (pools[0].refcount, pools[1].refcount)):
            np.testing.assert_array_equal(a, b)
        assert pools[0].cow_debt == pools[1].cow_debt
        assert pools[0].cow_events == pools[1].cow_events
    assert pools[1].cow_events > 0
    for s in range(n_slots):
        for t in tabs:
            t.release(s)
    for p in pools:
        assert p.used_blocks == 0 and p.cow_debt == 0
        assert (p.refcount[1:] == 0).all()


# ---------------------------------------------------------------------------
# decode_spec / quant_decode_spec from the same caches
# ---------------------------------------------------------------------------

MAX_LEN, BS = 32, 8
# slot lengths and live rows (k = 4): a full draft, a one-row slot, three
# live rows then one past max_len, one live row at the last position and
# three past it, a slot already past the cache end (a free slot counting on)
SPEC_LENS = [5, 17, 29, 31, 40]
SPEC_QLENS = [4, 1, 3, 1, 1]
SPEC_K = 4


def _spec_caches(jcfg, quant, paged, seed=0):
    """Random per-slot caches (numpy) at SPEC_LENS; paged ones over a
    shuffled pool whose slots own every block of their table."""
    rng = np.random.default_rng(seed)
    L, Hk, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    B, nb = len(SPEC_LENS), MAX_LEN // BS
    if quant:
        rows = {n: (rng.integers(-127, 128, (L, B, MAX_LEN, Hk, D))
                    .astype(np.int8) if n.endswith("_q") else
                    rng.uniform(0.002, 0.02, (L, B, MAX_LEN, Hk))
                    .astype(np.float32)) for n in ("k_q", "k_s", "v_q",
                                                   "v_s")}
    else:
        rows = {n: rng.standard_normal((L, B, MAX_LEN, Hk, D))
                .astype(np.float32) for n in ("k", "v")}
    cache = dict(rows)
    if paged:
        N = B * nb + 1
        perm = rng.permutation(np.arange(1, N))
        table = perm.reshape(B, nb).astype(np.int32)
        table[4] = 0                    # the free slot owns nothing
        for n, r in rows.items():
            pool = rng.standard_normal((L, N, BS) + r.shape[3:]).astype(
                r.dtype) if r.dtype != np.int8 else np.zeros(
                (L, N, BS) + r.shape[3:], np.int8)
            for b in range(4):
                pool[:, table[b]] = r[:, b].reshape(
                    (L, nb, BS) + r.shape[3:])
            cache[n] = pool
        cache["block_table"] = table
        cache["write_table"] = table.copy()
    cache["len"] = np.asarray(SPEC_LENS, np.int32)
    return cache


def _jax_spec(jcfg, jparams, cache, tokens, q_lens, quant):
    jc = {n: jnp.asarray(v) for n, v in cache.items()}
    fn = jkv.quant_decode_spec if quant else jtf.decode_spec
    logits, acc, out = fn(jcfg, jparams, jc, jnp.asarray(tokens, jnp.int32),
                          jtf.ModelCtx(attn_chunk=8),
                          q_lens=jnp.asarray(q_lens, jnp.int32))
    return (np.asarray(logits), np.asarray(acc),
            {n: np.asarray(v) for n, v in out.items()})


def _spec_tokens(jcfg, jparams, cache, quant, seed=0):
    """Step inputs: slots 0 and 2 draft what the model emits (accepts
    reach q_lens), the others random drafts."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, jcfg.vocab_size, (len(SPEC_LENS), SPEC_K))
    for j in range(1, SPEC_K):
        logits, _, _ = _jax_spec(jcfg, jparams, cache, tokens, SPEC_QLENS,
                                 quant)
        g = logits.argmax(-1)
        for b in (0, 2):
            tokens[b, j] = g[b, j - 1]
    return tokens


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("layout", ["dense", "paged", "int8", "paged_int8"])
def test_decode_spec_matches_jax(layout):
    jcfg, jparams, tcfg, tparams = _models("olmo-1b")
    quant, paged = "int8" in layout, "paged" in layout
    cache = _spec_caches(jcfg, quant, paged)
    tokens = _spec_tokens(jcfg, jparams, cache, quant)
    jlogits, jacc, jout = _jax_spec(jcfg, jparams, cache, tokens,
                                    SPEC_QLENS, quant)
    assert jacc.tolist()[:3] == [4, 1, 3]
    results = {}
    for impl in ("dense", "flash"):
        tc = {n: torch.as_tensor(v.copy()) for n, v in cache.items()}
        fn = tkv.quant_decode_spec if quant else ttf.decode_spec
        with torch.inference_mode():
            logits, acc, out = fn(
                tcfg, tparams, tc, torch.as_tensor(tokens),
                ttf.ModelCtx(attn_chunk=8, decode_impl=impl),
                q_lens=torch.as_tensor(SPEC_QLENS, dtype=torch.int32))
        results[impl] = logits.numpy()
        assert _rel(logits.numpy(), jlogits) <= LOGIT_RTOL, impl
        np.testing.assert_array_equal(acc.numpy(), jacc)
        np.testing.assert_array_equal(out["len"].numpy(), jout["len"])
        for n in cache:
            if n == "len":
                continue
            got, want = out[n].numpy(), jout[n]
            if paged and n not in ("block_table", "write_table"):
                # the null block collects dead rows in either order
                got, want = got[:, 1:], want[:, 1:]
            if got.dtype == np.int8:
                # a value rounding at .5 may part by one step
                assert np.abs(got.astype(int) - want).max() <= 1, n
            else:
                assert np.abs(got - want).max() <= LOGIT_RTOL * max(
                    1.0, float(np.abs(want).max())), n
    assert _rel(results["flash"], results["dense"]) <= LOGIT_RTOL


def test_dense_spec_rows_past_the_end_are_dropped():
    """Rows past the cache end leave the cache as JAX's dropping scatter
    does: the live row at S - 1 wins over the dead rows clamped onto it."""
    S, k = 6, 4
    cache = torch.arange(2 * S, dtype=torch.float32).reshape(2, S, 1)
    new = 100 + torch.arange(2 * k, dtype=torch.float32).reshape(2, k, 1)
    tgt, src = ttf.spec_rows(torch.tensor([4, 7]), k, S)
    ttf.write_spec_rows(cache, tgt, src, new)
    jc = jnp.arange(2 * S, dtype=jnp.float32).reshape(2, S, 1)
    pos = jnp.asarray([4, 7])[:, None] + jnp.arange(k)[None]
    jc = jc.at[jnp.arange(2)[:, None], pos].set(jnp.asarray(new.numpy()),
                                                 mode="drop")
    np.testing.assert_array_equal(cache.numpy(), np.asarray(jc))


# ---------------------------------------------------------------------------
# the engine at spec_k 4 against JAX's spec engine and the one-token port
# ---------------------------------------------------------------------------

def _zipf_requests(traffic_mod, vocab, n=6, seed=0, max_new=10):
    """Zipfian prompts (recsys-style repetitive ids, as in
    ``tests/test_serving_engine.py``): the n-gram drafter finds real
    matches, so accepts exercise the > 1 path."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(6, 14))
        toks = np.minimum(rng.zipf(1.2, plen) + 2, vocab - 1)
        reqs.append(traffic_mod.Request(
            rid=i, user_id=i, prompt=tuple(int(t) for t in toks),
            max_new_tokens=max_new, arrival=0.001 * (i // 2)))
    return reqs


def _shared_requests(traffic_mod, vocab):
    """Four requests on one 20-token prompt (two shared 8-row blocks and a
    shared tail: prefix hits and copy-on-write) beside two Zipf ones."""
    prompt = _zipf_requests(traffic_mod, vocab, n=1, seed=3)[0].prompt
    prompt = (prompt * 3)[:20]
    return [traffic_mod.Request(rid=i, user_id=i, prompt=prompt,
                                max_new_tokens=9, arrival=0.0)
            for i in range(4)] + [
        dataclasses.replace(r, rid=4 + i, user_id=4 + i)
        for i, r in enumerate(_zipf_requests(traffic_mod, vocab, n=2))]


LAYOUTS = {"dense": {}, "paged": dict(kind="paged", block_size=8),
           "int8": dict(kv_bits=8),
           "paged_int8": dict(kind="paged", kv_bits=8, block_size=8)}


def _clock(traffic_mod):
    return traffic_mod.Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02)


def _engines(arch, layout_kw, spec_k=4, tracer=False, n_slots=3,
             make_reqs=_zipf_requests):
    """The JAX spec engine and the port's spec engine on one workload,
    plus the port's one-token engine: {name: (outputs, records, summary,
    engine)}."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    out = {}
    runs = (("jax", jeng, jtraffic, jobs, JLayout, jcfg, jparams, {},
             jtf.ModelCtx(attn_chunk=8), spec_k),
            ("torch", teng, ttraffic, tobs, CacheLayout, tcfg, tparams,
             {"device": "cpu"}, ttf.ModelCtx(attn_chunk=8), spec_k),
            ("torch_one", teng, ttraffic, tobs, CacheLayout, tcfg, tparams,
             {"device": "cpu"}, ttf.ModelCtx(attn_chunk=8), 1))
    for name, eng, traffic, obs, lcls, cfg, params, kw, ctx, k in runs:
        layout = lcls(**layout_kw)
        explicit = layout != lcls()
        backend = eng.make_backend(cfg, params, ctx,
                                   layout=layout if explicit else None, **kw)
        tr, reg = ((obs.Tracer(), obs.MetricsRegistry()) if tracer
                   else (None, None))
        engine = eng.ServingEngine(
            backend, eng.EngineConfig(n_slots=n_slots, max_len=64,
                                      spec_k=k, layout=layout),
            _clock(traffic), tracer=tr, metrics=reg)
        res = engine.run(make_reqs(traffic, cfg.vocab_size))
        out[name] = (*res, engine, tr, reg)
    return out


def _check_engines(runs, layout_kw):
    jout, jrecs, jsum = runs["jax"][:3]
    tout, trecs, tsum, teng_ = runs["torch"][:4]
    assert tout == jout
    assert [dataclasses.asdict(r) for r in trecs] == \
        [dataclasses.asdict(r) for r in jrecs]
    assert tsum["spec"] == jsum["spec"]
    assert _same(tsum, jsum), (tsum, jsum)
    assert tout == runs["torch_one"][0]
    assert tsum["spec"]["accepted_tokens_per_step"] > 1.0
    assert tsum["decode_steps"] <= runs["torch_one"][2]["decode_steps"]
    if layout_kw.get("kind") == "paged":
        # rejected rows over-secure blocks past the frontier; retirement
        # must still drain every refcount
        assert teng_.pool.used_blocks == 0 and teng_.pool.cow_debt == 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ["recllm-base", "olmo-1b"])
def test_spec_engine_matches_jax(arch, layout):
    _check_engines(_engines(arch, LAYOUTS[layout]), LAYOUTS[layout])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_engine_matches_jax_moe(layout):
    _check_engines(_engines("moonshot-v1-16b-a3b", LAYOUTS[layout]),
                   LAYOUTS[layout])


@pytest.mark.parametrize("make_reqs", [_zipf_requests, _shared_requests],
                         ids=["zipf", "shared"])
def test_spec_trace_matches_jax(make_reqs):
    """The traced spec run: every event (``decode_step``'s
    ``model_flops`` scaled by live rows, ``spec_q_rows``,
    ``tokens_emitted``; ``pool.cow`` from the span walk) and the
    registry's ``engine.spec_tokens`` equal JAX's; shared prompts copy
    on write and drain the pool."""
    runs = _engines("olmo-1b", LAYOUTS["paged"], tracer=True,
                    make_reqs=make_reqs)
    _check_engines(runs, LAYOUTS["paged"])
    jtr, jreg = runs["jax"][4:]
    ttr, treg = runs["torch"][4:]
    assert len(ttr.events) == len(jtr.events)
    for e, f in zip(ttr.events, jtr.events):
        assert (e["ph"], e["name"], e["track"]) == \
            (f["ph"], f["name"], f["track"])
        assert e["args"] == f["args"], (e, f)
        assert e["ts"] == pytest.approx(f["ts"], abs=1e-12)
    steps = [e for e in ttr.events if e["name"] == "decode_step"]
    assert steps and all("spec_q_rows" in e["args"]
                         and "tokens_emitted" in e["args"] for e in steps)
    assert _same(treg.snapshot(), jreg.snapshot())
    spec_tokens = treg.snapshot()["counters"]["engine.spec_tokens"]
    assert spec_tokens == runs["torch"][2]["spec"]["spec_tokens"]
    if make_reqs is _shared_requests:
        assert runs["torch"][2]["paged"]["shared_hits"] > 0
        assert ttr.span_names().get("pool.cow", 0) > 0


# ---------------------------------------------------------------------------
# toy backends (the cases of tests/test_serving_engine.py)
# ---------------------------------------------------------------------------

class ToyBackend:
    """Next token = fn(last) on the CPU; no real cache."""

    V = 32
    family = "uniform"
    device = torch.device("cpu")

    def __init__(self, next_fn=None):
        self.next_fn = next_fn or (lambda t: (t + 1) % self.V)

    def init_slots(self, n_slots, max_len):
        return {"len": torch.zeros(n_slots, dtype=torch.int64)}

    def prefill(self, cache, tokens, true_len, slot):
        logits = torch.zeros(self.V)
        logits[self.next_fn(int(tokens[0, true_len - 1]))] = 1.0
        return logits, cache

    def _logits(self, tokens):
        B, k = tokens.shape
        logits = torch.zeros((B, k, self.V))
        for b in range(B):
            for j in range(k):
                logits[b, j, self.next_fn(int(tokens[b, j]))] = 1.0
        return logits

    def decode(self, cache, tokens):
        return self._logits(tokens), cache


class SpecToyBackend(ToyBackend):
    """A toy whose ``decode_spec`` verifies draft rows with the
    greedy-accept rule of the k-row step."""

    def decode_spec(self, cache, tokens, q_lens):
        logits = self._logits(tokens)
        return logits, ttf.verify_greedy(tokens, logits, q_lens), cache


def _toy_workload(n=24, seed=0, eos_id=-1, arrival_rate=200.0):
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n))
    return [ttraffic.Request(
        rid=i, user_id=i,
        prompt=tuple(int(t) for t in rng.integers(
            0, ToyBackend.V, int(rng.integers(2, 10)))),
        max_new_tokens=int(rng.integers(2, 9)),
        arrival=float(arrivals[i]), eos_id=eos_id) for i in range(n)]


def _toy_run(backend, reqs, **ecfg):
    engine = teng.ServingEngine(
        backend, teng.EngineConfig(max_len=64, **ecfg),
        ttraffic.Clock(0.0, 0.0))
    return (*engine.run(reqs), engine)


def test_spec_toy_streams_match_single_step():
    reqs = _toy_workload(n=24, eos_id=5)
    base, _, s_base, _ = _toy_run(ToyBackend(), reqs, n_slots=3)
    spec, _, s_spec, eng = _toy_run(SpecToyBackend(), reqs, n_slots=3,
                                    spec_k=4)
    assert spec == base
    assert s_spec["finished"] == s_base["finished"]
    assert not eng.queue and all(r is None for r in eng.slot_req)
    assert s_spec["spec"]["k"] == 4
    assert s_spec["spec"]["accepted_tokens_per_step"] >= 1.0


def test_spec_eos_mid_draft_truncates_the_accept():
    a, b, e = 1, 2, 3
    nxt = {a: b, b: e, e: a}
    req = ttraffic.Request(rid=0, user_id=0, prompt=(a, b, e, a),
                           max_new_tokens=10, arrival=0.0, eos_id=e)
    outs, _, summary, _ = _toy_run(SpecToyBackend(lambda t: nxt.get(t, 0)),
                                   [req], n_slots=1, spec_k=4)
    # prefill emits b, then one step accepts [e, a, b, e]: the stream
    # stops at the first EOS
    assert outs[0] == [b, e]
    assert summary["finished"] == 1


@pytest.mark.parametrize("budget", [1, 2, 3, 5, 8])
def test_spec_budget_cap_never_overshoots(budget):
    req = ttraffic.Request(rid=0, user_id=0, prompt=(7, 7, 7),
                           max_new_tokens=budget, arrival=0.0)
    outs, _, _, _ = _toy_run(SpecToyBackend(lambda t: 7), [req], n_slots=1,
                             spec_k=4)
    assert outs[0] == [7] * budget


# ---------------------------------------------------------------------------
# the launcher and the refusals
# ---------------------------------------------------------------------------

def test_launcher_serves_speculatively():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--spec-k", "4", "--requests", "6",
         "--no-warmup", "--json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    summary = json.loads(res.stdout[res.stdout.index("\n{") + 1:])
    assert summary["finished"] == 6
    assert summary["spec"]["k"] == 4 and summary["spec"]["draft"] == "ngram"


def test_refusals():
    _, _, tcfg, tparams = _models("recllm-base")
    backend = teng.make_backend(tcfg, tparams, device="cpu")
    with pytest.raises(ValueError, match="spec_draft"):
        teng.ServingEngine(backend, teng.EngineConfig(spec_k=4,
                                                      spec_draft="eagle"))
    with pytest.raises(ValueError, match="no speculative decode path"):
        teng.ServingEngine(ToyBackend(),
                           teng.EngineConfig(spec_k=4))
    engine = teng.ServingEngine(backend, teng.EngineConfig(spec_k=4))
    assert backend.spec_k == 4
    req = _zipf_requests(ttraffic, tcfg.vocab_size, n=1)[0]
    with pytest.raises(NotImplementedError, match="sampled"):
        engine.submit(dataclasses.replace(req, temperature=0.7))
    blk = ttf._layer(tparams["blocks"], 0)["attn"]
    x = torch.zeros((1, 2, tcfg.d_model))
    kc = torch.zeros((1, 8, tcfg.num_kv_heads, tcfg.head_dim))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttf.attn_decode_spec(tcfg, blk, x, torch.zeros((1, 2), dtype=int),
                             ttf.ModelCtx(), kc, kc.clone(),
                             torch.zeros(1, dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32), window=4)
