"""The port's paged KV cache against the JAX package.

* ``serving/block_pool.py``: the same scripted admit / seal / copy-on-write
  / exhaust / release sequence drives both packages' ``BlockPool`` and
  ``SlotTables``; tables, refcounts, free lists and stats must be
  identical after every step.
* The paged backend (16-bit pool): prefill two slots, decode with a free
  slot whose length runs past the table; logits within 1e-4 in float32,
  equal greedy tokens, equal pools outside the null block.
* The engine scenarios of ``tests/test_paged_serving.py`` (prefix sharing
  with copy-on-write, divergent tails, pool exhaustion, an impossible
  request) under a pinned clock: streams, records and summary equal to the
  JAX engine's, and the scenario's own assertions on the port.

Reduced RecLLM-base in float32, JAX params converted into the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache_layout import CacheLayout as JLayout
from repro.config import get_arch as jget_arch
from repro.config import reduced as jreduced
from repro.models import transformer as jtf
from repro.serving import block_pool as jbp
from repro.serving import engine as jeng
from repro.serving import traffic as jtraffic
from repro_torch import convert
from repro_torch.cache_layout import CacheLayout
from repro_torch.config import get_arch, reduced
from repro_torch.serving import block_pool as tbp
from repro_torch.serving import engine as teng
from repro_torch.serving import traffic as ttraffic

torch.set_num_threads(2)

ARCH = "recllm-base"


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(jget_arch(ARCH)), dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch(ARCH)), dtype="float32")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return jcfg, jparams, tcfg, tparams


# -- block pool -------------------------------------------------------------

def _state(pool, tables):
    return dict(read=tables.read.tolist(), write=tables.write.tolist(),
                refcount=pool.refcount.tolist(), free=list(pool._free),
                sealed=sorted(pool._hash_of.items()), cow_debt=pool.cow_debt,
                used=pool.used_blocks, peak=pool.peak_used,
                shared_hits=pool.shared_hits, cow_events=pool.cow_events,
                seal_count=pool.seal_count,
                pending=tables._pending_tail.tolist())


def test_prefix_keys_match_jax():
    for prompt, bs in (((5, 6, 7, 8, 9, 10, 11), 4), (tuple(range(16)), 8),
                       ((3,), 4)):
        assert tbp.prefix_keys(prompt, bs, ("seed", 16)) == \
            jbp.prefix_keys(prompt, bs, ("seed", 16))


def test_block_pool_script_matches_jax():
    """admit two identical prompts (full blocks + a shared tail), COW the
    tail, admit a divergent prompt, fail an admission on exhaustion without
    mutation, claim a sole-owner sealed block in place, release
    everything."""
    bs = 4
    a = tuple(range(3, 13))                  # 2 full blocks + a 2-token tail
    b = a[:8] + (90, 91, 92)                 # shares the 2 full blocks only
    script = [
        ("admit", 0, a, 4), ("seal", 0), ("admit", 1, a, 4), ("seal", 1),
        ("writable", 1, 10), ("writable", 0, 10), ("writable", 1, 12),
        ("admit", 2, b, 5), ("seal", 2), ("release", 0),
        ("writable", 2, 11), ("admit", 0, tuple(range(50, 67)), 5),
        ("release", 1), ("writable", 2, 4),    # sole owner: claim in place
        ("admit", 0, tuple(range(50, 67)), 5), ("seal", 0),
        ("writable", 0, 17), ("release", 2), ("release", 0),
    ]
    sides = []
    for mod in (jbp, tbp):
        pool = mod.BlockPool(12, bs)
        sides.append((mod, pool, mod.SlotTables(pool, 3, 5)))
    for step in script:
        out = []
        for mod, pool, tables in sides:
            op, slot = step[:2]
            if op == "admit":
                keys, tail = mod.prefix_keys(step[2], bs, "seed")
                ret = tables.admit(slot, keys, tail, step[3])
            elif op == "seal":
                ret = tables.seal_prompt(slot)
            elif op == "writable":
                ret = tables.ensure_writable(slot, step[2])
            else:
                ret = tables.release(slot)
            out.append((ret, _state(pool, tables)))
        assert out[0] == out[1], step
    (_, pool, tables) = sides[1]
    assert pool.used_blocks == 0 and (pool.refcount[1:] == 0).all()
    assert pool.cow_events > 0 and pool.shared_hits > 0
    assert [r for r, _ in out] == [None, None]   # release's return
    assert (tables.read == tbp.NULL_BLOCK).all()


# -- the paged backend --------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_paged_backend_matches_jax(model, impl):
    jcfg, jparams, tcfg, tparams = model
    n_slots, max_len, bs = 3, 16, 4
    lay = dict(kind="paged", impl=impl, block_size=bs)
    jb = jeng.PagedNativeBackend(jcfg, jparams, layout=JLayout(**lay))
    tb = teng.PagedNativeBackend(tcfg, tparams, layout=CacheLayout(**lay),
                                 device="cpu")
    jc, tc = jb.init_slots(n_slots, max_len), tb.init_slots(n_slots, max_len)
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    # shuffled private blocks for slots 0 and 2; slot 1 free (all null)
    tables = np.array([[5, 2, 0, 0], [0, 0, 0, 0], [7, 1, 0, 0]], np.int32)
    jc = jb.set_tables(jc, tables, tables)
    tc = tb.set_tables(tc, tables, tables)
    rng = np.random.default_rng(2)
    for slot, n in ((0, 6), (2, 3)):
        toks = np.zeros((1, 8), np.int32)
        toks[:, :n] = rng.integers(3, jcfg.vocab_size, (1, n))
        jrow, jc = jb.prefill(jc, toks, n, slot)
        trow, tc = tb.prefill(tc, toks, n, slot)
        np.testing.assert_allclose(trow.numpy(), np.asarray(jrow),
                                   atol=1e-4, rtol=0)
    tc["len"][1] = max_len - 1          # a free slot about to run past S
    jc["len"] = jc["len"].at[1].set(max_len - 1)
    nxt = np.full((n_slots, 1), 9, np.int32)
    live = [0, 2]
    for _ in range(4):
        jl, jc = jb.decode(jc, jnp.asarray(nxt))
        tl, tc = tb.decode(tc, torch.from_numpy(nxt.astype(np.int64)))
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=1e-4, rtol=0)
        jn = np.asarray(jl[:, 0].argmax(-1))
        assert (tl[:, 0].argmax(-1).numpy()[live] == jn[live]).all()
        nxt = jn[:, None].astype(np.int32)
    for n in ("k", "v"):                # block 0 is the null sink: skip it
        np.testing.assert_allclose(tc[n][:, 1:].numpy(),
                                   np.asarray(jc[n])[:, 1:], atol=1e-5,
                                   rtol=0)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()


# -- engine scenarios ---------------------------------------------------------

def _serve_both(model, reqs, layout=None, n_slots=2, max_len=64):
    """Serve ``reqs`` (kwargs of Request) through the JAX and the port
    engine under a pinned clock; assert equal streams, records and
    summaries; return the port's (outputs, summary, engine)."""
    jcfg, jparams, tcfg, tparams = model
    runs = []
    for eng, traffic, cfg, params, lay_cls, kw in (
            (jeng, jtraffic, jcfg, jparams, JLayout, {}),
            (teng, ttraffic, tcfg, tparams, CacheLayout, {"device": "cpu"})):
        lay = None if layout is None else lay_cls(**layout)
        backend = eng.make_backend(cfg, params, layout=lay, **kw)
        engine = eng.ServingEngine(
            backend, eng.EngineConfig(n_slots=n_slots, max_len=max_len,
                                      layout=lay or lay_cls()),
            traffic.Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02))
        out, recs, summary = engine.run(
            [traffic.Request(**r) for r in reqs])
        runs.append((out, [dataclasses.asdict(r) for r in recs], summary,
                     engine))
    (jout, jrecs, jsum, _), (tout, trecs, tsum, engine) = runs
    assert tout == jout
    assert trecs == jrecs
    assert tsum == jsum
    return tout, tsum, engine


def _req(rid, prompt, new):
    return dict(rid=rid, user_id=rid, prompt=tuple(prompt),
                max_new_tokens=new, arrival=0.0, eos_id=-1)


def test_prefix_sharing_is_token_exact_and_actually_shares(model):
    prompt = range(3, 3 + 13)               # 3 full 4-blocks + 1-token tail
    reqs = [_req(i, prompt, 6) for i in range(3)]
    layout = dict(kind="paged", block_size=4)
    dense, _, _ = _serve_both(model, reqs, n_slots=3)
    shared, ss, engine = _serve_both(model, reqs, layout, n_slots=3)
    assert shared == dense
    assert ss["paged"]["shared_hits"] > 0, "identical prompts never shared"
    assert ss["paged"]["cow_events"] > 0, "shared tail never COW'd"
    assert engine.pool.used_blocks == 0     # all returned after drain
    private, sp, _ = _serve_both(model, reqs,
                                 dict(layout, prefix_sharing=False),
                                 n_slots=3)
    assert private == dense and sp["paged"]["shared_hits"] == 0


def test_divergent_tails_share_only_complete_prefix_blocks(model):
    base = tuple(range(3, 3 + 8))           # two full 4-blocks
    reqs = [_req(0, base + (50, 51), 5), _req(1, base + (60, 61, 62), 5)]
    dense, _, _ = _serve_both(model, reqs)
    shared, ss, _ = _serve_both(model, reqs, dict(kind="paged",
                                                  block_size=4))
    assert shared == dense
    assert ss["paged"]["shared_hits"] == 2


def test_pool_exhaustion_degrades_to_queueing(model):
    rng = np.random.default_rng(3)
    # every span is exactly 3 blocks (12-token prompt + 8 new = 20 rows at
    # block_size 8), so a 6-block pool fits at most 2 of the 3 slots
    reqs = [_req(i, rng.integers(3, 256, 12).tolist(), 8) for i in range(6)]
    layout = dict(kind="paged", block_size=8, num_blocks=6,
                  prefix_sharing=False)
    dense, _, _ = _serve_both(model, reqs, n_slots=3)
    paged, sp, engine = _serve_both(model, reqs, layout, n_slots=3)
    assert sp["finished"] == len(reqs) and sp["rejected"] == 0
    assert paged == dense, "oversubscribed pool corrupted decode state"
    assert sp["max_concurrent_slots"] <= 2
    assert engine.pool.used_blocks == 0
    assert (engine.pool.refcount[1:] == 0).all()
    assert (engine.tables.read == tbp.NULL_BLOCK).all()


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_impossible_request_is_rejected_not_stalled(model, kv_bits):
    # a span of 5 blocks can never fit a 4-block pool: reject, don't spin
    layout = dict(kind="paged", kv_bits=kv_bits, block_size=8, num_blocks=4,
                  prefix_sharing=False)
    reqs = [_req(0, range(3, 35), 8), _req(1, (5, 6, 7), 4)]
    _, sp, _ = _serve_both(model, reqs, layout)
    assert sp["rejected"] == 1
    assert sp["finished"] == 1              # the small request still ran
