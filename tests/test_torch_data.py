"""The port's data pipeline and tokenizer against the JAX package's, on
the CPU.

* ``HashTokenizer.encode`` ids equal to JAX's for several texts and
  ``max_len``;
* ``synthetic_lm_batches`` equal to JAX's; ``place_batch`` and
  ``Prefetcher`` on ``device="cpu"`` yield every batch, in order, equal to
  JAX's placed batches; the prefetcher hands a source's exception to the
  consumer after the batches before it, and ``close`` ends its worker;
* a 2-rank gloo world (subprocesses of this file, a ``FileStore``) beside
  JAX on two host devices (one subprocess with
  ``--xla_force_host_platform_device_count=2``): each rank's blocks from
  ``place_batch`` and from ``Prefetcher`` with ``NamedSharding``s over
  ``data`` equal to JAX's addressable shards.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.data import pipeline as jpipe
from repro.data import tokenizer as jtok
from repro_torch.data import pipeline as tpipe
from repro_torch.data import tokenizer as ttok

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 180
VOCAB, BATCH, SEQ, STEPS = 50, 4, 8, 5
# batch key -> partition spec over the 2-rank (data 2) mesh
SPECS = {"tokens": ("data",), "targets": ("data", None),
         "mask": (None, "data")}
TEXTS = ["hello world hello", "The quick brown fox", "", "a b c d e f g h",
         "Ünïcode wörds, punctuation!"]


@pytest.mark.parametrize("max_len", [0, 3, 8, 16])
@pytest.mark.parametrize("vocab", [1000, 37])
def test_tokenizer_equals_jax(vocab, max_len):
    ours, ref = ttok.HashTokenizer(vocab), jtok.HashTokenizer(vocab)
    for text in TEXTS:
        assert ours.encode(text, max_len) == ref.encode(text, max_len)
    assert ours.pad_id == ref.pad_id == 0


def test_hash_tokenizer():
    tok = ttok.HashTokenizer(1000)
    ids = tok.encode("hello world hello", max_len=8)
    assert len(ids) == 8
    assert ids[0] == 1                       # bos
    assert ids[1] == ids[3]                  # same word same id
    assert all(0 <= i < 1000 for i in ids)
    assert ids == tok.encode("hello world hello", max_len=8)


def _stream(seed=0):
    return list(tpipe.synthetic_lm_batches(VOCAB, BATCH, SEQ, STEPS,
                                           seed=seed))


def _want(seed=0):
    """JAX's batches placed by its ``place_batch``, as numpy."""
    return [{k: np.asarray(v) for k, v in jpipe.place_batch(b).items()}
            for b in jpipe.synthetic_lm_batches(VOCAB, BATCH, SEQ, STEPS,
                                                seed=seed)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert g[k].numpy().dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k].numpy(), w[k])


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_equal_jax(seed):
    for g, w in zip(_stream(seed), jpipe.synthetic_lm_batches(
            VOCAB, BATCH, SEQ, STEPS, seed=seed)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_place_batch_equals_jax():
    _same([tpipe.place_batch(b, device="cpu") for b in _stream()], _want())


@pytest.mark.parametrize("size", [1, 2, 8])
def test_prefetcher_yields_every_batch_in_order(size):
    got = list(tpipe.Prefetcher(iter(_stream()), size=size, device="cpu"))
    _same(got, _want())


def test_prefetcher_raises_the_source_error_after_its_batches():
    def source():
        yield from _stream()[:2]
        raise OSError("the source broke")

    got = []
    with pytest.raises(OSError, match="the source broke"):
        for b in tpipe.Prefetcher(source(), size=1, device="cpu"):
            got.append(b)
    _same(got, _want()[:2])


def test_prefetcher_close_ends_the_worker():
    pf = tpipe.Prefetcher(iter(_stream() * 10), size=1, device="cpu")
    first = next(iter(pf))
    pf.close()
    assert not pf._t.is_alive()
    _same([first], _want()[:1])


def test_placement_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.place_batch(_stream()[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.Prefetcher(iter(_stream()))


# -- the 2-rank world ----------------------------------------------------------

def run_jax(out_path):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("data",))
    sh = {k: NamedSharding(mesh, P(*s)) for k, s in SPECS.items()}
    arrays = {}
    placed = [jpipe.place_batch(b, sh) for b in jpipe.synthetic_lm_batches(
        VOCAB, BATCH, SEQ, STEPS, seed=1)]
    fetched = list(jpipe.Prefetcher(jpipe.synthetic_lm_batches(
        VOCAB, BATCH, SEQ, STEPS, seed=1), size=2, shardings=sh))
    for how, batches in (("place", placed), ("prefetch", fetched)):
        for i, b in enumerate(batches):
            for k, v in b.items():
                for s in v.addressable_shards:
                    arrays[f"{how}|{i}|{k}|{s.device.id}"] = np.asarray(
                        s.data)
    np.savez(out_path, **arrays)


def run_port(out_path, rank, store):
    from repro_torch.core.sharding import NamedSharding
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        mesh = make_host_mesh(data=2)
        sh = {k: NamedSharding(mesh, s) for k, s in SPECS.items()}
        placed = [tpipe.place_batch(b, sh, device="cpu")
                  for b in tpipe.synthetic_lm_batches(VOCAB, BATCH, SEQ,
                                                      STEPS, seed=1)]
        fetched = list(tpipe.Prefetcher(tpipe.synthetic_lm_batches(
            VOCAB, BATCH, SEQ, STEPS, seed=1), size=2, shardings=sh,
            device="cpu"))
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **{f"{how}|{i}|{k}": v.numpy()
                          for how, batches in (("place", placed),
                                               ("prefetch", fetched))
                          for i, b in enumerate(batches)
                          for k, v in b.items()})


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data2")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    cmds = [["jax", str(tmp / "jax.npz")]] + [
        ["torch", str(tmp / f"r{r}.npz"), str(r), str(tmp / "store")]
        for r in range(2)]
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
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"r{r}.npz")) for r in range(2)])


@pytest.mark.parametrize("how", ["place", "prefetch"])
def test_sharded_blocks_equal_jax_shards(world2, how):
    ref, ranks = world2
    for rank, got in enumerate(ranks):
        keys = sorted(k for k in got if k.startswith(how + "|"))
        assert len(keys) == STEPS * len(SPECS)
        for key in keys:
            want = ref[f"{key}|{rank}"]
            assert got[key].shape == want.shape, key
            np.testing.assert_array_equal(got[key], want)


if __name__ == "__main__":
    side, out, *rest = sys.argv[1:]
    if side == "jax":
        run_jax(out)
    else:
        run_port(out, int(rest[0]), rest[1])
