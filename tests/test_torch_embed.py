"""The port's sparse-embedding pieces against the JAX package on the CPU:
the plain versions of the ``gather_rows`` and ``scatter_add_rows`` kernels
against the Pallas kernels in interpret mode, the dedup lookup with the
gather kernel, and ``embeddings/update.py`` function by function.

The same numpy inputs (seeded) go through ``repro`` and ``repro_torch``;
on CPU tensors each port wrapper runs the plain version of its CUDA
kernel (``chip_smoke.py`` holds the kernels against those plain versions
on the GPU).  Tolerances: gathers, unique ids, inverse indices and the
world-of-one sync exactly (copies and a sum of one term); scatter-adds
1e-6 relative and absolute, as ``tests/test_embeddings.py`` holds the
Pallas kernel to its oracle (duplicates add in input order on both sides,
so they come out equal in practice); top-k rows exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.embeddings import dedup_lookup as jdedup_lookup
from repro.embeddings import update as jupdate
from repro.kernels import ops as jops
from repro_torch.embeddings import dedup_lookup
from repro_torch.embeddings import update
from repro_torch.kernels import embedding_ops, fused_adamw, ops as tops

torch.set_num_threads(2)


def _zipf_ids(n, rows, seed=1):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(1.3, n) - 1, rows - 1).astype(np.int32)


def _normal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- the plain versions against the Pallas kernels ---------------------------

GATHER_CASES = {  # name -> (rows, dim, ids, dtype)
    "zipf_f32": (64, 16, _zipf_ids(40, 64), "float32"),
    "zipf_wide_f32": (128, 32, _zipf_ids(48, 128), "float32"),
    "zipf_bf16": (128, 32, _zipf_ids(48, 128), "bfloat16"),
    "all_dupes_f32": (16, 8, np.full(12, 5, np.int32), "float32"),
}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_rows_matches_pallas(case):
    rows, dim, ids, dtype = GATHER_CASES[case]
    table = _normal((rows, dim))
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    want = np.asarray(jops.embedding_gather(jt, jnp.asarray(ids))
                      .astype(jnp.float32))
    tt = _t(table).to(getattr(torch, dtype))
    for impl in ("kernel", "ref"):
        got = tops.embedding_gather(tt, _t(ids), impl=impl)
        assert got.dtype == tt.dtype and got.shape == (len(ids), dim)
        np.testing.assert_array_equal(got.float().numpy(), want)


SCATTER_CASES = {  # name -> (n, dim, idx, n_rows)
    "heavy_dupes": (24, 16, np.random.default_rng(3).integers(0, 8, 24)
                    .astype(np.int32), 8),
    "zipf": (48, 32, _zipf_ids(48, 64, seed=4), 64),
    # the sentinel dump row: ids n_rows - 1 stand for padding
    "dump_row": (10, 16, np.array([3, 9, 0, 9, 3, 3, 9, 1, 9, 9],
                                  np.int32), 10),
}


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_add_rows_matches_pallas(case):
    n, dim, idx, n_rows = SCATTER_CASES[case]
    x = _normal((n, dim), seed=5)
    want = np.asarray(jops.embedding_scatter_add(
        jnp.asarray(x), jnp.asarray(idx), n_rows))
    for impl in ("kernel", "ref"):
        got = tops.embedding_scatter_add(_t(x), _t(idx), n_rows, impl=impl)
        assert got.shape == (n_rows, dim)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(40,), (8, 5)], ids=["1d", "2d"])
def test_dedup_lookup_with_the_gather_kernel_matches_jax(shape):
    table = _normal((64, 16), seed=2)
    ids = _zipf_ids(40, 64).reshape(shape)
    want = np.asarray(jdedup_lookup(jnp.asarray(table), jnp.asarray(ids),
                                    use_kernel=True))
    for use_kernel in (True, False):
        got = dedup_lookup(_t(table), _t(ids), use_kernel=use_kernel)
        assert got.shape == shape + (16,)
        np.testing.assert_array_equal(got.numpy(), want)


# -- embeddings/update.py ----------------------------------------------------

@pytest.mark.parametrize("cap", [None, 40, 3], ids=["len", "padded", "cut"])
def test_rows_touched_matches_jax(cap):
    """Sentinel padding to cap, and jnp.unique's silent cut below the
    unique count (cap 3)."""
    ids = _zipf_ids(20, 64).reshape(4, 5)
    want = np.asarray(jupdate.rows_touched(jnp.asarray(ids), 64, cap))
    got = update.rows_touched(_t(ids), 64, cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_gather_grad_rows_matches_jax(use_kernel):
    g = _normal((64, 16), seed=6)
    u = np.asarray(jupdate.rows_touched(jnp.asarray(_zipf_ids(20, 64)), 64))
    assert (u == 64).any()                         # sentinel entries
    want = np.asarray(jupdate.gather_grad_rows(jnp.asarray(g),
                                               jnp.asarray(u)))
    got = update.gather_grad_rows(_t(g), _t(u), use_kernel=use_kernel)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_scatter_rows_matches_jax(use_kernel):
    """Sentinels onto the dump row; duplicates as after an all-gather."""
    u = np.array([2, 7, 64, 64, 2, 9, 7, 64], np.int32)
    rows = _normal((8, 16), seed=7)
    want = np.asarray(jupdate.scatter_rows(jnp.asarray(u), jnp.asarray(rows),
                                           64, use_kernel=use_kernel))
    got = update.scatter_rows(_t(u), _t(rows), 64, use_kernel=use_kernel)
    assert got.shape == (64, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_sparse_grad_from_lookup_matches_jax(use_kernel):
    """u itself (padded with repeats of the smallest id), the segment
    sums, and the dense gradient rebuilt from them against autograd."""
    table = _normal((64, 16), seed=8)
    ids = _zipf_ids(32, 64, seed=9)
    dout = _normal((32, 16), seed=10)
    ju, jrows = jupdate.sparse_grad_from_lookup(
        jnp.asarray(dout), jnp.asarray(ids), 64, use_kernel=use_kernel)
    tu, trows = update.sparse_grad_from_lookup(_t(dout), _t(ids), 64,
                                               use_kernel=use_kernel)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(trows.numpy(), np.asarray(jrows), rtol=1e-6,
                               atol=1e-6)
    tt = _t(table).requires_grad_()
    torch.sum(tt[_t(ids).long()] * _t(dout)).backward()
    rebuilt = update.scatter_rows(tu, trows, 64)
    np.testing.assert_allclose(rebuilt.numpy(), tt.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "ref"])
def test_row_compressor_matches_jax(use_kernel):
    rows = _normal((8, 16), seed=11)
    rows[3, :5] = 2.0                              # ties in one row
    want = np.asarray(jupdate.make_row_compressor(
        "topk", k=4, use_kernel=use_kernel)(jnp.asarray(rows)))
    got = update.make_row_compressor("topk", k=4,
                                     use_kernel=use_kernel)(_t(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="row compressor"):
        update.make_row_compressor("onebit")


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    from repro_torch.core import hierarchical
    store = dist.FileStore(str(tmp_path_factory.mktemp("embed1") / "store"),
                           1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield hierarchical.make_dp_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("compress", [None, "topk"])
@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_sparse_row_sync_world_of_one(world1, use_kernel, compress):
    """On one rank the rows-touched sync is the dense gradient bit for bit
    (JAX's own check); with the row compressor it equals JAX's sync on a
    one-device mesh."""
    g = np.zeros((64, 16), np.float32)
    ids = _zipf_ids(20, 64)
    rng = np.random.default_rng(5)
    for j in ids:
        g[j] += rng.normal(size=16).astype(np.float32)
    jcomp = (jupdate.make_row_compressor(compress, k=4) if compress
             else None)
    mesh = compat.make_mesh((1,), ("data",))
    f = shard_map(lambda gs, i: jupdate.sparse_row_sync(
        gs, i, ("data",), compress=jcomp), mesh=mesh, in_specs=(P(), P()),
        out_specs=P(), check_rep=False)
    want = np.asarray(f(jnp.asarray(g), jnp.asarray(ids)))
    tcomp = (update.make_row_compressor(compress, k=4, use_kernel=use_kernel)
             if compress else None)
    got = update.sparse_row_sync(_t(g), _t(ids), world1, ("data",),
                                 compress=tcomp, use_kernel=use_kernel)
    np.testing.assert_array_equal(got.numpy(), want)
    if compress is None:
        np.testing.assert_array_equal(got.numpy(), g)


# -- the wrappers ------------------------------------------------------------

def _wrapper_calls():
    return {
        "gather_rows": lambda x: embedding_ops.gather_rows(
            x, torch.tensor([3, 1, 3])),
        "scatter_add_rows": lambda x: embedding_ops.scatter_add_rows(
            x, torch.tensor([0, 2, 0, 1, 2, 2, 0, 1]), 4),
        "adamw_update": lambda x: fused_adamw.adamw_update(
            *(x.reshape(-1),) * 4, fused_adamw.hyper(
                1e-3, 0.1, 0.05, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
                device="cpu")),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_embed_and_adamw_wrappers_refuse_autograd(name):
    """The kernels have no backward: under autograd every wrapper raises,
    on the CPU too; under no_grad it runs.  On CPU tensors it runs the
    plain version and counts no launch."""
    call = _wrapper_calls()[name]
    wrapper = getattr(embedding_ops if name != "adamw_update"
                      else fused_adamw, name)
    before = wrapper.launches
    x = _t(_normal((8, 4))).requires_grad_()
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
        call(x)
    with torch.no_grad():
        call(x)
    assert wrapper.launches == before
