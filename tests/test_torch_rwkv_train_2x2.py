"""The port's rwkv6 hybrid step on worlds of four against JAX's on host
meshes of four devices (reduced rwkv6-1.6b in float32, 3 steps,
grad_clip 1.0; the harness of ``tests/test_torch_rwkv_train.py``).

Four gloo ranks (subprocesses of this file, a ``FileStore``) and one JAX
subprocess (``--xla_force_host_platform_device_count=4``) start with the
module and run concurrently, each with its own timeout.  Each runs a
2 x 2 ``(data, model)`` mesh, then a ``(1, 4)`` mesh on the same four
ranks or devices:

* ``tp``: Megatron TP over ``model`` at seq 16 (no SP): 2 of the 4 heads
  and 48 of the 96 ``d_ff`` columns a rank, the time mix's ``ln_x`` over
  the gathered channels;
* ``sp``: the same with Megatron-SP at seq 32: the residual a sequence
  shard, the token shifts taken on the gathered sequence;
* ``dp_heavy``: the batch over every axis, the weights gathered at use;
* ``zero2_m2``: TP and SP in 2 micro-batches, the gradients
  reduce-scattered onto ZeRO's optimizer shards (every case does that);
* ``w14_sp``: the ``(1, 4)`` mesh, one head a rank, SP at seq 32.

Held (``assert_close`` of ``tests/test_torch_rwkv_train.py``): losses
within rtol 1e-5, ``grad_norm`` within rtol 1e-5 at steps 1 and 2 and
5e-5 at step 3, the gathered params and AdamW state after 3 steps (m, v
rtol 1e-5 atol 1e-6; params, master rtol 1e-5 atol 1e-5), every rank's
shard equal to its slice of the full array and every rank's full arrays
equal.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_hybrid import _load, _save
from test_torch_rwkv_train import assert_close, init, run_jax, run_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
# (data, model) -> {case: (seq, micro-batches, plan kind, SP)}
WORLDS = {
    (2, 2): {"tp": (16, 1, "megatron", False),
             "sp": (32, 1, "megatron", True),
             "dp_heavy": (32, 1, "dp_heavy", False),
             "zero2_m2": (32, 2, "megatron", True)},
    (1, 4): {"w14_sp": (32, 1, "megatron", True)},
}
CASES = {c: v for cases in WORLDS.values() for c, v in cases.items()}


@pytest.fixture(scope="module", autouse=True)
def world4_procs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rwkv4")
    np.savez(tmp / "init.npz", **init())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cmds = [["jax", str(tmp / "jax.npz"), str(tmp / "init.npz")]] + [
        ["torch", str(tmp / f"r{r}.npz"), str(tmp / "init.npz"), str(r),
         str(tmp / "store")] for r in range(4)]
    procs = [subprocess.Popen([sys.executable, __file__, *c], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        yield tmp, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def world4(world4_procs):
    tmp, procs = world4_procs
    for p in procs:
        try:
            log = p.communicate(timeout=TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            pytest.fail(f"{p.args[2]} still running after {TIMEOUT_S} s")
        assert p.returncode == 0, log[-3000:]
    return (_load(tmp / "jax.npz"),
            [_load(tmp / f"r{r}.npz") for r in range(4)])


@pytest.mark.parametrize("case", list(CASES))
def test_rwkv_hybrid_step_on_four_ranks_matches_jax(world4, case):
    ref, ranks = world4
    assert_close(ranks[0][case], ref[case], case)


@pytest.mark.parametrize("case", list(CASES))
def test_rwkv_shards_agree_across_ranks(world4, case):
    """Every rank's shard of params and opt is its slice of the full array
    by the port's spec, and every rank gathers the same full arrays."""
    _, ranks = world4
    for r, port in enumerate(ranks):
        assert port[case][4] == 0.0, (r, port[case][4])
        for part in (2, 3):
            for k, v in port[case][part].items():
                np.testing.assert_array_equal(v, ranks[0][case][part][k])


def test_plans_are_the_ones_named():
    """TP everywhere but ``dp_heavy``; SP where the case says; the heads
    and ``d_ff`` split as named."""
    from repro_torch import config
    from repro_torch.core import hybrid, sharding
    from repro_torch.core.hierarchical import DPMesh
    from test_torch_rwkv_train import _cfg, _plan
    cfg = _cfg(config)
    for (data, model), cases in WORLDS.items():
        mesh = DPMesh(shape={"data": data, "model": model},
                      coords={"data": 0, "model": model - 1}, groups={})
        for name, case in cases.items():
            seq, micro = case[:2]
            plan = _plan(config, hybrid, sharding, mesh, case)
            hooks = sharding.TPHooks(plan.sharding, cfg, seq_len=seq,
                                     rows=8 // micro)
            heavy = name == "dp_heavy"
            assert plan.sharding.dp_heavy == heavy and not plan.remat
            assert hooks.tp == (1 if heavy else model), name
            assert hooks.seq == case[3], name
            assert hooks.rank == (0 if heavy else model - 1)
    assert cfg.d_model // cfg.rwkv_head_size == 4 and cfg.d_ff == 96


def _subprocess_main(argv):
    side, out_path, init_path, *rest = argv
    flat = dict(np.load(init_path))
    out = {}
    if side == "jax":
        from repro import compat
        for shape, cases in WORLDS.items():
            out.update(run_jax(compat.make_mesh(shape, ("data", "model")),
                               flat, cases))
    else:
        from repro_torch.launch.mesh import make_host_mesh
        rank, store_path = int(rest[0]), rest[1]
        torch.set_num_threads(1)
        dist.init_process_group("gloo",
                                store=dist.FileStore(store_path, 4),
                                rank=rank, world_size=4)
        try:
            for (data, model), cases in WORLDS.items():
                out.update(run_port(make_host_mesh(data=data, model=model),
                                    flat, cases))
        finally:
            dist.destroy_process_group()
    _save(out_path, out)


if __name__ == "__main__":
    _subprocess_main(sys.argv[1:])
