"""The port's hybrid step on a 2 x 2 ``(data, model)`` world against
JAX's on a 2 x 2 host mesh, for the reduced MoE archs (float32, 3 steps,
grad_clip 1.0, 2 micro-batches, ZeRO-1/2; the cases of
``tests/test_torch_moe_train.py``'s ``CASES``).

Four gloo ranks (subprocesses of this file, a ``FileStore``) and one JAX
subprocess (``--xla_force_host_platform_device_count=4``) start with the
module and run concurrently, each with its own timeout:

* expert parallelism: each ``model`` rank holds and runs 2 of the 4
  experts; SP on (seq 32) and off (seq 16);
* the Switch aux losses over the global micro-batch (``frac_tokens`` and
  the mean probs over both ``data`` ranks' rows, the router's gradient
  summed over ``model`` and the aux gradients counted once);
* the FSDP-expert layout (``sharding.FSDP_EXPERT_BYTES`` set to 0 in the
  port's ranks): the experts' ``d_ff`` also over ``data``, gathered at
  use, against JAX's step without it.

Held: losses and ``grad_norm`` within rtol 1e-5, the gathered params and
AdamW state after 3 steps (tolerances of ``assert_same``), every rank's
shard equal to its slice of the full array, every rank's aux (the global
values) equal.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_moe_train import CASES, assert_same, init, run_jax, run_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


def _save(path, out):
    arrays = {}
    for case, (losses, norms, fp, fo, *rest) in out.items():
        arrays[f"{case}|losses"] = np.asarray(losses)
        arrays[f"{case}|norms"] = np.asarray(norms)
        if rest:
            err, aux, fsdp = rest
            arrays[f"{case}|err"] = np.float64(err)
            arrays[f"{case}|fsdp"] = np.bool_(fsdp)
            for k, v in aux.items():
                arrays[f"{case}|a|{k}"] = v
        for part, flat in (("p", fp), ("o", fo)):
            for k, v in flat.items():
                arrays[f"{case}|{part}|{k}"] = v
    np.savez(path, **arrays)


def _load(path):
    data = np.load(path)
    out = {}
    for key in data.files:
        case, kind, *rest = key.split("|")
        entry = out.setdefault(case, {"p": {}, "o": {}, "a": {}})
        if rest:
            entry[kind][rest[0]] = data[key]
        else:
            entry[kind] = data[key]
    return {c: (list(e["losses"]), list(e["norms"]), e["p"], e["o"],
                float(e.get("err", 0.0)), e["a"], bool(e.get("fsdp", False)))
            for c, e in out.items()}


@pytest.fixture(scope="module", autouse=True)
def world4_procs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe4")
    inits = init(CASES)
    np.savez(tmp / "init.npz", **{f"{a}|{k}": v for a, flat in inits.items()
                                  for k, v in flat.items()})
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
def test_moe_hybrid_step_2x2_matches_jax(world4, case):
    ref, ranks = world4
    assert_same(ranks[0][case], ref[case], case)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_shards_and_aux_agree_across_ranks(world4, case):
    """Every rank's shard of params and opt is its slice of the full array
    by the port's spec; every rank gathers the same full arrays and
    reports the same global aux; the FSDP cases shard d_ff over data."""
    _, ranks = world4
    for r, port in enumerate(ranks):
        assert port[case][4] == 0.0, (r, port[case][4])
        for part in (2, 3):
            for k, v in port[case][part].items():
                np.testing.assert_array_equal(v, ranks[0][case][part][k])
        for k, v in port[case][5].items():
            np.testing.assert_allclose(v, ranks[0][case][5][k], rtol=1e-6,
                                       err_msg=f"rank {r} aux {k}")
        assert port[case][6] == CASES[case][3], (r, case)


def test_plans_are_the_ones_named():
    """SP on at seq 32 and off at 16 over model 2; no dp_heavy; the
    experts split 2 a rank."""
    from repro_torch import config
    from repro_torch.core import hybrid, sharding
    from repro_torch.core.hierarchical import DPMesh
    from test_torch_moe_train import BATCH, _cfg
    for r in range(2):
        mesh = DPMesh(shape={"data": 2, "model": 2},
                      coords={"data": 0, "model": r}, groups={})
        for case, (arch, seq, micro, _) in CASES.items():
            cfg = _cfg(config, arch)
            plan = hybrid.auto_plan(cfg, mesh, config.ShapeConfig(
                "t", seq, BATCH, "train"), config.ParallelConfig(
                    microbatches=micro))
            assert plan.sharding.seq_shard == (seq == 32), case
            assert not plan.sharding.dp_heavy and not plan.remat
            hooks = sharding.TPHooks(plan.sharding, cfg, seq_len=seq,
                                     rows=BATCH // micro)
            assert hooks.experts == (2 * r, 2 * r + 2), case


def _subprocess_main(argv):
    side, out_path, init_path, *rest = argv
    data = np.load(init_path)
    inits = {}
    for key in data.files:
        arch, path = key.split("|")
        inits.setdefault(arch, {})[path] = data[key]
    if side == "jax":
        from repro import compat
        out = run_jax(compat.make_mesh((2, 2), ("data", "model")), inits,
                      CASES)
    else:
        from repro_torch.launch.mesh import make_host_mesh
        rank, store_path = int(rest[0]), rest[1]
        torch.set_num_threads(1)
        dist.init_process_group("gloo",
                                store=dist.FileStore(store_path, 4),
                                rank=rank, world_size=4)
        try:
            out = run_port(make_host_mesh(data=2, model=2), inits, CASES)
        finally:
            dist.destroy_process_group()
    _save(out_path, out)


if __name__ == "__main__":
    _subprocess_main(sys.argv[1:])
