"""The port's checkpoint manager and the training loop's fault tolerance
(``repro_torch/checkpoint/manager.py``, ``runtime/trainer.train_loop``,
``resume_or_init``), against the JAX package's where both apply.

* ``tests/test_checkpoint.py``'s six cases on the port: round trip,
  keep-N, torn write, empty directory, dtype cast, manifest.
* Float32 checkpoints cross-read: the port's restores in
  ``repro.checkpoint.manager.restore_latest`` and JAX's in the port's.
* Elastic: a hybrid-step state saved from a 2 x 2 ``(data, model)`` gloo
  world (four subprocesses of this file, a ``FileStore``) restores whole
  onto a world of one, and onto the 2 x 2 world as each rank's shards.
* ``train_loop`` with ``checkpoint_every`` and ``fail_at``, then
  ``resume_or_init``, reproduces the uninterrupted run's losses (the
  hybrid step on reduced olmo-1b, a world of one), and its
  ``train_step``/``checkpoint`` events equal JAX's under a ``ManualClock``.
* The launchers: ``repro_torch.launch.train`` ends with the JAX
  launcher's ``done:`` line, takes the pipelined flags and refuses only
  ``--host-devices``; ``launch/train_recsys.py`` resumes a run killed
  after a checkpoint.
"""
import dataclasses
import functools
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


@pytest.fixture
def tree():
    """The JAX test's tree; its tuple of blocks as a dict keyed 0, 1 (the
    same paths in the npz)."""
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "blocks": {"0": {"a": torch.ones(2)},
                                  "1": {"a": torch.zeros(2)}}},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def test_save_restore_roundtrip(tmp_path, tree):
    d = str(tmp_path)
    ckpt.save(d, 10, tree)
    out = ckpt.restore(d, 10, tree)
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_keep_n_gc(tmp_path, tree):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, tree, keep=2)
    assert ckpt.list_steps(d) == [4, 5]


def test_restore_latest_skips_torn_write(tmp_path, tree):
    d = str(tmp_path)
    ckpt.save(d, 1, tree)
    ckpt.save(d, 2, tree)
    # a node dying mid-save of step 3: manifest missing
    torn = os.path.join(d, "step_0000000003")
    os.makedirs(torn)
    with open(os.path.join(torn, "arrays.npz"), "wb") as f:
        f.write(b"garbage")
    step, _ = ckpt.restore_latest(d, tree)
    assert step == 2
    # and a corrupt manifest is also skipped
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        f.write("{not json")
    step, _ = ckpt.restore_latest(d, tree)
    assert step == 2


def test_restore_latest_empty_dir(tmp_path, tree):
    step, out = ckpt.restore_latest(str(tmp_path), tree)
    assert step is None and out is tree


def test_restore_casts_dtype_and_keeps_bf16(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.ones(4, dtype=torch.float32)})
    out = ckpt.restore(d, 1, {"w": torch.ones(4, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16
    # a bf16 leaf goes to disk as float32 (numpy has no bf16) and back
    # bit for bit
    w = torch.randn(64).to(torch.bfloat16)
    ckpt.save(d, 2, {"w": w})
    with np.load(os.path.join(d, "step_0000000002", "arrays.npz")) as z:
        assert z["w"].dtype == np.float32
    back = ckpt.restore(d, 2, {"w": torch.zeros(64, dtype=torch.bfloat16)})
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))


def test_manifest_contents(tmp_path, tree):
    d = str(tmp_path)
    path = ckpt.save(d, 42, tree, extra_meta={"mesh": [16, 16]})
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    assert m["step"] == 42 and m["committed"] and m["mesh"] == [16, 16]
    assert m["keys"] == ["opt/step", "params/blocks/0/a",
                         "params/blocks/1/a", "params/w"]


# -- cross-reads with the JAX package ----------------------------------------

def test_port_checkpoint_restores_in_jax(tmp_path, tree):
    import jax.numpy as jnp
    from repro.checkpoint import manager as jckpt
    ckpt.save(str(tmp_path), 3, tree)
    template = {"params": {"w": jnp.zeros((3, 4)),
                           "blocks": ({"a": jnp.zeros(2)},
                                      {"a": jnp.zeros(2)})},
                "opt": {"step": jnp.asarray(0, jnp.int32)}}
    step, out = jckpt.restore_latest(str(tmp_path), template)
    assert step == 3
    np.testing.assert_array_equal(out["params"]["w"], tree["params"]["w"])
    np.testing.assert_array_equal(out["params"]["blocks"][1]["a"], 0.0)
    assert int(out["opt"]["step"]) == 7 and out["opt"]["step"].dtype == \
        jnp.int32


def test_jax_checkpoint_restores_in_port(tmp_path, tree):
    import jax.numpy as jnp
    from repro.checkpoint import manager as jckpt
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    jckpt.save(str(tmp_path), 5, {"params": {
        "w": jnp.asarray(w), "blocks": ({"a": jnp.ones(2)},
                                        {"a": jnp.full(2, 2.0)})},
        "opt": {"step": jnp.asarray(9, jnp.int32)}})
    step, out = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 5
    np.testing.assert_array_equal(out["params"]["w"].numpy(), w)
    np.testing.assert_array_equal(out["params"]["blocks"]["1"]["a"], 2.0)
    assert out["opt"]["step"].dtype == torch.int32
    assert int(out["opt"]["step"]) == 9


# -- the hybrid step: elastic restore, kill and resume --------------------------

def _setup(mesh, steps=6, ckpt_dir="", ckpt_every=0):
    """Reduced olmo-1b (float32) under auto_plan's plan on ``mesh``:
    (step, state, shardings, tcfg, batches)."""
    from repro_torch import config, convert
    from repro_torch.core import hybrid, sharding
    from repro_torch.data import pipeline
    from repro_torch.optimizer import adamw
    from repro_torch.runtime import trainer
    cfg = dataclasses.replace(config.reduced(config.get_arch("olmo-1b")),
                              dtype="float32")
    plan = hybrid.auto_plan(cfg, mesh, config.ShapeConfig("t", 16, 8,
                                                          "train"),
                            config.ParallelConfig(microbatches=2))
    tcfg = config.TrainConfig(steps=steps, learning_rate=1e-3,
                              warmup_steps=2, checkpoint_dir=ckpt_dir,
                              checkpoint_every=ckpt_every,
                              keep_checkpoints=2)
    full = convert.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in pipeline.synthetic_lm_batches(cfg.vocab_size, 8, 16,
                                                      steps, seed=3)]
    step, shardings_for = trainer.make_hybrid_train_step(
        cfg, plan, tcfg, params_shape=full)
    psh, osh, _ = shardings_for(full, batches[0])
    state = {"params": sharding.device_put(full, psh),
             "opt": sharding.device_put(adamw.init_opt_state(full), osh)}
    return step, state, {"params": psh, "opt": osh}, tcfg, batches


@pytest.fixture
def world1(tmp_path):
    from repro_torch.launch.mesh import make_host_mesh
    store = dist.FileStore(str(tmp_path / "store1"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield make_host_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4_ckpt(tmp_path_factory):
    """Four gloo ranks train 2 steps on a 2 x 2 mesh and save; rank 0 also
    writes the gathered full state."""
    tmp = tmp_path_factory.mktemp("ckpt4")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp), str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        for p in procs:
            try:
                log = p.communicate(timeout=TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {p.args[-1]} still running after "
                            f"{TIMEOUT_S} s")
            assert p.returncode == 0, log[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return tmp


def test_elastic_restore_2x2_onto_world_of_one(world4_ckpt, world1):
    from repro_torch.core import sharding
    _, state, shardings, _, _ = _setup(world1)
    step, out = ckpt.restore_latest(str(world4_ckpt / "ck"), state,
                                    shardings)
    assert step == 2
    whole = np.load(world4_ckpt / "full.npz")
    got = {k: v for k, v in ckpt._paths(sharding.gather(out, shardings))}
    assert sorted(got) == sorted(whole.files)
    for k in whole.files:
        np.testing.assert_array_equal(got[k].numpy(), whole[k])
    assert int(out["opt"]["step"]) == 2


def test_elastic_restore_onto_the_2x2_world_gives_each_rank_its_shards(
        world4_ckpt):
    for r in range(4):
        assert (world4_ckpt / f"ok{r}").read_text() == "restored shards equal"


def test_killed_run_resumes_to_the_uninterrupted_losses(world1, tmp_path):
    from repro_torch.runtime import trainer
    step, state, _, tcfg, batches = _setup(world1)
    want = trainer.train_loop(state, iter(batches), step, tcfg).losses
    d = str(tmp_path / "ck")
    step, state, shardings, tcfg, batches = _setup(world1, ckpt_dir=d,
                                                   ckpt_every=2)
    with pytest.raises(RuntimeError, match="injected failure"):
        trainer.train_loop(state, iter(batches), step, tcfg, fail_at=3,
                           shardings=shardings)
    assert ckpt.list_steps(d) == [2]
    # restart: fresh state, resume from the latest checkpoint
    step, fresh, shardings, tcfg, batches = _setup(world1, ckpt_dir=d,
                                                   ckpt_every=2)
    start, state = trainer.resume_or_init(fresh, tcfg, shardings)
    assert start == 2 and int(state["opt"]["step"]) == 2
    res = trainer.train_loop(state, iter(batches[start:]), step, tcfg,
                             start_step=start, shardings=shardings)
    assert res.final_step == 6
    assert res.losses == want[start:]
    assert ckpt.list_steps(d) == [4, 6]


def _loop_events(side, tmp):
    """The train loop's events from ``side``'s package: a step that adds
    one to a scalar and advances a ManualClock by 1.5, a checkpoint that
    advances it by 0.25, every 2 of 5 steps."""
    if side == "jax":
        import jax.numpy as jnp
        from repro.checkpoint import manager as mgr
        from repro.config import TrainConfig
        from repro.obs import ManualClock, Tracer
        from repro.runtime import trainer
        params = {"w": jnp.zeros(3)}
        opt = {"step": jnp.asarray(0, jnp.int32)}
    else:
        from repro_torch.checkpoint import manager as mgr
        from repro_torch.config import TrainConfig
        from repro_torch.obs import ManualClock, Tracer
        from repro_torch.runtime import trainer
        params = {"w": torch.zeros(3)}
        opt = {"step": torch.tensor(0, dtype=torch.int32)}
    clock = ManualClock()
    tracer = Tracer(clock=clock)

    def step_fn(p, o, b):
        clock.advance(1.5)
        return {"w": p["w"] + 1}, {"step": o["step"] + 1}, {"loss": b}

    save = mgr.save

    def timed_save(*a, **kw):
        clock.advance(0.25)
        return save(*a, **kw)

    tcfg = TrainConfig(steps=5, checkpoint_every=2,
                       checkpoint_dir=str(tmp / side))
    mgr.save = timed_save
    try:
        trainer.train_loop({"params": params, "opt": opt},
                           iter([0.5, 0.25, 0.125, 1.0, 2.0]), step_fn, tcfg,
                           tracer=tracer)
    finally:
        mgr.save = save
    return tracer.events


def test_train_loop_events_equal_jax(tmp_path):
    got, want = _loop_events("torch", tmp_path), _loop_events("jax",
                                                              tmp_path)
    assert [e["name"] for e in got].count("checkpoint") == 2
    assert got == want


# -- the launchers -------------------------------------------------------------

def _launch(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *argv], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)


def test_train_launcher_ends_with_the_done_line(tmp_path):
    out = _launch("repro_torch.launch.train", "--device", "cpu", "--arch",
                  "olmo-1b", "--reduced", "--steps", "2", "--batch", "8",
                  "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("olmo-1b: 0.1M params on mesh data=1 model=1 "
                               "stage=1; plan notes: ()")
    assert re.fullmatch(r"done: 2 steps, host throughput \d+\.\d "
                        r"samples/s, final loss \d+\.\d{4}", lines[-1])


@pytest.mark.parametrize("flag", [("--pp-stages", "2"),
                                  ("--grad-sync", "onebit"),
                                  ("--host-devices", "8")])
def test_train_launcher_refuses_the_pipelined_path(flag):
    """Only ``--host-devices`` (JAX's host-platform setting) is refused;
    the pipelined flags are accepted since the pipelined path is ported:
    ``--pp-stages 2`` takes it (on a world of two: ``test_torch_pp.py``),
    and ``--grad-sync``, which serves only it, leaves a one-stage run on
    the hybrid path, as JAX's launcher does."""
    from repro_torch.launch import train
    if flag[0] == "--host-devices":
        with pytest.raises(SystemExit) as e:
            train.parse_args(["--device", "cpu", *flag])
        assert e.value.code != 0
        return
    args = train.parse_args(["--device", "cpu", *flag])
    assert str(getattr(args, flag[0][2:].replace("-", "_"))) == flag[1]
    if flag[0] == "--grad-sync":
        out = _launch("repro_torch.launch.train", "--device", "cpu", "--arch",
                      "olmo-1b", "--reduced", "--steps", "2", "--batch", "8",
                      "--seq", "16", *flag)
        assert out.returncode == 0, out.stderr[-3000:]
        assert out.stdout.splitlines()[0].endswith("stage=1; plan notes: ()")
    else:
        out = _launch("repro_torch.launch.train", "--device", "cpu", *flag)
        # a world of one cannot hold two stages: the mesh says so
        assert out.returncode != 0 and "does not cover the world" in \
            out.stderr


def test_train_recsys_resumes_a_killed_run(tmp_path, monkeypatch, capsys):
    """Killed after step 26 (a checkpoint at 25), then run again: it
    resumes at 25 and finishes the 30 steps."""
    from repro_torch.launch import train_recsys
    from repro_torch.runtime import trainer
    argv = ["--device", "cpu", "--steps", "30", "--batch", "8", "--seq",
            "16", "--scale", "0.005", "--ckpt-dir", str(tmp_path / "ck")]
    loop = trainer.train_loop
    monkeypatch.setattr(trainer, "train_loop",
                        functools.partial(loop, fail_at=26))
    with pytest.raises(RuntimeError, match="injected failure at step 26"):
        train_recsys.main(argv)
    assert ckpt.list_steps(str(tmp_path / "ck")) == [25]
    monkeypatch.setattr(trainer, "train_loop", loop)
    capsys.readouterr()
    assert train_recsys.main(argv) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 25" in out
    assert "step 30: loss" in out and "HR@10" in out
    assert ckpt.list_steps(str(tmp_path / "ck")) == [25]


def _rank_main(tmp, rank):
    from repro_torch.core import sharding
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), 4), rank=rank, world_size=4)
    try:
        mesh = make_host_mesh(data=2, model=2)
        step, state, shardings, tcfg, batches = _setup(mesh, steps=2)
        for b in batches:
            state["params"], state["opt"], _ = step(state["params"],
                                                    state["opt"], b)
        ckpt.save(str(tmp / "ck"), 2, state, shardings=shardings)
        full = sharding.gather(state, shardings)
        if rank == 0:
            np.savez(tmp / "full.npz", **{k: v.numpy()
                                          for k, v in ckpt._paths(full)})
        _, fresh, _, _, _ = _setup(mesh, steps=2)
        back = ckpt.restore(str(tmp / "ck"), 2, fresh, shardings)
        same = all(torch.equal(a, b) for a, b in zip(_leaves(back),
                                                     _leaves(state)))
        (tmp / f"ok{rank}").write_text("restored shards equal" if same
                                       else "restored shards differ")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(pathlib.Path(sys.argv[1]), int(sys.argv[2]))
