"""The port's pipelined DP x TP x stage train step against JAX's
``make_pp_train_step`` (float32, reduced configs, 3 steps, grad_clip 1.0,
a remainder batch of 6 rows in 4 micro-batches, masks that differ
between rows).

Two worlds run as subprocesses of this file, started with the module and
collected by the tests, each beside a JAX subprocess on as many host
devices, all concurrently and each with its own timeout:

* ``stage`` 2 alone (two gloo ranks): 1F1B and GPipe on uneven bounds
  ``[0, 1, 4]`` (stage 0 runs two pad slots);
* four gloo ranks: ``data`` 2 x ``stage`` 2 under 1F1B and GPipe (flat),
  under ``hierarchical``, ``onebit`` and ``topk`` (the residual held too);
  ``model`` 2 x ``stage`` 2, 1F1B, olmo-1b (tied: Megatron TP stage
  bodies, the embedding's gradient added to the head's) and GPipe,
  internlm2-20b (one kv head: ``wk``/``wv`` replicated over ``model``,
  and norm scales, whose per-rank partial gradients are summed over
  ``model`` once); deepseek-7b
  (untied) with ``topk`` and the rows-touched embedding sync (top-k row
  compressor); and a rebalance in the loop from the skewed bounds
  ``[0, 1, 6]`` fed pinned stage times (``probe_stage_times`` patched in
  both packages): the new bounds, the remapped params and moments and
  the losses after it.

Held: the loss each step within rtol 1e-5; the full params, ``m``/``v``/
``master`` after 3 steps, and the residual where it is read after each
step, within rtol 1e-5, atol 1e-6.  A last test runs ``launch/train.py --pp-stages 2`` on
two ranks under ``torchrun`` beside the JAX launcher on two host devices
(the same header line), and kills a rebalanced run after its checkpoint
to resume it at the saved bounds.
"""
import dataclasses
import functools
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ, MICRO = 3, 6, 16, 4
RTOL, ATOL = 1e-5, 1e-6
LR = 1e-3
FLIPS = 1           # noise-level compression decisions allowed a case
TIMEOUT_S = 300
# case -> (arch, layers, (data, model, stage), schedule, sync, bounds)
CASES = {
    "s2_1f1b": ("olmo-1b", 4, (1, 1, 2), "1f1b", "flat", [0, 1, 4]),
    "s2_gpipe": ("olmo-1b", 4, (1, 1, 2), "gpipe", "flat", [0, 1, 4]),
    "d2s2_1f1b": ("olmo-1b", 4, (2, 1, 2), "1f1b", "flat", [0, 2, 4]),
    "d2s2_gpipe": ("olmo-1b", 4, (2, 1, 2), "gpipe", "flat", [0, 2, 4]),
    "m2s2_1f1b": ("olmo-1b", 4, (1, 2, 2), "1f1b", "flat", [0, 1, 4]),
    "m2s2_gqa": ("internlm2-20b", 4, (1, 2, 2), "gpipe", "flat", [0, 1, 4]),
    "d2s2_hier": ("olmo-1b", 4, (2, 1, 2), "1f1b", "hierarchical",
                  [0, 2, 4]),
    "d2s2_onebit": ("olmo-1b", 4, (2, 1, 2), "1f1b", "onebit", [0, 2, 4]),
    "d2s2_topk": ("olmo-1b", 4, (2, 1, 2), "1f1b", "topk", [0, 2, 4]),
    "deepseek_embed": ("deepseek-7b", 4, (2, 1, 2), "1f1b", "topk_embed",
                       [0, 2, 4]),
    "rebalance": ("olmo-1b", 6, (2, 1, 2), "1f1b", "flat", [0, 1, 6]),
}
WORLDS = {2: [n for n, c in CASES.items() if c[2] == (1, 1, 2)],
          4: [n for n, c in CASES.items() if c[2] != (1, 1, 2)]}


def _cfg(config_mod, name):
    arch, layers = CASES[name][:2]
    return dataclasses.replace(config_mod.reduced(config_mod.get_arch(arch)),
                               num_layers=layers, dtype="float32")


def _tcfg(config_mod):
    return config_mod.TrainConfig(steps=20, learning_rate=LR,
                                  warmup_steps=1, grad_clip=1.0,
                                  checkpoint_every=0)


def _syncs(trainer, name):
    """(DPSyncConfig, EmbedSyncConfig or None) of a case."""
    sync = CASES[name][4]
    if sync == "topk_embed":
        return (trainer.DPSyncConfig(mode="topk", topk_block=256, k=64),
                trainer.EmbedSyncConfig(id_fns={"embed": lambda b:
                                                b["tokens"]},
                                        compress="topk", k=8))
    return trainer.DPSyncConfig(mode=sync), None


def pinned_times(cfg, pp_params, bounds, *args, **kw):
    """Stage times proportional to the stage's layer count, slower on
    stage 1: ``[n0, 3 n1]``."""
    return [float(bounds[1] - bounds[0]),
            3.0 * float(bounds[2] - bounds[1])]


def _batches(vocab):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        lens = rng.integers(SEQ // 4, SEQ + 1, BATCH)
        out.append({
            "tokens": rng.integers(3, vocab, (BATCH, SEQ)).astype(np.int32),
            "targets": rng.integers(3, vocab, (BATCH, SEQ)).astype(np.int32),
            "mask": (np.arange(SEQ)[None] < lens[:, None]).astype(
                np.float32)})
    return out


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/") if tree[k]
                       else {f"{prefix}{k}/": np.zeros(0)})
        else:
            out[prefix + k] = np.asarray(tree[k])
    return out


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        if leaf:
            node[leaf] = v
    return tree


def _recording(step, out, whole):
    """``step`` that appends ``whole(residual)`` to ``out`` after each
    call."""
    def run(*args):
        res = step(*args)
        out.append(whole(res[2]))
        return res
    return run


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _init():
    """Each case's JAX init (PRNGKey(0)), flattened."""
    import jax
    from repro import config
    from repro.models import transformer as tf
    return {name: _flat(jax.tree.map(np.asarray, tf.init_params(
        jax.random.PRNGKey(0), _cfg(config, name)))) for name in CASES}


# -- the two sides -----------------------------------------------------------

def run_jax(init, names):
    """{case: {"losses", "p", "o", "res", ["history", "remapped"]}}."""
    import jax
    import jax.numpy as jnp
    from repro import compat, config
    from repro.models import transformer as tf
    from repro.optimizer import adamw
    from repro.runtime import trainer
    trainer.probe_stage_times = pinned_times
    out = {}
    for name in names:
        cfg = _cfg(config, name)
        _, _, shape, sched, _, bounds = CASES[name]
        mesh = compat.make_mesh(shape, ("data", "model", "stage"))
        scfg, esync = _syncs(trainer, name)
        params = jax.tree.map(jnp.asarray, _nest(init[name]))
        pp = tf.pp_partition_params(cfg, params, bounds)
        pp_shape = jax.eval_shape(lambda: pp)
        opt = adamw.init_opt_state(trainer.pp_trainable(
            pp, cfg.tie_embeddings))
        res = jnp.zeros(shape[:2] + (shape[2], trainer.pp_residual_size(
            cfg, pp_shape, mesh, scfg, embed_sync=esync)))
        step = trainer.make_pp_train_step(
            cfg, mesh, _tcfg(config), bounds, pp_shape, n_micro=MICRO,
            pp_schedule=sched, scfg=scfg, embed_sync=esync)
        batches = [jax.tree.map(jnp.asarray, b)
                   for b in _batches(cfg.vocab_size)]
        entry, res_steps = {}, []
        if _compressed(name):
            step = _recording(step, res_steps, lambda r: np.array(r))
        last = {"state": {"params": pp, "opt": opt, "residual": res}}
        rebal = None
        if name == "rebalance":
            inner = trainer.PPRebalancer(cfg, mesh, _tcfg(config), bounds,
                                         n_micro=MICRO, scfg=scfg)

            def rebal(state, step_fn):
                new = inner(state, step_fn)
                if new is not None:
                    last["state"] = new[0]
                    entry.setdefault("remapped", _flat(
                        {"p": new[0]["params"], "o": new[0]["opt"]}))
                return new
            rebal.bounds = inner.bounds
        run = trainer.train_loop(last["state"], iter(batches), step,
                                 _tcfg(config),
                                 rebalance_every=1 if rebal else 0,
                                 rebalance_fn=rebal)
        state = last["state"]
        entry.update(losses=run.losses, p=_flat(state["params"]),
                     o=_flat(state["opt"]), res=np.asarray(res_steps))
        if name == "rebalance":
            entry["history"] = inner.history
        out[name] = entry
    return out


def run_port(init, names):
    """The same from the port on this rank (full arrays gathered)."""
    from repro_torch import config, convert
    from repro_torch.core import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optimizer import adamw
    from repro_torch.runtime import trainer
    trainer.probe_stage_times = pinned_times
    out = {}
    for name in names:
        cfg = _cfg(config, name)
        _, _, (d, m, s), sched, _, bounds = CASES[name]
        mesh = make_host_mesh(data=d, model=m, stage=s)
        scfg, esync = _syncs(trainer, name)
        full = tf.pp_partition_params(cfg, convert.params_from_numpy(
            _nest(init[name]), device="cpu"), bounds)
        sh = trainer.pp_shardings(cfg, mesh, full, scfg)
        params = sharding.device_put(full, sh["params"])
        opt = adamw.init_opt_state(trainer.pp_trainable(
            params, cfg.tie_embeddings))
        res = torch.zeros((1, 1, 1, trainer.pp_residual_size(
            cfg, full, mesh, scfg, embed_sync=esync)))
        step = trainer.make_pp_train_step(
            cfg, mesh, _tcfg(config), bounds, full, n_micro=MICRO,
            pp_schedule=sched, scfg=scfg, embed_sync=esync)
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in _batches(cfg.vocab_size)]
        entry, res_steps = {}, []
        if _compressed(name):
            step = _recording(step, res_steps, lambda r: _np(
                sharding.gather(r, sh["residual"])))
        last = {"state": {"params": params, "opt": opt, "residual": res}}

        def whole(st):
            return {k: _np(sharding.gather(st[k], sh[k]))
                    for k in ("params", "opt")}
        rebal = None
        if name == "rebalance":
            inner = trainer.PPRebalancer(cfg, mesh, _tcfg(config), bounds,
                                         n_micro=MICRO, scfg=scfg)

            def rebal(state, step_fn):
                new = inner(state, step_fn)
                if new is not None:
                    last["state"] = new[0]
                    if "remapped" not in entry:
                        w = whole(new[0])
                        entry["remapped"] = _flat({"p": w["params"],
                                                   "o": w["opt"]})
                return new
            rebal.bounds = inner.bounds
        run = trainer.train_loop(last["state"], iter(batches), step,
                                 _tcfg(config),
                                 rebalance_every=1 if rebal else 0,
                                 rebalance_fn=rebal)
        w = whole(last["state"])
        entry.update(losses=run.losses, p=_flat(w["params"]),
                     o=_flat(w["opt"]), res=np.asarray(res_steps))
        if name == "rebalance":
            entry["history"] = inner.history
        out[name] = entry
    return out


VAG_BOUNDS, VAG_MICRO = [0, 1, 4], 4


def _vag_inputs(cfg):
    rng = np.random.default_rng(9)
    h = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(3, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    lens = rng.integers(4, SEQ + 1, BATCH)
    mask = (np.arange(SEQ)[None] < lens[:, None]).astype(np.float32)
    return h, tgt, mask


def _mean_last(last_fn, ones, count):
    """``make_pipeline_loss``'s head: the mean NLL of a micro-batch."""
    def f(lp, y, tgt):
        return last_fn(lp, y, tgt, ones(tgt.shape)) / count(tgt)
    return f


def vag_jax(init):
    """JAX's autodiff GPipe value-and-grad and pipelined loss on two
    stages: {"losses": [vag loss, pipelined loss], "p": the gradients}."""
    import jax
    import jax.numpy as jnp
    from repro import compat, config
    from repro.core import pipeline as jpl
    from repro.models import transformer as tf
    cfg = _cfg(config, "s2_1f1b")
    ctx = tf.ModelCtx(attn_chunk=8)
    pp = tf.pp_partition_params(cfg, jax.tree.map(jnp.asarray, _nest(
        init["s2_1f1b"])), VAG_BOUNDS)
    mesh = compat.make_mesh((2,), ("stage",))
    stage_fn, last_fn = tf.make_stage_fn(cfg, ctx), tf.make_last_fn(cfg, ctx)
    x, tgt, mask = (jnp.asarray(np.asarray(a)) for a in _micro_np(cfg))
    loss, (gs, gl, gx) = jax.jit(jpl.gpipe_value_and_grad(
        stage_fn, last_fn, mesh, 2, VAG_MICRO))(pp["stage"], pp["last"], x,
                                                tgt, mask)
    mean = jpl.make_pipeline_loss(stage_fn, _mean_last(last_fn, jnp.ones,
                                             lambda a: a.size),
                                  mesh, 2, VAG_MICRO)(
        pp["stage"], pp["last"], x, tgt)
    return {"vag": {"losses": [float(loss), float(mean)],
                    "p": _flat({"blocks": gs["blocks"], "last": gl,
                                "x": np.asarray(gx)}),
                    "res": np.zeros(0)}}


def _micro_np(cfg):
    h, tgt, mask = _vag_inputs(cfg)
    pad = (-BATCH) % VAG_MICRO

    def micro(a):
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        return a.reshape((VAG_MICRO, -1) + a.shape[1:])
    return micro(h), micro(tgt), micro(mask)


def vag_port(init):
    """The port on this rank: the executor under both schedules, the
    autograd GPipe (sends with autograd) and the pipelined loss, each
    stage's gradients gathered over the stage axis."""
    from repro_torch import config, convert
    from repro_torch.core import hierarchical as hier
    from repro_torch.core import pipeline as tpl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map
    cfg = _cfg(config, "s2_1f1b")
    ctx = tf.ModelCtx(attn_chunk=8)
    mesh = make_host_mesh(stage=2)
    s = mesh.coords["stage"]
    full = tf.pp_partition_params(cfg, convert.params_from_numpy(
        _nest(init["s2_1f1b"]), device="cpu"), VAG_BOUNDS)
    stage = tree_map(lambda a: a[s:s + 1].clone(), full["stage"])
    stage_fn, last_fn = tf.make_stage_fn(cfg, ctx), tf.make_last_fn(cfg, ctx)
    x, tgt, mask = (torch.from_numpy(a) for a in _micro_np(cfg))
    vags = {"1f1b": tpl.make_pipeline_value_and_grad(
                stage_fn, last_fn, mesh, 2, VAG_MICRO, schedule="1f1b"),
            "gpipe": tpl.make_pipeline_value_and_grad(
                stage_fn, last_fn, mesh, 2, VAG_MICRO, schedule="gpipe"),
            "autograd": tpl.gpipe_value_and_grad(stage_fn, last_fn, mesh, 2,
                                                 VAG_MICRO)}
    mean = tpl.make_pipeline_loss(stage_fn, _mean_last(last_fn, torch.ones,
                                             torch.numel),
                                  mesh, 2, VAG_MICRO)(
        stage, full["last"], x, tgt)
    out = {}
    for name, vag in vags.items():
        loss, (gs, gl, gx) = vag(stage, full["last"], x, tgt, mask)
        blocks = tree_map(lambda g: _np(hier.gather_dim(
            g.contiguous(), mesh, ("stage",), 0)), gs["blocks"])
        out[f"vag_{name}"] = {"losses": [float(loss), float(mean)],
                              "p": _flat({"blocks": blocks,
                                          "last": _np(gl), "x": _np(gx)}),
                              "res": np.zeros(0)}
    return out


def _save(path, out):
    arrays = {}
    for name, e in out.items():
        arrays[f"{name}|losses"] = np.asarray(e["losses"])
        arrays[f"{name}|res"] = e["res"]
        if "history" in e:
            arrays[f"{name}|history"] = np.asarray(e["history"])
        for part in ("p", "o", "remapped"):
            for k, v in e.get(part, {}).items():
                arrays[f"{name}|{part}|{k}"] = v
    np.savez(path, **arrays)


def _load(path):
    data = np.load(path)
    out = {}
    for key in data.files:
        name, kind, *rest = key.split("|")
        e = out.setdefault(name, {"p": {}, "o": {}})
        if rest:
            e.setdefault(kind, {})[rest[0]] = data[key]
        else:
            e[kind] = data[key]
    return out


# -- the worlds ----------------------------------------------------------------

def _jax_groups(n):
    """The world's cases cut into groups of two, one JAX process each
    (JAX's compiles take most of the time; the port's ranks run every
    case in ~15 s)."""
    names = WORLDS[n] + (["vag"] if n == 2 else [])
    return [names[i:i + 2] for i in range(0, len(names), 2)]


@pytest.fixture(scope="module", autouse=True)
def worlds_procs(tmp_path_factory):
    """Start both worlds' subprocesses with the module; :func:`worlds`
    collects them."""
    tmp = tmp_path_factory.mktemp("pp")
    init = _init()
    np.savez(tmp / "init.npz", **{f"{n}|{k}": v for n, flat in init.items()
                                  for k, v in flat.items()})
    procs = []
    for n in WORLDS:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
        cmds = [["jax", ",".join(g), str(tmp / f"jax{n}_{i}.npz"),
                 str(tmp / "init.npz")]
                for i, g in enumerate(_jax_groups(n))] + [
            ["torch", str(n), str(tmp / f"w{n}r{r}.npz"),
             str(tmp / "init.npz"), str(r), str(tmp / f"store{n}")]
            for r in range(n)]
        procs += [subprocess.Popen([sys.executable, __file__, *c], env=env,
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
def worlds(worlds_procs):
    tmp, procs = worlds_procs
    for p in procs:
        try:
            log = p.communicate(timeout=TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            pytest.fail(f"{p.args[2:5]} still running after {TIMEOUT_S} s")
        assert p.returncode == 0, log[-3000:]
    ref, port = {}, {}
    for n in WORLDS:
        for i, _ in enumerate(_jax_groups(n)):
            ref.update(_load(tmp / f"jax{n}_{i}.npz"))
        port.update(_load(tmp / f"w{n}r0.npz"))
        for r in range(1, n):       # every rank gathers the same arrays
            other = _load(tmp / f"w{n}r{r}.npz")
            for name in WORLDS[n]:
                np.testing.assert_array_equal(other[name]["losses"],
                                              port[name]["losses"])
                for k, v in other[name]["p"].items():
                    if k.startswith("stage/") or not _compressed(name):
                        np.testing.assert_array_equal(
                            v, port[name]["p"][k], err_msg=f"{name} {k}")
    return ref, port


# -- the launcher --------------------------------------------------------------

LAUNCH = ["--arch", "olmo-1b", "--reduced", "--pp-stages", "2",
          "--pp-micro", "2", "--batch", "8", "--seq", "16"]


def _torchrun(args, env, tmp):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "2", "--master-port", str(_free_port()), __file__, "launch",
           *args, "--device", "cpu"]
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S, cwd=tmp)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pp_launcher_prints_jax_lines_and_resumes_at_saved_bounds(
        tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    jax_run = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *LAUNCH, "--steps", "3",
         "--host-devices", "2", "--ckpt-dir", str(tmp_path / "jck")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        mine = _torchrun([*LAUNCH, "--steps", "3", "--ckpt-dir",
                          str(tmp_path / "ck")], env, tmp_path)
        assert mine.returncode == 0, mine.stdout[-2000:] + mine.stderr[-3000:]
        # killed after its step-10 checkpoint, the bounds moved at step 2
        four = dict(env, PP_TEST_LAYERS="4", PP_TEST_FAIL_AT="10")
        killed = _torchrun([*LAUNCH, "--steps", "12", "--pp-rebalance-every",
                            "2", "--ckpt-dir", str(tmp_path / "ck4")], four,
                           tmp_path)
        resumed = _torchrun([*LAUNCH, "--steps", "12", "--resume",
                             "--ckpt-dir", str(tmp_path / "ck4")],
                            dict(four, PP_TEST_FAIL_AT=""), tmp_path)
        ref = jax_run.communicate(timeout=TIMEOUT_S)[0]
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.communicate()
    assert jax_run.returncode == 0, ref[-3000:]
    lines = [ln for ln in mine.stdout.splitlines()
             if not ln.startswith("step built")]
    header = [ln for ln in ref.splitlines() if "params on mesh" in ln]
    assert header and lines[0] == header[0], (lines[0], header)
    assert "stage bounds (0, 1, 2)" in lines[0] and "bubble" in lines[0]
    for i in (1, 2, 3):
        assert re.fullmatch(rf"step {i}: loss \d+\.\d{{4}}", lines[i])
    assert re.fullmatch(r"done: 3 steps, host throughput [\d.]+ samples/s, "
                        r"final loss \d+\.\d{4}", lines[4])
    assert killed.returncode != 0
    assert "injected failure at step 10" in killed.stderr
    assert "step 2: rebalanced (bounds [0, 3, 4])" in killed.stdout
    ck = np.load(tmp_path / "ck4" / f"step_{10:010d}" / "arrays.npz")
    assert list(ck["stage_bounds"]) == [0, 3, 4]
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    out = resumed.stdout.splitlines()
    assert "step built at bounds [0, 3, 4]" in out
    assert [ln.split(":")[0] for ln in out if ln.startswith("step 1")] == [
        "step 11", "step 12"]
    assert out[-1].startswith("done: 2 steps")


def _compressed(name):
    """Under 1-bit and top-k each rank compresses its own flat vector --
    its stage's blocks and the replicated extras (``last``, ``embed``) --
    so the extras' synced gradients, and the clip scale with them, differ
    between stage ranks, in JAX's step as in the port's (JAX's global
    array is device 0's copy, which the tests compare: rank 0's)."""
    return CASES[name][4] in ("onebit", "topk", "topk_embed")


def _off(got, want):
    """{(path without its optimizer part, index)} of the elements outside
    the tolerance."""
    assert got.keys() == want.keys()
    out = set()
    for k in got:
        bad = ~np.isclose(got[k], want[k], rtol=RTOL, atol=ATOL)
        pos = k.split("/", 1)[1] if k.split("/")[0] in ("m", "v",
                                                        "master") else k
        out |= {(pos, tuple(int(i) for i in ix)) for ix in np.argwhere(bad)}
    return out


def _flip_places(name, off, opt, res_shape):
    """Mask over the gathered residual ``(data, model, stage, n)`` of the
    flat places of the positions ``off``: each rank's flat vector is its
    stage's blocks (leading dim 1), then the replicated extras, in tree
    order (the order of ``opt``'s ``m/`` keys), less a sparse-synced
    table.  A stage leaf's place is marked on every rank of its stage, an
    extra's on every rank."""
    assert CASES[name][2][1] == 1, name           # no TP shards to place
    sparse = ("embed",) if CASES[name][4] == "topk_embed" else ()
    where, start = {}, 0
    for key in opt:
        if not key.startswith("m/") or key.endswith("/") \
                or key.split("/")[1] in sparse:     # "/": an empty dict
            continue
        shape = opt[key].shape
        local = shape[1:] if key.startswith("m/stage/") else shape
        where[key[2:]] = (start, local)
        start += int(np.prod(local))
    assert start <= res_shape[-1], (name, start, res_shape)
    mask = np.zeros(res_shape, bool)
    for key, ix in off:
        first, local = where[key]
        if key.startswith("stage/"):
            mask[:, :, ix[0], first + np.ravel_multi_index(ix[1:], local)] \
                = True
        else:
            mask[..., first + np.ravel_multi_index(ix, local)] = True
    return mask


@pytest.mark.parametrize("name", list(CASES))
def test_pp_step_matches_jax(worlds, name):
    """Within tolerance everywhere, but where a decision is taken on a
    value within float noise of its boundary: the packages' gradients
    differ by ~1e-7 relative, so a 1-bit sign or a top-k pick can go the
    other way (d2s2_onebit), and Adam, dividing a synced gradient that
    cancelled to noise by its own root mean square, turns that noise into
    a step (deepseek_embed: m 9.40e-10 against 9.54e-10).  From then on
    the element's trajectory differs by up to an Adam step (lr) a step.
    Those cases may have ``FLIPS`` such positions, each within ``STEPS``
    Adam steps of JAX's value.  Their residual is held after every step
    up to the one at which a flip shows in it, everywhere but at the
    flips' own places: from the next step on, every gradient moves a
    little with the flipped parameter, and the residual carries the
    gradients at full precision (m, v and the parameters see only their
    compressed values, and stay held)."""
    ref, port = worlds
    j, p = ref[name], port[name]
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=RTOL,
                               err_msg=name)
    off = _off(p["p"], j["p"]) | _off(p["o"], j["o"])
    budget = FLIPS if _compressed(name) else 0
    assert len(off) <= budget, (name, sorted(off)[:8])
    for key, ix in off:
        gap = abs(float(p["p"][key][ix]) - float(j["p"][key][ix]))
        assert gap <= STEPS * LR, (name, key, ix, gap)
    if budget:
        assert p["res"].shape == j["res"].shape and len(j["res"]) == STEPS
        flips = _flip_places(name, off, j["o"], j["res"].shape[1:])
        shown = False
        for t in range(STEPS):
            np.testing.assert_allclose(
                p["res"][t][~flips], j["res"][t][~flips], rtol=RTOL,
                atol=ATOL, err_msg=f"{name} residual after step {t + 1}")
            shown = not np.allclose(p["res"][t][flips], j["res"][t][flips],
                                    rtol=RTOL, atol=ATOL)
            if shown:
                break
        assert np.abs(j["res"]).max() > 0, name


@pytest.mark.parametrize("how", ["1f1b", "gpipe", "autograd"])
def test_two_stage_value_and_grad_matches_jax(worlds, how):
    """On two stages (bounds ``[0, 1, 4]``, 6 rows in 4 micro-batches,
    masks): the executor under either schedule and the autograd GPipe
    (sends whose backward is the reverse send) give JAX's autodiff GPipe
    loss and its stage, head and input gradients; ``make_pipeline_loss``
    JAX's mean."""
    ref, port = worlds
    j, p = ref["vag"], port[f"vag_{how}"]
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=RTOL)
    assert p["p"].keys() == j["p"].keys()
    for k in j["p"]:
        np.testing.assert_allclose(p["p"][k], j["p"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=f"{how} {k}")


def test_rebalance_moves_bounds_params_and_moments_as_jax(worlds):
    """Pinned times ``[n0, 3 n1]`` move ``[0, 1, 6]`` to ``[0, 3, 6]``,
    then to ``[0, 4, 6]`` (each re-carve re-attributes the times), as
    JAX's rebalancer moves them; the remapped state right after the first
    move equals JAX's."""
    ref, port = worlds
    j, p = ref["rebalance"], port["rebalance"]
    np.testing.assert_array_equal(p["history"], j["history"])
    assert j["history"].tolist() == [[0, 1, 6], [0, 3, 6], [0, 4, 6]]
    assert not _off(p["remapped"], j["remapped"])


def _launch_main(argv):
    """The training launcher with the test's hooks: ``PP_TEST_LAYERS``
    sets the reduced configs' depth, ``PP_TEST_FAIL_AT`` kills the loop
    after that step, the stage times are :func:`pinned_times`, and rank 0
    prints the bounds each pipelined step is built at."""
    from repro_torch import config
    from repro_torch.launch import train
    from repro_torch.runtime import trainer
    torch.set_num_threads(1)
    if os.environ.get("PP_TEST_LAYERS"):
        config.reduced = functools.partial(
            config.reduced, layers=int(os.environ["PP_TEST_LAYERS"]))
    if os.environ.get("PP_TEST_FAIL_AT"):
        trainer.train_loop = functools.partial(
            trainer.train_loop, fail_at=int(os.environ["PP_TEST_FAIL_AT"]))
    trainer.probe_stage_times = pinned_times
    build = trainer.make_pp_train_step

    def built(cfg, mesh, tcfg, bounds, *a, **kw):
        if dist.get_rank() == 0:
            print(f"step built at bounds {list(bounds)}", flush=True)
        return build(cfg, mesh, tcfg, bounds, *a, **kw)
    trainer.make_pp_train_step = built
    return train.main(argv)


def _subprocess_main(argv):
    side, world, out_path, init_path, *rest = argv
    data = np.load(init_path)
    init = {}
    for key in data.files:
        name, path = key.split("|")
        init.setdefault(name, {})[path] = data[key]
    if side == "jax":
        out = run_jax(init, [n for n in world.split(",") if n != "vag"])
        if "vag" in world.split(","):
            out.update(vag_jax(init))
    else:
        world = int(world)
        rank, store_path = int(rest[0]), rest[1]
        torch.set_num_threads(1)
        dist.init_process_group("gloo",
                                store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        try:
            out = run_port(init, WORLDS[world])
            if world == 2:
                out.update(vag_port(init))
        finally:
            dist.destroy_process_group()
    _save(out_path, out)


if __name__ == "__main__":
    if sys.argv[1] == "launch":
        sys.exit(_launch_main(sys.argv[2:]))
    _subprocess_main(sys.argv[1:])
