"""Training launcher: any uniform --arch (dense or MoE) or rwkv6-1.6b at
any scale on the world ``torchrun`` gives, or on a world of one (port of
``repro/launch/train.py``; jamba is not registered: its mamba layers
are not ported, ROADMAP.md).

The step is ``runtime.trainer.make_hybrid_train_step`` under the plan
``core.hybrid.auto_plan`` picks for the ``(data, model)`` mesh: Megatron
TP over ``model`` (or ``dp_heavy``; the MoE archs' experts over ``model``,
expert parallelism; rwkv6's heads and channel-mix ``d_ff`` over
``model``), DP over ``data``, ZeRO-1/2, remat,
``--pp-micro`` micro-batches of gradient accumulation, checkpoints every
``max(steps // 4, 10)`` steps into ``--ckpt-dir`` and ``--resume`` from
the latest.  NCCL on GPUs, gloo on CPUs; runs on the GPU unless
``--device cpu``; weights are random, drawn from seed 0:

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --reduced --steps 50 --batch 16 --seq 64 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch olmo-1b --data 2 --model 2 --steps 20 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-30b-a3b --layers 4 --steps 6 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --reduced --steps 12 --batch 8 --seq 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --steps 6 --batch 8 --seq 512 --lr 1e-4

``--pp-stages N`` (N > 1) switches to the pipelined DP x TP x stage path
(``trainer.make_pp_train_step``) on a ``(data, model, stage)`` mesh: the
planner's balanced layer bounds slice the transformer into stages, the
1F1B (or GPipe, ``--pp-schedule``) schedule drives them over
``--pp-micro`` micro-batches, the DP gradient sync (``--grad-sync``)
composes across ``data``, ``--pp-rebalance-every K`` re-carves the
bounds from measured stage times every K steps, and the checkpoints
carry the bounds, which ``--resume`` restores:

  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch olmo-1b --data 2 --model 2 --pp-stages 2 --pp-micro 4 \\
      --steps 10 --batch 16 --seq 512

``--remat on|off`` overrides the hybrid plan's remat choice (default
``auto``); ``--layers N`` keeps the arch's first N layers (the JAX
launcher has no such flag); ``--host-devices`` (a JAX host-platform
setting) has no meaning here and is refused.  An MoE arch or rwkv6 with
``--pp-stages > 1`` raises, as in JAX: the pipelined path drops the MoE
aux losses and slices only the uniform family into stages.  A
``--model`` over which the heads, ``d_ff``, experts or padded vocab do
not split raises too, naming ROADMAP.md (JAX's guard replicates those
blocks).
"""
import argparse
import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU-friendly, float32)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the arch's first N layers at its published "
                         "widths (a depth cut to fit the cards; 0: all)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", type=int, default=1, help="dp mesh size")
    ap.add_argument("--model", type=int, default=1, help="tp mesh size")
    ap.add_argument("--pp-stages", type=int, default=1,
                    help="pipeline stages (>1 enables the pipelined path)")
    ap.add_argument("--pp-micro", type=int, default=4,
                    help="pipeline micro-batches per step (on the hybrid "
                         "path: gradient accumulation)")
    ap.add_argument("--pp-schedule", default="1f1b",
                    choices=("1f1b", "gpipe"))
    ap.add_argument("--pp-rebalance-every", type=int, default=0,
                    help="every K steps, re-carve the layer->stage bounds "
                         "from measured per-stage times and live-remap "
                         "params/optimizer (0 = off)")
    ap.add_argument("--grad-sync", default="flat",
                    choices=("flat", "hierarchical", "onebit", "topk"),
                    help="DP gradient sync mode on the pipelined path")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="JAX's host-device count: refused here")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--trace-out", default="",
                    help="write the training span timeline here (train_step "
                         "/ rebalance.probe / checkpoint spans, plus "
                         "per-stage stage_tick spans from rebalance probes "
                         "on the pipelined path): .jsonl for raw events, "
                         "anything else for Chrome-trace/Perfetto JSON")
    ap.add_argument("--remat", default="auto", choices=("auto", "on", "off"),
                    help="override the hybrid plan's remat choice")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.host_devices is not None:
        ap.error("--host-devices sets JAX's host-platform device count; the "
                 "port takes its world from torchrun (or a world of one)")
    return args


def _init_world(device: torch.device) -> None:
    """The world torchrun describes in the environment, else a world of
    one."""
    from repro_torch.core import hierarchical
    if "WORLD_SIZE" not in os.environ:
        hierarchical.init_world_of_one(device)
    else:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


def run(args: argparse.Namespace, tracer=None, pipelined=None):
    """Train as the flags say; returns (``TrainResult``, plan).  A
    ``tracer`` given here records the run's spans (``--trace-out`` makes
    one of its own).  ``pipelined`` forces the pipelined path on (at any
    ``--pp-stages``, a ``stage`` axis of 1 included) or off; by default it
    runs when ``--pp-stages > 1``."""
    from repro_torch import convert, resolve_device
    from repro_torch.config import (ParallelConfig, ShapeConfig,
                                    TrainConfig, get_arch, list_archs,
                                    reduced)
    from repro_torch.core.hybrid import auto_plan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.obs import Tracer, write_trace
    from repro_torch.tree import tree_leaves

    if args.arch not in list_archs():
        raise SystemExit(f"unknown arch {args.arch}; have {list_archs()}")
    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    pp = max(args.pp_stages, 1)
    if pipelined is None:
        pipelined = pp > 1
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if pipelined:
        tf.check_stage_slicing(cfg)
    _init_world(device)
    try:
        lead = dist.get_rank() == 0
        mesh = make_host_mesh(data=args.data, model=args.model,
                              stage=pp if pipelined else 0)
        shape = ShapeConfig("cli", args.seq, args.batch, "train")
        pcfg = ParallelConfig(dp=args.data, tp=args.model, pp=pp,
                              microbatches=args.pp_micro,
                              pp_schedule=args.pp_schedule)
        plan = auto_plan(cfg, mesh, shape, pcfg)
        if args.remat != "auto":
            plan = dataclasses.replace(plan, remat=args.remat == "on")
        tcfg = TrainConfig(steps=args.steps, learning_rate=args.lr,
                           warmup_steps=max(args.steps // 20, 2),
                           checkpoint_dir=args.ckpt_dir,
                           checkpoint_every=max(args.steps // 4, 10))
        if args.trace_out and tracer is None:
            tracer = Tracer()
        gen = torch.Generator(device=device).manual_seed(0)
        params = convert.init_params(cfg, gen, device)
        n = sum(x.numel() for x in tree_leaves(params))
        if lead:
            print(f"{cfg.name}: {n/1e6:.1f}M params on mesh "
                  f"data={args.data} model={args.model} stage={pp}; "
                  f"plan notes: {plan.notes}")
        train = _pipelined if pipelined else _hybrid
        box = [params]          # the path takes the only reference
        del params
        res = train(args, cfg, mesh, plan, tcfg, box, device, tracer, lead)
        if lead:
            print(f"done: {res.steps_run} steps, host throughput "
                  f"{res.throughput:.1f} samples/s, final loss "
                  f"{res.losses[-1]:.4f}")
            if res.aux:         # MoE: the last step's Switch aux losses
                print(f"moe aux: lb_loss {res.aux[-1]['lb_loss']:.4f}, "
                      f"z_loss {res.aux[-1]['z_loss']:.4f} (summed over "
                      f"{cfg.num_layers} layers)")
            if args.trace_out:
                nev = write_trace(args.trace_out, tracer)
                print(f"trace: {nev} events -> {args.trace_out} "
                      f"(open at https://ui.perfetto.dev)")
        return res, plan
    finally:
        dist.destroy_process_group()


def _batches(args, cfg, device, start):
    from repro_torch.data import pipeline
    for b in pipeline.synthetic_lm_batches(
            cfg.vocab_size, args.batch, args.seq, args.steps - start,
            seed=start):
        yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _hybrid(args, cfg, mesh, plan, tcfg, box, device, tracer, lead):
    """The GSPMD-hybrid path's port: TP x DP.  ``box`` holds the full
    params, which the path takes out (so they can be freed)."""
    from repro_torch.core import sharding
    from repro_torch.runtime import trainer
    params = box.pop()
    step, shardings_for = trainer.make_hybrid_train_step(
        cfg, plan, tcfg, params_shape=params)
    psh, osh, _ = shardings_for(params,
                                next(_batches(args, cfg, device, 0)))
    state_sh = {"params": psh, "opt": osh}
    shards = sharding.device_put(params, psh)
    state = {"params": shards,
             "opt": trainer.init_hybrid_opt(cfg, plan, shards, params)}
    del params
    start = 0
    if args.resume:
        start, state = trainer.resume_or_init(state, tcfg, state_sh)
    return trainer.train_loop(
        state, _batches(args, cfg, device, start), step, tcfg,
        start_step=start, samples_per_batch=args.batch, verbose=lead,
        log_every=max(args.steps // 10, 1), tracer=tracer,
        shardings=state_sh)


def _pipelined(args, cfg, mesh, plan, tcfg, box, device, tracer, lead):
    """The pipelined DP x TP x stage path (``box`` as in :func:`_hybrid`).
    The stage bodies take the model knobs the hybrid step sets itself:
    attention in chunks of ``ModelCtx``'s default 1024 tokens and the
    flash backward when there is no TP.  The error-feedback residual is
    allocated for the compressed syncs only (the JAX launcher allocates
    it for every mode; flat and hierarchical never read it)."""
    from repro_torch.core import sharding
    from repro_torch.models import transformer as tf
    from repro_torch.optimizer import adamw
    from repro_torch.runtime import trainer
    bounds = list(plan.stage_bounds)
    ctx = tf.ModelCtx(flash_vjp=args.model == 1)
    scfg = trainer.DPSyncConfig(mode=args.grad_sync)
    full = tf.pp_partition_params(cfg, box.pop(), bounds)
    sh = trainer.pp_shardings(cfg, mesh, full, scfg)
    n_res = (trainer.pp_residual_size(cfg, full, mesh, scfg)
             if scfg.mode in ("onebit", "topk") else 0)
    local = sharding.device_put(full, sh["params"])
    del full
    state = {"params": local,
             "opt": adamw.init_opt_state(trainer.pp_trainable(
                 local, cfg.tie_embeddings)),
             "residual": torch.zeros((1, 1, 1, n_res), device=device),
             "stage_bounds": torch.tensor(bounds, dtype=torch.int32,
                                          device=device)}
    start = 0
    if args.resume:
        start, state = trainer.resume_or_init(state, tcfg, sh)
        # checkpoints restore by key (shapes come from disk): a run
        # rebalanced mid-flight restores its moved carve points, and the
        # step must be rebuilt at THOSE bounds, not the planner's
        bounds = [int(b) for b in state["stage_bounds"]]
    pp_shape = trainer.global_shapes(cfg, mesh, state["params"])
    step = trainer.make_pp_train_step(
        cfg, mesh, tcfg, bounds, pp_shape, n_micro=args.pp_micro,
        pp_schedule=args.pp_schedule, scfg=scfg, ctx=ctx)
    rebal = None
    if args.pp_rebalance_every:
        rebal = trainer.PPRebalancer(
            cfg, mesh, tcfg, bounds, n_micro=args.pp_micro,
            pp_schedule=args.pp_schedule, scfg=scfg, ctx=ctx, tracer=tracer)
    res = trainer.train_loop(
        state, _batches(args, cfg, device, start), step, tcfg,
        start_step=start, samples_per_batch=args.batch, verbose=lead,
        rebalance_every=args.pp_rebalance_every, rebalance_fn=rebal,
        log_every=max(args.steps // 10, 1), tracer=tracer, shardings=sh)
    if lead and rebal is not None and len(rebal.history) > 1:
        print(f"stage bounds rebalanced {len(rebal.history) - 1}x: "
              f"{rebal.history[0]} -> {rebal.history[-1]}")
    return res


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
