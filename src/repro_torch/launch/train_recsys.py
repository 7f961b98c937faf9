"""Train the paper's RecLLM recommender on the synthetic
Amazon-Electronics dataset through the data-parallel step, then rank with
HR@10 / NDCG@10 (port of ``examples/train_recsys.py``).

The step is ``runtime.trainer.make_dp_train_step`` over the world
``torchrun`` gives (NCCL on GPUs, gloo on CPUs), or over a world of one.
``--grad-sync`` picks the paper's sync: flat all-reduce (Eq. 8),
hierarchical all-reduce (C5), or 1-bit / top-k compression with error
feedback (C6, Eq. 10-11) through the CUDA kernels.  Runs on the GPU
unless ``--device cpu``; weights are random, drawn from ``--seed``:

  PYTHONPATH=src python -m repro_torch.launch.train_recsys --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train_recsys --device cpu \\
      --steps 20 --scale 0.005 --grad-sync onebit
  PYTHONPATH=src torchrun --nproc-per-node 4 -m \\
      repro_torch.launch.train_recsys --full --grad-sync topk

``--full`` trains RecLLM-base at full width (12 layers, d_model 768); the
default is ``reduced(recllm-base, layers=4)``.  With ``--ckpt-dir`` the run
resumes from that directory's latest checkpoint, if any, and checkpoints
every ``max(steps // 4, 25)`` steps, as the JAX example does (each rank's
compression residual is saved as its row of the ``(ranks, N)`` array).
``--embed-plan`` / ``--embed-mesh data,model`` print what that CF-table
sharding plan would cost on that mesh (``embeddings.plan_summary`` of each
table) before training; training itself is unchanged:

  PYTHONPATH=src python -m repro_torch.launch.train_recsys --full \\
      --embed-plan row_col --embed-mesh 8,4
"""
import argparse
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch import embeddings, resolve_device
from repro_torch.config import TrainConfig, get_arch, reduced
from repro_torch.core import hierarchical
from repro_torch.core.sharding import NamedSharding
from repro_torch.models.transformer import ModelCtx
from repro_torch.optimizer import adamw
from repro_torch.recsys import dataset, metrics, model as recmodel
from repro_torch.runtime import trainer
from repro_torch.tree import tree_leaves, tree_map


def init_world(device: torch.device) -> hierarchical.DPMesh:
    """The world torchrun describes in the environment, else a world of
    one."""
    if "WORLD_SIZE" not in os.environ:
        return hierarchical.init_world_of_one(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend)
    return hierarchical.make_dp_mesh()


def print_embed_plan(cfg, n_users: int, args) -> None:
    """What the ``--embed-plan`` placement of each CF table would cost on
    the ``--embed-mesh`` mesh (per-rank shard, modeled wire bytes)."""
    dp, mp = (int(x) for x in args.embed_mesh.split(","))
    mesh_shape = {"data": dp, "model": mp}
    plan = embeddings.make_plan(args.embed_plan)
    batch_per_dev = max(1, args.batch // dp)
    for spec in recmodel.embed_specs(cfg, n_users).values():
        try:
            s = embeddings.plan_summary(spec, plan, mesh_shape,
                                        batch_per_dev)
        except ValueError as e:                  # dims don't divide the mesh
            print(f"embed[{spec.name}] plan {plan.kind}: skipped ({e})")
            continue
        print(f"embed[{spec.name}] plan {plan.kind} on mesh {mesh_shape}: "
              f"shard ({s['shard_rows']},{s['shard_cols']}) = "
              f"{s['table_bytes_per_dev']/1e6:.2f} MB/dev, "
              f"exchange {s['modeled_exchange_bytes']['total']/1e6:.3f} "
              f"MB/step (sparse DP sync "
              f"{s['modeled_sparse_sync_bytes']/1e6:.3f} MB)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32,
                    help="global batch (split over the dp ranks)")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--scale", type=float, default=0.01,
                    help="dataset scale (1.0 = full Table 1 sizes)")
    ap.add_argument("--full", action="store_true",
                    help="train the full recllm-base (~178M params)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint here and resume from here (default: "
                         "no checkpoints)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-sync", default="flat",
                    choices=("flat", "hierarchical", "onebit", "topk"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--embed-plan", default="replicated",
                    choices=embeddings.PLANS,
                    help="CF-table sharding plan to cost (placement summary"
                         " printed before training)")
    ap.add_argument("--embed-mesh", default="8,4",
                    help="data,model mesh extents for the placement summary")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    mesh = init_world(device)
    try:
        return _train(args, device, mesh)
    finally:
        dist.destroy_process_group()


def _train(args, device, mesh) -> int:
    lead = dist.get_rank() == 0

    ds = dataset.generate(scale=args.scale, seed=0)
    if lead:
        print(f"dataset: {ds.n_users:,} users, {ds.n_items:,} items, "
              f"{len(ds.user):,} interactions (80/10/10 chronological)")
    base = get_arch("recllm-base")
    cfg = dataclasses.replace(
        base if args.full else reduced(base, layers=4),
        vocab_size=ds.n_items + 3, vocab_pad_to=64, dtype="float32")
    ctx = ModelCtx(attn_chunk=min(args.seq, 512))
    tcfg = TrainConfig(steps=args.steps, learning_rate=args.lr,
                       warmup_steps=max(args.steps // 20, 5),
                       checkpoint_every=(max(args.steps // 4, 25)
                                         if args.ckpt_dir else 0),
                       checkpoint_dir=args.ckpt_dir, keep_checkpoints=2)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = recmodel.init_recllm(cfg, ds.n_users, gen, device)
    n = sum(x.numel() for x in tree_leaves(params))
    if lead:
        print(f"RecLLM params: {n / 1e6:.1f}M  (backbone {cfg.num_layers}L "
              f"d={cfg.d_model}), {args.grad_sync} sync over "
              f"{mesh.size(('data',))} rank(s) on {device}")

    if lead:
        print_embed_plan(cfg, ds.n_users, args)

    scfg = trainer.DPSyncConfig(mode=args.grad_sync)
    # the residual as this rank's row of JAX's (ranks, N) array
    state = {"params": params, "opt": adamw.init_opt_state(params),
             "residual": torch.zeros((1, trainer.residual_size(params, scfg)),
                                     dtype=torch.float32, device=device)}
    whole = NamedSharding(mesh, ())
    shardings = {"params": tree_map(lambda _: whole, state["params"]),
                 "opt": tree_map(lambda _: whole, state["opt"]),
                 "residual": NamedSharding(mesh, ("data", None))}

    def loss_fn(p, b):
        return recmodel.recllm_loss(cfg, p, b, ctx)[0]

    dp_step = trainer.make_dp_train_step(loss_fn, mesh, tcfg, scfg)

    def step(params, opt, residual, batch):
        params, opt, residual, loss = dp_step(params, opt, residual[0],
                                              batch)
        return params, opt, residual[None], loss

    # fault tolerance: resume if a previous run died
    start = 0
    if args.ckpt_dir:
        start, state = trainer.resume_or_init(state, tcfg, shardings)
        if start and lead:
            print(f"resumed from checkpoint at step {start}")

    def batches():
        for b in dataset.seq_batches(ds, args.batch, args.seq,
                                     steps=args.steps - start, seed=start):
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    res = trainer.train_loop(state, batches(), step, tcfg, start_step=start,
                             samples_per_batch=args.batch, verbose=lead,
                             log_every=max(args.steps // 10, 1),
                             shardings=shardings)
    if lead:
        print(f"throughput: {res.throughput:.1f} samples/s (host)")

    # --- evaluation: HR@10 / NDCG@10 with history exclusion ---------------
    toks, gold, lens = dataset.eval_examples(ds, seq_len=args.seq,
                                             max_users=256)
    with torch.no_grad():
        scores = recmodel.score_users(
            cfg, state["params"], torch.from_numpy(toks).to(device),
            torch.zeros((toks.shape[0],), dtype=torch.int32, device=device),
            torch.from_numpy(lens).to(device), ctx)
        excl = torch.from_numpy(metrics.history_exclusion(
            toks, cfg.padded_vocab)).to(device)
        hr, ndcg = metrics.hr_ndcg_at_k(scores, torch.from_numpy(gold)
                                        .to(device), k=10, exclude=excl)
    if lead:
        print(f"HR@10 {float(hr):.4f}  NDCG@10 {float(ndcg):.4f}  "
              f"(random baseline HR@10 ~ {10 / ds.n_items:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
