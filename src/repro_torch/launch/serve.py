"""Serving launcher: the continuous-batching engine under simulated recsys
load (port of ``repro/launch/serve.py``, engine mode, greedy one-token and
speculative decode of the uniform family, one-token decode of rwkv6).

Runs on the GPU unless ``--device cpu``; reports throughput and p50/p95/p99
TTFT / per-token latency against SLO tiers:

  PYTHONPATH=src python -m repro_torch.launch.serve --slots 8 --max-len 512 \\
      --attn-impl flash --decode-impl flash
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --cache-layout paged --kv int8 --decode-impl flash
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch moonshot-v1-16b-a3b --kernels --attn-impl flash \\
      --decode-impl flash
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --kernels --slots 8 --max-len 512

``--attn-impl flash`` runs prefill attention through the CUDA flash-attention
kernel (the JAX package's ``pallas`` value); ``--decode-impl flash`` runs
every decode step through the CUDA flash-decode kernel of the cache layout;
``--kernels`` sets ``ModelCtx.use_kernels``, the JAX package's switch of
that name, which drives every kernel of the model stack: every MoE FFN
routes through the CUDA router kernel, and every rwkv6 prefill's WKV
recurrence runs through the CUDA chunked-WKV6 kernel.  rwkv6
serves under the dense and paged layouts; ``--kv int8`` exits with the
reference's error (it carries no KV).  The layout flags (``--kv``,
``--cache-layout``, ``--block-size``, ``--num-blocks``,
``--no-prefix-sharing``) fold into one
:class:`~repro_torch.cache_layout.CacheLayout`, as in the JAX launcher.
Weights are random, drawn from ``--seed``.

``--spec-k N`` turns on speculative decode: each step self-drafts up to
N - 1 tokens a slot from the request's own prompt and output
(``--spec-draft ngram``, no second model) and verifies every row in one
k-row decode through the layout's decode path (the k-row forms of the
flash-decode kernels under ``--decode-impl flash``); greedy streams equal
one-token decode's, and ``--json`` prints the summary's ``spec`` block
(accepted tokens and verify rows per slot-step):

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --spec-k 4 --cache-layout paged --decode-impl flash

``--candidates N`` attaches a head-heavy (Zipfian) candidate item set to
every request and ``--cf-plan replicated`` mounts the CF scoring head: each
request is then a retrieval->rank call (LM prefill, CF factor lookup, gated
fusion, candidate ranking).  ``--cf-cache-rows`` sizes a hot-row replica
in front of each table's device gather (scores are bit-identical with the
cache on or off).  It is off by default: on the replicated plan its
per-lookup election costs more than the gathers it saves (``PERF.md``);
it is there for the sharded plans' exchange.  ``--cf-plan row|col|row_col``
mounts the head with its tables sharded by that plan on a
``torch.distributed`` world of one (NCCL on the card, gloo with
``--device cpu``), as the JAX launcher mounts it on a 1x1 mesh: the
plan's sharded lookup and its collectives run, over one rank; a
deployment hands in its training mesh.  ``--trace-out FILE`` writes the
measured run's spans and metrics (``.jsonl`` raw events, anything else
Chrome-trace JSON for https://ui.perfetto.dev):

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --candidates 8 --cf-plan replicated --trace-out trace.json
"""
import argparse
import dataclasses
import json

import torch
import torch.distributed as dist

from repro_torch import convert, resolve_device
from repro_torch.cache_layout import CacheLayout
from repro_torch.config import get_arch, list_archs, reduced
from repro_torch.core import hierarchical
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import ModelCtx
from repro_torch.obs import MetricsRegistry, Tracer, write_trace
from repro_torch.serving import (CFHead, EngineConfig, ServingEngine,
                                 TrafficConfig, generate, make_backend)
from repro_torch.serving.metrics import format_report

SHARDED = ("row", "col", "row_col")     # CF plans served over a mesh


def run_engine(args) -> int:
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = convert.init_params(cfg, gen, device)

    defaults = TrafficConfig()
    tcfg = TrafficConfig(
        n_requests=args.requests, rate=args.rate, process=args.process,
        prompt_max=max(defaults.prompt_min, min(48, args.max_len // 2)),
        new_tokens_max=max(defaults.new_tokens_min,
                           min(24, args.max_len // 4)),
        vocab_size=cfg.vocab_size, seed=args.seed,
        # recsys retrieval->rank: per-request candidate item sets (drawn
        # from a separate rng stream: the base workload is unperturbed)
        candidates=args.candidates)
    requests = generate(tcfg)

    layout = CacheLayout(kind=args.cache_layout,
                         kv_bits=8 if args.kv == "int8" else 16,
                         impl=args.decode_impl,
                         block_size=args.block_size,
                         num_blocks=args.num_blocks,
                         prefix_sharing=not args.no_prefix_sharing)
    ecfg = EngineConfig(n_slots=args.slots, max_len=args.max_len,
                        queue_capacity=args.queue_capacity,
                        refill=args.refill, sample_seed=args.seed,
                        layout=layout, spec_k=args.spec_k,
                        spec_draft=args.spec_draft)
    ctx = ModelCtx(attn_impl=args.attn_impl, attn_chunk=8,
                   use_kernels=args.kernels)

    own_world = args.cf_plan in SHARDED and not dist.is_initialized()
    if own_world:
        hierarchical.init_world_of_one(device)
    try:
        return _serve(args, cfg, params, device, tcfg, requests, layout,
                      ecfg, ctx)
    finally:
        if own_world:
            dist.destroy_process_group()


def _serve(args, cfg, params, device, tcfg, requests, layout, ecfg,
           ctx) -> int:
    mesh = make_host_mesh() if args.cf_plan in SHARDED else None

    def mk_cf_head():
        if args.cf_plan == "off":
            return None
        return CFHead.build(
            n_users=tcfg.n_users, n_items=cfg.vocab_size, cf_dim=16,
            seed=args.seed, plan=args.cf_plan,
            cache_rows=args.cf_cache_rows, device=device, mesh=mesh)

    def mk_server(tracer=None, metrics=None):
        backend = make_backend(cfg, params, ctx, layout=layout,
                               device=device)
        return ServingEngine(backend, ecfg, tracer=tracer, metrics=metrics,
                             cf_head=mk_cf_head())

    try:
        if not args.no_warmup:
            # first-use costs (kernel builds, CUDA context, cuBLAS handles)
            # stay outside the measured run, as in a resident server
            mk_server().run(requests)
        # tracing is scoped to the measured run only, never the warm-up
        tracer = Tracer() if args.trace_out else None
        metrics = MetricsRegistry() if args.trace_out else None
        server = mk_server(tracer, metrics)
    except (ValueError, NotImplementedError) as e:
        # layout/family/spec_k mismatches
        raise SystemExit(str(e))
    outputs, records, summary = server.run(requests)

    title = (f"{cfg.name} {args.cache_layout} kv={args.kv} "
             f"attn={args.attn_impl} "
             f"decode={args.decode_impl} kernels={args.kernels} "
             f"refill={args.refill} "
             f"slots={args.slots} {args.process}@{args.rate:g}req/s "
             f"on {device}")
    print(format_report(summary, title))
    if "cf" in summary:
        s = summary["cf"]
        print(f"cf head: plan={s['plan']} scored={s['requests_scored']} "
              f"cache_rows={s['cache_rows']} (live {s['cache_rows_live']}) "
              f"hit_rate={s['hit_rate']:.3f} "
              f"({s['hits']} hits / {s['misses']} misses)")
    if args.trace_out:
        n = write_trace(args.trace_out, tracer, metrics)
        print(f"trace: {n} events -> {args.trace_out} "
              f"(open at https://ui.perfetto.dev)")
    if args.json:
        print(json.dumps(summary, indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recllm-base", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda unless asked)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=64.0)
    ap.add_argument("--process", default="poisson",
                    choices=("poisson", "bursty"))
    ap.add_argument("--kv", default="native", choices=("native", "int8"))
    ap.add_argument("--cache-layout", default="dense",
                    choices=("dense", "paged"),
                    help="KV cache layout: dense per-slot (B, S, ...) rows "
                         "or the shared block pool with per-slot block "
                         "tables, prefix sharing and copy-on-write")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged layout: KV rows per physical block")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged layout: pool size in blocks (0 = auto: one "
                         "dense footprint, slots*max_len/block_size); set "
                         "below auto to oversubscribe and exercise "
                         "admission queueing")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="paged layout: disable content-hash prompt-prefix "
                         "block sharing")
    ap.add_argument("--attn-impl", default="chunked",
                    choices=("naive", "chunked", "flash"),
                    help="prefill attention: plain (naive/chunked) or the "
                         "CUDA flash-attention kernel")
    ap.add_argument("--decode-impl", default="dense",
                    choices=("dense", "flash"),
                    help="decode attention: dense einsum over the padded "
                         "(or gathered paged) cache, or the CUDA "
                         "flash-decode kernel of the layout")
    ap.add_argument("--kernels", action="store_true",
                    help="ModelCtx.use_kernels: every hand-written kernel "
                         "of the model stack (MoE: the CUDA router kernel; "
                         "rwkv6: each prefill's WKV recurrence through the "
                         "CUDA chunked-WKV6 kernel) instead of its plain "
                         "version")
    ap.add_argument("--spec-k", type=int, default=1,
                    help="speculative decode: verify up to this many token "
                         "rows per slot per step (1 = one-token decode; "
                         "KV families only: rwkv6 refuses)")
    ap.add_argument("--spec-draft", default="ngram", choices=("ngram",),
                    help="speculative draft source: self-speculative n-gram "
                         "lookup over the request's own prompt + output "
                         "(no second model)")
    ap.add_argument("--candidates", type=int, default=0,
                    help="recsys retrieval->rank: head-heavy (Zipfian) "
                         "candidate item ids per request the CF head "
                         "scores and ranks (0 = plain LM serving)")
    ap.add_argument("--cf-plan", default="off",
                    choices=("off", "replicated", "row", "col", "row_col"),
                    help="mount the CF scoring head with its cf_user/"
                         "cf_item factor tables under this plan (row/col/"
                         "row_col: sharded over a world of one)")
    ap.add_argument("--cf-cache-rows", type=int, default=0,
                    help="hot-row replica capacity per CF table: the "
                         "frequency-tracked head served from the host, "
                         "without a device gather (0 = cache off; scores "
                         "are bit-identical either way)")
    ap.add_argument("--refill", default="continuous",
                    choices=("continuous", "static"))
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--trace-out", default="",
                    help="write the measured run's span timeline + metrics "
                         "here: .jsonl for raw events, anything else for "
                         "Chrome-trace/Perfetto JSON")
    ap.add_argument("--json", action="store_true")
    return run_engine(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
