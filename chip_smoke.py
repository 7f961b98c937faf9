#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py [--out report.json]

Needs one NVIDIA GPU (sm_90a: H100) and the CUDA toolkit's ``nvcc``; builds
the port's kernels from ``src/repro_torch/kernels/csrc`` first.  Phases, each
failing the run with a non-zero exit when its check fails:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the kernels' build time and ptxas resource report;
2. kernels against their plain PyTorch versions on the card: every case of
   ``tests/test_torch_kernels.py`` plus RecLLM-base's serving shapes, in
   float32 (tolerance 1e-4) and bfloat16 (2e-2, absolute), and at those
   shapes the time of the kernel, of the plain version and of one PyTorch
   call computing the same function (``scaled_dot_product_attention`` with
   the equivalent boolean mask, a yardstick the port never calls);
3. serving RecLLM-base at full width in bf16 (random weights from a seeded
   generator) through ``repro_torch.serving``: 16 Poisson requests on 8
   slots of 512 positions with both attention kernels on.  Every request
   must finish and each kernel must have launched once per layer per
   prefill / decode step.  Against the plain path (chunked prefill, dense
   decode) on the same card: the first prefill row and decode step logits
   within 2e-2 of the largest logit in bf16 and 1e-4 absolute in float32,
   and the float32 workload under a pinned clock gives the same greedy
   streams.  One more run under ``torch.profiler`` gives the device's busy
   share of the run and its top kernels.

It then prints the ``kernels`` JSON line (time, plain time, bound, library
time and main-path launches per kernel) and, last, the device JSON line.
Without CUDA, or without the rest of the repository beside it, it exits
non-zero before printing either.
"""
import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_TOL, BF16_TOL = 1e-4, 2e-2

# the cases of tests/test_torch_kernels.py (head_dim 32)
PREFILL_CASES = [  # (B, H, Hk, S, causal, window)
    (1, 2, 2, 40, True, 0), (2, 4, 1, 40, True, 8), (1, 4, 1, 33, True, 0),
    (1, 2, 2, 24, False, 0), (1, 4, 2, 37, False, 5),
]
DECODE_CASES = [  # (B, Sq, H, Hk, S, lengths, q_lens, window, ring)
    (4, 1, 2, 2, 40, [0, 1, 40, 17], None, 0, False),
    (4, 1, 8, 2, 40, [0, 1, 40, 23], None, 0, False),
    (4, 1, 2, 2, 40, [0, 1, 5, 40], None, 16, False),
    (4, 1, 2, 2, 16, [0, 3, 16, 29], None, 12, True),
    (4, 3, 2, 2, 40, [0, 5, 20, 38], [3, 1, 2, 3], 0, False),
    (4, 2, 8, 2, 16, [1, 7, 16, 25], [2, 1, 2, 2], 12, True),
    (3, 3, 2, 2, 40, [2, 30, 38], [3, 2, 1], 6, False),
]
CASE_D = 32
# RecLLM-base serving shapes
DECODE_MAIN = dict(B=8, S=512, H=12, Hk=12, D=64,
                   lengths=[1, 37, 64, 100, 200, 300, 450, 512])
PREFILL_MAIN = [dict(B=1, H=12, S=s, D=64) for s in (24, 200)]


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible; python "
          f"{sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(_build.SOURCES)} kernels with nvcc in "
          f"{build_s:.1f} s")
    for name, log in sorted(_build.ptxas_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    return {"card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s}


def _time_ms(torch, fn, flush, iters=30):
    """Mean device time of fn over ``iters`` calls, CUDA events around each,
    the 50 MB L2 flushed before each call (a serving step finds its
    layer's K/V cold: the other layers' caches ran through L2 since)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def phase_kernels(torch):
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"cases": [], "timing": {}}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def run_prefill(B, H, Hk, S, D, causal, window, dtype):
        q, k, v = (randn(B, n, S, D, dtype=dtype) for n in (H, Hk, Hk))
        got = ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        return (q, k, v), _max_err(got, want)

    def run_decode(B, Sq, H, Hk, S, D, lengths, q_lens, window, ring, dtype):
        q = randn(B, Sq, H, D, dtype=dtype)
        k, v = (randn(B, S, Hk, D, dtype=dtype) for _ in range(2))
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if q_lens is not None:
            q_lens = torch.tensor(q_lens, dtype=torch.int32, device=dev)
        kw = dict(window=window, ring=ring, q_lens=q_lens)
        got = ops.flash_decode(q, k, v, lengths, **kw)
        want = ref.decode_attention(q, k, v, lengths, **kw)
        return (q, k, v, lengths), _max_err(got, want)

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        for c in PREFILL_CASES:
            B, H, Hk, S, causal, window = c
            _, err = run_prefill(B, H, Hk, S, CASE_D, causal, window, dtype)
            report["cases"].append(["flash_attention", name, list(c), err])
            check(err <= tol, f"flash_attention {name} case {c}: max abs "
                              f"err {err} > {tol}")
        for c in DECODE_CASES:
            B, Sq, H, Hk, S, lengths, q_lens, window, ring = c
            _, err = run_decode(B, Sq, H, Hk, S, CASE_D, lengths, q_lens,
                                window, ring, dtype)
            report["cases"].append(["flash_decode", name, list(c), err])
            check(err <= tol, f"flash_decode {name} case {c}: max abs err "
                              f"{err} > {tol}")
        print(f"[kernels] {name}: {len(PREFILL_CASES)} flash_attention and "
              f"{len(DECODE_CASES)} flash_decode cases within {tol} of the "
              f"plain versions (worst "
              f"{max(e for _, n, _, e in report['cases'] if n == name):.3g})")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    F = torch.nn.functional

    # decode at RecLLM-base's serving shape, ragged lengths
    m = DECODE_MAIN
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        (q, k, v, lengths), errs[dtype] = run_decode(
            m["B"], 1, m["H"], m["Hk"], m["S"], m["D"], m["lengths"], None,
            0, False, dtype)
    check(errs[torch.float32] <= F32_TOL and errs[torch.bfloat16] <= BF16_TOL,
          f"flash_decode at the serving shape: errors {errs}")
    pos = torch.arange(m["S"], device=dev)
    mask = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    live = sum(m["lengths"])
    esz = 2
    nbytes = (2 * live * m["Hk"] * m["D"] * esz           # live K and V
              + 2 * m["B"] * m["H"] * m["D"] * esz + 4 * m["B"])  # q, o, len
    flops = 4 * live * m["H"] * m["D"]
    t = {"shape": (f"B={m['B']} S={m['S']} H=Hk={m['H']} D={m['D']} bf16, "
                   f"lengths {m['lengths']}"),
         "max_abs_err": errs[torch.bfloat16], "tol": BF16_TOL,
         "ms": _time_ms(torch, lambda: ops.flash_decode(q, k, v, lengths),
                        flush),
         "plain_ms": _time_ms(torch, lambda: ref.decode_attention(
             q, k, v, lengths), flush),
         "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
             qt, kt, vt, attn_mask=mask), flush),
         "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
         "ops_ms": flops / BF16_FLOPS_PER_S * 1e3}
    report["timing"]["flash_decode"] = [t]

    # prefill at RecLLM-base's prompt shapes
    report["timing"]["flash_attention"] = []
    for m in PREFILL_MAIN:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            (q, k, v), errs[dtype] = run_prefill(m["B"], m["H"], m["H"],
                                                 m["S"], m["D"], True, 0,
                                                 dtype)
        check(errs[torch.float32] <= F32_TOL
              and errs[torch.bfloat16] <= BF16_TOL,
              f"flash_attention at S={m['S']}: errors {errs}")
        causal = torch.ones(m["S"], m["S"], dtype=torch.bool,
                            device=dev).tril()
        S, n = m["S"], m["B"] * m["H"] * m["S"] * m["D"]
        flops = 4 * m["B"] * m["H"] * m["D"] * S * (S + 1) // 2
        t = {"shape": f"B={m['B']} H=Hk={m['H']} S={S} D={m['D']} bf16 "
                      "causal",
             "max_abs_err": errs[torch.bfloat16], "tol": BF16_TOL,
             "ms": _time_ms(torch, lambda: ops.flash_attention_bhsd(q, k, v),
                            flush),
             "plain_ms": _time_ms(torch, lambda: ref.flash_attention(
                 q, k, v), flush),
             "library_ms": _time_ms(
                 torch, lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=causal), flush),
             "bytes_ms": 4 * n * 2 / HBM_BYTES_PER_S * 1e3,
             "ops_ms": flops / BF16_FLOPS_PER_S * 1e3}
        report["timing"]["flash_attention"].append(t)
    for name, rows in report["timing"].items():
        for t in rows:
            t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
            t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                             else "operations")
            print(f"[time {name}] {t['shape']}: kernel {t['ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, sdpa "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
                  f"({t['bound_by']}), max abs err {t['max_abs_err']:.3g}")
    return report


def _first_divergence(a, b):
    for rid in sorted(a):
        for i, (x, y) in enumerate(zip(a[rid], b[rid])):
            if x != y:
                return rid, i
        if len(a[rid]) != len(b[rid]):
            return rid, min(len(a[rid]), len(b[rid]))
    return None


def _device_time(torch, fn):
    """Run fn under torch.profiler; return the summed GPU kernel time by
    kernel name (ms).  Kernels on one stream never overlap, so the sum is
    the time the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
    return by_name


def phase_serving(torch):
    from repro_torch import convert
    from repro_torch.config import get_arch
    from repro_torch.kernels.decode_attention import flash_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (Clock, EngineConfig, ServingEngine,
                                     TrafficConfig, generate, make_backend)
    dev = torch.device("cuda")
    cfg = get_arch("recllm-base")
    ecfg = EngineConfig(n_slots=8, max_len=512)
    requests = generate(TrafficConfig(n_requests=16,
                                      vocab_size=cfg.vocab_size, seed=0))
    kern = tf.ModelCtx(attn_impl="flash", decode_impl="flash", attn_chunk=8)
    plain = tf.ModelCtx(attn_chunk=8)       # chunked prefill, dense decode

    def params_for(c):
        return convert.init_params(
            c, torch.Generator(device=dev).manual_seed(0), dev)

    def run(c, params, ctx, clock=None):
        engine = ServingEngine(make_backend(c, params, ctx, device=dev),
                               ecfg, clock)
        return engine.run(requests)

    params = params_for(cfg)
    run(cfg, params, kern)                  # warm-up: CUDA and cuBLAS init
    flash_attention.launches = 0
    flash_decode_attention.launches = 0
    t0 = time.perf_counter()
    outputs, records, summary = run(cfg, params, kern)
    wall_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    L = cfg.num_layers
    check(summary["finished"] == len(requests) and summary["rejected"] == 0,
          f"served {summary['finished']}/{len(requests)} requests")
    check(launches["flash_attention"] == L * summary["prefills"],
          f"flash_attention launched {launches['flash_attention']} times "
          f"for {summary['prefills']} prefills of {L} layers")
    check(launches["flash_decode"] == L * summary["decode_steps"],
          f"flash_decode launched {launches['flash_decode']} times for "
          f"{summary['decode_steps']} decode steps of {L} layers")
    t, p = summary["ttft_s"], summary["tpot_s"]
    print(f"[serve] {cfg.name} bf16, {ecfg.n_slots} slots x "
          f"{ecfg.max_len}: {summary['finished']}/{len(requests)} requests, "
          f"{summary['tokens_out']} tokens, {summary['prefills']} prefills, "
          f"{summary['decode_steps']} decode steps in {wall_s:.3f} s; "
          f"{summary['throughput_tok_s']:.1f} tok/s; TTFT p50 "
          f"{t['p50'] * 1e3:.2f} ms p99 {t['p99'] * 1e3:.2f} ms; TPOT p50 "
          f"{p['p50'] * 1e3:.2f} ms p99 {p['p99'] * 1e3:.2f} ms")
    print(f"[serve] launches: flash_attention {launches['flash_attention']} "
          f"= {L} x {summary['prefills']} prefills, flash_decode "
          f"{launches['flash_decode']} = {L} x {summary['decode_steps']} "
          "decode steps")

    # where the time goes: the same workload once more under the profiler;
    # device busy time over the measured (unprofiled) run's wall time
    by_name = _device_time(torch, lambda: run(cfg, params, kern))
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    profile = {"device_busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
               "busy_share": busy_ms / (wall_s * 1e3),
               "top_kernels_ms": top}
    if busy_ms > 0:
        print(f"[profile] device busy {busy_ms:.2f} ms of the run's "
              f"{wall_s * 1e3:.1f} ms wall ({profile['busy_share']:.1%}); "
              "top kernels: " + "; ".join(
                  f"{n[:48]} {ms:.2f} ms" for n, ms in top))
    else:
        print("[profile] the profiler recorded no device time: device busy "
              "share not measured")

    # first prefill row and first decode step: kernels vs plain path, in
    # bf16 (max abs diff relative to the largest plain logit: two bf16
    # paths that round attention probabilities at different places differ
    # by a few ulps of the largest logits) and in float32 (absolute)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = params_for(cfg32)
    req = requests[0]
    s_pad = -(-len(req.prompt) // 8) * 8
    toks = torch.zeros((1, s_pad), dtype=torch.long, device=dev)
    toks[0, :len(req.prompt)] = torch.tensor(req.prompt, device=dev)
    logit_errs = {}
    for dname, c, ps, tol, relative in (
            ("bfloat16", cfg, params, BF16_TOL, True),
            ("float32", cfg32, params32, F32_TOL, False)):
        rows, steps = {}, {}
        with torch.inference_mode():
            for name, ctx in (("kernels", kern), ("plain", plain)):
                cache = tf.init_slots(c, ecfg.n_slots, ecfg.max_len,
                                      device=dev)
                rows[name], cache = tf.prefill_into_slot(
                    c, ps, cache, toks, len(req.prompt), 0, ctx)
                nxt = torch.zeros((ecfg.n_slots, 1), dtype=torch.long,
                                  device=dev)
                nxt[0, 0] = torch.argmax(rows["kernels"])
                steps[name], _ = tf.decode_step(c, ps, cache, nxt, ctx)
        scale = (max(float(rows["plain"].float().abs().max()),
                     float(steps["plain"].float().abs().max()))
                 if relative else 1.0)
        e = {"prefill_abs": _max_err(rows["kernels"], rows["plain"]),
             "decode_abs": _max_err(steps["kernels"], steps["plain"]),
             "largest_logit": scale if relative else None}
        logit_errs[dname] = e
        what = (f"relative to the largest logit {scale:.3g}" if relative
                else "absolute")
        print(f"[serve] {dname} logits, kernels vs plain path: first "
              f"prefill row max abs diff {e['prefill_abs']:.3g}, first "
              f"decode step {e['decode_abs']:.3g} (tolerance {tol} {what})")
        check(max(e["prefill_abs"], e["decode_abs"]) <= tol * scale,
              f"{dname} logits of the kernel path differ from the plain "
              f"path: {e}")

    # greedy streams under a pinned clock: f32 must match exactly, bf16 is
    # reported with the logit margin of the first differing token
    streams = {}
    for dname, c, ps in (("bfloat16", cfg, params),
                         ("float32", cfg32, params32)):
        for name, ctx in (("kernels", kern), ("plain", plain)):
            streams[dname, name] = run(c, ps, ctx, Clock(
                fixed_decode_s=0.01, fixed_prefill_s=0.02))[0]
    div32 = _first_divergence(streams["float32", "kernels"],
                              streams["float32", "plain"])
    check(div32 is None, f"float32 greedy streams differ at (rid, token) "
                         f"{div32}")
    n_tok = sum(len(v) for v in streams["float32", "plain"].values())
    print(f"[serve] float32 pinned-clock greedy streams: kernel path == "
          f"plain path ({n_tok} tokens)")
    div16 = _first_divergence(streams["bfloat16", "kernels"],
                              streams["bfloat16", "plain"])
    near_tie = None
    if div16 is None:
        print("[serve] bfloat16 pinned-clock greedy streams: kernel path == "
              "plain path")
    else:
        rid, i = div16
        r = next(x for x in requests if x.rid == rid)
        seq = list(r.prompt) + streams["bfloat16", "plain"][rid][:i]
        with torch.inference_mode():
            logits, _, _ = tf.forward(
                cfg, params, {"tokens": torch.tensor([seq], device=dev)},
                plain)
        top = torch.topk(logits[0, -1].float(), 2).values
        near_tie = {"rid": rid, "token": i,
                    "plain_top2_margin": float(top[0] - top[1])}
        print(f"[serve] bfloat16 pinned-clock greedy streams differ first at "
              f"request {rid} token {i}; the plain path's top-2 logit margin "
              f"there is {near_tie['plain_top2_margin']:.4g}")
    return {"summary": summary, "wall_s": wall_s, "launches": launches,
            "profile": profile,
            "logit_errs": logit_errs, "bf16_near_tie": near_tie}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write the full report (every case's error, "
                         "the timings, the serve summary) as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    report = {}
    try:
        report["device"] = phase_device(torch)
        report["kernels"] = phase_kernels(torch)
        report["serving"] = phase_serving(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if args.out:
            out = pathlib.Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1, default=str))

    sources = {"flash_attention": ("src/repro_torch/kernels/csrc/"
                                   "flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:74"),
               "flash_decode": ("src/repro_torch/kernels/csrc/"
                                "flash_decode.cu",
                                "src/repro/kernels/decode_attention.py:221")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = report["kernels"]["timing"][name][0]     # the main-path shape
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": report["serving"]["launches"][name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
