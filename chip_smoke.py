#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py [--out report.json]

Needs one NVIDIA GPU (sm_90a: H100) and the CUDA toolkit's ``nvcc``; builds
the port's kernels from ``src/repro_torch/kernels/csrc`` first.  Phases, each
failing the run with a non-zero exit when its check fails:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the kernels' build time and ptxas resource report (the bf16
   prefill attention, the scatter, the decode split and merge kernels,
   the top-k row kernels and the three WKV kernels must not spill);
2. kernels against their plain PyTorch versions on the card: every case of
   ``tests/test_torch_kernels.py`` (flash-attention, and flash-decode over
   the dense, int8, paged and paged int8 caches), decode cases across the
   decode kernel's 64-key splits (live ranges ending on a split border and
   one key past it, a window band starting in a later split, a ring
   wrapping across splits, empty slots beside full ones, 3 draft rows with
   GQA 8:1, D = 128, 18 splits, paged with 4- and 16-row blocks), prefill
   cases across
   several 64-key tiles (S up to 333, D 64 and 128, GQA 4:1 and 8:1, a
   window across tile edges, causal off, Sq < Sk) plus RecLLM-base's
   serving shapes, in float32 (tolerance 1e-4) and bfloat16 (2e-2,
   absolute); a paged-kernel run with the null block and every unmapped
   block filled with NaN, which must give the same output (no dead table
   entry is read); and at the serving shapes the time of the kernel, of
   the plain version and, where one exists, of one PyTorch call computing
   the same function (``scaled_dot_product_attention`` with the
   equivalent boolean mask, a yardstick the port never calls), plus for
   the paged kernels the dense kernel on the equivalent dense cache, and
   for the decode kernels their CUDA kernels' profiled times; dense decode
   also at Qwen3-30B-A3B's GQA shape beside SDPA with ``enable_gqa``; the
   four decode entry points also at speculative decode's verify shape (8
   slots, 4 rows, mixed live rows), dense beside SDPA with the equivalent
   mask;
   whether the redesigned prefill, scatter and decode kernels are at or
   below their PyTorch calls and their earlier designs' times is printed
   as a ``[gate ...]`` line, reported and not enforced.  The gradient-compression kernels (onebit quantize and
   dequantize, top-k sparsify and the top-k sync's select entry; run first,
   before any profiler session) likewise,
   on test sizes, tied values and the training phase's full flat
   gradient: bytes, kept values, residuals, the selected indices and
   values and the sent residual exact, scales within 1e-6 relative; timed
   beside their plain versions (no PyTorch call computes the first three;
   the select entry also beside the sparsify-then-pick glue it replaced
   and ``torch.topk`` over the magnitudes), top-k sparsify also at the
   cf_user row compressor's shape.
   The sparse-embedding kernels and the fused AdamW kernel likewise:
   gather_rows exactly in f32 and bf16 at the CPU tests' sizes and on the
   training path's (192,403, 64) table (and ``dedup_lookup(use_kernel=
   True)``); scatter_add_rows bit-equal (``torch.equal``) with heavy
   duplicates, more ids than a staged chunk, D = 6, no ids, ids on both
   sides of a slab border, the sentinel dump row (and every id on it) and
   the path's shape, where one call must run one CUDA kernel;
   adamw_update at N = 16,384 to 48,414,720, 17,408 (a shape the TPU
   kernel's tiling rejects) and cf_item's 4,034,560 within 1e-6 + 1e-5
   relative; timed at the path's shapes beside ``index_select``,
   ``index_add_`` and ``torch._fused_adamw_``, and gather_rows and
   ``index_select`` once more in turns (medians and spreads).  The MoE
   router at the
   MoE serving shapes (T, E, k) in ``ROUTER_CASES``, with a row of equal
   logits (experts 0..k-1, gates 1/k) and a row of duplicated maxima (the
   lowest index first): probs and gates within 1e-6, indices equal except
   on rows whose top k + 1 probs hold a near-tie (counted); timed beside
   ``torch.softmax`` -> ``torch.topk`` -> normalise.  The route entry
   point of the same kernel (router, capacity places, dispatch, combine,
   loads in one launch) at the cases of ``ROUTE_CASES`` (decode, prompt
   buckets, 16 groups of 256, E 128 / k 8, decode over 40 and 64 slots
   (several blocks whose counts meet through the ticket), capacity 0.5,
   half the tokens dead, a 1024-token group, a C of 5): gates, idx and
   probs bit-identical
   to the router entry's, places, dispatch, combine and loads bit-equal
   (``torch.equal``) to the plain dispatch fed that routing, gates and
   probs within 1e-6 of the whole plain version and idx, places, dispatch
   and loads equal to it where no near-tie reorders experts; timed beside
   the plain version, the router kernel followed by the plain dispatch
   (the design it replaced) and an empty kernel.  The chunked WKV6
   kernel at the JAX kernel test's shapes, B * H = 15, 33 tiles (a ragged
   carry segment), rwkv6-1.6b's serving prefill (1, 32, 48, 64) and a
   long prompt (1, 32, 4096, 64), each with drawn decays and with w =
   1e-6, and on transposed (B, T, H, hs) views read in place: output and
   final state within 2e-4 of the largest value of the plain chunked
   recurrence and of the sequential scan, the output laid out as the
   views; pads frozen with w = 1, k = 0 give the unpadded prompt's state;
   timed at the two timed shapes beside both plain versions, whose
   hundreds to thousands of launches are timed as the profiler's sum of
   their kernels' device time (no PyTorch call computes it).  Every kernel wrapper must raise on inputs that
   require grad;
3. serving RecLLM-base at full width in bf16 (random weights from a seeded
   generator) through ``repro_torch.serving``: 16 Poisson requests on 8
   slots of 512 positions with both attention kernels on, under the dense
   bf16 cache and then the paged, int8 and paged int8 layouts.  Each run
   resets every launch counter just before it and reads them just after:
   every request must finish, flash-attention must have launched once per
   layer per prefill and the layout's decode kernel once per layer per
   decode step, the other decode kernels never.  Against the plain path
   (chunked prefill, dense decode) on the same card: the first prefill row
   and decode step logits within 2e-2 of the largest logit in bf16 and
   1e-4 absolute in float32, and the float32 workload under a pinned clock
   gives the same greedy streams; likewise paged == dense kernel, int8
   kernel == int8 plain path, paged int8 == int8 kernel.  One prefix-sharing
   run (4 identical 40-token prompts, 16-row blocks) must share blocks,
   copy on write, drain the pool and match the dense streams.  Each
   layout's workload once more under ``torch.profiler`` gives the device's
   busy share, its top kernels and the attention kernels' device time per
   call on the main path (a decode call's split and merge kernels
   together, the union of their intervals).  Then the CF head on the same
   model and kernels: the same 16 requests with 16 candidates each
   (``TrafficConfig(seed=0, candidates=16)``, 10,000 users, cf_dim 16),
   scored at admission by two heads over the same tables, with no hot-row
   cache and with 128 rows, a tracer and a registry on the cached run.
   Under a pinned clock the greedy streams must equal the engine's without
   a head, cf / fused / ranking must be bit-equal between the heads (each
   ranking a permutation of its candidates, one request's cf equal to
   numpy's ``item[cand] @ user[u]``), the registry's ``cf_cache``
   counters must sum to the head's, ``gather_rows`` must launch twice a
   scored request without the cache and once a lookup with a miss with
   it (counted independently by replaying the lookups on the CPU), every
   TTFT must equal its ``req.queue_wait`` + ``req.prefill`` spans within
   1e-9 s with ``cf.lookup`` inside ``req.prefill``, and the Chrome trace
   must reload with ``ph``/``ts``/``pid``/``tid`` on every event.
   Unpinned: TTFT p50 with and without the head, ``cf.lookup`` ms a
   request, and ``gather_rows``'s device ms a call on this path (the
   profiler).  Then ``spec_serving``, speculative decode
   (``EngineConfig(spec_k=4)`` against one-token decode, the same 16
   requests): RecLLM-base in float32 under a pinned clock under the four
   layouts (greedy streams and ``finished`` equal, no more decode steps,
   the paged pool drained), the same in bf16 unpinned, one-token and spec
   runs in turns (TPOT, TTFT, throughput, decode steps, wall, the device's
   busy share from a profile of each, the first stream divergence if
   any), and Moonlight at 12 layers in float32 with the route kernel
   (streams equal).  Every run launches its layout's decode entry point
   once per layer per decode step, the spec runs some of them at Sq 2 and
   4 (each launch counted by its rows), and Moonlight's route kernel with
   groups of the verify rows;
4. serving the MoE archs at full width in bf16 with the route kernel on
   every MoE FFN and both attention kernels on: Moonlight-16B-A3B cut to
   12 of its 48 layers (7.52B parameters, 15.0 GB) under the dense,
   paged, int8 and paged int8 layouts and dense once with the plain
   router, and Qwen3-30B-A3B (qk-norm, 128 experts top 8) cut to 4
   layers, dense; the same 16 requests on 8 slots of 512.  Each run:
   every request served, ``moe_route`` launched once per layer per
   prefill and decode step (0 with the plain router; ``moe_router`` 0 on
   every run: the route kernel carries its arithmetic), the attention
   kernels as in phase 3; a profile of each gives the device's busy
   share and the route kernel's device time per call (its prompt and
   decode kernels).  The two Moonlight dense runs' greedy streams must be
   equal, and the route kernel's and the plain router's first prefill row
   and decode step logits finite and within 2e-2 of the largest logit;
5. serving rwkv6-1.6b at full width in bf16 (24 layers, d_model 2048,
   1.6B parameters) under the dense and paged layouts with every prefill's
   WKV through the kernel, and dense once with the plain chunked
   recurrence; the same 16 requests on 8 slots of 512.  Each run: every
   request served, ``wkv6_chunked`` launched once per layer per prefill (0
   on the plain path; decode steps are the one-token update); a profile of
   the dense kernel and plain runs gives the device's busy share and the
   kernel's device time per call (the union of its kernels' intervals);
   paged streams must equal dense ones (the paged layout pages nothing for
   rwkv6), the plain path's first stream divergence is printed, and the
   first prefill row and decode step logits of 4 prompts must be finite
   and, with the model in float32, within 1e-4 (absolute) of the plain
   path's; the bf16 differences are printed beside those between the two
   plain paths (the chunked recurrence and the sequential scan), which
   bf16 rounding over 24 layers makes as large.  Then one 4096-token
   prompt through the forward with the kernel and with the plain path:
   bf16 wall time, device busy and WKV device time per call, and every
   position's logits (bf16 printed, float32 within 1e-4);
6. training RecLLM-base at full width in float32 (178.0M parameters, the
   full dataset, batch 32 x seq 32) through ``repro_torch.runtime.trainer``'s
   data-parallel step on a one-rank NCCL group: 20 steps each under flat,
   hierarchical, 1-bit and top-k sync with the kernels, then 1-bit and
   top-k with the plain versions, all under deterministic algorithms.
   Each run resets the launch counters and must launch each compression
   kernel the number of times a step implies (top-k: the select entry
   once, and under the row compressor the sparsify entry once more);
   every loss must be finite;
   top-k's kernel run must equal its plain run bit for bit (1-bit's gap,
   from its scales' last bits, is reported).  Then five runs of the
   sparse-embedding slice: cf_user synced rows-touched through the gather
   and scatter kernels (``flat_embed``, whose losses must equal flat's bit
   for bit: on one rank it is the dense gradient), the same with the
   plain row operations (equal too), with zero_opt (within 1e-4 relative
   of flat: its clip sums in another order), with top-k sync and the
   top-k row compressor, and flat with the fused AdamW kernel (11 leaves a
   step; its gap to flat is reported).  One step's gradient through the
   kernel sync and the plain sync: 1-bit bits equal and values within 1e-6
   of the largest, top-k equal; one AdamW step, fused against
   elementwise, within 1e-6 + 1e-5 relative.  HR@10/NDCG@10 and wire bytes
   per step after each run.

Then the hybrid TP x DP step (``runtime/trainer.make_hybrid_train_step``)
on a one-rank NCCL world (tp = dp = 1), under deterministic algorithms:
olmo-1b at full width (16 layers, d_model 2048, vocab 50,304, bf16)
through ``launch/train.py``'s ``run`` for 6 steps at batch 8 x seq 512
(its 4 micro-batches, lr 1e-4), once with remat forced off and once on: plan
notes, step ms p50 and tokens/s from the loop's ``train_step`` spans,
``torch.cuda.max_memory_allocated``; the losses must be equal and the
peak lower with remat on.  RecLLM-base at full width (float32) through
the hybrid step with ``recllm_loss`` and replicated CF tables against
the DP step (flat) on the same 5 seeded batches: losses within 1e-4
relative (the flash backward at tp 1 against autograd through the
chunked attention: rounding only).  A checkpoint round trip of a 2-layer
RecLLM-base in a temporary directory the phase removes: the restored
state bit-equal to the saved one, and the resumed run's next losses
within 1e-6 relative of the uninterrupted run's.

Then the pipelined DP x TP x stage step
(``runtime/trainer.make_pp_train_step``) on a one-rank NCCL world with a
``stage`` axis of 1 (NCCL takes one rank a card: no message is sent, but
the executor, its recompute, the syncs and their kernels run), under
deterministic algorithms: olmo-1b's widths in float32 cut to 2 layers
through the pipelined and the hybrid step on the same 3 batches, losses
within 2e-4 relative + 1e-5 (JAX's tolerance for its pipelined step
against the DP step); olmo-1b at full width through ``launch/train.py``'s
``run`` with the pipelined path forced on, batch 8 x seq 512 in 4
micro-batches, lr 1e-4, under 1F1B and GPipe (flat sync, the hybrid
phase's 6 steps: losses finite and falling, 1F1B's within 1e-3 relative
of the hybrid phase's remat-off run on the same batches, the schedules'
within 1e-3 of each other and printed whether bit-equal; step ms p50,
tokens/s and peak memory beside the hybrid phase's; 1F1B once more with
the flash backward, which the hybrid step takes at tp 1) and under 1-bit and top-k sync (2 steps each: each
step's compression kernels launched as the DP step launches them); and
``probe_stage_times`` over the 16 full-width layers carved ``[0, 4,
16]`` with the bounds ``rebalance_stages`` gives (they must move).

Then ``sharded_cf``: the CF-table plans (row, col, row_col) on a one-rank
NCCL world: every plan's lookup through ``gather_rows``, the launcher's
CF head under each plan against the replicated head, and RecLLM-base
through the hybrid step under ``embed_plans`` row and row_col
(``phase_sharded_cf`` says what each holds).

Then ``async_dp``, the paper's sync-against-async half, on a one-rank
NCCL world under deterministic algorithms: RecLLM-base at full width
(float32) through ``core/async_dp.py``'s sync and async simulators on 16
batches of 32 x 32 (zero staleness within 1e-6 relative of sync; the
straggler process at max staleness 0, 2 and 6, compensated and naive:
every loss finite, each stale run parting from zero staleness, no kernel
launched; final loss, step ms p50 and peak memory printed); the DP step
fed 8 batches through ``data.Prefetcher(size=2)`` and through
``data.place_batch`` on the main thread (every batch received, losses
bit-equal, launches equal; step ms p50 both ways); and
``runtime/elastic.py`` at one rank (``make_mesh_for(1)`` and ``reshard``
of the hybrid step's state the identity, ``shrink_batch`` keeping the
batch).

Last, ``moe_training``: MoE training through the hybrid step on a
one-rank NCCL world (expert parallelism and the global aux losses reduce
to the identity at one rank): Qwen3-30B-A3B at its published widths, 4 of
its 48 layers (52.2 GiB of resident state reckoned), bf16,
through ``launch/train.py``'s ``run`` (6 steps of 8 x 512 tokens in 4
micro-batches, lr 1e-4, remat off): losses and aux losses finite, no
kernel launched (the route kernels refuse autograd); step ms p50,
tokens/s, peak memory, ``lb_loss`` / ``z_loss`` per step and the last
step's expert-load spread; then reduced Qwen3 and Moonlight in float32,
the hybrid step's losses over 3 steps within 1e-5 relative of a plain
loop's (``loss_fn``, ``backward``, ``adamw_apply``) on the same card.

After it, ``rwkv6_training``: rwkv6-1.6b through the hybrid step on a
one-rank NCCL world: at its published widths (24 layers, d_model 2048, 32
heads of 64, d_ff 7168, vocab 65,536, untied; 1,584,091,136 parameters),
bf16, through ``launch/train.py``'s ``run`` (6 steps of 8 x 512 tokens in
4 micro-batches, lr 1e-4), remat off and then on: losses finite and the
last below the first, the peak under the card's memory, no kernel
launched (the WKV kernel refuses autograd; training runs the plain
chunked recurrence, as JAX's step does); parameters, the reckoned
resident state, peak, step ms p50, tokens/s and losses printed; then
reduced rwkv6 in float32, the hybrid step's losses over 3 steps within
1e-6 relative of a plain loop's on the same card.

It then prints the ``kernels`` JSON line (time, plain time, bound, library
time and main-path launches per kernel) and, last, the device JSON line.
Without CUDA, or without the rest of the repository beside it, it exits
non-zero before printing either.

  python3 chip_smoke.py --wkv6-against TREE

runs none of the phases: it times the WKV kernel of another checkout at
TREE (an earlier commit unpacked with ``git archive``) and this one's in
turns, each in a process of its own (TREE, this, this, TREE): the timed
shapes behind the spin and rwkv6-1.6b's dense serve run (TTFT and TPOT
p50, the WKV device time of every call), and prints each tree's medians
and quartiles.

  python3 chip_smoke.py --moe-against TREE

likewise serves the MoE archs of phase 4 with the kernels on, with the
checkout at TREE and with this one in turns: Moonlight dense's TTFT and
TPOT p50, the routing's device time of every MoE layer call, the device
kernels of one decode step, and the greedy streams of Moonlight under
the four layouts and of Qwen3 dense, which must be equal across trees.
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12              # H100 SXM float32, outside tensor cores
F32_TOL, BF16_TOL = 1e-4, 2e-2

# the cases of tests/test_torch_kernels.py (head_dim 32)
PREFILL_CASES = [  # (B, H, Hk, S, causal, window)
    (1, 2, 2, 40, True, 0), (2, 4, 1, 40, True, 8), (1, 4, 1, 33, True, 0),
    (1, 2, 2, 24, False, 0), (1, 4, 2, 37, False, 5),
]
# prefill across several 64-key tiles of the bf16 kernel, ragged edges:
# (B, H, Hk, Sq, Sk, D, causal, window)
PREFILL_TILED_CASES = [
    (1, 4, 1, 64, 64, 64, True, 0),        # one whole tile, GQA 4:1
    (1, 8, 1, 65, 65, 128, True, 0),       # one key past it, GQA 8:1
    (2, 4, 4, 200, 200, 64, True, 0),      # the serve prompt, 4 tiles
    (1, 4, 2, 333, 333, 64, True, 100),    # a window across tile edges
    (1, 8, 1, 333, 333, 128, False, 0),    # causal off, GQA 8:1
    (1, 4, 1, 65, 200, 64, False, 0),      # Sq < Sk
    (1, 4, 2, 100, 333, 128, True, 70),    # Sq < Sk, causal and window
    (1, 2, 2, 200, 200, 32, False, 37),    # a window alone, D = 32
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
QUANT_CASES = [  # (B, Sq, H, Hk, S, lengths, q_lens)
    (4, 1, 2, 2, 40, [0, 1, 40, 17], None),
    (4, 1, 8, 2, 48, [0, 49, 53, 7], None),
    (4, 3, 2, 2, 40, [0, 5, 20, 38], [3, 1, 2, 3]),
]
PAGED_CASES = [  # (B, Sq, H, Hk, nb, bs, lengths, q_lens, window, ring)
    (4, 1, 2, 2, 5, 8, [0, 1, 40, 17], None, 0, False),
    (4, 1, 8, 2, 5, 8, [0, 0, 0, 0], None, 0, False),
    (4, 1, 2, 2, 5, 8, [0, 1, 5, 40], None, 16, False),
    (4, 1, 2, 2, 2, 8, [0, 3, 16, 29], None, 12, True),
    (4, 3, 2, 2, 5, 8, [0, 5, 20, 38], [3, 1, 2, 3], 0, False),
    (4, 2, 8, 2, 4, 4, [1, 7, 16, 25], [2, 1, 2, 2], 12, True),
    (3, 3, 2, 2, 5, 8, [2, 30, 38], [3, 2, 1], 6, False),
]
CASE_D = 32
# across the decode kernel's 64-key splits, both dtypes, D given:
# (B, Sq, H, Hk, S, D, lengths, q_lens, window, ring)
DECODE_SPLIT_CASES = [
    (4, 1, 2, 2, 192, 32, [64, 65, 0, 192], None, 0, False),  # on a border,
    #                                 one key past it, len 0 beside full
    (3, 1, 4, 2, 192, 64, [100, 150, 191], None, 40, False),  # window band
    #                                 starting inside a later split
    (3, 1, 2, 2, 160, 32, [170, 230, 100], None, 70, True),   # ring wraps
    #                                 across split borders
    (4, 3, 16, 2, 200, 64, [63, 64, 0, 130], [3, 2, 3, 1], 0, False),  # Sq 3,
    #                                 G 8: 24 rows, three row chunks
    (2, 1, 8, 2, 256, 128, [129, 256], None, 0, False),       # D = 128
    (2, 2, 8, 1, 130, 128, [64, 127], [2, 2], 30, True),      # D = 128, G 8,
    #                                 ring, draft rows
    (2, 1, 4, 2, 1100, 64, [1030, 1100], None, 0, False),     # 18 splits:
    #                                 the merge's loads 8 splits at a time
]
QUANT_SPLIT_CASES = [  # (B, Sq, H, Hk, S, D, lengths, q_lens)
    (4, 1, 2, 2, 192, 32, [64, 65, 0, 192], None),
    (4, 3, 16, 2, 200, 64, [63, 64, 0, 130], [3, 2, 3, 1]),
    (2, 1, 8, 2, 256, 128, [129, 300], None),                 # len past S
    (2, 1, 4, 2, 1100, 64, [1030, 1100], None),               # 18 splits
]
# (B, Sq, H, Hk, nb, bs, D, lengths, q_lens, window, ring)
PAGED_SPLIT_CASES = [
    (4, 1, 2, 2, 48, 4, 32, [64, 65, 0, 192], None, 0, False),    # bs = 4
    (4, 1, 2, 2, 12, 16, 32, [64, 65, 0, 192], None, 0, False),   # bs = 16
    (3, 1, 4, 2, 12, 16, 64, [100, 150, 191], None, 40, False),
    (3, 1, 2, 2, 40, 4, 32, [170, 230, 100], None, 70, True),
    (4, 3, 16, 2, 13, 16, 64, [63, 64, 0, 130], [3, 2, 3, 1], 0, False),
    (2, 1, 8, 2, 16, 16, 128, [129, 256], None, 0, False),
    (2, 1, 4, 2, 69, 16, 64, [1030, 1100], None, 0, False),   # 18 splits
]
# RecLLM-base serving shapes
DECODE_MAIN = dict(B=8, S=512, H=12, Hk=12, D=64,
                   lengths=[1, 37, 64, 100, 200, 300, 450, 512])
# Qwen3-30B-A3B's decode attention (GQA 8:1) at the same slots and lengths
DECODE_GQA = dict(DECODE_MAIN, H=32, Hk=4, D=128)
# the decode kernels' times in the design this body replaced (one block a
# (KV head, slot) walking its whole live range, query rows in turn), at
# DECODE_MAIN behind the spin on an H100 80GB HBM3 at 700 W
DECODE_GATE_MS = {"flash_decode": 0.0235, "flash_decode_quant": 0.0244,
                  "flash_decode_paged": 0.0312,
                  "flash_decode_paged_quant": 0.0311}
BLOCK_MAIN = 16                    # paged: rows per block (pool 8*32 + 1)
PREFILL_MAIN = [dict(B=1, H=12, S=s, D=64) for s in (24, 200)]
# the per-row kernel's 0.0099 ms at S = 24, which the tile kernel replaced,
# + 10%
PREFILL_GATE_MS = {24: 0.0109}

# name -> (port source, TPU kernel it replaces, launch counter owner)
KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:74"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/decode_attention.py:221"),
    "flash_decode_quant": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                           "src/repro/kernels/decode_attention.py:281"),
    "flash_decode_paged": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                           "src/repro/kernels/decode_attention.py:352"),
    "flash_decode_paged_quant": (
        "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/decode_attention.py:416"),
    "onebit_quantize": ("src/repro_torch/kernels/csrc/grad_compress.cu",
                        "src/repro/kernels/grad_compress.py:37"),
    "onebit_dequantize": ("src/repro_torch/kernels/csrc/grad_compress.cu",
                          "src/repro/kernels/grad_compress.py:59"),
    "topk_sparsify": ("src/repro_torch/kernels/csrc/topk_sparsify.cu",
                      "src/repro/kernels/topk_sparsify.py:34"),
    "topk_select": ("src/repro_torch/kernels/csrc/topk_sparsify.cu",
                    "src/repro/kernels/topk_sparsify.py:34"),
    "gather_rows": ("src/repro_torch/kernels/csrc/embedding_ops.cu",
                    "src/repro/kernels/embedding_ops.py:33"),
    "scatter_add_rows": ("src/repro_torch/kernels/csrc/embedding_ops.cu",
                         "src/repro/kernels/embedding_ops.py:62"),
    "adamw_update": ("src/repro_torch/kernels/csrc/fused_adamw.cu",
                     "src/repro/kernels/fused_adamw.py:29"),
    "moe_router": ("src/repro_torch/kernels/csrc/moe_router.cu",
                   "src/repro/kernels/moe_router.py:39"),
    "moe_route": ("src/repro_torch/kernels/csrc/moe_router.cu",
                  "src/repro/kernels/moe_router.py:39"),
    "wkv6_chunked": ("src/repro_torch/kernels/csrc/wkv6.cu",
                     "src/repro/kernels/wkv6.py:66"),
}
NO_LIBRARY = {
    "flash_decode_quant": "no PyTorch call attends over int8 values with "
                          "per-(position, head) scales",
    "flash_decode_paged": "no PyTorch call attends through a block table",
    "flash_decode_paged_quant": "no PyTorch call attends through a block "
                                "table over int8 values with scales",
    "onebit_quantize": "no PyTorch call packs sign bits with per-tile "
                       "mean-|g| scales",
    "onebit_dequantize": "no PyTorch call unpacks sign bits to +-scale",
    "topk_sparsify": "no PyTorch call thresholds rows at the k-th largest "
                     "distinct magnitude",
    "wkv6_chunked": "no PyTorch call computes the WKV6 recurrence",
    "moe_route": "no PyTorch call builds capacity-limited dispatch and "
                 "combine tensors",
}
# what a kernel takes over beyond its TPU kernel: the JAX code around it
ALSO_REPLACES = {"moe_route": "src/repro/models/moe.py:97-117"}
# kernels that the main path no longer launches: why (the kernels line
# reads their launches from the main path all the same, 0)
OFF_PATH = {"moe_router": "off the serve path: moe_route's route_row "
                          "computes its arithmetic there; held against its "
                          "plain version in phase 2"}


# kernels that must build without register spills (ptxas -v)
NO_SPILLS = ("flash_attention_mma_kernel", "scatter_add_rows_kernel",
             "flash_decode_split_kernel", "flash_decode_merge_kernel",
             "topk_rows_kernel", "wkv6_intra_kernel", "wkv6_span_kernel",
             "wkv6_carry_kernel", "moe_route_kernel",
             "moe_route_decode_kernel")


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def _wrappers():
    """Kernel name -> the wrapper that counts its launches."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import embedding_ops as eo
    from repro_torch.kernels import fused_adamw as fa
    from repro_torch.kernels import grad_compress as gc
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import topk_sparsify as tk
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.kernels.flash_attention import flash_attention
    return {"flash_attention": flash_attention,
            "flash_decode": dk.flash_decode_attention,
            "flash_decode_quant": dk.flash_decode_attention_quant,
            "flash_decode_paged": dk.flash_decode_attention_paged,
            "flash_decode_paged_quant": dk.flash_decode_attention_paged_quant,
            "onebit_quantize": gc.onebit_quantize,
            "onebit_dequantize": gc.onebit_dequantize,
            "topk_sparsify": tk.topk_sparsify,
            "topk_select": tk.topk_select,
            "gather_rows": eo.gather_rows,
            "scatter_add_rows": eo.scatter_add_rows,
            "adamw_update": fa.adamw_update,
            "moe_router": mr.moe_router,
            "moe_route": mr.moe_route,
            "wkv6_chunked": wk.wkv6_chunked}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


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
    print(f"[build] {len(_build.SOURCES)} sources with nvcc in "
          f"{build_s:.1f} s")
    spills = []
    for name, log in sorted(_build.ptxas_log.items()):
        fn = ""                      # the mangled kernel the lines are of
        for line in log.splitlines():
            found = re.search(r"Function properties for (\S+)", line)
            fn = found.group(1) if found else fn
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {fn[:60]}: {line.strip()}")
            if (any(k in fn for k in NO_SPILLS)
                    and re.search(r"[1-9]\d* bytes spill", line)):
                spills.append(f"{fn}: {line.strip()}")
    check(not spills, f"register spills: {spills}")
    return {"card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s}


SPIN_CYCLES = 20_000_000          # ~10 ms of device spin at H100 clocks


def _time_ms(torch, fn, flush, iters=30):
    """Mean device time of fn over ``iters`` calls, CUDA events around each.

    Before each call the 50 MB L2 is flushed (a serving step finds its
    layer's K/V cold: the other layers' caches ran through L2 since) and a
    spin kernel holds the device for ~10 ms, so the host has queued all of
    fn's launches before the start event fires: the events time the device
    work, not the host's launch latency.  A call the host took longer to
    queue than 0.8 of the spin (the events would time host gaps) is not
    counted; raises when fewer than ``iters`` of 3 * ``iters`` calls
    count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin = _spin_ms(torch)
    times, host_max = [], 0.0
    for _ in range(3 * iters):
        ms, host_ms = _timed_call(torch, fn, flush)
        host_max = max(host_max, host_ms)
        if host_ms < 0.8 * spin:
            times.append(ms)
            if len(times) == iters:
                return sum(times) / iters
    raise SmokeFailure(f"queueing the timed call took up to {host_max:.3f} "
                       f"ms, longer than 0.8 of the {spin:.3f} ms spin, in "
                       f"{3 * iters - len(times)} of {3 * iters} calls")


def _timed_call(torch, fn, flush):
    """(device ms, host ms to queue it) of one call of fn behind an L2
    flush and the spin kernel."""
    flush.zero_()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end), host_ms


def _time_in_turns(torch, fns, flush, iters=30):
    """{name: sorted device ms of ``iters`` calls} for the callables of
    ``fns``, timed as :func:`_time_ms` does, one call of each in turn
    (the order reversed every other turn: a b, b a, ...), so the card's
    state drifts alike under all of them.  A call the host took longer
    to queue than 0.8 of the spin is timed again, at most twice."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    spin = _spin_ms(torch)
    names = list(fns)
    times = {n: [] for n in names}
    for turn in range(iters):
        for n in (names if turn % 2 == 0 else names[::-1]):
            for _ in range(3):
                ms, host_ms = _timed_call(torch, fns[n], flush)
                if host_ms < 0.8 * spin:
                    times[n].append(ms)
                    break
            else:
                raise SmokeFailure(f"queueing {n} took longer than 0.8 of "
                                   f"the {spin:.3f} ms spin three times")
    return {n: sorted(v) for n, v in times.items()}


def _profiled_ms(torch, fn, flush, iters):
    """Mean device time of fn over ``iters`` calls: the summed durations of
    its CUDA kernels, each call traced alone by ``torch.profiler`` after an
    L2 flush.  For a plain version of more small launches than a spin can
    hold queued: like :func:`_time_ms` it counts the device's work, not its
    waits on the host between launches (nor the gaps of a few microseconds
    between queued kernels, which :func:`_time_ms` includes)."""
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda.synchronize()
        total += sum(ms for ms, _ in _device_time(torch, fn).values())
    return total / iters


def _spin_ms(torch):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def report_gate(what, ms, library_ms, library, limit_ms=None,
                limit="the earlier design"):
    """Print whether a redesigned kernel is at or below its PyTorch call
    (when there is one) and ``limit_ms`` in this run.  Reported, not
    enforced: a time is not a correctness check, and the host's noise
    would make it flaky."""
    ok = ((library_ms is None or ms <= library_ms)
          and (limit_ms is None or ms <= limit_ms))
    against = ([f"{library} {library_ms:.4f} ms"] if library_ms is not None
               else []) + ([f"{limit} {limit_ms} ms"] if limit_ms else [])
    print(f"[gate {what}] kernel {ms:.4f} ms against "
          + " and ".join(against) + (": met" if ok else ": MISSED"))


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def paged_tables(lengths, q_lens, nb, bs, seed=0, spare=3):
    """(B, nb) int32 tables over a shuffled pool (the helper of
    ``tests/test_torch_kernels.py``): each slot's live blocks get distinct
    physical ids from a permutation of 1..N-1, dead entries point at the
    null block 0.  Returns (tables, N) with N = B * nb + 1 + spare."""
    import numpy as np
    B = len(lengths)
    N = B * nb + 1 + spare
    perm = np.random.default_rng(seed).permutation(np.arange(1, N))
    tables = np.zeros((B, nb), np.int32)
    for b, n in enumerate(lengths):
        last = n + (1 if q_lens is None else q_lens[b]) - 1
        live = min(-(-min(last, nb * bs) // bs), nb)
        tables[b, :live] = perm[b * nb:b * nb + live]
    return tables, N


class Inputs:
    """Seeded inputs on the card for each kernel and its plain version."""

    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev).manual_seed(0)

    def randn(self, *shape, dtype):
        t = self.torch
        return t.randn(shape, generator=self.gen, device=self.dev).to(dtype)

    def int8(self, *shape):
        return self.torch.randint(-127, 128, shape, generator=self.gen,
                                  device=self.dev, dtype=self.torch.int8)

    def scales(self, *shape):
        # |values| <= 127 * 0.02 keeps bf16 outputs below 4, where a bf16
        # ulp (1/64) stays inside the 2e-2 tolerance
        return (self.torch.rand(shape, generator=self.gen, device=self.dev)
                * 0.018 + 0.002)

    def ints(self, xs):
        if xs is None:
            return None
        return self.torch.tensor(xs, dtype=self.torch.int32, device=self.dev)

    def prefill(self, B, H, Hk, S, D, causal, window, dtype, Sk=None):
        from repro_torch.kernels import ops, ref
        q = self.randn(B, H, S, D, dtype=dtype)
        k, v = (self.randn(B, Hk, Sk or S, D, dtype=dtype) for _ in "kv")
        kw = dict(causal=causal, window=window)
        return (ops.flash_attention_bhsd, ref.flash_attention, (q, k, v), kw)

    def decode(self, B, Sq, H, Hk, S, D, lengths, q_lens, window, ring,
               dtype):
        from repro_torch.kernels import decode_attention as dk
        from repro_torch.kernels import ref
        q = self.randn(B, Sq, H, D, dtype=dtype)
        k, v = (self.randn(B, S, Hk, D, dtype=dtype) for _ in range(2))
        kw = dict(window=window, ring=ring, q_lens=self.ints(q_lens))
        return (dk.flash_decode_attention, ref.decode_attention,
                (q, k, v, self.ints(lengths)), kw)

    def quant(self, B, Sq, H, Hk, S, D, lengths, q_lens, dtype):
        from repro_torch.kernels import decode_attention as dk
        from repro_torch.kernels import ref
        args = (self.randn(B, Sq, H, D, dtype=dtype),
                self.int8(B, S, Hk, D), self.scales(B, S, Hk),
                self.int8(B, S, Hk, D), self.scales(B, S, Hk),
                self.ints(lengths))
        return (dk.flash_decode_attention_quant, ref.decode_attention_quant,
                args, dict(q_lens=self.ints(q_lens)))

    def paged(self, B, Sq, H, Hk, nb, bs, D, lengths, q_lens, window, ring,
              dtype, quant=False, poison=False):
        """Shuffled pool; unmapped blocks (block 0 included) hold garbage x10
        or, with ``poison``, NaN (int8: NaN scales, values 127)."""
        from repro_torch.kernels import decode_attention as dk
        from repro_torch.kernels import ref
        torch = self.torch
        tables, N = paged_tables(lengths, q_lens, nb, bs)
        unused = torch.ones(N, dtype=torch.bool, device=self.dev)
        unused[torch.as_tensor(tables[tables > 0], device=self.dev).long()] \
            = False
        q = self.randn(B, Sq, H, D, dtype=dtype)
        if quant:
            pools = [self.int8(N, bs, Hk, D), self.scales(N, bs, Hk),
                     self.int8(N, bs, Hk, D), self.scales(N, bs, Hk)]
            if poison:
                for i in (0, 2):
                    pools[i][unused] = 127
                for i in (1, 3):
                    pools[i][unused] = float("nan")
            fn, plain = (dk.flash_decode_attention_paged_quant,
                         ref.decode_attention_paged_quant)
            kw = dict(q_lens=self.ints(q_lens))
        else:
            pools = [self.randn(N, bs, Hk, D, dtype=dtype) for _ in range(2)]
            for p in pools:
                p[unused] = float("nan") if poison else p[unused] * 10
            fn, plain = dk.flash_decode_attention_paged, \
                ref.decode_attention_paged
            kw = dict(window=window, ring=ring, q_lens=self.ints(q_lens))
        args = (q, *pools, self.ints(tables), self.ints(lengths))
        return fn, plain, args, kw


def _case_builders(inp):
    """Kernel name -> [(case, build(dtype) -> (fn, plain, args, kw))]."""
    D = CASE_D
    return {
        "flash_attention": [
            (c, lambda dt, c=c: inp.prefill(*c[:4], D, *c[4:], dt))
            for c in PREFILL_CASES] + [
            (c, lambda dt, c=c: inp.prefill(*c[:4], *c[5:], dt, Sk=c[4]))
            for c in PREFILL_TILED_CASES],
        "flash_decode": [
            (c, lambda dt, c=c: inp.decode(*c[:5], D, *c[5:], dt))
            for c in DECODE_CASES],
        "flash_decode_quant": [
            (c, lambda dt, c=c: inp.quant(*c[:5], D, *c[5:], dt))
            for c in QUANT_CASES],
        "flash_decode_paged": [
            (c, lambda dt, c=c: inp.paged(*c[:6], D, *c[6:], dt))
            for c in PAGED_CASES],
        "flash_decode_paged_quant": [
            (c, lambda dt, c=c: inp.paged(*c[:6], D, *c[6:], dt, quant=True))
            for c in PAGED_CASES if not c[-2]],
    }


def _split_case_builders(inp):
    """Like :func:`_case_builders`, for the cases across the decode
    kernel's splits (head dim in the case)."""
    return {
        "flash_decode": [(c, lambda dt, c=c: inp.decode(*c, dt))
                         for c in DECODE_SPLIT_CASES],
        "flash_decode_quant": [(c, lambda dt, c=c: inp.quant(*c, dt))
                               for c in QUANT_SPLIT_CASES],
        "flash_decode_paged": [(c, lambda dt, c=c: inp.paged(*c, dt))
                               for c in PAGED_SPLIT_CASES],
        "flash_decode_paged_quant": [
            (c, lambda dt, c=c: inp.paged(*c, dt, quant=True))
            for c in PAGED_SPLIT_CASES if not c[-2]],
    }


def phase_kernels(torch):
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref
    from repro_torch.models import kvquant
    inp = Inputs(torch)
    dev = inp.dev
    report = {"cases": [], "timing": {}}

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        counts = []
        for builders, what in ((_case_builders(inp), ""),
                               (_split_case_builders(inp), " across splits")):
            for kname, cases in builders.items():
                for case, build in cases:
                    fn, plain, args, kw = build(dtype)
                    err = _max_err(fn(*args, **kw), plain(*args, **kw))
                    report["cases"].append([kname, name, list(case), err])
                    check(err <= tol, f"{kname} {name} case {case}: max abs "
                                      f"err {err} > {tol}")
                counts.append(f"{len(cases)} {kname}{what}")
        print(f"[kernels] {name}: {', '.join(counts)} cases within {tol} of "
              f"the plain versions (worst "
              f"{max(e for _, n, _, e in report['cases'] if n == name):.3g})")

    # the paged kernels read no dead table entry: NaN in the null block and
    # every unmapped block changes nothing (the plain versions, which
    # gather whole tables, would turn NaN there)
    for quant in (False, True):
        c = PAGED_CASES[4]                 # k rows across block boundaries
        outs = []
        for poison in (False, True):
            inp.gen.manual_seed(7)
            fn, _, args, kw = inp.paged(*c[:6], CASE_D, *c[6:8],
                                        0 if quant else c[8],
                                        False if quant else c[9],
                                        torch.float32, quant=quant,
                                        poison=poison)
            outs.append(fn(*args, **kw))
        same = bool(torch.equal(outs[0], outs[1]))
        check(same and bool(torch.isfinite(outs[1]).all()),
              f"paged{' int8' if quant else ''} kernel output changed with "
              "NaN in unmapped blocks: it read a dead table entry")
    print("[kernels] paged and paged int8: NaN in the null block and every "
          "unmapped block leaves the output unchanged")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    F = torch.nn.functional
    m = DECODE_MAIN
    B, S, H, Hk, D = m["B"], m["S"], m["H"], m["Hk"], m["D"]
    lengths = inp.ints(m["lengths"])
    live = sum(m["lengths"])
    qo_bytes = 2 * B * H * D * 2 + 4 * B          # q and o in bf16, lengths
    flops = 4 * live * H * D
    shape = f"B={B} S={S} H=Hk={H} D={D} bf16 q, lengths {m['lengths']}"

    def timing(kname, fn, plain, args, kw, nbytes, library=None,
               dense=None, shape_note="", at=(shape, D, flops)):
        """Check and time one call at a serving shape; ``at`` is the
        shape's (description, head dim, operations)."""
        shape_, d, ops = at
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            a = tuple(x.to(dt) if x.dtype in (torch.float32, torch.bfloat16)
                      and x.dim() == 4 and x.shape[-1] == d else x
                      for x in args)
            errs[dt] = _max_err(fn(*a, **kw), plain(*a, **kw))
        check(errs[torch.float32] <= F32_TOL
              and errs[torch.bfloat16] <= BF16_TOL,
              f"{kname} at the serving shape: errors {errs}")
        t = {"shape": shape_ + shape_note,
             "max_abs_err": errs[torch.bfloat16], "tol": BF16_TOL,
             "max_abs_err_f32": errs[torch.float32],
             "ms": _time_ms(torch, lambda: fn(*args, **kw), flush),
             "plain_ms": _time_ms(torch, lambda: plain(*args, **kw), flush),
             "library_ms": (_time_ms(torch, library, flush)
                            if library is not None else None),
             "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "ops_ms": ops / BF16_FLOPS_PER_S * 1e3}
        if library is None:
            t["library_note"] = NO_LIBRARY[kname]
        if dense is not None:
            t["dense_kernel_ms"] = _time_ms(torch, dense, flush)
        # one call under the profiler, L2 flushed: each CUDA kernel's time,
        # and the union of their intervals (they overlap under a dependent
        # launch)
        flush.zero_()
        torch.cuda.synchronize()
        events = _device_events(torch, lambda: fn(*args, **kw))
        t["device_kernels_ms"] = {_kernel_name(n): (e - s) / 1e6
                                  for n, s, e in events}
        t["device_span_ms"] = _busy_ms([(s, e) for _, s, e in events])
        report["timing"].setdefault(kname, []).append(t)
        return t

    # decode at RecLLM-base's serving shape, ragged lengths: dense bf16
    q = inp.randn(B, 1, H, D, dtype=torch.bfloat16)
    k, v = (inp.randn(B, S, Hk, D, dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    timing("flash_decode", dk.flash_decode_attention, ref.decode_attention,
           (q, k, v, lengths), {}, 2 * live * Hk * D * 2 + qo_bytes,
           library=lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask))

    # int8: values and scales from quantizing the same K/V
    (k_q, k_s), (v_q, v_s) = kvquant.quantize_kv(k), kvquant.quantize_kv(v)
    int8_bytes = 2 * live * Hk * D + 2 * live * Hk * 4
    timing("flash_decode_quant", dk.flash_decode_attention_quant,
           ref.decode_attention_quant, (q, k_q, k_s, v_q, v_s, lengths), {},
           int8_bytes + qo_bytes, shape_note=", int8 K/V + f32 scales")

    # paged: the same rows scattered over a shuffled (8 * 32 + 1)-block pool
    nb = S // BLOCK_MAIN
    tables_np, N = paged_tables(m["lengths"], None, nb, BLOCK_MAIN,
                                spare=0)
    tables = inp.ints(tables_np.tolist())
    tbl_bytes = tables.numel() * 4

    def pool_of(x, tables=tables, N=N):
        p = torch.zeros((N, BLOCK_MAIN) + tuple(x.shape[2:]), dtype=x.dtype,
                        device=dev)
        p[tables.long().reshape(-1)] = x.reshape((B * nb, BLOCK_MAIN)
                                                 + tuple(x.shape[2:]))
        return p

    kp, vp = pool_of(k), pool_of(v)
    kd, vd = ref.paged_gather(kp, tables), ref.paged_gather(vp, tables)
    note = f", pool ({N}, {BLOCK_MAIN}, {Hk}, {D}), tables ({B}, {nb})"
    timing("flash_decode_paged", dk.flash_decode_attention_paged,
           ref.decode_attention_paged, (q, kp, vp, tables, lengths), {},
           2 * live * Hk * D * 2 + tbl_bytes + qo_bytes, shape_note=note,
           dense=lambda: dk.flash_decode_attention(q, kd, vd, lengths))
    pools = [pool_of(x) for x in (k_q, k_s, v_q, v_s)]
    dq = [ref.paged_gather(p, tables) for p in pools]
    timing("flash_decode_paged_quant", dk.flash_decode_attention_paged_quant,
           ref.decode_attention_paged_quant, (q, *pools, tables, lengths), {},
           int8_bytes + tbl_bytes + qo_bytes, shape_note=note + ", int8",
           dense=lambda: dk.flash_decode_attention_quant(q, *dq, lengths))

    # Qwen3-30B-A3B's decode (GQA 8:1, D = 128) at the same slots, beside
    # SDPA with the query heads grouped over the KV heads
    g = DECODE_GQA
    Hq, Hg, Dg = g["H"], g["Hk"], g["D"]
    qg = inp.randn(B, 1, Hq, Dg, dtype=torch.bfloat16)
    kg, vg = (inp.randn(B, S, Hg, Dg, dtype=torch.bfloat16) for _ in "kv")
    qgt, kgt, vgt = (x.transpose(1, 2) for x in (qg, kg, vg))
    timing("flash_decode", dk.flash_decode_attention, ref.decode_attention,
           (qg, kg, vg, lengths), {},
           2 * live * Hg * Dg * 2 + 2 * B * Hq * Dg * 2 + 4 * B,
           library=lambda: F.scaled_dot_product_attention(
               qgt, kgt, vgt, attn_mask=mask, enable_gqa=True),
           at=(f"B={B} S={S} H={Hq} Hk={Hg} D={Dg} (Qwen3-30B-A3B) bf16 q, "
               f"lengths {m['lengths']}", Dg, 4 * live * Hq * Dg))

    # speculative decode's k-row verify (VERIFY_MAIN, the same cache shape
    # as DECODE_MAIN): the four entry points with mixed live rows; row j
    # of slot b attends over lengths + j keys, so the bound counts each
    # slot's union of keys and its live rows' operations
    vm = VERIFY_MAIN
    Sq = vm["Sq"]
    vlens, q_lens = inp.ints(vm["lengths"]), inp.ints(vm["q_lens"])
    keys = sum(n + r - 1 for n, r in zip(vm["lengths"], vm["q_lens"]))
    vat = (f"B={B} Sq={Sq} S={S} H=Hk={H} D={D} bf16 q, lengths "
           f"{vm['lengths']}, q_lens {vm['q_lens']}", D,
           sum(4 * (n + j) * H * D
               for n, r in zip(vm["lengths"], vm["q_lens"])
               for j in range(r)))
    vqo = 2 * B * Sq * H * D * 2 + 8 * B        # q, o, lengths, q_lens
    kv16, kv8 = 2 * keys * Hk * D * 2, 2 * keys * Hk * (D + 4)
    qv = inp.randn(B, Sq, H, D, dtype=torch.bfloat16)
    vtables_np, vN = paged_tables(vm["lengths"], vm["q_lens"], nb,
                                  BLOCK_MAIN, spare=0)
    vtables = inp.ints(vtables_np.tolist())
    vkw = dict(q_lens=q_lens)
    vnote = f", blocks of {BLOCK_MAIN}"
    # SDPA's equivalent: row j of slot b sees keys < lengths + j; a dead
    # row sees key 0 only (SDPA has no all-masked row; the kernel writes
    # zeros there, so only live rows are compared)
    rows = torch.arange(Sq, device=dev)
    vlive = rows[None] < q_lens.long()[:, None]
    vends = vlens.long()[:, None] + rows[None]      # keys row j sees
    vmask = (pos[None, None] < vends[..., None]) & vlive[..., None]
    vmask[:, :, 0] |= ~vlive
    qvt = qv.transpose(1, 2)

    def sdpa_verify():
        return F.scaled_dot_product_attention(qvt, kt, vt,
                                              attn_mask=vmask[:, None])

    report["verify"] = {
        "flash_decode": timing(
            "flash_decode", dk.flash_decode_attention, ref.decode_attention,
            (qv, k, v, vlens), vkw, kv16 + vqo, library=sdpa_verify,
            at=vat),
        "flash_decode_quant": timing(
            "flash_decode_quant", dk.flash_decode_attention_quant,
            ref.decode_attention_quant, (qv, k_q, k_s, v_q, v_s, vlens),
            vkw, kv8 + vqo, shape_note=", int8", at=vat),
        "flash_decode_paged": timing(
            "flash_decode_paged", dk.flash_decode_attention_paged,
            ref.decode_attention_paged,
            (qv, *(pool_of(x, vtables, vN) for x in (k, v)), vtables,
             vlens), vkw, kv16 + vtables.numel() * 4 + vqo,
            shape_note=vnote, at=vat),
        "flash_decode_paged_quant": timing(
            "flash_decode_paged_quant",
            dk.flash_decode_attention_paged_quant,
            ref.decode_attention_paged_quant,
            (qv, *(pool_of(x, vtables, vN) for x in (k_q, k_s, v_q, v_s)),
             vtables, vlens), vkw, kv8 + vtables.numel() * 4 + vqo,
            shape_note=", int8" + vnote, at=vat)}
    t = report["verify"]["flash_decode"]
    t["library_max_abs_err"] = _max_err(
        dk.flash_decode_attention(qv, k, v, vlens, **vkw)[vlive],
        sdpa_verify().transpose(1, 2)[vlive])
    check(t["library_max_abs_err"] <= BF16_TOL,
          f"flash_decode at the verify shape: SDPA's live rows differ from "
          f"the kernel's by {t['library_max_abs_err']}")

    for kname, limit_ms in DECODE_GATE_MS.items():
        t = report["timing"][kname][0]
        report_gate(f"{kname} RecLLM", t["ms"], t["library_ms"],
                    "sdpa with the length mask", limit_ms)
    t = report["timing"]["flash_decode"][1]
    report_gate("flash_decode Qwen3 GQA", t["ms"], t["library_ms"],
                "sdpa with enable_gqa")

    # prefill at RecLLM-base's prompt shapes
    report["timing"]["flash_attention"] = []
    for pm in PREFILL_MAIN:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            fn, plain, (qp, kpp, vpp), kw = inp.prefill(
                pm["B"], pm["H"], pm["H"], pm["S"], pm["D"], True, 0, dtype)
            errs[dtype] = _max_err(fn(qp, kpp, vpp, **kw),
                                   plain(qp, kpp, vpp, **kw))
        check(errs[torch.float32] <= F32_TOL
              and errs[torch.bfloat16] <= BF16_TOL,
              f"flash_attention at S={pm['S']}: errors {errs}")
        causal = torch.ones(pm["S"], pm["S"], dtype=torch.bool,
                            device=dev).tril()
        Sp, n = pm["S"], pm["B"] * pm["H"] * pm["S"] * pm["D"]
        pflops = 4 * pm["B"] * pm["H"] * pm["D"] * Sp * (Sp + 1) // 2
        t = {"shape": f"B={pm['B']} H=Hk={pm['H']} S={Sp} D={pm['D']} bf16 "
                      "causal",
             "max_abs_err": errs[torch.bfloat16], "tol": BF16_TOL,
             "max_abs_err_f32": errs[torch.float32],
             "ms": _time_ms(torch, lambda: fn(qp, kpp, vpp), flush),
             "plain_ms": _time_ms(torch, lambda: plain(qp, kpp, vpp), flush),
             "library_ms": _time_ms(
                 torch, lambda: F.scaled_dot_product_attention(
                     qp, kpp, vpp, attn_mask=causal), flush),
             "bytes_ms": 4 * n * 2 / HBM_BYTES_PER_S * 1e3,
             "ops_ms": pflops / BF16_FLOPS_PER_S * 1e3}
        report["timing"]["flash_attention"].append(t)
    for t, pm in zip(report["timing"]["flash_attention"], PREFILL_MAIN):
        report_gate(f"flash_attention S={pm['S']}", t["ms"],
                    t["library_ms"], "sdpa with the causal mask",
                    PREFILL_GATE_MS.get(pm["S"]),
                    "the per-row kernel's time + 10%")
    for name, rows in report["timing"].items():
        for t in rows:
            t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
            t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                             else "operations")
            lib = (f"sdpa {t['library_ms']:.4f} ms"
                   if t["library_ms"] is not None else "no library call")
            extra = (f", dense kernel on the gathered cache "
                     f"{t['dense_kernel_ms']:.4f} ms"
                     if "dense_kernel_ms" in t else "")
            if "device_kernels_ms" in t:
                extra += ", profiled " + ", ".join(
                    f"{n} {ms:.4f}" for n, ms in
                    t["device_kernels_ms"].items()) + (
                    f" (span {t['device_span_ms']:.4f})")
            print(f"[time {name}] {t['shape']}: kernel {t['ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, {lib}{extra}, bound "
                  f"{t['bound_ms']:.5f} ms ({t['bound_by']}), max abs err "
                  f"{t['max_abs_err']:.3g}")
    return report


def _kernel_name(name):
    """``void ns::foo_kernel<...>(...)`` -> ``foo_kernel``."""
    found = re.search(r"(\w+)[<(]", name)
    return found.group(1) if found else name[:40]


def _first_divergence(a, b):
    for rid in sorted(a):
        for i, (x, y) in enumerate(zip(a[rid], b[rid])):
            if x != y:
                return rid, i
        if len(a[rid]) != len(b[rid]):
            return rid, min(len(a[rid]), len(b[rid]))
    return None


def _device_events(torch, fn):
    """Run fn under torch.profiler; return its CUDA kernels as (name,
    start ns, end ns) in start order.  Only the device is traced:
    host-side operator events would add nothing read here and most of the
    trace's processing time.  The profiler's raw events are read, not
    ``prof.events()``, which builds a Python object for every event and
    correlates them (about 25 times slower to read)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(
        ((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
         for ev in prof.profiler.kineto_results.events()
         if ev.device_type() == torch.autograd.DeviceType.CUDA),
        key=lambda e: e[1])


def _busy_ms(intervals):
    """The length in ms of the union of (start ns, end ns) intervals: the
    time the device ran any of them.  Kernels on one stream overlap only
    under a programmatic dependent launch (the decode merge kernel starts
    while its split kernel runs), where a sum would count twice."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total / 1e6


def _device_time(torch, fn):
    """{kernel name: (summed GPU time in ms, launches)} of fn's run."""
    by_name = {}
    for name, s, e in _device_events(torch, fn):
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (e - s) / 1e6, n + 1)
    return by_name


def serve_measured(name, cfg, ecfg, run, n_requests, per_layer,
                   warm_up=True):
    """Warm-up (unless an earlier run of the same kernels was one), then
    one run between a reset and a read of every launch counter.  Every
    request must finish, and each kernel in ``per_layer`` (name ->
    "prefill", "decode" or "both") must have launched once per layer per
    prefill, per decode step or per both, every other kernel never.
    Returns ({summary, wall_s, launches}, the token streams)."""
    if warm_up:
        run()                               # warm-up: CUDA, cuBLAS init
    reset_launches()
    t0 = time.perf_counter()
    outputs, _, summary = run()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    check(summary["finished"] == n_requests and summary["rejected"] == 0,
          f"{name}: served {summary['finished']}/{n_requests} requests")
    L = cfg.num_layers
    steps = {"prefill": summary["prefills"],
             "decode": summary["decode_steps"]}
    steps["both"] = steps["prefill"] + steps["decode"]
    want = {k: 0 for k in launches}
    want.update({k: L * steps[when] for k, when in per_layer.items()})
    check(launches == want, f"{name}: launches {launches}, want {want} "
          f"({steps['prefill']} prefills, {steps['decode']} decode steps "
          f"of {L} layers)")
    t, p = summary["ttft_s"], summary["tpot_s"]
    print(f"[serve {name}] {cfg.name} ({L} layers) {cfg.dtype}, "
          f"{ecfg.n_slots} slots x {ecfg.max_len}: "
          f"{summary['finished']}/{n_requests} requests, "
          f"{summary['tokens_out']} tokens, {steps['prefill']} prefills, "
          f"{steps['decode']} decode steps in {wall_s:.3f} s; "
          f"{summary['throughput_tok_s']:.1f} tok/s; TTFT p50 "
          f"{t['p50'] * 1e3:.2f} ms p99 {t['p99'] * 1e3:.2f} ms; TPOT "
          f"p50 {p['p50'] * 1e3:.2f} ms p99 {p['p99'] * 1e3:.2f} ms; "
          f"kv_bytes_per_step {summary['kv_bytes_per_step']:.0f}"
          + (f"; paged {summary['paged']}" if "paged" in summary else ""))
    print(f"[serve {name}] launches: " + ", ".join(
        f"{k} {launches[k]} = {L} x {steps[w]} "
        + {"prefill": "prefills", "decode": "decode steps",
           "both": "prefills + decode steps"}[w]
        for k, w in per_layer.items()) + ", every other kernel 0")
    return {"summary": summary, "wall_s": wall_s,
            "launches": launches}, outputs


def _calls_ms(events, subs):
    """Device ms of each wrapper call in a trace: the union of the
    intervals of the kernels named by ``subs`` (substrings of the CUDA
    kernels' names, the first naming the kernel that starts each call)."""
    calls = []
    for n, s, e in events:
        if subs[0] in n:
            calls.append([])
        if calls and any(t in n for t in subs):
            calls[-1].append((s, e))
    return [_busy_ms(c) for c in calls]


def profile_serve(torch, name, run, wall_s, tags):
    """The workload once more under ``torch.profiler``: device busy time
    (the union of the kernels' intervals) over the measured (unprofiled)
    run's wall time, the top kernels, and the device time per wrapper call
    of each kernel in ``tags`` (report name -> substrings of the names of
    the CUDA kernels one call launches, the first naming the kernel that
    starts each call): the union of the call's kernels' intervals."""
    t0 = time.perf_counter()
    events = _device_events(torch, run)
    profile_s = time.perf_counter() - t0
    wall_ms = wall_s * 1e3
    busy_ms = _busy_ms([(s, e) for _, s, e in events])
    by_name = {}
    for n, s, e in events:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    per_launch = {}
    for kname, subs in tags.items():
        calls = _calls_ms(events, subs)
        if calls:
            per_launch[kname] = sum(calls) / len(calls)
    if busy_ms > 0:
        print(f"[profile {name}] device busy {busy_ms:.2f} ms of the "
              f"measured run's {wall_ms:.1f} ms wall "
              f"({busy_ms / wall_ms:.1%}); device ms per call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in per_launch.items())
              + "; top kernels: " + "; ".join(
                  f"{n[:48]} {ms:.2f} ms" for n, ms in top)
              + f"; the profiled run took {profile_s:.1f} s")
    else:
        print(f"[profile {name}] the profiler recorded no device time: "
              "device busy share not measured")
    return {"device_busy_ms": busy_ms, "wall_ms": wall_ms,
            "busy_share": busy_ms / wall_ms, "top_kernels_ms": top,
            "device_ms_per_launch": per_launch, "profile_s": profile_s}


def first_logits(torch, tf, cfg, params, ctx, prompt, ecfg, nxt_token=None):
    """The prefill row of ``prompt`` (padded to a multiple of 8) in slot 0
    and the logits of the first decode step after it, fed ``nxt_token``
    (the row's argmax when None), through ``ctx``."""
    dev = torch.device("cuda")
    toks = torch.zeros((1, -(-len(prompt) // 8) * 8), dtype=torch.long,
                       device=dev)
    toks[0, :len(prompt)] = torch.tensor(prompt, device=dev)
    with torch.inference_mode():
        cache = tf.init_slots(cfg, ecfg.n_slots, ecfg.max_len, device=dev)
        row, cache = tf.prefill_into_slot(cfg, params, cache, toks,
                                          len(prompt), 0, ctx)
        nxt = torch.zeros((ecfg.n_slots, 1), dtype=torch.long, device=dev)
        nxt[0, 0] = torch.argmax(row) if nxt_token is None else nxt_token
        step, _ = tf.decode_step(cfg, params, cache, nxt, ctx)
    return row, step


# flash_attention_rows_kernel (f32) or flash_attention_mma_kernel (bf16),
# one a call; a decode call's split kernel and its merge kernel
ATTN_TAGS = {"flash_attention": ("flash_attention_",),
             "decode": ("flash_decode_split_kernel",
                        "flash_decode_merge_kernel")}


# serving layouts beyond the dense bf16 cache: name -> (CacheLayout kwargs,
# the decode kernel that must carry every decode step)
LAYOUTS = {
    "paged": (dict(kind="paged", block_size=BLOCK_MAIN),
              "flash_decode_paged"),
    "int8": (dict(kv_bits=8), "flash_decode_quant"),
    "paged_int8": (dict(kind="paged", kv_bits=8, block_size=BLOCK_MAIN),
                   "flash_decode_paged_quant"),
}


def phase_serving(torch):
    from repro_torch import convert
    from repro_torch.config import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (CacheLayout, Clock, EngineConfig,
                                     Request, ServingEngine, TrafficConfig,
                                     generate, make_backend)
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

    def engine(c, params, ctx, clock=None, layout=None, e=ecfg):
        if layout is not None:
            e = dataclasses.replace(e, layout=layout)
        return ServingEngine(make_backend(c, params, ctx, layout=layout,
                                          device=dev), e, clock)

    def run(c, params, ctx, clock=None, layout=None, reqs=requests, e=ecfg):
        return engine(c, params, ctx, clock, layout, e).run(reqs)

    def pinned():
        return Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02)

    def measured(name, layout, decode_kernel):
        return serve_measured(
            name, cfg, ecfg, lambda: run(cfg, params, kern, layout=layout),
            len(requests),
            {"flash_attention": "prefill", decode_kernel: "decode"})[0]

    params = params_for(cfg)
    report = {"runs": {"dense": measured("dense", None, "flash_decode")}}
    for name, (kw, kname) in LAYOUTS.items():
        report["runs"][name] = measured(
            name, CacheLayout(impl="flash", **kw), kname)

    # where the time goes: each workload once more under the profiler;
    # device busy time over the measured (unprofiled) run's wall time, and
    # the device time per launch of the attention kernels on the main path
    report["profile"] = {}
    for name, (kw, _) in [("dense", ({}, None)), *LAYOUTS.items()]:
        layout = CacheLayout(impl="flash", **kw) if kw else None
        report["profile"][name] = profile_serve(
            torch, name, lambda: run(cfg, params, kern, layout=layout),
            report["runs"][name]["wall_s"], ATTN_TAGS)

    # first prefill row and first decode step: kernels vs plain path, in
    # bf16 (max abs diff relative to the largest plain logit: two bf16
    # paths that round attention probabilities at different places differ
    # by a few ulps of the largest logits) and in float32 (absolute)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = params_for(cfg32)
    logit_errs = {}
    for dname, c, ps, tol, relative in (
            ("bfloat16", cfg, params, BF16_TOL, True),
            ("float32", cfg32, params32, F32_TOL, False)):
        rows, steps = {}, {}
        for name, ctx in (("kernels", kern), ("plain", plain)):
            # both decode steps take the kernel path's first token
            tok = torch.argmax(rows["kernels"]) if rows else None
            rows[name], steps[name] = first_logits(
                torch, tf, c, ps, ctx, requests[0].prompt, ecfg, tok)
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
    report["logit_errs"] = logit_errs

    # greedy streams under a pinned clock: f32 must match exactly, bf16 is
    # reported with the logit margin of the first differing token
    streams, summaries = {}, {}
    for dname, c, ps in (("bfloat16", cfg, params),
                         ("float32", cfg32, params32)):
        for name, ctx in (("kernels", kern), ("plain", plain)):
            streams[dname, name], _, summaries[dname, name] = run(
                c, ps, ctx, pinned())
    n_tok = sum(len(v) for v in streams["float32", "plain"].values())

    def same_streams(a, b, what):
        div = _first_divergence(streams[a], streams[b])
        check(div is None, f"float32 greedy streams differ, {what}, at "
                           f"(rid, token) {div}")
        print(f"[serve] float32 pinned-clock greedy streams: {what} "
              f"({n_tok} tokens)")

    same_streams(("float32", "kernels"), ("float32", "plain"),
                 "kernel path == plain path")
    # the new layouts, float32, pinned clock
    for name, (kw, _) in LAYOUTS.items():
        streams["float32", name], _, summaries["float32", name] = run(
            cfg32, params32, kern, pinned(), CacheLayout(impl="flash", **kw))
    streams["float32", "int8_plain"] = run(
        cfg32, params32, kern, pinned(),
        CacheLayout(kv_bits=8, impl="dense"))[0]
    same_streams(("float32", "paged"), ("float32", "kernels"),
                 "paged kernel == dense kernel")
    same_streams(("float32", "int8"), ("float32", "int8_plain"),
                 "int8 kernel == int8 plain path")
    same_streams(("float32", "paged_int8"), ("float32", "int8"),
                 "paged int8 kernel == int8 kernel")

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
    report["bf16_near_tie"] = near_tie

    # prefix sharing on the card: 4 identical 40-token prompts (2 full
    # blocks + an 8-row tail), paged bf16 cache with 16-row blocks, float32
    prompt = tuple(int(t) for t in requests[0].prompt * 40)[:40]
    share_reqs = [Request(rid=i, user_id=i, prompt=prompt, max_new_tokens=8,
                          arrival=0.0) for i in range(4)]
    dense_out = run(cfg32, params32, kern, pinned(), reqs=share_reqs)[0]
    eng = engine(cfg32, params32, kern, pinned(),
                 CacheLayout(kind="paged", impl="flash",
                             block_size=BLOCK_MAIN))
    shared_out, _, ssum = eng.run(share_reqs)
    pg = ssum["paged"]
    check(pg["shared_hits"] > 0 and pg["cow_events"] > 0,
          f"prefix sharing: no shared block or no copy-on-write: {pg}")
    check(eng.pool.used_blocks == 0,
          f"prefix sharing: {eng.pool.used_blocks} blocks still used after "
          "the drain")
    check(_first_divergence(shared_out, dense_out) is None,
          "prefix sharing: streams differ from the dense run")
    print(f"[serve] prefix sharing, 4 x one 40-token prompt, blocks of "
          f"{BLOCK_MAIN}: {pg}; pool drained; float32 streams == dense")
    report["prefix_sharing"] = pg
    # the float32 one-token runs of the kernel path, layout by layout: the
    # spec phase holds its spec_k runs against them
    one = {"dense": "kernels", **{n: n for n in LAYOUTS}}
    report["f32_one_token"] = {
        layout: {"streams": streams["float32", name],
                 "finished": summaries["float32", name]["finished"],
                 "decode_steps": summaries["float32", name]["decode_steps"]}
        for layout, name in one.items()}
    return report


# -- speculative decode ---------------------------------------------------------

SPEC_K = 4               # verify rows a step (the launcher's --spec-k)
# the k-row verify shape of RecLLM-base: 8 slots, k = 4, mixed live rows;
# lengths are row 0's valid length (cache_len + 1), every live row fits S
VERIFY_MAIN = dict(B=8, Sq=SPEC_K, S=512, H=12, Hk=12, D=64,
                   lengths=[1, 37, 64, 100, 200, 300, 450, 509],
                   q_lens=[4, 1, 2, 3, 4, 1, 4, 4])
SPEC_MOE = ("moonlight", "moonshot-v1-16b-a3b", 12)   # phase 4's depth


@contextlib.contextmanager
def rows_seen():
    """Count, while active, the query rows (Sq) of every flash-decode
    launch and the (groups, group size) of every MoE route call: {"decode":
    {Sq: calls}, "moe_route": {(g, G): calls}}.  It wraps the decode
    wrappers' shared ``_launch`` and ``ops.moe_route``; the launch counters
    stay on the wrappers themselves."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ops
    seen = {"decode": {}, "moe_route": {}}
    launch, route = dk._launch, ops.moe_route

    def count(what, key):
        seen[what][key] = seen[what].get(key, 0) + 1

    def _launch(fn_name, q, *a, **kw):
        count("decode", q.shape[1])
        return launch(fn_name, q, *a, **kw)

    def moe_route(logits, *a, **kw):
        count("moe_route", tuple(logits.shape[:2]))
        return route(logits, *a, **kw)

    dk._launch, ops.moe_route = _launch, moe_route
    try:
        yield seen
    finally:
        dk._launch, ops.moe_route = launch, route


def phase_spec_serving(torch, one_token):
    """Speculative decode on the card (``EngineConfig.spec_k`` = SPEC_K
    against 1): RecLLM-base at full width in float32 under the four layouts
    against the serving phase's one-token runs (``one_token``: layout ->
    streams, finished, decode steps; streams token-exact, the pool
    drained, no more decode steps), the same in bf16 timed in turns and
    profiled, Moonlight (phase 4's depth) dense in float32 with the route
    kernel, and the layouts' decode entry points launched once per layer
    per step at Sq > 1.  The entry points at the verify shape are timed in
    the kernels phase."""
    from repro_torch import convert
    from repro_torch.config import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (CacheLayout, Clock, EngineConfig,
                                     ServingEngine, TrafficConfig, generate,
                                     make_backend)
    dev = torch.device("cuda")
    report = {"runs": {}, "profile": {}}
    kern = tf.ModelCtx(attn_impl="flash", decode_impl="flash", attn_chunk=8)
    ecfg = EngineConfig(n_slots=8, max_len=512)
    layouts = [("dense", None, "flash_decode")] + [
        (name, CacheLayout(impl="flash", **kw), kname)
        for name, (kw, kname) in LAYOUTS.items()]

    def serve(name, cfg, params, ctx, layout, spec_k, per_layer, requests,
              pinned=True, warm_up=False):
        """One measured run (serve_measured's launch checks) of a fresh
        engine; spec runs also count the rows of every launch."""
        e = dataclasses.replace(ecfg, spec_k=spec_k,
                                **({} if layout is None else
                                   {"layout": layout}))
        engines = []

        def run():
            engines.append(ServingEngine(
                make_backend(cfg, params, ctx, layout=layout, device=dev), e,
                Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02)
                if pinned else None))
            return engines[-1].run(requests)

        with rows_seen() as seen:
            res, streams = serve_measured(name, cfg, e, run, len(requests),
                                          per_layer, warm_up=warm_up)
        res["rows_seen"] = {"decode": seen["decode"],
                            "moe_route": {f"{g}x{G}": n for (g, G), n in
                                          seen["moe_route"].items()}}
        if spec_k > 1:
            s = res["summary"]["spec"]
            check(any(r > 1 for r in seen["decode"]),
                  f"{name}: no decode launch at Sq > 1 (rows seen "
                  f"{seen['decode']})")
            print(f"[spec {name}] accepted_tokens_per_step "
                  f"{s['accepted_tokens_per_step']:.4f}, "
                  f"verify_rows_per_step {s['verify_rows_per_step']:.4f}, "
                  f"{res['summary']['decode_steps']} decode steps; decode "
                  f"launches by Sq {seen['decode']}")
        pool = engines[-1].pool
        res["pool_used_after"] = None if pool is None else pool.used_blocks
        return res, streams, run

    def compare(name, one, spec):
        """``one``: the one-token run's streams, finished and decode steps;
        ``spec``: the spec run's (result, streams)."""
        rk, sk = spec
        steps = rk["summary"]["decode_steps"]
        div = _first_divergence(sk, one["streams"])
        check(div is None, f"{name}: spec streams differ from one-token "
                           f"streams at (rid, token) {div}")
        check(rk["summary"]["finished"] == one["finished"],
              f"{name}: finished {rk['summary']['finished']} != "
              f"{one['finished']}")
        check(steps <= one["decode_steps"],
              f"{name}: {steps} spec decode steps > {one['decode_steps']} "
              "one-token steps")
        check(rk["pool_used_after"] in (None, 0),
              f"{name}: {rk['pool_used_after']} blocks used after the run")
        print(f"[spec {name}] streams == one-token streams "
              f"({sum(len(v) for v in one['streams'].values())} tokens); "
              f"decode steps {steps} against {one['decode_steps']}"
              + ("; pool drained" if rk["pool_used_after"] == 0 else ""))

    # (a) float32, pinned clock: spec streams == the serving phase's
    # one-token streams (the same requests, params, clock and context)
    cfg = get_arch("recllm-base")
    requests = generate(TrafficConfig(n_requests=16,
                                      vocab_size=cfg.vocab_size, seed=0))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = convert.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    for name, layout, dkern in layouts:
        key = f"f32_{name}_k{SPEC_K}"
        r, streams, _ = serve(key, cfg32, params32, kern, layout, SPEC_K,
                              {"flash_attention": "prefill",
                               dkern: "decode"}, requests)
        report["runs"][key] = r
        report["runs"][key]["one_token_decode_steps"] = one_token[name][
            "decode_steps"]
        compare(f"f32_{name}", one_token[name], (r, streams))
    params32 = None
    torch.cuda.empty_cache()

    # (b) bf16, unpinned, in turns: one-token and spec runs alternate
    params = convert.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    bf16 = {}
    for i, (name, layout, dkern) in enumerate(layouts):
        per_layer = {"flash_attention": "prefill", dkern: "decode"}
        order = [1, SPEC_K, SPEC_K, 1] if name == "dense" else [SPEC_K, 1]
        for turn, k in enumerate(order):
            key = f"bf16_{name}_k{k}" + (f"_{turn}" if name == "dense"
                                        else "")
            r, streams, run = serve(key, cfg, params, kern, layout, k,
                                    per_layer, requests, pinned=False,
                                    warm_up=(i == 0 and turn == 0))
            report["runs"][key] = r
            bf16.setdefault((name, k), []).append((r, streams, run))
        for k in (1, SPEC_K):
            r, _, run = bf16[name, k][-1]
            report["profile"][f"bf16_{name}_k{k}"] = profile_serve(
                torch, f"spec bf16_{name}_k{k}", run, r["wall_s"], ATTN_TAGS)
        div = _first_divergence(bf16[name, SPEC_K][0][1], bf16[name, 1][0][1])
        report["runs"][f"bf16_{name}_divergence"] = div
        print(f"[spec bf16_{name}] streams spec against one-token: "
              + ("equal" if div is None else
                 f"first differ at (rid, token) {div}"))
    report["bf16_table"] = {}
    for name, _, _ in layouts:
        row = {}
        for k in (1, SPEC_K):
            rs = [r for r, _, _ in bf16[name, k]]
            su = [r["summary"] for r in rs]
            row[f"k{k}"] = {
                "tpot_p50_ms": [s["tpot_s"]["p50"] * 1e3 for s in su],
                "tpot_p99_ms": [s["tpot_s"]["p99"] * 1e3 for s in su],
                "ttft_p50_ms": [s["ttft_s"]["p50"] * 1e3 for s in su],
                "throughput_tok_s": [s["throughput_tok_s"] for s in su],
                "decode_steps": [s["decode_steps"] for s in su],
                "wall_s": [r["wall_s"] for r in rs],
                "busy_share": report["profile"][f"bf16_{name}_k{k}"][
                    "busy_share"]}
        report["bf16_table"][name] = row
        print(f"[spec bf16_{name}] one-token against spec k={SPEC_K}: " +
              "; ".join(f"{m} {row['k1'][m]} vs {row[f'k{SPEC_K}'][m]}"
                        for m in row["k1"]))
    params = None
    torch.cuda.empty_cache()

    # (c) Moonlight at phase 4's depth, float32, dense, the route kernel
    short, arch, n_layers = SPEC_MOE
    mcfg = dataclasses.replace(get_arch(arch), num_layers=n_layers,
                               dtype="float32")
    mparams = convert.init_params(
        mcfg, torch.Generator(device=dev).manual_seed(0), dev)
    mreqs = generate(TrafficConfig(n_requests=16,
                                   vocab_size=mcfg.vocab_size, seed=0))
    mctx = dataclasses.replace(kern, use_kernels=True)
    per_layer = {"flash_attention": "prefill", "flash_decode": "decode",
                 "moe_route": "both"}
    mruns = {}
    for k in (1, SPEC_K):
        key = f"{short}_f32_dense_k{k}"
        r, streams, _ = serve(key, mcfg, mparams, mctx, None, k, per_layer,
                              mreqs)
        report["runs"][key] = r
        mruns[k] = (r, streams)
    groups = {G for (g, G) in
              (tuple(map(int, s.split("x")))
               for s in mruns[SPEC_K][0]["rows_seen"]["moe_route"])
              if g == ecfg.n_slots}
    check(any(G > 1 for G in groups), f"{short}: no route launch with "
                                      f"groups of the verify rows ({groups})")
    print(f"[spec {short}] route calls by (groups x group size): "
          f"{mruns[SPEC_K][0]['rows_seen']['moe_route']}")
    r1, s1 = mruns[1]
    compare(f"{short}_f32_dense",
            {"streams": s1, "finished": r1["summary"]["finished"],
             "decode_steps": r1["summary"]["decode_steps"]}, mruns[SPEC_K])
    mparams = None
    torch.cuda.empty_cache()
    return report


# -- CF head serving ----------------------------------------------------------

CF_USERS = 10_000        # TrafficConfig's n_users (the launcher's head)
CF_DIM = 16              # the launcher's cf_dim
CF_CACHE_ROWS = 128      # the launcher's --cf-cache-rows
CF_CANDIDATES = 16
CF_TAGS = {"gather_rows": ("gather_rows_kernel",)}
CF_ROUNDS = 3            # unpinned runs of each engine, in turns


def phase_cf_serving(torch, card):
    """RecLLM-base at full width in bf16 with the CF head scoring every
    request's candidate set at admission (the kernels context of the dense
    run, 16 requests of ``TrafficConfig(seed=0, candidates=16)`` on 8 slots
    x 512, 10,000 users).  Two heads carry the same tables, with no hot-row
    cache and with 128 rows; a tracer and a registry ride on the cached
    run.  Under a pinned clock: greedy streams equal to the same engine's
    without a head, cf / fused / ranking bit-equal between the heads, one
    request's cf equal to numpy's over the host tables, the registry's
    cf_cache counters equal to the head's, ``gather_rows`` launched twice a
    scored request without the cache and once a lookup with a miss with
    it, TTFT equal to the spans' sum with every ``cf.lookup`` inside its
    ``req.prefill``, and the Chrome trace reloading whole.  Unpinned: TTFT
    p50 with and without the head, ``cf.lookup`` ms a request, and the
    profiler's ``gather_rows`` device ms a call on this path."""
    import tempfile

    import numpy as np

    from repro_torch import convert
    from repro_torch.config import get_arch
    from repro_torch.embeddings import (CacheConfig, CachedLookup, EmbedSpec,
                                        init_table, make_plan)
    from repro_torch.models import transformer as tf
    from repro_torch.obs import MetricsRegistry, Tracer, write_trace
    from repro_torch.serving import (CFConfig, CFHead, Clock, EngineConfig,
                                     ServingEngine, TrafficConfig, generate,
                                     make_backend)
    dev = torch.device("cuda")
    cfg = get_arch("recllm-base")
    ecfg = EngineConfig(n_slots=8, max_len=512)
    requests = generate(TrafficConfig(n_requests=16,
                                      vocab_size=cfg.vocab_size, seed=0,
                                      candidates=CF_CANDIDATES,
                                      n_users=CF_USERS))
    kern = tf.ModelCtx(attn_impl="flash", decode_impl="flash", attn_chunk=8)
    params = convert.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    user = init_table(gen, EmbedSpec("cf_user", CF_USERS, CF_DIM), dev)
    item = init_table(gen, EmbedSpec("cf_item", cfg.vocab_size, CF_DIM), dev)
    user_np, item_np = user.cpu().numpy(), item.cpu().numpy()

    def head(rows):
        return CFHead(user, item, cfg=CFConfig(cache_rows=rows), device=dev)

    def pinned():
        return Clock(fixed_decode_s=0.01, fixed_prefill_s=0.02,
                     fixed_cf_s=0.005)

    def engine(cf_head, clock=None, tracer=None, metrics=None):
        return ServingEngine(make_backend(cfg, params, kern, device=dev),
                             ecfg, clock, tracer=tracer, metrics=metrics,
                             cf_head=cf_head)

    engine(head(0)).run(requests)           # warm-up: the head's path too
    L = cfg.num_layers

    def launches_of(name, eng, run, gathers):
        reset_launches()
        outputs, records, summary = run()
        got = read_launches()
        check(summary["finished"] == len(requests)
              and summary["rejected"] == 0,
              f"cf {name}: served {summary['finished']}/{len(requests)}")
        want = {k: 0 for k in got}
        want.update(flash_attention=L * summary["prefills"],
                    flash_decode=L * summary["decode_steps"],
                    gather_rows=gathers(eng))
        check(got == want, f"cf {name}: launches {got}, want {want}")
        return outputs, records, summary, got

    # pinned clock: one schedule for every run, so streams and scores
    # compare exactly
    plain_out = engine(None, pinned()).run(requests)[0]
    eng_u = engine(head(0), pinned())
    out_u, _, sum_u, l_u = launches_of(
        "uncached", eng_u, lambda: eng_u.run(requests),
        lambda e: 2 * e.cf_scored)
    tracer, registry = Tracer(), MetricsRegistry()
    eng_c = engine(head(CF_CACHE_ROWS), pinned(), tracer, registry)

    def missed_lookups(e):
        """Lookups with a miss, from the scored requests replayed through
        CPU lookups of the same tables and cache: an independent count of
        the device gathers the cached head must have made."""
        cache = CacheConfig(rows=CF_CACHE_ROWS)
        plan = make_plan("replicated")
        lk = {n: CachedLookup(EmbedSpec(n, *t.shape), plan, t,
                              device="cpu", cache=cache)
              for n, t in (("cf_user", user_np), ("cf_item", item_np))}
        by_rid = {r.rid: r for r in requests}
        n = 0
        for rid in e.cf_results:                # in scoring order
            r = by_rid[rid]
            n += lk["cf_user"]([r.user_id])[1]["misses"] > 0
            n += lk["cf_item"](list(r.candidates))[1]["misses"] > 0
        return n

    out_c, recs_c, sum_c, l_c = launches_of(
        "cached", eng_c, lambda: eng_c.run(requests), missed_lookups)
    check(eng_u.cf_scored == eng_c.cf_scored == len(requests),
          f"cf: scored {eng_u.cf_scored} / {eng_c.cf_scored} of "
          f"{len(requests)} requests")
    for name, out in (("uncached", out_u), ("cached", out_c)):
        div = _first_divergence(out, plain_out)
        check(div is None, f"cf {name}: greedy streams differ from the "
                           f"engine's without a head at (rid, token) {div}")
    for rid, ru in eng_u.cf_results.items():
        rc = eng_c.cf_results[rid]
        for k in ("cf", "fused", "ranking"):
            check(np.array_equal(rc[k], ru[k]),
                  f"cf: request {rid}'s {k} differs cached vs uncached")
        r = next(x for x in requests if x.rid == rid)
        check(sorted(ru["ranking"].tolist()) == sorted(r.candidates),
              f"cf: request {rid}'s ranking is not a permutation of its "
              "candidates")
    r0 = requests[0]
    want_cf = item_np[np.asarray(r0.candidates)] @ user_np[r0.user_id]
    check(np.array_equal(eng_c.cf_results[r0.rid]["cf"], want_cf),
          "cf: request 0's scores differ from numpy's item[cand] @ user[u]")
    counters = registry.snapshot()["counters"]
    head_c = eng_c.cf_head
    check(counters["cf_cache.hits"] + counters["cf_cache.misses"]
          == head_c.hits + head_c.misses,
          f"cf: registry counters {counters} against the head's "
          f"{head_c.hits} hits + {head_c.misses} misses")
    spans = {}
    for e in tracer.events:
        if e["ph"] == "X" and "rid" in e["args"]:
            spans.setdefault(e["args"]["rid"], {})[e["name"]] = e
    for rec in recs_c:
        sp = spans[rec.rid]
        cf_sp, pf = sp["cf.lookup"], sp["req.prefill"]
        check(abs(sp["req.queue_wait"]["dur"] + pf["dur"] - rec.ttft)
              <= 1e-9, f"cf: request {rec.rid}'s TTFT differs from its "
                       "spans' sum")
        check(pf["ts"] <= cf_sp["ts"]
              and cf_sp["ts"] + cf_sp["dur"] <= pf["ts"] + pf["dur"] + 1e-9,
              f"cf: request {rec.rid}'s cf.lookup lies outside req.prefill")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cf_trace.json")
        n_events = write_trace(path, tracer, registry)
        events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    check(len(events) == n_events and all(
        all(k in e for k in ("ph", "ts", "pid", "tid")) for e in events),
          "cf: the Chrome trace does not reload with ph/ts/pid/tid")
    print(f"[cf] {cfg.name} bf16, {len(requests)} requests x "
          f"{CF_CANDIDATES} candidates, {CF_USERS:,} users, cf_dim "
          f"{CF_DIM}: pinned-clock streams == the engine's without a head; "
          f"cf/fused/ranking bit-equal uncached vs cached "
          f"({CF_CACHE_ROWS} rows, hit rate {head_c.hit_rate:.3f}); "
          f"gather_rows launches {l_u['gather_rows']} uncached (2 x "
          f"{eng_u.cf_scored} scored), {l_c['gather_rows']} cached (lookups "
          f"with a miss); TTFT == spans within 1e-9 s; trace {n_events} "
          "events reloaded")

    # unpinned: what the head costs a request; the three engines in turns
    # (the order reversed every other round), TTFT p50 pooled by median
    variants = [("no_head", None), ("cached", CF_CACHE_ROWS), ("uncached", 0)]
    rounds = {name: [] for name, _ in variants}
    for rnd in range(CF_ROUNDS):
        for name, rows in (variants if rnd % 2 == 0 else variants[::-1]):
            tr = Tracer()
            t0 = time.perf_counter()
            _, _, summary = engine(None if rows is None else head(rows),
                                   tracer=tr).run(requests)
            rounds[name].append({
                "ttft_p50_ms": summary["ttft_s"]["p50"] * 1e3,
                "tpot_p50_ms": summary["tpot_s"]["p50"] * 1e3,
                "wall_s": time.perf_counter() - t0,
                "cf_ms": [e["dur"] * 1e3 for e in tr.events
                          if e["name"] == "cf.lookup"]})
    timing = {}
    for name, runs in rounds.items():
        cf_ms = sorted(x for r in runs for x in r["cf_ms"])
        timing[name] = {
            "ttft_p50_ms": [r["ttft_p50_ms"] for r in runs],
            "tpot_p50_ms": [r["tpot_p50_ms"] for r in runs],
            "wall_s": runs[-1]["wall_s"]}
        if cf_ms:
            timing[name]["cf_lookup_ms_p50"] = float(np.percentile(cf_ms, 50))
            timing[name]["cf_lookup_ms_p99"] = float(np.percentile(cf_ms, 99))
        print(f"[cf {name}] ({card}) TTFT p50 of {CF_ROUNDS} runs in turns "
              f"(median {np.median(timing[name]['ttft_p50_ms']):.3f}): "
              + ", ".join(f"{x:.3f}" for x in timing[name]["ttft_p50_ms"])
              + " ms; TPOT p50 " + ", ".join(
                  f"{x:.3f}" for x in timing[name]["tpot_p50_ms"]) + " ms"
              + (f"; cf.lookup a request p50 "
                 f"{timing[name]['cf_lookup_ms_p50']:.4f} ms p99 "
                 f"{timing[name]['cf_lookup_ms_p99']:.4f} ms (n "
                 f"{len(cf_ms)})" if cf_ms else ""))

    # where a cf.lookup's time goes: each part alone on request 0's ids,
    # host clock around synchronised work, median of 50 calls
    def host_ms(fn, n=50):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    cand = np.asarray(r0.candidates, np.int64)
    row = torch.randn(cfg.vocab_size, generator=gen, device=dev).to(
        torch.bfloat16)
    cold, hot = head(0), head(CF_CACHE_ROWS)
    for _ in range(3):                      # elect request 0's ids
        hot.score(r0.user_id, cand, row)
    parts = {
        "user_gather_round_trip": lambda: cold.lookups["cf_user"](
            [r0.user_id]),
        "item_gather_round_trip": lambda: cold.lookups["cf_item"](cand),
        "logits_at_candidates": lambda: row[
            torch.as_tensor(cand, device=dev)].float().cpu(),
        "cached_item_lookup_all_hits": lambda: hot.lookups["cf_item"](cand),
        "score_uncached": lambda: cold.score(r0.user_id, cand, row),
        "score_cached_all_hits": lambda: hot.score(r0.user_id, cand, row)}
    breakdown = {k: host_ms(fn) for k, fn in parts.items()}
    print(f"[cf] ({card}) a cf.lookup's parts, host ms (median of 50, "
          f"{len(cand)} candidates): " + ", ".join(
              f"{k} {v:.4f}" for k, v in breakdown.items()))
    prof = profile_serve(
        torch, "cf uncached",
        lambda: engine(head(0)).run(requests),
        timing["uncached"]["wall_s"], CF_TAGS)
    gather_ms = prof["device_ms_per_launch"].get("gather_rows")
    print(f"[cf] ({card}) gather_rows device ms a call on the CF serve "
          "path: " + ("not measured" if gather_ms is None
                      else f"{gather_ms:.5f}"))
    return {"runs": {"uncached": {"launches": l_u, "cf": sum_u["cf"]},
                     "cached": {"launches": l_c, "cf": sum_c["cf"]}},
            "timing": timing, "breakdown_ms": breakdown, "profile": prof,
            "gather_rows_device_ms": gather_ms}


# -- MoE serving --------------------------------------------------------------

# (run prefix, arch, layers kept of its 48): full width, depth cut to fit
# the smoke run's time beside the RecLLM phases
MOE_SERVE = [("moonlight", "moonshot-v1-16b-a3b", 12),
             ("qwen3", "qwen3-moe-30b-a3b", 4)]
# "moe_route_" names both route kernels (moe_route_kernel for a prompt,
# moe_route_decode_kernel for a decode step) and not moe_router_kernel
ROUTER_TAGS = dict(ATTN_TAGS, moe_router=("moe_router_kernel",),
                   moe_route=("moe_route_",))


def phase_moe_serving(torch):
    """The MoE archs at full width in bf16 through ``repro_torch.serving``
    with every MoE FFN routed through the route kernel: Moonlight under
    the dense, paged, int8 and paged int8 layouts and dense once with the
    plain router; Qwen3 (qk-norm, 128 experts top 8, GQA 32 on 4) dense."""
    from repro_torch import convert
    from repro_torch.config import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (CacheLayout, EngineConfig,
                                     ServingEngine, TrafficConfig, generate,
                                     make_backend)
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    ecfg = EngineConfig(n_slots=8, max_len=512)
    kern = tf.ModelCtx(attn_impl="flash", decode_impl="flash", attn_chunk=8,
                       use_kernels=True)
    plain_router = dataclasses.replace(kern, use_kernels=False)
    report = {"runs": {}, "profile": {}, "models": {}}
    for short, arch, layers in MOE_SERVE:
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        params = convert.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        leaves = tree_leaves(params)
        n_params = sum(t.numel() for t in leaves)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        print(f"[moe {short}] {arch}: {layers} of 48 layers at full width "
              f"(d_model {cfg.d_model}, {cfg.num_heads} heads on "
              f"{cfg.num_kv_heads} x {cfg.head_dim}, {cfg.num_experts} "
              f"experts top {cfg.experts_per_token} of d_ff {cfg.d_ff}, "
              f"vocab {cfg.vocab_size:,}), {cfg.dtype}: {n_params:,} "
              f"parameters, {n_bytes / 1e9:.2f} GB")
        report["models"][short] = {"arch": arch, "layers": layers,
                                   "params": n_params, "bytes": n_bytes}
        requests = generate(TrafficConfig(n_requests=16,
                                          vocab_size=cfg.vocab_size, seed=0))

        def run(ctx, layout=None):
            e = ecfg if layout is None else dataclasses.replace(
                ecfg, layout=layout)
            return ServingEngine(make_backend(cfg, params, ctx, layout=layout,
                                              device=dev), e).run(requests)

        runs = [("dense", kern, None, "flash_decode")]
        if short == "moonlight":
            runs.append(("dense_plain_router", plain_router, None,
                         "flash_decode"))
            runs += [(name, kern, CacheLayout(impl="flash", **kw), kname)
                     for name, (kw, kname) in LAYOUTS.items()]
        streams = {}
        for name, ctx, layout, dkern in runs:
            per_layer = {"flash_attention": "prefill", dkern: "decode"}
            if ctx.use_kernels:
                per_layer["moe_route"] = "both"
            key = f"{short}_{name}"
            fn = (lambda ctx=ctx, layout=layout: run(ctx, layout))
            report["runs"][key], streams[name] = serve_measured(
                key, cfg, ecfg, fn, len(requests), per_layer)
            report["profile"][key] = profile_serve(
                torch, key, fn, report["runs"][key]["wall_s"], ROUTER_TAGS)

        if short == "moonlight":
            n_tok = sum(len(v) for v in streams["dense"].values())
            div = _first_divergence(streams["dense"],
                                    streams["dense_plain_router"])
            report["router_stream_divergence"] = div
            check(div is None, f"{arch}: greedy streams of the route kernel "
                  f"and of the plain router differ at (rid, token) {div}")
            print(f"[moe {short}] greedy streams, route kernel == plain "
                  f"router ({n_tok} tokens)")
            # the first prefill row and decode step through both routers:
            # finite, and within the bf16 tolerance of the largest logit
            rows, steps = {}, {}
            for name, ctx in (("kernel", kern), ("plain", plain_router)):
                tok = torch.argmax(rows["kernel"]) if rows else None
                rows[name], steps[name] = first_logits(
                    torch, tf, cfg, params, ctx, requests[0].prompt, ecfg,
                    tok)
            check(all(bool(torch.isfinite(x).all())
                      for x in (*rows.values(), *steps.values())),
                  f"{arch}: non-finite logits")
            scale = max(float(rows["plain"].float().abs().max()),
                        float(steps["plain"].float().abs().max()))
            e = {"prefill_abs": _max_err(rows["kernel"], rows["plain"]),
                 "decode_abs": _max_err(steps["kernel"], steps["plain"]),
                 "largest_logit": scale}
            report["router_logit_errs"] = e
            print(f"[moe {short}] bf16 logits, route kernel vs plain "
                  f"router: first prefill row max abs diff "
                  f"{e['prefill_abs']:.3g}, first decode step "
                  f"{e['decode_abs']:.3g} (tolerance {BF16_TOL} relative to "
                  f"the largest logit {scale:.3g})")
            check(max(e["prefill_abs"], e["decode_abs"]) <= BF16_TOL * scale,
                  f"{arch}: the route kernel's logits differ from the "
                  f"plain router's: {e}")
        params = leaves = None               # free the weights for the next
        torch.cuda.empty_cache()
    return report


# -- rwkv6 serving ------------------------------------------------------------

# a call's kernels: the chunks, the segment boundaries' states (long
# prompts only), then the state carried across the chunks
WKV_TAGS = {"wkv6_chunked": ("wkv6_intra_kernel", "wkv6_span_kernel",
                             "wkv6_carry_kernel")}
WKV_LONG = 4096          # the long prompt's tokens (a long user history)
WKV_PROMPTS = 4          # prompts whose first logits are compared


def _wkv_scan(on):
    """While ``on``: the model's WKV kernel calls routed to the sequential
    scan (``ops.wkv6_chunked(impl="ref")``), a second plain path."""
    import contextlib

    from repro_torch.kernels import ops
    kernel = ops.wkv6_chunked

    @contextlib.contextmanager
    def routed():
        ops.wkv6_chunked = (lambda *a, **kw: kernel(*a, **dict(kw,
                                                              impl="ref")))
        try:
            yield
        finally:
            ops.wkv6_chunked = kernel
    return routed() if on else contextlib.nullcontext()


def long_prompt(torch, tf, bf16, f32, kern, plain):
    """One ``WKV_LONG``-token prompt through rwkv6's forward at full width,
    with the WKV kernel and with the plain chunked recurrence.  In bf16
    (``bf16`` = (cfg, params)): the wall time of each (after a warm-up),
    the WKV launches, a profile (device busy, the kernel's device ms per
    call: the union of its kernels' intervals) and the logits' difference
    beside the bf16 tolerance (reported: see the first-row check).  In
    float32: the logits of the two paths held within ``F32_TOL``."""
    dev = torch.device("cuda")
    tokens = torch.randint(0, bf16[0].vocab_size, (1, WKV_LONG), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    out, diffs = {}, {}
    for dname, (cfg, params) in (("bfloat16", bf16), ("float32", f32)):
        logits = {}
        for name, ctx in (("kernel", kern), ("plain", plain)):
            def fwd(ctx=ctx):
                with torch.inference_mode():
                    return tf.forward(cfg, params, {"tokens": tokens},
                                      ctx)[0]
            if dname == "float32":
                logits[name] = fwd()
                continue
            fwd()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            logits[name] = fwd()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = read_launches()["wkv6_chunked"]
            events = _device_events(torch, fwd)
            calls = _calls_ms(events, WKV_TAGS["wkv6_chunked"])
            busy_ms = _busy_ms([(a, b) for _, a, b in events])
            out[name] = {"wall_s": wall_s, "wkv_launches": launches,
                         "device_busy_ms": busy_ms,
                         "wkv_ms_per_call": (sum(calls) / len(calls)
                                             if calls else None)}
        check(all(bool(torch.isfinite(x).all()) for x in logits.values()),
              f"rwkv6 long prompt: non-finite {dname} logits")
        diffs[dname] = (_max_err(logits["kernel"], logits["plain"]),
                        float(logits["plain"].float().abs().max()))
        logits = None
    check(out["kernel"]["wkv_launches"] == bf16[0].num_layers
          and out["plain"]["wkv_launches"] == 0,
          f"rwkv6 long prompt: WKV launches {out['kernel']['wkv_launches']} "
          f"with the kernel (want {bf16[0].num_layers}), "
          f"{out['plain']['wkv_launches']} plain (want 0)")
    out["logit_abs"] = diffs
    k, pl = out["kernel"], out["plain"]
    per_call = ("not measured (no device event traced)"
                if k["wkv_ms_per_call"] is None
                else f"{k['wkv_ms_per_call']:.4f} ms")
    (d16, big16), (d32, _) = diffs["bfloat16"], diffs["float32"]
    print(f"[rwkv6 long prompt] {bf16[0].name}, one {WKV_LONG}-token prompt "
          f"through the forward in bf16: kernel {k['wall_s'] * 1e3:.1f} ms "
          f"wall, device busy {k['device_busy_ms']:.2f} ms, WKV "
          f"{k['wkv_launches']} calls, device time of each {per_call}; "
          f"plain chunked {pl['wall_s'] * 1e3:.1f} ms wall, device busy "
          f"{pl['device_busy_ms']:.2f} ms; logits max abs diff over all "
          f"{WKV_LONG} positions: bf16 {d16:.3g} ({d16 / big16:.4f} of the "
          f"largest logit {big16:.3g}; the bf16 tolerance is {BF16_TOL}), "
          f"float32 {d32:.3g} (tolerance {F32_TOL} absolute)")
    check(d32 <= F32_TOL, f"rwkv6 long prompt: the WKV kernel's float32 "
          f"logits differ from the plain path's by {d32} > {F32_TOL}")
    return out


def phase_rwkv6_serving(torch):
    """rwkv6-1.6b at full width (24 layers, d_model 2048, 32 heads of 64,
    vocab 65,536) in bf16 through ``repro_torch.serving``: under the dense
    and paged layouts with every prefill's WKV through the kernel, and
    dense once with the plain chunked recurrence."""
    from repro_torch import convert
    from repro_torch.config import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (CacheLayout, EngineConfig,
                                     ServingEngine, TrafficConfig, generate,
                                     make_backend)
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    cfg = get_arch("rwkv6-1.6b")
    ecfg = EngineConfig(n_slots=8, max_len=512)
    kern = tf.ModelCtx(attn_chunk=8, use_kernels=True)
    plain = tf.ModelCtx(attn_chunk=8)
    params = convert.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"[rwkv6] {cfg.name}: {cfg.num_layers} layers at full width "
          f"(d_model {cfg.d_model}, {cfg.d_model // cfg.rwkv_head_size} "
          f"heads of {cfg.rwkv_head_size}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size:,}), {cfg.dtype}: {n_params:,} parameters, "
          f"{n_bytes / 1e9:.2f} GB")
    report = {"runs": {}, "profile": {},
              "model": {"params": n_params, "bytes": n_bytes}}
    requests = generate(TrafficConfig(n_requests=16,
                                      vocab_size=cfg.vocab_size, seed=0))

    def run(ctx, layout=None):
        e = ecfg if layout is None else dataclasses.replace(ecfg,
                                                            layout=layout)
        return ServingEngine(make_backend(cfg, params, ctx, layout=layout,
                                          device=dev), e).run(requests)

    # paged runs the dense run's model calls (warmed up by it); the kernel
    # and plain dense runs are profiled, the device-time comparison the
    # phase reports
    streams = {}
    for name, ctx, layout in (
            ("dense", kern, None),
            ("paged", kern, CacheLayout(kind="paged", block_size=BLOCK_MAIN)),
            ("dense_plain", plain, None)):
        per_layer = {"wkv6_chunked": "prefill"} if ctx.use_kernels else {}
        fn = (lambda ctx=ctx, layout=layout: run(ctx, layout))
        report["runs"][name], streams[name] = serve_measured(
            f"rwkv6_{name}", cfg, ecfg, fn, len(requests), per_layer,
            warm_up=name != "paged")
        if name != "paged":
            report["profile"][name] = profile_serve(
                torch, f"rwkv6_{name}", fn, report["runs"][name]["wall_s"],
                WKV_TAGS)
    n_tok = sum(len(x) for x in streams["dense"].values())
    div = _first_divergence(streams["paged"], streams["dense"])
    check(div is None, f"rwkv6: paged streams differ from dense at (rid, "
                       f"token) {div}, though the paged layout pages nothing")
    print(f"[rwkv6] greedy streams, paged == dense with the kernel "
          f"({n_tok} tokens)")
    div = _first_divergence(streams["dense"], streams["dense_plain"])
    report["plain_stream_divergence"] = div
    print("[rwkv6] greedy streams, kernel vs plain chunked recurrence: "
          + ("equal" if div is None
             else f"first differ at (rid, token) {div}"))
    # the first prefill row and decode step of the first WKV_PROMPTS
    # requests through the WKV kernel and the plain chunked recurrence,
    # held in float32 (absolute, as phase 3's float32 check).  In bf16 the
    # 24 layers turn float32 rounding differences of the WKV output into
    # bf16 rounding flips that the two plain paths, the chunked recurrence
    # and the sequential scan, show as well, so the bf16 figures are
    # printed beside the plain paths' drift
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = convert.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    e = {}
    for dname, c, ps in (("bfloat16", cfg, params),
                         ("float32", cfg32, params32)):
        for req in requests[:WKV_PROMPTS]:
            rows, steps = {}, {}
            for name, ctx in (("kernel", kern), ("plain", plain),
                              ("scan", kern)):
                tok = torch.argmax(rows["kernel"]) if rows else None
                with _wkv_scan(name == "scan"):
                    rows[name], steps[name] = first_logits(
                        torch, tf, c, ps, ctx, req.prompt, ecfg, tok)
            check(all(bool(torch.isfinite(x).all())
                      for x in (*rows.values(), *steps.values())),
                  f"rwkv6: non-finite {dname} logits")
            big = (max(float(rows["plain"].float().abs().max()),
                       float(steps["plain"].float().abs().max()))
                   if dname == "bfloat16" else 1.0)
            for name in ("kernel", "scan"):
                e.setdefault((dname, name), []).append(
                    max(_max_err(rows[name], rows["plain"]),
                        _max_err(steps[name], steps["plain"])) / big)
    report["logit_errs"] = {f"{d} {n}": v for (d, n), v in e.items()}

    def listed(key):
        return ", ".join(f"{x:.3g}" for x in e[key])
    print(f"[rwkv6] float32 logits, max abs diff from the plain chunked "
          f"recurrence, first prefill row and decode step of "
          f"{WKV_PROMPTS} prompts: WKV kernel {listed(('float32', 'kernel'))}"
          f" (tolerance {F32_TOL} absolute), sequential scan (plain) "
          f"{listed(('float32', 'scan'))}")
    print(f"[rwkv6] bf16 logits, the same relative to the largest logit: "
          f"WKV kernel {listed(('bfloat16', 'kernel'))}, sequential scan "
          f"(plain) {listed(('bfloat16', 'scan'))} (the bf16 tolerance is "
          f"{BF16_TOL})")
    check(max(e["float32", "kernel"]) <= F32_TOL,
          f"rwkv6: the WKV kernel's float32 logits differ from the plain "
          f"path's by {max(e['float32', 'kernel'])} > {F32_TOL}")
    rows = steps = None
    report["long_prompt"] = long_prompt(torch, tf, (cfg, params),
                                        (cfg32, params32), kern, plain)
    params = leaves = None
    torch.cuda.empty_cache()
    return report


# -- gradient compression (training) -----------------------------------------

# the cases of tests/test_torch_compress.py
ONEBIT_CASES = [(8 * 512, 512), (8 * 2048, 512), (8 * 1024, 1024)]  # N, block
TOPK_CASES = [(4096, 512, 8), (8192, 2048, 32), (2048, 256, 1)]   # N, block, k
SCALE_RTOL = 1e-6        # 1-bit scales: a mean of 8 * block |g|, any order
TIED = (0.0, 0.5, -0.5, 1.0, -1.0, 2.0)   # magnitudes that tie within a row
# the cf_user row compressor's top-k (nb, block, k): a batch's unique
# users, sentinel-padded to the batch of 32, x the 64-wide row, k = 8
ROW_TOPK = (32, 64, 8)
TOPK_GATE_MS = 3.1471    # the earlier design at the flat shape (PERF.md)


def full_width_size(cfg, n_users, cf_dim=64):
    """RecLLM's parameter count: tied embedding, stacked blocks (q, k, v,
    o; gated MLP; two RMSNorm scales a layer), final norm, the CF tables
    and the fusion gate."""
    d, L = cfg.d_model, cfg.num_layers
    layer = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d \
        + 3 * d * cfg.d_ff + 2 * d
    return (cfg.padded_vocab * d + L * layer + d
            + (cfg.padded_vocab + n_users) * cf_dim + 1)


def train_config():
    """The training phase's RecLLM-base (the full dataset's vocab, padded
    to 64, float32, as ``launch/train_recsys.py --full`` sets it)."""
    from repro_torch.config import get_arch
    from repro_torch.recsys import dataset
    n_items = max(64, int(dataset.FULL_ITEMS * 1.0))
    n_users = max(32, int(dataset.FULL_USERS * 1.0))
    cfg = dataclasses.replace(get_arch("recllm-base"), vocab_size=n_items + 3,
                              vocab_pad_to=64, dtype="float32")
    return cfg, n_users


def _pad(n, mult):
    return n + (-n) % mult


def phase_compress_kernels(torch, report):
    """The compression kernels against their plain versions, then timed at
    the training phase's flat size; rows added to ``report["timing"]``."""
    from repro_torch.kernels import grad_compress as gc
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_sparsify as tk
    from repro_torch.runtime.trainer import DPSyncConfig
    inp = Inputs(torch)
    dev = inp.dev
    scfg = DPSyncConfig()
    cfg, n_users = train_config()
    n_params = full_width_size(cfg, n_users)
    n_onebit = _pad(n_params, 8 * scfg.block)
    n_topk = _pad(n_params, scfg.topk_block)

    def data(n, kind):
        if kind == "normal":
            return inp.randn(n, dtype=torch.float32)
        pick = torch.randint(0, len(TIED), (n,), generator=inp.gen,
                             device=dev)
        return torch.tensor(TIED, device=dev)[pick]

    def onebit_case(n, block, kind):
        g2d = data(n, kind).reshape(8, n // 8)
        pk, sk = gc.onebit_quantize(g2d, block)
        pr, sr = ref.onebit_quantize(g2d, block)
        check(torch.equal(pk, pr), f"onebit_quantize N={n} block={block} "
              f"{kind}: packed bytes differ from the plain version")
        rel = float(((sk - sr).abs() / sr.abs().clamp(min=1e-30)).max())
        check(rel <= SCALE_RTOL, f"onebit_quantize N={n} block={block} "
              f"{kind}: scales {rel} relative from the plain version")
        dk = gc.onebit_dequantize(torch.stack([pk, pr]),
                                  torch.stack([sk, sr]), block)
        dr = ref.onebit_dequantize(torch.stack([pk, pr]),
                                   torch.stack([sk, sr]), block)
        check(torch.equal(dk, dr), f"onebit_dequantize N={n} block={block} "
              f"{kind}: differs from the plain version")
        return rel, float((sk - sr).abs().max()), float((dk - dr).abs().max())

    def topk_case(n, block, k, kind):
        """(sparsify's, select's) max abs error; each must be 0."""
        x2d = data(n, kind).reshape(n // block, block)
        kk, rk = tk.topk_sparsify(x2d, k)
        kr, rr = ref.topk_sparsify_rounds(x2d, k)
        check(torch.equal(kk, kr) and torch.equal(rk, rr),
              f"topk_sparsify N={n} block={block} k={k} {kind}: kept or "
              "residual differ from the plain version")
        ik, vk, sk = tk.topk_select(x2d, k)
        ir, vr, sr = ref.topk_select(x2d, k)
        check(torch.equal(ik, ir) and torch.equal(vk, vr)
              and torch.equal(sk, sr), f"topk_select N={n} block={block} "
              f"k={k} {kind}: indices, values or the sent residual differ "
              "from the plain version")
        return (max(_max_err(kk, kr), _max_err(rk, rr)),
                max(_max_err(vk, vr), _max_err(sk, sr)))

    worst = 0.0
    for kind in ("normal", "tied"):
        for n, block in ONEBIT_CASES:
            worst = max(worst, onebit_case(n, block, kind)[0])
        for n, block, k in TOPK_CASES + [(ROW_TOPK[0] * ROW_TOPK[1],
                                          *ROW_TOPK[1:])]:
            topk_case(n, block, k, kind)
    row = torch.tensor([5.0, -5.0, 3.0, 1.0, 0.5, -0.25, 0.125, 0.0],
                       device=dev)
    kept, _ = tk.topk_sparsify(row[None], 2)
    check(kept[0, :4].tolist() == [5.0, -5.0, 3.0, 0.0],
          f"topk_sparsify keeps {kept[0].tolist()} of the tie row (want the "
          "distinct-magnitude threshold 3)")
    # max_abs_err of each kernel's row: its full-width "normal" case
    full_rel, full_abs, deq_abs = onebit_case(n_onebit, scfg.block, "normal")
    onebit_case(n_onebit, scfg.block, "tied")
    topk_abs, select_abs = topk_case(n_topk, scfg.topk_block, scfg.k,
                                     "normal")
    topk_case(n_topk, scfg.topk_block, scfg.k, "tied")
    print(f"[kernels] compression: {2 * len(ONEBIT_CASES) + 2} onebit and "
          f"{2 * len(TOPK_CASES) + 4} topk cases, sparsify and select "
          f"(normal and tied values, the cf_user rows {ROW_TOPK}, full "
          f"width N={n_onebit:,} / {n_topk:,}) equal the plain versions "
          f"(bytes, kept, residual, indices, values, sent residual exact; "
          f"scales within {max(worst, full_rel):.3g} relative, tolerance "
          f"{SCALE_RTOL}); the tie row keeps [5, -5, 3]")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g2d = (inp.randn(n_onebit, dtype=torch.float32) * 1e-3).reshape(8, -1)
    packed, scales = gc.onebit_quantize(g2d, scfg.block)
    x2d = inp.randn(n_topk, dtype=torch.float32).reshape(-1, scfg.topk_block)
    rows2d = inp.randn(ROW_TOPK[0] * ROW_TOPK[1], dtype=torch.float32
                       ).reshape(ROW_TOPK[:2])
    n1, nb = n_onebit, n_onebit // (8 * scfg.block)
    n_rows = rows2d.numel()

    def glue(x2d, k):
        """What the select entry replaced in the sync: the sparsifier,
        then k picked from |kept| with one int64 key an element, a gather,
        a scatter into zeros and the subtraction."""
        kept, _ = tk.topk_sparsify(x2d, k)
        block = x2d.shape[1]
        bits = kept.abs().view(torch.int32).to(torch.int64)
        rev = block - 1 - torch.arange(block, device=dev)
        idx = torch.topk((bits << 32) | rev, k, dim=-1).indices
        vals = torch.gather(kept, -1, idx)
        sent = torch.zeros_like(kept).scatter_(-1, idx, vals)
        return idx.to(torch.int32), vals, x2d - sent
    rows = {
        "onebit_quantize": (
            lambda: gc.onebit_quantize(g2d, scfg.block),
            lambda: ref.onebit_quantize(g2d, scfg.block), None,
            4 * n1 + n1 // 8 + 4 * nb, 2 * n1, full_abs, SCALE_RTOL,
            f"(8, {n1 // 8:,}) f32 -> u8 + {nb:,} scales, block "
            f"{scfg.block}"),
        "onebit_dequantize": (
            lambda: gc.onebit_dequantize(packed, scales, scfg.block),
            lambda: ref.onebit_dequantize(packed, scales, scfg.block), None,
            n1 // 8 + 4 * nb + 4 * n1, n1, deq_abs, 0.0,
            f"({n1 // 8:,},) u8 + {nb:,} scales -> (8, {n1 // 8:,}) f32, "
            "one payload"),
        "topk_sparsify": (
            lambda: tk.topk_sparsify(x2d, scfg.k),
            lambda: ref.topk_sparsify_rounds(x2d, scfg.k), None,
            12 * n_topk, scfg.k * n_topk, topk_abs, 0.0,
            f"({n_topk // scfg.topk_block:,}, {scfg.topk_block}) f32, "
            f"k={scfg.k}"),
        # read 4 bytes an element, write the sent residual (4) and k
        # (index, value) pairs a row; k compares an element at most
        "topk_select": (
            lambda: tk.topk_select(x2d, scfg.k),
            lambda: ref.topk_select(x2d, scfg.k),
            lambda: torch.topk(x2d.abs(), scfg.k, dim=-1),
            8 * n_topk + 8 * scfg.k * (n_topk // scfg.topk_block),
            scfg.k * n_topk, select_abs, 0.0,
            f"({n_topk // scfg.topk_block:,}, {scfg.topk_block}) f32, "
            f"k={scfg.k}"),
    }
    # tol: the scales' relative tolerance for quantize (its bytes are
    # exact); dequantize and top-k are held exactly
    for name, (fn, plain, lib, nbytes, ops, err, tol, shape) in rows.items():
        t = {"shape": shape, "max_abs_err": err, "tol": tol,
             "ms": _time_ms(torch, fn, flush),
             "plain_ms": _time_ms(torch, plain, flush),
             "library_ms": (_time_ms(torch, lib, flush) if lib is not None
                            else None),
             "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "ops_ms": ops / F32_OPS_PER_S * 1e3}
        if lib is None:
            t["library_note"] = NO_LIBRARY[name]
        else:
            t["library_note"] = "torch.topk over |x| (indices and values)"
            t["glue_ms"] = _time_ms(torch, lambda: glue(x2d, scfg.k), flush)
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations")
        report["timing"][name] = [t]
        lib_s = (f"torch.topk {t['library_ms']:.4f} ms, the glue it "
                 f"replaced {t['glue_ms']:.4f} ms" if lib is not None
                 else "no library call")
        print(f"[time {name}] {shape}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, {lib_s}, bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}), max abs err "
              f"{err:.3g}")
    report_gate("topk_sparsify", report["timing"]["topk_sparsify"][0]["ms"],
                None, None, TOPK_GATE_MS)
    sel = report["timing"]["topk_select"][0]
    report_gate("topk_select", sel["ms"], sel["library_ms"], "torch.topk",
                round(sel["glue_ms"], 4), "the glue it replaced")
    # the row compressor's shape (the topk_embed run's second launch)
    t = {"shape": f"{ROW_TOPK[:2]} f32, k={ROW_TOPK[2]} (cf_user rows)",
         "max_abs_err": 0.0, "tol": 0.0,
         "ms": _time_ms(torch, lambda: tk.topk_sparsify(rows2d, ROW_TOPK[2]),
                        flush),
         "plain_ms": _time_ms(torch, lambda: ref.topk_sparsify_rounds(
             rows2d, ROW_TOPK[2]), flush),
         "library_ms": None, "library_note": NO_LIBRARY["topk_sparsify"],
         "bytes_ms": 12 * n_rows / HBM_BYTES_PER_S * 1e3,
         "ops_ms": ROW_TOPK[2] * n_rows / F32_OPS_PER_S * 1e3}
    t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
    t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
    report["timing"]["topk_sparsify"].append(t)
    print(f"[time topk_sparsify] {t['shape']}: kernel {t['ms']:.4f} ms, "
          f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.3g} ms "
          f"({t['bound_by']})")
    return report


# -- sparse-embedding sync and the fused optimizer (training) ----------------

# the cases of tests/test_torch_embed.py: gather (rows, dim, n ids), in f32
# and bf16, plus a 3-wide bf16 row (6 bytes: the byte-wise copy);
# scatter (n, dim, n_rows)
GATHER_CASES = [(64, 16, 40), (128, 32, 48), (16, 8, 12), (100, 3, 7)]
SCATTER_CASES = [(24, 16, 8), (48, 32, 64), (1000, 64, 5),
                 (5000, 16, 7),     # more ids than one staged chunk (256)
                 (300, 6, 1000),    # D = 6: rows straddle the 4096-float slabs
                 (0, 64, 40)]       # no ids: zeros
# fused AdamW: tests/test_kernels.py's sizes, the shape the Pallas
# kernel's tiling rejects, cf_item and embed at full width
ADAMW_NS = [8 * 2048, 8 * 4096, 17_408, 4_034_560, 48_414_720]
ADAMW_ATOL, ADAMW_RTOL = 1e-6, 1e-5      # tests/test_kernels.py:172
ADAMW_KW = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
ADAMW_FLOPS = 12         # per element; far below the byte bound


def _adamw_err(got, want):
    """(max |a - b| over p', m', v', whether every element is within
    ADAMW_ATOL + ADAMW_RTOL |b|)."""
    worst, ok = 0.0, True
    for a, b in zip(got, want):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        ok &= bool((d <= ADAMW_ATOL + ADAMW_RTOL * b.abs()).all())
    return worst, ok


def phase_embed_kernels(torch, report):
    """gather_rows, scatter_add_rows and adamw_update against their plain
    versions, at the CPU tests' sizes and at the training path's shapes,
    then timed there; rows added to ``report["timing"]``."""
    from repro_torch.embeddings import dedup_lookup, update
    from repro_torch.kernels import embedding_ops as eo
    from repro_torch.kernels import fused_adamw as fa
    from repro_torch.kernels import ref
    inp = Inputs(torch)
    dev = inp.dev
    _, n_users = train_config()

    def ids(n, rows):
        return torch.randint(0, rows, (n,), generator=inp.gen, device=dev,
                             dtype=torch.int32)

    # gather: exact, f32 and bf16, then the path's (192,403, 64) f32 table
    # with a batch's 32 user ids (what sparse_row_sync gathers)
    for rows, dim, n in GATHER_CASES:
        for dt in (torch.float32, torch.bfloat16):
            t, i = inp.randn(rows, dim, dtype=dt), ids(n, rows)
            check(torch.equal(eo.gather_rows(t, i), ref.gather_rows(t, i)),
                  f"gather_rows ({rows}, {dim}) {dt} n={n}: differs from "
                  "the plain version")
    table = inp.randn(n_users, 64, dtype=torch.float32)
    users = ids(TRAIN_BATCH, n_users)
    users[TRAIN_BATCH // 2:] = users[:TRAIN_BATCH // 2]      # repeats
    u = update.rows_touched(users, n_users)
    gidx = torch.clamp(u, 0, n_users - 1)
    check(torch.equal(eo.gather_rows(table, gidx),
                      ref.gather_rows(table, gidx)),
          "gather_rows at the path's shape differs from the plain version")
    check(torch.equal(dedup_lookup(table, users.reshape(4, -1),
                                   use_kernel=True),
                      table[users.long()].reshape(4, -1, 64)),
          "dedup_lookup(use_kernel=True) differs from the direct gather")

    # scatter, bit-equal to the plain version: heavy duplicates, more ids
    # than a chunk, D = 6, no ids, ids on both sides of a slab border, the
    # sentinel dump row, the path's shape
    scatter_errs = []

    def scatter_case(x, idx, n_rows, what):
        got = eo.scatter_add_rows(x, idx, n_rows)
        want = ref.scatter_add_rows(x, idx, n_rows)
        err = float((got - want).abs().max()) if want.numel() else 0.0
        check(bool(torch.equal(got, want)), f"scatter_add_rows {what}: "
              f"differs from the plain version (max abs {err})")
        scatter_errs.append(err)
        return err

    for n, dim, n_rows in SCATTER_CASES:
        scatter_case(inp.randn(n, dim, dtype=torch.float32), ids(n, n_rows),
                     n_rows, f"({n}, {dim}) -> {n_rows}")
    # a slab holds 4096 floats: rows 63 | 64 at D = 64; rows 682 and 1365
    # split between two slabs at D = 6; each id three times, out of order
    for dim, n_rows, border in (
            (64, 200, [62, 63, 64, 65, 127, 128, 0, 199]),
            (6, 1400, [681, 682, 683, 1364, 1365, 1366, 0, 1399])):
        edge = inp.ints(border * 3)
        scatter_case(inp.randn(edge.shape[0], dim, dtype=torch.float32),
                     edge, n_rows, f"D={dim} across slab borders")
    sent = ids(10, 10)
    sent[::3] = 9                          # the dump row of a 9-row table
    scatter_case(inp.randn(10, 16, dtype=torch.float32), sent, 10,
                 "onto the dump row")
    scatter_case(inp.randn(300, 64, dtype=torch.float32),
                 torch.full((300,), 40, dtype=torch.int32, device=dev), 41,
                 "every id on the dump row")
    sidx = torch.clamp(u, max=n_users)     # scatter_rows' ids
    srows = inp.randn(u.shape[0], 64, dtype=torch.float32)
    scat_err = scatter_case(srows, sidx, n_users + 1, "at the path's shape")
    # one call, one CUDA kernel (no sort, no separate zero-fill)
    scat_kernels = _device_time(
        torch, lambda: eo.scatter_add_rows(srows, sidx, n_users + 1))
    check(sum(c for _, c in scat_kernels.values()) == 1,
          f"scatter_add_rows at the path's shape ran {scat_kernels}, want "
          "one kernel")

    # fused AdamW after 3 steps of bias correction; lr and the
    # corrections as device scalars, as the optimizer passes them
    step = 3
    bc1, bc2 = 1 - 0.9 ** step, 1 - 0.95 ** step
    lr = 1e-3
    hyper = fa.hyper(torch.tensor(lr, device=dev),
                     torch.tensor(bc1, device=dev),
                     torch.tensor(bc2, device=dev), device=dev, **ADAMW_KW)
    adamw_errs = {}
    for N in ADAMW_NS:
        p_, g_, m_ = (inp.randn(N, dtype=torch.float32) for _ in range(3))
        v_ = inp.randn(N, dtype=torch.float32).abs()
        err, ok = _adamw_err(fa.adamw_update(p_, g_, m_, v_, hyper),
                             ref.adamw_update(p_, g_, m_, v_, lr=lr,
                                              bc1=bc1, bc2=bc2, **ADAMW_KW))
        check(ok, f"adamw_update N={N}: beyond atol {ADAMW_ATOL} + rtol "
                  f"{ADAMW_RTOL} of the plain version (max abs {err})")
        adamw_errs[N] = err
    print(f"[kernels] embedding: {2 * len(GATHER_CASES) + 1} gather cases "
          f"(f32, bf16, the path's ({n_users:,}, 64) f32) and the kernel "
          f"dedup lookup equal the plain versions; "
          f"{len(scatter_errs)} scatter cases bit-equal, one CUDA kernel a "
          f"call; adamw_update at N in {ADAMW_NS} within atol "
          f"{ADAMW_ATOL} + rtol {ADAMW_RTOL} "
          f"(max abs " + ", ".join(f"{e:.3g}" for e in adamw_errs.values())
          + ")")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    n, D = gidx.shape[0], 64
    N = ADAMW_NS[-1]
    p_, g_, m_ = (inp.randn(N, dtype=torch.float32) for _ in range(3))
    v_ = inp.randn(N, dtype=torch.float32).abs()
    lib_state = [x.clone() for x in (p_, g_, m_, v_)]
    lib_step = torch.tensor(float(step), device=dev)
    library_adamw, adamw_note = None, None
    if hasattr(torch, "_fused_adamw_"):
        def library_adamw():
            pl, gl, ml, vl = lib_state
            torch._fused_adamw_([pl], [gl], [ml], [vl], [], [lib_step],
                                lr=lr, beta1=ADAMW_KW["b1"],
                                beta2=ADAMW_KW["b2"],
                                weight_decay=ADAMW_KW["wd"],
                                eps=ADAMW_KW["eps"], amsgrad=False,
                                maximize=False)
    else:
        adamw_note = "this torch has no torch._fused_adamw_"
    sidx_long = sidx.long()
    rows = {
        "gather_rows": (
            lambda: eo.gather_rows(table, gidx),
            lambda: ref.gather_rows(table, gidx),
            lambda: torch.index_select(table, 0, gidx),
            2 * n * D * 4, 0, 0.0, 0.0,
            f"({n_users:,}, {D}) f32 table, {n} ids (a batch's unique "
            "users, sentinel-padded and clamped)", None),
        "scatter_add_rows": (
            lambda: eo.scatter_add_rows(srows, sidx, n_users + 1),
            lambda: ref.scatter_add_rows(srows, sidx, n_users + 1),
            lambda: torch.zeros((n_users + 1, D), device=dev).index_add_(
                0, sidx_long, srows),
            4 * (n * D + (n_users + 1) * D), n * D, scat_err, 0.0,
            f"({n}, {D}) f32 rows -> ({n_users + 1:,}, {D}), the dump row "
            "included; wrapper time (one kernel: slab sums and the write)",
            None),
        "adamw_update": (
            lambda: fa.adamw_update(p_, g_, m_, v_, hyper),
            lambda: ref.adamw_update(p_, g_, m_, v_, lr=lr, bc1=bc1,
                                     bc2=bc2, **ADAMW_KW),
            library_adamw, 28 * N, ADAMW_FLOPS * N, adamw_errs[N],
            ADAMW_RTOL, f"({N:,},) f32 (the embed leaf), 7 streams",
            adamw_note),
    }
    for name, (fn, plain, lib, nbytes, ops, err, tol, shape,
               note) in rows.items():
        t = {"shape": shape, "max_abs_err": err, "tol": tol,
             "ms": _time_ms(torch, fn, flush),
             "plain_ms": _time_ms(torch, plain, flush),
             "library_ms": (_time_ms(torch, lib, flush)
                            if lib is not None else None),
             "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "ops_ms": ops / F32_OPS_PER_S * 1e3}
        if note:
            t["library_note"] = note
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations")
        report["timing"][name] = [t]
        if name == "scatter_add_rows":
            report_gate(name, t["ms"], t["library_ms"],
                        "zero-fill + index_add_")
        lib_s = (f"library {t['library_ms']:.4f} ms"
                 if t["library_ms"] is not None else "no library call")
        print(f"[time {name}] {shape}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, {lib_s}, bound {t['bound_ms']:.3g} "
              f"ms ({t['bound_by']}), max abs err {err:.3g}")
    # the gather against index_select, one call of each in turn: the two
    # sit at a launch's floor, where the means above cannot rank them
    turns = _time_in_turns(torch, {
        "gather_rows": lambda: eo.gather_rows(table, gidx),
        "index_select": lambda: torch.index_select(table, 0, gidx)}, flush)
    spread = {}
    for name, v in turns.items():
        c = len(v)
        spread[name] = {"median_ms": (v[(c - 1) // 2] + v[c // 2]) / 2,
                        "q1_ms": v[c // 4], "q3_ms": v[(3 * c) // 4],
                        "min_ms": v[0], "max_ms": v[-1], "calls": c}
    report["timing"]["gather_rows"][0]["in_turns"] = spread
    print("[time gather_rows] in turns with index_select, "
          f"{spread['gather_rows']['calls']} calls each: " + "; ".join(
              f"{name} median {d['median_ms']:.4f} ms (quartiles "
              f"{d['q1_ms']:.4f}-{d['q3_ms']:.4f}, range {d['min_ms']:.4f}-"
              f"{d['max_ms']:.4f})" for name, d in spread.items()))
    return report


# -- MoE router ---------------------------------------------------------------

# (T, E, k): decode (T = 8 slots) and prompt-bucket shapes of Moonlight
# (64 experts, top 6) and Qwen3 (128, top 8), a large batch, the smallest
ROUTER_CASES = [(8, 64, 6), (64, 64, 6), (4096, 64, 6), (8, 128, 8),
                (1000, 128, 8), (1, 8, 2)]
ROUTER_TIMED = [(8, 64, 6), (64, 64, 6), (4096, 64, 6), (8, 128, 8)]
ROUTER_TOL = 1e-6        # probs and gates, absolute; idx exact off near-ties
ROUTER_TIE_GAP = 1e-6    # top k + 1 probs this close may order either way


def router_inputs(torch, inp, T, E, k):
    """Seeded (T, E) f32 logits; with T >= 3, row 0 all equal (experts
    0..k-1, gates 1/k) and row 1 with three equal maxima."""
    x = inp.randn(T, E, dtype=torch.float32)
    if T >= 3:
        x[0] = 0.25
        x[1, [3, E - 2, E // 2]] = float(x[1].max()) + 1.0
    return x


def phase_router_kernel(torch, report):
    """moe_router against its plain version at the MoE serving shapes, the
    tie rows included, then timed; rows added to ``report["timing"]``."""
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref
    inp = Inputs(torch)
    errs, near_ties = {}, 0
    for T, E, k in ROUTER_CASES:
        x = router_inputs(torch, inp, T, E, k)
        (g, i, p), (pg, pi, pp) = mr.moe_router(x, k), ref.moe_router(x, k)
        err = max(_max_err(p, pp), _max_err(g, pg))
        check(err <= ROUTER_TOL, f"moe_router ({T}, {E}, {k}): probs or "
              f"gates {err} from the plain version > {ROUTER_TOL}")
        # rows whose top k + 1 plain probs hold two within the tie gap may
        # order those experts either way; every other row must match
        top = torch.topk(pp, min(k + 1, E), dim=-1).values
        tied = (top[:, :-1] - top[:, 1:] < ROUTER_TIE_GAP).any(-1)
        differ = (i != pi).any(-1)
        check(not bool((differ & ~tied).any()),
              f"moe_router ({T}, {E}, {k}): indices differ from the plain "
              f"version on {int((differ & ~tied).sum())} rows without a "
              "near-tie")
        near_ties += int((differ & tied).sum())
        if T >= 3:
            check(i[0].tolist() == list(range(k))
                  and bool(torch.allclose(g[0], torch.full_like(g[0], 1 / k),
                                          atol=ROUTER_TOL, rtol=0))
                  and i[1, :3].tolist() == [3, E // 2, E - 2][:k],
                  f"moe_router ({T}, {E}, {k}): tie rows {i[:2].tolist()}")
        errs[(T, E, k)] = err
    print(f"[kernels] moe_router: {len(ROUTER_CASES)} cases (T, E, k) in "
          f"{ROUTER_CASES} within {ROUTER_TOL} of the plain version (worst "
          f"{max(errs.values()):.3g}); equal-logit rows give experts "
          f"0..k-1 with gates 1/k, duplicated maxima the lowest index first;"
          f" rows whose indices differ at a near-tie: {near_ties}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=inp.dev)
    rows = []
    for T, E, k in ROUTER_TIMED:
        x = router_inputs(torch, inp, T, E, k)

        def library(x=x, k=k):
            p = torch.softmax(x, dim=-1)
            v, i = torch.topk(p, k, dim=-1)
            return v / torch.clamp(v.sum(-1, keepdim=True), min=1e-9), i, p

        t = {"shape": f"T={T} E={E} k={k} f32 logits"
                      + (" (decode: one row a slot)" if T == 8 else ""),
             "max_abs_err": errs[(T, E, k)],
             "tol": ROUTER_TOL,
             "ms": _time_ms(torch, lambda: mr.moe_router(x, k), flush),
             "plain_ms": _time_ms(torch, lambda: ref.moe_router(x, k),
                                  flush),
             "library_ms": _time_ms(torch, library, flush),
             "library_note": "torch.softmax -> torch.topk -> normalise",
             "bytes_ms": (2 * T * E * 4 + T * k * 8) / HBM_BYTES_PER_S * 1e3,
             "ops_ms": T * E * (4 + 2 * k) / F32_OPS_PER_S * 1e3}
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations")
        rows.append(t)
        print(f"[time moe_router] {t['shape']}: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, softmax + topk "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.3g} ms "
              f"({t['bound_by']}), max abs err {t['max_abs_err']:.3g}")
    report["timing"]["moe_router"] = rows
    report["router_near_tie_rows"] = near_ties
    return route_cases(torch, inp, flush, report)


# (g, G, E, k, capacity factor or C, dead share, dtype): Moonlight's decode
# (a group a slot) and prompt buckets, a long prefill (16 groups of 256),
# Qwen3's E 128 / k 8 at decode and a bucket, capacity 0.5 (drops), half
# the tokens dead, the reduced archs' 1024-token group, and a C of 5 that
# no 16-byte vector divides (rows written an element at a time)
ROUTE_CASES = [(8, 1, 64, 6, 1.25, 0.0, "bfloat16"),
               (1, 24, 64, 6, 1.25, 0.0, "bfloat16"),
               (1, 64, 64, 6, 1.25, 0.0, "bfloat16"),
               (16, 256, 64, 6, 1.25, 0.0, "bfloat16"),
               (8, 1, 128, 8, 1.25, 0.0, "bfloat16"),
               (40, 1, 64, 6, 1.25, 0.0, "bfloat16"),   # decode, > 32
               (64, 1, 128, 8, 1.25, 0.3, "bfloat16"),  # slots: 2 blocks
               (1, 64, 128, 8, 1.25, 0.0, "bfloat16"),
               (2, 64, 64, 6, 0.5, 0.0, "float32"),
               (2, 48, 64, 6, 1.25, 0.5, "bfloat16"),
               (1, 1024, 8, 2, 1.25, 0.3, "bfloat16"),
               (2, 40, 16, 4, 5, 0.2, "float16")]     # the first: main path


def route_inputs(torch, inp, g, G, E, dead):
    """Seeded (g, G, E) f32 logits with a per-expert skew (hot experts
    overflow their queues), token 0 of group 0 all equal (experts 0..k-1),
    and a live mask with ``dead`` of the tokens out (None when 0)."""
    x = inp.randn(g, G, E, dtype=torch.float32) \
        + 1.5 * inp.randn(E, dtype=torch.float32)
    x[0, 0] = 0.25
    live = None
    if dead:
        live = torch.rand((g, G), generator=inp.gen, device=inp.dev) >= dead
    return x, live


def route_bytes(g, G, E, k, C, esz, live):
    """Bytes the route must move: the logits (and live mask) read once, and
    gates, idx, places, probs, dispatch, combine, loads and top-1 shares
    written once."""
    return (g * G * E * 4 + (g * G if live is not None else 0)
            + 3 * g * G * k * 4 + g * G * E * 4 + 2 * g * G * E * C * esz
            + 2 * E * 4)


def route_cases(torch, inp, flush, report):
    """moe_route on the card: routing bit-identical to moe_router's on the
    same logits; places, dispatch, combine, loads bit-equal to the plain
    capacity dispatch fed that routing; against the whole plain version
    (its own router), gates and probs within ROUTER_TOL, and idx, places,
    dispatch and loads equal where no row holds a near-tie.  Each case
    then timed behind the spin beside the plain version, the design it
    replaced (the router kernel, then the plain dispatch) and an empty
    kernel."""
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref
    from repro_torch.models.moe import _capacity

    def router_then_dispatch(x, k, C, live, dt):
        g, G, E = x.shape
        gates, idx, probs = mr.moe_router(x.reshape(-1, E), k)
        return ref.moe_dispatch(gates.reshape(g, G, k), idx.reshape(g, G, k),
                                probs.reshape(g, G, E), C, live, dt)

    errs, drops, tied_cases, rows = [], [], 0, []
    floor_ms = _time_ms(torch, lambda: torch.cuda._sleep(0), flush)
    for g, G, E, k, cap, dead, dname in ROUTE_CASES:
        C = cap if isinstance(cap, int) else _capacity(G, k, E, cap)
        dt = getattr(torch, dname)
        x, live = route_inputs(torch, inp, g, G, E, dead)
        case = f"moe_route (g={g}, G={G}, E={E}, k={k}, C={C}, {dname})"
        r = mr.moe_route(x, k, C, live, dt)
        rg, ri, rp = mr.moe_router(x.reshape(-1, E), k)
        check(torch.equal(r.gates.reshape(-1, k), rg)
              and torch.equal(r.idx.reshape(-1, k), ri)
              and torch.equal(r.probs.reshape(-1, E), rp),
              f"{case}: gates, idx or probs differ from moe_router's")
        want = ref.moe_dispatch(r.gates, r.idx, r.probs, C, live, dt)
        for name in ("place", "dispatch", "combine", "load"):
            check(torch.equal(getattr(r, name), getattr(want, name)),
                  f"{case}: {name} differs from the plain dispatch of the "
                  "same routing")
        check(_max_err(r.top1, want.top1) <= 1e-6,
              f"{case}: top-1 shares differ from the plain dispatch's")
        ticket = mr._ticket(x.device, torch.cuda.current_stream().cuda_stream)
        check(int(ticket[0]) == 0, f"{case}: the ticket reads "
              f"{int(ticket[0])} after the launch, not 0")
        check(r.idx[0, 0].tolist() == list(range(k)),
              f"{case}: the equal-logit row routes to {r.idx[0, 0].tolist()}")
        plain = ref.moe_route(x, k, C, live, dt)
        err = max(_max_err(r.gates, plain.gates),
                  _max_err(r.probs, plain.probs))
        check(err <= ROUTER_TOL, f"{case}: gates or probs {err} from the "
              f"plain version > {ROUTER_TOL}")
        top = torch.topk(plain.probs, min(k + 1, E), dim=-1).values
        near = (top[..., :-1] - top[..., 1:] < ROUTER_TIE_GAP).any(-1)
        near[0, 0] = False           # the equal-logit row: an exact tie
        if bool(near.any()):
            tied_cases += 1          # a near-tie may reorder experts
        else:
            for name in ("idx", "place", "dispatch", "load"):
                check(torch.equal(getattr(r, name),
                                  getattr(plain, name).to(
                                      getattr(r, name).dtype)),
                      f"{case}: {name} differs from the plain version")
            cerr = _max_err(r.combine, plain.combine)
            check(cerr <= ROUTER_TOL + torch.finfo(dt).eps,
                  f"{case}: combine {cerr} from the plain version")
        alive = (torch.ones((g, G), dtype=torch.bool, device=inp.dev)
                 if live is None else live)
        drops.append(int(((r.place >= C) & alive[..., None]).sum()))
        errs.append(err)
        esz = torch.empty((), dtype=dt).element_size()
        t = {"shape": f"g={g} G={G} E={E} k={k} C={C} {dname}"
                      + (f", {dead:.0%} dead" if dead else "")
                      + (" (decode: a group a slot)" if G == 1 else "")
                      + "; wrapper time, one launch",
             "max_abs_err": err, "tol": ROUTER_TOL,
             "ms": _time_ms(torch, lambda: mr.moe_route(x, k, C, live, dt),
                            flush),
             "plain_ms": _time_ms(
                 torch, lambda: ref.moe_route(x, k, C, live, dt), flush),
             "router_dispatch_ms": _time_ms(
                 torch, lambda: router_then_dispatch(x, k, C, live, dt),
                 flush),
             "library_ms": None, "library_note": NO_LIBRARY["moe_route"],
             "floor_ms": floor_ms,
             "bytes": route_bytes(g, G, E, k, C, esz, live),
             "ops_ms": g * G * E * (4 + 2 * k) / F32_OPS_PER_S * 1e3}
        t["bytes_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations")
        rows.append(t)
        print(f"[time moe_route] {t['shape']}: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, the router kernel + plain "
              f"dispatch {t['router_dispatch_ms']:.4f} ms, an empty kernel "
              f"{floor_ms:.4f} ms, bound {t['bound_ms']:.3g} ms "
              f"({t['bound_by']}: {t['bytes']:,} bytes)")
        report_gate(f"moe_route G={G} g={g}", t["ms"], None, None,
                    round(t["router_dispatch_ms"], 4),
                    "the router kernel + dispatch")
    print(f"[kernels] moe_route: {len(ROUTE_CASES)} cases (g, G, E, k, "
          f"capacity, dead share, dtype) in {ROUTE_CASES}: gates, idx and "
          "probs bit-identical to moe_router's; places, dispatch, combine "
          "and loads bit-equal to the plain dispatch of that routing; gates "
          f"and probs within {ROUTER_TOL} of the plain version (worst "
          f"{max(errs):.3g}), idx, places, dispatch and loads equal to it "
          f"in every case without a near-tie ({tied_cases} with one); "
          f"(token, slot) pairs dropped at the capacity: {drops}")
    report["timing"]["moe_route"] = rows
    report["route_drops"] = drops
    return report


# (B, H, T, hs, chunk): the cases of tests/test_kernels.py (the JAX
# kernel's), then rwkv6-1.6b's serving prefill (48 tokens, chunk
# gcd(32, 48) = 16) and a long prompt
WKV_CASES = [(2, 2, 64, 16, 16), (1, 4, 32, 8, 8), (2, 1, 96, 32, 32),
             (3, 5, 64, 64, 32),      # B * H = 15: no column tile divides it
             (1, 2, 1056, 64, 32)]    # 33 tiles: a carry segment of one
# transposed (B, T, H, hs) views, as the model passes them: one chunk
# record stream of 16-token tiles, one of 32 with a ragged last tile
WKV_VIEWS = [(1, 32, 48, 64, 16), (2, 4, 80, 64, 16)]
WKV_TIMED = [(1, 32, 48, 64, 16), (1, 32, 4096, 64, 32)]
WKV_TOL = 2e-4           # of max(1, the largest |plain value|): float32 sums
                         # in other orders (the plain chunked version and the
                         # scan part by ~3e-6 of it at T = 4096)
WKV_PAD_LEN = 37         # true prompt length inside the 48-token serve shape


def wkv6_inputs(torch, inp, B, H, T, hs):
    """Seeded f32 streams as the JAX kernel test draws them: w = exp(-exp(2
    n - 2)) spans fast to slow decay; u = 0.1 n."""
    r, k, v = (inp.randn(B, H, T, hs, dtype=torch.float32) for _ in range(3))
    w = torch.exp(-torch.exp(inp.randn(B, H, T, hs, dtype=torch.float32)
                             * 2 - 2))
    return r, k, v, w, inp.randn(H, hs, dtype=torch.float32) * 0.1


def wkv6_work(B, H, T, hs, chunk):
    """(bytes, operations) of one call: r, k, v, w and u read once, o and
    the final state written once; per chunk of C and (b, h), the running
    log-decay sum (3 a value), the strictly causal pairs' exp-weighted dot
    (5 a channel: difference, clamp, exp, two products), the bonus (3),
    both decay factors (4), M v over s <= t (2 a term), the cross term and
    the state update (2 a term each) and the state decay (2)."""
    C, nc = chunk, T // chunk
    nbytes = (5 * B * H * T * hs + B * H * hs * hs + H * hs) * 4
    per_chunk = (3 * C * hs + 5 * C * (C - 1) // 2 * hs + 3 * C * hs
                 + 4 * C * hs + 2 * C * (C + 1) // 2 * hs
                 + 2 * C * hs * hs + 2 * C * hs * hs + 2 * hs * hs)
    return nbytes, B * H * nc * per_chunk


def phase_wkv6_kernel(torch, report):
    """wkv6_chunked against its plain version (the chunked recurrence) and
    the sequential scan: the JAX test cases and the tiles' edge cases, w =
    1e-6, transposed views read in place, pads frozen with w = 1 and k = 0,
    the final state; then timed at the serve and long shapes; rows added
    to ``report["timing"]``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk
    inp = Inputs(torch)
    errs = {}

    def held(what, got, plain):
        """max |got - plain| over max(1, max |plain|), checked."""
        e = _max_err(got, plain) / max(1.0, float(plain.abs().max()))
        check(e <= WKV_TOL, f"wkv6_chunked {what}: {e} of the largest value "
                            f"from the plain version > {WKV_TOL}")
        return e

    for B, H, T, hs, chunk in WKV_CASES + WKV_TIMED:
        r, k, v, w, u = wkv6_inputs(torch, inp, B, H, T, hs)
        for decay in (None, 1e-6):
            ww = w if decay is None else torch.full_like(w, decay)
            o, S = wk.wkv6_chunked(r, k, v, ww, u, chunk=chunk)
            check(bool(torch.isfinite(o).all() and torch.isfinite(S).all()),
                  f"wkv6_chunked {(B, H, T, hs, chunk)} w={decay}: "
                  "non-finite output")
            po, pS = ref.wkv6_chunked_state(r, k, v, ww, u, chunk)
            so, sS = ref.wkv6_scan(r, k, v, ww, u)
            key = (B, H, T, hs, chunk, decay)
            errs[key] = max(held(f"{key} o", o, po), held(f"{key} S", S, pS),
                            held(f"{key} o vs scan", o, so),
                            held(f"{key} S vs scan", S, sS))
    # the model's layout: transposed (B, T, H, hs) views, read through
    # their strides; the output comes back laid out as r
    for B, H, T, hs, chunk in WKV_VIEWS:
        *btsh, _ = wkv6_inputs(torch, inp, B, T, H, hs)
        r, k, v, w = (x.transpose(1, 2) for x in btsh)
        u = inp.randn(H, hs, dtype=torch.float32) * 0.1
        for decay in (None, 1e-6):
            ww = w if decay is None else torch.full_like(w, decay)
            o, S = wk.wkv6_chunked(r, k, v, ww, u, chunk=chunk)
            check(o.transpose(1, 2).is_contiguous(),
                  f"wkv6_chunked view {(B, H, T, hs)}: o strides "
                  f"{o.stride()}, not laid out as r {r.stride()}")
            dense = [x.contiguous() for x in (r, k, v, ww)]
            po, pS = ref.wkv6_chunked_state(*dense, u, chunk)
            so, sS = ref.wkv6_scan(*dense, u)
            key = ("view", B, H, T, hs, chunk, decay)
            errs[key] = max(held(f"{key} o", o, po), held(f"{key} S", S, pS),
                            held(f"{key} o vs scan", o, so),
                            held(f"{key} S vs scan", S, sS))
    # pads frozen (w = 1, k = 0 past the true length): the final state is
    # the unpadded prompt's, and the live outputs are unchanged
    B, H, T, hs, chunk = WKV_TIMED[0]
    r, k, v, w, u = wkv6_inputs(torch, inp, B, H, T, hs)
    w[:, :, WKV_PAD_LEN:] = 1.0
    k[:, :, WKV_PAD_LEN:] = 0.0
    o, S = wk.wkv6_chunked(r, k, v, w, u, chunk=chunk)
    cut = [x[:, :, :WKV_PAD_LEN].contiguous() for x in (r, k, v, w)]
    co, cS = ref.wkv6_scan(*cut, u)
    errs["pads"] = max(held("pads: S vs the unpadded prompt's", S, cS),
                       held("pads: live o", o[:, :, :WKV_PAD_LEN], co))
    print(f"[kernels] wkv6_chunked: {len(WKV_CASES + WKV_TIMED)} shapes "
          f"(B, H, T, hs, chunk) in {WKV_CASES + WKV_TIMED}, each with drawn "
          f"decays and with w = 1e-6, output and final state within "
          f"{WKV_TOL} of the largest value of the plain chunked version and "
          f"of the sequential scan, and transposed (B, T, H, hs) views "
          f"{WKV_VIEWS} read in place (worst {max(errs.values()):.3g}); pads "
          f"frozen past {WKV_PAD_LEN} of {T} tokens give the unpadded "
          f"prompt's state ({errs['pads']:.3g})")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=inp.dev)
    rows = []
    for B, H, T, hs, chunk in WKV_TIMED:
        r, k, v, w, u = wkv6_inputs(torch, inp, B, H, T, hs)
        plain = (lambda r=r, k=k, v=v, w=w, u=u, c=chunk:
                 ref.wkv6_chunked_state(r, k, v, w, u, c))
        scan = (lambda r=r, k=k, v=v, w=w, u=u: ref.wkv6_scan(r, k, v, w, u))
        nbytes, ops = wkv6_work(B, H, T, hs, chunk)
        (o, S), (po, pS) = wk.wkv6_chunked(r, k, v, w, u, chunk=chunk), plain()

        t = {"shape": f"B={B} H={H} T={T} hs={hs} chunk={chunk} f32"
                      + (" (rwkv6-1.6b's longest serve prefill)" if T == 48
                         else " (a long prompt)"),
             "max_abs_err": max(_max_err(o, po), _max_err(S, pS)),
             "largest_value": float(po.abs().max()),
             "rel_err_checked": errs[(B, H, T, hs, chunk, None)],
             "tol": WKV_TOL,
             "ms": _time_ms(torch, lambda: wk.wkv6_chunked(
                 r, k, v, w, u, chunk=chunk), flush),
             # the plain versions loop over chunks or tokens: hundreds to
             # tens of thousands of small launches, more than a spin can
             # hold queued, so their device time is the profiler's sum of
             # their kernels (the scan at T = 4096, ~0.6 s of host time a
             # call, once)
             "plain_ms": _profiled_ms(torch, plain, flush, 5),
             "scan_ms": _profiled_ms(torch, scan, flush,
                                     5 if T <= 48 else 1),
             "library_ms": None, "library_note": NO_LIBRARY["wkv6_chunked"],
             "bytes": nbytes, "operations": ops,
             "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "ops_ms": ops / F32_OPS_PER_S * 1e3}
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations")
        rows.append(t)
        print(f"[time wkv6_chunked] {t['shape']}: kernel {t['ms']:.4f} ms, "
              f"plain chunked {t['plain_ms']:.4f} ms, sequential scan "
              f"{t['scan_ms']:.4f} ms (both the profiler's kernel sum), no "
              f"library call, bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}: {nbytes:,} bytes, "
              f"{ops:,} operations), max abs err {t['max_abs_err']:.3g} "
              f"(largest value {t['largest_value']:.3g})")
    report["timing"]["wkv6_chunked"] = rows
    return report


# -- the WKV kernel in turns with another tree's ----------------------------

WKV_TURNS = 30           # timed calls of each timed shape, a probe
WKV_SERVE_RUNS = 3       # measured dense serve runs, a probe


def wkv6_probe(torch, root):
    """Measure the WKV kernel of the tree at ``root``, whose ``src`` goes
    first on the path: each ``WKV_TIMED`` shape behind the spin
    (``WKV_TURNS`` calls, L2 flushed), and rwkv6-1.6b's dense serve run
    with the kernel (as phase 5 runs it: ``WKV_SERVE_RUNS`` measured runs
    after a warm-up, TTFT and TPOT p50 each, then one profiled run: the
    device ms of every WKV call).  Uses only what every tree's package
    since the WKV kernel landed offers."""
    sys.path.insert(0, str(pathlib.Path(root).resolve() / "src"))
    from repro_torch import convert
    from repro_torch.config import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (EngineConfig, ServingEngine,
                                     TrafficConfig, generate, make_backend)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["wkv6"])
    dev = torch.device("cuda")
    inp = Inputs(torch)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {"root": str(root), "cold_ms": {}, "serve": []}
    for B, H, T, hs, chunk in WKV_TIMED:
        r, k, v, w, u = wkv6_inputs(torch, inp, B, H, T, hs)
        fn = (lambda r=r, k=k, v=v, w=w, u=u, c=chunk:
              wk.wkv6_chunked(r, k, v, w, u, chunk=c))
        out["cold_ms"][f"T={T}"] = _time_in_turns(
            torch, {"kernel": fn}, flush, WKV_TURNS)["kernel"]
    cfg = get_arch("rwkv6-1.6b")
    params = convert.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    requests = generate(TrafficConfig(n_requests=16,
                                      vocab_size=cfg.vocab_size, seed=0))
    ecfg = EngineConfig(n_slots=8, max_len=512)
    ctx = tf.ModelCtx(attn_chunk=8, use_kernels=True)

    def run():
        return ServingEngine(make_backend(cfg, params, ctx, device=dev),
                             ecfg).run(requests)

    run()                                   # warm-up
    for _ in range(WKV_SERVE_RUNS):
        summary = run()[2]
        out["serve"].append({"ttft_p50_ms": summary["ttft_s"]["p50"] * 1e3,
                             "tpot_p50_ms": summary["tpot_s"]["p50"] * 1e3})
    events = _device_events(torch, run)
    # this tree's two kernels, or the one-kernel design before them
    out["wkv_call_ms"] = max((_calls_ms(events, WKV_TAGS["wkv6_chunked"]),
                              _calls_ms(events, ("wkv6_kernel",))), key=len)
    return out


def _pooled_stats(xs):
    """Median, quartiles and count of the pooled figures of one tree."""
    import statistics
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return {"median": med, "q1": q1, "q3": q3, "n": len(xs)}


def wkv6_against(torch, other):
    """The WKV kernel of the tree at ``other`` and this tree's in turns,
    each measured by :func:`wkv6_probe` in a process of its own, in the
    order other, this, this, other; prints the medians and quartiles of
    the pooled figures of each tree."""
    runs = {"other": [], "this": []}
    for name, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--wkv6-probe",
             str(root)], capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0,
              f"wkv6 probe of {root} failed: {proc.stderr[-3000:]}")
        runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"[wkv6 turns] probe of {name} ({root}) done", flush=True)

    result = {}
    for name, probes in runs.items():
        pooled = {f"cold {key} ms": [x for p in probes
                                     for x in p["cold_ms"][key]]
                  for key in probes[0]["cold_ms"]}
        pooled["serve WKV device ms a call"] = [
            x for p in probes for x in p["wkv_call_ms"]]
        for key in ("ttft_p50_ms", "tpot_p50_ms"):
            pooled[f"serve {key}"] = [s[key] for p in probes
                                      for s in p["serve"]]
        result[name] = {key: _pooled_stats(xs)
                        for key, xs in pooled.items()}
    for key in result["this"]:
        a, b = result["other"][key], result["this"][key]
        print(f"[wkv6 turns] {key}: other tree median {a['median']:.5f} "
              f"(quartiles {a['q1']:.5f}-{a['q3']:.5f}, n {a['n']}), this "
              f"tree {b['median']:.5f} ({b['q1']:.5f}-{b['q3']:.5f}, n "
              f"{b['n']})")
    return result


# -- the MoE routing in turns with another tree's ----------------------------

MOE_SERVE_RUNS = 3       # measured Moonlight dense serve runs, a probe


@contextlib.contextmanager
def expert_marker(torch):
    """Within it, an empty kernel (``torch.cuda._sleep(0)``, a
    ``spin_kernel``) is queued just before each MoE FFN's first expert
    product, the einsum "gtec,gtd->egcd" with which ``moe_ffn`` starts its
    experts (in this tree and the earlier ones): in a trace a layer call's
    routing then lies between its router kernel's start and that marker."""
    orig = torch.einsum

    def einsum(eq, *operands, **kw):
        if eq.replace(" ", "") == "gtec,gtd->egcd":
            torch.cuda._sleep(0)
        return orig(eq, *operands, **kw)

    torch.einsum = einsum
    try:
        yield
    finally:
        torch.einsum = orig


def routing_ms(events):
    """Device ms of the routing of each MoE layer call in a trace taken
    under :func:`expert_marker`: the union of the intervals of the kernels
    from a router kernel's start (``moe_router_kernel`` in a tree before
    the route kernel, else ``moe_route_kernel`` or
    ``moe_route_decode_kernel``) up to the next marker (the route kernel
    alone, or the router kernel and the plain dispatch's kernels)."""
    out, cur = [], None
    for name, s, e in events:
        if "moe_route" in name:
            cur = [(s, e)]
        elif cur is not None and "spin_kernel" in name:
            out.append(_busy_ms(cur))
            cur = None
        elif cur is not None:
            cur.append((s, e))
    return out


def decode_step_kernels(torch, cfg, params, ctx, prompt, n_slots=8,
                        max_len=512):
    """(device kernels, device busy ms) of one decode step over ``n_slots``
    slots of a dense cache after ``prompt``'s prefill into slot 0, traced
    after a warm-up step."""
    from repro_torch.serving import make_backend
    dev = torch.device("cuda")
    be = make_backend(cfg, params, ctx, device=dev)
    cache = be.init_slots(n_slots, max_len)
    padded = list(prompt) + [0] * (-len(prompt) % 8)
    _, cache = be.prefill(cache, [padded], len(prompt), 0)
    nxt = torch.zeros((n_slots, 1), dtype=torch.long, device=dev)
    _, cache = be.decode(cache, nxt)
    torch.cuda.synchronize()
    events = _device_events(torch, lambda: be.decode(cache, nxt))
    return len(events), _busy_ms([(s, e) for _, s, e in events])


def moe_probe(torch, root):
    """Serve the MoE archs of phase 4 with the tree at ``root`` (its ``src``
    first on the path) and ``use_kernels``: the greedy streams of Moonlight
    under the dense, paged, int8 and paged int8 layouts and of Qwen3 dense;
    Moonlight dense's TTFT and TPOT p50 over ``MOE_SERVE_RUNS`` measured
    runs, the routing's device ms of every MoE layer call in one traced run
    (:func:`routing_ms`), its device busy share, and the device kernels of
    one decode step.  Uses only what every tree's package since the router
    kernel landed offers."""
    sys.path.insert(0, str(pathlib.Path(root).resolve() / "src"))
    from repro_torch import convert
    from repro_torch.config import get_arch
    from repro_torch.kernels import _build, ops
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (CacheLayout, EngineConfig,
                                     ServingEngine, TrafficConfig, generate,
                                     make_backend)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["moe_router", "flash_attention", "flash_decode"])
    dev = torch.device("cuda")
    ecfg = EngineConfig(n_slots=8, max_len=512)
    ctx = tf.ModelCtx(attn_impl="flash", decode_impl="flash", attn_chunk=8,
                      use_kernels=True)
    out = {"root": str(root), "fused": hasattr(ops, "moe_route"),
           "streams": {}, "serve": []}
    for short, arch, layers in MOE_SERVE:
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        params = convert.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        requests = generate(TrafficConfig(n_requests=16,
                                          vocab_size=cfg.vocab_size, seed=0))

        def run(layout=None):
            e = ecfg if layout is None else dataclasses.replace(
                ecfg, layout=layout)
            return ServingEngine(make_backend(cfg, params, ctx, layout=layout,
                                              device=dev), e).run(requests)

        layouts = [("dense", None)]
        if short == "moonlight":
            layouts += [(name, CacheLayout(impl="flash", **kw))
                        for name, (kw, _) in LAYOUTS.items()]
        for name, layout in layouts:
            outputs = run(layout)[0]
            out["streams"][f"{short}_{name}"] = {
                str(rid): list(toks) for rid, toks in outputs.items()}
        if short == "moonlight":
            for _ in range(MOE_SERVE_RUNS):
                t0 = time.perf_counter()
                summary = run()[2]
                out["serve"].append({
                    "ttft_p50_ms": summary["ttft_s"]["p50"] * 1e3,
                    "tpot_p50_ms": summary["tpot_s"]["p50"] * 1e3,
                    "wall_s": time.perf_counter() - t0})
            with expert_marker(torch):
                events = _device_events(torch, run)
            out["routing_ms"] = routing_ms(events)
            out["busy_share"] = (_busy_ms([(s, e) for _, s, e in events])
                                 / (out["serve"][-1]["wall_s"] * 1e3))
            out["decode_step_kernels"], out["decode_step_busy_ms"] = \
                decode_step_kernels(torch, cfg, params, ctx,
                                    requests[0].prompt)
        params = None
        torch.cuda.empty_cache()
    return out


def moe_against(torch, other):
    """The MoE routing of the tree at ``other`` and this tree's in turns,
    each measured by :func:`moe_probe` in a process of its own, in the
    order other, this, this, other; prints the medians and quartiles of the
    pooled figures of each tree and checks that every greedy stream of
    every probe equals the first probe's."""
    runs = {"other": [], "this": []}
    for name, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--moe-probe",
             str(root)], capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0,
              f"moe probe of {root} failed: {proc.stderr[-3000:]}")
        runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"[moe turns] probe of {name} ({root}) done", flush=True)
    first = runs["other"][0]["streams"]
    equal = {}
    for key, want in first.items():
        n_tok = sum(len(v) for v in want.values())
        for name, probes in runs.items():
            for probe in probes:
                got = {int(r): v for r, v in probe["streams"][key].items()}
                div = _first_divergence(
                    {int(r): v for r, v in want.items()}, got)
                check(div is None, f"{key}: the {name} tree's greedy "
                      f"stream differs from the other tree's at (rid, "
                      f"token) {div}")
        equal[key] = n_tok
    result = {"streams_equal": equal}
    for name, probes in runs.items():
        result[name] = {
            "fused": probes[0]["fused"],
            "routing device ms a MoE layer call": _pooled_stats(
                [x for p in probes for x in p["routing_ms"]]),
            "ttft_p50_ms": _pooled_stats(
                [s["ttft_p50_ms"] for p in probes for s in p["serve"]]),
            "tpot_p50_ms": _pooled_stats(
                [s["tpot_p50_ms"] for p in probes for s in p["serve"]]),
            "decode_step_kernels": [p["decode_step_kernels"]
                                    for p in probes],
            "decode_step_busy_ms": [p["decode_step_busy_ms"]
                                    for p in probes],
            "busy_share": [p["busy_share"] for p in probes]}
    for key in ("routing device ms a MoE layer call", "ttft_p50_ms",
                "tpot_p50_ms"):
        a, b = result["other"][key], result["this"][key]
        print(f"[moe turns] {key}: other tree median {a['median']:.5f} "
              f"(quartiles {a['q1']:.5f}-{a['q3']:.5f}, n {a['n']}), this "
              f"tree {b['median']:.5f} ({b['q1']:.5f}-{b['q3']:.5f}, n "
              f"{b['n']})")
    for key in ("decode_step_kernels", "decode_step_busy_ms", "busy_share"):
        print(f"[moe turns] {key}: other tree {result['other'][key]}, this "
              f"tree {result['this'][key]}")
    print("[moe turns] greedy streams, this tree == the other tree: "
          + ", ".join(f"{k} ({n} tokens)" for k, n in equal.items()))
    return result


def check_autograd_guard(torch):
    """Every kernel wrapper raises on the card when autograd would record
    the call (the kernels have no backward): a training caller gets an
    error, not outputs that silently carry no gradient."""
    from repro_torch.kernels import ref
    inp = Inputs(torch)
    calls = {k: cases[0][1](torch.float32)[::2]      # (fn, args)
             for k, cases in _case_builders(inp).items()}
    g = inp.randn(8 * 512, dtype=torch.float32)
    packed, scales = ref.onebit_quantize(g.reshape(8, -1), 512)
    x4 = g[:2048].reshape(1, 2, 64, 16)
    wrappers = _wrappers()
    calls.update({
        "onebit_quantize": (wrappers["onebit_quantize"], (g.reshape(8, -1),)),
        "onebit_dequantize": (wrappers["onebit_dequantize"],
                              (packed, scales)),
        "topk_sparsify": (wrappers["topk_sparsify"], (g.reshape(4, -1), 8)),
        "topk_select": (wrappers["topk_select"], (g.reshape(4, -1), 8)),
        "gather_rows": (wrappers["gather_rows"],
                        (g.reshape(64, -1), inp.ints([3, 1, 3]))),
        "scatter_add_rows": (wrappers["scatter_add_rows"],
                             (g.reshape(64, -1), inp.ints([0, 2] * 32), 4)),
        "adamw_update": (wrappers["adamw_update"], (g, g, g, g.abs(), g[:8])),
        "moe_router": (wrappers["moe_router"], (g.reshape(64, -1), 6)),
        "moe_route": (wrappers["moe_route"], (g.reshape(8, 8, -1), 6, 8)),
        "wkv6_chunked": (wrappers["wkv6_chunked"],
                         (x4, x4, x4, x4.sigmoid(), g[:32].reshape(2, 16)))})
    for name, (fn, args) in calls.items():
        leaf = args[0] if args[0].is_floating_point() else args[1]
        leaf.requires_grad_()
        try:
            fn(*args)
        except RuntimeError as e:
            check("no backward" in str(e), f"{name}: {e}")
        else:
            raise SmokeFailure(f"{name} ran on inputs that require grad")
        finally:
            leaf.requires_grad_(False)
    print(f"[kernels] all {len(calls)} wrappers raise on CUDA inputs that "
          "require grad (no backward kernels yet)")


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 32, 32
# (name, sync mode, use_kernel, step options) in the order they run, each
# from one init.  Options: "embed" -> EmbedSyncConfig(id_fns=
# embed_id_fns(), **embed), cf_user synced rows-touched; "adamw_kernel"
# -> the fused AdamW kernel.
TRAIN_RUNS = [("flat", "flat", True, {}),
              ("hierarchical", "hierarchical", True, {}),
              ("onebit", "onebit", True, {}), ("topk", "topk", True, {}),
              ("onebit_plain", "onebit", False, {}),
              ("topk_plain", "topk", False, {}),
              ("flat_embed", "flat", True, {"embed": {}}),
              ("flat_embed_plain", "flat", True,
               {"embed": {"use_kernel": False}}),
              ("flat_embed_zero", "flat", True,
               {"embed": {"zero_opt": True}}),
              ("topk_embed", "topk", True,
               {"embed": {"compress": "topk", "k": 8}}),
              ("flat_fused_adamw", "flat", True, {"adamw_kernel": True})]
# kernel launches per step each run's design implies: 1-bit quantizes the
# local gradient once and dequantizes the local and the gathered payloads
# in one launch each; top-k selects once (and sparsifies the exchanged
# cf_user rows under the row compressor); the rows-touched sync gathers
# the touched rows once and scatters the gathered ones once; the fused
# AdamW kernel takes the 11 leaves whose size is a multiple of 1024
# (FUSED_LEAVES); the other runs launch nothing
EMBED_LAUNCHES = {"gather_rows": 1, "scatter_add_rows": 1}
FUSED_LEAVES, FUSED_FLOATS = 11, 165_713_920
TRAIN_LAUNCHES = {"onebit": {"onebit_quantize": 1, "onebit_dequantize": 2},
                  "topk": {"topk_select": 1},
                  "flat_embed": EMBED_LAUNCHES,
                  "flat_embed_zero": EMBED_LAUNCHES,
                  "topk_embed": {"topk_select": 1, "topk_sparsify": 1,
                                 **EMBED_LAUNCHES},
                  "flat_fused_adamw": {"adamw_update": FUSED_LEAVES}}
# On one rank the rows-touched sync is the dense gradient, so these runs
# must give flat's losses bit for bit; zero_opt's clip sums the squares
# in another order, so it is held within ZERO_RTOL of flat (the JAX
# package's own check of it)
EQUAL_TO_FLAT = ("flat_embed", "flat_embed_plain")
ZERO_RTOL = 1e-4
EMBED_ROW_BYTES = 64 * 4 + 4       # one exchanged row and its int32 id
TRAJ_EQUAL = ("topk",)


def phase_training(torch):
    import math

    import torch.distributed as dist
    from repro_torch.config import TrainConfig
    from repro_torch.core import compression, hierarchical
    from repro_torch.models.transformer import ModelCtx
    from repro_torch.optimizer import adamw
    from repro_torch.recsys import dataset, metrics, model as recmodel
    from repro_torch.runtime import trainer
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ds = dataset.generate(scale=1.0, seed=0)
    cfg, n_users = train_config()
    check((ds.n_users, ds.n_items + 3) == (n_users, cfg.vocab_size),
          "dataset sizes differ from the training config")
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in dataset.seq_batches(ds, TRAIN_BATCH, TRAIN_SEQ,
                                            steps=TRAIN_STEPS, seed=7)]
    toks, gold, lens = dataset.eval_examples(ds, seq_len=TRAIN_SEQ,
                                             max_users=256)
    excl = torch.from_numpy(metrics.history_exclusion(
        toks, cfg.padded_vocab)).to(dev)
    toks, gold, lens = (torch.from_numpy(a).to(dev)
                        for a in (toks, gold, lens))
    data_s = time.perf_counter() - t0
    mesh = hierarchical.init_world_of_one(dev)
    params0 = recmodel.init_recllm(
        cfg, ds.n_users, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(x.numel() for x in tree_leaves(params0))
    check(n_params == full_width_size(cfg, n_users),
          f"{n_params} parameters, want {full_width_size(cfg, n_users)}")
    # the optimizer settings of launch/train_recsys.py (examples/
    # train_recsys.py --full): at full width the compress payload's lr 1e-2
    # (set for its reduced model) makes every sync's loss spike
    ctx = ModelCtx(attn_chunk=TRAIN_SEQ)
    tcfg = TrainConfig(steps=TRAIN_STEPS, learning_rate=3e-3,
                       warmup_steps=5, checkpoint_every=0)

    def loss_fn(p, b):
        return recmodel.recllm_loss(cfg, p, b, ctx)[0]

    print(f"[train] RecLLM-base float32 at full width: {n_params:,} "
          f"parameters ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.padded_vocab:,}, {ds.n_users:,} users); "
          f"{len(ds.user):,} interactions; batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}; one-rank {dist.get_backend()} group; data in "
          f"{data_s:.1f} s")
    report = {"n_params": n_params, "runs": {}}
    # the embedding backward's index_add_ then sums in a fixed order, not
    # with atomics; no NaN fill of new tensors, which would add memsets to
    # the step's time
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        for name, mode, use_kernel, opts in TRAIN_RUNS:
            scfg = trainer.DPSyncConfig(mode=mode, use_kernel=use_kernel)
            esync = (trainer.EmbedSyncConfig(id_fns=recmodel.embed_id_fns(),
                                             **opts["embed"])
                     if "embed" in opts else None)
            exclude = esync.exclude if esync else ()
            n = trainer.residual_size(params0, scfg, exclude=exclude)
            params = tree_map(lambda p: p.clone(), params0)
            opt = adamw.init_opt_state(params)
            if esync is not None and esync.zero_opt:
                opt = trainer.shard_embed_opt(opt, esync, mesh, scfg)
            resid = torch.zeros(n, dtype=torch.float32, device=dev)
            step = trainer.make_dp_train_step(
                loss_fn, mesh, tcfg, scfg, embed_sync=esync,
                params_shape=params0,
                adamw_kernel=opts.get("adamw_kernel", False))
            split, losses, wall = {}, [], []
            torch.cuda.synchronize()
            reset_launches()
            for i, b in enumerate(batches):
                t1 = time.perf_counter()
                # the first step's split (first use of the kernels and the
                # collectives) is left out, as from steps/s
                params, opt, resid, loss = step(params, opt, resid, b,
                                                split=split if i else {})
                losses.append(float(loss))
                wall.append(time.perf_counter() - t1)
            launches = read_launches()
            check(all(math.isfinite(x) for x in losses),
                  f"train {name}: non-finite loss {losses}")
            per_step = TRAIN_LAUNCHES.get(name, {})
            want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in launches}
            check(launches == want, f"train {name}: launches {launches}, "
                  f"want {want}")
            with torch.no_grad():
                scores = recmodel.score_users(
                    cfg, params, toks, torch.zeros_like(lens), lens, ctx)
                hr, ndcg = metrics.hr_ndcg_at_k(scores, gold, k=10,
                                                exclude=excl)
            steady = sum(wall[1:]) / (len(wall) - 1)
            # the dense part over the params outside the excluded tables,
            # plus each rank's rows-touched payload: P ranks x U ids (the
            # sentinel-padded unique set of a rank's batch) x (row + id)
            n_dense = n_params - sum(params0[k].numel() for k in exclude)
            rows_wire = (mesh.size(("data",)) * TRAIN_BATCH
                         * EMBED_ROW_BYTES if esync else 0)
            wire = {"flat": n_dense * 4 * 2, "hierarchical": n_dense * 4,
                    "onebit": n // 8 + (n // 512) * 4,
                    "topk": (n // scfg.topk_block) * scfg.k * 8}[mode]
            payload = {"onebit": n // 8 + n // (8 * scfg.block) * 4,
                       "topk": (n // scfg.topk_block) * scfg.k * 8}.get(
                           mode, n_dense * 4)
            wire, payload = wire + rows_wire, payload + rows_wire
            r = {"losses": losses, "first_loss": losses[0],
                 "final_loss": sum(losses[-5:]) / 5,
                 "step_s": wall, "steps_per_s": 1.0 / steady,
                 "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
                 "split_s": {k: v / (TRAIN_STEPS - 1)
                             for k, v in split.items()},
                 "wire_bytes": wire, "payload_bytes": payload,
                 "rows_wire_bytes": rows_wire,
                 "launches": launches, "hr10": float(hr),
                 "ndcg10": float(ndcg)}
            report["runs"][name] = r
            sp = r["split_s"]
            print(f"[train {name}] losses {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f} (last-5 mean {r['final_loss']:.4f}); "
                  f"{r['steps_per_s']:.2f} steps/s, "
                  f"{r['tokens_per_s']:.0f} tokens/s (steps 2-{TRAIN_STEPS}, "
                  f"first {wall[0] * 1e3:.0f} ms); steps 2-{TRAIN_STEPS} "
                  f"split fwd+bwd "
                  f"{sp['fwd_bwd'] * 1e3:.2f} ms, sync {sp['sync'] * 1e3:.2f}"
                  f" ms, opt {sp['opt'] * 1e3:.2f} ms; wire bytes/step "
                  f"{wire:,} (payload {payload:,}"
                  + (f"; cf_user rows {rows_wire:,}" if esync else "")
                  + f"); HR@10 {r['hr10']:.4f} "
                  f"NDCG@10 {r['ndcg10']:.4f}; launches "
                  + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
            del params, opt, resid

        for mode in ("onebit", "topk"):
            a = report["runs"][mode]["losses"]
            b = report["runs"][mode + "_plain"]["losses"]
            diff = max(abs(x - y) for x, y in zip(a, b))
            report["runs"][mode]["traj_max_abs_loss_diff"] = diff
            if mode in TRAJ_EQUAL:
                check(diff == 0.0, f"train {mode}: kernel and plain runs' "
                      f"losses part by {diff}; they must be equal")
            print(f"[train {mode}] kernel vs plain run: losses within "
                  f"{diff:.3g} over {TRAIN_STEPS} steps ("
                  + ("must be equal)" if mode in TRAJ_EQUAL
                     else "reported, not held)"))
        flat = report["runs"]["flat"]["losses"]
        for name in ("flat_embed", "flat_embed_plain", "flat_embed_zero",
                     "flat_fused_adamw"):
            other = report["runs"][name]["losses"]
            diff = max(abs(x - y) for x, y in zip(other, flat))
            rel = max(abs(x - y) / abs(y) for x, y in zip(other, flat))
            report["runs"][name]["flat_max_abs_loss_diff"] = diff
            if name in EQUAL_TO_FLAT:
                check(other == flat, f"train {name}: losses part from "
                      f"flat's by {diff}; on one rank they must be equal")
                held = "must be equal"
            elif name == "flat_embed_zero":
                check(rel <= ZERO_RTOL, f"train {name}: losses {rel} "
                      f"relative from flat's > {ZERO_RTOL}")
                held = f"held within {ZERO_RTOL} relative"
            else:
                held = "reported, not held"
            print(f"[train {name}] against flat: losses within {diff:.3g} "
                  f"absolute, {rel:.3g} relative over {TRAIN_STEPS} steps "
                  f"({held})")

        # the kernel sync against the plain sync on one step's gradient
        # (taken once) and a nonzero residual
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params0)
        grads = tree_unflatten(leaves, list(torch.autograd.grad(
            loss_fn(leaves, batches[0]), tree_leaves(leaves))))
        gen = torch.Generator(device=dev).manual_seed(1)
        with torch.no_grad():
            for mode in ("onebit", "topk"):
                scfg = trainer.DPSyncConfig(mode=mode)
                n = trainer.residual_size(params0, scfg)
                resid = torch.randn(n, generator=gen, device=dev) * 1e-4
                out = {}
                for use_kernel in (True, False):
                    sync = compression.make_compressed_sync(
                        mode, mesh=mesh, block=scfg.block if mode == "onebit"
                        else scfg.topk_block, k=scfg.k,
                        use_kernel=use_kernel)
                    g, r = sync(grads, resid)
                    out[use_kernel] = (torch.cat([x.reshape(-1) for x in
                                                  tree_leaves(g)]), r)
                (gk, rk), (gp, rp) = out[True], out[False]
                if mode == "onebit":
                    flat_x = torch.cat([torch.cat([x.reshape(-1) for x in
                                                   tree_leaves(grads)]),
                                        torch.zeros(n - n_params,
                                                    device=dev)]) + resid
                    bk, _ = ops.onebit_quantize(flat_x, scfg.block)
                    bp, _ = ops.onebit_quantize(flat_x, scfg.block,
                                                impl="ref")
                    check(torch.equal(bk, bp), "onebit sync: kernel bits "
                          "differ from the plain bits")
                    # the mean is +-scale: relative to the largest scale;
                    # the residual x - scale * sign is rounded at |x|, so
                    # scales a few ulps apart move it by an ulp of |x|:
                    # each element relative to max(|x|, the largest scale)
                    scale = float(gp.abs().max())
                    errs = (float((gk - gp).abs().max()) / scale,
                            float(((rk - rp).abs()
                                   / torch.clamp(flat_x.abs(), min=scale))
                                  .max()))
                    check(max(errs) <= SCALE_RTOL, f"onebit sync: kernel "
                          f"against plain {errs} relative > {SCALE_RTOL}")
                    x_ratio = float(flat_x.abs().max()) / scale
                    r_gap = float((rk - rp).abs().max()) / scale
                    what = (f"bits equal, mean within {errs[0]:.3g} of the "
                            f"largest value, residual within {errs[1]:.3g} "
                            "of max(|x|, the largest value) elementwise "
                            f"(max |x| = {x_ratio:.3g} x the largest value; "
                            f"residual gap {r_gap:.3g} of the largest "
                            "value)")
                else:
                    check(torch.equal(gk, gp) and torch.equal(rk, rp),
                          "topk sync: kernel and plain differ")
                    what = "mean and residual equal"
                report[f"sync_{mode}"] = what
                print(f"[train] {mode} sync on one step's gradient, kernel "
                      f"against plain: {what}")

            # one AdamW step of the fused route against the elementwise
            # one on the same gradient, at step 3 with nonzero moments
            routed = [x.numel() for x in tree_leaves(params0)
                      if x.numel() % 1024 == 0]
            check((len(routed), sum(routed)) == (FUSED_LEAVES, FUSED_FLOATS),
                  f"{len(routed)} leaves ({sum(routed)} floats) take the "
                  f"fused route, want {FUSED_LEAVES} ({FUSED_FLOATS})")
            opt0 = adamw.init_opt_state(params0)
            opt0["m"] = tree_map(lambda g: 0.3 * g, grads)
            opt0["v"] = tree_map(lambda g: 0.5 * g * g, grads)
            opt0["step"] = torch.full_like(opt0["step"], 2)
            out = {k: adamw.adamw_apply(params0, grads, opt0, 3e-3, tcfg,
                                        use_kernel=k)[1]
                   for k in (True, False)}
            worst = 0.0
            for part in ("master", "m", "v"):
                err, ok = _adamw_err(tree_leaves(out[True][part]),
                                     tree_leaves(out[False][part]))
                check(ok, f"fused AdamW step: {part} beyond atol "
                          f"{ADAMW_ATOL} + rtol {ADAMW_RTOL} of the "
                          f"elementwise step (max abs {err})")
                worst = max(worst, err)
            report["adamw_step_max_abs_err"] = worst
            print(f"[train] one AdamW step, fused route ({FUSED_LEAVES} "
                  f"leaves, {FUSED_FLOATS:,} floats) against the "
                  f"elementwise step: new params, m and v within atol "
                  f"{ADAMW_ATOL} + rtol {ADAMW_RTOL} (max abs {worst:.3g})")
            del out, opt0
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
        dist.destroy_process_group()
    return report


# the hybrid phase: olmo-1b at full width through launch/train.py (its
# micro-batching: 4 of 2 rows), RecLLM-base hybrid against DP on seeded
# batches, and a checkpoint round trip of a 2-layer RecLLM-base
HYBRID_STEPS, HYBRID_BATCH, HYBRID_SEQ = 6, 8, 512
# the launcher's default lr (1e-3, the JAX launcher's) made olmo-1b's
# loss climb from 11.09 to 20.46 in 6 steps at full width on the H100
HYBRID_LR = 1e-4
HYBRID_REC_STEPS, HYBRID_REC_RTOL = 5, 1e-4
# the resumed run repeats the uninterrupted one's operations on a
# bit-equal state under deterministic algorithms: expected equal
HYBRID_CKPT_STEPS, HYBRID_RESUME_RTOL = 2, 1e-6


def _hybrid_state(torch, cfg, n_users, mesh, plan, tcfg, loss_fn, ctx,
                  batch):
    """A hybrid step over a fresh RecLLM init (seed 0) and its state."""
    from repro_torch.core import sharding
    from repro_torch.recsys import model as recmodel
    from repro_torch.runtime import trainer
    dev = torch.device("cuda")
    full = recmodel.init_recllm(
        cfg, n_users, torch.Generator(device=dev).manual_seed(0), dev)
    step, shardings_for = trainer.make_hybrid_train_step(
        cfg, plan, tcfg, loss_fn, params_shape=full, ctx=ctx)
    psh, osh, _ = shardings_for(full, batch)
    params = sharding.device_put(full, psh)
    state = {"params": params,
             "opt": trainer.init_hybrid_opt(cfg, plan, params, full)}
    return step, state, {"params": psh, "opt": osh}


def phase_hybrid_training(torch, card):
    """The hybrid TP x DP step on a one-rank NCCL world (tp = dp = 1):
    olmo-1b at full width through the training launcher, remat forced off
    and on; RecLLM-base (float32, full width) through the hybrid step
    against the DP step; a checkpoint round trip on the device."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.config import (ParallelConfig, ShapeConfig,
                                    TrainConfig)
    from repro_torch.core import hierarchical
    from repro_torch.core.hybrid import auto_plan
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import ModelCtx
    from repro_torch.obs import Tracer
    from repro_torch.recsys import model as recmodel
    from repro_torch.runtime import trainer
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    report = {"card": card}
    tmp = tempfile.mkdtemp(prefix="hybrid_ckpt_")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        # -- 1. olmo-1b at full width through launch/train.py ------------
        runs = {}
        for remat in ("off", "on"):
            gc.collect()        # a cycle of an earlier phase holds no tensor
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tracer = Tracer()
            res, plan = train_launcher.run(train_launcher.parse_args([
                "--arch", "olmo-1b", "--steps", str(HYBRID_STEPS),
                "--batch", str(HYBRID_BATCH), "--seq", str(HYBRID_SEQ),
                "--lr", str(HYBRID_LR), "--remat", remat,
                "--ckpt-dir", os.path.join(tmp, "olmo")]),
                tracer=tracer)
            peak = torch.cuda.max_memory_allocated()
            ms = sorted(1e3 * e["dur"] for e in tracer.events
                        if e["name"] == "train_step")
            p50 = float(np.median(ms))
            runs[remat] = {"losses": res.losses, "peak_bytes": peak,
                           "step_ms": ms, "step_ms_p50": p50,
                           "tokens_per_s": HYBRID_BATCH * HYBRID_SEQ
                           / (p50 / 1e3), "notes": list(plan.notes),
                           "remat": plan.remat}
            check(len(res.losses) == HYBRID_STEPS and all(
                math.isfinite(x) for x in res.losses),
                f"olmo-1b remat {remat}: losses {res.losses}")
            print(f"[hybrid] olmo-1b full width bf16, batch {HYBRID_BATCH} "
                  f"x seq {HYBRID_SEQ}, {plan.pcfg.microbatches} "
                  f"micro-batches, lr {HYBRID_LR:g}, remat {remat}: plan notes "
                  f"{list(plan.notes)}; step ms p50 {p50:.1f} (min "
                  f"{ms[0]:.1f}), {runs[remat]['tokens_per_s']:.0f} "
                  f"tokens/s; peak {peak / 2**30:.2f} GiB; losses "
                  f"{[round(x, 4) for x in res.losses]} ({card})")
        check(runs["on"]["losses"] == runs["off"]["losses"],
              "olmo-1b: remat changed the losses")
        check(runs["on"]["peak_bytes"] < runs["off"]["peak_bytes"],
              "olmo-1b: the peak is not lower with remat on")
        report["olmo"] = runs
        print(f"[hybrid] remat on: losses equal, peak "
              f"{runs['on']['peak_bytes'] / 2**30:.2f} GiB against "
              f"{runs['off']['peak_bytes'] / 2**30:.2f} GiB off")

        # -- 2. RecLLM-base: the hybrid step against the DP step ----------
        torch.cuda.empty_cache()
        cfg, n_users = train_config()
        hierarchical.init_world_of_one(dev)
        dp_mesh = hierarchical.make_dp_mesh()
        mesh = make_host_mesh()
        rng = np.random.default_rng(7)
        batches = [{"tokens": rng.integers(3, cfg.vocab_size,
                                           (TRAIN_BATCH, TRAIN_SEQ)),
                    "targets": rng.integers(3, cfg.vocab_size,
                                            (TRAIN_BATCH, TRAIN_SEQ)),
                    "user": rng.integers(0, n_users, TRAIN_BATCH)}
                   for _ in range(HYBRID_REC_STEPS)]
        batches = [{k: torch.from_numpy(v.astype(np.int32)).to(dev)
                    for k, v in b.items()} for b in batches]
        ctx = ModelCtx(attn_chunk=TRAIN_SEQ)
        tcfg = TrainConfig(steps=TRAIN_STEPS, learning_rate=3e-3,
                           warmup_steps=5, checkpoint_every=0)
        plan = auto_plan(cfg, mesh, ShapeConfig(
            "recllm", TRAIN_SEQ, TRAIN_BATCH, "train"), ParallelConfig())

        def hybrid_loss(p, b, c):
            return recmodel.recllm_loss(cfg, p, b, c)

        step, state, _ = _hybrid_state(torch, cfg, n_users, mesh, plan,
                                       tcfg, hybrid_loss, ctx, batches[0])
        hybrid = trainer.train_loop(state, iter(batches), step,
                                    tcfg).losses
        del step, state
        params = recmodel.init_recllm(
            cfg, n_users, torch.Generator(device=dev).manual_seed(0), dev)
        from repro_torch.optimizer import adamw
        dp_step = trainer.make_dp_train_step(
            lambda p, b: recmodel.recllm_loss(cfg, p, b, ctx)[0], dp_mesh,
            tcfg, trainer.DPSyncConfig(mode="flat"))
        flat = trainer.train_loop(
            {"params": params, "opt": adamw.init_opt_state(params),
             "residual": torch.zeros(1, device=dev)}, iter(batches),
            dp_step, tcfg).losses
        del params
        worst = max(abs(a - b) / abs(b) for a, b in zip(hybrid, flat))
        check(worst <= HYBRID_REC_RTOL,
              f"RecLLM hybrid {hybrid} against DP {flat}")
        report["recllm"] = {"hybrid": hybrid, "dp_flat": flat,
                            "max_rel": worst, "notes": list(plan.notes)}
        print(f"[hybrid] RecLLM-base float32 full width, batch "
              f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {HYBRID_REC_STEPS} "
              f"seeded batches: hybrid losses {[round(x, 5) for x in hybrid]}"
              f" against the DP step's (flat) within {worst:.2e} relative "
              f"(limit {HYBRID_REC_RTOL:g}); plan notes {list(plan.notes)}")

        # -- 3. a checkpoint round trip on the device ---------------------
        torch.cuda.empty_cache()
        cfg2 = dataclasses.replace(cfg, num_layers=2)
        tcfg2 = dataclasses.replace(tcfg, checkpoint_dir=os.path.join(
            tmp, "recllm"))

        def loss2(p, b, c):
            return recmodel.recllm_loss(cfg2, p, b, c)

        step, state, shardings = _hybrid_state(
            torch, cfg2, n_users, mesh, plan, tcfg2, loss2, ctx, batches[0])
        n = HYBRID_CKPT_STEPS
        trainer.train_loop(state, iter(batches[:n]), step, tcfg2)
        ckpt.save(tcfg2.checkpoint_dir, n, state, shardings=shardings)
        _, fresh, _ = _hybrid_state(torch, cfg2, n_users, mesh, plan,
                                    tcfg2, loss2, ctx, batches[0])
        start, back = trainer.resume_or_init(fresh, tcfg2, shardings)
        check(start == n, f"resumed at {start}, want {n}")
        bad = [i for i, (a, b) in enumerate(zip(tree_leaves(back),
                                                tree_leaves(state)))
               if a.dtype != b.dtype or not torch.equal(a, b)]
        check(not bad, f"restored leaves {bad} differ from the saved ones")
        ahead = trainer.train_loop(state, iter(batches[n:]), step,
                                   tcfg2).losses
        resumed = trainer.train_loop(back, iter(batches[n:]), step, tcfg2,
                                     start_step=n).losses
        gap = max(abs(a - b) / abs(b) for a, b in zip(resumed, ahead))
        check(gap <= HYBRID_RESUME_RTOL,
              f"resumed losses {resumed} against {ahead}")
        n_leaves = len(tree_leaves(state))
        report["checkpoint"] = {"leaves": n_leaves, "ahead": ahead,
                                "resumed": resumed}
        print(f"[hybrid] checkpoint round trip (RecLLM-base, 2 layers, "
              f"float32): {n_leaves} leaves restored bit-equal after "
              f"{n} steps; {len(resumed)} resumed steps' losses within "
              f"{gap:.2e} relative (limit {HYBRID_RESUME_RTOL:g}) of the "
              f"uninterrupted run's {[round(x, 5) for x in ahead]}")
        del state, back, fresh, step
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return report


# the hybrid phase's steps, batches and lr schedule: the two runs' losses
# are compared step by step (over the first 4 the loss does not fall on
# these batches, in either step)
PP_STEPS, PP_COMPRESSED_STEPS = HYBRID_STEPS, 2
# bf16 at full width: the hybrid step's flash backward against autograd
# through the chunked attention, in another order
PP_HYBRID_RTOL = 1e-3
# the pipelined step against the hybrid step at float32, olmo-1b's widths
# cut to 2 layers: JAX's own tolerance for its pipelined step against the
# DP step (tests/distributed_checks.py)
PP_PARITY_LAYERS, PP_PARITY_STEPS = 2, 3
PP_PARITY_RTOL, PP_PARITY_ATOL = 2e-4, 1e-5
# ... and their params, m, v and master after those steps, each leaf's
# worst element against the leaf's largest: a gradient off by a constant
# factor moves m by that factor and v by its square
PP_STATE_TOL = 1e-5
PP_PROBE_BOUNDS = [0, 4, 16]
# launches a pipelined step makes: the DP step's sync, once a step
PP_LAUNCHES = {"onebit": {"onebit_quantize": 1, "onebit_dequantize": 2},
               "topk": {"topk_select": 1}}


def phase_pipelined_training(torch, card, hybrid):
    """The pipelined DP x TP x stage step (``trainer.make_pp_train_step``)
    on a one-rank NCCL world with a ``stage`` axis of 1: no message is
    sent, but the executor (forward without autograd, the backward's
    recompute), the syncs and their kernels run.  (a) olmo-1b's widths in
    float32 cut to 2 layers: the pipelined step's losses against the
    hybrid step's on the same batches, then its merged params and AdamW
    state against the hybrid step's (no clip, so a gradient's scale shows
    in m and v); (b) olmo-1b at full width (bf16) through
    ``launch/train.py`` under 1F1B and GPipe (flat sync): step ms p50,
    tokens/s, peak memory.  At a stage axis of 1 the two schedules are the
    same computation (the only stage is first and last, and the backward
    ticks take the micro-batches in the same order), so GPipe's run checks
    that the step is deterministic, not a schedule; (c) 1F1B under 1-bit
    and top-k sync with the launch counters; (d) ``probe_stage_times``
    over the 16 full-width layers carved ``[0, 4, 16]`` and the bounds
    ``rebalance_stages`` gives."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.config import (ParallelConfig, ShapeConfig,
                                    TrainConfig, get_arch)
    from repro_torch.core import hierarchical, load_balance, sharding
    from repro_torch.core.hybrid import auto_plan
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import ModelCtx
    from repro_torch.obs import Tracer
    from repro_torch.optimizer import adamw
    from repro_torch.runtime import trainer
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    report = {"card": card}
    tmp = tempfile.mkdtemp(prefix="pp_ckpt_")
    # the stage knobs launch/train.py gives the pipelined step at tp 1
    ctx = ModelCtx(flash_vjp=True)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        # -- a. the pipelined step against the hybrid step (float32) -------
        cfg = dataclasses.replace(get_arch("olmo-1b"),
                                  num_layers=PP_PARITY_LAYERS,
                                  dtype="float32")
        hierarchical.init_world_of_one(dev)
        rng = np.random.default_rng(3)
        batches = [{k: torch.from_numpy(rng.integers(
            3, cfg.vocab_size, (HYBRID_BATCH, HYBRID_SEQ)).astype(
                np.int32)).to(dev) for k in ("tokens", "targets")}
            for _ in range(PP_PARITY_STEPS)]
        tcfg = TrainConfig(steps=20, learning_rate=HYBRID_LR,
                           warmup_steps=2, grad_clip=0.0,
                           checkpoint_every=0)
        losses, states = {}, {}
        bounds = [0, cfg.num_layers]
        for kind in ("hybrid", "pipelined"):
            torch.cuda.empty_cache()
            full = convert.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
            if kind == "hybrid":
                plan = auto_plan(cfg, make_host_mesh(), ShapeConfig(
                    "pp", HYBRID_SEQ, HYBRID_BATCH, "train"),
                    ParallelConfig(microbatches=4))
                step, shardings_for = trainer.make_hybrid_train_step(
                    cfg, plan, tcfg, params_shape=full)
                psh, _, _ = shardings_for(full, batches[0])
                params = sharding.device_put(full, psh)
                state = {"params": params, "opt": trainer.init_hybrid_opt(
                    cfg, plan, params, full)}
            else:
                pp = tf.pp_partition_params(cfg, full, bounds)
                state = {"params": pp, "opt": adamw.init_opt_state(
                    trainer.pp_trainable(pp, cfg.tie_embeddings)),
                    "residual": torch.zeros((1, 1, 1, 0), device=dev)}
                step = trainer.make_pp_train_step(
                    cfg, make_host_mesh(stage=1), tcfg, bounds, pp,
                    n_micro=4, ctx=ctx)
            del full
            losses[kind] = trainer.train_loop(state, iter(batches), step,
                                              tcfg).losses
            states[kind] = state
            del state, step
        worst = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
            losses["pipelined"], losses["hybrid"]))
        check(all(abs(a - b) <= PP_PARITY_ATOL + PP_PARITY_RTOL * abs(b)
                  for a, b in zip(losses["pipelined"], losses["hybrid"])),
              f"pipelined {losses['pipelined']} against hybrid "
              f"{losses['hybrid']}")
        # the merged pipelined state against the hybrid step's, leaf by leaf
        hyb, pst = states["hybrid"], states["pipelined"]
        pairs = {"params": (hyb["params"], tf.pp_merge_params(
            cfg, pst["params"], bounds))}
        for part in ("m", "v", "master"):
            pairs[part] = (hyb["opt"][part], tf.pp_merge_params(
                cfg, pst["opt"][part], bounds))
        state_err = {}
        for part, (want, got) in pairs.items():
            wl, gl = tree_leaves(want), tree_leaves(got)
            check(len(wl) == len(gl) and all(
                a.shape == b.shape for a, b in zip(wl, gl)),
                f"pipelined {part}: tree differs from the hybrid step's")
            state_err[part] = max(
                float((a.float() - b.float()).abs().max())
                / max(float(b.float().abs().max()), 1e-30)
                for a, b in zip(gl, wl))
        del states, hyb, pst, pairs, want, got, wl, gl
        check(all(e <= PP_STATE_TOL for e in state_err.values()),
              f"pipelined state against the hybrid step's: {state_err} "
              f"(limit {PP_STATE_TOL:g} of each leaf's largest)")
        report["parity"] = {**losses, "max_rel": worst,
                            "state_err": state_err}
        print(f"[pipelined] olmo-1b widths, {PP_PARITY_LAYERS} layers, "
              f"float32, batch {HYBRID_BATCH} x seq {HYBRID_SEQ} in 4 "
              f"micro-batches, {PP_PARITY_STEPS} seeded batches: pipelined "
              f"losses {[round(x, 6) for x in losses['pipelined']]} against "
              f"the hybrid step's {[round(x, 6) for x in losses['hybrid']]}"
              f", within {worst:.2e} relative (limit {PP_PARITY_RTOL:g} "
              f"+ {PP_PARITY_ATOL:g}); after them params, m, v, master "
              f"within {', '.join(f'{e:.2e}' for e in state_err.values())} "
              f"of each leaf's largest (limit {PP_STATE_TOL:g})")
        dist.destroy_process_group()

        # -- b, c. olmo-1b at full width through launch/train.py -----------
        runs = {}
        for name, sched, sync, steps in (
                ("1f1b", "1f1b", "flat", PP_STEPS),
                ("gpipe", "gpipe", "flat", PP_STEPS),
                ("onebit", "1f1b", "onebit", PP_COMPRESSED_STEPS),
                ("topk", "1f1b", "topk", PP_COMPRESSED_STEPS)):
            gc.collect()        # (a)'s steps and states hold no tensor
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tracer = Tracer()
            reset_launches()
            res, plan = train_launcher.run(train_launcher.parse_args([
                "--arch", "olmo-1b", "--steps", str(steps),
                "--batch", str(HYBRID_BATCH), "--seq", str(HYBRID_SEQ),
                "--lr", str(HYBRID_LR), "--pp-micro", "4",
                "--pp-schedule", sched, "--grad-sync", sync,
                "--ckpt-dir", os.path.join(tmp, name)]),
                tracer=tracer, pipelined=True)
            launches = {k: v for k, v in read_launches().items() if v}
            peak = torch.cuda.max_memory_allocated()
            ms = sorted(1e3 * e["dur"] for e in tracer.events
                        if e["name"] == "train_step")
            p50 = float(np.median(ms))
            runs[name] = {"losses": res.losses, "peak_bytes": peak,
                          "step_ms": ms, "step_ms_p50": p50,
                          "tokens_per_s": HYBRID_BATCH * HYBRID_SEQ
                          / (p50 / 1e3), "notes": list(plan.notes),
                          "launches": launches}
            check(len(res.losses) == steps and all(
                math.isfinite(x) for x in res.losses),
                f"pipelined {name}: losses {res.losses}")
            want = {k: n * steps for k, n in PP_LAUNCHES.get(sync,
                                                             {}).items()}
            check(launches == want, f"pipelined {name}: launches "
                  f"{launches}, want {want}")
            print(f"[pipelined] olmo-1b full width bf16, stage 1, "
                  f"{sched}, {sync} sync, batch {HYBRID_BATCH} x seq "
                  f"{HYBRID_SEQ}, 4 micro-batches, lr {HYBRID_LR:g}: plan "
                  f"notes {list(plan.notes)}; step ms p50 {p50:.1f} (min "
                  f"{ms[0]:.1f}), {runs[name]['tokens_per_s']:.0f} tokens/s;"
                  f" peak {peak / 2**30:.2f} GiB; launches {launches}; "
                  f"losses {[round(x, 4) for x in res.losses]} ({card})")
        for name in ("1f1b", "gpipe"):
            ls = runs[name]["losses"]
            check(ls[-1] < ls[0], f"pipelined {name}: losses not falling "
                  f"{ls}")
        hl = hybrid["olmo"]["off"]["losses"]
        check(all(abs(a - b) <= PP_HYBRID_RTOL * abs(b)
                  for a, b in zip(runs["1f1b"]["losses"], hl)),
              f"pipelined {runs['1f1b']['losses']} against hybrid {hl}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            runs["1f1b"]["losses"], hl))
        same = runs["1f1b"]["losses"] == runs["gpipe"]["losses"]
        gap = max(abs(a - b) for a, b in zip(runs["1f1b"]["losses"],
                                             runs["gpipe"]["losses"]))
        check(gap <= 1e-3 * abs(runs["1f1b"]["losses"][0]),
              f"1F1B {runs['1f1b']['losses']} against GPipe "
              f"{runs['gpipe']['losses']}")
        off = hybrid["olmo"]["off"]
        print(f"[pipelined] 1F1B and GPipe (one computation at a stage "
              f"axis of 1: a determinism check) losses "
              f"{'equal bit for bit' if same else f'differ by {gap:.3e}'}; "
              f"1F1B's within {rel:.2e} relative of the hybrid step's on "
              f"the same batches (limit {PP_HYBRID_RTOL:g}); "
              f"1F1B step ms p50 {runs['1f1b']['step_ms_p50']:.1f} and peak "
              f"{runs['1f1b']['peak_bytes'] / 2**30:.2f} GiB against the "
              f"hybrid step's {off['step_ms_p50']:.1f} ms and "
              f"{off['peak_bytes'] / 2**30:.2f} GiB (remat off) and "
              f"{hybrid['olmo']['on']['step_ms_p50']:.1f} ms, "
              f"{hybrid['olmo']['on']['peak_bytes'] / 2**30:.2f} GiB (on), "
              f"this run")
        report["olmo"] = runs
        report["schedules_equal"] = same
        report["hybrid_max_rel"] = rel

        # -- d. the stage-time probe and the rebalance it gives -------------
        torch.cuda.empty_cache()
        cfg = get_arch("olmo-1b")
        full = convert.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        pp = tf.pp_partition_params(cfg, full, PP_PROBE_BOUNDS)
        del full
        times = trainer.probe_stage_times(cfg, pp, PP_PROBE_BOUNDS, ctx,
                                          batch=2, seq=HYBRID_SEQ, iters=5)
        new = load_balance.rebalance_stages(times, PP_PROBE_BOUNDS)
        del pp
        check(all(t > 0 for t in times) and len(new) == 3
              and new != PP_PROBE_BOUNDS,
              f"probe {times} -> bounds {new}")
        report["probe"] = {"bounds": PP_PROBE_BOUNDS, "stage_s": times,
                           "rebalanced": new}
        print(f"[pipelined] probe_stage_times, olmo-1b full width bf16, "
              f"bounds {PP_PROBE_BOUNDS}, a micro-batch of 2 x "
              f"{HYBRID_SEQ}: stage ms {[round(1e3 * t, 3) for t in times]}"
              f" -> rebalance_stages {new} ({card})")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return report


# -- the sharded CF tables ---------------------------------------------------

SHARDED_PLANS = ("row", "col", "row_col")
# ids a lookup: a request's user + candidates, a training batch's users,
# and a batch of many requests' candidates
SHARDED_IDS = (1 + CF_CANDIDATES, TRAIN_BATCH, 4096)
SHARDED_GRAD_ATOL = 1e-6
SHARDED_CF_ROUNDS = 2     # unpinned serve runs of each plan, in turns
SHARDED_REC_RTOL = 1e-6


def phase_sharded_cf(torch, card):
    """The sharded CF-table plans (row, col, row_col) on a one-rank NCCL
    world, the mesh ``(data 1, model 1)``: (a) every plan's lookup
    (``embeddings.make_sharded_lookup``) on the card at two sizes, the
    launcher head's tables (10,000 x 16 users, RecLLM-base's vocab x 16
    items) and RecLLM-base's full-width training tables (cf_dim 64): under
    ``no_grad`` through the ``gather_rows`` kernel (one launch a lookup)
    bit-equal to ``table[ids]``, with grad bit-equal too and its gradient
    within 1e-6 of the replicated gather's; (b) the launcher's CF head on
    RecLLM-base (bf16, 16 requests x 16 candidates) under each plan and
    the replicated plan: pinned-clock greedy streams, cf / fused /
    ranking and every kernel's launches equal to the replicated head's;
    unpinned ``cf.lookup`` p50 of each; ``gather_rows`` device ms a call
    on the row-sharded path (profiler); (c) RecLLM-base at full width
    (float32) through the hybrid step with ``embed_plans("row")`` and
    ``("row_col")`` against the replicated plan on the same 5 batches:
    losses within 1e-6 relative (bit-equality printed)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.config import (ParallelConfig, ShapeConfig,
                                    TrainConfig, get_arch)
    from repro_torch.core import hierarchical
    from repro_torch.core.hybrid import auto_plan
    from repro_torch.embeddings import (EmbedSpec, init_table, make_plan,
                                        make_sharded_lookup,
                                        named_sharding)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import ModelCtx
    from repro_torch.obs import Tracer
    from repro_torch.recsys import model as recmodel
    from repro_torch.runtime import trainer
    from repro_torch.serving import (CFConfig, CFHead, Clock, EngineConfig,
                                     ServingEngine, TrafficConfig, generate,
                                     make_backend)
    dev = torch.device("cuda")
    report = {"card": card}
    hierarchical.init_world_of_one(dev)
    deterministic(torch, True)  # (a) and (c): duplicates summed in order
    try:
        mesh = make_host_mesh()
        # -- (a) every plan's lookup on the card ---------------------------
        cfg = get_arch("recllm-base")
        tcfg_model, n_users = train_config()
        gen = torch.Generator(device=dev).manual_seed(3)
        tables = {
            "head": {n: init_table(gen, EmbedSpec(n, rows, CF_DIM), dev)
                     for n, rows in (("cf_user", CF_USERS),
                                     ("cf_item", cfg.vocab_size))},
            "recllm": {n: init_table(gen, EmbedSpec(n, rows, 64), dev)
                       for n, rows in (("cf_user", n_users),
                                       ("cf_item",
                                        tcfg_model.padded_vocab))}}
        lookups = {}
        for size, tabs in tables.items():
            for name, t in tabs.items():
                spec = EmbedSpec(name, *t.shape)
                for n in SHARDED_IDS:
                    ids = torch.randint(0, t.shape[0], (n,), generator=gen,
                                        device=dev, dtype=torch.int32)
                    want = t[ids.long()]
                    tgt = torch.randn(want.shape, generator=gen, device=dev)
                    t0 = t.clone().requires_grad_()
                    (g_want,) = torch.autograd.grad(
                        0.5 * torch.sum((t0[ids.long()] - tgt) ** 2), t0)
                    for kind in ("replicated",) + SHARDED_PLANS:
                        plan = make_plan(kind)
                        shard = named_sharding(mesh, plan).shard(t)
                        lk = make_sharded_lookup(mesh, spec, plan,
                                                 use_kernel=True)
                        reset_launches()
                        with torch.no_grad():
                            out = lk(shard, ids)
                        torch.cuda.synchronize()
                        launched = read_launches()["gather_rows"]
                        check(torch.equal(out, want),
                              f"{size} {name} {kind} n={n}: the kernel "
                              "lookup differs from table[ids]")
                        check(launched == 1,
                              f"{size} {name} {kind}: {launched} gather_rows "
                              "launches a lookup, want 1")
                        sh = shard.detach().clone().requires_grad_()
                        got = make_sharded_lookup(mesh, spec, plan)(sh, ids)
                        check(torch.equal(got.detach(), want),
                              f"{size} {name} {kind} n={n}: the lookup with "
                              "grad differs from table[ids]")
                        (g,) = torch.autograd.grad(
                            0.5 * torch.sum((got - tgt) ** 2), sh)
                        err = float((g - g_want).abs().max())
                        check(err <= SHARDED_GRAD_ATOL,
                              f"{size} {name} {kind} n={n}: gradient off "
                              f"by {err:.3e}")
                        lookups[f"{size}/{name}/{kind}/{n}"] = err
        report["lookups_grad_err"] = lookups
        # the kernel path with grad mode on: a table that needs no gradient
        # still goes through gather_rows; one that does is refused
        lk = make_sharded_lookup(mesh, spec, plan, use_kernel=True)
        reset_launches()
        out = lk(shard, ids)
        torch.cuda.synchronize()
        check(read_launches()["gather_rows"] == 1 and torch.equal(out, want),
              "a grad-mode kernel lookup did not go through gather_rows")
        refusal = ""
        try:
            lk(shard.detach().clone().requires_grad_(), ids)
        except RuntimeError as e:
            refusal = str(e)
        check("no backward" in refusal, "a kernel lookup recording a "
              f"gradient was not refused ({refusal or 'it ran'})")
        print(f"[sharded] use_kernel with grad mode on: gather_rows "
              f"launched for a table without a gradient, refused for one "
              f"with ({kind})")
        print(f"[sharded] lookups on the card, plans replicated/row/col/"
              f"row_col, the head's tables ({CF_USERS:,} x {CF_DIM}, "
              f"{cfg.vocab_size:,} x {CF_DIM}) and RecLLM-base's ({n_users:,}"
              f" x 64, {tcfg_model.padded_vocab:,} x 64), {SHARDED_IDS} ids: "
              f"one gather_rows launch a no_grad lookup, bit-equal to "
              f"table[ids]; gradients within {max(lookups.values()):.3e} of "
              f"the replicated gather's (limit {SHARDED_GRAD_ATOL:g})")

        # -- (b) the launcher's CF head under each plan --------------------
        deterministic(torch, False)
        ecfg = EngineConfig(n_slots=8, max_len=512)
        requests = generate(TrafficConfig(n_requests=16,
                                          vocab_size=cfg.vocab_size, seed=0,
                                          candidates=CF_CANDIDATES,
                                          n_users=CF_USERS))
        kern = tf.ModelCtx(attn_impl="flash", decode_impl="flash",
                           attn_chunk=8)
        params = convert.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        user, item = tables["head"]["cf_user"], tables["head"]["cf_item"]

        def head(kind):
            return CFHead(user, item, cfg=CFConfig(plan=kind), device=dev,
                          mesh=mesh)

        def engine(kind, clock=None, tracer=None):
            return ServingEngine(make_backend(cfg, params, kern, device=dev),
                                 ecfg, clock, tracer=tracer,
                                 cf_head=head(kind))

        engine("row").run(requests)         # warm-up: the sharded path too
        pinned = {}
        for kind in ("replicated",) + SHARDED_PLANS:
            eng = engine(kind, Clock(fixed_decode_s=0.01,
                                     fixed_prefill_s=0.02, fixed_cf_s=0.005))
            reset_launches()
            out, _, summary = eng.run(requests)
            torch.cuda.synchronize()
            pinned[kind] = (eng, out, read_launches())
            check(summary["finished"] == len(requests)
                  and eng.cf_scored == len(requests),
                  f"sharded {kind}: served {summary['finished']}, scored "
                  f"{eng.cf_scored} of {len(requests)}")
        eng_r, out_r, l_r = pinned["replicated"]
        check(l_r["gather_rows"] == 2 * eng_r.cf_scored,
              f"replicated head: {l_r['gather_rows']} gather_rows launches "
              f"for {eng_r.cf_scored} scored requests")
        for kind in SHARDED_PLANS:
            eng, out, launched = pinned[kind]
            div = _first_divergence(out, out_r)
            check(div is None, f"sharded {kind}: greedy streams differ from "
                               f"the replicated head's at {div}")
            for rid, want in eng_r.cf_results.items():
                for k in ("cf", "fused", "ranking"):
                    check(np.array_equal(eng.cf_results[rid][k], want[k]),
                          f"sharded {kind}: request {rid}'s {k} differs "
                          "from the replicated head's")
            check(launched == l_r, f"sharded {kind}: launches {launched}, "
                                   f"the replicated head's {l_r}")
        rounds = {k: [] for k in ("replicated",) + SHARDED_PLANS}
        walls = {}
        for rnd in range(SHARDED_CF_ROUNDS):
            order = list(rounds) if rnd % 2 == 0 else list(rounds)[::-1]
            for kind in order:
                tr = Tracer()
                t0 = time.perf_counter()
                engine(kind, tracer=tr).run(requests)
                walls[kind] = time.perf_counter() - t0
                rounds[kind] += [e["dur"] * 1e3 for e in tr.events
                                 if e["name"] == "cf.lookup"]
        p50 = {k: float(np.percentile(v, 50)) for k, v in rounds.items()}
        prof = profile_serve(torch, "cf row", lambda: engine("row").run(
            requests), walls["row"], CF_TAGS)
        gather_ms = prof["device_ms_per_launch"].get("gather_rows")
        report["serve"] = {
            "launches": {k: v[2] for k, v in pinned.items()},
            "cf_lookup_ms_p50": p50, "profile": prof,
            "gather_rows_device_ms": gather_ms}
        print(f"[sharded] the launcher's CF head on {cfg.name} bf16, "
              f"{len(requests)} requests x {CF_CANDIDATES} candidates: "
              f"pinned-clock streams, cf/fused/ranking and launches under "
              f"row/col/row_col == the replicated head's (gather_rows "
              f"{l_r['gather_rows']} = 2 x {eng_r.cf_scored}); cf.lookup a "
              f"request p50 ms ({SHARDED_CF_ROUNDS} runs each, in turns): "
              + ", ".join(f"{k} {v:.4f}" for k, v in p50.items())
              + "; gather_rows device ms a call on the row path: "
              + ("not measured" if gather_ms is None
                 else f"{gather_ms:.5f}") + f" ({card})")

        # -- (c) the hybrid step with embed_plans at full width ------------
        del params, pinned
        gc.collect()
        torch.cuda.empty_cache()
        deterministic(torch, True)
        rng = np.random.default_rng(7)
        batches = [{k: torch.from_numpy(v.astype(np.int32)).to(dev)
                    for k, v in {
                        "tokens": rng.integers(3, tcfg_model.vocab_size,
                                               (TRAIN_BATCH, TRAIN_SEQ)),
                        "targets": rng.integers(3, tcfg_model.vocab_size,
                                                (TRAIN_BATCH, TRAIN_SEQ)),
                        "user": rng.integers(0, n_users,
                                             TRAIN_BATCH)}.items()}
                   for _ in range(HYBRID_REC_STEPS)]
        ctx = ModelCtx(attn_chunk=TRAIN_SEQ)
        tcfg = TrainConfig(steps=TRAIN_STEPS, learning_rate=3e-3,
                           warmup_steps=5, checkpoint_every=0)

        def hybrid_loss(p, b, c):
            return recmodel.recllm_loss(tcfg_model, p, b, c)

        losses = {}
        for kind in ("replicated", "row", "row_col"):
            plan = auto_plan(tcfg_model, mesh, ShapeConfig(
                "recllm", TRAIN_SEQ, TRAIN_BATCH, "train"), ParallelConfig(),
                embed_plans=(None if kind == "replicated"
                             else recmodel.embed_plans(kind)))
            step, state, _ = _hybrid_state(torch, tcfg_model, n_users, mesh,
                                           plan, tcfg, hybrid_loss, ctx,
                                           batches[0])
            losses[kind] = trainer.train_loop(state, iter(batches), step,
                                              tcfg).losses
            del step, state
        base = losses["replicated"]
        rel = {}
        for kind in ("row", "row_col"):
            rel[kind] = max(abs(a - b) / abs(b)
                            for a, b in zip(losses[kind], base))
            check(rel[kind] <= SHARDED_REC_RTOL,
                  f"RecLLM hybrid under {kind}: {losses[kind]} against the "
                  f"replicated plan's {base}")
        report["recllm"] = {"losses": losses, "max_rel": rel}
        print(f"[sharded] RecLLM-base float32 full width through the hybrid "
              f"step, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
              f"{HYBRID_REC_STEPS} seeded batches: replicated losses "
              f"{[round(x, 5) for x in base]}; " + "; ".join(
                  f"embed_plans({k!r}) within {rel[k]:.2e} relative (limit "
                  f"{SHARDED_REC_RTOL:g}), bit-equal "
                  f"{losses[k] == base}" for k in rel))
    finally:
        deterministic(torch, False)
        if dist.is_initialized():
            dist.destroy_process_group()
    return report


# the async-DP phase: the simulator's batches and runs (staleness process,
# max staleness, compensated), the training phase's lr and warmup
ASYNC_STEPS = 16
ASYNC_LR, ASYNC_WARMUP = 3e-3, 5
ASYNC_RUNS = [("tau0", "random", 0, True), ("tau0_straggler", "straggler", 0,
                                            True),
              ("tau2", "straggler", 2, True), ("tau2_naive", "straggler", 2,
                                               False),
              ("tau6", "straggler", 6, True), ("tau6_naive", "straggler", 6,
                                               False)]
ASYNC_SYNC_RTOL = 1e-6
# the prefetcher's run: the DP step with flat sync, the fused AdamW and the
# rows-touched cf_user sync, so the three kernels of the step all launch
PREFETCH_STEPS = 8
PREFETCH_LAUNCHES = {"gather_rows": 1, "scatter_add_rows": 1,
                     "adamw_update": FUSED_LEAVES}


def phase_async_dp(torch, card):
    """The paper's sync-against-async half on a one-rank NCCL world, under
    deterministic algorithms: (a) RecLLM-base at full width (float32)
    through ``core/async_dp.py``'s ``simulate_sync_sgd`` and
    ``simulate_async_sgd`` on the same 16 batches: zero staleness (the
    ``random`` process at S = 0) against the sync run, losses within 1e-6
    relative; the ``straggler`` process at S = 0, 2 and 6, compensated and
    naive (S = 0: printed; S > 0: each must part from zero staleness at
    some step); every loss finite; no kernel launched (the simulator's
    update is elementwise, as in JAX); final loss, step ms p50 and peak
    memory of each run; (b) the DP step (flat sync, the fused AdamW, the
    rows-touched cf_user sync) on 8 batches fed once through
    ``data.Prefetcher(size=2)`` from host numpy and once placed on the
    main thread by ``data.place_batch``: every batch received, losses
    bit-equal, the launches of gather_rows, scatter_add_rows and
    adamw_update equal (and as the step implies); step ms p50 both ways;
    (c) ``runtime/elastic.py`` at one rank: ``make_mesh_for(1)`` and
    ``reshard`` of the hybrid step's RecLLM-base state onto it the
    identity bit for bit, ``shrink_batch`` keeping the batch."""
    import math
    import statistics

    import torch.distributed as dist
    from repro_torch.config import ParallelConfig, ShapeConfig, TrainConfig
    from repro_torch.core import async_dp, hierarchical
    from repro_torch.core.hybrid import auto_plan
    from repro_torch.data import Prefetcher, place_batch
    from repro_torch.models.transformer import ModelCtx
    from repro_torch.optimizer import adamw
    from repro_torch.recsys import dataset, model as recmodel
    from repro_torch.runtime import elastic, trainer
    from repro_torch.tree import tree_leaves, tree_map
    dev = torch.device("cuda")
    report = {"card": card, "runs": {}}
    ds = dataset.generate(scale=1.0, seed=0)
    cfg, n_users = train_config()
    host = list(dataset.seq_batches(ds, TRAIN_BATCH, TRAIN_SEQ,
                                    steps=ASYNC_STEPS, seed=7))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in host]
    ctx = ModelCtx(attn_chunk=TRAIN_SEQ)
    mesh = hierarchical.init_world_of_one(dev)
    deterministic(torch, True)
    try:
        params0 = recmodel.init_recllm(
            cfg, n_users, torch.Generator(device=dev).manual_seed(0), dev)
        n_params = sum(x.numel() for x in tree_leaves(params0))
        check(n_params == full_width_size(cfg, n_users),
              f"{n_params} parameters, want {full_width_size(cfg, n_users)}")

        # -- (a) sync against async at full width --------------------------
        def run(name, simulate):
            marks = []

            def loss_fn(p, b):
                if not torch.is_grad_enabled():   # the loss after an update
                    marks.append(time.perf_counter())
                return recmodel.recllm_loss(cfg, p, b, ctx)[0]

            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            _, losses = simulate(loss_fn)
            launches = {k: v for k, v in read_launches().items() if v}
            check(all(math.isfinite(x) for x in losses),
                  f"async {name}: non-finite loss {losses}")
            check(not launches, f"async {name}: launched {launches}; the "
                  "simulator's update is elementwise")
            steps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
            r = {"losses": losses, "final_loss": losses[-1],
                 "step_ms_p50": statistics.median(steps),
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            report["runs"][name] = r
            print(f"[async {name}] losses {losses[0]:.5f} -> "
                  f"{losses[-1]:.5f}; step ms p50 {r['step_ms_p50']:.1f} "
                  f"(steps 2-{ASYNC_STEPS}); peak {r['peak_gib']:.2f} GiB "
                  f"({card})")
            return losses

        sync = run("sync", lambda f: async_dp.simulate_sync_sgd(
            f, params0, batches, ASYNC_LR, warmup_steps=ASYNC_WARMUP))
        for name, mode, s_max, comp in ASYNC_RUNS:
            acfg = async_dp.AsyncConfig(max_staleness=s_max, compensate=comp,
                                        lr=ASYNC_LR, staleness=mode,
                                        warmup_steps=ASYNC_WARMUP)
            run(name, lambda f, acfg=acfg: async_dp.simulate_async_sgd(
                f, params0, batches, acfg))
        runs = report["runs"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(runs["tau0"]["losses"],
                                                       sync))
        check(rel <= ASYNC_SYNC_RTOL, f"async tau0: losses {rel} relative "
              f"from the sync run's > {ASYNC_SYNC_RTOL}")
        fresh = runs["tau0"]["losses"]
        for name in ("tau2", "tau2_naive", "tau6", "tau6_naive"):
            check(runs[name]["losses"] != fresh, f"async {name}: losses equal "
                  "zero staleness's at every step: the ring is not live")
        stg = max(abs(a - b) / abs(b) for a, b in zip(
            runs["tau0_straggler"]["losses"], sync))
        beats = {s: runs[f"tau{s}"]["final_loss"]
                 < runs[f"tau{s}_naive"]["final_loss"] for s in (2, 6)}
        report.update(tau0_sync_rel=rel, tau0_sync_equal=fresh == sync,
                      tau0_straggler_sync_rel=stg, compensated_beats=beats)
        print(f"[async] RecLLM-base float32 full width ({n_params:,} "
              f"parameters), {ASYNC_STEPS} batches of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, lr {ASYNC_LR}: zero staleness within {rel:.3g} "
              f"relative of sync (limit {ASYNC_SYNC_RTOL:g}; bit-equal "
              f"{fresh == sync}); straggler S=0 within {stg:.3g} (printed: "
              "its fast workers draw tau 1, so compensation halves their "
              "lr); tau > 0 runs part from zero staleness; compensated "
              "beats naive at S=2: " f"{beats[2]}, S=6: {beats[6]} "
              "(printed, not held)")

        # -- (b) the prefetcher on the device ------------------------------
        del batches
        gc.collect()
        torch.cuda.empty_cache()
        tcfg = TrainConfig(steps=TRAIN_STEPS, learning_rate=3e-3,
                           warmup_steps=5, checkpoint_every=0)
        scfg = trainer.DPSyncConfig(mode="flat", use_kernel=True)
        esync = trainer.EmbedSyncConfig(id_fns=recmodel.embed_id_fns())
        step = trainer.make_dp_train_step(
            lambda p, b: recmodel.recllm_loss(cfg, p, b, ctx)[0], mesh, tcfg,
            scfg, embed_sync=esync, params_shape=params0, adamw_kernel=True)
        n_res = trainer.residual_size(params0, scfg, exclude=esync.exclude)
        feeds = {"prefetch": lambda: Prefetcher(
                     iter(host[:PREFETCH_STEPS]), size=2, device=dev),
                 "direct": lambda: (place_batch(b, device=dev)
                                    for b in host[:PREFETCH_STEPS])}
        fed = {}
        for name, feed in feeds.items():
            params = tree_map(lambda p: p.clone(), params0)
            opt = adamw.init_opt_state(params)
            resid = torch.zeros(n_res, dtype=torch.float32, device=dev)
            losses, wall = [], []
            torch.cuda.synchronize()
            reset_launches()
            t1 = time.perf_counter()
            for b in feed():
                params, opt, resid, loss = step(params, opt, resid, b)
                losses.append(float(loss))
                t2 = time.perf_counter()
                wall.append((t2 - t1) * 1e3)
                t1 = t2
            launches = {k: v for k, v in read_launches().items() if v}
            check(len(losses) == PREFETCH_STEPS, f"prefetch {name}: "
                  f"{len(losses)} batches of {PREFETCH_STEPS}")
            want = {k: v * PREFETCH_STEPS for k, v in
                    PREFETCH_LAUNCHES.items()}
            check(launches == want, f"prefetch {name}: launches {launches}, "
                  f"want {want}")
            fed[name] = {"losses": losses, "launches": launches,
                         "step_ms_p50": statistics.median(wall[1:])}
            del params, opt, resid
        check(fed["prefetch"]["losses"] == fed["direct"]["losses"],
              f"prefetched losses {fed['prefetch']['losses']} differ from "
              f"the directly placed {fed['direct']['losses']}")
        report["prefetch"] = fed
        print(f"[async prefetch] the DP step (flat, fused AdamW, rows-"
              f"touched cf_user) on {PREFETCH_STEPS} batches: losses "
              f"{fed['direct']['losses'][0]:.5f} -> "
              f"{fed['direct']['losses'][-1]:.5f}, bit-equal through "
              "Prefetcher(size=2) and place_batch; launches " + ", ".join(
                  f"{k} {v}" for k, v in fed["direct"]["launches"].items())
              + f" both ways; step ms p50 {fed['prefetch']['step_ms_p50']:.1f}"
              f" prefetched, {fed['direct']['step_ms_p50']:.1f} placed on "
              f"the main thread ({card})")
        del step

        # -- (c) elastic resharding at one rank ----------------------------
        gc.collect()
        torch.cuda.empty_cache()
        batch = place_batch(host[0], device=dev)
        shape = ShapeConfig("recllm", TRAIN_SEQ, TRAIN_BATCH, "train")

        def hybrid_loss(p, b, c):
            return recmodel.recllm_loss(cfg, p, b, c)

        plan = auto_plan(cfg, mesh, shape, ParallelConfig())
        step, state, sh = _hybrid_state(torch, cfg, n_users, mesh, plan,
                                        tcfg, hybrid_loss, ctx, batch)
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)
        before = [x.clone() for x in tree_leaves(state["params"])
                  + tree_leaves(state["opt"])]
        new = elastic.make_mesh_for(1)
        check(new is not None and new.shape == {"data": 1, "model": 1},
              f"make_mesh_for(1) on one rank: {new}")
        plan2 = auto_plan(cfg, new, shape, ParallelConfig())
        _, shardings_for = trainer.make_hybrid_train_step(
            cfg, plan2, tcfg, hybrid_loss, params_shape=state["params"],
            ctx=ctx)
        psh, osh, _ = shardings_for(state["params"], batch)
        after = (tree_leaves(elastic.reshard(state["params"], psh,
                                             sh["params"]))
                 + tree_leaves(elastic.reshard(state["opt"], osh, sh["opt"])))
        check(len(after) == len(before) and all(
            a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(after, before)),
            "reshard onto make_mesh_for(1) is not the identity")
        kept = elastic.shrink_batch(batch, 1, 1)
        check(all(torch.equal(kept[k], batch[k]) for k in batch),
              "shrink_batch at one rank changed the batch")
        report["elastic"] = {"leaves": len(after), "identity": True}
        print(f"[async elastic] one-rank {dist.get_backend()} world: "
              f"make_mesh_for(1) {new.shape}; reshard of the hybrid step's "
              f"RecLLM-base state ({len(after)} leaves, after one step) the "
              "identity bit for bit; shrink_batch keeps the batch")
    finally:
        deterministic(torch, False)
        if dist.is_initialized():
            dist.destroy_process_group()
    return report

# MoE training: Qwen3-30B-A3B at published widths through the launcher,
# its depth cut to fit one card's 80 GB: 4 layers' resident state is 52.2
# GiB (bf16 params; float32 master, m, v and gradient sums: 18 bytes a
# parameter), printed by the phase beside the measured peak
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "qwen3-moe-30b-a3b", 4
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_MICRO = 6, 8, 512, 4
MOE_TRAIN_LR = 1e-4
# the reduced archs' hybrid step against a plain loop on the card
MOE_PARITY_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
MOE_PARITY_STEPS, MOE_PARITY_BATCH, MOE_PARITY_SEQ = 3, 8, 32
MOE_PARITY_RTOL = 1e-5


def phase_moe_training(torch, card):
    """MoE training through the hybrid step on a one-rank NCCL world (tp =
    dp = 1: expert parallelism and the dp-global aux losses reduce to the
    identity; the CPU tests hold their multi-rank form on gloo).  (a)
    Qwen3-30B-A3B at its published widths (d_model 2048, 32 q / 4 kv heads
    of 128, 128 experts of d_ff 768, top 8, vocab 151,936, untied), its
    first ``MOE_TRAIN_LAYERS`` layers, bf16, through ``launch/train.py``'s
    ``run``: 8 x 512 tokens in 4 micro-batches, 6 steps, lr 1e-4, remat
    off: losses finite, no kernel launched (the route kernels refuse
    autograd; training runs their plain version); step ms p50, tokens/s,
    peak memory, ``lb_loss`` / ``z_loss`` per step and the spread of the
    last step's expert loads.  (b) reduced Qwen3 and Moonlight in float32:
    the hybrid step's losses over 3 steps against a plain loop on the same
    device (``loss_fn``, ``backward``, ``adamw_apply``, no plan), within
    ``MOE_PARITY_RTOL`` relative."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.config import (ParallelConfig, ShapeConfig,
                                    TrainConfig, get_arch, reduced)
    from repro_torch.core import hierarchical, sharding
    from repro_torch.core.hybrid import auto_plan
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.obs import Tracer
    from repro_torch.optimizer import adamw, schedule
    from repro_torch.runtime import trainer
    from repro_torch.tree import tree_map
    dev = torch.device("cuda")
    report = {"card": card}
    tmp = tempfile.mkdtemp(prefix="moe_train_")
    try:
        # -- (a) Qwen3-30B-A3B at published widths --------------------------
        full = get_arch(MOE_TRAIN_ARCH)
        layers = MOE_TRAIN_LAYERS
        cfg = dataclasses.replace(full, num_layers=layers)
        n_params = cfg.num_params()
        print(f"[moe_training] {MOE_TRAIN_ARCH} at published widths "
              f"(d_model {cfg.d_model}, {cfg.num_heads} q / "
              f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, "
              f"{cfg.num_experts} experts of d_ff {cfg.d_ff} top "
              f"{cfg.experts_per_token}, vocab {cfg.vocab_size:,}), {layers} "
              f"of {full.num_layers} layers: {n_params:,} parameters, "
              f"resident state reckoned {n_params * 18 / 2**30:.1f} GiB")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tracer = Tracer()
        reset_launches()
        res, plan = train_launcher.run(train_launcher.parse_args([
            "--arch", MOE_TRAIN_ARCH, "--layers", str(layers),
            "--steps", str(MOE_TRAIN_STEPS), "--batch", str(MOE_TRAIN_BATCH),
            "--seq", str(MOE_TRAIN_SEQ), "--pp-micro", str(MOE_TRAIN_MICRO),
            "--lr", str(MOE_TRAIN_LR), "--remat", "off",
            "--ckpt-dir", os.path.join(tmp, "qwen3")]), tracer=tracer)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        check(len(res.losses) == MOE_TRAIN_STEPS and all(
            math.isfinite(x) for x in res.losses),
            f"{MOE_TRAIN_ARCH}: losses {res.losses}")
        check(not any(launches.values()),
              f"{MOE_TRAIN_ARCH} training launched kernels: "
              f"{ {k: v for k, v in launches.items() if v} }")
        check(len(res.aux) == MOE_TRAIN_STEPS,
              f"{MOE_TRAIN_ARCH}: {len(res.aux)} steps' aux")
        ms = sorted(1e3 * e["dur"] for e in tracer.events
                    if e["name"] == "train_step")
        p50 = float(np.median(ms))
        lb = [a["lb_loss"] for a in res.aux]
        z = [a["z_loss"] for a in res.aux]
        check(all(math.isfinite(x) for x in lb + z),
              f"aux losses lb {lb} z {z}")
        load = np.asarray(res.aux[-1]["expert_load"])
        spread = {"max_over_mean": float(load.max() / load.mean()),
                  "min_over_mean": float(load.min() / load.mean()),
                  "cv": float(load.std() / load.mean())}
        report["qwen3"] = {
            "layers": layers, "params": n_params, "losses": res.losses,
            "step_ms": ms, "step_ms_p50": p50,
            "tokens_per_s": MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (p50 / 1e3),
            "peak_bytes": peak, "lb_loss": lb, "z_loss": z,
            "load_spread": spread, "launches": launches,
            "notes": list(plan.notes), "remat": plan.remat}
        print(f"[moe_training] {MOE_TRAIN_ARCH} {layers} layers {cfg.dtype}, "
              f"batch {MOE_TRAIN_BATCH} x seq {MOE_TRAIN_SEQ} in "
              f"{plan.pcfg.microbatches} micro-batches, lr "
              f"{MOE_TRAIN_LR:g}, remat {plan.remat}: step ms p50 "
              f"{p50:.1f} (min {ms[0]:.1f}, max {ms[-1]:.1f}), "
              f"{report['qwen3']['tokens_per_s']:.0f} tokens/s; peak "
              f"{peak / 2**30:.2f} GiB; losses "
              f"{[round(x, 4) for x in res.losses]}; lb_loss "
              f"{[round(x, 4) for x in lb]}; z_loss "
              f"{[round(x, 4) for x in z]} (summed over {layers} layers); "
              f"last step's expert loads (all {cfg.experts_per_token} slots"
              f", {layers} layers): max/mean {spread['max_over_mean']:.3f}, "
              f"min/mean {spread['min_over_mean']:.3f}, cv "
              f"{spread['cv']:.3f}; no kernel launched ({card})")
        del res

        # -- (b) reduced archs: the hybrid step against a plain loop ------
        gc.collect()
        torch.cuda.empty_cache()
        hierarchical.init_world_of_one(dev)
        mesh = make_host_mesh()
        tcfg = TrainConfig(steps=20, learning_rate=1e-3, warmup_steps=1,
                           grad_clip=1.0, checkpoint_every=0)
        report["parity"] = {}
        for arch in MOE_PARITY_ARCHS:
            rcfg = dataclasses.replace(reduced(get_arch(arch)),
                                       dtype="float32")
            rng = np.random.default_rng(3)
            batches = [{
                "tokens": rng.integers(3, rcfg.vocab_size, (
                    MOE_PARITY_BATCH, MOE_PARITY_SEQ)),
                "targets": rng.integers(3, rcfg.vocab_size, (
                    MOE_PARITY_BATCH, MOE_PARITY_SEQ))}
                for _ in range(MOE_PARITY_STEPS)]
            batches = [{k: torch.from_numpy(v.astype(np.int32)).to(dev)
                        for k, v in b.items()} for b in batches]
            p0 = convert.init_params(
                rcfg, torch.Generator(device=dev).manual_seed(0), dev)
            plain = tree_map(torch.clone, p0)
            plan = auto_plan(rcfg, mesh, ShapeConfig(
                "moe", MOE_PARITY_SEQ, MOE_PARITY_BATCH, "train"),
                ParallelConfig())
            step, shardings_for = trainer.make_hybrid_train_step(
                rcfg, plan, tcfg, params_shape=p0)
            psh, _, _ = shardings_for(p0, batches[0])
            params = sharding.device_put(p0, psh)
            opt = trainer.init_hybrid_opt(rcfg, plan, params, p0)
            hybrid = []
            for b in batches:
                params, opt, m = step(params, opt, b)
                hybrid.append(float(m["loss"]))
            popt = adamw.init_opt_state(plain)
            ctx = tf.ModelCtx(flash_vjp=True)       # the step's at tp 1
            loop = []
            for b in batches:
                leaves = tree_map(lambda x: x.detach().requires_grad_(),
                                  plain)
                total, _ = tf.loss_fn(rcfg, leaves, b, ctx)
                total.backward()
                loop.append(float(total.detach()))
                lr = schedule.warmup_cosine(popt["step"], tcfg.learning_rate,
                                            tcfg.warmup_steps, tcfg.steps)
                plain, popt = adamw.adamw_apply(
                    plain, tree_map(lambda x: x.grad, leaves), popt, lr,
                    tcfg)
            worst = max(abs(a - b) / abs(b) for a, b in zip(hybrid, loop))
            check(worst <= MOE_PARITY_RTOL,
                  f"{arch} reduced: hybrid {hybrid} against the plain loop "
                  f"{loop}")
            report["parity"][arch] = {"hybrid": hybrid, "loop": loop,
                                      "max_rel": worst}
            print(f"[moe_training] {arch} reduced (float32, "
                  f"{rcfg.num_experts} experts top "
                  f"{rcfg.experts_per_token}), {MOE_PARITY_STEPS} steps of "
                  f"{MOE_PARITY_BATCH} x {MOE_PARITY_SEQ}: hybrid losses "
                  f"{[round(x, 6) for x in hybrid]} against the plain loop's "
                  f"within {worst:.2e} relative (limit {MOE_PARITY_RTOL:g})")
            del params, opt, plain, popt, step
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return report


RWKV_TRAIN_ARCH = "rwkv6-1.6b"
RWKV_TRAIN_STEPS, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ = 6, 8, 512
RWKV_TRAIN_MICRO, RWKV_TRAIN_LR = 4, 1e-4
RWKV_PARITY_STEPS, RWKV_PARITY_BATCH, RWKV_PARITY_SEQ = 3, 8, 64
RWKV_PARITY_RTOL = 1e-6


def rwkv6_layer_split(torch, cfg, card):
    """One rwkv6 layer at ``cfg``'s widths on one micro-batch of the
    training phase, forward and backward: the whole layer (remat off and
    on) and its chunked WKV alone (float32 r, k, v, w of the layer's
    shape).  For each: the wall ms (median of 3, the device synchronised
    around each), and from one profiled run the CUDA kernels launched and
    the device's busy ms (the union of their intervals)."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map
    dev = torch.device("cuda")
    one = dataclasses.replace(cfg, num_layers=1)
    blocks = convert.init_params(
        one, torch.Generator(device=dev).manual_seed(0), dev)["blocks"]
    B, T = RWKV_TRAIN_BATCH // RWKV_TRAIN_MICRO, RWKV_TRAIN_SEQ
    H, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    gen = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn((B, T, cfg.d_model), generator=gen, device=dev).to(
        getattr(torch, cfg.dtype))
    rkv = [torch.randn((B, T, H, hs), generator=gen, device=dev)
           for _ in range(3)]
    w0 = 0.9 + 0.1 * torch.rand((B, T, H, hs), generator=gen, device=dev)
    u0 = torch.zeros((H, hs), device=dev)

    def layer(remat):
        def run():
            params = {"blocks": tree_map(
                lambda t: t.detach().requires_grad_(), blocks)}
            x = x0.detach().requires_grad_()
            out = tf._rwkv_forward(one, params, x, tf.ModelCtx(remat=remat))
            out.float().square().mean().backward()
        return run

    def wkv():
        r, k, v, w, u = (t.detach().requires_grad_()
                         for t in (*rkv, w0, u0))
        o, S = ssm._wkv6_chunked(r, k, v, w, u)
        (o.square().mean() + S.square().mean()).backward()

    out = {}
    for name, fn in (("layer_remat_off", layer(False)),
                     ("layer_remat_on", layer(True)), ("wkv", wkv)):
        fn()                                    # warm
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        ev = _device_events(torch, fn)
        out[name] = {"wall_ms": float(np.median(walls)), "walls": walls,
                     "kernels": len(ev),
                     "busy_ms": _busy_ms([(a, b) for _, a, b in ev])}
        print(f"[rwkv6_training] split, {name} ({B} x {T} tokens, forward "
              f"+ backward): wall ms {out[name]['wall_ms']:.1f}, "
              f"{len(ev)} CUDA kernels, device busy "
              f"{out[name]['busy_ms']:.1f} ms ({card})")
    return out


def phase_rwkv6_training(torch, card):
    """rwkv6 training through the hybrid step on a one-rank NCCL world (tp
    = dp = 1: the time and channel mixes' collectives reduce to the
    identity; the CPU tests hold their multi-rank form on gloo).  (a)
    rwkv6-1.6b at its published widths, bf16, through ``launch/train.py``'s
    ``run``: 8 x 512 tokens in 4 micro-batches, 6 steps, lr 1e-4, remat off
    and then on: losses finite and falling, the peak under the card's
    memory, no kernel launched (the WKV runs its plain chunked form, which
    has a backward); step ms p50, tokens/s and peak memory.  (b) reduced
    rwkv6 in float32: the hybrid step's losses over 3 steps against a
    plain loop on the same device (``loss_fn``, ``backward``,
    ``adamw_apply``, no plan), within ``RWKV_PARITY_RTOL`` relative."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.config import (ParallelConfig, ShapeConfig,
                                    TrainConfig, get_arch, reduced)
    from repro_torch.core import hierarchical, sharding
    from repro_torch.core.hybrid import auto_plan
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.obs import Tracer
    from repro_torch.optimizer import adamw, schedule
    from repro_torch.runtime import trainer
    from repro_torch.tree import tree_leaves, tree_map
    dev = torch.device("cuda")
    report = {"card": card}
    tmp = tempfile.mkdtemp(prefix="rwkv_train_")
    try:
        # -- (a) rwkv6-1.6b at published widths, remat off then on -------
        cfg = get_arch(RWKV_TRAIN_ARCH)
        n_params = sum(x.numel() for x in tree_leaves(convert.init_params(
            cfg, torch.Generator(device=dev), "meta")))   # shapes only
        hbm = torch.cuda.get_device_properties(0).total_memory
        print(f"[rwkv6_training] {RWKV_TRAIN_ARCH} at published widths "
              f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.d_model // cfg.rwkv_head_size} heads of "
              f"{cfg.rwkv_head_size}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size:,}): {n_params:,} parameters, resident "
              f"state reckoned {n_params * 18 / 2**30:.2f} GiB; the card "
              f"holds {hbm / 2**30:.2f} GiB")
        runs = {}
        for remat in ("off", "on"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tracer = Tracer()
            reset_launches()
            res, plan = train_launcher.run(train_launcher.parse_args([
                "--arch", RWKV_TRAIN_ARCH, "--steps", str(RWKV_TRAIN_STEPS),
                "--batch", str(RWKV_TRAIN_BATCH),
                "--seq", str(RWKV_TRAIN_SEQ),
                "--pp-micro", str(RWKV_TRAIN_MICRO),
                "--lr", str(RWKV_TRAIN_LR), "--remat", remat,
                "--ckpt-dir", os.path.join(tmp, remat)]), tracer=tracer)
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            losses = res.losses
            check(len(losses) == RWKV_TRAIN_STEPS and all(
                math.isfinite(x) for x in losses),
                f"{RWKV_TRAIN_ARCH} remat {remat}: losses {losses}")
            check(losses[-1] < losses[0],
                  f"{RWKV_TRAIN_ARCH} remat {remat}: the loss did not fall "
                  f"({losses})")
            check(peak < hbm, f"{RWKV_TRAIN_ARCH} remat {remat}: peak "
                  f"{peak} of {hbm} bytes")
            check(not any(launches.values()),
                  f"{RWKV_TRAIN_ARCH} training launched kernels: "
                  f"{ {k: v for k, v in launches.items() if v} }")
            ms = sorted(1e3 * e["dur"] for e in tracer.events
                        if e["name"] == "train_step")
            p50 = float(np.median(ms))
            runs[remat] = {
                "losses": losses, "step_ms": ms, "step_ms_p50": p50,
                "tokens_per_s": RWKV_TRAIN_BATCH * RWKV_TRAIN_SEQ
                / (p50 / 1e3), "peak_bytes": peak, "launches": launches,
                "notes": list(plan.notes), "remat": plan.remat}
            print(f"[rwkv6_training] {RWKV_TRAIN_ARCH} {cfg.dtype}, batch "
                  f"{RWKV_TRAIN_BATCH} x seq {RWKV_TRAIN_SEQ} in "
                  f"{plan.pcfg.microbatches} micro-batches, lr "
                  f"{RWKV_TRAIN_LR:g}, remat {remat}: step ms p50 "
                  f"{p50:.1f} (min {ms[0]:.1f}, max {ms[-1]:.1f}), "
                  f"{runs[remat]['tokens_per_s']:.0f} tokens/s; peak "
                  f"{peak / 2**30:.2f} GiB; losses "
                  f"{[round(x, 4) for x in losses]}; every kernel counter "
                  f"0 ({card})")
            del res
        same = runs["on"]["losses"] == runs["off"]["losses"]
        gap = max(abs(a - b) for a, b in zip(runs["on"]["losses"],
                                             runs["off"]["losses"]))
        print(f"[rwkv6_training] remat on: peak "
              f"{runs['on']['peak_bytes'] / 2**30:.2f} GiB against "
              f"{runs['off']['peak_bytes'] / 2**30:.2f} GiB off; losses "
              f"{'equal to' if same else 'apart from'} remat off's (largest "
              f"difference {gap:.3e})")
        report["params"] = n_params
        report["full"] = runs

        # -- (c) where a step's time goes: one layer, one micro-batch ----
        report["split"] = rwkv6_layer_split(torch, cfg, card)

        # -- (b) reduced rwkv6: the hybrid step against a plain loop -----
        gc.collect()
        torch.cuda.empty_cache()
        hierarchical.init_world_of_one(dev)
        mesh = make_host_mesh()
        tcfg = TrainConfig(steps=20, learning_rate=1e-3, warmup_steps=1,
                           grad_clip=1.0, checkpoint_every=0)
        rcfg = dataclasses.replace(reduced(cfg), dtype="float32")
        rng = np.random.default_rng(3)
        batches = [{k: torch.from_numpy(rng.integers(3, rcfg.vocab_size, (
            RWKV_PARITY_BATCH, RWKV_PARITY_SEQ)).astype(np.int32)).to(dev)
            for k in ("tokens", "targets")}
            for _ in range(RWKV_PARITY_STEPS)]
        p0 = convert.init_params(
            rcfg, torch.Generator(device=dev).manual_seed(0), dev)
        plain = tree_map(torch.clone, p0)
        plan = auto_plan(rcfg, mesh, ShapeConfig(
            "rwkv", RWKV_PARITY_SEQ, RWKV_PARITY_BATCH, "train"),
            ParallelConfig())
        step, shardings_for = trainer.make_hybrid_train_step(
            rcfg, plan, tcfg, params_shape=p0)
        psh, _, _ = shardings_for(p0, batches[0])
        params = sharding.device_put(p0, psh)
        opt = trainer.init_hybrid_opt(rcfg, plan, params, p0)
        hybrid = []
        for b in batches:
            params, opt, m = step(params, opt, b)
            hybrid.append(float(m["loss"]))
        popt = adamw.init_opt_state(plain)
        ctx = tf.ModelCtx(flash_vjp=True)           # the step's at tp 1
        loop = []
        for b in batches:
            leaves = tree_map(lambda x: x.detach().requires_grad_(), plain)
            total, _ = tf.loss_fn(rcfg, leaves, b, ctx)
            total.backward()
            loop.append(float(total.detach()))
            lr = schedule.warmup_cosine(popt["step"], tcfg.learning_rate,
                                        tcfg.warmup_steps, tcfg.steps)
            plain, popt = adamw.adamw_apply(
                plain, tree_map(lambda x: x.grad, leaves), popt, lr, tcfg)
        worst = max(abs(a - b) / abs(b) for a, b in zip(hybrid, loop))
        check(worst <= RWKV_PARITY_RTOL,
              f"rwkv6 reduced: hybrid {hybrid} against the plain loop "
              f"{loop}")
        report["parity"] = {"hybrid": hybrid, "loop": loop,
                            "max_rel": worst}
        print(f"[rwkv6_training] rwkv6 reduced (float32, "
              f"{rcfg.num_layers} layers, d_model {rcfg.d_model}), "
              f"{RWKV_PARITY_STEPS} steps of {RWKV_PARITY_BATCH} x "
              f"{RWKV_PARITY_SEQ}: hybrid losses "
              f"{[round(x, 6) for x in hybrid]} against the plain loop's "
              f"within {worst:.2e} relative (limit {RWKV_PARITY_RTOL:g})")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return report


def deterministic(torch, on):
    """Deterministic algorithms on or off (uninitialised memory left
    unfilled while on, as the training phases run)."""
    torch.use_deterministic_algorithms(on)
    torch.utils.deterministic.fill_uninitialized_memory = not on


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write the full report (every case's error, "
                         "the timings, the serve summaries) as JSON here")
    ap.add_argument("--wkv6-against", default="", metavar="TREE",
                    help="instead of the phases: time the WKV kernel of "
                         "the checkout at TREE and this one's in turns "
                         "(the timed shapes and rwkv6's dense serve run)")
    ap.add_argument("--wkv6-probe", default="", help=argparse.SUPPRESS)
    ap.add_argument("--moe-against", default="", metavar="TREE",
                    help="instead of the phases: serve the MoE archs with "
                         "the checkout at TREE and this one in turns "
                         "(routing device time, TTFT, TPOT, kernels a "
                         "decode step, greedy streams under every layout)")
    ap.add_argument("--moe-probe", default="", help=argparse.SUPPRESS)

    args = ap.parse_args(argv)
    # cuBLAS on a fixed workspace configuration, which torch requires to run
    # cuBLAS under deterministic algorithms (the training phase)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if args.wkv6_probe:
        print(json.dumps(wkv6_probe(torch, args.wkv6_probe)))
        return 0
    if args.moe_probe:
        print(json.dumps(moe_probe(torch, args.moe_probe)))
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    if args.wkv6_against:
        try:
            result = wkv6_against(torch, pathlib.Path(args.wkv6_against))
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"wkv6_turns": result}))
        return 0
    if args.moe_against:
        try:
            result = moe_against(torch, pathlib.Path(args.moe_against))
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"moe_turns": result}))
        return 0
    report = {"phase_s": {}}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, *args)
        report["phase_s"][name] = time.perf_counter() - t0
        print(f"[phase {name}] {report['phase_s'][name]:.1f} s")
        return out

    try:
        report["device"] = timed("device", phase_device)
        # the compression phase runs before the first profiler session:
        # run after one, its work left every later trace of the script
        # empty (torch 2.11, CUDA 12.8, H100), the torch kernels' too
        compress = timed("compress_kernels", phase_compress_kernels,
                         {"timing": {}})
        report["kernels"] = timed("kernels", phase_kernels)
        report["kernels"]["timing"].update(compress["timing"])
        for name, fn in (("embed_kernels", phase_embed_kernels),
                         ("router_kernel", phase_router_kernel),
                         ("wkv6_kernel", phase_wkv6_kernel)):
            timed(name, fn, report["kernels"])
        timed("autograd_guard", check_autograd_guard)
        report["serving"] = timed("serving", phase_serving)
        report["spec_serving"] = timed(
            "spec_serving", phase_spec_serving,
            report["serving"].pop("f32_one_token"))
        report["cf_serving"] = timed("cf_serving", phase_cf_serving,
                                     report["device"]["card"])
        report["moe_serving"] = timed("moe_serving", phase_moe_serving)
        report["rwkv6_serving"] = timed("rwkv6_serving", phase_rwkv6_serving)
        report["training"] = timed("training", phase_training)
        report["hybrid_training"] = timed("hybrid_training",
                                          phase_hybrid_training,
                                          report["device"]["card"])
        report["pipelined_training"] = timed(
            "pipelined_training", phase_pipelined_training,
            report["device"]["card"], report["hybrid_training"])
        report["sharded_cf"] = timed("sharded_cf", phase_sharded_cf,
                                     report["device"]["card"])
        report["async_dp"] = timed("async_dp", phase_async_dp,
                                   report["device"]["card"])
        report["moe_training"] = timed("moe_training", phase_moe_training,
                                       report["device"]["card"])
        report["rwkv6_training"] = timed("rwkv6_training",
                                         phase_rwkv6_training,
                                         report["device"]["card"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if args.out:
            out = pathlib.Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1, default=str))

    # launches: each kernel's count in the serve or train run of its own
    # path (moe_router's in the MoE serve run, which no longer launches it)
    path_of = {"flash_attention": ("serving", "dense"),
               "flash_decode": ("serving", "dense"),
               **{kname: ("serving", name)
                  for name, (_, kname) in LAYOUTS.items()},
               "onebit_quantize": ("training", "onebit"),
               "onebit_dequantize": ("training", "onebit"),
               "topk_sparsify": ("training", "topk_embed"),
               "topk_select": ("training", "topk"),
               "gather_rows": ("training", "flat_embed"),
               "scatter_add_rows": ("training", "flat_embed"),
               "adamw_update": ("training", "flat_fused_adamw"),
               "moe_router": ("moe_serving", "moonlight_dense"),
               "moe_route": ("moe_serving", "moonlight_dense"),
               "wkv6_chunked": ("rwkv6_serving", "dense")}
    # gather_rows also runs on the CF head's serve path: its launches there
    # and its device ms a call from that run's profile
    cf = report["cf_serving"]
    cf_serve = {"launches_uncached":
                cf["runs"]["uncached"]["launches"]["gather_rows"],
                "launches_cached":
                cf["runs"]["cached"]["launches"]["gather_rows"],
                "device_ms": cf["gather_rows_device_ms"]}
    # ... and on the sharded heads' path (the same counts under every plan)
    sharded = report["sharded_cf"]["serve"]
    cf_serve["sharded"] = {
        "launches": {k: v["gather_rows"]
                     for k, v in sharded["launches"].items()},
        "device_ms_row": sharded["gather_rows_device_ms"]}
    # the k-row verify: each decode entry point at the verify shape and its
    # launches in the bf16 spec run of its layout; the route kernel's in
    # Moonlight's spec run (groups of the verify rows)
    spec = report["spec_serving"]
    spec_of = {kname: dict(report["kernels"]["verify"][kname],
                           launches=spec["runs"][
        f"bf16_{name}_k{SPEC_K}" + ("_1" if name == "dense" else "")][
        "launches"][kname]) for name, kname in
        [("dense", "flash_decode")] + [(n, kn) for n, (_, kn) in
                                       LAYOUTS.items()]}
    spec_of["moe_route"] = {"launches": spec["runs"][
        f"{SPEC_MOE[0]}_f32_dense_k{SPEC_K}"]["launches"]["moe_route"]}
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        t = report["kernels"]["timing"][name][0]     # the main-path shape
        phase, run = path_of[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            **({"also_replaces": ALSO_REPLACES[name]}
               if name in ALSO_REPLACES else {}),
            **({"off_path": OFF_PATH[name]} if name in OFF_PATH else {}),
            "launches": report[phase]["runs"][run]["launches"][name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], **({"cf_serve": cf_serve}
                                    if name == "gather_rows" else {}),
            **({"spec_verify": spec_of[name]} if name in spec_of else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
