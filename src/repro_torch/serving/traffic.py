"""Recsys request-traffic simulator: reproducible "millions of users"
scenarios scaled down to whatever the host can serve.

Real recommendation traffic is far from i.i.d.:

* arrivals are Poisson at quiet hours but *bursty* around pushes and sales
  events — modeled as a two-state modulated Poisson process (ON periods
  arrive ``burst_factor`` x faster than OFF periods);
* user popularity is Zipfian (a head of power users dominates), so the same
  user histories recur — prompts for one user share a seeded history prefix,
  which is what makes request-level caching worthwhile downstream;
* prompt lengths (user-history length) are Zipf-distributed with a long
  tail clipped to the serving window;
* requests carry an SLO tier: ``interactive`` ranking calls with tight
  TTFT, and ``batch`` re-scoring calls that only care about completion.

Everything is driven by one seed; two calls to :func:`generate` with the
same config produce identical workloads.

A numpy copy of ``repro/serving/traffic.py`` (without the prefill-burst
scenario, which comes with disaggregated serving): the same config and seed
give the same requests, field for field, in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLOTier:
    name: str
    ttft_ms: float
    tpot_ms: float


INTERACTIVE_TIER = SLOTier("interactive", ttft_ms=500.0, tpot_ms=100.0)
BATCH_TIER = SLOTier("batch", ttft_ms=5_000.0, tpot_ms=1_000.0)


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    user_id: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival: float                      # seconds since sim start
    slo: SLOTier = BATCH_TIER
    eos_id: int = -1                    # -1: never stop early
    temperature: float = 0.0            # <= 0: greedy decode
    top_k: int = 0                      # 0: no top-k filtering
    # encoder-decoder families (whisper): per-request encoder frames
    # (F, d_model) as nested tuples so Request stays hashable/comparable;
    # the engine computes the slot's cross-KV from these at admission.
    frames: Optional[Tuple[Tuple[float, ...], ...]] = None
    # vlm prompts (qwen2-vl): the prompt's leading image-patch grid
    # (grid_h, grid_w) — grid_h*grid_w patch tokens precede the text.
    # Drives the request's multimodal-RoPE position layout at prefill and
    # the per-token position advance at decode.
    grid: Optional[Tuple[int, int]] = None
    # recsys retrieval->rank: the candidate item ids this request asks to
    # be scored (CF head + LM fusion); None = plain LM request.
    candidates: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    n_requests: int = 64
    rate: float = 32.0                  # mean requests/s
    process: str = "poisson"            # poisson | bursty
    burst_factor: float = 6.0           # ON-state rate multiplier
    burst_switch_p: float = 0.15        # per-arrival state-flip probability
    n_users: int = 10_000
    zipf_users: float = 1.2             # user-popularity skew (>1)
    prompt_min: int = 4
    prompt_max: int = 48
    zipf_prompt: float = 1.4            # prompt-length tail (>1)
    new_tokens_min: int = 4
    new_tokens_max: int = 24
    interactive_fraction: float = 0.75
    vocab_size: int = 256
    eos_id: int = -1
    temperature: float = 0.0            # per-request sampling (0 = greedy)
    top_k: int = 0
    encoder_frames: int = 0             # >0: attach (F, frame_dim) frames
    frame_dim: int = 0                  # (enc-dec families, e.g. whisper)
    frame_scale: float = 0.02
    image_grid: Tuple[int, int] = ()    # (gh, gw): vlm requests carry a
                                        # gh x gw patch-token prompt prefix
    image_fraction: float = 1.0         # share of requests with an image
    # recsys retrieval->rank: candidate ids per request (0 = none).
    # Head-heavy (Zipfian item popularity) — the distribution that makes
    # the hot-row cache pay — and drawn from a separate per-request rng
    # stream, so the base workload stays byte-identical with candidates
    # on or off.
    candidates: int = 0
    zipf_items: float = 1.3             # candidate-popularity skew (>1)
    seed: int = 0


def _bounded_zipf(rng: np.random.Generator, a: float, lo: int, hi: int,
                  size: int) -> np.ndarray:
    """Zipf(a) shifted to [lo, hi] by rejection-free clipping."""
    x = lo - 1 + rng.zipf(a, size=size)
    return np.clip(x, lo, hi)


def _arrival_times(cfg: TrafficConfig, rng: np.random.Generator) -> np.ndarray:
    if cfg.process == "poisson":
        gaps = rng.exponential(1.0 / cfg.rate, size=cfg.n_requests)
    elif cfg.process == "bursty":
        # two-state modulated Poisson: per-arrival geometric state dwell
        gaps = np.empty(cfg.n_requests)
        on = False
        for i in range(cfg.n_requests):
            if rng.random() < cfg.burst_switch_p:
                on = not on
            r = cfg.rate * cfg.burst_factor if on else cfg.rate / 2.0
            gaps[i] = rng.exponential(1.0 / r)
    else:
        raise ValueError(f"unknown arrival process {cfg.process!r}")
    return np.cumsum(gaps)


def _candidate_set(cfg: TrafficConfig, rid: int) -> Tuple[int, ...]:
    """Head-heavy candidate item ids for one request.

    Zipf(``zipf_items``) over the item vocabulary: a popularity-biased
    retrieval stage mostly proposes the same head of hot items across
    requests (repeats across — and occasionally within — a set are the
    point).  The rng is seeded from (seed, rid) alone, never the shared
    workload stream, so turning candidates on/off cannot perturb
    arrivals, users, prompts, or SLO assignment.
    """
    crng = np.random.default_rng((cfg.seed, 0x5EED5, rid))
    ids = _bounded_zipf(crng, cfg.zipf_items, 1, cfg.vocab_size,
                        cfg.candidates) - 1
    return tuple(int(i) for i in ids)


def _user_prompt(cfg: TrafficConfig, user_id: int, length: int,
                 rng: np.random.Generator) -> Tuple[int, ...]:
    """User-history prompt: a per-user deterministic history stream plus a
    fresh per-request suffix (the "new interactions since last visit")."""
    hist_rng = np.random.default_rng(cfg.seed * 1_000_003 + user_id)
    history = hist_rng.integers(3, cfg.vocab_size,
                                size=max(cfg.prompt_max, length))
    fresh = max(1, length // 4)
    suffix = rng.integers(3, cfg.vocab_size, size=fresh)
    tokens = np.concatenate([history[:length - fresh], suffix])
    return tuple(int(t) for t in tokens)


def generate(cfg: TrafficConfig) -> List[Request]:
    """The full workload, sorted by arrival time."""
    if cfg.prompt_max < cfg.prompt_min:
        raise ValueError(f"prompt_max {cfg.prompt_max} < prompt_min "
                         f"{cfg.prompt_min}")
    if cfg.new_tokens_max < cfg.new_tokens_min:
        raise ValueError(f"new_tokens_max {cfg.new_tokens_max} < "
                         f"new_tokens_min {cfg.new_tokens_min}")
    rng = np.random.default_rng(cfg.seed)
    arrivals = _arrival_times(cfg, rng)
    users = _bounded_zipf(rng, cfg.zipf_users, 1, cfg.n_users,
                          cfg.n_requests) - 1
    lengths = _bounded_zipf(rng, cfg.zipf_prompt, cfg.prompt_min,
                            cfg.prompt_max, cfg.n_requests)
    new_tokens = rng.integers(cfg.new_tokens_min, cfg.new_tokens_max + 1,
                              size=cfg.n_requests)
    interactive = rng.random(cfg.n_requests) < cfg.interactive_fraction

    reqs = []
    for i in range(cfg.n_requests):
        frames = None
        if cfg.encoder_frames and cfg.frame_dim:
            f = rng.normal(0.0, cfg.frame_scale,
                           (cfg.encoder_frames, cfg.frame_dim))
            frames = tuple(tuple(float(x) for x in row) for row in f)
        grid = None
        if cfg.image_grid and rng.random() < cfg.image_fraction:
            gh, gw = cfg.image_grid
            if gh * gw < int(lengths[i]):   # patches must leave text room
                grid = (int(gh), int(gw))
        reqs.append(Request(
            rid=i,
            user_id=int(users[i]),
            prompt=_user_prompt(cfg, int(users[i]), int(lengths[i]), rng),
            max_new_tokens=int(new_tokens[i]),
            arrival=float(arrivals[i]),
            slo=INTERACTIVE_TIER if interactive[i] else BATCH_TIER,
            eos_id=cfg.eos_id,
            temperature=cfg.temperature,
            top_k=cfg.top_k,
            frames=frames,
            grid=grid,
            candidates=(_candidate_set(cfg, i) if cfg.candidates > 0
                        else None),
        ))
    return reqs


class Clock:
    """Simulated clock the engine advances: by measured model wall time for
    each compute call, and by arbitrary jumps when idle-waiting for the next
    arrival.  Tests can pin per-call costs to get deterministic timelines."""

    def __init__(self, fixed_decode_s: Optional[float] = None,
                 fixed_prefill_s: Optional[float] = None,
                 fixed_handoff_s: Optional[float] = None,
                 fixed_cf_s: Optional[float] = None):
        self.now = 0.0
        self.fixed_decode_s = fixed_decode_s
        self.fixed_prefill_s = fixed_prefill_s
        self.fixed_handoff_s = fixed_handoff_s
        self.fixed_cf_s = fixed_cf_s

    def advance(self, dt: float) -> None:
        assert dt >= 0.0
        self.now += dt
