"""Serving scenarios: arrival processes and request-length mixtures.

Open-loop trace generators bake the request *and* its timing into one
array; here a scenario is just the demand side — WHEN requests arrive and
HOW LONG they are. What memory traffic they cause, and when, is decided
window by window by the closed-loop scheduler reacting to completions.

Arrival processes (all in requests per kilocycle, deterministic per seed):

* ``poisson`` — homogeneous Poisson: exponential inter-arrival gaps.
* ``bursty``  — on/off modulated Poisson (an on-phase at ``burst_factor``
  x the base rate, an off-phase near zero), the bursty-tenant pattern.
* ``diurnal`` — sinusoid-modulated Poisson over ``period`` cycles, the
  day/night load curve scaled down to simulator horizons.

Length mixtures (prompt tokens, decode tokens):

* ``chat``      — short prompts, short-to-medium generations.
* ``summarize`` — long prompts, short generations (prefill-heavy).
* ``mixed``     — a 70/30 draw of the two.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

ARRIVAL_PROCESSES = ("poisson", "bursty", "diurnal")
MIXTURES = ("chat", "summarize", "mixed")


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: arrives at ``arrival`` (cycle), needs
    ``prompt_tokens`` of prefill and ``decode_tokens`` generated tokens."""

    rid: int
    arrival: int
    prompt_tokens: int
    decode_tokens: int


def _thin(rng: np.random.Generator, horizon: int, rate_per_kcycle: float,
          intensity) -> np.ndarray:
    """Nonhomogeneous Poisson arrivals by thinning: draw at the peak rate,
    keep each point with probability ``intensity(t) <= 1``."""
    peak = rate_per_kcycle / 1000.0
    if peak <= 0:
        return np.zeros((0,), np.int64)
    gaps = rng.exponential(1.0 / peak, size=max(8, int(peak * horizon * 2) + 8))
    t = np.cumsum(gaps)
    t = t[t < horizon]
    keep = rng.random(t.size) < np.clip(intensity(t), 0.0, 1.0)
    return np.sort(t[keep]).astype(np.int64)


def arrival_times(process: str, rate_per_kcycle: float, horizon: int,
                  rng: np.random.Generator, *, burst_factor: float = 4.0,
                  period: int = 20_000) -> np.ndarray:
    """Arrival cycles of one scenario (sorted int64)."""
    if process == "poisson":
        return _thin(rng, horizon, rate_per_kcycle, lambda t: np.ones_like(t))
    if process == "bursty":
        # on-phase at burst_factor x base for 1/burst_factor of each period:
        # same mean rate as the Poisson scenario, concentrated into bursts
        on_frac = 1.0 / burst_factor
        return _thin(rng, horizon, rate_per_kcycle * burst_factor,
                     lambda t: ((t % period) < on_frac * period).astype(float))
    if process == "diurnal":
        return _thin(rng, horizon, rate_per_kcycle * 2.0,
                     lambda t: 0.5 * (1.0 + np.sin(2 * np.pi * t / period)))
    raise ValueError(
        f"unknown arrival process {process!r}; valid: {ARRIVAL_PROCESSES}")


def sample_lengths(mixture: str, n: int,
                   rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(prompt_tokens, decode_tokens) draws of one mixture."""
    def chat(k):
        return (rng.integers(2, 9, k), rng.integers(4, 17, k))

    def summarize(k):
        return (rng.integers(16, 49, k), rng.integers(2, 7, k))

    if mixture == "chat":
        p, d = chat(n)
    elif mixture == "summarize":
        p, d = summarize(n)
    elif mixture == "mixed":
        pick = rng.random(n) < 0.7
        pc, dc = chat(n)
        ps, ds = summarize(n)
        p = np.where(pick, pc, ps)
        d = np.where(pick, dc, ds)
    else:
        raise ValueError(f"unknown mixture {mixture!r}; valid: {MIXTURES}")
    return p.astype(np.int64), d.astype(np.int64)


def generate_requests(process: str = "poisson", mixture: str = "chat",
                      rate_per_kcycle: float = 1.0, horizon: int = 40_000,
                      seed: int = 0, *, burst_factor: float = 4.0,
                      period: int = 20_000) -> List[Request]:
    """One serving scenario: arrivals of ``process`` at ``rate_per_kcycle``
    over ``horizon`` cycles, lengths from ``mixture``. Deterministic per
    seed (the closed-loop backpressure tests rely on this)."""
    rng = np.random.default_rng(seed)
    t = arrival_times(process, rate_per_kcycle, horizon, rng,
                      burst_factor=burst_factor, period=period)
    p, d = sample_lengths(mixture, t.size, rng)
    return [Request(rid=i, arrival=int(t[i]), prompt_tokens=int(p[i]),
                    decode_tokens=int(d[i])) for i in range(t.size)]


def spawn_seeds(seed: int, lanes: int) -> List[int]:
    """``lanes`` independent child seeds of ``seed`` (SeedSequence spawn),
    for per-lane request streams that must not be correlated across the
    lanes of a batched study. Deterministic per (seed, lanes)."""
    ss = np.random.SeedSequence(seed)
    return [int(child.generate_state(1)[0]) for child in ss.spawn(lanes)]


def generate_request_batch(scenarios, seed: int = 0, *,
                           independent_streams: bool = True
                           ) -> List[List[Request]]:
    """One request list per lane. ``scenarios`` is a sequence of
    :func:`generate_requests` kwargs dicts (without ``seed``); with
    ``independent_streams`` each lane draws from its own
    :func:`spawn_seeds` child stream, otherwise every lane reuses ``seed``
    verbatim (the serving study does this so its batched and sequential
    paths feed identical scenarios)."""
    scenarios = list(scenarios)
    seeds = (spawn_seeds(seed, len(scenarios)) if independent_streams
             else [seed] * len(scenarios))
    return [generate_requests(**sc, seed=s)
            for sc, s in zip(scenarios, seeds)]
