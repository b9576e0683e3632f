"""Post-simulation analytics reproducing the paper's Table 2 and Figs 6-9.

Host-side numpy over :class:`repro_torch.core.simulator.SimResult`; the
same functions as ``repro.core.stats``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.simulator import SimResult


@dataclasses.dataclass
class DiffSummary:
    """Paper Table 2 row: MemSimCycles - DRAMSimCycles per request class.

    A class with zero completed requests (a degenerate lane: tiny horizon,
    read-only / write-only trace, empty record slice) carries NaN averages
    with its count field as the explicit flag — ``n_read`` / ``n_write``
    say how many requests the statistics summarize, and rendering helpers
    (:func:`fmt_diff`, :func:`format_table2`) print ``n/a`` instead of
    leaking ``nan`` into Table-2 rows.
    """

    read_diff_avg: float
    read_diff_std: float
    write_diff_avg: float
    write_diff_std: float
    n_read: int
    n_write: int


def _mean_std(x: np.ndarray) -> Tuple[float, float]:
    """(mean, std) with an explicit empty-slice guard: no numpy
    mean-of-empty RuntimeWarning, no 0/0 — just the NaN sentinel the count
    flags explain."""
    if x.size == 0:
        return float("nan"), float("nan")
    return float(np.mean(x)), float(np.std(x))


def cycle_diffs(result: SimResult, ideal_complete: np.ndarray) -> DiffSummary:
    """Per-request cycle differences vs the ideal model (completed only)."""
    done = result.completed & (ideal_complete >= 0)
    mem_lat = result.t_complete - result.t_admit
    ideal_lat = ideal_complete - result.t_intended
    diff = mem_lat - ideal_lat
    rd = done & (result.is_write == 0)
    wr = done & (result.is_write == 1)

    r_avg, r_std = _mean_std(diff[rd])
    w_avg, w_std = _mean_std(diff[wr])
    return DiffSummary(r_avg, r_std, w_avg, w_std, int(rd.sum()), int(wr.sum()))


def latency_summary(result: SimResult) -> Dict[str, float]:
    """Latency statistics of the completed requests.

    Degenerate lanes are first-class: with zero completed requests (or
    zero of one request class) every affected statistic is NaN and the
    ``completed`` / ``total`` counts are the explicit flag — callers render
    or filter on the counts, never on NaN comparisons. No empty-slice
    warning or divide-by-zero escapes.
    """
    done = result.completed
    lat = result.latency[done]
    rd = result.is_write[done] == 0
    mean, std = _mean_std(lat)
    read_mean, _ = _mean_std(lat[rd])
    write_mean, _ = _mean_std(lat[~rd])
    return {
        "mean": mean,
        "std": std,
        "read_mean": read_mean,
        "write_mean": write_mean,
        "p50": float(np.percentile(lat, 50)) if lat.size else float("nan"),
        "p95": float(np.percentile(lat, 95)) if lat.size else float("nan"),
        "p99": float(np.percentile(lat, 99)) if lat.size else float("nan"),
        "completed": int(done.sum()),
        "total": int(done.size),
    }


def latency_percentiles(x: np.ndarray,
                        qs: Tuple[int, ...] = (50, 95, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` of a latency sample,
    NaN-with-count on empty input per the ``_mean_std`` convention (the
    serving studies report these for per-request queueing and service
    times, and an idle lane — zero completions in a window or a whole
    study point — must flag, not raise)."""
    x = np.asarray(x, np.float64).ravel()
    out = {f"p{q}": (float(np.percentile(x, q)) if x.size else float("nan"))
           for q in qs}
    out["n"] = int(x.size)
    return out


def windowed_profile(result: SimResult, window: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
    """Paper Fig 6: average latency of requests completing in each window.

    Returns (window_start_cycles, mean_latency) with NaN for empty windows.
    """
    done = result.completed
    tc = result.t_complete[done]
    lat = result.latency[done]
    nbins = max(1, int(np.ceil(result.num_cycles / window)))
    bins = np.clip(tc // window, 0, nbins - 1)
    sums = np.bincount(bins, weights=lat.astype(np.float64), minlength=nbins)
    cnts = np.bincount(bins, minlength=nbins)
    with np.errstate(invalid="ignore"):
        means = np.where(cnts > 0, sums / np.maximum(cnts, 1), np.nan)
    return np.arange(nbins) * window, means


def latency_breakdown(result: SimResult) -> Dict[str, float]:
    """Paper Fig 8: average latency split into its constituents.

    * ``req_queue``  — admission to dispatch (the global queue stage)
    * ``bank_queue`` — dispatch to service start (scheduler local queue)
    * ``service``    — service start to front-end ack (ACT/RW/PRE + response)
    * ``reqqueue_struct`` / ``_pct`` — req_queue + bank_queue combined: the
      paper's Fig 3 defines "the reqQueue data structure" as the global
      queue PLUS the per-scheduler queues, so its "reqQueue backpressure"
      corresponds to this composite.
    """
    done = result.completed & (result.t_dispatch >= 0) & (result.t_start >= 0)
    if not done.any():
        return {"req_queue": 0.0, "bank_queue": 0.0, "service": 0.0,
                "req_queue_pct": 0.0, "bank_queue_pct": 0.0, "service_pct": 0.0}
    w_req = (result.t_dispatch - result.t_admit)[done].astype(np.float64)
    w_bank = (result.t_start - result.t_dispatch)[done].astype(np.float64)
    w_srv = (result.t_complete - result.t_start)[done].astype(np.float64)
    tot = float((w_req + w_bank + w_srv).mean())
    parts = {
        "req_queue": float(w_req.mean()),
        "bank_queue": float(w_bank.mean()),
        "service": float(w_srv.mean()),
    }
    for k in list(parts):
        parts[f"{k}_pct"] = 100.0 * parts[k] / tot if tot > 0 else 0.0
    parts["reqqueue_struct"] = parts["req_queue"] + parts["bank_queue"]
    parts["reqqueue_struct_pct"] = (parts["req_queue_pct"]
                                    + parts["bank_queue_pct"])
    return parts


def pareto_point(result: SimResult) -> Tuple[int, float]:
    """Paper Fig 9: (completed requests, average latency) operating point."""
    s = latency_summary(result)
    return s["completed"], s["mean"]


def records_at_horizon(result: SimResult, horizon: int) -> SimResult:
    """Per-request records as a shorter run of ``horizon`` cycles would
    have produced them.

    The simulator is causal: the state at cycle ``c`` never depends on
    later cycles, so a record stamped at cycle < ``horizon`` is identical
    between a ``horizon``-cycle run and any longer run, and a record the
    shorter run never stamped stays -1. This derives the paper's Fig 9
    operating points (30k-cycle horizon) from the full 100k-cycle sweep
    without re-simulating. Only the ``t_*`` record fields are derived;
    ``rdata`` keeps full-run values (a read whose column access landed
    before the horizon but whose ack did not would differ), and aggregate
    cycle counters (``counters``, ``blocked_*``) cover the full run and are
    zeroed here to prevent misuse.
    """
    if horizon > result.num_cycles:
        raise ValueError(f"horizon {horizon} exceeds simulated "
                         f"{result.num_cycles} cycles")

    def cut(x: np.ndarray) -> np.ndarray:
        return np.where((x >= 0) & (x < horizon), x, -1)

    return SimResult(
        cfg=result.cfg,
        num_cycles=horizon,
        t_intended=result.t_intended,
        is_write=result.is_write,
        t_admit=cut(result.t_admit),
        t_dispatch=cut(result.t_dispatch),
        t_start=cut(result.t_start),
        t_complete=cut(result.t_complete),
        rdata=result.rdata,
        counters={k: np.zeros_like(np.asarray(v))
                  for k, v in result.counters.items()},
        blocked_arrival=0,
        blocked_dispatch=0,
    )


def fmt_diff(value: float, n: int) -> str:
    """Render one Table-2 statistic: ``n/a`` for a class with no completed
    requests (the NaN-with-flag convention of :class:`DiffSummary`) instead
    of leaking the string ``nan`` into the table."""
    return f"{value:.0f}" if n > 0 else "n/a"


def format_table2(rows: List[Tuple[str, DiffSummary]]) -> str:
    out = ["| Benchmark | Read Diff Avg | Read StdDev | Write Diff Avg | Write StdDev |",
           "|---|---|---|---|---|"]
    for name, d in rows:
        out.append(
            f"| {name} | {fmt_diff(d.read_diff_avg, d.n_read)} "
            f"| {fmt_diff(d.read_diff_std, d.n_read)} "
            f"| {fmt_diff(d.write_diff_avg, d.n_write)} "
            f"| {fmt_diff(d.write_diff_std, d.n_write)} |"
        )
    return "\n".join(out)
