"""Streaming sweep executor: chunked lanes under a memory budget, one
lane-batched K3 launch a chunk, kill/resume checkpointing.

PyTorch counterpart of ``repro.core.sweep_stream``. The materialising
sweeps (:func:`repro_torch.core.engine.sweep_grid` /
:func:`~repro_torch.core.engine.sweep_topologies`) set up every lane of
the grid at once: fine at 10^3 points, hopeless at the 10^4-10^6-point
campaigns where the lanes' state alone exceeds device memory and a crash
loses hours of work. Both route here under the reference's condition
(``stream=True``, a ``checkpoint_dir``, or at least
:func:`~repro_torch.core.engine._stream_threshold` points):

* **Chunking under a memory budget**: the lane space is split,
  topology-major, into chunks of ``chunk_lanes`` lanes, given or derived
  from ``memory_budget_bytes`` by :func:`lane_footprint_bytes` (the
  budget covers the running chunk and the next one). The reference pads
  a topology's last chunk with sentinel lanes to reuse one compiled
  shape; the port's kernel takes any lane count, so no chunk is padded.

* **One launch a chunk, pipelined**: each chunk is one
  ``engine._start_batch``, on the card one launch of the lane-batched K3
  (``fused_run_batch_kernel``) unless the run budget relaunches it. From
  one thread, chunk N+1 is set up and its launch enqueued on its own CUDA
  stream before chunk N is read, so the card runs chunk N+1 while the
  host copies chunk N's records, checkpoints it and frees its device
  state: at most two chunks are alive, which is what the budget reckons.
  Every form of the kernel is loaded before the first launch.

* **Persistent kernels**: the kernel libraries come from
  :func:`repro_torch.kernels.build.load`, which with
  ``MEMSIM_EXEC_CACHE_DIR`` set loads them from the persistent cache
  (:mod:`repro_torch.core.exec_cache`): a warm re-invoke in a fresh
  process runs ``nvcc`` zero times.

* **Kill/resume**: with ``checkpoint_dir`` set, every finished chunk's
  records publish atomically through
  :class:`repro_torch.checkpoint.store.SweepCheckpoint` beside a manifest
  fingerprinting the whole sweep (points, lane configs, schedules, traces,
  horizon, chunking). A killed sweep re-invoked with the same arguments
  resumes from the committed chunks; a manifest of another sweep raises
  ``ValueError`` under ``resume=True`` (``resume=False`` clears it). The
  fingerprints and the files are the reference's, so a manifest written
  by either package is the other's.

Exactness: each chunk runs the lanes the materialising path runs, and a
lane's result does not depend on the lanes beside it, so streamed,
resumed and materialising runs of one grid agree bit for bit, per lane.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine as _eng
from repro_torch.core import exec_cache
from repro_torch.core.graphs import _leaves
from repro_torch.core.params import (
    I32, MemSimConfig, ParamSchedule, RuntimeParams)
from repro_torch.core.simulator import (
    SimResult, Trace, init_state, resolve_device)
from repro_torch.kernels import build
from repro_torch.kernels.bank_fsm.fused import preload_batch_forms

#: Test seam: when set, called as ``_pre_commit_hook(chunk_index)`` after a
#: chunk's records are on the host but *before* the chunk is committed to
#: the checkpoint store, the window a crash would lose that chunk's work.
#: The kill/resume tests SIGKILL the process from here.
_pre_commit_hook: Optional[Callable[[int], None]] = None

#: Default lanes per chunk when neither ``chunk_lanes`` nor
#: ``memory_budget_bytes`` is given.
DEFAULT_CHUNK_LANES = 256

#: Hard ceiling on a derived chunk size.
MAX_CHUNK_LANES = 1024

#: the port's state carries one write-sink slot on each per-request record
#: and on ``mem`` that the reference's does not
_SINK_SLOTS = 6


# --------------------------------------------------------------------------
# memory budget -> chunk size


def lane_footprint_bytes(topo, n_max: int, s_max: int) -> int:
    """Bytes one lane of a chunk pins, as the reference reckons them: the
    per-lane :class:`SimState` (its shapes from :func:`init_state` on the
    ``meta`` device, no allocation, less the port's sink slots), its
    padded trace rows, its padded schedule and the depth limits, all
    int32. The port's real bytes a lane differ (sink slots, the scratch
    of lanes above 1024 banks, the launch arguments); this is the
    reference's number, so chunk plans and fingerprints agree."""
    shape = (s_max,) if topo.tiers == 1 else (s_max, topo.tiers)
    nf = len(RuntimeParams._fields)
    sched = ParamSchedule(
        boundaries=torch.arange(s_max, dtype=I32),
        values=RuntimeParams(*[torch.zeros(shape, dtype=I32)] * nf))
    state = init_state(topo, sched, n_max, device="meta")
    state_b = 4 * (sum(t.numel() for t in _leaves(state)) - _SINK_SLOTS)
    trace_b = 4 * 4 * n_max                       # t/addr/is_write/wdata
    sched_b = 4 * (1 + nf * topo.tiers) * s_max
    return state_b + trace_b + sched_b + 8        # + queue/resp limits


def _resolve_chunk_lanes(chunk_lanes: Optional[int],
                         memory_budget_bytes: Optional[int],
                         lane_bytes: int, n_points: int) -> int:
    """An explicit ``chunk_lanes`` wins; else a budget covers two chunks
    (running + next), floored at one lane per chunk; else
    :data:`DEFAULT_CHUNK_LANES`. A budget below a single lane's footprint
    raises: the sweep would exceed it at once."""
    if chunk_lanes is not None:
        if chunk_lanes < 1:
            raise ValueError(f"chunk_lanes must be >= 1, got {chunk_lanes}")
        return min(chunk_lanes, max(1, n_points))
    if memory_budget_bytes is not None:
        if memory_budget_bytes < lane_bytes:
            raise ValueError(
                f"memory_budget_bytes={memory_budget_bytes} is below a "
                f"single lane's footprint of {lane_bytes} bytes for this "
                f"(topology, trace, schedule) shape; even a one-lane chunk "
                f"cannot fit. Raise the budget to at least {lane_bytes} "
                f"bytes (>= {2 * lane_bytes} keeps the executing + "
                f"prefetched chunk pair resident) or pass chunk_lanes "
                f"explicitly to override the budget.")
        derived = memory_budget_bytes // (2 * lane_bytes)
        return max(1, min(int(derived), MAX_CHUNK_LANES, max(1, n_points)))
    return min(DEFAULT_CHUNK_LANES, max(1, n_points))


# --------------------------------------------------------------------------
# sweep fingerprinting (resume safety)


def _i32_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, np.int32)).tobytes()


def _trace_digest(tr: Trace) -> str:
    h = hashlib.sha256()
    for arr in (tr.t, tr.addr, tr.is_write, tr.wdata):
        h.update(_i32_bytes(arr))
    return h.hexdigest()


def _sched_bytes(sc: ParamSchedule) -> bytes:
    return b"".join([_i32_bytes(sc.boundaries)]
                    + [_i32_bytes(v) for v in sc.values])


def sweep_fingerprint(lane_cfgs: Sequence[MemSimConfig],
                      scheds: Sequence[ParamSchedule],
                      trace_list: Sequence[Trace],
                      qs: Sequence[int], rs: Sequence[int],
                      num_cycles: int, cap: int, rcap: int,
                      cycle_skip: bool, chunk_lanes: int) -> str:
    """Hex digest identifying a streaming sweep for resume: the exact lane
    configs (full ``repr``), the resolved per-lane schedules and depth
    limits, the trace contents, the horizon, the capacities, the engine
    ABI version and the chunk geometry. The reference's digest for the
    same inputs (configs on the ``fused`` backend, whose ``repr`` both
    packages share)."""
    h = hashlib.sha256()
    h.update(repr((exec_cache.ENGINE_ABI_VERSION, num_cycles, cap, rcap,
                   bool(cycle_skip), chunk_lanes,
                   len(lane_cfgs))).encode())
    tr_digests: Dict[int, str] = {}
    for cfg_i, sc, tr, q, r in zip(lane_cfgs, scheds, trace_list, qs, rs):
        h.update(repr((cfg_i, q, r)).encode())
        h.update(_sched_bytes(sc))
        d = tr_digests.get(id(tr))
        if d is None:
            d = tr_digests[id(tr)] = _trace_digest(tr)
        h.update(d.encode())
    return h.hexdigest()


def _chunk_digest(fingerprint: str, ci: int, lane_idx: Sequence[int]) -> str:
    return hashlib.sha256(
        (fingerprint + repr((ci, tuple(lane_idx)))).encode()).hexdigest()


# --------------------------------------------------------------------------
# the executor

#: Per-lane record arrays checkpointed for each chunk (``[L, n_max]``).
_RECORD_KEYS = ("t_admit", "t_dispatch", "t_start", "t_complete", "rdata")


def _chunk_records(finals, n_max: int) -> Tuple[Dict[str, np.ndarray],
                                                List[str]]:
    """A chunk's final states as the checkpoint's arrays, one copy to the
    host a field for every lane: the records ``[L, n_max]`` (sink slots
    dropped), the blocked counts ``[L]`` and each counter ``c_<key>``."""
    def host(get):
        return torch.stack([get(st) for st in finals]).cpu().numpy()

    arrays = {key: host(lambda st: getattr(st, key)[:n_max])
              for key in _RECORD_KEYS}
    arrays["blocked_arrival"] = host(lambda st: st.blocked_arrival)
    arrays["blocked_dispatch"] = host(lambda st: st.blocked_dispatch)
    counters_keys = list(finals[0].counters)
    for ckey in counters_keys:
        arrays["c_" + ckey] = host(lambda st: st.counters[ckey])
    return arrays, counters_keys


def stream_sweep(cfg: MemSimConfig,
                 trace: Union[Trace, Sequence[Trace]],
                 grid,
                 num_cycles: int = 100_000,
                 *, capacity: Optional[int] = None,
                 resp_capacity: Optional[int] = None,
                 cycle_skip: bool = True,
                 max_workers: Optional[int] = None,
                 chunk_lanes: Optional[int] = None,
                 memory_budget_bytes: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 resume: bool = True,
                 timings: Optional[dict] = None,
                 device=None) -> "_eng.TopoGridResult":
    """Stream a (topology x runtime) grid through chunked lane-batched
    launches.

    Takes the grid language of
    :func:`repro_torch.core.engine.sweep_topologies` (a runtime-only grid,
    the :func:`~repro_torch.core.engine.sweep_grid` case, is one topology)
    and returns the same :class:`~repro_torch.core.engine.TopoGridResult`,
    bit-identical per lane to the materialising paths. See the module
    docstring for the chunking, pipelining and checkpointing contract.
    ``max_workers`` is accepted for the reference's signature: the port
    compiles nothing a topology, and its chunks run from one thread.

    ``timings`` (optional dict; also the result's ``timings``) receives
    the reference's keys: ``compiles`` (kernel libraries built),
    ``compile_s`` / ``compile_s_wall`` (the build and the kernels' load),
    ``prep_s`` (the chunks' set-up and launch enqueue), ``run_s`` (waiting
    for the chunks' launches), ``checkpoint_s``, ``steps`` (the longest
    lane's), ``topologies``, ``streamed``, ``chunk_lanes``, ``chunks``,
    ``chunks_resumed``, ``lane_bytes``, ``peak_chunk_bytes`` and
    ``per_chunk`` (``{chunk, topology, lanes, prep_s, run_s, results_s,
    steps, launches, device}`` a chunk run); and the port's own
    ``launches`` (lane-batched K3 launches), ``results_s`` (the records'
    copies to the host), ``plan_s`` (the grid's expansion, the chunk plan,
    the fingerprint and the checkpoint's restore) and ``merge_s`` (the
    result table's assembly).
    ``device=None`` runs on the CUDA card and raises without one.
    """
    from repro_torch.checkpoint.store import SweepCheckpoint

    t_plan0 = time.perf_counter()
    dev = resolve_device(device)

    # ---- expand the grid exactly like the materialising paths ----------
    points = _eng.topo_grid_points(grid)
    (lane_cfgs, trace_list, qs, rs, cap, rcap, scheds, topologies,
     topo_of_point, groups) = _eng._topo_lanes(cfg, trace, points, capacity,
                                               resp_capacity)
    n_points = len(points)
    n_topos = len(topologies)
    s_max = scheds[0].num_segments
    n_max = max(int(tr.num_requests) for tr in trace_list)

    # ---- chunk plan: topology-major ------------------------------------
    lane_bytes = max(lane_footprint_bytes(t, n_max, s_max)
                     for t in topologies)
    L = _resolve_chunk_lanes(chunk_lanes, memory_budget_bytes, lane_bytes,
                             n_points)
    chunks: List[Tuple[int, List[int]]] = []   # (topo group, lane indices)
    for gi in range(n_topos):
        idxs = groups[gi]
        for off in range(0, len(idxs), L):
            chunks.append((gi, idxs[off:off + L]))
    n_chunks = len(chunks)

    fp = sweep_fingerprint(lane_cfgs, scheds, trace_list, qs, rs,
                           num_cycles, cap, rcap, cycle_skip, L)

    # ---- checkpoint store: validate-or-refuse, find committed chunks ---
    ckpt = SweepCheckpoint(checkpoint_dir) if checkpoint_dir else None
    done: Dict[int, Tuple[Dict[str, np.ndarray], Dict]] = {}
    if ckpt is not None:
        existing = ckpt.read_manifest()
        if existing is not None and existing.get("fingerprint") != fp:
            if resume:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} belongs to a "
                    "different sweep (grid / configs / traces / horizon / "
                    "chunking changed); pass resume=False to discard it")
            ckpt.clear()
            existing = None
        if existing is None or not resume:
            if not resume:
                ckpt.clear()
            ckpt.write_manifest({
                "version": 1,
                "fingerprint": fp,
                "n_points": n_points,
                "n_chunks": n_chunks,
                "chunk_lanes": L,
                "num_cycles": int(num_cycles),
                "grid_axes": list(grid),
                "chunks": [{"topology": gi, "lanes": list(map(int, li)),
                            "digest": _chunk_digest(fp, ci, li)}
                           for ci, (gi, li) in enumerate(chunks)],
            })
        else:
            for ci in ckpt.done_chunks():
                if ci >= n_chunks:
                    continue
                loaded = ckpt.load_chunk(ci)
                if loaded is None:
                    continue
                arrays, meta = loaded
                # a chunk only restores when its digest proves it was
                # produced by THIS sweep's chunk ci, else it is recomputed
                if meta.get("digest") == _chunk_digest(fp, ci,
                                                       chunks[ci][1]):
                    done[ci] = (arrays, meta)

    plan_s = time.perf_counter() - t_plan0

    # ---- the kernels: built (or loaded from the cache), every form of
    # the lane-batched K3 loaded before the first launch -----------------
    pending = [ci for ci in range(n_chunks) if ci not in done]
    need = {topologies[chunks[ci][0]].fsm_backend for ci in pending}
    built0 = build.build_count()
    t_c0 = time.perf_counter()
    if dev.type == "cuda" and need - {"plain"}:
        build.load()
        if "fused" in need:
            preload_batch_forms()
    compile_s = time.perf_counter() - t_c0

    # every distinct trace padded to the sweep's n_max once, as the
    # reference stacks every chunk at one request count
    padded: Dict[int, Trace] = {}
    for tr in trace_list:
        if id(tr) not in padded:
            padded[id(tr)] = _eng._pad_trace(tr, n_max)
    streams: List[Optional[torch.cuda.Stream]] = [None, None]
    if dev.type == "cuda" and pending:
        here = torch.cuda.current_stream(dev)
        streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
        for s in streams:
            # a trace the caller put on the card may still be in flight
            s.wait_stream(here)

    def on(s):
        return torch.cuda.stream(s) if s is not None else nullcontext()

    def start(k: int):
        """Set up pending chunk ``k``'s lanes on its stream and, fused on
        the card, enqueue its launch."""
        ci = pending[k]
        gi, idxs = chunks[ci]
        gcfg = dataclasses.replace(lane_cfgs[idxs[0]], queue_size=cap,
                                   resp_queue_size=rcap)
        s = streams[k % 2]
        t0 = time.perf_counter()
        with on(s):
            finish = _eng._start_batch(
                gcfg, [padded[id(trace_list[i])] for i in idxs], num_cycles,
                queue_sizes=[qs[i] for i in idxs],
                resp_queue_sizes=[rs[i] for i in idxs],
                params=[scheds[i] for i in idxs], lane_cfgs=None,
                cycle_skip=cycle_skip, batch_mode="lanes", dev=dev)
        return ci, s, finish, time.perf_counter() - t0

    per_chunk = []
    steps_max = 0
    prep_wall = run_wall = results_wall = save_wall = 0.0
    launches_total = 0
    nxt = start(0) if pending else None
    for k in range(len(pending)):
        ci, s, finish, prep_s = nxt
        nxt = None
        gi, idxs = chunks[ci]
        # the next chunk's launch goes in before this one is read, unless
        # this one runs the split or plain loops (their CUDA-graph captures
        # then overlap no launch)
        if k + 1 < len(pending) and topologies[gi].fsm_backend == "fused":
            nxt = start(k + 1)
        t_r0 = time.perf_counter()
        with on(s):
            finals, lane_steps, launches = finish(as_states=True)
            t_r1 = time.perf_counter()
            arrays, counters_keys = _chunk_records(finals, n_max)
        t_r2 = time.perf_counter()
        del finish, finals   # the chunk's device state goes here
        steps_i = max(lane_steps)
        steps_max = max(steps_max, steps_i)
        meta = {"digest": _chunk_digest(fp, ci, idxs),
                "lanes": list(map(int, idxs)),
                "counters_keys": counters_keys,
                "steps": steps_i}
        if _pre_commit_hook is not None:
            _pre_commit_hook(ci)
        if ckpt is not None:
            t_s0 = time.perf_counter()
            ckpt.save_chunk(ci, arrays, meta)
            save_wall += time.perf_counter() - t_s0
        done[ci] = (arrays, meta)
        prep_wall += prep_s
        run_wall += t_r1 - t_r0
        results_wall += t_r2 - t_r1
        launches_total += launches
        per_chunk.append({"chunk": ci, "topology": gi, "lanes": len(idxs),
                          "prep_s": prep_s, "run_s": t_r1 - t_r0,
                          "results_s": t_r2 - t_r1, "steps": steps_i,
                          "launches": int(launches), "device": str(dev)})
        if nxt is None and k + 1 < len(pending):
            nxt = start(k + 1)

    # ---- merge: committed + freshly computed chunks -> result table ----
    t_m0 = time.perf_counter()
    host_trace: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    results: List[Optional[SimResult]] = [None] * n_points
    for ci in range(n_chunks):
        arrays, meta = done[ci]
        _, idxs = chunks[ci]
        for k, i in enumerate(idxs):
            tr = trace_list[i]
            if id(tr) not in host_trace:
                host_trace[id(tr)] = (tr.t.cpu().numpy(),
                                      tr.is_write.cpu().numpy())
            t_intended, is_write = host_trace[id(tr)]
            n_i = int(tr.num_requests)
            results[i] = SimResult(
                cfg=lane_cfgs[i],
                num_cycles=num_cycles,
                t_intended=t_intended,
                is_write=is_write,
                t_admit=arrays["t_admit"][k, :n_i],
                t_dispatch=arrays["t_dispatch"][k, :n_i],
                t_start=arrays["t_start"][k, :n_i],
                t_complete=arrays["t_complete"][k, :n_i],
                rdata=arrays["rdata"][k, :n_i],
                counters={ckey: np.asarray(arrays["c_" + ckey][k])
                          for ckey in meta["counters_keys"]},
                blocked_arrival=int(arrays["blocked_arrival"][k]),
                blocked_dispatch=int(arrays["blocked_dispatch"][k]),
            )
        steps_max = max(steps_max, int(meta.get("steps", 0)))

    own = {
        "compiles": build.build_count() - built0,
        "compile_s": compile_s,
        "compile_s_wall": compile_s,
        "run_s": run_wall,
        "prep_s": prep_wall,
        "checkpoint_s": save_wall,
        "steps": steps_max,
        "topologies": n_topos,
        "streamed": True,
        "chunk_lanes": L,
        "chunks": n_chunks,
        "chunks_resumed": n_chunks - len(pending),
        "lane_bytes": lane_bytes,
        "peak_chunk_bytes": 2 * L * lane_bytes,
        "per_chunk": per_chunk,
        "launches": launches_total,
        "results_s": results_wall,
        "plan_s": plan_s,
        "merge_s": time.perf_counter() - t_m0,
    }
    if timings is not None:
        for k in ("compiles", "topologies", "chunks", "chunks_resumed",
                  "launches"):
            timings[k] = timings.get(k, 0) + own[k]
        for k in ("compile_s", "compile_s_wall", "run_s", "prep_s",
                  "checkpoint_s", "results_s", "plan_s", "merge_s"):
            timings[k] = timings.get(k, 0.0) + own[k]
        timings["steps"] = max(timings.get("steps", 0), own["steps"])
        for k in ("streamed", "chunk_lanes", "lane_bytes",
                  "peak_chunk_bytes"):
            timings[k] = own[k]
        timings.setdefault("per_chunk", []).extend(per_chunk)
    return _eng.TopoGridResult(points=points, results=results,
                               topologies=topologies,
                               topo_of_point=topo_of_point, timings=own)
