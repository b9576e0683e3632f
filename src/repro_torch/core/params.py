"""MemorySim configuration: static topology vs runtime parameters.

PyTorch counterpart of ``repro.core.params``; every class, field order,
constant and ``ValueError`` text is the same, so a configuration (or a
packed kernel-ABI matrix) means the same thing in both packages.

* :class:`Topology` — everything that determines tensor *shapes* or the
  structure of the per-cycle program (channel/rank/bankgroup/bank counts,
  queue capacities, backing-store size, FSM backend).

* :class:`RuntimeParams` — every JEDEC timing parameter of the paper's
  Table 1 plus the page and scheduling policy as int flags. Leaves are
  Python ints or int32 tensors.

* :class:`ParamSchedule` — piecewise-constant runtime parameters (DVFS,
  thermal throttling, refresh stepping) whose leaves are int32 tensors.

* :class:`MemSimConfig` — Topology + all runtime fields in one frozen
  dataclass; ``cfg.topology()`` / ``cfg.runtime()`` split it.

FSM backends (``Topology.fsm_backend``) and their reference counterparts:

====================  ==================  ===================================
port                  reference (JAX)     what runs on a CUDA tensor
====================  ==================  ===================================
``"plain"``           ``"jnp"``           PyTorch ops only (``fsm_update``)
``"split"``           ``"pallas"``        K1 ``bank_fsm_step`` + K2
                                          ``bank_event_bound`` CUDA kernels
``"fused"`` (default) ``"fused"``         K3: one persistent
                                          ``fused_run`` launch per run,
                                          ``simulate`` in its per-cycle
                                          form (no skip)
====================  ==================  ===================================

On a CPU tensor ``"split"`` and ``"fused"`` run the kernels' plain PyTorch
versions (same ABI, same arithmetic); on a CUDA tensor they launch the
CUDA kernels or raise — there is no fallback.

Address mapping (paper §5.2)::

    address <- {remaining_bits, rank_idx, bankgroup_idx, bank_idx}
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

I32 = torch.int32


def _log2(x: int) -> int:
    assert x > 0 and (x & (x - 1)) == 0, f"{x} must be a power of two"
    return int(math.log2(x))


def _np(x) -> np.ndarray:
    """Host numpy view of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _i32(x, device=None) -> torch.Tensor:
    """``x`` as an int32 tensor (kept on its device unless ``device``)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=I32, device=device or x.device)
    return torch.as_tensor(np.asarray(x, np.int64).astype(np.int32),
                           device=device)


# Policy flags
PAGE_CLOSED, PAGE_OPEN = 0, 1
SCHED_FCFS, SCHED_FRFCFS = 0, 1
PAGE_POLICIES = {"closed": PAGE_CLOSED, "open": PAGE_OPEN}
SCHED_POLICIES = {"fcfs": SCHED_FCFS, "frfcfs": SCHED_FRFCFS}
FSM_BACKENDS = ("plain", "split", "fused")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static shape-determining configuration (frozen, hashable)."""

    # ---- topology -------------------------------------------------------
    channels: int = 1
    ranks: int = 2
    bankgroups: int = 4
    banks_per_group: int = 4
    column_bits: int = 6          # low "remaining" bits that index within a row

    # ---- memory tiers (DRAM + CXL expander) ------------------------------
    # the first ``dram_channels`` channels are tier 0, the last
    # ``cxl_channels`` tier 1; each tier carries its own RuntimeParams row
    tiers: int = 1
    cxl_channels: int = 0

    # ---- queue capacities (the runtime depth is a limit tensor) ----------
    queue_size: int = 128         # global reqQueue depth == per-bank queue depth
    resp_queue_size: int = 64

    # ---- data correctness -------------------------------------------------
    mem_words: int = 1 << 16      # word-addressable backing store size

    # ---- backend (see the module docstring) ------------------------------
    fsm_backend: str = "fused"

    def __post_init__(self):
        if self.fsm_backend not in FSM_BACKENDS:
            raise ValueError(
                f"fsm_backend={self.fsm_backend!r} not in {FSM_BACKENDS}")

    # ---- derived ----------------------------------------------------------
    @property
    def banks_per_rank(self) -> int:
        return self.bankgroups * self.banks_per_group

    @property
    def banks_per_channel(self) -> int:
        return self.ranks * self.banks_per_rank

    @property
    def num_banks(self) -> int:
        """Total flattened bank count B = C * R * BG * BA."""
        return self.channels * self.banks_per_channel

    @property
    def num_ranks(self) -> int:
        """Total flattened rank count (channels * ranks)."""
        return self.channels * self.ranks

    @property
    def bank_bits(self) -> int:
        return _log2(self.banks_per_group)

    @property
    def bankgroup_bits(self) -> int:
        return _log2(self.bankgroups)

    @property
    def rank_bits(self) -> int:
        return _log2(self.ranks)

    @property
    def channel_bits(self) -> int:
        return _log2(self.channels)

    @property
    def dram_channels(self) -> int:
        """Channels in tier 0 (direct DRAM)."""
        return self.channels - self.cxl_channels

    @property
    def tier_split_bank(self) -> int:
        """Index of the first tier-1 (CXL) flattened bank; equals
        ``num_banks`` when there is no second tier."""
        return self.dram_channels * self.banks_per_channel

    @property
    def tier_split_rank(self) -> int:
        """Index of the first tier-1 (CXL) flattened rank."""
        return self.dram_channels * self.ranks

    @property
    def addr_low_bits(self) -> int:
        """Bits consumed by {channel, rank, bankgroup, bank}."""
        return self.bank_bits + self.bankgroup_bits + self.rank_bits + self.channel_bits

    @property
    def row_shift(self) -> int:
        """Right shift that turns a word address into its row index."""
        return self.addr_low_bits + self.column_bits

    def topology(self) -> "Topology":
        """The pure static slice (strips the runtime fields off a
        :class:`MemSimConfig`)."""
        return Topology(**{f.name: getattr(self, f.name)
                           for f in dataclasses.fields(Topology)})

    def validate(self) -> "Topology":
        for f in ("channels", "ranks", "bankgroups", "banks_per_group"):
            v = getattr(self, f)
            if v <= 0 or (v & (v - 1)) != 0:
                raise ValueError(f"{f}={v} must be a power of two")
        if self.queue_size < 1:
            raise ValueError(f"queue_size={self.queue_size} must be >= 1")
        if self.resp_queue_size < 1:
            raise ValueError(
                f"resp_queue_size={self.resp_queue_size} must be >= 1")
        if self.tiers not in (1, 2):
            raise ValueError(f"tiers={self.tiers} must be 1 or 2 (DRAM, "
                             "or DRAM + CXL expander)")
        if self.tiers == 1 and self.cxl_channels != 0:
            raise ValueError(
                f"cxl_channels={self.cxl_channels} requires tiers=2")
        if self.tiers == 2:
            for f, v in (("cxl_channels", self.cxl_channels),
                         ("dram_channels", self.dram_channels)):
                if v <= 0 or (v & (v - 1)) != 0:
                    raise ValueError(
                        f"{f}={v} must be a power of two >= 1 when tiers=2 "
                        f"(channels={self.channels} is partitioned "
                        f"DRAM|CXL)")
        return self


class RuntimeParams(NamedTuple):
    """Runtime parameters: paper Table-1 timings + policy flags.

    Leaves are Python ints or int32 tensors (scalars, or ``[T]`` per tier
    after :func:`tiered_params`). The field order is the packed kernel ABI
    (:data:`RP_INDEX`)."""

    tRP: int = 14                 # precharge period
    tFAW: int = 30                # four-activation window
    tRRDL: int = 6                # min cycles between two ACTs (same rank)
    tRCDRD: int = 14              # ACTIVATE -> READ delay
    tRCDWR: int = 14              # ACTIVATE -> WRITE delay
    tCCDL: int = 2                # gap between consecutive column commands
    tWTR: int = 8                 # WRITE -> READ turnaround
    tRFC: int = 260               # refresh cycle time / "deadline to start"
    tREFI: int = 3600             # refresh interval
    tCL: int = 14                 # column command data-return latency
    tXS: int = 10                 # self-refresh exit latency
    tRTW: int = 2                 # read -> write turnaround
    sref_idle_cycles: int = 1000  # idle cycles before SREF entry
    page_policy: int = PAGE_CLOSED
    sched_policy: int = SCHED_FCFS
    # host-side tier placement (tiers=2 topologies; inert otherwise)
    tier_interleave_log2: int = 6
    tier_cxl_frac_log2: int = 1

    @classmethod
    def from_config(cls, cfg: "MemSimConfig") -> "RuntimeParams":
        kw = {f: getattr(cfg, f) for f in cls._fields
              if f not in ("page_policy", "sched_policy")}
        return cls(page_policy=PAGE_POLICIES[cfg.page_policy],
                   sched_policy=SCHED_POLICIES[cfg.sched_policy], **kw)

    def pack(self) -> torch.Tensor:
        """Flatten to an int32 ``[NUM_RUNTIME_PARAMS, 1]`` column."""
        return torch.stack(
            [_i32(v).reshape(()) for v in self]).reshape(len(self._fields), 1)

    @classmethod
    def unpack(cls, vec) -> "RuntimeParams":
        """Inverse of :meth:`pack` (``vec`` int32 [NP, 1] or [NP])."""
        flat = vec.reshape(len(cls._fields))
        return cls(*[flat[i] for i in range(len(cls._fields))])

    @classmethod
    def stack(cls, rps) -> "RuntimeParams":
        """Stack a sequence of RuntimeParams on a leading axis."""
        rps = list(rps)
        return cls(*[torch.stack([_i32(getattr(rp, f)) for rp in rps])
                     for f in cls._fields])

    def apply_to(self, cfg: "MemSimConfig") -> "MemSimConfig":
        """``cfg`` with this parameter point substituted (flags raised back
        to the policy strings), so results carry an accurate label.
        Returns ``cfg`` unchanged for a tier-stacked point."""
        try:
            vals = {f: int(getattr(self, f)) for f in self._fields}
        except (TypeError, ValueError):  # [T] leaves: no single label
            return cfg
        vals["page_policy"] = {v: k for k, v in
                               PAGE_POLICIES.items()}[vals["page_policy"]]
        vals["sched_policy"] = {v: k for k, v in
                                SCHED_POLICIES.items()}[vals["sched_policy"]]
        return dataclasses.replace(cfg, **vals)


NUM_RUNTIME_PARAMS = len(RuntimeParams._fields)
#: field -> column of the packed kernel-ABI rows (csrc/rp_index.h mirrors it)
RP_INDEX = {name: i for i, name in enumerate(RuntimeParams._fields)}

#: fields resolved as machine-global scalars (placement decode, promotion)
TIER_UNIFORM_FIELDS = ("page_policy", "sched_policy",
                       "tier_interleave_log2", "tier_cxl_frac_log2")


def tiered_params(*tier_rps) -> "RuntimeParams":
    """Stack one :class:`RuntimeParams` point per memory tier (DRAM first,
    then the CXL expander): every leaf becomes int32[T]. Fields in
    :data:`TIER_UNIFORM_FIELDS` must agree across tiers."""
    if len(tier_rps) < 2:
        raise ValueError("tiered_params needs one RuntimeParams per tier "
                         f"(>= 2), got {len(tier_rps)}")
    for f in TIER_UNIFORM_FIELDS:
        vals = [int(getattr(rp, f)) for rp in tier_rps]
        if len(set(vals)) > 1:
            raise ValueError(
                f"{f} must be tier-uniform (resolved as a machine-global "
                f"scalar), got {vals} across tiers")
    return RuntimeParams.stack(tier_rps)


def tier_of_bank(topo: "Topology") -> np.ndarray:
    """Static int32[B] tier index of every flattened bank (numpy)."""
    ch = np.arange(topo.num_banks, dtype=np.int32) // topo.banks_per_channel
    return (ch >= topo.dram_channels).astype(np.int32)


def rp_for_banks(topo: "Topology", rp: "RuntimeParams") -> "RuntimeParams":
    """Resolve a (possibly tier-stacked) parameter point to per-bank form:
    the identity for ``topo.tiers == 1``; otherwise every ``[T]`` leaf is
    gathered through the static bank->tier map to ``[B]`` and scalar leaves
    pass through."""
    if topo.tiers == 1:
        return rp

    def leaf(v):
        a = _i32(v)
        if a.dim() == 0:
            return a
        return a[torch.as_tensor(tier_of_bank(topo), device=a.device)
                 .long()]

    return RuntimeParams(*[leaf(v) for v in rp])


#: sentinel boundary for "no further segment" / schedule padding; equals
#: the event-horizon infinity so the two mins compose
SCHEDULE_INF = 0x3FFFFFFF


class ParamSchedule(NamedTuple):
    """Piecewise-constant time-varying :class:`RuntimeParams`.

    ``boundaries[s]`` is the first cycle of segment ``s`` (strictly
    increasing, ``boundaries[0] == 0``); ``values`` is a
    ``RuntimeParams.stack``-ed point whose leaves carry one entry per
    segment (``[S]``, or ``[S, T]`` when tier-stacked). The parameters
    governing cycle ``c`` are ``values[segment_at(c)]``; WAIT timers latch
    their duration at the grant cycle and count down across boundaries.
    Padding rows (:meth:`pad_to`) carry a ``SCHEDULE_INF`` boundary and are
    never active.
    """

    boundaries: torch.Tensor      # int32[S] (or [L, S] when lane-stacked)
    values: RuntimeParams         # each leaf int32[S] (or [S, T], [L, S])

    # ---- static shape ----------------------------------------------------
    @property
    def num_segments(self) -> int:
        return int(tuple(self.boundaries.shape)[-1])

    @property
    def num_tiers(self) -> int:
        """Memory-tier count T: a leaf is tier-stacked iff it carries one
        axis beyond the boundaries' segment axis."""
        bnd_nd = self.boundaries.dim()
        t = 1
        for v in self.values:
            shape = tuple(np.shape(v)) if not isinstance(v, torch.Tensor) \
                else tuple(v.shape)
            if len(shape) == bnd_nd + 1:
                t = max(t, int(shape[-1]))
        return t

    # ---- construction ----------------------------------------------------
    @classmethod
    def constant(cls, rp: "RuntimeParams") -> "ParamSchedule":
        """The degenerate S=1 schedule: ``rp`` for the whole run."""
        return cls(boundaries=torch.zeros((1,), dtype=I32),
                   values=RuntimeParams.stack([rp]))

    @classmethod
    def from_segments(cls, segments) -> "ParamSchedule":
        """Build from ``[(start_cycle, RuntimeParams), ...]`` and validate
        (boundaries sorted, unique, starting at 0; every segment through
        :func:`runtime_constraint_violations`)."""
        if not segments:
            raise ValueError("ParamSchedule needs at least one segment")
        starts = [int(s) for s, _ in segments]
        rps = [rp for _, rp in segments]
        return cls(boundaries=torch.tensor(starts, dtype=I32),
                   values=RuntimeParams.stack(rps)).validate()

    # ---- the one resolver ------------------------------------------------
    def segment_at(self, cycle) -> torch.Tensor:
        """Index of the segment governing ``cycle`` (int32 0-d tensor)."""
        b = _i32(self.boundaries)
        if self.num_segments == 1:
            return torch.zeros((), dtype=I32, device=b.device)
        c = _i32(cycle, b.device)
        return ((c >= b).to(I32).sum() - 1).to(I32)

    def params_at(self, cycle) -> "RuntimeParams":
        """The :class:`RuntimeParams` governing ``cycle``."""
        if self.num_segments == 1:
            return RuntimeParams(*[_i32(v)[0] for v in self.values])
        seg = self.segment_at(cycle).long()
        return RuntimeParams(*[_i32(v)[seg] for v in self.values])

    def next_boundary(self, cycle) -> torch.Tensor:
        """First segment boundary strictly after ``cycle``
        (``SCHEDULE_INF`` when none)."""
        b = _i32(self.boundaries)
        if self.num_segments == 1:
            return torch.tensor(SCHEDULE_INF, dtype=I32, device=b.device)
        c = _i32(cycle, b.device)
        inf = torch.full_like(b, SCHEDULE_INF)
        return torch.where(b > c, b, inf).min().to(I32)

    # ---- kernel ABI ------------------------------------------------------
    def pack(self):
        """``(boundaries int32[S, 1], values int32[T*S, NP])``; the values
        matrix is tier-major (row ``t*S + s`` is tier ``t``'s segment
        ``s``)."""
        s = self.num_segments
        t = self.num_tiers
        if t == 1:
            vals = torch.stack([_i32(v).reshape(s) for v in self.values],
                               dim=1)
        else:
            vals = torch.stack(
                [_i32(v).reshape(s, -1).expand(s, t).T.reshape(t * s)
                 for v in self.values], dim=1)
        return _i32(self.boundaries).reshape(s, 1), vals.contiguous()

    @classmethod
    def unpack(cls, bounds, vals) -> "ParamSchedule":
        """Inverse of :meth:`pack` (``bounds`` [S, 1] or [S], ``vals``
        [T*S, NP] tier-major)."""
        s = bounds.reshape(-1).shape[0]
        t = vals.shape[0] // s
        if t == 1:
            leaves = [vals[:, i] for i in range(NUM_RUNTIME_PARAMS)]
        else:
            cube = vals.reshape(t, s, NUM_RUNTIME_PARAMS)
            leaves = [cube[:, :, i].T for i in range(NUM_RUNTIME_PARAMS)]
        return cls(boundaries=bounds.reshape(s),
                   values=RuntimeParams(*leaves))

    # ---- batching --------------------------------------------------------
    def pad_to(self, s: int) -> "ParamSchedule":
        """Pad to ``s`` segments with inert rows (boundary ``SCHEDULE_INF``,
        values repeating the last real segment)."""
        cur = self.num_segments
        if cur == s:
            return self
        if cur > s:
            raise ValueError(f"cannot pad {cur} segments down to {s}")
        extra = s - cur
        b0 = _i32(self.boundaries).reshape(cur)
        b = torch.cat([b0, torch.full((extra,), SCHEDULE_INF, dtype=I32,
                                      device=b0.device)])

        def pad_leaf(v):
            a = _i32(v)
            if a.dim() == 2:        # tier-stacked [S, T]
                return torch.cat([a, a[-1].expand(extra, a.shape[1])])
            a = a.reshape(cur)
            return torch.cat([a, a[-1].expand(extra)])

        vals = RuntimeParams(*[pad_leaf(v) for v in self.values])
        return ParamSchedule(boundaries=b, values=vals)

    @classmethod
    def stack(cls, scheds) -> "ParamSchedule":
        """Stack schedules on a leading lane axis (padding each to the
        common segment count)."""
        scheds = list(scheds)
        s_max = max(sc.num_segments for sc in scheds)
        padded = [sc.pad_to(s_max) for sc in scheds]
        return cls(
            boundaries=torch.stack([_i32(sc.boundaries) for sc in padded]),
            values=RuntimeParams(*[
                torch.stack([_i32(getattr(sc.values, f)) for sc in padded])
                for f in RuntimeParams._fields]))

    # ---- validation / labelling -----------------------------------------
    def segment(self, s: int) -> "RuntimeParams":
        """Segment ``s``'s parameter point (host-side indexing)."""
        return RuntimeParams(*[_i32(v)[s] for v in self.values])

    def validate(self) -> "ParamSchedule":
        """Host-side validation: boundaries sorted, unique, starting at
        cycle 0 (``SCHEDULE_INF`` padding rows exempt, but only as a
        suffix), and every real segment's values through
        :func:`runtime_constraint_violations` — the same ValueError texts as
        config construction."""
        bad = []
        bounds = [int(x) for x in _np(self.boundaries).reshape(-1)]
        real = [b for b in bounds if b < SCHEDULE_INF]
        n_real = len(real)
        if len(real) != len(bounds) and any(
                b < SCHEDULE_INF for b in bounds[n_real:]):
            bad.append("schedule padding rows (boundary >= "
                       f"{SCHEDULE_INF}) must form a suffix")
        if not real:
            bad.append("schedule needs at least one real segment "
                       "(boundary below the padding sentinel)")
        elif real[0] != 0:
            bad.append(f"schedule boundaries must start at cycle 0, "
                       f"got {real[0]}")
        for a, b in zip(real, real[1:]):
            if b <= a:
                bad.append("schedule boundaries must be sorted and "
                           f"unique (strictly increasing): {a} then {b}")
        t_count = self.num_tiers
        arrs = {f: _np(getattr(self.values, f)) for f in RuntimeParams._fields}
        for s in range(n_real):
            for ti in range(t_count):
                vals = {}
                for f, arr in arrs.items():
                    if arr.ndim >= 2:     # tier-stacked [S, T]
                        vals[f] = int(arr[s, min(ti, arr.shape[1] - 1)])
                    else:                 # tier-uniform [S]
                        vals[f] = int(arr.reshape(-1)[s])
                prefix = ""
                if n_real > 1:
                    prefix = f"schedule segment {s}: "
                if t_count > 1:
                    prefix += f"tier {ti}: "
                bad.extend(prefix + m
                           for m in runtime_constraint_violations(vals))
            for f in TIER_UNIFORM_FIELDS:
                arr = arrs[f]
                if arr.ndim >= 2 and len(set(
                        int(x) for x in arr[s].reshape(-1))) > 1:
                    bad.append(
                        f"{f} must be tier-uniform (resolved as a "
                        f"machine-global scalar), got "
                        f"{[int(x) for x in arr[s].reshape(-1)]} across "
                        f"tiers")
        if bad:
            raise ValueError("; ".join(bad))
        return self

    def apply_to(self, cfg: "MemSimConfig") -> "MemSimConfig":
        """A schedule with exactly one real segment labels like its constant
        point; a time-varying schedule returns ``cfg`` unchanged."""
        bounds = _np(self.boundaries).reshape(-1)
        if int((bounds < SCHEDULE_INF).sum()) == 1:
            return self.segment(0).apply_to(cfg)
        return cfg


def as_schedule(params) -> "ParamSchedule":
    """Lift ``params`` to a :class:`ParamSchedule` (a bare
    :class:`RuntimeParams` becomes the S=1 schedule)."""
    if isinstance(params, ParamSchedule):
        return params
    if isinstance(params, RuntimeParams):
        return ParamSchedule.constant(params)
    raise TypeError(
        f"params must be RuntimeParams or ParamSchedule, got "
        f"{type(params).__name__}")


#: runtime fields that must be strictly positive
POSITIVE_RUNTIME_FIELDS = tuple(
    f for f in RuntimeParams._fields
    if f not in ("page_policy", "sched_policy",
                 "tier_interleave_log2", "tier_cxl_frac_log2"))


def runtime_constraint_violations(vals) -> list:
    """Cross-field constraints on a runtime parameter point, shared by
    :meth:`MemSimConfig.validate` and the engines' ``params=`` path.
    ``vals`` maps every field to an int (or ``None``: unknown, skipped).
    Returns the violation messages, empty when the point is valid."""
    def known(*fields):
        return all(vals.get(f) is not None for f in fields)

    out = []
    for f in POSITIVE_RUNTIME_FIELDS:
        if known(f) and vals[f] < 1:
            out.append(f"{f}={vals[f]} must be >= 1")
    if known("tREFI", "tRFC") and vals["tREFI"] <= vals["tRFC"]:
        out.append(
            f"tREFI={vals['tREFI']} (refresh interval) must exceed "
            f"tRFC={vals['tRFC']} (refresh cycle time)")
    if known("tFAW", "tRRDL") and vals["tFAW"] < vals["tRRDL"]:
        out.append(
            f"tFAW={vals['tFAW']} (four-activation window) must be >= "
            f"tRRDL={vals['tRRDL']} (ACT-to-ACT gap)")
    if known("page_policy") and vals["page_policy"] not in (PAGE_CLOSED,
                                                            PAGE_OPEN):
        out.append(
            f"page_policy flag {vals['page_policy']} not in "
            f"{{{PAGE_CLOSED} (closed), {PAGE_OPEN} (open)}}")
    if known("sched_policy") and vals["sched_policy"] not in (SCHED_FCFS,
                                                              SCHED_FRFCFS):
        out.append(
            f"sched_policy flag {vals['sched_policy']} not in "
            f"{{{SCHED_FCFS} (fcfs), {SCHED_FRFCFS} (frfcfs)}}")
    if known("tier_interleave_log2") and not (
            0 <= vals["tier_interleave_log2"] <= 24):
        out.append(
            f"tier_interleave_log2={vals['tier_interleave_log2']} must be "
            f"in [0, 24] (word-block interleave granularity)")
    if known("tier_cxl_frac_log2") and not (
            1 <= vals["tier_cxl_frac_log2"] <= 20):
        out.append(
            f"tier_cxl_frac_log2={vals['tier_cxl_frac_log2']} must be in "
            f"[1, 20] (CXL owns 1 of every 2^k interleave blocks)")
    return out


@dataclasses.dataclass(frozen=True)
class MemSimConfig(Topology):
    """Topology + runtime parameters in one frozen object."""

    # ---- timing parameters (paper Table 1 values) ------------------------
    tRP: int = 14                 # precharge period
    tFAW: int = 30                # four-activation window
    tRRDL: int = 6                # min cycles between two ACTs (same rank)
    tRCDRD: int = 14              # ACTIVATE -> READ delay
    tRCDWR: int = 14              # ACTIVATE -> WRITE delay
    tCCDL: int = 2                # gap between consecutive column commands
    tWTR: int = 8                 # WRITE -> READ turnaround
    tRFC: int = 260               # refresh cycle time / "deadline to start"
    tREFI: int = 3600             # refresh interval
    tCL: int = 14                 # column command data-return latency
    tXS: int = 10                 # self-refresh exit latency
    tRTW: int = 2                 # read -> write turnaround

    # ---- self refresh (paper §5.2.3) -------------------------------------
    sref_idle_cycles: int = 1000  # idle cycles before SREF entry

    # ---- policies -------------------------------------------------------
    page_policy: str = "closed"   # "closed" (paper) or "open"
    sched_policy: str = "fcfs"    # "fcfs" (paper) or "frfcfs"

    # ---- tier placement (tiers=2 topologies; inert on a single tier) -----
    tier_interleave_log2: int = 6
    tier_cxl_frac_log2: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.page_policy not in PAGE_POLICIES:
            raise ValueError(
                f"page_policy={self.page_policy!r} not in "
                f"{sorted(PAGE_POLICIES)}")
        if self.sched_policy not in SCHED_POLICIES:
            raise ValueError(
                f"sched_policy={self.sched_policy!r} not in "
                f"{sorted(SCHED_POLICIES)}")

    def runtime(self) -> RuntimeParams:
        """The runtime slice (policies lowered to int flags)."""
        return RuntimeParams.from_config(self)

    def validate(self) -> "MemSimConfig":
        Topology.validate(self)
        vals = {f: getattr(self, f) for f in RuntimeParams._fields
                if f not in ("page_policy", "sched_policy")}
        vals["page_policy"] = PAGE_POLICIES[self.page_policy]
        vals["sched_policy"] = SCHED_POLICIES[self.sched_policy]
        bad = runtime_constraint_violations(vals)
        if bad:
            raise ValueError("; ".join(bad))
        return self


# FSM states of the bank scheduler (paper Fig 2) --------------------------
S_IDLE = 0
S_REF_ISSUE = 1
S_REF_WAIT = 2
S_SREF_ISSUE = 3
S_SREF = 4                        # parked in self refresh
S_SREF_EXIT_ISSUE = 5
S_SREF_EXIT_WAIT = 6
S_ACT_ISSUE = 7
S_ACT_WAIT = 8
S_RW_ISSUE = 9
S_RW_WAIT = 10
S_PRE_ISSUE = 11
S_PRE_WAIT = 12
S_RESP_PEND = 13                  # completion token awaiting response arbiter
NUM_STATES = 14

# DRAM commands on the shared bus ----------------------------------------
CMD_NOP = 0
CMD_ACT = 1
CMD_RD = 2
CMD_WR = 3
CMD_PRE = 4
CMD_REF = 5
CMD_SREF_ENTER = 6
CMD_SREF_EXIT = 7
NUM_CMDS = 8

# pending-after-precharge codes (open-page mode)
P_NONE, P_RW, P_REF, P_SREF = 0, 1, 2, 3

DEFAULT_CONFIG = MemSimConfig()

if RuntimeParams() != RuntimeParams.from_config(DEFAULT_CONFIG):
    raise RuntimeError(
        "RuntimeParams field defaults drifted from MemSimConfig defaults: "
        f"{RuntimeParams()} != {RuntimeParams.from_config(DEFAULT_CONFIG)}")
