"""Ideal reference model — a DRAMSim3-like open-page software simulator.

PyTorch-package counterpart of ``repro.core.ideal``: an event-driven,
per-bank FCFS model with open-page row buffers (hit ``tCL + tCCDL``, miss
``tRP + tRCD + tCL``, closed bank ``tRCD + tCL``), periodic refresh
(``tRFC`` every ``tREFI``), infinite queues and bit-true data.

It is a scalar recurrence over the N time-sorted requests, each step
depending on the previous one through its bank's state. It therefore runs
on the host over Python ints — N launches of one-element kernels would be
absurd on a GPU — and returns its tensors on the requested device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.dram_model import decode_address
from repro_torch.core.params import MemSimConfig, RuntimeParams
from repro_torch.core.simulator import Trace, resolve_device


class IdealResult(NamedTuple):
    t_complete: torch.Tensor  # [N] completion cycle per request
    rdata: torch.Tensor       # [N] read data (0 for writes)


def _run(cfg: MemSimConfig, trace: Trace, rp: RuntimeParams):
    topo = cfg.topology()
    t = trace.t.cpu()
    bank_t, _, row_t = decode_address(topo, trace.addr.cpu())
    arrive = t.numpy().tolist()
    banks = bank_t.numpy().tolist()
    rows = row_t.numpy().tolist()
    addrs = trace.addr.cpu().numpy().tolist()
    writes = trace.is_write.cpu().numpy().tolist()
    wdata = trace.wdata.cpu().numpy().tolist()
    p = {f: int(getattr(rp, f)) for f in RuntimeParams._fields}

    b = topo.num_banks
    bank_free = [0] * b
    open_row = [-1] * b
    next_refresh = [p["tREFI"]] * b
    mem = {}
    n = len(arrive)
    t_complete = [0] * n
    rdata = [0] * n
    mask = topo.mem_words - 1
    for i in range(n):
        bank = banks[i]
        ready = max(arrive[i], bank_free[bank])
        # refresh: catch up a deadline passed before service begins
        nref = next_refresh[bank]
        if ready >= nref:
            ready = max(ready, nref + p["tRFC"])
            nref = nref + p["tREFI"]
        cur_row = open_row[bank]
        is_wr = writes[i] == 1
        t_rcd = p["tRCDWR"] if is_wr else p["tRCDRD"]
        if cur_row == rows[i]:
            service = p["tCL"] + p["tCCDL"]
        elif cur_row < 0:
            service = t_rcd + p["tCL"]
        else:
            service = p["tRP"] + t_rcd + p["tCL"]
        done = ready + service
        maddr = addrs[i] & mask
        rdata_i = mem.get(maddr, 0)
        if is_wr:
            mem[maddr] = wdata[i]
        bank_free[bank] = done
        open_row[bank] = rows[i]  # open-page: the row stays open
        next_refresh[bank] = nref
        t_complete[i] = done
        rdata[i] = 0 if is_wr else rdata_i
    # int32 results, wrapping as the reference's int32 arithmetic does
    return (np.asarray(t_complete, np.int64).astype(np.int32),
            np.asarray(rdata, np.int64).astype(np.int32))


def simulate_ideal(cfg: MemSimConfig, trace: Trace, *,
                   params: RuntimeParams = None, device=None) -> IdealResult:
    """Run the open-page reference; returns per-request completion cycles
    (and read data) as int32 tensors on ``device`` (default: the CUDA
    card, raising without one)."""
    dev = resolve_device(device)
    rp = cfg.runtime() if params is None else params
    tc, rd = _run(cfg, trace, rp)
    return IdealResult(t_complete=torch.from_numpy(tc).to(dev),
                       rdata=torch.from_numpy(rd).to(dev))


def ideal_latencies(cfg: MemSimConfig, trace: Trace,
                    device=None) -> np.ndarray:
    res = simulate_ideal(cfg, trace, device=device)
    return res.t_complete.cpu().numpy() - trace.t.cpu().numpy()
