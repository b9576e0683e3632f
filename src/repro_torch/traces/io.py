"""Trace file round-trip in the DRAMSim3 text format.

DRAMSim3's standalone trace format is one request per line::

    0x2AE00000 READ 120
    0x2AE00040 WRITE 128

i.e. hex address, opcode, issue cycle. We read/write that format so traces
are exchangeable with the reference simulator the paper compares against.
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.core.simulator import Trace


def save_trace(path: str, trace: Trace, word_bytes: int = 4) -> None:
    t = trace.t.cpu().numpy()
    addr = trace.addr.cpu().numpy().astype(np.int64) * word_bytes
    wr = trace.is_write.cpu().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(len(t)):
            op = "WRITE" if wr[i] else "READ"
            f.write(f"0x{addr[i]:08X} {op} {int(t[i])}\n")


def save_session_trace(path: str, session, word_bytes: int = 4) -> Trace:
    """Dump a closed-loop session's *realized* address stream — every
    request the scheduler actually emitted across all windows, in arrival
    order — as a DRAMSim3 trace file, so an open-loop replay (here or in
    the reference simulator) can reproduce the closed-loop run's traffic.
    Accepts anything with a ``.trace()`` or a plain
    :class:`~repro_torch.core.simulator.Trace`; returns
    the trace it wrote."""
    trace = session.trace() if hasattr(session, "trace") else session
    save_trace(path, trace, word_bytes)
    return trace


def load_trace(path: str, word_bytes: int = 4) -> Trace:
    ts, addrs, writes = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            a, op, t = parts
            addrs.append(int(a, 16) // word_bytes)
            writes.append(1 if op.upper() == "WRITE" else 0)
            ts.append(int(t))
    return Trace.from_numpy(
        np.asarray(ts, np.int64).astype(np.int32),
        np.asarray(addrs, np.int64) & 0x3FFFFFFF,
        np.asarray(writes, np.int32),
    )
