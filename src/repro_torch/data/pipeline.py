"""Synthetic sharded data pipeline with host-local prefetch.

This package's copy of ``repro.data.pipeline`` (a numpy module): every
host generates only its shard of the global batch, and the token stream
is a deterministic function of (seed, step, host), so a resumed run from
step k sees exactly the stream the crashed run would have seen, and the
batches are the reference's, array for array. A background thread keeps
``prefetch`` batches ready so step N+1's data is made while step N runs.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


class SyntheticLM:
    """Deterministic synthetic LM token stream (shifted-label batches)."""

    def __init__(self, cfg: ArchConfig, global_batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        if global_batch % num_hosts:
            raise ValueError(f"global batch {global_batch} is not a "
                             f"multiple of {num_hosts} hosts")
        self.cfg = cfg
        self.local_batch = global_batch // num_hosts
        self.seq = seq_len
        self.seed = seed
        self.host = host_id

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 64 + self.host)
        # zipf-ish token distribution: a realistic router/embedding load
        z = rng.zipf(1.3, size=(self.local_batch, self.seq + 1))
        toks = (z % (self.cfg.vocab - 1)).astype(np.int32) + 1
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend != "none" and not self.cfg.is_encdec:
            embeds = rng.standard_normal(
                (self.local_batch, self.seq, self.cfg.d_model)
            ).astype(np.float32)
            batch = {"embeds": embeds * 0.02, "labels": toks[:, 1:]}
        if self.cfg.is_encdec:
            src = rng.standard_normal(
                (self.local_batch, self.seq, self.cfg.d_model)
            ).astype(np.float32)
            batch = {"src_embeds": src * 0.02, "tgt_tokens": toks[:, :-1],
                     "labels": toks[:, 1:]}
        return batch


class Prefetcher:
    """Background-thread prefetch of a step-indexed source: iterating
    yields ``(step, batch)`` from ``start_step`` on, in order."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 prefetch: int = 2):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
