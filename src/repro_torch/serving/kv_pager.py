"""Paged KV-cache manager: block allocation, eviction, tiered placement.

The serving stack's memory map. Sequences own chains of fixed-size KV
blocks from a bounded pool (the vLLM/MaxText paged-attention model; the
``PageState`` snapshot threaded to the scheduler follows the MaxText
``page_manager``/``page_state`` idiom — an immutable view of pool
occupancy that admission decisions read, never mutate). The pager turns
scheduler intents into *word addresses* for the memory simulator:

* ``append_addrs``  — the new token's KV write lands at the sequence tail,
  allocating a fresh block when the tail block fills;
* ``gather_addrs``  — the decode attention gather over the sequence's
  blocks, recency-weighted toward the hot tail;
* tier-aware placement — on a tiered topology (DRAM + CXL expander)
  the last ``hot_blocks`` blocks of each sequence live in DRAM address
  space and every older block is *demoted* to the CXL expander space,
  through the same :func:`repro_torch.traces.llm_workload.dram_words` /
  :func:`~repro_torch.traces.llm_workload.cxl_words` placement maps the
  open-loop tiered traces use (so the stream matches the lane's
  ``tier_interleave_log2`` / ``tier_cxl_frac_log2`` flags).

Eviction is at sequence boundaries: a finished sequence returns its whole
chain to the free list. When the pool runs dry the pager refuses
admission (``can_admit``) — allocation pressure is a *backpressure
signal* to the scheduler, not an exception.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.traces.llm_workload import cxl_words, dram_words


@dataclasses.dataclass(frozen=True)
class PageState:
    """Immutable pool-occupancy snapshot (the MaxText ``page_state``
    threading idiom): the scheduler reads this to gate admission."""

    num_blocks: int
    free_blocks: int
    used_blocks: int
    sequences: int

    @property
    def occupancy(self) -> float:
        return self.used_blocks / max(self.num_blocks, 1)


class KVPager:
    """Block-granular KV-cache manager for one device's KV pool.

    ``block_words`` words per block, ``words_per_token`` KV words appended
    per generated token. ``tiered=True`` routes block addresses through
    the DRAM/CXL placement maps (``interleave_log2`` / ``cxl_frac_log2``
    must then match the simulated lane's placement flags).
    """

    def __init__(self, num_blocks: int = 64, block_words: int = 256,
                 words_per_token: int = 32, *, hot_blocks: int = 2,
                 tiered: bool = False, interleave_log2: int = 6,
                 cxl_frac_log2: int = 1, kv_base: int = 1 << 22,
                 addr_mask: int = 0x3FFFFFFF):
        if block_words % words_per_token:
            raise ValueError("block_words must be a words_per_token multiple")
        self.num_blocks = num_blocks
        self.block_words = block_words
        self.words_per_token = words_per_token
        self.hot_blocks = max(1, hot_blocks)
        self.tiered = tiered
        self.interleave_log2 = interleave_log2
        self.cxl_frac_log2 = cxl_frac_log2
        self.kv_base = kv_base
        self.addr_mask = addr_mask
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._chains: Dict[int, List[int]] = {}
        self._fill: Dict[int, int] = {}  # words filled in the tail block

    # ---- occupancy ---------------------------------------------------------

    def page_state(self) -> PageState:
        used = self.num_blocks - len(self._free)
        return PageState(num_blocks=self.num_blocks,
                         free_blocks=len(self._free), used_blocks=used,
                         sequences=len(self._chains))

    def blocks_for_tokens(self, tokens: int) -> int:
        words = tokens * self.words_per_token
        return -(-words // self.block_words)

    def can_admit(self, prompt_tokens: int) -> bool:
        """Enough free blocks to hold the prompt's KV plus one growth
        block for the first generated token?"""
        return (self.blocks_for_tokens(prompt_tokens) + 1
                <= len(self._free))

    # ---- sequence lifecycle ------------------------------------------------

    def admit(self, rid: int) -> None:
        if rid in self._chains:
            raise ValueError(f"sequence {rid} already admitted")
        self._chains[rid] = []
        self._fill[rid] = 0

    def free_seq(self, rid: int) -> None:
        """Sequence-boundary eviction: the whole chain returns to the
        pool."""
        for bid in self._chains.pop(rid):
            self._free.append(bid)
        self._fill.pop(rid)

    # ---- address generation ------------------------------------------------

    def append_addrs(self, rid: int, tokens: int = 1) -> np.ndarray:
        """Word addresses of ``tokens`` new tokens' KV writes at the
        sequence tail, allocating blocks as the tail fills. Raises if the
        pool is dry — schedulers gate on :meth:`can_admit` /
        :meth:`page_state` first. Vectorized: one block-sized chunk per
        allocation instead of a per-word Python loop (same addresses)."""
        chain = self._chains[rid]
        remaining = tokens * self.words_per_token
        chunks = []
        while remaining:
            if not chain or self._fill[rid] == self.block_words:
                if not self._free:
                    raise RuntimeError(
                        f"KV pool exhausted ({self.num_blocks} blocks); "
                        "admission must gate on can_admit()")
                chain.append(self._free.pop())
                self._fill[rid] = 0
            take = min(remaining, self.block_words - self._fill[rid])
            # the tail block is by definition inside the hot window
            chunks.append(self.kv_base + chain[-1] * self.block_words
                          + self._fill[rid]
                          + np.arange(take, dtype=np.int64))
            self._fill[rid] += take
            remaining -= take
        idx = (np.concatenate(chunks) if chunks
               else np.zeros(0, np.int64))
        if self.tiered:
            idx = np.asarray(dram_words(idx, self.interleave_log2,
                                        self.cxl_frac_log2), np.int64)
        return idx & self.addr_mask

    def gather_addrs(self, rid: int, n: int,
                     rng: np.random.Generator) -> np.ndarray:
        """Word addresses of an ``n``-read attention gather over the
        sequence's KV: recency-weighted — most reads hit the hot tail
        window (DRAM on tiered topologies), the rest the demoted cold
        blocks (CXL). Vectorized: the hot/cold choices, block positions
        and in-block offsets are batched draws (still deterministic per
        ``rng`` state)."""
        chain = self._chains[rid]
        if not chain:
            return np.zeros(0, np.int64)
        n_chain = len(chain)
        hot_lo = max(0, n_chain - self.hot_blocks)
        if n_chain > self.hot_blocks:
            cold = rng.random(n) < 0.25
            pos = np.where(cold,
                           rng.integers(0, n_chain - self.hot_blocks,
                                        size=n),
                           rng.integers(hot_lo, n_chain, size=n))
        else:
            pos = rng.integers(hot_lo, n_chain, size=n)
        limit = np.where(pos == n_chain - 1,
                         max(self._fill[rid], 1), self.block_words)
        off = (rng.random(n) * limit).astype(np.int64)
        idx = (self.kv_base
               + np.asarray(chain, np.int64)[pos] * self.block_words + off)
        if self.tiered:
            hot = pos >= n_chain - self.hot_blocks
            idx = np.where(
                hot,
                np.asarray(dram_words(idx, self.interleave_log2,
                                      self.cxl_frac_log2), np.int64),
                np.asarray(cxl_words(idx, self.interleave_log2,
                                     self.cxl_frac_log2), np.int64))
        return idx & self.addr_mask
