"""Fixed-capacity circular FIFOs, the RTL Decoupled-queue analogue.

PyTorch counterpart of ``repro.core.queues``:

* ``Fifo``        — one queue: ``buf[Q, F]`` plus 0-d head/count tensors.
* ``BankedFifo``  — B independent queues ``buf[B, Q, F]`` with a vectorized
  per-bank pop and a single-bank push.

All fields are int32; ``F`` packs ``(addr, is_write, data, req_id)``. Every
operation is branchless (masked), so nothing in the cycle loop reads a
device value on the host. Each queue carries a runtime ``limit``
(occupancy cap <= static capacity).

The queue *buffers* are updated in place (a push writes its slot into the
existing ``buf``; the returned queue shares it); head/count/limit tensors
are new objects. Callers that need the pre-push image must clone it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.indexing import put_, take
from repro_torch.core.params import I32

REQ_FIELDS = 4  # addr, is_write, data, req_id
F_ADDR, F_WRITE, F_DATA, F_ID = 0, 1, 2, 3


class Fifo(NamedTuple):
    buf: torch.Tensor    # [Q, F] int32
    head: torch.Tensor   # 0-d int32
    count: torch.Tensor  # 0-d int32
    limit: torch.Tensor  # 0-d int32 runtime occupancy cap (<= capacity)

    @staticmethod
    def make(capacity: int, fields: int = REQ_FIELDS, limit=None,
             device=None) -> "Fifo":
        return Fifo(
            buf=torch.zeros((capacity, fields), dtype=I32, device=device),
            head=torch.zeros((), dtype=I32, device=device),
            count=torch.zeros((), dtype=I32, device=device),
            limit=torch.full((), capacity if limit is None else int(limit),
                             dtype=I32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.buf.shape[0]

    def full(self) -> torch.Tensor:
        return self.count >= self.limit

    def empty(self) -> torch.Tensor:
        return self.count == 0

    def peek(self) -> torch.Tensor:
        """Head item [F]; garbage if empty (callers must mask)."""
        return take(self.buf, self.head)

    def peek_valid(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Masked head-of-queue peek without pop: ``(item [F], valid)``."""
        return self.peek(), ~self.empty()

    def push(self, item: torch.Tensor, enable: torch.Tensor) -> "Fifo":
        # RTL ready & valid: a push into a full queue does not commit
        enable = enable & ~self.full()
        idx = (self.head + self.count) % self.capacity
        put_(self.buf, idx, torch.where(enable, item, take(self.buf, idx)))
        return Fifo(buf=self.buf, head=self.head,
                    count=self.count + enable.to(I32), limit=self.limit)

    def pop(self, enable: torch.Tensor) -> Tuple["Fifo", torch.Tensor]:
        item = self.peek()
        en = enable.to(I32)
        return (
            Fifo(buf=self.buf, head=(self.head + en) % self.capacity,
                 count=self.count - en, limit=self.limit),
            item,
        )


class BankedFifo(NamedTuple):
    buf: torch.Tensor    # [B, Q, F] int32
    head: torch.Tensor   # [B] int32
    count: torch.Tensor  # [B] int32
    limit: torch.Tensor  # 0-d int32 runtime occupancy cap (all banks)

    @staticmethod
    def make(banks: int, capacity: int, fields: int = REQ_FIELDS,
             limit=None, device=None) -> "BankedFifo":
        return BankedFifo(
            buf=torch.zeros((banks, capacity, fields), dtype=I32,
                            device=device),
            head=torch.zeros((banks,), dtype=I32, device=device),
            count=torch.zeros((banks,), dtype=I32, device=device),
            limit=torch.full((), capacity if limit is None else int(limit),
                             dtype=I32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.buf.shape[1]

    def full(self) -> torch.Tensor:           # [B] bool
        return self.count >= self.limit

    def empty(self) -> torch.Tensor:          # [B] bool
        return self.count == 0

    def peek(self) -> torch.Tensor:
        """Per-bank head items [B, F]; garbage where empty."""
        b, _, f = self.buf.shape
        idx = self.head.long().view(b, 1, 1).expand(b, 1, f)
        return torch.gather(self.buf, 1, idx).view(b, f)

    def peek_valid(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Masked per-bank head peek: ``(items [B, F], valid bool[B])``."""
        return self.peek(), ~self.empty()

    def push_at(self, bank: torch.Tensor, item: torch.Tensor,
                enable: torch.Tensor) -> "BankedFifo":
        """Push ``item`` [F] into queue ``bank`` (0-d index), masked and
        gated on the target bank not being at its limit."""
        enable = enable & ~take(self.full(), bank)
        idx = (take(self.head, bank) + take(self.count, bank)) % self.capacity
        b1, i1 = bank.reshape(1), idx.reshape(1)
        cur = self.buf[b1, i1]                                       # [1, F]
        self.buf.index_put_((b1, i1), torch.where(enable, item, cur[0])[None])
        count = self.count.index_add(0, b1, enable.to(I32).reshape(1))
        return BankedFifo(buf=self.buf, head=self.head, count=count,
                          limit=self.limit)

    def pop_mask(self, enable: torch.Tensor
                 ) -> Tuple["BankedFifo", torch.Tensor]:
        """Every bank whose ``enable`` bit is set pops its head. Returns
        (new_fifo, items[B, F])."""
        items = self.peek()
        en = enable.to(I32)
        return (
            BankedFifo(buf=self.buf, head=(self.head + en) % self.capacity,
                       count=self.count - en, limit=self.limit),
            items,
        )

    def promote_rowhit(self, open_row: torch.Tensor,
                       rows: torch.Tensor) -> "BankedFifo":
        """FR-FCFS: swap the oldest row-hit entry into the head slot, unless
        an older entry touches the same address. ``open_row`` int32[B]
        (-1 = no open row); ``rows`` int32[B, Q] row of every slot in age
        order. ``argmax`` returns the first maximal index, i.e. the oldest
        hit, as ``jnp.argmax`` does."""
        b, q, _ = self.buf.shape
        dev = self.buf.device
        ar_q = torch.arange(q, dtype=I32, device=dev)
        ar_b = torch.arange(b, device=dev)
        offs = (self.head[:, None] + ar_q[None, :]) % q              # [B, Q]
        addr = torch.gather(self.buf[..., F_ADDR], 1, offs.long())
        valid = ar_q[None, :] < self.count[:, None]
        hit = valid & (rows == open_row[:, None]) & (open_row >= 0)[:, None]
        first = hit.to(I32).argmax(dim=1).to(I32)                     # [B]
        has = hit.any(dim=1)
        addr_sel = torch.gather(addr, 1, first.long()[:, None])[:, 0]
        older = ar_q[None, :] < first[:, None]
        conflict = (older & valid & (addr == addr_sel[:, None])).any(dim=1)
        sel = torch.where(has & ~conflict, first, torch.zeros_like(first))
        head = self.head.long()
        pos = ((self.head + sel) % q).long()
        head_items = self.buf[ar_b, head]
        sel_items = self.buf[ar_b, pos]
        self.buf[ar_b, head] = sel_items
        self.buf[ar_b, pos] = head_items
        return self


def rr_arbiter(bids: torch.Tensor, ptr: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotating-priority round-robin arbiter (paper §5.3).

    ``bids`` bool[B]; ``ptr`` 0-d int32. Returns ``(winner, any_grant,
    new_ptr)``; the bank at ``ptr`` has highest priority and the pointer
    moves one past the winner. ``%`` is a floor-mod, as in jnp."""
    n = bids.shape[0]
    rot = (torch.arange(n, dtype=I32, device=bids.device) - ptr) % n
    key = torch.where(bids, rot, torch.full_like(rot, n))
    winner = key.argmin().to(I32)
    any_grant = bids.any()
    new_ptr = torch.where(any_grant, (winner + 1) % n, ptr)
    return winner, any_grant, new_ptr


def rr_arbiter_grouped(bids: torch.Tensor, ptrs: torch.Tensor, groups: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel round-robin: one grant per group of ``B//groups`` banks.

    ``bids`` bool[B] flattened channel-major; ``ptrs`` int32[groups].
    Returns (grant_mask bool[B], winners int32[groups], new_ptrs)."""
    b = bids.shape[0]
    if b % groups != 0:
        raise ValueError(
            f"rr_arbiter_grouped: {b} banks do not divide into {groups} "
            f"groups; the trailing {b % groups} banks would never arbitrate")
    per = b // groups
    bids2 = bids.reshape(groups, per)
    ar = torch.arange(per, dtype=I32, device=bids.device)
    rot = (ar[None, :] - ptrs[:, None]) % per
    key = torch.where(bids2, rot, torch.full_like(rot, per))
    winners = key.argmin(dim=1).to(I32)
    any_grant = bids2.any(dim=1)
    new_ptrs = torch.where(any_grant, (winners + 1) % per, ptrs)
    grant = (ar[None, :] == winners[:, None]) & any_grant[:, None]
    return grant.reshape(b), winners, new_ptrs
