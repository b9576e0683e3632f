"""Batched serving loop: continuous batching with a real waiting queue.

Requests sit in a waiting queue until a batch slot frees, join ONLY at
sequence boundaries (a finishing sequence releases its slot; nothing is
preempted mid-stream), and every decode step runs the one-token step over
the whole batch with a per-slot position vector. A joining request resets
its slot's position to 0: cache entries beyond a slot's position are never
attended under causal masking, so slot reuse needs no cache clearing. A
Mamba layer's state is not reset: a reused slot carries the previous
request's ``h`` and ``conv`` into the next one, as in the reference
server (ROADMAP §3); so does an mLSTM or sLSTM layer's ``c``, ``n`` and
``m``, and an idle slot's state moves on under its token 0.
Prompt tokens are teacher-forced one per step. The loop reads the step's
next tokens on the host once per step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --tiny \
      --device cpu --batch 4 --requests 10 --prompt-len 16 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-v0.1-52b --tiny --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v3-671b --tiny --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch xlstm-1.3b --tiny --device cpu

An encoder-decoder config (seamless-m4t-medium) exits, as the reference
server does: its prefill and decode step are ``launch.steps``'.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.simulator import resolve_device
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import registry


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt: np.ndarray
    max_new: int
    pos: int = 0                 # per-slot position (resets to 0 on join)
    prompt_idx: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)


def serve_loop(decode, params, caches, prompts: List[np.ndarray],
               max_news: List[int], batch: int, *,
               max_seq: Optional[int] = None):
    """Continuous-batching loop over ``len(prompts)`` requests with
    ``batch`` slots. Returns (generated token lists per request, joined
    step index per request, total steps)."""
    waiting = deque(
        _Slot(rid=i, prompt=np.asarray(p, np.int32), max_new=int(n))
        for i, (p, n) in enumerate(zip(prompts, max_news)))
    slots: List[Optional[_Slot]] = [None] * batch
    outputs: List[Optional[List[int]]] = [None] * len(prompts)
    joined = [-1] * len(prompts)
    last_tok = np.zeros((batch,), np.int32)
    steps = 0
    while waiting or any(s is not None for s in slots):
        for i in range(batch):  # join at sequence boundaries only
            if slots[i] is None and waiting:
                slots[i] = waiting.popleft()
                joined[slots[i].rid] = steps
                last_tok[i] = slots[i].prompt[0]
        tok = np.zeros((batch,), np.int32)
        pos = np.zeros((batch,), np.int32)
        for i, s in enumerate(slots):
            if s is None:
                continue  # idle slot: token 0 at pos 0, output ignored
            tok[i] = (s.prompt[s.prompt_idx] if s.prompt_idx < len(s.prompt)
                      else last_tok[i])
            pos[i] = s.pos
            if max_seq is not None and s.pos >= max_seq:
                raise ValueError(f"request {s.rid} overflows max_seq={max_seq}")
        nxt, _, caches = decode(params, caches, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        nxt = nxt.cpu().numpy()
        steps += 1
        for i, s in enumerate(slots):
            if s is None:
                continue
            s.pos += 1
            if s.prompt_idx < len(s.prompt):
                s.prompt_idx += 1  # teacher-forced prefill, one token/step
                if s.prompt_idx < len(s.prompt):
                    continue
                # the last prompt token's output is the first generation
            s.generated.append(int(nxt[i]))
            last_tok[i] = nxt[i]
            if len(s.generated) >= s.max_new:
                outputs[s.rid] = s.generated  # sequence boundary: slot frees
                slots[i] = None
    return outputs, joined, steps


def make_requests(seed: int, vocab: int, requests: int, prompt_len: int,
                  max_new: int) -> Tuple[List[np.ndarray], List[int]]:
    """Mixed-length requests, so that joins happen mid-run: prompt lengths
    in [max(2, prompt_len // 2), prompt_len], generation lengths in
    [max(2, max_new // 2), max_new], tokens in [1, vocab), drawn from
    ``numpy.random.default_rng(seed)`` in the reference server's order."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(max(2, prompt_len // 2), prompt_len + 1,
                         size=requests)
    news = rng.integers(max(2, max_new // 2), max_new + 1, size=requests)
    prompts = [rng.integers(1, vocab, size=(int(p),)).astype(np.int32)
               for p in plens]
    return prompts, [int(n) for n in news]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    if cfg.is_encdec:
        raise SystemExit(f"{cfg.name} is an encoder-decoder model: serve it "
                         f"through launch.steps.make_prefill and "
                         f"make_decode_step, not this loop")
    dev = resolve_device(args.device)

    params = registry.init_params(cfg, args.seed, device=dev)
    decode = make_decode_step(cfg, dtype=torch.float32, device=dev)
    prompts, news = make_requests(args.seed, cfg.vocab, args.requests,
                                  args.prompt_len, args.max_new)

    caches = registry.init_caches(cfg, args.batch, args.max_seq, device=dev)
    t0 = time.time()
    outputs, joined, steps = serve_loop(
        decode, params, caches, prompts, news, args.batch,
        max_seq=args.max_seq)
    dt = time.time() - t0
    total_tokens = int(sum(len(p) for p in prompts) + sum(news))
    print(f"[serve] {args.requests} reqs through {args.batch} slots in "
          f"{steps} steps, {dt:.2f}s -> {total_tokens/dt:.0f} tok/s "
          f"on {dev}")
    print(f"[serve] join steps: {joined}")
    for i in range(min(args.requests, 2)):
        print(f"  req{i}: {outputs[i][:16]}")


if __name__ == "__main__":
    main()
