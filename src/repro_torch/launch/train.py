"""Fault-tolerant training launcher.

PyTorch counterpart of ``repro.launch.train``, with its flags and printed
lines. A supervision loop around the train step (``launch.steps``):

  * checkpoint/restart: restores the latest committed checkpoint on
    launch (``--resume``), snapshots asynchronously every
    ``--checkpoint-every`` steps and commits atomically
    (``checkpoint.store.CheckpointStore``, the reference's file format);
  * watchdog: a heartbeat file is written every step; an external
    supervisor restarts the job when it goes stale, and the restart lands
    on the last committed checkpoint;
  * deterministic data: the pipeline is a function of (seed, step, host),
    so a restart replays the exact stream;
  * device-failure drill: ``--fail-at-step`` injects a crash after that
    step's checkpoint, and a later ``--resume`` run reproduces the same
    loss trajectory.

It trains in float32, as the reference's CLI does, on the CUDA card
unless given ``--device`` (``--device cpu`` for the CPU); without a card
and without ``--device`` it raises.

Usage (CPU-scale example):
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
      --tiny --device cpu --steps 50 --batch 8 --seq 128 \
      --ckpt-dir /tmp/ckpt --resume
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.core.simulator import resolve_device
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry
from repro_torch.optim import AdamWConfig, adamw_init, schedules


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default=None,
                    help="wsd|cosine|const (default: wsd for minicpm)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a crash (fault-tolerance drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    dev = resolve_device(args.device)
    sched_name = args.schedule or (
        "wsd" if cfg.name.startswith("minicpm") else "cosine")
    schedule = schedules.make(sched_name, args.lr, args.steps)

    step_fn = make_train_step(
        cfg, schedule=schedule, opt_cfg=AdamWConfig(), dtype=torch.float32,
        num_microbatches=args.microbatches,
        grad_compression=args.grad_compression, device=dev)

    params = registry.init_params(cfg, args.seed, device=dev)
    opt_state = adamw_init(params)
    if args.grad_compression:
        from repro_torch.optim import compression
        opt_state["err"] = compression.init_error(params)

    start_step = 0
    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    if store and args.resume and store.latest_step() is not None:
        params, opt_state, start_step, _ = store.restore(params, opt_state)
        print(f"[train] resumed from step {start_step}")

    source = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    data = Prefetcher(source, start_step=start_step)
    heartbeat = os.path.join(args.ckpt_dir or tempfile.gettempdir(),
                             "heartbeat")

    t0 = time.time()
    tokens_done = 0
    try:
        for step, batch in data:
            if step >= args.steps:
                break
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            tokens_done += args.batch * args.seq
            with open(heartbeat, "w") as f:     # watchdog liveness
                f.write(str(step))
            if step % args.log_every == 0 or step == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                tps = tokens_done / max(time.time() - t0, 1e-9)
                print(f"[train] step {step} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.2f} lr={m['lr']:.2e} "
                      f"tok/s={tps:.0f}")
            if store and (step + 1) % args.checkpoint_every == 0:
                store.save_async(step + 1, params, opt_state,
                                 extra={"loss": float(metrics["loss"])})
            if args.fail_at_step is not None and step == args.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
    finally:
        data.close()
        if store:
            store.wait()
    print(f"[train] done: {args.steps} steps in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
