"""Training launcher: the end-to-end entry point, with fault tolerance
(counterpart of ``repro/launch/train.py``, the same flags and result keys,
plus ``--device``, ``--repeat-batch`` and ``--n-layers``, a cut in depth).

  * restart: resumes from the latest checkpoint of ``--ckpt-dir`` (the
    port's ``CheckpointManager``; the state as ``train_step.state_leaves``
    lists it);
  * preemption safety: SIGTERM and SIGINT finish the current step, write
    a checkpoint and exit; ``--stop-after N`` does the same after N steps
    (a simulated preemption);
  * deterministic data skip-ahead: the token stream is counter-based
    (``data.pipeline.TokenStream``), so a restarted run consumes exactly
    the batches it would have;
  * straggler telemetry: steps slower than ``--straggler-factor`` times
    the trailing median are logged;
  * ``--multihost``: the reference calls ``jax.distributed.initialize()``,
    a no-op on one host; the port runs one process, so it has nothing to
    initialise.

It runs on the card (``--device cuda``, the default) and raises where
none is visible, unless the caller asks for the CPU. The parameters are
float32 master weights; activations run in ``cfg.dtype``. Whisper's
``enc_frames`` and the vision stub's prefix embeddings are zeros, and the
prefix positions' labels -1, as the reference feeds them.

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --steps 50 --batch 8 --seq 64 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import statistics
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.models import model as M
from repro_torch.sharding.rules import unpadded_plan
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    load_state_leaves,
    make_train_step,
    state_leaves,
)
from repro_torch.utils import resolve_device


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the model to this many layers (0: as "
                         "configured)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--stop-after", type=int, default=0,
                    help="stop (checkpoint+exit) after N steps: a "
                         "simulated preemption")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeat-batch", action="store_true",
                    help="feed step 0's batch at every step")
    return ap.parse_args(argv)


def make_batch(cfg, data: TokenStream, step: int, args, dev) -> dict:
    """The step's batch on ``dev``, with the frontend's inputs; split into
    ``args.microbatches`` along a new leading dim when there are more
    than one."""
    host = data.batch(step)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    dtype = getattr(torch, cfg.dtype)
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = torch.zeros(
            (args.batch, cfg.n_prefix_embeds, cfg.d_model), dtype=dtype,
            device=dev)
        batch["labels"][:, :cfg.n_prefix_embeds] = -1
    if cfg.enc_dec:
        batch["enc_frames"] = torch.zeros(
            (args.batch, cfg.enc_seq, cfg.d_model), dtype=dtype, device=dev)
    if args.microbatches > 1:
        batch = {k: v.reshape(args.microbatches, -1, *v.shape[1:])
                 for k, v in batch.items()}
    return batch


def main(argv=None) -> dict:
    args = parse(argv)
    dev = resolve_device(args.device)
    if args.multihost:
        print("[multihost] one process: nothing to initialise")
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    plan = unpadded_plan(cfg)

    params = M.init_params(cfg, plan, seed=args.seed, device=dev,
                           max_seq=args.seq, dtype=torch.float32)
    state = init_train_state(params)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq} device={dev}")

    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps),
        microbatches=args.microbatches)
    step_fn = make_train_step(cfg, plan, tcfg)
    data = TokenStream(DataConfig(
        seed=args.seed, vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            load_state_leaves(state, mgr.restore(latest, state_leaves(state)))
            start_step = latest
            print(f"[elastic-restart] resumed from step {latest}")

    stop = {"flag": False}

    def handler(signum, frame):
        print(f"[preempt] signal {signum}: checkpoint + exit")
        stop["flag"] = True

    sigs = (signal.SIGTERM, signal.SIGINT)
    old = [signal.signal(s, handler) for s in sigs]
    losses, times, opt_times = [], [], []
    step = start_step
    try:
        for step in range(start_step, args.steps):
            batch = make_batch(cfg, data, 0 if args.repeat_batch else step,
                               args, dev)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            times.append(dt)
            opt_times.append(metrics["opt_s"])
            if len(times) > 8:
                med = statistics.median(times[-32:])
                if dt > args.straggler_factor * med:
                    print(f"[straggler] step {step}: {dt:.2f}s "
                          f"(median {med:.2f}s)")
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt:.2f}s", flush=True)
            if mgr is not None and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, state_leaves(state), blocking=False)
            if args.stop_after and step - start_step + 1 >= args.stop_after:
                print(f"[preempt-sim] stopping after {args.stop_after} steps")
                break
            if stop["flag"]:
                break
    finally:
        for s, h in zip(sigs, old):
            signal.signal(s, h)
    if mgr is not None:
        mgr.save(step + 1, state_leaves(state), blocking=True)
    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps_run": len(losses), "final_step": step + 1,
              "losses": losses, "step_s": times, "opt_s": opt_times,
              "params": n_params}
    if losses:
        print(f"done: loss {result['first_loss']:.4f} -> "
              f"{result['last_loss']:.4f} over {result['steps_run']} steps")
    return result


if __name__ == "__main__":
    main()
