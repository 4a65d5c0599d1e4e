"""End-to-end training driver on one card.

The port of the reference's ``launch/train.py``: config -> train step ->
deterministic data pipeline -> async checkpointing -> resume ->
straggler watchdog. Training runs the reference's default route,
``attention_impl="blocked"`` (plain PyTorch, differentiated by
autograd): the launcher sets it on the config and prints it, and
:func:`train` refuses the kernel route, whose Hopper kernels have no
backward pass. The reference's ``--mesh`` (a sharded step over a device
mesh) has no counterpart on one card.

Usage (on the CUDA card; ``--device cpu`` runs without one):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.simulator import resolve_device
from repro_torch.data import DataConfig, make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (State, check_trainable, init_train_state,
                                    make_train_step)


@dataclasses.dataclass
class Watchdog:
    """Straggler/hang detection: flags steps slower than ``factor`` x the
    median of the last 50; here it logs and counts."""
    factor: float = 3.0
    history: Optional[list] = None
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        self.history = (self.history or [])
        self.history.append(dt)
        med = float(np.median(self.history[-50:]))
        slow = len(self.history) > 5 and dt > self.factor * med
        self.flagged += int(slow)
        return slow


def batch_on(dcfg: DataConfig, step: int, device) -> dict:
    """The pipeline's batch for ``step`` as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in make_batch(dcfg, step).items()}


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          opt: Optional[AdamWConfig] = None, log_every: int = 10,
          resume: bool = True, device="cuda") -> Tuple[State, List[float]]:
    """Train ``cfg`` from seed 0 (or the newest checkpoint under
    ``ckpt_dir``) up to ``steps``; returns (state, the losses of the steps
    run here). A checkpoint is saved every ``ckpt_every`` steps and at the
    end."""
    check_trainable(cfg)
    device = resolve_device(device)
    opt = opt or AdamWConfig(total_steps=steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch)
    store = CheckpointStore(ckpt_dir) if ckpt_dir else None
    watchdog = Watchdog()
    state = init_train_state(
        cfg, generator=torch.Generator(device).manual_seed(0), device=device)
    start = 0
    if store and resume and store.latest_step() is not None:
        state, start = store.restore(state)
        print(f"[train] resumed from step {start}")
    step_fn = make_train_step(cfg, opt)
    losses = []
    for step in range(start, steps):
        t0 = time.time()
        state, metrics = step_fn(state, batch_on(dcfg, step, device))
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0
        if watchdog.observe(dt):
            print(f"[train] straggler: step {step} took {dt:.2f}s")
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt:.2f}s)", flush=True)
        if store and (step + 1) % ckpt_every == 0:
            store.save(step + 1, state)
    if store:
        store.save(steps, state, wait=True)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attention_impl="blocked")
    print(f"[train] {cfg.name}: attention_impl={cfg.attention_impl!r} "
          f"(plain routes; the kernels have no backward), remat="
          f"{cfg.remat!r}, device {args.device}")
    train(cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
          ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
