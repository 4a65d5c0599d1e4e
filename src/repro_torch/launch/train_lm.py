"""End-to-end LM training: a qwen3-family model from a few steps to a few
hundred, with checkpoint/restart (stop it mid-run and rerun: it resumes),
the straggler watchdog and deterministic data.

The counterpart of the reference's ``examples/train_lm.py`` (``lm_10m``
by default, ``--full`` for ``lm_100m`` and 300 steps), and with
``--quick`` of part 3 of its ``examples/quickstart.py`` (the qwen3
smoke config, 20 steps of B=4 x T=64, which prints its losses as the
quickstart does: 20 steps stay inside the default 100-step warmup).
``lm_10m`` and ``lm_100m`` assert that the loss went down. Every mode
trains on the plain routes (``train`` refuses the kernel route).

Usage (on the CUDA card; ``--device cpu`` runs without one):
  PYTHONPATH=src python -m repro_torch.launch.train_lm [--full | --quick]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train
from repro_torch.models.config import ModelConfig


def lm_100m() -> ModelConfig:
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=10, d_model=640,
        n_heads=10, n_kv_heads=5, head_dim=64, d_ff=2560,
        vocab_size=32768, qk_norm=True, dtype="float32",
        remat="none", attn_chunk=128, attention_impl="blocked")


def lm_10m() -> ModelConfig:
    return ModelConfig(
        name="lm-10m", family="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=1024,
        vocab_size=8192, qk_norm=True, dtype="float32",
        remat="none", attn_chunk=128, attention_impl="blocked")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--full", action="store_true",
                      help="lm_100m for 300 steps at T=256")
    mode.add_argument("--quick", action="store_true",
                      help="the qwen3 smoke config, 20 steps, B=4, T=64")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here, and resume from it")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                                  attention_impl="blocked")
        steps, seq, every = args.steps or 20, 64, 5
    else:
        cfg = lm_100m() if args.full else lm_10m()
        steps = args.steps or (300 if args.full else 60)
        seq, every = (256 if args.full else 128), 10
    n = cfg.param_count() / 1e6
    print(f"[train_lm] {cfg.name}: {n:.0f}M params, {steps} steps, "
          f"attention_impl={cfg.attention_impl!r}")
    _, losses = train(cfg, steps=steps, global_batch=4, seq_len=seq,
                      ckpt_dir=args.ckpt_dir, ckpt_every=25,
                      log_every=every, device=args.device)
    if not losses:
        print("[train_lm] nothing to run: the checkpoint is at the last step")
        return
    print(f"[train_lm] loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps")
    if not args.quick and not losses[-1] < losses[0]:
        raise AssertionError("loss must decrease")


if __name__ == "__main__":
    main()
