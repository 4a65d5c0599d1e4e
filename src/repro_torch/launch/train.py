"""End-to-end training driver, on one card or over a device mesh.

The port of the reference's ``launch/train.py``: config -> mesh/rules ->
train step -> deterministic data pipeline -> async checkpointing ->
resume -> straggler watchdog. Training runs the reference's default
route, ``attention_impl="blocked"`` (plain PyTorch, differentiated by
autograd): the launcher sets it on the config and prints it, and
:func:`train` refuses the kernel route, whose Hopper kernels have no
backward pass.

``--mesh test`` is the reference's sharded step on a small mesh. Where
the reference runs one controller over every device, the port runs one
process per device: ``sharding.compat.spawn`` starts ``--nproc`` ranks (4 by
default), joined by NCCL with rank r on ``cuda:r`` (``gloo`` with
``--device cpu``) at ``--init-method`` (default: a free local TCP port),
each running :func:`train` on the mesh (2, N/2) for an even N of 4 or
more, else (1, N), under the reference's "tp" rules (``train(...,
profile="dp")`` runs the other profile; see ``repro_torch.train.step``).
Rank 0 logs, the watchdog's flags too;
checkpoints hold full leaves (``repro_torch.checkpoint``), so a run
resumes on any mesh. NCCL needs a card per rank.

Usage (on the CUDA card; ``--device cpu`` runs without one):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 5 --mesh test --nproc 4 --device cpu
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
from repro_torch.sharding.compat import rank_device, spawn
from repro_torch.sharding.rules import make_rules
from repro_torch.train.step import (State, batch_shard, check_trainable,
                                    init_train_state, make_train_step,
                                    place_train_state, state_placements)


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


def _is_rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          opt: Optional[AdamWConfig] = None, log_every: int = 10,
          resume: bool = True, device="cuda", mesh=None,
          profile: str = "tp") -> Tuple[State, List[float]]:
    """Train ``cfg`` from seed 0 (or the newest checkpoint under
    ``ckpt_dir``) up to ``steps``; returns (state, the losses of the steps
    run here). A checkpoint is saved every ``ckpt_every`` steps and at the
    end. With ``mesh`` (every rank of its process group calls this, each
    with its own ``device``), the step is sharded under
    ``make_rules(..., profile=profile)`` and each rank reads its slice of
    the global batch; only rank 0 logs."""
    check_trainable(cfg)
    device = resolve_device(device)
    opt = opt or AdamWConfig(total_steps=steps)
    rules = (make_rules(cfg, mesh, batch_size=global_batch, profile=profile)
             if mesh is not None else None)
    n_shards, shard = batch_shard(mesh, rules) if mesh is not None else (1, 0)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, n_shards=n_shards,
                      shard=shard)
    store = CheckpointStore(ckpt_dir) if ckpt_dir else None
    watchdog = Watchdog()
    rank0 = _is_rank0()
    state = init_train_state(
        cfg, generator=torch.Generator(device).manual_seed(0), device=device)
    if mesh is not None:
        state = place_train_state(state, cfg, mesh, rules)
    start = 0
    if store and resume and store.latest_step() is not None:
        if mesh is not None:
            state, start = store.restore(
                state, mesh=mesh, placements=state_placements(
                    state["params"], cfg, mesh, rules))
        else:
            state, start = store.restore(state)
        if rank0:
            print(f"[train] resumed from step {start}")
    step_fn = make_train_step(cfg, opt, mesh=mesh, rules=rules)
    losses = []
    for step in range(start, steps):
        t0 = time.time()
        state, metrics = step_fn(state, batch_on(dcfg, step, device))
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0
        if watchdog.observe(dt) and rank0:
            print(f"[train] straggler: step {step} took {dt:.2f}s")
        if rank0 and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt:.2f}s)", flush=True)
        if store and (step + 1) % ckpt_every == 0:
            store.save(step + 1, state)
    if store:
        store.save(steps, state, wait=True)
    return state, losses


def test_mesh_shape(nproc: int) -> Tuple[int, int]:
    """The (data, model) shape ``--mesh test`` takes on ``nproc`` ranks:
    the reference's 2 x 2 at 4, (2, N/2) for an even N >= 4, else
    (1, N)."""
    if nproc >= 4 and nproc % 2 == 0:
        return 2, nproc // 2
    return 1, nproc


def _train_rank(cfg, kw: dict, backend: str, mesh_shape) -> List[float]:
    """One rank of ``--mesh test``: :func:`train` on the mesh."""
    from repro_torch.launch.mesh import make_test_mesh
    device = rank_device(backend)
    mesh = make_test_mesh(*mesh_shape, device_type=device.type)
    _, losses = train(cfg, device=device, mesh=mesh, **kw)
    return losses


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
    ap.add_argument("--mesh", default="none", choices=("none", "test"),
                    help="none (one device) | test (a small mesh, one "
                    "rank per device)")
    ap.add_argument("--nproc", type=int, default=4,
                    help="ranks of --mesh test (default 4)")
    ap.add_argument("--init-method", default=None,
                    help="rendezvous (default: tcp://127.0.0.1:<free "
                    "port>)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attention_impl="blocked")
    print(f"[train] {cfg.name}: attention_impl={cfg.attention_impl!r} "
          f"(plain routes; the kernels have no backward), remat="
          f"{cfg.remat!r}, device {args.device}")
    kw = dict(steps=args.steps, global_batch=args.batch, seq_len=args.seq,
              ckpt_dir=args.ckpt_dir)
    if args.mesh == "none":
        train(cfg, device=args.device, **kw)
        return
    backend = "nccl" if resolve_device(args.device).type == "cuda" else "gloo"
    shape = test_mesh_shape(args.nproc)
    print(f"[train] mesh {shape} ('data', 'model') over {args.nproc} "
          f"{backend} ranks, profile 'tp'")
    spawn(_train_rank, args.nproc, backend=backend,
          init_method=args.init_method, args=(cfg, kw, backend, shape))


if __name__ == "__main__":
    main()
