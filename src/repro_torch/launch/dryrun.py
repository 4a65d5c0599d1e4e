"""Multi-node dry run: trace every (arch x shape x mesh) cell.

The port of the reference's ``launch/dryrun.py``. For each cell this
joins a ``"fake"`` process group of 256 (16 x 16) or 512 (2 x 16 x 16)
ranks in its own process, as rank 0, places the state and the inputs as
DTensors of ``meta`` tensors on the reference's production mesh (shapes
only: nothing is allocated, nothing is sent), and runs the real step
eagerly: the "tp" train step (forward, backward and the ZeRO-1 AdamW
update) for train shapes, the prefill forward, or ``decode_step``. The
attention takes the blocked route that training takes (the kernels run
on CUDA or CPU tensors only). It records, per device
(:mod:`repro_torch.launch.step_analysis`):

  memory      argument bytes (rank 0's local shards of the state and the
              inputs), output and alias bytes (an output whose storage is
              an input's, as the train state updated in place, or a
              decode cache with ``donate_cache``: the counterpart of
              donation), the peak of live storages the step created, and
              the peak estimate: arguments plus that peak;
  ops         dot FLOPs and dot bytes at the local shapes, collective
              bytes per kind (the reference's ring conventions);
  roofline    compute, memory and collective seconds on the H100
              constants below, and MODEL_FLOPS = 6ND (2ND for inference).

The constants: 989e12 bf16 FLOP/s and 3.35e12 B/s of HBM (the H100 SXM
data sheet at 700 W, ``launch/roofline.py``), and 50e9 B/s a device for
collectives: the InfiniBand NDR rate of a DGX H100's one 400 Gb/s
ConnectX-7 port per GPU (NVIDIA DGX H100 data sheet). NVLink (900 GB/s
a GPU both ways, 450 GB/s each way) joins only the 8 GPUs of one node: a
16-wide model axis spans two 8-GPU NVLink domains, and the data and pod
axes span nodes, so every ring of the production meshes crosses the
slower network, as every TPU ring crossed ICI in the reference.

Usage (no card needed; ``meta`` tensors on the CPU):
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
Results land in ``results/dryrun_torch/<cell>.json`` (one process per
cell: a process joins one group; ``launch/run_dryrun_all.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import specs as SP
from repro_torch.launch.roofline import BF16_OPS_PER_S, HBM_BYTES_PER_S
from repro_torch.launch.step_analysis import (StepCounter, storage_bytes,
                                              storages)
from repro_torch.models import transformer as T

PEAK_FLOPS = BF16_OPS_PER_S      # dense bf16 tensor-core FLOP/s a GPU
HBM_BW = HBM_BYTES_PER_S         # bytes/s a GPU
LINK_BW = 50e9                   # bytes/s a GPU to another node (NDR IB)

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results"
               / "dryrun_torch")


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode: D = batch tokens."""
    n = cfg.active_param_count()
    _, dec_len = SP.split_lens(cfg, shape.seq_len)
    if shape.kind == "train":
        tokens = shape.global_batch * dec_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * dec_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # one token per sequence


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def join_fake_group(world_size: int) -> None:
    """Join a ``"fake"`` process group of ``world_size`` ranks as rank 0:
    collectives return at once and move nothing (one group a process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"this process is in a group of "
                               f"{dist.get_world_size()} ranks")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def leaves(tree):
    """The tensors of a tree of dicts, lists and modules (a module's
    parameters)."""
    from torch.utils._pytree import tree_flatten
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.nn.Module):
            out += list(t.parameters())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def trace(fn, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` under a :class:`StepCounter`; returns its
    summary, the memory terms and ``trace_s``. ``args`` are the step's
    arguments (modules, dicts and lists of tensors)."""
    ins = storages(leaves(args))
    t0 = time.time()
    with StepCounter(leaves(args)) as counter:
        out = fn(*args)
    dt = time.time() - t0
    outs = storages(leaves(out))
    alias = sum(n for k, n in outs.items() if k in ins)
    return {"ops": counter.summary(), "trace_s": dt,
            "argument_bytes": sum(ins.values()),
            "output_bytes": sum(n for k, n in outs.items() if k not in ins),
            "alias_bytes": alias, "temp_bytes": counter.peak}


def train_cell(cfg, batch: Dict[str, torch.Tensor], *, mesh=None,
               rules=None, accum: int = 1):
    """(step, state, this rank's batch) of a train cell on ``meta``: the
    train state placed by the rules (plain on one device)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (local_batch, make_train_step,
                                        place_train_state)
    state = SP.abstract_train_state(cfg)
    if mesh is not None:
        state = place_train_state(state, cfg, mesh, rules)
        batch = local_batch(batch, mesh, rules, accum)
    step = make_train_step(cfg, AdamWConfig(), accum, mesh=mesh,
                           rules=rules)
    return step, state, batch


def _tp(mesh, rules):
    """The rules context and DTensor's implicit replication of the plain
    tensors made inside the model (positions, masks)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding.rules import rules_context
    ctx = contextlib.ExitStack()
    if mesh is not None:
        ctx.enter_context(rules_context(mesh, rules))
        ctx.enter_context(implicit_replication())
    return ctx


def cell_config(arch: str, mesh, kv_dtype: Optional[str] = None):
    """The config a cell traces: the arch's, ``kv_repeat`` tuned to the
    mesh, the blocked attention route, and ``kv_dtype`` when given."""
    cfg = SP.tune_for_mesh(get_config(arch), mesh)
    return dataclasses.replace(cfg, attention_impl="blocked",
                               **({"kv_cache_dtype": kv_dtype}
                                  if kv_dtype else {}))


def place_cell(cfg, shape, mesh, rules, accum: int = 1,
               donate_cache: bool = False) -> Dict[str, Any]:
    """A cell's step on ``meta`` and its placed arguments: {"step",
    "args", "params", "opt" (train), "batch", "cache" (decode)}. Train:
    the train state placed by the rules (ZeRO-1 m and v) and this rank's
    slice of the batch; prefill: the parameters and the batch as
    DTensors; decode: the parameters, one token a sequence and the cache
    as DTensors (:func:`repro_torch.launch.specs`), the cache updated in
    place with ``donate_cache``."""
    from repro_torch.sharding.rules import (param_placements, place,
                                            place_params)
    if shape.kind == "train":
        step, state, batch = train_cell(cfg, SP.input_specs(cfg, shape),
                                        mesh=mesh, rules=rules, accum=accum)
        return {"step": step, "args": (state, batch),
                "params": state["params"], "opt": state["opt"],
                "batch": batch, "cache": None}
    params = SP.abstract_params(cfg)
    params = place_params(params, mesh, param_placements(params, mesh, rules))
    bp = SP.batch_placements({"tokens": None}, mesh, rules)["tokens"]
    if shape.kind == "prefill":
        batch = {k: place(v, mesh, bp)
                 for k, v in SP.input_specs(cfg, shape).items()}

        def prefill(params, b):
            with _tp(mesh, rules), torch.no_grad():
                logits, _ = T.forward(params, cfg, b["tokens"],
                                      enc_frames=b.get("enc_frames"))
            return logits
        return {"step": prefill, "args": (params, batch), "params": params,
                "opt": None, "batch": batch, "cache": None}
    enc_len, dec_len = SP.split_lens(cfg, shape.seq_len)
    with _tp(mesh, rules), torch.no_grad():
        frames = (place(SP._frames(cfg, shape.global_batch, enc_len), mesh,
                        bp) if cfg.is_enc_dec else None)
        cache = T.init_cache(cfg, shape.global_batch, dec_len,
                             start_len=dec_len - 1, device=SP.META,
                             params=params, enc_frames=frames)
    tokens = place(torch.empty((shape.global_batch, 1), dtype=torch.int32,
                               device=SP.META), mesh, bp)

    def serve_step(params, tokens, cache):
        with _tp(mesh, rules), torch.no_grad():
            logits, new = T.decode_step(params, cfg, tokens, cache)
            if donate_cache:           # the cache updated in place
                for old_c, new_c in zip(cache, new):
                    for k, t in new_c.items():
                        if old_c[k] is not t:
                            old_c[k].copy_(t)
                new = cache
        return logits, new
    return {"step": serve_step, "args": (params, tokens, cache),
            "params": params, "opt": None, "batch": {"tokens": tokens},
            "cache": cache}


def production_mesh(multi_pod: bool):
    """Join a fake group of the production mesh's size (this process's
    one group) and return the mesh."""
    from repro_torch.launch.mesh import (PRODUCTION_MESHES,
                                         make_production_mesh)
    world = 1
    for s in PRODUCTION_MESHES[multi_pod][0]:
        world *= s
    join_fake_group(world)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def build_cell(arch: str, shape_name: str, multi_pod: bool, *,
               profile: str = "tp", accum: int = 1,
               donate_cache: bool = False, kv_dtype: Optional[str] = None
               ) -> Dict[str, Any]:
    """Trace one cell on the production mesh (this process joins a fake
    group of its size) and return its record (the reference's schema,
    ``compile_s`` as ``trace_s``, ``hlo`` as ``ops``)."""
    from repro_torch.sharding.rules import make_rules
    shape = SHAPES[shape_name]
    name = mesh_name(multi_pod)
    skip = applicable(get_config(arch), shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "status": "skipped", "reason": skip}
    mesh = production_mesh(multi_pod)
    cfg = cell_config(arch, mesh, kv_dtype)
    rules = make_rules(cfg, mesh, batch_size=shape.global_batch,
                       profile=profile)
    t0 = time.time()
    cell = place_cell(cfg, shape, mesh, rules, accum, donate_cache)
    t_lower = time.time() - t0
    res = trace(cell["step"], *cell["args"])

    chips = mesh.mesh.numel()
    ops = res["ops"]
    mf = model_flops(cfg, shape)
    flops_dev = ops["dot_flops"]
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = ops["dot_bytes"] / HBM_BW
    coll_s = ops["collective_total"] / LINK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    arg, temp = res["argument_bytes"], res["temp_bytes"]
    return {
        "arch": arch, "shape": shape_name, "mesh": name, "status": "ok",
        "chips": chips, "kv_repeat": cfg.kv_repeat,
        "variant": {"profile": profile, "accum": accum,
                    "donate_cache": donate_cache, "kv_dtype": kv_dtype},
        "lower_s": round(t_lower, 1), "trace_s": round(res["trace_s"], 1),
        "memory": {
            "argument_bytes_per_device": arg,
            "output_bytes_per_device": res["output_bytes"],
            "temp_bytes_per_device": temp,
            "alias_bytes_per_device": res["alias_bytes"],
            "peak_estimate_gb": round((arg + temp) / 2**30, 3),
        },
        "xla_cost": None,
        "ops": {
            "dot_flops_per_device": flops_dev,
            "dot_bytes_per_device": ops["dot_bytes"],
            "collective_bytes_per_device": ops["collective_bytes"],
            "collective_total_per_device": ops["collective_total"],
            "collective_calls_per_device": ops["collective_calls"],
            "n_ops": ops["n_ops"],
        },
        "roofline": {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant,
            "model_flops_global": mf,
            "useful_flops_ratio": (mf / (flops_dev * chips)
                                   if flops_dev else None),
        },
    }


def analyze_train_step(cfg, global_batch: int, seq_len: int,
                       accum: int = 1) -> Dict[str, Any]:
    """The dry run of a one-device train step (no mesh) of ``cfg`` at
    (``global_batch``, ``seq_len``): :func:`trace`'s record, with the
    state's bytes apart (``state_bytes``: parameters, m, v and the
    step)."""
    cfg = dataclasses.replace(cfg, attention_impl="blocked")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq_len,
                                global_batch=global_batch)
    step, state, batch = train_cell(cfg, SP.input_specs(cfg, shape),
                                    accum=accum)
    res = trace(step, state, batch)
    res["state_bytes"] = storage_bytes(leaves(state))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", default="tp")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--donate-cache", action="store_true")
    ap.add_argument("--kv-dtype", default=None)
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__{'mp' if args.multi_pod else 'sp'}"
            out = (pathlib.Path(args.out) if args.out
                   else RESULTS_DIR / f"{tag}.json")
            try:
                res = build_cell(arch, shape, args.multi_pod,
                                 profile=args.profile, accum=args.accum,
                                 donate_cache=args.donate_cache,
                                 kv_dtype=args.kv_dtype)
            except Exception as e:          # noqa: BLE001
                res = {"arch": arch, "shape": shape,
                       "mesh": mesh_name(args.multi_pod),
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
            out.write_text(json.dumps(res, indent=1, default=str))
            status = res["status"]
            extra = ""
            if status == "ok":
                r = res["roofline"]
                extra = (f" dominant={r['dominant']} "
                         f"compute={r['compute_s']:.3f}s "
                         f"mem={r['memory_s']:.3f}s "
                         f"coll={r['collective_s']:.3f}s "
                         f"peak/dev={res['memory']['peak_estimate_gb']}GB "
                         f"trace={res['trace_s']}s")
            elif status == "error":
                extra = " " + res["error"][:200]
            print(f"[dryrun] {tag}: {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
