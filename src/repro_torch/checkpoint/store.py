"""Checkpointing with async save and restart.

The port of the reference's ``checkpoint/store.py``, with its on-disk
format, so a directory either package writes loads in the other bit for
bit:

    ckpt_dir/step_00000100/
        manifest.json        {step, leaves: {path: {file, shape, dtype}}}
        <escaped-path>.npy   one file per leaf

  * writes go to ``.tmp_step_*`` and are renamed into place, so a
    failure mid-save never shows a partial checkpoint (restore looks for
    the newest *complete* manifest);
  * async save: the copy to host memory is made at once (training goes
    on changing the parameters in place), the disk write on a worker
    thread;
  * numpy has no bfloat16 or float8, so those leaves are stored as
    uint16 / uint8 views, as the reference stores them (it names them by
    ``ml_dtypes``; the port reinterprets the bits with ``Tensor.view``).

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars, or :class:`torch.nn.Module`s, whose leaves are their
named parameters (a train state's ``params``); a leaf's path joins its
keys with ``/``.

Over a mesh (one process per device), a checkpoint still holds full
leaves in this layout, so it stays interchangeable with the reference's
and with one-device runs: :meth:`CheckpointStore.save` gathers every
DTensor leaf (a ZeRO-1 moment, a tensor-parallel parameter) whole, a
collective that every rank joins, and only rank 0 keeps the host copy
and writes it. :meth:`CheckpointStore.restore` loads full leaves and
places them on any mesh and world size with ``placements=`` (the
reference's ``shardings=``, its elastic re-mesh), or on one ``device``.
"""
from __future__ import annotations

import copy
import json
import pathlib
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed
from torch import nn

#: dtypes numpy cannot hold, by the manifest's (numpy's) dtype name: the
#: torch dtype, the integer dtype of its width in torch and in numpy,
#: and the unsigned dtype the ``.npy`` stores
_EXOTIC = {"bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8,
                             np.uint8),
           "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8,
                           np.uint8)}


def _esc(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "~", path)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in the tree's order."""
    if isinstance(tree, nn.Module):
        return {prefix + k: v for k, v in tree.named_parameters()}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _is_dtensor(t) -> bool:
    return hasattr(t, "full_tensor")


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else 0


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory (an exotic dtype as its unsigned
    view) and the manifest's name of its dtype."""
    if not torch.is_tensor(leaf):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach()
    if _is_dtensor(t):
        t = t.full_tensor()
    name = str(t.dtype).removeprefix("torch.")
    if name in _EXOTIC:
        _, t_int, _, store = _EXOTIC[name]
        return t.view(t_int).to("cpu", copy=True).numpy().view(store), name
    return t.to("cpu", copy=True).numpy(), name


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype in _EXOTIC:
        t_dtype, _, np_int, _ = _EXOTIC[dtype]
        return torch.from_numpy(arr.view(np_int)).view(t_dtype).to(device)
    return torch.from_numpy(arr).to(device)


def _flatten_placements(tree, prefix: str = "") -> Dict[str, tuple]:
    """{path: placements} of a tree of dicts whose leaves are placement
    tuples (the paths :func:`_flatten` gives the matching state)."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tuple(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flatten_placements(v, f"{prefix}{k}/"))
    return out


class CheckpointStore:
    def __init__(self, directory):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, wait: bool = False) -> None:
        """Snapshot ``tree`` to host memory now; write it to disk on a
        worker thread (joined by the next save, :meth:`wait` or
        ``wait=True``). A tree with DTensor leaves is gathered whole by
        every rank (each must call this) and written by rank 0 alone;
        with ``wait=True`` every rank returns once the checkpoint is on
        disk."""
        flat = _flatten(tree)
        sharded = any(_is_dtensor(v) for v in flat.values())
        writer = not sharded or _rank() == 0
        host = {}
        for k, v in flat.items():
            arr = _to_host(v)             # every rank joins each gather
            if writer:
                host[k] = arr
        if writer:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        if wait:
            self.wait()
            if sharded:
                torch.distributed.barrier()

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]]):
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}}
        for path, (arr, dtype) in host.items():
            fname = _esc(path) + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][path] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for d in self.dir.glob("step_*"):
            if (d / "manifest.json").exists():
                steps.append(int(d.name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, like, step: Optional[int] = None, *, device=None,
                mesh=None, placements=None):
        """Load into the structure of ``like`` -> (tree, step). Leaves are
        tensors on ``device`` (default: the device of ``like``'s leaf;
        the CPU for a non-tensor leaf), in the dtype the checkpoint
        holds; a module in ``like`` comes back as a copy holding the
        loaded parameters (``like`` is left as it was).

        With ``mesh`` and ``placements`` (a tree of dicts shaped as
        ``like``, a module's entry {parameter name: placements}, as
        ``repro_torch.train.step.state_placements`` gives them), a
        leaf that has placements is loaded whole on this rank's
        ``device`` and kept as a DTensor of its placements (each rank
        its own chunk): any mesh and world size can load any
        checkpoint."""
        from repro_torch.sharding.rules import place
        pl = _flatten_placements(placements) if placements else {}
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())

        def load(path, leaf):
            meta = manifest["leaves"].get(path)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {path}")
            dev = device if device is not None else (
                leaf.device if torch.is_tensor(leaf) else "cpu")
            t = _from_host(np.load(d / meta["file"]), meta["dtype"], dev)
            if path in pl:
                t = place(t, mesh, pl[path])
            return t

        def build(tree, prefix):
            if isinstance(tree, nn.Module):
                memo = {}
                for k, p in tree.named_parameters():
                    memo[id(p)] = nn.Parameter(load(prefix + k, p),
                                               requires_grad=p.requires_grad)
                return copy.deepcopy(tree, memo)
            if isinstance(tree, dict):
                return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(build(v, f"{prefix}{i}/")
                                  for i, v in enumerate(tree))
            return load(prefix[:-1], tree)

        return build(like, ""), step
