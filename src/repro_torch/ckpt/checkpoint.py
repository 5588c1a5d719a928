"""Checkpointing: atomic, manifest-driven, the port of
``repro.ckpt.checkpoint``, in the reference's format.

Layout:  <dir>/step_<N>/            (N zero-padded to 8 digits)
             manifest.json   — step, leaf names, shapes, dtypes, extra meta
             <leaf>.npy      — one array per leaf (full, on the host)

Writes go to step_<N>.tmp/ and are renamed into place, so a crash mid-save
never corrupts the latest checkpoint: a restart resumes from the previous
step.  The async mode hands the host copy of the state to a writer thread
so the train loop does not block on the disk.

Leaf names are the reference's: a ``TrainState`` flattens as (params, opt,
step) into ``0.<params path>``, ``1.m.<path>``, ``1.step``, ``1.v.<path>``
and ``2``, dict keys sorted as ``jax.tree_util`` sorts them, the path
'.'-joined with anything but [A-Za-z0-9_.-] replaced by '_'.  A bfloat16
leaf is written as the reference writes an ml_dtypes bfloat16 array: its
raw 2-byte values under npy descr ``'<V2'``, manifest dtype
``"bfloat16"``.  So either package reads the other's float leaves bit for
bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "CheckpointManager",
           "named_leaves"]

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _children(node):
    """(key, child) pairs of a tree node in the reference's flatten order,
    or None for a leaf."""
    from ..train.step import TrainState

    if isinstance(node, TrainState):
        return list(enumerate((node.params, node.opt, node.step)))
    if isinstance(node, dict):
        return [(key, node[key]) for key in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def named_leaves(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """(checkpoint name, leaf) of every leaf, in the reference's order."""
    kids = _children(tree)
    if kids is None:
        return [(_SAFE.sub("_", ".".join(str(k) for k in prefix)), tree)]
    return [item for key, child in kids
            for item in named_leaves(child, prefix + (key,))]


def _rebuild(like, leaves):
    """`like`'s structure with its leaves, in order, taken from `leaves`."""
    from ..train.step import TrainState

    if isinstance(like, TrainState):
        return TrainState(*(_rebuild(c, leaves)
                            for c in (like.params, like.opt, like.step)))
    if isinstance(like, dict):
        return {key: _rebuild(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(c, leaves) for c in like)
    return next(leaves)


def _save_leaf(path: Path, t: torch.Tensor) -> dict:
    """Write one leaf as the reference writes it; returns its manifest
    entry's shape and dtype."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # ml_dtypes' bfloat16 saves as descr '<V2': the same header, then
        # the raw 2-byte values
        bits = t.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": bits.shape})
            f.write(bits.tobytes())
        return {"shape": list(bits.shape), "dtype": "bfloat16"}
    arr = t.numpy()
    np.save(path, arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def save(state, directory: str | Path, step: int, extra: dict | None = None
         ) -> Path:
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, leaf in named_leaves(state):
        manifest["leaves"].append(
            {"name": name, **_save_leaf(tmp / f"{name}.npy", leaf)})
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            steps.append(int(m.group(1)))
    return max(steps, default=None)


def restore(state_like, directory: str | Path, step: int | None = None,
            device: "torch.device | str | None" = None):
    """Restore into the structure of `state_like` (tensors, or ``meta``
    tensors for the shapes only) -> (state, manifest).  Each leaf takes
    `state_like`'s type for it and lands on `device` (by default the
    leaf's own device, the CPU for a ``meta`` leaf)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    meta = {m["name"]: m for m in manifest["leaves"]}
    out = []
    for name, like in named_leaves(state_like):
        if name not in meta:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = np.load(d / f"{name}.npy")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {name}: checkpoint shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        dev = device if device is not None else (
            "cpu" if like.device.type == "meta" else like.device)
        out.append(_from_numpy(arr, meta[name]["dtype"])
                   .to(device=dev, dtype=like.dtype))
    return _rebuild(state_like, iter(out)), manifest


def _host_copy(state):
    """The state with every leaf copied to host memory (the next train
    step writes into the device tensors while a writer thread saves)."""
    leaves = iter([leaf.detach().to("cpu", copy=True)
                   for _, leaf in named_leaves(state)])
    return _rebuild(state, leaves)


class CheckpointManager:
    """save-every-N with bounded retention and optional async writes."""

    def __init__(self, directory: str | Path, every: int = 50, keep: int = 3,
                 async_write: bool = False):
        self.directory = Path(directory)
        self.every = every
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None

    def maybe_save(self, state, step: int, extra: dict | None = None) -> bool:
        if step % self.every != 0:
            return False
        self.wait()
        if self.async_write:
            # the port's tensors are updated in place by the next step:
            # copy the state to the host here, then hand the copy off
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(_host_copy(state), step,
                                                extra), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(state, step, extra)
        return True

    def _save_and_gc(self, state, step, extra):
        save(state, self.directory, step, extra)
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.directory.iterdir()
            if re.fullmatch(r"step_\d+", p.name))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
