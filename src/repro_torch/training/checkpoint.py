"""Atomic checkpoints of tensor trees.

* **Atomic**: written to ``<dir>/tmp.<step>`` and renamed to
  ``<dir>/step_<n>`` — a preemption mid-write never corrupts the latest
  checkpoint (rename is atomic on POSIX).
* **Format**: one ``.npy`` per leaf plus a JSON manifest of leaf names,
  dtypes and shapes.  numpy has no bfloat16, so a bf16 leaf is stored as
  its raw 16-bit words (``uint16``) and tagged ``bfloat16`` in the
  manifest; restore is bit-exact for every dtype.  The port's checkpoints
  are its own: the reference cannot read its bf16 leaves.
* **Async**: ``AsyncSaver.save_async`` copies the tree to the host, then
  hands the write to a thread, so the step loop is not blocked on disk.
* Data-pipeline state and the step counter travel inside the checkpoint,
  so resume replays nothing and skips nothing.

The reference's ``shardings`` (elastic re-sharding on restore) has no
meaning on one device and is not ported (ROADMAP Queue 1 item 11); a
restored leaf goes to the device of the matching leaf of the target tree.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import tree_leaves, tree_map

_SEP = "__"


def _names(tree: Any, prefix: Tuple[str, ...] = ()) -> List[str]:
    """Leaf names in the order of ``tree_leaves``: dict keys joined by
    ``__``."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _names(tree[k], prefix + (str(k),))]
    return [_SEP.join(re.sub(r"[^A-Za-z0-9_.-]", "_", p) for p in prefix)]


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A copy of a leaf as a numpy array, and its dtype name (bf16 as raw
    words)."""
    t = leaf.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _write(ckpt_dir: str, step: int, names: List[str],
           host: List[Tuple[np.ndarray, str]],
           extra: Optional[Dict[str, Any]]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, (arr, dtype) in zip(names, host):
        fn = f"{name}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"name": name, "file": fn, "dtype": dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Blocking atomic save of a tree of dicts of tensors.  Returns the
    final checkpoint path."""
    return _write(ckpt_dir, step, _names(tree),
                  [_to_host(l) for l in tree_leaves(tree)], extra)


class AsyncSaver:
    """One-slot background saver (latest request wins)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save_async(self, ckpt_dir: str, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy ``tree`` to the host now (the caller may then update it in
        place) and write it on a thread."""
        names = _names(tree)
        host = [_to_host(l) for l in tree_leaves(tree)]
        self.wait()
        self._thread = threading.Thread(
            target=lambda: setattr(self, "last_path", _write(
                ckpt_dir, step, names, host, extra)),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, target_tree: Any, step: Optional[int] = None
            ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore into the structure of ``target_tree`` (latest step unless
    given); each leaf lands on its target leaf's device and must match its
    dtype and shape.  Returns ``(tree, step, extra)``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {l["name"]: l for l in manifest["leaves"]}
    names = iter(_names(target_tree))

    def load(ref: torch.Tensor) -> torch.Tensor:
        name = next(names)
        rec = by_name[name]
        t = _from_host(np.load(os.path.join(path, rec["file"])),
                       rec["dtype"])
        if t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(f"checkpoint leaf {name}: {t.dtype}"
                             f"{tuple(t.shape)}, target {ref.dtype}"
                             f"{tuple(ref.shape)}")
        return t.to(ref.device)

    return tree_map(load, target_tree), step, manifest.get("extra", {})


def cleanup(ckpt_dir: str, keep_last: int = 3) -> None:
    """Remove all but the ``keep_last`` newest checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
