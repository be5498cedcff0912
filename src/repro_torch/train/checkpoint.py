"""Atomic, async checkpointing with auto-resume.

The reference's ``repro/train/checkpoint.py`` and its layout:
``<dir>/step_<N>/`` (``step_%08d``) holds one ``.npy`` per leaf
(``leaf_%05d.npy``, leaves numbered in ``jax.tree_util``'s order,
:func:`models.param.tree_flatten`) and ``manifest.json`` with the step,
the leaf count, the tree's structure, the shapes and dtypes and a config
hash.  Writes go to a ``.tmp`` directory renamed on completion, so a
crash mid-write never corrupts the latest checkpoint; ``latest_step``
trusts only directories whose manifest exists.  The writer runs in a
daemon thread on host copies taken before it starts; ``wait()`` joins it
before the next save.

bf16 leaves: numpy has no bf16, and the reference writes them through
``ml_dtypes`` as 2-byte void records (descr ``<V2``) with ``bfloat16``
in the manifest's dtypes.  The port reads and writes them as those
bytes (a uint16 view), so a checkpoint the reference wrote restores
here.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..models.param import tree_flatten, tree_unflatten

_LEAF_FMT = "leaf_{:05d}.npy"
BF16 = "bfloat16"


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def _to_host(t: torch.Tensor):
    """``(numpy array, dtype name)`` of a tensor; bf16 as 2-byte voids."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2"), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.require(arr, requirements="C")
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str, cfg_hash: str = "", keep: int = 3):
        self.dir = directory
        self.cfg_hash = cfg_hash
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        # Copy to the host *before* handing to the writer thread: the
        # next step makes new tensors, but a caller may update in place.
        leaves, treedef = tree_flatten(tree)
        host = [_to_host(l) for l in leaves]
        t = threading.Thread(target=self._write, daemon=True,
                             args=(step, host, repr(treedef)))
        t.start()
        self._thread = t
        if blocking:
            self.wait()

    def _write(self, step: int, host, treedef_str: str) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for i, (arr, _) in enumerate(host):
            np.save(os.path.join(tmp, _LEAF_FMT.format(i)), arr)
        manifest = {
            "step": step,
            "num_leaves": len(host),
            "treedef": treedef_str,
            "cfg_hash": self.cfg_hash,
            "shapes": [list(arr.shape) for arr, _ in host],
            "dtypes": [dt for _, dt in host],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)           # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------ restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d{8})", name)
            if m and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device=None) -> Any:
        """Load checkpoint ``step`` into the structure of ``like`` (a tree
        of tensors, meta tensors included).  Each leaf keeps the dtype it
        was written with and lands on ``device``; by default on its
        ``like`` leaf's device, or the CPU for a meta leaf."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if self.cfg_hash and manifest["cfg_hash"] and \
                manifest["cfg_hash"] != self.cfg_hash:
            raise ValueError(
                f"checkpoint config hash {manifest['cfg_hash']} != {self.cfg_hash}")
        leaves_like, treedef = tree_flatten(like)
        if manifest["num_leaves"] != len(leaves_like):
            raise ValueError(f"structure mismatch: the checkpoint has "
                             f"{manifest['num_leaves']} leaves, the tree "
                             f"{len(leaves_like)}")
        out = []
        for i, (l, dtype) in enumerate(zip(leaves_like, manifest["dtypes"])):
            arr = np.load(os.path.join(path, _LEAF_FMT.format(i)))
            dev = device if device is not None else (
                "cpu" if l.device.type == "meta" else l.device)
            out.append(_from_host(arr, dtype, dev))
        return tree_unflatten(treedef, out)
