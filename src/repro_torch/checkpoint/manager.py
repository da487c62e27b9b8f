"""Checkpointing: atomic, async-capable, keyed by each leaf's tree path.

The counterpart of ``repro/checkpoint/manager.py``, over the port's trees
(dicts, frozen dataclasses, NamedTuples and tuples of tensors, numpy
arrays and Python or numpy scalars).  The files are the port's own format:
one ``.npy`` a leaf and a ``manifest.json`` mapping each leaf's path
(``['cursor']['batch']``, ``['queue'].buf``) to its file, shape and dtype.

  * **atomic commit**: a save writes ``<prefix>_N.tmp/`` and renames it to
    ``<prefix>_N/`` when every file is written, so a crash mid-save never
    corrupts the newest checkpoint;
  * **async save**: the leaves are copied to the host first, and a
    background thread serializes them (``blocking=False``);
  * **restore** loads into the structure of a template, each tensor leaf on
    the template leaf's device and in its dtype;
  * **retention**: the newest ``keep`` checkpoints of the prefix survive,
    older ones are deleted after a successful commit, never before.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def flatten_with_paths(tree, path: str = "") -> dict:
    """``{path: leaf}`` over a tree's leaves, in a stable order: dict keys
    sorted, dataclass fields and tuple items in their order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten_with_paths(tree[k], f"{path}[{k!r}]"))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(flatten_with_paths(getattr(tree, f.name),
                                          f"{path}.{f.name}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, x in enumerate(tree):
            out.update(flatten_with_paths(x, f"{path}[{i}]"))
        return out
    return {path: tree}


def unflatten_like(like, leaves: dict, path: str = ""):
    """The tree of ``like`` with each leaf replaced by ``leaves[path]``."""
    if isinstance(like, dict):
        return {k: unflatten_like(like[k], leaves, f"{path}[{k!r}]")
                for k in like}
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: unflatten_like(getattr(like, f.name), leaves,
                                   f"{path}.{f.name}")
            for f in dataclasses.fields(like)})
    if isinstance(like, tuple):
        items = [unflatten_like(x, leaves, f"{path}[{i}]")
                 for i, x in enumerate(like)]
        return type(like)(*items) if hasattr(like, "_fields") \
            else tuple(items)
    return leaves[path]


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:  # npy has no bf16: widen losslessly
            return x.detach().float().cpu().numpy()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


class CheckpointManager:
    """Checkpoints under ``directory`` as ``<prefix>_<step>/``.

    Retention (``keep``) applies per prefix, so a drain-snapshot manager
    (``prefix="snap"``) and another prefix can share one directory.
    """

    def __init__(self, directory: str, keep: int = 3, prefix: str = "step"):
        if not re.fullmatch(r"[A-Za-z][A-Za-z0-9._-]*", prefix):
            raise ValueError(f"bad checkpoint prefix {prefix!r}")
        self.dir = directory
        self.keep = keep
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = True):
        """Copy the leaves to the host, then serialize them (in a
        background thread unless ``blocking``)."""
        flat = flatten_with_paths(tree)
        host = {p: (_to_host(x), _dtype_name(x)) for p, x in flat.items()}
        self.wait()  # one in-flight async save at a time
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(target=self._write,
                                            args=(step, host), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict):
        tmp = os.path.join(self.dir, f"{self.prefix}_{step}.tmp")
        final = os.path.join(self.dir, f"{self.prefix}_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for i, path in enumerate(sorted(host)):
            arr, dtype = host[path]
            fname = f"arr_{i}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[path] = {"file": fname, "shape": list(arr.shape),
                              "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "arrays": manifest}, f)
        os.replace(tmp, final)  # atomic commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"{self.prefix}_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(rf"{re.escape(self.prefix)}_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        d = os.path.join(self.dir, f"{self.prefix}_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)["arrays"]

    def load_leaf(self, step: int, meta: dict) -> np.ndarray:
        return np.load(os.path.join(self.dir, f"{self.prefix}_{step}",
                                    meta["file"]))

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``: a tensor leaf comes back
        on the template leaf's device and in its dtype, any other leaf as
        a numpy array of the template's dtype."""
        manifest = self.manifest(step)
        leaves = {}
        for path, ref in flatten_with_paths(like).items():
            arr = self.load_leaf(step, manifest[path])
            if isinstance(ref, torch.Tensor):
                leaves[path] = torch.from_numpy(np.array(arr)).to(
                    device=ref.device, dtype=ref.dtype)
            else:
                leaves[path] = np.asarray(arr, dtype=np.asarray(ref).dtype)
        return unflatten_like(like, leaves)
