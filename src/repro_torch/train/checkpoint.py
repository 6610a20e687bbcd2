"""Fault-tolerant checkpointing.

* atomic: write to a temp dir, fsync, rename — a crash mid-save never
  corrupts the latest checkpoint;
* ``latest`` pointer file for O(1) resume discovery;
* async mode: the device->host copy happens synchronously (cheap), the disk
  write runs on a background thread so training never stalls on I/O;
* retention: keep the last ``keep`` checkpoints;
* nested dicts / lists / tuples of arrays are stored as one .npz
  (path-flattened: ``"a/b/0"`` keys, as the reference writes them) + a
  metadata json, so the two packages read each other's checkpoints.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict / list / tuple tree, in the
    order the reference's ``jax.tree_util`` flattens it: dict keys sorted,
    sequences by index, ``None`` an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> Dict[str, np.ndarray]:
    """Leaves as ``{"a/b/0": array}`` — the reference's on-disk keys."""
    return {_key(path): np.asarray(leaf) for path, leaf in _leaves(tree)}


def _unflatten_into(tree, flat: Dict[str, np.ndarray]):
    """A tree shaped like ``tree`` with its leaves read from ``flat``
    (shapes checked against the template's leaves that have one)."""

    def build(node, prefix):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k], prefix + (k,)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (i,))
                              for i, v in enumerate(node))
        key = _key(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        want = getattr(node, "shape", None)
        if want is not None and tuple(arr.shape) != tuple(want):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {want}")
        return arr

    return build(tree, ())


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None,
             block: bool = False) -> None:
        self.wait()  # never two writers (same-step saves must serialize)
        flat = _flatten(tree)  # device->host copy happens here, synchronously
        meta = {"step": int(step), "time": time.time(), **(extra or {})}
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, meta)

    def _write(self, step: int, flat, meta) -> None:
        tmp = self.dir / f".tmp-{step}"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "state.npz", **flat)
        (tmp / "meta.json").write_text(json.dumps(meta))
        with open(tmp / "state.npz", "rb") as f:
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        (self.dir / "latest.tmp").write_text(final.name)
        (self.dir / "latest.tmp").rename(self.dir / "latest")
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*"))
        for old in ckpts[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "latest"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.dir / name).exists():
            # fall back to newest on-disk checkpoint
            ckpts = sorted(self.dir.glob("step_*"))
            if not ckpts:
                return None
            name = ckpts[-1].name
        return int(name.split("_")[1])

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[Any, Dict[str, Any]]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:010d}"
        with np.load(path / "state.npz") as z:
            flat = {k: z[k] for k in z.files}
        meta = json.loads((path / "meta.json").read_text())
        return _unflatten_into(template, flat), meta
