"""Async, atomic checkpointing in ``repro.checkpoint``'s layout, so either
package restores the other's checkpoints.

Layout per step:  <dir>/step_<N>/
    manifest.json   — step, leaf count, tree description, leaf shapes / dtypes
    leaf_<i>.npy    — one array per leaf, gathered to the host

A tree is nested dicts, tuples and lists of tensors or numpy arrays; its
leaves are ordered as ``jax.tree.flatten`` orders them (a dict by sorted
key, a sequence in order, ``None`` no leaf).  The trainer saves ``repro``'s
layout (``models.convert.to_repro_layout``: per-layer leaves stacked).

Guarantees
----------
* **atomic**: written to ``step_<N>.tmp``, then ``os.rename``'d: a crash
  mid-save never corrupts the latest checkpoint.
* **async**: ``save()`` copies every leaf to the host, hands the copies to
  a writer thread and returns; ``wait()`` joins it (one write in flight).
  The copy is taken before ``save()`` returns because the trainer updates
  its parameters in place: a thread reading live tensors would write a
  later step's values.
* ``keep``: the newest ``keep`` steps stay, older ones are removed.
* ``restore(template)`` puts each leaf on its template leaf's device;
  ``restore(template, shardings=)`` places each leaf by its
  ``parallel.sharding.NamedSharding`` (a DTensor on that mesh, each rank
  keeping its shard): ``repro``'s elastic restore onto another mesh.
* a DTensor leaf is gathered whole (``full_tensor``, on every rank) before
  its host copy; ``write=False`` (the ranks but one of a mesh) gathers and
  writes nothing.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.parallel.sharding import distribute, full_tensor


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_describe(v) for v in tree) + ")"
    return "None" if tree is None else "*"


def _host_copy(x) -> np.ndarray:
    """A host array of ``x`` (a DTensor gathered whole) that nothing else
    references."""
    if isinstance(x, torch.Tensor):
        return full_tensor(x.detach()).to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, write: bool = True):
        self.dir = directory
        self.keep = keep
        self.write = write
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- save --

    def save(self, step: int, tree: Any, blocking: bool = False):
        """Snapshot to the host, then write in the background."""
        self.wait()  # one in-flight write at a time
        host_leaves = [_host_copy(x) for x in tree_leaves(tree)]
        if not self.write:
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, host_leaves, _describe(tree)), daemon=True
        )
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, leaves, treedef_str: str):
        try:
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, leaf in enumerate(leaves):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), leaf)
            manifest = {
                "step": step,
                "n_leaves": len(leaves),
                "treedef": treedef_str,
                "shapes": [list(x.shape) for x in leaves],
                "dtypes": [str(x.dtype) for x in leaves],
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()
        except Exception as e:  # raised again by wait() in the caller's thread
            self._error = e

    def wait(self):
        """Join the write in flight; a write that failed raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.available_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ---------------------------------------------------------- restore --

    def available_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None, shardings=None):
        """Restore into the structure of ``template``: a tensor leaf comes
        back as a tensor on its device, a numpy leaf as an array.
        ``shardings``: a tree of ``NamedSharding``s matching ``template``;
        each leaf comes back as a DTensor placed by its sharding (elastic
        restore onto another mesh than the one that saved).  Returns (tree,
        step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = tree_leaves(template)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(f"tree structure changed: {manifest['n_leaves']} leaves "
                             f"saved, {len(leaves)} in the template")
        flat_sh = [None] * len(leaves) if shardings is None else tree_leaves(shardings)
        if len(flat_sh) != len(leaves):
            raise ValueError(f"{len(flat_sh)} shardings for {len(leaves)} leaves")
        out = []
        for i, (want, sh) in enumerate(zip(leaves, flat_sh)):
            got = np.load(os.path.join(path, f"leaf_{i}.npy"))
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(f"leaf {i}: saved {got.shape}, template {tuple(want.shape)}")
            if sh is not None:
                device = want.device if isinstance(want, torch.Tensor) else "cpu"
                out.append(distribute(torch.from_numpy(got).to(device), sh.mesh,
                                      sh.placements))
            else:
                out.append(torch.from_numpy(got).to(want.device)
                           if isinstance(want, torch.Tensor) else got)
        return _unflatten(template, iter(out)), step
