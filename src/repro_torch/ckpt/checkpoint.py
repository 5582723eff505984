"""Fault-tolerant checkpointing in the JAX package's on-disk format (port
of :mod:`repro.ckpt.checkpoint`), so a training state written by either
package restores in the other.

* the payload is one ``state.npz`` of the state's tensors keyed by tree
  path, ``/`` written as ``\\x1f`` (the state's paths are JAX's:
  ``params/...``, ``opt/.../m``, ``step``);
* ``meta.json`` holds the step, the payload's sha256 (checked on load),
  the time and an ``extra`` dict;
* atomic publish: written to ``<dir>/.tmp.<step>`` and renamed to
  ``step_<step:09d>``;
* async saves: the tensors are copied to the host on the caller's thread,
  serialized and written on a background thread, one save in flight;
* keep-N garbage collection.

The payload is streamed, never held whole in memory: ``np.savez`` writes
it straight to its file (the same bytes it would write to a buffer), and
its sha256 is taken by reading the file back in chunks; a restore hashes
the file on a thread while the tensors are parsed from it, and raises
before returning if the digest differs.  Restore lays each tensor onto the
template's device and dtype (the template is a state of the same tree,
any device).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.utils.pytrees import flatten_with_paths, unflatten_paths


# bytes a hash reads at a time
_CHUNK = 64 << 20


def _sha256_file(path: str) -> str:
    """The sha256 of the file at `path`, read in chunks."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(_CHUNK)
            if not b:
                return h.hexdigest()
            h.update(b)


def _tree_to_arrays(tree) -> dict:
    return {path: leaf.detach().cpu().numpy()
            for path, leaf in flatten_with_paths(tree)}


def _rebuild(template, arrays: dict):
    leaves = []
    for path, leaf in flatten_with_paths(template):
        if path not in arrays:
            raise KeyError(f"checkpoint missing tensor {path!r}")
        arr = arrays[path]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(leaf.shape)}")
        # an array parsed from the payload is the caller's own (a fresh
        # writable array); a read-only one is copied first
        arr = arr if arr.flags.writeable else np.array(arr)
        t = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
        leaves.append((path, t.requires_grad_(leaf.requires_grad)))
    return unflatten_paths(leaves)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, extra: Optional[dict] = None,
             block: bool = False):
        arrays = _tree_to_arrays(state)      # the device copy, synchronous
        self.wait()                          # one in-flight save at a time

        def write():
            tmp = os.path.join(self.dir, f".tmp.{step}")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            payload = os.path.join(tmp, "state.npz")
            with open(payload, "wb") as f:
                np.savez(f, **{k.replace("/", "\x1f"): v
                               for k, v in arrays.items()})
            digest = _sha256_file(payload)
            meta = {"step": step, "sha256": digest, "time": time.time(),
                    "extra": extra or {}}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)            # atomic publish
            self._gc()

        if self.async_save and not block:
            def run():
                try:
                    write()
                except BaseException as e:   # reported by wait()
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        """Join the save in flight; raise the error it hit, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template, verify: bool = True):
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        payload = os.path.join(path, "state.npz")
        # the digest on a thread (hashlib releases the GIL) while the
        # tensors are parsed; checked before anything is returned or
        # raised, so a corrupt payload fails its integrity check whatever
        # the parse made of it
        digest = {}
        hasher = threading.Thread(
            target=lambda: digest.setdefault("sha256",
                                             _sha256_file(payload)),
            daemon=True)
        if verify:
            hasher.start()
        state, error = None, None
        try:
            with np.load(payload) as npz:
                arrays = {k.replace("\x1f", "/"): npz[k]
                          for k in npz.files}
            state = _rebuild(template, arrays)
        except Exception as e:               # raised after the check
            error = e
        if verify:
            hasher.join()
            if digest.get("sha256") != meta["sha256"]:
                raise IOError(f"checkpoint {path} failed integrity "
                              f"check") from error
        if error is not None:
            raise error
        return state, meta

    def restore_latest(self, template):
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, template)
