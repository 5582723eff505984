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

Restore lays each tensor onto the template's device and dtype (the
template is a state of the same tree, any device).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.utils.pytrees import flatten_with_paths, unflatten_paths


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
        t = torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                               dtype=leaf.dtype)
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
            buf = io.BytesIO()
            np.savez(buf, **{k.replace("/", "\x1f"): v
                             for k, v in arrays.items()})
            payload = buf.getvalue()
            digest = hashlib.sha256(payload).hexdigest()
            tmp = os.path.join(self.dir, f".tmp.{step}")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "state.npz"), "wb") as f:
                f.write(payload)
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
        with open(os.path.join(path, "state.npz"), "rb") as f:
            payload = f.read()
        if verify:
            digest = hashlib.sha256(payload).hexdigest()
            if digest != meta["sha256"]:
                raise IOError(f"checkpoint {path} failed integrity check")
        npz = np.load(io.BytesIO(payload))
        arrays = {k.replace("\x1f", "/"): npz[k] for k in npz.files}
        return _rebuild(template, arrays), meta

    def restore_latest(self, template):
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, template)
