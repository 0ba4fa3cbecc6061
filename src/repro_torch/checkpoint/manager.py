"""Checkpoint manager: atomic, checksummed, async-capable. The port's copy
of ``repro/checkpoint/manager.py``; it writes the same files.

  * **atomicity** — writes go to ``step_XXXXXXXX.tmp`` and are renamed
    only after the manifest (with per-array SHA-256) is fsynced; a crashed
    save never corrupts the latest-good checkpoint.
  * **async** — ``save(..., blocking=False)`` snapshots to host memory
    and writes on a background thread; :meth:`CheckpointManager.wait`
    joins it.
  * **self-describing restore** — one ``np.save`` per leaf, unsharded;
    ``restore_arrays(step)`` loads a step's leaves from its manifest
    alone.
  * **retention** — ``keep_last`` prunes old steps; a ``latest`` symlink
    gives O(1) discovery.

The reference flattens a pytree; the port has no tree library, so a
checkpoint is a plain list of leaves, in the order the caller gives
(``core.state.PLANES`` for an index state, the reference's flatten
order). A leaf is a numpy array or a tensor, written in its own dtype:
callers cross dtypes that differ from the reference's (the bitmap's
int32 words) before they save.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch


def _host(x, copy: bool) -> np.ndarray:
    """A leaf as a host array; ``copy`` snapshots one the caller may go on
    mutating (a CPU tensor's ``.numpy()`` shares its memory)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        a = x.cpu().numpy() if x.is_cuda else x.numpy()
        return a.copy() if copy and not x.is_cuda else a
    a = np.asarray(x)
    return a.copy() if copy else a


def sha256_of(arr: np.ndarray) -> str:
    """SHA-256 of the array's C-order bytes (``arr.tobytes()``), without
    the copy ``tobytes`` makes of a contiguous array."""
    a = np.ascontiguousarray(arr)
    return hashlib.sha256(a.reshape(-1).view(np.uint8)).hexdigest()


class CheckpointManager:
    def __init__(self, directory, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, leaves, blocking: bool = True) -> None:
        """Snapshot ``leaves`` (a list) at ``step``. A non-blocking save
        copies to host memory first, then writes on a daemon thread."""
        host = [_host(x, copy=not blocking) for x in leaves]
        self.wait()                                # one in-flight save max
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "arrays": []}
        for i, arr in enumerate(host_leaves):
            path = tmp / f"arr_{i:05d}.npy"
            np.save(path, arr)
            manifest["arrays"].append({
                "file": path.name,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha256": sha256_of(arr),
            })
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic publish
        latest = self.dir / "latest"
        if latest.is_symlink() or latest.exists():
            latest.unlink()
        os.symlink(final.name, latest)
        self._prune()

    def _prune(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- metadata sidecars --------------------------------------------------

    def save_metadata(self, name: str, obj: dict) -> None:
        """Atomically publish a JSON sidecar (e.g. index config/topology)."""
        tmp = self.dir / f"{name}.json.tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.dir / f"{name}.json")

    def load_metadata(self, name: str) -> dict:
        with open(self.dir / f"{name}.json") as f:
            return json.load(f)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if p.is_dir() and not p.name.endswith(".tmp")]

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return max(steps) if steps else None

    def manifest(self, step: int) -> dict:
        with open(self.dir / f"step_{step:08d}" / "manifest.json") as f:
            return json.load(f)

    def restore_arrays(self, step: int, verify: bool = True
                       ) -> list[np.ndarray]:
        """Load a step's leaves straight from its manifest (shapes and
        dtypes come from the files); ``verify`` checks each SHA-256."""
        d = self.dir / f"step_{step:08d}"
        out = []
        for meta in self.manifest(step)["arrays"]:
            arr = np.load(d / meta["file"])
            if verify and sha256_of(arr) != meta["sha256"]:
                raise IOError(f"checksum mismatch in {meta['file']}")
            out.append(arr)
        return out

    def restore(self, step: int, example, verify: bool = True
                ) -> list[np.ndarray]:
        """Load ``step`` as a list shaped like ``example`` (a list of
        leaves): the leaf count is checked against the manifest before any
        array file is read."""
        stored = len(self.manifest(step)["arrays"])
        if len(example) != stored:
            raise ValueError(
                f"checkpoint/model structure mismatch: example has "
                f"{len(example)} leaves, step {step} stored {stored}")
        return self.restore_arrays(step, verify=verify)
