"""Checkpointing of tensor trees: atomic, keep-k (port of
``repro.checkpoint.manager``).

Format: one directory per step --
    step_000123/
      manifest.json   # leaf paths, dtypes, shapes, extras
      arrays.npz      # the flattened leaves, on the host
      _COMMITTED      # written last; readers ignore dirs without it

Durability contract (the reference's):

* **Atomicity**: a save goes to ``step_X.tmp-<nonce>``, writes
  ``_COMMITTED`` last and is renamed into place (rename is atomic on
  POSIX), so a process dying mid-save never corrupts a restore point.
  Overwriting a committed step renames the old directory aside
  (``step_X.old-<nonce>``) first and removes it only after the new commit
  lands; a stranded aside is renamed back by recovery when a manager is
  constructed, so no crash point loses the step.
* **Exact leaves**: a bfloat16 tensor (npz has no such dtype) is stored as
  its uint16 bits and viewed back on restore; every other dtype, the
  packed int32 words of the 1-bit planes included, is stored as it is.
  A serving cache comes back bit for bit.
* **Keep-k**: older committed steps are pruned after a successful commit,
  never before.

The manifest is JSON (the reference writes msgpack, optionally
zstd-compressed, neither of which this package needs).  ``restore`` puts
each leaf on its template's device with its template's dtype.

**Sharded runs**: a checkpoint always holds the global leaves.
``save(..., gather=)`` takes a collective from its caller
(``runtime.sharding.gather_tree_to``, passed in by ``TrainingRunner``)
that puts the global tree on one rank's host and returns ``None`` on the
others: that rank writes, and the caller waits for its commit.
``restore(..., shardings=)`` gives each rank its slice of each saved leaf
(each sharding's ``shard``), so a run saved on one mesh resumes on another
(the reference's elastic restore).  Only the writer repairs or prunes the
directory.  The manager imports nothing of the runtime.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_paths, unflatten

__all__ = ["CheckpointManager"]

_MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d{9})$")


def _write_manifest(dirname: str, manifest: dict) -> None:
    with open(os.path.join(dirname, _MANIFEST), "w") as f:
        json.dump(manifest, f)


def _read_manifest(dirname: str) -> dict:
    with open(os.path.join(dirname, _MANIFEST)) as f:
        return json.load(f)


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str, Optional[str]]:
    """A tensor as a numpy array, with its dtype's name and, where npz
    cannot hold the dtype, the dtype it is stored as."""
    t = leaf.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16", "uint16"
    return t.numpy(), str(t.dtype).removeprefix("torch."), None


def _from_host(arr: np.ndarray, entry: dict) -> torch.Tensor:
    if entry.get("stored_as") == "uint16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))  # keeps a 0-d leaf 0-d


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, writer: bool = True):
        self.directory = directory
        self.keep = keep
        self.writer = writer
        os.makedirs(directory, exist_ok=True)
        if writer:
            self._recover()

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extras: Optional[dict] = None, gather: Any = None) -> str:
        """Atomically persist ``tree`` (tensors, + JSON-able ``extras``) for ``step``.

        Overwriting an existing committed step never opens a loss window:
        the old directory is renamed ASIDE (``step_X.old-<nonce>``) before
        the new one is renamed into place, and removed only after the new
        commit lands.  A crash anywhere in between leaves either the final
        dir or the aside dir committed; :meth:`_recover` (run at manager
        construction) renames a stranded aside back into place.

        ``gather``: when ``tree`` holds this rank's shards, a collective
        that every rank of the mesh calls through ``save``, returning the
        global tree on one rank and ``None`` on the others; the rank that
        gets the tree writes it, the others return the step's path at
        once.  The caller waits for the commit (a barrier) before it
        counts on the step.
        """
        if gather is not None:
            tree = gather(tree)
            if tree is None:
                return os.path.join(self.directory, f"step_{step:09d}")
        return self._write(step, tree, extras)

    def _write(self, step: int, tree: Any, extras: Optional[dict]) -> str:
        final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = tempfile.mkdtemp(prefix=f"step_{step:09d}.tmp-", dir=self.directory)
        old = None
        try:
            arrays = {}
            meta = []
            for i, (p, leaf) in enumerate(leaves_with_paths(tree)):
                arr, dtype, stored_as = _to_host(leaf)
                entry = {"path": p, "dtype": dtype, "shape": list(arr.shape)}
                if stored_as is not None:
                    entry["stored_as"] = stored_as
                arrays[f"a{i}"] = arr
                meta.append(entry)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            manifest = {
                "step": step,
                "leaves": meta,
                "extras": extras or {},
                "time": time.time(),
                "proc": 0,
            }
            _write_manifest(tmp, manifest)
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                # rename aside, never rmtree-then-rename: a crash between
                # those two would lose the only committed copy of this step
                old = final + ".old-" + os.path.basename(tmp).rsplit(".tmp-", 1)[1]
                os.rename(final, old)
            os.rename(tmp, final)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            # an in-process failure between the two renames: put the old
            # committed step back where readers look for it
            if old is not None and os.path.exists(old) and not os.path.exists(final):
                os.rename(old, final)
            raise
        self._prune()
        return final

    # ------------------------------------------------------------------
    def _recover(self) -> None:
        """Repair the overwrite crash window: a committed ``step_X.old-*``
        aside whose ``step_X`` is missing is renamed back into place (the
        process died between the two renames of an overwrite); asides whose
        final exists are leftovers of a crash after commit and are removed."""
        for name in os.listdir(self.directory):
            if ".old-" not in name:
                continue
            aside = os.path.join(self.directory, name)
            final = os.path.join(self.directory, name.split(".old-", 1)[0])
            if not _STEP_RE.match(os.path.basename(final)):
                continue
            if os.path.exists(os.path.join(final, "_COMMITTED")):
                shutil.rmtree(aside, ignore_errors=True)
            elif os.path.exists(os.path.join(aside, "_COMMITTED")):
                shutil.rmtree(final, ignore_errors=True)  # uncommitted husk
                os.rename(aside, final)
            else:
                shutil.rmtree(aside, ignore_errors=True)

    # ------------------------------------------------------------------
    def _committed_steps(self) -> List[int]:
        return sorted(
            int(m.group(1))
            for name in os.listdir(self.directory)
            if (m := _STEP_RE.match(name))
            and os.path.exists(os.path.join(self.directory, name, "_COMMITTED"))
        )

    def latest_step(self) -> Optional[int]:
        steps = self._committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None,
                shardings: Any = None) -> Tuple[int, Any, dict]:
        """Load (step, tree, extras).

        ``like``: template tree -- the structure to restore into; each leaf
        comes back on its template's device with its template's dtype, and
        must have its template's shape.  ``shardings``: a matching tree of
        ``NamedSharding`` -- each saved (global) leaf is sliced to this
        rank's piece on that mesh (its ``shard``), which ``like`` holds; the
        mesh may differ from the one that saved it (elastic restore).
        """
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.directory}")
        if like is None:
            raise ValueError("restore requires a template tree (like=)")
        d = os.path.join(self.directory, f"step_{step:09d}")
        manifest = _read_manifest(d)
        data = np.load(os.path.join(d, "arrays.npz"))
        by_path = {m["path"]: (m, data[f"a{i}"]) for i, m in enumerate(manifest["leaves"])}
        out = []
        placed = [None] * len(leaves_with_paths(like)) if shardings is None else [
            sh for _, sh in leaves_with_paths(shardings)]
        for (p, leaf), sh in zip(leaves_with_paths(like), placed):
            if p not in by_path:
                raise KeyError(f"checkpoint missing leaf {p}")
            entry, arr = by_path[p]
            t = _from_host(arr, entry)
            if sh is not None:
                t = sh.shard(t)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {p}: {tuple(t.shape)} vs {tuple(leaf.shape)}")
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        return step, unflatten(like, out), manifest["extras"]

    # ------------------------------------------------------------------
    def _prune(self) -> None:
        if not self.writer:
            return
        steps = self._committed_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)
        # clean stale tmpdirs from crashed saves
        for name in os.listdir(self.directory):
            if ".tmp-" in name:
                full = os.path.join(self.directory, name)
                if time.time() - os.path.getmtime(full) > 3600:
                    shutil.rmtree(full, ignore_errors=True)
