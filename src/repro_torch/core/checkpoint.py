"""Checkpoint manager: user-directed + periodic checkpoints to object store.

Layout per checkpoint:
    ckpt/<job>/<step>/blob/<leaf-path>     raw little-endian array bytes
    ckpt/<job>/<step>/manifest             atomic JSON: shapes/dtypes/sha256s

Guarantees:
* **Atomic publish** — the manifest is written last; a checkpoint without a
  valid manifest does not exist (crash-during-save leaves no torn state).
* **Integrity** — every blob's sha256 is verified on load; a corrupt
  checkpoint is skipped and the previous one used (tested).
* **Retention** — keep the most recent ``keep_last`` checkpoints.

Works for the port's train states (numpy trees in the reference's layout,
``convert.train_state_to_jax``), for trees of torch tensors on any device
and for the tiny state dicts of simulated learners alike.

This is the port's copy of the reference's ``core/checkpoint.py`` and
writes its byte layout exactly (keys, raw little-endian blobs, manifest
JSON, sha256), so a checkpoint written by either package loads in the
other.  What differs: a leaf may be a torch tensor, and bf16 leaves go
through their 2-byte view under the dtype name ``"bfloat16"`` (the
reference reads them with ``ml_dtypes``, which the port does not need);
they load back as CPU ``torch.bfloat16`` tensors, every other leaf as a
numpy array.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.objectstore import ObjectStore

SEP = "/"
BF16 = "bfloat16"


def _leaf_bytes(leaf: Any) -> Tuple[List[int], str, bytes]:
    """``(shape, dtype name, raw bytes)`` of one leaf: a torch tensor on
    any device, a numpy array (``ml_dtypes`` bf16 included) or a
    scalar."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            arr, name = t.contiguous().view(torch.int16).cpu().numpy(), BF16
        else:
            arr = t.cpu().numpy()
            name = str(arr.dtype)
        return list(t.shape), name, np.ascontiguousarray(arr).tobytes()
    arr = np.asarray(leaf)
    return list(arr.shape), str(arr.dtype), np.ascontiguousarray(arr).tobytes()


def _from_bytes(data: bytes, name: str, shape) -> Any:
    if name == BF16:
        bits = np.frombuffer(data, dtype=np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
    else:
        out[prefix.rstrip(SEP)] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, val in flat.items():
        parts = path.split(SEP)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


class CheckpointManager:
    def __init__(self, store: ObjectStore, job_id: str, keep_last: int = 3):
        if not job_id or SEP in job_id:
            # a slash would fold extra levels into the key layout and break
            # step parsing / prefix GC
            raise ValueError(f"invalid job_id {job_id!r}: must be non-empty "
                             f"and must not contain {SEP!r}")
        if keep_last < 0:
            raise ValueError(f"keep_last must be >= 0, got {keep_last}")
        self.store = store
        self.job_id = job_id
        self.keep_last = keep_last

    def _base(self, step: int) -> str:
        return f"ckpt/{self.job_id}/{step:012d}"

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> int:
        """Returns total bytes written."""
        flat = _flatten(tree)
        base = self._base(step)
        manifest: Dict[str, Any] = {"step": step, "leaves": {}}
        total = 0
        for path, leaf in flat.items():
            shape, dtype, data = _leaf_bytes(leaf)
            blob_path = f"{base}/blob/{path}"
            digest = self.store.put(blob_path, data)
            manifest["leaves"][path] = {
                "shape": shape, "dtype": dtype,
                "sha256": digest, "bytes": len(data)}
            total += len(data)
        self.store.put_json_atomic(f"{base}/manifest", manifest)
        self._gc(current=step)
        return total

    # ------------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        prefix = f"ckpt/{self.job_id}/"
        for p in self.store.list_prefix(prefix):
            # parse relative to the listing prefix (an absolute split index
            # would mis-parse if the layout ever gains/loses a level)
            rest = p[len(prefix):]
            head, _, tail = rest.partition("/")
            if tail.rstrip("/") == "manifest" and head.isdigit():
                out.append(int(head))
        return sorted(set(out))

    def latest_valid_step(self) -> Optional[int]:
        for step in reversed(self.steps()):
            if self._valid(step):
                return step
        return None

    def newest_invalid(self) -> Optional[int]:
        """The newest checkpoint generation, iff it fails integrity.

        This is the classifier's CKPT_CORRUPT evidence: a crashed learner
        restoring now would skip this generation and silently lose work
        back to the previous one.
        """
        steps = self.steps()
        if steps and not self._valid(steps[-1]):
            return steps[-1]
        return None

    def fallback_one(self) -> Optional[int]:
        """Safe-list repair for CKPT_CORRUPT: drop exactly one (corrupt)
        newest generation and return the step to roll the gang back to.

        Deliberately bounded — never deletes a generation that passes
        integrity, and never walks further back than one generation, so
        a misclassification cannot destroy good checkpoints.
        """
        bad = self.newest_invalid()
        if bad is not None:
            self.store.delete_prefix(self._base(bad))
        return self.latest_valid_step()

    def _valid(self, step: int) -> bool:
        base = self._base(step)
        man = self.store.get_json_verified(f"{base}/manifest")
        if man is None:
            return False
        for path, meta in man["leaves"].items():
            if not self.store.verify(f"{base}/blob/{path}", meta["sha256"]):
                return False
        return True

    def load(self, step: Optional[int] = None) -> Optional[Tuple[int, Any]]:
        """Load ``step`` (or the latest *valid* checkpoint).  Corrupt or torn
        checkpoints are skipped, falling back to older ones."""
        candidates = [step] if step is not None else list(reversed(self.steps()))
        for s in candidates:
            base = self._base(s)
            man = self.store.get_json_verified(f"{base}/manifest")
            if man is None:
                continue
            flat = {}
            ok = True
            for path, meta in man["leaves"].items():
                blob_path = f"{base}/blob/{path}"
                if not self.store.verify(blob_path, meta["sha256"]):
                    ok = False
                    break
                flat[path] = _from_bytes(self.store.get(blob_path),
                                         meta["dtype"], meta["shape"])
            if ok:
                return s, _unflatten(flat)
        return None

    def _gc(self, current: Optional[int] = None) -> None:
        """Retention: keep the newest ``keep_last`` checkpoints, always
        including the just-saved ``current``.  ``keep_last=0`` keeps *only*
        the current one (a plain ``steps[:-0]`` slice would be empty and
        delete nothing — the historical bug)."""
        steps = self.steps()
        protect = set(steps[-self.keep_last:]) if self.keep_last > 0 else set()
        if current is not None:
            protect.add(current)
        for s in steps:
            if s not in protect:
                self.store.delete_prefix(self._base(s))
