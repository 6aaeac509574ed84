"""Shared NFS volume analog (paper §III-e).

One volume per job, mounted by both the learner pods and the helper pod.
Learners redirect exit status and progress into files; the isolated
controller detects completion/failure by reading them — the volume state
survives crashes of *either* side.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class Volume:
    def __init__(self, name: str):
        self.name = name
        self.files: Dict[str, Any] = {}

    def write(self, path: str, data: Any) -> None:
        self.files[path] = data

    def append(self, path: str, line: str) -> None:
        self.files.setdefault(path, [])
        self.files[path].append(line)

    def read(self, path: str, default: Any = None) -> Any:
        return self.files.get(path, default)

    def ls(self, prefix: str = ""):
        return sorted(k for k in self.files if k.startswith(prefix))


class VolumeManager:
    def __init__(self):
        self._vols: Dict[str, Volume] = {}

    def provision(self, name: str) -> Volume:
        if name not in self._vols:
            self._vols[name] = Volume(name)
        return self._vols[name]

    def get(self, name: str) -> Optional[Volume]:
        return self._vols.get(name)

    def release(self, name: str) -> bool:
        return self._vols.pop(name, None) is not None

    def active(self):
        return sorted(self._vols)
