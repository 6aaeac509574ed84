"""Cloud object store analog (checkpoints, results, logs).

Content integrity is first-class: every blob carries its sha256; manifests
are published atomically (a checkpoint either has a complete valid manifest
or does not exist).  ``corrupt()`` flips bytes for the corruption-detection
tests — a restored learner must reject a damaged checkpoint and fall back
to the previous one.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional


class ObjectStore:
    def __init__(self):
        self._blobs: Dict[str, bytes] = {}
        self.alive = True
        self.put_count = 0
        self.bytes_written = 0

    def _check(self):
        if not self.alive:
            raise ConnectionError("object store unavailable")

    # -- raw blobs --------------------------------------------------------
    def put(self, path: str, data: bytes) -> str:
        self._check()
        digest = hashlib.sha256(data).hexdigest()
        self._blobs[path] = data
        self.put_count += 1
        self.bytes_written += len(data)
        return digest

    def append(self, path: str, data: bytes) -> None:
        """Append to a blob without rewriting it (the log-shipping path).
        Costs O(len(data)) per call — the blob grows in place (bytearray),
        so shipping n log lines writes O(total) bytes, not O(n²) as the
        old read-modify-write ``get`` + ``put`` per line did."""
        self._check()
        buf = self._blobs.get(path)
        if not isinstance(buf, bytearray):
            buf = bytearray(buf if buf is not None else b"")
            self._blobs[path] = buf
        buf += data
        self.put_count += 1
        self.bytes_written += len(data)

    def get(self, path: str) -> bytes:
        self._check()
        raw = self._blobs[path]
        # only append()-grown blobs are bytearray-backed; don't tax every
        # read (checkpoint shards are large) with a defensive copy
        return bytes(raw) if isinstance(raw, bytearray) else raw

    def exists(self, path: str) -> bool:
        return path in self._blobs

    def delete_prefix(self, prefix: str) -> int:
        self._check()
        doomed = [k for k in self._blobs if k.startswith(prefix)]
        for k in doomed:
            del self._blobs[k]
        return len(doomed)

    def list_prefix(self, prefix: str) -> List[str]:
        self._check()
        return sorted(k for k in self._blobs if k.startswith(prefix))

    # -- integrity-checked documents ---------------------------------------
    def put_json_atomic(self, path: str, obj: dict) -> None:
        """Manifest publish: serialize + checksum + single-key insert (the
        atomicity unit).  Readers see old manifest or new, never torn."""
        body = json.dumps(obj, sort_keys=True).encode()
        digest = hashlib.sha256(body).hexdigest()
        self._check()
        self._blobs[path] = json.dumps(
            {"sha256": digest, "body": obj}, sort_keys=True).encode()
        self.put_count += 1
        self.bytes_written += len(body)

    def get_json_verified(self, path: str) -> Optional[dict]:
        """Returns the manifest body, or None if missing/corrupt."""
        self._check()
        raw = self._blobs.get(path)
        if raw is None:
            return None
        try:
            wrapper = json.loads(raw.decode())
            body = wrapper["body"]
            digest = hashlib.sha256(
                json.dumps(body, sort_keys=True).encode()).hexdigest()
            if digest != wrapper["sha256"]:
                return None
            return body
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            # the corruption modes of a torn/garbage manifest: bad UTF-8,
            # bad JSON (ValueError), missing wrapper keys, non-dict wrapper
            return None

    def verify(self, path: str, sha256: str) -> bool:
        raw = self._blobs.get(path)
        return raw is not None and hashlib.sha256(raw).hexdigest() == sha256

    # -- fault injection -----------------------------------------------------
    def corrupt(self, path: str, byte_index: int = 0) -> None:
        raw = bytearray(self._blobs[path])
        raw[byte_index % len(raw)] ^= 0xFF
        self._blobs[path] = bytes(raw)
