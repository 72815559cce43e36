"""Incremental write-ahead log (copy of hnsw_tpu/io/wal.py) — parity
with parquet/incremental.go.

Change records (Add/Delete with key, vector, timestamp —
incremental.go:37-51) buffer in memory and flush to numbered log files
``vector%06d.<fmt>`` (incremental.go:126-234). Reads overlay
newest-log-first (incremental.go:237-352). ``compact`` merges base +
logs into a rewritten base and deletes the logs (incremental.go:
453-488); ``should_compact`` triggers on log count or age
(incremental.go:812-827). Compaction-on-open mirrors parquet/graph.go:157.

Durability contract: buffered changes are VOLATILE until ``flush()``
writes them to a log file. Flush triggers: every ``max_changes``
records, ``sync_writes=True`` (flush per record), an age-based
``flush_if_stale`` (driven by DiskGraph's background flusher, the
analogue of the reference's 30s flush goroutine —
parquet/vector_ops.go:80-95), and close.

All public methods are thread-safe (the background flusher runs on its
own thread).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from hnsw_tpu_torch.io import table as T


@dataclasses.dataclass
class Change:
    """incremental.go:37-44."""
    type: str                      # "add" | "delete"
    key: Any
    vector: Optional[np.ndarray]
    timestamp: float


class IncrementalStore:
    """WAL of vector adds/deletes with numbered log files."""

    def __init__(self, directory: str, fmt: str = "parquet",
                 max_changes: int = 1000, max_age_seconds: float = 3600.0,
                 max_log_files: int = 5, sync_writes: bool = False):
        self.dir = directory
        self.fmt = fmt
        self.max_changes = max_changes
        self.max_age = max_age_seconds
        self.max_log_files = max_log_files
        self.sync_writes = sync_writes
        self.pending: List[Change] = []
        self.oldest_pending: Optional[float] = None
        self._lock = threading.RLock()
        os.makedirs(directory, exist_ok=True)

    # -- paths ------------------------------------------------------------
    def _log_paths(self) -> List[str]:
        pat = os.path.join(self.dir, f"vector*.{T.ext_for(self.fmt)}")
        return sorted(glob.glob(pat))

    def _next_log_path(self) -> str:
        logs = self._log_paths()
        n = 0
        if logs:
            last = os.path.basename(logs[-1]).split(".")[0]
            n = int(last.replace("vector", "")) + 1
        return os.path.join(self.dir,
                            f"vector{n:06d}.{T.ext_for(self.fmt)}")

    # -- buffering ------------------------------------------------------------
    def record_add(self, key: Any, vector: np.ndarray) -> None:
        with self._lock:
            self.pending.append(Change("add", key,
                                       np.asarray(vector, np.float32),
                                       time.time()))
            self.oldest_pending = (self.oldest_pending
                                   or self.pending[-1].timestamp)
            if self.sync_writes or len(self.pending) >= self.max_changes:
                self.flush()

    def record_delete(self, key: Any) -> None:
        with self._lock:
            self.pending.append(Change("delete", key, None, time.time()))
            self.oldest_pending = (self.oldest_pending
                                   or self.pending[-1].timestamp)
            if self.sync_writes or len(self.pending) >= self.max_changes:
                self.flush()

    def flush(self) -> Optional[str]:
        """Write pending changes to the next numbered log file
        (incremental.go:154-234). Deletes encode as NaN vectors."""
        with self._lock:
            if not self.pending:
                return None
            dim = next((c.vector.shape[0] for c in self.pending
                        if c.vector is not None), 1)
            keys, vecs = [], []
            for c in self.pending:
                keys.append(c.key)
                if c.type == "add":
                    vecs.append(c.vector)
                else:
                    vecs.append(np.full((dim,), np.nan, np.float32))
            path = self._next_log_path()
            T.write_vectors(path, keys, np.stack(vecs), self.fmt)
            self.pending.clear()
            self.oldest_pending = None
            return path

    def flush_if_stale(self, max_age_seconds: float) -> Optional[str]:
        """Flush iff the oldest buffered change is older than
        ``max_age_seconds`` — the age-triggered path of the reference's
        background flush goroutine (parquet/vector_ops.go:80-95)."""
        with self._lock:
            if (self.oldest_pending is not None
                    and time.time() - self.oldest_pending
                    >= max_age_seconds):
                return self.flush()
            return None

    # -- reads (overlay newest-first, incremental.go:237-352) ----------------
    def get_vector(self, key: Any) -> Tuple[bool, Optional[np.ndarray]]:
        """(found, vector|None). found+None means 'deleted here'."""
        with self._lock:
            for c in reversed(self.pending):
                if c.key == key:
                    return True, (c.vector if c.type == "add" else None)
        for path in reversed(self._log_paths()):
            keys, vecs = T.read_vectors(path, self.fmt)
            for i in range(len(keys) - 1, -1, -1):
                if keys[i] == key:
                    v = vecs[i]
                    return True, (None if np.isnan(v).all() else v)
        return False, None

    def overlay(self) -> Dict[Any, Optional[np.ndarray]]:
        """Materialize the full overlay: key -> vector (None=deleted)."""
        out: Dict[Any, Optional[np.ndarray]] = {}
        for path in self._log_paths():                # oldest -> newest
            keys, vecs = T.read_vectors(path, self.fmt)
            for k, v in zip(keys, vecs):
                out[k] = None if np.isnan(v).all() else v
        with self._lock:
            for c in self.pending:
                out[c.key] = c.vector if c.type == "add" else None
        return out

    # -- compaction (incremental.go:453-488, 812-827) --------------------------
    def should_compact(self) -> bool:
        if len(self._log_paths()) > self.max_log_files:
            return True
        with self._lock:
            if (self.oldest_pending is not None
                    and time.time() - self.oldest_pending > self.max_age):
                return True
        return False

    def merge(self, base_keys: Sequence[Any], base_vectors: np.ndarray,
              overlay: Optional[Dict[Any, Optional[np.ndarray]]] = None
              ) -> Tuple[List[Any], np.ndarray]:
        """Merge base + overlay WITHOUT touching the log files. The
        caller persists the merged state first, then calls
        ``discard_logs`` — so a crash between the two never loses data.

        Vectorized for the common shape (huge base, small overlay): the
        untouched base rows ride one boolean-mask slice instead of a
        per-key dict + np.stack (which cost tens of seconds per million
        rows on reopen). Pass ``overlay`` to reuse an already-read one.
        """
        ov = self.overlay() if overlay is None else overlay
        base_vectors = np.asarray(base_vectors)
        if not ov:
            return list(base_keys), base_vectors
        touched = set(ov)
        keep = np.fromiter((k not in touched for k in base_keys),
                           bool, count=len(base_keys))
        keys = [k for k, m in zip(base_keys, keep) if m]
        adds = [(k, v) for k, v in ov.items() if v is not None]
        keys += [k for k, _ in adds]
        dim = (base_vectors.shape[1] if base_vectors.ndim == 2
               and base_vectors.size else
               (len(adds[0][1]) if adds else 0))
        parts = []
        if keep.any():
            parts.append(base_vectors[keep])
        if adds:
            parts.append(np.stack([v for _, v in adds]))
        vecs = (np.concatenate(parts).astype(np.float32, copy=False)
                if parts else np.zeros((0, dim), np.float32))
        return keys, vecs

    def discard_logs(self) -> None:
        """Delete all log files + drop buffered changes. Only call after
        the merged state has been durably persisted elsewhere."""
        with self._lock:
            for path in self._log_paths():
                os.unlink(path)
            self.pending.clear()
            self.oldest_pending = None

    def compact(self, base_keys: Sequence[Any], base_vectors: np.ndarray
                ) -> Tuple[List[Any], np.ndarray]:
        """Merge base + overlay -> new base; delete all logs. Returns the
        merged (keys, vectors). NOTE: the caller must persist the result;
        prefer merge() + persist + discard_logs() for crash safety."""
        with self._lock:
            self.flush()
            keys, vecs = self.merge(base_keys, base_vectors)
            self.discard_logs()
            return keys, vecs

    @property
    def num_log_files(self) -> int:
        return len(self._log_paths())
