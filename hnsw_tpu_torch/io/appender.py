"""Streaming Arrow ingest (copy of hnsw_tpu/io/appender.py) — parity
with arrow/appender.go.

Feeds Arrow RecordBatches (the Arrow Flight entry point, appender.go's
design role) into any index via buffered batched inserts:
schema validation (appender.go:65-150), append_record/batch/table, and
a stream consumer for iterators/generators of record batches
(appender.go:306-338's StreamRecords; Python iterators subsume the
channel variant).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Iterable, List, Optional

import numpy as np

try:
    import pyarrow as pa
    HAVE_ARROW = True
except Exception:  # pragma: no cover
    HAVE_ARROW = False


@dataclasses.dataclass(frozen=True)
class AppenderConfig:
    """appender.go:23-42 defaults."""
    key_field: str = "key"
    vector_field: str = "vector"
    batch_size: int = 1000


class ArrowAppender:
    """Buffered streaming ingest into an index (anything with
    batch_add)."""

    def __init__(self, index, config: Optional[AppenderConfig] = None):
        if not HAVE_ARROW:  # pragma: no cover
            raise RuntimeError("pyarrow is required for ArrowAppender")
        self.index = index
        self.cfg = config or AppenderConfig()
        self._keys: List[Any] = []
        self._vecs: List[np.ndarray] = []
        self.total_appended = 0

    # -- schema validation (appender.go:65-150) ------------------------------
    def validate_schema(self, schema: "pa.Schema") -> None:
        names = set(schema.names)
        if self.cfg.key_field not in names:
            raise ValueError(f"schema missing key field "
                             f"{self.cfg.key_field!r}")
        if self.cfg.vector_field not in names:
            raise ValueError(f"schema missing vector field "
                             f"{self.cfg.vector_field!r}")
        vf = schema.field(self.cfg.vector_field).type
        ok = (pa.types.is_list(vf) or pa.types.is_fixed_size_list(vf)
              or pa.types.is_large_list(vf))
        if not ok or not pa.types.is_floating(vf.value_type):
            raise ValueError(
                f"vector field must be list<floating>, got {vf}")
        kf = schema.field(self.cfg.key_field).type
        if not (pa.types.is_integer(kf) or pa.types.is_string(kf)
                or pa.types.is_large_string(kf)):
            raise ValueError(f"key field must be integer or string, got {kf}")

    # -- appends ----------------------------------------------------------------
    def append_record(self, batch: "pa.RecordBatch") -> int:
        self.validate_schema(batch.schema)
        keys = batch.column(self.cfg.key_field).to_pylist()
        vec_col = batch.column(self.cfg.vector_field)
        vecs = [np.asarray(v, np.float32) for v in vec_col.to_pylist()]
        for k, v in zip(keys, vecs):
            self._keys.append(k)
            self._vecs.append(v)
            if len(self._keys) >= self.cfg.batch_size:
                self.flush()
        return len(keys)

    def append_table(self, table: "pa.Table") -> int:
        n = 0
        for batch in table.to_batches():
            n += self.append_record(batch)
        return n

    append_batch = append_record  # reference exposes both names

    def flush(self) -> int:
        if not self._keys:
            return 0
        n = len(self._keys)
        self.index.batch_add(self._keys, np.stack(self._vecs))
        self.total_appended += n
        self._keys, self._vecs = [], []
        return n

    # -- streaming (appender.go:306-338) -----------------------------------------
    def stream_records(self, batches: Iterable["pa.RecordBatch"]) -> int:
        """Consume an iterator of record batches; returns rows ingested."""
        n = 0
        for b in batches:
            n += self.append_record(b)
        self.flush()
        return n

    def stream_records_async(self, batches: Iterable["pa.RecordBatch"]
                             ) -> "StreamHandle":
        """Background-thread variant with an error conduit
        (appender.go's Async + error channel)."""
        handle = StreamHandle()

        def run():
            try:
                handle.rows = self.stream_records(batches)
            except Exception as e:  # surfaced via .result()
                handle.error = e
            finally:
                handle.done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        handle.thread = t
        return handle


class StreamHandle:
    def __init__(self):
        self.done = threading.Event()
        self.error: Optional[Exception] = None
        self.rows = 0
        self.thread: Optional[threading.Thread] = None

    def result(self, timeout: Optional[float] = None) -> int:
        if not self.done.wait(timeout):
            raise TimeoutError("stream still running")
        if self.error:
            raise self.error
        return self.rows
