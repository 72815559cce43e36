"""hnsw_tpu_torch — the hnsw_tpu vector index served with PyTorch and CUDA.

A port of ``hnsw_tpu`` (JAX, TPU) to PyTorch on NVIDIA GPUs, with the
same module layout and public names. It imports neither JAX nor the JAX
package. Ported: both index types with their serving and capacity modes,
the device wave builder, checkpoints, the hybrid and adaptive engines
with their LSH, IVF and partitioner tiers, disk storage (DiskGraph, WAL,
mmap store), the streaming exact tier, facets, metadata, the analyzer and
the multi-device package ``parallel`` (a mesh of shards driven by one
process, several of which may share a card; slices over TCP); every
public name of ``hnsw_tpu``.

  Graph              HNSW index: native C++ host build or the device wave
                     builder (core/build_device.py: build, refine, delete
                     repair, checkpoints, deadlines, resume_build),
                     batched beam search on the device (core/search.py)
                     in every serving layout (fp16/bf16/int8 stores,
                     neighbor blocks, pivot entry, compact upper layers)
  ExactIndex         brute-force k-NN; on CUDA at 32768+ rows the float32
                     table runs the hand-written screen kernel
                     (csrc/exact_screen.cu), and so do the int8/bf16/fp16
                     capacity tables (the capacity screen), which rerank
                     on the host
  HybridIndex        tiered dispatch exact / graph / LSH or IVF, and
                     recall-aware routing (search(..., target_recall=))
  AdaptiveHybridIndex  every vector in every tier; a per-query bandit
                     (AdaptiveSelector) picks the arm, probes recall
                     against the exact tier and backstops weak arms;
                     warm(k) before serving, fallback_errors to watch
  IVFIndex           k-means partitions scanned as batched matmuls
  LSHIndex           random-hyperplane buckets + exact re-rank
  Partitioner        centroid routing and rebalance
  MultiIndexAdapter  fan-out search over several indexes
  FacetedGraph       faceted filtering: over-fetch + post-filter, or one
                     masked exact scan (batch_search_exact; K1 on CUDA at
                     32768+ slots)
  MetadataGraph      JSON payloads attached to results
  Analyzer           structure metrics of a graph (host arrays)
  DiskGraph          durable graph: parquet / arrow / npz tables + WAL,
                     vectors in RAM or memory-mapped (io/mmap_store.py);
                     the JAX package's directory format
  ArrowAppender      streaming Arrow ingest (needs pyarrow)
  index.streaming.StreamingExactIndex  exact k-NN over a memory-mapped
                     row file streamed through the device in chunks (K1
                     on float32 chunks of 32768+ rows; bf16 / fp16 / int8
                     chunks through the capacity screen,
                     with an f32 host rerank); an arm of the
                     adaptive engine (attach_stream)
  parallel.sharded   Mesh / default_mesh and the sharded searches: row-
                     sharded exact (K1 a shard), capacity (the capacity
                     screen a shard), IVF, query- and
                     partition-sharded graphs; parallel.rowsharded (one
                     graph, rows over the mesh), parallel.partitioned
                     (PartitionedGraph), parallel.multihost / rpc
                     (MultiHostIndex over slices, in-process or TCP),
                     parallel.dryrun.dryrun_multichip
  save_graph/load_graph/SavedGraph  checkpoints, in the JAX package's
                     file format (io/codec.py)
  register_distance  custom metrics
  GraphConfig, ...   the configuration dataclasses

Public boundaries take and return numpy arrays; ops take torch tensors
and run on the tensors' device.
"""

__version__ = "0.1.0"

from hnsw_tpu_torch.analyzer import Analyzer, QualityMetrics
from hnsw_tpu_torch.config import (AdaptiveConfig, GraphConfig, HybridConfig,
                                   ShardingConfig, StoreConfig)
from hnsw_tpu_torch.facets import (BasicFacet, EqualityFilter, Facet,
                                   FacetedGraph, FacetFilter, FacetStore,
                                   MemoryFacetStore, RangeFilter,
                                   StringContainsFilter)
from hnsw_tpu_torch.index.adapters import MultiIndexAdapter, SearchableIndex
from hnsw_tpu_torch.index.adaptive import (AdaptiveHybridIndex,
                                           AdaptiveSelector)
from hnsw_tpu_torch.index.exact import ExactIndex
from hnsw_tpu_torch.index.hnsw import Graph
from hnsw_tpu_torch.index.hybrid import HybridIndex, IndexStats
from hnsw_tpu_torch.index.ivf import IVFIndex
from hnsw_tpu_torch.index.lsh import LSHIndex
from hnsw_tpu_torch.index.partitioner import Partitioner
from hnsw_tpu_torch.io.appender import AppenderConfig, ArrowAppender
from hnsw_tpu_torch.io.codec import (SavedGraph, export_graph, import_graph,
                                     load_graph, save_graph)
from hnsw_tpu_torch.io.disk_graph import DiskGraph
from hnsw_tpu_torch.meta import (MemoryMetadataStore, MetadataGraph,
                                 MetadataStore)
from hnsw_tpu_torch.ops.distance import register_distance
from hnsw_tpu_torch.telemetry import DistanceStats, MetricsWindow, QueryMetrics

__all__ = ["AdaptiveConfig", "AdaptiveHybridIndex", "AdaptiveSelector",
           "Analyzer", "AppenderConfig", "ArrowAppender", "BasicFacet",
           "DiskGraph", "DistanceStats", "EqualityFilter", "ExactIndex",
           "Facet", "FacetFilter", "FacetStore", "FacetedGraph", "Graph",
           "GraphConfig", "HybridConfig", "HybridIndex", "IVFIndex",
           "IndexStats", "LSHIndex", "MemoryFacetStore",
           "MemoryMetadataStore", "MetadataGraph", "MetadataStore",
           "MetricsWindow", "MultiIndexAdapter", "Partitioner",
           "QualityMetrics", "QueryMetrics", "RangeFilter", "SavedGraph",
           "SearchableIndex", "ShardingConfig", "StoreConfig",
           "StringContainsFilter", "export_graph", "import_graph",
           "load_graph", "register_distance", "save_graph", "__version__"]
