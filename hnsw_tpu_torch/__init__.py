"""hnsw_tpu_torch — the hnsw_tpu vector index served with PyTorch and CUDA.

A port of ``hnsw_tpu`` (JAX, TPU) to PyTorch on NVIDIA GPUs, with the
same module layout and public names. It imports neither JAX nor the JAX
package. Ported so far: the serving path of both index types, with their
serving and capacity modes.

  Graph              HNSW index: native C++ host build, batched beam
                     search on the device (core/search.py) in every
                     serving layout (fp16/bf16/int8 stores, neighbor
                     blocks, pivot entry, compact upper layers)
  ExactIndex         brute-force k-NN; on CUDA at 32768+ rows the float32
                     table runs the hand-written screen kernel
                     (csrc/exact_screen.cu); int8/bf16/fp16 capacity
                     tables scan with plain torch and rerank on the host
  register_distance  custom metrics
  GraphConfig, ...   the configuration dataclasses

Public boundaries take and return numpy arrays; ops take torch tensors
and run on the tensors' device.
"""

__version__ = "0.1.0"

from hnsw_tpu_torch.config import (AdaptiveConfig, GraphConfig, HybridConfig,
                                   ShardingConfig, StoreConfig)
from hnsw_tpu_torch.index.exact import ExactIndex
from hnsw_tpu_torch.index.hnsw import Graph
from hnsw_tpu_torch.ops.distance import register_distance

__all__ = ["AdaptiveConfig", "ExactIndex", "Graph", "GraphConfig",
           "HybridConfig", "ShardingConfig", "StoreConfig",
           "register_distance", "__version__"]
