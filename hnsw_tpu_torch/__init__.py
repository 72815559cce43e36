"""hnsw_tpu_torch — the hnsw_tpu vector index served with PyTorch and CUDA.

A port of ``hnsw_tpu`` (JAX, TPU) to PyTorch on NVIDIA GPUs, with the
same module layout and public names. It imports neither JAX nor the JAX
package. Ported so far: the serving path of both index types.

  Graph              HNSW index: native C++ host build, batched beam
                     search on the device (core/search.py)
  ExactIndex         brute-force k-NN; on CUDA at 32768+ rows it runs the
                     hand-written screen kernel (csrc/exact_screen.cu)
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
