"""The benchmark of ``hnsw_tpu_torch`` on one NVIDIA H100: ``portbench.run``
runs one cell of ``BENCHMARK.json``. It imports neither JAX nor the JAX
package ``hnsw_tpu``."""
