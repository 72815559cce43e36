// Fused exact k-NN screen for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel hnsw_tpu/ops/pallas_exact.py:pallas_exact_screen.
// For every query it finds the k_sel smallest (distance, column id) pairs
// over an [N, D] f32 table under one of the builtin metrics, with the
// validity mask applied, and never writes the [Q, N] score matrix to
// device memory.
//
// What bounds it on this card: 2*Q*N*D flops of f32 FMA (no tensor cores
// in this version; 67 TFLOP/s peak on an H100 SXM) against one read of the
// table per query tile. A 64-query tile does 64 FMAs for every 4-byte table
// element it loads, well above the card's ~20 flop/byte balance point, and
// the table tiles of neighbouring query tiles meet in L2, so the FMA pipe
// and the shared-memory loads that feed it are the limit, not HBM.
//
// What the design does about it:
//   * a register tile of 4 queries x 8 columns per thread, fed from
//     shared-memory stages of 32 dimensions, so each shared load feeds
//     several FMAs;
//   * grid = (query tiles, N segments); a loop inside the block walks the
//     segment's column tiles (the TPU's sequential grid axis), and N is cut
//     into enough segments that a 1024-query batch still fills every SM;
//   * selection keeps each query's running best k_sel in shared memory as
//     int64 keys (order-preserving int32 of the distance in the high half,
//     global column id in the low half). A candidate costs one compare
//     against the current worst key; only winners take the warp-wide
//     sorted insert. Keys are unique, so ties go to the lower id;
//   * a second small kernel merges each query's per-segment lists.
// Tensor cores (bf16 wgmma, 3xTF32) with TMA-fed stages are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int TQ = 64;       // queries per block
constexpr int TC = 128;      // table columns per tile
constexpr int DK = 32;       // dimensions per shared-memory stage
constexpr int NT = 256;      // threads per block, as a 16 x 16 grid
constexpr int RQ = TQ / 16;  // query rows per thread
constexpr int RC = TC / 16;  // columns per thread
constexpr int QS = TQ + 1;   // padded strides: transposed stores hit
constexpr int CS = TC + 1;   // distinct banks
constexpr int MERGE_THREADS = 256;
constexpr float INF_DIST = 3.0e38f;  // ops/distance.py INF_DIST
constexpr long long EMPTY = LLONG_MAX;

enum Metric { COSINE = 0, L2 = 1, SQEUCLIDEAN = 2, DOT = 3 };

// fast_math rounds both Gram operands to bf16; products and sums stay f32,
// which is bf16 x bf16 with f32 output.
__device__ __forceinline__ float stage_value(float x, int fast) {
  return fast ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Order-preserving f32 -> int32 (pallas_exact.py:_mono_int32) in the high
// half, the global column id in the low half.
__device__ __forceinline__ long long pack_key(float d, int col) {
  int u = __float_as_int(d);
  int m = u >= 0 ? u : INT_MIN - u;
  return (long long)(((unsigned long long)(unsigned)m << 32) |
                     (unsigned)col);
}

// Insert c into the ascending list L[0, k) in shared memory, dropping the
// last entry; c < L[k - 1] on entry. Called by a whole warp (k <= 128).
__device__ __forceinline__ void warp_insert(long long* L, int k, long long c,
                                            int lane) {
  long long prev[4];
  int pos = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    int e = lane + 32 * s;
    long long cur = e < k ? L[e] : EMPTY;
    prev[s] = (e < k && e > 0) ? L[e - 1] : EMPTY;
    pos += __popc(__ballot_sync(0xffffffffu, e < k && cur < c));
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    int e = lane + 32 * s;
    if (e < k && e >= pos) L[e] = e == pos ? c : prev[s];
  }
  __syncwarp();
}

// partial[q, seg, :] = ascending k_sel smallest keys of query q over
// columns [seg * seg_len, min(n, (seg + 1) * seg_len)); EMPTY pads.
__global__ void __launch_bounds__(NT)
    screen_kernel(const float* __restrict__ queries,
                  const float* __restrict__ vectors,
                  const float* __restrict__ v_sq,
                  const unsigned char* __restrict__ valid, int nq, int n,
                  int d, int k_sel, int seg_len, int metric, int fast,
                  long long* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* lists = reinterpret_cast<long long*>(smem);      // [TQ][k_sel]
  float* qs = reinterpret_cast<float*>(lists + TQ * k_sel);    // [DK][QS]
  float* vs = qs + DK * QS;                                    // [DK][CS]
  float* dt = vs + DK * CS;                                    // [TQ][CS]
  float* qsq = dt + TQ * CS;                                   // [TQ]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * TQ;
  const int seg = blockIdx.y, n_seg = gridDim.y;
  const int c_begin = seg * seg_len;
  const int c_end = min(n, c_begin + seg_len);

  for (int i = tid; i < TQ * k_sel; i += NT) lists[i] = EMPTY;
  if (tid < TQ) {  // squared query norms in f32, before any bf16 rounding
    float s = 0.f;
    if (q0 + tid < nq) {
      const float* row = queries + (size_t)(q0 + tid) * d;
      for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
    }
    qsq[tid] = s;
  }
  __syncthreads();

  for (int c0 = c_begin; c0 < c_end; c0 += TC) {
    float acc[RQ][RC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += DK) {
      // stage [TQ x DK] queries and [TC x DK] table rows, transposed;
      // consecutive threads read consecutive dimensions of one row
#pragma unroll
      for (int r = 0; r < TQ * DK / NT; ++r) {
        int idx = tid + r * NT, row = idx / DK, kk = idx % DK;
        int gq = q0 + row, gd = d0 + kk;
        float x = (gq < nq && gd < d) ? queries[(size_t)gq * d + gd] : 0.f;
        qs[kk * QS + row] = stage_value(x, fast);
      }
#pragma unroll
      for (int r = 0; r < TC * DK / NT; ++r) {
        int idx = tid + r * NT, row = idx / DK, kk = idx % DK;
        int gc = c0 + row, gd = d0 + kk;
        float x = (gc < c_end && gd < d) ? vectors[(size_t)gc * d + gd] : 0.f;
        vs[kk * CS + row] = stage_value(x, fast);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        float a[RQ], b[RC];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = qs[kk * QS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RC; ++j) b[j] = vs[kk * CS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // metric epilogue (ops/distance.py _epilogue) + validity mask; rows
    // past the segment end (the ragged edge of N included) are masked too
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      int cc = tx + 16 * j, gc = c0 + cc;
      bool ok = gc < c_end && valid[gc];
      float vq = ok ? v_sq[gc] : 0.f;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        int row = ty + 16 * i;
        float g = acc[i][j], dist;
        if (metric == DOT) {
          dist = -g;
        } else if (metric == COSINE) {
          dist = 1.f - g * rsqrtf(qsq[row] * vq + 1e-30f);
        } else {
          dist = fmaxf(qsq[row] + vq - 2.f * g, 0.f);
          if (metric == L2) dist = sqrtf(dist);
        }
        dt[row * CS + cc] = ok ? dist : INF_DIST;
      }
    }
    __syncthreads();

    // selection: one warp per query row, a candidate is inserted only if
    // it beats the row's current worst key
    for (int row = warp; row < TQ; row += NT / 32) {
      long long* L = lists + row * k_sel;
      long long worst = L[k_sel - 1];
#pragma unroll
      for (int r = 0; r < TC / 32; ++r) {
        int cc = lane + 32 * r;
        float dist = dt[row * CS + cc];
        long long mine = dist < INF_DIST ? pack_key(dist, c0 + cc) : EMPTY;
        unsigned b = __ballot_sync(0xffffffffu, mine < worst);
        while (b) {
          int src = __ffs(b) - 1;
          long long c = __shfl_sync(0xffffffffu, mine, src);
          warp_insert(L, k_sel, c, lane);
          worst = L[k_sel - 1];
          if (lane == src) mine = EMPTY;
          b = __ballot_sync(0xffffffffu, mine < worst);
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < TQ * k_sel; i += NT) {
    int row = i / k_sel, e = i % k_sel;
    if (q0 + row < nq)
      partial[((size_t)(q0 + row) * n_seg + seg) * k_sel + e] = lists[i];
  }
}

// out[q, :] = ascending k_sel smallest of query q's n_seg * k_sel keys:
// one block per query, bitonic sort of the padded list in shared memory.
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const long long* __restrict__ partial, int width, int p2,
                 int k_sel, long long* __restrict__ out) {
  extern __shared__ long long buf[];
  const size_t q = blockIdx.x;
  const long long* src = partial + q * width;
  for (int i = threadIdx.x; i < p2; i += MERGE_THREADS)
    buf[i] = i < width ? src[i] : EMPTY;
  __syncthreads();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p2; i += MERGE_THREADS) {
        int j = i ^ stride;
        if (j > i) {
          bool ascending = (i & size) == 0;
          long long a = buf[i], b = buf[j];
          if ((a > b) == ascending) {
            buf[i] = b;
            buf[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < k_sel; i += MERGE_THREADS)
    out[q * k_sel + i] = buf[i];
}

size_t screen_smem_bytes(int k_sel) {
  return (size_t)TQ * k_sel * sizeof(long long) +
         (size_t)(DK * QS + DK * CS + TQ * CS + TQ) * sizeof(float);
}

}  // namespace

extern "C" {

// Tile sizes, so the Python wrapper can plan segments without copying them.
int exact_screen_tile_queries() { return TQ; }
int exact_screen_tile_columns() { return TC; }

// Resident screen blocks per SM for this k_sel; negative cudaError_t on
// failure.
int exact_screen_blocks_per_sm(int k_sel) {
  size_t smem = screen_smem_bytes(k_sel);
  cudaError_t e = cudaFuncSetAttribute(
      screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, screen_kernel,
                                                    NT, smem);
  return e != cudaSuccess ? -(int)e : blocks;
}

// Screen + merge on `stream`. partial: [nq, n_seg, k_sel] int64 scratch;
// out: [nq, k_sel] int64 keys. Returns the cudaError_t of the launches.
int exact_screen_launch(const void* queries, const void* vectors,
                        const void* v_sq, const void* valid, int nq, int n,
                        int d, int k_sel, int n_seg, int seg_len, int metric,
                        int fast, void* partial, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t smem = screen_smem_bytes(k_sel);
  cudaError_t e = cudaFuncSetAttribute(
      screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((nq + TQ - 1) / TQ, n_seg);
  screen_kernel<<<grid, NT, smem, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(vectors),
      static_cast<const float*>(v_sq),
      static_cast<const unsigned char*>(valid), nq, n, d, k_sel, seg_len,
      metric, fast, static_cast<long long*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int width = n_seg * k_sel, p2 = 1;
  while (p2 < width) p2 <<= 1;
  merge_kernel<<<nq, MERGE_THREADS, p2 * sizeof(long long), st>>>(
      static_cast<const long long*>(partial), width, p2, k_sel,
      static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
