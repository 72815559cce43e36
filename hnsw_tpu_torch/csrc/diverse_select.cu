// Neighbour selection of the wave builder for NVIDIA Hopper (sm_90a):
// kernel K4.
//
// Replaces hnsw_tpu/core/build.py:_diverse_select_dev (one jitted XLA
// program on the TPU: a stable sort and dedup of each row's candidates,
// the [P, C, C] candidate Gram on the MXU, then two fori_loops of C steps,
// Malkov's diversity heuristic and the backfill). Its plain PyTorch twin is
// hnsw_tpu_torch/core/build.py:_diverse_select_reference, and this kernel
// returns what that function returns, quirks included:
//
//   1. order the row's candidates by distance, stably (equal distances
//      keep their column order; INF_DIST pads go last);
//   2. a candidate whose id appeared at an earlier sorted position becomes
//      INF in its slot; valid = distance < INF_DIST and id >= 0;
//   3. diversify == 0: the first min(C, deg) sorted ids, -1 where invalid
//      (a duplicate leaves a gap), no compaction;
//   4. the Gram over the sorted candidates at DEFAULT: each operand rounded
//      to bf16 (round to nearest even, as ops/distance.bf16_round), f32
//      sums; pair distances per metric as the twin writes them (cosine
//      1 - g rsqrt(s_j s_e + 1e-30), dot -g, sqeuclidean
//      max(s_j + s_e - 2g, 0), l2 its square root), each step rounded as
//      PyTorch's separate elementwise kernels round it;
//   5. Malkov's scan in sorted order: take a valid j while count < deg
//      unless a kept e < j has pd[j, e] < cd[j] (strict);
//   6. backfill: then valid, unkept candidates in order while count < deg;
//   7. compaction: the kept ids in sorted order into min(C, deg) columns,
//      -1 padded.
//
// The twin runs this as several hundred eager launches a call (a Python
// loop of C steps of about ten launches each); here a call is one launch,
// one block of 128 threads a row p:
//
//   A. the row's ids and distances go to shared memory; each thread ranks
//      its candidates by counting (rank_j = #{i : d_i < d_j, or d_i == d_j
//      and i < j}: exactly stable, O(C^2) compares over the block), then
//      dedups against the earlier ranks and reads the squared norms;
//   G. the Gram's lower triangle (only pd[j, e] with e < j is ever read),
//      32 x 32 tiles of candidate pairs, each thread a 2 x 4 block of f32
//      sums in registers. Per tile the rows are staged 32 columns of D at
//      a time (any D: coalesced loads of the f32, fp16 or bf16 store,
//      rounded to bf16 on the way in), read back as 16-byte vectors. Each
//      tile ends in the metric's epilogue and a conflict bit per pair
//      (pd[j, e] < cd[j]), OR-ed into a [C, ceil(C / 32)] bit matrix in
//      shared memory: the [C, C] distances are never held, 8 KB of bits
//      at C = 256;
//   S. one warp runs the C serial steps on the bits: lane w holds the kept
//      mask of candidates 32w .. 32w + 31, a step is one shared load and
//      one vote (clash = any(conflict[j] & kept)); the backfill and the
//      compaction take 32 candidates a step with ballots and popc.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s f32 FMA, 989
// TFLOP/s bf16 on the tensor cores). A layer-0 call of the smoke's build
// (P 2,048, C 96, D 128) must read P C D 4 = 100.7 MB of rows without
// reuse (30 us) and do P C (C - 1) / 2 D 2 = 2.4 GFLOP of Gram (2.4 us at
// the bf16 tensor peak; 36 us on the f32 pipes, where this kernel runs
// it). The rows come from a few thousand distinct nodes of a wave, so the
// bytes with reuse are far fewer. The kernel is bound by the f32 FMA work
// and the staging latency between its barriers; a product on the tensor
// cores (mma.sync on bf16 operands, exact for DEFAULT's rounded operands)
// is later work.
//
// Shared memory (dynamic), for W = ceil(C / 32): 2 x 32 x 36 floats of
// staged rows (9,216 B), six [C] arrays (the input ids and distances, the
// sorted ids and distances, squared norms, validity) and the [C, W] bits:
// 9,216 + 24 C + 4 C W bytes; C <= 1,024 (W <= 32, one warp's lanes), at
// most 164,864 B. The wrapper (ops/diverse_select.py) repeats the count
// and asks the library (diverse_select_smem_bytes) in its tests.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;              // candidates a side of a Gram tile
constexpr int kChunk = 32;             // columns of D staged a step
constexpr int kStride = kChunk + 4;    // floats a staged row: 16-byte
                                       // aligned, LDS.128 without conflicts
constexpr int kMaxC = 1024;
constexpr float kInf = 3.0e38f;        // INF_DIST
constexpr unsigned kFull = 0xffffffffu;

enum Metric { M_COSINE = 0, M_L2 = 1, M_SQEUCLIDEAN = 2, M_DOT = 3 };
enum Store { ST_F32 = 0, ST_F16 = 1, ST_BF16 = 2 };

struct Layout {
  int stage, din, iin, cd, ci, sq, valid, bits, total;
};

__host__ __device__ inline Layout layout(int C) {
  const int W = (C + 31) / 32;
  Layout L;
  int o = 0;
  L.stage = o; o += 2 * kTile * kStride * 4;
  L.din = o; o += 4 * C;
  L.iin = o; o += 4 * C;
  L.cd = o; o += 4 * C;
  L.ci = o; o += 4 * C;
  L.sq = o; o += 4 * C;
  L.valid = o; o += 4 * C;
  L.bits = o; o += 4 * C * W;
  L.total = o;
  return L;
}

template <int STORE>
__device__ __forceinline__ float load_value(const void* v, size_t i) {
  if constexpr (STORE == ST_F32) {
    return static_cast<const float*>(v)[i];
  } else if constexpr (STORE == ST_F16) {
    return __half2float(static_cast<const __half*>(v)[i]);
  } else {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(v)[i]);
  }
}

// ops/distance.bf16_round: f32 -> bf16 (nearest even) -> f32
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the twin's pair distance from the Gram entry g and the two squared
// norms, one rounding a step (no contraction into an FMA)
__device__ __forceinline__ float pair_dist(float g, float sj, float se,
                                           int metric) {
  if (metric == M_COSINE) {
    const float r = rsqrtf(__fadd_rn(__fmul_rn(sj, se), 1e-30f));
    return __fsub_rn(1.0f, __fmul_rn(g, r));
  }
  if (metric == M_DOT) return -g;
  const float t = fmaxf(__fsub_rn(__fadd_rn(sj, se), __fmul_rn(2.0f, g)),
                        0.0f);
  return metric == M_L2 ? __fsqrt_rn(t) : t;
}

template <int STORE>
__global__ void __launch_bounds__(kThreads, 8)
diverse_select_kernel(const int* __restrict__ cand_i,
                      const float* __restrict__ cand_d,
                      const void* __restrict__ vectors,
                      const float* __restrict__ sq_norms, int N, int C, int D,
                      int deg, int out_w, int metric, int diversify,
                      int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(C);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* din = reinterpret_cast<float*>(smem + L.din);
  int* iin = reinterpret_cast<int*>(smem + L.iin);
  float* cd = reinterpret_cast<float*>(smem + L.cd);
  int* ci = reinterpret_cast<int*>(smem + L.ci);
  float* ssq = reinterpret_cast<float*>(smem + L.sq);
  int* valid = reinterpret_cast<int*>(smem + L.valid);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L.bits);
  const int tid = threadIdx.x;
  const int W = (C + 31) >> 5;
  const size_t p = blockIdx.x;

  // A. load, rank by counting, dedup
  for (int j = tid; j < C; j += kThreads) {
    din[j] = cand_d[p * C + j];
    iin[j] = cand_i[p * C + j];
  }
  if (diversify) {
    for (int w = tid; w < C * W; w += kThreads) bits[w] = 0u;
  }
  __syncthreads();
  for (int j = tid; j < C; j += kThreads) {
    const float dj = din[j];
    int r = 0;
    for (int i = 0; i < C; ++i) {
      const float di = din[i];
      r += (di < dj) || (di == dj && i < j);
    }
    cd[r] = dj;
    ci[r] = iin[j];
  }
  __syncthreads();
  for (int j = tid; j < C; j += kThreads) {
    const int id = ci[j];
    bool dup = false;
    if (id >= 0) {
      for (int e = 0; e < j && !dup; ++e) dup = ci[e] == id;
    }
    const float d = dup ? kInf : cd[j];
    cd[j] = d;
    valid[j] = (d < kInf) && (id >= 0);
    ssq[j] = sq_norms[min(max(id, 0), N - 1)];
  }
  __syncthreads();

  if (!diversify) {
    for (int j = tid; j < out_w; j += kThreads) {
      out[p * out_w + j] = valid[j] ? ci[j] : -1;
    }
    return;
  }

  // G. the Gram's lower triangle, tile by tile, into conflict bits
  const int nb = (C + kTile - 1) / kTile;
  const int tj = tid >> 3;             // rows 2 tj, 2 tj + 1 of the tile
  const int te = tid & 7;              // columns te + 8 i, i < 4
  for (int jb = 0; jb < nb; ++jb) {
    for (int eb = 0; eb <= jb; ++eb) {
      const bool diag = jb == eb;
      const int nrows = diag ? kTile : 2 * kTile;
      const float* A = stage;
      const float* B = diag ? stage : stage + kTile * kStride;
      float acc[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.0f;
      for (int k0 = 0; k0 < D; k0 += kChunk) {
        __syncthreads();                 // the last chunk is consumed
        for (int x = tid; x < nrows * kChunk; x += kThreads) {
          const int r = x / kChunk, c = x % kChunk;
          const int cand = (r < kTile ? jb : eb) * kTile + (r % kTile);
          const int k = k0 + c;
          float v = 0.0f;
          if (cand < C && k < D) {
            const int id = min(max(ci[cand], 0), N - 1);
            v = bf16r(load_value<STORE>(vectors, (size_t)id * D + k));
          }
          stage[r * kStride + c] = v;
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < kChunk; c += 4) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(&A[(2 * tj) * kStride + c]);
          const float4 a1 =
              *reinterpret_cast<const float4*>(&A[(2 * tj + 1) * kStride + c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 b = *reinterpret_cast<const float4*>(
                &B[(te + 8 * i) * kStride + c]);
            acc[0][i] = fmaf(a0.x, b.x, acc[0][i]);
            acc[0][i] = fmaf(a0.y, b.y, acc[0][i]);
            acc[0][i] = fmaf(a0.z, b.z, acc[0][i]);
            acc[0][i] = fmaf(a0.w, b.w, acc[0][i]);
            acc[1][i] = fmaf(a1.x, b.x, acc[1][i]);
            acc[1][i] = fmaf(a1.y, b.y, acc[1][i]);
            acc[1][i] = fmaf(a1.z, b.z, acc[1][i]);
            acc[1][i] = fmaf(a1.w, b.w, acc[1][i]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = jb * kTile + 2 * tj + r;
        if (j >= C) continue;
        uint32_t m = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = eb * kTile + te + 8 * i;
          if (e < j && pair_dist(acc[r][i], ssq[j], ssq[e], metric) < cd[j]) {
            m |= 1u << (te + 8 * i);
          }
        }
        if (m) atomicOr(&bits[j * W + eb], m);
      }
    }
  }
  __syncthreads();

  // S. Malkov's scan, the backfill and the compaction: one warp
  if (tid >= 32) return;
  const int lane = tid;
  uint32_t kept = 0u;                    // lane w: candidates 32w .. 32w+31
  int count = 0;
  for (int j = 0; j < C && count < deg; ++j) {
    if (!valid[j]) continue;
    const uint32_t clash = lane < W ? (bits[j * W + lane] & kept) : 0u;
    if (__any_sync(kFull, clash != 0u)) continue;
    if (lane == (j >> 5)) kept |= 1u << (j & 31);
    ++count;
  }
  const uint32_t below = (1u << lane) - 1u;
  for (int b = 0; b < W && count < deg; ++b) {
    const int j = b * 32 + lane;
    const uint32_t kb = __shfl_sync(kFull, kept, b);
    const bool cand = j < C && valid[j] && !((kb >> lane) & 1u);
    const uint32_t m = __ballot_sync(kFull, cand);
    const bool take = cand && count + __popc(m & below) < deg;
    const uint32_t t = __ballot_sync(kFull, take);
    if (lane == b) kept |= t;
    count += __popc(t);
  }
  int* o = out + p * out_w;
  int pos = 0;
  for (int b = 0; b < W; ++b) {
    const uint32_t kb = __shfl_sync(kFull, kept, b);
    if ((kb >> lane) & 1u) {
      const int at = pos + __popc(kb & below);
      if (at < out_w) o[at] = ci[b * 32 + lane];
    }
    pos += __popc(kb);
  }
  for (int at = pos + lane; at < out_w; at += 32) o[at] = -1;
}

// the kernel of each row store, by its code (ST_*)
using Kernel = decltype(&diverse_select_kernel<ST_F32>);
const Kernel kKernels[] = {diverse_select_kernel<ST_F32>,
                           diverse_select_kernel<ST_F16>,
                           diverse_select_kernel<ST_BF16>};

// the store's kernel, allowed the dynamic shared memory of C candidates
// a row; nullptr for an unknown store
Kernel prepared(int C, int store, cudaError_t* err) {
  if (store < ST_F32 || store > ST_BF16) {
    *err = cudaErrorInvalidValue;
    return nullptr;
  }
  *err = cudaFuncSetAttribute(kKernels[store],
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              layout(C).total);
  return *err == cudaSuccess ? kKernels[store] : nullptr;
}

}  // namespace

extern "C" {

// dynamic shared memory of one block at C candidates a row
int diverse_select_smem_bytes(int C) { return layout(C).total; }

// resident blocks an SM at C candidates a row, for the store's kernel (0
// f32, 1 fp16, 2 bf16); -1 on an error
int diverse_select_blocks_per_sm(int C, int store) {
  cudaError_t err;
  const Kernel k = prepared(C, store, &err);
  int n = 0;
  if (k != nullptr) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads,
                                                        layout(C).total);
  }
  return err == cudaSuccess ? n : -1;
}

// One launch: rows [P, out_w] int32 of `out` from cand_i [P, C] int32 and
// cand_d [P, C] f32 (row-major, contiguous), the [N, D] row store (f32,
// fp16 or bf16 by `store`) and its squared norms (at least N, f32).
// Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for arguments the kernel does not take.
int diverse_select_launch(const int* cand_i, const float* cand_d,
                          const void* vectors, const float* sq_norms, int P,
                          int C, int N, int D, int deg, int out_w, int metric,
                          int store, int diversify, int* out, void* stream) {
  if (P < 0 || C < 1 || C > kMaxC || N < 1 || D < 0 || deg < 1 ||
      out_w != (C < deg ? C : deg) || metric < 0 || metric > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0) return 0;
  cudaError_t err;
  const Kernel k = prepared(C, store, &err);
  if (k == nullptr) return static_cast<int>(err);
  k<<<P, kThreads, layout(C).total, static_cast<cudaStream_t>(stream)>>>(
      cand_i, cand_d, vectors, sq_norms, N, C, D, deg, out_w, metric,
      diversify, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
