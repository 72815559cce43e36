// Beam search of one HNSW layer for NVIDIA Hopper (sm_90a): kernel K2.
//
// Replaces the hop loop of hnsw_tpu/core/search.py:beam_search_layer (the
// jax.lax.while_loop around the hop body: select, gather, score, merge),
// which XLA fuses on the TPU without a Pallas kernel. Its plain PyTorch
// twin is hnsw_tpu_torch/core/search.py:beam_search_layer_reference, and
// this kernel returns what that function returns: the pool's distances
// and ids [B, P], ascending, empty slots (INF_DIST, -1), and each query's
// hop count.
//
// Design. Within a layer a query's search depends on nothing but its own
// pool: a query whose best unexpanded entry is no better than its worst
// entry merges only INF candidates from then on, and its pool stays as it
// is. So one block (128 threads) owns one query for the whole layer and
// loops over its hops until nothing is taken or it reaches max_hops; the
// batch's lockstep hop count is the largest per-query count. No barrier
// spans blocks and nothing returns to the host between hops. Shared
// memory holds the query row, the pool [P] (distance and id, with the
// "expanded" flag in bit 30 of the id, as the twin carries it), the
// candidate block [E*M] and a merge buffer. Each hop repeats the twin's
// steps in its order, with its tie rules:
//
//   1. select: the first E unexpanded entries in pool order (the pool is
//      sorted, so these are the E best, ties to the lower position);
//      take = distance < the pool's last (= largest) distance;
//   2. mark them expanded;
//   3. gather their E*M neighbour ids (through upper_map for a compact
//      upper table);
//   4. mask ids < 0, slots of entries not taken, and ids already in the
//      pool (a C x P compare in shared memory); under the bitonic merge,
//      also later copies of an id seen earlier in the same block;
//   5. score the survivors, one warp per candidate and U = 4 candidates a
//      warp at once (their loads in flight together): coalesced vector
//      loads of the row (f32 rows, or one row of the expanded node's int8
//      or fp16 neighbour block), a shuffle reduction, the metric's
//      epilogue (ops/distance.gathered_epilogue, rounding step by step as
//      PyTorch's separate elementwise kernels do);
//   6. merge. "bitonic": the candidates ranked by (distance, slot),
//      reversed behind the pool and an INF pad to W2 = the next power of
//      two >= P + E*M, then the twin's compare-exchange network (swap iff
//      a > b), keeping the first P. "sort": a stable merge of the sorted
//      pool with the ranked candidates (merge path: each element's output
//      position from a binary search in the other list), keeping P, then
//      the twin's adjacent-duplicate mask. The twin leaves those holes
//      (INF, -1) in place; here they move behind the finite entries, in
//      order. Both are the same pool to every later step (the next stable
//      sort sees the same order of finite entries and of INF entries), and
//      the twin's final stable sort makes the outputs equal.
//
// Precision, as the twin's _score_hop / _score_blocks: f32 rows at HIGHEST
// multiply in f32; at DEFAULT both operands are rounded to bf16 first;
// int8 blocks take a bf16-rounded query against the exact upcast, times
// block_scale, with squared norms that are bf16-rounded sums of
// bf16-rounded squares times block_scale^2; fp16 blocks score in f32; a
// store_normalized cosine store has squared norm 1. The f32 sums run in
// another order than the twin's einsum.
//
// What bounds it on this card (H100 SXM, 3.35 TB/s). Per query and hop it
// must read the E expanded nodes' neighbour ids (E*M*4 bytes) and the
// rows of the candidates it scores (512 bytes each for f32 at D = 128,
// 128 for an int8 block row): a few KB. Over a batch of 1,024 queries at
// ef 64 that is tens of MB, a bound of tens of microseconds. What the
// kernel spends instead is latency: every hop is a chain of dependent
// steps (ids, then rows, then the merge) with about twenty block
// barriers, so a block is idle while its loads are in flight. The design
// answers that with many resident blocks an SM (128 threads and a few KB
// of shared memory each: up to 16) so that one block's merge overlaps
// another's loads, and with U candidates in flight a warp.
//
// Shared memory (dynamic) for C = E*M, WB = W2 under the bitonic merge and
// P under the sort merge, in 4-byte words: D (padded to 4) + 2P (pool) +
// 2WB (merge buffer) + 6C (candidate ids, the scored list, the sorted
// list) + 2E + NW. The wrapper (ops/beam_search.py) takes P + C <= 4,096
// and at most 227 KB; ef 512 at E = 4, M = 32 needs 15.9 KB at D = 128.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;            // threads a block
constexpr int NW = NT / 32;        // warps a block
constexpr int U = 4;               // candidates a warp scores at once
constexpr unsigned FULL = 0xffffffffu;
constexpr float INF_DIST = 3.0e38f;
constexpr int EXP_BIT = 1 << 30;
constexpr float EPS = 1e-30f;

enum { M_COSINE = 0, M_L2 = 1, M_SQEUCLIDEAN = 2, M_DOT = 3 };
// scoring modes: f32 rows at HIGHEST, f32 rows at DEFAULT (bf16 operands),
// int8 neighbour blocks, fp16 neighbour blocks
enum { S_F32 = 0, S_BF16 = 1, S_I8 = 2, S_F16 = 3 };

struct Params {
  const float* queries;    // [B, D]
  const float* q_sq;       // [B]
  const int* start_ids;    // [B, s_in]
  const float* start_d;    // [B, s_in]
  int s_in;
  const int* table;        // the layer's neighbour rows [n_rows, width]
  int width;
  const int* upper_map;    // [cap] slot -> row of a compact table, or null
  int n_rows;
  const float* vectors;    // [cap, D] f32 (rows)
  const float* sq_norms;   // [cap] (rows)
  const void* blocks;      // [cap, block_m, D] int8 / fp16 (blocks)
  int block_m;
  const float* block_scale;  // [] (int8 blocks)
  int D, P, E, M, max_hops, metric, merge_sort, normalized, W2;
  float* out_d;            // [B, P]
  int* out_i;              // [B, P]
  int* hops;               // [B]
  int* work;               // [B, 2]: nodes expanded, candidates scored
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// id without the expanded flag (-1 stays -1)
__device__ __forceinline__ int unpack(int p) {
  return p >= 0 ? (p & (EXP_BIT - 1)) : p;
}

// ops/distance.gathered_epilogue, one PyTorch elementwise step at a time
// (no fused multiply-add across steps).
__device__ __forceinline__ float epilogue(int metric, float qv, float qsq,
                                          float vsq) {
  if (metric == M_DOT) return -qv;
  if (metric == M_COSINE)
    return __fsub_rn(1.0f, __fmul_rn(qv, rsqrtf(__fadd_rn(__fmul_rn(qsq, vsq),
                                                          EPS))));
  float d = fmaxf(__fsub_rn(__fadd_rn(qsq, vsq), __fmul_rn(2.0f, qv)), 0.0f);
  return metric == M_L2 ? __fsqrt_rn(d) : d;
}

// Exclusive prefix sum of v over the block's threads in thread order;
// *total gets the sum. Every thread calls it; scratch holds NW ints.
__device__ __forceinline__ int block_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    int s = scratch[w];
    off += w < warp ? s : 0;
    tot += s;
  }
  __syncthreads();
  *total = tot;
  return off + x - v;
}

// The n entries of (sd, si) into (dd, di): finite distances first, then
// the INF ones, each group in its order (a stable sort of an array whose
// finite entries are ascending). Ends with a barrier.
__device__ __forceinline__ void compact(const float* sd, const int* si,
                                        float* dd, int* di, int n,
                                        int* scratch) {
  const int per = (n + NT - 1) / NT;
  const int lo = min((int)threadIdx.x * per, n), hi = min(lo + per, n);
  int cnt = 0;
  for (int p = lo; p < hi; ++p) cnt += sd[p] < INF_DIST;
  int tot;
  int fin = block_scan(cnt, scratch, &tot);
  int inf = tot + (lo - fin);
  for (int p = lo; p < hi; ++p) {
    float d = sd[p];
    int i = si[p];
    if (d < INF_DIST) {
      dd[fin] = d;
      di[fin++] = i;
    } else {
      dd[inf] = d;
      di[inf++] = i;
    }
  }
  __syncthreads();
}

// entries of the ascending a[0, n) below x / at most x
__device__ __forceinline__ int lower_bound(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int upper_bound(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One element of a row as the scoring mode reads it (f32 after the mode's
// rounding), and its square's contribution to the block squared norm.
template <int SCORE>
__device__ __forceinline__ float elem(const Params& a, size_t i) {
  if (SCORE == S_F32) return __ldg(a.vectors + i);
  if (SCORE == S_BF16) return bf16r(__ldg(a.vectors + i));
  if (SCORE == S_I8)
    return (float)__ldg(static_cast<const signed char*>(a.blocks) + i);
  return __half2float(__ldg(static_cast<const __half*>(a.blocks) + i));
}

// Four consecutive elements (i a multiple of 4, rows aligned: VEC).
template <int SCORE>
__device__ __forceinline__ void elem4(const Params& a, size_t i, float* x) {
  if (SCORE == S_F32 || SCORE == S_BF16) {
    float4 v = __ldg(reinterpret_cast<const float4*>(a.vectors + i));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    if (SCORE == S_BF16) {
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = bf16r(x[t]);
    }
  } else if (SCORE == S_I8) {
    char4 v = __ldg(reinterpret_cast<const char4*>(
        static_cast<const signed char*>(a.blocks) + i));
    x[0] = (float)v.x; x[1] = (float)v.y; x[2] = (float)v.z;
    x[3] = (float)v.w;
  } else {
    uint2 v = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __half*>(a.blocks) + i));
    float2 lo = __half22float2(*reinterpret_cast<__half2*>(&v.x));
    float2 hi = __half22float2(*reinterpret_cast<__half2*>(&v.y));
    x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
  }
}

template <int SCORE>
__device__ __forceinline__ float sq_term(float x) {
  return SCORE == S_I8 ? bf16r(x * x) : __fmul_rn(x, x);
}

// Distances of the n_ok listed candidates: warp w takes list entries
// w*U .. w*U+U-1, then NW*U further, and so on.
template <int SCORE, bool VEC>
__device__ __forceinline__ void score_list(
    const Params& a, const float* qop, float qsq, float scale,
    const int* sel_cur, const int* cand_id, const int* ok_slot, float* ok_d,
    int n_ok) {
  constexpr bool BLOCKS = SCORE == S_I8 || SCORE == S_F16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = a.D, M = a.M;
  for (int base = warp * U; base < n_ok; base += NW * U) {
    size_t off[U];
    bool v[U];
    float vsq_row = 0.0f;   // lane u < U: the squared norm of row u
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = base + u;
      v[u] = k < n_ok;
      const int slot = v[u] ? ok_slot[k] : 0;
      if (BLOCKS) {
        const int e = slot / M, m = slot - e * M;
        off[u] = ((size_t)sel_cur[e] * a.block_m + m) * D;
      } else {
        const int id = v[u] ? cand_id[slot] : 0;
        off[u] = (size_t)id * D;
        if (lane == u && v[u]) vsq_row = __ldg(a.sq_norms + id);
      }
    }
    float acc[U], ssq[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = ssq[u] = 0.0f;
    if (VEC) {
      for (int k = lane * 4; k < D; k += 128) {
        const float4 q4 = *reinterpret_cast<const float4*>(qop + k);
        float x[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (v[u]) {
            elem4<SCORE>(a, off[u] + k, x[u]);
          } else {
            x[u][0] = x[u][1] = x[u][2] = x[u][3] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc[u] = fmaf(q4.x, x[u][0], acc[u]);
          acc[u] = fmaf(q4.y, x[u][1], acc[u]);
          acc[u] = fmaf(q4.z, x[u][2], acc[u]);
          acc[u] = fmaf(q4.w, x[u][3], acc[u]);
          if (BLOCKS) {
#pragma unroll
            for (int t = 0; t < 4; ++t) ssq[u] += sq_term<SCORE>(x[u][t]);
          }
        }
      }
    } else {
      for (int k = lane; k < D; k += 32) {
        const float qk = qop[k];
        float x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) x[u] = v[u] ? elem<SCORE>(a, off[u] + k)
                                                : 0.0f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc[u] = fmaf(qk, x[u], acc[u]);
          if (BLOCKS) ssq[u] += sq_term<SCORE>(x[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) {
        acc[u] += __shfl_xor_sync(FULL, acc[u], o);
        if (BLOCKS) ssq[u] += __shfl_xor_sync(FULL, ssq[u], o);
      }
    }
    bool mine = false;
    float qv = 0.0f, s = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (lane == u) {
        mine = v[u];
        qv = acc[u];
        s = ssq[u];
      }
    }
    if (mine) {
      float vsq;
      if (SCORE == S_I8) {
        qv = __fmul_rn(qv, scale);
        vsq = (a.normalized && a.metric == M_COSINE)
                  ? 1.0f : __fmul_rn(bf16r(s), __fmul_rn(scale, scale));
      } else if (SCORE == S_F16) {
        vsq = (a.normalized && a.metric == M_COSINE) ? 1.0f : s;
      } else {
        vsq = vsq_row;
      }
      ok_d[base + lane] = epilogue(a.metric, qv, qsq, vsq);
    }
  }
}

template <int SCORE, bool VEC>
__global__ void __launch_bounds__(NT) beam_search_kernel(Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int D = a.D, P = a.P, E = a.E, M = a.M, C = E * M, W2 = a.W2;
  const int WB = a.merge_sort ? P : W2;
  float* qop = reinterpret_cast<float*>(smem);        // D (padded to 4)
  float* pool_d = qop + ((D + 3) & ~3);               // P
  int* pool_i = reinterpret_cast<int*>(pool_d + P);   // P
  float* buf_d = reinterpret_cast<float*>(pool_i + P);  // WB
  int* buf_i = reinterpret_cast<int*>(buf_d + WB);    // WB
  int* cand_id = buf_i + WB;                          // C
  int* ok_slot = cand_id + C;                         // C
  float* ok_d = reinterpret_cast<float*>(ok_slot + C);  // C
  float* so_d = ok_d + C;                             // C
  int* so_i = reinterpret_cast<int*>(so_d + C);       // C
  int* so_r = so_i + C;                               // C
  int* sel_j = so_r + C;                              // E
  int* sel_cur = sel_j + E;                           // E
  int* scratch = sel_cur + E;                         // NW

  // the query row as the scoring mode multiplies it
  const float* q = a.queries + (size_t)b * D;
  for (int k = tid; k < D; k += NT) {
    const float x = q[k];
    qop[k] = (SCORE == S_BF16 || SCORE == S_I8) ? bf16r(x) : x;
  }
  const float qsq = a.q_sq[b];
  const float scale = SCORE == S_I8 ? *a.block_scale : 1.0f;

  // pool init: the start entries lead; more than one are sorted stably by
  // distance and adjacent duplicate ids masked, as the twin does
  const int S = min(a.s_in, P);
  const int* sid = a.start_ids + (size_t)b * a.s_in;
  const float* sdist = a.start_d + (size_t)b * a.s_in;
  for (int p = tid; p < P; p += NT) {
    pool_d[p] = p < S ? sdist[p] : INF_DIST;
    pool_i[p] = p < S ? sid[p] : -1;
  }
  __syncthreads();
  if (S > 1) {
    for (int s = tid; s < S; s += NT) {
      const float d = pool_d[s];
      int r = 0;
      for (int t = 0; t < S; ++t) {
        const float e = pool_d[t];
        r += (e < d) || (e == d && t < s);
      }
      buf_d[r] = d;
      buf_i[r] = pool_i[s];
    }
    for (int p = S + tid; p < P; p += NT) {
      buf_d[p] = INF_DIST;
      buf_i[p] = -1;
    }
    __syncthreads();
    for (int p = tid; p < P; p += NT)
      pool_i[p] = p > 0 && buf_i[p] >= 0 && buf_i[p] == buf_i[p - 1];
    __syncthreads();
    for (int p = tid; p < P; p += NT) {
      if (pool_i[p]) {
        buf_d[p] = INF_DIST;
        buf_i[p] = -1;
      }
    }
    __syncthreads();
    compact(buf_d, buf_i, pool_d, pool_i, P, scratch);
  }

  int hops = 0, n_exp = 0, n_scored = 0;
  const int per_p = (P + NT - 1) / NT;
  const int p_lo = min(tid * per_p, P), p_hi = min(p_lo + per_p, P);
  while (hops < a.max_hops) {
    // 1. select: the first E unexpanded finite entries in pool order
    const float worst = pool_d[P - 1];
    int cnt = 0;
    for (int p = p_lo; p < p_hi; ++p) {
      const int pi = pool_i[p];
      cnt += pi >= 0 && pi < EXP_BIT && pool_d[p] < INF_DIST;
    }
    int n_elig;
    int ord = block_scan(cnt, scratch, &n_elig);
    for (int p = p_lo; p < p_hi && ord < E; ++p) {
      const int pi = pool_i[p];
      if (pi >= 0 && pi < EXP_BIT && pool_d[p] < INF_DIST) sel_j[ord++] = p;
    }
    __syncthreads();
    const int n_sel = min(n_elig, E);
    int n_take = 0;   // the pool is ascending: the taken entries lead
    for (int e = 0; e < n_sel; ++e) n_take += pool_d[sel_j[e]] < worst;
    if (n_take == 0) break;
    // 2. mark
    for (int e = tid; e < n_take; e += NT) {
      const int p = sel_j[e];
      sel_cur[e] = pool_i[p];
      pool_i[p] |= EXP_BIT;
    }
    __syncthreads();
    // 3-4. gather ids, mask invalid and in-pool ids
    const int Ct = n_take * M;
    for (int c = tid; c < C; c += NT) {
      int id = -1;
      if (c < Ct) {
        const int e = c / M, m = c - e * M;
        int row = sel_cur[e];
        if (a.upper_map != nullptr) {
          const int u = __ldg(a.upper_map + row);
          row = u < 0 ? -1 : min(u, a.n_rows - 1);
        }
        if (row >= 0) id = __ldg(a.table + (size_t)row * a.width + m);
        if (id >= 0) {
          for (int p = 0; p < P; ++p) {
            if ((pool_i[p] & ~EXP_BIT) == id) {
              id = -1;
              break;
            }
          }
        }
      }
      cand_id[c] = id;
    }
    __syncthreads();
    if (!a.merge_sort) {
      // same-hop duplicates: keep the first copy
      for (int c = tid; c < Ct; c += NT) {
        const int id = cand_id[c];
        int dup = 0;
        if (id >= 0) {
          for (int t = 0; t < c; ++t) {
            if (cand_id[t] == id) {
              dup = 1;
              break;
            }
          }
        }
        so_r[c] = dup;
      }
      __syncthreads();
      for (int c = tid; c < Ct; c += NT)
        if (so_r[c]) cand_id[c] = -1;
      __syncthreads();
    }
    // the list of candidates to score, in slot order
    const int per_c = (Ct + NT - 1) / NT;
    const int c_lo = min(tid * per_c, Ct), c_hi = min(c_lo + per_c, Ct);
    cnt = 0;
    for (int c = c_lo; c < c_hi; ++c) cnt += cand_id[c] >= 0;
    int n_ok;
    int k = block_scan(cnt, scratch, &n_ok);
    for (int c = c_lo; c < c_hi; ++c)
      if (cand_id[c] >= 0) ok_slot[k++] = c;
    __syncthreads();
    // 5. score
    score_list<SCORE, VEC>(a, qop, qsq, scale, sel_cur, cand_id, ok_slot,
                           ok_d, n_ok);
    __syncthreads();
    // rank the scored candidates by (distance, slot): so_* is the sorted
    // list, so_r each one's rank among all C slots (the masked slots are
    // (INF, -1) and rank before a scored one only at a distance >= INF)
    for (int j = tid; j < n_ok; j += NT) {
      const float d = ok_d[j];
      int r = 0;
      for (int t = 0; t < n_ok; ++t) {
        const float e = ok_d[t];
        r += (e < d) || (e == d && t < j);
      }
      int full = r;
      if (d >= INF_DIST) {
        const int slot = ok_slot[j];
        for (int c = 0; c < C; ++c)
          full += cand_id[c] < 0 && (INF_DIST < d || c < slot);
      }
      so_d[r] = d;
      so_i[r] = cand_id[ok_slot[j]];
      so_r[r] = full;
    }
    __syncthreads();
    // 6. merge
    if (!a.merge_sort) {
      for (int p = tid; p < W2; p += NT) {
        buf_d[p] = p < P ? pool_d[p] : INF_DIST;
        buf_i[p] = p < P ? pool_i[p] : -1;
      }
      __syncthreads();
      for (int j = tid; j < n_ok; j += NT) {
        const int pos = W2 - 1 - so_r[j];
        buf_d[pos] = so_d[j];
        buf_i[pos] = so_i[j];
      }
      __syncthreads();
      for (int s = W2 >> 1; s >= 1; s >>= 1) {
        for (int p = tid; p < (W2 >> 1); p += NT) {
          const int lo = ((p & ~(s - 1)) << 1) | (p & (s - 1)), hi = lo + s;
          const float x = buf_d[lo], y = buf_d[hi];
          if (x > y) {
            buf_d[lo] = y;
            buf_d[hi] = x;
            const int t = buf_i[lo];
            buf_i[lo] = buf_i[hi];
            buf_i[hi] = t;
          }
        }
        __syncthreads();
      }
      for (int p = tid; p < P; p += NT) {
        pool_d[p] = buf_d[p];
        pool_i[p] = buf_i[p];
      }
      __syncthreads();
    } else {
      const int n_masked = C - n_ok;
      for (int p = tid; p < P; p += NT) {
        buf_d[p] = INF_DIST;
        buf_i[p] = -1;
      }
      __syncthreads();
      for (int p = tid; p < P; p += NT) {
        const float d = pool_d[p];
        const int pos = p + lower_bound(so_d, n_ok, d)
                        + (d > INF_DIST ? n_masked : 0);
        if (pos < P) {
          buf_d[pos] = d;
          buf_i[pos] = pool_i[p];
        }
      }
      for (int j = tid; j < n_ok; j += NT) {
        const int pos = so_r[j] + upper_bound(pool_d, P, so_d[j]);
        if (pos < P) {
          buf_d[pos] = so_d[j];
          buf_i[pos] = so_i[j];
        }
      }
      __syncthreads();
      for (int p = tid; p < P; p += NT) {
        const int id = unpack(buf_i[p]);
        pool_i[p] = p > 0 && id >= 0 && id == unpack(buf_i[p - 1]);
      }
      __syncthreads();
      for (int p = tid; p < P; p += NT) {
        if (pool_i[p]) {
          buf_d[p] = INF_DIST;
          buf_i[p] = -1;
        }
      }
      __syncthreads();
      compact(buf_d, buf_i, pool_d, pool_i, P, scratch);
    }
    ++hops;
    n_exp += n_take;
    n_scored += n_ok;
  }
  // the pool is ascending with its empty slots last: the twin's final
  // stable sort leaves it as it is
  for (int p = tid; p < P; p += NT) {
    const float d = pool_d[p];
    a.out_d[(size_t)b * P + p] = d;
    a.out_i[(size_t)b * P + p] = d >= INF_DIST ? -1 : unpack(pool_i[p]);
  }
  if (tid == 0) {
    a.hops[b] = hops;
    a.work[2 * b] = n_exp;
    a.work[2 * b + 1] = n_scored;
  }
}

int next_pow2(int n) {
  int w = 1;
  while (w < n) w <<= 1;
  return w;
}

size_t smem_bytes(int D, int P, int E, int M, int merge_sort) {
  const int C = E * M;
  const int WB = merge_sort ? P : next_pow2(P + C);
  return 4 * (size_t)(((D + 3) & ~3) + 2 * P + 2 * WB + 6 * C + 2 * E + NW);
}

template <int SCORE, bool VEC>
cudaError_t launch(const Params& p, int B, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        beam_search_kernel<SCORE, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  beam_search_kernel<SCORE, VEC><<<B, NT, smem, st>>>(p);
  return cudaGetLastError();
}

template <int SCORE>
cudaError_t launch_vec(const Params& p, bool vec, int B, size_t smem,
                       cudaStream_t st) {
  return vec ? launch<SCORE, true>(p, B, smem, st)
             : launch<SCORE, false>(p, B, smem, st);
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes (ops/beam_search.py
// computes the same number to decide which calls take the kernel).
int beam_search_smem_bytes(int D, int P, int E, int M, int merge_sort) {
  return (int)smem_bytes(D, P, E, M, merge_sort);
}

// One launch: B blocks, one query each. score: 0 f32 rows, 1 f32 rows with
// bf16 operands, 2 int8 blocks, 3 fp16 blocks. metric: 0 cosine, 1 l2,
// 2 sqeuclidean, 3 dot. merge_sort: 0 bitonic, 1 sort. Returns the
// cudaError_t of the launch.
int beam_search_launch(const void* queries, const void* q_sq,
                       const void* start_ids, const void* start_d, int s_in,
                       const void* table, int width, const void* upper_map,
                       int n_rows, const void* vectors, const void* sq_norms,
                       const void* blocks, int block_m,
                       const void* block_scale, int B, int D, int P, int E,
                       int M, int max_hops, int metric, int score,
                       int merge_sort, int normalized, void* out_d,
                       void* out_i, void* hops, void* work, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  Params p;
  p.queries = static_cast<const float*>(queries);
  p.q_sq = static_cast<const float*>(q_sq);
  p.start_ids = static_cast<const int*>(start_ids);
  p.start_d = static_cast<const float*>(start_d);
  p.s_in = s_in;
  p.table = static_cast<const int*>(table);
  p.width = width;
  p.upper_map = static_cast<const int*>(upper_map);
  p.n_rows = n_rows;
  p.vectors = static_cast<const float*>(vectors);
  p.sq_norms = static_cast<const float*>(sq_norms);
  p.blocks = blocks;
  p.block_m = block_m;
  p.block_scale = static_cast<const float*>(block_scale);
  p.D = D;
  p.P = P;
  p.E = E;
  p.M = M;
  p.max_hops = max_hops;
  p.metric = metric;
  p.merge_sort = merge_sort;
  p.normalized = normalized;
  p.W2 = next_pow2(P + E * M);
  p.out_d = static_cast<float*>(out_d);
  p.out_i = static_cast<int*>(out_i);
  p.hops = static_cast<int*>(hops);
  p.work = static_cast<int*>(work);
  const size_t smem = smem_bytes(D, P, E, M, merge_sort);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // whole-row vector loads: rows start at multiples of D elements, so
  // D % 4 == 0 and an aligned base keep every row aligned
  const bool vec4 = D % 4 == 0;
  switch (score) {
    case S_F32:
      return (int)launch_vec<S_F32>(p, vec4 && aligned(vectors, 16), B, smem,
                                    st);
    case S_BF16:
      return (int)launch_vec<S_BF16>(p, vec4 && aligned(vectors, 16), B,
                                     smem, st);
    case S_I8:
      return (int)launch_vec<S_I8>(p, vec4 && aligned(blocks, 4), B, smem,
                                   st);
    case S_F16:
      return (int)launch_vec<S_F16>(p, vec4 && aligned(blocks, 8), B, smem,
                                    st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
