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
// One launch a call, one block of 128 threads a row p:
//
//   A. the row's ids and distances go to shared memory; each thread ranks
//      its candidates by counting (rank_j = #{i : d_i < d_j, or d_i == d_j
//      and i < j}: exactly stable, O(C^2) compares over the block), then
//      dedups against the earlier ranks and reads the squared norms;
//   G-stage. each valid candidate's row is gathered ONCE into shared memory
//      as bf16, in sorted order: 16-byte loads of the f32 or fp16 store
//      rounded to bf16 (nearest even: pack_bf16 below), a bf16 store copied
//      as stored with cp.async; C and D padded to multiples of 16 with
//      zeros (invalid and padded candidates are zero rows), a row pitch of
//      D_pad + 8 bf16, so ldmatrix's eight 16-byte rows fall in eight bank
//      groups;
//   G-product. the Gram's lower triangle on the tensor cores:
//      mma.sync m16n8k16 bf16 x bf16 -> f32, fed by ldmatrix. A unit is 16
//      candidates j (an m-tile) against 32 candidates e (one 32-bit word of
//      conflict bits: four n-tiles); a warp owns whole units, and only the
//      fragments that hold some pair e < j are issued (the diagonal word's
//      upper two n-tiles of an even m-tile are skipped);
//   G-bits. the epilogue in registers: each lane holds (row g / g + 8,
//      columns 2t / 2t + 1) of a fragment, applies the strict compare
//      pd[j, e] < cd[j] (for l2 as max(t, 0) <= a limit a row, computed in
//      A: no square root a pair), masks e >= j and padded rows, and the
//      quad ORs its
//      bits with two shuffles; one lane stores each (row, word): no shared
//      atomics. The bits are a triangle, row j holding words 0 .. j / 32;
//   S. one warp runs the C serial steps on the bits: lane w holds the kept
//      mask of candidates 32w .. 32w + 31, a step is one shared load and
//      one vote (clash = any(conflict[j] & kept)); the backfill and the
//      compaction take 32 candidates a step with ballots and popc.
//
// Where C_pad x pitch does not fit the block's row budget (kRowBudget; C
// 1,024 at D 128, C 256 at D 300), D is staged in slabs with every row of
// the slab resident, and each unit's accumulators carry across slabs in a
// global workspace (each lane its own 16 floats): still one gather a slot
// a slab. Such a launch is persistent: a grid of the card's resident
// blocks walks the rows, so the workspace is that grid's, not P's.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 on the
// tensor cores). A layer-0 call of the smoke's build (P 2,048, C 96, D 128)
// gathers P C D 4 = 100.7 MB of f32 rows, one gather a slot, from about
// 59,000 distinct rows (30 MB: L2 serves the repeats), and does
// P C (C - 1) / 2 D 2 = 2.4 GFLOP of Gram (2.4 us at the bf16 peak). The
// gather is the work: the kernel before this one staged each row again for
// every 32 x 32 tile (ceil(C / 32) times) with scalar loads and two barriers
// a chunk and ran the product on the f32 pipes, and its split
// (tools/select_split.py) gave the staging 0.54-0.67 of a block's cycles
// and the product 0.19-0.26. Here each row is gathered once in 16-byte
// loads with one barrier a slab, and the product is a few mma.sync a unit.
// Why mma.sync and not wgmma: a row's Gram is at most 1,024 wide and
// usually 96; wgmma's 64-row tiles would waste most of a 96-wide triangle
// and need the swizzled shared layout, and the whole call is 2.4 GFLOP, ~5
// us even at half the bf16 peak, so mma.sync's rate is no limit. One block
// a row at 28 KB of shared memory and 64 registers (C 96, D 128) keeps 8
// blocks an SM, so one block's scan (one warp, C serial steps) and rank
// overlap another's gather and product.
//
// The bf16 operands are DEFAULT's rounding and their products are exact in
// f32, so the tensor cores compute the twin's Gram with another f32
// summation order (equal on integer-valued rows).
//
// Shared memory (dynamic): three [C] arrays, each padded to a multiple of
// 4 for 16-byte reads (the sorted distances, or l2's limits; the sorted
// ids, -1 where invalid; squared norms), the triangle of conflict bits
// (bit_words(C) words), then the staged rows (C_pad x pitch bf16, 128-byte
// aligned), where the rank first reads the input ids and distances. At C
// 96 / D 128 that is 28,032 bytes: 8 blocks an SM. layout() is the one
// source of it; ops/diverse_select.py repeats it and its tests hold the
// two equal (diverse_select_smem_bytes).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 1024;
#ifndef DIVERSE_SELECT_ROW_BUDGET      // -D to move the slab threshold
#define DIVERSE_SELECT_ROW_BUDGET (96 * 1024)
#endif
constexpr int kRowBudget = DIVERSE_SELECT_ROW_BUDGET;  // staged rows, bytes
constexpr int kSmemMax = 232448;       // dynamic shared memory a block
constexpr int kUnitFloats = 16;        // accumulators a lane of a unit
// resident blocks an SM the registers must allow: 64 registers a thread
// (ptxas spills 8 bytes; C 96, D 128: shared memory allows 8 as well)
constexpr int kMinBlocks = 8;
constexpr float kInf = 3.0e38f;        // INF_DIST
constexpr unsigned kFull = 0xffffffffu;

enum Metric { M_COSINE = 0, M_L2 = 1, M_SQEUCLIDEAN = 2, M_DOT = 3 };
enum Store { ST_F32 = 0, ST_F16 = 1, ST_BF16 = 2 };

// Phase counters (SELECT_PHASE_CLOCKS builds, tools/select_split.py):
// thread 0 adds the clock64() cycles since the last mark to the phase's
// counter: A load, rank, dedup, norms; G-stage the row gather; G-product;
// G-bits the epilogue and conflict bits; S scan, backfill, compaction.
enum { PH_A = 0, PH_STAGE, PH_PRODUCT, PH_BITS, PH_SCAN, N_PHASE };
#ifdef SELECT_PHASE_CLOCKS
__device__ long long* g_clocks = nullptr;
#define PHASE_MARK(ph)                                  \
  do {                                                  \
    if (threadIdx.x == 0) {                             \
      const long long t_ = clock64();                   \
      clk[ph] += t_ - clk[N_PHASE];                     \
      clk[N_PHASE] = t_;                                \
    }                                                   \
  } while (0)
#define CLOCKS_OUT()                                                   \
  do {                                                                 \
    if (threadIdx.x == 0 && g_clocks != nullptr) {                     \
      for (int i_ = 0; i_ < N_PHASE; ++i_)                             \
        g_clocks[(size_t)blockIdx.x * N_PHASE + i_] += clk[i_];        \
    }                                                                  \
  } while (0)
#else
#define PHASE_MARK(ph) \
  do {                 \
  } while (0)
#define CLOCKS_OUT() \
  do {               \
  } while (0)
#endif

// words of the triangle of conflict bits over candidates 0 .. C - 1 (row
// j holds words 0 .. j >> 5); also the offset of row C's first word
__host__ __device__ inline int bit_words(int C) {
  const int q = C >> 5, r = C & 31;
  return 32 * (q * (q + 1) / 2) + r * (q + 1);
}

// (m-tile, word) units of the lower triangle over R m-tiles of 16
// candidates: m-tile r pairs with words 0 .. r / 2
__host__ __device__ inline int unit_count(int R) {
  const int h = R / 2;
  return (R & 1) ? (h + 1) * (h + 1) : h * (h + 1);
}

struct Layout {
  int c_pad, d_pad, slab, n_slabs, pitch;  // pitch: bf16 a staged row
  int cd, ci, sq, bits, rows, din, iin;    // byte offsets
  int plain, total;  // bytes of a launch without and with diversify
  int units;
};

// the block's layout at C candidates, D wide: the rows whole where they
// fit kRowBudget (one slab of D_pad), else the widest slab of 16k columns
// that does; total < 0 where not even 16 columns fit
__host__ __device__ inline Layout layout(int C, int D) {
  Layout L;
  L.c_pad = (C + 15) / 16 * 16;
  L.d_pad = D < 16 ? 16 : (D + 15) / 16 * 16;
  const int cq = (C + 3) / 4 * 4;         // 16-byte aligned arrays
  int o = 0;
  L.cd = o; o += 4 * cq;
  L.ci = o; o += 4 * cq;
  L.sq = o; o += 4 * cq;
  L.bits = o; o += 4 * bit_words(C);
  o = (o + 127) / 128 * 128;
  L.rows = o;
  // the input ids and distances, read only by the rank, lie where the
  // rows are staged later
  L.din = o;
  L.iin = o + 4 * cq;
  L.plain = o + 8 * cq;
  int budget = kSmemMax - o;
  if (budget > kRowBudget) budget = kRowBudget;
  L.slab = L.c_pad * (L.d_pad + 8) * 2 <= budget
               ? L.d_pad
               : (budget / (2 * L.c_pad) - 8) / 16 * 16;
  L.units = unit_count(L.c_pad / 16);
  if (L.slab < 16) {
    L.slab = L.n_slabs = L.pitch = 0;
    L.total = -1;
    return L;
  }
  L.n_slabs = (L.d_pad + L.slab - 1) / L.slab;
  L.pitch = L.slab + 8;
  L.total = o + L.c_pad * L.pitch * 2;
  return L;
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

// The largest m >= 0 with sqrt_rn(m) < c, or -1 where there is none (c <=
// 0): l2's pair distance is sqrt_rn(max(t, 0)), non-decreasing in t, so
// pd < c is max(t, 0) <= l2_limit(c), one limit a row instead of a
// square root a pair.
__device__ __forceinline__ float l2_limit(float c) {
  if (!(c > 0.0f)) return -1.0f;
  float y = __fmul_rn(c, c);
  while (y > 0.0f && __fsqrt_rn(y) >= c) y = nextafterf(y, 0.0f);
  for (;;) {
    const float z = nextafterf(y, INFINITY);
    if (isinf(z) || __fsqrt_rn(z) >= c) break;
    y = z;
  }
  return y;
}

// pd[j, e] < cd[j] (strict) from the Gram entry, the two squared norms and
// the row's limit (cd[j], or l2_limit(cd[j]) for l2)
__device__ __forceinline__ bool conflict(float g, float sj, float se,
                                         float lim, int metric) {
  if (metric == M_L2) {
    return fmaxf(__fsub_rn(__fadd_rn(sj, se), __fmul_rn(2.0f, g)), 0.0f) <=
           lim;
  }
  return pair_dist(g, sj, se, metric) < lim;
}

// two f32 rounded to bf16 (nearest even, as ops/distance.bf16_round), a
// in the low half (the lower address)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// elements k .. k + 7 of the row at `base` as 8 bf16, zeros past D (VEC:
// 16-byte loads of whole 4- or 8-element groups)
template <int STORE, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const void* vectors, size_t base,
                                            int k, int D) {
  if constexpr (VEC && STORE == ST_F32) {
    const float* src = static_cast<const float*>(vectors) + base + k;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (k < D) a = __ldg(reinterpret_cast<const float4*>(src));
    if (k + 4 < D) b = __ldg(reinterpret_cast<const float4*>(src + 4));
    return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                      pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  } else if constexpr (VEC && STORE == ST_F16) {
    if (k >= D) return make_uint4(0u, 0u, 0u, 0u);
    const uint4 h = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const __half*>(vectors) + base + k));
    const uint32_t w[4] = {h.x, h.y, h.z, h.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      o[i] = pack_bf16(f.x, f.y);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] = k + i < D ? load_value<STORE>(vectors, base + k + i) : 0.0f;
    }
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                      pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
}

// G-stage: columns [k0, k0 + width) of every candidate's row into `rows`
// (C_pad x pitch bf16), zeros for invalid and padded candidates and past D;
// an id past the store reads row N - 1, as the twin's clamp does
template <int STORE, bool VEC>
__device__ __forceinline__ void stage_rows(
    __nv_bfloat16* rows, const void* __restrict__ vectors, const int* ci,
    int C, int c_pad, int N, int D, int k0, int width, int pitch) {
  const int chunks = width / 8;           // 16-byte chunks a staged row
  const int items = c_pad * chunks;
  constexpr int kBatch = 4;               // chunks a thread has in flight
  for (int x0 = threadIdx.x; x0 < items; x0 += kThreads * kBatch) {
    if constexpr (VEC && STORE == ST_BF16) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int x = x0 + b * kThreads;
        if (x < items) {
          const int j = x / chunks, c = x - j * chunks, k = k0 + c * 8;
          const bool on = j < C && ci[j] >= 0 && k < D;
          const __nv_bfloat16* src =
              static_cast<const __nv_bfloat16*>(vectors);
          if (on) src += (size_t)min(ci[j], N - 1) * D + k;
          // 16 bytes as stored, or 16 zero bytes (source size 0)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                           "r"(smem_addr(rows + j * pitch + c * 8)),
                       "l"(src), "r"(on ? 16 : 0));
        }
      }
    } else {
      uint4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int x = x0 + b * kThreads;
        v[b] = make_uint4(0u, 0u, 0u, 0u);
        if (x < items) {
          const int j = x / chunks, k = k0 + (x - j * chunks) * 8;
          if (j < C && ci[j] >= 0) {
            v[b] = load_chunk<STORE, VEC>(
                vectors, (size_t)min(ci[j], N - 1) * D, k, D);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int x = x0 + b * kThreads;
        if (x < items) {
          const int j = x / chunks, c = x - j * chunks;
          *reinterpret_cast<uint4*>(rows + j * pitch + c * 8) = v[b];
        }
      }
    }
  }
  if constexpr (VEC && STORE == ST_BF16) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// DIVERSIFY false: steps 1-3 only (one instantiation serves every store:
// no row is read), launched with the arrays' shared memory alone
template <int STORE, bool VEC, bool DIVERSIFY>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
diverse_select_kernel(const int* __restrict__ cand_i,
                      const float* __restrict__ cand_d,
                      const void* __restrict__ vectors,
                      const float* __restrict__ sq_norms, int P, int N,
                      int C, int D, int deg, int out_w, int metric,
                      int* __restrict__ out, float* __restrict__ workspace) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(C, D);
  float* din = reinterpret_cast<float*>(smem + L.din);
  int* iin = reinterpret_cast<int*>(smem + L.iin);
  float* cd = reinterpret_cast<float*>(smem + L.cd);
  int* ci = reinterpret_cast<int*>(smem + L.ci);
  float* ssq = reinterpret_cast<float*>(smem + L.sq);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L.bits);
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(smem + L.rows);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int W = (C + 31) >> 5;
#ifdef SELECT_PHASE_CLOCKS
  long long clk[N_PHASE + 1];
  if (tid == 0) {
    for (int i = 0; i < N_PHASE; ++i) clk[i] = 0;
    clk[N_PHASE] = clock64();
  }
#endif

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    // A. load, rank by counting, dedup, norms
    for (int j = tid; j < C; j += kThreads) {
      din[j] = cand_d[(size_t)p * C + j];
      iin[j] = cand_i[(size_t)p * C + j];
    }
    __syncthreads();
    for (int j = tid; j < C; j += kThreads) {
      const float dj = din[j];
      int r = 0, i = 0;
      for (; i + 4 <= C; i += 4) {          // four distances a read
        const float4 v = *reinterpret_cast<const float4*>(din + i);
        r += (v.x < dj) || (v.x == dj && i < j);
        r += (v.y < dj) || (v.y == dj && i + 1 < j);
        r += (v.z < dj) || (v.z == dj && i + 2 < j);
        r += (v.w < dj) || (v.w == dj && i + 3 < j);
      }
      for (; i < C; ++i) {
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
        for (int e = 0; e < j && !dup; e += 4) {   // four ids a read
          const int4 v = *reinterpret_cast<const int4*>(ci + e);
          dup = (v.x == id) || (e + 1 < j && v.y == id) ||
                (e + 2 < j && v.z == id) || (e + 3 < j && v.w == id);
        }
      }
      const float d = cd[j];
      const bool valid = !dup && d < kInf && id >= 0;
      iin[j] = valid;                    // the inputs are read: a flag
      cd[j] = DIVERSIFY && metric == M_L2 ? l2_limit(d) : d;
      ssq[j] = sq_norms[min(max(id, 0), N - 1)];
    }
    __syncthreads();
    for (int j = tid; j < C; j += kThreads) {
      if (!iin[j]) ci[j] = -1;           // from here, valid = ci[j] >= 0
    }
    __syncthreads();
    PHASE_MARK(PH_A);

    if constexpr (!DIVERSIFY) {
      for (int j = tid; j < out_w; j += kThreads) {
        out[(size_t)p * out_w + j] = ci[j];
      }
    } else {
      // G. the Gram's lower triangle, a D slab at a time, into conflict bits
      for (int s = 0; s < L.n_slabs; ++s) {
        const int k0 = s * L.slab;
        const int width = min(L.slab, L.d_pad - k0);
        const bool first = s == 0, last = s == L.n_slabs - 1;
        if (!first) __syncthreads();       // the last slab is consumed
        stage_rows<STORE, VEC>(rows, vectors, ci, C, L.c_pad, N, D, k0,
                               width, L.pitch);
        __syncthreads();
        PHASE_MARK(PH_STAGE);
        int u = 0;
        for (int r = 0; r < L.c_pad / 16; ++r) {
          for (int g = 0; g <= r / 2; ++g, ++u) {
            if (u % kWarps != warp) continue;
            // n-tiles of word g that hold a pair e < j: four, or two on the
            // diagonal word of an even m-tile
            const bool four = 2 * r + 2 - 4 * g >= 4;
            float4* ws = reinterpret_cast<float4*>(
                workspace + (((size_t)blockIdx.x * L.units + u) * 32 + lane) *
                                kUnitFloats);
            float acc[4][4];
  #pragma unroll
            for (int t = 0; t < 4; ++t) {
              const float4 v =
                  first ? make_float4(0.f, 0.f, 0.f, 0.f) : ws[t];
              acc[t][0] = v.x;
              acc[t][1] = v.y;
              acc[t][2] = v.z;
              acc[t][3] = v.w;
            }
            // A: rows 16r + (lane & 15), columns + 8 (lane >> 4); B: rows
            // 32g + (lane & 7) + 8 (lane >> 4), columns + 8 ((lane >> 3) & 1)
            const uint32_t a_at = smem_addr(
                rows + (16 * r + (lane & 15)) * L.pitch + (lane >> 4) * 8);
            const uint32_t b_at = smem_addr(
                rows + (32 * g + (lane & 7) + ((lane >> 4) << 3)) * L.pitch +
                ((lane >> 3) & 1) * 8);
            for (int kk = 0; kk < width; kk += 16) {
              uint32_t a[4], b[4];
              ldsm_x4(a, a_at + kk * 2);
              ldsm_x4(b, b_at + kk * 2);
              mma_bf16(acc[0], a, b[0], b[1]);
              mma_bf16(acc[1], a, b[2], b[3]);
              if (four) {
                ldsm_x4(b, b_at + (16 * L.pitch + kk) * 2);
                mma_bf16(acc[2], a, b[0], b[1]);
                mma_bf16(acc[3], a, b[2], b[3]);
              }
            }
            PHASE_MARK(PH_PRODUCT);
            if (!last) {
  #pragma unroll
              for (int t = 0; t < 4; ++t) {
                ws[t] = make_float4(acc[t][0], acc[t][1], acc[t][2],
                                    acc[t][3]);
              }
              continue;
            }
            // the epilogue: this lane's rows j0 = 16r + lane / 4 and j0 + 8,
            // columns 32g + 8t + 2 (lane % 4) + b
            const int j0 = 16 * r + (lane >> 2), j1 = j0 + 8;
            uint32_t w0 = 0u, w1 = 0u;
  #pragma unroll
            for (int t = 0; t < 4; ++t) {
  #pragma unroll
              for (int b = 0; b < 2; ++b) {
                const int at = 8 * t + 2 * (lane & 3) + b;
                const int e = 32 * g + at;
                if (e < j0 && j0 < C &&
                    conflict(acc[t][b], ssq[j0], ssq[e], cd[j0], metric)) {
                  w0 |= 1u << at;
                }
                if (e < j1 && j1 < C &&
                    conflict(acc[t][2 + b], ssq[j1], ssq[e], cd[j1],
                             metric)) {
                  w1 |= 1u << at;
                }
              }
            }
            w0 |= __shfl_xor_sync(kFull, w0, 1);
            w0 |= __shfl_xor_sync(kFull, w0, 2);
            w1 |= __shfl_xor_sync(kFull, w1, 1);
            w1 |= __shfl_xor_sync(kFull, w1, 2);
            if ((lane & 3) == 0) {
              if (j0 < C) bits[bit_words(j0) + g] = w0;
              if (j1 < C) bits[bit_words(j1) + g] = w1;
            }
            PHASE_MARK(PH_BITS);
          }
        }
      }
      __syncthreads();
      PHASE_MARK(PH_BITS);

      // S. Malkov's scan, the backfill and the compaction: one warp
      if (warp == 0) {
        uint32_t kept = 0u;                // lane w: candidates 32w .. 32w+31
        int count = 0;
        for (int b = 0; b < W && count < deg; ++b) {
          // candidates 32b .. 32b + n - 1: their validity as one mask; row
          // 32b + i holds b + 1 words from bit_words(32b) + i (b + 1), and
          // lane w <= b reads word w of 16 rows ahead of the serial steps
          const int n = min(32, C - 32 * b);
          const uint32_t vmask =
              __ballot_sync(kFull, lane < n && ci[32 * b + lane] >= 0);
          const uint32_t* words = bits + bit_words(32 * b) + lane;
          for (int i0 = 0; i0 < n && count < deg; i0 += 16) {
            uint32_t row[16];
  #pragma unroll
            for (int i = 0; i < 16; ++i) {
              row[i] = lane <= b && i0 + i < n ? words[(i0 + i) * (b + 1)]
                                               : 0u;
            }
  #pragma unroll
            for (int i = 0; i < 16; ++i) {
              const bool clash = __any_sync(kFull, (row[i] & kept) != 0u);
              const bool take =
                  count < deg && ((vmask >> (i0 + i)) & 1u) && !clash;
              kept |= take && lane == b ? 1u << (i0 + i) : 0u;
              count += take;
            }
          }
        }
        const uint32_t below = (1u << lane) - 1u;
        for (int b = 0; b < W && count < deg; ++b) {
          const int j = b * 32 + lane;
          const uint32_t kb = __shfl_sync(kFull, kept, b);
          const bool cand = j < C && ci[j] >= 0 && !((kb >> lane) & 1u);
          const uint32_t m = __ballot_sync(kFull, cand);
          const bool take = cand && count + __popc(m & below) < deg;
          const uint32_t t = __ballot_sync(kFull, take);
          if (lane == b) kept |= t;
          count += __popc(t);
        }
        int* o = out + (size_t)p * out_w;
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
    }
    PHASE_MARK(PH_SCAN);
    __syncthreads();                     // before the next row's loads
  }
  CLOCKS_OUT();
}

// the kernel of each row store (ST_*), with scalar or 16-byte loads, and
// the one without diversify
using Kernel = decltype(&diverse_select_kernel<ST_F32, true, true>);
const Kernel kKernels[3][2] = {
    {diverse_select_kernel<ST_F32, false, true>,
     diverse_select_kernel<ST_F32, true, true>},
    {diverse_select_kernel<ST_F16, false, true>,
     diverse_select_kernel<ST_F16, true, true>},
    {diverse_select_kernel<ST_BF16, false, true>,
     diverse_select_kernel<ST_BF16, true, true>}};
const Kernel kPlainOrder = diverse_select_kernel<ST_F32, false, false>;

// the store's kernel, allowed the layout's dynamic shared memory; nullptr
// for an unknown store or a layout that does not fit
Kernel prepared(int C, int D, int store, bool vec, cudaError_t* err) {
  const Layout L = layout(C, D);
  if (store < ST_F32 || store > ST_BF16 || L.total < 0) {
    *err = cudaErrorInvalidValue;
    return nullptr;
  }
  const Kernel k = kKernels[store][vec ? 1 : 0];
  *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              L.total);
  return *err == cudaSuccess ? k : nullptr;
}

int blocks_per_sm(int C, int D, int store, bool vec) {
  cudaError_t err;
  const Kernel k = prepared(C, D, store, vec, &err);
  int n = 0;
  if (k != nullptr) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads,
                                                        layout(C, D).total);
  }
  return err == cudaSuccess ? n : -1;
}

// blocks of a diversifying launch: one a row, or, where D is staged in
// slabs, a persistent grid of the card's resident blocks walking the rows;
// 0 on an error
int grid_blocks(int P, int C, int D, int store) {
  const Layout L = layout(C, D);
  if (L.total < 0) return 0;
  if (L.n_slabs == 1) return P;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  const int per_sm = blocks_per_sm(C, D, store, true);
  if (per_sm < 1) return 0;
  return P < sms * per_sm ? P : sms * per_sm;
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

extern "C" {

// dynamic shared memory of one block at C candidates a row, D wide, for
// the store (0 f32, 1 fp16, 2 bf16); -1 for arguments the kernel does not
// take
int diverse_select_smem_bytes(int C, int D, int store) {
  if (C < 1 || C > kMaxC || D < 0 || store < ST_F32 || store > ST_BF16) {
    return -1;
  }
  return layout(C, D).total;
}

// resident blocks an SM at C candidates a row, D wide, for the store's
// kernel (16-byte loads); -1 on an error
int diverse_select_blocks_per_sm(int C, int D, int store) {
  if (diverse_select_smem_bytes(C, D, store) < 0) return -1;
  return blocks_per_sm(C, D, store, true);
}

// bytes of the global workspace a diversifying launch of P rows needs: 0
// where the rows are staged whole (one slab), else 16 floats a lane of each
// unit of each block of the persistent grid; -1 for arguments the kernel
// does not take
long long diverse_select_workspace_bytes(int P, int C, int D, int store) {
  if (P < 0 || diverse_select_smem_bytes(C, D, store) < 0) return -1;
  const Layout L = layout(C, D);
  if (L.n_slabs <= 1 || P == 0) return 0;
  const int grid = grid_blocks(P, C, D, store);
  if (grid < 1) return -1;
  return (long long)grid * L.units * 32 * kUnitFloats * sizeof(float);
}

// One launch: rows [P, out_w] int32 of `out` from cand_i [P, C] int32 and
// cand_d [P, C] f32 (row-major, contiguous), the [N, D] row store (f32,
// fp16 or bf16 by `store`) and its squared norms (at least N, f32);
// `workspace` holds diverse_select_workspace_bytes where that is not 0.
// Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for arguments the kernel does not take.
int diverse_select_launch(const int* cand_i, const float* cand_d,
                          const void* vectors, const float* sq_norms, int P,
                          int C, int N, int D, int deg, int out_w, int metric,
                          int store, int diversify, int* out, void* workspace,
                          void* stream) {
  if (P < 0 || C < 1 || C > kMaxC || N < 1 || D < 0 || deg < 1 ||
      out_w != (C < deg ? C : deg) || metric < 0 || metric > 3 ||
      store < ST_F32 || store > ST_BF16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0) return 0;
  const Layout L = layout(C, D);
  const bool slabs = diversify && L.n_slabs > 1;
  if (L.total < 0 || (slabs && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!diversify) {
    // no row is staged and no bit set: the arrays' shared memory alone
    const cudaError_t err = cudaFuncSetAttribute(
        kPlainOrder, cudaFuncAttributeMaxDynamicSharedMemorySize, L.plain);
    if (err != cudaSuccess) return static_cast<int>(err);
    kPlainOrder<<<P, kThreads, L.plain, st>>>(cand_i, cand_d, vectors,
                                             sq_norms, P, N, C, D, deg,
                                             out_w, metric, out, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  // whole 16-byte groups: rows start at multiples of D elements
  const bool vec = aligned(vectors, 16) &&
                   D % (store == ST_F32 ? 4 : 8) == 0;
  cudaError_t err;
  const Kernel k = prepared(C, D, store, vec, &err);
  if (k == nullptr) return static_cast<int>(err);
  const int grid = slabs ? grid_blocks(P, C, D, store) : P;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  k<<<grid, kThreads, L.total, st>>>(cand_i, cand_d, vectors, sq_norms, P,
                                     N, C, D, deg, out_w, metric, out,
                                     static_cast<float*>(workspace));
  return static_cast<int>(cudaGetLastError());
}

#ifdef SELECT_PHASE_CLOCKS
// Phase counters of the next launches: [P, N_PHASE] int64 on the device,
// or null (tools/select_split.py).
int diverse_select_phase_count() { return N_PHASE; }
int diverse_select_set_clocks(void* clocks) {
  long long* p = static_cast<long long*>(clocks);
  return static_cast<int>(cudaMemcpyToSymbol(g_clocks, &p, sizeof(p)));
}
#endif

}  // extern "C"
