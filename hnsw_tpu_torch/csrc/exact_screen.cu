// Fused exact k-NN screen for NVIDIA Hopper (sm_90a).
//
// Replaces two sites of the JAX package:
//
// * K1, the TPU kernel hnsw_tpu/ops/pallas_exact.py:pallas_exact_screen:
//   for every query the k_sel smallest (distance, column id) pairs over an
//   [N, D] f32 table under one of the builtin metrics, with the validity
//   mask applied;
// * K3, the capacity scan hnsw_tpu/ops/topk.py:quantized_topk_candidates
//   (each chunk selected by the TPU's approx_min_k): the same contract
//   over the capacity modes' reduced tables, int8 rows with a per-row
//   scale (row ~= row_int8 * scale), bf16 rows or fp16 rows.
//
// Neither writes the [Q, N] score matrix to device memory.
//
// One kernel, screen_wgmma_kernel<STORE, ROUTE>, computes that contract
// with the Gram product on the tensor cores. STORE is the table's type and
// the product's precision (Store below); ROUTE is who fills the ring of
// shared-memory stages (ops/exact_screen.py screen_route and
// capacity_route). A stage holds [rows x 32] f32 boxes (128 bytes a row,
// in the 128-byte swizzle) of the queries and the table, one mbarrier a
// stage:
//
// * WGMMA (TMA): one thread asks TMA for both boxes. TMA needs a row pitch
//   that is a multiple of 16 bytes (f32: D % 4 == 0; int8: D % 16 == 0;
//   16-bit: D % 8 == 0) and 16-byte aligned base pointers.
// * WGMMA_CP (cp.async, float32 tables only): every float32 table else
//   (D % 4 != 0, such as GloVe's D = 25 / 50 or lastfm's 65, and row
//   views at any 4-byte offset). All 256 threads copy the boxes with
//   cp.async, 8 bytes a copy where D is even and the base pointers are
//   8-byte aligned, else 4. Each value lands at the byte TMA's swizzle
//   would give it, columns past D and rows past the matrix are
//   zero-filled through the copy's src-size operand (as TMA's
//   out-of-bounds fill), and each thread's copies arrive on the stage's
//   mbarrier (cp.async.mbarrier.arrive.noinc, the barrier counting all
//   256).
// * WGMMA_LD (reduced tables only, every pitch TMA cannot take, such as
//   int8 rows of glove-25's 25 bytes or bf16 rows of glove-50's 100): the
//   threads copy both boxes with ordinary loads and stores, then arrive
//   on the barrier.
// From the landed stage on, the producers share every instruction.
//
// One elementwise pass over each landed stage makes the operands the
// product reads, in place in the swizzled boxes:
//   F32       x -> hi = tf32_rna(x) (in place) and lo = tf32_rna(x - hi)
//             (a second buffer of the same layout) for both operands; the
//             product is 3xTF32, hi*lo + lo*hi + hi*hi, small terms first
//             (the dropped lo*lo term is ~2^-22 of sum |q_i v_i|);
//   F32_FAST  both operands rounded to bf16 in place, exact in TF32 (8
//             significand bits of TF32's 11): one TF32 pass gives exactly
//             the bf16 x bf16 -> f32 products fast_math means;
//   I8, BF16  the query rounded to bf16 (round to nearest even, as
//             ops/distance.bf16_round); the raw int8 / bf16 rows, landed
//             in a box of their own, widened into the f32 table box. int8
//             and bf16 values are exact in TF32, so one TF32 pass gives
//             the exact products, summed in f32. I8 multiplies each
//             column's Gram by its row's scale in the epilogue, before the
//             metric; the norms are the exact f32 v_sq of the original
//             rows (ops/topk.quantized_topk_candidates, its plain twin);
//   F16       the fp16 rows widened exactly (11 significant bits fit TF32's
//             11; fp16 subnormals are normal under TF32's 8-bit exponent),
//             the f32 query split into hi and lo as in F32; the product is
//             2xTF32, lo*v + hi*v, within ~2^-22 of sum |q_i v_i| of the
//             f32 product of the plain twin.
// Both operands are row-major [rows, D], i.e. K-major, the only layout
// TF32 wgmma takes: nothing is transposed.
//
// What bounds it on this card (H100 SXM). At Q=1024, N=2^20, D=128 the
// Gram is 275 GFLOP. Done f32-accurate it takes at least 1.67 ms, as
// 3xTF32 (3 passes at 495 TFLOP/s; the FMA pipe's 67 TFLOP/s would take
// 4.10 ms). fast_math's bf16 operands could run at the bf16 rate (989
// TFLOP/s): 0.28 ms; so could the int8 and bf16 tables (int8 values are
// exact in bf16), while fp16 at f32 fidelity needs two TF32 passes, 1.11
// ms. The table read once from HBM is 0.16 ms in f32, 0.04 ms in int8. So
// every store is bound by operations, not bytes, and every producer puts
// the product on the tensor cores (TF32 here; the int8 and bf16 tables'
// bf16 wgmma is screen_ws_kernel, below).
// The query tile is blockIdx.x, the fastest-varying grid index, so the
// query tiles of one segment run together and meet its table boxes in L2.
// Measured, the product itself hides behind the rest: the staging (the
// copies from L2 and the conversion pass), the epilogue and the
// selection each take a share of the time, and they overlap only across
// blocks. So the design aims at two resident blocks an SM. The cp.async
// producer spends its threads' issue slots on the copies that TMA makes
// for free; its copies of the next stage are in flight while the warps
// convert, multiply and select the current one. (That split comes from
// tools/screen_split.py, which times builds with -DSPLIT_NO_SELECT,
// -DSPLIT_NO_EPILOGUE and -DSPLIT_NO_PRODUCT: each compiles that part of
// screen_wgmma_kernel and screen_ws_kernel out, so their results are
// wrong by design. The library the port loads defines none of them.)
//
// Shared memory (dynamic; 227 KB a block, 228 KB an SM on this card), for
// TQ = 64 queries by TC = 128 columns a tile:
//   ring   2 stages: F32 2 x 48 KiB (8 KiB query box + 16 KiB table box,
//          twice for the lo buffers); F32_FAST 2 x 24 KiB; I8 and BF16 2 x
//          35 KiB (24 KiB of f32 boxes, the raw rows: 4 / 8 KiB, padded to
//          hold the distance tile); F16 2 x 40 KiB (+ the query's lo box)
//   lists  TQ x k_sel int64 keys: 9 KiB at k_sel = 18, 64 KiB at 128,
//          128 KiB at 256 (the reduced stores' limit)
//   dt     TQ x (TC + 8) f32 distance tile, 34 KiB: its own region in
//          F32_FAST; in every other store the stage the tile's last k
//          block used, whose refill waits until the selection is done
//   qsq, thresholds, flags, the tile's norms and mask (and I8's scales),
//          mbarriers and the alignment slack: 3 KiB
// F32 at k_sel = 18: 108 KiB, two blocks an SM (up to k_sel = 28); at
// k_sel = 128: 163 KiB, one block. F32_FAST at k_sel = 18: 94 KiB, two
// blocks. I8 at k_sel = 26 (the int8 rung's pool at k = 10): 86 KiB, BF16
// at 14: 80 KiB, F16 at 14: 90 KiB, two blocks each; at k_sel = 256
// (k = 170 on the int8 rung) I8 and BF16 take 201 KiB, F16 211 KiB, one
// block. The query tile is
// not kept resident: it streams through the ring beside the table boxes
// (8 KiB of L2 reads a stage), so the budget does not grow with D (D =
// 960 fits as D = 128).
//
// A block runs 2 warpgroups; each computes the m64 x n64 half of the
// 64 x 128 tile with wgmma.m64n64k8.f32.tf32.tf32 from shared memory,
// 4 k8 steps a stage, the descriptor's start address advancing 32 bytes
// a step inside the 128-byte swizzle row. The epilogue is compiled per
// metric and selects l2 on the squared distance (the merge kernel takes
// the square root of the surviving keys); it flags the rows with a
// distance below their current worst, and the selection visits only
// those. While the warps run the epilogue and the selection of one column
// tile, the loads for the next tile are in flight.
//
// Selection: each query's running best k_sel sit in shared memory as
// int64 keys (order-preserving int32 of the distance in the high half,
// global column id in the low half). A candidate costs one compare
// against the current worst distance; only winners take the warp-wide
// sorted insert. Keys are unique, so ties go to the lower id.
// grid = (query tiles, N segments); a loop inside the block walks the
// segment's column tiles (the TPU's sequential grid axis); a second small
// kernel merges each query's per-segment lists.
//
// The capacity screen's own route for int8 and bf16 tables (WGMMA_WS,
// ops/exact_screen.py "bf16_ws"): screen_ws_kernel<STORE>, the same
// contract (keys, ties, l2 selected squared, the scale multiplying the
// Gram before the metric, masked columns at +inf, segments, the merge
// kernel) built for what those stores allow. Their products are exact in
// bf16 (an int8 value is, and the query is rounded to bf16 by contract),
// so the Gram runs as bf16 wgmma (m64n64k16, f32 sums) at twice TF32's
// rate, reading half the bytes of the widened boxes above. A block is 5
// warpgroups:
// * one producer warpgroup (setmaxnreg 40). One thread keeps the ring
//   full with TMA: bf16 rows land as they lie in device memory, already
//   in the 128-byte swizzle wgmma reads (64 bf16 a swizzle row), 4 tiles
//   of 64 rows deep; int8 rows land raw, 4 tiles deep, and the
//   warpgroup's 128 threads widen each into a bf16 swizzled tile (a ring
//   of 3; int8 -> bf16 is exact, a prmt and an fadd a value), half the
//   bytes the f32 boxes above take. The conversion stays off the
//   consumers, so the table is not the register-sourced A operand: in
//   the capacity split (tools/screen_split.py --capacity, 1M x 128,
//   kk 26) the kernel above spends ~2.0 of its 4.7 ms selecting and ~0.9
//   in the epilogue, and here the selection is still the largest share
//   (~1.4 of 2.3 ms) while the producer's TMA and widening alone take
//   ~0.9. The same threads stage each tile's norms, mask and scales
//   beside it, loaded a tile ahead;
// * four consumer warpgroups (setmaxnreg 104), each with its own tile of
//   64 queries, rounded to bf16 once (round to nearest even, as
//   ops/distance.bf16_round) into the K-major swizzled layout and kept
//   resident for the whole segment (q_sq stays the f32 norm). A
//   consumer waits for a tile once, runs its product (D / 16 wgmma),
//   waits on the product once, computes the metric in its accumulator
//   registers and releases the stage; then it selects straight from the
//   registers: a warp owns 16 query rows (the accumulator's layout: a
//   row's values lie in the four lanes of a quad) and keeps their lists
//   in registers too, each in its quad's lanes, 8 entries a lane (so
//   k_sel <= 32); a lane flags its values at or below its rows' current
//   worst distance, and all 16 rows insert their flagged keys together,
//   with shuffles inside each quad. No distance tile is written, no
//   barrier spans warps after the set-up, and while one consumer runs its
//   epilogue and selection the others' products and the producer's copies
//   and conversion run beside it.
// Shared memory: the resident queries (4 x 64 x D bf16, 64 KiB at D =
// 128), the ring (bf16 4 x 16 KiB; int8 4 x 8 + 3 x 16 KiB at D = 128),
// the tiles' norms / mask / scales and the barriers: 133 KiB for bf16 and
// 148 KiB for int8 at D = 128, one block an SM (16 consumer warps, as
// two blocks of the kernel above); up to D = 192 fits 227 KB. A segment
// costs its lists' fill again (about k_sel (1 + ln(segment / k_sel))
// inserts a query), so the wrapper plans one wave of blocks, not two.
// Elsewhere (k_sel past 32, D past 192: ops/exact_screen.ws_applies) the
// capacity screen keeps the kernel above.

#include <cuda.h>  // CUtensorMap and its enums (types only, no driver link)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int TQ = 64;   // queries per block
constexpr int TC = 128;  // table columns per tile
constexpr int NT = 256;  // threads per block
constexpr int MERGE_THREADS = 256;
constexpr float INF_DIST = 3.0e38f;  // ops/distance.py INF_DIST
constexpr long long EMPTY = LLONG_MAX;

enum Metric { COSINE = 0, L2 = 1, SQEUCLIDEAN = 2, DOT = 3 };
// The producer of the ring (ops/exact_screen.py ROUTES, CAPACITY_ROUTES);
// WGMMA_WS is screen_ws_kernel, the capacity screen's int8 / bf16 route.
enum Route { WGMMA = 1, WGMMA_CP = 2, WGMMA_LD = 3, WGMMA_WS = 4 };
// The table's store and the product's precision (ops/exact_screen.py
// STORES): float32 at f32 accuracy or with fast_math's bf16 operands, and
// the capacity modes' int8 (with per-row scales), bf16 and fp16 tables.
enum Store { F32 = 0, F32_FAST = 1, I8 = 2, BF16 = 3, F16 = 4 };

constexpr int WK = 32;                     // f32 per 128-byte swizzle row
constexpr int STAGES = 2;                  // ring depth
constexpr int Q_BOX = TQ * WK * 4;         // 8 KiB query box
constexpr int V_BOX = TC * WK * 4;         // 16 KiB table box
constexpr int X_BYTES = Q_BOX + V_BOX;     // what an f32 producer lands
constexpr int V_HALF = V_BOX / 2;          // one warpgroup's 64 table rows
constexpr int WCS = TC + 8;  // distance-tile stride: the epilogue's float2
                             // stores of a half-warp hit 32 distinct banks
constexpr int DT_BYTES = TQ * WCS * 4;     // the distance tile

__host__ __device__ constexpr bool reduced(int s) { return s >= I8; }
// bytes of one table value as it lies in device memory
__host__ __device__ constexpr int elem_bytes(int s) {
  return s == I8 ? 1 : reduced(s) ? 2 : 4;
}
// the raw rows of a reduced stage: [TC][WK] values, row-major, unswizzled
__host__ __device__ constexpr int raw_box(int s) {
  return TC * WK * elem_bytes(s);
}
// where they land: past the f32 boxes (and F16's query lo box)
__host__ __device__ constexpr int raw_offset(int s) {
  return X_BYTES + (s == F16 ? Q_BOX : 0);
}
__host__ __device__ constexpr int round_1k(int b) {
  return (b + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }
// Every store but F32_FAST keeps the distance tile in the stage its last k
// block used, so a stage holds at least the tile; stages stay 1024-byte
// multiples (the swizzle atoms' alignment).
__host__ __device__ constexpr int stage_bytes(int s) {
  return s == F32        ? 2 * X_BYTES  // + the lo buffers
         : s == F32_FAST ? X_BYTES
                         : max_int(round_1k(raw_offset(s) + raw_box(s)),
                                   round_1k(DT_BYTES));
}
__host__ __device__ constexpr bool dt_in_ring(int s) { return s != F32_FAST; }

// fast_math rounds both Gram operands to bf16; products and sums stay f32,
// which is bf16 x bf16 with f32 output.
__device__ __forceinline__ float bf16_value(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
// last entry; c < L[k - 1] on entry. Called by a whole warp (any k). The
// shift runs 32 entries at a time from the top down to c's place: a
// chunk reads the entry below each of its own before it writes them, and
// the chunks below it are still untouched.
__device__ __forceinline__ void warp_insert(long long* L, int k, long long c,
                                            int lane) {
  const int chunks = (k + 31) / 32;
  int pos = 0;
  for (int s = 0; s < chunks; ++s) {
    const int e = lane + 32 * s;
    const unsigned below = __ballot_sync(0xffffffffu, e < k && L[e] < c);
    pos += __popc(below);
    if (below != 0xffffffffu) break;  // the list is sorted: c's place found
  }
  for (int s = chunks - 1; s >= pos / 32; --s) {
    const int e = lane + 32 * s;
    const long long v = e > pos && e < k ? L[e - 1] : c;
    __syncwarp();
    if (e >= pos && e < k) L[e] = v;
    __syncwarp();
  }
}

// Empty key lists and the f32 squared query norms (before any rounding).
__device__ __forceinline__ void init_block(long long* lists, float* qsq,
                                           const float* queries, int q0,
                                           int nq, int d, int k_sel,
                                           int tid) {
  for (int i = tid; i < TQ * k_sel; i += NT) lists[i] = EMPTY;
  if (tid < TQ) {
    float s = 0.f;
    if (q0 + tid < nq) {
      const float* row = queries + (size_t)(q0 + tid) * d;
      for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
    }
    qsq[tid] = s;
  }
}

// The distance of a list key; INF_DIST for EMPTY.
__device__ __forceinline__ float key_dist(long long key) {
  if (key == EMPTY) return INF_DIST;
  int m = (int)(key >> 32);
  return __int_as_float(m >= 0 ? m : INT_MIN - m);
}

// Selection of one [TQ, TC] distance tile (row stride WCS): one warp per
// query row, a candidate is inserted only if it beats the row's current
// worst key. A row's list only holds columns left of the candidate's
// (tiles, chunks and lanes go left to right), so a candidate at the worst
// distance never beats the worst key: comparing distances is exact, and
// only winners are packed. A row is visited only if the epilogue flagged
// a distance below thr[row], its worst distance when the tile began; the
// warp then clears the flag and lowers thr.
__device__ __forceinline__ void select_tile(long long* lists, const float* dt,
                                            int k_sel, int c0, int warp,
                                            int lane, int* hit, float* thr) {
  for (int row = warp; row < TQ; row += NT / 32) {
    if (!hit[row]) continue;
    long long* L = lists + row * k_sel;
    float worst = key_dist(L[k_sel - 1]);
#pragma unroll
    for (int r = 0; r < TC / 32; ++r) {
      const float dist = dt[row * WCS + lane + 32 * r];
      unsigned b = __ballot_sync(0xffffffffu, dist < worst);
      while (b) {
        const int src = __ffs(b) - 1;
        const float d = __shfl_sync(0xffffffffu, dist, src);
        warp_insert(L, k_sel, pack_key(d, c0 + 32 * r + src), lane);
        worst = key_dist(L[k_sel - 1]);
        b = __ballot_sync(0xffffffffu, dist < worst) & ~((2u << src) - 1u);
      }
    }
    if (lane == 0) {
      hit[row] = 0;
      thr[row] = worst;
    }
  }
}

__device__ __forceinline__ void write_partial(const long long* lists,
                                              long long* partial, int q0,
                                              int nq, int seg, int n_seg,
                                              int k_sel, int tid) {
  for (int i = tid; i < TQ * k_sel; i += NT) {
    int row = i / k_sel, e = i % k_sel;
    if (q0 + row < nq)
      partial[((size_t)(q0 + row) * n_seg + seg) * k_sel + e] = lists[i];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// A plain arrival (release at the block's scope): the ordinary-load
// producer's stores before it are seen by every thread whose wait ends.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzle
// atoms (8 rows x 128 bytes, 1024-byte aligned): start address >> 4, the
// leading offset unused for this layout (1), the stride between 8-row
// groups 1024 bytes, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// acc[64 x 64] (+)= A[64 x 8] * B[64 x 8]^T, both tf32 from shared memory;
// scale_d = 0 overwrites acc.
__device__ __forceinline__ void mma_tf32(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving accumulator accesses across the async
// wgmma fence / wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// TMA producer of an f32 table, one thread: arm the stage's barrier for
// X_BYTES and start both boxes.
__device__ __forceinline__ void issue_stage(unsigned char* st, uint64_t* bar,
                                            const CUtensorMap* tq,
                                            const CUtensorMap* tv, int k0,
                                            int q0, int c0) {
  mbar_expect_tx(bar, X_BYTES);
  tma_load_2d(st, tq, k0, q0, bar);
  tma_load_2d(st + Q_BOX, tv, k0, c0, bar);
}

// One cp.async of E f32 (4 or 8 bytes) into shared memory at dst; ok =
// false copies no byte (src-size 0) and zero-fills the piece.
template <int E>
__device__ __forceinline__ void cp_piece(uint32_t dst, const float* src,
                                         bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
               "l"(src), "n"(4 * E), "r"(ok ? 4 * E : 0)
               : "memory");
}

// cp.async producer, every thread: its share of the [ROWS x WK] box at
// rows r0.., columns k0.. of the row-major [rows, d] matrix src, into dst
// in TMA's 128-byte swizzle (in each 8-row x 128-byte atom, the 16-byte
// chunk c of row r lands at chunk c ^ (r % 8)). A thread keeps one
// column (pair) and walks rows 8E apart, so its row % 8, and with it its
// swizzled byte in the row, never changes; a warp reads 128 contiguous
// bytes of the matrix (one row, or two for E = 2). Pieces past d or past
// `rows` are zero-filled, so the k tail and the ragged rows add nothing.
template <int ROWS, int E>
__device__ __forceinline__ void cp_box(unsigned char* dst, const float* src,
                                       int rows, int d, int r0, int k0,
                                       int tid) {
  constexpr int LANES = WK / E;     // threads a row
  constexpr int STEP = NT / LANES;  // rows a pass: 8E
  const int kk = (tid % LANES) * E;
  const int r = tid / LANES;
  const uint32_t s =
      smem_u32(dst) + r * 128 + (((kk / 4) ^ (r % 8)) * 16) + (kk % 4) * 4;
  const bool col_ok = k0 + kk < d;
  const float* g = src + (size_t)(r0 + r) * d + k0 + kk;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const bool ok = col_ok && r0 + r + i * STEP < rows;
    cp_piece<E>(s + i * STEP * 128, ok ? g + (size_t)i * STEP * d : src, ok);
  }
}

__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
          smem_u32(bar))
      : "memory");
}

// cp.async producer of an f32 table, every thread: both boxes of a stage,
// then an arrive on its barrier (initialised with NT) once this thread's
// copies landed.
template <int E>
__device__ __forceinline__ void cp_stage(unsigned char* st, uint64_t* bar,
                                         const float* queries,
                                         const float* vectors, int nq, int n,
                                         int d, int k0, int q0, int c0,
                                         int tid) {
  cp_box<TQ, E>(st, queries, nq, d, q0, k0, tid);
  cp_box<TC, E>(st + Q_BOX, vectors, n, d, c0, k0, tid);
  cp_arrive(bar);
}

// Ordinary-load producer, every thread: the f32 query box in the swizzle
// (a warp reads 32 consecutive values of a row), then the raw table box
// row-major, zeros past d and past the matrices.
template <int S>
__device__ __forceinline__ void ld_stage(unsigned char* st,
                                         const float* queries,
                                         const unsigned char* table, int nq,
                                         int n, int d, int k0, int q0, int c0,
                                         int tid) {
  {
    const int kk = tid % WK, r = tid / WK;  // 8 rows a pass
    const bool col_ok = k0 + kk < d;
#pragma unroll
    for (int i = 0; i < TQ / (NT / WK); ++i) {
      const int row = r + i * (NT / WK);
      const bool ok = col_ok && q0 + row < nq;
      const float x = ok ? queries[(size_t)(q0 + row) * d + k0 + kk] : 0.f;
      *reinterpret_cast<float*>(st + row * 128 +
                                (((kk / 4) ^ (row % 8)) * 16) +
                                (kk % 4) * 4) = x;
    }
  }
  unsigned char* raw = st + raw_offset(S);
#pragma unroll
  for (int i = 0; i < TC * WK / NT; ++i) {
    const int e = tid + i * NT;
    const int row = e / WK, col = k0 + e % WK;
    const bool ok = c0 + row < n && col < d;
    const size_t at = (size_t)(c0 + row) * d + col;
    if constexpr (elem_bytes(S) == 1) {
      raw[e] = ok ? table[at] : 0;
    } else {
      reinterpret_cast<uint16_t*>(raw)[e] =
          ok ? reinterpret_cast<const uint16_t*>(table)[at] : 0;
    }
  }
}

// Four raw table values (row-major in the raw box) widened to f32, each
// exactly.
template <int S>
__device__ __forceinline__ float4 widen4(const unsigned char* p) {
  if constexpr (S == I8) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    if constexpr (S == BF16) {  // a bf16 is the high half of its f32
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    } else {
      return make_float4(
          __half2float(__ushort_as_half((unsigned short)(u.x & 0xffffu))),
          __half2float(__ushort_as_half((unsigned short)(u.x >> 16))),
          __half2float(__ushort_as_half((unsigned short)(u.y & 0xffffu))),
          __half2float(__ushort_as_half((unsigned short)(u.y >> 16))));
    }
  }
}

// The landed stage's conversion pass, then its product into acc (this
// warpgroup's 64 x 64 half). Every thread of the block calls it. The pass
// rewrites each value at its own byte offset, so the swizzle stands;
// first = overwrite acc instead of adding.
template <int S>
__device__ __forceinline__ void stage_product(float (&acc)[32],
                                              unsigned char* st, int tid,
                                              int wg, bool first) {
  float4* x = reinterpret_cast<float4*>(st);
  float4* lo = reinterpret_cast<float4*>(st + X_BYTES);
  if constexpr (!reduced(S)) {  // both f32 boxes
#pragma unroll
    for (int r = 0; r < X_BYTES / 16 / NT; ++r) {
      const int i = tid + r * NT;
      float4 v = x[i];
      if (S == F32_FAST) {
        x[i] = make_float4(bf16_value(v.x), bf16_value(v.y),
                           bf16_value(v.z), bf16_value(v.w));
      } else {
        float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                               tf32_rna(v.w));
        x[i] = h;
        lo[i] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                            tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
      }
    }
  } else {
    // the query box: bf16-rounded (I8, BF16), or hi / lo (F16)
#pragma unroll
    for (int r = 0; r < Q_BOX / 16 / NT; ++r) {
      const int i = tid + r * NT;
      const float4 v = x[i];
      if (S == F16) {
        const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y),
                                     tf32_rna(v.z), tf32_rna(v.w));
        x[i] = h;
        lo[i] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                            tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
      } else {
        x[i] = make_float4(bf16_value(v.x), bf16_value(v.y),
                           bf16_value(v.z), bf16_value(v.w));
      }
    }
    // the table: 16-byte chunk j of the swizzled f32 box is row j / 8's
    // chunk (j % 8) ^ (row % 8), i.e. its values 4c .. 4c + 3 in the raw
    // box; a warp reads 128 (int8) or 256 contiguous raw bytes
    const unsigned char* raw = st + raw_offset(S);
    float4* vbox = reinterpret_cast<float4*>(st + Q_BOX);
#pragma unroll
    for (int r = 0; r < V_BOX / 16 / NT; ++r) {
      const int j = tid + r * NT;
      const int row = j / 8, c = (j % 8) ^ (row % 8);
      vbox[j] = widen4<S>(raw + (row * WK + 4 * c) * elem_bytes(S));
    }
  }
  // generic-proxy writes -> visible to wgmma's async-proxy reads
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const uint32_t base = smem_u32(st);
  const uint64_t a_hi = smem_desc(base);
  const uint64_t b_hi = smem_desc(base + Q_BOX + wg * V_HALF);
  const uint64_t a_lo = smem_desc(base + X_BYTES);
  const uint64_t b_lo = smem_desc(base + X_BYTES + Q_BOX + wg * V_HALF);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#ifndef SPLIT_NO_PRODUCT
#pragma unroll
  for (int k = 0; k < WK / 8; ++k) {
    const int off = 2 * k;  // 8 tf32 = 32 bytes, in 16-byte units
    const int keep = (first && k == 0) ? 0 : 1;
    if (S == F32) {  // 3xTF32, small terms first
      mma_tf32(acc, a_hi + off, b_lo + off, keep);
      mma_tf32(acc, a_lo + off, b_hi + off, 1);
      mma_tf32(acc, a_hi + off, b_hi + off, 1);
    } else if (S == F16) {  // 2xTF32: the exact table, the query split
      mma_tf32(acc, a_lo + off, b_hi + off, keep);
      mma_tf32(acc, a_hi + off, b_hi + off, 1);
    } else {  // one pass: F32_FAST, I8, BF16
      mma_tf32(acc, a_hi + off, b_hi + off, keep);
    }
  }
#endif  // SPLIT_NO_PRODUCT
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);
}

// A distance in the selection domain: l2 is kept squared (the square root
// is monotone; the merge kernel takes it at the end).
template <int M>
__device__ __forceinline__ float select_dist(float g, float qq, float vq) {
  if (M == DOT) return -g;
  if (M == COSINE) return 1.f - g * rsqrtf(qq * vq + 1e-30f);
  return fmaxf(qq + vq - 2.f * g, 0.f);
}

// The Gram's factor a column: none (f32, bf16 and fp16 tables), or the
// int8 rows' scales, s[c] for column c of the tile.
struct NoScale {
  static constexpr bool on = false;
  const float* s;
};
struct RowScale {
  static constexpr bool on = true;
  const float* s;
};

// Metric epilogue of this warpgroup's 64 x 64 accumulator into the
// distance tile dt (stride WCS): register 4j + 2h + e holds row r0 + 8h,
// column 8j + 2(lane % 4) + e of the half. The Gram is scaled first (int8
// rows), then the metric; pen[c] is 0, or +inf for a masked column (so
// its distance is +inf, never selected); a row with a distance below its
// threshold is flagged for the selection.
template <int M, class SC>
__device__ __forceinline__ void epilogue(const float (&acc)[32], float* dt,
                                         const float* qsq, const float* thr,
                                         int* hit, const float* vqs,
                                         const float* pen, SC scale, int r0,
                                         int wg, int lane) {
  const float qq0 = qsq[r0], qq1 = qsq[r0 + 8];
  const float t0 = thr[r0], t1 = thr[r0 + 8];
  bool beats0 = false, beats1 = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cc = wg * 64 + 8 * j + 2 * (lane % 4);
    const float2 vq = *reinterpret_cast<const float2*>(vqs + cc);
    const float2 p = *reinterpret_cast<const float2*>(pen + cc);
    float g0 = acc[4 * j], g1 = acc[4 * j + 1];
    float g2 = acc[4 * j + 2], g3 = acc[4 * j + 3];
    if constexpr (SC::on) {
      const float2 s = *reinterpret_cast<const float2*>(scale.s + cc);
      g0 *= s.x;
      g1 *= s.y;
      g2 *= s.x;
      g3 *= s.y;
    }
    const float2 d0 = make_float2(select_dist<M>(g0, qq0, vq.x) + p.x,
                                  select_dist<M>(g1, qq0, vq.y) + p.y);
    const float2 d1 = make_float2(select_dist<M>(g2, qq1, vq.x) + p.x,
                                  select_dist<M>(g3, qq1, vq.y) + p.y);
    beats0 |= d0.x < t0 || d0.y < t0;
    beats1 |= d1.x < t1 || d1.y < t1;
    *reinterpret_cast<float2*>(dt + r0 * WCS + cc) = d0;
    *reinterpret_cast<float2*>(dt + (r0 + 8) * WCS + cc) = d1;
  }
  if (beats0) hit[r0] = 1;
  if (beats1) hit[r0 + 8] = 1;
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// partial[q, seg, :] = ascending k_sel smallest keys of query q over
// columns [seg * seg_len, min(n, (seg + 1) * seg_len)); EMPTY pads.
// TMA: tm_q / tm_v are TMA maps of the queries [nq, d] (box 32 x TQ, 128B
// swizzle) and the table [n, d] (box 32 x TC; f32 in the 128B swizzle, a
// reduced table unswizzled into its raw box), zero fill past the edges
// (the ragged end of N, D past a multiple of 32). cp.async and ordinary
// loads: the maps are unused and the threads copy from queries / table,
// f32 two a copy when pair is set. scales: the int8 rows' [n] scales (I8
// only).
template <int S, int R>
__global__ void __launch_bounds__(NT, 2)
    screen_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_v,
                        const float* __restrict__ queries,
                        const void* __restrict__ table,
                        const float* __restrict__ scales,
                        const float* __restrict__ v_sq,
                        const unsigned char* __restrict__ valid, int nq,
                        int n, int d, int k_sel, int seg_len, int metric,
                        int pair, long long* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SB = stage_bytes(S);
  // the distance tile lives in the stage the tile's last k block used
  // (free until its refill, which waits for the selection), so that two
  // blocks fit an SM at the usual k_sel; F32_FAST keeps its own
  constexpr bool DT_IN_RING = dt_in_ring(S);
  constexpr bool TMA = R == WGMMA;
  const float* vectors = static_cast<const float*>(table);
  const unsigned char* rows = static_cast<const unsigned char*>(table);
  unsigned char* ring = align_1024(smem_raw);                  // [STAGES][SB]
  long long* lists = reinterpret_cast<long long*>(ring + STAGES * SB);
  float* dt_own = reinterpret_cast<float*>(lists + TQ * k_sel);  // [TQ][WCS]
  float* qsq = dt_own + (DT_IN_RING ? 0 : TQ * WCS);           // [TQ]
  float* thr = qsq + TQ;         // [TQ] worst listed distance of each row
  int* hit = reinterpret_cast<int*>(thr + TQ);  // [TQ] row beats thr
  float* vqs = reinterpret_cast<float*>(hit + TQ);  // [TC] the tile's v_sq
  float* pen = vqs + TC;        // [TC] 0, or +inf for a masked column
  float* scl = pen + TC;        // [TC] the tile's int8 row scales (I8)
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(scl + (S == I8 ? TC : 0));   // [STAGES]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = tid / 128;               // warpgroup: column half
  const int r0 = (warp % 4) * 16 + lane / 4;  // accumulator rows r0, r0+8
  const int q0 = blockIdx.x * TQ;
  const int seg = blockIdx.y, n_seg = gridDim.y;
  const int c_begin = seg * seg_len;
  const int c_end = min(n, c_begin + seg_len);
  const int n_kb = (d + WK - 1) / WK;
  const int n_tiles = (c_end - c_begin + TC - 1) / TC;
  const int total = n_tiles * n_kb;  // stage loads, in (tile, k block) order
  // who issues a stage's loads: one thread asks TMA, all threads copy
  const bool issuer = !TMA || tid == 0;

  init_block(lists, qsq, queries, q0, nq, d, k_sel, tid);
  if (tid < TQ) {
    thr[tid] = INF_DIST;
    hit[tid] = 0;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], TMA ? 1 : NT);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the issuers: start stage load l (in (tile, k block) order)
  const CUtensorMap* pq = &tm_q;
  const CUtensorMap* pv = &tm_v;
  auto load = [&](int l) {
    if (l >= total) return;
    unsigned char* st = ring + l % STAGES * SB;
    uint64_t* bar = &bars[l % STAGES];
    const int k0 = (l % n_kb) * WK, c0 = c_begin + (l / n_kb) * TC;
    if constexpr (!reduced(S)) {
      if constexpr (TMA) {
        issue_stage(st, bar, pq, pv, k0, q0, c0);
      } else if (pair) {
        cp_stage<2>(st, bar, queries, vectors, nq, n, d, k0, q0, c0, tid);
      } else {
        cp_stage<1>(st, bar, queries, vectors, nq, n, d, k0, q0, c0, tid);
      }
    } else if constexpr (TMA) {
      mbar_expect_tx(bar, Q_BOX + raw_box(S));
      tma_load_2d(st, pq, k0, q0, bar);
      tma_load_2d(st + raw_offset(S), pv, k0, c0, bar);
    } else {
      ld_stage<S>(st, queries, rows, nq, n, d, k0, q0, c0, tid);
      mbar_arrive(bar);
    }
  };
  if (issuer)
    for (int l = 0; l < STAGES; ++l) load(l);

  float acc[32] = {};
  for (int t = 0, l = 0; t < n_tiles; ++t) {
    const int c0 = c_begin + t * TC;
    // the tile's column norms, mask (and scales), loaded while the product
    // runs (unconditionally, so that nothing waits on them before the
    // epilogue)
    float vq_mine = 0.f, sc_mine = 0.f;
    unsigned char ok_mine = 0;
    if (tid < TC && c0 + tid < c_end) {  // rows past the segment: masked
      vq_mine = v_sq[c0 + tid];
      ok_mine = valid[c0 + tid];
      if (S == I8) sc_mine = scales[c0 + tid];
    }
    for (int kb = 0; kb < n_kb; ++kb, ++l) {
      const int s = l % STAGES;
      mbar_wait(&bars[s], (l / STAGES) & 1);
      stage_product<S>(acc, ring + s * SB, tid, wg, kb == 0);
      __syncthreads();  // every warpgroup's wgmma has read stage s
      if (issuer && !(DT_IN_RING && kb == n_kb - 1)) load(l + STAGES);
    }
    float* dt = DT_IN_RING
                    ? reinterpret_cast<float*>(ring + (l - 1) % STAGES * SB)
                    : dt_own;

    if (tid < TC) {
      vqs[tid] = vq_mine;
      pen[tid] = ok_mine ? 0.f : __int_as_float(0x7f800000);
      if (S == I8) scl[tid] = sc_mine;
    }
    __syncthreads();

    using Scale = typename std::conditional<S == I8, RowScale, NoScale>::type;
    const Scale scale{scl};
#ifndef SPLIT_NO_EPILOGUE
    switch (metric) {  // one branch a tile, none a value
      case COSINE:
        epilogue<COSINE>(acc, dt, qsq, thr, hit, vqs, pen, scale, r0, wg,
                         lane);
        break;
      case DOT:
        epilogue<DOT>(acc, dt, qsq, thr, hit, vqs, pen, scale, r0, wg, lane);
        break;
      default:  // l2 selects on the squared distance, as sqeuclidean
        epilogue<SQEUCLIDEAN>(acc, dt, qsq, thr, hit, vqs, pen, scale, r0,
                              wg, lane);
    }
#endif  // SPLIT_NO_EPILOGUE
    __syncthreads();
#ifndef SPLIT_NO_SELECT
    select_tile(lists, dt, k_sel, c0, warp, lane, hit, thr);
#endif  // SPLIT_NO_SELECT
    if (DT_IN_RING)  // generic-proxy use of dt before the refill rewrites it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (DT_IN_RING && issuer) load(l - 1 + STAGES);
  }
  write_partial(lists, partial, q0, nq, seg, n_seg, k_sel, tid);
}

static_assert(DT_BYTES <= stage_bytes(F32) && DT_BYTES <= stage_bytes(I8) &&
                  DT_BYTES <= stage_bytes(BF16) &&
                  DT_BYTES <= stage_bytes(F16),
              "the distance tile fits one stage wherever it lives there");

// ---- the capacity screen's warp-specialised route (WGMMA_WS) --------------

constexpr int WS_NC = 4;                   // consumer warpgroups
constexpr int WS_NT = 128 * (WS_NC + 1);   // + the producer warpgroup
constexpr int WS_TQ = 64 * WS_NC;          // queries a block, 64 a consumer
constexpr int WS_TC = 64;                  // table rows (columns) a tile
constexpr int WS_KB = 64;                  // bf16 a 128-byte swizzle row
constexpr int WS_QBOX = 64 * 128;          // a k block of a query tile
constexpr int WS_VBOX = WS_TC * 128;       // a k block of a bf16 tile
constexpr int WS_RBOX = WS_TC * WS_KB;     // a k block of a raw int8 tile
constexpr int WS_STAGES_BF16 = 4;          // bf16 tiles in the ring
constexpr int WS_STAGES_I8 = 3;            // int8: widened tiles in the ring
constexpr int WS_RAW = 4;                  // int8: raw tiles in flight
constexpr int WS_PRODUCER_REGS = 40;       // setmaxnreg of the producer
constexpr int WS_CONSUMER_REGS = 104;      // and of the consumers
constexpr int WS_K_MAX = 32;               // a list: 8 entries x 4 lanes
// Past every cudaError_t, below ERR_TMA: the compiled kernel's registers
// cannot cover the setmaxnreg budget above (its launch could wait
// forever for registers), so it is not launched.
constexpr int ERR_REGS = 90000;

__host__ __device__ constexpr int ws_stages(int s) {
  return s == I8 ? WS_STAGES_I8 : WS_STAGES_BF16;
}

// Dynamic shared memory of screen_ws_kernel<store> at this D
// (ops/exact_screen.ws_smem_bytes repeats it): the alignment slack, the
// resident queries, the ring (and int8's raw tiles), the tiles' norms /
// mask / scales, the query norms and the barriers. The lists live in
// registers.
size_t ws_smem_bytes(int d, int store) {
  const size_t n_kb = (d + WS_KB - 1) / WS_KB, ns = ws_stages(store);
  const bool i8 = store == I8;
  return 1024 + WS_NC * n_kb * WS_QBOX + ns * n_kb * WS_VBOX +
         (i8 ? WS_RAW * n_kb * WS_RBOX : 0) + ns * 3 * WS_TC * sizeof(float) +
         WS_TQ * sizeof(float) +
         (2 * ns + (i8 ? 2 * WS_RAW : 0)) * sizeof(uint64_t);
}

// acc[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T, both bf16 K-major from
// shared memory (128-byte swizzle), f32 sums; scale_d = 0 overwrites acc.
__device__ __forceinline__ void mma_bf16(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Two f32 rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Four int8 (the bytes of w, lowest first) as four bf16, exactly: byte b
// + 128 becomes the low mantissa byte of 2^23, the f32 subtraction leaves
// b, and the top half of an f32 with <= 8 significant bits is its bf16.
__device__ __forceinline__ uint2 i8x4_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float m = 8388736.f;  // 2^23 + 128
  const uint32_t f0 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - m);
  const uint32_t f1 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - m);
  const uint32_t f2 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - m);
  const uint32_t f3 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - m);
  return make_uint2(__byte_perm(f0, f1, 0x7632), __byte_perm(f2, f3, 0x7632));
}

// mbar_wait for screen_ws_kernel's roles, which wait on each other: a
// wait past ~2^34 cycles (seconds) traps, so a fault in the hand-offs
// ends the launch with an error instead of holding the card.
__device__ __forceinline__ void ws_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The metric of one consumer's 64 x 64 accumulator, in place: register
// 4j + 2h + e holds row r0 + 8h, column 8j + 2(lane % 4) + e of the tile
// (vq, pen, scl: the tile's norms, 0 / +inf mask and int8 scales). The
// Gram is scaled first (int8 rows), then the metric, as the kernel above.
// Returns the lane's flags: bit i set where distance i is at or below its
// row's current worst (thr0 for row r0, thr1 for r0 + 8).
template <int M, bool SCALE>
__device__ __forceinline__ unsigned ws_epilogue(float (&acc)[32],
                                                const float* vq,
                                                const float* pen,
                                                const float* scl, float qq0,
                                                float qq1, float thr0,
                                                float thr1, int lane) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cc = 8 * j + 2 * (lane % 4);
    const float2 v = *reinterpret_cast<const float2*>(vq + cc);
    const float2 p = *reinterpret_cast<const float2*>(pen + cc);
    float2 s = make_float2(1.f, 1.f);
    if (SCALE) s = *reinterpret_cast<const float2*>(scl + cc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        float g = acc[i];
        if (SCALE) g *= e ? s.y : s.x;
        const float dist =
            select_dist<M>(g, h ? qq1 : qq0, e ? v.y : v.x) + (e ? p.y : p.x);
        acc[i] = dist;
        m |= (unsigned)(dist <= (h ? thr1 : thr0)) << i;
      }
    }
  }
  return m;
}

// The lane's distance number sel = 4j + 2H + e of row half H: a select
// tree of depth 4 over its 16 values of that half, by e, then the bits
// of j (plain scalars: an array here would go to local memory).
template <int H>
__device__ __forceinline__ float ws_pick(const float (&d)[32], int sel) {
  const bool e = sel & 1, j0 = sel & 4, j1 = sel & 8, j2 = sel & 16;
#define WS_AT(j) (e ? d[4 * (j) + 2 * H + 1] : d[4 * (j) + 2 * H])
  const float b0 = j0 ? WS_AT(1) : WS_AT(0), b1 = j0 ? WS_AT(3) : WS_AT(2);
  const float b2 = j0 ? WS_AT(5) : WS_AT(4), b3 = j0 ? WS_AT(7) : WS_AT(6);
#undef WS_AT
  const float c0 = j1 ? b1 : b0, c1 = j1 ? b3 : b2;
  return j2 ? c1 : c0;
}

// A row's list lives in the four lanes of its quad: lane 4q + t holds its
// entries 8t .. 8t + 7 (ascending through the quad; k_sel <= 32, entries
// from k_sel on are never read). The quad's worst key, entry k_sel - 1:
__device__ __forceinline__ long long quad_worst(const long long (&l)[8],
                                                int k_sel, int lane) {
  const int e = k_sel - 1;
  long long v = l[0];
#pragma unroll
  for (int r = 1; r < 8; ++r) v = (e & 7) == r ? l[r] : v;
  return __shfl_sync(0xffffffffu, v, (lane & ~3) | (e >> 3));
}

// Inserts key c into the quad's list where ins (the quad's lanes agree on
// c and ins; every lane of the warp calls it, for its own quad's row): c
// goes to position pos, the number of entries below it, and the entries
// from pos on move up one place, the lane's first taking the previous
// lane's last.
__device__ __forceinline__ void quad_insert(long long (&l)[8], long long c,
                                            bool ins, int lane) {
  int below = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) below += l[r] < c;
  int pos = below + __shfl_xor_sync(0xffffffffu, below, 1);
  pos += __shfl_xor_sync(0xffffffffu, pos, 2);
  const long long carry = __shfl_up_sync(0xffffffffu, l[7], 1);
  const int first = 8 * (lane & 3);
  if (ins) {
#pragma unroll
    for (int r = 7; r >= 0; --r) {
      const int p = first + r;
      const long long prev = r ? l[r - 1] : carry;
      l[r] = p < pos ? l[r] : p == pos ? c : prev;
    }
  }
}

// Selection of one consumer warp's 16 rows straight from the registers
// into their register-resident lists (quad q holds row q, la, and row
// q + 8, lb: the accumulator's register 4j + 2h + e of lane 4q + t is
// row q + 8h). All 16 rows advance together: each step, every quad with
// flagged distances left takes the lowest flagged one of one of its
// lanes for each of its two rows and inserts its key where it beats the
// row's worst key (the exact test: a key at the worst distance with a
// lower id still enters, so the order of the insertions does not
// matter); ballots and shuffles, no shared memory. w0 / w1: the rows'
// worst keys; the lanes' thresholds for the next tile (thr0 for row q,
// thr1 for row q + 8) are their distances.
__device__ __forceinline__ void ws_select(const float (&dist)[32],
                                          unsigned m, long long (&la)[8],
                                          long long (&lb)[8], long long& w0,
                                          long long& w1, int k_sel, int c0,
                                          int lane, float& thr0,
                                          float& thr1) {
  constexpr unsigned ALL = 0xffffffffu;
  unsigned f0 = m & 0x33333333u, f1 = m & 0xCCCCCCCCu;  // h = 0, h = 1
  const int base = lane & ~3, t = lane & 3;
  while (true) {
    const unsigned b0 = __ballot_sync(ALL, f0 != 0);
    const unsigned b1 = __ballot_sync(ALL, f1 != 0);
    if (!(b0 | b1)) break;
    // the quad's first lane with a flag left, -1 where none is
    const int src0 = __ffs((b0 >> base) & 0xFu) - 1;
    const int src1 = __ffs((b1 >> base) & 0xFu) - 1;
    const int s0 = __ffs(f0) - 1, s1 = __ffs(f1) - 1;  // lowest flags
    const float v0 = ws_pick<0>(dist, s0), v1 = ws_pick<1>(dist, s1);
    const int cl0 = c0 + 8 * (s0 >> 2) + 2 * t + (s0 & 1);
    const int cl1 = c0 + 8 * (s1 >> 2) + 2 * t + (s1 & 1);
    const int from0 = base | max(src0, 0), from1 = base | max(src1, 0);
    const long long k0 = pack_key(__shfl_sync(ALL, v0, from0),
                                  __shfl_sync(ALL, cl0, from0));
    const long long k1 = pack_key(__shfl_sync(ALL, v1, from1),
                                  __shfl_sync(ALL, cl1, from1));
    if (src0 == t) f0 &= f0 - 1;
    if (src1 == t) f1 &= f1 - 1;
    quad_insert(la, k0, src0 >= 0 && k0 < w0, lane);
    quad_insert(lb, k1, src1 >= 0 && k1 < w1, lane);
    w0 = quad_worst(la, k_sel, lane);
    w1 = quad_worst(lb, k_sel, lane);
  }
  thr0 = key_dist(w0);
  thr1 = key_dist(w1);
}

// partial[q, seg, :] as screen_wgmma_kernel's, for the int8 (with
// scales) and bf16 tables, warp-specialised (the note at the top). tm_v:
// TMA map of the table [n, d] in [64 x WS_TC] boxes (bf16 in the 128-byte
// swizzle, int8 unswizzled), zero fill past the edges. The queries are
// read once by their consumers.
template <int S>
__global__ void __launch_bounds__(WS_NT, 1)
    screen_ws_kernel(const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ queries,
                     const float* __restrict__ scales,
                     const float* __restrict__ v_sq,
                     const unsigned char* __restrict__ valid, int nq, int n,
                     int d, int k_sel, int seg_len, int metric,
                     long long* __restrict__ partial) {
  static_assert(S == I8 || S == BF16, "int8 or bf16 tables");
  constexpr int NS = ws_stages(S);
  constexpr bool RAW = S == I8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_kb = (d + WS_KB - 1) / WS_KB;
  unsigned char* qs = align_1024(smem_raw);          // [NC][n_kb][QBOX]
  unsigned char* ring = qs + WS_NC * n_kb * WS_QBOX;  // [NS][n_kb][VBOX]
  unsigned char* raw = ring + NS * n_kb * WS_VBOX;    // [RAW][n_kb][RBOX]
  float* aux = reinterpret_cast<float*>(             // [NS][vq|pen|scl][TC]
      raw + (RAW ? WS_RAW * n_kb * WS_RBOX : 0));
  float* qsq = aux + NS * 3 * WS_TC;                              // [TQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(qsq + WS_TQ);     // [NS]
  uint64_t* empty = full + NS;                                    // [NS]
  uint64_t* raw_full = empty + NS;                                // [RAW]
  uint64_t* raw_empty = raw_full + WS_RAW;                        // [RAW]

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int seg = blockIdx.y, n_seg = gridDim.y;
  const int c_begin = seg * seg_len;
  const int c_end = min(n, c_begin + seg_len);
  const int n_tiles = (c_end - c_begin + WS_TC - 1) / WS_TC;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 128);          // the producer warpgroup
      mbar_init(&empty[s], 4 * WS_NC);   // a lane of every consumer warp
    }
    if (RAW)
      for (int r = 0; r < WS_RAW; ++r) {
        mbar_init(&raw_full[r], 1);
        mbar_init(&raw_empty[r], 128);
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        WS_PRODUCER_REGS));
    const int p = tid;
    const CUtensorMap* pv = &tm_v;
    // thread 0: arm bar for a whole tile (its arrival) and start its boxes
    auto issue = [&](int t, uint64_t* bar, unsigned char* dst, int box) {
      mbar_expect_tx(bar, n_kb * box);
      const int c0 = c_begin + t * WS_TC;
      for (int kb = 0; kb < n_kb; ++kb)
        tma_load_2d(dst + kb * box, pv, kb * WS_KB, c0, bar);
    };
    // threads 64..127: one column each of a tile's norms, mask (+inf
    // past the segment) and scales, loaded a tile ahead (the loads are in
    // flight while the thread waits for and fills the current stage) and
    // written into the stage's aux
    const int c_aux = p - (128 - WS_TC);
    float nx_vq = 0.f, nx_pen = 0.f, nx_scl = 0.f;
    auto load_aux = [&](int t) {
      const int col = c_begin + t * WS_TC + c_aux;
      const bool ok = c_aux >= 0 && t < n_tiles && col < c_end;
      nx_vq = ok ? v_sq[col] : 0.f;
      nx_pen = ok && valid[col] ? 0.f : __int_as_float(0x7f800000);
      nx_scl = RAW && ok ? scales[col] : 0.f;
    };
    auto stage_aux = [&](int t, float* a) {
      if (c_aux >= 0) {
        const float vq = nx_vq, pen = nx_pen, scl = nx_scl;
        load_aux(t + 1);
        a[c_aux] = vq;
        a[WS_TC + c_aux] = pen;
        if (RAW) a[2 * WS_TC + c_aux] = scl;
      }
    };
    load_aux(0);
    if constexpr (RAW) {
      if (p == 0)
        for (int t = 0; t < min(WS_RAW, n_tiles); ++t)
          issue(t, &raw_full[t], raw + t * n_kb * WS_RBOX, WS_RBOX);
      for (int t = 0; t < n_tiles; ++t) {
        const int r = t % WS_RAW, s = t % NS;
        ws_wait(&raw_full[r], (t / WS_RAW) & 1);
        if (t >= NS) ws_wait(&empty[s], (t / NS - 1) & 1);
        const unsigned char* src = raw + r * n_kb * WS_RBOX;
        unsigned char* dst = ring + s * n_kb * WS_VBOX;
        // 16 int8 a thread -> two 16-byte chunks of the bf16 row, at the
        // swizzled chunks 2q ^ (row % 8) and (2q + 1) ^ (row % 8)
        for (int it = p; it < n_kb * WS_TC * 4; it += 128) {
          const int kb = it / (WS_TC * 4), row = it / 4 % WS_TC, q = it % 4;
          const uint4 in = *reinterpret_cast<const uint4*>(
              src + kb * WS_RBOX + row * WS_KB + q * 16);
          const uint2 a = i8x4_bf16(in.x), b = i8x4_bf16(in.y);
          const uint2 c = i8x4_bf16(in.z), e = i8x4_bf16(in.w);
          unsigned char* out = dst + kb * WS_VBOX + row * 128;
          *reinterpret_cast<uint4*>(out + (((2 * q) ^ (row & 7)) * 16)) =
              make_uint4(a.x, a.y, b.x, b.y);
          *reinterpret_cast<uint4*>(out + (((2 * q + 1) ^ (row & 7)) * 16)) =
              make_uint4(c.x, c.y, e.x, e.y);
        }
        stage_aux(t, aux + s * 3 * WS_TC);
        // the widened tile -> wgmma's async-proxy reads; the raw tile's
        // generic reads before TMA rewrites it
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&full[s]);
        mbar_arrive(&raw_empty[r]);
        if (p == 0 && t + WS_RAW < n_tiles) {
          ws_wait(&raw_empty[r], (t / WS_RAW) & 1);
          issue(t + WS_RAW, &raw_full[r], raw + r * n_kb * WS_RBOX, WS_RBOX);
        }
      }
    } else {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NS;
        if (t >= NS) ws_wait(&empty[s], (t / NS - 1) & 1);
        if (p == 0) {
          issue(t, &full[s], ring + s * n_kb * WS_VBOX, WS_VBOX);
        } else {
          stage_aux(t, aux + s * 3 * WS_TC);
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- a consumer warpgroup: 64 queries ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        WS_CONSUMER_REGS));
    const int cw = wg - 1, ct = tid - 128 * wg, warp = ct / 32;
    const int qb = blockIdx.x * WS_TQ + 64 * cw;
    const bool active = qb < nq;  // a tile past Q only keeps the ring going
    unsigned char* qa = qs + cw * n_kb * WS_QBOX;
    float* qq = qsq + 64 * cw;
    if (active) {
      // the resident query tile: 8 bf16 (a 16-byte chunk) an item, chunk
      // c of a 128-byte row at c ^ (row % 8), zeros past d and past nq
      for (int i = ct; i < 64 * n_kb * 8; i += 128) {
        const int row = i / (n_kb * 8), ch = i % (n_kb * 8);
        const int k0 = ch * 8;
        const bool rok = qb + row < nq;
        const float* src = queries + (size_t)(qb + row) * d;
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + 2 * e;
          w[e] = bf16x2_bits(rok && k < d ? src[k] : 0.f,
                             rok && k + 1 < d ? src[k + 1] : 0.f);
        }
        *reinterpret_cast<uint4*>(qa + (ch / 8) * WS_QBOX + row * 128 +
                                  (((ch % 8) ^ (row & 7)) * 16)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
      if (ct < 64) {  // the f32 norms, before any rounding
        float s = 0.f;
        if (qb + ct < nq) {
          const float* row = queries + (size_t)(qb + ct) * d;
          for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
        }
        qq[ct] = s;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    named_sync(1 + cw, 128);
    const int r0 = 16 * warp + lane / 4;  // the lane's rows r0, r0 + 8
    const float qq0 = active ? qq[r0] : 0.f, qq1 = active ? qq[r0 + 8] : 0.f;
    float thr0 = INF_DIST, thr1 = INF_DIST;
    // the lists of the lane's quad's rows (r0: la, r0 + 8: lb), entries
    // 8t .. 8t + 7, and their worst keys
    long long la[8], lb[8], w0 = EMPTY, w1 = EMPTY;
#pragma unroll
    for (int r = 0; r < 8; ++r) la[r] = lb[r] = EMPTY;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(qa);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NS, c0 = c_begin + t * WS_TC;
      ws_wait(&full[s], (t / NS) & 1);
      unsigned m = 0;
      if (active) {
        const uint32_t v_addr = smem_u32(ring + s * n_kb * WS_VBOX);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#ifndef SPLIT_NO_PRODUCT
        for (int kb = 0; kb < n_kb; ++kb) {
          const uint64_t da = smem_desc(q_addr + kb * WS_QBOX);
          const uint64_t db = smem_desc(v_addr + kb * WS_VBOX);
#pragma unroll
          for (int k = 0; k < WS_KB / 16; ++k)  // 16 bf16 = 32 bytes a step
            mma_bf16(acc, da + 2 * k, db + 2 * k, (kb | k) ? 1 : 0);
        }
#endif  // SPLIT_NO_PRODUCT
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(acc);
#ifndef SPLIT_NO_EPILOGUE
        const float* a = aux + s * 3 * WS_TC;
        switch (metric) {  // one branch a tile, none a value
          case COSINE:
            m = ws_epilogue<COSINE, RAW>(acc, a, a + WS_TC, a + 2 * WS_TC,
                                         qq0, qq1, thr0, thr1, lane);
            break;
          case DOT:
            m = ws_epilogue<DOT, RAW>(acc, a, a + WS_TC, a + 2 * WS_TC, qq0,
                                      qq1, thr0, thr1, lane);
            break;
          default:  // l2 selects on the squared distance, as sqeuclidean
            m = ws_epilogue<SQEUCLIDEAN, RAW>(acc, a, a + WS_TC,
                                              a + 2 * WS_TC, qq0, qq1, thr0,
                                              thr1, lane);
        }
#endif  // SPLIT_NO_EPILOGUE
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with s
#ifndef SPLIT_NO_SELECT
      if (active)
        ws_select(acc, m, la, lb, w0, w1, k_sel, c0, lane, thr0, thr1);
#else
      asm volatile("" ::"r"(m));  // keeps the epilogue of the split builds
#endif  // SPLIT_NO_SELECT
    }
    if (active) {  // the lane's entries of its quad's two rows
      const int qa0 = qb + r0, qa1 = qb + r0 + 8, e0 = 8 * (lane & 3);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (e0 + r < k_sel && qa0 < nq)
          partial[((size_t)qa0 * n_seg + seg) * k_sel + e0 + r] = la[r];
        if (e0 + r < k_sel && qa1 < nq)
          partial[((size_t)qa1 * n_seg + seg) * k_sel + e0 + r] = lb[r];
      }
    }
  }
}

// The warp-specialised screen of a store; nullptr for a store it does not
// take.
const void* ws_fn(int store) {
  if (store == I8) return reinterpret_cast<const void*>(screen_ws_kernel<I8>);
  if (store == BF16)
    return reinterpret_cast<const void*>(screen_ws_kernel<BF16>);
  return nullptr;
}

size_t wgmma_smem_bytes(int k_sel, int store) {
  return 1024 + (size_t)STAGES * stage_bytes(store) +
         (size_t)TQ * k_sel * sizeof(long long) +
         (size_t)((dt_in_ring(store) ? 0 : TQ * WCS) + 3 * TQ + 2 * TC +
                  (store == I8 ? TC : 0)) *
             sizeof(float) +
         STAGES * sizeof(uint64_t);
}

// cuTensorMapEncodeTiled, looked up through the runtime so the library
// needs no link against the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Past every cudaError_t: ERR_TMA + the CUresult of a tensor map that
// could not be made.
constexpr int ERR_TMA = 100000;

// TMA map of a row-major [rows, d] matrix of `store`'s values in
// [box_rows x 32] boxes: f32 in the 128-byte swizzle, the reduced rows
// (copied as raw 8- or 16-bit values) unswizzled.
int encode_rows(CUtensorMap* map, const void* ptr, int rows, int d,
                int box_rows, int store) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_TMA + CUDA_ERROR_NOT_FOUND;
  const int eb = elem_bytes(store);
  cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)d * eb};
  cuuint32_t box[2] = {(cuuint32_t)WK, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = eb == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : eb == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                             : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                  elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  eb == 4 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMA + (int)r;
}

// TMA map of screen_ws_kernel's table [rows, d] of `store` in [WS_KB x
// WS_TC] boxes: bf16 in the 128-byte swizzle wgmma reads (64 values a
// row), int8 unswizzled (64 bytes a row, widened by the producer).
int encode_ws_rows(CUtensorMap* map, const void* ptr, int rows, int d,
                   int store) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_TMA + CUDA_ERROR_NOT_FOUND;
  const int eb = elem_bytes(store);
  cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)d * eb};
  cuuint32_t box[2] = {(cuuint32_t)WS_KB, (cuuint32_t)WS_TC};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map,
                  eb == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                  2, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  eb == 2 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMA + (int)r;
}

// ---- merge ------------------------------------------------------------------

// out[q, :] = ascending k_sel smallest of query q's n_seg * k_sel keys:
// one block per query, bitonic sort of the padded list in shared memory.
// sqrt_keys: the keys hold squared l2 distances; each becomes the key of
// its square root before the sort.
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const long long* __restrict__ partial, int width, int p2,
                 int k_sel, int sqrt_keys, long long* __restrict__ out) {
  extern __shared__ long long buf[];
  const size_t q = blockIdx.x;
  const long long* src = partial + q * width;
  for (int i = threadIdx.x; i < p2; i += MERGE_THREADS) {
    long long k = i < width ? src[i] : EMPTY;
    if (sqrt_keys && k != EMPTY)
      k = pack_key(sqrtf(key_dist(k)), (int)(unsigned)(k & 0xffffffffLL));
    buf[i] = k;
  }
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

// The (store, route) pairs the library holds: both f32 stores take TMA or
// cp.async (4-byte copies take any f32 table); the reduced stores TMA or
// the ordinary loads (any pitch).
#define SCREEN_KERNELS(X)                                                   \
  X(F32, WGMMA) X(F32, WGMMA_CP) X(F32_FAST, WGMMA) X(F32_FAST, WGMMA_CP)   \
  X(I8, WGMMA) X(I8, WGMMA_LD) X(BF16, WGMMA) X(BF16, WGMMA_LD)             \
  X(F16, WGMMA) X(F16, WGMMA_LD)

// The screen kernel of a route and store; nullptr for a pair the library
// does not hold.
const void* screen_fn(int route, int store) {
#define SCREEN_FN(S, R)                                         \
  if (store == S && route == R)                                 \
    return reinterpret_cast<const void*>(screen_wgmma_kernel<S, R>);
  SCREEN_KERNELS(SCREEN_FN)
#undef SCREEN_FN
  return nullptr;
}

// The merge of the segments' lists into out; every screen selects l2 on
// the squared distance.
int merge(const long long* partial, int nq, int n_seg, int k_sel,
          int metric, void* out, cudaStream_t st) {
  int width = n_seg * k_sel, p2 = 1;
  while (p2 < width) p2 <<= 1;
  merge_kernel<<<nq, MERGE_THREADS, p2 * sizeof(long long), st>>>(
      partial, width, p2, k_sel, metric == L2, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A block's queries and a tile's columns of a route, so the Python wrapper
// can plan segments without copying them.
int exact_screen_tile_queries(int route) {
  return route == WGMMA_WS ? WS_TQ : TQ;
}
int exact_screen_tile_columns(int route) {
  return route == WGMMA_WS ? WS_TC : TC;
}

// Dynamic shared memory of a route's screen at this D, k_sel and store.
size_t exact_screen_smem_bytes(int route, int d, int k_sel, int store) {
  return route == WGMMA_WS ? ws_smem_bytes(d, store)
                           : wgmma_smem_bytes(k_sel, store);
}

// Resident screen blocks per SM for this route, D, k_sel and store (0
// f32, 1 f32 fast_math, 2 int8, 3 bf16, 4 fp16); negative cudaError_t on
// failure (a route the store does not take, or shared memory past the
// card's).
int exact_screen_blocks_per_sm(int route, int d, int k_sel, int store) {
  const bool ws = route == WGMMA_WS;
  const void* fn = ws ? ws_fn(store) : screen_fn(route, store);
  if (fn == nullptr || (ws && k_sel > WS_K_MAX))
    return -(int)cudaErrorInvalidValue;
  size_t smem = exact_screen_smem_bytes(route, d, k_sel, store);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                    ws ? WS_NT : NT, smem);
  return e != cudaSuccess ? -(int)e : blocks;
}

// Screen (route: 1 wgmma = TMA producer, 2 wgmma_cp = cp.async producer,
// f32 stores only, 3 wgmma_ld = ordinary loads, reduced stores only, 4
// the warp-specialised bf16 screen, int8 and bf16 stores only) + merge on
// `stream`.
// vectors: the [n, d] table of `store` (f32, int8, bf16 or fp16 values);
// scales: its [n] f32 row scales for int8, else unused. partial: [nq,
// n_seg, k_sel] int64 scratch; out: [nq, k_sel] int64 keys. Returns the
// cudaError_t of the launches, ERR_TMA + CUresult when a TMA map fails, or
// ERR_REGS (route 4) when the kernel's registers cannot cover its
// setmaxnreg budget.
int exact_screen_launch(int route, const void* queries, const void* vectors,
                        const void* scales, const void* v_sq,
                        const void* valid, int nq, int n, int d, int k_sel,
                        int n_seg, int seg_len, int metric, int store,
                        void* partial, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ws = route == WGMMA_WS;
  const void* fn = ws ? ws_fn(store) : screen_fn(route, store);
  if (fn == nullptr || (ws && k_sel > WS_K_MAX))
    return (int)cudaErrorInvalidValue;
  size_t smem = exact_screen_smem_bytes(route, d, k_sel, store);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float* qp = static_cast<const float*>(queries);
  const float* scp = static_cast<const float*>(scales);
  const float* sqp = static_cast<const float*>(v_sq);
  const unsigned char* okp = static_cast<const unsigned char*>(valid);
  long long* pp = static_cast<long long*>(partial);
  if (ws) {
    // the producer gives up registers for the consumers: the block's
    // allocation must hold both budgets
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, fn);
    if (e != cudaSuccess) return (int)e;
    if ((long)fa.numRegs * WS_NT <
        128L * WS_PRODUCER_REGS + 128L * WS_NC * WS_CONSUMER_REGS)
      return ERR_REGS;
    CUtensorMap tv = {};
    const int rc = encode_ws_rows(&tv, vectors, n, d, store);
    if (rc != 0) return rc;
    dim3 grid_ws((nq + WS_TQ - 1) / WS_TQ, n_seg);
    if (store == I8)
      screen_ws_kernel<I8><<<grid_ws, WS_NT, smem, st>>>(
          tv, qp, scp, sqp, okp, nq, n, d, k_sel, seg_len, metric, pp);
    else
      screen_ws_kernel<BF16><<<grid_ws, WS_NT, smem, st>>>(
          tv, qp, scp, sqp, okp, nq, n, d, k_sel, seg_len, metric, pp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return merge(pp, nq, n_seg, k_sel, metric, out, st);
  }
  dim3 grid((nq + TQ - 1) / TQ, n_seg);
  CUtensorMap tq = {}, tv = {};
  if (route == WGMMA) {
    int rc = encode_rows(&tq, queries, nq, d, TQ, F32);
    if (rc == 0) rc = encode_rows(&tv, vectors, n, d, TC, store);
    if (rc != 0) return rc;
  }
  // cp.async: 8-byte copies where a row is a whole number of them and
  // both base pointers are 8-byte aligned; 4-byte copies take any f32
  const int pair = d % 2 == 0 && (reinterpret_cast<uintptr_t>(queries) |
                                  reinterpret_cast<uintptr_t>(vectors)) %
                                         8 == 0;
#define SCREEN_LAUNCH(S, R)                                               \
  if (store == S && route == R)                                           \
    screen_wgmma_kernel<S, R><<<grid, NT, smem, st>>>(                    \
        tq, tv, qp, vectors, scp, sqp, okp, nq, n, d, k_sel, seg_len,     \
        metric, pair, pp);
  SCREEN_KERNELS(SCREEN_LAUNCH)
#undef SCREEN_LAUNCH
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return merge(pp, nq, n_seg, k_sel, metric, out, st);
}

}  // extern "C"
