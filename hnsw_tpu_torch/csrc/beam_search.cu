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
// One block a query. Within a layer a query's search depends on nothing
// but its own pool: a query whose best unexpanded entry is no better than
// its worst entry merges only INF candidates from then on, and its pool
// stays as it is. So one block (128 threads) owns one query for the whole
// layer and loops over its hops until nothing is taken or it reaches
// max_hops; the batch's lockstep hop count is the largest per-query count.
// No barrier spans blocks and nothing returns to the host between hops.
//
// What bounds it on this card (H100 SXM, 3.35 TB/s, 132 SMs). Per query and
// hop it reads the E expanded nodes' neighbour ids (E*M*4 bytes) and the
// rows of the candidates it scores (512 bytes each for f32 at D = 128):
// over a batch of 1,024 queries a bound of tens of microseconds, which the
// kernel misses by 50-100x. Neither bytes nor operations bound it: the
// time is (dependent latency and issued instructions of one hop) x (the
// slowest query's hop count), with eight blocks sharing an SM. Each hop is
// a chain (select -> ids -> rows -> merge) of two trips to device memory
// and shared-memory work between block barriers. The design keeps that
// chain short and its instruction count small:
//
//   S. every thread puts the pool's ids into an open-addressing hash table
//      in shared memory (H slots, a power of two >= 2x its keys; 64-bit
//      words: id << 32 | 0 for a pool entry, id << 32 | slot + 1 for a
//      candidate; atomicCAS); warp 0 meanwhile selects the first E
//      unexpanded entries in pool order with ballots (the pool is sorted,
//      so these are the E best, ties to the lower position; take =
//      distance < the pool's last, largest, distance) and marks them
//      expanded (bit 30 of the id, as the twin carries it).  [barrier 1]
//   G. one thread a candidate slot loads its neighbour id (through
//      upper_map for a compact upper table), asks the L2 cache for its row
//      (prefetch.global.L2: always in a block layout, in a row store K2
//      only, see K5 below), and probes the table:
//      an id of the pool is masked (entries at INF with a valid id too:
//      the refine seeds a node with itself at INF); under the bitonic
//      merge it inserts the id with atomicMin of its slot, so the lowest
//      slot of a hop's copies wins.
//      O(1) a candidate in place of the C x P and C^2 compares.  [2]
//   L. warp 0 lists the surviving slots in slot order with ballots (a
//      later copy of an id finds a lower slot in the table and drops); the
//      other warps lay out the merge buffer.  [3]
//   C. score the list: a warp takes 8 rows at once (U; one 16-byte load a
//      lane a row at D = 128: 32 rows of a block in flight), sums them
//      with a transposing shuffle reduction (9 shuffles for 8 rows), and
//      applies the metric's epilogue (ops/distance.gathered_epilogue,
//      rounding step by step as PyTorch's separate elementwise kernels
//      do). A candidate that can enter the pool (distance <= the pool's
//      worst, < under the sort merge; every one while the pool's worst is
//      INF) appends its 64-bit key (the distance's order-preserving bits,
//      then its list index: slot order) with a shared atomicAdd. The others
//      cannot reach the first P outputs of either merge and are left out;
//      a hop with none keeps its pool as it is. The table is cleared.  [4]
//   R. rank the entering candidates by sorting their keys (bitonic; the
//      stages with stride < 64 in registers with __shfl_xor_sync), then
//      merge. "bitonic": the ranked candidates reversed behind the pool
//      and an INF pad to W2 = the next power of two >= P + E*M, then the
//      twin's compare-exchange network (swap iff a > b), only the
//      exchanges whose outputs reach the first P (stride >= 64 in shared
//      memory, < 64 in registers a warp). "sort": a stable merge of the
//      pool with the ranked candidates (merge path: each element's output
//      position from a binary search in the other list), keeping P, then
//      the twin's adjacent-duplicate mask. The twin leaves those holes
//      (INF, -1) in place; here they move behind the finite entries, in
//      order. Both are the same pool to every later step (the next stable
//      sort sees the same order of finite entries and of INF entries), and
//      the twin's final stable sort makes the outputs equal. Up to 64
//      entering candidates and P + E*M <= 512 (the common hop) take warp 0
//      alone, with no block barrier inside; larger ones the whole block.
//      [5; a hop of the block-wide path has 8-13]
//
// Block barriers a hop: 5 (4 when no candidate enters), against about 20
// before. Where 32 or fewer candidates enter, R sorts them one a lane (15
// stages, not 21 on two). __launch_bounds__(128, 8): at most 64 registers
// a thread, so eight blocks fit an SM (132 x 8 = 1,056 >= a batch of 1,024
// in one wave) while each needs under 28 KB of shared memory (P + E*M <=
// 512 at D = 128, E*M = 128).
//
// Precision, as the twin's _score_hop / _score_blocks: f32 rows at HIGHEST
// multiply in f32; at DEFAULT both operands are rounded to bf16 first;
// int8 blocks take a bf16-rounded query against the exact upcast, times
// block_scale, with squared norms that are bf16-rounded sums of
// bf16-rounded squares times block_scale^2; fp16 blocks score in f32; a
// store_normalized cosine store has squared norm 1. The row stores of the
// capacity modes read their rows from the typed ``vectors`` and the
// squared norms from ``sq_norms``: int8 rows (the capacity mode's qvec,
// ``vectors`` on the device a [1, D] placeholder) take a bf16-rounded
// query whatever the precision, against the exact upcast, and the f32 sum
// times the row's own qscale (one rounding); fp16 rows take the f32 query
// whatever the precision (the store's 11 significand bits are its point);
// bf16 rows take the query rounded to bf16 at DEFAULT, else in f32. The
// host says whether the query is rounded (``round_q``, from
// ops/beam_search.rounds_operands, the one place that decides). Every
// such product but f32 x fp16 / bf16 is exact in f32, so
// the kernel parts from the twin only in the order of its f32 sums (and
// in that an FMA does not round the f32 x fp16 / bf16 product).
//
// Shared memory (dynamic), in bytes, for C = E*M, W2 = next_pow2(P + C),
// WB = W2 under the bitonic merge and P under the sort merge, H =
// next_pow2(2 (P + C)) (bitonic: pool and candidate ids) or
// next_pow2(2 P) (sort: pool ids), NS = max(64, next_pow2(C)):
//   8 (H (table) + NS (keys)) + 4 (D padded to 4 (the query row) + 2P
//   (pool) + 2WB (merge buffer) + 4C (ids, table slots, list, distances)
//   + 3C under the sort merge (the ranked list) + 2E + 4).
// The wrapper (ops/beam_search.py) computes the same number and takes
// P + C <= 4,096 within 227 KB: ef 64 / 192 at E = 4, M = 32, D = 128 need
// 10,288 / 17,456 B, ef 512 32,304 B, P + C = 4,096 133,680 B (sort:
// 134,192 B), which leaves room for D up to 24,692 there (the layout
// before this one, without the table and keys: 41,204), and at ef 512 for
// D up to 50,164.

//
// K5: a whole search a launch (graph_search_kernel<SCORE0, SCOREUP, VEC>).
// Replaces hnsw_tpu/core/search.py:search_graph (:368, the jit program of
// a batch: _entry_dist :147, the upper-layer loop :427, the f32 rerank
// :445-468), whose plain version in the port is
// core/search.py:search_graph_reference: one K2 launch a layer, a host
// sync a layer for its hop count, and about ten eager launches of entry
// scoring, hand-off and rerank around them (78 launches and 12 host
// syncs for a 1,024-query batch of a 9-layer graph). What bounds it is
// what bounds K2, layer after layer: the slowest query's dependent hops;
// its bytes and operations are the sum of the layers' (and the rerank's
// R rows a query), tens of microseconds at the graph tier's shape. The
// design removes everything between the layers: one block a query runs
// layer_search (K2's body as a device function) on each layer in turn,
// from the entries it scores itself (the graph's entry, or the caller's
// seeds, a warp a row in the upper layers' row mode), handing the pool's
// best to the next layer in shared memory, then layer 0 in its own mode,
// then the rerank of the pool's head (a warp a row at full f32, a stable
// rank by counting in pool order) straight into the [B, k] outputs, and
// each layer's hop count into [L, B]. No block waits for another, and the
// host reads nothing before the results. The layers' shapes (P, E, M and
// the hash table, merge widths and shared-memory offsets that follow from
// them) are computed on the host for the upper layers and for layer 0;
// one allocation holds the larger layout, then the entries. SCOREUP is a
// row mode (the entries are always scored on rows); SCORE0 is the same
// mode, or int8 / fp16 blocks over any row mode: 15 pairs.
// __launch_bounds__(128, 8) as K2: a 1,024-query batch stays one wave.
// Nothing lives in registers across the layers: the upper layer in search
// (its table, rows and index) is in k5_ref, a shared variable at a fixed
// address read where it is used, and the block's and thread's index, the
// query's row and squared norm and the entries' place are taken anew
// where they are used. Even so ptxas spills 80-208 B a thread at the
// 64-register cap: the kernel inlines two layer bodies (the upper layers'
// and layer 0's), and a build with one of them spills none; a
// non-inlined layer body makes the parameters a local copy, and loading
// half a row group at a time halves the loads in flight. (The upper
// layer's table must be read as a value: a conditional of two lvalues,
// one a kernel parameter, takes the parameter's address, and the whole
// parameter block is then copied to local memory.)
//
// The split of K5 (tools/graph_split.py, -DGRAPH_PHASE_CLOCKS) showed a
// hop as a serial chain of shared work, five block barriers and L2 round
// trips, eight blocks an SM: a batch of 8 distinct queries repeated, whose
// rows all sit in L2, took within 10% of the cycles a hop of a random
// batch, so device-memory bytes do not set the pace. Two redesigns of
// that chain were built, held equal to this form bit for bit, and
// measured slower, so they are left out: a ring of rows staged in shared
// memory by cp.async in G and scored from there in C, and a narrow walk
// of the 8-wide upper layers by warp 0 alone between two block barriers a
// hop (no hash table). What stays: nothing is kept in registers across
// the layers, and the one-key-a-lane sort.
//
// K5 asks the L2 cache for no row of a row store ahead (layer_search's
// PREFETCH false; K2, which the builder launches, still does). At a
// million rows (512 MB of f32 rows against 50 MB of L2) the memory
// system, not the hop's chain, sets the pace: a block's time fell only
// 1.11x from 6 to 8 resident blocks an SM, and a hop's row loads waited
// 8-10 us. The prefetch asked for the row of every gathered id, about 128
// a hop at E*M = 128, of which a layer-0 hop scores about 50: the rest
// are ids the pool holds, whose rows it does not read again. Without it a
// launch of 8,192 queries took 5.23 / 10.59 ms at ef 64 / 192 against
// 6.04 / 13.36 ms, with the same outputs bit for bit, and a batch whose
// rows all sit in L2 was faster too (3.89 against 4.24 ms at ef 64); fp16
// rows at ef 192 took 10.33 against 10.37 ms. A block layout keeps it: an
// expanded node's block is one run of its M rows, asked for before the
// ids are read, and int8 blocks at ef 192 (pivot seeds, fast_math) took
// 9.39 ms without it against 8.52-8.57 ms with it. A form of one query a
// warp, four a block (no block barrier inside a hop, 20 queries an SM at
// ef 64 against 8), was built, held equal bit for bit and measured
// slower: 5.73 / 15.02 ms without the prefetch. A warp keeps 8 rows in
// flight, a block 32, and at 96 registers a thread the warps an SM held
// fewer rows in flight than the blocks, each waiting as long.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;            // threads a block
constexpr int NW = NT / 32;        // warps a block
constexpr int MIN_BLOCKS = 8;      // resident blocks an SM (launch bounds)
constexpr int U = 8;               // rows a warp scores at once
constexpr int SOLO_WIDTH = 512;    // P + C up to which warp 0 merges alone
constexpr unsigned FULL = 0xffffffffu;
constexpr float INF_DIST = 3.0e38f;
constexpr int EXP_BIT = 1 << 30;
constexpr float EPS = 1e-30f;
constexpr unsigned long long EMPTY = ~0ull;    // a free table slot
constexpr unsigned long long KEY_PAD = ~0ull;  // sorts after every key

enum { M_COSINE = 0, M_L2 = 1, M_SQEUCLIDEAN = 2, M_DOT = 3 };
// scoring modes: f32 rows at HIGHEST, f32 rows at DEFAULT (bf16 operands),
// int8 neighbour blocks, fp16 neighbour blocks, int8 rows with per-row
// scales, fp16 rows, bf16 rows
enum { S_F32 = 0, S_BF16 = 1, S_I8 = 2, S_F16 = 3, S_Q8ROW = 4,
       S_F16ROW = 5, S_B16ROW = 6 };

// layer-0 neighbour blocks (else rows of ``vectors``)
__host__ __device__ constexpr bool is_blocks(int score) {
  return score == S_I8 || score == S_F16;
}
// bytes an element of the scored store
__host__ __device__ constexpr int elem_bytes(int score) {
  return (score == S_F32 || score == S_BF16) ? 4
         : (score == S_I8 || score == S_Q8ROW) ? 1 : 2;
}

// Byte offsets of the shared-memory arrays (layout(): the query row at 0;
// 8-byte arrays next).
struct Layout {
  int tab, keys, pool_d, pool_i, buf_d, buf_i, cand_id, cand_pos, ok_slot,
      ok_d, so_d, so_i, so_r, sel_j, sel_cur, counts, bytes;
};

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
  const void* vectors;     // [cap, D] rows: f32, int8 (qvec), fp16, bf16
  const float* sq_norms;   // [cap] (rows)
  const float* qscale;     // [cap] per-row scale (int8 rows)
  int round_q;             // the query rounded to bf16 (rounds_operands)
  const void* blocks;      // [cap, block_m, D] int8 / fp16 (blocks)
  int block_m;
  const float* block_scale;  // [] (int8 blocks)
  int D, P, E, M, max_hops, metric, merge_sort, normalized;
  int C, W2, WB, H, NS, shift;   // E*M, merge widths, table slots, keys
  Layout L;                // byte offsets into the dynamic shared memory
  float* out_d;            // [B, P]
  int* out_i;              // [B, P]
  int* hops;               // [B]
  int* work;               // [B, 2]: nodes expanded, candidates scored
  long long* clocks;       // [B, N_PHASE] (BEAM_PHASE_CLOCKS builds only)
};

// Phase counters (BEAM_PHASE_CLOCKS builds of K2, tools/hop_split.py;
// GRAPH_PHASE_CLOCKS builds of K5, tools/graph_split.py): thread 0 adds
// the clock64() cycles since the last mark to the phase's counter. The
// same-hop dedup has no phase of its own here: the table does it in
// "gather" and "list". K5's clocked build counts a layer's set-up (pool
// init, the hand-off to the next layer) in PH_DEDUP, and sums the counters
// over four groups (G_*): the entries, the upper layers, layer 0, the
// rerank.
enum { PH_SELECT = 0, PH_GATHER, PH_DEDUP, PH_LIST, PH_SCORE, PH_RANK,
       PH_MERGE, PH_COMPACT, N_PHASE };
enum { G_ENTRY = 0, G_UPPER, G_LAYER0, G_RERANK, N_GROUP };
#if defined(BEAM_PHASE_CLOCKS) || defined(GRAPH_PHASE_CLOCKS)
#define PHASE_CLOCKS
#endif
#if defined(BEAM_PHASE_CLOCKS) && defined(GRAPH_PHASE_CLOCKS)
#error "one clocked kernel a build: BEAM_PHASE_CLOCKS or GRAPH_PHASE_CLOCKS"
#endif
#ifdef PHASE_CLOCKS
#define PHASE_MARK(ph)                                  \
  do {                                                  \
    if (threadIdx.x == 0) {                             \
      const long long t_ = clock64();                   \
      clk[ph] += t_ - clk[N_PHASE];                     \
      clk[N_PHASE] = t_;                                \
    }                                                   \
  } while (0)
#else
#define PHASE_MARK(ph) \
  do {                 \
  } while (0)
#endif

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// id without the expanded flag (-1 stays -1)
__device__ __forceinline__ int unpack(int p) {
  return p >= 0 ? (p & (EXP_BIT - 1)) : p;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  const char* c = static_cast<const char*>(p);
  for (int o = 0; o < bytes; o += 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
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

// A sort key that orders as (distance, j): the float's order-preserving
// bits (-0 as +0, so equal distances tie), then j.
__device__ __forceinline__ unsigned long long make_key(float d, int j) {
  unsigned u = __float_as_uint(d);
  if ((u << 1) == 0u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(j);
}

// ---- the pool's hash table ------------------------------------------------

__device__ __forceinline__ int tab_hash(int id, int shift) {
  return static_cast<int>((static_cast<unsigned>(id) * 0x9E3779B1u) >> shift);
}

// Puts a pool id in the table (low word 0: a pool entry).
__device__ __forceinline__ void tab_insert_pool(unsigned long long* tab,
                                                int mask, int shift, int id) {
  const unsigned long long want = static_cast<unsigned long long>(id) << 32;
  for (int h = tab_hash(id, shift);; h = (h + 1) & mask) {
    const unsigned long long old = atomicCAS(tab + h, EMPTY, want);
    if (old == EMPTY || old == want) return;
  }
}

// Candidate slot c with id: -1 if the id is in the pool. Else, with
// insert (bitonic merge), the table position of its entry, whose low word
// ends as the lowest slot + 1 of the hop's copies; without, 0.
__device__ __forceinline__ int tab_probe(unsigned long long* tab, int mask,
                                         int shift, int id, int c,
                                         bool insert) {
  const unsigned long long key = static_cast<unsigned long long>(id) << 32;
  const unsigned long long want = key | static_cast<unsigned>(c + 1);
  for (int h = tab_hash(id, shift);; h = (h + 1) & mask) {
    unsigned long long cur =
        *reinterpret_cast<volatile unsigned long long*>(tab + h);
    if (cur == EMPTY) {
      if (!insert) return 0;
      cur = atomicCAS(tab + h, EMPTY, want);
      if (cur == EMPTY) return h;
    }
    if ((cur >> 32) == (key >> 32)) {
      if (static_cast<unsigned>(cur) == 0u) return -1;
      atomicMin(tab + h, want);
      return h;
    }
  }
}

// ---- sorting and merging in registers -------------------------------------

// One compare-exchange stage (k, j) of an ascending bitonic sort, j < 32,
// over a warp's 64-chunk at base: the lane holds elements base + lane (x0)
// and base + lane + 32 (x1).
__device__ __forceinline__ void sort_stage(unsigned long long& x0,
                                           unsigned long long& x1, int base,
                                           int k, int j, int lane) {
  const unsigned long long p0 = __shfl_xor_sync(FULL, x0, j);
  const unsigned long long p1 = __shfl_xor_sync(FULL, x1, j);
  const bool lower = (lane & j) == 0;
  const bool up0 = ((base + lane) & k) == 0;
  const bool up1 = ((base + lane + 32) & k) == 0;
  x0 = (lower == up0) ? min(x0, p0) : max(x0, p0);
  x1 = (lower == up1) ? min(x1, p1) : max(x1, p1);
}

// The stages j = 32 .. 1 of bitonic step k (k >= 64) on a warp's 64-chunk.
__device__ __forceinline__ void sort_chunk_tail(unsigned long long& x0,
                                                unsigned long long& x1,
                                                int base, int k, int lane) {
  const bool up = ((base + lane) & k) == 0;   // x1's direction is the same
  if ((x0 > x1) == up) {
    const unsigned long long t = x0;
    x0 = x1;
    x1 = t;
  }
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1) sort_stage(x0, x1, base, k, j, lane);
}

// A warp's 64-chunk sorted: ascending where (base & 64) == 0, else
// descending (the first six steps of a bitonic sort of the whole array).
__device__ __forceinline__ void sort_chunk(unsigned long long& x0,
                                           unsigned long long& x1, int base,
                                           int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j >= 1; j >>= 1) sort_stage(x0, x1, base, k, j, lane);
  }
  sort_chunk_tail(x0, x1, base, 64, lane);
}

// The warp's 32 keys, one a lane, sorted ascending in lane order (distinct
// keys: the order any sort gives).
__device__ __forceinline__ unsigned long long sort32(unsigned long long x,
                                                     int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j >= 1; j >>= 1) {
      const unsigned long long p = __shfl_xor_sync(FULL, x, j);
      x = (((lane & j) == 0) == ((lane & k) == 0)) ? min(x, p) : max(x, p);
    }
  }
  return x;
}

// Ascending bitonic sort of keys[0, ns) (ns a power of two >= 64) by the
// whole block; ends with a barrier.
__device__ void block_sort(unsigned long long* keys, int ns) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = warp * 64; base < ns; base += NW * 64) {
    unsigned long long x0 = keys[base + lane], x1 = keys[base + lane + 32];
    sort_chunk(x0, x1, base, lane);
    keys[base + lane] = x0;
    keys[base + lane + 32] = x1;
  }
  __syncthreads();
  for (int k = 128; k <= ns; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int i = threadIdx.x; i < (ns >> 1); i += NT) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1)), hi = lo + j;
        const unsigned long long x = keys[lo], y = keys[hi];
        if ((x > y) == ((lo & k) == 0)) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncthreads();
    }
    for (int base = warp * 64; base < ns; base += NW * 64) {
      unsigned long long x0 = keys[base + lane], x1 = keys[base + lane + 32];
      sort_chunk_tail(x0, x1, base, k, lane);
      keys[base + lane] = x0;
      keys[base + lane + 32] = x1;
    }
    __syncthreads();
  }
}

// One stage (stride s < 32) of the twin's merge network on a warp's
// 64-chunk of (distance, id): swap iff the lower position's distance is
// larger.
__device__ __forceinline__ void net_stage(float& d, int& i, int s, int lane) {
  const float pd = __shfl_xor_sync(FULL, d, s);
  const int pi = __shfl_xor_sync(FULL, i, s);
  const bool lower = (lane & s) == 0;
  if (lower ? d > pd : pd > d) {
    d = pd;
    i = pi;
  }
}

// The twin's bitonic merge network (_bitonic_merge: stages s = W2/2 .. 1,
// swap iff a > b) over buf[0, W2), keeping only the exchanges whose outputs
// reach [0, P), which it writes to the pool. SOLO: warp 0 alone (the
// other warps do not call it), else the whole block; ends synced.
template <bool SOLO>
__device__ void merge_network(float* bd, int* bi, int W2, int P,
                              float* pool_d, int* pool_i) {
  const int lane = threadIdx.x & 31;
  const int rank = SOLO ? lane : threadIdx.x, team = SOLO ? 32 : NT;
  for (int s = W2 >> 1; s >= 64; s >>= 1) {
    const int need = (P + s - 1) / s * s;   // outputs below it matter
    for (int i = rank; i < (W2 >> 1); i += team) {
      const int lo = ((i & ~(s - 1)) << 1) | (i & (s - 1)), hi = lo + s;
      if (lo >= need) break;
      const float x = bd[lo], y = bd[hi];
      if (x > y) {
        bd[lo] = y;
        bd[hi] = x;
        const int t = bi[lo];
        bi[lo] = bi[hi];
        bi[hi] = t;
      }
    }
    if (SOLO) __syncwarp(); else __syncthreads();
  }
  const int first = SOLO ? 0 : threadIdx.x >> 5, step = SOLO ? 1 : NW;
  for (int base = first * 64; base < P; base += step * 64) {
    const int i0 = base + lane, i1 = i0 + 32;
    float d0 = i0 < W2 ? bd[i0] : INF_DIST, d1 = i1 < W2 ? bd[i1] : INF_DIST;
    int x0 = i0 < W2 ? bi[i0] : -1, x1 = i1 < W2 ? bi[i1] : -1;
    if (W2 >= 64 && d0 > d1) {
      const float t = d0;
      d0 = d1;
      d1 = t;
      const int u = x0;
      x0 = x1;
      x1 = u;
    }
    for (int s = min(16, W2 >> 1); s >= 1; s >>= 1) {
      net_stage(d0, x0, s, lane);
      net_stage(d1, x1, s, lane);
    }
    if (i0 < P) {
      pool_d[i0] = d0;
      pool_i[i0] = x0;
    }
    if (i1 < P) {
      pool_d[i1] = d1;
      pool_i[i1] = x1;
    }
  }
  if (SOLO) __syncwarp(); else __syncthreads();
}

// Warp 0: buf[0, n) into the pool with the twin's adjacent-duplicate mask
// (a later copy of the previous entry's id becomes (INF, -1)), finite
// distances first, then the INF ones, each group in its order (a stable
// sort of an array whose finite entries are ascending).
__device__ void dedup_compact(const float* bd, const int* bi, float* pool_d,
                              int* pool_i, int n) {
  const int lane = threadIdx.x & 31;
  int n_fin = 0;
  for (int base = 0; base < n; base += 32) {
    const int p = base + lane;
    bool fin = false;
    if (p < n) {
      const int id = unpack(bi[p]);
      const bool dup = p > 0 && id >= 0 && id == unpack(bi[p - 1]);
      fin = !dup && bd[p] < INF_DIST;
    }
    n_fin += __popc(__ballot_sync(FULL, fin));
  }
  int fo = 0, io = n_fin;
  for (int base = 0; base < n; base += 32) {
    const int p = base + lane;
    bool fin = false, inf = false;
    float d = INF_DIST;
    int i = -1;
    if (p < n) {
      const int id = unpack(bi[p]);
      const bool dup = p > 0 && id >= 0 && id == unpack(bi[p - 1]);
      if (!dup) {
        d = bd[p];
        i = bi[p];
      }
      fin = !dup && d < INF_DIST;
      inf = !fin;
    }
    const unsigned bf = __ballot_sync(FULL, fin);
    const unsigned bn = __ballot_sync(FULL, inf);
    if (fin || inf) {
      const int o = fin ? fo + __popc(bf & lanes_below(lane))
                        : io + __popc(bn & lanes_below(lane));
      pool_d[o] = d;
      pool_i[o] = i;
    }
    fo += __popc(bf);
    io += __popc(bn);
  }
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

// ---- scoring --------------------------------------------------------------

// bf16 bits (the low or high half of a word) as f32: exact
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Four consecutive elements (i a multiple of 4, rows aligned: VEC), f32
// after the mode's rounding.
template <int SCORE>
__device__ __forceinline__ void elem4(const Params& a, size_t i, float* x) {
  const void* base = is_blocks(SCORE) ? a.blocks : a.vectors;
  if (SCORE == S_F32 || SCORE == S_BF16) {
    float4 v = __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + i));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    if (SCORE == S_BF16) {
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = bf16r(x[t]);
    }
  } else if (SCORE == S_I8 || SCORE == S_Q8ROW) {
    char4 v = __ldg(reinterpret_cast<const char4*>(
        static_cast<const signed char*>(base) + i));
    x[0] = (float)v.x; x[1] = (float)v.y; x[2] = (float)v.z;
    x[3] = (float)v.w;
  } else if (SCORE == S_B16ROW) {
    uint2 v = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const unsigned short*>(base) + i));
    x[0] = bf16_lo(v.x); x[1] = bf16_hi(v.x);
    x[2] = bf16_lo(v.y); x[3] = bf16_hi(v.y);
  } else {
    uint2 v = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __half*>(base) + i));
    float2 lo = __half22float2(*reinterpret_cast<__half2*>(&v.x));
    float2 hi = __half22float2(*reinterpret_cast<__half2*>(&v.y));
    x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
  }
}

// One element of ``base`` (any alignment) in scoring mode SCORE.
template <int SCORE>
__device__ __forceinline__ float elem_at(const void* base, size_t i) {
  if (SCORE == S_F32) return __ldg(static_cast<const float*>(base) + i);
  if (SCORE == S_BF16)
    return bf16r(__ldg(static_cast<const float*>(base) + i));
  if (SCORE == S_I8 || SCORE == S_Q8ROW)
    return (float)__ldg(static_cast<const signed char*>(base) + i);
  if (SCORE == S_B16ROW)
    return bf16_lo(__ldg(static_cast<const unsigned short*>(base) + i));
  return __half2float(__ldg(static_cast<const __half*>(base) + i));
}

// One element of the mode's store (any alignment).
template <int SCORE>
__device__ __forceinline__ float elem(const Params& a, size_t i) {
  return elem_at<SCORE>(is_blocks(SCORE) ? a.blocks : a.vectors, i);
}

template <int SCORE>
__device__ __forceinline__ float sq_term(float x) {
  return SCORE == S_I8 ? bf16r(x * x) : __fmul_rn(x, x);
}

// Sum over the warp of each of the U = 8 values; lanes 4u .. 4u + 3 get
// row u's sum. Each step keeps half its rows and trades the other half
// with the lane across (9 shuffles in place of 40).
__device__ __forceinline__ float reduce8(const float* v, int lane) {
  float w[4], x[2];
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b16 ? v[i] : v[i + 4];
    const float keep = b16 ? v[i + 4] : v[i];
    w[i] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b8 ? w[i] : w[i + 2];
    const float keep = b8 ? w[i + 2] : w[i];
    x[i] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  float y = (b4 ? x[1] : x[0]) + __shfl_xor_sync(FULL, b4 ? x[0] : x[1], 4);
  y += __shfl_xor_sync(FULL, y, 2);
  y += __shfl_xor_sync(FULL, y, 1);
  return y;
}

// Distances of the n_ok listed candidates: warp w takes list entries
// w*U .. w*U+U-1, then NW*U further, and so on. Each one that can enter the
// pool appends its key to keys[] (the count in *n_enter).
template <int SCORE, bool VEC>
__device__ __forceinline__ void score_list(
    const Params& a, const float* qop, float qsq, float scale,
    const int* sel_cur, const int* cand_id, const int* ok_slot, float* ok_d,
    int n_ok, float worst, unsigned long long* keys, int* n_enter) {
  constexpr bool BLOCKS = is_blocks(SCORE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = a.D, M = a.M;
  const bool all_enter = !(worst < INF_DIST);
  for (int base = warp * U; base < n_ok; base += NW * U) {
    int row[U];   // rows: the vector slot; blocks: node * block_m + m
    float vsq_row = 0.0f;   // lane 4u: the squared norm of row u
    float scl_row = 1.0f;   // lane 4u: row u's scale (int8 rows)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = base + u;
      const int slot = k < n_ok ? ok_slot[k] : -1;
      if (BLOCKS) {
        const int e = slot / M, m = slot - e * M;
        row[u] = slot < 0 ? -1 : sel_cur[e] * a.block_m + m;
      } else {
        row[u] = slot < 0 ? -1 : cand_id[slot];
        if (lane == 4 * u && slot >= 0) {
          vsq_row = __ldg(a.sq_norms + row[u]);
          if (SCORE == S_Q8ROW) scl_row = __ldg(a.qscale + row[u]);
        }
      }
    }
    float acc[U], ssq[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = ssq[u] = 0.0f;
    // fp16 blocks load half the rows at a time (their conversions and
    // squared sums need the registers); each row's sums keep their order
    constexpr int UH = SCORE == S_F16 ? U / 2 : U;
#pragma unroll
    for (int h = 0; h < U; h += UH) {
      if (VEC) {
        for (int k = lane * 4; k < D; k += 128) {
          const float4 q4 = *reinterpret_cast<const float4*>(qop + k);
          float x[UH][4];
#pragma unroll
          for (int v = 0; v < UH; ++v) {
            if (row[h + v] >= 0) {
              elem4<SCORE>(a, (size_t)row[h + v] * D + k, x[v]);
            } else {
              x[v][0] = x[v][1] = x[v][2] = x[v][3] = 0.0f;
            }
          }
#pragma unroll
          for (int v = 0; v < UH; ++v) {
            float& s = acc[h + v];
            s = fmaf(q4.x, x[v][0], s);
            s = fmaf(q4.y, x[v][1], s);
            s = fmaf(q4.z, x[v][2], s);
            s = fmaf(q4.w, x[v][3], s);
            if (BLOCKS) {
#pragma unroll
              for (int t = 0; t < 4; ++t)
                ssq[h + v] += sq_term<SCORE>(x[v][t]);
            }
          }
        }
      } else {
        for (int k = lane; k < D; k += 32) {
          const float qk = qop[k];
          float x[UH];
#pragma unroll
          for (int v = 0; v < UH; ++v)
            x[v] = row[h + v] >= 0
                       ? elem<SCORE>(a, (size_t)row[h + v] * D + k) : 0.0f;
#pragma unroll
          for (int v = 0; v < UH; ++v) {
            acc[h + v] = fmaf(qk, x[v], acc[h + v]);
            if (BLOCKS) ssq[h + v] += sq_term<SCORE>(x[v]);
          }
        }
      }
    }
    float qv = reduce8(acc, lane);
    const float s = BLOCKS ? reduce8(ssq, lane) : 0.0f;
    const int j = base + (lane >> 2);
    if ((lane & 3) == 0 && j < n_ok) {
      float vsq;
      if (SCORE == S_I8) {
        qv = __fmul_rn(qv, scale);
        vsq = (a.normalized && a.metric == M_COSINE)
                  ? 1.0f : __fmul_rn(bf16r(s), __fmul_rn(scale, scale));
      } else if (SCORE == S_F16) {
        vsq = (a.normalized && a.metric == M_COSINE) ? 1.0f : s;
      } else {
        if (SCORE == S_Q8ROW) qv = __fmul_rn(qv, scl_row);
        vsq = vsq_row;
      }
      const float d = epilogue(a.metric, qv, qsq, vsq);
      ok_d[j] = d;
      if (all_enter || (a.merge_sort ? d < worst : d <= worst))
        keys[atomicAdd(n_enter, 1)] = make_key(d, j);
    }
  }
}

// ---- one layer -------------------------------------------------------------

#ifdef PHASE_CLOCKS
__shared__ long long clk[N_PHASE + 1];
#endif

// ---- a hop's steps -------------------------------------------------------

// Warp 0: the first E unexpanded finite entries of the pool in pool order
// (the pool is ascending: they lead); those taken (distance < the pool's
// last, largest, distance) are marked expanded (bit 30 of the id, as the
// twin carries it) and their ids put in sel_cur. Returns how many are
// taken; ends synced across the warp.
__device__ __forceinline__ int select_take(const float* pool_d, int* pool_i,
                                           int P, int E, int* sel_j,
                                           int* sel_cur) {
  const int lane = threadIdx.x & 31;
  const float worst = pool_d[P - 1];
  int found = 0;
  for (int base = 0; base < P && found < E; base += 32) {
    const int p = base + lane;
    const int pi = p < P ? pool_i[p] : -1;
    const bool elig = pi >= 0 && pi < EXP_BIT && pool_d[p] < INF_DIST;
    const unsigned bal = __ballot_sync(FULL, elig);
    const int r = found + __popc(bal & lanes_below(lane));
    if (elig && r < E) sel_j[r] = p;
    found += __popc(bal);
  }
  __syncwarp();
  const int n_sel = min(found, E);
  int n_take = 0;
  for (int base = 0; base < n_sel; base += 32) {
    const int e = base + lane;
    n_take += __popc(__ballot_sync(
        FULL, e < n_sel && pool_d[sel_j[min(e, n_sel - 1)]] < worst));
  }
  for (int e = lane; e < n_take; e += 32) {
    const int p = sel_j[e];
    sel_cur[e] = pool_i[p];
    pool_i[p] |= EXP_BIT;
  }
  __syncwarp();
  return n_take;
}

// The merge buffer before a hop's merge (warps 1.. of the block): bitonic,
// the pool then an INF pad to WB; sort, INF.
__device__ __forceinline__ void lay_out_buffer(const float* pool_d,
                                               const int* pool_i,
                                               float* buf_d, int* buf_i,
                                               int P, int WB,
                                               int sort_merge) {
  for (int p = threadIdx.x - 32; p < WB; p += NT - 32) {
    const bool keep = !sort_merge && p < P;
    buf_d[p] = keep ? pool_d[p] : INF_DIST;
    buf_i[p] = keep ? pool_i[p] : -1;
  }
}

// The r-th ranked entering candidate (keys sorted): bitonic, to W2 - 1 -
// its rank among all C slots (a scored candidate ranks before the masked
// slots (INF, -1) unless its distance is >= INF); sort, to the ranked
// list.
__device__ __forceinline__ void place_ranked(
    const unsigned long long* keys, int r, const int* ok_slot,
    const float* ok_d, const int* cand_id, int n_masked, int W2,
    int sort_merge, float* buf_d, int* buf_i, float* so_d, int* so_i,
    int* so_r) {
  const int j = static_cast<int>(keys[r] & 0xffffffffu);
  const int slot = ok_slot[j];
  const float d = ok_d[j];
  const int id = cand_id[slot];
  const int full = r + (d > INF_DIST ? n_masked
                        : d >= INF_DIST ? slot - j : 0);
  if (sort_merge) {
    so_d[r] = d;
    so_i[r] = id;
    so_r[r] = full;
  } else {
    buf_d[W2 - 1 - full] = d;
    buf_i[W2 - 1 - full] = id;
  }
}

// The sort merge: a stable merge of the pool with the ng ranked
// candidates (merge path: each element's output position from a binary
// search in the other list), the first P into buf; by threads rank, rank
// + team, ...
__device__ __forceinline__ void merge_sorted(
    const float* pool_d, const int* pool_i, const float* so_d,
    const int* so_i, const int* so_r, int ng, int n_masked, int P,
    float* buf_d, int* buf_i, int rank, int team) {
  for (int p = rank; p < P; p += team) {
    const float d = pool_d[p];
    const int pos = p + lower_bound(so_d, ng, d)
                    + (d > INF_DIST ? n_masked : 0);
    if (pos < P) {
      buf_d[pos] = d;
      buf_i[pos] = pool_i[p];
    }
  }
  for (int r = rank; r < ng; r += team) {
    const int pos = so_r[r] + upper_bound(pool_d, P, so_d[r]);
    if (pos < P) {
      buf_d[pos] = so_d[r];
      buf_i[pos] = so_i[r];
    }
  }
}

// Warp 0 alone: rank ng <= 64 entering candidates by sorting their keys in
// registers, then merge them into the pool (bitonic: the twin's network,
// sort: the merge path and the adjacent-duplicate mask); the pool in
// shared memory, synced across the warp. P + C <= SOLO_WIDTH.
__device__ __forceinline__ void rank_merge_warp(
    const Params& a, unsigned long long* keys, int ng, const int* ok_slot,
    const float* ok_d, const int* cand_id, int n_masked, float* buf_d,
    int* buf_i, float* so_d, int* so_i, int* so_r, float* pool_d,
    int* pool_i) {
  const int lane = threadIdx.x & 31;
  if (ng <= 32) {   // one key a lane: 15 stages in place of 21 on two
    keys[lane] = sort32(lane < ng ? keys[lane] : KEY_PAD, lane);
  } else {
    unsigned long long x0 = keys[lane];
    unsigned long long x1 = lane + 32 < ng ? keys[lane + 32] : KEY_PAD;
    sort_chunk(x0, x1, 0, lane);
    keys[lane] = x0;
    keys[lane + 32] = x1;
  }
  __syncwarp();
  for (int r = lane; r < ng; r += 32)
    place_ranked(keys, r, ok_slot, ok_d, cand_id, n_masked, a.W2,
                 a.merge_sort, buf_d, buf_i, so_d, so_i, so_r);
  __syncwarp();
  PHASE_MARK(PH_RANK);
  if (!a.merge_sort) {
    merge_network<true>(buf_d, buf_i, a.W2, a.P, pool_d, pool_i);
    PHASE_MARK(PH_MERGE);
  } else {
    merge_sorted(pool_d, pool_i, so_d, so_i, so_r, ng, n_masked, a.P, buf_d,
                 buf_i, lane, 32);
    __syncwarp();
    PHASE_MARK(PH_MERGE);
    dedup_compact(buf_d, buf_i, pool_d, pool_i, a.P);
    __syncwarp();
    PHASE_MARK(PH_COMPACT);
  }
}

// The query row as a scoring mode multiplies it (rounded to bf16 where
// round_q says so) into qop, at the start of the dynamic shared memory. The
// caller syncs before it is read.
__device__ __forceinline__ void load_query(float* qop, const float* q, int D,
                                           int round_q) {
  for (int k = threadIdx.x; k < D; k += NT) {
    const float x = q[k];
    qop[k] = round_q ? bf16r(x) : x;
  }
}

// K5's upper layer in search, in shared memory at an address fixed when
// the kernel is linked: read where it is used (volatile), so that nothing
// of it lives in a register across a hop.
struct LayerRef {
  const int* table;
  int n_rows;
  int layer;
};
__shared__ LayerRef k5_ref;

// One layer's beam search for the block's query: the pool starts from the
// s_in entries (sid, sdist: global or shared memory), the hops run on the
// layer's neighbour rows (a.table of a.n_rows rows, or with ``upper`` K5's
// k5_ref's; through a.upper_map for a compact table) with the shapes and
// layout of ``a``, the query
// (already in qop, as a.round_q has it) and its squared norm qsq. Adds the
// nodes expanded and candidates scored to n_exp, n_scored and returns the
// hop count. On return every thread is synced and the pool is in shared
// memory (a.L.pool_d, a.L.pool_i): ascending, empty slots (INF, -1) last,
// ids with the expanded flag. K2 (beam_search_kernel) runs one layer a
// launch; K5 (graph_search_kernel) runs every layer of a search. PREFETCH:
// in a row store, each gathered id's row is asked of the L2 cache as the
// id arrives (K2). A block layout always asks for its slot's row.
template <int SCORE, bool VEC, bool PREFETCH>
__device__ __forceinline__ int layer_search(const Params& a, bool upper,
                                            const int* sid,
                                            const float* sdist, int s_in,
                                            float qsq, int& n_exp,
                                            int& n_scored) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool BLOCKS = is_blocks(SCORE);
  constexpr int ES = elem_bytes(SCORE);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int D = a.D, P = a.P, E = a.E, M = a.M, C = a.C, W2 = a.W2;
  const int H = a.H, NS = a.NS, WB = a.WB, sort_merge = a.merge_sort;
  const int mask = H - 1, shift = a.shift;
#define SMEM(T, name) reinterpret_cast<T*>(smem + a.L.name)
  const float* const qop = reinterpret_cast<const float*>(smem);  // D
  unsigned long long* const tab = SMEM(unsigned long long, tab);   // H
  unsigned long long* const keys = SMEM(unsigned long long, keys);  // NS
  float* const pool_d = SMEM(float, pool_d);              // P
  int* const pool_i = SMEM(int, pool_i);                  // P
  float* const buf_d = SMEM(float, buf_d);                // WB
  int* const buf_i = SMEM(int, buf_i);                    // WB
  int* const cand_id = SMEM(int, cand_id);                // C
  int* const cand_pos = SMEM(int, cand_pos);              // C
  int* const ok_slot = SMEM(int, ok_slot);                // C
  float* const ok_d = SMEM(float, ok_d);                  // C
  float* const so_d = SMEM(float, so_d);                  // C (sort)
  int* const so_i = SMEM(int, so_i);                      // C (sort)
  int* const so_r = SMEM(int, so_r);                      // C (sort)
  int* const sel_j = SMEM(int, sel_j);                    // E
  int* const sel_cur = SMEM(int, sel_cur);                // E
  int* const counts = SMEM(int, counts);  // taken, listed, entering
#undef SMEM

  const float scale = SCORE == S_I8 ? *a.block_scale : 1.0f;
  for (int h = tid; h < H; h += NT) tab[h] = EMPTY;

  // pool init: the start entries lead; more than one are sorted stably by
  // distance and adjacent duplicate ids masked, as the twin does
  const int S = min(s_in, P);
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
    if (warp == 0) dedup_compact(buf_d, buf_i, pool_d, pool_i, P);
    __syncthreads();
  }

#ifdef BEAM_PHASE_CLOCKS
  if (tid == 0) {
    for (int i = 0; i < N_PHASE; ++i) clk[i] = 0;
    clk[N_PHASE] = clock64();
  }
#endif
#ifdef GRAPH_PHASE_CLOCKS
  PHASE_MARK(PH_DEDUP);   // the layer's set-up
#endif
  int hops = 0;
  while (hops < a.max_hops) {
    // S. the pool's ids into the table (cleared at init or in the last
    // hop's scoring); warp 0 selects the first E unexpanded finite
    // entries in pool order and marks the taken ones (the pool is
    // ascending: they lead)
    for (int p = tid; p < P; p += NT) {
      const int id = unpack(pool_i[p]);
      if (id >= 0) tab_insert_pool(tab, mask, shift, id);
    }
    if (warp == 0) {
      const int n_take = select_take(pool_d, pool_i, P, E, sel_j, sel_cur);
      if (lane == 0) {
        counts[0] = n_take;
        counts[2] = 0;
      }
    }
    __syncthreads();
    PHASE_MARK(PH_SELECT);
    const int n_take = counts[0];
    if (n_take == 0) break;

    // G. gather ids; mask invalid and in-pool ids (and, bitonic, leave
    // each id's lowest slot of the hop in the table)
    const int Ct = n_take * M;
    const int* table = a.table;
    int n_rows = a.n_rows;
    if (upper) {   // read as values: no address of a param
      const volatile LayerRef& r = k5_ref;
      table = r.table;
      n_rows = r.n_rows;
    }
    for (int c = tid; c < C; c += NT) {
      int id = -1, pos = 0;
      if (c < Ct) {
        const int e = c / M, m = c - e * M;
        int row = sel_cur[e];
        if (BLOCKS)
          prefetch_l2(static_cast<const char*>(a.blocks) +
                          ((size_t)row * a.block_m + m) * D * ES,
                      D * ES);
        if (a.upper_map != nullptr) {
          const int u = __ldg(a.upper_map + row);
          row = u < 0 ? -1 : min(u, n_rows - 1);
        }
        if (row >= 0) id = __ldg(table + (size_t)row * a.width + m);
        if (id >= 0) {
          if (!BLOCKS && PREFETCH)
            prefetch_l2(static_cast<const char*>(a.vectors) +
                            (size_t)id * D * ES,
                        D * ES);
          pos = tab_probe(tab, mask, shift, id, c, !sort_merge);
          if (pos < 0) id = -1;
        }
      }
      cand_id[c] = id;
      cand_pos[c] = pos;
    }
    __syncthreads();
    PHASE_MARK(PH_GATHER);

    // L. warp 0: the list of candidates to score, in slot order
    // (bitonic: a slot whose id's table entry names a lower slot is a
    // later copy)
    if (warp == 0) {
      int n = 0;
      for (int base = 0; base < Ct; base += 32) {
        const int c = base + lane;
        bool ok = c < Ct && cand_id[c] >= 0;
        if (ok && !sort_merge)
          ok = static_cast<unsigned>(tab[cand_pos[c]]) ==
               static_cast<unsigned>(c + 1);
        const unsigned bal = __ballot_sync(FULL, ok);
        if (ok) ok_slot[n + __popc(bal & lanes_below(lane))] = c;
        n += __popc(bal);
      }
      if (lane == 0) counts[1] = n;
    } else {
      // the other warps lay out the merge buffer (bitonic: the pool,
      // then an INF pad; sort: INF)
      lay_out_buffer(pool_d, pool_i, buf_d, buf_i, P, WB, sort_merge);
    }
    __syncthreads();
    PHASE_MARK(PH_LIST);
    const int n_ok = counts[1];

    // C. score; the candidates that can enter the pool leave their keys;
    // the table is cleared for the next hop
    for (int h = tid; h < H; h += NT) tab[h] = EMPTY;
    score_list<SCORE, VEC>(a, qop, qsq, scale, sel_cur, cand_id, ok_slot,
                           ok_d, n_ok, pool_d[P - 1], keys, counts + 2);
    __syncthreads();
    PHASE_MARK(PH_SCORE);
    ++hops;
    n_exp += n_take;
    n_scored += n_ok;
    const int ng = counts[2];
    if (ng == 0) continue;   // no candidate reaches the first P outputs

    // R. rank the entering candidates by (distance, slot) and merge. A
    // scored candidate ranks before the masked slots (INF, -1) unless its
    // distance is >= INF.
    const int n_masked = C - n_ok;
    if (ng <= 64 && P + C <= SOLO_WIDTH) {
      if (warp == 0)
        rank_merge_warp(a, keys, ng, ok_slot, ok_d, cand_id, n_masked, buf_d,
                        buf_i, so_d, so_i, so_r, pool_d, pool_i);
      __syncthreads();
      continue;
    }
    for (int i = ng + tid; i < NS; i += NT) keys[i] = KEY_PAD;
    __syncthreads();
    block_sort(keys, max(64, 1 << (32 - __clz(ng - 1))));
    // each ranked candidate: bitonic, to W2 - 1 - its rank among all C
    // slots; sort, to the ranked list
    for (int r = tid; r < ng; r += NT)
      place_ranked(keys, r, ok_slot, ok_d, cand_id, n_masked, W2,
                   sort_merge, buf_d, buf_i, so_d, so_i, so_r);
    __syncthreads();
    PHASE_MARK(PH_RANK);
    if (!sort_merge) {
      merge_network<false>(buf_d, buf_i, W2, P, pool_d, pool_i);
      PHASE_MARK(PH_MERGE);
    } else {
      merge_sorted(pool_d, pool_i, so_d, so_i, so_r, ng, n_masked, P, buf_d,
                   buf_i, tid, NT);
      __syncthreads();
      PHASE_MARK(PH_MERGE);
      if (warp == 0) dedup_compact(buf_d, buf_i, pool_d, pool_i, P);
      __syncthreads();
      PHASE_MARK(PH_COMPACT);
    }
  }
  return hops;
}

// ---- K2: one layer a launch ------------------------------------------------

template <int SCORE, bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    beam_search_kernel(Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x, P = a.P;
  load_query(reinterpret_cast<float*>(smem), a.queries + (size_t)b * a.D,
             a.D, a.round_q);
  int n_exp = 0, n_scored = 0;
  const int hops = layer_search<SCORE, VEC, true>(
      a, false, a.start_ids + (size_t)b * a.s_in,
      a.start_d + (size_t)b * a.s_in, a.s_in, a.q_sq[b], n_exp, n_scored);
  // the pool is ascending with its empty slots last: the twin's final
  // stable sort leaves it as it is
  const float* pool_d = reinterpret_cast<const float*>(smem + a.L.pool_d);
  const int* pool_i = reinterpret_cast<const int*>(smem + a.L.pool_i);
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
#ifdef BEAM_PHASE_CLOCKS
  if (tid == 0 && a.clocks != nullptr)
    for (int i = 0; i < N_PHASE; ++i)
      a.clocks[(size_t)b * N_PHASE + i] = clk[i];
#endif
}

// ---- K5: every layer of a search a launch ----------------------------------

#ifndef BEAM_PHASE_CLOCKS
constexpr int MAX_UP = 64;   // upper layers K5 takes

struct GraphParams {
  Params up;               // the upper layers' shapes, row store, rounding
  Params l0;               // layer 0's (its table in l0.table)
  const int* up_table[MAX_UP];   // layer l's neighbour rows at l - 1
  int up_rows[MAX_UP];           // their rows (compact tables)
  int n_up;                // upper layers searched: L - 1, or 0 with seeds
  const int* entry;        // [] the graph's entry slot (no seeds)
  const int* seeds;        // [B, s_in] layer-0 entries, -1 padded, or null
  int s_in;
  int n_seed;              // entries layer 0 starts from: min(s_in, P0), or 1
  int cap;                 // slots: an id is clamped to cap - 1 to be scored
  int k;                   // results a query
  int R;                   // the rerank's window (0: the pool's first k)
  int rr_score;            // the rerank's rows: S_F32, S_F16ROW or S_B16ROW
  const void* rr_vectors;  // [cap, D] those rows
  int seed_off;            // byte offset of the entries in shared memory
  float* out_d;            // [B, k]
  int* out_i;              // [B, k]
  int* hops;               // [n_up + 1, B]: the top layer first
  long long* clocks;       // [B, N_GROUP, N_PHASE + 1] (GRAPH_PHASE_CLOCKS)
};

#ifdef GRAPH_PHASE_CLOCKS
// Each group's phase cycles, then its rows scored (thread 0 keeps them).
__shared__ long long gclk[N_GROUP * (N_PHASE + 1)];

__device__ __forceinline__ void clocks_start() {
  if (threadIdx.x == 0) {
    for (int i = 0; i < N_GROUP * (N_PHASE + 1); ++i) gclk[i] = 0;
    for (int i = 0; i < N_PHASE; ++i) clk[i] = 0;
    clk[N_PHASE] = clock64();
  }
}

// The cycles counted since the last fold into group grp, and rows scored.
__device__ __forceinline__ void clocks_fold(int grp, int rows) {
  if (threadIdx.x == 0) {
    long long* c = gclk + grp * (N_PHASE + 1);
    for (int i = 0; i < N_PHASE; ++i) {
      c[i] += clk[i];
      clk[i] = 0;
    }
    c[N_PHASE] += rows;
  }
}

__device__ __forceinline__ void clocks_write(long long* out) {
  if (threadIdx.x == 0 && out != nullptr)
    for (int i = 0; i < N_GROUP * (N_PHASE + 1); ++i)
      out[(size_t)blockIdx.x * N_GROUP * (N_PHASE + 1) + i] = gclk[i];
}

// valid ids among ids[0, n) (thread 0's count of rows scored)
__device__ __forceinline__ int count_valid(const int* ids, int n) {
  int r = 0;
  for (int i = 0; i < n; ++i) r += ids[i] >= 0;
  return r;
}
#endif

// The distance from the query in qop to row ``id`` of ``vectors`` in row
// mode SCORE, by one warp (element by element, any alignment; a shuffle
// sum that leaves the same value in every lane), as _score_hop scores it.
template <int SCORE>
__device__ __forceinline__ float row_dist(const void* vectors,
                                          const float* sq_norms,
                                          const float* qscale, int metric,
                                          int D, const float* qop, float qsq,
                                          int id) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int k = lane; k < D; k += 32)
    acc = fmaf(qop[k], elem_at<SCORE>(vectors, (size_t)id * D + k), acc);
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  if (SCORE == S_Q8ROW) acc = __fmul_rn(acc, __ldg(qscale + id));
  return epilogue(metric, acc, qsq, __ldg(sq_norms + id));
}

// The rerank's f32 distance (the query unrounded, the row store's values
// as f32).
__device__ __forceinline__ float rerank_dist(const GraphParams& g,
                                             const float* qop, float qsq,
                                             int id) {
  const int D = g.l0.D;
  if (g.rr_score == S_F16ROW)
    return row_dist<S_F16ROW>(g.rr_vectors, g.up.sq_norms, nullptr,
                              g.up.metric, D, qop, qsq, id);
  if (g.rr_score == S_B16ROW)
    return row_dist<S_B16ROW>(g.rr_vectors, g.up.sq_norms, nullptr,
                              g.up.metric, D, qop, qsq, id);
  return row_dist<S_F32>(g.rr_vectors, g.up.sq_norms, nullptr, g.up.metric,
                         D, qop, qsq, id);
}

// One block a query, as K2, through every layer: the entries (the graph's
// entry, or the caller's seeds) scored in the upper layers' mode SCOREUP;
// each upper layer's narrow beam (layer_search on its own table), whose
// best entry, where it has one, is the next layer's entry; layer 0 in its
// mode SCORE0; then the f32 rerank of the pool's head (R > 0: the first R
// ids scored at full precision, -1 ids at INF, a stable rank by distance,
// the first k written, -1 at INF) or the pool's first k. Each layer's hop
// count goes to its row of ``hops``.
// blockIdx.x, read anew where it is used (volatile: not kept in a register
// across the layers)
__device__ __forceinline__ int block_index() {
  int b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}

// threadIdx.x, read anew where it is used after the layers (volatile)
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// K5's query row in device memory
__device__ __forceinline__ const float* query_row(const GraphParams& g) {
  return g.l0.queries + (size_t)block_index() * g.l0.D;
}

// K5's entries in shared memory (n_seed ids, then their distances), at an
// offset taken anew where they are used (volatile: no pointer to them is
// kept in a register across the layers)
__device__ __forceinline__ int* seed_ids(const GraphParams& g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int off;
  asm volatile("mov.b32 %0, %1;" : "=r"(off) : "r"(g.seed_off));
  return reinterpret_cast<int*>(smem + off);
}
__device__ __forceinline__ float* seed_dists(const GraphParams& g) {
  return reinterpret_cast<float*>(seed_ids(g) + g.n_seed);
}

template <int SCORE0, int SCOREUP, bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    graph_search_kernel(GraphParams g) {
  // Each step takes the thread's and the block's index, the query's
  // squared norm and the entries' place anew (thread_index, block_index,
  // q_sq, seed_ids): the layers' bodies keep the registers to themselves.
  extern __shared__ __align__(16) unsigned char smem[];
  float* const qop = reinterpret_cast<float*>(smem);
  volatile LayerRef* const ref = &k5_ref;

  // 1. the entries, a warp each, as the upper layers score rows
  {
    const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
    const float qsq = g.l0.q_sq[block_index()];
#ifdef GRAPH_PHASE_CLOCKS
    clocks_start();
#endif
    load_query(qop, query_row(g), g.l0.D, g.up.round_q);
    if (tid == 0) ref->layer = g.n_up;
    __syncthreads();
    for (int s = warp; s < g.n_seed; s += NW) {
      const int id = g.seeds != nullptr
                         ? __ldg(g.seeds + (size_t)block_index() * g.s_in + s)
                         : __ldg(g.entry);
      float d = INF_DIST;
      if (id >= 0)
        d = row_dist<SCOREUP>(g.up.vectors, g.up.sq_norms, g.up.qscale,
                              g.up.metric, g.l0.D, qop, qsq,
                              min(id, g.cap - 1));
      if (lane == 0) {
        seed_ids(g)[s] = id >= 0 ? id : -1;
        seed_dists(g)[s] = d;
      }
    }
    __syncthreads();
#ifdef GRAPH_PHASE_CLOCKS
    PHASE_MARK(PH_SCORE);
    clocks_fold(G_ENTRY, tid == 0 ? count_valid(seed_ids(g), g.n_seed) : 0);
#endif
  }

  // 2. the upper layers, the top first: a pool's best entry, where it has
  // one, is the next layer's entry. The layer, its table and rows live in
  // ref; layer_search's first barrier orders thread 0's writes.
  int n_exp = 0, n_scored = 0;
  for (;;) {
    const int l = ref->layer;
    if (l < 1) break;
    if (thread_index() == 0) {
      ref->table = g.up_table[l - 1];
      ref->n_rows = g.up_rows[l - 1];
    }
    const int hops = layer_search<SCOREUP, VEC, false>(
        g.up, true, seed_ids(g), seed_dists(g), 1, g.l0.q_sq[block_index()],
        n_exp, n_scored);
    if (thread_index() == 0) {
      const int lt = ref->layer;
      g.hops[(size_t)(g.n_up - lt) * gridDim.x + block_index()] = hops;
      ref->layer = lt - 1;
      const float d = reinterpret_cast<const float*>(smem + g.up.L.pool_d)[0];
      const int i = reinterpret_cast<const int*>(smem + g.up.L.pool_i)[0];
      if (d < INF_DIST && unpack(i) >= 0) {
        seed_ids(g)[0] = unpack(i);
        seed_dists(g)[0] = d;
      }
    }
    __syncthreads();
#ifdef GRAPH_PHASE_CLOCKS
    PHASE_MARK(PH_DEDUP);
#endif
  }
#ifdef GRAPH_PHASE_CLOCKS
  clocks_fold(G_UPPER, n_scored);
  n_scored = 0;
#endif

  // 3. layer 0 (layer_search's first barrier orders the new query row)
  load_query(qop, query_row(g), g.l0.D, g.l0.round_q);
  const int hops0 = layer_search<SCORE0, VEC, false>(
      g.l0, false, seed_ids(g), seed_dists(g), g.n_seed,
      g.l0.q_sq[block_index()], n_exp, n_scored);
#ifdef GRAPH_PHASE_CLOCKS
  clocks_fold(G_LAYER0, n_scored);
#endif
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const float* pool_d = reinterpret_cast<const float*>(smem + g.l0.L.pool_d);
  const int* pool_i = reinterpret_cast<const int*>(smem + g.l0.L.pool_i);
  float* const out_d = g.out_d + (size_t)block_index() * g.k;
  int* const out_i = g.out_i + (size_t)block_index() * g.k;
  if (tid == 0)
    g.hops[(size_t)g.n_up * gridDim.x + block_index()] = hops0;
  if (g.R == 0) {
    for (int p = tid; p < g.k; p += NT) {
      const float d = pool_d[p];
      out_d[p] = d;
      out_i[p] = d >= INF_DIST ? -1 : unpack(pool_i[p]);
    }
#ifdef GRAPH_PHASE_CLOCKS
    __syncthreads();
    PHASE_MARK(PH_RANK);
    clocks_fold(G_RERANK, 0);
    clocks_write(g.clocks);
#endif
    return;
  }

  // 4. the f32 rerank of the pool's head, into layer 0's merge buffer
  const float qsq = g.l0.q_sq[block_index()];
  float* const rd = reinterpret_cast<float*>(smem + g.l0.L.buf_d);
  int* const ri = reinterpret_cast<int*>(smem + g.l0.L.buf_i);
  load_query(qop, query_row(g), g.l0.D, 0);
  __syncthreads();
  for (int r = warp; r < g.R; r += NW) {
    const float pd = pool_d[r];
    const int id = pd >= INF_DIST ? -1 : unpack(pool_i[r]);
    const float d = id >= 0 ? rerank_dist(g, qop, qsq, min(id, g.cap - 1))
                            : INF_DIST;
    if (lane == 0) {
      rd[r] = d;
      ri[r] = id;
    }
  }
  __syncthreads();
#ifdef GRAPH_PHASE_CLOCKS
  PHASE_MARK(PH_SCORE);
#endif
  // a stable sort by distance (ties in pool order): each entry's rank
  for (int r = tid; r < g.R; r += NT) {
    const float d = rd[r];
    int rank = 0;
    for (int t = 0; t < g.R; ++t) {
      const float e = rd[t];
      rank += (e < d) || (e == d && t < r);
    }
    if (rank < g.k) {
      out_d[rank] = d;
      out_i[rank] = d >= INF_DIST ? -1 : ri[r];
    }
  }
#ifdef GRAPH_PHASE_CLOCKS
  __syncthreads();
  PHASE_MARK(PH_RANK);
  clocks_fold(G_RERANK, tid == 0 ? count_valid(ri, g.R) : 0);
  clocks_write(g.clocks);
#endif
}
#endif  // BEAM_PHASE_CLOCKS

int next_pow2(int n) {
  int w = 1;
  while (w < n) w <<= 1;
  return w;
}

// table slots: twice the keys it may hold (bitonic: pool and candidate
// ids; sort: pool ids)
int table_slots(int P, int C, int merge_sort) {
  return next_pow2(2 * (P + (merge_sort ? 0 : C)));
}

int key_slots(int C) { return next_pow2(C) > 64 ? next_pow2(C) : 64; }

Layout layout(int D, int P, int E, int M, int merge_sort) {
  const int C = E * M, SC = merge_sort ? C : 0;
  const int WB = merge_sort ? P : next_pow2(P + C);
  Layout L;
  int o = 4 * ((D + 3) & ~3);
  L.tab = o;      o += 8 * table_slots(P, C, merge_sort);
  L.keys = o;     o += 8 * key_slots(C);
  L.pool_d = o;   o += 4 * P;
  L.pool_i = o;   o += 4 * P;
  L.buf_d = o;    o += 4 * WB;
  L.buf_i = o;    o += 4 * WB;
  L.cand_id = o;  o += 4 * C;
  L.cand_pos = o; o += 4 * C;
  L.ok_slot = o;  o += 4 * C;
  L.ok_d = o;     o += 4 * C;
  L.so_d = o;     o += 4 * SC;
  L.so_i = o;     o += 4 * SC;
  L.so_r = o;     o += 4 * SC;
  L.sel_j = o;    o += 4 * E;
  L.sel_cur = o;  o += 4 * E;
  L.counts = o;   o += 16;
  L.bytes = o;
  return L;
}

size_t smem_bytes(int D, int P, int E, int M, int merge_sort) {
  return (size_t)layout(D, P, E, M, merge_sort).bytes;
}

// A layer's shapes in ``p``: the candidate block, merge widths, table and
// key slots, the hash's shift and the shared-memory layout.
void set_shape(Params& p, int D, int P, int E, int M, int merge_sort) {
  p.D = D;
  p.P = P;
  p.E = E;
  p.M = M;
  p.merge_sort = merge_sort;
  p.C = E * M;
  p.W2 = next_pow2(P + p.C);
  p.WB = merge_sort ? P : p.W2;
  p.H = table_slots(P, p.C, merge_sort);
  p.NS = key_slots(p.C);
  p.shift = 32;
  for (int h = p.H; h > 1; h >>= 1) --p.shift;   // 32 - log2(H)
  p.L = layout(D, P, E, M, merge_sort);
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

#ifdef PHASE_CLOCKS
long long* g_clocks = nullptr;   // the next launch's phase counters
#endif
#ifdef GRAPH_RESIDENCY_PAD
int g_pad = 0;   // bytes of shared memory a K5 block takes beyond its need
#endif

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

#ifndef BEAM_PHASE_CLOCKS
typedef void (*GraphKernel)(GraphParams);

template <int SCORE0, int SCOREUP>
GraphKernel graph_kernel_vec(bool vec) {
  return vec ? graph_search_kernel<SCORE0, SCOREUP, true>
             : graph_search_kernel<SCORE0, SCOREUP, false>;
}

// layer 0 on neighbour blocks: the upper layers and the entries on any row
// mode
template <int SCORE0>
GraphKernel graph_kernel_up(int up, bool vec) {
  switch (up) {
    case S_F32: return graph_kernel_vec<SCORE0, S_F32>(vec);
    case S_BF16: return graph_kernel_vec<SCORE0, S_BF16>(vec);
    case S_Q8ROW: return graph_kernel_vec<SCORE0, S_Q8ROW>(vec);
    case S_F16ROW: return graph_kernel_vec<SCORE0, S_F16ROW>(vec);
    case S_B16ROW: return graph_kernel_vec<SCORE0, S_B16ROW>(vec);
    default: return nullptr;
  }
}

// K5's instantiation for layer 0's mode and the upper layers' (the same
// row mode unless layer 0 is on blocks), or null for a pair it lacks
GraphKernel graph_kernel(int score0, int up, bool vec) {
  switch (score0) {
    case S_I8: return graph_kernel_up<S_I8>(up, vec);
    case S_F16: return graph_kernel_up<S_F16>(up, vec);
    case S_F32:
      return up == S_F32 ? graph_kernel_vec<S_F32, S_F32>(vec) : nullptr;
    case S_BF16:
      return up == S_BF16 ? graph_kernel_vec<S_BF16, S_BF16>(vec) : nullptr;
    case S_Q8ROW:
      return up == S_Q8ROW ? graph_kernel_vec<S_Q8ROW, S_Q8ROW>(vec)
                           : nullptr;
    case S_F16ROW:
      return up == S_F16ROW ? graph_kernel_vec<S_F16ROW, S_F16ROW>(vec)
                            : nullptr;
    case S_B16ROW:
      return up == S_B16ROW ? graph_kernel_vec<S_B16ROW, S_B16ROW>(vec)
                            : nullptr;
    default: return nullptr;
  }
}

// K5's dynamic shared memory: the larger layout of the layers it searches
// (layer 0, and the upper layers' when n_up > 0), then the entries (n_seed
// ids and distances) at *seed_off.
int graph_smem(int D, int P_up, int E_up, int M_up, int n_up, int P0,
               int E0, int M0, int merge_sort, int n_seed, int* seed_off) {
  int o = layout(D, P0, E0, M0, merge_sort).bytes;
  if (n_up > 0) {
    const int u = layout(D, P_up, E_up, M_up, merge_sort).bytes;
    o = u > o ? u : o;
  }
  o = (o + 7) & ~7;
  if (seed_off != nullptr) *seed_off = o;
  return o + 8 * n_seed;
}
#endif  // BEAM_PHASE_CLOCKS

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes (ops/beam_search.py
// computes the same number to decide which calls take the kernel).
int beam_search_smem_bytes(int D, int P, int E, int M, int merge_sort) {
  return (int)smem_bytes(D, P, E, M, merge_sort);
}

// One launch: B blocks, one query each. score: 0 f32 rows, 1 f32 rows with
// bf16 operands, 2 int8 blocks, 3 fp16 blocks, 4 int8 rows with per-row
// scales (vectors = qvec [cap, D] int8, qscale [cap]), 5 fp16 rows, 6 bf16
// rows. round_q: the query rounded to bf16 (1 for scores 1, 2 and 4, and
// for 6 at DEFAULT; ops/beam_search.rounds_operands). metric: 0 cosine,
// 1 l2, 2 sqeuclidean, 3 dot. merge_sort: 0 bitonic, 1 sort. Returns the
// cudaError_t of the launch.
int beam_search_launch(const void* queries, const void* q_sq,
                       const void* start_ids, const void* start_d, int s_in,
                       const void* table, int width, const void* upper_map,
                       int n_rows, const void* vectors, const void* sq_norms,
                       const void* qscale, const void* blocks, int block_m,
                       const void* block_scale, int B, int D, int P, int E,
                       int M, int max_hops, int metric, int score,
                       int merge_sort, int normalized, int round_q,
                       void* out_d, void* out_i, void* hops, void* work,
                       void* stream) {
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
  p.vectors = vectors;
  p.sq_norms = static_cast<const float*>(sq_norms);
  p.qscale = static_cast<const float*>(qscale);
  p.round_q = round_q;
  p.blocks = blocks;
  p.block_m = block_m;
  p.block_scale = static_cast<const float*>(block_scale);
  p.max_hops = max_hops;
  p.metric = metric;
  p.normalized = normalized;
  set_shape(p, D, P, E, M, merge_sort);
  p.out_d = static_cast<float*>(out_d);
  p.out_i = static_cast<int*>(out_i);
  p.hops = static_cast<int*>(hops);
  p.work = static_cast<int*>(work);
#ifdef BEAM_PHASE_CLOCKS
  p.clocks = g_clocks;
#else
  p.clocks = nullptr;
#endif
  const size_t smem = (size_t)p.L.bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // whole-row vector loads (4 elements a lane): rows start at multiples of
  // D elements, so D % 4 == 0 and a base aligned to 4 elements keep every
  // row aligned
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
    case S_Q8ROW:
      return (int)launch_vec<S_Q8ROW>(p, vec4 && aligned(vectors, 4), B,
                                      smem, st);
    case S_F16ROW:
      return (int)launch_vec<S_F16ROW>(p, vec4 && aligned(vectors, 8), B,
                                       smem, st);
    case S_B16ROW:
      return (int)launch_vec<S_B16ROW>(p, vec4 && aligned(vectors, 8), B,
                                       smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#ifdef BEAM_PHASE_CLOCKS
// Phase counters of the next launches: [B, N_PHASE] int64 on the device,
// or null (tools/hop_split.py).
int beam_search_phase_count() { return N_PHASE; }
void beam_search_set_clocks(void* clocks) {
  g_clocks = static_cast<long long*>(clocks);
}
#endif

// The SM clock in kHz (cudaDevAttrClockRate of the current device).
int beam_search_clock_khz() {
  int dev = 0, khz = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev) != cudaSuccess)
    return 0;
  return khz;
}

// Resident blocks an SM of one instantiation at ``smem`` bytes of dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int beam_search_blocks_per_sm(int score, int vec, int smem) {
  int n = 0;
  const void* f = nullptr;
  switch (score * 2 + (vec ? 1 : 0)) {
    case 0: f = (const void*)beam_search_kernel<S_F32, false>; break;
    case 1: f = (const void*)beam_search_kernel<S_F32, true>; break;
    case 2: f = (const void*)beam_search_kernel<S_BF16, false>; break;
    case 3: f = (const void*)beam_search_kernel<S_BF16, true>; break;
    case 4: f = (const void*)beam_search_kernel<S_I8, false>; break;
    case 5: f = (const void*)beam_search_kernel<S_I8, true>; break;
    case 6: f = (const void*)beam_search_kernel<S_F16, false>; break;
    case 7: f = (const void*)beam_search_kernel<S_F16, true>; break;
    case 8: f = (const void*)beam_search_kernel<S_Q8ROW, false>; break;
    case 9: f = (const void*)beam_search_kernel<S_Q8ROW, true>; break;
    case 10: f = (const void*)beam_search_kernel<S_F16ROW, false>; break;
    case 11: f = (const void*)beam_search_kernel<S_F16ROW, true>; break;
    case 12: f = (const void*)beam_search_kernel<S_B16ROW, false>; break;
    case 13: f = (const void*)beam_search_kernel<S_B16ROW, true>; break;
    default: return -1;
  }
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, f, NT, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

#ifndef BEAM_PHASE_CLOCKS
// K5's dynamic shared memory of one block, in bytes (ops/graph_search.py
// computes the same number): n_up upper layers at (P_up, E_up, M_up),
// layer 0 at (P0, E0, M0), n_seed entries.
int graph_search_smem_bytes(int D, int P_up, int E_up, int M_up, int n_up,
                            int P0, int E0, int M0, int merge_sort,
                            int n_seed) {
  return graph_smem(D, P_up, E_up, M_up, n_up, P0, E0, M0, merge_sort,
                    n_seed, nullptr);
}

// One launch of K5: B blocks, one query each, every layer. queries [B, D]
// and q_sq [B] f32 as K2 takes them. entry: the
// graph's entry slot ([] int32) where seeds is null, else seeds [B, s_in]
// int32, -1 padded (layer 0 starts from the first min(s_in, P0)).
// up_tables / up_rows: host arrays of the n_up upper layers' neighbour
// tables (layer l at l - 1; rows through upper_map where it is not null)
// and their row counts, each up_width wide; table0 [cap, width0] layer 0's.
// vectors: the upper layers' and the entries' row store (score_up: 0 f32,
// 1 f32 with bf16 operands, 4 int8 rows with qscale, 5 fp16, 6 bf16), and
// layer 0's where score0 is a row mode; blocks, block_m, block_scale layer
// 0's where score0 is 2 (int8) or 3 (fp16). rr_vectors / rr_score (0, 5 or
// 6): the rerank's rows, over the first R entries of the pool (R = 0: the
// pool's first k). round_up / round_0: the query rounded to bf16 on the
// upper layers (and the entries) / on layer 0. Outputs: out_d [B, k] f32,
// out_i [B, k] int32, hops [n_up + 1, B] int32 (the top layer first).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a pair
// of modes or a layer count it lacks).
int graph_search_launch(
    const void* queries, const void* q_sq, const void* entry,
    const void* seeds, int s_in, int n_up, const void* const* up_tables,
    const int* up_rows, int up_width, const void* upper_map,
    const void* table0, int width0,
    const void* vectors, const void* sq_norms, const void* qscale,
    const void* blocks, int block_m, const void* block_scale,
    const void* rr_vectors, int rr_score, int R, int k, int B, int D,
    int cap, int P_up, int E_up, int M_up, int P0, int E0, int M0,
    int max_hops, int metric, int score_up, int score0, int merge_sort,
    int normalized, int round_up, int round_0, void* out_d, void* out_i,
    void* hops, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (n_up < 0 || n_up > MAX_UP || is_blocks(score_up))
    return (int)cudaErrorInvalidValue;
  GraphParams g;
  Params* both[2] = {&g.up, &g.l0};
  for (Params* p : both) {
    p->queries = static_cast<const float*>(queries);
    p->q_sq = static_cast<const float*>(q_sq);
    p->start_ids = nullptr;
    p->start_d = nullptr;
    p->s_in = 0;
    p->vectors = vectors;
    p->sq_norms = static_cast<const float*>(sq_norms);
    p->qscale = static_cast<const float*>(qscale);
    p->blocks = blocks;
    p->block_m = block_m;
    p->block_scale = static_cast<const float*>(block_scale);
    p->max_hops = max_hops;
    p->metric = metric;
    p->normalized = normalized;
    p->out_d = nullptr;
    p->out_i = nullptr;
    p->hops = nullptr;
    p->work = nullptr;
    p->clocks = nullptr;
  }
  set_shape(g.up, D, P_up, E_up, M_up, merge_sort);
  g.up.table = nullptr;
  g.up.width = up_width;
  g.up.upper_map = static_cast<const int*>(upper_map);
  g.up.n_rows = 0;
  g.up.round_q = round_up;
  set_shape(g.l0, D, P0, E0, M0, merge_sort);
  g.l0.table = static_cast<const int*>(table0);
  g.l0.width = width0;
  g.l0.upper_map = nullptr;
  g.l0.n_rows = cap;
  g.l0.round_q = round_0;
  for (int l = 0; l < MAX_UP; ++l) {
    g.up_table[l] = l < n_up ? static_cast<const int*>(up_tables[l]) : nullptr;
    g.up_rows[l] = l < n_up ? up_rows[l] : 0;
  }
  g.n_up = n_up;
  g.entry = static_cast<const int*>(entry);
  g.seeds = static_cast<const int*>(seeds);
  g.s_in = s_in;
  g.n_seed = seeds != nullptr ? (s_in < P0 ? s_in : P0) : 1;
  if (g.n_seed < 1) return (int)cudaErrorInvalidValue;
  g.cap = cap;
  g.k = k;
  g.R = R;
  g.rr_score = rr_score;
  g.rr_vectors = rr_vectors;
  g.out_d = static_cast<float*>(out_d);
  g.out_i = static_cast<int*>(out_i);
  g.hops = static_cast<int*>(hops);
#ifdef GRAPH_PHASE_CLOCKS
  g.clocks = g_clocks;
#else
  g.clocks = nullptr;
#endif
  size_t smem = (size_t)graph_smem(D, P_up, E_up, M_up, n_up, P0, E0, M0,
                                   merge_sort, g.n_seed, &g.seed_off);
#ifdef GRAPH_RESIDENCY_PAD
  smem += g_pad;
#endif
  // whole-row vector loads, as K2 takes them: D % 4 == 0 and every scored
  // store's base aligned to 4 elements
  const uintptr_t row_align = 4 * elem_bytes(score_up);
  bool vec = D % 4 == 0 && aligned(vectors, row_align);
  if (is_blocks(score0)) vec = vec && aligned(blocks, 4 * elem_bytes(score0));
  const GraphKernel f = graph_kernel(score0, score_up, vec);
  if (f == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  f<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

#ifdef GRAPH_PHASE_CLOCKS
// Phase counters of the next K5 launches: [B, N_GROUP, N_PHASE + 1] int64
// on the device (each group's phase cycles, then its rows scored), or null
// (tools/graph_split.py).
int graph_search_clock_cols() { return N_GROUP * (N_PHASE + 1); }
void graph_search_set_clocks(void* clocks) {
  g_clocks = static_cast<long long*>(clocks);
}
#endif

#ifdef GRAPH_RESIDENCY_PAD
// The residency probe's build (tools/graph_split.py --resident): the next
// K5 launches take ``bytes`` of dynamic shared memory a block beyond their
// need, so that fewer blocks fit an SM. The results do not change.
void graph_search_set_pad(int bytes) { g_pad = bytes > 0 ? bytes : 0; }
#endif

// Resident blocks an SM of one K5 instantiation at ``smem`` bytes of
// dynamic shared memory, or -1 for a pair of modes it lacks.
int graph_search_blocks_per_sm(int score0, int score_up, int vec, int smem) {
  const GraphKernel f = graph_kernel(score0, score_up, vec != 0);
  int n = 0;
  if (f == nullptr) return -1;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, f, NT, smem) !=
      cudaSuccess)
    return -1;
  return n;
}
#endif  // BEAM_PHASE_CLOCKS

}  // extern "C"
