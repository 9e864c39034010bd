// Decode attention for one query token per row over a dense, heads-major KV
// cache or a paged KV pool, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the reference package:
//   - adversarial_spec_tpu/ops/pallas_decode.py:125 _decode_attn_kernel
//     (B1, reached through decode_attention): every S=1 dense decode step;
//   - adversarial_spec_tpu/ops/pallas_paged.py:52 _paged_attn_kernel (B3,
//     reached through paged_decode_attention): B1 through a page table over
//     a shared page pool (the continuous batcher's S=1 decode).
// The speculative verify (S > 1 query positions per row: B2, B4) is
// verify_attention.cu. One body serves both, each over a float cache (K/V
// in q's type) or an int8 cache (the reference's kv_dtype="int8": int8 K/V
// with per-(token, head) f32 scales): four entries. Two template switches
// pick the entry: the K/V element type (q's type or int8_t) and kPaged, the
// slot-address policy. Each entry has its own launch counter on the Python
// side (ops/decode_attention.py and ops/paged_attention.py, an `_int8kv`
// counter for the int8 cache).
//
// What bounds it: the bytes of K and V it reads. At the main paths' shapes
// (Llama-3-8B: Hkv=8, g=4 query heads per KV head, D=128, bf16; thousands
// of cached slots per row) a call does ~2 flops per K/V byte (~4 for int8),
// against the card's ~295 flops/byte balance, so the floor is bytes / 3.35
// TB/s: ~11 us for the dense smoke's 37.9 MB.
//
// What the design does about it:
//   - Split-KV (flash-decoding) grid (n_split, Hkv * n_chunks, B). The
//     block for (row, KV head) clips the row's window [lo, hi) to [0, T),
//     cuts the window's tiles into n_split near-equal contiguous runs
//     (split_kv.cuh split_run) and streams run blockIdx.x. n_split comes
//     from shapes alone (ops/split_kv.py plan_splits at this kernel's own
//     four blocks per SM), so no host ever reads the bounds or the table
//     and the call can be captured in a CUDA graph. With n_split > 1 each
//     block writes an f32 partial (m, l, unnormalized acc [g, D]) and
//     split_kv.cuh's combine merges them by the log-sum-exp rescale; with
//     n_split = 1 the block writes the output.
//   - A 3-stage cp.async ring of 16-byte copies: two tiles are in flight
//     while a third is scored. A tile is 16 KB of K and V (32 slots of bf16
//     D=128 rows, 64 of int8 ones), so the four resident blocks of an SM
//     keep ~128 KB in flight. Slots outside the window, past T or in an
//     unmapped page are zero-filled by the copy (source size 0), never
//     loaded. Rows whose address or strides are not 16-byte aligned are
//     staged element by element in the same ring (no overlap).
//   - CUDA cores, not tensor cores: g = 4 query rows are below any MMA
//     tile, and the arithmetic is far below the balance point. Each lane
//     owns 8 elements of D (a group of D / 8 lanes holds one K/V row) and
//     holds them of every query row of the block in registers, as f32
//     pre-scaled q, together with its accumulator slice. A lane group
//     reads a K row as 16-byte vectors from shared memory and dots it with
//     all g rows at once; the partial sums of 4 slots x 4 rows are summed
//     over the group by one butterfly (reduce-scatter then all-gather:
//     30 shuffles for 16 sums where a shuffle per sum per level takes 64).
//   - Each lane group keeps its own online-softmax state (m, l) and P.V
//     accumulators over its share of every tile's slots; groups and then
//     warps merge once, at the end of the block's run (shuffles, then
//     shared memory). The ring's one barrier per tile is the only
//     block-wide one inside the loop. Masks apply only on tiles that
//     straddle a window edge, the softcap only when one is set. bf16 q is
//     pre-scaled by log2(e) as well, so scores, running maxima and every
//     exponent are in log2 units and each exponent is one exp2f, as in the
//     verify kernels (a partial's max is written back in natural units for
//     the shared combine); f32 q keeps expf, the reference's exp.
//   - int8 K/V: each element is dequantized in f32 as float(k8) * ks[t]
//     before its product (and v the same), the reference's order
//     (ops/flash_common.py flash_update_heads). f32 q: exact CUDA-core f32
//     arithmetic, no TF32.
//
// Paged pools: physical page 0 is the trash page (inactive rows and
// rejected drafts write arbitrary K/V there) and negative ids are table
// padding. The block reads the page ids from the table itself; a slot of a
// page whose id is <= 0 is never loaded (values and scale page alike) and
// never scored. When the page size is a multiple of the tile, a tile lies
// in one page and such a page is skipped whole, block-uniformly (the ring's
// barrier ORs every thread's "staged a mapped slot"). Other page sizes
// (any from 1 up) gather several pages, or parts of two, per tile, and the
// masks then check each slot's page.
//
// Layout and contract (checked again by the Python wrappers):
//   q   [B, Hq, D], D contiguous
//   dense: k,v [B, Hkv, T, D] any strides except D contiguous: a layer's
//          slice of the [L, B, Hkv, T, D] cache needs no copy
//   paged: k,v [n_pages, Hkv, page, D] (a layer's view of the
//          [L, n_pages, Hkv, page, D] pool), table int32 [B, P] (row
//          stride given, entries contiguous); T = P * page
//   int8 cache: k,v int8 in the same layouts, and ks,vs f32 scales
//          [B, Hkv, T, 1] (dense) or [n_pages, Hkv, page, 1] (paged), any
//          strides; a null ks means a float cache
//   bounds int32 [B, 2] (start, end)
//   out [B, Hq, D] in q's dtype; ws the f32 partials (n_split > 1):
//          acc [n_split, B, Hkv, g, D], then m and l [n_split, B, Hkv, g]
// Each row masks its own [start, end); the ragged tail past T is masked; a
// row with an empty window yields exact zeros; a fully masked row stays
// NaN-free (alpha is forced to 0 while the running max is -inf). Scores
// are (q . k) * scale, then the optional softcap tanh(s / c) * c.

#include "split_kv.cuh"

namespace {

constexpr int kThreads = 128;     // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;   // the launch bound; ops/split_kv.py DECODE_BLOCKS_PER_SM
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kStageBytes = 16384;  // K + V bytes of one staged tile
constexpr int kG = 4;             // query rows per block: the group, padded or chunked
constexpr int kE = 8;             // elements of a K/V row per lane
constexpr int kBatch = 4;         // slots a lane group scores between softmax updates
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  long long q_sb, q_sh;
  // Dense: k_sb is the batch-row stride. Paged: k_sb is the page stride.
  const void* k;
  long long k_sb, k_sh, k_st;
  const void* v;
  long long v_sb, v_sh, v_st;
  // int8 cache only (null for a float cache): per-(slot, head) f32 scales,
  // strides as k's (batch row or page, head, slot).
  const float* ks;
  long long ks_sb, ks_sh, ks_st;
  const float* vs;
  long long vs_sb, vs_sh, vs_st;
  const int* table;  // paged only: [B, P] physical page ids
  long long tb_sb;
  const int* bounds;  // [B, 2] (start, end), row stride bd_sb
  long long bd_sb;
  void* out;
  long long o_sb, o_sh;
  float* ws;  // partials, n_split > 1 only
  // n_chunks: blocks of kG query rows per KV head (ceil(g / kG)); page:
  // slots per page (paged only).
  int B, Hq, Hkv, T, D, page, n_split, n_chunks, vec16;
  float scale, softcap;
};

// Compile-time shape of an entry: head dim kD, K/V element type TK.
template <int kD, typename TK>
struct Shape {
  static constexpr int kL = kD / kE;                       // lanes per K/V row
  static constexpr int kNG = 32 / kL;                      // lane groups per warp
  static constexpr int kGroups = kWarps * kNG;             // lane groups per block
  static constexpr int kRow = kD * (int)sizeof(TK);        // bytes of a K/V row
  static constexpr int kTile = kStageBytes / (2 * kRow);   // slots per tile
  static constexpr int kSpg = kTile / kGroups;             // slots per group per tile
  static constexpr int kB = kSpg < kBatch ? kSpg : kBatch;  // slots per softmax update
  static constexpr int kChunks = kRow / 16;                // 16-byte copies per row
  static_assert(kTile * kChunks % kThreads == 0, "a tile's copies must split over the threads");
  // One ring stage: K rows, V rows, then (int8) the K and V scales.
  static constexpr int kStage = kStageBytes + (is_int8<TK>() ? 2 * kTile * 4 : 0);
  static constexpr int kSmem = kStages * kStage;
  static_assert(kSpg * kGroups == kTile && kSpg % kB == 0, "tile must split over lane groups");
  // The merge scratch (acc, m, l of every warp) reuses the ring.
  static_assert(kWarps * kG * (kD + 2) * 4 <= kSmem, "merge scratch must fit in the ring");
};

// Element e (0..7) of lane li's share of a row: d = li * 8 + e, except f32
// rows, read as two 16-byte halves (li * 4 .. +4 and D / 2 + li * 4 .. +4)
// so a group's loads stay contiguous.
template <typename TK, int kD>
__device__ __forceinline__ int elem_d(int li, int e) {
  if constexpr (std::is_same<TK, float>::value) return e < 4 ? li * 4 + e : kD / 2 + li * 4 + e - 4;
  return li * kE + e;
}

// Lane li's 8 elements of a staged row (elem_d's order), in f32; an int8
// row is dequantized as float(x8) * s, the reference's order.
template <typename TK, int kD>
__device__ __forceinline__ void load_elems(const unsigned char* row, int li, float s,
                                           float (&x)[kE]) {
  if constexpr (std::is_same<TK, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(row + li * 16);
    const float4 b = *reinterpret_cast<const float4*>(row + kD * 2 + li * 16);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (is_int8<TK>()) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + li * 8);
    const char4 a = *reinterpret_cast<const char4*>(&u.x);
    const char4 b = *reinterpret_cast<const char4*>(&u.y);
    x[0] = (float)a.x * s; x[1] = (float)a.y * s; x[2] = (float)a.z * s; x[3] = (float)a.w * s;
    x[4] = (float)b.x * s; x[5] = (float)b.y * s; x[6] = (float)b.z * s; x[7] = (float)b.w * s;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(row + li * 16);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// Sum N values over the lanes of an aligned group whose lane offsets run
// from kO down to 1 (a group of 2 * kO lanes): the butterfly's
// reduce-scatter halves the values each level, the all-gather undoes it,
// and every lane ends with all N sums.
template <int N, int kO>
struct GroupSum {
  static __device__ __forceinline__ void scatter(float* x, int lane) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = lane & kO;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? x[i] : x[i + H];
        const float keep = up ? x[i + H] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, send, kO);
      }
      if constexpr (kO > 1) GroupSum<H, kO / 2>::scatter(x, lane);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], kO);
      if constexpr (kO > 1) GroupSum<1, kO / 2>::scatter(x, lane);
    }
  }
  static __device__ __forceinline__ void gather(float* x, int lane) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      if constexpr (kO > 1) GroupSum<H, kO / 2>::gather(x, lane);
      const bool up = lane & kO;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float other = __shfl_xor_sync(0xffffffffu, x[i], kO);
        x[i + H] = up ? x[i] : other;
        x[i] = up ? other : x[i];
      }
    }
  }
};

// The unit of scores and maxima: log2 units for bf16 q (q carries the
// factor log2(e), so the softmax's exponent is exp2f of a difference),
// natural units for f32 q (expf, the reference's exp).
template <typename TQ>
__host__ __device__ constexpr float score_unit() {
  return std::is_same<TQ, float>::value ? 1.f : kLog2e;
}

// exp for the softmax, of a difference in score_unit. Both give exactly 1
// at 0.
template <typename TQ>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (std::is_same<TQ, float>::value) return expf(x);
  return exp2f(x);
}

// Where slot t of row b lives: (row or page id, slot there); false when it
// is outside [lo, hi) or in an unmapped page (then nothing is read). A tile
// inside one page passes that page's id as tile_id.
template <bool kPaged>
__device__ __forceinline__ bool slot_home(const Args& a, int b, int t, int lo, int hi, int tile_id,
                                          long long* row, int* slot) {
  if (t < lo || t >= hi) return false;
  if (!kPaged) {
    *row = b;
    *slot = t;
    return true;
  }
  const int p = t / a.page;
  const int id = tile_id != 0 ? tile_id : a.table[b * a.tb_sb + p];
  *row = id;
  *slot = t - p * a.page;
  return id > 0;
}

// Start the copy of tile ti into one ring stage; returns whether this
// thread staged any slot that is scored (in the window, in a mapped page).
template <typename TK, bool kPaged, int kD>
__device__ __forceinline__ bool issue_tile(const Args& a, int b, int h, int ti, int lo, int hi,
                                           bool in_page, unsigned char* stage) {
  using S = Shape<kD, TK>;
  const int t0 = ti * S::kTile;
  // Block-uniform: every thread reads the same entry.
  const int tile_id = kPaged && in_page ? a.table[b * a.tb_sb + t0 / a.page] : 0;
  if (kPaged && in_page && tile_id <= 0) {
    // Trash page or padding: the whole tile is skipped, so nothing is
    // staged (not even zeros).
    return false;
  }
  unsigned char* kd = stage;
  unsigned char* vd = stage + S::kTile * S::kRow;
  const TK* kb = static_cast<const TK*>(a.k) + h * a.k_sh;
  const TK* vb = static_cast<const TK*>(a.v) + h * a.v_sh;
  bool any = false;
  if (a.vec16) {
#pragma unroll
    for (int it = 0; it < S::kTile * S::kChunks / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int j = i / S::kChunks, c = i % S::kChunks;
      long long row = 0;
      int slot = 0;
      const bool in = slot_home<kPaged>(a, b, t0 + j, lo, hi, tile_id, &row, &slot);
      const int e = c * (16 / (int)sizeof(TK));
      const TK* ks = kb + row * a.k_sb + (long long)slot * a.k_st + e;
      const TK* vs = vb + row * a.v_sb + (long long)slot * a.v_st + e;
      cp_async16(kd + j * S::kRow + c * 16, in ? ks : kb, in ? 16 : 0);
      cp_async16(vd + j * S::kRow + c * 16, in ? vs : vb, in ? 16 : 0);
      any |= in;
    }
  } else {
    for (int i = threadIdx.x; i < S::kTile * kD; i += kThreads) {
      const int j = i / kD, d = i % kD;
      long long row = 0;
      int slot = 0;
      const bool in = slot_home<kPaged>(a, b, t0 + j, lo, hi, tile_id, &row, &slot);
      TK kx{}, vx{};
      if (in) {
        kx = kb[row * a.k_sb + (long long)slot * a.k_st + d];
        vx = vb[row * a.v_sb + (long long)slot * a.v_st + d];
      }
      reinterpret_cast<TK*>(kd + j * S::kRow)[d] = kx;
      reinterpret_cast<TK*>(vd + j * S::kRow)[d] = vx;
      any |= in;
    }
  }
  if constexpr (is_int8<TK>()) {
    float* ksd = reinterpret_cast<float*>(stage + kStageBytes);
    float* vsd = ksd + S::kTile;
    for (int j = threadIdx.x; j < S::kTile; j += kThreads) {
      long long row = 0;
      int slot = 0;
      const bool in = slot_home<kPaged>(a, b, t0 + j, lo, hi, tile_id, &row, &slot);
      const float* ks = a.ks + row * a.ks_sb + h * a.ks_sh + (long long)slot * a.ks_st;
      const float* vs = a.vs + row * a.vs_sb + h * a.vs_sh + (long long)slot * a.vs_st;
      cp_async4(ksd + j, in ? ks : a.ks, in ? 4 : 0);
      cp_async4(vsd + j, in ? vs : a.vs, in ? 4 : 0);
    }
  }
  return any;
}

// TQ is q's and out's type; TK the K/V element type (TQ, or int8_t for the
// int8 cache); kPaged reads slots through the page table (B3).
template <typename TQ, typename TK, bool kPaged, int kD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) decode_attn_kernel(Args a) {
  using S = Shape<kD, TK>;
  constexpr int kL = S::kL, kTile = S::kTile, kB = S::kB, kN = kB * kG;
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / a.n_chunks, r0 = (blockIdx.y % a.n_chunks) * kG;
  const int g = a.Hq / a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int li = lane % kL;                        // lane within its group
  const int grp = warp * S::kNG + lane / kL;       // the group within the block

  extern __shared__ __align__(16) unsigned char smem[];

  // The row's window, clipped to the cache; this split's run of its tiles.
  const int lo = max(a.bounds[b * a.bd_sb], 0), hi = min(a.bounds[b * a.bd_sb + 1], a.T);
  int t_a, t_b;
  split_run(lo, hi, kTile, a.n_split, split, &t_a, &t_b);
  // A tile lies inside one page when the page is a multiple of the tile.
  const bool in_page = kPaged && a.page % kTile == 0;

  // Start the ring before anything else: its copies overlap the q loads.
  unsigned staged = 0;  // bit st: this thread staged a scored slot into stage st
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (t_a + st < t_b && issue_tile<TK, kPaged, kD>(a, b, h, t_a + st, lo, hi, in_page,
                                                      smem + st * S::kStage))
      staged |= 1u << st;
    cp_async_commit();
  }

  // q rows r0 .. r0 + kG (pad rows past g are zeros), pre-scaled into
  // score_unit, f32.
  float q[kG][kE];
  const float q_scale = a.scale * score_unit<TQ>();
  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_sb;
#pragma unroll
  for (int r = 0; r < kG; ++r) {
    const bool real = r0 + r < g;
    const TQ* qr = qb + (long long)(h * g + (real ? r0 + r : 0)) * a.q_sh;
#pragma unroll
    for (int e = 0; e < kE; ++e) q[r][e] = real ? to_f32(qr[elem_d<TK, kD>(li, e)]) * q_scale : 0.f;
  }
  float m[kG], l[kG], acc[kG][kE];
#pragma unroll
  for (int r = 0; r < kG; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[r][e] = 0.f;
  }

#pragma unroll 1
  for (int ti = t_a; ti < t_b; ++ti) {
    const int st = (ti - t_a) % kStages;
    cp_async_wait<kStages - 2>();
    // The ring's one barrier: tile ti has landed everywhere, the stage
    // consumed last has been released, and the block learns whether any
    // thread staged a scored slot of this tile.
    const bool scored = __syncthreads_or((staged >> st) & 1u);
    {
      const int tn = ti + kStages - 1, sn = (ti - t_a + kStages - 1) % kStages;
      staged &= ~(1u << sn);
      if (tn < t_b && issue_tile<TK, kPaged, kD>(a, b, h, tn, lo, hi, in_page,
                                                  smem + sn * S::kStage))
        staged |= 1u << sn;
      cp_async_commit();
    }
    if (!scored) continue;  // block-uniform: a tile of unmapped pages

    const unsigned char* kt = smem + st * S::kStage;
    const unsigned char* vt = kt + kTile * S::kRow;
    const float* ksc = reinterpret_cast<const float*>(kt + kStageBytes);
    const float* vsc = ksc + kTile;
    const int t0 = ti * kTile;
    // Masks only on a tile that straddles the window, or whose slots may
    // lie in different pages.
    const bool edge = t0 < lo || t0 + kTile > hi || (kPaged && !in_page);
#pragma unroll
    for (int kb = 0; kb < S::kSpg; kb += kB) {
      // ---- scores of kB slots (j = slot within the tile) x kG rows ----
      float s[kN];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int j = (kb + k) * S::kGroups + grp;
        float x[kE];
        load_elems<TK, kD>(kt + j * S::kRow, li, is_int8<TK>() ? ksc[j] : 1.f, x);
#pragma unroll
        for (int r = 0; r < kG; ++r) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < kE; ++e) d = fmaf(q[r][e], x[e], d);
          s[k * kG + r] = d;
        }
      }
      GroupSum<kN, kL / 2>::scatter(s, lane);
      GroupSum<kN, kL / 2>::gather(s, lane);
      if (a.softcap > 0.f) {  // c * tanh(s / c), with s and c in score_unit
        const float cap = a.softcap * score_unit<TQ>();
#pragma unroll
        for (int i = 0; i < kN; ++i) s[i] = tanhf(s[i] / cap) * cap;
      }
      if (edge) {
#pragma unroll
        for (int k = 0; k < kB; ++k) {
          long long row;
          int slot;
          const int t = t0 + (kb + k) * S::kGroups + grp;
          if (!slot_home<kPaged>(a, b, t, lo, hi, in_page ? 1 : 0, &row, &slot)) {
#pragma unroll
            for (int r = 0; r < kG; ++r) s[k * kG + r] = -INFINITY;
          }
        }
      }
      // ---- online softmax of the group's rows ----
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        float mx = m[r];
#pragma unroll
        for (int k = 0; k < kB; ++k) mx = fmaxf(mx, s[k * kG + r]);
        // A row masked everywhere so far keeps m = -inf: pin the exponent
        // and force alpha to 0 so no NaN enters l or acc.
        const float m_safe = isfinite(mx) ? mx : 0.f;
        const float alpha = isfinite(m[r]) ? softmax_exp<TQ>(m[r] - m_safe) : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < kB; ++k) {
          const float p = softmax_exp<TQ>(s[k * kG + r] - m_safe);
          s[k * kG + r] = p;
          sum += p;
        }
        m[r] = mx;
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[r][e] *= alpha;
      }
      // ---- acc += P V ----
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int j = (kb + k) * S::kGroups + grp;
        float x[kE];
        load_elems<TK, kD>(vt + j * S::kRow, li, is_int8<TK>() ? vsc[j] : 1.f, x);
#pragma unroll
        for (int r = 0; r < kG; ++r)
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[r][e] = fmaf(s[k * kG + r], x[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();

  // ---- merge the warp's lane groups (same elements, other slots) ----
#pragma unroll
  for (int o = kL; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < kG; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mx = fmaxf(m[r], mo);
      const float wa = isfinite(m[r]) ? softmax_exp<TQ>(m[r] - mx) : 0.f;
      const float wb = isfinite(mo) ? softmax_exp<TQ>(mo - mx) : 0.f;
      m[r] = mx;
      l[r] = l[r] * wa + lo_ * wb;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = acc[r][e] * wa + ao * wb;
      }
    }
  }

  // ---- merge the warps through shared memory (the ring's space) ----
  __syncthreads();  // every warp is done with the ring
  float* acc_w = reinterpret_cast<float*>(smem);  // [kWarps, kG, kD]
  float* m_w = acc_w + kWarps * kG * kD;           // [kWarps, kG]
  float* l_w = m_w + kWarps * kG;                  // [kWarps, kG]
  if (lane < kL) {
#pragma unroll
    for (int r = 0; r < kG; ++r) {
#pragma unroll
      for (int e = 0; e < kE; ++e) acc_w[(warp * kG + r) * kD + elem_d<TK, kD>(li, e)] = acc[r][e];
      if (lane == 0) {
        m_w[warp * kG + r] = m[r];
        l_w[warp * kG + r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kG * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    if (r0 + r >= g) break;  // pad rows (rows are the outer index)
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w * kG + r]);
    float o = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_w[w * kG + r];
      const float wt = isfinite(mw) ? softmax_exp<TQ>(mw - mx) : 0.f;
      den += wt * l_w[w * kG + r];
      o += wt * acc_w[(w * kG + r) * kD + d];
    }
    const int row = r0 + r;
    if (a.n_split == 1) {
      store_as(static_cast<TQ*>(a.out) + b * a.o_sb + (long long)(h * g + row) * a.o_sh + d,
               o / fmaxf(den, 1e-30f));
    } else {
      const long long pr = partial_row(split, a.B, a.Hkv, g, b, h, row);
      a.ws[pr * kD + d] = o;
      if (d == 0) {
        const long long per = (long long)a.n_split * a.B * a.Hkv * g;
        a.ws[per * kD + pr] = mx / score_unit<TQ>();  // the combine's natural units
        a.ws[per * kD + per + pr] = den;
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

template <typename TQ, typename TK, bool kPaged, int kD>
int launch(Args a, cudaStream_t stream) {
  using S = Shape<kD, TK>;
  a.vec16 = aligned16<TK>(a.k, a.k_sb, a.k_sh, a.k_st) && aligned16<TK>(a.v, a.v_sb, a.v_sh, a.v_st);
  auto kernel = decode_attn_kernel<TQ, TK, kPaged, kD>;
  // Above 48 KB a block must opt in, once per entry.
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  kernel<<<dim3(a.n_split, a.Hkv * a.n_chunks, a.B), kThreads, S::kSmem, stream>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int g = a.Hq / a.Hkv;
  const Partials p{a.ws, a.out, a.o_sb, 0, a.o_sh, a.B, a.Hkv, g, a.D, g, a.n_split};
  return combine<TQ>(p, stream);
}

template <typename TQ, typename TK, bool kPaged>
int by_head_dim(const Args& a, cudaStream_t s) {
  switch (a.D) {
    case 64: return launch<TQ, TK, kPaged, 64>(a, s);
    case 128: return launch<TQ, TK, kPaged, 128>(a, s);
    default: return launch<TQ, TK, kPaged, 256>(a, s);
  }
}

template <bool kPaged>
int dispatch(Args& a, int dtype, void* stream) {
  if (a.D != 64 && a.D != 128 && a.D != 256) return (int)cudaErrorInvalidValue;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.B <= 0 || a.T <= 0 || a.n_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.n_split > 1 && a.ws == nullptr) return (int)cudaErrorInvalidValue;
  if (kPaged && (a.page <= 0 || a.T % a.page != 0)) return (int)cudaErrorInvalidValue;
  // Both scales or neither: a null ks is a float cache in q's type.
  if ((a.ks == nullptr) != (a.vs == nullptr)) return (int)cudaErrorInvalidValue;
  const bool quant = a.ks != nullptr;
  a.n_chunks = (a.Hq / a.Hkv + kG - 1) / kG;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return quant ? by_head_dim<float, int8_t, kPaged>(a, s) : by_head_dim<float, float, kPaged>(a, s);
  }
  if (dtype == 1) {
    return quant ? by_head_dim<__nv_bfloat16, int8_t, kPaged>(a, s)
                 : by_head_dim<__nv_bfloat16, __nv_bfloat16, kPaged>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

void set_common(Args& a, const void* q, long long q_sb, long long q_sh, const void* k,
                long long k_sb, long long k_sh, long long k_st, const void* v, long long v_sb,
                long long v_sh, long long v_st, const float* ks, long long ks_sb,
                long long ks_sh, long long ks_st, const float* vs, long long vs_sb,
                long long vs_sh, long long vs_st, const int* bounds, long long bd_sb, void* out,
                long long o_sb, long long o_sh, float* ws, int n_split) {
  a.q = q; a.q_sb = q_sb; a.q_sh = q_sh;
  a.k = k; a.k_sb = k_sb; a.k_sh = k_sh; a.k_st = k_st;
  a.v = v; a.v_sb = v_sb; a.v_sh = v_sh; a.v_st = v_st;
  a.ks = ks; a.ks_sb = ks_sb; a.ks_sh = ks_sh; a.ks_st = ks_st;
  a.vs = vs; a.vs_sb = vs_sb; a.vs_sh = vs_sh; a.vs_st = vs_st;
  a.bounds = bounds; a.bd_sb = bd_sb;
  a.out = out; a.o_sb = o_sb; a.o_sh = o_sh;
  a.ws = ws; a.n_split = n_split;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q's and out's type; a float cache is
// in the same type). ks/vs: the int8 cache's f32 scales, or null for a
// float cache. ws: f32 workspace of n_split * B * Hkv * g * (D + 2) floats
// (null when n_split = 1). Strides are in elements. Returns the
// cudaError_t of the launches (0 = launched).
extern "C" int advspec_decode_attention(
    const void* q, long long q_sb, long long q_sh,
    const void* k, long long k_sb, long long k_sh, long long k_st,
    const void* v, long long v_sb, long long v_sh, long long v_st,
    const float* ks, long long ks_sb, long long ks_sh, long long ks_st,
    const float* vs, long long vs_sb, long long vs_sh, long long vs_st,
    const int* bounds, long long bd_sb,
    void* out, long long o_sb, long long o_sh,
    float* ws, int n_split,
    int B, int Hq, int Hkv, int T, int D, int dtype,
    float scale, float softcap, void* stream) {
  Args a{};
  set_common(a, q, q_sb, q_sh, k, k_sb, k_sh, k_st, v, v_sb, v_sh, v_st, ks, ks_sb, ks_sh, ks_st,
             vs, vs_sb, vs_sh, vs_st, bounds, bd_sb, out, o_sb, o_sh, ws, n_split);
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.T = T; a.D = D;
  a.scale = scale; a.softcap = softcap;
  return dispatch<false>(a, dtype, stream);
}

// Paged entry (B3). k/v are a layer's [n_pages, Hkv, page, D] pool view:
// k_sp is the page stride (ks_sp the scale pages', [n_pages, Hkv, page, 1],
// for an int8 pool). The table is int32 [B, P] with row stride tb_sb and
// contiguous entries; T = P * page.
extern "C" int advspec_paged_decode_attention(
    const void* q, long long q_sb, long long q_sh,
    const void* k, long long k_sp, long long k_sh, long long k_st,
    const void* v, long long v_sp, long long v_sh, long long v_st,
    const float* ks, long long ks_sp, long long ks_sh, long long ks_st,
    const float* vs, long long vs_sp, long long vs_sh, long long vs_st,
    const int* table, long long tb_sb,
    const int* bounds, long long bd_sb,
    void* out, long long o_sb, long long o_sh,
    float* ws, int n_split,
    int B, int Hq, int Hkv, int P, int page, int D, int dtype,
    float scale, float softcap, void* stream) {
  Args a{};
  set_common(a, q, q_sb, q_sh, k, k_sp, k_sh, k_st, v, v_sp, v_sh, v_st, ks, ks_sp, ks_sh, ks_st,
             vs, vs_sp, vs_sh, vs_st, bounds, bd_sb, out, o_sb, o_sh, ws, n_split);
  a.table = table; a.tb_sb = tb_sb;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.T = P * page; a.D = D;
  a.page = page;
  a.scale = scale; a.softcap = softcap;
  return dispatch<true>(a, dtype, stream);
}
