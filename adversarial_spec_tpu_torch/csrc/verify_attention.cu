// Speculative-verify attention over a dense, heads-major KV cache or a paged
// KV pool, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the reference package:
//   - adversarial_spec_tpu/ops/pallas_decode.py:decode_attention_mq
//     (_mq_attn_kernel, B2): a short span of S query positions per row
//     (the speculative verify, S = gamma + 1), each position with its own
//     [start, end) window, the whole span reading the cache in one pass;
//   - adversarial_spec_tpu/ops/pallas_paged.py:paged_decode_attention_mq
//     (_paged_mq_attn_kernel, B4): the same through a page table over a
//     shared page pool (the continuous batcher's span-native verify).
// Each over a float cache (K/V in q's type) or an int8 cache (the
// reference's kv_dtype="int8": int8 K/V beside per-(token, head) f32
// scales): four entries. The S = 1 kernels (B1, B3) stay in
// decode_attention.cu.
//
// What bounds it: the bytes of K and V it reads. At the verify's shapes
// (Llama-3-8B, Hkv=8, D=128, S=9, g=4: R = g*S = 36 query rows per KV
// head; thousands of cached slots per row) a call does ~18 flops per K/V
// byte (~36 for int8), far below the card's ~295 flops/byte balance, so
// the floor is bytes / 3.35 TB/s.
//
// What the design does about it:
//   - Split-KV (flash-decoding) grid (n_split, Hkv, B). Each block computes
//     the union of its (row, KV head)'s windows in the kernel, cuts the
//     union's tiles into n_split near-equal contiguous runs and takes run
//     blockIdx.x; no host ever reads the windows or the table. n_split is
//     chosen on the host from shapes alone (ops/split_kv.py: the least
//     that fills the two blocks each of the 132 SMs holds; the bf16
//     kernel's launch bound keeps it to 128 registers a thread, which
//     spills a few words in some entries). With n_split > 1 each block
//     writes an f32 partial (running max m, normalizer l, unnormalized acc
//     [R, D]) and a second small kernel merges the partials by the
//     log-sum-exp rescale; with n_split = 1 the block writes the output.
//   - A cp.async ring of K/V tiles (kStages = 2, 16-byte copies): the next
//     tile's copy is in flight while this tile's scores and P.V run (a page
//     too large for two stages in shared memory takes one). Slots
//     outside the union (and past T, and a page's pad slots below) are
//     zero-filled by the copy itself (source size 0), never loaded, so
//     stale or poisoned bytes cannot reach a 0 * x product. The copies,
//     the split of the union's tiles and the combine pass are
//     split_kv.cuh's, shared with decode_attention.cu. Rows whose address or strides are not 16-byte
//     aligned are staged element by element instead (same ring, no
//     overlap). Shared-memory rows carry 16 bytes of padding, so the
//     ldmatrix loads below are free of bank conflicts.
//   - bf16 q: tensor-core scores and P.V with mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate). The R query rows are padded to Rp, a multiple of 16;
//     pad rows have the empty window [T, 0). q stays unscaled in bf16;
//     scale, then the softcap, apply to the f32 score, and the masks in
//     the softmax pass, which skips them for a tile inside every row's
//     window (most tiles); softmax state (m, l, alpha, with the -inf-safe
//     alpha) is f32. Each warp owns 8 slots of the tile across all rows
//     for the scores, and D / 8 columns across all rows for P.V. P enters
//     the bf16 product as two bf16 terms, hi = bf16(p) and lo = bf16(p -
//     hi), so
//     P.V keeps ~16 bits of p (one bf16 rounding of p would move outputs
//     near zero by more than one bf16 rounding of the output). wgmma
//     wants 64-row tiles, and this work sits far below the card's
//     flops/byte balance, so mma.sync loses nothing here. The output tile
//     Rp x D lives in registers, 64 f32 per thread at most: Rp * D <=
//     16384 (Rp <= 256, 128, 64 for D = 64, 128, 256).
//   - int8 K/V with bf16 q: each staged tile is converted to bf16 once per
//     element (exact: |k| <= 127), then takes the bf16 path; the K scale
//     multiplies the f32 score column (s = (q.k8) * ks[t] * scale) and
//     the V scale folds into p before its bf16 split (p' = p * vs[t]).
//     Both are the reference's dequantize-first order (flash_update_heads:
//     k * ks, v * vs) rounded differently.
//   - f32 q: f32 CUDA-core arithmetic (no TF32), q pre-scaled in f32, an
//     int8 slot dequantized float(k8) * ks before its product, exactly the
//     reference's order; same grid, ring and combine.
//
// Paged pools: physical page 0 is the trash page and negative ids are table
// padding, so a page whose id is <= 0 is skipped whole (block-uniform),
// values and scale page alike. A tile is one page (tslots = page real
// slots) where the page fits in shared memory beside the span's rows; where
// it does not, a page is staged as tpp tiles of page / tpp slots (halves,
// quarters, ... of the page, at least 16 slots: D = 256 with 128-slot f32
// pages takes 64, or 32 beside 132 f32 query rows). Either way a tile is staged
// into a shared-memory tile of the next multiple of 16 slots: the pad
// slots are zero-filled by the copy and masked like slots past the window,
// so any page size works. advspec_verify_max_rows reports, from the same
// tile choice, the most query rows an f32 launch holds; the wrappers cut
// longer f32 spans into runs of positions that fit (ops/split_kv.py
// span_runs).
//
// Layout and contract (checked again by the Python wrappers):
//   q   [B, S, Hq, D]   D contiguous
//   dense: k,v [B, Hkv, T, D] any strides except D contiguous
//   paged: k,v [n_pages, Hkv, page, D], table int32 [B, P] (row stride
//          given, entries contiguous); T = P * page
//   int8 cache: k,v int8 in the same layouts, ks,vs f32 [..., 1], any
//          strides; a null ks means a float cache
//   starts/ends int32 [B, S] (or [B, 1] broadcast via a zero S stride)
//   out [B, S, Hq, D] in q's dtype; ws the f32 partials (n_split > 1):
//          acc [n_split, B, Hkv, R, D], then m and l [n_split, B, Hkv, R]
// Each query row masks its own [start, end); a row with an empty window
// yields exact zeros.

#include "split_kv.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;      // cp.async ring depth (1 for a page too big for 2)
constexpr int kMaxAcc = 16384;  // Rp * D held in registers (64 f32 a thread)
constexpr size_t kMaxSmem = 232448 - 1024;

struct Args {
  const void* q;
  long long q_sb, q_ss, q_sh;
  // Dense: k_sb is the batch-row stride. Paged: k_sb is the page stride.
  const void* k;
  long long k_sb, k_sh, k_st;
  const void* v;
  long long v_sb, v_sh, v_st;
  const float* ks;  // int8 cache only (null for a float cache)
  long long ks_sb, ks_sh, ks_st;
  const float* vs;
  long long vs_sb, vs_sh, vs_st;
  const int* table;  // paged only: [B, P] physical page ids
  long long tb_sb;
  const int* starts;
  long long st_sb, st_ss;
  const int* ends;
  long long en_sb, en_ss;
  void* out;
  long long o_sb, o_ss, o_sh;
  float* ws;  // partials, n_split > 1 only
  // tile: shared-memory slots of a staged tile (a multiple of 16 for bf16
  // q); tslots: the cache slots it holds (dense: tile; paged: the page, or
  // page / tpp where a page does not fit); tpp: tiles per page (paged).
  int B, S, Hq, Hkv, T, D, R, Rp, tile, tslots, tpp, n_split, vec16, q16;
  float scale, softcap;
};

// Shared-memory carve-up (byte offsets), the same on host and device.
struct Layout {
  size_t k, v, ksc, vsc, kc, vc, q, s, phi, plo, acc, m, l, al, lo, hi, total;
  int kv_ld;  // ring row stride in bytes: D elements + 16 bytes of padding
};

template <bool kTC, typename TK>
__host__ __device__ Layout make_layout(int Rp, int D, int TT, int stages) {
  Layout L{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) / 16 * 16;
    return o;
  };
  L.kv_ld = D * (int)sizeof(TK) + 16;
  L.k = take((size_t)stages * TT * L.kv_ld);
  L.v = take((size_t)stages * TT * L.kv_ld);
  if (is_int8<TK>()) {
    L.ksc = take((size_t)stages * TT * 4);
    L.vsc = take((size_t)stages * TT * 4);
  }
  if (kTC) {
    if (is_int8<TK>()) {  // the staged tile converted to bf16
      L.kc = take((size_t)TT * (D + 8) * 2);
      L.vc = take((size_t)TT * (D + 8) * 2);
    }
    L.q = take((size_t)Rp * (D + 8) * 2);
    L.s = take((size_t)Rp * (TT + 4) * 4);
    L.phi = take((size_t)Rp * (TT + 8) * 2);
    L.plo = take((size_t)Rp * (TT + 8) * 2);
  } else {
    L.q = take((size_t)Rp * D * 4);
    L.acc = take((size_t)Rp * D * 4);
    L.s = take((size_t)Rp * TT * 4);
  }
  L.m = take((size_t)Rp * 4);
  L.l = take((size_t)Rp * 4);
  L.al = take((size_t)Rp * 4);
  L.lo = take((size_t)Rp * 4);
  L.hi = take((size_t)Rp * 4);
  L.total = off;
  return L;
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}
// c += a (16x16, row) * b (16x8, col): bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- shared pieces of the two verify kernels -------------------------------

// Every row's window (pad rows r >= R get the empty [T, 0)), m = -inf and
// l = 0; then the union of the non-empty windows clipped to [0, T) (in
// range_s[0..1]), the slots inside every row's window (range_s[2..3]: a
// tile there needs no mask), and this split's run [*t_a, *t_b) of the
// union's tiles (split_run).
__device__ void setup_rows(const Args& a, int b, int* lo_s, int* hi_s, float* m_s, float* l_s,
                           int* range_s, int* t_a, int* t_b) {
  const int g = a.Hq / a.Hkv;
  for (int r = threadIdx.x; r < a.Rp; r += kThreads) {
    int lo = a.T, hi = 0;
    if (r < a.R) {
      const int s = r / g;
      lo = a.starts[b * a.st_sb + s * a.st_ss];
      hi = a.ends[b * a.en_sb + s * a.en_ss];
    }
    lo_s[r] = lo;
    hi_s[r] = hi;
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int lo = a.T, hi = 0, all_lo = 0, all_hi = a.T;
    for (int r = 0; r < a.R; ++r) {
      const int s0 = max(lo_s[r], 0), e0 = min(hi_s[r], a.T);
      if (s0 < e0) {
        lo = min(lo, s0);
        hi = max(hi, e0);
      }
      all_lo = max(all_lo, lo_s[r]);
      all_hi = min(all_hi, hi_s[r]);
    }
    range_s[0] = lo;
    range_s[1] = hi;
    range_s[2] = all_lo;
    range_s[3] = all_hi;
  }
  __syncthreads();
  split_run(range_s[0], range_s[1], a.tslots, a.n_split, blockIdx.x, t_a, t_b);
}

// The tile's page id (paged) or batch row (dense), and its first slot there;
// false for a page that is never loaded (id <= 0: trash page or padding).
template <bool kPaged>
__device__ __forceinline__ bool tile_home(const Args& a, int b, int ti, long long* row,
                                          int* slot0) {
  if (kPaged) {
    const int id = a.table[b * a.tb_sb + ti / a.tpp];
    *row = id;
    *slot0 = ti % a.tpp * a.tslots;
    return id > 0;
  }
  *row = b;
  *slot0 = ti * a.tslots;
  return true;
}

// Start the copy of tile ti into ring stage dst (K, V and, for an int8
// cache, their scales). Slots outside [lo, hi), and a page's pad slots
// (j >= tslots), are zero-filled. kD is the head dim when known at compile
// time (0: a.D).
template <typename TK, bool kPaged, int kD>
__device__ void issue_tile(const Args& a, int b, int h, int ti, int lo, int hi, unsigned char* kd,
                           unsigned char* vd, float* ksd, float* vsd, int kv_ld) {
  long long row;
  int slot0;
  if (!tile_home<kPaged>(a, b, ti, &row, &slot0)) return;
  const int TT = a.tile, D = kD ? kD : a.D, t0 = ti * a.tslots;
  const TK* kt = static_cast<const TK*>(a.k) + row * a.k_sb + h * a.k_sh + (long long)slot0 * a.k_st;
  const TK* vt = static_cast<const TK*>(a.v) + row * a.v_sb + h * a.v_sh + (long long)slot0 * a.v_st;
  if (a.vec16) {
    const int C = D * (int)sizeof(TK) / 16;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < TT * C; i += kThreads) {
      const int j = i / C, c = i % C, t = t0 + j;
      const bool in = j < a.tslots && t >= lo && t < hi;
      const int e = c * (16 / (int)sizeof(TK));
      cp_async16(kd + j * kv_ld + c * 16, in ? kt + (long long)j * a.k_st + e : kt, in ? 16 : 0);
      cp_async16(vd + j * kv_ld + c * 16, in ? vt + (long long)j * a.v_st + e : vt, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TT * D; i += kThreads) {
      const int j = i / D, d = i % D, t = t0 + j;
      const bool in = j < a.tslots && t >= lo && t < hi;
      TK kx{}, vx{};
      if (in) {
        kx = kt[(long long)j * a.k_st + d];
        vx = vt[(long long)j * a.v_st + d];
      }
      reinterpret_cast<TK*>(kd + j * kv_ld)[d] = kx;
      reinterpret_cast<TK*>(vd + j * kv_ld)[d] = vx;
    }
  }
  if constexpr (is_int8<TK>()) {
    const float* kst = a.ks + row * a.ks_sb + h * a.ks_sh + (long long)slot0 * a.ks_st;
    const float* vst = a.vs + row * a.vs_sb + h * a.vs_sh + (long long)slot0 * a.vs_st;
    for (int j = threadIdx.x; j < TT; j += kThreads) {
      const int t = t0 + j;
      const bool in = j < a.tslots && t >= lo && t < hi;
      cp_async4(ksd + j, in ? kst + (long long)j * a.ks_st : kst, in ? 4 : 0);
      cp_async4(vsd + j, in ? vst + (long long)j * a.vs_st : vst, in ? 4 : 0);
    }
  }
}

// A block's ring of kSt tile stages (Layout's k, v, ksc, vsc regions)
// over its run [t_a, t_b) of tiles: start() issues the first kSt - 1;
// wait(ti) returns tile ti's stage once every thread's copies of it have
// landed and the previous tile is consumed, and starts the copy of the
// tile kSt - 1 ahead (with one stage, only then the copy of ti itself).
template <typename TK, bool kPaged, int kD, int kSt>
struct Ring {
  unsigned char* smem;
  const Layout& L;
  int b, h, lo, hi, t_a, t_b;

  __device__ unsigned char* k(int st, int TT) const { return smem + L.k + (size_t)st * TT * L.kv_ld; }
  __device__ unsigned char* v(int st, int TT) const { return smem + L.v + (size_t)st * TT * L.kv_ld; }
  __device__ float* ks(int st, int TT) const {
    return reinterpret_cast<float*>(smem + L.ksc) + st * TT;
  }
  __device__ float* vs(int st, int TT) const {
    return reinterpret_cast<float*>(smem + L.vsc) + st * TT;
  }
  __device__ void issue(const Args& a, int ti, int st) const {
    const int TT = a.tile;
    if (ti < t_b)
      issue_tile<TK, kPaged, kD>(a, b, h, ti, lo, hi, k(st, TT), v(st, TT), ks(st, TT), vs(st, TT),
                                 L.kv_ld);
    cp_async_commit();
  }
  __device__ void start(const Args& a) const {
#pragma unroll 1
    for (int st = 0; st < kSt - 1; ++st) issue(a, t_a + st, st);
  }
  __device__ int wait(const Args& a, int ti) const {
    const int st = (ti - t_a) % kSt;
    if (kSt == 1) {
      __syncthreads();
      issue(a, ti, 0);
    }
    cp_async_wait<kSt == 1 ? 0 : kSt - 2>();
    __syncthreads();
    if (kSt > 1) issue(a, ti + kSt - 1, (st + kSt - 1) % kSt);
    return st;
  }
};

// Threads per row of a softmax: the largest power of two, at most 32 and
// at most TT / per, with rows * tpr <= kThreads (all rows in one pass).
__device__ __forceinline__ int softmax_tpr(int rows, int TT, int per) {
  int tpr = 32;
  while (tpr > 1 && (rows * tpr > kThreads || tpr * per > TT)) tpr >>= 1;
  return tpr;
}

// f32 q: online softmax over one tile's masked scores s [rows, TT], tpr
// threads per row (an aligned lane group): new max, the -inf-safe alpha,
// p = exp(s - m) in place; l and m updated.
__device__ void softmax_f32(float* s, int s_ld, int rows, int TT, float* m_s, float* l_s,
                            float* al_s) {
  const int tpr = softmax_tpr(rows, TT, 1);
  for (int base = 0; base < rows * tpr; base += kThreads) {  // one pass unless rows > 256
    const int i = base + threadIdx.x, r = i / tpr, part = i % tpr;
    const bool act = r < rows;
    float* sr = s + r * s_ld;
    float mx = -INFINITY;
    if (act)
      for (int j = part; j < TT; j += tpr) mx = fmaxf(mx, sr[j]);
    for (int o = tpr / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = act ? m_s[r] : -INFINITY;
    const float m_new = fmaxf(m_old, mx);
    // A row masked everywhere so far keeps m = -inf: pin the exponent and
    // force alpha to 0 so no NaN enters l or acc.
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float alpha = isfinite(m_old) ? expf(m_old - m_safe) : 0.f;
    float sum = 0.f;
    if (act) {
      for (int j = part; j < TT; j += tpr) {
        const float p = expf(sr[j] - m_safe);
        sum += p;
        sr[j] = p;
      }
    }
    for (int o = tpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (act && part == 0) {
      m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + sum;
      al_s[r] = alpha;
    }
  }
}

// bf16 q: online softmax over one tile's scaled scores s [rows, TT] (slot
// pairs, tpr threads per row). Softcap, then, unless the tile lies inside
// every row's window (interior), the row's mask [lo, hi), t < T and j <
// nvalid (a page's pad slots). p =
// exp(s - m) is written, times the V scale vsc when given, as bf16 hi and
// lo terms; l, m and alpha as in softmax_f32.
__device__ void softmax_bf16(const Args& a, float* s, int s_ld, __nv_bfloat16* phi,
                             __nv_bfloat16* plo, int p_ld, const float* vsc, int rows, int TT,
                             int nvalid, int t0, bool interior, const int* lo_s, const int* hi_s, float* m_s,
                             float* l_s, float* al_s) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int tpr = softmax_tpr(rows, TT, 2);
  const bool edit = !interior || a.softcap > 0.f;
  for (int base = 0; base < rows * tpr; base += kThreads) {
    const int i = base + threadIdx.x, r = i / tpr, part = i % tpr;
    const bool act = r < rows;
    float* sr = s + r * s_ld;
    float mx = -INFINITY;
    if (act) {
      const int lo = lo_s[r], hi = min(hi_s[r], a.T);
      for (int j = 2 * part; j < TT; j += 2 * tpr) {
        float2 v = *reinterpret_cast<float2*>(sr + j);
        if (edit) {
          if (a.softcap > 0.f) {
            v.x = tanhf(v.x / a.softcap) * a.softcap;
            v.y = tanhf(v.y / a.softcap) * a.softcap;
          }
          if (!interior) {
            const int t = t0 + j;
            if (t < lo || t >= hi || j >= nvalid) v.x = -INFINITY;
            if (t + 1 < lo || t + 1 >= hi || j + 1 >= nvalid) v.y = -INFINITY;
          }
          *reinterpret_cast<float2*>(sr + j) = v;
        }
        mx = fmaxf(mx, fmaxf(v.x, v.y));
      }
    }
    for (int o = tpr / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = act ? m_s[r] : -INFINITY;
    const float m_new = fmaxf(m_old, mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;  // as in softmax_f32
    const float alpha = isfinite(m_old) ? exp2f((m_old - m_safe) * kLog2e) : 0.f;
    const float ms2 = m_safe * kLog2e;
    float sum = 0.f;
    if (act) {
      for (int j = 2 * part; j < TT; j += 2 * tpr) {
        const float2 v = *reinterpret_cast<const float2*>(sr + j);
        float2 p = make_float2(exp2f(fmaf(v.x, kLog2e, -ms2)), exp2f(fmaf(v.y, kLog2e, -ms2)));
        sum += p.x + p.y;
        if (vsc) {
          p.x *= vsc[j];
          p.y *= vsc[j + 1];
        }
        const __nv_bfloat162 hb = __floats2bfloat162_rn(p.x, p.y);
        const float2 hf = __bfloat1622float2(hb);
        *reinterpret_cast<__nv_bfloat162*>(phi + r * p_ld + j) = hb;
        *reinterpret_cast<__nv_bfloat162*>(plo + r * p_ld + j) =
            __floats2bfloat162_rn(p.x - hf.x, p.y - hf.y);
      }
    }
    for (int o = tpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (act && part == 0) {
      m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + sum;
      al_s[r] = alpha;
    }
  }
}

// Where row r's element d goes: the output (n_split = 1, normalized, in TQ)
// or this split's f32 partial.
template <typename TQ>
__device__ __forceinline__ void emit(const Args& a, int b, int h, int r, int d, float acc, float l) {
  if (a.n_split == 1) {
    const int g = a.Hq / a.Hkv, s = r / g, gi = r % g;
    store_as(static_cast<TQ*>(a.out) + b * a.o_sb + s * a.o_ss + (long long)(h * g + gi) * a.o_sh + d,
             acc / fmaxf(l, 1e-30f));
  } else {
    a.ws[partial_row(blockIdx.x, a.B, a.Hkv, a.R, b, h, r) * a.D + d] = acc;
  }
}

// A split's m and l rows (n_split > 1).
__device__ void emit_state(const Args& a, int b, int h, const float* m_s, const float* l_s) {
  if (a.n_split == 1) return;
  const long long per = (long long)a.n_split * a.B * a.Hkv * a.R;
  const long long row0 = partial_row(blockIdx.x, a.B, a.Hkv, a.R, b, h, 0);
  float* ms = a.ws + per * a.D;
  for (int r = threadIdx.x; r < a.R; r += kThreads) {
    ms[row0 + r] = m_s[r];
    ms[per + row0 + r] = l_s[r];
  }
}

// ---- bf16 q: tensor cores ---------------------------------------------------

template <typename TK, bool kPaged, int kD, int kSt>
__global__ void __launch_bounds__(kThreads, 2) verify_tc_kernel(Args a) {
  constexpr bool kQuant = is_int8<TK>();
  constexpr int kLd = kD + 8;                    // bf16 row stride: q, K/V tiles
  constexpr int kNTW = kD / 8 / kWarps;          // n8 tiles of D per warp in P.V
  constexpr int kMaxMT = kMaxAcc / (16 * kD);    // 16-row tiles of Rp, at most
  constexpr int kChunk = 4;                      // m tiles per K fragment in S
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = a.Hq / a.Hkv, TT = a.tile, MT = a.Rp / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Layout L = make_layout<true, TK>(a.Rp, kD, TT, kSt);
  const int sld = TT + 4, pld = TT + 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  __nv_bfloat16* phi = reinterpret_cast<__nv_bfloat16*>(smem + L.phi);
  __nv_bfloat16* plo = reinterpret_cast<__nv_bfloat16*>(smem + L.plo);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* al_s = reinterpret_cast<float*>(smem + L.al);
  int* lo_s = reinterpret_cast<int*>(smem + L.lo);
  int* hi_s = reinterpret_cast<int*>(smem + L.hi);
  __shared__ int range_s[4];

  // q unscaled in bf16, pad rows zero. Row r = (span position r / g, group
  // lane r % g) -> query head h * g + r % g.
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb;
  if (a.q16) {  // 16-byte loads: 8 elements each
    for (int i = threadIdx.x; i < a.Rp * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), d = 8 * (i % (kD / 8));
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < a.R)
        x = *reinterpret_cast<const uint4*>(qb + (r / g) * a.q_ss + (long long)(h * g + r % g) * a.q_sh + d);
      *reinterpret_cast<uint4*>(q_s + r * kLd + d) = x;
    }
  } else {
    for (int i = threadIdx.x; i < a.Rp * kD; i += kThreads) {
      const int r = i / kD, d = i % kD;
      __nv_bfloat16 x = __float2bfloat16(0.f);
      if (r < a.R) x = qb[(r / g) * a.q_ss + (long long)(h * g + r % g) * a.q_sh + d];
      q_s[r * kLd + d] = x;
    }
  }
  int t_a, t_b;
  setup_rows(a, b, lo_s, hi_s, m_s, l_s, range_s, &t_a, &t_b);
  const int lo = range_s[0], hi = range_s[1];

  float acc[kMaxMT][kNTW][4];
#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt)
#pragma unroll
    for (int n = 0; n < kNTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  const Ring<TK, kPaged, kD, kSt> ring{smem, L, b, h, lo, hi, t_a, t_b};
  ring.start(a);
#pragma unroll 1
  for (int ti = t_a; ti < t_b; ++ti) {
    const int st = ring.wait(a, ti);
    if (kPaged && a.table[b * a.tb_sb + ti / a.tpp] <= 0) continue;  // block-uniform skip
    const int t0 = ti * a.tslots;
    const float* ksc = ring.ks(st, TT);
    const float* vsc = ring.vs(st, TT);
    const __nv_bfloat16* kT;
    const __nv_bfloat16* vT;
    if constexpr (kQuant) {
      // int8 -> bf16 once per element of the tile (exact for |x| <= 127).
      const int8_t* k8 = reinterpret_cast<const int8_t*>(ring.k(st, TT));
      const int8_t* v8 = reinterpret_cast<const int8_t*>(ring.v(st, TT));
      __nv_bfloat16* kc = reinterpret_cast<__nv_bfloat16*>(smem + L.kc);
      __nv_bfloat16* vc = reinterpret_cast<__nv_bfloat16*>(smem + L.vc);
      for (int i = threadIdx.x; i < TT * (kD / 4); i += kThreads) {
        const int j = i / (kD / 4), c = 4 * (i % (kD / 4));
        const char4 kx = *reinterpret_cast<const char4*>(k8 + j * L.kv_ld + c);
        const char4 vx = *reinterpret_cast<const char4*>(v8 + j * L.kv_ld + c);
        __nv_bfloat162* kr = reinterpret_cast<__nv_bfloat162*>(kc + j * kLd + c);
        __nv_bfloat162* vr = reinterpret_cast<__nv_bfloat162*>(vc + j * kLd + c);
        kr[0] = __floats2bfloat162_rn((float)kx.x, (float)kx.y);
        kr[1] = __floats2bfloat162_rn((float)kx.z, (float)kx.w);
        vr[0] = __floats2bfloat162_rn((float)vx.x, (float)vx.y);
        vr[1] = __floats2bfloat162_rn((float)vx.z, (float)vx.w);
      }
      __syncthreads();
      kT = kc;
      vT = vc;
    } else {
      kT = reinterpret_cast<const __nv_bfloat16*>(ring.k(st, TT));
      vT = reinterpret_cast<const __nv_bfloat16*>(ring.v(st, TT));
    }

    // ---- S = Q K^T on the tensor cores: each warp owns 8-slot n tiles
    // (nt = warp, warp + 8, ...) across every 16-row m tile, so one K
    // fragment serves kChunk m tiles with independent accumulators.
    for (int nt = warp; nt < TT / 8; nt += kWarps) {
      for (int mc = 0; mc < MT; mc += kChunk) {
        float c[kChunk][4];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          uint32_t bf[2], af[kChunk][4];
          ldsm_x2(bf, kT + (nt * 8 + lane % 8) * kLd + kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            if (mc + i < MT)
              ldsm_x4(af[i], q_s + ((mc + i) * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            if (mc + i < MT) mma_bf16(c[i], af[i], bf);
        }
        // Scaled scores (times the K scale of an int8 slot); the softmax
        // applies the softcap and the masks.
        const int j = nt * 8 + (lane % 4) * 2;
        float cs0 = a.scale, cs1 = a.scale;
        if constexpr (kQuant) {
          cs0 *= ksc[j];
          cs1 *= ksc[j + 1];
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (mc + i >= MT) continue;
          const int r = (mc + i) * 16 + lane / 4;
          *reinterpret_cast<float2*>(s_s + r * sld + j) = make_float2(c[i][0] * cs0, c[i][1] * cs1);
          *reinterpret_cast<float2*>(s_s + (r + 8) * sld + j) =
              make_float2(c[i][2] * cs0, c[i][3] * cs1);
        }
      }
    }
    __syncthreads();
    const bool interior =
        TT == a.tslots && t0 >= range_s[2] && t0 + TT <= min(range_s[3], a.T);
    softmax_bf16(a, s_s, sld, phi, plo, pld, kQuant ? vsc : nullptr, a.Rp, TT, a.tslots, t0,
                 interior, lo_s, hi_s, m_s, l_s, al_s);
    __syncthreads();

    // ---- O = O * alpha + P V: each warp owns kNTW n8 tiles of D, all rows.
#pragma unroll
    for (int mt = 0; mt < kMaxMT; ++mt) {
      if (mt < MT) {
        const float a0 = al_s[mt * 16 + lane / 4], a1 = al_s[mt * 16 + lane / 4 + 8];
#pragma unroll
        for (int n = 0; n < kNTW; ++n) {
          acc[mt][n][0] *= a0;
          acc[mt][n][1] *= a0;
          acc[mt][n][2] *= a1;
          acc[mt][n][3] *= a1;
        }
      }
    }
#pragma unroll 1
    for (int kk = 0; kk < TT / 16; ++kk) {
      uint32_t bv[kNTW][2];
#pragma unroll
      for (int n = 0; n < kNTW; ++n)
        ldsm_x2_trans(bv[n], vT + (kk * 16 + lane % 16) * kLd + (warp * kNTW + n) * 8);
      // The hi terms for every m tile, then the lo terms: consecutive
      // mmas go to different accumulators.
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const __nv_bfloat16* pp = part ? plo : phi;
#pragma unroll
        for (int mt = 0; mt < kMaxMT; ++mt) {
          if (mt < MT) {
            uint32_t af[4];
            ldsm_x4(af, pp + (mt * 16 + lane % 16) * pld + kk * 16 + (lane / 16) * 8);
#pragma unroll
            for (int n = 0; n < kNTW; ++n) mma_bf16(acc[mt][n], af, bv[n]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt) {
    if (mt < MT) {
#pragma unroll
      for (int n = 0; n < kNTW; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + lane / 4 + (e / 2) * 8;
          const int d = (warp * kNTW + n) * 8 + (lane % 4) * 2 + (e % 2);
          if (r < a.R) emit<__nv_bfloat16>(a, b, h, r, d, acc[mt][n][e], l_s[r]);
        }
      }
    }
  }
  emit_state(a, b, h, m_s, l_s);
}

// ---- f32 q: CUDA cores, the reference's order --------------------------------

// q_s row (f32, pre-scaled) . K row, both D long; an int8 row dequantizes
// each element in f32 (float(k8) * ks) before the product.
__device__ __forceinline__ float dot_row(const float* q, const float* k, int D, float) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(q[d], k[d], acc);
  return acc;
}
__device__ __forceinline__ float dot_row(const float* q, const int8_t* k, int D, float ks) {
  const char4* k4 = reinterpret_cast<const char4*>(k);
  float acc = 0.f;
  for (int d = 0; d < D / 4; ++d) {
    const char4 c = k4[d];
    acc = fmaf(q[4 * d], (float)c.x * ks, acc);
    acc = fmaf(q[4 * d + 1], (float)c.y * ks, acc);
    acc = fmaf(q[4 * d + 2], (float)c.z * ks, acc);
    acc = fmaf(q[4 * d + 3], (float)c.w * ks, acc);
  }
  return acc;
}

template <typename TK, bool kPaged, int kSt>
__global__ void __launch_bounds__(kThreads) verify_f32_kernel(Args a) {
  constexpr bool kQuant = is_int8<TK>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = a.Hq / a.Hkv, R = a.R, D = a.D, TT = a.tile;
  const Layout L = make_layout<false, TK>(R, D, TT, kSt);
  const int ld = L.kv_ld / (int)sizeof(TK);  // ring row stride in elements

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L.q);      // [R, D] pre-scaled q
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);  // [R, D] running P V
  float* p_s = reinterpret_cast<float*>(smem + L.s);      // [R, TT] scores / probs
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* al_s = reinterpret_cast<float*>(smem + L.al);
  int* lo_s = reinterpret_cast<int*>(smem + L.lo);
  int* hi_s = reinterpret_cast<int*>(smem + L.hi);
  __shared__ int range_s[4];

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[i] = qb[(r / g) * a.q_ss + (long long)(h * g + r % g) * a.q_sh + d] * a.scale;
    acc_s[i] = 0.f;
  }
  int t_a, t_b;
  setup_rows(a, b, lo_s, hi_s, m_s, l_s, range_s, &t_a, &t_b);
  const int lo = range_s[0], hi = range_s[1];

  const Ring<TK, kPaged, 0, kSt> ring{smem, L, b, h, lo, hi, t_a, t_b};  // D known at run time
  ring.start(a);
#pragma unroll 1
  for (int ti = t_a; ti < t_b; ++ti) {
    const int st = ring.wait(a, ti);
    if (kPaged && a.table[b * a.tb_sb + ti / a.tpp] <= 0) continue;  // block-uniform skip
    const int t0 = ti * a.tslots;
    const TK* k_t = reinterpret_cast<const TK*>(ring.k(st, TT));
    const TK* v_t = reinterpret_cast<const TK*>(ring.v(st, TT));
    const float* ksc = ring.ks(st, TT);
    const float* vsc = ring.vs(st, TT);

    for (int i = threadIdx.x; i < R * TT; i += kThreads) {
      const int r = i / TT, j = i % TT, t = t0 + j;
      float sc = -INFINITY;
      if (j < a.tslots && t < a.T && t >= lo_s[r] && t < hi_s[r]) {
        sc = dot_row(q_s + r * D, k_t + j * ld, D, kQuant ? ksc[j] : 1.f);
        if (a.softcap > 0.f) sc = tanhf(sc / a.softcap) * a.softcap;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    softmax_f32(p_s, TT, R, TT, m_s, l_s, al_s);
    __syncthreads();
    for (int i = threadIdx.x; i < R * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* pr = p_s + r * TT;
      float acc = acc_s[i] * al_s[r];
      for (int j = 0; j < TT; ++j) {
        float vv = to_f32(v_t[j * ld + d]);
        if constexpr (kQuant) vv *= vsc[j];  // float(v8) * vs, then P V
        acc = fmaf(pr[j], vv, acc);
      }
      acc_s[i] = acc;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += kThreads)
    emit<float>(a, b, h, i / D, i % D, acc_s[i], l_s[i / D]);
  emit_state(a, b, h, m_s, l_s);
}

// ---- host side --------------------------------------------------------------

// The tile, the cache slots it holds and the ring depth whose layout fits
// Rp query rows, and its shared-memory bytes (tile 0 when nothing fits).
// Dense: the largest of 64, 32, 16 slots with two stages. Paged: the page
// and then its halves down to 16 slots, each padded to a multiple of 16
// slots, with two stages or else one.
struct Plan {
  int tile, tslots, stages;
  size_t smem;
};
template <bool kTC, typename TK, bool kPaged>
Plan pick(int Rp, int D, int page) {
  for (int ts = kPaged ? page : 64;; ts /= 2) {
    const int tile = (ts + 15) / 16 * 16;
    for (int st = kStages; st >= (kPaged ? 1 : kStages); --st) {
      const size_t bytes = make_layout<kTC, TK>(Rp, D, tile, st).total;
      if (bytes <= kMaxSmem) return {tile, ts, st, bytes};
    }
    if (kPaged ? ts % 2 != 0 || ts / 2 < 16 : ts == 16) return {0, 0, 0, 0};
  }
}

// f32 q: the most query rows (R = g x span positions) whose layout fits
// beside the smallest tile pick() would take (0 when none does).
template <typename TK, bool kPaged>
int f32_max_rows(int D, int page) {
  if (pick<false, TK, kPaged>(1, D, page).tile == 0) return 0;
  int lo = 1, hi = 1 << 16;  // pick(lo) fits; find the last R that fits
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (pick<false, TK, kPaged>(mid, D, page).tile != 0) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename Kernel>
int run(Kernel kernel, size_t* opted_in, size_t smem, const Args& a, cudaStream_t stream) {
  // Above 48 KB a block must opt in; raise the opt-in once per size.
  if (smem > *opted_in) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    *opted_in = smem;
  }
  kernel<<<dim3(a.n_split, a.Hkv, a.B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The combine of this call's partials (split_kv.cuh).
template <typename TQ>
int combine_splits(const Args& a, cudaStream_t stream) {
  const Partials p{a.ws, a.out, a.o_sb, a.o_ss, a.o_sh, a.B, a.Hkv, a.R, a.D, a.Hq / a.Hkv,
                   a.n_split};
  return combine<TQ>(p, stream);
}

template <typename TK, bool kPaged, int kD>
int launch_tc(Args a, cudaStream_t stream) {
  a.Rp = (a.R + 15) / 16 * 16;
  if (a.Rp * kD > kMaxAcc) return (int)cudaErrorInvalidValue;
  const Plan p = pick<true, TK, kPaged>(a.Rp, kD, a.tslots);
  if (p.tile == 0) return (int)cudaErrorInvalidConfiguration;
  a.tile = p.tile;
  a.tpp = kPaged ? a.tslots / p.tslots : 1;
  a.tslots = p.tslots;
  static size_t opted_in[2] = {48 * 1024, 48 * 1024};
  int rc;
  if constexpr (kPaged) {
    rc = p.stages == 1 ? run(verify_tc_kernel<TK, true, kD, 1>, &opted_in[0], p.smem, a, stream)
                       : run(verify_tc_kernel<TK, true, kD, kStages>, &opted_in[1], p.smem, a, stream);
  } else {
    rc = run(verify_tc_kernel<TK, false, kD, kStages>, &opted_in[1], p.smem, a, stream);
  }
  return rc ? rc : combine_splits<__nv_bfloat16>(a, stream);
}

template <typename TK, bool kPaged>
int launch_f32(Args a, cudaStream_t stream) {
  a.Rp = a.R;
  const Plan p = pick<false, TK, kPaged>(a.Rp, a.D, a.tslots);
  if (p.tile == 0) return (int)cudaErrorInvalidConfiguration;
  a.tile = p.tile;
  a.tpp = kPaged ? a.tslots / p.tslots : 1;
  a.tslots = p.tslots;
  static size_t opted_in[2] = {48 * 1024, 48 * 1024};
  int rc;
  if constexpr (kPaged) {
    rc = p.stages == 1 ? run(verify_f32_kernel<TK, true, 1>, &opted_in[0], p.smem, a, stream)
                       : run(verify_f32_kernel<TK, true, kStages>, &opted_in[1], p.smem, a, stream);
  } else {
    rc = run(verify_f32_kernel<TK, false, kStages>, &opted_in[1], p.smem, a, stream);
  }
  return rc ? rc : combine_splits<float>(a, stream);
}

template <bool kPaged>
int dispatch(Args& a, int dtype, void* stream) {
  if (a.D != 64 && a.D != 128 && a.D != 256) return (int)cudaErrorInvalidValue;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.B <= 0 || a.S <= 0 || a.T <= 0 || a.n_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.n_split > 1 && a.ws == nullptr) return (int)cudaErrorInvalidValue;
  if (kPaged && (a.tslots <= 0 || a.T % a.tslots != 0)) return (int)cudaErrorInvalidValue;
  if ((a.ks == nullptr) != (a.vs == nullptr)) return (int)cudaErrorInvalidValue;
  const bool quant = a.ks != nullptr;
  a.R = (a.Hq / a.Hkv) * a.S;
  a.q16 = dtype == 1 && aligned16<__nv_bfloat16>(a.q, a.q_sb, a.q_ss, a.q_sh);
  a.vec16 = quant ? aligned16<int8_t>(a.k, a.k_sb, a.k_sh, a.k_st) &&
                        aligned16<int8_t>(a.v, a.v_sb, a.v_sh, a.v_st)
                  : dtype == 0 ? aligned16<float>(a.k, a.k_sb, a.k_sh, a.k_st) &&
                                     aligned16<float>(a.v, a.v_sb, a.v_sh, a.v_st)
                               : aligned16<__nv_bfloat16>(a.k, a.k_sb, a.k_sh, a.k_st) &&
                                     aligned16<__nv_bfloat16>(a.v, a.v_sb, a.v_sh, a.v_st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return quant ? launch_f32<int8_t, kPaged>(a, s) : launch_f32<float, kPaged>(a, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (a.D) {
    case 64:
      return quant ? launch_tc<int8_t, kPaged, 64>(a, s) : launch_tc<__nv_bfloat16, kPaged, 64>(a, s);
    case 128:
      return quant ? launch_tc<int8_t, kPaged, 128>(a, s) : launch_tc<__nv_bfloat16, kPaged, 128>(a, s);
    default:
      return quant ? launch_tc<int8_t, kPaged, 256>(a, s) : launch_tc<__nv_bfloat16, kPaged, 256>(a, s);
  }
}

void set_common(Args& a, const void* q, long long q_sb, long long q_ss, long long q_sh,
                const void* k, long long k_sb, long long k_sh, long long k_st, const void* v,
                long long v_sb, long long v_sh, long long v_st, const float* ks, long long ks_sb,
                long long ks_sh, long long ks_st, const float* vs, long long vs_sb,
                long long vs_sh, long long vs_st, const int* starts, long long st_sb,
                long long st_ss, const int* ends, long long en_sb, long long en_ss, void* out,
                long long o_sb, long long o_ss, long long o_sh, float* ws, int n_split) {
  a.q = q; a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k = k; a.k_sb = k_sb; a.k_sh = k_sh; a.k_st = k_st;
  a.v = v; a.v_sb = v_sb; a.v_sh = v_sh; a.v_st = v_st;
  a.ks = ks; a.ks_sb = ks_sb; a.ks_sh = ks_sh; a.ks_st = ks_st;
  a.vs = vs; a.vs_sb = vs_sb; a.vs_sh = vs_sh; a.vs_st = vs_st;
  a.starts = starts; a.st_sb = st_sb; a.st_ss = st_ss;
  a.ends = ends; a.en_sb = en_sb; a.en_ss = en_ss;
  a.out = out; a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.ws = ws; a.n_split = n_split;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q's and out's type; a float cache is in
// the same type). ks/vs: the int8 cache's f32 scales, or null for a float
// cache. ws: f32 workspace of n_split * B * Hkv * R * (D + 2) floats (null
// when n_split = 1). Strides are in elements. Returns the cudaError_t of
// the launches (0 = launched).
extern "C" int advspec_decode_attention_mq(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_sh, long long k_st,
    const void* v, long long v_sb, long long v_sh, long long v_st,
    const float* ks, long long ks_sb, long long ks_sh, long long ks_st,
    const float* vs, long long vs_sb, long long vs_sh, long long vs_st,
    const int* starts, long long st_sb, long long st_ss,
    const int* ends, long long en_sb, long long en_ss,
    void* out, long long o_sb, long long o_ss, long long o_sh,
    float* ws, int n_split,
    int B, int S, int Hq, int Hkv, int T, int D, int dtype,
    float scale, float softcap, void* stream) {
  Args a{};
  set_common(a, q, q_sb, q_ss, q_sh, k, k_sb, k_sh, k_st, v, v_sb, v_sh, v_st, ks, ks_sb, ks_sh,
             ks_st, vs, vs_sb, vs_sh, vs_st, starts, st_sb, st_ss, ends, en_sb, en_ss, out, o_sb,
             o_ss, o_sh, ws, n_split);
  a.B = B; a.S = S; a.Hq = Hq; a.Hkv = Hkv; a.T = T; a.D = D;
  a.scale = scale; a.softcap = softcap;
  return dispatch<false>(a, dtype, stream);
}

// Paged (B4): k/v are a layer's [n_pages, Hkv, page, D] pool view (k_sp the
// page stride; ks_sp the scale pages', [n_pages, Hkv, page, 1]). The table
// is int32 [B, P] with row stride tb_sb and contiguous entries; T = P * page.
extern "C" int advspec_paged_decode_attention_mq(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sp, long long k_sh, long long k_st,
    const void* v, long long v_sp, long long v_sh, long long v_st,
    const float* ks, long long ks_sp, long long ks_sh, long long ks_st,
    const float* vs, long long vs_sp, long long vs_sh, long long vs_st,
    const int* table, long long tb_sb,
    const int* starts, long long st_sb, long long st_ss,
    const int* ends, long long en_sb, long long en_ss,
    void* out, long long o_sb, long long o_ss, long long o_sh,
    float* ws, int n_split,
    int B, int S, int Hq, int Hkv, int P, int page, int D, int dtype,
    float scale, float softcap, void* stream) {
  Args a{};
  set_common(a, q, q_sb, q_ss, q_sh, k, k_sp, k_sh, k_st, v, v_sp, v_sh, v_st, ks, ks_sp, ks_sh,
             ks_st, vs, vs_sp, vs_sh, vs_st, starts, st_sb, st_ss, ends, en_sb, en_ss, out, o_sb,
             o_ss, o_sh, ws, n_split);
  a.table = table; a.tb_sb = tb_sb;
  a.B = B; a.S = S; a.Hq = Hq; a.Hkv = Hkv; a.T = P * page; a.D = D;
  a.tslots = page;
  a.tpp = 1;
  a.scale = scale; a.softcap = softcap;
  return dispatch<true>(a, dtype, stream);
}

// The most query rows per KV head (g x span positions) one f32-q launch of
// B2 (paged = 0) or B4 (paged = 1, page slots per page) holds at head_dim
// D over a float (kv_itemsize 4) or int8 (1) cache: the rows that fit in
// shared memory beside the smallest tile the kernel would stage. 0 when
// not even one row fits; -1 for arguments the kernels do not take.
extern "C" int advspec_verify_max_rows(int D, int kv_itemsize, int paged, int page) {
  if ((D != 64 && D != 128 && D != 256) || (paged && page <= 0)) return -1;
  if (kv_itemsize == 4)
    return paged ? f32_max_rows<float, true>(D, page) : f32_max_rows<float, false>(D, 0);
  if (kv_itemsize == 1)
    return paged ? f32_max_rows<int8_t, true>(D, page) : f32_max_rows<int8_t, false>(D, 0);
  return -1;
}
