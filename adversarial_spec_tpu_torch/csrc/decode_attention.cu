// Decode attention over a dense, heads-major KV cache or a paged KV pool,
// for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the reference package:
//   - adversarial_spec_tpu/ops/pallas_decode.py:decode_attention
//     (_decode_attn_kernel, B1): one query token per row, every S=1 dense
//     decode step;
//   - adversarial_spec_tpu/ops/pallas_decode.py:decode_attention_mq
//     (_mq_attn_kernel, B2): a short span of S query positions per row
//     (the speculative verify, S = gamma + 1), each position with its own
//     [start, end) window, the whole span reading the cache in one pass;
//   - adversarial_spec_tpu/ops/pallas_paged.py:paged_decode_attention
//     (_paged_attn_kernel, B3): B1 through a page table over a shared
//     page pool (the continuous batcher's S=1 decode);
//   - adversarial_spec_tpu/ops/pallas_paged.py:paged_decode_attention_mq
//     (_paged_mq_attn_kernel, B4): B2 through a page table (the batcher's
//     span-native verify).
// One online-softmax body serves all four. Two template switches pick the
// entry: kSpan (S > 1 query positions per row, or S = 1 with the span axis
// compiled out) and kPaged, the tile-address policy: a dense cache tile is
// `tile` consecutive slots of the row's [Hkv, T, D] slice; a paged tile is
// exactly one page, found through the row's page-table entry. Each entry
// has its own C entry point (and its own launch counter on the Python
// side, ops/decode_attention.py and ops/paged_attention.py), and shows up
// under its own name in a profile.
//
// What bounds it: the bytes of K and V it reads. At the main paths' shapes
// (Llama-3-8B, Hkv=8, D=128, bf16; thousands of cached slots per row) a
// layer does ~2 flops per K/V byte for S=1 (~18 for S=9), far below the
// card's ~295 flops/byte balance point, so the floor is bytes / 3.35 TB/s.
//
// What the design does about it: every K/V byte is read from device memory
// at most once per call — all g*S query rows of a KV head share each staged
// tile (the GQA fold), scores/softmax state/accumulator never leave the SM,
// tiles wholly outside the union of the rows' windows are never loaded, and
// loads are 16-byte vectors where alignment allows.
//
// Paged pools: physical page 0 is the trash page (inactive rows and
// rejected drafts write arbitrary K/V there) and negative ids are table
// padding, so a page whose id is <= 0 is skipped whole — never loaded,
// never scored — exactly as the Pallas kernels skip it. Inside a loaded
// tile, slots outside the union of the block's windows are zero-filled
// rather than loaded, so whatever bytes lie there (stale or poisoned) can
// never reach the softmax through a 0 * x product.
//
// What it does not do yet: one block per (row, KV head) fills only B*Hkv
// SMs (64 of 132 at the batcher's 8 slots), and tile loads are not
// overlapped with compute. A split-KV (flash-decoding) grid with a combine
// pass, cp.async/TMA double buffering and tensor-core scores are later work.
//
// Layout and contract (checked again by the Python wrappers):
//   q   [B, S, Hq, D]   (S=1 entries pass a zero S stride), D contiguous
//   dense: k,v [B, Hkv, T, D] any strides except D contiguous — a layer's
//          slice of the [L, B, Hkv, T, D] cache needs no copy
//   paged: k,v [n_pages, Hkv, page, D] (a layer's view of the
//          [L, n_pages, Hkv, page, D] pool), table int32 [B, P] (row
//          stride given, entries contiguous); T = P * page
//   starts/ends int32 [B, S] (or [B, 1] broadcast via a zero S stride)
//   out [B, S, Hq, D]   in q's dtype; written, never allocated, here
// Each query row masks its own [start, end); the ragged tail past T is
// masked; a row with an empty window yields exact zeros. Softmax state and
// the accumulator are f32; the optional softcap is tanh(s/c)*c; scores are
// (q . k) * scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 227 KB of dynamic shared memory per block on sm_90, less a margin for the
// kernel's static shared memory.
constexpr size_t kMaxSmem = 232448 - 1024;

struct Args {
  const void* q;
  long long q_sb, q_ss, q_sh;
  // Dense: k_sb is the batch-row stride. Paged: k_sb is the page stride.
  const void* k;
  long long k_sb, k_sh, k_st;
  const void* v;
  long long v_sb, v_sh, v_st;
  const int* table;  // paged only: [B, P] physical page ids
  long long tb_sb;
  const int* starts;
  long long st_sb, st_ss;
  const int* ends;
  long long en_sb, en_ss;
  void* out;
  long long o_sb, o_ss, o_sh;
  int B, S, Hq, Hkv, T, D, tile, vec16;
  float scale, softcap;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q_s row (f32, pre-scaled) . k_s row (T), both D long.
__device__ __forceinline__ float dot_row(const float* q, const float* k, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(q[d], k[d], acc);
  return acc;
}
__device__ __forceinline__ float dot_row(const float* q, const __nv_bfloat16* k, int D) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k);
  float acc = 0.f;
  for (int d = 0; d < D / 2; ++d) {
    float2 kf = __bfloat1622float2(k2[d]);
    acc = fmaf(q[2 * d], kf.x, acc);
    acc = fmaf(q[2 * d + 1], kf.y, acc);
  }
  return acc;
}

// Smem row stride of a staged K/V tile, in elements: one extra 4-byte word
// per row so threads reading the same column of consecutive rows (the score
// loop) hit distinct banks.
template <typename T>
__host__ __device__ constexpr int tile_stride(int D) {
  return D + 4 / (int)sizeof(T);
}

template <typename T>
size_t smem_bytes(int R, int D, int tile) {
  size_t floats = 2 * (size_t)R * D + (size_t)R * tile + 3 * (size_t)R;
  size_t ints = 2 * (size_t)R;
  size_t kv = 2 * (size_t)tile * tile_stride<T>(D) * sizeof(T);
  return floats * 4 + ints * 4 + kv;
}

// kSpan = false is the S = 1 entry (B1, B3): the span axis is compiled
// out. kPaged = true reads tiles through the page table (B3, B4); its tile
// is one page (a.tile == page size).
template <typename T, bool kSpan, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(Args a) {
  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // batch row
  const int g = a.Hq / a.Hkv;
  const int R = kSpan ? g * a.S : g;  // query rows owned by this block
  const int D = a.D;
  const int TT = a.tile;
  const int ks = tile_stride<T>(D);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [R, D] pre-scaled q
  float* acc_s = q_s + R * D;                   // [R, D] running PV
  float* p_s = acc_s + R * D;                   // [R, TT] scores / probs
  float* m_s = p_s + R * TT;                    // [R] running max
  float* l_s = m_s + R;                         // [R] running normalizer
  float* al_s = l_s + R;                        // [R] this tile's alpha
  int* lo_s = reinterpret_cast<int*>(al_s + R);  // [R] window start
  int* hi_s = lo_s + R;                          // [R] window end
  T* k_s = reinterpret_cast<T*>(hi_s + R);       // [TT, ks]
  T* v_s = k_s + TT * ks;                        // [TT, ks]
  __shared__ int range_s[2];

  // Query row r = (span position s, group lane gi) -> head h*g + gi.
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = kSpan ? r / g : 0, gi = kSpan ? r % g : r;
    q_s[i] = to_f32(qb[s * a.q_ss + (long long)(h * g + gi) * a.q_sh + d]) * a.scale;
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int s = kSpan ? r / g : 0;
    lo_s[r] = a.starts[b * a.st_sb + s * a.st_ss];
    hi_s[r] = a.ends[b * a.en_sb + s * a.en_ss];
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // Union of the non-empty windows, clipped to the cache: tiles outside
    // it are skipped entirely (never loaded).
    int lo = a.T, hi = 0;
    for (int r = 0; r < R; ++r) {
      const int s0 = max(lo_s[r], 0), e0 = min(hi_s[r], a.T);
      if (s0 < e0) {
        lo = min(lo, s0);
        hi = max(hi, e0);
      }
    }
    range_s[0] = lo;
    range_s[1] = hi;
  }
  __syncthreads();
  const int lo = range_s[0], hi = range_s[1];

  const T* kbase = static_cast<const T*>(a.k) + h * a.k_sh;
  const T* vbase = static_cast<const T*>(a.v) + h * a.v_sh;
  const int W = D * (int)sizeof(T) / 4;  // 4-byte words per K/V row
  const int WS = ks * (int)sizeof(T) / 4;
  uint32_t* kw = reinterpret_cast<uint32_t*>(k_s);
  uint32_t* vw = reinterpret_cast<uint32_t*>(v_s);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int t0 = (lo / TT) * TT; t0 < hi; t0 += TT) {
    // ---- This tile's base address (slot t0) under the address policy. ----
    const T* kt;
    const T* vt;
    if (kPaged) {
      // Every thread reads the same entry, so the skip is block-uniform.
      const int id = a.table[b * a.tb_sb + t0 / TT];
      if (id <= 0) continue;  // trash page or padding: never loaded
      kt = kbase + (long long)id * a.k_sb;
      vt = vbase + (long long)id * a.v_sb;
    } else {
      kt = kbase + b * a.k_sb + (long long)t0 * a.k_st;
      vt = vbase + b * a.v_sb + (long long)t0 * a.v_st;
    }
    // ---- Stage the K/V tile (slots outside [lo, hi) are zero-filled). ----
    if (a.vec16) {
      const int W4 = W / 4;
      for (int i = threadIdx.x; i < TT * W4; i += kThreads) {
        const int j = i / W4, c = i % W4, t = t0 + j;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
        if (t >= lo && t < hi) {
          kv = *reinterpret_cast<const uint4*>(kt + (long long)j * a.k_st + c * (16 / (int)sizeof(T)));
          vv = *reinterpret_cast<const uint4*>(vt + (long long)j * a.v_st + c * (16 / (int)sizeof(T)));
        }
        uint32_t* kr = kw + j * WS + 4 * c;
        uint32_t* vr = vw + j * WS + 4 * c;
        kr[0] = kv.x; kr[1] = kv.y; kr[2] = kv.z; kr[3] = kv.w;
        vr[0] = vv.x; vr[1] = vv.y; vr[2] = vv.z; vr[3] = vv.w;
      }
    } else {
      for (int i = threadIdx.x; i < TT * W; i += kThreads) {
        const int j = i / W, c = i % W, t = t0 + j;
        uint32_t kx = 0u, vx = 0u;
        if (t >= lo && t < hi) {
          kx = *reinterpret_cast<const uint32_t*>(kt + (long long)j * a.k_st + c * (4 / (int)sizeof(T)));
          vx = *reinterpret_cast<const uint32_t*>(vt + (long long)j * a.v_st + c * (4 / (int)sizeof(T)));
        }
        kw[j * WS + c] = kx;
        vw[j * WS + c] = vx;
      }
    }
    __syncthreads();

    // ---- Scores: each query row against each slot of the tile. ----
    for (int i = threadIdx.x; i < R * TT; i += kThreads) {
      const int r = i / TT, j = i % TT, t = t0 + j;
      float sc = -INFINITY;
      if (t < a.T && t >= lo_s[r] && t < hi_s[r]) {
        sc = dot_row(q_s + r * D, k_s + j * ks, D);
        if (a.softcap > 0.f) sc = tanhf(sc / a.softcap) * a.softcap;
      }
      p_s[i] = sc;
    }
    __syncthreads();

    // ---- Online softmax per row (one warp per row). ----
    for (int r = warp; r < R; r += kThreads / 32) {
      float* pr = p_s + r * TT;
      float mx = -INFINITY;
      for (int j = lane; j < TT; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // A row masked everywhere so far keeps m = -inf: pin the exponent
      // and force alpha to 0 so no NaN enters l or acc.
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m_old) ? expf(m_old - m_safe) : 0.f;
      float sum = 0.f;
      for (int j = lane; j < TT; j += 32) {
        const float p = expf(pr[j] - m_safe);
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        al_s[r] = alpha;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + P V ----
    for (int i = threadIdx.x; i < R * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* pr = p_s + r * TT;
      float acc = acc_s[i] * al_s[r];
      for (int j = 0; j < TT; ++j) acc = fmaf(pr[j], to_f32(v_s[j * ks + d]), acc);
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  // ---- Finalize: acc / max(l, 1e-30) -> exact zeros for empty windows. ----
  T* ob = static_cast<T*>(a.out) + b * a.o_sb;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = kSpan ? r / g : 0, gi = kSpan ? r % g : r;
    store_as(ob + s * a.o_ss + (long long)(h * g + gi) * a.o_sh + d,
             acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
bool aligned16(const void* p, long long sb, long long sh, long long st) {
  const long long e = (long long)sizeof(T);
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (sb * e) % 16 == 0 &&
         (sh * e) % 16 == 0 && (st * e) % 16 == 0;
}

template <typename T, bool kSpan, bool kPaged>
int launch(Args a, cudaStream_t stream) {
  const int R = (a.Hq / a.Hkv) * a.S;
  int tile = 0;
  if (kPaged) {
    tile = a.tile;  // one page per tile
    if (smem_bytes<T>(R, a.D, tile) > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  } else {
    for (int c = 128; c >= 16; c /= 2) {
      if (smem_bytes<T>(R, a.D, c) <= kMaxSmem) {
        tile = c;
        break;
      }
    }
  }
  if (tile == 0) return (int)cudaErrorInvalidConfiguration;
  a.tile = tile;
  a.vec16 = aligned16<T>(a.k, a.k_sb, a.k_sh, a.k_st) &&
            aligned16<T>(a.v, a.v_sb, a.v_sh, a.v_st);
  const size_t smem = smem_bytes<T>(R, a.D, tile);
  // Above 48 KB a block must opt in; raise the opt-in once per size.
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<T, kSpan, kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 grid(a.Hkv, a.B);
  decode_attn_kernel<T, kSpan, kPaged><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kSpan, bool kPaged>
int dispatch(Args& a, int dtype, void* stream) {
  if (a.D != 64 && a.D != 128 && a.D != 256) return (int)cudaErrorInvalidValue;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.B <= 0 || a.S <= 0 || a.T <= 0)
    return (int)cudaErrorInvalidValue;
  if (kPaged && (a.tile <= 0 || a.T % a.tile != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, kSpan, kPaged>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16, kSpan, kPaged>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int advspec_decode_attention(
    const void* q, long long q_sb, long long q_sh,
    const void* k, long long k_sb, long long k_sh, long long k_st,
    const void* v, long long v_sb, long long v_sh, long long v_st,
    const int* bounds, long long bd_sb,
    void* out, long long o_sb, long long o_sh,
    int B, int Hq, int Hkv, int T, int D, int dtype,
    float scale, float softcap, void* stream) {
  Args a{};
  a.q = q; a.q_sb = q_sb; a.q_ss = 0; a.q_sh = q_sh;
  a.k = k; a.k_sb = k_sb; a.k_sh = k_sh; a.k_st = k_st;
  a.v = v; a.v_sb = v_sb; a.v_sh = v_sh; a.v_st = v_st;
  a.starts = bounds; a.st_sb = bd_sb; a.st_ss = 0;
  a.ends = bounds + 1; a.en_sb = bd_sb; a.en_ss = 0;
  a.out = out; a.o_sb = o_sb; a.o_ss = 0; a.o_sh = o_sh;
  a.B = B; a.S = 1; a.Hq = Hq; a.Hkv = Hkv; a.T = T; a.D = D;
  a.scale = scale; a.softcap = softcap;
  return dispatch<false, false>(a, dtype, stream);
}

extern "C" int advspec_decode_attention_mq(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_sh, long long k_st,
    const void* v, long long v_sb, long long v_sh, long long v_st,
    const int* starts, long long st_sb, long long st_ss,
    const int* ends, long long en_sb, long long en_ss,
    void* out, long long o_sb, long long o_ss, long long o_sh,
    int B, int S, int Hq, int Hkv, int T, int D, int dtype,
    float scale, float softcap, void* stream) {
  Args a{};
  a.q = q; a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k = k; a.k_sb = k_sb; a.k_sh = k_sh; a.k_st = k_st;
  a.v = v; a.v_sb = v_sb; a.v_sh = v_sh; a.v_st = v_st;
  a.starts = starts; a.st_sb = st_sb; a.st_ss = st_ss;
  a.ends = ends; a.en_sb = en_sb; a.en_ss = en_ss;
  a.out = out; a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.B = B; a.S = S; a.Hq = Hq; a.Hkv = Hkv; a.T = T; a.D = D;
  a.scale = scale; a.softcap = softcap;
  return dispatch<true, false>(a, dtype, stream);
}

// Paged entries (B3: span = 0, S = 1; B4: span = 1). k/v are a layer's
// [n_pages, Hkv, page, D] pool view: k_sp is the page stride. The table is
// int32 [B, P] with row stride tb_sb and contiguous entries; T = P * page.
extern "C" int advspec_paged_decode_attention(
    int span,
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sp, long long k_sh, long long k_st,
    const void* v, long long v_sp, long long v_sh, long long v_st,
    const int* table, long long tb_sb,
    const int* starts, long long st_sb, long long st_ss,
    const int* ends, long long en_sb, long long en_ss,
    void* out, long long o_sb, long long o_ss, long long o_sh,
    int B, int S, int Hq, int Hkv, int P, int page, int D, int dtype,
    float scale, float softcap, void* stream) {
  Args a{};
  a.q = q; a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k = k; a.k_sb = k_sp; a.k_sh = k_sh; a.k_st = k_st;
  a.v = v; a.v_sb = v_sp; a.v_sh = v_sh; a.v_st = v_st;
  a.table = table; a.tb_sb = tb_sb;
  a.starts = starts; a.st_sb = st_sb; a.st_ss = st_ss;
  a.ends = ends; a.en_sb = en_sb; a.en_ss = en_ss;
  a.out = out; a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.B = B; a.S = S; a.Hq = Hq; a.Hkv = Hkv; a.T = P * page; a.D = D;
  a.tile = page;
  a.scale = scale; a.softcap = softcap;
  if (span) return dispatch<true, true>(a, dtype, stream);
  if (S != 1) return (int)cudaErrorInvalidValue;
  return dispatch<false, true>(a, dtype, stream);
}
