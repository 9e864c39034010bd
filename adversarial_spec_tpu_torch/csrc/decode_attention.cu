// Decode attention for one query token per row over a dense, heads-major KV
// cache or a paged KV pool, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the reference package:
//   - adversarial_spec_tpu/ops/pallas_decode.py:decode_attention
//     (_decode_attn_kernel, B1): every S=1 dense decode step;
//   - adversarial_spec_tpu/ops/pallas_paged.py:paged_decode_attention
//     (_paged_attn_kernel, B3): B1 through a page table over a shared
//     page pool (the continuous batcher's S=1 decode).
// The speculative verify (S > 1 query positions per row: B2, B4) is
// verify_attention.cu. One online-softmax body serves both, each over a
// float cache (K/V in q's type) or an int8 cache (the reference's
// kv_dtype="int8": int8 K/V with per-(token, head) f32 scales, dequantized
// inside the staged tile as the Pallas kernels do, ops/flash_common.py
// flash_update_heads) — four entries. Two template switches pick the entry:
// the K/V element type (q's type or int8_t) and kPaged, the tile-address
// policy: a dense cache tile is `tile` consecutive slots of the row's
// [Hkv, T, D] slice; a paged tile is exactly one page, found through the
// row's page-table entry. Each entry has its own launch counter on the
// Python side (ops/decode_attention.py and ops/paged_attention.py, an
// `_int8kv` counter for the int8 cache), and shows up under its own name in
// a profile.
//
// What bounds it: the bytes of K and V it reads. At the main paths' shapes
// (Llama-3-8B, Hkv=8, D=128, bf16; thousands of cached slots per row) a
// layer does ~2 flops per K/V byte, far below the card's ~295 flops/byte
// balance point, so the floor is bytes / 3.35 TB/s. The int8 cache reads
// D + 4 bytes per (slot, head) for each of K and V (the values and one f32
// scale) instead of 2D.
//
// What the design does about it: every K/V byte is read from device memory
// at most once per call — all g query rows of a KV head share each staged
// tile (the GQA fold), scores/softmax state/accumulator never leave the SM,
// tiles wholly outside the row's window are never loaded, and loads are
// 16-byte vectors where alignment allows.
//
// Paged pools: physical page 0 is the trash page (inactive rows and
// rejected drafts write arbitrary K/V there) and negative ids are table
// padding, so a page whose id is <= 0 is skipped whole — never loaded,
// never scored — exactly as the Pallas kernels skip it (its scale page
// too). Inside a loaded tile, slots outside the window are zero-filled
// rather than loaded (values and scales alike), so whatever bytes lie there
// (stale or poisoned) can never reach the softmax through a 0 * x product.
//
// What it does not do yet: one block per (row, KV head) fills only B*Hkv
// SMs (64 of 132 at the batcher's 8 slots), and tile loads are not
// overlapped with compute; verify_attention.cu's split-KV grid and cp.async
// ring are what this body would take next.
//
// Layout and contract (checked again by the Python wrappers):
//   q   [B, Hq, D], D contiguous
//   dense: k,v [B, Hkv, T, D] any strides except D contiguous — a layer's
//          slice of the [L, B, Hkv, T, D] cache needs no copy
//   paged: k,v [n_pages, Hkv, page, D] (a layer's view of the
//          [L, n_pages, Hkv, page, D] pool), table int32 [B, P] (row
//          stride given, entries contiguous); T = P * page
//   int8 cache: k,v int8 in the same layouts, and ks,vs f32 scales
//          [B, Hkv, T, 1] (dense) or [n_pages, Hkv, page, 1] (paged), any
//          strides; a null ks means a float cache
//   bounds int32 [B, 2] (start, end)
//   out [B, Hq, D]   in q's dtype; written, never allocated, here
// Each row masks its own [start, end); the ragged tail past T is masked; a
// row with an empty window yields exact zeros. Softmax state and the
// accumulator are f32; the optional softcap is tanh(s/c)*c; scores are
// (q . k) * scale. An int8 slot dequantizes in f32 before it is used,
// k = float(k8) * ks[t], v = float(v8) * vs[t], in the reference's order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// 227 KB of dynamic shared memory per block on sm_90, less a margin for the
// kernel's static shared memory.
constexpr size_t kMaxSmem = 232448 - 1024;

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
  int B, Hq, Hkv, T, D, tile, vec16;
  float scale, softcap;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
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
// int8 row: each element dequantized in f32 (float(k8) * ks) before the
// product, as the reference dequantizes the tile before its dot.
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

// Smem row stride of a staged K/V tile, in elements: one extra 4-byte word
// per row so threads reading the same column of consecutive rows (the score
// loop) hit distinct banks (an int8 row of D + 4 bytes is D/4 + 1 words).
template <typename T>
__host__ __device__ constexpr int tile_stride(int D) {
  return D + 4 / (int)sizeof(T);
}

template <typename TK>
__host__ __device__ constexpr bool is_int8() {
  return std::is_same<TK, int8_t>::value;
}

template <typename TK>
size_t smem_bytes(int R, int D, int tile) {
  size_t floats = 2 * (size_t)R * D + (size_t)R * tile + 3 * (size_t)R;
  if (is_int8<TK>()) floats += 2 * (size_t)tile;  // the tile's K and V scales
  size_t kv = 2 * (size_t)tile * tile_stride<TK>(D) * sizeof(TK);
  return floats * 4 + kv;
}

// TQ is q's and out's type; TK the K/V element type (TQ, or int8_t for the
// int8 cache). kPaged = true reads tiles through the page table (B3); its
// tile is one page (a.tile == page size).
template <typename TQ, typename TK, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(Args a) {
  constexpr bool kQuant = is_int8<TK>();
  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // batch row
  const int R = a.Hq / a.Hkv;  // query rows owned by this block: the group
  const int D = a.D;
  const int TT = a.tile;
  const int ks = tile_stride<TK>(D);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [R, D] pre-scaled q
  float* acc_s = q_s + R * D;                   // [R, D] running PV
  float* p_s = acc_s + R * D;                   // [R, TT] scores / probs
  float* m_s = p_s + R * TT;                    // [R] running max
  float* l_s = m_s + R;                         // [R] running normalizer
  float* al_s = l_s + R;                        // [R] this tile's alpha
  float* ksc_s = al_s + R;                      // [TT] K scales (int8)
  float* vsc_s = ksc_s + (kQuant ? TT : 0);     // [TT] V scales (int8)
  TK* k_s = reinterpret_cast<TK*>(vsc_s + (kQuant ? TT : 0));  // [TT, ks]
  TK* v_s = k_s + TT * ks;                                      // [TT, ks]

  // Query row r -> head h*R + r.
  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_sb;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[i] = to_f32(qb[(long long)(h * R + r) * a.q_sh + d]) * a.scale;
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();
  // The row's window, clipped to the cache: tiles outside it are skipped
  // entirely (never loaded); an empty window loads nothing.
  const int lo = max(a.bounds[b * a.bd_sb], 0), hi = min(a.bounds[b * a.bd_sb + 1], a.T);

  const TK* kbase = static_cast<const TK*>(a.k) + h * a.k_sh;
  const TK* vbase = static_cast<const TK*>(a.v) + h * a.v_sh;
  const int W = D * (int)sizeof(TK) / 4;  // 4-byte words per K/V row
  const int WS = ks * (int)sizeof(TK) / 4;
  uint32_t* kw = reinterpret_cast<uint32_t*>(k_s);
  uint32_t* vw = reinterpret_cast<uint32_t*>(v_s);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int t0 = (lo / TT) * TT; t0 < hi; t0 += TT) {
    // ---- This tile's base address (slot t0) under the address policy. ----
    const TK* kt;
    const TK* vt;
    long long row;  // the tile's page (paged) or batch row (dense)
    int slot0;      // the tile's first slot within that page or row
    if (kPaged) {
      // Every thread reads the same entry, so the skip is block-uniform.
      const int id = a.table[b * a.tb_sb + t0 / TT];
      if (id <= 0) continue;  // trash page or padding: never loaded
      row = id;
      slot0 = 0;
    } else {
      row = b;
      slot0 = t0;
    }
    kt = kbase + row * a.k_sb + (long long)slot0 * a.k_st;
    vt = vbase + row * a.v_sb + (long long)slot0 * a.v_st;
    if constexpr (kQuant) {
      // ---- Stage the tile's scales (0 outside [lo, hi), as its slots). ----
      const float* kst = a.ks + row * a.ks_sb + h * a.ks_sh + (long long)slot0 * a.ks_st;
      const float* vst = a.vs + row * a.vs_sb + h * a.vs_sh + (long long)slot0 * a.vs_st;
      for (int j = threadIdx.x; j < TT; j += kThreads) {
        const int t = t0 + j;
        const bool in = t >= lo && t < hi;
        ksc_s[j] = in ? kst[(long long)j * a.ks_st] : 0.f;
        vsc_s[j] = in ? vst[(long long)j * a.vs_st] : 0.f;
      }
    }
    // ---- Stage the K/V tile (slots outside [lo, hi) are zero-filled). ----
    if (a.vec16) {
      const int W4 = W / 4;
      for (int i = threadIdx.x; i < TT * W4; i += kThreads) {
        const int j = i / W4, c = i % W4, t = t0 + j;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
        if (t >= lo && t < hi) {
          kv = *reinterpret_cast<const uint4*>(kt + (long long)j * a.k_st + c * (16 / (int)sizeof(TK)));
          vv = *reinterpret_cast<const uint4*>(vt + (long long)j * a.v_st + c * (16 / (int)sizeof(TK)));
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
          kx = *reinterpret_cast<const uint32_t*>(kt + (long long)j * a.k_st + c * (4 / (int)sizeof(TK)));
          vx = *reinterpret_cast<const uint32_t*>(vt + (long long)j * a.v_st + c * (4 / (int)sizeof(TK)));
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
      if (t >= lo && t < hi) {
        if constexpr (kQuant) {
          sc = dot_row(q_s + r * D, k_s + j * ks, D, ksc_s[j]);
        } else {
          sc = dot_row(q_s + r * D, k_s + j * ks, D);
        }
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
      for (int j = 0; j < TT; ++j) {
        float vv = to_f32(v_s[j * ks + d]);
        if constexpr (kQuant) vv *= vsc_s[j];  // float(v8) * vs, then P V
        acc = fmaf(pr[j], vv, acc);
      }
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  // ---- Finalize: acc / max(l, 1e-30) -> exact zeros for empty windows. ----
  TQ* ob = static_cast<TQ*>(a.out) + b * a.o_sb;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    store_as(ob + (long long)(h * R + r) * a.o_sh + d, acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
bool aligned16(const void* p, long long sb, long long sh, long long st) {
  const long long e = (long long)sizeof(T);
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (sb * e) % 16 == 0 &&
         (sh * e) % 16 == 0 && (st * e) % 16 == 0;
}

template <typename TQ, typename TK, bool kPaged>
int launch(Args a, cudaStream_t stream) {
  const int R = a.Hq / a.Hkv;
  int tile = 0;
  if (kPaged) {
    tile = a.tile;  // one page per tile
    if (smem_bytes<TK>(R, a.D, tile) > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  } else {
    for (int c = 128; c >= 16; c /= 2) {
      if (smem_bytes<TK>(R, a.D, c) <= kMaxSmem) {
        tile = c;
        break;
      }
    }
  }
  if (tile == 0) return (int)cudaErrorInvalidConfiguration;
  a.tile = tile;
  a.vec16 = aligned16<TK>(a.k, a.k_sb, a.k_sh, a.k_st) &&
            aligned16<TK>(a.v, a.v_sb, a.v_sh, a.v_st);
  const size_t smem = smem_bytes<TK>(R, a.D, tile);
  // Above 48 KB a block must opt in; raise the opt-in once per size.
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<TQ, TK, kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 grid(a.Hkv, a.B);
  decode_attn_kernel<TQ, TK, kPaged><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kPaged>
int dispatch(Args& a, int dtype, void* stream) {
  if (a.D != 64 && a.D != 128 && a.D != 256) return (int)cudaErrorInvalidValue;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.B <= 0 || a.T <= 0)
    return (int)cudaErrorInvalidValue;
  if (kPaged && (a.tile <= 0 || a.T % a.tile != 0)) return (int)cudaErrorInvalidValue;
  // Both scales or neither: a null ks is a float cache in q's type.
  if ((a.ks == nullptr) != (a.vs == nullptr)) return (int)cudaErrorInvalidValue;
  const bool quant = a.ks != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return quant ? launch<float, int8_t, kPaged>(a, s)
                 : launch<float, float, kPaged>(a, s);
  }
  if (dtype == 1) {
    return quant ? launch<__nv_bfloat16, int8_t, kPaged>(a, s)
                 : launch<__nv_bfloat16, __nv_bfloat16, kPaged>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

void set_scales(Args& a, const float* ks, long long ks_sb, long long ks_sh, long long ks_st,
                const float* vs, long long vs_sb, long long vs_sh, long long vs_st) {
  a.ks = ks; a.ks_sb = ks_sb; a.ks_sh = ks_sh; a.ks_st = ks_st;
  a.vs = vs; a.vs_sb = vs_sb; a.vs_sh = vs_sh; a.vs_st = vs_st;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q's and out's type; a float cache is
// in the same type). ks/vs: the int8 cache's f32 scales, or null for a
// float cache. Strides are in elements. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int advspec_decode_attention(
    const void* q, long long q_sb, long long q_sh,
    const void* k, long long k_sb, long long k_sh, long long k_st,
    const void* v, long long v_sb, long long v_sh, long long v_st,
    const float* ks, long long ks_sb, long long ks_sh, long long ks_st,
    const float* vs, long long vs_sb, long long vs_sh, long long vs_st,
    const int* bounds, long long bd_sb,
    void* out, long long o_sb, long long o_sh,
    int B, int Hq, int Hkv, int T, int D, int dtype,
    float scale, float softcap, void* stream) {
  Args a{};
  a.q = q; a.q_sb = q_sb; a.q_sh = q_sh;
  a.k = k; a.k_sb = k_sb; a.k_sh = k_sh; a.k_st = k_st;
  a.v = v; a.v_sb = v_sb; a.v_sh = v_sh; a.v_st = v_st;
  set_scales(a, ks, ks_sb, ks_sh, ks_st, vs, vs_sb, vs_sh, vs_st);
  a.bounds = bounds; a.bd_sb = bd_sb;
  a.out = out; a.o_sb = o_sb; a.o_sh = o_sh;
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
    int B, int Hq, int Hkv, int P, int page, int D, int dtype,
    float scale, float softcap, void* stream) {
  Args a{};
  a.q = q; a.q_sb = q_sb; a.q_sh = q_sh;
  a.k = k; a.k_sb = k_sp; a.k_sh = k_sh; a.k_st = k_st;
  a.v = v; a.v_sb = v_sp; a.v_sh = v_sh; a.v_st = v_st;
  set_scales(a, ks, ks_sp, ks_sh, ks_st, vs, vs_sp, vs_sh, vs_st);
  a.table = table; a.tb_sb = tb_sb;
  a.bounds = bounds; a.bd_sb = bd_sb;
  a.out = out; a.o_sb = o_sb; a.o_sh = o_sh;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.T = P * page; a.D = D;
  a.tile = page;
  a.scale = scale; a.softcap = softcap;
  return dispatch<true>(a, dtype, stream);
}
