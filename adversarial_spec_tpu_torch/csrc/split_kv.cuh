// The split-KV machinery shared by the decode-attention kernels
// (decode_attention.cu: B1, B3) and the verify kernels
// (verify_attention.cu: B2, B4): the cp.async copies that stage K/V tiles,
// the cut of a window's tiles into near-equal runs (one per split), and the
// combine pass that merges the splits' f32 partials by the log-sum-exp
// rescale. Each .cu is built into its own library (ops/_build.py), so each
// instantiates its own copy; everything here lives in an anonymous
// namespace.
//
// Partials layout (n_split > 1), f32: acc [n_split, B, Hkv, R, D], then m
// and l [n_split, B, Hkv, R]. Query row r of KV head h is span position
// r / g, query head h * g + r % g (S = 1: R = g, position 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---- cp.async ---------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16-byte async copy; src_bytes = 0 zero-fills the destination, reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- element types ------------------------------------------------------------

template <typename TK>
__host__ __device__ constexpr bool is_int8() {
  return std::is_same<TK, int8_t>::value;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
bool aligned16(const void* p, long long sb, long long sh, long long st) {
  const long long e = (long long)sizeof(T);
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (sb * e) % 16 == 0 &&
         (sh * e) % 16 == 0 && (st * e) % 16 == 0;
}

// ---- the split of a window's tiles ------------------------------------------

// Split i's run [*t_a, *t_b) of tile indices: the tiles lo / tile ..
// ceil(hi / tile) of the window [lo, hi) cut into n_split contiguous runs
// whose lengths differ by at most one (empty for an empty window, or when
// the window has fewer tiles than splits). ops/split_kv.py split_tiles
// mirrors it.
__host__ __device__ __forceinline__ void split_run(int lo, int hi, int tile, int n_split, int i,
                                                   int* t_a, int* t_b) {
  const int first = lo < hi ? lo / tile : 0;
  const int n = lo < hi ? (hi + tile - 1) / tile - first : 0;
  *t_a = first + (int)((long long)i * n / n_split);
  *t_b = first + (int)((long long)(i + 1) * n / n_split);
}

// ---- the combine --------------------------------------------------------------

struct Partials {
  const float* ws;  // the layout above
  void* out;        // out[b, s, h * g + r % g, d] at o_sb, o_ss, o_sh
  long long o_sb, o_ss, o_sh;
  int B, Hkv, R, D, g, n_split;
};

// Flat index of partial row (split, b, h, r).
__device__ __forceinline__ long long partial_row(int split, int B, int Hkv, int R, int b, int h,
                                                 int r) {
  return (((long long)split * B + b) * Hkv + h) * R + r;
}

constexpr int kCombineThreads = 256;

// One thread per output element: grid (ceil(R * D / kCombineThreads), Hkv, B).
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads) combine_kernel(Partials p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int R = p.R, D = p.D, ns = p.n_split;
  const long long per = (long long)ns * p.B * p.Hkv * R;  // rows of all partials
  const long long step = (long long)p.B * p.Hkv * R;      // one split's rows
  const long long row0 = ((long long)b * p.Hkv + h) * R;
  const float* m = p.ws + per * D;
  const float* l = m + per;
  TQ* ob = static_cast<TQ*>(p.out) + b * p.o_sb;
  const int i = blockIdx.x * kCombineThreads + threadIdx.x;
  if (i < R * D) {
    const int r = i / D, d = i % D;
    float mx = -INFINITY;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, m[s * step + row0 + r]);
    float o = 0.f, den = 0.f;
    if (mx != -INFINITY) {  // every split empty: exact zeros
      for (int s = 0; s < ns; ++s) {
        const long long row = s * step + row0 + r;
        const float w = expf(m[row] - mx);  // an empty split's m = -inf: w = 0
        den += w * l[row];
        o += w * p.ws[row * D + d];
      }
    }
    store_as(ob + (r / p.g) * p.o_ss + (long long)(h * p.g + r % p.g) * p.o_sh + d,
             o / fmaxf(den, 1e-30f));
  }
}

// Launch the combine (nothing to merge when n_split = 1).
template <typename TQ>
int combine(const Partials& p, cudaStream_t stream) {
  if (p.n_split == 1) return 0;
  combine_kernel<TQ><<<dim3((p.R * p.D + kCombineThreads - 1) / kCombineThreads, p.Hkv, p.B),
                       kCombineThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
