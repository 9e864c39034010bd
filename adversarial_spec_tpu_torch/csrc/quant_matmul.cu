// Weight-only quantized matrix products for Hopper (sm_90a):
//   out[M, N] = (x[M, K] @ q[K, N]) * scale[1, N]
// with the weight stored int8, or as int4 nibbles packed two to a byte.
//
// Replaces two Pallas TPU kernels of the reference package:
//   - adversarial_spec_tpu/ops/pallas_quant.py:matmul_int8
//     (_qmm_int8_kernel, B5): q int8 [K, N];
//   - adversarial_spec_tpu/ops/pallas_quant.py:matmul_int4
//     (_qmm_int4_kernel, B6): q4 int8 [ceil(K/2), N], byte k holding row 2k
//     in its low nibble and row 2k+1 in its high nibble (ops/quant.py
//     pack_int4); an odd K packs one zero row.
// Both keep the reference kernel's arithmetic: an f32 accumulator over the
// whole of K, the per-column f32 scale applied once to the accumulator, one
// cast to the output type (x's type, or f32 for the head's logits).
//
// What bounds it: at decode (M <= 72 rows: 4 for a dense S=1 step, 36 for
// the dense verify, 72 for the batcher's 8-row verify) a product does
// 2*M flops per weight element, far below the card's ~295 flops/byte
// balance point, so the floor is the packed weight bytes / 3.35 TB/s. The
// prefill chunks (M of 512-4096 rows) are bound by tensor-core operations.
//
// What the design does about it:
//   - Each block owns a BM x BN output tile and loops over K itself; the
//     accumulator lives in registers (the Pallas k grid axis and its VMEM
//     scratch become that loop). The weight crosses device memory at its
//     packed width: the int8 tile (or the packed int4 tile, BK/2 bytes per
//     column) is read with 16-byte loads where alignment allows and is
//     widened to bf16 only in shared memory. For M <= 80 one block row
//     covers all of M, so each weight byte is read from device memory once.
//     Above that, blockIdx.x runs over the row tiles, so the blocks that
//     share a weight column tile are scheduled together and all but the
//     first find it in L2; the activation is re-read once per column tile
//     (from L2 where it fits in the 50 MB). The int4 tile is
//     unpacked into rows 2k and 2k+1 of the dense shared tile by shifts
//     (sign-extending both nibbles), so the activation is never split into
//     even and odd columns and never padded: columns >= K are masked to zero
//     as they are loaded, which also cancels the zero row of an odd K.
//   - Global loads for tile t+1 are issued into registers before the
//     products of tile t run, so they overlap.
//   - bf16 activations: products on the tensor cores (WMMA 16x16x16, bf16
//     in, f32 accumulation). For M <= 80 one block covers all rows (BM =
//     16*ceil(M/16)), so the weight is read once; its tile is 32 columns
//     wide and its four warps split K two ways (reduced through shared
//     memory at the end) so that N/32 blocks share the card. Larger M uses
//     128 x 128 tiles with eight warps of 32 x 64 each.
//   - f32 activations (the tiny f32 models of the tests): CUDA-core FMA in
//     exact f32 (never TF32), 64 x 64 tiles, 4 x 4 outputs a thread.
//   - Every shape is covered: any M >= 1, N and K; ragged tiles are masked;
//     vector loads are used only where the pointer, the row stride and the
//     tile edge allow, scalar masked loads elsewhere.
//
// What it does not do yet: wgmma and TMA (the WMMA path reaches a fraction
// of the card's bf16 rate), and a split-K or stream-K grid to fill all 132
// SMs when N/32 is small (wk/wv at decode give 32 blocks).
//
// Layout and contract (checked again by the Python wrappers,
// ops/quant_matmul.py):
//   x     [M, K] f32 or bf16, row stride ldx (elements), K contiguous
//   q     int8 [K, N] (int8) or [ceil(K/2), N] (int4), contiguous
//   scale f32 [N], contiguous
//   out   [M, N] f32 or bf16, row stride ldo; written, never allocated, here

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

// Sign-extended nibbles of a packed byte: low = row 2k, high = row 2k+1.
__device__ __forceinline__ int lo_nibble(uint32_t b) {
  return ((int)(int8_t)(uint8_t)(b << 4)) >> 4;
}
__device__ __forceinline__ int hi_nibble(uint32_t b) {
  return ((int)(int8_t)(uint8_t)b) >> 4;
}

// Byte j (0..15) of a 16-byte vector, and two small integers as a bf16 pair
// (exact: |v| <= 127) in one 32-bit word, low half first.
__device__ __forceinline__ uint32_t byte_of(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j % 4))) & 0xFFu;
}
__device__ __forceinline__ uint32_t bf16x2(int a, int b) {
  const __nv_bfloat162 h = __halves2bfloat162(__int2bfloat16_rn(a), __int2bfloat16_rn(b));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// bf16 activations: tensor cores (WMMA).
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int KSPLIT_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, KSPLIT = KSPLIT_;
  static constexpr int FM = BM / WARPS_M / 16;  // fragments a warp owns along M
  static constexpr int FN = BN / WARPS_N / 16;  // ... and along N
  static constexpr int WARPS = WARPS_M * WARPS_N * KSPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int XLD = BK + 8;  // padded smem row strides (elements)
  static constexpr int WLD = BN + 8;
  static constexpr int RLD = BN + 4;
  static constexpr int TILE_BYTES = (BM * XLD + BK * WLD) * 2;
  static constexpr int RED_BYTES = KSPLIT > 1 ? (KSPLIT - 1) * BM * RLD * 4 : 0;
  static constexpr int EPI_BYTES = WARPS * 16 * 16 * 4;
  static constexpr int SMEM = (TILE_BYTES > RED_BYTES ? TILE_BYTES : RED_BYTES) + EPI_BYTES;
  static_assert(SMEM <= 48 * 1024, "static shared memory");
  static_assert(BM % (16 * WARPS_M) == 0 && BN % (16 * WARPS_N) == 0, "warp tiling");
  static_assert(BK % (16 * KSPLIT) == 0 && BN % 16 == 0 && BK % 8 == 0, "tiles");
};

// Decode: all of M (<= 80 rows) in one block, 32 columns, K split over two
// warp groups. Prefill: 128 x 128 tiles.
template <int FM>
using SmallCfg = Cfg<16 * FM, 32, 128, 1, 2, 2>;
using LargeCfg = Cfg<128, 128, 64, 4, 2, 1>;

template <class C, bool kInt4>
struct Tiles {
  // Weight chunks of 16 packed bytes (one vector load each) per K tile.
  static constexpr int W_ROWS = kInt4 ? C::BK / 2 : C::BK;
  static constexpr int W_CHUNKS = W_ROWS * C::BN / 16;
  static constexpr int W_PER = (W_CHUNKS + C::THREADS - 1) / C::THREADS;
  // Activation chunks of 8 bf16 (16 bytes).
  static constexpr int X_CHUNKS = C::BM * C::BK / 8;
  static constexpr int X_PER = (X_CHUNKS + C::THREADS - 1) / C::THREADS;
};

struct Problem {
  const bf16* x;
  long long ldx;
  const int8_t* w;
  const float* scale;
  void* out;
  long long ldo;
  int M, N, K;
  int w_rows;  // stored weight rows: K (int8) or ceil(K/2) (int4)
  int vec_x, vec_w;
};

template <class C, bool kInt4>
__device__ __forceinline__ void load_tile(const Problem& p, int m0, int n0, int k0,
                                          uint4 (&wr)[Tiles<C, kInt4>::W_PER],
                                          uint4 (&xr)[Tiles<C, kInt4>::X_PER]) {
  using T = Tiles<C, kInt4>;
  const int tid = threadIdx.x;
  const int wk0 = kInt4 ? k0 / 2 : k0;  // first stored weight row of the tile
#pragma unroll
  for (int i = 0; i < T::W_PER; ++i) {
    const int c = tid + i * C::THREADS;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c < T::W_CHUNKS) {
      const int r = wk0 + c / (C::BN / 16);
      const int n = n0 + (c % (C::BN / 16)) * 16;
      if (r < p.w_rows) {
        const int8_t* src = p.w + (long long)r * p.N + n;
        if (p.vec_w && n + 16 <= p.N) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint32_t w4[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (n + j < p.N) w4[j / 4] |= (uint32_t)(uint8_t)src[j] << (8 * (j % 4));
          v = make_uint4(w4[0], w4[1], w4[2], w4[3]);
        }
      }
    }
    wr[i] = v;
  }
#pragma unroll
  for (int i = 0; i < T::X_PER; ++i) {
    const int c = tid + i * C::THREADS;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c < T::X_CHUNKS) {
      const int m = m0 + c / (C::BK / 8);
      const int k = k0 + (c % (C::BK / 8)) * 8;
      if (m < p.M) {
        const bf16* src = p.x + (long long)m * p.ldx + k;
        if (p.vec_x && k + 8 <= p.K) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
          uint32_t w4[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k + j < p.K) w4[j / 2] |= (uint32_t)s16[j] << (16 * (j % 2));
          v = make_uint4(w4[0], w4[1], w4[2], w4[3]);
        }
      }
    }
    xr[i] = v;
  }
}

template <class C, bool kInt4>
__device__ __forceinline__ void store_tile(bf16* xs, bf16* ws,
                                           const uint4 (&wr)[Tiles<C, kInt4>::W_PER],
                                           const uint4 (&xr)[Tiles<C, kInt4>::X_PER]) {
  using T = Tiles<C, kInt4>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < T::W_PER; ++i) {
    const int c = tid + i * C::THREADS;
    if (c >= T::W_CHUNKS) continue;
    const int r = c / (C::BN / 16);
    const int n = (c % (C::BN / 16)) * 16;
    const uint4 v = wr[i];
    uint32_t lo[8], hi[8];  // 16 bf16 each, as pairs
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t b0 = byte_of(v, 2 * j), b1 = byte_of(v, 2 * j + 1);
      if (kInt4) {
        lo[j] = bf16x2(lo_nibble(b0), lo_nibble(b1));
        hi[j] = bf16x2(hi_nibble(b0), hi_nibble(b1));
      } else {
        lo[j] = bf16x2((int)(int8_t)b0, (int)(int8_t)b1);
      }
    }
    // int8: the row r of the tile; int4: rows 2r (low nibbles), 2r+1 (high).
    uint4* d0 = reinterpret_cast<uint4*>(ws + (kInt4 ? 2 * r : r) * C::WLD + n);
    d0[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    d0[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    if (kInt4) {
      uint4* d1 = reinterpret_cast<uint4*>(ws + (2 * r + 1) * C::WLD + n);
      d1[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      d1[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
#pragma unroll
  for (int i = 0; i < T::X_PER; ++i) {
    const int c = tid + i * C::THREADS;
    if (c >= T::X_CHUNKS) continue;
    const int m = c / (C::BK / 8);
    const int k = (c % (C::BK / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + m * C::XLD + k) = xr[i];
  }
}

template <class C, bool kInt4, typename OutT>
__global__ void __launch_bounds__(C::THREADS)
qmm_bf16_kernel(Problem p) {
  using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
  using CFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  using T = Tiles<C, kInt4>;

  __shared__ __align__(128) unsigned char smem[C::SMEM];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + C::BM * C::XLD;
  float* red = reinterpret_cast<float*>(smem);  // reuses the tiles after the loop
  const int TILE_OR_RED = C::TILE_BYTES > C::RED_BYTES ? C::TILE_BYTES : C::RED_BYTES;
  float* epi = reinterpret_cast<float*>(smem + TILE_OR_RED);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp / (C::WARPS_M * C::WARPS_N);  // K-split group
  const int wi = warp % (C::WARPS_M * C::WARPS_N);
  const int wm = (wi / C::WARPS_N) * C::FM * 16;  // warp tile origin in the block tile
  const int wn = (wi % C::WARPS_N) * C::FN * 16;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;  // row tiles fastest

  CFrag acc[C::FM][C::FN];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 wr[T::W_PER], xr[T::X_PER];
  const int n_tiles = (p.K + C::BK - 1) / C::BK;
  load_tile<C, kInt4>(p, m0, n0, 0, wr, xr);
  for (int t = 0; t < n_tiles; ++t) {
    store_tile<C, kInt4>(xs, ws, wr, xr);
    __syncthreads();
    if (t + 1 < n_tiles) load_tile<C, kInt4>(p, m0, n0, (t + 1) * C::BK, wr, xr);
#pragma unroll
    for (int kk = group * 16; kk < C::BK; kk += 16 * C::KSPLIT) {
      AFrag a[C::FM];
      BFrag b[C::FN];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm + 16 * i) * C::XLD + kk, C::XLD);
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
        wmma::load_matrix_sync(b[j], ws + kk * C::WLD + wn + 16 * j, C::WLD);
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (C::KSPLIT > 1) {
    // Groups 1.. park their partial sums; group 0 adds them up.
    if (group > 0) {
      float* r = red + (size_t)(group - 1) * C::BM * C::RLD;
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j)
          wmma::store_matrix_sync(r + (wm + 16 * i) * C::RLD + wn + 16 * j, acc[i][j], C::RLD,
                                  wmma::mem_row_major);
    }
    __syncthreads();
    if (group > 0) return;
#pragma unroll
    for (int g = 1; g < C::KSPLIT; ++g) {
      const float* r = red + (size_t)(g - 1) * C::BM * C::RLD;
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) {
          CFrag part;
          wmma::load_matrix_sync(part, r + (wm + 16 * i) * C::RLD + wn + 16 * j, C::RLD,
                                 wmma::mem_row_major);
#pragma unroll
          for (int e = 0; e < part.num_elements; ++e) acc[i][j].x[e] += part.x[e];
        }
    }
  }

  // Epilogue, one 16 x 16 fragment at a time through the warp's scratch:
  // scale once, cast once, masked store.
  float* s = epi + warp * 256;
  OutT* out = reinterpret_cast<OutT*>(p.out);
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      const int gm0 = m0 + wm + 16 * i, gn0 = n0 + wn + 16 * j;
      if (gm0 >= p.M || gn0 >= p.N) continue;  // warp-uniform
      wmma::store_matrix_sync(s, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = gm0 + e / 16, gn = gn0 + e % 16;
        if (gm < p.M && gn < p.N) store_out(out + (long long)gm * p.ldo + gn, s[e] * p.scale[gn]);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// f32 activations: exact f32 FMA on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

template <bool kInt4>
__global__ void __launch_bounds__(F_THREADS)
qmm_f32_kernel(const float* x, long long ldx, const int8_t* w, const float* scale,
               float* out, long long ldo, int M, int N, int K, int w_rows) {
  __shared__ float xs[F_BM][F_BK + 1];
  __shared__ float ws[F_BK][F_BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int e = threadIdx.x; e < F_BM * F_BK; e += F_THREADS) {
      const int m = e / F_BK, k = e % F_BK;
      const int gm = m0 + m, gk = k0 + k;
      xs[m][k] = (gm < M && gk < K) ? x[(long long)gm * ldx + gk] : 0.0f;
    }
    if (kInt4) {
      for (int e = threadIdx.x; e < (F_BK / 2) * F_BN; e += F_THREADS) {
        const int r = e / F_BN, n = e % F_BN;
        const int gr = k0 / 2 + r, gn = n0 + n;
        const uint32_t b = (gr < w_rows && gn < N) ? (uint8_t)w[(long long)gr * N + gn] : 0u;
        ws[2 * r][n] = (float)lo_nibble(b);
        ws[2 * r + 1][n] = (float)hi_nibble(b);
      }
    } else {
      for (int e = threadIdx.x; e < F_BK * F_BN; e += F_THREADS) {
        const int r = e / F_BN, n = e % F_BN;
        const int gr = k0 + r, gn = n0 + n;
        ws[r][n] = (gr < w_rows && gn < N) ? (float)w[(long long)gr * N + gn] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) out[(long long)gm * ldo + gn] = acc[i][j] * scale[gn];
    }
}

// ---------------------------------------------------------------------------
// Dispatch.
// ---------------------------------------------------------------------------

template <class C, bool kInt4, typename OutT>
int launch_bf16(const Problem& p, cudaStream_t s) {
  dim3 grid((p.M + C::BM - 1) / C::BM, (p.N + C::BN - 1) / C::BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  qmm_bf16_kernel<C, kInt4, OutT><<<grid, C::THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool kInt4, typename OutT>
int pick_bf16(const Problem& p, cudaStream_t s) {
  switch ((p.M + 15) / 16) {
    case 1: return launch_bf16<SmallCfg<1>, kInt4, OutT>(p, s);
    case 2: return launch_bf16<SmallCfg<2>, kInt4, OutT>(p, s);
    case 3: return launch_bf16<SmallCfg<3>, kInt4, OutT>(p, s);
    case 4: return launch_bf16<SmallCfg<4>, kInt4, OutT>(p, s);
    case 5: return launch_bf16<SmallCfg<5>, kInt4, OutT>(p, s);
    default: return launch_bf16<LargeCfg, kInt4, OutT>(p, s);
  }
}

template <bool kInt4>
int run(const void* x, long long ldx, const int8_t* w, const float* scale, void* out,
        long long ldo, int M, int N, int K, int x_dtype, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w_rows = kInt4 ? (K + 1) / 2 : K;
  if (x_dtype == 0) {  // f32 in, f32 out
    if (out_dtype != 0) return (int)cudaErrorInvalidValue;
    dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
    if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
    qmm_f32_kernel<kInt4><<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), ldx, w, scale, static_cast<float*>(out), ldo, M, N, K,
        w_rows);
    return (int)cudaGetLastError();
  }
  if (x_dtype != 1) return (int)cudaErrorInvalidValue;
  Problem p{};
  p.x = static_cast<const bf16*>(x);
  p.ldx = ldx;
  p.w = w;
  p.scale = scale;
  p.out = out;
  p.ldo = ldo;
  p.M = M; p.N = N; p.K = K;
  p.w_rows = w_rows;
  p.vec_x = (ldx % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  p.vec_w = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (out_dtype == 0) return pick_bf16<kInt4, float>(p, s);
  if (out_dtype == 1) return pick_bf16<kInt4, bf16>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x_dtype 0 takes out_dtype 0 only.
// Strides are in elements. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int advspec_matmul_int8(const void* x, long long ldx, const int8_t* q,
                                   const float* scale, void* out, long long ldo, int M, int N,
                                   int K, int x_dtype, int out_dtype, void* stream) {
  return run<false>(x, ldx, q, scale, out, ldo, M, N, K, x_dtype, out_dtype, stream);
}

// q4 holds ceil(K/2) packed rows; K is the true contraction width.
extern "C" int advspec_matmul_int4(const void* x, long long ldx, const int8_t* q4,
                                   const float* scale, void* out, long long ldo, int M, int N,
                                   int K, int x_dtype, int out_dtype, void* stream) {
  return run<true>(x, ldx, q4, scale, out, ldo, M, N, K, x_dtype, out_dtype, stream);
}
