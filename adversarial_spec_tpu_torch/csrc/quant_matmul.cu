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
// cast to the output type (x's type, or f32 for the head's logits). Every
// sum is taken in a fixed order (no atomics), so two calls on the same
// inputs are bit-identical.
//
// What bounds it: at decode (M <= 72 rows: 4 for a dense S=1 step, 36 for
// the dense verify, 72 for the batcher's 8-row verify) a product does
// 2*M flops per weight element, far below the card's ~295 flops/byte
// balance point, so the floor is the packed weight bytes / 3.35 TB/s. The
// prefill chunks (M of 512-4096 rows) are bound by tensor-core operations.
//
// What the design does about it (bf16 activations; ops/quant_matmul.py
// plans the column width and the K split from shapes alone):
//   - Widening, exact and once per element, in registers. The product is
//     taken swapped, out^T = q^T x^T: the weight is the tensor cores' A
//     operand, from registers, and the token rows their N side, so M = 4
//     pads to 8 rows, not 64. int4's packing already puts the two K
//     neighbours one bf16x2 register of an A fragment holds into one byte;
//     int8 takes them from two rows with one byte permute. A two's-
//     complement value v of b bits is v = (v & low) - (v & sign), and each
//     term is built as a bf16 bit pattern: 0x4300 | bits is 128 + an
//     integer below 128, or 128 + 128 = 256 = 2^8 for int8's sign bit, all
//     exact in bf16, as is their difference (one lop3 each and one bf16x2
//     subtract for two elements). A-fragment rows may name any weight
//     columns, so a thread's two rows of a fragment are neighbouring
//     columns and one shared-memory load feeds both.
//   - One kernel, qmm_stream_kernel, for decode and prefill rows. Each
//     block owns bn = 64 or 128 weight columns (a consumer warpgroup per
//     64), a tile of NT token rows (the least of 8, 16, 24, 40, 56, 72, 96,
//     128 that holds M; 256-row tiles above) and one run of K. A producer
//     warp keeps a ring of up to 8 stages in flight (as many as ~110 KB of
//     shared memory holds, so two blocks share an SM; twice that for 128
//     and 256 rows, one block an SM): each stage's 64 packed weight rows
//     (64 k of int8, 128 of int4) and its x tile, by TMA (zero-filled past
//     the matrix, which also cancels an odd K's zero row), completing on
//     the stage's mbarrier. The consumers run wgmma.m64nNTk16, A the weight fragment
//     widened in registers, B the x tile in shared memory (K-major,
//     128-byte swizzle), in groups of four k16 steps: one group in flight
//     while the next group's fragments widen.
//   - Decode rows (M <= 128) are a weight stream: the K runs of a column
//     strip form a thread-block cluster of ks <= 16 blocks, as many as keep
//     every cluster resident at once (the runtime's occupancy calculator,
//     advspec_qmm_clusters), so that the grid fills the card even for a
//     narrow weight (wk/wv, N = 1024). At
//     the end every block parks its f32 partial tile in its own shared
//     memory, and block r of the cluster sums its share of the tile over
//     the ranks' partials in rank order, 0 to ks-1, read through
//     distributed shared memory, then scales, casts and stores: no global
//     workspace, no second launch, a fixed order. A split starts on a
//     stage boundary (a multiple of 64 or 128 k), so int4 splits start on
//     an even K row and never cut a nibble pair.
//   - Prefill rows (M > 128) take 256-row tiles (wgmma n = 256: the
//     widening of a weight tile serves twice the rows), 128 weight columns
//     a block, one block an SM, token tiles fastest in the grid so the
//     blocks that share a weight tile run together and find it in L2; K is
//     split only while the tiles leave SMs idle. Without a split a block
//     scales, casts and stores straight from its registers.
//   - Operands TMA cannot take (an x row stride that is no multiple of 8,
//     N no multiple of 16, K below one 64-k box) take qmm_general_kernel,
//     at any M: the same K-split stream and reduction with per-thread
//     cp.async copies (scalar where 16-byte copies do not fit) and
//     mma.sync.m16n8k16 on 128-row tiles. Ragged columns are masked at the
//     store.
//   - f32 activations (the tiny f32 models of the tests): CUDA-core FMA in
//     exact f32 (never TF32), 64 x 64 tiles, 4 x 4 outputs a thread.
//
// Layout and contract (checked again by the Python wrappers,
// ops/quant_matmul.py):
//   x     [M, K] f32 or bf16, row stride ldx (elements), K contiguous
//   q     int8 [K, N] (int8) or [ceil(K/2), N] (int4), contiguous
//   scale f32 [N], contiguous
//   out   [M, N] f32 or bf16, row stride ldo; written, never allocated, here

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// Sign-extended nibbles of a packed byte: low = row 2k, high = row 2k+1.
__device__ __forceinline__ int lo_nibble(uint32_t b) {
  return ((int)(int8_t)(uint8_t)(b << 4)) >> 4;
}
__device__ __forceinline__ int hi_nibble(uint32_t b) {
  return ((int)(int8_t)(uint8_t)b) >> 4;
}

// ---- exact widening into bf16x2 A-fragment registers --------------------------

__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t mask, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(mask), "r"(c));  // (a & b) | c
  return d;
}
// p holds a kBits-bit two's-complement value v in the low bits of each
// 16-bit half; returns the bf16 pair (v_lo, v_hi), exact.
template <int kBits>
__device__ __forceinline__ uint32_t widen_pair(uint32_t p) {
  constexpr uint32_t kLow = kBits == 4 ? 0x00070007u : 0x007F007Fu;
  constexpr uint32_t kSign = kBits == 4 ? 0x00080008u : 0x00800080u;
  const uint32_t a = and_or(p, kLow, 0x43004300u);   // 128 + (v & low)
  const uint32_t b = and_or(p, kSign, 0x43004300u);  // 128 + (v & sign)
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
// int4: byte j of w (rows 2k, 2k+1 of one column) -> (row 2k, row 2k+1);
// w4 = w >> 4.
__device__ __forceinline__ uint32_t widen_int4(uint32_t w, uint32_t w4, int j) {
  return widen_pair<4>(__byte_perm(w, w4, j | ((4 + j) << 8)));
}
// int8: byte j of e (row k) and of o (row k+1) -> (row k, row k+1).
__device__ __forceinline__ uint32_t widen_int8(uint32_t e, uint32_t o, int j) {
  return widen_pair<8>(__byte_perm(e, o, j | ((4 + j) << 8)));
}

// ---- PTX wrappers ----------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
// c += a (16x16, row) * b (16x8, col): bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_scaled(void* out, long long idx, int out_f32, float v) {
  if (out_f32)
    static_cast<float*>(out)[idx] = v;
  else
    static_cast<bf16*>(out)[idx] = __float2bfloat16(v);
}

// ---- TMA and mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// A 2-D box of a tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// ---------------------------------------------------------------------------
// Decode rows: the K-split weight stream (mma.sync, cluster reduction).
// ---------------------------------------------------------------------------

constexpr int kDecRows = 64;   // stored weight rows a stage holds (int8: k; int4: k / 2)
constexpr int kDecMaxM = 128;  // token rows a decode block holds
constexpr int kPrefillRows = 256;  // token rows a prefill block holds
constexpr int kMaxCluster = 16;  // above 8 a kernel opts in to non-portable sizes
constexpr int kStreamMaxStages = 8;
constexpr int kStreamSmem = 110 * 1024;  // ring budget: two blocks on each SM (below 128 rows)

template <bool kInt4>
struct Dec {
  static constexpr int BK = kInt4 ? 2 * kDecRows : kDecRows;  // k per stage
  static constexpr int XLD = BK + 8;  // general kernel: x row stride in shared memory (bf16)
};

// The general kernel's row stride of a stage's weight rows for bn columns: bn + 32
// (bn + 64 at bn = 32) bytes, so that the four rows one load instruction
// touches land 8 banks apart. int8 rows are stored evens first (row 2i at
// i, row 2i+1 at 32 + i) for the same reason.
__host__ __device__ inline int dec_wld(int bn) { return bn == 32 ? 96 : bn + 32; }
template <bool kInt4>
__host__ __device__ inline int dec_srow(int rr) {
  return kInt4 ? rr : (rr & 1) * (kDecRows / 2) + (rr >> 1);
}

// One k16 step s of a stage for one warp: the A fragments of its 32
// columns (wa(rr): the thread's four columns 4g .. 4g+3 of the stage's
// stored weight row rr; A row g of fragment j is column 4g + 2j, row g + 8
// column 4g + 2j + 1), widened in registers, times the x B fragments of
// every 8-row tile i (xa(m, c): the address of x row m, 16-byte chunk c of
// the stage).
template <int FM, bool kInt4, typename WAddr, typename XAddr>
__device__ __forceinline__ void dec_step(float (&acc)[2][FM][4], int s, int lane, WAddr wa,
                                         XAddr xa) {
  const int t = lane % 4, r = 8 * s + t;  // int4: the packed row of k = 16s + 2t; int8: k / 2
  uint32_t a[2][4];
  if (kInt4) {
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wa(r));
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wa(r + 4));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      a[j][0] = widen_int4(w0, w0 >> 4, 2 * j);
      a[j][1] = widen_int4(w0, w0 >> 4, 2 * j + 1);
      a[j][2] = widen_int4(w1, w1 >> 4, 2 * j);
      a[j][3] = widen_int4(w1, w1 >> 4, 2 * j + 1);
    }
  } else {
    const uint32_t e0 = *reinterpret_cast<const uint32_t*>(wa(2 * r));
    const uint32_t o0 = *reinterpret_cast<const uint32_t*>(wa(2 * r + 1));
    const uint32_t e1 = *reinterpret_cast<const uint32_t*>(wa(2 * r + 8));
    const uint32_t o1 = *reinterpret_cast<const uint32_t*>(wa(2 * r + 9));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      a[j][0] = widen_int8(e0, o0, 2 * j);
      a[j][1] = widen_int8(e0, o0, 2 * j + 1);
      a[j][2] = widen_int8(e1, o1, 2 * j);
      a[j][3] = widen_int8(e1, o1, 2 * j + 1);
    }
  }
  const int c = 2 * s + ((lane >> 3) & 1);  // the lane's 8-column half of the k16 step
#pragma unroll
  for (int i = 0; i < FM; i += 2) {
    if (i + 1 < FM) {
      uint32_t b[4];
      ldsm_x4(b, xa(8 * i + (lane & 7) + 8 * (lane >> 4), c));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma_bf16(acc[j][i], a[j], b[0], b[1]);
        mma_bf16(acc[j][i + 1], a[j], b[2], b[3]);
      }
    } else {
      uint32_t b[2];
      ldsm_x2(b, xa(8 * i + (lane & 7), c));
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_bf16(acc[j][i], a[j], b[0], b[1]);
    }
  }
}

// A warp's accumulators into a partial tile [8 FM, bn] (row stride pld),
// at its 32 columns from wc.
template <int FM>
__device__ __forceinline__ void park(float* part, int pld, int wc, int lane,
                                     const float (&acc)[2][FM][4]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      const int n = wc + 4 * g + 2 * j, m = 8 * i + 2 * t;
      *reinterpret_cast<float2*>(part + m * pld + n) = make_float2(acc[j][i][0], acc[j][i][2]);
      *reinterpret_cast<float2*>(part + (m + 1) * pld + n) =
          make_float2(acc[j][i][1], acc[j][i][3]);
    }
}

// After cluster.sync(): block `rank` finishes its share of the tile's
// 4-column chunks (each rank's partial tile [mc, bn], row stride pld, in
// its own shared memory). Each chunk is the sum over the cluster's ranks 0
// .. ks-1 in order (loads issued four ranks at a time), then times the
// scale, one cast, masked stores.
__device__ void cluster_store(const cg::cluster_group& cluster, float* part, int mc, int pld,
                              int bn, int ks, int rank, int m0, int n0, int M, int N,
                              const float* scale, void* out, long long ldo, int out_f32) {
  const int cpr = bn / 4, chunks = mc * cpr;
  const int c_b = (rank + 1) * chunks / ks;
  for (int c = rank * chunks / ks + threadIdx.x; c < c_b; c += blockDim.x) {
    const int m = c / cpr, n = (c % cpr) * 4;
    const int gm = m0 + m, gn = n0 + n;
    if (gm >= M || gn >= N) continue;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q0 = 0; q0 < ks; q0 += 4) {
      float4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q0 + q < ks)
          v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q0 + q) +
                                                  m * pld + n);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q0 + q < ks) {
          sum[0] += v[q].x;
          sum[1] += v[q].y;
          sum[2] += v[q].z;
          sum[3] += v[q].w;
        }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (gn + e < N)
        store_scaled(out, (long long)gm * ldo + gn + e, out_f32, sum[e] * scale[gn + e]);
  }
}

struct DecArgs {
  const bf16* x;
  long long ldx;
  const int8_t* w;
  const float* scale;
  void* out;
  long long ldo;
  int M, N, K, w_rows, bn, ks, stages, out_f32, vec_x, vec_w;
};

// ---- wgmma with the weight as its register A operand ------------------------------

// A K-major bf16 operand tile with the 128-byte swizzle: rows of 128 bytes,
// 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// Keep the compiler from moving register reads or writes across the
// asynchronous wgmma that owns these registers.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int G>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[G][4]) {
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A thread's offsets into a stage's weight tile (BN-byte rows stored by TMA
// with the BN-byte swizzle: 16-byte chunk c of row r at c ^ the address
// bits 7.. of the row) for its wgmma A fragments: A rows g and g + 8 of
// warp w's 16 are the weight columns col = 16w + 2g and col + 1.
//   int4: the two bytes at col of packed rows t and t + 4 (k = 2t, 2t+1 and
//     2t+8, 2t+9), two-byte loads;
//   int8: lane l's row address for ldmatrix.trans (row l of each 32-row
//     pair of k16 steps, at the warp's 16 columns): thread (g, t) receives
//     the 16-bit elements (rows 2t and 2t+1, columns col and col + 1) of
//     each 8-row matrix, the fragment's k pairs for both of its columns.
// The rows of k16 step s lie 8s (int4) or 16s (int8) rows on, where the
// swizzle repeats, so each offset serves every step.
template <int BN, bool kInt4>
__device__ __forceinline__ void frag_offsets(int (&o)[2], int col, int lane) {
  auto at = [&](int r, int c) {
    const int a = r * BN + c;
    return a ^ (((a >> 7) & (BN / 16 - 1)) << 4);
  };
  if (kInt4) {
    o[0] = at(lane % 4, col);
    o[1] = at(lane % 4 + 4, col);
  } else {
    o[0] = at(lane, col & ~15);
    o[1] = 0;
  }
}

// int4: the A fragment of k16 step s (packed rows 8s + t and 8s + t + 4).
template <int BN>
__device__ __forceinline__ void widen_k16_int4(uint32_t (&a)[4], const unsigned char* ws,
                                               const int (&o)[2], int s) {
  const uint32_t h0 = *reinterpret_cast<const uint16_t*>(ws + o[0] + 8 * s * BN);
  const uint32_t h1 = *reinterpret_cast<const uint16_t*>(ws + o[1] + 8 * s * BN);
  const uint32_t h04 = h0 >> 4, h14 = h1 >> 4;
  a[0] = widen_int4(h0, h04, 0);
  a[1] = widen_int4(h0, h04, 1);
  a[2] = widen_int4(h1, h14, 0);
  a[3] = widen_int4(h1, h14, 1);
}

// int8: the A fragments of k16 steps s and s + 1 (rows 16s .. 16s + 31),
// one ldmatrix.trans: byte 0 and 2 of each register are rows 2t, 2t + 1 at
// col, bytes 1 and 3 at col + 1.
template <int BN>
__device__ __forceinline__ void widen_k32_int8(uint32_t (&a)[4], uint32_t (&b)[4],
                                               const unsigned char* ws, const int (&o)[2],
                                               int s) {
  uint32_t r[4];
  ldsm_x4_trans(r, ws + o[0] + 16 * s * BN);
  a[0] = widen_pair<8>(__byte_perm(r[0], 0, 0x0200));
  a[1] = widen_pair<8>(__byte_perm(r[0], 0, 0x0301));
  a[2] = widen_pair<8>(__byte_perm(r[1], 0, 0x0200));
  a[3] = widen_pair<8>(__byte_perm(r[1], 0, 0x0301));
  b[0] = widen_pair<8>(__byte_perm(r[2], 0, 0x0200));
  b[1] = widen_pair<8>(__byte_perm(r[2], 0, 0x0301));
  b[2] = widen_pair<8>(__byte_perm(r[3], 0, 0x0200));
  b[3] = widen_pair<8>(__byte_perm(r[3], 0, 0x0301));
}

// d (64 x N, f32) += a (64 x 16, bf16 registers) * b (16 x N, bf16 from
// shared memory, K-major): wgmma.m64nNk16, one instance per token-tile width.
template <int N>
struct Wgmma;
template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<24> {
  static __device__ __forceinline__ void run(float (&d)[12], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<40> {
  static __device__ __forceinline__ void run(float (&d)[20], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<56> {
  static __device__ __forceinline__ void run(float (&d)[28], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<72> {
  static __device__ __forceinline__ void run(float (&d)[36], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35}, "
        "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// ---- the stream kernel: TMA behind mbarriers, wgmma ---------------------------------
//
// The last warp is the producer: its lane 0 loads each stage by TMA, the
// weight tile (64 stored rows, 64 k of int8 or 128 of int4, x bn columns,
// one box, the bn-byte swizzle) and the x tile (64 k x NT rows a box, the
// 128-byte swizzle), both
// zero-filled past the matrix, completing on the stage's full barrier.
// Consumer warpgroup c (warps 4c .. 4c+3) owns columns 64c .. 64c+63 and
// runs wgmma.m64nNTk16 in groups of four k16 steps (64 k): A the weight
// fragments widened in registers, B the stage's x tile (NT token rows,
// K-major), one group in flight while the next group's fragments widen. A
// stage is released (its empty barrier, one arrival per consumer warp)
// once its last group is done.

__host__ __device__ inline int stream_x_bytes(int nt, int bk) { return nt * bk * 2; }
__host__ __device__ inline int stream_stage_bytes(int bn, int nt, int bk) {
  return stream_x_bytes(nt, bk) + kDecRows * bn;  // a multiple of 1024
}
__host__ __device__ inline int stream_stages(int bn, int nt, int bk) {
  const int budget = nt < kDecMaxM ? kStreamSmem : 2 * kStreamSmem;  // 128+ rows: one block an SM
  const int st = budget / stream_stage_bytes(bn, nt, bk);
  return st < kStreamMaxStages ? st : kStreamMaxStages;
}
__host__ __device__ inline size_t stream_smem(int bn, int nt, int bk, int stages) {
  const size_t ring = (size_t)stages * stream_stage_bytes(bn, nt, bk);
  const size_t part = (size_t)nt * (bn + 4) * 4;
  return (ring > part ? ring : part) + 2 * kStreamMaxStages * 8 + 1024;  // barriers, alignment
}

template <int NT, int BN, bool kInt4>
__global__ void __launch_bounds__(BN / 64 * 128 + 32, NT < 128 ? 2 : 1)
    qmm_stream_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                      const DecArgs p) {
  constexpr int BK = Dec<kInt4>::BK, SPS = BK / 16;  // k16 steps a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  cg::cluster_group cluster = cg::this_cluster();

  const int ks = p.ks, rank = (int)cluster.block_rank(), stages = p.stages;
  const int n0 = (blockIdx.y / ks) * BN, m0 = blockIdx.x * NT;  // token chunks fastest
  constexpr int nwg = BN / 64;  // consumer warpgroups
  const int xbytes = stream_x_bytes(NT, BK), stage = stream_stage_bytes(BN, NT, BK);
  const int nkt = (p.K + BK - 1) / BK;
  const int kt_a = rank * nkt / ks, kt_b = (rank + 1) * nkt / ks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t ring = (size_t)stages * stage, part_bytes = (size_t)NT * (BN + 4) * 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (ring > part_bytes ? ring : part_bytes));
  uint64_t* empty = full + kStreamMaxStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * nwg);
    }
    fence_barrier_init();
  }
  __syncthreads();

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  const int g = lane / 4, t = lane % 4;
  const int col = 16 * warp + 2 * g;  // consumers: warp w's A rows are columns 16w ..

  if (warp == 4 * nwg) {  // producer
    if (lane == 0) {
#pragma unroll 1
      for (int kt = kt_a; kt < kt_b; ++kt) {
        const int i = kt - kt_a, s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], (i / stages - 1) & 1);
        unsigned char* xs = smem + (size_t)s * stage;
        mbar_expect_tx(&full[s], stage);
        tma_load_2d(xs + xbytes, &tw, n0, kt * kDecRows, &full[s]);
#pragma unroll
        for (int h = 0; h < BK / 64; ++h)  // 64 k a box
          tma_load_2d(xs + h * NT * 128, &tx, kt * BK + 64 * h, m0, &full[s]);
      }
    }
  } else {  // consumers: groups of GS k16 steps, one group in flight
    // Four steps a group; two for int8 below 128 rows, whose fragments the
    // two blocks an SM hold in their registers.
    constexpr int GS = kInt4 || NT >= kDecMaxM ? 4 : 2, GPS = SPS / GS;  // groups a stage
    const int ngroups = (kt_b - kt_a) * GPS;
    int o[2];
    frag_offsets<BN, kInt4>(o, col, lane);
    auto widen = [&](uint32_t (&a)[GS][4], int grp) {
      const int i = grp / GPS, st = i % stages;
      if (grp % GPS == 0) mbar_wait(&full[st], (i / stages) & 1);
      const unsigned char* ws = smem + (size_t)st * stage + xbytes;
      const int s0 = GS * (grp % GPS);
#pragma unroll
      for (int kk = 0; kk < GS; kk += kInt4 ? 1 : 2) {
        if constexpr (kInt4)
          widen_k16_int4<BN>(a[kk], ws, o, s0 + kk);
        else
          widen_k32_int8<BN>(a[kk], a[kk + 1], ws, o, s0 + kk);
      }
    };
    auto issue = [&](uint32_t (&a)[GS][4], int grp) {
      const int s0 = GS * (grp % GPS);  // the group's first k16 step in its stage
      const unsigned char* xs = smem + (size_t)((grp / GPS) % stages) * stage;
      const uint64_t desc = kmajor_sw128_desc(xs + (s0 / 4) * NT * 128) + 2 * (s0 % 4);
      fence_acc(acc);
      fence_frags(a);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < GS; ++kk) Wgmma<NT>::run(acc, a[kk], desc + 2 * kk);  // +32 bytes of k
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    // After group `done` has completed: release its stage if it was the last.
    auto retire = [&](int done) {
      if (done % GPS == GPS - 1 && lane == 0) mbar_arrive(&empty[(done / GPS) % stages]);
    };
    uint32_t a0[GS][4] = {}, a1[GS][4] = {};
    if (ngroups > 0) widen(a0, 0);
#pragma unroll 1
    for (int grp = 0; grp < ngroups; grp += 2) {
      issue(a0, grp);  // in flight: grp - 1, grp
      wgmma_wait<1>();
      fence_frags(a1);
      if (grp > 0) retire(grp - 1);
      if (grp + 1 >= ngroups) break;
      widen(a1, grp + 1);
      issue(a1, grp + 1);
      wgmma_wait<1>();
      fence_frags(a0);
      retire(grp);
      if (grp + 2 < ngroups) widen(a0, grp + 2);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frags(a0);
    fence_frags(a1);
    if (ngroups > 0) retire(ngroups - 1);
  }
  // acc[4c + e]: token 8c + 2t + (e & 1), weight column col + (e >> 1).
  if (ks == 1) {  // no split: scale, cast and store from the registers
    const int gn = n0 + col;  // N % 16 == 0: gn + 1 < N too
    if (warp < 4 * nwg && gn < p.N) {
      const float s0 = p.scale[gn], s1 = p.scale[gn + 1];
#pragma unroll
      for (int c = 0; c < NT / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gm = m0 + 8 * c + 2 * t + e;
          if (gm >= p.M) continue;
          const float v0 = acc[4 * c + e] * s0, v1 = acc[4 * c + 2 + e] * s1;
          const long long idx = (long long)gm * p.ldo + gn;
          if (p.out_f32)
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + idx) = make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + idx) =
                __floats2bfloat162_rn(v0, v1);
        }
    }
    return;
  }
  __syncthreads();  // every stage consumed: the ring becomes the partial tile
  float* part = reinterpret_cast<float*>(smem);
  const int pld = BN + 4;
  if (warp < 4 * nwg) {
#pragma unroll
    for (int c = 0; c < NT / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(part + (8 * c + 2 * t + e) * pld + col) =
            make_float2(acc[4 * c + e], acc[4 * c + 2 + e]);
  }
  cluster.sync();
  cluster_store(cluster, part, NT, pld, BN, ks, rank, m0, n0, p.M, p.N, p.scale, p.out, p.ldo,
                p.out_f32);
  cluster.sync();  // no block leaves while another still reads its partial
}

// ---- the general kernel: any alignment (cp.async or scalar copies) ---------------
//
// The same stream for operands TMA cannot take (an x row stride
// that is no multiple of 8, N no multiple of 16, K below one x box): a
// 4-stage cp.async ring whose copies every thread issues (16 bytes where
// alignment allows, zero-filled past the matrix; scalar elsewhere), one
// warp per 32 columns, 128 rows a block.

constexpr int kGenStages = 4;
constexpr int kGenFM = kDecMaxM / 8;

__host__ __device__ inline size_t gen_stage_bytes(int bn, int bk) {
  return (size_t)kDecRows * dec_wld(bn) + (size_t)kDecMaxM * (bk + 8) * 2;
}
__host__ __device__ inline size_t gen_smem(int bn, int bk) {
  const size_t ring = kGenStages * gen_stage_bytes(bn, bk);
  const size_t part = (size_t)kDecMaxM * (bn + 4) * 4;
  return ring > part ? ring : part;
}

// Start the copies of K tile kt (stored weight rows kt * 64 .., x columns
// kt * BK ..) into ring stage ws / xs.
template <bool kInt4>
__device__ void gen_issue(const DecArgs& p, int kt, int m0, int n0, unsigned char* ws, bf16* xs,
                          int wld) {
  constexpr int BK = Dec<kInt4>::BK, XLD = Dec<kInt4>::XLD, MC = kDecMaxM;
  const int r0 = kt * kDecRows, k0 = kt * BK;
  const int cpr = p.bn / 16;  // 16-byte chunks per weight row
  for (int c = threadIdx.x; c < kDecRows * cpr; c += blockDim.x) {
    const int rr = c / cpr, n = (c % cpr) * 16;
    unsigned char* dst = ws + dec_srow<kInt4>(rr) * wld + n;
    const int gr = r0 + rr, gn = n0 + n;
    const int8_t* src = p.w + (long long)gr * p.N + gn;
    if (p.vec_w) {
      const bool in = gr < p.w_rows && gn < p.N;
      cp_async16(dst, in ? src : p.w, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (gr < p.w_rows && gn + e < p.N) ? (unsigned char)src[e] : 0;
    }
  }
  for (int c = threadIdx.x; c < MC * (BK / 8); c += blockDim.x) {
    const int m = c / (BK / 8), k = (c % (BK / 8)) * 8;
    bf16* dst = xs + m * XLD + k;
    const int gm = m0 + m, gk = k0 + k;
    const bf16* src = p.x + (long long)gm * p.ldx + gk;
    if (p.vec_x) {
      const bool in = gm < p.M && gk < p.K;
      cp_async16(dst, in ? src : p.x, in ? 16 : 0);
    } else {
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
      unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
      for (int e = 0; e < 8; ++e) d16[e] = (gm < p.M && gk + e < p.K) ? s16[e] : 0;
    }
  }
}

template <bool kInt4>
__global__ void __launch_bounds__(128) qmm_general_kernel(const DecArgs p) {
  constexpr int FM = kGenFM, MC = kDecMaxM, BK = Dec<kInt4>::BK, XLD = Dec<kInt4>::XLD;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int ks = p.ks, rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / ks) * p.bn, m0 = blockIdx.y * MC;
  const int wld = dec_wld(p.bn);
  const size_t stage = gen_stage_bytes(p.bn, BK);
  const int nkt = (p.K + BK - 1) / BK;
  const int kt_a = rank * nkt / ks, kt_b = (rank + 1) * nkt / ks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  auto wst = [&](int st) { return smem + st * stage; };
  auto xst = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * stage + (size_t)kDecRows * wld);
  };
  auto issue = [&](int kt, int st) {
    if (kt < kt_b) gen_issue<kInt4>(p, kt, m0, n0, wst(st), xst(st), wld);
    cp_async_commit();
  };

  float acc[2][FM][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kGenStages - 1; ++st) issue(kt_a + st, st);
#pragma unroll 1
  for (int kt = kt_a; kt < kt_b; ++kt) {
    const int st = (kt - kt_a) % kGenStages;
    cp_async_wait<kGenStages - 2>();
    __syncthreads();
    issue(kt + kGenStages - 1, (st + kGenStages - 1) % kGenStages);
    const unsigned char* ws = wst(st) + warp * 32 + 4 * (lane / 4);
    const bf16* xs = xst(st);
    auto wa = [&](int rr) { return ws + dec_srow<kInt4>(rr) * wld; };
    auto xa = [&](int m, int c) { return xs + m * XLD + 8 * c; };
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) dec_step<FM, kInt4>(acc, s, lane, wa, xa);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* part = reinterpret_cast<float*>(smem);
  const int pld = p.bn + 4;
  park<FM>(part, pld, warp * 32, lane, acc);
  cluster.sync();
  cluster_store(cluster, part, MC, pld, p.bn, ks, rank, m0, n0, p.M, p.N, p.scale, p.out, p.ldo,
                p.out_f32);
  cluster.sync();  // no block leaves while another still reads its partial
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

// Raise a kernel's dynamic shared-memory opt-in once per size (above 48 KB
// a block must opt in), and opt in to clusters of more than 8 blocks, at
// its first launch (*opted starts at 0).
template <typename Kernel>
int opt_in(Kernel kernel, size_t* opted, size_t smem) {
  if (smem <= *opted) return 0;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) *opted = smem;
  return (int)e;
}

// Launch kernel(args...) on a grid of thread-block clusters of shape cl.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, dim3 grid, dim3 cl, int threads, size_t smem, cudaStream_t s,
                    Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl.x;
  attr[0].val.clusterDim.y = cl.y;
  attr[0].val.clusterDim.z = cl.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool kInt4>
int launch_general(const DecArgs& p, cudaStream_t s) {
  const size_t smem = gen_smem(p.bn, Dec<kInt4>::BK);
  static size_t opted = 0;
  auto kernel = qmm_general_kernel<kInt4>;
  if (int e = opt_in(kernel, &opted, smem)) return e;
  const long long strips = (p.N + p.bn - 1) / p.bn;
  const int chunks = (p.M + kDecMaxM - 1) / kDecMaxM;
  if (strips * p.ks > 0x7fffffffLL || chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(strips * p.ks), (unsigned)chunks, 1);
  return launch_clusters(kernel, grid, dim3(p.ks, 1, 1), p.bn, smem, s, p);  // a warp per 32 columns
}

// The stream kernel's ring depth and shared memory, its opt-ins made.
template <int NT, int BN, bool kInt4>
int stream_prepare(int* stages, size_t* smem) {
  *stages = stream_stages(BN, NT, Dec<kInt4>::BK);
  *smem = stream_smem(BN, NT, Dec<kInt4>::BK, *stages);
  static size_t opted = 0;
  return opt_in(qmm_stream_kernel<NT, BN, kInt4>, &opted, *smem);
}

// The most clusters of ks blocks of the stream kernel the card runs at
// once (the runtime's occupancy calculator; 0 when it cannot tell).
template <int NT, int BN, bool kInt4>
int stream_clusters(int ks) {
  int stages, n = 0;
  size_t smem;
  if (stream_prepare<NT, BN, kInt4>(&stages, &smem)) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, ks, 1);
  cfg.blockDim = dim3(BN / 64 * 128 + 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(&n, qmm_stream_kernel<NT, BN, kInt4>, &cfg) != cudaSuccess) {
    cudaGetLastError();  // clear it: the answer is only "unknown"
    return 0;
  }
  return n;
}

template <int NT, int BN, bool kInt4>
int launch_stream(const CUtensorMap& tx, const CUtensorMap& tw, DecArgs p, cudaStream_t s) {
  size_t smem;
  if (int e = stream_prepare<NT, BN, kInt4>(&p.stages, &smem)) return e;
  auto kernel = qmm_stream_kernel<NT, BN, kInt4>;
  const long long strips = (p.N + p.bn - 1) / p.bn;
  const long long chunks = (p.M + NT - 1) / NT;
  const int threads = BN / 64 * 128 + 32;
  if (strips * p.ks > 65535 || chunks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)chunks, (unsigned)(strips * p.ks), 1);
  if (p.ks == 1) {  // no split: no cluster (the kernel stores from its registers)
    kernel<<<grid, threads, smem, s>>>(tx, tw, p);
    return (int)cudaGetLastError();
  }
  return launch_clusters(kernel, grid, dim3(1, p.ks, 1), threads, smem, s, tx, tw, p);
}

// The token tile: the least of the wgmma widths that holds M rows up to
// 128; above, 256-row tiles.
constexpr int kTokenTiles[] = {8, 16, 24, 40, 56, 72, 96, 128};
inline int token_tile(int M) {
  for (int nt : kTokenTiles)
    if (M <= nt) return nt;
  return kPrefillRows;
}

// CALL(NT, BN) on the stream kernel's instance for M rows and bn columns.
#define ADVSPEC_STREAM_SWITCH(M, bn, CALL)                                        \
  switch (token_tile(M)) {                                                        \
    case 8: return bn == 128 ? CALL(8, 128) : CALL(8, 64);                        \
    case 16: return bn == 128 ? CALL(16, 128) : CALL(16, 64);                     \
    case 24: return bn == 128 ? CALL(24, 128) : CALL(24, 64);                     \
    case 40: return bn == 128 ? CALL(40, 128) : CALL(40, 64);                     \
    case 56: return bn == 128 ? CALL(56, 128) : CALL(56, 64);                     \
    case 72: return bn == 128 ? CALL(72, 128) : CALL(72, 64);                     \
    case 96: return bn == 128 ? CALL(96, 128) : CALL(96, 64);                     \
    case 128: return bn == 128 ? CALL(128, 128) : CALL(128, 64);                  \
    default: return bn == 128 ? CALL(kPrefillRows, 128) : CALL(kPrefillRows, 64); \
  }

template <bool kInt4>
int pick_stream(const CUtensorMap& tx, const CUtensorMap& tw, const DecArgs& p,
                cudaStream_t s) {
#define ADVSPEC_LAUNCH(nt, w) launch_stream<nt, w, kInt4>(tx, tw, p, s)
  ADVSPEC_STREAM_SWITCH(p.M, p.bn, ADVSPEC_LAUNCH)
#undef ADVSPEC_LAUNCH
}

template <bool kInt4>
int pick_clusters(int M, int bn, int ks) {
#define ADVSPEC_CLUSTERS(nt, w) stream_clusters<nt, w, kInt4>(ks)
  ADVSPEC_STREAM_SWITCH(M, bn, ADVSPEC_CLUSTERS)
#undef ADVSPEC_CLUSTERS
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D tensor map over rows x cols elements (row stride in bytes), box
// box_cols x box_rows, swizzled (128-byte unless given), zero fill out of
// bounds.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long rows,
                long long cols, long long row_bytes, int box_cols, int box_rows,
                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What TMA takes: bf16 x rows and weight rows 16-byte aligned, at least
// one 64-k x box.
bool stream_ok(const void* x, long long ldx, const int8_t* w, int N, int K) {
  return ldx % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % 16 == 0 && K >= 64;
}

template <bool kInt4>
int run(const void* x, long long ldx, const int8_t* w, const float* scale, void* out,
        long long ldo, int M, int N, int K, int x_dtype, int out_dtype, int bn, int ksplit,
        void* stream) {
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
  if (x_dtype != 1 || (out_dtype != 0 && out_dtype != 1)) return (int)cudaErrorInvalidValue;
  if ((bn != 32 && bn != 64 && bn != 128) || ksplit < 1 || ksplit > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  DecArgs p{};
  p.x = static_cast<const bf16*>(x);
  p.ldx = ldx;
  p.w = w;
  p.scale = scale;
  p.out = out;
  p.ldo = ldo;
  p.M = M; p.N = N; p.K = K;
  p.w_rows = w_rows;
  p.bn = bn;
  p.ks = ksplit;
  p.out_f32 = out_dtype == 0;
  p.vec_x = (ldx % 8 == 0) && (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  p.vec_w = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (bn >= 64 && stream_ok(x, ldx, w, N, K)) {
    const int mc = token_tile(M);
    CUtensorMap tx, tw;
    const CUtensorMapSwizzle wswz = bn == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    if (!tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, ldx * 2, 64, mc) ||
        !tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, w_rows, N, N, bn, kDecRows, wswz))
      return (int)cudaErrorInvalidValue;
    return pick_stream<kInt4>(tx, tw, p, s);
  }
  // The general kernel's ring (up to 180 KB) leaves one block an SM: its
  // clusters stay within the portable 8.
  p.ks = ksplit < 8 ? ksplit : 8;
  return launch_general<kInt4>(p, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x_dtype 0 takes out_dtype 0 only
// (and ignores bn and ksplit). bn: the columns per block (64 or 128; 32
// takes the general kernel) with ksplit (1-16) blocks along K in a cluster.
// Strides are in elements. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int advspec_matmul_int8(const void* x, long long ldx, const int8_t* q,
                                   const float* scale, void* out, long long ldo, int M, int N,
                                   int K, int x_dtype, int out_dtype, int bn, int ksplit,
                                   void* stream) {
  return run<false>(x, ldx, q, scale, out, ldo, M, N, K, x_dtype, out_dtype, bn, ksplit, stream);
}

// The most clusters of ksplit blocks (bn = 64 or 128 columns each, M token
// rows, int4 1 for B6) of the decode kernel the card runs at once, for the
// plan (ops/quant_matmul.py); 0 when the runtime cannot tell, -1 for
// arguments the kernel does not take.
extern "C" int advspec_qmm_clusters(int M, int bn, int ksplit, int int4) {
  if (M <= 0 || (bn != 64 && bn != 128) || ksplit < 1 || ksplit > kMaxCluster) return -1;
  return int4 ? pick_clusters<true>(M, bn, ksplit) : pick_clusters<false>(M, bn, ksplit);
}

// q4 holds ceil(K/2) packed rows; K is the true contraction width.
extern "C" int advspec_matmul_int4(const void* x, long long ldx, const int8_t* q4,
                                   const float* scale, void* out, long long ldo, int M, int N,
                                   int K, int x_dtype, int out_dtype, int bn, int ksplit,
                                   void* stream) {
  return run<true>(x, ldx, q4, scale, out, ldo, M, N, K, x_dtype, out_dtype, bn, ksplit, stream);
}
