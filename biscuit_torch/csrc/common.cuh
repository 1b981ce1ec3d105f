// Shared device code of the port's kernels: a bf16 tensor-core GEMM main
// loop (mma.sync m16n8k16, f32 accumulate, a three-stage cp.async ring),
// shared-memory barriers and bulk copies, Philox4x32-10, and block
// reductions.
//
// The GEMM computes one BM x 128 tile of C = A * B with A row-major
// (M x K, bf16) and B row-major (K x N, bf16), with 8 warps in a 2 x 4
// grid, each owning a (BM/2) x 32 sub-tile. It leaves the
// accumulators in registers in the mma C-fragment layout; each kernel
// writes its own epilogue with for_each_acc. This is the simple design
// (no wgmma, no TMA), which the unit backward's dgrad runs; the serving
// path's pointwise convs run sepconv_gemm.cuh. Its shared memory
// (GemmSmem) is dynamic: a kernel using it declares `extern __shared__`
// and its launcher raises the block's limit with set_gemm_smem.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bt {

constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 64;
constexpr int GEMM_STAGES = 3;
constexpr int GEMM_THREADS = 256;       // 8 warps: 2 (M) x 4 (N)
constexpr int A_LD = GEMM_BK + 8;       // padded smem rows (bank spread)

constexpr int B_LD = GEMM_BN + 8;

template <int BM>
struct GemmSmem {
  __nv_bfloat16 a[GEMM_STAGES][BM][A_LD];
  __nv_bfloat16 b[GEMM_STAGES][GEMM_BK][B_LD];
};

// Allow `kernel` the dynamic shared memory of a BM-row GEMM tile.
template <int BM, typename K>
inline cudaError_t set_gemm_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(GemmSmem<BM>));
}

template <int BM>
__device__ __forceinline__ GemmSmem<BM>& gemm_smem(unsigned char* raw) {
  return *reinterpret_cast<GemmSmem<BM>*>(raw);
}

template <int BM>
struct Acc {
  static constexpr int MT = BM / 32;    // m16 tiles per warp (BM/2 rows)
  static constexpr int NT = 4;          // n8 tiles per warp (32 columns)
  float v[MT][NT][4];                   // [m16 tile][n8 tile][fragment]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Load k-tile kt of A (rows m0..m0+BM) and B (cols n0..n0+128) into stage.
// Requires K % 8 == 0, N % 8 == 0 and 16-byte aligned rows (lda, ldb % 8).
template <int BM>
__device__ __forceinline__ void gemm_load_tile(
    GemmSmem<BM>& s, int stage, const __nv_bfloat16* __restrict__ A,
    int lda, const __nv_bfloat16* __restrict__ B, int ldb, int M, int N,
    int K, int m0, int n0, int kt) {
  const int tid = threadIdx.x;
  const int k0 = kt * GEMM_BK;
  constexpr int A_CHUNKS = GEMM_BK / 8;   // 16-byte chunks per A row
  constexpr int B_CHUNKS = GEMM_BN / 8;        // 16-byte chunks per B row
#pragma unroll
  for (int i = tid; i < BM * A_CHUNKS; i += GEMM_THREADS) {
    int r = i / A_CHUNKS, c = (i % A_CHUNKS) * 8;
    int gr = m0 + r, gk = k0 + c;
    bool ok = gr < M && gk < K;
    const __nv_bfloat16* src = ok ? A + (size_t)gr * lda + gk : A;
    cp_async16(&s.a[stage][r][c], src, ok ? 16 : 0);
  }
#pragma unroll
  for (int i = tid; i < GEMM_BK * B_CHUNKS; i += GEMM_THREADS) {
    int r = i / B_CHUNKS, c = (i % B_CHUNKS) * 8;
    int gk = k0 + r, gn = n0 + c;
    bool ok = gk < K && gn < N;
    const __nv_bfloat16* src = ok ? B + (size_t)gk * ldb + gn : B;
    cp_async16(&s.b[stage][r][c], src, ok ? 16 : 0);
  }
}

// Main loop: acc = A[m0:m0+BM, :] * B[:, n0:n0+128], f32 accumulate.
template <int BM>
__device__ __forceinline__ void gemm_mainloop(
    GemmSmem<BM>& s, Acc<BM>& acc, const __nv_bfloat16* __restrict__ A,
    int lda, const __nv_bfloat16* __restrict__ B, int ldb, int M, int N, int K,
    int m0, int n0) {
  constexpr int MT = Acc<BM>::MT, NT = Acc<BM>::NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc.v[i][j][f] = 0.f;

  // Ring of GEMM_STAGES tiles: tile kt lives in stage kt % GEMM_STAGES.
  // One group is committed per step (possibly empty), so waiting for all
  // but GEMM_STAGES - 2 groups means tile kt has landed; the barrier after
  // it also proves every warp is done with the stage that is refilled.
  const int nk = (K + GEMM_BK - 1) / GEMM_BK;
#pragma unroll
  for (int t = 0; t < GEMM_STAGES - 1; ++t) {
    if (t < nk)
      gemm_load_tile<BM>(s, t, A, lda, B, ldb, M, N, K, m0, n0, t);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % GEMM_STAGES;
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();
    const int next = kt + GEMM_STAGES - 1;
    if (next < nk)
      gemm_load_tile<BM>(s, next % GEMM_STAGES, A, lda, B, ldb, M, N, K,
                             m0, n0, next);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        int r = wm * (BM / 2) + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[i], &s.a[st][r][c]);
      }
      // Each x4.trans load covers k16 x n16: two n8 tiles' fragments.
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        int c = wn * 32 + j * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bf[j], &s.b[st][r][c]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc.v[i][j], af[i], bf[j >> 1][(j & 1) * 2],
                   bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the caller may reuse the shared memory
}

// Visit the accumulators as f(m16 tile, n8 tile, half, row, col, v[col],
// v[col+1]); half 1 is the fragment's rows 8..15; col is even.
template <int BM, typename F>
__device__ __forceinline__ void for_each_acc(const Acc<BM>& acc, int m0,
                                             int n0, F&& f) {
  constexpr int MT = Acc<BM>::MT, NT = Acc<BM>::NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      int row = m0 + wm * (BM / 2) + i * 16 + g;
      int col = n0 + wn * 32 + j * 8 + 2 * t;
      f(i, j, 0, row, col, acc.v[i][j][0], acc.v[i][j][1]);
      f(i, j, 1, row + 8, col, acc.v[i][j][2], acc.v[i][j][3]);
    }
}

// ---------------------------------------------------------------- Philox
// Philox4x32-10 (Salmon et al. 2011, as in Random123 and cuRAND).
struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += W0;
      k1 += W1;
    }
    uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

__device__ __forceinline__ uint32_t u4_get(const U4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Dropout stream of the MC head: counter (col/4, row, pass, layer), key
// (seed low, seed high); word col%4 is the draw of element (row, col).
__device__ __forceinline__ U4 dropout_bits(uint32_t seed_lo, uint32_t seed_hi,
                                           int pass, int layer, int row,
                                           int col) {
  return philox4x32_10(
      U4{(uint32_t)(col >> 2), (uint32_t)row, (uint32_t)pass, (uint32_t)layer},
      seed_lo, seed_hi);
}

// ----------------------------------------------- mbarriers, bulk copies
// A shared-memory barrier of `count` arrivals a phase, which a bulk copy
// can also complete by its byte count (expect_tx / complete_tx).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// Make the initialised barriers visible before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}
// One arrival that also expects `bytes` from bulk copies this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory by the copy engine, completing
// `bytes` of the barrier's expected transaction count.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------ reductions
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block (blockDim.x a multiple of 32, <= 1024); every
// thread gets the result. scratch: 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = lane < nw ? scratch[lane] : 0.f;
  return warp_sum(s);
}

}  // namespace bt
