// The Xception middle flow: 8 residual blocks x 3 units of
// relu -> depthwise 3x3 SAME (f32 taps) -> bf16 -> pointwise C x C (bf16,
// f32 accumulate) -> folded BatchNorm, identity residual every 3 units.
//
// Replaces the TPU kernel biscuit_tpu/ops/fused_sepconv.py `_kernel`
// (called through `_fused_call`, `fused_middle_flow` and
// `trunk_features_fused`).
//
// Numerics are the TPU kernel's: the activation is carried in f32 across
// all 24 units; only the pointwise product's input is rounded to bf16, and
// the output is rounded to bf16 once, at the end.
//
// What bounds it on the H100: tensor-core operations. At N = 256 tiles the
// 24 pointwise products are 24 x 2 x (256*19*19) x 728 x 728 = 2.35 TFLOP,
// 2.4 ms at 989 TFLOP/s bf16; the depthwise taps add 24 x 18 x N*361*728
// f32 operations (0.43 ms at 67 TFLOP/s). The unavoidable HBM traffic is
// one bf16 read and write of the activation plus 25 MB of weights, 0.09 ms.
//
// Design: the TPU kernel keeps all 24 units' weights (25 MB) resident in
// VMEM and streams images through them; 227 KB of shared memory holds
// neither the weights nor an image's 19x19x728 f32 activation (1 MB). So
// this works unit by unit over the whole batch, with two launches per
// unit: a depthwise kernel (relu, nine taps in the TPU kernel's order with
// separate f32 multiply and add roundings, bf16 store; a rolling window
// down each image column loads each input 3 times, not 9) and a GEMM
// (M = N*361 pixels, K = N_out = 728) on Hopper's warpgroup MMA, whose
// epilogue applies the folded BN scale/shift and, every third unit, the
// block's residual, writing the f32 carry (or the bf16 output after the
// last unit). The GEMM's grid runs the column blocks of one row block
// together, so each A tile comes from HBM once. The carry makes an HBM
// round trip per unit (about 12 bytes per element with the bf16 GEMM
// input), which the 50 MB L2 does not hold at N = 256: about 16 GB over
// 24 units, some 5 ms at 3.35 TB/s. Measured 16.6 ms at N = 256 (PERF.md):
// bound by that traffic and by each GEMM tile's epilogue, which does not
// overlap its main loop. Keeping the carry on chip (the depthwise taps as
// the GEMM's A-tile producer) and a persistent GEMM are the next steps.
#include "wgmma.cuh"

namespace {

__global__ void to_f32_kernel(const __nv_bfloat16* __restrict__ x,
                              float* __restrict__ y, size_t n) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __bfloat162float(x[i]);
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f),
                     fmaxf(v.w, 0.f));
}

__device__ __forceinline__ void fma_rn4(float acc[4], float4 v, float4 t) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(v.x, t.x));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(v.y, t.y));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(v.z, t.z));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(v.w, t.w));
}

// relu -> depthwise 3x3 SAME -> bf16. A thread owns four channels of one
// image column and walks down it with a rolling 3 x 3 window, so each
// input is loaded 3 times rather than 9.
__global__ void depthwise_kernel(const float* __restrict__ x,
                                 const float* __restrict__ taps,  // (9, C)
                                 __nv_bfloat16* __restrict__ out, int n_img,
                                 int H, int W, int C) {
  const int c4 = C / 4;
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n_img * W * c4) return;
  const int c = (int)(idx % c4) * 4;
  const int w = (int)((idx / c4) % W);
  const size_t img = idx / ((size_t)c4 * W);
  float4 t[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    t[i] = *reinterpret_cast<const float4*>(taps + i * C + c);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // relu'd row hh at columns w-1, w, w+1; zeros outside the image.
  auto load_row = [&](int hh, float4 row[3]) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ww = w + dx - 1;
      row[dx] = (hh >= 0 && hh < H && ww >= 0 && ww < W)
                    ? relu4(*reinterpret_cast<const float4*>(
                          x + ((img * H + hh) * W + ww) * C + c))
                    : zero;
    }
  };
  float4 win[3][3];
  load_row(-1, win[0]);
  load_row(0, win[1]);
  for (int h = 0; h < H; ++h) {
    load_row(h + 1, win[2]);
    // Nine taps in the TPU kernel's (dy, dx) order from zero.
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) fma_rn4(acc, win[dy][dx], t[dy * 3 + dx]);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        out + ((img * H + h) * W + w) * C + c);
    o[0] = __floats2bfloat162_rn(acc[0], acc[1]);
    o[1] = __floats2bfloat162_rn(acc[2], acc[3]);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      win[0][dx] = win[1][dx];
      win[1][dx] = win[2][dx];
    }
  }
}

// ------------------------------------------------- pointwise GEMM (wgmma)
// C = A . B^T with A (M x K) and Bt (N x K) both K-major in shared memory,
// 128-byte swizzled, as Hopper's warpgroup MMA reads them. A block of two
// warpgroups owns a 128 x 128 tile; each warpgroup issues m64n128k16.
constexpr int PW_BM = 128, PW_BN = 128, PW_BK = 64, PW_STAGES = 3;
constexpr int PW_THREADS = 256;
constexpr int PW_TILE = 128 * PW_BK * 2;       // bytes of one 128 x 64 tile
constexpr int PW_SMEM = 2 * PW_STAGES * PW_TILE + 1024;   // + alignment

// 128 rows x 64 k of a K-major matrix into a swizzled tile (zero-filled
// past `rows` and K).
__device__ __forceinline__ void load_tile_swz(unsigned char* tile,
                                              const __nv_bfloat16* src,
                                              int ld, int row0, int rows,
                                              int k0, int K) {
#pragma unroll
  for (int i = threadIdx.x; i < 128 * 8; i += PW_THREADS) {
    const int r = i >> 3, ch = i & 7;
    const int gr = row0 + r, gk = k0 + ch * 8;
    const bool ok = gr < rows && gk < K;
    bt::cp_async16(tile + bt::swz(r, ch),
                   ok ? src + (size_t)gr * ld + gk : src, ok ? 16 : 0);
  }
}

// y = (A . B) * sc + sh [+ res] -> f32 carry, or bf16 out when out_bf16.
// Bt is the unit's pointwise weight as (out, in).
__global__ void __launch_bounds__(PW_THREADS)
    pointwise_kernel(const __nv_bfloat16* __restrict__ A,
                     const __nv_bfloat16* __restrict__ Bt,
                     const float* __restrict__ sc, const float* __restrict__ sh,
                     const float* res, float* out_f32,
                     __nv_bfloat16* out_bf16, int M, int C) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = bt::smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* sa = base;                          // [stage][PW_TILE]
  unsigned char* sb = base + PW_STAGES * PW_TILE;    // [stage][PW_TILE]
  // Column blocks vary fastest, so the blocks that share an A tile run
  // together and read it from L2, not HBM.
  const int n0 = blockIdx.x * PW_BN, m0 = blockIdx.y * PW_BM;
  const int wg = threadIdx.x >> 7;
  const int nk = (C + PW_BK - 1) / PW_BK;

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

#pragma unroll
  for (int t = 0; t < PW_STAGES - 1; ++t) {
    if (t < nk) {
      load_tile_swz(sa + t * PW_TILE, A, C, m0, M, t * PW_BK, C);
      load_tile_swz(sb + t * PW_TILE, Bt, C, n0, C, t * PW_BK, C);
    }
    bt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % PW_STAGES;
    bt::cp_async_wait<PW_STAGES - 2>();
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy.
    bt::fence_proxy_async();
    __syncthreads();
    const int next = kt + PW_STAGES - 1;
    if (next < nk) {
      load_tile_swz(sa + (next % PW_STAGES) * PW_TILE, A, C, m0, M,
                    next * PW_BK, C);
      load_tile_swz(sb + (next % PW_STAGES) * PW_TILE, Bt, C, n0, C,
                    next * PW_BK, C);
    }
    bt::cp_async_commit();
    const uint64_t da =
        bt::smem_desc(bt::smem_u32(sa + st * PW_TILE) + wg * 64 * 128);
    const uint64_t db = bt::smem_desc(bt::smem_u32(sb + st * PW_TILE));
    bt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PW_BK / 16; ++kk)     // 32 bytes per k16 step
      bt::wgmma_m64n128k16(d, da + 2 * kk, db + 2 * kk);
    bt::wgmma_commit();
    bt::wgmma_wait<0>();
  }
  bt::cp_async_wait<0>();

  // Accumulator layout: warp w of the warpgroup holds rows 16w..16w+15;
  // d[4j..4j+3] are the m16n8 fragment of columns 8j..8j+7.
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int row0 = m0 + wg * 64 + w4 * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < PW_BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane & 3);
    if (col >= C) continue;
    const float2 s = *reinterpret_cast<const float2*>(sc + col);
    const float2 b = *reinterpret_cast<const float2*>(sh + col);
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const int row = row0 + hlf * 8;
      if (row >= M) continue;
      float v0 = __fadd_rn(__fmul_rn(d[4 * j + 2 * hlf], s.x), b.x);
      float v1 = __fadd_rn(__fmul_rn(d[4 * j + 2 * hlf + 1], s.y), b.y);
      const size_t o = (size_t)row * C + col;
      if (res) {
        const float2 r = *reinterpret_cast<const float2*>(res + o);
        v0 = __fadd_rn(v0, r.x);
        v1 = __fadd_rn(v1, r.y);
      }
      if (out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(out_f32 + o) = make_float2(v0, v1);
    }
  }
}

// pwt[u][n][k] = pw[u][k][n]: the pointwise weights K-major for wgmma.
__global__ void transpose_kernel(const __nv_bfloat16* __restrict__ pw,
                                 __nv_bfloat16* __restrict__ pwt, int C) {
  __shared__ __nv_bfloat16 t[32][33];
  const size_t u = blockIdx.z;
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const __nv_bfloat16* src = pw + u * C * C;
  __nv_bfloat16* dst = pwt + u * C * C;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    if (k < C && n < C) t[i][threadIdx.x] = src[(size_t)k * C + n];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (k < C && n < C) dst[(size_t)n * C + k] = t[threadIdx.x][i];
  }
}

}  // namespace

// x, out: (N, H, W, C) bf16. dw: (U, 9, C) f32. pw: (U, C, C) bf16 (in,
// out). sc, sh: (U, C) f32. carry, tmp: N*H*W*C f32 scratch. a: N*H*W*C
// bf16 scratch. pwt: U*C*C bf16 scratch. U % 3 == 0, C % 8 == 0.
extern "C" int fused_middle_flow_launch(
    const void* x, const void* dw, const void* pw, const void* sc,
    const void* sh, void* out, void* carry, void* tmp, void* a, void* pwt,
    int n_img, int H, int W, int C, int U, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n_img == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int M = n_img * H * W;
  const size_t n = (size_t)M * C;
  float* R = (float*)carry;   // block input (residual), then block output
  float* T = (float*)tmp;     // carry inside a block
  __nv_bfloat16* Ab = (__nv_bfloat16*)a;
  __nv_bfloat16* Bt = (__nv_bfloat16*)pwt;
  transpose_kernel<<<dim3((C + 31) / 32, (C + 31) / 32, U), dim3(32, 8), 0,
                     s>>>((const __nv_bfloat16*)pw, Bt, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  to_f32_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const __nv_bfloat16*)x, R, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = cudaFuncSetAttribute(pointwise_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                PW_SMEM)) != cudaSuccess)
    return (int)e;
  const size_t dw_threads = (size_t)n_img * W * (C / 4);
  const dim3 gemm_grid((C + PW_BN - 1) / PW_BN, (M + PW_BM - 1) / PW_BM);
  for (int u = 0; u < U; ++u) {
    const float* src = (u % 3 == 0) ? R : T;
    depthwise_kernel<<<(unsigned)((dw_threads + 255) / 256), 256, 0, s>>>(
        src, (const float*)dw + (size_t)u * 9 * C, Ab, n_img, H, W, C);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const bool last_of_block = u % 3 == 2;
    const bool last = u == U - 1;
    pointwise_kernel<<<gemm_grid, PW_THREADS, PW_SMEM, s>>>(
        Ab, Bt + (size_t)u * C * C,
        (const float*)sc + (size_t)u * C, (const float*)sh + (size_t)u * C,
        last_of_block ? R : nullptr, last_of_block ? R : T,
        last ? (__nv_bfloat16*)out : nullptr, M, C);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
