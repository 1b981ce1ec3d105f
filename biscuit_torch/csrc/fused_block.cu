// One strided Xception block at inference (entry0, entry1, entry2 and the
// exit block of the trunk):
//
//   a0 = bf16(dw3x3_SAME([relu] x, dw0))       nine f32 taps
//   y0 = relu(f32(a0 . pw0) * s0 + h0)         kept in f32
//   a1 = bf16(dw3x3_SAME(y0, dw1))
//   y1 = bf16(f32(a1 . pw1) * s1 + h1)
//   r  = f32(x[:, ::2, ::2] . rw) * rs + rh    raw x, even rows and columns
//   out = bf16(maxpool3x3_s2_SAME(y1) + r)     (N, ceil(H/2), ceil(W/2), F1)
//
// with the BatchNorms folded to f32 scale and shift, and each product and
// sum of the taps and the BN rounded on its own (no fused multiply-add), at
// the TPU kernel's rounding points.
//
// Replaces the TPU kernel biscuit_tpu/ops/fused_block.py `_kernel` (called
// through `_fused_call` and `fused_strided_block`).
//
// What bounds it on the H100, at N = 256 (the larger of bytes over 3.35
// TB/s and operations over 989 TFLOP/s bf16 or 67 TFLOP/s f32): the bf16
// tensor-core products, 2 M (Cin F0 + F0 F1) + 2 M/4 Cin F1 operations
// (M = N H W), bound entry1 (74^2 128->256, 0.30 ms), entry2 (37^2
// 256->728, 0.54 ms) and the exit block (19^2 728->728->1024, 0.28 ms); at
// entry0 (147^2 64->128) the f32 taps and BN (0.33 ms), the one bf16 read
// of x and write of the output (1.07 GB, 0.32 ms) and the products (0.30
// ms) all but tie.
//
// Design. The TPU kernel streams H strips with 3-row halos through VMEM
// and keeps the whole block on chip. 227 KB of shared memory holds no
// useful strip at 147 x 147 x 128, and Hopper's blocks run in no order, so
// this is six simple passes over HBM behind one entry point, each with a
// fixed order of summation:
//   1. depthwise pass over x (relu as it is read when relu_first) -> a0;
//   2. GEMM a0 . pw0 on mma.sync tensor cores (common.cuh's main loop),
//      epilogue BN0 and relu -> f32 y0. y0 exists only inside the image,
//      so the next pass sees exact zeros at the border, never BN0's shift;
//   3. depthwise pass over y0 -> a1;
//   4. GEMM a1 . pw1, epilogue BN1 -> bf16 y1;
//   5. the max-pool of y1 into the output buffer, one thread per output
//      pixel and 8 channels in 16-byte loads (-inf outside the image; the
//      window starts at row 2i - 1 when H is odd and at 2i when H is even,
//      and the same for W);
//   6. the residual GEMM over x's even-row, even-column pixels (its A rows
//      gathered by a row map in the loader, no copy), whose epilogue
//      applies res_bn, adds the pooled value it reads from the output
//      buffer, and writes bf16 over it.
// The depthwise passes (depthwise.cuh) stage input rows in a shared-memory
// ring filled by bulk copies; the SAME border is zeros in that ring, never
// a padded copy. The wrapper allocates a0,
// y0, a1 and y1 (6.4 GB at entry0 and N = 256), whose round trips are
// most of the time at entry0 and entry1: keeping y0 and a1 on chip (the
// depthwise taps as the GEMMs' A-tile producers) is the next step there,
// and wgmma with a store-coalescing epilogue where the products bound it.
#include "common.cuh"
#include "depthwise.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;

// One pointwise conv of the block: (A . B) * sc + sh over M pixel rows.
// FIRST: relu, written in f32 (y0); else written in bf16 (y1). Block b
// covers column block b % ncol and row block b / ncol, so the blocks that
// share an A tile run together and read it from L2.
template <bool FIRST>
__global__ void __launch_bounds__(bt::GEMM_THREADS)
    sep_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                    const float* __restrict__ sc, const float* __restrict__ sh,
                    void* __restrict__ out, int M, int N, int K, int ncol) {
  extern __shared__ unsigned char smem_raw[];
  auto& s = bt::gemm_smem<BM>(smem_raw);
  bt::Acc<BM> acc;
  const int n0 = (blockIdx.x % ncol) * bt::GEMM_BN;
  const int m0 = (blockIdx.x / ncol) * BM;
  bt::gemm_mainloop<BM>(s, acc, A, K, B, N, M, N, K, m0, n0);
  bt::for_each_acc<BM>(
      acc, m0, n0, [&](int, int, int, int row, int col, float v0, float v1) {
        if (row >= M || col >= N) return;
        const float2 a = *reinterpret_cast<const float2*>(sc + col);
        const float2 b = *reinterpret_cast<const float2*>(sh + col);
        v0 = __fadd_rn(__fmul_rn(v0, a.x), b.x);
        v1 = __fadd_rn(__fmul_rn(v1, a.y), b.y);
        const size_t o = (size_t)row * N + col;
        if (FIRST)
          *reinterpret_cast<float2*>((float*)out + o) =
              make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        else
          *reinterpret_cast<__nv_bfloat162*>((bf16*)out + o) =
              __floats2bfloat162_rn(v0, v1);
      });
}

// Output pixel m = (n * H2 + i) * W2 + j of the stride-2 grid.
struct Pixel2 {
  int n, i, j;
  __device__ __forceinline__ Pixel2(int m, int H2, int W2) {
    j = m % W2;
    const int t = m / W2;
    i = t % H2;
    n = t / H2;
  }
};

// A rows of the residual 1x1 stride-2 conv: output pixel m reads x at
// (n, 2i, 2j), whatever the parity of H and W.
struct StridedRows {
  const bf16* x;
  int H, W, C, H2, W2;
  __device__ __forceinline__ const bf16* operator()(int m) const {
    const Pixel2 p(m, H2, W2);
    return x + (((size_t)p.n * H + 2 * p.i) * W + 2 * p.j) * C;
  }
};

// pooled = maxpool3x3_s2_SAME(y1), written into out. One thread per output
// pixel and 8 channels, in 16-byte loads; the window of output row i starts
// at row 2i - 1 when H is odd and at 2i when H is even (TF/Flax SAME pads
// the smaller half before), the same for W, and rows and columns outside
// the image are skipped (-inf padding).
constexpr int POOL_THREADS = 256;

__global__ void __launch_bounds__(POOL_THREADS)
    pool_kernel(const bf16* __restrict__ y1, bf16* __restrict__ out,
                int n_img, int H, int W, int F) {
  const int f8 = F / 8;
  const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n_img * H2 * W2 * f8) return;
  const int c = (int)(idx % f8) * 8;
  const int m = (int)(idx / f8);
  const Pixel2 p(m, H2, W2);
  const int top = H & 1, left = W & 1;
  const float neg_inf = __int_as_float(0xff800000);
  __nv_bfloat162 mx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) mx[k] = __floats2bfloat162_rn(neg_inf, neg_inf);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int hh = 2 * p.i - top + dy;
    if (hh < 0 || hh >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ww = 2 * p.j - left + dx;
      if (ww < 0 || ww >= W) continue;
      const uint4 u = *reinterpret_cast<const uint4*>(
          y1 + (((size_t)p.n * H + hh) * W + ww) * F + c);
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) mx[k] = __hmax2(mx[k], v[k]);
    }
  }
  uint4 u;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = mx[k];
  *reinterpret_cast<uint4*>(out + (size_t)m * F + c) = u;
}

// out = bf16(f32(out) + (x_s2 . rw) * rs + rh), out holding the pooled y1.
__global__ void __launch_bounds__(bt::GEMM_THREADS)
    residual_kernel(const bf16* __restrict__ x, const bf16* __restrict__ rw,
                    const float* __restrict__ rs,
                    const float* __restrict__ rh, bf16* out, int n_img,
                    int H, int W, int Cin, int F, int ncol) {
  extern __shared__ unsigned char smem_raw[];
  auto& s = bt::gemm_smem<BM>(smem_raw);
  bt::Acc<BM> acc;
  const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
  const int M = n_img * H2 * W2;
  const int n0 = (blockIdx.x % ncol) * bt::GEMM_BN;
  const int m0 = (blockIdx.x / ncol) * BM;
  bt::gemm_mainloop_rows<BM>(s, acc, StridedRows{x, H, W, Cin, H2, W2}, rw,
                             F, M, F, Cin, m0, n0);
  bt::for_each_acc<BM>(
      acc, m0, n0, [&](int, int, int, int row, int col, float v0, float v1) {
        if (row >= M || col >= F) return;
        __nv_bfloat162* o =
            reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * F + col);
        const float2 pooled = __bfloat1622float2(*o);
        const float2 a = *reinterpret_cast<const float2*>(rs + col);
        const float2 b = *reinterpret_cast<const float2*>(rh + col);
        const float r0 = __fadd_rn(__fmul_rn(v0, a.x), b.x);
        const float r1 = __fadd_rn(__fmul_rn(v1, a.y), b.y);
        *o = __floats2bfloat162_rn(__fadd_rn(pooled.x, r0),
                                   __fadd_rn(pooled.y, r1));
      });
}

unsigned gemm_blocks(int M, int N) {
  return (unsigned)(((N + bt::GEMM_BN - 1) / bt::GEMM_BN) *
                    (((size_t)M + BM - 1) / BM));
}

}  // namespace

// x: (N, H, W, Cin) bf16. dw0 (9, Cin), dw1 (9, F0) f32 taps; pw0 (Cin, F0),
// pw1 (F0, F1), rw (Cin, F1) bf16; s0, h0 (F0,), s1, h1, rs, rh (F1,) f32.
// out: (N, ceil(H/2), ceil(W/2), F1) bf16. Scratch a0 (N, H, W, Cin) bf16,
// y0 (N, H, W, F0) f32, a1 (N, H, W, F0) bf16, y1 (N, H, W, F1) bf16.
// Cin, F0, F1 % 8 == 0; every pointer 16-byte aligned.
extern "C" int fused_block_launch(
    const void* x, const void* dw0, const void* pw0, const void* s0,
    const void* h0, const void* dw1, const void* pw1, const void* s1,
    const void* h1, const void* rw, const void* rs, const void* rh, void* out,
    void* a0, void* y0, void* a1, void* y1, int n_img, int H, int W, int Cin,
    int F0, int F1, int relu_first, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n_img == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int M = n_img * H * W;
  const bf16* xb = (const bf16*)x;
  const size_t smem = sizeof(bt::GemmSmem<BM>);

  // 1. a0 = bf16(dw3x3([relu] x)).
  e = relu_first ? bt::depthwise3x3<bf16, bf16, true>(
                       xb, (const float*)dw0, (bf16*)a0, n_img, H, W, Cin, s)
                 : bt::depthwise3x3<bf16, bf16, false>(
                       xb, (const float*)dw0, (bf16*)a0, n_img, H, W, Cin, s);
  if (e != cudaSuccess) return (int)e;

  // 2. y0 = relu(BN0(a0 . pw0)), f32.
  auto* gemm0 = sep_gemm_kernel<true>;
  if ((e = bt::set_gemm_smem<BM>(gemm0)) != cudaSuccess) return (int)e;
  gemm0<<<gemm_blocks(M, F0), bt::GEMM_THREADS, smem, s>>>(
      (const bf16*)a0, (const bf16*)pw0, (const float*)s0, (const float*)h0,
      y0, M, F0, Cin, (F0 + bt::GEMM_BN - 1) / bt::GEMM_BN);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 3. a1 = bf16(dw3x3(y0)).
  if ((e = bt::depthwise3x3<float, bf16, false>(
           (const float*)y0, (const float*)dw1, (bf16*)a1, n_img, H, W, F0,
           s)) != cudaSuccess)
    return (int)e;

  // 4. y1 = bf16(BN1(a1 . pw1)).
  auto* gemm1 = sep_gemm_kernel<false>;
  if ((e = bt::set_gemm_smem<BM>(gemm1)) != cudaSuccess) return (int)e;
  gemm1<<<gemm_blocks(M, F1), bt::GEMM_THREADS, smem, s>>>(
      (const bf16*)a1, (const bf16*)pw1, (const float*)s1, (const float*)h1,
      y1, M, F1, F0, (F1 + bt::GEMM_BN - 1) / bt::GEMM_BN);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 5. out = maxpool(y1); 6. out = bf16(out + res_bn(x_s2 . rw)).
  const int M2 = n_img * ((H + 1) / 2) * ((W + 1) / 2);
  const size_t pool_threads = (size_t)M2 * (F1 / 8);
  pool_kernel<<<(unsigned)((pool_threads + POOL_THREADS - 1) / POOL_THREADS),
                POOL_THREADS, 0, s>>>((const bf16*)y1, (bf16*)out, n_img, H,
                                      W, F1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = bt::set_gemm_smem<BM>(residual_kernel)) != cudaSuccess)
    return (int)e;
  residual_kernel<<<gemm_blocks(M2, F1), bt::GEMM_THREADS, smem, s>>>(
      xb, (const bf16*)rw, (const float*)rs, (const float*)rh, (bf16*)out,
      n_img, H, W, Cin, F1, (F1 + bt::GEMM_BN - 1) / bt::GEMM_BN);
  return (int)cudaGetLastError();
}
