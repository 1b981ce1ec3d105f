// One strided Xception block at inference (entry0, entry1, entry2 and the
// exit block of the trunk):
//
//   a0 = bf16(dw3x3_SAME([relu] x, dw0))       nine f32 taps
//   y0 = relu(f32(a0 . pw0) * s0 + h0)         kept in f32
//   a1 = bf16(dw3x3_SAME(y0, dw1))
//   y1 = bf16(f32(a1 . pw1) * s1 + h1)
//   r  = f32(x[:, ::2, ::2] . rw) * rs + rh    raw x, even rows and columns
//   out = T(maxpool3x3_s2_SAME(y1) + r)        (N, ceil(H/2), ceil(W/2), F1)
//
// with the BatchNorms folded to f32 scale and shift, and each product and
// sum of the taps and the BN rounded on its own (no fused multiply-add), at
// the TPU kernel's rounding points. x and out are of one type T: bf16 (the
// bf16 trunk) or f32 (an f32 model's), as the TPU kernel reads x in either
// and writes out_ref in x's dtype.
//
// f32 x. The first depthwise pass reads it as f32 (the instantiation the
// y0 pass runs); a0, y0, a1 and y1 keep their types, so the pool still
// takes bf16 y1 (the TPU kernel's `slab`) and writes its max, exact, as
// f32. The residual product is the one place where f32 x meets the
// tensor cores: the TPU kernel's jnp.dot of f32 x and bf16 rw promotes to
// f32, and bf16 x (within 2^-8 relative) would not be that. This splits
// x = hi + lo, hi = bf16(x) and lo = bf16(x - hi) (x - hi is exact), in a
// small pass over the stride-2 pixels only (a quarter of x, written as
// the rows [hi | lo] of a (M2, 2 Cin) bf16 matrix), and runs the same
// bf16 GEMM over K = 2 Cin against [rw; rw], copied once a call: hi + lo
// is x to 2^-16 relative, and every bf16 product is exact in the f32
// sum, so r is the f32 product to about 2^-16 relative, with one GEMM
// engine for both types. A TF32 wgmma on x (a second instantiation of the
// GEMM, A widened to f32 through its own tensor map) would round x to
// 2^-11.
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
//   2. GEMM a0 . pw0, epilogue BN0 and relu -> f32 y0. y0 exists only
//      inside the image, so the next pass sees exact zeros at the border,
//      never BN0's shift;
//   3. depthwise pass over y0 -> a1;
//   4. GEMM a1 . pw1, epilogue BN1 -> bf16 y1;
//   5. the max-pool of y1 into the output buffer, one thread per output
//      pixel and 8 channels in 16-byte loads (-inf outside the image; the
//      window starts at row 2i - 1 when H is odd and at 2i when H is even,
//      and the same for W);
//   6. the residual GEMM over x's even-row, even-column pixels, read in
//      place by a tensor map with element strides (no copy; for f32 x, the
//      [hi | lo] rows of the split pass), whose epilogue applies res_bn,
//      adds the pooled value it reads from the output buffer, and writes
//      x's type over it.
// The depthwise passes (depthwise.cuh) stage input rows in a shared-memory
// ring filled by bulk copies; the SAME border is zeros in that ring, never
// a padded copy. The three GEMMs are sepconv_gemm.cuh: TMA loads, a
// producer and two consumer warpgroups on wgmma, a persistent grid of CTA
// pairs that share B by multicast, and an epilogue staged through shared
// memory into 16-byte stores. The wrapper allocates a0, y0, a1 and y1
// (6.4 GB at entry0 and N = 256), whose round trips are most of the time
// at entry0 and entry1: keeping y0 and a1 on chip (the depthwise taps as
// the GEMMs' A-tile producers) is the next step there.
#include "depthwise.cuh"
#include "sepconv_gemm.cuh"

namespace {

using bt::bf16;

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

// pooled = maxpool3x3_s2_SAME(y1), written into out. One thread per output
// pixel and 8 channels, in 16-byte loads; the window of output row i starts
// at row 2i - 1 when H is odd and at 2i when H is even (TF/Flax SAME pads
// the smaller half before), the same for W, and rows and columns outside
// the image are skipped (-inf padding).
constexpr int POOL_THREADS = 256;

__device__ __forceinline__ void store8(bf16* p, const __nv_bfloat162 v[4]) {
  uint4 u;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = v[k];
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const __nv_bfloat162 v[4]) {
  float f[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(v[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// OutT: x's type; the max of bf16 values is stored exactly in either.
template <typename OutT>
__global__ void __launch_bounds__(POOL_THREADS)
    pool_kernel(const bf16* __restrict__ y1, OutT* __restrict__ out,
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
  store8(out + (size_t)m * F + c, mx);
}

// For f32 x: the rows [hi | lo] of the residual GEMM's A, (M2, 2 C) bf16,
// hi = bf16(x) and lo = bf16(x - hi) at x's even rows and columns (x - hi
// is exact in f32). One thread per output pixel and 8 channels.
__global__ void __launch_bounds__(POOL_THREADS)
    split_kernel(const float* __restrict__ x, bf16* __restrict__ a,
                 int n_img, int H, int W, int C) {
  const int c8 = C / 8;
  const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n_img * H2 * W2 * c8) return;
  const int c = (int)(idx % c8) * 8;
  const int m = (int)(idx / c8);
  const Pixel2 p(m, H2, W2);
  const float* src = x + (((size_t)p.n * H + 2 * p.i) * W + 2 * p.j) * C + c;
  const float4 v0 = reinterpret_cast<const float4*>(src)[0];
  const float4 v1 = reinterpret_cast<const float4*>(src)[1];
  const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  __nv_bfloat162 hi[4], lo[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hi[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    const float2 h = __bfloat1622float2(hi[k]);
    lo[k] = __floats2bfloat162_rn(v[2 * k] - h.x, v[2 * k + 1] - h.y);
  }
  bf16* row = a + (size_t)m * 2 * C;
  store8(row + c, hi);
  store8(row + C + c, lo);
}

// Step 1: a0 = bf16(dw3x3([relu] x)) for x of type Tin.
template <typename Tin>
cudaError_t first_depthwise(const void* x, const float* taps, bf16* a0,
                            int n_img, int H, int W, int C, bool relu,
                            cudaStream_t s) {
  const Tin* xt = (const Tin*)x;
  return relu ? bt::depthwise3x3<Tin, bf16, true>(xt, taps, a0, n_img, H, W,
                                                  C, s)
              : bt::depthwise3x3<Tin, bf16, false>(xt, taps, a0, n_img, H,
                                                   W, C, s);
}

// Step 5: out = maxpool(y1), out of type OutT.
template <typename OutT>
cudaError_t pool(const bf16* y1, void* out, int n_img, int H, int W, int F,
                 cudaStream_t s) {
  const size_t threads = (size_t)n_img * ((H + 1) / 2) * ((W + 1) / 2) *
                         (F / 8);
  pool_kernel<OutT><<<(unsigned)((threads + POOL_THREADS - 1) / POOL_THREADS),
                      POOL_THREADS, 0, s>>>(y1, (OutT*)out, n_img, H, W, F);
  return cudaGetLastError();
}

}  // namespace

// x: (N, H, W, Cin), bf16, or f32 when x_f32. dw0 (9, Cin), dw1 (9, F0)
// f32 taps; pw0 (Cin, F0), pw1 (F0, F1), rw (Cin, F1) bf16; s0, h0 (F0,),
// s1, h1, rs, rh (F1,) f32. out: (N, ceil(H/2), ceil(W/2), F1) in x's
// type. Scratch a0 (N, H, W, Cin) bf16, y0 (N, H, W, F0) f32, a1 (N, H,
// W, F0) bf16, y1 (N, H, W, F1) bf16; for f32 x also xs (N, ceil(H/2),
// ceil(W/2), 2 Cin) bf16 and rw2 (2 Cin, F1) bf16 (unused, may be null,
// for bf16 x). Cin, F0, F1 % 8 == 0; every pointer 16-byte aligned.
extern "C" int fused_block_launch(
    const void* x, const void* dw0, const void* pw0, const void* s0,
    const void* h0, const void* dw1, const void* pw1, const void* s1,
    const void* h1, const void* rw, const void* rs, const void* rh, void* out,
    void* a0, void* y0, void* a1, void* y1, void* xs, void* rw2, int n_img,
    int H, int W, int Cin, int F0, int F1, int relu_first, int x_f32,
    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n_img == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int M = n_img * H * W;
  const int M2 = n_img * ((H + 1) / 2) * ((W + 1) / 2);
  const bt::DenseA rows{M};
  const bt::DenseA rows2{M2};
  const bt::StridedA xstr = bt::strided_rows(n_img, H, W);
  const bt::SgPlan p0 = bt::sg_plan(rows, F0);
  const bt::SgPlan p1 = bt::sg_plan(rows, F1);
  const bt::SgPlan pr = x_f32 ? bt::sg_plan(rows2, F1) : bt::sg_plan(xstr, F1);
  const int kr = x_f32 ? 2 * Cin : Cin;   // the residual GEMM's K
  CUtensorMap a0map, pw0map, a1map, pw1map, xmap, rwmap;
  if ((e = bt::rows_map(&a0map, a0, M, Cin)) != cudaSuccess ||
      (e = bt::weight_map(&pw0map, p0, pw0, 1, Cin, F0)) != cudaSuccess ||
      (e = bt::rows_map(&a1map, a1, M, F0)) != cudaSuccess ||
      (e = bt::weight_map(&pw1map, p1, pw1, 1, F0, F1)) != cudaSuccess ||
      (e = x_f32 ? bt::rows_map(&xmap, xs, M2, kr)
                 : bt::strided_map(&xmap, xstr, x, H, W, Cin)) !=
          cudaSuccess ||
      (e = bt::weight_map(&rwmap, pr, x_f32 ? rw2 : rw, 1, kr, F1)) !=
          cudaSuccess)
    return (int)e;

  // 1. a0 = bf16(dw3x3([relu] x)).
  e = (x_f32 ? &first_depthwise<float> : &first_depthwise<bf16>)(
      x, (const float*)dw0, (bf16*)a0, n_img, H, W, Cin, relu_first != 0, s);
  if (e != cudaSuccess) return (int)e;

  // 2. y0 = relu(BN0(a0 . pw0)), f32.
  bt::BnEpilogue epi0{};
  epi0.sc = (const float*)s0;
  epi0.sh = (const float*)h0;
  epi0.out_f32 = (float*)y0;
  epi0.ld = F0;
  epi0.relu = 1;
  if ((e = bt::sepconv_gemm(p0, a0map, pw0map, rows, epi0, F0, Cin, 0, s)) !=
      cudaSuccess)
    return (int)e;

  // 3. a1 = bf16(dw3x3(y0)).
  if ((e = bt::depthwise3x3<float, bf16, false>(
           (const float*)y0, (const float*)dw1, (bf16*)a1, n_img, H, W, F0,
           s)) != cudaSuccess)
    return (int)e;

  // 4. y1 = bf16(BN1(a1 . pw1)).
  bt::BnEpilogue epi1{};
  epi1.sc = (const float*)s1;
  epi1.sh = (const float*)h1;
  epi1.out_bf16 = (bf16*)y1;
  epi1.ld = F1;
  if ((e = bt::sepconv_gemm(p1, a1map, pw1map, rows, epi1, F1, F0, 0, s)) !=
      cudaSuccess)
    return (int)e;

  // 5. out = maxpool(y1); 6. out = T(out + res_bn(x_s2 . rw)).
  if ((e = (x_f32 ? &pool<float> : &pool<bf16>)((const bf16*)y1, out, n_img,
                                                 H, W, F1, s)) != cudaSuccess)
    return (int)e;
  bt::BnEpilogue epir{};
  epir.sc = (const float*)rs;
  epir.sh = (const float*)rh;
  epir.ld = F1;
  if (!x_f32) {
    epir.out_bf16 = (bf16*)out;
    epir.add_out = 1;
    return (int)bt::sepconv_gemm(pr, xmap, rwmap, xstr, epir, F1, Cin, 0, s);
  }
  // The [hi | lo] rows of x's stride-2 pixels, and [rw; rw] (copied per
  // call so that the weights keep the bf16 path's layout; see the wrapper).
  const size_t split_threads = (size_t)M2 * (Cin / 8);
  split_kernel<<<(unsigned)((split_threads + POOL_THREADS - 1) / POOL_THREADS),
                 POOL_THREADS, 0, s>>>((const float*)x, (bf16*)xs, n_img, H,
                                       W, Cin);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t rw_bytes = (size_t)Cin * F1 * sizeof(bf16);
  if ((e = cudaMemcpyAsync(rw2, rw, rw_bytes, cudaMemcpyDeviceToDevice, s)) !=
          cudaSuccess ||
      (e = cudaMemcpyAsync((char*)rw2 + rw_bytes, rw, rw_bytes,
                           cudaMemcpyDeviceToDevice, s)) != cudaSuccess)
    return (int)e;
  // The f32 pooled value is the epilogue's f32 residual, read from out
  // and added (pooled + r is r + pooled, one rounding) as out is written.
  epir.add_out = 0;
  epir.res_f32 = (const float*)out;
  epir.out_f32 = (float*)out;
  return (int)bt::sepconv_gemm(pr, xmap, rwmap, rows2, epir, F1, kr, 0, s);
}

// The plans of the block's three GEMMs (sepconv_gemm_report, one after
// another: GEMM0, GEMM1, then the residual conv's, as bf16 x runs it).
extern "C" int fused_block_gemm_plan(int n_img, int H, int W, int Cin, int F0,
                                     int F1, int* out) {
  const bt::DenseA rows{n_img * H * W};
  const bt::StridedA xs = bt::strided_rows(n_img, H, W);
  cudaError_t e;
  if ((e = bt::sepconv_gemm_report<bt::DenseA>(bt::sg_plan(rows, F0),
                                                      out)) != cudaSuccess ||
      (e = bt::sepconv_gemm_report<bt::DenseA>(
           bt::sg_plan(rows, F1), out + bt::SG_REPORT)) != cudaSuccess)
    return (int)e;
  return (int)bt::sepconv_gemm_report<bt::StridedA>(
      bt::sg_plan(xs, F1), out + 2 * bt::SG_REPORT);
}
