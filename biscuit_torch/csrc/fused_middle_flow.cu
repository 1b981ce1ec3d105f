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
// the output is written in x's dtype once, at the end: x is bf16 (the bf16
// trunk) or f32 (an f32 model's), as the TPU kernel reads x_ref in either
// and writes out_ref in x's. An f32 x changes three places, nothing else:
// unit 0's depthwise reads it as f32 (the carry's instantiation), block
// 0's residual is x itself as an f32 residual, and the last unit stores
// f32.
//
// What bounds it on the H100: tensor-core operations, if the carry stayed
// on chip. At N = 256 tiles the 24 pointwise products are 24 x 2 x
// (256*19*19) x 728 x 728 = 2.35 TFLOP, 2.4 ms at 989 TFLOP/s bf16; the
// depthwise taps add 24 x 18 x N*361*728 f32 operations (0.43 ms at 67
// TFLOP/s). The TPU kernel keeps all 24 units' weights (25 MB) resident in
// VMEM and streams images through them; 227 KB of shared memory holds
// neither the weights nor an image's 19x19x728 f32 carry (1 MB), so this
// runs unit by unit over the whole batch and the carry crosses HBM: per
// unit the depthwise reads the f32 carry (269 MB at N = 256) and writes
// the bf16 GEMM input (135 MB), and the GEMM reads that and writes the f32
// carry (269 MB), with the block's f32 residual read every third unit.
// That is 21.5 GB over 24 units, 6.4 ms at 3.35 TB/s: the floor of this
// two-pass design.
//
// Design, two launches a unit:
//  * depthwise: the shared staged pass of depthwise.cuh (relu as it is
//    read, nine taps in the TPU kernel's (dy, dx) order with separate f32
//    multiply and add roundings, bf16 store). A block walks all the
//    columns of a 19-wide image, so each input crosses HBM once. Unit 0
//    reads the bf16 input directly. Blocks that owned whole images'
//    32-channel slices, each loaded by one tensor copy, measured slower or
//    no faster, persistent and double-buffered included (PERF.md). An f32
//    x is read as the carry is.
//  * pointwise: sepconv_gemm.cuh (TMA, a producer and two consumer
//    warpgroups on wgmma, persistent, clusters of two row blocks that
//    share each B tile by multicast, staged epilogue), reading the unit's
//    weight in its (in, out) layout through one 3-D tensor map over all U
//    weights; its epilogue applies the folded BN and, every third unit,
//    the block's residual (the input for block 0, the f32 carry after),
//    writing the f32 carry, or the output after the last unit.
// Keeping the carry on chip (the depthwise as the GEMM's A-tile producer)
// is the next step (ROADMAP).
#include "depthwise.cuh"
#include "sepconv_gemm.cuh"

using bt::bf16;

// x, out: (N, H, W, C), bf16, or f32 when x_f32. dw: (U, 9, C) f32. pw:
// (U, C, C) bf16 (in, out). sc, sh: (U, C) f32. carry, tmp: N*H*W*C f32
// scratch. a: N*H*W*C bf16 scratch. U % 3 == 0, C % 8 == 0, every pointer
// 16-byte aligned.
extern "C" int fused_middle_flow_launch(
    const void* x, const void* dw, const void* pw, const void* sc,
    const void* sh, void* out, void* carry, void* tmp, void* a, int n_img,
    int H, int W, int C, int U, int x_f32, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n_img == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* xb = x_f32 ? nullptr : (const bf16*)x;
  const float* xf = x_f32 ? (const float*)x : nullptr;
  float* R = (float*)carry;   // block output, the next block's residual
  float* T = (float*)tmp;     // carry inside a block
  bf16* Ab = (bf16*)a;
  const bt::DenseA rows{n_img * H * W};
  const bt::SgPlan plan = bt::sg_plan(rows, C);
  CUtensorMap amap, bmap;
  if ((e = bt::rows_map(&amap, Ab, rows.M, C)) != cudaSuccess ||
      (e = bt::weight_map(&bmap, plan, pw, U, C, C)) != cudaSuccess)
    return (int)e;
  for (int u = 0; u < U; ++u) {
    const int j = u % 3;
    const float* taps = (const float*)dw + (size_t)u * 9 * C;
    if (u == 0 && !x_f32)
      e = bt::depthwise3x3<bf16, bf16, true>(xb, taps, Ab, n_img, H, W, C, s);
    else
      e = bt::depthwise3x3<float, bf16, true>(u == 0 ? xf : j == 0 ? R : T,
                                               taps, Ab, n_img, H, W, C, s);
    if (e != cudaSuccess) return (int)e;
    bt::BnEpilogue epi{};
    epi.sc = (const float*)sc + (size_t)u * C;
    epi.sh = (const float*)sh + (size_t)u * C;
    epi.ld = C;
    if (j == 2) {            // the block's residual: its input
      if (u == 2 && !x_f32)
        epi.res_bf16 = xb;
      else
        epi.res_f32 = u == 2 ? xf : R;
    }
    if (u == U - 1 && !x_f32)
      epi.out_bf16 = (bf16*)out;
    else
      epi.out_f32 = u == U - 1 ? (float*)out : j == 2 ? R : T;
    if ((e = bt::sepconv_gemm(plan, amap, bmap, rows, epi, C, C, u, s)) !=
        cudaSuccess)
      return (int)e;
  }
  return 0;
}

// The plan of the pointwise GEMM for n_img images of H x W x C
// (sepconv_gemm_report).
extern "C" int fused_middle_flow_gemm_plan(int n_img, int H, int W, int C,
                                           int* out) {
  const bt::DenseA rows{n_img * H * W};
  return (int)bt::sepconv_gemm_report<bt::DenseA>(
      bt::sg_plan(rows, C), out);
}
