// Standalone depthwise 3x3, stride 1, SAME, NHWC, in bf16 or f32 (the
// output in the input's type), nine f32 taps with edge masks.
//
// Replaces the TPU kernel biscuit_tpu/ops/depthwise_pallas.py `_dw_kernel`
// (called through `_dw_call`, `_dw_forward` and the custom-VJP
// `depthwise_conv3x3`, whose input gradient is this same kernel with the
// taps flipped in space).
//
// What bounds it on the H100: bytes. It reads each input once and writes
// each output once (4 bytes an element in bf16, 8 in f32) against 18 f32
// operations an element: at 147 x 147 x 128 and N = 256 that is 2.83 GB,
// 0.85 ms at 3.35 TB/s, against 0.19 ms of f32 arithmetic at 67 TFLOP/s.
//
// Design: the TPU kernel rolls a whole (NB, H*W, C) block held in VMEM
// and masks the wrapped edges. Here a thread owns four channels of one
// image column and walks down it two rows a step with a rolling window
// (depthwise.cuh), so each input comes from memory or cache 3 times, not
// 9, from neighbouring threads in contiguous 8- or 16-byte loads, with six
// loads in flight a step; edges are bounds checks that contribute exact
// zeros. One pass, no scratch. It reaches about 2 TB/s (PERF.md); holding
// more loads in flight without more registers is the open step.
#include "depthwise.cuh"

// x, out: (N, H, W, C), bf16 when is_f32 == 0, else f32. taps: (9, C) f32
// in (dy, dx) row-major order. Four channels a thread when C % 4 == 0,
// else one. Every pointer 16-byte aligned.
extern "C" int depthwise3x3_launch(const void* x, const void* taps, void* out,
                                   int n_img, int H, int W, int C, int is_f32,
                                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)taps;
  const bool v4 = C % 4 == 0;
  if (is_f32) {
    const float* xi = (const float*)x;
    float* o = (float*)out;
    e = v4 ? bt::depthwise3x3<float, float, false, 4>(xi, t, o, n_img, H, W,
                                                      C, s)
           : bt::depthwise3x3<float, float, false, 1>(xi, t, o, n_img, H, W,
                                                      C, s);
  } else {
    const __nv_bfloat16* xi = (const __nv_bfloat16*)x;
    __nv_bfloat16* o = (__nv_bfloat16*)out;
    e = v4 ? bt::depthwise3x3<__nv_bfloat16, __nv_bfloat16, false, 4>(
                 xi, t, o, n_img, H, W, C, s)
           : bt::depthwise3x3<__nv_bfloat16, __nv_bfloat16, false, 1>(
                 xi, t, o, n_img, H, W, C, s);
  }
  return (int)e;
}
