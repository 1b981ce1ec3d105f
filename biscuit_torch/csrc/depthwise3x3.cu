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
// 0.85 ms at 3.35 TB/s, against 0.19 ms of f32 arithmetic at 67 TFLOP/s
// (0.43 ms of instruction issue, since each multiply and add is rounded on
// its own).
//
// Design: the TPU kernel rolls a whole (NB, H*W, C) block held in VMEM
// and masks the wrapped edges. Here a block walks down one column range
// of one or more images, all channels, with a ring of input row pairs in
// shared memory that one producer thread fills by bulk copies (one
// contiguous copy a row) up to eight pairs ahead; the consumers compute
// two rows a step from a register window and never take a block-wide
// barrier (depthwise.cuh). Each input crosses HBM once and the loads in
// flight cost no registers. It replaces a pass that read each input from
// L1 three times with six loads in flight a thread (about 2 TB/s, 92-98
// registers). C not a multiple of 8 takes the narrow one-channel path.
// One launch, no scratch.
#include "depthwise.cuh"

// x, out: (N, H, W, C), bf16 when is_f32 == 0, else f32. taps: (9, C) f32
// in (dy, dx) row-major order. Every pointer 16-byte aligned.
extern "C" int depthwise3x3_launch(const void* x, const void* taps, void* out,
                                   int n_img, int H, int W, int C, int is_f32,
                                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)taps;
  if (is_f32)
    return (int)bt::depthwise3x3<float, float, false>(
        (const float*)x, t, (float*)out, n_img, H, W, C, s);
  return (int)bt::depthwise3x3<__nv_bfloat16, __nv_bfloat16, false>(
      (const __nv_bfloat16*)x, t, (__nv_bfloat16*)out, n_img, H, W, C, s);
}
