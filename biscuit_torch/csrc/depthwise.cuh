// Depthwise 3x3, stride 1, SAME, on NHWC activations: the pass shared by
// fused_block.cu (both of a strided block's depthwise convs) and
// depthwise3x3.cu (the standalone op and its input gradient).
//
//   out[n, h, w, c] = sum_{dy, dx} in[n, h+dy-1, w+dx-1, c] * taps[dy*3+dx][c]
//
// with zeros outside the image (bounds checks, never a padded copy), the
// nine taps in (dy, dx) row-major order, each product and each sum rounded
// on its own in f32 (__fmul_rn, __fadd_rn: no fused multiply-add), so the
// kernel and its plain PyTorch version agree to the last bit of the f32
// sum. A thread owns V channels (4 when C % 4 == 0, else 1) of one image
// column and walks down it two rows at a time with a rolling 4 x 3 window,
// so each input is loaded 3 times, not 9; neighbouring threads hold
// neighbouring channels, so a warp's loads are contiguous.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bt {

constexpr int DW_BLOCK = 256;

template <int V>
__device__ __forceinline__ void dw_load(const float* p, float v[V]) {
  if constexpr (V == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void dw_load(const __nv_bfloat16* p, float v[V]) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void dw_store(float* p, const float v[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void dw_store(__nv_bfloat16* p, const float v[V]) {
  if constexpr (V == 4) {
    uint2 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// One thread per (image, column, V channels): n_img * W * (C / V) threads.
// RELU applies relu to the input as it is read.
template <typename Tin, typename Tout, bool RELU, int V>
__global__ void __launch_bounds__(DW_BLOCK)
    depthwise3x3_kernel(const Tin* __restrict__ x,
                        const float* __restrict__ taps,   // (9, C)
                        Tout* __restrict__ out, int n_img, int H, int W,
                        int C) {
  const int cv = C / V;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n_img * W * cv) return;
  const int c = (int)(idx % cv) * V;
  const int w = (int)((idx / cv) % W);
  const size_t img = idx / ((size_t)cv * W);
  float t[9][V];
#pragma unroll
  for (int i = 0; i < 9; ++i) dw_load<V>(taps + i * C + c, t[i]);
  // Row hh at columns w-1, w, w+1 (relu'd if RELU); zeros outside.
  auto load_row = [&](int hh, float row[3][V]) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ww = w + dx - 1;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        dw_load<V>(x + ((img * H + hh) * W + ww) * C + c, row[dx]);
        if (RELU) {
#pragma unroll
          for (int i = 0; i < V; ++i) row[dx][i] = fmaxf(row[dx][i], 0.f);
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) row[dx][i] = 0.f;
      }
    }
  };
  // Two output rows a step: rows h+1 and h+2 are loaded together, so six
  // loads are in flight rather than three.
  float win[4][3][V];
  load_row(-1, win[0]);
  load_row(0, win[1]);
  for (int h = 0; h < H; h += 2) {
    load_row(h + 1, win[2]);
    load_row(h + 2, win[3]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && h + 1 >= H) break;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(win[r + dy][dx][i],
                                                 t[dy * 3 + dx][i]));
      dw_store<V>(out + ((img * H + h + r) * W + w) * C + c, acc);
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        win[0][dx][i] = win[2][dx][i];
        win[1][dx][i] = win[3][dx][i];
      }
  }
}

// Launch the pass on `stream`; the caller checks C % V == 0 and 16-byte
// aligned x, taps and out.
template <typename Tin, typename Tout, bool RELU, int V>
inline cudaError_t depthwise3x3(const Tin* x, const float* taps, Tout* out,
                                int n_img, int H, int W, int C,
                                cudaStream_t s) {
  const size_t threads = (size_t)n_img * W * (C / V);
  if (threads == 0 || H == 0) return cudaSuccess;
  depthwise3x3_kernel<Tin, Tout, RELU, V>
      <<<(unsigned)((threads + DW_BLOCK - 1) / DW_BLOCK), DW_BLOCK, 0, s>>>(
          x, taps, out, n_img, H, W, C);
  return cudaGetLastError();
}

}  // namespace bt
