// Depthwise 3x3, stride 1, SAME, on NHWC activations: the pass shared by
// fused_block.cu (both of a strided block's depthwise convs) and
// depthwise3x3.cu (the standalone op and its input gradient).
//
//   out[n, h, w, c] = sum_{dy, dx} in[n, h+dy-1, w+dx-1, c] * taps[dy*3+dx][c]
//
// with zeros outside the image (never a padded copy), the nine taps in
// (dy, dx) row-major order, each product and each sum rounded on its own
// in f32 (__fmul_rn, __fadd_rn: no fused multiply-add), so the kernel and
// its plain PyTorch version agree to the last bit of the f32 sum. RELU
// applies relu to the input as it is read.
//
// What bounds it: bytes (each input read once, each output written once),
// with the 18 separately rounded f32 instructions an element close behind
// (0.43 ms of issue at 147^2 x 128 x 256 on 132 SMs, against 0.85 ms of
// HBM traffic in bf16).
//
// Design (C % 8 == 0, C <= 1024): rows staged in shared memory by the
// copy engine. It replaces a pass in which each thread walked one image
// column with a window in registers and read its three neighbour columns
// from L1: 92-98 registers, 2 blocks an SM, and only six 8-byte loads in
// flight a thread held it near 2 TB/s. Here a block owns up to 32 output
// columns of one or more images (all C channels, 4 a thread) and walks
// down H two rows a step. One producer thread fills a ring of 8 row pairs
// in shared memory, each row of the block's columns plus one halo column
// each side one contiguous bulk copy (cp.async.bulk, completing on an
// mbarrier), so the loads in flight cost no registers and each input
// crosses HBM once. The consumers wait on the pair's barrier, read their
// 3 x 2 new inputs from shared memory, compute two output rows from a
// 4-row window whose halves swap roles from one step to the next (no
// register moves), and release the slot; no block-wide barrier is taken
// in the loop. A thread keeps the taps of rows dy = 0 and 1 in registers
// and reads those of dy = 2 from shared memory once a step for both rows:
// all 36 in registers spill or cost the second block an SM, and all in
// shared memory cost more reads (PERF.md). Halo columns outside the image
// are zeros written once; rows outside it are never copied, the consumers
// take zeros for them. A block of a small image walks several images, so
// its ring stays full.
// Other C take the narrow path: one thread per (image, column, channel),
// walking down its column with a window in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace bt {

constexpr int DW_CONSUMERS = 256;   // at most, computing threads a block
constexpr int DW_THREADS = DW_CONSUMERS + 32;   // and one producer warp
constexpr int DW_PAIRS = 8;         // input row pairs in shared memory
constexpr int DW_COLS = 32;         // at most, output columns a block
constexpr int DW_MAX_C = 4 * DW_CONSUMERS;   // widest C of the staged pass
constexpr int DW_NARROW_BLOCK = 256;

__device__ __forceinline__ void dw_load4(const float* p, float v[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

__device__ __forceinline__ void dw_load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void dw_store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void dw_store4(__nv_bfloat16* p, const float v[4]) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dw_to_f32(float v) { return v; }
__device__ __forceinline__ float dw_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void dw_put(float* p, float v) { *p = v; }
__device__ __forceinline__ void dw_put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Launch geometry of the staged pass: W cut into nr ranges of wb output
// columns, all C channels a block (cg = C / 4 threads a column), and ipb
// images walked one after another by each block, so that a block of a
// small image still has enough rows to keep its ring full.
struct DwGeometry {
  int wb, nr, cg, consumers, ipb;
  unsigned blocks, threads;
  size_t row_bytes, smem;
  DwGeometry(int n_img, int H, int W, int C, size_t in_bytes) {
    cg = C / 4;
    wb = DW_CONSUMERS / cg;
    if (wb > DW_COLS) wb = DW_COLS;
    nr = (W + wb - 1) / wb;
    wb = (W + nr - 1) / nr;
    consumers = cg * wb;
    threads = (unsigned)((consumers + 31) / 32 * 32 + 32);
    // About 48 row pairs a block, while the grid keeps 4 blocks an SM.
    const int pairs = (H + 1) / 2 + 1;
    const long cap = (long)n_img * nr / (4 * 132);
    ipb = (48 + pairs - 1) / pairs;
    if (ipb > cap) ipb = (int)(cap < 1 ? 1 : cap);
    if (ipb > n_img) ipb = n_img;
    blocks = (unsigned)(((long)n_img + ipb - 1) / ipb * nr);
    row_bytes = (size_t)(wb + 2) * C * in_bytes;
    smem = 128 + 3 * C * 4 + (size_t)DW_PAIRS * 2 * row_bytes;
  }
};

template <typename Tin, typename Tout, bool RELU>
__global__ void __launch_bounds__(DW_THREADS, 2)
    dw_staged_kernel(const Tin* __restrict__ x,
                     const float* __restrict__ taps,   // (9, C)
                     Tout* __restrict__ out, int n_img, int H, int W, int C,
                     int wb, int nr, int consumers, int ipb) {
  extern __shared__ __align__(128) unsigned char dw_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(dw_smem);   // [DW_PAIRS]
  uint64_t* empty = full + DW_PAIRS;                        // [DW_PAIRS]
  float* taps_s = reinterpret_cast<float*>(dw_smem + 128);   // dy = 2
  Tin* ring = reinterpret_cast<Tin*>(dw_smem + 128 + 3 * C * 4);
  const int row_elems = (wb + 2) * C;
  const int w0 = (blockIdx.x % nr) * wb;
  const int img0 = (blockIdx.x / nr) * ipb;
  const int n_here = min(ipb, n_img - img0);
  const int pairs = (H + 1) / 2 + 1;
  const int events = n_here * pairs;
  const int tid = threadIdx.x;
  const int producer = (consumers + 31) / 32 * 32;   // first producer thread
  const size_t row_stride = (size_t)W * C;

  // Columns outside the image stay zero in every slot: the copies write
  // only the columns inside it, and rows outside it are never copied (the
  // consumers take zeros for them). The fence orders these generic-proxy
  // stores before the copy engine's writes to the same slots. A phase of
  // `full` is the producer's arrival and the bytes it copies; every
  // consumer releases a slot after reading it.
  for (int k = tid; k < 3 * C; k += blockDim.x) taps_s[k] = taps[6 * C + k];
  uint4* ring16 = reinterpret_cast<uint4*>(ring);
  for (int k = tid; k < DW_PAIRS * 2 * row_elems * (int)sizeof(Tin) / 16;
       k += blockDim.x)
    ring16[k] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int st = 0; st < DW_PAIRS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= producer) {
    // Event e: image img0 + i, input rows 2j - 1 and 2j (those inside the
    // image) into slot e % DW_PAIRS, by one thread.
    if (tid > producer) return;
    const int cs = max(w0 - 1, 0), ce = min(w0 + wb, W - 1);
    const uint32_t copy_bytes = (uint32_t)((ce - cs + 1) * C * sizeof(Tin));
    const int dst_off = (cs - (w0 - 1)) * C;
    int i = 0, j = 0;
    for (int e = 0; e < events; ++e) {
      const int st = e % DW_PAIRS;
      mbar_wait(&empty[st], ((e / DW_PAIRS) & 1) ^ 1);
      Tin* slot = ring + st * 2 * row_elems;
      const bool in0 = 2 * j - 1 >= 0 && 2 * j - 1 < H, in1 = 2 * j < H;
      mbar_arrive_expect_tx(&full[st], (in0 + in1) * copy_bytes);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int hh = 2 * j - 1 + r;
        if (r == 0 ? in0 : in1)
          bulk_copy_g2s(slot + r * row_elems + dst_off,
                        x + ((size_t)(img0 + i) * H + hh) * row_stride +
                            (size_t)cs * C,
                        copy_bytes, &full[st]);
      }
      if (++j == pairs) {
        j = 0;
        ++i;
      }
    }
    return;
  }
  if (tid >= consumers) return;

  const int cg = C / 4;
  const int grp = tid % cg, wl = tid / cg;
  const int c = grp * 4, w = w0 + wl;
  const bool active = w < W;
  const int my_off = wl * C + c;
  float t0[6][4];   // the taps of rows dy = 0 and 1
#pragma unroll
  for (int k = 0; k < 6; ++k) dw_load4(taps + k * C + c, t0[k]);

  // Input rows of the slot into cur (relu'd if RELU), then output rows
  // 2j - 2 and 2j - 1 from prev (rows 2j - 3, 2j - 2) and cur.
  int i = 0, j = 0;
  auto event = [&](int e, float (&prev)[2][3][4], float (&cur)[2][3][4]) {
    const int st = e % DW_PAIRS;
    mbar_wait(&full[st], (e / DW_PAIRS) & 1);
    const Tin* slot = ring + st * 2 * row_elems + my_off;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hh = 2 * j - 1 + r;
      const bool inside = hh >= 0 && hh < H;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (inside) {
          dw_load4(slot + r * row_elems + dx * C, cur[r][dx]);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) cur[r][dx][v] = 0.f;
        }
        if (RELU) {
#pragma unroll
          for (int v = 0; v < 4; ++v) cur[r][dx][v] = fmaxf(cur[r][dx][v], 0.f);
        }
      }
    }
    if (j > 0) {
      const int h = 2 * j - 2;
      Tout* o = out + (((size_t)(img0 + i) * H + h) * W + w) * C + c;
      // Window row rr (0, 1 from prev; 2, 3 from cur), all indices
      // compile-time constants once unrolled.
      auto in = [&](int rr, int dx, int v) {
        return rr < 2 ? prev[rr][dx][v] : cur[rr - 2][dx][v];
      };
      float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float tv[4];
          if (dy < 2) {
#pragma unroll
            for (int v = 0; v < 4; ++v) tv[v] = t0[dy * 3 + dx][v];
          } else {
            dw_load4(taps_s + dx * C + c, tv);
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc0[v] = __fadd_rn(acc0[v], __fmul_rn(in(dy, dx, v), tv[v]));
            acc1[v] = __fadd_rn(acc1[v], __fmul_rn(in(1 + dy, dx, v), tv[v]));
          }
        }
      if (active) dw_store4(o, acc0);
      if (active && h + 1 < H) dw_store4(o + row_stride, acc1);
    }
    // The inputs are in registers and used; the fence orders these
    // generic-proxy reads before the copy engine refills the slot.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&empty[st]);
    if (++j == pairs) {
      j = 0;
      ++i;
    }
  };
  // Two events an iteration, the window's halves swapping roles, so no
  // register moves.
  float wa[2][3][4], wb2[2][3][4];
  for (int e = 0; e < events; e += 2) {
    event(e, wa, wb2);
    if (e + 1 < events) event(e + 1, wb2, wa);
  }
}

// Narrow path: one thread per (image, column, channel), walking down the
// column with a rolling 3 x 3 window.
template <typename Tin, typename Tout, bool RELU>
__global__ void __launch_bounds__(DW_NARROW_BLOCK)
    dw_narrow_kernel(const Tin* __restrict__ x,
                     const float* __restrict__ taps,   // (9, C)
                     Tout* __restrict__ out, int n_img, int H, int W,
                     int C) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n_img * W * C) return;
  const int c = (int)(idx % C);
  const int w = (int)((idx / C) % W);
  const size_t img = idx / ((size_t)C * W);
  float t[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) t[i] = taps[i * C + c];
  auto load_row = [&](int hh, float row[3]) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ww = w + dx - 1;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        v = dw_to_f32(x[((img * H + hh) * W + ww) * C + c]);
        if (RELU) v = fmaxf(v, 0.f);
      }
      row[dx] = v;
    }
  };
  float win[3][3];
  load_row(-1, win[0]);
  load_row(0, win[1]);
  for (int h = 0; h < H; ++h) {
    load_row(h + 1, win[2]);
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = __fadd_rn(acc, __fmul_rn(win[dy][dx], t[dy * 3 + dx]));
    dw_put(out + ((img * H + h) * W + w) * C + c, acc);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      win[0][dx] = win[1][dx];
      win[1][dx] = win[2][dx];
    }
  }
}

// Launch the pass on `stream`; the caller checks 16-byte aligned x, taps
// and out.
template <typename Tin, typename Tout, bool RELU>
inline cudaError_t depthwise3x3(const Tin* x, const float* taps, Tout* out,
                                int n_img, int H, int W, int C,
                                cudaStream_t s) {
  if (n_img == 0 || H == 0 || W == 0 || C == 0) return cudaSuccess;
  if (C % 8 || C > DW_MAX_C) {
    const size_t threads = (size_t)n_img * W * C;
    dw_narrow_kernel<Tin, Tout, RELU>
        <<<(unsigned)((threads + DW_NARROW_BLOCK - 1) / DW_NARROW_BLOCK),
           DW_NARROW_BLOCK, 0, s>>>(x, taps, out, n_img, H, W, C);
    return cudaGetLastError();
  }
  const DwGeometry g(n_img, H, W, C, sizeof(Tin));
  auto* kernel = dw_staged_kernel<Tin, Tout, RELU>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (e != cudaSuccess) return e;
  kernel<<<g.blocks, g.threads, g.smem, s>>>(x, taps, out, n_img, H, W, C,
                                             g.wb, g.nr, g.consumers, g.ipb);
  return cudaGetLastError();
}

}  // namespace bt
