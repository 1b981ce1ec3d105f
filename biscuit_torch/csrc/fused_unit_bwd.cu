// Backward of one separable-conv + train-mode BatchNorm unit:
//
//   forward   r = relu(a) (or a), d = dw3x3_SAME(r), p = pw1x1(d),
//             y = BN_train(p)
//   backward  gp   = A*g - B - xh*C          (xh = p*inv - mu*inv)
//             gd   = bf16(gp) . Wpw^T        (f32)
//             dWpw = d^T . bf16(gp)
//             gr   = dw3x3_SAME(gd, flipped taps)
//             dWdw[u,v] = sum r[i+u-1, j+v-1] * gd[i, j]
//             da   = gr * (r > 0)            (gr when there is no relu)
//   with A = gamma*inv, B = A*sum(g)/m, C = A*sum(g*xh)/m, and
//   dgamma = sum(g*xh), dbeta = sum(g) over the m = N*H*W pixels.
//
// Replaces the TPU kernels biscuit_tpu/ops/fused_unit_bwd.py
// `_unit_bwd_kernel` (whole plane, via `unit_bwd_pallas`) and
// `_unit_bwd_strip_kernel` (H strips with halo rows, via
// `unit_bwd_pallas_strips`). Their numerics are kept: gd stays f32 into
// the depthwise taps, both weight gradients accumulate in f32.
//
// What bounds it on the H100: bytes. The least traffic is one read of gy,
// p, r, d and one write of da (2*CO + 3*CI bf16 per pixel) plus the BN
// sums' read of gy and p; the two GEMMs are 4*CI*CO operations per pixel
// at 989 TFLOP/s, below the bytes at every Xception geometry.
//
// Design. The TPU kernels stream whole planes (or strips) through VMEM
// and do everything in one pass. 227 KB of shared memory holds neither a
// plane nor a strip at 147x147x128, and Hopper's blocks run in parallel
// and in no order, so the work is split into passes over HBM, each simple
// and each with a fixed order of summation (deterministic, no atomics):
//   1. BN sums: per-block column sums of g and g*p, then a fixed-order
//      reduction and a per-channel finalize (A, B, C, dgamma, dbeta);
//   2. gp pass: bf16(gp) written once (M x CO);
//   3. dgrad GEMM gd = gp . Wpw^T on mma.sync tensor cores (common.cuh's
//      main loop), gd written in f32 (M x CI);
//   4. wgrad GEMM dWpw = d^T . gp, the pixel dimension split over blocks
//      (split-K), per-split partials summed in a fixed order;
//   5. depthwise backward: a thread owns two channels of one image
//      column and walks down its rows with rolling 3x3 windows of gd and
//      r, writing da and accumulating dWdw; per-block partials summed in
//      a fixed order.
// The two entry points differ in how pass 5 cuts the plane.
// `unit_bwd_plane_launch` gives each block all H rows of a tile of wt
// columns (no halo rows); `unit_bwd_strips_launch` gives each block a
// strip of hs rows across the width, reading the strip's two halo rows
// of gd and r from HBM. Out-of-image rows and columns contribute exact
// zeros (bounds checks, never padded reads), and a ragged last strip or
// tile stops at the image's edge.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ reductions
// out[l] = sum_p part[p * L + l], p in a fixed order: threadIdx.y sums a
// contiguous range of p, the 8 ranges are added in order.
constexpr int RED_Y = 8;

__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int P,
                                       size_t L) {
  __shared__ float red[RED_Y][32];
  const size_t l = (size_t)blockIdx.x * 32 + threadIdx.x;
  const int chunk = (P + RED_Y - 1) / RED_Y;
  const int p0 = threadIdx.y * chunk, p1 = min(P, p0 + chunk);
  float s = 0.f;
  if (l < L)
    for (int p = p0; p < p1; ++p) s += part[(size_t)p * L + l];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && l < L) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < RED_Y; ++i) t += red[i][threadIdx.x];
    out[l] = t;
  }
}

cudaError_t reduce_partials(const float* part, float* out, int P, size_t L,
                            cudaStream_t s) {
  reduce_partials_kernel<<<(unsigned)((L + 31) / 32), dim3(32, RED_Y), 0,
                           s>>>(part, out, P, L);
  return cudaGetLastError();
}

__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}

// ------------------------------------------------------------- 1. BN sums
// Block (32, 8): threadIdx.x owns channels c..c+3, threadIdx.y strides the
// block's rows. part[blockIdx.y][0][c] = sum g, [1][c] = sum g*p.
__global__ void bn_sums_kernel(const bf16* __restrict__ gy,
                               const bf16* __restrict__ p,
                               float* __restrict__ part, int M, int CO,
                               int rows) {
  __shared__ float red[8][32][8];
  const int c = (blockIdx.x * 32 + threadIdx.x) * 4;
  const int m0 = blockIdx.y * rows, m1 = min(M, m0 + rows);
  float sg[4] = {0.f, 0.f, 0.f, 0.f}, sgp[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < CO) {
    for (int m = m0 + threadIdx.y; m < m1; m += 8) {
      float g[4], pv[4];
      load4(gy + (size_t)m * CO + c, g);
      load4(p + (size_t)m * CO + c, pv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sg[j] += g[j];
        sgp[j] += g[j] * pv[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[threadIdx.y][threadIdx.x][j] = sg[j];
    red[threadIdx.y][threadIdx.x][4 + j] = sgp[j];
  }
  __syncthreads();
  if (threadIdx.y == 0 && c < CO) {
    float t[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j] += red[i][threadIdx.x][j];
    float* out = part + (size_t)blockIdx.y * 2 * CO;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[c + j] = t[j];
      out[CO + c + j] = t[4 + j];
    }
  }
}

// vec rows: A = gamma*inv, B = A*sum(g)/m, C = A*sum(g*xh)/m, inv, mu*inv.
__global__ void bn_finalize_kernel(const float* __restrict__ sums,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ mu,
                                   const float* __restrict__ var, float eps,
                                   float m, int CO, float* __restrict__ vec,
                                   float* __restrict__ dgamma,
                                   float* __restrict__ dbeta) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= CO) return;
  const float inv = 1.f / sqrtf(var[c] + eps);
  const float sum_g = sums[c], sum_gp = sums[CO + c];
  const float sum_gx = (sum_gp - mu[c] * sum_g) * inv;
  const float a = gamma[c] * inv;
  vec[c] = a;
  vec[CO + c] = a * (sum_g / m);
  vec[2 * CO + c] = a * (sum_gx / m);
  vec[3 * CO + c] = inv;
  vec[4 * CO + c] = mu[c] * inv;
  dgamma[c] = sum_gx;
  dbeta[c] = sum_g;
}

// ----------------------------------------------------------- 2. gp pass
// Block (bx, by): threadIdx.x owns eight channels (CO % 8 == 0), whose
// five BN coefficients it keeps in registers; threadIdx.y strides the
// block's `rows` pixel rows.
constexpr int GP_THREADS = 256;

__global__ void __launch_bounds__(GP_THREADS)
    gp_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ p,
              const float* __restrict__ vec, bf16* __restrict__ gpb, int M,
              int CO, int rows) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (c >= CO) return;
  float k[5][8];
#pragma unroll
  for (int r = 0; r < 5; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) k[r][j] = vec[r * CO + c + j];
  const int m1 = min(M, (int)(blockIdx.y + 1) * rows);
  for (int m = blockIdx.y * rows + threadIdx.y; m < m1; m += blockDim.y) {
    const size_t o = (size_t)m * CO + c;
    const uint4 ug = *reinterpret_cast<const uint4*>(gy + o);
    const uint4 up = *reinterpret_cast<const uint4*>(p + o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&ug);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&up);
    uint4 uo;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&uo);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 g = __bfloat1622float2(g2[j]);
      const float2 pf = __bfloat1622float2(p2[j]);
      const int a = 2 * j, b = 2 * j + 1;
      const float xa = pf.x * k[3][a] - k[4][a];
      const float xb = pf.y * k[3][b] - k[4][b];
      o2[j] = __floats2bfloat162_rn(g.x * k[0][a] - k[1][a] - xa * k[2][a],
                                    g.y * k[0][b] - k[1][b] - xb * k[2][b]);
    }
    *reinterpret_cast<uint4*>(gpb + o) = uo;
  }
}

// ------------------------------------------------------ 3. dgrad GEMM
// gd (M x CI, f32) = gpb (M x CO) . wpwt (CO x CI). Block b covers column
// block b % ncol and row block b / ncol: the blocks that share a row
// block of gpb run together and read it from L2.
constexpr int DG_BM = 128;

__global__ void __launch_bounds__(bt::GEMM_THREADS)
    dgrad_kernel(const bf16* __restrict__ gpb, const bf16* __restrict__ wpwt,
                 float* __restrict__ gd, int M, int CI, int CO, int ncol) {
  extern __shared__ unsigned char smem_raw[];
  auto& s = bt::gemm_smem<DG_BM>(smem_raw);
  bt::Acc<DG_BM> acc;
  const int n0 = (blockIdx.x % ncol) * bt::GEMM_BN;
  const int m0 = (blockIdx.x / ncol) * DG_BM;
  bt::gemm_mainloop<DG_BM>(s, acc, gpb, CO, wpwt, CI, M, CI, CO, m0, n0);
  bt::for_each_acc<DG_BM>(
      acc, m0, n0, [&](int, int, int, int row, int col, float v0, float v1) {
        if (row < M && col < CI)
          *reinterpret_cast<float2*>(gd + (size_t)row * CI + col) =
              make_float2(v0, v1);
      });
}

// ------------------------------------------------------ 4. wgrad GEMM
// part[s] (CI x CO) = d[k0:k1]^T . gpb[k0:k1] over the split's pixel rows.
// Both operands are stored with the pixel (contraction) index as the row,
// so A = d^T is staged k-major and read with ldmatrix.trans.
constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64, WG_STAGES = 3;
constexpr int WG_LD = WG_BM + 8;

struct WgSmem {
  bf16 a[WG_STAGES][WG_BK][WG_LD];
  bf16 b[WG_STAGES][WG_BK][WG_LD];
};

__device__ __forceinline__ void wg_load_tile(WgSmem& s, int st,
                                             const bf16* __restrict__ d,
                                             const bf16* __restrict__ gpb,
                                             int CI, int CO, int k_end,
                                             int i0, int j0, int k0) {
  constexpr int CH = WG_BM / 8;   // 16-byte chunks per staged row
  for (int t = threadIdx.x; t < WG_BK * CH; t += bt::GEMM_THREADS) {
    const int r = t / CH, c = (t % CH) * 8;
    const int gk = k0 + r;
    const int gi = i0 + c, gj = j0 + c;
    const bool oka = gk < k_end && gi < CI;
    const bool okb = gk < k_end && gj < CO;
    bt::cp_async16(&s.a[st][r][c], oka ? d + (size_t)gk * CI + gi : d,
                   oka ? 16 : 0);
    bt::cp_async16(&s.b[st][r][c], okb ? gpb + (size_t)gk * CO + gj : gpb,
                   okb ? 16 : 0);
  }
}

__global__ void __launch_bounds__(bt::GEMM_THREADS)
    wgrad_kernel(const bf16* __restrict__ d, const bf16* __restrict__ gpb,
                 float* __restrict__ part, int M, int CI, int CO, int chunk,
                 int ti, int tj) {
  extern __shared__ unsigned char smem_raw[];
  WgSmem& s = *reinterpret_cast<WgSmem*>(smem_raw);
  const int tile = blockIdx.x % (ti * tj), split = blockIdx.x / (ti * tj);
  const int i0 = (tile / tj) * WG_BM, j0 = (tile % tj) * WG_BN;
  const int k_begin = split * chunk, k_end = min(M, k_begin + chunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  constexpr int MT = 4, NT = 4;   // warp tile 64 x 32
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[i][j][f] = 0.f;

  const int nk = (k_end - k_begin + WG_BK - 1) / WG_BK;
#pragma unroll
  for (int t = 0; t < WG_STAGES - 1; ++t) {
    if (t < nk)
      wg_load_tile(s, t, d, gpb, CI, CO, k_end, i0, j0, k_begin + t * WG_BK);
    bt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % WG_STAGES;
    bt::cp_async_wait<WG_STAGES - 2>();
    __syncthreads();
    const int next = kt + WG_STAGES - 1;
    if (next < nk)
      wg_load_tile(s, next % WG_STAGES, d, gpb, CI, CO, k_end, i0, j0,
                   k_begin + next * WG_BK);
    bt::cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < WG_BK; kk += 16) {
      // A fragment (rows i, cols k) from the k-major stage: matrices
      // (i 0-7, k 0-7), (i 8-15, k 0-7), (i 0-7, k 8-15), (i 8-15, k 8-15).
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int k = kk + (lane & 7) + (lane >> 4) * 8;
        const int c = wm * 64 + i * 16 + ((lane >> 3) & 1) * 8;
        bt::ldmatrix_x4_trans(af[i], &s.a[st][k][c]);
      }
      uint32_t bfr[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wn * 32 + j * 16 + (lane >> 4) * 8;
        bt::ldmatrix_x4_trans(bfr[j], &s.b[st][k][c]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          bt::mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                       bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  bt::cp_async_wait<0>();

  float* out = part + (size_t)split * CI * CO;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j0 + wn * 32 + j * 8 + 2 * t4;
      if (col >= CO) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i0 + wm * 64 + i * 16 + g + h * 8;
        if (row < CI)
          *reinterpret_cast<float2*>(out + (size_t)row * CO + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// ---------------------------------------------- 5. depthwise backward
// Block (bx, by), bx * by <= 256: threadIdx.x owns channels c, c+1,
// threadIdx.y strides the block's columns; blockIdx.y is the image, and
// blockIdx.z = strip * tiles + tile picks the rows [strip*hs, +hs) and
// the columns [tile*wt, +wt), each cut at the image's edge. Each thread
// walks its columns top to bottom with rolling windows of gd (f32) and r
// (packed bf16) over rows h-1..h+1 and columns w-1..w+1, so every value
// is loaded three times, not nine. Two channels a thread keep it under
// 85 registers, for three blocks per SM. The block's dWdw sums are added
// over threadIdx.y in order and written as one partial per (image,
// strip, column tile).
constexpr int DW_THREADS = 256;

__global__ void __launch_bounds__(DW_THREADS, 3)
    dw_bwd_kernel(const float* __restrict__ gd, const bf16* __restrict__ r,
                  const float* __restrict__ wflip, bf16* __restrict__ da,
                  float* __restrict__ part, int H, int W, int CI, int hs,
                  int wt, int relu_first) {
  __shared__ float2 red[DW_THREADS * 9];
  const int bx = blockDim.x, by = blockDim.y;
  const int c = (blockIdx.x * bx + threadIdx.x) * 2;
  const int n = blockIdx.y;
  const int tiles = (W + wt - 1) / wt;
  const int h0 = (blockIdx.z / tiles) * hs, h1 = min(H, h0 + hs);
  const int w0 = (blockIdx.z % tiles) * wt, w1 = min(W, w0 + wt);
  const float2 zero = make_float2(0.f, 0.f);
  const __nv_bfloat162 zero_r = __floats2bfloat162_rn(0.f, 0.f);
  float2 acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = zero;

  if (c < CI) {
    float2 tap[9];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      tap[t] = *reinterpret_cast<const float2*>(wflip + t * CI + c);
    const size_t img = (size_t)n * H;
    for (int w = w0 + threadIdx.y; w < w1; w += by) {
      // Row hh of gd and r at columns w-1, w, w+1; zeros outside.
      auto load_row = [&](int hh, float2 g[3], __nv_bfloat162 rr[3]) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int ww = w + dx - 1;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
            const size_t o = ((img + hh) * W + ww) * CI + c;
            g[dx] = *reinterpret_cast<const float2*>(gd + o);
            rr[dx] = *reinterpret_cast<const __nv_bfloat162*>(r + o);
          } else {
            g[dx] = zero;
            rr[dx] = zero_r;
          }
        }
      };
      float2 g[3][3];
      __nv_bfloat162 rw[3][3];
      load_row(h0 - 1, g[0], rw[0]);
      load_row(h0, g[1], rw[1]);
      for (int h = h0; h < h1; ++h) {
        load_row(h + 1, g[2], rw[2]);
        float2 gr = zero;
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            gr.x += g[u][v].x * tap[u * 3 + v].x;
            gr.y += g[u][v].y * tap[u * 3 + v].y;
          }
        const float2 gc = g[1][1];
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const float2 x = __bfloat1622float2(rw[u][v]);
            acc[u * 3 + v].x += x.x * gc.x;
            acc[u * 3 + v].y += x.y * gc.y;
          }
        if (relu_first) {
          const float2 rc = __bfloat1622float2(rw[1][1]);
          gr.x = rc.x > 0.f ? gr.x : 0.f;
          gr.y = rc.y > 0.f ? gr.y : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(da + ((img + h) * W + w) * CI +
                                           c) =
            __floats2bfloat162_rn(gr.x, gr.y);
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          g[0][v] = g[1][v];
          g[1][v] = g[2][v];
          rw[0][v] = rw[1][v];
          rw[1][v] = rw[2][v];
        }
      }
    }
  }
  const int tid = threadIdx.y * bx + threadIdx.x;
#pragma unroll
  for (int t = 0; t < 9; ++t) red[tid * 9 + t] = acc[t];
  __syncthreads();
  if (threadIdx.y == 0 && c < CI) {
    float* out = part + ((size_t)n * gridDim.z + blockIdx.z) * 9 * CI;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      float2 sum = zero;
      for (int y = 0; y < by; ++y) {
        const float2 v = red[(y * bx + threadIdx.x) * 9 + t];
        sum.x += v.x;
        sum.y += v.y;
      }
      *reinterpret_cast<float2*>(out + t * CI + c) = sum;
    }
  }
}

// ------------------------------------------------------------ the passes
struct Args {
  const bf16 *gy, *p, *r, *d;
  const float *wflip;          // (9, CI) flipped taps
  const bf16* wpwt;            // (CO, CI)
  const float *gamma, *mu, *var;
  float eps;
  bf16* da;                    // (N, H, W, CI)
  float *dwdw, *dwpw, *dgamma, *dbeta;   // (9, CI), (CI, CO), (CO,), (CO,)
  float *bn_part, *sums, *vec;           // (P_bn, 2, CO), (2, CO), (5, CO)
  bf16* gpb;                             // (M, CO)
  float *gd, *wg_part, *dw_part;         // (M, CI), (S_w, CI, CO), (N*S, 9, CI)
  int N, H, W, CI, CO, relu_first;
  int bn_rows, wg_chunk;
};

int run(const Args& a, int hs, int wt, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int M = a.N * a.H * a.W;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;

  // 1. BN sums.
  const int p_bn = (M + a.bn_rows - 1) / a.bn_rows;
  bn_sums_kernel<<<dim3((a.CO / 4 + 31) / 32, p_bn), dim3(32, 8), 0, s>>>(
      a.gy, a.p, a.bn_part, M, a.CO, a.bn_rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = reduce_partials(a.bn_part, a.sums, p_bn, (size_t)2 * a.CO, s)) !=
      cudaSuccess)
    return (int)e;
  bn_finalize_kernel<<<(a.CO + 127) / 128, 128, 0, s>>>(
      a.sums, a.gamma, a.mu, a.var, a.eps, (float)M, a.CO, a.vec, a.dgamma,
      a.dbeta);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 2. bf16(gp).
  // Eight rows per thread, more where the grid would pass 65535 rows.
  const int gx = min(32, a.CO / 8), gyy = GP_THREADS / gx;
  const int gp_rows = gyy * max(8, (M + 65535 * gyy - 1) / (65535 * gyy));
  const dim3 gp_grid((a.CO / 8 + gx - 1) / gx, (M + gp_rows - 1) / gp_rows);
  gp_kernel<<<gp_grid, dim3(gx, gyy), 0, s>>>(a.gy, a.p, a.vec, a.gpb, M,
                                              a.CO, gp_rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 3. dgrad.
  if ((e = bt::set_gemm_smem<DG_BM>(dgrad_kernel)) != cudaSuccess)
    return (int)e;
  const int ncol = (a.CI + bt::GEMM_BN - 1) / bt::GEMM_BN;
  const size_t dg_blocks = (size_t)ncol * ((M + DG_BM - 1) / DG_BM);
  dgrad_kernel<<<(unsigned)dg_blocks, bt::GEMM_THREADS,
                 sizeof(bt::GemmSmem<DG_BM>), s>>>(a.gpb, a.wpwt, a.gd, M,
                                                   a.CI, a.CO, ncol);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 4. wgrad, split over the pixel rows.
  if ((e = cudaFuncSetAttribute(wgrad_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sizeof(WgSmem))) != cudaSuccess)
    return (int)e;
  const int ti = (a.CI + WG_BM - 1) / WG_BM, tj = (a.CO + WG_BN - 1) / WG_BN;
  const int splits = (M + a.wg_chunk - 1) / a.wg_chunk;
  wgrad_kernel<<<(unsigned)(ti * tj * splits), bt::GEMM_THREADS,
                 sizeof(WgSmem), s>>>(a.d, a.gpb, a.wg_part, M, a.CI, a.CO,
                                      a.wg_chunk, ti, tj);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = reduce_partials(a.wg_part, a.dwpw, splits,
                           (size_t)a.CI * a.CO, s)) != cudaSuccess)
    return (int)e;

  // 5. depthwise backward, da and dWdw.
  const int tiles = ((a.H + hs - 1) / hs) * ((a.W + wt - 1) / wt);
  const int bx = min(32, a.CI / 2), by = min(DW_THREADS / bx, wt);
  const dim3 grid((a.CI / 2 + bx - 1) / bx, a.N, tiles);
  dw_bwd_kernel<<<grid, dim3(bx, by), 0, s>>>(a.gd, a.r, a.wflip, a.da,
                                              a.dw_part, a.H, a.W, a.CI, hs,
                                              wt, a.relu_first);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)reduce_partials(a.dw_part, a.dwdw, a.N * tiles,
                              (size_t)9 * a.CI, s);
}

Args make_args(const void* gy, const void* p, const void* r, const void* d,
               const void* wflip, const void* wpwt, const void* gamma,
               const void* mu, const void* var, float eps, void* da,
               void* dwdw, void* dwpw, void* dgamma, void* dbeta,
               void* bn_part, void* sums, void* vec, void* gpb, void* gd,
               void* wg_part, void* dw_part, int N, int H, int W, int CI,
               int CO, int relu_first, int bn_rows, int wg_chunk) {
  return Args{(const bf16*)gy,     (const bf16*)p,     (const bf16*)r,
              (const bf16*)d,      (const float*)wflip, (const bf16*)wpwt,
              (const float*)gamma, (const float*)mu,   (const float*)var,
              eps,                 (bf16*)da,          (float*)dwdw,
              (float*)dwpw,        (float*)dgamma,     (float*)dbeta,
              (float*)bn_part,     (float*)sums,       (float*)vec,
              (bf16*)gpb,          (float*)gd,         (float*)wg_part,
              (float*)dw_part,     N,                  H,
              W,                   CI,                 CO,
              relu_first,          bn_rows,            wg_chunk};
}

}  // namespace

// gy, p: (N, H, W, CO) bf16; r, d: (N, H, W, CI) bf16; wflip (9, CI) f32;
// wpwt (CO, CI) bf16; gamma, mu, var (CO,) f32. Outputs da (N, H, W, CI)
// bf16, dwdw (9, CI), dwpw (CI, CO), dgamma, dbeta (CO,) f32. Scratch
// sizes as in biscuit_torch/ops/fused_unit_bwd.py `_scratch`. CI, CO % 8.
#define UNIT_BWD_PARAMS                                                     \
  const void *gy, const void *p, const void *r, const void *d,              \
      const void *wflip, const void *wpwt, const void *gamma,               \
      const void *mu, const void *var, float eps, void *da, void *dwdw,     \
      void *dwpw, void *dgamma, void *dbeta, void *bn_part, void *sums,     \
      void *vec, void *gpb, void *gd, void *wg_part, void *dw_part, int N,  \
      int H, int W, int CI, int CO, int relu_first, int bn_rows,            \
      int wg_chunk
#define UNIT_BWD_ARGS                                                       \
  make_args(gy, p, r, d, wflip, wpwt, gamma, mu, var, eps, da, dwdw, dwpw,  \
            dgamma, dbeta, bn_part, sums, vec, gpb, gd, wg_part, dw_part, N, \
            H, W, CI, CO, relu_first, bn_rows, wg_chunk)

// Whole planes: each depthwise-backward block walks all H rows of a tile
// of wt columns, with no halo rows.
extern "C" int unit_bwd_plane_launch(UNIT_BWD_PARAMS, int wt, int device,
                                     void* stream) {
  if (wt < 1) return (int)cudaErrorInvalidValue;
  return run(UNIT_BWD_ARGS, H, wt, device, stream);
}

// Strips of hs rows across the whole width, each with its two halo rows
// read from HBM.
extern "C" int unit_bwd_strips_launch(UNIT_BWD_PARAMS, int hs, int device,
                                      void* stream) {
  if (hs < 1) return (int)cudaErrorInvalidValue;
  return run(UNIT_BWD_ARGS, hs, W, device, stream);
}
