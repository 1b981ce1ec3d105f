// Train-mode BatchNorm over the M rows of channels-last data (N, H, W, C),
// as Flax computes it, in two passes each way:
//
//   forward   sums  = (sum x, sum x*x) over the rows, f32
//             mean  = sums[0] / m, var = max(0, sums[1] / m - mean^2)
//             y     = x's type of ((x - mean) * (inv * gamma)) + beta
//   backward  sums  = (sum g, sum g*xh), xh = (x - mean) * inv
//             gx    = x's type of (gamma * inv) * ((g - sums[0] / m)
//                                                  - xh * (sums[1] / m))
//   with inv = rsqrt(var + eps), m the rows of the whole batch (of every
//   rank of a lockstep group), and the divisions by m products with the f32
//   1/m; dgamma = sum g*xh and dbeta = sum g are the backward's sums.
//
// Replaces no TPU kernel: train-mode BatchNorm, left to XLA by the JAX
// package, which fuses it. Written as PyTorch ops, each step of the
// formulas would be its own f32 pass over a copy of the activation, and
// autograd would add a dozen more back.
//
// What bounds it on the H100: bytes. The least traffic is the sums' read of
// x, then a read of x and a write of y (6 bytes an element in bf16); back,
// a read of gy and x for the sums, then a read of both and a write of gx
// (10 bytes). A few operations an element against 3.35 TB/s.
//
// Design. Blocks of 256 threads, (tx, ty): threadIdx.x owns one 16-byte
// vector of channels (8 in bf16, 4 in f32), threadIdx.y strides the
// block's rows, and where C is at most 32 vectors a warp spans several
// whole rows, so that neighbouring threads read neighbouring addresses at
// every C. Each block takes a contiguous range of rows (the grid is sized
// by the wrapper, ops/bn_train.py `launch_plan`, from M, C and the SM
// count: about BLOCKS_PER_SM blocks an SM, one wave), with several loads in
// flight a thread.
//   1. bn_sums_kernel: f32 sums in registers, added over the block's rows
//      of threads in shared memory in a fixed tree, one partial a block;
//   2. bn_finalize_kernel: the partials summed in a fixed order into the
//      (2, C) sums. No atomics: two runs give the same bits;
//   3. bn_apply_kernel / bn_apply_bwd_kernel: each thread forms its
//      channels' coefficients from the sums once, then streams its rows.
// For one rank the apply entries launch 1 and 2 first, so that a way is one
// call from the host; a lockstep group calls bn_sums_launch, all-reduces
// the sums (the wrapper), then the apply entry.
// Each step of the apply passes is rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn, never an FMA), in the order of the plain version,
// so that from the same sums they give its outputs bit for bit.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 3;   // resident blocks an SM (85 registers)
constexpr int FIN_Y = 32;          // rows of threads of a finalize block

// A 16-byte vector of T to and from floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float v[4]) {
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float v[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float v[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float v[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return u;
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* base, int m, int C, int c) {
  return *reinterpret_cast<const uint4*>(base + (size_t)m * C + c);
}

template <typename T>
__device__ __forceinline__ void store16(T* base, int m, int C, int c,
                                        uint4 u) {
  *reinterpret_cast<uint4*>(base + (size_t)m * C + c) = u;
}

// inv = rsqrt(var + eps), as torch.rsqrt computes it on the card.
__device__ __forceinline__ float inv_std(float var, float eps) {
  return rsqrtf(__fadd_rn(var, eps));
}

// ------------------------------------------------------------ 1. sums
// BWD false: (sum x, sum x*x); true: (sum g, sum g*xh). U rows of loads in
// flight a thread. part[blockIdx.y][k][c]: the block's sums.
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    bn_sums_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                   const float* __restrict__ mean,
                   const float* __restrict__ var, float eps,
                   float* __restrict__ part, int M, int C, int rows) {
  constexpr int N = Vec<T>::N;
  constexpr int U = BWD ? 2 : 4;
  __shared__ float red[THREADS][2 * N + 1];
  const int tx = blockDim.x, ty = blockDim.y;
  const int c = (blockIdx.x * tx + threadIdx.x) * N;
  const int m0 = blockIdx.y * rows, m1 = min(M, m0 + rows);
  float s0[N], s1[N], mu[N], inv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s0[j] = s1[j] = mu[j] = inv[j] = 0.f;
  if (c < C) {
    if constexpr (BWD) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        mu[j] = mean[c + j];
        inv[j] = inv_std(var[c + j], eps);
      }
    }
    auto add = [&](const uint4& ua, const uint4& ub) {
      float a[N], b[N];
      Vec<T>::unpack(ua, a);
      if constexpr (BWD) {
        Vec<T>::unpack(ub, b);
#pragma unroll
        for (int j = 0; j < N; ++j)
          b[j] = __fmul_rn(__fsub_rn(b[j], mu[j]), inv[j]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) b[j] = a[j];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s0[j] += a[j];
        s1[j] += a[j] * b[j];
      }
    };
    int m = m0 + threadIdx.y;
    for (; m + (U - 1) * ty < m1; m += U * ty) {
      uint4 ua[U], ub[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ua[u] = load16(BWD ? gy : x, m + u * ty, C, c);
        if constexpr (BWD) ub[u] = load16(x, m + u * ty, C, c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) add(ua[u], ub[u]);
    }
    for (; m < m1; m += ty) {
      const uint4 ua = load16(BWD ? gy : x, m, C, c);
      add(ua, BWD ? load16(x, m, C, c) : ua);
    }
  }
  // The block's rows of threads, added in a fixed tree: rows from the
  // largest power of two P <= ty onto those below, then halving.
  const int tid = threadIdx.y * tx + threadIdx.x;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    red[tid][j] = s0[j];
    red[tid][N + j] = s1[j];
  }
  __syncthreads();
  int P = 1;
  while (2 * P <= ty) P *= 2;
  if ((int)threadIdx.y < ty - P) {
#pragma unroll
    for (int j = 0; j < 2 * N; ++j) red[tid][j] += red[tid + P * tx][j];
  }
  __syncthreads();
  for (int s = P / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.y < s) {
#pragma unroll
      for (int j = 0; j < 2 * N; ++j) red[tid][j] += red[tid + s * tx][j];
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < C) {
    float* out = part + (size_t)blockIdx.y * 2 * C;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      out[c + j] = red[threadIdx.x][j];
      out[C + c + j] = red[threadIdx.x][N + j];
    }
  }
}

// --------------------------------------------------------- 2. finalize
// Block (32, FIN_Y): threadIdx.x owns channel c, threadIdx.y sums a
// contiguous range of the P partials, and the ranges are added in order.
__global__ void __launch_bounds__(32 * FIN_Y)
    bn_finalize_kernel(const float* __restrict__ part, int P, int C,
                       float* __restrict__ sums) {
  __shared__ float red[FIN_Y][2][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int chunk = (P + FIN_Y - 1) / FIN_Y;
  const int p0 = threadIdx.y * chunk, p1 = min(P, p0 + chunk);
  float a = 0.f, b = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int q = p0; q < p1; ++q) {
      a += part[(size_t)q * 2 * C + c];
      b += part[(size_t)q * 2 * C + C + c];
    }
  }
  red[threadIdx.y][0][threadIdx.x] = a;
  red[threadIdx.y][1][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  float ta = 0.f, tb = 0.f;
#pragma unroll
  for (int i = 0; i < FIN_Y; ++i) {
    ta += red[i][0][threadIdx.x];
    tb += red[i][1][threadIdx.x];
  }
  sums[c] = ta;
  sums[C + c] = tb;
}

// -------------------------------------------------- 3. forward apply
// y = ((x - mean) * k) + beta, k = inv * gamma; the blocks of the first
// row range also write mean and var.
template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ sums,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, float inv_m, float eps,
                    T* __restrict__ y, float* __restrict__ mean_out,
                    float* __restrict__ var_out, int M, int C, int rows) {
  constexpr int N = Vec<T>::N;
  constexpr int U = 4;
  const int ty = blockDim.y;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * N;
  if (c >= C) return;
  const int m0 = blockIdx.y * rows, m1 = min(M, m0 + rows);
  const bool first = blockIdx.y == 0 && threadIdx.y == 0;
  float mu[N], k[N], sh[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float mj = __fmul_rn(sums[c + j], inv_m);
    const float d =
        __fsub_rn(__fmul_rn(sums[C + c + j], inv_m), __fmul_rn(mj, mj));
    const float vj = d < 0.f ? 0.f : d;      // NaN stays NaN, as clamp_min
    mu[j] = mj;
    k[j] = __fmul_rn(inv_std(vj, eps), gamma[c + j]);
    sh[j] = beta[c + j];
    if (first) {
      mean_out[c + j] = mj;
      var_out[c + j] = vj;
    }
  }
  auto apply = [&](int m, const uint4& u) {
    float v[N];
    Vec<T>::unpack(u, v);
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mu[j]), k[j]), sh[j]);
    store16(y, m, C, c, Vec<T>::pack(v));
  };
  int m = m0 + threadIdx.y;
  for (; m + (U - 1) * ty < m1; m += U * ty) {
    uint4 u[U];
#pragma unroll
    for (int i = 0; i < U; ++i) u[i] = load16(x, m + i * ty, C, c);
#pragma unroll
    for (int i = 0; i < U; ++i) apply(m + i * ty, u[i]);
  }
  for (; m < m1; m += ty) apply(m, load16(x, m, C, c));
}

// ------------------------------------------------- 3. backward apply
// gx = a * ((g - bm) - xh * cm), a = gamma * inv, bm = sums[0] / m,
// cm = sums[1] / m, xh = (x - mean) * inv.
template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    bn_apply_bwd_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                        const float* __restrict__ mean,
                        const float* __restrict__ var,
                        const float* __restrict__ gamma,
                        const float* __restrict__ sums, float inv_m,
                        float eps, T* __restrict__ gx, int M, int C,
                        int rows) {
  constexpr int N = Vec<T>::N;
  constexpr int U = 2;
  const int ty = blockDim.y;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * N;
  if (c >= C) return;
  const int m0 = blockIdx.y * rows, m1 = min(M, m0 + rows);
  float mu[N], inv[N], a[N], bm[N], cm[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mu[j] = mean[c + j];
    inv[j] = inv_std(var[c + j], eps);
    a[j] = __fmul_rn(gamma[c + j], inv[j]);
    bm[j] = __fmul_rn(sums[c + j], inv_m);
    cm[j] = __fmul_rn(sums[C + c + j], inv_m);
  }
  auto apply = [&](int m, const uint4& ug, const uint4& ux) {
    float g[N], v[N];
    Vec<T>::unpack(ug, g);
    Vec<T>::unpack(ux, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xh = __fmul_rn(__fsub_rn(v[j], mu[j]), inv[j]);
      v[j] = __fmul_rn(a[j],
                       __fsub_rn(__fsub_rn(g[j], bm[j]), __fmul_rn(xh, cm[j])));
    }
    store16(gx, m, C, c, Vec<T>::pack(v));
  };
  int m = m0 + threadIdx.y;
  for (; m + (U - 1) * ty < m1; m += U * ty) {
    uint4 ug[U], ux[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      ug[i] = load16(gy, m + i * ty, C, c);
      ux[i] = load16(x, m + i * ty, C, c);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) apply(m + i * ty, ug[i], ux[i]);
  }
  for (; m < m1; m += ty) apply(m, load16(gy, m, C, c), load16(x, m, C, c));
}

// The plan as the wrapper computes it: tx vectors of channels a block row,
// gx blocks across C, parts blocks of `rows` rows down M.
bool valid_plan(int M, int C, int n, int tx, int gx, int rows, int parts) {
  return M > 0 && C > 0 && C % n == 0 && tx >= 1 && tx <= 32 &&
         (long long)gx * tx * n >= C && rows >= 1 && parts >= 1 &&
         parts <= 65535 && gx <= 65535 && (long long)parts * rows >= M &&
         (long long)M * C < (1LL << 62);
}

template <typename T>
cudaError_t sums_launch(const void* x, const void* gy, const void* mean,
                        const void* var, float eps, float* part, float* sums,
                        int M, int C, int tx, int gx, int rows, int parts,
                        cudaStream_t s) {
  const dim3 grid(gx, parts), block(tx, THREADS / tx);
  if (gy)
    bn_sums_kernel<T, true><<<grid, block, 0, s>>>(
        (const T*)x, (const T*)gy, (const float*)mean, (const float*)var, eps,
        part, M, C, rows);
  else
    bn_sums_kernel<T, false><<<grid, block, 0, s>>>(
        (const T*)x, nullptr, nullptr, nullptr, eps, part, M, C, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bn_finalize_kernel<<<(C + 31) / 32, dim3(32, FIN_Y), 0, s>>>(part, parts,
                                                               C, sums);
  return cudaGetLastError();
}

}  // namespace

// sums (2, C) f32 of x (M, C), bf16 when is_f32 == 0, else f32: (sum x,
// sum x*x) when gy is null, else (sum gy, sum gy*xh) with xh from mean and
// var (C,) f32. part: (parts, 2, C) f32 scratch. Every pointer 16-byte
// aligned.
extern "C" int bn_sums_launch(const void* x, const void* gy, const void* mean,
                              const void* var, float eps, void* part,
                              void* sums, int M, int C, int is_f32, int tx,
                              int gx, int rows, int parts, int device,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_plan(M, C, is_f32 ? 4 : 8, tx, gx, rows, parts) ||
      (gy && (!mean || !var)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_f32)
    return (int)sums_launch<float>(x, gy, mean, var, eps, (float*)part,
                                   (float*)sums, M, C, tx, gx, rows, parts, s);
  return (int)sums_launch<bf16>(x, gy, mean, var, eps, (float*)part,
                                (float*)sums, M, C, tx, gx, rows, parts, s);
}

// y (M, C) in x's type, mean and var (C,) f32, from the sums (2, C) f32 of
// the whole batch, inv_m = f32(1 / m), and gamma, beta (C,) f32. With part
// (as bn_sums_launch's) the call first writes the sums of x's own rows into
// sums, then applies them.
extern "C" int bn_apply_launch(const void* x, void* sums, const void* gamma,
                               const void* beta, float inv_m, float eps,
                               void* y, void* mean, void* var, void* part,
                               int M, int C, int is_f32, int tx, int gx,
                               int rows, int parts, int device,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_plan(M, C, is_f32 ? 4 : 8, tx, gx, rows, parts))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* sm = (float*)sums;
  if (part)
    e = is_f32 ? sums_launch<float>(x, nullptr, nullptr, nullptr, eps,
                                    (float*)part, sm, M, C, tx, gx, rows,
                                    parts, s)
               : sums_launch<bf16>(x, nullptr, nullptr, nullptr, eps,
                                   (float*)part, sm, M, C, tx, gx, rows,
                                   parts, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(gx, parts), block(tx, THREADS / tx);
  const float *g = (const float*)gamma, *b = (const float*)beta;
  if (is_f32)
    bn_apply_kernel<float><<<grid, block, 0, s>>>(
        (const float*)x, sm, g, b, inv_m, eps, (float*)y, (float*)mean,
        (float*)var, M, C, rows);
  else
    bn_apply_kernel<bf16><<<grid, block, 0, s>>>(
        (const bf16*)x, sm, g, b, inv_m, eps, (bf16*)y, (float*)mean,
        (float*)var, M, C, rows);
  return (int)cudaGetLastError();
}

// gx (M, C) in x's type from gy and x (M, C), the forward's mean and var,
// gamma (C,) f32 and the backward's sums (2, C) f32 of the whole batch. With
// part, the call first writes the backward's sums of these rows into sums.
extern "C" int bn_apply_bwd_launch(const void* gy, const void* x,
                                   const void* mean, const void* var,
                                   const void* gamma, void* sums, float inv_m,
                                   float eps, void* gx, void* part, int M,
                                   int C, int is_f32, int tx, int gxb,
                                   int rows, int parts, int device,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_plan(M, C, is_f32 ? 4 : 8, tx, gxb, rows, parts))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* sm = (float*)sums;
  if (part)
    e = is_f32 ? sums_launch<float>(x, gy, mean, var, eps, (float*)part, sm,
                                    M, C, tx, gxb, rows, parts, s)
               : sums_launch<bf16>(x, gy, mean, var, eps, (float*)part, sm,
                                   M, C, tx, gxb, rows, parts, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(gxb, parts), block(tx, THREADS / tx);
  const float *mu = (const float*)mean, *v = (const float*)var,
              *g = (const float*)gamma;
  if (is_f32)
    bn_apply_bwd_kernel<float><<<grid, block, 0, s>>>(
        (const float*)gy, (const float*)x, mu, v, g, sm, inv_m, eps,
        (float*)gx, M, C, rows);
  else
    bn_apply_bwd_kernel<bf16><<<grid, block, 0, s>>>(
        (const bf16*)gy, (const bf16*)x, mu, v, g, sm, inv_m, eps, (bf16*)gx,
        M, C, rows);
  return (int)cudaGetLastError();
}
