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
// the depthwise taps, both weight gradients accumulate in f32, and gp is
// formed as A*g - B - xh*C before its bf16 rounding.
//
// What bounds it on the H100: bytes. The least traffic is the BN sums'
// read of gy and p, then one more read of gy, p, r, d and one write of da
// (2*CO + 3*CI bf16 per pixel); the two GEMMs are 4*CI*CO operations per
// pixel at 989 TFLOP/s, below the bytes at every Xception geometry but the
// exit tail's 1536 -> 2048.
//
// Design. 227 KB of shared memory holds neither a plane nor a strip at
// 147x147x128, and Hopper's blocks run in parallel and in no order, so
// the work is six launches, each with a fixed order of summation
// (deterministic, no atomics):
//   1. ub_bn_sums_kernel: per-block column sums of g and g*p; its blocks
//      also cast Wpw, which they read as the module holds it (CO, CI) in
//      f32, to the bf16 copy that the dgrad reads;
//   2. ub_bn_finalize_kernel: the partials summed in a fixed order, then
//      the five per-channel coefficients (vec) and dgamma, dbeta;
//   3. dgrad, gd = bf16(gp) . Wpw^T, on sepconv_gemm.cuh's kernel with the
//      A loader UbDgradA: gy and p tiles arrive by TMA, the consumer
//      warpgroups form bf16(gp) in place in the swizzled A stage
//      (fence.proxy.async, then wgmma reads it), and B is the (CO, CI) bf16
//      Wpw read MN-major; gd is written in f32. The blocks of the first
//      column tile also write bf16(gp) (M x CO) for the weight gradient;
//      nothing reads it back here;
//   4. wgrad, dWpw = d^T . bf16(gp), on the same kernel with the A loader
//      UbWgradA: d and gp MN-major as they lie (pixels as the
//      contraction), the pixels split over work items, one f32 partial
//      per split;
//   5. ub_dw_bwd_kernel: the depthwise backward on rows staged in shared
//      memory by bulk copies (gd f32 and r bf16, with their halo columns,
//      onto an mbarrier ring filled by one producer thread), a persistent
//      grid walking (rows, column range) items; each consumer thread owns
//      two channels of one column (of two where CI is wide), keeps a
//      window of three rows of gd and r in registers, writes da in bf16
//      and sums dWdw; one partial per block, reduced over the block's
//      columns in order. The taps are read as the module holds them,
//      (CI, 9) f32;
//   6. ub_reduce_kernel: the dWpw and dWdw partials summed in a fixed
//      order.
// What holds the GEMMs (PERF.md): the rate at which the ring's stages
// arrive from L2, not the tensor cores.
//
// The two entry points differ in how pass 5 cuts the plane.
// `unit_bwd_plane_launch` gives each block all H rows of its images (no
// halo rows); `unit_bwd_strips_launch` gives each block strips of hs
// rows, each strip with its two halo rows. In both a work item is a range
// of columns (with its two halo columns) and a block keeps a slice of at
// most 1024 channels. Out-of-image rows and columns contribute exact
// zeros (never copied, read as zeros), and a ragged last strip or column
// range stops at the image's edge.
//
// Under lockstep data parallelism the BN statistics are the group's: a
// rank holds M of the group's m pixels, and mean(g), mean(g*xh) are taken
// over all m. Then the work is split at the BN sums into two entries
// around the caller's all-reduce of one (2, CO) f32 vector:
// `unit_bwd_sums_launch` runs pass 1 and sums its partials into (sum g,
// sum g*xh) in the order pass 2 sums them; `unit_bwd_{plane,strips}_
// global_launch` takes that vector, summed over the group, with m, and
// runs passes 2-6 (its pass 2 also casts Wpw). At one rank the two entries
// give the one-call route's outputs bit for bit.
//
// The launch plan (every grid, tile, split, ring depth and shared-memory
// size) is computed by the wrapper, biscuit_torch/ops/fused_unit_bwd.py
// `launch_plan`, and passed in as PLAN_FIELDS ints; this file checks it
// and launches it as it is.
#include "sepconv_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bt::smem_u32;

// ------------------------------------------------------------- 1. BN sums
// Block (tx, ty), tx * ty = 256: threadIdx.x owns channels c..c+7 (16-byte
// loads), threadIdx.y strides the block's rows, two rows a step.
// part[blockIdx.y][0][c] = sum g, [1][c] = sum g*p, the ty partial sums
// added in order. The blocks also cast w32 (nw values, the module's f32
// Wpw) to w16 in bf16, 8 values a thread, spread over the whole grid.
constexpr int BN_THREADS = 256;

__global__ void __launch_bounds__(BN_THREADS)
    ub_bn_sums_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ p,
                      float* __restrict__ part, int M, int CO, int rows,
                      const float* __restrict__ w32, bf16* __restrict__ w16,
                      size_t nw) {
  __shared__ float red[BN_THREADS][17];
  const int tx = blockDim.x, ty = blockDim.y;
  const int tid = threadIdx.y * tx + threadIdx.x;
  const size_t threads = (size_t)tx * ty * gridDim.x * gridDim.y;
  for (size_t i = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * tx * ty +
                  tid;
       8 * i < nw; i += threads) {
    float v[8];
    bt::load8(w32 + 8 * i, v);
    bt::store8(w16 + 8 * i, v);
  }
  const int c = (blockIdx.x * tx + threadIdx.x) * 8;
  const int m0 = blockIdx.y * rows, m1 = min(M, m0 + rows);
  float sg[8], sgp[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sg[j] = sgp[j] = 0.f;
  if (c < CO) {
    for (int m = m0 + threadIdx.y; m < m1; m += 2 * ty) {
      const bool two = m + ty < m1;
      const size_t o = (size_t)m * CO + c, o2 = o + (size_t)ty * CO;
      float g[2][8], pv[2][8];
      bt::load8(gy + o, g[0]);
      bt::load8(p + o, pv[0]);
      if (two) {
        bt::load8(gy + o2, g[1]);
        bt::load8(p + o2, pv[1]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sg[j] += g[0][j];
        sgp[j] += g[0][j] * pv[0][j];
      }
      if (two) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sg[j] += g[1][j];
          sgp[j] += g[1][j] * pv[1][j];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[tid][j] = sg[j];
    red[tid][8 + j] = sgp[j];
  }
  __syncthreads();
  if (threadIdx.y == 0 && c < CO) {
    float t[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) t[j] = 0.f;
    for (int i = 0; i < ty; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) t[j] += red[i * tx + threadIdx.x][j];
    float* out = part + (size_t)blockIdx.y * 2 * CO;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out[c + j] = t[j];
      out[CO + c + j] = t[8 + j];
    }
  }
}

// ------------------------------------------------------- 2. BN finalize
// Block (32, 8): threadIdx.x owns channel c; threadIdx.y sums a contiguous
// range of the P partials, and the 8 ranges are added in order. Then
// vec rows: A = gamma*inv, B = A*sum(g)/m, C = A*sum(g*xh)/m, inv, mu*inv.
//
// MODE says where the two sums come from and what is written:
//   BN_ONE_CALL   the partials of pass 1 (sum g, sum g*p), summed here; vec,
//                 dgamma and dbeta are written (the one-call route);
//   BN_SUMS       the same partials, summed in the same order; only
//                 sums = (sum g, sum g*xh) of this rank's pixels is written,
//                 for the caller to all-reduce over its group;
//   BN_GIVEN      sums as BN_SUMS wrote them, already summed over the group,
//                 read as they are; only vec is written, from them with the
//                 group's pixel count m (a rank's dgamma and dbeta are its
//                 own BN_SUMS, which the caller keeps). Its blocks also cast
//                 Wpw (nw values) to the bf16 copy that the dgrad reads,
//                 which the one-call route's pass 1 casts.
// At one rank BN_SUMS then BN_GIVEN compute what BN_ONE_CALL computes, bit
// for bit (dbeta, dgamma being the sums): the sums come from the same
// additions in the same order.
constexpr int RED_Y = 8;
enum BnMode { BN_ONE_CALL, BN_SUMS, BN_GIVEN };

template <int MODE>
__global__ void ub_bn_finalize_kernel(const float* __restrict__ part, int P,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ mu,
                                      const float* __restrict__ var,
                                      float eps, float m, int CO,
                                      float* __restrict__ vec,
                                      float* __restrict__ dgamma,
                                      float* __restrict__ dbeta,
                                      float* __restrict__ sums,
                                      const float* __restrict__ w32,
                                      bf16* __restrict__ w16, size_t nw) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  float sum_g, sum_gx, inv;
  if constexpr (MODE == BN_GIVEN) {
    const size_t threads = (size_t)gridDim.x * 32 * RED_Y;
    for (size_t i = ((size_t)blockIdx.x * RED_Y + threadIdx.y) * 32 +
                    threadIdx.x;
         8 * i < nw; i += threads) {
      float v[8];
      bt::load8(w32 + 8 * i, v);
      bt::store8(w16 + 8 * i, v);
    }
    if (threadIdx.y != 0 || c >= CO) return;
    sum_g = part[c];
    sum_gx = part[CO + c];
    inv = 1.f / sqrtf(var[c] + eps);
  } else {
    __shared__ float red[RED_Y][2][32];
    const int chunk = (P + RED_Y - 1) / RED_Y;
    const int p0 = threadIdx.y * chunk, p1 = min(P, p0 + chunk);
    float sg = 0.f, sgp = 0.f;
    if (c < CO)
      for (int q = p0; q < p1; ++q) {
        sg += part[(size_t)q * 2 * CO + c];
        sgp += part[(size_t)q * 2 * CO + CO + c];
      }
    red[threadIdx.y][0][threadIdx.x] = sg;
    red[threadIdx.y][1][threadIdx.x] = sgp;
    __syncthreads();
    if (threadIdx.y != 0 || c >= CO) return;
    float sum_gp = 0.f;
    sum_g = 0.f;
#pragma unroll
    for (int i = 0; i < RED_Y; ++i) {
      sum_g += red[i][0][threadIdx.x];
      sum_gp += red[i][1][threadIdx.x];
    }
    inv = 1.f / sqrtf(var[c] + eps);
    sum_gx = (sum_gp - mu[c] * sum_g) * inv;
    if constexpr (MODE == BN_SUMS) {
      sums[c] = sum_g;
      sums[CO + c] = sum_gx;
      return;
    }
  }
  const float a = gamma[c] * inv;
  vec[c] = a;
  vec[CO + c] = a * (sum_g / m);
  vec[2 * CO + c] = a * (sum_gx / m);
  vec[3 * CO + c] = inv;
  vec[4 * CO + c] = mu[c] * inv;
  if constexpr (MODE == BN_ONE_CALL) {
    dgamma[c] = sum_gx;
    dbeta[c] = sum_g;
  }
}

// ------------------------------------------------- 3, 4. the two GEMMs
// Both run on sepconv_gemm.cuh's kernel (its ring, producer, consumers and
// CTA pairs), each with its own A loader and the plain F32Epilogue; B is
// MN-major in both and read in place: the dgrad's is Wpw (CO, CI), the
// bf16 copy that pass 1 casts of the module's weight; the wgrad's is
// bf16(gp), (M, CO), which the dgrad writes.

// bf16(gp) of 8 channels from gy, p and their coefficients q (rows of
// vec), in the TPU kernels' order of operations.
__device__ __forceinline__ uint4 gp8(uint4 ug, uint4 up,
                                     const float (&q)[5][8]) {
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&ug);
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&up);
  uint4 uo;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&uo);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 g = __bfloat1622float2(g2[j]);
    const float2 pf = __bfloat1622float2(p2[j]);
    const int a = 2 * j, b = 2 * j + 1;
    const float xa = pf.x * q[3][a] - q[4][a];
    const float xb = pf.y * q[3][b] - q[4][b];
    o2[j] = __floats2bfloat162_rn(g.x * q[0][a] - q[1][a] - xa * q[2][a],
                                  g.y * q[0][b] - q[1][b] - xb * q[2][b]);
  }
  return uo;
}

// dgrad's A, gd = bf16(gp) . Wpw^T: a stage holds gy's and p's tiles (128
// pixels x 64 channels of CO each, K-major) by TMA, gy's through the
// kernel's A map and p's through pmap. The consumers form bf16(gp) in
// place of gy, each warpgroup its own 64 rows, then fence their writes to
// the async proxy that wgmma reads through. The CTAs of the first column
// tile also write that bf16(gp) to gpb for the wgrad.
struct UbDgradA {
  static constexpr int A_BYTES = 2 * bt::SG_BM * bt::SG_BK * 2;
  static constexpr int TA = 0;
  CUtensorMap pmap;   // p: {CO, M}, box {64, 128}
  const float* vec;   // (5, CO) BN coefficients
  bf16* gpb;          // (M, CO)
  int M, CO;
  __host__ __device__ int tiles() const {
    return (M + bt::SG_BM - 1) / bt::SG_BM;
  }
  __device__ uint32_t bytes(int) const { return A_BYTES; }
  __device__ bt::TileRows rows(int t) const {
    const int m0 = t * bt::SG_BM;
    return {m0, min(bt::SG_BM, M - m0)};
  }
  __device__ void prefetch() const { bt::prefetch_tensor_map(&pmap); }
  __device__ void load(void* dst, const CUtensorMap* map, int t, int k0,
                       uint64_t* bar) const {
    bt::tma_load_2d(dst, map, k0, t * bt::SG_BM, bar);
    bt::tma_load_2d(static_cast<unsigned char*>(dst) + A_BYTES / 2, &pmap, k0,
                    t * bt::SG_BM, bar);
  }
  // This thread's slot: physical 16-byte chunk pc of rows rb + 16 i of the
  // tile, which holds channels 8 ch .. 8 ch + 7 of the stage's 64
  // (128-byte swizzle: chunk ch of row r sits at ch ^ (r & 7), and
  // (rb + 16 i) & 7 == rb & 7). gp is zero past CO (the copy engine's
  // zeros of gy and p would not give zero gp).
  __device__ void prepare(unsigned char* sa, int k0, int n0, bool real,
                          const bt::TileRows& tr, int cw, int tid) const {
    const int pc = tid & 7, rb = cw * 64 + (tid >> 3);
    const int co0 = k0 + 8 * (pc ^ (rb & 7));
    const bool in = co0 < CO;
    float q[5][8];
    if (in) {
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float4 lo =
            __ldg(reinterpret_cast<const float4*>(vec + i * CO + co0));
        const float4 hi =
            __ldg(reinterpret_cast<const float4*>(vec + i * CO + co0 + 4));
        q[i][0] = lo.x, q[i][1] = lo.y, q[i][2] = lo.z, q[i][3] = lo.w;
        q[i][4] = hi.x, q[i][5] = hi.y, q[i][6] = hi.z, q[i][7] = hi.w;
      }
    }
    const bool write = in && n0 == 0 && real;
    // All four rows' loads first: the stores below may not be moved above
    // them.
    uint4 gv[4], pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = (rb + 16 * i) * 128 + pc * 16;
      gv[i] = *reinterpret_cast<const uint4*>(sa + off);
      pv[i] = *reinterpret_cast<const uint4*>(sa + A_BYTES / 2 + off);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rb + 16 * i;
      const uint4 o = in ? gp8(gv[i], pv[i], q) : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(sa + r * 128 + pc * 16) = o;
      if (write && r < tr.rows)
        *reinterpret_cast<uint4*>(gpb + (size_t)(tr.m0 + r) * CO + co0) = o;
    }
    // The generic-proxy writes made visible to wgmma, then every thread of
    // the warpgroup past them.
    bt::fence_proxy_async();
    bt::named_bar_sync(1 + cw, 128);
  }
};

// wgrad's A, dWpw = d^T . bf16(gp): d (M, CI) as CI rows of M pixels,
// MN-major as it lies; a stage holds its two 64-channel x 64-pixel boxes
// (one a warpgroup), through a map {CI, M} with box {64, 64}. Boxes wholly
// past CI are not fetched: their rows are never stored.
struct UbWgradA {
  static constexpr int A_BYTES = bt::SG_BM * bt::SG_BK * 2;
  static constexpr int TA = 1;
  int CI;
  __host__ __device__ int tiles() const {
    return (CI + bt::SG_BM - 1) / bt::SG_BM;
  }
  __device__ int boxes(int t) const {
    return min(2, (CI - t * bt::SG_BM + 63) / 64);
  }
  __device__ uint32_t bytes(int t) const { return boxes(t) * 64 * 128; }
  __device__ bt::TileRows rows(int t) const {
    const int m0 = t * bt::SG_BM;
    return {m0, min(bt::SG_BM, CI - m0)};
  }
  __device__ void prefetch() const {}
  __device__ void load(void* dst, const CUtensorMap* map, int t, int k0,
                       uint64_t* bar) const {
    for (int h = 0; h < boxes(t); ++h)
      bt::tma_load_2d(static_cast<unsigned char*>(dst) + h * 64 * 128, map,
                      t * bt::SG_BM + 64 * h, k0, bar);
  }
  __device__ void prepare(unsigned char*, int, int, bool,
                          const bt::TileRows&, int, int) const {}
};

// A 2-D bf16 tensor map of rows x cols (row-major), boxes of bc columns x
// br rows, 128-byte swizzle.
cudaError_t map2d(CUtensorMap* map, const void* base, long long rows,
                  int cols, int bc, int br) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)bc, (cuuint32_t)br};
  const cuuint32_t es[2] = {1, 1};
  return bt::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                             dims, strides, box, es,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

// The GEMM of column tile BN on the plan's grid and shared memory.
template <int BN, class ALoad>
cudaError_t ub_gemm(const void* a, int a_rows, int a_cols, int a_bc,
                    int a_br, const void* b, int K, const ALoad& al,
                    const bt::F32Epilogue& epi, const bt::SgShape& sh,
                    int grid, int smem, cudaStream_t s) {
  CUtensorMap am, bm;
  cudaError_t e;
  if ((e = map2d(&am, a, a_rows, a_cols, a_bc, a_br)) != cudaSuccess ||
      (e = bt::weight_map(&bm, bt::SgPlan{BN, sh.cm}, b, 1, K, sh.N)) !=
          cudaSuccess)
    return e;
  return bt::sepconv_gemm_planned<BN>(am, bm, al, epi, sh, grid, smem, s);
}

template <class ALoad>
cudaError_t ub_gemm_bn(int bn, const void* a, int a_rows, int a_cols,
                       int a_bc, int a_br, const void* b, int K,
                       const ALoad& al, const bt::F32Epilogue& epi,
                       const bt::SgShape& sh, int grid, int smem,
                       cudaStream_t s) {
  switch (bn) {
    case 64:
      return ub_gemm<64>(a, a_rows, a_cols, a_bc, a_br, b, K, al, epi, sh,
                         grid, smem, s);
    case 128:
      return ub_gemm<128>(a, a_rows, a_cols, a_bc, a_br, b, K, al, epi, sh,
                          grid, smem, s);
    case 256:
      return ub_gemm<256>(a, a_rows, a_cols, a_bc, a_br, b, K, al, epi, sh,
                          grid, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------- 5. depthwise backward
// A persistent grid of ncs * G blocks. Block b takes channel slice b % ncs
// (channels c0 .. c0 + cb - 1) and walks work items j = b / ncs, + G, ...
// of the nwr * N * nstrips items: item j is column range j % nwr (columns
// w0 .. w0 + wt - 1) of unit j / nwr (image u / nstrips, rows s * rows ..
// of strip s = u % nstrips). For each item a producer thread copies the
// input rows h0 - 1 .. h1 that lie in the image, each row's gd (f32) and r
// (bf16) at the in-image columns of w0 - 1 .. w0 + wt, onto a ring of
// `ring` slots (a slot: wt + 2 columns of gd, then of r, channel pitch
// cb). Consumer thread tid owns channels c, c + 1 (c = c0 + 2 (tid %
// (cb / 2))) of the CPT columns from w0 + CPT (tid / (cb / 2)) on (two
// where CI passes 256, which fewer loads a column serve); it reads
// the columns and rows outside the image as zeros, never from the slot.
// Its dWdw sums run over all of the block's items, one partial a block.
// At most 512 computing threads a block with one column a thread, 384
// with two (whose windows take more registers: 13 warps keep 128 a
// thread, as the SM's four register partitions split them).
template <int CPT>
constexpr int db_max_consumers() {
  return CPT == 1 ? 512 : 384;
}
constexpr int DB_BARRIERS = 256;   // bytes of barriers before the ring

struct DbArgs {
  const float* gd;
  const bf16* r;
  const float* taps;   // (CI, 9), unflipped
  bf16* da;
  float* part;         // (G, 9, CI)
  int N, H, W, CI;
  int cb, ncs, wt, nwr, rows, nstrips, G, ring, consumers;
  int relu_first;
};

// Work item j: its image, rows h0 .. h1 - 1 and first column w0.
struct DbItem {
  int n, h0, h1, w0;
};

__device__ __forceinline__ DbItem db_item(const DbArgs& a, int j) {
  const int u = j / a.nwr;
  const int h0 = (u % a.nstrips) * a.rows;
  return {u / a.nstrips, h0, min(a.H, h0 + a.rows), (j % a.nwr) * a.wt};
}

template <int CPT>
__global__ void __launch_bounds__(db_max_consumers<CPT>() + 32, 1)
    ub_dw_bwd_kernel(const DbArgs a) {
  extern __shared__ __align__(128) unsigned char db_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(db_smem);
  uint64_t* empty = full + a.ring;
  unsigned char* ring = db_smem + DB_BARRIERS;
  const int slice = blockIdx.x % a.ncs, gb = blockIdx.x / a.ncs;
  const int c0 = slice * a.cb, cbh = min(a.cb, a.CI - c0);
  const int items = a.nwr * a.N * a.nstrips;
  const int gd_bytes = (a.wt + 2) * a.cb * 4;
  const int slot_bytes = (a.wt + 2) * a.cb * 6;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < a.ring; ++s) {
      bt::mbar_init(&full[s], 1);
      bt::mbar_init(&empty[s], a.consumers / 32);
    }
    bt::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= a.consumers) {
    if (tid != a.consumers) return;
    // Producer.
    const bool whole = a.ncs == 1;   // a pixel's channels are contiguous
    int ev = 0;
    for (int j = gb; j < items; j += a.G) {
      const DbItem t = db_item(a, j);
      const int cs = max(t.w0 - 1, 0), ce = min(t.w0 + a.wt, a.W - 1);
      const int dst_col = cs - (t.w0 - 1);
      const uint32_t row_gd = whole ? (uint32_t)((ce - cs + 1) * a.CI * 4)
                                    : (uint32_t)(cbh * 4);
      const uint32_t row_r = row_gd / 2;
      const int copies = whole ? 1 : ce - cs + 1;
      for (int hh = t.h0 - 1; hh <= t.h1; ++hh, ++ev) {
        const int st = ev % a.ring;
        bt::mbar_wait(&empty[st], ((ev / a.ring) & 1) ^ 1);
        const bool inside = hh >= 0 && hh < a.H;
        bt::mbar_arrive_expect_tx(&full[st],
                                  inside ? copies * (row_gd + row_r) : 0u);
        if (!inside) continue;
        unsigned char* slot = ring + (size_t)st * slot_bytes;
        const size_t pix = ((size_t)t.n * a.H + hh) * a.W + cs;
        for (int q = 0; q < copies; ++q) {
          const size_t src = (pix + q) * a.CI + c0;
          const int col = dst_col + q;
          bt::bulk_copy_g2s(slot + col * a.cb * 4, a.gd + src, row_gd,
                            &full[st]);
          bt::bulk_copy_g2s(slot + gd_bytes + col * a.cb * 2, a.r + src,
                            row_r, &full[st]);
        }
      }
    }
    return;
  }

  const int half = a.cb / 2;
  const int wl = tid / half, cp = tid % half;   // column group, channels
  const int c = c0 + 2 * cp;
  const bool lane_on = wl * CPT < a.wt && 2 * cp < cbh;
  const float2 zero = make_float2(0.f, 0.f);
  float2 tap[9], acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    // Flipped taps: gr[h, w] = sum gd[h+u-1, w+v-1] * taps[8 - (3u+v)].
    tap[k] = lane_on ? make_float2(a.taps[c * 9 + 8 - k],
                                   a.taps[(c + 1) * 9 + 8 - k])
                     : zero;
    acc[k] = zero;
  }
  // This thread's values in a slot: columns CPT wl + v (slot column 0 is
  // image column w0 - 1), channels c, c + 1.
  const int my_g = (wl * CPT * a.cb + 2 * cp) * 4, my_r = gd_bytes + my_g / 2;
  const int col_g = a.cb * 4, col_r = a.cb * 2;
  const size_t row_stride = (size_t)a.W * a.CI;
  // A window row: gd and r (as f32) at columns w - 1 .. w + CPT.
  struct Row {
    float2 g[CPT + 2], r[CPT + 2];
  };
  int ev = 0;
  // Event of input row hh: wait for its slot, load it into nw, release
  // the slot, and (from the third row of the item on) compute output row
  // hh - 1 at columns w .. w + CPT - 1 from the window rows (r0, r1, nw) =
  // (hh - 2, hh - 1, hh). in[v]: column w + v - 1 lies in the image and
  // the thread has work.
  auto event = [&](int hh, int h0, const bool (&in)[CPT + 2], const Row& r0,
                   const Row& r1, Row& nw, bf16* dp) {
    const int st = ev % a.ring;
    bt::mbar_wait(&full[st], (ev / a.ring) & 1);
    ++ev;
    const unsigned char* slot = ring + st * slot_bytes;
    const bool row_in = hh >= 0 && hh < a.H;
#pragma unroll
    for (int v = 0; v < CPT + 2; ++v) {
      const bool load = row_in && in[v];
      nw.g[v] = load ? *reinterpret_cast<const float2*>(slot + my_g +
                                                        v * col_g)
                     : zero;
      nw.r[v] = load ? __bfloat1622float2(
                           *reinterpret_cast<const __nv_bfloat162*>(
                               slot + my_r + v * col_r))
                     : zero;
    }
    // The warp has read the slot: one arrival a warp releases it.
    __syncwarp();
    if ((tid & 31) == 0) bt::mbar_arrive(&empty[st]);
    if (hh < h0 + 1) return;
#pragma unroll
    for (int o = 0; o < CPT; ++o) {
      if (!in[o + 1]) continue;
      float2 part[3];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const Row& R = u == 0 ? r0 : u == 1 ? r1 : nw;
        part[u] = zero;
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          part[u].x += R.g[o + v].x * tap[3 * u + v].x;
          part[u].y += R.g[o + v].y * tap[3 * u + v].y;
        }
      }
      float2 gr = make_float2(part[0].x + part[1].x + part[2].x,
                              part[0].y + part[1].y + part[2].y);
      const float2 gc = r1.g[o + 1];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const Row& R = u == 0 ? r0 : u == 1 ? r1 : nw;
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          acc[3 * u + v].x += R.r[o + v].x * gc.x;
          acc[3 * u + v].y += R.r[o + v].y * gc.y;
        }
      }
      if (a.relu_first) {
        gr.x = r1.r[o + 1].x > 0.f ? gr.x : 0.f;
        gr.y = r1.r[o + 1].y > 0.f ? gr.y : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(
          dp + (size_t)(hh - 1 - h0) * row_stride + o * a.CI) =
          __floats2bfloat162_rn(gr.x, gr.y);
    }
  };
  for (int j = gb; j < items; j += a.G) {
    const DbItem t = db_item(a, j);
    const int w = t.w0 + wl * CPT;
    bool in[CPT + 2];
#pragma unroll
    for (int v = 0; v < CPT + 2; ++v)
      in[v] = lane_on && w + v - 1 >= 0 && w + v - 1 < a.W &&
              w + v - 1 <= t.w0 + a.wt;
    bf16* dp = a.da + (((size_t)t.n * a.H + t.h0) * a.W + w) * a.CI + c;
    Row x, y, z;
#pragma unroll
    for (int v = 0; v < CPT + 2; ++v)
      x.g[v] = x.r[v] = y.g[v] = y.r[v] = zero;
    // Three events a step, the window rows rotating roles (no moves).
    for (int hh = t.h0 - 1; hh <= t.h1; hh += 3) {
      event(hh, t.h0, in, x, y, z, dp);
      if (hh + 1 <= t.h1) event(hh + 1, t.h0, in, y, z, x, dp);
      if (hh + 2 <= t.h1) event(hh + 2, t.h0, in, z, x, y, dp);
    }
  }

  // dWdw: the block's columns added in order, through the (now idle) ring.
  bt::named_bar_sync(1, a.consumers);
  float2* red = reinterpret_cast<float2*>(ring);
#pragma unroll
  for (int k = 0; k < 9; ++k) red[tid * 9 + k] = acc[k];
  bt::named_bar_sync(1, a.consumers);
  if (wl != 0 || 2 * cp >= cbh) return;
  float* out = a.part + (size_t)gb * 9 * a.CI;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float2 s = zero;
    for (int j = 0; j < a.wt / CPT; ++j) {
      const float2 v = red[(j * half + cp) * 9 + k];
      s.x += v.x;
      s.y += v.y;
    }
    *reinterpret_cast<float2*>(out + k * a.CI + c) = s;
  }
}

// ------------------------------------------------------- 6. reductions
// out[l] = sum_p part[p * L + l] for the two lists (dWpw, then dWdw), p in
// a fixed order: threadIdx.y sums a contiguous range of p, the 8 ranges
// are added in order. A thread owns 4 consecutive columns (L % 4 == 0);
// column group q (128 columns) of the two lists laid end to end goes to
// block q % gridDim.x.

__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

__global__ void ub_reduce_kernel(const float* __restrict__ pa,
                                 float* __restrict__ oa, int Pa, size_t La,
                                 const float* __restrict__ pb,
                                 float* __restrict__ ob, int Pb, size_t Lb) {
  __shared__ float4 red[RED_Y][32];
  const size_t ga = (La + 127) / 128, groups = ga + (Lb + 127) / 128;
  for (size_t q = blockIdx.x; q < groups; q += gridDim.x) {
    const bool first = q < ga;
    const float* part = first ? pa : pb;
    float* out = first ? oa : ob;
    const int P = first ? Pa : Pb;
    const size_t L = first ? La : Lb;
    const size_t l = ((first ? q : q - ga) * 32 + threadIdx.x) * 4;
    const int chunk = (P + RED_Y - 1) / RED_Y;
    const int p0 = threadIdx.y * chunk, p1 = min(P, p0 + chunk);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l < L)
      for (int p = p0; p < p1; ++p)
        add4(s, __ldg(reinterpret_cast<const float4*>(part + (size_t)p * L +
                                                       l)));
    __syncthreads();   // the last group's sums have been read
    red[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.y == 0 && l < L) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < RED_Y; ++i) add4(t, red[i][threadIdx.x]);
      *reinterpret_cast<float4*>(out + l) = t;
    }
  }
}

// ------------------------------------------------------------ the passes
// The launch plan, in the order of `PLAN_FIELDS` in
// biscuit_torch/ops/fused_unit_bwd.py.
enum PlanField {
  P_BN_TX, P_BN_GX, P_BN_ROWS, P_BN_PARTS, P_FIN_GRID,
  P_DG_BN, P_DG_STAGES, P_DG_SMEM, P_DG_GRID, P_DG_CLUSTER,
  P_WG_BN, P_WG_STAGES, P_WG_SMEM, P_WG_GRID, P_WG_SPLITS, P_WG_CHUNK,
  P_WG_CLUSTER,
  P_DW_CB, P_DW_NCS, P_DW_CPT, P_DW_WT, P_DW_NWR, P_DW_ROWS, P_DW_NSTRIPS,
  P_DW_G, P_DW_RING, P_DW_CONSUMERS, P_DW_SMEM, P_DW_BLOCKS,
  P_RED_GRID,
  P_FIELDS
};

struct Args {
  const bf16 *gy, *p, *r, *d;
  const float* taps;           // (CI, 9)
  const float* wpw;            // (CO, CI)
  const float *gamma, *mu, *var;
  float eps;
  bf16* da;                    // (N, H, W, CI)
  float *dwdw, *dwpw, *dgamma, *dbeta;   // (9, CI), (CI, CO), (CO,), (CO,)
  float *bn_part, *vec;                  // (P_bn, 2, CO), (5, CO)
  bf16 *wpw16, *gpb;                     // (CO, CI), (M, CO)
  float *gd, *wg_part, *dw_part;         // (M, CI), (S_w, CI, CO), (P_dw, 9, CI)
  int N, H, W, CI, CO, relu_first;
};

// The plan is launched as it is; these are the limits the kernels hold it
// to.
bool plan_ok(const Args& a, const int* pl, int M) {
  return !(pl[P_BN_TX] < 1 || pl[P_BN_TX] > 32 ||
      (long long)pl[P_BN_GX] * pl[P_BN_TX] * 8 < a.CO ||
      (long long)pl[P_BN_PARTS] * pl[P_BN_ROWS] < M ||
      pl[P_FIN_GRID] * 32 < a.CO || pl[P_RED_GRID] < 1 ||
      pl[P_DW_BLOCKS] != pl[P_DW_NCS] * pl[P_DW_G] ||
      (pl[P_DW_CPT] != 1 && pl[P_DW_CPT] != 2) || pl[P_DW_WT] % pl[P_DW_CPT] ||
      pl[P_DW_RING] < 1 || pl[P_DW_RING] > DB_BARRIERS / 16 ||
      pl[P_DW_CONSUMERS] > (pl[P_DW_CPT] == 2 ? db_max_consumers<2>()
                                              : db_max_consumers<1>()) ||
      pl[P_DW_CONSUMERS] % 32);
}

// Pass 1, the BN sums' partials; with nw > 0 its blocks also cast Wpw.
cudaError_t bn_sums(const Args& a, const int* pl, int M, size_t nw,
                    cudaStream_t s) {
  ub_bn_sums_kernel<<<dim3(pl[P_BN_GX], pl[P_BN_PARTS]),
                      dim3(pl[P_BN_TX], BN_THREADS / pl[P_BN_TX]), 0, s>>>(
      a.gy, a.p, a.bn_part, M, a.CO, pl[P_BN_ROWS], a.wpw, a.wpw16, nw);
  return cudaGetLastError();
}

// Passes 1-6 of one unit backward. With `given` null, the one-call route:
// the BN sums of this call's M pixels. Otherwise `given` holds (sum g,
// sum g*xh) over m pixels of a group, as `run_sums` wrote them and the
// caller all-reduced them, and pass 1 is not run.
int run(const Args& a, const int* pl, int device, void* stream,
        const float* given, float m) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int M = a.N * a.H * a.W;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (!plan_ok(a, pl, M)) return (int)cudaErrorInvalidValue;

  // 1, 2. BN sums (and Wpw in bf16), then the coefficients.
  const size_t nw = (size_t)a.CO * a.CI;
  if (given == nullptr) {
    if ((e = bn_sums(a, pl, M, nw, s)) != cudaSuccess) return (int)e;
    ub_bn_finalize_kernel<BN_ONE_CALL><<<pl[P_FIN_GRID], dim3(32, RED_Y), 0,
                                         s>>>(
        a.bn_part, pl[P_BN_PARTS], a.gamma, a.mu, a.var, a.eps, (float)M,
        a.CO, a.vec, a.dgamma, a.dbeta, nullptr, nullptr, nullptr, 0);
  } else {
    ub_bn_finalize_kernel<BN_GIVEN><<<pl[P_FIN_GRID], dim3(32, RED_Y), 0,
                                      s>>>(
        given, 1, a.gamma, a.mu, a.var, a.eps, m, a.CO, a.vec, a.dgamma,
        a.dbeta, nullptr, a.wpw, a.wpw16, nw);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 3. dgrad (and bf16(gp)): M x CI, k = CO.
  UbDgradA dg;
  dg.vec = a.vec;
  dg.gpb = a.gpb;
  dg.M = M;
  dg.CO = a.CO;
  const int kco = (a.CO + bt::SG_BK - 1) / bt::SG_BK * bt::SG_BK;
  if ((e = map2d(&dg.pmap, a.p, M, a.CO, bt::SG_BK, bt::SG_BM)) !=
          cudaSuccess ||
      (e = ub_gemm_bn(pl[P_DG_BN], a.gy, M, a.CO, bt::SG_BK, bt::SG_BM,
                      a.wpw16, a.CO, dg, bt::F32Epilogue{a.gd, a.CI, 0},
                      bt::SgShape{a.CI, a.CO, 0, pl[P_DG_CLUSTER], 1, kco,
                                  pl[P_DG_STAGES]},
                      pl[P_DG_GRID], pl[P_DG_SMEM], s)) != cudaSuccess)
    return (int)e;

  // 4. wgrad: CI x CO, k = M pixels in P_WG_SPLITS ranges.
  if ((e = ub_gemm_bn(pl[P_WG_BN], a.d, M, a.CI, 64, bt::SG_BK, a.gpb, M,
                      UbWgradA{a.CI},
                      bt::F32Epilogue{a.wg_part, a.CO,
                                      (long long)a.CI * a.CO},
                      bt::SgShape{a.CO, M, 0, pl[P_WG_CLUSTER],
                                  pl[P_WG_SPLITS], pl[P_WG_CHUNK],
                                  pl[P_WG_STAGES]},
                      pl[P_WG_GRID], pl[P_WG_SMEM], s)) != cudaSuccess)
    return (int)e;

  // 5. depthwise backward, da and dWdw partials.
  const DbArgs b{a.gd, a.r, a.taps, a.da, a.dw_part, a.N, a.H, a.W, a.CI,
                 pl[P_DW_CB], pl[P_DW_NCS], pl[P_DW_WT], pl[P_DW_NWR],
                 pl[P_DW_ROWS], pl[P_DW_NSTRIPS], pl[P_DW_G], pl[P_DW_RING],
                 pl[P_DW_CONSUMERS], a.relu_first};
  auto* dw_kernel = pl[P_DW_CPT] == 2 ? ub_dw_bwd_kernel<2>
                                     : ub_dw_bwd_kernel<1>;
  if ((e = cudaFuncSetAttribute(dw_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                pl[P_DW_SMEM])) != cudaSuccess)
    return (int)e;
  dw_kernel<<<pl[P_DW_BLOCKS], pl[P_DW_CONSUMERS] + 32, pl[P_DW_SMEM], s>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 6. the weight gradients' partials, summed in order.
  ub_reduce_kernel<<<pl[P_RED_GRID], dim3(32, RED_Y), 0, s>>>(
      a.wg_part, a.dwpw, pl[P_WG_SPLITS], (size_t)a.CI * a.CO, a.dw_part,
      a.dwdw, pl[P_DW_G], (size_t)9 * a.CI);
  return (int)cudaGetLastError();
}

// Pass 1 and the first half of pass 2: sums = (sum g, sum g*xh) over this
// call's M pixels, (2, CO) f32.
int run_sums(const Args& a, const int* pl, int device, void* stream,
             float* sums) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int M = a.N * a.H * a.W;
  cudaStream_t s = (cudaStream_t)stream;
  if (!plan_ok(a, pl, M)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaMemsetAsync(sums, 0, 2 * a.CO * sizeof(float), s);
  if ((e = bn_sums(a, pl, M, 0, s)) != cudaSuccess) return (int)e;
  ub_bn_finalize_kernel<BN_SUMS><<<pl[P_FIN_GRID], dim3(32, RED_Y), 0, s>>>(
      a.bn_part, pl[P_BN_PARTS], a.gamma, a.mu, a.var, a.eps, (float)M, a.CO,
      nullptr, nullptr, nullptr, sums, nullptr, nullptr, 0);
  return (int)cudaGetLastError();
}

Args make_args(const void* gy, const void* p, const void* r, const void* d,
               const void* taps, const void* wpw, const void* gamma,
               const void* mu, const void* var, float eps, void* da,
               void* dwdw, void* dwpw, void* dgamma, void* dbeta,
               void* bn_part, void* vec, void* wpw16, void* gpb, void* gd,
               void* wg_part, void* dw_part, int N, int H, int W, int CI,
               int CO, int relu_first) {
  return Args{(const bf16*)gy,     (const bf16*)p,      (const bf16*)r,
              (const bf16*)d,      (const float*)taps,  (const float*)wpw,
              (const float*)gamma, (const float*)mu,    (const float*)var,
              eps,                 (bf16*)da,           (float*)dwdw,
              (float*)dwpw,        (float*)dgamma,      (float*)dbeta,
              (float*)bn_part,     (float*)vec,         (bf16*)wpw16,
              (bf16*)gpb,          (float*)gd,          (float*)wg_part,
              (float*)dw_part,     N,                   H,
              W,                   CI,                  CO,
              relu_first};
}

}  // namespace

// gy, p: (N, H, W, CO) bf16; r, d: (N, H, W, CI) bf16; taps (CI, 9) f32
// and wpw (CO, CI) f32, as the modules hold them; gamma, mu, var (CO,)
// f32. Outputs da (N, H, W, CI) bf16, dwdw (9, CI), dwpw (CI, CO), dgamma,
// dbeta (CO,) f32. Scratch and plan (P_FIELDS ints) from
// biscuit_torch/ops/fused_unit_bwd.py `launch_plan`. CI, CO % 8 == 0,
// 16-byte aligned bases.
#define UNIT_BWD_PARAMS                                                     \
  const void *gy, const void *p, const void *r, const void *d,              \
      const void *taps, const void *wpw, const void *gamma, const void *mu, \
      const void *var, float eps, void *da, void *dwdw, void *dwpw,         \
      void *dgamma, void *dbeta, void *bn_part, void *vec, void *wpw16,     \
      void *gpb, void *gd, void *wg_part, void *dw_part, int N, int H,      \
      int W, int CI, int CO, int relu_first, const int *plan
#define UNIT_BWD_ARGS                                                       \
  make_args(gy, p, r, d, taps, wpw, gamma, mu, var, eps, da, dwdw, dwpw,    \
            dgamma, dbeta, bn_part, vec, wpw16, gpb, gd, wg_part, dw_part, N, \
            H, W, CI, CO, relu_first)

bool plane_ok(int H, const int* plan) {
  return plan[P_DW_ROWS] == H && plan[P_DW_NSTRIPS] == 1;
}

bool strips_ok(int H, const int* plan) {
  return plan[P_DW_ROWS] >= 1 &&
         plan[P_DW_NSTRIPS] == (H + plan[P_DW_ROWS] - 1) / plan[P_DW_ROWS];
}

// Whole planes: each depthwise-backward block walks all H rows of its
// images, with no halo rows.
extern "C" int unit_bwd_plane_launch(UNIT_BWD_PARAMS, int device,
                                     void* stream) {
  if (!plane_ok(H, plan)) return (int)cudaErrorInvalidValue;
  return run(UNIT_BWD_ARGS, plan, device, stream, nullptr, 0.f);
}

// Strips of plan[P_DW_ROWS] rows, each with its two halo rows.
extern "C" int unit_bwd_strips_launch(UNIT_BWD_PARAMS, int device,
                                      void* stream) {
  if (!strips_ok(H, plan)) return (int)cudaErrorInvalidValue;
  return run(UNIT_BWD_ARGS, plan, device, stream, nullptr, 0.f);
}

// The route of a group of ranks (lockstep data parallelism), in two
// entries around the caller's all-reduce. unit_bwd_sums_launch: pass 1 and
// the sums of this rank's pixels into sums (2, CO) f32, (sum g, sum g*xh),
// from gy, p (N, H, W, CO) bf16 and mu, var (CO,) f32, with bn_part as
// scratch; of the plan (`launch_plan` at CI = CO) it reads the BN fields.
extern "C" int unit_bwd_sums_launch(const void* gy, const void* p,
                                    const void* mu, const void* var,
                                    float eps, void* bn_part, void* sums,
                                    int N, int H, int W, int CO,
                                    const int* plan, int device,
                                    void* stream) {
  Args a{};
  a.gy = (const bf16*)gy;
  a.p = (const bf16*)p;
  a.mu = (const float*)mu;
  a.var = (const float*)var;
  a.eps = eps;
  a.bn_part = (float*)bn_part;
  a.N = N;
  a.H = H;
  a.W = W;
  a.CI = CO;
  a.CO = CO;
  return run_sums(a, plan, device, stream, (float*)sums);
}

// Then passes 2-6 from sums summed over the group, whose pixels number m.
// dgamma and dbeta are not written (they may be null): a rank's share of
// them is its own sums, from unit_bwd_sums_launch.
extern "C" int unit_bwd_plane_global_launch(UNIT_BWD_PARAMS,
                                            const void* sums, float m,
                                            int device, void* stream) {
  if (!plane_ok(H, plan)) return (int)cudaErrorInvalidValue;
  return run(UNIT_BWD_ARGS, plan, device, stream, (const float*)sums, m);
}

extern "C" int unit_bwd_strips_global_launch(UNIT_BWD_PARAMS,
                                             const void* sums, float m,
                                             int device, void* stream) {
  if (!strips_ok(H, plan)) return (int)cudaErrorInvalidValue;
  return run(UNIT_BWD_ARGS, plan, device, stream, (const float*)sums, m);
}

// The plan's field count, for the wrapper to check against its own.
extern "C" int unit_bwd_plan_fields() { return P_FIELDS; }
