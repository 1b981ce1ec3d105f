// Fused tile preprocessing: uint8 RGB -> reinhard_fast stain normalization
// -> per-image standardization -> bf16, one launch per batch.
//
// Replaces the TPU kernel biscuit_tpu/ops/fused_preprocess.py `_kernel`
// (called through `_fused_call` and `fused_preprocess`).
//
// What it computes, per image: rgb = max(u8, 1); lab = 100 * M_lab .
// log10(max(M_lms . rgb, 1e-8)); per-channel two-pass mean/std of lab;
// lab' = (lab - mean) / max(std, 1e-6) * target_std + target_mean; rgb' =
// clip(M_rgb . 10^(M_log . lab' / 100), 0, 255); then over the three
// channels jointly (rgb' - mean) / max(std, 1/sqrt(3HW)), stored as bf16
// or, as the TPU kernel's `out_dtype` allows, as f32.
//
// What bounds it on the H100: at the floor, HBM bytes. Each pixel must be
// read once as 3 bytes and written once as 3 bf16 (6 bytes): 9 bytes per
// pixel, 206 MB for 256 tiles of 299 x 299, about 62 us at 3.35 TB/s (15
// bytes a pixel, 103 us, with f32 out). Its
// arithmetic, about 120 instructions and 6 transcendentals a pixel, takes
// longer at the card's issue rate (about 90 us); and the per-image
// statistics hold the 16 CTAs of an image in step, three CTAs (of
// different images) sharing most SMs, so that a CTA waits at each of its
// barriers for the slowest of its cluster. The waits and the loads' and
// barriers' latency, not the bytes, set its time (PERF.md).
//
// Design: the TPU kernel keeps whole images in VMEM. One image's f32 lab
// planes (1.07 MB at 299 x 299) do not fit one SM's shared memory, so one
// image is split over a thread-block cluster (the launch plan, from
// ops/fused_preprocess.py `launch_plan`: 16 CTAs of 5,588 pixels and 67
// KB at 299 x 299, three to an SM; 8 of 11,176 with `cluster=8`), each
// CTA holding its pixels' values in shared memory, interleaved as the
// image is (element 3p + c):
//   * its uint8 bytes are read from HBM once, by bulk copies (the 16-byte
//     aligned middle; no image after the first starts on a 16-byte
//     boundary) and byte loads (the head and tail), into a staging area
//     at the top of the buffer; the lab values, 4 times as wide, are
//     written from the bottom up over the staging bytes already read, so
//     the buffer is 12 bytes a pixel: the pixels whose values end below
//     the staging area (three quarters) take no barrier, the rest are
//     read into registers first and written after one;
//   * lab is computed once a pixel (3 logarithms) and rgb' overwrites it
//     in place (3 exponentials): 6 transcendentals a pixel, against the
//     24 of a kernel that recomputes them in each of five passes;
//   * the statistics are two-pass, as the reference's: each CTA sums its
//     pixels, then the squared deviations of its values in shared memory
//     from its own mean (per-thread partials, then a warp and block tree),
//     pushes both and its mean to every CTA of the cluster through
//     distributed shared memory, and every CTA combines them (mean = sum
//     S_r / n, M2 = sum (Q_r + n_r (m_r - mean)^2), Chan et al.'s
//     pairwise update) with the same butterfly over the ranks, so all CTAs
//     of an image get the same bits whichever finishes first, and a
//     repeat gives the same output: one cluster barrier for the lab
//     statistics and one for those of rgb'. No atomics;
//   * the output is written with 16-byte stores (8 bf16 or 4 f32), the
//     values read from shared memory as two float4 or one (the buffer is
//     offset so that the first whole 16-byte output chunk starts on a
//     float4), with the head and tail elements stored one by one. Only
//     this store depends on the output type: a 299 x 299 image is 536,406
//     bytes in bf16 and 1,072,812 in f32, 6 and 12 mod 16, so in either
//     type the images after the first start off a 16-byte boundary.
// The logarithms and exponentials are the hardware's approximate base-2
// ones (lg2.approx, ex2.approx; errors near 1e-7 relative on these
// ranges, far inside the bf16 output's rounding), with the change of base
// folded into the colour matrices on either side of them.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr uint32_t BULK_PIECE = 16384;
constexpr int B_ROUND = 8;           // staged pixels a thread holds at once
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block can use
constexpr int MAX_CLUSTER = 16;      // non-portable above 8

// Dynamic shared memory of a CTA of `chunk` pixels: 12 bytes a pixel, a
// float4 of shift and the staging area's rounding. As
// ops/fused_preprocess.py `smem_bytes`.
__host__ __device__ constexpr long long smem_bytes(long long chunk) {
  return (12 * chunk + 32 + 15) / 16 * 16;
}

// Coefficients: rgb2lms[9], loglms2lab[9], lab2loglms[9], lms2rgb[9],
// target means[3], target stds[3].
struct Coef {
  float rgb2lms[9], loglms2lab[9], lab2loglms[9], lms2rgb[9], tm[3], ts[3];
};
constexpr int N_COEF = sizeof(Coef) / sizeof(float);

// Slots of a CTA's partials, three a value: its sum, its own mean and
// the squared deviations from that mean; lab's three channels, then rgb'.
enum { LAB = 0, RGB = 9, N_STATS = 12 };

__device__ __forceinline__ void mix(const float* m, const float x[3],
                                    float y[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = m[3 * i] * x[0] + m[3 * i + 1] * x[1] + m[3 * i + 2] * x[2];
}

// The hardware's base-2 logarithm and exponential, denormals flushed (the
// logarithm's arguments are near 1 or above, and an exponential that
// underflows is summed into a value that the clamp to [0, 255] holds).
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte k of the word w as a float: the byte under the exponent of 2^23,
// less 2^23.
__device__ __forceinline__ float byte_at(uint32_t w, int k) {
  const uint32_t f = __byte_perm(w, 0x4B000000u, 0x7540u | k);
  return __uint_as_float(f) - 8388608.f;
}

// The three bytes of a pixel, packed in the low 24 bits.
__device__ __forceinline__ uint32_t pixel_bytes(const unsigned char* p) {
  return p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16;
}

// lab of one pixel of packed bytes px; lms_m = rgb2lms, lab_m =
// loglms2lab with 100 log10(2) folded in. The reference's max(lms, 1e-8)
// is left out: every rgb2lms coefficient is positive and rgb >= 1, so
// lms >= 0.997.
__device__ __forceinline__ void to_lab(const float lms_m[9],
                                       const float lab_m[9], uint32_t px,
                                       float lab[3]) {
  float rgb[3], lms[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rgb[i] = fmaxf(byte_at(px, i), 1.f);
  mix(lms_m, rgb, lms);
#pragma unroll
  for (int i = 0; i < 3; ++i) lms[i] = lg2(lms[i]);
  mix(lab_m, lms, lab);
}

// Sums of K values over the warp, the butterflies interleaved; every
// lane gets the same bits.
template <int K>
__device__ __forceinline__ void warp_sums(float v[K]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

// Sums of K values over the block; every thread gets them. scratch: 32 *
// K floats.
template <int K>
__device__ __forceinline__ void block_sums(float v[K], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  warp_sums<K>(v);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) scratch[32 * i + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = lane < nw ? scratch[32 * i + lane] : 0.f;
  warp_sums<K>(v);
}

// Store this CTA's partials of K values (every thread holds them) into
// slots base + 3i.. of every CTA of the cluster: thread r stores to CTA
// r.
template <int K>
__device__ __forceinline__ void push(const float sum[K], const float own[K],
                                     const float sq[K],
                                     float (*parts)[MAX_CLUSTER], int base,
                                     uint32_t rank, uint32_t ranks) {
  if (threadIdx.x < ranks) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float* slot = &parts[base + 3 * i][rank];
      bt::st_cluster_f32(slot, threadIdx.x, sum[i]);
      bt::st_cluster_f32(slot + MAX_CLUSTER, threadIdx.x, own[i]);
      bt::st_cluster_f32(slot + 2 * MAX_CLUSTER, threadIdx.x, sq[i]);
    }
  }
}

// After every CTA has pushed: the image's mean and M2 (sum of squared
// deviations) of K values, mean = sum S_r / n and M2 = sum (Q_r + n_r
// (m_r - mean)^2) over the ranks r (Chan et al.'s pairwise update), into
// stat[2i], stat[2i + 1]. Lane r of warp 0 takes rank r; the sums over
// the ranks are the same butterfly in every CTA, so every CTA gets the
// same bits whichever finished first. A CTA's count: its pixels times
// per_px (1 for lab, 3 for rgb').
template <int K>
__device__ __forceinline__ void combine(float (*parts)[MAX_CLUSTER], int base,
                                        uint32_t ranks, int chunk, int hw,
                                        float per_px, float* stat) {
  bt::cluster_sync();
  const int r = threadIdx.x;
  if (r < 32) {
    const int p0 = min(r * chunk, hw), p1 = min(p0 + chunk, hw);
    const bool live = r < (int)ranks && p1 > p0;
    const float nr = per_px * (p1 - p0);
    float sum[K], m2[K];
#pragma unroll
    for (int i = 0; i < K; ++i) sum[i] = live ? parts[base + 3 * i][r] : 0.f;
    warp_sums<K>(sum);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      sum[i] /= per_px * hw;   // the mean
      const float d = live ? parts[base + 3 * i + 1][r] - sum[i] : 0.f;
      m2[i] = live ? parts[base + 3 * i + 2][r] + nr * d * d : 0.f;
    }
    warp_sums<K>(m2);
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        stat[2 * i] = sum[i];
        stat[2 * i + 1] = m2[i];
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// One cluster an image; CTA `rank` owns pixels [rank * chunk, ...) of it.
// OutT: __nv_bfloat16 or float.
template <typename OutT>
__global__ void __launch_bounds__(MAX_THREADS)
    fused_preprocess_kernel(const uint8_t* __restrict__ x,
                            OutT* __restrict__ out,
                            const float* __restrict__ coef, int hw,
                            int chunk) {
  // log2 of the output elements a 16-byte store holds, and of an element's
  // bytes.
  constexpr int LOG_PER16 = sizeof(OutT) == 2 ? 3 : 2;
  constexpr int LOG_SIZE = sizeof(OutT) == 2 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Coef c;
  __shared__ float scratch[3 * 32];
  __shared__ float parts[N_STATS][MAX_CLUSTER], stat[6];
  __shared__ uint64_t bar;
  const int tid = threadIdx.x, nt = blockDim.x;
  const uint32_t ranks = bt::cluster_nctarank(), rank = bt::cluster_ctarank();
  const size_t img = blockIdx.x / ranks;
  const int p0 = min((int)rank * chunk, hw);
  const int npx = min(p0 + chunk, hw) - p0;
  // This CTA's input bytes [a, b). The staging area holds them from the
  // 16-byte boundary a16 below a: stage[k] is the byte at a16 + k.
  const uint8_t* src = x + (img * hw + p0) * 3;
  const uintptr_t a = (uintptr_t)src, b = a + 3 * (size_t)npx;
  const uintptr_t a16 = a & ~(uintptr_t)15;
  const int head = (int)(a - a16);
  const uintptr_t m0 = (a + 15) & ~(uintptr_t)15, m1 = b & ~(uintptr_t)15;
  const bool bulk = m1 > m0;
  const int stage_off =
      (int)smem_bytes(chunk) - ((head + 3 * npx + 15) & ~15);
  const unsigned char* px = smem + stage_off + head;   // pixel q: px[3q..]

  // This CTA's output elements [0, ne): oh of them before the first
  // 16-byte boundary; v is shifted so that element oh starts a float4.
  OutT* dst = out + (img * hw + p0) * 3;
  const int ne = 3 * npx;
  const int oh =
      min(ne, (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> LOG_SIZE));
  const int shift = (4 - (oh & 3)) & 3;
  float* v = reinterpret_cast<float*>(smem) + shift;

  // The coefficients, with the logarithm's and the exponential's change
  // of base folded into the matrices that take and give them.
  for (int i = tid; i < N_COEF; i += nt) {
    const float k = i >= 9 && i < 18    ? 30.102999566398120f    // 100 log10 2
                    : i >= 18 && i < 27 ? 0.033219280948873623f  // log2(10)/100
                                        : 1.f;
    reinterpret_cast<float*>(&c)[i] = coef[i] * k;
  }
  if (tid == 0 && bulk) {
    bt::mbar_init(&bar, 1);
    bt::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && bulk) {
    const uint32_t total_bytes = (uint32_t)(m1 - m0);
    bt::mbar_arrive_expect_tx(&bar, total_bytes);
    for (uint32_t off = 0; off < total_bytes; off += BULK_PIECE)
      bt::bulk_copy_g2s(smem + stage_off + (m0 - a16) + off,
                        reinterpret_cast<const void*>(m0 + off),
                        min(BULK_PIECE, total_bytes - off), &bar);
  }
  {
    // The bytes outside the aligned middle, one by one.
    const int nh = bulk ? (int)(m0 - a) : 3 * npx;
    const int nl = bulk ? (int)(b - m1) : 0;
    for (int i = tid; i < nh + nl; i += nt) {
      const uintptr_t p = i < nh ? a + i : m1 + (i - nh);
      smem[stage_off + (p - a16)] = *reinterpret_cast<const uint8_t*>(p);
    }
  }
  // Every CTA of the cluster has started before any writes to another's
  // shared memory (the wait is before the first push).
  bt::cluster_arrive();
  __syncthreads();
  if (bulk) bt::mbar_wait(&bar, 0);

  // (1) lab, once a pixel, and its sums. The values (12 bytes a pixel)
  // are written from the bottom of the buffer up, over staging bytes
  // already read: pixels [0, qa) end below the staging area; the rest are
  // read into registers in rounds of B_ROUND a thread, each round's reads
  // before a barrier and its writes after (a pixel's values never reach
  // the bytes of a later pixel). The first round is read first and
  // written after the pixels below qa.
  float lms_m[9], lab_m[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    lms_m[k] = c.rgb2lms[k];
    lab_m[k] = c.loglms2lab[k];
  }
  const int qa = min(npx, (stage_off + head - 4 * shift) / 12);
  float s[3] = {0.f, 0.f, 0.f};
  uint32_t held[B_ROUND];
#pragma unroll
  for (int j = 0; j < B_ROUND; ++j) {
    const int q = qa + tid + j * nt;
    held[j] = q < npx ? pixel_bytes(px + 3 * q) : 0u;
  }
#pragma unroll 2
  for (int q = tid; q < qa; q += nt) {
    float lab[3];
    to_lab(lms_m, lab_m, pixel_bytes(px + 3 * q), lab);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v[3 * q + i] = lab[i];
      s[i] += lab[i];
    }
  }
  for (int base = qa;;) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < B_ROUND; ++j) {
      const int q = base + tid + j * nt;
      if (q < npx) {
        float lab[3];
        to_lab(lms_m, lab_m, held[j], lab);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          v[3 * q + i] = lab[i];
          s[i] += lab[i];
        }
      }
    }
    base += B_ROUND * nt;
    if (base >= npx) break;
#pragma unroll
    for (int j = 0; j < B_ROUND; ++j) {
      const int q = base + tid + j * nt;
      held[j] = q < npx ? pixel_bytes(px + 3 * q) : 0u;
    }
  }
  block_sums<3>(s, scratch);

  // (2) the squared deviations of lab from this CTA's mean (two-pass).
  float q2[3] = {0.f, 0.f, 0.f}, own[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) own[i] = npx > 0 ? s[i] / npx : 0.f;
#pragma unroll 4
  for (int q = tid; q < npx; q += nt) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float d = v[3 * q + i] - own[i];
      q2[i] += d * d;
    }
  }
  block_sums<3>(q2, scratch);
  bt::cluster_wait();
  push<3>(s, own, q2, parts, LAB, rank, ranks);
  combine<3>(parts, LAB, ranks, chunk, hw, 1.f, stat);
  float mean[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) mean[i] = stat[2 * i];

  // (3) rgb' in place, and its sum over all three channels. lab' = (lab -
  // mean) * gain + tm with gain = ts / max(std, 1e-6), and the log lms =
  // M lab' / 100 of it, are taken together as mg (lab - mean) + bias with
  // mg = M diag(gain) and bias = M tm (M with log2(10) / 100 folded in).
  // rgb' is kept divided by 255 (lms2rgb / 255), so that the clip to
  // [0, 255] is the saturation of the last multiply-add to [0, 1].
  float mg[9], bias[3], rgb_m[9];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float gain =
        c.ts[j] / fmaxf(sqrtf(stat[2 * j + 1] / (float)hw), 1e-6f);
#pragma unroll
    for (int i = 0; i < 3; ++i) mg[3 * i + j] = c.lab2loglms[3 * i + j] * gain;
  }
  mix(c.lab2loglms, c.tm, bias);
#pragma unroll
  for (int k = 0; k < 9; ++k) rgb_m[k] = c.lms2rgb[k] * (1.f / 255.f);
  float t[1] = {0.f};
#pragma unroll 2
  for (int q = tid; q < npx; q += nt) {
    float d[3], lms[3], rgb[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = v[3 * q + i] - mean[i];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      lms[i] = ex2(bias[i] + mg[3 * i] * d[0] + mg[3 * i + 1] * d[1] +
                   mg[3 * i + 2] * d[2]);
    mix(rgb_m, lms, rgb);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      rgb[i] = __saturatef(rgb[i]);
      v[3 * q + i] = rgb[i];
    }
    t[0] += rgb[0] + rgb[1] + rgb[2];
  }
  block_sums<1>(t, scratch);

  // (4) its squared deviations from this CTA's mean.
  float w2[1] = {0.f};
  const float own_t[1] = {npx > 0 ? t[0] / (3.f * npx) : 0.f};
#pragma unroll 4
  for (int q = tid; q < npx; q += nt) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float d = v[3 * q + i] - own_t[0];
      w2[0] += d * d;
    }
  }
  block_sums<1>(w2, scratch);   // its barriers: the lab statistics are read
  push<1>(t, own_t, w2, parts, RGB, rank, ranks);
  combine<1>(parts, RGB, ranks, chunk, hw, 3.f, stat);
  // (rgb' - mu) / max(sd, 1 / sqrt(3n)) in rgb' / 255: v * scale + offset.
  const float n3 = 3.f * hw;
  const float scale =
      1.f / fmaxf(sqrtf(stat[1] / n3), 1.f / (255.f * sqrtf(n3)));
  const float offset = -stat[0] * scale;
  // No CTA writes to another's shared memory after this; each waits below
  // for all to get here before it exits.
  bt::cluster_arrive();

  // (5) write: 16-byte chunks of 8 bf16 or 4 f32, the head and tail one
  // by one.
  const int nch = (ne - oh) >> LOG_PER16;
  const int tail = oh + (nch << LOG_PER16);
  for (int i = tid; i < oh + (ne - tail); i += nt) {
    const int e = i < oh ? i : tail + (i - oh);
    put(dst + e, v[e] * scale + offset);
  }
  const float4* v4 = reinterpret_cast<const float4*>(v + oh);
  if constexpr (LOG_PER16 == 3) {
    uint4* d4 = reinterpret_cast<uint4*>(dst + oh);
#pragma unroll 2
    for (int k = tid; k < nch; k += nt) {
      const float4 lo = v4[2 * k], hi = v4[2 * k + 1];
      d4[k] = make_uint4(
          pack_bf16(lo.x * scale + offset, lo.y * scale + offset),
          pack_bf16(lo.z * scale + offset, lo.w * scale + offset),
          pack_bf16(hi.x * scale + offset, hi.y * scale + offset),
          pack_bf16(hi.z * scale + offset, hi.w * scale + offset));
    }
  } else {
    float4* d4 = reinterpret_cast<float4*>(dst + oh);
#pragma unroll 2
    for (int k = tid; k < nch; k += nt) {
      const float4 a = v4[k];
      d4[k] = make_float4(a.x * scale + offset, a.y * scale + offset,
                          a.z * scale + offset, a.w * scale + offset);
    }
  }
  bt::cluster_wait();
}

bool valid_plan(int hw, int cluster, int chunk, int threads, int smem) {
  return hw >= 1 && cluster >= 1 && cluster <= MAX_CLUSTER &&
         (cluster & (cluster - 1)) == 0 && chunk >= 1 &&
         (long long)chunk * cluster >= hw && smem >= smem_bytes(chunk) &&
         smem <= SMEM_LIMIT && threads >= 32 && threads <= MAX_THREADS &&
         threads % 32 == 0;
}

// The launch of the kernel for OutT with clusters of `cluster` CTAs of
// `threads` threads and `smem` bytes of dynamic shared memory (its grid
// one cluster).
template <typename OutT>
cudaError_t configure(int cluster, int threads, int smem,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_preprocess_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(fused_preprocess_kernel<OutT>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename OutT>
cudaError_t launch(const void* x, void* out, const void* coef, int n_images,
                   int hw, int cluster, int chunk, int threads, int smem,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e = configure<OutT>(cluster, threads, smem, &cfg, &attr);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3((unsigned)(n_images * cluster));
  cfg.stream = stream;
  return cudaLaunchKernelEx(&cfg, fused_preprocess_kernel<OutT>,
                            (const uint8_t*)x, (OutT*)out,
                            (const float*)coef, hw, chunk);
}

}  // namespace

// The plan's launch (ops/fused_preprocess.py `launch_plan`): n_images
// clusters of `cluster` CTAs, CTA r of an image owning its pixels
// [r * chunk, (r + 1) * chunk) (cut at hw). out: bf16, or f32 when
// out_f32.
extern "C" int fused_preprocess_launch(const void* x, void* out,
                                       const void* coef, int n_images, int hw,
                                       int cluster, int chunk, int threads,
                                       int smem, int out_f32, int device,
                                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n_images == 0) return 0;
  if (n_images < 0 || !valid_plan(hw, cluster, chunk, threads, smem) ||
      (long long)n_images * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(out_f32 ? launch<float>(x, out, coef, n_images, hw, cluster,
                                       chunk, threads, smem, s)
                       : launch<__nv_bfloat16>(x, out, coef, n_images, hw,
                                               cluster, chunk, threads, smem,
                                               s));
}

// How many clusters of the plan are resident on the card at once
// (cudaOccupancyMaxActiveClusters), into *fit: the bf16 kernel's (the f32
// one differs only in its store).
extern "C" int fused_preprocess_max_clusters(int hw, int cluster, int chunk,
                                             int threads, int smem,
                                             int device, int* fit) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_plan(hw, cluster, chunk, threads, smem))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  e = configure<__nv_bfloat16>(cluster, threads, smem, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(
      fit, fused_preprocess_kernel<__nv_bfloat16>, &cfg);
}
