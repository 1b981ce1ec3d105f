// K-pass MC-dropout head with in-kernel dropout and the per-tile softmax
// mean/std:
//   h1 = drop(relu(f . W1 + b1)); h2 = drop(relu(h1 . W2 + b2));
//   p = softmax(h2 . W3 + b3); mean = sum(p)/K, std = sqrt(max(sum(p^2)/K -
//   mean^2, 0)); bf16 matmul inputs, f32 accumulate, inverted dropout
//   x 1/(1-rate) with h rounded to bf16 after the mask.
//
// Replaces the TPU kernel biscuit_tpu/ops/mcd_head.py `_kernel` (called
// through `_mcd_head_call` and `mcd_head_pallas`).
//
// What bounds it on the H100: tensor-core operations. Dropout follows the
// relu, so layer 1 is the same in every pass and is computed once here
// (the TPU kernel recomputes it K times); the work is then 2 N (F H + K (H H
// + H C)), 17.2 GFLOP at N = 256, F = 2048, H = 1024, K = 30: 17 us at
// 989 TFLOP/s. Weights and features are about 8 MB. In practice W2 sets the
// pace: every block streams all of it (2 MB) from L2.
//
// Design: two launches; scratch is the 1 MB f32 h1 and W2 restaged (2 MB),
// both of which stay in L2. It replaces five launches on mma.sync that
// wrote the K masked copies of h1 (15.7 MB) and per-warp partial logits to
// HBM, computed each Philox draw twice and reduced on 2 SMs.
//  (1) layer1_kernel: h1 = relu(bf16(f) . W1 + b1) on mma.sync tensor
//      cores in 32 x 64 tiles (128 blocks at N = 256, H = 1024), the f32
//      features staged in shared memory by cp.async and rounded to bf16 as
//      the A fragments are built, so no cast pass and no bf16 copy exist.
//      Its extra blocks copy W2 into the order the pass kernel's shared
//      memory wants, one contiguous 16 KB chunk per ring stage.
//  (2) pass_kernel: the rest, in one block per 64 GEMM rows. Rows are
//      tile-major, each tile's K passes padded to P = the next power of two
//      (64 / P tiles a block; at K > 64 a block owns one tile and walks its
//      passes in chunks of 64 rows). The block builds its masked A operand
//      (64 x H bf16, 128 KB at H = 1024) once, straight into 128-byte-
//      swizzled shared memory from h1 and the layer-0 mask, so it never
//      reaches HBM; W3 (4 KB) is loaded beside it. W2 streams through a
//      four-stage ring in 64 x 128 chunks, one bulk copy each, issued by
//      a producer thread that waits on each stage's release (mbarriers,
//      no block-wide barrier), and is read in its (in, out) layout as
//      wgmma's MN-major B; two consumer warpgroups each issue m64n64k16
//      on one half of each 128-column tile with one group left in flight.
//      The tile's epilogue applies b2, relu, the layer-1 mask, the bf16
//      round and the product with W3, adding each row's logits in
//      registers in a fixed order. After the last column tile the block
//      sums the partial logits, takes the softmax and sums p and p^2 over
//      each tile's real passes in pass order, and writes mean and std: no
//      atomics, and a call repeats bit for bit. Past H = 1024 (C = 8) or
//      1152 (C = 2), A and W3 do not both fit: the producer then also
//      copies each column tile's 128 rows of W3 into one of two slices,
//      and A holds up to 18 k-chunks, rebuilt segment by segment inside
//      each column tile when H has more (pass_kernel<true>); streaming W3
//      at H = 1024 cost 18 us of 100 (PERF.md), so the common shapes keep
//      it whole.
//
// Dropout draws: Philox4x32-10 with counter (col/4, row, pass, layer) and
// key (seed low 32 bits, seed high 32 bits); element (row, col) takes word
// col % 4 and is dropped when it is below rate * 2^32, as the TPU kernel
// compares its hardware bits. The counter names the tile and the pass, not
// the GEMM row, so the row order changes no draw. Each draw is computed
// once: in the epilogue the two threads that share a column quad compute
// one row each and swap halves. The plain version in ops/mcd_head.py
// reproduces the same stream.
#include "wgmma.cuh"

namespace {

constexpr int MAX_CLASSES = 8;

// ---------------------------------------------------------------- layer 1
constexpr int L1_BM = 32, L1_BN = 64, L1_BK = 64, L1_STAGES = 4;
constexpr int L1_THREADS = 128;           // 4 warps: 2 (M) x 2 (N)
constexpr int L1_ALD = L1_BK + 8;         // f32 A rows: conflict-free float2
constexpr int L1_BLD = L1_BN + 8;         // bf16 B rows (ldmatrix)

struct L1Smem {
  float a[L1_STAGES][L1_BM][L1_ALD];
  __nv_bfloat16 b[L1_STAGES][L1_BK][L1_BLD];
};

__device__ __forceinline__ void l1_load(L1Smem& s, int st,
                                        const float* __restrict__ f,
                                        const __nv_bfloat16* __restrict__ w1,
                                        int N, int F, int H, int m0, int n0,
                                        int kt) {
  const int k0 = kt * L1_BK;
#pragma unroll
  for (int i = threadIdx.x; i < L1_BM * (L1_BK / 4); i += L1_THREADS) {
    const int r = i / (L1_BK / 4), c = (i % (L1_BK / 4)) * 4;
    const bool ok = m0 + r < N && k0 + c < F;
    bt::cp_async16(&s.a[st][r][c], ok ? f + (size_t)(m0 + r) * F + k0 + c : f,
                   ok ? 16 : 0);
  }
#pragma unroll
  for (int i = threadIdx.x; i < L1_BK * (L1_BN / 8); i += L1_THREADS) {
    const int r = i / (L1_BN / 8), c = (i % (L1_BN / 8)) * 8;
    const bool ok = k0 + r < F && n0 + c < H;
    bt::cp_async16(&s.b[st][r][c],
                   ok ? w1 + (size_t)(k0 + r) * H + n0 + c : w1, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// W2 chunk of pass step q (column tile q / nkc, k-chunk q % nkc) in the
// order the pass kernel's shared memory wants it: two 64-column halves,
// each 64 k-rows of 128 bytes, 128-byte swizzled (wgmma's MN-major B),
// zeros past H. One block of layer1_kernel writes one 16 KB chunk, so the
// pass kernel fetches each with a single bulk copy.
constexpr int W2_CHUNK = 64 * 256;

__device__ void stage_w2(const __nv_bfloat16* __restrict__ w2,
                         unsigned char* __restrict__ w2s, int H, int nkc,
                         int q) {
  const int k0 = (q % nkc) * 64, n0 = (q / nkc) * 128;
  unsigned char* dst = w2s + (size_t)q * W2_CHUNK;
  for (int i = threadIdx.x; i < 64 * 16; i += L1_THREADS) {
    const int kr = i >> 4, half = (i >> 3) & 1, ch = i & 7;
    const int k = k0 + kr, n = n0 + half * 64 + ch * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < H && n < H)
      v = *reinterpret_cast<const uint4*>(w2 + (size_t)k * H + n);
    *reinterpret_cast<uint4*>(dst + half * 8192 + bt::swz(kr, ch)) = v;
  }
}

// Blocks below n_l1: h1 = relu(bf16(f) . W1 + b1), f32, one 32 x 64 tile
// each (row blocks vary fastest, so the blocks that share a W1 slice run
// together). The blocks after them stage W2 for the pass kernel.
__global__ void __launch_bounds__(L1_THREADS)
    layer1_kernel(const float* __restrict__ f,
                  const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ b1, float* __restrict__ h1,
                  const __nv_bfloat16* __restrict__ w2,
                  unsigned char* __restrict__ w2s, int N, int F, int H,
                  int n_l1) {
  if ((int)blockIdx.x >= n_l1) {
    stage_w2(w2, w2s, H, (H + 63) / 64, blockIdx.x - n_l1);
    return;
  }
  extern __shared__ __align__(128) unsigned char l1_smem[];
  L1Smem& s = *reinterpret_cast<L1Smem*>(l1_smem);
  const int mb = (N + L1_BM - 1) / L1_BM;
  const int m0 = (blockIdx.x % mb) * L1_BM, n0 = (blockIdx.x / mb) * L1_BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nk = (F + L1_BK - 1) / L1_BK;
#pragma unroll
  for (int kt = 0; kt < L1_STAGES - 1; ++kt) {
    if (kt < nk) l1_load(s, kt, f, w1, N, F, H, m0, n0, kt);
    bt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % L1_STAGES;
    bt::cp_async_wait<L1_STAGES - 2>();
    __syncthreads();
    const int next = kt + L1_STAGES - 1;
    if (next < nk)
      l1_load(s, next % L1_STAGES, f, w1, N, F, H, m0, n0, next);
    bt::cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < L1_BK; kk += 16) {
      // A fragment of m16n8k16 from f32: rows g, g+8; k 2t, 2t+8.
      const float* r0 = &s.a[st][wm * 16 + g][kk + 2 * t];
      const float* r1 = r0 + 8 * L1_ALD;
      const uint32_t af[4] = {
          pack_bf16(*reinterpret_cast<const float2*>(r0)),
          pack_bf16(*reinterpret_cast<const float2*>(r1)),
          pack_bf16(*reinterpret_cast<const float2*>(r0 + 8)),
          pack_bf16(*reinterpret_cast<const float2*>(r1 + 8))};
      uint32_t bf[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wn * 32 + j * 16 + (lane >> 4) * 8;
        bt::ldmatrix_x4_trans(bf[j], &s.b[st][r][c]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bt::mma_bf16(acc[j], af, bf[j >> 1][(j & 1) * 2],
                     bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  bt::cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + 2 * t;
    if (col >= H) continue;
    const float2 b = *reinterpret_cast<const float2*>(b1 + col);
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const int row = m0 + wm * 16 + g + hlf * 8;
      if (row < N)
        *reinterpret_cast<float2*>(h1 + (size_t)row * H + col) =
            make_float2(fmaxf(acc[j][2 * hlf] + b.x, 0.f),
                        fmaxf(acc[j][2 * hlf + 1] + b.y, 0.f));
    }
  }
}

// ------------------------------------------------------------ pass kernel
constexpr int PS_ROWS = 64;             // GEMM rows of a block (one m64)
constexpr int PS_CONSUMERS = 256;       // two warpgroups
constexpr int PS_THREADS = PS_CONSUMERS + 32;   // and one producer warp
constexpr int PS_STAGES = 4;            // W2 ring
constexpr int PS_A_CHUNK = PS_ROWS * 128;   // 64 rows x 64 k, bf16
constexpr int W3_SLICE = 128 * MAX_CLASSES * 2;   // W3 rows of a column tile

// Shared-memory layout of the pass kernel whose A operand holds kseg
// k-chunks and whose W3 takes w3_bytes (all of it, or two slices): A, the
// W2 ring, W3, per-row logits, probabilities and per-tile sums, the
// barriers, and room to align to 1024 bytes.
struct PassLayout {
  int a, b, w3, part, prob, sums, bars, total;
  __host__ __device__ PassLayout(int kseg, int w3_bytes) {
    a = 0;
    b = a + kseg * PS_A_CHUNK;
    w3 = b + PS_STAGES * W2_CHUNK;
    part = w3 + (w3_bytes + 15) / 16 * 16;
    prob = part + 2 * PS_ROWS * MAX_CLASSES * 4;
    sums = prob + PS_ROWS * MAX_CLASSES * 4;
    bars = sums + 2 * PS_ROWS * MAX_CLASSES * 4;
    total = bars + (2 * PS_STAGES + 4) * 8 + 1024;
  }
};

// Named barrier of the two consumer warpgroups (the producer warp takes
// no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PS_CONSUMERS) : "memory");
}

// SEG: A and all of W3 do not fit at once. W3 then comes in slices of
// 128 rows, one per column tile, and A, when it holds fewer k-chunks than
// H has, is rebuilt segment by segment inside each column tile. Otherwise
// W3 is loaded once and A built once a row chunk, and the step loop holds
// nothing but the products.
template <bool SEG>
__global__ void __launch_bounds__(PS_THREADS, 1)
    pass_kernel(const float* __restrict__ h1,
                const unsigned char* __restrict__ w2s,
                const float* __restrict__ b2,
                const __nv_bfloat16* __restrict__ w3,
                const float* __restrict__ b3, float* __restrict__ mean,
                float* __restrict__ std_out, int N, int H, int K, int C,
                int P, int T, int chunks, int kseg, uint32_t seed_lo,
                uint32_t seed_hi, uint32_t thresh, float scale) {
  extern __shared__ __align__(128) unsigned char ps_smem[];
  const uint32_t raw = bt::smem_u32(ps_smem);
  unsigned char* base = ps_smem + ((1024 - (raw & 1023)) & 1023);
  const PassLayout L(kseg, SEG ? 2 * W3_SLICE : H * C * 2);
  unsigned char* sa = base + L.a;
  unsigned char* sb = base + L.b;
  __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(base + L.w3);
  float* part = reinterpret_cast<float*>(base + L.part);   // [2][64][8]
  float* prob = reinterpret_cast<float*>(base + L.prob);   // [64][8]
  float* sum_p = reinterpret_cast<float*>(base + L.sums);  // [64][8]
  float* sum_q = sum_p + PS_ROWS * MAX_CLASSES;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + PS_STAGES;
  uint64_t* w3full = empty + PS_STAGES;   // [2]
  uint64_t* w3empty = w3full + 2;         // [2]

  const int tid = threadIdx.x, lane = tid & 31;
  const int nkc = (H + 63) / 64, ncol = (H + 127) / 128;
  const int steps = ncol * nkc;

  if (tid == 0) {
    for (int st = 0; st < PS_STAGES; ++st) {
      bt::mbar_init(&full[st], 1);
      bt::mbar_init(&empty[st], PS_CONSUMERS);
    }
    for (int b = 0; b < 2; ++b) {
      bt::mbar_init(&w3full[b], 1);
      bt::mbar_init(&w3empty[b], PS_CONSUMERS);
    }
    bt::mbar_init_fence();
  }
  __syncthreads();

  // Producer: one thread keeps the W2 ring full, each chunk one bulk copy
  // into a stage the consumers have released, and (SEG) at the first
  // chunk of each column tile copies that tile's 128 rows of W3 into one
  // of two slices for its epilogue.
  if (tid >= PS_CONSUMERS) {
    if (tid == PS_CONSUMERS) {
      for (int q = 0; q < chunks * steps; ++q) {
        const int s = q % steps;
        if (SEG && s % nkc == 0) {
          const int u = q / nkc, j = s / nkc;   // column tiles so far
          const uint32_t bytes = (uint32_t)(min(128, H - j * 128) * C * 2);
          bt::mbar_wait(&w3empty[u & 1], ((u >> 1) & 1) ^ 1);
          bt::mbar_arrive_expect_tx(&w3full[u & 1], bytes);
          bt::bulk_copy_g2s(base + L.w3 + (u & 1) * W3_SLICE,
                            w3 + (size_t)j * 128 * C, bytes, &w3full[u & 1]);
        }
        const int st = q % PS_STAGES, round = q / PS_STAGES;
        bt::mbar_wait(&empty[st], (round & 1) ^ 1);
        bt::mbar_arrive_expect_tx(&full[st], W2_CHUNK);
        bt::bulk_copy_g2s(sb + st * W2_CHUNK,
                          w2s + (size_t)s * W2_CHUNK, W2_CHUNK, &full[st]);
      }
    }
    return;
  }

  const int wg = tid >> 7, w4 = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int tile0 = blockIdx.x * T;
  const bool drop = thresh != 0;
  for (int i = tid; i < T * MAX_CLASSES; i += PS_CONSUMERS)
    sum_p[i] = sum_q[i] = 0.f;
  if (!SEG)
    for (int i = tid; i < H * C; i += PS_CONSUMERS) w3s[i] = w3[i];

  // Tile and pass of block row r in chunk ch; valid when both exist.
  auto row_of = [&](int r, int ch, int& n, int& k) {
    n = tile0 + r / P;
    k = ch * PS_ROWS + r % P;
    return n < N && k < K;
  };
  auto release = [&](int q) { bt::mbar_arrive(&empty[q % PS_STAGES]); };
  // A's k-chunks kc0 .. kc0 + nk - 1 of row chunk ch into A's slots 0 ..
  // nk - 1: A[r][col] = bf16(keep0 ? h1[n][col] * scale : 0), 8 columns
  // an item, one Philox per 4 columns; zeros past H and on padding rows.
  auto build_a = [&](int ch, int kc0, int nk) {
    const int q8 = nk * 8;
    for (int i = tid; i < PS_ROWS * q8; i += PS_CONSUMERS) {
      const int r = i / q8, q = i % q8, col = (kc0 * 8 + q) * 8;
      int n, k;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (row_of(r, ch, n, k) && col < H) {
        const float4* src =
            reinterpret_cast<const float4*>(h1 + (size_t)n * H + col);
        const float4 u = src[0], v = src[1];
        float e[8] = {u.x * scale, u.y * scale, u.z * scale, u.w * scale,
                      v.x * scale, v.y * scale, v.z * scale, v.w * scale};
        if (drop) {
#pragma unroll
          for (int hq = 0; hq < 2; ++hq) {
            const bt::U4 r4 =
                bt::dropout_bits(seed_lo, seed_hi, k, 0, n, col + 4 * hq);
            if (r4.x < thresh) e[4 * hq] = 0.f;
            if (r4.y < thresh) e[4 * hq + 1] = 0.f;
            if (r4.z < thresh) e[4 * hq + 2] = 0.f;
            if (r4.w < thresh) e[4 * hq + 3] = 0.f;
          }
        }
        out = make_uint4(pack_bf16(make_float2(e[0], e[1])),
                         pack_bf16(make_float2(e[2], e[3])),
                         pack_bf16(make_float2(e[4], e[5])),
                         pack_bf16(make_float2(e[6], e[7])));
      }
      *reinterpret_cast<uint4*>(sa + (q >> 3) * PS_A_CHUNK +
                                bt::swz(r, q & 7)) = out;
    }
  };

  for (int ch = 0; ch < chunks; ++ch) {
    // This thread's two accumulator rows and their tile and pass; in the
    // epilogue the even thread of a pair draws for row lo, the odd for hi.
    const int r_lo = w4 * 16 + g, r_hi = r_lo + 8;
    int n_lo, k_lo, n_hi, k_hi;
    row_of(r_lo, ch, n_lo, k_lo);
    row_of(r_hi, ch, n_hi, k_hi);
    const int n_me = (t & 1) ? n_hi : n_lo, k_me = (t & 1) ? k_hi : k_lo;

    float logit[2][MAX_CLASSES];
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf)
#pragma unroll
      for (int c = 0; c < MAX_CLASSES; ++c) logit[hlf][c] = 0.f;
    float d[32];
    bool pending = false;   // the previous step's stage is not released
    if (!SEG) {
      build_a(ch, 0, nkc);
      bt::fence_proxy_async();
      consumers_sync();
    }

    for (int s = 0; s < steps; ++s) {
      const int q = ch * steps + s, kc = s % nkc, j = s / nkc;
      if (SEG && kc % kseg == 0 && (j == 0 || kseg < nkc)) {
        // The next kseg k-chunks of A, once both warpgroups' products on
        // the old contents are done.
        if (pending) {
          bt::wgmma_wait<0>();
          release(q - 1);
          pending = false;
        }
        consumers_sync();
        build_a(ch, kc, min(kseg, nkc - kc));
        bt::fence_proxy_async();
        consumers_sync();
      }
      bt::mbar_wait(&full[q % PS_STAGES], (q / PS_STAGES) & 1);
      if (kc == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) d[e] = 0.f;
      }
      const uint64_t da =
          bt::smem_desc(bt::smem_u32(sa + (kc % kseg) * PS_A_CHUNK));
      const uint64_t db = bt::smem_desc(
          bt::smem_u32(sb + (q % PS_STAGES) * W2_CHUNK + wg * 8192), 512);
      bt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // A: +32 bytes, B: +2048 per k16
        bt::wgmma_bmn<64>(d, da + 2 * kk, db + 128 * kk);
      bt::wgmma_commit();
      if (kc != nkc - 1) {
        // Keep this step's products in flight; the previous step's are
        // done, so its stage goes back to the producer.
        bt::wgmma_wait<1>();
        if (pending) release(q - 1);
        pending = true;
        continue;
      }
      bt::wgmma_wait<0>();
      if (pending) release(q - 1);
      release(q);
      pending = false;

      // Epilogue of column tile j: b2, relu, layer-1 mask, bf16, . W3
      // (its rows of this tile; SEG: in slice u % 2).
      const int u = q / nkc;
      if (SEG) bt::mbar_wait(&w3full[u & 1], (u >> 1) & 1);
      const __nv_bfloat16* w3t =
          SEG ? w3s + (u & 1) * (W3_SLICE / 2) : w3s + j * 128 * C;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int cl = wg * 64 + jn * 8 + 2 * t, col = j * 128 + cl;
        uint32_t lo0 = 0xffffffffu, lo1 = 0xffffffffu;
        uint32_t hi0 = 0xffffffffu, hi1 = 0xffffffffu;
        if (drop) {
          const bt::U4 rb = bt::dropout_bits(seed_lo, seed_hi, k_me, 1, n_me,
                                             col);
          const uint32_t sx = (t & 1) ? rb.x : rb.z;
          const uint32_t sy = (t & 1) ? rb.y : rb.w;
          const uint32_t ox = __shfl_xor_sync(0xffffffffu, sx, 1);
          const uint32_t oy = __shfl_xor_sync(0xffffffffu, sy, 1);
          if (t & 1) {
            lo0 = ox; lo1 = oy; hi0 = rb.z; hi1 = rb.w;
          } else {
            lo0 = rb.x; lo1 = rb.y; hi0 = ox; hi1 = oy;
          }
        }
        if (col >= H) continue;
        const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
        const uint32_t bits[2][2] = {{lo0, lo1}, {hi0, hi1}};
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          float v0 = fmaxf(d[4 * jn + 2 * hlf] + bias.x, 0.f);
          float v1 = fmaxf(d[4 * jn + 2 * hlf + 1] + bias.y, 0.f);
          v0 = __bfloat162float(__float2bfloat16_rn(
              bits[hlf][0] >= thresh ? v0 * scale : 0.f));
          v1 = __bfloat162float(__float2bfloat16_rn(
              bits[hlf][1] >= thresh ? v1 * scale : 0.f));
#pragma unroll
          for (int c = 0; c < MAX_CLASSES; ++c)
            if (c < C)
              logit[hlf][c] +=
                  v0 * __bfloat162float(w3t[cl * C + c]) +
                  v1 * __bfloat162float(w3t[(cl + 1) * C + c]);
        }
      }
      if (SEG) bt::mbar_arrive(&w3empty[u & 1]);
    }

    // Each row's partial logits: the quad's four threads, then one slot
    // per warpgroup.
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf)
#pragma unroll
      for (int c = 0; c < MAX_CLASSES; ++c) {
        if (c >= C) break;
        float v = logit[hlf][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0)
          part[(wg * PS_ROWS + r_lo + 8 * hlf) * MAX_CLASSES + c] = v;
      }
    consumers_sync();
    if (tid < PS_ROWS) {
      int n, k;
      if (row_of(tid, ch, n, k)) {
        float z[MAX_CLASSES];
        float mx = __int_as_float(0xff800000);   // -inf
        for (int c = 0; c < C; ++c) {
          z[c] = part[tid * MAX_CLASSES + c] +
                 part[(PS_ROWS + tid) * MAX_CLASSES + c] + b3[c];
          mx = fmaxf(mx, z[c]);
        }
        float den = 0.f;
        for (int c = 0; c < C; ++c) {
          z[c] = expf(z[c] - mx);
          den += z[c];
        }
        for (int c = 0; c < C; ++c) prob[tid * MAX_CLASSES + c] = z[c] / den;
      }
    }
    consumers_sync();
    // Sums over each tile's passes of this chunk, in pass order (T * C is
    // up to 512 sums, two a thread).
    for (int i = tid; i < T * C; i += PS_CONSUMERS) {
      const int tt = i / C, c = i % C;
      float sp = sum_p[tt * MAX_CLASSES + c], sq = sum_q[tt * MAX_CLASSES + c];
      for (int kk = 0; kk < P; ++kk) {
        if (ch * PS_ROWS + kk >= K) break;
        const float p = prob[(tt * P + kk) * MAX_CLASSES + c];
        sp += p;
        sq += p * p;
      }
      sum_p[tt * MAX_CLASSES + c] = sp;
      sum_q[tt * MAX_CLASSES + c] = sq;
    }
    consumers_sync();
  }

  for (int i = tid; i < T * C; i += PS_CONSUMERS) {
    const int tt = i / C, c = i % C, n = tile0 + tt;
    if (n < N) {
      const float m = sum_p[tt * MAX_CLASSES + c] / (float)K;
      mean[(size_t)n * C + c] = m;
      std_out[(size_t)n * C + c] =
          sqrtf(fmaxf(sum_q[tt * MAX_CLASSES + c] / (float)K - m * m, 0.f));
    }
  }
}

// Bytes of W2 as layer 1's extra blocks stage it: one chunk per column
// tile and k-chunk.
size_t w2_stage_bytes(int H) {
  return (size_t)((H + 127) / 128) * ((H + 63) / 64) * W2_CHUNK;
}

}  // namespace

// Scratch the launcher needs at N tiles and hidden width H: h1 (N * H
// f32), then W2 staged for the pass kernel.
extern "C" size_t mcd_head_scratch_bytes(int N, int H) {
  return (size_t)N * H * 4 + w2_stage_bytes(H);
}

// feats (N, F) f32; w1 (F, H), w2 (H, H), w3 (H, C) bf16 (in, out); biases
// f32; scratch of mcd_head_scratch_bytes(N, H). Out: mean, std (N, C) f32.
// F % 8 == 0, H % 8 == 0, 1 <= C <= 8, K >= 1, every pointer 16-byte
// aligned. The pass kernel's rows: a tile's K passes padded to P, the next
// power of two, T = 64 / P tiles a block; at K > 64 a block owns one tile
// and walks its passes in row chunks of 64. Its A operand and W3 stay in
// shared memory whole while they fit (H up to 1024 at C = 8, 1152 at
// C = 2); past that W3 comes in slices and A holds as many 64-wide
// k-chunks as fit (18), rebuilt for each column tile when H has more.
extern "C" int mcd_head_launch(const void* feats, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* w3, const void* b3, void* mean,
                               void* std_out, void* scratch, int N, int F,
                               int H, int C, int K, unsigned int seed_lo,
                               unsigned int seed_hi, unsigned int thresh,
                               float scale, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N < 0 || F % 8 || H % 8 || H <= 0 || C < 1 || C > MAX_CLASSES || K < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  int P = 1;
  while (P < K && P < PS_ROWS) P *= 2;
  const int T = PS_ROWS / P, chunks = (K + PS_ROWS - 1) / PS_ROWS;
  int optin = 0;
  if ((e = cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  device)) != cudaSuccess)
    return (int)e;
  const int nkc = (H + 63) / 64;
  const bool seg = PassLayout(nkc, H * C * 2).total > optin;
  const int fit = (optin - PassLayout(0, 2 * W3_SLICE).total) / PS_A_CHUNK;
  const int kseg = !seg || fit > nkc ? nkc : fit;
  if (kseg < 1) return (int)cudaErrorInvalidValue;
  const int smem = PassLayout(kseg, seg ? 2 * W3_SLICE : H * C * 2).total;
  cudaStream_t s = (cudaStream_t)stream;
  auto* pass = seg ? pass_kernel<true> : pass_kernel<false>;
  if ((e = cudaFuncSetAttribute(layer1_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sizeof(L1Smem))) != cudaSuccess ||
      (e = cudaFuncSetAttribute(pass,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)) != cudaSuccess)
    return (int)e;
  float* h1 = (float*)scratch;
  unsigned char* w2s = (unsigned char*)scratch + (size_t)N * H * 4;
  const int n_l1 = ((N + L1_BM - 1) / L1_BM) * ((H + L1_BN - 1) / L1_BN);
  const int steps = ((H + 127) / 128) * nkc;
  layer1_kernel<<<n_l1 + steps, L1_THREADS, sizeof(L1Smem), s>>>(
      (const float*)feats, (const __nv_bfloat16*)w1, (const float*)b1, h1,
      (const __nv_bfloat16*)w2, w2s, N, F, H, n_l1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  pass<<<(N + T - 1) / T, PS_THREADS, smem, s>>>(
      h1, w2s, (const float*)b2, (const __nv_bfloat16*)w3, (const float*)b3,
      (float*)mean, (float*)std_out, N, H, K, C, P, T, chunks, kseg, seed_lo,
      seed_hi, thresh, scale);
  return (int)cudaGetLastError();
}
