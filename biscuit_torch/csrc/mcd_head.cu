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
// Design: two launches; scratch is the 1 MB f32 h1 and W2 and W3 restaged
// (2 MB and at most 256 KB), all of which stay in L2. It replaces five launches on mma.sync that
// wrote the K masked copies of h1 (15.7 MB) and per-warp partial logits to
// HBM, computed each Philox draw twice and reduced on 2 SMs.
//  (1) layer1_kernel: h1 = relu(bf16(f) . W1 + b1) on mma.sync tensor
//      cores in 32 x 64 tiles (128 blocks at N = 256, H = 1024), the f32
//      features staged in shared memory by cp.async and rounded to bf16 as
//      the A fragments are built, so no cast pass and no bf16 copy exist.
//      Its extra blocks copy W2 into the order the pass kernel's shared
//      memory wants, one contiguous 16 KB chunk per ring stage, and W3 in
//      one slice per column tile.
//  (2) pass_kernel: the rest, in one block per 64 GEMM rows. Rows are
//      tile-major, each tile's K passes padded to P = the next power of two
//      (64 / P tiles a block; at K > 64 a block owns one tile and walks its
//      passes in chunks of 64 rows). The block builds its masked A operand
//      (64 x H bf16, 128 KB at H = 1024) once, straight into 128-byte-
//      swizzled shared memory from h1 and the layer-0 mask, so it never
//      reaches HBM. W2 streams through a four-stage ring in 64 x 128
//      chunks, one bulk copy each, issued by a producer thread that waits
//      on each stage's release (mbarriers, no block-wide barrier), and is
//      read in its (in, out) layout as wgmma's MN-major B; two consumer
//      warpgroups each issue m64n64k16 on one half of each 128-column tile
//      with one group left in flight. The tile's epilogue applies b2, relu,
//      the layer-1 mask and the bf16 round, and the logits are a third
//      tensor-core product, with C padded to CP = 16, 32, 64 or 128: the
//      warpgroup's masked bf16 h2 tile, already in wgmma's accumulator
//      layout, is packed in registers as the A operand of m64nCPk16
//      (FlashAttention-3's route for P) against the column tile's 128 x CP
//      slice of W3, which layer 1's extra blocks stage K-major and
//      swizzled and the producer copies in, one slice at a time, a few W2
//      chunks into each column tile. The 64 x CP logits accumulate in
//      registers across the column tiles. After the last one, both
//      warpgroups store their partial logits into shared memory laid over
//      A (dead by then); four threads a row add them and b3, mask the
//      padded classes to -inf (the TPU kernel's -1e9 biases) and take the
//      row's softmax with quad shuffles. The sums of p and p^2 over each
//      tile's real passes, in pass order, become mean and std, or are
//      carried in 2 CP floats when K > 64 walks row chunks: no atomics,
//      and a call repeats bit for bit. At CP = 128 and H = 1024, A (128
//      KB, built once a row chunk), the W2 ring (64 KB) and one W3 slice
//      (32 KB) fill 227 KB. Past that (H > 1024 at CP = 128, 1152 at 64,
//      1216 at 16 and 32) A holds as many 64-wide k-chunks as fit and is
//      rebuilt segment by segment inside each column tile (pass_kernel<
//      true, CP>), whose wgmmas ptxas serializes (C7518): forced at H =
//      1024, 0.16 ms against 0.13.
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

constexpr int MAX_CLASSES = 128;   // one 128-lane tile, as the TPU kernel

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

// W3's rows of column tile j as the pass kernel reads them: wgmma's
// K-major B, the tile's two 64-k halves one after the other, each cp rows
// (classes) of 64 k-values (128 bytes), 128-byte swizzled; zeros for the
// padded classes and past H. One block of layer1_kernel writes one slice.
__device__ void stage_w3(const __nv_bfloat16* __restrict__ w3,
                         unsigned char* __restrict__ w3s, int H, int C,
                         int cp, int j) {
  const unsigned short* w = reinterpret_cast<const unsigned short*>(w3);
  unsigned char* dst = w3s + (size_t)j * cp * 256;
  for (int i = threadIdx.x; i < cp * 16; i += L1_THREADS) {
    const int half = i / (cp * 8), n = (i >> 3) % cp, ch = i & 7;
    const int k0 = j * 128 + half * 64 + ch * 8;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 2 * e;
      const uint32_t lo = n < C && k < H ? w[(size_t)k * C + n] : 0u;
      const uint32_t hi = n < C && k + 1 < H ? w[(size_t)(k + 1) * C + n] : 0u;
      v[e] = lo | hi << 16;
    }
    *reinterpret_cast<uint4*>(dst + half * cp * 128 + bt::swz(n, ch)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Blocks below n_l1: h1 = relu(bf16(f) . W1 + b1), f32, one 32 x 64 tile
// each (row blocks vary fastest, so the blocks that share a W1 slice run
// together). The blocks after them stage W2 for the pass kernel, then W3,
// one column tile's slice a block.
__global__ void __launch_bounds__(L1_THREADS)
    layer1_kernel(const float* __restrict__ f,
                  const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ b1, float* __restrict__ h1,
                  const __nv_bfloat16* __restrict__ w2,
                  unsigned char* __restrict__ w2s,
                  const __nv_bfloat16* __restrict__ w3,
                  unsigned char* __restrict__ w3s, int N, int F, int H,
                  int C, int cp, int n_l1) {
  if ((int)blockIdx.x >= n_l1) {
    const int nkc = (H + 63) / 64, q = blockIdx.x - n_l1;
    const int steps = ((H + 127) / 128) * nkc;
    if (q < steps)
      stage_w2(w2, w2s, H, nkc, q);
    else
      stage_w3(w3, w3s, H, C, cp, q - steps);
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

// Shared-memory layout of the pass kernel whose A operand holds kseg
// k-chunks, at cp padded classes: A, its space also holding the row
// chunk's two halves of logits and then probabilities (2 x 64 x (cp + 8)
// f32) after the last column tile; the W2 ring; one W3 slice (cp x 128
// bf16); the per-class sums carried across row chunks (2 cp f32); the
// barriers; and room to align to 1024 bytes.
struct PassLayout {
  int b, w3, sums, bars, total;
  __host__ __device__ PassLayout(int kseg, int cp) {
    const int a_bytes = kseg * PS_A_CHUNK;
    const int p_bytes = 2 * PS_ROWS * (cp + 8) * 4;
    b = a_bytes > p_bytes ? a_bytes : p_bytes;   // both 1024-aligned
    w3 = b + PS_STAGES * W2_CHUNK;
    sums = w3 + cp * 256;
    bars = sums + 2 * cp * 4;
    total = bars + (2 * PS_STAGES + 2) * 8 + 1024;
  }
};

// Named barrier of the two consumer warpgroups (the producer warp takes
// no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PS_CONSUMERS) : "memory");
}

// CP: C padded to 16, 32, 64 or 128. SEG: A does not hold all of H's
// k-chunks at once, and is rebuilt segment by segment inside each column
// tile; otherwise A is built once a row chunk, and the step loop holds
// nothing but the products. w3s is W3 as layer 1 staged it.
template <bool SEG, int CP>
__global__ void __launch_bounds__(PS_THREADS, 1)
    pass_kernel(const float* __restrict__ h1,
                const unsigned char* __restrict__ w2s,
                const float* __restrict__ b2,
                const unsigned char* __restrict__ w3s,
                const float* __restrict__ b3, float* __restrict__ mean,
                float* __restrict__ std_out, int N, int H, int K, int C,
                int P, int T, int chunks, int kseg, uint32_t seed_lo,
                uint32_t seed_hi, uint32_t thresh, float scale) {
  extern __shared__ __align__(128) unsigned char ps_smem[];
  const uint32_t raw = bt::smem_u32(ps_smem);
  unsigned char* base = ps_smem + ((1024 - (raw & 1023)) & 1023);
  const PassLayout L(kseg, CP);
  unsigned char* sa = base;
  unsigned char* sb = base + L.b;
  float* prob = reinterpret_cast<float*>(base);   // over A, see PassLayout
  float* sum_p = reinterpret_cast<float*>(base + L.sums);   // [CP]
  float* sum_q = sum_p + CP;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + PS_STAGES;
  uint64_t* w3full = empty + PS_STAGES;
  uint64_t* w3empty = w3full + 1;

  const int tid = threadIdx.x, lane = tid & 31;
  const int nkc = (H + 63) / 64, ncol = (H + 127) / 128;
  const int steps = ncol * nkc;

  if (tid == 0) {
    for (int st = 0; st < PS_STAGES; ++st) {
      bt::mbar_init(&full[st], 1);
      bt::mbar_init(&empty[st], PS_CONSUMERS);
    }
    bt::mbar_init(w3full, 1);
    bt::mbar_init(w3empty, PS_CONSUMERS);
    bt::mbar_init_fence();
  }
  __syncthreads();

  // Producer: one thread keeps the W2 ring full, each chunk one bulk copy
  // into a stage the consumers have released. A few chunks into each
  // column tile, once the last tile's epilogue released the one W3 slice,
  // it copies that tile's slice in, so the ring stays full meanwhile.
  if (tid >= PS_CONSUMERS) {
    if (tid == PS_CONSUMERS) {
      for (int q = 0; q < chunks * steps; ++q) {
        const int s = q % steps;
        const int st = q % PS_STAGES, round = q / PS_STAGES;
        bt::mbar_wait(&empty[st], (round & 1) ^ 1);
        bt::mbar_arrive_expect_tx(&full[st], W2_CHUNK);
        bt::bulk_copy_g2s(sb + st * W2_CHUNK,
                          w2s + (size_t)s * W2_CHUNK, W2_CHUNK, &full[st]);
        if (s % nkc == min(PS_STAGES - 1, nkc - 1)) {
          const int u = q / nkc, j = s / nkc;   // column tiles so far
          bt::mbar_wait(w3empty, (u & 1) ^ 1);
          bt::mbar_arrive_expect_tx(w3full, CP * 256);
          bt::bulk_copy_g2s(base + L.w3, w3s + (size_t)j * CP * 256,
                            CP * 256, w3full);
        }
      }
    }
    return;
  }

  const int wg = tid >> 7, w4 = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int tile0 = blockIdx.x * T;
  const bool drop = thresh != 0;

  // Tile and pass of block row r in chunk ch; valid when both exist.
  auto row_of = [&](int r, int ch, int& n, int& k) {
    n = tile0 + r / P;
    k = ch * PS_ROWS + r % P;
    return n < N && k < K;
  };
  auto release = [&](int q) { bt::mbar_arrive(&empty[q % PS_STAGES]); };
  // Layer 1's draws for columns col, col + 1 of this thread's rows lo and
  // hi (bits[hlf][e]; all ones without dropout): each draw is computed
  // once, the even thread of a pair for its row lo (pass k, tile n), the
  // odd for its row hi, and the two swap halves.
  auto layer1_bits = [&](int k, int n, int col, uint32_t (&bits)[2][2]) {
    bits[0][0] = bits[0][1] = bits[1][0] = bits[1][1] = 0xffffffffu;
    if (!drop) return;
    const bt::U4 rb = bt::dropout_bits(seed_lo, seed_hi, k, 1, n, col);
    const uint32_t ox = __shfl_xor_sync(0xffffffffu, (t & 1) ? rb.x : rb.z, 1);
    const uint32_t oy = __shfl_xor_sync(0xffffffffu, (t & 1) ? rb.y : rb.w, 1);
    if (t & 1) {
      bits[0][0] = ox; bits[0][1] = oy; bits[1][0] = rb.z; bits[1][1] = rb.w;
    } else {
      bits[0][0] = rb.x; bits[0][1] = rb.y; bits[1][0] = ox; bits[1][1] = oy;
    }
  };
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

    // The 64 x CP logits product's accumulator, (row, class) as d's
    // layout.
    float lg[CP / 2];
#pragma unroll
    for (int e = 0; e < CP / 2; ++e) lg[e] = 0.f;
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
      // (its slice of this tile).
      const int u = q / nkc;
      // The masked bf16 h2 tile as the A operand of four m64nCPk16:
      // k16 step kk takes column groups jn = 2 kk (registers 0, 1: rows
      // lo, hi) and 2 kk + 1 (registers 2, 3).
      uint32_t af[4][4];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int cl = wg * 64 + jn * 8 + 2 * t, col = j * 128 + cl;
        uint32_t bits[2][2];
        layer1_bits(k_me, n_me, col, bits);
        // Past H the accumulator is 0 (W2 staged zeros) and W3's rows
        // are zeros: the columns add nothing.
        const float2 bias = col < H
            ? *reinterpret_cast<const float2*>(b2 + col)
            : make_float2(0.f, 0.f);
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const float v0 = fmaxf(d[4 * jn + 2 * hlf] + bias.x, 0.f);
          const float v1 = fmaxf(d[4 * jn + 2 * hlf + 1] + bias.y, 0.f);
          af[jn >> 1][(jn & 1) * 2 + hlf] = pack_bf16(make_float2(
              bits[hlf][0] >= thresh ? v0 * scale : 0.f,
              bits[hlf][1] >= thresh ? v1 * scale : 0.f));
        }
      }
      bt::mbar_wait(w3full, u & 1);
      const uint64_t dw =
          bt::smem_desc(bt::smem_u32(base + L.w3 + wg * CP * 128));
      bt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // B K-major: +32 bytes per k16
        bt::wgmma_rs<CP>(lg, af[kk], dw + 2 * kk);
      bt::wgmma_commit();
      bt::wgmma_wait<0>();
      bt::mbar_arrive(w3empty);
    }

    // Both warpgroups' partial logits into prob (on A, once both
    // warpgroups' products on it are done), each in its half; then each
    // row's softmax, four threads a row (a quad), CP / 4 classes a
    // thread, adding the halves and b3 and masking the padded classes to
    // -inf, p written over the first half. The accumulator registers are
    // only ever stored, by every thread alike.
    constexpr int S = CP + 8;   // row stride: float2 stores, few conflicts
    consumers_sync();
#pragma unroll
    for (int jn = 0; jn < CP / 8; ++jn)
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf)
        *reinterpret_cast<float2*>(prob + wg * PS_ROWS * S +
                                   (r_lo + 8 * hlf) * S + jn * 8 + 2 * t) =
            make_float2(lg[4 * jn + 2 * hlf], lg[4 * jn + 2 * hlf + 1]);
    consumers_sync();
    {
      float* row = prob + (tid >> 2) * S;
      const int q4 = tid & 3;
      float z[CP / 4];
      float mx = __int_as_float(0xff800000);   // -inf
#pragma unroll
      for (int i = 0; i < CP / 4; ++i) {
        const int c = 4 * i + q4;
        z[i] = c < C ? row[c] + row[PS_ROWS * S + c] + b3[c]
                     : __int_as_float(0xff800000);
        mx = fmaxf(mx, z[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float den = 0.f;
#pragma unroll
      for (int i = 0; i < CP / 4; ++i) {
        z[i] = expf(z[i] - mx);
        den += z[i];
      }
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
#pragma unroll   // the entries this thread read, and no other thread
      for (int i = 0; i < CP / 4; ++i) row[4 * i + q4] = z[i] / den;
    }
    consumers_sync();
    // Sums over each tile's passes of this chunk, in pass order, carried
    // to the next chunk (K > 64: one tile a block, one class a thread)
    // or written out.
    for (int i = tid; i < T * C; i += PS_CONSUMERS) {
      const int tt = i / C, c = i % C, n = tile0 + tt;
      float sp = ch ? sum_p[c] : 0.f, sq = ch ? sum_q[c] : 0.f;
      for (int kk = 0; kk < P; ++kk) {
        if (ch * PS_ROWS + kk >= K) break;
        const float p = prob[(tt * P + kk) * S + c];
        sp += p;
        sq += p * p;
      }
      if (ch + 1 < chunks) {
        sum_p[c] = sp;
        sum_q[c] = sq;
      } else if (n < N) {
        const float m = sp / (float)K;
        mean[(size_t)n * C + c] = m;
        std_out[(size_t)n * C + c] =
            sqrtf(fmaxf(sq / (float)K - m * m, 0.f));
      }
    }
    consumers_sync();
  }
}

// Bytes of W2 as layer 1's extra blocks stage it: one chunk per column
// tile and k-chunk.
size_t w2_stage_bytes(int H) {
  return (size_t)((H + 127) / 128) * ((H + 63) / 64) * W2_CHUNK;
}

// The padded class count: 16, 32, 64 or 128.
int padded_classes(int C) {
  int cp = 16;
  while (cp < C) cp *= 2;
  return cp;
}

// Bytes of W3 as layer 1 stages it: one cp x 128 slice per column tile.
size_t w3_stage_bytes(int H, int C) {
  return (size_t)((H + 127) / 128) * padded_classes(C) * 256;
}

using PassFn = decltype(&pass_kernel<false, 16>);

// The pass kernel at cp padded classes.
template <bool SEG>
PassFn pass_for(int cp) {
  return cp == 16   ? pass_kernel<SEG, 16>
         : cp == 32 ? pass_kernel<SEG, 32>
         : cp == 64 ? pass_kernel<SEG, 64>
                    : pass_kernel<SEG, 128>;
}

}  // namespace

// Scratch the launcher needs at N tiles, hidden width H and C classes: h1
// (N * H f32), then W2 and W3 staged for the pass kernel.
extern "C" size_t mcd_head_scratch_bytes(int N, int H, int C) {
  return (size_t)N * H * 4 + w2_stage_bytes(H) + w3_stage_bytes(H, C);
}

// feats (N, F) f32; w1 (F, H), w2 (H, H), w3 (H, C) bf16 (in, out); biases
// f32; scratch of mcd_head_scratch_bytes(N, H, C). Out: mean, std (N, C)
// f32. F % 8 == 0, H % 8 == 0, 1 <= C <= 128, K >= 1, every pointer
// 16-byte aligned. The pass kernel's rows: a tile's K passes padded to P,
// the next power of two, T = 64 / P tiles a block; at K > 64 a block owns
// one tile and walks its passes in row chunks of 64. W3 comes in slices,
// and A holds as many k-chunks as fit beside them (16 at C > 64: whole up
// to H = 1024), rebuilt by segment (pass_kernel<true, CP>) when H has
// more.
extern "C" int mcd_head_launch(const void* feats, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* w3, const void* b3, void* mean,
                               void* std_out, void* scratch, int N, int F,
                               int H, int C, int K, unsigned int seed_lo,
                               unsigned int seed_hi, unsigned int thresh,
                               float scale, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N < 0 || F % 8 || H % 8 || H <= 0 || C < 1 || C > MAX_CLASSES ||
      K < 1)
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
  const int nkc = (H + 63) / 64, cp = padded_classes(C);
  int kseg = nkc;
  while (kseg > 1 && PassLayout(kseg, cp).total > optin) --kseg;
  const int smem = PassLayout(kseg, cp).total;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  const PassFn pass = kseg < nkc ? pass_for<true>(cp) : pass_for<false>(cp);
  cudaStream_t s = (cudaStream_t)stream;
  if ((e = cudaFuncSetAttribute(layer1_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sizeof(L1Smem))) != cudaSuccess ||
      (e = cudaFuncSetAttribute(pass,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)) != cudaSuccess)
    return (int)e;
  float* h1 = (float*)scratch;
  unsigned char* w2s = (unsigned char*)scratch + (size_t)N * H * 4;
  unsigned char* w3s = w2s + w2_stage_bytes(H);
  const int n_l1 = ((N + L1_BM - 1) / L1_BM) * ((H + L1_BN - 1) / L1_BN);
  const int ncol = (H + 127) / 128, steps = ncol * nkc;
  layer1_kernel<<<n_l1 + steps + ncol, L1_THREADS,
                  sizeof(L1Smem), s>>>(
      (const float*)feats, (const __nv_bfloat16*)w1, (const float*)b1, h1,
      (const __nv_bfloat16*)w2, w2s, (const __nv_bfloat16*)w3, w3s, N, F, H,
      C, cp, n_l1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  pass<<<(N + T - 1) / T, PS_THREADS, smem, s>>>(
      h1, w2s, (const float*)b2, w3s, (const float*)b3, (float*)mean,
      (float*)std_out, N, H, K, C, P, T, chunks, kseg, seed_lo, seed_hi,
      thresh, scale);
  return (int)cudaGetLastError();
}
