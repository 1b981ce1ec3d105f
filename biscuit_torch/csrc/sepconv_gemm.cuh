// One Hopper GEMM for the port's pointwise (1x1) convolutions and their
// gradients, shared by the middle flow (fused_middle_flow.cu), the strided
// block (fused_block.cu) and the unit backward's dgrad and wgrad
// (fused_unit_bwd.cu):
//
//   out[m, n] = epi(sum_k A[m, k] * B[k, n])
//
// bf16 operands, f32 accumulation. A comes through an A loader (below). B
// is a (K, N) row-major matrix (a pointwise weight as the port stacks it,
// (in, out); the unit backward's Wpw as the module holds it, (CO, CI); or
// its bf16(gp), (pixels, CO)), which wgmma reads as an MN-major operand
// (its transpose flag), so no transposed copy is made. The epilogue is
// either BnEpilogue, which applies a folded BatchNorm as
// __fadd_rn(__fmul_rn(v, sc), sh), a separate multiply and add as the TPU
// kernels round, then an optional relu, an optional residual (f32 or bf16)
// added after BN, and writes f32 or bf16 (with add_out it first reads the
// bf16 value already in the output, the strided block's pooled y1, and
// adds it); or F32Epilogue, which stores the f32 sums as they are.
//
// What bounds it on the H100: bytes, at the port's shapes. A middle-flow
// unit at N = 256 (M = 92,416, K = N = 728) reads 135 MB of A and writes
// a 269 MB f32 carry (reading it again every third unit as the residual):
// about 0.15 ms at 3.35 TB/s, against 98 GFLOP, 0.10 ms at 989 TFLOP/s.
// Measured 0.33 ms (PERF.md): the ring's reads from L2 (each 128 x 184
// tile reads all of its K of A and B) and the epilogue, which the
// consumers run between main loops, hold it there.
//
// Design:
//  * TMA loads. A and B tiles come in by cp.async.bulk.tensor through
//    tensor maps with 128-byte swizzle, encoded on the host by
//    cuTensorMapEncodeTiled (reached through the runtime's driver entry
//    point, so the build needs no -lcuda). The copy engine zero-fills
//    boxes past the tensor's edge, which covers ragged M, N and K: the
//    main loop has no masks.
//  * Ring and warps. A ring of stages in shared memory with a full and an
//    empty mbarrier each. Warpgroup 2 is the producer: one thread issues
//    every copy, and the warpgroup gives its registers to the two
//    consumer warpgroups (setmaxnreg, 40 and 232 a thread), each owning 64
//    rows of the 128-row tile; each issues m64nBNk16 over the whole column
//    tile, keeps one group in flight (wgmma_wait<1>) and releases a stage
//    when the group that read it has retired. The main loop takes no block
//    barrier.
//  * Persistent grid. As many blocks as fit at once (one an SM) walk the
//    work items; the column tiles of one row block are consecutive, so the
//    blocks that share an A tile run at the same time and read it from L2.
//    The producer fills the ring for the next item while the consumers run
//    this item's epilogue. K may be split into ranges (SgShape), each its
//    own work items and its own output plane (the wgrad's pixel splits).
//  * Clusters. Two CTAs on neighbouring row blocks take the same column
//    tile and share its B: each loads half of every B box and multicasts
//    it to both (cp.async.bulk.tensor .multicast::cluster), and each
//    consumer warp releases a stage to both CTAs; the producer stays until
//    the pair has released every stage. This cuts what the ring reads from
//    L2 by a third at the middle flow's 128 x 184 tiles; a 2 x 2 cluster
//    that also shared A, a second block an SM, and a TMA store of the
//    staged tile were slower (PERF.md).
//  * Staged epilogue (BnEpilogue). Each consumer warpgroup writes its
//    accumulators, 64 columns at a time, into shared memory, then reads
//    them back by rows, so that each thread applies the epilogue to 8
//    consecutive outputs of 4 rows and stores each row's as 16 or 32
//    contiguous bytes beside its neighbours'. The bf16 values it adds (the
//    pooled y1, a bf16 residual) are loaded before the tile's main loop.
//    F32Epilogue stores from the accumulators and takes no staging room,
//    which leaves the unit backward's wider stages a deeper ring.
//  * A loaders. DenseA: the rows of an (M, K) matrix. StridedA: the
//    strided block's residual 1x1 stride-2 conv, whose A rows are x's even
//    rows and columns, read in place by a 4-D tensor map with element
//    strides (1, 2, 2, 1). Its tile is r whole output rows of one image
//    (or, when an output row is wider than the tile, a run of one row),
//    so its rows are consecutive in the output. The unit backward adds
//    two in fused_unit_bwd.cu: one whose consumers form the A tile in
//    shared memory before their MMAs (prepare), and one read MN-major.
//
// Shapes: any M, K and N with K % 8 == N % 8 == 0 (a 16-byte row pitch, as
// TMA needs) and 16-byte aligned bases. The column tile BN is chosen per N
// (sg_plan) by the serving GEMMs, by the caller's plan otherwise.
#pragma once

#include <cuda.h>

#include "wgmma.cuh"

namespace bt {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------- tensor maps (host)
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the installed driver, looked up once.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tiled tensor map of `rank` dimensions (innermost first); strides in
// bytes of dimensions 1.. ; zeros outside the tensor.
inline cudaError_t make_tensor_map(CUtensorMap* map, CUtensorMapDataType dt,
                                   int rank, const void* base,
                                   const cuuint64_t* dims,
                                   const cuuint64_t* strides,
                                   const cuuint32_t* box,
                                   const cuuint32_t* elem_strides,
                                   CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const CUresult r =
      fn(map, dt, (cuuint32_t)rank, const_cast<void*>(base), dims, strides,
         box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------------ TMA loads (device)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The same, multicast: the box lands at dst in every CTA of the cluster
// whose bit is set in mask, each completing its barrier at bar's offset.
__device__ __forceinline__ void tma_load_3d_mc(void* dst,
                                               const CUtensorMap* map, int c0,
                                               int c1, int c2, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

// Barrier `id` (1..15) among `n` threads of the block.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// This warpgroup's registers a thread, lowered or raised to R.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------------- clusters
// One arrival on the barrier at bar's offset in the cluster's CTA `cta`,
// with the default (CTA-scope) release: what it orders is this warp's
// wgmma reads of the stage, which have retired; a cluster-scope release
// would also wait for the thread's outstanding global stores.
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// ------------------------------------------------------------- geometry
constexpr int SG_BM = 128;                // rows a tile: 2 warpgroups x 64
constexpr int SG_BK = 64;                 // k a stage: one 128-byte row
constexpr int SG_CONSUMERS = 256;
constexpr int SG_WARPS = SG_CONSUMERS / 32;
// and a producer warpgroup, of which one thread issues the copies; it
// hands its registers to the consumers (setmaxnreg).
constexpr int SG_THREADS = SG_CONSUMERS + 128;
constexpr int SG_PRODUCER_REGS = 40, SG_CONSUMER_REGS = 232;
constexpr int SG_CLUSTER = 2;   // CTAs of a cluster, on neighbouring rows
constexpr int SG_EPI_LD = 72;   // f32 pitch of a staged row: conflict-free
                                // float2 writes of the accumulator layout
constexpr int SG_EPI_BYTES = 64 * SG_EPI_LD * 4;   // a warpgroup's chunk
constexpr int SG_BARRIER_BYTES = 256;             // full and empty barriers
constexpr int SG_MAX_STAGES = SG_BARRIER_BYTES / 16;
constexpr int SG_SMEM_LIMIT = 232448;             // per block, sm_90

// The output rows of one A tile: rows m0 .. m0 + rows - 1, which are the
// tile's shared-memory rows 0 .. rows - 1.
struct TileRows {
  long long m0;
  int rows;
};

// ------------------------------------------------------------ A loaders
// An A loader tells the kernel how a stage's A tile is filled and read:
//   A_BYTES  the tile's room in a stage (a multiple of 1024);
//   TA       0: K-major (rows of 64 k-values, 32 bytes a k-step of 16),
//            1: MN-major (box h of 64 rows holds rows 64 h .. 64 h + 63
//            as 64 k-rows of 128 bytes, 2048 bytes a k-step of 16);
//   tiles()  row tiles; rows(t) the output rows of tile t;
//   bytes(t) the bytes that load(t) brings in;
//   prefetch() and load(dst, map, t, k0, bar): the producer's part;
//   prepare(stage, k0, n0, real, rows, cw, tid): what consumer warpgroup
//            cw does to a full stage before its MMAs read it.

// A as the rows of an (M, K) bf16 matrix; map: 2-D {K, M}, box {64, 128}.
struct DenseA {
  static constexpr int A_BYTES = SG_BM * SG_BK * 2;
  static constexpr int TA = 0;
  int M;
  __host__ __device__ int tiles() const { return (M + SG_BM - 1) / SG_BM; }
  __device__ uint32_t bytes(int) const { return A_BYTES; }
  __device__ TileRows rows(int t) const {
    const int m0 = t * SG_BM;
    return {m0, min(SG_BM, M - m0)};
  }
  __device__ void prefetch() const {}
  __device__ void load(void* dst, const CUtensorMap* map, int t, int k0,
                       uint64_t* bar) const {
    tma_load_2d(dst, map, k0, t * SG_BM, bar);
  }
  __device__ void prepare(unsigned char*, int, int, bool, const TileRows&,
                          int, int) const {}
};

// A of the 1x1 stride-2 conv over x (n, H, W, C): output pixel (n, i, j)
// reads x[n, 2i, 2j]. Output rows are (n * H2 + i) * W2 + j. A tile is r
// output rows i0 .. i0 + r - 1 of image n (wc == W2), or wc columns j0 ..
// of one output row (W2 > 128, r == 1). map: 4-D {C, W, H, n}, element
// strides {1, 2, 2, 1}, box {64, 2 wc, 2 r, 1}: the copy engine walks
// every other column and row and writes the tile's rows in output order.
struct StridedA {
  static constexpr int A_BYTES = SG_BM * SG_BK * 2;
  static constexpr int TA = 0;
  int H2, W2, wc, r, ni, nj, n_img;
  __host__ __device__ int tiles() const { return n_img * ni * nj; }
  __device__ uint32_t bytes(int) const { return 128u * wc * r; }
  __device__ TileRows rows(int t) const {
    const int j = t % nj, i = (t / nj) % ni, n = t / (nj * ni);
    const int i0 = i * r, j0 = j * wc;
    const long long m0 = ((long long)n * H2 + i0) * W2 + j0;
    return {m0, nj == 1 ? min(r, H2 - i0) * W2 : min(wc, W2 - j0)};
  }
  __device__ void prefetch() const {}
  __device__ void load(void* dst, const CUtensorMap* map, int t, int k0,
                       uint64_t* bar) const {
    const int j = t % nj, i = (t / nj) % ni, n = t / (nj * ni);
    tma_load_4d(dst, map, k0, 2 * j * wc, 2 * i * r, n, bar);
  }
  __device__ void prepare(unsigned char*, int, int, bool, const TileRows&,
                          int, int) const {}
};

// ------------------------------------------------------------- epilogue
// Eight consecutive values of a row to f32, and back.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// out = [bf16 out +] ([relu](acc * sc + sh) [+ res]); each product and sum
// rounded on its own (the TPU kernels' rounding points, never an FMA).
// Exactly one of out_f32, out_bf16 is set, and at most one of res_f32,
// res_bf16; res and out are (M, ld) row-major. With add_out the bf16 value
// already in out (the strided block's pooled y1) is read and added first.
//
// A call covers 8 columns of SG_EPI_ROWS rows 16 apart, so a thread loads
// its scale and shift once and issues the rows' residual loads together.
// The bf16 values it adds (a bf16 residual, or the pooled y1 already in
// out) do not depend on the product, so the kernel loads them before the
// tile's main loop (prefetch) and the epilogue waits on no memory for them.
constexpr int SG_EPI_ROWS = 4;

struct BnEpilogue {
  static constexpr bool STAGED = true;
  const float* sc;
  const float* sh;
  const float* res_f32;
  const bf16* res_bf16;
  float* out_f32;
  bf16* out_bf16;
  int ld;
  int relu;
  int add_out;
  // The bf16 values this epilogue adds, or nullptr.
  __device__ __forceinline__ const bf16* extra_bf16() const {
    if (res_bf16 != nullptr) return res_bf16;
    return add_out && out_f32 == nullptr ? out_bf16 : nullptr;
  }
  // Those values at rows lr0 + 16 i of the tile, columns col .. col + 7.
  __device__ __forceinline__ void prefetch(const TileRows& tr, int lr0,
                                           int col,
                                           uint4 pre[SG_EPI_ROWS]) const {
    const bf16* src = extra_bf16();
#pragma unroll
    for (int i = 0; i < SG_EPI_ROWS; ++i)
      pre[i] = lr0 + 16 * i < tr.rows
                   ? *reinterpret_cast<const uint4*>(
                         src + (tr.m0 + lr0 + 16 * i) * ld + col)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
  // Rows lr0 + 16 i of the tile (those below tr.rows), columns col ..
  // col + 7; acc: the staged accumulators of row lr0 at those columns;
  // pre: the prefetched bf16 values, if extra_bf16().
  __device__ __forceinline__ void operator()(const TileRows& tr, int lr0,
                                             int col, const float* acc,
                                             const uint4* pre) const {
    float v[SG_EPI_ROWS][8], s[8], h[8];
    bool ok[SG_EPI_ROWS];
    long long o[SG_EPI_ROWS];
    load8(sc + col, s);
    load8(sh + col, h);
#pragma unroll
    for (int i = 0; i < SG_EPI_ROWS; ++i) {
      ok[i] = lr0 + 16 * i < tr.rows;
      o[i] = (tr.m0 + lr0 + 16 * i) * ld + col;
      load8(acc + 16 * i * SG_EPI_LD, v[i]);
    }
    const bool res = res_f32 != nullptr || res_bf16 != nullptr;
    const bool add = out_f32 == nullptr && add_out;
    float r[SG_EPI_ROWS][8];
#pragma unroll
    for (int i = 0; i < SG_EPI_ROWS; ++i) {
      if (!ok[i]) continue;
      if (res_f32 != nullptr)
        load8(res_f32 + o[i], r[i]);
      else if (res || add)
        load8(reinterpret_cast<const bf16*>(&pre[i]), r[i]);
    }
#pragma unroll
    for (int i = 0; i < SG_EPI_ROWS; ++i) {
      if (!ok[i]) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float x = __fadd_rn(__fmul_rn(v[i][k], s[k]), h[k]);
        if (relu) x = fmaxf(x, 0.f);
        if (res) x = __fadd_rn(x, r[i][k]);
        if (add) x = __fadd_rn(r[i][k], x);
        v[i][k] = x;
      }
      if (out_f32 != nullptr)
        store8(out_f32 + o[i], v[i]);
      else
        store8(out_bf16 + o[i], v[i]);
    }
  }
};

// out[split] = acc in f32, stored from the accumulators (no staging): out
// holds one plane a k split, `plane` floats apart, of rows ld floats long.
// Thread rows lr and lr + 8 of the tile (those below tr.rows), columns
// below N; each quad of lanes stores 32 contiguous bytes of a row.
struct F32Epilogue {
  static constexpr bool STAGED = false;
  float* out;
  int ld;
  long long plane;
  template <int BN>
  __device__ __forceinline__ void store(const float (&d)[BN / 2],
                                        const TileRows& tr, int n0, int N,
                                        int split, int lr, int lane) const {
    float* o = out + split * plane + tr.m0 * ld;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= N) continue;
      if (lr < tr.rows)
        *reinterpret_cast<float2*>(o + (long long)lr * ld + col) =
            make_float2(d[4 * j], d[4 * j + 1]);
      if (lr + 8 < tr.rows)
        *reinterpret_cast<float2*>(o + (long long)(lr + 8) * ld + col) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
};

// ------------------------------------------------------------ the ring
template <int BN, class ALoad = DenseA, class Epi = BnEpilogue>
struct SgCfg {
  static constexpr int NB = (BN + 63) / 64;         // 64-column B boxes
  static constexpr int A_BYTES = ALoad::A_BYTES;
  static constexpr int B_BYTES = NB * SG_BK * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;   // a multiple of 1024
  // 1024 bytes of alignment slack, a staged epilogue's two chunks, the
  // barriers.
  static constexpr int EPI_BYTES = Epi::STAGED ? 2 * SG_EPI_BYTES : 0;
  static constexpr int FIXED = 1024 + EPI_BYTES + SG_BARRIER_BYTES;
  static constexpr int FIT = (SG_SMEM_LIMIT - FIXED) / STAGE;
  // The serving GEMMs' ring: as many stages as fit, at most 5.
  static constexpr int STAGES = FIT < 5 ? FIT : 5;
  static constexpr int smem(int stages) { return FIXED + stages * STAGE; }
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(BN % 8 == 0 && BN <= 256 && STAGES >= 2, "column tile");
  static_assert(A_BYTES % 1024 == 0, "A tile");
};

// What a launch computes: N output columns; k from 0 to K in `splits`
// ranges of `chunk` (a multiple of SG_BK), each its own work items and
// output plane; B's slice bz; clusters of cm CTAs; a ring of `stages`.
struct SgShape {
  int N, K, bz, cm, splits, chunk, stages;
};

// A work item as CTA cx of its cluster takes it: row tile mt (the last one
// for a CTA past it, which computes it for its partners and stores
// nothing: real false), first column n0, and k split `split`, whose k
// range starts at k0 and takes nk stages.
struct SgItem {
  int mt;
  bool real;
  int n0, k0, nk, split;
};

template <int BN>
__device__ __forceinline__ SgItem sg_item(const SgShape& s, int mtiles,
                                          int item, int cx) {
  const int nt = (s.N + BN - 1) / BN;
  const int ctiles = (mtiles + s.cm - 1) / s.cm * nt;
  const int split = item / ctiles, ct = item - split * ctiles;
  const int mt = (ct / nt) * s.cm + cx;
  const int k0 = split * s.chunk, k1 = min(s.K, k0 + s.chunk);
  return {min(mt, mtiles - 1), mt < mtiles, (ct % nt) * BN, k0,
          (k1 - k0 + SG_BK - 1) / SG_BK, split};
}

// A position in the ring: its stage and the parity of that stage's pass.
struct RingPos {
  int st = 0;
  int ph = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
  }
};

// --------------------------------------------------------------- kernel
// Clusters of cm CTAs on neighbouring row blocks share each column tile's
// B: CTA x of a cluster loads k-rows x * 64 / cm .. of every B box and
// multicasts them to the others, so a stage of a CTA is written by all of
// its cluster and each consumer warp releases it to all of them. A CTA
// whose row block lies past the last (the last cluster of an odd count)
// loads and multiplies the last row block for its partners and stores
// nothing.
template <int BN, class ALoad, class Epi>
__global__ void __launch_bounds__(SG_THREADS, 1)
    sepconv_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap bmap,
                        const __grid_constant__ ALoad al, const Epi epi,
                        const SgShape sh) {
  using C = SgCfg<BN, ALoad, Epi>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = sh.stages, cm = sh.cm;
  float* stg = reinterpret_cast<float*>(base + S * C::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S * C::STAGE +
                                               C::EPI_BYTES);
  uint64_t* empty = full + S;
  const int mtiles = al.tiles(), nt = (sh.N + BN - 1) / BN;
  const int items = (mtiles + cm - 1) / cm * nt * sh.splits;
  const int cid = blockIdx.x / cm, clusters = gridDim.x / cm;
  const int cx = (int)cluster_ctarank();
  const uint16_t peers = (uint16_t)((1u << cm) - 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], SG_WARPS * cm);
    }
    mbar_init_fence();
  }
  cluster_sync();

  if (threadIdx.x >= SG_CONSUMERS) {
    // Producer: one thread keeps the ring full across work items.
    setmaxnreg_dec<SG_PRODUCER_REGS>();
    if (threadIdx.x == SG_CONSUMERS) {
      prefetch_tensor_map(&amap);
      prefetch_tensor_map(&bmap);
      al.prefetch();
      const int kr = SG_BK / cm;
      RingPos rp;
      for (int item = cid; item < items; item += clusters) {
        const SgItem t = sg_item<BN>(sh, mtiles, item, cx);
        // B boxes wholly past N are not fetched: their columns are never
        // stored.
        const int nb = min(C::NB, (sh.N - t.n0 + 63) / 64);
        for (int kt = 0; kt < t.nk; ++kt, rp.next(S)) {
          mbar_wait(&empty[rp.st], rp.ph ^ 1);
          unsigned char* sa = base + rp.st * C::STAGE;
          const int k = t.k0 + kt * SG_BK;
          // All of the stage's bytes land here, whoever loads them.
          mbar_arrive_expect_tx(&full[rp.st],
                                al.bytes(t.mt) + nb * SG_BK * 128);
          al.load(sa, &amap, t.mt, k, &full[rp.st]);
          for (int b = 0; b < nb; ++b) {
            unsigned char* sb = sa + C::A_BYTES + b * SG_BK * 128;
            if (cm == 1)
              tma_load_3d(sb, &bmap, t.n0 + 64 * b, k, sh.bz, &full[rp.st]);
            else
              tma_load_3d_mc(sb + cx * kr * 128, &bmap, t.n0 + 64 * b,
                             k + cx * kr, sh.bz, &full[rp.st], peers);
          }
        }
      }
      // Stay until every stage has been released by the whole cluster, so
      // that no partner arrives on this CTA's barriers after it has left.
      for (int i = 0; i < S; ++i, rp.next(S))
        mbar_wait(&empty[rp.st], rp.ph ^ 1);
    }
  } else {
    // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of each tile.
    setmaxnreg_inc<SG_CONSUMER_REGS>();
    const int cw = threadIdx.x >> 7;
    const int tid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31, w4 = tid >> 5;
    float* my_stg = stg + cw * 64 * SG_EPI_LD;
    auto release = [&](int st) {
      if (lane == 0)
        for (int r = 0; r < cm; ++r) mbar_arrive_cta(&empty[st], (uint32_t)r);
    };
    // A k-step of 16 in the A descriptor (16-byte units): 32 bytes along a
    // K-major row, 16 rows of 128 bytes MN-major.
    constexpr int A_STEP = ALoad::TA ? 128 : 2;
    // This thread's staged-epilogue slot: 8-column group tid % 8 of each
    // 64-column chunk, rows tid / 8 + 16 i of its warpgroup's 64.
    const int c = 8 * (tid & 7), lr = cw * 64 + (tid >> 3);
    bool pf = false;
    if constexpr (Epi::STAGED) pf = epi.extra_bf16() != nullptr;
    RingPos rp;
    for (int item = cid; item < items; item += clusters) {
      const SgItem t = sg_item<BN>(sh, mtiles, item, cx);
      const TileRows tr = al.rows(t.mt);
      uint4 pre[C::NB][SG_EPI_ROWS];
      if constexpr (Epi::STAGED) {
        if (pf && t.real) {
#pragma unroll
          for (int q = 0; q < C::NB; ++q) {
            const int col = t.n0 + 64 * q + c;
            if (64 * q + c < BN && col < sh.N) epi.prefetch(tr, lr, col, pre[q]);
          }
        }
      }
      float d[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < t.nk; ++kt, rp.next(S)) {
        mbar_wait(&full[rp.st], rp.ph);
        unsigned char* sa = base + rp.st * C::STAGE;
        al.prepare(sa, t.k0 + kt * SG_BK, t.n0, t.real, tr, cw, tid);
        const uint32_t sa32 = smem_u32(sa);
        const uint64_t da = smem_desc(sa32 + cw * 64 * 128);
        // B: 64-column groups of 64 k-rows each, 8 KB apart.
        const uint64_t db = smem_desc(sa32 + C::A_BYTES, SG_BK * 128 / 16);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SG_BK / 16; ++kk)   // 16 k: 16 B rows
          Wgmma<BN, ALoad::TA, 1>::run(d, da + A_STEP * kk, db + 128 * kk);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = rp.st;
      }
      wgmma_wait<0>();
      if (prev >= 0) release(prev);
      if (!t.real) continue;

      // Accumulator layout: warp w4 holds rows 16 w4 .. 16 w4 + 15;
      // d[4j .. 4j + 3] are the m16n8 fragment of columns 8j .. 8j + 7.
      if constexpr (!Epi::STAGED) {
        epi.template store<BN>(d, tr, t.n0, sh.N, t.split,
                               cw * 64 + w4 * 16 + (lane >> 2), lane);
      } else {
        // Staged, 64 columns at a time.
#pragma unroll
        for (int q = 0; q < C::NB; ++q) {
          named_bar_sync(1 + cw, 128);    // the last chunk has been read
#pragma unroll
          for (int j = 8 * q; j < 8 * q + 8; ++j) {
            if (j < BN / 8) {
              const int col = (j - 8 * q) * 8 + 2 * (lane & 3);
              const int row = w4 * 16 + (lane >> 2);
              *reinterpret_cast<float2*>(my_stg + row * SG_EPI_LD + col) =
                  make_float2(d[4 * j], d[4 * j + 1]);
              *reinterpret_cast<float2*>(my_stg + (row + 8) * SG_EPI_LD +
                                         col) =
                  make_float2(d[4 * j + 2], d[4 * j + 3]);
            }
          }
          named_bar_sync(1 + cw, 128);
          const int col = t.n0 + 64 * q + c;
          if (64 * q + c < BN && col < sh.N)
            epi(tr, lr, col, my_stg + (lr - cw * 64) * SG_EPI_LD + c, pre[q]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- launcher
// The launch of the kernel with clusters of cm CTAs and smem bytes a
// block, and how many of its clusters fit on the card at once.
template <int BN, class ALoad, class Epi>
inline cudaError_t sg_configure(int cm, int smem, cudaLaunchConfig_t* cfg,
                                cudaLaunchAttribute* attr, int* fit) {
  auto* kernel = sepconv_gemm_kernel<BN, ALoad, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cm;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cm);
  cfg->blockDim = dim3(SG_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(fit, kernel, cfg);
}

// The launch of a caller that plans its own: `grid` CTAs, every one
// resident at once (the grid is persistent; a grid that does not fit is
// refused, not cut), `smem` bytes a block for sh.stages stages.
template <int BN, class ALoad, class Epi>
inline cudaError_t sepconv_gemm_planned(const CUtensorMap& amap,
                                        const CUtensorMap& bmap,
                                        const ALoad& al, const Epi& epi,
                                        const SgShape& sh, int grid, int smem,
                                        cudaStream_t s) {
  using C = SgCfg<BN, ALoad, Epi>;
  if (sh.stages < 2 || sh.stages > SG_MAX_STAGES ||
      smem != C::smem(sh.stages) || smem > SG_SMEM_LIMIT || sh.cm < 1 ||
      sh.cm > SG_CLUSTER || grid < sh.cm || grid % sh.cm || sh.splits < 1 ||
      sh.chunk < SG_BK || sh.chunk % SG_BK ||
      (long long)sh.splits * sh.chunk < sh.K ||
      (long long)(sh.splits - 1) * sh.chunk >= sh.K)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int fit = 0;
  cudaError_t e = sg_configure<BN, ALoad, Epi>(sh.cm, smem, &cfg, &attr, &fit);
  if (e != cudaSuccess) return e;
  if (grid / sh.cm > fit) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)grid);
  cfg.stream = s;
  return cudaLaunchKernelEx(&cfg, sepconv_gemm_kernel<BN, ALoad, Epi>, amap,
                            bmap, al, epi, sh);
}

// How one serving GEMM runs: its column tile and cluster size. The column
// tile for N output channels is the wider one where it pads fewer columns
// (N = 728: 4 x 184 = 736 against 6 x 128 = 768); clusters pair
// neighbouring row blocks wherever there are two.
struct SgPlan {
  int bn, cm;
};

template <class ALoad>
inline SgPlan sg_plan(const ALoad& al, int N) {
  const int pad128 = (N + 127) / 128 * 128 - N;
  const int pad184 = (N + 183) / 184 * 184 - N;
  return {pad184 < pad128 ? 184 : 128, al.tiles() >= 2 ? SG_CLUSTER : 1};
}

template <int BN, class ALoad>
inline cudaError_t sepconv_gemm_launch(const SgPlan& p,
                                       const CUtensorMap& amap,
                                       const CUtensorMap& bmap,
                                       const ALoad& al, const BnEpilogue& epi,
                                       int N, int K, int bz, cudaStream_t s) {
  using C = SgCfg<BN, ALoad, BnEpilogue>;
  const long long ctiles =
      (long long)((al.tiles() + p.cm - 1) / p.cm) * ((N + BN - 1) / BN);
  if (ctiles == 0) return cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int fit = 0;
  cudaError_t e =
      sg_configure<BN, ALoad, BnEpilogue>(p.cm, C::SMEM, &cfg, &attr, &fit);
  if (e != cudaSuccess) return e;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  // A persistent grid: as many clusters as fit on the card at once.
  cfg.gridDim = dim3((unsigned)((ctiles < fit ? ctiles : fit) * p.cm));
  cfg.stream = s;
  const SgShape sh{N, K, bz, p.cm, 1, (K + SG_BK - 1) / SG_BK * SG_BK,
                   C::STAGES};
  return cudaLaunchKernelEx(&cfg, sepconv_gemm_kernel<BN, ALoad, BnEpilogue>,
                            amap, bmap, al, epi, sh);
}

// out = epi(A . B[bz]) for A as `al` reads it through amap and B the
// (K, N) slice bz of bmap, the maps encoded for the plan p.
template <class ALoad>
inline cudaError_t sepconv_gemm(const SgPlan& p, const CUtensorMap& amap,
                                const CUtensorMap& bmap, const ALoad& al,
                                const BnEpilogue& epi, int N, int K, int bz,
                                cudaStream_t s) {
  return p.bn == 184
             ? sepconv_gemm_launch<184>(p, amap, bmap, al, epi, N, K, bz, s)
             : sepconv_gemm_launch<128>(p, amap, bmap, al, epi, N, K, bz, s);
}

// The plan as SG_REPORT ints: column tile, cluster size, the ring's
// stages, the dynamic shared memory a block, the kernel's registers and
// local (spilled) bytes a thread as the runtime reports them, and the
// blocks resident at once (the persistent grid).
constexpr int SG_REPORT = 7;

template <class ALoad>
inline cudaError_t sepconv_gemm_report(const SgPlan& p, int out[SG_REPORT]) {
  using Wide = SgCfg<184, ALoad, BnEpilogue>;
  using Narrow = SgCfg<128, ALoad, BnEpilogue>;
  cudaFuncAttributes a;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int fit = 0;
  const bool wide = p.bn == 184;
  cudaError_t e =
      wide ? sg_configure<184, ALoad, BnEpilogue>(p.cm, Wide::SMEM, &cfg,
                                                  &attr, &fit)
           : sg_configure<128, ALoad, BnEpilogue>(p.cm, Narrow::SMEM, &cfg,
                                                  &attr, &fit);
  if (e == cudaSuccess)
    e = wide ? cudaFuncGetAttributes(
                   &a, sepconv_gemm_kernel<184, ALoad, BnEpilogue>)
             : cudaFuncGetAttributes(
                   &a, sepconv_gemm_kernel<128, ALoad, BnEpilogue>);
  out[0] = p.bn;
  out[1] = p.cm;
  out[2] = wide ? Wide::STAGES : Narrow::STAGES;
  out[3] = wide ? Wide::SMEM : Narrow::SMEM;
  out[4] = a.numRegs;
  out[5] = (int)a.localSizeBytes;
  out[6] = fit * p.cm;
  return e;
}

// The maps of the operands.
// rows x K bf16 row-major -> DenseA's map.
inline cudaError_t rows_map(CUtensorMap* map, const void* a, long long rows,
                            int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {SG_BK, SG_BM};
  const cuuint32_t es[2] = {1, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, dims,
                         strides, box, es, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Z weights of (K, N) bf16, (in, out) row-major and stacked -> B's map
// (boxes of 64 columns x 64 / cm k-rows).
inline cudaError_t weight_map(CUtensorMap* map, const SgPlan& p, const void* w,
                              int Z, int K, int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)Z};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)(SG_BK / p.cm), 1};
  const cuuint32_t es[3] = {1, 1, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, dims,
                         strides, box, es, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The residual conv's tiles over x (n_img, H, W, C).
inline StridedA strided_rows(int n_img, int H, int W) {
  StridedA g;
  g.H2 = (H + 1) / 2;
  g.W2 = (W + 1) / 2;
  g.wc = g.W2 < SG_BM ? g.W2 : SG_BM;
  g.r = 1;
  if (g.wc == g.W2) {
    g.r = SG_BM / g.W2;
    if (g.r > g.H2) g.r = g.H2;
  }
  g.ni = (g.H2 + g.r - 1) / g.r;
  g.nj = (g.W2 + g.wc - 1) / g.wc;
  g.n_img = n_img;
  return g;
}

// x (n_img, H, W, C) bf16 -> the map of StridedA g.
inline cudaError_t strided_map(CUtensorMap* map, const StridedA& g,
                               const void* x, int H, int W, int C) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)g.n_img};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {SG_BK, (cuuint32_t)(2 * g.wc),
                             (cuuint32_t)(2 * g.r), 1};
  const cuuint32_t es[4] = {1, 2, 2, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims,
                         strides, box, es, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace bt
