// hopper_int8.cuh: the Hopper (sm_90a) int8 mainloop that both kernels of the
// port run on,
//
//   C[m, n] = sum_k at[m, k] * bt[n, k]      int8 x int8 -> int32
//
// over two K-contiguous row-major [N, K'] operands, with a caller's hook that
// can act on the running sums at any 64-column step (a segment flush) and a
// caller's epilogue on the finished tile.
//
// The machine, per block (384 threads, one block per SM, persistent):
// - warpgroup 0 is the producer. After `setmaxnreg.dec` one thread walks the
//   block's tiles and their K stages and issues two TMA loads per stage
//   (`cp.async.bulk.tensor`) into a ring of STAGES shared-memory stages, each
//   one 128-byte swizzle row of K: A a 128 x 128-byte box, B a BN x 128-byte
//   box. A `full` mbarrier per stage counts the bytes in; an `empty` mbarrier
//   per stage counts the eight consumer warps out.
// - warpgroups 1 and 2 are the consumers (`setmaxnreg.inc`), rows 0..63 and
//   64..127 of the block tile. Each waits on `full`, issues four
//   `wgmma.mma_async m64nBNk32.s32.s8.s8` per stage from shared-memory
//   descriptors (K-major, 128-byte swizzle, start address advanced 32 bytes
//   per k32 step), keeps one stage of wgmma in flight, and releases the stage
//   before it. The int32 sums stay in registers: BN / 2 per thread.
// - The roles split in one if / else that never reconverges, so ptxas honours
//   `setmaxnreg` (40 registers for the producer, 232 for the consumers).
// - Tiles run in a grouped order: GROUP_M row tiles by every column tile,
//   row-tile fastest. The ~132 tiles in flight (consecutive tile numbers)
//   then cover GROUP_M row tiles by ~132 / GROUP_M column tiles, so each A
//   row tile is read from device memory about once per group and each B
//   column tile once per GROUP_M consecutive tiles, which start together;
//   the rest come from L2.
// - A K' that ends half-way through a 128-byte stage, and a last column tile
//   past N, read zeros: TMA fills out-of-range boxes with zeros and still
//   counts the whole box's bytes. The half stage's wgmmas are skipped; the
//   epilogue masks columns past N.
//
// The caller's hook, an `Epi` type, per consumer thread:
//   static constexpr int BN;  struct Params;   // BN: 128, 192 or 256
//   __device__ Epi(const Params&);
//   __device__ void begin_tile();                      // before a tile's K walk
//   __device__ bool ends(int step);                    // 64-column step `step`
//                                                      // ends a group of K?
//   __device__ void flush(const int32_t (&acc)[BN/2]); // then: the group's sums
//   __device__ void finish(const int32_t (&acc)[BN/2], int row0, int col0, int n);
// After `flush` the next wgmma runs with scale-d = 0: each group's sums start
// from zero without a fill. `ends` is false for a plain product.
//
// Accumulator coordinates (the wgmma D fragment): element i of lane l in warp
// w of a consumer warpgroup is row 16w + l/4 + 8((i%4)/2) and column
// 8(i/4) + 2(l%4) + i%2 of the warpgroup's 64 x BN tile. `pack_rows` and
// `quad_or` turn one boolean per element into the tile's little-endian words
// (bit j of word q is column 32q + j) without shared memory.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper_int8 {

constexpr int BM = 128;      // rows per block tile: two consumer warpgroups
constexpr int BK = 128;      // K bytes per ring stage: one swizzle row
constexpr int K_STEP = 64;   // the callers' K granularity: two k32 wgmmas
// row tiles per group of the tile order (1: row-major, column tile fastest,
// the order without grouping; scripts/torch_mainloop_sweep.py times both)
#ifndef HOPPER_INT8_GROUP_M
#define HOPPER_INT8_GROUP_M 8
#endif
constexpr int GROUP_M = HOPPER_INT8_GROUP_M;
// ring stages: 4 measured fastest at every tile width on the H100 (more
// stages ran slower; scripts/torch_mainloop_sweep.py times other counts)
#ifndef HOPPER_INT8_STAGES
#define HOPPER_INT8_STAGES 4
#endif
constexpr int STAGES = HOPPER_INT8_STAGES;
constexpr int THREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

template <int BN>
struct Ring {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  uint8_t a[STAGES][A_BYTES];  // every tile starts on a 1024-byte boundary
  uint8_t b[STAGES][B_BYTES];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// Dynamic shared memory a kernel of this shape asks for: the ring, and room
// to align it to 1024 bytes (the 128-byte swizzle pattern's period).
template <int BN>
constexpr int smem_bytes() {
  return (int)sizeof(Ring<BN>) + 1024;
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of `bar` has completed. A wait that
// lasts seconds means a lost arrival: trap (the launch fails) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - t0 > 8000000000ll) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One TMA box of a 2-D map into shared memory; `k` is the inner (K byte)
// coordinate, `row` the outer one. Completion counts into `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// The smem descriptor of a K-major tile written by TMA with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across a
// wgmma fence, commit or wait.
template <int N>
__device__ __forceinline__ void fence_acc(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The accumulator operands of one wgmma: C is "+r" (read and written) or
// "=r" (written only: scale-d is 0 and the old sums are dead, so they need
// not stay live across an epilogue).
#define KV_D8(C, i)                                                  \
  C(d[(i) + 0]), C(d[(i) + 1]), C(d[(i) + 2]), C(d[(i) + 3]),        \
      C(d[(i) + 4]), C(d[(i) + 5]), C(d[(i) + 6]), C(d[(i) + 7])
#define KV_D64(C)                                                    \
  KV_D8(C, 0), KV_D8(C, 8), KV_D8(C, 16), KV_D8(C, 24), KV_D8(C, 32), \
      KV_D8(C, 40), KV_D8(C, 48), KV_D8(C, 56)
#define KV_D96(C) \
  KV_D64(C), KV_D8(C, 64), KV_D8(C, 72), KV_D8(C, 80), KV_D8(C, 88)
#define KV_D128(C) \
  KV_D96(C), KV_D8(C, 96), KV_D8(C, 104), KV_D8(C, 112), KV_D8(C, 120)
#define KV_R64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define KV_R96 \
  KV_R64 \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, " \
  "%90, %91, %92, %93, %94, %95"
#define KV_R128 \
  KV_R96 \
  ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, " \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127"
#define KV_WGMMA(SHAPE, REGS, DA, DB, SCALE)                          \
  "{\n .reg .pred p;\n setp.ne.b32 p, " SCALE ", 0;\n"                 \
  "wgmma.mma_async.sync.aligned." SHAPE ".s32.s8.s8 {" REGS "}, " DA \
  ", " DB ", p;\n}\n"
// One width: ACC false overwrites d (scale-d 0), ACC true adds to it.
#define KV_MMA(N, R, SHAPE, REGS, DA, DB, SCALE)                         \
  template <>                                                           \
  struct Mma<N> {                                                       \
    template <bool ACC>                                                 \
    static __device__ __forceinline__ void run(int32_t (&d)[R],         \
                                               uint64_t da, uint64_t db) { \
      if (ACC)                                                          \
        asm volatile(KV_WGMMA(SHAPE, REGS, DA, DB, SCALE)               \
                     : KV_D##R("+r")                                    \
                     : "l"(da), "l"(db), "r"(1));                       \
      else                                                              \
        asm volatile(KV_WGMMA(SHAPE, REGS, DA, DB, SCALE)               \
                     : KV_D##R("=r")                                    \
                     : "l"(da), "l"(db), "r"(0));                       \
    }                                                                   \
  };

// d (+)= A[64 x 32] * B[N x 32]^T, A and B K-major in shared memory; N is
// the block tile's width.
template <int N>
struct Mma;
KV_MMA(128, 64, "m64n128k32", KV_R64, "%64", "%65", "%66")
KV_MMA(192, 96, "m64n192k32", KV_R96, "%96", "%97", "%98")
KV_MMA(256, 128, "m64n256k32", KV_R128, "%128", "%129", "%130")

#undef KV_MMA
#undef KV_WGMMA
#undef KV_R128
#undef KV_R96
#undef KV_R64
#undef KV_D128
#undef KV_D96
#undef KV_D64
#undef KV_D8

// ---------------------------------------------------------------------------
// Tile order and the epilogue's lane pack
// ---------------------------------------------------------------------------

// Tile t -> (row tile, column tile): groups of GROUP_M row tiles (the last
// group may be smaller) by every column tile, row tile fastest.
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n,
                                            int& tm, int& tn) {
  const int per_group = GROUP_M * tiles_n;
  const int first = (t / per_group) * GROUP_M;
  const int size = min(tiles_m - first, GROUP_M);
  const int r = t % per_group;
  tm = first + r % size;
  tn = r / size;
}

// This thread's share of its two rows' words (rows l/4 and l/4 + 8 of its
// warp's 16): bit 8((i/4)%4) + 2(l%4) + i%2 of word[(i%4)/2][i/16] is
// pred(i), the element's boolean. The other three lanes of the quad (same
// l/4) hold the word's other bits.
// The bit of accumulator element i of this lane in its row's word i / 16.
__device__ __forceinline__ int elem_bit(int i) {
  return 8 * ((i / 4) % 4) + 2 * (int)(threadIdx.x % 4) + i % 2;
}

template <int BN, class Pred>
__device__ __forceinline__ void pack_rows(uint32_t (&word)[2][BN / 32],
                                          Pred pred) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) word[h][q] = 0u;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    word[(i % 4) / 2][i / 16] |= (pred(i) ? 1u : 0u) << (8 * ((i / 4) % 4) + i % 2);
  const int shift = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) word[h][q] <<= shift;
}

// OR over the four lanes of a quad: every lane gets the whole word. All 32
// lanes of the warp must call it.
__device__ __forceinline__ uint32_t quad_or(uint32_t v) {
  v |= __shfl_xor_sync(0xffffffffu, v, 1);
  v |= __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The word of columns col0 .. col0 + 31: bit j is v[col0 + j] > 0 (0 past
// n). All 32 lanes of the warp must call it.
__device__ __forceinline__ uint32_t column_word(const int32_t* __restrict__ v,
                                                int col0, int n, bool on) {
  const int col = col0 + (int)(threadIdx.x % 32);
  return __ballot_sync(0xffffffffu, on && col < n && __ldg(v + col) > 0);
}

// Store the finished words of the warpgroup tile at (row0, col0) into
// out[n, n/32]: lane l stores word q of both its rows where q % 4 == l % 4,
// and no word past column n.
template <int BN>
__device__ __forceinline__ void store_rows(int32_t* __restrict__ out, int n,
                                           int row0, int col0,
                                           const uint32_t (&word)[2][BN / 32]) {
  const int lane = threadIdx.x % 32;
  const int row = row0 + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const size_t wpr = (size_t)(n / 32);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < BN / 32; ++q)
      if (q % 4 == lane % 4 && col0 + 32 * q < n)
        out[(size_t)(row + 8 * h) * wpr + col0 / 32 + q] = (int32_t)word[h][q];
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    int8_kernel(__grid_constant__ const CUtensorMap map_a,
                __grid_constant__ const CUtensorMap map_b,
                __grid_constant__ const typename Epi::Params params, int n,
                int kp) {
  constexpr int BN = Epi::BN;
  using R = Ring<BN>;
  extern __shared__ uint8_t smem_raw[];
  R& ring = *reinterpret_cast<R*>(smem_raw +
                                  ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int wg = threadIdx.x / 128;
  const int steps = kp / K_STEP;        // 64-column steps
  const int kstages = (steps + 1) / 2;  // 128-byte ring stages
  const int tiles_m = n / BM;
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        tile_coords(t, tiles_m, tiles_n, tm, tn);
        for (int ks = 0; ks < kstages; ++ks) {
          mbar_wait(&ring.empty[stage], phase ^ 1);
          mbar_expect_tx(&ring.full[stage], R::STAGE_BYTES);
          tma_load(ring.a[stage], &map_a, &ring.full[stage], ks * BK, tm * BM);
          tma_load(ring.b[stage], &map_b, &ring.full[stage], ks * BK, tn * BN);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - 1;  // rows 64c .. 64c + 63 of the block tile
    const bool releaser = threadIdx.x % 32 == 0;
    Epi epi(params);
    int32_t acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      tile_coords(t, tiles_m, tiles_n, tm, tn);
      epi.begin_tile();
      bool zero = true;  // the next wgmma starts its sums from zero
      int held = -1;     // the stage whose wgmmas may still be running
      for (int ks = 0; ks < kstages; ++ks) {
        mbar_wait(&ring.full[stage], phase);
        const uint64_t da = sw128_desc(ring.a[stage] + c * 64 * BK);
        const uint64_t db = sw128_desc(ring.b[stage]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int step = 2 * ks + h;
          if (step < steps) {
            // k32 groups 2h and 2h + 1 of the stage: 64h and 64h + 32 bytes
            // into each 128-byte row (descriptor units of 16 bytes)
            fence_acc(acc);
            wgmma_fence();
            if (zero)
              Mma<BN>::template run<false>(acc, da + 4 * h, db + 4 * h);
            else
              Mma<BN>::template run<true>(acc, da + 4 * h, db + 4 * h);
            Mma<BN>::template run<true>(acc, da + 4 * h + 2, db + 4 * h + 2);
            zero = false;
            if (epi.ends(step)) {
              wgmma_commit();
              wgmma_wait<0>();
              fence_acc(acc);
              epi.flush(acc);
              zero = true;
            }
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // every stage before this one is read
        fence_acc(acc);
        if (held >= 0 && releaser) mbar_arrive(&ring.empty[held]);
        held = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (releaser) mbar_arrive(&ring.empty[held]);
      epi.finish(acc, tm * BM + 64 * c, tn * BN, n);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A TMA map over a row-major int8 [rows, kp] operand in device memory: boxes
// of box_rows x 128 K bytes, 128-byte swizzle, zero fill out of range.
// cuTensorMapEncodeTiled is a driver function: fetched through the runtime,
// so the library needs no link against libcuda.
inline bool make_kmajor_map(CUtensorMap* map, const void* ptr, int rows, int kp,
                            int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess)
      return false;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                &found) != cudaSuccess)
      return false;
#endif
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp};  // bytes between rows
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch int8_kernel<Epi> over at, bt int8 [n, kp] (n a multiple of BM, kp
// of K_STEP, both 16-byte aligned): one block per SM, at most one per tile.
// Returns a cudaError_t.
template <class Epi>
inline cudaError_t launch(const void* at, const void* bt,
                          const typename Epi::Params& params, int n, int kp,
                          cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!make_kmajor_map(&map_a, at, n, kp, BM) ||
      !make_kmajor_map(&map_b, bt, n, kp, Epi::BN))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<Epi::BN>();
  cudaError_t err = cudaFuncSetAttribute(
      int8_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  const int tiles = (n / BM) * ((n + Epi::BN - 1) / Epi::BN);
  int8_kernel<Epi><<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(
      map_a, map_b, params, n, kp);
  return cudaGetLastError();
}

}  // namespace hopper_int8
