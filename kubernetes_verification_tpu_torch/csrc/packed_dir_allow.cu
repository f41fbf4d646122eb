// packed_dir_allow: one direction of the any-port packed reachability solve.
//
//   out[i, w] bit j  =  (sum_p a[p, i] * b[p, 32w + j] > 0)  OR  not_iso(...)
//
// with not_iso taken of the column (default_allow_axis 1, ingress), of the row
// (axis 0, egress) or not at all (axis -1). The int32 counts never leave the
// block: each block writes only its bit-packed words.
//
// Replaces the Pallas TPU kernel kubernetes_verification_tpu/ops/pallas_kernels.py
// :: packed_dir_allow (body _dir_kernel). That kernel walked the policy axis
// as a sequential grid axis into a VMEM scratch accumulator and packed the
// bits through f32 dots against constant pack matrices, because Mosaic cannot
// do a lane-splitting reshape. Here a block owns one TM x TN output tile and
// loops over the whole policy axis itself (nothing carries between blocks),
// and the pack is a warp ballot: 32 lanes hold 32 consecutive columns of one
// row, and __ballot_sync returns the finished little-endian word.
//
// Bound on an H100: compute. The product is 2*P*N^2 int8 operations
// (~2.1e14 at P = 10,000, N = 102,400: ~106 ms at 1,979 dense int8 TOP/s),
// against 2*P*N + N^2/8 bytes (~3.4 GB, ~1 ms at 3.35 TB/s). This first
// design takes the plain road to the tensor cores: WMMA int8 16x16x16
// fragments with int32 accumulators, operand tiles staged in shared memory
// with one register-prefetched stage; no wgmma, no TMA, no warp
// specialisation.
//
// Layouts. Int8 tensor-core products exist only as row.col (A K-contiguous
// by row, B K-contiguous by column); WMMA emulates any other layout with
// slow fragment loads (measured on the H100: a first version that loaded A
// col_major / B row_major straight from the [P, N] maps ran at 146 TOP/s).
// So the kernel takes the K-contiguous transposes at = a^T and bt = b^T,
// both int8 [N, P'] row-major (the wrapper makes them: one strided copy
// each), and loads A(m, k) = at[m, k] as a row_major matrix_a fragment and
// B(k, n) = bt[n, k] as a col_major matrix_b fragment. In shared memory
// each operand stage is TK/16 blocks of [rows][16] bytes: every fragment
// then starts on a 32-byte boundary (WMMA requires it) and a fragment load
// reads 256 contiguous bytes. The blocks are skewed by 32 bytes, which
// makes the staging stores conflict-free.
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 128;  // output rows per block
constexpr int TN = 128;  // output columns per block (TN / 32 words)
constexpr int TK = 64;   // policy rows per shared-memory stage
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = TM / WARPS_M;  // 32 rows per warp
constexpr int WN = TN / WARPS_N;  // 64 columns per warp
constexpr int FM = WM / 16;
constexpr int FN = WN / 16;
constexpr int KB_STRIDE = TM * 16 + 32;  // bytes per 16-deep k block
constexpr int TILE_BYTES = (TK / 16) * KB_STRIDE;  // one operand stage
constexpr int EPI_LD = WN + 4;                  // int32 per staged row
constexpr int EPI_WARP = 16 * EPI_LD;           // int32 per warp's stage
constexpr int EPI_BYTES = WARPS_M * WARPS_N * EPI_WARP * 4;
constexpr int SMEM_BYTES =
    (2 * TILE_BYTES > EPI_BYTES) ? 2 * TILE_BYTES : EPI_BYTES;
constexpr int CHUNKS = TM * (TK / 16);  // 16-byte chunks per operand stage
constexpr int LOADS = CHUNKS / THREADS;

static_assert(TM == TN, "the staging layout assumes square tiles");
static_assert(CHUNKS % THREADS == 0, "whole chunks per thread");
static_assert(KB_STRIDE % 32 == 0, "fragments must start 32-byte aligned");
static_assert((EPI_WARP * 4) % 32 == 0, "staged fragments 32-byte aligned");

// One operand stage: rows row0.. row0+TM of a K-contiguous [N, p] matrix,
// columns k0 .. k0+TK; chunk c is (row c / (TK/16), k block c % (TK/16)),
// so four neighbouring threads read one row's 64 contiguous bytes.
__device__ __forceinline__ void load_stage(
    const int8_t* __restrict__ src, int p, int k0, int row0, int tid,
    int4 (&reg)[LOADS]) {
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int c = tid + l * THREADS;
    const int row = c / (TK / 16);
    const int kb = c % (TK / 16);
    reg[l] = *reinterpret_cast<const int4*>(
        src + (size_t)(row0 + row) * p + k0 + kb * 16);
  }
}

__device__ __forceinline__ void store_stage(
    int8_t* dst, int tid, const int4 (&reg)[LOADS]) {
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int c = tid + l * THREADS;
    const int row = c / (TK / 16);
    const int kb = c % (TK / 16);
    *reinterpret_cast<int4*>(dst + kb * KB_STRIDE + row * 16) = reg[l];
  }
}

__global__ void __launch_bounds__(THREADS) packed_dir_allow_kernel(
    const int8_t* __restrict__ at, const int8_t* __restrict__ bt,
    const int32_t* __restrict__ not_iso, int32_t* __restrict__ out, int n,
    int p, int axis) {
  __shared__ __align__(128) int8_t smem[SMEM_BYTES];
  int8_t* As = smem;
  int8_t* Bs = smem + TILE_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  int4 ra[LOADS], rb[LOADS];
  load_stage(at, p, 0, m0, tid, ra);
  load_stage(bt, p, 0, n0, tid, rb);
  for (int k0 = 0; k0 < p; k0 += TK) {
    store_stage(As, tid, ra);
    store_stage(Bs, tid, rb);
    __syncthreads();
    if (k0 + TK < p) {  // next stage in flight while this one multiplies
      load_stage(at, p, k0 + TK, m0, tid, ra);
      load_stage(bt, p, k0 + TK, n0, tid, rb);
    }
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major>
          fb[FN];
      const int kb = kk / 16;
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(
            fa[i],
            reinterpret_cast<const signed char*>(
                As + kb * KB_STRIDE + (wm * FM + i) * 256),
            16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(
            fb[j],
            reinterpret_cast<const signed char*>(
                Bs + kb * KB_STRIDE + (wn * FN + j) * 256),
            16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: stage 16 rows x WN columns of counts per warp, threshold,
  // OR in not_iso, and ballot each row's 32-column halves into words.
  int32_t* stage = reinterpret_cast<int32_t*>(smem) + warp * EPI_WARP;
  const int wcol0 = n0 + wn * WN;  // first column of this warp
  bool col_free[WN / 32];
#pragma unroll
  for (int h = 0; h < WN / 32; ++h)
    col_free[h] = axis == 1 && not_iso[wcol0 + h * 32 + lane] > 0;
  const int words_per_row = n / 32;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(stage + j * 16, acc[i][j], EPI_LD,
                              wmma::mem_row_major);
    __syncwarp();
    const int row0 = m0 + wm * WM + i * 16;
    int32_t mine = 0;  // lane l keeps the word of (row l / 2, half l % 2)
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const bool row_free = axis == 0 && not_iso[row0 + r] > 0;
#pragma unroll
      for (int h = 0; h < WN / 32; ++h) {
        const bool ok =
            stage[r * EPI_LD + h * 32 + lane] > 0 || col_free[h] || row_free;
        const unsigned word = __ballot_sync(0xffffffffu, ok);
        if (lane == r * (WN / 32) + h) mine = (int32_t)word;
      }
    }
    const int r = lane / (WN / 32);
    const int h = lane % (WN / 32);
    out[(size_t)(row0 + r) * words_per_row + wcol0 / 32 + h] = mine;
    __syncwarp();
  }
}

}  // namespace

// C entry, bound with ctypes. at, bt: int8 [n, p] row-major (the
// transposed per-policy maps); not_iso: int32 [n]; out: int32 [n, n/32].
// Returns a cudaError_t as int: 0 on a launch that was accepted;
// cudaErrorInvalidValue for shapes the kernel does not take (n a positive
// multiple of TM and TN, p a positive multiple of TK: the wrapper pads the
// policy axis with inert zero columns).
extern "C" int packed_dir_allow_launch(const void* at, const void* bt,
                                       const void* not_iso, void* out, int n,
                                       int p, int axis, void* stream) {
  if (n <= 0 || n % TM || n % TN || p <= 0 || p % TK) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(n / TN, n / TM);
  packed_dir_allow_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)at, (const int8_t*)bt, (const int32_t*)not_iso,
      (int32_t*)out, n, p, axis);
  return (int)cudaGetLastError();
}
