// fused_ports_reach: the whole port-bitmap reachability of the tiled solve.
//
// The K axis holds the virtual-policy (VP) rows of both directions, in
// segments: [egress ported masks | egress full block | ingress ported masks |
// ingress full block], each padded with zero columns to a TK multiple. Row s
// of the plan ends segment s (in TK steps) and names its kind and slab. For
// one (src i, dst j) element, with c the segment's count sum_k at[i,k]*bt[j,k]:
//
//   egress segment, slab m (m = R: the full block):  plane_m  |= c > 0
//   ingress segment, ported mask m:   gi_any |= c > 0
//                                     conj   |= c > 0 && (planes & ov[m]) != 0
//   ingress full block:               gi_any |= c > 0
//                                     conj   |= c > 0 && any plane
//
// and at the end reach = conj | da && ((di && de) | (di && ge_any) |
// (de && gi_any)), with ge_any = any plane, di = niso_i[j], de = niso_e[i].
// Bit j % 32 of out[i, j / 32] is reach (little-endian words). ov[m] has bit
// R set: the full egress block overlaps every mask.
//
// Replaces the Pallas TPU kernel kubernetes_verification_tpu/ops/
// pallas_kernels.py :: fused_ports_stripe (body _fused_ports_kernel). That
// kernel walked K as a sequential grid axis, kept one int32 count scratch
// plus R + 4 int8 [tm, TN] planes in VMEM, and returned an int8 [N, TN]
// stripe that XLA packed. Here one block owns one TM x TN output tile and
// walks the whole plan itself (blocks run in no order, so nothing carries
// between them). The planes are not tiles but bits: every thread keeps, for
// each of its accumulator elements, one state value of W 32-bit words that
// holds the R + 1 egress planes in bits 0..R and gi_any / conj in bits 30 /
// 31 of the last word (W = 1 for R <= 29, W = 2 for R <= 61). A flush is
// elementwise over the accumulator fragments, which all share one element
// mapping, so the state never needs to know the fragment layout. The epilogue
// writes each element's conj / ge_any / gi_any into its fragment, stores the
// fragments to shared memory where they land at their (row, column), applies
// di and de, and packs with a warp ballot as packed_dir_allow.cu does.
//
// Bound on an H100: compute. The product is 2*K*N^2 int8 operations (~4.2e14
// at K ~ 20,300 VP rows, N = 102,400: ~215 ms at 1,979 dense int8 TOP/s),
// against 2*K'*N + N^2/8 bytes (~5.7 GB, ~1.7 ms at 3.35 TB/s). The first
// design keeps packed_dir_allow's plain road to the tensor cores: WMMA int8
// 16x16x16 fragments with int32 accumulators on K-contiguous operands
// (at, bt int8 [N, K'] row-major: A(m, k) = at[m, k] row_major, B(k, n) =
// bt[n, k] col_major, the only fast int8 layout), skewed shared-memory
// stages and one register-prefetched stage; no wgmma, no TMA. The state costs
// 64 * W registers beside the 64 accumulators.
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 128;  // output rows per block
constexpr int TN = 128;  // output columns per block (TN / 32 words)
constexpr int TK = 64;   // K columns per shared-memory stage
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = TM / WARPS_M;  // 32 rows per warp
constexpr int WN = TN / WARPS_N;  // 64 columns per warp
constexpr int FM = WM / 16;
constexpr int FN = WN / 16;
constexpr int EL = 8;  // elements of a 16x16 int accumulator per thread
constexpr int KB_STRIDE = TM * 16 + 32;  // bytes per 16-deep k block
constexpr int TILE_BYTES = (TK / 16) * KB_STRIDE;  // one operand stage
constexpr int EPI_LD = WN + 4;                  // int32 per staged row
constexpr int EPI_WARP = 16 * EPI_LD;           // int32 per warp's stage
constexpr int EPI_BYTES = WARPS_M * WARPS_N * EPI_WARP * 4;
constexpr int SMEM_BYTES =
    (2 * TILE_BYTES > EPI_BYTES) ? 2 * TILE_BYTES : EPI_BYTES;
constexpr int CHUNKS = TM * (TK / 16);  // 16-byte chunks per operand stage
constexpr int LOADS = CHUNKS / THREADS;
constexpr int MAX_R = 61;  // two state words: planes 0..61, flags 62, 63
constexpr uint32_t GI_BIT = 1u << 30;    // in the last state word
constexpr uint32_t CONJ_BIT = 1u << 31;  // in the last state word

static_assert(TM == TN, "the staging layout assumes square tiles");
static_assert(CHUNKS % THREADS == 0, "whole chunks per thread");
static_assert(KB_STRIDE % 32 == 0, "fragments must start 32-byte aligned");
static_assert((EPI_WARP * 4) % 32 == 0, "staged fragments 32-byte aligned");

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;
static_assert(Acc::num_elements == EL, "8 accumulator elements per thread");

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

// Word w of the W-word mask of the plane bits 0..r.
__device__ __forceinline__ uint32_t plane_bits(int w, int r) {
  const int hi = min(r - 32 * w, 31);  // the word's highest plane bit
  if (hi < 0) return 0u;
  return hi == 31 ? 0xffffffffu : (2u << hi) - 1u;
}

// The flush at the end of one segment, elementwise over the accumulators,
// then the accumulators are zeroed for the next segment. All branches are on
// block-uniform values (kind, slab, r).
template <int W>
__device__ __forceinline__ void flush(
    Acc (&acc)[FM][FN], uint32_t (&st)[FM][FN][EL][W], int kind, int slab,
    int r, const unsigned long long* __restrict__ ov,
    const uint32_t (&planes)[W]) {
  if (kind <= 1) {  // egress: set plane bit `slab`
    uint32_t set[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
      set[w] = (slab >= 0 && slab <= r && (slab >> 5) == w)
                   ? 1u << (slab & 31)
                   : 0u;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const uint32_t ok = acc[i][j].x[e] > 0 ? 0xffffffffu : 0u;
#pragma unroll
          for (int w = 0; w < W; ++w) st[i][j][e][w] |= set[w] & ok;
        }
  } else {  // ingress: gi_any, and conj against the overlapping planes
    uint32_t m[W];
    unsigned long long v = 0ull;
    if (kind == 2 && slab >= 0 && slab < r) v = __ldg(ov + slab);
#pragma unroll
    for (int w = 0; w < W; ++w)
      m[w] = kind == 3 ? planes[w] : (uint32_t)(v >> (32 * w));
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          if (acc[i][j].x[e] > 0) {
            uint32_t hit = 0u;
#pragma unroll
            for (int w = 0; w < W; ++w) hit |= st[i][j][e][w] & m[w];
            st[i][j][e][W - 1] |= GI_BIT | (hit ? CONJ_BIT : 0u);
          }
        }
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);
}

template <int W>
__global__ void __launch_bounds__(THREADS) fused_ports_reach_kernel(
    const int8_t* __restrict__ at, const int8_t* __restrict__ bt,
    const int32_t* __restrict__ plan, int n_plan,
    const unsigned long long* __restrict__ ov, int r,
    const int32_t* __restrict__ niso_i, const int32_t* __restrict__ niso_e,
    int32_t* __restrict__ out, int n, int p, int default_allow) {
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

  uint32_t planes[W];  // the plane bits 0..r
#pragma unroll
  for (int w = 0; w < W; ++w) planes[w] = plane_bits(w, r);

  Acc acc[FM][FN];
  uint32_t st[FM][FN][EL][W];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(acc[i][j], 0);
#pragma unroll
      for (int e = 0; e < EL; ++e)
#pragma unroll
        for (int w = 0; w < W; ++w) st[i][j][e][w] = 0u;
    }

  int seg = 0;
  int seg_end = __ldg(plan) * TK;  // K index where segment `seg` ends
  int4 ra[LOADS], rb[LOADS];
  load_stage(at, p, 0, m0, tid, ra);
  load_stage(bt, p, 0, n0, tid, rb);
  for (int k0 = 0; k0 < p; k0 += TK) {
    store_stage(As, tid, ra);
    store_stage(Bs, tid, rb);
    __syncthreads();
    // The next stage may belong to the next segment: it only goes into
    // registers here, and this segment's flush below follows its last mma.
    if (k0 + TK < p) {
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
    if (k0 + TK == seg_end) {
      flush<W>(acc, st, __ldg(plan + 3 * seg + 1), __ldg(plan + 3 * seg + 2),
               r, ov, planes);
      ++seg;
      seg_end = seg < n_plan ? __ldg(plan + 3 * seg) * TK : -1;
    }
    __syncthreads();
  }

  // Epilogue: each element's conj (bit 0), ge_any (bit 1) and gi_any (bit
  // 2) go into its accumulator fragment, which lands at its (row, column)
  // in the warp's shared-memory stage; then di / de and the ballot pack.
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        uint32_t any = 0u;
#pragma unroll
        for (int w = 0; w < W; ++w) any |= st[i][j][e][w] & planes[w];
        const uint32_t last = st[i][j][e][W - 1];
        acc[i][j].x[e] = (int)(((last & CONJ_BIT) ? 1u : 0u) |
                               (any ? 2u : 0u) |
                               ((last & GI_BIT) ? 4u : 0u));
      }
  int32_t* stage = reinterpret_cast<int32_t*>(smem) + warp * EPI_WARP;
  const int wcol0 = n0 + wn * WN;  // first column of this warp
  bool col_free[WN / 32];
#pragma unroll
  for (int h = 0; h < WN / 32; ++h)
    col_free[h] = default_allow && niso_i[wcol0 + h * 32 + lane] > 0;
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
    for (int rr = 0; rr < 16; ++rr) {
      const bool row_free = default_allow && niso_e[row0 + rr] > 0;
#pragma unroll
      for (int h = 0; h < WN / 32; ++h) {
        const int v = stage[rr * EPI_LD + h * 32 + lane];
        const bool di = col_free[h];
        const bool ok = (v & 1) || (di && row_free) || (di && (v & 2)) ||
                        (row_free && (v & 4));
        const unsigned word = __ballot_sync(0xffffffffu, ok);
        if (lane == rr * (WN / 32) + h) mine = (int32_t)word;
      }
    }
    const int rr = lane / (WN / 32);
    const int h = lane % (WN / 32);
    out[(size_t)(row0 + rr) * words_per_row + wcol0 / 32 + h] = mine;
    __syncwarp();
  }
}

}  // namespace

// C entry, bound with ctypes. at, bt: int8 [n, p] row-major (the
// K-contiguous src / dst VP rows); plan: int32 [n_plan, 3] (segment end in
// TK steps, kind 0..3, slab); ov: uint64 [r]; niso_i, niso_e: int32 [n];
// out: int32 [n, n/32]. Returns a cudaError_t as int: 0 on a launch that was
// accepted; cudaErrorInvalidValue for shapes the kernel does not take (n a
// positive multiple of TM and TN, p a positive multiple of TK, at least one
// plan row, 0 <= r <= 61).
extern "C" int fused_ports_reach_launch(
    const void* at, const void* bt, const void* plan, const void* ov,
    const void* niso_i, const void* niso_e, void* out, int n, int p,
    int n_plan, int r, int default_allow, void* stream) {
  if (n <= 0 || n % TM || n % TN || p <= 0 || p % TK || n_plan <= 0 || r < 0 ||
      r > MAX_R) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(n / TN, n / TM);
  cudaStream_t s = (cudaStream_t)stream;
  if (r <= 29) {
    fused_ports_reach_kernel<1><<<grid, THREADS, 0, s>>>(
        (const int8_t*)at, (const int8_t*)bt, (const int32_t*)plan, n_plan,
        (const unsigned long long*)ov, r, (const int32_t*)niso_i,
        (const int32_t*)niso_e, (int32_t*)out, n, p, default_allow);
  } else {
    fused_ports_reach_kernel<2><<<grid, THREADS, 0, s>>>(
        (const int8_t*)at, (const int8_t*)bt, (const int32_t*)plan, n_plan,
        (const unsigned long long*)ov, r, (const int32_t*)niso_i,
        (const int32_t*)niso_e, (int32_t*)out, n, p, default_allow);
  }
  return (int)cudaGetLastError();
}
