// fused_ports_reach: the whole port-bitmap reachability of the tiled solve.
//
// The K axis holds the virtual-policy (VP) rows of both directions, in
// segments: [egress ported masks | egress full block | ingress ported masks |
// ingress full block], each padded with zero columns to a 64-column step.
// Row s of the plan ends segment s (in 64-column steps) and names its kind
// and slab. For one (src i, dst j) element, with c the segment's count
// sum_k at[i,k]*bt[j,k]:
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
// stripe that XLA packed. Here each tile walks the whole plan on the shared
// Hopper mainloop of hopper_int8.cuh (TMA into a 4-stage mbarrier ring, two
// consumer warpgroups of 64 x BN issuing wgmma m64nBNk32, a grouped tile
// order; BN = 192 at W = 1, 128 at W = 2), and the mainloop's hook flushes a
// segment at the 64-column step that ends it, which may be the middle of a 128-byte stage:
// wgmma.wait_group 0, then the flush reads the sums, and the segment's next
// wgmma runs with scale-d = 0. The planes are not tiles but bits: every
// consumer thread keeps, for each of its BN / 2 accumulator elements, one state
// value of W 32-bit registers that holds the R + 1 egress planes in bits 0..R
// and gi_any / conj in bits 30 / 31 of the last word (W = 1 for R <= 29,
// W = 2 for R <= 61). The flush is elementwise, so it needs no coordinates.
// The epilogue combines each element's state with di (its bit of a ballot
// over the tile's columns) and de (its row's), and packs the result
// straight from the accumulator layout.
//
// Bound on an H100: compute. The product is 2*K*N^2 int8 operations (~4.2e14
// at K ~ 20,100 real VP rows, N = 102,400: ~213 ms at 1,979 dense int8
// TOP/s), against 2*K'*N + N^2/8 bytes (~5.7 GB, ~1.7 ms at 3.35 TB/s). The
// state costs BN / 2 * W registers beside the BN / 2 accumulators, inside
// the consumers' 232: so the widest tile that fits is 192 at W = 1 and 128
// at W = 2 (the mainloop's rate rises with the tile width:
// scripts/torch_mainloop_sweep.py).
#include "hopper_int8.cuh"

using namespace hopper_int8;

namespace {

constexpr int MAX_R = 61;  // two state words: planes 0..61, flags 62, 63
constexpr uint32_t GI_BIT = 1u << 30;    // in the last state word
constexpr uint32_t CONJ_BIT = 1u << 31;  // in the last state word

// Word w of the W-word mask of the plane bits 0..r.
__device__ __forceinline__ uint32_t plane_bits(int w, int r) {
  const int hi = min(r - 32 * w, 31);  // the word's highest plane bit
  if (hi < 0) return 0u;
  return hi == 31 ? 0xffffffffu : (2u << hi) - 1u;
}

template <int W>
struct FusedEpi {
  // 96 sums + 96 state registers at W = 1; 64 + 128 at W = 2
  static constexpr int BN = W == 1 ? 192 : 128;
  static constexpr int EL = BN / 2;  // accumulator elements per thread
  struct Params {
    const int32_t* plan;  // [n_plan, 3]: segment end in 64-column steps, kind, slab
    int n_plan;
    const unsigned long long* ov;  // [r]
    int r;
    const int32_t* niso_i;  // [N]
    const int32_t* niso_e;  // [N]
    int32_t* out;           // [N, N/32]
    int default_allow;
  };
  const Params& p;
  uint32_t planes[W];  // the plane bits 0..r
  uint32_t st[EL][W];
  int seg;      // the plan row of the running segment
  int seg_end;  // its end, in 64-column steps

  __device__ explicit FusedEpi(const Params& params) : p(params) {
#pragma unroll
    for (int w = 0; w < W; ++w) planes[w] = plane_bits(w, p.r);
  }

  __device__ void begin_tile() {
#pragma unroll
    for (int e = 0; e < EL; ++e)
#pragma unroll
      for (int w = 0; w < W; ++w) st[e][w] = 0u;
    seg = 0;
    seg_end = __ldg(p.plan);
  }

  __device__ bool ends(int step) const { return step + 1 == seg_end; }

  // The flush at the end of one segment, elementwise over the sums. All
  // branches are on block-uniform values (kind, slab, r).
  __device__ void flush(const int32_t (&acc)[EL]) {
    const int kind = __ldg(p.plan + 3 * seg + 1);
    const int slab = __ldg(p.plan + 3 * seg + 2);
    if (kind <= 1) {  // egress: set plane bit `slab`
      uint32_t set[W];
#pragma unroll
      for (int w = 0; w < W; ++w)
        set[w] = (slab >= 0 && slab <= p.r && (slab >> 5) == w)
                     ? 1u << (slab & 31)
                     : 0u;
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        const uint32_t ok = acc[e] > 0 ? 0xffffffffu : 0u;
#pragma unroll
        for (int w = 0; w < W; ++w) st[e][w] |= set[w] & ok;
      }
    } else {  // ingress: gi_any, and conj against the overlapping planes
      uint32_t m[W];
      unsigned long long v = 0ull;
      if (kind == 2 && slab >= 0 && slab < p.r) v = __ldg(p.ov + slab);
#pragma unroll
      for (int w = 0; w < W; ++w)
        m[w] = kind == 3 ? planes[w] : (uint32_t)(v >> (32 * w));
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        if (acc[e] > 0) {
          uint32_t hit = 0u;
#pragma unroll
          for (int w = 0; w < W; ++w) hit |= st[e][w] & m[w];
          st[e][W - 1] |= GI_BIT | (hit ? CONJ_BIT : 0u);
        }
      }
    }
    ++seg;
    seg_end = seg < p.n_plan ? __ldg(p.plan + 3 * seg) : -1;
  }

  // reach = conj | da && (di && (de | ge_any) | de && gi_any) per element,
  // with di the element's bit of the tile's column words (a ballot each)
  // and de its row's; then the lane pack.
  __device__ void finish(const int32_t (&)[EL], int row0, int col0, int n) {
    const bool da = p.default_allow != 0;
    uint32_t di[BN / 32];
#pragma unroll
    for (int q = 0; q < BN / 32; ++q)
      di[q] = column_word(p.niso_i, col0 + 32 * q, n, da);
    const int row = row0 + 16 * ((threadIdx.x / 32) % 4) + (threadIdx.x % 32) / 4;
    bool de[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      de[h] = da && __ldg(p.niso_e + row + 8 * h) > 0;
    uint32_t word[2][BN / 32];
    pack_rows<BN>(word, [&](int e) {
      const uint32_t last = st[e][W - 1];
      uint32_t any = 0u;
#pragma unroll
      for (int w = 0; w < W; ++w) any |= st[e][w] & planes[w];
      const bool col = (di[e / 16] >> elem_bit(e)) & 1u;
      const bool rowe = de[(e % 4) / 2];
      return (last & CONJ_BIT) || (col && (rowe || any)) || (rowe && (last & GI_BIT));
    });
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) word[h][q] = quad_or(word[h][q]);
    store_rows<BN>(p.out, n, row0, col0, word);
  }
};

}  // namespace

// C entry, bound with ctypes. at, bt: int8 [n, p] row-major (the
// K-contiguous src / dst VP rows), 16-byte aligned; plan: int32 [n_plan, 3]
// (segment end in 64-column steps, kind 0..3, slab); ov: uint64 [r]; niso_i,
// niso_e: int32 [n]; out: int32 [n, n/32]. Returns a cudaError_t as int: 0 on
// a launch that was accepted; cudaErrorInvalidValue for shapes the kernel
// does not take (n a positive multiple of 128, p a positive multiple of 64,
// at least one plan row, 0 <= r <= 61).
extern "C" int fused_ports_reach_launch(
    const void* at, const void* bt, const void* plan, const void* ov,
    const void* niso_i, const void* niso_e, void* out, int n, int p,
    int n_plan, int r, int default_allow, void* stream) {
  if (n <= 0 || n % BM || p <= 0 || p % K_STEP || n_plan <= 0 || r < 0 ||
      r > MAX_R) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (r <= 29) {
    const FusedEpi<1>::Params params{
        (const int32_t*)plan, n_plan, (const unsigned long long*)ov, r,
        (const int32_t*)niso_i, (const int32_t*)niso_e, (int32_t*)out,
        default_allow};
    return (int)launch<FusedEpi<1>>(at, bt, params, n, p, s);
  }
  const FusedEpi<2>::Params params{
      (const int32_t*)plan, n_plan, (const unsigned long long*)ov, r,
      (const int32_t*)niso_i, (const int32_t*)niso_e, (int32_t*)out,
      default_allow};
  return (int)launch<FusedEpi<2>>(at, bt, params, n, p, s);
}

// Dynamic shared memory per block of the instantiation with w state words,
// for the build report.
extern "C" int fused_ports_reach_smem_bytes(int w) {
  return w == 1 ? smem_bytes<FusedEpi<1>::BN>() : smem_bytes<FusedEpi<2>::BN>();
}
