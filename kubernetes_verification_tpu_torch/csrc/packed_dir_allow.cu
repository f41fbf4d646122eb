// packed_dir_allow: one direction of the any-port packed reachability solve.
//
//   out[i, w] bit j  =  (sum_p a[p, i] * b[p, 32w + j] > 0)  OR  not_iso(...)
//
// with not_iso taken of the column (default_allow_axis 1, ingress), of the row
// (axis 0, egress) or not at all (axis -1). The int32 counts never leave the
// registers: each block writes only its bit-packed words.
//
// Replaces the Pallas TPU kernel kubernetes_verification_tpu/ops/pallas_kernels.py
// :: packed_dir_allow (body _dir_kernel). That kernel walked the policy axis
// as a sequential grid axis into a VMEM scratch accumulator and packed the
// bits through f32 dots against constant pack matrices, because Mosaic cannot
// do a lane-splitting reshape. Here each tile walks the whole policy axis
// itself (nothing carries between blocks) on the shared Hopper mainloop of
// hopper_int8.cuh: TMA loads into a 4-stage mbarrier ring, two consumer
// warpgroups issuing wgmma m64n256k32 s8.s8 -> s32, persistent blocks in a
// grouped tile order. The pack is done from the accumulator layout: each
// lane ORs its 8 bits of a row's word into place and two shuffles within the
// lane quad finish the word (no shared memory, no ballot per word).
//
// Bound on an H100: compute. The product is 2*P*N^2 int8 operations
// (~2.1e14 at P = 10,000, N = 102,400: ~106 ms at 1,979 dense int8 TOP/s),
// against 2*P*N + N^2/8 bytes (~3.4 GB, ~1 ms at 3.35 TB/s). Block tile
// 128 x 256 (the kernel keeps no per-element state, so the wider tile fits):
// 128 accumulators per consumer thread, 48 KB per ring stage.
//
// Layouts. int8 wgmma takes both operands K-major from shared memory (the
// transpose flags exist only for 16-bit types), so the kernel takes the
// K-contiguous transposes at = a^T and bt = b^T, both int8 [N, P'] row-major
// (the wrapper makes them: one strided copy each).
#include "hopper_int8.cuh"

using namespace hopper_int8;

namespace {

struct DirEpi {
  static constexpr int BN = 256;
  struct Params {
    const int32_t* not_iso;  // [N] (row 0 of the [8, N] vector)
    int32_t* out;            // [N, N/32]
    int axis;                // 1: OR not_iso of the column, 0: of the row
  };
  const Params& p;

  __device__ explicit DirEpi(const Params& params) : p(params) {}
  __device__ void begin_tile() {}
  __device__ bool ends(int) const { return false; }
  __device__ void flush(const int32_t (&)[BN / 2]) {}

  __device__ void finish(const int32_t (&acc)[BN / 2], int row0, int col0,
                         int n) {
    uint32_t word[2][BN / 32];
    pack_rows<BN>(word, [&](int i) { return acc[i] > 0; });
    uint32_t col_free[BN / 32];
#pragma unroll
    for (int q = 0; q < BN / 32; ++q)
      col_free[q] = column_word(p.not_iso, col0 + 32 * q, n, p.axis == 1);
    const int row = row0 + 16 * ((threadIdx.x / 32) % 4) + (threadIdx.x % 32) / 4;
    bool row_free[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_free[h] = p.axis == 0 && __ldg(p.not_iso + row + 8 * h) > 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
        const uint32_t w = quad_or(word[h][q] | col_free[q]);
        word[h][q] = row_free[h] ? 0xffffffffu : w;
      }
    store_rows<BN>(p.out, n, row0, col0, word);
  }
};

}  // namespace

// C entry, bound with ctypes. at, bt: int8 [n, p] row-major (the transposed
// per-policy maps), 16-byte aligned; not_iso: int32 [n]; out: int32
// [n, n/32]. Returns a cudaError_t as int: 0 on a launch that was accepted;
// cudaErrorInvalidValue for shapes the kernel does not take (n a positive
// multiple of 128, p a positive multiple of 64: the wrapper pads the policy
// axis with inert zero columns).
extern "C" int packed_dir_allow_launch(const void* at, const void* bt,
                                       const void* not_iso, void* out, int n,
                                       int p, int axis, void* stream) {
  if (n <= 0 || n % BM || p <= 0 || p % K_STEP) {
    return (int)cudaErrorInvalidValue;
  }
  const DirEpi::Params params{(const int32_t*)not_iso, (int32_t*)out, axis};
  return (int)launch<DirEpi>(at, bt, params, n, p, (cudaStream_t)stream);
}

// Dynamic shared memory per block, for the build report.
extern "C" int packed_dir_allow_smem_bytes() {
  return smem_bytes<DirEpi::BN>();
}
