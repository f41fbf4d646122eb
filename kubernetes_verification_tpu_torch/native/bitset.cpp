// Packed-bitset verification kernels — the native engine of the framework.
//
// The reference delegates all heavy bit work to third-party natives: the
// `bitarray` C extension for the kano matrix build (kano_py/kano/model.py:
// 128-163, algorithm.py throughout) and z3's C++ Datalog engine for the
// kubesv solve (kubesv/kubesv/constraint.py:114-133). This file is the
// framework-owned equivalent: sets over pods/label-pairs are packed into
// uint64 words and every hot loop — subset/disjoint/any-intersect selector
// tests, the OR-scatter matrix build, transitive closure, popcounts and the
// packed transpose behind column queries — runs as word-parallel native code,
// OpenMP-threaded over the outer axis.
//
// Exposed C ABI (see native/binding.py for the ctypes wrappers); all arrays
// are row-major, W = ceil(n_cols / 64) words per row, tail bits zero.

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// bool bytes [rows][cols] -> packed [rows][W]
void kv_pack(const uint8_t* in, int64_t rows, int64_t cols, uint64_t* out) {
    const int64_t W = (cols + 63) / 64;
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* src = in + r * cols;
        uint64_t* dst = out + r * W;
        std::memset(dst, 0, W * sizeof(uint64_t));
        for (int64_t c = 0; c < cols; ++c)
            if (src[c]) dst[c >> 6] |= (uint64_t)1 << (c & 63);
    }
}

void kv_unpack(const uint64_t* in, int64_t rows, int64_t cols, uint8_t* out) {
    const int64_t W = (cols + 63) / 64;
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < rows; ++r) {
        const uint64_t* src = in + r * W;
        uint8_t* dst = out + r * cols;
        for (int64_t c = 0; c < cols; ++c)
            dst[c] = (src[c >> 6] >> (c & 63)) & 1;
    }
}

// out[s*N + n] = (req[s] & kv[n]) == req[s]   (all required bits present)
void kv_subset(const uint64_t* req, const uint64_t* kv, int64_t S, int64_t N,
               int64_t W, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t s = 0; s < S; ++s) {
        const uint64_t* r = req + s * W;
        for (int64_t n = 0; n < N; ++n) {
            const uint64_t* k = kv + n * W;
            uint64_t bad = 0;
            for (int64_t w = 0; w < W; ++w) bad |= r[w] & ~k[w];
            out[s * N + n] = bad == 0;
        }
    }
}

// out[s*N + n] = (a[s] & b[n]) == 0
void kv_disjoint(const uint64_t* a, const uint64_t* b, int64_t S, int64_t N,
                 int64_t W, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t s = 0; s < S; ++s) {
        const uint64_t* r = a + s * W;
        for (int64_t n = 0; n < N; ++n) {
            const uint64_t* k = b + n * W;
            uint64_t hit = 0;
            for (int64_t w = 0; w < W; ++w) hit |= r[w] & k[w];
            out[s * N + n] = hit == 0;
        }
    }
}

// out[s*N + n] = (a[s] & b[n]) != 0
void kv_any(const uint64_t* a, const uint64_t* b, int64_t S, int64_t N,
            int64_t W, uint8_t* out) {
    kv_disjoint(a, b, S, N, W, out);
    const int64_t total = S * N;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < total; ++i) out[i] = !out[i];
}

// The matrix build / grant contraction (kano_py/kano/model.py:158-163):
//   for p, i: if sel[p] has bit i:  out[i] |= val[p]
// sel, val: packed [P][W] over N; out: packed [N][W] over N.
// Parallelised over row blocks so two threads never write the same out row.
void kv_or_scatter(const uint64_t* sel, const uint64_t* val, int64_t P,
                   int64_t N, int64_t W, uint64_t* out) {
#pragma omp parallel
    {
        int tid = 0, nth = 1;
#if defined(_OPENMP)
        tid = omp_get_thread_num();
        nth = omp_get_num_threads();
#endif
        const int64_t lo = N * tid / nth, hi = N * (tid + 1) / nth;
        for (int64_t p = 0; p < P; ++p) {
            const uint64_t* s = sel + p * W;
            const uint64_t* v = val + p * W;
            for (int64_t i = lo; i < hi; ++i) {
                if ((s[i >> 6] >> (i & 63)) & 1) {
                    uint64_t* row = out + i * W;
                    for (int64_t w = 0; w < W; ++w) row[w] |= v[w];
                }
            }
        }
    }
}

// row-wise OR of a mask into selected rows: for i: if cond[i]: out[i] |= mask
void kv_row_or_mask(uint64_t* out, const uint8_t* cond, const uint64_t* mask,
                    int64_t N, int64_t W) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < N; ++i)
        if (cond[i]) {
            uint64_t* row = out + i * W;
            for (int64_t w = 0; w < W; ++w) row[w] |= mask[w];
        }
}

// out = a & b elementwise over [R][W]
void kv_and_rows(const uint64_t* a, const uint64_t* b, int64_t R, int64_t W,
                 uint64_t* out) {
    const int64_t total = R * W;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < total; ++i) out[i] = a[i] & b[i];
}

// out |= a elementwise over [R][W]
void kv_or_into(uint64_t* out, const uint64_t* a, int64_t R, int64_t W) {
    const int64_t total = R * W;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < total; ++i) out[i] |= a[i];
}

// in-place transitive closure of a packed [N][W] boolean matrix.
// Packed Warshall: for pivot k, every row with bit k set ORs in row k —
// O(N^2/64) word ops per pivot, the packed analogue of the repeated
// squaring used on device (ops/closure.py).
void kv_closure(uint64_t* m, int64_t N, int64_t W) {
    for (int64_t k = 0; k < N; ++k) {
        const uint64_t* rk = m + k * W;
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < N; ++i) {
            uint64_t* ri = m + i * W;
            if (i != k && ((ri[k >> 6] >> (k & 63)) & 1))
                for (int64_t w = 0; w < W; ++w) ri[w] |= rk[w];
        }
    }
}

void kv_popcount_rows(const uint64_t* m, int64_t R, int64_t W, int64_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < R; ++r) {
        int64_t acc = 0;
        const uint64_t* row = m + r * W;
        for (int64_t w = 0; w < W; ++w) acc += __builtin_popcountll(row[w]);
        out[r] = acc;
    }
}

// packed transpose: in [R][Wc] over C columns -> out [C][Wr] over R columns.
// Column queries become row scans on the transposed matrix — the fix for the
// reference's O(N) Python bit-by-bit getcol (kano_py/kano/model.py:180-184).
void kv_transpose(const uint64_t* in, int64_t R, int64_t C, uint64_t* out) {
    const int64_t Wc = (C + 63) / 64, Wr = (R + 63) / 64;
#pragma omp parallel for schedule(static)
    for (int64_t c = 0; c < C; ++c) {
        uint64_t* dst = out + c * Wr;
        std::memset(dst, 0, Wr * sizeof(uint64_t));
        for (int64_t r = 0; r < R; ++r)
            if ((in[r * Wc + (c >> 6)] >> (c & 63)) & 1)
                dst[r >> 6] |= (uint64_t)1 << (r & 63);
    }
}

int kv_num_threads(void) {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
