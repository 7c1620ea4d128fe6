// Kernel K5: the per-chunk transfer operators of one long token stream,
// written for Hopper (sm_90a), as independent rows with per-row
// power-of-two scales.
//
// Replaces the Pallas TPU kernel tools/exp_opkernel.py:97
// chunk_operators_fused (its pallas_call at :128), whose contract is
// itrails_tpu/hmm/longseq.py:38 chunk_operators: for every chunk c of a
// (C, L) token matrix, the ordered product of its columns' operators
// a diag(e(tok_t)), max-normalized, with its log scale in f64.  Row i of
// that product is an ordinary forward vector started from the unit vector
// e_i, so this kernel computes rows, each with its own scale.  For every
// row (c, i), from x = e_i, over the chunk's L columns:
//
//   x    <- (x @ a) * e(tok_t)          (e(tok) = bfull[:, tok])
//   k     = ilogb(max_j x_j), floored at ilogb(FLT_MIN) or ilogb(DBL_MIN)
//   x    <- x * 2^-k,   ksum_{c,i} += k
//
// where a PAD token (-1) leaves x and ksum alone.  Outputs: the rows X
// (C, M, M) in the tables' scalar, float or double, and the exponent sums
// (C, M) int32.  A power-of-two scale is exact: the only rounding left is
// the product's, and no column takes a log or a division.  The wrapper
// (hmm/cuda_longseq.py) folds rows and sums into the contract in f64:
// lr = ln2 k, logz_c = max_i (lr_ci + log max_j X_cij),
// ops_c = X_c exp(lr_c - logz_c)[:, None].  This is the TPU kernel's own
// formulation (per-row scales, exp_opkernel.py:47); there they were sums
// renormalized every four columns, here exact powers of two every column.
//
// What bounds it on an H100: per non-PAD column of a chunk the product
// (M rows of x @ a) is 2 M^3 operations and the emission scale and rescale
// 2 M^2 more, against 4 bytes of token in; each chunk writes its rows and
// sums once.  So it is bound by issue, 67 TFLOP/s in f32 outside the tensor
// cores and in f64 on the FP64 tensor cores: a 320,000-column block needs
// ~0.195 ms at M = 27 and ~22.5 ms at M = 133 on either scalar.
//
// Layout: the row kernels of csrc/rows.cuh (shared with K1; its note gives
// the design), started from unit vectors (Start::kUnit): row r is
// row r mod M of chunk r / M, and the grid covers ceil(C M / rows a warp)
// warps, so the wave count no longer hangs on C.  f32 runs on the FMA pipes
// (4 rows a warp at M <= 64, else 8), f64 on the FP64 tensor cores, 16
// rows a warp up to M = 136 and 8 above:
//
//   M (MP)             rows a warp  X       a (shared)    X a warp   warps
//   <= 64 (<= 64)      16           regs    <= 32 KB      -          <= 8
//   65-136 (72-136)    16           staged  41-148 KB     9-17 KB    4-8
//   137-160 (144-160)  8            regs    166-200 KB    -          <= 8
//   161-224 (168-224)  8            staged  - (from L2)   10-14 KB   8
//
// Registers a thread (nvcc 12.9 -Xptxas -v, sm_90a, no spill at any M) and
// shared memory a block:
//
//   M     f32                                 f64
//   27    90 regs, 0.5 KB a warp (rows)       194 regs, 8 KB (a)
//   133   122 regs, 100 KB (a) + 5 KB/warp    255 regs, 145 KB (a) + 17 KB/warp
//   224   158 regs, 196 KB (a) + 7 KB/warp    246 regs, 14 KB/warp (a from L2)
//
// Times for 313 chunks of 1,024 columns (chip_smoke.py phase 2, NVIDIA
// H100 80GB HBM3, 700 W; PERF.md §6): f32 1.28 ms at M = 27 and 50.2 ms at
// M = 133 (15% and 45% of the bound), f64 1.16 and 38.9 ms (17% and 58%),
// against PR 12's kernel (a block a chunk, one scale a chunk) at 2.97 /
// 99.5 ms in f32 and 5.88 / 294 ms in f64.  At M = 27 the card holds all
// 529-2,113 warp tiles at once and the column loop's latency sets the pace.
//
// Launch contract: the C entry point enqueues on the given stream, does
// not synchronize, allocates nothing, and returns cudaGetLastError().

#include "rows.cuh"  // the row kernels, and forward.cuh's helpers

namespace {

// The kernels K5 launches: the rows of csrc/rows.cuh from unit vectors.
template <int S>
__global__ void __launch_bounds__(f32_warps<S>() * 32, 1)
k5_rows_f32(const float* __restrict__ a,       // (M, M)
            const float* __restrict__ bt,      // (625, 32S), zero pad
            const int* __restrict__ tokens,    // (C, L), PAD = -1
            float* __restrict__ x_out,         // (C, M, M)
            int* __restrict__ k_out,           // (C, M)
            int C, int L, int M) {
  rows_f32<Start::kUnit, S>(a, bt, nullptr, tokens, x_out, k_out, C * M, L, M);
}

template <int NT, int RH, bool XS, bool GB>
__global__ void __launch_bounds__(kWarpsF64 * 32, 1)
k5_rows_f64(const double2* __restrict__ afr,   // (NT, NT, 32) a's fragments
            const double* __restrict__ bt,     // (625, width), zero pad
            const int* __restrict__ tokens,    // (C, L), PAD = -1
            double* __restrict__ x_out,        // (C, M, M)
            int* __restrict__ k_out,           // (C, M)
            int C, int L, int M, int width) {
  rows_f64<Start::kUnit, NT, RH, XS, GB, F64Layout<NT, RH>::EP>(
      afr, bt, nullptr, tokens, x_out, k_out, C * M, L, M, width);
}

// Calls f with the Rows of the f64 instantiation at nt 8-column tiles.
template <int NT, typename F>
int dispatch_nt(int nt, F& f) {
  if (nt == NT) {
    constexpr int RH = NT <= 17 ? 2 : 1;  // 8-row halves a warp
    using Lay = F64Layout<NT, RH>;
    return f(rows_config(k5_rows_f64<NT, RH, Lay::XS, Lay::GB>, 8 * RH,
                         Lay::kFixed, Lay::kWarp, kWarpsF64));
  }
  if constexpr (NT < kMaxNT) {
    return dispatch_nt<NT + 1>(nt, f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Calls f with the Rows of the instantiation K5 runs at M states on f32
// (f64 == 0) or f64 tables.
template <typename F>
int dispatch_k5(int M, int f64, F&& f) {
  if (f64 != 0) return dispatch_nt<1>((M + 7) / 8, f);
  return dispatch_s(M, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    constexpr size_t fixed = S > 1 ? sizeof(float) * 32 * S * 32 * S : 0;
    return f(rows_config(k5_rows_f32<S>, f32_rows<S>(), fixed,
                         sizeof(float) * f32_rows<S>() * 32 * S, f32_warps<S>()));
  });
}

}  // namespace

extern "C" {

int k5_max_states() { return 32 * kMaxS; }

// The rows X (C, M, M) and exponent sums (C, M) int32 of a (C, L) token
// matrix.  f64 == 0: a is the (M, M) float matrix; else a's (NT, NT, 32)
// double2 fragments.  bt is (625, k1_table_width(M)) in the tables' scalar.
int k5_rows(const void* a, const void* bt, const int* tokens, void* x, int* k,
            int C, int L, int M, int f64, void* stream) {
  if (C < 1 || L < 1 || M < 1 || M > 32 * kMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = k1_table_width(M);
  return dispatch_k5(M, f64, [&](auto cfg) {
    if constexpr (std::is_same_v<decltype(cfg.kernel), decltype(&k5_rows_f32<1>)>) {
      return launch_rows(cfg, C * M, s, static_cast<const float*>(a),
                         static_cast<const float*>(bt), tokens,
                         static_cast<float*>(x), k, C, L, M);
    } else {
      return launch_rows(cfg, C * M, s, static_cast<const double2*>(a),
                         static_cast<const double*>(bt), tokens,
                         static_cast<double*>(x), k, C, L, M, width);
    }
  });
}

// What K5 runs at M states on f32 (f64 == 0) or f64 tables: out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] rows a
// warp, out[3] warps a block at most.
int k5_attributes(int M, int f64, int* out) {
  if (M < 1 || M > 32 * kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_k5(M, f64, [&](auto cfg) {
    cudaFuncAttributes at;
    const cudaError_t err = cudaFuncGetAttributes(&at, cfg.kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = at.numRegs;
    out[1] = static_cast<int>(at.localSizeBytes);
    out[2] = cfg.rows_per_warp;
    out[3] = cfg.max_warps;
    return 0;
  });
}

const char* k5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
