// Kernel K1 on Hopper (sm_90a): the scaled forward log-likelihood of a
// window batch, each window a row of the row kernels of csrc/rows.cuh
// (shared with K5) with exact power-of-two scales.  The one-warp-a-window
// forward_kernel that K2 and K4 run is csrc/forward.cuh.
//
// Launch contract: the C entry points enqueue on the given stream, do not
// synchronize, allocate nothing, and return cudaGetLastError().

#include "rows.cuh"  // the row kernels of K1 and K5, and forward.cuh

// ===================================================================== K1
// Kernel K1: the scaled forward log-likelihood of a window batch, each
// window a row of the tiles of csrc/rows.cuh (Start::kGiven).
//
// Replaces the Pallas TPU kernel itrails_tpu/hmm/pallas_fwd.py:327
// forward_fused (its body is _kernel, pallas_fwd.py:232, which steps a
// block of windows a column as one product on the matrix unit).  For every
// window w of a (W, T) token batch, over columns 1..T-1 (column 0 is the
// wrapper's, hmm/cuda_fwd.py), from x = x0[w] = pi * e(tok_{w,0}):
//
//   x <- (x @ a) * e(tok_t),  k = ilogb(max_j x_j),  x <- x 2^-k,
//   ksum_w += k,
//
// where a PAD column keeps x and ksum, and a token outside the alphabet
// zeroes x (the window's loglik is then -inf).  Outputs: the rows X (W, M)
// in the tables' scalar and the exponent sums (W,) int32.  The wrapper
// folds them into the contract in f64: ll_w = ln2 ksum_w +
// log(sum_j X_wj) and alpha_w = X_w / sum_j X_wj; a window with no live
// column after column 0 folds to column 0's own alpha and log-normalizer.
//
// What bounds it on an H100: per non-PAD column 2 M^2 + 3 M operations
// (the product, the emission and the normalization; chip_smoke.py's
// k1_bound_ms) against 4 bytes of token in, and each window writes one row
// and one sum, so K1 is bound by issue, not by memory: 33.5 M columns need
// 0.64 ms at M = 27 at 67 TFLOP/s (f32 outside the tensor cores; f64 on
// the FP64 tensor cores) against 0.04 ms for their tokens at 3.35 TB/s.  The recurrence is sequential in t; the parallelism is across
// windows.
//
// Why rows with power-of-two scales.  One warp walking one window
// (forward_kernel, K1's kernel before this one) paid, every column, fixed
// work that does not grow with M: a 5-step shuffle reduction for the
// normalizer (10 shuffles in f64), a division a state, a log and a Kahan
// add that every lane computed, and the alpha row stored to shared memory
// between two __syncwarp and read back as the product's broadcast operand.
// At M = 27 the product was 32 FMAs a lane against ~100 instructions a
// column (~51 SM clocks a window-column against ~4.4 at the bound), and in
// f64 the division and the log are multi-instruction sequences on the
// FP64 pipe, outside the tensor cores (2.07x the f32 time).  Here a
// column's scale is its max's exponent, read from bits (exact; no log, no
// division), the log is taken once a window by the wrapper, a tile of
// windows shares each load of a, and in f64 the product runs on the FP64
// tensor cores.
//
// Tile height (f64): 8 rows (mma m8n8k4) at every W and M.  A tile is
// latency-bound when it has an SM sub-partition to itself (~1,400 SM
// clocks a column at M = 27 for 8 rows, ~1,700 for 16), so halving the
// rows a tile pays until the tiles fill the card's 528 sub-partitions (4
// an SM), and no further: 16-row tiles win only where ceil(W / 16) fills
// them, W >= 8,433 on 132 SMs.  No bucket the optimize path plans comes
// near that (the CLI's has W = 100, the genome-scale engine's 4,096), so
// K1 keeps one tile height; 16-row tiles (RH = 2, as K5 takes them) come
// back only with a measured workload of such buckets and a check at that
// shape.  The times that chose it, 8-row / 16-row tiles (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md §6):
//
//   M     W x T           8 rows         16 rows
//   27    100 x 10112     7.15-7.16 ms   8.48-8.49 ms   (the CLI's bucket)
//   27    4096 x 8192     5.78-5.83      7.09-7.13
//   27    8448 x 2048     1.83           1.71-1.72
//   27    16384 x 2048    3.04           2.36-2.53
//   133   1024 x 2048     12.14-12.15    15.89-15.90
//   133   8448 x 512      5.22-5.26      4.13-4.16
//
// The mma chain is not what holds a column: putting each tile's k steps
// NT mma apart instead of back to back moved K1 by -2% at M = 27 and
// +0.5% at M = 133, and spreading them over 4 accumulator sets by -4% on
// the CLI's bucket and -7% at 4096 x 8192 (8 sets no better), so K1 keeps
// K5's order.  f32 takes K5's tiles: 4 rows a warp at M <= 64, else 8.

namespace {

template <int S>
__global__ void __launch_bounds__(f32_warps<S>() * 32, 1)
k1_rows_f32(const float* __restrict__ a,       // (M, M)
            const float* __restrict__ bt,      // (625, 32S), zero pad
            const float* __restrict__ x0,      // (W, M) after column 0
            const int* __restrict__ tokens,    // (W, T), PAD = -1
            float* __restrict__ x_out,         // (W, M)
            int* __restrict__ k_out,           // (W,)
            int W, int T, int M) {
  rows_f32<Start::kGiven, S>(a, bt, x0, tokens, x_out, k_out, W, T - 1, M);
}

template <int NT>
__global__ void __launch_bounds__(kWarpsF64 * 32, 1)
k1_rows_f64(const double2* __restrict__ afr,   // (NT, NT, 32) a's fragments
            const double* __restrict__ bt,     // (625, width), zero pad
            const double* __restrict__ x0,     // (W, M) after column 0
            const int* __restrict__ tokens,    // (W, T), PAD = -1
            double* __restrict__ x_out,        // (W, M)
            int* __restrict__ k_out,           // (W,)
            int W, int T, int M, int width) {
  using Lay = F64Layout<NT, 1>;
  rows_f64<Start::kGiven, NT, 1, Lay::XS, Lay::GB, Lay::EP>(
      afr, bt, x0, tokens, x_out, k_out, W, T - 1, M, width);
}

// Calls f with the Rows of K1's f64 instantiation at nt 8-column tiles.
template <int NT, typename F>
int k1_dispatch_nt(int nt, F& f) {
  if (nt == NT)
    return f(rows_config(k1_rows_f64<NT>, 8, F64Layout<NT, 1>::kFixed,
                         F64Layout<NT, 1>::kWarp, kWarpsF64));
  if constexpr (NT < kMaxNT) {
    return k1_dispatch_nt<NT + 1>(nt, f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Calls f with the Rows of the instantiation K1 runs at M states on f32
// (f64 == 0) or f64 tables.
template <typename F>
int dispatch_k1(int M, int f64, F&& f) {
  if (f64 != 0) return k1_dispatch_nt<1>((M + 7) / 8, f);
  return dispatch_s(M, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    constexpr size_t fixed = S > 1 ? sizeof(float) * 32 * S * 32 * S : 0;
    return f(rows_config(k1_rows_f32<S>, f32_rows<S>(), fixed,
                         sizeof(float) * f32_rows<S>() * 32 * S, f32_warps<S>()));
  });
}

}  // namespace

extern "C" {

// K1: the rows X (W, M) and exponent sums (W,) int32 of a (W, T) token
// batch over columns 1..T-1, started from x0 (W, M).  f64 == 0: a is the
// (M, M) float matrix and x0, X float; else a's (NT, NT, 32) double2
// fragments and x0, X double.  bt is (625, k1_table_width(M)) in the
// tables' scalar.
int k1_forward(const void* a, const void* bt, const void* x0,
               const int* tokens, void* x, int* k, int W, int T, int M,
               int f64, void* stream) {
  if (W < 1 || T < 1 || M < 1 || M > 32 * kMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = k1_table_width(M);
  return dispatch_k1(M, f64, [&](auto cfg) {
    if constexpr (std::is_same_v<decltype(cfg.kernel), decltype(&k1_rows_f32<1>)>) {
      return launch_rows(cfg, W, s, static_cast<const float*>(a),
                         static_cast<const float*>(bt),
                         static_cast<const float*>(x0), tokens,
                         static_cast<float*>(x), k, W, T, M);
    } else {
      return launch_rows(cfg, W, s, static_cast<const double2*>(a),
                         static_cast<const double*>(bt),
                         static_cast<const double*>(x0), tokens,
                         static_cast<double*>(x), k, W, T, M, width);
    }
  });
}

// What K1 runs at M states on f32 (f64 == 0) or f64 tables: out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] rows a
// warp, out[3] warps a block at most.
int k1_attributes(int M, int f64, int* out) {
  if (M < 1 || M > 32 * kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_k1(M, f64, [&](auto cfg) {
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

const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
