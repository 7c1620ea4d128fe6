// Kernel K5: the per-chunk transfer operators of one long token stream,
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/exp_opkernel.py:97
// chunk_operators_fused (its pallas_call at :128), whose contract is
// itrails_tpu/hmm/longseq.py:38 chunk_operators.  For every chunk c of a
// (C, L) token matrix, from G = I:
//
//   G    <- (G @ a) * e(tok_t)^T        (e(tok) = bfull[:, tok], a row scale
//                                        of the columns)
//   z     = max(max over the (M, M) entries of G, FLT_MIN or DBL_MIN)
//   G    <- G / z,   logz_c += log z    (logz in f64)
//
// where a PAD token (-1) keeps G and adds nothing to logz.  Outputs: the
// max-normalized operators (C, M, M) in the tables' scalar, float or
// double, and their log scales (C,) in f64.  Both scalars run the same
// code; double is the optimize CLI's value path at --precision float64,
// which scipy's finite differences need.
// hmm/longseq.py:forward_loglik_long multiplies the operators in column
// order and adds the log scales in f64.  The TPU kernel's split-bf16
// emission table, one-hot emission matmul, identity-rows lane layout and
// per-row scales are TPU workarounds and are not carried over: here each
// chunk has one scalar scale a column, the contract of chunk_operators.
//
// What bounds it on an H100: per non-PAD column the product G @ a is M^3
// FMAs (2 M^3 operations) and the emission scale and normalization 2 M^2
// more, against 4 bytes of token in; each chunk writes 4 M^2 + 8 bytes
// (8 M^2 + 8 in double).  So it is bound by issue, 67 TFLOP/s in f32
// outside the tensor cores and in f64 on the FP64 tensor cores (this
// kernel's f64 FMAs run outside them, at half that): a 320,000-column
// block needs ~0.195 ms at M = 27 and ~22.5 ms at M = 133.  The chunks
// are independent, so the chunk count is the parallel axis (313 chunks of
// 1,024 columns for 320,000 columns).
//
// Design (simple and exact first; wgmma on G @ a and TMA are later work):
// * one block of kOpWarps warps owns one chunk; warp w owns the rows
//   w, w + kOpWarps, ... of G.  Row i of G @ a is (row i of G) @ a, so a
//   row is K1's forward step (Mat::at_x, csrc/fwd.cu) with the rows of G
//   in place of the windows' alpha, and the rows share one token stream.
//   Above M = 32 a warp multiplies 2-3 rows at once, loading each
//   entry of a once for them, and keeps four partial sums an entry
//   (rows_times_a);
// * G lives in shared memory, one buffer of M rows of 32S scalars: a row
//   depends only on its own old values, so each warp reads its row, waits
//   for its lanes (__syncwarp) and writes the new row over it.  In double
//   above M = 96, a beside G would pass 227 KB (S = 4: 129 KB of a and
//   128 KB of G), and each block keeps its G in a (M, 32S) slice of a
//   scratch buffer in global memory instead (k5_g_global), with the same
//   accesses: a warp reads its own G rows once a column (1.3 KB a row at
//   M = 133, from L1/L2), where a read from L2 would be read by every row;
// * the column's max is a warp shuffle reduction, then one value a warp in
//   shared memory (two slots by column parity, so one __syncthreads a
//   column suffices), then each warp divides its own rows by it;
// * a sits where K1 keeps it: its columns in registers at M <= 32, a
//   (32S, 32S + 1) copy in shared memory up to M = 160 (S = 5: 103 KB of a
//   and 100 KB of G at most; M = 133: 188 KB).  Above M = 160, a beside G
//   would exceed the 227 KB a block may use (S = 6: 148 KB of a and 147 KB
//   of G), so the kernel reads a zero-padded copy of a from global memory,
//   which stays in L2 (201 KB at M = 224): correct, and slower than a
//   thread-block cluster holding G's rows in distributed shared memory
//   would be, which is later work.  In double a stays in shared memory
//   up to M = 160 too (S = 5: 206 KB), with G in global memory above
//   M = 96; above M = 160 both are read from global memory.  In double K5
//   multiplies one or two rows at a time (k5_rows) with two partial sums
//   an entry (k5_partials) to stay within the registers;
// * the emission row is a direct gather from the transposed table
//   bt = bfull^T (625, 32S), as K1's load_emission does, one column ahead;
// * logz is accumulated in f64 by thread 0 and written as f64.
//
// Launch contract: the C entry point enqueues on the given stream, does
// not synchronize, allocates nothing, and returns cudaGetLastError().

#include <cfloat>

#include "fwd.cu"  // K1: Mat, load_emission, dispatch_s and the helpers

namespace {

constexpr int kOpWarps = 16;  // warps of a K5 block

// Whether K5 reads a from a zero-padded copy in global memory (L2): above
// S = 5, where a's (32S, 32S + 1) copy passes the 227 KB a block may use
// beside G (float) or alone (double: S = 6, 296 KB).
template <int S>
constexpr bool k5_a_global() {
  return S > 5;
}

// Whether K5 on scalar R keeps G in a scratch buffer in global memory: in
// double above S = 3, where a's copy and G's M x 32S scalars together
// pass 227 KB.
template <int S, typename R>
constexpr bool k5_g_global() {
  return sizeof(R) == 8 && S > 3;
}

// Rows of G a warp multiplies at once (S > 1), and partial sums an entry:
// their NR S D sums and a's 4 S entries stay within the 128 registers a
// thread of a 512-thread block may hold (a double takes two).  In float
// the four partial sums also keep the rounding of an entry's M-term sum
// small; in double two suffice.
template <int S, typename R>
__host__ __device__ constexpr int k5_rows() {
  if constexpr (sizeof(R) == 4) return S > 5 ? 2 : 3;
  return S > 5 ? 1 : 2;
}

template <typename R>
__host__ __device__ constexpr int k5_partials() {
  return sizeof(R) == 4 ? 4 : 2;
}

__device__ __forceinline__ float max_r(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double max_r(double x, double y) { return fmax(x, y); }

template <typename R>
__device__ __forceinline__ R warp_max(R x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max_r(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// out[q][k] = (x_q @ a)_{lane + 32k} for the NR rows x_q of G, S > 1.  Each
// entry of a is loaded once for the NR rows (Mat::at_x loads one entry of
// a per FMA, so shared-memory loads, not FMAs, would bound the product),
// and each sum is kept in D partial sums (D = 4: one for each of the four
// source states of a step, added at the end as Mat::at_x does at S == 1;
// D = 2: states 0, 2 and 1, 3): D independent FMA chains, and a rounding
// error that grows with M/D terms instead of M.
template <int NR, int S, typename R, bool G>
__device__ __forceinline__ void rows_times_a(const Mat<S, R, G>& am,
                                             const R* const (&x)[NR],
                                             R (&out)[NR][S], int lane) {
  constexpr int LDA = Mat<S, R, G>::LDA;
  constexpr int D = k5_partials<R>();
  R p[D][NR][S];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int k = 0; k < S; ++k) p[d][q][k] = 0;
  for (int i = 0; i < am.m4; i += 4) {
    const R* r = am.s_a + i * LDA + lane;
    R av[4][S];
#pragma unroll
    for (int d = 0; d < 4; ++d)
#pragma unroll
      for (int k = 0; k < S; ++k) av[d][k] = r[d * LDA + 32 * k];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const auto v = load4(x[q] + i);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        p[0][q][k] = fma_r(av[0][k], v.x, p[0][q][k]);
        p[1][q][k] = fma_r(av[1][k], v.y, p[1][q][k]);
        p[2 % D][q][k] = fma_r(av[2][k], v.z, p[2 % D][q][k]);
        p[3 % D][q][k] = fma_r(av[3][k], v.w, p[3 % D][q][k]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NR; ++q)
#pragma unroll
    for (int k = 0; k < S; ++k)
      out[q][k] = D == 4 ? (p[0][q][k] + p[1][q][k]) + (p[2 % D][q][k] + p[3 % D][q][k])
                         : p[0][q][k] + p[1][q][k];
}

template <int S, typename R, bool GA, bool GG>
__global__ void __launch_bounds__(kOpWarps * 32)
k5_operators_kernel(const R* __restrict__ a,       // (M, M), or (32S, 32S+1) with GA
                    const R* __restrict__ bt,      // (625, 32*S), zero pad
                    const int* __restrict__ tokens,  // (C, L), PAD = -1
                    R* __restrict__ ops,           // (C, M, M)
                    double* __restrict__ logz,     // (C,)
                    R* __restrict__ gbuf,          // (C, M, 32S) with GG
                    int L, int M) {
  constexpr int MP = 32 * S;
  constexpr R kTiny = sizeof(R) == 4 ? R(FLT_MIN) : R(DBL_MIN);
  extern __shared__ float4 smem4[];
  R* smem = reinterpret_cast<R*>(smem4);
  R* g = GG ? gbuf + static_cast<size_t>(blockIdx.x) * M * MP  // (M, MP): G
            : smem + Mat<S, R, GA>::kSmem;
  R* s_max = smem + Mat<S, R, GA>::kSmem + (GG ? 0 : M * MP);  // (2, kOpWarps)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Mat<S, R, GA> am;
  am.load(a, smem, M, lane);
  for (int idx = threadIdx.x; idx < M * MP; idx += blockDim.x) {
    const int i = idx / MP;
    g[idx] = idx - i * MP == i ? R(1) : R(0);  // G = I
  }
  __syncthreads();

  const int* row = tokens + static_cast<size_t>(blockIdx.x) * L;
  int tok = __ldg(row);
  R e[S];
  load_emission<S>(e, bt, tok, lane);
  double lz = 0.0;  // thread 0's sum of log z
  int par = 0;      // the slot of s_max this column writes

  for (int t = 0; t < L; ++t) {
    const int tok_n = t + 1 < L ? __ldg(row + t + 1) : kPad;
    R e_n[S];
    load_emission<S>(e_n, bt, tok_n, lane);  // consumed next column

    if (tok != kPad) {  // uniform across the block: one chunk a block
      R mx = 0;
      if constexpr (S == 1) {  // a's columns in registers: one row at a time
        for (int r = warp; r < M; r += kOpWarps) {
          R* x = g + r * MP;
          R out[S];
          am.at_x(out, x, lane);  // (row r of G) @ a
          __syncwarp();           // every lane has read row r
          const R v = out[0] * e[0];
          x[lane] = v;
          mx = max_r(mx, v);
        }
      } else {  // NR rows at a time: r0, r0 + kOpWarps, ...
        constexpr int NR = k5_rows<S, R>();
        for (int r0 = warp; r0 < M; r0 += NR * kOpWarps) {
          const R* xs[NR];
#pragma unroll
          for (int q = 0; q < NR; ++q) {
            const int r = r0 + q * kOpWarps;
            xs[q] = g + (r < M ? r : r0) * MP;  // past M: row r0 again, unused
          }
          R out[NR][S];
          rows_times_a<NR>(am, xs, out, lane);
          __syncwarp();  // every lane has read the rows
#pragma unroll
          for (int q = 0; q < NR; ++q) {
            if (r0 + q * kOpWarps >= M) break;
            R* x = g + (r0 + q * kOpWarps) * MP;
#pragma unroll
            for (int k = 0; k < S; ++k) {
              const R v = out[q][k] * e[k];
              x[lane + 32 * k] = v;
              mx = max_r(mx, v);
            }
          }
        }
      }
      mx = warp_max(mx);
      if (lane == 0) s_max[par * kOpWarps + warp] = mx;
      __syncthreads();
      R z = 0;
#pragma unroll
      for (int q = 0; q < kOpWarps; ++q) z = max_r(z, s_max[par * kOpWarps + q]);
      z = max_r(z, kTiny);
      for (int r = warp; r < M; r += kOpWarps) {
        R* x = g + r * MP;
#pragma unroll
        for (int k = 0; k < S; ++k) x[lane + 32 * k] = x[lane + 32 * k] / z;
      }
      __syncwarp();  // the next column's product reads whole rows
      if (threadIdx.x == 0) lz += log(static_cast<double>(z));
      par ^= 1;
    }
    tok = tok_n;
#pragma unroll
    for (int k = 0; k < S; ++k) e[k] = e_n[k];
  }

  R* out = ops + static_cast<size_t>(blockIdx.x) * M * M;
  for (int r = warp; r < M; r += kOpWarps)
    for (int j = lane; j < M; j += 32) out[r * M + j] = g[r * MP + j];
  if (threadIdx.x == 0) logz[blockIdx.x] = lz;
}

template <int S, typename R>
size_t k5_smem(int M) {
  return static_cast<size_t>(Mat<S, R, k5_a_global<S>()>::kSmem +
                             (k5_g_global<S, R>() ? 0 : M * 32 * S) +
                             2 * kOpWarps) * sizeof(R);
}

template <int S, typename R>
int launch_k5(const void* a, const void* bt, const int* tokens, void* ops,
              double* logz, void* gbuf, int C, int L, int M,
              cudaStream_t stream) {
  constexpr bool GA = k5_a_global<S>();
  constexpr bool GG = k5_g_global<S, R>();
  if (GG && gbuf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = k5_smem<S, R>(M);
  const cudaError_t err = allow_smem(k5_operators_kernel<S, R, GA, GG>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k5_operators_kernel<S, R, GA, GG><<<C, kOpWarps * 32, smem, stream>>>(
      static_cast<const R*>(a), static_cast<const R*>(bt), tokens,
      static_cast<R*>(ops), logz, static_cast<R*>(gbuf), L, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int k5_max_states() { return 32 * kMaxS; }

// The tables' layout is K1's: bt is (625, k1_table_width(M)).  Row stride
// of the zero-padded (32S, 32S + 1) copy of a that K5 reads from global
// memory at M states, on either scalar, or 0 where it takes a as the plain
// (M, M) matrix.
int k5_a_stride(int M) {
  const int S = (M + 31) / 32;
  return S > 5 ? 32 * S + 1 : 0;
}

// Scalars of G's scratch in global memory for one chunk (M x 32S), or 0
// where G lives in shared memory.
int k5_g_scratch(int M, int f64) {
  const int S = (M + 31) / 32;
  return f64 != 0 && S > 3 ? M * 32 * S : 0;
}

// The operators (C, M, M) and log scales (C,) of a (C, L) token matrix.
// Every float argument is double where f64 != 0; gbuf is (C, M, 32S) where
// k5_g_scratch(M, f64) is not 0, else it may be null.
int k5_operators(const void* a, const void* bt, const int* tokens, void* ops,
                 double* logz, void* gbuf, int C, int L, int M, int f64,
                 void* stream) {
  if (C < 1 || L < 1 || M < 1 || M > 32 * kMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_s(M, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    return f64 != 0
               ? launch_k5<S, double>(a, bt, tokens, ops, logz, gbuf, C, L, M, s)
               : launch_k5<S, float>(a, bt, tokens, ops, logz, gbuf, C, L, M, s);
  });
}

const char* k5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
