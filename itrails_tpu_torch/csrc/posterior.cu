// Kernel K4: posterior state probabilities of the coalescent HMM (scaled
// forward, scaled reverse sweep, gamma = normalize(alpha * beta)), written
// for Hopper (sm_90a).
//
// Replaces itrails_tpu/hmm/pallas_fwd.py:493 posterior_fused (its Pallas
// bodies are _kernel_alpha :434 and _bwd_kernel :443).  For every window w
// of a (W, T) token batch (column 0's alpha is made by the wrapper):
//
//   forward  alpha_t    = normalize((a^T alpha_{t-1}) * e(tok_t))
//   reverse  beta_{T-1} = 1 (or the exit beta the caller gives)
//            beta_{t-1} = normalize(a^T (e(tok_t) * beta_t))
//            gamma_t    = normalize(alpha_t * beta_t)
//
// where e(tok) = bfull[:, tok], normalize divides by the sum (a sum of 0
// divides by 1), and a PAD token (-1) keeps alpha and keeps beta.  The
// reverse sweep contracts over the source state, a^T x, as the reference
// does (itrails_tpu/hmm/decoders.py:196-201): the same operator as the
// forward, Mat::at_x, not K2's textbook a x.  The scale factors of alpha
// and beta cancel in gamma's normalization, so no logs are needed.
//
// What bounds it on an H100: per non-PAD column two M x M products (in
// f64, see below) and the elementwise and normalize work, about 4 M^2 +
// 9 M operations, against 4 bytes of token in and 4 M bytes of gamma out,
// so the function is bound by issue (67 TFLOP/s, f32 outside the tensor
// cores and f64 on them): 33.5 M columns at M = 27 need ~1.6 ms.  The
// recursion is sequential in t in both directions, so the parallelism is
// across windows.  The alpha store
// (written by the forward, read back and overwritten with gamma by the
// reverse sweep) is a cost of this design, not of the function; its
// callers split a batch into window groups under a byte budget
// (hmm/decoders.py:posterior_stream).
//
// Design (simple and exact first):
// * the forward is forward_kernel (csrc/forward.cuh, included below),
//   instantiated with a checkpoint every column (TC = 1) and no loglik: it
//   writes alpha_t into row t of the store (T, W, 32S) for t < T-1 and the
//   final alpha into a (W, M) tensor;
// * the reverse kernel has the forward's shape: one warp per window, eight
//   windows per block, lane l owning states l, l+32, ...; beta lives in registers
//   and in a per-warp shared row that Mat::at_x reads (a in registers at
//   M <= 32, in shared memory above); each step reads the warp's alpha row
//   (32S contiguous floats) and writes gamma over it;
// * the emission row is a direct gather from the transposed table
//   bt = bfull^T (625, 32S), one step ahead;
// * with a null store the reverse kernel is the beta sweep alone: it reads
//   no alpha and writes no gamma, and returns beta at the window's first
//   column (the segmented route's reverse pass); with a store, beta at
//   the first column is written only where the caller asks for it;
// * both kernels are instantiated on float and on double (the posterior
//   CLI's default, --precision float64): the same code on the scalar R
//   of the tables, the store and the elementwise work.  In both, a and
//   the warp's broadcast row are double (Mat<S, double>), so each M-term
//   product accumulates in f64 and is rounded to R once: with the product
//   in float, its M roundings a column put a long block's f32 posterior
//   further from the f64 one than the JAX package's f32 route
//   (tests/test_torch_posterior_long.py).  f32 tables alone
//   put the posterior off by up to 2.4e-4 on windows whose state runs are
//   tens of thousands of columns long, which f64 removes.  In double a
//   sits in shared memory up to M = 160 (S = 5: 206 KB of a and 10 KB of
//   rows); above that its (32S, 32S + 1) copy (296 KB at S = 6) does not
//   fit the 227 KB a block may use, and the kernels read a zero-padded
//   copy in global memory that stays in L2 (a_in_global, csrc/forward.cuh).
//   The store's rows are 8 bytes a state in double; the callers' byte
//   budget counts them so.  In double the bound is f64 issue, 67 TFLOP/s
//   on the FP64 tensor cores (NVIDIA data sheet, H100 SXM).
//
// Launch contract: the C entry points enqueue on the given stream, do not
// synchronize, allocate nothing, and return cudaGetLastError().

#include "forward.cuh"  // forward_kernel, Mat, load_emission and the helpers

namespace {

// The reverse sweep over columns T-1..0 of every window: gamma over the
// alpha store (unless it is null) and beta at column 0 (unless
// beta_first is null).
template <int S, typename R, bool G>
__global__ void __launch_bounds__(kFwdWarps * 32)
k4_reverse_kernel(const double* __restrict__ a,     // (M, M), or (32S, 32S+1) with G
                  const R* __restrict__ bt,         // (625, 32*S), zero pad
                  const int* __restrict__ tokens,   // (W, T), PAD = -1
                  const R* __restrict__ beta_exit,  // (W, M) or null: ones
                  const R* __restrict__ alpha_fin,  // (W, M) alpha_{T-1}
                  R* __restrict__ store,            // (T, W, 32*S) or null
                  R* __restrict__ beta_first,       // (W, M) or null
                  int W, int T, int M) {
  constexpr int MP = 32 * S;
  extern __shared__ float4 smem4[];
  double* smem = reinterpret_cast<double*>(smem4);
  double* s_x = smem + Mat<S, double, G>::kSmem;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Mat<S, double, G> am;
  am.load(a, smem, M, lane);
  __syncthreads();
  const int w = blockIdx.x * kFwdWarps + warp;
  if (w >= W) return;  // after the only block-wide barrier

  double* x = s_x + warp * MP;
  R beta[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    beta[k] = j < M ? (beta_exit != nullptr
                           ? beta_exit[static_cast<size_t>(w) * M + j]
                           : R(1))
                    : R(0);
    x[j] = 0;
  }
  __syncwarp();

  const int* row = tokens + static_cast<size_t>(w) * T;
  int tok = T > 1 ? __ldg(row + T - 1) : kPad;
  R e[S];
  load_emission<S>(e, bt, tok, lane);
  R al[S];  // alpha_t, read one step ahead
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    al[k] = store != nullptr && j < M
                ? alpha_fin[static_cast<size_t>(w) * M + j]
                : R(0);
  }

  for (int t = T - 1; t >= 0; --t) {
    const int tok_n = t > 1 ? __ldg(row + t - 1) : kPad;
    R e_n[S];
    load_emission<S>(e_n, bt, tok_n, lane);  // consumed next step
    R al_n[S];
#pragma unroll
    for (int k = 0; k < S; ++k) al_n[k] = 0;
    if (store != nullptr && t > 0) {  // row t-1 still holds alpha_{t-1}
      const R* r = store + (static_cast<size_t>(t - 1) * W + w) * MP;
#pragma unroll
      for (int k = 0; k < S; ++k) al_n[k] = r[lane + 32 * k];
    }

    if (store != nullptr) {  // gamma_t = normalize(alpha_t * beta_t)
      R* r = store + (static_cast<size_t>(t) * W + w) * MP;
      R g[S];
      R part = 0;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        g[k] = al[k] * beta[k];
        part += g[k];
      }
      const R s = warp_sum(part);
      const R d = s > R(0) ? s : R(1);
#pragma unroll
      for (int k = 0; k < S; ++k) r[lane + 32 * k] = g[k] / d;
    }

    if (t > 0 && tok != kPad) {  // uniform across the warp
#pragma unroll
      for (int k = 0; k < S; ++k) x[lane + 32 * k] = e[k] * beta[k];
      __syncwarp();
      double acc[S];
      am.at_x(acc, x, lane);
      R nx[S];
      R part = 0;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        nx[k] = static_cast<R>(acc[k]);  // the product rounded once
        part += nx[k];
      }
      const R s = warp_sum(part);
      const R d = s > R(0) ? s : R(1);
#pragma unroll
      for (int k = 0; k < S; ++k) beta[k] = nx[k] / d;
      __syncwarp();  // every lane has read x before it is written again
    }
    tok = tok_n;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      e[k] = e_n[k];
      al[k] = al_n[k];
    }
  }

  if (beta_first != nullptr) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int j = lane + 32 * k;
      if (j < M) beta_first[static_cast<size_t>(w) * M + j] = beta[k];
    }
  }
}

template <int S, typename R>
int launch_forward(const void* a, const void* bt, const void* al0,
                   const int* tokens, void* store, void* alpha_fin, int W,
                   int T, int M, cudaStream_t stream) {
  constexpr bool G = a_in_global<S, double>();
  const size_t smem = forward_smem<S, double, G>();
  const cudaError_t err = allow_smem(forward_kernel<S, 1, R, G, double>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  forward_kernel<S, 1, R, G, double>
      <<<(W + kFwdWarps - 1) / kFwdWarps, kFwdWarps * 32, smem, stream>>>(
          static_cast<const double*>(a), static_cast<const R*>(bt),
          static_cast<const R*>(al0), nullptr, tokens,
          static_cast<R*>(alpha_fin), nullptr, static_cast<R*>(store), W, T, M);
  return static_cast<int>(cudaGetLastError());
}

template <int S, typename R>
int launch_reverse(const void* a, const void* bt, const int* tokens,
                   const void* beta_exit, const void* alpha_fin, void* store,
                   void* beta_first, int W, int T, int M,
                   cudaStream_t stream) {
  constexpr bool G = a_in_global<S, double>();
  // the same a and one row a warp
  const size_t smem = forward_smem<S, double, G>();
  const cudaError_t err = allow_smem(k4_reverse_kernel<S, R, G>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k4_reverse_kernel<S, R, G>
      <<<(W + kFwdWarps - 1) / kFwdWarps, kFwdWarps * 32, smem, stream>>>(
          static_cast<const double*>(a), static_cast<const R*>(bt), tokens,
          static_cast<const R*>(beta_exit), static_cast<const R*>(alpha_fin),
          static_cast<R*>(store), static_cast<R*>(beta_first), W, T, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int k4_forward_r(const void* a, const void* bt, const void* al0,
                 const int* tokens, void* store, void* alpha_fin, int W, int T,
                 int M, cudaStream_t s) {
  return dispatch_s(M, [&](auto sc) {
    return launch_forward<decltype(sc)::value, R>(a, bt, al0, tokens, store,
                                                  alpha_fin, W, T, M, s);
  });
}

template <typename R>
int k4_reverse_r(const void* a, const void* bt, const int* tokens,
                 const void* beta_exit, const void* alpha_fin, void* store,
                 void* beta_first, int W, int T, int M, cudaStream_t s) {
  return dispatch_s(M, [&](auto sc) {
    return launch_reverse<decltype(sc)::value, R>(
        a, bt, tokens, beta_exit, alpha_fin, store, beta_first, W, T, M, s);
  });
}

}  // namespace

extern "C" {

int k4_max_states() { return 32 * kMaxS; }

// The tables' layout is K1's: bt is (625, k1_table_width(M)), a store row
// is k1_table_width(M) wide, and a is double, in both instantiations: the
// padded copy of k1_a_stride(M, 1) where that is not 0.

// The forward: alpha_t into store row t for t < T-1, alpha_{T-1} into
// alpha_fin (W, M).  Every float argument but a is double where f64 != 0.
int k4_forward(const void* a, const void* bt, const void* al0,
               const int* tokens, void* store, void* alpha_fin, int W, int T,
               int M, int f64, void* stream) {
  if (W < 1 || T < 1 || M < 1 || M > 32 * kMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 != 0
             ? k4_forward_r<double>(a, bt, al0, tokens, store, alpha_fin, W, T, M, s)
             : k4_forward_r<float>(a, bt, al0, tokens, store, alpha_fin, W, T, M, s);
}

// The reverse sweep: gamma over the store (alpha_fin gives alpha_{T-1})
// and beta at column 0 into beta_first (W, M) unless it is null.  A null
// store sweeps beta alone; a null beta_exit starts from ones.
int k4_reverse(const void* a, const void* bt, const int* tokens,
               const void* beta_exit, const void* alpha_fin, void* store,
               void* beta_first, int W, int T, int M, int f64, void* stream) {
  if (W < 1 || T < 1 || M < 1 || M > 32 * kMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 != 0
             ? k4_reverse_r<double>(a, bt, tokens, beta_exit, alpha_fin, store,
                                    beta_first, W, T, M, s)
             : k4_reverse_r<float>(a, bt, tokens, beta_exit, alpha_fin, store,
                                   beta_first, W, T, M, s);
}

const char* k4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
