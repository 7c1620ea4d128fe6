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
// What bounds it on an H100: per non-PAD column two M x M products and
// the elementwise and normalize work, about 4 M^2 + 9 M f32 operations,
// against 4 bytes of token in and 4 M bytes of gamma out, so the function
// is bound by f32 issue (67 TFLOP/s outside the tensor cores): 33.5 M
// columns at M = 27 need ~1.6 ms.  The recursion is sequential in t in
// both directions, so the parallelism is across windows.  The alpha store
// (written by the forward, read back and overwritten with gamma by the
// reverse sweep) is a cost of this design, not of the function; its
// callers split a batch into window groups under a byte budget
// (hmm/decoders.py:posterior_stream).
//
// Design (simple and exact first):
// * the forward is K1's own kernel (csrc/fwd.cu, included below),
//   instantiated with a checkpoint every column (TC = 1) and no loglik: it
//   writes alpha_t into row t of the store (T, W, 32S) for t < T-1 and the
//   final alpha into a (W, M) tensor, so K4's alpha are K1's bits;
// * the reverse kernel has K1's shape: one warp per window, eight windows
//   per block, lane l owning states l, l+32, ...; beta lives in registers
//   and in a per-warp shared row that Mat::at_x reads (a in registers at
//   M <= 32, in shared memory above); each step reads the warp's alpha row
//   (32S contiguous floats) and writes gamma over it;
// * the emission row is a direct gather from the transposed table
//   bt = bfull^T (625, 32S), one step ahead;
// * with a null store the reverse kernel is the beta sweep alone: it reads
//   no alpha and writes no gamma, and returns beta at the window's first
//   column (the segmented route's reverse pass); with a store, beta at
//   the first column is written only where the caller asks for it.
//
// Launch contract: the C entry points enqueue on the given stream, do not
// synchronize, allocate nothing, and return cudaGetLastError().

#include "fwd.cu"  // K1: forward_kernel, Mat, load_emission and the helpers

namespace {

// The reverse sweep over columns T-1..0 of every window: gamma over the
// alpha store (unless it is null) and beta at column 0 (unless
// beta_first is null).
template <int S>
__global__ void __launch_bounds__(kFwdWarps * 32)
k4_reverse_kernel(const float* __restrict__ a,          // (M, M) row-major
                  const float* __restrict__ bt,         // (625, 32*S), zero pad
                  const int* __restrict__ tokens,       // (W, T), PAD = -1
                  const float* __restrict__ beta_exit,  // (W, M) or null: ones
                  const float* __restrict__ alpha_fin,  // (W, M) alpha_{T-1}
                  float* __restrict__ store,            // (T, W, 32*S) or null
                  float* __restrict__ beta_first,       // (W, M) or null
                  int W, int T, int M) {
  constexpr int MP = 32 * S;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_x = smem + (S > 1 ? MP * Mat<S>::LDA : 0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Mat<S> am;
  am.load(a, smem, M, lane);
  __syncthreads();
  const int w = blockIdx.x * kFwdWarps + warp;
  if (w >= W) return;  // after the only block-wide barrier

  float* x = s_x + warp * MP;
  float beta[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    beta[k] = j < M ? (beta_exit != nullptr
                           ? beta_exit[static_cast<size_t>(w) * M + j]
                           : 1.f)
                    : 0.f;
    x[j] = 0.f;
  }
  __syncwarp();

  const int* row = tokens + static_cast<size_t>(w) * T;
  int tok = T > 1 ? __ldg(row + T - 1) : kPad;
  float e[S];
  load_emission<S>(e, bt, tok, lane);
  float al[S];  // alpha_t, read one step ahead
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    al[k] = store != nullptr && j < M
                ? alpha_fin[static_cast<size_t>(w) * M + j]
                : 0.f;
  }

  for (int t = T - 1; t >= 0; --t) {
    const int tok_n = t > 1 ? __ldg(row + t - 1) : kPad;
    float e_n[S];
    load_emission<S>(e_n, bt, tok_n, lane);  // consumed next step
    float al_n[S];
#pragma unroll
    for (int k = 0; k < S; ++k) al_n[k] = 0.f;
    if (store != nullptr && t > 0) {  // row t-1 still holds alpha_{t-1}
      const float* r = store + (static_cast<size_t>(t - 1) * W + w) * MP;
#pragma unroll
      for (int k = 0; k < S; ++k) al_n[k] = r[lane + 32 * k];
    }

    if (store != nullptr) {  // gamma_t = normalize(alpha_t * beta_t)
      float* r = store + (static_cast<size_t>(t) * W + w) * MP;
      float g[S];
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        g[k] = al[k] * beta[k];
        part += g[k];
      }
      const float s = warp_sum(part);
      const float d = s > 0.f ? s : 1.f;
#pragma unroll
      for (int k = 0; k < S; ++k) r[lane + 32 * k] = g[k] / d;
    }

    if (t > 0 && tok != kPad) {  // uniform across the warp
#pragma unroll
      for (int k = 0; k < S; ++k) x[lane + 32 * k] = e[k] * beta[k];
      __syncwarp();
      float nx[S];
      am.at_x(nx, x, lane);
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < S; ++k) part += nx[k];
      const float s = warp_sum(part);
      const float d = s > 0.f ? s : 1.f;
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

template <int S>
int launch_forward(const float* a, const float* bt, const float* al0,
                   const int* tokens, float* store, float* alpha_fin, int W,
                   int T, int M, cudaStream_t stream) {
  const size_t smem = forward_smem<S>();
  const cudaError_t err = allow_smem(forward_kernel<S, 1>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  forward_kernel<S, 1><<<(W + kFwdWarps - 1) / kFwdWarps, kFwdWarps * 32, smem,
                         stream>>>(a, bt, al0, nullptr, tokens, alpha_fin,
                                   nullptr, store, W, T, M);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_reverse(const float* a, const float* bt, const int* tokens,
                   const float* beta_exit, const float* alpha_fin,
                   float* store, float* beta_first, int W, int T, int M,
                   cudaStream_t stream) {
  const size_t smem = forward_smem<S>();  // the same a and one row a warp
  const cudaError_t err = allow_smem(k4_reverse_kernel<S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k4_reverse_kernel<S><<<(W + kFwdWarps - 1) / kFwdWarps, kFwdWarps * 32, smem,
                         stream>>>(a, bt, tokens, beta_exit, alpha_fin, store,
                                   beta_first, W, T, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pad width of the transposed emission table bt and of a store row (32*S).
int k4_table_width(int M) { return 32 * ((M + 31) / 32); }

int k4_max_states() { return 32 * kMaxS; }

// The forward: alpha_t into store row t for t < T-1, alpha_{T-1} into
// alpha_fin (W, M).
int k4_forward(const float* a, const float* bt, const float* al0,
               const int* tokens, float* store, float* alpha_fin, int W,
               int T, int M, void* stream) {
  if (W < 1 || T < 1 || M < 1 || M > 32 * kMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 31) / 32) {
    case 1: return launch_forward<1>(a, bt, al0, tokens, store, alpha_fin, W, T, M, s);
    case 2: return launch_forward<2>(a, bt, al0, tokens, store, alpha_fin, W, T, M, s);
    case 3: return launch_forward<3>(a, bt, al0, tokens, store, alpha_fin, W, T, M, s);
    case 4: return launch_forward<4>(a, bt, al0, tokens, store, alpha_fin, W, T, M, s);
    case 5: return launch_forward<5>(a, bt, al0, tokens, store, alpha_fin, W, T, M, s);
    case 6: return launch_forward<6>(a, bt, al0, tokens, store, alpha_fin, W, T, M, s);
    default: return launch_forward<7>(a, bt, al0, tokens, store, alpha_fin, W, T, M, s);
  }
}

// The reverse sweep: gamma over the store (alpha_fin gives alpha_{T-1})
// and beta at column 0 into beta_first (W, M) unless it is null.  A null
// store sweeps beta alone; a null beta_exit starts from ones.
int k4_reverse(const float* a, const float* bt, const int* tokens,
               const float* beta_exit, const float* alpha_fin, float* store,
               float* beta_first, int W, int T, int M, void* stream) {
  if (W < 1 || T < 1 || M < 1 || M > 32 * kMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 31) / 32) {
    case 1: return launch_reverse<1>(a, bt, tokens, beta_exit, alpha_fin, store, beta_first, W, T, M, s);
    case 2: return launch_reverse<2>(a, bt, tokens, beta_exit, alpha_fin, store, beta_first, W, T, M, s);
    case 3: return launch_reverse<3>(a, bt, tokens, beta_exit, alpha_fin, store, beta_first, W, T, M, s);
    case 4: return launch_reverse<4>(a, bt, tokens, beta_exit, alpha_fin, store, beta_first, W, T, M, s);
    case 5: return launch_reverse<5>(a, bt, tokens, beta_exit, alpha_fin, store, beta_first, W, T, M, s);
    case 6: return launch_reverse<6>(a, bt, tokens, beta_exit, alpha_fin, store, beta_first, W, T, M, s);
    default: return launch_reverse<7>(a, bt, tokens, beta_exit, alpha_fin, store, beta_first, W, T, M, s);
  }
}

const char* k4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
