// Kernel K3: Viterbi decoding of the coalescent HMM (max-plus forward and
// pointer backtrack), written for Hopper (sm_90a).
//
// Replaces itrails_tpu/hmm/pallas_viterbi.py:299 viterbi_fused (its Pallas
// bodies are _fwd_kernel :100 and _bwd_kernel :270 for Mp <= 32, and the
// value-only _fwd_kernel_vo :153 with the pointer recompute _bwd_kernel_vo
// :232 above).  For every window w of a (W, T) token batch, columns 1..T-1
// (column 0 and the log tables are made by the wrapper, in torch):
//
//   s_ij      = omega_{t-1}[i] + log_a[i][j]
//   ptr_t[j]  = argmax_i s_ij            (first index on ties)
//   nv_j      = max_i s_ij + log_e[tok_t][j]
//   omega_t   = nv - max_j nv            (rescaled every step)
//
// where a PAD token (-1) keeps omega and writes the identity pointer.  The
// backtrack starts from argmax omega_{T-1} (first index), or from a state
// the caller gives, and walks the pointers back: path[t-1] =
// ptr_t[path[t]].  Every operation is an exact f32 add, compare or
// subtract, so the kernel takes the same decisions as the plain version
// (hmm/cuda_viterbi.py:viterbi_fused_plain) on the same tables, bit for
// bit, ties included.
//
// What bounds it on an H100: per non-PAD column one add and one compare
// per (source, destination) pair, 2*M^2 f32 operations, against 8 bytes
// of token in and state out, so the function is bound by f32 issue
// (67 TFLOP/s outside the tensor cores): 33.5 M columns need ~0.77 ms at
// M=27.  The recursion is sequential in t, so the parallelism is across
// windows.  The pointer table (W x (T-1) x M bytes) is a cost of this
// design, not of the function: the wrapper splits a batch into window
// groups whose table stays under a byte budget.
//
// Design (simple and exact first):
// * one warp per window, eight windows per block; lane l owns states
//   l, l+32, ..., so M <= 32*kMaxS;
// * omega_i reaches every lane by shuffle from its owner, and each lane
//   keeps a running (max, argmax) for its states with a strict '>' over
//   i = 0..M-1, which is the first-index tie-break;
// * for M <= 32 the loop over sources runs all 32 lanes without a
//   branch: a source i >= M has omega -inf and log_a -inf, so its score
//   never wins, and with no branch the shuffles of later sources overlap
//   the compare chain of earlier ones;
// * log_a: for M <= 32 each lane keeps its column in registers; up to
//   M = 32*kSmemMaxS the block copies it into shared memory (M rows of
//   32S floats: consecutive lanes read consecutive words, no bank
//   conflict); above that lanes read it through the read-only cache;
// * the log-emission row is a gather from the transposed table
//   lbt (625, 32S), one step ahead, as in forward_kernel (csrc/forward.cuh);
// * pointers are uint8 (M <= 255), stored (W, T-1, M);
// * the backtrack is one thread per window, a chain of dependent byte
//   loads.
//
// Launch contract: the C entry point enqueues both kernels on the given
// stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;      // windows per block of the forward kernel
constexpr int kMaxS = 8;       // states per lane: M <= 255 (uint8 pointers)
constexpr int kSmemMaxS = 7;   // log_a in shared memory up to M = 224
constexpr int kMaxStates = 255;
constexpr int kTokens = 625;   // alphabet size
constexpr int kPad = -1;
constexpr int kBacktrackThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Log-emission of the lane's states for one token; the row of a token
// outside the alphabet is clamped to it, as the plain version's gather.
template <int S>
__device__ __forceinline__ void load_log_emission(float (&e)[S],
                                                  const float* __restrict__ lbt,
                                                  int tok, int lane) {
  const int row = tok < 0 ? 0 : (tok >= kTokens ? kTokens - 1 : tok);
  const float* r = lbt + static_cast<size_t>(row) * (32 * S);
#pragma unroll
  for (int k = 0; k < S; ++k) e[k] = __ldg(r + lane + 32 * k);
}

// The max-plus forward over columns 1..T-1 of every window: pointers and
// the final rescaled omega.  For 1 < S < kMaxS (log_a in shared memory)
// the kernel is held to 64 registers a thread, four blocks an SM where
// shared memory allows; S = 1 and S = kMaxS run without that cap.
template <int S>
__global__ void __launch_bounds__(kWarps * 32, (S > 1 && S < kMaxS) ? 4 : 1)
viterbi_forward(const float* __restrict__ la,     // (M, 32S), log a, row i
                const float* __restrict__ lbt,    // (625, 32S), log bfull^T
                const float* __restrict__ om0,    // (W, M) omega of column 0
                const int* __restrict__ tokens,   // (W, T), PAD = -1
                uint8_t* __restrict__ ptr,        // (W, T-1, M)
                float* __restrict__ om_out,       // (W, M)
                int W, int T, int M) {
  constexpr int MP = 32 * S;
  constexpr bool kRegs = S == 1;
  constexpr bool kShared = S > 1 && S <= kSmemMaxS;
  extern __shared__ float s_la[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float col[kRegs ? 32 : 1];  // col[i] = log_a[i][lane]
  if constexpr (kRegs) {
#pragma unroll
    for (int i = 0; i < 32; ++i) col[i] = i < M ? la[i * MP + lane] : -INFINITY;
  }
  if constexpr (kShared) {
    for (int idx = threadIdx.x; idx < M * MP; idx += blockDim.x)
      s_la[idx] = la[idx];
    __syncthreads();
  }
  const int w = blockIdx.x * kWarps + warp;
  if (w >= W) return;  // after the only block-wide barrier

  float om[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    om[k] = j < M ? om0[static_cast<size_t>(w) * M + j] : -INFINITY;
  }

  const int* row = tokens + static_cast<size_t>(w) * T;
  uint8_t* wptr = ptr + static_cast<size_t>(w) * (T - 1) * M;
  int tok = T > 1 ? row[1] : kPad;
  float e[S];
  load_log_emission<S>(e, lbt, tok, lane);

  for (int t = 1; t < T; ++t) {
    const int tok_n = t + 1 < T ? __ldg(row + t + 1) : kPad;
    float e_n[S];
    load_log_emission<S>(e_n, lbt, tok_n, lane);  // consumed next step
    uint8_t* p = wptr + static_cast<size_t>(t - 1) * M;

    if (tok != kPad) {  // uniform across the warp: one window per warp
      float best[S];
      int arg[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        best[k] = -INFINITY;
        arg[k] = 0;
      }
#pragma unroll
      for (int kk = 0; kk < S; ++kk) {
        const int base = 32 * kk;
        if constexpr (kRegs) {
#pragma unroll
          for (int l = 0; l < 32; ++l) {  // l >= M adds -inf: no effect
            const float s = __shfl_sync(kFull, om[0], l) + col[l];
            if (s > best[0]) {
              best[0] = s;
              arg[0] = l;
            }
          }
        } else {
          const int lim = M - base < 32 ? M - base : 32;
          for (int l = 0; l < lim; ++l) {
            const int i = base + l;
            const float oi = __shfl_sync(kFull, om[kk], l);
            const float* r = (kShared ? s_la : la) + i * MP + lane;
#pragma unroll
            for (int k = 0; k < S; ++k) {
              float a_ij;
              if constexpr (kShared) {
                a_ij = r[32 * k];
              } else {
                a_ij = __ldg(r + 32 * k);
              }
              const float s = oi + a_ij;
              if (s > best[k]) {
                best[k] = s;
                arg[k] = i;
              }
            }
          }
        }
      }
      float nv[S];
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int j = lane + 32 * k;
        nv[k] = j < M ? best[k] + e[k] : -INFINITY;
        mx = fmaxf(mx, nv[k]);
      }
      mx = warp_max(mx);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int j = lane + 32 * k;
        if (j < M) {
          om[k] = nv[k] - mx;
          p[j] = static_cast<uint8_t>(arg[k]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int j = lane + 32 * k;
        if (j < M) p[j] = static_cast<uint8_t>(j);
      }
    }
    tok = tok_n;
#pragma unroll
    for (int k = 0; k < S; ++k) e[k] = e_n[k];
  }

#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    if (j < M) om_out[static_cast<size_t>(w) * M + j] = om[k];
  }
}

// The backtrack, one thread per window: the final state is ``last[w]``
// when given, else argmax_j omega[w][j] (first index).
__global__ void __launch_bounds__(kBacktrackThreads)
viterbi_backtrack(const uint8_t* __restrict__ ptr,  // (W, T-1, M)
                  const float* __restrict__ om,     // (W, M)
                  const int* __restrict__ last,     // (W,) or null
                  int* __restrict__ path,           // (W, T)
                  int W, int T, int M) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int s = 0;
  if (last != nullptr) {
    s = last[w];
  } else {
    const float* o = om + static_cast<size_t>(w) * M;
    float best = o[0];
    for (int j = 1; j < M; ++j) {
      if (o[j] > best) {
        best = o[j];
        s = j;
      }
    }
  }
  int* out = path + static_cast<size_t>(w) * T;
  const uint8_t* p = ptr + static_cast<size_t>(w) * (T - 1) * M;
  out[T - 1] = s;
  for (int t = T - 1; t >= 1; --t) {
    s = p[static_cast<size_t>(t - 1) * M + s];
    out[t - 1] = s;
  }
}

template <int S>
int launch_k3(const float* la, const float* lbt, const float* om0,
              const int* tokens, const int* last, uint8_t* ptr, float* om_out,
              int* path, int W, int T, int M, cudaStream_t stream) {
  const size_t smem = (S > 1 && S <= kSmemMaxS)
                          ? static_cast<size_t>(M) * 32 * S * sizeof(float)
                          : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_forward<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_forward<S><<<(W + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(
      la, lbt, om0, tokens, ptr, om_out, W, T, M);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  viterbi_backtrack<<<(W + kBacktrackThreads - 1) / kBacktrackThreads,
                      kBacktrackThreads, 0, stream>>>(ptr, om_out, last, path,
                                                      W, T, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pad width of the log tables la and lbt for M states (32*S).
int k3_table_width(int M) { return 32 * ((M + 31) / 32); }

int k3_max_states() { return kMaxStates; }

// Both kernels of K3 on one window group: the forward writes ptr and
// om_out, the backtrack path.  ``last`` may be null.
int k3_viterbi(const float* la, const float* lbt, const float* om0,
               const int* tokens, const int* last, uint8_t* ptr,
               float* om_out, int* path, int W, int T, int M, void* stream) {
  if (W < 1 || T < 1 || M < 1 || M > kMaxStates)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 31) / 32) {
    case 1: return launch_k3<1>(la, lbt, om0, tokens, last, ptr, om_out, path, W, T, M, s);
    case 2: return launch_k3<2>(la, lbt, om0, tokens, last, ptr, om_out, path, W, T, M, s);
    case 3: return launch_k3<3>(la, lbt, om0, tokens, last, ptr, om_out, path, W, T, M, s);
    case 4: return launch_k3<4>(la, lbt, om0, tokens, last, ptr, om_out, path, W, T, M, s);
    case 5: return launch_k3<5>(la, lbt, om0, tokens, last, ptr, om_out, path, W, T, M, s);
    case 6: return launch_k3<6>(la, lbt, om0, tokens, last, ptr, om_out, path, W, T, M, s);
    case 7: return launch_k3<7>(la, lbt, om0, tokens, last, ptr, om_out, path, W, T, M, s);
    default: return launch_k3<kMaxS>(la, lbt, om0, tokens, last, ptr, om_out, path, W, T, M, s);
  }
}

const char* k3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
