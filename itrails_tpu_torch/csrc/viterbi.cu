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
// * the column loop is maxplus_columns (csrc/maxplus_forward.cuh), which
//   kernel K6 (csrc/maxplus.cu) runs without pointers for its operator
//   rows: one body for both;
// * pointers are uint8 (M <= 255), stored (W, T-1, M);
// * the backtrack is one thread per window, a chain of dependent byte
//   loads.
//
// A long block (hmm/longseq.py:viterbi_long) runs as a batch of chunk
// windows, each entered through an omega read from kernel K6's max-plus
// operators (csrc/maxplus.cu), and needs the forward's pointer table after
// the forward: the forward, the backtrack and two more kernels are entry
// points of their own, and a window batch (hmm/cuda_viterbi.py:
// viterbi_fused) is the forward, then the backtrack.
// * The entry map, one thread per (window, exit state), consecutive
//   threads on one window's states so that a warp reads one pointer row:
//   each walks its window's pointers back from its exit state and records
//   the state at the window's column 0, a (W, M) map.  Every walk is the
//   window's length, not the block's.
// * The chain, one thread: window w's exit state is window w+1's state at
//   column 0, so from the last window's exit state, W lookups in the maps
//   give every window's exit state.  The backtrack then starts each
//   window from its own.
//
// Launch contract: each C entry point enqueues its kernels on the given
// stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError().

#include "maxplus_forward.cuh"  // maxplus_columns, load_log_a and the helpers

namespace {

constexpr int kMaxS = 8;       // states per lane: M <= 255 (uint8 pointers)
constexpr int kMaxStates = 255;
constexpr int kBacktrackThreads = 128;

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
  extern __shared__ float s_la[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float col[S == 1 ? 32 : 1];  // col[i] = log_a[i][lane]
  const float* rows = load_log_a<S>(col, la, s_la, M, lane);
  const int w = blockIdx.x * kWarps + warp;
  if (w >= W) return;  // after the only block-wide barrier

  float om[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    om[k] = j < M ? om0[static_cast<size_t>(w) * M + j] : -INFINITY;
  }
  double unused = 0.0;
  maxplus_columns<S, true>(om, col, rows, lbt,
                           tokens + static_cast<size_t>(w) * T + 1, T - 1,
                           ptr + static_cast<size_t>(w) * (T - 1) * M, unused,
                           M, lane);
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

// The entry map: map[w][s] = the state at column 0 of window w on the
// path that leaves it in state s (see the note at the top).
__global__ void __launch_bounds__(kBacktrackThreads)
viterbi_entry_map(const uint8_t* __restrict__ ptr,  // (W, T-1, M)
                  int* __restrict__ map,            // (W, M)
                  int W, int T, int M) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(W) * M) return;
  const int w = static_cast<int>(idx / M);
  int s = static_cast<int>(idx - static_cast<long long>(w) * M);
  const uint8_t* p = ptr + static_cast<size_t>(w) * (T - 1) * M;
  for (int t = T - 1; t >= 1; --t) s = p[static_cast<size_t>(t - 1) * M + s];
  map[idx] = s;
}

// The chain, one thread: states[W] is ``start[0]`` when given, else
// argmax_j om_last[j] (first index); states[w] = map[w][states[w+1]].
__global__ void viterbi_chain(const int* __restrict__ map,      // (W, M)
                              const float* __restrict__ om_last,  // (M,)
                              const int* __restrict__ start,    // (1,) or null
                              int* __restrict__ states,         // (W + 1,)
                              int W, int M) {
  int s = 0;
  if (start != nullptr) {
    s = start[0];
  } else {
    float best = om_last[0];
    for (int j = 1; j < M; ++j) {
      if (om_last[j] > best) {
        best = om_last[j];
        s = j;
      }
    }
  }
  states[W] = s;
  for (int w = W - 1; w >= 0; --w) {
    s = map[static_cast<size_t>(w) * M + s];
    states[w] = s;
  }
}

template <int S>
int launch_forward(const float* la, const float* lbt, const float* om0,
                   const int* tokens, uint8_t* ptr, float* om_out, int W,
                   int T, int M, cudaStream_t stream) {
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
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int W, int T, int M) {
  return W < 1 || T < 1 || M < 1 || M > kMaxStates;
}

}  // namespace

extern "C" {

int k3_max_states() { return kMaxStates; }

// K3's forward on a window batch: ptr (W, T-1, M) and om_out (W, M).
int k3_forward(const float* la, const float* lbt, const float* om0,
               const int* tokens, uint8_t* ptr, float* om_out, int W, int T,
               int M, void* stream) {
  if (bad_shape(W, T, M)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 31) / 32) {
    case 1: return launch_forward<1>(la, lbt, om0, tokens, ptr, om_out, W, T, M, s);
    case 2: return launch_forward<2>(la, lbt, om0, tokens, ptr, om_out, W, T, M, s);
    case 3: return launch_forward<3>(la, lbt, om0, tokens, ptr, om_out, W, T, M, s);
    case 4: return launch_forward<4>(la, lbt, om0, tokens, ptr, om_out, W, T, M, s);
    case 5: return launch_forward<5>(la, lbt, om0, tokens, ptr, om_out, W, T, M, s);
    case 6: return launch_forward<6>(la, lbt, om0, tokens, ptr, om_out, W, T, M, s);
    case 7: return launch_forward<7>(la, lbt, om0, tokens, ptr, om_out, W, T, M, s);
    default: return launch_forward<kMaxS>(la, lbt, om0, tokens, ptr, om_out, W, T, M, s);
  }
}

// K3's backtrack from the forward's ptr and om: path (W, T).  ``last`` may
// be null.
int k3_backtrack(const uint8_t* ptr, const float* om, const int* last,
                 int* path, int W, int T, int M, void* stream) {
  if (bad_shape(W, T, M)) return static_cast<int>(cudaErrorInvalidValue);
  viterbi_backtrack<<<(W + kBacktrackThreads - 1) / kBacktrackThreads,
                      kBacktrackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ptr, om, last, path, W, T, M);
  return static_cast<int>(cudaGetLastError());
}

// The entry map of a forward's ptr: map (W, M) int32.
int k3_entry_map(const uint8_t* ptr, int* map, int W, int T, int M,
                 void* stream) {
  if (bad_shape(W, T, M)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(W) * M;
  const long long blocks = (n + kBacktrackThreads - 1) / kBacktrackThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  viterbi_entry_map<<<static_cast<unsigned>(blocks), kBacktrackThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(ptr, map, W, T, M);
  return static_cast<int>(cudaGetLastError());
}

// The chain over W windows' maps: states (W + 1,) int32.  ``start`` may be
// null, and then om_last (M,) gives the last window's exit state.
int k3_chain(const int* map, const float* om_last, const int* start,
             int* states, int W, int M, void* stream) {
  if (bad_shape(W, 1, M)) return static_cast<int>(cudaErrorInvalidValue);
  viterbi_chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      map, om_last, start, states, W, M);
  return static_cast<int>(cudaGetLastError());
}

const char* k3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
