// Kernel K6: the max-plus chunk operators of one long block, and the scan
// that reads omega at every chunk's entry from them, written for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package builds these operators with
// XLA ops (itrails_tpu/hmm/longseq.py:328-342, mp_matmul and op_step) and
// scans them with lax.associative_scan (:344-346); its Viterbi route,
// longseq.viterbi_long (:298), needs both before its per-chunk recursion
// (kernel K3, csrc/viterbi.cu) can start every chunk at once.
//
// K6, maxplus_rows: for a (C, L) token matrix, chunk c's operator R_c has
// row i = K3's forward over the chunk's columns from the unit omega (0 at
// i, NEG elsewhere), without pointers: K3's own column loop,
// maxplus_columns (csrc/maxplus_forward.cuh), compiled here in its mode
// without pointers:
//
//   best_j = max_k g[k] + log_a[k][j]
//   nv_j   = best_j + log_e[tok][j]
//   g      = nv - max_j nv            (rescaled every column)
//   off_i += max_j nv                 (summed in f64, in column order)
//
// and a PAD column keeps g and adds nothing.  R_c[i][j] = g[j] + off_i.
// Every f32 operation is K3's own, an exact add, max or subtract, and the
// f64 sum runs in column order, so the plain version
// (hmm/cuda_maxplus.py:maxplus_operators_plain) gives the same bits.
//
// The scan, maxplus_scan: omega_0 is column 0's rescaled omega; for c = 0..
// C-1, entry[c] = (float) omega_c and
//
//   omega_{c+1}[j] = max_i (omega_c[i] + off_c[i]) + (double) g_c[i][j],
//
// rescaled by its max, in f64 and in that order of adds.  One block walks
// the C chunks in order: its depth is C, not the block's T columns.
//
// What bounds them on an H100.  K6: per non-PAD column of a chunk, one add
// and one max for each (row, source, destination), 2*M^3 f32 operations,
// against 4 bytes of token in; bound by f32 instruction throughput outside
// the tensor cores (67 TFLOP/s): max-plus has no tensor-core path.  The
// scan: 2*M^2 f64 operations per chunk against 4*M^2 bytes of operator in,
// bound by bytes, but a chain of C dependent steps in one block.
//
// Design (simple and exact first):
// * K6: one warp per operator row (chunk, i), eight rows a block, K3's
//   forward layout and loop: lane l owns destinations l, l+32, ...; g_k
//   reaches every lane by shuffle from its owner; log_a in registers
//   (M <= 32) or in shared memory (M <= 224, K1's, K4's and K5's limit
//   too); the log-emission row a gather from the transposed table
//   (625, 32S), one column ahead.  Rows of one chunk share a block, so its
//   tokens and emission rows are read once from L2.
// * The scan: one block of 256 threads, thread j owns destination j; each
//   chunk's operator is staged in shared memory by the whole block
//   (coalesced, every load independent), then thread j takes its max over
//   i against the broadcast (omega + off) row.
//
// Launch contract: each C entry point enqueues its kernel on the given
// stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError().

#include "maxplus_forward.cuh"  // maxplus_columns, load_log_a and the helpers

namespace {

constexpr int kMaxS = 7;       // states per lane: M <= 224, log_a in shared
constexpr int kMaxStates = 224;
constexpr float kNeg = -1e4f;  // hmm/cuda_viterbi.py:NEG
constexpr int kScanThreads = 256;
static_assert(kMaxS <= kSmemMaxS, "K6 keeps log_a in shared memory");

template <int S>
__global__ void __launch_bounds__(kWarps * 32)
maxplus_rows(const float* __restrict__ la,     // (M, 32S), log a, row i
             const float* __restrict__ lbt,    // (625, 32S), log bfull^T
             const int* __restrict__ tokens,   // (C, L), PAD = -1
             float* __restrict__ ops,          // (C, M, M), rescaled rows
             double* __restrict__ off,         // (C, M), their offsets
             int C, int L, int M) {
  extern __shared__ float s_la[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float col[S == 1 ? 32 : 1];  // col[i] = log_a[i][lane]
  const float* rows = load_log_a<S>(col, la, s_la, M, lane);
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= static_cast<long long>(C) * M) return;  // after the only barrier
  const int c = static_cast<int>(r / M);
  const int i0 = static_cast<int>(r - static_cast<long long>(c) * M);

  float g[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    g[k] = j < M ? (j == i0 ? 0.0f : kNeg) : -INFINITY;
  }
  double offset = 0.0;
  maxplus_columns<S, false>(g, col, rows, lbt,
                            tokens + static_cast<size_t>(c) * L, L, nullptr,
                            offset, M, lane);

  float* out = ops + static_cast<size_t>(r) * M;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    if (j < M) out[j] = g[k];
  }
  if (lane == 0) off[r] = offset;
}

__device__ __forceinline__ double block_max(double x, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmax(x, __shfl_xor_sync(kFull, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double m = red[0];
#pragma unroll
  for (int w = 1; w < kScanThreads / 32; ++w) m = fmax(m, red[w]);
  return m;
}

// Omega at every chunk's entry, in one block: see the note at the top.
__global__ void __launch_bounds__(kScanThreads)
maxplus_scan(const float* __restrict__ ops,   // (C, M, M)
             const double* __restrict__ off,  // (C, M)
             const double* __restrict__ w_in, // (M,), max 0
             float* __restrict__ entry,       // (C, M)
             double* __restrict__ w_out,      // (M,), after chunk C-1
             int C, int M) {
  extern __shared__ double s_mem[];
  double* s_row = s_mem;                        // omega + off, (kScanThreads)
  double* red = s_mem + kScanThreads;           // (kScanThreads / 32)
  float* s_ops = reinterpret_cast<float*>(red + kScanThreads / 32);  // (M, M)
  const int j = threadIdx.x;
  const bool own = j < M;
  double w = own ? w_in[j] : -INFINITY;
  for (int c = 0; c < C; ++c) {
    const float* g = ops + static_cast<size_t>(c) * M * M;
    for (int idx = j; idx < M * M; idx += kScanThreads) s_ops[idx] = g[idx];
    if (own) {
      entry[static_cast<size_t>(c) * M + j] = static_cast<float>(w);
      s_row[j] = w + off[static_cast<size_t>(c) * M + j];
    }
    __syncthreads();
    double v = -INFINITY;
    if (own) {
      for (int i = 0; i < M; ++i)
        v = fmax(v, s_row[i] + static_cast<double>(s_ops[i * M + j]));
    }
    const double mx = block_max(v, red);
    w = v - mx;
    __syncthreads();  // s_row, s_ops and red are rewritten next chunk
  }
  if (own) w_out[j] = w;
}

template <int S>
int launch_rows(const float* la, const float* lbt, const int* tokens,
                float* ops, double* off, int C, int L, int M,
                cudaStream_t stream) {
  const size_t smem =
      S > 1 ? static_cast<size_t>(M) * 32 * S * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        maxplus_rows<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows = static_cast<long long>(C) * M;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  maxplus_rows<S><<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      la, lbt, tokens, ops, off, C, L, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int k6_max_states() { return kMaxStates; }

// K6 on a (C, L) token matrix: ops (C, M, M) and off (C, M).
int k6_operators(const float* la, const float* lbt, const int* tokens,
                 float* ops, double* off, int C, int L, int M, void* stream) {
  if (C < 1 || L < 1 || M < 1 || M > kMaxStates)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 31) / 32) {
    case 1: return launch_rows<1>(la, lbt, tokens, ops, off, C, L, M, s);
    case 2: return launch_rows<2>(la, lbt, tokens, ops, off, C, L, M, s);
    case 3: return launch_rows<3>(la, lbt, tokens, ops, off, C, L, M, s);
    case 4: return launch_rows<4>(la, lbt, tokens, ops, off, C, L, M, s);
    case 5: return launch_rows<5>(la, lbt, tokens, ops, off, C, L, M, s);
    case 6: return launch_rows<6>(la, lbt, tokens, ops, off, C, L, M, s);
    default: return launch_rows<kMaxS>(la, lbt, tokens, ops, off, C, L, M, s);
  }
}

// The entry scan over C chunks' operators: entry (C, M) and w_out (M,).
int k6_scan(const float* ops, const double* off, const double* w_in,
            float* entry, double* w_out, int C, int M, void* stream) {
  if (C < 1 || M < 1 || M > kMaxStates)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (kScanThreads + kScanThreads / 32) * sizeof(double)
                      + static_cast<size_t>(M) * M * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        maxplus_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  maxplus_scan<<<1, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ops, off, w_in, entry, w_out, C, M);
  return static_cast<int>(cudaGetLastError());
}

const char* k6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
