// Kernel K1: the Rabiner-scaled forward recurrence of the coalescent HMM,
// written for Hopper (sm_90a).
//
// Replaces itrails_tpu/hmm/pallas_fwd.py:327 forward_fused (its Pallas body
// is _kernel, pallas_fwd.py:232).  For every window w of a (W, T) token
// batch, columns 1..T-1 (column 0 is done by the wrapper):
//
//   alpha_t = normalize((a^T alpha_{t-1}) * bfull[:, tok_t]),
//   ll_w   += log(sum((a^T alpha_{t-1}) * bfull[:, tok_t])),
//
// where a PAD token (-1) leaves alpha and ll unchanged.  Outputs: the
// normalized final alpha (W, M) and the per-window loglik (W,), in f32.
//
// What bounds it on an H100: the product a^T alpha costs 2*M^2 flops per
// column against 4 bytes of token traffic, so the kernel is bound by f32
// FMA issue (67 TFLOP/s outside the tensor cores), not by memory: 33.5 M
// columns need ~0.73 ms at M=27 and ~17.7 ms at M=133, while their 134 MB
// of tokens take 0.04 ms at 3.35 TB/s.  The recurrence is sequential in t,
// so the parallelism is across windows only.
//
// Design (simple and exact first; tensor cores are later work):
// * one warp per window, eight windows per block; lane l owns states
//   l, l+32, ..., so M <= 32*kMaxS;
// * alpha lives in registers and in a per-warp shared-memory row that the
//   warp reads back, four states at a time, as the broadcast operand of
//   the product; for M <= 32 each lane keeps its column of a in
//   registers, above that a sits in shared memory (M=133: 87 KB).  The
//   register form saves 28 shared-memory loads per column: at M=27 on an
//   H100 80GB HBM3 (700 W) K1 takes 9.04-9.08 ms for 4096 x 8192 columns
//   and 132-133 ms for one 320,000-column window, against 10.45-10.50 ms
//   and 228 ms with a in shared memory (chip_smoke.py, PERF.md);
// * the emission row is a direct gather from the transposed table
//   bt = bfull^T (625, 32*S), which stays in L1/L2 (80 KB at M=27,
//   400 KB at M=133); the next column's row is requested one step ahead;
// * tokens arrive 32 columns per coalesced warp load, one chunk ahead,
//   and reach the lanes by shuffle;
// * the normalizer is a warp shuffle reduction; the per-window log-sum is
//   an f32 Kahan sum, so its rounding does not grow with T.
//
// Launch contract: the C entry point enqueues on the given stream, does
// not synchronize, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;     // windows per block
constexpr int kMaxS = 7;      // states per lane: M <= 224
constexpr int kTokens = 625;  // alphabet size
constexpr int kPad = -1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Emission of the lane's states for one token.  A PAD token is never used;
// a token outside the alphabet gives 0, so the window's loglik becomes
// -inf instead of reading outside the table.
template <int S>
__device__ __forceinline__ void load_emission(float (&e)[S],
                                              const float* __restrict__ bt,
                                              int tok, int lane) {
  const bool ok = static_cast<unsigned>(tok) < static_cast<unsigned>(kTokens);
  const float* row = bt + static_cast<size_t>(ok ? tok : 0) * (32 * S);
#pragma unroll
  for (int k = 0; k < S; ++k) e[k] = ok ? __ldg(row + lane + 32 * k) : 0.f;
}

template <int S>
__global__ void __launch_bounds__(kWarps * 32)
k1_forward_kernel(const float* __restrict__ a,     // (M, M) row-major
                  const float* __restrict__ bt,    // (625, 32*S), zero pad
                  const float* __restrict__ al0,   // (W, M) alpha after col 0
                  const float* __restrict__ ll0,   // (W,) log-norm of col 0
                  const int* __restrict__ tokens,  // (W, T), PAD = -1
                  float* __restrict__ alpha_out,   // (W, M)
                  float* __restrict__ ll_out,      // (W,)
                  int W, int T, int M) {
  constexpr int MP = 32 * S;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m4 = (M + 3) & ~3;
  // s_a[i * MP + j] = a[i][j] (S > 1 only); rows m4 and columns MP padded
  float* s_a = smem;
  float* s_al = smem + (S > 1 ? m4 * MP : 0);
  if constexpr (S > 1) {
    for (int idx = threadIdx.x; idx < m4 * MP; idx += blockDim.x) {
      const int i = idx / MP, j = idx - (idx / MP) * MP;
      s_a[idx] = (i < M && j < M) ? a[i * M + j] : 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= W) return;  // after the only block-wide barrier

  float* al = s_al + warp * MP;
  float alpha[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    alpha[k] = j < M ? al0[static_cast<size_t>(w) * M + j] : 0.f;
    al[j] = alpha[k];
  }
  float acol[S == 1 ? 32 : 1];  // lane's column of a (M <= 32 only)
  if constexpr (S == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acol[i] = (i < M && lane < M) ? a[i * M + lane] : 0.f;
  }
  __syncwarp();

  const int* row = tokens + static_cast<size_t>(w) * T;
  // chunk c of the token stream holds columns 1 + 32c .. 32 + 32c
  int cur = 1 + lane < T ? row[1 + lane] : kPad;
  int nxt = 33 + lane < T ? row[33 + lane] : kPad;
  int tok = __shfl_sync(kFull, cur, 0);
  float e[S];
  load_emission<S>(e, bt, tok, lane);
  float ll = ll0[w];
  float comp = 0.f;  // Kahan compensation of ll

  for (int t = 1; t < T; ++t) {
    const int off = (t - 1) & 31;
    const int tok_n = __shfl_sync(kFull, off == 31 ? nxt : cur, (off + 1) & 31);
    float e_n[S];
    load_emission<S>(e_n, bt, tok_n, lane);  // consumed next step

    if (tok != kPad) {  // uniform across the warp: one window per warp
      float nx[S];
      if constexpr (S == 1) {
        float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(al + i);
          p0 = fmaf(acol[i], x.x, p0);
          p1 = fmaf(acol[i + 1], x.y, p1);
          p2 = fmaf(acol[i + 2], x.z, p2);
          p3 = fmaf(acol[i + 3], x.w, p3);
        }
        nx[0] = ((p0 + p1) + (p2 + p3)) * e[0];
      } else {
        float acc[S];
#pragma unroll
        for (int k = 0; k < S; ++k) acc[k] = 0.f;
        for (int i = 0; i < m4; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(al + i);
          const float* r = s_a + i * MP + lane;
#pragma unroll
          for (int k = 0; k < S; ++k) {
            acc[k] = fmaf(r[32 * k], x.x, acc[k]);
            acc[k] = fmaf(r[MP + 32 * k], x.y, acc[k]);
            acc[k] = fmaf(r[2 * MP + 32 * k], x.z, acc[k]);
            acc[k] = fmaf(r[3 * MP + 32 * k], x.w, acc[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < S; ++k) nx[k] = acc[k] * e[k];
      }
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < S; ++k) part += nx[k];
      const float s = warp_sum(part);
#pragma unroll
      for (int k = 0; k < S; ++k) alpha[k] = nx[k] / s;
      __syncwarp();  // every lane has read the old alpha row
#pragma unroll
      for (int k = 0; k < S; ++k) al[lane + 32 * k] = alpha[k];
      __syncwarp();
      const float y = logf(s) - comp;
      const float sum = ll + y;
      comp = (sum - ll) - y;
      ll = sum;
    }

    if (off == 31) {
      cur = nxt;
      const int c = t + 33 + lane;
      nxt = c < T ? row[c] : kPad;
    }
    tok = tok_n;
#pragma unroll
    for (int k = 0; k < S; ++k) e[k] = e_n[k];
  }

#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    if (j < M) alpha_out[static_cast<size_t>(w) * M + j] = alpha[k];
  }
  if (lane == 0) ll_out[w] = ll;
}

template <int S>
int launch(const float* a, const float* bt, const float* al0,
           const float* ll0, const int* tokens, float* alpha_out,
           float* ll_out, int W, int T, int M, cudaStream_t stream) {
  constexpr int MP = 32 * S;
  const int m4 = (M + 3) & ~3;
  const size_t smem =
      static_cast<size_t>((S > 1 ? m4 * MP : 0) + kWarps * MP) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_forward_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + kWarps - 1) / kWarps);
  k1_forward_kernel<S><<<grid, kWarps * 32, smem, stream>>>(
      a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pad width of the transposed emission table bt for M states (32*S).
int k1_table_width(int M) { return 32 * ((M + 31) / 32); }

int k1_max_states() { return 32 * kMaxS; }

int k1_forward(const float* a, const float* bt, const float* al0,
               const float* ll0, const int* tokens, float* alpha_out,
               float* ll_out, int W, int T, int M, void* stream) {
  if (W < 1 || T < 1 || M < 1 || M > 32 * kMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 31) / 32) {
    case 1: return launch<1>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    case 2: return launch<2>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    case 3: return launch<3>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    case 4: return launch<4>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    case 5: return launch<5>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    case 6: return launch<6>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    default: return launch<7>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
  }
}

const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
