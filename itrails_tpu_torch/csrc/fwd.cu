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
//   registers, above that a sits in shared memory with a row stride of
//   32S + 1 (M=133: 103 KB).  The register form saves 28 shared-memory
//   loads per column: at M=27 on an H100 80GB HBM3 (700 W) K1 takes
//   9.04-9.08 ms for 4096 x 8192 columns and 132-133 ms for one
//   320,000-column window, against 10.45-10.50 ms and 228 ms with a in
//   shared memory (chip_smoke.py, PERF.md);
// * the emission row is a direct gather from the transposed table
//   bt = bfull^T (625, 32*S), which stays in L1/L2 (80 KB at M=27,
//   400 KB at M=133); the next column's row is requested one step ahead;
// * tokens arrive 32 columns per coalesced warp load, one chunk ahead,
//   and reach the lanes by shuffle;
// * the normalizer is a warp shuffle reduction; the per-window log-sum is
//   an f32 Kahan sum, so its rounding does not grow with T.
//
// Kernel K2 (csrc/grad.cu) includes this file: its forward launch is
// forward_kernel with TC > 0, which also writes alpha at every chunk entry
// of TC columns, and its backward recomputes chunks with forward_step and
// reads a through Mat.  K1 instantiates TC = 0, which compiles the
// checkpoint away.
//
// Launch contract: the C entry point enqueues on the given stream, does
// not synchronize, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kFwdWarps = 8;  // windows per block of the forward kernel
// Blocks of the forward kernel resident on an SM, which caps it at 64
// registers a thread: 4096 windows (512 blocks) then run in one wave on
// the 132 SMs of an H100, where 76-78 registers allowed three blocks and
// two waves.
constexpr int kFwdBlocksPerSM = 4;
constexpr int kMaxS = 7;      // states per lane of K1: M <= 224
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

// The matrix a as a warp reads it: for S == 1 each lane's column (and, for
// K2's a x, its row; unused registers compile away) in registers, else a
// (32S, 32S + 1) zero-padded copy in shared memory, whose odd row stride
// lets both a^T x and a x read it without bank conflicts.
template <int S>
struct Mat {
  static constexpr int MP = 32 * S;
  static constexpr int LDA = MP + 1;
  float col[S == 1 ? 32 : 1];  // col[i] = a[i][lane]
  float row[S == 1 ? 32 : 1];  // row[j] = a[lane][j]
  const float* s_a;            // s_a[i * LDA + j] = a[i][j]
  int m4;

  // Fills the registers (S == 1) or the block's shared copy (S > 1); the
  // caller synchronizes the block before the first product.
  __device__ __forceinline__ void load(const float* __restrict__ a, float* smem,
                                       int M, int lane) {
    m4 = (M + 3) & ~3;
    if constexpr (S == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        col[i] = (i < M && lane < M) ? a[i * M + lane] : 0.f;
        row[i] = (i < M && lane < M) ? a[lane * M + i] : 0.f;
      }
      s_a = nullptr;
    } else {
      for (int idx = threadIdx.x; idx < MP * MP; idx += blockDim.x) {
        const int i = idx / MP, j = idx - (idx / MP) * MP;
        smem[i * LDA + j] = (i < M && j < M) ? a[i * M + j] : 0.f;
      }
      s_a = smem;
    }
  }

  // out[k] = (a^T x)_{lane + 32k}; x is a 16-byte aligned shared row of MP
  // floats that every lane of the warp has written.
  __device__ __forceinline__ void at_x(float (&out)[S], const float* x,
                                       int lane) const {
    if constexpr (S == 1) {
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + i);
        p0 = fmaf(col[i], v.x, p0);
        p1 = fmaf(col[i + 1], v.y, p1);
        p2 = fmaf(col[i + 2], v.z, p2);
        p3 = fmaf(col[i + 3], v.w, p3);
      }
      out[0] = (p0 + p1) + (p2 + p3);
    } else {
#pragma unroll
      for (int k = 0; k < S; ++k) out[k] = 0.f;
      for (int i = 0; i < m4; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + i);
        const float* r = s_a + i * LDA + lane;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          out[k] = fmaf(r[32 * k], v.x, out[k]);
          out[k] = fmaf(r[LDA + 32 * k], v.y, out[k]);
          out[k] = fmaf(r[2 * LDA + 32 * k], v.z, out[k]);
          out[k] = fmaf(r[3 * LDA + 32 * k], v.w, out[k]);
        }
      }
    }
  }

  // out[k] = (a x)_{lane + 32k}, x as for at_x.
  __device__ __forceinline__ void a_x(float (&out)[S], const float* x,
                                      int lane) const {
    if constexpr (S == 1) {
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + j);
        p0 = fmaf(row[j], v.x, p0);
        p1 = fmaf(row[j + 1], v.y, p1);
        p2 = fmaf(row[j + 2], v.z, p2);
        p3 = fmaf(row[j + 3], v.w, p3);
      }
      out[0] = (p0 + p1) + (p2 + p3);
    } else {
#pragma unroll
      for (int k = 0; k < S; ++k) out[k] = 0.f;
      for (int j = 0; j < m4; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + j);
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const float* r = s_a + (lane + 32 * k) * LDA + j;
          out[k] = fmaf(r[0], v.x, out[k]);
          out[k] = fmaf(r[1], v.y, out[k]);
          out[k] = fmaf(r[2], v.z, out[k]);
          out[k] = fmaf(r[3], v.w, out[k]);
        }
      }
    }
  }
};

// One forward column: reads alpha from the warp's shared row x, returns
// a^T alpha in atu and the normalized next alpha, and the normalizer.
// Every lane must have written x before the call.
template <int S>
__device__ __forceinline__ float forward_step(const Mat<S>& am,
                                              const float* x,
                                              const float (&e)[S],
                                              float (&atu)[S],
                                              float (&alpha)[S], int lane) {
  am.at_x(atu, x, lane);
  float nx[S];
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    nx[k] = atu[k] * e[k];
    part += nx[k];
  }
  const float s = warp_sum(part);
#pragma unroll
  for (int k = 0; k < S; ++k) alpha[k] = nx[k] / s;
  return s;
}

// The forward recurrence over columns 1..T-1 of every window.  With
// TC > 0 it also writes the carry before columns 1, 1 + TC, 1 + 2 TC, ...
// into chk; a null alpha_out skips the final alpha.
template <int S, int TC>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdBlocksPerSM)
forward_kernel(const float* __restrict__ a,     // (M, M) row-major
               const float* __restrict__ bt,    // (625, 32*S), zero pad
               const float* __restrict__ al0,   // (W, M) alpha after col 0
               const float* __restrict__ ll0,   // (W,) log-norm of col 0
               const int* __restrict__ tokens,  // (W, T), PAD = -1
               float* __restrict__ alpha_out,   // (W, M) or null
               float* __restrict__ ll_out,      // (W,)
               float* __restrict__ chk,         // (n_chunks, W, 32*S), TC > 0
               int W, int T, int M) {
  constexpr int MP = 32 * S;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_al = smem + (S > 1 ? MP * Mat<S>::LDA : 0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Mat<S> am;
  am.load(a, smem, M, lane);
  __syncthreads();
  const int w = blockIdx.x * kFwdWarps + warp;
  if (w >= W) return;  // after the only block-wide barrier

  float* al = s_al + warp * MP;
  float alpha[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    alpha[k] = j < M ? al0[static_cast<size_t>(w) * M + j] : 0.f;
    al[j] = alpha[k];
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
    if constexpr (TC > 0) {
      if ((t - 1) % TC == 0) {  // chunk entry: the carry before column t
        float* c = chk + (static_cast<size_t>((t - 1) / TC) * W + w) * MP;
#pragma unroll
        for (int k = 0; k < S; ++k) c[lane + 32 * k] = alpha[k];
      }
    }

    if (tok != kPad) {  // uniform across the warp: one window per warp
      float atu[S];
      const float s = forward_step<S>(am, al, e, atu, alpha, lane);
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

  if (alpha_out != nullptr) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int j = lane + 32 * k;
      if (j < M) alpha_out[static_cast<size_t>(w) * M + j] = alpha[k];
    }
  }
  if (lane == 0) ll_out[w] = ll;
}

// Dynamic shared memory of forward_kernel: a (S > 1) and one alpha row a warp.
template <int S>
size_t forward_smem() {
  return static_cast<size_t>((S > 1 ? 32 * S * Mat<S>::LDA : 0) +
                             kFwdWarps * 32 * S) * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int S>
int launch_k1(const float* a, const float* bt, const float* al0,
              const float* ll0, const int* tokens, float* alpha_out,
              float* ll_out, int W, int T, int M, cudaStream_t stream) {
  const size_t smem = forward_smem<S>();
  const cudaError_t err = allow_smem(forward_kernel<S, 0>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kFwdWarps - 1) / kFwdWarps);
  forward_kernel<S, 0><<<grid, kFwdWarps * 32, smem, stream>>>(
      a, bt, al0, ll0, tokens, alpha_out, ll_out, nullptr, W, T, M);
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
    case 1: return launch_k1<1>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    case 2: return launch_k1<2>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    case 3: return launch_k1<3>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    case 4: return launch_k1<4>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    case 5: return launch_k1<5>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    case 6: return launch_k1<6>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
    default: return launch_k1<7>(a, bt, al0, ll0, tokens, alpha_out, ll_out, W, T, M, s);
  }
}

const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
