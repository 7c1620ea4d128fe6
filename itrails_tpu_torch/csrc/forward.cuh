// The one-warp-a-window scaled forward kernel of the coalescent HMM on
// Hopper (sm_90a), with the helpers and the table layout that the port's
// kernels share.  Included by csrc/grad.cu (K2), csrc/posterior.cu (K4)
// and csrc/rows.cuh (the row kernels of K1 and K5).
//
// forward_kernel (with Mat, forward_step and load_emission) is K2's
// forward (csrc/grad.cu) and K4's alpha pass (csrc/posterior.cu), and
// nothing else; K1 is csrc/fwd.cu.  For every window w of a (W, T) token
// batch, columns 1..T-1 (column 0 is done by the wrappers):
//
//     alpha_t = normalize((a^T alpha_{t-1}) * bfull[:, tok_t]),
//     ll_w   += log(sum((a^T alpha_{t-1}) * bfull[:, tok_t])),
//
//   where a PAD token (-1) leaves alpha and ll unchanged.  Outputs: the
//   normalized final alpha (W, M) in the tables' scalar (float or double)
//   and the per-window loglik (W,) in f64, the value ll - comp of the
//   kernel's Kahan pair, so a long window's loglik keeps the compensation
//   (at ~1e8 nats one f32 ulp is 8).
//
// Design of forward_kernel (simple and exact first):
// * one warp per window, eight windows per block; lane l owns states
//   l, l+32, ..., so M <= 32*kMaxS;
// * alpha lives in registers and in a per-warp shared-memory row that the
//   warp reads back, four states at a time, as the broadcast operand of
//   the product; for M <= 32 each lane keeps its column of a in
//   registers, above that a sits in shared memory with a row stride of
//   32S + 1 (M=133: 103 KB).  The register form saves 28 shared-memory
//   loads per column: at M=27 on an H100 80GB HBM3 (700 W) the forward
//   took 9.04-9.08 ms for 4096 x 8192 columns and 132-133 ms for one
//   320,000-column window, against 10.45-10.50 ms and 228 ms with a in
//   shared memory (chip_smoke.py, PERF.md);
// * the emission row is a direct gather from the transposed table
//   bt = bfull^T (625, 32*S), which stays in L1/L2 (80 KB at M=27,
//   400 KB at M=133); the next column's row is requested one step ahead;
// * tokens arrive 32 columns per coalesced warp load, one chunk ahead,
//   and reach the lanes by shuffle;
// * the normalizer is a warp shuffle reduction; the per-window log-sum is
//   an f32 Kahan sum, so its rounding does not grow with T, and it leaves
//   the kernel as the f64 value of the sum minus its compensation.
//
// The helpers below are templated on the scalar R.  K2 instantiates float
// only, K4 float and double, each with a (and the product's accumulation)
// in double; K5 (csrc/operators.cu) and K1 reuse
// load_emission.  With G = true, Mat reads a from a zero-padded
// (32S, 32S + 1) copy in global memory (L2) instead of shared memory, for
// the sizes where shared memory cannot hold it beside a kernel's other
// rows: K4 in double above S = 5 (a_in_global).
//
// K2's forward launch is forward_kernel with TC > 0, which also writes
// alpha at every chunk entry of TC columns, and its backward recomputes
// chunks with forward_step and reads a through Mat; K4's is TC = 1.
//
// A header with no kernel of its own: a library instantiates what it
// launches.  It does export, from every library that includes it, the
// tables' layout on the card (k1_table_width, k1_a_stride,
// k1_max_states; hmm/cuda_fwd.py bind_layout), so each wrapper pads its
// tables by the rule of the library it calls.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kFwdWarps = 8;  // windows per block of the forward kernel
// Blocks of the forward kernel resident on an SM, which caps it at 64
// registers a thread: 4096 windows (512 blocks) then run in one wave on
// the 132 SMs of an H100, where 76-78 registers allowed three blocks and
// two waves.
constexpr int kFwdBlocksPerSM = 4;
constexpr int kMaxS = 7;      // states per lane: M <= 224
constexpr int kTokens = 625;  // alphabet size
constexpr int kPad = -1;
constexpr unsigned kFull = 0xffffffffu;

template <typename R>
__device__ __forceinline__ R warp_sum(R x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float fma_r(float x, float y, float z) {
  return fmaf(x, y, z);
}
__device__ __forceinline__ double fma_r(double x, double y, double z) {
  return fma(x, y, z);
}
__device__ __forceinline__ float log_r(float x) { return logf(x); }
__device__ __forceinline__ double log_r(double x) { return log(x); }

// Four consecutive elements of a shared row (16-byte aligned for float,
// 32-byte aligned for double).
struct Four32 { float x, y, z, w; };
struct Four64 { double x, y, z, w; };
__device__ __forceinline__ Four32 load4(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Four64 load4(const double* p) {
  const double2 u = *reinterpret_cast<const double2*>(p);
  const double2 v = *reinterpret_cast<const double2*>(p + 2);
  return {u.x, u.y, v.x, v.y};
}

// Emission of the lane's states for one token.  A PAD token is never used;
// a token outside the alphabet gives 0, so the window's loglik becomes
// -inf instead of reading outside the table.
template <int S, typename R>
__device__ __forceinline__ void load_emission(R (&e)[S],
                                              const R* __restrict__ bt,
                                              int tok, int lane) {
  const bool ok = static_cast<unsigned>(tok) < static_cast<unsigned>(kTokens);
  const R* row = bt + static_cast<size_t>(ok ? tok : 0) * (32 * S);
#pragma unroll
  for (int k = 0; k < S; ++k) e[k] = ok ? __ldg(row + lane + 32 * k) : R(0);
}

// The matrix a as a warp reads it: for S == 1 each lane's column (and, for
// K2's a x, its row; unused registers compile away) in registers, else a
// (32S, 32S + 1) zero-padded copy in shared memory (or, with G, in global
// memory), whose odd row stride lets both a^T x and a x read it without
// bank conflicts.
template <int S, typename R = float, bool G = false>
struct Mat {
  static_assert(S > 1 || !G, "a sits in registers at S == 1");
  static constexpr int MP = 32 * S;
  static constexpr int LDA = MP + 1;
  // elements of R that the copy of a takes in the block's shared memory
  static constexpr int kSmem = (S > 1 && !G) ? MP * LDA : 0;
  R col[S == 1 ? 32 : 1];  // col[i] = a[i][lane]
  R row[S == 1 ? 32 : 1];  // row[j] = a[lane][j]
  const R* s_a;            // s_a[i * LDA + j] = a[i][j]
  int m4;

  // Fills the registers (S == 1) or the block's shared copy (S > 1, !G);
  // with G, a is already the padded (MP, LDA) copy in global memory.  The
  // caller synchronizes the block before the first product.
  __device__ __forceinline__ void load(const R* __restrict__ a, R* smem,
                                       int M, int lane) {
    m4 = (M + 3) & ~3;
    if constexpr (S == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        col[i] = (i < M && lane < M) ? a[i * M + lane] : R(0);
        row[i] = (i < M && lane < M) ? a[lane * M + i] : R(0);
      }
      s_a = nullptr;
    } else if constexpr (G) {
      s_a = a;
    } else {
      for (int idx = threadIdx.x; idx < MP * MP; idx += blockDim.x) {
        const int i = idx / MP, j = idx - (idx / MP) * MP;
        smem[i * LDA + j] = (i < M && j < M) ? a[i * M + j] : R(0);
      }
      s_a = smem;
    }
  }

  // out[k] = (a^T x)_{lane + 32k}; x is a 16-byte aligned shared row of MP
  // elements that every lane of the warp has written.
  __device__ __forceinline__ void at_x(R (&out)[S], const R* x,
                                       int lane) const {
    if constexpr (S == 1) {
      R p0 = 0, p1 = 0, p2 = 0, p3 = 0;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        const auto v = load4(x + i);
        p0 = fma_r(col[i], v.x, p0);
        p1 = fma_r(col[i + 1], v.y, p1);
        p2 = fma_r(col[i + 2], v.z, p2);
        p3 = fma_r(col[i + 3], v.w, p3);
      }
      out[0] = (p0 + p1) + (p2 + p3);
    } else {
#pragma unroll
      for (int k = 0; k < S; ++k) out[k] = 0;
      for (int i = 0; i < m4; i += 4) {
        const auto v = load4(x + i);
        const R* r = s_a + i * LDA + lane;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          out[k] = fma_r(r[32 * k], v.x, out[k]);
          out[k] = fma_r(r[LDA + 32 * k], v.y, out[k]);
          out[k] = fma_r(r[2 * LDA + 32 * k], v.z, out[k]);
          out[k] = fma_r(r[3 * LDA + 32 * k], v.w, out[k]);
        }
      }
    }
  }

  // out[k] = (a x)_{lane + 32k}, x as for at_x.
  __device__ __forceinline__ void a_x(R (&out)[S], const R* x,
                                      int lane) const {
    if constexpr (S == 1) {
      R p0 = 0, p1 = 0, p2 = 0, p3 = 0;
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const auto v = load4(x + j);
        p0 = fma_r(row[j], v.x, p0);
        p1 = fma_r(row[j + 1], v.y, p1);
        p2 = fma_r(row[j + 2], v.z, p2);
        p3 = fma_r(row[j + 3], v.w, p3);
      }
      out[0] = (p0 + p1) + (p2 + p3);
    } else {
#pragma unroll
      for (int k = 0; k < S; ++k) out[k] = 0;
      for (int j = 0; j < m4; j += 4) {
        const auto v = load4(x + j);
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const R* r = s_a + (lane + 32 * k) * LDA + j;
          out[k] = fma_r(r[0], v.x, out[k]);
          out[k] = fma_r(r[1], v.y, out[k]);
          out[k] = fma_r(r[2], v.z, out[k]);
          out[k] = fma_r(r[3], v.w, out[k]);
        }
      }
    }
  }
};

// One forward column: reads alpha from the warp's shared row x, returns
// a^T alpha in atu and the normalized next alpha, and the normalizer.
// Every lane must have written x before the call.  The product runs in A,
// the scalar of a and of x (K4's float instantiation: double), and is
// rounded to R once.
template <int S, typename R, typename A, bool G>
__device__ __forceinline__ R forward_step(const Mat<S, A, G>& am, const A* x,
                                          const R (&e)[S], R (&atu)[S],
                                          R (&alpha)[S], int lane) {
  A acc[S];
  am.at_x(acc, x, lane);
  R nx[S];
  R part = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    atu[k] = static_cast<R>(acc[k]);
    nx[k] = atu[k] * e[k];
    part += nx[k];
  }
  const R s = warp_sum(part);
#pragma unroll
  for (int k = 0; k < S; ++k) alpha[k] = nx[k] / s;
  return s;
}

// The forward recurrence over columns 1..T-1 of every window.  With
// TC > 0 it also writes the carry before columns 1, 1 + TC, 1 + 2 TC, ...
// into chk; a null alpha_out skips the final alpha, and a null ll_out the
// loglik (ll0 is then not read).  A is the scalar of a and of the shared
// alpha rows, in which the product accumulates (K4: double in both its
// instantiations); an instantiation with a in double is capped at two
// blocks an SM instead of four, which leaves it 128 registers.
template <int S, int TC, typename R = float, bool G = false, typename A = R>
__global__ void __launch_bounds__(kFwdWarps * 32,
                                  sizeof(A) == 4 ? kFwdBlocksPerSM : 2)
forward_kernel(const A* __restrict__ a,         // (M, M), or (32S, 32S+1) with G
               const R* __restrict__ bt,        // (625, 32*S), zero pad
               const R* __restrict__ al0,       // (W, M) alpha after col 0
               const R* __restrict__ ll0,       // (W,) log-norm of col 0
               const int* __restrict__ tokens,  // (W, T), PAD = -1
               R* __restrict__ alpha_out,       // (W, M) or null
               double* __restrict__ ll_out,     // (W,) or null
               R* __restrict__ chk,             // (n_chunks, W, 32*S), TC > 0
               int W, int T, int M) {
  constexpr int MP = 32 * S;
  extern __shared__ float4 smem4[];
  A* smem = reinterpret_cast<A*>(smem4);
  A* s_al = smem + Mat<S, A, G>::kSmem;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Mat<S, A, G> am;
  am.load(a, smem, M, lane);
  __syncthreads();
  const int w = blockIdx.x * kFwdWarps + warp;
  if (w >= W) return;  // after the only block-wide barrier

  A* al = s_al + warp * MP;
  R alpha[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    alpha[k] = j < M ? al0[static_cast<size_t>(w) * M + j] : R(0);
    al[j] = alpha[k];
  }
  __syncwarp();

  const int* row = tokens + static_cast<size_t>(w) * T;
  // chunk c of the token stream holds columns 1 + 32c .. 32 + 32c
  int cur = 1 + lane < T ? row[1 + lane] : kPad;
  int nxt = 33 + lane < T ? row[33 + lane] : kPad;
  int tok = __shfl_sync(kFull, cur, 0);
  R e[S];
  load_emission<S>(e, bt, tok, lane);
  R ll = ll_out != nullptr ? ll0[w] : R(0);
  R comp = 0;  // Kahan compensation of ll

  for (int t = 1; t < T; ++t) {
    const int off = (t - 1) & 31;
    const int tok_n = __shfl_sync(kFull, off == 31 ? nxt : cur, (off + 1) & 31);
    R e_n[S];
    load_emission<S>(e_n, bt, tok_n, lane);  // consumed next step
    if constexpr (TC > 0) {
      if ((t - 1) % TC == 0) {  // chunk entry: the carry before column t
        R* c = chk + (static_cast<size_t>((t - 1) / TC) * W + w) * MP;
#pragma unroll
        for (int k = 0; k < S; ++k) c[lane + 32 * k] = alpha[k];
      }
    }

    if (tok != kPad) {  // uniform across the warp: one window per warp
      R atu[S];
      const R s = forward_step<S>(am, al, e, atu, alpha, lane);
      __syncwarp();  // every lane has read the old alpha row
#pragma unroll
      for (int k = 0; k < S; ++k) al[lane + 32 * k] = alpha[k];
      __syncwarp();
      if (ll_out != nullptr) {
        const R y = log_r(s) - comp;
        const R sum = ll + y;
        comp = (sum - ll) - y;
        ll = sum;
      }
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
  if (ll_out != nullptr && lane == 0)  // the compensated sum
    ll_out[w] = static_cast<double>(ll) - static_cast<double>(comp);
}

// Dynamic shared memory of forward_kernel: a (S > 1, !G) and one alpha row
// a warp, in the scalar A of a.
template <int S, typename A = float, bool G = false>
size_t forward_smem() {
  return static_cast<size_t>(Mat<S, A, G>::kSmem + kFwdWarps * 32 * S) *
         sizeof(A);
}

// Whether the forward kernel with a in scalar R (K4) reads a from a padded
// copy in global memory (L2): in double above S = 5 the (32S, 32S + 1)
// copy no longer fits the 227 KB of shared memory a block may use beside
// the warps' rows (S = 5: 206 KB of a and 10 KB of rows; S = 6: 296 KB of
// a).
template <int S, typename R>
constexpr bool a_in_global() {
  return sizeof(R) == 8 && S > 5;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Calls f with std::integral_constant<int, S> for S = (M + 31) / 32, the
// states a lane owns (M <= 32 * kMaxS).
template <typename F>
int dispatch_s(int M, F&& f) {
  switch ((M + 31) / 32) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    default: return f(std::integral_constant<int, 7>{});
  }
}

}  // namespace

extern "C" {

// Pad width of the transposed emission table bt for M states (32*S).
int k1_table_width(int M) { return 32 * ((M + 31) / 32); }

int k1_max_states() { return 32 * kMaxS; }

// Row stride of the zero-padded (32S, 32S + 1) copy of a that a kernel
// reads from global memory at M states with a in double (f64 != 0; K4 in
// both its instantiations) or float, or 0 where it takes a as the plain
// (M, M) matrix.
int k1_a_stride(int M, int f64) {
  const int S = (M + 31) / 32;
  return f64 != 0 && S > 5 ? 32 * S + 1 : 0;
}

}  // extern "C"
