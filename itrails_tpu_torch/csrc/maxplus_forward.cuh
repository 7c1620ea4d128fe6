// K3's max-plus forward as one warp walks it, shared by K3's forward kernel
// (csrc/viterbi.cu) and K6's operator rows (csrc/maxplus.cu), so that a
// chunk operator's row is K3's own recursion, one body compiled into both.
//
// maxplus_columns walks n columns of one window or one operator row; lane
// l owns states l, l+32, ...  For each non-PAD column, in f32:
//
//   best_j = max_i om[i] + log_a[i][j]    (arg_j: the first i on ties)
//   nv_j   = best_j + log_e[tok][j]
//   om     = nv - max_j nv                 (rescaled every column)
//
// and a PAD column keeps om.  With pointers (K3) column u writes arg into
// row u of the window's table, the identity for PAD; without (K6) the
// rescale maxima are summed into an f64 offset in column order and the
// max takes no argmax.  Every f32 operation is an exact add, max or
// subtract, so the plain versions (hmm/cuda_viterbi.py, hmm/cuda_maxplus.py)
// give the same bits.
//
// Layout of the tables: log_a (M, 32S), row i; for M <= 32 each lane keeps
// its column in registers (``col``), for S <= kSmemMaxS the caller has
// copied it into shared memory (``la``), above that ``la`` is the global
// copy, read through the read-only cache.  The log-emission row is a
// gather from the transposed table lbt (625, 32S), one column ahead.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;      // windows (or operator rows) per block
constexpr int kSmemMaxS = 7;   // log_a in shared memory up to M = 224
constexpr int kTokens = 625;   // alphabet size
constexpr int kPad = -1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Log-emission of the lane's states for one token; the row of a token
// outside the alphabet is clamped to it, as the plain versions' gather.
template <int S>
__device__ __forceinline__ void load_log_emission(float (&e)[S],
                                                  const float* __restrict__ lbt,
                                                  int tok, int lane) {
  const int row = tok < 0 ? 0 : (tok >= kTokens ? kTokens - 1 : tok);
  const float* r = lbt + static_cast<size_t>(row) * (32 * S);
#pragma unroll
  for (int k = 0; k < S; ++k) e[k] = __ldg(r + lane + 32 * k);
}

// Fills the lane's column of log_a (M <= 32), or copies log_a into the
// block's shared memory (S <= kSmemMaxS); returns the rows the walk reads.
// Call before the block's only barrier, which it holds for the shared copy.
template <int S>
__device__ __forceinline__ const float* load_log_a(
    float (&col)[S == 1 ? 32 : 1], const float* __restrict__ la, float* s_la,
    int M, int lane) {
  constexpr int MP = 32 * S;
  if constexpr (S == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) col[i] = i < M ? la[i * MP + lane] : -INFINITY;
    return la;
  } else if constexpr (S <= kSmemMaxS) {
    for (int idx = threadIdx.x; idx < M * MP; idx += blockDim.x)
      s_la[idx] = la[idx];
    __syncthreads();
    return s_la;
  } else {
    return la;
  }
}

// The walk over cols[0..n-1] (PAD = -1); see the note at the top.  ``ptr``
// is the window's (n, M) pointer table with kPointers, else unused, and
// ``offset`` is summed into without kPointers, else untouched.
template <int S, bool kPointers>
__device__ __forceinline__ void maxplus_columns(
    float (&om)[S], const float (&col)[S == 1 ? 32 : 1],
    const float* __restrict__ la, const float* __restrict__ lbt,
    const int* __restrict__ cols, int n, uint8_t* __restrict__ ptr,
    double& offset, int M, int lane) {
  constexpr int MP = 32 * S;
  constexpr bool kRegs = S == 1;
  constexpr bool kShared = S > 1 && S <= kSmemMaxS;
  int tok = n > 0 ? __ldg(cols) : kPad;
  float e[S];
  load_log_emission<S>(e, lbt, tok, lane);

  for (int u = 0; u < n; ++u) {
    const int tok_n = u + 1 < n ? __ldg(cols + u + 1) : kPad;
    float e_n[S];
    load_log_emission<S>(e_n, lbt, tok_n, lane);  // consumed next column
    uint8_t* p = kPointers ? ptr + static_cast<size_t>(u) * M : nullptr;

    if (tok != kPad) {  // uniform across the warp: one walk per warp
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
            if constexpr (kPointers) {
              if (s > best[0]) {
                best[0] = s;
                arg[0] = l;
              }
            } else {
              best[0] = fmaxf(best[0], s);
            }
          }
        } else {
          const int lim = M - base < 32 ? M - base : 32;
          for (int l = 0; l < lim; ++l) {
            const int i = base + l;
            const float oi = __shfl_sync(kFull, om[kk], l);
            const float* r = la + i * MP + lane;
#pragma unroll
            for (int k = 0; k < S; ++k) {
              float a_ij;
              if constexpr (kShared) {
                a_ij = r[32 * k];
              } else {
                a_ij = __ldg(r + 32 * k);
              }
              const float s = oi + a_ij;
              if constexpr (kPointers) {
                if (s > best[k]) {
                  best[k] = s;
                  arg[k] = i;
                }
              } else {
                best[k] = fmaxf(best[k], s);
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
        om[k] = nv[k] - mx;  // -inf stays -inf
        if constexpr (kPointers) {
          if (j < M) p[j] = static_cast<uint8_t>(arg[k]);
        }
      }
      if constexpr (!kPointers) offset += static_cast<double>(mx);
    } else if constexpr (kPointers) {
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
}

}  // namespace
