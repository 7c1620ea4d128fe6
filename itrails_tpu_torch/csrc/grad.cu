// Kernel K2: the forward log-likelihood of the coalescent HMM and its
// exact gradient with respect to (a, bfull), written for Hopper (sm_90a).
//
// Replaces itrails_tpu/hmm/pallas_grad.py:203 loglik_and_grads_fused (its
// Pallas bodies are _fwd_kernel, :61, and _bwd_kernel, :104).  For every
// window w of a (W, T) token batch and columns 1..T-1 (column 0 is done by
// the wrapper, as on the TPU):
//
//   forward   alpha_t = normalize((a^T alpha_{t-1}) * e_t),  e_t = bfull[:, tok_t]
//             ll_w   += log(sum((a^T alpha_{t-1}) * e_t))
//   backward  with u = alpha_{t-1}, atu = a^T u, v = e_t * beta_t and
//             Z_t = sum_j atu_j v_j:
//             dA[i, j]       += u_i v_j / Z_t
//             dB[j, tok_t]   += atu_j beta_t(j) / Z_t
//             beta_{t-1}      = normalize(a v)
//
// Every per-step normalization cancels inside Z_t, so no log bookkeeping
// is needed.  A PAD token (-1) leaves alpha, beta and the sums unchanged.
// Beta at column T-1 is ones, or a given exit row per window: a window
// that is one chunk of a long block then ends where the rest of the block
// begins (the wrapper likewise starts its forward from a given entry row).
// Outputs: the per-window loglik (W,) in f64 (a compensated sum), beta
// at the origin (W, 32*S), and per-block partial sums of dA (G, 32*S, 32*S)
// and dB (G, 625, 32*S); the wrapper sums the partials over blocks in a
// fixed order and does column 0.
//
// Two launches per call:
// * the forward: forward_kernel (csrc/forward.cuh, included below) instantiated
//   to also write alpha at every chunk entry into a checkpoint
//   (n_chunks, W, 32*S) f32, chunks of kChunk columns;
// * k2_backward: one warp per window walks the chunks in reverse.  For each
//   chunk it recomputes the chunk's alpha rows and their a^T alpha from the
//   checkpoint into per-warp shared-memory rows, with the forward's own
//   step, then sweeps the chunk backwards with beta in registers,
//   writing v / Z and atu * beta / Z rows.  At the chunk's end the block
//   folds its warps' rows into dA and dB: warp g owns dA rows 4g..4g+3
//   (mod 4 * kWarps) and every token tok with tok % kWarps == g, so each
//   entry has one owner lane that adds in a fixed order.  No atomics: two
//   runs on the same inputs give the same bits, and L-BFGS-B runs repeat.
//   The block's partials sit in device memory (mostly in L2): dB's is
//   80 KB at M <= 32 and 400 KB at M = 133.  In shared memory at M <= 32 it
//   held a block to one per SM and made K2 slower: 57.0 ms against 37.4 ms
//   for 4096 x 8192 columns at M = 27 on an H100 80GB HBM3, 700 W, and
//   600 ms against 579 ms for one 320,000-column window (chip_smoke.py,
//   PERF.md).
//
// What bounds it on an H100: per non-PAD column the function needs three
// M x M products (the forward's a^T alpha, a v and the dA outer product,
// 6 M^2 f32 flops) against 4 bytes of token traffic: 33.5 M columns at
// M = 27 are ~0.16 TFLOP, ~2.4 ms at 67 TFLOP/s outside the tensor cores,
// against ~0.13 GB (~0.04 ms) of tokens.  It is bound by f32 FMA issue.
// The checkpoint design adds a fourth product, the recompute (8 M^2 done
// per column) and the checkpoint's traffic (0.27 GB written and read back
// at M = 27), in exchange for storing alpha once per chunk instead of once
// per column.  The recurrence
// is sequential in t, so its parallelism is across windows.  A long block
// is therefore never one window here: hmm/longseq.py cuts it into chunk
// windows with boundary rows from K5's transfer operators, one warp a
// chunk.
//
// Design (simple and exact first): the product forms of forward.cuh (Mat: for
// M <= 32 each lane keeps its column and its row of a in registers; above
// that a sits in shared memory with a padded row stride, so both a^T x and
// a x read it without bank conflicts); z is clamped at 1e-30 as on the TPU.
//
// Launch contract: the C entry point enqueues on the given stream, does
// not synchronize, allocates nothing, and returns cudaGetLastError().  The
// dA and dB partials must be zero on entry.

#include "forward.cuh"  // forward_kernel, Mat, forward_step and the helpers

namespace {

constexpr int kGradMaxS = 5;  // states per lane of K2: M <= 160

// Backward block shape: windows per block and columns per chunk.
template <int S>
struct Bwd {
  static constexpr int kWarps = S == 1 ? 8 : 4;
  static constexpr int kChunk = S == 1 ? 16 : 8;
};

// kExit: beta at column T-1 is read from beta_in (a window that is one
// chunk of a long block); otherwise it is ones and beta_in is not read, so
// the bucket's instantiation is the kernel it was before exit rows existed.
template <int S, bool kExit>
__global__ void __launch_bounds__(Bwd<S>::kWarps * 32)
k2_backward_kernel(const float* __restrict__ a,     // (M, M) row-major
                   const float* __restrict__ bt,    // (625, 32*S), zero pad
                   const float* __restrict__ chk,   // (n_chunks, W, 32*S)
                   const int* __restrict__ tokens,  // (W, T), PAD = -1
                   const float* __restrict__ beta_in,  // (W, M), kExit
                   float* __restrict__ beta0,       // (W, 32*S)
                   float* __restrict__ da_part,     // (G, 32*S, 32*S), zeros
                   float* __restrict__ db_part,     // (G, 625, 32*S), zeros
                   int W, int T, int M, int n_chunks) {
  constexpr int MP = 32 * S;
  constexpr int NW = Bwd<S>::kWarps;
  constexpr int TC = Bwd<S>::kChunk;
  constexpr int ROWS = TC * MP;  // one warp's rows of one buffer
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_a = smem;                                  // S > 1
  float* s_u = s_a + (S > 1 ? MP * Mat<S>::LDA : 0);  // alpha_{t-1} rows
  float* s_w = s_u + NW * ROWS;                       // v / Z rows
  float* s_q = s_w + NW * ROWS;                       // a^T u, then dB rows
  int* s_tok = reinterpret_cast<int*>(s_q + NW * ROWS);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * NW + warp;
  const bool live = w < W;  // a warp past W sweeps PAD columns only
  Mat<S> am;
  am.load(a, s_a, M, lane);
  __syncthreads();

  float* db = db_part + static_cast<size_t>(blockIdx.x) * kTokens * MP;
  float* da = da_part + static_cast<size_t>(blockIdx.x) * MP * MP;
  float* u_rows = s_u + warp * ROWS;
  float* w_rows = s_w + warp * ROWS;
  float* q_rows = s_q + warp * ROWS;
  int* toks = s_tok + warp * TC;
  const int* row = tokens + static_cast<size_t>(live ? w : 0) * T;
  float beta[S];  // beta at column T-1
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = lane + 32 * k;
    if constexpr (kExit)
      beta[k] = j < M && live ? beta_in[static_cast<size_t>(w) * M + j] : 0.f;
    else
      beta[k] = j < M ? 1.f : 0.f;
  }

  for (int c = n_chunks - 1; c >= 0; --c) {
    if (lane < TC) {
      const int col = 1 + c * TC + lane;
      toks[lane] = live && col < T ? __ldg(row + col) : kPad;
    }
    // pass 1: recompute the chunk's alpha rows and a^T alpha
    float alpha[S];
#pragma unroll
    for (int k = 0; k < S; ++k)
      alpha[k] = live ? chk[(static_cast<size_t>(c) * W + w) * MP + lane + 32 * k]
                      : 0.f;
    __syncwarp();
    for (int t = 0; t < TC; ++t) {
      float* u = u_rows + t * MP;
#pragma unroll
      for (int k = 0; k < S; ++k) u[lane + 32 * k] = alpha[k];
      __syncwarp();
      const int tok = toks[t];
      float atu[S];
      if (tok != kPad) {
        float e[S];
        load_emission<S>(e, bt, tok, lane);
        forward_step<S>(am, u, e, atu, alpha, lane);
      } else {
#pragma unroll
        for (int k = 0; k < S; ++k) atu[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < S; ++k) q_rows[t * MP + lane + 32 * k] = atu[k];
    }
    // pass 2: reverse sweep with beta in registers
    for (int t = TC - 1; t >= 0; --t) {
      const int tok = toks[t];
      float* wv = w_rows + t * MP;
      float* q = q_rows + t * MP;
      if (tok == kPad) {
#pragma unroll
        for (int k = 0; k < S; ++k) wv[lane + 32 * k] = q[lane + 32 * k] = 0.f;
        continue;
      }
      float e[S], v[S], atu[S];
      load_emission<S>(e, bt, tok, lane);
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        atu[k] = q[lane + 32 * k];
        v[k] = e[k] * beta[k];
        part += atu[k] * v[k];
      }
      const float zinv = 1.f / fmaxf(warp_sum(part), 1e-30f);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        wv[lane + 32 * k] = v[k] * zinv;
        q[lane + 32 * k] = atu[k] * beta[k] * zinv;
      }
      __syncwarp();
      float av[S];  // a (v / Z): beta's scale is normalized away
      am.a_x(av, wv, lane);
      part = 0.f;
#pragma unroll
      for (int k = 0; k < S; ++k) part += av[k];
      const float s = fmaxf(warp_sum(part), 1e-30f);
#pragma unroll
      for (int k = 0; k < S; ++k) beta[k] = av[k] / s;
    }
    __syncthreads();

    // fold the block's rows into dA: warp g owns row groups g, g + NW, ...
    for (int g4 = warp; g4 < MP / 4; g4 += NW) {
      float acc[4][S];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < S; ++k) acc[r][k] = 0.f;
      for (int e = 0; e < NW * TC; ++e) {
        const float4 u4 = *reinterpret_cast<const float4*>(s_u + e * MP + 4 * g4);
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const float wk = s_w[e * MP + lane + 32 * k];
          acc[0][k] = fmaf(u4.x, wk, acc[0][k]);
          acc[1][k] = fmaf(u4.y, wk, acc[1][k]);
          acc[2][k] = fmaf(u4.z, wk, acc[2][k]);
          acc[3][k] = fmaf(u4.w, wk, acc[3][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < S; ++k) da[(4 * g4 + r) * MP + lane + 32 * k] += acc[r][k];
    }
    // ... and into dB: warp g owns the tokens tok % NW == g
    for (int e = 0; e < NW * TC; ++e) {
      const int tok = s_tok[e];
      if (static_cast<unsigned>(tok) < static_cast<unsigned>(kTokens) &&
          tok % NW == warp) {
#pragma unroll
        for (int k = 0; k < S; ++k)
          db[tok * MP + lane + 32 * k] += s_q[e * MP + lane + 32 * k];
      }
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      beta0[static_cast<size_t>(w) * MP + lane + 32 * k] = beta[k];
  }
}

template <int S>
size_t backward_smem() {
  constexpr int MP = 32 * S;
  constexpr int NW = Bwd<S>::kWarps;
  constexpr int TC = Bwd<S>::kChunk;
  return static_cast<size_t>((S > 1 ? MP * Mat<S>::LDA : 0) +
                             3 * NW * TC * MP + NW * TC) * sizeof(float);
}

template <int S>
int launch_k2(const float* a, const float* bt, const float* al0,
              const float* ll0, const int* tokens, const float* beta_in,
              float* chk, double* ll_out, float* beta0, float* da_part,
              float* db_part, int W, int T, int M, cudaStream_t stream) {
  const size_t fsm = forward_smem<S>();
  const size_t bsm = backward_smem<S>();
  constexpr int TC = Bwd<S>::kChunk;
  cudaError_t err = allow_smem(forward_kernel<S, TC, float, false>, fsm);
  if (err == cudaSuccess)
    err = beta_in != nullptr ? allow_smem(k2_backward_kernel<S, true>, bsm)
                             : allow_smem(k2_backward_kernel<S, false>, bsm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (T - 1 + TC - 1) / TC;
  forward_kernel<S, TC, float, false>
      <<<(W + kFwdWarps - 1) / kFwdWarps, kFwdWarps * 32, fsm, stream>>>(
          a, bt, al0, ll0, tokens, nullptr, ll_out, chk, W, T, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int NW = Bwd<S>::kWarps;
  const dim3 grid((W + NW - 1) / NW);
  if (beta_in != nullptr)
    k2_backward_kernel<S, true><<<grid, NW * 32, bsm, stream>>>(
        a, bt, chk, tokens, beta_in, beta0, da_part, db_part, W, T, M,
        n_chunks);
  else
    k2_backward_kernel<S, false><<<grid, NW * 32, bsm, stream>>>(
        a, bt, chk, tokens, nullptr, beta0, da_part, db_part, W, T, M,
        n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pad width of the state axis for M states (32*S): the transposed
// emission table, the checkpoint, beta0 and the partials use it.
int k2_table_width(int M) { return 32 * ((M + 31) / 32); }

int k2_max_states() { return 32 * kGradMaxS; }

// Columns per chunk of the checkpoint for M states.
int k2_chunk(int M) {
  switch ((M + 31) / 32) {
    case 1: return Bwd<1>::kChunk;
    default: return Bwd<2>::kChunk;
  }
}

// Blocks of the backward kernel, the leading axis of the partials.
int k2_blocks(int W, int M) {
  const int nw = (M + 31) / 32 == 1 ? Bwd<1>::kWarps : Bwd<2>::kWarps;
  return (W + nw - 1) / nw;
}

int k2_loglik_and_grads(const float* a, const float* bt, const float* al0,
                        const float* ll0, const int* tokens,
                        const float* beta_in, float* chk, double* ll_out,
                        float* beta0, float* da_part, float* db_part, int W,
                        int T, int M, void* stream) {
  if (W < 1 || T < 1 || M < 1 || M > 32 * kGradMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 31) / 32) {
    case 1: return launch_k2<1>(a, bt, al0, ll0, tokens, beta_in, chk, ll_out, beta0, da_part, db_part, W, T, M, s);
    case 2: return launch_k2<2>(a, bt, al0, ll0, tokens, beta_in, chk, ll_out, beta0, da_part, db_part, W, T, M, s);
    case 3: return launch_k2<3>(a, bt, al0, ll0, tokens, beta_in, chk, ll_out, beta0, da_part, db_part, W, T, M, s);
    case 4: return launch_k2<4>(a, bt, al0, ll0, tokens, beta_in, chk, ll_out, beta0, da_part, db_part, W, T, M, s);
    default: return launch_k2<5>(a, bt, al0, ll0, tokens, beta_in, chk, ll_out, beta0, da_part, db_part, W, T, M, s);
  }
}

const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
