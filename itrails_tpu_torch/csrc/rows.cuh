// The row kernels of K1 (csrc/fwd.cu) and K5 (csrc/operators.cu), written
// for Hopper (sm_90a): independent forward rows, each with its own exact
// power-of-two scale.  Included by fwd.cu and operators.cu; it takes its
// helpers (kPad, kTokens, kFull, load4, load_emission, dispatch_s,
// allow_smem) from forward.cuh.
//
// A row x of M states takes, for every column t it reads,
//
//   x    <- (x @ a) * e(tok_t)          (e(tok) = bfull[:, tok])
//   k     = ilogb(max_j x_j), floored at ilogb(FLT_MIN) or ilogb(DBL_MIN)
//   x    <- x * 2^-k,   ksum += k
//
// where a PAD token (-1) leaves x and ksum alone and a token outside the
// alphabet zeroes the row.  Outputs: the rows X in the tables' scalar and
// the exponent sums int32.  A power-of-two scale is exact, so the only
// rounding is the product's, and no column takes a log or a division.
// A row's exponent moves by at most 1,022 a column (a row that has gone to
// zero floors at -1,022 every column, and its value is -inf whatever its
// sum), so an int32 sum holds 2^21 columns of a zeroed row and far more of
// a live one (|k| < 30 a column on the port's models).
//
// Rows differ only in where they start and which tokens they read, one
// compile-time policy (Start):
//   kUnit  (K5)  row r is row r mod M of chunk r / M's operator: it starts
//                from the unit vector e_{r mod M} and reads the L columns
//                of token row r / M of a (C, L) matrix;
//   kGiven (K1)  row r is window r: it starts from x0[r] and reads columns
//                1..L of token row r of a (W, L + 1) matrix (column 0 is
//                the wrapper's).
// The kernels that K5 and K1 launch are thin __global__ wrappers around
// the bodies below (k5_rows_* in operators.cu, k1_rows_* in fwd.cu), so
// each library's SASS names its own kernels.
//
// Layout: every row is independent, so a warp owns a tile of rows (rows of
// different chunks or windows may share it; each reads its own tokens,
// fetched two columns ahead), and the grid covers the tiles in as few
// waves over the card's SMs as the warps a block allow (block_warps).  A
// block's warps share a read-only copy of a in shared memory, loaded
// before the kernel's only __syncthreads; in the column loop a warp waits
// only for its own lanes (__syncwarp, shuffles).  A row's max is a
// reduction over the lanes that hold it; its exponent is read from the
// bits of the max, and 2^-k is built from bits too.  A column where every
// row of a tile is PAD is skipped by the whole warp.
//
// * f32, on the FMA pipes (rows_f32): a warp owns 4 rows (M <= 64) or 8,
//   lane l the columns l, l + 32, ... (S = ceil(M / 32) of them); the rows
//   live in the warp's slice of shared memory and are read back, four
//   entries at a time, as broadcasts, so each load of a (registers at
//   M <= 32, else shared memory, stride 32S) serves every row of the tile.
//   Each output sums its M terms eight at a time into the running sum, so
//   its rounding is that of M / 8 additions (one long chain of M FMAs
//   missed K5's atol 5e-5 at M = 133, 6.9e-5).  The row maxima take one
//   transposed butterfly (rows_max: 6 or 9 shuffles, not 5 a row).  At
//   M <= 64 the next column's emission rows are loaded during this one.
//   f32 does not use TF32 tensor cores: they keep ~3 digits.
// * f64, on the FP64 tensor cores (rows_f64): the product is a tall-skinny
//   GEMM, (rows, M) @ (M, M), a tile of 16 (or 8) rows at a time, with
//   mma.sync m16n8k4 f64 on 16-row tiles and m8n8k4 on 8-row ones
//   (m16n8k4 timed fastest of the sm_90 shapes that ptxas 12.9 takes for
//   16 rows, PERF.md §6).  M is padded to MP = 8 NT.  Thread (g, t) of a
//   warp (lane 4g + t) holds the accumulator entries (g, 8n + 2t + h) and
//   (g + 8, 8n + 2t + h), h = 0, 1, of every 8-column tile n.  The k steps
//   are ordered so that k step (j, h) takes, in lane (g, t), the state
//   8j + 2t + h: then the A fragments of the next column are the very
//   registers the accumulator of tile j left in the same thread, and no
//   fragment crosses lanes.  a is stored in that order once
//   (cuda_fwd.dmma_fragments in the wrappers): the double2 of lane (g, t)
//   at (j, n) holds a[8j + 2t + h][8n + g], h = 0, 1, one conflict-free
//   16-byte load a lane for two k steps.  The rows of the last column (X)
//   are kept in registers or, where X and the accumulators together would
//   pass the 255 registers a thread may hold, in a lane-private slice of
//   shared memory (X staged; no other lane reads it).  Where the registers
//   allow (F64Layout::EP) the next column's emission pairs are loaded
//   during this one.
//
//   16-row tiles (RH = 2):
//   M (MP)             X       a (shared)    X a warp   warps
//   <= 64 (<= 64)      regs    <= 32 KB      -          <= 8
//   65-136 (72-136)    staged  41-148 KB     9-17 KB    4-8
//   8-row tiles (RH = 1):
//   <= 160 (<= 160)    regs    <= 200 KB     -          <= 8
//   161-224 (168-224)  staged  - (from L2)   10-14 KB   8
//
//   Above M = 160 a's fragments (up to 401 KB at M = 224) do not fit in
//   shared memory: each warp reads them one k slice at a time from the
//   L2-resident copy, correct and slower.  K5 takes 16-row tiles up to
//   M = 136 and 8-row ones above; K1 takes 8-row tiles at every M (fwd.cu).
//
// Launch contract of the wrappers' C entry points: they enqueue on the
// given stream, do not synchronize, allocate nothing, and return
// cudaGetLastError().

#pragma once

#include <cfloat>

#include "forward.cuh"

namespace {

constexpr int kSmemBlock = 232448;  // shared memory a block may use (227 KB)
// Rows of a warp's tile in f32 and warps of an f32 block at most, at S
// states a lane: short tiles where the card holds every tile at once (M <=
// 64, latency-bound), 8 rows where a's loads serve more rows and the
// tiles fill the SMs in whole waves (K5 at M = 133: 50.4 ms against 54.7
// with 4 rows, PERF.md §6).
template <int S>
__host__ __device__ constexpr int f32_rows() {
  return S <= 2 ? 4 : 8;
}
template <int S>
__host__ __device__ constexpr int f32_warps() {
  return S <= 2 ? 16 : 8;
}
constexpr int kWarpsF64 = 8;        // warps of an f64 block at most (255 registers)
constexpr int kMaxNT = 28;          // 8-column tiles of M <= 224

// Where a row starts and which tokens it reads (see the note above).
enum class Start { kUnit, kGiven };

template <Start St>
__device__ __forceinline__ const int* token_row(const int* tokens, int r, int L,
                                                int M) {
  if constexpr (St == Start::kUnit) {
    return tokens + static_cast<size_t>(r / M) * L;
  } else {
    return tokens + static_cast<size_t>(r) * (L + 1) + 1;
  }
}

// ---------------------------------------------------------------- scales
// The exponent k of a row's max mx (ilogb, floored at that of the smallest
// normal, capped so that 2^-k is normal) and 2^-k, both from the bits.
__device__ __forceinline__ int row_exponent(float mx) {
  const int e = (__float_as_int(mx) >> 23) & 0xff;
  return min(max(e, 1), 253) - 127;
}
__device__ __forceinline__ int row_exponent(double mx) {
  const int e = static_cast<int>((__double_as_longlong(mx) >> 52) & 0x7ff);
  return min(max(e, 1), 2045) - 1023;
}
__device__ __forceinline__ float pow2_neg(float, int k) {
  return __int_as_float((127 - k) << 23);
}
__device__ __forceinline__ double pow2_neg(double, int k) {
  return __longlong_as_double(static_cast<long long>(1023 - k) << 52);
}

// ------------------------------------------------------------------ f32
// The max over the warp of R rows' values v[q] (R = 2^n <= 32), as a
// transposed butterfly: each of the first n steps halves the rows a lane
// carries, so it takes 5 dependent steps and R - 1 + 5 - n shuffles in all,
// not 5 R.  On return lane l holds the max of one row, which
// rows_max_lane(q) names for row q.
template <int R>
__device__ __forceinline__ float rows_max(const float (&v)[R], int lane) {
  float cur[R];
#pragma unroll
  for (int q = 0; q < R; ++q) cur[q] = v[q];
  int off = 16;
#pragma unroll
  for (int n = R; n > 1; n /= 2, off /= 2) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? cur[i] : cur[n / 2 + i];
      cur[i] = fmaxf(up ? cur[n / 2 + i] : cur[i], __shfl_xor_sync(kFull, send, off));
    }
  }
#pragma unroll
  for (; off > 0; off /= 2) cur[0] = fmaxf(cur[0], __shfl_xor_sync(kFull, cur[0], off));
  return cur[0];
}

template <int R>
__device__ __forceinline__ int rows_max_lane(int q) {
  int lane = 0, off = 16;
#pragma unroll
  for (int n = R; n > 1; n /= 2, off /= 2)
    if (q & (n / 2)) lane += off;
  return lane;
}

// The f32 rows r0 .. r0 + R - 1 of warp (blockIdx, threadIdx / 32), over L
// columns; x0 is read only by kGiven.  Launched with f32_warps<S>() warps
// a block at most and (S > 1) a's (32S)^2 floats plus R 32S floats a warp
// of dynamic shared memory.
template <Start St, int S>
__device__ __forceinline__ void rows_f32(
    const float* __restrict__ a,     // (M, M)
    const float* __restrict__ bt,    // (625, 32S), zero pad
    const float* __restrict__ x0,    // (rows, M), kGiven
    const int* __restrict__ tokens,  // see Start
    float* __restrict__ x_out,       // (rows, M)
    int* __restrict__ k_out,         // (rows,)
    int rows, int L, int M) {
  constexpr int MP = 32 * S;
  constexpr int R = f32_rows<S>();
  extern __shared__ float4 smem4[];
  float* s_a = reinterpret_cast<float*>(smem4);  // (MP, MP) with S > 1
  float* xs = s_a + (S > 1 ? MP * MP : 0) + (threadIdx.x >> 5) * R * MP;
  const int lane = threadIdx.x & 31;
  float acol[S == 1 ? 32 : 1];  // S == 1: acol[i] = a[i][lane]
  if constexpr (S == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acol[i] = (i < M && lane < M) ? a[i * M + lane] : 0.f;
  } else {
    for (int idx = threadIdx.x; idx < MP * MP; idx += blockDim.x) {
      const int i = idx / MP, j = idx - (idx / MP) * MP;
      s_a[idx] = (i < M && j < M) ? a[i * M + j] : 0.f;
    }
  }
  __syncthreads();
  const int r0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * R;
  if (r0 >= rows) return;  // after the kernel's only block-wide barrier

  // lane q < R carries row r0 + q: its token stream, its tokens of this
  // column and the next, and its exponent sum
  const int rq = r0 + (lane < R ? lane : 0);
  const bool own = lane < R && rq < rows;
  const bool first = St == Start::kUnit || L > 0;  // K5 takes L >= 1
  const int* trow = token_row<St>(tokens, rq, L, M);
  int tok = own && first ? __ldg(trow) : kPad;
  int tok_n = own && L > 1 ? __ldg(trow + 1) : kPad;
  int ksum = 0;
#pragma unroll
  for (int q = 0; q < R; ++q) {  // x = the rows' start
    if constexpr (St == Start::kUnit) {
      const int i = (r0 + q) % M;
#pragma unroll
      for (int s = 0; s < S; ++s) xs[q * MP + lane + 32 * s] = lane + 32 * s == i ? 1.f : 0.f;
    } else {
      const int r = r0 + q;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = lane + 32 * s;
        xs[q * MP + j] = r < rows && j < M ? x0[static_cast<size_t>(r) * M + j] : 0.f;
      }
    }
  }
  // EP: this column's emission rows are loaded during the last column
  constexpr bool EP = S <= 2;
  float e[EP ? R : 1][S];
  if constexpr (EP) {
#pragma unroll
    for (int q = 0; q < R; ++q) load_emission<S>(e[q], bt, __shfl_sync(kFull, tok, q), lane);
  }
  __syncwarp();
  const int m8 = (M + 7) & ~7;

  for (int t = 0; t < L; ++t) {
    const int tok_nn = own && t + 2 < L ? __ldg(trow + t + 2) : kPad;
    const unsigned live = __ballot_sync(kFull, tok != kPad);  // bit q: row q
    if (live != 0) {  // uniform across the warp
      // y[q][s] = (row q @ a)_{lane + 32 s}, summed eight terms at a time
      // into y, which keeps an f32 sum's rounding that of M / 8 additions
      float y[R][S];
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int s = 0; s < S; ++s) y[q][s] = 0.f;
      if constexpr (S == 1) {
#pragma unroll
        for (int k = 0; k < 32; k += 8) {
          if (k < m8) {
#pragma unroll
            for (int q = 0; q < R; ++q) {
              const auto u = load4(xs + q * MP + k);
              const auto v = load4(xs + q * MP + k + 4);
              float p = acol[k] * u.x;
              p = fmaf(acol[k + 1], u.y, p);
              p = fmaf(acol[k + 2], u.z, p);
              p = fmaf(acol[k + 3], u.w, p);
              p = fmaf(acol[k + 4], v.x, p);
              p = fmaf(acol[k + 5], v.y, p);
              p = fmaf(acol[k + 6], v.z, p);
              p = fmaf(acol[k + 7], v.w, p);
              y[q][0] += p;
            }
          }
        }
      } else {
        for (int k = 0; k < m8; k += 8) {
          float av[8][S];
#pragma unroll
          for (int d = 0; d < 8; ++d)
#pragma unroll
            for (int s = 0; s < S; ++s) av[d][s] = s_a[(k + d) * MP + lane + 32 * s];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const auto u = load4(xs + q * MP + k);
            const auto v = load4(xs + q * MP + k + 4);
#pragma unroll
            for (int s = 0; s < S; ++s) {
              float p = av[0][s] * u.x;
              p = fmaf(av[1][s], u.y, p);
              p = fmaf(av[2][s], u.z, p);
              p = fmaf(av[3][s], u.w, p);
              p = fmaf(av[4][s], v.x, p);
              p = fmaf(av[5][s], v.y, p);
              p = fmaf(av[6][s], v.z, p);
              p = fmaf(av[7][s], v.w, p);
              y[q][s] += p;
            }
          }
        }
      }
      float mx[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {  // the emission, each row its own token's
        float eq[S];
        if constexpr (EP) {
#pragma unroll
          for (int s = 0; s < S; ++s) eq[s] = e[q][s];
        } else {
          load_emission<S>(eq, bt, __shfl_sync(kFull, tok, q), lane);
        }
        mx[q] = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          y[q][s] *= eq[s];
          mx[q] = fmaxf(mx[q], y[q][s]);
        }
      }
      const int kr = row_exponent(rows_max<R>(mx, lane));  // of one row
      const int kq = __shfl_sync(kFull, kr, rows_max_lane<R>(lane & (R - 1)));
      if (lane < R && ((live >> lane) & 1u)) ksum += kq;
      __syncwarp();  // every lane has read the old rows
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float sc = pow2_neg(0.f, __shfl_sync(kFull, kr, rows_max_lane<R>(q)));
        if ((live >> q) & 1u) {
#pragma unroll
          for (int s = 0; s < S; ++s) xs[q * MP + lane + 32 * s] = y[q][s] * sc;
        }
      }
      __syncwarp();  // the next column's product reads whole rows
    }
    if constexpr (EP) {  // the next column's emission rows, in flight during it
#pragma unroll
      for (int q = 0; q < R; ++q)
        load_emission<S>(e[q], bt, __shfl_sync(kFull, tok_n, q), lane);
    }
    tok = tok_n;
    tok_n = tok_nn;
  }

#pragma unroll
  for (int q = 0; q < R; ++q) {  // a lane's own columns: no wait needed
    const int r = r0 + q;
    if (r >= rows) break;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = lane + 32 * s;
      if (j < M) x_out[static_cast<size_t>(r) * M + j] = xs[q * MP + j];
    }
  }
  if (own) k_out[rq] = ksum;
}

// ------------------------------------------------------------------ f64
// One mma.sync of the FP64 tensor cores: D = A B + D, D in place.
__device__ __forceinline__ void dmma884(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

__device__ __forceinline__ void dmma1684(double (&c)[2][2], double a0, double a1,
                                         double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0][0]), "+d"(c[0][1]), "+d"(c[1][0]), "+d"(c[1][1])
      : "d"(a0), "d"(a1), "d"(b));
}

// c[rh][i] += sum over the two k steps (j, h) of x[rh][h] b.h, for the
// RH 8-row halves of a tile: (g + 8 rh, 8n + 2t + i) += x(g + 8 rh,
// 8j + 2t' + h) a(8j + 2t' + h, 8n + 2t + i) summed over t' and h.
template <int RH>
__device__ __forceinline__ void dmma_step(double (&c)[RH][2],
                                          const double (&x)[RH][2], double2 b) {
  if constexpr (RH == 1) {
    dmma884(c[0], x[0][0], b.x);
    dmma884(c[0], x[0][1], b.y);
  } else {
    dmma1684(c, x[0][0], x[1][0], b.x);
    dmma1684(c, x[0][1], x[1][1], b.y);
  }
}

// The emission pairs of row half rh for token tok: e[n][rh] holds
// bt[tok][8n + 2 t4 + h], h = 0, 1 (0 for a PAD or a token outside the
// alphabet: such a pair is never used, or zeroes the row).
template <int NT, int RH>
__device__ __forceinline__ void emission_pairs(double2 (&e)[NT][RH], int rh,
                                               const double* __restrict__ bt,
                                               int tok, int width, int t4) {
  const bool ok = static_cast<unsigned>(tok) < static_cast<unsigned>(kTokens);
  const double2* row = reinterpret_cast<const double2*>(
      bt + static_cast<size_t>(ok ? tok : 0) * width + 2 * t4);
#pragma unroll
  for (int n = 0; n < NT; ++n) e[n][rh] = ok ? __ldg(row + 4 * n) : make_double2(0.0, 0.0);
}

// The layout of the f64 rows at NT 8-column tiles and RH 8-row halves a
// warp (RH = 2 needs NT <= 17; see the table above).
template <int NT, int RH>
struct F64Layout {
  static constexpr bool XS = RH == 2 ? NT > 8 : NT > 20;    // X staged
  static constexpr bool GB = NT > 20;                       // a's fragments from L2
  // this column's emission pairs loaded during the last one: 16-row tiles
  // with X in registers, and 8-row tiles at M <= 96 (above, beside X and
  // the accumulators, they would spill)
  static constexpr bool EP = !XS && (RH == 2 || NT <= 12);
  static constexpr size_t kFixed = GB ? 0 : sizeof(double2) * NT * NT * 32;
  static constexpr size_t kWarp = XS ? sizeof(double2) * NT * RH * 32 : 0;
};

// The f64 rows r0 .. r0 + 8 RH - 1 of warp (blockIdx, threadIdx / 32), over
// L columns; x0 is read only by kGiven.  Launched with kWarpsF64 warps a
// block at most and F64Layout's shared memory.
template <Start St, int NT, int RH, bool XS, bool GB, bool EP>
__device__ __forceinline__ void rows_f64(
    const double2* __restrict__ afr,  // (NT, NT, 32) a's fragments
    const double* __restrict__ bt,    // (625, width), zero pad
    const double* __restrict__ x0,    // (rows, M), kGiven
    const int* __restrict__ tokens,   // see Start
    double* __restrict__ x_out,       // (rows, M)
    int* __restrict__ k_out,          // (rows,)
    int rows, int L, int M, int width) {
  static_assert(!EP || !XS, "emission pairs ahead only with X in registers");
  constexpr int RW = 8 * RH;
  extern __shared__ double2 smem2[];
  double2* xs = smem2 + (GB ? 0 : NT * NT * 32) + (threadIdx.x >> 5) * (NT * RH * 32);
  if constexpr (!GB) {
    for (int idx = threadIdx.x; idx < NT * NT * 32; idx += blockDim.x) smem2[idx] = afr[idx];
  }
  __syncthreads();
  const double2* fr = GB ? afr : smem2;
  const int r0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * RW;
  if (r0 >= rows) return;  // after the kernel's only block-wide barrier
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;

  int r[RH], tok[RH], tok_n[RH], ksum[RH];
  bool own[RH];
  const int* trow[RH];
  double x[XS ? 1 : NT][RH][2];  // x[j][rh][h] = X(g + 8 rh, 8j + 2 t4 + h)
#pragma unroll
  for (int rh = 0; rh < RH; ++rh) {
    r[rh] = r0 + g + 8 * rh;
    own[rh] = r[rh] < rows;
    const bool first = St == Start::kUnit || L > 0;  // K5 takes L >= 1
    trow[rh] = token_row<St>(tokens, own[rh] ? r[rh] : r0, L, M);
    tok[rh] = own[rh] && first ? __ldg(trow[rh]) : kPad;
    tok_n[rh] = own[rh] && L > 1 ? __ldg(trow[rh] + 1) : kPad;
    ksum[rh] = 0;
    const int i = r[rh] % M;
#pragma unroll
    for (int j = 0; j < NT; ++j) {  // x = the rows' start
      double v0, v1;
      if constexpr (St == Start::kUnit) {
        v0 = 8 * j + 2 * t4 == i ? 1.0 : 0.0;
        v1 = 8 * j + 2 * t4 + 1 == i ? 1.0 : 0.0;
      } else {
        const int col = 8 * j + 2 * t4;
        const double* row = x0 + static_cast<size_t>(r[rh]) * M;
        v0 = own[rh] && col < M ? row[col] : 0.0;
        v1 = own[rh] && col + 1 < M ? row[col + 1] : 0.0;
      }
      if constexpr (XS) {
        xs[(j * RH + rh) * 32 + lane] = make_double2(v0, v1);
      } else {
        x[j][rh][0] = v0;
        x[j][rh][1] = v1;
      }
    }
  }

  // EP: this column's emission pairs e[n][rh] = (e(g + 8 rh)_{8n + 2 t4},
  // e(...)_{8n + 2 t4 + 1}) are loaded during the last column.  Elsewhere
  // they are loaded after the product.
  double2 e[EP ? NT : 1][RH];
  if constexpr (EP) {
#pragma unroll
    for (int rh = 0; rh < RH; ++rh) emission_pairs<NT>(e, rh, bt, tok[rh], width, t4);
  }

  for (int t = 0; t < L; ++t) {
    int tok_nn[RH];
    bool live[RH], any = false;
#pragma unroll
    for (int rh = 0; rh < RH; ++rh) {
      tok_nn[rh] = own[rh] && t + 2 < L ? __ldg(trow[rh] + t + 2) : kPad;
      live[rh] = tok[rh] != kPad;
      any = any || live[rh];
    }
    if (__any_sync(kFull, any)) {  // uniform across the warp
      double c[NT][RH][2];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int rh = 0; rh < RH; ++rh) c[n][rh][0] = c[n][rh][1] = 0.0;
      if constexpr (XS) {
#pragma unroll 1
        for (int j = 0; j < NT; ++j) {
          double xa[RH][2];
#pragma unroll
          for (int rh = 0; rh < RH; ++rh) {
            const double2 v = xs[(j * RH + rh) * 32 + lane];
            xa[rh][0] = v.x;
            xa[rh][1] = v.y;
          }
          const double2* f = fr + j * NT * 32 + lane;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if constexpr (GB) {
              dmma_step<RH>(c[n], xa, __ldg(f + n * 32));
            } else {
              dmma_step<RH>(c[n], xa, f[n * 32]);
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const double2* f = fr + j * NT * 32 + lane;
#pragma unroll
          for (int n = 0; n < NT; ++n) dmma_step<RH>(c[n], x[j], f[n * 32]);
        }
      }
      if constexpr (!EP) {
#pragma unroll
        for (int rh = 0; rh < RH; ++rh) {
          const bool ok = static_cast<unsigned>(tok[rh]) < static_cast<unsigned>(kTokens);
          const double* erow = bt + static_cast<size_t>(ok ? tok[rh] : 0) * width + 2 * t4;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const double2 en = ok ? __ldg(reinterpret_cast<const double2*>(erow + 8 * n))
                                  : make_double2(0.0, 0.0);
            c[n][rh][0] *= en.x;
            c[n][rh][1] *= en.y;
          }
        }
      }
#pragma unroll
      for (int rh = 0; rh < RH; ++rh) {  // the emission, the row max, the scale
        double mx = 0.0;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if constexpr (EP) {
            c[n][rh][0] *= e[n][rh].x;
            c[n][rh][1] *= e[n][rh].y;
          }
          mx = fmax(mx, fmax(c[n][rh][0], c[n][rh][1]));
        }
        mx = fmax(mx, __shfl_xor_sync(kFull, mx, 1));  // the quad holds the row
        mx = fmax(mx, __shfl_xor_sync(kFull, mx, 2));
        const int k = row_exponent(mx);
        const double sc = pow2_neg(0.0, k);
        if (live[rh]) {
          ksum[rh] += k;
#pragma unroll
          for (int n = 0; n < NT; ++n) {  // tile n becomes k steps (n, 0..1)
            if constexpr (XS) {
              xs[(n * RH + rh) * 32 + lane] =
                  make_double2(c[n][rh][0] * sc, c[n][rh][1] * sc);
            } else {
              x[n][rh][0] = c[n][rh][0] * sc;
              x[n][rh][1] = c[n][rh][1] * sc;
            }
          }
        }
      }
    }
#pragma unroll
    for (int rh = 0; rh < RH; ++rh) {
      if constexpr (EP) emission_pairs<NT>(e, rh, bt, tok_n[rh], width, t4);
      tok[rh] = tok_n[rh];
      tok_n[rh] = tok_nn[rh];
    }
  }

#pragma unroll
  for (int rh = 0; rh < RH; ++rh) {
    if (!own[rh]) continue;
    double* out = x_out + static_cast<size_t>(r[rh]) * M;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      double v0, v1;
      if constexpr (XS) {
        const double2 v = xs[(j * RH + rh) * 32 + lane];
        v0 = v.x;
        v1 = v.y;
      } else {
        v0 = x[j][rh][0];
        v1 = x[j][rh][1];
      }
      const int col = 8 * j + 2 * t4;
      if (col < M) out[col] = v0;
      if (col + 1 < M) out[col + 1] = v1;
    }
    if (t4 == 0) k_out[r[rh]] = ksum[rh];
  }
}

// -------------------------------------------------------------- launches
// The SMs of the current card (1 if it cannot be asked).
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1)
    sms = 1;
  return sms;
}

// Warps of a block: the fewest waves over the card's SMs at one block an SM
// for `tiles` warp tiles, then the blocks spread evenly over those waves.
int block_warps(int tiles, int max_warps) {
  const int sms = sm_count();
  const int waves = (tiles + sms * max_warps - 1) / (sms * max_warps);
  const int w = (tiles + sms * waves - 1) / (sms * waves);
  return w < 1 ? 1 : (w > max_warps ? max_warps : w);
}

// One instantiation of a row kernel: its kernel, the rows a warp owns, the
// shared memory of the block (fixed) and of each warp, and the warps a
// block at most.
template <typename Kernel>
struct Rows {
  Kernel kernel;
  int rows_per_warp;
  size_t fixed, per_warp;
  int max_warps;
};

template <typename Kernel>
Rows<Kernel> rows_config(Kernel kernel, int rows_per_warp, size_t fixed,
                         size_t per_warp, int cap) {
  int w = cap;
  if (per_warp > 0) {
    const size_t fit = (kSmemBlock - fixed) / per_warp;
    w = fit < static_cast<size_t>(cap) ? static_cast<int>(fit) : cap;
  }
  return {kernel, rows_per_warp, fixed, per_warp, w};
}

// Launches cfg's kernel over `rows` rows with args...: the tiles spread by
// block_warps, the shared memory of the warps a block.
template <typename Kernel, typename... Args>
int launch_rows(const Rows<Kernel>& cfg, int rows, cudaStream_t stream,
                Args... args) {
  if (cfg.max_warps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (rows + cfg.rows_per_warp - 1) / cfg.rows_per_warp;
  const int w = block_warps(tiles, cfg.max_warps);
  const size_t smem = cfg.fixed + w * cfg.per_warp;
  const cudaError_t err = allow_smem(cfg.kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tiles + w - 1) / w);
  cfg.kernel<<<grid, 32 * w, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
