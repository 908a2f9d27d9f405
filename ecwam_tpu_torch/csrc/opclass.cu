// Op-class micro-benchmark — kernel D of the port.
//
// Replaces scripts/mosaic_opclass.py:make (:44) and make2 (:63), the
// Pallas TPU kernels that apply one op class K times to each (36, 40, 128)
// tile of a (36, 40, lanes) float32 array (the two differ only in how the
// output is sliced, so one entry covers both).  The plain PyTorch
// reference is ecwam_tpu_torch/tools/opclass.py:opclass_plain, the wrapper
// tools/opclass.py:opclass.  Every class acts within one (36, 40) column
// of the array (one lane of the TPU tile):
//   fma          x·1.0000001 + 1e-9
//   sub_shift    x[k, m] ← x[k, (m + 1) mod 40]
//   sub_shift4   x[k, m] ← x[k, (m + 4) mod 40]
//   lead_roll    x[k, m] ← x[(k + 1) mod 36, m]
//   transpose2x  x ← (xᵀ·1.0000001)ᵀ, both transposes materialised
//   lead_reduce  x ← x + 1e-12·Σ_k x[k, m]
//   sub_reduce   x ← x + 1e-12·Σ_m x[k, m]
//   lane_bcast   x ← x·(1e-6·m + 0.9999)
//   exp          x ← exp(1e-6·x)
//
// What bounds it, and the design (the first design kept 16 columns in
// shared memory twice over, one 512-thread block an SM, and moved every
// entry through shared memory in each application; its six layout and
// reduction classes ran at 34–50 % of that traffic's bound):
//  * the elementwise classes (fma, lane_bcast, exp) need no neighbour: each
//    thread keeps four elements in registers for all K applications, so
//    the array is read and written once, and the FP32 pipes (fma,
//    lane_bcast) or the special-function units (exp) are the limit;
//  * the shifts, the roll and the reductions act along one axis of a
//    column, so each thread holds one line of one column along that axis
//    in registers for all K applications (sub_shift, sub_shift4 and
//    sub_reduce a k-row of 40 entries, lead_roll and lead_reduce an m-line
//    of 36), 32 neighbouring columns across a warp's lanes, so that each
//    load and store of the array is one 128-byte line a warp.  A shift is
//    then a rotation of the thread's registers (each application moves
//    every register: the K loop is not unrolled, so no rotation folds into
//    the next), a reduction a register sum with four partial sums and the
//    add; no data crosses lanes and no shared memory is used.  The array's
//    one read and one write (HBM) or, for the reductions, the FP32 pipes
//    bound them;
//  * transpose2x really moves data across threads: each application
//    materialises xᵀ and then (xᵀ)ᵀ.  A block of 8 columns × 40 threads
//    holds the column's k-rows in registers (threads r < 36); the first
//    transpose stores them into shared memory and threads r < 40 gather
//    the m-lines (xᵀ's rows), scale them, store them back, and threads
//    r < 36 gather their k-rows again — two shared-memory round trips per
//    entry and application, the least a transpose through on-chip memory
//    can take, and its limit.  Rows of the shared tile lie 8 banks apart
//    (a k stride of 328 floats), so neither the k-row nor the m-line
//    accesses of a warp (4 lines × 8 columns) conflict.

#include <cuda_runtime.h>

namespace {

constexpr int NANG = 36, MF = 40, NE = NANG * MF;   // one column: 1440
constexpr int EW_THREADS = 256, EW_PER = 4;         // elementwise blocks
constexpr int LC = 32;                              // columns a line block
constexpr int LPB = 4;                              // lines a line block
constexpr int TC = 8;                               // columns a tile block
constexpr int TR = MF;                              // threads a column
constexpr int KS = MF * TC + 8;                     // tile's k stride

enum Cls { FMA, SUB_SHIFT, SUB_SHIFT4, LEAD_ROLL, TRANSPOSE2X, LEAD_REDUCE,
           SUB_REDUCE, LANE_BCAST, EXP, NCLS };

// the elementwise classes: EW_PER elements a thread, in registers
template <int CLS>
__global__ void __launch_bounds__(EW_THREADS)
elementwise(const float* __restrict__ in, float* __restrict__ out, long n,
            long lanes, int K) {
  const long base = (long)blockIdx.x * EW_THREADS * EW_PER + threadIdx.x;
  float x[EW_PER], w[EW_PER];
#pragma unroll
  for (int u = 0; u < EW_PER; ++u) {
    const long e = base + (long)u * EW_THREADS;
    x[u] = e < n ? in[e] : 0.f;
    // the multiplier of lane_bcast, rounded as the plain version rounds it
    const int m = (int)((e / lanes) % MF);
    w[u] = __fadd_rn(__fmul_rn((float)m, 1e-6f), 0.9999f);
  }
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int u = 0; u < EW_PER; ++u) {
      if (CLS == FMA) x[u] = x[u] * 1.0000001f + 1e-9f;
      if (CLS == LANE_BCAST) x[u] = x[u] * w[u];
      if (CLS == EXP) x[u] = expf(x[u] * 1e-6f);
    }
  }
#pragma unroll
  for (int u = 0; u < EW_PER; ++u) {
    const long e = base + (long)u * EW_THREADS;
    if (e < n) out[e] = x[u];
  }
}

// v[i] ← v[(i + S) mod N]: every register moves
template <int S, int N>
__device__ __forceinline__ void rotate(float (&v)[N]) {
  float t[S];
#pragma unroll
  for (int i = 0; i < S; ++i) t[i] = v[i];
#pragma unroll
  for (int i = 0; i < N - S; ++i) v[i] = v[i + S];
#pragma unroll
  for (int i = 0; i < S; ++i) v[N - S + i] = t[i];
}

// the shifts, the roll and the reductions: one line of one column a
// thread, in registers; a block is LC columns × LPB lines
template <int CLS>
__global__ void __launch_bounds__(LC * LPB)
lines(const float* __restrict__ in, float* __restrict__ out, long lanes,
      int K) {
  constexpr bool ALONG_M =
      CLS == SUB_SHIFT || CLS == SUB_SHIFT4 || CLS == SUB_REDUCE;
  constexpr int LEN = ALONG_M ? MF : NANG;          // the line's entries
  constexpr int STEP = ALONG_M ? 1 : MF;            // their entry stride
  const long col = (long)blockIdx.x * LC + (threadIdx.x % LC);
  const int line = blockIdx.y * LPB + threadIdx.x / LC;
  const long base = (long)(ALONG_M ? line * MF : line) * lanes + col;
  float v[LEN];
#pragma unroll
  for (int j = 0; j < LEN; ++j) v[j] = in[base + (long)j * STEP * lanes];
#pragma unroll 1
  for (int it = 0; it < K; ++it) {
    if constexpr (CLS == SUB_SHIFT || CLS == LEAD_ROLL) {
      rotate<1>(v);
    } else if constexpr (CLS == SUB_SHIFT4) {
      rotate<4>(v);
    } else {                                        // the reductions
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < LEN; ++j) a[j % 4] += v[j];
      const float t = ((a[0] + a[1]) + (a[2] + a[3])) * 1e-12f;
#pragma unroll
      for (int j = 0; j < LEN; ++j) v[j] = v[j] + t;
    }
  }
#pragma unroll
  for (int j = 0; j < LEN; ++j) out[base + (long)j * STEP * lanes] = v[j];
}

// transpose2x: TC columns a block, TR threads a column; entry (k, m) of
// column c at s[k·KS + m·TC + c].  One register array a thread holds its
// k-row (v[0..MF)) and, between the transposes, its m-line (v[0..NANG))
__global__ void __launch_bounds__(TC * TR, 3)
transpose2x(const float* __restrict__ in, float* __restrict__ out,
            long lanes, int K) {
  extern __shared__ float s[];
  const int c = threadIdx.x % TC, r = threadIdx.x / TC;
  const long col = (long)blockIdx.x * TC + c;
  const bool krow = r < NANG;                       // holds k-row r
  float v[MF];
  if (krow) {
#pragma unroll
    for (int m = 0; m < MF; ++m) v[m] = in[(long)(r * MF + m) * lanes + col];
  }
#pragma unroll 1
  for (int it = 0; it < K; ++it) {
    // xᵀ: the k-rows out, the m-lines (xᵀ's rows) in, scaled
    if (krow) {
#pragma unroll
      for (int m = 0; m < MF; ++m) s[r * KS + m * TC + c] = v[m];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NANG; ++k) v[k] = s[k * KS + r * TC + c] * 1.0000001f;
    __syncthreads();
    // (xᵀ)ᵀ: the m-lines out, the k-rows in
#pragma unroll
    for (int k = 0; k < NANG; ++k) s[k * KS + r * TC + c] = v[k];
    __syncthreads();
    if (krow) {
#pragma unroll
      for (int m = 0; m < MF; ++m) v[m] = s[r * KS + m * TC + c];
    }
    __syncthreads();
  }
  if (krow) {
#pragma unroll
    for (int m = 0; m < MF; ++m) out[(long)(r * MF + m) * lanes + col] = v[m];
  }
}

template <int CLS>
int launch(const float* in, float* out, long lanes, int K,
           cudaStream_t stream) {
  if constexpr (CLS == FMA || CLS == LANE_BCAST || CLS == EXP) {
    const long n = (long)NE * lanes;
    const long per = (long)EW_THREADS * EW_PER;
    elementwise<CLS><<<(unsigned)((n + per - 1) / per), EW_THREADS, 0,
                       stream>>>(in, out, n, lanes, K);
    return (int)cudaGetLastError();
  } else if constexpr (CLS == TRANSPOSE2X) {
    const size_t smem = (size_t)NANG * KS * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        transpose2x, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    transpose2x<<<(unsigned)(lanes / TC), TC * TR, smem, stream>>>(
        in, out, lanes, K);
    return (int)cudaGetLastError();
  } else {
    constexpr bool ALONG_M =
        CLS == SUB_SHIFT || CLS == SUB_SHIFT4 || CLS == SUB_REDUCE;
    const dim3 grid((unsigned)(lanes / LC), (ALONG_M ? NANG : MF) / LPB);
    lines<CLS><<<grid, LC * LPB, 0, stream>>>(in, out, lanes, K);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// Host entry, bound from Python with ctypes: K applications of class
// ``cls`` (the order of Cls above, tools/opclass.py:CLASSES) to the
// (36, 40, lanes) float32 array ``in``, written to ``out`` (another
// array; ``lanes`` a multiple of 32).  Returns the CUDA error code of the
// launch (0 = launched).
extern "C" int opclass_launch(int cls, const float* in, float* out,
                              long lanes, int K, void* stream) {
  if (lanes <= 0 || lanes % LC || K < 0 || in == out)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (cls) {
    case FMA: return launch<FMA>(in, out, lanes, K, s);
    case SUB_SHIFT: return launch<SUB_SHIFT>(in, out, lanes, K, s);
    case SUB_SHIFT4: return launch<SUB_SHIFT4>(in, out, lanes, K, s);
    case LEAD_ROLL: return launch<LEAD_ROLL>(in, out, lanes, K, s);
    case TRANSPOSE2X: return launch<TRANSPOSE2X>(in, out, lanes, K, s);
    case LEAD_REDUCE: return launch<LEAD_REDUCE>(in, out, lanes, K, s);
    case SUB_REDUCE: return launch<SUB_REDUCE>(in, out, lanes, K, s);
    case LANE_BCAST: return launch<LANE_BCAST>(in, out, lanes, K, s);
    case EXP: return launch<EXP>(in, out, lanes, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
