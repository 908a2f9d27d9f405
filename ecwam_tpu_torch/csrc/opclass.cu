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
// What bounds it, and the design:
//  * the elementwise classes (fma, lane_bcast, exp) need no neighbour: each
//    thread keeps four elements in registers for all K applications, so
//    the array is read and written once, and the FP32 pipes (fma,
//    lane_bcast) or the special-function units (exp) are the limit;
//  * the layout classes and the reductions keep a group of 16 columns in
//    shared memory twice over (two 16·1440-float buffers, 184 KB of the
//    227 KB a block may have, one block of 512 threads an SM), loaded and
//    stored once, with the K applications done there from one buffer
//    into the other.  The column is the fastest index (shared address
//    (k·40 + m)·16 + column), and thread (row r, column c) owns entries
//    i = r + 32·j, j < 45, of column c; a warp's two rows have entries of
//    opposite parity, so its 32 accesses at one entry fall in 32 banks.
//    A shift, roll or transpose is an index map from one buffer into the
//    other (the transpose there and back, two maps), with no staging in
//    registers.  A reduction sums along the thread's own column (the
//    reduced axis lies in one column, not across lanes, so no shuffle is
//    needed and the reads stay free of bank conflicts) into a 40×16
//    scratch row, then each thread writes its entries plus that row into
//    the other buffer.  Shared-memory bandwidth is their limit.

#include <cuda_runtime.h>

namespace {

constexpr int NANG = 36, MF = 40, NE = NANG * MF;   // one column: 1440
constexpr int COLS = 16;                            // columns a block
constexpr int THREADS = 512;
constexpr int ROWS = THREADS / COLS;                // 32
constexpr int EPT = NE / ROWS;                      // entries a thread: 45
constexpr int EW_THREADS = 256, EW_PER = 4;         // elementwise blocks

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

// the source entry of entry i under the index maps (shifts and roll)
template <int CLS>
__device__ __forceinline__ int source(int i) {
  const int k = i / MF, m = i - k * MF;
  if (CLS == SUB_SHIFT) return k * MF + (m + 1 == MF ? 0 : m + 1);
  if (CLS == SUB_SHIFT4) return k * MF + (m + 4 >= MF ? m + 4 - MF : m + 4);
  return i + MF >= NE ? i + MF - NE : i + MF;        // LEAD_ROLL
}

// the layout classes and the reductions: 16 columns in shared memory, two
// buffers
template <int CLS>
__global__ void __launch_bounds__(THREADS, 1)
columns(const float* __restrict__ in, float* __restrict__ out, long lanes,
        int K) {
  extern __shared__ float smem[];
  float* a = smem;                                  // NE·COLS each
  float* b = smem + NE * COLS;
  float* red = smem + 2 * NE * COLS;                // MF·COLS
  const int c = threadIdx.x % COLS, r = threadIdx.x / COLS;
  const long col = (long)blockIdx.x * COLS + c;
#pragma unroll 5
  for (int j = 0; j < EPT; ++j) {
    const int i = r + ROWS * j;
    a[i * COLS + c] = in[(long)i * lanes + col];
  }
  __syncthreads();
  for (int it = 0; it < K; ++it) {
    if (CLS == SUB_SHIFT || CLS == SUB_SHIFT4 || CLS == LEAD_ROLL) {
#pragma unroll 5
      for (int j = 0; j < EPT; ++j) {
        const int i = r + ROWS * j;
        b[i * COLS + c] = a[source<CLS>(i) * COLS + c];
      }
    } else if (CLS == TRANSPOSE2X) {
      // there: entry (k, m) to (m, k) of the (40, 36) layout, scaled
#pragma unroll 5
      for (int j = 0; j < EPT; ++j) {
        const int i = r + ROWS * j, k = i / MF, m = i - k * MF;
        b[(m * NANG + k) * COLS + c] = a[i * COLS + c] * 1.0000001f;
      }
      __syncthreads();
      // and back: entry (m, k) of the (40, 36) layout to (k, m)
#pragma unroll 5
      for (int j = 0; j < EPT; ++j) {
        const int i = r + ROWS * j, m = i / NANG, k = i - m * NANG;
        a[(k * MF + m) * COLS + c] = b[i * COLS + c];
      }
    } else {
      // LEAD_REDUCE: Σ over k for each m; SUB_REDUCE: Σ over m for each k
      const int nred = CLS == LEAD_REDUCE ? MF : NANG;
      for (int q = r; q < nred; q += ROWS) {
        float acc = 0.f;
        if (CLS == LEAD_REDUCE) {
          for (int k = 0; k < NANG; ++k) acc += a[(k * MF + q) * COLS + c];
        } else {
          for (int m = 0; m < MF; ++m) acc += a[(q * MF + m) * COLS + c];
        }
        red[q * COLS + c] = acc;
      }
      __syncthreads();
#pragma unroll 5
      for (int j = 0; j < EPT; ++j) {
        const int i = r + ROWS * j, k = i / MF;
        const int q = CLS == LEAD_REDUCE ? i - k * MF : k;
        b[i * COLS + c] = a[i * COLS + c] + red[q * COLS + c] * 1e-12f;
      }
    }
    __syncthreads();
    if (CLS != TRANSPOSE2X) {                       // the result is in b
      float* t = a;
      a = b;
      b = t;
    }
  }
#pragma unroll 5
  for (int j = 0; j < EPT; ++j) {
    const int i = r + ROWS * j;
    out[(long)i * lanes + col] = a[i * COLS + c];
  }
}

template <int CLS>
int launch(const float* in, float* out, long lanes, int K,
           cudaStream_t stream) {
  if (CLS == FMA || CLS == LANE_BCAST || CLS == EXP) {
    const long n = (long)NE * lanes;
    const long per = (long)EW_THREADS * EW_PER;
    elementwise<CLS><<<(unsigned)((n + per - 1) / per), EW_THREADS, 0,
                       stream>>>(in, out, n, lanes, K);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)(2 * NE + MF) * COLS * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      columns<CLS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  columns<CLS><<<(unsigned)(lanes / COLS), THREADS, smem, stream>>>(
      in, out, lanes, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entry, bound from Python with ctypes: K applications of class
// ``cls`` (the order of Cls above, tools/opclass.py:CLASSES) to the
// (36, 40, lanes) float32 array ``in``, written to ``out`` (another
// array; ``lanes`` a multiple of 32).  Returns the CUDA error code of the
// launch (0 = launched).
extern "C" int opclass_launch(int cls, const float* in, float* out,
                              long lanes, int K, void* stream) {
  if (lanes <= 0 || lanes % COLS || K < 0 || in == out)
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
