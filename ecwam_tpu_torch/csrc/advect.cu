// Fused CTU advection pass over the SRL spectrum (irefra 0-3).
//
// Replaces ecwam_tpu/ops/propagation_pallas.py:advect_pallas (the Pallas
// TPU kernel).  The plain PyTorch reference is
// ecwam_tpu_torch/ops/propagation_fused.py:advect_xla + segment_advect,
// whose indexing this kernel follows; the wrapper is
// ecwam_tpu_torch/ops/propagation_cuda.py:advect.
//
// Per body row r of segment i (rows S+i·S .. S+i·S+S-1), lane l = k·nft+m:
//   out = valid·[(1−Σw)f + Σ w·obs·f_nb + w_km1 f(k−1) + w_kp1 f(k+1)
//                + w_mm1 f(m−1) + w_mp1 f(m+1)]
// with the lat/corner neighbours as FIR taps over the row-below window
// and the row-above window, W/E from the own row, and the CTU weights
// rebuilt from geom, cg (with its land fallback) and the lane constants
// (ctuw.F90:90-745, propags2.F90:49-130).  The taps are rebased per
// segment (ops/propagation_rebase.py): the window of side s starts at
// base_s[i] + lo_s[i] + il and the FIR runs the segment's nonzero extent
// ext_s[i] of columns.  Rows outside the body are written as zeros.
// Lanes with m >= nw (the frequencies above a fast-wave sub-band) are
// copied through unchanged; nf (>= nw) is the computed width, which sets
// the lane constants and the σ̇ shift's band-edge clamp.
//
// Current refraction (irefra 2/3, template flag CUR): the current splits
// each edge displacement into its upstream and downstream parts, so all
// four corners are live (the ctuwupdt.F90:95-150 quadrant map); the
// current gradients add to the turning rate θ̇; and σ̇ shifts energy
// between neighbouring frequencies of the row (ctuw.F90:430-470): phase 1
// keeps cg·k and ω/sinh·k per (row, m), and phase 2 forms σ̇(k, m±1) and
// reads f(k, m±1) of its own row, clamped at the band's edges.  With CFL
// (template flag), the pass also writes per row the CFL-violation flag
// (max Courant number over the lanes above 1 in either direction, or the
// outflow sum outside [0, 1]) and the three largest Courant numbers, for
// the current retry mask and CHECKCFL.  OBS (template flag) multiplies
// the neighbour terms by the obstruction factors; it is false when every
// factor is 1 (all-open water), and then no obstruction table is read.
//
// What bounds it: bytes — the spectrum read once and written once, plus
// the small per-row tables (chip_smoke.py: advect_bytes).  The design for
// the H100:
//  * Work items are tiles of RT rows of one segment; a CTA walks each
//    item's bands of KB = 4 directions.  Lanes are k-major, so a band is
//    contiguous in a row (16·nft bytes, 16-byte aligned when nang is a
//    multiple of 4).  Per band step, the own rows (RT+2, with the k−1
//    and k+1 halo directions, wrapping at 0 and nang−1), the dn and up
//    windows (RT+ext−1 rows of the band; without currents only the side
//    the band's directions read) and the band's lane constants are
//    staged in shared memory with cp.async; per item, once for all its
//    bands, the three cg windows, the per-row tables and the taps.  Both
//    are double-buffered: the next step's copies are in flight while this
//    one computes.  Phase 1 (the per-(row, frequency) edge velocities)
//    runs once per item.
//  * A persistent grid (the CTAs the SMs hold) walks the items in row
//    order, so neighbouring CTAs share their windows in L2.
//  * Each thread owns one lane (k, m) of the band for a band step: its
//    lane constants sit in registers and no output needs an integer
//    division.  A warp covers one row; per-row values and the tap
//    columns (one float4 [lat, corE, corW, 0] a column) are broadcast
//    reads of shared memory.  The FIR runs the segment's extent with no
//    branch on the tap values; without currents a lane reads only its
//    upstream side (the other side's weights are 0).
//  * The CFL maxima are warp reductions per row, then one shared-memory
//    combine per row and band; cfl_combine folds the bands.

#include <cuda_runtime.h>

namespace {

// lane-constant rows, in the order of propagation_cuda.LC_ROWS
enum Lc { LC_S, LC_CTH, LC_EAST, LC_NORTH, LC_DT, LC_SP, LC_SM, LC_SD_P,
          LC_CD_P, LC_SD_M, LC_CD_M, LC_SS_P, LC_SC_P, LC_CC_P, LC_SS_M,
          LC_SC_M, LC_CC_M, LC_NF_SC, LC_NF_CC, LC_NF_SS, LC_DFP, LC_DFM,
          NLC };
// per-row table in shared memory: geom, grads, then the small fields
// (each pair 8-byte aligned for its copy), and 1/(zdello·xdella); phase 2
// reads slots 0-7 and 16-23 as four float4
enum Row { R_Z, R_CI, R_TP, R_DPS, R_DPN, R_XD, R_GRADS = 8, R_SEAW = 16,
           R_SEAE, R_CGLDN, R_CGLUP, R_U, R_V, R_VALID, R_AREAM1, NROW = 24 };

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int KB = 4;           // directions per band
constexpr int MAX_BANDS = 128;  // nang ≤ 512 (each band's sides: 512 B)
// per-(row, freq) fields of phase 1: edge velocities (4), cg, ω/sinh·k,
// and with currents cg·k and ω/sinh·k·k
template <bool CUR>
__host__ __device__ constexpr int nfields() { return CUR ? 8 : 6; }
// lane-constant rows staged per band: all with currents, else up to the
// depth-refraction rows
template <bool CUR>
__host__ __device__ constexpr int nlc() { return CUR ? NLC : LC_CD_M + 1; }

struct Args {
  const float* f_in; float* f_out;
  const float* cg; const float* cg_land;
  const float* ktaps; const float* sea_own;
  const float* cgland; const float* geom; const float* valid;
  const float* obs; const float* pf; const float* grads; const float* uv;
  const int* dn_base; const int* up_base; const int* kseg; const float* lc;
  int* part;
  int nsrl, nang, nft, nf, nw, S, ew2, irefra, RT, nbands, nitems;
  float cmtodeg, fratio, rfratio;
};

// shared-memory layout (floats), the same on host and device: two band
// stages, two row stages, the phase-1 fields and the CFL slots
struct Layout {
  int bw, bl, hs, os, wr, own, dn, up, lcs, band, cgo, cgd, cgu, row, tap,
      rows, rstage, fs, red, total;
};
__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }
template <bool CUR, bool CFL>
__host__ __device__ inline Layout layout(int nft, int nf, int ew2, int RT) {
  Layout L;
  L.bw = up4(KB * nft);                  // band lanes of a row
  L.bl = up4(KB * nf);                   // band lanes of a lane constant
  L.hs = up4(nft + 6);                   // a halo direction's 16-byte span
  L.os = L.bw + 2 * L.hs;                // own row: band, halo k−1, k+1
  L.wr = RT + ew2 - 1;                   // window rows at most
  L.own = 0;
  L.dn = L.own + (RT + 2) * L.os;
  L.up = L.dn + L.wr * L.bw;
  L.lcs = L.up + L.wr * L.bw;
  L.band = L.lcs + nlc<CUR>() * L.bl;    // one band stage
  L.cgo = 0;                             // offsets in a row stage
  L.cgd = L.cgo + up4((RT + 2) * nft);
  L.cgu = L.cgd + up4(L.wr * nft);
  L.row = L.cgu + up4(L.wr * nft);
  L.tap = L.row + RT * NROW;
  L.rows = L.tap + RT * 2 * ew2 * 4;     // one row stage
  L.rstage = 2 * L.band;
  L.fs = L.rstage + 2 * L.rows;
  L.red = L.fs + nfields<CUR>() * RT * nf;
  L.total = L.red + (CFL ? RT * 4 * NWARPS : 0);
  return L;
}

// order-preserving int key of a float, for max reductions over floats
__device__ __forceinline__ int fkey(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float fval(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// the upstream / downstream split of one edge displacement: ad = |Δ| of
// the edge velocity plus the current term, up = ad where the current
// keeps the velocity's sign, dw = ad where it reverses it
__device__ __forceinline__ void updown(float cgx, float vadd, float dtc,
                                       float& ad, float& up, float& dw) {
  const float rel = cgx + vadd;
  const float sr = rel > 0.f ? 1.f : (rel < 0.f ? -1.f : 0.f);
  const float sc = cgx > 0.f ? 1.f : (cgx < 0.f ? -1.f : 0.f);
  ad = fabsf(dtc * rel);
  up = sr == sc ? ad : 0.f;
  dw = sr == sc ? 0.f : ad;
}

// a row tile's segment: its rebase [lo_dn, lo_up, ext_dn, ext_up] and
// the original window bases, loaded one item ahead of their use
struct Seg {
  int4 sg;
  int dn, up;
};

__device__ __forceinline__ Seg seg_of(const Args& a, int item, int ntile) {
  if (item >= a.nitems) return Seg{make_int4(0, 0, 0, 0), 0, 0};
  const int seg = item / ntile;
  return Seg{__ldg(reinterpret_cast<const int4*>(a.kseg) + seg),
             __ldg(a.dn_base + seg), __ldg(a.up_base + seg)};
}

// a work item: RT rows of one segment
struct Tile {
  long r0, db, ub;              // first body row, window starts
  int ed, eu;                   // tap extents
};

__device__ __forceinline__ Tile tile_of(const Args& a, int item, int ntile,
                                        const Seg& g) {
  Tile t;
  const int seg = item / ntile;
  const int tile = item - seg * ntile;
  t.r0 = (long)a.S + (long)seg * a.S + (long)tile * a.RT;
  t.db = (long)g.dn + g.sg.x + (long)tile * a.RT;
  t.ub = (long)g.up + g.sg.y + (long)tile * a.RT;
  t.ed = g.sg.z;
  t.eu = g.sg.w;
  return t;
}

// stage an item's per-row data into row stage ``rs``: the cg windows, the
// per-row tables and the taps (every thread takes part)
__device__ __forceinline__ void stage_rows(const Args& a, const Layout& L,
                                           const Tile& t, float* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nft = a.nft, RT = a.RT;
  const int ncd = t.ed > 0 ? RT + t.ed - 1 : 0;  // cg window rows
  const int ncu = t.eu > 0 ? RT + t.eu - 1 : 0;
  // the cg windows (rows are contiguous in cg)
  for (int i = threadIdx.x; i < (RT + 2) * nft; i += THREADS)
    cp4(rs + L.cgo + i, a.cg + (t.r0 - 1) * nft + i);
  for (int i = threadIdx.x; i < ncd * nft; i += THREADS)
    cp4(rs + L.cgd + i, a.cg + t.db * nft + i);
  for (int i = threadIdx.x; i < ncu * nft; i += THREADS)
    cp4(rs + L.cgu + i, a.cg + t.ub * nft + i);
  // the per-row tables
  for (int i = threadIdx.x; i < RT * 8; i += THREADS) {
    const int q = i >> 3, op = i & 7;
    const long r = t.r0 + q;
    float* d = rs + L.row + q * NROW;
    switch (op) {
      case 0: cp16(d + R_Z, a.geom + r * 8); break;
      case 1: cp16(d + R_Z + 4, a.geom + r * 8 + 4); break;
      case 2: if (a.grads) cp16(d + R_GRADS, a.grads + r * 8); break;
      case 3: if (a.grads) cp16(d + R_GRADS + 4, a.grads + r * 8 + 4); break;
      case 4: cp8(d + R_SEAW, a.sea_own + 2 * r); break;
      case 5: cp8(d + R_CGLDN, a.cgland + 2 * r); break;
      case 6: if (a.uv) cp8(d + R_U, a.uv + 2 * r); break;
      default: cp4(d + R_VALID, a.valid + r); break;
    }
  }
  // the tap columns of the tile's rows, each side up to its extent
  for (int q = warp; q < RT; q += NWARPS) {
    const float* src = a.ktaps + (t.r0 + q) * 2 * a.ew2 * 4;
    float* d = rs + L.tap + q * 2 * a.ew2 * 4;
    for (int c = lane; c < 2 * a.ew2; c += 32)
      if (c < a.ew2 ? c < t.ed : c - a.ew2 < t.eu) cp16(d + 4 * c, src + 4 * c);
  }
}

// stage one band of an item into band stage ``bs``: the own rows with
// their halo directions, the windows the band reads (``sides``: bit 0
// dn, bit 1 up) and the band's lane constants (warps take rows, lanes
// take 16-byte chunks of a row's band)
template <bool CUR>
__device__ __forceinline__ void stage_band(const Args& a, const Layout& L,
                                           const Tile& t, int k0, int sides,
                                           float* bs, bool vec16) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nft = a.nft, RT = a.RT;
  const long Lw = (long)a.nang * nft;
  const int kb = min(KB, a.nang - k0);
  const int bwn = kb * nft;               // band floats in global memory
  const int kl = (k0 + a.nang - 1) % a.nang;     // halo directions
  const int kr = (k0 + kb) % a.nang;
  const long boff = (long)k0 * nft;
  const int nwd = t.ed > 0 ? RT + t.ed - 1 : 0;  // window rows
  const int nwu = t.eu > 0 ? RT + t.eu - 1 : 0;
  auto band_rows = [&](float* dst, int stride, const float* base, long row0,
                       long pitch, int nrows, int n) {
    for (int q = warp; q < nrows; q += NWARPS) {
      const float* src = base + (row0 + q) * pitch;
      float* d = dst + q * stride;
      if (vec16) {
        for (int c = lane; c < (n >> 2); c += 32) cp16(d + 4 * c, src + 4 * c);
      } else {
        for (int c = lane; c < n; c += 32) cp4(d + c, src + c);
      }
    }
  };
  band_rows(bs + L.own, L.os, a.f_in + boff, t.r0 - 1, Lw, RT + 2, bwn);
  if (sides & 1) band_rows(bs + L.dn, L.bw, a.f_in + boff, t.db, Lw, nwd, bwn);
  if (sides & 2) band_rows(bs + L.up, L.bw, a.f_in + boff, t.ub, Lw, nwu, bwn);
  band_rows(bs + L.lcs, L.bl, a.lc + (long)k0 * a.nf, 0, (long)a.nang * a.nf,
            nlc<CUR>(), kb * a.nf);
  // the halo directions of the own rows: k−1 then k+1, wrapped, each as
  // the 16-byte chunks that span it (it starts (k·nft)&3 floats in)
  const int al = vec16 ? (kl * nft) & ~3 : kl * nft;
  const int ar = vec16 ? (kr * nft) & ~3 : kr * nft;
  const int nl = vec16 ? (up4(kl * nft + nft) - al) >> 2 : nft;
  const int nr = vec16 ? (up4(kr * nft + nft) - ar) >> 2 : nft;
  for (int q = warp; q < RT + 2; q += NWARPS) {
    const float* src = a.f_in + (t.r0 - 1 + q) * Lw;
    float* d = bs + L.own + q * L.os + L.bw;
    for (int c = lane; c < nl + nr; c += 32) {
      const bool left = c < nl;
      const int i = left ? c : c - nl;
      float* dc = d + (left ? 0 : L.hs);
      const float* sc = src + (left ? al : ar);
      if (vec16)
        cp16(dc + 4 * i, sc + 4 * i);
      else
        cp4(dc + i, sc + i);
    }
  }
}

template <bool CUR, bool CFL, bool OBS>
__global__ void __launch_bounds__(THREADS, 1) advect_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int band_sides[MAX_BANDS];
  const Layout L = layout<CUR, CFL>(a.nft, a.nf, a.ew2, a.RT);
  const int nft = a.nft, nf = a.nf, nang = a.nang, nw = a.nw, RT = a.RT;
  const long Lw = (long)nang * nft;
  const int nseg = a.nsrl / a.S - 3;
  const bool vec16 = nang % KB == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // front and end pad blocks: zeros below nw, copies above
  {
    const long body_end = (long)a.S * (nseg + 1) * Lw;
    const long npad = 3L * a.S * Lw;
    for (long i = blockIdx.x * (long)THREADS + threadIdx.x; i < npad;
         i += (long)gridDim.x * THREADS) {
      const long idx = i < (long)a.S * Lw ? i : body_end + (i - (long)a.S * Lw);
      const int l = (int)(idx % Lw);
      a.f_out[idx] = (l % nft) < nw ? 0.f : a.f_in[idx];
    }
  }
  // which windows each band reads: without currents a lane reads only its
  // upstream side, dn for a northward direction, else up
  for (int b = threadIdx.x; b < a.nbands; b += THREADS) {
    int sides = 3;
    if (!CUR) {
      sides = 0;
      for (int k = b * KB; k < min(b * KB + KB, nang); ++k)
        sides |= a.lc[LC_NORTH * nang * nf + k * nf] > 0.5f ? 1 : 2;
    }
    band_sides[b] = sides;
  }
  __syncthreads();

  // this thread's lane of a band: j = kk·nft + m
  const int LG = (KB * nft + 31) & ~31;        // threads per row group
  const int rg = THREADS / LG;                 // row groups
  const int j = threadIdx.x % LG, rgi = threadIdx.x / LG;
  const int kk = j / nft, m = j - kk * nft;
  const int jl = kk * nf + m;                  // its lane-constant column
  const int ntile = a.S / RT;
  const int wpr = LG / 32, wig = (threadIdx.x % LG) >> 5;  // warps a row
  const int mm1 = m > 0 ? m - 1 : m;
  const int mp1 = m < nf - 1 ? m + 1 : m;

  int item = blockIdx.x;
  if (item >= a.nitems) return;
  Seg g_next = seg_of(a, item + gridDim.x, ntile);
  Tile cur = tile_of(a, item, ntile, seg_of(a, item, ntile));
  stage_rows(a, L, cur, sm + L.rstage);
  stage_band<CUR>(a, L, cur, 0, band_sides[0], sm, vec16);
  cp_commit();

  int band = 0, li = 0;                        // li: this CTA's item count
  for (int s = 0;; ++s) {
    float* bs = sm + (s & 1) * L.band;
    float* rs = sm + L.rstage + (li & 1) * L.rows;
    // the next (item, band), staged while this one computes
    int nitem = item, nband = band + 1;
    if (nband == a.nbands) { nitem += gridDim.x; nband = 0; }
    const bool more = nitem < a.nitems;
    Tile nxt = cur;
    if (more) {
      if (nband == 0) {                        // a new item: its rows too
        nxt = tile_of(a, nitem, ntile, g_next);
        g_next = seg_of(a, nitem + gridDim.x, ntile);
        stage_rows(a, L, nxt, sm + L.rstage + ((li + 1) & 1) * L.rows);
      }
      stage_band<CUR>(a, L, nxt, nband * KB, band_sides[nband],
                      sm + ((s + 1) & 1) * L.band, vec16);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const int k0 = band * KB, kb = min(KB, nang - k0);
    float* fs = sm + L.fs;
    const int fstr = RT * nf;                  // field stride
    if (band == 0) {
      // ---- phase 1: edge velocities per (row, frequency), once an item
      for (int it = warp; it < RT; it += NWARPS) {
        float* rw = rs + L.row + it * NROW;
        const long r = cur.r0 + it;
        if (lane == 0) rw[R_AREAM1] = 1.f / (rw[R_Z] * rw[R_XD]);
        for (int mm = lane; mm < nf; mm += 32) {
          const float cgl = a.cg_land[mm];
          const float* co = rs + L.cgo + mm;
          const float cg_o = co[(it + 1) * nft];
          const float sea_w = rw[R_SEAW], sea_e = rw[R_SEAE];
          const float cg_w = sea_w * co[it * nft] + (1.f - sea_w) * cgl;
          const float cg_e = sea_e * co[(it + 2) * nft] + (1.f - sea_e) * cgl;
          const float4* tdn = reinterpret_cast<const float4*>(rs + L.tap)
                              + it * 2 * a.ew2;
          const float4* tup = tdn + a.ew2;
          const float* cd = rs + L.cgd + it * nft + mm;
          const float* cu = rs + L.cgu + it * nft + mm;
          float cg_s = 0.f, cg_n = 0.f;
          for (int e = 0; e < cur.ed; ++e) cg_s += tdn[e].x * cd[e * nft];
          for (int e = 0; e < cur.eu; ++e) cg_n += tup[e].x * cu[e * nft];
          cg_s += rw[R_CGLDN] * cgl;
          cg_n += rw[R_CGLUP] * cgl;
          float* o = fs + it * nf + mm;
          o[0] = 0.5f * (cg_o + cg_w) * rw[R_CI];   // x-velocity, west edge
          o[fstr] = 0.5f * (cg_o + cg_e) * rw[R_CI];       // east edge
          o[2 * fstr] = 0.5f * (cg_o + rw[R_DPS] * cg_s);  // y, south edge
          o[3 * fstr] = 0.5f * (cg_o + rw[R_DPN] * cg_n);  // north edge
          o[4 * fstr] = cg_o;
          o[5 * fstr] = a.irefra ? a.pf[r * 3 * nft + mm] : 0.f;  // omosnh2kd
          if (CUR) {
            o[6 * fstr] = a.pf[(r * 3 + 1) * nft + mm];   // cg·wavnum
            o[7 * fstr] = a.pf[(r * 3 + 2) * nft + mm];   // omosnh2kd·wavnum
          }
        }
      }
      __syncthreads();
    }

    // this band's lane constants, from shared memory into registers
    const bool calc = rgi < rg && kk < kb && m < nw;
    const bool copy = rgi < rg && kk < kb && m >= nw;
    float c_s = 0.f, c_cth = 0.f, c_dt = 0.f, c_sp = 0.f, c_sm = 0.f;
    float c_sdp = 0.f, c_cdp = 0.f, c_sdm = 0.f, c_cdm = 0.f;
    float c_ssp = 0.f, c_scp = 0.f, c_ccp = 0.f, c_ssm = 0.f, c_scm = 0.f;
    float c_ccm = 0.f, c_nsc = 0.f, c_ncc = 0.f, c_nss = 0.f, c_dfp = 0.f;
    float c_dfm = 0.f;
    bool ea = false, no = false;
    if (calc) {
      const float* c = bs + L.lcs + jl;
      c_s = c[LC_S * L.bl]; c_cth = c[LC_CTH * L.bl]; c_dt = c[LC_DT * L.bl];
      c_sp = c[LC_SP * L.bl]; c_sm = c[LC_SM * L.bl];
      ea = c[LC_EAST * L.bl] > 0.5f;
      no = c[LC_NORTH * L.bl] > 0.5f;
      if (a.irefra == (CUR ? 3 : 1)) {
        c_sdp = c[LC_SD_P * L.bl]; c_cdp = c[LC_CD_P * L.bl];
        c_sdm = c[LC_SD_M * L.bl]; c_cdm = c[LC_CD_M * L.bl];
      }
      if (CUR) {
        c_ssp = c[LC_SS_P * L.bl]; c_scp = c[LC_SC_P * L.bl];
        c_ccp = c[LC_CC_P * L.bl]; c_ssm = c[LC_SS_M * L.bl];
        c_scm = c[LC_SC_M * L.bl]; c_ccm = c[LC_CC_M * L.bl];
        c_nsc = c[LC_NF_SC * L.bl]; c_ncc = c[LC_NF_CC * L.bl];
        c_nss = c[LC_NF_SS * L.bl]; c_dfp = c[LC_DFP * L.bl];
        c_dfm = c[LC_DFM * L.bl];
      }
    }

    // ---- phase 2: this thread's lane over the tile's rows
    // f(k−1) and f(k+1): in the band, or in a halo span
    const int hl = vec16 ? (((k0 + nang - 1) % nang) * nft) & 3 : 0;
    const int hr = vec16 ? (((k0 + kb) % nang) * nft) & 3 : 0;
    const int off_m1 = kk > 0 ? j - nft : L.bw + hl + m;
    const int off_p1 = kk < kb - 1 ? j + nft : L.bw + L.hs + hr + m;
    // without currents: the live lat and corner slots of the obs table
    const int ob_lat = no ? 0 : nft;
    const int ob_cor = (no ? (ea ? 6 : 5) : (ea ? 7 : 4)) * nft;
    // a warp lies in one row group, so the CFL reductions see full warps
    if (rgi < rg && (CFL || calc || copy)) {
      for (int it = rgi; it < RT; it += rg) {
        const long r = cur.r0 + it;
        const float* own = bs + L.own + (it + 1) * L.os;
        float* dst = a.f_out + r * Lw + (long)k0 * nft + j;
        if (copy) *dst = own[j];
        float sumwn = 0.f, adx = 0.f, ady = 0.f;
        bool bad = false;
        // the row's table: four broadcast vector loads
        const float4* rw4 = reinterpret_cast<const float4*>(
            rs + L.row + it * NROW);
        const float4 g0 = rw4[0], g1 = rw4[1], g4 = rw4[4], g5 = rw4[5];
        const float* rw = rs + L.row + it * NROW;
        const float z = g0.x, xdella = g1.y;
        if (calc) {
          const float* o = fs + it * nf + m;
          const float tp = g0.z;
          const float aream1 = g5.w;
          float w_lats, w_latn, w_lonw, w_lone, w_ne, w_se, w_sw, w_nw;
          if (!CUR) {
            const float dxup_w = fabsf(c_dt * (o[0] * c_s) * a.cmtodeg);
            const float dxup_e = fabsf(c_dt * (o[fstr] * c_s) * a.cmtodeg);
            const float dyup_s = fabsf(c_dt * (o[2 * fstr] * c_cth) * a.cmtodeg);
            const float dyup_n = fabsf(c_dt * (o[3 * fstr] * c_cth) * a.cmtodeg);
            const float dxup_1 = ea ? dxup_w : dxup_e;
            const float dxup_2 = ea ? dxup_e : dxup_w;
            const float dyup_1 = no ? dyup_s : dyup_n;
            const float dyup_2 = no ? dyup_n : dyup_s;
            const float w_jyo1 = (z - dxup_2) * dyup_1 * aream1;
            const float w_jxo1 = (xdella - dyup_2) * dxup_1 * aream1;
            const float wg1 = dxup_1 * dyup_1 * aream1;
            sumwn = (z * dyup_2 + xdella * dxup_2 - dxup_2 * dyup_2) * aream1;
            w_lats = no ? w_jyo1 : 0.f;
            w_latn = no ? 0.f : w_jyo1;
            w_lonw = ea ? w_jxo1 : 0.f;
            w_lone = ea ? 0.f : w_jxo1;
            // only the upstream-upstream corner is live without currents
            // (ctuwupdt.F90:95-150 quadrant → corner map)
            w_ne = (!no && !ea) ? wg1 : 0.f;
            w_se = (no && !ea) ? wg1 : 0.f;
            w_sw = (no && ea) ? wg1 : 0.f;
            w_nw = (!no && ea) ? wg1 : 0.f;
            if (CFL) {
              adx = fmaxf(dxup_w, dxup_e);
              ady = fmaxf(dyup_s, dyup_n);
            }
          } else {
            const float u = g5.x, v = g5.y;
            const float dtc = c_dt;
            const float ux = u * g0.y;
            float ad_w, up_w, dw_w, ad_e, up_e, dw_e;
            float ad_s, up_s, dw_s, ad_n, up_n, dw_n;
            updown(o[0] * c_s, ux, dtc, ad_w, up_w, dw_w);
            updown(o[fstr] * c_s, ux, dtc, ad_e, up_e, dw_e);
            updown(o[2 * fstr] * c_cth, v * 0.5f * (1.f + g0.w), dtc,
                   ad_s, up_s, dw_s);
            updown(o[3 * fstr] * c_cth, v * 0.5f * (1.f + g1.x), dtc,
                   ad_n, up_n, dw_n);
            ad_w *= a.cmtodeg; up_w *= a.cmtodeg; dw_w *= a.cmtodeg;
            ad_e *= a.cmtodeg; up_e *= a.cmtodeg; dw_e *= a.cmtodeg;
            ad_s *= a.cmtodeg; up_s *= a.cmtodeg; dw_s *= a.cmtodeg;
            ad_n *= a.cmtodeg; up_n *= a.cmtodeg; dw_n *= a.cmtodeg;
            const float dxup_1 = ea ? up_w : up_e, dxup_2 = ea ? up_e : up_w;
            const float dxdw_1 = ea ? dw_w : dw_e, dxdw_2 = ea ? dw_e : dw_w;
            const float dyup_1 = no ? up_s : up_n, dyup_2 = no ? up_n : up_s;
            const float dydw_1 = no ? dw_s : dw_n, dydw_2 = no ? dw_n : dw_s;
            const float dxx = z - dxup_2 - dxdw_1;
            const float dyy = xdella - dyup_2 - dydw_1;
            const float w_jyo1 = dxx * dyup_1 * aream1;
            const float w_jyo2 = dxx * dydw_2 * aream1;
            const float w_jxo1 = dyy * dxup_1 * aream1;
            const float w_jxo2 = dyy * dxdw_2 * aream1;
            w_lats = no ? w_jyo1 : w_jyo2;
            w_latn = no ? w_jyo2 : w_jyo1;
            w_lonw = ea ? w_jxo1 : w_jxo2;
            w_lone = ea ? w_jxo2 : w_jxo1;
            const float wg1 = dxup_1 * dyup_1 * aream1;
            const float wg2 = dxdw_2 * dyup_1 * aream1;
            const float wg3 = dxup_1 * dydw_2 * aream1;
            const float wg4 = dxdw_2 * dydw_2 * aream1;
            // quadrant → physical corner (ctuwupdt.F90:95-150)
            w_sw = no ? (ea ? wg1 : wg2) : (ea ? wg3 : wg4);
            w_se = no ? (ea ? wg2 : wg1) : (ea ? wg4 : wg3);
            w_nw = no ? (ea ? wg3 : wg4) : (ea ? wg1 : wg2);
            w_ne = no ? (ea ? wg4 : wg3) : (ea ? wg2 : wg1);
            sumwn = (z * (dydw_1 + dyup_2) + xdella * (dxup_2 + dxdw_1)
                     - (dxdw_1 + dxup_2) * (dydw_1 + dyup_2)) * aream1;
            if (CFL) {
              adx = fmaxf(ad_w, ad_e);
              ady = fmaxf(ad_s, ad_n);
            }
          }

          // direction turning (ctuw.F90:345-420)
          float dthp = tp * c_sp * o[4 * fstr];
          float dthm = tp * c_sm * o[4 * fstr];
          if (a.irefra == (CUR ? 3 : 1)) {        // depth refraction
            const float ddphi = rw[R_GRADS], ddlam_dco = rw[R_GRADS + 1];
            const float drdp = ddphi * c_sdp - ddlam_dco * c_cdp;
            const float drdm = ddphi * c_sdm - ddlam_dco * c_cdm;
            dthp = dthp + o[5 * fstr] * drdp;
            dthm = dthm + o[5 * fstr] * drdm;
          }
          float w_mm1 = 0.f, w_mp1 = 0.f;
          if (CUR) {
            const float* gr = rw + R_GRADS;
            const float duphi = gr[2], dvphi = gr[3];
            const float dulam = gr[4], dvlam = gr[5], omdd = gr[6];
            dthp = dthp + (duphi * c_ssp + dvphi * c_scp
                           - dulam * c_scp - dvlam * c_ccp);
            dthm = dthm + (duphi * c_ssm + dvphi * c_scm
                           - dulam * c_scm - dvlam * c_ccm);
            // σ̇ at m and its clamped neighbours (ctuw.F90:430-470)
            const float sdot_nf = duphi * c_nsc + dvphi * c_ncc
                + dulam * c_nss + dvlam * c_nsc;
            const float* op = fs + it * nf + mp1;
            const float* om = fs + it * nf + mm1;
            const float sd = sdot_nf * o[6 * fstr] + omdd * o[7 * fstr];
            const float sd_p = sdot_nf * op[6 * fstr] + omdd * op[7 * fstr];
            const float sd_m = sdot_nf * om[6 * fstr] + omdd * om[7 * fstr];
            const float dthp_f = (sd + sd_p) * c_dfp;
            const float dthm_f = (sd + sd_m) * c_dfm;
            sumwn = sumwn + ((dthp + fabsf(dthp)) + (fabsf(dthm) - dthm));
            sumwn = sumwn + ((dthp_f + fabsf(dthp_f)) + (fabsf(dthm_f) - dthm_f));
            w_mm1 = (dthm_f + fabsf(dthm_f)) * a.fratio;
            w_mp1 = (-dthp_f + fabsf(dthp_f)) * a.rfratio;
          } else {
            sumwn = sumwn + ((dthp + fabsf(dthp)) + (fabsf(dthm) - dthm));
          }
          const float w_km1 = dthm + fabsf(dthm);
          const float w_kp1 = -dthp + fabsf(dthp);

          // FIR over the rebased windows: [lat, corE, corW] a column
          const float4* tdn = reinterpret_cast<const float4*>(rs + L.tap)
                              + it * 2 * a.ew2;
          const float4* tup = tdn + a.ew2;
          const float* fdn = bs + L.dn + it * L.bw + j;
          const float* fup = bs + L.up + it * L.bw + j;
          const float f_own = own[j];
          const float v_w = g4.x * own[j - L.os];
          const float v_e = g4.y * own[j + L.os];
          float out = (1.f - sumwn) * f_own;
          if (!CUR) {
            // without currents only the upstream side is live: the dn
            // window's latS and one south corner for a northward lane,
            // else the up window's latN and one north corner (the other
            // weights are 0, so the sum is the plain version's)
            const float4* tq = no ? tdn : tup;
            const float* fq = no ? fdn : fup;
            const int ext = no ? cur.ed : cur.eu;
            float v_lat = 0.f, v_cor = 0.f;
            for (int e = 0; e < ext; ++e) {
              const float4 t = tq[e];
              const float fv = fq[e * L.bw];
              v_lat += t.x * fv;
              v_cor += (ea ? t.z : t.y) * fv;
            }
            const float w_lat = no ? w_lats : w_latn;
            const float w_cor = no ? (ea ? w_sw : w_se) : (ea ? w_nw : w_ne);
            if (OBS) {
              const float* ob = a.obs + r * 8 * nft + m;  // [latS latN lonW
              out = out + w_lat * ob[ob_lat] * v_lat;      //  lonE corNE corSE
              out = out + w_lonw * ob[2 * nft] * v_w       //  corSW corNW]
                        + w_lone * ob[3 * nft] * v_e;
              out = out + w_cor * ob[ob_cor] * v_cor;
            } else {
              out = out + w_lat * v_lat;
              out = out + w_lonw * v_w + w_lone * v_e;
              out = out + w_cor * v_cor;
            }
          } else {
            float v_latS = 0.f, v_corSE = 0.f, v_corSW = 0.f;
            float v_latN = 0.f, v_corNE = 0.f, v_corNW = 0.f;
            for (int e = 0; e < cur.ed; ++e) {
              const float4 t = tdn[e];
              const float fv = fdn[e * L.bw];
              v_latS += t.x * fv;
              v_corSE += t.y * fv;
              v_corSW += t.z * fv;
            }
            for (int e = 0; e < cur.eu; ++e) {
              const float4 t = tup[e];
              const float fv = fup[e * L.bw];
              v_latN += t.x * fv;
              v_corNE += t.y * fv;
              v_corNW += t.z * fv;
            }
            if (OBS) {
              const float* ob = a.obs + r * 8 * nft + m;
              out = out + w_lats * ob[0] * v_latS + w_latn * ob[nft] * v_latN;
              out = out + w_lonw * ob[2 * nft] * v_w + w_lone * ob[3 * nft] * v_e;
              out = out + (w_ne * ob[4 * nft] * v_corNE + w_se * ob[5 * nft] * v_corSE
                           + w_sw * ob[6 * nft] * v_corSW + w_nw * ob[7 * nft] * v_corNW);
            } else {
              out = out + w_lats * v_latS + w_latn * v_latN;
              out = out + w_lonw * v_w + w_lone * v_e;
              out = out + (w_ne * v_corNE + w_se * v_corSE
                           + w_sw * v_corSW + w_nw * v_corNW);
            }
          }
          out = out + w_km1 * own[off_m1];
          out = out + w_kp1 * own[off_p1];
          if (CUR) {
            out = out + w_mm1 * own[j - m + mm1];
            out = out + w_mp1 * own[j - m + mp1];
          }
          *dst = g5.z * out;
          if (CFL)
            bad = adx > z || ady > xdella || sumwn > 1.f || sumwn < 0.f;
        }
        if (CFL) {
          // the row's flag and maxima over this warp's lanes, then one
          // slot per warp of the row group
          const int kx = __reduce_max_sync(0xffffffffu,
                                           calc ? fkey(adx / z) : fkey(-INFINITY));
          const int ky = __reduce_max_sync(0xffffffffu,
                                           calc ? fkey(ady / xdella) : fkey(-INFINITY));
          const int ks = __reduce_max_sync(0xffffffffu,
                                           calc ? fkey(sumwn) : fkey(-INFINITY));
          const unsigned b = __reduce_or_sync(0xffffffffu, bad ? 1u : 0u);
          if (lane == 0) {
            int* red = reinterpret_cast<int*>(sm + L.red) + (it * 4) * NWARPS;
            red[0 * NWARPS + wig] = (int)b;
            red[1 * NWARPS + wig] = kx;
            red[2 * NWARPS + wig] = ky;
            red[3 * NWARPS + wig] = ks;
          }
        }
      }
    }
    __syncthreads();
    if (CFL) {
      // one partial per row and band: [flag, x, y, outflow] keys
      for (int i = threadIdx.x; i < RT * 4; i += THREADS) {
        const int it = i >> 2, q = i & 3;
        const int* red = reinterpret_cast<const int*>(sm + L.red)
                         + (it * 4 + q) * NWARPS;
        int v = red[0];
        for (int w = 1; w < wpr; ++w) v = q ? max(v, red[w]) : (v | red[w]);
        a.part[((long)band * 4 + q) * a.nsrl + cur.r0 + it] = v;
      }
      // the slots are rewritten only after the next step's barrier
    }
    if (!more) break;
    if (nband == 0) ++li;
    item = nitem;
    band = nband;
    cur = nxt;
  }
}

// the bands' partials → the per-row CFL flag and the three maxima (valid
// rows; zeros elsewhere)
__global__ void cfl_combine(const int* part, const float* valid, int* cfl,
                            float* stats, int nsrl, int S, int nbands) {
  const long r = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (r >= nsrl) return;
  const int nseg = nsrl / S - 3;
  const bool body = r >= S && r < (long)S * (nseg + 1);
  const bool v = body && valid[r] > 0.f;
  int f = 0, k[3] = {fkey(-INFINITY), fkey(-INFINITY), fkey(-INFINITY)};
  if (v) {
    for (int b = 0; b < nbands; ++b) {
      f |= part[((long)b * 4) * nsrl + r];
      for (int q = 0; q < 3; ++q)
        k[q] = max(k[q], part[((long)b * 4 + q + 1) * nsrl + r]);
    }
  }
  cfl[r] = v ? f : 0;
  for (int q = 0; q < 3; ++q) stats[(long)q * nsrl + r] = v ? fval(k[q]) : 0.f;
}

template <bool CUR, bool CFL, bool OBS>
int launch(const Args& a, void* stream) {
  const Layout L = layout<CUR, CFL>(a.nft, a.nf, a.ew2, a.RT);
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kern = advect_kernel<CUR, CFL, OBS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: the CTAs the SMs hold (measured against one CTA per work
  // item, tools/advect_stages.py)
  int dev = 0, nsm = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  int grid = nsm * (per > 0 ? per : 1);
  grid = grid < a.nitems ? grid : a.nitems;
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool CUR, bool CFL>
int launch_obs(const Args& a, bool obs, void* stream) {
  return obs ? launch<CUR, CFL, true>(a, stream)
             : launch<CUR, CFL, false>(a, stream);
}

}  // namespace

// Shared memory a launch needs with ``rt`` rows a tile (bytes), so that
// the wrapper can pick the tile; 0 for shapes the kernel does not take.
extern "C" long advect_smem(int nft, int nf, int ew2, int rt, int cur,
                            int cfl) {
  if (nft < 1 || ((KB * nft + 31) & ~31) > THREADS) return 0;
  const Layout L = cur ? (cfl ? layout<true, true>(nft, nf, ew2, rt)
                              : layout<true, false>(nft, nf, ew2, rt))
                       : (cfl ? layout<false, true>(nft, nf, ew2, rt)
                              : layout<false, false>(nft, nf, ew2, rt));
  return (long)L.total * (long)sizeof(float);
}

// Host entry, bound from Python with ctypes.  ``cfl``/``stats`` (nsrl
// ints, 3·nsrl floats) are written when not null, through ``part``
// (4·nbands·nsrl ints of scratch).  Returns the CUDA error code of the
// launches (0 = launched).
extern "C" int advect_launch(
    const float* f_in, float* f_out, const float* cg, const float* cg_land,
    const float* ktaps, const float* sea_own, const float* cgland,
    const float* geom, const float* valid, const float* obs, const float* pf,
    const float* grads, const float* uv, const int* dn_base,
    const int* up_base, const int* kseg, const float* lc, int* part,
    int* cfl, float* stats, int nsrl, int nang, int nft, int nf, int nw,
    int S, int ew2, int rt, int nbands, int irefra, int obs_flag,
    float cmtodeg, float fratio, void* stream) {
  const bool cur = irefra == 2 || irefra == 3;
  const bool with_cfl = cfl != nullptr;
  const bool use_obs = obs_flag != 0;
  if (S < 1 || nsrl % S != 0 || nsrl < 3 * S || nw < 1 || nw > nf
      || nf > nft || irefra < 0 || irefra > 3 || (irefra && (!pf || !grads))
      || (cur && !uv) || (!cfl != !stats) || (with_cfl && !part)
      || (use_obs && !obs) || ew2 < 1 || rt < 1 || S % rt != 0
      || nbands != (nang + KB - 1) / KB || nbands > MAX_BANDS
      || advect_smem(nft, nf, ew2, rt, cur, with_cfl) == 0)
    return (int)cudaErrorInvalidValue;
  const int nseg = nsrl / S - 3;
  const Args a{f_in, f_out, cg, cg_land, ktaps, sea_own, cgland, geom,
               valid, obs, pf, grads, uv, dn_base, up_base, kseg, lc, part,
               nsrl, nang, nft, nf, nw, S, ew2, irefra, rt, nbands,
               nseg * (S / rt), cmtodeg, fratio, 1.f / fratio};
  int err;
  if (cur)
    err = with_cfl ? launch_obs<true, true>(a, use_obs, stream)
                   : launch_obs<true, false>(a, use_obs, stream);
  else
    err = with_cfl ? launch_obs<false, true>(a, use_obs, stream)
                   : launch_obs<false, false>(a, use_obs, stream);
  if (err != 0 || !with_cfl) return err;
  cfl_combine<<<(nsrl + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part, valid, cfl, stats, nsrl, S, nbands);
  return (int)cudaGetLastError();
}
