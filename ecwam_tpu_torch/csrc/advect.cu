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
// (dn_base[i] + il + e) and the row-above window (up_base[i] + il + e),
// W/E from the own row, and the CTU weights rebuilt from geom, cg (with
// its land fallback) and the lane constants (ctuw.F90:90-745,
// propags2.F90:49-130).  Rows outside the body are written as zeros.
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
// the current retry mask and CHECKCFL.
//
// What bounds it: bytes.  Each pass reads the spectrum once for the own
// row and, through L2, about twice more for the two neighbour windows,
// and writes it once — with the sub-band passes about 4 spectrum passes
// per model step.  The design is the simple one: one CTA per S-row SRL
// block, a first phase that builds the per-(row, frequency) velocity
// fields of RT rows in shared memory, a second phase with threads over
// (row, lane) outputs reading the windows straight from global memory
// (the 50 MB L2 holds a segment's windows) and skipping zero taps.
// Left on the table: staging the three windows in shared memory with
// cp.async/TMA, rebasing the taps so the FIR needs no per-tap branch,
// and vectorised 16-byte loads.

#include <cuda_runtime.h>

namespace {

// lane-constant rows, in the order of propagation_cuda.LC_ROWS
enum Lc { LC_S, LC_CTH, LC_EAST, LC_NORTH, LC_DT, LC_SP, LC_SM, LC_SD_P,
          LC_CD_P, LC_SD_M, LC_CD_M, LC_SS_P, LC_SC_P, LC_CC_P, LC_SS_M,
          LC_SC_M, LC_CC_M, LC_NF_SC, LC_NF_CC, LC_NF_SS, LC_DFP, LC_DFM,
          NLC };

constexpr int THREADS = 256;
constexpr int RT = 16;          // rows per shared-memory tile
// per-(row, freq) fields in shared memory: 6 without currents, and with
// them 8 on an odd stride of 9, so that the lanes of a warp, which read
// neighbouring frequencies, fall on distinct banks
template <bool CUR>
__host__ __device__ constexpr int nfields() { return CUR ? 9 : 6; }

struct Args {
  const float* f_in; float* f_out;
  const float* cg; const float* cg_land;
  const float* taps_dn; const float* taps_up; const float* sea_own;
  const float* cgland; const float* geom; const float* valid;
  const float* obs; const float* pf; const float* grads; const float* uv;
  const int* dn_base; const int* up_base; const float* lc;
  int* cfl; float* stats;
  int nsrl, nang, nft, nf, nw, S, EW, irefra;
  float cmtodeg, fratio;
};

// order-preserving int key of a float, for atomicMax over floats
__device__ __forceinline__ int fkey(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float fval(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
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

template <bool CUR, bool CFL>
__global__ void __launch_bounds__(THREADS) advect_kernel(Args a) {
  constexpr int NF = nfields<CUR>();
  extern __shared__ float fs[];               // [RT][nf][NF]
  __shared__ int cfl_s[RT], rx_s[RT], ry_s[RT], rs_s[RT];
  const int S = a.S, EW = a.EW, nft = a.nft, nf = a.nf, nang = a.nang;
  const int nw = a.nw;
  const int Lw = nang * nft;                   // storage lanes per row
  const int Ll = nang * nf;                    // lane-constant row length
  const int nseg = a.nsrl / S - 3;
  const int blk = blockIdx.x;
  const long r0 = (long)blk * S;

  if (blk < 1 || blk > nseg) {                 // front / end pad blocks
    for (long idx = threadIdx.x; idx < (long)S * Lw; idx += THREADS) {
      const long r = r0 + idx / Lw;
      const int l = (int)(idx % Lw);
      a.f_out[r * Lw + l] = (l % nft) < nw ? 0.f : a.f_in[r * Lw + l];
    }
    if (CFL) {
      for (int il = threadIdx.x; il < S; il += THREADS) {
        a.cfl[r0 + il] = 0;
        for (int q = 0; q < 3; ++q) a.stats[(long)q * a.nsrl + r0 + il] = 0.f;
      }
    }
    return;
  }
  const int seg = blk - 1;
  const long db = a.dn_base[seg], ub = a.up_base[seg];

  for (int t0 = 0; t0 < S; t0 += RT) {
    const int nrt = min(RT, S - t0);
    if (CFL && threadIdx.x < RT) {
      cfl_s[threadIdx.x] = 0;
      rx_s[threadIdx.x] = ry_s[threadIdx.x] = rs_s[threadIdx.x] =
          fkey(-INFINITY);
    }
    // ---- phase 1: edge velocities per (row, frequency)
    for (int idx = threadIdx.x; idx < nrt * nf; idx += THREADS) {
      const int it = idx / nf, m = idx - it * nf;
      const int il = t0 + it;
      const long r = r0 + il;
      const float* cg = a.cg;
      const float cgl = a.cg_land[m];
      const float cg_o = cg[r * nft + m];
      const float sea_w = a.sea_own[2 * r], sea_e = a.sea_own[2 * r + 1];
      const float cg_w = sea_w * cg[(r - 1) * nft + m] + (1.f - sea_w) * cgl;
      const float cg_e = sea_e * cg[(r + 1) * nft + m] + (1.f - sea_e) * cgl;
      const float* tdn = a.taps_dn + r * 3 * EW;    // latS taps
      const float* tup = a.taps_up + r * 3 * EW;    // latN taps
      float cg_s = 0.f, cg_n = 0.f;
      for (int e = 0; e < EW; ++e) {
        if (tdn[e] != 0.f) cg_s += tdn[e] * cg[(db + il + e) * nft + m];
        if (tup[e] != 0.f) cg_n += tup[e] * cg[(ub + il + e) * nft + m];
      }
      cg_s += a.cgland[2 * r] * cgl;
      cg_n += a.cgland[2 * r + 1] * cgl;
      const float* g = a.geom + r * 8;
      float* o = fs + (it * nf + m) * NF;
      o[0] = 0.5f * (cg_o + cg_w) * g[1];       // x-velocity, west edge
      o[1] = 0.5f * (cg_o + cg_e) * g[1];       // east edge
      o[2] = 0.5f * (cg_o + g[3] * cg_s);       // y-velocity, south edge
      o[3] = 0.5f * (cg_o + g[4] * cg_n);       // north edge
      o[4] = cg_o;
      o[5] = a.irefra ? a.pf[r * 3 * nft + m] : 0.f;   // omosnh2kd
      if (CUR) {
        o[6] = a.pf[(r * 3 + 1) * nft + m];      // cg·wavnum
        o[7] = a.pf[(r * 3 + 2) * nft + m];      // omosnh2kd·wavnum
      }
    }
    __syncthreads();

    // ---- phase 2: outputs over (row, lane)
    for (int idx = threadIdx.x; idx < nrt * Lw; idx += THREADS) {
      const int it = idx / Lw, l = idx - it * Lw;
      const int il = t0 + it;
      const long r = r0 + il;
      const int k = l / nft, m = l - k * nft;
      if (m >= nw) {
        a.f_out[r * Lw + l] = a.f_in[r * Lw + l];
        continue;
      }
      const float* c = a.lc + k * nf + m;       // lane-constant column
      const float* o = fs + (it * nf + m) * NF;
      const float* g = a.geom + r * 8;
      const float z = g[0], tp = g[2], xdella = g[5];
      const float east = c[LC_EAST * Ll], north = c[LC_NORTH * Ll];
      const bool ea = east > 0.5f, no = north > 0.5f;
      const float aream1 = 1.f / (z * xdella);
      float w_lats, w_latn, w_lonw, w_lone, w_ne, w_se, w_sw, w_nw, sumwn;
      float adx = 0.f, ady = 0.f;               // CFL: largest |Δ| per axis
      if (!CUR) {
        const float dxup_w = fabsf(c[LC_DT * Ll] * (o[0] * c[LC_S * Ll]) * a.cmtodeg);
        const float dxup_e = fabsf(c[LC_DT * Ll] * (o[1] * c[LC_S * Ll]) * a.cmtodeg);
        const float dyup_s = fabsf(c[LC_DT * Ll] * (o[2] * c[LC_CTH * Ll]) * a.cmtodeg);
        const float dyup_n = fabsf(c[LC_DT * Ll] * (o[3] * c[LC_CTH * Ll]) * a.cmtodeg);
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
        const float u = a.uv[2 * r], v = a.uv[2 * r + 1];
        const float dtc = c[LC_DT * Ll];
        const float ux = u * g[1];
        float ad_w, up_w, dw_w, ad_e, up_e, dw_e;
        float ad_s, up_s, dw_s, ad_n, up_n, dw_n;
        updown(o[0] * c[LC_S * Ll], ux, dtc, ad_w, up_w, dw_w);
        updown(o[1] * c[LC_S * Ll], ux, dtc, ad_e, up_e, dw_e);
        updown(o[2] * c[LC_CTH * Ll], v * 0.5f * (1.f + g[3]), dtc,
               ad_s, up_s, dw_s);
        updown(o[3] * c[LC_CTH * Ll], v * 0.5f * (1.f + g[4]), dtc,
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
      float dthp = tp * c[LC_SP * Ll] * o[4];
      float dthm = tp * c[LC_SM * Ll] * o[4];
      if (a.irefra == (CUR ? 3 : 1)) {        // depth refraction
        const float ddphi = a.grads[r * 8], ddlam_dco = a.grads[r * 8 + 1];
        const float drdp = ddphi * c[LC_SD_P * Ll] - ddlam_dco * c[LC_CD_P * Ll];
        const float drdm = ddphi * c[LC_SD_M * Ll] - ddlam_dco * c[LC_CD_M * Ll];
        dthp = dthp + o[5] * drdp;
        dthm = dthm + o[5] * drdm;
      }
      float w_mm1 = 0.f, w_mp1 = 0.f;
      int mm1 = m, mp1 = m;
      if (CUR) {
        const float* gr = a.grads + r * 8;
        const float duphi = gr[2], dvphi = gr[3];
        const float dulam = gr[4], dvlam = gr[5], omdd = gr[6];
        dthp = dthp + (duphi * c[LC_SS_P * Ll] + dvphi * c[LC_SC_P * Ll]
                       - dulam * c[LC_SC_P * Ll] - dvlam * c[LC_CC_P * Ll]);
        dthm = dthm + (duphi * c[LC_SS_M * Ll] + dvphi * c[LC_SC_M * Ll]
                       - dulam * c[LC_SC_M * Ll] - dvlam * c[LC_CC_M * Ll]);
        // σ̇ at m and its clamped neighbours (ctuw.F90:430-470)
        const float sdot_nf = duphi * c[LC_NF_SC * Ll] + dvphi * c[LC_NF_CC * Ll]
            + dulam * c[LC_NF_SS * Ll] + dvlam * c[LC_NF_SC * Ll];
        mm1 = m > 0 ? m - 1 : m;
        mp1 = m < nf - 1 ? m + 1 : m;
        const float* op = fs + (it * nf + mp1) * NF;
        const float* om = fs + (it * nf + mm1) * NF;
        const float sd = sdot_nf * o[6] + omdd * o[7];
        const float sd_p = sdot_nf * op[6] + omdd * op[7];
        const float sd_m = sdot_nf * om[6] + omdd * om[7];
        const float dthp_f = (sd + sd_p) * c[LC_DFP * Ll];
        const float dthm_f = (sd + sd_m) * c[LC_DFM * Ll];
        sumwn = sumwn + ((dthp + fabsf(dthp)) + (fabsf(dthm) - dthm));
        sumwn = sumwn + ((dthp_f + fabsf(dthp_f)) + (fabsf(dthm_f) - dthm_f));
        w_mm1 = (dthm_f + fabsf(dthm_f)) * a.fratio;
        w_mp1 = (-dthp_f + fabsf(dthp_f)) / a.fratio;
      } else {
        sumwn = sumwn + ((dthp + fabsf(dthp)) + (fabsf(dthm) - dthm));
      }
      const float w_km1 = dthm + fabsf(dthm);
      const float w_kp1 = -dthp + fabsf(dthp);

      // FIR taps over the dn/up windows: slots [lat, corE, corW]
      const float* tdn = a.taps_dn + r * 3 * EW;
      const float* tup = a.taps_up + r * 3 * EW;
      const float* fdn = a.f_in + (db + il) * Lw + l;
      const float* fup = a.f_in + (ub + il) * Lw + l;
      float v_latS = 0.f, v_corSE = 0.f, v_corSW = 0.f;
      float v_latN = 0.f, v_corNE = 0.f, v_corNW = 0.f;
      for (int e = 0; e < EW; ++e) {
        const float t_s = tdn[e], t_se = tdn[EW + e], t_sw = tdn[2 * EW + e];
        if (t_s != 0.f || t_se != 0.f || t_sw != 0.f) {
          const float fv = fdn[(long)e * Lw];
          v_latS += t_s * fv;
          v_corSE += t_se * fv;
          v_corSW += t_sw * fv;
        }
        const float t_n = tup[e], t_ne = tup[EW + e], t_nw = tup[2 * EW + e];
        if (t_n != 0.f || t_ne != 0.f || t_nw != 0.f) {
          const float fv = fup[(long)e * Lw];
          v_latN += t_n * fv;
          v_corNE += t_ne * fv;
          v_corNW += t_nw * fv;
        }
      }
      const float* frow = a.f_in + r * Lw;
      const float f_own = frow[l];
      const float v_w = a.sea_own[2 * r] * frow[l - Lw];
      const float v_e = a.sea_own[2 * r + 1] * frow[l + Lw];
      const float* ob = a.obs + r * 8 * nft + m;     // [latS latN lonW lonE
      const int km1 = (k + nang - 1) % nang;         //  corNE corSE corSW corNW]
      const int kp1 = (k + 1) % nang;

      float out = (1.f - sumwn) * f_own;
      out = out + w_lats * ob[0] * v_latS + w_latn * ob[nft] * v_latN;
      out = out + w_lonw * ob[2 * nft] * v_w + w_lone * ob[3 * nft] * v_e;
      out = out + (w_ne * ob[4 * nft] * v_corNE + w_se * ob[5 * nft] * v_corSE
                   + w_sw * ob[6 * nft] * v_corSW + w_nw * ob[7 * nft] * v_corNW);
      out = out + w_km1 * frow[km1 * nft + m];
      out = out + w_kp1 * frow[kp1 * nft + m];
      if (CUR) {
        out = out + w_mm1 * frow[k * nft + mm1];
        out = out + w_mp1 * frow[k * nft + mp1];
      }
      a.f_out[r * Lw + l] = a.valid[r] * out;
      if (CFL) {
        const bool bad = adx > z || ady > xdella || sumwn > 1.f || sumwn < 0.f;
        if (bad) atomicOr(&cfl_s[it], 1);
        atomicMax(&rx_s[it], fkey(adx / z));
        atomicMax(&ry_s[it], fkey(ady / xdella));
        atomicMax(&rs_s[it], fkey(sumwn));
      }
    }
    __syncthreads();
    if (CFL) {
      if (threadIdx.x < nrt) {
        const long r = r0 + t0 + threadIdx.x;
        const bool v = a.valid[r] > 0.f;
        a.cfl[r] = v ? cfl_s[threadIdx.x] : 0;
        a.stats[r] = v ? fval(rx_s[threadIdx.x]) : 0.f;
        a.stats[(long)a.nsrl + r] = v ? fval(ry_s[threadIdx.x]) : 0.f;
        a.stats[2L * a.nsrl + r] = v ? fval(rs_s[threadIdx.x]) : 0.f;
      }
      __syncthreads();
    }
  }
}

template <bool CUR, bool CFL>
int launch(const Args& a, void* stream) {
  const size_t smem = (size_t)RT * a.nf * nfields<CUR>() * sizeof(float);
  advect_kernel<CUR, CFL><<<a.nsrl / a.S, THREADS, smem,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entry, bound from Python with ctypes.  ``cfl``/``stats`` (nsrl
// ints, 3·nsrl floats) are written when not null.  Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int advect_launch(
    const float* f_in, float* f_out, const float* cg, const float* cg_land,
    const float* taps_dn, const float* taps_up, const float* sea_own,
    const float* cgland, const float* geom, const float* valid,
    const float* obs, const float* pf, const float* grads, const float* uv,
    const int* dn_base, const int* up_base, const float* lc, int* cfl,
    float* stats, int nsrl, int nang, int nft, int nf, int nw, int S, int EW,
    int irefra, float cmtodeg, float fratio, void* stream) {
  const bool cur = irefra == 2 || irefra == 3;
  if (S < 1 || nsrl % S != 0 || nsrl < 3 * S || nw < 1 || nw > nf
      || nf > nft || irefra < 0 || irefra > 3 || (irefra && (!pf || !grads))
      || (cur && !uv) || (!cfl != !stats))
    return (int)cudaErrorInvalidValue;
  const Args a{f_in, f_out, cg, cg_land, taps_dn, taps_up, sea_own, cgland,
               geom, valid, obs, pf, grads, uv, dn_base, up_base, lc, cfl,
               stats, nsrl, nang, nft, nf, nw, S, EW, irefra, cmtodeg, fratio};
  if (cur)
    return cfl ? launch<true, true>(a, stream) : launch<true, false>(a, stream);
  return cfl ? launch<false, true>(a, stream) : launch<false, false>(a, stream);
}
