// Fused IMPLSCH physics step, minimal or full mode — one row a warp on a
// persistent grid, the tables in shared memory.
//
// Replaces ecwam_tpu/ops/physics/implsch_pallas.py:implsch_pallas_srl
// (kernel B, the SRL entry) and implsch_pallas.py:implsch_pallas (kernel
// C, the compact (nang, nfre, n) entry): the Pallas TPU kernels that trace
// ops/physics/implsch.py under kernelmode.pallas_safe.  One launch entry,
// implsch_launch, takes either layout through a point stride and a bin
// stride.  The plain PyTorch reference is
// ecwam_tpu_torch/ops/physics/implsch.py:implsch via
// implsch_cuda.implsch_srl_plain / implsch_compact_plain; the wrappers are
// implsch_cuda.implsch_srl / implsch_compact.
//
// Chain per row (implsch.F90:120-360): SDEPTHLIM, FKMEAN, 2×SINFLX (AIRSEA
// Newton NITER=18, SINPUT ARD with the sheltering frequency scan,
// FEMEANWS, FRCUTINDEX, STRESSO with TAU_PHI_HF's JTOT integral), SDISSIP
// ARD, SNONLIN DIA (isnonlin=1), SDIWBK, SBOTTOM, the semi-implicit
// update with limiter/floor/cap, IMPHFTAIL, SETICE.  The spectrum (SRL row
// + its tail-block row, or the compact column) is written back; the 6
// stress rows go out.
//
// Full mode (output dates, template flag FULL) adds, per row: PHIWA in the
// second SINFLX call; the WNFLUXES source sums Σ_k ssource, Σ_k sinθ·ssource
// and Σ_k cosθ·ssource per frequency, formed right after SNONLIN (divided by
// max(1−δ·fld, 1)) plus the FLMAX cap term in a second pass, so no fourth
// bin array is kept; WNFLUXES' scalar chain; the second FKMEAN and FEMEANWS;
// STOKESTRN with STOKFAC derived from wavnum and depth.  It writes the 30
// SCAL_OUT_FULL rows and the windsea mask xllws as float 0/1 into
// (nang, nfre, nrows); each lane keeps its directions' mask bits in a 64-bit
// register word (nfre <= 64).
//
// ECMWF's cycle-49/50 options (template flag OPTS, a separate
// instantiation so that the default configuration's code is untouched;
// the options themselves are bits of the uniform ``opts`` argument):
//  * LLGCBZ0, the gravity-capillary roughness closure: HALPHAP on the
//    first call, and TAUT_Z0_GC's two fixed-point loops of NITER steps,
//    each step summing STRESS_GC over the NWAV = 82 gc wavenumbers.  That
//    sum is split over the row's lanes and closed with a row sum; the loop
//    control stays scalar and redundant, as elsewhere.  TAU_PHI_HF's
//    stress integral stops at the gc cut-off and the TAUW cap is dropped;
//  * LLNORMAGAM: per gust and frequency the direction sums Σ gam0·F and
//    Σ gam0·F·sin² normalise the growth rate (SINPUT), and the tail
//    integrals take the same normalisation;
//  * LLCAPCHNK: the wind-capped Charnock parameter (CHNKMIN) and, with
//    LLNORMAGAM, the growth factor RNFAC;
//  * LCISCAL and SDICE3 (LCIWA3): per-bin scaling of the sources by the
//    open-water fraction and the h^1.25·f^4.5 ice attenuation, with the
//    group speed derived from (k, d).
//
// The rest of the reference's physics (template flag EXT, instantiated
// with OPTS, so that the default and OPTS instantiations keep their code;
// the options are further bits of ``opts``):
//  * iphys=0 (template flag JAN, with EXT): Janssen's SINPUT_JAN in place
//    of SINPUT ARD, frequency-parallel, the same per-frequency loop with
//    the lanes over directions and row sums for LLNORMAGAM and the
//    STRESSO/FEMEANWS sums; the cycle-4 SDISSIP_JAN in place of SDISSIP
//    ARD.  Its STRESSO has no sheltering: iphys=0 sets TAUWSHELTER = 0,
//    and STRESSO's sheltered branch with TAUWSHELTER = 0 is the
//    reference's LTAUWSHELTER = .FALSE. branch (the stress is the
//    wind's, the tail integrand's u* constant);
//  * ISNONLIN=0, the DIA enhancement from depth and the mean wavenumber;
//    ISNONLIN=2, TRANSF_SNL with PEAK_ANG's spreads: the peak is the
//    lowest-index maximum over (k, m = 1..nfre−2) — lane maxima, then a
//    row reduction that keeps the lowest index on ties — and the window
//    of 2·NSH+1 frequencies updates THMEAN in order, each step closed by
//    row sums; 1 − r1 is accumulated as Σ 2·sin²(Δθ/2)·F·Δf, free of
//    cancellation for narrow spectra;
//  * SDICE1 (a bilinear lookup per frequency in the 16×36 CIDEAC table
//    in global memory, through the read-only cache, and the per-row floe
//    size) and SDICE2 (per bin), before SDICE3, as the reference orders
//    them;
//  * CIMSSTRN (full mode, LSTRN): AKI_ICE's 25 Newton steps, one lane per
//    frequency, on the spectrum after SETICE;
//  * the switches: LBIWBK off drops SDEPTHLIM and SDIWBK; LICERUN off the
//    LCISCAL scaling, SDICE, the sea-ice flux and Stokes branches and
//    SETICE; LMASKICE off SETICE.
//
// u*-driven forcing (ICODE_WND 1/2, template flag UST, the compact entry
// in either mode: the dense model's physics step), instantiated with OPTS
// and with EXT/JAN, so that every option combines with it: AIRSEA's u*
// branch replaces the TAUT_Z0 solve (and, under LLGCBZ0, TAUT_Z0_GC and
// HALPHAP) in both SINFLX calls — Z0WAVE from the carried u* and TAUW
// (LLCAPCHNK: the Charnock parameter capped at the call's incoming U10),
// then U10 from the log profile, u*/κ·(ln XNLEV − ln z0), floored at
// WSPMIN — and that U10 feeds the rest of the chain (RNFAC of the second
// call, SINPUT, the sea-ice flux branch, Stokes) and goes out as one more
// row after the mode's (airsea.F90:44-70, implsch.py's ICODE 1/2
// hand-over).
//
// Full mode's switches (EXT bits, so that the default and OPTS
// instantiations keep their code): LCFLX off leaves out the flux sums and
// WNFLUXES and writes their rows as 0, LSTOKES off STOKESTRN and CIMSSTRN
// (their rows 0); LWVFLX_SNL off takes the flux source before SNONLIN
// and without the implicit factor (implsch.F90:281-306), summed per
// frequency into the row's own ``pre`` arrays, which SNONLIN leaves alone.
//
// Two widths of this file (implsch_cuda picks one from nang and nfre):
// the default, KPL = 2 directions a lane (nang <= 64) with each lane's
// windsea-mask bits in a 64-bit register word per direction (full mode,
// nfre <= 64); and IMPLSCH_WIDE, KPL = 4 with the mask in the row's
// shared words, nfre words of 32 bits per direction rounded up (any nfre),
// at most 8 warps a block (a 72×36 row takes ≈ 35 KB, so about six rows
// an SM) and so up to 255 registers a thread.  The wide build takes any
// nang whose row and tables fit one block's shared memory: the first GRP
// = 128 directions as before, in the lanes' registers; past them (the
// per-direction stages of SINPUT, SNONLIN, STRESSO and PEAK_ANG) the rest
// in further passes of RL directions, one a lane, their sums added to the
// first group's, and LLNORMAGAM's direction sums taken in a pass of their
// own first.  Past 128 directions W stays in global memory (it is nang²;
// SDISSIP reads its band through the cache).  Each width
// is built twice, with IMPLSCH_SRL (the SRL entry's instantiations) and
// with IMPLSCH_COMPACT (the compact entry's, UST among them), so that
// the four libraries compile in parallel.
//
// What bounds it: arithmetic and transcendentals.  Its only bulk traffic
// is one read and one write of each spectrum row (≈2·nang·nfre·4 bytes);
// everything else is a few hundred bytes of per-row env/forcing.  The
// whole row's spectrum and its two source arrays (fl, fld, sl) stay in
// shared memory, so the ~30 passes the plain version makes over device
// memory become on-chip work.  The design for Hopper answers the parent
// kernel's time by stage (one warp per row, every table read from global
// memory; ecwam_tpu_torch/tools/implsch_stages.py, PERF.md): SNONLIN 41 %,
// SINPUT 24 %, SDISSIP 17 %, TAUT_Z0_GC 13 % with the options, each other
// stage 2–6 %, the load and store 3 %:
//  * a persistent grid of one block per SM (where shared memory allows
//    only one) whose warps step through the rows; each block first copies
//    the parameter block, the per-frequency and per-direction tables, the
//    saturation matrix W, the DIA weights and index tables and (OPTS) the
//    gc tables into shared memory, so no inner loop reads a table from
//    global memory;
//  * RL = 32 lanes a row, one row a warp, twelve warps (rows) an SM at
//    36×36, as many as shared memory holds (≈18 KB a row).  The kernel is
//    latency-bound: half the warps take 1.7–1.8× the time.  Two rows a warp
//    (RL = 16, the rows in flight as many) keep 75 % of the lanes busy in
//    the per-direction stages, where one row a warp leaves 28 of 32 idle
//    in the second pass over 36 directions, and share each instruction of
//    a sequential chain between two rows; but they halve the warps, and
//    ran 1.27× slower by default and 1.56× with the options (PERF.md), so
//    RPW = 32 / RL rows a warp stays a constant of this file.  The chains
//    (TAUT_Z0's Newton steps, the sheltering scan, the JTOT tail
//    integrals, the SDIWBK Newton) run redundantly on a row's lanes: by
//    default they cost 2–3 % each of the parent's time, and one lane per
//    row would put block barriers between the stages;
//  * fl, fld and sl with an odd direction pitch nfp (nfre, odd), so the
//    lanes' direction-strided and frequency-strided accesses are free of
//    bank conflicts; rows 16 banks apart where that costs no warp;
//  * bin loops carry (k, m) from one bin to the next: no division;
//  * SDISSIP ARD (17 %): B(k, m) once per bin over W's band of
//    2·NSDSNTH+1 directions (was twice over all), bins over the lanes,
//    between the two SINFLX calls, where the first call's source arrays
//    are dead: sl holds B, fld the rate d, and the second SINPUT forms
//    fld + d and sl + d·F as the reference orders them;
//  * SNONLIN (41 %): the direction wraps of the taps by compare-and-
//    subtract, once per row and KH; each lane reads the old values of its
//    five target bins before it writes any (they are distinct,
//    pack_tables checks); one writer per bin in a fixed order, no
//    atomics.  With one row a warp its step loop was bound by the SM's
//    shared-memory pipe and by two __syncwarp a step (151 warp-wide
//    shared-memory instructions a step in the build's SASS at 36
//    directions: scalar table reads, re-read after each store they might
//    alias, the tap stage's 9 loads and 4 stores and the scatter's 20
//    loads and 10 stores, each twice), so it is a two-stage pipeline: a
//    step's weights, indices and af11 are one 16-byte-aligned record read
//    in 9 float4 broadcasts; the lane's own ad and delad stay in its
//    registers; step j + 1's taps (fl is constant through SNONLIN) go
//    into a second buffer after step j's scatter has read the first, so
//    one __syncwarp a step orders both; and the two target bins a step
//    shares with the next (ikm1, ikp1 are the next ikm, ikp) stay in
//    registers.  74 shared-memory instructions a step (PERF.md); the row
//    does not grow: the second buffer lies over cosw and sin2, dead
//    through SNONLIN (cosw is formed again after it).  The scatter takes
//    one direction slot q at a time, and the taps follow it: with both
//    slots' loads ahead of the taps ptxas spilled registers all over the
//    kernel and the step ran no faster than the parent's;
//  * SINPUT (24 %): the two gusts of the second call side by side in one
//    direction pass; the first call writes no source arrays (the second
//    overwrites them) and full mode's PHIWA terms only in the second;
//  * per-frequency factors of the per-bin stages (SBOTTOM's rate, the
//    group speed and the sea-ice rates of SDICE1/3, IMPHFTAIL's ratio)
//    once per frequency, not per bin; the converged Newton loops of
//    TAUT_Z0_GC's second stage and SDIWBK stop once nothing changes.
// Load and store take 3 % of the parent's time, so the row is copied with
// plain coalesced loads, not cp.async.

#include <cuda_runtime.h>
#include <math.h>

// A named namespace, not an anonymous one: nvcc names an anonymous
// namespace with a hash drawn anew at each compilation, and ptxas then gave
// one source's default minimal kernel 152 or 161 registers from build to
// build (83 or 94 ms on all O320 rows); under a fixed name every build of
// a source is the same (tools/ptxas_registers.py).  Each build is its own
// shared library, loaded with RTLD_LOCAL, so the names cannot clash.
namespace ecwam_implsch {

// scalar parameters, in the order of implsch_cuda.PAR_NAMES
enum Par {
  P_DELT, P_DELT5, P_DELTH, P_DELT25, P_DELT2, P_COEF1,
  P_ZALP, P_FPMH, P_FPPM, P_FLOGSPRDM1, P_ALPHAOG, P_ALPHAMIN,
  P_CONST1, P_TAUWSHELTER, P_Z0RAT, P_Z0TUBMAX, P_SWELLF4, P_SWELLF7M1,
  P_X0G, P_TMP03, P_TPIINV, P_DAL1, P_DAL2,
  P_G, P_GM1, P_XKAPPA, P_XLOGXL, P_RNUM, P_RNU4, P_TWO_NU,
  P_EPSMIN, P_EPSUS, P_EPS1P, P_ACD, P_BCD, P_CDMAX,
  P_C1CD, P_C2CD, P_P1CD, P_P2CD, P_P2C1, P_P12, P_HALF_KAPPA, P_LN10,
  P_SWF16, P_SWF5_2, P_FU, P_FUD, P_SSDSC2, P_SSDSC4, P_SSDSC6,
  P_ONE_M_SSDSC6,
  P_FLMIN, P_CITHRSH, P_CITHRSH_TAIL, P_BATHYMAX, P_DKMAX, P_DEPTHTRS,
  P_ROWATERM1, P_ZPI4GM2, P_SBOT_C, P_ABMIN, P_DELABM1, P_ENH_MIN,
  P_ENH_MAX, P_NSDSNTH,
  // full mode only
  P_DELTM, P_ZPI4GM1, P_COEFA, P_COEFX, P_WSEMEAN_MIN,
  P_LWAMRSETCI, P_ZCITHRS, P_CITHRSH_INV, P_ZMAXEXP, P_EFD_FAC, P_FFD_FAC,
  P_EFD_MIN, P_EFD_MAX, P_CDB_C1, P_CDB_C2, P_CDB_P1, P_CDB_P2, P_CDB_MAX,
  P_EPSU10, P_EPSUS3, P_TAUOCMIN, P_TAUOCMAX, P_PHIEPSMIN, P_PHIEPSMAX,
  P_PHIOC_ICE, P_PHIAW_ICE, P_TWOG, P_TWOGM1, P_STOKES_C, P_STMAX,
  P_CITHRSH_STOKES,
  // the cycle-49/50 options
  P_ALPHA, P_CHNKMIN_U, P_ANG_GC_A, P_ANG_GC_B, P_ANG_GC_C, P_BMAXOKAP,
  P_RN1_RN, P_DTHRN_A, P_DTHRN_U, P_GAMNCONST, P_ALPHAPMAX, P_XNLEV,
  P_RNUKAPPAM1, P_SQRTGOSURFT, P_XKM0, P_XLOGKRATIOM1, P_ACDLIN, P_BCDLIN,
  P_ALPHAMAX, P_CONSTN, P_CDICE2, P_LOGFR_LAST, P_FR_NM3, P_HALP_TAIL,
  P_G4PI,
  // iphys=0, ISNONLIN 0/2, SDICE1/2 and CIMSSTRN
  P_CONSS, P_DELTA_SDIS, P_CVIS, P_CONST3, P_XKAPPAD, P_NSH, P_COEF_FR2,
  P_XKDMIN, P_TICMIN, P_DTIC, P_NICT, P_HICMIN, P_DHIC, P_NICH, P_CDICWA,
  P_FICSTF_C, P_RDH_C, P_AKI_MAX, P_F1LIM,
  NPAR
};

// option bits of ``opts``, in the order of implsch_cuda.OPT_FLAGS
enum Opt { OPT_LLGCBZ0 = 1, OPT_LLNORMAGAM = 2, OPT_LLCAPCHNK = 4,
           OPT_LCIWA3 = 8, OPT_LCISCAL = 16,
           OPT_IPHYS0 = 32, OPT_ISNONLIN0 = 64, OPT_ISNONLIN2 = 128,
           OPT_LCIWA1 = 256, OPT_LCIWA2 = 512, OPT_LSTRN = 1024,
           OPT_NO_LBIWBK = 2048, OPT_NO_LICERUN = 4096,
           OPT_NO_LMASKICE = 8192, OPT_NO_LCFLX = 16384,
           OPT_NO_LSTOKES = 32768, OPT_NO_LWVFLX_SNL = 65536,
           OPT_USTAR = 131072 };
constexpr int OPT_EXT = 32 * 4095;           // the EXT instantiations' bits

// gravity-capillary tables (NWAV each), in the order of
// implsch_cuda.GC_TABLES
enum GcTab { G_LOGXK, G_CM, G_OM3GMKM, G_XKMSQRTVGOC2, G_DELKCC_OMXKM3,
             G_C2OSQRTVG, G_DNS_OMXKM3, G_OMEGA, NGCTAB };
// the tables STRESS_GC reads for every wavenumber, staged in shared
// memory; the others are read at one index a call, from global memory
constexpr int NGCSTAGE = G_C2OSQRTVG;

// per-frequency tables following the parameters, in this order
enum FreqTab { T_FR, T_DFIM, T_DFIMOFR, T_DFIMFR, T_ZPIFR, T_FR5, T_COFRM4,
               T_RHOWG, T_FLMAX, T_DFIMSIM, T_FR45, T_DFIMFR2, NFREQTAB };

// rows of the full-mode output block, in the order of
// implsch_cuda.SCAL_OUT_FULL (the first 6 are the minimal mode's)
enum Out { O_UFRIC, O_TAUW, O_TAUWDIR, O_Z0M, O_Z0B, O_CHRNCK, O_MIJ,
           O_PHIWA, O_EMEAN, O_FMEAN, O_F1MEAN, O_AKMEAN, O_XKMEAN,
           O_EMEANWS, O_FMEANWS, O_WSEMEAN, O_WSFMEAN, O_TAUXD, O_TAUYD,
           O_TAUOCXD, O_TAUOCYD, O_TAUOC, O_PHIOCD, O_PHIEPS, O_PHIAW,
           O_EM_OC, O_F1_OC, O_USTOKES, O_VSTOKES, O_STRNMS, NOUT_FULL };
// UST's extra row: the U10 of the log profile, after the mode's rows
constexpr int O_WSWAVE = NOUT_FULL;
constexpr int NOUT_MIN = O_MIJ;              // the minimal mode's rows

constexpr int RL = 32;          // lanes a row
constexpr int RPW = 32 / RL;    // rows a warp
#ifdef IMPLSCH_WIDE
constexpr bool WIDE = true;     // the mask in shared memory
constexpr int KPL = 128 / RL;   // directions a lane in registers: the
                                // first 128; the rest in further passes
constexpr int MAX_WARPS = 8;    // warps a block (the launch takes fewer
                                // where shared memory holds fewer)
#else
constexpr bool WIDE = false;
constexpr int KPL = 64 / RL;    // directions a lane: nang <= 64
constexpr int MAX_WARPS = 12;   // warps a block (the launch takes fewer
                                // where shared memory holds fewer)
#endif
// the directions the lanes' registers hold (one group); past it, the wide
// build walks the rest a direction a lane at a time, in passes of RL
constexpr int GRP = RL * KPL;
constexpr int JTOT = 19;        // tail-integral nodes (tables.JTOT_TAUHF)
constexpr int NITER = 18;       // TAUT_Z0 Newton steps
constexpr float EPS1 = 1.0e-5f; // tauw/u*² margin (yowtabl.F90:34)
constexpr unsigned ALL = 0xffffffffu;

// The parameter block and tables.  implsch_launch fills it with pointers
// into the packed device arrays; each block of the kernel copies the
// tables its inner loops read into shared memory and points it there
// (stage_tables), and adds the bin walk's constants.
struct Tabs {
  const float* par;
  const float* fr; const float* dfim; const float* dfimofr;
  const float* dfimfr; const float* zpifr; const float* fr5;
  const float* cofrm4; const float* rhowg; const float* flmax;
  const float* dfimsim; const float* fr45;
  const float* th; const float* sinth; const float* costh;
  const float* wmat; const float* swellft; const float* wtauhf;
  const float* gc;                             // GcTab's first NGCSTAGE
  const float* gcx;                            // every GcTab, global
  const float* dia;                            // the DIA step records
  const float* xk_ext; const int* shifts;
  int nang, nfre, nred, mlsthg, niab, nwav, opts;
  const float* dfimfr2; const float* cideac;   // EXT only
  // the bin walk (for_bins): the direction pitch of fl/fld/sl (nfre,
  // odd), the step RL = dk·nfre + dm, and the lane's first bin (k0, m0)
  int nfp, dk, dm, k0, m0;
};

// sum over a row's RL lanes, the same value (its first lane's) on each
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = RL / 2; o > 0; o >>= 1) v += __shfl_xor_sync(ALL, v, o, RL);
  return __shfl_sync(ALL, v, 0, RL);
}

// Σ_m f(m) over the frequency ladder (lanes stride m)
template <class F>
__device__ __forceinline__ float msum(int nfre, int lane, F f) {
  float s = 0.f;
  for (int m = lane; m < nfre; m += RL) s += f(m);
  return row_sum(s);
}

// out[m] = Σ_k a[k, m], one lane per frequency, directions in order
__device__ __forceinline__ void colsum(const float* a, float* out, int nang,
                                       int nfre, int nfp, int lane) {
  for (int m = lane; m < nfre; m += RL) {
    float s = 0.f;
    for (int k = 0; k < nang; ++k) s += a[k * nfp + m];
    out[m] = s;
  }
  __syncwarp();
}

// f(b, k, m) on the lane's bins k·nfre + m = lane, lane + RL, ... (b =
// k·nfp + m, its place in fl/fld/sl): (k, m) is carried from one bin to
// the next, so the loop divides nothing
template <class F>
__device__ __forceinline__ void for_bins(const Tabs& T, F f) {
  const int nfre = T.nfre, nfp = T.nfp, n = T.nang * nfre;
  int k = T.k0, m = T.m0;
  for (int i = T.k0 * nfre + T.m0; i < n; i += RL) {
    f(k * nfp + m, k, m);
    m += T.dm;
    k += T.dk;
    if (m >= nfre) {
      m -= nfre;
      ++k;
    }
  }
}

// i in [0, 2n) wrapped into [0, n)
__device__ __forceinline__ int wrap(int i, int n) {
  return i >= n ? i - n : i;
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// CHNKMIN, the minimum Charnock parameter for very high winds
// (chnkmin.F90:28)
__device__ __forceinline__ float chnkmin(const float* P, float u10) {
  return P[P_ALPHAMIN] + (P[P_ALPHA] - P[P_ALPHAMIN]) * 0.5f
      * (1.f - tanhf(u10 - P[P_CHNKMIN_U]));
}

// TAUT_Z0, non-LLGCBZ0 branch (taut_z0.F90:230-290); OPTS adds LLCAPCHNK
template <bool OPTS>
__device__ void taut_z0(const float* P, int opts, float utop, float udir,
                        float tauw, float tauwdir, float ug, int iusfg,
                        float& ustar, float& z0, float& z0b, float& chrnck) {
  const float tauwact = fmaxf(tauw * cosf(udir - tauwdir), P[P_EPSMIN]);
  const float tauweff = tauwact * P[P_EPS1P];
  float alphaog = P[P_ALPHAOG], xmin = 0.f;
  if (OPTS && (opts & OPT_LLCAPCHNK)) {
    const float cmin = chnkmin(P, utop);
    xmin = 0.15f * (P[P_ALPHA] - cmin);
    alphaog = cmin * P[P_GM1];
  }
  const float xkutop = P[P_XKAPPA] * utop;
  const float ustold = iusfg == 1
      ? ug : utop * sqrtf(fminf(P[P_ACD] + P[P_BCD] * utop, P[P_CDMAX]));
  float tauold = fmaxf(ustold * ustold, tauweff);
  float us = sqrtf(tauold);
  float ustm1 = 1.f / fmaxf(us, P[P_EPSUS]);
  float z0ch = 0.f;
  for (int it = 0; it < NITER; ++it) {
    const float x = fmaxf(tauwact / tauold, xmin);
    z0ch = alphaog * tauold / sqrtf(1.f - x);
    const float z0vis = P[P_RNUM] * ustm1;
    const float z0tot = z0ch + z0vis;
    const float xologz0 = 1.f / (P[P_XLOGXL] - logf(z0tot));
    const float f = us - xkutop * xologz0;
    const float zz = ustm1 * (z0ch * (2.f - 3.f * x) / (1.f - x) - z0vis)
        / z0tot;
    const float delf = 1.f - xkutop * (xologz0 * xologz0) * zz;
    if (delf != 0.f) us = us - f / delf;
    tauold = fmaxf(us * us, tauweff);
    us = sqrtf(tauold);
    ustm1 = 1.f / fmaxf(us, P[P_EPSUS]);
  }
  ustar = us;
  z0 = z0ch;
  z0b = alphaog * tauold;
  chrnck = fmaxf(P[P_G] * z0ch * (ustm1 * ustm1), P[P_ALPHAMIN]);
}

// AIRSEA's u* branch (airsea.F90 ICODE 1/2): Z0WAVE (z0wave.F90:40-60)
// from u* and the wave stress (LLCAPCHNK: the Charnock parameter capped
// at the incoming U10 ``u10``), then U10 from the log profile, floored at
// WSPMIN = 1
__device__ float z0wave_u10(const float* P, int opts, float ustar,
                            float tauw, float u10, float& z0, float& z0b,
                            float& chrnck) {
  const float alphaog = (opts & OPT_LLCAPCHNK) ? chnkmin(P, u10) * P[P_GM1]
                                               : P[P_ALPHAOG];
  const float ust2 = ustar * ustar;
  const float arg = fmaxf(ust2 - tauw, EPS1);
  z0 = alphaog * (ust2 * ustar) / sqrtf(arg);
  z0b = alphaog * ust2;
  chrnck = P[P_G] * z0 / ust2;
  return fmaxf((1.f / P[P_XKAPPA]) * ustar * (P[P_XLOGXL] - logf(z0)), 1.f);
}

// WSIGSTAR (wsigstar.F90:48-86); OPTS adds the LLGCBZ0/LLNORMAGAM branch
template <bool OPTS>
__device__ float wsigstar(const float* P, int opts, float wswave,
                          float ufric, float z0m, float wstar) {
  const float w3 = wstar * wstar * wstar;
  if (OPTS && (opts & (OPT_LLGCBZ0 | OPT_LLNORMAGAM))) {
    const float u10m1 = 1.f / fmaxf(wswave, 1.f);
    const float z0vis = P[P_RNUM] / fmaxf(ufric, P[P_EPSUS]);
    float zchar = P[P_G] * (z0m - z0vis) / fmaxf(ufric * ufric, P[P_EPSUS]);
    zchar = fminf(fmaxf(zchar, P[P_ALPHAMIN]), P[P_ALPHAMAX]);
    const float bcd = P[P_BCDLIN] * sqrtf(zchar);
    const float c_d = P[P_ACDLIN] + bcd * wswave;
    const float sig_conv = 1.f + 0.5f * wswave / c_d * bcd;
    return fminf(0.9f, sig_conv * u10m1
                           * powf(P[P_HALF_KAPPA] * w3, 1.f / 3.f));
  }
  const float u10 = fmaxf(ufric / P[P_XKAPPA] * (P[P_LN10] - logf(z0m)),
                          1.f);
  const float u10m1 = 1.f / u10;
  const float c2u10p1 = P[P_C2CD] * powf(u10, P[P_P1CD]);
  const float u10p2 = powf(u10, P[P_P2CD]);
  const float c_d = (P[P_C1CD] + c2u10p1) * u10p2;
  const float dc_ddu = (P[P_P2C1] + P[P_P12] * c2u10p1) * u10p2 * u10m1;
  const float sig_conv = 1.f + 0.5f * u10 / c_d * dc_ddu;
  return fminf(0.9f, sig_conv * u10m1
                         * powf(P[P_HALF_KAPPA] * w3, 1.f / 3.f));
}

// NS_GC, the 0-based gc cut-off index for u* (ns_gc.F90:21-23)
__device__ __forceinline__ int ns_gc(const Tabs& T, float ustar) {
  const float* P = T.par;
  const float xks = P[P_SQRTGOSURFT] / (1.48f + 2.05f * ustar);
  const int ns0 = (int)floorf(logf(fmaxf(xks * P[P_XKM0], 1.f))
                              * P[P_XLOGKRATIOM1]);
  return min(ns0, T.nwav - 2);
}

// STRESS_GC (stress_gc.F90:63-103): the gc-range wave stress for
// (ustar, z0).  The sum over the NWAV wavenumbers is split over the
// row's lanes; every lane of the row returns the same value
__device__ float stress_gc(const Tabs& T, int lane, float ang, float ustar,
                           float z0, float z0min, float halp, float rnfac) {
  const float* P = T.par;
  const float* G = T.gc;
  const int nw = T.nwav;
  const int ns = ns_gc(T, ustar);
  const float c2_ns = T.gcx[G_C2OSQRTVG * nw + ns];
  const float tauwcg_min = (ustar * (z0min / z0)) * (ustar * (z0min / z0));
  const float u4 = (ustar * ustar) * (ustar * ustar);
  const float logxl = logf(1.f + 0.25f * tanhf(4.f * u4));
  const float zabhrc = ang * P[P_CONST1] * halp * c2_ns;
  const float cn = (T.opts & OPT_LLNORMAGAM)
      ? rnfac * P[P_BMAXOKAP] * halp * c2_ns / fmaxf(ustar, P[P_EPSUS]) : 0.f;
  const float logz0 = logf(z0);
  float part = 0.f;
  for (int i = lane; i < nw; i += RL) {
    if (i < ns) continue;
    const float x = ustar * G[G_CM * nw + i];
    const float xlog = G[G_LOGXK * nw + i] + logz0
        + P[P_XKAPPA] / (x + P[P_ZALP]);
    const float zlog = fminf(xlog - logxl, 0.f);
    const float zlog2x = zlog * zlog * x;
    const float gam_w = zlog2x * zlog2x * expf(xlog) * G[G_OM3GMKM * nw + i];
    const float zn = cn * G[G_XKMSQRTVGOC2 * nw + i] * gam_w;
    const float g = gam_w * ((1.f + P[P_RN1_RN] * zn) / (1.f + zn));
    part += g * (i == ns ? T.gcx[G_DNS_OMXKM3 * nw + i]
                         : G[G_DELKCC_OMXKM3 * nw + i]);
  }
  return fmaxf(zabhrc * row_sum(part), tauwcg_min);
}

// the empirical neutral drag curve CDM (taut_z0 cdm.func.h)
__device__ __forceinline__ float cdm(float u) {
  return fmaxf(fminf(0.0006f + 0.00008f * u,
                     0.001f + 0.0018f * expf(-0.05f * (u - 33.f))), 0.001f);
}

// TAUT_Z0, LLGCBZ0 branch (taut_z0.F90:146-281): the under-relaxed
// fixed-point solve of u*² = τw + τvisc + τgc, then the Newton solve for
// z0 and the Charnock parameter, with the reference's convergence exits,
// no-convergence fallbacks and the x1 ≥ pmax skip
__device__ void taut_z0_gc(const Tabs& T, int lane, float utop, float udir,
                           float tauw, float tauwdir, float ug, float halp,
                           float rnfac, int iusfg, float& ustar, float& z0,
                           float& z0b, float& chrnck) {
  const float* P = T.par;
  const float z0min = 1.0e-6f, pmax = 0.99f;
  const float pce = iusfg == 1 ? 0.001f : 0.005f;
  const float cosdiff = cosf(udir - tauwdir);
  const float tauwact = fmaxf(tauw * cosdiff, P[P_EPSMIN]);
  const float alphaog = (T.opts & OPT_LLCAPCHNK) ? chnkmin(P, utop) * P[P_GM1]
                                               : 0.f;
  const float usmax = fmaxf(-0.21339f + utop * (0.093698f + utop
      * (-0.0020944f + 5.5091e-5f * utop)), 0.03f);
  const float tauweff = fminf(tauwact * P[P_EPS1P], usmax * usmax);
  float us;
  if (iusfg == 0) {
    const float ugs = fmaxf(ug, P[P_EPSUS]);
    const float x = fminf(tauwact / (ugs * ugs), pmax);
    float zchar = fminf(P[P_ALPHAOG] * (ug * ug) / sqrtf(1.f - x),
                        0.05f * expf(-0.05f * (utop - 35.f)));
    zchar = fminf(zchar, P[P_ALPHAMAX]);
    const float cdfg = utop < 1.f ? 0.002f
        : (cosdiff > 0.9f ? P[P_ACDLIN] + P[P_BCDLIN] * sqrtf(zchar) * utop
                          : cdm(utop));
    us = utop * sqrtf(cdfg);
  } else {
    us = ug;
  }
  const float w1 = 0.85f - 0.05f * (tanhf(10.f * (utop - 5.f)) + 1.f);
  const float xkutop = P[P_XKAPPA] * utop;
  auto z0_of = [&](float u, float lo) {
    return fmaxf(P[P_XNLEV] / (expf(fminf(xkutop / u, 50.f)) - 1.f), lo);
  };

  // first stage: u* from the stress balance
  float ustold = us, tauold = us * us, ust = us, tauunr = 0.f;
  bool done = false;
  for (int it = 0; it < NITER; ++it) {
    const float z0n = z0_of(ustold, z0min);
    const float tauv = P[P_RNUKAPPAM1] * ustold / z0n;
    const float ang = P[P_ANG_GC_A] + P[P_ANG_GC_B]
        * tanhf(P[P_ANG_GC_C] * tauold);
    const float tauunr_n = stress_gc(T, lane, ang, ustold, z0n, z0min, halp,
                                     rnfac);
    const float taunew = tauweff + tauv + tauunr_n;
    const float ustmix = w1 * ustold + (1.f - w1) * sqrtf(taunew);
    const bool done_new = done || fabsf(ustmix - ustold) < pce * ustmix;
    if (!done) {
      ust = ustmix;
      tauunr = tauunr_n;
    }
    if (!done_new) {
      tauold = ustmix * ustmix;
      ustold = ustmix;
    }
    done = done_new;
  }
  const float tauold1 = tauold;
  const float x1 = tauweff / tauold1;
  const bool fallback = !done && x1 >= pmax;
  const float ust_fb = utop * sqrtf(cdm(utop));
  const float z0minrst = ust_fb * ust_fb * P[P_ALPHAOG];
  if (fallback) {
    us = ust_fb;
    z0 = z0_of(ust_fb, z0minrst);
    z0b = z0minrst;
  } else {
    us = ust;
    z0 = z0_of(ust, z0min);
    z0b = z0 * sqrtf(tauunr / tauold1);
  }
  if (!(x1 < pmax)) {                          // no second stage
    const float um1 = 1.f / fmaxf(us, P[P_EPSUS]);
    chrnck = fmaxf(P[P_G] * (z0 - P[P_RNUM] * um1) * (um1 * um1),
                   P[P_ALPHAMIN]);
    ustar = us;
    return;
  }

  // second stage: Newton solve for z0 and the Charnock parameter
  const float tau0 = fmaxf(us * us, tauweff);
  const float alpog = fmaxf(fminf(z0b / tau0, P[P_ALPHAMAX]), alphaog);
  float ust2 = us, z02 = z0, z0b2 = z0b, xk = 0.f;
  ustold = us;
  tauold = tau0;
  done = false;
  for (int it = 0; it < NITER; ++it) {
    const float x = fminf(tauweff / tauold, pmax);
    const float ustm1 = 1.f / fmaxf(ustold, P[P_EPSUS]);
    const float z0vis = P[P_RNUM] * ustm1;
    const float h = 0.5f * z0vis / (1.f - x);
    const float z0b_n = alpog * tauold;
    const float z0_n = h + sqrtf(h * h + z0b_n * z0b_n / (1.f - x));
    const float xologz0 = 1.f / logf(P[P_XNLEV] / z0_n + 1.f);
    const float f = ustold - xkutop * xologz0;
    const float zz = 2.f * ustm1 * (3.f * (z0b_n * z0b_n)
        + 0.5f * z0vis * z0_n - z0_n * z0_n)
        / (2.f * (z0_n * z0_n) * (1.f - x) - z0vis * z0_n);
    const float delf = 1.f - xkutop * (xologz0 * xologz0) * zz;
    float ust_n = delf != 0.f ? ustold - f / delf : ustold;
    const float taunew = fmaxf(ust_n * ust_n, tauweff);
    ust_n = sqrtf(taunew);
    const bool done_new = done || fabsf(taunew - tauold) < pce * tauold;
    if (!done) {
      ust2 = ust_n;
      z02 = z0_n;
      z0b2 = z0b_n;
      xk = x;
    }
    if (!done_new) {
      tauold = taunew;
      ustold = ust_n;
    }
    done = done_new;
    if (done) break;                           // nothing changes after
  }
  if (done) {
    const float um1 = 1.f / fmaxf(ust2, P[P_EPSUS]);
    chrnck = fmaxf(P[P_G] * (z0b2 / sqrtf(1.f - xk)) * (um1 * um1),
                   P[P_ALPHAMIN]);
    ustar = ust2;
    z0 = z02;
    z0b = z0b2;
  } else {                                     // restore (taut_z0.F90:266)
    const float um1 = 1.f / fmaxf(us, P[P_EPSUS]);
    chrnck = fmaxf(P[P_G] * (z0 - P[P_RNUM] * um1) * (um1 * um1),
                   P[P_ALPHAMIN]);
    ustar = us;
  }
}

// swell friction factor, linear in log10(a_b/z0) (sinput_ard.F90:187-194)
__device__ float swellft_interp(const Tabs& T, float zorb) {
  const float* P = T.par;
  const float xi = (log10f(fmaxf(zorb, 3.f)) - P[P_ABMIN]) * P[P_DELABM1];
  const int ind = min(T.niab - 1, (int)xi);
  const float deli1 = fminf(1.f, xi - (float)ind);
  return T.swellft[ind - 1] * (1.f - deli1) + T.swellft[ind] * deli1;
}

// TRANSF shallow-water DIA enhancement (transf.F90:26-40)
__device__ float transf(const float* P, float xk, float depth) {
  const float x = xk * depth;
  const float xs = fminf(x, P[P_DKMAX]);
  const float t0 = tanhf(xs);
  const float om = sqrtf(P[P_G] * xk * t0);
  const float c0 = om / xk;
  const float vg = xs < 1.0e-4f
      ? c0 : 0.5f * c0 * (1.f + 2.f * xs / sinhf(2.f * xs));
  const float t2 = t0 * t0;
  const float a = t0 - xs * (1.f - t2);
  const float dvg = a * a + 4.f * (xs * xs) * t2 * (1.f - t2);
  const float xnl1 = (9.f * (t2 * t2) - 10.f * t2 + 9.f) / (8.f * (t2 * t0));
  const float b = 2.f * vg - 0.5f * c0;
  const float xnl2 = (b * b / (P[P_G] * depth - vg * vg) + 1.f) / xs;
  const float t4 = t2 * t2;
  const float d = xnl1 - xnl2;
  const float val = d * d / (dvg * (t4 * t4));
  const bool on = depth < P[P_BATHYMAX] && depth > 0.f && x <= P[P_DKMAX];
  return on ? val : 1.f;
}

// Per-row working set in shared memory: fl, fld, sl (nang rows of pitch
// nfp each), five per-frequency arrays, sx/sy (SNONLIN's factors enh over
// them once STRESSO is done), the three per-direction rows flm, cosw, sin2
// and dx (SNONLIN's two buffers of three transfer arrays over cosw, sin2
// and dx; in full mode, each in its own stage,
// also sp, the flux-source sums sumt/sumx/sumy and the windsea-mask words
// of the second FEMEANWS); in full mode, after them, the wide build's
// mask words (mask_at) and EXT's pre-SNONLIN flux sums (pre_at)
struct Work {
  float* fl; float* fld; float* sl;
  float* wav; float* cinv; float* xk2cg; float* tm; float* ws;
  float* sx; float* sy; float* enh;
  float* cosw; float* sin2; float* flm;
  float* dx; float* sp; float* sumt; float* sumx; float* sumy;
};

__host__ __device__ __forceinline__ int sxy_floats(int nfre, int mlsthg) {
  return 2 * nfre > mlsthg ? 2 * nfre : mlsthg;
}

__host__ __device__ __forceinline__ int dx_floats(int nang, int nfre,
                                                  bool full) {
  return full && nfre > nang ? 4 * nfre : 4 * nang;
}

// 32-bit mask words a direction (the wide build's shared mask)
__host__ __device__ __forceinline__ int mask_words(int nfre) {
  return (nfre + 31) >> 5;
}

// floats a row takes, rounded to whole bank rows (``pre``: the
// pre-SNONLIN flux sums of LWVFLX_SNL off)
__host__ __device__ __forceinline__ int row_floats(int nang, int nfre,
                                                   int mlsthg, bool full,
                                                   bool pre) {
  int n = 3 * nang * (nfre | 1) + 5 * nfre + sxy_floats(nfre, mlsthg)
      + 3 * nang + dx_floats(nang, nfre, full);
  if (full && WIDE) n += nang * mask_words(nfre);
  if (full && pre) n += 3 * nfre;
  return (n + 31) & ~31;
}

__device__ __forceinline__ Work work_at(float* w, const Tabs& T) {
  const int nfre = T.nfre, nb = T.nang * T.nfp;
  Work W;
  W.fl = w;
  W.fld = w + nb;
  W.sl = w + 2 * nb;
  W.wav = w + 3 * nb;
  W.cinv = W.wav + nfre;
  W.xk2cg = W.cinv + nfre;
  W.tm = W.xk2cg + nfre;
  W.ws = W.tm + nfre;
  W.sx = W.ws + nfre;
  W.sy = W.sx + nfre;
  W.enh = W.sx;
  W.flm = W.sx + sxy_floats(nfre, T.mlsthg);
  W.cosw = W.flm + T.nang;
  W.sin2 = W.cosw + T.nang;
  W.dx = W.sin2 + T.nang;
  W.sp = W.dx;                                 // FULL only, as are
  W.sumt = W.dx + nfre;                        // sumt, sumx and sumy
  W.sumx = W.sumt + nfre;
  W.sumy = W.sumx + nfre;
  return W;
}

// full mode only, the rest of the row (see row_floats), derived where it
// is used so that minimal mode keeps no pointer to it: the wide build's
// windsea-mask words (mask_words(nfre) a direction), then EXT's three
// pre-SNONLIN flux sums of nfre floats each
__device__ __forceinline__ unsigned* mask_at(const Work& W, const Tabs& T) {
  return reinterpret_cast<unsigned*>(W.dx + dx_floats(T.nang, T.nfre, true));
}

__device__ __forceinline__ float* pre_at(const Work& W, const Tabs& T) {
  return reinterpret_cast<float*>(
      mask_at(W, T) + (WIDE ? T.nang * mask_words(T.nfre) : 0));
}

// the windsea mask of the second SINPUT call, bit m of the lane's
// direction q (k): a register word in the default build, the row's
// shared words in the wide one
__device__ __forceinline__ void mask_clear(unsigned long long* xbits,
                                           const Work& W, const Tabs& T,
                                           int lane) {
  if constexpr (WIDE) {
    const int nwd = mask_words(T.nfre);
    unsigned* xw = mask_at(W, T);
    for (int k = lane; k < T.nang; k += RL)
      for (int w = 0; w < nwd; ++w) xw[k * nwd + w] = 0u;
  } else {
#pragma unroll
    for (int q = 0; q < KPL; ++q) xbits[q] = 0ull;
  }
}

__device__ __forceinline__ void mask_set(unsigned long long* xbits,
                                         const Work& W, const Tabs& T, int q,
                                         int k, int m) {
  if constexpr (WIDE)
    mask_at(W, T)[k * mask_words(T.nfre) + (m >> 5)] |= 1u << (m & 31);
  else
    xbits[q] |= 1ull << m;
}

// HALPHAP (halphap.F90:54-99): half the Phillips parameter of the
// downwind half of the spectrum; uses W.tm and W.ws as scratch
__device__ float halphap(const Tabs& T, const Work& W, int lane) {
  const float* P = T.par;
  const int nang = T.nang, nfre = T.nfre, nfp = T.nfp;
  for (int m = lane; m < nfre; m += RL) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < nang; ++k) {
      const float c = W.cosw[k];
      const float wd = 0.5f + 0.5f * (c > 0.f ? 1.f : (c < 0.f ? -1.f : 0.f));
      const float v = W.fl[k * nfp + m] * wd;
      s1 += v;
      s2 += fmaxf(v, P[P_EPSMIN]);
    }
    W.tm[m] = s1;
    W.ws[m] = s2;
  }
  __syncwarp();
  const float xmss = msum(nfre, lane, [&](int m) {
    return (T.dfim[m] * (W.wav[m] * W.wav[m])) * W.tm[m]; });
  const float em = msum(nfre, lane, [&](int m) { return T.dfim[m] * W.ws[m]; })
      + P[P_DELT25] * W.ws[nfre - 1];
  const float fs = msum(nfre, lane, [&](int m) {
    return T.dfimofr[m] * W.ws[m]; }) + P[P_DELT2] * W.ws[nfre - 1];
  const float fm = fmaxf(em / fs, T.fr[0]);
  const float tail = P[P_HALP_TAIL] * (W.tm[nfre - 1] * P[P_DELTH]);
  const float spec = xmss / fmaxf(P[P_LOGFR_LAST]
                                  - logf(fmaxf(fm, P[P_EPSMIN])),
                                  P[P_EPSMIN]);
  const bool ok = em > 0.f && fm < P[P_FR_NM3] && spec <= P[P_ALPHAPMAX];
  __syncwarp();
  return 0.5f * fminf(ok ? spec : tail, P[P_ALPHAPMAX]);
}

#ifdef IMPLSCH_WIDE
// The wide build's directions past the first group (sinput_ard and
// sinput_jan walk them one a lane): a gust's growth rate in direction
// (sk, ck) or at cos(θ − θ_wind) = cw, the expressions of the group's own
// loops; coslp (ARD) and whether the bin is active come back
__device__ __forceinline__ float ard_growth(float r2, float tx, float ty,
                                           float um1, float ucn,
                                           float ucnzalpd, float zcn,
                                           float cnsn, float sk, float ck,
                                           float& coslp, bool& active) {
  coslp = r2 > 0.f ? (sk * tx + ck * ty) * (um1 * um1) : ck;
  const float x = coslp * ucn;
  const float zlog = zcn + ucnzalpd / (coslp > 0.01f ? coslp : 1.f);
  active = coslp > 0.01f && zlog < 0.f;
  const float zlog2x = zlog * zlog * x;
  return active ? expf(zlog) * zlog2x * zlog2x * cnsn : 0.f;
}

__device__ __forceinline__ float jan_growth(const float* P, float ucn,
                                           float cw, float zcn, float cnsn,
                                           bool& active) {
  const float ucnd = 1.f / ucn;
  const bool lz = cw > 0.01f;
  const float zlog = zcn + P[P_XKAPPA] / (lz ? cw : 1.f) * ucnd;
  active = lz && zlog < 0.f;
  const float x = cw * ucn;
  const float zlog2x = zlog * zlog * x;
  return active ? zlog2x * zlog2x * expf(zlog) * cnsn : 0.f;
}
#endif

// SINPUT ARD (sinput_ard.F90:88-434) in SINFLX call 1 or 2 (``second``):
// per frequency
// ws = Σ_k xllws·F (FEMEANWS), sx/sy = Σ_k spos·sin/cos (STRESSO); the
// second call also forms the step's sources, fld = fm + d and sl = fm·F +
// d·F, with SDISSIP's rate d that fld holds (sdissip_ard).  The first
// call's gust is one, the second's two, side by side in one direction
// pass (each gust's sheltering scan is its own).  FULL's second call also
// keeps sp = Σ_k spos per frequency, the xllws bits of the lane's
// directions (bit m of xbits[q]) and phw = Σ (sl − spos)·ρwgΔfΔθ, the
// first term of PHIWA (stresso.F90:71-78).  OPTS adds LLNORMAGAM: the
// growth rate of each gust and frequency is normalised by its direction
// sums Σ gam0·F and Σ gam0·F·sin² (with cstrnfac = constn·rnfac/raorw)
template <bool FULL, bool OPTS>
__device__ __forceinline__ void sinput_ard(const Tabs& T, const Work& W, int lane,
                           bool second,
                           float wswave, float wdwave, float ufric,
                           float z0m, float raorw, float wstar, float rnfac,
                           unsigned long long* xbits, float& phw) {
  constexpr int NG = 2;                        // gusts, at most
  const int ng = second ? 2 : 1;
  const bool neg = second;                     // llsneg, the swell damping
  const bool fw = FULL && second;              // full mode's sums
  const float* P = T.par;
  const int nang = T.nang, nfre = T.nfre, nfp = T.nfp;
  const float avg = ng > 1 ? 0.5f : 1.f;
  const bool normagam = OPTS && (T.opts & OPT_LLNORMAGAM);
  const float cstrnfac = P[P_CONSTN] * rnfac / raorw;
  float ustp0[NG];
  if (ng > 1) {
    const float sig_n = wsigstar<OPTS>(P, T.opts, wswave, ufric, z0m, wstar);
    ustp0[0] = ufric * (1.f + sig_n);
    ustp0[1] = ufric * (1.f - sig_n);
  } else {
    ustp0[0] = ustp0[1] = ufric;
  }
  float pturb = 0.f, temp2 = 0.f, aird_pvisc = 0.f;
  if (neg) {
    colsum(W.fl, W.tm, nang, nfre, nfp, lane);
    const float uorbt = 2.f * sqrtf(P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
      return (T.dfim[m] * (T.zpifr[m] * T.zpifr[m])) * W.tm[m]; }));
    const float aorb = 2.f * sqrtf(P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
      return T.dfim[m] * W.tm[m]; }));
    const float re = P[P_RNU4] * uorbt * aorb;
    const float z0vis = P[P_RNUM] / fmaxf(ufric, 1.0e-4f);
    const float z0tub = P[P_Z0RAT] * fminf(P[P_Z0TUBMAX], z0m);
    const float zorb = aorb / fmaxf(z0vis, z0tub);
    temp2 = swellft_interp(T, zorb) * uorbt;
    const float smooth = 0.5f * tanhf((re - P[P_SWELLF4]) * P[P_SWELLF7M1]);
    pturb = 0.5f + smooth;
    aird_pvisc = (0.5f - smooth) * raorw;
  }
  const float tws = fabsf(P[P_TAUWSHELTER]);
  const float swd = sinf(wdwave), cwd = cosf(wdwave);
  float taux[NG], tauy[NG], xs[NG], ys[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g == ng) break;
    const float u2 = ustp0[g] * ustp0[g];
    taux[g] = u2 * swd;
    tauy[g] = u2 * cwd;
    xs[g] = ys[g] = 0.f;
  }
  const float rogoroair = P[P_G] / raorw;
  if (fw) {
    mask_clear(xbits, W, T, lane);
    phw = 0.f;
  }

  for (int m = 0; m < nfre; ++m) {
    const float zp = T.zpifr[m];
    const float zcn = logf(W.wav[m] * z0m);
    const float cnsn = (zp * P[P_CONST1]) * raorw;
    float dstab1 = 0.f, temp1 = 0.f;
    if (neg) {
      const float coef_v = P[P_SWF16] * (zp * zp) / P[P_G];
      const float coef5_v = P[P_SWF5_2] * sqrtf(P[P_TWO_NU] * zp);
      dstab1 = coef5_v * aird_pvisc * W.wav[m];
      temp1 = coef_v * raorw;
    }
    const float cim = W.cinv[m];
    const float constf = rogoroair * cim * T.dfim[m];
    // each gust's sheltered stress and friction velocity
    float tx[NG], ty[NG], r2[NG], ustp[NG], um1[NG], ucn[NG], ucnzalpd[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g == ng) break;
      tx[g] = taux[g] - tws * xs[g];
      ty[g] = tauy[g] - tws * ys[g];
      r2[g] = tx[g] * tx[g] + ty[g] * ty[g];
      ustp[g] = powf(r2[g], 0.25f);
      um1[g] = 1.f / fmaxf(ustp[g], P[P_EPSUS]);
      ucn[g] = ustp[g] * cim;
      ucnzalpd[g] = P[P_XKAPPA] / (ucn[g] + P[P_ZALP]);
    }
#ifdef IMPLSCH_WIDE
    float gnv[NG];                             // LLNORMAGAM's factors
#pragma unroll
    for (int g = 0; g < NG; ++g) gnv[g] = 1.f;
#endif
    float fldacc[KPL], sposacc[KPL], xll[KPL], px[NG], py[NG];
#pragma unroll
    for (int q = 0; q < KPL; ++q) fldacc[q] = sposacc[q] = xll[q] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) px[g] = py[g] = 0.f;
    if (!OPTS) {
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int k = lane + RL * q;
        if (k >= nang) continue;
        const float sk = T.sinth[k], ck = T.costh[k];
        const float f = W.fl[k * nfp + m];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (g == ng) break;
          const float coslp = r2[g] > 0.f
              ? (sk * tx[g] + ck * ty[g]) * (um1[g] * um1[g]) : ck;
          const float x = coslp * ucn[g];
          const float zlog = zcn + ucnzalpd[g] / (coslp > 0.01f ? coslp : 1.f);
          const bool active = coslp > 0.01f && zlog < 0.f;
          const float zlog2x = zlog * zlog * x;
          const float gam0 = active ? expf(zlog) * zlog2x * zlog2x * cnsn : 0.f;
          if (active) xll[q] = 1.f;
          const float dstab = neg
              ? dstab1 + pturb * (temp1 * (temp2 + (P[P_FU] + P[P_FUD] * coslp)
                                                      * ustp[g]))
              : 0.f;
          const float slp = gam0 * f;
          px[g] += slp * sk;
          py[g] += slp * ck;
          sposacc[q] += slp;
          fldacc[q] += gam0 + dstab;
        }
      }
    } else {
      // the growth rates first, then their normalisation, then the sums
      float gam[NG][KPL], cl[NG][KPL], s1[NG], s2[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) s1[g] = s2[g] = 0.f;
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int k = lane + RL * q;
#pragma unroll
        for (int g = 0; g < NG; ++g) gam[g][q] = cl[g][q] = 0.f;
        if (k >= nang) continue;
        const float sk = T.sinth[k], ck = T.costh[k];
        const float f = W.fl[k * nfp + m];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (g == ng) break;
          const float coslp = r2[g] > 0.f
              ? (sk * tx[g] + ck * ty[g]) * (um1[g] * um1[g]) : ck;
          const float x = coslp * ucn[g];
          const float zlog = zcn + ucnzalpd[g] / (coslp > 0.01f ? coslp : 1.f);
          const bool active = coslp > 0.01f && zlog < 0.f;
          const float zlog2x = zlog * zlog * x;
          gam[g][q] = active ? expf(zlog) * zlog2x * zlog2x * cnsn : 0.f;
          cl[g][q] = coslp;
          xll[q] = fmaxf(xll[q], active ? 1.f : 0.f);
          const float gf = gam[g][q] * f;
          s1[g] += gf;
          s2[g] += gf * W.sin2[k];
        }
      }
#ifdef IMPLSCH_WIDE
      // the sums' other directions
      if (normagam) {
        for (int k = lane + GRP; k < nang; k += RL) {
          const float f = W.fl[k * nfp + m];
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            if (g == ng) break;
            float coslp;
            bool active;
            const float gf = ard_growth(
                r2[g], tx[g], ty[g], um1[g], ucn[g], ucnzalpd[g], zcn,
                cnsn, T.sinth[k], T.costh[k], coslp, active) * f;
            s1[g] += gf;
            s2[g] += gf * W.sin2[k];
          }
        }
      }
#endif
      if (normagam) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (g == ng) break;
          const float sumf = row_sum(s1[g]), sumfsin2 = row_sum(s2[g]);
          const float znz = cstrnfac * W.xk2cg[m] * um1[g];
          const float gn = (1.f + znz * sumfsin2) / (1.f + znz * sumf);
#ifdef IMPLSCH_WIDE
          gnv[g] = gn;
#endif
#pragma unroll
          for (int q = 0; q < KPL; ++q) gam[g][q] = gam[g][q] * gn;
        }
      }
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int k = lane + RL * q;
        if (k >= nang) continue;
        const float sk = T.sinth[k], ck = T.costh[k];
        const float f = W.fl[k * nfp + m];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (g == ng) break;
          const float dstab = neg
              ? dstab1 + pturb * (temp1 * (temp2 + (P[P_FU] + P[P_FUD]
                                                    * cl[g][q]) * ustp[g]))
              : 0.f;
          const float slp = gam[g][q] * f;
          px[g] += slp * sk;
          py[g] += slp * ck;
          sposacc[q] += slp;
          fldacc[q] += gam[g][q] + dstab;
        }
      }
    }
#ifdef IMPLSCH_WIDE
    float wsp = 0.f, sxp = 0.f, syp = 0.f, spp = 0.f, dph = 0.f;
    // the directions past the first group, one a lane: growth, the
    // gusts' sums and the sources at once (the loops below do them for
    // the group)
    for (int k = lane + GRP; k < nang; k += RL) {
      const float sk = T.sinth[k], ck = T.costh[k];
      const int b = k * nfp + m;
      const float f = W.fl[b];
      float fa = 0.f, sa = 0.f, xl = 0.f;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (g == ng) break;
        float coslp;
        bool active;
        const float gam = ard_growth(r2[g], tx[g], ty[g], um1[g],
                                     ucn[g], ucnzalpd[g], zcn, cnsn, sk,
                                     ck, coslp, active)
            * (normagam ? gnv[g] : 1.f);
        if (active) xl = 1.f;
        const float dstab = neg
            ? dstab1 + pturb * (temp1 * (temp2 + (P[P_FU] + P[P_FUD] * coslp)
                                                    * ustp[g]))
            : 0.f;
        const float slp = gam * f;
        px[g] += slp * sk;
        py[g] += slp * ck;
        sa += slp;
        fa += gam + dstab;
      }
      const float fm = avg * fa;
      const float sp = avg * sa;
      if (neg) {
        const float d = W.fld[b];            // SDISSIP's rate
        W.fld[b] = fm + d;
        W.sl[b] = fmaf(d, f, fm * f);
      }
      wsp += xl * f;
      sxp += sp * sk;
      syp += sp * ck;
      if (fw) {
        spp += sp;
        dph += (fm * f - sp) * T.rhowg[m];
        if (xl != 0.f) mask_set(xbits, W, T, 0, k, m);
      }
    }
#endif
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g == ng) break;
      xs[g] = xs[g] + row_sum(px[g]) * constf;
      ys[g] = ys[g] + row_sum(py[g]) * constf;
    }
#ifndef IMPLSCH_WIDE
    float wsp = 0.f, sxp = 0.f, syp = 0.f, spp = 0.f, dph = 0.f;
#endif
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int k = lane + RL * q;
      if (k >= nang) continue;
      const int b = k * nfp + m;
      const float f = W.fl[b];
      const float fm = avg * fldacc[q];
      const float sp = avg * sposacc[q];
      if (neg) {
        const float d = W.fld[b];              // SDISSIP's rate
        W.fld[b] = fm + d;
        W.sl[b] = fmaf(d, f, fm * f);
      }
      wsp += xll[q] * f;
      sxp += sp * T.sinth[k];
      syp += sp * T.costh[k];
      if (fw) {
        spp += sp;
        dph += (fm * f - sp) * T.rhowg[m];
        if (xll[q] != 0.f) mask_set(xbits, W, T, q, k, m);
      }
    }
    wsp = row_sum(wsp);
    sxp = row_sum(sxp);
    syp = row_sum(syp);
    if (fw) {
      spp = row_sum(spp);
      phw += row_sum(dph);
    }
    if (lane == 0) {
      W.ws[m] = wsp;
      W.sx[m] = sxp;
      W.sy[m] = syp;
      if (fw) W.sp[m] = spp;
    }
  }
  __syncwarp();
}

// STRESSO + TAU_PHI_HF's stress integral (stresso.F90:63-160,
// tau_phi_hf.F90:73-255) in SINFLX call 1 or 2: the total wave stress and
// its direction.  FULL's second call also completes PHIWA: phiwa comes in
// as sinput_ard's phw and leaves with Σ ρwgΔfΔθ-to-the-cut · sp and the
// tail's energy flux PHIHF added.  OPTS adds LLGCBZ0 (the stress integral
// stops at the gc cut-off; no TAUW cap) and LLNORMAGAM (both integrals
// normalised as in SINPUT)
template <bool FULL, bool OPTS>
__device__ void stresso(const Tabs& T, const Work& W, int lane, bool second,
                        int mij,
                        float ufric, float z0m, float aird, float wdwave,
                        float rnfac, float& tauw, float& tauwdir,
                        float& phiwa) {
  const bool fw = FULL && second;
  const float* P = T.par;
  const int nang = T.nang, nfre = T.nfre, nfp = T.nfp;
  auto rhowgdfth = [&](int m) {
    if (m > mij) return 0.f;
    const float w = T.rhowg[m];
    return (m == mij && mij != nfre - 1) ? 0.5f * w : w;
  };
  float xst = msum(nfre, lane, [&](int m) {
    return rhowgdfth(m) * W.cinv[m] * W.sx[m]; });
  float yst = msum(nfre, lane, [&](int m) {
    return rhowgdfth(m) * W.cinv[m] * W.sy[m]; });
  const float af = fmaxf(aird, 1.f);
  if (fw)
    phiwa += msum(nfre, lane, [&](int m) { return rhowgdfth(m) * W.sp[m]; });
  xst = xst / af;
  yst = yst / af;
  const float u2 = ufric * ufric;
  const float taupx = u2 * sinf(wdwave) - P[P_TAUWSHELTER] * xst;
  const float taupy = u2 * cosf(wdwave) - P[P_TAUWSHELTER] * yst;
  const float usdirp = atan2f(taupx, taupy);
  const float ust = powf(taupx * taupx + taupy * taupy, 0.25f);

  // TAU_PHI_HF, sheltered stress integral (zsup = log 1 = 0)
  const float xloggz0 = logf(P[P_G] * z0m);
  const float omegacc = fmaxf(T.zpifr[mij], P[P_X0G] / ust);
  const float sqrtz0og = sqrtf(z0m * P[P_GM1]);
  const float sqrtgz0 = 1.f / sqrtz0og;
  const float zinf = logf(omegacc * sqrtz0og);
  const float consttau = P[P_ZPI4GM2] * T.fr5[mij];
  float part = 0.f, part2 = 0.f;
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int k = lane + RL * q;
    if (k >= nang) continue;
    const float cw = fmaxf(W.cosw[k], 0.f);
    const float fc2 = W.fl[k * nfp + mij] * (cw * cw);
    part += fc2 * cw;
    if (fw) part2 += fc2;
  }
#ifdef IMPLSCH_WIDE
  for (int k = lane + GRP; k < nang; k += RL) {
    const float cw = fmaxf(W.cosw[k], 0.f);
    const float fc2 = W.fl[k * nfp + mij] * (cw * cw);
    part += fc2 * cw;
    if (fw) part2 += fc2;
  }
#endif
  const float f1dcos3 = P[P_DELTH] * row_sum(part);
  const float delz_phi = fmaxf((0.f - zinf) / (float)(JTOT - 1), 0.f);
  float delz = delz_phi;
  if (OPTS && (T.opts & OPT_LLGCBZ0)) {
    const float oms = T.gcx[G_OMEGA * T.nwav + ns_gc(T, ufric)];
    const float zsup = fminf(logf(oms * sqrtz0og), 0.f);
    delz = fmaxf((zsup - zinf) / (float)(JTOT - 1), 0.f);
  }
  // LLNORMAGAM: gamnorma = (1 + c1·znz)/(1 + c2·znz), znz = zbeta·u*·y
  float c1 = 0.f, c2 = 0.f;
  const bool normagam = OPTS && (T.opts & OPT_LLNORMAGAM);
  if (normagam) {
    float ps = 0.f, pt = 0.f;
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int k = lane + RL * q;
      if (k >= nang) continue;
      const float f = W.fl[k * nfp + mij];
      ps += f * W.sin2[k];
      pt += f;
    }
#ifdef IMPLSCH_WIDE
    for (int k = lane + GRP; k < nang; k += RL) {
      const float f = W.fl[k * nfp + mij];
      ps += f * W.sin2[k];
      pt += f;
    }
#endif
    const float confg = P[P_GAMNCONST] * T.fr5[mij] * rnfac * sqrtgz0;
    c1 = confg * (P[P_DELTH] * row_sum(ps));
    c2 = confg * (P[P_DELTH] * row_sum(pt));
  }
  float taul = ust * ust, ustc = ust, tauhf = 0.f;
  for (int j = 0; j < JTOT; ++j) {
    const float y = expf(zinf + (float)j * delz);
    const float cm1 = y * sqrtgz0 * P[P_GM1];
    const float zx = ustc * cm1 + P[P_ZALP];
    const float zlog = fminf(xloggz0 + 2.f * logf(cm1) + P[P_XKAPPA] / zx,
                             0.f);
    const float z2 = zlog * zlog;
    const float zbeta = z2 * z2 * expf(zlog);
    float fnc2 = f1dcos3 * consttau * zbeta * taul * T.wtauhf[j] * delz;
    if (normagam) {
      const float znz = zbeta * ustc * y;
      fnc2 = fnc2 * ((1.f + c1 * znz) / (1.f + c2 * znz));
    }
    taul = fmaxf(taul - P[P_TAUWSHELTER] * fnc2, 0.f);
    ustc = sqrtf(taul);
    tauhf += fnc2;
  }
  if (fw) {
    // PHIHF: the full range up to log 1 = 0, afresh from the sheltered u*
    // (tau_phi_hf.F90:200-254)
    const float f1dcos2 = P[P_DELTH] * row_sum(part2);
    float taup = ust * ust, ustph = ust, acc = 0.f;
    for (int j = 0; j < JTOT; ++j) {
      const float y = expf(zinf + (float)j * delz_phi);
      const float cm1 = y * sqrtgz0 * P[P_GM1];
      const float zx = ustph * cm1 + P[P_ZALP];
      const float zlog = fminf(xloggz0 + 2.f * logf(cm1) + P[P_XKAPPA] / zx,
                               0.f);
      const float z2 = zlog * zlog;
      const float zbeta = z2 * z2 * expf(zlog);
      float fnc2 = zbeta * taup * T.wtauhf[j] * delz_phi;
      if (normagam) {
        const float znz = zbeta * ustc * y;
        fnc2 = fnc2 * ((1.f + c1 * znz) / (1.f + c2 * znz));
      }
      taup = fmaxf(taup - P[P_TAUWSHELTER] * f1dcos3 * consttau * fnc2, 0.f);
      ustph = sqrtf(taup);
      acc += fnc2 / y;
    }
    phiwa += f1dcos2 * (aird * P[P_ZPI4GM1] * T.fr5[mij]) * sqrtz0og * acc;
  }
  xst = xst + tauhf * sinf(usdirp);
  yst = yst + tauhf * cosf(usdirp);
  tauw = sqrtf(xst * xst + yst * yst);
  if (!(OPTS && (T.opts & OPT_LLGCBZ0))) tauw = fminf(tauw, u2 / P[P_EPS1P]);
  tauwdir = atan2f(xst, yst);
}

// SDISSIP ARD (sdissip_ard.F90:70-256), run between the two SINFLX calls:
// the spectrum the dissipation reads is final after the first call's tail
// floor, and the first call's source arrays are dead.  The saturation
// B(k, m) = facsat(m)·Σ_j W(k, j)·F(j, m) is summed once per bin over W's
// band j = k−NSDSNTH..k+NSDSNTH (the other entries are 0), bins over the
// lanes, into sl; then its maximum over the directions per frequency,
// and the rate d of each bin into fld, which the second call's SINPUT
// adds to its own terms
__device__ void sdissip_ard(const Tabs& T, const Work& W, int lane) {
  const float* P = T.par;
  const int nang = T.nang, nfre = T.nfre, nfp = T.nfp;
  const int ns = (int)P[P_NSDSNTH];
  for (int m = lane; m < nfre; m += RL)
    W.tm[m] = W.wav[m] * P[P_TPIINV] * W.xk2cg[m];
  __syncwarp();
  for_bins(T, [&](int b, int k, int m) {
    const float* wk = T.wmat + k * nang;
    int j = k - ns < 0 ? k - ns + nang : k - ns;
    float acc = 0.f;
    for (int o = -ns; o <= ns; ++o) {
      acc += wk[j] * W.fl[j * nfp + m];
      j = j + 1 == nang ? 0 : j + 1;
    }
    W.sl[b] = acc * W.tm[m];
  });
  __syncwarp();
  for (int m = lane; m < nfre; m += RL) {
    float bth0 = -INFINITY;
    for (int k = 0; k < nang; ++k) bth0 = fmaxf(bth0, W.sl[k * nfp + m]);
    const float zc2 = P[P_SSDSC2] * T.zpifr[m];
    const float t0 = fmaxf(0.f, bth0 * P[P_TMP03] - P[P_SSDSC4]);
    W.tm[m] = zc2 * P[P_SSDSC6] * (t0 * t0);
  }
  __syncwarp();
  for_bins(T, [&](int b, int k, int m) {
    const float zc2 = P[P_SSDSC2] * T.zpifr[m];
    const float t = fmaxf(0.f, W.sl[b] * P[P_TMP03] - P[P_SSDSC4]);
    const float d0 = W.tm[m];
    W.fld[b] = d0 + zc2 * P[P_ONE_M_SSDSC6] * (t * t);
  });
  __syncwarp();
}

// TRANSF_SNL (transf_snl.F90:30-85): TRANSF with the spread dependence
// of PEAK_ANG's ν and σθ, clipped to [0.1, 10]
__device__ float transf_snl(const float* P, float xk0, float depth,
                            float xnu, float sig_th) {
  const float x0 = xk0 * depth;
  const float xk = fmaxf(xk0, P[P_XKDMIN] / depth);
  const float x = fminf(xk * depth, P[P_DKMAX]);
  const float t0 = tanhf(x);
  const float t0sq = t0 * t0;
  const float om = sqrtf(P[P_G] * xk * t0);
  const float c0 = om / xk;
  const float cs_sq = P[P_G] * depth;
  const float vg = x < 1.0e-4f
      ? c0 : 0.5f * c0 * (1.f + 2.f * x / sinhf(2.f * x));
  const float vg_sq = vg * vg;
  const float a = t0 - x * (1.f - t0sq);
  const float dvg = a * a + 4.f * (x * x) * t0sq * (1.f - t0sq);
  const float xnl1 = (9.f * (t0sq * t0sq) - 10.f * t0sq + 9.f)
      / (8.f * t0sq * t0);
  const float b = 2.f * vg - 0.5f * c0;
  const float xnl2 = (b * b / (cs_sq - vg_sq) + 1.f) / x;
  const float e = 2.f * c0 + vg * (1.f - t0sq);
  const float xnl4 = 1.f / (4.f * t0) * (e * e) / (cs_sq - vg_sq);
  const float alp = (1.f - vg_sq / cs_sq) * (c0 * c0) / vg_sq;
  const float s2 = sig_th * sig_th;
  const float zfac = s2 / (s2 + alp * (xnu * xnu));
  const float xnl = xnl1 - xnl2 + zfac * xnl4;
  const float t4 = t0sq * t0sq;
  const float val = fminf(fmaxf(xnl * xnl / (dvg * (t4 * t4)), 0.1f), 10.f);
  const bool on = depth < P[P_BATHYMAX] && depth > 0.f && x0 <= P[P_DKMAX];
  return on ? val : 1.f;
}

// The DIA step records, one a step j (MC) of DIA_REC floats, 16-byte
// aligned (implsch_cuda.DIA_RECORD): the tap stage's part first, TAP_REC
// floats (the weights rnl 0-4 and 13-16, af11, and the tap frequencies
// ic, ip, ip1, im, im1 as int bits), then the scatter's (the weights rnl
// 5-12 and 17-24, and the targets ikm, ikm1, ikp, ikp1, Fortran's 1-based
// indices, as int bits).  Every lane reads the same record, so each part
// comes in float4 broadcasts: 4 loads and 5, not 36 scalar ones
constexpr int TAP_REC = 16, DIA_REC = 36;

struct DiaTap {
  float w0, w1, w2, w3, w4, w13, w14, w15, w16, af11;
  int ic, ip, ip1, im, im1;
};

struct DiaScatter {
  float w5, w6, w7, w8, w9, w10, w11, w12;
  float w17, w18, w19, w20, w21, w22, w23, w24;
  int ikm, ikm1, ikp, ikp1;
};

__device__ __forceinline__ DiaTap dia_tap(const float* dia, int j) {
  const float4* r = reinterpret_cast<const float4*>(dia + j * DIA_REC);
  const float4 a = r[0], b = r[1], c = r[2], d = r[3];
  return DiaTap{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y,
                __float_as_int(c.z), __float_as_int(c.w), __float_as_int(d.x),
                __float_as_int(d.y), __float_as_int(d.z)};
}

__device__ __forceinline__ DiaScatter dia_scatter(const float* dia, int j) {
  const float4* r = reinterpret_cast<const float4*>(
      dia + j * DIA_REC + TAP_REC);
  const float4 a = r[0], b = r[1], c = r[2], d = r[3], e = r[4];
  return DiaScatter{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                    c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w,
                    __float_as_int(e.x), __float_as_int(e.y),
                    __float_as_int(e.z), __float_as_int(e.w)};
}

// one direction's four transfer terms of a step: fl's taps at the
// direction's own row (offset rk) and at the rows k + s (q1, q11, q2, q21)
struct DiaTerms {
  float ad, delad, delap, delam;
};

__device__ __forceinline__ DiaTerms dia_terms(const DiaTap& t,
                                              const float* fl, int rk,
                                              int q1, int q11, int q2,
                                              int q21, float ftemp,
                                              float dal1, float dal2) {
  const float sap = t.w1 * fl[q1 + t.ip] + t.w2 * fl[q11 + t.ip]
      + t.w3 * fl[q1 + t.ip1] + t.w4 * fl[q11 + t.ip1];
  const float sam = t.w13 * fl[q2 + t.im] + t.w14 * fl[q21 + t.im]
      + t.w15 * fl[q2 + t.im1] + t.w16 * fl[q21 + t.im1];
  const float fij = fl[rk + t.ic] * t.w0;
  float fad1 = fij * (sap + sam);
  const float fad2 = fad1 - 2.f * sap * sam;
  fad1 = fad1 + fad2;
  const float fcen = ftemp * fij;
  return DiaTerms{fad2 * fcen, fad1 * ftemp, (fij - 2.f * sam) * dal1 * fcen,
                  (fij - 2.f * sap) * dal2 * fcen};
}

// SNONLIN DIA with the TRANSF enhancement (snonlin.F90:70-470); EXT adds
// ISNONLIN=0 (one factor ``enhfr`` for every MC) and ISNONLIN=2
// (TRANSF_SNL with PEAK_ANG's ``xnu`` and ``sig_th``).  Per KH the lane's
// directions' tap directions k + s and k − s are wrapped once.  Per step
// j each lane adds the transfer terms into its own directions' target
// bins: one writer per bin, steps in order, KH 0 then 1, bit-reproducible.
// The steps run as a two-stage pipeline, one __syncwarp a step: between
// two of them a lane does step j's scatter, which reads the terms of the
// shifted directions from one buffer (ad, delap, delam; its own ad and
// delad from its registers), then step j + 1's taps, which read only fl
// (constant here) and go into the other buffer; the buffers are the
// row's dx and its cosw/sin2 rows (row_step puts cosw back afterwards;
// sin2 is dead).  Of a step's five targets
// (own, ikm, ikm1, ikp, ikp1) ikm1 and ikp1 are the next step's ikm and
// ikp (pack_tables checks), so those two bins stay in registers from one
// step to the next: three old values of sl and of fld are read a step
// and three written.  The wide build's directions past GRP take the same
// pipeline but write every target each step, their delad taken again
template <bool EXT>
__device__ void snonlin(const Tabs& T, const Work& W, int lane, float depth,
                        float enhfr, float xnu, float sig_th) {
  const float* P = T.par;
  const int nang = T.nang, nfre = T.nfre, nfp = T.nfp, ml = T.mlsthg;
  for (int mc = lane; mc < ml; mc += RL) {
    const float xk = mc < nfre ? W.wav[mc] : T.xk_ext[mc - nfre];
    if (EXT && (T.opts & OPT_ISNONLIN0))
      W.enh[mc] = enhfr;
    else if (EXT && (T.opts & OPT_ISNONLIN2))
      W.enh[mc] = transf_snl(P, xk, depth, xnu, sig_th);
    else
      W.enh[mc] = fminf(fmaxf(transf(P, xk, depth), P[P_ENH_MIN]),
                        P[P_ENH_MAX]);
  }
  __syncwarp();
  const float dal1 = P[P_DAL1], dal2 = P[P_DAL2];
  const float* fl = W.fl;
  // buffer b of the terms: ad, delap, delam (nang each) from W.dx + nang
  // − 3·nang·b; buffer 1 lies over cosw, sin2 and dx's first nang
  auto buf = [&](int b) { return W.dx + nang - 3 * nang * b; };
  for (int kh = 0; kh < 2; ++kh) {
    const int s1 = T.shifts[4 * kh], s11 = T.shifts[4 * kh + 1];
    const int s2 = T.shifts[4 * kh + 2], s21 = T.shifts[4 * kh + 3];
    // rows of fl at k + s, and the directions k − s (shifts in [0, nang));
    // a lane's slot q past nang works on direction nang − 1 and writes
    // nothing
    int r1[KPL], r11[KPL], r2[KPL], r21[KPL];
    int u1[KPL], u11[KPL], u2[KPL], u21[KPL];
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int k = min(lane + RL * q, nang - 1);
      r1[q] = wrap(k + s1, nang) * nfp;
      r11[q] = wrap(k + s11, nang) * nfp;
      r2[q] = wrap(k + s2, nang) * nfp;
      r21[q] = wrap(k + s21, nang) * nfp;
      u1[q] = wrap(k - s1 + nang, nang);
      u11[q] = wrap(k - s11 + nang, nang);
      u2[q] = wrap(k - s2 + nang, nang);
      u21[q] = wrap(k - s21 + nang, nang);
    }
    // a step's terms of the lane's directions, stored into buffer
    // (step & 1) for the shifted directions; the lane's own ad and delad
    // stay here for the step's scatter
    DiaTerms dt[KPL];
    auto taps = [&](int j) {
      const DiaTap t = dia_tap(T.dia, j);
      const float ftemp = t.af11 * W.enh[j];
#pragma unroll
      for (int q = 0; q < KPL; ++q)
        dt[q] = dia_terms(t, fl, min(lane + RL * q, nang - 1) * nfp, r1[q],
                          r11[q], r2[q], r21[q], ftemp, dal1, dal2);
    };
    auto put_taps = [&](int j, int p) {
      float* b = buf(p);
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int k = lane + RL * q;
        if (k < nang) {
          b[k] = dt[q].ad;
          b[nang + k] = dt[q].delap;
          b[2 * nang + k] = dt[q].delam;
        }
      }
#ifdef IMPLSCH_WIDE
      // the directions past the first group, their rows of fl at k + s
      // found here (the same expressions as the group's)
      if (GRP < nang) {
        const DiaTap t = dia_tap(T.dia, j);
        const float ftemp = t.af11 * W.enh[j];
        for (int k = lane + GRP; k < nang; k += RL) {
          const DiaTerms d = dia_terms(
              t, fl, k * nfp, wrap(k + s1, nang) * nfp,
              wrap(k + s11, nang) * nfp, wrap(k + s2, nang) * nfp,
              wrap(k + s21, nang) * nfp, ftemp, dal1, dal2);
          b[k] = d.ad;
          b[nang + k] = d.delap;
          b[2 * nang + k] = d.delam;
        }
      }
#endif
    };
    // sl and fld of the targets ikm and ikp carried into the next step
    float cs[KPL][2], cf[KPL][2];
    taps(0);
    put_taps(0, 0);
    {
      const DiaScatter s = dia_scatter(T.dia, 0);
      const int tm = s.ikm - 1, tp = s.ikp - 1;
      const bool cm = tm >= 0 && tm < nfre, cp = tp >= 0 && tp < nfre;
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int kk = min(lane + RL * q, nang - 1);
        cs[q][0] = cm ? W.sl[kk * nfp + tm] : 0.f;
        cf[q][0] = cm ? W.fld[kk * nfp + tm] : 0.f;
        cs[q][1] = cp ? W.sl[kk * nfp + tp] : 0.f;
        cf[q][1] = cp ? W.fld[kk * nfp + tp] : 0.f;
      }
    }
    __syncwarp();
    int lm1 = -1, lp1 = -1;                    // the last step's carried
    for (int j = 0; j < ml; ++j) {
      const float* ad = buf(j & 1);
      const float* delap = ad + nang;
      const float* delam = ad + 2 * nang;
      // the step's target frequencies: its own (inside the ladder) and the
      // four of ikm, ikm1, ikp, ikp1 inside it, distinct (pack_tables
      // checks)
      const DiaScatter s = dia_scatter(T.dia, j);
      const int tm = s.ikm - 1, tm1 = s.ikm1 - 1;
      const int tp = s.ikp - 1, tp1 = s.ikp1 - 1;
      const bool c0 = j < nfre, cm = tm >= 0 && tm < nfre;
      const bool cm1 = tm1 >= 0 && tm1 < nfre, cp = tp >= 0 && tp < nfre;
      const bool cp1 = tp1 >= 0 && tp1 < nfre;
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int k = lane + RL * q;
        const bool put = k < nang;
        float* slk = W.sl + min(k, nang - 1) * nfp;
        float* fldk = W.fld + min(k, nang - 1) * nfp;
        // the old values of the targets not carried, and the terms of
        // the shifted directions, all read before any is written
        const float os0 = c0 ? slk[j] : 0.f, of0 = c0 ? fldk[j] : 0.f;
        const float os1 = cm1 ? slk[tm1] : 0.f;
        const float of1 = cm1 ? fldk[tm1] : 0.f;
        const float os2 = cp1 ? slk[tp1] : 0.f;
        const float of2 = cp1 ? fldk[tp1] : 0.f;
        const float a0 = ad[u2[q]], a1 = ad[u21[q]];
        const float a2 = delam[u2[q]], a3 = delam[u21[q]];
        const float a4 = ad[u1[q]], a5 = ad[u11[q]];
        const float a6 = delap[u1[q]], a7 = delap[u11[q]];
        if (put && c0) {
          slk[j] = os0 + -2.f * dt[q].ad;
          fldk[j] = of0 + -2.f * dt[q].delad;
        }
        if (put && cm) {
          slk[tm] = cs[q][0] + (s.w20 * a0 + s.w19 * a1);
          fldk[tm] = cf[q][0] + (s.w23 * a2 + s.w24 * a3);
        }
        if (put && cp) {
          slk[tp] = cs[q][1] + (s.w8 * a4 + s.w7 * a5);
          fldk[tp] = cf[q][1] + (s.w11 * a6 + s.w12 * a7);
        }
        cs[q][0] = os1 + (s.w17 * a0 + s.w18 * a1);
        cf[q][0] = of1 + (s.w21 * a2 + s.w22 * a3);
        cs[q][1] = os2 + (s.w5 * a4 + s.w6 * a5);
        cf[q][1] = of2 + (s.w9 * a6 + s.w10 * a7);
      }
      lm1 = cm1 ? tm1 : -1;
      lp1 = cp1 ? tp1 : -1;
      // step j + 1's terms into the other buffer (at the last step its
      // own again, into the buffer no step reads any more): fl is
      // constant through SNONLIN
      taps(min(j + 1, ml - 1));
      put_taps(min(j + 1, ml - 1), (j + 1) & 1);
#ifdef IMPLSCH_WIDE
      // the directions past the first group: every target read and
      // written here, the directions k − s found here, delad taken again
      // from step j's taps (the same expression, so the same value)
      if (GRP < nang) {
        const DiaTap t = dia_tap(T.dia, j);
        const float ftemp = t.af11 * W.enh[j];
        for (int k = lane + GRP; k < nang; k += RL) {
          const int v1 = wrap(k - s1 + nang, nang);
          const int v11 = wrap(k - s11 + nang, nang);
          const int v2 = wrap(k - s2 + nang, nang);
          const int v21 = wrap(k - s21 + nang, nang);
          const float dl = dia_terms(
              t, fl, k * nfp, wrap(k + s1, nang) * nfp,
              wrap(k + s11, nang) * nfp, wrap(k + s2, nang) * nfp,
              wrap(k + s21, nang) * nfp, ftemp, dal1, dal2).delad;
          float* slk = W.sl + k * nfp;
          float* fldk = W.fld + k * nfp;
          float gs[5], gf[5], ga[10];
          gs[0] = c0 ? slk[j] : 0.f;
          gf[0] = c0 ? fldk[j] : 0.f;
          gs[1] = cm ? slk[tm] : 0.f;
          gf[1] = cm ? fldk[tm] : 0.f;
          gs[2] = cm1 ? slk[tm1] : 0.f;
          gf[2] = cm1 ? fldk[tm1] : 0.f;
          gs[3] = cp ? slk[tp] : 0.f;
          gf[3] = cp ? fldk[tp] : 0.f;
          gs[4] = cp1 ? slk[tp1] : 0.f;
          gf[4] = cp1 ? fldk[tp1] : 0.f;
          ga[0] = ad[k];
          ga[1] = dl;
          ga[2] = ad[v2];
          ga[3] = ad[v21];
          ga[4] = delam[v2];
          ga[5] = delam[v21];
          ga[6] = ad[v1];
          ga[7] = ad[v11];
          ga[8] = delap[v1];
          ga[9] = delap[v11];
          if (c0) {
            slk[j] = gs[0] + -2.f * ga[0];
            fldk[j] = gf[0] + -2.f * ga[1];
          }
          if (cm) {
            slk[tm] = gs[1] + (s.w20 * ga[2] + s.w19 * ga[3]);
            fldk[tm] = gf[1] + (s.w23 * ga[4] + s.w24 * ga[5]);
          }
          if (cm1) {
            slk[tm1] = gs[2] + (s.w17 * ga[2] + s.w18 * ga[3]);
            fldk[tm1] = gf[2] + (s.w21 * ga[4] + s.w22 * ga[5]);
          }
          if (cp) {
            slk[tp] = gs[3] + (s.w8 * ga[6] + s.w7 * ga[7]);
            fldk[tp] = gf[3] + (s.w11 * ga[8] + s.w12 * ga[9]);
          }
          if (cp1) {
            slk[tp1] = gs[4] + (s.w5 * ga[6] + s.w6 * ga[7]);
            fldk[tp1] = gf[4] + (s.w9 * ga[8] + s.w10 * ga[9]);
          }
        }
      }
#endif
      __syncwarp();
    }
    // the last step's ikm1 and ikp1 bins, carried out of the loop
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int k = lane + RL * q;
      if (k >= nang) continue;
      if (lm1 >= 0) {
        W.sl[k * nfp + lm1] = cs[q][0];
        W.fld[k * nfp + lm1] = cf[q][0];
      }
      if (lp1 >= 0) {
        W.sl[k * nfp + lp1] = cs[q][1];
        W.fld[k * nfp + lp1] = cf[q][1];
      }
    }
  }
  __syncwarp();
}

// SINPUT_JAN (sinput_jan.F90:84-280), Janssen's quasi-linear input of WAM
// cycle 4 (iphys=0) in SINFLX call 1 or 2: frequency-parallel, no
// sheltering, gusts ordered (1 − σ, 1 + σ).  The same outputs as
// sinput_ard (the second call's fld and sl are the input's alone: the
// cycle-4 dissipation comes after both calls), and in FULL's second call
// sp, the mask bits and phw.  OPTS adds LLNORMAGAM as in sinput_ard
template <bool FULL, bool OPTS>
__device__ __forceinline__ void sinput_jan(const Tabs& T, const Work& W, int lane,
                           bool second,
                           float wswave, float ufric, float z0m, float raorw,
                           float wstar, float rnfac,
                           unsigned long long* xbits, float& phw) {
  constexpr int NG = 2;
  const int ng = second ? 2 : 1;
  const bool neg = second;
  const bool fw = FULL && second;
  const float* P = T.par;
  const int nang = T.nang, nfre = T.nfre, nfp = T.nfp;
  const bool normagam = OPTS && (T.opts & OPT_LLNORMAGAM);
  const float cstrnfac = P[P_CONSTN] * rnfac / raorw;
  float us[NG], wsin = 1.f;
  if (ng > 1) {
    const float sig_n = wsigstar<OPTS>(P, T.opts, wswave, ufric, z0m, wstar);
    us[0] = ufric * (1.f - sig_n);
    us[1] = ufric * (1.f + sig_n);
    wsin = 0.5f;
  } else {
    us[0] = us[1] = ufric;
  }
  if (fw) {
    mask_clear(xbits, W, T, lane);
    phw = 0.f;
  }
  for (int m = 0; m < nfre; ++m) {
    const float zp = T.zpifr[m], wav = W.wav[m], cim = W.cinv[m];
    const float cnsn = (zp * P[P_CONST1]) * ((zp * zp) / (P[P_G] * wav))
        * raorw;
    const float zcn = logf(wav * z0m);
#ifdef IMPLSCH_WIDE
    float gnv[NG];                             // LLNORMAGAM's factors
#pragma unroll
    for (int g = 0; g < NG; ++g) gnv[g] = 1.f;
#endif
    float u1[KPL], u2[KPL], xll[KPL];
#pragma unroll
    for (int q = 0; q < KPL; ++q) u1[q] = u2[q] = xll[q] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g == ng) break;
      const float ucn = us[g] * cim + P[P_ZALP];
      const float ucnd = 1.f / ucn;
      float gam[KPL];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int k = lane + RL * q;
        gam[q] = 0.f;
        if (k >= nang) continue;
        const float cw = W.cosw[k];
        const bool lz = cw > 0.01f;
        const float zlog = zcn + P[P_XKAPPA] / (lz ? cw : 1.f) * ucnd;
        const bool active = lz && zlog < 0.f;
        const float x = cw * ucn;
        const float zlog2x = zlog * zlog * x;
        gam[q] = active ? zlog2x * zlog2x * expf(zlog) * cnsn : 0.f;
        xll[q] = fmaxf(xll[q], active ? 1.f : 0.f);
        if (normagam) {
          const float gf = gam[q] * W.fl[k * nfp + m];
          s1 += gf;
          s2 += gf * W.sin2[k];
        }
      }
#ifdef IMPLSCH_WIDE
      // the sums' other directions
      if (normagam) {
        for (int k = lane + GRP; k < nang; k += RL) {
          bool active;
          const float gf = jan_growth(P, us[g] * cim + P[P_ZALP],
                                      W.cosw[k], zcn, cnsn, active)
              * W.fl[k * nfp + m];
          s1 += gf;
          s2 += gf * W.sin2[k];
        }
      }
#endif
      if (normagam) {
        const float sumf = row_sum(s1), sumfsin2 = row_sum(s2);
        const float znz = cstrnfac * W.xk2cg[m]
            * (1.f / fmaxf(us[g], P[P_EPSUS]));
        const float gn = (1.f + znz * sumfsin2) / (1.f + znz * sumf);
#ifdef IMPLSCH_WIDE
        gnv[g] = gn;
#endif
#pragma unroll
        for (int q = 0; q < KPL; ++q) gam[q] = gam[q] * gn;
      }
      const float c3u2 = P[P_CONST3] * (ucn * ucn);
      const float xvd = 1.f / (-us[g] * P[P_XKAPPAD] * zcn * cim);
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int k = lane + RL * q;
        if (k >= nang) continue;
        u1[q] += wsin * gam[q];
        if (neg) u2[q] += wsin * (c3u2 * (W.cosw[k] - xvd));
      }
    }
    float wsp = 0.f, sxp = 0.f, syp = 0.f, spp = 0.f, dph = 0.f;
#ifdef IMPLSCH_WIDE
    // the directions past the first group, one a lane: both gusts'
    // rates and the sources at once (the loops above and below do them
    // for the group)
    for (int k = lane + GRP; k < nang; k += RL) {
      float v1 = 0.f, v2 = 0.f, xl = 0.f;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (g == ng) break;
        const float ucn = us[g] * cim + P[P_ZALP];
        bool active;
        const float gam = jan_growth(P, ucn, W.cosw[k], zcn, cnsn, active)
            * (normagam ? gnv[g] : 1.f);
        xl = fmaxf(xl, active ? 1.f : 0.f);
        const float c3u2 = P[P_CONST3] * (ucn * ucn);
        const float xvd = 1.f / (-us[g] * P[P_XKAPPAD] * zcn * cim);
        v1 += wsin * gam;
        if (neg) v2 += wsin * (c3u2 * (W.cosw[k] - xvd));
      }
      const int b = k * nfp + m;
      const float f = W.fl[b];
      const float fm = v1 + v2 * cnsn;
      const float sp = v1 * f;
      if (neg) {
        W.fld[b] = fm;
        W.sl[b] = fm * f;
      }
      wsp += xl * f;
      sxp += sp * T.sinth[k];
      syp += sp * T.costh[k];
      if (fw) {
        spp += sp;
        dph += (fm * f - sp) * T.rhowg[m];
        if (xl != 0.f) mask_set(xbits, W, T, 0, k, m);
      }
    }
#endif
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int k = lane + RL * q;
      if (k >= nang) continue;
      const int b = k * nfp + m;
      const float f = W.fl[b];
      const float fm = u1[q] + u2[q] * cnsn;
      const float sp = u1[q] * f;
      if (neg) {
        W.fld[b] = fm;
        W.sl[b] = fm * f;
      }
      wsp += xll[q] * f;
      sxp += sp * T.sinth[k];
      syp += sp * T.costh[k];
      if (fw) {
        spp += sp;
        dph += (fm * f - sp) * T.rhowg[m];
        if (xll[q] != 0.f) mask_set(xbits, W, T, q, k, m);
      }
    }
    wsp = row_sum(wsp);
    sxp = row_sum(sxp);
    syp = row_sum(syp);
    if (fw) {
      spp = row_sum(spp);
      phw += row_sum(dph);
    }
    if (lane == 0) {
      W.ws[m] = wsp;
      W.sx[m] = sxp;
      W.sy[m] = syp;
      if (fw) W.sp[m] = spp;
    }
  }
  __syncwarp();
}

// SDISSIP_JAN (sdissip_jan.F90:50-120), the cycle-4 dissipation from the
// first FKMEAN's mean parameters, per bin
__device__ void sdissip_jan(const Tabs& T, const Work& W, float emean,
                            float f1mean, float xkmean) {
  const float* P = T.par;
  const float xk2 = xkmean * xkmean;
  const float sds = P[P_CONSS] * f1mean * (emean * emean) * (xk2 * xk2);
  const float dsd = P[P_DELTA_SDIS];
  for_bins(T, [&](int b, int k, int m) {
    const float wav = W.wav[m];
    const float x = wav / xkmean;
    const float t = sds * x * ((1.f - dsd) + dsd * x)
        + P[P_CVIS] * (wav * wav);
    W.fld[b] += t;
    W.sl[b] += t * W.fl[b];
  });
  __syncwarp();
}

// PEAK_ANG (peak_ang.F90:60-160): the frequency spread ν and directional
// spread σθ at the peak, for TRANSF_SNL; W.tm and W.ws as scratch.  The
// peak is the lowest-index maximum over (k, m = 1..nfre−2); the window's
// THMEAN update is sequential in m, each step closed by row sums (the two
// rows of a warp walk windows of the same length, the steps outside the
// ladder adding nothing); s1 − s2 is summed directly as
// Σ 2·sin²((θ − θm)/2)·F·Δf
__device__ void peak_ang(const Tabs& T, const Work& W, int lane, float& xnu,
                         float& sig_th) {
  const float* P = T.par;
  const int nang = T.nang, nfre = T.nfre, nfp = T.nfp;
  const float zeps = 10.f * 1.1920929e-7f;       // 10·FLT_EPSILON
  for (int m = lane; m < nfre; m += RL) {
    float s = 0.f, mx = -INFINITY;
    for (int k = 0; k < nang; ++k) {
      const float f = W.fl[k * nfp + m];
      s += f;
      mx = fmaxf(mx, f);
    }
    W.tm[m] = s;
    W.ws[m] = mx;
  }
  __syncwarp();
  float sum0 = zeps + msum(nfre, lane, [&](int m) {
    return T.dfim[m] * W.tm[m]; });
  float sum1 = msum(nfre, lane, [&](int m) { return T.dfimfr[m] * W.tm[m]; });
  float sum2 = msum(nfre, lane, [&](int m) {
    return T.dfimfr2[m] * W.tm[m]; });
  const float tl = W.tm[nfre - 1];
  sum0 = sum0 + P[P_DELT25] * tl;
  sum1 = sum1 + P[P_COEF1] * tl;
  sum2 = sum2 + P[P_COEF_FR2] * tl;
  xnu = sum0 > zeps
      ? sqrtf(fmaxf(sum2 * sum0 / (sum1 * sum1) - 1.f, zeps)) : zeps;

  // the peak: lane maxima over m = 1..nfre−2, then the row's, the
  // lowest index on ties
  float best = -INFINITY;
  int ib = nfre;
  for (int m = lane; m < nfre - 1; m += RL) {
    if (m >= 1 && W.ws[m] > best) {
      best = W.ws[m];
      ib = m;
    }
  }
#pragma unroll
  for (int o = RL / 2; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(ALL, best, o, RL);
    const int oi = __shfl_xor_sync(ALL, ib, o, RL);
    if (ob > best || (ob == best && oi < ib)) {
      best = ob;
      ib = oi;
    }
  }
  const int mmax = best > 0.f ? ib : 1;

  const int nsh = (int)P[P_NSH];
  float ss = 0.f, sc = zeps, s1 = zeps, d = zeps;
  for (int i = -nsh; i <= nsh; ++i) {
    const int m = mmax + i;
    const bool in = m >= 0 && m <= nfre - 1;
    const int mm = in ? m : 0;
    float ps = 0.f, pc = 0.f, pf = 0.f;
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int k = lane + RL * q;
      if (k >= nang) continue;
      const float f = W.fl[k * nfp + mm];
      ps += T.sinth[k] * f;
      pc += T.costh[k] * f;
      pf += f;
    }
#ifdef IMPLSCH_WIDE
    for (int k = lane + GRP; k < nang; k += RL) {
      const float f = W.fl[k * nfp + mm];
      ps += T.sinth[k] * f;
      pc += T.costh[k] * f;
      pf += f;
    }
#endif
    ps = row_sum(ps);
    pc = row_sum(pc);
    pf = row_sum(pf);
    if (in) {
      ss += ps;
      sc += pc;
    }
    const float thm = atan2f(ss, sc);
    if (in) s1 += pf * T.dfim[mm];
    float pd = 0.f;
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      const int k = lane + RL * q;
      if (k >= nang) continue;
      const float h = sinf(0.5f * (T.th[k] - thm));
      pd += 2.f * h * h * W.fl[k * nfp + mm];
    }
#ifdef IMPLSCH_WIDE
    for (int k = lane + GRP; k < nang; k += RL) {
      const float h = sinf(0.5f * (T.th[k] - thm));
      pd += 2.f * h * h * W.fl[k * nfp + mm];
    }
#endif
    pd = row_sum(pd);
    if (in) d += pd * T.dfim[mm];
  }
  sig_th = s1 > zeps ? sqrtf(2.f * fmaxf(d / s1, 0.f)) : 0.f;
  __syncwarp();
}

// SDICE1's attenuation rate at frequency m (sdice1.F90:100-124): the
// bilinear lookup of CIDEAC in (period, thickness) — the thickness cell
// ``ih`` and weight ``wh1`` are the row's — times the row's 1/D
__device__ float sdice1_alpha(const Tabs& T, int m, int ih, float wh1,
                              float dinv) {
  const float* P = T.par;
  const int nict = (int)P[P_NICT], nich = (int)P[P_NICH];
  const float tw = 1.f / T.fr[m];
  const int it = min(max((int)floorf((tw - P[P_TICMIN]) / P[P_DTIC]), 0),
                     nict - 1);
  const int it1 = min(it + 1, nict - 1);
  const float wt1 = fminf(fmaxf((tw - (P[P_TICMIN] + (float)it * P[P_DTIC]))
                                / P[P_DTIC], 0.f), 1.f);
  const int ih1 = min(ih + 1, nich - 1);
  auto c = [&](int i, int j) { return __ldg(T.cideac + i * nich + j); };
  const float wh = 1.f - wh1, wt = 1.f - wt1;
  const float deac = wt * (wh * c(it, ih) + wh1 * c(it, ih1))
      + wt1 * (wh * c(it1, ih) + wh1 * c(it1, ih1));
  return expf(deac) * dinv;
}

// AKI_ICE (aki_ice.F90): the wavenumber under sea ice of thickness cith,
// 25 Newton steps of the flexural dispersion with the reference's clip
__device__ float aki_ice(const float* P, float xk, float depth, float cith) {
  if (!(cith > 0.f)) return xk;
  const float ficstf = P[P_FICSTF_C] * (cith * cith * cith);
  const float rdh = P[P_RDH_C] * cith;
  const float om2 = P[P_G] * xk * tanhf(xk * depth);
  float aki = fminf(xk, powf(om2 / fmaxf(ficstf, 1.f), 0.2f));
  for (int it = 0; it < 25; ++it) {
    const float akid = fminf(depth * aki, 50.f);
    const float sh = sinhf(akid);
    const float a2 = aki * aki;
    const float f = ficstf * (a2 * a2 * aki) + P[P_G] * aki
        - om2 * (rdh * aki + 1.f / tanhf(akid));
    const float fp = 5.f * ficstf * (a2 * a2) + P[P_G]
        - om2 * (rdh - depth / (sh * sh));
    const float nxt = aki - f / fp;
    aki = nxt <= 0.f ? P[P_AKI_MAX] : fminf(nxt, P[P_AKI_MAX]);
  }
  return aki;
}

// Layout of the spectrum: bin (k, m) of row p lies at
// fin[p·f_ps + (k·nfr + m)·f_bs] for m < nfr (SRL rows: f_ps = nang·nfr,
// f_bs = 1; compact (nang, nfre, n): f_ps = 1, f_bs = n, nfr = nfre), and
// at tin[p·nang·(nfre−nfr) + k·(nfre−nfr) + m − nfr] above (the SRL tail
// block).  fout/tout take the result in the same layout; they may equal
// fin/tin (in place).  The template flag COMPACT (f_bs != 1) keeps the
// bin-stride multiply out of the SRL instantiations.
struct Layout {
  const float* fin; float* fout; long f_ps, f_bs;
  const float* tin; float* tout; int nfr;
};

// One physics step of row p on the row's RL lanes (``live`` false: a
// partner row of an odd row count, read from row p and not written)
template <bool FULL, bool COMPACT, bool OPTS, bool EXT, bool JAN, bool UST>
__device__ __forceinline__ void row_step(
    const Layout& Lo, const float* __restrict__ env2d,
    const float* __restrict__ scal, float* __restrict__ out,
    float* __restrict__ xllws, const Tabs& T, const Work& W, int lane,
    long p, bool live, int nrows) {
  const float* P = T.par;
  const int nang = T.nang, nfre = T.nfre, nfp = T.nfp;
  const int nfr = Lo.nfr, nt = nfre - nfr;

  // ---- load: the row's advected bins + its tail-block bins
  const float* frow = Lo.fin + p * Lo.f_ps;
  const float* trow = nt ? Lo.tin + p * (long)(nang * nt) : nullptr;
  auto fidx = [&](int k, int m) {
    const int i = k * nfr + m;
    return COMPACT ? (long)i * Lo.f_bs : (long)i;
  };
  for_bins(T, [&](int b, int k, int m) {
    W.fl[b] = m < nfr ? frow[fidx(k, m)] : trow[k * nt + (m - nfr)];
  });
  for (int m = lane; m < nfre; m += RL) {
    W.wav[m] = env2d[(long)m * nrows + p];
    W.cinv[m] = env2d[(long)(nfre + m) * nrows + p];
    W.xk2cg[m] = env2d[(long)(2 * nfre + m) * nrows + p];
  }
  auto sc = [&](int i) { return scal[(long)i * nrows + p]; };
  float wswave = sc(0);                        // UST: the log profile's
  const float wdwave = sc(1), aird = sc(2), wstar = sc(3);
  const float cicover = sc(4), cithick = sc(5), depth = sc(6);
  const float emaxdpt = sc(7);
  float ufric = sc(8), tauw = sc(9), tauwdir = sc(10), z0m = sc(11);
  float z0b = sc(12), chrnck = sc(13);
  __syncwarp();
  // EXT: the switches (LBIWBK, LICERUN, LMASKICE) and the option bits
  const int xo = EXT ? T.opts : 0;
  const bool biwbk = !(xo & OPT_NO_LBIWBK);
  const bool icerun = !(xo & OPT_NO_LICERUN);

  // ---- SDEPTHLIM (sdepthlim.F90:32-46)
  if (biwbk) {
    colsum(W.fl, W.tm, nang, nfre, nfp, lane);
    float em = msum(nfre, lane, [&](int m) { return T.dfim[m] * W.tm[m]; });
    em = em + P[P_DELT25] * W.tm[nfre - 1] + P[P_EPSMIN];
    const float scale = fminf(emaxdpt / em, 1.f);
    __syncwarp();
    for_bins(T, [&](int b, int k, int m) {
      W.fl[b] = fmaxf(W.fl[b] * scale, P[P_EPSMIN]);
    });
    __syncwarp();
  }

  // ---- FKMEAN: emean, fmean (1/f weighted), f1mean (fkmean.F90:60-100)
  colsum(W.fl, W.tm, nang, nfre, nfp, lane);
  float emean = P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
    return T.dfim[m] * W.tm[m]; });
  float fmean = P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
    return T.dfimofr[m] * W.tm[m]; });
  float f1mean = P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
    return T.dfimfr[m] * W.tm[m]; });
  {
    const float tl = W.tm[nfre - 1];
    emean = emean + P[P_DELT25] * tl;
    fmean = emean / (fmean + P[P_DELT2] * tl);
    f1mean = (f1mean + P[P_COEF1] * tl) / emean;
  }
  // EXT: the mean wavenumbers, for ISNONLIN=0 (akmean) and SDISSIP_JAN
  // (xkmean)
  float akmean = 0.f, xkmean = 0.f;
  if (EXT && (JAN || (xo & OPT_ISNONLIN0))) {
    const float ak = P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
      return T.dfim[m] / sqrtf(W.wav[m]) * W.tm[m]; });
    const float xk = P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
      return sqrtf(W.wav[m]) * T.dfim[m] * W.tm[m]; });
    const float tl = W.tm[nfre - 1];
    const float ar = emean / (ak + P[P_COEFA] * tl);
    akmean = ar * ar;
    const float xr = (xk + P[P_COEFX] * tl) / emean;
    xkmean = xr * xr;
  }
  __syncwarp();

  for (int k = lane; k < nang; k += RL) {
    const float d = T.th[k] - wdwave;
    const float cw = cosf(d), sw = sinf(d), c2 = fmaxf(0.f, cw);
    W.cosw[k] = cw;
    W.sin2[k] = sw * sw;
    W.flm[k] = (1.f - 0.9f * fminf(cicover, 0.99f)) * P[P_FLMIN] * (c2 * c2);
  }
  __syncwarp();
  const float raorw = fmaxf(aird, 1.f) * P[P_ROWATERM1];
  const int opts = OPTS ? T.opts : 0;
  // RNFAC (sinflx.F90:92-98) of the call's incoming U10: under UST the
  // second call's is the first call's log-profile U10
  float rnfac = (opts & OPT_LLNORMAGAM) && (opts & OPT_LLCAPCHNK)
      ? 1.f + P[P_DTHRN_A] * (1.f + tanhf(wswave - P[P_DTHRN_U])) : 1.f;

  // ---- 2×SINFLX (sinflx.F90:190-260), SDISSIP ARD between the calls
  int mij = nfre - 1;
  float fmeanws = 0.f, phiwa = 0.f, halp = 0.f;
  unsigned long long xbits[KPL];
#pragma unroll 1
  for (int icall = 1; icall <= 2; ++icall) {
    const bool second = icall == 2;
    if (!second) {
      for (int k = lane; k < nang; k += RL) {
        const int b = k * nfp + nfre - 1;
        W.fl[b] = fmaxf(W.fl[b], W.flm[k]);
      }
      __syncwarp();
      if (!UST && (opts & OPT_LLGCBZ0)) halp = halphap(T, W, lane);
    } else if (UST && (opts & OPT_LLNORMAGAM) && (opts & OPT_LLCAPCHNK)) {
      rnfac = 1.f + P[P_DTHRN_A] * (1.f + tanhf(wswave - P[P_DTHRN_U]));
    }
    if (UST)
      wswave = z0wave_u10(P, opts, ufric, tauw, wswave, z0m, z0b, chrnck);
    else if (opts & OPT_LLGCBZ0)
      taut_z0_gc(T, lane, wswave, wdwave, tauw, tauwdir, ufric, halp, rnfac,
                 second ? 1 : 0, ufric, z0m, z0b, chrnck);
    else
      taut_z0<OPTS>(P, opts, wswave, wdwave, tauw, tauwdir, ufric,
                    second ? 1 : 0, ufric, z0m, z0b, chrnck);
    if constexpr (JAN)
      sinput_jan<FULL, OPTS>(T, W, lane, second, wswave, ufric, z0m, raorw,
                             wstar, rnfac, xbits, phiwa);
    else
      sinput_ard<FULL, OPTS>(T, W, lane, second, wswave, wdwave, ufric, z0m,
                             raorw, wstar, rnfac, xbits, phiwa);
    // FEMEANWS (femeanws.F90:52-100)
    float emws = msum(nfre, lane, [&](int m) { return T.dfim[m] * W.ws[m]; })
        + P[P_EPSMIN];
    float fmws = msum(nfre, lane, [&](int m) {
      return T.dfimofr[m] * W.ws[m]; }) + P[P_EPSMIN];
    emws = emws + P[P_DELT25] * W.ws[nfre - 1];
    fmws = fmws + P[P_DELT2] * W.ws[nfre - 1];
    fmeanws = emws / fmws;
    // FRCUTINDEX (frcutindex.F90:64-108)
    const float fm2 = fmaxf(fmeanws, fmean) * P[P_FPMH];
    const float fpm = P[P_FPPM] / fmaxf(ufric, P[P_EPSMIN]);
    int mij1 = (int)rintf(log10f(fmaxf(fm2, fpm)) * P[P_FLOGSPRDM1]) + 1;
    mij1 = min(max(mij1, 1), nfre);
    if (!(cicover <= P[P_CITHRSH_TAIL])) mij1 = nfre;
    mij = mij1 - 1;
    stresso<FULL, OPTS>(T, W, lane, second, mij, ufric, z0m, aird, wdwave,
                        rnfac, tauw, tauwdir, phiwa);
    if (!JAN && !second) sdissip_ard(T, W, lane);
  }

  if constexpr (JAN) sdissip_jan(T, W, emean, f1mean, xkmean);
  // the DIA enhancement of ISNONLIN 0 (snonlin.F90:127-136) or 2
  float enhfr = 0.f, xnu = 0.f, sig_th = 0.f;
  if (EXT && (xo & OPT_ISNONLIN0)) {
    const float e = fmaxf(0.75f * depth * akmean, 0.5f);
    enhfr = 1.f + (5.5f / e) * (1.f - 0.833f * e) * expf(-1.25f * e);
  }
  if (EXT && (xo & OPT_ISNONLIN2)) peak_ang(T, W, lane, xnu, sig_th);
  // EXT's full-mode switches: LCFLX and LSTOKES off leave out their rows,
  // LWVFLX_SNL off takes the flux source here, before SNONLIN and
  // without the implicit factor (implsch.F90:281-306)
  const bool lcflx = !(xo & OPT_NO_LCFLX);
  const bool lstokes = !(xo & OPT_NO_LSTOKES);
  const bool snl_flux = !(xo & OPT_NO_LWVFLX_SNL);
  if (FULL && lcflx && !snl_flux) {
    float* pre = pre_at(W, T);
    for (int m = lane; m < nfre; m += RL) {
      float st = 0.f, sx = 0.f, sy = 0.f;
      for (int k = 0; k < nang; ++k) {
        const float ss = W.sl[k * nfp + m];
        st += ss;
        sx += T.sinth[k] * ss;
        sy += T.costh[k] * ss;
      }
      pre[m] = st;
      pre[nfre + m] = sx;
      pre[2 * nfre + m] = sy;
    }
    __syncwarp();
  }
  snonlin<EXT>(T, W, lane, depth, enhfr, xnu, sig_th);
  // SNONLIN's second buffer took cosw: SETICE reads it again
  for (int k = lane; k < nang; k += RL) W.cosw[k] = cosf(T.th[k] - wdwave);

  // ---- WNFLUXES' source sums, SNONLIN included (implsch.F90:297-305)
  if (FULL && lcflx && !snl_flux) {
    const float* pre = pre_at(W, T);
    for (int m = lane; m < nfre; m += RL) {
      W.sumt[m] = pre[m];
      W.sumx[m] = pre[nfre + m];
      W.sumy[m] = pre[2 * nfre + m];
    }
    __syncwarp();
  } else if (FULL && lcflx) {
    for (int m = lane; m < nfre; m += RL) {
      float st = 0.f, sx = 0.f, sy = 0.f;
      for (int k = 0; k < nang; ++k) {
        const int b = k * nfp + m;
        const float ss = W.sl[b] / fmaxf(1.f - P[P_DELT5] * W.fld[b], 1.f);
        st += ss;
        sx += T.sinth[k] * ss;
        sy += T.costh[k] * ss;
      }
      W.sumt[m] = st;
      W.sumx[m] = sx;
      W.sumy[m] = sy;
    }
    __syncwarp();
  }

  // ---- SDIWBK (sdiwbk.F90:44-75) + SBOTTOM (sbottom.F90:41-60)
  float sds = 0.f;
  {
    const float alph = 2.f * emaxdpt / emean;
    const float arg = fminf(alph, 50.f);
    float q_old = expf(-arg), q_out = q_old;
    bool done = false;
    for (int it = 0; it < 15; ++it) {
      const float expq = expf(-arg * (1.f - q_old));
      const float q = q_old - (expq - q_old) / (arg * expq - 1.f);
      const float rel_err = fabsf(q - q_old) / q_old;
      if (!done) q_out = q;
      done = done || rel_err < 1.0e-5f;
      if (!done) q_old = q;
      if (done) break;                         // nothing changes after
    }
    if (depth < P[P_DEPTHTRS] && biwbk)
      sds = 2.f * alph * fminf(q_out, 1.f) * f1mean;
  }
  const bool bottom = depth < P[P_BATHYMAX];
  if (!OPTS) {
    // SBOTTOM's rate per frequency into W.tm
    if (bottom)
      for (int m = lane; m < T.nred; m += RL)
        W.tm[m] = P[P_SBOT_C] * W.wav[m]
            / sinhf(fminf(2.f * depth * W.wav[m], 50.f));
    __syncwarp();
    for_bins(T, [&](int b, int k, int m) {
      if (m >= T.nred) return;
      const float f = W.fl[b];
      float s = W.sl[b] + (-sds) * f;
      float d = W.fld[b] + (-sds);
      if (bottom) {
        const float sbo = W.tm[m];
        s = s + sbo * f;
        d = d + sbo;
      }
      W.sl[b] = s;
      W.fld[b] = d;
    });
  } else {
    // SDIWBK, then LCISCAL and SDICE3 on every frequency
    // (implsch.F90, sdice3.F90:55-95), then SBOTTOM; EXT adds SDICE1 and
    // SDICE2 before SDICE3, and LICERUN.  Per frequency first: SBOTTOM's
    // rate (W.tm), the group speed from (k, d) as implsch.derive_cgroup
    // (W.sx), and times it SDICE1's rate (W.ws) and SDICE3's (W.sy)
    const float beta = 1.f - cicover;
    const bool ciwa3 = icerun && (opts & OPT_LCIWA3);
    const bool ciwa1 = EXT && icerun && (xo & OPT_LCIWA1);
    const bool ciwa2 = EXT && icerun && (xo & OPT_LCIWA2);
    const bool ice = ciwa3 || ciwa1 || ciwa2;
    const float h125 = ciwa3 ? powf(cithick, 1.25f) : 0.f;
    // SDICE1's floe size 1/D and thickness cell (sdice1.F90:65-124)
    float dinv = 0.f, wh1 = 0.f;
    int ih = 0;
    if (ciwa1) {
      const float cidmax = 200.f + 300.f * cicover;
      const float icm = fminf(floorf(logf(cidmax / 20.f) / logf(2.f)), 3.f);
      float sn = 0.f, sd = 0.f, x = 1.f, g = 1.f;
      for (int i = 0; i <= 3; ++i) {
        if ((float)i <= icm) {
          sn += x * cidmax / g;
          sd += x;
        }
        x *= 4.f * 0.955f;
        g *= 2.f;
      }
      dinv = sd / sn;
      const int nich = (int)P[P_NICH];
      ih = min(max((int)floorf((cithick - P[P_HICMIN]) / P[P_DHIC]), 0),
               nich - 1);
      wh1 = fminf(fmaxf((cithick - (P[P_HICMIN] + (float)ih * P[P_DHIC]))
                        / P[P_DHIC], 0.f), 1.f);
    }
    for (int m = lane; m < nfre; m += RL) {
      if (bottom && m < T.nred)
        W.tm[m] = P[P_SBOT_C] * W.wav[m]
            / sinhf(fminf(2.f * depth * W.wav[m], 50.f));
      if (ice) {
        const float xk = W.wav[m];
        const float akd = xk * depth, akd_s = fminf(akd, 10.f);
        const float cg = akd <= 10.f
            ? 0.5f * sqrtf(P[P_G] * tanhf(akd_s) / xk)
                  * (1.f + 2.f * akd_s / sinhf(2.f * akd_s))
            : P[P_G4PI] / T.fr[m];
        W.sx[m] = cg;
        if (ciwa1)
          W.ws[m] = -(cithick > 0.f ? sdice1_alpha(T, m, ih, wh1, dinv) : 0.f)
              * cg;
        if (ciwa3) W.sy[m] = -(P[P_CDICE2] * h125 * T.fr45[m]) * cg;
      }
    }
    __syncwarp();
    for_bins(T, [&](int b, int k, int m) {
      const bool low = m < T.nred;
      const float f = W.fl[b];
      float s = W.sl[b], d = W.fld[b];
      if (low) {
        s = s + (-sds) * f;
        d = d + (-sds);
      }
      if (icerun && (opts & OPT_LCISCAL)) {
        s = beta * s;
        d = beta * d;
      }
      if (ciwa1) {
        const float fldice = W.ws[m];
        s = s + cicover * (f * fldice);
        d = d + cicover * fldice;
      }
      if (ciwa2) {
        // SDICE2 (sdice2.F90:45-70): the drag on each bin's amplitude
        const float xk = W.wav[m];
        const float ewh = 4.f * sqrtf(fmaxf(P[P_EPSMIN], f * T.dfim[m]));
        const float fldice = -(P[P_CDICWA] * (xk * xk) * ewh) * W.sx[m];
        s = s + cicover * (f * fldice);
        d = d + cicover * fldice;
      }
      if (ciwa3) {
        const float fldice = W.sy[m];
        s = s + cicover * (f * fldice);
        d = d + cicover * fldice;
      }
      if (low && bottom) {
        const float sbo = W.tm[m];
        s = s + sbo * f;
        d = d + sbo;
      }
      W.sl[b] = s;
      W.fld[b] = d;
    });
  }
  __syncwarp();

  // ---- semi-implicit update with growth limiter (implsch.F90:260-300);
  // FULL keeps the FLMAX cap's flux term deltm·min(flmax − F, 0) in fld,
  // which is dead after the update
  const float usfm = ufric * fmaxf(fmeanws, fmean);
  for_bins(T, [&](int b, int k, int m) {
    const float temp = usfm * (T.cofrm4[m] * P[P_DELT]);
    const float gtemp1 = fmaxf(1.f - P[P_DELT5] * W.fld[b], 1.f);
    const float gtemp2 = P[P_DELT] * W.sl[b] / gtemp1;
    const float flhab = fminf(fabsf(gtemp2), temp);
    float f = W.fl[b] + sgn(gtemp2) * flhab;
    f = fmaxf(f, W.flm[k]);
    if (FULL) W.fld[b] = P[P_DELTM] * fminf(T.flmax[m] - f, 0.f);
    W.fl[b] = fminf(f, T.flmax[m]);
  });
  __syncwarp();

  // FULL's extra rows go out as they are formed (by the row's first lane)
  auto put = [&](int i, float v) {
    if (live && lane == 0) out[i * (long)nrows + p] = v;
  };
  if (FULL) {
    if (lcflx) {
      // the cap term joins the source sums (implsch.F90:375,390)
      for (int m = lane; m < nfre; m += RL) {
        float st = 0.f, sx = 0.f, sy = 0.f;
        for (int k = 0; k < nang; ++k) {
          const float cap = W.fld[k * nfp + m];
          st += cap;
          sx += T.sinth[k] * cap;
          sy += T.costh[k] * cap;
        }
        W.sumt[m] += st;
        W.sumx[m] += sx;
        W.sumy[m] += sy;
      }
      __syncwarp();

      // WNFLUXES (wnfluxes.F90:150-340) with the first FKMEAN's em, f1
      auto rhowgdfth = [&](int m) {
        if (m > mij) return 0.f;
        const float w = T.rhowg[m];
        return (m == mij && mij != nfre - 1) ? 0.5f * w : w;
      };
      const float philf = msum(nfre, lane, [&](int m) {
        return W.sumt[m] * rhowgdfth(m); });
      const float xstr = msum(nfre, lane, [&](int m) {
        return W.sumx[m] * (W.cinv[m] * rhowgdfth(m)); });
      const float ystr = msum(nfre, lane, [&](int m) {
        return W.sumy[m] * (W.cinv[m] * rhowgdfth(m)); });
      float ooval = 1.f, ustar = ufric, em_oc = emean, f1_oc = f1mean;
      if (P[P_LWAMRSETCI] != 0.f && icerun && cicover > P[P_ZCITHRS]) {
        const float ci4 = cicover * P[P_CITHRSH_INV];
        const float oi = expf(-fminf((ci4 * ci4) * (ci4 * ci4), P[P_ZMAXEXP]));
        const float u10p = fmaxf(wswave, P[P_EPSU10]);
        const float cd_bulk = fminf((P[P_CDB_C1] + P[P_CDB_C2]
                                     * powf(u10p, P[P_CDB_P1]))
                                    * powf(u10p, P[P_CDB_P2]), P[P_CDB_MAX]);
        const float uu = ufric / u10p;
        const float cd_ice = oi * (uu * uu) + (1.f - oi) * cd_bulk;
        const float us_i = fmaxf(sqrtf(cd_ice) * u10p, P[P_EPSUS]);
        const float us2 = us_i * us_i;
        const float efd = fminf(P[P_EFD_FAC] * (us2 * us2), P[P_EFD_MAX]);
        em_oc = fmaxf(oi * emean + (1.f - oi) * efd, P[P_EFD_MIN]);
        const float ffd = P[P_FFD_FAC] / us_i;
        f1_oc = fminf(fmaxf(oi * f1mean + (1.f - oi) * ffd, T.fr[1]),
                      T.fr[nfre - 1]);
        ooval = oi;
        ustar = us_i;
      }
      const float tau = aird * fmaxf(ustar * ustar, P[P_EPSUS]);
      const float tauxd = tau * sinf(wdwave), tauyd = tau * cosf(wdwave);
      const float tauocxd = tauxd - ooval * xstr;
      const float tauocyd = tauyd - ooval * ystr;
      const float tauo = sqrtf(tauocxd * tauocxd + tauocyd * tauocyd);
      const float xn = aird * fmaxf(ustar * ustar * ustar, P[P_EPSUS3]);
      const float phioc = ooval * (philf - phiwa)
          + (1.f - ooval) * P[P_PHIOC_ICE] * xn;
      const float phieps = fminf(fmaxf(phioc / xn, P[P_PHIEPSMIN]),
                                 P[P_PHIEPSMAX]);
      put(O_TAUXD, tauxd);
      put(O_TAUYD, tauyd);
      put(O_TAUOCXD, tauocxd);
      put(O_TAUOCYD, tauocyd);
      put(O_TAUOC, fminf(fmaxf(tauo / tau, P[P_TAUOCMIN]), P[P_TAUOCMAX]));
      put(O_PHIOCD, phieps * xn);
      put(O_PHIEPS, phieps);
      put(O_PHIAW, ooval * phiwa / xn + (1.f - ooval) * P[P_PHIAW_ICE]);
      put(O_EM_OC, em_oc);
      put(O_F1_OC, f1_oc);
    } else {
      for (int i = O_TAUXD; i <= O_F1_OC; ++i) put(i, 0.f);
    }
    put(O_PHIWA, phiwa);
    put(O_MIJ, (float)mij);

    // second FKMEAN (fkmean.F90:60-100) and FEMEANWS on the updated bins
    colsum(W.fl, W.tm, nang, nfre, nfp, lane);
    float e2 = P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
      return T.dfim[m] * W.tm[m]; });
    float fm1 = P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
      return T.dfimofr[m] * W.tm[m]; });
    float f1 = P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
      return T.dfimfr[m] * W.tm[m]; });
    float ak = P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
      return T.dfim[m] / sqrtf(W.wav[m]) * W.tm[m]; });
    float xk = P[P_EPSMIN] + msum(nfre, lane, [&](int m) {
      return sqrtf(W.wav[m]) * T.dfim[m] * W.tm[m]; });
    const float tl = W.tm[nfre - 1];
    e2 = e2 + P[P_DELT25] * tl;
    put(O_EMEAN, e2);
    put(O_FMEAN, e2 / (fm1 + P[P_DELT2] * tl));
    put(O_F1MEAN, (f1 + P[P_COEF1] * tl) / e2);
    const float ar = e2 / (ak + P[P_COEFA] * tl);
    put(O_AKMEAN, ar * ar);
    const float xr = (xk + P[P_COEFX] * tl) / e2;
    put(O_XKMEAN, xr * xr);
    // the windsea sums Σ_k xllws·F per frequency: each direction's mask
    // word goes to shared memory (W.dx, free after the flux sums; the
    // wide build's mask is there already), then one lane per frequency
    // sums the directions in order
    const unsigned* xw = mask_at(W, T);
    int nwd = mask_words(nfre);
    if constexpr (!WIDE) {
      unsigned* x2 = reinterpret_cast<unsigned*>(W.dx);
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int k = lane + RL * q;
        if (k >= nang) continue;
        x2[2 * k] = (unsigned)xbits[q];
        x2[2 * k + 1] = (unsigned)(xbits[q] >> 32);
      }
      xw = x2;
      nwd = 2;
    }
    __syncwarp();
    for (int m = lane; m < nfre; m += RL) {
      const int word = m >> 5, bit = m & 31;
      float w = 0.f;
      for (int k = 0; k < nang; ++k)
        if ((xw[k * nwd + word] >> bit) & 1u) w += W.fl[k * nfp + m];
      W.ws[m] = w;
    }
    __syncwarp();
    float emws = msum(nfre, lane, [&](int m) { return T.dfim[m] * W.ws[m]; })
        + P[P_EPSMIN];
    float fmws = msum(nfre, lane, [&](int m) {
      return T.dfimofr[m] * W.ws[m]; }) + P[P_EPSMIN];
    emws = emws + P[P_DELT25] * W.ws[nfre - 1];
    fmws = fmws + P[P_DELT2] * W.ws[nfre - 1];
    const bool small = emws < P[P_WSEMEAN_MIN];
    put(O_EMEANWS, emws);
    put(O_FMEANWS, emws / fmws);
    put(O_WSEMEAN, small ? P[P_WSEMEAN_MIN] : emws);
    put(O_WSFMEAN, small ? 2.f * T.fr[nfre - 1] : emws / fmws);
    __syncwarp();
  }

  // ---- IMPHFTAIL (imphftail.F90:40-55) + SETICE (setice.F90:38-60)
  const float t_mij = 1.f / (W.xk2cg[mij] * W.wav[mij]);
  for (int m = mij + 1 + lane; m < nfre; m += RL)
    W.tm[m] = (1.f / (W.xk2cg[m] * W.wav[m])) / t_mij;
  __syncwarp();
  for_bins(T, [&](int b, int k, int m) {
    if (m <= mij) return;
    W.fl[b] = fmaxf(W.tm[m] * W.fl[k * nfp + mij], W.flm[k]);
  });
  __syncwarp();
  if (icerun && !(xo & OPT_NO_LMASKICE) && cicover > P[P_CITHRSH]) {
    const float cireduc = fmaxf(P[P_EPSMIN], 1.f - cicover);
    for_bins(T, [&](int b, int k, int m) {
      const float c2 = fmaxf(0.f, W.cosw[k]);
      W.fl[b] = cireduc * P[P_FLMIN] * (c2 * c2);
    });
  }
  __syncwarp();

  // ---- STOKESTRN (stokesdrift.F90:95-145), STOKFAC from (k, d)
  if (FULL && !lstokes) {
    put(O_USTOKES, 0.f);
    put(O_VSTOKES, 0.f);
    put(O_STRNMS, 0.f);
  } else if (FULL) {
    const int nodd = nfre - 1 + nfre % 2;
    for (int m = lane; m < nodd; m += RL) {
      const float om = T.zpifr[m], xk = W.wav[m];
      const float akd = xk * depth;
      const float sh = P[P_TWOG] * (xk * xk)
          / (om * tanhf(2.f * fminf(akd, 10.f)));
      const float dp = P[P_TWOGM1] * (om * om * om);
      W.tm[m] = (akd <= 10.f ? sh : dp) * T.dfimsim[m];
    }
    __syncwarp();
    float us = 0.f, vs = 0.f, ut = 0.f, vt = 0.f;
    for_bins(T, [&](int b, int k, int m) {
      if (m >= nodd) return;
      const float f3 = W.tm[m] * W.fl[b];
      us += f3 * T.sinth[k];
      vs += f3 * T.costh[k];
      if (m == nodd - 1) {
        ut += T.sinth[k] * W.fl[b];
        vt += T.costh[k] * W.fl[b];
      }
    });
    us = row_sum(us) + P[P_STOKES_C] * row_sum(ut);
    vs = row_sum(vs) + P[P_STOKES_C] * row_sum(vt);
    if (P[P_LWAMRSETCI] != 0.f && icerun && cicover > P[P_CITHRSH_STOKES]) {
      const float fac = 0.016f * wswave * (1.f - cicover);
      us = fac * sinf(wdwave);
      vs = fac * cosf(wdwave);
    }
    put(O_USTOKES, fminf(fmaxf(us, -P[P_STMAX]), P[P_STMAX]));
    put(O_VSTOKES, fminf(fmaxf(vs, -P[P_STMAX]), P[P_STMAX]));
    put(O_STRNMS, 0.f);
    if (xo & OPT_LSTRN) {
      // CIMSSTRN (cimsstrn.F90:85-125): one lane per frequency
      float part = 0.f;
      for (int m = lane; m < nfre; m += RL) {
        float sume = 0.f;
        for (int k = 0; k < nang; ++k) sume += W.fl[k * nfp + m];
        const float xk = W.wav[m];
        const float xki = aki_ice(P, xk, depth, cithick);
        const float e = 0.5f * cithick * (xki * xki * xki) / xk;
        if (sume > P[P_F1LIM]) part += (e * e) * sume * T.dfim[m];
      }
      put(O_STRNMS, row_sum(part));
    }
  }

  // ---- store
  if (live) {
    float* fdst = Lo.fout + p * Lo.f_ps;
    float* tdst = nt ? Lo.tout + p * (long)(nang * nt) : nullptr;
    for_bins(T, [&](int b, int k, int m) {
      if (m < nfr) fdst[fidx(k, m)] = W.fl[b];
      else tdst[k * nt + (m - nfr)] = W.fl[b];
    });
    if (lane == 0) {
      out[O_UFRIC * (long)nrows + p] = ufric;
      out[O_TAUW * (long)nrows + p] = tauw;
      out[O_TAUWDIR * (long)nrows + p] = tauwdir;
      out[O_Z0M * (long)nrows + p] = z0m;
      out[O_Z0B * (long)nrows + p] = z0b;
      out[O_CHRNCK * (long)nrows + p] = chrnck;
      if (UST) out[(FULL ? O_WSWAVE : NOUT_MIN) * (long)nrows + p] = wswave;
    }
    if (FULL) {
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int k = lane + RL * q;
        if (k >= nang) continue;
        for (int m = 0; m < nfre; ++m) {
          if constexpr (WIDE)
            xllws[(long)(k * nfre + m) * nrows + p] = (float)(
                (mask_at(W, T)[k * mask_words(nfre) + (m >> 5)] >> (m & 31))
                & 1u);
          else
            xllws[(long)(k * nfre + m) * nrows + p] =
                (float)((xbits[q] >> m) & 1ull);
        }
      }
#ifdef IMPLSCH_WIDE
      for (int k = lane + GRP; k < nang; k += RL)
        for (int m = 0; m < nfre; ++m)
          xllws[(long)(k * nfre + m) * nrows + p] = (float)(
              (mask_at(W, T)[k * mask_words(nfre) + (m >> 5)] >> (m & 31))
              & 1u);
#endif
    }
  }
  __syncwarp();                                // W is the next row's
}

#ifdef IMPLSCH_WIDE
// W's floats in the staged tables (SDISSIP's saturation weights, nang²):
// up to GRP directions; past them W is read from global memory through
// the cache
__host__ __device__ __forceinline__ int staged_w(int nang) {
  return nang <= GRP ? nang * nang : 0;
}
#define STAGED_W(nang) staged_w(nang)
#else
#define STAGED_W(nang) nang * nang
#endif

// Each block's copy of the tables its inner loops read, in shared memory
// from ``s``: the parameter block with the per-frequency and per-direction
// tables and W (contiguous in the packed array; in the wide build only
// while it is staged, STAGED_W), the
// tail-integral weights, (OPTS) the gc tables, the DIA step records from
// the next 16-byte boundary, and SNONLIN's shifts; then the bin walk's
// constants.  Every thread of the block takes part; it returns the tables
// pointed there
template <bool OPTS>
__host__ __device__ __forceinline__ int table_floats(int nang, int nfre,
                                                     int mlsthg, int nwav) {
  const int head = NPAR + NFREQTAB * nfre + 3 * nang + STAGED_W(nang) + JTOT
      + (OPTS ? NGCSTAGE * nwav : 0);
  const int n = ((head + 3) & ~3) + DIA_REC * mlsthg + 8;
  return (n + 31) & ~31;
}

template <bool OPTS>
__device__ Tabs stage_tables(const Tabs& G, float* s) {
  const int nang = G.nang, nfre = G.nfre, ml = G.mlsthg;
  const int tid = threadIdx.x, nth = blockDim.x;
  auto copy = [&](float* d, const float* g, int n) {
    for (int i = tid; i < n; i += nth) d[i] = g[i];
  };
  Tabs T = G;
  const int n1 = NPAR + NFREQTAB * nfre + 3 * nang + STAGED_W(nang);
  copy(s, G.par, n1);
  auto at = [&](const float* g) { return s + (g - G.par); };
  T.par = s;
  T.fr = at(G.fr); T.dfim = at(G.dfim); T.dfimofr = at(G.dfimofr);
  T.dfimfr = at(G.dfimfr); T.zpifr = at(G.zpifr); T.fr5 = at(G.fr5);
  T.cofrm4 = at(G.cofrm4); T.rhowg = at(G.rhowg); T.flmax = at(G.flmax);
  T.dfimsim = at(G.dfimsim); T.fr45 = at(G.fr45);
  T.dfimfr2 = at(G.dfimfr2);
  T.th = at(G.th); T.sinth = at(G.sinth); T.costh = at(G.costh);
#ifdef IMPLSCH_WIDE
  T.wmat = staged_w(nang) ? at(G.wmat) : G.wmat;
#else
  T.wmat = at(G.wmat);
#endif
  float* q = s + n1;
  copy(q, G.wtauhf, JTOT);
  T.wtauhf = q;
  q += JTOT;
  if (OPTS) {
    copy(q, G.gc, NGCSTAGE * G.nwav);
    T.gc = q;
    q += NGCSTAGE * G.nwav;
  }
  q = s + (((q - s) + 3) & ~3);                // float4 reads
  {
    // the records hold ints as bits: copied as words
    const unsigned* g = reinterpret_cast<const unsigned*>(G.dia);
    unsigned* d = reinterpret_cast<unsigned*>(q);
    for (int i = tid; i < DIA_REC * ml; i += nth) d[i] = g[i];
  }
  T.dia = q;
  q += DIA_REC * ml;
  int* qi = reinterpret_cast<int*>(q);
  for (int i = tid; i < 8; i += nth) qi[i] = G.shifts[i];
  T.shifts = qi;
  const int lane = threadIdx.x & (RL - 1);
  T.nfp = nfre | 1;
  T.dk = RL / nfre;
  T.dm = RL - T.dk * nfre;
  T.k0 = lane / nfre;
  T.m0 = lane - T.k0 * nfre;
  __syncthreads();
  return T;
}

// The grid: one or more blocks an SM, each of ``blockDim.x/32`` warps;
// warp w of block b steps the row groups RPW·i .. RPW·i + RPW − 1, i =
// b·warps + w, then every gridDim.x·warps groups on; lanes r·RL .. r·RL +
// RL − 1 take row RPW·i + r.  Each warp's rows have their own working sets
// after the block's tables
template <bool FULL, bool COMPACT, bool OPTS, bool EXT = false,
          bool JAN = false, bool UST = false>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
implsch_kernel(Layout Lo, const float* __restrict__ env2d,
               const float* __restrict__ scal, float* __restrict__ out,
               float* __restrict__ xllws, Tabs G, int nrows, int rstride) {
  extern __shared__ float smem[];
  const Tabs T = stage_tables<OPTS>(G, smem);
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int sub = (threadIdx.x & 31) / RL;
  const int lane = threadIdx.x & (RL - 1);
  const Work W = work_at(
      smem + table_floats<OPTS>(G.nang, G.nfre, G.mlsthg, G.nwav)
          + (long)(RPW * warp + sub) * rstride,
      T);
  const long groups = ((long)nrows + RPW - 1) / RPW;
  for (long i = (long)blockIdx.x * warps + warp; i < groups;
       i += (long)gridDim.x * warps) {
    const long p = RPW * i + sub;
    const bool live = p < nrows;
    row_step<FULL, COMPACT, OPTS, EXT, JAN, UST>(
        Lo, env2d, scal, out, xllws, T, W, lane, live ? p : p - sub, live,
        nrows);
  }
}

template <bool FULL, bool COMPACT, bool OPTS, bool EXT, bool JAN,
          bool UST = false>
int launch(const Layout& Lo, const float* env2d, const float* scal,
           float* out, float* xllws, const Tabs& T, int nrows,
           cudaStream_t stream) {
  auto* kernel = implsch_kernel<FULL, COMPACT, OPTS, EXT, JAN, UST>;
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // as many warps a block as shared memory holds, at most MAX_WARPS; the
  // rows lie 16 banks apart (the stride an odd number of 16-float halves)
  // where that costs no warp: with one row a warp it made the default
  // instantiation 7-9 % faster at 36×36 (PERF.md), and it keeps two rows
  // a warp apart
  const long tb = 4L * table_floats<OPTS>(T.nang, T.nfre, T.mlsthg, T.nwav);
  const int rf = row_floats(T.nang, T.nfre, T.mlsthg, FULL,
                            EXT && (T.opts & OPT_NO_LWVFLX_SNL));
  auto fit = [&](int stride) {
    const long n = (optin - tb) / (4L * RPW * stride);
    return (int)(n < MAX_WARPS ? n : MAX_WARPS);
  };
  const int rstride = fit(rf + 16) < fit(rf) ? rf : rf + 16;
  const int warps = fit(rstride);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(tb + 4L * RPW * rstride * warps);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * warps, smem);
  if (e != cudaSuccess) return (int)e;
  const long groups = ((long)nrows + RPW - 1) / RPW;
  const long need = (groups + warps - 1) / warps;
  const long fill = (long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(need < fill ? need : fill);
  if (blocks == 0) return (int)cudaSuccess;
  kernel<<<blocks, 32 * warps, smem, stream>>>(Lo, env2d, scal, out, xllws, T,
                                               nrows, rstride);
  return (int)cudaGetLastError();
}

}  // namespace ecwam_implsch

using namespace ecwam_implsch;

// Host entry, bound from Python with ctypes.  ``tab``/``itab`` hold the
// parameter block and tables laid out by implsch_cuda.pack_tables; the
// layout arguments are those of ``Layout`` above.  ``out`` takes 6 rows
// (minimal) or NOUT_FULL rows and ``xllws`` the (nang, nfre, nrows) mask
// (full; with OPT_USTAR one more row, U10, in either mode).  ``nred`` is
// the configuration's nfre_red, the top of the SDIWBK/SBOTTOM range,
// whatever the layout.  ``opts`` picks the instantiation: with OPT_USTAR
// a UST one (compact layout; with OPTS where another bit is set, and
// EXT/JAN where their bits are set), else with bits of OPT_EXT the EXT one (JAN too for iphys=0), with
// other bits OPTS, with none the default.  Returns the CUDA error code of
// the launch (0 = launched).
extern "C" int implsch_launch(
    int full, const float* fin, float* fout, long f_ps, long f_bs,
    const float* tin, float* tout, const float* env2d, const float* scal,
    float* out, float* xllws, const float* tab, const int* itab, int nrows,
    int nang, int nfre, int nfr, int nred, int mlsthg, int niab, int nwav,
    int opts, void* stream) {
  if ((!WIDE && nang > RL * KPL) || nang < 1 || nfre < 1 || nfr < 1
      || nfr > nfre
      || nred < 1 || nred > nfre || (full && !WIDE && nfre > 64)
      || nwav < 2 || (nfr < nfre && (!tin || !tout)))
    return (int)cudaErrorInvalidValue;
  Tabs T;
  T.nang = nang; T.nfre = nfre; T.nred = nred; T.mlsthg = mlsthg;
  T.niab = niab; T.nwav = nwav; T.opts = opts;
  const float* t = tab;
  T.par = t; t += NPAR;
  const float* ft[NFREQTAB];
  for (int i = 0; i < NFREQTAB; ++i) { ft[i] = t; t += nfre; }
  T.fr = ft[T_FR]; T.dfim = ft[T_DFIM]; T.dfimofr = ft[T_DFIMOFR];
  T.dfimfr = ft[T_DFIMFR]; T.zpifr = ft[T_ZPIFR]; T.fr5 = ft[T_FR5];
  T.cofrm4 = ft[T_COFRM4]; T.rhowg = ft[T_RHOWG]; T.flmax = ft[T_FLMAX];
  T.dfimsim = ft[T_DFIMSIM]; T.fr45 = ft[T_FR45];
  T.th = t; t += nang;
  T.sinth = t; t += nang;
  T.costh = t; t += nang;
  T.wmat = t; t += nang * nang;
  T.swellft = t; t += niab;
  T.wtauhf = t; t += JTOT;
  T.gc = T.gcx = t; t += NGCTAB * nwav;
  T.dia = t; t += DIA_REC * mlsthg;
  T.xk_ext = t;
  T.shifts = itab;
  T.dfimfr2 = ft[T_DFIMFR2];
  T.cideac = T.xk_ext + (mlsthg - nfre);
  T.nfp = T.dk = T.dm = T.k0 = T.m0 = 0;       // set in each block

  const Layout Lo{fin, fout, f_ps, f_bs, tin, tout, nfr};
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(F, C, O, E, J) \
  launch<F, C, O, E, J>(Lo, env2d, scal, out, xllws, T, nrows, s)
  if ((opts & OPT_USTAR) && f_bs == 1)          // u*: the compact entry
    return (int)cudaErrorInvalidValue;
  // IMPLSCH_SRL or IMPLSCH_COMPACT: a build that holds one entry's
  // instantiations (the libraries of _build.VARIANTS, built in parallel)
#if defined(IMPLSCH_SRL)
  if (f_bs != 1) return (int)cudaErrorInvalidValue;
#define MODES(O, E, J)                                                    \
  return full ? LAUNCH(true, false, O, E, J) : LAUNCH(false, false, O, E, J)
#elif defined(IMPLSCH_COMPACT)
  if (f_bs == 1) return (int)cudaErrorInvalidValue;
#define MODES(O, E, J)                                                    \
  return full ? LAUNCH(true, true, O, E, J) : LAUNCH(false, true, O, E, J)
#else
#error "build with -DIMPLSCH_SRL or -DIMPLSCH_COMPACT (_build.VARIANTS)"
#endif
#ifndef IMPLSCH_SRL
#define UST_MODES(O, E, J)                                                \
  return full ? launch<true, true, O, E, J, true>(Lo, env2d, scal, out,    \
                                                  xllws, T, nrows, s)      \
              : launch<false, true, O, E, J, true>(Lo, env2d, scal, out,   \
                                                   xllws, T, nrows, s)
  if (opts & OPT_USTAR) {
    if (opts & OPT_EXT) {
      if (opts & OPT_IPHYS0) { UST_MODES(true, true, true); }
      UST_MODES(true, true, false);
    }
    if (opts != OPT_USTAR) { UST_MODES(true, false, false); }
    UST_MODES(false, false, false);
  }
#undef UST_MODES
#endif
  if (opts & OPT_EXT) {
    if (opts & OPT_IPHYS0) { MODES(true, true, true); }
    MODES(true, true, false);
  }
  if (opts) { MODES(true, false, false); }
  MODES(false, false, false);
#undef MODES
#undef LAUNCH
}
