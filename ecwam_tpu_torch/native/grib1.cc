// GRIB edition-1 codec (simple packing) — native equivalent of the
// eccodes subset ecWAM uses (reference: src/ecwam/yowgrib.F90 wraps
// eccodes IGRIB_* calls; forcing decode grib2wgrid.F90, product encode
// wgribencode.F90).  Supports:
//   - regular lat-lon (GDS type 0), reduced lat-lon (type 0 + PL),
//     regular/reduced Gaussian (type 4 + PL)
//   - bitmap (BMS) for missing values
//   - sign-magnitude 16/24-bit integers, IBM-370 32-bit reference value
//
// C ABI for ctypes; all multi-byte fields big-endian per the spec.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t be(const uint8_t* p, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
    return v;
}

inline int32_t sm(const uint8_t* p, int n) {  // sign-magnitude signed int
    uint32_t v = be(p, n);
    uint32_t signbit = 1u << (8 * n - 1);
    return (v & signbit) ? -(int32_t)(v & (signbit - 1)) : (int32_t)v;
}

inline void put_be(uint8_t* p, uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) { p[i] = v & 0xff; v >>= 8; }
}

inline void put_sm(uint8_t* p, int32_t v, int n) {
    uint32_t m = (v < 0) ? (uint32_t)(-v) : (uint32_t)v;
    put_be(p, m, n);
    if (v < 0) p[0] |= 0x80;
}

double ibm_to_double(const uint8_t* p) {
    int sign = (p[0] & 0x80) ? -1 : 1;
    int expo = (p[0] & 0x7f) - 64;
    uint32_t mant = be(p + 1, 3);
    if (mant == 0) return 0.0;
    return sign * std::ldexp((double)mant, -24) * std::pow(16.0, expo);
}

// Encode double → IBM float bytes (round toward nearest representable
// below in magnitude so the reference value stays <= all data values).
void double_to_ibm(double x, uint8_t* p) {
    if (x == 0.0) { p[0] = p[1] = p[2] = p[3] = 0; return; }
    int sign = x < 0 ? 1 : 0;
    double ax = std::fabs(x);
    int expo = (int)std::ceil(std::log2(ax) / 4.0);
    // normalise mantissa into [1/16, 1)
    double m = ax * std::pow(16.0, -expo);
    while (m >= 1.0) { m /= 16.0; ++expo; }
    while (m < 0.0625 && expo > -64) { m *= 16.0; --expo; }
    uint32_t mant = (uint32_t)std::floor(m * 16777216.0 + 1e-9);
    if (mant >= 16777216u) { mant >>= 4; ++expo; }
    p[0] = (uint8_t)((sign << 7) | ((expo + 64) & 0x7f));
    put_be(p + 1, mant, 3);
}

struct Reader {
    const uint8_t* buf;
    long len;
    long pos = 0;
};

}  // namespace

// meta layout (int64 slots) shared by g1_info / g1_encode:
//  0 totalLen      1 table2Version  2 centre      3 generatingProcess
//  4 gridId        5 param          6 levelType   7 level
//  8 dataDate (YYYYMMDD)            9 dataTime (HHMM)
// 10 unitOfTime   11 P1            12 P2          13 timeRangeInd
// 14 gridType (0 latlon, 4 gaussian, 10 rotated…)
// 15 Ni (-1 = reduced)             16 Nj
// 17 lat1 (millideg)  18 lon1      19 lat2        20 lon2
// 21 Di (millideg, -1 missing)     22 Dj / N      23 scanMode
// 24 nValues      25 hasBitmap     26 nPL (0 = none)
// 27 decimalScale 28 binaryScale   29 bitsPerValue
// 30 subCentre    31 reserved

extern "C" {

// Find the next GRIB message at/after *offset; returns 0 and updates
// *offset/*msglen, or -1 if none.
int g1_next(const uint8_t* buf, long len, long* offset, long* msglen) {
    for (long i = *offset; i + 8 <= len; ++i) {
        if (buf[i] == 'G' && buf[i+1] == 'R' && buf[i+2] == 'I' &&
            buf[i+3] == 'B' && buf[i+7] == 1) {
            long tl = be(buf + i + 4, 3);
            if (i + tl <= len && tl >= 32) {
                *offset = i;
                *msglen = tl;
                return 0;
            }
        }
    }
    return -1;
}

int g1_info(const uint8_t* msg, long len, int64_t* meta, int64_t* pl,
            long pl_cap) {
    if (len < 32 || std::memcmp(msg, "GRIB", 4) != 0 || msg[7] != 1)
        return -1;
    for (int i = 0; i < 32; ++i) meta[i] = 0;
    meta[0] = be(msg + 4, 3);
    const uint8_t* pds = msg + 8;
    long pdslen = be(pds, 3);
    meta[1] = pds[3];
    meta[2] = pds[4];
    meta[3] = pds[5];
    meta[4] = pds[6];
    int flags = pds[7];
    meta[5] = pds[8];
    meta[6] = pds[9];
    meta[7] = be(pds + 10, 2);
    int yy = pds[12], mm = pds[13], dd = pds[14], hh = pds[15], mi = pds[16];
    int century = pds[24];
    long year = (century - 1) * 100 + yy;
    meta[8] = year * 10000L + mm * 100L + dd;
    meta[9] = hh * 100L + mi;
    meta[10] = pds[17];
    meta[11] = pds[18];
    meta[12] = pds[19];
    meta[13] = pds[20];
    meta[30] = pds[25];
    meta[27] = sm(pds + 26, 2);

    const uint8_t* p = pds + pdslen;
    long nvals = 0;
    if (flags & 0x80) {  // GDS
        long gdslen = be(p, 3);
        int nv = p[3], pv = p[4];
        meta[14] = p[5];
        uint32_t ni = be(p + 6, 2), nj = be(p + 8, 2);
        meta[15] = (ni == 0xffff) ? -1 : (int64_t)ni;
        meta[16] = nj;
        meta[17] = sm(p + 10, 3);
        meta[18] = sm(p + 13, 3);
        meta[19] = sm(p + 17, 3);
        meta[20] = sm(p + 20, 3);
        uint32_t di = be(p + 23, 2);
        meta[21] = (di == 0xffff) ? -1 : (int64_t)di;
        meta[22] = be(p + 25, 2);
        meta[23] = p[27];
        // PL list of row lengths (reduced grids)
        if (meta[15] == -1 && pv > 0) {
            long npl = (gdslen - (pv - 1)) / 2 - nv * 2;
            // standard: PL starts after PV (nv 4-byte IBM floats)
            const uint8_t* plp = p + (pv - 1) + nv * 4;
            npl = (p + gdslen - plp) / 2;
            if (npl > pl_cap) return -3;
            meta[26] = npl;
            for (long i = 0; i < npl; ++i) {
                pl[i] = be(plp + 2 * i, 2);
                nvals += pl[i];
            }
        } else {
            nvals = (long)meta[15] * (long)meta[16];
        }
        p += gdslen;
    }
    if (flags & 0x40) {  // BMS
        long bmslen = be(p, 3);
        meta[25] = 1;
        p += bmslen;
    }
    // BDS
    long bdslen = be(p, 3);
    meta[28] = sm(p + 4, 2);
    meta[29] = p[10];
    if (meta[29] > 0 && nvals == 0) {
        int unused = p[3] & 0x0f;
        nvals = ((bdslen - 11) * 8 - unused) / meta[29];
    }
    meta[24] = nvals;
    return 0;
}

int g1_values(const uint8_t* msg, long len, double* out, long nvals,
              double missing) {
    int64_t meta[32];
    int64_t pl_dummy[8192];
    if (g1_info(msg, len, meta, pl_dummy, 8192) != 0) return -1;
    if (meta[24] != nvals) return -2;
    const uint8_t* pds = msg + 8;
    long pdslen = be(pds, 3);
    int flags = pds[7];
    const uint8_t* p = pds + pdslen;
    if (flags & 0x80) p += be(p, 3);
    const uint8_t* bitmap = nullptr;
    if (flags & 0x40) {
        bitmap = p + 6;
        p += be(p, 3);
    }
    long bdslen = be(p, 3);
    (void)bdslen;
    int binscale = sm(p + 4, 2);
    double ref = ibm_to_double(p + 6);
    int nbits = p[10];
    const uint8_t* data = p + 11;
    double dscale = std::pow(10.0, -(double)meta[27]);
    double bscale = std::ldexp(1.0, binscale);

    long bitpos = 0;
    for (long i = 0; i < nvals; ++i) {
        bool present = true;
        if (bitmap) present = (bitmap[i >> 3] >> (7 - (i & 7))) & 1;
        if (!present) { out[i] = missing; continue; }
        if (nbits == 0) { out[i] = ref * dscale; continue; }
        uint64_t x = 0;
        long bp = bitpos;
        for (int b = 0; b < nbits; ++b, ++bp)
            x = (x << 1) | ((data[bp >> 3] >> (7 - (bp & 7))) & 1);
        bitpos = bp;
        out[i] = (ref + (double)x * bscale) * dscale;
    }
    return 0;
}

// Encode one message. values: nvals doubles (missing where == missing and
// use_bitmap). pl: row lengths (npl>0 → reduced grid). Returns message
// length or <0 on error.
long g1_encode(const double* values, long nvals, const int64_t* meta,
               const int64_t* pl, uint8_t* out, long cap,
               double missing, int use_bitmap) {
    int nbits = meta[29] > 0 ? (int)meta[29] : 16;
    long npl = meta[26];

    // min/max over present values
    double vmin = 0, vmax = 0;
    bool any = false;
    std::vector<uint8_t> bitmap;
    long npresent = 0;
    if (use_bitmap) bitmap.assign((nvals + 7) / 8, 0);
    for (long i = 0; i < nvals; ++i) {
        bool present = !(use_bitmap && values[i] == missing);
        if (present) {
            if (!any) { vmin = vmax = values[i]; any = true; }
            else { vmin = std::min(vmin, values[i]);
                   vmax = std::max(vmax, values[i]); }
            ++npresent;
            if (use_bitmap) bitmap[i >> 3] |= (uint8_t)(1 << (7 - (i & 7)));
        }
    }
    if (!any) { vmin = vmax = 0.0; }

    int dscale_i = (int)meta[27];
    double dmul = std::pow(10.0, (double)dscale_i);
    double smin = vmin * dmul, smax = vmax * dmul;
    int binscale = 0;
    double range = smax - smin;
    uint64_t maxint = (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1);
    if (range > 0) {
        binscale = (int)std::ceil(std::log2(range / (double)maxint));
        while (std::ldexp((double)maxint, binscale) < range) ++binscale;
    }
    uint8_t refbytes[4];
    double_to_ibm(smin, refbytes);
    double ref = ibm_to_double(refbytes);  // the exact stored reference
    double bscale_inv = std::ldexp(1.0, -binscale);

    // section sizes
    long pdslen = 28;
    long gdslen = 32 + (npl > 0 ? 2 * npl : 0);
    long bmslen = use_bitmap ? 6 + (long)bitmap.size() : 0;
    long databits = npresent * (long)nbits;
    long databytes = (databits + 7) / 8;
    long bdslen = 11 + databytes;
    if (bdslen % 2) ++bdslen;  // even length padding
    long total = 8 + pdslen + gdslen + bmslen + bdslen + 4;
    if (total > cap) return -1;

    uint8_t* p = out;
    std::memcpy(p, "GRIB", 4);
    put_be(p + 4, (uint32_t)total, 3);
    p[7] = 1;
    p += 8;

    // PDS
    std::memset(p, 0, pdslen);
    put_be(p, (uint32_t)pdslen, 3);
    p[3] = (uint8_t)meta[1];
    p[4] = (uint8_t)meta[2];
    p[5] = (uint8_t)meta[3];
    p[6] = (uint8_t)meta[4];
    p[7] = 0x80 | (use_bitmap ? 0x40 : 0);
    p[8] = (uint8_t)meta[5];
    p[9] = (uint8_t)meta[6];
    put_be(p + 10, (uint32_t)meta[7], 2);
    long date = meta[8];
    long year = date / 10000, mon = (date / 100) % 100, day = date % 100;
    int century = (int)((year - 1) / 100 + 1);
    p[12] = (uint8_t)(year - (century - 1) * 100);
    p[13] = (uint8_t)mon;
    p[14] = (uint8_t)day;
    p[15] = (uint8_t)(meta[9] / 100);
    p[16] = (uint8_t)(meta[9] % 100);
    p[17] = (uint8_t)meta[10];
    p[18] = (uint8_t)meta[11];
    p[19] = (uint8_t)meta[12];
    p[20] = (uint8_t)meta[13];
    p[24] = (uint8_t)century;
    p[25] = (uint8_t)meta[30];
    put_sm(p + 26, dscale_i, 2);
    p += pdslen;

    // GDS
    std::memset(p, 0, gdslen);
    put_be(p, (uint32_t)gdslen, 3);
    p[3] = 0;
    p[4] = (npl > 0) ? 33 : 0xff;  // PV/PL offset (1-based)
    p[5] = (uint8_t)meta[14];
    if (meta[15] < 0) put_be(p + 6, 0xffff, 2);
    else put_be(p + 6, (uint32_t)meta[15], 2);
    put_be(p + 8, (uint32_t)meta[16], 2);
    put_sm(p + 10, (int32_t)meta[17], 3);
    put_sm(p + 13, (int32_t)meta[18], 3);
    p[16] = 0x80;  // resolution/component flags: direction increments given
    put_sm(p + 17, (int32_t)meta[19], 3);
    put_sm(p + 20, (int32_t)meta[20], 3);
    if (meta[21] < 0) put_be(p + 23, 0xffff, 2);
    else put_be(p + 23, (uint32_t)meta[21], 2);
    put_be(p + 25, (uint32_t)meta[22], 2);
    p[27] = (uint8_t)meta[23];
    for (long i = 0; i < npl; ++i)
        put_be(p + 32 + 2 * i, (uint32_t)pl[i], 2);
    p += gdslen;

    // BMS
    if (use_bitmap) {
        std::memset(p, 0, 6);
        put_be(p, (uint32_t)bmslen, 3);
        put_be(p + 4, 0, 2);  // no predefined bitmap
        std::memcpy(p + 6, bitmap.data(), bitmap.size());
        p += bmslen;
    }

    // BDS
    std::memset(p, 0, bdslen);
    put_be(p, (uint32_t)bdslen, 3);
    long unused = bdslen * 8 - 88 - databits;
    p[3] = (uint8_t)(unused & 0x0f);
    put_sm(p + 4, binscale, 2);
    std::memcpy(p + 6, refbytes, 4);
    p[10] = (uint8_t)nbits;
    uint8_t* data = p + 11;
    long bitpos = 0;
    for (long i = 0; i < nvals; ++i) {
        if (use_bitmap && values[i] == missing) continue;
        double s = values[i] * dmul;
        double xd = (s - ref) * bscale_inv;
        uint64_t x = (xd <= 0) ? 0 : (uint64_t)std::llround(xd);
        if (x > maxint) x = maxint;
        for (int b = nbits - 1; b >= 0; --b, ++bitpos) {
            if ((x >> b) & 1)
                data[bitpos >> 3] |= (uint8_t)(1 << (7 - (bitpos & 7)));
        }
    }
    p += bdslen;
    std::memcpy(p, "7777", 4);
    return total;
}

}  // extern "C"
