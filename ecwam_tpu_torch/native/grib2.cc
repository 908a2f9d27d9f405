// GRIB edition-2 codec (simple packing, template 5.0) — native equivalent
// of the eccodes GRIB2 subset ecWAM uses (reference: src/ecwam/yowgrib.F90
// IGRIB_* wrappers; wgribencode.F90 encodes edition 1 or 2 depending on
// the parameter table).  Supports:
//   - grid templates 3.0 (lat-lon) and 3.40 (Gaussian), regular and
//     reduced (PL list, 2-octet entries)
//   - product template 4.0, data representation 5.0 (simple packing,
//     IEEE-754 reference value), bitmap section 6
//
// C ABI mirrors grib1.cc: the same 32-slot int64 meta array, with
// edition-2 reinterpretations:
//   slot 1  tablesVersion        slot 4  discipline
//   slot 5  parameterCategory*1000 + parameterNumber
//   slot 11 forecastTime (in units of slot 10)
//   lat/lon/increment slots stay in MILLIdegrees at the ABI (the codec
//   converts to the wire's microdegrees), so the Python layer is
//   edition-agnostic.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t be(const uint8_t* p, int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
    return v;
}

inline int64_t sm(const uint8_t* p, int n) {  // sign-magnitude signed int
    uint64_t v = be(p, n);
    uint64_t signbit = 1ull << (8 * n - 1);
    return (v & signbit) ? -(int64_t)(v & (signbit - 1)) : (int64_t)v;
}

inline void put_be(uint8_t* p, uint64_t v, int n) {
    for (int i = n - 1; i >= 0; --i) { p[i] = v & 0xff; v >>= 8; }
}

inline void put_sm(uint8_t* p, int64_t v, int n) {
    uint64_t m = (v < 0) ? (uint64_t)(-v) : (uint64_t)v;
    put_be(p, m, n);
    if (v < 0) p[0] |= 0x80;
}

double ieee_to_double(const uint8_t* p) {
    uint32_t u = (uint32_t)be(p, 4);
    float f;
    std::memcpy(&f, &u, 4);
    return (double)f;
}

void double_to_ieee(double x, uint8_t* p) {
    float f = (float)x;
    uint32_t u;
    std::memcpy(&u, &f, 4);
    put_be(p, u, 4);
}

constexpr uint32_t MISS4 = 0xffffffffu;

}  // namespace

extern "C" {

// Find the next GRIB2 message at/after *offset.
int g2_next(const uint8_t* buf, long len, long* offset, long* msglen) {
    for (long i = *offset; i + 16 <= len; ++i) {
        if (buf[i] == 'G' && buf[i+1] == 'R' && buf[i+2] == 'I' &&
            buf[i+3] == 'B' && buf[i+7] == 2) {
            long tl = (long)be(buf + i + 8, 8);
            if (i + tl <= len && tl >= 32) {
                *offset = i;
                *msglen = tl;
                return 0;
            }
        }
    }
    return -1;
}

// Walk sections; fills meta (32 int64 slots, grib1.cc layout) + PL.
int g2_info(const uint8_t* msg, long len, int64_t* meta, int64_t* pl,
            long pl_cap) {
    if (len < 32 || std::memcmp(msg, "GRIB", 4) != 0 || msg[7] != 2)
        return -1;
    for (int i = 0; i < 32; ++i) meta[i] = 0;
    meta[0] = (int64_t)be(msg + 8, 8);
    meta[4] = msg[6];                     // discipline
    meta[15] = -1;                        // Ni default: reduced/unknown
    const uint8_t* p = msg + 16;
    const uint8_t* end = msg + len;
    long nvals = 0;
    while (p + 4 <= end && std::memcmp(p, "7777", 4) != 0) {
        long slen = (long)be(p, 4);
        if (slen < 5 || p + slen > end) return -2;
        int snum = p[4];
        if (snum == 1) {                  // identification
            meta[2] = (int64_t)be(p + 5, 2);
            meta[30] = (int64_t)be(p + 7, 2);
            meta[1] = p[9];
            long year = (long)be(p + 12, 2);
            meta[8] = year * 10000L + p[14] * 100L + p[15];
            meta[9] = p[16] * 100L + p[17];
        } else if (snum == 3) {           // grid definition
            long ndata = (long)be(p + 6, 4);
            int noct = p[10];
            int tmpl = (int)be(p + 12, 2);
            meta[14] = (tmpl == 40) ? 4 : 0;   // map back to GRIB1 gridType
            const uint8_t* t = p + 14;
            uint32_t ni = (uint32_t)be(t + 16, 4);
            uint32_t nj = (uint32_t)be(t + 20, 4);
            meta[15] = (ni == MISS4) ? -1 : (int64_t)ni;
            meta[16] = nj;
            meta[17] = sm(t + 32, 4) / 1000;   // microdeg → millideg
            meta[18] = sm(t + 36, 4) / 1000;
            meta[19] = sm(t + 41, 4) / 1000;
            meta[20] = sm(t + 45, 4) / 1000;
            uint32_t di = (uint32_t)be(t + 49, 4);
            meta[21] = (di == MISS4) ? -1 : (int64_t)(di / 1000);
            uint32_t dj = (uint32_t)be(t + 53, 4);
            meta[22] = (tmpl == 40) ? (int64_t)dj
                                    : (dj == MISS4 ? -1 : (int64_t)(dj / 1000));
            meta[23] = t[57];
            if (noct > 0) {               // PL list after the template
                const uint8_t* plp = t + 58;
                long npl = (p + slen - plp) / noct;
                if (npl > pl_cap) return -3;
                meta[26] = npl;
                for (long i = 0; i < npl; ++i)
                    pl[i] = (int64_t)be(plp + noct * i, noct);
            }
            nvals = ndata;
        } else if (snum == 4) {           // product definition (4.0)
            const uint8_t* t = p + 9;
            meta[5] = (int64_t)t[0] * 1000 + t[1];
            meta[3] = t[5];               // generatingProcessIdentifier
            meta[10] = t[8];              // unit of time
            meta[11] = sm(t + 9, 4);      // forecast time
            meta[6] = t[13];              // typeOfFirstFixedSurface
            meta[7] = (int64_t)be(t + 15, 4);
        } else if (snum == 5) {           // data representation (5.0)
            meta[28] = sm(p + 15, 2);
            meta[27] = sm(p + 17, 2);
            meta[29] = p[19];
        } else if (snum == 6) {
            if (p[5] == 0) meta[25] = 1;
        }
        p += slen;
    }
    meta[24] = nvals;
    return 0;
}

int g2_values(const uint8_t* msg, long len, double* out, long nvals,
              double missing) {
    int64_t meta[32];
    int64_t pl_dummy[8192];
    if (g2_info(msg, len, meta, pl_dummy, 8192) != 0) return -1;
    if (meta[24] != nvals) return -2;
    const uint8_t* p = msg + 16;
    const uint8_t* end = msg + len;
    const uint8_t* bitmap = nullptr;
    double ref = 0.0;
    int binscale = 0, nbits = 0;
    double dscale = 1.0;
    const uint8_t* data = nullptr;
    while (p + 4 <= end && std::memcmp(p, "7777", 4) != 0) {
        long slen = (long)be(p, 4);
        int snum = p[4];
        if (snum == 5) {
            ref = ieee_to_double(p + 11);
            binscale = (int)sm(p + 15, 2);
            dscale = std::pow(10.0, -(double)sm(p + 17, 2));
            nbits = p[19];
        } else if (snum == 6) {
            if (p[5] == 0) bitmap = p + 6;
        } else if (snum == 7) {
            data = p + 5;
        }
        p += slen;
    }
    if (!data && nbits > 0) return -4;
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

long g2_encode(const double* values, long nvals, const int64_t* meta,
               const int64_t* pl, uint8_t* out, long cap,
               double missing, int use_bitmap) {
    int nbits = meta[29] > 0 ? (int)meta[29] : 16;
    long npl = meta[26];

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
    // IEEE float32 reference, rounded down so stored ref <= all values
    uint8_t refbytes[4];
    double_to_ieee(smin, refbytes);
    double ref = ieee_to_double(refbytes);
    if (ref > smin) {
        uint32_t u = (uint32_t)be(refbytes, 4);
        u -= 1;                            // previous representable float
        put_be(refbytes, u, 4);
        ref = ieee_to_double(refbytes);
    }
    double bscale_inv = std::ldexp(1.0, -binscale);

    long sec1 = 21;
    long sec3 = 14 + 58 + (npl > 0 ? 2 * npl : 0);
    long sec4 = 34;
    long sec5 = 21;
    long databits = npresent * (long)nbits;
    long databytes = (databits + 7) / 8;
    long sec6 = use_bitmap ? 6 + (long)bitmap.size() : 6;
    long sec7 = 5 + databytes;
    long total = 16 + sec1 + sec3 + sec4 + sec5 + sec6 + sec7 + 4;
    if (total > cap) return -1;

    uint8_t* p = out;
    // section 0
    std::memcpy(p, "GRIB", 4);
    p[4] = 0; p[5] = 0;
    p[6] = (uint8_t)meta[4];              // discipline
    p[7] = 2;
    put_be(p + 8, (uint64_t)total, 8);
    p += 16;

    // section 1: identification
    std::memset(p, 0, sec1);
    put_be(p, (uint64_t)sec1, 4);
    p[4] = 1;
    put_be(p + 5, (uint64_t)meta[2], 2);
    put_be(p + 7, (uint64_t)meta[30], 2);
    p[9] = meta[1] ? (uint8_t)meta[1] : 32;   // tablesVersion
    p[10] = 0;                                // localTablesVersion
    p[11] = 1;                                // significance: start of fc
    long date = meta[8];
    put_be(p + 12, (uint64_t)(date / 10000), 2);
    p[14] = (uint8_t)((date / 100) % 100);
    p[15] = (uint8_t)(date % 100);
    p[16] = (uint8_t)(meta[9] / 100);
    p[17] = (uint8_t)(meta[9] % 100);
    p[18] = 0;
    p[19] = 0;                                // production status
    p[20] = 1;                                // processed data: forecast
    p += sec1;

    // section 3: grid definition
    std::memset(p, 0, sec3);
    put_be(p, (uint64_t)sec3, 4);
    p[4] = 3;
    p[5] = 0;                                 // source: template
    put_be(p + 6, (uint64_t)nvals, 4);
    p[10] = (npl > 0) ? 2 : 0;                // octets per PL entry
    p[11] = (npl > 0) ? 1 : 0;                // interpretation: parallels
    int tmpl = (meta[14] == 4) ? 40 : 0;
    put_be(p + 12, (uint64_t)tmpl, 2);
    uint8_t* t = p + 14;
    t[0] = 6;                                 // shapeOfEarth: sphere 6371229
    std::memset(t + 1, 0xff, 15);             // radius/axes: missing
    if (meta[15] < 0) put_be(t + 16, MISS4, 4);
    else put_be(t + 16, (uint64_t)meta[15], 4);
    put_be(t + 20, (uint64_t)meta[16], 4);
    put_be(t + 24, 0, 4);                     // basic angle
    put_be(t + 28, MISS4, 4);                 // subdivisions: missing
    put_sm(t + 32, meta[17] * 1000, 4);       // millideg → microdeg
    put_sm(t + 36, meta[18] * 1000, 4);
    t[40] = 0x30;                             // i/j increments given
    put_sm(t + 41, meta[19] * 1000, 4);
    put_sm(t + 45, meta[20] * 1000, 4);
    if (meta[21] < 0) put_be(t + 49, MISS4, 4);
    else put_be(t + 49, (uint64_t)(meta[21] * 1000), 4);
    if (tmpl == 40) put_be(t + 53, (uint64_t)meta[22], 4);
    else if (meta[22] < 0) put_be(t + 53, MISS4, 4);
    else put_be(t + 53, (uint64_t)(meta[22] * 1000), 4);
    t[57] = (uint8_t)meta[23];
    for (long i = 0; i < npl; ++i)
        put_be(t + 58 + 2 * i, (uint64_t)pl[i], 2);
    p += sec3;

    // section 4: product definition, template 4.0
    std::memset(p, 0, sec4);
    put_be(p, (uint64_t)sec4, 4);
    p[4] = 4;
    put_be(p + 5, 0, 2);                      // no coordinate values
    put_be(p + 7, 0, 2);                      // template 4.0
    uint8_t* q = p + 9;
    q[0] = (uint8_t)(meta[5] / 1000);         // parameterCategory
    q[1] = (uint8_t)(meta[5] % 1000);         // parameterNumber
    q[2] = 2;                                 // genProcess: forecast
    q[3] = 0;
    q[4] = 0;
    q[5] = (uint8_t)meta[3];                  // generatingProcessId
    put_be(q + 6, 0, 2);
    q[8] = (uint8_t)meta[10];                 // unit of time
    put_sm(q + 9, meta[11], 4);               // forecast time
    q[13] = meta[6] ? (uint8_t)meta[6] : 1;   // surface: ground/water
    q[14] = 0;
    put_be(q + 15, (uint64_t)meta[7], 4);
    q[19] = 0xff;                             // second surface: missing
    q[20] = 0xff;
    put_be(q + 21, MISS4, 4);
    p += sec4;

    // section 5: data representation, template 5.0
    std::memset(p, 0, sec5);
    put_be(p, (uint64_t)sec5, 4);
    p[4] = 5;
    put_be(p + 5, (uint64_t)npresent, 4);
    put_be(p + 9, 0, 2);                      // template 5.0
    std::memcpy(p + 11, refbytes, 4);
    put_sm(p + 15, binscale, 2);
    put_sm(p + 17, dscale_i, 2);
    p[19] = (uint8_t)nbits;
    p[20] = 0;                                // floating point values
    p += sec5;

    // section 6: bitmap
    put_be(p, (uint64_t)sec6, 4);
    p[4] = 6;
    p[5] = use_bitmap ? 0 : 255;
    if (use_bitmap) std::memcpy(p + 6, bitmap.data(), bitmap.size());
    p += sec6;

    // section 7: data
    std::memset(p, 0, sec7);
    put_be(p, (uint64_t)sec7, 4);
    p[4] = 7;
    uint8_t* data = p + 5;
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
    p += sec7;
    std::memcpy(p, "7777", 4);
    return total;
}

}  // extern "C"
