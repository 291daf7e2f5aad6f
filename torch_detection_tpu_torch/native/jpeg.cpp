// Baseline JPEG decoder: sequential Huffman, 8-bit, one or three components.
//
// It gives the pixels libjpeg-turbo gives under its defaults (the output of
// cv2.imread(path, IMREAD_COLOR) before any EXIF orientation):
//   * the integer "islow" IDCT of jidctint.c with its dequantisation and its
//     post-IDCT range limit;
//   * fancy upsampling (jdsample.c): h2v1 and h2v2 triangle filters when the
//     component is wider than two samples, box replication otherwise, h1v2
//     always; the edge rows replicated as jdmainct.c's context rows are;
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c, range-limited;
//   * the colour space of three components by jdapimin.c's rules: JFIF means
//     YCbCr, else the Adobe APP14 transform flag, else component ids 'R',
//     'G', 'B' mean RGB, and anything else YCbCr.
// Output is interleaved BGR (or RGB on request), a gray image repeated to
// three channels.
//
// Refused with status 1 (unsupported): progressive, arithmetic-coded,
// lossless, hierarchical and 12-bit files, two or four components, sampling
// factors other than 4:4:4, 4:2:2, 4:2:0 and 4:4:0, and DNL heights.
// Refused with status 2 (corrupt): a truncated or corrupt entropy stream, a
// wrong restart marker, a Huffman code outside its table. libjpeg warns and
// fills the rest with grey instead.
//
// Plain C++17, no intrinsics. The C interface is td_jpeg_info and
// td_jpeg_decode; neither keeps state between calls.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kOk = 0, kUnsupported = 1, kCorrupt = 2;

struct Failure {
  int status;
  std::string message;
};

[[noreturn]] void fail(int status, const std::string& message) { throw Failure{status, message}; }

const int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                         12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                         35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                         58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];
  uint8_t look_val[1 << kLookBits];
  // AC tables: a code and its magnitude bits within the lookahead, resolved
  // at once: (value << 8) | (run << 4) | bits consumed; 0 where they do not fit
  int16_t fast_ac[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t values[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;      // Huffman tables of the current scan
  int bw = 0, bh = 0;      // blocks a row and rows of blocks, padded to whole MCUs
  int dw = 0, dh = 0;      // downsampled width and height (jdinput.c)
  bool scanned = false;
  std::vector<uint8_t> plane;  // bw * 8 by bh * 8 samples
};

struct Header {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  long app1_offset = -1, app1_length = 0;
  Component comp[3];
  uint16_t quant[4][64];  // natural order
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
};

const char* sof_kind(int marker) {
  switch (marker) {
    case 0xC2: return "progressive (SOF2)";
    case 0xC3: return "lossless (SOF3)";
    case 0xC5: return "differential sequential (SOF5)";
    case 0xC6: return "differential progressive (SOF6)";
    case 0xC7: return "differential lossless (SOF7)";
    case 0xC9: return "arithmetic-coded sequential (SOF9)";
    case 0xCA: return "arithmetic-coded progressive (SOF10)";
    case 0xCB: return "arithmetic-coded lossless (SOF11)";
    case 0xCD: return "arithmetic-coded differential sequential (SOF13)";
    case 0xCE: return "arithmetic-coded differential progressive (SOF14)";
    case 0xCF: return "arithmetic-coded differential lossless (SOF15)";
    default: return nullptr;
  }
}

void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* values, int nvalues) {
  int sizes[257], codes[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) sizes[p++] = l;
  sizes[p] = 0;
  if (p != nvalues || p > 256) fail(kCorrupt, "bad Huffman table");
  int code = 0, si = sizes[0];
  p = 0;
  while (sizes[p]) {
    while (sizes[p] == si) codes[p++] = code++;
    if (code >= (1 << si)) fail(kCorrupt, "bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      t.valoffset[l] = p - codes[p];
      p += counts[l - 1];
      t.maxcode[l] = codes[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look_len, 0, sizeof(t.look_len));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      int look = codes[p] << (kLookBits - l);
      for (int c = 0; c < (1 << (kLookBits - l)); ++c) {
        t.look_len[look + c] = static_cast<uint8_t>(l);
        t.look_val[look + c] = values[p];
      }
    }
  }
  std::memcpy(t.values, values, nvalues);
  for (int look = 0; look < (1 << kLookBits); ++look) {
    t.fast_ac[look] = 0;
    int len = t.look_len[look];
    if (!len) continue;
    int rs = t.look_val[look], run = rs >> 4, size = rs & 15;
    if (size == 0 || len + size > kLookBits) continue;
    int bits = (look >> (kLookBits - len - size)) & ((1 << size) - 1);
    int value = bits < (1 << (size - 1)) ? bits - (1 << size) + 1 : bits;
    t.fast_ac[look] = static_cast<int16_t>(value * 256 + (run << 4) + len + size);
  }
  t.defined = true;
}

// MSB-first bit reader over the entropy-coded segment; stops at a marker and
// feeds zeros beyond it, counting them so that a read past the data fails.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf = 0;
  int bits = 0;       // valid bits in buf (low end)
  int padding = 0;    // how many of them are zeros past a marker or the end
  bool at_marker = false;

  void fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && pos < size) {
        byte = data[pos];
        if (byte == 0xFF) {
          size_t q = pos + 1;
          while (q < size && data[q] == 0xFF) ++q;  // fill bytes
          if (q < size && data[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
            pos = q - 1;
            byte = 0;
            padding += 8;
          }
        } else {
          ++pos;
        }
      } else {
        at_marker = true;
        padding += 8;
      }
      buf = (buf << 8) | byte;
      bits += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (bits < n) fill();
    return static_cast<uint32_t>(buf >> (bits - n)) & ((1u << n) - 1);
  }
  inline void skip(int n) { bits -= n; }
  inline int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    bits -= n;
    return static_cast<int>(v);
  }
  inline bool overran() const { return bits < padding; }
  void reset() {  // at a restart marker or the end of a scan
    buf = 0;
    bits = 0;
    padding = 0;
  }
};

inline int decode_symbol(BitReader& br, const Huffman& t) {
  uint32_t look = br.peek(kLookBits);
  int len = t.look_len[look];
  if (len) {
    br.skip(len);
    return t.look_val[look];
  }
  uint32_t code16 = br.peek(16);
  for (int l = kLookBits + 1; l <= 16; ++l) {
    int32_t code = static_cast<int32_t>(code16 >> (16 - l));
    if (code <= t.maxcode[l]) {
      br.skip(l);
      return t.values[(t.valoffset[l] + code) & 0xFF];
    }
  }
  fail(kCorrupt, "corrupt JPEG data: bad Huffman code");
}

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

// jidctint.c, jpeg_idct_islow, with CONST_BITS 13 and PASS1_BITS 2.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

struct IdctLimit {
  uint8_t t[1024];
  IdctLimit() {
    // jdmaster.c's post-IDCT table indexed by (x & 1023): x in [-128, 127]
    // gives x + 128, larger positive values 255, larger negative values 0.
    for (int i = 0; i < 1024; ++i) {
      int x = i < 512 ? i : i - 1024;
      int v = x + 128;
      t[i] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const IdctLimit kIdctLimit;

// The butterfly of jpeg_idct_islow on one column (dequantised) or one row:
// the eight outputs scaled by 2^CONST_BITS, before each pass's descale.
inline void idct8(const int32_t* x, int32_t* y) {
  int32_t z2 = x[2], z3 = x[6];
  int32_t z1 = (z2 + z3) * F0541;
  int32_t tmp2 = z1 + z3 * -F1847;
  int32_t tmp3 = z1 + z2 * F0765;
  int32_t tmp0 = (x[0] + x[4]) * (1 << kConstBits);
  int32_t tmp1 = (x[0] - x[4]) * (1 << kConstBits);
  int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = x[7];
  tmp1 = x[5];
  tmp2 = x[3];
  tmp3 = x[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int32_t z4 = tmp1 + tmp3;
  int32_t z5 = (z3 + z4) * F1175;
  tmp0 *= F0298;
  tmp1 *= F2053;
  tmp2 *= F3072;
  tmp3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 *= -F1961;
  z4 *= -F0390;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  y[0] = tmp10 + tmp3;
  y[7] = tmp10 - tmp3;
  y[1] = tmp11 + tmp2;
  y[6] = tmp11 - tmp2;
  y[2] = tmp12 + tmp1;
  y[5] = tmp12 - tmp1;
  y[3] = tmp13 + tmp0;
  y[4] = tmp13 - tmp0;
}

// Dequantise a block (coefficients and table in natural order) and write its
// 8 x 8 samples. A column or row whose AC terms are all zero takes
// libjpeg's shortcut, which gives the same values.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64], x[8], y[8];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    if (!(in[8] | in[16] | in[24] | in[32] | in[40] | in[48] | in[56])) {
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = in[0] * q[c] * (1 << kPass1Bits);
      continue;
    }
    for (int k = 0; k < 8; ++k) x[k] = in[8 * k] * q[8 * k + c];
    idct8(x, y);
    for (int r = 0; r < 8; ++r) ws[r * 8 + c] = descale(y[r], kConstBits - kPass1Bits);
  }
  const uint8_t* lim = kIdctLimit.t;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      uint8_t v = lim[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    idct8(w, y);
    for (int c = 0; c < 8; ++c) o[c] = lim[descale(y[c], kConstBits + kPass1Bits + 3) & 1023];
  }
}

inline int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// Parses markers up to the first SOS (decode == false) or through the whole
// file, decoding each scan (decode == true).
struct Decoder {
  const uint8_t* data;
  size_t size;
  Header hd;
  bool have_frame = false;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  // Position of the next marker at or after pos (skipping fill bytes).
  int next_marker(size_t& pos) {
    while (pos < size && data[pos] != 0xFF) ++pos;  // libjpeg skips garbage too
    while (pos < size && data[pos] == 0xFF) ++pos;
    if (pos >= size) return -1;
    return data[pos++];
  }

  const uint8_t* segment(size_t& pos, int& len) {
    if (pos + 2 > size) fail(kCorrupt, "truncated JPEG marker segment");
    len = u16(data + pos) - 2;
    if (len < 0 || pos + 2 + len > size) fail(kCorrupt, "truncated JPEG marker segment");
    const uint8_t* p = data + pos + 2;
    pos += 2 + len;
    return p;
  }

  void read_sof(int marker, const uint8_t* p, int len) {
    if (have_frame) fail(kCorrupt, "JPEG with two frame headers");
    if (const char* kind = sof_kind(marker))
      fail(kUnsupported, std::string(kind) + " JPEG is not supported: baseline sequential "
                                             "Huffman only");
    if (len < 6) fail(kCorrupt, "bad JPEG frame header");
    int precision = p[0];
    if (precision != 8)
      fail(kUnsupported, std::to_string(precision) + "-bit JPEG is not supported: 8-bit only");
    hd.height = u16(p + 1);
    hd.width = u16(p + 3);
    hd.ncomp = p[5];
    if (hd.height == 0)
      fail(kUnsupported, "JPEG with its height in a DNL marker is not supported");
    if (hd.width == 0) fail(kCorrupt, "JPEG of width 0");
    if (hd.ncomp == 4)
      fail(kUnsupported, "four-component (CMYK/YCCK) JPEG is not supported: gray or YCbCr only");
    if (hd.ncomp != 1 && hd.ncomp != 3)
      fail(kUnsupported, std::to_string(hd.ncomp) + "-component JPEG is not supported: gray or "
                                                    "YCbCr only");
    if (len < 6 + 3 * hd.ncomp) fail(kCorrupt, "bad JPEG frame header");
    for (int i = 0; i < hd.ncomp; ++i) {
      Component& c = hd.comp[i];
      c.id = p[6 + 3 * i];
      c.h = p[7 + 3 * i] >> 4;
      c.v = p[7 + 3 * i] & 15;
      c.tq = p[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(kCorrupt, "bad JPEG frame header");
      if (c.h > hd.hmax) hd.hmax = c.h;
      if (c.v > hd.vmax) hd.vmax = c.v;
    }
    if (hd.ncomp == 1) {  // a single component is never subsampled
      hd.comp[0].h = hd.comp[0].v = hd.hmax = hd.vmax = 1;
    }
    std::string factors;
    bool ok = true;
    for (int i = 0; i < hd.ncomp; ++i) {
      const Component& c = hd.comp[i];
      factors += (i ? "," : "") + std::to_string(c.h) + "x" + std::to_string(c.v);
      int rh = hd.hmax / c.h, rv = hd.vmax / c.v;
      if (hd.hmax % c.h || hd.vmax % c.v || rh > 2 || rv > 2) ok = false;
    }
    if (!ok)
      fail(kUnsupported, "JPEG sampling factors " + factors + " are not supported: 4:4:4, "
                         "4:2:2, 4:2:0 and 4:4:0 only");
    hd.mcux = (hd.width + 8 * hd.hmax - 1) / (8 * hd.hmax);
    hd.mcuy = (hd.height + 8 * hd.vmax - 1) / (8 * hd.vmax);
    for (int i = 0; i < hd.ncomp; ++i) {
      Component& c = hd.comp[i];
      c.bw = hd.mcux * c.h;
      c.bh = hd.mcuy * c.v;
      c.dw = static_cast<int>((static_cast<long>(hd.width) * c.h + hd.hmax - 1) / hd.hmax);
      c.dh = static_cast<int>((static_cast<long>(hd.height) * c.v + hd.vmax - 1) / hd.vmax);
    }
    have_frame = true;
  }

  void read_dqt(const uint8_t* p, int len) {
    int i = 0;
    while (i < len) {
      int pq = p[i] >> 4, tq = p[i] & 15;
      if (tq > 3 || pq > 1) fail(kCorrupt, "bad JPEG quantisation table");
      int n = pq ? 128 : 64;
      if (i + 1 + n > len) fail(kCorrupt, "bad JPEG quantisation table");
      for (int k = 0; k < 64; ++k)
        hd.quant[tq][kZigzag[k]] =
            static_cast<uint16_t>(pq ? u16(p + i + 1 + 2 * k) : p[i + 1 + k]);
      hd.quant_defined[tq] = true;
      i += 1 + n;
    }
  }

  void read_dht(const uint8_t* p, int len) {
    int i = 0;
    while (i < len) {
      if (i + 17 > len) fail(kCorrupt, "bad JPEG Huffman table");
      int tc = p[i] >> 4, th = p[i] & 15;
      if (tc > 1 || th > 3) fail(kCorrupt, "bad JPEG Huffman table");
      int n = 0;
      for (int l = 0; l < 16; ++l) n += p[i + 1 + l];
      if (n > 256 || i + 17 + n > len) fail(kCorrupt, "bad JPEG Huffman table");
      build_huffman(tc ? hd.ac[th] : hd.dc[th], p + i + 1, p + i + 17, n);
      i += 17 + n;
    }
  }

  void read_app(int marker, const uint8_t* p, int len, size_t offset) {
    if (marker == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) hd.jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      hd.adobe = true;
      hd.adobe_transform = p[11];
    }
    if (marker == 0xE1 && hd.app1_offset < 0) {
      hd.app1_offset = static_cast<long>(offset);
      hd.app1_length = len;
    }
  }

  // Returns the position after the scan's entropy-coded data.
  size_t decode_scan(const uint8_t* p, int len, size_t pos) {
    if (!have_frame) fail(kCorrupt, "JPEG scan before the frame header");
    int ns = p[0];
    if (ns < 1 || ns > hd.ncomp || len < 4 + 2 * ns) fail(kCorrupt, "bad JPEG scan header");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = p[1 + 2 * i], tables = p[2 + 2 * i];
      Component* c = nullptr;
      for (int k = 0; k < hd.ncomp; ++k)
        if (hd.comp[k].id == id) c = &hd.comp[k];
      if (!c) fail(kCorrupt, "JPEG scan names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3 || !hd.dc[c->td].defined || !hd.ac[c->ta].defined)
        fail(kCorrupt, "JPEG scan uses an undefined Huffman table");
      if (!hd.quant_defined[c->tq]) fail(kCorrupt, "JPEG scan uses an undefined quantisation table");
      sc[i] = c;
    }
    int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], ahal = p[3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0) fail(kCorrupt, "bad sequential JPEG scan header");
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (c.plane.empty()) c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
      c.scanned = true;
    }

    // MCU geometry: interleaved scans run over the frame's MCUs, a scan of
    // one component over that component's own blocks.
    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = hd.mcux;
      mcus_y = hd.mcuy;
    }
    BitReader br{data, size, pos};
    int pred[3] = {0, 0, 0};
    int16_t coef[64];
    int restarts_left = hd.restart_interval, next_rst = 0;
    long total = static_cast<long>(mcus_x) * mcus_y;
    for (long m = 0; m < total; ++m) {
      if (hd.restart_interval) {
        if (restarts_left == 0) {
          // the restart marker: drop the partial byte, check RSTn, reset
          if (br.overran()) fail(kCorrupt, "corrupt JPEG data: premature end of data segment");
          size_t q = br.pos;
          br.reset();
          while (q < size && data[q] == 0xFF) ++q;
          if (q >= size || data[q] != 0xD0 + next_rst || data[q - 1] != 0xFF)
            fail(kCorrupt, "corrupt JPEG data: restart marker RST" + std::to_string(next_rst) +
                               " missing");
          br.pos = q + 1;
          br.at_marker = false;
          next_rst = (next_rst + 1) & 7;
          restarts_left = hd.restart_interval;
          pred[0] = pred[1] = pred[2] = 0;
        }
        --restarts_left;
      }
      int mx = static_cast<int>(m % mcus_x), my = static_cast<int>(m / mcus_x);
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        int bh_n = ns == 1 ? 1 : c.v, bw_n = ns == 1 ? 1 : c.h;
        const Huffman& dct = hd.dc[c.td];
        const Huffman& act = hd.ac[c.ta];
        const uint16_t* q = hd.quant[c.tq];
        const int stride = c.bw * 8;
        for (int by = 0; by < bh_n; ++by) {
          for (int bx = 0; bx < bw_n; ++bx) {
            std::memset(coef, 0, sizeof(coef));
            int s = decode_symbol(br, dct);
            if (s > 16) fail(kCorrupt, "corrupt JPEG data: bad DC code");
            int diff = s ? extend(br.get(s), s) : 0;
            pred[i] += diff;
            coef[0] = static_cast<int16_t>(pred[i]);
            for (int k = 1; k < 64;) {
              int fast = act.fast_ac[br.peek(kLookBits)];
              if (fast) {
                br.skip(fast & 15);
                k += (fast >> 4) & 15;
                if (k > 63) fail(kCorrupt, "corrupt JPEG data: coefficient index past 63");
                coef[kZigzag[k]] = static_cast<int16_t>(fast >> 8);
                ++k;
                continue;
              }
              int rs = decode_symbol(br, act);
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                if (k > 63) fail(kCorrupt, "corrupt JPEG data: coefficient index past 63");
                coef[kZigzag[k]] = static_cast<int16_t>(extend(br.get(s), s));
                ++k;
              } else {
                if (r != 15) break;
                k += 16;
              }
            }
            if (br.overran()) fail(kCorrupt, "corrupt JPEG data: premature end of data segment");
            int row = ns == 1 ? my : my * c.v + by;
            int col = ns == 1 ? mx : mx * c.h + bx;
            idct_islow(coef, q, c.plane.data() + static_cast<size_t>(row) * 8 * stride + col * 8,
                       stride);
          }
        }
      }
    }
    if (br.overran()) fail(kCorrupt, "corrupt JPEG data: premature end of data segment");
    return br.pos;
  }

  void parse(bool decode) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail(kCorrupt, "not a JPEG file");
    size_t pos = 2;
    for (;;) {
      int marker = next_marker(pos);
      if (marker < 0) {  // no EOI: finish() checks that every component was scanned
        if (have_frame) return;
        fail(kCorrupt, "JPEG without a frame header");
      }
      if (marker == 0xD9) return;  // EOI
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      int len;
      size_t seg_start = pos + 2;
      const uint8_t* p = segment(pos, len);
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
          marker != 0xCC) {
        read_sof(marker, p, len);
      } else if (marker == 0xC4) {
        read_dht(p, len);
      } else if (marker == 0xCC) {
        fail(kUnsupported, "arithmetic-coded (DAC) JPEG is not supported: Huffman only");
      } else if (marker == 0xDB) {
        read_dqt(p, len);
      } else if (marker == 0xDD) {
        if (len < 2) fail(kCorrupt, "bad JPEG restart interval");
        hd.restart_interval = u16(p);
      } else if (marker == 0xDA) {
        if (!decode) {
          if (!have_frame) fail(kCorrupt, "JPEG scan before the frame header");
          return;
        }
        pos = decode_scan(p, len, pos);
      } else if (marker == 0xDC) {
        fail(kUnsupported, "JPEG with a DNL marker is not supported");
      } else if (marker >= 0xE0 && marker <= 0xEF) {
        read_app(marker, p, len, seg_start);
      }
    }
  }

  void finish(uint8_t* out, bool rgb) {
    const int r_at = rgb ? 0 : 2, b_at = rgb ? 2 : 0;
    for (int i = 0; i < hd.ncomp; ++i)
      if (!hd.comp[i].scanned) fail(kCorrupt, "JPEG ends before every component was scanned");
    const int W = hd.width, H = hd.height;
    if (hd.ncomp == 1) {
      const Component& c = hd.comp[0];
      const int stride = c.bw * 8;
      for (int y = 0; y < H; ++y) {
        const uint8_t* s = c.plane.data() + static_cast<size_t>(y) * stride;
        uint8_t* o = out + static_cast<size_t>(y) * W * 3;
        for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = s[x];
      }
      return;
    }
    // colour space (jdapimin.c default_decompress_parms)
    bool ycc = true;
    if (hd.jfif) {
      ycc = true;
    } else if (hd.adobe) {
      ycc = hd.adobe_transform != 0;
    } else if (hd.comp[0].id == 82 && hd.comp[1].id == 71 && hd.comp[2].id == 66) {
      ycc = false;
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    const int64_t one_half = 1 << 15;
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((static_cast<int64_t>(91881) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((static_cast<int64_t>(116130) * x + one_half) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + static_cast<int32_t>(one_half);
    }
    uint8_t clamp_mem[1024];
    for (int i = 0; i < 1024; ++i) {
      int v = i - 384;
      clamp_mem[i] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
    const uint8_t* clamp = clamp_mem + 384;

    std::vector<uint8_t> rows[3];
    for (int i = 0; i < 3; ++i) rows[i].resize(static_cast<size_t>(W) + 16);
    for (int y = 0; y < H; ++y) {
      const uint8_t* line[3];
      for (int i = 0; i < 3; ++i) line[i] = upsample_row(hd.comp[i], y, rows[i].data());
      uint8_t* o = out + static_cast<size_t>(y) * W * 3;
      if (ycc) {
        for (int x = 0; x < W; ++x) {
          int yy = line[0][x], cb = line[1][x], cr = line[2][x];
          o[3 * x + r_at] = clamp[yy + cr_r[cr]];
          o[3 * x + 1] = clamp[yy + ((cb_g[cb] + cr_g[cr]) >> 16)];
          o[3 * x + b_at] = clamp[yy + cb_b[cb]];
        }
      } else {
        for (int x = 0; x < W; ++x) {
          o[3 * x + r_at] = line[0][x];
          o[3 * x + 1] = line[1][x];
          o[3 * x + b_at] = line[2][x];
        }
      }
    }
  }

  // Output row y of component c at full resolution (jdsample.c).
  const uint8_t* upsample_row(const Component& c, int y, uint8_t* buf) {
    const int stride = c.bw * 8;
    const int rh = hd.hmax / c.h, rv = hd.vmax / c.v;
    const uint8_t* plane = c.plane.data();
    const int W = hd.width;
    if (rh == 1 && rv == 1) return plane + static_cast<size_t>(y) * stride;
    const int dw = c.dw;
    const bool fancy_h = dw > 2;
    if (rv == 1) {  // h2v1
      const uint8_t* in = plane + static_cast<size_t>(y) * stride;
      if (!fancy_h) {
        for (int x = 0; x < W; ++x) buf[x] = in[x >> 1];
        return buf;
      }
      buf[0] = in[0];
      buf[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        int v = in[i] * 3;
        buf[2 * i] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
        buf[2 * i + 1] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
      }
      buf[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      buf[2 * dw - 1] = in[dw - 1];
      return buf;
    }
    // rv == 2: the nearer input row and the next nearer, the edges replicated
    const int iy = y >> 1;
    int other = (y & 1) ? iy + 1 : iy - 1;
    if (other < 0) other = 0;
    if (other > c.dh - 1) other = c.dh - 1;
    const uint8_t* in0 = plane + static_cast<size_t>(iy) * stride;
    const uint8_t* in1 = plane + static_cast<size_t>(other) * stride;
    if (rh == 1) {  // h1v2, always fancy
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x) buf[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      return buf;
    }
    if (!fancy_h) {  // h2v2 box
      for (int x = 0; x < W; ++x) buf[x] = in0[x >> 1];
      return buf;
    }
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    buf[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
    buf[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int i = 1; i < dw - 1; ++i) {
      next_sum = in0[i + 1] * 3 + in1[i + 1];
      buf[2 * i] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      buf[2 * i + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    buf[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    buf[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
    return buf;
  }
};

int report(const Failure& f, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", f.message.c_str());
  return f.status;
}

}  // namespace

extern "C" {

// Reads the headers up to the first scan. info receives width, height,
// components, and the offset and length of the first APP1 segment's payload
// (-1 and 0 without one). Returns 0, 1 (unsupported) or 2 (corrupt).
int td_jpeg_info(const uint8_t* data, long size, long* info, char* err, int errlen) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.parse(false);
    if (!d.have_frame) fail(kCorrupt, "JPEG without a frame header");
    info[0] = d.hd.width;
    info[1] = d.hd.height;
    info[2] = d.hd.ncomp;
    info[3] = d.hd.app1_offset;
    info[4] = d.hd.app1_length;
    return kOk;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Failure{kCorrupt, "out of memory decoding a JPEG"}, err, errlen);
  }
}

// Decodes the whole file into out, height * width * 3 bytes of BGR, or of
// RGB where rgb is nonzero.
int td_jpeg_decode(const uint8_t* data, long size, uint8_t* out, long width, long height,
                   int rgb, char* err, int errlen) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.parse(true);
    if (!d.have_frame) fail(kCorrupt, "JPEG without a frame header");
    if (d.hd.width != width || d.hd.height != height)
      fail(kCorrupt, "JPEG size differs from its header's");
    d.finish(out, rgb != 0);
    return kOk;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Failure{kCorrupt, "out of memory decoding a JPEG"}, err, errlen);
  }
}

}  // extern "C"
