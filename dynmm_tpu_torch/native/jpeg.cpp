// JPEG decoding for dynmm_tpu_torch/data/jpeg.py, pixel-exact with
// cv2.imread (libjpeg-turbo with its defaults).
//
// Decodes baseline and extended-sequential Huffman JPEG (SOF0/SOF1, 8-bit
// samples) with 1 or 3 components, integral sampling factors (4:4:4,
// 4:2:2, 4:2:0, 4:4:0, ...), interleaved or one-component scans, restart
// intervals, and any image size. It computes what libjpeg-turbo computes:
//   - the ISLOW integer IDCT (jidctint.c) with its range-limit table;
//   - "fancy" upsampling: the h2v1, h1v2 and h2v2 triangle filters of
//     jdsample.c, edge rows and columns replicated at the component's own
//     (downsampled) size; plain replication where libjpeg-turbo takes it
//     (a component 1 or 2 samples wide, other integral factors);
//   - YCbCr -> RGB with the fixed-point tables of jdcolor.c.
// Progressive (SOF2), lossless, hierarchical and arithmetic-coded files,
// 12- or 16-bit samples, CMYK/YCCK (4 components) and RGB-coded 3-component
// files (Adobe transform 0, or 'R','G','B' component ids) are refused with
// a message naming the marker.
//
// jpeg_info(buf, n, dims, err, errlen): dims = {height, width, components}.
// jpeg_decode(buf, n, out, err, errlen): out = height*width*components
// bytes, RGB interleaved for 3 components, grey for 1. Both return 0, or 1
// with a NUL-terminated message in err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

std::string hex_marker(int m) {
  char b[16];
  std::snprintf(b, sizeof b, "0xFF%02X", m);
  return b;
}

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 8-bit lookahead: (length << 8) | symbol, 0 where the code is longer
  uint16_t look[256];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, static_cast<size_t>(nsym));
    int code = 0, k = 0;
    int huffcode[257];
    int huffsize[257];
    for (int len = 1; len <= 16; ++len)
      for (int i = 0; i < counts[len - 1]; ++i) huffsize[k++] = len;
    huffsize[k] = 0;
    k = 0;
    int size = huffsize[0];
    while (huffsize[k]) {
      while (huffsize[k] == size) huffcode[k++] = code++;
      if (code >= (1 << size)) throw Error("bad Huffman table (DHT)");
      code <<= 1;
      ++size;
    }
    k = 0;
    for (int len = 1; len <= 16; ++len) {
      if (counts[len - 1]) {
        valoffset[len] = k - huffcode[k];
        k += counts[len - 1];
        maxcode[len] = huffcode[k - 1];
      } else {
        maxcode[len] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof look);
    k = 0;
    for (int len = 1; len <= 8; ++len)
      for (int i = 0; i < counts[len - 1]; ++i, ++k) {
        const int base = huffcode[k] << (8 - len);
        for (int j = 0; j < (1 << (8 - len)); ++j)
          look[base + j] = static_cast<uint16_t>((len << 8) | vals[k]);
      }
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;  // Huffman tables of the current scan
  int bw = 0, bh = 0;  // blocks across and down in the plane
  int dw = 0, dh = 0;  // downsampled size (libjpeg's downsampled_width)
  int pred = 0;
  std::vector<uint8_t> plane;  // (bh*8) x (bw*8) samples
};

// Reads entropy-coded bits, unstuffing 0xFF00; at a marker it supplies
// zeros (libjpeg's behaviour) and leaves the position on the marker.
struct BitReader {
  const uint8_t* buf;
  size_t n, pos;
  uint32_t acc = 0;
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 24) {
      uint32_t byte = 0;
      if (!at_marker && pos < n) {
        byte = buf[pos];
        if (byte == 0xFF) {
          size_t p = pos + 1;
          while (p < n && buf[p] == 0xFF) ++p;  // fill bytes
          if (p < n && buf[p] == 0x00) {
            pos = p + 1;
          } else {
            at_marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= byte << (24 - nbits);
      nbits += 8;
    }
  }
  int peek8() {
    if (nbits < 8) fill();
    return static_cast<int>(acc >> 24);
  }
  int bits(int k) {  // k in 0..16
    if (k == 0) return 0;
    if (nbits < k) fill();
    const int r = static_cast<int>(acc >> (32 - k));
    acc <<= k;
    nbits -= k;
    return r;
  }
  int bit() { return bits(1); }
  void reset() {  // byte-align for a restart marker
    acc = 0;
    nbits = 0;
  }
};

int decode_symbol(BitReader& br, const Huffman& t) {
  const int l = t.look[br.peek8()];
  if (l) {
    br.bits(l >> 8);
    return l & 0xFF;
  }
  int code = br.bits(8);
  int len = 8;
  while (true) {
    code = (code << 1) | br.bit();
    ++len;
    if (len > 16) throw Error("corrupt Huffman data");
    if (code <= t.maxcode[len]) break;
  }
  return t.vals[code + t.valoffset[len]];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ------------------------------------------------------------ ISLOW IDCT
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

// jdmaster.c's post-IDCT range limit: index by (value & 1023)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x)
      t[x] = x < 128 ? static_cast<uint8_t>(x + 128)
             : x < 512 ? 255
             : x < 896 ? 0
                       : static_cast<uint8_t>(x - 896);
  }
};
const RangeLimit kRange;

// coef: 64 dequantized coefficients in natural order
void idct_islow(const int32_t* coef, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* in = coef + c;
    int64_t z2 = in[16], z3 = in[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0];
    z3 = in[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56];
    tmp1 = in[40];
    tmp2 = in[24];
    tmp3 = in[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    ws[c + 0] = static_cast<int32_t>(descale(tmp10 + tmp3, s));
    ws[c + 56] = static_cast<int32_t>(descale(tmp10 - tmp3, s));
    ws[c + 8] = static_cast<int32_t>(descale(tmp11 + tmp2, s));
    ws[c + 48] = static_cast<int32_t>(descale(tmp11 - tmp2, s));
    ws[c + 16] = static_cast<int32_t>(descale(tmp12 + tmp1, s));
    ws[c + 40] = static_cast<int32_t>(descale(tmp12 - tmp1, s));
    ws[c + 24] = static_cast<int32_t>(descale(tmp13 + tmp0, s));
    ws[c + 32] = static_cast<int32_t>(descale(tmp13 - tmp0, s));
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t{w[0]} + w[4]) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (int64_t{w[0]} - w[4]) * (int64_t{1} << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    auto lim = [](int64_t x) { return kRange.t[descale(x, s) & 1023]; };
    o[0] = lim(tmp10 + tmp3);
    o[7] = lim(tmp10 - tmp3);
    o[1] = lim(tmp11 + tmp2);
    o[6] = lim(tmp11 - tmp2);
    o[2] = lim(tmp12 + tmp1);
    o[5] = lim(tmp12 - tmp1);
    o[3] = lim(tmp13 + tmp0);
    o[4] = lim(tmp13 - tmp0);
  }
}

// ------------------------------------------------------------- decoder
struct Decoder {
  const uint8_t* buf;
  size_t n, pos = 0;
  int height = 0, width = 0, hmax = 1, vmax = 1;
  bool have_frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;

  Decoder(const uint8_t* b, size_t len) : buf(b), n(len) {}

  int u8() {
    if (pos >= n) throw Error("unexpected end of file");
    return buf[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // skip to the next 0xFF xx with xx not 0 or 0xFF
    while (true) {
      if (pos >= n) throw Error("unexpected end of file (no EOI marker)");
      if (buf[pos] != 0xFF) {
        ++pos;
        continue;
      }
      while (pos < n && buf[pos] == 0xFF) ++pos;
      if (pos >= n) throw Error("unexpected end of file");
      const int m = buf[pos++];
      if (m != 0) return m;
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      const int pq_tq = u8();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw Error("bad quantization table (DQT)");
      for (int i = 0; i < 64; ++i)
        qt[tq][kZigzag[i]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      const int tc_th = u8();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error("bad Huffman table (DHT)");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = static_cast<uint8_t>(u8());
      if (total > 256) throw Error("bad Huffman table (DHT)");
      uint8_t symbols[256];
      for (int i = 0; i < total; ++i) symbols[i] = static_cast<uint8_t>(u8());
      (tc ? ac : dc)[th].build(counts, symbols, total);
    }
  }

  void read_sof(int marker) {
    const int precision = u8();
    if (precision != 8)
      throw Error(std::to_string(precision) + "-bit samples (SOF marker " +
                  hex_marker(marker) + ") are not supported: 8-bit only");
    height = u16();
    width = u16();
    const int nc = u8();
    if (height == 0)
      throw Error("a height defined by a DNL marker is not supported");
    if (width == 0) throw Error("zero image width");
    if (nc == 4)
      throw Error("4-component (CMYK/YCCK) JPEGs (SOF marker " +
                  hex_marker(marker) + ") are not supported");
    if (nc != 1 && nc != 3)
      throw Error(std::to_string(nc) + "-component JPEGs are not supported");
    comps.resize(static_cast<size_t>(nc));
    for (auto& c : comps) {
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Error("bad component in SOF marker " + hex_marker(marker));
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (nc == 1) {  // libjpeg: a lone component is one block per MCU
      comps[0].h = comps[0].v = 1;
      hmax = vmax = 1;
    }
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        throw Error("fractional sampling factors are not supported");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = static_cast<int>((int64_t{width} * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((int64_t{height} * c.v + vmax - 1) / vmax);
      c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
    }
    have_frame = true;
  }

  void check_color() {
    if (comps.size() != 3) return;
    if (jfif) return;
    if (adobe) {
      if (adobe_transform == 0)
        throw Error("RGB-coded JPEGs (Adobe APP14 transform 0) are not "
                    "supported");
      if (adobe_transform != 1)
        throw Error("Adobe APP14 transform " +
                    std::to_string(adobe_transform) + " is not supported");
      return;
    }
    if (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B')
      throw Error("RGB-coded JPEGs (component ids 'R','G','B') are not "
                  "supported");
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    if (!hd.defined || !ha.defined)
      throw Error("scan uses an undefined Huffman table");
    int32_t coef[64] = {0};
    const uint16_t* q = qt[c.tq];
    const int t = decode_symbol(br, hd);
    if (t > 16) throw Error("corrupt DC coefficient");
    const int diff = t ? extend(br.bits(t), t) : 0;
    c.pred += diff;
    coef[0] = c.pred * q[0];
    for (int k = 1; k < 64;) {
      const int rs = decode_symbol(br, ha);
      const int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r != 15) break;
        k += 16;
        continue;
      }
      k += r;
      if (k > 63) throw Error("corrupt AC coefficients");
      const int z = kZigzag[k];
      coef[z] = extend(br.bits(s), s) * q[z];
      ++k;
    }
    const int stride = c.bw * 8;
    idct_islow(coef, c.plane.data() + static_cast<size_t>(by) * 8 * stride +
                         static_cast<size_t>(bx) * 8,
               stride);
  }

  void read_scan() {
    if (!have_frame) throw Error("SOS marker before the frame header");
    const size_t seg_start = pos;
    const int len = u16();
    const int ns = u8();
    if (ns < 1 || ns > static_cast<int>(comps.size()))
      throw Error("bad SOS marker");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int cid = u8();
      const int tt = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == cid) found = &c;
      if (!found) throw Error("SOS names an unknown component");
      found->td = tt >> 4;
      found->ta = tt & 15;
      if (found->td > 3 || found->ta > 3) throw Error("bad SOS marker");
      if (!qt_defined[found->tq])
        throw Error("scan uses an undefined quantization table");
      sc.push_back(found);
    }
    const int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      throw Error("spectral selection or successive approximation in a "
                  "sequential scan (SOS marker 0xFFDA)");
    pos = seg_start + static_cast<size_t>(len);
    for (auto* c : sc) c->pred = 0;

    BitReader br{buf, n, pos};
    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    }
    const int64_t total = int64_t{mcus_x} * mcus_y;
    int restarts = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        // the marker must be next: skip the padding bits and it
        br.reset();
        size_t p = br.pos;
        while (p < n && buf[p] != 0xFF) ++p;
        while (p < n && buf[p] == 0xFF) ++p;
        if (p < n && buf[p] >= 0xD0 && buf[p] <= 0xD7) {
          ++p;
        } else {
          throw Error("missing RST marker after restart interval " +
                      std::to_string(restarts));
        }
        br.pos = p;
        br.at_marker = false;
        ++restarts;
        for (auto* c : sc) c->pred = 0;
      }
      const int mx = static_cast<int>(m % mcus_x);
      const int my = static_cast<int>(m / mcus_x);
      if (ns == 1) {
        decode_block(br, *sc[0], mx, my);
      } else {
        for (auto* c : sc)
          for (int v = 0; v < c->v; ++v)
            for (int h = 0; h < c->h; ++h)
              decode_block(br, *c, mx * c->h + h, my * c->v + v);
      }
    }
    // continue after the entropy-coded data
    pos = br.pos;
  }

  void parse(bool decode) {
    if (n < 4 || buf[0] != 0xFF || buf[1] != 0xD8)
      throw Error("not a JPEG file (no SOI marker)");
    pos = 2;
    bool seen_scan = false;
    while (true) {
      const int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RST
      if (m == 0x01) continue;               // TEM
      if (m == 0xDA) {
        if (!have_frame) throw Error("SOS marker before the frame header");
        check_color();
        if (!decode) return;
        read_scan();
        seen_scan = true;
        continue;
      }
      const size_t seg = pos;
      const int len = u16();
      if (len < 2 || seg + static_cast<size_t>(len) > n)
        throw Error("truncated marker segment " + hex_marker(m));
      const size_t end = seg + static_cast<size_t>(len);
      switch (m) {
        case 0xC0:
        case 0xC1:
          if (have_frame) throw Error("more than one frame header");
          read_sof(m);
          break;
        case 0xC2:
          throw Error("progressive JPEGs (SOF2 marker 0xFFC2) are not "
                      "supported");
        case 0xC3:
          throw Error("lossless JPEGs (SOF3 marker 0xFFC3) are not "
                      "supported");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          throw Error("hierarchical JPEGs (SOF marker " + hex_marker(m) +
                      ") are not supported");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          throw Error("arithmetic-coded JPEGs (SOF marker " + hex_marker(m) +
                      ") are not supported");
        case 0xCC:
          throw Error("arithmetic-coded JPEGs (DAC marker 0xFFCC) are not "
                      "supported");
        case 0xC4:
          read_dht(end);
          break;
        case 0xDB:
          read_dqt(end);
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xE0:
          if (len >= 7 && std::memcmp(buf + seg + 2, "JFIF\0", 5) == 0)
            jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && std::memcmp(buf + seg + 2, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = buf[seg + 13];
          }
          break;
        default:
          break;  // APPn, COM, DNL, ...
      }
      pos = end;
    }
    if (!have_frame) throw Error("no frame header (SOF marker)");
    if (decode && !seen_scan) throw Error("no scan (SOS marker)");
  }
};

// ------------------------------------------------------------ upsampling
// The component's samples at the full image size (height rows of at
// least the image's width), as libjpeg-turbo's jdsample.c computes them (fancy upsampling).
std::vector<uint8_t> upsample(const Component& c, int hmax, int vmax,
                              int height, int& out_stride) {
  const int stride = c.bw * 8;
  const uint8_t* p = c.plane.data();
  const int he = hmax / c.h, ve = vmax / c.v;
  const int ow = c.dw * he;  // >= width
  out_stride = ow;
  std::vector<uint8_t> out(static_cast<size_t>(ow) * height);
  auto in_row = [&](int r) {  // edge rows replicated at the real height
    if (r < 0) r = 0;
    if (r > c.dh - 1) r = c.dh - 1;
    return p + static_cast<size_t>(r) * stride;
  };
  const bool fancy_h = c.dw > 2;
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out.data() + static_cast<size_t>(y) * ow;
    if (he == 1 && ve == 1) {
      std::memcpy(o, in_row(y), static_cast<size_t>(ow));
    } else if (he == 2 && ve == 1 && fancy_h) {
      const uint8_t* in = in_row(y);
      int v = in[0];
      *o++ = static_cast<uint8_t>(v);
      *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < c.dw - 1; ++x) {
        v = in[x] * 3;
        *o++ = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
        *o++ = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
      }
      v = in[c.dw - 1];
      *o++ = static_cast<uint8_t>((v * 3 + in[c.dw - 2] + 1) >> 2);
      *o++ = static_cast<uint8_t>(v);
    } else if (he == 1 && ve == 2) {
      const int r = y >> 1;
      const bool upper = (y & 1) == 0;  // next nearest row is above
      const uint8_t* in0 = in_row(r);
      const uint8_t* in1 = in_row(upper ? r - 1 : r + 1);
      const int bias = upper ? 1 : 2;
      for (int x = 0; x < c.dw; ++x)
        o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (he == 2 && ve == 2 && fancy_h) {
      const int r = y >> 1;
      const bool upper = (y & 1) == 0;
      const uint8_t* in0 = in_row(r);
      const uint8_t* in1 = in_row(upper ? r - 1 : r + 1);
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 2; x < c.dw; ++x) {
        next_sum = in0[x] * 3 + in1[x];
        *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
    } else {
      // integral replication (jdsample.c h2v1/h2v2/int_upsample); libjpeg
      // replicates the decoded rows, which cover the padded height
      const uint8_t* in = p + static_cast<size_t>(y / ve) * stride;
      for (int x = 0; x < ow; ++x) o[x] = in[x / he];
    }
  }
  return out;
}

// jdcolor.c's YCbCr -> RGB tables
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (1 << kScale) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

void run(const uint8_t* buf, size_t n, int* dims, uint8_t* out) {
  Decoder d(buf, n);
  d.parse(out != nullptr);
  dims[0] = d.height;
  dims[1] = d.width;
  dims[2] = static_cast<int>(d.comps.size());
  if (!out) return;
  const int w = d.width, h = d.height;
  if (d.comps.size() == 1) {
    const Component& c = d.comps[0];
    for (int y = 0; y < h; ++y)
      std::memcpy(out + static_cast<size_t>(y) * w,
                  c.plane.data() + static_cast<size_t>(y) * c.bw * 8,
                  static_cast<size_t>(w));
    return;
  }
  int sy, sb, sr;
  const auto Y = upsample(d.comps[0], d.hmax, d.vmax, h, sy);
  const auto Cb = upsample(d.comps[1], d.hmax, d.vmax, h, sb);
  const auto Cr = upsample(d.comps[2], d.hmax, d.vmax, h, sr);
  for (int y = 0; y < h; ++y) {
    const uint8_t* py = Y.data() + static_cast<size_t>(y) * sy;
    const uint8_t* pb = Cb.data() + static_cast<size_t>(y) * sb;
    const uint8_t* pr = Cr.data() + static_cast<size_t>(y) * sr;
    uint8_t* o = out + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int yy = py[x], cb = pb[x], cr = pr[x];
      o[3 * x] = clamp255(yy + kYcc.cr_r[cr]);
      o[3 * x + 1] = clamp255(
          yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
    }
  }
}

void set_error(char* err, int errlen, const char* msg) {
  if (errlen <= 0) return;
  std::snprintf(err, static_cast<size_t>(errlen), "%s", msg);
}

}  // namespace

extern "C" {

int jpeg_info(const uint8_t* buf, long n, int* dims, char* err, int errlen) {
  try {
    run(buf, static_cast<size_t>(n), dims, nullptr);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

int jpeg_decode(const uint8_t* buf, long n, uint8_t* out, char* err,
                int errlen) {
  try {
    int dims[3];
    run(buf, static_cast<size_t>(n), dims, out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
