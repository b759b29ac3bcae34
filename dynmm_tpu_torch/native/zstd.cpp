// Zstandard decoder (RFC 8878) and CRC-32C, for the Orbax checkpoints of
// ``utils/orbax.py``: tensorstore compresses OCDBT nodes and zarr chunks
// with zstd and checks OCDBT files with CRC-32C, and the port reads them
// without a zstd package.
//
// Decodes zstd frames (concatenated, skippable frames skipped): raw, RLE and
// compressed blocks; Huffman literals (1 or 4 streams, direct or
// FSE-compressed weights, treeless blocks); sequences with predefined, RLE,
// described and repeated FSE tables; repeat offsets; the optional XXH64
// content checksum. Frames that need a dictionary raise. Every read is
// bounds-checked: a corrupt or truncated frame returns an error message,
// never reads or writes outside its buffers.
//
//   long zstd_decompress(src, n, dst, cap, err, errlen): bytes written, -1 on
//       a corrupt frame (``err`` says why), -2 if the content needs more than
//       ``cap`` bytes.
//   long long zstd_content_size(src, n): the sum of the frames' declared
//       content sizes, -1 if a frame declares none, -2 on a bad header.
//   uint32 crc32c(src, n, crc): CRC-32C (Castagnoli) of ``src`` continued
//       from ``crc`` (0 to start).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& m) : std::runtime_error(m) {}
};
struct NoRoom {};

[[noreturn]] void fail(const char* m) { throw Corrupt(m); }

inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

inline uint64_t rd_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; i++) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = xround(v1, rd_le(p, 8));
      v2 = xround(v2, rd_le(p + 8, 8));
      v3 = xround(v3, rd_le(p + 16, 8));
      v4 = xround(v4, rd_le(p + 24, 8));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, rd_le(p, 8)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (rd_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ bitstreams
// Forward (FSE table descriptions): bits taken from the low end of each
// byte, bytes in order.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;  // bits consumed
  uint32_t read(int k) {
    if (bit + k > n * 8) fail("FSE table description overruns its block");
    uint32_t v = 0;
    for (int i = 0; i < k; i++, bit++)
      v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    return v;
  }
  void rewind(int k) { bit -= k; }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward (Huffman and FSE streams): read from the last bit towards the
// first, after the final byte's padding; bits below the start read as 0.
struct BackBits {
  const uint8_t* p;
  int64_t pos;  // bits [0, pos) unread
  BackBits(const uint8_t* src, size_t n) : p(src) {
    if (n == 0) fail("empty bitstream");
    uint8_t last = src[n - 1];
    if (last == 0) fail("bitstream without its end marker");
    pos = int64_t(n) * 8 - (8 - highbit(last));
  }
  // k ≤ 32: the widest field is a 31-bit offset
  uint64_t read(int k) {
    if (k == 0) return 0;
    pos -= k;
    int64_t lo = pos;
    int take = k, shift = 0;
    if (lo < 0) {
      shift = int(-lo);
      take -= shift;
      lo = 0;
      if (take <= 0) return 0;
    }
    const uint8_t* q = p + (lo >> 3);
    int b = int(lo & 7), nbytes = (b + take + 7) >> 3;
    uint64_t v = 0;
    for (int i = 0; i < nbytes; i++) v |= uint64_t(q[i]) << (8 * i);
    return ((v >> b) & ((uint64_t(1) << take) - 1)) << shift;
  }
};

// --------------------------------------------------------------- FSE
constexpr int FSE_MAX_SYMBS = 256;

struct FseTable {
  int log = 0;
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
};

void fse_build(FseTable& t, const int16_t* freq, int nsym, int log) {
  size_t size = size_t(1) << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  uint16_t state[FSE_MAX_SYMBS];
  size_t high = size;
  for (int s = 0; s < nsym; s++)
    if (freq[s] == -1) {
      if (high == 0) fail("FSE table overfull");
      t.sym[--high] = uint8_t(s);
      state[s] = 1;
    }
  size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    if (freq[s] <= 0) continue;
    state[s] = uint16_t(freq[s]);
    for (int i = 0; i < freq[s]; i++) {
      t.sym[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE probabilities do not fill the table");
  for (size_t i = 0; i < size; i++) {
    uint16_t next = state[t.sym[i]]++;
    int nb = log - highbit(next);
    t.nbits[i] = uint8_t(nb);
    t.base[i] = uint16_t((uint32_t(next) << nb) - size);
  }
}

// Reads an FSE table description at ``p``; returns the bytes it took.
size_t fse_read_table(FseTable& t, const uint8_t* p, size_t n, int max_log,
                      int max_sym) {
  FwdBits in{p, n};
  int log = int(in.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log too large");
  int32_t remaining = 1 << log;
  int16_t freq[FSE_MAX_SYMBS];
  int sym = 0;
  while (remaining > 0 && sym <= max_sym) {
    int bits = highbit(uint64_t(remaining) + 1) + 1;
    uint32_t val = in.read(bits);
    uint32_t lower = (1u << (bits - 1)) - 1;
    uint32_t thresh = (1u << bits) - 1 - (uint32_t(remaining) + 1);
    if ((val & lower) < thresh) {
      in.rewind(1);
      val &= lower;
    } else if (val > lower) {
      val -= thresh;
    }
    int16_t prob = int16_t(int(val) - 1);
    remaining -= prob < 0 ? -prob : prob;
    freq[sym++] = prob;
    if (prob == 0) {
      uint32_t rep = in.read(2);
      for (;;) {
        for (uint32_t i = 0; i < rep && sym <= max_sym; i++) freq[sym++] = 0;
        if (rep != 3) break;
        rep = in.read(2);
      }
    }
  }
  if (remaining != 0 || sym > max_sym + 1) fail("bad FSE table description");
  fse_build(t, freq, sym, log);
  return in.bytes_used();
}

void fse_rle(FseTable& t, uint8_t s) {
  t.log = 0;
  t.sym.assign(1, s);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

struct FseState {
  const FseTable* t;
  uint32_t s;
  void init(const FseTable& tab, BackBits& b) {
    t = &tab;
    s = uint32_t(b.read(tab.log));
  }
  uint8_t peek() const { return t->sym[s]; }
  void update(BackBits& b) {
    s = t->base[s] + uint32_t(b.read(t->nbits[s]));
  }
};

// ------------------------------------------------------------- Huffman
constexpr int HUF_MAX_BITS = 11;

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> sym, nbits;
};

void huf_build(HufTable& h, const uint8_t* w, int nw) {
  uint64_t sum = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > HUF_MAX_BITS) fail("Huffman weight too large");
    if (w[i]) sum += uint64_t(1) << (w[i] - 1);
  }
  if (sum == 0) fail("Huffman weights all zero");
  int max_bits = highbit(sum) + 1;
  uint64_t left = (uint64_t(1) << max_bits) - sum;
  if (left == 0 || (left & (left - 1))) fail("Huffman weights do not sum");
  if (max_bits > HUF_MAX_BITS) fail("Huffman code longer than 11 bits");
  int last = highbit(left) + 1;
  uint8_t bits[257];
  for (int i = 0; i < nw; i++) bits[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
  bits[nw] = uint8_t(max_bits + 1 - last);
  int nsym = nw + 1;
  uint32_t count[HUF_MAX_BITS + 2] = {0};
  for (int i = 0; i < nsym; i++) count[bits[i]]++;
  size_t size = size_t(1) << max_bits;
  h.max_bits = max_bits;
  h.sym.assign(size, 0);
  h.nbits.assign(size, 0);
  uint32_t idx[HUF_MAX_BITS + 2];
  idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; i--) {
    idx[i - 1] = idx[i] + count[i] * (1u << (max_bits - i));
    if (idx[i - 1] > size) fail("Huffman table overfull");
    memset(&h.nbits[idx[i]], i, idx[i - 1] - idx[i]);
  }
  if (idx[0] != size) fail("Huffman table not full");
  for (int i = 0; i < nsym; i++) {
    if (!bits[i]) continue;
    uint32_t len = 1u << (max_bits - bits[i]);
    memset(&h.sym[idx[bits[i]]], i, len);
    idx[bits[i]] += len;
  }
}

// Reads a Huffman tree description; returns the bytes it took.
size_t huf_read_table(HufTable& h, const uint8_t* p, size_t n) {
  if (n < 1) fail("truncated Huffman tree description");
  uint8_t hb = p[0];
  uint8_t w[256];
  int nw = 0;
  size_t used;
  if (hb >= 128) {
    nw = hb - 127;
    used = 1 + (size_t(nw) + 1) / 2;
    if (used > n) fail("truncated Huffman weights");
    for (int i = 0; i < nw; i++) {
      uint8_t b = p[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {
    used = 1 + size_t(hb);
    if (used > n || hb == 0) fail("truncated Huffman weights");
    FseTable t;
    size_t th = fse_read_table(t, p + 1, hb, 6, 255);
    if (th >= hb) fail("Huffman weight stream empty");
    BackBits b(p + 1 + th, hb - th);
    FseState s1, s2;
    s1.init(t, b);
    s2.init(t, b);
    for (;;) {
      if (nw >= 255) fail("too many Huffman weights");
      w[nw++] = s1.peek();
      s1.update(b);
      if (b.pos < 0) {
        w[nw++] = s2.peek();
        break;
      }
      if (nw >= 255) fail("too many Huffman weights");
      w[nw++] = s2.peek();
      s2.update(b);
      if (b.pos < 0) {
        if (nw >= 255) fail("too many Huffman weights");
        w[nw++] = s1.peek();
        break;
      }
    }
  }
  huf_build(h, w, nw);
  return used;
}

void huf_stream(const HufTable& h, const uint8_t* p, size_t n, uint8_t* out,
                size_t count) {
  BackBits b(p, n);
  uint32_t mask = (1u << h.max_bits) - 1;
  uint32_t state = uint32_t(b.read(h.max_bits));
  for (size_t i = 0; i < count; i++) {
    out[i] = h.sym[state];
    int nb = h.nbits[state];
    state = ((state << nb) + uint32_t(b.read(nb))) & mask;
  }
  if (b.pos != -h.max_bits) fail("Huffman stream not consumed exactly");
}

// ------------------------------------------------------------ sequences
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,
    12, 13, 14, 15, 16, 18, 20,  22,  24,  28,  32,   40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Frame {
  uint8_t* out;
  size_t cap;
  size_t pos = 0;        // bytes written for this frame (from out)
  size_t frame_start;    // offset of this frame's first byte in out
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;

  void put(const uint8_t* src, size_t n) {
    if (pos + n > cap) throw NoRoom();
    memcpy(out + pos, src, n);
    pos += n;
  }
  void fill(uint8_t v, size_t n) {
    if (pos + n > cap) throw NoRoom();
    memset(out + pos, v, n);
    pos += n;
  }
  void match(uint64_t offset, size_t len) {
    if (offset == 0 || offset > pos - frame_start)
      fail("match offset before the frame's start");
    if (pos + len > cap) throw NoRoom();
    uint8_t* d = out + pos;
    const uint8_t* s = d - offset;
    if (offset >= len) {
      memcpy(d, s, len);
    } else {
      for (size_t i = 0; i < len; i++) d[i] = s[i];
    }
    pos += len;
  }

  size_t literals(const uint8_t* p, size_t n) {
    if (n < 1) fail("truncated literals section");
    int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
    size_t regen, comp = 0, hdr;
    if (type < 2) {
      if (fmt == 0 || fmt == 2) {
        hdr = 1;
        regen = p[0] >> 3;
      } else if (fmt == 1) {
        hdr = 2;
        if (n < 2) fail("truncated literals header");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      } else {
        hdr = 3;
        if (n < 3) fail("truncated literals header");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      }
      if (regen > (size_t(1) << 17)) fail("literals beyond the block size");
      lit.resize(regen);
      if (type == 0) {
        if (hdr + regen > n) fail("truncated raw literals");
        memcpy(lit.data(), p + hdr, regen);
        return hdr + regen;
      }
      if (hdr + 1 > n) fail("truncated RLE literals");
      memset(lit.data(), p[hdr], regen);
      return hdr + 1;
    }
    int streams = fmt == 0 ? 1 : 4;
    if (fmt < 2) {
      hdr = 3;
      if (n < 3) fail("truncated literals header");
      uint64_t h = rd_le(p, 3);
      regen = (h >> 4) & 0x3FF;
      comp = (h >> 14) & 0x3FF;
    } else if (fmt == 2) {
      hdr = 4;
      if (n < 4) fail("truncated literals header");
      uint64_t h = rd_le(p, 4);
      regen = (h >> 4) & 0x3FFF;
      comp = (h >> 18) & 0x3FFF;
    } else {
      hdr = 5;
      if (n < 5) fail("truncated literals header");
      uint64_t h = rd_le(p, 5);
      regen = (h >> 4) & 0x3FFFF;
      comp = (h >> 22) & 0x3FFFF;
    }
    if (regen > (size_t(1) << 17)) fail("literals beyond the block size");
    if (hdr + comp > n) fail("truncated compressed literals");
    const uint8_t* q = p + hdr;
    size_t qn = comp;
    if (type == 2) {
      size_t t = huf_read_table(huf, q, qn);
      have_huf = true;
      q += t;
      qn -= t;
    } else if (!have_huf) {
      fail("treeless literals without an earlier Huffman table");
    }
    lit.resize(regen);
    if (streams == 1) {
      huf_stream(huf, q, qn, lit.data(), regen);
    } else {
      if (qn < 6) fail("truncated jump table");
      size_t s1 = rd_le(q, 2), s2 = rd_le(q + 2, 2), s3 = rd_le(q + 4, 2);
      if (6 + s1 + s2 + s3 > qn) fail("jump table beyond the literals");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("four literal streams for too few literals");
      const uint8_t* r = q + 6;
      huf_stream(huf, r, s1, lit.data(), seg);
      huf_stream(huf, r + s1, s2, lit.data() + seg, seg);
      huf_stream(huf, r + s1 + s2, s3, lit.data() + 2 * seg, seg);
      huf_stream(huf, r + s1 + s2 + s3, s4, lit.data() + 3 * seg,
                 regen - 3 * seg);
    }
    return hdr + comp;
  }

  size_t table(FseTable& t, bool& have, int mode, const uint8_t* p, size_t n,
               const int16_t* def, int ndef, int def_log, int max_log,
               int max_sym) {
    switch (mode) {
      case 0:
        fse_build(t, def, ndef, def_log);
        have = true;
        return 0;
      case 1:
        if (n < 1) fail("truncated RLE table");
        if (p[0] > max_sym) fail("RLE symbol out of range");
        fse_rle(t, p[0]);
        have = true;
        return 1;
      case 2: {
        size_t used = fse_read_table(t, p, n, max_log, max_sym);
        have = true;
        return used;
      }
      default:
        if (!have) fail("repeated FSE table without an earlier one");
        return 0;
    }
  }

  void block(const uint8_t* p, size_t n) {
    size_t used = literals(p, n);
    p += used;
    n -= used;
    if (n < 1) fail("truncated sequences section");
    size_t nseq = p[0], hdr = 1;
    if (nseq >= 128) {
      if (nseq < 255) {
        if (n < 2) fail("truncated sequences header");
        nseq = ((nseq - 128) << 8) + p[1];
        hdr = 2;
      } else {
        if (n < 3) fail("truncated sequences header");
        nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
        hdr = 3;
      }
    }
    if (nseq == 0) {
      if (hdr != n) fail("bytes after an empty sequences section");
      put(lit.data(), lit.size());
      return;
    }
    if (hdr >= n) fail("truncated sequences header");
    uint8_t modes = p[hdr++];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    p += hdr;
    n -= hdr;
    size_t t = table(ll, have_ll, modes >> 6, p, n, LL_DEFAULT, 36, 6, 9, 35);
    p += t;
    n -= t;
    t = table(of, have_of, (modes >> 4) & 3, p, n, OF_DEFAULT, 29, 5, 8, 31);
    p += t;
    n -= t;
    t = table(ml, have_ml, (modes >> 2) & 3, p, n, ML_DEFAULT, 53, 6, 9, 52);
    p += t;
    n -= t;
    BackBits b(p, n);
    FseState sl, so, sm;
    sl.init(ll, b);
    so.init(of, b);
    sm.init(ml, b);
    size_t lp = 0;
    for (size_t i = 0; i < nseq; i++) {
      uint8_t oc = so.peek(), lc = sl.peek(), mc = sm.peek();
      if (lc > 35 || mc > 52) fail("sequence code out of range");
      if (oc > 31) fail("offset code out of range");
      uint64_t ofv = (uint64_t(1) << oc) + b.read(oc);
      size_t mlen = ML_BASE[mc] + size_t(b.read(ML_BITS[mc]));
      size_t llen = LL_BASE[lc] + size_t(b.read(LL_BITS[lc]));
      if (i + 1 < nseq) {
        sl.update(b);
        sm.update(b);
        so.update(b);
      }
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        uint32_t idx = uint32_t(ofv - 1) + (llen == 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx < 3 ? rep[idx] : rep[0] - 1;
          if (idx > 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (lp + llen > lit.size()) fail("sequence takes more literals than decoded");
      put(lit.data() + lp, llen);
      lp += llen;
      match(offset, mlen);
    }
    if (b.pos != 0) fail("sequences bitstream not consumed exactly");
    put(lit.data() + lp, lit.size() - lp);
  }
};

// Parses a frame header at p; returns its size, or throws.
struct Header {
  size_t size;
  bool single, checksum;
  int64_t content;  // -1 unknown
  uint64_t window;
};

Header frame_header(const uint8_t* p, size_t n) {
  if (n < 5) fail("truncated frame header");
  uint8_t d = p[4];
  int fcs_flag = d >> 6;
  Header h;
  h.single = (d >> 5) & 1;
  h.checksum = (d >> 2) & 1;
  if (d & 8) fail("reserved bit set in the frame header");
  int did = d & 3;
  size_t q = 5;
  h.window = 0;
  if (!h.single) {
    if (q >= n) fail("truncated frame header");
    uint8_t wd = p[q++];
    int e = wd >> 3, m = wd & 7;
    uint64_t base = uint64_t(1) << (10 + e);
    h.window = base + (base / 8) * m;
  }
  static const int did_size[4] = {0, 1, 2, 4};
  if (q + did_size[did] > n) fail("truncated frame header");
  uint64_t dict = rd_le(p + q, did_size[did]);
  q += did_size[did];
  if (dict) fail("frame needs a dictionary");
  int fcs_size = fcs_flag == 0 ? (h.single ? 1 : 0) : (1 << fcs_flag);
  if (q + fcs_size > n) fail("truncated frame header");
  if (fcs_size == 0) {
    h.content = -1;
  } else {
    uint64_t v = rd_le(p + q, fcs_size);
    if (fcs_size == 2) v += 256;
    h.content = int64_t(v);
  }
  q += fcs_size;
  if (h.single) h.window = uint64_t(h.content);
  h.size = q;
  return h;
}

constexpr uint32_t MAGIC = 0xFD2FB528u;

size_t decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t i = 0, total = 0;
  if (n == 0) fail("empty input");
  while (i < n) {
    if (n - i < 4) fail("truncated frame magic");
    uint32_t magic = uint32_t(rd_le(src + i, 4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - i < 8) fail("truncated skippable frame");
      uint64_t len = rd_le(src + i + 4, 4);
      if (len > n - i - 8) fail("truncated skippable frame");
      i += 8 + len;
      continue;
    }
    if (magic != MAGIC) fail("not a zstd frame (bad magic)");
    Header h = frame_header(src + i, n - i);
    i += h.size;
    Frame f;
    f.out = dst;
    f.cap = cap;
    f.pos = total;
    f.frame_start = total;
    for (;;) {
      if (n - i < 3) fail("truncated block header");
      uint32_t bh = uint32_t(rd_le(src + i, 3));
      i += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) fail("reserved block type");
      size_t in_size = type == 1 ? 1 : size;
      if (in_size > n - i) fail("truncated block");
      if (size > (1u << 17)) fail("block larger than 128 KiB");
      if (type == 0) {
        f.put(src + i, size);
      } else if (type == 1) {
        f.fill(src[i], size);
      } else {
        size_t before = f.pos;
        f.block(src + i, size);
        if (f.pos - before > (1u << 17)) fail("block decodes beyond 128 KiB");
      }
      i += in_size;
      if (last) break;
    }
    size_t produced = f.pos - total;
    if (h.content >= 0 && uint64_t(produced) != uint64_t(h.content))
      fail("frame content size differs from its header");
    if (h.checksum) {
      if (n - i < 4) fail("truncated content checksum");
      uint32_t want = uint32_t(rd_le(src + i, 4));
      uint32_t got = uint32_t(xxh64(dst + total, produced));
      if (want != got) fail("content checksum mismatch");
      i += 4;
    }
    total = f.pos;
  }
  return total;
}

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int k = 1; k < 8; k++)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const CrcTables& crc_tables() {
  static const CrcTables tables;
  return tables;
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

extern "C" {

long zstd_decompress(const uint8_t* src, long n, uint8_t* dst, long cap,
                     char* err, int errlen) {
  try {
    return long(decode(src, size_t(n), dst, size_t(cap)));
  } catch (const Corrupt& e) {
    set_err(err, errlen, e.what());
    return -1;
  } catch (const NoRoom&) {
    set_err(err, errlen, "output buffer too small");
    return -2;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

long long zstd_content_size(const uint8_t* src, long n) {
  try {
    size_t i = 0;
    long long total = 0;
    while (i < size_t(n)) {
      if (size_t(n) - i < 4) return -2;
      uint32_t magic = uint32_t(rd_le(src + i, 4));
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (size_t(n) - i < 8) return -2;
        i += 8 + rd_le(src + i + 4, 4);
        continue;
      }
      if (magic != MAGIC) return -2;
      Header h = frame_header(src + i, size_t(n) - i);
      if (h.content < 0) return -1;
      total += h.content;
      // walk the blocks to the next frame
      i += h.size;
      for (;;) {
        if (size_t(n) - i < 3) return -2;
        uint32_t bh = uint32_t(rd_le(src + i, 3));
        i += 3 + (((bh >> 1) & 3) == 1 ? 1 : (bh >> 3));
        if (i > size_t(n)) return -2;
        if (bh & 1) break;
      }
      if (h.checksum) i += 4;
    }
    return total;
  } catch (const std::exception&) {
    return -2;
  }
}

uint32_t crc32c(const uint8_t* p, long n, uint32_t crc) {
  const auto& t = crc_tables().t;
  crc = ~crc;
  long i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t v = rd_le(p + i, 8) ^ crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^
          t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
  }
  for (; i < n; i++) crc = (crc >> 8) ^ t[0][(crc ^ p[i]) & 0xFF];
  return ~crc;
}

}  // extern "C"
