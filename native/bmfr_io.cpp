// bmfr_io — native IO runtime for bmfr_tpu.
//
// The reference's host runtime is C++ (OpenImageIO EXR/PNG IO, OpenMP
// parallel frame loading — opencl/bmfr.cpp:145-172, :252-313, :519-553).
// This library provides this rebuild's equivalent without external image
// deps: a scanline EXR reader/writer (NONE/ZIPS/ZIP compression, HALF and
// FLOAT channels), a zlib-based PNG writer, and a pthread-parallel batch
// loader. Exposed via a C ABI consumed through ctypes
// (bmfr_tpu/io/native.py).
//
// Build: make -C native  (g++ -O2 -shared -fPIC, links zlib + pthread)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <map>
#include <thread>
#include <atomic>
#include <mutex>

#include <zlib.h>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

// ---------------------------------------------------------------------
// half <-> float
// ---------------------------------------------------------------------
float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {
      // subnormal half -> normalized float
      int e = -1;
      do {
        e++;
        mant <<= 1;
      } while ((mant & 0x400) == 0);
      mant &= 0x3FF;
      bits = sign | ((127 - 15 - e) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t float_to_half(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000;
  int32_t exp = (int32_t)((bits >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = bits & 0x7FFFFF;
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;
    mant |= 0x800000;
    uint32_t shift = 14 - exp;
    uint16_t val = (uint16_t)(mant >> shift);
    // round to nearest
    if ((mant >> (shift - 1)) & 1) val++;
    return (uint16_t)(sign | val);
  }
  if (exp >= 31) return (uint16_t)(sign | 0x7C00);  // inf/overflow
  uint16_t val = (uint16_t)(sign | (exp << 10) | (mant >> 13));
  if (mant & 0x1000) val++;  // round
  return val;
}

// ---------------------------------------------------------------------
// EXR structures
// ---------------------------------------------------------------------
struct ExrChannel {
  std::string name;
  int32_t pixel_type;  // 0=UINT 1=HALF 2=FLOAT
};

struct ExrHeader {
  std::vector<ExrChannel> channels;  // alphabetical (file order)
  uint8_t compression = 0;           // 0=NONE 2=ZIPS 3=ZIP
  int32_t xmin = 0, ymin = 0, xmax = 0, ymax = 0;
  int width() const { return xmax - xmin + 1; }
  int height() const { return ymax - ymin + 1; }
};

struct Reader {
  const uint8_t *p, *end;
  bool fail = false;
  explicit Reader(const std::vector<uint8_t> &buf)
      : p(buf.data()), end(buf.data() + buf.size()) {}
  bool need(size_t n) {
    if ((size_t)(end - p) < n) {
      fail = true;
      return false;
    }
    return true;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  uint64_t u64() {
    if (!need(8)) return 0;
    uint64_t v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return *p++;
  }
  std::string cstr(size_t maxlen = 256) {
    std::string s;
    while (p < end && *p && s.size() < maxlen) s.push_back((char)*p++);
    if (p < end && *p == 0) p++;
    else fail = true;
    return s;
  }
  void skip(size_t n) {
    if (need(n)) p += n;
  }
};

bool read_file(const char *path, std::vector<uint8_t> &out) {
  FILE *f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize((size_t)n);
  size_t got = std::fread(out.data(), 1, (size_t)n, f);
  std::fclose(f);
  if (got != (size_t)n) {
    set_error(std::string("short read on ") + path);
    return false;
  }
  return true;
}

bool parse_exr_header(Reader &r, ExrHeader &h) {
  if (r.u32() != 20000630u) {
    set_error("not an EXR file (bad magic)");
    return false;
  }
  uint32_t version = r.u32();
  if ((version & 0xFF) != 2) {
    set_error("unsupported EXR version");
    return false;
  }
  if (version & 0x200) {
    set_error("tiled EXR not supported");
    return false;
  }
  while (true) {
    std::string name = r.cstr();
    if (r.fail) {
      set_error("corrupt EXR header");
      return false;
    }
    if (name.empty()) break;  // end of header
    std::string type = r.cstr();
    uint32_t size = r.u32();
    const uint8_t *attr_start = r.p;
    if (name == "channels" && type == "chlist") {
      while (true) {
        std::string cn = r.cstr();
        if (cn.empty()) break;
        ExrChannel c;
        c.name = cn;
        c.pixel_type = (int32_t)r.u32();
        r.skip(4);   // pLinear + reserved
        r.skip(8);   // x/y sampling
        h.channels.push_back(c);
      }
    } else if (name == "compression" && type == "compression") {
      h.compression = r.u8();
    } else if (name == "dataWindow" && type == "box2i") {
      h.xmin = (int32_t)r.u32();
      h.ymin = (int32_t)r.u32();
      h.xmax = (int32_t)r.u32();
      h.ymax = (int32_t)r.u32();
    } else {
      r.skip(size);
      continue;
    }
    // realign in case the typed parse didn't consume exactly `size`
    r.p = attr_start;
    r.skip(size);
    if (r.fail) {
      set_error("corrupt EXR attribute " + name);
      return false;
    }
  }
  if (h.channels.empty()) {
    set_error("EXR has no channels");
    return false;
  }
  return true;
}

// EXR zip post-inflate reconstruction: un-predictor then de-interleave.
void exr_unfilter(std::vector<uint8_t> &buf) {
  // predictor
  for (size_t i = 1; i < buf.size(); ++i)
    buf[i] = (uint8_t)((int)buf[i - 1] + (int)buf[i] - 128);
  // deinterleave
  std::vector<uint8_t> out(buf.size());
  const size_t half = (buf.size() + 1) / 2;
  const uint8_t *t1 = buf.data();
  const uint8_t *t2 = buf.data() + half;
  for (size_t i = 0; i < buf.size(); ++i)
    out[i] = (i & 1) ? *t2++ : *t1++;
  buf.swap(out);
}

void exr_filter(std::vector<uint8_t> &buf) {  // inverse, for writing
  std::vector<uint8_t> tmp(buf.size());
  const size_t half = (buf.size() + 1) / 2;
  uint8_t *t1 = tmp.data();
  uint8_t *t2 = tmp.data() + half;
  for (size_t i = 0; i < buf.size(); ++i)
    if (i & 1) *t2++ = buf[i];
    else *t1++ = buf[i];
  // predictor
  uint8_t prev = tmp.empty() ? 0 : tmp[0];
  for (size_t i = 1; i < tmp.size(); ++i) {
    uint8_t cur = tmp[i];
    tmp[i] = (uint8_t)((int)cur - (int)prev + 128);
    prev = cur;
  }
  buf.swap(tmp);
}

bool zlib_inflate(const uint8_t *src, size_t n, std::vector<uint8_t> &dst) {
  uLongf dlen = (uLongf)dst.size();
  int rc = uncompress(dst.data(), &dlen, src, (uLong)n);
  if (rc != Z_OK || dlen != dst.size()) {
    set_error("zlib inflate failed");
    return false;
  }
  return true;
}

int lines_per_block(uint8_t compression) {
  switch (compression) {
    case 0: return 1;   // NONE
    case 1: return 1;   // RLE
    case 2: return 1;   // ZIPS
    case 3: return 16;  // ZIP
    case 4: return 32;  // PIZ
    case 5: return 16;  // PXR24
    case 6: return 32;  // B44
    case 7: return 32;  // B44A
    default: return -1;
  }
}

// ---------------------------------------------------------------------
// B44 / B44A decompression: HALF channels as 4x4 blocks of 14 packed
// bytes (3-byte flat blocks in B44A, marker b[2] == 0xfc); FLOAT
// channels stored raw, channel-major. Cross-checked against the Python
// decoder in bmfr_tpu/io/exr_py.py.
// ---------------------------------------------------------------------

void b44_unpack14(const uint8_t *b, uint16_t *t) {
  t[0] = (uint16_t)((b[0] << 8) | b[1]);
  const int shift = b[2] >> 2;
  const int bias = 0x20 << shift;
  t[4] = (uint16_t)(t[0] + ((((b[2] << 4) | (b[3] >> 4)) & 0x3F) << shift) - bias);
  t[8] = (uint16_t)(t[4] + ((((b[3] << 2) | (b[4] >> 6)) & 0x3F) << shift) - bias);
  t[12] = (uint16_t)(t[8] + ((b[4] & 0x3F) << shift) - bias);
  t[1] = (uint16_t)(t[0] + ((b[5] >> 2) << shift) - bias);
  t[5] = (uint16_t)(t[4] + ((((b[5] << 4) | (b[6] >> 4)) & 0x3F) << shift) - bias);
  t[9] = (uint16_t)(t[8] + ((((b[6] << 2) | (b[7] >> 6)) & 0x3F) << shift) - bias);
  t[13] = (uint16_t)(t[12] + ((b[7] & 0x3F) << shift) - bias);
  t[2] = (uint16_t)(t[1] + ((b[8] >> 2) << shift) - bias);
  t[6] = (uint16_t)(t[5] + ((((b[8] << 4) | (b[9] >> 4)) & 0x3F) << shift) - bias);
  t[10] = (uint16_t)(t[9] + ((((b[9] << 2) | (b[10] >> 6)) & 0x3F) << shift) - bias);
  t[14] = (uint16_t)(t[13] + ((b[10] & 0x3F) << shift) - bias);
  t[3] = (uint16_t)(t[2] + ((b[11] >> 2) << shift) - bias);
  t[7] = (uint16_t)(t[6] + ((((b[11] << 4) | (b[12] >> 4)) & 0x3F) << shift) - bias);
  t[11] = (uint16_t)(t[10] + ((((b[12] << 2) | (b[13] >> 6)) & 0x3F) << shift) - bias);
  t[15] = (uint16_t)(t[14] + ((b[13] & 0x3F) << shift) - bias);
}

inline uint16_t b44_untransform(uint16_t t) {
  return (t & 0x8000) ? (uint16_t)(t & 0x7FFF) : (uint16_t)(~t);
}

bool b44_uncompress_chunk(const uint8_t *cp, size_t packed,
                          const std::vector<int> &chan_types, int W,
                          int nlines, bool b44a,
                          std::vector<uint8_t> &raw) {
  const int nch = (int)chan_types.size();
  size_t line_bytes = 0;
  std::vector<size_t> col_off(nch);
  for (int c = 0; c < nch; ++c) {
    col_off[c] = line_bytes;
    line_bytes += (size_t)W * (chan_types[c] == 2 ? 4 : 2);
  }
  raw.assign(line_bytes * nlines, 0);
  size_t pos = 0;
  const int ph = (nlines + 3) & ~3, pw = (W + 3) & ~3;
  std::vector<uint16_t> vals((size_t)ph * pw);
  for (int c = 0; c < nch; ++c) {
    if (chan_types[c] != 1) {  // FLOAT stored raw, channel-major lines
      const size_t nb = 4 * (size_t)W;
      for (int y = 0; y < nlines; ++y) {
        if (pos + nb > packed) {
          set_error("truncated B44 chunk");
          return false;
        }
        std::memcpy(raw.data() + (size_t)y * line_bytes + col_off[c],
                    cp + pos, nb);
        pos += nb;
      }
      continue;
    }
    uint16_t t[16];
    for (int by = 0; by < ph; by += 4) {
      for (int bx = 0; bx < pw; bx += 4) {
        if (b44a && pos + 3 <= packed && cp[pos + 2] == 0xFC) {
          uint16_t t0 = (uint16_t)((cp[pos] << 8) | cp[pos + 1]);
          for (int i = 0; i < 16; ++i) t[i] = t0;
          pos += 3;
        } else {
          if (pos + 14 > packed) {
            set_error("truncated B44 chunk");
            return false;
          }
          b44_unpack14(cp + pos, t);
          pos += 14;
        }
        for (int r = 0; r < 4; ++r)
          for (int cc = 0; cc < 4; ++cc)
            vals[(size_t)(by + r) * pw + bx + cc] =
                b44_untransform(t[4 * r + cc]);
      }
    }
    for (int y = 0; y < nlines; ++y)
      std::memcpy(raw.data() + (size_t)y * line_bytes + col_off[c],
                  vals.data() + (size_t)y * pw, 2 * (size_t)W);
  }
  return true;
}

// ---------------------------------------------------------------------
// PIZ decompression (wavelet + Huffman), written from the OpenEXR file
// format spec; independently cross-checked against the pure-Python codec
// in bmfr_tpu/io/piz.py. The reference reads PIZ via OpenImageIO
// (/root/reference/opencl/bmfr.cpp:145-163).
// ---------------------------------------------------------------------

inline void wdec14(uint16_t l, uint16_t h, uint16_t &a, uint16_t &b) {
  int16_t ls = (int16_t)l, hs = (int16_t)h;
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  int16_t as = (int16_t)ai;
  int16_t bs = (int16_t)(as - hi);
  a = (uint16_t)as;
  b = (uint16_t)bs;
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t &a, uint16_t &b) {
  int m = l, d = h;
  int bb = (m - (d >> 1)) & 0xffff;
  int aa = (d + bb - 0x8000) & 0xffff;
  b = (uint16_t)bb;
  a = (uint16_t)aa;
}

// 2-D hierarchical wavelet decode on a strided uint16 plane.
void wav2_decode_u16(uint16_t *in, int nx, int ox, int ny, int oy,
                     uint16_t mx) {
  const bool w14 = mx < (1 << 14);
  int n = nx < ny ? nx : ny;
  int p = 1, p2;
  while (p <= n) p <<= 1;
  p >>= 1;
  p2 = p;
  p >>= 1;
  while (p >= 1) {
    uint16_t *py = in;
    uint16_t *ey = in + (ptrdiff_t)oy * (ny - p2);
    const ptrdiff_t oy1 = (ptrdiff_t)oy * p, oy2 = (ptrdiff_t)oy * p2;
    const ptrdiff_t ox1 = (ptrdiff_t)ox * p, ox2 = (ptrdiff_t)ox * p2;
    uint16_t i00, i01, i10, i11;
    for (; py <= ey; py += oy2) {
      uint16_t *px = py;
      uint16_t *ex = py + (ptrdiff_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t *q01 = px + ox1;
        uint16_t *q10 = px + oy1;
        uint16_t *q11 = q10 + ox1;
        if (w14) {
          wdec14(*px, *q10, i00, i10);
          wdec14(*q01, *q11, i01, i11);
          wdec14(i00, i01, *px, *q01);
          wdec14(i10, i11, *q10, *q11);
        } else {
          wdec16(*px, *q10, i00, i10);
          wdec16(*q01, *q11, i01, i11);
          wdec16(i00, i01, *px, *q01);
          wdec16(i10, i11, *q10, *q11);
        }
      }
      if (nx & p) {  // odd remainder column: vertical pairs
        uint16_t *q10 = px + oy1;
        if (w14) wdec14(*px, *q10, i00, *q10);
        else wdec16(*px, *q10, i00, *q10);
        *px = i00;
      }
    }
    if (ny & p) {  // odd remainder row: horizontal pairs
      uint16_t *px = py;
      uint16_t *ex = py + (ptrdiff_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t *q01 = px + ox1;
        if (w14) wdec14(*px, *q01, i00, *q01);
        else wdec16(*px, *q01, i00, *q01);
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// Huffman: canonical codes <= 58 bits; code lengths packed as 6-bit
// fields with zero-run escapes; run-length pseudo-symbol == iM followed
// by an 8-bit repeat count; bits MSB-first.
struct PizBitReader {
  const uint8_t *p, *end;
  uint64_t acc = 0;
  int n = 0;
  bool fail = false;
  PizBitReader(const uint8_t *p_, const uint8_t *e) : p(p_), end(e) {}
  uint32_t get(int nbits) {  // nbits <= 32
    while (n < nbits) {
      if (p >= end) {
        fail = true;
        return 0;
      }
      acc = (acc << 8) | *p++;
      n += 8;
    }
    n -= nbits;
    uint32_t v = (uint32_t)((acc >> n) & ((nbits == 32 ? 0xffffffffull
                                                       : (1ull << nbits) - 1)));
    acc &= n ? ((1ull << n) - 1) : 0;
    return v;
  }
};

const int PIZ_HUF_ENCSIZE = (1 << 16) + 1;
const int PIZ_SHORT_ZEROCODE_RUN = 59;
const int PIZ_LONG_ZEROCODE_RUN = 63;
const int PIZ_SHORTEST_LONG_RUN = 2 + PIZ_LONG_ZEROCODE_RUN -
                                  PIZ_SHORT_ZEROCODE_RUN;  // 6

bool piz_unpack_lengths(PizBitReader &r, uint32_t im, uint32_t iM,
                        std::vector<uint8_t> &len) {
  len.assign(PIZ_HUF_ENCSIZE, 0);
  uint32_t i = im;
  while (i <= iM) {
    uint32_t l = r.get(6);
    if (r.fail) break;
    if (l == (uint32_t)PIZ_LONG_ZEROCODE_RUN) {
      i += r.get(8) + PIZ_SHORTEST_LONG_RUN;
    } else if (l >= (uint32_t)PIZ_SHORT_ZEROCODE_RUN) {
      i += l - PIZ_SHORT_ZEROCODE_RUN + 2;
    } else {
      len[i++] = (uint8_t)l;
    }
  }
  if (r.fail || i != iM + 1) {
    set_error("corrupt PIZ huffman table");
    return false;
  }
  return true;
}

bool piz_huf_decompress(const uint8_t *src, size_t nsrc, uint16_t *out,
                        size_t n_out) {
  if (n_out == 0) return true;
  if (nsrc < 20) {
    set_error("corrupt PIZ huffman header");
    return false;
  }
  uint32_t im, iM, nbits;
  std::memcpy(&im, src, 4);
  std::memcpy(&iM, src + 4, 4);
  std::memcpy(&nbits, src + 12, 4);
  if (im >= PIZ_HUF_ENCSIZE || iM >= PIZ_HUF_ENCSIZE || im > iM) {
    set_error("corrupt PIZ huffman header");
    return false;
  }
  PizBitReader tr(src + 20, src + nsrc);
  std::vector<uint8_t> len;
  if (!piz_unpack_lengths(tr, im, iM, len)) return false;

  // canonical code assignment (counts per length; first code per length
  // computed longest-to-shortest; increasing symbol order within length)
  uint64_t cnt[59] = {0};
  for (int s = 0; s < PIZ_HUF_ENCSIZE; ++s) cnt[len[s]]++;
  cnt[0] = 0;
  uint64_t first[59] = {0};
  uint64_t c = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + cnt[i]) >> 1;
    first[i] = c;
    c = nc;
  }
  std::vector<uint64_t> code(PIZ_HUF_ENCSIZE, 0);
  {
    uint64_t nxt[59];
    std::memcpy(nxt, first, sizeof(nxt));
    for (int s = 0; s < PIZ_HUF_ENCSIZE; ++s)
      if (len[s]) code[s] = nxt[len[s]]++;
  }

  // 14-bit direct decode table; longer codes resolved canonically
  const int DEC = 14;
  std::vector<int32_t> tsym((size_t)1 << DEC, -1);
  std::vector<uint8_t> tlen((size_t)1 << DEC, 0);
  // per-length symbol lists for the long path
  std::vector<std::vector<uint32_t>> lsyms(59);
  for (int s = 0; s < PIZ_HUF_ENCSIZE; ++s) {
    int l = len[s];
    if (!l) continue;
    if (l <= DEC) {
      uint64_t base = code[s] << (DEC - l);
      uint64_t span = 1ull << (DEC - l);
      for (uint64_t k = 0; k < span; ++k) {
        tsym[base + k] = s;
        tlen[base + k] = (uint8_t)l;
      }
    } else {
      lsyms[l].push_back((uint32_t)s);
    }
  }

  const uint32_t rlc = iM;
  // leftover partial-byte table bits are discarded: the bit stream
  // restarts at the next whole byte
  const uint8_t *p = tr.p;
  const uint8_t *end = src + nsrc;
  unsigned __int128 acc = 0;
  int nacc = 0;
  size_t oi = 0;
  uint64_t consumed = 0;
  while (oi < n_out && consumed < nbits) {
    while (nacc < DEC && p < end) {
      acc = (acc << 8) | *p++;
      nacc += 8;
    }
    uint32_t peek;
    if (nacc >= DEC)
      peek = (uint32_t)((acc >> (nacc - DEC)) & ((1u << DEC) - 1));
    else
      peek = (uint32_t)((acc << (DEC - nacc)) & ((1u << DEC) - 1));
    int32_t s = tsym[peek];
    int l;
    if (s >= 0) {
      l = tlen[peek];
    } else {
      // long code: extend canonically past DEC bits
      l = DEC + 1;
      s = -1;
      while (l <= 58) {
        while (nacc < l && p < end) {
          acc = (acc << 8) | *p++;
          nacc += 8;
        }
        if (nacc < l) break;
        uint64_t cc = (uint64_t)((acc >> (nacc - l)) &
                                 (((unsigned __int128)1 << l) - 1));
        // canonical: codes of length l occupy [first[l], first[l]+cnt[l]),
        // assigned to lsyms[l] (all length-l symbols) in symbol order
        if (!lsyms[l].empty() && cc >= first[l] &&
            cc - first[l] < lsyms[l].size()) {
          s = (int32_t)lsyms[l][cc - first[l]];
          break;
        }
        ++l;
      }
      if (s < 0) {
        set_error("corrupt PIZ huffman data");
        return false;
      }
    }
    if (nacc < l) {
      set_error("corrupt PIZ huffman data");
      return false;
    }
    nacc -= l;
    acc &= nacc ? (((unsigned __int128)1 << nacc) - 1) : 0;
    consumed += l;
    if ((uint32_t)s == rlc) {
      while (nacc < 8 && p < end) {
        acc = (acc << 8) | *p++;
        nacc += 8;
      }
      if (nacc < 8) {
        set_error("corrupt PIZ huffman data");
        return false;
      }
      nacc -= 8;
      uint32_t rep = (uint32_t)((acc >> nacc) & 0xff);
      acc &= nacc ? (((unsigned __int128)1 << nacc) - 1) : 0;
      consumed += 8;
      if (oi == 0 || oi + rep > n_out) {
        set_error("corrupt PIZ run length");
        return false;
      }
      uint16_t v = out[oi - 1];
      for (uint32_t k = 0; k < rep; ++k) out[oi++] = v;
    } else {
      out[oi++] = (uint16_t)s;
    }
  }
  if (oi != n_out) {
    set_error("truncated PIZ huffman data");
    return false;
  }
  return true;
}

// Full PIZ chunk -> standard per-line-per-channel raw layout.
bool piz_uncompress_chunk(const uint8_t *cp, size_t packed,
                          const std::vector<int> &chan_bytes, int W,
                          int nlines, std::vector<uint8_t> &raw) {
  if (packed < 4) {
    set_error("corrupt PIZ chunk");
    return false;
  }
  uint16_t min_nz, max_nz;
  std::memcpy(&min_nz, cp, 2);
  std::memcpy(&max_nz, cp + 2, 2);
  size_t pos = 4;
  std::vector<uint8_t> bitmap((1 << 16) >> 3, 0);
  if (min_nz <= max_nz) {
    size_t nb = (size_t)max_nz - min_nz + 1;
    if (max_nz >= bitmap.size() || pos + nb > packed) {
      set_error("corrupt PIZ bitmap");
      return false;
    }
    std::memcpy(bitmap.data() + min_nz, cp + pos, nb);
    pos += nb;
  }
  // reverse LUT (zero is always index 0)
  std::vector<uint16_t> lut(1 << 16, 0);
  uint32_t k = 0;
  for (uint32_t d = 0; d < (1u << 16); ++d)
    if (d == 0 || (bitmap[d >> 3] & (1 << (d & 7)))) lut[k++] = (uint16_t)d;
  uint16_t max_value = (uint16_t)(k - 1);

  if (pos + 4 > packed) {
    set_error("corrupt PIZ chunk");
    return false;
  }
  int32_t huf_len;
  std::memcpy(&huf_len, cp + pos, 4);
  pos += 4;
  if (huf_len < 0 || pos + (size_t)huf_len > packed) {
    set_error("corrupt PIZ chunk length");
    return false;
  }

  const int nch = (int)chan_bytes.size();
  size_t total = 0;
  std::vector<size_t> chan_ushorts(nch);
  for (int c2 = 0; c2 < nch; ++c2) {
    chan_ushorts[c2] = (size_t)W * (chan_bytes[c2] / 2) * nlines;
    total += chan_ushorts[c2];
  }
  std::vector<uint16_t> data(total);
  if (!piz_huf_decompress(cp + pos, huf_len, data.data(), total))
    return false;

  // wavelet decode per channel (FLOAT channels: two interleaved planes)
  size_t off = 0;
  for (int c2 = 0; c2 < nch; ++c2) {
    int size = chan_bytes[c2] / 2;
    for (int j = 0; j < size; ++j)
      wav2_decode_u16(data.data() + off + j, W, size, nlines,
                      W * size, max_value);
    off += chan_ushorts[c2];
  }
  for (size_t i = 0; i < total; ++i) data[i] = lut[data[i]];

  // reassemble scanline layout
  size_t line_bytes = 0;
  for (int c2 = 0; c2 < nch; ++c2) line_bytes += (size_t)chan_bytes[c2] * W;
  raw.resize(line_bytes * nlines);
  uint8_t *rp = raw.data();
  for (int l = 0; l < nlines; ++l) {
    size_t chan_off = 0;
    for (int c2 = 0; c2 < nch; ++c2) {
      size_t row_ushorts = (size_t)W * (chan_bytes[c2] / 2);
      const uint16_t *srcp = data.data() + chan_off + (size_t)l * row_ushorts;
      std::memcpy(rp, srcp, row_ushorts * 2);
      rp += row_ushorts * 2;
      chan_off += chan_ushorts[c2];
    }
  }
  return true;
}

// PXR24 chunk -> standard raw layout. FLOAT channels are stored as three
// MSB-first byte planes of the float's top 24 bits (decode is exact);
// HALF as two byte planes; the whole buffer is delta-coded then zlib'd.
bool pxr24_uncompress_chunk(const uint8_t *cp, size_t packed,
                            const std::vector<int> &chan_types, int W,
                            int nlines, std::vector<uint8_t> &raw) {
  size_t tmp_line = 0;
  for (int t : chan_types) tmp_line += (size_t)W * (t == 2 ? 3 : 2);
  std::vector<uint8_t> tmp(tmp_line * nlines);
  if (!zlib_inflate(cp, packed, tmp)) return false;
  for (size_t i = 1; i < tmp.size(); ++i)
    tmp[i] = (uint8_t)((int)tmp[i - 1] + (int)tmp[i] - 128);

  size_t line_bytes = 0;
  for (int t : chan_types) line_bytes += (size_t)W * (t == 2 ? 4 : 2);
  raw.resize(line_bytes * nlines);
  const uint8_t *sp = tmp.data();
  uint8_t *rp = raw.data();
  for (int l = 0; l < nlines; ++l) {
    for (int t : chan_types) {
      if (t == 2) {  // FLOAT
        const uint8_t *b0 = sp, *b1 = sp + W, *b2 = sp + 2 * (size_t)W;
        sp += 3 * (size_t)W;
        for (int x = 0; x < W; ++x) {
          uint32_t u = ((uint32_t)b0[x] << 24) | ((uint32_t)b1[x] << 16) |
                       ((uint32_t)b2[x] << 8);
          std::memcpy(rp, &u, 4);
          rp += 4;
        }
      } else {  // HALF
        const uint8_t *hi = sp, *lo = sp + W;
        sp += 2 * (size_t)W;
        for (int x = 0; x < W; ++x) {
          uint16_t u = (uint16_t)(((uint16_t)hi[x] << 8) | lo[x]);
          std::memcpy(rp, &u, 2);
          rp += 2;
        }
      }
    }
  }
  return true;
}

// EXR RLE codec (ImfRle.cpp semantics): signed count byte; negative =
// that many literal bytes follow, non-negative = count+1 copies of the
// next byte. Applied to the same filtered/interleaved byte stream as ZIP.
bool rle_decompress(const uint8_t *src, size_t n, std::vector<uint8_t> &dst) {
  size_t di = 0;
  const uint8_t *end = src + n;
  while (src < end) {
    int count = (int8_t)*src++;
    if (count < 0) {
      size_t len = (size_t)(-count);
      if (src + len > end || di + len > dst.size()) {
        set_error("corrupt RLE data");
        return false;
      }
      std::memcpy(dst.data() + di, src, len);
      src += len;
      di += len;
    } else {
      size_t len = (size_t)count + 1;
      if (src >= end || di + len > dst.size()) {
        set_error("corrupt RLE data");
        return false;
      }
      std::memset(dst.data() + di, *src++, len);
      di += len;
    }
  }
  if (di != dst.size()) {
    set_error("RLE size mismatch");
    return false;
  }
  return true;
}

size_t rle_compress(const uint8_t *src, size_t n, std::vector<uint8_t> &out) {
  // Simple conformant encoder: runs of >=3 as repeats, else literals.
  out.clear();
  size_t i = 0;
  while (i < n) {
    size_t run = 1;
    while (i + run < n && src[i + run] == src[i] && run < 128) run++;
    if (run >= 3) {
      out.push_back((uint8_t)(run - 1));
      out.push_back(src[i]);
      i += run;
    } else {
      size_t lit = i;
      size_t len = 0;
      while (i < n && len < 127) {
        size_t r = 1;
        while (i + r < n && src[i + r] == src[i] && r < 128) r++;
        if (r >= 3) break;
        i += r;
        len += r;
      }
      out.push_back((uint8_t)(-(int)len));
      out.insert(out.end(), src + lit, src + lit + len);
    }
  }
  return out.size();
}

// Decode one EXR file into interleaved RGB float32 (out[h][w][c]).
// Channel mapping: R,G,B -> 0,1,2; single/other channel sets are mapped in
// file order.
bool decode_exr(const char *path, float *out, int exp_w, int exp_h,
                int exp_c) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return false;
  Reader r(buf);
  ExrHeader h;
  if (!parse_exr_header(r, h)) return false;
  const int W = h.width(), H = h.height();
  if (W != exp_w || H != exp_h) {
    set_error("unexpected EXR size");
    return false;
  }
  const int lpb = lines_per_block(h.compression);
  if (lpb < 0) {
    set_error("unsupported EXR compression " +
              std::to_string((int)h.compression));
    return false;
  }
  const int nch = (int)h.channels.size();

  // channel -> output index
  std::vector<int> chan_out(nch);
  for (int c = 0; c < nch; ++c) {
    const std::string &n = h.channels[c].name;
    int idx;
    if (n == "R" || n == "r") idx = 0;
    else if (n == "G" || n == "g") idx = 1;
    else if (n == "B" || n == "b") idx = 2;
    else idx = c;  // file order for non-RGB layouts
    chan_out[c] = idx < exp_c ? idx : -1;
  }

  // bytes per pixel per channel
  std::vector<int> chan_bytes(nch);
  size_t line_bytes = 0;
  for (int c = 0; c < nch; ++c) {
    chan_bytes[c] = h.channels[c].pixel_type == 1 ? 2 : 4;
    if (h.channels[c].pixel_type == 0) {
      set_error("UINT EXR channels not supported");
      return false;
    }
    line_bytes += (size_t)chan_bytes[c] * W;
  }

  const int nblocks = (H + lpb - 1) / lpb;
  // line offset table
  std::vector<uint64_t> offsets(nblocks);
  for (int b = 0; b < nblocks; ++b) offsets[b] = r.u64();
  if (r.fail) {
    set_error("corrupt EXR offset table");
    return false;
  }

  std::vector<uint8_t> raw;
  for (int b = 0; b < nblocks; ++b) {
    // All chunk metadata is untrusted file content: validate the offset
    // (overflow-safe), the chunk's y origin (a negative/huge y0 would
    // write out of bounds below), and the packed size before touching it.
    if (offsets[b] > buf.size() || buf.size() - offsets[b] < 8) {
      set_error("corrupt EXR chunk offset");
      return false;
    }
    const uint8_t *cp = buf.data() + offsets[b];
    int32_t y0;
    uint32_t packed;
    std::memcpy(&y0, cp, 4);
    std::memcpy(&packed, cp + 4, 4);
    cp += 8;
    if (packed > buf.size() - offsets[b] - 8) {
      set_error("corrupt EXR chunk size");
      return false;
    }
    if (y0 < h.ymin || y0 > h.ymax) {
      set_error("corrupt EXR chunk y origin");
      return false;
    }
    const int ylo = y0 - h.ymin;
    const int nlines = std::min(lpb, H - ylo);
    if (nlines <= 0) {
      set_error("corrupt EXR chunk line count");
      return false;
    }
    const size_t unpacked = line_bytes * (size_t)nlines;

    const uint8_t *data_ptr;
    if (h.compression == 0 || packed >= unpacked) {
      if (packed < unpacked) {
        set_error("truncated raw EXR chunk");
        return false;
      }
      data_ptr = cp;  // stored raw
    } else if (h.compression == 4) {
      if (!piz_uncompress_chunk(cp, packed, chan_bytes, W, nlines, raw))
        return false;
      data_ptr = raw.data();
    } else if (h.compression == 5) {
      std::vector<int> chan_types(nch);
      for (int c = 0; c < nch; ++c) chan_types[c] = h.channels[c].pixel_type;
      if (!pxr24_uncompress_chunk(cp, packed, chan_types, W, nlines, raw))
        return false;
      data_ptr = raw.data();
    } else if (h.compression == 6 || h.compression == 7) {
      std::vector<int> chan_types(nch);
      for (int c = 0; c < nch; ++c) chan_types[c] = h.channels[c].pixel_type;
      if (!b44_uncompress_chunk(cp, packed, chan_types, W, nlines,
                                h.compression == 7, raw))
        return false;
      data_ptr = raw.data();
    } else {
      raw.assign(unpacked, 0);
      if (h.compression == 1) {
        if (!rle_decompress(cp, packed, raw)) return false;
      } else {
        if (!zlib_inflate(cp, packed, raw)) return false;
      }
      exr_unfilter(raw);
      data_ptr = raw.data();
    }

    // scanlines: per line, per channel (file order), W values
    const uint8_t *sp = data_ptr;
    for (int l = 0; l < nlines; ++l) {
      const int y = ylo + l;
      for (int c = 0; c < nch; ++c) {
        const int oc = chan_out[c];
        if (h.channels[c].pixel_type == 1) {
          const uint16_t *hp = (const uint16_t *)sp;
          if (oc >= 0)
            for (int x = 0; x < W; ++x)
              out[((size_t)y * W + x) * exp_c + oc] = half_to_float(hp[x]);
          sp += 2 * (size_t)W;
        } else {
          const float *fp = (const float *)sp;
          if (oc >= 0)
            for (int x = 0; x < W; ++x)
              out[((size_t)y * W + x) * exp_c + oc] = fp[x];
          sp += 4 * (size_t)W;
        }
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------
// PNG writer (zlib only, no libpng)
// ---------------------------------------------------------------------
void put_u32_be(std::vector<uint8_t> &v, uint32_t x) {
  v.push_back((uint8_t)(x >> 24));
  v.push_back((uint8_t)(x >> 16));
  v.push_back((uint8_t)(x >> 8));
  v.push_back((uint8_t)x);
}

void png_chunk(std::vector<uint8_t> &out, const char *tag,
               const std::vector<uint8_t> &data) {
  put_u32_be(out, (uint32_t)data.size());
  size_t crc_start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data.begin(), data.end());
  uint32_t crc = crc32(0, out.data() + crc_start, (uInt)(out.size() - crc_start));
  put_u32_be(out, crc);
}

bool write_png_impl(const char *path, const uint8_t *img, int w, int h,
                    int c) {
  if (c != 3 && c != 1 && c != 4) {
    set_error("png: channels must be 1, 3 or 4");
    return false;
  }
  std::vector<uint8_t> out;
  const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A, 0x0A};
  out.insert(out.end(), sig, sig + 8);

  std::vector<uint8_t> ihdr;
  put_u32_be(ihdr, (uint32_t)w);
  put_u32_be(ihdr, (uint32_t)h);
  ihdr.push_back(8);  // bit depth
  ihdr.push_back(c == 1 ? 0 : (c == 3 ? 2 : 6));  // color type
  ihdr.push_back(0);
  ihdr.push_back(0);
  ihdr.push_back(0);
  png_chunk(out, "IHDR", ihdr);

  // filter byte 0 per row
  std::vector<uint8_t> rawbuf((size_t)h * ((size_t)w * c + 1));
  for (int y = 0; y < h; ++y) {
    uint8_t *row = rawbuf.data() + (size_t)y * ((size_t)w * c + 1);
    row[0] = 0;
    std::memcpy(row + 1, img + (size_t)y * w * c, (size_t)w * c);
  }
  uLongf zlen = compressBound((uLong)rawbuf.size());
  std::vector<uint8_t> zbuf(zlen);
  if (compress2(zbuf.data(), &zlen, rawbuf.data(), (uLong)rawbuf.size(), 6) !=
      Z_OK) {
    set_error("png: zlib compress failed");
    return false;
  }
  zbuf.resize(zlen);
  png_chunk(out, "IDAT", zbuf);
  png_chunk(out, "IEND", {});

  FILE *f = std::fopen(path, "wb");
  if (!f) {
    set_error(std::string("cannot create ") + path);
    return false;
  }
  size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (wrote != out.size()) {
    set_error("png: short write");
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------
// PNG reader (zlib only). Covers what OpenImageIO-written reference
// outputs use: 8/16-bit gray/RGB/RGBA, filters 0-4, no interlace/palette.
// ---------------------------------------------------------------------
uint32_t rd_u32_be(const uint8_t *p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

bool png_unfilter(std::vector<uint8_t> &raw, int h, size_t stride, int bpp) {
  // in place: raw holds h * (1 + stride) filtered bytes; compacts to
  // h * stride unfiltered bytes at the front.
  std::vector<uint8_t> prev(stride, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t *src = raw.data() + (size_t)y * (stride + 1);
    uint8_t ftype = src[0];
    uint8_t *row = raw.data() + (size_t)y * stride;
    std::memmove(row, src + 1, stride);
    switch (ftype) {
      case 0:
        break;
      case 1:  // Sub
        for (size_t i = bpp; i < stride; ++i) row[i] += row[i - bpp];
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i) row[i] += prev[i];
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          int left = i >= (size_t)bpp ? row[i - bpp] : 0;
          row[i] = (uint8_t)(row[i] + ((left + prev[i]) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= (size_t)bpp ? row[i - bpp] : 0;
          int b = prev[i];
          int cc = i >= (size_t)bpp ? prev[i - bpp] : 0;
          int p = a + b - cc;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - cc);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : cc);
          row[i] = (uint8_t)(row[i] + pred);
        }
        break;
      default:
        set_error("png: unknown filter type");
        return false;
    }
    std::memcpy(prev.data(), row, stride);
  }
  return true;
}

struct PngInfo {
  int width = 0, height = 0, channels = 0, bitdepth = 0;
};

bool png_parse(const std::vector<uint8_t> &buf, PngInfo &info,
               std::vector<uint8_t> &idat) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A, 0x0A};
  if (buf.size() < 8 || std::memcmp(buf.data(), sig, 8) != 0) {
    set_error("png: bad signature");
    return false;
  }
  size_t pos = 8;
  bool have_ihdr = false;
  while (pos + 8 <= buf.size()) {
    uint32_t length = rd_u32_be(buf.data() + pos);
    const uint8_t *tag = buf.data() + pos + 4;
    if (length > buf.size() - pos - 8) {
      set_error("png: truncated chunk");
      return false;
    }
    const uint8_t *data = buf.data() + pos + 8;
    pos += 12 + (size_t)length;  // length + tag + data + crc
    if (std::memcmp(tag, "IHDR", 4) == 0) {
      if (length != 13) {
        set_error("png: bad IHDR");
        return false;
      }
      info.width = (int)rd_u32_be(data);
      info.height = (int)rd_u32_be(data + 4);
      info.bitdepth = data[8];
      int ctype = data[9];
      int interlace = data[12];
      static const int chan_of[7] = {1, -1, 3, -1, 2, -1, 4};
      info.channels = (ctype >= 0 && ctype <= 6) ? chan_of[ctype] : -1;
      if (info.channels < 0 || (info.bitdepth != 8 && info.bitdepth != 16) ||
          interlace != 0 || info.width <= 0 || info.height <= 0 ||
          info.width > 1 << 20 || info.height > 1 << 20) {
        set_error("png: unsupported format");
        return false;
      }
      have_ihdr = true;
    } else if (std::memcmp(tag, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + length);
    } else if (std::memcmp(tag, "IEND", 4) == 0) {
      break;
    }
  }
  if (!have_ihdr || idat.empty()) {
    set_error("png: missing IHDR/IDAT");
    return false;
  }
  return true;
}

// Decode a PNG into float32 RGB in [0, 1] (alpha dropped, gray broadcast).
// out must hold w * h * 3 floats matching the probed size.
bool read_png_impl(const char *path, float *out, int exp_w, int exp_h) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return false;
  PngInfo info;
  std::vector<uint8_t> idat;
  if (!png_parse(buf, info, idat)) return false;
  if (info.width != exp_w || info.height != exp_h) {
    set_error("png: unexpected size");
    return false;
  }
  const int bpp = info.channels * (info.bitdepth / 8);
  const size_t stride = (size_t)info.width * bpp;
  std::vector<uint8_t> raw((stride + 1) * (size_t)info.height);
  if (!zlib_inflate(idat.data(), idat.size(), raw)) return false;
  if (!png_unfilter(raw, info.height, stride, bpp)) return false;

  const float maxv = info.bitdepth == 16 ? 65535.0f : 255.0f;
  const int in_c = info.channels;
  const int color_c = in_c >= 3 ? 3 : 1;  // gray / gray+alpha broadcast
  for (int y = 0; y < info.height; ++y) {
    const uint8_t *row = raw.data() + (size_t)y * stride;
    for (int x = 0; x < info.width; ++x) {
      float rgb[3];
      for (int c = 0; c < 3; ++c) {
        int sc = c < color_c ? c : 0;
        float v;
        if (info.bitdepth == 16) {
          const uint8_t *p = row + ((size_t)x * in_c + sc) * 2;
          v = (float)(((uint16_t)p[0] << 8) | p[1]);  // PNG is big-endian
        } else {
          v = (float)row[(size_t)x * in_c + sc];
        }
        rgb[c] = v / maxv;
      }
      float *op = out + ((size_t)y * info.width + x) * 3;
      op[0] = rgb[0];
      op[1] = rgb[1];
      op[2] = rgb[2];
    }
  }
  return true;
}

bool probe_png_impl(const char *path, int *w, int *h) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return false;
  PngInfo info;
  std::vector<uint8_t> idat;
  if (!png_parse(buf, info, idat)) return false;
  *w = info.width;
  *h = info.height;
  return true;
}

// ---------------------------------------------------------------------
// EXR writer (scanline, ZIP, float or half, RGB)
// ---------------------------------------------------------------------
void wr_str(std::vector<uint8_t> &v, const char *s) {
  v.insert(v.end(), s, s + std::strlen(s) + 1);
}

void wr_u32(std::vector<uint8_t> &v, uint32_t x) {
  const uint8_t *p = (const uint8_t *)&x;
  v.insert(v.end(), p, p + 4);
}

void wr_u64(std::vector<uint8_t> &v, uint64_t x) {
  const uint8_t *p = (const uint8_t *)&x;
  v.insert(v.end(), p, p + 8);
}

void wr_f32(std::vector<uint8_t> &v, float x) {
  const uint8_t *p = (const uint8_t *)&x;
  v.insert(v.end(), p, p + 4);
}

bool write_exr_impl(const char *path, const float *img, int w, int h, int c,
                    bool half, int compression) {
  if (c != 3) {
    set_error("exr writer: only 3 channels supported");
    return false;
  }
  std::vector<uint8_t> out;
  wr_u32(out, 20000630u);
  wr_u32(out, 2u);

  auto attr = [&](const char *name, const char *type,
                  const std::vector<uint8_t> &data) {
    wr_str(out, name);
    wr_str(out, type);
    wr_u32(out, (uint32_t)data.size());
    out.insert(out.end(), data.begin(), data.end());
  };

  // channels (alphabetical: B, G, R)
  std::vector<uint8_t> chl;
  const char *names[3] = {"B", "G", "R"};
  for (int i = 0; i < 3; ++i) {
    wr_str(chl, names[i]);
    wr_u32(chl, half ? 1u : 2u);
    chl.push_back(0);  // pLinear
    chl.push_back(0);
    chl.push_back(0);
    chl.push_back(0);
    wr_u32(chl, 1);  // xSampling
    wr_u32(chl, 1);  // ySampling
  }
  chl.push_back(0);
  attr("channels", "chlist", chl);

  if (compression != 0 && compression != 1 && compression != 2 &&
      compression != 3) {
    set_error("exr writer: compression must be NONE(0), RLE(1), ZIPS(2) "
              "or ZIP(3)");
    return false;
  }
  std::vector<uint8_t> comp = {(uint8_t)compression};
  attr("compression", "compression", comp);

  std::vector<uint8_t> dw;
  wr_u32(dw, 0);
  wr_u32(dw, 0);
  wr_u32(dw, (uint32_t)(w - 1));
  wr_u32(dw, (uint32_t)(h - 1));
  attr("dataWindow", "box2i", dw);
  attr("displayWindow", "box2i", dw);

  std::vector<uint8_t> lo = {0};  // INCREASING_Y
  attr("lineOrder", "lineOrder", lo);

  std::vector<uint8_t> par;
  wr_f32(par, 1.0f);
  attr("pixelAspectRatio", "float", par);

  std::vector<uint8_t> swc;
  wr_f32(swc, 0.0f);
  wr_f32(swc, 0.0f);
  attr("screenWindowCenter", "v2f", swc);

  std::vector<uint8_t> sww;
  wr_f32(sww, 1.0f);
  attr("screenWindowWidth", "float", sww);

  out.push_back(0);  // end of header

  const int lpb = compression == 3 ? 16 : 1;
  const int nblocks = (h + lpb - 1) / lpb;
  const size_t px_bytes = half ? 2 : 4;
  const size_t line_bytes = px_bytes * (size_t)w * 3;

  size_t table_pos = out.size();
  out.resize(out.size() + 8 * (size_t)nblocks);

  std::vector<uint64_t> offsets(nblocks);
  std::vector<uint8_t> rawbuf, zbuf;
  // file channel order B,G,R -> source channel 2,1,0
  const int src_chan[3] = {2, 1, 0};
  for (int b = 0; b < nblocks; ++b) {
    offsets[b] = out.size();
    const int ylo = b * lpb;
    const int nlines = std::min(lpb, h - ylo);
    rawbuf.resize(line_bytes * (size_t)nlines);
    uint8_t *rp = rawbuf.data();
    for (int l = 0; l < nlines; ++l) {
      const int y = ylo + l;
      for (int fc = 0; fc < 3; ++fc) {
        const int sc = src_chan[fc];
        if (half) {
          uint16_t *hp = (uint16_t *)rp;
          for (int x = 0; x < w; ++x)
            hp[x] = float_to_half(img[((size_t)y * w + x) * 3 + sc]);
        } else {
          float *fp = (float *)rp;
          for (int x = 0; x < w; ++x)
            fp[x] = img[((size_t)y * w + x) * 3 + sc];
        }
        rp += px_bytes * (size_t)w;
      }
    }
    size_t zlen = 0;
    if (compression == 0) {
      zlen = rawbuf.size();  // force raw path below
    } else {
      exr_filter(rawbuf);
      if (compression == 1) {
        zlen = rle_compress(rawbuf.data(), rawbuf.size(), zbuf);
      } else {  // ZIPS(2) and ZIP(3) share the zlib path
        uLongf zl = compressBound((uLong)rawbuf.size());
        zbuf.resize(zl);
        if (compress2(zbuf.data(), &zl, rawbuf.data(), (uLong)rawbuf.size(),
                      6) != Z_OK) {
          set_error("exr: zlib compress failed");
          return false;
        }
        zlen = zl;
      }
    }
    wr_u32(out, (uint32_t)ylo);
    if (compression != 0 && zlen < rawbuf.size()) {
      wr_u32(out, (uint32_t)zlen);
      out.insert(out.end(), zbuf.begin(), zbuf.begin() + zlen);
    } else {
      // store raw when compression doesn't help (or NONE)
      if (compression != 0) exr_unfilter(rawbuf);
      wr_u32(out, (uint32_t)rawbuf.size());
      out.insert(out.end(), rawbuf.begin(), rawbuf.end());
    }
  }
  std::memcpy(out.data() + table_pos, offsets.data(), 8 * (size_t)nblocks);

  FILE *f = std::fopen(path, "wb");
  if (!f) {
    set_error(std::string("cannot create ") + path);
    return false;
  }
  size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (wrote != out.size()) {
    set_error("exr: short write");
    return false;
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------
extern "C" {

const char *bmfr_last_error() { return g_last_error.c_str(); }

int bmfr_exr_read_header(const char *path, int *w, int *h, int *c) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return 1;
  Reader r(buf);
  ExrHeader hd;
  if (!parse_exr_header(r, hd)) return 1;
  *w = hd.width();
  *h = hd.height();
  *c = (int)hd.channels.size();
  return 0;
}

int bmfr_exr_read(const char *path, float *out, int w, int h, int c) {
  std::memset(out, 0, (size_t)w * h * c * sizeof(float));
  return decode_exr(path, out, w, h, c) ? 0 : 1;
}

int bmfr_exr_write(const char *path, const float *img, int w, int h, int c,
                   int half) {
  return write_exr_impl(path, img, w, h, c, half != 0, 3) ? 0 : 1;
}

int bmfr_exr_write_ex(const char *path, const float *img, int w, int h,
                      int c, int half, int compression) {
  return write_exr_impl(path, img, w, h, c, half != 0, compression) ? 0 : 1;
}

int bmfr_png_write(const char *path, const uint8_t *img, int w, int h,
                   int c) {
  return write_png_impl(path, img, w, h, c) ? 0 : 1;
}

int bmfr_png_probe(const char *path, int *w, int *h) {
  return probe_png_impl(path, w, h) ? 0 : 1;
}

// out: w*h*3 float32, RGB in [0,1] (alpha dropped, gray broadcast).
int bmfr_png_read(const char *path, float *out, int w, int h) {
  return read_png_impl(path, out, w, h) ? 0 : 1;
}

// Threaded batch loader: the OpenMP-parallel-for equivalent
// (opencl/bmfr.cpp:259-307). Returns 0 if every file decoded.
int bmfr_load_frames(const char **paths, int n, float *out, int w, int h,
                     int c, int threads) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads > n) threads = n > 0 ? n : 1;
  std::atomic<int> next(0);
  std::atomic<int> errors(0);
  // Per-call locals (captured by reference below): concurrent invocations
  // from parallel Python threads (ctypes releases the GIL) must not share
  // error state.
  std::mutex err_mu;
  std::string first_error;
  const size_t frame_elems = (size_t)w * h * c;

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (!decode_exr(paths[i], out + frame_elems * (size_t)i, w, h, c)) {
        errors.fetch_add(1);
        std::lock_guard<std::mutex> g(err_mu);
        if (first_error.empty())
          first_error = std::string(paths[i]) + ": " + g_last_error;
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t) ts.emplace_back(worker);
  for (auto &t : ts) t.join();
  if (errors.load() > 0) {
    set_error(first_error);
    return 1;
  }
  return 0;
}

}  // extern "C"
