// groan_rs_tpu native trajectory codec.
//
// Host-side C++ implementation of the Gromacs XDR trajectory formats:
//   - XTC: big-endian XDR framing + the lossy "3dfcoord" integer-quantized,
//     variable-bit-packed coordinate compression (magic 1995 and the
//     large-frame magic 2023 variant with a 64-bit payload size)
//   - TRR: XDR framing with optional single/double precision x/v/f blocks
//
// This replaces the role of the reference's vendored C xdrfile library and
// the molly Rust crate (see /root/reference/external/xdrfile/ and
// src/io/xtc_io/molly_xtc.rs) with a from-scratch, buffer-oriented design:
// frames are located by an O(frames) header scan (offset index), then
// decoded in bulk into caller-provided [nframes, natoms, 3] float buffers,
// optionally stopping early after the first K atoms (partial-frame reads:
// decompression is sequential, so "partial" = stop once the last selected
// atom has been produced — the same trick molly uses).  Multi-frame decode
// fans out across a thread pool (frames are independent).
//
// The 3dfcoord bit format implemented here is the public-domain algorithm
// from the Gromacs XTC specification (magicints table, sizeofints
// multi-radix packing, run-length encoded "small" deltas with the
// water-molecule atom-swap optimization).
//
// Provenance note: the DECODER is a from-scratch redesign (pread reader,
// left-aligned 64-bit MSB-first BitReader with single-refill multi-radix
// unpack and reciprocal division, frame-parallel pool, partial-frame early
// stop, int16 quantized output). The ENCODER's control flow necessarily
// mirrors the canonical public-domain/BSD xdrfile compressor
// (xdrfile_compress_coord_float) because byte-identical output is a
// correctness requirement — the smallidx adaptation and run heuristics ARE
// the format; tests assert byte-for-byte round trips against
// gromacs-written fixtures.
//
// C ABI exported at the bottom; Python binds via ctypes (io/native.py).

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cmath>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

// ------------------------------------------------------------------ errors
enum GxError : int64_t {
  GX_OK = 0,
  GX_ERR_OPEN = -1,
  GX_ERR_MAGIC = -2,
  GX_ERR_CORRUPT = -3,
  GX_ERR_NATOMS = -4,
  GX_ERR_IO = -5,
  GX_ERR_RANGE = -6,
  GX_ERR_PRECISION = -7,
  GX_ERR_Q16 = -8,  // quantized ints do not fit int16 (q16 decode only)
  GX_ERR_DELTA = -9,  // inter-frame deltas do not fit int8 (delta wire only)
  GX_ERR_CAP = -10,  // caller-provided output capacity exceeded
};

// ------------------------------------------------------------------ XDR helpers
inline uint32_t load_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}
inline uint64_t load_be64(const uint8_t* p) {
  return (uint64_t(load_be32(p)) << 32) | load_be32(p + 4);
}
inline int32_t load_i32(const uint8_t* p) { return int32_t(load_be32(p)); }
inline float load_f32(const uint8_t* p) {
  uint32_t v = load_be32(p);
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}
inline double load_f64(const uint8_t* p) {
  uint64_t v = load_be64(p);
  double d;
  std::memcpy(&d, &v, 8);
  return d;
}
inline void store_be32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}
inline void store_i32(uint8_t* p, int32_t v) { store_be32(p, uint32_t(v)); }
inline void store_f32(uint8_t* p, float f) {
  uint32_t v;
  std::memcpy(&v, &f, 4);
  store_be32(p, v);
}

// ------------------------------------------------------------------ file reader
struct FileReader {
  int fd = -1;
  int64_t size = 0;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    size = ::lseek(fd, 0, SEEK_END);
    return size >= 0;
  }
  ~FileReader() {
    if (fd >= 0) ::close(fd);
  }
  bool read_at(int64_t off, void* dst, int64_t n) const {
    int64_t got = 0;
    while (got < n) {
      ssize_t r = ::pread(fd, static_cast<uint8_t*>(dst) + got, size_t(n - got), off + got);
      if (r <= 0) return false;
      got += r;
    }
    return true;
  }
};

// ------------------------------------------------------------------ 3dfcoord tables
// Magic quantization table of the XTC format specification.
constexpr int kMagicInts[] = {
    0,        0,        0,       0,       0,       0,       0,       0,       0,
    8,        10,       12,      16,      20,      25,      32,      40,      50,
    64,       80,       101,     128,     161,     203,     256,     322,     406,
    512,      645,      812,     1024,    1290,    1625,    2048,    2580,    3250,
    4096,     5060,     6501,    8192,    10321,   13003,   16384,   20642,   26007,
    32768,    41285,    52015,   65536,   82570,   104031,  131072,  165140,  208063,
    262144,   330280,   416127,  524287,  660561,  832255,  1048576, 1321122, 1664510,
    2097152,  2642245,  3329021, 4194304, 5284491, 6658042, 8388607, 10568983,
    13316085, 16777216};
constexpr int kFirstIdx = 9;
constexpr int kLastIdx = int(sizeof(kMagicInts) / sizeof(int)) - 1;

// exact-division magic number m = ceil(2^64 / d) (see
// BitReader::fast_divm); 0 marks the d <= 1 identity case
constexpr uint64_t magic_of_u32(uint32_t d) {
  return d <= 1 ? 0 : ~uint64_t(0) / d + 1;
}

// magics for every kMagicInts entry, computed at compile time
constexpr std::array<uint64_t, size_t(kLastIdx) + 1> make_magic_table() {
  std::array<uint64_t, size_t(kLastIdx) + 1> t{};
  for (int i = 0; i <= kLastIdx; i++)
    t[size_t(i)] = magic_of_u32(uint32_t(kMagicInts[i]));
  return t;
}
constexpr auto kMagicDiv = make_magic_table();

// number of bits needed to represent values in [0, size]
int sizeof_int(int size) {
  int num = 1, nbits = 0;
  while (size >= num && nbits < 32) {
    nbits++;
    num <<= 1;
  }
  return nbits;
}

// bits needed for a multi-radix packed triple with per-axis ranges sizes[]
int sizeof_ints(int n, const uint32_t sizes[]) {
  uint32_t bytes[32];
  uint32_t nbytes = 1;
  bytes[0] = 1;
  int nbits = 0;
  for (int i = 0; i < n; i++) {
    uint64_t tmp = 0;
    uint32_t bytecnt = 0;
    for (; bytecnt < nbytes; bytecnt++) {
      tmp += uint64_t(bytes[bytecnt]) * sizes[i];
      bytes[bytecnt] = tmp & 0xff;
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[bytecnt++] = tmp & 0xff;
      tmp >>= 8;
    }
    nbytes = bytecnt;
  }
  uint32_t num = 1;
  nbytes--;
  while (bytes[nbytes] >= num) {
    nbits++;
    num *= 2;
  }
  return nbits + int(nbytes) * 8;
}

// ------------------------------------------------------------------ bit reader
// MSB-first bit stream over the packed payload.  Keeps a left-aligned
// 64-bit accumulator refilled bytewise, so any read of <= 57 bits is two
// shifts — this is the decode hot loop (every coordinate of every frame
// goes through here), replacing the reference's byte-at-a-time state
// machine (xdrfile.c decodebits) with ~4x fewer operations per value.
struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t cnt = 0;       // bytes consumed into acc
  uint64_t acc = 0;     // left-aligned pending bits
  int nbits = 0;        // valid bits in acc

  inline void refill() {
    if (nbits > 56) return;
    if (cnt + 8 <= len) {
      // bulk path: one unaligned big-endian load refills up to 8 bytes.
      // OR-ing a partially-consumed byte again is idempotent (identical
      // bits land at identical positions), so only whole bytes advance cnt.
      uint64_t chunk;
      std::memcpy(&chunk, data + cnt, 8);
      chunk = __builtin_bswap64(chunk);
      acc |= chunk >> nbits;
      int take = (64 - nbits) >> 3;
      cnt += size_t(take);
      nbits += take * 8;
      return;
    }
    while (nbits <= 56) {
      uint64_t byte = (cnt < len) ? data[cnt] : 0;  // zero-pad past EOF
      cnt++;
      acc |= byte << (56 - nbits);
      nbits += 8;
    }
  }

  // n <= 57; reads past the real payload consume zero-padding (see
  // overrun() for detection)
  inline uint64_t get64(int n) {
    refill();
    uint64_t v = acc >> (64 - n);
    acc <<= n;
    nbits -= n;
    return v;
  }

  // Consumption (cnt, nbits) is monotone, so evaluating "did we read past
  // the payload" on demand at the former sticky-flag checkpoints is
  // equivalent to updating a flag inside every get64 — and removes a
  // compare+set from the per-value hot path.
  inline bool overrun() const { return cnt * 8 - size_t(nbits) > len * 8; }

  inline int get(int n) { return n == 0 ? 0 : int(get64(n)); }

  // exact magic-number division, one widening multiply + one conditional
  // decrement (no int<->double converts, no fixup loop): with
  // m = ceil(2^64/d) the estimate floor(x*m / 2^64) = floor(x/d) + {0,1}
  // for ANY x < 2^64, and never undershoots.  `magic_of` returns 0 for
  // d <= 1 (the q = x identity case, branched on here).
  static constexpr uint64_t magic_of(uint32_t d) { return magic_of_u32(d); }
  static inline uint64_t fast_divm(uint64_t x, uint32_t d, uint64_t m) {
    if (m == 0) return x;  // d == 1
    uint64_t q = uint64_t((unsigned __int128)(x) * m >> 64);
    if (q * uint64_t(d) > x) q--;
    return q;
  }

  // Reassemble a least-significant-chunk-first packed value from its raw
  // MSB-first stream image `v` (low nbits_total bits valid).  The stream
  // holds the chunks first-chunk-first: [c0 (8b)][c1 (8b)]...[ck (rem)];
  // the packed integer is X = c0 + c1*2^8 + ... + ck*2^(8k).  bswap
  // reverses the byte order in O(1); the final (rem<8)-bit chunk lands
  // high-aligned inside its byte and is re-seated explicitly.
  static inline uint64_t reassemble_chunks(uint64_t v, int nbits_total) {
    int k = (nbits_total - 1) >> 3;  // index of the remainder chunk
    int rem = nbits_total - 8 * k;   // 1..8 bits
    uint64_t b = __builtin_bswap64(v << (64 - nbits_total));
    return (b & ((uint64_t(1) << (8 * k)) - 1))
         | ((b >> (8 * k + 8 - rem)) << (8 * k));
  }

  inline void get_ints(int nints, int nbits_total, const uint32_t sizes[],
                       const uint64_t magics[], int32_t nums[]) {
    if (nints == 3 && nbits_total <= 57) {
      // fast path: gather the least-significant-chunk-first packed value
      // with one refill, then two divisions
      uint64_t x = reassemble_chunks(get64(nbits_total), nbits_total);
      uint64_t q = fast_divm(x, sizes[2], magics[2]);
      nums[2] = int32_t(x - q * sizes[2]);
      uint64_t q2 = fast_divm(q, sizes[1], magics[1]);
      nums[1] = int32_t(q - q2 * sizes[1]);
      nums[0] = int32_t(q2);
      return;
    }
    // general path (wide ranges): byte-based long division
    int bytes[32];
    bytes[1] = bytes[2] = bytes[3] = 0;
    int nbytes = 0;
    int rem = nbits_total;
    while (rem > 8) {
      bytes[nbytes++] = int(get64(8));
      rem -= 8;
    }
    if (rem > 0) bytes[nbytes++] = int(get64(rem));
    for (int i = nints - 1; i > 0; i--) {
      uint32_t num = 0;
      for (int j = nbytes - 1; j >= 0; j--) {
        num = (num << 8) | uint32_t(bytes[j]);
        uint32_t p = num / sizes[i];
        bytes[j] = int(p);
        num -= p * sizes[i];
      }
      nums[i] = int32_t(num);
    }
    nums[0] = bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) | (bytes[3] << 24);
  }
};

// ------------------------------------------------------------------ bit writer
// 64-bit accumulator mirror of the BitReader: bits collect MSB-first in
// the low `nbits` of `acc`, whole bytes drain as they complete — the
// previous byte-at-a-time carry (lastbyte/lastbits) cost several shifts
// and a push_back branch per BYTE; this costs them per PUT.  The emitted
// stream is bit-identical by construction.
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;  // pending bits, right-aligned (low nbits valid)
  int nbits = 0;     // 0..7 between puts

  explicit BitWriter(std::vector<uint8_t>& buf) : out(buf) {}

  inline void put(int n, uint32_t num) {
    if (__builtin_expect(n > 56, 0)) {
      // Wide puts carry at most 32 significant bits (num is u32); the
      // excess high bits are zeros.  Emit them first in safe chunks so
      // `acc << n` below never sheds pending bits (nbits <= 7, so any
      // n <= 56 keeps nbits + n < 64; n >= 64 would be shift UB).  The
      // zero-padding calls in put_ints / tng_put_ints_wide reach here
      // with n up to ~432 for very wide value ranges.
      for (int zeros = n - 32; zeros > 0; zeros -= 24)
        put(zeros > 24 ? 24 : zeros, 0);
      n = 32;
    }
    const uint32_t mask = n < 32 ? (1u << n) - 1 : 0xffffffffu;
    acc = (acc << n) | uint64_t(num & mask);  // nbits + n <= 7 + 56 < 64
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      out.push_back(uint8_t(acc >> nbits));
    }
    acc &= (uint64_t(1) << nbits) - 1;  // shed emitted bits
  }

  void flush() {
    if (nbits > 0) {
      out.push_back(uint8_t(acc << (8 - nbits)));
      acc = 0;
      nbits = 0;
    }
  }

  void put_ints(int nints, int nbits_total, const uint32_t sizes[],
                const uint32_t nums[]) {
    if (nints == 3 && nbits_total <= 57) {
      // fast path (mirror of BitReader::get_ints): the packed value fits
      // u64 (nums[i] < sizes[i] and sizeof_ints bounds the product by
      // 2^nbits_total), emitted least-significant byte first with the
      // final remainder chunk MSB-aligned — exactly the byte-path order.
      uint64_t x =
          (uint64_t(nums[0]) * sizes[1] + nums[1]) * sizes[2] + nums[2];
      int nb = nbits_total;
      while (nb >= 8) {
        put(8, uint32_t(x & 0xff));
        x >>= 8;
        nb -= 8;
      }
      if (nb) put(nb, uint32_t(x));
      return;
    }
    // general path (wide ranges): byte-based schoolbook base conversion
    uint32_t bytes[32];
    uint32_t nbytes = 0;
    uint64_t tmp = nums[0];
    do {
      bytes[nbytes++] = tmp & 0xff;
      tmp >>= 8;
    } while (tmp != 0);
    for (int i = 1; i < nints; i++) {
      tmp = nums[i];
      uint32_t bytecnt = 0;
      for (; bytecnt < nbytes; bytecnt++) {
        tmp += uint64_t(bytes[bytecnt]) * sizes[i];
        bytes[bytecnt] = tmp & 0xff;
        tmp >>= 8;
      }
      while (tmp != 0) {
        bytes[bytecnt++] = tmp & 0xff;
        tmp >>= 8;
      }
      nbytes = bytecnt;
    }
    if (nbits_total >= int(nbytes) * 8) {
      for (uint32_t b = 0; b < nbytes; b++) put(8, bytes[b]);
      put(nbits_total - int(nbytes) * 8, 0);
    } else {
      uint32_t b = 0;
      for (; b + 1 < nbytes; b++) put(8, bytes[b]);
      put(nbits_total - int(b) * 8, bytes[b]);
    }
  }
};

// ------------------------------------------------------------------ XTC frame header
struct XtcHeader {
  int32_t magic = 0;
  int32_t natoms = 0;
  int32_t step = 0;
  float time = 0;
  float box[9];
  // coordinate block metadata (natoms > 9 only)
  float precision = 0;
  int32_t minint[3], maxint[3];
  int32_t smallidx = 0;
  int64_t nbytes = 0;       // payload byte count (no padding)
  int64_t data_offset = 0;  // absolute file offset of the packed payload
  int64_t frame_size = 0;   // total frame size incl. padding
};

// Parse the fixed header at `off`.  Returns GX_OK / error.
int64_t parse_xtc_header(const FileReader& f, int64_t off, XtcHeader* h) {
  uint8_t buf[96];
  if (off + 60 > f.size) return GX_ERR_IO;
  if (!f.read_at(off, buf, 60)) return GX_ERR_IO;
  h->magic = load_i32(buf);
  if (h->magic != 1995 && h->magic != 2023) return GX_ERR_MAGIC;
  h->natoms = load_i32(buf + 4);
  h->step = load_i32(buf + 8);
  h->time = load_f32(buf + 12);
  for (int i = 0; i < 9; i++) h->box[i] = load_f32(buf + 16 + 4 * i);
  int32_t natoms2 = load_i32(buf + 52);
  if (natoms2 != h->natoms) return GX_ERR_CORRUPT;

  if (h->natoms <= 9) {
    // tiny systems are stored as plain floats, no precision field
    h->precision = 0;
    h->nbytes = int64_t(h->natoms) * 3 * 4;
    h->data_offset = off + 56;
    h->frame_size = 56 + h->nbytes;
    return GX_OK;
  }

  int hdr_extra = (h->magic == 2023) ? 40 : 36;  // precision..nbytes
  if (!f.read_at(off + 56, buf, hdr_extra)) return GX_ERR_IO;
  h->precision = load_f32(buf);
  for (int i = 0; i < 3; i++) h->minint[i] = load_i32(buf + 4 + 4 * i);
  for (int i = 0; i < 3; i++) h->maxint[i] = load_i32(buf + 16 + 4 * i);
  h->smallidx = load_i32(buf + 28);
  if (h->magic == 2023) {
    h->nbytes = int64_t(load_be64(buf + 32));
  } else {
    h->nbytes = load_i32(buf + 32);
  }
  if (h->nbytes < 0 || h->nbytes > f.size) return GX_ERR_CORRUPT;
  int64_t padded = (h->nbytes + 3) & ~int64_t(3);
  h->data_offset = off + 56 + hdr_extra;
  h->frame_size = 56 + hdr_extra + padded;
  return GX_OK;
}

// Emit one decoded coordinate triple.  OutT=float converts via the
// canonical `float(int) * (1/precision)`; OutT=int16_t emits the raw
// quantized integers (the on-wire format for device transfer: dequantize
// on device with the same multiply for bit-identical floats).
template <typename OutT>
static inline void emit3(OutT*& fp, const int32_t* c, float inv_precision) {
  if constexpr (std::is_same_v<OutT, float>) {
    fp[0] = float(c[0]) * inv_precision;
    fp[1] = float(c[1]) * inv_precision;
    fp[2] = float(c[2]) * inv_precision;
  } else {
    fp[0] = OutT(c[0]);
    fp[1] = OutT(c[1]);
    fp[2] = OutT(c[2]);
  }
  fp += 3;
}

// Decode the packed coordinate payload into out[0 .. 3*stop_after).
// `stop_after` <= natoms enables partial-frame decode.
template <typename OutT>
int64_t decode_3dfcoord_t(const XtcHeader& h, const uint8_t* data, size_t datalen,
                          OutT* out, int stop_after) {
  if constexpr (std::is_same_v<OutT, int16_t>) {
    // quantized output must fit int16 (checked up front via header bounds)
    for (int a = 0; a < 3; a++)
      if (h.minint[a] < -32768 || h.maxint[a] > 32767) return GX_ERR_Q16;
  }
  const float inv_precision = 1.0f / h.precision;
  uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
  for (int i = 0; i < 3; i++) sizeint[i] = uint32_t(h.maxint[i] - h.minint[i]) + 1;

  int bitsize;
  if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
    for (int i = 0; i < 3; i++) bitsizeint[i] = sizeof_int(int(sizeint[i]));
    bitsize = 0;
  } else {
    bitsize = sizeof_ints(3, sizeint);
  }

  int smallidx = h.smallidx;
  if (smallidx < kFirstIdx || smallidx > kLastIdx) return GX_ERR_CORRUPT;
  int smaller = kMagicInts[std::max(kFirstIdx, smallidx - 1)] / 2;
  int smallnum = kMagicInts[smallidx] / 2;
  uint32_t sizesmall[3] = {uint32_t(kMagicInts[smallidx]), uint32_t(kMagicInts[smallidx]),
                           uint32_t(kMagicInts[smallidx])};

  // division magics for the fast_divm hot path (sizeint fixed per
  // frame; sizesmall follows the smallidx adaptation via kMagicDiv)
  uint64_t mag_sizeint[3] = {BitReader::magic_of(sizeint[0]),
                             BitReader::magic_of(sizeint[1]),
                             BitReader::magic_of(sizeint[2])};
  uint64_t mag_small[3] = {kMagicDiv[size_t(smallidx)],
                           kMagicDiv[size_t(smallidx)],
                           kMagicDiv[size_t(smallidx)]};

  BitReader br{data, datalen};
  int32_t thiscoord[3], prevcoord[3] = {0, 0, 0};
  int run = 0;
  int i = 0;
  const int lsize = h.natoms;
  OutT* fp = out;
  // partial-frame decode: a water-run can span the stop boundary, so every
  // run emission is guarded against the output end (the loop-top check
  // alone would overrun `out` by up to one run)
  OutT* const fp_end = out + 3 * int64_t(std::min(stop_after, lsize));

  // The stream interleaves [large triple][flag] per lone atom; when the
  // joint pack plus the flag fit one <=57-bit read, fuse them — one refill
  // and one accumulator update per atom instead of two (xdrfile reads them
  // separately, xdrfile.c receivebits per value).  flag==0 REUSES the
  // previous runlength (format semantics), so the straight-line hot exit
  // below additionally requires run == 0.
  const bool fused = (bitsize != 0 && bitsize + 1 <= 57);
  while (i < lsize) {
    if (i >= stop_after) return GX_OK;  // partial-frame early stop
    int flag;
    if (fused) {
      uint64_t v = br.get64(bitsize + 1);
      flag = int(v & 1);
      uint64_t x = BitReader::reassemble_chunks(v >> 1, bitsize);
      uint64_t q = BitReader::fast_divm(x, sizeint[2], mag_sizeint[2]);
      thiscoord[2] = int32_t(x - q * sizeint[2]);
      uint64_t q2 = BitReader::fast_divm(q, sizeint[1], mag_sizeint[1]);
      thiscoord[1] = int32_t(q - q2 * sizeint[1]);
      thiscoord[0] = int32_t(q2);
    } else {
      if (bitsize == 0) {
        thiscoord[0] = br.get(int(bitsizeint[0]));
        thiscoord[1] = br.get(int(bitsizeint[1]));
        thiscoord[2] = br.get(int(bitsizeint[2]));
      } else {
        br.get_ints(3, bitsize, sizeint, mag_sizeint, thiscoord);
      }
      flag = br.get(1);
    }
    i++;
    thiscoord[0] += h.minint[0];
    thiscoord[1] += h.minint[1];
    thiscoord[2] += h.minint[2];
    prevcoord[0] = thiscoord[0];
    prevcoord[1] = thiscoord[1];
    prevcoord[2] = thiscoord[2];

    if (flag == 0 && run == 0) {
      // hot path: lone large atom, no run to reuse, smallidx unchanged
      emit3(fp, thiscoord, inv_precision);
      if (br.overrun()) return GX_ERR_CORRUPT;
      continue;
    }
    int is_smaller = 0;
    if (flag == 1) {
      run = br.get(5);
      is_smaller = run % 3;
      run -= is_smaller;
      is_smaller--;
    }
    if (br.overrun()) return GX_ERR_CORRUPT;

    if (run > 0) {
      // first run atom: water-optimization — it was swapped with its
      // predecessor at compression time; swap back and emit both
      br.get_ints(3, smallidx, sizesmall, mag_small, thiscoord);
      i++;
      thiscoord[0] += prevcoord[0] - smallnum;
      thiscoord[1] += prevcoord[1] - smallnum;
      thiscoord[2] += prevcoord[2] - smallnum;
      std::swap(thiscoord[0], prevcoord[0]);
      std::swap(thiscoord[1], prevcoord[1]);
      std::swap(thiscoord[2], prevcoord[2]);
      if (fp >= fp_end) return GX_OK;
      emit3(fp, prevcoord, inv_precision);
      if (fp >= fp_end) return GX_OK;
      emit3(fp, thiscoord, inv_precision);
      // the delta chain continues from prevcoord (the swap left the
      // decoded first run atom there), exactly as the scalar loop did
      // remaining run atoms: straight-line chain, no swap branch.
      // (Batching m fixed-width triples per bit-read was tried and is a
      // measured wash here — typical water runs leave only 2 chained
      // triples, see PERF.md "Negative result: batched small-triple
      // reads".)
      for (int k = 3; k < run; k += 3) {
        br.get_ints(3, smallidx, sizesmall, mag_small, thiscoord);
        i++;
        thiscoord[0] += prevcoord[0] - smallnum;
        thiscoord[1] += prevcoord[1] - smallnum;
        thiscoord[2] += prevcoord[2] - smallnum;
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];
        if (fp >= fp_end) return GX_OK;
        emit3(fp, thiscoord, inv_precision);
      }
    } else {
      emit3(fp, thiscoord, inv_precision);
    }
    smallidx += is_smaller;
    if (is_smaller < 0) {
      smallnum = smaller;
      smaller = (smallidx > kFirstIdx) ? kMagicInts[smallidx - 1] / 2 : 0;
    } else if (is_smaller > 0) {
      smaller = smallnum;
      smallnum = kMagicInts[smallidx] / 2;
    }
    if (smallidx < kFirstIdx || smallidx > kLastIdx) return GX_ERR_CORRUPT;
    if (is_smaller) {
      sizesmall[0] = sizesmall[1] = sizesmall[2] = uint32_t(kMagicInts[smallidx]);
      mag_small[0] = mag_small[1] = mag_small[2] = kMagicDiv[size_t(smallidx)];
    }
    if (br.overrun()) return GX_ERR_CORRUPT;
  }
  return GX_OK;
}

// Decode one frame (header already parsed) into out/box/etc.
template <typename OutT>
int64_t decode_xtc_frame_t(const FileReader& f, const XtcHeader& h,
                           std::vector<uint8_t>& scratch, OutT* coords, int stop_after) {
  if (h.natoms <= 9) {
    // tiny systems store raw floats — no quantized representation exists
    if constexpr (!std::is_same_v<OutT, float>) return GX_ERR_Q16;
    scratch.resize(size_t(h.nbytes));
    if (!f.read_at(h.data_offset, scratch.data(), h.nbytes)) return GX_ERR_IO;
    int n = std::min(stop_after, int(h.natoms));
    for (int i = 0; i < 3 * n; i++) coords[i] = load_f32(scratch.data() + 4 * i);
    return GX_OK;
  }
  // Partial-frame reads only need the payload prefix the early stop can
  // touch.  Worst case per emitted atom: a "large" triple (<=~98 bits for
  // the joint pack or 3x32 split) + flag/runlength (6) or a run atom
  // (3 x <=26 bits); 32 bytes/atom dominates both, and a water-run can
  // overshoot the stop by one run (<=30 atoms).  Bounding the pread makes
  // a 400-atom early stop read ~13 KB instead of a multi-MB payload.
  int64_t need = h.nbytes;
  if (stop_after < int(h.natoms)) {
    need = std::min<int64_t>(h.nbytes, 64 + int64_t(stop_after + 33) * 32);
  }
  scratch.resize(size_t(need));
  if (!f.read_at(h.data_offset, scratch.data(), need)) return GX_ERR_IO;
  return decode_3dfcoord_t(h, scratch.data(), scratch.size(), coords,
                           std::min(stop_after, int(h.natoms)));
}

int64_t decode_xtc_frame(const FileReader& f, const XtcHeader& h,
                         std::vector<uint8_t>& scratch, float* coords, int stop_after) {
  return decode_xtc_frame_t(f, h, scratch, coords, stop_after);
}

// ------------------------------------------------------------------ XTC compression
// Quantize + compress coordinates; returns payload bytes (appended to out).
int64_t encode_3dfcoord(const float* coords, int natoms, float precision,
                        int32_t minint[3], int32_t maxint[3], int32_t* smallidx_out,
                        std::vector<uint8_t>& out) {
  std::vector<int32_t> ip(size_t(natoms) * 3);
  const float kMaxAbs = float(INT32_MAX - 2);
  // branchless rounding (identical expression to the checked original so
  // quantized ints — and therefore the emitted bytes — are unchanged);
  // the range check is deferred to one flag so the loop vectorizes, with
  // out-of-range lanes clamped to keep the float->int cast defined
  bool out_of_range = false;
  for (int64_t i = 0; i < int64_t(natoms) * 3; i++) {
    const float lf = coords[i] * precision;
    const bool bad = !(lf >= -kMaxAbs && lf <= kMaxAbs);  // true for NaN too
    out_of_range |= bad;
    const float lc = bad ? 0.0f : lf;
    ip[i] = int32_t(lc >= 0 ? lc + 0.5f : lc - 0.5f);
  }
  if (out_of_range) return GX_ERR_PRECISION;

  minint[0] = minint[1] = minint[2] = INT32_MAX;
  maxint[0] = maxint[1] = maxint[2] = INT32_MIN;
  int32_t prev[3] = {0, 0, 0};
  int64_t mindiff = INT64_MAX;
  for (int i = 0; i < natoms; i++) {
    const int32_t* c = &ip[size_t(i) * 3];
    for (int d = 0; d < 3; d++) {
      minint[d] = std::min(minint[d], c[d]);
      maxint[d] = std::max(maxint[d], c[d]);
    }
    if (i > 0) {
      int64_t diff = std::abs(int64_t(c[0]) - prev[0]) + std::abs(int64_t(c[1]) - prev[1]) +
                     std::abs(int64_t(c[2]) - prev[2]);
      mindiff = std::min(mindiff, diff);
    }
    prev[0] = c[0];
    prev[1] = c[1];
    prev[2] = c[2];
  }

  uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
  for (int d = 0; d < 3; d++) {
    int64_t range = int64_t(maxint[d]) - minint[d] + 1;
    if (range > INT32_MAX) return GX_ERR_PRECISION;
    sizeint[d] = uint32_t(range);
  }
  int bitsize;
  if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
    for (int d = 0; d < 3; d++) bitsizeint[d] = sizeof_int(int(sizeint[d]));
    bitsize = 0;
  } else {
    bitsize = sizeof_ints(3, sizeint);
  }

  int smallidx = kFirstIdx;
  while (smallidx < kLastIdx && kMagicInts[smallidx] < mindiff) smallidx++;
  *smallidx_out = smallidx;

  int maxidx = std::min(kLastIdx, smallidx + 8);
  int minidx = maxidx - 8;
  int smaller = kMagicInts[std::max(kFirstIdx, smallidx - 1)] / 2;
  int smallnum = kMagicInts[smallidx] / 2;
  uint32_t sizesmall[3] = {uint32_t(kMagicInts[smallidx]), uint32_t(kMagicInts[smallidx]),
                           uint32_t(kMagicInts[smallidx])};
  int larger = kMagicInts[maxidx] / 2;

  BitWriter bw(out);
  int32_t prevcoord[3] = {0, 0, 0};
  uint32_t tmpcoord[30];
  int prevrun = -1;
  int i = 0;
  while (i < natoms) {
    int is_small = 0;
    int32_t* thiscoord = &ip[size_t(i) * 3];
    int is_smaller;
    if (smallidx < maxidx && i >= 1 && std::abs(thiscoord[0] - prevcoord[0]) < larger &&
        std::abs(thiscoord[1] - prevcoord[1]) < larger &&
        std::abs(thiscoord[2] - prevcoord[2]) < larger) {
      is_smaller = 1;
    } else if (smallidx > minidx) {
      is_smaller = -1;
    } else {
      is_smaller = 0;
    }
    if (i + 1 < natoms) {
      if (std::abs(thiscoord[0] - thiscoord[3]) < smallnum &&
          std::abs(thiscoord[1] - thiscoord[4]) < smallnum &&
          std::abs(thiscoord[2] - thiscoord[5]) < smallnum) {
        // swap first atom with second for better water compression
        std::swap(thiscoord[0], thiscoord[3]);
        std::swap(thiscoord[1], thiscoord[4]);
        std::swap(thiscoord[2], thiscoord[5]);
        is_small = 1;
      }
    }
    uint32_t abs3[3] = {uint32_t(thiscoord[0] - minint[0]), uint32_t(thiscoord[1] - minint[1]),
                        uint32_t(thiscoord[2] - minint[2])};
    if (bitsize == 0) {
      bw.put(int(bitsizeint[0]), abs3[0]);
      bw.put(int(bitsizeint[1]), abs3[1]);
      bw.put(int(bitsizeint[2]), abs3[2]);
    } else {
      bw.put_ints(3, bitsize, sizeint, abs3);
    }
    prevcoord[0] = thiscoord[0];
    prevcoord[1] = thiscoord[1];
    prevcoord[2] = thiscoord[2];
    thiscoord += 3;
    i++;

    int run = 0;
    if (is_small == 0 && is_smaller == -1) is_smaller = 0;
    while (is_small && run < 8 * 3) {
      if (is_smaller == -1) {
        int64_t d0 = thiscoord[0] - prevcoord[0];
        int64_t d1 = thiscoord[1] - prevcoord[1];
        int64_t d2 = thiscoord[2] - prevcoord[2];
        if (d0 * d0 + d1 * d1 + d2 * d2 >= int64_t(smaller) * smaller) is_smaller = 0;
      }
      tmpcoord[run++] = uint32_t(thiscoord[0] - prevcoord[0] + smallnum);
      tmpcoord[run++] = uint32_t(thiscoord[1] - prevcoord[1] + smallnum);
      tmpcoord[run++] = uint32_t(thiscoord[2] - prevcoord[2] + smallnum);
      prevcoord[0] = thiscoord[0];
      prevcoord[1] = thiscoord[1];
      prevcoord[2] = thiscoord[2];
      i++;
      thiscoord += 3;
      is_small = 0;
      if (i < natoms && std::abs(thiscoord[0] - prevcoord[0]) < smallnum &&
          std::abs(thiscoord[1] - prevcoord[1]) < smallnum &&
          std::abs(thiscoord[2] - prevcoord[2]) < smallnum) {
        is_small = 1;
      }
    }
    if (run != prevrun || is_smaller != 0) {
      prevrun = run;
      bw.put(1, 1);
      bw.put(5, uint32_t(run + is_smaller + 1));
    } else {
      bw.put(1, 0);
    }
    for (int k = 0; k < run; k += 3) {
      bw.put_ints(3, smallidx, sizesmall, &tmpcoord[k]);
    }
    if (is_smaller != 0) {
      smallidx += is_smaller;
      if (is_smaller < 0) {
        smallnum = smaller;
        smaller = kMagicInts[smallidx - 1] / 2;
      } else {
        smaller = smallnum;
        smallnum = kMagicInts[smallidx] / 2;
      }
      sizesmall[0] = sizesmall[1] = sizesmall[2] = uint32_t(kMagicInts[smallidx]);
    }
  }
  bw.flush();
  return GX_OK;
}

// ------------------------------------------------------------------ TRR
struct TrrHeader {
  int32_t box_size = 0, vir_size = 0, pres_size = 0;
  int64_t x_size = 0, v_size = 0, f_size = 0;
  int32_t natoms = 0, step = 0;
  double time = 0, lambda = 0;
  bool is_double = false;
  int64_t body_offset = 0;  // offset of box block
  int64_t frame_size = 0;
  double box[9];
};

int64_t parse_trr_header(const FileReader& f, int64_t off, TrrHeader* h) {
  uint8_t buf[108];
  if (off + 84 > f.size) return GX_ERR_IO;
  if (!f.read_at(off, buf, 84)) return GX_ERR_IO;
  if (load_i32(buf) != 1993) return GX_ERR_MAGIC;
  int32_t slen = load_i32(buf + 4);  // strlen + 1 ("GMX_trn_file" -> 13)
  int32_t xdr_len = load_i32(buf + 8);
  if (slen != xdr_len + 1 || xdr_len < 0 || xdr_len > 64) return GX_ERR_CORRUPT;
  int64_t pad = (xdr_len + 3) & ~3;
  int64_t p = off + 12 + pad;
  uint8_t ints[52];
  if (!f.read_at(p, ints, 52)) return GX_ERR_IO;
  int32_t ir_size = load_i32(ints), e_size = load_i32(ints + 4);
  h->box_size = load_i32(ints + 8);
  h->vir_size = load_i32(ints + 12);
  h->pres_size = load_i32(ints + 16);
  int32_t top_size = load_i32(ints + 20), sym_size = load_i32(ints + 24);
  h->x_size = load_i32(ints + 28);
  h->v_size = load_i32(ints + 32);
  h->f_size = load_i32(ints + 36);
  h->natoms = load_i32(ints + 40);
  h->step = load_i32(ints + 44);
  int32_t nre = load_i32(ints + 48);
  (void)ir_size;
  (void)e_size;
  (void)top_size;
  (void)sym_size;
  (void)nre;

  // real size: from box (9 reals) or x (3*natoms reals)
  int real_size = 4;
  if (h->box_size != 0) {
    real_size = h->box_size / 9;
  } else if (h->x_size != 0 && h->natoms > 0) {
    real_size = int(h->x_size / (int64_t(h->natoms) * 3));
  }
  if (real_size != 4 && real_size != 8) return GX_ERR_CORRUPT;
  h->is_double = (real_size == 8);

  p += 52;
  uint8_t tl[16];
  if (!f.read_at(p, tl, size_t(2 * real_size))) return GX_ERR_IO;
  if (h->is_double) {
    h->time = load_f64(tl);
    h->lambda = load_f64(tl + 8);
  } else {
    h->time = load_f32(tl);
    h->lambda = load_f32(tl + 4);
  }
  p += 2 * real_size;
  h->body_offset = p;

  // read box if present
  if (h->box_size) {
    uint8_t bb[72];
    if (!f.read_at(p, bb, size_t(h->box_size))) return GX_ERR_IO;
    for (int i = 0; i < 9; i++)
      h->box[i] = h->is_double ? load_f64(bb + 8 * i) : load_f32(bb + 4 * i);
  } else {
    std::fill(h->box, h->box + 9, 0.0);
  }

  int64_t body = int64_t(h->box_size) + h->vir_size + h->pres_size + h->x_size + h->v_size +
                 h->f_size;
  h->frame_size = (h->body_offset - off) + body;
  return GX_OK;
}

// read a block of `n` reals at `off` into float dst
bool read_reals(const FileReader& f, int64_t off, int64_t n, bool is_double, float* dst,
                std::vector<uint8_t>& scratch) {
  int rs = is_double ? 8 : 4;
  scratch.resize(size_t(n) * rs);
  if (!f.read_at(off, scratch.data(), n * rs)) return false;
  if (is_double) {
    for (int64_t i = 0; i < n; i++) dst[i] = float(load_f64(scratch.data() + 8 * i));
  } else {
    for (int64_t i = 0; i < n; i++) dst[i] = load_f32(scratch.data() + 4 * i);
  }
  return true;
}

// ------------------------------------------------------------------ parallel map
void parallel_for(int64_t n, int n_threads, const std::function<void(int64_t)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; i++) fn(i);
    return;
  }
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  int nt = std::min<int64_t>(n_threads, n);
  pool.reserve(size_t(nt));
  for (int t = 0; t < nt; t++) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) break;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Bulk multi-frame XTC decode shared by the float and int16 C entry points.
template <typename OutT>
int64_t gx_xtc_read_impl(const char* path, const int64_t* offsets, int64_t nframes,
                         int32_t expected_natoms, int32_t stop_after, OutT* coords,
                         float* boxes, int32_t* steps, float* times, float* precisions,
                         int32_t n_threads) {
  FileReader f;
  if (!f.open(path)) return GX_ERR_OPEN;
  std::atomic<int64_t> err{GX_OK};
  parallel_for(nframes, n_threads, [&](int64_t i) {
    if (err.load(std::memory_order_relaxed) != GX_OK) return;
    XtcHeader h;
    int64_t rc = parse_xtc_header(f, offsets[i], &h);
    if (rc == GX_OK && h.natoms != expected_natoms) rc = GX_ERR_NATOMS;
    if (rc == GX_OK) {
      std::vector<uint8_t> scratch;
      rc = decode_xtc_frame_t(f, h, scratch, coords + i * int64_t(stop_after) * 3, stop_after);
    }
    if (rc == GX_OK) {
      if (boxes) std::memcpy(boxes + i * 9, h.box, 9 * sizeof(float));
      if (steps) steps[i] = h.step;
      if (times) times[i] = h.time;
      if (precisions) precisions[i] = h.precision;
    } else {
      int64_t expected = GX_OK;
      err.compare_exchange_strong(expected, rc);
    }
  });
  return err.load();
}

// ------------------------------------------------------------- TNG XTC2
// Decoder for GROMACS tng_compress "XTC2" position streams
// (initial_coding=5) — the default coder TNG files carry for non-tiny
// systems.  The wire format was reverse-engineered from known plaintext
// (no tng source in this environment); io/tng.py documents the grammar
// and docs/tng_compress_notes.md the derivation.  Python keeps a
// reference implementation; this native path decodes ~100x faster and is
// what io/tng.py calls.
//
// Key difference from the classic 3dfcoord tables: tng's magic table
// corrects xdrfile's famous frozen typo 5060 -> 5160 (= 2^(12+1/3)).
static const int32_t kTngMagic[] = {
    0,       0,       0,       0,        0,        0,        0,       0,
    0,       8,       10,      12,       16,       20,       25,      32,
    40,      50,      64,      80,       101,      128,      161,     203,
    256,     322,     406,     512,      645,      812,      1024,    1290,
    1625,    2048,    2580,    3250,     4096,     5160,     6501,    8192,
    10321,   13003,   16384,   20642,    26007,    32768,    41285,   52015,
    65536,   82570,   104031,  131072,   165140,   208063,   262144,  330280,
    416127,  524287,  660561,  832255,   1048576,  1321122,  1664510, 2097152,
    2642245, 3329021, 4194304, 5284491,  6658042,  8388607,  10568983,
    13316085, 16777216};
constexpr int kTngMagicN = int(sizeof(kTngMagic) / sizeof(kTngMagic[0]));

namespace {

// little-endian big-number divmod over 32-bit limbs: the sendints payload
// arrives LS-byte-first, so limb[0] is the least significant.  Each digit
// extraction is one pass of u64-by-u32 division; the hardware divide is
// replaced by the codec's exact magic division (fast_divm; cur < 2^63
// here: rem < base < 2^31 plus a 32-bit limb, so the quotient-check
// product q*base <= cur stays in u64), and fully-extracted top limbs are
// shed so later digits walk a shorter number.  vs the byte-wise/divq
// version this is ~8x fewer and ~5x cheaper steps on the K-run hot path.
struct TngBignum {
  uint32_t limbs[24];  // 768 bits; >= any 6-atom run at 24-bit bases
  int n = 0;

  // read `w` bits from the MSB-first stream in sendints layout:
  // whole bytes first (each MSB-first within itself), remainder last
  bool load(BitReader& br, int w) {
    if (w > int(sizeof(limbs)) * 8) return false;
    n = 0;
    while (w >= 32) {
      // 4 whole wire bytes: first byte read is least significant
      limbs[n++] = __builtin_bswap32(uint32_t(br.get64(32)));
      w -= 32;
    }
    if (w > 0) {
      uint32_t cur = 0;
      int shift = 0;
      while (w >= 8) {
        cur |= uint32_t(br.get(8)) << shift;
        shift += 8;
        w -= 8;
      }
      if (w > 0) cur |= uint32_t(br.get(w)) << shift;
      limbs[n++] = cur;
    }
    return !br.overrun();
  }

  uint32_t divmod(uint32_t base, uint64_t magic) {
    uint64_t rem = 0;
    for (int i = n - 1; i >= 0; --i) {
      uint64_t cur = (rem << 32) | limbs[i];
      uint64_t q = BitReader::fast_divm(cur, base, magic);
      limbs[i] = uint32_t(q);
      rem = cur - q * base;
    }
    while (n > 0 && limbs[n - 1] == 0) --n;
    return uint32_t(rem);
  }

  bool nonzero() const { return n != 0; }
};

inline int64_t tng_unzig(uint32_t u) {
  return (u & 1) ? int64_t(u + 1) / 2 : -int64_t(u / 2);
}

// gather a w-bit (w <= 57) sendints-layout pack as ONE u64: read the bits
// MSB-first in one refill, then reverse the byte order in O(1) — same
// chunk-reassembly trick as BitReader::get_ints (the wire is LS-byte-first
// with an MSB-aligned remainder chunk).
inline uint64_t tng_read_pack57(BitReader& br, int w) {
  return BitReader::reassemble_chunks(br.get64(w), w);
}

// width of a 3K-digit base-b pack: ceil(3K * log2 b)
inline int tng_small_width(int k3, double log2b) {
  return int(std::ceil(double(k3) * log2b));
}

// Precomputed per-table-entry log2 and pack widths (identical expressions
// to the inline computations they replace, so encoder decisions — and
// therefore the emitted bytes — are unchanged; log2/ceil in the chooser's
// inner loop dominated the encode profile).
struct TngTables {
  double log2[kTngMagicN];
  int16_t width[kTngMagicN][19];  // [idx][n_digits], n_digits <= 18
  TngTables() {
    for (int i = 0; i < kTngMagicN; ++i) {
      log2[i] = kTngMagic[i] ? std::log2(double(kTngMagic[i])) : 0.0;
      for (int k3 = 0; k3 <= 18; ++k3)
        width[i][k3] = int16_t(tng_small_width(k3, log2[i]));
    }
  }
};
static const TngTables kTngTab;

}  // namespace

// Decode one XTC2 stream (payload AFTER the 40-byte TNGP header) into
// int32 quantized coordinates [natoms, 3].  Returns 0 or a GX_ERR_*.
static int64_t tng_xtc2_decode_impl(const uint8_t* stream, int64_t nbytes,
                                    int32_t natoms, int32_t* out) {
  if (nbytes < 16) return GX_ERR_CORRUPT;
  int32_t minint[3];
  std::memcpy(minint, stream, 12);
  int32_t bl[3];
  double wl_bits = 0;
  for (int c = 0; c < 3; ++c) {
    int bidx = int(stream[12 + c]) + 4;
    if (bidx < 0 || bidx >= kTngMagicN || kTngMagic[bidx] == 0)
      return GX_ERR_CORRUPT;
    bl[c] = kTngMagic[bidx];
    wl_bits += std::log2(double(bl[c]));
  }
  const int wl = int(std::ceil(wl_bits));
  const uint64_t mag_bl[3] = {BitReader::magic_of(uint32_t(bl[0])),
                              BitReader::magic_of(uint32_t(bl[1])),
                              BitReader::magic_of(uint32_t(bl[2]))};
  int idx = int(stream[15]) + 4;
  int K = 1;
  bool flip = false;
  // per-smallidx cache: division magic of the current run base (the
  // smallidx adapts rarely relative to run decodes), plus the digit-chunk
  // divisor b^m (kept < 2^31 so the quotient-check products stay in u64)
  int cached_idx = -1;
  uint64_t mag_small = 0, mag_chunk = 0;
  int chunk_m = 1;
  uint32_t chunk_d = 0;

  BitReader br{stream, size_t(nbytes)};
  // skip the 16 header bytes: instructions start at bit 128
  for (int i = 0; i < 16; ++i) br.get(8);

  TngBignum bn;
  int64_t a = 0;

  auto read_large = [&](int32_t* dst) -> bool {
    if (wl <= 57) {  // one refill + two divisions (the common case)
      uint64_t v = tng_read_pack57(br, wl);
      if (br.overrun()) return false;
      uint64_t q = BitReader::fast_divm(v, uint32_t(bl[2]), mag_bl[2]);
      uint32_t z = uint32_t(v - q * uint64_t(bl[2]));
      uint64_t q2 = BitReader::fast_divm(q, uint32_t(bl[1]), mag_bl[1]);
      uint32_t y = uint32_t(q - q2 * uint64_t(bl[1]));
      if (q2 >= uint64_t(bl[0])) return false;
      dst[0] = int32_t(q2) + minint[0];
      dst[1] = int32_t(y) + minint[1];
      dst[2] = int32_t(z) + minint[2];
      return true;
    }
    if (!bn.load(br, wl)) return false;
    uint32_t z = bn.divmod(uint32_t(bl[2]), mag_bl[2]);
    uint32_t y = bn.divmod(uint32_t(bl[1]), mag_bl[1]);
    uint32_t x = bn.divmod(uint32_t(bl[0]), mag_bl[0]);
    if (bn.nonzero()) return false;
    dst[0] = int32_t(x) + minint[0];
    dst[1] = int32_t(y) + minint[1];
    dst[2] = int32_t(z) + minint[2];
    return true;
  };

  // decode a K-run's 3K zigzag deltas into tmp[], least atom first
  int64_t tmp[6 * 3];
  auto read_run = [&](int kk) -> bool {
    if (idx < 0 || idx >= kTngMagicN || kTngMagic[idx] == 0) return false;
    uint32_t b = uint32_t(kTngMagic[idx]);
    if (idx != cached_idx) {
      cached_idx = idx;
      mag_small = BitReader::magic_of(b);
      // chunk size: extract `chunk_m` digits per bignum pass by dividing
      // by b^m (largest power that still fits a 32-bit schoolbook divisor)
      chunk_m = 1;
      uint64_t p = b;
      while (p * b < (uint64_t(1) << 31) && chunk_m < 6) {
        p *= b;
        ++chunk_m;
      }
      chunk_d = uint32_t(p);
      mag_chunk = BitReader::magic_of(chunk_d);
    }
    const int nd = 3 * kk;
    int w = kTngTab.width[idx][nd];
    if (w <= 57) {  // whole run in one u64 — no bignum at all
      uint64_t v = tng_read_pack57(br, w);
      if (br.overrun()) return false;
      for (int j = nd - 1; j > 0; --j) {
        uint64_t q = BitReader::fast_divm(v, b, mag_small);
        tmp[j] = tng_unzig(uint32_t(v - q * b));
        v = q;
      }
      if (v >= b) return false;
      tmp[0] = tng_unzig(uint32_t(v));
      return true;
    }
    if (!bn.load(br, w)) return false;
    // chunked extraction: one bignum pass yields chunk_m digits
    for (int j = nd - 1; j >= 0;) {
      int m = (j + 1 < chunk_m) ? j + 1 : chunk_m;
      uint64_t r;
      if (m == chunk_m) {
        r = bn.divmod(chunk_d, mag_chunk);
      } else {  // final short group
        uint32_t d = b;
        for (int t = 1; t < m; ++t) d *= b;
        r = bn.divmod(d, BitReader::magic_of(d));
      }
      for (int t = 0; t < m; ++t) {
        uint64_t q = BitReader::fast_divm(r, b, mag_small);
        tmp[j--] = tng_unzig(uint32_t(r - q * b));
        r = q;
      }
    }
    return !bn.nonzero();
  };

  while (a < natoms) {
    if (br.overrun()) return GX_ERR_CORRUPT;
    if (br.get(1)) {  // DEFAULT: one large + a small run
      if (!flip) {
        if (!read_large(out + 3 * a)) return GX_ERR_CORRUPT;
        ++a;
        int kk = int(std::min<int64_t>(K, natoms - a));
        if (kk > 0) {
          if (!read_run(kk)) return GX_ERR_CORRUPT;
          for (int k = 0; k < kk; ++k) {
            for (int c = 0; c < 3; ++c)
              out[3 * (a + k) + c] =
                  int32_t(out[3 * (a + k) - 3 + c] + tmp[3 * k + c]);
          }
          a += kk;
        }
      } else {
        // water-swap emission: large is atom a+1; the run's first small
        // decodes against the large and is emitted FIRST (atom a); the
        // remaining smalls chain off that first small (atoms a+2..)
        int32_t large[3];
        if (!read_large(large)) return GX_ERR_CORRUPT;
        int kk = int(std::min<int64_t>(K, natoms - a - 1));
        if (kk <= 0) {
          std::memcpy(out + 3 * a, large, 12);
          ++a;
          continue;
        }
        if (!read_run(kk)) return GX_ERR_CORRUPT;
        for (int c = 0; c < 3; ++c)
          out[3 * a + c] = int32_t(large[c] + tmp[c]);
        std::memcpy(out + 3 * (a + 1), large, 12);
        for (int k = 1; k < kk; ++k) {
          const int32_t* prev =
              (k == 1) ? out + 3 * a : out + 3 * (a + k);
          for (int c = 0; c < 3; ++c)
            out[3 * (a + 1 + k) + c] = int32_t(prev[c] + tmp[3 * k + c]);
        }
        a += 1 + kk;
      }
      continue;
    }
    if (!br.get(1)) {  // '00' SMALL_RUNLENGTH
      int v = br.get(4);
      if (v == 15) {
        K = 6;
      } else {
        K = v / 3 + 1;
        idx += v % 3 - 1;
      }
      continue;
    }
    if (!br.get(1)) {  // '010x'
      if (!br.get(1)) {  // ONLY_LARGE
        if (!read_large(out + 3 * a)) return GX_ERR_CORRUPT;
        ++a;
      } else {  // ONLY_SMALL
        if (a == 0) return GX_ERR_CORRUPT;
        int kk = int(std::min<int64_t>(K, natoms - a));
        if (!read_run(kk)) return GX_ERR_CORRUPT;
        for (int k = 0; k < kk; ++k)
          for (int c = 0; c < 3; ++c)
            out[3 * (a + k) + c] =
                int32_t(out[3 * (a + k) - 3 + c] + tmp[3 * k + c]);
        a += kk;
      }
      continue;
    }
    if (!br.get(1)) {  // '0110' SMALLIDX_JUMP
      int s = br.get(1);
      int m = br.get(1);
      idx += (1 + m) * (s ? -1 : 1);
      continue;
    }
    if (!br.get(1)) {  // '01110' FLIP
      flip = !flip;
      continue;
    }
    int n_rle = br.get(4) + 3;  // '01111' LARGE_RLE
    for (int i = 0; i < n_rle && a < natoms; ++i) {
      if (!read_large(out + 3 * a)) return GX_ERR_CORRUPT;
      ++a;
    }
  }
  return br.overrun() ? GX_ERR_CORRUPT : 0;
}

// ------------------------------------------------------------------ encoder
// Write-side of the XTC2 grammar.  Mirrors io/tng.py `_encode_xtc2`
// decision-for-decision (same greedy run selection, same double-precision
// width math), so the two encoders emit bit-identical streams; any
// grammar-valid program that reproduces the quantized ints is a correct
// XTC2 stream, so matching GROMACS' own instruction choices is not
// required.

// Emit `nd` digits (most-significant first) as ONE sendints-layout
// integer of `nbits` bits; sizes[i] is the radix of digits[i] (value =
// ((d0*s1)+d1)*s2+... like BitWriter::put_ints, but with a buffer wide
// enough for 6-atom runs at 24-bit bases).
static void tng_put_ints_wide(BitWriter& bw, const uint32_t* digits,
                              const uint32_t* sizes, int nd, int nbits) {
  if (nbits <= 57) {  // whole pack fits u64: Horner + LS-first emission
    uint64_t v = digits[0];
    for (int i = 1; i < nd; ++i) v = v * sizes[i] + digits[i];
    int full = nbits >> 3, rem = nbits & 7;
    for (int b = 0; b < full; ++b) {
      bw.put(8, uint32_t(v & 0xff));
      v >>= 8;
    }
    if (rem) bw.put(rem, uint32_t(v));
    return;
  }
  uint8_t bytes[96];
  int nbytes = 0;
  for (int i = 0; i < nd; ++i) {
    uint64_t tmp = digits[i];
    int bc = 0;
    for (; bc < nbytes; ++bc) {
      tmp += uint64_t(bytes[bc]) * sizes[i];
      bytes[bc] = uint8_t(tmp & 0xff);
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[bc++] = uint8_t(tmp & 0xff);
      tmp >>= 8;
    }
    nbytes = bc;
  }
  if (nbits >= nbytes * 8) {
    for (int b = 0; b < nbytes; ++b) bw.put(8, bytes[b]);
    bw.put(nbits - nbytes * 8, 0);
  } else {
    int b = 0;
    for (; b + 1 < nbytes; ++b) bw.put(8, bytes[b]);
    bw.put(nbits - b * 8, bytes[b]);
  }
}

inline int tng_needed_idx(uint64_t dmax) {
  for (int i = 9; i < kTngMagicN; ++i)
    if (uint64_t(kTngMagic[i]) > dmax) return i;
  return -1;
}

int64_t tng_xtc2_encode_impl(const int32_t* q, int64_t natoms,
                             std::vector<uint8_t>& out) {
  if (natoms <= 0) return GX_ERR_RANGE;
  int32_t mn[3], mx[3];
  for (int c = 0; c < 3; ++c) mn[c] = mx[c] = q[c];
  for (int64_t a = 1; a < natoms; ++a)
    for (int c = 0; c < 3; ++c) {
      int32_t v = q[3 * a + c];
      if (v < mn[c]) mn[c] = v;
      if (v > mx[c]) mx[c] = v;
    }
  int sb[3];
  int32_t bl[3];
  double wlb = 0;
  for (int c = 0; c < 3; ++c) {
    int64_t span = int64_t(mx[c]) - mn[c] + 1;
    int i = 9;
    while (i < kTngMagicN && kTngMagic[i] < span) ++i;
    if (i >= kTngMagicN) return GX_ERR_RANGE;
    sb[c] = i - 4;
    bl[c] = kTngMagic[i];
    wlb += std::log2(double(bl[c]));
  }
  const int wl = int(std::ceil(wlb));

  // zigzag intra deltas vs the previous atom (dz[0] unused)
  std::vector<uint64_t> dz(size_t(natoms) * 3, 0);
  for (int64_t a = 1; a < natoms; ++a)
    for (int c = 0; c < 3; ++c) {
      int64_t d = int64_t(q[3 * a + c]) - q[3 * (a - 1) + c];
      dz[size_t(3 * a + c)] = d > 0 ? uint64_t(2 * d - 1) : uint64_t(-2 * d);
    }
  auto window_max = [&](int64_t a, int kk) {
    uint64_t m = 0;
    for (int64_t j = a; j < a + kk; ++j)
      for (int c = 0; c < 3; ++c)
        if (dz[size_t(3 * j + c)] > m) m = dz[size_t(3 * j + c)];
    return m;
  };

  out.clear();
  out.resize(16);
  std::memcpy(out.data(), mn, 12);
  out[12] = uint8_t(sb[0]);
  out[13] = uint8_t(sb[1]);
  out[14] = uint8_t(sb[2]);
  int idx = tng_needed_idx(
      natoms > 1 ? window_max(1, int(std::min<int64_t>(6, natoms - 1))) : 0);
  if (idx < 0) idx = 9;
  if (idx > 4 + 255) idx = 4 + 255;
  out[15] = uint8_t(idx - 4);
  int K = 1;

  BitWriter bw(out);  // appends after the 16 header bytes = bit 128
  const uint32_t lsz[3] = {uint32_t(bl[0]), uint32_t(bl[1]), uint32_t(bl[2])};
  auto put_large = [&](int64_t a) {
    uint32_t nums[3] = {uint32_t(q[3 * a] - mn[0]),
                        uint32_t(q[3 * a + 1] - mn[1]),
                        uint32_t(q[3 * a + 2] - mn[2])};
    tng_put_ints_wide(bw, nums, lsz, 3, wl);
  };
  auto set_idx_k = [&](int target_idx, int target_k) {
    if (target_k != K) {
      int step = target_idx - idx;
      step = step < -1 ? -1 : (step > 1 ? 1 : step);
      if (target_k == 6) {
        bw.put(2, 0b00);
        bw.put(4, 15);
      } else {
        bw.put(2, 0b00);
        bw.put(4, uint32_t((target_k - 1) * 3 + step + 1));
        idx += step;
      }
      K = target_k;
    }
    while (idx != target_idx) {
      int d = target_idx - idx;
      int m = (d >= 2 || d <= -2) ? 1 : 0;
      bw.put(4, 0b0110);
      bw.put(1, d < 0 ? 1 : 0);
      bw.put(1, uint32_t(m));
      idx += (1 + m) * (d > 0 ? 1 : -1);
    }
  };

  // Instruction selection (mirrors io/tng.py _encode_xtc2 exactly —
  // same options, same integer cross-multiplied bits-per-atom
  // comparison, same evaluation order — so the streams stay
  // byte-identical): ONLY_LARGE vs ONLY_SMALL run vs DEFAULT
  // (large + chained run, the GROMACS-style 1-bit molecule pattern).
  std::vector<int> per_atom(size_t(natoms), 0);
  std::vector<uint8_t> small_ok(size_t(natoms), 0);
  for (int64_t a2 = 1; a2 < natoms; ++a2) {
    int ni2 = tng_needed_idx(window_max(a2, 1));
    if (ni2 >= 0) {
      per_atom[size_t(a2)] = ni2;
      small_ok[size_t(a2)] = 3.0 * kTngTab.log2[ni2] < double(wl);
    }
  }
  auto trans_bits = [&](int ti, int tk) -> int64_t {
    int d = ti - idx;
    int64_t c = 0;
    if (tk != K) {
      c += 6;
      if (tk != 6) {
        if (d > 0) --d;
        else if (d < 0) ++d;
      }
    }
    return c + 6 * ((std::abs(d) + 1) / 2);
  };
  auto put_run = [&](int64_t start, int kk) {
    uint32_t base = uint32_t(kTngMagic[idx]);
    uint32_t digits[18], szs[18];
    for (int k = 0; k < 3 * kk; ++k) {
      digits[k] = uint32_t(dz[size_t(3 * start + k)]);
      szs[k] = base;
    }
    tng_put_ints_wide(bw, digits, szs, 3 * kk, kTngTab.width[idx][3 * kk]);
  };

  // Best grammar option at atom `a` against a large-baseline of
  // `l_cost` bits (4+W standalone; W when extending an open LARGE_RLE
  // run).  Mirrors io/tng.py decide() exactly: same candidate order
  // (tightest base first, then the sticky current idx), same strict-<
  // integer cross-multiplied comparison — byte-identical streams.
  auto decide = [&](int64_t a, int64_t l_cost, char& kind, int& t_idx,
                    int& t_kk) {
    kind = 'L';
    t_idx = idx;
    t_kk = 0;
    if (!small_ok[size_t(a)]) return;
    int64_t best_c = l_cost;
    int best_adv = 1;
    int m = 0;
    for (int kk = 1; kk <= int(std::min<int64_t>(6, natoms - a)); ++kk) {
      if (!small_ok[size_t(a + kk - 1)]) break;
      m = std::max(m, per_atom[size_t(a + kk - 1)]);
      const int cands[2] = {m, idx};
      const int ncand = idx > m ? 2 : 1;
      for (int ci = 0; ci < ncand; ++ci) {
        const int t = cands[ci];
        int64_t c = trans_bits(t, kk) + 4 + kTngTab.width[t][3 * kk];
        if (c * best_adv < best_c * kk) {
          best_c = c;
          best_adv = kk;
          kind = 'S';
          t_idx = t;
          t_kk = kk;
        }
      }
    }
    m = 0;
    for (int kk = 1; kk <= int(std::min<int64_t>(6, natoms - a - 1)); ++kk) {
      if (!small_ok[size_t(a + kk)]) break;
      m = std::max(m, per_atom[size_t(a + kk)]);
      const int cands[2] = {m, idx};
      const int ncand = idx > m ? 2 : 1;
      for (int ci = 0; ci < ncand; ++ci) {
        const int t = cands[ci];
        int64_t c = trans_bits(t, kk) + 1 + wl + kTngTab.width[t][3 * kk];
        if (c * best_adv < best_c * (1 + kk)) {
          best_c = c;
          best_adv = 1 + kk;
          kind = 'D';
          t_idx = t;
          t_kk = kk;
        }
      }
    }
  };

  int64_t a = 0;
  bw.put(4, 0b0100);  // ONLY_LARGE: atom 0
  put_large(a);
  ++a;
  while (a < natoms) {
    char kind;
    int t_idx, t_kk;
    decide(a, 4 + wl, kind, t_idx, t_kk);
    if (kind == 'L') {
      // extend into a LARGE_RLE run: each further large costs exactly
      // W bits, so the continuation baseline is W (see io/tng.py)
      int n_big = 1;
      while (a + n_big < natoms && n_big < 18) {
        char k2;
        int ti2, tk2;
        decide(a + n_big, wl, k2, ti2, tk2);
        if (k2 != 'L') break;
        ++n_big;
      }
      if (n_big >= 3) {
        bw.put(5, 0b01111);
        bw.put(4, uint32_t(n_big - 3));
        for (int i = 0; i < n_big; ++i) put_large(a++);
      } else {
        for (int i = 0; i < n_big; ++i) {
          bw.put(4, 0b0100);
          put_large(a++);
        }
      }
    } else if (kind == 'S') {
      set_idx_k(t_idx, t_kk);
      bw.put(4, 0b0101);
      put_run(a, t_kk);
      a += t_kk;
    } else {  // DEFAULT: large + chained run
      set_idx_k(t_idx, t_kk);
      bw.put(1, 1);
      put_large(a);
      put_run(a + 1, t_kk);
      a += 1 + t_kk;
    }
  }
  bw.flush();
  return 0;
}

}  // namespace

// ==================================================================== C ABI
extern "C" {

// ---- TNG tng_compress XTC2 ----------------------------------------------

// Decode one XTC2 position stream (payload after the 40-byte TNGP
// header) into int32 quantized coordinates [natoms, 3].
int64_t gx_tng_xtc2_decode(const uint8_t* stream, int64_t nbytes,
                           int32_t natoms, int32_t* out) {
  return tng_xtc2_decode_impl(stream, nbytes, natoms, out);
}

// Encode int32 quantized coordinates [natoms, 3] as one XTC2 stream
// (header + instruction bits).  Returns bytes written into `out`
// (capacity `cap`), or a negative GxError.
int64_t gx_tng_xtc2_encode(const int32_t* q, int32_t natoms, uint8_t* out,
                           int64_t cap) {
  std::vector<uint8_t> buf;
  int64_t rc = tng_xtc2_encode_impl(q, natoms, buf);
  if (rc != 0) return rc;
  if (int64_t(buf.size()) > cap) return GX_ERR_CAP;
  std::memcpy(out, buf.data(), buf.size());
  return int64_t(buf.size());
}

// ---- XTC ----------------------------------------------------------------

// Scan an XTC file, filling per-frame metadata arrays (capacity `cap`).
// Returns the number of frames, or a negative GxError.
int64_t gx_xtc_scan(const char* path, int64_t cap, int64_t* offsets, int32_t* steps,
                    float* times, int32_t* natoms_out) {
  FileReader f;
  if (!f.open(path)) return GX_ERR_OPEN;
  int64_t off = 0;
  int64_t n = 0;
  int32_t natoms = -1;
  while (off < f.size) {
    XtcHeader h;
    int64_t rc = parse_xtc_header(f, off, &h);
    if (rc != GX_OK) return (n == 0) ? rc : GX_ERR_CORRUPT;
    if (natoms < 0) {
      natoms = h.natoms;
    } else if (natoms != h.natoms) {
      return GX_ERR_NATOMS;
    }
    if (n >= cap) return GX_ERR_RANGE;
    offsets[n] = off;
    steps[n] = h.step;
    times[n] = h.time;
    n++;
    off += h.frame_size;
  }
  if (natoms_out) *natoms_out = natoms;
  return n;
}

// Decode `nframes` frames whose start offsets are given in `offsets`.
// coords: [nframes, stop_after, 3] (only the first `stop_after` atoms of
// each frame are produced — partial-frame decode).  boxes: [nframes, 9].
int64_t gx_xtc_read(const char* path, const int64_t* offsets, int64_t nframes,
                    int32_t expected_natoms, int32_t stop_after, float* coords, float* boxes,
                    int32_t* steps, float* times, float* precisions, int32_t n_threads) {
  return gx_xtc_read_impl(path, offsets, nframes, expected_natoms, stop_after, coords,
                          boxes, steps, times, precisions, n_threads);
}

// Quantized variant: emits the raw 3dfcoord integers as int16 (fails with
// GX_ERR_RANGE if any frame's integer bounds exceed int16 — callers fall
// back to the float path).  Intended as a compact on-wire format for
// host->device transfer: dequantizing on device with float(q) * (1/prec)
// reproduces the float path bit-for-bit.
int64_t gx_xtc_read_q16(const char* path, const int64_t* offsets, int64_t nframes,
                        int32_t expected_natoms, int32_t stop_after, int16_t* coords,
                        float* boxes, int32_t* steps, float* times, float* precisions,
                        int32_t n_threads) {
  return gx_xtc_read_impl(path, offsets, nframes, expected_natoms, stop_after, coords,
                          boxes, steps, times, precisions, n_threads);
}

// Delta-wire variant: decode frames to raw quantized int32, then emit
// int8 INTER-FRAME deltas (3 bytes/atom-frame vs 6 for q16, 12 for f32)
// plus a sparse per-frame ESCAPE list for atoms whose motion does not fit
// int8 — periodic-boundary crossers (a wrap jumps by the whole quantized
// box length) and fast movers.  An escape stores the atom index and its
// absolute quantized coords; its delta slot is zeroed.
//
// A per-frame global int shift (`shifts`, the median inter-frame delta
// over a coordinate sample) is removed before the int8 test, so
// whole-system drift — common in real MD output — does not blow the
// escape budget.
//
// Reconstruction (exact, bit-identical to the float decode path):
//   carry = base
//   for f in frames:
//     carry += shifts[f] + deltas[f]; carry[esc_idx[f]] = esc_val[f]
//   q[f] = carry; pos = float32(q) * (1/precision)
// carry equals the true quantized frame after every step (escaped atoms
// are reset to their absolute ints), so deltas are plain
// q[f] - q[f-1] - shift[f] and every frame converts independently in
// parallel.
//
// `base` ([stop_after, 3] int32, quantized at `base_prec`) chains chunks:
// a whole trajectory ships as one int32 key frame plus int8+escape
// streams.  When base is absent (or its precision mismatches this chunk),
// frame 0 is all-escape-free (deltas[0] = 0), base_out receives q[0] (the
// key frame to ship) and *base_used = 0.  last_out always receives the
// final frame's quantized ints — the base for the NEXT chunk.
//
// Fails with GX_ERR_DELTA when any frame needs more than `esc_cap`
// escapes (dense motion — e.g. frames saved far apart in time) or when
// precision varies across frames; callers fall back to the q16 wire.
// Shared impl for the int8 and 6-bit-packed delta wires: exactly one of
// `deltas` (int8, 3 B/atom) / `packed6` (6-bit biased u=d+32 MSB-first,
// 2.25 B/atom; per-frame row of ceil(stop*3/4)*3 bytes) is non-null.
// 4 biased 6-bit values -> 3 wire bytes, MSB-first within the group
// (the delta6 wire layout; the device-side unpack in FrameEngine and the
// test reconstructions mirror this expression)
static inline void pack6_group(uint8_t* dst, uint8_t u0, uint8_t u1,
                               uint8_t u2, uint8_t u3) {
  dst[0] = uint8_t((u0 << 2) | (u1 >> 4));
  dst[1] = uint8_t(((u1 & 0x0f) << 4) | (u2 >> 2));
  dst[2] = uint8_t(((u2 & 0x03) << 6) | u3);
}

static int64_t read_delta_impl(const char* path, const int64_t* offsets, int64_t nframes,
                          int32_t expected_natoms, int32_t stop_after,
                          const int32_t* sel, int32_t nsel,
                          const int32_t* base, float base_prec, int8_t* deltas,
                          uint8_t* packed6,
                          int32_t* shifts, int32_t* esc_idx, int32_t* esc_val,
                          int32_t* esc_count, int32_t esc_cap, int32_t* base_out,
                          int32_t* last_out, int32_t* base_used, float* boxes,
                          int32_t* steps, float* times, float* precisions,
                          int32_t n_threads) {
  FileReader f;
  if (!f.open(path)) return GX_ERR_OPEN;
  if (nframes <= 0) return GX_OK;
  const int64_t natoms3 = int64_t(stop_after) * 3;
  // selection mode: decode the full prefix but EMIT only `sel`'s atoms
  // (deltas, escapes, key frames all live in selection space) — the
  // compact wires then need no host-side gather pass at all
  const int32_t nout = sel ? nsel : stop_after;
  const int64_t nout3 = int64_t(nout) * 3;
  // int16 scratch (uninitialized): the delta wire presupposes q16-able
  // ints (GX_ERR_Q16 falls through to the q16/f32 paths otherwise), and
  // halving the scratch write traffic matters when decode is the wall
  std::unique_ptr<int16_t[]> q(new int16_t[size_t(nframes) * size_t(natoms3)]);
  std::unique_ptr<int16_t[]> base16;
  std::atomic<int64_t> err{GX_OK};
  parallel_for(nframes, n_threads, [&](int64_t i) {
    if (err.load(std::memory_order_relaxed) != GX_OK) return;
    XtcHeader h;
    int64_t rc = parse_xtc_header(f, offsets[i], &h);
    if (rc == GX_OK && h.natoms != expected_natoms) rc = GX_ERR_NATOMS;
    if (rc == GX_OK) {
      std::vector<uint8_t> scratch;
      rc = decode_xtc_frame_t(f, h, scratch, q.get() + i * natoms3, stop_after);
    }
    if (rc == GX_OK) {
      if (boxes) std::memcpy(boxes + i * 9, h.box, 9 * sizeof(float));
      if (steps) steps[i] = h.step;
      if (times) times[i] = h.time;
      if (precisions) precisions[i] = h.precision;
    } else {
      int64_t expected = GX_OK;
      err.compare_exchange_strong(expected, rc);
    }
  });
  if (err.load() != GX_OK) return err.load();
  // deltas only make sense inside ONE quantization grid
  for (int64_t i = 1; i < nframes; i++)
    if (precisions[i] != precisions[0]) return GX_ERR_DELTA;

  const int16_t* base0 = nullptr;  // selection space when `sel` given
  int used = (base != nullptr && base_prec == precisions[0]) ? 1 : 0;
  if (used) {
    base16.reset(new int16_t[size_t(nout3)]);
    for (int64_t k = 0; k < nout3; k++) {
      if (base[k] < -32768 || base[k] > 32767) return GX_ERR_DELTA;
      base16[size_t(k)] = int16_t(base[k]);
    }
    base0 = base16.get();
  } else if (sel) {
    base16.reset(new int16_t[size_t(nout3)]);
    for (int32_t j = 0; j < nout; j++)
      for (int c = 0; c < 3; c++) {
        const int16_t v = q[size_t(3 * int64_t(sel[j]) + c)];
        base16[size_t(3 * j + c)] = v;
        base_out[3 * j + c] = v;
      }
    base0 = base16.get();
  } else {
    for (int64_t k = 0; k < natoms3; k++) base_out[k] = q[size_t(k)];
    base0 = q.get();
  }
  if (base_used) *base_used = used;

  // contiguous selections (incl. the common "analysis atoms are a file
  // prefix" case) collapse the gathered per-atom loop to flat pointer
  // arithmetic, which the compiler auto-vectorizes (see the fast path in
  // the frame lambda below)
  bool sel_contig = sel != nullptr;
  if (sel)
    for (int32_t j = 1; j < nsel; ++j)
      if (sel[j] != sel[0] + j) {
        sel_contig = false;
        break;
      }
  const int32_t sel0 = (sel && nsel > 0) ? sel[0] : 0;

  parallel_for(nframes, n_threads, [&](int64_t i) {
    if (err.load(std::memory_order_relaxed) != GX_OK) return;
    // prev is SELECTION space for frame 0 (the base), full-frame space
    // otherwise; `at(p, j, c)` resolves the right index
    const bool prev_is_sel = (i == 0);
    const int16_t* prev = (i == 0) ? base0 : q.get() + (i - 1) * natoms3;
    const int16_t* cur = q.get() + i * natoms3;
    const int64_t npad = (nout3 + 3) & ~int64_t(3);
    int8_t* out = deltas ? deltas + i * nout3 : nullptr;
    std::vector<uint8_t> stage;  // scalar path only (fast path packs direct)
    auto prev_at = [&](int32_t j, int32_t a, int c) -> int32_t {
      return prev_is_sel && sel ? prev[3 * j + c] : prev[3 * a + c];
    };
    int32_t* eidx = esc_idx + i * int64_t(esc_cap);
    int32_t* eval = esc_val + i * int64_t(esc_cap) * 3;

    // global-drift removal: median per-axis delta over a strided sample
    int32_t shift[3] = {0, 0, 0};
    {
      const int32_t ns = std::min<int32_t>(nout, 1024);
      const int32_t stride = std::max<int32_t>(1, nout / ns);
      std::vector<int32_t> samp(static_cast<size_t>(ns), 0);
      for (int c = 0; c < 3; c++) {
        int32_t k = 0;
        for (int32_t j = 0; j < nout && k < ns; j += stride, k++) {
          const int32_t a = sel ? sel[j] : j;
          samp[size_t(k)] = int32_t(cur[3 * a + c]) - prev_at(j, a, c);
        }
        std::nth_element(samp.begin(), samp.begin() + k / 2, samp.begin() + k);
        shift[c] = samp[size_t(k / 2)];
      }
    }
    shifts[3 * i] = shift[0];
    shifts[3 * i + 1] = shift[1];
    shifts[3 * i + 2] = shift[2];

    int32_t ne = 0;
    if ((out || packed6) && (!sel || sel_contig)) {
      // flat block fast path for contiguous/absent selections.  24-value
      // blocks align with BOTH atom (3) and 6-bit-group (4) boundaries,
      // so each block is self-contained: pass 1 computes the 24 biased
      // bytes in registers, emits the wire directly, and records ONE
      // overflow flag per block (no per-value stage/ovb arrays — 6 MB of
      // cache traffic per 1M-atom frame in the previous two-pass form);
      // pass 2 revisits only flagged blocks (escapes are rare by the
      // wire's design), records the escapes, and repairs the block's
      // bytes in place.  Identical output to the scalar loop below.
      const int16_t* cp = cur + 3 * int64_t(sel0);
      const int16_t* pp = prev_is_sel ? prev : prev + 3 * int64_t(sel0);
      const int32_t bias = packed6 ? 32 : 128;
      const uint32_t ovmask = packed6 ? ~0x3fu : ~0xffu;
      int32_t pat[24];
      for (int t = 0; t < 24; ++t) pat[t] = shift[t % 3] - bias;
      uint8_t* pk = packed6 ? packed6 + i * (npad / 4) * 3 : nullptr;
      const int64_t nblk = nout3 / 24;
      std::vector<uint8_t> blkov(static_cast<size_t>(nblk) + 1, 0);
      for (int64_t blk = 0; blk < nblk; ++blk) {
        const int64_t k = 24 * blk;
        uint8_t s[24];
        uint32_t ov = 0;
        for (int t = 0; t < 24; ++t) {
          const int32_t d = int32_t(cp[k + t]) - int32_t(pp[k + t]) - pat[t];
          s[t] = uint8_t(d);
          ov |= uint32_t(d) & ovmask;
        }
        blkov[size_t(blk)] = ov != 0;
        if (packed6) {
          uint8_t* p3 = pk + (k / 4) * 3;
          for (int g = 0; g < 6; ++g)
            pack6_group(p3 + 3 * g, s[4 * g], s[4 * g + 1], s[4 * g + 2],
                        s[4 * g + 3]);
        } else {
          for (int t = 0; t < 24; ++t)
            out[k + t] = int8_t(int32_t(s[t]) - bias);
        }
      }
      // ragged tail block (< 24 values, < 28 incl. group pad): a small
      // local buffer pre-filled with the zero-delta bias
      if (nblk * 24 < nout3) {
        uint8_t s2[28];
        for (int t = 0; t < 28; ++t) s2[t] = 32;
        uint32_t ov = 0;
        for (int64_t k = nblk * 24; k < nout3; ++k) {
          const int32_t d = int32_t(cp[k]) - int32_t(pp[k]) - pat[k % 24];
          if (packed6)
            s2[k - nblk * 24] = uint8_t(d);
          else
            out[k] = int8_t(int32_t(uint8_t(d)) - bias);
          ov |= uint32_t(d) & ovmask;
        }
        blkov[size_t(nblk)] = ov != 0;
        if (packed6)
          for (int64_t g = (nblk * 24) / 4; g < npad / 4; ++g) {
            const uint8_t* u = s2 + (4 * g - nblk * 24);
            pack6_group(pk + 3 * g, u[0], u[1], u[2], u[3]);
          }
      }
      // pass 2: record + repair escapes inside flagged blocks only
      for (int64_t blk = 0; blk <= nblk; ++blk) {
        if (!blkov[size_t(blk)]) continue;
        const int32_t j0 = int32_t(8 * blk);
        const int32_t j1 = std::min<int32_t>(j0 + 8, nout);
        bool esc_in_blk[8] = {};
        for (int32_t j = j0; j < j1; ++j) {
          uint32_t ov = 0;
          for (int c = 0; c < 3; ++c) {
            const int64_t k = 3 * int64_t(j) + c;
            const int32_t d =
                int32_t(cp[k]) - int32_t(pp[k]) - pat[k % 24];
            ov |= uint32_t(d) & ovmask;
          }
          if (!ov) continue;
          if (ne >= esc_cap) {
            int64_t expected = GX_OK;
            err.compare_exchange_strong(expected, int64_t(GX_ERR_DELTA));
            return;
          }
          esc_in_blk[j - j0] = true;
          eidx[ne] = j;
          eval[3 * ne] = cp[3 * j];
          eval[3 * ne + 1] = cp[3 * j + 1];
          eval[3 * ne + 2] = cp[3 * j + 2];
          ne++;
          if (out)
            out[3 * j] = out[3 * j + 1] = out[3 * j + 2] = 0;
        }
        if (packed6) {
          // repack the block's groups with escaped atoms at the
          // zero-delta byte (blocks are group- and atom-aligned, so the
          // repair never crosses a block boundary)
          auto biased_at = [&](int64_t k) -> uint8_t {
            if (k >= nout3) return 32;  // pad
            if (esc_in_blk[(k / 3) - int64_t(j0)]) return 32;
            return uint8_t(int32_t(cp[k]) - int32_t(pp[k]) - pat[k % 24]);
          };
          const int64_t g0 = 6 * blk;
          const int64_t g1 = std::min<int64_t>(g0 + 6, npad / 4);
          for (int64_t g = g0; g < g1; ++g)
            pack6_group(pk + 3 * g, biased_at(4 * g), biased_at(4 * g + 1),
                        biased_at(4 * g + 2), biased_at(4 * g + 3));
        }
      }
      esc_count[i] = ne;
      return;
    }
    if (packed6) stage.assign(size_t(npad), 32);  // pad decodes to d=0
    for (int32_t j = 0; j < nout; j++) {
      const int32_t a = sel ? sel[j] : j;
      const int16_t* c = cur + 3 * a;
      int32_t d0 = int32_t(c[0]) - prev_at(j, a, 0) - shift[0],
              d1 = int32_t(c[1]) - prev_at(j, a, 1) - shift[1],
              d2 = int32_t(c[2]) - prev_at(j, a, 2) - shift[2];
      const int32_t over = packed6
          ? (((d0 + 32) | (d1 + 32) | (d2 + 32)) & ~0x3f)
          : (((d0 + 128) | (d1 + 128) | (d2 + 128)) & ~0xff);
      if (over) {
        if (ne >= esc_cap) {
          int64_t expected = GX_OK;
          err.compare_exchange_strong(expected, int64_t(GX_ERR_DELTA));
          return;
        }
        eidx[ne] = j;  // selection-space index
        eval[3 * ne] = c[0];
        eval[3 * ne + 1] = c[1];
        eval[3 * ne + 2] = c[2];
        ne++;
        if (out) out[3 * j] = out[3 * j + 1] = out[3 * j + 2] = 0;
        // stage already holds the zero-delta bias value 32
      } else if (out) {
        out[3 * j] = int8_t(d0);
        out[3 * j + 1] = int8_t(d1);
        out[3 * j + 2] = int8_t(d2);
      } else {
        stage[size_t(3 * j)] = uint8_t(d0 + 32);
        stage[size_t(3 * j + 1)] = uint8_t(d1 + 32);
        stage[size_t(3 * j + 2)] = uint8_t(d2 + 32);
      }
    }
    if (packed6) {
      uint8_t* pk = packed6 + i * (npad / 4) * 3;
      for (int64_t g = 0; g < npad / 4; g++)
        pack6_group(pk + 3 * g, stage[size_t(4 * g)], stage[size_t(4 * g + 1)],
                    stage[size_t(4 * g + 2)], stage[size_t(4 * g + 3)]);
    }
    esc_count[i] = ne;
  });
  if (err.load() != GX_OK) return err.load();
  {
    const int16_t* lastf = q.get() + (nframes - 1) * natoms3;
    if (sel) {
      for (int32_t j = 0; j < nout; j++)
        for (int c = 0; c < 3; c++)
          last_out[3 * j + c] = lastf[3 * int64_t(sel[j]) + c];
    } else {
      for (int64_t k = 0; k < natoms3; k++) last_out[k] = lastf[k];
    }
  }
  return GX_OK;
}

int64_t gx_xtc_read_delta(const char* path, const int64_t* offsets, int64_t nframes,
                          int32_t expected_natoms, int32_t stop_after,
                          const int32_t* sel, int32_t nsel,
                          const int32_t* base, float base_prec, int8_t* deltas,
                          int32_t* shifts, int32_t* esc_idx, int32_t* esc_val,
                          int32_t* esc_count, int32_t esc_cap, int32_t* base_out,
                          int32_t* last_out, int32_t* base_used, float* boxes,
                          int32_t* steps, float* times, float* precisions,
                          int32_t n_threads) {
  return read_delta_impl(path, offsets, nframes, expected_natoms, stop_after,
                         sel, nsel, base, base_prec, deltas, nullptr, shifts,
                         esc_idx, esc_val, esc_count, esc_cap, base_out,
                         last_out, base_used, boxes, steps, times, precisions,
                         n_threads);
}

// 6-bit packed delta wire (2.25 B/atom-frame): biased deltas u = d + 32 in
// [0, 63], four values per 3 bytes, escapes for |d| > 31.  Same chaining /
// shift / escape semantics as the int8 wire.
int64_t gx_xtc_read_delta6(const char* path, const int64_t* offsets, int64_t nframes,
                           int32_t expected_natoms, int32_t stop_after,
                           const int32_t* sel, int32_t nsel,
                           const int32_t* base, float base_prec, uint8_t* packed,
                           int32_t* shifts, int32_t* esc_idx, int32_t* esc_val,
                           int32_t* esc_count, int32_t esc_cap, int32_t* base_out,
                           int32_t* last_out, int32_t* base_used, float* boxes,
                           int32_t* steps, float* times, float* precisions,
                           int32_t n_threads) {
  return read_delta_impl(path, offsets, nframes, expected_natoms, stop_after,
                         sel, nsel, base, base_prec, nullptr, packed, shifts,
                         esc_idx, esc_val, esc_count, esc_cap, base_out,
                         last_out, base_used, boxes, steps, times, precisions,
                         n_threads);
}

// Hydrogen-bond candidate generation (one frame): the cell-pruned
// (donor, acceptor) pair walk of the reference (hbonds.rs:229-298 /
// cellgrid.rs:444-472), emitted in EXACT reference order — donors in
// chain order; per donor the <=27 neighbour cells in (x,y,z) relative
// offset order with offsets (-1,0,1) deduped modulo the cell count; and
// within a cell ascending atom index (counting sort).  Binning replays
// the reference f32 arithmetic (wrap loops, floor division).  This is
// the host-side bottleneck of the batched device hbond path at scale
// (~24 ms/frame in numpy at 33k atoms); here it is a single fused pass.
//
// Returns the pair count, or GX_ERR_CAP if `cap` is too small (caller
// doubles and retries).
int64_t gx_hbond_candidates(const float* pos, const float* box3,
                            const int32_t* acceptors, int32_t na,
                            const int32_t* donors, int32_t nd,
                            float max_distance,
                            int32_t* d_rank_out, int32_t* a_rank_out,
                            int64_t cap) {
  if (na <= 0 || nd <= 0) return 0;
  auto wrap1 = [](float x, float L) -> float {
    if (!(L > 0.f) || !std::isfinite(x)) return -1.f;  // signal corrupt
    while (x > L) x -= L;
    while (x < 0.f) x += L;
    return x;
  };
  int64_t ncells[3];
  float cell_w[3];
  for (int c = 0; c < 3; c++) {
    ncells[c] = std::max<int64_t>(int64_t(std::floor(box3[c] / max_distance)), 1);
    cell_w[c] = box3[c] / float(ncells[c]);
  }
  const int64_t total = ncells[0] * ncells[1] * ncells[2];
  if (total <= 0 || total > (int64_t(1) << 31)) return GX_ERR_CORRUPT;

  // --- acceptor cells + counting sort (ascending atom index per cell)
  std::vector<int32_t> acell(static_cast<size_t>(na), 0);
  std::vector<int32_t> cell_cnt(size_t(total) + 1, 0);
  for (int32_t k = 0; k < na; k++) {
    int64_t cid = 0;
    for (int c = 0; c < 3; c++) {
      float w = wrap1(pos[3 * int64_t(acceptors[k]) + c], box3[c]);
      if (w < 0.f) return GX_ERR_CORRUPT;
      int64_t cc = (int64_t(std::floor(w / cell_w[c])) % ncells[c] + ncells[c]) % ncells[c];
      cid = cid * ncells[c] + cc;
    }
    acell[size_t(k)] = int32_t(cid);
    cell_cnt[size_t(cid) + 1]++;
  }
  for (int64_t i = 0; i < total; i++) cell_cnt[size_t(i) + 1] += cell_cnt[size_t(i)];
  std::vector<int32_t> cell_atoms(static_cast<size_t>(na), 0);  // acceptor RANKS, sorted by cell
  {
    std::vector<int32_t> cursor(cell_cnt.begin(), cell_cnt.end() - 1);
    for (int32_t k = 0; k < na; k++)
      cell_atoms[size_t(cursor[size_t(acell[size_t(k)])]++)] = k;
  }

  // --- per-axis relative offsets (-1, 0, 1) deduped modulo ncells
  int offs[3][3];
  int noffs[3];
  for (int c = 0; c < 3; c++) {
    noffs[c] = 0;
    bool seen[3] = {false, false, false};
    for (int d = -1; d <= 1; d++) {
      int m = int(((d % ncells[c]) + ncells[c]) % ncells[c]);
      bool dup = false;
      for (int e = 0; e < noffs[c]; e++) {
        int me = int(((offs[c][e] % ncells[c]) + ncells[c]) % ncells[c]);
        if (me == m) dup = true;
      }
      (void)seen;
      if (!dup) offs[c][noffs[c]++] = d;
    }
  }

  int64_t n_out = 0;
  for (int32_t dk = 0; dk < nd; dk++) {
    const int32_t datom = donors[dk];
    int64_t dcc[3];
    for (int c = 0; c < 3; c++) {
      float w = wrap1(pos[3 * int64_t(datom) + c], box3[c]);
      if (w < 0.f) return GX_ERR_CORRUPT;
      dcc[c] = (int64_t(std::floor(w / cell_w[c])) % ncells[c] + ncells[c]) % ncells[c];
    }
    for (int ox = 0; ox < noffs[0]; ox++)
      for (int oy = 0; oy < noffs[1]; oy++)
        for (int oz = 0; oz < noffs[2]; oz++) {
          int64_t c0 = (dcc[0] + offs[0][ox] + ncells[0]) % ncells[0];
          int64_t c1 = (dcc[1] + offs[1][oy] + ncells[1]) % ncells[1];
          int64_t c2 = (dcc[2] + offs[2][oz] + ncells[2]) % ncells[2];
          int64_t cid = (c0 * ncells[1] + c1) * ncells[2] + c2;
          for (int32_t p = cell_cnt[size_t(cid)]; p < cell_cnt[size_t(cid) + 1]; p++) {
            int32_t ak = cell_atoms[size_t(p)];
            if (acceptors[ak] == datom) continue;  // self (hbonds.rs:253)
            if (n_out >= cap) return GX_ERR_CAP;
            d_rank_out[n_out] = dk;
            a_rank_out[n_out] = ak;
            n_out++;
          }
        }
  }
  return n_out;
}

// Probe natoms/magic from the first frame header.
int64_t gx_xtc_probe(const char* path, int32_t* natoms, int32_t* magic) {
  FileReader f;
  if (!f.open(path)) return GX_ERR_OPEN;
  XtcHeader h;
  int64_t rc = parse_xtc_header(f, 0, &h);
  if (rc != GX_OK) return rc;
  if (natoms) *natoms = h.natoms;
  if (magic) *magic = h.magic;
  return GX_OK;
}

// Compress one frame and append it to `path` (create if needed).
int64_t gx_xtc_write_frame(const char* path, int32_t natoms, int32_t step, float time,
                           const float* box9, const float* coords, float precision) {
  std::vector<uint8_t> payload;
  int32_t minint[3], maxint[3], smallidx = 0;
  int64_t nbytes = 0;
  if (natoms > 9) {
    int64_t rc = encode_3dfcoord(coords, natoms, precision, minint, maxint, &smallidx, payload);
    if (rc != GX_OK) return rc;
    nbytes = int64_t(payload.size());
  }

  std::vector<uint8_t> frame;
  frame.reserve(100 + payload.size());
  auto push_i32 = [&](int32_t v) {
    uint8_t b[4];
    store_i32(b, v);
    frame.insert(frame.end(), b, b + 4);
  };
  auto push_f32 = [&](float v) {
    uint8_t b[4];
    store_f32(b, v);
    frame.insert(frame.end(), b, b + 4);
  };
  push_i32(1995);
  push_i32(natoms);
  push_i32(step);
  push_f32(time);
  for (int i = 0; i < 9; i++) push_f32(box9 ? box9[i] : 0.0f);
  push_i32(natoms);
  if (natoms <= 9) {
    for (int i = 0; i < natoms * 3; i++) push_f32(coords[i]);
  } else {
    push_f32(precision);
    for (int d = 0; d < 3; d++) push_i32(minint[d]);
    for (int d = 0; d < 3; d++) push_i32(maxint[d]);
    push_i32(smallidx);
    push_i32(int32_t(nbytes));
    frame.insert(frame.end(), payload.begin(), payload.end());
    while (frame.size() % 4 != 0) frame.push_back(0);
  }

  FILE* fh = std::fopen(path, "ab");
  if (!fh) return GX_ERR_OPEN;
  size_t w = std::fwrite(frame.data(), 1, frame.size(), fh);
  std::fclose(fh);
  return (w == frame.size()) ? GX_OK : GX_ERR_IO;
}

// ---- TRR ----------------------------------------------------------------

// Scan a TRR file.  Flag bytes: bit0 = has_x, bit1 = has_v, bit2 = has_f,
// bit3 = is_double.
int64_t gx_trr_scan(const char* path, int64_t cap, int64_t* offsets, int32_t* steps,
                    double* times, double* lambdas, uint8_t* flags, int32_t* natoms_out) {
  FileReader f;
  if (!f.open(path)) return GX_ERR_OPEN;
  int64_t off = 0, n = 0;
  int32_t natoms = -1;
  while (off < f.size) {
    TrrHeader h;
    int64_t rc = parse_trr_header(f, off, &h);
    if (rc != GX_OK) return (n == 0) ? rc : GX_ERR_CORRUPT;
    if (natoms < 0) {
      natoms = h.natoms;
    } else if (natoms != h.natoms) {
      return GX_ERR_NATOMS;
    }
    if (n >= cap) return GX_ERR_RANGE;
    offsets[n] = off;
    steps[n] = h.step;
    times[n] = h.time;
    lambdas[n] = h.lambda;
    flags[n] = uint8_t((h.x_size ? 1 : 0) | (h.v_size ? 2 : 0) | (h.f_size ? 4 : 0) |
                       (h.is_double ? 8 : 0));
    n++;
    off += h.frame_size;
  }
  if (natoms_out) *natoms_out = natoms;
  return n;
}

// Read TRR frames.  x/v/f buffers are [nframes, natoms, 3] (may be null);
// absent blocks leave the corresponding frame slice untouched.
// stop_after <= natoms reads only the first stop_after atoms of each
// x/v/f block — TRR blocks are uncompressed, so partial reads touch only
// the needed byte ranges (cf. the reference's GroupXtcReader concept,
// molly_xtc.rs:475; TRR can do it exactly, no sequential decode needed).
int64_t gx_trr_read(const char* path, const int64_t* offsets, int64_t nframes, int32_t natoms,
                    int32_t stop_after, float* x, float* v, float* fr, float* boxes,
                    int32_t* steps, double* times, double* lambdas, uint8_t* flags,
                    int32_t n_threads) {
  FileReader f;
  if (!f.open(path)) return GX_ERR_OPEN;
  std::atomic<int64_t> err{GX_OK};
  const int64_t n3 = int64_t(stop_after) * 3;
  parallel_for(nframes, n_threads, [&](int64_t i) {
    if (err.load(std::memory_order_relaxed) != GX_OK) return;
    TrrHeader h;
    int64_t rc = parse_trr_header(f, offsets[i], &h);
    if (rc == GX_OK && h.natoms != natoms) rc = GX_ERR_NATOMS;
    if (rc == GX_OK) {
      std::vector<uint8_t> scratch;
      int64_t p = h.body_offset + h.box_size + h.vir_size + h.pres_size;
      bool ok = true;
      if (h.x_size && x) ok = ok && read_reals(f, p, n3, h.is_double, x + i * n3, scratch);
      p += h.x_size;
      if (h.v_size && v) ok = ok && read_reals(f, p, n3, h.is_double, v + i * n3, scratch);
      p += h.v_size;
      if (h.f_size && fr) ok = ok && read_reals(f, p, n3, h.is_double, fr + i * n3, scratch);
      if (!ok) rc = GX_ERR_IO;
      if (rc == GX_OK) {
        if (boxes)
          for (int k = 0; k < 9; k++) boxes[i * 9 + k] = float(h.box[k]);
        if (steps) steps[i] = h.step;
        if (times) times[i] = h.time;
        if (lambdas) lambdas[i] = h.lambda;
        if (flags)
          flags[i] = uint8_t((h.x_size ? 1 : 0) | (h.v_size ? 2 : 0) | (h.f_size ? 4 : 0) |
                             (h.is_double ? 8 : 0));
      }
    }
    if (rc != GX_OK) {
      int64_t expected = GX_OK;
      err.compare_exchange_strong(expected, rc);
    }
  });
  return err.load();
}

int64_t gx_trr_probe(const char* path, int32_t* natoms) {
  FileReader f;
  if (!f.open(path)) return GX_ERR_OPEN;
  TrrHeader h;
  int64_t rc = parse_trr_header(f, 0, &h);
  if (rc != GX_OK) return rc;
  if (natoms) *natoms = h.natoms;
  return GX_OK;
}

// Write one single-precision TRR frame (x/v/f nullable).
int64_t gx_trr_write_frame(const char* path, int32_t natoms, int32_t step, double time,
                           double lambda, const float* box9, const float* x, const float* v,
                           const float* fr) {
  std::vector<uint8_t> frame;
  auto push_i32 = [&](int32_t val) {
    uint8_t b[4];
    store_i32(b, val);
    frame.insert(frame.end(), b, b + 4);
  };
  auto push_f32 = [&](float val) {
    uint8_t b[4];
    store_f32(b, val);
    frame.insert(frame.end(), b, b + 4);
  };
  int64_t n3 = int64_t(natoms) * 3;
  int32_t box_size = box9 ? 36 : 0;
  int32_t x_size = x ? int32_t(n3 * 4) : 0;
  int32_t v_size = v ? int32_t(n3 * 4) : 0;
  int32_t f_size = fr ? int32_t(n3 * 4) : 0;

  push_i32(1993);
  push_i32(13);
  push_i32(12);
  const char* tag = "GMX_trn_file";
  frame.insert(frame.end(), tag, tag + 12);
  push_i32(0);         // ir_size
  push_i32(0);         // e_size
  push_i32(box_size);  // box_size
  push_i32(0);         // vir_size
  push_i32(0);         // pres_size
  push_i32(0);         // top_size
  push_i32(0);         // sym_size
  push_i32(x_size);
  push_i32(v_size);
  push_i32(f_size);
  push_i32(natoms);
  push_i32(step);
  push_i32(0);  // nre
  push_f32(float(time));
  push_f32(float(lambda));
  if (box9)
    for (int i = 0; i < 9; i++) push_f32(box9[i]);
  auto push_block = [&](const float* src) {
    if (!src) return;
    for (int64_t i = 0; i < n3; i++) push_f32(src[i]);
  };
  push_block(x);
  push_block(v);
  push_block(fr);

  FILE* fh = std::fopen(path, "ab");
  if (!fh) return GX_ERR_OPEN;
  size_t w = std::fwrite(frame.data(), 1, frame.size(), fh);
  std::fclose(fh);
  return (w == frame.size()) ? GX_OK : GX_ERR_IO;
}

// Self-test of the exact magic division that underpins every bitstream
// decode (fast_divm): for each divisor in the XTC smallidx ladder, the
// TNG base table, and adversarial families (d, d-1, d+1, 2^k, 2^k +- 1),
// check quotient/remainder against hardware division at the boundary
// dividends x in {k*d - 1, k*d, k*d + 1} for k spanning the full u64/x
// range plus a deterministic LCG sweep.  Returns the number of failing
// (x, d) pairs (0 = pass); exercised by tests/test_wire_formats.py.
int64_t gx_selftest_divm(int64_t n_random) {
  int64_t bad = 0;
  std::vector<uint32_t> divisors;
  for (int i = 0; i <= kLastIdx; ++i)
    if (kMagicInts[i] > 1) divisors.push_back(uint32_t(kMagicInts[i]));
  for (int k = 1; k < 32; ++k) {
    const uint32_t p = uint32_t(1) << k;
    divisors.push_back(p);
    divisors.push_back(p - 1);
    if (p < 0x80000000u) divisors.push_back(p + 1);
  }
  divisors.push_back(2);
  divisors.push_back(3);
  divisors.push_back(0xffffffffu);
  auto check = [&](uint64_t x, uint32_t d, uint64_t m) {
    const uint64_t q = BitReader::fast_divm(x, d, m);
    if (q != x / d) ++bad;
  };
  uint64_t lcg = 0x9e3779b97f4a7c15ull;
  for (uint32_t d : divisors) {
    const uint64_t m = BitReader::magic_of(d);
    // boundaries around multiples across the magnitude range
    for (int s = 0; s < 64; ++s) {
      const uint64_t base = (uint64_t(1) << s);
      const uint64_t k = base / d;
      for (int off = -1; off <= 1; ++off) {
        const uint64_t x0 = k * uint64_t(d);
        if (x0 == 0 && off < 0) continue;
        check(x0 + uint64_t(int64_t(off)), d, m);
      }
      check(base - 1, d, m);
      check(base, d, m);
    }
    check(~uint64_t(0), d, m);            // x = 2^64 - 1
    check(uint64_t(d) - 1, d, m);         // q = 0 boundary
    check(uint64_t(d), d, m);             // q = 1 boundary
    for (int64_t r = 0; r < n_random; ++r) {
      lcg = lcg * 6364136223846793005ull + 1442695040888963407ull;
      check(lcg, d, m);
      // and the nearest exact-multiple boundaries of that draw
      const uint64_t q = lcg / d;
      check(q * d, d, m);
      if (q) check(q * d - 1, d, m);
    }
  }
  // d == 1 identity path
  check(123456789ull, 1, BitReader::magic_of(1));
  return bad;
}

}  // extern "C"
