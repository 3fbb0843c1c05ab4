/* FLAC decoder of the PyTorch/CUDA port, host C++ with a plain C interface.
 *
 * The port's own copy of the JAX package's native decoder
 * (native/augment/flac.cc), so that the port reads the ASVspoof2019 corpus
 * as shipped without soundfile. It handles the standard streamable subset:
 * 8/16/24-bit PCM, mono and stereo, every channel decorrelation mode,
 * constant/verbatim/fixed/LPC subframes and Rice-coded residual
 * partitions. CRCs are parsed but not verified (the input is trusted local
 * data).
 *
 * Built with the host C++ compiler at first use
 * (ops/_host_build.host_library(), c++ -O2 -shared -fPIC); no nvcc is
 * needed.
 */

#include <cstddef>
#include <cstdint>

#include <cstring>
#include <vector>

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  bool ok() const { return !fail_; }
  size_t byte_pos() const { return pos_ >> 3; }

  uint64_t bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      if (pos_ >= size_ * 8) {
        fail_ = true;
        return 0;
      }
      v = (v << 1) | ((data_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1);
      ++pos_;
    }
    return v;
  }

  int64_t signed_bits(int n) {
    uint64_t v = bits(n);
    if (n > 0 && (v >> (n - 1)) & 1) {
      return static_cast<int64_t>(v) - (1LL << n);
    }
    return static_cast<int64_t>(v);
  }

  uint32_t unary() {
    uint32_t q = 0;
    while (ok() && bits(1) == 0) {
      ++q;
      if (q > 1u << 24) {
        fail_ = true;
        break;
      }
    }
    return q;
  }

  void align() { pos_ = (pos_ + 7) & ~size_t(7); }

  void skip_bytes(size_t n) { pos_ += n * 8; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  bool fail_ = false;
};

int64_t rice_decode(BitReader& br, int param) {
  uint32_t q = br.unary();
  uint64_t r = br.bits(param);
  uint64_t u = (static_cast<uint64_t>(q) << param) | r;
  /* zigzag */
  return (u >> 1) ^ -static_cast<int64_t>(u & 1);
}

bool decode_residual(BitReader& br, int order, int block_size,
                     std::vector<int64_t>& out) {
  int method = static_cast<int>(br.bits(2));
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  int escape = method == 0 ? 15 : 31;
  int part_order = static_cast<int>(br.bits(4));
  int n_parts = 1 << part_order;
  if (block_size % n_parts) return false;
  int idx = order;
  for (int p = 0; p < n_parts; ++p) {
    int n = block_size >> part_order;
    if (p == 0) n -= order;
    int param = static_cast<int>(br.bits(param_bits));
    if (param == escape) {
      int raw_bits = static_cast<int>(br.bits(5));
      for (int i = 0; i < n; ++i) out[idx++] = br.signed_bits(raw_bits);
    } else {
      for (int i = 0; i < n; ++i) out[idx++] = rice_decode(br, param);
    }
    if (!br.ok()) return false;
  }
  return true;
}

const int kFixedOrders[5][4] = {
    {},
    {1},
    {2, -1},
    {3, -3, 1},
    {4, -6, 4, -1},
};

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
  if (br.bits(1) != 0) return false;  /* padding bit */
  int type = static_cast<int>(br.bits(6));
  int wasted = 0;
  if (br.bits(1)) {
    wasted = 1 + static_cast<int>(br.unary());
  }
  bps -= wasted;
  out.assign(block_size, 0);

  if (type == 0) {  /* CONSTANT */
    int64_t v = br.signed_bits(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  /* VERBATIM */
    for (int i = 0; i < block_size; ++i) out[i] = br.signed_bits(bps);
  } else if (type >= 8 && type <= 12) {  /* FIXED order 0..4 */
    int order = type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.signed_bits(bps);
    if (!decode_residual(br, order, block_size, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) {
        pred += static_cast<int64_t>(kFixedOrders[order][j]) * out[i - 1 - j];
      }
      out[i] += pred;
    }
  } else if (type >= 32) {  /* LPC order 1..32 */
    int order = (type & 31) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.signed_bits(bps);
    int precision = static_cast<int>(br.bits(4)) + 1;
    if (precision == 16) return false;  /* invalid */
    int shift = static_cast<int>(br.signed_bits(5));
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.signed_bits(precision);
    if (!decode_residual(br, order, block_size, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted) {
    for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
  }
  return br.ok();
}

uint64_t read_utf8(BitReader& br) {
  uint64_t b0 = br.bits(8);
  int extra = 0;
  uint64_t v;
  if ((b0 & 0x80) == 0) {
    return b0;
  } else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
  else { extra = 6; v = 0; }
  for (int i = 0; i < extra; ++i) v = (v << 6) | (br.bits(8) & 0x3F);
  return v;
}

}  // namespace

/* Parse the metadata headers up to the first audio frame. Returns
 * STREAMINFO total_samples (0 = unknown per spec) and leaves `br`
 * positioned at the first frame; -1 on malformed input. */
static int64_t parse_headers(BitReader& br, int* sr, int* nch, int* bps) {
  br.skip_bytes(4);
  int64_t total = -1;
  bool last = false;
  while (!last) {
    last = br.bits(1);
    int type = static_cast<int>(br.bits(7));
    uint32_t len = static_cast<uint32_t>(br.bits(24));
    if (type == 0) { /* STREAMINFO */
      br.bits(16); br.bits(16);       /* min/max block size */
      br.bits(24); br.bits(24);       /* min/max frame size */
      *sr = static_cast<int>(br.bits(20));
      *nch = static_cast<int>(br.bits(3)) + 1;
      *bps = static_cast<int>(br.bits(5)) + 1;
      total = static_cast<int64_t>(br.bits(36));
      br.skip_bytes(16);              /* md5 */
    } else {
      br.skip_bytes(len);
    }
    if (!br.ok()) return -1;
  }
  if (total < 0 || *sr == 0 || *nch < 1 || *nch > 8) return -1;
  return total;
}

extern "C" {

/* STREAMINFO probe: returns total samples per channel (0 = unknown),
 * or -1 on malformed input. */
long flac_stream_info(const uint8_t* data, size_t size, int* sample_rate,
                      int* channels, int* bits_per_sample) {
  if (size < 42 || std::memcmp(data, "fLaC", 4) != 0) return -1;
  BitReader br(data, size);
  int sr = 0, nch = 0, bps = 0;
  int64_t total = parse_headers(br, &sr, &nch, &bps);
  if (total < 0) return -1;
  *sample_rate = sr;
  *channels = nch;
  *bits_per_sample = bps;
  return static_cast<long>(total);
}

/* Decode a FLAC stream. Returns samples written PER CHANNEL, or -1 on
 * malformed input. Output is interleaved int32 (original bit depth,
 * sign-extended). */
long flac_decode(const uint8_t* data, size_t size, int32_t* out,
                 size_t max_samples, int* sample_rate, int* channels,
                 int* bits_per_sample) {
  if (size < 42 || std::memcmp(data, "fLaC", 4) != 0) return -1;
  BitReader br(data, size);
  int sr = 0, nch = 0, bps = 0;
  if (parse_headers(br, &sr, &nch, &bps) < 0) return -1;
  *sample_rate = sr;
  *channels = nch;
  *bits_per_sample = bps;

  static const int kBlock[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                 256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
  static const int kBps[8] = {0, 8, 12, -1, 16, 20, 24, 32};

  size_t written = 0;
  std::vector<std::vector<int64_t>> ch(nch);

  while (br.ok() && written < max_samples) {
    /* frame sync: 14 bits 0b11111111111110 */
    uint64_t sync = br.bits(14);
    if (!br.ok()) break;  /* clean EOF */
    if (sync != 0x3FFE) return written ? static_cast<long>(written) : -1;
    br.bits(1);                        /* reserved */
    br.bits(1);                        /* blocking strategy */
    int bs_code = static_cast<int>(br.bits(4));
    int sr_code = static_cast<int>(br.bits(4));
    int ch_code = static_cast<int>(br.bits(4));
    int bps_code = static_cast<int>(br.bits(3));
    br.bits(1);                        /* reserved */
    read_utf8(br);                     /* frame or sample number */

    int block_size;
    if (bs_code == 6) block_size = static_cast<int>(br.bits(8)) + 1;
    else if (bs_code == 7) block_size = static_cast<int>(br.bits(16)) + 1;
    else block_size = kBlock[bs_code];
    if (block_size <= 0) return -1;

    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);

    int frame_bps = bps_code == 0 ? bps : kBps[bps_code];
    if (frame_bps <= 0) return -1;

    br.bits(8);                        /* header CRC-8 */

    int n_sub = nch;
    int mode = 0;  /* 0 independent, 1 L/S, 2 R/S, 3 M/S */
    if (ch_code >= 8 && ch_code <= 10) {
      n_sub = 2;
      mode = ch_code - 7;
      if (nch != 2) return -1;
    } else if (ch_code > 10) {
      return -1;
    }

    for (int c = 0; c < n_sub; ++c) {
      int sub_bps = frame_bps;
      /* side channel carries one extra bit */
      if ((mode == 1 && c == 1) || (mode == 2 && c == 0) ||
          (mode == 3 && c == 1)) {
        sub_bps += 1;
      }
      if (!decode_subframe(br, block_size, sub_bps, ch[c])) return -1;
    }
    br.align();
    br.bits(16);                       /* frame CRC-16 */
    if (!br.ok()) return -1;

    /* undo decorrelation */
    if (mode == 1) {            /* left/side: R = L - S */
      for (int i = 0; i < block_size; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (mode == 2) {     /* right/side: L = S + R */
      for (int i = 0; i < block_size; ++i) ch[0][i] = ch[0][i] + ch[1][i];
    } else if (mode == 3) {     /* mid/side */
      for (int i = 0; i < block_size; ++i) {
        int64_t mid = ch[0][i];
        int64_t side = ch[1][i];
        mid = (mid << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    for (int i = 0; i < block_size && written < max_samples; ++i) {
      for (int c = 0; c < nch; ++c) {
        out[written * nch + c] = static_cast<int32_t>(ch[c][i]);
      }
      ++written;
    }
  }
  return static_cast<long>(written);
}

}  /* extern "C" */
