// Host-side native codec for fewbit-tpu.
//
// The device compute path packs activation codes in the codec
// (fewbit_tpu/ops/codec.py); this library is the *host* runtime
// counterpart — the role the reference's C++ stream codec plays on CPU
// (/root/reference/fewbit/cpu/codec.h:33-106), rebuilt for this package's
// bit-plane layout and for throughput (multi-threaded, word-oriented):
//
//   * bit-plane pack/unpack identical to fewbit_tpu.ops.bitpack — used for
//     host-side compression of code tensors (checkpoint/offload paths) and
//     as an independent oracle for the Python/JAX implementations;
//   * a dense little-endian stream codec (arbitrary width 1..32) for
//     byte-stream storage interchange.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this toolchain).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread -o libfewbit_host.so
//        fewbit_host_codec.cc

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr int kGroup = 32;  // codes per uint32 word per plane

inline uint64_t words_per_plane(uint64_t n) { return (n + kGroup - 1) / kGroup; }

// Run fn(begin, end) over [0, total) on up to `threads` workers.
template <typename Fn>
void parallel_for(uint64_t total, int threads, Fn fn) {
  if (threads <= 1 || total < (1u << 16)) {
    fn(0, total);
    return;
  }
  unsigned hw = std::thread::hardware_concurrency();
  int nt = std::min<uint64_t>(std::min<int>(threads, hw ? hw : 1), total);
  std::vector<std::thread> pool;
  uint64_t chunk = (total + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    uint64_t begin = t * chunk;
    uint64_t end = std::min(total, begin + chunk);
    if (begin >= end) break;
    pool.emplace_back([=] { fn(begin, end); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// --------------------------------------------------------------------------
// Bit-plane codec (layout identical to fewbit_tpu.ops.bitpack):
// codes viewed as a (32, m) C-order matrix, m = ceil(n/32);
// packed[b * m + j] = OR_i ((codes[i * m + j] >> b) & 1) << i.
// A ragged tail behaves as zero-padding.
// --------------------------------------------------------------------------

void fewbit_plane_pack(const uint32_t* codes, uint64_t n, int bits,
                       uint32_t* packed, int threads) {
  uint64_t m = words_per_plane(n);
  parallel_for(m, threads, [=](uint64_t begin, uint64_t end) {
    for (uint64_t j = begin; j < end; ++j) {
      uint32_t acc[32];  // one accumulator per plane is enough; reuse
      for (int b = 0; b < bits; ++b) acc[b] = 0;
      for (int i = 0; i < kGroup; ++i) {
        uint64_t idx = static_cast<uint64_t>(i) * m + j;
        uint32_t code = idx < n ? codes[idx] : 0u;
        for (int b = 0; b < bits; ++b) {
          acc[b] |= ((code >> b) & 1u) << i;
        }
      }
      for (int b = 0; b < bits; ++b) packed[static_cast<uint64_t>(b) * m + j] = acc[b];
    }
  });
}

void fewbit_plane_unpack(const uint32_t* packed, uint64_t n, int bits,
                         uint32_t* codes, int threads) {
  uint64_t m = words_per_plane(n);
  parallel_for(m, threads, [=](uint64_t begin, uint64_t end) {
    for (uint64_t j = begin; j < end; ++j) {
      for (int i = 0; i < kGroup; ++i) {
        uint64_t idx = static_cast<uint64_t>(i) * m + j;
        if (idx >= n) break;
        uint32_t code = 0;
        for (int b = 0; b < bits; ++b) {
          code |= ((packed[static_cast<uint64_t>(b) * m + j] >> i) & 1u) << b;
        }
        codes[idx] = code;
      }
    }
  });
}

// --------------------------------------------------------------------------
// Dense little-endian stream codec, width 1..32 bits per code: code k
// occupies bits [k*w, (k+1)*w) of the stream (LSB-first within bytes).
// Returns the number of bytes written/read, or 0 on invalid width.
// --------------------------------------------------------------------------

uint64_t fewbit_stream_nbytes(uint64_t n, int width) {
  if (width < 1 || width > 32) return 0;
  return (n * static_cast<uint64_t>(width) + 7) / 8;
}

uint64_t fewbit_stream_pack(const uint32_t* codes, uint64_t n, int width,
                            uint8_t* out) {
  uint64_t nbytes = fewbit_stream_nbytes(n, width);
  if (!nbytes) return 0;
  std::memset(out, 0, nbytes);
  uint64_t bitpos = 0;
  uint32_t mask = width == 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  for (uint64_t k = 0; k < n; ++k, bitpos += width) {
    uint64_t value = static_cast<uint64_t>(codes[k] & mask);
    uint64_t byte = bitpos >> 3;
    int shift = bitpos & 7;
    uint64_t merged = value << shift;
    for (int b = 0; merged; ++b, merged >>= 8) {
      out[byte + b] |= static_cast<uint8_t>(merged & 0xFFu);
    }
  }
  return nbytes;
}

uint64_t fewbit_stream_unpack(const uint8_t* stream, uint64_t n, int width,
                              uint32_t* codes) {
  uint64_t nbytes = fewbit_stream_nbytes(n, width);
  if (!nbytes) return 0;
  uint32_t mask = width == 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  uint64_t bitpos = 0;
  for (uint64_t k = 0; k < n; ++k, bitpos += width) {
    uint64_t byte = bitpos >> 3;
    int shift = bitpos & 7;
    uint64_t acc = 0;
    int have = 0;
    for (int b = 0; have < shift + 32 && byte + b < nbytes; ++b, have += 8) {
      acc |= static_cast<uint64_t>(stream[byte + b]) << (8 * b);
    }
    codes[k] = static_cast<uint32_t>((acc >> shift) & mask);
  }
  return nbytes;
}

int fewbit_host_abi_version() { return 1; }

}  // extern "C"
