// TIFF LZW codec — native hot loops for deepbedmap_tpu_torch.data.geotiff.
//
// The Python implementation in geotiff.py is the semantic reference (libtiff-
// compatible "early change" width transitions, cross-validated against
// PIL/libtiff in tests/test_data.py); this C++ port exists because encoding a
// ~800 MB continent DEM byte-by-byte in Python is minutes, not seconds.
//
// Build: deepbedmap_tpu_torch/data/_tiffnative.py runs g++ on first use.
// ABI: plain C functions, loaded via ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int width) {
    bitbuf = (bitbuf << width) | code;
    bitcnt += width;
    while (bitcnt >= 8) {
      out.push_back(static_cast<uint8_t>((bitbuf >> (bitcnt - 8)) & 0xFF));
      bitcnt -= 8;
    }
  }
  void flush() {
    if (bitcnt > 0) {
      out.push_back(static_cast<uint8_t>((bitbuf << (8 - bitcnt)) & 0xFF));
      bitcnt = 0;
    }
  }
};

}  // namespace

extern "C" {

// Encode `n` bytes; writes up to `cap` bytes into `out`.
// Returns bytes written, or -1 if `cap` is insufficient.
long long tiff_lzw_encode(const uint8_t* in, long long n, uint8_t* out,
                          long long cap) {
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(n + (n >> 1) + 64));
  BitWriter bw(buf);

  // Dictionary as a prefix-tree packed in a flat array:
  // next[code * 256 + byte] -> code of (string(code) + byte); stale entries
  // are detected via a generation stamp so dictionary clears are O(1)
  // instead of a 4 MB memset (clears are frequent on poorly-compressible
  // data and dominated the profile).
  std::vector<int32_t> next(4096 * 256, 0);
  std::vector<uint32_t> gen(4096 * 256, 0);
  uint32_t epoch = 1;
  int next_code = 258;
  int width = 9;
  bw.put(kClear, width);

  long long pos = 0;
  if (n > 0) {
    int w = in[pos++];
    while (pos < n) {
      uint8_t c = in[pos++];
      size_t idx = static_cast<size_t>(w) * 256 + c;
      if (gen[idx] == epoch) {
        w = next[idx];
        continue;
      }
      bw.put(static_cast<uint32_t>(w), width);
      next[idx] = next_code++;
      gen[idx] = epoch;
      // width transition mirroring libtiff's decoder-side early change
      if (next_code == (1 << width) && width < 12) {
        width += 1;
      } else if (next_code == (1 << 12) - 2) {
        bw.put(kClear, width);
        ++epoch;
        next_code = 258;
        width = 9;
      }
      w = c;
    }
    bw.put(static_cast<uint32_t>(w), width);
  }
  bw.put(kEoi, width);
  bw.flush();

  if (static_cast<long long>(buf.size()) > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<long long>(buf.size());
}

// Decode `n` bytes; writes up to `cap` bytes into `out`.
// Returns bytes written, -1 if `cap` insufficient, -2 on malformed stream.
long long tiff_lzw_decode(const uint8_t* in, long long n, uint8_t* out,
                          long long cap) {
  // Fast LZW: every dictionary string, once emitted, exists CONTIGUOUSLY in
  // the output (entry T = string(prev) + first(code) starts where string(prev)
  // was just written, and first(code) lands immediately after via the next
  // emit). So each entry stores (start position in out, length, first byte)
  // and emit() is a forward copy from earlier output -- no prefix-chain walk,
  // no scratch buffer, memcpy when the ranges don't overlap (they only
  // overlap in the KwKwK case).
  std::vector<int64_t> spos(4096, -1);
  std::vector<int32_t> length(4096, 0);
  std::vector<uint8_t> firstb(4096, 0);
  for (int i = 0; i < 256; ++i) {
    firstb[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int table_size = 258;
  int width = 9;

  uint64_t bitbuf = 0;
  int bitcnt = 0;
  long long pos = 0;
  long long written = 0;
  int prev = -1;

  auto emit = [&](int code) -> bool {
    const long long len = length[code];
    if (written + len > cap) return false;
    if (len == 1) {
      out[written++] = firstb[code];
      return true;
    }
    const long long s = spos[code];
    if (s + len <= written) {
      std::memcpy(out + written, out + s, static_cast<size_t>(len));
    } else {
      for (long long i = 0; i < len; ++i) out[written + i] = out[s + i];
    }
    written += len;
    return true;
  };

  while (true) {
    while (bitcnt < width && pos < n) {
      bitbuf = (bitbuf << 8) | in[pos++];
      bitcnt += 8;
    }
    if (bitcnt < width) break;
    int code = static_cast<int>((bitbuf >> (bitcnt - width)) & ((1u << width) - 1));
    bitcnt -= width;

    if (code == kClear) {
      table_size = 258;
      width = 9;
      prev = -1;
      continue;
    }
    if (code == kEoi) break;

    if (prev < 0) {
      if (code >= 256) return -2;
      if (!emit(code)) return -1;
      prev = code;
    } else if (code < table_size) {
      if (code == kClear || code == kEoi) return -2;
      if (table_size < 4096) {
        spos[table_size] = written - length[prev];
        firstb[table_size] = firstb[prev];
        length[table_size] = length[prev] + 1;
        ++table_size;
      }
      if (!emit(code)) return -1;
      prev = code;
    } else if (code == table_size && table_size < 4096) {
      // KwKwK: the new entry is emitted immediately (overlap-forward copy)
      spos[table_size] = written - length[prev];
      firstb[table_size] = firstb[prev];
      length[table_size] = length[prev] + 1;
      ++table_size;
      if (!emit(table_size - 1)) return -1;
      prev = table_size - 1;
    } else {
      return -2;
    }
    // libtiff-compatible early change
    if (table_size >= (1 << width) - 1 && width < 12) width += 1;
  }
  return written;
}

// Decode many independent blocks in parallel (TIFF strips/tiles decompress
// independently). `in` concatenates the compressed blocks (`in_offsets`:
// n_blocks+1 entries); block i decodes into out[out_offsets[i] ..
// out_offsets[i+1]) and its written length lands in out_lens (negative on
// error). Returns 0, or -1 if any block failed.
long long tiff_lzw_decode_blocks(const uint8_t* in, const long long* in_offsets,
                                 int n_blocks, uint8_t* out,
                                 const long long* out_offsets,
                                 long long* out_lens, int n_threads) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int workers = n_threads > 0 ? n_threads : hw;
  if (workers > n_blocks) workers = n_blocks;
  if (workers > hw) workers = hw;

  std::atomic<int> next{0};
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_blocks) break;
      out_lens[i] = tiff_lzw_decode(
          in + in_offsets[i], in_offsets[i + 1] - in_offsets[i],
          out + out_offsets[i], out_offsets[i + 1] - out_offsets[i]);
    }
  };
  if (workers <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < workers; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  for (int i = 0; i < n_blocks; ++i)
    if (out_lens[i] < 0) return -1;
  return 0;
}

// Encode many independent blocks in parallel (TIFF strips/tiles compress
// independently). `in` is the concatenation of all blocks; `in_offsets` has
// n_blocks+1 entries. Each output block gets `out_stride` bytes at
// out + i*out_stride; written lengths land in out_lens (-1 if a block
// overflowed its stride). Threads: min(n_threads, blocks, hw concurrency).
long long tiff_lzw_encode_blocks(const uint8_t* in, const long long* in_offsets,
                                 int n_blocks, uint8_t* out,
                                 long long out_stride, long long* out_lens,
                                 int n_threads) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int workers = n_threads > 0 ? n_threads : hw;
  if (workers > n_blocks) workers = n_blocks;
  if (workers > hw) workers = hw;

  std::atomic<int> next{0};
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_blocks) break;
      const uint8_t* src = in + in_offsets[i];
      long long len = in_offsets[i + 1] - in_offsets[i];
      out_lens[i] = tiff_lzw_encode(src, len, out + i * out_stride, out_stride);
    }
  };
  if (workers <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < workers; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  for (int i = 0; i < n_blocks; ++i)
    if (out_lens[i] < 0) return -1;
  return 0;
}

// Horizontal differencing predictor (TIFF predictor 2) for int16 rows,
// in place: forward (encode) and inverse (decode).
void tiff_predict_i16(int16_t* data, long long rows, long long cols) {
  for (long long r = 0; r < rows; ++r) {
    int16_t* row = data + r * cols;
    for (long long c = cols - 1; c > 0; --c) row[c] = static_cast<int16_t>(row[c] - row[c - 1]);
  }
}

void tiff_unpredict_i16(int16_t* data, long long rows, long long cols) {
  for (long long r = 0; r < rows; ++r) {
    int16_t* row = data + r * cols;
    for (long long c = 1; c < cols; ++c) row[c] = static_cast<int16_t>(row[c] + row[c - 1]);
  }
}

}  // extern "C"
