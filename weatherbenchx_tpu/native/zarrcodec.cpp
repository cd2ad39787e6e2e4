// Parallel zarr cell decoder: threaded file read + codec inflation.
//
// The evaluation pipeline's storage bottleneck is decoding compressed zarr
// cells (the reference delegates this to zarr/numcodecs/c-blosc, none of
// which exist here). This module reads and decodes a batch of cell files
// concurrently, writing decompressed bytes straight into caller-provided
// numpy buffers — no Python-level per-stream loops, no intermediate
// copies. Codecs: raw, zlib, gzip, zstd, and the c-blosc1 chunk format
// (README_CHUNK_FORMAT.rst) with lz4/zstd/zlib inner streams and byte
// shuffle. The pure-Python mirror lives in weatherbenchx_tpu/codecs.py.
//
// Build: g++ -O3 -shared -fPIC -pthread zarrcodec.cpp -lz
//            -l:libzstd.so.1 -l:liblz4.so.1  (lz4 and zstd are linked by
//            soname and declared below, so only their runtime libraries
//            need to be installed, not their headers).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" size_t ZSTD_decompress(void* dst, size_t dst_capacity,
                                  const void* src, size_t compressed_size);
extern "C" size_t ZSTD_compress(void* dst, size_t dst_capacity,
                                const void* src, size_t src_size,
                                int compression_level);
extern "C" size_t ZSTD_compressBound(size_t src_size);
extern "C" unsigned ZSTD_isError(size_t code);
extern "C" int LZ4_decompress_safe(const char* src, char* dst,
                                   int compressed_size, int dst_capacity);
extern "C" int LZ4_compress_default(const char* src, char* dst,
                                    int src_size, int dst_capacity);
extern "C" int LZ4_compressBound(int input_size);

namespace {

enum Codec { RAW = 0, ZLIB = 1, GZIP = 2, ZSTD = 3, BLOSC = 4 };

enum Err {
  OK = 0,
  E_OPEN = 1,
  E_READ = 2,
  E_FORMAT = 3,
  E_DECODE = 4,
  E_SIZE = 5,
  E_UNSUPPORTED = 6,
  E_WRITE = 7,
  E_ENCODE = 8,
};

int read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return E_OPEN;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n < 0) {
    std::fclose(f);
    return E_READ;
  }
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(out->data(), 1, n, f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n) ? OK : E_READ;
}

int inflate_into(const uint8_t* src, size_t src_n, uint8_t* dst,
                 size_t dst_n, int window_bits) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, window_bits) != Z_OK) return E_DECODE;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(src_n);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(dst_n);
  int rc = inflate(&zs, Z_FINISH);
  uLong produced = zs.total_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END) return E_DECODE;
  return produced == dst_n ? OK : E_SIZE;
}

inline int32_t le32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;  // x86 and arm64 hosts are little-endian
}

inline uint32_t le32u(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Inverse byte shuffle: stream j holds byte-plane j of the block.
void unshuffle(const uint8_t* in, uint8_t* out, size_t nbytes,
               int typesize) {
  size_t n = nbytes / typesize;
  for (int j = 0; j < typesize; ++j) {
    const uint8_t* plane = in + j * n;
    uint8_t* o = out + j;
    for (size_t i = 0; i < n; ++i) o[i * typesize] = plane[i];
  }
  size_t tail = nbytes - n * typesize;
  if (tail) std::memcpy(out + n * typesize, in + n * typesize, tail);
}

constexpr int kMaxSplits = 16;
constexpr int kMinBuffer = 128;

int blosc_inner(int compressor, const uint8_t* src, int32_t csize,
                uint8_t* dst, int32_t dsize) {
  switch (compressor) {
    case 1: {  // lz4 / lz4hc (same raw block format)
      int n = LZ4_decompress_safe(reinterpret_cast<const char*>(src),
                                  reinterpret_cast<char*>(dst), csize, dsize);
      return n == dsize ? OK : E_DECODE;
    }
    case 3:  // zlib
      return inflate_into(src, csize, dst, dsize, MAX_WBITS);
    case 4: {  // zstd
      size_t n = ZSTD_decompress(dst, dsize, src, csize);
      return (!ZSTD_isError(n) && n == static_cast<size_t>(dsize))
                 ? OK
                 : E_DECODE;
    }
    default:  // blosclz / snappy need c-blosc itself
      return E_UNSUPPORTED;
  }
}

int decode_blosc(const std::vector<uint8_t>& raw, uint8_t* dst,
                 int64_t dst_n) {
  if (raw.size() < 16) return E_FORMAT;
  const uint8_t* p = raw.data();
  int flags = p[2], typesize = p[3];
  int32_t nbytes = le32(p + 4), blocksize = le32(p + 8);
  if (flags & 0x4) return E_UNSUPPORTED;  // bit-shuffle
  if (nbytes != dst_n) return E_SIZE;
  if (nbytes == 0) return OK;
  if (flags & 0x2) {  // pure memcpy chunk
    if (raw.size() < static_cast<size_t>(16 + nbytes)) return E_FORMAT;
    std::memcpy(dst, p + 16, nbytes);
    return OK;
  }
  if (blocksize <= 0) return E_FORMAT;
  int compressor = (flags >> 5) & 0x7;
  bool shuffled = (flags & 0x1) && typesize > 1;
  int nblocks = (nbytes + blocksize - 1) / blocksize;
  if (raw.size() < static_cast<size_t>(16 + 4 * nblocks)) return E_FORMAT;
  const uint8_t* bstarts = p + 16;

  std::vector<uint8_t> tmp(shuffled ? blocksize : 0);
  for (int b = 0; b < nblocks; ++b) {
    int32_t bsize = std::min<int64_t>(blocksize, nbytes - int64_t(b) * blocksize);
    bool leftover = bsize != blocksize;
    // Split rule mirrors codecs._decode_nsplits: modern chunks signal
    // non-splitting via flag 0x10; an absent flag means split whenever the
    // block is big enough to have been.
    int nsplits = 1;
    if (!leftover && typesize > 1 && !(flags & 0x10) &&
        typesize <= kMaxSplits && bsize / typesize >= kMinBuffer)
      nsplits = typesize;
    int32_t neblock = bsize / nsplits;
    // Unsigned read: a corrupt negative bstart sign-extended into size_t
    // would wrap the pos+4 bounds check below and read out of bounds.
    uint64_t pos = le32u(bstarts + 4 * b);
    uint8_t* block_out = shuffled ? tmp.data() : dst + int64_t(b) * blocksize;
    for (int s = 0; s < nsplits; ++s) {
      if (pos + 4 > raw.size()) return E_FORMAT;
      int32_t csize = le32(p + pos);
      pos += 4;
      if (csize < 0 || pos + csize > raw.size()) return E_FORMAT;
      uint8_t* dsplit = block_out + int64_t(s) * neblock;
      if (csize == neblock) {
        std::memcpy(dsplit, p + pos, neblock);
      } else {
        int rc = blosc_inner(compressor, p + pos, csize, dsplit, neblock);
        if (rc != OK) return rc;
      }
      pos += csize;
    }
    if (shuffled)
      unshuffle(tmp.data(), dst + int64_t(b) * blocksize, bsize, typesize);
  }
  return OK;
}

int decode_one(const char* path, int codec, uint8_t* dst, int64_t dst_n) {
  std::vector<uint8_t> raw;
  int rc = read_file(path, &raw);
  if (rc != OK) return rc;
  switch (codec) {
    case RAW:
      if (static_cast<int64_t>(raw.size()) != dst_n) return E_SIZE;
      std::memcpy(dst, raw.data(), raw.size());
      return OK;
    case ZLIB:
      return inflate_into(raw.data(), raw.size(), dst, dst_n, MAX_WBITS);
    case GZIP:
      return inflate_into(raw.data(), raw.size(), dst, dst_n,
                          MAX_WBITS | 32);
    case ZSTD: {
      size_t n = ZSTD_decompress(dst, dst_n, raw.data(), raw.size());
      return (!ZSTD_isError(n) && n == static_cast<size_t>(dst_n))
                 ? OK
                 : E_SIZE;
    }
    case BLOSC:
      return decode_blosc(raw, dst, dst_n);
    default:
      return E_UNSUPPORTED;
  }
}

// Byte shuffle (forward): interleaved elements to byte planes.
void shuffle_bytes(const uint8_t* in, uint8_t* out, size_t nbytes,
                   int typesize) {
  size_t n = nbytes / typesize;
  for (int j = 0; j < typesize; ++j) {
    uint8_t* plane = out + j * n;
    const uint8_t* i = in + j;
    for (size_t k = 0; k < n; ++k) plane[k] = i[k * typesize];
  }
  size_t tail = nbytes - n * typesize;
  if (tail) std::memcpy(out + n * typesize, in + n * typesize, tail);
}

int32_t choose_blocksize(int64_t nbytes, int typesize) {
  // Mirrors codecs._choose_blocksize: ~256 KB, a multiple of typesize.
  int64_t bs = nbytes <= (1 << 18) ? nbytes : (1 << 18);
  bs -= bs % typesize;
  if (bs < typesize) bs = typesize;
  return static_cast<int32_t>(bs);
}

void put_le32(std::vector<uint8_t>* out, size_t pos, int32_t v) {
  std::memcpy(out->data() + pos, &v, 4);
}

void append_le32(std::vector<uint8_t>* out, int32_t v) {
  size_t pos = out->size();
  out->resize(pos + 4);
  put_le32(out, pos, v);
}

// Encodes one c-blosc1 chunk (blosc-lz4, byte shuffle) — the same format
// rules as codecs.blosc_compress, decodable by real c-blosc/numcodecs.
int encode_blosc(const uint8_t* src, int64_t nbytes, int typesize,
                 std::vector<uint8_t>* out) {
  // The c-blosc1 format stores nbytes/cbytes/bstarts as int32: cells that
  // don't fit MUST be refused loudly (the Python mirror raises
  // struct.error) — truncating would write a silently-corrupt chunk.
  if (nbytes > INT32_MAX - 16) return E_SIZE;
  typesize = (typesize > 0 && typesize <= 255) ? typesize : 1;
  int32_t blocksize = nbytes ? choose_blocksize(nbytes, typesize) : 0;
  int nblocks = nbytes ? static_cast<int>((nbytes + blocksize - 1)
                                          / blocksize) : 0;
  bool do_shuffle = typesize > 1;
  bool split = typesize <= kMaxSplits && blocksize / typesize >= kMinBuffer;
  int flags = (1 << 5);  // lz4
  if (do_shuffle) flags |= 0x1;
  if (!split) flags |= 0x10;

  auto write_memcpy_chunk = [&]() {
    out->assign(16, 0);
    (*out)[0] = 2;
    (*out)[2] = 0x2;
    (*out)[3] = static_cast<uint8_t>(typesize);
    put_le32(out, 4, static_cast<int32_t>(nbytes));
    put_le32(out, 8, blocksize);
    put_le32(out, 12, static_cast<int32_t>(nbytes + 16));
    out->insert(out->end(), src, src + nbytes);
    return OK;
  };
  if (nbytes == 0) return write_memcpy_chunk();

  size_t header_size = 16 + 4 * nblocks;
  std::vector<uint8_t> body;
  body.reserve(nbytes / 2);
  std::vector<int32_t> bstarts(nblocks);
  std::vector<uint8_t> shuf(do_shuffle ? blocksize : 0);
  std::vector<uint8_t> comp(LZ4_compressBound(blocksize) + 8);
  for (int b = 0; b < nblocks; ++b) {
    int32_t bsize = static_cast<int32_t>(
        std::min<int64_t>(blocksize, nbytes - int64_t(b) * blocksize));
    const uint8_t* block = src + int64_t(b) * blocksize;
    if (do_shuffle) {
      shuffle_bytes(block, shuf.data(), bsize, typesize);
      block = shuf.data();
    }
    int nsplits = (split && bsize == blocksize) ? typesize : 1;
    int32_t neblock = bsize / nsplits;
    // Incompressible data can push header+body past int32 before the
    // final cbytes check; fall back to the (in-range) memcpy chunk.
    if (static_cast<int64_t>(header_size + body.size()) > INT32_MAX)
      return write_memcpy_chunk();
    bstarts[b] = static_cast<int32_t>(header_size + body.size());
    for (int s = 0; s < nsplits; ++s) {
      const uint8_t* sp = block + int64_t(s) * neblock;
      int csize = LZ4_compress_default(
          reinterpret_cast<const char*>(sp),
          reinterpret_cast<char*>(comp.data()), neblock,
          static_cast<int>(comp.size()));
      if (csize <= 0 || csize >= neblock) {  // stored stream
        append_le32(&body, neblock);
        body.insert(body.end(), sp, sp + neblock);
      } else {
        append_le32(&body, csize);
        body.insert(body.end(), comp.data(), comp.data() + csize);
      }
    }
  }
  int64_t cbytes = header_size + body.size();
  if (cbytes >= nbytes + 16) return write_memcpy_chunk();
  out->assign(16, 0);
  (*out)[0] = 2;
  (*out)[2] = static_cast<uint8_t>(flags);
  (*out)[3] = static_cast<uint8_t>(typesize);
  put_le32(out, 4, static_cast<int32_t>(nbytes));
  put_le32(out, 8, blocksize);
  put_le32(out, 12, static_cast<int32_t>(cbytes));
  for (int b = 0; b < nblocks; ++b) append_le32(out, bstarts[b]);
  out->insert(out->end(), body.begin(), body.end());
  return OK;
}

// "Use the codec default" sentinel for the level argument: explicit 0
// (zlib stored) and negative values (zstd fast levels) are valid user
// settings that must pass through, matching the Python codec path.
constexpr int kDefaultLevel = INT32_MIN;

int encode_one(const char* path, int codec, const uint8_t* src,
               int64_t nbytes, int typesize, int level) {
  std::vector<uint8_t> out;
  switch (codec) {
    case RAW:
      out.assign(src, src + nbytes);
      break;
    case ZLIB: {
      uLongf dst_n = compressBound(nbytes);
      out.resize(dst_n);
      if (compress2(out.data(), &dst_n, src, nbytes,
                    level == kDefaultLevel ? 1 : level) != Z_OK)
        return E_ENCODE;
      out.resize(dst_n);
      break;
    }
    case ZSTD: {
      size_t bound = ZSTD_compressBound(nbytes);
      out.resize(bound);
      size_t n = ZSTD_compress(out.data(), bound, src, nbytes,
                               level == kDefaultLevel ? 3 : level);
      if (ZSTD_isError(n)) return E_ENCODE;
      out.resize(n);
      break;
    }
    case BLOSC: {
      int rc = encode_blosc(src, nbytes, typesize, &out);
      if (rc != OK) return rc;
      break;
    }
    default:
      return E_UNSUPPORTED;
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return E_OPEN;
  size_t wrote = out.empty() ? 0 : std::fwrite(out.data(), 1, out.size(), f);
  int close_rc = std::fclose(f);
  return (wrote == out.size() && close_rc == 0) ? OK : E_WRITE;
}

}  // namespace

extern "C" {

// Encodes + writes n cells concurrently (inverse of wbx_decode_cells).
// Returns 0, or (index * 16 + errcode) + 1 of the first failing cell.
int wbx_encode_cells(int n, const char** paths, int codec,
                     const void** srcs, int64_t cell_nbytes, int typesize,
                     int level, int threads) {
  std::atomic<int> next(0);
  std::atomic<int> status(0);
  int nworkers = std::min(n, threads > 0 ? threads : 1);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || status.load() != 0) return;
      int rc = encode_one(paths[i], codec,
                          static_cast<const uint8_t*>(srcs[i]),
                          cell_nbytes, typesize, level);
      if (rc != OK) {
        int expect = 0;
        status.compare_exchange_strong(expect, i * 16 + rc + 1);
        return;
      }
    }
  };
  if (nworkers <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nworkers);
    for (int t = 0; t < nworkers; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return status.load();
}

// Decodes n cell files concurrently. paths[i] == nullptr marks a missing
// cell (skipped — caller pre-fills dests[i]). Returns 0, or the first
// failing cell's (index * 16 + errcode) + 1 packed for diagnostics.
int wbx_decode_cells(int n, const char** paths, int codec, void** dests,
                     int64_t cell_nbytes, int threads) {
  std::atomic<int> next(0);
  std::atomic<int> status(0);
  int nworkers = std::min(n, threads > 0 ? threads : 1);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || status.load() != 0) return;
      if (!paths[i]) continue;
      int rc = decode_one(paths[i], codec,
                          static_cast<uint8_t*>(dests[i]), cell_nbytes);
      if (rc != OK) {
        int expect = 0;
        status.compare_exchange_strong(expect, i * 16 + rc + 1);
        return;
      }
    }
  };
  if (nworkers <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nworkers);
    for (int t = 0; t < nworkers; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return status.load();
}

}  // extern "C"
