// ArrayRecord container IO: the riegeli block and chunk layer that the
// JAX package's ArrayRecord files are made of, without riegeli or
// array_record (the card's machine has neither).
//
// A riegeli file is a sequence of 64 KiB blocks.  Each block begins with a
// 24-byte block header { u64 header_hash, u64 previous_chunk, u64
// next_chunk }: the distance from the chunk that the block boundary
// interrupts back to its beginning (0 when a chunk begins at the boundary)
// and forward to its end.  Chunks run across block boundaries; a chunk is a
// 40-byte header { u64 header_hash, u64 data_size, u64 data_hash, u8
// chunk_type | u56 num_records, u64 decoded_data_size } followed by
// data_size bytes of data, with a block header wherever a boundary falls
// inside.  A chunk of n records spans at least n bytes (zeros after the
// data), so that every record has a distinct position.  Every hash is
// HighwayHash-64 keyed with "Riegeli/records\n" twice: a block header
// hashes its other 16 bytes, a chunk header its other 32, data_hash the
// chunk's data without the block headers inside it.
//
// This library holds:
//   * ar_highway_hash: HighwayHash-64 (the portable reference algorithm)
//     with the riegeli key;
//   * ar_open / ar_chunk_header / ar_chunk_data / ar_close: a chunk reader
//     over pread, so that reader threads may call it at once on one handle,
//     which steps over block headers, checks every header hash, and the data
//     hash when asked;
//   * ar_writer_open / ar_write_chunk / ar_pad_to_block_boundary /
//     ar_writer_close: a chunk writer that inserts the block headers and
//     computes all three hashes.
// What a chunk's data means (the simple-chunk encoding, zstd, the
// ArrayRecord footer and postscript) is decoded in Python:
// data/array_record.py.
//
// Build: at first use, with the host's C++ compiler, into
// attentionalpoolingaction_torch/_build/ (ops/_build.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <vector>

namespace {

constexpr uint64_t kBlockSize = uint64_t{1} << 16;
constexpr uint64_t kBlockHeaderSize = 24;
constexpr uint64_t kChunkHeaderSize = 40;

// Error codes (ar_error_string gives their text).
constexpr int kErrArgs = -1;
constexpr int kErrIo = -2;
constexpr int kErrTruncated = -3;
constexpr int kErrBlockHash = -4;
constexpr int kErrChunkHash = -5;
constexpr int kErrDataHash = -6;
constexpr int kErrBlockLinks = -7;

// -- HighwayHash-64 -------------------------------------------------------

struct HHState {
  uint64_t v0[4], v1[4], mul0[4], mul1[4];
};

// "Riegeli/records\n" twice, as four little-endian words.
constexpr uint64_t kRiegeliKey[4] = {0x2f696c6567656952ULL,
                                     0x0a7364726f636572ULL,
                                     0x2f696c6567656952ULL,
                                     0x0a7364726f636572ULL};

void HHReset(const uint64_t key[4], HHState* s) {
  s->mul0[0] = 0xdbe6d5d5fe4cce2fULL;
  s->mul0[1] = 0xa4093822299f31d0ULL;
  s->mul0[2] = 0x13198a2e03707344ULL;
  s->mul0[3] = 0x243f6a8885a308d3ULL;
  s->mul1[0] = 0x3bd39e10cb0ef593ULL;
  s->mul1[1] = 0xc0acf169b5f18a8cULL;
  s->mul1[2] = 0xbe5466cf34e90c6cULL;
  s->mul1[3] = 0x452821e638d01377ULL;
  for (int i = 0; i < 4; ++i) {
    s->v0[i] = s->mul0[i] ^ key[i];
    s->v1[i] = s->mul1[i] ^ ((key[i] >> 32) | (key[i] << 32));
  }
}

void ZipperMergeAndAdd(uint64_t v1, uint64_t v0, uint64_t* add1,
                       uint64_t* add0) {
  *add0 += (((v0 & 0xff000000ULL) | (v1 & 0xff00000000ULL)) >> 24) |
           (((v0 & 0xff0000000000ULL) | (v1 & 0xff000000000000ULL)) >> 16) |
           (v0 & 0xff0000ULL) | ((v0 & 0xff00ULL) << 32) |
           ((v1 & 0xff00000000000000ULL) >> 8) | (v0 << 56);
  *add1 += (((v1 & 0xff000000ULL) | (v0 & 0xff00000000ULL)) >> 24) |
           (v1 & 0xff0000ULL) | ((v1 & 0xff0000000000ULL) >> 16) |
           ((v1 & 0xff00ULL) << 24) | ((v0 & 0xff000000000000ULL) >> 8) |
           ((v1 & 0xffULL) << 48) | (v0 & 0xff00000000000000ULL);
}

void HHUpdate(const uint64_t lanes[4], HHState* s) {
  for (int i = 0; i < 4; ++i) {
    s->v1[i] += s->mul0[i] + lanes[i];
    s->mul0[i] ^= (s->v1[i] & 0xffffffffULL) * (s->v0[i] >> 32);
    s->v0[i] += s->mul1[i];
    s->mul1[i] ^= (s->v0[i] & 0xffffffffULL) * (s->v1[i] >> 32);
  }
  ZipperMergeAndAdd(s->v1[1], s->v1[0], &s->v0[1], &s->v0[0]);
  ZipperMergeAndAdd(s->v1[3], s->v1[2], &s->v0[3], &s->v0[2]);
  ZipperMergeAndAdd(s->v0[1], s->v0[0], &s->v1[1], &s->v1[0]);
  ZipperMergeAndAdd(s->v0[3], s->v0[2], &s->v1[3], &s->v1[2]);
}

uint64_t Load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);  // little-endian host (x86-64, aarch64)
  return v;
}

void HHUpdatePacket(const uint8_t* packet, HHState* s) {
  const uint64_t lanes[4] = {Load64(packet), Load64(packet + 8),
                             Load64(packet + 16), Load64(packet + 24)};
  HHUpdate(lanes, s);
}

void Rotate32By(uint64_t count, uint64_t lanes[4]) {
  for (int i = 0; i < 4; ++i) {
    const uint32_t half0 = static_cast<uint32_t>(lanes[i]);
    const uint32_t half1 = static_cast<uint32_t>(lanes[i] >> 32);
    lanes[i] = static_cast<uint32_t>((half0 << count) | (half0 >> (32 - count)));
    lanes[i] |= static_cast<uint64_t>(static_cast<uint32_t>(
                    (half1 << count) | (half1 >> (32 - count))))
                << 32;
  }
}

// The last size_mod32 (1..31) bytes.
void HHUpdateRemainder(const uint8_t* bytes, uint64_t size_mod32,
                       HHState* s) {
  const uint64_t size_mod4 = size_mod32 & 3;
  const uint8_t* remainder = bytes + (size_mod32 & ~uint64_t{3});
  uint8_t packet[32] = {0};
  for (int i = 0; i < 4; ++i) s->v0[i] += (size_mod32 << 32) + size_mod32;
  Rotate32By(size_mod32, s->v1);
  memcpy(packet, bytes, remainder - bytes);
  if (size_mod32 & 16) {
    for (int i = 0; i < 4; ++i) packet[28 + i] = remainder[i + size_mod4 - 4];
  } else if (size_mod4) {
    packet[16 + 0] = remainder[0];
    packet[16 + 1] = remainder[size_mod4 >> 1];
    packet[16 + 2] = remainder[size_mod4 - 1];
  }
  HHUpdatePacket(packet, s);
}

uint64_t HHFinalize64(HHState* s) {
  for (int n = 0; n < 4; ++n) {
    const uint64_t permuted[4] = {(s->v0[2] >> 32) | (s->v0[2] << 32),
                                  (s->v0[3] >> 32) | (s->v0[3] << 32),
                                  (s->v0[0] >> 32) | (s->v0[0] << 32),
                                  (s->v0[1] >> 32) | (s->v0[1] << 32)};
    HHUpdate(permuted, s);
  }
  return s->v0[0] + s->v1[0] + s->mul0[0] + s->mul1[0];
}

uint64_t RiegeliHash(const uint8_t* data, uint64_t size) {
  HHState s;
  HHReset(kRiegeliKey, &s);
  uint64_t i = 0;
  for (; i + 32 <= size; i += 32) HHUpdatePacket(data + i, &s);
  if (size & 31) HHUpdateRemainder(data + i, size & 31, &s);
  return HHFinalize64(&s);
}

// -- positions ------------------------------------------------------------

uint64_t RemainingInBlock(uint64_t pos) {
  return (kBlockSize - pos % kBlockSize) % kBlockSize;
}

// The position after `length` bytes of chunk written from `pos`, counting
// the block headers inserted on the way.
uint64_t AddWithOverhead(uint64_t pos, uint64_t length) {
  while (length > 0) {
    if (pos % kBlockSize == 0) pos += kBlockHeaderSize;
    const uint64_t take = std::min(length, RemainingInBlock(pos));
    pos += take;
    length -= take;
  }
  return pos;
}

// A chunk may begin at a block boundary or after a block header, never
// inside one.
uint64_t RoundUpToPossibleChunkBoundary(uint64_t pos) {
  const uint64_t in_block = pos % kBlockSize;
  return in_block != 0 && in_block < kBlockHeaderSize
             ? pos - in_block + kBlockHeaderSize
             : pos;
}

uint64_t ChunkEnd(uint64_t chunk_begin, uint64_t data_size,
                  uint64_t num_records) {
  return std::max(
      AddWithOverhead(chunk_begin, kChunkHeaderSize + data_size),
      RoundUpToPossibleChunkBoundary(chunk_begin + num_records));
}

// -- reader ---------------------------------------------------------------

struct Reader {
  int fd = -1;
  uint64_t size = 0;
};

int PreadFull(int fd, uint8_t* out, uint64_t n, uint64_t pos,
              uint64_t file_size) {
  if (pos + n > file_size) return kErrTruncated;
  uint64_t done = 0;
  while (done < n) {
    const ssize_t got = pread(fd, out + done, n - done, (off_t)(pos + done));
    if (got < 0) return kErrIo;
    if (got == 0) return kErrTruncated;
    done += (uint64_t)got;
  }
  return 0;
}

// Reads n bytes of a chunk beginning at chunk_begin, starting at file
// position *pos: block headers on the way are checked (their hash, and
// that they point back at chunk_begin) and skipped.  Advances *pos.
int ReadChunkBytes(const Reader* r, uint64_t chunk_begin, uint64_t* pos,
                   uint8_t* out, uint64_t n) {
  while (n > 0) {
    if (*pos % kBlockSize == 0) {
      uint8_t bh[kBlockHeaderSize];
      int rc = PreadFull(r->fd, bh, kBlockHeaderSize, *pos, r->size);
      if (rc) return rc;
      if (RiegeliHash(bh + 8, 16) != Load64(bh)) return kErrBlockHash;
      const uint64_t previous_chunk = Load64(bh + 8);
      if (previous_chunk != *pos - chunk_begin) return kErrBlockLinks;
      *pos += kBlockHeaderSize;
    }
    const uint64_t take = std::min(n, RemainingInBlock(*pos));
    int rc = PreadFull(r->fd, out, take, *pos, r->size);
    if (rc) return rc;
    *pos += take;
    out += take;
    n -= take;
  }
  return 0;
}

}  // namespace

extern "C" {

uint64_t ar_highway_hash(const uint8_t* data, uint64_t size) {
  return RiegeliHash(data, size);
}

const char* ar_error_string(int code) {
  switch (code) {
    case kErrArgs: return "bad arguments";
    case kErrIo: return "read or write failed";
    case kErrTruncated: return "truncated file";
    case kErrBlockHash: return "block header hash mismatch";
    case kErrChunkHash: return "chunk header hash mismatch";
    case kErrDataHash: return "chunk data hash mismatch";
    case kErrBlockLinks:
      return "block header does not point at the chunk it interrupts";
    default: return "unknown error";
  }
}

// Opens a file for reading; null if it cannot be opened.
void* ar_open(const char* path) {
  const int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  Reader* r = new Reader();
  r->fd = fd;
  r->size = (uint64_t)st.st_size;
  return r;
}

int64_t ar_size(void* handle) {
  return handle ? (int64_t)((Reader*)handle)->size : kErrArgs;
}

// Reads and checks the header of the chunk beginning at chunk_begin.
// info[6] = { data_size, data_hash, chunk_type, num_records,
// decoded_data_size, chunk_end }.  Returns 0 or an error code.
int ar_chunk_header(void* handle, uint64_t chunk_begin, uint64_t* info) {
  const Reader* r = (const Reader*)handle;
  if (!r || !info) return kErrArgs;
  if (RoundUpToPossibleChunkBoundary(chunk_begin) != chunk_begin)
    return kErrArgs;
  uint8_t h[kChunkHeaderSize];
  uint64_t pos = chunk_begin;
  int rc = ReadChunkBytes(r, chunk_begin, &pos, h, kChunkHeaderSize);
  if (rc) return rc;
  if (RiegeliHash(h + 8, 32) != Load64(h)) return kErrChunkHash;
  const uint64_t data_size = Load64(h + 8);
  const uint64_t type_and_records = Load64(h + 24);
  info[0] = data_size;
  info[1] = Load64(h + 16);
  info[2] = type_and_records & 0xff;
  info[3] = type_and_records >> 8;
  info[4] = Load64(h + 32);
  info[5] = ChunkEnd(chunk_begin, data_size, info[3]);
  return 0;
}

// Reads the data_size bytes of data of the chunk beginning at chunk_begin
// into out, and checks them against data_hash when verify is set.
int ar_chunk_data(void* handle, uint64_t chunk_begin, uint64_t data_size,
                  uint64_t data_hash, int verify, uint8_t* out) {
  const Reader* r = (const Reader*)handle;
  if (!r || (!out && data_size)) return kErrArgs;
  const uint64_t data_begin = AddWithOverhead(chunk_begin, kChunkHeaderSize);
  if (data_begin + data_size > r->size) return kErrTruncated;
  uint64_t pos = data_begin;
  int rc = ReadChunkBytes(r, chunk_begin, &pos, out, data_size);
  if (rc) return rc;
  if (verify && RiegeliHash(out, data_size) != data_hash) return kErrDataHash;
  return 0;
}

void ar_close(void* handle) {
  Reader* r = (Reader*)handle;
  if (!r) return;
  if (r->fd >= 0) close(r->fd);
  delete r;
}

}  // extern "C"

// -- writer ---------------------------------------------------------------

namespace {

struct Writer {
  FILE* f = nullptr;
  uint64_t pos = 0;
  bool failed = false;
  // the chunk being written, for the block headers inside it
  uint64_t chunk_begin = 0, chunk_end = 0;
};

void PutRaw(Writer* w, const uint8_t* p, uint64_t n) {
  if (n && fwrite(p, 1, n, w->f) != n) w->failed = true;
  w->pos += n;
}

// Appends n bytes of the current chunk (zeros when p is null), with a
// block header at every boundary on the way.
void Put(Writer* w, const uint8_t* p, uint64_t n) {
  static const uint8_t kZeros[4096] = {0};
  while (n > 0) {
    if (w->pos % kBlockSize == 0) {
      uint8_t bh[kBlockHeaderSize];
      const uint64_t previous_chunk = w->pos - w->chunk_begin;
      const uint64_t next_chunk = w->chunk_end - w->pos;
      memcpy(bh + 8, &previous_chunk, 8);
      memcpy(bh + 16, &next_chunk, 8);
      const uint64_t hash = RiegeliHash(bh + 8, 16);
      memcpy(bh, &hash, 8);
      PutRaw(w, bh, kBlockHeaderSize);
    }
    uint64_t take = std::min(n, RemainingInBlock(w->pos));
    if (!p) take = std::min<uint64_t>(take, sizeof(kZeros));
    PutRaw(w, p ? p : kZeros, take);
    if (p) p += take;
    n -= take;
  }
}

void WriteChunk(Writer* w, int chunk_type, uint64_t num_records,
                uint64_t decoded_data_size, const uint8_t* data,
                uint64_t data_size, uint64_t data_hash) {
  uint8_t h[kChunkHeaderSize];
  const uint64_t type_and_records =
      (uint64_t)(uint8_t)chunk_type | (num_records << 8);
  memcpy(h + 8, &data_size, 8);
  memcpy(h + 16, &data_hash, 8);
  memcpy(h + 24, &type_and_records, 8);
  memcpy(h + 32, &decoded_data_size, 8);
  const uint64_t header_hash = RiegeliHash(h + 8, 32);
  memcpy(h, &header_hash, 8);
  w->chunk_begin = w->pos;
  w->chunk_end = ChunkEnd(w->pos, data_size, num_records);
  Put(w, h, kChunkHeaderSize);
  Put(w, data, data_size);  // null data: zeros
  Put(w, nullptr, w->chunk_end - w->pos);
}

}  // namespace

extern "C" {

// Creates (truncates) a file for writing; null if it cannot.
void* ar_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  return w;
}

// Appends one chunk.  Returns the position where it begins, or an error.
int64_t ar_write_chunk(void* handle, int chunk_type, uint64_t num_records,
                       uint64_t decoded_data_size, const uint8_t* data,
                       uint64_t data_size) {
  Writer* w = (Writer*)handle;
  if (!w || (!data && data_size) || num_records >> 56) return kErrArgs;
  const uint64_t begin = w->pos;
  WriteChunk(w, chunk_type, num_records, decoded_data_size, data, data_size,
             RiegeliHash(data, data_size));
  return w->failed ? kErrIo : (int64_t)begin;
}

// Appends a padding chunk ('p', zeros) that ends at the next block
// boundary (one block further when fewer bytes than a chunk header are
// left in this one).  Returns the new position, or an error.
int64_t ar_pad_to_block_boundary(void* handle) {
  Writer* w = (Writer*)handle;
  if (!w) return kErrArgs;
  uint64_t length = RemainingInBlock(w->pos);
  if (length == 0) return (int64_t)w->pos;
  if (length < kChunkHeaderSize) length += kBlockSize;
  // a block header falls inside when the chunk runs into the next block
  const uint64_t data_size = length - kChunkHeaderSize -
                             (length > kBlockSize ? kBlockHeaderSize : 0);
  std::vector<uint8_t> zeros(data_size, 0);
  WriteChunk(w, 'p', 0, 0, nullptr, data_size,
             RiegeliHash(zeros.data(), data_size));
  return w->failed ? kErrIo : (int64_t)w->pos;
}

// Flushes and closes the file.  Returns 0, or an error if any write failed.
int ar_writer_close(void* handle) {
  Writer* w = (Writer*)handle;
  if (!w) return kErrArgs;
  bool failed = w->failed;
  if (fclose(w->f) != 0) failed = true;
  delete w;
  return failed ? kErrIo : 0;
}

}  // extern "C"
