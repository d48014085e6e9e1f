// Indexed TFRecord IO — the framework's native host-runtime component.
//
// The reference leans on TF1's C++ queue-runners for record IO (SURVEY.md
// section 2.2); the TPU-native replacement is a Grain pipeline, and Grain
// wants *random access*, which raw TFRecords (a stream format) cannot give.
// This library provides:
//   * tfr_build_index: one sequential scan of a TFRecord file emitting a
//     binary index of (offset, length) pairs;
//   * tfr_open/tfr_read/tfr_close: mmap'd index + pread-based record fetch,
//     thread-safe (no shared mutable state per read — safe from Grain's
//     worker threads/processes without locking);
//   * tfr_verify_crc toggle: masked CRC32C validation of record payloads
//     (same polynomial/masking as the TFRecord spec).
//
// TFRecord framing: { uint64 len | uint32 crc(len) | bytes[len] | uint32
// crc(bytes) }, little-endian, crc = masked crc32c.
//
// The PyTorch port's copy of the JAX package's native/tfrecord_index.cc.
// The index format is the same byte for byte (magic "TFRIDX01"), so both
// packages read each other's <file>.idx.  One entry point is added:
// tfr_masked_crc32c, which the port's record writers use for the framing
// CRCs (the pure-Python crc32c runs at a few MB/s).
//
// Build: at first use, with the host's C++ compiler (g++ -O3 -shared
// -fPIC), into attentionalpoolingaction_torch/_build/ (ops/_build.py).
// Python bindings: attentionalpoolingaction_torch/data/native_io.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <vector>

namespace {

constexpr uint64_t kIndexMagic = 0x5446524944583031ULL;  // "TFRIDX01"

uint32_t crc32c_table[8][256];
bool crc_table_init_done = false;

void InitCrcTable() {
  if (crc_table_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    crc32c_table[0][i] = c;
  }
  // slice-by-8 tables for speed
  for (int t = 1; t < 8; t++) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = crc32c_table[t - 1][i];
      crc32c_table[t][i] = crc32c_table[0][c & 0xff] ^ (c >> 8);
    }
  }
  crc_table_init_done = true;
}

uint32_t Crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, data, 4);
    memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = crc32c_table[7][lo & 0xff] ^ crc32c_table[6][(lo >> 8) & 0xff] ^
          crc32c_table[5][(lo >> 16) & 0xff] ^ crc32c_table[4][lo >> 24] ^
          crc32c_table[3][hi & 0xff] ^ crc32c_table[2][(hi >> 8) & 0xff] ^
          crc32c_table[1][(hi >> 16) & 0xff] ^ crc32c_table[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = crc32c_table[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t MaskedCrc(const uint8_t* data, size_t n) {
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

struct IndexEntry {
  uint64_t offset;  // offset of the payload (past the 12-byte header)
  uint64_t length;  // payload length
};

struct Reader {
  int data_fd = -1;
  const IndexEntry* entries = nullptr;  // mmap'd
  void* map_base = nullptr;
  size_t map_len = 0;
  int64_t count = 0;
  bool verify_crc = false;
};

}  // namespace

extern "C" {

// Scan a TFRecord file and write a binary index. Returns record count,
// or -1 (open/read failure) or -2 (corrupt framing / crc mismatch).
int64_t tfr_build_index(const char* tfrecord_path, const char* index_path,
                        int verify_crc) {
  InitCrcTable();
  FILE* in = fopen(tfrecord_path, "rb");
  if (!in) return -1;
  std::vector<IndexEntry> entries;
  std::vector<uint8_t> buf;
  uint64_t pos = 0;
  for (;;) {
    uint8_t header[12];
    size_t got = fread(header, 1, 12, in);
    if (got == 0) break;  // clean EOF
    if (got != 12) { fclose(in); return -2; }
    uint64_t len;
    uint32_t len_crc;
    memcpy(&len, header, 8);
    memcpy(&len_crc, header + 8, 4);
    if (MaskedCrc(header, 8) != len_crc) { fclose(in); return -2; }
    uint64_t payload_off = pos + 12;
    if (verify_crc) {
      buf.resize(len + 4);
      if (fread(buf.data(), 1, len + 4, in) != len + 4) {
        fclose(in);
        return -2;
      }
      uint32_t data_crc;
      memcpy(&data_crc, buf.data() + len, 4);
      if (MaskedCrc(buf.data(), len) != data_crc) { fclose(in); return -2; }
    } else {
      if (fseek(in, (long)(len + 4), SEEK_CUR) != 0) { fclose(in); return -2; }
    }
    entries.push_back({payload_off, len});
    pos = payload_off + len + 4;
  }
  fclose(in);

  FILE* out = fopen(index_path, "wb");
  if (!out) return -1;
  uint64_t magic = kIndexMagic;
  uint64_t n = entries.size();
  fwrite(&magic, 8, 1, out);
  fwrite(&n, 8, 1, out);
  fwrite(entries.data(), sizeof(IndexEntry), entries.size(), out);
  fclose(out);
  return (int64_t)entries.size();
}

// Open data + index. Returns an opaque handle or null.
void* tfr_open(const char* tfrecord_path, const char* index_path,
               int verify_crc) {
  InitCrcTable();
  int idx_fd = open(index_path, O_RDONLY);
  if (idx_fd < 0) return nullptr;
  struct stat st;
  if (fstat(idx_fd, &st) != 0 || (size_t)st.st_size < 16) {
    close(idx_fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, idx_fd, 0);
  close(idx_fd);
  if (base == MAP_FAILED) return nullptr;
  uint64_t magic, count;
  memcpy(&magic, base, 8);
  memcpy(&count, (uint8_t*)base + 8, 8);
  if (magic != kIndexMagic ||
      16 + count * sizeof(IndexEntry) > (uint64_t)st.st_size) {
    munmap(base, st.st_size);
    return nullptr;
  }
  int data_fd = open(tfrecord_path, O_RDONLY);
  if (data_fd < 0) {
    munmap(base, st.st_size);
    return nullptr;
  }
  Reader* r = new Reader();
  r->data_fd = data_fd;
  r->map_base = base;
  r->map_len = st.st_size;
  r->entries = (const IndexEntry*)((const uint8_t*)base + 16);
  r->count = (int64_t)count;
  r->verify_crc = verify_crc != 0;
  return r;
}

int64_t tfr_count(void* handle) {
  return handle ? ((Reader*)handle)->count : -1;
}

// Length of record i (so callers can size buffers), or -1.
int64_t tfr_record_length(void* handle, int64_t i) {
  Reader* r = (Reader*)handle;
  if (!r || i < 0 || i >= r->count) return -1;
  return (int64_t)r->entries[i].length;
}

// Read record i into buf (capacity cap). Returns bytes written, or
// -1 (bad args), -2 (io error), -3 (crc mismatch), or required size as
// -(4 + needed) if cap is too small... simpler: returns needed size if
// cap < needed (no write happens); callers compare to cap.
int64_t tfr_read(void* handle, int64_t i, uint8_t* buf, int64_t cap) {
  Reader* r = (Reader*)handle;
  if (!r || i < 0 || i >= r->count || !buf) return -1;
  const IndexEntry e = r->entries[i];
  if ((int64_t)e.length > cap) return (int64_t)e.length;
  int64_t off = 0;
  while (off < (int64_t)e.length) {
    ssize_t got = pread(r->data_fd, buf + off, e.length - off,
                        (off_t)(e.offset + off));
    if (got <= 0) return -2;
    off += got;
  }
  if (r->verify_crc) {
    uint8_t crc_buf[4];
    if (pread(r->data_fd, crc_buf, 4, (off_t)(e.offset + e.length)) != 4)
      return -2;
    uint32_t want;
    memcpy(&want, crc_buf, 4);
    if (MaskedCrc(buf, e.length) != want) return -3;
  }
  return (int64_t)e.length;
}

void tfr_close(void* handle) {
  Reader* r = (Reader*)handle;
  if (!r) return;
  if (r->data_fd >= 0) close(r->data_fd);
  if (r->map_base) munmap(r->map_base, r->map_len);
  delete r;
}

// TFRecord's masked CRC32C of n bytes (the framing's two checksums).
uint32_t tfr_masked_crc32c(const uint8_t* data, uint64_t n) {
  InitCrcTable();
  return MaskedCrc(data, n);
}

}  // extern "C"
