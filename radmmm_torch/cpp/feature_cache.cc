// Memory-mapped feature cache: the native replacement for the reference's
// LMDB caches (data.py:218-222, 264-269). Append-only writer + mmap'd
// zero-copy reader with a sorted-hash index, safe for concurrent readers
// across dataloader threads/processes.
//
// The port's own copy of the JAX package's cpp/feature_cache.cc, with the
// same on-disk format byte for byte, so that a cache written by either
// package is read by the other.
//
// File layout:
//   <path>.dat : records, each [u32 key_len][key bytes][payload bytes]
//   <path>.idx : header [u64 magic][u64 count], then count entries of
//                [u64 hash][u64 offset][u64 total_len] sorted by hash.
//
// C API (ctypes-friendly), thread-safe for readers.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52414443414348ULL;  // "RADCACH"

uint64_t fnv1a(const char* data, size_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

struct IndexEntry {
  uint64_t hash;
  uint64_t offset;
  uint64_t total_len;
};

struct Writer {
  FILE* dat = nullptr;
  std::string base;
  std::vector<IndexEntry> entries;
  uint64_t offset = 0;
};

struct Reader {
  int fd = -1;
  const char* data = nullptr;
  size_t data_size = 0;
  std::vector<IndexEntry> entries;
};

}  // namespace

extern "C" {

void* cache_writer_open(const char* path) {
  auto* w = new Writer();
  w->base = path;
  w->dat = std::fopen((w->base + ".dat").c_str(), "wb");
  if (!w->dat) {
    delete w;
    return nullptr;
  }
  return w;
}

int cache_writer_put(void* handle, const char* key, const void* data,
                     uint64_t len) {
  auto* w = static_cast<Writer*>(handle);
  uint32_t key_len = static_cast<uint32_t>(std::strlen(key));
  uint64_t total = sizeof(uint32_t) + key_len + len;
  if (std::fwrite(&key_len, sizeof(uint32_t), 1, w->dat) != 1) return -1;
  if (std::fwrite(key, 1, key_len, w->dat) != key_len) return -1;
  if (len && std::fwrite(data, 1, len, w->dat) != len) return -1;
  w->entries.push_back({fnv1a(key, key_len), w->offset, total});
  w->offset += total;
  return 0;
}

int cache_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  std::fclose(w->dat);
  std::sort(w->entries.begin(), w->entries.end(),
            [](const IndexEntry& a, const IndexEntry& b) {
              return a.hash < b.hash ||
                     (a.hash == b.hash && a.offset < b.offset);
            });
  FILE* idx = std::fopen((w->base + ".idx").c_str(), "wb");
  if (!idx) {
    delete w;
    return -1;
  }
  uint64_t count = w->entries.size();
  std::fwrite(&kMagic, sizeof(uint64_t), 1, idx);
  std::fwrite(&count, sizeof(uint64_t), 1, idx);
  std::fwrite(w->entries.data(), sizeof(IndexEntry), count, idx);
  std::fclose(idx);
  delete w;
  return 0;
}

void* cache_open(const char* path) {
  auto* r = new Reader();
  std::string base(path);
  FILE* idx = std::fopen((base + ".idx").c_str(), "rb");
  if (!idx) {
    delete r;
    return nullptr;
  }
  uint64_t magic = 0, count = 0;
  if (std::fread(&magic, sizeof(uint64_t), 1, idx) != 1 ||
      magic != kMagic || std::fread(&count, sizeof(uint64_t), 1, idx) != 1) {
    std::fclose(idx);
    delete r;
    return nullptr;
  }
  r->entries.resize(count);
  if (count && std::fread(r->entries.data(), sizeof(IndexEntry), count,
                          idx) != count) {
    std::fclose(idx);
    delete r;
    return nullptr;
  }
  std::fclose(idx);

  r->fd = ::open((base + ".dat").c_str(), O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  fstat(r->fd, &st);
  r->data_size = static_cast<size_t>(st.st_size);
  r->data = static_cast<const char*>(
      mmap(nullptr, r->data_size, PROT_READ, MAP_SHARED, r->fd, 0));
  if (r->data == MAP_FAILED) {
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  return r;
}

uint64_t cache_count(void* handle) {
  return static_cast<Reader*>(handle)->entries.size();
}

// Returns pointer to payload and sets *out_len; nullptr if missing.
const void* cache_get(void* handle, const char* key, uint64_t* out_len) {
  auto* r = static_cast<Reader*>(handle);
  uint32_t key_len = static_cast<uint32_t>(std::strlen(key));
  uint64_t h = fnv1a(key, key_len);
  auto it = std::lower_bound(
      r->entries.begin(), r->entries.end(), h,
      [](const IndexEntry& e, uint64_t hash) { return e.hash < hash; });
  for (; it != r->entries.end() && it->hash == h; ++it) {
    const char* rec = r->data + it->offset;
    uint32_t klen;
    std::memcpy(&klen, rec, sizeof(uint32_t));
    if (klen == key_len &&
        std::memcmp(rec + sizeof(uint32_t), key, klen) == 0) {
      *out_len = it->total_len - sizeof(uint32_t) - klen;
      return rec + sizeof(uint32_t) + klen;
    }
  }
  *out_len = 0;
  return nullptr;
}

void cache_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r->data && r->data != MAP_FAILED)
    munmap(const_cast<char*>(r->data), r->data_size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

}  // extern "C"
