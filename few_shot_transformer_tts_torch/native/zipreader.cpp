// Native zip reader for the packed mel store (mels.zip); the port's own copy
// of few_shot_transformer_tts_tpu/native/zipreader.cpp.
//
// The reference reads mels through Python's zipfile with a lock around every
// access (reference dataloader.py:19-22,413-416), serializing the feeder
// thread against the trainer.  This reader parses the central directory once
// (ZIP64-aware — packed datasets run to ~100 GB), then serves stored
// (uncompressed) entries with positioned pread calls: no seek state, no lock,
// no GIL (ctypes releases it for the duration of the call).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libzipreader.so zipreader.cpp
// (native/zipreader.py does it at first use).
//
// C ABI:
//   void* zr_open(const char* path)             NULL on failure
//   void  zr_close(void* h)
//   long  zr_size(void* h, const char* name)    uncompressed size, -1 missing,
//                                               -2 unsupported (not stored)
//   long  zr_read(void* h, const char* name, char* buf, long cap)
//                                               bytes read, or <0 as above
//   long  zr_count(void* h)
//   long  zr_names(void* h, char* buf, long cap) newline-joined entry names

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Entry {
  uint64_t header_offset;  // local file header position
  uint64_t comp_size;
  uint64_t uncomp_size;
  uint16_t method;         // 0 = stored, 8 = deflate
  uint64_t data_offset;    // resolved lazily (0 = unresolved)
};

struct Reader {
  int fd = -1;
  std::unordered_map<std::string, Entry> entries;
  std::vector<std::string> order;
};

uint16_t rd16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

bool pread_all(int fd, void* buf, size_t n, uint64_t off) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = pread(fd, p, n, off);
    if (r <= 0) return false;
    p += r;
    off += r;
    n -= r;
  }
  return true;
}

constexpr uint32_t kEOCD = 0x06054b50;
constexpr uint32_t kEOCD64Locator = 0x07064b50;
constexpr uint32_t kEOCD64 = 0x06064b50;
constexpr uint32_t kCentral = 0x02014b50;
constexpr uint32_t kLocal = 0x04034b50;

bool parse_central_directory(Reader* r, uint64_t file_size) {
  // find EOCD in the trailing 64 KB + 22 bytes
  const uint64_t tail_len =
      file_size < 65557 ? file_size : static_cast<uint64_t>(65557);
  std::vector<uint8_t> tail(tail_len);
  if (!pread_all(r->fd, tail.data(), tail_len, file_size - tail_len))
    return false;
  int64_t eocd_pos = -1;
  for (int64_t i = static_cast<int64_t>(tail_len) - 22; i >= 0; --i) {
    if (rd32(&tail[i]) == kEOCD) {
      eocd_pos = i;
      break;
    }
  }
  if (eocd_pos < 0) return false;
  const uint8_t* eocd = &tail[eocd_pos];
  uint64_t cd_count = rd16(eocd + 10);
  uint64_t cd_size = rd32(eocd + 12);
  uint64_t cd_offset = rd32(eocd + 16);

  // ZIP64: locator sits immediately before the EOCD
  uint64_t eocd_abs = file_size - tail_len + eocd_pos;
  if (cd_offset == 0xFFFFFFFFu || cd_count == 0xFFFFu ||
      cd_size == 0xFFFFFFFFu) {
    if (eocd_abs < 20) return false;
    uint8_t loc[20];
    if (!pread_all(r->fd, loc, 20, eocd_abs - 20)) return false;
    if (rd32(loc) != kEOCD64Locator) return false;
    uint64_t eocd64_off = rd64(loc + 8);
    uint8_t e64[56];
    if (!pread_all(r->fd, e64, 56, eocd64_off)) return false;
    if (rd32(e64) != kEOCD64) return false;
    cd_count = rd64(e64 + 32);
    cd_size = rd64(e64 + 40);
    cd_offset = rd64(e64 + 48);
  }

  std::vector<uint8_t> cd(cd_size);
  if (!pread_all(r->fd, cd.data(), cd_size, cd_offset)) return false;
  uint64_t pos = 0;
  r->entries.reserve(cd_count);
  for (uint64_t i = 0; i < cd_count; ++i) {
    if (pos + 46 > cd_size || rd32(&cd[pos]) != kCentral) return false;
    const uint8_t* h = &cd[pos];
    uint16_t method = rd16(h + 10);
    uint64_t comp = rd32(h + 20);
    uint64_t uncomp = rd32(h + 24);
    uint16_t name_len = rd16(h + 28);
    uint16_t extra_len = rd16(h + 30);
    uint16_t comment_len = rd16(h + 32);
    uint64_t header_off = rd32(h + 42);
    if (pos + 46 + name_len + extra_len + comment_len > cd_size) return false;
    std::string name(reinterpret_cast<const char*>(h + 46), name_len);
    // ZIP64 extra field (id 0x0001): order is uncomp, comp, header offset,
    // present only for fields that saturated
    const uint8_t* extra = h + 46 + name_len;
    uint64_t epos = 0;
    while (epos + 4 <= extra_len) {
      uint16_t id = rd16(extra + epos);
      uint16_t len = rd16(extra + epos + 2);
      if (id == 0x0001) {
        const uint8_t* f = extra + epos + 4;
        uint64_t fpos = 0;
        if (uncomp == 0xFFFFFFFFu && fpos + 8 <= len) {
          uncomp = rd64(f + fpos);
          fpos += 8;
        }
        if (comp == 0xFFFFFFFFu && fpos + 8 <= len) {
          comp = rd64(f + fpos);
          fpos += 8;
        }
        if (header_off == 0xFFFFFFFFu && fpos + 8 <= len) {
          header_off = rd64(f + fpos);
          fpos += 8;
        }
      }
      epos += 4 + len;
    }
    Entry e{header_off, comp, uncomp, method, 0};
    r->entries.emplace(name, e);
    r->order.push_back(std::move(name));
    pos += 46 + name_len + extra_len + comment_len;
  }
  return true;
}

// local header: resolve the payload offset (name/extra lengths can differ
// from the central copy)
bool resolve_data_offset(const Reader* r, Entry* e) {
  uint8_t lh[30];
  if (!pread_all(r->fd, lh, 30, e->header_offset)) return false;
  if (rd32(lh) != kLocal) return false;
  uint16_t name_len = rd16(lh + 26);
  uint16_t extra_len = rd16(lh + 28);
  e->data_offset = e->header_offset + 30 + name_len + extra_len;
  return true;
}

}  // namespace

extern "C" {

void* zr_open(const char* path) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 22) {
    close(fd);
    return nullptr;
  }
  Reader* r = new Reader();
  r->fd = fd;
  if (!parse_central_directory(r, static_cast<uint64_t>(st.st_size))) {
    close(fd);
    delete r;
    return nullptr;
  }
  return r;
}

void zr_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  if (!r) return;
  close(r->fd);
  delete r;
}

long zr_size(void* h, const char* name) {
  Reader* r = static_cast<Reader*>(h);
  auto it = r->entries.find(name);
  if (it == r->entries.end()) return -1;
  if (it->second.method != 0) return -2;
  return static_cast<long>(it->second.uncomp_size);
}

long zr_read(void* h, const char* name, char* buf, long cap) {
  Reader* r = static_cast<Reader*>(h);
  auto it = r->entries.find(name);
  if (it == r->entries.end()) return -1;
  Entry& e = it->second;
  if (e.method != 0) return -2;
  if (e.data_offset == 0 && !resolve_data_offset(r, &e)) return -3;
  long n = static_cast<long>(e.uncomp_size);
  if (n > cap) return -4;
  if (!pread_all(r->fd, buf, n, e.data_offset)) return -3;
  return n;
}

long zr_count(void* h) {
  return static_cast<long>(static_cast<Reader*>(h)->order.size());
}

long zr_names(void* h, char* buf, long cap) {
  Reader* r = static_cast<Reader*>(h);
  long pos = 0;
  for (const auto& n : r->order) {
    long need = static_cast<long>(n.size()) + 1;
    if (pos + need > cap) return -4;
    memcpy(buf + pos, n.data(), n.size());
    buf[pos + n.size()] = '\n';
    pos += need;
  }
  return pos;
}

}  // extern "C"
