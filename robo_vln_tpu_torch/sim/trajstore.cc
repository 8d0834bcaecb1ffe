// Native trajectory store: the framework's LMDB replacement (the port's own
// copy of robo_vln_tpu/sim/trajstore.cc, built by sim/build.py).
//
// The reference buffers expert trajectories in LMDB (robo_vln_trainer.py:
// 199-239, 404-501) — ~1.5 TB of msgpack'd episodes read back with
// block-shuffled batched lookups.  This is a minimal, dependency-free
// key-value store tuned for that exact access pattern:
//
//   * append-only data log  (store.dat):  sequence of [u64 key][u64 len][payload]
//   * index sidecar         (store.idx):  sequence of [u64 key][u64 off][u64 len]
//
// Writers append + flush on commit; readers mmap the data log and serve
// zero-copy pointers.  Both files are plain little-endian so the pure-Python
// backend (data/trajectory_store.py) reads/writes the same format.
//
// C ABI (ctypes): ts_open / ts_put / ts_get_len / ts_get / ts_count /
// ts_flush / ts_close.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Entry {
  uint64_t off;
  uint64_t len;
};

struct Store {
  std::string dir;
  FILE* dat_w = nullptr;   // append handle (writable mode)
  FILE* idx_w = nullptr;
  int dat_fd = -1;         // read handle (mmap)
  uint8_t* map = nullptr;
  size_t map_len = 0;
  std::unordered_map<uint64_t, Entry> index;
  uint64_t dat_size = 0;
  bool writable = false;
};

bool load_index(Store* s) {
  std::string idx_path = s->dir + "/store.idx";
  FILE* f = fopen(idx_path.c_str(), "rb");
  if (!f) return true;  // empty store
  uint64_t rec[3];
  while (fread(rec, sizeof(uint64_t), 3, f) == 3) {
    s->index[rec[0]] = Entry{rec[1], rec[2]};
  }
  fclose(f);
  return true;
}

bool remap(Store* s) {
  if (s->map) {
    munmap(s->map, s->map_len);
    s->map = nullptr;
    s->map_len = 0;
  }
  struct stat st;
  if (fstat(s->dat_fd, &st) != 0) return false;
  if (st.st_size == 0) return true;
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, s->dat_fd, 0);
  if (p == MAP_FAILED) return false;
  s->map = static_cast<uint8_t*>(p);
  s->map_len = st.st_size;
  return true;
}

}  // namespace

extern "C" {

void* ts_open(const char* dir, int writable) {
  Store* s = new Store();
  s->dir = dir;
  s->writable = writable != 0;
  mkdir(dir, 0755);
  std::string dat_path = s->dir + "/store.dat";
  std::string idx_path = s->dir + "/store.idx";

  if (s->writable) {
    s->dat_w = fopen(dat_path.c_str(), "ab");
    s->idx_w = fopen(idx_path.c_str(), "ab");
    if (!s->dat_w || !s->idx_w) {
      delete s;
      return nullptr;
    }
  }
  // ensure the data file exists for the read path
  int fd = open(dat_path.c_str(), O_RDONLY | O_CREAT, 0644);
  if (fd < 0) {
    delete s;
    return nullptr;
  }
  s->dat_fd = fd;
  load_index(s);
  struct stat st;
  fstat(fd, &st);
  s->dat_size = st.st_size;
  if (!remap(s)) {
    close(fd);
    delete s;
    return nullptr;
  }
  return s;
}

int ts_put(void* handle, uint64_t key, const uint8_t* buf, uint64_t len) {
  Store* s = static_cast<Store*>(handle);
  if (!s->writable) return -1;
  uint64_t off = s->dat_size + 16;  // payload offset (after header)
  uint64_t hdr[2] = {key, len};
  if (fwrite(hdr, sizeof(uint64_t), 2, s->dat_w) != 2) return -2;
  if (len && fwrite(buf, 1, len, s->dat_w) != len) return -2;
  uint64_t rec[3] = {key, off, len};
  if (fwrite(rec, sizeof(uint64_t), 3, s->idx_w) != 3) return -2;
  s->dat_size += 16 + len;
  s->index[key] = Entry{off, len};
  return 0;
}

int64_t ts_get_len(void* handle, uint64_t key) {
  Store* s = static_cast<Store*>(handle);
  auto it = s->index.find(key);
  if (it == s->index.end()) return -1;
  return static_cast<int64_t>(it->second.len);
}

int ts_get(void* handle, uint64_t key, uint8_t* out, uint64_t out_len) {
  Store* s = static_cast<Store*>(handle);
  auto it = s->index.find(key);
  if (it == s->index.end()) return -1;
  const Entry& e = it->second;
  if (out_len < e.len) return -2;
  if (e.off + e.len > s->map_len) {
    // data written after last mmap; flush + remap
    if (s->dat_w) fflush(s->dat_w);
    if (!remap(s)) return -3;
    if (e.off + e.len > s->map_len) return -3;
  }
  memcpy(out, s->map + e.off, e.len);
  return 0;
}

uint64_t ts_count(void* handle) {
  return static_cast<Store*>(handle)->index.size();
}

int ts_flush(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (s->dat_w) fflush(s->dat_w);
  if (s->idx_w) fflush(s->idx_w);
  return remap(s) ? 0 : -1;
}

void ts_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (s->dat_w) fclose(s->dat_w);
  if (s->idx_w) fclose(s->idx_w);
  if (s->map) munmap(s->map, s->map_len);
  if (s->dat_fd >= 0) close(s->dat_fd);
  delete s;
}

}  // extern "C"
