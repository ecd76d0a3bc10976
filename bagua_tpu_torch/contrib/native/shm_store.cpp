// Shared-memory key-value store (C ABI, loaded via ctypes).
//
// Native-runtime analog of the reference's redis-backed store
// (bagua/torch_api/contrib/utils/redis_store.py:46-137 bootstraps local redis
// servers as the host-side sample cache).  On a TPU host the same job —
// a cross-process KV cache shared by dataloader workers — is served by one
// POSIX shared-memory segment with a process-shared mutex, no external
// server process.
//
// Layout of the segment:
//   Header | slot table (open addressing, linear probing) | value arena
// Values are append-allocated from the arena; overwriting a key appends a
// new value and abandons the old bytes (clear() reclaims everything).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0xBA60A570u;

struct Header {
  uint64_t magic;
  uint64_t capacity_bytes;  // whole segment
  uint64_t n_slots;
  uint64_t arena_offset;    // from segment start
  uint64_t arena_size;
  std::atomic<uint64_t> arena_used;
  std::atomic<uint64_t> n_keys;
  pthread_mutex_t mutex;
};

struct Slot {
  uint64_t hash;      // 0 = empty
  uint64_t key_len;
  uint64_t val_offset;  // into arena
  uint64_t val_len;     // value bytes (key bytes precede value in arena)
};

uint64_t fnv1a(const uint8_t* data, uint64_t len) {
  uint64_t h = 1469598103934665603ull;
  for (uint64_t i = 0; i < len; ++i) {
    h ^= data[i];
    h *= 1099511628211ull;
  }
  return h ? h : 1;  // reserve 0 for "empty"
}

struct Store {
  int fd;
  uint8_t* base;
  uint64_t size;
  Header* header;
  Slot* slots;
  uint8_t* arena;
};

Slot* find_slot(Store* s, uint64_t hash, const uint8_t* key, uint64_t key_len,
                bool for_insert) {
  uint64_t n = s->header->n_slots;
  for (uint64_t probe = 0; probe < n; ++probe) {
    Slot* slot = &s->slots[(hash + probe) % n];
    if (slot->hash == 0) return for_insert ? slot : nullptr;
    if (slot->hash == hash && slot->key_len == key_len &&
        memcmp(s->arena + slot->val_offset - key_len, key, key_len) == 0)
      return slot;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Create or attach to a named shared-memory store. Returns handle or null.
// Creator election is via O_CREAT|O_EXCL: exactly one process initializes
// the segment and publishes the magic word LAST (release store); attachers
// spin until the magic appears, so they never observe a half-built header.
void* bagua_shm_store_open(const char* name, uint64_t capacity_bytes,
                           int create) {
  uint64_t n_slots = capacity_bytes / 256;  // ~256B/entry budget
  if (n_slots < 64) n_slots = 64;
  uint64_t meta = sizeof(Header) + n_slots * sizeof(Slot);
  if (capacity_bytes < meta + 4096) capacity_bytes = meta + 4096;

  bool creator = false;
  int fd = -1;
  if (create) {
    fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd >= 0) {
      creator = true;
    } else if (errno == EEXIST) {
      fd = shm_open(name, O_RDWR, 0600);
    }
  } else {
    fd = shm_open(name, O_RDWR, 0600);
  }
  if (fd < 0) return nullptr;

  if (creator) {
    if (ftruncate(fd, (off_t)capacity_bytes) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    // Wait for the creator to size the segment (~5s timeout).
    struct stat st;
    for (int i = 0; i < 5000; ++i) {
      if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
      if (st.st_size > 0) break;
      usleep(1000);
    }
    if (st.st_size == 0) { close(fd); return nullptr; }
    capacity_bytes = (uint64_t)st.st_size;
  }

  void* base = mmap(nullptr, capacity_bytes, PROT_READ | PROT_WRITE,
                    MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }

  Store* s = new Store();
  s->fd = fd;
  s->base = (uint8_t*)base;
  s->size = capacity_bytes;
  s->header = (Header*)base;

  if (creator) {
    Header* h = s->header;
    memset(h, 0, sizeof(Header));
    h->capacity_bytes = capacity_bytes;
    h->n_slots = n_slots;
    h->arena_offset = sizeof(Header) + n_slots * sizeof(Slot);
    h->arena_size = capacity_bytes - h->arena_offset;
    h->arena_used.store(0);
    h->n_keys.store(0);
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mutex, &attr);
    memset(s->base + sizeof(Header), 0, n_slots * sizeof(Slot));
    // Publish: init complete. Attachers spin on this.
    __atomic_store_n(&h->magic, kMagic, __ATOMIC_RELEASE);
  } else {
    // Spin until the creator publishes the magic (~5s timeout).
    bool ready = false;
    for (int i = 0; i < 5000; ++i) {
      if (__atomic_load_n(&s->header->magic, __ATOMIC_ACQUIRE) == kMagic) {
        ready = true;
        break;
      }
      usleep(1000);
    }
    if (!ready) {
      munmap(base, capacity_bytes);
      close(fd);
      delete s;
      return nullptr;
    }
  }
  s->slots = (Slot*)(s->base + sizeof(Header));
  s->arena = s->base + s->header->arena_offset;
  return s;
}

static int lock(Header* h) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) {  // previous owner died: state is still consistent
    pthread_mutex_consistent(&h->mutex);
    rc = 0;
  }
  return rc;
}

// Returns 0 on success, -1 on failure (full table / arena).
int bagua_shm_store_set(void* handle, const uint8_t* key, uint64_t key_len,
                        const uint8_t* val, uint64_t val_len) {
  Store* s = (Store*)handle;
  Header* h = s->header;
  uint64_t hash = fnv1a(key, key_len);
  if (lock(h) != 0) return -1;
  Slot* slot = find_slot(s, hash, key, key_len, /*for_insert=*/true);
  if (!slot) { pthread_mutex_unlock(&h->mutex); return -1; }
  uint64_t need = key_len + val_len;
  uint64_t used = h->arena_used.load();
  if (used + need > h->arena_size) { pthread_mutex_unlock(&h->mutex); return -1; }
  uint8_t* dst = s->arena + used;
  memcpy(dst, key, key_len);
  memcpy(dst + key_len, val, val_len);
  if (slot->hash == 0) h->n_keys.fetch_add(1);
  slot->hash = hash;
  slot->key_len = key_len;
  slot->val_offset = used + key_len;
  slot->val_len = val_len;
  h->arena_used.store(used + need);
  pthread_mutex_unlock(&h->mutex);
  return 0;
}

// Returns value length, or -1 if missing. If out_capacity >= value length,
// copies the value into out.
int64_t bagua_shm_store_get(void* handle, const uint8_t* key, uint64_t key_len,
                            uint8_t* out, uint64_t out_capacity) {
  Store* s = (Store*)handle;
  Header* h = s->header;
  uint64_t hash = fnv1a(key, key_len);
  if (lock(h) != 0) return -1;
  Slot* slot = find_slot(s, hash, key, key_len, /*for_insert=*/false);
  if (!slot) { pthread_mutex_unlock(&h->mutex); return -1; }
  int64_t len = (int64_t)slot->val_len;
  if ((uint64_t)len <= out_capacity && out != nullptr)
    memcpy(out, s->arena + slot->val_offset, slot->val_len);
  pthread_mutex_unlock(&h->mutex);
  return len;
}

uint64_t bagua_shm_store_num_keys(void* handle) {
  return ((Store*)handle)->header->n_keys.load();
}

void bagua_shm_store_clear(void* handle) {
  Store* s = (Store*)handle;
  Header* h = s->header;
  if (lock(h) != 0) return;
  memset(s->slots, 0, h->n_slots * sizeof(Slot));
  h->arena_used.store(0);
  h->n_keys.store(0);
  pthread_mutex_unlock(&h->mutex);
}

void bagua_shm_store_close(void* handle) {
  Store* s = (Store*)handle;
  munmap(s->base, s->size);
  close(s->fd);
  delete s;
}

void bagua_shm_store_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
