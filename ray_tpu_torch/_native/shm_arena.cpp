// Shared-memory arena object store — the native data plane of the
// per-node object store (role of the reference's plasma store:
// src/ray/object_manager/plasma/{store.h,object_store.h,dlmalloc.cc},
// redesigned: one mmap'd arena + object index in shared memory so every
// local process resolves objects with NO rpc and NO copy).
//
// Layout of the arena file (in /dev/shm):
//   [Header | Entry table | free-list array | data region ...]
//
// Concurrency: one process-shared robust pthread mutex guards the index
// + allocator (plasma serializes through its store thread instead; a
// mutex keeps readers out of the store's event loop entirely).  Object
// payload reads happen outside the lock: an entry's (offset,size) is
// immutable once sealed, and eviction cannot reclaim an entry whose
// refcount > 0.
//
// Build: g++ -O3 -shared -fPIC shm_arena.cpp -o libshm_arena.so
// Python binding: ctypes (ray_tpu_torch/_native/arena.py).

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52415954505542ULL;  // "RAYTPUB" (v2: populated_end)

// Kernels < 5.14 lack the define; on them madvise returns EINVAL and
// writers fall back to paying their own first-touch faults.
#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23
#endif
constexpr uint32_t kIdSize = 32;

enum EntryState : uint32_t {
  kEmpty = 0,
  kAllocated = 1,
  kSealed = 2,
  kTombstone = 3,  // deleted slot, probe chain continues through it
};

struct Entry {
  uint8_t id[kIdSize];
  uint64_t offset;
  uint64_t size;
  uint32_t state;
  uint32_t refcount;
  uint64_t last_access;  // monotonic ns, for LRU eviction
  uint32_t owner_pid;    // creator pid (crash cleanup)
  // 1 while the creator still holds its alloc-time reference; cleared by
  // arena_release_create, or reclaimed when owner_pid is dead.
  uint32_t creator_ref;
};

struct FreeBlock {
  uint64_t offset;
  uint64_t size;
};

struct Header {
  uint64_t magic;
  uint64_t file_size;
  uint64_t data_start;
  uint64_t data_capacity;
  uint64_t used;
  uint64_t bump;  // high-water mark within data region
  // Pages below this data-region offset are known physically populated
  // (background prefault thread or populate-on-alloc).  Writes above it
  // would page-fault per 4K; arena_alloc populates the gap in one
  // MADV_POPULATE_WRITE batch instead (~3-4x faster than touch-faulting
  // a cold 256 MB put — see PERF_ANALYSIS.md).
  uint64_t populated_end;
  uint32_t table_cap;
  uint32_t free_cap;
  uint32_t free_count;
  uint32_t num_objects;
  uint64_t num_evictions;
  pthread_mutex_t mutex;
};

struct Arena {
  int fd;
  uint8_t* base;
  Header* hdr;
  Entry* table;
  FreeBlock* freelist;
};

inline uint64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}

inline uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 32-byte id
  uint64_t h = 1469598103934665603ull;
  for (uint32_t i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ull;
  }
  return h;
}

// Rebuild allocator metadata from the entry table after a client died
// holding the mutex (EOWNERDEAD): a half-written Entry or half-moved
// free list cannot be trusted.  Sealed entries are ground truth — their
// (offset,size) are immutable after seal — so everything else is
// recomputed from them.  kAllocated entries whose owner process is GONE
// are dropped (their payload is garbage); kAllocated entries of LIVE
// writers keep both their entry and their byte range — recycling a
// range a live client is still memcpy-ing into would corrupt whoever
// allocates it next.  The free list becomes the gaps between kept
// blocks, and used/bump/num_objects are recounted.  Refcounts leaked by
// the dead client are left in place (a live reader may hold them); they
// only pin objects.
void repair_after_owner_death(Arena* a) {
  Header* h = a->hdr;
  struct Blk {
    uint64_t off, size;
  };
  Blk* blks = new Blk[h->table_cap];
  uint32_t n = 0;
  uint32_t live = 0;
  uint64_t used = 0;
  for (uint32_t i = 0; i < h->table_cap; i++) {
    Entry* e = &a->table[i];
    if (e->state == kAllocated) {
      bool owner_alive =
          e->owner_pid != 0 && (kill(pid_t(e->owner_pid), 0) == 0 || errno != ESRCH);
      // Age bound guards against PID reuse / EPERM false-positives: a
      // live writer allocs and seals within seconds, so a kAllocated
      // entry older than 5 minutes is a leak, not an in-flight write.
      bool stale = now_ns() - e->last_access > 300ull * 1000000000ull;
      if (!owner_alive || stale) {
        e->state = kTombstone;
        e->refcount = 0;
        continue;
      }
    }
    if (e->state == kSealed && e->refcount > 0 && e->creator_ref &&
        e->owner_pid != 0 && kill(pid_t(e->owner_pid), 0) != 0 && errno == ESRCH) {
      // Creator died between seal and release: reclaim its reference.
      e->creator_ref = 0;
      e->refcount--;
    }
    if (e->state == kAllocated || e->state == kSealed) {
      blks[n++] = {e->offset, (e->size + 63) & ~63ull};
      used += e->size;
      live++;
    }
  }
  qsort(blks, n, sizeof(Blk), [](const void* x, const void* y) {
    uint64_t ox = ((const Blk*)x)->off, oy = ((const Blk*)y)->off;
    return ox < oy ? -1 : (ox > oy ? 1 : 0);
  });
  h->free_count = 0;
  uint64_t cursor = 0;
  for (uint32_t i = 0; i < n; i++) {
    if (blks[i].off > cursor && h->free_count < h->free_cap) {
      a->freelist[h->free_count].offset = cursor;
      a->freelist[h->free_count].size = blks[i].off - cursor;
      h->free_count++;
    }
    uint64_t end = blks[i].off + blks[i].size;
    if (end > cursor) cursor = end;
  }
  h->bump = cursor;
  h->used = used;
  h->num_objects = live;
  delete[] blks;
}

class Lock {
 public:
  explicit Lock(Arena* a) : a_(a) {
    int rc = pthread_mutex_lock(&a_->hdr->mutex);
    if (rc == EOWNERDEAD) {
      // A client died holding the lock: repair the index/allocator from
      // the sealed entries before trusting any of it.
      repair_after_owner_death(a_);
      pthread_mutex_consistent(&a_->hdr->mutex);
    }
  }
  ~Lock() { pthread_mutex_unlock(&a_->hdr->mutex); }

 private:
  Arena* a_;
};

// Find the entry for id, or the first insertable slot (nullptr if full).
Entry* find_entry(Arena* a, const uint8_t* id, bool for_insert) {
  Header* h = a->hdr;
  uint64_t idx = hash_id(id) % h->table_cap;
  Entry* insert_slot = nullptr;
  for (uint32_t probe = 0; probe < h->table_cap; probe++) {
    Entry* e = &a->table[(idx + probe) % h->table_cap];
    if (e->state == kEmpty) {
      if (for_insert) return insert_slot ? insert_slot : e;
      return nullptr;
    }
    if (e->state == kTombstone) {
      if (insert_slot == nullptr) insert_slot = e;
      continue;
    }
    if (memcmp(e->id, id, kIdSize) == 0) return e;
  }
  return for_insert ? insert_slot : nullptr;
}

// first-fit over the sorted free list, else bump
int64_t alloc_space(Arena* a, uint64_t size) {
  Header* h = a->hdr;
  size = (size + 63) & ~63ull;  // 64B alignment
  for (uint32_t i = 0; i < h->free_count; i++) {
    if (a->freelist[i].size >= size) {
      uint64_t off = a->freelist[i].offset;
      a->freelist[i].offset += size;
      a->freelist[i].size -= size;
      if (a->freelist[i].size == 0) {
        memmove(&a->freelist[i], &a->freelist[i + 1],
                (h->free_count - i - 1) * sizeof(FreeBlock));
        h->free_count--;
      }
      return int64_t(off);
    }
  }
  if (h->bump + size <= h->data_capacity) {
    uint64_t off = h->bump;
    h->bump += size;
    return int64_t(off);
  }
  return -1;
}

void free_space(Arena* a, uint64_t offset, uint64_t size) {
  Header* h = a->hdr;
  size = (size + 63) & ~63ull;
  // insert sorted by offset, coalescing with neighbours
  uint32_t pos = 0;
  while (pos < h->free_count && a->freelist[pos].offset < offset) pos++;
  bool merged = false;
  if (pos > 0 && a->freelist[pos - 1].offset + a->freelist[pos - 1].size == offset) {
    a->freelist[pos - 1].size += size;
    offset = a->freelist[pos - 1].offset;
    size = a->freelist[pos - 1].size;
    pos--;
    merged = true;
  }
  if (pos + 1 <= h->free_count && pos < h->free_count && !merged &&
      offset + size == a->freelist[pos].offset) {
    a->freelist[pos].offset = offset;
    a->freelist[pos].size += size;
    merged = true;
  } else if (merged && pos + 1 < h->free_count &&
             offset + size == a->freelist[pos + 1].offset) {
    a->freelist[pos].size += a->freelist[pos + 1].size;
    memmove(&a->freelist[pos + 1], &a->freelist[pos + 2],
            (h->free_count - pos - 2) * sizeof(FreeBlock));
    h->free_count--;
  }
  if (!merged) {
    if (h->free_count >= h->free_cap) {
      // free-list full: leak the block (reclaimed when neighbours free)
      return;
    }
    memmove(&a->freelist[pos + 1], &a->freelist[pos],
            (h->free_count - pos) * sizeof(FreeBlock));
    a->freelist[pos].offset = offset;
    a->freelist[pos].size = size;
    h->free_count++;
  }
  // trailing block touching the bump pointer collapses back into it
  while (h->free_count > 0) {
    FreeBlock* last = &a->freelist[h->free_count - 1];
    if (last->offset + last->size == h->bump) {
      h->bump = last->offset;
      h->free_count--;
    } else {
      break;
    }
  }
}

void delete_entry_locked(Arena* a, Entry* e) {
  free_space(a, e->offset, e->size);
  a->hdr->used -= e->size;
  a->hdr->num_objects--;
  e->state = kTombstone;
  e->refcount = 0;
}

}  // namespace

extern "C" {

// returns handle or nullptr
void* arena_create(const char* path, uint64_t data_capacity, uint32_t table_cap,
                   uint32_t free_cap) {
  uint64_t meta = sizeof(Header) + uint64_t(table_cap) * sizeof(Entry) +
                  uint64_t(free_cap) * sizeof(FreeBlock);
  meta = (meta + 4095) & ~4095ull;
  uint64_t file_size = meta + data_capacity;
  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, off_t(file_size)) != 0) {
    close(fd);
    unlink(path);
    return nullptr;
  }
  uint8_t* base = (uint8_t*)mmap(nullptr, file_size, PROT_READ | PROT_WRITE,
                                 MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    unlink(path);
    return nullptr;
  }
  Header* h = (Header*)base;
  memset(h, 0, sizeof(Header));
  h->file_size = file_size;
  h->data_start = meta;
  h->data_capacity = data_capacity;
  h->table_cap = table_cap;
  h->free_cap = free_cap;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);
  pthread_mutexattr_destroy(&attr);

  Arena* a = new Arena();
  a->fd = fd;
  a->base = base;
  a->hdr = h;
  a->table = (Entry*)(base + sizeof(Header));
  a->freelist = (FreeBlock*)(base + sizeof(Header) + uint64_t(table_cap) * sizeof(Entry));
  h->magic = kMagic;  // written last: attachers spin on it
  return a;
}

void* arena_attach(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  uint8_t* base = (uint8_t*)mmap(nullptr, size_t(st.st_size),
                                 PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Header* h = (Header*)base;
  if (h->magic != kMagic || h->file_size != uint64_t(st.st_size)) {
    munmap(base, size_t(st.st_size));
    close(fd);
    return nullptr;
  }
  Arena* a = new Arena();
  a->fd = fd;
  a->base = base;
  a->hdr = h;
  a->table = (Entry*)(base + sizeof(Header));
  a->freelist =
      (FreeBlock*)(base + sizeof(Header) + uint64_t(h->table_cap) * sizeof(Entry));
  return a;
}

void arena_close(void* handle) {
  Arena* a = (Arena*)handle;
  if (!a) return;
  munmap(a->base, size_t(a->hdr->file_size));
  close(a->fd);
  delete a;
}

uint8_t* arena_base(void* handle) {
  Arena* a = (Arena*)handle;
  return a->base + a->hdr->data_start;
}

// Allocate space for an object. Returns data-region offset, -1 if no
// space, -2 if the id already exists.
int64_t arena_alloc(void* handle, const uint8_t* id, uint64_t size) {
  Arena* a = (Arena*)handle;
  uint64_t pop_off = 0, pop_len = 0;
  int64_t off;
  {
    Lock l(a);
    Entry* e = find_entry(a, id, /*for_insert=*/false);
    if (e != nullptr) return -2;
    e = find_entry(a, id, /*for_insert=*/true);
    if (e == nullptr) return -1;  // table full
    off = alloc_space(a, size);
    if (off < 0) return -1;
    memcpy(e->id, id, kIdSize);
    e->offset = uint64_t(off);
    e->size = size;
    e->state = kAllocated;
    // Creator reference: the writer holds one ref from alloc until its
    // registration with the store completes (plasma's create semantics).
    // Without it, LRU eviction can reclaim a just-sealed slot before the
    // raylet records it, silently dropping the object.
    e->refcount = 1;
    e->creator_ref = 1;
    e->owner_pid = uint32_t(getpid());
    e->last_access = now_ns();
    a->hdr->used += size;
    a->hdr->num_objects++;
    // populate-on-alloc: claim the unpopulated tail of this block now,
    // madvise AFTER the lock drops (populating 256 MB takes tens of ms —
    // too long to hold the robust mutex; double-populate on a race is
    // harmless, a missed write-fault is not)
    uint64_t end = uint64_t(off) + size;
    if (end > a->hdr->populated_end) {
      pop_off = a->hdr->populated_end;
      pop_len = end - pop_off;
      a->hdr->populated_end = end;
    }
  }
  if (pop_len) {
    uint64_t pstart = pop_off & ~4095ull;
    uint64_t plen = ((pop_off + pop_len + 4095) & ~4095ull) - pstart;
    madvise(a->base + a->hdr->data_start + pstart, plen, MADV_POPULATE_WRITE);
  }
  return off;
}

int arena_seal(void* handle, const uint8_t* id) {
  Arena* a = (Arena*)handle;
  Lock l(a);
  Entry* e = find_entry(a, id, false);
  if (e == nullptr || e->state != kAllocated) return -1;
  e->state = kSealed;
  e->last_access = now_ns();
  return 0;
}

// Lookup a sealed object; bumps refcount (caller must arena_decref).
// Returns offset, or -1 if absent/unsealed.
int64_t arena_lookup(void* handle, const uint8_t* id, uint64_t* size_out) {
  Arena* a = (Arena*)handle;
  Lock l(a);
  Entry* e = find_entry(a, id, false);
  if (e == nullptr || e->state != kSealed) return -1;
  e->refcount++;
  e->last_access = now_ns();
  if (size_out) *size_out = e->size;
  return int64_t(e->offset);
}

int arena_contains(void* handle, const uint8_t* id) {
  Arena* a = (Arena*)handle;
  Lock l(a);
  Entry* e = find_entry(a, id, false);
  return (e != nullptr && e->state == kSealed) ? 1 : 0;
}

int arena_decref(void* handle, const uint8_t* id) {
  Arena* a = (Arena*)handle;
  Lock l(a);
  Entry* e = find_entry(a, id, false);
  if (e == nullptr || e->state == kEmpty || e->state == kTombstone) return -1;
  if (e->refcount > 0) e->refcount--;
  return 0;
}

// Drop the creator's alloc-time reference (after the raylet registered
// the object).  Idempotent.
int arena_release_create(void* handle, const uint8_t* id) {
  Arena* a = (Arena*)handle;
  Lock l(a);
  Entry* e = find_entry(a, id, false);
  if (e == nullptr || e->state == kEmpty || e->state == kTombstone) return -1;
  if (e->creator_ref) {
    e->creator_ref = 0;
    if (e->refcount > 0) e->refcount--;
  }
  return 0;
}

namespace {
// A creator that died before arena_release_create leaks one reference;
// reclaim it so the slot stays evictable/deletable.
void maybe_reap_dead_creator(Entry* e) {
  if (e->creator_ref && e->owner_pid != 0 &&
      kill(pid_t(e->owner_pid), 0) != 0 && errno == ESRCH) {
    e->creator_ref = 0;
    if (e->refcount > 0) e->refcount--;
  }
}
}  // namespace

// Delete if refcount == 0. Returns 0 on success, -1 busy/absent.
int arena_delete(void* handle, const uint8_t* id) {
  Arena* a = (Arena*)handle;
  Lock l(a);
  Entry* e = find_entry(a, id, false);
  if (e == nullptr || e->state == kEmpty || e->state == kTombstone) return -1;
  if (e->refcount > 0) maybe_reap_dead_creator(e);
  if (e->refcount > 0) return -1;
  delete_entry_locked(a, e);
  return 0;
}

namespace {
// A contiguous block of `need` bytes exists (free list or bump headroom).
bool can_fit_contiguous(Arena* a, uint64_t need) {
  Header* h = a->hdr;
  if (h->data_capacity - h->bump >= need) return true;
  for (uint32_t i = 0; i < h->free_count; i++) {
    if (a->freelist[i].size >= need) return true;
  }
  return false;
}
}  // namespace

// A contiguous block of `need` bytes is currently allocatable.
int arena_can_fit(void* handle, uint64_t need) {
  Arena* a = (Arena*)handle;
  Lock l(a);
  return can_fit_contiguous(a, (need + 63) & ~63ull) ? 1 : 0;
}

// Evict LRU sealed, unreferenced objects until a CONTIGUOUS block of
// `need` bytes exists (total-bytes-freed is not enough: LRU frees old low
// offsets while the bump pointer sits high — coalescing via free_space
// plus this criterion guarantees the next alloc succeeds).
// Writes up to max_out evicted ids into out_ids (32B each).  Returns the
// number evicted THIS call (callers loop: stop when arena_can_fit, give
// up on -1 = nothing evictable), so every evicted id is reported even
// when more than max_out evictions are needed.
// One table scan per call (not per victim): candidates are collected,
// sorted by last_access, then evicted in order.
int arena_evict_lru(void* handle, uint64_t need, uint8_t* out_ids, int max_out) {
  Arena* a = (Arena*)handle;
  Lock l(a);
  Header* h = a->hdr;
  need = (need + 63) & ~63ull;
  if (can_fit_contiguous(a, need)) return 0;

  struct Cand {
    uint64_t last_access;
    uint32_t index;
  };
  Cand* cands = new Cand[h->table_cap];
  uint32_t n_cand = 0;
  for (uint32_t i = 0; i < h->table_cap; i++) {
    Entry* e = &a->table[i];
    if (e->state == kSealed && e->refcount > 0) maybe_reap_dead_creator(e);
    if (e->state == kSealed && e->refcount == 0) {
      cands[n_cand++] = {e->last_access, i};
    }
  }
  if (n_cand == 0) {
    delete[] cands;
    return -1;
  }
  // insertion-free ordering: simple qsort by last_access ascending
  qsort(cands, n_cand, sizeof(Cand), [](const void* x, const void* y) {
    uint64_t lx = ((const Cand*)x)->last_access, ly = ((const Cand*)y)->last_access;
    return lx < ly ? -1 : (lx > ly ? 1 : 0);
  });
  int n_evicted = 0;
  for (uint32_t c = 0; c < n_cand && n_evicted < max_out; c++) {
    if (can_fit_contiguous(a, need)) break;
    Entry* e = &a->table[cands[c].index];
    if (out_ids != nullptr) {
      memcpy(out_ids + n_evicted * kIdSize, e->id, kIdSize);
    }
    delete_entry_locked(a, e);
    h->num_evictions++;
    n_evicted++;
  }
  delete[] cands;
  if (n_evicted == 0 && !can_fit_contiguous(a, need)) return -1;
  return n_evicted;
}

// Test-only: acquire the arena mutex and return WITHOUT unlocking, so a
// test can exit the process "inside" the critical section and exercise
// the EOWNERDEAD repair path in the next locker.
int arena_test_lock_and_abandon(void* handle) {
  Arena* a = (Arena*)handle;
  int rc = pthread_mutex_lock(&a->hdr->mutex);
  if (rc == EOWNERDEAD) {
    repair_after_owner_death(a);
    pthread_mutex_consistent(&a->hdr->mutex);
  }
  return 0;
}

// Fault every data page in up front so puts never pay first-touch cost
// (~4x memcpy slowdown on tmpfs) — the same reason plasma pre-allocates
// its pool.  MADV_POPULATE_WRITE makes the kernel allocate + write-map
// the pages WITHOUT touching their contents, so it cannot race client
// writes into freshly allocated slots (a manual read-modify-write sweep
// would be a data race that can revert a racing client's byte).  On
// kernels without it (< 5.14) we simply skip: puts fall back to paying
// their own faults, which is the pre-prefault behavior.
// Populate [off, off+len) of the data region; returns 0 on success.
// The caller (Python, trickling in a background thread) bounds the
// range and paces the calls — a raw full-capacity sweep would both
// saturate the memory bus at startup and make the entire arena
// resident at once (capacity × raylets on a multi-raylet box).
int arena_prefault_range(void* handle, uint64_t off, uint64_t len) {
  Arena* a = (Arena*)handle;
  uint64_t cap = a->hdr->data_capacity;
  if (off >= cap) return 0;
  if (len > cap - off) len = cap - off;
  int rc = madvise(a->base + a->hdr->data_start + off, len, MADV_POPULATE_WRITE);
  if (rc == 0) {
    // advance the populate-on-alloc watermark so allocs under it skip
    // their own madvise (benign unlocked max: double-populate is safe)
    uint64_t end = off + len;
    if (end > a->hdr->populated_end) a->hdr->populated_end = end;
  }
  return rc;
}

uint64_t arena_used(void* handle) { return ((Arena*)handle)->hdr->used; }
uint64_t arena_data_capacity(void* handle) {
  return ((Arena*)handle)->hdr->data_capacity;
}
uint32_t arena_num_objects(void* handle) {
  return ((Arena*)handle)->hdr->num_objects;
}
uint64_t arena_num_evictions(void* handle) {
  return ((Arena*)handle)->hdr->num_evictions;
}

}  // extern "C"
