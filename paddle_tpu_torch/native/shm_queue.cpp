// Shared-memory ring of batches from DataLoader worker processes to the
// parent: a copy of paddle_tpu/native/shm_queue.cpp.
//
// Workers write collated numpy batches straight into a POSIX shared-memory
// ring (no pickle over a pipe); the parent maps the same ring and copies
// each slot's payload out.  Flow control is two process-shared semaphores
// (free slots / filled slots) and a robust mutex over the ring indices.
//
// C ABI, bound with ctypes (paddle_tpu_torch/native/__init__.py).
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <semaphore.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint64_t magic;
  uint32_t n_slots;
  uint64_t slot_size;
  uint32_t head;  // next slot to pop
  uint32_t tail;  // next slot to push
  pthread_mutex_t mu;
  sem_t free_slots;
  sem_t filled_slots;
};

struct Slot {
  uint64_t seq;
  uint64_t len;
  // payload follows
};

constexpr uint64_t kMagic = 0x707173686d71ULL;  // "pqshmq"

struct Handle {
  Header* hdr;
  size_t map_len;
  char name[256];
  bool owner;
};

char* slot_at(Header* h, uint32_t i) {
  return reinterpret_cast<char*>(h) + sizeof(Header) +
         static_cast<size_t>(i) * (sizeof(Slot) + h->slot_size);
}

}  // namespace

extern "C" {

// Create a new queue; returns an opaque handle or nullptr.
void* shmq_create(const char* name, uint64_t slot_size, uint32_t n_slots) {
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t len = sizeof(Header) + static_cast<size_t>(n_slots) * (sizeof(Slot) + slot_size);
  if (ftruncate(fd, static_cast<off_t>(len)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Header* h = static_cast<Header*>(mem);
  h->magic = kMagic;
  h->n_slots = n_slots;
  h->slot_size = slot_size;
  h->head = 0;
  h->tail = 0;
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  // a worker killed mid-push must not wedge the parent forever
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  sem_init(&h->free_slots, 1, n_slots);
  sem_init(&h->filled_slots, 1, 0);
  Handle* hd = new Handle{h, len, {0}, true};
  strncpy(hd->name, name, sizeof(hd->name) - 1);
  return hd;
}

// Open an existing queue (workers).
void* shmq_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(mem);
  if (h->magic != kMagic) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  Handle* hd = new Handle{h, static_cast<size_t>(st.st_size), {0}, false};
  strncpy(hd->name, name, sizeof(hd->name) - 1);
  return hd;
}

static int lock_robust(pthread_mutex_t* mu) {
  int rc = pthread_mutex_lock(mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  return rc;
}

// Push one payload (blocks while full; timeout_ms<0 -> wait forever).
// Returns 0 ok, 1 timeout, -1 payload larger than slot, -2 sem/lock failure.
int shmq_push(void* handle, const void* data, uint64_t len, uint64_t seq,
              int timeout_ms) {
  Handle* hd = static_cast<Handle*>(handle);
  Header* h = hd->hdr;
  if (len > h->slot_size) return -1;
  if (timeout_ms < 0) {
    while (sem_wait(&h->free_slots) != 0 && errno == EINTR) {}
  } else {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    ts.tv_sec += timeout_ms / 1000;
    ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
    ts.tv_sec += ts.tv_nsec / 1000000000L;
    ts.tv_nsec %= 1000000000L;
    while (sem_timedwait(&h->free_slots, &ts) != 0) {
      if (errno == ETIMEDOUT) return 1;
      if (errno != EINTR) return -2;
    }
  }
  if (lock_robust(&h->mu) != 0) return -2;
  uint32_t i = h->tail;
  h->tail = (h->tail + 1) % h->n_slots;
  Slot* s = reinterpret_cast<Slot*>(slot_at(h, i));
  s->seq = seq;
  s->len = len;
  memcpy(reinterpret_cast<char*>(s) + sizeof(Slot), data, len);
  pthread_mutex_unlock(&h->mu);
  sem_post(&h->filled_slots);
  return 0;
}

// Pop one payload into out (cap bytes). Returns payload length (>= 0 —
// empty payloads are valid), -3 on timeout, -1 on too-small buffer, -2 on
// sem/lock failure; seq written to *seq_out.
int64_t shmq_pop(void* handle, void* out, uint64_t cap, uint64_t* seq_out,
                 int timeout_ms) {
  Handle* hd = static_cast<Handle*>(handle);
  Header* h = hd->hdr;
  if (timeout_ms < 0) {
    while (sem_wait(&h->filled_slots) != 0 && errno == EINTR) {}
  } else {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    ts.tv_sec += timeout_ms / 1000;
    ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
    ts.tv_sec += ts.tv_nsec / 1000000000L;
    ts.tv_nsec %= 1000000000L;
    while (sem_timedwait(&h->filled_slots, &ts) != 0) {
      if (errno == ETIMEDOUT) return -3;
      if (errno != EINTR) return -2;
    }
  }
  if (lock_robust(&h->mu) != 0) return -2;
  Slot* s = reinterpret_cast<Slot*>(slot_at(h, h->head));
  uint64_t len = s->len;
  if (len > cap) {
    // head NOT advanced: the slot stays at the front for a retry with a
    // bigger buffer, and its filled token is returned
    pthread_mutex_unlock(&h->mu);
    sem_post(&h->filled_slots);
    return -1;
  }
  h->head = (h->head + 1) % h->n_slots;
  *seq_out = s->seq;
  memcpy(out, reinterpret_cast<char*>(s) + sizeof(Slot), len);
  pthread_mutex_unlock(&h->mu);
  sem_post(&h->free_slots);
  return static_cast<int64_t>(len);
}

uint64_t shmq_slot_size(void* handle) {
  return static_cast<Handle*>(handle)->hdr->slot_size;
}

void shmq_close(void* handle) {
  Handle* hd = static_cast<Handle*>(handle);
  bool owner = hd->owner;
  char name[256];
  strncpy(name, hd->name, sizeof(name));
  munmap(hd->hdr, hd->map_len);
  if (owner) shm_unlink(name);
  delete hd;
}

}  // extern "C"
