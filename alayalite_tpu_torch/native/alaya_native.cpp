// Native host runtime for alayalite_tpu_torch (a copy of the JAX package's
// alaya_native.cpp; the code below is the same).
//
// Host-side counterparts of the reference's C++ runtime layers:
//   - vecs loader: mmap + parallel header-stripping copy of fvecs/ivecs/bvecs
//     files (reference: include/utils/io_utils.hpp:40-80 reads one record at
//     a time through ifstream). Fills numpy buffers.
//   - aligned arena: 2MB-aligned allocation pool for host staging buffers
//     (reference: include/utils/memory.hpp AlignedAlloc/alloc_2m).
//   - batch queue: the serving path's replacement for the coroutine
//     Scheduler/Worker/TaskQueue stack (include/executor/): concurrent
//     clients push single queries; a dispatcher thread pops a coalesced
//     batch and searches it as one device batch. Condvar-based with a
//     max-wait so latency is bounded; one memcpy per query is ~100ns for
//     128-d f32.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- vecs IO

// Probe an (f|i|b)vecs file: record = i32 dim header + dim*elem_size payload.
// Returns 0 on success and fills n/dim; -1 open error, -2 corrupt.
int al_vecs_probe(const char* path, int elem_size, int64_t* out_n,
                  int64_t* out_dim) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  int32_t dim = 0;
  if (read(fd, &dim, 4) != 4 || dim <= 0) {
    close(fd);
    if (st.st_size == 0) { *out_n = 0; *out_dim = 0; return 0; }
    return -2;
  }
  close(fd);
  const int64_t record = 4 + int64_t(dim) * elem_size;
  if (st.st_size % record != 0) return -2;
  *out_n = st.st_size / record;
  *out_dim = dim;
  return 0;
}

// Copy payloads of rows [0, n) into dst (contiguous, n*dim*elem_size bytes),
// stripping the per-record dim headers, with `threads` parallel strips.
int al_vecs_load(const char* path, int elem_size, int64_t n, int64_t dim,
                 void* dst, int threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  fstat(fd, &st);
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -1;
  const int64_t record = 4 + dim * elem_size;
  const int64_t row_bytes = dim * elem_size;
  if (threads < 1) threads = 1;
  std::vector<std::thread> pool;
  const int64_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      const char* src = static_cast<const char*>(base);
      char* out = static_cast<char*>(dst);
      for (int64_t i = lo; i < hi; ++i) {
        std::memcpy(out + i * row_bytes, src + i * record + 4, row_bytes);
      }
    });
  }
  for (auto& th : pool) th.join();
  munmap(base, st.st_size);
  return 0;
}

// ------------------------------------------------------------ aligned arena

struct AlArena {
  std::vector<void*> blocks;
  std::mutex mu;
};

void* al_arena_create() { return new AlArena(); }

void* al_arena_alloc(void* arena_, int64_t bytes, int64_t align) {
  auto* arena = static_cast<AlArena*>(arena_);
  if (align < 64) align = 64;
  void* p = nullptr;
  if (posix_memalign(&p, size_t(align), size_t(bytes)) != 0) return nullptr;
  std::lock_guard<std::mutex> g(arena->mu);
  arena->blocks.push_back(p);
  return p;
}

void al_arena_destroy(void* arena_) {
  auto* arena = static_cast<AlArena*>(arena_);
  for (void* p : arena->blocks) free(p);
  delete arena;
}

// -------------------------------------------------------------- batch queue

struct AlBatchQueue {
  int dim;
  int max_batch;
  int64_t timeout_us;
  std::vector<float> buf;      // ring of query vectors [capacity, dim]
  std::vector<int64_t> tickets;  // request ids, same ring
  int capacity;
  int head = 0, tail = 0, count = 0;
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
};

void* al_bq_create(int capacity, int dim, int max_batch, int64_t timeout_us) {
  auto* q = new AlBatchQueue();
  q->dim = dim;
  q->max_batch = max_batch;
  q->timeout_us = timeout_us;
  q->capacity = capacity;
  q->buf.resize(size_t(capacity) * dim);
  q->tickets.resize(capacity);
  return q;
}

// Push one query; blocks while full. Returns 0, or -1 if closed.
int al_bq_push(void* q_, int64_t ticket, const float* vec) {
  auto* q = static_cast<AlBatchQueue*>(q_);
  std::unique_lock<std::mutex> lk(q->mu);
  q->cv_push.wait(lk, [&] { return q->count < q->capacity || q->closed; });
  if (q->closed) return -1;
  std::memcpy(&q->buf[size_t(q->tail) * q->dim], vec,
              sizeof(float) * q->dim);
  q->tickets[q->tail] = ticket;
  q->tail = (q->tail + 1) % q->capacity;
  q->count += 1;
  lk.unlock();
  q->cv_pop.notify_one();
  return 0;
}

// Pop a coalesced batch: waits until at least one query is present, then up
// to timeout_us more for the batch to fill (bounded latency). Returns the
// number of queries written to out/out_tickets; 0 on close.
int al_bq_pop_batch(void* q_, float* out, int64_t* out_tickets) {
  auto* q = static_cast<AlBatchQueue*>(q_);
  std::unique_lock<std::mutex> lk(q->mu);
  q->cv_pop.wait(lk, [&] { return q->count > 0 || q->closed; });
  if (q->count == 0 && q->closed) return 0;
  if (q->count < q->max_batch && q->timeout_us > 0) {
    q->cv_pop.wait_for(lk, std::chrono::microseconds(q->timeout_us),
                       [&] { return q->count >= q->max_batch || q->closed; });
  }
  int take = q->count < q->max_batch ? q->count : q->max_batch;
  for (int i = 0; i < take; ++i) {
    std::memcpy(out + size_t(i) * q->dim,
                &q->buf[size_t(q->head) * q->dim], sizeof(float) * q->dim);
    out_tickets[i] = q->tickets[q->head];
    q->head = (q->head + 1) % q->capacity;
  }
  q->count -= take;
  lk.unlock();
  q->cv_push.notify_all();
  return take;
}

int al_bq_size(void* q_) {
  auto* q = static_cast<AlBatchQueue*>(q_);
  std::lock_guard<std::mutex> g(q->mu);
  return q->count;
}

void al_bq_close(void* q_) {
  auto* q = static_cast<AlBatchQueue*>(q_);
  {
    std::lock_guard<std::mutex> g(q->mu);
    q->closed = true;
  }
  q->cv_pop.notify_all();
  q->cv_push.notify_all();
}

void al_bq_destroy(void* q_) { delete static_cast<AlBatchQueue*>(q_); }

}  // extern "C"
