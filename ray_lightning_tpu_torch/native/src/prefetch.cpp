// Native input-pipeline runtime: threaded batch gather + background
// prefetch.
//
// Role in the framework: the host-side data path that feeds the card.  A
// copy of the JAX package's runtime (ray_lightning_tpu/native/src/
// prefetch.cpp), a small dependency-free C++ core driven through ctypes
// (ray_lightning_tpu_torch/native/__init__.py); host code, not a kernel.
//
// Contract (mirrors the Python DataLoader's semantics exactly):
//   - the caller computes the epoch's index order in Python (so shuffle /
//     shard order is bit-identical to the pure-Python path across
//     processes) and hands it to rlt_prefetcher_start;
//   - a producer thread assembles batches ahead of consumption into a
//     ring of caller-owned slot buffers (double/triple buffering), using
//     a row-gather that fans out across threads for large batches;
//   - the consumer pops slots FIFO; a yielded slot stays valid until the
//     caller releases it (release-on-next-iteration in the Python
//     wrapper).
//
// Everything is C ABI so ctypes can bind it without pybind11.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct SourceArray {
  const char* data;
  int64_t row_bytes;
};

constexpr int kFree = 0;
constexpr int kReady = 1;

// Gather rows src[idx[r]] -> dst[r] for one array, splitting the row
// range across threads when the copy is big enough to amortize spawn.
void gather_rows(const SourceArray& src, const int64_t* idx, int64_t nrows,
                 char* dst, int n_threads) {
  const int64_t rb = src.row_bytes;
  auto copy_range = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      std::memcpy(dst + r * rb, src.data + idx[r] * rb,
                  static_cast<size_t>(rb));
    }
  };
  const int64_t total = nrows * rb;
  if (n_threads <= 1 || total < (1 << 20) || nrows < n_threads) {
    copy_range(0, nrows);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads - 1);
  const int64_t chunk = (nrows + n_threads - 1) / n_threads;
  for (int t = 1; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    if (lo >= nrows) break;
    const int64_t hi = std::min<int64_t>(nrows, lo + chunk);
    pool.emplace_back(copy_range, lo, hi);
  }
  copy_range(0, std::min<int64_t>(nrows, chunk));
  for (auto& th : pool) th.join();
}

struct Prefetcher {
  std::vector<SourceArray> arrays;
  // slots[s][a] = destination buffer for array a in ring slot s
  std::vector<std::vector<char*>> slots;
  int queue_depth = 2;
  int n_threads = 1;

  // epoch state
  std::vector<int64_t> indices;
  int64_t batch_size = 0;
  int64_t n_batches = 0;
  bool running = false;

  std::mutex mu;
  std::condition_variable cv_free;   // producer waits for a free slot
  std::condition_variable cv_ready;  // consumer waits for a ready slot
  std::vector<int> slot_state;
  std::vector<int64_t> slot_rows;
  int64_t produced = 0;  // batches produced
  int64_t consumed = 0;  // batches handed to the consumer
  std::atomic<bool> stop_flag{false};
  std::thread producer;

  void join_producer() {
    if (producer.joinable()) producer.join();
    running = false;
  }

  void produce_loop() {
    for (int64_t b = 0; b < n_batches && !stop_flag.load(); ++b) {
      const int slot = static_cast<int>(b % queue_depth);
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return slot_state[slot] == kFree || stop_flag.load();
        });
        if (stop_flag.load()) return;
      }
      const int64_t lo = b * batch_size;
      const int64_t nrows =
          std::min<int64_t>(batch_size, (int64_t)indices.size() - lo);
      const int64_t* idx = indices.data() + lo;
      for (size_t a = 0; a < arrays.size(); ++a) {
        gather_rows(arrays[a], idx, nrows, slots[slot][a], n_threads);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        slot_rows[slot] = nrows;
        slot_state[slot] = kReady;
        ++produced;
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

Prefetcher* rlt_prefetcher_create(int n_arrays, int queue_depth,
                                  int n_threads) {
  auto* p = new Prefetcher();
  p->arrays.resize(static_cast<size_t>(n_arrays));
  p->queue_depth = queue_depth > 0 ? queue_depth : 2;
  p->n_threads = n_threads > 0 ? n_threads : 1;
  p->slots.assign(static_cast<size_t>(p->queue_depth),
                  std::vector<char*>(static_cast<size_t>(n_arrays), nullptr));
  p->slot_state.assign(static_cast<size_t>(p->queue_depth), kFree);
  p->slot_rows.assign(static_cast<size_t>(p->queue_depth), 0);
  return p;
}

void rlt_prefetcher_set_array(Prefetcher* p, int i, const void* data,
                              int64_t row_bytes) {
  p->arrays[static_cast<size_t>(i)] = {static_cast<const char*>(data),
                                       row_bytes};
}

void rlt_prefetcher_set_slot(Prefetcher* p, int slot, int i, void* dst) {
  p->slots[static_cast<size_t>(slot)][static_cast<size_t>(i)] =
      static_cast<char*>(dst);
}

// Begin an epoch: the caller's index order (already shuffled/sharded in
// Python) is copied internally; a producer thread starts filling slots.
void rlt_prefetcher_start(Prefetcher* p, const int64_t* indices, int64_t n,
                          int64_t batch_size, int drop_last) {
  p->join_producer();
  p->indices.assign(indices, indices + n);
  p->batch_size = batch_size;
  p->n_batches =
      drop_last ? n / batch_size : (n + batch_size - 1) / batch_size;
  p->produced = 0;
  p->consumed = 0;
  p->stop_flag.store(false);
  std::fill(p->slot_state.begin(), p->slot_state.end(), kFree);
  p->running = true;
  p->producer = std::thread([p] { p->produce_loop(); });
}

// Pop the next batch FIFO.  Returns the slot index and writes the row
// count, or -1 when the epoch is exhausted.  The slot stays owned by the
// consumer until rlt_prefetcher_release.
int64_t rlt_prefetcher_next(Prefetcher* p, int64_t* nrows) {
  if (p->consumed >= p->n_batches) return -1;
  const int slot = static_cast<int>(p->consumed % p->queue_depth);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] {
    return p->slot_state[slot] == kReady || p->stop_flag.load();
  });
  if (p->stop_flag.load() && p->slot_state[slot] != kReady) return -1;
  *nrows = p->slot_rows[slot];
  ++p->consumed;
  return slot;
}

void rlt_prefetcher_release(Prefetcher* p, int64_t slot) {
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->slot_state[static_cast<size_t>(slot)] = kFree;
  }
  p->cv_free.notify_one();
}

// Abort the in-flight epoch (consumer bailed early).
void rlt_prefetcher_stop(Prefetcher* p) {
  p->stop_flag.store(true);
  p->cv_free.notify_all();
  p->cv_ready.notify_all();
  p->join_producer();
}

void rlt_prefetcher_destroy(Prefetcher* p) {
  rlt_prefetcher_stop(p);
  delete p;
}

// Standalone threaded gather (used for one-shot batch assembly outside
// the prefetch ring, e.g. the distributed predict fast path).
void rlt_gather(const void* src, int64_t row_bytes, const int64_t* indices,
                int64_t nrows, void* dst, int n_threads) {
  SourceArray a{static_cast<const char*>(src), row_bytes};
  gather_rows(a, indices, nrows, static_cast<char*>(dst), n_threads);
}

}  // extern "C"
