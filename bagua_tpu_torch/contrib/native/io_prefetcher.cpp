// Native data-loading prefetcher (C ABI, loaded via ctypes).
//
// The runtime-side analog of the reference's data path: where bagua leans on
// torch DataLoader worker *processes* plus a redis cache, a TPU host wants
// GIL-free native reader threads feeding the input pipeline.  This is a
// thread-pool file reader with a bounded completion queue: Python submits
// (id, path) pairs, worker threads read whole files off disk, and Python
// polls completed (id, buffer) results.  Backpressure comes from the bounded
// in-flight budget.

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Task {
  uint64_t id;
  std::string path;
};

struct Result {
  uint64_t id;
  uint8_t* data;  // malloc'd; freed by prefetcher_free_buffer
  int64_t size;   // -1 = read error
};

struct Prefetcher {
  std::vector<std::thread> workers;
  std::deque<Task> tasks;
  std::deque<Result> results;
  std::mutex mu;
  std::condition_variable task_cv;
  std::condition_variable result_cv;
  bool stopping = false;
  uint64_t in_flight = 0;
  uint64_t capacity;

  void worker_loop() {
    for (;;) {
      Task task;
      {
        std::unique_lock<std::mutex> lock(mu);
        task_cv.wait(lock, [&] { return stopping || !tasks.empty(); });
        if (stopping && tasks.empty()) return;
        task = std::move(tasks.front());
        tasks.pop_front();
      }
      Result r{task.id, nullptr, -1};
      FILE* f = fopen(task.path.c_str(), "rb");
      if (f) {
        fseek(f, 0, SEEK_END);
        long size = ftell(f);
        fseek(f, 0, SEEK_SET);
        if (size >= 0) {
          r.data = (uint8_t*)malloc(size > 0 ? size : 1);
          if (r.data && fread(r.data, 1, size, f) == (size_t)size) {
            r.size = size;
          } else {
            free(r.data);
            r.data = nullptr;
          }
        }
        fclose(f);
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        results.push_back(r);
      }
      result_cv.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* bagua_prefetcher_create(int n_threads, uint64_t capacity) {
  auto* p = new Prefetcher();
  p->capacity = capacity ? capacity : 64;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    p->workers.emplace_back([p] { p->worker_loop(); });
  return p;
}

// Returns 0 on success, -1 if the in-flight budget is exhausted (try again
// after polling some results).
int bagua_prefetcher_submit(void* handle, uint64_t id, const char* path) {
  auto* p = (Prefetcher*)handle;
  {
    std::lock_guard<std::mutex> lock(p->mu);
    if (p->in_flight >= p->capacity) return -1;
    p->tasks.push_back(Task{id, path});
    p->in_flight++;
  }
  p->task_cv.notify_one();
  return 0;
}

// Polls one completed read.  Returns 1 and fills (id, data, size) if a
// result was available (blocking up to timeout_ms), else 0.  size == -1
// signals a read error for that id (data is null).
int bagua_prefetcher_poll(void* handle, uint64_t* id, uint8_t** data,
                          int64_t* size, int timeout_ms) {
  auto* p = (Prefetcher*)handle;
  std::unique_lock<std::mutex> lock(p->mu);
  if (!p->result_cv.wait_for(lock, std::chrono::milliseconds(timeout_ms),
                             [&] { return !p->results.empty(); }))
    return 0;
  Result r = p->results.front();
  p->results.pop_front();
  p->in_flight--;
  *id = r.id;
  *data = r.data;
  *size = r.size;
  return 1;
}

void bagua_prefetcher_free_buffer(uint8_t* data) { free(data); }

void bagua_prefetcher_destroy(void* handle) {
  auto* p = (Prefetcher*)handle;
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->stopping = true;
  }
  p->task_cv.notify_all();
  for (auto& t : p->workers) t.join();
  for (auto& r : p->results)
    if (r.data) free(r.data);
  delete p;
}

}  // extern "C"
