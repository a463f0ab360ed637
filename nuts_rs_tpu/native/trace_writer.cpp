// Async trace-chunk writer: the native I/O runtime of the framework.
//
// Native counterpart of the reference's async storage backend
// (nuts-rs src/storage/zarr/async_impl.rs:33-981): a bounded write queue with
// backpressure (max_queued_writes, async_impl.rs:365-400) drained by worker
// threads that zlib-compress Zarr chunks and write them to disk, so the
// Python host loop feeding the device never blocks on storage I/O.
//
// C ABI for ctypes; no Python.h dependency.
//
// Scope note vs the reference: async_impl.rs targets any tokio object_store
// (local FS, S3, GCS, ...).  This NATIVE writer targets the local
// filesystem (fast fd writes off the sampler thread); object-store URLs
// (memory://, s3://, ...) are handled by the Python layer through fsspec
// instead (storage/zarr_format.py) — ZarrConfig("s3://...") routes every
// chunk through the protocol's fsspec driver and skips this writer.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>
#ifndef NO_ZSTD
#include <zstd.h>
#endif

namespace {

struct WriteJob {
  std::string path;
  std::vector<uint8_t> data;
  int compress_level;  // <0: raw
  int codec = 0;       // 0: zlib, 1: zstd (reference ships Blosc-Zstd,
                       // src/storage/zarr/common.rs:310-331; plain zstd is
                       // the zarr-v2 "zstd" numcodecs id, ArviZ-readable)
};

struct Writer {
  std::deque<WriteJob> queue;
  std::mutex mu;
  std::condition_variable cv_push;  // workers wait for jobs
  std::condition_variable cv_pop;   // producers wait for space
  std::vector<std::thread> workers;
  size_t max_queue;
  size_t in_flight = 0;  // queued + currently being written
  bool shutdown = false;
  std::string error;

  explicit Writer(size_t max_queue_, int n_threads) : max_queue(max_queue_) {
    for (int i = 0; i < n_threads; i++) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  void set_error(const std::string& msg) {
    std::lock_guard<std::mutex> lock(mu);
    if (error.empty()) error = msg;
  }

  static bool write_file(const WriteJob& job, std::string* err) {
    std::vector<uint8_t> out;
    const uint8_t* payload = job.data.data();
    size_t payload_len = job.data.size();

    if (job.compress_level >= 0 && job.codec == 1) {
#ifdef NO_ZSTD
      // Fallback build on hosts without libzstd: the zlib async path stays
      // available; zstd jobs must be compressed Python-side (write_raw).
      *err = "native writer built without zstd (NO_ZSTD): " + job.path;
      return false;
#else
      size_t bound = ZSTD_compressBound(job.data.size());
      out.resize(bound);
      size_t n = ZSTD_compress(out.data(), bound, job.data.data(),
                               job.data.size(), job.compress_level);
      if (ZSTD_isError(n)) {
        *err = "zstd compress failed for " + job.path;
        return false;
      }
      payload = out.data();
      payload_len = n;
#endif
    } else if (job.compress_level >= 0) {
      uLongf bound = compressBound(job.data.size());
      out.resize(bound);
      int rc = compress2(out.data(), &bound, job.data.data(), job.data.size(),
                         job.compress_level);
      if (rc != Z_OK) {
        *err = "zlib compress failed for " + job.path;
        return false;
      }
      payload = out.data();
      payload_len = bound;
    }

    std::string tmp = job.path + ".tmp";
    FILE* f = fopen(tmp.c_str(), "wb");
    if (!f) {
      *err = "open failed: " + tmp;
      return false;
    }
    size_t written = fwrite(payload, 1, payload_len, f);
    fclose(f);
    if (written != payload_len) {
      *err = "short write: " + tmp;
      return false;
    }
    if (rename(tmp.c_str(), job.path.c_str()) != 0) {
      *err = "rename failed: " + job.path;
      return false;
    }
    return true;
  }

  void run() {
    for (;;) {
      WriteJob job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_push.wait(lock, [this] { return shutdown || !queue.empty(); });
        if (queue.empty()) return;  // shutdown with drained queue
        job = std::move(queue.front());
        queue.pop_front();
      }
      std::string err;
      if (!write_file(job, &err)) set_error(err);
      {
        std::lock_guard<std::mutex> lock(mu);
        in_flight--;
      }
      cv_pop.notify_all();
    }
  }

  // Blocks when the queue is full (backpressure; async_impl.rs:365-400).
  // The predicate also releases on shutdown so a producer blocked here
  // during destruction cannot wait forever on a condvar about to be
  // destroyed; jobs arriving after shutdown are dropped (destruction is a
  // caller bug the Python layer guards against, but it must not deadlock).
  void enqueue(const char* path, const void* data, size_t len, int level,
               int codec) {
    WriteJob job;
    job.path = path;
    job.data.assign(static_cast<const uint8_t*>(data),
                    static_cast<const uint8_t*>(data) + len);
    job.compress_level = level;
    job.codec = codec;
    {
      std::unique_lock<std::mutex> lock(mu);
      cv_pop.wait(lock, [this] { return shutdown || in_flight < max_queue; });
      if (shutdown) return;
      queue.push_back(std::move(job));
      in_flight++;
    }
    cv_push.notify_one();
  }

  void flush() {
    std::unique_lock<std::mutex> lock(mu);
    cv_pop.wait(lock, [this] { return shutdown || in_flight == 0; });
  }

  ~Writer() {
    {
      std::lock_guard<std::mutex> lock(mu);
      shutdown = true;
    }
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* tw_create(size_t max_queue, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (max_queue < 1) max_queue = 1;
  return new Writer(max_queue, n_threads);
}

void tw_write(void* handle, const char* path, const void* data, size_t len,
              int compress_level) {
  static_cast<Writer*>(handle)->enqueue(path, data, len, compress_level, 0);
}

void tw_write2(void* handle, const char* path, const void* data, size_t len,
               int compress_level, int codec) {
  static_cast<Writer*>(handle)->enqueue(path, data, len, compress_level,
                                        codec);
}

void tw_flush(void* handle) { static_cast<Writer*>(handle)->flush(); }

// Returns an empty string when no error occurred.
const char* tw_error(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  std::lock_guard<std::mutex> lock(w->mu);
  return w->error.c_str();
}

void tw_destroy(void* handle) { delete static_cast<Writer*>(handle); }

}  // extern "C"
