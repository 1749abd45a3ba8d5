// DrawStore — append-only binary posterior-draw store with an async writer.
//
// The port's own copy of the JAX package's store, in the same `.stkr` file
// format, so that each package reads the other's files.  Draw blocks copied
// back from the card are handed to ds_append(), which copies them into an
// in-memory queue and returns at once; a writer thread streams them to
// disk, so the sample loop never waits on the filesystem.
//
// File layout (little-endian):
//   header: magic "STKD" | u32 version | u64 chains | u64 dim
//   body:   float32 draws, draw-major: [n_draws_total][chains][dim]
//
// C ABI (ctypes-friendly); all functions return 0 on success, <0 on error.

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

constexpr char kMagic[4] = {'S', 'T', 'K', 'D'};
constexpr uint32_t kVersion = 1;

struct Header {
  char magic[4];
  uint32_t version;
  uint64_t chains;
  uint64_t dim;
};

struct Store {
  FILE* file = nullptr;
  uint64_t chains = 0;
  uint64_t dim = 0;
  uint64_t draws_written = 0;   // flushed to disk
  uint64_t draws_queued = 0;    // accepted by ds_append (>= draws_written)

  std::deque<std::vector<float>> queue;
  std::mutex mu;
  std::condition_variable cv;       // writer wakeup
  std::condition_variable cv_done;  // flush waiters
  bool shutting_down = false;
  bool write_error = false;
  std::thread writer;

  void WriterLoop() {
    for (;;) {
      std::vector<float> block;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] { return !queue.empty() || shutting_down; });
        if (queue.empty()) {
          if (shutting_down) return;
          continue;
        }
        block = std::move(queue.front());
        queue.pop_front();
      }
      size_t n = block.size();
      size_t written = fwrite(block.data(), sizeof(float), n, file);
      {
        std::lock_guard<std::mutex> lock(mu);
        if (written != n) {
          write_error = true;
        } else {
          draws_written += n / (chains * dim);
        }
        cv_done.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

// Reopening an existing store with a matching header APPENDS (preempted
// runs resume without losing persisted draws); a fresh path creates the
// file.  A mismatched header is an error (nullptr), never a truncation.
void* ds_open(const char* path, uint64_t chains, uint64_t dim) {
  if (chains == 0 || dim == 0) return nullptr;
  uint64_t preexisting = 0;
  FILE* f = fopen(path, "r+b");
  if (f) {
    Header h;
    if (fread(&h, sizeof(Header), 1, f) != 1 ||
        memcmp(h.magic, kMagic, 4) != 0 || h.version != kVersion ||
        h.chains != chains || h.dim != dim) {
      fclose(f);
      return nullptr;
    }
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    preexisting =
        (size - static_cast<long>(sizeof(Header))) / (4 * chains * dim);
  } else {
    f = fopen(path, "wb");
    if (!f) return nullptr;
    Header h;
    memcpy(h.magic, kMagic, 4);
    h.version = kVersion;
    h.chains = chains;
    h.dim = dim;
    if (fwrite(&h, sizeof(Header), 1, f) != 1) {
      fclose(f);
      return nullptr;
    }
  }
  Store* s = new Store;
  s->file = f;
  s->chains = chains;
  s->dim = dim;
  s->draws_written = preexisting;
  s->draws_queued = preexisting;
  s->writer = std::thread([s] { s->WriterLoop(); });
  return s;
}

// data: draw-major float32 [n_draws][chains][dim]; copies and returns.
int ds_append(void* handle, const float* data, uint64_t n_draws) {
  Store* s = static_cast<Store*>(handle);
  if (!s || !data) return -1;
  size_t n = static_cast<size_t>(n_draws) * s->chains * s->dim;
  std::vector<float> block(data, data + n);
  {
    std::lock_guard<std::mutex> lock(s->mu);
    if (s->write_error) return -2;
    s->queue.push_back(std::move(block));
    s->draws_queued += n_draws;
  }
  s->cv.notify_one();
  return 0;
}

// Blocks until every queued draw is on disk (fflush included).
int ds_flush(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (!s) return -1;
  std::unique_lock<std::mutex> lock(s->mu);
  s->cv_done.wait(lock, [&] {
    return s->write_error || (s->queue.empty() && s->draws_written == s->draws_queued);
  });
  if (s->write_error) return -2;
  fflush(s->file);
  return 0;
}

uint64_t ds_count(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (!s) return 0;
  std::lock_guard<std::mutex> lock(s->mu);
  return s->draws_queued;
}

int ds_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (!s) return -1;
  {
    std::lock_guard<std::mutex> lock(s->mu);
    s->shutting_down = true;
  }
  s->cv.notify_all();
  s->writer.join();
  // drain anything the writer missed between last wake and shutdown
  while (!s->queue.empty()) {
    auto& block = s->queue.front();
    if (fwrite(block.data(), sizeof(float), block.size(), s->file) !=
        block.size()) {
      s->write_error = true;
    } else {
      s->draws_written += block.size() / (s->chains * s->dim);
    }
    s->queue.pop_front();
  }
  int rc = s->write_error ? -2 : 0;
  fclose(s->file);
  delete s;
  return rc;
}

}  // extern "C"
