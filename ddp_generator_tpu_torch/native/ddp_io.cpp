// ddp_io: native checkpoint/restore engine for ddp_generator_tpu.
//
// Role in the framework: the reference solver has NO checkpoint/resume at all
// (SURVEY.md section 5 -- solver state lives only in process memory; warm
// starting is only possible by passing the previous solution as u_nom to a
// new call, reference iLQG_mex.c:113-115).  For large batched production
// solves, this module provides the missing subsystem as native code: a
// compact binary tensor-archive format plus an asynchronous background
// writer so snapshotting a running solve does not stall the device loop.
//
// Design:
//   * File format "DDPT": magic, version, count; per tensor: name, dtype
//     code, ndim, dims, byte payload; trailing CRC32 per tensor.
//   * Synchronous API: ddpio_write / ddpio_open+read.
//   * Async API: a dedicated writer thread with a bounded job queue; jobs
//     own copies of the payloads, so the caller's buffers are free
//     immediately (double-buffering against device pulls).
//
// Build: g++ -O3 -shared -fPIC -pthread -o libddp_io.so ddp_io.cpp
// (see build.py / Makefile).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x44445054;  // "DDPT"
constexpr uint32_t kVersion = 1;
constexpr int kMaxDims = 8;

uint32_t crc32(const uint8_t* data, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Tensor {
  std::string name;
  int32_t dtype = 0;  // caller-defined code (numpy dtype enum on py side)
  int32_t ndim = 0;
  int64_t dims[kMaxDims] = {0};
  std::vector<uint8_t> data;
};

bool write_archive(const std::string& path, const std::vector<Tensor>& ts,
                   std::string* err) {
  std::string tmp = path + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) {
    if (err) *err = "cannot open " + tmp;
    return false;
  }
  auto w = [&](const void* p, size_t n) { return fwrite(p, 1, n, f) == n; };
  uint32_t count = (uint32_t)ts.size();
  bool ok = w(&kMagic, 4) && w(&kVersion, 4) && w(&count, 4);
  for (const auto& t : ts) {
    if (!ok) break;
    uint32_t name_len = (uint32_t)t.name.size();
    uint64_t nbytes = t.data.size();
    uint32_t crc = crc32(t.data.data(), t.data.size());
    ok = w(&name_len, 4) && w(t.name.data(), name_len) && w(&t.dtype, 4) &&
         w(&t.ndim, 4) && w(t.dims, sizeof(int64_t) * kMaxDims) &&
         w(&nbytes, 8) && w(t.data.data(), nbytes) && w(&crc, 4);
  }
  if (fclose(f) != 0) ok = false;
  if (!ok) {
    if (err) *err = "short write to " + tmp;
    remove(tmp.c_str());
    return false;
  }
  if (rename(tmp.c_str(), path.c_str()) != 0) {
    if (err) *err = "rename failed for " + path;
    remove(tmp.c_str());
    return false;
  }
  return true;
}

struct Archive {
  std::vector<Tensor> tensors;
  std::string error;
};

Archive* read_archive(const std::string& path) {
  auto* a = new Archive();
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    a->error = "cannot open " + path;
    return a;
  }
  auto r = [&](void* p, size_t n) { return fread(p, 1, n, f) == n; };
  uint32_t magic = 0, version = 0, count = 0;
  if (!r(&magic, 4) || magic != kMagic || !r(&version, 4) || !r(&count, 4)) {
    a->error = "bad header in " + path;
    fclose(f);
    return a;
  }
  for (uint32_t i = 0; i < count; i++) {
    Tensor t;
    uint32_t name_len = 0;
    uint64_t nbytes = 0;
    uint32_t crc = 0;
    if (!r(&name_len, 4) || name_len > (1u << 20)) goto corrupt;
    t.name.resize(name_len);
    if (!r(&t.name[0], name_len) || !r(&t.dtype, 4) || !r(&t.ndim, 4) ||
        !r(t.dims, sizeof(int64_t) * kMaxDims) || !r(&nbytes, 8))
      goto corrupt;
    t.data.resize(nbytes);
    if (!r(t.data.data(), nbytes) || !r(&crc, 4)) goto corrupt;
    if (crc32(t.data.data(), t.data.size()) != crc) {
      a->error = "CRC mismatch for tensor '" + t.name + "' in " + path;
      fclose(f);
      return a;
    }
    a->tensors.push_back(std::move(t));
  }
  fclose(f);
  return a;
corrupt:
  a->error = "truncated archive " + path;
  fclose(f);
  return a;
}

// ---------------- async writer ----------------

struct WriteJob {
  std::string path;
  std::vector<Tensor> tensors;
};

class AsyncWriter {
 public:
  explicit AsyncWriter(size_t max_queue) : max_queue_(max_queue) {
    thread_ = std::thread([this] { run(); });
  }
  ~AsyncWriter() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      cv_.notify_all();
    }
    thread_.join();
  }
  // Returns false if the queue is full (caller may retry or drop).
  bool submit(WriteJob&& job) {
    std::unique_lock<std::mutex> lk(mu_);
    if (queue_.size() >= max_queue_) return false;
    queue_.push_back(std::move(job));
    cv_.notify_one();
    return true;
  }
  void drain() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return queue_.empty() && !busy_; });
  }
  int64_t completed() const { return completed_.load(); }
  int64_t failed() const { return failed_.load(); }

 private:
  void run() {
    for (;;) {
      WriteJob job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) {
          if (stop_) return;
          continue;
        }
        job = std::move(queue_.front());
        queue_.pop_front();
        busy_ = true;
      }
      std::string err;
      bool ok = write_archive(job.path, job.tensors, &err);
      if (ok)
        completed_.fetch_add(1);
      else
        failed_.fetch_add(1);
      {
        std::unique_lock<std::mutex> lk(mu_);
        busy_ = false;
        done_cv_.notify_all();
      }
    }
  }
  size_t max_queue_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<WriteJob> queue_;
  bool stop_ = false;
  bool busy_ = false;
  std::thread thread_;
  std::atomic<int64_t> completed_{0}, failed_{0};
};

std::string g_last_error;

}  // namespace

extern "C" {

// ---- synchronous write ----
// names: array of C strings; dtypes: int codes; ndims/dims flattened
// (kMaxDims per tensor); datas: payload pointers; nbytes: payload sizes.
int ddpio_write(const char* path, int32_t n, const char** names,
                const int32_t* dtypes, const int32_t* ndims,
                const int64_t* dims, const void** datas,
                const int64_t* nbytes) {
  std::vector<Tensor> ts(n);
  for (int32_t i = 0; i < n; i++) {
    ts[i].name = names[i];
    ts[i].dtype = dtypes[i];
    ts[i].ndim = ndims[i];
    memcpy(ts[i].dims, dims + (size_t)i * kMaxDims, sizeof(int64_t) * kMaxDims);
    ts[i].data.assign((const uint8_t*)datas[i],
                      (const uint8_t*)datas[i] + nbytes[i]);
  }
  std::string err;
  if (!write_archive(path, ts, &err)) {
    g_last_error = err;
    return -1;
  }
  return 0;
}

// ---- read ----
void* ddpio_open(const char* path) { return read_archive(path); }
int32_t ddpio_count(void* h) {
  auto* a = (Archive*)h;
  return a->error.empty() ? (int32_t)a->tensors.size() : -1;
}
const char* ddpio_error(void* h) {
  auto* a = (Archive*)h;
  return a ? a->error.c_str() : g_last_error.c_str();
}
const char* ddpio_last_error() { return g_last_error.c_str(); }
const char* ddpio_name(void* h, int32_t i) {
  return ((Archive*)h)->tensors[i].name.c_str();
}
int32_t ddpio_dtype(void* h, int32_t i) {
  return ((Archive*)h)->tensors[i].dtype;
}
int32_t ddpio_ndim(void* h, int32_t i) {
  return ((Archive*)h)->tensors[i].ndim;
}
void ddpio_dims(void* h, int32_t i, int64_t* out) {
  memcpy(out, ((Archive*)h)->tensors[i].dims, sizeof(int64_t) * kMaxDims);
}
int64_t ddpio_nbytes(void* h, int32_t i) {
  return (int64_t)((Archive*)h)->tensors[i].data.size();
}
int ddpio_read(void* h, int32_t i, void* out, int64_t nbytes) {
  auto& t = ((Archive*)h)->tensors[i];
  if ((int64_t)t.data.size() != nbytes) return -1;
  memcpy(out, t.data.data(), nbytes);
  return 0;
}
void ddpio_close(void* h) { delete (Archive*)h; }

// ---- async writer ----
void* ddpio_writer_create(int32_t max_queue) {
  return new AsyncWriter((size_t)max_queue);
}
int ddpio_writer_submit(void* w, const char* path, int32_t n,
                        const char** names, const int32_t* dtypes,
                        const int32_t* ndims, const int64_t* dims,
                        const void** datas, const int64_t* nbytes) {
  WriteJob job;
  job.path = path;
  job.tensors.resize(n);
  for (int32_t i = 0; i < n; i++) {
    auto& t = job.tensors[i];
    t.name = names[i];
    t.dtype = dtypes[i];
    t.ndim = ndims[i];
    memcpy(t.dims, dims + (size_t)i * kMaxDims, sizeof(int64_t) * kMaxDims);
    t.data.assign((const uint8_t*)datas[i],
                  (const uint8_t*)datas[i] + nbytes[i]);
  }
  return ((AsyncWriter*)w)->submit(std::move(job)) ? 0 : -1;
}
void ddpio_writer_drain(void* w) { ((AsyncWriter*)w)->drain(); }
int64_t ddpio_writer_completed(void* w) { return ((AsyncWriter*)w)->completed(); }
int64_t ddpio_writer_failed(void* w) { return ((AsyncWriter*)w)->failed(); }
void ddpio_writer_destroy(void* w) { delete (AsyncWriter*)w; }

}  // extern "C"
