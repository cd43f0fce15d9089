// Native Criteo split-binary batch loader (PyTorch port).
//
// The port's own copy of the JAX package's ``cc/data_loader.cc``, the same
// code: a C++17 thread pool preads and type-widens batches directly into
// ring-buffer slots, so the Python process only ever sees ready-to-ship
// numpy views. Batch assembly -- fp16->fp32 widening of the numerical
// features and int8/16/32 -> int32 widening of each categorical stream --
// is done here, multi-threaded, not in numpy. Built at first use by
// ``distributed_embeddings_torch/cc/__init__.py`` with the host C++
// compiler into the repository's ``build/`` directory.
//
// On-disk format (reference `utils.py:117-123, 157-206`):
//   <base>/label.bin      uint8   [num_samples]
//   <base>/numerical.bin  float16 [num_samples, num_numerical]
//   <base>/cat_<id>.bin   intN    [num_samples]  (N = 8/16/32 by vocab size)
//
// Exposed as a plain C API for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// fp16 -> fp32 (scalar; compilers vectorize the loop well with -O3)
// ---------------------------------------------------------------------------
inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t out;
  if (exp == 0) {
    if (mant == 0) {
      out = sign;  // +-0
    } else {
      // subnormal: normalize. mant's top set bit at position p becomes the
      // implicit bit; value = mant * 2^-24 so the fp32 exponent is 103 + p
      // = 113 - shift.
      int shift = 0;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      out = sign | ((uint32_t)(113 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 0x1F) {
    out = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    out = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &out, sizeof(f));
  return f;
}

ssize_t pread_full(int fd, void* buf, size_t count, off_t offset) {
  char* p = static_cast<char*>(buf);
  size_t done = 0;
  while (done < count) {
    ssize_t n = ::pread(fd, p + done, count - done, offset + (off_t)done);
    if (n <= 0) return n < 0 ? n : (ssize_t)done;
    done += (size_t)n;
  }
  return (ssize_t)done;
}

struct CatFile {
  int fd = -1;
  int itemsize = 4;  // 1, 2 or 4
};

struct Batch {
  int64_t index = -1;
  int64_t num_samples = 0;
  std::vector<float> numerical;  // [n, num_numerical]
  std::vector<int32_t> cats;     // [num_cat, n] feature-major
  std::vector<float> labels;     // [n]
  bool ready = false;
};

class Loader {
 public:
  Loader(const char* base_dir, int num_numerical, int num_cat,
         const int32_t* cat_ids, const int64_t* cat_itemsizes,
         int64_t batch_size, int64_t rank, int64_t world_size, int drop_last,
         int prefetch_depth, int num_threads)
      : num_numerical_(num_numerical),
        batch_size_(batch_size),
        rank_(rank),
        world_size_(world_size < 1 ? 1 : world_size),
        prefetch_depth_(prefetch_depth < 1 ? 1 : prefetch_depth) {
    std::string base(base_dir);
    label_fd_ = ::open((base + "/label.bin").c_str(), O_RDONLY);
    if (label_fd_ < 0) {
      err_ = "cannot open " + base + "/label.bin";
      return;
    }
    struct stat st;
    ::fstat(label_fd_, &st);
    num_samples_ = (int64_t)st.st_size;

    if (num_numerical_ > 0) {
      num_fd_ = ::open((base + "/numerical.bin").c_str(), O_RDONLY);
      if (num_fd_ < 0) {
        err_ = "cannot open " + base + "/numerical.bin";
        return;
      }
      ::fstat(num_fd_, &st);
      if ((int64_t)st.st_size != num_samples_ * num_numerical_ * 2) {
        err_ = "numerical.bin size mismatch";
        return;
      }
    }
    for (int i = 0; i < num_cat; ++i) {
      CatFile cf;
      cf.itemsize = (int)cat_itemsizes[i];
      std::string path = base + "/cat_" + std::to_string(cat_ids[i]) + ".bin";
      cf.fd = ::open(path.c_str(), O_RDONLY);
      if (cf.fd < 0) {
        err_ = "cannot open " + path;
        return;
      }
      ::fstat(cf.fd, &st);
      if ((int64_t)st.st_size != num_samples_ * cf.itemsize) {
        err_ = path + " size mismatch";
        return;
      }
      cats_.push_back(cf);
    }

    int64_t global_batch = batch_size_ * world_size_;
    num_batches_ = drop_last ? num_samples_ / global_batch
                             : (num_samples_ + global_batch - 1) / global_batch;

    int n = num_threads < 1 ? 1 : num_threads;
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { this->WorkerLoop(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      shutdown_ = true;
    }
    cv_work_.notify_all();
    cv_done_.notify_all();
    for (auto& t : workers_) t.join();
    if (label_fd_ >= 0) ::close(label_fd_);
    if (num_fd_ >= 0) ::close(num_fd_);
    for (auto& c : cats_) ::close(c.fd);
  }

  const char* error() const { return err_.empty() ? nullptr : err_.c_str(); }
  int64_t num_samples() const { return num_samples_; }
  int64_t num_batches() const { return num_batches_; }

  // Reset iteration to batch 0 and (re)fill the prefetch window.
  void Start() {
    std::lock_guard<std::mutex> lk(mu_);
    next_to_schedule_ = 0;
    next_to_emit_ = 0;
    window_.clear();
    ScheduleLocked();
    cv_work_.notify_all();
  }

  // Blocking: copy batch `next_to_emit_` into caller buffers.
  // Returns the sample count (0 is a legitimate empty per-rank slice of a
  // real batch, e.g. a high rank past the data end with drop_last=0),
  // -2 at end of epoch, -1 on error.
  int64_t Next(float* numerical, int32_t* cats, float* labels) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!err_.empty()) return -1;
    if (next_to_emit_ >= num_batches_) return -2;
    int64_t want = next_to_emit_;
    cv_done_.wait(lk, [&] {
      if (shutdown_ || !err_.empty()) return true;
      for (auto& b : window_)
        if (b.index == want && b.ready) return true;
      return false;
    });
    if (shutdown_ || !err_.empty()) return -1;
    Batch batch;
    for (auto it = window_.begin(); it != window_.end(); ++it) {
      if (it->index == want) {
        batch = std::move(*it);
        window_.erase(it);
        break;
      }
    }
    ++next_to_emit_;
    ScheduleLocked();
    cv_work_.notify_all();
    lk.unlock();

    int64_t n = batch.num_samples;
    if (numerical && num_numerical_ > 0)
      std::memcpy(numerical, batch.numerical.data(),
                  sizeof(float) * n * num_numerical_);
    // caller buffer is [num_cat, batch_size]; a short trailing batch (n <
    // batch_size) must keep the caller's row stride, not pack contiguously
    if (cats && !cats_.empty())
      for (size_t f = 0; f < cats_.size(); ++f)
        std::memcpy(cats + f * batch_size_, batch.cats.data() + f * n,
                    sizeof(int32_t) * n);
    if (labels) std::memcpy(labels, batch.labels.data(), sizeof(float) * n);
    return n;
  }

 private:
  // Assumes mu_ held: queue load tasks up to the prefetch depth.
  void ScheduleLocked() {
    while ((int64_t)window_.size() < prefetch_depth_ &&
           next_to_schedule_ < num_batches_) {
      Batch b;
      b.index = next_to_schedule_++;
      window_.push_back(std::move(b));
      pending_.push_back(window_.back().index);
    }
  }

  void WorkerLoop() {
    for (;;) {
      int64_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [&] { return shutdown_ || !pending_.empty(); });
        if (shutdown_) return;
        idx = pending_.front();
        pending_.pop_front();
      }
      LoadBatch(idx);
      cv_done_.notify_all();
    }
  }

  void LoadBatch(int64_t idx) {
    // dp slicing: rank r reads the r-th slice of global batch idx
    int64_t start = idx * batch_size_ * world_size_ + rank_ * batch_size_;
    int64_t end = start + batch_size_;
    if (end > num_samples_) end = num_samples_;
    int64_t n = end > start ? end - start : 0;

    Batch local;
    local.index = idx;
    local.num_samples = n;
    local.labels.resize(n);
    {
      std::vector<uint8_t> raw(n);
      if (pread_full(label_fd_, raw.data(), n, start) != (ssize_t)n) {
        Fail("short read on label.bin");
        return;
      }
      for (int64_t i = 0; i < n; ++i) local.labels[i] = (float)raw[i];
    }
    if (num_numerical_ > 0) {
      int64_t count = n * num_numerical_;
      std::vector<uint16_t> raw(count);
      if (pread_full(num_fd_, raw.data(), count * 2,
                     start * num_numerical_ * 2) != (ssize_t)(count * 2)) {
        Fail("short read on numerical.bin");
        return;
      }
      local.numerical.resize(count);
      for (int64_t i = 0; i < count; ++i)
        local.numerical[i] = half_to_float(raw[i]);
    }
    if (!cats_.empty()) {
      local.cats.resize(cats_.size() * n);
      std::vector<char> raw;
      for (size_t f = 0; f < cats_.size(); ++f) {
        const CatFile& cf = cats_[f];
        raw.resize(n * cf.itemsize);
        if (pread_full(cf.fd, raw.data(), n * cf.itemsize,
                       start * cf.itemsize) != (ssize_t)(n * cf.itemsize)) {
          Fail("short read on categorical file");
          return;
        }
        int32_t* out = local.cats.data() + f * n;
        switch (cf.itemsize) {
          case 1: {
            auto* p = reinterpret_cast<const int8_t*>(raw.data());
            for (int64_t i = 0; i < n; ++i) out[i] = p[i];
            break;
          }
          case 2: {
            auto* p = reinterpret_cast<const int16_t*>(raw.data());
            for (int64_t i = 0; i < n; ++i) out[i] = p[i];
            break;
          }
          default: {
            std::memcpy(out, raw.data(), n * 4);
            break;
          }
        }
      }
    }

    std::lock_guard<std::mutex> lk(mu_);
    for (auto& b : window_) {
      if (b.index == idx) {
        int64_t i = b.index;
        b = std::move(local);
        b.index = i;
        b.ready = true;
        break;
      }
    }
  }

  void Fail(const std::string& msg) {
    std::lock_guard<std::mutex> lk(mu_);
    if (err_.empty()) err_ = msg;
  }

  int num_numerical_;
  int64_t batch_size_, rank_, world_size_, prefetch_depth_;
  int64_t num_samples_ = 0, num_batches_ = 0;
  int label_fd_ = -1, num_fd_ = -1;
  std::vector<CatFile> cats_;

  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_;
  std::deque<Batch> window_;       // in-flight + ready batches
  std::deque<int64_t> pending_;    // indices awaiting a worker
  int64_t next_to_schedule_ = 0, next_to_emit_ = 0;
  bool shutdown_ = false;
  std::string err_;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* de_loader_open(const char* base_dir, int num_numerical, int num_cat,
                     const int32_t* cat_ids, const int64_t* cat_itemsizes,
                     int64_t batch_size, int64_t rank, int64_t world_size,
                     int drop_last, int prefetch_depth, int num_threads) {
  auto* l = new Loader(base_dir, num_numerical, num_cat, cat_ids,
                       cat_itemsizes, batch_size, rank, world_size, drop_last,
                       prefetch_depth, num_threads);
  return l;
}

const char* de_loader_error(void* h) {
  return static_cast<Loader*>(h)->error();
}

int64_t de_loader_num_samples(void* h) {
  return static_cast<Loader*>(h)->num_samples();
}

int64_t de_loader_num_batches(void* h) {
  return static_cast<Loader*>(h)->num_batches();
}

void de_loader_start(void* h) { static_cast<Loader*>(h)->Start(); }

int64_t de_loader_next(void* h, float* numerical, int32_t* cats,
                       float* labels) {
  return static_cast<Loader*>(h)->Next(numerical, cats, labels);
}

void de_loader_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
