// Native MultiSlot data feeder: multithreaded file parsing + bounded
// queues (the port's copy of the JAX package's runtime/datafeed.cc).
//
// Reference: paddle/fluid/framework/data_feed.h:61 (DataFeed /
// MultiSlotDataFeed / MultiSlotInMemoryDataFeed), framework/channel.h
// (bounded channels), operators/reader/lod_tensor_blocking_queue.h.
//
// The host side stays native C++ (parse + shuffle + batch assembly off
// the GIL) and fills fixed-shape padded buffers the caller hands over:
// one buffer a slot, [batch_size, dim], which on a machine with CUDA are
// pinned host memory, so the batch goes to the card with no second host
// copy.  Exposed as a tiny C API consumed through ctypes; built by g++
// at first use (paddle_tpu_torch/runtime/__init__.py).
//
// MultiSlot text format (one sample per line), per slot:
//   <n> v1 v2 ... vn
// dense slots: n floats (n == dim); sparse slots: n uint64 ids
// (padded/truncated to max_ids per sample, pad value = -1).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <mutex>
#include <queue>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct SlotSpec {
  std::string name;
  bool is_dense;   // dense float vs sparse int64 ids
  int dim;         // dense dim or max ids per sample (padded)
};

struct Sample {
  std::vector<float> dense;     // concatenated dense slots
  std::vector<int64_t> sparse;  // concatenated (padded) sparse slots
};

template <typename T>
class BlockingQueue {
 public:
  explicit BlockingQueue(size_t cap) : cap_(cap), closed_(false) {}

  bool Push(T&& v) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return false;
    q_.push(std::move(v));
    not_empty_.notify_one();
    return true;
  }

  bool Pop(T* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop();
    not_full_.notify_one();
    return true;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

 private:
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::queue<T> q_;
  size_t cap_;
  bool closed_;
};

struct Batch {
  int n = 0;
  std::vector<float> dense;
  std::vector<int64_t> sparse;
};

class Feeder {
 public:
  Feeder(std::vector<std::string> files, std::vector<SlotSpec> slots,
         int batch_size, int nthreads, int shuffle_buf, uint64_t seed)
      : files_(std::move(files)),
        slots_(std::move(slots)),
        batch_size_(batch_size),
        shuffle_buf_(shuffle_buf),
        rng_(seed),
        samples_(4096),
        batches_(64),
        file_idx_(0) {
    for (const auto& s : slots_) {
      if (s.is_dense) dense_dim_ += s.dim;
      else sparse_dim_ += s.dim;
    }
    active_readers_.store(nthreads);
    for (int i = 0; i < nthreads; ++i) {
      readers_.emplace_back([this] { ReadLoop(); });
    }
    batcher_ = std::thread([this] { BatchLoop(); });
  }

  ~Feeder() {
    samples_.Close();
    batches_.Close();
    for (auto& t : readers_) t.join();
    if (batcher_.joinable()) batcher_.join();
    Batch b;
    while (batches_.Pop(&b)) {
    }
  }

  // Copies the next batch into outs[k], slot k's [batch_size, dim]
  // buffer (float for a dense slot, int64 for a sparse one).  Returns
  // rows copied (0 = exhausted).
  int Next(void** outs) {
    Batch b;
    if (!batches_.Pop(&b)) return 0;
    int doff = 0, soff = 0;
    for (size_t k = 0; k < slots_.size(); ++k) {
      const SlotSpec& s = slots_[k];
      for (int r = 0; r < b.n; ++r) {
        if (s.is_dense) {
          std::memcpy(static_cast<float*>(outs[k]) + (size_t)r * s.dim,
                      b.dense.data() + (size_t)r * dense_dim_ + doff,
                      sizeof(float) * s.dim);
        } else {
          std::memcpy(static_cast<int64_t*>(outs[k]) + (size_t)r * s.dim,
                      b.sparse.data() + (size_t)r * sparse_dim_ + soff,
                      sizeof(int64_t) * s.dim);
        }
      }
      if (s.is_dense) doff += s.dim;
      else soff += s.dim;
    }
    return b.n;
  }

  int dense_dim() const { return dense_dim_; }
  int sparse_dim() const { return sparse_dim_; }

 private:
  bool ParseLine(const std::string& line, Sample* s) {
    const char* p = line.c_str();
    char* end = nullptr;
    s->dense.reserve(dense_dim_);
    s->sparse.reserve(sparse_dim_);
    for (const auto& slot : slots_) {
      long n = strtol(p, &end, 10);
      if (end == p) return false;
      p = end;
      if (slot.is_dense) {
        if (n != slot.dim) return false;
        for (long i = 0; i < n; ++i) {
          float v = strtof(p, &end);
          if (end == p) return false;
          p = end;
          s->dense.push_back(v);
        }
      } else {
        for (long i = 0; i < n; ++i) {
          long long id = strtoll(p, &end, 10);
          if (end == p) return false;
          p = end;
          if (i < slot.dim) s->sparse.push_back(id);
        }
        for (long i = n; i < slot.dim; ++i) s->sparse.push_back(-1);
      }
    }
    return true;
  }

  void ReadLoop() {
    std::vector<Sample> buf;
    std::mt19937_64 local_rng(rng_());
    for (;;) {
      size_t idx = file_idx_.fetch_add(1);
      if (idx >= files_.size()) break;
      std::ifstream in(files_[idx]);
      if (!in.is_open()) {
        std::fprintf(stderr, "[datafeed] cannot open %s\n",
                     files_[idx].c_str());
        continue;
      }
      std::string line;
      while (std::getline(in, line)) {
        if (line.empty()) continue;
        Sample s;
        if (!ParseLine(line, &s)) continue;
        if (shuffle_buf_ > 1) {
          // reservoir-style local shuffle (reference: Dataset
          // LocalShuffle, framework/data_set.h:90)
          buf.push_back(std::move(s));
          if ((int)buf.size() >= shuffle_buf_) {
            std::uniform_int_distribution<size_t> d(0, buf.size() - 1);
            size_t j = d(local_rng);
            std::swap(buf[j], buf.back());
            if (!samples_.Push(std::move(buf.back()))) return;
            buf.pop_back();
          }
        } else {
          if (!samples_.Push(std::move(s))) return;
        }
      }
    }
    for (auto& s : buf)
      if (!samples_.Push(std::move(s))) return;
    if (active_readers_.fetch_sub(1) == 1) samples_.Close();
  }

  void BatchLoop() {
    for (;;) {
      Batch b;
      b.dense.resize((size_t)batch_size_ * dense_dim_);
      b.sparse.resize((size_t)batch_size_ * sparse_dim_);
      int n = 0;
      Sample s;
      while (n < batch_size_ && samples_.Pop(&s)) {
        std::memcpy(b.dense.data() + (size_t)n * dense_dim_,
                    s.dense.data(), sizeof(float) * dense_dim_);
        std::memcpy(b.sparse.data() + (size_t)n * sparse_dim_,
                    s.sparse.data(), sizeof(int64_t) * sparse_dim_);
        ++n;
      }
      if (n == 0) break;
      b.n = n;
      if (!batches_.Push(std::move(b))) return;
      if (n < batch_size_) break;  // final partial batch
    }
    batches_.Close();
  }

 public:
  std::atomic<int> active_readers_{0};

 private:
  std::vector<std::string> files_;
  std::vector<SlotSpec> slots_;
  int batch_size_;
  int shuffle_buf_;
  int dense_dim_ = 0;
  int sparse_dim_ = 0;
  std::mt19937_64 rng_;
  BlockingQueue<Sample> samples_;
  BlockingQueue<Batch> batches_;
  std::atomic<size_t> file_idx_;
  std::vector<std::thread> readers_;
  std::thread batcher_;
};

std::vector<SlotSpec> ParseSpec(const char* spec) {
  // "name:dense:13,name2:sparse:5,..."
  std::vector<SlotSpec> out;
  std::stringstream ss(spec);
  std::string item;
  while (std::getline(ss, item, ',')) {
    size_t a = item.find(':');
    size_t b = item.find(':', a + 1);
    SlotSpec s;
    s.name = item.substr(0, a);
    s.is_dense = item.substr(a + 1, b - a - 1) == "dense";
    s.dim = std::stoi(item.substr(b + 1));
    out.push_back(s);
  }
  return out;
}

}  // namespace

extern "C" {

void* ptfeed_create(const char** files, int nfiles, const char* slot_spec,
                    int batch_size, int nthreads, int shuffle_buf,
                    uint64_t seed) {
  std::vector<std::string> fs(files, files + nfiles);
  auto slots = ParseSpec(slot_spec);
  return new Feeder(fs, slots, batch_size, nthreads, shuffle_buf, seed);
}

int ptfeed_dense_dim(void* h) { return static_cast<Feeder*>(h)->dense_dim(); }
int ptfeed_sparse_dim(void* h) {
  return static_cast<Feeder*>(h)->sparse_dim();
}

int ptfeed_next(void* h, void** outs) {
  return static_cast<Feeder*>(h)->Next(outs);
}

void ptfeed_destroy(void* h) { delete static_cast<Feeder*>(h); }

}  // extern "C"
