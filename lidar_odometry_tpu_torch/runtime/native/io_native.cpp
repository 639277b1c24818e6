// Native KITTI loader of the PyTorch port (a copy of the JAX package's
// runtime/native/io_native.cpp).
//
// The dataset driver streams KITTI velodyne .bin files from disk on the
// frame loop. Host CPU time is what feeds the device, so file parsing and
// read-ahead live in C++: a prefetch thread decodes the next scans, in
// order and a bounded number ahead, while the current one is on the card.
// Exposed through a plain C ABI for ctypes (runtime/native_io.py, which
// builds this file with g++ at first use; see the Makefile beside it).

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

namespace {

struct Cloud {
    std::vector<float> xyz;  // 3 * n floats
    long n = 0;
    bool ok = false;
};

// Read a KITTI .bin (x, y, z, intensity float4); intensity dropped.
Cloud load_bin(const std::string& path) {
    Cloud c;
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return c;
    std::fseek(f, 0, SEEK_END);
    long bytes = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    long n = bytes / (4 * sizeof(float));
    std::vector<float> buf(static_cast<size_t>(n) * 4);
    size_t got = std::fread(buf.data(), sizeof(float), static_cast<size_t>(n) * 4, f);
    std::fclose(f);
    n = static_cast<long>(got / 4);
    c.xyz.resize(static_cast<size_t>(n) * 3);
    for (long i = 0; i < n; ++i) {
        c.xyz[i * 3 + 0] = buf[i * 4 + 0];
        c.xyz[i * 3 + 1] = buf[i * 4 + 1];
        c.xyz[i * 3 + 2] = buf[i * 4 + 2];
    }
    c.n = n;
    c.ok = true;
    return c;
}

class Prefetcher {
  public:
    Prefetcher(std::vector<std::string> paths, int lookahead)
        : paths_(std::move(paths)), lookahead_(lookahead) {
        worker_ = std::thread([this] { this->run(); });
    }

    ~Prefetcher() {
        {
            std::lock_guard<std::mutex> g(mu_);
            stop_ = true;
        }
        cv_space_.notify_all();
        cv_data_.notify_all();
        if (worker_.joinable()) worker_.join();
    }

    // Blocks until the next cloud in order is ready; returns count or -1.
    long next(float* out, long capacity) {
        std::unique_lock<std::mutex> lk(mu_);
        cv_data_.wait(lk, [this] { return !queue_.empty() || done_ || stop_; });
        if (queue_.empty()) return -1;
        Cloud c = std::move(queue_.front());
        queue_.pop_front();
        cv_space_.notify_one();
        lk.unlock();
        if (!c.ok) return -1;
        long n = c.n < capacity ? c.n : capacity;
        std::memcpy(out, c.xyz.data(), static_cast<size_t>(n) * 3 * sizeof(float));
        return n;
    }

  private:
    void run() {
        for (const auto& p : paths_) {
            Cloud c = load_bin(p);
            std::unique_lock<std::mutex> lk(mu_);
            cv_space_.wait(lk, [this] {
                return static_cast<int>(queue_.size()) < lookahead_ || stop_;
            });
            if (stop_) return;
            queue_.push_back(std::move(c));
            cv_data_.notify_one();
        }
        std::lock_guard<std::mutex> g(mu_);
        done_ = true;
        cv_data_.notify_all();
    }

    std::vector<std::string> paths_;
    int lookahead_;
    std::deque<Cloud> queue_;
    std::mutex mu_;
    std::condition_variable cv_data_, cv_space_;
    std::thread worker_;
    bool done_ = false;
    bool stop_ = false;
};

}  // namespace

extern "C" {

long lo_load_kitti_bin(const char* path, float* out, long capacity) {
    Cloud c = load_bin(path);
    if (!c.ok) return -1;
    long n = c.n < capacity ? c.n : capacity;
    std::memcpy(out, c.xyz.data(), static_cast<size_t>(n) * 3 * sizeof(float));
    return n;
}

long lo_count_kitti_bin(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long bytes = std::ftell(f);
    std::fclose(f);
    return bytes / (4 * sizeof(float));
}

void* lo_prefetcher_create(const char** paths, long n_paths, int lookahead) {
    std::vector<std::string> v;
    v.reserve(static_cast<size_t>(n_paths));
    for (long i = 0; i < n_paths; ++i) v.emplace_back(paths[i]);
    return new Prefetcher(std::move(v), lookahead);
}

long lo_prefetcher_next(void* p, float* out, long capacity) {
    return static_cast<Prefetcher*>(p)->next(out, capacity);
}

void lo_prefetcher_destroy(void* p) { delete static_cast<Prefetcher*>(p); }

}  // extern "C"
