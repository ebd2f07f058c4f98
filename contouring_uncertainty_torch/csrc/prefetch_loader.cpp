// Background batch assembly for the training input pipeline (host C++).
//
// The port's copy of the JAX package's native/prefetch_loader.cpp, with the
// same algorithm, so both packages draw the same batches: the dataset stays
// in flat host arrays; one worker thread gathers shuffled batches into a
// ring of reusable slot buffers, and the Python training loop copies a
// filled slot out and hands it to the device feed (data/native_loader.py,
// train/trainer.py `_device_prefetch`).
//
// Built with g++ by build.py into the git-ignored _build/, loaded with
// ctypes. C API:
//   pf_create(...)  -> handle; starts the worker thread filling the ring
//   pf_next(handle) -> index of a filled slot (blocks while the ring is empty)
//   pf_release(handle, slot) -> return the slot to the worker
//   pf_buffers(handle, slot, &img, &gt, &cont) -> the slot's buffer pointers
//   pf_destroy(handle)
//
// Epochs: epoch e shuffles the indices 0..n-1 (carried over from epoch e-1)
// with std::shuffle driven by std::mt19937_64(seed + e); a batch never
// crosses an epoch boundary and the last partial batch is dropped.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Prefetcher {
  // Source arrays (owned by Python; they must outlive the prefetcher).
  // Images are a byte stream (img_bytes per sample): the Python side feeds
  // float32 or uint8 (TrainerConfig.feed_uint8) and views the slot buffer
  // back in the same dtype.
  const uint8_t* imgs = nullptr;
  const uint8_t* gts = nullptr;
  const float* contours = nullptr;
  int64_t n = 0;
  int64_t img_bytes = 0;   // per-sample image bytes (any dtype)
  int64_t gt_elems = 0;    // per-sample byte count
  int64_t cont_elems = 0;  // per-sample float count
  int64_t batch = 0;
  uint64_t seed = 0;

  // Ring of slots.
  int n_slots = 0;
  std::vector<std::vector<uint8_t>> img_buf;
  std::vector<std::vector<uint8_t>> gt_buf;
  std::vector<std::vector<float>> cont_buf;

  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::queue<int> free_slots, ready_slots;
  std::atomic<bool> stop{false};
  std::thread worker;

  void produce() {
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    uint64_t epoch = 0;
    while (!stop.load()) {
      std::mt19937_64 rng(seed + epoch);
      std::shuffle(order.begin(), order.end(), rng);
      int64_t n_batches = n / batch;
      for (int64_t b = 0; b < n_batches && !stop.load(); ++b) {
        int slot;
        {
          std::unique_lock<std::mutex> lock(mu);
          cv_free.wait(lock, [&] { return stop.load() || !free_slots.empty(); });
          if (stop.load()) return;
          slot = free_slots.front();
          free_slots.pop();
        }
        uint8_t* img_dst = img_buf[slot].data();
        uint8_t* gt_dst = gt_buf[slot].data();
        float* cont_dst = cont_buf[slot].data();
        for (int64_t j = 0; j < batch; ++j) {
          int64_t src = order[b * batch + j];
          std::memcpy(img_dst + j * img_bytes, imgs + src * img_bytes,
                      img_bytes);
          if (gts)
            std::memcpy(gt_dst + j * gt_elems, gts + src * gt_elems, gt_elems);
          if (contours)
            std::memcpy(cont_dst + j * cont_elems, contours + src * cont_elems,
                        cont_elems * sizeof(float));
        }
        {
          std::lock_guard<std::mutex> lock(mu);
          ready_slots.push(slot);
        }
        cv_ready.notify_one();
      }
      ++epoch;
    }
  }
};

}  // namespace

extern "C" {

void* pf_create(const uint8_t* imgs, const uint8_t* gts, const float* contours,
                int64_t n, int64_t img_bytes, int64_t gt_elems,
                int64_t cont_elems, int64_t batch, uint64_t seed,
                int n_slots) {
  auto* p = new Prefetcher();
  p->imgs = imgs;
  p->gts = gts;
  p->contours = contours;
  p->n = n;
  p->img_bytes = img_bytes;
  p->gt_elems = gt_elems;
  p->cont_elems = cont_elems;
  p->batch = batch;
  p->seed = seed;
  p->n_slots = n_slots;
  p->img_buf.resize(n_slots);
  p->gt_buf.resize(n_slots);
  p->cont_buf.resize(n_slots);
  for (int i = 0; i < n_slots; ++i) {
    p->img_buf[i].resize(batch * img_bytes);
    p->gt_buf[i].resize(batch * (gt_elems > 0 ? gt_elems : 1));
    p->cont_buf[i].resize(batch * (cont_elems > 0 ? cont_elems : 1));
    p->free_slots.push(i);
  }
  p->worker = std::thread([p] { p->produce(); });
  return p;
}

int pf_next(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lock(p->mu);
  p->cv_ready.wait(lock, [&] { return p->stop.load() || !p->ready_slots.empty(); });
  if (p->ready_slots.empty()) return -1;
  int slot = p->ready_slots.front();
  p->ready_slots.pop();
  return slot;
}

void pf_release(void* handle, int slot) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->free_slots.push(slot);
  }
  p->cv_free.notify_one();
}

void pf_buffers(void* handle, int slot, uint8_t** img, uint8_t** gt, float** cont) {
  auto* p = static_cast<Prefetcher*>(handle);
  *img = p->img_buf[slot].data();
  *gt = p->gt_buf[slot].data();
  *cont = p->cont_buf[slot].data();
}

void pf_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_free.notify_all();
  p->cv_ready.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
