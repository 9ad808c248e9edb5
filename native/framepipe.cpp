// framepipe: native frame-ingestion runtime for the tracker.
//
// Role parity with the reference's ROS image transport + nodelet zero-copy
// path (pf_mpe/src/monocular_pose_estimator.cpp:245-268 image callback,
// pf_mpe/src/nodelet.cpp in-process deployment): a camera/replay producer
// feeds frames into a bounded single-producer single-consumer ring buffer;
// the Python/JAX consumer pops the newest frame (drop-oldest backpressure,
// matching a real-time tracker's "latest frame wins" policy) and extracts
// the red channel exactly like the node does (:267-268) — but here the
// conversion happens in native code off the Python GIL.
//
// Build: make -C native   ->  libframepipe.so (pure C ABI, ctypes-loaded).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct FramePipe {
  int width = 0;
  int height = 0;
  size_t capacity = 0;

  std::vector<uint8_t> slots;     // capacity * width * height
  std::vector<double> timestamps; // capacity
  std::vector<uint64_t> seq;      // capacity, sequence number per slot

  std::atomic<uint64_t> head{0}; // next slot to write (producer)
  std::atomic<uint64_t> tail{0}; // next slot to read (consumer)
  std::atomic<uint64_t> pushed{0};
  std::atomic<uint64_t> dropped{0};
  std::atomic<bool> closed{false};

  std::mutex mtx;
  std::condition_variable cv;

  // optional replay thread
  std::thread replayer;
  std::atomic<bool> stop_replay{false};

  uint8_t *slot_ptr(uint64_t index) {
    return slots.data() + (index % capacity) * (size_t)width * height;
  }
};

} // namespace

extern "C" {

FramePipe *fp_create(int width, int height, int capacity) {
  if (width <= 0 || height <= 0 || capacity <= 1) return nullptr;
  auto *p = new FramePipe();
  p->width = width;
  p->height = height;
  p->capacity = (size_t)capacity;
  p->slots.resize((size_t)capacity * width * height);
  p->timestamps.resize(capacity);
  p->seq.resize(capacity, 0);
  return p;
}

void fp_destroy(FramePipe *p) {
  if (!p) return;
  p->closed.store(true);
  p->stop_replay.store(true);
  p->cv.notify_all();
  if (p->replayer.joinable()) p->replayer.join();
  delete p;
}

// Push a frame.  channels==1: grayscale copy; channels==3: interleaved
// BGR, red channel extracted (reference: cv::split + channels[2]).
// Drop-oldest when full.  Returns the frame's sequence number, or -1.
long long fp_push(FramePipe *p, const uint8_t *data, int channels, double timestamp) {
  if (!p || p->closed.load()) return -1;
  const size_t n = (size_t)p->width * p->height;
  {
    std::lock_guard<std::mutex> lk(p->mtx);
    uint64_t head = p->head.load(std::memory_order_relaxed);
    uint64_t tail = p->tail.load(std::memory_order_relaxed);
    if (head - tail >= p->capacity) {
      // ring full: drop the oldest frame
      p->tail.store(tail + 1, std::memory_order_relaxed);
      p->dropped.fetch_add(1);
    }
    uint8_t *dst = p->slot_ptr(head);
    if (channels == 1) {
      std::memcpy(dst, data, n);
    } else if (channels == 3) {
      for (size_t i = 0; i < n; ++i) dst[i] = data[i * 3 + 2]; // red of BGR
    } else {
      return -1;
    }
    p->timestamps[head % p->capacity] = timestamp;
    p->seq[head % p->capacity] = head;
    p->head.store(head + 1, std::memory_order_release);
    p->pushed.fetch_add(1);
  }
  p->cv.notify_one();
  return (long long)(p->head.load() - 1);
}

// Pop the next frame in order.  Returns sequence number, -1 on timeout,
// -2 when the pipe is closed and drained.
long long fp_pop(FramePipe *p, uint8_t *out, double *timestamp, int timeout_ms) {
  if (!p) return -2;
  std::unique_lock<std::mutex> lk(p->mtx);
  const auto deadline =
      std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  while (p->head.load() == p->tail.load()) {
    if (p->closed.load()) return -2;
    if (p->cv.wait_until(lk, deadline) == std::cv_status::timeout) return -1;
  }
  uint64_t tail = p->tail.load();
  const size_t n = (size_t)p->width * p->height;
  std::memcpy(out, p->slot_ptr(tail), n);
  *timestamp = p->timestamps[tail % p->capacity];
  long long s = (long long)p->seq[tail % p->capacity];
  p->tail.store(tail + 1, std::memory_order_release);
  return s;
}

// Pop the most recent frame, discarding older ones ("latest wins", the
// real-time policy).  Returns dropped-in-this-call count via *skipped.
long long fp_pop_latest(FramePipe *p, uint8_t *out, double *timestamp, int timeout_ms,
                        int *skipped) {
  if (!p) return -2;
  std::unique_lock<std::mutex> lk(p->mtx);
  const auto deadline =
      std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  while (p->head.load() == p->tail.load()) {
    if (p->closed.load()) return -2;
    if (p->cv.wait_until(lk, deadline) == std::cv_status::timeout) return -1;
  }
  uint64_t head = p->head.load();
  uint64_t tail = p->tail.load();
  uint64_t last = head - 1;
  *skipped = (int)(last - tail);
  const size_t n = (size_t)p->width * p->height;
  std::memcpy(out, p->slot_ptr(last), n);
  *timestamp = p->timestamps[last % p->capacity];
  long long s = (long long)p->seq[last % p->capacity];
  p->tail.store(head, std::memory_order_release);
  return s;
}

unsigned long long fp_pushed(FramePipe *p) { return p ? p->pushed.load() : 0; }
unsigned long long fp_dropped(FramePipe *p) { return p ? p->dropped.load() : 0; }
int fp_pending(FramePipe *p) {
  return p ? (int)(p->head.load() - p->tail.load()) : 0;
}
void fp_close(FramePipe *p) {
  if (!p) return;
  p->closed.store(true);
  p->cv.notify_all();
}

// Replay a contiguous uint8 buffer of `count` frames (count*H*W bytes,
// already grayscale) at `fps` from a background thread — the bag-replay
// equivalent (reference launch files embed `rosbag play`, README.md:383).
// The buffer must stay alive until fp_replay_done / fp_destroy.
int fp_start_replay(FramePipe *p, const uint8_t *buffer, int count, double fps,
                    double t0) {
  if (!p || p->replayer.joinable() || count <= 0 || fps <= 0) return -1;
  p->stop_replay.store(false);
  const size_t n = (size_t)p->width * p->height;
  p->replayer = std::thread([p, buffer, count, fps, t0, n]() {
    const auto start = std::chrono::steady_clock::now();
    for (int i = 0; i < count && !p->stop_replay.load(); ++i) {
      const auto due =
          start + std::chrono::microseconds((long long)(i * 1e6 / fps));
      std::this_thread::sleep_until(due);
      fp_push(p, buffer + (size_t)i * n, 1, t0 + i / fps);
    }
  });
  return 0;
}

int fp_replay_running(FramePipe *p) {
  return p && p->replayer.joinable() && !p->stop_replay.load() ? 1 : 0;
}

void fp_stop_replay(FramePipe *p) {
  if (!p) return;
  p->stop_replay.store(true);
  if (p->replayer.joinable()) p->replayer.join();
  p->replayer = std::thread();
}

} // extern "C"
