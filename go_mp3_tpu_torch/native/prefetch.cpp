// A native worker thread for the Decoder's readahead prefetch: it runs one
// parse of a stream's parser into the caller's rows (gmp_parse or
// gmp_parse_packed) while the caller's thread ships the rows before them to
// the card and serves reads from their PCM.
//
// No Python runs on it. A Python thread takes the interpreter lock before
// and after each native call, and the caller's thread drops and takes that
// lock around every torch call of a device decode, so a Python worker makes
// the caller wait for the lock inside its device call. The worker and the
// join each spin a short while before they sleep on a condition variable:
// waking a sleeping thread costs tens of microseconds on a virtual machine's
// idle core, as much as a decode's host work around its card call, and a
// stream read in a loop starts its next parse well within the spin.
//
//   w = gmp_worker_create();               // a thread
//   gmp_worker_start(w, parser, cap, packed, rows...);
//   n = gmp_worker_join(w, &parse_ns);     // granules, or -1: gmp_error(parser)
//   gmp_worker_destroy(w);                 // joins a parse in flight; the thread ends
//
// One parse at a time per worker; the caller keeps the parser and the rows
// alive until the join returns.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <thread>

extern "C" {
int gmp_parse(void* pv, int cap, int16_t* spectra, int32_t* sfl, int32_t* sfs,
              int32_t* meta);
int gmp_parse_packed(void* pv, int cap, int16_t* spectra, int16_t* side);
}

namespace {

using Clock = std::chrono::steady_clock;
constexpr auto kSpin = std::chrono::microseconds(2000);

inline void cpu_relax() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#elif defined(__aarch64__)
  asm volatile("yield");
#endif
}

// True once `flag` is set, within kSpin; false if the spin ran out.
bool spin_until(const std::atomic<bool>& flag) {
  const auto end = Clock::now() + kSpin;
  while (!flag.load(std::memory_order_acquire)) {
    if (Clock::now() > end) return false;
    cpu_relax();
  }
  return true;
}

struct Worker {
  std::mutex m;
  std::condition_variable job_cv, done_cv;
  std::atomic<bool> job{false}, done{true}, quit{false};
  bool worker_sleeps = false, joiner_sleeps = false;  // guarded by m
  // the parse in flight, written by the caller before `job` is set
  void* parser = nullptr;
  int cap = 0;
  bool packed = true;
  void* rows[4] = {nullptr, nullptr, nullptr, nullptr};
  // its result, written by the worker before `done` is set
  int result = 0;
  int64_t parse_ns = 0;
};

void run(Worker* w) {
  for (;;) {
    if (!spin_until(w->job)) {
      std::unique_lock<std::mutex> lk(w->m);
      w->worker_sleeps = true;
      w->job_cv.wait(lk, [w] {
        return w->job.load(std::memory_order_acquire) || w->quit.load();
      });
      w->worker_sleeps = false;
      if (w->quit.load()) {  // gmp_worker_destroy has returned: w is this thread's
        lk.unlock();
        delete w;
        return;
      }
    }
    w->job.store(false, std::memory_order_relaxed);
    const auto t0 = Clock::now();
    const int n =
        w->packed
            ? gmp_parse_packed(w->parser, w->cap, static_cast<int16_t*>(w->rows[0]),
                               static_cast<int16_t*>(w->rows[1]))
            : gmp_parse(w->parser, w->cap, static_cast<int16_t*>(w->rows[0]),
                        static_cast<int32_t*>(w->rows[1]),
                        static_cast<int32_t*>(w->rows[2]),
                        static_cast<int32_t*>(w->rows[3]));
    w->parse_ns =
        std::chrono::duration_cast<std::chrono::nanoseconds>(Clock::now() - t0).count();
    w->result = n;
    std::lock_guard<std::mutex> lk(w->m);
    w->done.store(true, std::memory_order_release);
    if (w->joiner_sleeps) w->done_cv.notify_one();
  }
}

}  // namespace

extern "C" {

void* gmp_worker_create() {
  auto* w = new Worker();
  std::thread(run, w).detach();
  return w;
}

void gmp_worker_start(void* pw, void* parser, int cap, int packed, void* r0,
                      void* r1, void* r2, void* r3) {
  auto* w = static_cast<Worker*>(pw);
  w->parser = parser;
  w->cap = cap;
  w->packed = packed != 0;
  w->rows[0] = r0;
  w->rows[1] = r1;
  w->rows[2] = r2;
  w->rows[3] = r3;
  w->done.store(false, std::memory_order_relaxed);
  std::lock_guard<std::mutex> lk(w->m);
  w->job.store(true, std::memory_order_release);
  if (w->worker_sleeps) w->job_cv.notify_one();
}

int gmp_worker_join(void* pw, int64_t* parse_ns) {
  auto* w = static_cast<Worker*>(pw);
  if (!spin_until(w->done)) {
    std::unique_lock<std::mutex> lk(w->m);
    w->joiner_sleeps = true;
    w->done_cv.wait(lk, [w] { return w->done.load(std::memory_order_acquire); });
    w->joiner_sleeps = false;
  }
  *parse_ns = w->parse_ns;
  return w->result;
}

void gmp_worker_destroy(void* pw) {
  auto* w = static_cast<Worker*>(pw);
  if (!w->done.load(std::memory_order_acquire)) {
    int64_t ns;
    gmp_worker_join(pw, &ns);
  }
  std::lock_guard<std::mutex> lk(w->m);
  w->quit.store(true);
  w->job_cv.notify_one();
}

}  // extern "C"
