// Native worker threads that parse off the caller's thread. A job is one
// parse of a stream's parser into the caller's rows (gmp_parse or
// gmp_parse_packed): the Decoder's readahead prefetch, while the caller's
// thread ships the rows before them to the card and serves reads from their
// PCM. Or up to k chunks of many streams (gmp_parse_packed8_many): the
// corpus's next segment, while the caller packs and ships the current one.
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
//   gmp_worker_start_many(w, handles, n, cap, k, tail, head, side, valids, strides...);
//   c = gmp_worker_join_many(w, &parse_ns, &status, &stream);
//                                          // chunks with a granule; status as
//                                          // gmp_parse_packed8_many's -1 / -2
//   gmp_worker_destroy(w);                 // joins a parse in flight; the thread ends
//
// One job at a time per worker; the caller keeps the parsers and the rows
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
int gmp_parse_packed8_many(void** pv, int n_streams, int cap, int8_t* tail8,
                           int16_t* head16, uint8_t* side8, int32_t* valids,
                           int32_t* err_stream);
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
  // the job in flight, written by the caller before `job` is set
  bool many = false;  // gmp_worker_start_many's job
  void* parser = nullptr;
  int cap = 0;
  bool packed = true;
  void* rows[4] = {nullptr, nullptr, nullptr, nullptr};
  void** handles = nullptr;  // many: the streams' parsers
  int n_streams = 0, chunks = 0;
  int64_t stride[3] = {0, 0, 0};  // many: bytes from a chunk's tail, head, side rows to the next's
  // its result, written by the worker before `done` is set
  int result = 0;
  int32_t status = 0, err_stream = -1;
  int64_t parse_ns = 0;
};

// Up to w->chunks chunks of every stream, one gmp_parse_packed8_many call a
// chunk, stopping at the first chunk with no granule or at an error: the
// chunks with a granule before the stop, the error in status / err_stream.
int parse_many(Worker* w) {
  auto* tail = static_cast<int8_t*>(w->rows[0]);
  auto* head = static_cast<char*>(w->rows[1]);
  auto* side = static_cast<uint8_t*>(w->rows[2]);
  auto* valids = static_cast<int32_t*>(w->rows[3]);
  w->status = 0;
  w->err_stream = -1;
  int c = 0;
  for (; c < w->chunks; c++) {
    const int mx = gmp_parse_packed8_many(
        w->handles, w->n_streams, w->cap, tail + c * w->stride[0],
        reinterpret_cast<int16_t*>(head + c * w->stride[1]), side + c * w->stride[2],
        valids + int64_t(c) * w->n_streams, &w->err_stream);
    if (mx < 0) w->status = mx;
    if (mx <= 0) break;
  }
  return c;
}

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
        w->many ? parse_many(w)
        : w->packed
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

// Hand the job the caller wrote to the thread.
void post(Worker* w) {
  w->done.store(false, std::memory_order_relaxed);
  std::lock_guard<std::mutex> lk(w->m);
  w->job.store(true, std::memory_order_release);
  if (w->worker_sleeps) w->job_cv.notify_one();
}

// Return once the job in flight (if any) is done.
void wait_done(Worker* w) {
  if (!spin_until(w->done)) {
    std::unique_lock<std::mutex> lk(w->m);
    w->joiner_sleeps = true;
    w->done_cv.wait(lk, [w] { return w->done.load(std::memory_order_acquire); });
    w->joiner_sleeps = false;
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
  w->many = false;
  post(w);
}

int gmp_worker_join(void* pw, int64_t* parse_ns) {
  auto* w = static_cast<Worker*>(pw);
  wait_done(w);
  *parse_ns = w->parse_ns;
  return w->result;
}

// rows: [chunks, n_streams, cap, ..] each, C order, as gmp_parse_packed8_many
// takes one chunk of them; valids int32 [chunks, n_streams]. The caller
// zeroes valids: a chunk past the stop is not written.
void gmp_worker_start_many(void* pw, void** handles, int n_streams, int cap,
                           int chunks, int8_t* tail8, int16_t* head16,
                           uint8_t* side8, int32_t* valids, int64_t tail_stride,
                           int64_t head_stride, int64_t side_stride) {
  auto* w = static_cast<Worker*>(pw);
  w->handles = handles;
  w->n_streams = n_streams;
  w->cap = cap;
  w->chunks = chunks;
  w->rows[0] = tail8;
  w->rows[1] = head16;
  w->rows[2] = side8;
  w->rows[3] = valids;
  w->stride[0] = tail_stride;
  w->stride[1] = head_stride;
  w->stride[2] = side_stride;
  w->many = true;
  post(w);
}

int gmp_worker_join_many(void* pw, int64_t* parse_ns, int32_t* status,
                         int32_t* err_stream) {
  auto* w = static_cast<Worker*>(pw);
  wait_done(w);
  *parse_ns = w->parse_ns;
  *status = w->status;
  *err_stream = w->err_stream;
  return w->result;
}

void gmp_worker_destroy(void* pw) {
  auto* w = static_cast<Worker*>(pw);
  wait_done(w);
  std::lock_guard<std::mutex> lk(w->m);
  w->quit.store(true);
  w->job_cv.notify_one();
}

}  // extern "C"
