// Native prefetch data loader: a producer thread pool fills a ring of
// host batch buffers AHEAD of the consumer, so batch synthesis (or, in a
// real deployment, file IO + decode) overlaps device compute — the
// double-buffered host side of an input pipeline.  The reference suite
// has no loader; this is the runtime-layer analogue of its pinned-host
// buffer discipline (concurency/bench_omp.cpp:42-44) applied to input
// data: host buffers live outside the accelerator framework entirely and
// cross the boundary as raw pointers (ctypes, zero-copy numpy views).
//
// DETERMINISM CONTRACT (what makes this compose with checkpoint/resume):
// batch t is a pure function of (seed, t) — splitmix64 keyed by
// (seed, t, element index) — and tpl_seek(t) repositions the stream, so
// a resumed training run replays exactly the batches the killed run
// would have seen.  tpu_patterns_torch/io/loader.py holds the Python
// side; tests/test_torch_io.py pins the contract (cross-instance
// determinism, seek equivalence, prefetch-ahead behavior, and batches
// equal to the JAX package's loader, whose csrc/loader.cc this copies).
//
// Concurrency model: one mutex + two condvars around a ring of
// `n_buffers` slots; `workers` producer threads claim step numbers and
// fill slot (step % n_buffers) with the slot's generation gate keeping
// writers exactly n_buffers ahead of the consumer.  tpl_next() blocks
// until the NEXT sequential step's slot is filled and releases the slot
// the consumer previously held.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, well-mixed, and trivially portable — the point is a
// deterministic stream, not cryptography.
static inline uint64_t mix64(uint64_t z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// uniform in [-1, 1): 53-bit mantissa path, cast to float at the end
static inline float to_unit(uint64_t bits) {
  const double u = (double)(bits >> 11) * (1.0 / 9007199254740992.0);
  return (float)(2.0 * u - 1.0);
}

struct Loader {
  uint64_t seed;
  int64_t elems;        // floats per batch
  int n_buffers;
  std::vector<std::vector<float>> ring;
  std::vector<int64_t> slot_step;  // which step each slot holds; -1 empty

  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  int64_t next_fill;     // next step a producer may claim
  int64_t next_consume;  // next step tpl_next will hand out
  std::atomic<int64_t> filled_total{0};
  uint64_t epoch;  // bumped by seek: stale fills are discarded
  bool stop;
  std::vector<std::thread> workers;

  Loader(uint64_t seed_, int64_t elems_, int n_buffers_, int n_threads)
      : seed(seed_),
        elems(elems_),
        n_buffers(n_buffers_),
        ring(n_buffers_),
        slot_step(n_buffers_, -1),
        next_fill(0),
        next_consume(0),
        epoch(0),
        stop(false) {
    for (auto& b : ring) b.resize((size_t)elems);
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { work(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv_produce.notify_all();
    cv_consume.notify_all();
    for (auto& w : workers) w.join();
  }

  void fill(float* dst, int64_t step) const {
    const uint64_t key = mix64(seed ^ mix64((uint64_t)step));
    for (int64_t i = 0; i < elems; ++i)
      dst[i] = to_unit(mix64(key ^ (uint64_t)i));
  }

  void work() {
    // Producers synthesize into thread-LOCAL scratch and commit to the
    // ring under the lock only if their epoch is still current.  A
    // stale producer (seek raced its fill) therefore never touches the
    // ring at all — without the scratch, an in-flight stale fill would
    // keep writing its slot unlocked while a new-epoch producer or the
    // consumer uses it (a torn-data race, not just a dropped batch).
    // The commit memcpy is serialized by the lock; synthesis (the slow
    // part) stays parallel.
    std::vector<float> scratch((size_t)elems);
    std::unique_lock<std::mutex> l(mu);
    while (true) {
      // claim the next step whose slot is free.  The bound is
      // n_buffers - 1, NOT n_buffers: the consumer still READS the slot
      // of step next_consume-1 until its next tpl_next call, and step
      // next_consume-1 + n_buffers maps to that same slot — one slot of
      // the ring is always reserved for the outstanding pointer.
      while (!stop && next_fill >= next_consume + n_buffers - 1)
        cv_produce.wait(l);
      if (stop) return;
      const int64_t step = next_fill++;
      const uint64_t my_epoch = epoch;
      l.unlock();
      fill(scratch.data(), step);
      l.lock();
      if (my_epoch == epoch && !stop) {
        std::memcpy(ring[(size_t)(step % n_buffers)].data(),
                    scratch.data(), (size_t)elems * sizeof(float));
        slot_step[(size_t)(step % n_buffers)] = step;
        filled_total.fetch_add(1, std::memory_order_relaxed);
        cv_consume.notify_all();
      }
    }
  }

  const float* next(int64_t* step_out) {
    std::unique_lock<std::mutex> l(mu);
    const int64_t want = next_consume;
    while (!stop && slot_step[(size_t)(want % n_buffers)] != want)
      cv_consume.wait(l);
    if (stop) return nullptr;
    // handing out slot (want % n_buffers): the buffer the consumer held
    // before (want-1) becomes reclaimable via next_consume++; the slot
    // handed out NOW stays safe because producers stop n_buffers-1
    // ahead (see work()).  Single consumer assumed: tpl_next/tpl_seek
    // must not race each other (the Python wrapper is one thread).
    next_consume = want + 1;
    slot_step[(size_t)(want % n_buffers)] = -1;
    if (step_out) *step_out = want;
    cv_produce.notify_all();
    return ring[(size_t)(want % n_buffers)].data();
  }

  void seek(int64_t step) {
    std::lock_guard<std::mutex> l(mu);
    epoch++;
    next_fill = step;
    next_consume = step;
    for (auto& s : slot_step) s = -1;
    cv_produce.notify_all();
  }
};

}  // namespace

extern "C" {

void* tpl_create(uint64_t seed, int64_t elems, int n_buffers,
                 int n_threads) {
  if (elems <= 0 || n_buffers < 2 || n_threads < 1) return nullptr;
  return new Loader(seed, elems, n_buffers, n_threads);
}

void tpl_destroy(void* p) { delete (Loader*)p; }

const float* tpl_next(void* p, int64_t* step_out) {
  return ((Loader*)p)->next(step_out);
}

void tpl_seek(void* p, int64_t step) { ((Loader*)p)->seek(step); }

int64_t tpl_filled_total(void* p) {
  return ((Loader*)p)->filled_total.load(std::memory_order_relaxed);
}

// Synchronous reference: fill one buffer for `step` without any loader
// state — the oracle the tests compare the prefetched stream against.
void tpl_fill_reference(uint64_t seed, int64_t elems, int64_t step,
                        float* dst) {
  const uint64_t key = mix64(seed ^ mix64((uint64_t)step));
  for (int64_t i = 0; i < elems; ++i)
    dst[i] = to_unit(mix64(key ^ (uint64_t)i));
}

}  // extern "C"
