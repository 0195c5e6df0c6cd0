// Host-side request scheduler of the serving engines (C++ core).
//
// The port's copy of the JAX package's ``native/serving_native.cpp``: the
// queue, batch formation, priority, abort and latency accounting live
// below the interpreter lock; Python holds only the request payloads
// (keyed by the ids this module assigns) and the device work.
//
// Semantics:
//  - submit(priority): ids are monotonically increasing; dequeue order is
//    (higher priority first, FIFO within a priority);
//  - collect(max_out, first_timeout_s, batch_wait_s): blocks up to
//    first_timeout_s for the first request, then keeps gathering until
//    max_out requests are taken or batch_wait_s elapses from the FIRST
//    take (the dynamic-batching window);
//  - collect_nowait(max_out): non-blocking admission (continuous batching
//    at decode-chunk boundaries);
//  - abort(id): removes a QUEUED request (returns 1) -- once collected the
//    request belongs to the Python side;
//  - complete(id): stamps end-to-end latency for stats.
//
// Build: compiled at first use by native/__init__.py (g++ -O3 -shared);
// no dependencies beyond the C++17 standard library.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <unordered_map>

namespace {

using clk = std::chrono::steady_clock;

double now_s() {
    return std::chrono::duration<double>(clk::now().time_since_epoch()).count();
}

struct Request {
    int64_t id;
    int64_t priority;
    double  submitted_s;
};

struct Engine {
    std::mutex mu;
    std::condition_variable cv;
    // dequeue order: highest priority first, FIFO (lowest id) within it
    std::map<std::pair<int64_t, int64_t>, Request> queue;  // (-prio, id) -> req
    std::unordered_map<int64_t, double> in_flight;         // id -> submitted_s
    std::atomic<int64_t> next_id{0};
    bool woken = false;   // wake(): abandons in-progress collect waits

    // stats
    int64_t n_submitted = 0, n_collected = 0, n_aborted = 0, n_completed = 0;
    int64_t n_batches = 0;
    double  total_queue_wait_s = 0.;   // submit -> collect
    double  total_latency_s = 0.;      // submit -> complete
};

}  // namespace

extern "C" {

void* serving_engine_create() {
    return new Engine();
}

void serving_engine_destroy(void* h) {
    delete static_cast<Engine*>(h);
}

int64_t serving_engine_submit(void* h, int64_t priority) {
    Engine* e = static_cast<Engine*>(h);
    int64_t id = e->next_id.fetch_add(1);
    {
        std::lock_guard<std::mutex> lock(e->mu);
        e->queue.emplace(std::make_pair(-priority, id),
                         Request{id, priority, now_s()});
        e->n_submitted += 1;
    }
    e->cv.notify_one();
    return id;
}

int serving_engine_abort(void* h, int64_t id) {
    Engine* e = static_cast<Engine*>(h);
    std::lock_guard<std::mutex> lock(e->mu);
    for (auto it = e->queue.begin(); it != e->queue.end(); ++it) {
        if (it->second.id == id) {
            e->queue.erase(it);
            e->n_aborted += 1;
            return 1;
        }
    }
    return 0;
}

static int take_locked(Engine* e, int64_t* out_ids, int max_out) {
    int n = 0;
    double t = now_s();
    while (n < max_out && !e->queue.empty()) {
        auto it = e->queue.begin();
        out_ids[n++] = it->second.id;
        e->total_queue_wait_s += t - it->second.submitted_s;
        e->in_flight[it->second.id] = it->second.submitted_s;
        e->n_collected += 1;
        e->queue.erase(it);
    }
    return n;
}

int serving_engine_collect(void* h, int64_t* out_ids, int max_out,
                           double first_timeout_s, double batch_wait_s) {
    Engine* e = static_cast<Engine*>(h);
    std::unique_lock<std::mutex> lock(e->mu);
    auto ready = [e] { return !e->queue.empty() || e->woken; };
    if (e->queue.empty()) {
        e->cv.wait_for(lock,
                       std::chrono::duration<double>(first_timeout_s), ready);
        if (e->woken) { e->woken = false; return 0; }
        if (e->queue.empty()) return 0;
    }
    int n = take_locked(e, out_ids, max_out);
    // dynamic-batching window: keep gathering until full or the window ends
    auto deadline = clk::now() + std::chrono::duration_cast<clk::duration>(
        std::chrono::duration<double>(batch_wait_s));
    while (n < max_out) {
        if (!e->cv.wait_until(lock, deadline, ready))
            break;
        if (e->woken) { e->woken = false; break; }
        n += take_locked(e, out_ids + n, max_out - n);
    }
    if (n > 0) e->n_batches += 1;
    return n;
}

int serving_engine_collect_nowait(void* h, int64_t* out_ids, int max_out) {
    Engine* e = static_cast<Engine*>(h);
    std::lock_guard<std::mutex> lock(e->mu);
    return take_locked(e, out_ids, max_out);
}

void serving_engine_complete(void* h, int64_t id) {
    Engine* e = static_cast<Engine*>(h);
    std::lock_guard<std::mutex> lock(e->mu);
    auto it = e->in_flight.find(id);
    if (it == e->in_flight.end()) return;
    e->total_latency_s += now_s() - it->second;
    e->n_completed += 1;
    e->in_flight.erase(it);
}

int64_t serving_engine_pending(void* h) {
    Engine* e = static_cast<Engine*>(h);
    std::lock_guard<std::mutex> lock(e->mu);
    return static_cast<int64_t>(e->queue.size());
}

// which: 0 submitted, 1 collected, 2 aborted, 3 completed, 4 batches
int64_t serving_engine_stat(void* h, int which) {
    Engine* e = static_cast<Engine*>(h);
    std::lock_guard<std::mutex> lock(e->mu);
    switch (which) {
        case 0: return e->n_submitted;
        case 1: return e->n_collected;
        case 2: return e->n_aborted;
        case 3: return e->n_completed;
        case 4: return e->n_batches;
    }
    return -1;
}

// which: 0 mean queue wait, 1 mean end-to-end latency (seconds)
double serving_engine_mean_s(void* h, int which) {
    Engine* e = static_cast<Engine*>(h);
    std::lock_guard<std::mutex> lock(e->mu);
    if (which == 0)
        return e->n_collected ? e->total_queue_wait_s / e->n_collected : 0.;
    return e->n_completed ? e->total_latency_s / e->n_completed : 0.;
}

void serving_engine_wake(void* h) {
    Engine* e = static_cast<Engine*>(h);
    {
        std::lock_guard<std::mutex> lock(e->mu);
        e->woken = true;     // consumed by the next (or current) collect
    }
    e->cv.notify_all();
}

}  // extern "C"
