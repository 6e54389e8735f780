// Native time-ordered sensor dispatcher.
//
// Reference counterpart: dispatch_queue (src/trajectory/dispatch.h:59-258)
// — per-sensor FIFO queues with monotonicity filtering, a 40-message
// watermark before dispatch starts, and strictly time-ordered pops of the
// globally oldest buffered message.  The reference runs this as a mutexed
// thread; here it is a deterministic function of the timestamps (offline
// merge) plus a streaming queue class for online use, both behind a C API
// consumed via ctypes (no pybind11 in this image).
//
// Built by liwslam_torch/io/dispatch.py (g++ -O2 -shared -fPIC) at first use.

#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <vector>

namespace {

constexpr double kTimeMax = std::numeric_limits<double>::max();

struct Queue {
    std::deque<std::pair<double, long>> buf;  // (time, original index)
    double last_accepted = -kTimeMax;         // per-sensor monotonicity
    long produced = 0;
    bool enabled = true;
};

}  // namespace

extern "C" {

// Offline merge.  times[s][0..counts[s]) are each sensor's message stamps
// (already in arrival order).  Fills out_sensor/out_index with the
// dispatch order; returns the number of dispatched messages.
//
// watermark: dispatch only proceeds while every enabled sensor holds >=
// watermark buffered messages (dispatch.h:202-204).  drain != 0 processes
// the tail after all inputs are exhausted (the reference would block
// waiting for more data; offline runs want the tail).
long dispatch_merge(const double** times, const long* counts, int n_sensors,
                    const uint8_t* enabled, int watermark, int drain,
                    int32_t* out_sensor, int64_t* out_index) {
    std::vector<Queue> qs(n_sensors);
    std::vector<long> next(n_sensors, 0);
    for (int s = 0; s < n_sensors; ++s) qs[s].enabled = enabled ? enabled[s] != 0 : true;

    double last_dispatch = -kTimeMax;
    long n_out = 0;
    bool feeding = true;

    auto feed_one = [&]() -> bool {
        // interleave feeding round-robin by time: push the earliest
        // next-unconsumed message among all sensors (models arrival order)
        int best = -1;
        double best_t = kTimeMax;
        for (int s = 0; s < n_sensors; ++s) {
            if (next[s] < counts[s] && times[s][next[s]] < best_t) {
                best_t = times[s][next[s]];
                best = s;
            }
        }
        if (best < 0) return false;
        double t = times[best][next[best]];
        long idx = next[best]++;
        Queue& q = qs[best];
        // add_*_msg filters (dispatch.h:110-119)
        if (t <= last_dispatch) return true;
        if (!q.buf.empty() && q.buf.back().first >= t) return true;
        if (t <= q.last_accepted) return true;
        q.last_accepted = t;
        q.buf.emplace_back(t, idx);
        return true;
    };

    auto watermark_ok = [&]() -> bool {
        for (int s = 0; s < n_sensors; ++s)
            if (qs[s].enabled && (long)qs[s].buf.size() < watermark) return false;
        return true;
    };

    while (true) {
        // fill until the watermark holds or input is exhausted
        while (!watermark_ok() && feeding) feeding = feed_one();
        if (!watermark_ok() && !drain) break;

        // pop the globally oldest buffered message (dispatch.h:210-231)
        int oldest = -1;
        double oldest_t = kTimeMax;
        for (int s = 0; s < n_sensors; ++s) {
            if (!qs[s].enabled) continue;
            if (qs[s].buf.empty()) { oldest = -1; break; }
            if (qs[s].buf.front().first < oldest_t) {
                oldest_t = qs[s].buf.front().first;
                oldest = s;
            }
        }
        if (oldest < 0) {
            // some enabled queue is empty: try to feed more, else finish
            if (feeding) { feeding = feed_one(); if (feeding) continue; }
            // drain remaining non-empty queues in time order
            bool any = false;
            oldest_t = kTimeMax;
            for (int s = 0; s < n_sensors; ++s) {
                if (!qs[s].buf.empty() && qs[s].buf.front().first < oldest_t) {
                    oldest_t = qs[s].buf.front().first;
                    oldest = s;
                    any = true;
                }
            }
            if (!any) break;
            if (!drain) break;
        }
        Queue& q = qs[oldest];
        auto [t, idx] = q.buf.front();
        q.buf.pop_front();
        if (t <= last_dispatch) continue;
        last_dispatch = t;
        out_sensor[n_out] = oldest;
        out_index[n_out] = idx;
        ++n_out;
    }
    return n_out;
}

// ---------------------------------------------------------------------
// Streaming queue (online mode)

struct DispatchQueue {
    std::vector<Queue> qs;
    double last_dispatch = -kTimeMax;
    int watermark;
};

void* dq_create(int n_sensors, const uint8_t* enabled, int watermark) {
    auto* d = new DispatchQueue;
    d->qs.resize(n_sensors);
    for (int s = 0; s < n_sensors; ++s)
        d->qs[s].enabled = enabled ? enabled[s] != 0 : true;
    d->watermark = watermark;
    return d;
}

void dq_destroy(void* h) { delete static_cast<DispatchQueue*>(h); }

// returns 1 if accepted, 0 if dropped (late / non-monotonic)
int dq_add(void* h, int sensor, double t, int64_t index) {
    auto* d = static_cast<DispatchQueue*>(h);
    Queue& q = d->qs[sensor];
    if (t <= d->last_dispatch) return 0;
    if (!q.buf.empty() && q.buf.back().first >= t) return 0;
    q.buf.emplace_back(t, index);
    return 1;
}

// pops the globally oldest message if the watermark allows; returns 1 and
// fills (sensor, index, time), else 0.
int dq_pop(void* h, int32_t* sensor, int64_t* index, double* time) {
    auto* d = static_cast<DispatchQueue*>(h);
    for (auto& q : d->qs)
        if (q.enabled && (long)q.buf.size() < d->watermark) return 0;
    int oldest = -1;
    double oldest_t = kTimeMax;
    for (size_t s = 0; s < d->qs.size(); ++s) {
        if (!d->qs[s].enabled) continue;
        if (d->qs[s].buf.empty()) return 0;
        if (d->qs[s].buf.front().first < oldest_t) {
            oldest_t = d->qs[s].buf.front().first;
            oldest = (int)s;
        }
    }
    if (oldest < 0) return 0;
    auto [t, idx] = d->qs[oldest].buf.front();
    d->qs[oldest].buf.pop_front();
    if (t <= d->last_dispatch) return dq_pop(h, sensor, index, time);
    d->last_dispatch = t;
    *sensor = oldest;
    *index = idx;
    *time = t;
    return 1;
}

}  // extern "C"
