// host_core — native host-side runtime core for tempest_tpu.
//
// The TPU does the DSP; this library makes the *host* side of the streaming
// runtime native: lock-free-ish ring buffer for IQ blocks, interleaved-I/Q
// unpacking/conversion, and envelope precompute — the roles the reference
// delegates to Julia's threaded runtime (AtomicAbstractSDRs.jl:28-190) and
// to the SDR C drivers underneath AbstractSDRs.  Exposed through a plain C
// ABI consumed via ctypes (tempest_tpu/native/__init__.py); a pure-Python
// fallback exists, this path removes the GIL from the producer hot loop.
//
// Build: tempest_tpu/native/__init__.py builds this on first import
// (g++ -O3 -march=native -std=c++17 -shared -fPIC).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>

extern "C" {

// ---------------------------------------------------------------- ring buffer
// Single-producer single-consumer ring of fixed-size float32-complex blocks.
// Overwrite-oldest on overflow (never block the radio), counted.  Mirrors the
// semantics of the reference's AtomicCircularBuffer (circ_put!/circ_take!,
// AtomicAbstractSDRs.jl:161-190) with a condition-variable consumer wait
// instead of a spin-yield loop.
struct Ring {
    float*  arena;        // depth * block_floats
    int64_t block_floats; // floats per block (2 * complex samples)
    int64_t depth;
    int64_t write_idx;    // next slot to write
    int64_t count;        // unread blocks
    int64_t overflows;
    int64_t produced;
    int64_t consumed;
    int64_t last_seq;     // production sequence of the last block taken
    bool    closed;
    std::mutex m;
    std::condition_variable nonempty;
};

Ring* ring_create(int64_t block_floats, int64_t depth) {
    if (block_floats <= 0 || depth < 2) return nullptr;
    Ring* r = new (std::nothrow) Ring();
    if (!r) return nullptr;
    r->arena = new (std::nothrow) float[(size_t)(block_floats * depth)];
    if (!r->arena) { delete r; return nullptr; }
    r->block_floats = block_floats;
    r->depth = depth;
    r->write_idx = r->count = r->overflows = 0;
    r->produced = r->consumed = 0;
    r->last_seq = -1;
    r->closed = false;
    return r;
}

void ring_destroy(Ring* r) {
    if (!r) return;
    delete[] r->arena;
    delete r;
}

// Copy one block in; never blocks (drops oldest when full).
void ring_put(Ring* r, const float* data) {
    {
        std::lock_guard<std::mutex> lk(r->m);
        std::memcpy(r->arena + r->write_idx * r->block_floats, data,
                    (size_t)r->block_floats * sizeof(float));
        r->write_idx = (r->write_idx + 1) % r->depth;
        if (r->count == r->depth) r->overflows++;
        else r->count++;
        r->produced++;
    }
    r->nonempty.notify_one();
}

// Copy the oldest unread block out.  Blocks up to timeout_ms (<0: forever).
// Returns 1 on success, 0 on timeout/closed-and-empty.
int ring_take(Ring* r, float* out, double timeout_ms) {
    std::unique_lock<std::mutex> lk(r->m);
    auto ready = [r] { return r->count > 0 || r->closed; };
    if (timeout_ms < 0) {
        r->nonempty.wait(lk, ready);
    } else if (!r->nonempty.wait_for(
                   lk, std::chrono::duration<double, std::milli>(timeout_ms),
                   ready)) {
        return 0;
    }
    if (r->count == 0) return 0;  // closed and drained
    int64_t read_idx = (r->write_idx - r->count + r->depth) % r->depth;
    std::memcpy(out, r->arena + read_idx * r->block_floats,
                (size_t)r->block_floats * sizeof(float));
    // Unread blocks are the most recent `count` puts (overwrite drops the
    // oldest), so the delivered block's production sequence is
    // produced - count — consumers track their absolute stream position
    // across overflow drops with this.
    r->last_seq = r->produced - r->count;
    r->count--;
    r->consumed++;
    return 1;
}

void ring_close(Ring* r) {
    { std::lock_guard<std::mutex> lk(r->m); r->closed = true; }
    r->nonempty.notify_all();
}

// Counter getters take the mutex: these are polled live (health snapshots)
// while ring_put/ring_take mutate the counters under lock — an unlocked
// int64 read would be a data race (UB).
int64_t ring_overflows(Ring* r) { std::lock_guard<std::mutex> lk(r->m); return r->overflows; }
int64_t ring_available(Ring* r) { std::lock_guard<std::mutex> lk(r->m); return r->count; }
int64_t ring_produced(Ring* r)  { std::lock_guard<std::mutex> lk(r->m); return r->produced; }
int64_t ring_consumed(Ring* r)  { std::lock_guard<std::mutex> lk(r->m); return r->consumed; }
int64_t ring_last_seq(Ring* r)  { std::lock_guard<std::mutex> lk(r->m); return r->last_seq; }

// ------------------------------------------------------- sample conversion
// Interleaved int16 I/Q -> float32 interleaved, with scaling.  The unpack the
// reference does per-read in readComplexBinary (DatBinaryFiles.jl:60-65),
// here vectorizable by the compiler and GIL-free.
void iq_int16_to_float32(const int16_t* in, float* out, int64_t n_words,
                         float scale) {
    for (int64_t i = 0; i < n_words; ++i) out[i] = scale * (float)in[i];
}

// Interleaved float32 I/Q -> envelope |z| (AM demod on the host, for
// host-side fallbacks and validation; the TPU path does this on device).
void iq_envelope_f32(const float* iq, float* env, int64_t n_complex) {
    for (int64_t i = 0; i < n_complex; ++i) {
        float re = iq[2 * i], im = iq[2 * i + 1];
        env[i] = __builtin_sqrtf(re * re + im * im);
    }
}

// Interleaved float32 I/Q -> squared envelope |z|^2.
void iq_power_f32(const float* iq, float* pow_out, int64_t n_complex) {
    for (int64_t i = 0; i < n_complex; ++i) {
        float re = iq[2 * i], im = iq[2 * i + 1];
        pow_out[i] = re * re + im * im;
    }
}

}  // extern "C"
