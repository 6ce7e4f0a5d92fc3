// ThreadSanitizer stress harness for the SPSC ring (tempest_tpu/native).
//
// Builds host_core.cpp together with this main under -fsanitize=thread and
// hammers put/take from concurrent producer/consumer threads; any data race
// in the ring's locking shows up as a TSan report (non-zero exit).  This is
// the framework's race-detection story (SURVEY.md §5 — the reference has
// none; its thread safety is by construction and untested).
//
// Build+run (see tests/test_native_tsan.py):
//   g++ -O1 -g -std=c++17 -fsanitize=thread host_core.cpp ring_stress.cpp \
//       -o ring_stress -lpthread && ./ring_stress

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

extern "C" {
struct Ring;
Ring* ring_create(int64_t block_floats, int64_t depth);
void ring_destroy(Ring*);
void ring_put(Ring*, const float*);
int ring_take(Ring*, float*, double timeout_ms);
void ring_close(Ring*);
int64_t ring_overflows(Ring*);
int64_t ring_consumed(Ring*);
int64_t ring_produced(Ring*);
int64_t ring_available(Ring*);
}

int main() {
    constexpr int64_t kBlock = 4096;
    constexpr int64_t kDepth = 8;
    constexpr int kBlocks = 20000;
    Ring* ring = ring_create(kBlock, kDepth);
    if (!ring) return 2;

    std::atomic<bool> ok{true};

    std::thread producer([&] {
        std::vector<float> buf(kBlock);
        for (int i = 0; i < kBlocks; ++i) {
            // Every float in block i carries the value i so the consumer can
            // verify blocks are delivered whole (no torn copies).
            for (auto& v : buf) v = static_cast<float>(i);
            ring_put(ring, buf.data());
        }
        ring_close(ring);
    });

    std::thread consumer([&] {
        std::vector<float> buf(kBlock);
        while (ring_take(ring, buf.data(), 2000.0)) {
            const float first = buf[0];
            for (int64_t j = 1; j < kBlock; ++j) {
                if (buf[j] != first) {  // torn block ⇒ race in the copy path
                    ok = false;
                    return;
                }
            }
        }
    });

    // Health poller: reads every counter *while* put/take mutate them — the
    // live StreamingRuntime.health() pattern.  An unlocked getter is a data
    // race TSan reports here.
    std::atomic<bool> stop_poll{false};
    std::thread poller([&] {
        int64_t sink = 0;
        while (!stop_poll.load(std::memory_order_relaxed)) {
            sink += ring_overflows(ring) + ring_produced(ring) +
                    ring_consumed(ring) + ring_available(ring);
        }
        if (sink < 0) std::printf("");  // keep the reads alive
    });

    producer.join();
    consumer.join();
    stop_poll = true;
    poller.join();
    const int64_t consumed = ring_consumed(ring);
    const int64_t overflows = ring_overflows(ring);
    ring_destroy(ring);
    if (!ok) {
        std::fprintf(stderr, "FAIL: torn block observed\n");
        return 1;
    }
    if (consumed + overflows != kBlocks) {
        std::fprintf(stderr, "FAIL: consumed %lld + overflows %lld != %d\n",
                     static_cast<long long>(consumed),
                     static_cast<long long>(overflows), kBlocks);
        return 1;
    }
    std::printf("OK consumed=%lld overflows=%lld\n",
                static_cast<long long>(consumed),
                static_cast<long long>(overflows));
    return 0;
}
