// Host-side native runtime for approximatenn.
//
// The reference implements its entire host runtime in C: the bucket-table
// histogram+scatter (/root/reference/alg.c:252-266), the brute-force
// rank/recall oracle (/root/reference/test_correctness.c:207-262), and the
// harness IO. These are their C++ equivalents for this framework — the
// device path is JAX/XLA, but ground-truth generation for multi-million
// point corpora and bit-exact host validation of the device bucket build
// belong on the host, multithreaded, at native speed.
//
// Exposed as a plain C ABI consumed via ctypes (native/lib.py).
// Build: see native/build.py (g++ -O3 -shared -fPIC -pthread).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Bucket-table construction — the exact host semantics of the reference's
// second_half histogram phase (alg.c:252-266): count codes per bucket,
// tmax = max occupancy, table[bucket][slot] = point ids in FIRST-SEEN order
// (the reference appends in point order), sentinel-padded to capacity.
// Returns tmax. capacity <= 0 means "use tmax" and requires the caller to
// size `table` as n_buckets * tmax via a first call with table == nullptr.
// ---------------------------------------------------------------------------
int32_t ann_bucket_table(const int32_t* codes, int64_t n, int32_t n_buckets,
                         int32_t capacity, int32_t sentinel,
                         int32_t* counts /* n_buckets */,
                         int32_t* table /* n_buckets * capacity, or null */) {
  std::memset(counts, 0, sizeof(int32_t) * (size_t)n_buckets);
  int32_t tmax = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t c = codes[i];
    if (c < 0 || c >= n_buckets) return -1;
    tmax = std::max(tmax, ++counts[c]);
  }
  if (table == nullptr) return tmax;
  if (capacity <= 0) capacity = tmax;
  for (int64_t b = 0; b < (int64_t)n_buckets * capacity; ++b) table[b] = sentinel;
  std::vector<int32_t> fill((size_t)n_buckets, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t c = codes[i];
    if (fill[c] < capacity) table[(int64_t)c * capacity + fill[c]++] = (int32_t)i;
  }
  return tmax;
}

// ---------------------------------------------------------------------------
// Multithreaded exact k-NN (squared L2) — the ground-truth oracle
// (role of test_correctness.c:207-227 at corpus scale). Queries are
// partitioned across threads; per query a bounded max-heap over the k best.
// exclude_self >= 0 treats query q as point id (q + exclude_self) and skips
// it (the oracle's self-match exclusion, test_correctness.c:229-244 —
// there via a ULONG_MAX sentinel).
// ---------------------------------------------------------------------------
static inline float sqdist(const float* a, const float* b, int64_t d) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int64_t j = 0;
  for (; j + 4 <= d; j += 4) {
    float d0 = a[j] - b[j], d1 = a[j + 1] - b[j + 1];
    float d2 = a[j + 2] - b[j + 2], d3 = a[j + 3] - b[j + 3];
    s0 += d0 * d0; s1 += d1 * d1; s2 += d2 * d2; s3 += d3 * d3;
  }
  for (; j < d; ++j) { float dd = a[j] - b[j]; s0 += dd * dd; }
  return s0 + s1 + s2 + s3;
}

void ann_brute_force(const float* points, int64_t n, int64_t d,
                     const float* queries, int64_t m, int32_t k,
                     int64_t exclude_self_offset,  // <0: no exclusion
                     int32_t* out_ids /* m*k */, float* out_dists /* m*k */,
                     int32_t n_threads) {
  if (n_threads <= 0)
    n_threads = (int32_t)std::max(1u, std::thread::hardware_concurrency());
  // NOTE: k is the caller's output stride even when k > n; rows with fewer
  // than k candidates are sentinel-padded below.
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    // (dist, id) max-heap of size k per query
    std::vector<std::pair<float, int32_t>> heap((size_t)k);
    for (;;) {
      int64_t q = next.fetch_add(1);
      if (q >= m) return;
      const float* qv = queries + q * d;
      int64_t skip = exclude_self_offset >= 0 ? q + exclude_self_offset : -1;
      int32_t filled = 0;
      auto cmp = [](const std::pair<float, int32_t>& a,
                    const std::pair<float, int32_t>& b) {
        return a.first < b.first;  // max-heap by distance
      };
      for (int64_t i = 0; i < n; ++i) {
        if (i == skip) continue;
        float dd = sqdist(qv, points + i * d, d);
        if (filled < k) {
          heap[filled++] = {dd, (int32_t)i};
          if (filled == k) std::make_heap(heap.begin(), heap.end(), cmp);
        } else if (dd < heap.front().first) {
          std::pop_heap(heap.begin(), heap.end(), cmp);
          heap.back() = {dd, (int32_t)i};
          std::push_heap(heap.begin(), heap.end(), cmp);
        }
      }
      std::sort(heap.begin(), heap.begin() + filled);
      for (int32_t j = 0; j < k; ++j) {
        bool real = j < filled;
        out_ids[q * k + j] = real ? heap[j].second : (int32_t)n;
        out_dists[q * k + j] =
            real ? heap[j].first : std::numeric_limits<float>::infinity();
      }
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

// ---------------------------------------------------------------------------
// Rank scoring — the reference's recall metrics (test_correctness.c:169-262)
// at native speed: for each query, compute every guess's true rank in the
// exact distance ordering. Ranks of sentinel guesses (id >= n) are n.
// Emits per-query (sum of ranks, count of rank >= k, max rank) so the
// Python caller aggregates exactly like compute_score/cscore.
// ---------------------------------------------------------------------------
void ann_rank_guesses(const float* points, int64_t n, int64_t d,
                      const float* queries, int64_t m,
                      const int32_t* guesses /* m*k */, int32_t k,
                      int64_t exclude_self_offset,
                      int64_t* out_rank_sum /* m */,
                      int32_t* out_miss /* m */, int32_t* out_max /* m */,
                      int32_t n_threads) {
  if (n_threads <= 0)
    n_threads = (int32_t)std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<float> dd((size_t)n);
    for (;;) {
      int64_t q = next.fetch_add(1);
      if (q >= m) return;
      const float* qv = queries + q * d;
      int64_t skip = exclude_self_offset >= 0 ? q + exclude_self_offset : -1;
      for (int64_t i = 0; i < n; ++i)
        dd[i] = (i == skip) ? std::numeric_limits<float>::infinity()
                            : sqdist(qv, points + i * d, d);
      int64_t sum = 0;
      int32_t miss = 0, mx = 0;
      for (int32_t j = 0; j < k; ++j) {
        int32_t g = guesses[q * k + j];
        int32_t rank;
        if (g < 0 || g >= n || g == skip) {
          rank = (int32_t)n;  // sentinel / invalid guess: worst rank
        } else {
          // rank = how many points are strictly closer (ties don't count
          // against the guess, matching inv_ans's strict ordering)
          float gd = dd[g];
          int64_t closer = 0;
          for (int64_t i = 0; i < n; ++i) closer += dd[i] < gd;
          rank = (int32_t)closer;
        }
        sum += rank;
        miss += rank >= k;
        mx = std::max(mx, rank);
      }
      out_rank_sum[q] = sum;
      out_miss[q] = miss;
      out_max[q] = mx;
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

// Version/capability probe for the ctypes wrapper.
int32_t ann_native_abi(void) { return 1; }

}  // extern "C"
