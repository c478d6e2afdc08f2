// Threading helper for the native host extensions (osod_eval.cpp, dataloader.cpp).
#ifndef RUNIA_NATIVE_PARALLEL_UTIL_H_
#define RUNIA_NATIVE_PARALLEL_UTIL_H_

#include <algorithm>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>

namespace runia_native {

// Split [0, n_items) into contiguous chunks, one std::thread per chunk.
// Call only with the GIL released; fn must not touch Python state.
inline void parallel_for(int64_t n_items, int num_threads,
                         const std::function<void(int64_t, int64_t)>& fn) {
  if (num_threads <= 1 || n_items <= 1) {
    fn(0, n_items);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n_items + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t begin = t * chunk;
    const int64_t end = std::min<int64_t>(begin + chunk, n_items);
    if (begin >= end) break;
    threads.emplace_back(fn, begin, end);
  }
  for (auto& th : threads) th.join();
}

}  // namespace runia_native

#endif  // RUNIA_NATIVE_PARALLEL_UTIL_H_
