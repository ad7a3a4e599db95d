// Shared worker-thread-count policy for the native runtime.
//
// GAT_THREADS=N overrides the hardware default everywhere threads are
// spawned; GAT_THREADS=1 forces every threaded path sequential, which is
// the determinism oracle for tests/test_thread_determinism.py (outputs
// must be byte-identical at any thread count).
#pragma once

#include <cstdlib>
#include <thread>

inline int gat_thread_count(int cap = 16) {
  static int env_threads = [] {
    const char* e = std::getenv("GAT_THREADS");
    if (!e || !*e) return -1;
    int v = std::atoi(e);
    return v >= 1 ? v : -1;
  }();
  if (env_threads > 0) return env_threads < cap ? env_threads : cap;
  int hw = (int)std::thread::hardware_concurrency();
  int n = hw > 1 ? hw : 1;
  return n < cap ? n : cap;
}
