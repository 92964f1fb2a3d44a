// Bounds checks of the persistent kernels' global-memory indices and TMA
// box coordinates, compiled in only for the checked build.
//
// The card's machine has no memory checker (compute-sanitizer refuses the
// H100 there), so an index past its tensor surfaces only later, as some
// other op's "illegal memory access".  Built with -DRST_BOUNDS_CHECK
// (ops/_build.py, switched on by RST_BOUNDS_CHECK=1 in the environment and
// hashed into the library's name), RST_CHECK(idx, bound) traps when idx is
// outside [0, bound), after printing the source file, line, kernel (or
// helper) name, the expression, its value and the bound.  Without the flag
// it compiles to nothing, so the default libraries run the same code.
#pragma once

#ifdef RST_BOUNDS_CHECK
#include <cstdio>
#include <cstdlib>

// Device code traps (the launch fails with an error the wrapper raises);
// host code (the launch loops of the .cuh helpers) aborts.
__host__ __device__ inline void rst_check_failed() {
#ifdef __CUDA_ARCH__
  __trap();
#else
  abort();
#endif
}

#define RST_CHECK(idx, bound)                                                         \
  do {                                                                                \
    const long long rst_i_ = (long long)(idx), rst_b_ = (long long)(bound);           \
    if (rst_i_ < 0 || rst_i_ >= rst_b_) {                                             \
      printf("RST_CHECK %s:%d %s: %s = %lld outside [0, %lld)\n", __FILE__, __LINE__, \
             __func__, #idx, rst_i_, rst_b_);                                         \
      rst_check_failed();                                                             \
    }                                                                                 \
  } while (0)
#else
#define RST_CHECK(idx, bound) \
  do {                        \
  } while (0)
#endif
