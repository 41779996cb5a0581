// OpenMP when the compiler provides it (-fopenmp), a serial stand-in
// otherwise: build.py falls back to a serial build where the toolchain
// ships no OpenMP runtime, and the `#pragma omp` lines then compile away.
#pragma once
#ifdef _OPENMP
#include <omp.h>
#else
static inline int omp_get_max_threads() { return 1; }
static inline int omp_get_thread_num() { return 0; }
#endif
