// Shared helpers of the port's CUDA kernels (plain C interface, ctypes-bound).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GPS_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes shared with ops/_build.py.
enum GpsDtype { GPS_F32 = 0, GPS_F64 = 1 };

template <typename T>
struct Limits;

template <>
struct Limits<float> {
  __device__ static float inf() { return __int_as_float(0x7f800000); }
  __device__ static float tiny() { return 1.17549435082228750797e-38f; }  // FLT_MIN
};

template <>
struct Limits<double> {
  __device__ static double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
  __device__ static double tiny() { return 2.22507385850720138309e-308; }  // DBL_MIN
};

// The 16-byte vector of T (4 float32 or 2 float64): one shared-memory load.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};
