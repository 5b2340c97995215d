// The eight scan combines of ops/scan.py:OPS that K1 (scan.cu,
// scan_lookback.cuh) and K2 (scan_tiled.cu) share, one copy of each, so the
// two scans cannot drift apart.
//
// Every combine writes its arithmetic in the order of the JAX combine it
// ports, so that results agree to rounding. The library is built with
// --fmad=false so no multiply-add is contracted behind the source's back.
//
// Argument order follows jax.lax.associative_scan: the accumulated composite
// is always the FIRST argument; under `reverse` that is the later composite
// (pallas_scan.py:137-142, 269-275). The scans below walk "scan order"
// indices k and touch position p = reverse ? n - 1 - k : k, so one code path
// serves both directions.
#pragma once

#include "common.cuh"

namespace {

constexpr int kScanThreads = 256;

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

// 3x3 helpers on row-major 9-arrays, summed in the order of
// kalman_parallel._mmul / _mvec: (x0*y0 + x1*y1) + x2*y2.
template <typename T>
__device__ __forceinline__ void mmul(const T* a, const T* b, T* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

template <typename T>
__device__ __forceinline__ void mvec(const T* a, const T* v, T* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = a[3 * i] * v[0] + a[3 * i + 1] * v[1] + a[3 * i + 2] * v[2];
}

template <typename T>
__device__ __forceinline__ void mT(const T* a, T* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o[3 * i + j] = a[3 * j + i];
}

// Adjugate inverse, kalman_parallel._minv.
template <typename T>
__device__ __forceinline__ void minv(const T* m, T* o) {
  const T c00 = m[4] * m[8] - m[5] * m[7];
  const T c01 = m[2] * m[7] - m[1] * m[8];
  const T c02 = m[1] * m[5] - m[2] * m[4];
  const T c10 = m[5] * m[6] - m[3] * m[8];
  const T c11 = m[0] * m[8] - m[2] * m[6];
  const T c12 = m[2] * m[3] - m[0] * m[5];
  const T c20 = m[3] * m[7] - m[4] * m[6];
  const T c21 = m[1] * m[6] - m[0] * m[7];
  const T c22 = m[0] * m[4] - m[1] * m[3];
  const T inv_det = T(1) / (m[0] * c00 + m[1] * c10 + m[2] * c20);
  o[0] = c00 * inv_det; o[1] = c01 * inv_det; o[2] = c02 * inv_det;
  o[3] = c10 * inv_det; o[4] = c11 * inv_det; o[5] = c12 * inv_det;
  o[6] = c20 * inv_det; o[7] = c21 * inv_det; o[8] = c22 * inv_det;
}

// (xx, xy, xz, yy, yz, zz) -> row-major 9-array (kalman_parallel._sym_expand).
template <typename T>
__device__ __forceinline__ void sym_expand(const T* s, T* o) {
  o[0] = s[0]; o[1] = s[1]; o[2] = s[2];
  o[3] = s[1]; o[4] = s[3]; o[5] = s[4];
  o[6] = s[2]; o[7] = s[4]; o[8] = s[5];
}

// Quaternion chain, kalman_parallel.parallel_quat_chain.combine (4 leaves).
template <typename T>
struct QuatChain {
  static constexpr int L = 4;
  __device__ static void identity(T* e) { e[0] = 0; e[1] = 0; e[2] = 0; e[3] = 1; }
  __device__ static void apply(const T* a, const T* b, T* o) {
    const T x1 = a[0], y1 = a[1], z1 = a[2], w1 = a[3];
    const T x2 = b[0], y2 = b[1], z2 = b[2], w2 = b[3];
    const T x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
    const T y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
    const T z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
    const T w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
    const T n = sqrt(x * x + y * y + z * z + w * w);
    const T inv = n > T(1e-9) ? T(1) / n : T(1);
    o[0] = x * inv; o[1] = y * inv; o[2] = z * inv; o[3] = w * inv;
  }
};

// Affine Kalman filter elements, kalman_parallel._combine_filter (27 leaves:
// A[9], b[3], C[6], eta[3], J[6]; C and J symmetric, upper triangle).
template <typename T>
struct Filter {
  static constexpr int L = 27;
  __device__ static void identity(T* e) {
#pragma unroll
    for (int i = 0; i < L; ++i) e[i] = 0;
    e[0] = 1; e[4] = 1; e[8] = 1;
  }
  __device__ static void apply(const T* e1, const T* e2, T* o) {
    const T* A1 = e1; const T* b1 = e1 + 9; const T* eta1 = e1 + 18;
    const T* A2 = e2; const T* b2 = e2 + 9; const T* eta2 = e2 + 18;
    T C1[9], J1[9], C2[9], J2[9];
    sym_expand(e1 + 12, C1); sym_expand(e1 + 21, J1);
    sym_expand(e2 + 12, C2); sym_expand(e2 + 21, J2);
    T tmp[9], M[9];
    mmul(C1, J2, tmp);  // I + C1 J2
    tmp[0] = tmp[0] + T(1); tmp[4] = tmp[4] + T(1); tmp[8] = tmp[8] + T(1);
    minv(tmp, M);
    T A2M[9];
    mmul(A2, M, A2M);
    mmul(A2M, A1, o);  // A
    T v[3], w[3];
    mvec(C1, eta2, v);
    v[0] = b1[0] + v[0]; v[1] = b1[1] + v[1]; v[2] = b1[2] + v[2];
    mvec(A2M, v, w);
    o[9] = w[0] + b2[0]; o[10] = w[1] + b2[1]; o[11] = w[2] + b2[2];  // b
    T A2MC1[9], A2T[9], C[9];
    mmul(A2M, C1, A2MC1);
    mT(A2, A2T);
    mmul(A2MC1, A2T, C);
    o[12] = C[0] + C2[0]; o[13] = C[1] + C2[1]; o[14] = C[2] + C2[2];
    o[15] = C[4] + C2[4]; o[16] = C[5] + C2[5]; o[17] = C[8] + C2[8];  // C
    T MA1[9], A1tMt[9];
    mmul(M, A1, MA1);
    mT(MA1, A1tMt);
    mvec(J2, b1, v);
    v[0] = eta2[0] - v[0]; v[1] = eta2[1] - v[1]; v[2] = eta2[2] - v[2];
    mvec(A1tMt, v, w);
    o[18] = w[0] + eta1[0]; o[19] = w[1] + eta1[1]; o[20] = w[2] + eta1[2];  // eta
    T AJ[9], J[9];
    mmul(A1tMt, J2, AJ);
    mmul(AJ, A1, J);
    o[21] = J[0] + J1[0]; o[22] = J[1] + J1[1]; o[23] = J[2] + J1[2];
    o[24] = J[4] + J1[4]; o[25] = J[5] + J1[5]; o[26] = J[8] + J1[8];  // J
  }
};

// RTS suffix, kalman_parallel.fuse_ekf_rts_parallel.combine (12 leaves:
// M[9], c[3]). First argument = accumulated (later-in-time) composite.
template <typename T>
struct RtsSuffix {
  static constexpr int L = 12;
  __device__ static void identity(T* e) {
#pragma unroll
    for (int i = 0; i < L; ++i) e[i] = 0;
    e[0] = 1; e[4] = 1; e[8] = 1;
  }
  __device__ static void apply(const T* first, const T* second, T* o) {
    const T* M2 = first; const T* c2 = first + 9;
    const T* M1 = second; const T* c1 = second + 9;
    mmul(M1, M2, o);
    T v[3];
    mvec(M1, c2, v);
    o[9] = v[0] + c1[0]; o[10] = v[1] + c1[1]; o[11] = v[2] + c1[2];
  }
};

// Normalised 2x2 homogeneous products, tridiag._mobius_combine (4 leaves).
template <typename T>
struct Mobius {
  static constexpr int L = 4;
  __device__ static void identity(T* e) { e[0] = 1; e[1] = 0; e[2] = 0; e[3] = 1; }
  __device__ static void apply(const T* p, const T* q, T* o) {
    const T m00 = q[0] * p[0] + q[1] * p[2];
    const T m01 = q[0] * p[1] + q[1] * p[3];
    const T m10 = q[2] * p[0] + q[3] * p[2];
    const T m11 = q[2] * p[1] + q[3] * p[3];
    const T scale = tmax(tmax(fabs(m00), fabs(m01)), tmax(fabs(m10), fabs(m11)));
    const T inv = T(1) / tmax(scale, Limits<T>::tiny());
    o[0] = m00 * inv; o[1] = m01 * inv; o[2] = m10 * inv; o[3] = m11 * inv;
  }
};

// Affine composition (alpha, beta[3]), tridiag._affine_combine (4 leaves).
template <typename T>
struct Affine3 {
  static constexpr int L = 4;
  __device__ static void identity(T* e) { e[0] = 1; e[1] = 0; e[2] = 0; e[3] = 0; }
  __device__ static void apply(const T* a, const T* b, T* o) {
    o[0] = b[0] * a[0];
#pragma unroll
    for (int i = 1; i < 4; ++i) o[i] = b[0] * a[i] + b[i];
  }
};

// Segment-structure scans, alignment._add/_max/_min_combine.
template <typename T>
struct Add2 {
  static constexpr int L = 2;
  __device__ static void identity(T* e) { e[0] = 0; e[1] = 0; }
  __device__ static void apply(const T* a, const T* b, T* o) { o[0] = a[0] + b[0]; o[1] = a[1] + b[1]; }
};

template <typename T>
struct Max3 {
  static constexpr int L = 3;
  __device__ static void identity(T* e) { e[0] = e[1] = e[2] = -Limits<T>::inf(); }
  __device__ static void apply(const T* a, const T* b, T* o) {
#pragma unroll
    for (int i = 0; i < 3; ++i) o[i] = tmax(a[i], b[i]);
  }
};

template <typename T>
struct Min3 {
  static constexpr int L = 3;
  __device__ static void identity(T* e) { e[0] = e[1] = e[2] = Limits<T>::inf(); }
  __device__ static void apply(const T* a, const T* b, T* o) {
#pragma unroll
    for (int i = 0; i < 3; ++i) o[i] = tmin(a[i], b[i]);
  }
};

template <int L, typename T>
__device__ __forceinline__ void copy_leaves(const T* src, T* dst) {
#pragma unroll
  for (int l = 0; l < L; ++l) dst[l] = src[l];
}

// Dynamic shared memory above 48 KB needs the opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Op codes are the order of ops/scan.py:OPS. `Launch<Op, T>::run(args...)`
// for the combine named by `op`; cudaErrorInvalidValue for an unknown op.
template <template <class, typename> class Launch, typename T, typename... Args>
cudaError_t dispatch_op(int op, Args... args) {
  switch (op) {
    case 0: return Launch<QuatChain<T>, T>::run(args...);
    case 1: return Launch<Filter<T>, T>::run(args...);
    case 2: return Launch<RtsSuffix<T>, T>::run(args...);
    case 3: return Launch<Mobius<T>, T>::run(args...);
    case 4: return Launch<Affine3<T>, T>::run(args...);
    case 5: return Launch<Add2<T>, T>::run(args...);
    case 6: return Launch<Max3<T>, T>::run(args...);
    case 7: return Launch<Min3<T>, T>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
