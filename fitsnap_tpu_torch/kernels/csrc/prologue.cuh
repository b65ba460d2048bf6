// The SNAP pair prologue with forward-mode tangents, shared by the kernels
// that need it (K1 pair_u_duals, and K9 / K11 / K11T of nn_grid.cu): the
// Cayley-Klein parameters (ar, ai, br, bi) and the switching weight w of a
// pair, each as a dual number carrying its three displacement tangents.
// The closed form of fitsnap_tpu/ops/snap.py `_ck_prologue` and of its
// jax.jvp, at the working type T (double, or float for K1's float32
// instantiation, where every scalar is rounded to float as the JAX
// package's weakly typed Python floats are).
#pragma once

#include <math.h>

namespace {

template <typename T>
struct DualT {
  T v;
  T d[3];
};
using Dual = DualT<double>;

template <typename T>
__device__ __forceinline__ DualT<T> dconst(T v) {
  DualT<T> r;
  r.v = v;
  r.d[0] = r.d[1] = r.d[2] = T(0);
  return r;
}

template <typename T>
__device__ __forceinline__ DualT<T> operator+(DualT<T> a, DualT<T> b) {
  DualT<T> r;
  r.v = a.v + b.v;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] + b.d[c];
  return r;
}

template <typename T>
__device__ __forceinline__ DualT<T> operator-(DualT<T> a, DualT<T> b) {
  DualT<T> r;
  r.v = a.v - b.v;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] - b.d[c];
  return r;
}

template <typename T>
__device__ __forceinline__ DualT<T> operator-(DualT<T> a) {
  DualT<T> r;
  r.v = -a.v;
  for (int c = 0; c < 3; ++c) r.d[c] = -a.d[c];
  return r;
}

template <typename T>
__device__ __forceinline__ DualT<T> operator*(DualT<T> a, DualT<T> b) {
  DualT<T> r;
  r.v = a.v * b.v;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] * b.v + a.v * b.d[c];
  return r;
}

template <typename T>
__device__ __forceinline__ DualT<T> operator+(DualT<T> a, T s) {
  a.v += s;
  return a;
}

template <typename T>
__device__ __forceinline__ DualT<T> operator-(DualT<T> a, T s) {
  a.v -= s;
  return a;
}

template <typename T>
__device__ __forceinline__ DualT<T> operator*(DualT<T> a, T s) {
  DualT<T> r;
  r.v = a.v * s;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] * s;
  return r;
}

template <typename T>
__device__ __forceinline__ DualT<T> operator*(T s, DualT<T> a) {
  return a * s;
}

template <typename T>
__device__ __forceinline__ DualT<T> operator/(DualT<T> a, T s) {
  DualT<T> r;
  r.v = a.v / s;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] / s;
  return r;
}

template <typename T>
__device__ __forceinline__ DualT<T> operator/(DualT<T> a, DualT<T> b) {
  DualT<T> r;
  r.v = a.v / b.v;
  for (int c = 0; c < 3; ++c)
    r.d[c] = a.d[c] / b.v - a.v * b.d[c] / (b.v * b.v);
  return r;
}

template <typename T>
__device__ __forceinline__ DualT<T> dsqrt(DualT<T> a) {
  DualT<T> r;
  r.v = sqrt(a.v);
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] * (T(0.5) / r.v);
  return r;
}

template <typename T>
__device__ __forceinline__ DualT<T> dtan(DualT<T> a) {
  DualT<T> r;
  r.v = tan(a.v);
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] * (T(1) + r.v * r.v);
  return r;
}

template <typename T>
__device__ __forceinline__ DualT<T> dcos(DualT<T> a) {
  T s, co;
  sincos(a.v, &s, &co);
  DualT<T> r;
  r.v = co;
  for (int c = 0; c < 3; ++c) r.d[c] = -s * a.d[c];
  return r;
}

struct Scalars {
  double rcutfac, rfac0, rmin0;
  int switchflag, switchinnerflag;
};

// Cayley-Klein parameters (ar, ai, br, bi) and switching weight w of one
// pair, each with its tangents along the three displacement axes.  elem is
// (nelem, 4): radelem, wj, sinner, dinner.  A masked pair takes the safe
// displacement (1, 0, 0), zero tangents and weight 0.  The scalars (and
// products of them with pi, formed at float64) are rounded to T once.
template <typename T>
__device__ void prologue(T dx, T dy, T dz, bool valid, int ie, int je,
                         const T* __restrict__ elem, const Scalars& s,
                         DualT<T> out[5]) {
  const T one = valid ? T(1) : T(0);
  if (!valid) {
    dx = T(1);
    dy = T(0);
    dz = T(0);
  }
  const T rcutfac = static_cast<T>(s.rcutfac);
  const T rmin0 = static_cast<T>(s.rmin0);
  const T rfac0_pi = static_cast<T>(s.rfac0 * M_PI);
  DualT<T> x = dconst(dx), y = dconst(dy), z = dconst(dz);
  x.d[0] = one;
  y.d[1] = one;
  z.d[2] = one;
  const DualT<T> r = dsqrt(x * x + y * y + z * z);
  const T rcutij = (elem[ie * 4] + elem[je * 4]) * rcutfac;
  const DualT<T> theta0 = (r - rmin0) * rfac0_pi / (rcutij - rmin0);
  const DualT<T> z0 = r / dtan(theta0);
  const DualT<T> r0inv = dconst(T(1)) / dsqrt(r * r + z0 * z0);
  out[0] = r0inv * z0;
  out[1] = -(r0inv * z);
  out[2] = r0inv * y;
  out[3] = -(r0inv * x);

  DualT<T> sfac = dconst(T(1));
  if (s.switchflag) {
    const T rscale = static_cast<T>(M_PI) / (rcutij - rmin0);
    if (r.v <= rmin0) {
      sfac = dconst(T(1));
    } else if (r.v > rcutij) {
      sfac = dconst(T(0));
    } else {
      sfac = T(0.5) * (dcos((r - rmin0) * rscale) + T(1));
    }
  }
  if (s.switchinnerflag) {
    const T half_pi = static_cast<T>(0.5 * M_PI);
    const T sin_ij = T(0.5) * (elem[ie * 4 + 2] + elem[je * 4 + 2]);
    const T din_ij = T(0.5) * (elem[ie * 4 + 3] + elem[je * 4 + 3]);
    DualT<T> arg = (r - sin_ij) * half_pi / din_ij;
    if (arg.v < -half_pi) arg = dconst(-half_pi);
    if (arg.v > half_pi) arg = dconst(half_pi);
    DualT<T> inner = T(0.5) * (dconst(T(1)) - dcos(arg + half_pi));
    if (r.v >= sin_ij + din_ij) inner = dconst(T(1));
    if (r.v <= sin_ij - din_ij) inner = dconst(T(0));
    sfac = sfac * inner;
  }
  out[4] = valid ? sfac * elem[je * 4 + 1] : dconst(T(0));
}

}  // namespace
