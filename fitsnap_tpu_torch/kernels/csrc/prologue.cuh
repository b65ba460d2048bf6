// The SNAP pair prologue with forward-mode tangents, shared by the kernels
// that need it (K1 pair_u_duals, and K9 / K11 / K11T of nn_grid.cu): the
// Cayley-Klein parameters (ar, ai, br, bi) and the switching weight w of a
// pair, each as a dual number carrying its three displacement tangents.
// The closed form of fitsnap_tpu/ops/snap.py `_ck_prologue` and of its
// jax.jvp.
#pragma once

#include <math.h>

namespace {

struct Dual {
  double v;
  double d[3];
};

__device__ __forceinline__ Dual dconst(double v) {
  Dual r;
  r.v = v;
  r.d[0] = r.d[1] = r.d[2] = 0.0;
  return r;
}

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  Dual r;
  r.v = a.v + b.v;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] + b.d[c];
  return r;
}

__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  Dual r;
  r.v = a.v - b.v;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] - b.d[c];
  return r;
}

__device__ __forceinline__ Dual operator-(Dual a) {
  Dual r;
  r.v = -a.v;
  for (int c = 0; c < 3; ++c) r.d[c] = -a.d[c];
  return r;
}

__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  Dual r;
  r.v = a.v * b.v;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] * b.v + a.v * b.d[c];
  return r;
}

__device__ __forceinline__ Dual operator+(Dual a, double s) {
  a.v += s;
  return a;
}

__device__ __forceinline__ Dual operator-(Dual a, double s) {
  a.v -= s;
  return a;
}

__device__ __forceinline__ Dual operator*(Dual a, double s) {
  Dual r;
  r.v = a.v * s;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] * s;
  return r;
}

__device__ __forceinline__ Dual operator*(double s, Dual a) { return a * s; }

__device__ __forceinline__ Dual operator/(Dual a, double s) {
  Dual r;
  r.v = a.v / s;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] / s;
  return r;
}

__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  Dual r;
  r.v = a.v / b.v;
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] / b.v - a.v * b.d[c] / (b.v * b.v);
  return r;
}

__device__ __forceinline__ Dual dsqrt(Dual a) {
  Dual r;
  r.v = sqrt(a.v);
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] * (0.5 / r.v);
  return r;
}

__device__ __forceinline__ Dual dtan(Dual a) {
  Dual r;
  r.v = tan(a.v);
  for (int c = 0; c < 3; ++c) r.d[c] = a.d[c] * (1.0 + r.v * r.v);
  return r;
}

__device__ __forceinline__ Dual dcos(Dual a) {
  double s, co;
  sincos(a.v, &s, &co);
  Dual r;
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
// displacement (1, 0, 0), zero tangents and weight 0.
__device__ void prologue(double dx, double dy, double dz, bool valid, int ie,
                         int je, const double* __restrict__ elem,
                         const Scalars& s, Dual out[5]) {
  const double one = valid ? 1.0 : 0.0;
  if (!valid) {
    dx = 1.0;
    dy = 0.0;
    dz = 0.0;
  }
  Dual x = dconst(dx), y = dconst(dy), z = dconst(dz);
  x.d[0] = one;
  y.d[1] = one;
  z.d[2] = one;
  const Dual r = dsqrt(x * x + y * y + z * z);
  const double rcutij = (elem[ie * 4] + elem[je * 4]) * s.rcutfac;
  const Dual theta0 = (r - s.rmin0) * (s.rfac0 * M_PI) / (rcutij - s.rmin0);
  const Dual z0 = r / dtan(theta0);
  const Dual r0inv = dconst(1.0) / dsqrt(r * r + z0 * z0);
  out[0] = r0inv * z0;
  out[1] = -(r0inv * z);
  out[2] = r0inv * y;
  out[3] = -(r0inv * x);

  Dual sfac = dconst(1.0);
  if (s.switchflag) {
    const double rscale = M_PI / (rcutij - s.rmin0);
    if (r.v <= s.rmin0) {
      sfac = dconst(1.0);
    } else if (r.v > rcutij) {
      sfac = dconst(0.0);
    } else {
      sfac = 0.5 * (dcos((r - s.rmin0) * rscale) + 1.0);
    }
  }
  if (s.switchinnerflag) {
    const double sin_ij = 0.5 * (elem[ie * 4 + 2] + elem[je * 4 + 2]);
    const double din_ij = 0.5 * (elem[ie * 4 + 3] + elem[je * 4 + 3]);
    Dual arg = (r - sin_ij) * (0.5 * M_PI) / din_ij;
    if (arg.v < -0.5 * M_PI) arg = dconst(-0.5 * M_PI);
    if (arg.v > 0.5 * M_PI) arg = dconst(0.5 * M_PI);
    Dual inner = 0.5 * (dconst(1.0) - dcos(arg + 0.5 * M_PI));
    if (r.v >= sin_ij + din_ij) inner = dconst(1.0);
    if (r.v <= sin_ij - din_ij) inner = dconst(0.0);
    sfac = sfac * inner;
  }
  out[4] = valid ? sfac * elem[je * 4 + 1] : dconst(0.0);
}

}  // namespace
