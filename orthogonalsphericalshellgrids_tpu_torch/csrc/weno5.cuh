// WENO-5 (Z-weights) reconstruction from the left, shared by momentum.cu and
// tracer_adv.cu. Same expression, term for term, as ops/advection.py:_weno5_left
// (and the JAX package's ops/advection.py:_weno5_left).
#pragma once

template <typename T>
__device__ __forceinline__ T sq(T a) { return a * a; }

// n / d for a divisor d that is positive (finite or +inf), or NaN only where n is NaN
// too, as every divisor of weno5_left is: a zero n is returned as it is, which is the
// quotient's own bits (a zero of n's sign), and the lanes that hold one do not issue
// the division, whose full-range path is slow on a zero dividend. The same bits as
// n / d for every such input.
template <typename T>
__device__ __forceinline__ T div_nz(T n, T d) {
  if (n == T(0)) return n;
  return n / d;
}

template <bool NZ, typename T>
__device__ __forceinline__ T quot(T n, T d) {
  if constexpr (NZ)
    return div_nz(n, d);
  else
    return n / d;
}

// NZ: every division through div_nz (tracer_adv.cu); momentum.cu and probes.cu keep
// the plain division.
template <bool NZ = false, typename T>
__device__ __forceinline__ T weno5_left(T m3, T m2, T m1, T p0, T p1) {
  const T q0 = quot<NZ>(T(2.0) * m3 - T(7.0) * m2 + T(11.0) * m1, T(6.0));
  const T q1 = quot<NZ>(-m2 + T(5.0) * m1 + T(2.0) * p0, T(6.0));
  const T q2 = quot<NZ>(T(2.0) * m1 + T(5.0) * p0 - p1, T(6.0));
  const T c = T(13.0 / 12.0);
  const T b0 = c * sq(m3 - T(2.0) * m2 + m1) + T(0.25) * sq(m3 - T(4.0) * m2 + T(3.0) * m1);
  const T b1 = c * sq(m2 - T(2.0) * m1 + p0) + T(0.25) * sq(m2 - p0);
  const T b2 = c * sq(m1 - T(2.0) * p0 + p1) + T(0.25) * sq(T(3.0) * m1 - T(4.0) * p0 + p1);
  const T tau = b0 > b2 ? b0 - b2 : b2 - b0;
  const T eps = T(1e-8);
  const T a0 = T(0.1) * (T(1.0) + sq(quot<NZ>(tau, b0 + eps)));
  const T a1 = T(0.6) * (T(1.0) + sq(quot<NZ>(tau, b1 + eps)));
  const T a2 = T(0.3) * (T(1.0) + sq(quot<NZ>(tau, b2 + eps)));
  const T s = a0 + a1 + a2;
  return quot<NZ>(a0 * q0 + a1 * q1 + a2 * q2, s);
}

// Upwind-selected WENO-5 at a face from the centers c(-3..+2) relative to the face
// (cell k-1 is the first upwind cell for positive flow), as in
// ops/advection.py:weno5_upwind_faces_from_centers: the stencil's operands are
// selected on the sign first, so a warp whose signs differ evaluates one
// reconstruction, not two.
template <bool NZ = false, typename T>
__device__ __forceinline__ T weno5_upwind_selected(bool pos, T cm3, T cm2, T cm1, T c0,
                                                   T cp1, T cp2) {
  return weno5_left<NZ>(pos ? cm3 : cp2, pos ? cm2 : cp1, pos ? cm1 : c0, pos ? c0 : cm1,
                        pos ? cp1 : cm2);
}
