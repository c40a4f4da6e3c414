// WENO-5 (Z-weights) reconstruction from the left, shared by momentum.cu and
// tracer_adv.cu. Same expression, term for term, as ops/advection.py:_weno5_left
// (and the JAX package's ops/advection.py:_weno5_left).
#pragma once

template <typename T>
__device__ __forceinline__ T sq(T a) { return a * a; }

template <typename T>
__device__ __forceinline__ T weno5_left(T m3, T m2, T m1, T p0, T p1) {
  const T q0 = (T(2.0) * m3 - T(7.0) * m2 + T(11.0) * m1) / T(6.0);
  const T q1 = (-m2 + T(5.0) * m1 + T(2.0) * p0) / T(6.0);
  const T q2 = (T(2.0) * m1 + T(5.0) * p0 - p1) / T(6.0);
  const T c = T(13.0 / 12.0);
  const T b0 = c * sq(m3 - T(2.0) * m2 + m1) + T(0.25) * sq(m3 - T(4.0) * m2 + T(3.0) * m1);
  const T b1 = c * sq(m2 - T(2.0) * m1 + p0) + T(0.25) * sq(m2 - p0);
  const T b2 = c * sq(m1 - T(2.0) * p0 + p1) + T(0.25) * sq(T(3.0) * m1 - T(4.0) * p0 + p1);
  const T tau = b0 > b2 ? b0 - b2 : b2 - b0;
  const T eps = T(1e-8);
  const T a0 = T(0.1) * (T(1.0) + sq(tau / (b0 + eps)));
  const T a1 = T(0.6) * (T(1.0) + sq(tau / (b1 + eps)));
  const T a2 = T(0.3) * (T(1.0) + sq(tau / (b2 + eps)));
  const T s = a0 + a1 + a2;
  return (a0 * q0 + a1 * q1 + a2 * q2) / s;
}

// Upwind-selected WENO-5 at a face from the centers c(-3..+2) relative to the face
// (cell k-1 is the first upwind cell for positive flow): the stencil is chosen on
// the inputs, as in ops/advection.py:weno5_upwind_faces_from_centers.
template <typename T>
__device__ __forceinline__ T weno5_upwind(bool pos, T cm3, T cm2, T cm1, T c0, T cp1,
                                          T cp2) {
  return pos ? weno5_left(cm3, cm2, cm1, c0, cp1) : weno5_left(cp2, cp1, c0, cm1, cm2);
}

// The same reconstruction with the stencil's operands selected on the sign first:
// one weno5_left evaluated whatever the sign, so a warp whose signs differ does not
// run both (momentum.cu; tracer_adv.cu keeps weno5_upwind).
template <typename T>
__device__ __forceinline__ T weno5_upwind_selected(bool pos, T cm3, T cm2, T cm1, T c0,
                                                   T cp1, T cp2) {
  return weno5_left(pos ? cm3 : cp2, pos ? cm2 : cp1, pos ? cm1 : c0, pos ? c0 : cm1,
                    pos ? cp1 : cm2);
}
