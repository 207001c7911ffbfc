// The cell chain of the AD Jacobian for the water, air and energy EOS
// ("wge"/"wae" on IAPWS-97, fully mobile relative permeability, zero
// capillarity), in one pass: the primal and its npv = 3 forward-mode
// tangents of System.jacobian_parts' cell chain (solver/system.py):
//
//   1. eos.unscale (the adaptive or fixed partial-pressure scale);
//   2. eos.properties (eos/wge.py): the saturation temperature of p - pg
//      in region 4, IAPWS-IF97 regions 1 and 2 (thermo/iapws97.py), the
//      IAPWS-2008 viscosity, and air's density, enthalpy, Henry's
//      constant, energy of solution, mass fractions and mixture
//      viscosity (thermo/ncg.py);
//   3. the fully mobile relative permeability and zero capillarity;
//   4. eos.conductivity;
//   5. assembly.cell_balances (zero in ghost rows).
//
// It replaces no Pallas kernel: it is the counterpart of XLA's fusion of
// jax.linearize over the cell chain in waiwera_tpu/solver/system.py. The
// plain version is torch.func.vmap(torch.func.jvp(cell_chain)) in
// System.cell_jvp, which materialises every intermediate, with its three
// tangents, as a tensor in device memory (the [3, N, 34] and [3, N, 43]
// exponent tensors of the IF97 sums among them).
//
// What bounds it: bytes. Per row it reads the f64 y, the region, five rock
// fields and the ghost flag (~70 B) and writes 24 primal and 3 x 27 tangent
// values and the phase composition (~430 B in f32): ~0.27 GB at the
// flagship size (532,480 rows), ~0.08 ms at the H100's 3.35 TB/s. Its ~70
// exp and log a liquid row (~100 a vapour row, ~170 a two-phase row) are
// ~40 M over the flagship, ~0.01 ms on the special function units.
//
// What the design does about it: one thread per row carries a dual number
// Dual<T, 3> (a value and its three tangents) through the chain in
// registers, so nothing but the outputs leaves the thread. The IF97 and
// viscosity sums loop over the __constant__ tables below (the plain
// chain's own tables, bit for bit), so every thread of a warp reads the
// same term at once. Regions are read, not differentiated: each thread
// branches on its row's region (frozen, as in the plain chain) and
// computes only the phases present, whose properties the plain chain keeps
// (it masks the absent phase's to zero); warps diverge only at the
// boiling front. y and the rock are read in f64 and cast in registers.
// Every arithmetic step rounds as the plain chain's separate PyTorch ops do
// (explicit _rn intrinsics, no FMA contraction), in the plain chain's order.
//
// Outputs, structure of arrays (the views ops/wge_cell.py hands out):
//   P [PRIMAL_COLUMNS * n]: FluidState's floating fields in field order,
//     field f at column offset F_f as a row-major [n, width] block
//     (P + F_f * n), then the conductivity;
//   D [npv][TANGENT_COLUMNS * n]: the same fields' tangents for each seed
//     (y[:, v] for tangent v), the conductivity's, then dL [n, npv];
//   phases [n]: the phase composition (int32); err [n] (optional): the
//     EOS error flag of eos.properties.

#include <cuda_runtime.h>
#include <stdint.h>

// column offsets, in units of n (ops/wge_cell.py LAYOUT)
enum Column {
  F_PRESSURE = 0,
  F_TEMPERATURE = 1,
  F_PERMEABILITY_FACTOR = 2,
  F_PARTIAL_PRESSURE = 3,       // [n, 2]: water, gas
  F_DENSITY = 5,                // [n, 2]: liquid, vapour
  F_VISCOSITY = 7,              // [n, 2]
  F_SATURATION = 9,             // [n, 2]
  F_RELATIVE_PERMEABILITY = 11, // [n, 2]
  F_CAPILLARY_PRESSURE = 13,    // [n, 2]
  F_SPECIFIC_ENTHALPY = 15,     // [n, 2]
  F_INTERNAL_ENERGY = 17,       // [n, 2]
  F_MASS_FRACTION = 19,         // [n, 2, 2]: phase, component
  F_CONDUCTIVITY = 23,
  F_BALANCES = 24,              // tangents only: dL [n, 3]
  PRIMAL_COLUMNS = 24,
  TANGENT_COLUMNS = 27,
};

constexpr int NPV = 3;

// ---------------------------------------------------------------------
// Coefficient tables: thermo/iapws97.py's _R1_GAMPI, _R1_GAMT, _R2_GAMT0,
// _R2_GAMPI, _R2_GAMT (coefficient, exponent of x, exponent of y), _SAT_N,
// _VISC_H0, _VISC_H1 (with _VISC_I and _VISC_J in VISC_TERMS below), and
// thermo/ncg.py's AirNCG
// _ENTHALPY, _HENRY and its derivative coefficients, as the plain chain
// uses them (tests/test_torch_wge_cell.py holds them to the modules').
// ---------------------------------------------------------------------
__constant__ double R1_GAMPI_N[34] = {
    0.0, -0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 0.0, 0.00028319080123804,
    -0.00060706301565874, -0.018990068218419, -0.032529748770505,
    -0.021841717175414, -5.283835796993e-05, -0.00094368642146534,
    -0.00060003561586052, 9.5322787813974e-05, -8.8283690661692e-06,
    -1.45389992595188e-15, -9.5038934535162e-05, -8.4812393955936e-06,
    -2.5561538436030902e-09, -8.9701127632e-06, -2.60684891582404e-06,
    -5.7366919751696e-13, -2.02584984300585e-06, -1.01874413933128e-08,
    -1.39398969845072e-09, -1.4440047572061508e-17, 3.33001080055983e-19,
    7.63737668221055e-22, -3.5842867920213e-22, 5.65070932023524e-23,
    -2.993186793358656e-24,
};
__constant__ double R1_GAMPI_I[34] = {
    -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 3.0, 3.0, 3.0, 4.0, 7.0, 7.0,
    20.0, 22.0, 28.0, 29.0, 30.0, 31.0,
};
__constant__ double R1_GAMPI_J[34] = {
    -2.0, -1.0, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0, -9.0, -7.0, -1.0, 0.0, 1.0, 3.0,
    -3.0, 0.0, 1.0, 3.0, 17.0, -4.0, 0.0, 6.0, -5.0, -2.0, 10.0, -8.0, -11.0,
    -6.0, -29.0, -31.0, -38.0, -39.0, -40.0, -41.0,
};
__constant__ double R1_GAMT_N[34] = {
    -0.29265942426334, 0.84548187169114, -0.0, 3.3855169168385,
    -1.91583926775744, 0.47316115539684, -0.066465668798004,
    0.0040607314991784, -0.00254871721114236, 0.00424944110961118,
    0.018990068218419, -0.0, -0.021841717175414, -0.00015851507390979001,
    0.0014155296321980099, -0.0, 4.7661393906987e-05, -1.32425535992538e-05,
    -1.235814937059098e-14, 0.000126718579380216, -0.0,
    -5.1123076872061805e-09, 1.1212640954e-05, 1.30342445791202e-06,
    -1.4341729937924e-12, 3.24135974880936e-06, 1.40077319158051e-08,
    1.0454922738380401e-09, 1.9941018075703988e-17, -4.48827542684151e-19,
    -1.00075970318621e-21, 4.65957282962769e-22, -7.2912378325616e-23,
    3.835020578990778e-24,
};
__constant__ double R1_GAMT_I[34] = {
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0,
    2.0, 2.0, 2.0, 2.0, 3.0, 3.0, 3.0, 4.0, 4.0, 4.0, 5.0, 8.0, 8.0, 21.0,
    23.0, 29.0, 30.0, 31.0, 32.0,
};
__constant__ double R1_GAMT_J[34] = {
    -3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0, 4.0, -10.0, -8.0, -2.0, -1.0, 0.0,
    2.0, -4.0, -1.0, 0.0, 2.0, 16.0, -5.0, -1.0, 5.0, -6.0, -3.0, 9.0, -9.0,
    -12.0, -7.0, -30.0, -32.0, -39.0, -40.0, -41.0, -42.0,
};
__constant__ double R2_GAMT0_N[9] = {
    -0.0, 10.086655968018, 0.02804395564151, -0.28581095232582,
    1.22131494671784, -2.8481638342888, 4.383951131945, -0.56817264921544,
    0.063805391259921,
};
__constant__ double R2_GAMT0_J[9] = {
    -1.0, 0.0, -6.0, -5.0, -4.0, -3.0, -2.0, 1.0, 2.0,
};
__constant__ double R2_GAMPI_N[43] = {
    -0.0017731742473213, -0.017834862292358, -0.045996013696365,
    -0.057581259083432, -0.05032527872793, -6.6065283340406e-05,
    -0.0003789797503263, -0.007878555448671, -0.087594591301146,
    -5.3349095828174e-05, 6.1445213076927e-08, 1.31612001853305e-06,
    -9.683303171571e-05, -0.0045101773626443995, -0.122004760687947,
    -3.15389238237468e-09, 5.116287140914e-08, 1.92901490874028e-06,
    1.14610381688305e-05, -1.00288598706366e-10, -0.012702883392812999,
    -143.374451604624, -4.1341695026989e-17, -8.8352662293707e-06,
    -0.27262789705017304, 9.0049690883672e-11, -65.8490727183984,
    1.78287415218792e-07, 1.0406965210174e-18, -1.0234747095929e-12,
    -1.0018179379511e-08, -1.29412653835176e-09, 1.71088510070544,
    -6.05920510335078, 1.78371690710842e-23, 6.1258633752463995e-12,
    -8.4004935396416e-05, -1.2401766233984191e-24, 8.321928474960541e-05,
    -2.93678005497663e-14, 1.7541026542814642e-27, 1.329953168418672e-15,
    -2.26487297378904e-05,
};
__constant__ double R2_GAMPI_I[43] = {
    0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 2.0, 2.0,
    3.0, 3.0, 3.0, 4.0, 5.0, 5.0, 5.0, 6.0, 6.0, 6.0, 7.0, 7.0, 8.0, 9.0, 9.0,
    9.0, 15.0, 15.0, 17.0, 19.0, 19.0, 19.0, 20.0, 21.0, 22.0, 23.0, 23.0,
    23.0,
};
__constant__ double R2_GAMPI_J[43] = {
    0.0, 1.0, 2.0, 3.0, 6.0, 1.0, 2.0, 4.0, 7.0, 36.0, 0.0, 1.0, 3.0, 6.0,
    35.0, 1.0, 2.0, 3.0, 7.0, 3.0, 16.0, 35.0, 0.0, 11.0, 25.0, 8.0, 36.0,
    13.0, 4.0, 10.0, 14.0, 29.0, 50.0, 57.0, 20.0, 35.0, 48.0, 21.0, 53.0,
    39.0, 26.0, 40.0, 58.0,
};
__constant__ double R2_GAMT_N[43] = {
    -0.0, -0.017834862292358, -0.09199202739273, -0.172743777250296,
    -0.30195167236758, -3.3032641670203e-05, -0.0003789797503263,
    -0.015757110897342, -0.306581069554011, -0.0009602837249071321, 0.0,
    4.3870667284435e-07, -9.683303171571e-05, -0.009020354725288799,
    -1.423388874692715, -7.8847309559367e-10, 2.558143570457e-08,
    1.4467611815552102e-06, 1.60454534363627e-05, -5.0144299353183e-11,
    -0.033874355714168, -836.35096769364, -0.0, -1.38839897890111e-05,
    -0.9736710608934751, 9.0049690883672e-11, -296.3208272327928,
    2.57526266427144e-07, 4.1627860840696e-19, -1.0234747095929e-12,
    -1.40254511313154e-08, -2.345604350762565e-09, 5.3465159397045,
    -19.18748282727747, 1.78371690710842e-23, 1.0720260906681199e-11,
    -0.0002016118449513984, -1.2401766233984191e-24, 0.0002004828223513221,
    -4.97975748452559e-14, 1.900277875471586e-27, 2.21658861403112e-15,
    -5.47344301999018e-05,
};
__constant__ double R2_GAMT_I[43] = {
    1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 2.0, 2.0, 3.0, 3.0, 3.0, 3.0, 3.0,
    4.0, 4.0, 4.0, 5.0, 6.0, 6.0, 6.0, 7.0, 7.0, 7.0, 8.0, 8.0, 9.0, 10.0,
    10.0, 10.0, 16.0, 16.0, 18.0, 20.0, 20.0, 20.0, 21.0, 22.0, 23.0, 24.0,
    24.0, 24.0,
};
__constant__ double R2_GAMT_J[43] = {
    -1.0, 0.0, 1.0, 2.0, 5.0, 0.0, 1.0, 3.0, 6.0, 35.0, -1.0, 0.0, 2.0, 5.0,
    34.0, 0.0, 1.0, 2.0, 6.0, 2.0, 15.0, 34.0, -1.0, 10.0, 24.0, 7.0, 35.0,
    12.0, 3.0, 9.0, 13.0, 28.0, 49.0, 56.0, 19.0, 34.0, 47.0, 20.0, 52.0,
    38.0, 25.0, 39.0, 57.0,
};
__constant__ double SAT_N[10] = {
    1167.0521452767, -724213.16703206, -17.073846940092, 12020.82470247,
    -3232555.0322333, 14.91510861353, -4823.2657361591, 405113.40542057,
    -0.23855557567849, 650.17534844798,
};
__constant__ double VISC_H0[4] = {
    1.67752, 2.20462, 0.6366564, -0.241605,
};
__constant__ double VISC_H1[21] = {
    0.520094, 0.0850895, -1.08374, -0.289555, 0.222531, 0.999115, 1.88797,
    1.26613, 0.120573, -0.281378, -0.906851, -0.772479, -0.489837, -0.25704,
    0.161913, 0.257399, -0.0325372, 0.0698452, 0.00872102, -0.00435673,
    -0.000593264,
};
__constant__ double AIR_ENTHALPY[4] = {
    1.2074, 9.24502, 0.115984, -0.000563568,
};
__constant__ double AIR_HENRY[14] = {
    0.513726, 1.58603, -0.59378, -0.698282, 0.51033, -0.121388, 0.0100041,
    0.26234, 0.610628, 0.700732, -1.39299, 0.71385, -0.154216, 0.012319,
};
__constant__ double AIR_HENRY_DERIV[12] = {
    1.58603, -1.18756, -2.094846, 2.04132, -0.60694, 0.0600246, 0.610628,
    1.401464, -4.17897, 2.8554, -0.77108, 0.07391400000000001,
};

// Scalars the Python objects hold (ops/wge_cell.py wge_params): the EOS's
// primary scale rows by region, its partial-pressure scaling, IAPWS-97's
// region 1 temperature limit, and AirNCG's derived constants.
struct WgeParams {
  double scale[4][3];
  double region1_max_temperature;
  double air_enthalpy_shift;
  double air_fmix;
  double air_cmix;
  int adaptive_pp_scale;
};

// ---------------------------------------------------------------------
// Rounding: each step rounds once, as a separate PyTorch op does.
// ---------------------------------------------------------------------
template <typename T> struct Op;
template <> struct Op<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  static __device__ __forceinline__ float log(float a) { return logf(a); }
};
template <> struct Op<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ double log(double a) { return ::log(a); }
};

// ---------------------------------------------------------------------
// Dual<T>: a value and its NPV tangents, in registers. Constants are
// doubles cast to T first, as PyTorch casts a Python number to the
// tensor's dtype.
// ---------------------------------------------------------------------
template <typename T> struct Dual {
  T v;
  T d[NPV];
};

template <typename T> __device__ __forceinline__ Dual<T> constant(double c) {
  Dual<T> r;
  r.v = T(c);
#pragma unroll
  for (int k = 0; k < NPV; ++k) r.d[k] = T(0);
  return r;
}

template <typename T> __device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  Dual<T> r;
  r.v = Op<T>::add(a.v, b.v);
#pragma unroll
  for (int k = 0; k < NPV; ++k) r.d[k] = Op<T>::add(a.d[k], b.d[k]);
  return r;
}
template <typename T> __device__ __forceinline__ Dual<T> operator+(Dual<T> a, double c) {
  a.v = Op<T>::add(a.v, T(c));
  return a;
}
template <typename T> __device__ __forceinline__ Dual<T> operator+(double c, Dual<T> a) {
  return a + c;
}
template <typename T> __device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  Dual<T> r;
  r.v = Op<T>::sub(a.v, b.v);
#pragma unroll
  for (int k = 0; k < NPV; ++k) r.d[k] = Op<T>::sub(a.d[k], b.d[k]);
  return r;
}
template <typename T> __device__ __forceinline__ Dual<T> operator-(Dual<T> a, double c) {
  a.v = Op<T>::sub(a.v, T(c));
  return a;
}
template <typename T> __device__ __forceinline__ Dual<T> operator-(double c, Dual<T> a) {
  Dual<T> r;
  r.v = Op<T>::sub(T(c), a.v);
#pragma unroll
  for (int k = 0; k < NPV; ++k) r.d[k] = -a.d[k];
  return r;
}
template <typename T> __device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  Dual<T> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < NPV; ++k) r.d[k] = -a.d[k];
  return r;
}
template <typename T> __device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  Dual<T> r;
  r.v = Op<T>::mul(a.v, b.v);
#pragma unroll
  for (int k = 0; k < NPV; ++k)
    r.d[k] = Op<T>::add(Op<T>::mul(a.d[k], b.v), Op<T>::mul(b.d[k], a.v));
  return r;
}
template <typename T> __device__ __forceinline__ Dual<T> operator*(Dual<T> a, double c) {
  const T t = T(c);
  a.v = Op<T>::mul(a.v, t);
#pragma unroll
  for (int k = 0; k < NPV; ++k) a.d[k] = Op<T>::mul(a.d[k], t);
  return a;
}
template <typename T> __device__ __forceinline__ Dual<T> operator*(double c, Dual<T> a) {
  return a * c;
}
template <typename T> __device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  Dual<T> r;
  r.v = Op<T>::div(a.v, b.v);
#pragma unroll
  for (int k = 0; k < NPV; ++k)
    r.d[k] = Op<T>::div(Op<T>::sub(a.d[k], Op<T>::mul(r.v, b.d[k])), b.v);
  return r;
}
template <typename T> __device__ __forceinline__ Dual<T> operator/(Dual<T> a, double c) {
  const T t = T(c);
  a.v = Op<T>::div(a.v, t);
#pragma unroll
  for (int k = 0; k < NPV; ++k) a.d[k] = Op<T>::div(a.d[k], t);
  return a;
}
// c / a as PyTorch computes a Python number over a tensor: reciprocal(a) * c
template <typename T> __device__ __forceinline__ Dual<T> operator/(double c, Dual<T> a) {
  Dual<T> r;
  const T inv = Op<T>::div(T(1), a.v);
  const T inv2 = Op<T>::mul(inv, inv);
#pragma unroll
  for (int k = 0; k < NPV; ++k) r.d[k] = -Op<T>::mul(a.d[k], inv2);
  r.v = inv;
  return r * c;
}
template <typename T> __device__ __forceinline__ Dual<T> exp(Dual<T> a) {
  Dual<T> r;
  r.v = Op<T>::exp(a.v);
#pragma unroll
  for (int k = 0; k < NPV; ++k) r.d[k] = Op<T>::mul(a.d[k], r.v);
  return r;
}
template <typename T> __device__ __forceinline__ Dual<T> log(Dual<T> a) {
  Dual<T> r;
  r.v = Op<T>::log(a.v);
#pragma unroll
  for (int k = 0; k < NPV; ++k) r.d[k] = Op<T>::div(a.d[k], a.v);
  return r;
}
template <typename T> __device__ __forceinline__ Dual<T> sqrt(Dual<T> a) {
  Dual<T> r;
  r.v = Op<T>::sqrt(a.v);
  const T two_r = Op<T>::mul(T(2), r.v);
#pragma unroll
  for (int k = 0; k < NPV; ++k) r.d[k] = Op<T>::div(a.d[k], two_r);
  return r;
}
// torch.where(c, a, b): the value and the tangent of the branch taken
template <typename T> __device__ __forceinline__ Dual<T> where(bool c, Dual<T> a, Dual<T> b) {
  return c ? a : b;
}
// torch.clamp(a, lo, hi): the tangent passes inside [lo, hi], bounds
// included, and is zero outside
template <typename T> __device__ __forceinline__ Dual<T> clamp(Dual<T> a, double lo, double hi) {
  const T l = T(lo), h = T(hi);
  const bool inside = a.v >= l && a.v <= h;
  a.v = a.v < l ? l : (a.v > h ? h : a.v);
  if (!inside) {
#pragma unroll
    for (int k = 0; k < NPV; ++k) a.d[k] = T(0);
  }
  return a;
}
template <typename T> __device__ __forceinline__ Dual<T> clamp_min(Dual<T> a, double lo) {
  const T l = T(lo);
  if (!(a.v >= l)) {
    a.v = l;
#pragma unroll
    for (int k = 0; k < NPV; ++k) a.d[k] = T(0);
  }
  return a;
}

// ---------------------------------------------------------------------
// Thermodynamics: thermo/base.py constants, thermo/iapws97.py functions
// ---------------------------------------------------------------------
constexpr double RCONST = 0.461526e3;
constexpr double TC_K = 273.15;
constexpr double TCRITICAL_K = 647.096;
constexpr double TCRITICAL = TCRITICAL_K - TC_K;
constexpr double PCRITICAL = 22.064e6;
constexpr double DCRITICAL = 322.0;
constexpr double MAX_PRESSURE = 100.0e6;
constexpr double SATURATION_MIN_PRESSURE = 611.213;
constexpr double REGION2_MAX_TEMPERATURE = 800.0;
constexpr int PHASE_LIQUID = 1, PHASE_VAPOUR = 2, PHASE_SUPERCRITICAL = 4;

// sum_k n_k x^ix_k y^jy_k as n_k exp(ix_k log x + jy_k log y) (_powsum)
template <typename T>
__device__ Dual<T> powsum(Dual<T> x, Dual<T> y, const double* n,
                          const double* ix, const double* jy, int terms) {
  const Dual<T> lx = log(x), ly = log(y);
  Dual<T> acc = constant<T>(0.0);
  for (int k = 0; k < terms; ++k)
    acc = acc + exp(lx * ix[k] + ly * jy[k]) * n[k];
  return acc;
}

// IF97 eq. (31): saturation temperature (deg C) from pressure (Pa)
template <typename T>
__device__ Dual<T> saturation_temperature(Dual<T> p, bool& err) {
  const double* n = SAT_N;
  err = p.v < T(SATURATION_MIN_PRESSURE) || p.v > T(PCRITICAL);
  const Dual<T> ps = clamp(p, SATURATION_MIN_PRESSURE, PCRITICAL);
  const Dual<T> beta2 = sqrt(ps / 1.0e6);
  const Dual<T> beta = sqrt(beta2);
  const Dual<T> e = beta2 + n[2] * beta + n[5];
  const Dual<T> f = n[0] * beta2 + n[3] * beta + n[6];
  const Dual<T> g = n[1] * beta2 + n[4] * beta + n[7];
  const Dual<T> d = 2.0 * g / (-f - sqrt(f * f - 4.0 * e * g));
  const Dual<T> x = d + n[9];
  return 0.5 * (x - sqrt(x * x - 4.0 * (n[9] * d + n[8]))) - TC_K;
}

// IF97 eq. (30): saturation pressure (Pa) from temperature (deg C); its
// value only (it decides region 3's phase)
template <typename T>
__device__ T saturation_pressure(T t) {
  const double* n = SAT_N;
  Dual<T> tk = constant<T>(0.0);
  tk.v = t < T(0) ? T(0) : (t > T(TCRITICAL) ? T(TCRITICAL) : t);
  tk = tk + TC_K;
  const Dual<T> theta = tk + n[8] / (tk - n[9]);
  const Dual<T> theta2 = theta * theta;
  const Dual<T> a = theta2 + n[0] * theta + n[1];
  const Dual<T> b = n[2] * theta2 + n[3] * theta + n[4];
  const Dual<T> c = n[5] * theta2 + n[6] * theta + n[7];
  Dual<T> x = 2.0 * c / (-b + sqrt(b * b - 4.0 * a * c));
  x = x * x;
  return (1.0e6 * x * x).v;
}

// IF97 region 1: liquid density and internal energy
template <typename T>
__device__ void region1(Dual<T> p, Dual<T> t, double max_temperature,
                        Dual<T>& density, Dual<T>& energy, bool& err) {
  err = t.v > T(max_temperature) || p.v > T(MAX_PRESSURE);
  const Dual<T> tk = clamp(t, 0.0, max_temperature) + TC_K;
  const Dual<T> rt = RCONST * tk;
  const Dual<T> pi = clamp(p, 0.0, MAX_PRESSURE) / 16.53e6;
  const Dual<T> tau = 1386.0 / tk;
  const Dual<T> x = 7.1 - pi;
  const Dual<T> y = tau - 1.222;
  const Dual<T> gampi = -powsum(x, y, R1_GAMPI_N, R1_GAMPI_I, R1_GAMPI_J, 34);
  const Dual<T> gamt = powsum(x, y, R1_GAMT_N, R1_GAMT_I, R1_GAMT_J, 34);
  density = 16.53e6 / (rt * gampi);
  energy = rt * (tau * gamt - pi * gampi);
}

// IF97 region 2: steam density and internal energy
template <typename T>
__device__ void region2(Dual<T> p, Dual<T> t, Dual<T>& density,
                        Dual<T>& energy, bool& err) {
  err = t.v > T(REGION2_MAX_TEMPERATURE) || p.v > T(MAX_PRESSURE);
  const Dual<T> tk = clamp(t, 0.0, REGION2_MAX_TEMPERATURE) + TC_K;
  const Dual<T> rt = RCONST * tk;
  const Dual<T> pi = clamp(p, 1e-3, MAX_PRESSURE) / 1.0e6;
  const Dual<T> tau = 540.0 / tk;
  const Dual<T> y = tau - 0.5;
  const Dual<T> ltau = log(tau);
  Dual<T> gamt0 = constant<T>(0.0);
  for (int k = 0; k < 9; ++k)
    gamt0 = gamt0 + exp(ltau * R2_GAMT0_J[k]) * R2_GAMT0_N[k];
  const Dual<T> gampir = powsum(pi, y, R2_GAMPI_N, R2_GAMPI_I, R2_GAMPI_J, 43);
  const Dual<T> gamtr = powsum(pi, y, R2_GAMT_N, R2_GAMT_I, R2_GAMT_J, 43);
  const Dual<T> gampi = 1.0 / pi + gampir;
  density = 1.0e6 / (rt * gampi);
  energy = rt * (tau * (gamt0 + gamtr) - pi * gampi);
}

// IAPWS-2008 viscosity without critical enhancement; the finite-density
// sum term by term (k, _VISC_I[k], _VISC_J[k]), so that the powers stay in
// registers
#define VISC_TERMS \
  VISC_TERM(0, 0, 0) \
  VISC_TERM(1, 1, 0) \
  VISC_TERM(2, 2, 0) \
  VISC_TERM(3, 3, 0) \
  VISC_TERM(4, 0, 1) \
  VISC_TERM(5, 1, 1) \
  VISC_TERM(6, 2, 1) \
  VISC_TERM(7, 3, 1) \
  VISC_TERM(8, 5, 1) \
  VISC_TERM(9, 0, 2) \
  VISC_TERM(10, 1, 2) \
  VISC_TERM(11, 2, 2) \
  VISC_TERM(12, 3, 2) \
  VISC_TERM(13, 4, 2) \
  VISC_TERM(14, 0, 3) \
  VISC_TERM(15, 1, 3) \
  VISC_TERM(16, 0, 4) \
  VISC_TERM(17, 3, 4) \
  VISC_TERM(18, 4, 5) \
  VISC_TERM(19, 3, 6) \
  VISC_TERM(20, 5, 6)

template <typename T>
__device__ Dual<T> viscosity(Dual<T> t, Dual<T> density) {
  const double* h0 = VISC_H0;
  const Dual<T> tau = (t + TC_K) / TCRITICAL_K;
  const Dual<T> delta = density / DCRITICAL;
  const Dual<T> itau = 1.0 / tau;
  const Dual<T> s0 = h0[0] + h0[1] * itau + h0[2] * itau * itau +
                     h0[3] * itau * itau * itau;
  const Dual<T> mu0 = 100.0 * sqrt(tau) / s0;
  const Dual<T> x = itau - 1.0;
  const Dual<T> y = delta - 1.0;
  Dual<T> xs[6], ys[7];
  xs[0] = ys[0] = constant<T>(1.0);
  for (int k = 1; k < 6; ++k) xs[k] = xs[k - 1] * x;
  for (int k = 1; k < 7; ++k) ys[k] = ys[k - 1] * y;
  Dual<T> s1 = constant<T>(0.0);
#define VISC_TERM(k, I, J) s1 = s1 + VISC_H1[k] * xs[I] * ys[J];
  VISC_TERMS
#undef VISC_TERM
  return 1.0e-6 * mu0 * exp(delta * s1);
}

// Horner's sum_k c[k] x^k (thermo/ncg.py _poly)
template <typename T>
__device__ Dual<T> poly(const double* c, int len, Dual<T> x) {
  Dual<T> p = constant<T>(c[len - 1]);
  for (int k = len - 2; k >= 0; --k) p = p * x + c[k];
  return p;
}

// ---------------------------------------------------------------------
// Air (thermo/ncg.py AirNCG)
// ---------------------------------------------------------------------
constexpr double AIR_MW = 28.96;
constexpr double WATER_MW = 18.01528;
constexpr double GAS_CONSTANT = 8.3144598;
__constant__ double AIR_WEIGHT[2] = {0.79, 0.21};
__constant__ double AIR_HENRY_P0[2] = {1.01325e5, 1.0e5};
constexpr double AIR_FAIR = 97.0, AIR_CAIR = 3.617;

template <typename T> __device__ Dual<T> mole_to_mass(Dual<T> xmole) {
  const Dual<T> w = xmole * AIR_MW;
  return w / (w + (1.0 - xmole) * WATER_MW);
}

template <typename T> __device__ Dual<T> mass_to_mole(Dual<T> xg) {
  const Dual<T> w = xg / AIR_MW;
  return w / (w + (1.0 - xg) / WATER_MW);
}

// Hirschfelder et al. vapour mixture viscosity
template <typename T>
__device__ Dual<T> air_mixture_viscosity(Dual<T> water_visc, Dual<T> t,
                                         Dual<T> xg, const WgeParams& prm) {
  const double rm1 = AIR_MW, rm2 = WATER_MW;
  const double rm3 = 2.0 * rm1 * rm2 / (rm1 + rm2);
  const Dual<T> x1 = mass_to_mole(xg);
  const Dual<T> x2 = 1.0 - x1;
  const Dual<T> tk = t + TC_K;
  const Dual<T> trd1 = tk / AIR_FAIR;
  const Dual<T> trd3 = tk / prm.air_fmix;
  const Dual<T> ome1 = (1.188 - 0.051 * trd1) / trd1;
  const Dual<T> ome3 = (1.48 - 0.412 * log(trd3)) / trd3;
  const Dual<T> ard = 1.095 / trd3;
  const Dual<T> vis1 = 266.93e-7 * sqrt(rm1 * trd1 * AIR_FAIR) /
                       (AIR_CAIR * AIR_CAIR * ome1 * trd1);
  const Dual<T> vis2 = 10.0 * water_visc;
  const Dual<T> vis3 = 266.93e-7 * sqrt(rm3 * trd3 * prm.air_fmix) /
                       (prm.air_cmix * prm.air_cmix * ome3 * trd3);
  const Dual<T> z1 = x1 * x1 / vis1 + 2.0 * x2 * x1 / vis3 + x2 * x2 / vis2;
  const Dual<T> g = x1 * x1 * rm1 / rm2;
  const Dual<T> h = x2 * x2 * rm2 / rm1;
  const Dual<T> e = (2.0 * x1 * x2 * rm1 * rm2 / (rm3 * rm3)) * vis3 / (vis1 * vis2);
  const Dual<T> z2 = 0.6 * ard * (g / vis1 + e + h / vis2);
  const Dual<T> z3 = 0.6 * ard * (g + e * (vis1 + vis2) - 2.0 * x1 * x2 + h);
  return 0.1 * (1.0 + z3) / (z1 + z2);
}

// ---------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void put(T* P, T* D, int64_t n, int64_t i,
                                    int column, int width, int c,
                                    Dual<T> a) {
  const int64_t at = (int64_t)column * n + i * width + c;
  P[at] = a.v;
#pragma unroll
  for (int k = 0; k < NPV; ++k) D[(int64_t)k * TANGENT_COLUMNS * n + at] = a.d[k];
}

template <typename T>
__global__ void __launch_bounds__(128)
wge_cell_jvp_kernel(const double* __restrict__ y, const int* __restrict__ region,
                    const double* __restrict__ porosity,
                    const double* __restrict__ rock_density,
                    const double* __restrict__ specific_heat,
                    const double* __restrict__ wet_conductivity,
                    const double* __restrict__ dry_conductivity,
                    const unsigned char* __restrict__ ghost, WgeParams prm,
                    T* __restrict__ P, T* __restrict__ D,
                    int* __restrict__ phases, unsigned char* __restrict__ err_out,
                    int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = region[i];

  // eos.unscale: seed v is y[:, v]; with the adaptive partial-pressure
  // scale, pg = y[:, 2] * p
  Dual<T> ys[NPV], prim[NPV];
#pragma unroll
  for (int j = 0; j < NPV; ++j) {
    ys[j] = constant<T>(0.0);
    ys[j].v = T(y[i * NPV + j]);
    ys[j].d[j] = T(1);
    prim[j] = ys[j] * prm.scale[(r - 1) & 3][j];
  }
  const Dual<T> p = prim[0];
  const Dual<T> pg = prm.adaptive_pp_scale ? ys[2] * p : prim[2];
  const Dual<T> pw = p - pg;

  // eos.properties: temperature, phases, saturations
  bool err = false;
  Dual<T> t = prim[1];
  if (r == 4) {
    bool sat_err;
    t = saturation_temperature(pw, sat_err);
    err = sat_err;
  }
  int phase;
  if (r == 4) {
    phase = PHASE_LIQUID | PHASE_VAPOUR;
  } else if (t.v <= T(TCRITICAL)) {
    phase = r == 1 ? PHASE_LIQUID
          : r == 2 ? PHASE_VAPOUR
          : (p.v >= saturation_pressure(t.v) ? PHASE_LIQUID : PHASE_VAPOUR);
  } else {
    phase = p.v <= T(PCRITICAL) ? PHASE_VAPOUR : PHASE_SUPERCRITICAL;
  }
  const bool in_l = phase & PHASE_LIQUID, in_v = phase & PHASE_VAPOUR;
  const Dual<T> sv = r == 4 ? prim[1] : constant<T>(r == 2 ? 1.0 : 0.0);
  const Dual<T> sl = 1.0 - sv;

  // air's enthalpy at t, both phases
  const Dual<T> tk = t + TC_K;
  const Dual<T> gh = 1.0e4 * (poly(AIR_ENTHALPY, 4, tk / 100.0) - prm.air_enthalpy_shift);

  const Dual<T> zero = constant<T>(0.0);
  Dual<T> rho_l = zero, h_l = zero, u_l = zero, visc_l = zero, xg_l = zero;
  if (in_l) {
    // Henry's constant and energy of solution at t
    const Dual<T> ts = t / 100.0;
    Dual<T> henry = zero, dlnh = zero;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const Dual<T> hc = 1.0e5 * AIR_HENRY_P0[c] * poly(AIR_HENRY + 7 * c, 7, ts);
      henry = henry + AIR_WEIGHT[c] * hc;
      const Dual<T> dhinv = 1.0e5 * poly(AIR_HENRY_DERIV + 6 * c, 6, ts);
      dlnh = dlnh + AIR_WEIGHT[c] * AIR_HENRY_P0[c] * dhinv / (hc * 100.0);
    }
    const Dual<T> esol = -1.0e3 * GAS_CONSTANT * tk * tk * dlnh / AIR_MW;
    // water at total pressure, air dissolved by Henry's law
    Dual<T> dl, ul;
    bool el;
    region1(p, t, prm.region1_max_temperature, dl, ul, el);
    const Dual<T> hl_w = ul + p / where(dl.v > T(0), dl, constant<T>(1.0));
    xg_l = mole_to_mass(pg / clamp_min(henry, 1e-30));
    rho_l = dl;
    h_l = hl_w * (1.0 - xg_l) + (gh + esol) * xg_l;
    u_l = h_l - p / where(rho_l.v > T(0), rho_l, constant<T>(1.0));
    visc_l = viscosity(t, dl);
    err = err || el;
  }
  Dual<T> rho_v = zero, h_v = zero, u_v = zero, visc_v = zero, xg_v = zero;
  if (in_v) {
    // air at its partial pressure, steam at the water partial pressure
    const Dual<T> gd = pg * AIR_MW / (1.0e3 * GAS_CONSTANT * 1.0 * tk);
    Dual<T> dv, uv;
    bool ev;
    region2(pw, t, dv, uv, ev);
    const Dual<T> hv_w = uv + pw / where(dv.v > T(0), dv, constant<T>(1.0));
    rho_v = dv + gd;
    const Dual<T> total = gd + dv;
    xg_v = total.v > T(1e-30)
               ? gd / where(total.v > T(0), total, constant<T>(1.0))
               : zero;
    h_v = hv_w * (1.0 - xg_v) + gh * xg_v;
    u_v = h_v - p / where(rho_v.v > T(0), rho_v, constant<T>(1.0));
    visc_v = air_mixture_viscosity(viscosity(t, dv), t, xg_v, prm);
    err = err || ev;
  }

  // the fluid's floating fields, absent phases zero
  put(P, D, n, i, F_PRESSURE, 1, 0, p);
  put(P, D, n, i, F_TEMPERATURE, 1, 0, t);
  put(P, D, n, i, F_PERMEABILITY_FACTOR, 1, 0, constant<T>(1.0));
  put(P, D, n, i, F_PARTIAL_PRESSURE, 2, 0, pw);
  put(P, D, n, i, F_PARTIAL_PRESSURE, 2, 1, pg);
  put(P, D, n, i, F_DENSITY, 2, 0, rho_l);
  put(P, D, n, i, F_DENSITY, 2, 1, rho_v);
  put(P, D, n, i, F_VISCOSITY, 2, 0, visc_l);
  put(P, D, n, i, F_VISCOSITY, 2, 1, visc_v);
  put(P, D, n, i, F_SATURATION, 2, 0, sl);
  put(P, D, n, i, F_SATURATION, 2, 1, sv);
  put(P, D, n, i, F_RELATIVE_PERMEABILITY, 2, 0, constant<T>(in_l ? 1.0 : 0.0));
  put(P, D, n, i, F_RELATIVE_PERMEABILITY, 2, 1, constant<T>(in_v ? 1.0 : 0.0));
  put(P, D, n, i, F_CAPILLARY_PRESSURE, 2, 0, zero);
  put(P, D, n, i, F_CAPILLARY_PRESSURE, 2, 1, zero);
  put(P, D, n, i, F_SPECIFIC_ENTHALPY, 2, 0, h_l);
  put(P, D, n, i, F_SPECIFIC_ENTHALPY, 2, 1, h_v);
  put(P, D, n, i, F_INTERNAL_ENERGY, 2, 0, u_l);
  put(P, D, n, i, F_INTERNAL_ENERGY, 2, 1, u_v);
  const Dual<T> x_l[2] = {in_l ? 1.0 - xg_l : zero, xg_l};
  const Dual<T> x_v[2] = {in_v ? 1.0 - xg_v : zero, xg_v};
  put(P, D, n, i, F_MASS_FRACTION, 4, 0, x_l[0]);
  put(P, D, n, i, F_MASS_FRACTION, 4, 1, x_l[1]);
  put(P, D, n, i, F_MASS_FRACTION, 4, 2, x_v[0]);
  put(P, D, n, i, F_MASS_FRACTION, 4, 3, x_v[1]);

  // eos.conductivity: sqrt(S_l) between dry and wet
  const T wet = T(wet_conductivity[i]), dry = T(dry_conductivity[i]);
  const Dual<T> slc = clamp(sl, 0.0, 1.0);
  const Dual<T> root = slc.v > T(0) ? sqrt(slc) : zero;
  const Dual<T> cond = root * (double)Op<T>::sub(wet, dry) + (double)dry;
  put(P, D, n, i, F_CONDUCTIVITY, 1, 0, cond);

  // assembly.cell_balances' tangents, zero in ghost rows
  const T phi = T(porosity[i]);
  const T rock_heat = Op<T>::mul(T(rock_density[i]), T(specific_heat[i]));
  const Dual<T> w_l = sl * rho_l, w_v = sv * rho_v;
  const Dual<T> mass_w = (w_l * x_l[0] + w_v * x_v[0]) * (double)phi;
  const Dual<T> mass_g = (w_l * x_l[1] + w_v * x_v[1]) * (double)phi;
  const Dual<T> energy = (w_l * u_l + w_v * u_v) * (double)phi +
                         t * (double)rock_heat * (double)Op<T>::sub(T(1), phi);
  const bool g = ghost[i] != 0;
  const Dual<T> L[NPV] = {mass_w, mass_g, energy};
#pragma unroll
  for (int e = 0; e < NPV; ++e) {
#pragma unroll
    for (int k = 0; k < NPV; ++k)
      D[(int64_t)k * TANGENT_COLUMNS * n + (int64_t)F_BALANCES * n + i * NPV + e] =
          g ? T(0) : L[e].d[k];
  }
  phases[i] = phase;
  if (err_out != nullptr) err_out[i] = err;
}

template <typename T>
static int launch(const double* y, const int* region, const double* porosity,
                  const double* rock_density, const double* specific_heat,
                  const double* wet_conductivity,
                  const double* dry_conductivity, const unsigned char* ghost,
                  const WgeParams* prm, T* P, T* D, int* phases,
                  unsigned char* err, int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  wge_cell_jvp_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      y, region, porosity, rock_density, specific_heat, wet_conductivity,
      dry_conductivity, ghost, *prm, P, D, phases, err, n);
  return (int)cudaGetLastError();
}

// y [n, 3] f64, region [n] int32, the rock fields [n] f64 and ghost [n]
// bool, contiguous on the current device; P [24 n], D [3, 27 n] and phases
// [n] the outputs (Column), err [n] or null. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int wge_cell_jvp_f32(const double* y, const int* region,
                                const double* porosity,
                                const double* rock_density,
                                const double* specific_heat,
                                const double* wet_conductivity,
                                const double* dry_conductivity,
                                const unsigned char* ghost,
                                const WgeParams* prm, float* P, float* D,
                                int* phases, unsigned char* err, int64_t n,
                                void* stream) {
  return launch<float>(y, region, porosity, rock_density, specific_heat,
                       wet_conductivity, dry_conductivity, ghost, prm, P, D,
                       phases, err, n, stream);
}

extern "C" int wge_cell_jvp_f64(const double* y, const int* region,
                                const double* porosity,
                                const double* rock_density,
                                const double* specific_heat,
                                const double* wet_conductivity,
                                const double* dry_conductivity,
                                const unsigned char* ghost,
                                const WgeParams* prm, double* P, double* D,
                                int* phases, unsigned char* err, int64_t n,
                                void* stream) {
  return launch<double>(y, region, porosity, rock_density, specific_heat,
                        wet_conductivity, dry_conductivity, ghost, prm, P, D,
                        phases, err, n, stream);
}
