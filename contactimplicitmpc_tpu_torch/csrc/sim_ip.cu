// The quadruped's sim step on NVIDIA Hopper (sm_90a): its residual for the
// warp interior-point solve of sim_ip.cuh, and the entry point that
// ops/sim_ip.py loads.
//
// The model is models/quadruped.py::Quadruped on env.flat_2d_lc (linearized
// cone: nz 43, ntheta 34, nx 11, ny 16); its constants arrive packed
// (ops/sim_ip.py::pack_quadruped), so quadruped and quadruped_payload share
// one build. The residual r(z, theta, kappa) is sim/residual.py's with
// models/base.py::dynamics (the midpoint Euler-Lagrange terms, B^T u, A^T w,
// J^T lambda, the joint damping), phi (the feet's heights on flat ground),
// the tangential velocity stack and the E-mapping rows, from the quadruped's
// lever-arm closed forms: every body and foot is
// (x, z) + sum_j arm_j (sin th_j, -cos th_j) over the absolute angles, so
// M(q) v and the bias are sums over the nine bodies of J_b^T(m_b ...)
// without forming M. The midpoint-1 terms, B^T u and A^T w depend on theta
// alone and are formed once a solve (theta_terms). The lever-arm table is
// sparse (a body or foot hangs on at most three angles): the loops skip its
// zeros, a branch the whole warp takes alike.
//
// Arithmetic: float64 for float32 and float64 tensors alike, the outputs
// rounded to the tensors' type. A float32 solve stalls where the float64
// one does not: phase L's closed loop (tests/test_mpc_quadruped.py's 1000
// steps, float32) through this solve in float32 arithmetic met a state
// where float32 solves, the plain version's too, end their 40 trips with
// kvio just above kappa_tol, while the float64 solve of the same float32
// problem converges in 9 trips; the contract wants every step converged.
// tools/sim_ip_f32_stall.py replays that state; it builds this file with
// -DSIM_IP_FLOAT32_ARITHMETIC, which makes float32 tensors compute in
// float32. So a float32 problem is held to the plain version within the
// spread of two correct solves (tools/sim_ip_spread.py), not bit for bit.

#include "sim_ip.cuh"

namespace {

using sim_ip::Dual;
using sim_ip::sin_cos;

// The quadruped on flat_2d_lc.
constexpr int NQ = 11, NU = 8, NW = 2, NC = 4, NB = 8;
constexpr int NY = 2 * NC + NB;
constexpr int NT = 2 * NQ + NU + NW + 2;
constexpr int NA = NQ - 2;          // absolute angles
constexpr int NBODY = 9, NPOINT = 13;

// z = [q2; gamma1; b1; psi1; s1; eta1; s2], theta = [q0; q1; u1; w1; mu; h]
constexpr int Z_G = NQ, Z_B = Z_G + NC, Z_P = Z_B + NB, Z_S1 = Z_P + NC;
constexpr int Z_ETA = Z_S1 + NC, Z_S2 = Z_ETA + NB;
constexpr int T_Q0 = 0, T_Q1 = NQ, T_U = 2 * NQ, T_W = T_U + NU;
constexpr int T_MU = T_W + NW, T_H = T_MU + 1;

// The packed model (ops/sim_ip.py::pack_quadruped): lever arms (13 x 9:
// torso, (thigh, calf) x 4, feet 1-4), masses (9), inertias (9), joint
// friction (11), B (8 x 11), A (2 x 11), g.
constexpr int P_ARMS = 0, P_MASS = P_ARMS + NPOINT * NA, P_INERTIA = P_MASS + NBODY;
constexpr int P_JF = P_INERTIA + NBODY, P_B = P_JF + NQ, P_A = P_B + NU * NQ;
constexpr int P_G = P_A + NW * NQ;
constexpr int kPackSize = P_G + 1;
static_assert(NQ + 2 * NY == 43 && NT == 34, "the quadruped's dimensions");

// Midpoint terms of one Euler-Lagrange half: sum_b J_b^T m_b (sgn J_b v -
// h/2 (Jdot_b v + g e_z)) + sgn I v over the nine bodies, into acc; q is
// the midpoint configuration (its angles given as sin/cos), v the velocity.
// With sgn = +1 it is h/2 D1L + D2L at (q_m1, v_m1), with -1 it is
// h/2 D1L - D2L at (q_m2, v_m2) (models/base.py::dynamics, D1L = -bias,
// D2L = M v).
template <class T, class S, class V>
__device__ __forceinline__ void midpoint_terms(const S* pk, const T (&sn)[NA],
                                               const T (&cs)[NA], const V& v,
                                               S sgn, S hh, T (&acc)[NQ]) {
  const S g = pk[P_G];
#pragma unroll
  for (int b = 0; b < NBODY; ++b) {
    T jvx = v(0), jvz = v(1), jdx = T(S(0)), jdz = T(S(0));
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const S a = pk[P_ARMS + NA * b + j];
      if (a == S(0)) continue;
      const T av = a * v(2 + j);
      jvx += av * cs[j];
      jvz += av * sn[j];
      const T w = av * v(2 + j);
      jdx -= w * sn[j];
      jdz += w * cs[j];
    }
    const S m = pk[P_MASS + b];
    const T fx = m * (sgn * jvx - hh * jdx);
    const T fz = m * (sgn * jvz - hh * (jdz + T(g)));
    acc[0] += fx;
    acc[1] += fz;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const S a = pk[P_ARMS + NA * b + j];
      if (a == S(0)) continue;
      acc[2 + j] += a * (cs[j] * fx + sn[j] * fz);
    }
  }
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[2 + j] += (sgn * pk[P_INERTIA + j]) * v(2 + j);
}

struct QuadrupedFlat {
  static constexpr int NQ = ::NQ, NX = ::NQ, NY = ::NY, NT = ::NT, NCST = ::NQ;
  static constexpr int kPackSize = ::kPackSize;

  // The terms of the dynamics rows that depend on theta alone: h/2 D1L + D2L
  // at the first midpoint, B^T u and A^T w.
  template <class S>
  __device__ static void theta_terms(const S* pk, const S* th, S (&acc)[NQ]) {
    const S h = th[T_H], hh = S(0.5) * h;
    S sn[NA], cs[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j)
      sin_cos(S(0.5) * (th[T_Q0 + 2 + j] + th[T_Q1 + 2 + j]), sn[j], cs[j]);
#pragma unroll
    for (int k = 0; k < NQ; ++k) acc[k] = S(0);
    auto v = [&](int k) { return (th[T_Q1 + k] - th[T_Q0 + k]) / h; };
    midpoint_terms<S, S>(pk, sn, cs, v, S(1), hh, acc);
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      S bu = S(0), aw = S(0);
      for (int r = 0; r < NU; ++r) bu += pk[P_B + NQ * r + k] * th[T_U + r];
      for (int r = 0; r < NW; ++r) aw += pk[P_A + NQ * r + k] * th[T_W + r];
      acc[k] = (acc[k] + bu) + aw;
    }
  }

  // The equality rows of r(z, theta, .) (dynamics, impact, maximum
  // dissipation, friction cone), each handed to put(row, value) in order;
  // zf(i) gives z_i as a T, cst the theta terms of the dynamics.
  template <class T, class S, class Z, class Put>
  __device__ static __forceinline__ void equality_rows(const S* pk, const S* th, const S* cst,
                                                       const Z& zf, Put put) {
    const S h = th[T_H], hh = S(0.5) * h, mu = th[T_MU];
    T acc[NQ];
#pragma unroll
    for (int k = 0; k < NQ; ++k) acc[k] = T(cst[k]);
    auto vm = [&](int k) { return (zf(k) - T(th[T_Q1 + k])) / h; };
    {
      T sn[NA], cs[NA];
#pragma unroll
      for (int j = 0; j < NA; ++j) sin_cos(S(0.5) * (T(th[T_Q1 + 2 + j]) + zf(2 + j)), sn[j], cs[j]);
      midpoint_terms<T, S>(pk, sn, cs, vm, S(-1), hh, acc);
    }
#pragma unroll
    for (int k = 0; k < NQ; ++k) acc[k] -= (h * pk[P_JF + k]) * vm(k);

    // J(q2)^T lambda, the feet's heights and tangential velocities
    T phi[NC], vt[NC];
    {
      T sn[NA], cs[NA];
#pragma unroll
      for (int j = 0; j < NA; ++j) sin_cos(zf(2 + j), sn[j], cs[j]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = NBODY + c;
        const T lx = zf(Z_B + 2 * c) - zf(Z_B + 2 * c + 1), lz = zf(Z_G + c);
        acc[0] += lx;
        acc[1] += lz;
        T fz = zf(1), vx = zf(0) - T(th[T_Q1]);
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          const S a = pk[P_ARMS + NA * f + j];
          if (a == S(0)) continue;
          acc[2 + j] += a * (cs[j] * lx + sn[j] * lz);
          fz -= a * cs[j];
          vx += (a * cs[j]) * (zf(2 + j) - T(th[T_Q1 + 2 + j]));
        }
        phi[c] = fz;
        vt[c] = vx / h;
      }
    }
#pragma unroll
    for (int k = 0; k < NQ; ++k) put(k, acc[k]);
#pragma unroll
    for (int c = 0; c < NC; ++c) put(NQ + c, zf(Z_S1 + c) - phi[c]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const T p = zf(Z_P + c);
      put(NQ + NC + 2 * c, (zf(Z_ETA + 2 * c) - vt[c]) - p);
      put(NQ + NC + 2 * c + 1, (zf(Z_ETA + 2 * c + 1) + vt[c]) - p);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      put(NQ + NC + NB + c,
          zf(Z_S2 + c) - (mu * zf(Z_G + c) - (zf(Z_B + 2 * c) + zf(Z_B + 2 * c + 1))));
  }
};

#ifdef SIM_IP_FLOAT32_ARITHMETIC
using Float32Arithmetic = float;
#else
using Float32Arithmetic = double;
#endif

}  // namespace

// The packed model's length (ops/sim_ip.py::pack_quadruped holds it to its
// own) and the bytes of the type a float32 problem is computed in.
extern "C" int sim_ip_pack_size() { return kPackSize; }
extern "C" int sim_ip_float32_arithmetic_bytes() { return int(sizeof(Float32Arithmetic)); }

// One sim step's solve of n problems: z0 (n, 43) and theta (n, 34) in
// float32 (elem_bytes 4) or float64 (8), the packed model in float64; z
// (n, 43), rvio and kvio (n,) in the inputs' type, conv (n,) bool and iters
// (n,) int32 out (sim_ip::dispatch).
extern "C" int sim_ip_launch(int elem_bytes, const void* pack, const void* z0,
                             const void* theta, void* z, void* conv, void* iters,
                             void* rvio, void* kvio, int n, int fixed_iters,
                             int max_iter, int retries, int refine, int max_ls,
                             double r_tol, double kappa_tol, double kappa_floor,
                             double gamma_reg, double tau_min, double tau_max,
                             double eps_min, void* stream) {
  return sim_ip::dispatch<QuadrupedFlat, Float32Arithmetic>(
      elem_bytes, pack, z0, theta, z, conv, iters, rvio, kvio, n, fixed_iters, max_iter,
      retries, refine, max_ls, r_tol, kappa_tol, kappa_floor, gamma_reg, tau_min, tau_max,
      eps_min, stream);
}
