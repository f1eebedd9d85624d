// The quadruped's sim step on NVIDIA Hopper (sm_90a): its residual and
// Jacobian for the block interior-point solve of sim_ip.cuh, and the entry
// point that ops/sim_ip.py loads.
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
// sparse (a body or foot hangs on at most three angles): the loops run over
// its nonzeros, listed in the packed table.
//
// A point's residual in three stages between barriers, the work of each
// split over a group's threads: the eighteen sines and cosines (the nine
// angles at the second midpoint and at q2), a thread an angle; the nine
// bodies' forces (fx, fz) = m_b (sgn J_b v - h/2 (Jdot_b v + g e_z)); the
// 27 equality rows, a thread a row, each a sum over the bodies and feet.
//
// The Jacobian in (x, y1), written out (tests/test_torch_sim_ip.py's
// packed_jacobian mirrors it), in two stages across the block, from the
// sines, cosines and forces the iterate's residual left: for each body b
// and column k of q2, the derivative (dfx, dfz) of its force (through the
// velocity v = (q2 - q1)/h and the midpoint angle (q1 + q2)/2); then the
// 27 x 27 entries, a thread an entry: a dynamics row over q2 sums the bodies'
// derivatives through the lever arms, plus on the diagonal the angle's own
// term (the midpoint angle's rotation of the forces, the inertia, the joint
// damping and the feet's forces turned at q2); the rest are the contact
// Jacobian at q2, the feet's velocity rows and the friction cone's constants.
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

using sim_ip::sin_cos;

// The quadruped on flat_2d_lc.
constexpr int NQ = 11, NU = 8, NW = 2, NC = 4, NB = 8;
constexpr int NY = 2 * NC + NB;
constexpr int NT = 2 * NQ + NU + NW + 2;
constexpr int NA = NQ - 2;          // absolute angles
constexpr int NBODY = 9, NPOINT = 13;
constexpr int NE = NQ + NY;

// z = [q2; gamma1; b1; psi1; s1; eta1; s2], theta = [q0; q1; u1; w1; mu; h]
constexpr int Z_G = NQ, Z_B = Z_G + NC, Z_P = Z_B + NB, Z_S1 = Z_P + NC;
constexpr int Z_ETA = Z_S1 + NC, Z_S2 = Z_ETA + NB;
constexpr int T_Q0 = 0, T_Q1 = NQ, T_U = 2 * NQ, T_W = T_U + NU;
constexpr int T_MU = T_W + NW, T_H = T_MU + 1;

// The packed model (ops/sim_ip.py::pack_quadruped): lever arms (13 x 9:
// torso, (thigh, calf) x 4, feet 1-4), masses (9), inertias (9), joint
// friction (11), B (8 x 11), A (2 x 11), g, and the lever arms' nonzeros as
// lists (a count, then (index, arm) pairs in ascending index): each point's
// angles, each angle's bodies, each angle's feet.
constexpr int kPointAngles = 3, kAngleBodies = 5, kAngleFeet = 2;
constexpr int P_ARMS = 0, P_MASS = P_ARMS + NPOINT * NA, P_INERTIA = P_MASS + NBODY;
constexpr int P_JF = P_INERTIA + NBODY, P_B = P_JF + NQ, P_A = P_B + NU * NQ;
constexpr int P_G = P_A + NW * NQ, P_PA = P_G + 1;
constexpr int P_AB = P_PA + NPOINT * (1 + 2 * kPointAngles);
constexpr int P_AF = P_AB + NA * (1 + 2 * kAngleBodies);
constexpr int kPackSize = P_AF + NA * (1 + 2 * kAngleFeet);
static_assert(NQ + 2 * NY == 43 && NT == 34, "the quadruped's dimensions");

// A point's scratch: the sines and cosines of the nine angles at the second
// midpoint and at q2, then the nine bodies' forces.
constexpr int E_SN = 0, E_CS = NA, E_SN2 = 2 * NA, E_CS2 = 3 * NA, E_FX = 4 * NA,
              E_FZ = E_FX + NBODY, kEvalScratch = E_FZ + NBODY;
// The Jacobian's scratch: each body's force derivative (dfx, dfz) along each
// column of q2 (the iterate's trigonometry and forces are its residual's).
constexpr int J_D = 0, kJacScratch = J_D + 2 * NBODY * NQ;

__device__ __forceinline__ int arm(int point, int j) { return P_ARMS + NA * point + j; }

// f(index, arm) over a list of the packed table's lever-arm nonzeros
template <class S, class F>
__device__ __forceinline__ void each(const S* list, F f) {
  const int n = int(list[0]);
#pragma unroll 1
  for (int e = 0; e < n; ++e) f(int(list[1 + 2 * e]), list[2 + 2 * e]);
}
template <class S>
__device__ __forceinline__ const S* point_angles(const S* pk, int p) {
  return pk + P_PA + (1 + 2 * kPointAngles) * p;
}
template <class S>
__device__ __forceinline__ const S* angle_bodies(const S* pk, int j) {
  return pk + P_AB + (1 + 2 * kAngleBodies) * j;
}
template <class S>
__device__ __forceinline__ const S* angle_feet(const S* pk, int j) {
  return pk + P_AF + (1 + 2 * kAngleFeet) * j;
}

// One body's force at a midpoint: m_b (sgn J_b v - h/2 (Jdot_b v + g e_z)),
// the midpoint's angles as sines and cosines, v(k) the velocity.
template <class S, class V>
__device__ __forceinline__ void body_force(const S* pk, int b, const S* sn, const S* cs,
                                           const V& v, S sgn, S hh, S& fx, S& fz) {
  S jvx = v(0), jvz = v(1), jdx = S(0), jdz = S(0);
  each(point_angles(pk, b), [&](int j, S a) {
    const S av = a * v(2 + j);
    jvx += av * cs[j];
    jvz += av * sn[j];
    const S w = av * v(2 + j);
    jdx -= w * sn[j];
    jdz += w * cs[j];
  });
  const S m = pk[P_MASS + b];
  fx = m * (sgn * jvx - hh * jdx);
  fz = m * (sgn * jvz - hh * (jdz + pk[P_G]));
}

// sum_b J_b^T (fx_b, fz_b) in row k of the dynamics (k >= 2: angle k - 2).
template <class S>
__device__ __forceinline__ S body_sum(const S* pk, int k, const S* sn, const S* cs,
                                      const S* fx, const S* fz) {
  S acc = S(0);
  if (k < 2) {
    const S* f = k == 0 ? fx : fz;
#pragma unroll 1
    for (int b = 0; b < NBODY; ++b) acc += f[b];
    return acc;
  }
  const int j = k - 2;
  each(angle_bodies(pk, j), [&](int b, S a) { acc += a * (cs[j] * fx[b] + sn[j] * fz[b]); });
  return acc;
}

struct QuadrupedFlat {
  static constexpr int NQ = ::NQ, NX = ::NQ, NY = ::NY, NT = ::NT, NCST = ::NQ + 1;
  static constexpr int kPackSize = ::kPackSize;
  static constexpr int kEvalScratch = ::kEvalScratch, kJacScratch = ::kJacScratch;

  // The terms of the dynamics rows that depend on theta alone: h/2 D1L + D2L
  // at the first midpoint, B^T u and A^T w; then 1 / h.
  template <class S>
  __device__ static void theta_terms(const S* pk, const S* th, S* cst, S* scr, int t) {
    const S h = th[T_H], hh = S(0.5) * h;
    auto v = [&](int k) { return (th[T_Q1 + k] - th[T_Q0 + k]) / h; };
    if (t < NA)
      sin_cos(S(0.5) * (th[T_Q0 + 2 + t] + th[T_Q1 + 2 + t]), scr[E_SN + t], scr[E_CS + t]);
    __syncthreads();
    if (t < NBODY)
      body_force(pk, t, scr + E_SN, scr + E_CS, v, S(1), hh, scr[E_FX + t], scr[E_FZ + t]);
    __syncthreads();
    if (t < NQ) {
      S acc = body_sum(pk, t, scr + E_SN, scr + E_CS, scr + E_FX, scr + E_FZ);
      if (t >= 2) acc += pk[P_INERTIA + t - 2] * v(t);
      S bu = S(0), aw = S(0);
      for (int r = 0; r < NU; ++r) bu += pk[P_B + NQ * r + t] * th[T_U + r];
      for (int r = 0; r < NW; ++r) aw += pk[P_A + NQ * r + t] * th[T_W + r];
      cst[t] = (acc + bu) + aw;
    }
    if (t == NQ) cst[NQ] = S(1) / h;
  }

  // The equality rows of r(z, theta, .) at the point zf (dynamics, impact,
  // maximum dissipation, friction cone) into out, split over a group's G
  // threads (this thread g; g >= G idle: it writes nothing and only takes
  // part in the barriers); cst holds theta_terms. Returns the sum of the
  // squares of this thread's rows.
  template <class S, class Z>
  __device__ static S rows(const S* pk, const S* th, const S* cst, const Z& zf, S* scr,
                           S* out, int g, int G) {
    const S h = th[T_H], hh = S(0.5) * h, mu = th[T_MU], ih = cst[NQ];
    auto vm = [&](int k) { return (zf(k) - th[T_Q1 + k]) * ih; };
    const bool idle = g >= G;   // no rows: only the barriers
    for (int k = g; !idle && k < 2 * NA; k += G) {
      if (k < NA)
        sin_cos(S(0.5) * (th[T_Q1 + 2 + k] + zf(2 + k)), scr[E_SN + k], scr[E_CS + k]);
      else
        sin_cos(zf(2 + k - NA), scr[E_SN2 + k - NA], scr[E_CS2 + k - NA]);
    }
    __syncthreads();
    for (int b = g; !idle && b < NBODY; b += G)
      body_force(pk, b, scr + E_SN, scr + E_CS, vm, S(-1), hh, scr[E_FX + b], scr[E_FZ + b]);
    __syncthreads();
    const S* sn2 = scr + E_SN2;
    const S* cs2 = scr + E_CS2;
    S squares = S(0);
    for (int i = g; !idle && i < NE; i += G) {
      S row;
      if (i < NQ) {
        // the dynamics: theta's terms, the second midpoint's, the joint
        // damping, J(q2)^T lambda
        S acc = cst[i] + body_sum(pk, i, scr + E_SN, scr + E_CS, scr + E_FX, scr + E_FZ);
        if (i >= 2) acc += (S(-1) * pk[P_INERTIA + i - 2]) * vm(i);
        acc -= (h * pk[P_JF + i]) * vm(i);
        if (i < 2) {
#pragma unroll 1
          for (int c = 0; c < NC; ++c)
            acc += i == 0 ? zf(Z_B + 2 * c) - zf(Z_B + 2 * c + 1) : zf(Z_G + c);
        } else {
          const int j = i - 2;
          each(angle_feet(pk, j), [&](int c, S a) {
            const S lx = zf(Z_B + 2 * c) - zf(Z_B + 2 * c + 1), lz = zf(Z_G + c);
            acc += a * (cs2[j] * lx + sn2[j] * lz);
          });
        }
        row = acc;
      } else if (i < NQ + NC) {
        // impact: s1 - phi, the foot's height
        const int c = i - NQ;
        S phi = zf(1);
        each(point_angles(pk, NBODY + c), [&](int j, S a) { phi -= a * cs2[j]; });
        row = zf(Z_S1 + c) - phi;
      } else if (i < NQ + NC + NB) {
        // maximum dissipation: eta -+ vt - psi, vt the foot's tangential
        // velocity
        const int m = i - NQ - NC, c = m >> 1;
        S vx = zf(0) - th[T_Q1];
        each(point_angles(pk, NBODY + c),
             [&](int j, S a) { vx += (a * cs2[j]) * (zf(2 + j) - th[T_Q1 + 2 + j]); });
        const S vt = vx * ih, p = zf(Z_P + c);
        row = (m & 1) ? (zf(Z_ETA + m) + vt) - p : (zf(Z_ETA + m) - vt) - p;
      } else {
        // friction cone
        const int c = i - NQ - NC - NB;
        row = zf(Z_S2 + c) - (mu * zf(Z_G + c) - (zf(Z_B + 2 * c) + zf(Z_B + 2 * c + 1)));
      }
      out[i] = row;
      squares = sim_ip::sq_add(squares, row);
    }
    return squares;
  }

  // The Jacobian of the equality rows in (x, y1) = z[0 .. NE) at z into jac
  // (row stride ldj), written out (the file's header); ev is the scratch
  // rows left at z (its sines, cosines and forces).
  template <class S>
  __device__ static void jacobian(const S* pk, const S* th, const S* cst, const S* z,
                                  const S* ev, S* scr, S* jac, int ldj, int t) {
    const S hh = S(0.5) * th[T_H], mu = th[T_MU], ih = cst[NQ];
    auto vm = [&](int k) { return (z[k] - th[T_Q1 + k]) * ih; };
    const S* sn = ev + E_SN;
    const S* cs = ev + E_CS;
    const S* sn2 = ev + E_SN2;
    const S* cs2 = ev + E_CS2;
    S* dfx = scr + J_D;                 // [b][k]
    S* dfz = scr + J_D + NBODY * NQ;
    if (t < NBODY * NQ) {
      const int b = t / NQ, k = t % NQ;
      const S m = pk[P_MASS + b];
      S dx = S(0), dz = S(0);
      if (k < 2) {
        // v_k = (q2_k - q1_k) / h moves J_b v by 1/h along x or z
        (k == 0 ? dx : dz) = -m * ih;
      } else {
        const int i = k - 2;
        const S a = pk[arm(b, i)];
        if (a != S(0)) {
          // v_i moves by 1/h, the midpoint angle by 1/2
          const S vi = vm(k), c = cs[i], s = sn[i];
          const S djvx = a * (c * ih - S(0.5) * vi * s);
          const S djvz = a * (s * ih + S(0.5) * vi * c);
          const S djdx = -a * (S(2) * vi * s * ih + S(0.5) * vi * vi * c);
          const S djdz = a * (S(2) * vi * c * ih - S(0.5) * vi * vi * s);
          dx = m * (-djvx - hh * djdx);
          dz = m * (-djvz - hh * djdz);
        }
      }
      dfx[NQ * b + k] = dx;
      dfz[NQ * b + k] = dz;
    }
    __syncthreads();
    const S* fx = ev + E_FX;
    const S* fz = ev + E_FZ;
#pragma unroll 1
    for (int e = t; e < NE * NE; e += sim_ip::kThreads) {
      const int i = e / NE, k = e % NE;
      S v = S(0);
      if (i < NQ) {
        if (k < NQ) {
          // the dynamics along q2: sum_b J_b^T d(fx_b, fz_b), and on the
          // diagonal the angle's own terms
          if (i < 2) {
            const S* d = i == 0 ? dfx : dfz;
#pragma unroll 1
            for (int b = 0; b < NBODY; ++b) v += d[NQ * b + k];
          } else {
            const int j = i - 2;
            each(angle_bodies(pk, j), [&](int b, S a) {
              v += a * (cs[j] * dfx[NQ * b + k] + sn[j] * dfz[NQ * b + k]);
            });
          }
          if (k == i) {
            v -= pk[P_JF + i];
            if (i >= 2) {
              const int j = i - 2;
              S rot = S(0);
              each(angle_bodies(pk, j),
                   [&](int b, S a) { rot += a * (cs[j] * fz[b] - sn[j] * fx[b]); });
              v += S(0.5) * rot - pk[P_INERTIA + j] * ih;
              each(angle_feet(pk, j), [&](int c, S a) {
                const S lx = z[Z_B + 2 * c] - z[Z_B + 2 * c + 1], lz = z[Z_G + c];
                v += a * (cs2[j] * lz - sn2[j] * lx);
              });
            }
          }
        } else if (k < Z_B) {
          // lambda_z = gamma_c
          const int c = k - Z_G;
          v = i == 1 ? S(1) : (i >= 2 ? pk[arm(NBODY + c, i - 2)] * sn2[i - 2] : S(0));
        } else if (k < Z_P) {
          // lambda_x = b_2c - b_2c+1
          const int c = (k - Z_B) >> 1;
          const S sg = ((k - Z_B) & 1) ? S(-1) : S(1);
          v = i == 0 ? sg : (i >= 2 ? sg * (pk[arm(NBODY + c, i - 2)] * cs2[i - 2]) : S(0));
        }
      } else if (i < NQ + NC) {
        // impact: -d phi
        const int c = i - NQ;
        if (k == 1) v = S(-1);
        else if (k >= 2 && k < NQ) v = -(pk[arm(NBODY + c, k - 2)] * sn2[k - 2]);
      } else if (i < NQ + NC + NB) {
        // maximum dissipation: -+ d vt, -1 along psi
        const int m = i - NQ - NC, c = m >> 1;
        const S sg = (m & 1) ? S(1) : S(-1);
        if (k == 0) {
          v = sg * ih;
        } else if (k >= 2 && k < NQ) {
          const int j = k - 2;
          const S a = pk[arm(NBODY + c, j)];
          if (a != S(0)) v = sg * (a * (cs2[j] - sn2[j] * (z[k] - th[T_Q1 + k]))) * ih;
        } else if (k == Z_P + c) {
          v = S(-1);
        }
      } else {
        // friction cone
        const int c = i - NQ - NC - NB;
        if (k == Z_G + c) v = -mu;
        else if (k == Z_B + 2 * c || k == Z_B + 2 * c + 1) v = S(1);
      }
      jac[ldj * i + k] = v;
    }
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
