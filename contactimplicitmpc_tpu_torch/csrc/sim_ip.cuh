// The sim step's contact-NCP interior-point solve on NVIDIA Hopper (sm_90a),
// one warp a problem, in one launch a sim step: the model-independent part.
//
// No TPU kernel is replaced: the JAX package runs this solve as one compiled
// program, contactimplicitmpc_tpu/sim/interior_point.py::ip_solve (the
// fori_loop of fixed iterations or the while_loop, :432-440, its trip body
// :343-415, the NCP Schur backend :155-222), which XLA fuses. The port's
// plain version is contactimplicitmpc_tpu_torch/sim/interior_point.py::
// ip_program with make_ncp_schur_solver (replayed as CUDA graphs of ~1.2k
// small PyTorch kernels a trip on the quadruped, sim/graphs.py). This header
// computes the same function on the linearized cone for any model whose
// residual is handed to it as a type M (sim_ip.cu holds the quadruped's):
//
//   struct M {
//     static constexpr int NQ, NX, NY, NT;   // q, x = q2, y = (gamma, b, psi), theta
//     static constexpr int NCST;             // theta-only terms of the rows
//     static constexpr int kPackSize;        // the packed constants
//     template <class S> static void theta_terms(pk, th, S (&cst)[NCST]);
//     template <class T, class S, class Z, class Put>
//     static void equality_rows(pk, th, cst, zf, put);  // the NX + NY rows
//   };
//
// with z = [x; y1; y2] (y1 = (gamma, b, psi), y2 their slacks), the NX + NY
// equality rows a function of z's first NX + NY entries, and the NY
// complementarity rows y1 o y2 - kappa. pk is the packed table in shared
// memory, th the problem's theta, zf(i) the i-th entry of z as a T (a value
// or a dual number), put(row, value) receives the rows in order.
//
// What it computes, per problem (one lane's sim step):
// - the Jacobian of the equality rows in (x, y1), the jacfwd of
//   interior_point.py: lane j evaluates those rows in forward-mode dual
//   numbers seeded with direction j and writes column j;
// - the Schur backend: Dx^-1 (NX x NX) and the inverse of
//   S = Ry1 - diag(y2r / y1r) - Rx Dx^-1 Dy1 (NY x NY) by unpivoted
//   Gauss-Jordan with the type's `tiny` pivot floor (ops/linsolve.py::
//   gj_inverse), y1r and y2r the gamma_reg-clamped cone variables, and the
//   back-substitution of make_ncp_schur_solver's `solve`;
// - one trip of `body`: the affine direction, sigma = (mu_aff / mu)^3 and the
//   kappa floor, the corrector and centering directions with `refine`
//   passes against the regularized operator (apply_reg_jacobian), tau, the
//   2 (max_ls + 1) line-search candidates spread over the lanes in rounds of
//   32 (candidate c's equality rows kept in shared memory, so the accepted
//   one is the next residual), the pick (the first accepted, else the argmin
//   of the merit, a NaN first as torch.argmin takes it) and the violations;
// - both loops: `fixed_iters > 0` masks trips (a non-finite trial keeps the
//   last finite iterate, and since a trip is a function of the state alone,
//   every later trip of the problem would give the same trial: the problem
//   stops there), else the adaptive loop to `max_iter`; `retries` cold
//   restarts from z_initialize; the divergence guard of `finish`. Each
//   problem is independent, so a problem that is done stops. No
//   sensitivities (diff_sol): no sim step asks for them, and the wrapper
//   raises before a launch that would need them.
// Every max/min propagates NaN as torch.maximum/minimum/clamp do.
//
// What bounds it: neither bytes nor operations but one problem's chain of
// dependent steps. A few problems fill a few of the 132 SMs with one warp
// each, so the card's rates are far away and the time is one problem's
// latency: NX + NY dual residual evaluations side by side, two Gauss-Jordans
// in registers, three structured solves and a round of candidate residuals a
// trip.
//
// Design:
// - A warp owns one problem and keeps it in shared memory (the iterate, its
//   residual, theta, the Jacobian, Dx^-1, Rx Dx^-1, S^-1, the directions)
//   plus NX + NY values a line-search candidate; a block holds 1 warp below
//   512 problems, so that the problems spread over the SMs, 4 from 512 on.
//   The model's constants sit once a block in shared memory; lanes read them
//   as broadcasts. Nothing intermediate goes to device memory.
// - Gauss-Jordan in registers: lane j holds column j of [A | I], the pivot
//   column travels by shuffle (knot_ip.cu's gj_columns, with a division by
//   the pivot as gj_inverse has it). So NX + NY, 2 NX and 2 NY fit a warp.
// - The step z - alpha d is formed with rounded product and difference
//   (__dmul_rn/__dsub_rn, __fmul_rn/__fsub_rn), never a fused multiply-add,
//   wherever it appears, so that a candidate's residual is bit for bit the
//   residual of the iterate it becomes.
// - S is the type the solve computes in, IO the tensors' type; the entry
//   point of a model (`dispatch`) picks S for float32 tensors.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace sim_ip {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;
constexpr int kMaxLs = 63;  // at most 128 candidates, 4 rounds

struct Opts {
  int fixed_iters, max_iter, retries, refine, max_ls;
  double r_tol, kappa_tol, kappa_floor, gamma_reg, tau_min, tau_max, eps_min;
};

// ---- scalars and forward-mode duals --------------------------------------

template <class S>
struct Dual {
  S v, d;
  Dual() = default;
  __device__ Dual(S x) : v(x), d(S(0)) {}
  __device__ Dual(S x, S dx) : v(x), d(dx) {}
};
template <class S>
__device__ __forceinline__ Dual<S> operator+(Dual<S> a, Dual<S> b) { return {a.v + b.v, a.d + b.d}; }
template <class S>
__device__ __forceinline__ Dual<S> operator-(Dual<S> a, Dual<S> b) { return {a.v - b.v, a.d - b.d}; }
template <class S>
__device__ __forceinline__ Dual<S> operator-(Dual<S> a) { return {-a.v, -a.d}; }
template <class S>
__device__ __forceinline__ Dual<S> operator*(Dual<S> a, Dual<S> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class S>
__device__ __forceinline__ Dual<S> operator*(S a, Dual<S> b) { return {a * b.v, a * b.d}; }
template <class S>
__device__ __forceinline__ Dual<S> operator/(Dual<S> a, S b) { return {a.v / b, a.d / b}; }
template <class S>
__device__ __forceinline__ Dual<S>& operator+=(Dual<S>& a, Dual<S> b) { return a = a + b; }
template <class S>
__device__ __forceinline__ Dual<S>& operator-=(Dual<S>& a, Dual<S> b) { return a = a - b; }

__device__ __forceinline__ void sin_cos(double x, double& s, double& c) { sincos(x, &s, &c); }
__device__ __forceinline__ void sin_cos(float x, float& s, float& c) { sincosf(x, &s, &c); }
template <class S>
__device__ __forceinline__ void sin_cos(Dual<S> x, Dual<S>& s, Dual<S>& c) {
  S sv, cv;
  sin_cos(x.v, sv, cv);
  s = {sv, cv * x.d};
  c = {cv, -sv * x.d};
}

template <class S> struct Lim;
template <> struct Lim<double> {
  static __device__ double tiny() { return DBL_MIN; }
  static __device__ double big() { return DBL_MAX; }
};
template <> struct Lim<float> {
  static __device__ float tiny() { return FLT_MIN; }
  static __device__ float big() { return FLT_MAX; }
};

// z - a d with the product and the difference each rounded (no fused
// multiply-add), as PyTorch forms it.
__device__ __forceinline__ double step(double z, double a, double d) {
  return __dsub_rn(z, __dmul_rn(a, d));
}
__device__ __forceinline__ float step(float z, float a, float d) {
  return __fsub_rn(z, __fmul_rn(a, d));
}

__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ float absval(float x) { return fabsf(x); }

template <class S>
__device__ __forceinline__ S pmax(S a, S b) { return (a != a || a > b) ? a : b; }
template <class S>
__device__ __forceinline__ S pmin(S a, S b) { return (a != a || a < b) ? a : b; }
template <class S>
__device__ __forceinline__ S warp_sum(S v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
template <class S>
__device__ __forceinline__ S warp_max(S v) {
  for (int o = 16; o; o >>= 1) v = pmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
template <class S>
__device__ __forceinline__ S warp_min(S v) {
  for (int o = 16; o; o >>= 1) v = pmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
template <class X>
__device__ __forceinline__ bool finite(X x) { return isfinite(x); }

// ---- one warp's problem in shared memory -----------------------------------

template <class M, class S>
struct Warp {
  static constexpr int NX = M::NX, NY = M::NY, NE = NX + NY, NZ = NX + 2 * NY;
  S th[M::NT], cst[M::NCST];
  S z0[NZ], z[NZ], r[NZ], zn[NZ], rn[NZ];
  S jac[NE][NE + 1];      // jac[row][direction]: Dx, Dy1 over Rx, Ry1
  S dxi[NX][NX + 1];      // Dx^-1
  S cai[NY][NX + 1];      // Rx Dx^-1
  S si[NY][NY + 1];       // the Schur complement's inverse
  S y1r[NY], y2r[NY];
  S daff[NZ], dcor[NZ], dcen[NZ], rc[NZ], rcor[NZ], kd[NZ], dd[NZ];
};

template <class M, class S>
struct Ctx {
  Warp<M, S>& w;
  S* cand;                // NE equality rows a line-search candidate
  const S* pk;
  int lane;
  Opts o;
};

// Inverse of an N x N matrix by unpivoted Gauss-Jordan with the `tiny`
// pivot floor, held by columns across a warp: lane j < N enters with column
// j of the matrix in t, lane N + j with column j of the identity and leaves
// with column j of the inverse.
template <int N, class S>
__device__ __forceinline__ void gj_columns(S (&t)[N]) {
  static_assert(2 * N <= 32, "the tableau's columns must fit a warp");
  const S tiny = Lim<S>::tiny();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    S piv = __shfl_sync(kFull, t[k], k);
    if (absval(piv) < tiny) piv = piv >= S(0) ? tiny : -tiny;
    const S row = t[k] / piv;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i != k) {
        const S g = __shfl_sync(kFull, t[i], k);
        t[i] = t[i] - g * row;
      }
    }
    t[k] = row;
  }
}

// r(z, theta, 0) at w.z into w.r, and its violations.
template <class M, class S>
__device__ void start(Ctx<M, S>& x, S& rvio, S& kvio) {
  using W = Warp<M, S>;
  constexpr int NX = W::NX, NY = W::NY, NE = W::NE;
  W& w = x.w;
  const int lane = x.lane;
  auto zf = [&](int i) { return w.z[i]; };
  M::template equality_rows<S, S>(x.pk, w.th, w.cst, zf, [&](int row, S v) {
    if (lane == 0) w.r[row] = v;
  });
  if (lane < NY) w.r[NE + lane] = w.z[NX + lane] * w.z[NE + lane] - S(0);
  __syncwarp();
  rvio = warp_max(lane < NE ? absval(w.r[lane]) : S(0));
  kvio = warp_max(lane < NY ? absval(w.r[NE + lane]) : S(0));
}

// The Jacobian and the Schur factors at w.z with the clamp gamma_reg kvio.
template <class M, class S>
__device__ void factor(Ctx<M, S>& x, S kvio) {
  using W = Warp<M, S>;
  constexpr int NX = W::NX, NY = W::NY, NE = W::NE;
  W& w = x.w;
  const int lane = x.lane;
  // lane j < NE: the equality rows along direction j
  auto zf = [&](int i) { return Dual<S>(w.z[i], i == lane ? S(1) : S(0)); };
  M::template equality_rows<Dual<S>, S>(x.pk, w.th, w.cst, zf, [&](int row, Dual<S> v) {
    if (lane < NE) w.jac[row][lane] = v.d;
  });
  if (lane < NY) {
    const S reg = S(x.o.gamma_reg) * kvio;
    w.y1r[lane] = pmax(w.z[NX + lane], reg);
    w.y2r[lane] = pmax(w.z[NE + lane], reg);
  }
  __syncwarp();
  {
    S t[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
      t[i] = lane < NX ? w.jac[i][lane] : (lane - NX == i ? S(1) : S(0));
    gj_columns<NX>(t);
    if (lane >= NX && lane < 2 * NX) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w.dxi[i][lane - NX] = t[i];
    }
  }
  __syncwarp();
  if (lane < NY) {
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      S s = S(0);
#pragma unroll
      for (int m = 0; m < NX; ++m) s += w.jac[NX + lane][m] * w.dxi[m][k];
      w.cai[lane][k] = s;
    }
  }
  __syncwarp();
  {
    S t[NY];
    if (lane < NY) {
      const S dg = w.y2r[lane] / w.y1r[lane];
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        S caib = S(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) caib += w.cai[i][k] * w.jac[k][NX + lane];
        t[i] = (w.jac[NX + i][NX + lane] - (i == lane ? dg : S(0))) - caib;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NY; ++i) t[i] = lane - NY == i ? S(1) : S(0);
    }
    gj_columns<NY>(t);
    if (lane >= NY && lane < 2 * NY) {
#pragma unroll
      for (int i = 0; i < NY; ++i) w.si[i][lane - NY] = t[i];
    }
  }
  __syncwarp();
}

// out = K^-1 rhs through the Schur factors (rhs and out in shared memory,
// distinct).
template <class M, class S>
__device__ void solve(Ctx<M, S>& x, const S* rhs, S* out) {
  using W = Warp<M, S>;
  constexpr int NX = W::NX, NY = W::NY, NE = W::NE;
  W& w = x.w;
  const int lane = x.lane;
  S u = S(0);
  if (lane < NY) {
    S cr = S(0);
#pragma unroll
    for (int k = 0; k < NX; ++k) cr += w.cai[lane][k] * rhs[k];
    u = (rhs[NX + lane] - rhs[NE + lane] / w.y1r[lane]) - cr;
  }
  S dy1 = S(0);
#pragma unroll
  for (int k = 0; k < NY; ++k) {
    const S uk = __shfl_sync(kFull, u, k);
    if (lane < NY) dy1 += w.si[lane][k] * uk;
  }
  S wk = S(0);
#pragma unroll
  for (int m = 0; m < NY; ++m) {
    const S dm = __shfl_sync(kFull, dy1, m);
    if (lane < NX) wk += w.jac[lane][NX + m] * dm;
  }
  if (lane < NX) wk = rhs[lane] - wk;
  S dx = S(0);
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    const S wv = __shfl_sync(kFull, wk, k);
    if (lane < NX) dx += w.dxi[lane][k] * wv;
  }
  if (lane < NX) out[lane] = dx;
  if (lane < NY) {
    out[NX + lane] = dy1;
    out[NE + lane] = (rhs[NE + lane] - w.y2r[lane] * dy1) / w.y1r[lane];
  }
  __syncwarp();
}

// One structured solve and `refine` passes of iterative refinement against
// the regularized operator (apply_reg_jacobian).
template <class M, class S>
__device__ void refined(Ctx<M, S>& x, const S* rhs, S* out) {
  using W = Warp<M, S>;
  constexpr int NX = W::NX, NY = W::NY, NE = W::NE, NZ = W::NZ;
  W& w = x.w;
  const int lane = x.lane;
  solve(x, rhs, out);
  for (int p = 0; p < x.o.refine; ++p) {
    if (lane < NE) {
      S s = S(0);
#pragma unroll
      for (int m = 0; m < NE; ++m) s += w.jac[lane][m] * out[m];
      if (lane >= NX) s += out[NY + lane];   // the rows' y2 identity
      w.kd[lane] = rhs[lane] - s;
    }
    if (lane < NY)
      w.kd[NE + lane] = rhs[NE + lane] -
                        (w.y2r[lane] * out[NX + lane] + w.y1r[lane] * out[NE + lane]);
    __syncwarp();
    solve(x, w.kd, w.dd);
    for (int i = lane; i < NZ; i += 32) out[i] = out[i] + w.dd[i];
    __syncwarp();
  }
}

// Largest alpha in (0, 1] with y - alpha dy >= (1 - tau) y over the cone
// variables y1 and y2, z[NX .. NZ), a lane each.
template <int NX, int NY, class S>
__device__ __forceinline__ S cone_step(const S* z, const S* d, S tau, int lane) {
  S ratio = Lim<S>::big();
  if (lane < 2 * NY) {
    const S y = z[NX + lane], dy = d[NX + lane];
    if (dy > S(0)) ratio = tau * y / dy;
  }
  return pmin(warp_min(ratio), S(1));
}

// Mean of y1 o y2 over the cone, at z - alpha d where d is given.
template <int NX, int NY, class S>
__device__ __forceinline__ S cone_mu(const S* z, const S* d, S alpha, int lane) {
  constexpr int NE = NX + NY;
  S p = S(0);
  if (lane < NY) {
    const S a = d ? step(z[NX + lane], alpha, d[NX + lane]) : z[NX + lane];
    const S b = d ? step(z[NE + lane], alpha, d[NE + lane]) : z[NE + lane];
    p = a * b;
  }
  return warp_sum(p) / S(NY);
}

// Argmin order of torch.argmin: a NaN before any number, then the smaller,
// then the first.
template <class S>
__device__ __forceinline__ bool before(S ma, int ia, S mb, int ib) {
  const bool na = ma != ma, nb = mb != mb;
  if (na != nb) return na;
  if (!na && ma != mb) return ma < mb;
  return ia < ib;
}

// One trip's body from the state in w.z, w.r: the new iterate and its
// residual into w.zn, w.rn and their violations.
template <class M, class S>
__device__ void body(Ctx<M, S>& x, S rvio, S kvio, S& rvio_n, S& kvio_n) {
  using W = Warp<M, S>;
  constexpr int NX = W::NX, NY = W::NY, NE = W::NE, NZ = W::NZ;
  W& w = x.w;
  const int lane = x.lane;
  const Opts& o = x.o;
  factor(x, kvio);
  refined(x, w.r, w.daff);
  const S alpha_aff = cone_step<NX, NY>(w.z, w.daff, S(1), lane);
  const S mu = cone_mu<NX, NY, S>(w.z, nullptr, S(0), lane);
  const S mu_aff = cone_mu<NX, NY>(w.z, w.daff, alpha_aff, lane);
  S sigma = pmin(pmax(mu_aff / pmax(mu, Lim<S>::tiny()), S(0)), S(1));
  sigma = sigma * sigma * sigma;
  const S kappa_t = pmax(sigma * mu, S(o.kappa_floor));

  for (int i = lane; i < NZ; i += 32) {
    const S c = i < NE ? w.r[i] : w.r[i] - kappa_t;
    w.rc[i] = c;
    w.rcor[i] = i < NE ? c : c + w.daff[i - NY] * w.daff[i];
  }
  __syncwarp();
  refined(x, w.rcor, w.dcor);
  refined(x, w.rc, w.dcen);

  const S v = pmax(rvio, kvio);
  const S tau = pmin(pmax(S(1) - v * v, S(o.tau_min)), S(o.tau_max));
  S m0 = S(0);
  for (int i = lane; i < NZ; i += 32) m0 += w.rc[i] * w.rc[i];
  const S merit0 = warp_sum(m0);
  const S a0_cor = cone_step<NX, NY>(w.z, w.dcor, tau, lane);
  const S a0_cen = cone_step<NX, NY>(w.z, w.dcen, tau, lane);

  // the candidates, a lane each, in rounds of 32
  const int n_cand = o.max_ls + 1, total = 2 * n_cand;
  int first_ok = -1, best_i = -1;
  S best_m = S(0);
  for (int base = 0; base < total; base += 32) {
    const int c = base + lane;
    bool ok = false;
    if (c < total) {
      const bool cor = c < n_cand;
      const S half = pmax(S(ldexp(1.0, -(c % n_cand))), S(o.eps_min));
      const S alpha = (cor ? a0_cor : a0_cen) * half;
      const S* dir = cor ? w.dcor : w.dcen;
      auto zf = [&](int i) { return step(w.z[i], alpha, dir[i]); };
      S merit = S(0);
      S* rows = x.cand + NE * c;
      M::template equality_rows<S, S>(x.pk, w.th, w.cst, zf, [&](int row, S val) {
        rows[row] = val;
        merit += val * val;
      });
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        const S b = zf(NX + i) * zf(NE + i) - kappa_t;
        merit += b * b;
      }
      ok = merit < (S(1) - S(1.0e-3) * alpha) * merit0;
      if (best_i < 0 || before(merit, c, best_m, best_i)) best_m = merit, best_i = c;
    }
    const unsigned acc = __ballot_sync(kFull, ok);
    if (first_ok < 0 && acc) first_ok = base + __ffs(acc) - 1;
  }
  for (int off = 16; off; off >>= 1) {
    const S om = __shfl_xor_sync(kFull, best_m, off);
    const int oi = __shfl_xor_sync(kFull, best_i, off);
    if (oi >= 0 && (best_i < 0 || before(om, oi, best_m, best_i))) best_m = om, best_i = oi;
  }
  __syncwarp();
  const int pick = first_ok >= 0 ? first_ok : best_i;
  const bool cor = pick < n_cand;
  const S alpha = (cor ? a0_cor : a0_cen) *
                  pmax(S(ldexp(1.0, -(pick % n_cand))), S(o.eps_min));
  const S* dir = cor ? w.dcor : w.dcen;
  for (int i = lane; i < NZ; i += 32) w.zn[i] = step(w.z[i], alpha, dir[i]);
  if (lane < NE) w.rn[lane] = x.cand[NE * pick + lane];
  __syncwarp();
  if (lane < NY) w.rn[NE + lane] = w.zn[NX + lane] * w.zn[NE + lane] - S(0);
  __syncwarp();
  rvio_n = warp_max(lane < NE ? absval(w.rn[lane]) : S(0));
  kvio_n = warp_max(lane < NY ? absval(w.rn[NE + lane]) : S(0));
}

// The solve of n problems of model M: IO is the tensors' type, S the one the
// solve computes in; the packed table arrives in float64.
template <class M, class S, class IO>
__global__ void __launch_bounds__(kMaxWarps * 32)
    sim_ip_kernel(const double* __restrict__ pack, const IO* __restrict__ z0,
                  const IO* __restrict__ theta, IO* __restrict__ z_out,
                  bool* __restrict__ conv_out, int* __restrict__ iters_out,
                  IO* __restrict__ rvio_out, IO* __restrict__ kvio_out, int n,
                  Opts o, int warp_bytes, int pack_bytes) {
  using W = Warp<M, S>;
  constexpr int NQ = M::NQ, NT = M::NT, NCST = M::NCST, NZ = W::NZ;
  static_assert(W::NE <= 32 && 2 * W::NY <= 32,
                "a direction a lane and the cone's variables a lane");
  extern __shared__ __align__(16) unsigned char smem[];
  S* pk = reinterpret_cast<S*>(smem);
  for (int i = threadIdx.x; i < M::kPackSize; i += blockDim.x) pk[i] = S(pack[i]);
  __syncthreads();
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + wi;
  if (p >= n) return;
  W& w = *reinterpret_cast<W*>(smem + pack_bytes + wi * warp_bytes);
  Ctx<M, S> x{w, reinterpret_cast<S*>(smem + pack_bytes + wi * warp_bytes + sizeof(W)),
              pk, lane, o};

  for (int i = lane; i < NT; i += 32) w.th[i] = S(theta[(size_t)p * NT + i]);
  for (int i = lane; i < NZ; i += 32) w.z0[i] = w.z[i] = S(z0[(size_t)p * NZ + i]);
  __syncwarp();
  {
    S acc[NCST];
    M::template theta_terms<S>(pk, w.th, acc);
    if (lane < NCST) {
#pragma unroll
      for (int k = 0; k < NCST; ++k)
        if (k == lane) w.cst[k] = acc[k];
    }
  }
  __syncwarp();

  const S r_tol = S(o.r_tol), kappa_tol = S(o.kappa_tol);
  S rvio, kvio;
  start(x, rvio, kvio);
  bool done = rvio <= r_tol && kvio <= kappa_tol;
  int it = 0;
  for (int attempt = 0; attempt <= o.retries; ++attempt) {
    if (attempt) {
      // cold restart of a failed solve from z_initialize (q2 from z0, ones);
      // a converged one starts again where it is
      if (!done) {
        for (int i = lane; i < NZ; i += 32) w.z[i] = i < NQ ? w.z0[i] : S(1);
        __syncwarp();
      }
      start(x, rvio, kvio);
      done = rvio <= r_tol && kvio <= kappa_tol;
      it = 0;
    }
    const bool fixed = o.fixed_iters > 0;
    for (int t = 0; fixed ? t < o.fixed_iters : it < o.max_iter; ++t) {
      if (done) break;
      S rvio_n, kvio_n;
      body(x, rvio, kvio, rvio_n, kvio_n);
      if (fixed) {
        bool fin = true;
        for (int i = lane; i < NZ; i += 32) fin = fin && finite(IO(w.zn[i]));
        if (!__all_sync(kFull, fin)) break;
      }
      for (int i = lane; i < NZ; i += 32) w.z[i] = w.zn[i], w.r[i] = w.rn[i];
      __syncwarp();
      rvio = rvio_n, kvio = kvio_n;
      ++it;
      done = rvio <= r_tol && kvio <= kappa_tol;
    }
  }
  // divergence guard: a non-finite solve (in the tensors' type) returns z0,
  // not converged
  bool fin = true;
  for (int i = lane; i < NZ; i += 32) fin = fin && finite(IO(w.z[i]));
  const bool bad = !__all_sync(kFull, fin);
  for (int i = lane; i < NZ; i += 32)
    z_out[(size_t)p * NZ + i] = bad ? z0[(size_t)p * NZ + i] : IO(w.z[i]);
  if (lane == 0) {
    conv_out[p] = done && !bad;
    iters_out[p] = it;
    rvio_out[p] = IO(rvio);
    kvio_out[p] = IO(kvio);
  }
}

// ---- host side ---------------------------------------------------------------

constexpr int align16(int n) { return (n + 15) & ~15; }

template <class M, class S, class IO>
int launch(const void* pack, const void* z0, const void* theta, void* z,
           void* conv, void* iters, void* rvio, void* kvio, int n, Opts o,
           cudaStream_t stream) {
  using W = Warp<M, S>;
  const int warps = n >= 512 ? kMaxWarps : 1;
  const int warp_bytes = align16(int(sizeof(W)) + W::NE * 2 * (o.max_ls + 1) * int(sizeof(S)));
  const int pack_bytes = align16(M::kPackSize * int(sizeof(S)));
  const int bytes = pack_bytes + warps * warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      sim_ip_kernel<M, S, IO>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  sim_ip_kernel<M, S, IO><<<(n + warps - 1) / warps, warps * 32, bytes, stream>>>(
      static_cast<const double*>(pack), static_cast<const IO*>(z0),
      static_cast<const IO*>(theta), static_cast<IO*>(z), static_cast<bool*>(conv),
      static_cast<int*>(iters), static_cast<IO*>(rvio), static_cast<IO*>(kvio), n, o,
      warp_bytes, pack_bytes);
  return int(cudaGetLastError());
}

// A model's entry point: checks the arguments and launches the solve of n
// problems in the tensors' type, float32 (elem_bytes 4, computed in F32) or
// float64 (8). 0 on success, a CUDA error code, or -2 for arguments the
// kernel does not take.
template <class M, class F32>
int dispatch(int elem_bytes, const void* pack, const void* z0, const void* theta,
             void* z, void* conv, void* iters, void* rvio, void* kvio, int n,
             int fixed_iters, int max_iter, int retries, int refine, int max_ls,
             double r_tol, double kappa_tol, double kappa_floor, double gamma_reg,
             double tau_min, double tau_max, double eps_min, void* stream) {
  if (n < 0 || fixed_iters < 0 || max_iter < 0 || retries < 0 || refine < 0 ||
      max_ls < 0 || max_ls > kMaxLs)
    return -2;
  if (n == 0) return 0;
  const Opts o{fixed_iters, max_iter, retries, refine, max_ls, r_tol, kappa_tol,
               kappa_floor, gamma_reg, tau_min, tau_max, eps_min};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<M, F32, float>(pack, z0, theta, z, conv, iters, rvio, kvio, n, o, s);
  if (elem_bytes == 8)
    return launch<M, double, double>(pack, z0, theta, z, conv, iters, rvio, kvio, n, o, s);
  return -2;
}

}  // namespace sim_ip
