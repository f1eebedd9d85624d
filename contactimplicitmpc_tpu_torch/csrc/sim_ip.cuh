// The sim step's contact-NCP interior-point solve on NVIDIA Hopper (sm_90a),
// one block of eight warps a problem, in one launch a sim step: the
// model-independent part.
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
//     static constexpr int kJacScratch;      // values the Jacobian keeps between stages
//     static constexpr int kEvalScratch;     // values a residual keeps between stages
//     template <class S> static void theta_terms(pk, th, cst, scr, t);
//     template <class S> static void jacobian(pk, th, cst, z, ev, scr, jac, ldj, t);
//     template <class S, class Z> static S rows(pk, th, cst, zf, scr, out, g, G);
//   };
//
// with z = [x; y1; y2] (y1 = (gamma, b, psi), y2 their slacks), the NX + NY
// equality rows a function of z's first NX + NY entries plus, in rows NX..,
// the matching y2 entry with coefficient one, and the NY complementarity
// rows y1 o y2 - kappa. pk is the packed table and th the problem's theta,
// in shared memory. The three functions are called by every thread of the
// block alike (t = threadIdx.x) and hold __syncthreads() between their
// stages: theta_terms writes the NCST terms into cst; rows writes the
// NX + NY equality rows at the point zf(i) into out, the work shared by the
// G threads of a group (g = 0 .. G - 1 this thread's place in it; g >= G a
// thread of no group, which writes nothing, not even scr or out, and only
// takes part in the barriers), with scr kEvalScratch values of the group's
// own, and returns the
// sum of the squares of the rows this thread wrote; jacobian writes the
// Jacobian of the equality rows in (x, y1) at z into jac (row stride ldj),
// ev the scratch rows left at z (so a point's trigonometry is taken once),
// scr kJacScratch values of its own.
//
// What it computes, per problem (one lane's sim step):
// - the Jacobian of the equality rows in (x, y1), the jacfwd of
//   interior_point.py, entry by entry from the model's closed form;
// - the Schur backend: Dx^-1 (NX x NX) and the inverse of
//   S = Ry1 - diag(y2r / y1r) - Rx Dx^-1 Dy1 (NY x NY) by unpivoted
//   Gauss-Jordan with the type's `tiny` pivot floor (ops/linsolve.py::
//   gj_inverse), y1r and y2r the gamma_reg-clamped cone variables, and the
//   back-substitution of make_ncp_schur_solver's `solve`;
// - one trip of `body`: the affine direction, sigma = (mu_aff / mu)^3 and the
//   kappa floor, the corrector and centering directions with `refine`
//   passes against the regularized operator (apply_reg_jacobian), tau, the
//   2 (max_ls + 1) line-search candidates in one round (candidate c's
//   equality rows kept in shared memory, so the accepted one is the next
//   residual), the pick (the first accepted, else the argmin of the merit, a
//   NaN first as torch.argmin takes it) and the violations;
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
// dependent steps. A few problems fill a few of the 132 SMs, so the card's
// rates are far away and the time is one problem's latency, trip after
// trip. A trip is ~50 dependent stages between barriers (the Jacobian's
// two, NX + NY pivot steps, four a structured solve, the candidates'
// three), each a few dependent float64 operations on shared memory.
//
// Design (the earlier kernel had a warp a problem: every lane evaluated the
// whole residual in dual numbers for its Jacobian column, Gauss-Jordan and
// the solves were chains of shuffles, the candidates a lane each in rounds
// of 32; 255 registers and spills; tools/sim_ip_phases.py clocks both):
// - A block of kThreads = 256 threads (eight warps) owns one problem at
//   every n, so that the independent work of a stage runs side by side, and
//   keeps it in shared memory (struct Prob: the packed model, theta, the
//   iterate and its residual double-buffered, the Jacobian, Dx^-1,
//   Rx Dx^-1, S^-1, the directions) plus, a candidate, its equality rows
//   and scratch. Nothing intermediate goes to device memory.
//   __launch_bounds__(256, 2) holds a thread to 128 registers, with no
//   spills; two blocks an SM, so past 264 problems the blocks run in
//   waves (128 threads, four blocks an SM, took 17% longer a trip on the
//   card).
// - The model takes each sine and cosine once a point, a thread an angle,
//   into shared memory; a point's residual is split over a group of
//   threads, and the Jacobian, formed entry by entry from closed forms
//   across the block, reuses the trigonometry and forces its iterate's
//   residual left (ev).
// - Gauss-Jordan in place (the identity half of [A | I] folded into the
//   columns as they are eliminated), an entry (or a few) a thread in
//   registers; the pivot row and column go through shared memory, double-
//   buffered, so a pivot step is one barrier.
// - A structured solve is four stages of products, a row and right-hand
//   side a thread; the corrector and centering solves run as one. Divisions
//   (a float64 division is a long software sequence on the card) leave the
//   chains: a reciprocal of each pivot and of y1r, and of h in the model; a
//   division an entry had made the eliminations twice as slow.
// - All 2 (max_ls + 1) candidates in one round, G threads each (the largest
//   power of two up to 32 with G (candidates) <= kThreads), their merits
//   summed by shuffles within the group. The merit at the iterate is summed
//   in the same order (sq_add, bilinear), so a candidate that does not move
//   has it bit for bit and is not accepted. The reductions every thread
//   needs (step lengths, mu, the pick, the violations) each warp does alike
//   from shared memory: the same values in the same order, so no barrier
//   broadcasts them.
// - The step z - alpha d is formed with rounded product and difference
//   (__dmul_rn/__dsub_rn, __fmul_rn/__fsub_rn), never a fused multiply-add,
//   wherever it appears, so that a candidate's residual is bit for bit the
//   residual of the iterate it becomes.
// - S is the type the solve computes in, IO the tensors' type; the entry
//   point of a model (`dispatch`) picks S for float32 tensors.
// - The widths are template constants with no bound of their own: the
//   centroidal family's (18, 24) take 3 entries a thread in the 24 x 24
//   elimination and about 200 KB of shared memory at max_ls = 63
//   (tests/test_torch_sim_ip.py's geometry test).

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace sim_ip {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                // a block a problem
constexpr int kMaxLs = 63;
constexpr int kMaxCand = 2 * (kMaxLs + 1);   // a trip's candidates, one round
static_assert(kMaxCand <= kThreads, "a candidate a thread at the least");

// ---- phase clocks (-DSIM_IP_PHASE_CLOCKS) ------------------------------------
// Thread 0 of problem 0 adds clock64() deltas a phase into g_clocks, read
// after the block's barriers: the phases, then the whole solve and its trips.
enum Phase { kTrigJacobian, kSchur, kSolves, kCandidates, kBookkeeping, kStartFinish,
             kPhases };
constexpr int kClockSlots = kPhases + 2;
#ifdef SIM_IP_PHASE_CLOCKS
__device__ long long g_clocks[kClockSlots];
__device__ __forceinline__ long long cycles() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}
struct Clock {
  bool on;
  long long t0, t;
  __device__ explicit Clock(bool on_) : on(on_), t0(0), t(0) {
    if (on) t0 = t = cycles();
  }
  __device__ void mark(int phase) {
    if (on) {
      const long long now = cycles();
      g_clocks[phase] += now - t;
      t = now;
    }
  }
  __device__ void trip() {
    if (on) g_clocks[kPhases + 1] += 1;
  }
  __device__ void total() {
    if (on) g_clocks[kPhases] += cycles() - t0;
  }
};
#else
struct Clock {
  __device__ explicit Clock(bool) {}
  __device__ void mark(int) {}
  __device__ void trip() {}
  __device__ void total() {}
};
#endif

struct Opts {
  int fixed_iters, max_iter, retries, refine, max_ls;
  double r_tol, kappa_tol, kappa_floor, gamma_reg, tau_min, tau_max, eps_min;
};

// ---- scalars -------------------------------------------------------------------

__device__ __forceinline__ void sin_cos(double x, double& s, double& c) { sincos(x, &s, &c); }
__device__ __forceinline__ void sin_cos(float x, float& s, float& c) { sincosf(x, &s, &c); }

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

// acc + x x with one rounding, and a o b - kappa with each rounded: the
// merits of the line search are summed with these alone, in one order, so
// that a candidate at the iterate itself has the iterate's merit bit for
// bit (and is not accepted)
__device__ __forceinline__ double sq_add(double acc, double x) { return __fma_rn(x, x, acc); }
__device__ __forceinline__ float sq_add(float acc, float x) { return __fmaf_rn(x, x, acc); }
__device__ __forceinline__ double bilinear(double a, double b, double kappa) {
  return __dsub_rn(__dmul_rn(a, b), kappa);
}
__device__ __forceinline__ float bilinear(float a, float b, float kappa) {
  return __fsub_rn(__fmul_rn(a, b), kappa);
}

__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ float absval(float x) { return fabsf(x); }

template <class S>
__device__ __forceinline__ S pmax(S a, S b) { return (a != a || a > b) ? a : b; }
template <class S>
__device__ __forceinline__ S pmin(S a, S b) { return (a != a || a < b) ? a : b; }
template <class X>
__device__ __forceinline__ bool finite(X x) { return isfinite(x); }

// Argmin order of torch.argmin: a NaN before any number, then the smaller,
// then the first.
template <class S>
__device__ __forceinline__ bool before(S ma, int ia, S mb, int ib) {
  const bool na = ma != ma, nb = mb != mb;
  if (na != nb) return na;
  if (!na && ma != mb) return ma < mb;
  return ia < ib;
}

// Reductions of f(0 .. n - 1) that every thread needs: each warp reduces
// alike (the same values in the same order), so every thread holds the same
// result and no barrier broadcasts it.
template <class S, class F>
__device__ __forceinline__ S all_sum(int n, F f) {
  const int lane = threadIdx.x & 31;
  S v = S(0);
  for (int i = lane; i < n; i += 32) v += f(i);
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
template <class S, class F>
__device__ __forceinline__ S all_max(int n, S init, F f) {
  const int lane = threadIdx.x & 31;
  S v = init;
  for (int i = lane; i < n; i += 32) v = pmax(v, f(i));
  for (int o = 16; o; o >>= 1) v = pmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
template <class S, class F>
__device__ __forceinline__ S all_min(int n, S init, F f) {
  const int lane = threadIdx.x & 31;
  S v = init;
  for (int i = lane; i < n; i += 32) v = pmin(v, f(i));
  for (int o = 16; o; o >>= 1) v = pmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ---- one block's problem in shared memory --------------------------------------

template <class M, class S>
struct Prob {
  static constexpr int NX = M::NX, NY = M::NY, NE = NX + NY, NZ = NX + 2 * NY;
  static constexpr int NM = NX > NY ? NX : NY;
  S pk[M::kPackSize];
  S th[M::NT], cst[M::NCST];
  S z0[NZ], z[2][NZ], r[2][NZ];   // the iterate and its residual, and the next
  S jac[NE][NE + 1];              // jac[row][direction]: Dx, Dy1 over Rx, Ry1
  S dxi[NX][NX + 1];              // Dx^-1
  S cai[NY][NX + 1];              // Rx Dx^-1
  S si[NY][NY + 1];               // the Schur complement's inverse
  S y1r[NY], y2r[NY], y1i[NY];   // y1i = 1 / y1r
  S daff[NZ], rhs[2][NZ], dir[2][NZ];   // [0] corrector, [1] centering
  S u[2][NY], dy1[2][NY], wk[2][NX];    // a solve's stages
  S kd[2][NZ];                          // refinement's right-hand sides
  S piv_row[2][NM], piv_col[2][NM];     // Gauss-Jordan's pivot row and column
  S jscr[M::kJacScratch];
  S merit[kMaxCand], ok[kMaxCand];
  // how many S values the members are
  static constexpr int kValues =
      M::kPackSize + M::NT + M::NCST + 5 * NZ + NE * (NE + 1) + NX * (NX + 1) +
      NY * (NX + 1) + NY * (NY + 1) + 3 * NY + 5 * NZ + 4 * NY + 2 * NX + 2 * NZ +
      4 * NM + M::kJacScratch + 2 * kMaxCand;
};

// Shared bytes of a block: the problem, then for each of the 2 (max_ls + 1)
// candidates its equality rows and scratch. The launch sets them itself, and
// each instantiation asserts that its largest fits an H100 block.
template <class M, class S>
constexpr int shared_bytes(int max_ls) {
  return int(sizeof(S)) * (Prob<M, S>::kValues +
                           2 * (max_ls + 1) * (M::NX + M::NY + M::kEvalScratch));
}

// Threads a candidate: the largest power of two up to 32 with
// G (candidates) <= kThreads.
__device__ __forceinline__ int group_size(int candidates) {
  int g = 32;
  while (g > 1 && g * candidates > kThreads) g >>= 1;
  return g;
}

template <class M, class S>
struct Ctx {
  Prob<M, S>& w;
  S* cand;      // a candidate's equality rows, then its scratch
  const S* ev;  // the scratch of the iterate's residual (rows' trigonometry, forces)
  int t;        // threadIdx.x
  int cur;      // which of z[2], r[2] holds the iterate
  Opts o;
  Clock& clk;
};

// In-place inverse of an N x N matrix by unpivoted Gauss-Jordan with the
// `tiny` pivot floor: gj_inverse on [A | I], the identity half's column k
// taking the place of A's column k as it is eliminated, and row k scaled by
// the pivot's reciprocal (one division a step, not one an entry). Thread t
// holds the entries t, t + kThreads, ... (row-major) in registers, entered
// as init(i, j); the inverse leaves through put(i, j, value). Each pivot
// step sends row k and column k through shared memory, double-buffered, so
// a step is one barrier. (Forming the next pivot's reciprocal beside the
// update, to take the division off the step's chain, made the steps slower
// on the card: a warp issues in order, so the division still stood in the
// way of the update.)
template <int N, int NM, class S, class Init, class Put>
__device__ __forceinline__ void gj_inplace(S (&prow)[2][NM], S (&pcol)[2][NM], int t,
                                           Init init, Put put) {
  static_assert(N <= NM, "the pivot buffers hold a row");
  constexpr int E = (N * N + kThreads - 1) / kThreads;
  const S tiny = Lim<S>::tiny();
  S v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = t + e * kThreads;
    v[e] = idx < N * N ? init(idx / N, idx % N) : S(0);
  }
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    S* row = prow[k & 1];
    S* col = pcol[k & 1];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = t + e * kThreads, i = idx / N, j = idx % N;
      if (idx < N * N) {
        if (i == k) row[j] = v[e];
        if (j == k) col[i] = v[e];
      }
    }
    __syncthreads();
    S piv = row[k];
    if (absval(piv) < tiny) piv = piv >= S(0) ? tiny : -tiny;
    const S inv = S(1) / piv;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = t + e * kThreads, i = idx / N, j = idx % N;
      if (idx < N * N) {
        const S rk = j == k ? inv : row[j] * inv;   // row k of [A | I] over the pivot
        v[e] = i == k ? rk : (j == k ? S(0) : v[e]) - col[i] * rk;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = t + e * kThreads;
    if (idx < N * N) put(idx / N, idx % N, v[e]);
  }
  __syncthreads();
}

// r(z, theta, 0) at the iterate into w.r[cur] (the block as one group), and
// its violations.
template <class M, class S>
__device__ void start(Ctx<M, S>& x, S& rvio, S& kvio) {
  using P = Prob<M, S>;
  constexpr int NX = P::NX, NY = P::NY, NE = P::NE;
  P& w = x.w;
  const S* z = w.z[x.cur];
  S* r = w.r[x.cur];
  auto zf = [&](int i) { return z[i]; };
  x.ev = x.cand + NE;
  M::template rows<S>(w.pk, w.th, w.cst, zf, x.cand + NE, r, x.t, kThreads);
  for (int i = x.t; i < NY; i += kThreads) r[NE + i] = bilinear(z[NX + i], z[NE + i], S(0));
  __syncthreads();
  rvio = all_max<S>(NE, S(0), [&](int i) { return absval(r[i]); });
  kvio = all_max<S>(NY, S(0), [&](int i) { return absval(r[NE + i]); });
}

// The Jacobian and the Schur factors at the iterate with the clamp
// gamma_reg kvio.
template <class M, class S>
__device__ void factor(Ctx<M, S>& x, S kvio) {
  using P = Prob<M, S>;
  constexpr int NX = P::NX, NY = P::NY, NE = P::NE;
  P& w = x.w;
  const int t = x.t;
  const S* z = w.z[x.cur];
  M::template jacobian<S>(w.pk, w.th, w.cst, z, x.ev, w.jscr, &w.jac[0][0], NE + 1, t);
  for (int i = t; i < NY; i += kThreads) {
    const S reg = S(x.o.gamma_reg) * kvio;
    w.y1r[i] = pmax(z[NX + i], reg);
    w.y2r[i] = pmax(z[NE + i], reg);
    w.y1i[i] = S(1) / w.y1r[i];
  }
  __syncthreads();
  x.clk.mark(kTrigJacobian);
  gj_inplace<NX>(w.piv_row, w.piv_col, t,
                 [&](int i, int j) { return w.jac[i][j]; },
                 [&](int i, int j, S v) { w.dxi[i][j] = v; });
  for (int e = t; e < NY * NX; e += kThreads) {
    const int i = e / NX, k = e % NX;
    S s = S(0);
#pragma unroll
    for (int m = 0; m < NX; ++m) s += w.jac[NX + i][m] * w.dxi[m][k];
    w.cai[i][k] = s;
  }
  __syncthreads();
  gj_inplace<NY>(
      w.piv_row, w.piv_col, t,
      [&](int i, int j) {
        S caib = S(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) caib += w.cai[i][k] * w.jac[k][NX + j];
        const S dg = i == j ? w.y2r[j] * w.y1i[j] : S(0);
        return (w.jac[NX + i][NX + j] - dg) - caib;
      },
      [&](int i, int j, S v) { w.si[i][j] = v; });
  x.clk.mark(kSchur);
}

// out_q = K^-1 rhs_q through the Schur factors for nr (1 or 2) right-hand
// sides rhs0, rhs1 (in shared memory, distinct from out0, out1); with `add`,
// out_q += K^-1 rhs_q.
template <class M, class S>
__device__ void solve(Ctx<M, S>& x, int nr, const S* rhs0, const S* rhs1, S* out0, S* out1,
                      bool add) {
  using P = Prob<M, S>;
  constexpr int NX = P::NX, NY = P::NY, NE = P::NE, NZ = P::NZ;
  P& w = x.w;
  const int t = x.t;
  for (int e = t; e < nr * NY; e += kThreads) {
    const int q = e / NY, i = e % NY;
    const S* b = q ? rhs1 : rhs0;
    S cr = S(0);
#pragma unroll
    for (int k = 0; k < NX; ++k) cr += w.cai[i][k] * b[k];
    w.u[q][i] = (b[NX + i] - b[NE + i] * w.y1i[i]) - cr;
  }
  __syncthreads();
  for (int e = t; e < nr * NY; e += kThreads) {
    const int q = e / NY, i = e % NY;
    S s = S(0);
#pragma unroll
    for (int k = 0; k < NY; ++k) s += w.si[i][k] * w.u[q][k];
    w.dy1[q][i] = s;
  }
  __syncthreads();
  for (int e = t; e < nr * NX; e += kThreads) {
    const int q = e / NX, l = e % NX;
    S s = S(0);
#pragma unroll
    for (int m = 0; m < NY; ++m) s += w.jac[l][NX + m] * w.dy1[q][m];
    w.wk[q][l] = (q ? rhs1 : rhs0)[l] - s;
  }
  __syncthreads();
  for (int e = t; e < nr * NZ; e += kThreads) {
    const int q = e / NZ, i = e % NZ;
    S v;
    if (i < NX) {
      v = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) v += w.dxi[i][k] * w.wk[q][k];
    } else if (i < NE) {
      v = w.dy1[q][i - NX];
    } else {
      const int j = i - NE;
      v = ((q ? rhs1 : rhs0)[i] - w.y2r[j] * w.dy1[q][j]) * w.y1i[j];
    }
    S* o = q ? out1 : out0;
    o[i] = add ? o[i] + v : v;
  }
  __syncthreads();
}

// A structured solve and `refine` passes of iterative refinement against the
// regularized operator (apply_reg_jacobian), for nr (1 or 2) right-hand
// sides.
template <class M, class S>
__device__ void refined(Ctx<M, S>& x, int nr, const S* rhs0, const S* rhs1, S* out0, S* out1) {
  using P = Prob<M, S>;
  constexpr int NX = P::NX, NY = P::NY, NE = P::NE, NZ = P::NZ;
  P& w = x.w;
  const int t = x.t;
  solve(x, nr, rhs0, rhs1, out0, out1, false);
  for (int p = 0; p < x.o.refine; ++p) {
    for (int e = t; e < nr * NZ; e += kThreads) {
      const int q = e / NZ, i = e % NZ;
      const S* o = q ? out1 : out0;
      S s;
      if (i < NE) {
        s = S(0);
#pragma unroll
        for (int m = 0; m < NE; ++m) s += w.jac[i][m] * o[m];
        if (i >= NX) s += o[NY + i];   // the rows' y2 identity
      } else {
        const int j = i - NE;
        s = w.y2r[j] * o[NX + j] + w.y1r[j] * o[NE + j];
      }
      w.kd[q][i] = (q ? rhs1 : rhs0)[i] - s;
    }
    __syncthreads();
    solve(x, nr, w.kd[0], w.kd[1], out0, out1, true);
  }
}

// Largest alpha in (0, 1] with y - alpha dy >= (1 - tau) y over the cone
// variables y1 and y2, z[NX .. NZ).
template <int NX, int NY, class S>
__device__ __forceinline__ S cone_step(const S* z, const S* d, S tau) {
  return pmin(all_min<S>(2 * NY, Lim<S>::big(), [&](int i) {
                const S y = z[NX + i], dy = d[NX + i];
                return dy > S(0) ? tau * y / dy : Lim<S>::big();
              }),
              S(1));
}

// cone_step along two directions at once, their reductions interleaved.
template <int NX, int NY, class S>
__device__ __forceinline__ void cone_steps(const S* z, const S* d0, const S* d1, S tau, S& a0,
                                           S& a1) {
  const int lane = threadIdx.x & 31;
  const S big = Lim<S>::big();
  S m0 = big, m1 = big;
  for (int i = lane; i < 2 * NY; i += 32) {
    const S y = z[NX + i], e0 = d0[NX + i], e1 = d1[NX + i];
    m0 = pmin(m0, e0 > S(0) ? tau * y / e0 : big);
    m1 = pmin(m1, e1 > S(0) ? tau * y / e1 : big);
  }
  for (int o = 16; o; o >>= 1) {
    m0 = pmin(m0, __shfl_xor_sync(kFull, m0, o));
    m1 = pmin(m1, __shfl_xor_sync(kFull, m1, o));
  }
  a0 = pmin(m0, S(1));
  a1 = pmin(m1, S(1));
}

// Mean of y1 o y2 over the cone, at z - alpha d (d given) or at z.
template <int NX, int NY, class S>
__device__ __forceinline__ S cone_mu(const S* z, const S* d, S alpha) {
  constexpr int NE = NX + NY;
  return all_sum<S>(NY, [&](int i) {
           const S a = d ? step(z[NX + i], alpha, d[NX + i]) : z[NX + i];
           const S b = d ? step(z[NE + i], alpha, d[NE + i]) : z[NE + i];
           return a * b;
         }) /
         S(NY);
}

// One trip's body from the iterate w.z[cur], w.r[cur]: the new iterate and
// its residual into w.z[cur ^ 1], w.r[cur ^ 1] and their violations.
template <class M, class S>
__device__ void body(Ctx<M, S>& x, S rvio, S kvio, S& rvio_n, S& kvio_n) {
  using P = Prob<M, S>;
  constexpr int NX = P::NX, NY = P::NY, NE = P::NE, NZ = P::NZ;
  constexpr int kCand = NE + M::kEvalScratch;   // a candidate's values
  P& w = x.w;
  const int t = x.t;
  const Opts& o = x.o;
  const S* z = w.z[x.cur];
  const S* r = w.r[x.cur];
  factor(x, kvio);
  refined(x, 1, r, r, w.daff, w.daff);
  x.clk.mark(kSolves);
  const S alpha_aff = cone_step<NX, NY>(z, w.daff, S(1));
  const S mu = cone_mu<NX, NY, S>(z, nullptr, S(0));
  const S mu_aff = cone_mu<NX, NY>(z, w.daff, alpha_aff);
  S sigma = pmin(pmax(mu_aff / pmax(mu, Lim<S>::tiny()), S(0)), S(1));
  sigma = sigma * sigma * sigma;
  const S kappa_t = pmax(sigma * mu, S(o.kappa_floor));
  for (int i = t; i < NZ; i += kThreads) {
    const S c = i < NE ? r[i] : r[i] - kappa_t;
    w.rhs[1][i] = c;
    w.rhs[0][i] = i < NE ? c : c + w.daff[i - NY] * w.daff[i];
  }
  __syncthreads();
  x.clk.mark(kBookkeeping);
  refined(x, 2, w.rhs[0], w.rhs[1], w.dir[0], w.dir[1]);
  x.clk.mark(kSolves);

  const S v = pmax(rvio, kvio);
  const S tau = pmin(pmax(S(1) - v * v, S(o.tau_min)), S(o.tau_max));
  // G threads a candidate; the merit at the iterate summed as a group sums
  // a candidate's (rows g, g + G, ..., then the bilinear rows, then the
  // group's shuffles), so that every group holds it bit for bit
  const int n_cand = o.max_ls + 1, total = 2 * n_cand;
  const int G = group_size(total);
  const int c = t / G, g = t % G;
  S merit0 = S(0);
  for (int i = g; i < NE; i += G) merit0 = sq_add(merit0, w.rhs[1][i]);
  for (int i = g; i < NY; i += G) merit0 = sq_add(merit0, w.rhs[1][NE + i]);
  for (int off = G >> 1; off; off >>= 1) merit0 += __shfl_xor_sync(kFull, merit0, off);
  S a0c, a0n;   // the corrector's and the centering direction's cone steps
  cone_steps<NX, NY>(z, w.dir[0], w.dir[1], tau, a0c, a0n);
  x.clk.mark(kBookkeeping);

  // the candidates, G threads each, in one round: c < n_cand along the
  // corrector, the rest along the centering direction
  const bool live = c < total;
  const int cc = live ? c : 0;
  const bool cor = cc < n_cand;
  const S alpha = (cor ? a0c : a0n) * pmax(S(ldexp(1.0, -(cc % n_cand))), S(o.eps_min));
  const S* dir = cor ? w.dir[0] : w.dir[1];
  auto zf = [&](int i) { return step(z[i], alpha, dir[i]); };
  S* rows = x.cand + kCand * cc;
  // the merit: the group's rows' squares (each thread its own rows'), then
  // the bilinear rows at kappa_t; a thread past the candidates passes g = G
  // and writes nothing
  S m = M::template rows<S>(w.pk, w.th, w.cst, zf, rows + NE, rows, live ? g : G, G);
  if (live) {
    for (int i = g; i < NY; i += G) m = sq_add(m, bilinear(zf(NX + i), zf(NE + i), kappa_t));
  }
  for (int off = G >> 1; off; off >>= 1) m += __shfl_xor_sync(kFull, m, off);
  if (live && g == 0) {
    w.merit[c] = m;
    w.ok[c] = m < (S(1) - S(1.0e-3) * alpha) * merit0 ? S(1) : S(0);
  }
  __syncthreads();
  x.clk.mark(kCandidates);

  // the pick, each warp alike: the first accepted, else the argmin
  int pick;
  {
    const int lane = t & 31;
    int first = kMaxCand;
    S best_m = S(0);
    int best_i = -1;
    for (int i = lane; i < total; i += 32) {
      if (first == kMaxCand && w.ok[i] != S(0)) first = i;
      if (best_i < 0 || before(w.merit[i], i, best_m, best_i)) best_m = w.merit[i], best_i = i;
    }
    for (int off = 16; off; off >>= 1) {
      const int of = __shfl_xor_sync(kFull, first, off);
      first = of < first ? of : first;
      const S om = __shfl_xor_sync(kFull, best_m, off);
      const int oi = __shfl_xor_sync(kFull, best_i, off);
      if (oi >= 0 && (best_i < 0 || before(om, oi, best_m, best_i))) best_m = om, best_i = oi;
    }
    pick = first < kMaxCand ? first : best_i;
  }
  const bool pcor = pick < n_cand;
  const S pa = (pcor ? a0c : a0n) * pmax(S(ldexp(1.0, -(pick % n_cand))), S(o.eps_min));
  const S* pd = pcor ? w.dir[0] : w.dir[1];
  const S* prow = x.cand + kCand * pick;
  x.ev = prow + NE;   // the new iterate's trigonometry and forces, for its Jacobian
  S* zn = w.z[x.cur ^ 1];
  S* rn = w.r[x.cur ^ 1];
  for (int i = t; i < NZ; i += kThreads) {
    zn[i] = step(z[i], pa, pd[i]);
    if (i < NE) rn[i] = prow[i];
  }
  for (int i = t; i < NY; i += kThreads)
    rn[NE + i] = bilinear(step(z[NX + i], pa, pd[NX + i]), step(z[NE + i], pa, pd[NE + i]), S(0));
  __syncthreads();
  rvio_n = all_max<S>(NE, S(0), [&](int i) { return absval(rn[i]); });
  kvio_n = all_max<S>(NY, S(0), [&](int i) { return absval(rn[NE + i]); });
}

// The solve of n problems of model M, a block a problem: IO is the tensors'
// type, S the one the solve computes in; the packed table arrives in
// float64.
template <class M, class S, class IO>
__global__ void __launch_bounds__(kThreads, 2)
    sim_ip_kernel(const double* __restrict__ pack, const IO* __restrict__ z0,
                  const IO* __restrict__ theta, IO* __restrict__ z_out,
                  bool* __restrict__ conv_out, int* __restrict__ iters_out,
                  IO* __restrict__ rvio_out, IO* __restrict__ kvio_out, int n,
                  Opts o) {
  using P = Prob<M, S>;
  constexpr int NQ = M::NQ, NT = M::NT, NZ = P::NZ;
  static_assert(sizeof(P) == sizeof(S) * P::kValues, "Prob is kValues values");
  extern __shared__ __align__(16) unsigned char smem[];
  P& w = *reinterpret_cast<P*>(smem);
  const int t = threadIdx.x, p = blockIdx.x;
  if (p >= n) return;
  Clock clk(p == 0 && t == 0);
  Ctx<M, S> x{w, reinterpret_cast<S*>(smem + sizeof(P)), nullptr, t, 0, o, clk};

  for (int i = t; i < M::kPackSize; i += kThreads) w.pk[i] = S(pack[i]);
  for (int i = t; i < NT; i += kThreads) w.th[i] = S(theta[(size_t)p * NT + i]);
  for (int i = t; i < NZ; i += kThreads) w.z0[i] = w.z[0][i] = S(z0[(size_t)p * NZ + i]);
  __syncthreads();
  M::template theta_terms<S>(w.pk, w.th, w.cst, x.cand, t);
  __syncthreads();

  const S r_tol = S(o.r_tol), kappa_tol = S(o.kappa_tol);
  S rvio, kvio;
  start(x, rvio, kvio);
  clk.mark(kStartFinish);
  bool done = rvio <= r_tol && kvio <= kappa_tol;
  int it = 0;
  for (int attempt = 0; attempt <= o.retries; ++attempt) {
    if (attempt) {
      // cold restart of a failed solve from z_initialize (q2 from z0, ones);
      // a converged one starts again where it is
      if (!done) {
        for (int i = t; i < NZ; i += kThreads) w.z[x.cur][i] = i < NQ ? w.z0[i] : S(1);
        __syncthreads();
      }
      start(x, rvio, kvio);
      done = rvio <= r_tol && kvio <= kappa_tol;
      it = 0;
      clk.mark(kStartFinish);
    }
    const bool fixed = o.fixed_iters > 0;
    for (int k = 0; fixed ? k < o.fixed_iters : it < o.max_iter; ++k) {
      if (done) break;
      S rvio_n, kvio_n;
      body(x, rvio, kvio, rvio_n, kvio_n);
      if (fixed) {
        bool fin = true;
        for (int i = t; i < NZ; i += kThreads) fin = fin && finite(IO(w.z[x.cur ^ 1][i]));
        if (!__syncthreads_and(fin)) break;
      }
      x.cur ^= 1;
      rvio = rvio_n, kvio = kvio_n;
      ++it;
      done = rvio <= r_tol && kvio <= kappa_tol;
      clk.trip();
      clk.mark(kBookkeeping);
    }
  }
  // divergence guard: a non-finite solve (in the tensors' type) returns z0,
  // not converged
  bool fin = true;
  for (int i = t; i < NZ; i += kThreads) fin = fin && finite(IO(w.z[x.cur][i]));
  const bool bad = !__syncthreads_and(fin);
  for (int i = t; i < NZ; i += kThreads)
    z_out[(size_t)p * NZ + i] = bad ? z0[(size_t)p * NZ + i] : IO(w.z[x.cur][i]);
  if (t == 0) {
    conv_out[p] = done && !bad;
    iters_out[p] = it;
    rvio_out[p] = IO(rvio);
    kvio_out[p] = IO(kvio);
  }
  clk.mark(kStartFinish);
  clk.total();
}

// ---- host side ---------------------------------------------------------------

template <class M, class S, class IO>
int launch(const void* pack, const void* z0, const void* theta, void* z,
           void* conv, void* iters, void* rvio, void* kvio, int n, Opts o,
           cudaStream_t stream) {
  static_assert(shared_bytes<M, S>(kMaxLs) <= 227 * 1024,
                "a block's shared memory at max_ls = kMaxLs fits an H100's 227 KB");
  const int bytes = shared_bytes<M, S>(o.max_ls);
  cudaError_t err = cudaFuncSetAttribute(
      sim_ip_kernel<M, S, IO>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  sim_ip_kernel<M, S, IO><<<n, kThreads, bytes, stream>>>(
      static_cast<const double*>(pack), static_cast<const IO*>(z0),
      static_cast<const IO*>(theta), static_cast<IO*>(z), static_cast<bool*>(conv),
      static_cast<int*>(iters), static_cast<IO*>(rvio), static_cast<IO*>(kvio), n, o);
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

#ifdef SIM_IP_PHASE_CLOCKS
// The clocked build's slots (sim_ip::Phase, then the whole solve and its
// trips): cleared, and copied to the host, on the default stream.
extern "C" int sim_ip_clock_slots() { return sim_ip::kClockSlots; }
extern "C" int sim_ip_clocks_reset() {
  const long long zero[sim_ip::kClockSlots] = {};
  return int(cudaMemcpyToSymbol(sim_ip::g_clocks, zero, sizeof(zero)));
}
extern "C" int sim_ip_clocks_read(long long* out) {
  return int(cudaMemcpyFromSymbol(out, sim_ip::g_clocks,
                                  sizeof(long long) * sim_ip::kClockSlots));
}
#endif
