// The structure-mode Newton's KKT solve on NVIDIA Hopper (sm_90a): the whole
// structured O(H) solve of control/structure_solver.py::structure_kkt_solve
// in one launch, a block of kThreads threads a problem (a lane, or a lane's
// line-search trial).
//
// Counterpart of the JAX package's structure_kkt_solve
// (contactimplicitmpc_tpu/control/structure_solver.py), which XLA compiles
// into one program of lax.scan sweeps. The plain PyTorch version runs those
// sweeps as Python loops of small batched ops (cuSOLVER's batched Cholesky,
// cuBLAS's triangular solves): hundreds of launches a solve.
//
// What it computes, for a problem with ns = H - 1 stages and blocks of
// n = 2 nq rows, from the stage Jacobians aa, ab (nq x nq), ba (nq x nu),
// the five residual stacks and the objective's stage inverses:
//   - beta, the right-hand side of Y dnu = beta (compute_beta!);
//   - Y = C S^-1 C^T stage by stage (compute_Y!): the diagonal block's lower
//     triangle, Yii = [[qat' + m qbt + b I, .], [qvt' + m W2, qbt' + ba rat
//     ba^T + m W G^T + b I]] with W = [aa ab] [[qat qvt] [qvt qbt]] (W2 its
//     right half), and the off-diagonal block Yij from stage t + 1's
//     Jacobians;
//   - the block Cholesky sweep (compute_L!): M = Yii - Lji_prev^T Lji_prev,
//     L = chol(M) a column step at a time, Lji = L^-1 Yij;
//   - the forward substitution y_t = L_t^-1 (beta_t - Lji_{t-1}^T y_{t-1}),
//     folded into the sweep, and the backward substitution
//     x_t = L_t^-T (y_t - Lji_t x_{t+1});
//   - the step's recovery (compute_dz!): du, dqa, dqb from dnu = x.
// A diagonal block that is not positive definite (a pivot that is not > 0,
// NaN included) gives a factor that is NaN in its lower triangle, as the
// plain version's cholesky_ex guard does, and a non-finite step; nothing
// is read back to the host.
//
// What bounds it: not the card's rates (a solve is ~1 MFLOP at the
// quadruped's nq 11 and H 10, and a few hundred KB) but its chain of
// dependent steps: ns stages of n Cholesky column steps and two
// triangular solves, and the latency of each stage's reads. The design
// keeps that chain inside one block: the stage's inputs, M, L, Lji and the
// previous Lji in shared memory, the next stage's inputs copied in by
// cp.async while a stage computes; one barrier a Cholesky column (each
// thread updates the entries it owns, recomputing the two column entries
// an update needs from the pivot's reciprocal square root, so a column's
// scaling and its trailing update are one phase); Lji = L^-1 Yij a column
// a thread while the last warp runs the forward substitution; the one-warp
// triangular solves hold two rows a lane, multiply by the pivots'
// reciprocals and pass each solved entry by a shuffle. The factors go to a
// scratch the wrapper allocates (L2-resident); in the backward
// substitution one warp solves a stage from shared copies of its factors
// while the other warps copy in the next stage's.
//
// Arithmetic in the tensors' type, float32 or float64; products summed in
// their own order, so results agree with the plain version to rounding.
// With -DKKT_PHASE_CLOCKS block 0 clocks the phases below (kkt_clocks.cuh).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "kkt_clocks.cuh"

namespace structure_kkt {

constexpr int kThreads = 256;          // a block a problem
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 64;              // 2 nq: two rows a lane in the one-warp solves
constexpr int kMaxNu = 64;
constexpr int kMinH = 3;               // two stages: one off-diagonal block at least
constexpr int kSharedLimit = 227 * 1024;
constexpr int kOwned = (kMaxN * (kMaxN + 1) / 2 + kThreads - 1) / kThreads;  // a thread's
                                       // entries of an n x n lower triangle

// The clocked build's phases (ops/structure_kkt.py::PHASES has their names):
// the first stage's inputs; then a stage at a time the next stage's copies
// issued, W, V, Yij, beta's products, the previous Lji written out with the
// barrier, M and beta, the Cholesky, the factor written out, Lji with the
// forward substitution; the backward substitution; the step's recovery.
enum Phase { kFirstInputs, kNextInputs, kW, kV, kYij, kBetaProducts, kLjiOut, kMAndBeta,
             kCholesky, kFactorOut, kLjiAndForward, kBackward, kRecovery, kPhases };
static_assert(kPhases <= kKktClockSlots, "a slot a phase");

// The values of the problem's type a block keeps in shared memory, for nq,
// nu and ns = H - 1 stages (ops/structure_kkt.py::shared_bytes mirrors it).
__host__ __device__ constexpr int shared_values(int nq, int nu, int ns) {
  return 38 * nq * nq + 3 * nq * nu + 2 * nu * nu + 3 * nu + 31 * nq + 6 * ns * nq + ns * nu;
}

template <class T>
struct Args {
  const T *qat, *qbt, *qvt, *rat;           // (H+1, nq, nq); rat (H+1, nu, nu)
  const T *aa, *ab, *ba;                    // (B, H, nq, nq); ba (B, H, nq, nu)
  const T *ru, *rqa, *rqb, *rd1, *rd2;      // (B, H, nu); the others (B, H, nq)
  T *du, *dqa, *dqb, *dnu1, *dnu2;          // the same shapes, row 0 zero
  T *lii, *lji;                             // (B, H-1, n, n), (B, H-2, n, n)
  int nq, nu, h;
  T beta;
};

// What a stage reads: its Jacobians and the next stage's, the objective's
// inverses at t and t + 1, its residuals and the previous stage's; laid out
// from `s` (values() of them). Built afresh where it is used, from plain
// arithmetic on one base pointer, so that it lives in registers.
template <class T>
struct StageIn {
  T *aa, *ab, *aan, *abn, *qac, *qbc, *qvc, *qan, *qbn, *qvn;  // nq x nq
  T *ba, *ra;                                                  // nq x nu, nu x nu
  T *ru, *rqa, *rqb, *rd1, *rd2, *rqap, *rqbp;

  __host__ __device__ static constexpr int values(int nq, int nu) {
    return 10 * nq * nq + nq * nu + nu * nu + nu + 6 * nq;
  }
  __device__ StageIn(T* s, int nq, int nu) {
    const int q2 = nq * nq;
    aa = s; ab = aa + q2; aan = ab + q2; abn = aan + q2; qac = abn + q2;
    qbc = qac + q2; qvc = qbc + q2; qan = qvc + q2; qbn = qan + q2; qvn = qbn + q2;
    ba = qvn + q2; ra = ba + nq * nu; ru = ra + nu * nu;
    rqa = ru + nu; rqb = rqa + nq; rd1 = rqb + nq; rd2 = rd1 + nq;
    rqap = rd2 + nq; rqbp = rqap + nq;
  }
};

// The block's shared memory, carved in shared_values' order: two stages'
// inputs (the next one's copied in while this one computes), W, V, the four
// n x n blocks, beta's products, the pivots' reciprocals (twice), beta's
// nine inner products a row, and the stages' y, x, ea, eb and du's inner
// vector.
template <class T>
struct Shared {
  T* in;                                                       // 2 StageIn
  T *w, *v;                                                    // nq x n, nq x nu
  T *m, *l, *y, *p;                                            // n x n
  T *g, *pa, *pb, *pc, *pd, *beta, *rdiag, *dots;              // beta's products, beta
  T *ys, *xs, *ea, *eb, *vu;                                   // ns x (n, n, nq, nq, nu)

  __device__ Shared(T* s, int nq, int nu, int ns) {
    const int n = 2 * nq;
    in = s;
    w = in + 2 * StageIn<T>::values(nq, nu);
    v = w + nq * n;
    m = v + nq * nu; l = m + n * n; y = l + n * n; p = y + n * n;
    g = p + n * n;
    pa = g + nu; pb = pa + nq; pc = pb + nq; pd = pc + nq;
    beta = pd + nq;
    rdiag = beta + n;
    dots = rdiag + 2 * n;
    ys = dots + 9 * nq;
    xs = ys + ns * n;
    ea = xs + ns * n;
    eb = ea + ns * nq;
    vu = eb + ns * nq;
  }
  // stage buffer b's inputs
  __device__ StageIn<T> stage(int b, int nq, int nu) const {
    return StageIn<T>(in + b * StageIn<T>::values(nq, nu), nq, nu);
  }
};

__device__ inline void set_nan(double& x) { x = __longlong_as_double(0x7ff8000000000000LL); }
__device__ inline void set_nan(float& x) { x = __int_as_float(0x7fc00000); }
__device__ inline double inv_sqrt(double x) { return rsqrt(x); }
__device__ inline float inv_sqrt(float x) { return rsqrtf(x); }

// dst[0..count) = src[0..count), global to shared without registers
// (cp.async); complete after copy_wait() and a barrier.
template <class T>
__device__ inline void copy_async(T* dst, const T* src, int count, int tid, int threads) {
  for (int i = tid; i < count; i += threads) __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
}
__device__ inline void copy_commit() { __pipeline_commit(); }
__device__ inline void copy_wait() { __pipeline_wait_prior(0); }

template <class T>
__device__ inline void zero(T* dst, int count, int tid) {
  for (int i = tid; i < count; i += kThreads) dst[i] = T(0);
}

// (a b)[i] = sum_k a[i][k] b[k], a row-major rows x cols
template <class T>
__device__ inline T row_dot(const T* a, int i, int cols, const T* b) {
  T acc = T(0);
#pragma unroll 4
  for (int k = 0; k < cols; ++k) acc += a[i * cols + k] * b[k];
  return acc;
}

// (a^T b)[i] = sum_k a[k][i] b[k], a row-major rows x cols
template <class T>
__device__ inline T col_dot(const T* a, int i, int rows, int cols, const T* b) {
  T acc = T(0);
#pragma unroll 4
  for (int k = 0; k < rows; ++k) acc += a[k * cols + i] * b[k];
  return acc;
}

// L x = r in place for lower-triangular L (n x n, row-major) with the
// reciprocals of its diagonal rd: one warp, a lane holding rows lane and
// lane + 32, each solved entry passed by a shuffle from the lane that holds
// it.
template <class T>
__device__ void lower_solve(const T* l, const T* rd, int n, T* x, int lane) {
  T r0 = lane < n ? x[lane] : T(0);
  T r1 = lane + 32 < n ? x[lane + 32] : T(0);
  for (int k = 0; k < n; ++k) {
    const T own = (k < 32 ? r0 : r1) * rd[k];
    const T xk = __shfl_sync(0xffffffffu, own, k & 31);
    if (lane == (k & 31)) {
      if (k < 32) r0 = xk; else r1 = xk;
    }
    if (lane > k && lane < n) r0 -= l[lane * n + k] * xk;
    if (lane + 32 > k && lane + 32 < n) r1 -= l[(lane + 32) * n + k] * xk;
  }
  if (lane < n) x[lane] = r0;
  if (lane + 32 < n) x[lane + 32] = r1;
}

// L^T x = r in place, the same way from the last row up.
template <class T>
__device__ void upper_solve_t(const T* l, const T* rd, int n, T* x, int lane) {
  T r0 = lane < n ? x[lane] : T(0);
  T r1 = lane + 32 < n ? x[lane + 32] : T(0);
  for (int k = n - 1; k >= 0; --k) {
    const T own = (k < 32 ? r0 : r1) * rd[k];
    const T xk = __shfl_sync(0xffffffffu, own, k & 31);
    if (lane == (k & 31)) {
      if (k < 32) r0 = xk; else r1 = xk;
    }
    if (lane < k) r0 -= l[k * n + lane] * xk;
    if (lane + 32 < k) r1 -= l[k * n + lane + 32] * xk;
  }
  if (lane < n) x[lane] = r0;
  if (lane + 32 < n) x[lane + 32] = r1;
}

// Stage st's inputs to `in` by cp.async (the block's threads).
template <class T>
__device__ void load_stage(const StageIn<T> in, const Args<T>& a, size_t p, int st, int ns,
                           int tid) {
  const int nq = a.nq, nu = a.nu, h = a.h, q2 = nq * nq, t = st + 1;
  const T* aa = a.aa + p * h * q2;
  const T* ab = a.ab + p * h * q2;
  const T* rqa = a.rqa + p * h * nq;
  const T* rqb = a.rqb + p * h * nq;
  copy_async(in.aa, aa + t * q2, q2, tid, kThreads);
  copy_async(in.ab, ab + t * q2, q2, tid, kThreads);
  if (st < ns - 1) {
    copy_async(in.aan, aa + (t + 1) * q2, q2, tid, kThreads);
    copy_async(in.abn, ab + (t + 1) * q2, q2, tid, kThreads);
  }
  copy_async(in.qac, a.qat + t * q2, q2, tid, kThreads);
  copy_async(in.qbc, a.qbt + t * q2, q2, tid, kThreads);
  copy_async(in.qvc, a.qvt + t * q2, q2, tid, kThreads);
  copy_async(in.qan, a.qat + (t + 1) * q2, q2, tid, kThreads);
  copy_async(in.qbn, a.qbt + (t + 1) * q2, q2, tid, kThreads);
  copy_async(in.qvn, a.qvt + (t + 1) * q2, q2, tid, kThreads);
  copy_async(in.ba, a.ba + p * h * nq * nu + t * nq * nu, nq * nu, tid, kThreads);
  copy_async(in.ra, a.rat + t * nu * nu, nu * nu, tid, kThreads);
  copy_async(in.ru, a.ru + p * h * nu + t * nu, nu, tid, kThreads);
  copy_async(in.rqa, rqa + t * nq, nq, tid, kThreads);
  copy_async(in.rqb, rqb + t * nq, nq, tid, kThreads);
  copy_async(in.rd1, a.rd1 + p * h * nq + t * nq, nq, tid, kThreads);
  copy_async(in.rd2, a.rd2 + p * h * nq + t * nq, nq, tid, kThreads);
  if (st > 0) {
    copy_async(in.rqap, rqa + (t - 1) * nq, nq, tid, kThreads);
    copy_async(in.rqbp, rqb + (t - 1) * nq, nq, tid, kThreads);
  } else {
    zero(in.rqap, nq, tid);
    zero(in.rqbp, nq, tid);
  }
  copy_commit();
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1) structure_kkt_kernel(Args<T> a) {
  extern __shared__ double smem_raw[];
  const int nq = a.nq, nu = a.nu, h = a.h, ns = h - 1, n = 2 * nq;
  const int q2 = nq * nq, nn = n * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t p = blockIdx.x;
  Shared<T> s(reinterpret_cast<T*>(smem_raw), nq, nu, ns);

  const T* aa = a.aa + p * h * q2;
  const T* ab = a.ab + p * h * q2;
  const T* ba = a.ba + p * h * nq * nu;
  const T* ru = a.ru + p * h * nu;
  const T* rqa = a.rqa + p * h * nq;
  const T* rqb = a.rqb + p * h * nq;
  T* lii = a.lii + p * ns * nn;
  T* lji = a.lji + p * (ns - 1) * nn;
  const T beta = a.beta;

  // the thread's entries (i, j), j <= i, of an n x n lower triangle, packed
  // as i << 8 | j, in increasing order (-1 past the triangle)
  int owned[kOwned];
#pragma unroll
  for (int q = 0; q < kOwned; ++q) {
    const int e = tid + q * kThreads;
    int i = int((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    while (i * (i + 1) / 2 > e) --i;
    owned[q] = e < n * (n + 1) / 2 ? i << 8 | (e - i * (i + 1) / 2) : -1;
  }

  PhaseClock clk(blockIdx.x == 0 && threadIdx.x == 0);
  load_stage(s.stage(0, nq, nu), a, p, 0, ns, tid);
  copy_wait();
  __syncthreads();
  clk.mark(kFirstInputs);
  T* prev = s.p;   // Lji of the stage before
  T* off = s.y;    // this stage's Yij, then its Lji
  for (int st = 0; st < ns; ++st) {
    const bool last = st == ns - 1;
    const T mask = st > 0 ? T(1) : T(0);
    const StageIn<T> c = s.stage(st & 1, nq, nu);
    if (!last) load_stage(s.stage((st + 1) & 1, nq, nu), a, p, st + 1, ns, tid);
    clk.mark(kNextInputs);

    // ---- W, V, Yij and beta's inner products; Lji of the stage before to
    // the scratch ----
    for (int e = tid; e < nq * n; e += kThreads) {
      const int i = e / n, col = e % n;
      T acc = T(0);
      if (col < nq) {
        for (int k = 0; k < nq; ++k)
          acc += c.aa[i * nq + k] * c.qac[k * nq + col] + c.ab[i * nq + k] * c.qvc[k * nq + col];
      } else {
        const int cc = col - nq;
        for (int k = 0; k < nq; ++k)
          acc += c.aa[i * nq + k] * c.qvc[k * nq + cc] + c.ab[i * nq + k] * c.qbc[k * nq + cc];
      }
      s.w[e] = acc;
    }
    clk.mark(kW);
    for (int e = tid; e < nq * nu; e += kThreads) {
      const int i = e / nu, col = e % nu;
      T acc = T(0);
      for (int k = 0; k < nu; ++k) acc += c.ba[i * nu + k] * c.ra[k * nu + col];
      s.v[e] = acc;
    }
    clk.mark(kV);
    if (!last) {
      for (int e = tid; e < nn; e += kThreads) {
        const int i = e / n, j = e % n;
        const int ii = i < nq ? i : i - nq, jj = j < nq ? j : j - nq;
        T y;
        if (j < nq) {
          y = -(i < nq ? c.qvn : c.qbn)[ii * nq + jj];
        } else {
          // -(qat aan^T + qvt abn^T) over the top rows, -(qvt aan^T + qbt abn^T) below
          const T* q1 = i < nq ? c.qan : c.qvn;
          const T* q2b = i < nq ? c.qvn : c.qbn;
          T acc1 = T(0), acc2 = T(0);
          for (int k = 0; k < nq; ++k) {
            acc1 += q1[ii * nq + k] * c.aan[jj * nq + k];
            acc2 += q2b[ii * nq + k] * c.abn[jj * nq + k];
          }
          y = -(acc1 + acc2);
        }
        off[e] = y;
      }
    }
    clk.mark(kYij);
    // beta's products, an entry a thread: g = rat ru, pa = qat rqap,
    // pb = qbt rqbp, pc = qvt rqbp, pd = qvt rqap
    for (int e = tid; e < nu + 4 * nq; e += kThreads) {
      if (e < nu) {
        s.g[e] = row_dot(c.ra, e, nu, c.ru);
      } else {
        const int f = (e - nu) / nq, i = (e - nu) % nq;
        const T* m = f == 0 ? c.qac : f == 1 ? c.qbc : c.qvc;
        const T* v = f == 0 || f == 3 ? c.rqap : c.rqbp;
        (f == 0 ? s.pa : f == 1 ? s.pb : f == 2 ? s.pc : s.pd)[i] = row_dot(m, i, nq, v);
      }
    }
    clk.mark(kBetaProducts);
    if (st > 0)
      for (int e = tid; e < nn; e += kThreads) lji[(st - 1) * nn + e] = prev[e];
    __syncthreads();
    clk.mark(kLjiOut);

    // ---- M = Yii - prev^T prev (lower triangle), beta ----
    for (int e = tid; e < nn; e += kThreads) {
      const int i = e / n, j = e % n;
      if (j > i) continue;
      T y;
      if (i < nq) {
        y = c.qan[i * nq + j] + mask * c.qbc[i * nq + j] + (i == j ? beta : T(0));
      } else if (j < nq) {
        y = c.qvn[(i - nq) * nq + j] + mask * s.w[(i - nq) * n + nq + j];
      } else {
        const int ii = i - nq, jj = j - nq;
        T bab = T(0), gq = T(0);
        for (int k = 0; k < nu; ++k) bab += s.v[ii * nu + k] * c.ba[jj * nu + k];
        for (int k = 0; k < nq; ++k)
          gq += s.w[ii * n + k] * c.aa[jj * nq + k] + s.w[ii * n + nq + k] * c.ab[jj * nq + k];
        y = c.qbn[ii * nq + jj] + bab + mask * gq + (ii == jj ? beta : T(0));
      }
      if (st > 0) {
        T acc = T(0);
        for (int k = 0; k < n; ++k) acc += prev[k * n + i] * prev[k * n + j];
        y = y - acc;
      }
      s.m[e] = y;
    }
    // beta's nine inner products a row, a product a thread: qat' rqa, qvt'
    // rqb; ba g, qbt' rqb, qvt' rqa, aa pa, ab pb, aa pc, ab pd
    for (int e = tid; e < 9 * nq; e += kThreads) {
      const int f = e / nq, i = e % nq;
      const T* m = f == 0 ? c.qan : f == 1 || f == 4 ? c.qvn : f == 3 ? c.qbn
                 : f == 5 || f == 7 ? c.aa : c.ab;
      const T* v = f == 0 || f == 4 ? c.rqa : f == 1 || f == 3 ? c.rqb : f == 5 ? s.pa
                 : f == 6 ? s.pb : f == 7 ? s.pc : s.pd;
      s.dots[e] = f == 2 ? row_dot(c.ba, i, nu, s.g) : row_dot(m, i, nq, v);
    }
    __syncthreads();
    for (int i = tid; i < nq; i += kThreads) {
      const T* d = s.dots;
      s.beta[i] = -c.rd1[i] + d[i] + d[nq + i] - mask * (s.pb[i] + s.pd[i]);
      s.beta[nq + i] = -c.rd2[i] - d[2 * nq + i] + d[3 * nq + i] + d[4 * nq + i]
                     - mask * (d[5 * nq + i] + d[6 * nq + i] + d[7 * nq + i] + d[8 * nq + i]);
    }
    clk.mark(kMAndBeta);

    // ---- L = chol(M), a barrier a column: each thread updates its own
    // entries with the pivot's reciprocal square root ----
    bool bad = false;
    for (int k = 0; k < n; ++k) {
      const T d = s.m[k * n + k];
      bad = bad || !(d > T(0));
      const T r = inv_sqrt(d);
#pragma unroll
      for (int q = 0; q < kOwned; ++q) {
        const int o = owned[q], i = o >> 8, j = o & 255;
        if (o < 0) break;
        if (j < k) continue;
        if (j > k) {
          s.m[i * n + j] -= (s.m[i * n + k] * r) * (s.m[j * n + k] * r);
        } else if (i > k) {
          s.l[i * n + k] = s.m[i * n + k] * r;
        } else {
          s.l[k * n + k] = sqrt(d);
          s.rdiag[k] = r;
        }
      }
      __syncthreads();
    }
    clk.mark(kCholesky);
    for (int e = tid; e < nn; e += kThreads) {
      const int i = e / n, j = e % n;
      T v = s.l[e];
      if (j > i) v = T(0);
      else if (bad) set_nan(v);
      s.l[e] = v;
      lii[st * nn + e] = v;
    }
    if (bad)
      for (int i = tid; i < n; i += kThreads) set_nan(s.rdiag[i]);
    __syncthreads();
    clk.mark(kFactorOut);

    // ---- Lji = L^-1 Yij, a column a thread; y by the last warp ----
    if (!last && tid < n) {
      const int j = tid;
      for (int i = 0; i < n; ++i) {
        T v = off[i * n + j];
#pragma unroll 4
        for (int k = 0; k < i; ++k) v -= s.l[i * n + k] * off[k * n + j];
        off[i * n + j] = v * s.rdiag[i];
      }
    }
    if (warp == kWarps - 1) {
      T* y = s.ys + st * n;
      for (int i = lane; i < n; i += 32) {
        T v = s.beta[i];
        if (st > 0) v = v - col_dot(prev, i, n, n, s.ys + (st - 1) * n);
        y[i] = v;
      }
      __syncwarp();
      lower_solve(s.l, s.rdiag, n, y, lane);
    }
    copy_wait();     // the next stage's inputs
    __syncthreads();
    clk.mark(kLjiAndForward);
    T* tmp = prev;
    prev = off;
    off = tmp;
  }

  // ---- x_t = L_t^-T (y_t - Lji_t x_{t+1}): warp 0 solves a stage from
  // shared copies of its factors while the other warps copy in the next ----
  copy_async(s.m, lii + (ns - 1) * nn, nn, tid, kThreads);
  copy_commit();
  copy_wait();
  __syncthreads();
  for (int st = ns - 1; st >= 0; --st) {
    const bool b = (ns - 1 - st) & 1;     // this stage's factors: m, l or y, p
    T* fl = b ? s.y : s.m;
    T* fj = b ? s.p : s.l;
    T* rd = s.rdiag + (b ? n : 0);
    if (warp == 0) {
      for (int i = lane; i < n; i += 32) rd[i] = T(1) / fl[i * n + i];
      T* x = s.xs + st * n;
      for (int i = lane; i < n; i += 32) {
        T v = s.ys[st * n + i];
        if (st < ns - 1) v = v - row_dot(fj, i, n, s.xs + (st + 1) * n);
        x[i] = v;
      }
      __syncwarp();
      upper_solve_t(fl, rd, n, x, lane);
    } else if (st > 0) {
      copy_async(b ? s.m : s.y, lii + (st - 1) * nn, nn, tid - 32, kThreads - 32);
      copy_async(b ? s.l : s.p, lji + (st - 1) * nn, nn, tid - 32, kThreads - 32);
      copy_commit();
      copy_wait();
    }
    __syncthreads();
  }
  clk.mark(kBackward);

  // ---- the step: ea, eb and du's inner vector, then du, dqa, dqb, dnu ----
  for (int e = tid; e < ns * nq; e += kThreads) {
    const int st = e / nq, i = e % nq, t = st + 1;
    const T* x = s.xs + st * n;
    T va = T(0), vb = T(0), nu1 = T(0);
    if (st < ns - 1) {
      const T* xn = s.xs + (st + 1) * n;
      va = col_dot(aa + (t + 1) * q2, i, nq, nq, xn + nq);
      vb = col_dot(ab + (t + 1) * q2, i, nq, nq, xn + nq);
      nu1 = xn[i];
    }
    s.ea[e] = rqa[t * nq + i] - x[i] + va;
    s.eb[e] = rqb[t * nq + i] - x[nq + i] + vb + nu1;
  }
  for (int e = tid; e < ns * nu; e += kThreads) {
    const int st = e / nu, i = e % nu, t = st + 1;
    s.vu[e] = ru[t * nu + i] + col_dot(ba + t * nq * nu, i, nq, nu, s.xs + st * n + nq);
  }
  __syncthreads();
  T* du = a.du + p * h * nu;
  T* dqa = a.dqa + p * h * nq;
  T* dqb = a.dqb + p * h * nq;
  T* dnu1 = a.dnu1 + p * h * nq;
  T* dnu2 = a.dnu2 + p * h * nq;
  for (int i = tid; i < nu; i += kThreads) du[i] = T(0);
  for (int i = tid; i < nq; i += kThreads) dqa[i] = dqb[i] = dnu1[i] = dnu2[i] = T(0);
  for (int e = tid; e < ns * nu; e += kThreads) {
    const int st = e / nu, i = e % nu, t = st + 1;
    du[t * nu + i] = row_dot(a.rat + t * nu * nu, i, nu, s.vu + st * nu);
  }
  for (int e = tid; e < ns * nq; e += kThreads) {
    const int st = e / nq, i = e % nq, t = st + 1;
    const T* ea = s.ea + st * nq;
    const T* eb = s.eb + st * nq;
    const T* qa = a.qat + (t + 1) * q2;
    const T* qb = a.qbt + (t + 1) * q2;
    const T* qv = a.qvt + (t + 1) * q2;
    dqa[t * nq + i] = row_dot(qa, i, nq, ea) + row_dot(qv, i, nq, eb);
    dqb[t * nq + i] = row_dot(qb, i, nq, eb) + row_dot(qv, i, nq, ea);
    dnu1[t * nq + i] = s.xs[st * n + i];
    dnu2[t * nq + i] = s.xs[st * n + nq + i];
  }
  clk.sync_mark(kRecovery);
}

// ---- host side ---------------------------------------------------------------

template <class T>
int launch(const Args<T>& a, int batch, cudaStream_t stream) {
  const int bytes = int(sizeof(T)) * shared_values(a.nq, a.nu, a.h - 1);
  if (bytes > kSharedLimit) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      structure_kkt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  structure_kkt_kernel<T><<<batch, kThreads, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

template <class T>
int dispatch(const void* const* in, void* const* out, int batch, int nq, int nu, int h,
             double beta, cudaStream_t stream) {
  Args<T> a;
  const T* const* i = reinterpret_cast<const T* const*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
  a.qat = i[0]; a.qbt = i[1]; a.qvt = i[2]; a.rat = i[3];
  a.aa = i[4]; a.ab = i[5]; a.ba = i[6];
  a.ru = i[7]; a.rqa = i[8]; a.rqb = i[9]; a.rd1 = i[10]; a.rd2 = i[11];
  a.du = o[0]; a.dqa = o[1]; a.dqb = o[2]; a.dnu1 = o[3]; a.dnu2 = o[4];
  a.lii = o[5]; a.lji = o[6];
  a.nq = nq; a.nu = nu; a.h = h;
  a.beta = T(beta);
  return launch<T>(a, batch, stream);
}

bool holds(int nq, int nu, int h) {
  return nq >= 1 && 2 * nq <= kMaxN && nu >= 1 && nu <= kMaxNu && h >= kMinH;
}

}  // namespace structure_kkt

// The shared bytes a block of a problem in elem_bytes-byte values takes, or
// -1 for dimensions the source does not hold.
extern "C" int structure_kkt_shared_bytes(int elem_bytes, int nq, int nu, int h) {
  if (!structure_kkt::holds(nq, nu, h) || (elem_bytes != 4 && elem_bytes != 8)) return -1;
  return elem_bytes * structure_kkt::shared_values(nq, nu, h - 1);
}

// One structured KKT solve of each of batch problems, float32 (elem_bytes 4)
// or float64 (8): in[12] = qat, qbt, qvt, rat, aa, ab, ba, rlagu, rlagqa,
// rlagqb, rdyn1, rdyn2; out[7] = du, dqa, dqb, dnu1, dnu2 and the factors'
// scratch lii, lji (ops/structure_kkt.py has the shapes). 0 on success, a
// CUDA error code, or -1 for dimensions or a type the source does not hold.
extern "C" int structure_kkt_launch(int elem_bytes, const void* const* in,
                                    void* const* out, int batch, int nq, int nu,
                                    int h, double beta, void* stream) {
  if (batch < 0 || !structure_kkt::holds(nq, nu, h)) return -1;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return structure_kkt::dispatch<float>(in, out, batch, nq, nu, h, beta, s);
  if (elem_bytes == 8)
    return structure_kkt::dispatch<double>(in, out, batch, nq, nu, h, beta, s);
  return -1;
}
