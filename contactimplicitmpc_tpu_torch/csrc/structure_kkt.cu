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
//     L = chol(M), Lji = L^-1 Yij;
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
// dependent steps: ns stages of n Cholesky column steps and triangular
// solves. The design keeps only that chain on the stage sweep:
//   - a prologue: every stage's inputs copied into shared memory at once by
//     16-byte cp.async, then, for all stages in parallel across the block,
//     everything that does not depend on the stage before: W, V, Yij, Yii
//     without its -Lji^T Lji term, and beta. Where every stage does not fit
//     (large nq at H = 20 in float64), the stages go in chunks of
//     chunk_stages (the rule below), a prologue a chunk;
//   - the chain a stage: M = Yii - P^T P with the forward substitution's
//     right-hand side (the block's threads); the n x n Cholesky of M by
//     warp 0, a lane a row in registers (a step's column to shared memory
//     and back 16 bytes a load, __syncwarp only), while for n <= kOneWarpN
//     warp 1 solves Lji = L^-1 Yij and y, a lane a column, a step behind
//     (a progress counter in shared memory), and the other warps write the
//     stage before's factors out; past kOneWarpN the columns are solved
//     over the warps after the Cholesky (whose rows, past 32, stay in
//     shared memory);
//   - the factors stay in shared memory for the backward substitution where
//     every stage fits (one warp, a lane a row), and go to the scratch the
//     wrapper allocates once, off the chain (structure_kkt_factors reads
//     them; the chunked backward reads them back from there).
//
// Arithmetic in the tensors' type, float32 or float64; products summed in
// their own order, so results agree with the plain version to rounding.
// With -DKKT_PHASE_CLOCKS thread 0 of block 0 clocks the phases below
// (kkt_clocks.cuh).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "kkt_clocks.cuh"

namespace structure_kkt {

constexpr int kThreads = 256;          // a block a problem
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 64;              // 2 nq: two rows a lane in the one-warp solves
constexpr int kMaxNu = 64;
constexpr int kMinH = 3;               // two stages: one off-diagonal block at least
constexpr int kCols = 4;               // columns a warp solves side by side (n > kOneWarpN)
constexpr int kOneWarpN = 30;          // n up to which one warp takes a stage's chain
constexpr int kSharedLimit = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// The clocked build's phases (ops/structure_kkt.py::PHASES has their names):
// a chunk's inputs and its prologue; a stage's M, Cholesky (with the stage
// before's factors written out) and Lji with y; the chunk's last factors
// out; the backward substitution; the step's recovery.
enum Phase { kInputs, kPrologue, kM, kCholesky, kLji, kFactorOut, kBackward, kRecovery,
             kPhases };
static_assert(kPhases <= kKktClockSlots, "a slot a phase");

// A copied input's room: count values and up to three more, for a start of
// the source's 16-byte alignment, in a whole number of 16-byte runs.
__host__ __device__ constexpr int padded(int count) { return (count + 7) / 4 * 4; }
// A chunk of s stages' inputs: aa, ab and the objective's qat, qbt, qvt over
// s + 1 knots; rat, ba, ru, rdyn1, rdyn2 over s; rlagqa, rlagqb over s + 1.
__host__ __device__ constexpr int input_values(int nq, int nu, int s) {
  return 5 * padded((s + 1) * nq * nq) + padded(s * nu * nu) + padded(s * nq * nu) + padded(s * nu) + 2 * padded(s * nq) + 2 * padded((s + 1) * nq);
}
// A chunk stage's own: Yii then L, Yij then Lji (rows of 2 nq + 1), and
// W, V and beta's products.
__host__ __device__ constexpr int stage_values(int nq, int nu) {
  return 4 * nq * (2 * nq + 1) + 2 * nq * nq + nq * nu + nu + 4 * nq;
}
// The Cholesky's columns (32 x 32), every stage's y, x and pivot
// reciprocals, the chunk before's last Lji, the recovery's ea, eb and du's
// inner vector, and two ints (the Cholesky's progress and a stage's
// non-positive pivot).
__host__ __device__ constexpr int fixed_values(int nq, int nu, int ns) {
  return 32 * 32 + 6 * ns * nq + 2 * nq * (2 * nq + 1) + ns * (2 * nq + nu) + 2;
}
// The values of the problem's type a block keeps in shared memory for nq,
// nu, ns = H - 1 stages and chunks of s stages (ops/structure_kkt.py::
// shared_bytes mirrors it).
__host__ __device__ constexpr int shared_values(int nq, int nu, int ns, int s) {
  return input_values(nq, nu, s) + s * stage_values(nq, nu) + fixed_values(nq, nu, ns);
}
// The stages a chunk takes: all ns where they fit, else the most that fit
// (0: the dimensions do not fit; ops/structure_kkt.py::chunk_stages mirrors
// it).
__host__ __device__ constexpr int chunk_stages(int nq, int nu, int ns, int elem_bytes) {
  int s = ns;
  while (s > 0 && elem_bytes * shared_values(nq, nu, ns, s) > kSharedLimit) --s;
  return s;
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

// A chunk's inputs in shared memory, from its first stage s0 (t0 = s0 + 1).
template <class T>
struct ChunkIn {
  const T *aa, *ab, *qa, *qb, *qv;   // knots t0 .. t0 + s
  const T *ra, *ba, *ru, *rd1, *rd2; // knots t0 .. t0 + s - 1
  const T *rqa, *rqb;                // knots t0 - 1 .. t0 + s - 1
};

__device__ inline void set_nan(double& x) { x = __longlong_as_double(0x7ff8000000000000LL); }
__device__ inline void set_nan(float& x) { x = __int_as_float(0x7fc00000); }
__device__ inline double inv_sqrt(double x) { return rsqrt(x); }
__device__ inline float inv_sqrt(float x) { return rsqrtf(x); }

// count values from global src into the shared room at `room` (16-byte
// aligned, padded(count) values) by cp.async, 16 bytes a copy but at the
// ends: the data start at the room's offset of src's 16-byte alignment,
// which is returned. Complete after __pipeline_wait_prior and a barrier.
template <class T>
__device__ const T* copy_in(T* room, const T* src, int count, int tid) {
  constexpr int vec = 16 / int(sizeof(T));
  const int shift = int(size_t(src) / sizeof(T) % vec);
  T* dst = room + shift;
  const int head = min(count, (vec - shift) % vec);
  const int runs = (count - head) / vec, tail = head + runs * vec;
  for (int e = tid; e < head + runs + count - tail; e += kThreads) {
    if (e < head) {
      __pipeline_memcpy_async(dst + e, src + e, sizeof(T));
    } else if (e < head + runs) {
      const int o = head + (e - head) * vec;
      __pipeline_memcpy_async(dst + o, src + o, 16);
    } else {
      const int o = tail + e - head - runs;
      __pipeline_memcpy_async(dst + o, src + o, sizeof(T));
    }
  }
  return dst;
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

// e / m for 0 <= e < 2^22, from inv = 1 / m in float32: (e + 1/2) / m lies
// at least 1 / (2 m) from an integer, far past float32's rounding there.
__device__ inline int div_by(int e, float inv) { return int((float(e) + 0.5f) * inv); }

// The lower triangle's entry e (row-major, diagonal included) as (i, j).
__device__ inline void tri_entry(int e, int& i, int& j) {
  i = int((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  while (i * (i + 1) / 2 > e) --i;
  j = e - i * (i + 1) / 2;
}

// 32 values from 16-byte aligned shared memory.
__device__ inline void load32(const float* p, float* out) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    out[4 * q] = v.x; out[4 * q + 1] = v.y; out[4 * q + 2] = v.z; out[4 * q + 3] = v.w;
  }
}
__device__ inline void load32(const double* p, double* out) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const double2 v = reinterpret_cast<const double2*>(p)[q];
    out[2 * q] = v.x; out[2 * q + 1] = v.y;
  }
}

// L = chol(M) in place (lower triangle, rows of ld) by one warp, a lane a
// row; rd gets the pivots' reciprocal square roots. A pivot that is not > 0
// turns the lower triangle and rd to NaN. For n <= 32 (every model but the
// centroidal family's n = 36) the lane's row lives in registers shifted a
// column a step; step k's column l_jk (j > k) goes to cols[k * 32 + j - k - 1]
// (16-byte aligned) and every lane reads it back 16 bytes a load, an entry
// above a lane's diagonal taking updates that are never read. Above 32, rows
// lane and lane + 32 stay in shared memory, l_j by shuffle.
template <class T>
__device__ void cholesky_warp(T* m, int ld, int n, T* rd, T* cols, volatile int* progress,
                              int base, int lane) {
  bool bad = false;
  if (n <= 32) {
    const bool live = lane < n;
    T v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = live && j <= lane ? m[lane * ld + j] : T(0);
#pragma unroll 2
    for (int k = 0; k < n; ++k) {
      const T d = __shfl_sync(kFull, v[0], k);
      bad = bad || !(d > T(0));
      const T r = inv_sqrt(d);
      const bool below = live && lane > k;
      const T l = v[0] * r;
      T* col = cols + k * 32;
      if (below) {
        col[lane - k - 1] = l;
        m[lane * ld + k] = l;
      }
      if (lane == k) {
        rd[k] = r;
        m[k * ld + k] = sqrt(d);
      }
      __syncwarp();
      if (lane == 0) {   // step k's column and pivot for the column solves
        __threadfence_block();
        *progress = base + k + 1;
      }
      T lj[32];
      load32(col, lj);
#pragma unroll
      for (int jj = 1; jj < 32; ++jj) v[jj - 1] = v[jj] - l * lj[jj - 1];
      v[31] = T(0);
    }
  } else {
    const int i0 = lane, i1 = lane + 32;
    T dg0 = T(0), dg1 = T(0);
    for (int k = 0; k < n; ++k) {
      const T d = m[k * ld + k];
      bad = bad || !(d > T(0));
      const T r = inv_sqrt(d);
      if (lane == (k & 31)) {
        rd[k] = r;
        if (k < 32) dg0 = sqrt(d); else dg1 = sqrt(d);
      }
      const bool b0 = i0 > k && i0 < n, b1 = i1 > k && i1 < n;
      const T l0 = b0 ? m[i0 * ld + k] * r : T(0);
      const T l1 = b1 ? m[i1 * ld + k] * r : T(0);
      for (int j = k + 1; j < n; ++j) {
        const T lj = __shfl_sync(kFull, j < 32 ? l0 : l1, j & 31);
        if (b0 && i0 >= j) m[i0 * ld + j] -= l0 * lj;
        if (b1 && i1 >= j) m[i1 * ld + j] -= l1 * lj;
      }
      if (b0) m[i0 * ld + k] = l0;
      if (b1) m[i1 * ld + k] = l1;
      __syncwarp();
    }
    for (int i = lane; i < n; i += 32) m[i * ld + i] = i < 32 ? dg0 : dg1;
  }
  __syncwarp();
  if (bad) {
    for (int i = lane; i < n; i += 32) {
      for (int j = 0; j <= i; ++j) set_nan(m[i * ld + j]);
      set_nan(rd[i]);
    }
  }
  if (lane == 0) progress[1] = bad;
  __syncwarp();
}

// L X = B in place by one warp for n <= kOneWarpN, a lane a column of B:
// Yij's n columns (rows of ld, where the stage has one) on lanes 0..n-1 and
// y's right-hand side (y) on lane n, each lane's column in registers
// shifted a row a step. Step k waits for the Cholesky's step k (progress
// past base + k): L's column k from the Cholesky's cols, 16 bytes a load,
// and rd[k], the reciprocal of its diagonal.
template <class T>
__device__ void solve_columns_warp(const T* cols, const T* rd, int n, T* yij, int ld, T* y,
                                   bool has_yij, const volatile int* progress, int base,
                                   int lane) {
  const bool on_y = lane == n, on = on_y || (has_yij && lane < n);
  T v[32];
#pragma unroll
  for (int m = 0; m < 32; ++m) v[m] = on && m < n ? (on_y ? y[m] : yij[m * ld + lane]) : T(0);
#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    while (*progress <= base + k) {
    }
    __threadfence_block();
    const T x = v[0] * rd[k];
    if (on_y) y[k] = x;
    else if (on) yij[k * ld + lane] = x;
    T lk[32];
    load32(cols + k * 32, lk);
#pragma unroll
    for (int jj = 1; jj < 32; ++jj) v[jj - 1] = v[jj] - lk[jj - 1] * x;
    v[31] = T(0);
  }
}

// L x = r in place for up to kCols columns side by side (column q's row i
// at col[q][i * stride[q]]), L's lower triangle in rows of ld, rd the
// reciprocals of its diagonal: one warp, a lane a row (lane and lane + 32),
// each solved entry passed by a shuffle from the lane that holds it.
template <class T>
__device__ void lower_solve(const T* l, int ld, const T* rd, int n, T* const* col,
                            const int* stride, int count, int lane) {
  T r0[kCols], r1[kCols];   // columns past count solve zeros, and are not stored
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    r0[q] = q < count && lane < n ? col[q][lane * stride[q]] : T(0);
    r1[q] = q < count && lane + 32 < n ? col[q][(lane + 32) * stride[q]] : T(0);
  }
  for (int k = 0; k < n; ++k) {
    const T rk = rd[k];
    const T lk0 = lane > k && lane < n ? l[lane * ld + k] : T(0);
    const T lk1 = lane + 32 > k && lane + 32 < n ? l[(lane + 32) * ld + k] : T(0);
    T xk[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) xk[q] = __shfl_sync(kFull, (k < 32 ? r0[q] : r1[q]) * rk, k & 31);
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const bool mine = lane == (k & 31);
      r0[q] = mine && k < 32 ? xk[q] : lane > k ? r0[q] - lk0 * xk[q] : r0[q];
      r1[q] = mine && k >= 32 ? xk[q] : lane + 32 > k ? r1[q] - lk1 * xk[q] : r1[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    if (q < count && lane < n) col[q][lane * stride[q]] = r0[q];
    if (q < count && lane + 32 < n) col[q][(lane + 32) * stride[q]] = r1[q];
  }
}

// L^T x = r in place (x in shared memory), the same way from the last row up.
template <class T>
__device__ void upper_solve_t(const T* l, int ld, const T* rd, int n, T* x, int lane) {
  T r0 = lane < n ? x[lane] : T(0);
  T r1 = lane + 32 < n ? x[lane + 32] : T(0);
#pragma unroll 4
  for (int k = n - 1; k >= 0; --k) {
    const T xk = __shfl_sync(kFull, (k < 32 ? r0 : r1) * rd[k], k & 31);
    if (lane == (k & 31)) {
      if (k < 32) r0 = xk; else r1 = xk;
    }
    if (lane < k) r0 -= l[k * ld + lane] * xk;
    if (lane + 32 < k) r1 -= l[k * ld + lane + 32] * xk;
  }
  if (lane < n) x[lane] = r0;
  if (lane + 32 < n) x[lane + 32] = r1;
}

// Stage st's factors (shared, rows of ld) to the scratch: L with zeros
// above the diagonal, and Lji where the stage has one (warps w0 ..
// w0 + warps - 1 of the block, a row a warp).
template <class T>
__device__ void factors_out(const T* l, const T* lj, int ld, int n, int st, int ns, T* lii,
                            T* lji, int w, int warps, int lane) {
  const int nn = n * n;
  for (int i = w; i < n; i += warps) {
    for (int j = lane; j < n; j += 32) {
      lii[st * nn + i * n + j] = j > i ? T(0) : l[i * ld + j];
      if (st < ns - 1) lji[st * nn + i * n + j] = lj[i * ld + j];
    }
  }
}

// x_t = L_t^-T (y_t - Lji_t x_{t+1}) from the last stage up, by one warp, a
// lane a row; the factors in rows of ldt (shared memory or the scratch).
template <class T>
__device__ void backward_warp(const T* lall, const T* jall, int ldt, int stride, const T* ys,
                              const T* rd, T* xs, int n, int ns, int lane) {
  for (int st = ns - 1; st >= 0; --st) {
    const T* lt = lall + st * stride;
    const T* jt = jall + st * stride;
    T* x = xs + st * n;
    for (int i = lane; i < n; i += 32) {
      T v = ys[st * n + i];
      if (st < ns - 1) {
        T acc = T(0);
#pragma unroll 4
        for (int k = 0; k < n; ++k) acc += jt[i * ldt + k] * xs[(st + 1) * n + k];
        v = v - acc;
      }
      x[i] = v;
    }
    __syncwarp();
    upper_solve_t(lt, ldt, rd + st * n, n, x, lane);
    __syncwarp();
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1) structure_kkt_kernel(Args<T> a, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq = a.nq, nu = a.nu, h = a.h, ns = h - 1, n = 2 * nq, ld = n + 1;
  const int q2 = nq * nq, nn = n * n, wvs = nq * n + nq * nu + nu + 4 * nq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t p = blockIdx.x;
  const bool fit = chunk == ns;   // every stage's factors stay for the backward substitution

  // shared memory, carved in shared_values' order
  T* in_room = reinterpret_cast<T*>(smem_raw);
  T* slot_l = in_room + input_values(nq, nu, chunk);   // chunk x n x ld: Yii, then L
  T* slot_j = slot_l + chunk * n * ld;                 // chunk x n x ld: Yij, then Lji
  T* cols = slot_j + chunk * n * ld;                   // 32 x 32: the Cholesky's columns
  T* wv = cols + 32 * 32;                              // chunk x (W, V, g, pa, pb, pc, pd)
  T* ys = wv + chunk * wvs;                            // ns x n: beta, then y
  T* xs = ys + ns * n;                                 // ns x n
  T* rd = xs + ns * n;                                 // ns x n
  T* carry = rd + ns * n;                              // n x ld: the chunk before's last Lji
  T* s_ea = carry + n * ld;                            // ns x nq
  T* s_eb = s_ea + ns * nq;                            // ns x nq
  T* s_vu = s_eb + ns * nq;                            // ns x nu
  volatile int* progress = reinterpret_cast<int*>(s_vu + ns * nu);   // and the stage's bad pivot

  const T* aa = a.aa + p * h * q2;
  const T* ab = a.ab + p * h * q2;
  const T* ba = a.ba + p * h * nq * nu;
  const T* ru = a.ru + p * h * nu;
  const T* rqa = a.rqa + p * h * nq;
  const T* rqb = a.rqb + p * h * nq;
  T* lii = a.lii + p * ns * nn;
  T* lji = a.lji + p * (ns - 1) * nn;
  const T beta = a.beta;

  PhaseClock clk(blockIdx.x == 0 && threadIdx.x == 0);
  if (tid == 0) progress[0] = 0;
  for (int s0 = 0; s0 < ns; s0 += chunk) {
    const int sc = min(chunk, ns - s0), t0 = s0 + 1;
    const int knots = min(sc + 1, h - t0);   // aa, ab rows t0 .. (the last stage has no next)

    // ---- the chunk's inputs, 16 bytes a copy ----
    ChunkIn<T> c;
    T* room = in_room;
    auto take = [&](const T* src, int count, int cap) {
      const T* got = copy_in(room, src, count, tid);
      room += padded(cap);
      return got;
    };
    c.aa = take(aa + t0 * q2, knots * q2, (chunk + 1) * q2);
    c.ab = take(ab + t0 * q2, knots * q2, (chunk + 1) * q2);
    c.qa = take(a.qat + t0 * q2, (sc + 1) * q2, (chunk + 1) * q2);
    c.qb = take(a.qbt + t0 * q2, (sc + 1) * q2, (chunk + 1) * q2);
    c.qv = take(a.qvt + t0 * q2, (sc + 1) * q2, (chunk + 1) * q2);
    c.ra = take(a.rat + t0 * nu * nu, sc * nu * nu, chunk * nu * nu);
    c.ba = take(ba + t0 * nq * nu, sc * nq * nu, chunk * nq * nu);
    c.ru = take(ru + t0 * nu, sc * nu, chunk * nu);
    c.rd1 = take(a.rd1 + p * h * nq + t0 * nq, sc * nq, chunk * nq);
    c.rd2 = take(a.rd2 + p * h * nq + t0 * nq, sc * nq, chunk * nq);
    c.rqa = take(rqa + (t0 - 1) * nq, (sc + 1) * nq, (chunk + 1) * nq);
    c.rqb = take(rqb + (t0 - 1) * nq, (sc + 1) * nq, (chunk + 1) * nq);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    clk.mark(kInputs);

    // ---- prologue 1, every stage of the chunk at once: W = [aa ab] Q,
    // V = ba R^-1, and beta's products g = rat ru, pa = qat rqap,
    // pb = qbt rqbp, pc = qvt rqbp, pd = qvt rqap (zero at stage 0) ----
    const float inv_wvs = 1.0f / float(wvs), inv_n = 1.0f / float(n), inv_nu = 1.0f / float(nu),
                inv_nq = 1.0f / float(nq);
    for (int g0 = tid; g0 < sc * wvs; g0 += kThreads) {
      const int u = div_by(g0, inv_wvs), e = g0 - u * wvs;
      const T* ca = c.aa + u * q2;
      const T* cb = c.ab + u * q2;
      const T* qac = c.qa + u * q2;
      const T* qbc = c.qb + u * q2;
      const T* qvc = c.qv + u * q2;
      T* w = wv + u * wvs;
      if (e < nq * n) {
        const int i = div_by(e, inv_n), col = e - i * n;
        const T* q1 = col < nq ? qac : qvc;
        const T* q2p = col < nq ? qvc : qbc;
        const int cc = col < nq ? col : col - nq;
        T acc = T(0);
        for (int k = 0; k < nq; ++k) acc += ca[i * nq + k] * q1[k * nq + cc] + cb[i * nq + k] * q2p[k * nq + cc];
        w[e] = acc;
      } else if (e < nq * n + nq * nu) {
        const int f = e - nq * n, i = div_by(f, inv_nu), col = f - i * nu;
        const T* bam = c.ba + u * nq * nu;
        const T* ra = c.ra + u * nu * nu;
        T acc = T(0);
        for (int k = 0; k < nu; ++k) acc += bam[i * nu + k] * ra[k * nu + col];
        w[e] = acc;
      } else {
        const int f = e - nq * n - nq * nu;
        if (f < nu) {
          w[e] = row_dot(c.ra + u * nu * nu, f, nu, c.ru + u * nu);
        } else {
          const int kind = div_by(f - nu, inv_nq), i = f - nu - kind * nq;
          const T* m = kind == 0 ? qac : kind == 1 ? qbc : qvc;
          const T* v = (kind == 0 || kind == 3 ? c.rqa : c.rqb) + u * nq;   // knot t - 1
          w[e] = s0 + u > 0 ? row_dot(m, i, nq, v) : T(0);
        }
      }
    }
    __syncthreads();

    // ---- prologue 2, every stage at once: Yii's lower triangle, Yij (but
    // at the last stage) and beta ----
    const int tri = n * (n + 1) / 2, per = tri + nn + n;
    const float inv_per = 1.0f / float(per);
    for (int g0 = tid; g0 < sc * per; g0 += kThreads) {
      const int u = div_by(g0, inv_per), e = g0 - u * per, st = s0 + u;
      const T mask = st > 0 ? T(1) : T(0);
      const T* w = wv + u * wvs;
      const T* v = w + nq * n;
      const T* g = v + nq * nu;
      const T *pa = g + nu, *pb = pa + nq, *pc = pb + nq, *pd = pc + nq;
      const T* ca = c.aa + u * q2;
      const T* cb = c.ab + u * q2;
      const T* bam = c.ba + u * nq * nu;
      const T* qan = c.qa + (u + 1) * q2;
      const T* qbn = c.qb + (u + 1) * q2;
      const T* qvn = c.qv + (u + 1) * q2;
      const T* aan = c.aa + (u + 1) * q2;
      const T* abn = c.ab + (u + 1) * q2;
      const T* rqa_t = c.rqa + (u + 1) * nq;
      const T* rqb_t = c.rqb + (u + 1) * nq;
      const bool has_yij = st < ns - 1;
      {
        if (e < tri) {
          int i, j;
          tri_entry(e, i, j);
          T y;
          if (i < nq) {
            y = qan[i * nq + j] + mask * c.qb[u * q2 + i * nq + j] + (i == j ? beta : T(0));
          } else if (j < nq) {
            y = qvn[(i - nq) * nq + j] + mask * w[(i - nq) * n + nq + j];
          } else {
            const int ii = i - nq, jj = j - nq;
            T bab = T(0), gq = T(0);
            for (int k = 0; k < nu; ++k) bab += v[ii * nu + k] * bam[jj * nu + k];
            for (int k = 0; k < nq; ++k)
              gq += w[ii * n + k] * ca[jj * nq + k] + w[ii * n + nq + k] * cb[jj * nq + k];
            y = qbn[ii * nq + jj] + bab + mask * gq + (ii == jj ? beta : T(0));
          }
          slot_l[u * n * ld + i * ld + j] = y;
        } else if (e < tri + nn) {
          if (!has_yij) continue;
          const int f = e - tri, i = div_by(f, inv_n), j = f - i * n;
          const int ii = i < nq ? i : i - nq, jj = j < nq ? j : j - nq;
          T y;
          if (j < nq) {
            y = -(i < nq ? qvn : qbn)[ii * nq + jj];
          } else {
            // -(qat aan^T + qvt abn^T) over the top rows, -(qvt aan^T + qbt abn^T) below
            const T* q1 = i < nq ? qan : qvn;
            const T* q2b = i < nq ? qvn : qbn;
            T acc1 = T(0), acc2 = T(0);
            for (int k = 0; k < nq; ++k) {
              acc1 += q1[ii * nq + k] * aan[jj * nq + k];
              acc2 += q2b[ii * nq + k] * abn[jj * nq + k];
            }
            y = -(acc1 + acc2);
          }
          slot_j[u * n * ld + i * ld + j] = y;
        } else {
          const int i = e - tri - nn;
          T b;
          if (i < nq) {
            b = -c.rd1[u * nq + i] + row_dot(qan, i, nq, rqa_t) + row_dot(qvn, i, nq, rqb_t)
                - mask * (pb[i] + pd[i]);
          } else {
            const int ii = i - nq;
            b = -c.rd2[u * nq + ii] - row_dot(bam, ii, nu, g)
                + row_dot(qbn, ii, nq, rqb_t) + row_dot(qvn, ii, nq, rqa_t)
                - mask * (row_dot(ca, ii, nq, pa) + row_dot(cb, ii, nq, pb) + row_dot(ca, ii, nq, pc)
                          + row_dot(cb, ii, nq, pd));
          }
          ys[st * n + i] = b;
        }
      }
    }
    __syncthreads();
    clk.mark(kPrologue);

    // ---- the chain: a stage at a time ----
    for (int st = s0; st < s0 + sc; ++st) {
      const int u = st - s0;
      T* lt = slot_l + u * n * ld;
      T* jt = slot_j + u * n * ld;
      const T* prev = u > 0 ? slot_j + (u - 1) * n * ld : carry;   // Lji of the stage before
      T* y = ys + st * n;
      const T* yp = y - n;   // y of the stage before
      // M = Yii - prev^T prev (lower triangle); y's right-hand side
      if (st > 0) {
        const int tri = n * (n + 1) / 2;
        for (int e = tid; e < tri + n; e += kThreads) {
          if (e < tri) {
            int i, j;
            tri_entry(e, i, j);
            T acc = T(0);
            for (int k = 0; k < n; ++k) acc += prev[k * ld + i] * prev[k * ld + j];
            lt[i * ld + j] = lt[i * ld + j] - acc;
          } else {
            const int i = e - tri;
            T acc = T(0);
            for (int k = 0; k < n; ++k) acc += prev[k * ld + i] * yp[k];
            y[i] = y[i] - acc;
          }
        }
        __syncthreads();
      }
      clk.mark(kM);
      // L = chol(M) by warp 0 and, for n <= kOneWarpN, Lji = L^-1 Yij and
      // y = L^-1 y by warp 1 a lane a column, a step behind; the stage
      // before's factors out by the other warps
      const bool one = n <= kOneWarpN, has_yij = st < ns - 1;
      if (warp == 0) {
        cholesky_warp(lt, ld, n, rd + st * n, cols, progress, 64 * st, lane);
        clk.mark(kCholesky);
      } else if (warp == 1 && one) {
        solve_columns_warp(cols, rd + st * n, n, jt, ld, y, has_yij, progress, 64 * st, lane);
      } else if (u > 0) {
        const int w0 = one ? 2 : 1;
        factors_out(slot_l + (u - 1) * n * ld, slot_j + (u - 1) * n * ld, ld, n, st - 1, ns,
                    lii, lji, warp - w0, kWarps - w0, lane);
      }
      __syncthreads();
      if (one && progress[1]) {   // L is NaN below its diagonal: so are Lji and y
        for (int e = tid; e < n * ld; e += kThreads) {
          if (has_yij) set_nan(jt[e]);
          if (e < n) set_nan(y[e]);
        }
        __syncthreads();
      }
      // above kOneWarpN: Lji and y, their columns over the warps
      if (!one) {
        const int cols = (st < ns - 1 ? n : 0) + 1;
        for (int c0 = warp; c0 < cols; c0 += kCols * kWarps) {
          T* col[kCols];
          int stride[kCols], count = 0;
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            const int idx = c0 + q * kWarps;
            col[q] = idx == cols - 1 ? y : jt + idx;
            stride[q] = idx == cols - 1 ? 1 : ld;
            if (idx < cols) count = q + 1;
          }
          lower_solve(lt, ld, rd + st * n, n, col, stride, count, lane);
        }
        __syncthreads();
      }
      clk.mark(kLji);
    }
    // the chunk's last stage's factors out; its Lji carried to the next chunk
    {
      const int u = sc - 1, st = s0 + u;
      factors_out(slot_l + u * n * ld, slot_j + u * n * ld, ld, n, st, ns, lii, lji, warp,
                  kWarps, lane);
      if (st < ns - 1)
        for (int e = tid; e < n * ld; e += kThreads) carry[e] = slot_j[u * n * ld + e];
      __syncthreads();
    }
    clk.mark(kFactorOut);
  }

  // ---- x_t = L_t^-T (y_t - Lji_t x_{t+1}) by warp 0, the factors from
  // shared memory where every stage fits, else from the scratch ----
  if (warp == 0) {
    if (fit)
      backward_warp(slot_l, slot_j, ld, n * ld, ys, rd, xs, n, ns, lane);
    else
      backward_warp<T>(lii, lji, n, nn, ys, rd, xs, n, ns, lane);
  }
  __syncthreads();
  clk.mark(kBackward);

  // ---- the step: ea, eb and du's inner vector, then du, dqa, dqb, dnu ----
  for (int e = tid; e < ns * nq; e += kThreads) {
    const int st = e / nq, i = e % nq, t = st + 1;
    const T* x = xs + st * n;
    T va = T(0), vb = T(0), nu1 = T(0);
    if (st < ns - 1) {
      const T* xn = xs + (st + 1) * n;
      va = col_dot(aa + (t + 1) * q2, i, nq, nq, xn + nq);
      vb = col_dot(ab + (t + 1) * q2, i, nq, nq, xn + nq);
      nu1 = xn[i];
    }
    s_ea[e] = rqa[t * nq + i] - x[i] + va;
    s_eb[e] = rqb[t * nq + i] - x[nq + i] + vb + nu1;
  }
  for (int e = tid; e < ns * nu; e += kThreads) {
    const int st = e / nu, i = e % nu, t = st + 1;
    s_vu[e] = ru[t * nu + i] + col_dot(ba + t * nq * nu, i, nq, nu, xs + st * n + nq);
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
    du[t * nu + i] = row_dot(a.rat + t * nu * nu, i, nu, s_vu + st * nu);
  }
  for (int e = tid; e < ns * nq; e += kThreads) {
    const int st = e / nq, i = e % nq, t = st + 1;
    const T* ea = s_ea + st * nq;
    const T* eb = s_eb + st * nq;
    const T* qa = a.qat + (t + 1) * q2;
    const T* qb = a.qbt + (t + 1) * q2;
    const T* qv = a.qvt + (t + 1) * q2;
    dqa[t * nq + i] = row_dot(qa, i, nq, ea) + row_dot(qv, i, nq, eb);
    dqb[t * nq + i] = row_dot(qb, i, nq, eb) + row_dot(qv, i, nq, ea);
    dnu1[t * nq + i] = xs[st * n + i];
    dnu2[t * nq + i] = xs[st * n + nq + i];
  }
  clk.sync_mark(kRecovery);
}

// ---- host side ---------------------------------------------------------------

template <class T>
int launch(const Args<T>& a, int batch, cudaStream_t stream) {
  const int ns = a.h - 1, chunk = chunk_stages(a.nq, a.nu, ns, int(sizeof(T)));
  if (chunk < 1) return -1;
  const int bytes = int(sizeof(T)) * shared_values(a.nq, a.nu, ns, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      structure_kkt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  structure_kkt_kernel<T><<<batch, kThreads, bytes, stream>>>(a, chunk);
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

bool holds(int nq, int nu, int h, int elem_bytes) {
  return nq >= 1 && 2 * nq <= kMaxN && nu >= 1 && nu <= kMaxNu && h >= kMinH &&
         (elem_bytes == 4 || elem_bytes == 8) && chunk_stages(nq, nu, h - 1, elem_bytes) >= 1;
}

}  // namespace structure_kkt

// The stages a chunk of a problem in elem_bytes-byte values takes, or -1 for
// dimensions the source does not hold.
extern "C" int structure_kkt_chunk_stages(int elem_bytes, int nq, int nu, int h) {
  if (!structure_kkt::holds(nq, nu, h, elem_bytes)) return -1;
  return structure_kkt::chunk_stages(nq, nu, h - 1, elem_bytes);
}

// The shared bytes a block of a problem in elem_bytes-byte values takes, or
// -1 for dimensions the source does not hold.
extern "C" int structure_kkt_shared_bytes(int elem_bytes, int nq, int nu, int h) {
  if (!structure_kkt::holds(nq, nu, h, elem_bytes)) return -1;
  const int ns = h - 1;
  return elem_bytes * structure_kkt::shared_values(
      nq, nu, ns, structure_kkt::chunk_stages(nq, nu, ns, elem_bytes));
}

// One structured KKT solve of each of batch problems, float32 (elem_bytes 4)
// or float64 (8): in[12] = qat, qbt, qvt, rat, aa, ab, ba, rlagu, rlagqa,
// rlagqb, rdyn1, rdyn2; out[7] = du, dqa, dqb, dnu1, dnu2 and the factors'
// scratch lii, lji (ops/structure_kkt.py has the shapes). 0 on success, a
// CUDA error code, or -1 for dimensions or a type the source does not hold.
extern "C" int structure_kkt_launch(int elem_bytes, const void* const* in,
                                    void* const* out, int batch, int nq, int nu,
                                    int h, double beta, void* stream) {
  if (batch < 0 || !structure_kkt::holds(nq, nu, h, elem_bytes)) return -1;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return structure_kkt::dispatch<float>(in, out, batch, nq, nu, h, beta, s);
  return structure_kkt::dispatch<double>(in, out, batch, nq, nu, h, beta, s);
}
