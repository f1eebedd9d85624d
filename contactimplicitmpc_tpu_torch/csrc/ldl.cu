// The direct-mode Newton's KKT solve on NVIDIA Hopper (sm_90a): the
// unpivoted LDL^T solve of ops/linsolve.py::ldl_solve for a batch of
// symmetric quasidefinite matrices and one right-hand side each, in one
// launch, a block of kThreads threads a matrix.
//
// Counterpart of the JAX package's ldl_solve (contactimplicitmpc_tpu/ops/
// linsolve.py) with its fori_loop ldl_factor, which XLA compiles into one
// program. The plain PyTorch version runs the factor's n dependent rank-1
// updates as Python steps: thousands of launches a solve at the direct
// paths' n = 100 to 480.
//
// Semantics, exactly the plain version's: no pivoting; each pivot floored in
// magnitude at `boost` (the dtype's tiny when the caller asks for none) with
// its sign kept (_boost_pivot); d carries the floored pivot that scaled L's
// column; then L y = b (unit diagonal), y / d, and L^T x = y. Only the lower
// triangle of the input is read, as the plain version's steps read it.
//
// The factor's arithmetic is the plain version's, operation for operation:
// column k is c_i = w_ik / d_k, and each entry of the trailing lower
// triangle takes w_ij - (d_k c_i) c_j in the order of k, every product and
// difference rounded on its own (__dmul_rn/__dsub_rn, no contraction into a
// fused multiply-add). So L and d equal the plain version's bit for bit; the
// substitutions sum in their own order, and agree to rounding.
//
// What bounds it: n^3 / 3 operations a matrix (37 MFLOP at n = 480) on one
// SM, and the factor's chain of n dependent column steps. The design is
// blocked and right-looking:
//   - the working lower triangle lives in a scratch the wrapper allocates
//     (the batch's 16 x 480^2 float32 values stay in the 50 MB L2);
//   - a panel of kPanel columns is factored in shared memory, two barriers a
//     column (scale the column; a thread a row updates the panel's later
//     columns);
//   - the trailing lower triangle then takes the panel's kPanel updates in
//     one pass, a kTile x kTile register tile a thread: each entry is read
//     and written once a panel, and updated in the order of k;
//   - L's columns go back to the scratch below the diagonal and, transposed,
//     above it, so that both substitutions read rows, coalesced; they run a
//     block of 32 at a time, one warp solving the diagonal block by shuffles
//     from a copy in shared memory (staged while the block updates the rest
//     with the block before).
// Sixteen matrices fill 16 of the card's 132 SMs. The scratch ends holding
// the factor: L below the diagonal, d on it (ldl_factors reads them). With
// -DKKT_PHASE_CLOCKS block 0 clocks the phases below (kkt_clocks.cuh).

#include <cuda_runtime.h>

#include "kkt_clocks.cuh"

namespace ldl {

constexpr int kThreads = 512;          // a block a matrix
constexpr int kPanel = 32;             // columns a panel
constexpr int kLd = kPanel + 1;        // a panel row's stride in shared memory
constexpr int kTile = 4;               // a thread's register tile, kTile x kTile
constexpr int kMaxN = 768;
constexpr int kSharedLimit = 227 * 1024;

// The clocked build's phases (ops/ldl.py::PHASES has their names): a panel's
// load with the trailing update before it, its factorization, its write-back
// (a barrier before the trailing update in the clocked build only), the
// forward and the backward substitution.
enum Phase { kTrailingAndLoad, kPanelFactor, kWriteBack, kForward, kBackward, kPhases };
static_assert(kPhases <= kKktClockSlots, "a slot a phase");

// The values a block keeps in shared memory for an n x n matrix: the panel
// (n rows), d and the right-hand side (ops/ldl.py::shared_bytes mirrors it).
__host__ __device__ constexpr int shared_values(int n) { return n * kLd + 2 * n; }

// A panel entry's place in shared memory.
__device__ inline int at(int r, int c) { return r * kLd + c; }

__device__ inline double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ inline float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ inline double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ inline float div(float a, float b) { return __fdiv_rn(a, b); }

template <class T>
__device__ inline T boost_pivot(T v, T boost) {
  const T sign = v >= T(0) ? T(1) : T(-1);
  return fabs(v) < boost ? sign * boost : v;
}

// The scratch's diagonal block of rows and columns [q0, q0 + qb) to the
// tile (qb x kLd): L's entries below its diagonal, their transposes above.
template <class T>
__device__ inline void stage_tile(T* tile, const T* w, int n, int q0, int qb, int tid) {
  for (int e = tid; e < qb * qb; e += kThreads) {
    const int k = e / qb, l = e % qb;
    tile[at(k, l)] = w[size_t(q0 + k) * n + q0 + l];
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
ldl_kernel(const T* a_all, const T* b_all, T* x_all, T* w_all, int n, T boost) {
  extern __shared__ double smem_raw[];
  T* pan = reinterpret_cast<T*>(smem_raw);   // n x kLd: the panel's rows p0..n-1
  T* d = pan + n * kLd;
  T* r = d + n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = size_t(blockIdx.x) * n * n;
  const T* a = a_all + off;
  T* w = w_all + off;

  PhaseClock clk(blockIdx.x == 0 && threadIdx.x == 0);
  for (int p0 = 0; p0 < n; p0 += kPanel) {
    const int pb = min(kPanel, n - p0), rows = n - p0;
    const T* src = p0 == 0 ? a : w;
    for (int e = tid; e < rows * pb; e += kThreads) {
      const int i = p0 + e / pb, j = e % pb;
      if (p0 + j <= i) pan[at(i - p0, j)] = src[size_t(i) * n + p0 + j];
    }
    __syncthreads();
    clk.mark(kTrailingAndLoad);

    // ---- factor the panel ----
    for (int k = 0; k < pb; ++k) {
      const int kk = p0 + k;
      const T piv = boost_pivot(pan[at(k, k)], boost);
      for (int i = kk + 1 + tid; i < n; i += kThreads)
        pan[at(i - p0, k)] = div(pan[at(i - p0, k)], piv);
      if (tid == 0) d[kk] = w[size_t(kk) * n + kk] = piv;
      __syncthreads();
      if (k + 1 < pb) {   // the panel's later columns, a thread a row
        for (int i = kk + 1 + tid; i < n; i += kThreads) {
          T* row = &pan[at(i - p0, 0)];
          const T ti = mul(piv, row[k]);
          const int last = min(pb - 1, i - p0);
          for (int j = k + 1; j <= last; ++j) row[j] = sub(row[j], mul(ti, pan[at(j, k)]));
        }
        __syncthreads();
      }
    }

    clk.mark(kPanelFactor);

    // ---- L's panel columns to the scratch: below the diagonal, and
    // transposed above it ----
    for (int e = tid; e < rows * pb; e += kThreads) {
      const int i = p0 + e / pb, j = e % pb;
      if (p0 + j < i) w[size_t(i) * n + p0 + j] = pan[at(i - p0, j)];
    }
    for (int e = tid; e < rows * pb; e += kThreads) {
      const int j = e / rows, i = p0 + e % rows;
      if (p0 + j < i) w[size_t(p0 + j) * n + i] = pan[at(i - p0, j)];
    }

    clk.sync_mark(kWriteBack);

    // ---- the trailing lower triangle takes the panel's updates ----
    const int q0 = p0 + pb, m = n - q0;
    if (m > 0) {
      const int nt = (m + kTile - 1) / kTile, tiles = nt * (nt + 1) / 2;
      for (int t = tid; t < tiles; t += kThreads) {
        int bi = int((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
        while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
        while (bi * (bi + 1) / 2 > t) --bi;
        const int bj = t - bi * (bi + 1) / 2;
        const int i0 = q0 + kTile * bi, j0 = q0 + kTile * bj;
        int ri[kTile], cj[kTile];   // the rows' panel indices
        T acc[kTile][kTile];
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
          ri[u] = min(i0 + u, n - 1) - p0;
          cj[u] = min(j0 + u, n - 1) - p0;
        }
#pragma unroll
        for (int u = 0; u < kTile; ++u)
#pragma unroll
          for (int v = 0; v < kTile; ++v) {
            const int i = i0 + u, j = j0 + v;
            acc[u][v] = (i < n && j <= i) ? src[size_t(i) * n + j] : T(0);
          }
        for (int k = 0; k < pb; ++k) {
          const T piv = d[p0 + k];
          T av[kTile], bv[kTile];
#pragma unroll
          for (int u = 0; u < kTile; ++u) {
            av[u] = mul(piv, pan[at(ri[u], k)]);
            bv[u] = pan[at(cj[u], k)];
          }
#pragma unroll
          for (int u = 0; u < kTile; ++u)
#pragma unroll
            for (int v = 0; v < kTile; ++v) acc[u][v] = sub(acc[u][v], mul(av[u], bv[v]));
        }
#pragma unroll
        for (int u = 0; u < kTile; ++u)
#pragma unroll
          for (int v = 0; v < kTile; ++v) {
            const int i = i0 + u, j = j0 + v;
            if (i < n && j <= i) w[size_t(i) * n + j] = acc[u][v];
          }
      }
    }
    __syncthreads();
  }

  clk.mark(kTrailingAndLoad);

  // ---- L y = b: a block of 32 rows at a time, the diagonal block staged in
  // shared memory (the panel's), L's rows below it read transposed ----
  T* tile = pan;
  const T* b = b_all + size_t(blockIdx.x) * n;
  for (int i = tid; i < n; i += kThreads) r[i] = b[i];
  stage_tile(tile, w, n, 0, min(32, n), tid);
  __syncthreads();
  for (int p0 = 0; p0 < n; p0 += 32) {
    const int pb = min(32, n - p0);
    if (warp == 0) {
      T v = lane < pb ? r[p0 + lane] : T(0);
      for (int k = 0; k < pb; ++k) {
        const T yk = __shfl_sync(0xffffffffu, v, k);
        if (lane > k && lane < pb) v = sub(v, mul(tile[at(k, lane)], yk));
      }
      if (lane < pb) r[p0 + lane] = v;
    }
    __syncthreads();
    for (int i = p0 + pb + tid; i < n; i += kThreads) {
      T v = r[i];
#pragma unroll 8
      for (int k = 0; k < pb; ++k) v = sub(v, mul(w[size_t(p0 + k) * n + i], r[p0 + k]));
      r[i] = v;
    }
    if (p0 + pb < n) stage_tile(tile, w, n, p0 + pb, min(32, n - p0 - pb), tid);
    __syncthreads();
  }
  for (int i = tid; i < n; i += kThreads) r[i] = div(r[i], boost_pivot(d[i], boost));
  stage_tile(tile, w, n, max(0, n - 32), n - max(0, n - 32), tid);
  __syncthreads();

  clk.mark(kForward);

  // ---- L^T x = y: from the last block of 32 up, L's rows read as stored ----
  for (int p1 = n; p1 > 0; p1 -= 32) {
    const int p0 = max(0, p1 - 32), pb = p1 - p0;
    if (warp == 0) {
      T v = lane < pb ? r[p0 + lane] : T(0);
      for (int k = pb - 1; k >= 0; --k) {
        const T xk = __shfl_sync(0xffffffffu, v, k);
        if (lane < k) v = sub(v, mul(tile[at(k, lane)], xk));
      }
      if (lane < pb) r[p0 + lane] = v;
    }
    __syncthreads();
    for (int i = tid; i < p0; i += kThreads) {
      T v = r[i];
#pragma unroll 8
      for (int k = 0; k < pb; ++k) v = sub(v, mul(w[size_t(p0 + k) * n + i], r[p0 + k]));
      r[i] = v;
    }
    if (p0 > 0) stage_tile(tile, w, n, max(0, p0 - 32), p0 - max(0, p0 - 32), tid);
    __syncthreads();
  }
  T* x = x_all + size_t(blockIdx.x) * n;
  for (int i = tid; i < n; i += kThreads) x[i] = r[i];
  clk.sync_mark(kBackward);
}

// ---- host side ---------------------------------------------------------------

template <class T>
int launch(const void* a, const void* b, void* x, void* work, int batch, int n,
           double boost, cudaStream_t stream) {
  const int bytes = int(sizeof(T)) * shared_values(n);
  if (bytes > kSharedLimit) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      ldl_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  ldl_kernel<T><<<batch, kThreads, bytes, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x),
      static_cast<T*>(work), n, T(boost));
  return int(cudaGetLastError());
}

}  // namespace ldl

// The shared bytes a block of an n x n matrix in elem_bytes-byte values
// takes, or -1 for an n or a type the source does not hold.
extern "C" int ldl_shared_bytes(int elem_bytes, int n) {
  if (n < 1 || n > ldl::kMaxN || (elem_bytes != 4 && elem_bytes != 8)) return -1;
  return elem_bytes * ldl::shared_values(n);
}

// x = a^-1 b by the unpivoted LDL^T of each of batch matrices a (batch, n, n)
// with b and x (batch, n), in float32 (elem_bytes 4) or float64 (8), pivots
// floored at boost; work (batch, n, n) is the factor's scratch. 0 on
// success, a CUDA error code, or -1 for an n or a type the source does not
// hold.
extern "C" int ldl_launch(int elem_bytes, const void* a, const void* b, void* x,
                          void* work, int batch, int n, double boost, void* stream) {
  if (batch < 0 || n < 1 || n > ldl::kMaxN) return -1;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return ldl::launch<float>(a, b, x, work, batch, n, boost, s);
  if (elem_bytes == 8) return ldl::launch<double>(a, b, x, work, batch, n, boost, s);
  return -1;
}
