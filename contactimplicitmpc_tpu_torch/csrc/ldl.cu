// The direct-mode Newton's KKT solve on NVIDIA Hopper (sm_90a): the
// unpivoted LDL^T solve of ops/linsolve.py::ldl_solve for a batch of
// symmetric quasidefinite matrices and one right-hand side each, in one
// launch, a thread-block cluster a matrix.
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
// difference rounded on its own (__fmul_rn/__fsub_rn, no contraction into a
// fused multiply-add). So L and d equal the plain version's bit for bit; the
// substitutions sum in their own order, and agree to rounding.
//
// What bounds it: n^3 / 3 operations a matrix (37 MFLOP at n = 480), and the
// factor's chain of n dependent column steps. The design:
//   - a thread-block cluster a matrix: kCluster CTAs, or 2 or 4 times as
//     many where kCluster do not hold it (cluster_size states the rule);
//     16 float32 matrices take 64 SMs in one wave (an H100 runs 30 such
//     clusters at once, and only 15 of 8). Row i belongs to CTA i mod C,
//     which keeps its lower-triangle entries and its right-hand side in its
//     shared memory for the whole solve;
//   - panels of kPanel columns. One warp of every CTA factors the panel's
//     diagonal block (pushed to every CTA by the rows' owners), a lane a
//     row in registers: a column step's column goes to shared memory and
//     comes back 16 bytes a load, __syncwarp only, no block barrier a
//     column. The forward substitution L y = b rides along as an extra
//     column;
//   - every row below the block is then eliminated on its own, a thread a
//     row running the panel's column steps in registers from the diagonal
//     block's c_jk and d: the same operations in the same order;
//   - every CTA pulls the other CTAs' rows of the panel from their compact
//     copies through distributed shared memory, 16 bytes a load, behind one
//     cluster barrier a panel;
//   - each CTA updates its rows of the trailing triangle out of its shared
//     memory, each entry's updates in the order of k, with look-ahead: the
//     next panel's columns first (a column a lane), then its rows of the
//     next diagonal block go to every CTA, behind a second cluster barrier,
//     and warp 0 factors that block while the warps of the other three
//     schedulers update the columns past it, a strip of kStripRows rows x
//     kStripCols columns a warp (4 columns a lane, its loads contiguous, 16
//     bytes a lane);
//   - the factor goes to the scratch once, at the end (L below the
//     diagonal, d on it: ldl_factors reads them), and L^T x = y runs across
//     the cluster a block of kPanel rows at a time: each CTA keeps partial
//     sums of its rows' terms, the block's CTA (block mod C, which kept the
//     block's factor) gathers them, solves the block by shuffles and pushes
//     x back.
// With -DKKT_PHASE_CLOCKS thread 0 of CTA 0 of cluster 0 clocks the phases
// below (kkt_clocks.cuh).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "kkt_clocks.cuh"

namespace cg = cooperative_groups;

namespace ldl {

constexpr int kThreads = 512;          // a CTA's threads
constexpr int kWarps = kThreads / 32;
constexpr int kRowWarps = kWarps - kWarps / 4;   // the warps past warp 0's scheduler (warp % 4 != 0)
constexpr int kPanel = 32;             // columns a panel: one warp's diagonal block
constexpr int kLd = kPanel + 1;        // a diagonal-block row: kPanel entries and the right-hand side
constexpr int kCluster = 4;            // CTAs a matrix: kCluster, 2 kCluster or 4 kCluster
constexpr int kStripRows = 8;          // a warp's strip of the trailing update: kStripRows of
constexpr int kStripCols = 128;        //   its CTA's rows x kStripCols columns, 4 a lane
constexpr int kTileCols = 8;           // the panel copy's rows come in runs of kTileCols
constexpr int kMaxN = 480;
constexpr int kSharedLimit = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// The clocked build's phases (ops/ldl.py::PHASES has their names): the rows'
// load and the first diagonal block's push; a panel's diagonal-block
// factor, its row eliminations, its exchange (push and cluster barrier) and
// the trailing update with the next diagonal block's push and barrier; the
// factor's write to the scratch; the backward substitution.
enum Phase { kLoad, kDiagFactor, kRowElim, kPanelExchange, kTrailingUpdate, kDiagPush,
             kWriteOut, kSolves, kPhases };
static_assert(kPhases <= kKktClockSlots, "a slot a phase");

// A CTA's rows of an n x n matrix on a cluster of c: rows rank + c li.
__host__ __device__ constexpr int rows_a_cta(int n, int c) { return (n + c - 1) / c; }
// Where row li starts in its CTA's row store: row li holds c li + c + 4
// values (its entries 0..i and its right-hand side, i + 2 <= c li + c + 1),
// so that every row starts 16-byte aligned for c a multiple of 4.
__host__ __device__ constexpr int row_offset(int li, int c) { return li * (c + 4) + c * li * (li - 1) / 2; }
// The panel copy's row length: rows 0..n-1 of a column, 16-byte aligned
// runs of kTileCols.
__host__ __device__ constexpr int panel_ld(int n) { return (n + kTileCols - 1) / kTileCols * kTileCols; }
// The CTA's own panel columns' row length: its rows, in 16-byte runs.
__host__ __device__ constexpr int mine_ld(int n, int c) { return (rows_a_cta(n, c) + 3) / 4 * 4; }
// The diagonal blocks a CTA keeps for the backward substitution.
__host__ __device__ constexpr int saved_blocks(int n, int c) { return ((n + kPanel - 1) / kPanel + c - 1) / c; }

// The values a CTA keeps in shared memory for an n x n matrix on a cluster
// of c: the panel copy, its own rows' panel columns (which the other CTAs
// pull), its rows, the diagonal block pushed in and factored, its saved
// diagonal blocks, d, x and the backward partial sums (ops/ldl.py::
// shared_bytes mirrors it).
__host__ __device__ constexpr int shared_values(int n, int c) {
  return kPanel * panel_ld(n) + kPanel * mine_ld(n, c) + row_offset(rows_a_cta(n, c), c) + 2 * kPanel * kLd + saved_blocks(n, c) * kPanel * kLd + 3 * n;
}

// The cluster's size for an n x n matrix of elem_bytes-byte values: the
// smallest of kCluster, 2 kCluster and 4 kCluster CTAs whose shared memory
// holds it (ops/ldl.py::cluster_size mirrors it). An H100 runs 30 clusters
// of 4 such CTAs at once, 15 of 8 and 7 of 16 (cudaOccupancyMaxActiveClusters):
// 16 matrices in one wave of 64 SMs in float32 at every n <= kMaxN.
__host__ __device__ constexpr int cluster_size(int n, int elem_bytes) {
  return elem_bytes * shared_values(n, kCluster) <= kSharedLimit ? kCluster : elem_bytes * shared_values(n, 2 * kCluster) <= kSharedLimit ? 2 * kCluster : 4 * kCluster;
}

__device__ inline double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ inline float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ inline double add(double a, double b) { return __dadd_rn(a, b); }
__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }
__device__ inline double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ inline float div(float a, float b) { return __fdiv_rn(a, b); }

template <class T>
__device__ inline T boost_pivot(T v, T boost) {
  const T sign = v >= T(0) ? T(1) : T(-1);
  return fabs(v) < boost ? sign * boost : v;
}

// kTileCols consecutive values from 16-byte aligned shared memory.
__device__ inline void load_run(const float* p, float* out) {
#pragma unroll
  for (int q = 0; q < kTileCols / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    out[4 * q] = v.x; out[4 * q + 1] = v.y; out[4 * q + 2] = v.z; out[4 * q + 3] = v.w;
  }
}
__device__ inline void load_run(const double* p, double* out) {
#pragma unroll
  for (int q = 0; q < kTileCols / 2; ++q) {
    const double2 v = reinterpret_cast<const double2*>(p)[q];
    out[2 * q] = v.x; out[2 * q + 1] = v.y;
  }
}

// 16 bytes from another CTA's shared memory.
__device__ inline void pull_run(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ inline void pull_run(const double* p, double* out) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  out[0] = v.x; out[1] = v.y;
}

// A column of the factored block, kPanel values 16 bytes a load.
template <class T>
__device__ inline void load_column(const T* p, T* out) {
#pragma unroll
  for (int j = 0; j < kPanel; j += kTileCols) load_run(p + j, out + j);
}

// A CTA's shared memory, carved in shared_values' order.
template <class T>
struct Smem {
  T *pan;    // kPanel x panel_ld(n): the panel's column k of row i at pan[k * ld + i]
  T *mine;   // kPanel x mine_ld(n, c): column k of the CTA's row li at mine[k * mld + li]
  T *rows;   // the CTA's rows: row li at row_offset(li, c), entries 0..i, then r_i
  T *din;    // the diagonal block pushed in: row l's kPanel entries, then r
  T *col;    // the factored block's columns: c_jk (j > k) at col[k * kPanel + j - k - 1]
  T *fy;     // the factored block's y
  T *save;   // the factored blocks b = rank, rank + c, ...
  T *d, *x, *acc;
  __device__ Smem(T* s, int n, int c) {
    pan = s;
    mine = pan + kPanel * panel_ld(n);
    rows = mine + kPanel * mine_ld(n, c);
    din = rows + row_offset(rows_a_cta(n, c), c);
    col = din + kPanel * kLd;
    fy = col + kPanel * kPanel;
    save = fy + kPanel;
    d = save + saved_blocks(n, c) * kPanel * kLd;
    x = d + n;
    acc = x + n;
  }
};

// The first of a CTA's rows li with rank + c li >= i0.
__device__ inline int first_row(int i0, int rank, int c) {
  return i0 <= rank ? 0 : (i0 - rank + c - 1) / c;
}

// The CTA's rows of the diagonal block [q0, q0 + kPanel), entries q0..i and
// the right-hand side, to every CTA's din (the CTA's threads).
template <class T>
__device__ void push_diag(const Smem<T>& s, cg::cluster_group& cluster, int q0, int n,
                          int c, int rank, int tid) {
  const int l0 = first_row(q0, rank, c), l1 = first_row(min(q0 + kPanel, n), rank, c);
  const int count = (l1 - l0) * kLd;
  for (int e = tid; e < c * count; e += kThreads) {
    const int q = e / count, f = e % count, li = l0 + f / kLd, j = f % kLd;
    const int i = rank + c * li, l = i - q0;
    if (j != kPanel && j > l) continue;
    const T v = s.rows[row_offset(li, c) + (j == kPanel ? i + 1 : q0 + j)];
    cluster.map_shared_rank(s.din, q)[l * kLd + j] = v;
  }
}

// The diagonal block of [p0, p0 + pb) by one warp, a lane a row in
// registers shifted a column a step (so that v[0] is always the step's
// column): its column steps, the forward substitution of its rows, d. A
// step's column c_jk goes to col, and every lane reads it back 16 bytes a
// load; an entry above a lane's diagonal or past the block takes updates
// too, and is never read. The result: col, fy and d, the CTA's rows and, for
// the CTA's saved blocks, save.
template <class T>
__device__ void factor_diag(const Smem<T>& s, int p0, int pb, int c, int rank, T boost,
                            int lane) {
  const bool live = lane < pb;
  const int i = p0 + lane;
  T* own = live && i % c == rank ? s.rows + row_offset(i / c, c) : nullptr;
  const int blk = p0 / kPanel;
  T* kept = live && blk % c == rank ? s.save + blk / c * kPanel * kLd : nullptr;
  T v[kPanel];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) v[j] = live && j <= lane ? s.din[lane * kLd + j] : T(0);
  T y = live ? s.din[lane * kLd + kPanel] : T(0);
  T mine = T(1);
#pragma unroll 2
  for (int k = 0; k < pb; ++k) {
    const T piv = boost_pivot(__shfl_sync(kFull, v[0], k), boost);
    const bool below = lane > k;
    const T ck = below ? div(v[0], piv) : v[0];
    const T t = mul(piv, ck);
    const T yk = __shfl_sync(kFull, y, k);
    if (lane == k) mine = piv;
    if (below) {
      y = sub(y, mul(ck, yk));
      s.col[k * kPanel + lane - k - 1] = ck;
      if (own) own[p0 + k] = ck;
      if (kept) kept[lane * kLd + k] = ck;
    }
    __syncwarp();
    T cj[kPanel];
    load_column(s.col + k * kPanel, cj);
#pragma unroll
    for (int jj = 1; jj < kPanel; ++jj) v[jj - 1] = sub(v[jj], mul(t, cj[jj - 1]));
    v[kPanel - 1] = T(0);
  }
  if (!live) return;
  s.fy[lane] = y;
  s.d[i] = mine;
  if (own) {
    own[i] = mine;
    own[i + 1] = y;
  }
}

// Row i = rank + c li below the diagonal block: the panel's pb column steps
// in registers shifted a column a step, from the factored block's columns
// (16 bytes a load), d and y; an entry past the panel takes updates too, and
// is never read. The result to the CTA's row, its panel copy and its own
// panel columns.
template <class T>
__device__ void eliminate_row(const Smem<T>& s, int li, int p0, int pb, int c, int rank,
                              int ld, int mld) {
  const int i = rank + c * li;
  T* row = s.rows + row_offset(li, c);
  T v[kPanel];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) v[j] = j < pb ? row[p0 + j] : T(0);
  T r = row[i + 1];
#pragma unroll 2
  for (int k = 0; k < pb; ++k) {
    const T piv = s.d[p0 + k];
    const T ck = div(v[0], piv);
    const T t = mul(piv, ck);
    r = sub(r, mul(ck, s.fy[k]));
    T cj[kPanel];
    load_column(s.col + k * kPanel, cj);
#pragma unroll
    for (int jj = 1; jj < kPanel; ++jj) v[jj - 1] = sub(v[jj], mul(t, cj[jj - 1]));
    v[kPanel - 1] = T(0);
    row[p0 + k] = ck;
    s.pan[k * ld + i] = ck;
    s.mine[k * mld + li] = ck;
  }
  row[i + 1] = r;
}

// 4 consecutive values of 16-byte aligned shared memory.
__device__ inline void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ inline void load4(const double* p, double* out) {
  const double2 a = reinterpret_cast<const double2*>(p)[0], b = reinterpret_cast<const double2*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ inline void store4(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ inline void store4(double* p, const double* in) {
  reinterpret_cast<double2*>(p)[0] = make_double2(in[0], in[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(in[2], in[3]);
}

// A warp's strip of the next panel's columns: the CTA's rows lf .. lf +
// kStripRows - 1 (those from l0 to ll taken) and column j a lane (where
// `on`) take the panel's pb updates in the order of k.
template <class T>
__device__ void update_next(const Smem<T>& s, int lf, int l0, int ll, int j, bool on, int p0,
                            int pb, int c, int rank, int ld, int mld) {
  T acc[kStripRows];
  T* rp[kStripRows];
  int iu[kStripRows];
#pragma unroll
  for (int u = 0; u < kStripRows; ++u) {
    const int li = min(lf + u, ll);
    iu[u] = !on || lf + u < l0 || lf + u > ll ? -1 : rank + c * li;   // -1: not the strip's
    rp[u] = s.rows + row_offset(li, c);
    acc[u] = rp[u][j];   // past a row's end: another value, never stored
  }
#pragma unroll 2
  for (int k = 0; k < pb; ++k) {
    const T dk = s.d[p0 + k];
    T av[kStripRows];
    load4(s.mine + k * mld + lf, av);
    load4(s.mine + k * mld + lf + 4, av + 4);
    const T b = s.pan[k * ld + j];
#pragma unroll
    for (int u = 0; u < kStripRows; ++u) acc[u] = sub(acc[u], mul(mul(dk, av[u]), b));
  }
#pragma unroll
  for (int u = 0; u < kStripRows; ++u)
    if (j <= iu[u]) rp[u][j] = acc[u];
}

// A warp's strip: the CTA's rows lf .. lf + kStripRows - 1 (those from l0 to
// ll taken) and columns j0 .. j0 + 3 a lane (j0 = the strip's first + 4
// lane) take the panel's pb updates in the order of k. A k's row factors
// come from the CTA's own panel columns and its columns from the panel copy,
// 16 bytes a load, a warp's loads contiguous.
template <class T>
__device__ void update_strip(const Smem<T>& s, int lf, int l0, int ll, int j0, int p0, int pb,
                             int c, int rank, int ld, int mld) {
  T acc[kStripRows][4];
  T* rp[kStripRows];
  int iu[kStripRows];
#pragma unroll
  for (int u = 0; u < kStripRows; ++u) {
    const int li = min(lf + u, ll);
    iu[u] = lf + u < l0 || lf + u > ll ? -1 : rank + c * li;   // -1: not the strip's
    rp[u] = s.rows + row_offset(li, c);
    load4(rp[u] + j0, acc[u]);   // past a row's end: other values, never stored
  }
#pragma unroll 2
  for (int k = 0; k < pb; ++k) {
    const T dk = s.d[p0 + k];
    T av[kStripRows], bv[4];
    load4(s.mine + k * mld + lf, av);
    load4(s.mine + k * mld + lf + 4, av + 4);
    load4(s.pan + k * ld + j0, bv);
#pragma unroll
    for (int u = 0; u < kStripRows; ++u) {
      const T a = mul(dk, av[u]);
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = sub(acc[u][v], mul(a, bv[v]));
    }
  }
#pragma unroll
  for (int u = 0; u < kStripRows; ++u) {
    if (j0 + 3 <= iu[u]) {
      store4(rp[u] + j0, acc[u]);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (j0 + v <= iu[u]) rp[u][j0 + v] = acc[u][v];
    }
  }
}

// The panel [p0, p0 + kPanel)'s trailing update past the next panel: the
// CTA's rows and columns from p0 + 2 kPanel on, in strips of kStripRows rows
// (aligned in the CTA's rows) and kStripCols columns, a strip a warp (w of
// the kRowWarps past warp 0's scheduler).
template <class T>
__device__ void update_rest(const Smem<T>& s, int p0, int c, int rank, int rows, int ld,
                            int mld, int w, int lane) {
  const int r0 = p0 + 2 * kPanel, l1 = first_row(r0, rank, c);
  int base = 0;
  for (int lf = l1 / kStripRows * kStripRows; lf < rows; lf += kStripRows) {
    const int ll = min(lf + kStripRows - 1, rows - 1);
    if (rank + c * ll < r0) continue;
    const int strips = (rank + c * ll - r0) / kStripCols + 1;
    for (int t = base + ((w - base) % kRowWarps + kRowWarps) % kRowWarps; t < base + strips;
         t += kRowWarps)
      update_strip(s, lf, l1, ll, r0 + kStripCols * (t - base) + 4 * lane, p0, kPanel, c, rank,
                   ld, mld);
    base += strips;
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
ldl_kernel(const T* a_all, const T* b_all, T* x_all, T* w_all, int n, T boost) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t mat = blockIdx.x / c;
  const Smem<T> s(reinterpret_cast<T*>(smem_raw), n, c);
  const T* a = a_all + mat * n * n;
  const T* b = b_all + mat * n;
  T* x_out = x_all + mat * n;
  T* w = w_all + mat * n * n;
  const int rows = (n - rank + c - 1) / c;   // this CTA's rows: rank + c li, li < rows
  const int ld = panel_ld(n), mld = mine_ld(n, c);

  PhaseClock clk(blockIdx.x == 0 && tid == 0);
  cluster.sync();   // every CTA runs before one reaches another's shared memory
  for (int li = warp; li < rows; li += kWarps) {
    const int i = rank + c * li;
    T* row = s.rows + row_offset(li, c);
    for (int j = lane; j <= i; j += 32) row[j] = a[size_t(i) * n + j];
    if (lane == 0) row[i + 1] = b[i];
  }
  __syncthreads();
  push_diag(s, cluster, 0, n, c, rank, tid);
  cluster.sync();
  clk.mark(kLoad);

  if (warp == 0) factor_diag(s, 0, min(kPanel, n), c, rank, boost, lane);
  __syncthreads();
  clk.mark(kDiagFactor);

  for (int p0 = 0; p0 < n; p0 += kPanel) {
    const int pb = min(kPanel, n - p0), q0 = p0 + pb;
    const int l0 = first_row(q0, rank, c);
    for (int li = l0 + tid; li < rows; li += kThreads)
      eliminate_row(s, li, p0, pb, c, rank, ld, mld);
    cluster.sync();   // every CTA's rows of the panel
    clk.mark(kRowElim);

    // ---- the other CTAs' rows of the panel into the copy, pulled 16 bytes
    // a load from their own panel columns ----
    constexpr int vec = 16 / int(sizeof(T));
    for (int qq = 1; qq < c; ++qq) {
      const int q = (rank + qq) % c;
      const int lq = first_row(q0, q, c) / vec * vec, runs = ((n - q + c - 1) / c - lq + vec - 1) / vec;
      const T* src = cluster.map_shared_rank(s.mine, q);
      for (int e = tid; e < pb * runs; e += kThreads) {
        const int k = e / runs, l = lq + vec * (e % runs);
        T got[vec];
        pull_run(src + k * mld + l, got);
#pragma unroll
        for (int v = 0; v < vec; ++v) {
          const int i = q + c * (l + v);
          if (i >= q0 && i < n) s.pan[k * ld + i] = got[v];
        }
      }
    }
    __syncthreads();
    clk.mark(kPanelExchange);
    if (q0 >= n) break;

    // ---- the trailing triangle, the CTA's rows >= q0 and columns q0..i:
    // first the next panel's columns, a strip of kStripRows rows a warp and
    // a column a lane; the next diagonal block pushed ----
    const int nb = min(kPanel, n - q0);
    for (int lf = l0 / kStripRows * kStripRows + kStripRows * warp; lf < rows;
         lf += kStripRows * kWarps)
      update_next(s, lf, l0, min(lf + kStripRows - 1, rows - 1), q0 + lane, lane < nb, p0, pb,
                  c, rank, ld, mld);
    __syncthreads();
    clk.mark(kTrailingUpdate);
    push_diag(s, cluster, q0, n, c, rank, tid);
    cluster.sync();
    clk.mark(kDiagPush);

    // ---- then the next diagonal block by warp 0, while the warps of the
    // other three schedulers (warp % 4 != 0) update the columns past it in
    // strips of kStripRows rows (aligned in the CTA's rows) and kStripCols
    // columns, a strip a warp ----
    if (warp == 0) {
      factor_diag(s, q0, nb, c, rank, boost, lane);
      clk.mark(kDiagFactor);
    } else if (warp % 4 != 0) {
      update_rest(s, p0, c, rank, rows, ld, mld, warp - 1 - warp / 4, lane);
    }
    __syncthreads();
    clk.mark(kTrailingUpdate);
  }

  // ---- the factor to the scratch: L below the diagonal, d on it; the
  // backward substitution's start, y / d on the CTA's rows ----
  for (int li = warp; li < rows; li += kWarps) {
    const int i = rank + c * li;
    const T* row = s.rows + row_offset(li, c);
    for (int j = lane; j <= i; j += 32) w[size_t(i) * n + j] = row[j];
  }
  for (int j = tid; j < n; j += kThreads) {
    T v = T(0);
    if (j % c == rank) {
      const T* row = s.rows + row_offset(j / c, c);
      v = div(row[j + 1], boost_pivot(row[j], boost));
    }
    s.acc[j] = v;
  }
  clk.sync_mark(kWriteOut);

  // ---- L^T x = y / d, a block of kPanel rows at a time from the last ----
  const int blocks = (n + kPanel - 1) / kPanel;
  for (int blk = blocks - 1; blk >= 0; --blk) {
    const int p0 = blk * kPanel, pb = min(kPanel, n - p0);
    cluster.sync();   // every CTA's partial sums of the block
    if (blk % c == rank && warp == 0) {
      const T* kept = s.save + blk / c * kPanel * kLd;
      T v = T(0);
      if (lane < pb)
        for (int q = 0; q < c; ++q) v = add(v, cluster.map_shared_rank(s.acc, q)[p0 + lane]);
#pragma unroll
      for (int k = kPanel - 1; k >= 0; --k) {
        if (k < pb) {
          const T xk = __shfl_sync(kFull, v, k);
          if (lane < k) v = sub(v, mul(kept[k * kLd + lane], xk));
        }
      }
      if (lane < pb) {
        for (int q = 0; q < c; ++q) cluster.map_shared_rank(s.x, q)[p0 + lane] = v;
        x_out[p0 + lane] = v;
      }
    }
    cluster.sync();   // the block's x in every CTA
    if (blk > 0) {
      const int l0 = first_row(p0, rank, c), l1 = first_row(p0 + pb, rank, c);
      for (int j = tid; j < p0; j += kThreads) {
        T v = s.acc[j];
        for (int li = l0; li < l1; ++li)
          v = sub(v, mul(s.rows[row_offset(li, c) + j], s.x[rank + c * li]));
        s.acc[j] = v;
      }
    }
  }
  clk.mark(kSolves);
}

// ---- host side ---------------------------------------------------------------

template <class T>
int configure(int n, int* c, int* bytes) {
  *c = cluster_size(n, int(sizeof(T)));
  *bytes = int(sizeof(T)) * shared_values(n, *c);
  if (*bytes > kSharedLimit) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      ldl_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (err == cudaSuccess && *c > 8)
    err = cudaFuncSetAttribute(ldl_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return int(err);
}

template <class T>
int launch(const void* a, const void* b, void* x, void* work, int batch, int n,
           double boost, cudaStream_t stream, int* active) {
  int c, bytes;
  const int err = configure<T>(n, &c, &bytes);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active) return int(cudaOccupancyMaxActiveClusters(active, ldl_kernel<T>, &cfg));
  cudaError_t e = cudaLaunchKernelEx(&cfg, ldl_kernel<T>, static_cast<const T*>(a),
                                     static_cast<const T*>(b), static_cast<T*>(x),
                                     static_cast<T*>(work), n, T(boost));
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

}  // namespace ldl

// The geometry of an n x n matrix in elem_bytes-byte values: out[0] the
// cluster's CTAs, out[1] a CTA's shared bytes, out[2] its threads, out[3]
// its rows. 0, or -1 for an n or a type the source does not hold.
extern "C" int ldl_geometry(int elem_bytes, int n, int* out) {
  if (n < 1 || n > ldl::kMaxN || (elem_bytes != 4 && elem_bytes != 8)) return -1;
  const int c = ldl::cluster_size(n, elem_bytes);
  out[0] = c;
  out[1] = elem_bytes * ldl::shared_values(n, c);
  out[2] = ldl::kThreads;
  out[3] = ldl::rows_a_cta(n, c);
  return 0;
}

// How many clusters of an n x n matrix's geometry the card runs at once
// (cudaOccupancyMaxActiveClusters) into *active; 0, a CUDA error code, or
// -1 for an n or a type the source does not hold.
extern "C" int ldl_max_active_clusters(int elem_bytes, int n, int* active) {
  if (n < 1 || n > ldl::kMaxN) return -1;
  if (elem_bytes == 4)
    return ldl::launch<float>(nullptr, nullptr, nullptr, nullptr, 1, n, 0.0, 0, active);
  if (elem_bytes == 8)
    return ldl::launch<double>(nullptr, nullptr, nullptr, nullptr, 1, n, 0.0, 0, active);
  return -1;
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
  if (elem_bytes == 4) return ldl::launch<float>(a, b, x, work, batch, n, boost, s, nullptr);
  if (elem_bytes == 8) return ldl::launch<double>(a, b, x, work, batch, n, boost, s, nullptr);
  return -1;
}
