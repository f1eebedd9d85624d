// Batched fixed-iteration interior-point solve of pre-linearized knot
// subproblems, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel contactimplicitmpc_tpu/ops/pallas_ip.py::_ip_kernel
// and its wrapper linearized_ip_fixed_pallas, and carries the whole contract
// of contactimplicitmpc_tpu/ops/fixed_ip.py::linearized_ip_fixed (the plain
// version is contactimplicitmpc_tpu_torch/ops/fixed_ip.py): `iters` masked
// Mehrotra predictor-corrector iterations on the structured Schur path with
// the last-finite-iterate guard, the final residual, `converged`, `rvio`,
// `kvio`, and the sensitivity solve dz = -K_reg^-1 rtheta0 with refinement
// and zeroing of non-finite results. Every max/min propagates NaN as
// jnp.maximum/jnp.minimum do, and the line search picks as jnp.argmin does.
//
// What bounds it: operations, not bytes. For the quadruped (nx 11, ny 16,
// ntheta 34; 8 iterations, 1 refinement pass, 4 step lengths a direction) a
// problem needs ~0.48 Mflop of float32 arithmetic against ~6.2 KB of its
// own traffic (dz, 43 x 34, is 94% of it) plus ~13.7 KB once per knot:
// ~75 flop a byte, above the card's 20 flop a byte at 67 TFLOP/s and
// 3.35 TB/s. ops/knot_ip.py::work counts both for a call; the bound is
// ~0.007 ms at the main path's N = 1008 and ~0.115 ms at N = 16128. The
// products are 11 to 43 wide and must stay full float32 (TF32 loses the
// agreement with the plain version, and wgmma's 64-row tile does not fit a
// 16 x 16 system), so no tensor cores, and the bound is reckoned at the
// 67 TFLOP/s of the plain float32 pipes. What the kernel really fights is
// the length of one problem's chain of dependent small steps: at the main
// path's sizes every problem is resident at once and the time is one
// problem's latency. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py): 0.065 ms at N = 144, 0.084 ms at N = 1008 and 0.911 ms
// at N = 16128, which is 1.6%, 8.6% and 12.7% of the bound.
//
// Design:
// - Per-knot constants once. knot_pack_kernel (one block a knot) inverts Dx,
//   forms Rx Dx^-1, Dx^-1 Dy1 and Ry1 - Rx Dx^-1 Dy1, and lays them, the
//   equality rows of rz0, rtheta0, r0, z0 and theta0 out as one
//   16-byte-aligned block a knot (struct Lay) in scratch that the wrapper
//   allocates.
// - A block works on problems of one knot (problem n uses knot n % K). It
//   brings the knot's block into shared memory with 16-byte cp.async copies
//   while its warps load their own theta, q2 and alt; all warps share it.
//   A warp owns one problem, at every N, and ~4 KB of state. The warps of
//   a block are chosen at launch from N: 1 at the main path's sizes, so
//   that the problems spread over the SMs and schedulers, 8 from 2048
//   problems on. A thread is capped at 128 registers, so that 16 warps are
//   resident on an SM: that costs 2-5% at the main path's sizes, where no
//   cap would spill nothing, and saves 16% at N = 16128.
// - Rows are padded to float4, so that every matrix-vector product reads 16
//   bytes a lane without bank conflicts. Each sum keeps the plain version's
//   order of terms (see dot_ss).
// - The 16 x 16 Schur complement is inverted in registers: lane j holds
//   column j of [S | I], the pivot column travels by shuffle, no barrier.
//   The pivot row is scaled by one reciprocal: a division a lane would run
//   its slow path on the exact zeros of the identity half.
// - The corrector and centering solves run side by side on the two halves
//   of the warp, three barriers a Schur solve (Dx^-1 Dy1 is folded). The
//   equality rows of the merit are affine in the step length, so two
//   products (Rza d) replace one a candidate, and lane c evaluates
//   candidate c of the line search alone; ballots select.
// - Sensitivities: lane c solves column c (refinement included) out of
//   registers, the matrices read as broadcasts from shared memory, and
//   stores dz[i][c] beside its neighbours'. The columns past 32, where a
//   model has them, go through the side-by-side solve.
// - One instantiation for each set of dimensions of a model of the JAX
//   package, listed in KNOT_IP_MODELS below (the quadruped, the 2D hopper,
//   the flamingo, the 2D particle, the pushbot, the walled cartpole). The
//   template takes any dimensions that meet struct Lay's assertions (NY a
//   multiple of 4 and at most 16, NX <= NY, at most 32 equality rows, at
//   most 34 columns of theta); lanes past NY, 2 NY, NE, NV or NT idle.
// - Past those assertions (the 3D models: the centroidal quadruped's knot
//   has 42 equality rows, a 24 x 24 Schur complement and 53 columns of
//   theta; the 3D particle's and hopper's NY of 6 is no multiple of 4), a
//   second template, knot_ip_wide_kernel, gives a problem a block of 2 to 4
//   warps; its design is set out where it begins, and its models are listed
//   in KNOT_IP_WIDE_MODELS. At the centroidal dimensions (8 iterations, 1
//   refinement pass) a problem needs ~1.44 Mflop, 3.0x the quadruped's: the
//   bound is ~0.024 ms at N = 1120.
// These reorderings stay inside the float32 spread of two correct solves:
// after 1 and 3 iterations every problem agrees with the plain version to
// ~1e-5 in z (chip_smoke.py and tests/test_torch_cuda.py hold 1e-4).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;     // problems per block, at most
constexpr int kPackThreads = 128;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float pmax(float a, float b) {
  return (a != a || a > b) ? a : b;  // NaN-propagating, like jnp.maximum
}
__device__ __forceinline__ float pmin(float a, float b) {
  return (a != a || a < b) ? a : b;  // NaN-propagating, like jnp.minimum
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = pmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = pmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// tau y / dy where dy limits the step (dy > 0), else the largest float.
__device__ __forceinline__ float step_ratio(float tau, float y, float dy) {
  const bool pos = dy > 0.0f;
  const float q = tau * y / (pos ? dy : 1.0f);
  return pos ? q : FLT_MAX;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Dot product of two 16-byte-aligned shared-memory rows of N floats (N a
// multiple of 4; the padding of either holds zeros). One accumulator, the
// terms in order: with the plain version's order of summation the two
// solves stay together longer (after the main path's 8 iterations 94% of
// the problems still agree in dz; with 4 accumulators 92% did), and the
// rows and right-hand sides in flight hide the chain's latency anyway.
template <int N>
__device__ __forceinline__ float dot_ss(const float* a, const float* b) {
  static_assert(N % 4 == 0, "padded rows");
  float s0 = 0.0f;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(a)[q];
    const float4 y = reinterpret_cast<const float4*>(b)[q];
    s0 = fmaf(x.x, y.x, s0);
    s0 = fmaf(x.y, y.y, s0);
    s0 = fmaf(x.z, y.z, s0);
    s0 = fmaf(x.w, y.w, s0);
  }
  return s0;
}

// Dot product of a 16-byte-aligned shared-memory row with N registers.
template <int N>
__device__ __forceinline__ float dot_sr(const float* a, const float (&v)[N]) {
  float s0 = 0.0f;
#pragma unroll
  for (int q = 0; q < (N + 3) / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(a)[q];
    if (4 * q < N) s0 = fmaf(x.x, v[4 * q], s0);
    if (4 * q + 1 < N) s0 = fmaf(x.y, v[4 * q + 1], s0);
    if (4 * q + 2 < N) s0 = fmaf(x.z, v[4 * q + 2], s0);
    if (4 * q + 3 < N) s0 = fmaf(x.w, v[4 * q + 3], s0);
  }
  return s0;
}

// Inverse of an N x N matrix by unpivoted Gauss-Jordan with the float32
// `tiny` pivot floor (the arithmetic of ops/linsolve.py::gj_inverse, but
// for the pivot row, scaled by the pivot's reciprocal), held by columns
// across a full warp: lane j < N enters with column j of the matrix in t,
// lane N + j with column j of the identity and leaves with column j of the
// inverse. No shared memory, no barrier.
template <int N>
__device__ __forceinline__ void gj_columns(float (&t)[N]) {
  static_assert(2 * N <= 32, "the tableau's columns must fit a warp");
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float piv = __shfl_sync(kFull, t[k], k);
    if (fabsf(piv) < FLT_MIN) piv = piv >= 0.0f ? FLT_MIN : -FLT_MIN;
    // one reciprocal, the same in every lane, and a product: a division
    // here would take its slow path on the identity half's exact zeros
    const float row = t[k] * (1.0f / piv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i != k) {
        const float g = __shfl_sync(kFull, t[i], k);
        t[i] = t[i] - g * row;
      }
    }
    t[k] = row;
  }
}

// Layouts, in floats. A vector of z- or residual-space is kept padded,
// [x or dynamics rows: NX (+ zero padding to 4) | y1 or the other equality
// rows: NY | y2 or bilinear rows: NY], so that each part is 16-byte aligned.
template <int NX, int NY, int NT, int NC>
struct Lay {
  static constexpr int NE = NX + NY;      // equality rows
  static constexpr int NZ = NX + 2 * NY;  // variables
  static_assert(NY % 4 == 0 && 2 * NY <= 32, "two right-hand sides a warp");
  static_assert(NX <= NY, "a half-warp's NY lanes hold the x rows of a solve");
  static_assert(NE <= 32 && NT <= 34, "rows and columns per lane");
  // sensitivity columns past the warp's lanes, solved side by side
  static constexpr int NL = NT > 32 ? NT - 32 : 0;
  static constexpr int VY1 = pad4(NX), VY2 = VY1 + NY, NV = VY2 + NY;
  static constexpr int XS = pad4(NX);  // row stride of NX-wide matrices
  static constexpr int YS = NY + 4;    // of NY-wide ones read a row a lane
  static constexpr int ES = pad4(NE);
  // padded slot of variable or row j, and back
  __host__ __device__ static constexpr int slot(int j) {
    return j < NX ? j : j + (VY1 - NX);
  }
  __host__ __device__ static constexpr bool is_pad(int s) {
    return s >= NX && s < VY1;
  }
  __host__ __device__ static constexpr int unslot(int s) {
    return s < NX ? s : s - (VY1 - NX);
  }
  // one knot's packed constants
  static constexpr int kRza = 0,                // rz0's equality rows, NE x NV
      kDxi = kRza + NE * NV,                    // Dx^-1, NX x XS
      kDy1 = kDxi + NX * XS,                    // NX x YS
      kDxdy = kDy1 + NX * YS,                   // Dx^-1 Dy1, NX x YS
      kCai = kDxdy + NX * YS,                   // Rx Dx^-1, NY x XS
      kSb = kCai + NY * XS,                     // Ry1 - Cai Dy1, NY x NY
      kRy1d = kSb + NY * NY,                    // diag Ry1
      kCaibd = kRy1d + NY,                      // diag Cai Dy1
      kRy2 = kCaibd + NY,                       // diag Ry2
      kZ0 = kRy2 + NY,                          // NV
      kR0 = kZ0 + NV,                           // equality rows of r0, ES
      kTh0 = kR0 + ES,                          // pad4(NT)
      kRt0 = kTh0 + pad4(NT),                   // rtheta0, NZ x NT
      kPack = kRt0 + pad4(NZ * NT);
  // one warp's state
  static constexpr int wSi = 0,                 // S^-1, NY x YS
      wY1r = wSi + NY * YS, wY2r = wY1r + NY,
      wQ = wY2r + NY,                           // Ry2 / y1r
      wZ = wQ + NY, wZz = wZ + NV,              // z and z - z0
      wR = wZz + NV,                            // r(z, 0)
      wDaff = wR + NV,
      wRhs = wDaff + NV,                        // two right-hand sides
      wD = wRhs + 2 * NV,                       // two solutions
      wRes = wD + 2 * NV,                       // two refinement residuals
      wJd = wRes + 2 * NV,                      // Rza d, two directions, ES
      wT0 = wJd + 2 * ES, wT1 = wT0 + 2 * NY,
      wTh = wT1 + 2 * NY,                       // theta - theta0
      kWarp = wTh + pad4(NT);
  static_assert(kPack % 4 == 0 && kWarp % 4 == 0, "16-byte blocks");
};

struct Params {
  const float *z0_lin, *theta0, *r0, *rz0, *rtheta0;  // per knot (K, ...)
  const float *alt, *theta, *q2_init;                   // per problem (N, ...)
  float* pack;                                          // (K, kPack) scratch
  float *z_out, *rvio_out, *kvio_out, *dz_out;
  uint8_t* conv_out;
  int n, k, iters, refine, max_ls;
  float r_tol, kappa_tol, kappa_floor, gamma_reg, tau_min, tau_max;
};

// ---- per-knot constants ---------------------------------------------------

template <int NX, int NY, int NT, int NC>
__global__ void __launch_bounds__(kPackThreads) knot_pack_kernel(Params p) {
  using L = Lay<NX, NY, NT, NC>;
  constexpr int NE = L::NE, NZ = L::NZ;
  __shared__ __align__(16) float s[L::kPack];
  const int kn = blockIdx.x, tid = threadIdx.x;
  const float* rz = p.rz0 + (size_t)kn * NZ * NZ;
  for (int e = tid; e < L::kPack; e += kPackThreads) s[e] = 0.0f;
  __syncthreads();
  for (int e = tid; e < NE * NZ; e += kPackThreads)
    s[L::kRza + (e / NZ) * L::NV + L::slot(e % NZ)] = rz[e];
  for (int e = tid; e < NX * NY; e += kPackThreads)
    s[L::kDy1 + (e / NY) * L::YS + e % NY] = rz[(e / NY) * NZ + NX + e % NY];
  if (tid < NY) {
    s[L::kRy1d + tid] = rz[(NX + tid) * NZ + NX + tid];
    s[L::kRy2 + tid] = rz[(NX + tid) * NZ + NE + tid];
  }
  for (int j = tid; j < NZ; j += kPackThreads)
    s[L::kZ0 + L::slot(j)] = p.z0_lin[(size_t)kn * NZ + j];
  if (tid < NE) s[L::kR0 + tid] = p.r0[(size_t)kn * NZ + tid];
  for (int j = tid; j < NT; j += kPackThreads)
    s[L::kTh0 + j] = p.theta0[(size_t)kn * NT + j];
  for (int e = tid; e < NZ * NT; e += kPackThreads)
    s[L::kRt0 + e] = p.rtheta0[(size_t)kn * NZ * NT + e];
  if (tid < 32) {  // Dx^-1 in the first warp's registers
    float t[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
      t[i] = tid < NX ? rz[i * NZ + tid] : (tid - NX == i ? 1.0f : 0.0f);
    gj_columns<NX>(t);
    if (tid >= NX && tid < 2 * NX) {
#pragma unroll
      for (int i = 0; i < NX; ++i) s[L::kDxi + i * L::XS + tid - NX] = t[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < NY * NX; e += kPackThreads) {
    const int i = e / NX, j = e % NX;
    float acc = 0.0f;
    for (int l = 0; l < NX; ++l)
      acc += rz[(NX + i) * NZ + l] * s[L::kDxi + l * L::XS + j];
    s[L::kCai + i * L::XS + j] = acc;
  }
  for (int e = tid; e < NX * NY; e += kPackThreads) {
    const int i = e / NY, j = e % NY;
    float acc = 0.0f;
    for (int l = 0; l < NX; ++l)
      acc += s[L::kDxi + i * L::XS + l] * s[L::kDy1 + l * L::YS + j];
    s[L::kDxdy + i * L::YS + j] = acc;
  }
  __syncthreads();
  for (int e = tid; e < NY * NY; e += kPackThreads) {
    const int i = e / NY, j = e % NY;
    float acc = 0.0f;
    for (int l = 0; l < NX; ++l)
      acc += s[L::kCai + i * L::XS + l] * s[L::kDy1 + l * L::YS + j];
    s[L::kSb + e] = rz[(NX + i) * NZ + NX + j] - acc;
    if (i == j) s[L::kCaibd + i] = acc;
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(p.pack + (size_t)kn * L::kPack);
  for (int e = tid; e < L::kPack / 4; e += kPackThreads)
    out[e] = reinterpret_cast<const float4*>(s)[e];
}

// ---- one warp, one problem ------------------------------------------------

template <int NX, int NY, int NT, int NC>
struct Solver {
  using L = Lay<NX, NY, NT, NC>;
  static constexpr int NE = L::NE, NV = L::NV;
  static constexpr int VY1 = L::VY1, VY2 = L::VY2;

  const float* pk;  // the knot's packed constants, shared memory
  float* w;         // this warp's state, shared memory
  int lane;
  float gamma_reg;

  // Regularized Schur factorization at z: y1r, y2r, Ry2 / y1r and
  // si = S^-1 with S = Ry1 - diag(Ry2 y2r / y1r) - Rx Dx^-1 Dy1.
  __device__ __forceinline__ void factor(float kvio) const {
    const float reg = gamma_reg * kvio;
    const int j = lane % NY;
    const float y1 = pmax(w[L::wZ + VY1 + j], reg);
    const float y2 = pmax(w[L::wZ + VY2 + j], reg);
    const float ry2 = pk[L::kRy2 + j];
    float t[NY];
    if (lane < NY) {
      w[L::wY1r + lane] = y1;
      w[L::wY2r + lane] = y2;
      w[L::wQ + lane] = ry2 / y1;
      const float d = pk[L::kRy1d + lane] - ry2 * y2 / y1 - pk[L::kCaibd + lane];
#pragma unroll
      for (int i = 0; i < NY; ++i)
        t[i] = i == lane ? d : pk[L::kSb + i * NY + lane];
    } else {
#pragma unroll
      for (int i = 0; i < NY; ++i) t[i] = i == lane - NY ? 1.0f : 0.0f;
    }
    gj_columns<NY>(t);
    if (lane >= NY && lane < 2 * NY) {
#pragma unroll
      for (int i = 0; i < NY; ++i) w[L::wSi + i * L::YS + lane - NY] = t[i];
    }
    __syncwarp();
  }

  // Eliminated solve of the regularized system (RZLin solve,
  // linearized_solver.jl:424-444) for NR right-hand sides at src, one on
  // each half of the warp; the solutions replace or are added to dst.
  template <int NR>
  __device__ __forceinline__ void schur(const float* src, float* dst,
                                        bool add) const {
    const int h = lane / NY, i = lane % NY;
    const bool act = h < NR;
    const float* sv = src + h * NV;
    float* dv = dst + h * NV;
    float* t0 = w + L::wT0 + h * NY;
    float* t1 = w + L::wT1 + h * NY;
    if (act) {
      const float acc = dot_ss<L::XS>(pk + L::kCai + i * L::XS, sv);
      const float v = sv[VY1 + i] - w[L::wQ + i] * sv[VY2 + i];
      t0[i] = acc - v;
    }
    __syncwarp();
    float temp = 0.0f;
    if (act) {
      temp = dot_ss<NY>(w + L::wSi + i * L::YS, t0);
      t1[i] = temp;
    }
    __syncwarp();
    if (act) {
      if (i < NX) {  // Dx^-1 (rdyn + Dy1 temp), the product with Dy1 folded
        const float x = dot_ss<L::XS>(pk + L::kDxi + i * L::XS, sv) +
                        dot_ss<NY>(pk + L::kDxdy + i * L::YS, t1);
        dv[i] = add ? dv[i] + x : x;
      }
      const float y = -temp;
      const float y2 =
          (sv[VY2 + i] - w[L::wY2r + i] * y) / w[L::wY1r + i];
      dv[VY1 + i] = add ? dv[VY1 + i] + y : y;
      dv[VY2 + i] = add ? dv[VY2 + i] + y2 : y2;
    }
    __syncwarp();
  }

  // NR Schur solves plus `refine` passes against the factorization's own
  // (regularized) operator.
  template <int NR>
  __device__ __forceinline__ void solve(const float* rhs, float* out,
                                        int refine) const {
    schur<NR>(rhs, out, false);
    float* res = w + L::wRes;
    for (int pass = 0; pass < refine; ++pass) {
      if (lane < NE) {
        const float* row = pk + L::kRza + lane * NV;
        const int s = L::slot(lane);
#pragma unroll
        for (int r = 0; r < NR; ++r)
          res[r * NV + s] = rhs[r * NV + s] - dot_ss<NV>(row, out + r * NV);
      }
      const int h = lane / NY, i = lane % NY;
      if (h < NR) {
        const float* o = out + h * NV;
        res[h * NV + VY2 + i] =
            rhs[h * NV + VY2 + i] -
            (w[L::wY1r + i] * o[VY2 + i] + w[L::wY2r + i] * o[VY1 + i]);
      }
      __syncwarp();
      schur<NR>(res, out, true);
    }
  }

  // The refined solve of sensitivity column c, -rtheta0[:, c], by one lane
  // out of registers; the matrices are broadcasts from shared memory.
  __device__ __forceinline__ void solve_column(int c, int refine,
                                               float (&ox)[NX], float (&oy)[NY],
                                               float (&ow)[NY]) const {
    const float* rt = pk + L::kRt0 + c;
#pragma unroll
    for (int i = 0; i < NX; ++i) ox[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < NY; ++i) oy[i] = ow[i] = 0.0f;
#pragma unroll 1
    for (int pass = 0; pass <= refine; ++pass) {
      float a[NX], b[NY], cc[NY];
#pragma unroll
      for (int i = 0; i < NX; ++i) a[i] = -rt[i * NT];
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        b[i] = -rt[(NX + i) * NT];
        cc[i] = -rt[(NE + i) * NT];
      }
      if (pass > 0) {  // the residual of the solution so far
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          const float* row = pk + L::kRza + i * NV;
          a[i] -= dot_sr<NX>(row, ox) + dot_sr<NY>(row + VY1, oy) +
                  dot_sr<NY>(row + VY2, ow);
        }
#pragma unroll
        for (int i = 0; i < NY; ++i) {
          const float* row = pk + L::kRza + (NX + i) * NV;
          b[i] -= dot_sr<NX>(row, ox) + dot_sr<NY>(row + VY1, oy) +
                  dot_sr<NY>(row + VY2, ow);
          cc[i] -= w[L::wY1r + i] * ow[i] + w[L::wY2r + i] * oy[i];
        }
      }
      float t0[NY], t1[NY], t2[NX];
#pragma unroll
      for (int i = 0; i < NY; ++i)
        t0[i] = dot_sr<NX>(pk + L::kCai + i * L::XS, a) -
                (b[i] - w[L::wQ + i] * cc[i]);
#pragma unroll
      for (int i = 0; i < NY; ++i)
        t1[i] = dot_sr<NY>(w + L::wSi + i * L::YS, t0);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        t2[i] = a[i] + dot_sr<NY>(pk + L::kDy1 + i * L::YS, t1);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        ox[i] += dot_sr<NX>(pk + L::kDxi + i * L::XS, t2);
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        const float y = -t1[i];
        oy[i] += y;
        ow[i] += (cc[i] - w[L::wY2r + i] * y) / w[L::wY1r + i];
      }
    }
  }
};

// Two full blocks an SM cap a thread at 128 registers: the column solve
// then spills ~0.4 KB a thread, and 16 warps are resident in place of the 8
// that an uncapped build (~240 registers) would leave.
template <int NX, int NY, int NT, int NC>
__global__ void __launch_bounds__(32 * kMaxWarps, 2) knot_ip_kernel(Params p) {
  using L = Lay<NX, NY, NT, NC>;
  constexpr int NE = L::NE, NZ = L::NZ, NV = L::NV;
  constexpr int VY1 = L::VY1, VY2 = L::VY2, ES = L::ES;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kn = blockIdx.x % p.k;
  const int n = ((blockIdx.x / p.k) * warps + warp) * p.k + kn;
  const bool live = n < p.n;

  // ---- the knot's block, asynchronously; meanwhile this problem's data --
  const float* gpack = p.pack + (size_t)kn * L::kPack;
  for (int e = threadIdx.x; e < L::kPack / 4; e += blockDim.x)
    cp_async16(smem + 4 * e, gpack + 4 * e);
  const float* pk = smem;
  float* w = smem + L::kPack + warp * L::kWarp;
  for (int e = lane; e < L::kWarp; e += 32) w[e] = 0.0f;
  float th_lo = 0.0f, th_hi = 0.0f, q2 = 0.0f, alt = 0.0f;
  if (live) {
    if (lane < NT) th_lo = p.theta[(size_t)n * NT + lane];
    if (lane + 32 < NT) th_hi = p.theta[(size_t)n * NT + lane + 32];
    if (lane < NX) q2 = p.q2_init[(size_t)n * NX + lane];
    if (lane >= NX && lane < NX + NC) alt = p.alt[(size_t)n * NC + lane - NX];
  }
  cp_async_wait_all();
  __syncthreads();
  if (!live) return;  // uniform per warp; no block barrier follows

  Solver<NX, NY, NT, NC> sv{pk, w, lane, p.gamma_reg};
  float* z = w + L::wZ;
  float* zz = w + L::wZz;
  float* r = w + L::wR;
  float* daff = w + L::wDaff;
  float* rhs = w + L::wRhs;
  float* d2 = w + L::wD;
  float* jd = w + L::wJd;
  float* th = w + L::wTh;
  const float* rza_row = pk + L::kRza + lane * NV;  // lanes < NE
  const int eslot = L::slot(lane);

  // ---- base residual and the initial point ----------------------------
  if (lane < NT) th[lane] = th_lo - pk[L::kTh0 + lane];
  if (lane + 32 < NT) th[lane + 32] = th_hi - pk[L::kTh0 + lane + 32];
  for (int s = lane; s < NV; s += 32) {
    if (L::is_pad(s)) continue;
    const float v = s < NX ? q2 : 1.0f;
    z[s] = v;
    zz[s] = v - pk[L::kZ0 + s];
  }
  __syncwarp();
  float rb = 0.0f;  // lanes < NE: r0 + rtheta0 (theta - theta0) + alt
  if (lane < NE) {
    const float* rt = pk + L::kRt0 + lane * NT;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) acc = fmaf(rt[j], th[j], acc);
    rb = pk[L::kR0 + lane] + acc + alt;
  }

  const int n_ls = p.max_ls + 1;
  // the half of the warp (of each 2 NY lanes, where NY < 16) and its row
  const int h = (lane / NY) % 2, i = lane % NY;
  // this lane's slots of a padded vector: lane and s1, where they exist
  static_assert(L::VY1 <= 32 && NV <= 64, "two slots a lane");
  const int s1 = lane + 32;
  const bool has0 = lane < NV && !L::is_pad(lane), has1 = s1 < NV;
  bool done = false;
  float req = 0.0f, rbl = 0.0f, rvio = 0.0f, kvio = 0.0f;

  // r(z, 0) into r, its row in this lane's req / rbl, and the violations
  auto residual = [&]() {
    if (lane < NE) {
      req = rb + dot_ss<NV>(rza_row, zz);
      r[eslot] = req;
    }
    if (lane < NY) {
      rbl = z[VY1 + lane] * z[VY2 + lane];
      r[VY2 + lane] = rbl;
    }
    rvio = warp_max(lane < NE ? fabsf(req) : 0.0f);
    kvio = warp_max(lane < NY ? fabsf(rbl) : 0.0f);
  };

  for (int it = 0; it < p.iters; ++it) {
    residual();
    const bool done_now = (rvio <= p.r_tol) && (kvio <= p.kappa_tol);
    sv.factor(kvio);
    sv.template solve<1>(r, daff, p.refine);

    // affine step length, centering parameter
    // (both halves of the warp work on the same NY pairs: no lane divides
    // by a dummy zero, which would take the division's slow path)
    const float y1 = z[VY1 + i], y2 = z[VY2 + i];
    const float a1 = daff[VY1 + i], a2 = daff[VY2 + i];
    float m = pmin(step_ratio(1.0f, y1, a1), step_ratio(1.0f, y2, a2));
    const float a_aff = pmin(1.0f, warp_min(m));
    const float yy = lane < NY ? y1 * y2 : 0.0f;
    const float yya = lane < NY ? (y1 - a_aff * a1) * (y2 - a_aff * a2) : 0.0f;
    const float mu = warp_sum(yy) / NY;
    const float mu_aff = warp_sum(yya) / NY;
    const float ratio = mu_aff / pmax(mu, FLT_MIN);
    const float sig = pmin(pmax(ratio, 0.0f), 1.0f);
    const float kappa_t = pmax(sig * sig * sig * mu, p.kappa_floor);

    // corrector (first) and centering (second) right-hand sides
    float m0 = 0.0f;
    for (int s = lane; s < NV; s += 32) {
      if (L::is_pad(s)) continue;
      const float rc = s < VY2 ? r[s] : r[s] - kappa_t;
      rhs[NV + s] = rc;
      rhs[s] = s < VY2 ? rc : rc + daff[s - NY] * daff[s];
      m0 = fmaf(rc, rc, m0);
    }
    const float merit0 = warp_sum(m0);
    __syncwarp();
    sv.template solve<2>(rhs, d2, p.refine);

    // fraction-to-boundary step of each direction on its half of the warp
    const float vmax = pmax(rvio, kvio);
    const float tau = pmin(pmax(1.0f - vmax * vmax, p.tau_min), p.tau_max);
    {
      const float* d = d2 + h * NV;
      const float b1 = d[VY1 + i], b2 = d[VY2 + i];
      m = pmin(step_ratio(tau, z[VY1 + i], b1), step_ratio(tau, z[VY2 + i], b2));
      for (int o = NY / 2; o; o >>= 1) m = pmin(m, __shfl_xor_sync(kFull, m, o));
      m = pmin(1.0f, m);
    }
    const float a_cor = __shfl_sync(kFull, m, 0);
    const float a_cen = __shfl_sync(kFull, m, NY);

    // the equality rows of r(z - a d) are r - a Rza d
    if (lane < NE) {
      jd[lane] = dot_ss<NV>(rza_row, d2);
      jd[ES + lane] = dot_ss<NV>(rza_row, d2 + NV);
    }
    __syncwarp();

    // two-direction backtracking line search, lane c on candidate c: the
    // first passing candidate wins; if none passes, the first minimum-merit
    // one (NaN counts as the minimum, as jnp.argmin)
    const bool valid = lane < 2 * n_ls;
    const int dir = valid ? lane / n_ls : 0;
    const float a = (dir ? a_cen : a_cor) *
                    __int_as_float((127 - lane % n_ls) << 23);  // 2^-halvings
    float mer;
    {
      const float* jv = jd + dir * ES;
      const float* d = d2 + dir * NV;
      float q0 = 0.0f, q1 = 0.0f;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const float v = r[L::slot(e)] - a * jv[e];
        if (e % 2) q1 = fmaf(v, v, q1); else q0 = fmaf(v, v, q0);
      }
#pragma unroll
      for (int e = 0; e < NY; ++e) {
        const float v = (z[VY1 + e] - a * d[VY1 + e]) *
                        (z[VY2 + e] - a * d[VY2 + e]) - kappa_t;
        if (e % 2) q1 = fmaf(v, v, q1); else q0 = fmaf(v, v, q0);
      }
      mer = q0 + q1;
    }
    int pick;
    const unsigned ok =
        __ballot_sync(kFull, valid && mer < (1.0f - 1.0e-3f * a) * merit0);
    if (ok) {
      pick = __ffs(ok) - 1;
    } else {
      const unsigned nans = __ballot_sync(kFull, valid && mer != mer);
      if (nans) {
        pick = __ffs(nans) - 1;
      } else {
        const float best = warp_min(valid ? mer : INFINITY);
        pick = __ffs(__ballot_sync(kFull, valid && mer == best)) - 1;
      }
    }
    const float a_pick = __shfl_sync(kFull, a, pick);
    const float* d = d2 + (pick / n_ls) * NV;
    const float zn0 = has0 ? z[lane] - a_pick * d[lane] : 0.0f;
    const float zn1 = has1 ? z[s1] - a_pick * d[s1] : 0.0f;
    const bool finite = __all_sync(kFull, isfinite(zn0) && isfinite(zn1));
    __syncwarp();  // every lane has read z
    // keep the last finite iterate; converged problems freeze
    if (!(done || done_now || !finite)) {
      if (has0) {
        z[lane] = zn0;
        zz[lane] = zn0 - pk[L::kZ0 + lane];
      }
      if (has1) {
        z[s1] = zn1;
        zz[s1] = zn1 - pk[L::kZ0 + s1];
      }
    }
    done = done || done_now;
    __syncwarp();
  }

  // ---- final residual, flags and the sensitivity solve ------------------
  residual();
  const bool converged = (rvio <= p.r_tol) && (kvio <= p.kappa_tol);
  sv.factor(kvio);
  constexpr int NL = L::NL;  // columns past the warp's lanes
  bool finite = true;
  if constexpr (NL > 0) {
    for (int s = lane; s < NV; s += 32) {
      if (L::is_pad(s)) continue;
#pragma unroll
      for (int c = 0; c < NL; ++c)
        rhs[c * NV + s] = -pk[L::kRt0 + L::unslot(s) * NT + 32 + c];
    }
    __syncwarp();
    sv.template solve<NL>(rhs, d2, p.refine);
    for (int s = lane; s < NV; s += 32) {
      if (L::is_pad(s)) continue;
#pragma unroll
      for (int c = 0; c < NL; ++c) finite = finite && isfinite(d2[c * NV + s]);
    }
  }
  // a lane past the last column solves that column again and stores nothing
  const bool col = lane < NT;
  float ox[NX], oy[NY], ow[NY];
  sv.solve_column(col ? lane : NT - 1, p.refine, ox, oy, ow);
#pragma unroll
  for (int e = 0; e < NX; ++e) finite = finite && isfinite(ox[e]);
#pragma unroll
  for (int e = 0; e < NY; ++e)
    finite = finite && isfinite(oy[e]) && isfinite(ow[e]);
  const bool dz_bad = !__all_sync(kFull, finite);
  float* dz = p.dz_out + (size_t)n * NZ * NT;
  if (col) {
#pragma unroll
    for (int e = 0; e < NX; ++e) dz[e * NT + lane] = dz_bad ? 0.0f : ox[e];
#pragma unroll
    for (int e = 0; e < NY; ++e) {
      dz[(NX + e) * NT + lane] = dz_bad ? 0.0f : oy[e];
      dz[(NE + e) * NT + lane] = dz_bad ? 0.0f : ow[e];
    }
  }
  for (int s = lane; s < NV; s += 32) {
    if (L::is_pad(s)) continue;
    if constexpr (NL > 0) {
#pragma unroll
      for (int c = 0; c < NL; ++c)
        dz[L::unslot(s) * NT + 32 + c] = dz_bad ? 0.0f : d2[c * NV + s];
    }
    p.z_out[(size_t)n * NZ + L::unslot(s)] = z[s];
  }
  if (lane == 0) {
    p.conv_out[n] = (converged && !dz_bad) ? 1 : 0;
    p.rvio_out[n] = rvio;
    p.kvio_out[n] = kvio;
  }
}

// ---- problems past one warp: one block a problem ---------------------------
//
// The centroidal quadruped's knot (nx 18, ny 24, ntheta 53; 42 equality
// rows, 66 variables) breaks every assertion of struct Lay: its two
// right-hand sides do not fit the two halves of a warp, nor its rows and
// columns a lane each. knot_ip_wide_kernel gives a problem a block of
// WLay::NTHR threads (2 to 4 warps) instead, and keeps the arithmetic of the
// plain version step by step:
// - the knot's packed block (WLay, laid out by knot_pack_wide_kernel; rows
//   padded to an odd stride, so that threads reading a row each do not
//   share a bank) and the problem's state in shared memory, past 48 KB by
//   the opt-in of dynamic shared memory;
// - every product is a loop over (row, right-hand side) elements, one
//   accumulator a sum, the terms in the plain version's order;
// - the [S | I] tableau inverted by Gauss-Jordan, a thread a column held in
//   registers, one reciprocal and one barrier a pivot, the pivot column
//   passed through shared memory;
// - the corrector and centering solves as two right-hand sides of one
//   Schur solve, and the sensitivities as ntheta right-hand sides of the
//   same solve, read from rtheta0 in place;
// - the line search as in knot_ip_kernel: one thread a candidate, in the
//   first warp, on the affine equality rows;
// - reductions over the block propagate NaN; `finite` is a barrier's AND.

__host__ __device__ constexpr int odd(int n) { return n | 1; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int NX, int NY, int NT, int NC>
struct WLay {
  static constexpr int NE = NX + NY, NZ = NX + 2 * NY;
  static constexpr int SZ = odd(NZ), SX = odd(NX), SY = odd(NY);
  // a thread for each tableau column, sensitivity column and equality row
  static constexpr int NTHR =
      32 * cmax(2, (cmax(cmax(2 * NY, NT), NE) + 31) / 32);
  static constexpr int NW = NTHR / 32;
  static_assert(NTHR <= 128, "2 to 4 warps a problem");
  // one knot's packed constants, in floats
  static constexpr int kRza = 0,                // rz0's equality rows, NE x SZ
      kDxi = kRza + NE * SZ,                    // Dx^-1, NX x SX
      kDy1 = kDxi + NX * SX,                    // NX x SY
      kCai = kDy1 + NX * SY,                    // Rx Dx^-1, NY x SX
      kSb = kCai + NY * SX,                     // Ry1 - Cai Dy1, NY x SY
      kRy1d = kSb + NY * SY,                    // diag Ry1
      kCaibd = kRy1d + NY,                      // diag Cai Dy1
      kRy2 = kCaibd + NY,                       // diag Ry2
      kZ0 = kRy2 + NY,                          // NZ
      kR0 = kZ0 + NZ,                           // equality rows of r0, NE
      kTh0 = kR0 + NE,                          // NT
      kRt0 = kTh0 + NT,                         // rtheta0, NZ x NT
      kPack = pad4(kRt0 + NZ * NT);
  // a problem's state kept through the solve
  static constexpr int SI = odd(NY);           // S^-1 row stride
  static constexpr int sZ = 0, sZz = sZ + NZ, sR = sZz + NZ,
      sY1r = sR + NZ, sY2r = sY1r + NY, sQ = sY2r + NY, sTh = sQ + NY,
      sSi = sTh + NT,                           // S^-1, NY x SI
      sPiv = sSi + NY * SI,                     // pivot columns, 2 x NY
      sRed = sPiv + 2 * NY,                     // two slots a warp
      sPick = sRed + 2 * NW,                    // the line search's pick
      kKeep = pad4(sPick + 2);
  // then either the iterations' vectors (right-hand sides contiguous)
  static constexpr int iDaff = 0, iRhs = iDaff + NZ, iD = iRhs + 2 * NZ,
      iRes = iD + 2 * NZ, iJd = iRes + 2 * NZ, iT0 = iJd + 2 * NE,
      iT1 = iT0 + 2 * cmax(NX, NY), kIter = iT1 + 2 * NY;
  // or the sensitivity solve's columns, CH at a time
  static constexpr int CH = (NT + 1) / 2;
  static constexpr int cRes = 0, cD = cRes + CH * NZ, cT0 = cD + CH * NZ,
      cT1 = cT0 + CH * cmax(NX, NY), kSens = cT1 + CH * NY;
  static constexpr int kState = kKeep + cmax(kIter, kSens);
  static constexpr int kBytes = 4 * (kPack + kState);
  static_assert(kBytes <= 227 * 1024, "a problem must fit an SM's shared memory");
  static constexpr int PER = (NZ + NTHR - 1) / NTHR;  // variables a thread
};

struct OpMax {
  __device__ float operator()(float a, float b) const { return pmax(a, b); }
};
struct OpMin {
  __device__ float operator()(float a, float b) const { return pmin(a, b); }
};
struct OpSum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

template <int NX, int NY, int NT, int NC>
struct WSolver {
  using L = WLay<NX, NY, NT, NC>;
  static constexpr int NE = L::NE, NZ = L::NZ, NTHR = L::NTHR;

  const float* pk;  // the knot's packed constants, shared memory
  float* s;         // the problem's kept state, shared memory
  int tid;
  float gamma_reg;

  // (a, b) each combined over the block by op; every thread gets both
  template <class Op>
  __device__ __forceinline__ void reduce2(float& a, float& b, Op op) const {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      a = op(a, __shfl_xor_sync(kFull, a, o));
      b = op(b, __shfl_xor_sync(kFull, b, o));
    }
    if (tid % 32 == 0) {
      s[L::sRed + 2 * (tid / 32)] = a;
      s[L::sRed + 2 * (tid / 32) + 1] = b;
    }
    __syncthreads();
    a = s[L::sRed];
    b = s[L::sRed + 1];
#pragma unroll
    for (int w = 1; w < L::NW; ++w) {
      a = op(a, s[L::sRed + 2 * w]);
      b = op(b, s[L::sRed + 2 * w + 1]);
    }
    __syncthreads();
  }
  template <class Op>
  __device__ __forceinline__ float reduce(float v, Op op) const {
    float unused = 0.0f;
    reduce2(v, unused, op);
    return v;
  }

  // Regularized Schur factorization at z: y1r, y2r, Ry2 / y1r and S^-1
  // with S = Ry1 - diag(Ry2 y2r / y1r) - Rx Dx^-1 Dy1, by Gauss-Jordan on
  // [S | I] held by columns: thread j < 2 NY keeps column j in registers,
  // the pivot column goes through shared memory (two buffers, so that one
  // barrier a pivot separates every write from the reads before it).
  __device__ void factor(float kvio) const {
    const float reg = gamma_reg * kvio;
    const float* z = s + L::sZ;
    float* y1r = s + L::sY1r;
    float* y2r = s + L::sY2r;
    if (tid < NY) {
      const float y1 = pmax(z[NX + tid], reg), y2 = pmax(z[NE + tid], reg);
      y1r[tid] = y1;
      y2r[tid] = y2;
      s[L::sQ + tid] = pk[L::kRy2 + tid] / y1;
    }
    __syncthreads();
    const int j = tid;
    float t[NY];
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      float v = 0.0f;
      if (j < NY)
        v = i == j ? pk[L::kRy1d + i] - pk[L::kRy2 + i] * y2r[i] / y1r[i] -
                         pk[L::kCaibd + i]
                   : pk[L::kSb + i * L::SY + j];
      else if (j - NY == i)
        v = 1.0f;
      t[i] = v;
    }
#pragma unroll
    for (int k = 0; k < NY; ++k) {
      float* pc = s + L::sPiv + (k & 1) * NY;
      if (j == k) {
#pragma unroll
        for (int i = 0; i < NY; ++i) pc[i] = t[i];
      }
      __syncthreads();
      float piv = pc[k];
      if (fabsf(piv) < FLT_MIN) piv = piv >= 0.0f ? FLT_MIN : -FLT_MIN;
      const float row = t[k] * (1.0f / piv);  // one reciprocal: see gj_columns
#pragma unroll
      for (int i = 0; i < NY; ++i)
        if (i != k) t[i] = t[i] - pc[i] * row;
      t[k] = row;
    }
    if (j >= NY && j < 2 * NY) {
#pragma unroll
      for (int i = 0; i < NY; ++i) s[L::sSi + i * L::SI + j - NY] = t[i];
    }
    __syncthreads();
  }

  // Eliminated solve of the regularized system (RZLin solve,
  // linearized_solver.jl:424-444) for nr right-hand sides: entry (c, l) of
  // the right-hand sides is sgn * b[c * bc + l * bl]; solution c is
  // d[c * NZ, +NZ), replaced or added to. t0 holds nr * max(NX, NY)
  // floats, t1 nr * NY.
  __device__ void schur(const float* b, int bc, int bl, float sgn, float* d,
                        float* t0, float* t1, int nr, bool add) const {
    const float* q = s + L::sQ;
    const float* y1r = s + L::sY1r;
    const float* y2r = s + L::sY2r;
    const float* si = s + L::sSi;
    for (int e = tid; e < nr * NY; e += NTHR) {  // Rx Dx^-1 rdyn - v
      const int c = e / NY, i = e % NY;
      const float* bv = b + c * bc;
      const float* row = pk + L::kCai + i * L::SX;
      float acc = 0.0f;
      for (int l = 0; l < NX; ++l) acc = fmaf(row[l], sgn * bv[l * bl], acc);
      const float v = sgn * bv[(NX + i) * bl] - q[i] * (sgn * bv[(NE + i) * bl]);
      t0[c * NY + i] = acc - v;
    }
    __syncthreads();
    for (int e = tid; e < nr * NY; e += NTHR) {  // temp = S^-1 t0
      const int c = e / NY, i = e % NY;
      const float* row = si + i * L::SI;
      const float* tv = t0 + c * NY;
      float acc = 0.0f;
      for (int l = 0; l < NY; ++l) acc = fmaf(row[l], tv[l], acc);
      t1[c * NY + i] = acc;
    }
    __syncthreads();
    for (int e = tid; e < nr * NX; e += NTHR) {  // rdyn + Dy1 temp, into t0
      const int c = e / NX, i = e % NX;
      const float* row = pk + L::kDy1 + i * L::SY;
      const float* tv = t1 + c * NY;
      float acc = 0.0f;
      for (int m = 0; m < NY; ++m) acc = fmaf(row[m], tv[m], acc);
      t0[c * NX + i] = sgn * b[c * bc + i * bl] + acc;
    }
    for (int e = tid; e < nr * NY; e += NTHR) {  // the y parts
      const int c = e / NY, i = e % NY;
      const float temp = t1[c * NY + i];
      const float y2 = (sgn * b[c * bc + (NE + i) * bl] + y2r[i] * temp) / y1r[i];
      float* dv = d + c * NZ;
      dv[NX + i] = add ? dv[NX + i] + -temp : -temp;
      dv[NE + i] = add ? dv[NE + i] + y2 : y2;
    }
    __syncthreads();
    for (int e = tid; e < nr * NX; e += NTHR) {  // x = Dx^-1 (...)
      const int c = e / NX, i = e % NX;
      const float* row = pk + L::kDxi + i * L::SX;
      const float* tv = t0 + c * NX;
      float acc = 0.0f;
      for (int l = 0; l < NX; ++l) acc = fmaf(row[l], tv[l], acc);
      float* dv = d + c * NZ;
      dv[i] = add ? dv[i] + acc : acc;
    }
    __syncthreads();
  }

  // The Schur solve plus `refine` passes against the factorization's own
  // (regularized) operator; res holds nr * NZ floats.
  __device__ void solve(const float* b, int bc, int bl, float sgn, float* d,
                        float* res, float* t0, float* t1, int nr,
                        int refine) const {
    schur(b, bc, bl, sgn, d, t0, t1, nr, false);
    const float* y1r = s + L::sY1r;
    const float* y2r = s + L::sY2r;
    for (int pass = 0; pass < refine; ++pass) {
      for (int e = tid; e < nr * NZ; e += NTHR) {
        const int c = e / NZ, j = e % NZ;
        const float* dv = d + c * NZ;
        float v;
        if (j < NE) {
          const float* row = pk + L::kRza + j * L::SZ;
          v = 0.0f;
          for (int l = 0; l < NZ; ++l) v = fmaf(row[l], dv[l], v);
        } else {
          const int i = j - NE;
          v = y1r[i] * dv[NE + i] + y2r[i] * dv[NX + i];
        }
        res[c * NZ + j] = sgn * b[c * bc + j * bl] - v;
      }
      __syncthreads();
      schur(res, NZ, 1, 1.0f, d, t0, t1, nr, true);
    }
  }
};

template <int NX, int NY, int NT, int NC>
__global__ void __launch_bounds__(WLay<NX, NY, NT, NC>::NTHR)
    knot_ip_wide_kernel(Params p) {
  using L = WLay<NX, NY, NT, NC>;
  constexpr int NE = L::NE, NZ = L::NZ, NTHR = L::NTHR, PER = L::PER;
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x, kn = n % p.k, tid = threadIdx.x;

  // ---- the knot's block, asynchronously; meanwhile this problem's data --
  const float* gpack = p.pack + (size_t)kn * L::kPack;
  for (int e = tid; e < L::kPack / 4; e += NTHR)
    cp_async16(smem + 4 * e, gpack + 4 * e);
  const float* pk = smem;
  float* s = smem + L::kPack;
  float* u = s + L::kKeep;
  for (int e = tid; e < L::kState; e += NTHR) s[e] = 0.0f;
  cp_async_wait_all();
  __syncthreads();

  WSolver<NX, NY, NT, NC> sv{pk, s, tid, p.gamma_reg};
  float* z = s + L::sZ;
  float* zz = s + L::sZz;
  float* r = s + L::sR;
  float* th = s + L::sTh;
  for (int j = tid; j < NT; j += NTHR)
    th[j] = p.theta[(size_t)n * NT + j] - pk[L::kTh0 + j];
  for (int j = tid; j < NZ; j += NTHR) {
    const float v = j < NX ? p.q2_init[(size_t)n * NX + j] : 1.0f;
    z[j] = v;
    zz[j] = v - pk[L::kZ0 + j];
  }
  __syncthreads();
  float rb = 0.0f;  // threads < NE: r0 + rtheta0 (theta - theta0) + alt
  if (tid < NE) {
    const float* rt = pk + L::kRt0 + tid * NT;
    float acc = 0.0f;
    for (int j = 0; j < NT; ++j) acc = fmaf(rt[j], th[j], acc);
    const float alt =
        tid >= NX && tid < NX + NC ? p.alt[(size_t)n * NC + tid - NX] : 0.0f;
    rb = pk[L::kR0 + tid] + acc + alt;
  }

  float rvio = 0.0f, kvio = 0.0f;
  // r(z, 0) into r, and the violations
  auto residual = [&]() {
    float req = 0.0f, rbl = 0.0f;
    if (tid < NE) {
      const float* row = pk + L::kRza + tid * L::SZ;
      float acc = 0.0f;
      for (int j = 0; j < NZ; ++j) acc = fmaf(row[j], zz[j], acc);
      req = rb + acc;
      r[tid] = req;
    }
    if (tid < NY) {
      rbl = z[NX + tid] * z[NE + tid];
      r[NE + tid] = rbl;
    }
    rvio = tid < NE ? fabsf(req) : 0.0f;
    kvio = tid < NY ? fabsf(rbl) : 0.0f;
    sv.reduce2(rvio, kvio, OpMax());
  };

  float* daff = u + L::iDaff;
  float* rhs = u + L::iRhs;
  float* d2 = u + L::iD;
  float* jd = u + L::iJd;
  const int n_ls = p.max_ls + 1;
  bool done = false;
  for (int it = 0; it < p.iters; ++it) {
    residual();
    const bool done_now = (rvio <= p.r_tol) && (kvio <= p.kappa_tol);
    sv.factor(kvio);
    sv.solve(r, NZ, 1, 1.0f, daff, u + L::iRes, u + L::iT0, u + L::iT1, 1,
             p.refine);

    // affine step length, centering parameter
    float m = FLT_MAX, yy = 0.0f, yya = 0.0f;
    if (tid < NY) {
      const float y1 = z[NX + tid], y2 = z[NE + tid];
      const float a1 = daff[NX + tid], a2 = daff[NE + tid];
      m = pmin(step_ratio(1.0f, y1, a1), step_ratio(1.0f, y2, a2));
    }
    const float a_aff = pmin(1.0f, sv.reduce(m, OpMin()));
    if (tid < NY) {
      const float y1 = z[NX + tid], y2 = z[NE + tid];
      yy = y1 * y2;
      yya = (y1 - a_aff * daff[NX + tid]) * (y2 - a_aff * daff[NE + tid]);
    }
    sv.reduce2(yy, yya, OpSum());
    const float mu = yy / NY;
    const float mu_aff = yya / NY;
    const float ratio = mu_aff / pmax(mu, FLT_MIN);
    const float sig = pmin(pmax(ratio, 0.0f), 1.0f);
    const float kappa_t = pmax(sig * sig * sig * mu, p.kappa_floor);

    // corrector (first) and centering (second) right-hand sides
    float m0 = 0.0f;
    for (int j = tid; j < NZ; j += NTHR) {
      const float rc = j < NE ? r[j] : r[j] - kappa_t;
      rhs[NZ + j] = rc;
      rhs[j] = j < NE ? rc : rc + daff[j - NY] * daff[j];
      m0 = fmaf(rc, rc, m0);
    }
    const float merit0 = sv.reduce(m0, OpSum());  // its barriers publish rhs
    sv.solve(rhs, NZ, 1, 1.0f, d2, u + L::iRes, u + L::iT0, u + L::iT1, 2,
             p.refine);

    // fraction-to-boundary step of each direction
    const float vmax = pmax(rvio, kvio);
    const float tau = pmin(pmax(1.0f - vmax * vmax, p.tau_min), p.tau_max);
    float mc = FLT_MAX, me = FLT_MAX;
    if (tid < NY) {
      const float y1 = z[NX + tid], y2 = z[NE + tid];
      mc = pmin(step_ratio(tau, y1, d2[NX + tid]),
                step_ratio(tau, y2, d2[NE + tid]));
      me = pmin(step_ratio(tau, y1, d2[NZ + NX + tid]),
                step_ratio(tau, y2, d2[NZ + NE + tid]));
    }
    sv.reduce2(mc, me, OpMin());
    const float a_cor = pmin(1.0f, mc);
    const float a_cen = pmin(1.0f, me);

    // the equality rows of r(z - a d) are r - a Rza d
    for (int e = tid; e < 2 * NE; e += NTHR) {
      const int dir = e / NE, row = e % NE;
      const float* rz = pk + L::kRza + row * L::SZ;
      const float* dv = d2 + dir * NZ;
      float acc = 0.0f;
      for (int j = 0; j < NZ; ++j) acc = fmaf(rz[j], dv[j], acc);
      jd[e] = acc;
    }
    __syncthreads();

    // two-direction backtracking line search in the first warp, thread c on
    // candidate c: the first passing candidate wins; if none passes, the
    // first minimum-merit one (NaN counts as the minimum, as jnp.argmin)
    if (tid < 32) {
      const bool valid = tid < 2 * n_ls;
      const int dir = valid ? tid / n_ls : 0;
      const float a = (dir ? a_cen : a_cor) *
                      __int_as_float((127 - tid % n_ls) << 23);  // 2^-halvings
      const float* jv = jd + dir * NE;
      const float* dv = d2 + dir * NZ;
      float mer = 0.0f;
      for (int e = 0; e < NE; ++e) {
        const float v = r[e] - a * jv[e];
        mer = fmaf(v, v, mer);
      }
      for (int e = 0; e < NY; ++e) {
        const float v = (z[NX + e] - a * dv[NX + e]) *
                        (z[NE + e] - a * dv[NE + e]) - kappa_t;
        mer = fmaf(v, v, mer);
      }
      int pick;
      const unsigned ok =
          __ballot_sync(kFull, valid && mer < (1.0f - 1.0e-3f * a) * merit0);
      if (ok) {
        pick = __ffs(ok) - 1;
      } else {
        const unsigned nans = __ballot_sync(kFull, valid && mer != mer);
        if (nans) {
          pick = __ffs(nans) - 1;
        } else {
          const float best = warp_min(valid ? mer : INFINITY);
          pick = __ffs(__ballot_sync(kFull, valid && mer == best)) - 1;
        }
      }
      const float a_pick = __shfl_sync(kFull, a, pick);
      if (tid == 0) {
        s[L::sPick] = a_pick;
        s[L::sPick + 1] = static_cast<float>(pick / n_ls);
      }
    }
    __syncthreads();
    const float a_pick = s[L::sPick];
    const float* d = d2 + static_cast<int>(s[L::sPick + 1]) * NZ;
    float zn[PER];
    bool fin = true;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = tid + k * NTHR;
      zn[k] = j < NZ ? z[j] - a_pick * d[j] : 0.0f;
      fin = fin && isfinite(zn[k]);
    }
    const bool finite = __syncthreads_and(fin);  // every thread has read z
    // keep the last finite iterate; converged problems freeze
    if (!(done || done_now || !finite)) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = tid + k * NTHR;
        if (j < NZ) {
          z[j] = zn[k];
          zz[j] = zn[k] - pk[L::kZ0 + j];
        }
      }
    }
    done = done || done_now;
    __syncthreads();
  }

  // ---- final residual, flags and the sensitivity solve ------------------
  residual();
  const bool converged = (rvio <= p.r_tol) && (kvio <= p.kappa_tol);
  sv.factor(kvio);
  // columns c0 + c of dz at dzs[c * NZ, +NZ), CH at a time, stored as they
  // come and zeroed again if any is not finite
  float* dzs = u + L::cD;
  float* dz = p.dz_out + (size_t)n * NZ * NT;
  bool fin = true;
  for (int c0 = 0; c0 < NT; c0 += L::CH) {
    const int nr = NT - c0 < L::CH ? NT - c0 : L::CH;
    sv.solve(pk + L::kRt0 + c0, 1, NT, -1.0f, dzs, u + L::cRes, u + L::cT0,
             u + L::cT1, nr, p.refine);
    for (int e = tid; e < NZ * nr; e += NTHR) {
      const int row = e / nr, c = e % nr;
      const float v = dzs[c * NZ + row];
      fin = fin && isfinite(v);
      dz[row * NT + c0 + c] = v;
    }
    __syncthreads();  // the next columns overwrite dzs
  }
  const bool dz_bad = !__syncthreads_and(fin);
  if (dz_bad) {
    for (int e = tid; e < NZ * NT; e += NTHR) dz[e] = 0.0f;
  }
  for (int j = tid; j < NZ; j += NTHR) p.z_out[(size_t)n * NZ + j] = z[j];
  if (tid == 0) {
    p.conv_out[n] = (converged && !dz_bad) ? 1 : 0;
    p.rvio_out[n] = rvio;
    p.kvio_out[n] = kvio;
  }
}

// The per-knot constants of WLay, one block a knot; written straight to the
// scratch in device memory (a wall's block is past 48 KB), with Dx^-1 and
// Rx Dx^-1 staged in shared memory.
template <int NX, int NY, int NT, int NC>
__global__ void __launch_bounds__(kPackThreads) knot_pack_wide_kernel(Params p) {
  using L = WLay<NX, NY, NT, NC>;
  constexpr int NE = L::NE, NZ = L::NZ;
  __shared__ float tab[NX * 2 * NX];  // [Dx | I] -> [. | Dx^-1]
  __shared__ float cai[NY * NX];
  const int kn = blockIdx.x, tid = threadIdx.x;
  const float* rz = p.rz0 + (size_t)kn * NZ * NZ;
  float* o = p.pack + (size_t)kn * L::kPack;
  for (int e = tid; e < L::kPack; e += kPackThreads) o[e] = 0.0f;
  __syncthreads();
  for (int e = tid; e < NE * NZ; e += kPackThreads)
    o[L::kRza + (e / NZ) * L::SZ + e % NZ] = rz[e];
  for (int e = tid; e < NX * NY; e += kPackThreads)
    o[L::kDy1 + (e / NY) * L::SY + e % NY] = rz[(e / NY) * NZ + NX + e % NY];
  for (int i = tid; i < NY; i += kPackThreads) {
    o[L::kRy1d + i] = rz[(NX + i) * NZ + NX + i];
    o[L::kRy2 + i] = rz[(NX + i) * NZ + NE + i];
  }
  for (int j = tid; j < NZ; j += kPackThreads)
    o[L::kZ0 + j] = p.z0_lin[(size_t)kn * NZ + j];
  for (int j = tid; j < NE; j += kPackThreads)
    o[L::kR0 + j] = p.r0[(size_t)kn * NZ + j];
  for (int j = tid; j < NT; j += kPackThreads)
    o[L::kTh0 + j] = p.theta0[(size_t)kn * NT + j];
  for (int e = tid; e < NZ * NT; e += kPackThreads)
    o[L::kRt0 + e] = p.rtheta0[(size_t)kn * NZ * NT + e];
  for (int e = tid; e < NX * 2 * NX; e += kPackThreads) {
    const int i = e / (2 * NX), j = e % (2 * NX);
    tab[e] = j < NX ? rz[i * NZ + j] : (j - NX == i ? 1.0f : 0.0f);
  }
  __syncthreads();
  for (int k = 0; k < NX; ++k) {  // Gauss-Jordan, a thread a column
    float piv = tab[k * 2 * NX + k];
    if (fabsf(piv) < FLT_MIN) piv = piv >= 0.0f ? FLT_MIN : -FLT_MIN;
    const float rinv = 1.0f / piv;
    for (int j = k + 1 + tid; j < 2 * NX; j += kPackThreads) {
      const float row = tab[k * 2 * NX + j] * rinv;
      for (int i = 0; i < NX; ++i)
        if (i != k) tab[i * 2 * NX + j] = tab[i * 2 * NX + j] - tab[i * 2 * NX + k] * row;
      tab[k * 2 * NX + j] = row;
    }
    __syncthreads();
  }
  for (int e = tid; e < NX * NX; e += kPackThreads)
    o[L::kDxi + (e / NX) * L::SX + e % NX] = tab[(e / NX) * 2 * NX + NX + e % NX];
  for (int e = tid; e < NY * NX; e += kPackThreads) {
    const int i = e / NX, j = e % NX;
    float acc = 0.0f;
    for (int l = 0; l < NX; ++l)
      acc += rz[(NX + i) * NZ + l] * tab[l * 2 * NX + NX + j];
    cai[e] = acc;
    o[L::kCai + i * L::SX + j] = acc;
  }
  __syncthreads();
  for (int e = tid; e < NY * NY; e += kPackThreads) {
    const int i = e / NY, j = e % NY;
    float acc = 0.0f;
    for (int l = 0; l < NX; ++l) acc += cai[i * NX + l] * rz[l * NZ + NX + j];
    o[L::kSb + i * L::SY + j] = rz[(NX + i) * NZ + NX + j] - acc;
    if (i == j) o[L::kCaibd + i] = acc;
  }
}

template <int NX, int NY, int NT, int NC>
int launch_pack(const Params& p, cudaStream_t stream) {
  knot_pack_kernel<NX, NY, NT, NC><<<p.k, kPackThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Warps (problems) of a block: one while the problems are few, so that they
// spread over every SM and scheduler; kMaxWarps at large N, where the knot's
// block is then fetched once for several problems.
int block_warps(int n) { return n < 2048 ? 1 : kMaxWarps; }

template <int NX, int NY, int NT, int NC>
int launch(const Params& p, cudaStream_t stream) {
  using L = Lay<NX, NY, NT, NC>;
  if (p.n % p.k != 0 || p.max_ls < 0 || 2 * (p.max_ls + 1) > 32) return -2;
  const int warps = block_warps(p.n);
  int err = launch_pack<NX, NY, NT, NC>(p, stream);
  if (err != 0) return err;
  static_assert(sizeof(float) * (L::kPack + kMaxWarps * L::kWarp) <= 48 * 1024,
                "past 48 KB the kernel must opt in to its dynamic shared "
                "memory (cudaFuncAttributeMaxDynamicSharedMemorySize)");
  const size_t smem = sizeof(float) * (L::kPack + warps * L::kWarp);
  const int per_knot = p.n / p.k;
  const int blocks = p.k * ((per_knot + warps - 1) / warps);
  knot_ip_kernel<NX, NY, NT, NC><<<blocks, 32 * warps, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NX, int NY, int NT, int NC>
int launch_pack_wide(const Params& p, cudaStream_t stream) {
  knot_pack_wide_kernel<NX, NY, NT, NC><<<p.k, kPackThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NX, int NY, int NT, int NC>
int launch_wide(const Params& p, cudaStream_t stream) {
  using L = WLay<NX, NY, NT, NC>;
  if (p.n % p.k != 0 || p.max_ls < 0 || 2 * (p.max_ls + 1) > 32) return -2;
  int err = launch_pack_wide<NX, NY, NT, NC>(p, stream);
  if (err != 0) return err;
  if (L::kBytes > 48 * 1024) {  // past 48 KB only by opting in
    err = static_cast<int>(cudaFuncSetAttribute(
        knot_ip_wide_kernel<NX, NY, NT, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes));
    if (err != 0) return err;
  }
  knot_ip_wide_kernel<NX, NY, NT, NC><<<p.n, L::NTHR, L::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The models this build holds, one line each: (nx, ny, ntheta, nc) of the
// model on its flat terrain (dims.py), and every model of the JAX package
// that gives those dimensions. Every entry point below dispatches over both
// tables: KNOT_IP_MODELS for problems a warp holds (struct Lay),
// KNOT_IP_WIDE_MODELS for those past it (struct WLay, a block a problem).
// ops/knot_ip.py mirrors both tables (KNOT_IP_MODELS, KNOT_IP_WIDE_MODELS)
// and a test holds the mirror to these lines.
#define KNOT_IP_MODELS(X)                                               \
  X(11, 16, 34, 4) /* quadruped, quadruped_payload */                   \
  X(4, 4, 14, 1)   /* hopper_2d */                                      \
  X(9, 16, 28, 4)  /* flamingo */                                       \
  X(2, 4, 10, 1)   /* particle_2d */                                    \
  X(2, 8, 10, 2)   /* pushbot */                                        \
  X(4, 8, 15, 2)   /* walledcartpole */
#define KNOT_IP_WIDE_MODELS(X)                                          \
  X(18, 24, 53, 4) /* centroidal_quadruped (+ _undamped, _box),         \
                      point_foot_quadruped */                           \
  X(3, 6, 14, 1)   /* particle (ny % 4 != 0) */                         \
  X(7, 6, 22, 1)   /* hopper_3d */                                      \
  X(18, 48, 53, 8) /* centroidal_quadruped_wall (+ _slanted) */

}  // namespace

// Plain C entry points (bound with ctypes). The launches return their
// cudaGetLastError() code, -1 for dimensions this build does not hold and
// -2 for arguments the kernel does not take.

// Floats of one knot's packed block.
extern "C" int knot_ip_pack_floats(int nx, int ny, int nt, int nc) {
#define KNOT_IP_CASE(NX, NY, NT, NC) \
  if (nx == NX && ny == NY && nt == NT && nc == NC) return Lay<NX, NY, NT, NC>::kPack;
  KNOT_IP_MODELS(KNOT_IP_CASE)
#undef KNOT_IP_CASE
#define KNOT_IP_CASE(NX, NY, NT, NC) \
  if (nx == NX && ny == NY && nt == NT && nc == NC) return WLay<NX, NY, NT, NC>::kPack;
  KNOT_IP_WIDE_MODELS(KNOT_IP_CASE)
#undef KNOT_IP_CASE
  return -1;
}

// The per-knot constants alone: (K, pack_floats) into `pack`.
extern "C" int knot_ip_pack_launch(
    const float* z0_lin, const float* theta0, const float* r0, const float* rz0,
    const float* rtheta0, float* pack, int k, int nx, int ny, int nt, int nc,
    void* stream) {
  Params p{};
  p.z0_lin = z0_lin, p.theta0 = theta0, p.r0 = r0, p.rz0 = rz0;
  p.rtheta0 = rtheta0, p.pack = pack, p.k = k;
  if (k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KNOT_IP_CASE(NX, NY, NT, NC)                  \
  if (nx == NX && ny == NY && nt == NT && nc == NC) \
    return launch_pack<NX, NY, NT, NC>(p, s);
  KNOT_IP_MODELS(KNOT_IP_CASE)
#undef KNOT_IP_CASE
#define KNOT_IP_CASE(NX, NY, NT, NC)                  \
  if (nx == NX && ny == NY && nt == NT && nc == NC) \
    return launch_pack_wide<NX, NY, NT, NC>(p, s);
  KNOT_IP_WIDE_MODELS(KNOT_IP_CASE)
#undef KNOT_IP_CASE
  return -1;
}

// The whole solve: the per-knot constants into `pack`, then the problems.
extern "C" int knot_ip_launch(
    const float* z0_lin, const float* theta0, const float* r0, const float* rz0,
    const float* rtheta0, const float* alt, const float* theta,
    const float* q2_init, float* pack, float* z_out, uint8_t* conv_out,
    float* rvio_out, float* kvio_out, float* dz_out, int n, int k, int nx,
    int ny, int nt, int nc, int iters, int refine, int max_ls, float r_tol,
    float kappa_tol, float kappa_floor, float gamma_reg, float tau_min,
    float tau_max, void* stream) {
  Params p{z0_lin, theta0, r0, rz0, rtheta0, alt, theta, q2_init, pack,
           z_out, rvio_out, kvio_out, dz_out, conv_out,
           n, k, iters, refine, max_ls,
           r_tol, kappa_tol, kappa_floor, gamma_reg, tau_min, tau_max};
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KNOT_IP_CASE(NX, NY, NT, NC)                  \
  if (nx == NX && ny == NY && nt == NT && nc == NC) \
    return launch<NX, NY, NT, NC>(p, s);
  KNOT_IP_MODELS(KNOT_IP_CASE)
#undef KNOT_IP_CASE
#define KNOT_IP_CASE(NX, NY, NT, NC)                  \
  if (nx == NX && ny == NY && nt == NT && nc == NC) \
    return launch_wide<NX, NY, NT, NC>(p, s);
  KNOT_IP_WIDE_MODELS(KNOT_IP_CASE)
#undef KNOT_IP_CASE
  return -1;
}
