// Hand-written Hopper kernels for two Gauss-Hermite sums at d = 2 under the
// Van der Pol drift, forward and adjoint: Q and Q', the path term of the
// d = 2 CVI-DP step's KL (models/cvi_dp_packed_ch.py::_kl_packed_ch), and V
// and V', VDP's drift energy (models/vdp.py::VariationalMarkovGP.e_sde); and
// one at d = 1 under the double-well drift, F and F', the path term of the
// d = 1 step's KL (models/cvi_dp_packed.py::_kl_path), at the end of the file.
//
// They replace no TPU kernel: the JAX package computes both sums with XLA
// (vi_diffusion_processes_tpu/models/cvi_dp_packed_ch.py:256-323 and
// vi_diffusion_processes_tpu/sde/utils.py:111-131), and the port's plain
// versions are ops/quad_kl.py::quad_kl_plain and
// ops/vdp_energy.py::vdp_energy_plain.  For each transition n < N of the grid
// and each of the P points (z_p, w_p) of the Gauss-Hermite grid
// (P = 20^2 = 400), x_p = mu_n + sqrt(2) L_n z_p and f the Van der Pol drift:
//
//   Q:  diff_p = x_p + dt f(x_p) - (A_n x_p + b_n)
//       s_n    = sum_p w_p diff_p^T P_n diff_p
//   V:  diff_p = b_n - A_n x_p - f(x_p)
//       e_n    = sum_p w_p diff_p^T S diff_p          S = Sigma^-1, shared
//
// and the adjoints take g [N] to the cotangents of mu, L, A, b (and P for
// Q').  Plain PyTorch builds [N, P, 2] tensors for x, f(x), diff and their
// products, and autograd as many again: at N = 99,999 each is 640 MB of
// float64.  Here every point lives in registers only: 16 numbers a
// transition come in (17 for the adjoint) and 1 goes out (16), so the
// kernels are bound by operations, 47 a point forward
// (portbench/counts.py::quad_point_flops), not by bytes.
//
// Design:
//   * one point loop for both sums, quad_fwd and quad_bwd; the template
//     parameter Form selects the integrand: which matrix multiplies x, the
//     factor of f, and whether the weight matrix is each transition's P_n
//     or one shared S;
//   * a group of kGroup = 8 lanes shares one transition: lane r takes the
//     points r, r + 8, r + 16, ... (50 of the 400), and the group adds its
//     partial sums with __shfl_xor_sync; a block of 256 threads takes 32
//     transitions;
//   * the grid (sqrt(2) z and w) is staged in shared memory once a block, as
//     three arrays: at each step the 8 lanes of a group read 8 neighbouring
//     words, and the 4 groups of a warp the same 8 (a broadcast);
//   * each transition's inputs are read once into registers, with what the
//     points share computed once: I - A, P + P^T, tau*a, tau/a, dt*tau*a,
//     1/3;
//   * every product is taken in the inputs' type (float64 or float32), and
//     nothing is clamped: a NaN in L gives a NaN s_n or e_n, as the plain
//     path does, so the trainers' NaN rejection sees it.
// Q takes x + dt f(x) - (A x + b) as (I - A) x - b + dt f(x): the same
// function, whose terms are all of the size of diff, where the plain
// expression subtracts two sums of the size of x.  V takes the negated
// difference A x - b + f(x), which gives the same quadratic form: with
// M = A and a factor 1 for f, it is Q's expression.  dt, a, tau and S are
// read from device memory, so a CUDA graph captures no value of them.
//
// Interface: plain C launchers that return a cudaError_t as an int; they
// launch on the given stream, never synchronise and allocate nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;
constexpr int kPerBlock = kThreads / kGroup;
constexpr unsigned kFull = 0xffffffffu;
// the grid's three arrays stay within the 48 KB of shared memory a block may
// take without opting in
constexpr int kMaxPoints = 2048;

// The integrand: kKl is Q's (M = I - A_n, f times dt, weight P_n), kEnergy
// V's (M = A_n, f times 1, weight S shared by every transition).
enum class Form { kKl, kEnergy };

template <typename T, int G = kGroup>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One transition's inputs and what its points share.
template <typename T>
struct Transition {
  T mu0, mu1, l00, l01, l10, l11;
  T m00, m01, m10, m11;  // M: I - A (kKl), A (kEnergy)
  T b0, b1;
  T p00, p01, p10, p11;  // the weight matrix: P_n (kKl), S (kEnergy)
  T s00, s01, s11;  // P + P^T
};

template <typename T, Form F>
__device__ __forceinline__ Transition<T> load_transition(const T* __restrict__ mu,
                                                        const T* __restrict__ chol,
                                                        const T* __restrict__ a,
                                                        const T* __restrict__ b,
                                                        const T* __restrict__ p, int k) {
  Transition<T> t;
  t.mu0 = mu[2 * k], t.mu1 = mu[2 * k + 1];
  t.l00 = chol[4 * k], t.l01 = chol[4 * k + 1], t.l10 = chol[4 * k + 2], t.l11 = chol[4 * k + 3];
  if constexpr (F == Form::kKl) {
    t.m00 = T(1) - a[4 * k], t.m01 = -a[4 * k + 1];
    t.m10 = -a[4 * k + 2], t.m11 = T(1) - a[4 * k + 3];
  } else {
    t.m00 = a[4 * k], t.m01 = a[4 * k + 1];
    t.m10 = a[4 * k + 2], t.m11 = a[4 * k + 3];
  }
  t.b0 = b[2 * k], t.b1 = b[2 * k + 1];
  const int q = F == Form::kKl ? 4 * k : 0;
  t.p00 = p[q], t.p01 = p[q + 1], t.p10 = p[q + 2], t.p11 = p[q + 3];
  t.s00 = t.p00 + t.p00, t.s01 = t.p01 + t.p10, t.s11 = t.p11 + t.p11;
  return t;
}

// The factor of f in the difference: dt (kKl, from device memory), 1 (kEnergy).
template <typename T, Form F>
__device__ __forceinline__ T drift_factor(const T* __restrict__ dt_ptr) {
  if constexpr (F == Form::kKl) {
    return *dt_ptr;
  } else {
    return T(1);
  }
}

// The grid in shared memory: sqrt(2) z_p in z0, z1 and w_p in w.
template <typename T>
__device__ __forceinline__ void stage_grid(const T* __restrict__ z, const T* __restrict__ w,
                                           int np, T* z0, T* z1, T* ws) {
  const T sqrt2 = T(1.4142135623730951);
  for (int p = threadIdx.x; p < np; p += kThreads) {
    z0[p] = sqrt2 * z[2 * p];
    z1[p] = sqrt2 * z[2 * p + 1];
    ws[p] = w[p];
  }
  __syncthreads();
}

// s[k] = sum_p w_p diff_p^T P diff_p with diff_p = M x_p - b + dt f(x_p).
template <typename T, Form F>
__device__ __forceinline__ void quad_fwd(const T* __restrict__ mu, const T* __restrict__ chol,
                                         const T* __restrict__ a, const T* __restrict__ b,
                                         const T* __restrict__ p, const T* __restrict__ z,
                                         const T* __restrict__ w, const T* __restrict__ dt_ptr,
                                         const T* __restrict__ a_ptr,
                                         const T* __restrict__ tau_ptr, T* __restrict__ s, int n,
                                         int np) {
  extern __shared__ unsigned char smem[];
  T* z0 = reinterpret_cast<T*>(smem);
  T* z1 = z0 + np;
  T* ws = z1 + np;
  stage_grid(z, w, np, z0, z1, ws);

  const int lane = threadIdx.x % kGroup;
  const int k = blockIdx.x * kPerBlock + threadIdx.x / kGroup;
  // a group past the end computes the last transition again, so that every
  // lane of the warp takes part in the shuffles, and writes nothing
  const Transition<T> t = load_transition<T, F>(mu, chol, a, b, p, k < n ? k : n - 1);
  const T dt = drift_factor<T, F>(dt_ptr), ta = *tau_ptr * *a_ptr,
          tia = *tau_ptr * (T(1) / *a_ptr);
  const T third = T(1) / T(3);

  T acc = T(0);
#pragma unroll 2
  for (int i = lane; i < np; i += kGroup) {
    const T zz0 = z0[i], zz1 = z1[i];
    const T x0 = t.mu0 + (t.l00 * zz0 + t.l01 * zz1);
    const T x1 = t.mu1 + (t.l10 * zz0 + t.l11 * zz1);
    const T f0 = ta * (x0 - x0 * x0 * x0 * third - x1);
    const T f1 = tia * x0;
    const T d0 = (t.m00 * x0 + t.m01 * x1 - t.b0) + dt * f0;
    const T d1 = (t.m10 * x0 + t.m11 * x1 - t.b1) + dt * f1;
    const T q = d0 * (t.p00 * d0 + t.p01 * d1) + d1 * (t.p10 * d0 + t.p11 * d1);
    acc += ws[i] * q;
  }
  acc = group_sum(acc);
  if (k < n && lane == 0) s[k] = acc;
}

// The cotangents of quad_fwd's s for g_s.  g per transition, the matrices
// row-major: kKl [n, 16], mu (2), L (4), A (4), b (2), P (4); kEnergy
// [n, 12], mu (2), L (4), A (4), b (2).
template <typename T, Form F>
__device__ __forceinline__ void quad_bwd(const T* __restrict__ g_s, const T* __restrict__ mu,
                                         const T* __restrict__ chol, const T* __restrict__ a,
                                         const T* __restrict__ b, const T* __restrict__ p,
                                         const T* __restrict__ z, const T* __restrict__ w,
                                         const T* __restrict__ dt_ptr,
                                         const T* __restrict__ a_ptr,
                                         const T* __restrict__ tau_ptr, T* __restrict__ g, int n,
                                         int np) {
  extern __shared__ unsigned char smem[];
  T* z0 = reinterpret_cast<T*>(smem);
  T* z1 = z0 + np;
  T* ws = z1 + np;
  stage_grid(z, w, np, z0, z1, ws);

  const int lane = threadIdx.x % kGroup;
  const int k = blockIdx.x * kPerBlock + threadIdx.x / kGroup;
  const int kk = k < n ? k : n - 1;
  const Transition<T> t = load_transition<T, F>(mu, chol, a, b, p, kk);
  const T dt = drift_factor<T, F>(dt_ptr), ta = *tau_ptr * *a_ptr,
          tia = *tau_ptr * (T(1) / *a_ptr);
  const T third = T(1) / T(3);
  // (M + dt J_f)^T with J_f = [[ta (1 - x0^2), -ta], [tia, 0]]: only its
  // (0, 0) entry changes from point to point
  const T dtta = dt * ta;
  const T k00_at0 = t.m00 + dtta, k01 = t.m01 - dtta, k10 = t.m10 + dt * tia, k11 = t.m11;

  // the sums over the lane's points, each without the factor g_s
  T gmu0 = 0, gmu1 = 0;                    // sum gx
  T gl00 = 0, gl01 = 0, gl10 = 0, gl11 = 0;  // sum gx (sqrt2 z)^T
  T ga00 = 0, ga01 = 0, ga10 = 0, ga11 = 0;  // sum u x^T
  T gb0 = 0, gb1 = 0;                      // sum u
  T gp00 = 0, gp01 = 0, gp11 = 0;          // sum w diff diff^T (kKl)
#pragma unroll 2
  for (int i = lane; i < np; i += kGroup) {
    const T zz0 = z0[i], zz1 = z1[i], wi = ws[i];
    const T x0 = t.mu0 + (t.l00 * zz0 + t.l01 * zz1);
    const T x1 = t.mu1 + (t.l10 * zz0 + t.l11 * zz1);
    const T xx = x0 * x0;
    const T f0 = ta * (x0 - xx * x0 * third - x1);
    const T f1 = tia * x0;
    const T d0 = (t.m00 * x0 + t.m01 * x1 - t.b0) + dt * f0;
    const T d1 = (t.m10 * x0 + t.m11 * x1 - t.b1) + dt * f1;
    // u = w (P + P^T) diff: the cotangent of diff over g_s
    const T u0 = wi * (t.s00 * d0 + t.s01 * d1);
    const T u1 = wi * (t.s01 * d0 + t.s11 * d1);
    // gx = (M + dt J_f)^T u
    const T k00 = k00_at0 - dtta * xx;
    const T gx0 = k00 * u0 + k10 * u1;
    const T gx1 = k01 * u0 + k11 * u1;
    gmu0 += gx0, gmu1 += gx1;
    gl00 += gx0 * zz0, gl01 += gx0 * zz1, gl10 += gx1 * zz0, gl11 += gx1 * zz1;
    ga00 += u0 * x0, ga01 += u0 * x1, ga10 += u1 * x0, ga11 += u1 * x1;
    gb0 += u0, gb1 += u1;
    if constexpr (F == Form::kKl) {
      const T wd0 = wi * d0;
      gp00 += wd0 * d0, gp01 += wd0 * d1, gp11 += wi * d1 * d1;
    }
  }
  gmu0 = group_sum(gmu0), gmu1 = group_sum(gmu1);
  gl00 = group_sum(gl00), gl01 = group_sum(gl01), gl10 = group_sum(gl10);
  gl11 = group_sum(gl11);
  ga00 = group_sum(ga00), ga01 = group_sum(ga01), ga10 = group_sum(ga10);
  ga11 = group_sum(ga11);
  gb0 = group_sum(gb0), gb1 = group_sum(gb1);
  if constexpr (F == Form::kKl) {
    gp00 = group_sum(gp00), gp01 = group_sum(gp01), gp11 = group_sum(gp11);
    if (k < n && lane == 0) {
      const T gs = g_s[k];
      T* out = g + 16 * static_cast<long long>(k);
      out[0] = gs * gmu0, out[1] = gs * gmu1;
      out[2] = gs * gl00, out[3] = gs * gl01, out[4] = gs * gl10, out[5] = gs * gl11;
      out[6] = -gs * ga00, out[7] = -gs * ga01, out[8] = -gs * ga10, out[9] = -gs * ga11;
      out[10] = -gs * gb0, out[11] = -gs * gb1;
      out[12] = gs * gp00, out[13] = gs * gp01, out[14] = gs * gp01, out[15] = gs * gp11;
    }
  } else if (k < n && lane == 0) {
    // M = A here, where Q's M = I - A: the cotangent of A changes sign
    const T gs = g_s[k];
    T* out = g + 12 * static_cast<long long>(k);
    out[0] = gs * gmu0, out[1] = gs * gmu1;
    out[2] = gs * gl00, out[3] = gs * gl01, out[4] = gs * gl10, out[5] = gs * gl11;
    out[6] = gs * ga00, out[7] = gs * ga01, out[8] = gs * ga10, out[9] = gs * ga11;
    out[10] = -gs * gb0, out[11] = -gs * gb1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quad_kl_fwd_kernel(const T* __restrict__ mu, const T* __restrict__ chol,
                       const T* __restrict__ a, const T* __restrict__ b,
                       const T* __restrict__ p, const T* __restrict__ z,
                       const T* __restrict__ w, const T* __restrict__ dt_ptr,
                       const T* __restrict__ a_ptr, const T* __restrict__ tau_ptr,
                       T* __restrict__ s, int n, int np) {
  quad_fwd<T, Form::kKl>(mu, chol, a, b, p, z, w, dt_ptr, a_ptr, tau_ptr, s, n, np);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quad_kl_bwd_kernel(const T* __restrict__ g_s, const T* __restrict__ mu,
                       const T* __restrict__ chol, const T* __restrict__ a,
                       const T* __restrict__ b, const T* __restrict__ p,
                       const T* __restrict__ z, const T* __restrict__ w,
                       const T* __restrict__ dt_ptr, const T* __restrict__ a_ptr,
                       const T* __restrict__ tau_ptr, T* __restrict__ g, int n, int np) {
  quad_bwd<T, Form::kKl>(g_s, mu, chol, a, b, p, z, w, dt_ptr, a_ptr, tau_ptr, g, n, np);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vdp_energy_fwd_kernel(const T* __restrict__ mu, const T* __restrict__ chol,
                          const T* __restrict__ a, const T* __restrict__ b,
                          const T* __restrict__ sigma_inv, const T* __restrict__ z,
                          const T* __restrict__ w, const T* __restrict__ a_ptr,
                          const T* __restrict__ tau_ptr, T* __restrict__ e, int n, int np) {
  quad_fwd<T, Form::kEnergy>(mu, chol, a, b, sigma_inv, z, w, nullptr, a_ptr, tau_ptr, e, n,
                             np);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vdp_energy_bwd_kernel(const T* __restrict__ g_e, const T* __restrict__ mu,
                          const T* __restrict__ chol, const T* __restrict__ a,
                          const T* __restrict__ b, const T* __restrict__ sigma_inv,
                          const T* __restrict__ z, const T* __restrict__ w,
                          const T* __restrict__ a_ptr, const T* __restrict__ tau_ptr,
                          T* __restrict__ g, int n, int np) {
  quad_bwd<T, Form::kEnergy>(g_e, mu, chol, a, b, sigma_inv, z, w, nullptr, a_ptr, tau_ptr, g,
                             n, np);
}

inline int blocks(int n) { return (n + kPerBlock - 1) / kPerBlock; }

template <typename T>
inline size_t smem_bytes(int np) { return 3 * static_cast<size_t>(np) * sizeof(T); }

inline bool valid(int n, int np) { return n >= 1 && np >= 1 && np <= kMaxPoints; }

template <typename T>
int launch_fwd(const T* mu, const T* chol, const T* a, const T* b, const T* p, const T* z,
               const T* w, const T* dt, const T* da, const T* tau, T* s, int n, int np,
               void* stream) {
  if (!valid(n, np)) return static_cast<int>(cudaErrorInvalidValue);
  quad_kl_fwd_kernel<T><<<blocks(n), kThreads, smem_bytes<T>(np),
                          static_cast<cudaStream_t>(stream)>>>(mu, chol, a, b, p, z, w, dt, da,
                                                               tau, s, n, np);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const T* g_s, const T* mu, const T* chol, const T* a, const T* b, const T* p,
               const T* z, const T* w, const T* dt, const T* da, const T* tau, T* g, int n,
               int np, void* stream) {
  if (!valid(n, np)) return static_cast<int>(cudaErrorInvalidValue);
  quad_kl_bwd_kernel<T><<<blocks(n), kThreads, smem_bytes<T>(np),
                          static_cast<cudaStream_t>(stream)>>>(g_s, mu, chol, a, b, p, z, w, dt,
                                                               da, tau, g, n, np);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_energy_fwd(const T* mu, const T* chol, const T* a, const T* b, const T* sigma_inv,
                      const T* z, const T* w, const T* da, const T* tau, T* e, int n, int np,
                      void* stream) {
  if (!valid(n, np)) return static_cast<int>(cudaErrorInvalidValue);
  vdp_energy_fwd_kernel<T><<<blocks(n), kThreads, smem_bytes<T>(np),
                             static_cast<cudaStream_t>(stream)>>>(mu, chol, a, b, sigma_inv, z,
                                                                  w, da, tau, e, n, np);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_energy_bwd(const T* g_e, const T* mu, const T* chol, const T* a, const T* b,
                      const T* sigma_inv, const T* z, const T* w, const T* da, const T* tau,
                      T* g, int n, int np, void* stream) {
  if (!valid(n, np)) return static_cast<int>(cudaErrorInvalidValue);
  vdp_energy_bwd_kernel<T><<<blocks(n), kThreads, smem_bytes<T>(np),
                             static_cast<cudaStream_t>(stream)>>>(g_e, mu, chol, a, b, sigma_inv,
                                                                  z, w, da, tau, g, n, np);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------- d = 1
// F and F': the path term of the d = 1 KL (models/cvi_dp_packed.py::_kl_path)
// under the double-well drift f(x) = scale x (c - x^2).  They replace no TPU
// kernel either: the JAX package computes the term with XLA
// (vi_diffusion_processes_tpu/models/cvi_dp_packed.py:251-286), and the
// port's plain version is ops/quad_kl.py::quad_kl_1d_plain.  For each pair
// n < N = T - 1 of the grid, from q's expectation parameters e1 = E[x],
// ed = E[x^2] at both ends and es = E[x_n x_n+1]:
//
//   v_k = ed_k - e1_k^2,  cov = es_n - e1_n e1_n+1,  a = cov / v_n,
//   b = e1_n+1 - a e1_n,  qv = v_n+1 - a^2 v_n,  L = sqrt(v_n + jitter),
//   x_p = e1_n + sqrt(2) L z_p,  diff_p = (1 - a) x_p - b + dt f(x_p),
//   s_n = sum_p w_p diff_p^2 / pv_n - (log qv - log pv_n) - 1 + qv / pv_n,
//
// with P = 20 points (z_p, w_p) and pv_n p's process variance.  Plain
// PyTorch builds [N, P] float64 tensors for x, f(x), both forward maps, their
// difference and its square, 16 MB each at T = 100,000, and autograd as many
// again.  Here 4 numbers a pair come in and 1 goes out: about 30 bytes and
// 20 x 15 operations a pair, so neither bound is near and a launch costs its
// latency.  The adjoint F' takes g [N] to the cotangents of e1, ed (each
// grid point touches two pairs) and es; with p's initial mean and variance
// it adds the gradient of KL_0 = KL[N(e1_0, v_0) || N(mu_0, var_0)] at
// point 0, so that one launch is the Girsanov gradient of the whole KL.
//
// Design:
//   * kGroup1 = 4 lanes share one pair (F) or one grid point (F'): lane r
//     takes the points r, r + 4, ...; a block of 256 threads takes 64; the
//     grid is read from device memory, where the 4 lanes of a group read 4
//     neighbouring words and every group of a warp the same ones;
//   * F' gives every grid point k its own group, which recomputes its two
//     pairs k - 1 and k and adds their parts: no atomics, so every run gives
//     the same bits; a group at the grid's ends computes a clamped pair and
//     discards it, so that every lane takes part in the shuffles;
//   * diff is taken as (1 - a) x - b + dt f(x), whose terms have the size of
//     diff, where x + dt f(x) - (a x + b) subtracts two terms of the size of x;
//   * the pair's closed forms (v, cov, a, b, qv, L) and the adjoint's chain
//     rule take no fused multiply-add (mul_rn, sub_rn): cov = es - e1 e1' and
//     qv = v' - a^2 v cancel three digits or more, and 1/qv enters the
//     cotangents, so they are rounded as the plain route's separate PyTorch
//     operations round them; the point loops contract freely;
//   * every product is taken in the inputs' type, and nothing is clamped.
// pv and g may be one value broadcast over the pairs (stride 0) or [N]; dt,
// the jitter and the drift's (scale, c) are read from device memory, so that
// a CUDA graph captures no value of them.
constexpr int kGroup1 = 4;
constexpr int kPerBlock1 = kThreads / kGroup1;

// Products, sums and differences rounded each on its own (no fused
// multiply-add); division and sqrt round correctly by default.
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// One pair's quantities and the part of its summand the points share.
template <typename T>
struct Pair {
  T m0, m1, v0, a, b, qv, pv, l, sl;
};

template <typename T>
__device__ __forceinline__ Pair<T> load_pair(const T* __restrict__ e1, const T* __restrict__ ed,
                                             const T* __restrict__ es, const T* __restrict__ pv,
                                             int pv_stride, T jitter, int k) {
  Pair<T> p;
  p.m0 = e1[k], p.m1 = e1[k + 1];
  p.v0 = sub_rn(ed[k], mul_rn(p.m0, p.m0));
  const T v1 = sub_rn(ed[k + 1], mul_rn(p.m1, p.m1));
  p.a = sub_rn(es[k], mul_rn(p.m0, p.m1)) / p.v0;
  p.b = sub_rn(p.m1, mul_rn(p.a, p.m0));
  p.qv = sub_rn(v1, mul_rn(mul_rn(p.a, p.a), p.v0));
  p.pv = pv[static_cast<long long>(k) * pv_stride];
  p.l = sqrt(add_rn(p.v0, jitter));
  p.sl = mul_rn(T(1.4142135623730951), p.l);
  return p;
}

// The closed-form C term -(log qv - log pv) - 1 + qv / pv.
template <typename T>
__device__ __forceinline__ T c_term(const Pair<T>& p) {
  return -(log(p.qv) - log(p.pv)) - T(1) + p.qv / p.pv;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quad_kl_1d_fwd_kernel(const T* __restrict__ e1, const T* __restrict__ ed,
                          const T* __restrict__ es, const T* __restrict__ pv, int pv_stride,
                          const T* __restrict__ z, const T* __restrict__ w,
                          const T* __restrict__ dt_ptr, const T* __restrict__ jitter_ptr,
                          const T* __restrict__ scale_ptr, const T* __restrict__ c_ptr,
                          T* __restrict__ s, int n, int np) {
  const int lane = threadIdx.x % kGroup1;
  const int k = blockIdx.x * kPerBlock1 + threadIdx.x / kGroup1;
  const Pair<T> p = load_pair(e1, ed, es, pv, pv_stride, *jitter_ptr, k < n ? k : n - 1);
  const T dt = *dt_ptr, scale = *scale_ptr, cc = *c_ptr, one_a = T(1) - p.a;
  T acc = T(0);
  for (int i = lane; i < np; i += kGroup1) {
    const T x = p.m0 + p.sl * z[i];
    const T d = (one_a * x - p.b) + dt * (scale * x * (cc - x * x));
    acc += w[i] * (d * d);
  }
  acc = group_sum<T, kGroup1>(acc);
  if (k < n && lane == 0) s[k] = acc / p.pv + c_term(p);
}

// One pair's cotangents for its cotangent g: of e1 and ed at its left (m0,
// v0 -> ed) and right (m1, v1 -> ed) ends, and of es.
template <typename T>
struct PairGrad {
  T m0, ed0, m1, ed1, es;
};

template <typename T>
__device__ __forceinline__ PairGrad<T> pair_adjoint(const Pair<T>& p, T g,
                                                    const T* __restrict__ z,
                                                    const T* __restrict__ w, int np, int lane,
                                                    T dt, T scale, T cc) {
  const T one_a = T(1) - p.a;
  // sums over the lane's points of u = w diff, u z, gx = u (1 - a + dt f'(x))
  // and gx z, each without the factor 2 g / pv
  T su = 0, suz = 0, sgx = 0, sgxz = 0;
  for (int i = lane; i < np; i += kGroup1) {
    const T zi = z[i];
    const T x = p.m0 + p.sl * zi;
    const T xx = x * x;
    const T u = w[i] * ((one_a * x - p.b) + dt * (scale * x * (cc - xx)));
    const T gx = u * (one_a + dt * (scale * (cc - T(3) * xx)));
    su += u, suz += u * zi, sgx += gx, sgxz += gx * zi;
  }
  su = group_sum<T, kGroup1>(su), suz = group_sum<T, kGroup1>(suz);
  sgx = group_sum<T, kGroup1>(sgx), sgxz = group_sum<T, kGroup1>(sgxz);
  const T k = mul_rn(T(2), g) / p.pv;
  const T gb = mul_rn(-k, su);                                           // b
  const T g_l = mul_rn(k, mul_rn(T(1.4142135623730951), sgxz));          // L
  const T gqv = mul_rn(g, sub_rn(T(1) / p.pv, T(1) / p.qv));  // qv, from the C term
  // a: through the points and b = m1 - a m0 together -k sum u (x - m0),
  // which is -k sqrt(2) L sum u z and cancels nothing; and qv = v1 - a^2 v0
  const T ga = sub_rn(mul_rn(mul_rn(-k, p.sl), suz),
                      mul_rn(mul_rn(mul_rn(T(2), p.a), p.v0), gqv));
  const T gcov = ga / p.v0;                                              // a = cov / v0
  const T gv0 = sub_rn(add_rn(mul_rn(mul_rn(-p.a, p.a), gqv), g_l / mul_rn(T(2), p.l)),
                       mul_rn(ga, p.a) / p.v0);
  PairGrad<T> r;
  r.m0 = sub_rn(sub_rn(sub_rn(mul_rn(k, sgx), mul_rn(gb, p.a)), mul_rn(gcov, p.m1)),
                mul_rn(mul_rn(T(2), p.m0), gv0));
  r.ed0 = gv0;
  r.m1 = sub_rn(sub_rn(gb, mul_rn(gcov, p.m0)), mul_rn(mul_rn(T(2), p.m1), gqv));
  r.ed1 = gqv;
  r.es = gcov;
  return r;
}

// g_out [3, n + 1]: the cotangents of e1, ed and es (the last column of the
// third row 0).  mu0, var0 (p's initial mean and variance) may be null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quad_kl_1d_bwd_kernel(const T* __restrict__ g, int g_stride, const T* __restrict__ e1,
                          const T* __restrict__ ed, const T* __restrict__ es,
                          const T* __restrict__ pv, int pv_stride, const T* __restrict__ z,
                          const T* __restrict__ w, const T* __restrict__ dt_ptr,
                          const T* __restrict__ jitter_ptr, const T* __restrict__ scale_ptr,
                          const T* __restrict__ c_ptr, const T* __restrict__ mu0_ptr,
                          const T* __restrict__ var0_ptr, T* __restrict__ g_out, int n,
                          int np) {
  const int lane = threadIdx.x % kGroup1;
  const int t = blockIdx.x * kPerBlock1 + threadIdx.x / kGroup1;  // the grid point
  const int tt = t < n ? t : n;
  const T dt = *dt_ptr, jitter = *jitter_ptr, scale = *scale_ptr, cc = *c_ptr;
  // the pair on the right (t) and on the left (t - 1), clamped into [0, n)
  const int kr = tt < n ? tt : n - 1, kl = tt > 0 ? tt - 1 : 0;
  const PairGrad<T> right =
      pair_adjoint(load_pair(e1, ed, es, pv, pv_stride, jitter, kr),
                   g[static_cast<long long>(kr) * g_stride], z, w, np, lane, dt, scale, cc);
  const PairGrad<T> left =
      pair_adjoint(load_pair(e1, ed, es, pv, pv_stride, jitter, kl),
                   g[static_cast<long long>(kl) * g_stride], z, w, np, lane, dt, scale, cc);
  if (t > n || lane != 0) return;
  T ge1 = T(0), ged = T(0);
  if (t < n) ge1 = right.m0, ged = right.ed0;
  if (t > 0) ge1 += left.m1, ged += left.ed1;
  if (t == 0 && mu0_ptr != nullptr) {
    // KL_0 = (v0 / var0 + (mu0 - e1_0)^2 / var0 - 1 + log(var0 / v0)) / 2
    const T m = e1[0], var0 = *var0_ptr;
    const T gv = mul_rn(T(0.5), sub_rn(T(1) / var0, T(1) / sub_rn(ed[0], mul_rn(m, m))));
    ge1 = add_rn(ge1, sub_rn(sub_rn(m, *mu0_ptr) / var0, mul_rn(mul_rn(T(2), m), gv)));
    ged = add_rn(ged, gv);
  }
  const long long cols = static_cast<long long>(n) + 1;
  g_out[t] = ge1;
  g_out[cols + t] = ged;
  g_out[2 * cols + t] = t < n ? right.es : T(0);
}

inline int blocks1(int n) { return (n + kPerBlock1 - 1) / kPerBlock1; }

inline bool valid1(int n, int np, int pv_stride) {
  return n >= 1 && np >= 1 && (pv_stride == 0 || pv_stride == 1);
}

template <typename T>
int launch_1d_fwd(const T* e1, const T* ed, const T* es, const T* pv, int pv_stride,
                  const T* z, const T* w, const T* dt, const T* jitter, const T* scale,
                  const T* c, T* s, int n, int np, void* stream) {
  if (!valid1(n, np, pv_stride)) return static_cast<int>(cudaErrorInvalidValue);
  quad_kl_1d_fwd_kernel<T><<<blocks1(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      e1, ed, es, pv, pv_stride, z, w, dt, jitter, scale, c, s, n, np);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_1d_bwd(const T* g, int g_stride, const T* e1, const T* ed, const T* es, const T* pv,
                  int pv_stride, const T* z, const T* w, const T* dt, const T* jitter,
                  const T* scale, const T* c, const T* mu0, const T* var0, T* g_out, int n,
                  int np, void* stream) {
  if (!valid1(n, np, pv_stride) || (g_stride != 0 && g_stride != 1) ||
      ((mu0 == nullptr) != (var0 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  quad_kl_1d_bwd_kernel<T><<<blocks1(n + 1), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, g_stride, e1, ed, es, pv, pv_stride, z, w, dt, jitter, scale, c, mu0, var0, g_out, n,
      np);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch of any of the four kernels for n transitions and np points:
// out[0] the grid, out[1] threads per block, out[2] lanes per transition,
// out[3] bytes of dynamic shared memory in float64, out[4] the most points
// it takes.
int vidp_quad_kl_shape(int n, int np, int* out) {
  if (!valid(n, np)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = blocks(n);
  out[1] = kThreads;
  out[2] = kGroup;
  out[3] = static_cast<int>(smem_bytes<double>(np));
  out[4] = kMaxPoints;
  return 0;
}

// s [n] from mu [n, 2], L, A [n, 2, 2], b [n, 2], P [n, 2, 2], the grid
// z [np, 2], w [np], and dt, a, tau as 0-d device tensors.
int vidp_quad_kl_fwd_f64(const double* mu, const double* chol, const double* a,
                         const double* b, const double* p, const double* z, const double* w,
                         const double* dt, const double* da, const double* tau, double* s,
                         int n, int np, void* stream) {
  return launch_fwd<double>(mu, chol, a, b, p, z, w, dt, da, tau, s, n, np, stream);
}

int vidp_quad_kl_fwd_f32(const float* mu, const float* chol, const float* a, const float* b,
                         const float* p, const float* z, const float* w, const float* dt,
                         const float* da, const float* tau, float* s, int n, int np,
                         void* stream) {
  return launch_fwd<float>(mu, chol, a, b, p, z, w, dt, da, tau, s, n, np, stream);
}

// g [n, 16] (see quad_bwd) from g_s [n] and the forward's inputs.
int vidp_quad_kl_bwd_f64(const double* g_s, const double* mu, const double* chol,
                         const double* a, const double* b, const double* p, const double* z,
                         const double* w, const double* dt, const double* da, const double* tau,
                         double* g, int n, int np, void* stream) {
  return launch_bwd<double>(g_s, mu, chol, a, b, p, z, w, dt, da, tau, g, n, np, stream);
}

int vidp_quad_kl_bwd_f32(const float* g_s, const float* mu, const float* chol, const float* a,
                         const float* b, const float* p, const float* z, const float* w,
                         const float* dt, const float* da, const float* tau, float* g, int n,
                         int np, void* stream) {
  return launch_bwd<float>(g_s, mu, chol, a, b, p, z, w, dt, da, tau, g, n, np, stream);
}

// e [n] from mu [n, 2], L, A [n, 2, 2], b [n, 2], S = Sigma^-1 [2, 2], the
// grid z [np, 2], w [np], and a, tau as 0-d device tensors.
int vidp_vdp_energy_fwd_f64(const double* mu, const double* chol, const double* a,
                            const double* b, const double* sigma_inv, const double* z,
                            const double* w, const double* da, const double* tau, double* e,
                            int n, int np, void* stream) {
  return launch_energy_fwd<double>(mu, chol, a, b, sigma_inv, z, w, da, tau, e, n, np, stream);
}

int vidp_vdp_energy_fwd_f32(const float* mu, const float* chol, const float* a, const float* b,
                            const float* sigma_inv, const float* z, const float* w,
                            const float* da, const float* tau, float* e, int n, int np,
                            void* stream) {
  return launch_energy_fwd<float>(mu, chol, a, b, sigma_inv, z, w, da, tau, e, n, np, stream);
}

// g [n, 12] (see quad_bwd) from g_e [n] and the forward's inputs.
int vidp_vdp_energy_bwd_f64(const double* g_e, const double* mu, const double* chol,
                            const double* a, const double* b, const double* sigma_inv,
                            const double* z, const double* w, const double* da,
                            const double* tau, double* g, int n, int np, void* stream) {
  return launch_energy_bwd<double>(g_e, mu, chol, a, b, sigma_inv, z, w, da, tau, g, n, np,
                                   stream);
}

int vidp_vdp_energy_bwd_f32(const float* g_e, const float* mu, const float* chol,
                            const float* a, const float* b, const float* sigma_inv,
                            const float* z, const float* w, const float* da, const float* tau,
                            float* g, int n, int np, void* stream) {
  return launch_energy_bwd<float>(g_e, mu, chol, a, b, sigma_inv, z, w, da, tau, g, n, np,
                                  stream);
}

// The launch of F for n pairs: out[0] its grid, out[1] threads per block,
// out[2] lanes per pair; F' takes the grid of n + 1 grid points.
int vidp_quad_kl_1d_shape(int n, int* out) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = blocks1(n);
  out[1] = kThreads;
  out[2] = kGroup1;
  return 0;
}

// s [n] from e1, ed [n + 1], es [n], pv [n] (pv_stride 1) or one value
// (pv_stride 0), the grid z, w [np], and dt, the jitter, scale and c as 0-d
// device tensors.
int vidp_quad_kl_1d_fwd_f64(const double* e1, const double* ed, const double* es,
                            const double* pv, int pv_stride, const double* z, const double* w,
                            const double* dt, const double* jitter, const double* scale,
                            const double* c, double* s, int n, int np, void* stream) {
  return launch_1d_fwd<double>(e1, ed, es, pv, pv_stride, z, w, dt, jitter, scale, c, s, n, np,
                               stream);
}

int vidp_quad_kl_1d_fwd_f32(const float* e1, const float* ed, const float* es, const float* pv,
                            int pv_stride, const float* z, const float* w, const float* dt,
                            const float* jitter, const float* scale, const float* c, float* s,
                            int n, int np, void* stream) {
  return launch_1d_fwd<float>(e1, ed, es, pv, pv_stride, z, w, dt, jitter, scale, c, s, n, np,
                              stream);
}

// g_out [3, n + 1] (see quad_kl_1d_bwd_kernel) from g [n] (g_stride 1) or
// one value (g_stride 0), the forward's inputs, and p's initial mean and
// variance as 0-d device tensors, or both null.
int vidp_quad_kl_1d_bwd_f64(const double* g, int g_stride, const double* e1, const double* ed,
                            const double* es, const double* pv, int pv_stride, const double* z,
                            const double* w, const double* dt, const double* jitter,
                            const double* scale, const double* c, const double* mu0,
                            const double* var0, double* g_out, int n, int np, void* stream) {
  return launch_1d_bwd<double>(g, g_stride, e1, ed, es, pv, pv_stride, z, w, dt, jitter, scale,
                               c, mu0, var0, g_out, n, np, stream);
}

int vidp_quad_kl_1d_bwd_f32(const float* g, int g_stride, const float* e1, const float* ed,
                            const float* es, const float* pv, int pv_stride, const float* z,
                            const float* w, const float* dt, const float* jitter,
                            const float* scale, const float* c, const float* mu0,
                            const float* var0, float* g_out, int n, int np, void* stream) {
  return launch_1d_bwd<float>(g, g_stride, e1, ed, es, pv, pv_stride, z, w, dt, jitter, scale, c,
                              mu0, var0, g_out, n, np, stream);
}

}  // extern "C"
