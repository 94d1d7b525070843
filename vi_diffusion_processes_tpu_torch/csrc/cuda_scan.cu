// Hand-written Hopper kernels for the d=1 CVI-DP hot loop.
//
// They replace the Pallas TPU kernels of
// vi_diffusion_processes_tpu/ops/pallas_scan.py:
//
//   K1  riccati_kernel   <- riccati_d_sweep_df / _riccati_kernel
//       UDU' pivot sweep  D_k = kd_k - b2_k / D_{k+1}   (b2[N-1] = 0)
//   K2  linrec_kernel    <- linear_recurrence / _linrec_kernel_{df,f32}
//       x_k = t_k * x_{k-+1} + c_k, forward or reverse, boundary value x0
//   K3  dist_q_kernel    <- dist_q_1d_planes / _dist_q_kernel
//       naturals -> SSM params -> marginals, the whole d=1 chain in one launch
//
// What bounds them on an H100: the latency of a sequential dependency chain,
// not bytes.  At T = 100k every f64 plane is 0.8 MB, which the card streams in
// well under a microsecond; the chain is T dependent divisions and FMAs.
//
// What the design does about it: one thread block per sequence (gridDim.x is
// the batch) of 1024 threads.  Thread j owns the contiguous chunk
// [j*l, (j+1)*l), l = ceil(N/1024), and the recursion runs in the TPU
// kernel's three phases:
//   A. each thread composes its chunk's map sequentially (an affine map for
//      the linear recurrences, a normalised 2x2 Moebius map for the sweep);
//   B. a Hillis-Steele inclusive scan of the 1024 maps in shared memory, in
//      window order (suffix for reverse recurrences and the sweep, prefix
//      for forward ones);
//   C. each thread re-runs its chunk exactly from its boundary value.
// The sequential depth drops from N to about 2*l + 2*log2(1024).
// Everything is native f64 (Hopper has FP64 units), so the TPU's
// double-float (hi, lo) f32 arithmetic is not carried over.
//
// Known costs, left for later work: a thread walks its own chunk, so the
// loads and stores of a warp are strided and uncoalesced; one block per
// sequence keeps a single SM busy.  Coalescing through shared memory,
// multi-block decoupled look-back and CUDA graphs are the next steps.
//
// Interface: plain C launchers that return cudaGetLastError() as an int.
// They launch on the given stream, never synchronise and allocate nothing:
// outputs and scratch come from the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

// This thread's chunk [start, end) of a length-n sequence.
__device__ __forceinline__ void chunk_of(int n, int& start, int& end) {
  const int l = (n + kThreads - 1) / kThreads;
  start = min(static_cast<int>(threadIdx.x) * l, n);
  end = min(start + l, n);
}

// Diagonal preconditioner of the sweep: s = sqrt(b2), or |kd| where b2 = 0
// (pallas_scan.py:359).  Any positive s leaves the algebra exact; it keeps
// the Moebius maps O(1)-conditioned.
__device__ __forceinline__ double precond(double kd, double b2) {
  return b2 > 0.0 ? sqrt(b2) : fabs(kd) + 1e-300;
}

// Phase B for affine maps x -> a*x + b.  Scans the block's window maps
// (prefix, or suffix when reverse) and returns the value entering this
// thread's chunk, given the boundary value x0 of the whole sequence.
// sA and sB are kThreads-long shared arrays; they are free again on return.
template <typename T>
__device__ T affine_entry(T a, T b, T x0, T* sA, T* sB, bool reverse) {
  const int j = threadIdx.x;
  sA[j] = a;
  sB[j] = b;
  __syncthreads();
  for (int sh = 1; sh < kThreads; sh <<= 1) {
    const int src = reverse ? j + sh : j - sh;
    const bool ok = reverse ? src < kThreads : src >= 0;
    const T pa = ok ? sA[src] : T(1);
    const T pb = ok ? sB[src] : T(0);
    __syncthreads();
    b = a * pb + b;  // this window's map applied after the earlier ones
    a = a * pa;
    sA[j] = a;
    sB[j] = b;
    __syncthreads();
  }
  const int prev = reverse ? j + 1 : j - 1;
  const bool has_prev = reverse ? prev < kThreads : prev >= 0;
  const T x = has_prev ? sA[prev] * x0 + sB[prev] : x0;
  __syncthreads();
  return x;
}

// Phase B for the sweep: suffix scan of 2x2 Moebius maps (earlier window is
// the left factor), normalised after every product.  Returns the pivot D_t
// entering this thread's chunk from the right: the first-column ratio of the
// next window's suffix map.  Past the last window the map is the identity,
// whose ratio 1/0 is replaced by 1; b2 = 0 at the final element resets the
// recursion there, so that placeholder never reaches a real pivot
// (pallas_scan.py:312-321).  s holds 4*kThreads doubles.
__device__ double mobius_entry(double w00, double w01, double w10, double w11,
                               double* s) {
  double* s00 = s;
  double* s01 = s + kThreads;
  double* s10 = s + 2 * kThreads;
  double* s11 = s + 3 * kThreads;
  const int j = threadIdx.x;
  s00[j] = w00;
  s01[j] = w01;
  s10[j] = w10;
  s11[j] = w11;
  __syncthreads();
  for (int sh = 1; sh < kThreads; sh <<= 1) {
    const int src = j + sh;
    const bool ok = src < kThreads;
    const double p00 = ok ? s00[src] : 1.0;
    const double p01 = ok ? s01[src] : 0.0;
    const double p10 = ok ? s10[src] : 0.0;
    const double p11 = ok ? s11[src] : 1.0;
    __syncthreads();
    const double n00 = w00 * p00 + w01 * p10;
    const double n01 = w00 * p01 + w01 * p11;
    const double n10 = w10 * p00 + w11 * p10;
    const double n11 = w10 * p01 + w11 * p11;
    const double r = rsqrt(n00 * n00 + n01 * n01 + n10 * n10 + n11 * n11 + 1e-300);
    w00 = n00 * r;
    w01 = n01 * r;
    w10 = n10 * r;
    w11 = n11 * r;
    s00[j] = w00;
    s01[j] = w01;
    s10[j] = w10;
    s11[j] = w11;
    __syncthreads();
  }
  const bool has_next = j + 1 < kThreads;
  const double t00 = has_next ? s00[j + 1] : 1.0;
  const double t10 = has_next ? s10[j + 1] : 0.0;
  __syncthreads();
  return t10 == 0.0 ? 1.0 : t00 / t10;
}

// Phase A of the sweep: W <- M_i W over the chunk, right to left, with
// M_i = [[kd_i, -b2_i], [1, 0]] on preconditioned channels; the new bottom
// row is the old top row, and the map is renormalised every step.
__device__ __forceinline__ void mobius_step(double kdt, double nb2t, double& w00,
                                            double& w01, double& w10, double& w11) {
  const double p00 = kdt * w00 + nb2t * w10;
  const double p01 = kdt * w01 + nb2t * w11;
  const double r = rsqrt(p00 * p00 + p01 * p01 + w00 * w00 + w01 * w01 + 1e-300);
  w10 = w00 * r;
  w11 = w01 * r;
  w00 = p00 * r;
  w01 = p01 * r;
}

// ---------------------------------------------------------------- K1
__global__ void __launch_bounds__(kThreads)
riccati_kernel(const double* __restrict__ kd, const double* __restrict__ b2,
               double* __restrict__ out, int n) {
  __shared__ double smem[4 * kThreads];
  const long long off = static_cast<long long>(blockIdx.x) * n;
  kd += off;
  b2 += off;
  out += off;
  int start, end;
  chunk_of(n, start, end);

  // A: the chunk's Moebius map
  double w00 = 1.0, w01 = 0.0, w10 = 0.0, w11 = 1.0;
  double s_next = end < n ? precond(kd[end], b2[end]) : 1.0;
  for (int i = end - 1; i >= start; --i) {
    const double si = precond(kd[i], b2[i]);
    mobius_step(kd[i] / si, -b2[i] / (si * s_next), w00, w01, w10, w11);
    s_next = si;
  }
  // B
  double d = mobius_entry(w00, w01, w10, w11, smem);
  // C: exact pivot recursion from the boundary value
  s_next = end < n ? precond(kd[end], b2[end]) : 1.0;
  for (int i = end - 1; i >= start; --i) {
    const double si = precond(kd[i], b2[i]);
    d = kd[i] / si - (b2[i] / (si * s_next)) / d;
    out[i] = d * si;
    s_next = si;
  }
}

// ---------------------------------------------------------------- K2
template <typename T>
__global__ void __launch_bounds__(kThreads)
linrec_kernel(const T* __restrict__ t, const T* __restrict__ c,
              const T* __restrict__ x0, T* __restrict__ out, int n, int reverse) {
  __shared__ T sA[kThreads];
  __shared__ T sB[kThreads];
  const long long off = static_cast<long long>(blockIdx.x) * n;
  t += off;
  c += off;
  out += off;
  int start, end;
  chunk_of(n, start, end);

  T a = T(1), b = T(0);
  if (reverse) {
    for (int i = end - 1; i >= start; --i) {
      a = t[i] * a;
      b = t[i] * b + c[i];
    }
  } else {
    for (int i = start; i < end; ++i) {
      a = t[i] * a;
      b = t[i] * b + c[i];
    }
  }
  T x = affine_entry<T>(a, b, x0[blockIdx.x], sA, sB, reverse != 0);
  if (reverse) {
    for (int i = end - 1; i >= start; --i) {
      x = t[i] * x + c[i];
      out[i] = x;
    }
  } else {
    for (int i = start; i < end; ++i) {
      x = t[i] * x + c[i];
      out[i] = x;
    }
  }
}

// ---------------------------------------------------------------- K3
// Phases 0 -> R -> Z -> M -> V of pallas_scan.py::_dist_q_kernel, in f64.
// scratch is [6, B, n] f64: s, kd_t, -b2_t, u, covs, w.  A chunk's first
// element reads u of the previous chunk's last element from the u plane
// after a barrier (global writes before __syncthreads are visible to the
// whole block after it).  Outputs are cast to TO at the store.
template <typename TO>
__global__ void __launch_bounds__(kThreads)
dist_q_kernel(const double* __restrict__ nat1, const double* __restrict__ nat2d,
              const double* __restrict__ nat2s, double* __restrict__ scratch,
              TO* __restrict__ covs_o, TO* __restrict__ a_o, TO* __restrict__ w_o,
              TO* __restrict__ mu_o, TO* __restrict__ v_o, int n) {
  __shared__ double smem[4 * kThreads];
  const long long bidx = blockIdx.x;
  const long long plane = static_cast<long long>(gridDim.x) * n;
  const long long off = bidx * n;
  nat1 += off;
  nat2d += off;
  nat2s += bidx * (n - 1);
  covs_o += off;
  a_o += off;
  w_o += off;
  mu_o += off;
  v_o += off;
  double* s_p = scratch + off;
  double* kdt_p = s_p + plane;
  double* nb2t_p = kdt_p + plane;
  double* u_p = nb2t_p + plane;
  double* cov_p = u_p + plane;
  double* w_p = cov_p + plane;
  int start, end;
  chunk_of(n, start, end);

  // 0: preconditioner s, then kd_t = kd/s and -b2_t = -ks^2/(s*s_next);
  // kd = -2*nat2d and ks = -nat2s, zero past the last element.
  for (int i = start; i < end; ++i) {
    const double ks = i < n - 1 ? -nat2s[i] : 0.0;
    s_p[i] = precond(-2.0 * nat2d[i], ks * ks);
  }
  __syncthreads();
  for (int i = start; i < end; ++i) {
    const double ks = i < n - 1 ? -nat2s[i] : 0.0;
    const double s_next = i + 1 < n ? s_p[i + 1] : 1.0;
    kdt_p[i] = -2.0 * nat2d[i] / s_p[i];
    nb2t_p[i] = -(ks * ks) / (s_p[i] * s_next);
  }

  // R: pivot sweep, emitting u = ks/D_{k+1} (a = -u) and covs = 1/D
  double w00 = 1.0, w01 = 0.0, w10 = 0.0, w11 = 1.0;
  for (int i = end - 1; i >= start; --i) {
    mobius_step(kdt_p[i], nb2t_p[i], w00, w01, w10, w11);
  }
  const double d_entry = mobius_entry(w00, w01, w10, w11, smem);
  {
    double rec = 1.0 / d_entry;  // 1/D_t of the element to the right
    double s_next = end < n ? s_p[end] : 1.0;
    for (int i = end - 1; i >= start; --i) {
      const double ks = i < n - 1 ? -nat2s[i] : 0.0;
      const double u = ks * (rec / s_next);
      u_p[i] = u;
      a_o[i] = static_cast<TO>(-u);
      rec = 1.0 / (kdt_p[i] + nb2t_p[i] * rec);
      const double cov = rec / s_p[i];
      cov_p[i] = cov;
      covs_o[i] = static_cast<TO>(cov);
      s_next = s_p[i];
    }
  }

  // Z: reverse solve z_k = -u_k z_{k+1} + theta_k; w = covs * z
  {
    double a = 1.0, b = 0.0;
    for (int i = end - 1; i >= start; --i) {
      const double t = -u_p[i];
      a = t * a;
      b = t * b + nat1[i];
    }
    double x = affine_entry<double>(a, b, 0.0, smem, smem + kThreads, true);
    for (int i = end - 1; i >= start; --i) {
      x = -u_p[i] * x + nat1[i];
      const double w = cov_p[i] * x;
      w_p[i] = w;
      w_o[i] = static_cast<TO>(w);
    }
  }

  // M: forward mean mu_k = -u_{k-1} mu_{k-1} + w_k (mu_0 = w_0)
  {
    double a = 1.0, b = 0.0;
    for (int i = start; i < end; ++i) {
      const double t = i > 0 ? -u_p[i - 1] : 0.0;
      a = t * a;
      b = t * b + w_p[i];
    }
    double x = affine_entry<double>(a, b, 0.0, smem, smem + kThreads, false);
    for (int i = start; i < end; ++i) {
      const double t = i > 0 ? -u_p[i - 1] : 0.0;
      x = t * x + w_p[i];
      mu_o[i] = static_cast<TO>(x);
    }
  }

  // V: forward variance v_k = u_{k-1}^2 v_{k-1} + covs_k (v_0 = covs_0)
  {
    double a = 1.0, b = 0.0;
    for (int i = start; i < end; ++i) {
      const double up = i > 0 ? u_p[i - 1] : 0.0;
      a = up * up * a;
      b = up * up * b + cov_p[i];
    }
    double x = affine_entry<double>(a, b, 0.0, smem, smem + kThreads, false);
    for (int i = start; i < end; ++i) {
      const double up = i > 0 ? u_p[i - 1] : 0.0;
      x = up * up * x + cov_p[i];
      v_o[i] = static_cast<TO>(x);
    }
  }
}

template <typename TO>
int launch_dist_q(const double* nat1, const double* nat2d, const double* nat2s,
                  double* scratch, TO* covs, TO* a, TO* w, TO* mu, TO* v,
                  int batch, int n, void* stream) {
  dist_q_kernel<TO><<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nat1, nat2d, nat2s, scratch, covs, a, w, mu, v, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_linrec(const T* t, const T* c, const T* x0, T* out, int batch, int n,
                  int reverse, void* stream) {
  linrec_kernel<T><<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, c, x0, out, n, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int vidp_riccati_f64(const double* kd, const double* b2, double* out, int batch,
                     int n, void* stream) {
  riccati_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      kd, b2, out, n);
  return static_cast<int>(cudaGetLastError());
}

int vidp_linrec_f64(const double* t, const double* c, const double* x0,
                    double* out, int batch, int n, int reverse, void* stream) {
  return launch_linrec<double>(t, c, x0, out, batch, n, reverse, stream);
}

int vidp_linrec_f32(const float* t, const float* c, const float* x0, float* out,
                    int batch, int n, int reverse, void* stream) {
  return launch_linrec<float>(t, c, x0, out, batch, n, reverse, stream);
}

int vidp_dist_q_1d_f32(const double* nat1, const double* nat2d,
                       const double* nat2s, double* scratch, float* covs,
                       float* a, float* w, float* mu, float* v, int batch, int n,
                       void* stream) {
  return launch_dist_q<float>(nat1, nat2d, nat2s, scratch, covs, a, w, mu, v,
                              batch, n, stream);
}

int vidp_dist_q_1d_f64(const double* nat1, const double* nat2d,
                       const double* nat2s, double* scratch, double* covs,
                       double* a, double* w, double* mu, double* v, int batch,
                       int n, void* stream) {
  return launch_dist_q<double>(nat1, nat2d, nat2s, scratch, covs, a, w, mu, v,
                               batch, n, stream);
}

}  // extern "C"
