// Hand-written Hopper kernel K4: the float32 UDU' pivot sweep
//
//   D_k = kd_k - b2_k / D_{k+1},   k = N-1 ... 0,   b2[N-1] = 0
//
// It replaces vi_diffusion_processes_tpu/ops/pallas_riccati.py::riccati_d_sweep:
// the Pallas kernels _compose_kernel (phase A) and _sweep_kernel (phase C)
// with the XLA lax.scan boundary pass between them (phase B).  It serves
// the x64-off configuration, whose naturals are float32.
//
// Numerics decide the design.  In float32 a log-depth tree of 2x2 Moebius
// products (K1's Hillis-Steele scan) loses the small singular direction on
// fine grids and D comes out negative (btd.py::btd_udu_parallel_1d), so
// every product here is taken in sequential order, right to left:
//   A. thread j composes the map of window j, [j*l, (j+1)*l), normalised
//      after every step;
//   B. one thread walks the nb window maps right to left and leaves the
//      pair (p, q) entering each window in shared memory; D = p/q, or +inf
//      where q = 0;
//   C. thread j runs the exact recursion through its window from that value.
// The windows are the TPU kernel's: nb = 128 * max(1, min(4, N / 16384))
// windows of l = ceil(N / nb) (pallas_riccati.py:126-127); elements past N
// are padded with kd~ = 1, b2~ = 0 as there.  The diagonal preconditioning
// s = sqrt(b2), or |kd| + 1e-30 where b2 = 0, keeps each map O(1)-conditioned
// (kd~ = kd/s, b2~ = b2/(s*s_next)); the output is D~ * s.
//
// What bounds it on an H100: the latency of the dependency chain, about
// 2*l + nb dependent steps (588 at N = 100,000), not bytes (1.2 MB).  One
// block per sequence keeps one SM busy, and a thread walks its own window,
// so loads are strided; both are known costs left for later work.
//
// Interface: a plain C launcher that returns cudaGetLastError() as an int,
// launches on the given stream, never synchronises and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindows = 512;

__device__ __forceinline__ float precond_f32(float kd, float b2) {
  return b2 > 0.f ? sqrtf(b2) : fabsf(kd) + 1e-30f;
}

// Element i of a window walked right to left: its preconditioned pair
// (kdt, b2t) and its scale s, given s_next of element i+1 (1 past N).
// Past N the pair is the padding (1, 0) and s_next is left as it is.
__device__ __forceinline__ void load_elem(const float* __restrict__ kd,
                                          const float* __restrict__ b2, int i,
                                          int n, float& s_next, float& kdt,
                                          float& b2t, float& s) {
  if (i < n) {
    s = precond_f32(kd[i], b2[i]);
    kdt = kd[i] / s;
    b2t = b2[i] / (s * s_next);
    s_next = s;
  } else {
    kdt = 1.f;
    b2t = 0.f;
    s = 1.f;
  }
}

__global__ void __launch_bounds__(kMaxWindows)
riccati_f32_kernel(const float* __restrict__ kd, const float* __restrict__ b2,
                   float* __restrict__ out, int n, int l) {
  __shared__ float sw[4][kMaxWindows];
  __shared__ float s_entry[kMaxWindows];
  const long long off = static_cast<long long>(blockIdx.x) * n;
  kd += off;
  b2 += off;
  out += off;
  const int nb = blockDim.x;
  const int j = threadIdx.x;
  const int start = j * l;
  const int past = start + l;  // first element after this window
  const float s_past = past < n ? precond_f32(kd[past], b2[past]) : 1.f;

  // A: this window's Moebius map, W <- M_i W for i = l-1 ... 0, with
  // M_i = [[kd~_i, -b2~_i], [1, 0]]
  float w00 = 1.f, w01 = 0.f, w10 = 0.f, w11 = 1.f;
  float s_next = s_past;
  for (int i = past - 1; i >= start; --i) {
    float kdt, b2t, s;
    load_elem(kd, b2, i, n, s_next, kdt, b2t, s);
    const float p00 = kdt * w00 - b2t * w10;
    const float p01 = kdt * w01 - b2t * w11;
    const float r = rsqrtf(p00 * p00 + p01 * p01 + w00 * w00 + w01 * w01 + 1e-30f);
    w10 = w00 * r;
    w11 = w01 * r;
    w00 = p00 * r;
    w01 = p01 * r;
  }
  sw[0][j] = w00;
  sw[1][j] = w01;
  sw[2][j] = w10;
  sw[3][j] = w11;
  __syncthreads();

  // B: the boundary pass, in sequential order
  if (j == 0) {
    float p = 1.f, q = 0.f;
    for (int w = nb - 1; w >= 0; --w) {
      s_entry[w] = q == 0.f ? __int_as_float(0x7f800000) : p / q;
      const float p2 = sw[0][w] * p + sw[1][w] * q;
      const float q2 = sw[2][w] * p + sw[3][w] * q;
      const float r = rsqrtf(p2 * p2 + q2 * q2 + 1e-30f);
      p = p2 * r;
      q = q2 * r;
    }
  }
  __syncthreads();

  // C: the exact recursion from the boundary value
  float d = s_entry[j];
  s_next = s_past;
  for (int i = past - 1; i >= start; --i) {
    float kdt, b2t, s;
    load_elem(kd, b2, i, n, s_next, kdt, b2t, s);
    d = kdt - b2t / d;
    if (i < n) out[i] = d * s;
  }
}

}  // namespace

extern "C" {

int vidp_riccati_f32(const float* kd, const float* b2, float* out, int batch,
                     int n, int nb, int l, void* stream) {
  if (nb < 1 || nb > kMaxWindows) return static_cast<int>(cudaErrorInvalidValue);
  riccati_f32_kernel<<<batch, nb, 0, static_cast<cudaStream_t>(stream)>>>(
      kd, b2, out, n, l);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
