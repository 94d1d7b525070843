// The UDU' pivot sweep in sequential order, shared by K1 and K3's phase R
// (cuda_scan.cu, float64) and K4 (cuda_riccati.cu, float32):
//
//   D_k = kd_k - b2_k / D_{k+1},   k = N-1 ... 0,   b2[N-1] = 0
//
// Numerics decide the design.  A log-depth tree of 2x2 Moebius products
// loses the small singular direction of the composed maps: in float32 on
// fine grids the pivots come out negative (btd.py::btd_udu_parallel_1d),
// and in float64 a window boundary on a small gap (1e-9 on a Matern12
// chain) loses 1e-8 of the pivot there, where the sequential recursion
// loses 1e-11.  So every product is taken in sequential order, right to
// left.  The sequence is cut into nb windows of l elements (the caller's
// choice, ops/cuda_scan.py::window_shape; elements past N are padded with
// kd~ = 1, b2~ = 0), and
//   A. one thread per window composes the window's map, normalised after
//      every step;
//   B. one thread walks the window maps right to left, one after another,
//      and leaves the pair (p, q) entering each window, normalised after
//      every step; D~ = p/q, or +inf where q = 0 (b2 = 0 at N-1 makes the
//      first real step forget it);
//   C. one thread per window runs the exact recursion from that value.
// The diagonal preconditioning s = sqrt(b2), or |kd| + eps where b2 = 0,
// keeps each map O(1)-conditioned (kd~ = kd/s, b2~ = b2/(s*s_next)); the
// output is D~ * s.
//
// What bounds it on an H100: the latency of the dependency chain, not bytes
// (2.4 MB in float64 at N = 100,000).  The chain is l steps of A, nb of B
// and l of C, each some tens of cycles of dependent arithmetic (two FMAs, a
// sum of squares, a reciprocal square root and a multiply in A and B; a
// division and a subtraction in C): 2*l + nb steps, 2*235 + 426 = 896 at
// N = 100,000 with the windows of window_shape.  The design keeps
// everything else off that chain:
//   * one launch; a sequence is spread over up to one block per SM, each
//     block owning a contiguous run of windows (a cooperative launch, whose
//     blocks meet at one grid sync between A and B);
//   * a block loads its run of kd and b2 with coalesced loads into dynamic
//     shared memory and computes s, kd~ and b2~ there once, with all its
//     threads; the walking threads (one per window, the first of the
//     block) then read shared memory only.  l is odd, so the 32 threads of
//     a warp, l words apart, hit 32 different banks;
//   * the run stays resident from A to C, so global memory is read once.
//     Rule: a block's run is cut into chunks of at most kThreads windows
//     and at most what the device's opt-in shared memory holds (3 values an
//     element).  One chunk (every single sequence up to about a million
//     elements in float64 on an H100) stays resident; with more chunks (one
//     block per sequence at a large batch, or a smaller device) each chunk
//     is loaded and preconditioned again for C;
//   * each block publishes its windows' maps to a global array; after the
//     grid sync every block runs B itself, from the right end down to its
//     own first window, on maps its threads stage into shared memory 16 KB
//     at a time.  Redundant, but it saves a second grid sync, which costs
//     more than the staging;
//   * results go back to shared memory and leave with coalesced stores.
// When fewer than two blocks a sequence fit beside the batch's other
// sequences, the launch is an ordinary one, one block per sequence.
//
// The scratch a launch takes from its caller: 6 values a window (the
// windows' maps, then their entry pairs).
#pragma once

#include "scan_launch.cuh"

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace vidp {
namespace sweep {

constexpr int kThreads = 256;  // threads per block = most windows per chunk
constexpr int kBatch = 8;      // elements a walking thread reads ahead

// What the sweep needs of its value type.
template <typename T>
struct Num;
template <>
struct Num<float> {
  static constexpr float kEps = 1e-30f;
  static __device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
  static __device__ __forceinline__ float root(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float mag(float x) { return fabsf(x); }
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
};
template <>
struct Num<double> {
  static constexpr double kEps = 1e-300;
  static __device__ __forceinline__ double rsq(double x) { return rsqrt(x); }
  static __device__ __forceinline__ double root(double x) { return sqrt(x); }
  static __device__ __forceinline__ double mag(double x) { return fabs(x); }
  static __device__ __forceinline__ double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
};

// A window's Moebius map and the pair entering a window.
template <typename T>
struct Map4 {
  T w00, w01, w10, w11;
};
template <typename T>
struct Pair {
  T p, q;
};
// Window maps staged per round of phase B (16 KB of shared memory).
template <typename T>
constexpr int kStage = 16384 / static_cast<int>(sizeof(Map4<T>));

// The sweep's inputs: kd and b2 planes (K1, K4), or K3's naturals
// (kd = -2*nat2d, b2 = nat2s^2 with 0 at the last element).  seq() moves
// to the s-th sequence of n elements; at() reads element i < n.
template <typename T>
struct KdB2 {
  const T* kd;
  const T* b2;
  __device__ __forceinline__ KdB2 seq(long long s, int n) const { return {kd + s * n, b2 + s * n}; }
  __device__ __forceinline__ void at(int i, int, T& k, T& b) const {
    k = kd[i];
    b = b2[i];
  }
};
struct Naturals {
  const double* nat2d;
  const double* nat2s;
  __device__ __forceinline__ Naturals seq(long long s, int n) const {
    return {nat2d + s * n, nat2s + s * (n - 1)};
  }
  __device__ __forceinline__ void at(int i, int n, double& k, double& b) const {
    const double ks = i < n - 1 ? nat2s[i] : 0.0;
    k = -2.0 * nat2d[i];
    b = ks * ks;
  }
};

template <typename T>
__device__ __forceinline__ T precond(T kd, T b2) {
  return b2 > T(0) ? Num<T>::root(b2) : Num<T>::mag(kd) + Num<T>::kEps;
}

// Load elements [e0, e0 + len) of the sequence into shared memory and
// precondition them in place: skd <- kd~, sb2 <- b2~, ss <- s (len + 1
// entries: b2~ needs s of the element after the chunk).  Elements past n
// are the padding (1, 0) with s = 1.  All threads of the block call this.
template <typename T, typename In>
__device__ void stage_chunk(const In& in, int e0, int len, int n, T* skd, T* sb2, T* ss) {
  __syncthreads();  // the previous chunk's readers are done
  for (int e = threadIdx.x; e <= len; e += kThreads) {
    const int i = e0 + e;
    T k = T(1), b = T(0), s = T(1);
    if (i < n) {
      in.at(i, n, k, b);
      s = precond(k, b);
    }
    if (e < len) {
      skd[e] = k;
      sb2[e] = b;
    }
    ss[e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < len; e += kThreads) {
    if (e0 + e < n) {
      const T s = ss[e];
      skd[e] = skd[e] / s;
      sb2[e] = sb2[e] / (s * ss[e + 1]);
    }
  }
  __syncthreads();
}

// wpb windows a block, wpc windows a chunk; maps and entry hold nb entries
// a sequence; out receives D.
template <typename T, typename In>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(In in, T* __restrict__ out, Map4<T>* maps, Pair<T>* entry, int n, int nb, int l,
             int bps, int wpb, int wpc) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __shared__ Map4<T> staged[kStage<T>];
  const int seq = blockIdx.x / bps;
  const int blk = blockIdx.x % bps;
  in = in.seq(seq, n);
  out += static_cast<long long>(seq) * n;
  maps += static_cast<long long>(seq) * nb;
  entry += static_cast<long long>(seq) * nb;
  const int w_lo = min(blk * wpb, nb);
  const int w_hi = min(w_lo + wpb, nb);
  const int nchunks = (w_hi - w_lo + wpc - 1) / wpc;
  T* skd = reinterpret_cast<T*>(smem_bytes);
  T* sb2 = skd + wpc * l;
  T* ss = sb2 + wpc * l;
  const int j = threadIdx.x;
  const T* pk = skd + j * l;
  const T* pb = sb2 + j * l;

  // A: each window's Moebius map, W <- M_i W for i = l-1 ... 0, with
  // M_i = [[kd~_i, -b2~_i], [1, 0]]
  for (int c = 0; c < nchunks; ++c) {
    const int w0 = w_lo + c * wpc;
    const int nw = min(wpc, w_hi - w0);
    stage_chunk(in, w0 * l, nw * l, n, skd, sb2, ss);
    if (j < nw) {
      T w00 = T(1), w01 = T(0), w10 = T(0), w11 = T(1);
      for (int top = l; top > 0; top -= kBatch) {
        T kv[kBatch], bv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = top - 1 - u;
          kv[u] = i >= 0 ? pk[i] : T(0);
          bv[u] = i >= 0 ? pb[i] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (top - 1 - u < 0) break;
          const T p00 = kv[u] * w00 - bv[u] * w10;
          const T p01 = kv[u] * w01 - bv[u] * w11;
          const T r = Num<T>::rsq(p00 * p00 + p01 * p01 + w00 * w00 + w01 * w01 + Num<T>::kEps);
          w10 = w00 * r;
          w11 = w01 * r;
          w00 = p00 * r;
          w01 = p01 * r;
        }
      }
      maps[w0 + j] = Map4<T>{w00, w01, w10, w11};
    }
  }
  vidp::sync_sequence(bps);

  // B: the boundary pass, in sequential order, from the right end down to
  // this block's first window
  T p = T(1), q = T(0);
  for (int hi = nb; hi > w_lo; hi -= kStage<T>) {
    const int lo = max(hi - kStage<T>, w_lo);
    for (int k = j; k < hi - lo; k += kThreads) {
      const Map4<T>* m = maps + lo + k;
      staged[k] = Map4<T>{__ldcg(&m->w00), __ldcg(&m->w01), __ldcg(&m->w10), __ldcg(&m->w11)};
    }
    __syncthreads();
    if (j == 0) {
      for (int w = hi - 1; w >= lo; --w) {
        if (w < w_hi) entry[w] = Pair<T>{p, q};
        const Map4<T> m = staged[w - lo];
        const T p2 = m.w00 * p + m.w01 * q;
        const T q2 = m.w10 * p + m.w11 * q;
        const T r = Num<T>::rsq(p2 * p2 + q2 * q2 + Num<T>::kEps);
        p = p2 * r;
        q = q2 * r;
      }
    }
    __syncthreads();
  }

  // C: the exact recursion from the boundary value
  for (int c = 0; c < nchunks; ++c) {
    const int w0 = w_lo + c * wpc;
    const int nw = min(wpc, w_hi - w0);
    if (nchunks > 1) stage_chunk(in, w0 * l, nw * l, n, skd, sb2, ss);
    if (j < nw) {
      const Pair<T> pq = entry[w0 + j];
      T d = pq.q == T(0) ? Num<T>::inf() : pq.p / pq.q;
      T* po = skd + j * l;
      const T* ps = ss + j * l;
      for (int top = l; top > 0; top -= kBatch) {
        T kv[kBatch], bv[kBatch], sv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = top - 1 - u;
          kv[u] = i >= 0 ? pk[i] : T(0);
          bv[u] = i >= 0 ? pb[i] : T(0);
          sv[u] = i >= 0 ? ps[i] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = top - 1 - u;
          if (i < 0) break;
          d = kv[u] - bv[u] / d;
          po[i] = d * sv[u];
        }
      }
    }
    __syncthreads();
    const int e0 = w0 * l;
    for (int e = j; e < nw * l; e += kThreads) {
      if (e0 + e < n) out[e0 + e] = skd[e];
    }
  }
}

struct Plan {
  Shape shape;
  int wpb, wpc;
  size_t smem;
};

// The SM count and the values of dynamic shared memory a block of this
// kernel may take on the current device (the opt-in limit less the
// kernel's static part), opted in once per kernel and device.
template <typename T>
cudaError_t dynamic_room(const void* kernel, int& sms, int& out) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, std::pair<int, int>> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(kernel, dev);
  const auto it = cache.find(key);
  if (it == cache.end()) {
    int optin = 0, count = 0;
    cudaFuncAttributes attr;
    if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess)
      return err;
    const int bytes = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    cache[key] = {count, bytes / static_cast<int>(sizeof(T))};
  }
  sms = cache[key].first;
  out = cache[key].second;
  return cudaSuccess;
}

// Blocks per sequence: up to one block per SM beside the batch's other
// sequences, at most one per window, 1 (no grid sync) when fewer than 2
// fit; then the chunk that the shared memory holds.
template <typename T, typename In>
cudaError_t plan(int batch, int nb, int l, Plan& p) {
  if (batch < 1 || nb < 1 || l < 1) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(&sweep_kernel<T, In>);
  int sms = 0, room = 0;
  cudaError_t err = dynamic_room<T>(kernel, sms, room);
  if (err != cudaSuccess) return err;
  const int fit = (room - 1) / 3 / l;  // windows whose kd~, b2~ and s fit
  if (fit < 1) return cudaErrorInvalidValue;
  int bps = std::min(sms / batch, nb);
  if (bps < 2) bps = 1;
  p.wpb = (nb + bps - 1) / bps;
  bps = (nb + p.wpb - 1) / p.wpb;  // no block without a window
  p.wpc = std::min({p.wpb, kThreads, fit});
  p.smem = (3 * static_cast<size_t>(p.wpc) * l + 1) * sizeof(T);
  p.shape = {batch * bps, bps};
  if (bps > 1) {
    int cap = 0;
    err = coresident_blocks(kernel, kThreads, p.smem, cap);
    if (err != cudaSuccess) return err;
    if (cap < p.shape.grid) return cudaErrorCooperativeLaunchTooLarge;
  }
  return cudaSuccess;
}

// The launch for this batch and these windows: out[0] the grid, out[1]
// blocks per sequence, out[2] threads per block, out[3] windows per block,
// out[4] windows per chunk, out[5] bytes of dynamic shared memory per block.
template <typename T, typename In>
int shape(int batch, int nb, int l, int* out) {
  Plan p;
  const cudaError_t err = plan<T, In>(batch, nb, l, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.shape.grid;
  out[1] = p.shape.bps;
  out[2] = kThreads;
  out[3] = p.wpb;
  out[4] = p.wpc;
  out[5] = static_cast<int>(p.smem);
  return 0;
}

// Launch the sweep of batch sequences of n elements on nb windows of l;
// scratch holds 6 * batch * nb values.
template <typename T, typename In>
int launch(In in, T* out, T* scratch, int batch, int n, int nb, int l, void* stream) {
  const long long padded = static_cast<long long>(nb) * l;  // indexed with ints
  if (n < 1 || padded < n || padded > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan<T, In>(batch, nb, l, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  Map4<T>* maps = reinterpret_cast<Map4<T>*>(scratch);
  Pair<T>* entry = reinterpret_cast<Pair<T>*>(scratch + 4 * static_cast<size_t>(batch) * nb);
  void* args[] = {&in, &out, &maps, &entry, &n, &nb, &l, &p.shape.bps, &p.wpb, &p.wpc};
  return vidp::launch(reinterpret_cast<const void*>(&sweep_kernel<T, In>), p.shape, kThreads,
                      p.smem, args, stream);
}

}  // namespace sweep
}  // namespace vidp
