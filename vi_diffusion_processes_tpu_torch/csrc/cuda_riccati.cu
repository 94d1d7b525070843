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
// products (the scan of K1 and K3) loses the small singular direction on
// fine grids and D comes out negative (btd.py::btd_udu_parallel_1d), so
// every product here is taken in sequential order, right to left.  The
// sequence is cut into nb windows of l elements (the caller's choice,
// ops/cuda_riccati.py::window_shape; elements past N are padded with
// kd~ = 1, b2~ = 0), and
//   A. one thread per window composes the window's map, normalised after
//      every step;
//   B. one thread walks the window maps right to left, one after another,
//      and leaves the pair (p, q) entering each window; D = p/q, or +inf
//      where q = 0 (b2 = 0 at N-1 makes the first real step forget it);
//   C. one thread per window runs the exact recursion from that value.
// The diagonal preconditioning s = sqrt(b2), or |kd| + 1e-30 where b2 = 0,
// keeps each map O(1)-conditioned (kd~ = kd/s, b2~ = b2/(s*s_next)); the
// output is D~ * s.
//
// What bounds it on an H100: the latency of the dependency chain, not bytes
// (1.2 MB at N = 100,000).  The chain is l steps of A, nb of B and l of C,
// each some tens of cycles of dependent float32 arithmetic (two FMAs, a
// sum of squares, rsqrtf and a multiply in A and B; a division and a
// subtraction in C): 2*l + nb steps, 2*235 + 426 = 896 at N = 100,000 with
// the windows of window_shape.  The design keeps everything else off that
// chain:
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
//     and at most what the device's opt-in shared memory holds (3 floats an
//     element).  One chunk (every single sequence up to a few million
//     elements on an H100) stays resident; with more chunks (one block per
//     sequence at a large batch, or a smaller device) each chunk is loaded
//     and preconditioned again for C;
//   * each block publishes its windows' maps (a float4 a window) to a
//     global array; after the grid sync every block runs B itself, from the
//     right end down to its own first window, on maps its threads stage
//     into shared memory kStage at a time.  Redundant, but it saves a second
//     grid sync, which costs more than the staging;
//   * results go back to shared memory and leave with coalesced stores.
// When fewer than two blocks a sequence fit beside the batch's other
// sequences, the launch is an ordinary one, one block per sequence.
//
// Interface: plain C functions that return a cudaError_t as an int.  The
// launcher launches on the given stream, never synchronises and allocates
// nothing: the caller brings the scratch, 6 floats a window.

#include "scan_launch.cuh"

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // threads per block = most windows per chunk
constexpr int kStage = 1024;   // window maps staged per round of phase B
constexpr int kBatch = 8;      // elements a walking thread reads ahead

__device__ __forceinline__ float precond_f32(float kd, float b2) {
  return b2 > 0.f ? sqrtf(b2) : fabsf(kd) + 1e-30f;
}

// Load elements [e0, e0 + len) of the sequence into shared memory and
// precondition them in place: skd <- kd~, sb2 <- b2~, ss <- s (len + 1
// entries: b2~ needs s of the element after the chunk).  Elements past n
// are the padding (1, 0) with s = 1.  All threads of the block call this.
__device__ void stage_chunk(const float* __restrict__ kd, const float* __restrict__ b2,
                            int e0, int len, int n, float* skd, float* sb2, float* ss) {
  __syncthreads();  // the previous chunk's readers are done
  for (int e = threadIdx.x; e <= len; e += kThreads) {
    const int i = e0 + e;
    float k = 1.f, b = 0.f, s = 1.f;
    if (i < n) {
      k = kd[i];
      b = b2[i];
      s = precond_f32(k, b);
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
      const float s = ss[e];
      skd[e] = skd[e] / s;
      sb2[e] = sb2[e] / (s * ss[e + 1]);
    }
  }
  __syncthreads();
}

// wpb windows a block, wpc windows a chunk; maps and entry hold nb entries
// a sequence.
__global__ void __launch_bounds__(kThreads)
riccati_f32_kernel(const float* __restrict__ kd, const float* __restrict__ b2,
                   float* __restrict__ out, float4* maps, float2* entry, int n, int nb,
                   int l, int bps, int wpb, int wpc) {
  extern __shared__ float smem[];
  __shared__ float4 staged[kStage];
  const int seq = blockIdx.x / bps;
  const int blk = blockIdx.x % bps;
  const long long off = static_cast<long long>(seq) * n;
  kd += off;
  b2 += off;
  out += off;
  maps += static_cast<long long>(seq) * nb;
  entry += static_cast<long long>(seq) * nb;
  const int w_lo = min(blk * wpb, nb);
  const int w_hi = min(w_lo + wpb, nb);
  const int nchunks = (w_hi - w_lo + wpc - 1) / wpc;
  float* skd = smem;
  float* sb2 = skd + wpc * l;
  float* ss = sb2 + wpc * l;
  const int j = threadIdx.x;
  const float* pk = skd + j * l;
  const float* pb = sb2 + j * l;

  // A: each window's Moebius map, W <- M_i W for i = l-1 ... 0, with
  // M_i = [[kd~_i, -b2~_i], [1, 0]]
  for (int c = 0; c < nchunks; ++c) {
    const int w0 = w_lo + c * wpc;
    const int nw = min(wpc, w_hi - w0);
    stage_chunk(kd, b2, w0 * l, nw * l, n, skd, sb2, ss);
    if (j < nw) {
      float w00 = 1.f, w01 = 0.f, w10 = 0.f, w11 = 1.f;
      for (int top = l; top > 0; top -= kBatch) {
        float kv[kBatch], bv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = top - 1 - u;
          kv[u] = i >= 0 ? pk[i] : 0.f;
          bv[u] = i >= 0 ? pb[i] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (top - 1 - u < 0) break;
          const float p00 = kv[u] * w00 - bv[u] * w10;
          const float p01 = kv[u] * w01 - bv[u] * w11;
          const float r = rsqrtf(p00 * p00 + p01 * p01 + w00 * w00 + w01 * w01 + 1e-30f);
          w10 = w00 * r;
          w11 = w01 * r;
          w00 = p00 * r;
          w01 = p01 * r;
        }
      }
      maps[w0 + j] = make_float4(w00, w01, w10, w11);
    }
  }
  vidp::sync_sequence(bps);

  // B: the boundary pass, in sequential order, from the right end down to
  // this block's first window
  float p = 1.f, q = 0.f;
  for (int hi = nb; hi > w_lo; hi -= kStage) {
    const int lo = max(hi - kStage, w_lo);
    for (int k = j; k < hi - lo; k += kThreads) staged[k] = __ldcg(maps + lo + k);
    __syncthreads();
    if (j == 0) {
      for (int w = hi - 1; w >= lo; --w) {
        if (w < w_hi) entry[w] = make_float2(p, q);
        const float4 m = staged[w - lo];
        const float p2 = m.x * p + m.y * q;
        const float q2 = m.z * p + m.w * q;
        const float r = rsqrtf(p2 * p2 + q2 * q2 + 1e-30f);
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
    if (nchunks > 1) stage_chunk(kd, b2, w0 * l, nw * l, n, skd, sb2, ss);
    if (j < nw) {
      const float2 pq = entry[w0 + j];
      float d = pq.y == 0.f ? __int_as_float(0x7f800000) : pq.x / pq.y;
      float* po = skd + j * l;
      const float* ps = ss + j * l;
      for (int top = l; top > 0; top -= kBatch) {
        float kv[kBatch], bv[kBatch], sv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = top - 1 - u;
          kv[u] = i >= 0 ? pk[i] : 0.f;
          bv[u] = i >= 0 ? pb[i] : 0.f;
          sv[u] = i >= 0 ? ps[i] : 0.f;
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
  vidp::Shape shape;
  int wpb, wpc;
  size_t smem;
};

// Floats of dynamic shared memory a block may take on the current device
// (the opt-in limit less the kernel's static part), opted in once per device.
cudaError_t dynamic_floats(int& sms, int& out) {
  static std::mutex mu;
  static std::map<int, std::pair<int, int>> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(dev);
  if (it == cache.end()) {
    int optin = 0, count = 0;
    cudaFuncAttributes attr;
    const void* kernel = reinterpret_cast<const void*>(&riccati_f32_kernel);
    if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess)
      return err;
    const int bytes = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    cache[dev] = {count, bytes / static_cast<int>(sizeof(float))};
  }
  sms = cache[dev].first;
  out = cache[dev].second;
  return cudaSuccess;
}

// Blocks per sequence: up to one block per SM beside the batch's other
// sequences, at most one per window, 1 (no grid sync) when fewer than 2
// fit; then the chunk that the shared memory holds.
cudaError_t plan(int batch, int nb, int l, Plan& p) {
  if (batch < 1 || nb < 1 || l < 1) return cudaErrorInvalidValue;
  int sms = 0, room = 0;
  cudaError_t err = dynamic_floats(sms, room);
  if (err != cudaSuccess) return err;
  const int fit = (room - 1) / 3 / l;  // windows whose kd~, b2~ and s fit
  if (fit < 1) return cudaErrorInvalidValue;
  int bps = std::min(sms / batch, nb);
  if (bps < 2) bps = 1;
  p.wpb = (nb + bps - 1) / bps;
  bps = (nb + p.wpb - 1) / p.wpb;  // no block without a window
  p.wpc = std::min({p.wpb, kThreads, fit});
  p.smem = (3 * static_cast<size_t>(p.wpc) * l + 1) * sizeof(float);
  p.shape = {batch * bps, bps};
  if (bps > 1) {
    int cap = 0;
    err = vidp::coresident_blocks(reinterpret_cast<const void*>(&riccati_f32_kernel),
                                  kThreads, p.smem, cap);
    if (err != cudaSuccess) return err;
    if (cap < p.shape.grid) return cudaErrorCooperativeLaunchTooLarge;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch of K4 for this batch and these windows on the current device:
// out[0] the grid, out[1] blocks per sequence, out[2] threads per block,
// out[3] windows per block, out[4] windows per chunk, out[5] bytes of
// dynamic shared memory per block.
int vidp_riccati_f32_shape(int batch, int nb, int l, int* out) {
  Plan p;
  const cudaError_t err = plan(batch, nb, l, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.shape.grid;
  out[1] = p.shape.bps;
  out[2] = kThreads;
  out[3] = p.wpb;
  out[4] = p.wpc;
  out[5] = static_cast<int>(p.smem);
  return 0;
}

// scratch: 6 * batch * nb floats (the windows' maps, then their entries).
int vidp_riccati_f32(const float* kd, const float* b2, float* out, float* scratch,
                     int batch, int n, int nb, int l, void* stream) {
  const long long padded = static_cast<long long>(nb) * l;  // indexed with ints
  if (n < 1 || padded < n || padded > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan(batch, nb, l, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  float4* maps = reinterpret_cast<float4*>(scratch);
  float2* entry = reinterpret_cast<float2*>(scratch + 4 * static_cast<size_t>(batch) * nb);
  void* args[] = {&kd, &b2, &out, &maps, &entry, &n, &nb, &l, &p.shape.bps, &p.wpb, &p.wpc};
  return vidp::launch(reinterpret_cast<const void*>(&riccati_f32_kernel), p.shape, kThreads,
                      p.smem, args, stream);
}

}  // extern "C"
