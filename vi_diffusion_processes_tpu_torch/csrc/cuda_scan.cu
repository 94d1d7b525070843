// Hand-written Hopper kernels for the d=1 CVI-DP hot loop.
//
// They replace the Pallas TPU kernels of
// vi_diffusion_processes_tpu/ops/pallas_scan.py:
//
//   K1  sweep_kernel<double> <- riccati_d_sweep_df / _riccati_kernel
//       UDU' pivot sweep  D_k = kd_k - b2_k / D_{k+1}   (b2[N-1] = 0)
//   K2  linrec_kernel    <- linear_recurrence / _linrec_kernel_{df,f32}
//       x_k = t_k * x_{k-+1} + c_k, forward or reverse, boundary value x0
//   K3  sweep_kernel<double, Naturals>, then dist_q_kernel
//                        <- dist_q_1d_planes / _dist_q_kernel
//       naturals -> SSM params -> marginals, the whole d=1 chain
//
// What bounds them on an H100: the latency of a sequential dependency chain,
// not bytes.  At T = 100k every f64 plane is 0.8 MB, which the card streams in
// well under a microsecond; the chain is T dependent divisions and FMAs.
//
// The pivot sweep (K1, and K3's phase R) is sweep_windows.cuh's windowed
// sweep, which takes every Moebius product in sequential order: a tree of
// them loses digits where a window boundary falls on a small gap.  What
// bounds it is its chain of 2*l + nb dependent steps (896 at T = 100k).  In
// float64 each step is a multiply and a fused multiply-add beside an
// integer maximum of exponent fields, then an exact multiply by a power of
// two: no division, square root or reciprocal square root is on the chain
// (those ran from a MUFU seed through Newton iterations, about 150 cycles a
// step), and the recursion in each window runs in projective form, its
// divisions taken by the whole block after the chain (sweep_windows.cuh).
// K4 keeps the float32 arithmetic it was measured with.  The affine scans
// (K2, and K3's phases U, Z, V and M) compose affine maps, which a tree
// keeps exact, and spread one sequence over many SMs, in one launch:
//   * the sequence is cut into tiles of kTile = 256 threads x kChunk = 2
//     elements; thread j of a tile owns the contiguous pair [2j, 2j+2), so
//     neighbouring threads touch neighbouring addresses and a warp's two
//     loads of a plane read one contiguous run of 64 elements;
//   * a block owns a contiguous run of tiles; the launcher picks blocks per
//     sequence (bps) from the batch, the SM count and the kernel's occupancy
//     (queried once per device and cached), up to one block per tile;
//   * within a tile, each thread composes its pair's affine map; a
//     warp-shuffle scan and a pass over the 8 warp totals give every thread
//     the map of all earlier pairs, in the recurrence's order (suffix for
//     reverse recurrences, prefix for forward ones); the tile's total
//     carries the boundary value to the block's next tile;
//   * across blocks: when bps > 1 the kernel is a cooperative launch.  Each
//     block publishes its run's aggregate map to a small global array, waits
//     at cooperative_groups::this_grid().sync(), and one warp composes the
//     aggregates of the blocks before it into its entry value.  K2 needs one
//     such grid sync; dist_q_kernel three (after R, with V's aggregate and
//     every covs; after U, with Z's; after M's).  When bps = 1 (large batch)
//     the launch is an ordinary one with one block per sequence and no grid
//     sync.
// The sequential depth drops from N to a few tiles per block, each a pair
// of dependent steps and two log-depth scans, plus the grid syncs.
// Everything is native f64 (Hopper has FP64 units), so the TPU's
// double-float (hi, lo) f32 arithmetic is not carried over; K2's f32 scans
// stay f32.
//
// Interface: plain C launchers that return a cudaError_t as an int.  They
// launch on the given stream, never synchronise and allocate nothing:
// outputs and scratch come from the caller, which sizes the scratch with
// vidp_scan_shape and vidp_riccati_f64_shape.

#include "sweep_windows.cuh"

#include <algorithm>

namespace {

using vidp::Shape;
using vidp::sync_sequence;

// -------------------------------------------------- multi-block scans
constexpr int kScanThreads = 256;
constexpr int kWarps = kScanThreads / 32;
constexpr int kChunk = 2;
constexpr int kTile = kScanThreads * kChunk;
constexpr unsigned kFull = 0xffffffffu;

// Affine map x -> a*x + b.
template <typename T>
struct Aff {
  T a, b;
};

template <typename T>
__device__ __forceinline__ Aff<T> identity(Aff<T>) { return {T(1), T(0)}; }

// The map that applies `first`, then `second`.
template <typename T>
__device__ __forceinline__ Aff<T> compose(Aff<T> first, Aff<T> second) {
  return {second.a * first.a, second.a * first.b + second.b};
}
// The map of the lane d places earlier in scan order (lower lanes for a
// prefix scan, higher for a suffix scan); every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ T shfl_earlier(T v, int d, bool suffix) {
  return suffix ? __shfl_down_sync(kFull, v, d) : __shfl_up_sync(kFull, v, d);
}
template <typename T>
__device__ __forceinline__ Aff<T> shfl_earlier(Aff<T> m, int d, bool suffix) {
  return {shfl_earlier(m.a, d, suffix), shfl_earlier(m.b, d, suffix)};
}

// Global loads that bypass L1: the aggregates and K3's scratch planes are
// written by other blocks in the same launch.
template <typename T>
__device__ __forceinline__ Aff<T> load_cg(const Aff<T>* p) {
  return {__ldcg(&p->a), __ldcg(&p->b)};
}

// Inclusive scan over the warp's lanes, in scan order.
template <typename M>
__device__ __forceinline__ M warp_scan(M x, bool suffix) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const M y = shfl_earlier(x, d, suffix);
    if (suffix ? lane + d < 32 : lane >= d) x = compose(y, x);
  }
  return x;
}

// Scan of the block's per-thread maps in scan order (suffix: higher threads
// first).  excl is the composition of the maps of every earlier thread,
// total that of all threads (the same in every thread).  tot is a kWarps
// array in shared memory; all threads of the block call this.
template <typename M>
__device__ void block_scan(M x, bool suffix, M* tot, M& excl, M& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const M inc = warp_scan(x, suffix);
  M ex = shfl_earlier(inc, 1, suffix);
  if (lane == (suffix ? 31 : 0)) ex = identity(x);
  if (lane == (suffix ? 0 : 31)) tot[warp] = inc;
  __syncthreads();
  M before = identity(x);
  total = identity(x);
  for (int k = 0; k < kWarps; ++k) {
    const int wk = suffix ? kWarps - 1 - k : k;
    if (wk == warp) before = total;
    total = compose(total, tot[wk]);
  }
  __syncthreads();
  excl = compose(before, ex);
}

template <typename M>
__device__ __forceinline__ M block_total(M x, bool suffix, M* tot) {
  M excl, total;
  block_scan(x, suffix, tot, excl, total);
  return total;
}

// The composition, in scan order, of the aggregates of the blocks of this
// sequence that come before block blk; block p's aggregate lies `stride`
// bytes after block p-1's.  One warp composes contiguous runs of them and
// reduces the runs with shuffles; slot is one map in shared memory.  All
// threads of the block call this.
template <typename M>
__device__ M blocks_before(const M* agg, int stride, int bps, int blk, bool suffix,
                           M* slot) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int mine = suffix ? bps - 1 - blk : blk;  // this block's place in scan order
    const int per = (mine + 31) / 32;
    const char* base = reinterpret_cast<const char*>(agg);
    M acc = identity(M{});
    for (int p = lane * per; p < min((lane + 1) * per, mine); ++p) {
      const long long b = suffix ? bps - 1 - p : p;
      acc = compose(acc, load_cg(reinterpret_cast<const M*>(base + b * stride)));
    }
    acc = warp_scan(acc, false);
    if (lane == 31) *slot = acc;
  }
  __syncthreads();
  const M r = *slot;
  __syncthreads();
  return r;
}

// The tiles [lo, hi) of block blk of bps, for a sequence of n elements.
__device__ __forceinline__ void tiles_of(int n, int bps, int blk, int& lo, int& hi) {
  const int ntiles = (n + kTile - 1) / kTile;
  const int per = (ntiles + bps - 1) / bps;
  lo = min(blk * per, ntiles);
  hi = min(lo + per, ntiles);
}

// The k-th tile of [lo, hi) in scan order.
__device__ __forceinline__ int tile_at(int lo, int hi, int k, bool suffix) {
  return suffix ? hi - 1 - k : lo + k;
}

// The k-th element of this thread's pair of tile `tile`, in scan order.
__device__ __forceinline__ int elem_at(int tile, int k, bool suffix) {
  const int base = tile * kTile + static_cast<int>(threadIdx.x) * kChunk;
  return suffix ? base + kChunk - 1 - k : base + k;
}

// ---------------------------------------------------------------- K2
// agg holds one Aff<T> per block (used when bps > 1).
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
linrec_kernel(const T* __restrict__ t, const T* __restrict__ c,
              const T* __restrict__ x0, T* __restrict__ out, Aff<T>* agg, int n,
              int bps, int reverse) {
  __shared__ Aff<T> tot[kWarps];
  __shared__ Aff<T> slot;
  const bool suffix = reverse != 0;
  const int seq = blockIdx.x / bps;
  const int blk = blockIdx.x % bps;
  const long long off = static_cast<long long>(seq) * n;
  t += off;
  c += off;
  out += off;
  int lo, hi;
  tiles_of(n, bps, blk, lo, hi);
  const Aff<T> id = {T(1), T(0)};
  T x = x0[seq];

  if (bps > 1) {
    // the block's aggregate map, published for the blocks after it
    Aff<T> mine = id;
    for (int k = 0; k < hi - lo; ++k) {
      const int tile = tile_at(lo, hi, k, suffix);
      Aff<T> m = id;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const int i = elem_at(tile, e, suffix);
        if (i < n) m = compose(m, Aff<T>{t[i], c[i]});
      }
      mine = compose(mine, block_total(m, suffix, tot));
    }
    if (threadIdx.x == 0) agg[blockIdx.x] = mine;
    sync_sequence(bps);
    const Aff<T> before = blocks_before(agg + seq * bps, sizeof(Aff<T>), bps, blk, suffix, &slot);
    x = before.a * x + before.b;
  }

  for (int k = 0; k < hi - lo; ++k) {
    const int tile = tile_at(lo, hi, k, suffix);
    T tv[kChunk], cv[kChunk];
    Aff<T> m = id;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = elem_at(tile, e, suffix);
      tv[e] = i < n ? t[i] : T(1);
      cv[e] = i < n ? c[i] : T(0);
      m = compose(m, Aff<T>{tv[e], cv[e]});
    }
    Aff<T> excl, total;
    block_scan(m, suffix, tot, excl, total);
    T y = excl.a * x + excl.b;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = elem_at(tile, e, suffix);
      y = tv[e] * y + cv[e];
      if (i < n) out[i] = y;
    }
    x = total.a * x + total.b;
  }
}

// ---------------------------------------------------------------- K3
// Phases R -> Z -> M, V of pallas_scan.py::_dist_q_kernel, in f64, with u
// taken in a phase U of its own from the covs that R writes.  Phase R's
// pivot sweep is a launch of its own before this kernel
// (sweep_kernel<double, Naturals>), which leaves the pivots D in the covs
// plane.  scratch is [3, B, n] f64 (u, covs, w), then the sweep's 6 values
// a window, then one KAgg per block.
struct KAgg {
  Aff<double> z, v, m;
};

template <typename TO>
__global__ void __launch_bounds__(kScanThreads)
dist_q_kernel(const double* __restrict__ nat1, const double* __restrict__ nat2s,
              double* __restrict__ scratch,
              TO* __restrict__ covs_o, TO* __restrict__ a_o, TO* __restrict__ w_o,
              TO* __restrict__ mu_o, TO* __restrict__ v_o, KAgg* agg, int n, int bps) {
  __shared__ Aff<double> tot_a[kWarps];
  __shared__ Aff<double> slot_a;
  const int seq = blockIdx.x / bps;
  const int blk = blockIdx.x % bps;
  const long long plane = static_cast<long long>(gridDim.x / bps) * n;
  const long long off = static_cast<long long>(seq) * n;
  KAgg* agg_seq = agg + seq * bps;
  nat1 += off;
  nat2s += static_cast<long long>(seq) * (n - 1);
  covs_o += off;
  a_o += off;
  w_o += off;
  mu_o += off;
  v_o += off;
  double* u_p = scratch + off;
  double* cov_p = u_p + plane;
  double* w_p = cov_p + plane;
  int lo, hi;
  tiles_of(n, bps, blk, lo, hi);
  const int ntl = hi - lo;
  const Aff<double> aff_id = {1.0, 0.0};

  // R: covs = 1/D from the pivots the sweep left in the covs plane; with
  // them the aggregate of V (prefix)
  Aff<double> mine_v = aff_id;
  for (int k = 0; k < ntl; ++k) {
    const int tile = tile_at(lo, hi, k, true);
    Aff<double> mv = aff_id;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = elem_at(tile, e, true);
      if (i >= n) continue;
      const double cov = 1.0 / cov_p[i];
      cov_p[i] = cov;
      covs_o[i] = static_cast<TO>(cov);
      // v_i = u_{i-1}^2 v_{i-1} + covs_i with u_{i-1} = ks_{i-1}/D_i = ks_{i-1} covs_i
      const double up = i > 0 ? -nat2s[i - 1] * cov : 0.0;
      mv = compose(Aff<double>{up * up, cov}, mv);
    }
    mine_v = compose(block_total(mv, false, tot_a), mine_v);
  }
  double carry_z = 0.0, carry_v = 0.0;
  if (threadIdx.x == 0 && bps > 1) agg[blockIdx.x].v = mine_v;
  sync_sequence(bps);
  if (bps > 1) carry_v = blocks_before(&agg_seq->v, sizeof(KAgg), bps, blk, false, &slot_a).b;

  // U: u_i = ks_i/D_{i+1} = ks_i covs_{i+1} (a = -u) from the covs written
  // above, so that a, the three recurrences and covs hold one pivot at every
  // element (the Girsanov gradient amplifies a mismatch in the last bits);
  // with u the aggregate of Z (suffix)
  Aff<double> mine_z = aff_id;
  for (int k = 0; k < ntl; ++k) {
    const int tile = tile_at(lo, hi, k, true);
    Aff<double> mz = aff_id;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = elem_at(tile, e, true);
      if (i >= n) continue;
      const double u = i < n - 1 ? -nat2s[i] * __ldcg(cov_p + i + 1) : 0.0;
      u_p[i] = u;
      a_o[i] = static_cast<TO>(-u);
      mz = compose(mz, Aff<double>{-u, nat1[i]});
    }
    mine_z = compose(mine_z, block_total(mz, true, tot_a));
  }
  if (threadIdx.x == 0 && bps > 1) agg[blockIdx.x].z = mine_z;
  sync_sequence(bps);
  if (bps > 1) carry_z = blocks_before(&agg_seq->z, sizeof(KAgg), bps, blk, true, &slot_a).b;

  // Z, exact: w = covs * z; with it the aggregate of M (prefix)
  Aff<double> mine_m = aff_id;
  for (int k = 0; k < ntl; ++k) {
    const int tile = tile_at(lo, hi, k, true);
    double uv[kChunk], cv[kChunk], th[kChunk];
    Aff<double> mz = aff_id;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = elem_at(tile, e, true);
      uv[e] = i < n ? __ldcg(u_p + i) : 0.0;
      cv[e] = i < n ? __ldcg(cov_p + i) : 0.0;
      th[e] = i < n ? nat1[i] : 0.0;
      if (i < n) mz = compose(mz, Aff<double>{-uv[e], th[e]});
    }
    Aff<double> excl, total;
    block_scan(mz, true, tot_a, excl, total);
    double z = excl.a * carry_z + excl.b;
    carry_z = total.a * carry_z + total.b;
    Aff<double> mm = aff_id;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = elem_at(tile, e, true);
      if (i >= n) continue;
      z = -uv[e] * z + th[e];
      const double w = cv[e] * z;
      w_p[i] = w;
      w_o[i] = static_cast<TO>(w);
      const double tm = i > 0 ? -__ldcg(u_p + i - 1) : 0.0;  // mu_i = -u_{i-1} mu_{i-1} + w_i
      mm = compose(Aff<double>{tm, w}, mm);
    }
    mine_m = compose(block_total(mm, false, tot_a), mine_m);
  }

  // V, exact: v_i = u_{i-1}^2 v_{i-1} + covs_i, left to right
  for (int k = 0; k < ntl; ++k) {
    const int tile = tile_at(lo, hi, k, false);
    double tv[kChunk], cv[kChunk];
    Aff<double> mv = aff_id;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = elem_at(tile, e, false);
      const double up = (i > 0 && i < n) ? __ldcg(u_p + i - 1) : 0.0;
      tv[e] = i < n ? up * up : 1.0;
      cv[e] = i < n ? __ldcg(cov_p + i) : 0.0;
      mv = compose(mv, Aff<double>{tv[e], cv[e]});
    }
    Aff<double> excl, total;
    block_scan(mv, false, tot_a, excl, total);
    double v = excl.a * carry_v + excl.b;
    carry_v = total.a * carry_v + total.b;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = elem_at(tile, e, false);
      v = tv[e] * v + cv[e];
      if (i < n) v_o[i] = static_cast<TO>(v);
    }
  }

  double carry_m = 0.0;
  if (threadIdx.x == 0 && bps > 1) agg[blockIdx.x].m = mine_m;
  sync_sequence(bps);
  if (bps > 1) carry_m = blocks_before(&agg_seq->m, sizeof(KAgg), bps, blk, false, &slot_a).b;

  // M, exact: mu_i = -u_{i-1} mu_{i-1} + w_i (mu_0 = w_0), left to right
  for (int k = 0; k < ntl; ++k) {
    const int tile = tile_at(lo, hi, k, false);
    double tv[kChunk], wv[kChunk];
    Aff<double> mm = aff_id;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = elem_at(tile, e, false);
      tv[e] = i >= n ? 1.0 : (i > 0 ? -__ldcg(u_p + i - 1) : 0.0);
      wv[e] = i < n ? __ldcg(w_p + i) : 0.0;
      mm = compose(mm, Aff<double>{tv[e], wv[e]});
    }
    Aff<double> excl, total;
    block_scan(mm, false, tot_a, excl, total);
    double mu = excl.a * carry_m + excl.b;
    carry_m = total.a * carry_m + total.b;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = elem_at(tile, e, false);
      mu = tv[e] * mu + wv[e];
      if (i < n) mu_o[i] = static_cast<TO>(mu);
    }
  }
}

// ------------------------------------------------------------ launching
// Blocks per sequence: as many as fit on the card beside the batch's other
// sequences, at most one per tile; 1 (no grid sync) when fewer than 2 fit.
// None of these kernels takes dynamic shared memory.
cudaError_t plan(const void* kernel, int batch, int n, Shape& shape) {
  int cap = 0;
  const cudaError_t err = vidp::coresident_blocks(kernel, kScanThreads, 0, cap);
  if (err != cudaSuccess) return err;
  const int ntiles = (n + kTile - 1) / kTile;
  int bps = std::min(cap / std::max(batch, 1), ntiles);
  if (bps < 2) bps = 1;
  shape = {batch * bps, bps};
  return cudaSuccess;
}

int launch(const void* kernel, Shape shape, void** args, void* stream) {
  return vidp::launch(kernel, shape, kScanThreads, 0, args, stream);
}

template <typename T>
int launch_linrec(const T* t, const T* c, const T* x0, T* out, void* agg, int batch,
                  int n, int reverse, void* stream) {
  const void* kernel = reinterpret_cast<const void*>(&linrec_kernel<T>);
  Shape shape;
  const cudaError_t err = plan(kernel, batch, n, shape);
  if (err != cudaSuccess) return static_cast<int>(err);
  Aff<T>* a = static_cast<Aff<T>*>(agg);
  void* args[] = {&t, &c, &x0, &out, &a, &n, &shape.bps, &reverse};
  return launch(kernel, shape, args, stream);
}

// K3: the pivot sweep on the naturals into the covs plane, then
// dist_q_kernel; scratch as dist_q_kernel's comment says, the sweep on nb
// windows of l.
template <typename TO>
int launch_dist_q(const double* nat1, const double* nat2d, const double* nat2s,
                  double* scratch, TO* covs, TO* a, TO* w, TO* mu, TO* v, int batch,
                  int n, int nb, int l, void* stream) {
  const void* kernel = reinterpret_cast<const void*>(&dist_q_kernel<TO>);
  Shape shape;
  cudaError_t err = plan(kernel, batch, n, shape);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t plane = static_cast<size_t>(batch) * n;
  double* sweep_scratch = scratch + 3 * plane;
  KAgg* agg = reinterpret_cast<KAgg*>(sweep_scratch + 6 * static_cast<size_t>(batch) * nb);
  const int e = vidp::sweep::launch<double>(vidp::sweep::Naturals{nat2d, nat2s}, scratch + plane,
                                            sweep_scratch, batch, n, nb, l, stream);
  if (e != 0) return e;
  void* args[] = {&nat1, &nat2s, &scratch, &covs, &a, &w, &mu, &v, &agg, &n, &shape.bps};
  return launch(kernel, shape, args, stream);
}

const void* scan_kernel(int which) {
  switch (which) {
    case 0: return reinterpret_cast<const void*>(&linrec_kernel<float>);
    case 1: return reinterpret_cast<const void*>(&linrec_kernel<double>);
    case 2: return reinterpret_cast<const void*>(&dist_q_kernel<float>);
    case 3: return reinterpret_cast<const void*>(&dist_q_kernel<double>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The launch shape of K2 (which = 0 f32, 1 f64) or K3's dist_q_kernel (2 f32
// out, 3 f64 out) for this batch and length on the current device: out[0]
// the grid, out[1] blocks per sequence, out[2] threads per block, out[3]
// elements per tile, out[4] doubles of aggregate scratch per block.
int vidp_scan_shape(int which, int batch, int n, int* out) {
  const void* kernel = scan_kernel(which);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Shape shape;
  const cudaError_t err = plan(kernel, batch, n, shape);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = shape.grid;
  out[1] = shape.bps;
  out[2] = kScanThreads;
  out[3] = kTile;
  out[4] = static_cast<int>((which < 2 ? sizeof(Aff<double>) : sizeof(KAgg)) / sizeof(double));
  return 0;
}

// The launch of the float64 sweep (K1, and K3's phase R when naturals = 1)
// for this batch and these windows: as vidp_riccati_f32_shape.
int vidp_riccati_f64_shape(int naturals, int batch, int nb, int l, int* out) {
  return naturals ? vidp::sweep::shape<double, vidp::sweep::Naturals>(batch, nb, l, out)
                  : vidp::sweep::shape<double, vidp::sweep::KdB2<double>>(batch, nb, l, out);
}

// K1; scratch: 6 * batch * nb doubles (the windows' maps, then their entries).
int vidp_riccati_f64(const double* kd, const double* b2, double* out, double* scratch,
                     int batch, int n, int nb, int l, void* stream) {
  return vidp::sweep::launch<double>(vidp::sweep::KdB2<double>{kd, b2}, out, scratch, batch, n,
                                     nb, l, stream);
}

int vidp_linrec_f64(const double* t, const double* c, const double* x0,
                    double* out, double* agg, int batch, int n, int reverse,
                    void* stream) {
  return launch_linrec<double>(t, c, x0, out, agg, batch, n, reverse, stream);
}

int vidp_linrec_f32(const float* t, const float* c, const float* x0, float* out,
                    float* agg, int batch, int n, int reverse, void* stream) {
  return launch_linrec<float>(t, c, x0, out, agg, batch, n, reverse, stream);
}

// K3; scratch: 3 * batch * n + 6 * batch * nb doubles, then the aggregates
// (vidp_scan_shape).
int vidp_dist_q_1d_f32(const double* nat1, const double* nat2d,
                       const double* nat2s, double* scratch, float* covs,
                       float* a, float* w, float* mu, float* v, int batch, int n,
                       int nb, int l, void* stream) {
  return launch_dist_q<float>(nat1, nat2d, nat2s, scratch, covs, a, w, mu, v,
                              batch, n, nb, l, stream);
}

int vidp_dist_q_1d_f64(const double* nat1, const double* nat2d,
                       const double* nat2s, double* scratch, double* covs,
                       double* a, double* w, double* mu, double* v, int batch,
                       int n, int nb, int l, void* stream) {
  return launch_dist_q<double>(nat1, nat2d, nat2s, scratch, covs, a, w, mu, v,
                               batch, n, nb, l, stream);
}

}  // extern "C"
