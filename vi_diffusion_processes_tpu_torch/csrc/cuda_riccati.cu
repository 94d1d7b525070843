// Hand-written Hopper kernel K4: the float32 UDU' pivot sweep
//
//   D_k = kd_k - b2_k / D_{k+1},   k = N-1 ... 0,   b2[N-1] = 0
//
// It replaces vi_diffusion_processes_tpu/ops/pallas_riccati.py::riccati_d_sweep:
// the Pallas kernels _compose_kernel (phase A) and _sweep_kernel (phase C)
// with the XLA lax.scan boundary pass between them (phase B).  It serves
// the x64-off configuration, whose naturals are float32.  The kernel is
// sweep_windows.cuh's windowed sweep in sequential order, in float32 (with
// eps = 1e-30 in the preconditioning, a reciprocal square root to normalise
// each step and a division in the recursion); K1 is the same kernel in
// float64, where every step is multiplies, fused multiply-adds and an exact
// power-of-two scaling.
//
// Interface: plain C functions that return a cudaError_t as an int.  The
// launcher launches on the given stream, never synchronises and allocates
// nothing: the caller brings the scratch, 6 floats a window.

#include "sweep_windows.cuh"

using vidp::sweep::KdB2;

extern "C" {

// The launch of K4 for this batch and these windows on the current device:
// out[0] the grid, out[1] blocks per sequence, out[2] threads per block,
// out[3] windows per block, out[4] windows per chunk, out[5] bytes of
// dynamic shared memory per block.
int vidp_riccati_f32_shape(int batch, int nb, int l, int* out) {
  return vidp::sweep::shape<float, KdB2<float>>(batch, nb, l, out);
}

// scratch: 6 * batch * nb floats (the windows' maps, then their entries).
int vidp_riccati_f32(const float* kd, const float* b2, float* out, float* scratch,
                     int batch, int n, int nb, int l, void* stream) {
  return vidp::sweep::launch<float>(KdB2<float>{kd, b2}, out, scratch, batch, n, nb, l, stream);
}

}  // extern "C"
