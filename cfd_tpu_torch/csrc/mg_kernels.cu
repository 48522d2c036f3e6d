// Hand-written CUDA kernels for the multigrid smoother on Hopper.
//
// They replace the TPU kernel make_mg_rb_sweep
// (cfd_tpu/ops/pallas/mg_kernels.py:50): one red-black Gauss-Seidel sweep
// of A x = b, A = -lap on the Dirichlet-0 interior, red-first or
// black-first, optionally with the post-sweep residual field
// r = b + lap x_new (zero shell).
//
//   mg_color_kernel     one colour of the sweep, in place on x
//   mg_residual_kernel  r = b + lap x on the interior, 0 on the shell
//
// What bounds them on an H100, and what the design does:
//
// * A sweep is a few flops per byte: bound by device-memory bandwidth.
//   The TPU function moves 3 fields (x, b in; x out), 4 with the residual.
//   The TPU kernel gets there by streaming z-planes through a VMEM ring,
//   red one plane ahead of black and the residual one more behind.  On
//   Hopper the blocks run in no order, so this first form works by colour:
//   one launch per colour, one thread per point of that colour (the thread
//   index along x counts every other point of the row), then a third
//   launch for the residual.  Each colour pass reads x and b in whole
//   sectors and writes half of x, so a sweep moves about 6 fields and the
//   residual 3 more: roughly twice the bound.  A z-marching tile that does
//   red on a haloed tile and black one plane behind is later work.
// * x is updated in place: a colour reads only the other colour, so no
//   thread reads a point another thread of the same launch writes.  (The
//   JAX function is pure; the wrapper documents the in-place contract.)
// * Built with -fmad=false, in the plain version's operation order
//   (nb = (x-pair)*inv_dx2 + (y-pair)*inv_dy2, then + (z-pair)*inv_dz2;
//   gs = (b + nb)*inv_factor; lap's second differences ((f+ - 2f) + f-)),
//   so the fields match the plain versions bit for bit.
// * nz == 1 is a 2D plane: its one plane is interior, parity is on i + j,
//   and there is no z term.
//
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32, kTileY = 8;

// One colour: points with (i + j + k) % 2 == parity on the interior.
__global__ void __launch_bounds__(kTileX * kTileY) mg_color_kernel(
    float* x, const float* __restrict__ b, int nz, int ny, int nx,
    float inv_dx2, float inv_dy2, float inv_dz2, float inv_factor,
    int parity) {
  const bool three_d = nz > 1;
  const int k = blockIdx.z + (three_d ? 1 : 0);
  const int j = blockIdx.y * kTileY + threadIdx.y;
  // every other point of row (j, k): i = 2 q + s, i + j + k = parity mod 2
  const int s = (parity + j + k) & 1;
  const int i = 2 * (blockIdx.x * kTileX + threadIdx.x) + s;
  if (j < 1 || j > ny - 2 || i < 1 || i > nx - 2) return;
  const long long sy = nx, sz = (long long)ny * nx;
  const long long c = k * sz + j * sy + i;
  float nb = (x[c + 1] + x[c - 1]) * inv_dx2 + (x[c + sy] + x[c - sy]) * inv_dy2;
  if (three_d) nb = nb + (x[c + sz] + x[c - sz]) * inv_dz2;
  x[c] = (b[c] + nb) * inv_factor;
}

// r = b + lap x on the interior (b - A x: A = -lap), 0 on the shell.
__global__ void __launch_bounds__(kTileX * kTileY) mg_residual_kernel(
    const float* __restrict__ x, const float* __restrict__ b,
    float* __restrict__ r, int nz, int ny, int nx, float inv_dx2,
    float inv_dy2, float inv_dz2) {
  const bool three_d = nz > 1;
  const int k = blockIdx.z;
  const int j = blockIdx.y * kTileY + threadIdx.y;
  const int i = blockIdx.x * kTileX + threadIdx.x;
  if (j >= ny || i >= nx) return;
  const long long sy = nx, sz = (long long)ny * nx;
  const long long c = k * sz + j * sy + i;
  const bool in = j > 0 && j < ny - 1 && i > 0 && i < nx - 1 &&
                  (!three_d || (k > 0 && k < nz - 1));
  if (!in) {
    r[c] = 0.0f;
    return;
  }
  const float c2 = 2.0f * x[c];
  float lap = ((x[c + 1] - c2) + x[c - 1]) * inv_dx2 +
              ((x[c + sy] - c2) + x[c - sy]) * inv_dy2;
  if (three_d) lap = lap + ((x[c + sz] - c2) + x[c - sz]) * inv_dz2;
  r[c] = b[c] + lap;
}

}  // namespace

extern "C" {

// One sweep: the colour of parity first_parity (0 red, 1 black), then the
// other; with r non-null the residual of the swept x.
int cfd_mg_rb_sweep(float* x, const float* b, float* r, int nz, int ny,
                    int nx, float inv_dx2, float inv_dy2, float inv_dz2,
                    float inv_factor, int first_parity, cudaStream_t stream) {
  const int half = (nx + 1) / 2;
  const dim3 block(kTileX, kTileY);
  const dim3 color_grid((half + kTileX - 1) / kTileX,
                        (ny + kTileY - 1) / kTileY, nz > 1 ? nz - 2 : 1);
  for (int pass = 0; pass < 2; ++pass) {
    mg_color_kernel<<<color_grid, block, 0, stream>>>(
        x, b, nz, ny, nx, inv_dx2, inv_dy2, inv_dz2, inv_factor,
        (first_parity + pass) & 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (r != nullptr) {
    const dim3 grid((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY,
                    nz);
    mg_residual_kernel<<<grid, block, 0, stream>>>(x, b, r, nz, ny, nx,
                                                   inv_dx2, inv_dy2, inv_dz2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
