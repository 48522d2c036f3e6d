// Index helpers of the whole-solve kernels (bicgstab_kernels.cu,
// rbsor_kernels.cu): an (nz, ny, nx) float32 volume, row-major, nz == 1 a
// 2D plane whose one plane is interior, nz >= 3 a 3D volume with a z-shell.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clamp_index(int q, int n) {
  return q < 1 ? 1 : (q > n - 2 ? n - 2 : q);
}

struct Volume {
  int nz, ny, nx;
  bool three_d;
  long long sy, sz, n;
  // the interior as a dense index range: planes k0.., rows 1.., cols 1..
  int k0, mz, my, mx;
  long long n_in;

  __device__ Volume(int nz_, int ny_, int nx_)
      : nz(nz_), ny(ny_), nx(nx_), three_d(nz_ > 1), sy(nx_),
        sz((long long)ny_ * nx_), n((long long)nz_ * ny_ * nx_),
        k0(nz_ > 1 ? 1 : 0), mz(nz_ > 1 ? nz_ - 2 : 1), my(ny_ - 2),
        mx(nx_ - 2), n_in((long long)(nz_ > 1 ? nz_ - 2 : 1) * (ny_ - 2) *
                          (nx_ - 2)) {}

  // (k, j, i) of the m-th interior point
  __device__ void interior_coords(long long m, int& k, int& j, int& i) const {
    const long long row = m / mx;
    i = 1 + (int)(m - row * mx);
    const int kk = (int)(row / my);
    j = 1 + (int)(row - (long long)kk * my);
    k = k0 + kk;
  }

  __device__ long long at(int k, int j, int i) const {
    return k * sz + j * sy + i;
  }

  __device__ long long interior_point(long long m) const {
    int k, j, i;
    interior_coords(m, k, j, i);
    return at(k, j, i);
  }

  // The Neumann mirror's source of point c: x[clamp(k), clamp(j),
  // clamp(i)], each index clamped to [1, n - 2] (k only in 3D).  That is
  // the composite of the reference's face order (x faces, then y, then z;
  // later faces own the corners): c itself for an interior point, an
  // interior point for a shell one.
  __device__ long long mirror(long long c) const {
    const int k = (int)(c / sz);
    const long long q = c - k * sz;
    const int j = (int)(q / nx);
    const int i = (int)(q - (long long)j * nx);
    return at(three_d ? clamp_index(k, nz) : k, clamp_index(j, ny),
              clamp_index(i, nx));
  }

  // 5/7-point Laplacian at an interior point, the plain version's order:
  // ((x+ - 2f) + x-) a + ((y+ - 2f) + y-) b, then + ((z+ - 2f) + z-) c
  __device__ float lap(const float* f, long long c, float inv_dx2,
                       float inv_dy2, float inv_dz2) const {
    const float c2 = 2.0f * f[c];
    float l = ((f[c + 1] - c2) + f[c - 1]) * inv_dx2 +
              ((f[c + sy] - c2) + f[c - sy]) * inv_dy2;
    if (three_d) l = l + ((f[c + sz] - c2) + f[c - sz]) * inv_dz2;
    return l;
  }

  // The stationary sweeps' neighbour sum (x+ + x-) a + (y+ + y-) b, then
  // + (z+ + z-) c
  __device__ float neighbour_sum(const float* f, long long c, float inv_dx2,
                                 float inv_dy2, float inv_dz2) const {
    float nb = (f[c + 1] + f[c - 1]) * inv_dx2 +
               (f[c + sy] + f[c - sy]) * inv_dy2;
    if (three_d) nb = nb + (f[c + sz] + f[c - sz]) * inv_dz2;
    return nb;
  }
};

}  // namespace
