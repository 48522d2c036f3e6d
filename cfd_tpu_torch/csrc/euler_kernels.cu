// Hand-written CUDA kernel for the explicit Euler step on Hopper.
//
// It replaces two TPU kernels of the reference:
//
//   make_euler_fused    (cfd_tpu/ops/pallas/euler_kernels.py, compute
//       :240-351 on the rolling engine)  the whole 3D step
//       -> euler_kernel<true, *> + reduce_max4_kernel (the flag: buoyancy
//          or energy on)
//   make_euler2d_fused  (cfd_tpu/ops/pallas/euler2d.py, compute :101-260
//       on the marching engine; the y-face wrap rows in the step wrapper,
//       cfd_tpu/solvers/ns/euler.py:280-311)  the whole 2D step
//       -> euler_kernel<false, *> + reduce_max4_kernel
//
// Both launch through cfd_euler_step, which picks the instantiation from
// nz (1: the 2D kernel) and from whether buoyancy or energy is on.  Their
// global-row modes (global_ny=, a decomposed shard's block) are
// euler_rows_kernel<true | false, *> through cfd_euler_step_rows.
//
// On a stretched grid (x/y; z stays uniform) the spacing parameter kS of
// explicit_common.cuh selects the derivative provider: parity (per-point
// forward spacings, the reference C library's stencils) or consistent
// (the exact nonuniform weights, with its own energy stencils); parity
// with the energy equation is never launched (cfd_euler_step refuses it,
// as the reference's builder does, euler_kernels.py:110-113).
//
// Per interior point (uniform grid; the 2D instantiation drops every z
// term, the reference's inv_dz2 = 0 idiom):
// derivatives clamped to +-100 and each second-derivative term to +-1000
// before the sum, du = cdt * (-u.grad u - dp_x / rho + nu lap u + src),
// u' = clamp(u + clamp(du, 1), 100), p' = p + clamp(-c cdt rho
// clamp(div, 10), 1), all kept at their old values where rho <= 1e-10.
// Velocity shells pass through from the input; p, rho and T take the
// periodic wrap x -> y -> z of the updated field.  With Boussinesq
// buoyancy every component's source takes ((-beta) g[c]) (T - T_ref).
// With the energy equation T is advected by the UPDATED velocities and
// diffused, interior only and unguarded, T' = T + cdt (-u.grad T +
// alpha lap T); after the wrap come the thermal faces, left, right,
// bottom, top, then back and front (euler_kernels.py:314-360).
//
// Design.  The TPU kernel streamed planes through a VMEM ring and took the
// z faces from the engine's shell snapshots.  Here one thread owns one
// point and reads its neighbours from device memory through L1/L2: a
// stencil at ~60 flops per 40 bytes moved is bound by HBM bandwidth
// (6 fields in, 6 out).  The wrap reads updated values at other points:
// a face point's p is the update at its wrap source (corner (0, 0) that
// of (ny-2, nx-2), a z face the wrapped plane nz-2 or 1).  Rather than a
// grid-wide barrier and a second launch, every thread computes the update
// at its own wrap source, which is itself for an interior point; only the
// shell threads (2-3% at 256^3) recompute a neighbour's update.  The
// thermal faces are the same kind of map (explicit_common.cuh:
// thermal_source): a Neumann face copies its neighbour's updated T, so
// its thread evaluates the step a second time at that point when it is
// not the p wrap source.  The step
// maxima of |u|^2, p, |p| and T over the whole output are folded per
// block and then by one block (reduce_max4_kernel); they keep NaN, so a
// NaN anywhere makes the step report DIVERGED.
//
// Built with -fmad=false: every multiply and add rounds separately, in
// the operation order of the plain version
// (cfd_tpu_torch/ops/kernels/euler_kernels.py:euler_step_plain).  Every
// entry point returns cudaGetLastError().

#include "explicit_common.cuh"

namespace {

struct Coefs {
  float mu, coef, c2x, c2y, c2z, cx2, cy2, cz2;
};

struct Update {
  float u, v, w, p;
};

// The step's update at interior point c = (k, j, i).  kThermal
// instantiates the buoyant and energy code; without it the kernel is the
// plain step's, with its register footprint.  kS: the spacing provider.
template <bool k3D, bool kThermal, int kS>
__device__ __forceinline__ Update euler_update(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ p,
    const float* __restrict__ rho, const float* __restrict__ T,
    const float* __restrict__ syv, const float* __restrict__ sxv,
    const float* __restrict__ scal, long long c, long long sy, long long sz,
    int j, int i, const Coefs& k, const Thermal& th, const Stretch& st) {
  const float uc = u[c], vc = v[c], wc = w[c], pc = p[c], r = rho[c];
  Update o = {uc, vc, wc, pc};
  if (!(r > kRhoMin)) return o;  // per-point guard (NaN rho too)
  const float cdt = scal[0], su_eff = scal[1], sv_eff = scal[2];

  auto d1x = [&](const float* f) {
    return clampv(
        d1_at<kS>(f[c - 1], f[c], f[c + 1], k.c2x, st.x, st.nx, i), kD1);
  };
  auto d1y = [&](const float* f) {
    return clampv(
        d1_at<kS>(f[c - sy], f[c], f[c + sy], k.c2y, st.y, st.ny, j), kD1);
  };
  auto d1z = [&](const float* f) {
    return clampv((f[c + sz] - f[c - sz]) * k.c2z, kD1);
  };
  auto lap = [&](const float* f, float fc) {
    float l =
        clampv(d2_at<kS>(f[c - 1], fc, f[c + 1], k.cx2, st.x, st.nx, i),
               kD2) +
        clampv(d2_at<kS>(f[c - sy], fc, f[c + sy], k.cy2, st.y, st.ny, j),
               kD2);
    if (k3D)
      l = l + clampv(((f[c + sz] - 2.0f * fc) + f[c - sz]) * k.cz2, kD2);
    return l;
  };

  const float du_dx = d1x(u), du_dy = d1y(u);
  const float dv_dx = d1x(v), dv_dy = d1y(v);
  const float dw_dx = d1x(w), dw_dy = d1y(w);
  const float dp_dx = d1x(p), dp_dy = d1y(p);
  const float nu = viscosity(k.mu, r);
  float su = su_eff * syv[j], sv = sv_eff * sxv[i], sw = 0.0f;
  if (kThermal && th.buoy) {
    const float dT = T[c] - th.tref;
    su = su + th.coef[0] * dT;
    sv = sv + th.coef[1] * dT;
    sw = th.coef[2] * dT;
  }

  float tu = -uc * du_dx - vc * du_dy;
  float tv = -uc * dv_dx - vc * dv_dy;
  float tw = -uc * dw_dx - vc * dw_dy;
  float div = du_dx + dv_dy;
  if (k3D) {
    const float du_dz = d1z(u), dv_dz = d1z(v), dw_dz = d1z(w);
    tu = tu - wc * du_dz;
    tv = tv - wc * dv_dz;
    tw = (tw - wc * dw_dz) - d1z(p) / r;
    div = div + dw_dz;
  }
  const float du = cdt * (((tu - dp_dx / r) + nu * lap(u, uc)) + su);
  const float dv = cdt * (((tv - dp_dy / r) + nu * lap(v, vc)) + sv);
  float rw = tw + nu * lap(w, wc);
  if (kThermal && th.buoy) rw = rw + sw;
  const float dw = cdt * rw;

  o.u = clampv(uc + clampv(du, kUpdate), kVel);
  o.v = clampv(vc + clampv(dv, kUpdate), kVel);
  o.w = clampv(wc + clampv(dw, kUpdate), kVel);
  o.p = pc + clampv(((-k.coef * cdt) * r) * clampv(div, kDiv), kUpdate);
  return o;
}

template <bool k3D, bool kThermal, int kS>
__global__ void __launch_bounds__(kTileX * kTileY) euler_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ p,
    const float* __restrict__ T, const float* __restrict__ rho,
    const float* __restrict__ syv, const float* __restrict__ sxv,
    const float* __restrict__ scal, float* __restrict__ uo,
    float* __restrict__ vo, float* __restrict__ wo, float* __restrict__ po,
    float* __restrict__ rhoo, float* __restrict__ To,
    float* __restrict__ partials, int nz, int ny, int nx, Coefs coefs,
    Thermal th, Stretch st) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  if (i < nx && j < ny) {
    const long long sy = nx, sz = (long long)ny * nx;
    const long long c = k * sz + j * sy + i;
    const int ks = k3D ? wrap_src(k, nz) : 0;
    const int js = wrap_src(j, ny), is = wrap_src(i, nx);
    const long long cs = ks * sz + js * sy + is;
    const bool interior = cs == c;  // interior points are their own source
    const Update e = euler_update<k3D, kThermal, kS>(
        u, v, w, p, rho, T, syv, sxv, scal, cs, sy, sz, js, is, coefs, th,
        st);
    const float ou = interior ? e.u : u[c];
    const float ov = interior ? e.v : v[c];
    const float ow = interior ? e.w : w[c];
    float ot;
    if (kThermal && kS != kParity && th.energy) {
      int kT, jT, iT;
      if (!thermal_source<k3D>(th, k, j, i, nz, ny, nx, kT, jT, iT, ot)) {
        const long long cT = kT * sz + jT * sy + iT;
        const Update et =
            cT == cs ? e
                     : euler_update<k3D, kThermal, kS>(
                           u, v, w, p, rho, T, syv, sxv, scal, cT, sy, sz,
                           jT, iT, coefs, th, st);
        ot = energy_update<k3D, kS>(T, cT, sy, sz, jT, iT, et.u, et.v, et.w,
                                    scal[0], th.alpha, coefs.c2x, coefs.c2y,
                                    coefs.c2z, coefs.cx2, coefs.cy2,
                                    coefs.cz2, st);
      }
    } else {
      ot = T[cs];
    }
    uo[c] = ou;
    vo[c] = ov;
    wo[c] = ow;
    po[c] = e.p;
    rhoo[c] = rho[cs];
    To[c] = ot;
    m[0] = (ou * ou + ov * ov) + ow * ow;
    m[1] = e.p;
    m[2] = fabsf(e.p);
    m[3] = ot;
  }
  block_max4(m, partials);
}

template <bool k3D, bool kThermal, int kS>
int launch_euler(const float* u, const float* v, const float* w,
                 const float* p, const float* T, const float* rho,
                 const float* syv, const float* sxv, const float* scal,
                 float* uo, float* vo, float* wo, float* po, float* rhoo,
                 float* To, float* partials, float* out, int nz, int ny,
                 int nx, Coefs coefs, const Thermal& th, const Stretch& st,
                 cudaStream_t stream) {
  euler_kernel<k3D, kThermal, kS><<<grid_of(nz, ny, nx),
                                    dim3(kTileX, kTileY), 0, stream>>>(
      u, v, w, p, T, rho, syv, sxv, scal, uo, vo, wo, po, rhoo, To, partials,
      nz, ny, nx, coefs, th, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_max4_kernel<<<1, kReduceThreads, 0, stream>>>(
      partials, blocks_of(nz, ny, nx), out);
  return (int)cudaGetLastError();
}

// The global-row mode of a decomposed shard's block (explicit_common.cuh:
// Shard; E3 make_euler_fused(global_ny=...), euler_kernels.py:78-86 and
// :108-118 of the reference, and E2 make_euler2d_fused(global_ny=...),
// euler2d.py:46-76): one thread per owned point of the halo-padded
// block, outputs of the owned window's size.  The x wrap and x thermal
// faces stay in the kernel, an x-face point evaluating the update at its
// source in its own row; the y-face rows and z-shell planes are passed
// through (the wrapper wraps p, rho and T there; the velocities passed
// through are already the step's), so no z or y wrap and no y or z
// thermal face is applied here.  An owned point off those faces is an
// interior point of the padded block, so its update is the single-device
// kernel's arithmetic.  The maxima: |u|^2 over every owned point, p and
// T off the faces (a wrapped face holds a copy of a value off them; the
// wrapper folds in its Dirichlet T faces).
// syv and the spacing's y rows are the block's rows of the global ones.
template <bool k3D, bool kThermal, int kS>
__global__ void __launch_bounds__(kTileX * kTileY) euler_rows_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ p,
    const float* __restrict__ T, const float* __restrict__ rho,
    const float* __restrict__ syv, const float* __restrict__ sxv,
    const float* __restrict__ scal, float* __restrict__ uo,
    float* __restrict__ vo, float* __restrict__ wo, float* __restrict__ po,
    float* __restrict__ rhoo, float* __restrict__ To,
    float* __restrict__ partials, int nzl, int nyl, int nx, Coefs coefs,
    Thermal th, Stretch st, Shard sh) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  if (i < nx && j < nyl) {
    const int jp = j + sh.hy;
    const long long sy = nx, sz = (long long)(nyl + 2 * sh.hy) * nx;
    const long long c = (k + sh.hz) * sz + jp * sy + i;
    const long long o = ((long long)k * nyl + j) * nx + i;
    const int jg = sh.y_base + j, kg = sh.z_base + k;
    const bool face = jg < 1 || jg > sh.ny_g - 2 ||
                      (k3D && (kg < 1 || kg > sh.nz_g - 2));
    if (face) {
      const float ou = u[c], ov = v[c], ow = w[c];
      uo[o] = ou;
      vo[o] = ov;
      wo[o] = ow;
      po[o] = p[c];
      rhoo[o] = rho[c];
      To[o] = T[c];
      m[0] = (ou * ou + ov * ov) + ow * ow;  // final: the shells pass
    } else {
      const int is = wrap_src(i, nx);
      const long long cs = c - i + is;
      const Update e = euler_update<k3D, kThermal, kS>(
          u, v, w, p, rho, T, syv, sxv, scal, cs, sy, sz, jp, is, coefs, th,
          st);
      const bool interior = is == i;
      const float ou = interior ? e.u : u[c];
      const float ov = interior ? e.v : v[c];
      const float ow = interior ? e.w : w[c];
      float ot;
      if (kThermal && kS != kParity && th.energy) {
        int kT, jT, iT;
        if (!thermal_source<false, false>(th, 0, jp, i, 1, 1, nx, kT, jT,
                                          iT, ot)) {
          const long long cT = c - i + iT;
          const Update et =
              cT == cs ? e
                       : euler_update<k3D, kThermal, kS>(
                             u, v, w, p, rho, T, syv, sxv, scal, cT, sy, sz,
                             jp, iT, coefs, th, st);
          ot = energy_update<k3D, kS>(T, cT, sy, sz, jp, iT, et.u, et.v,
                                      et.w, scal[0], th.alpha, coefs.c2x,
                                      coefs.c2y, coefs.c2z, coefs.cx2,
                                      coefs.cy2, coefs.cz2, st);
        }
      } else {
        ot = T[cs];
      }
      uo[o] = ou;
      vo[o] = ov;
      wo[o] = ow;
      po[o] = e.p;
      rhoo[o] = rho[cs];
      To[o] = ot;
      m[0] = (ou * ou + ov * ov) + ow * ow;
      m[1] = e.p;
      m[2] = fabsf(e.p);
      m[3] = ot;
    }
  }
  block_max4(m, partials);
}

template <bool k3D, bool kThermal, int kS>
int launch_euler_rows(const float* u, const float* v, const float* w,
                      const float* p, const float* T, const float* rho,
                      const float* syv, const float* sxv, const float* scal,
                      float* uo, float* vo, float* wo, float* po,
                      float* rhoo, float* To, float* partials, float* out,
                      int nzl, int nyl, int nx, Coefs coefs,
                      const Thermal& th, const Stretch& st, const Shard& sh,
                      cudaStream_t stream) {
  euler_rows_kernel<k3D, kThermal, kS><<<grid_of(nzl, nyl, nx),
                                         dim3(kTileX, kTileY), 0, stream>>>(
      u, v, w, p, T, rho, syv, sxv, scal, uo, vo, wo, po, rhoo, To, partials,
      nzl, nyl, nx, coefs, th, st, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_max4_kernel<<<1, kReduceThreads, 0, stream>>>(
      partials, blocks_of(nzl, nyl, nx), out);
  return (int)cudaGetLastError();
}

using EulerRowsLaunch = int (*)(const float*, const float*, const float*,
                                const float*, const float*, const float*,
                                const float*, const float*, const float*,
                                float*, float*, float*, float*, float*,
                                float*, float*, float*, int, int, int, Coefs,
                                const Thermal&, const Stretch&, const Shard&,
                                cudaStream_t);

template <bool k3D, bool kThermal>
EulerRowsLaunch pick_rows_spacing(int spacing) {
  if (spacing == kParity) return launch_euler_rows<k3D, kThermal, kParity>;
  if (spacing == kConsistent)
    return launch_euler_rows<k3D, kThermal, kConsistent>;
  return launch_euler_rows<k3D, kThermal, kUniform>;
}

using EulerLaunch = int (*)(const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            float*, float*, float*, float*, float*, float*,
                            float*, float*, int, int, int, Coefs,
                            const Thermal&, const Stretch&, cudaStream_t);

template <bool k3D, bool kThermal>
EulerLaunch pick_spacing(int spacing) {
  if (spacing == kParity) return launch_euler<k3D, kThermal, kParity>;
  if (spacing == kConsistent) return launch_euler<k3D, kThermal, kConsistent>;
  return launch_euler<k3D, kThermal, kUniform>;
}

}  // namespace

extern "C" {

// Blocks of every explicit kernel's launch: the length / 4 of partials.
long long cfd_explicit_partials(int nz, int ny, int nx) {
  return blocks_of(nz, ny, nx);
}

// thermal_f and thermal_i are host arrays (explicit_common.cuh:
// thermal_from): alpha, (-beta) g, T_ref, the Dirichlet values; the
// energy and buoyancy switches, the face types.  spacing is kUniform,
// kParity or kConsistent, xw and yw its weight rows (null when uniform).
int cfd_euler_step(const float* u, const float* v, const float* w,
                   const float* p, const float* T, const float* rho,
                   const float* syv, const float* sxv, const float* scal,
                   float* uo, float* vo, float* wo, float* po, float* rhoo,
                   float* To, float* partials, float* out, int nz, int ny,
                   int nx, float mu, float coef, float c2x, float c2y,
                   float c2z, float cx2, float cy2, float cz2,
                   const float* thermal_f, const int* thermal_i,
                   const float* xw, const float* yw, int spacing,
                   cudaStream_t stream) {
  const Coefs coefs = {mu, coef, c2x, c2y, c2z, cx2, cy2, cz2};
  const Thermal th = thermal_from(thermal_f, thermal_i);
  if (spacing == kParity && th.energy)
    return (int)cudaErrorInvalidValue;  // parity has no stretched energy
  const Stretch st = {xw, yw, nx, ny};
  const bool thermal = th.energy || th.buoy;
  EulerLaunch launch;
  if (nz > 1)
    launch = thermal ? pick_spacing<true, true>(spacing)
                     : pick_spacing<true, false>(spacing);
  else
    launch = thermal ? pick_spacing<false, true>(spacing)
                     : pick_spacing<false, false>(spacing);
  return launch(u, v, w, p, T, rho, syv, sxv, scal, uo, vo, wo, po, rhoo, To,
                partials, out, nz > 1 ? nz : 1, ny, nx, coefs, th, st,
                stream);
}

// The global-row mode (euler_rows_kernel): fields are the shard's
// halo-padded block of (nzl + 2 hz, nyl + 2 hy, nx) (nzl = 1, hz = 0 on a
// 2D grid, nz_g = 1), syv and yw the block's rows, outputs (nzl, nyl, nx);
// partials of cfd_explicit_partials(nzl, nyl, nx).
int cfd_euler_step_rows(const float* u, const float* v, const float* w,
                        const float* p, const float* T, const float* rho,
                        const float* syv, const float* sxv,
                        const float* scal, float* uo, float* vo, float* wo,
                        float* po, float* rhoo, float* To, float* partials,
                        float* out, int nzl, int nyl, int nx, float mu,
                        float coef, float c2x, float c2y, float c2z,
                        float cx2, float cy2, float cz2,
                        const float* thermal_f, const int* thermal_i,
                        const float* xw, const float* yw, int spacing,
                        int hz, int hy, int z_base, int nz_g, int y_base,
                        int ny_g, cudaStream_t stream) {
  const Coefs coefs = {mu, coef, c2x, c2y, c2z, cx2, cy2, cz2};
  const Thermal th = thermal_from(thermal_f, thermal_i);
  if (spacing == kParity && th.energy) return (int)cudaErrorInvalidValue;
  const Shard sh = {hz, hy, z_base, nz_g, y_base, ny_g};
  const Stretch st = {xw, yw, nx, nyl + 2 * hy};
  const bool thermal = th.energy || th.buoy;
  EulerRowsLaunch launch;
  if (nz_g > 1)
    launch = thermal ? pick_rows_spacing<true, true>(spacing)
                     : pick_rows_spacing<true, false>(spacing);
  else
    launch = thermal ? pick_rows_spacing<false, true>(spacing)
                     : pick_rows_spacing<false, false>(spacing);
  return launch(u, v, w, p, T, rho, syv, sxv, scal, uo, vo, wo, po, rhoo, To,
                partials, out, nz_g > 1 ? nzl : 1, nyl, nx, coefs, th, st,
                sh, stream);
}

}  // extern "C"
