// Hand-written CUDA kernel for one RK2 / RK4 stage on Hopper.
//
// It replaces two TPU kernels of the reference:
//
//   make_rk_stage    (cfd_tpu/ops/pallas/rk_kernels.py, compute :186-359 on
//       the rolling engine)  one 3D stage, mid or final
//       -> rk_kernel<true, false, *> / rk_kernel<true, true, *> +
//          reduce_max4_kernel (the last flag: buoyancy or energy on)
//   make_rk2d_stage  (cfd_tpu/ops/pallas/rk2d.py, compute :116-298 on the
//       marching engine; the y-face wrap rows in the step wrapper,
//       cfd_tpu/solvers/ns/rk.py:243-246)  one 2D stage
//       -> rk_kernel<false, false, *> / rk_kernel<false, true, *> + the
//          same
//
// Both launch through cfd_rk_stage, which picks the instantiation from nz
// (1: the 2D kernel), the stage kind and whether buoyancy or energy is
// on.  Their sharded modes (a decomposed shard's block: make_rk_stage's
// global_nz and global_nz + global_ny, make_rk2d_stage's global_ny) are
// rk_shard_kernel<*, *, *, *, kZ | kRows> through cfd_rk_stage_shard.
//
// One stage, with (factor, acc_mix, weight) choosing the Butcher position:
//
//   k    = RHS(stage state)    periodic-interior stencils: i == 1 reads
//                              nx - 2, i == nx - 2 reads 1, likewise in y
//                              and z (ns_momentum_rhs_scalar.h:78-90);
//                              zero on the shell and where rho <= 1e-10
//   next = clamp(q0 + factor * (acc_mix * acc + k))   velocities +-100
//   acc' = acc + weight * k
//
// A mid stage writes (next, acc') at every point.  The final stage writes
// the finished state: next, rho and T with the periodic wrap x -> y -> z
// (velocities too: RK wraps everything), and the step maxima of |u|^2,
// p, |p| and T.  A null accumulator reads as zero (the first stage).
// Boussinesq buoyancy joins every stage's sources with the step-start T
// (rk_kernels.py:292).  The energy equation runs in the final stage: T
// advected by the FINAL velocities, interior only, then the wrap and the
// thermal faces (rk_kernels.py:325-360), as in euler_kernels.cu.
//
// On a stretched grid the spacing parameter kS (explicit_common.cuh)
// selects parity or consistent derivatives, with the weights of the point
// whose RHS is evaluated (rk_kernels.py:206-237 of the reference); parity
// with the energy equation is never launched.
//
// Design.  The TPU kernel took the z-wrap neighbours (planes nz - 2 and 1)
// from pinned inputs because its streaming window could not see the far
// end of the array.  Here one thread owns one point and the wrap is an
// index map, so no pins.  Each stage reads ~13 fields and writes 8 (mid)
// or 6 (final): bound by HBM bandwidth.  The final stage's face points
// take updated values from their wrap sources; as in euler_kernels.cu
// every thread evaluates the stage at its own wrap source (itself for an
// interior point), so no second launch or grid-wide barrier is needed;
// a thermal face thread whose Neumann neighbour is not that source
// evaluates the stage a second time there.
//
// Built with -fmad=false, in the operation order of the plain version
// (cfd_tpu_torch/ops/kernels/rk_kernels.py:rk_stage_plain).  Every entry
// point returns cudaGetLastError().

#include "explicit_common.cuh"

namespace {

struct Coefs {
  float mu, coef, c2x, c2y, c2z, cx2, cy2, cz2;
};

struct Fields {
  const float *u, *v, *w, *p;          // stage state
  const float *q0u, *q0v, *q0w, *q0p;  // step-start state
  const float *rho, *T;
  const float *au, *av, *aw, *ap;      // accumulator, or all null
  const float *syv, *sxv;              // sin(pi y), sin(2 pi x)
  const float* scal;  // factor, acc_mix, weight, su_eff, sv_eff, dt
  // the z-wrap pins of a z-decomposed shard's block: planes of the
  // block's (ny, nx) of u, v, w, p at global plane nz - 2, then at
  // global plane 1 (8 planes; null on one device)
  const float* pin;
};

// The stage's modes: one device; a z-decomposed shard's block (global_nz:
// the z wrap from pins, y and x in the block); a shard's block of the
// global-row mode (global_nz + global_ny in 3D, global_ny in 2D: the y
// neighbours by global row, over a periodic 2-row halo ring).
constexpr int kOne = 0, kZ = 1, kRows = 2;

struct Outs {
  float* o[8];  // mid: next u, v, w, p, acc u, v, w, p; final: u, v, w, p,
                // rho, T
};

struct Rhs {
  float u, v, w, p;
};

// k = RHS(stage state) at interior point c = (k, j, i) of the block.  In
// the sharded modes (kMode != kOne) the periodic-interior neighbours key
// on the global plane kg and row jg: at kg == 1 (nz_g - 2) the z
// neighbour is the pin plane of global plane nz_g - 2 (1); in kRows the y
// neighbour at jg == 1 (ny_g - 2) is the row three below (above), which
// the periodic 2-row halo ring makes global row ny_g - 2 (1).
template <bool k3D, bool kThermal, int kS, int kMode = kOne>
__device__ __forceinline__ Rhs rk_rhs(const Fields& f, long long c,
                                      long long sy, long long sz, int k,
                                      int j, int i, int nz, int ny, int nx,
                                      const Coefs& q, const Thermal& th,
                                      const Stretch& st,
                                      const Shard* sh = nullptr) {
  const long long xl = i == 1 ? c + (nx - 3) : c - 1;
  const long long xr = i == nx - 2 ? c - (nx - 3) : c + 1;
  long long yd, yu, zb, zf;
  int kg = 0;
  if (kMode == kRows) {
    const int jg = sh->y_base + j - sh->hy;
    yd = jg == 1 ? c - 3 * sy : c - sy;
    yu = jg == sh->ny_g - 2 ? c + 3 * sy : c + sy;
  } else {
    yd = j == 1 ? c + (ny - 3) * sy : c - sy;
    yu = j == ny - 2 ? c - (ny - 3) * sy : c + sy;
  }
  if (kMode == kOne) {
    zb = k == 1 ? c + (nz - 3) * sz : c - sz;
    zf = k == nz - 2 ? c - (nz - 3) * sz : c + sz;
  } else {
    kg = sh->z_base + k - sh->hz;
    zb = c - sz;
    zf = c + sz;
  }
  // the z neighbours of field q (0-3: u, v, w, p)
  const long long pc = (long long)j * nx + i, plane = sz;
  auto zm = [&](const float* g, int fq) {
    if (kMode != kOne && kg == 1) return f.pin[fq * plane + pc];
    return g[zb];
  };
  auto zp = [&](const float* g, int fq) {
    if (kMode != kOne && kg == sh->nz_g - 2)
      return f.pin[(4 + fq) * plane + pc];
    return g[zf];
  };

  auto d1x = [&](const float* g) {
    return clampv(d1_at<kS>(g[xl], g[c], g[xr], q.c2x, st.x, st.nx, i), kD1);
  };
  auto d1y = [&](const float* g) {
    return clampv(d1_at<kS>(g[yd], g[c], g[yu], q.c2y, st.y, st.ny, j), kD1);
  };
  auto d1z = [&](const float* g, int fq) {
    return clampv((zp(g, fq) - zm(g, fq)) * q.c2z, kD1);
  };
  auto lap = [&](const float* g, float gc, int fq) {
    float l =
        clampv(d2_at<kS>(g[xl], gc, g[xr], q.cx2, st.x, st.nx, i), kD2) +
        clampv(d2_at<kS>(g[yd], gc, g[yu], q.cy2, st.y, st.ny, j), kD2);
    if (k3D)
      l = l + clampv(((zp(g, fq) - 2.0f * gc) + zm(g, fq)) * q.cz2, kD2);
    return l;
  };

  const float uc = f.u[c], vc = f.v[c], wc = f.w[c], r = f.rho[c];
  const float du_dx = d1x(f.u), du_dy = d1y(f.u);
  const float dv_dx = d1x(f.v), dv_dy = d1y(f.v);
  const float dw_dx = d1x(f.w), dw_dy = d1y(f.w);
  const float dp_dx = d1x(f.p), dp_dy = d1y(f.p);
  const float nu = viscosity(q.mu, r);
  float su = f.scal[3] * f.syv[j], sv = f.scal[4] * f.sxv[i], sw = 0.0f;
  if (kThermal && th.buoy) {
    const float dT = f.T[c] - th.tref;
    su = su + th.coef[0] * dT;
    sv = sv + th.coef[1] * dT;
    sw = th.coef[2] * dT;
  }

  float tu = -uc * du_dx - vc * du_dy;
  float tv = -uc * dv_dx - vc * dv_dy;
  float tw = -uc * dw_dx - vc * dw_dy;
  float div = du_dx + dv_dy;
  if (k3D) {
    const float du_dz = d1z(f.u, 0), dv_dz = d1z(f.v, 1),
                dw_dz = d1z(f.w, 2);
    tu = tu - wc * du_dz;
    tv = tv - wc * dv_dz;
    tw = (tw - wc * dw_dz) - d1z(f.p, 3) / r;
    div = div + dw_dz;
  }
  const float ok = r > kRhoMin ? 1.0f : 0.0f;  // guard (NaN rho too)
  Rhs o;
  o.u = (((tu - dp_dx / r) + nu * lap(f.u, uc, 0)) + su) * ok;
  o.v = (((tv - dp_dy / r) + nu * lap(f.v, vc, 1)) + sv) * ok;
  float rw = tw + nu * lap(f.w, wc, 2);
  if (kThermal && th.buoy) rw = rw + sw;
  o.w = rw * ok;
  o.p = ((-q.coef * r) * clampv(div, kDiv)) * ok;
  return o;
}

// kThermal instantiates the buoyant and energy code; without it the
// kernel is the plain stage's, with its register footprint.
template <bool k3D, bool kFinal, bool kThermal, int kS>
__global__ void __launch_bounds__(kTileX * kTileY) rk_kernel(
    Fields f, Outs out, float* __restrict__ partials, int nz, int ny,
    int nx, Coefs coefs, Thermal th, Stretch st) {
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
    // the final stage evaluates each point's wrap source; a mid stage
    // evaluates the point itself, with k = 0 on the shell
    const long long e = kFinal ? cs : c;
    Rhs r = {0.0f, 0.0f, 0.0f, 0.0f};
    if (kFinal || cs == c)
      r = rk_rhs<k3D, kThermal, kS>(f, e, sy, sz, ks, js, is, nz, ny, nx,
                                    coefs, th, st);
    const float factor = f.scal[0], acc_mix = f.scal[1];
    const bool acc = f.au != nullptr;
    const float au = acc ? f.au[e] : 0.0f, av = acc ? f.av[e] : 0.0f;
    const float aw = acc ? f.aw[e] : 0.0f, ap = acc ? f.ap[e] : 0.0f;
    const float un = clampv(f.q0u[e] + factor * (acc_mix * au + r.u), kVel);
    const float vn = clampv(f.q0v[e] + factor * (acc_mix * av + r.v), kVel);
    const float wn = clampv(f.q0w[e] + factor * (acc_mix * aw + r.w), kVel);
    const float pn = f.q0p[e] + factor * (acc_mix * ap + r.p);
    out.o[0][c] = un;
    out.o[1][c] = vn;
    out.o[2][c] = wn;
    out.o[3][c] = pn;
    if (kFinal) {
      float ot;
      if (kThermal && kS != kParity && th.energy) {
        int kT, jT, iT;
        if (!thermal_source<k3D>(th, k, j, i, nz, ny, nx, kT, jT, iT,
                                 ot)) {
          const long long cT = kT * sz + jT * sy + iT;
          float ut = un, vt = vn, wt = wn;
          if (cT != cs) {  // the final velocities at the T source
            const Rhs rt = rk_rhs<k3D, kThermal, kS>(
                f, cT, sy, sz, kT, jT, iT, nz, ny, nx, coefs, th, st);
            const float aut = acc ? f.au[cT] : 0.0f;
            const float avt = acc ? f.av[cT] : 0.0f;
            const float awt = acc ? f.aw[cT] : 0.0f;
            ut = clampv(f.q0u[cT] + factor * (acc_mix * aut + rt.u), kVel);
            vt = clampv(f.q0v[cT] + factor * (acc_mix * avt + rt.v), kVel);
            wt = clampv(f.q0w[cT] + factor * (acc_mix * awt + rt.w), kVel);
          }
          ot = energy_update<k3D, kS>(f.T, cT, sy, sz, jT, iT, ut, vt, wt,
                                      f.scal[5], th.alpha, coefs.c2x,
                                      coefs.c2y, coefs.c2z, coefs.cx2,
                                      coefs.cy2, coefs.cz2, st);
        }
      } else {
        ot = f.T[cs];
      }
      out.o[4][c] = f.rho[cs];
      out.o[5][c] = ot;
      m[0] = (un * un + vn * vn) + wn * wn;
      m[1] = pn;
      m[2] = fabsf(pn);
      m[3] = ot;
    } else {
      const float weight = f.scal[2];
      out.o[4][c] = au + weight * r.u;
      out.o[5][c] = av + weight * r.v;
      out.o[6][c] = aw + weight * r.w;
      out.o[7][c] = ap + weight * r.p;
    }
  }
  if (kFinal) block_max4(m, partials);
}

// One stage on a decomposed shard's block (explicit_common.cuh: Shard;
// the reference's make_rk_stage(global_nz=..., global_ny=...),
// rk_kernels.py:61-125, :183-184, and make_rk2d_stage(global_ny=...),
// rk2d.py:56-91): one thread per owned point of the halo-padded block.
// kMode kZ (3D, hy = 0, the block's rows whole): the z neighbours of
// global planes 1 and nz_g - 2 are the pins, y and x are the single-device
// kernel's, the final stage's x and y wraps and x / y thermal faces in
// the kernel.  kRows (3D with the pins, or 2D): the y neighbours by global
// row (rk_rhs), the final stage's x wrap and x thermal faces in the
// kernel.  The global z-shell planes (and, in kRows, the y-face rows),
// which the wrapper rewrites, take k = 0 at their own point and leave the
// maxima (the wrapper's periodic faces hold copies of values off them,
// its Dirichlet T faces it folds in itself).  A mid stage writes the
// next state and accumulator into the owned window of padded
// (block-shaped) outputs, whose halos the wrapper then fills; the final
// stage writes owned-size outputs.
template <bool k3D, bool kFinal, bool kThermal, int kS, int kMode>
__global__ void __launch_bounds__(kTileX * kTileY) rk_shard_kernel(
    Fields f, Outs out, float* __restrict__ partials, int nzl, int nyl,
    int nx, Coefs coefs, Thermal th, Stretch st, Shard sh) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  const Shard shl = sh;  // rk_rhs reads it through a pointer
  if (i < nx && j < nyl) {
    const int nyp = nyl + 2 * sh.hy, nzp = nzl + 2 * sh.hz;
    const int kp = k + sh.hz, jp = j + sh.hy;
    const long long sy = nx, sz = (long long)nyp * nx;
    const long long c = kp * sz + jp * sy + i;
    const long long o = ((long long)k * nyl + j) * nx + i;
    const int jg = sh.y_base + j, kg = sh.z_base + k;
    const bool face = (k3D && (kg < 1 || kg > sh.nz_g - 2)) ||
                      (kMode == kRows && (jg < 1 || jg > sh.ny_g - 2));
    const int is = wrap_src(i, nx);
    const int js = kMode == kRows ? jp : wrap_src(jp, nyp);
    const long long cs = face ? c : kp * sz + js * sy + is;
    const long long e = kFinal ? cs : c;
    Rhs r = {0.0f, 0.0f, 0.0f, 0.0f};
    if (!face && (kFinal || cs == c))
      r = rk_rhs<k3D, kThermal, kS, kMode>(f, e, sy, sz, kp, js, is, nzp,
                                           nyp, nx, coefs, th, st, &shl);
    const float factor = f.scal[0], acc_mix = f.scal[1];
    const bool acc = f.au != nullptr;
    const float au = acc ? f.au[e] : 0.0f, av = acc ? f.av[e] : 0.0f;
    const float aw = acc ? f.aw[e] : 0.0f, ap = acc ? f.ap[e] : 0.0f;
    const float un = clampv(f.q0u[e] + factor * (acc_mix * au + r.u), kVel);
    const float vn = clampv(f.q0v[e] + factor * (acc_mix * av + r.v), kVel);
    const float wn = clampv(f.q0w[e] + factor * (acc_mix * aw + r.w), kVel);
    const float pn = f.q0p[e] + factor * (acc_mix * ap + r.p);
    if (kFinal) {
      float ot = f.T[e];
      if (kThermal && kS != kParity && th.energy && !face) {
        int kT, jT, iT;
        if (!thermal_source<false, kMode != kRows>(th, kp, jp, i, nzp, nyp,
                                                   nx, kT, jT, iT, ot)) {
          const long long cT = kp * sz + jT * sy + iT;
          float ut = un, vt = vn, wt = wn;
          if (cT != cs) {  // the final velocities at the T source
            const Rhs rt = rk_rhs<k3D, kThermal, kS, kMode>(
                f, cT, sy, sz, kp, jT, iT, nzp, nyp, nx, coefs, th, st, &shl);
            const float aut = acc ? f.au[cT] : 0.0f;
            const float avt = acc ? f.av[cT] : 0.0f;
            const float awt = acc ? f.aw[cT] : 0.0f;
            ut = clampv(f.q0u[cT] + factor * (acc_mix * aut + rt.u), kVel);
            vt = clampv(f.q0v[cT] + factor * (acc_mix * avt + rt.v), kVel);
            wt = clampv(f.q0w[cT] + factor * (acc_mix * awt + rt.w), kVel);
          }
          ot = energy_update<k3D, kS>(f.T, cT, sy, sz, jT, iT, ut, vt, wt,
                                      f.scal[5], th.alpha, coefs.c2x,
                                      coefs.c2y, coefs.c2z, coefs.cx2,
                                      coefs.cy2, coefs.cz2, st);
        }
      }
      out.o[0][o] = un;
      out.o[1][o] = vn;
      out.o[2][o] = wn;
      out.o[3][o] = pn;
      out.o[4][o] = f.rho[e];
      out.o[5][o] = ot;
      if (!face) {
        m[0] = (un * un + vn * vn) + wn * wn;
        m[1] = pn;
        m[2] = fabsf(pn);
        m[3] = ot;
      }
    } else {
      const float weight = f.scal[2];
      out.o[0][c] = un;
      out.o[1][c] = vn;
      out.o[2][c] = wn;
      out.o[3][c] = pn;
      out.o[4][c] = au + weight * r.u;
      out.o[5][c] = av + weight * r.v;
      out.o[6][c] = aw + weight * r.w;
      out.o[7][c] = ap + weight * r.p;
    }
  }
  if (kFinal) block_max4(m, partials);
}

template <bool k3D, bool kThermal, int kS, int kMode>
int launch_rk_shard(const Fields& f, const Outs& o, float* partials,
                    float* out, int nzl, int nyl, int nx, const Coefs& coefs,
                    const Thermal& th, const Stretch& st, const Shard& sh,
                    int final_stage, cudaStream_t stream) {
  const dim3 grid = grid_of(nzl, nyl, nx), block(kTileX, kTileY);
  if (!final_stage) {
    rk_shard_kernel<k3D, false, kThermal, kS, kMode>
        <<<grid, block, 0, stream>>>(f, o, partials, nzl, nyl, nx, coefs,
                                     th, st, sh);
    return (int)cudaGetLastError();
  }
  rk_shard_kernel<k3D, true, kThermal, kS, kMode>
      <<<grid, block, 0, stream>>>(f, o, partials, nzl, nyl, nx, coefs, th,
                                   st, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_max4_kernel<<<1, kReduceThreads, 0, stream>>>(
      partials, blocks_of(nzl, nyl, nx), out);
  return (int)cudaGetLastError();
}

using RkShardLaunch = int (*)(const Fields&, const Outs&, float*, float*,
                              int, int, int, const Coefs&, const Thermal&,
                              const Stretch&, const Shard&, int,
                              cudaStream_t);

template <bool k3D, bool kThermal, int kMode>
RkShardLaunch pick_shard_spacing(int spacing) {
  if (spacing == kParity)
    return launch_rk_shard<k3D, kThermal, kParity, kMode>;
  if (spacing == kConsistent)
    return launch_rk_shard<k3D, kThermal, kConsistent, kMode>;
  return launch_rk_shard<k3D, kThermal, kUniform, kMode>;
}

template <bool k3D, int kMode>
RkShardLaunch pick_shard(bool thermal, int spacing) {
  return thermal ? pick_shard_spacing<k3D, true, kMode>(spacing)
                 : pick_shard_spacing<k3D, false, kMode>(spacing);
}

template <bool k3D, bool kThermal, int kS>
int launch_rk(const Fields& f, const Outs& o, float* partials, float* out,
              int nz, int ny, int nx, const Coefs& coefs, const Thermal& th,
              const Stretch& st, int final_stage, cudaStream_t stream) {
  const dim3 grid = grid_of(nz, ny, nx), block(kTileX, kTileY);
  if (!final_stage) {
    rk_kernel<k3D, false, kThermal, kS><<<grid, block, 0, stream>>>(
        f, o, partials, nz, ny, nx, coefs, th, st);
    return (int)cudaGetLastError();
  }
  rk_kernel<k3D, true, kThermal, kS><<<grid, block, 0, stream>>>(
      f, o, partials, nz, ny, nx, coefs, th, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_max4_kernel<<<1, kReduceThreads, 0, stream>>>(
      partials, blocks_of(nz, ny, nx), out);
  return (int)cudaGetLastError();
}

using RkLaunch = int (*)(const Fields&, const Outs&, float*, float*, int,
                         int, int, const Coefs&, const Thermal&,
                         const Stretch&, int, cudaStream_t);

template <bool k3D, bool kThermal>
RkLaunch pick_spacing(int spacing) {
  if (spacing == kParity) return launch_rk<k3D, kThermal, kParity>;
  if (spacing == kConsistent) return launch_rk<k3D, kThermal, kConsistent>;
  return launch_rk<k3D, kThermal, kUniform>;
}

}  // namespace

extern "C" {

// in[] = u, v, w, p, q0u, q0v, q0w, q0p, rho, T, acc u, v, w, p (the
// accumulator pointers all null for a zero accumulator), sin(pi y),
// sin(2 pi x), scal; outs[] as Outs.  partials and out (4 maxima) are read
// only by the final stage.  thermal_f and thermal_i are host arrays
// (explicit_common.cuh: thermal_from).  spacing is kUniform, kParity or
// kConsistent, xw and yw its weight rows (null when uniform).
int cfd_rk_stage(const float* const* in, float* const* outs,
                 float* partials, float* out, int nz, int ny, int nx,
                 float mu, float coef, float c2x, float c2y, float c2z,
                 float cx2, float cy2, float cz2, int final_stage,
                 const float* thermal_f, const int* thermal_i,
                 const float* xw, const float* yw, int spacing,
                 cudaStream_t stream) {
  const Fields f = {in[0],  in[1],  in[2],  in[3],  in[4],  in[5],
                    in[6],  in[7],  in[8],  in[9],  in[10], in[11],
                    in[12], in[13], in[14], in[15], in[16], nullptr};
  Outs o;
  for (int q = 0; q < 8; ++q) o.o[q] = outs[q];
  const Coefs coefs = {mu, coef, c2x, c2y, c2z, cx2, cy2, cz2};
  const Thermal th = thermal_from(thermal_f, thermal_i);
  if (spacing == kParity && th.energy)
    return (int)cudaErrorInvalidValue;  // parity has no stretched energy
  const Stretch st = {xw, yw, nx, ny};
  const bool thermal = th.energy || th.buoy;
  RkLaunch launch;
  if (nz > 1)
    launch = thermal ? pick_spacing<true, true>(spacing)
                     : pick_spacing<true, false>(spacing);
  else
    launch = thermal ? pick_spacing<false, true>(spacing)
                     : pick_spacing<false, false>(spacing);
  return launch(f, o, partials, out, nz > 1 ? nz : 1, ny, nx, coefs, th, st,
                final_stage, stream);
}

// One stage on a decomposed shard's block (rk_shard_kernel): in[] as
// cfd_rk_stage's with the pins (8 block planes, or null on a shard that
// holds neither global plane 1 nor nz_g - 2) at in[17]; every field the
// (nzl + 2 hz, nyl + 2 hy, nx) block (nzl = 1, hz = 0 on a 2D grid,
// nz_g = 1); a mid stage's outputs block-shaped, the final stage's
// (nzl, nyl, nx).  3D with hy = 0 is kZ, 3D with hy > 0 and 2D are kRows.
int cfd_rk_stage_shard(const float* const* in, float* const* outs,
                       float* partials, float* out, int nzl, int nyl,
                       int nx, float mu, float coef, float c2x, float c2y,
                       float c2z, float cx2, float cy2, float cz2,
                       int final_stage, const float* thermal_f,
                       const int* thermal_i, const float* xw,
                       const float* yw, int spacing, int hz, int hy,
                       int z_base, int nz_g, int y_base, int ny_g,
                       cudaStream_t stream) {
  const Fields f = {in[0],  in[1],  in[2],  in[3],  in[4],  in[5],
                    in[6],  in[7],  in[8],  in[9],  in[10], in[11],
                    in[12], in[13], in[14], in[15], in[16], in[17]};
  Outs o;
  for (int q = 0; q < 8; ++q) o.o[q] = outs[q];
  const Coefs coefs = {mu, coef, c2x, c2y, c2z, cx2, cy2, cz2};
  const Thermal th = thermal_from(thermal_f, thermal_i);
  if (spacing == kParity && th.energy) return (int)cudaErrorInvalidValue;
  const Shard sh = {hz, hy, z_base, nz_g, y_base, ny_g};
  const Stretch st = {xw, yw, nx, nyl + 2 * hy};
  const bool thermal = th.energy || th.buoy;
  RkShardLaunch launch;
  if (nz_g <= 1)
    launch = pick_shard<false, kRows>(thermal, spacing);
  else if (hy == 0)
    launch = pick_shard<true, kZ>(thermal, spacing);
  else
    launch = pick_shard<true, kRows>(thermal, spacing);
  return launch(f, o, partials, out, nz_g > 1 ? nzl : 1, nyl, nx, coefs, th,
                st, sh, final_stage, stream);
}

}  // extern "C"
