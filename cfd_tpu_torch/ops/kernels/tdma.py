"""Line Thomas solves of the spectral pressure paths (counterpart of
`cfd_tpu/ops/pallas/tdma.py`): z-lines in 3D, and y-lines in 2D on a
kernel of their own (at the end).

After the xy DST the pressure system splits into one tridiagonal per
(y, x) mode along z:

    (mu + 2w)·x_k − w·(x_{k−1} + x_{k+1}) = r_k,   k = 1..nz−2,
    x_0 = x_{nz−1} = 0,   w = 1/dz²,   mu = λx + λy > 0.

Plain versions (plain loops over z, any dtype, any device):
:func:`tdma_z_fwd_reference` (forward sweep → d′, t),
:func:`tdma_z_bwd_reference` (back substitution, the twin of the
reference's function of the same name), :func:`tdma_z_reference` (both,
the twin of the reference's full solve), and the analytic variant's
:func:`tdma_z_bwd_analytic_reference`.  The wrappers :func:`tdma_z_fwd`,
:func:`tdma_z_fwd_d` (no t), :func:`tdma_z_bwd` and
:func:`tdma_z_bwd_analytic` launch the CUDA kernels on a CUDA tensor and
the plain versions on a CPU tensor.  :func:`make_tdma_z` and
:func:`make_tdma_z_bwd` are the counterparts of the reference's builders
(`tdma.py:126`, `:265`); ``make_tdma_z(..., mu=None)`` takes μ at call
time (the sharded z-solve's y-pencils, each with its rows of μ).  Two
variants:

* ``"stored"``: the forward sweep writes t beside d′ and the back
  substitution reads it — plain Thomas, bit-equal to the plain loops;
* ``"analytic"``: the forward sweep writes d′ only, and the back
  substitution rebuilds t_k = sinh(kφ)/sinh((k+1)φ), cosh φ = 1 + mu/(2w),
  from the coefficient planes of :func:`_bwd_coeff_planes` (e^{−φ} and 2φ,
  float64 on the host, rounded once) as e^{−φ}·expm1(−2kφ)/expm1(−2(k+1)φ).
  The reference wrote (e^{−2kφ} − 1)/(e^{−2(k+1)φ} − 1), whose
  cancellation at small kφ cost it ~4e-6 relative (Mosaic lowers no
  expm1, `tdma.py:24-34`); ``expm1`` removes it, so the port is held to
  the reference at tolerance, not bit for bit.

The recurrence is the reference's, operation for operation and with the
same coefficients: rec = 1/((mu + 2w) − w·t), t = w·rec,
d′ = (r + w·d′)·rec from a zero carry at k = 1, then x = d′ + t·x from a
zero carry at k = nz−2 (`projection_kernels.py:686-698`, `tdma.py:526`).

Kernel note (`tdma_fwd_kernel`, `tdma_bwd_kernel<stored/analytic>`; they
replace the Thomas carries of `ProjectionKernels.pred_bt` and
`corr_bwd`, and `make_tdma_z` / `make_tdma_z_bwd` / `_build_bwd`,
`tdma.py:126`, `:265`, `:299`): sequential in z, independent per mode, a
handful of flops per 8–12 bytes — bound by memory bandwidth.  One thread
per (y, x) mode marches every plane, so each plane access is one
coalesced row of a warp; the carry lives in registers.  The analytic
form streams 2 fields each way instead of 3 (two expm1f a point: still
far under the card's arithmetic rate).
"""

from __future__ import annotations

import numpy as np
import torch

from . import native


def tdma_z_fwd_reference(r: torch.Tensor, mu: torch.Tensor, w: float):
    """Forward sweep of the (nz, ny, nx) zero-shell rhs ``r``:
    returns (d′, t), both with zero z-shell planes."""
    nz = r.shape[0]
    mu = mu.to(r.dtype)
    b = mu + 2.0 * w
    zero = torch.zeros_like(r[0])
    tc, dc = zero, zero
    ds, ts = [zero], [zero]
    for k in range(1, nz - 1):
        rec = 1.0 / (b - w * tc)
        tc = w * rec
        dc = (r[k] + w * dc) * rec
        ds.append(dc)
        ts.append(tc)
    # planes gathered and stacked, no write into a preallocated tensor:
    # autograd and forward-mode AD differentiate through the sweep
    return torch.stack(ds + [zero]), torch.stack(ts + [zero])


def tdma_z_bwd_reference(d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Back substitution of pre-swept (d′, t); returns x with mirror
    z-shells x[0] = x[1], x[nz−1] = x[nz−2]."""
    nz = d.shape[0]
    xs = [None] * nz
    xc = torch.zeros_like(d[0])
    for k in range(nz - 2, 0, -1):
        xc = d[k] + t[k] * xc
        xs[k] = xc
    xs[0], xs[nz - 1] = xs[1], xs[nz - 2]
    return torch.stack(xs)


def tdma_z_reference(r: torch.Tensor, mu: torch.Tensor, w: float):
    """Full Thomas solve: x with mirror z-shells."""
    return tdma_z_bwd_reference(*tdma_z_fwd_reference(r, mu, w))


def _check_fwd(r, mu):
    native.check_cuda(r, mu)
    if tuple(mu.shape) != tuple(r.shape[1:]):
        raise ValueError("tdma_z_fwd: mu must be an (ny, nx) plane")


def tdma_z_fwd(r: torch.Tensor, mu: torch.Tensor, w: float):
    """Forward sweep (d′, t) — ``tdma_fwd_kernel`` on CUDA."""
    if native.on_cpu(r):
        return tdma_z_fwd_reference(r, mu, w)
    nz, ny, nx = r.shape
    _check_fwd(r, mu)
    d = torch.empty_like(r)
    t = torch.empty_like(r)
    native.launch("cfd_tdma_fwd", r.device, native.ptr(r), native.ptr(mu),
                  float(w), native.ptr(d), native.ptr(t), nz, ny * nx, 1)
    tdma_z_fwd.launches += 1
    return d, t


def tdma_z_fwd_d_reference(r: torch.Tensor, mu: torch.Tensor, w: float):
    """Plain version of :func:`tdma_z_fwd_d`: the forward sweep's d′."""
    return tdma_z_fwd_reference(r, mu, w)[0]


def tdma_z_fwd_d(r: torch.Tensor, mu: torch.Tensor, w: float):
    """Forward sweep d′ alone (the analytic variant's, which rebuilds t) —
    ``tdma_fwd_kernel`` writing no t on CUDA."""
    if native.on_cpu(r):
        return tdma_z_fwd_d_reference(r, mu, w)
    nz, ny, nx = r.shape
    _check_fwd(r, mu)
    d = torch.empty_like(r)
    native.launch("cfd_tdma_fwd", r.device, native.ptr(r), native.ptr(mu),
                  float(w), native.ptr(d), None, nz, ny * nx, 0)
    tdma_z_fwd_d.launches += 1
    return d


def tdma_z_bwd(d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Back substitution x̂ with mirror z-shells — ``tdma_bwd_kernel`` on
    CUDA."""
    if native.on_cpu(d):
        return tdma_z_bwd_reference(d, t)
    nz, ny, nx = d.shape
    native.check_cuda(d, t)
    if t.shape != d.shape:
        raise ValueError("tdma_z_bwd: d and t must have one shape")
    x = torch.empty_like(d)
    native.launch("cfd_tdma_bwd", d.device, native.ptr(d), native.ptr(t),
                  native.ptr(x), nz, ny * nx)
    tdma_z_bwd.launches += 1
    return x


# ---- the analytic variant ---------------------------------------------------

def _bwd_coeff_planes(mu64, w64, np_dt=np.float32) -> np.ndarray:
    """The analytic variant's (2, my, mx) coefficient planes [e^{−φ}, 2φ]
    with cosh φ = 1 + mu/(2w), float64 on the host from the float64
    ``mu64`` and rounded once to ``np_dt`` (`tdma.py:115-123`; the
    reference stacks the same two planes as (2·my, mx) rows)."""
    mu64 = np.asarray(mu64, np.float64)
    s = mu64 / (2.0 * float(w64))
    sh = np.sqrt(s * (2.0 + s))                  # sinh φ
    einvphi = 1.0 / (1.0 + s + sh)               # e^{−φ}
    phi2 = 2.0 * np.log1p(s + sh)                # 2φ
    return np.stack([einvphi.astype(np_dt), phi2.astype(np_dt)])


def tdma_z_bwd_analytic_reference(d: torch.Tensor,
                                  coef: torch.Tensor) -> torch.Tensor:
    """Back substitution with t rebuilt from ``coef`` = [e^{−φ}, 2φ]:
    t_k = e^{−φ}·expm1(−k·2φ)/expm1(−(k+1)·2φ), x = d′ + t·x from
    k = nz−2 down to 1; mirror z-shells."""
    nz = d.shape[0]
    einv, p2 = coef[0].to(d.dtype), coef[1].to(d.dtype)
    xs = [None] * nz
    xc = torch.zeros_like(d[0])
    for k in range(nz - 2, 0, -1):
        kf = float(k)
        t = einv * torch.expm1(-kf * p2) / torch.expm1(-(kf + 1.0) * p2)
        xc = d[k] + t * xc
        xs[k] = xc
    xs[0], xs[nz - 1] = xs[1], xs[nz - 2]
    return torch.stack(xs)


def tdma_z_bwd_analytic(d: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Back substitution with analytic t — ``tdma_bwd_kernel<true>`` on
    CUDA; ``coef`` the (2, ny, nx) planes of :func:`_bwd_coeff_planes`."""
    if native.on_cpu(d):
        return tdma_z_bwd_analytic_reference(d, coef)
    nz, ny, nx = d.shape
    native.check_cuda(d, coef)
    if tuple(coef.shape) != (2, ny, nx):
        raise ValueError("tdma_z_bwd_analytic: coef must be (2, ny, nx)")
    x = torch.empty_like(d)
    native.launch("cfd_tdma_bwd_analytic", d.device, native.ptr(d),
                  native.ptr(coef), native.ptr(x), nz, ny * nx)
    tdma_z_bwd_analytic.launches += 1
    return x


# ---- the builders -------------------------------------------------------------

_VARIANTS = ("stored", "analytic")


def _build_planes(mu, w, variant, dtype, device):
    if variant not in _VARIANTS:
        raise ValueError(f"unknown tdma variant {variant!r}")
    mu64 = np.asarray(mu, np.float64)
    dtype = dtype or torch.float32
    mu_t = torch.as_tensor(mu64, dtype=dtype, device=device)
    coef = None
    if variant == "analytic":
        np_dt = np.float64 if dtype == torch.float64 else np.float32
        coef = torch.as_tensor(_bwd_coeff_planes(mu64, w, np_dt),
                               device=device)
    return mu_t, coef


def make_tdma_z(nz: int, my: int, mx: int, mu, w, dtype=None, device=None,
                variant: str = "stored"):
    """``run(r) → x`` for the z-line systems above on (nz, my, mx) arrays
    (`tdma.py:126-262`): r with zero z-shells in, x with mirror z-shells
    out.  ``mu`` is the (my, mx) float64 host plane (the coefficient
    planes derive from it here), ``w`` = 1/dz².  The wrappers launch the
    kernels on a CUDA tensor.  None when nz < 3 (no interior plane), as
    the reference's builder returns for a shape it does not take.

    ``mu=None`` takes μ at call time instead, ``run(r, mu)`` with ``mu`` an
    (my, mx) tensor on r's device (`tdma.py:126-137`): the sharded z-solve,
    where each shard's y-pencil sees its own rows of the eigenvalue plane.
    The kernels already read μ from device memory, so this is the stored
    pair with the caller's plane; stored variant only, as in the
    reference (the analytic variant's planes are built on the host)."""
    if nz < 3:
        return None
    if mu is None:
        if variant != "stored":
            raise ValueError("call-time mu is stored-variant only")

        def run_mu(r, mu_t):
            if tuple(mu_t.shape) != (my, mx) or tuple(r.shape) != (nz, my,
                                                                   mx):
                raise ValueError(f"make_tdma_z: expected r of shape "
                                 f"{(nz, my, mx)} and mu {(my, mx)}")
            return tdma_z_bwd(*tdma_z_fwd(r, mu_t, w))

        return run_mu
    mu_t, coef = _build_planes(mu, w, variant, dtype, device)
    if tuple(mu_t.shape) != (my, mx):
        raise ValueError("make_tdma_z: mu must be (my, mx)")

    def run(r):
        if variant == "stored":
            return tdma_z_bwd(*tdma_z_fwd(r, mu_t, w))
        return tdma_z_bwd_analytic(tdma_z_fwd_d(r, mu_t, w), coef)

    return run


def make_tdma_z_bwd(nz: int, my: int, mx: int, mu, w, dtype=None,
                    device=None, variant: str = "stored"):
    """The back-substitution twin of :func:`make_tdma_z`
    (`tdma.py:265-296`) on pre-swept planes in the fused-predictor layout
    (plane k at index k, zero z-shells): ``run(d, t)`` (stored) or
    ``run(d)`` (analytic) → x with mirror z-shells.  None when nz < 3."""
    if nz < 3:
        return None
    mu_t, coef = _build_planes(mu, w, variant, dtype, device)
    if tuple(mu_t.shape) != (my, mx):
        raise ValueError("make_tdma_z_bwd: mu must be (my, mx)")

    def run(d, t=None):
        if variant == "stored":
            return tdma_z_bwd(d, t)
        return tdma_z_bwd_analytic(d, coef)

    return run


# ---- y-lines of the 2D step --------------------------------------------------
#
# After the forward x-DST the 2D pressure system splits into one
# tridiagonal per x-mode m along y (`make_tdma_y_2d`, `tdma.py:434-523`):
#
#     (mu_m + 2w)·x_j − w·(x_{j−1} + x_{j+1}) = r_j,   j = 1..ny−2,
#     x_0 = x_{ny−1} = 0,   w = 1/dy²,   mu_m = λx_m > 0,
#
# the 3D recurrence with rows in place of planes.  On CUDA both sweeps run
# in one launch of ``tdma_y2d_kernel`` (`csrc/tdma_lines.cu`): a CTA owns
# a few neighbouring columns, each thread marches its column down and
# back up with the rows it reads copied ahead into a shared-memory ring,
# so a row's dependent chain is arithmetic alone.  rec and t come from
# the planes of :func:`tdma_y2d_planes`, built once with the step's
# pieces, so the forward row carries no divide.  :func:`tdma_y2d_plan`
# picks where d′ lives: in shared memory (16 columns a CTA) or, for a
# column too tall for it, parked in x (32 columns a CTA) — two
# instantiations of the same kernel — and the copy width: 16 bytes where
# nx is a multiple of 4, else 4.

# the kernel's ring and CTA widths (`tdma_lines.cu`: kStageRows, kStages,
# kSmemCols, kGlobalCols, kMaxSmem)
Y2D_STAGE_ROWS = 32
Y2D_STAGES = 8
Y2D_COLS = {"smem": 16, "global": 32}
Y2D_MAX_SMEM = 232448


def tdma_y2d_plan(ny: int, nx: int) -> dict:
    """The launch of ``tdma_y2d_kernel`` on an (ny, nx) rhs: ``variant``
    "smem" (d′ in shared memory) where ny − 2 rows of 16 columns and the
    two rings fit a CTA's 227 KB, else "global" (d′ parked in x);
    ``cols`` columns a CTA, ``ctas`` CTAs (CTA i owns columns i·cols …
    i·cols + cols − 1 below nx), ``smem_bytes`` its dynamic shared
    memory, ``copy`` the bytes a copy moves (16 where nx is a multiple of
    4 and the arrays are 16-byte aligned, which the wrapper checks, else
    4)."""
    if ny < 3 or nx < 1:
        raise ValueError(f"tdma_y2d_plan: needs ny >= 3 and nx >= 1, got "
                         f"{(ny, nx)}")
    rings = 2 * Y2D_STAGE_ROWS * Y2D_STAGES   # rows: r or t, rec or d′
    variant = "smem" if (rings + ny - 2) * Y2D_COLS["smem"] * 4 \
        <= Y2D_MAX_SMEM else "global"
    cols = Y2D_COLS[variant]
    rows = rings + (ny - 2 if variant == "smem" else 0)
    return {"variant": variant, "cols": cols, "ctas": -(-nx // cols),
            "smem_bytes": rows * cols * 4,
            "copy": 16 if nx % 4 == 0 else 4}


def tdma_y_2d_reference(r: torch.Tensor, mu: torch.Tensor, w: float):
    """Both sweeps of the (ny, mx) zero-shell rhs ``r`` with ``mu`` (mx,):
    x with mirror y-shells; plain loops over rows, any dtype."""
    return tdma_z_reference(r[:, None, :], mu[None, :], w)[:, 0, :]


def tdma_y2d_planes(mu: torch.Tensor, w: float, ny: int):
    """The data-free half of the forward sweep: (rec, t), two (ny, nx)
    planes with zero shell rows, rec = 1/((mu + 2w) − w·t), t = w·rec for
    j = 1..ny−2 from a zero t — the recurrence of
    :func:`tdma_z_fwd_reference`, operation for operation, on mu's device
    and dtype."""
    b = mu + 2.0 * w
    zero = torch.zeros_like(mu)
    tc, recs, ts = zero, [zero], [zero]
    for _ in range(1, ny - 1):
        rec = 1.0 / (b - w * tc)
        tc = w * rec
        recs.append(rec)
        ts.append(tc)
    return torch.stack(recs + [zero]), torch.stack(ts + [zero])


def tdma_y_2d_planes_reference(r: torch.Tensor, rec: torch.Tensor,
                               t: torch.Tensor, w: float) -> torch.Tensor:
    """Both sweeps with rec and t read from their planes: d′ = (r + w·d′)·rec
    going down, x = d′ + t·x going up; mirror y-shells."""
    ny = r.shape[0]
    dc = torch.zeros_like(r[0])
    ds = [dc]
    for j in range(1, ny - 1):
        dc = (r[j] + w * dc) * rec[j]
        ds.append(dc)
    return tdma_z_bwd_reference(torch.stack(ds + [dc])[:, None, :],
                                t[:, None, :])[:, 0, :]


def tdma_y_2d(r: torch.Tensor, mu: torch.Tensor, w: float,
              planes=None) -> torch.Tensor:
    """The y-line solve: x with mirror y-shells — one launch of
    ``tdma_y2d_kernel`` on CUDA (counted on ``launches``, and those
    through the 4-byte copies also on ``copy4_launches``), the plain
    version on a CPU tensor.  ``planes`` = (rec, t) from
    :func:`tdma_y2d_planes`, which the kernel reads in place of the
    forward sweep's divide: required on CUDA, optional on the CPU."""
    if tuple(mu.shape) != (r.shape[-1],) or r.dim() != 2 or r.shape[0] < 3:
        raise ValueError("tdma_y_2d: r must be (ny >= 3, nx) and mu (nx,)")
    if planes is not None and any(tuple(p.shape) != tuple(r.shape)
                                  for p in planes):
        raise ValueError("tdma_y_2d: the planes must be r's shape")
    if native.on_cpu(r):
        if planes is not None:
            return tdma_y_2d_planes_reference(r, *planes, w)
        return tdma_y_2d_reference(r, mu, w)
    native.check_cuda(r, mu, *(planes or ()))
    if planes is None:
        raise ValueError("tdma_y_2d: the kernel needs the rec and t planes "
                         "of tdma_y2d_planes")
    ny, nx = r.shape
    plan = tdma_y2d_plan(ny, nx)
    x = torch.empty_like(r)
    vec = plan["copy"] == 16 and all(native.ptr(a) % 16 == 0
                                     for a in (r, x, *planes))
    native.launch("cfd_tdma_y2d", r.device, native.ptr(r), float(w),
                  *map(native.ptr, planes), native.ptr(x), ny, nx,
                  int(plan["variant"] == "smem"), int(vec))
    tdma_y_2d.launches += 1
    if not vec:
        tdma_y_2d.copy4_launches += 1
    return x


def tdma_y2d_chain(mu: float, w: float, device, rows: int = 1 << 16):
    """The kernel's dependent chain a row, measured on the card: one
    thread runs ``rows`` rows of each recurrence on registers.  Returns
    the SM cycles a row of the kernel's forward sweep (rec from its plane:
    d′ alone), of the back substitution (x = d′ + t·x) and of a forward
    sweep computing rec (rec → t → d′, what the planes take off the
    chain), and the SM clock (MHz) of that last run (its cycles over its
    %globaltimer nanoseconds)."""
    mu_t = torch.tensor([mu, 1.0], dtype=torch.float32, device=device)
    out = torch.zeros(4, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=torch.float32, device=device)
    native.launch("cfd_tdma_y2d_chain", mu_t.device, native.ptr(mu_t),
                  float(w), int(rows), native.ptr(out), native.ptr(sink))
    fwd, bwd, ns, fwd_planes = (int(v) for v in out.cpu())
    return {"fwd_cycles": fwd / rows, "bwd_cycles": bwd / rows,
            "fwd_planes_cycles": fwd_planes / rows,
            "clock_mhz": fwd / ns * 1e3 if ns > 0 else float("nan")}


tdma_z_fwd.launches = 0
tdma_z_fwd_d.launches = 0
tdma_z_bwd.launches = 0
tdma_z_bwd_analytic.launches = 0
tdma_y_2d.launches = tdma_y_2d.copy4_launches = 0
