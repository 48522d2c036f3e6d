#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels of ``cfd_tpu_torch`` from the
sources in the checkout and holds every kernel against its plain PyTorch
version on the card: the 3D kernels at the entry grid 128×64×16 and at
512³, the 2D kernels at 128×32 and 2048² (the y-line Thomas kernel,
``tdma_y2d_kernel``, also at 1024×512, 37×23 and 256×4096, bit for bit
in the variant its plan picks there: d′ in shared memory, parked in x at
256×4096; beside its dependent-chain probe and the SM clock that
``nvidia-smi`` reads while it runs), and the 2D
y-solve's rescue
GEMM (``rolling.rescue_dot``) also at the Ghia cavity's 128² (both
products, two launches bit-identical, the fused divide bit-equal to the
divide after the product, device-timed beside ``torch.matmul`` and the
earlier ``left_dot`` + divide path; so again at HIGH in phase 27 and at
DEFAULT in phase 38).  Then it drives both main paths on the kernel
path and the plain path:

* 3D: ``cfd_tpu_torch.entry.entry(device="cuda")`` for 3 steps, and the
  512³ Taylor-Green projection step (``bench.py:run_3d``'s configuration)
  for 5 warm-up and 5 timed steps;
* 2D: the 2048² Taylor-Green projection step (``bench.py:run_2d(2048)``'s
  configuration) for 20 warm-up and 20 timed steps (the plain path,
  held against the kernel path after one step, for ``PLAIN_TIMED_STEPS``
  of each, as in every phase that holds the paths after one step), its
  y-line Thomas solve one ``tdma_y2d_kernel`` launch a step;

and the lid-driven cavity at Re = 100 on 128² for 20000 steps on the
kernel path, graded against Ghia's table (``bench.py:905-907``: RMS of u
and v on the centerlines below 0.10).  Then the explicit integrators:

* phase 9: the fused Euler kernel (3D and 2D) and the RK stage kernel
  (3D and 2D; first, mid and final stage) against their plain versions
  at 37×23×11 / 37×23 and at 256³ / 2048², with the clamps and the ρ
  guard engaged;
* phase 10: ``bench.py``'s explicit configurations on the kernel path
  and the plain path — Euler at 256³ (10 steps) and 2048² (20 steps),
  RK2 and RK4 at 256³ and 2048² (10 steps each), each run once to warm
  up and once timed with CUDA events;
* phase 11: ``Simulation.create(100, 50)`` with the default solver for
  2000 ``step()``s on the card, against the same steps on the plain path.

Then the CG pressure solve, the reference's default projection solver:

* phase 12: the fused CG passes (``lap_dot``, ``cg_update``), A1's rhs
  form and the non-DST corrector against their plain versions at
  37×23×11 and 512³, the 2D rhs form at 37×23 and 100×50, and the
  whole-solve CG in the form its plan names: the cluster kernel
  (``cg_solve[cluster]``) bit for bit against its order model, twice, at
  37×23, 100×50, 100², 128² and 512², beside the grid-wide kernel's time
  and the barrier probe's latencies, then against ``make_cg`` at 100×100
  (plain and Jacobi) and 512², the grid-wide kernel (``cg_solve``) at
  33×17×9 and 700²;
* phase 13: ``bench.py``'s ``cg_512`` solve (512³, tol 1e-6,
  ``check_interval`` 10) on the kernel path, timed, with its iteration
  count, host syncs and float64 true residual, and 20 fixed iterations
  against the plain path;
* phase 14: the 3D CG projection step at 256³ (``bench.py:run_3d``'s
  parameters), 3 warm-up and 3 timed steps on both paths;
* phase 15: ``Simulation.create(100, 50, solver_type="projection")`` for
  2000 ``step()``s, the cluster CG kernel once a step, the first 10
  held against the plain path (the facade's dt = 0.005 is past the
  viscous limit there, so the clamps are reached near step 40);
* phase 16: Ghia Re = 100 at 128² with the CG pressure solve
  (``GHIA_SOLVER_STEPS``, 10000 steps, t = 5; about 14 s on an H100),
  the cluster kernel once a step, then 2 steps of a 700² cavity through
  the grid-wide kernel.

Then the multigrid pressure solve:

* phase 17: the red-black sweep (``rb_sweep``: red-first, red-first with
  the residual field, black-first) against its plain version at
  17×33×9 and 513³, and the whole-solve 2D multigrid (``mg_solve``)
  against its plain version at 33² and 129²;
* phase 18: ``bench.py``'s ``multigrid_513`` solve (513³, tol 1e-6,
  ``check_interval`` 10) on both paths, timed, with its V-cycles, host
  syncs, float64 true residual and each level's sweep time against its
  bound;
* phase 19: MG-preconditioned CG at 513³ through the Poisson front end,
  on both paths;
* phase 20: the 3D multigrid projection step at 257³ (``run_3d``'s
  physics), 3 warm-up and 3 timed steps on both paths, at a relative
  tolerance of 1e-3: first the float32 residual floor of its first
  solve, which lies above the default 1e-6; then the CG step on the
  same grid at the same tolerance, timed on the kernel path;
* phase 21: ``bench.py:run_mg2d_vmem(129)``'s solve, Ghia Re = 100 at
  129² with the multigrid solve (``GHIA_SOLVER_STEPS``), and 100 steps of
  ``Simulation.create(65, 65, solver_type="projection_multigrid")``
  with its solver at a tolerance above the printed float32 floor, held
  against the plain path at step 10.

Then BiCGSTAB, Red-Black SOR and Jacobi:

* phase 22: the three BiCGSTAB passes (``pass_pv``, ``pass_st``,
  ``pass_xr``) and the RB-SOR sweep (``rbsor_sweep``) against their plain
  versions at 37×23×11 and 512³ (fields bit-equal; a NaN in x gives a NaN
  residual), and the whole solves (``bicgstab_solve``, ``rbsor_solve``,
  ``jacobi_solve``) at 100², 64×96 and 33×17×9 (BiCGSTAB also at 700²,
  the grid-wide form), and the cluster BiCGSTAB kernel bit for bit
  against its order model at the planes of phase 12;
* phase 23: ``bench.py:run_poisson_iters(100)`` through the Poisson front
  end — RB-SOR 2000, CG 400 and BiCGSTAB 150 iterations a solve, the rate
  Δiterations/Δtime between 5 and 105 solves;
* phase 24: BiCGSTAB on ``cg_512``'s 512³ problem through the front end's
  fused passes (tolerance 1e-6, else the first decade up that converges:
  float32 BiCGSTAB may not reach 1e-6 there), and 200 RB-SOR sweeps;
* phase 25: the BiCGSTAB step at 128³ beside the CG step there, the RB-SOR
  step at 128³ (its float32 floor printed first) and the Jacobi step at
  33³, on both paths;
* phase 26: Ghia Re = 100 at 128² with the BiCGSTAB solve (the cluster
  kernel once a step; 2 steps of a 700² cavity, the grid-wide one), the
  128² cavity
  for 50 steps with RB-SOR and with Jacobi above their printed floors,
  and ``poisson_solve``'s default preset at 100², on both paths;
* phase 27: ``spectral_precision="high"``'s kernels against their plain
  versions: the 3xTF32 GEMM (``plane_dot`` at "high") at 37×23×11 and
  512³, timed against its TF32 tensor-core bound and cuBLAS fp32, the
  no-t forward sweep and the analytic back substitution at 512³, the
  2D step's 3xTF32 x-DST at 2048² and its rescue GEMM at 2048² and 128²;
  the 3xTF32 GEMM and the SGEMM against a float64 product at depths 512
  and 2048;
* phase 28: the 512³ step at HIGH (5 warm-up and 5 timed steps) and the
  2048² step at HIGH (20 and 20), each on both paths and held against
  its HIGHEST step after the first step at the reference's HIGH bars
  (the launch counters show 3xTF32 launches and no SGEMM); the nz = 3
  step at 512×512×3 on both paths at HIGHEST and at HIGH, and its
  kernels against their plain versions there;
* phase 29: Ghia Re = 100 at 128² at HIGH for ``GHIA_SOLVER_STEPS``
  (RMS below 0.10, beside phase 7's HIGHEST values);
* phase 30: FFT_DIRECT through the Poisson front end on ``cg_512``'s
  512³ problem (ms a solve, float64 true residual below 1e-3), held
  against the plain solve on the card and beside the float64 one, and
  the eigen z-product against its plain version; and SOR
  (``poisson_solve``'s ``SOR_SCALAR`` preset) and Gauss-Seidel (the front
  end) at 33² in float64 (plain torch on the card: sweeps and ms),
  against the same SOR solve on the CPU.

Then the boundary conditions, ``bc_refresh``, buoyancy and the energy
equation:

* phase 31: the buoyant predictor (``predictor_star`` with T, 3D and 2D)
  at 37×23×11, 512³, 37×23 and 2048², and the Euler kernel and the RK
  stage with the energy update, buoyancy and two mixes of Dirichlet,
  Neumann and periodic thermal faces at 37×23×11, 256³, 37×23 and 2048²,
  against their plain versions (bit-equal);
* phase 32: ``bench.py:run_bc_refresh``'s configurations (the driven-lid
  hook) — the 512³ step at HIGHEST and HIGH and the 2048² step, on both
  paths, held after one step (both are past the explicit viscous limit;
  the 2048² status is reported), with the launch counts showing the
  predictor and b̃ once a step around the hook; the 256³ CG step with the
  hook; and ``examples/pulsatile_inlet_flow.py``'s channel at 1024×512
  (sinusoidal inlet, no-slip walls, zero-gradient outlet, the same BCs as
  the hook), ``PULSE_STEPS`` steps on both paths, status 0 on every
  step;
* phase 33: the 512³ spectral step with buoyancy and the energy equation
  (T linear in z, Dirichlet back and front, Neumann sides) on both paths,
  with the energy post-step's ms and its share of the step; the Euler,
  RK2 and RK4 steps at 256³ and the Euler and RK2 steps at 2048² with
  energy, buoyancy and thermal faces on both paths;
* phase 34: ``bench.py:dvd_gate``, de Vahl Davis Ra = 1e4 at 128² through
  the buoyant 2D step, marched in chunks of 4000 steps to the
  kinetic-energy steady state (at most 80000), u_max*, v_max* and Nu_avg
  within 4% of 16.178, 19.617 and 2.238, status 0 on every step;
* phase 35: the stretched-grid kernels against their plain versions,
  bit for bit: the consistent scheme's predictor (± T), b̃, rhs and
  corrector and the eigenbasis-fused chain at 128×64×16 and 512³
  (tanh β = 1.5 in x and y), its GEMMs (SGEMM and 3xTF32, 2e-5·max);
  the parity and consistent Euler and RK kernels (thermal included) at
  37×23×11, 256³, 37×23 and 2048²; the 2D consistent kernels at 128×32
  and 2048²;
* phase 36: ``bench.py:run_3d_consistent(512)`` at HIGHEST and HIGH (5
  warm-up and 5 timed steps on both paths, ms/step and MLUPS), the
  float64 true residual of the system one step solved (within twice the
  uniform step's float32 floor on this smooth rhs) and of the consistent
  direct solve on ``cg_512``'s rough rhs (bar 1e-3), the consistent CG
  and BiCGSTAB steps at 128³ (3 steps, iterations, host syncs) and the
  2D consistent step at 2048²;
* phase 37: ``bench.py:run_euler_3d(stretched=True)`` in the parity and
  consistent schemes at 256³, RK2 / RK4 there, the stretched Euler and
  RK2 steps at 2048², the stretched Poiseuille gate on the card
  (`tests/validation/test_poiseuille.py:110-165`: 40×32, 500 steps, β =
  0 / 1.5 / 2.0 below 0.05 / 0.20 / 0.30, uniform below stretched) and
  ``Simulation.from_grid`` on a stretched grid with the consistent
  scheme.

Then ``spectral_precision="default"`` and the differentiable steps:

* phase 38: the one-pass TF32 GEMM (``csrc/gemm_tf32.cu``) against its
  plain version at the 512³ plane shapes, the 2048² x-DST and every
  DEFAULT depth in use (K = 2048, 2046, 512, 510, 128, 126;
  ``TOL_GEMM``), on a 37×23×11 field's x- and batched y-products (their
  cp.async loads, counted) and on the 512×512×3 planes' (by TMA), two
  launches bit-identical, D(K), the cluster
  size and the CTAs of each launch printed, timed against its bound and
  ``torch.matmul`` with TF32 on, and its error against float64 beside the
  3xTF32 GEMM's and the SGEMM's; its rescue products at 2048² and 128²;
  the sum-order contract bit for bit: the rescue's s equals
  ``left_dot(Fy, a)[:, :K] / λ`` and its Gy·s the same columns of the
  full product, a 512-row slice's x-DST the same rows of the 2048-row
  one, a 130-plane block's ``plane_dot`` the same planes of the 512-plane
  one; the 512³ and 2048² DEFAULT steps (the emit-b̃ route) on both
  paths, held after one step, with launch counts that show the route (4
  TF32 launches a 3D step, 2 x-DST and 2 rescue launches a 2D step, no
  SGEMM, no 3xTF32, none through the cp.async loads), and one step of
  each against HIGHEST;
* phase 39: ``bench.py:run_hybrid_adjoint(128, 10)`` — a 128³ Euler
  rollout with ``remat="step"`` through the hybrid (kernel forward,
  autograd adjoint) and the plain differentiable step: forward and
  value+grad ms, the hybrid's value bit-equal to the kernel rollout, and
  max|grad_hybrid − grad_plain|;
* phase 40: ``bench.py:run_adjoint(1024, 50)`` — the 2D Euler rollout's
  forward ms, grad ms and ratio on the hybrid and the plain path;
* phase 41: the hybrid projection — FFT_DIRECT at 256³ (5 steps,
  ``remat="step"``; gradient at rtol 1e-5 / atol 5e-7 of the plain
  step's) and CG at 128³ (3 steps; relative L2 1e-3), each value
  bit-equal to the non-differentiable kernel step's rollout.

Then the z-decomposed step (``cfd_tpu_torch.parallel``), its 4 z-shards
emulated on the one card (``LocalComm``; one card cannot measure
scaling):

* phase 42: the ``global_nz`` predictor and b̃ kernels on the first, a
  middle and the last shard's halo-padded block at 37×23×16 and on the
  512³/4 slab (132×512×512, 130×512×512), the call-time-μ Thomas pair on
  a (512, 128, 512) y-pencil with its rows of μ (all bit-equal to their
  plain versions), the SGEMM / 3xTF32 inverse DST and the corrector on a
  1-halo x̂ block;
* phase 43: ``make_sharded_step`` on ``run_3d``'s 512³ configuration at
  HIGHEST and HIGH, 3 warm-up and 5 timed steps, against the single-device
  kernel step (HIGHEST at the reference's sharded bar, 2e-6 / 2e-5,
  0.0 expected; HIGH after one step at its HIGH bars), ms/step and MLUPS
  of both, and the emulated all_to_alls' and halo pads' ms;
* phase 44: float64 projection (FFT_DIRECT, CG), Euler and RK2 steps on
  the card at 33×17×9 against the CPU plain step, 1e-12, no kernel
  launched;
* phase 45: ``ProcessGroupComm`` on a one-rank NCCL group against
  ``LocalComm`` with one shard, the spectral and the CG step, bit for bit
  (it shows the process-group path runs on CUDA, and measures nothing).

And the z-decomposed CG and BiCGSTAB steps, on the same 4 emulated
shards:

* phase 46: the sharded Krylov kernels against their plain versions on
  the first, a middle and the last shard at 37×23×16 and on the 512³/4
  slab — K1 (``make_lap_dot_sharded``) and the BiCGSTAB pv / st passes
  on the 130-plane halo-padded block, K2 and xr on the owned block, the
  ``global_nz`` rhs, the corrector on a 1-halo block of a physical p:
  fields bit-equal, the shards' shares of the dots at ``TOL_DOT``;
* phase 47: ``bench.py``'s ``cg_512`` through ``make_cg_fused_sharded``
  (1221 ± 10% iterations, float64 true residual below 1e-3, host syncs
  at most one a chunk), ms an iteration beside phase 13's, and one CG
  iteration's halo exchange by plane copies against concatenation;
* phase 48: the 512³ CG step (``run_3d``'s physics, tolerance 1e-3) over
  4 shards against the single-device kernel step, 3 warm-up and 3 timed
  steps each, at ``TOL_CG_UVW`` and ``close_p``, iterations a step of
  both;
* phase 49: phase 25's BiCGSTAB step (128³, its tolerance) over 4 shards
  against the single-device kernel step, the same way.

On phases 47–49 every kernel wrapper of the path must count launches,
and each plain version of the path is replaced by a tripwire while it
runs: none may run.

And the (z, y)-decomposed step (``make_mesh`` of 4 shards, the (2, 2)
mesh every 4-card machine gets, and (1, 4); emulated on the card):

* phase 50: the global-row modes — the predictor (2 planes and 2 rows a
  side), b̃ and the CG rhs on its owned window, the corrector on the owned
  window of a 1-padded p block, K1 / K2 on 1-padded blocks — against
  their plain twins on blocks at the first, a middle and the last shard
  position of each axis at 37×23×16 and on the four (2, 2) blocks of
  512³ (fields bit-equal, the dots' shares at ``TOL_DOT``), then the
  x-DST and z-stage GEMMs (SGEMM and 3xTF32) at a (2, 2) shard's shapes;
* phase 51: the (2, 2) y/z solve with its x DSTs against the one-device
  eigen solve (2e-5·max), beside the Thomas one, each stage timed (the
  four emulated ``all_to_all``s, the z, y and x products);
* phase 52: the 512³ FFT_DIRECT step over (2, 2) and (1, 4) at HIGHEST
  and HIGH — the first step held against the float64 step on the card
  at fixed bars (at HIGHEST; its difference from the single-device
  step, whose Thomas z solve rounds otherwise, printed) and the
  single-device HIGH step; 3 warm-up and 5 timed steps beside the
  single-device step's, the two held against each other after them
  (with ``--profile`` 3 profiled steps);
* phase 53: ``cg_512`` over (2, 2) (the single-device count of phase 13,
  true residual below 1e-3) and the 512³ CG step over (2, 2) against the
  single-device step (iterations a step within 2, ``TOL_CG_UVW``,
  ``close_p``).

On phases 52 and 53 the plain twins of the path are tripwires too.

And the decomposed explicit steps (``make_sharded_step(...,
"explicit_euler" | "rk2" | "rk4")``, emulated shards on the card):

* phase 54: the Euler and RK kernels' sharded modes — E3's and E2's
  global-row mode, RK3's ``global_nz`` (z pins) and ``global_nz`` +
  ``global_ny`` modes, RK2's ``global_ny`` mode, Euler and RK's first,
  mid and final stages — against their plain twins on the first, a
  middle and the last of 3 blocks at 37×23×15 and 37×23, on every block
  of 4 z-shards and of (2, 2) at 256³ and of 4 y-shards at 2048²
  (owned windows bit-equal; one block of each mode timed by its device
  time);
* phase 55: ``bench.py``'s 256³ Euler, RK2 and RK4 over 4 z-shards,
  (2, 2) and (1, 4) against the single-device kernel step (the first
  step and 12 in all held at ``TOL_SHARDED_EXPLICIT``, expected 0; the
  maxima held too), 3 warm-up and 5 timed steps of each beside the
  single-device step's, the plain twins tripwires (with ``--profile``
  the (2, 2) steps profiled and their halo and pad copies' share);
* phase 56: the 2048² Euler and RK2 over 4 y-shards the same way, then
  the buoyant + energy (two face mixes) and tanh-stretched (parity,
  consistent + energy) Euler / RK2 / RK4 at 48×40×24 over 4z and (2, 2)
  and 96×64 over 4y, 3 steps, against the single-device steps;
* phase 57: ``Simulation.create(..., mesh=)`` (Euler on 128×64 over 4y
  and 64×48×24 over 4z, RK4 over (2, 2), the spectral projection over
  4z) against the single-device facade after 10 ``step()``s and a
  ``solve()``, a solver swap keeping the mesh; then the Euler step on a
  one-rank NCCL ``ProcessGroupComm`` against ``LocalComm``, bit for bit.

And the (z, y) BiCGSTAB step and the y-decomposed 2D projection step
(emulated shards on the card):

* phase 58: B1r — the BiCGSTAB passes' (z, y) modes on blocks padded one
  plane and one row a side — on every block of a (4, 3) cover of
  37×23×16 and of the (2, 2) mesh at 512³; P2r — the 2D predictor, b̃
  and corrector in their global-row modes — on every one of 4 y-shards'
  rows at 37×24 and 2048² (fields bit-equal, the dots' shares at
  ``TOL_DOT``; one block of each timed by its device time); then the 2D
  step's x-DST and slab y-solve GEMMs at a 2048² 4y shard's shapes;
* phase 59: ``bench.py:run_2d(2048)``'s step over 4 y-shards at HIGHEST
  and HIGH — the first HIGHEST step held against the float64 step on the
  card at ``TOL_2D_F64_*`` (its difference from the single-device step,
  whose Thomas y solve rounds otherwise, printed), HIGH against the
  single-device HIGH step; 3 warm-up and 20 timed steps beside the
  single-device step's (with ``--profile`` 3 profiled steps);
* phase 60: phase 49's BiCGSTAB step (128³) over (2, 2) and (1, 4)
  against the single-device kernel step, the same way;
* phase 61: ``Simulation.create(..., "projection_spectral", mesh=)`` on
  a 256×128 grid over 4 y-shards, one step against the single-device
  facade;
* phase 62: the red-black sweep's sharded modes (``rb_sweep(...,
  z_off, gnz[, y_off, gny])``) on every block of the 513³ field over 4
  z-shards and over (2, 2) (4 halo planes and rows a side), red-first
  with the residual, black-first and red-first: bit for bit against the
  plain twin, and the owned planes and rows against phase 17's
  single-device sweep of the whole field; one block of each mode timed;
* phase 63: ``bench.py``'s ``multigrid_513`` through
  ``make_multigrid_sharded`` over 4z and (2, 2): status 0, the
  single-device solve's V-cycle count and x bit for bit, the true
  residual below 1e-3; ms a solve, the coarse levels' share (run on
  every shard), host syncs and launches;
* phase 64: phase 20's 257³ multigrid step through ``make_sharded_step
  (..., MULTIGRID)`` over 4z and (2, 2) against the single-device kernel
  step at phase 20's bars (ms a step), and ``Simulation.create(65, 65,
  65, "projection_multigrid", mesh=)`` 3 steps against the single-device
  facade.

Then the energy equation and buoyancy on the decomposed projection
steps:

* phase 65: the buoyant predictor's sharded modes (``predictor_star``
  with T in its ``global_nz`` and global-row modes,
  ``predictor_star_2d`` with T in its global-row mode) on every block of
  the 512³ field over 4z and (2, 2) and of the 2048² field over 4y, bit
  for bit against the plain twin, and the owned window against the
  single-device buoyant predictor on the whole field; one block of each
  mode timed;
* phase 66: phase 33's 512³ buoyant + energy step over 4z (bit-equal to
  the single-device step) and (2, 2) (against float64 at phase 52's
  bars, T at the reference's), 3 warm-up and 5 timed steps, the energy
  post-step on the shards alone; the "mixed" thermal faces (periodic
  back and front) at 128³ over 4z and (2, 2); the 128³ CG and BiCGSTAB
  steps with energy and buoyancy over 4z at phase 48 / 49's bars;
* phase 67: phase 34's de Vahl Davis configuration over 4y for one
  1000-step chunk beside the single-device step: the first step against
  float64, Nu_avg after the chunk within 0.5%.

Then the consistent scheme on the z-decomposed spectral step and
``spectral_precision="default"`` on every decomposed step:

* phase 68: ``predictor_star`` (with and without T) and
  ``poisson_input`` in their consistent ``global_nz`` mode and the
  consistent corrector on the step's 1-halo block, on the first, a
  middle and the last block of 4 z-shards of a 37×23×16 stretched grid
  and on every block of the 512³ tanh β = 1.5 grid, bit for bit against
  the plain twin and, on the owned window, against phase 35's
  single-device consistent kernel; a middle block of each timed;
* phase 69: ``run_3d_consistent(512)``'s step over 4z, HIGHEST bit-equal
  to the single-device consistent step after 1 and 6 steps, HIGH at the
  HIGH bars, 3 warm-up and 5 timed steps of each beside the
  single-device step; a buoyant + energy consistent step at 64×48×32
  over 4z, 3 steps bit-equal to one device; ``Simulation.from_grid`` on
  a 4z mesh with a consistent grid, one step against the single-device
  facade;
* phase 70: the one-pass TF32 GEMM on a shard's x̂ block (and, in
  phases 50 and 58, on the (2, 2) and 4y shards' x-DST, z-stage and
  y-slab shapes; two launches bit-identical at each), then ``spectral_precision="default"`` on the 512³ step
  over 4z (uniform, bit-equal to the single-device DEFAULT step, and
  consistent) and (2, 2), at ``TOL_TF32_STEP``, and on the 2048² step
  over 4y at ``TOL_TF32_4Y``, ms a step beside HIGHEST, every stencil
  and GEMM of each path counted.

Then the IEEE fp32 SGEMM (``csrc/sgemm_fp32.cu``, every HIGHEST product):

* phase 71: the SGEMM against its plain version at every launch shape of
  the HIGHEST main paths (the 4y shard's x-DST and y slab, the 2048²
  x-DST, the (2, 2) shard's x-DST and z stage, the eigen z-product, the
  two ``plane_dot`` launches of a 130-plane block and of the 512³
  planes) and at the small ones (37×23×11, 128×32, 128², K = 2046 and
  510 through factors stored padded and packed): ``TOL_GEMM``, two
  launches bit-identical, one launch a call, its plan (tile, CTAs,
  tiles, TMA or the 4-byte copies), device ms beside its bound and one
  ``torch.matmul`` (TF32 off) of the same product; the sum-order
  contract bit for bit (a 512-row slice's x-DST, a 130-plane block's
  ``plane_dot``, ``left_dot`` into column slices at and off 16 bytes,
  TMA against the 4-byte copies at K = 2046 and 510).  Phases 4, 6,
  36, 43, 52 and 59 fail where a HIGHEST step's SGEMM launch took the
  4-byte copies (``highest_cp_async_launches``).

Then the 3xTF32 GEMM (``csrc/gemm_3xtf32.cu``, every HIGH product):

* phase 72: the 3xTF32 GEMM against its plain version at every launch
  shape of the HIGH main paths (the 4y shard's x-DST and y slab, the
  2048² x-DST, the (2, 2) shard's x-DST and z stage, the two
  ``plane_dot`` launches of 512×512×3, of a 130-plane block and of the
  512³ planes, the 128² cavity's x-DST) and at the small ones
  (37×23×11, 128×32, K = 2046 and 510 through factors stored padded and
  packed): ``TOL_GEMM``, its error against a float64 product within
  ``GEMM_VS_SGEMM`` of the SGEMM's, two launches bit-identical, one
  launch a call, its plan (tile, CTAs, tiles, D(K) against
  ``rolling.high_sum_order``, TMA or the 4-byte copies), device ms
  beside its bound, the SGEMM's launch and one ``torch.matmul`` (TF32
  off) of the same product; the sum-order contract bit for bit (a
  512-row slice's x-DST, a 130-plane block's ``plane_dot``,
  ``left_dot`` into column slices at and off 16 bytes, TMA against the
  4-byte copies at K = 2046 and 510).  Phases 27–29, 36, 43, 52 and 59
  fail where a HIGH launch of a main path took the 4-byte copies
  (``high_cp_async_launches``).

On phases 59, 60, 66, 69 and 70 the plain twins of the path are
tripwires too.

It checks status, finiteness, launch counters (set to 0 just before each
main path and read just after) and kernel-vs-plain agreement; any
failure exits non-zero.  The line before the last is a JSON object
describing each kernel (its time, its plain version's, the bound from
this run's bytes and operations, and a library call's time where one
PyTorch call computes the same function); the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.

    python3 chip_smoke.py --profile

adds phase 5: 3 more kernel-path steps of the 512³ and 2048² projection
steps, of each phase-10 configuration, of the (2, 2) HIGHEST step of
phase 52, of the 4y HIGHEST step of phase 59 and of the 512³ buoyant
steps of phase 66, and one step of each path of phases 48, 49, 53, 60
and 66, under
``torch.profiler``,
printing the device time per kernel, the device busy time against the
CUDA-event span and host wall time of those steps (the device's idle
share).

    python3 chip_smoke.py --ghia1000

adds phase 8: the north-star cavity of ``bench.py:919-923``, Re = 1000 on
512², dt = 4e-4, 150000 steps, graded at RMS < 0.01 (about 130 s on an
H100: the loop is bound by the host's launches).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

SEED = 0
N_BIG = 512            # the 3D benchmark grid, 512³
N_2D = 2048            # the 2D benchmark grid, 2048²
TIMED_STEPS = 5
TIMED_STEPS_2D = 20    # bench.py:run_2d times 4 × TIMED_STEPS
# the plain path's warm-up and timed steps where kernel and plain are held
# after one step (its timing alone: a 2048² plain step takes ~0.3 s)
PLAIN_TIMED_STEPS = 3
SRC = "cfd_tpu_torch/csrc/projection_kernels.cu"
SRC_2D = "cfd_tpu_torch/csrc/projection2d_kernels.cu"
A1 = "cfd_tpu/ops/pallas/projection_kernels.py:572"   # pred_bt_compute
A2 = "cfd_tpu/ops/pallas/projection_kernels.py:381"   # corr_bwd_compute
DOT = "cfd_tpu/ops/pallas/projection_kernels.py:226"  # plane_dot_rl
P2 = "cfd_tpu/ops/pallas/projection2d.py:200"         # pred_bt_compute
C2 = "cfd_tpu/ops/pallas/projection2d.py:252"         # corr_compute
DOT2 = "cfd_tpu/ops/pallas/projection2d.py:97"        # block_dot
TDMA2 = "cfd_tpu/ops/pallas/tdma.py:434"              # make_tdma_y_2d
SRC_TDMA2 = "cfd_tpu_torch/csrc/tdma_lines.cu"      # tdma_y2d_kernel
# the y-line kernel's shapes beside the 2D loop's, (ny, nx): the 1024×512
# channel's, a ragged one, and a column too tall for shared memory (the
# global-d′ variant)
Y2D_SHAPES = ((512, 1024), (23, 37), (4096, 256))
RESCUE = "cfd_tpu/solvers/poisson/spectral.py:299"    # rescue matmuls
SRC_RESCUE = "cfd_tpu_torch/csrc/rescue_gemm.cu"
N_GHIA = 128           # the Ghia cavity's grid: the rescue covers every mode
# The Ghia gates of the CG, multigrid and BiCGSTAB solves (phases 16, 21,
# 26) and the HIGH one (phase 29) run half of phase 7's 20000 steps
# (t = 5): the cavity is near steady there, and the whole script has to
# stay well inside its time limit (on an H100 the gates read RMS
# 0.0019-0.0020 against the 0.10 bar at 20000 steps, 0.009-0.010 at
# 10000)
GHIA_SOLVER_STEPS = 10000
EIGEN_Z = "cfd_tpu/solvers/poisson/spectral.py:836"   # eigen z-product
SRC_E = "cfd_tpu_torch/csrc/euler_kernels.cu"
SRC_RK = "cfd_tpu_torch/csrc/rk_kernels.cu"
E3 = "cfd_tpu/ops/pallas/euler_kernels.py:67"         # make_euler_fused
E2 = "cfd_tpu/ops/pallas/euler2d.py:46"               # make_euler2d_fused
RK3 = "cfd_tpu/ops/pallas/rk_kernels.py:61"           # make_rk_stage
RK2 = "cfd_tpu/ops/pallas/rk2d.py:56"                 # make_rk2d_stage
SRC_CG = "cfd_tpu_torch/csrc/cg_kernels.cu"
LAP_DOT = "cfd_tpu/ops/pallas/cg_kernels.py:75"       # make_lap_dot_rolling
CG_UPD = "cfd_tpu/ops/pallas/cg_kernels.py:360"       # make_cg_update
CG_VMEM = "cfd_tpu/ops/pallas/vmem_small.py:243"      # make_cg_vmem_solve
# The planes the whole-solve Krylov kernels take in one cluster (the
# facade's 100×50, the Ghia cavities' 128², run_poisson_iters' 100², a
# ragged 37×23 and 512²), and the shapes their plan sends to the
# grid-wide kernels (a 3D volume, a plane past one cluster's shared
# memory); (nz, ny, nx)
CLUSTER_PLANES = ((1, 23, 37), (1, 50, 100), (1, 100, 100), (1, 128, 128),
                  (1, 512, 512))
GRID_SHAPES = ((9, 17, 33), (1, 700, 700))
N_GRID_CAVITY = 700     # a 2D cavity past one cluster: the grid-wide form
GRID_CAVITY_STEPS = 2
A1_RHS = "cfd_tpu/ops/pallas/projection_kernels.py:699"   # emit="rhs"
A5_CORR = "cfd_tpu/ops/pallas/projection_kernels.py:724"  # corr_all
P2_RHS = "cfd_tpu/ops/pallas/projection2d.py:196"     # emit="rhs"
SRC_MG = "cfd_tpu_torch/csrc/mg_kernels.cu"
SRC_MGS = "cfd_tpu_torch/csrc/mg_solve.cu"
MG_SWEEP = "cfd_tpu/ops/pallas/mg_kernels.py:50"      # make_mg_rb_sweep
MG_VMEM = "cfd_tpu/ops/pallas/vmem_mg.py:114"         # make_mg_vmem_solve
N_MG = 513             # bench.py's multigrid_513
MG_513_ITERS = 11      # the reference's V-cycles there (BENCH_r05.json)
MG2D_ITERS = 5         # ... and run_mg2d_vmem(129)'s
N_MG_STEP = 257        # the MG projection step, run_3d's physics
# A multigrid solve recomputes its residual from x each V-cycle, so in
# float32 it stalls at a floor of about eps·‖A‖·‖e‖; from bench.py's
# Taylor-Green start at 257³ that floor lies above the default relative
# tolerance 1e-6 (phase 20 prints it), and such a solve would run its
# 5000 V-cycles and report −7.  The step runs at a tolerance above it.
MG_STEP_TOL = 1e-3
MG_FLOOR_CYCLES = 30   # V-cycles of the floor measurement
# Simulation.create(65, 65, "projection_multigrid"): at the default 1e-6
# the facade's first float32 solves stall at that floor (about 1.6e-6;
# status −7 after 5000 V-cycles), in the reference's float32 facade too,
# so its solver gets a tolerance above the floor (phase 21 prints it)
MG_FACADE = 65
MG_FACADE_TOL = 1e-5
MG_FACADE_STEPS = 100
SRC_BICG = "cfd_tpu_torch/csrc/bicgstab_kernels.cu"
SRC_SOR = "cfd_tpu_torch/csrc/rbsor_kernels.cu"
B1 = "cfd_tpu/ops/pallas/bicgstab_kernels.py:147"     # pass_pv/st/xr
B2 = "cfd_tpu/ops/pallas/vmem_small.py:326"           # bicgstab vmem solve
S1 = "cfd_tpu/ops/pallas/rbsor_kernels.py:53"         # make_rbsor_sweep
S2_SOR = "cfd_tpu/ops/pallas/vmem_small.py:167"       # rbsor vmem solve
S2_JAC = "cfd_tpu/ops/pallas/vmem_small.py:430"       # jacobi vmem solve
# bench.py:run_poisson_iters(100): the budgets a solve, the two solve
# counts whose difference gives the marginal rate
POISSON_N = 100
POISSON_BUDGETS = (("redblack_sor", 2000), ("cg", 400), ("bicgstab", 150))
POISSON_PAIR = (5, 105)
BICG_512_ITERS_MAX = 5000
SOR_512_SWEEPS = 200
# The BiCGSTAB projection step, run_3d's physics.  At phase 14's 256³ the
# Taylor-Green start's first float32 solve stalls: on the ρ breakdown at 87
# iterations with float32 dots, still at 2e-2 after 270 with float64 dots
# (CPU runs of the plain path); at 128³ it converges (275 iterations).
N_BICG_STEP = 128
N_SOR_STEP = 128       # the RB-SOR projection step, run_3d's physics
N_JAC_STEP = 33        # the Jacobi projection step
SOR_FLOOR_SWEEPS = 2000  # sweeps of a stationary floor measurement
CAVITY_STEPS = 50      # the stationary cavities, 128², Re = 100
GHIA = Path(__file__).resolve().parent / "tests/validation/ghia_data.py"
N_EXPL = 256           # bench.py:run_euler_3d / run_rk_3d, 256³
EXPL_DT = 1e-5         # bench.py's explicit configurations
FACADE_STEPS = 2000
N_CG = 256             # the CG projection step, bench.py:run_3d's parameters
CG_512_ITERS = 1221    # the reference's cg_512 record (BENCH_r05.json:44-47)
CG_STEPS = 3           # CG step: 3 warm-up and 3 timed steps a path
# Simulation.step's fixed dt = 0.005 puts the 100×50 projection past the
# explicit viscous limit (2ν·dt·(1/dx² + 1/dy²) = 1.22 > 1): a grid-scale
# mode grows ~1.44× a step and meets the ±100 clamps near step 40, in the
# reference's float64 step too, so kernel and plain are held against each
# other after 10 steps, before the growth amplifies their rounding.
FACADE_CHECK = 10

SRC_GEMM = "cfd_tpu_torch/csrc/gemm_3xtf32.cu"
SRC_SGEMM = "cfd_tpu_torch/csrc/sgemm_fp32.cu"       # every HIGHEST product
# an instruction's opcode in `cuobjdump -sass` (address, optional predicate)
SASS_OP = r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
SRC_GEMM_TF32 = "cfd_tpu_torch/csrc/gemm_tf32.cu"    # every DEFAULT product
# the depths of the DEFAULT products: the 2048² x-DST and rescue, the
# 512³ planes and the (2, 2) z stage, the 128² Ghia rescue
TF32_DEPTHS = (2048, 2046, 512, 510, 128, 126)
HP_DOT = "cfd_tpu/ops/pallas/rolling.py:42"           # hp_dot_general, HIGH
A2_ANALYTIC = "cfd_tpu/ops/pallas/projection_kernels.py:404"  # analytic t
A4_BWD = "cfd_tpu/ops/pallas/tdma.py:265"              # make_tdma_z_bwd
N_NZ3 = (3, N_BIG, N_BIG)   # the nz = 3 spectral step, run_3d's physics
# spectral_precision=HIGH against HIGHEST after one step, the reference's
# HIGH bars (tests/math/test_mega_kernels.py:134-137 in 3D,
# tests/math/test_pallas2d.py:145-147 in 2D), absolute on fields of order
# one there; a field larger than one (the Taylor-Green p here) is held to
# the bar times its max|·|, and u, v, w also to what the p difference
# passes on through the corrector, dt·|Δp|max/d (large where dt·p/dx is,
# as in run_2d(2048): dt = 1e-5 and max|p| ≈ 1e4 after the first step)
HIGH_P, HIGH_U, HIGH_U_2D = 2e-3, 1e-4, 1e-5
SOR_N = 33                 # SOR and Gauss-Seidel through poisson_solve

# Phases 31-34: buoyancy, the energy equation and bc_refresh
T_HOT, T_COLD, T_REF = 310.0, 290.0, 300.0
BETA = 3e-3            # the buoyant checks' and steps' expansion coefficient
ALPHA_3D = 1e-3        # 512³ at dt = 1e-4: inside dx²/(6α)
ALPHA_EXPL = 1e-3      # 2048² at dt = 1e-5: inside dx²/(4α)
# thermal faces (left, right, bottom, top, back, front): each type on
# each axis between the two mixes
THERMAL_FACE_MIXES = {
    "mixed": ("DIRICHLET", "DIRICHLET", "NEUMANN", "NEUMANN", "PERIODIC",
              "PERIODIC"),
    "neumann_periodic": ("NEUMANN", "PERIODIC", "DIRICHLET", "NEUMANN",
                         "NEUMANN", "DIRICHLET")}
A1_BUOY = "cfd_tpu/ops/pallas/projection_kernels.py:576"  # pred_bt, T halo
P2_BUOY = "cfd_tpu/ops/pallas/projection2d.py:200"        # pred_bt, T halo
# Phases 65-67: the buoyant predictor modes on shard blocks and the
# energy post-step on the decomposed projection steps
# (the reference pads T as u, v, w: fused.py:532, :817-818, :1031)
A1_BUOY_SHARD = "cfd_tpu/ops/pallas/projection_kernels.py:577"  # Tw, kg
A1_BUOY_ZY = "cfd_tpu/ops/pallas/projection_kernels.py:582"  # + y_off
P2_BUOY_ROWS = "cfd_tpu/ops/pallas/projection2d.py:166"  # bsrc, global rows
# Phases 68-70: the consistent scheme on the z-decomposed step (the
# consistent pins composed with global_nz, projection_kernels.py:203-211)
A1_CONS_SHARD = "cfd_tpu/ops/pallas/projection_kernels.py:590"  # kg, pins
A5_BT_CONS_SHARD = "cfd_tpu/ops/pallas/projection_kernels.py:658"  # faces
# examples/pulsatile_inlet_flow.py's channel, 1024×512 (ν = 0.05: the
# viscous number 2ν·dt·(1/dx² + 1/dy²) is 0.52 at dt = 1e-5)
PULSE = (1024, 512)
PULSE_DT = 1e-5
PULSE_STEPS = 300
# bench.py:dvd_gate: de Vahl Davis Ra = 1e4 at 128²
N_DVD = 128
DVD_BETA = 0.003333
DVD_DT = 5e-4
DVD_CHUNK = 4000
# phase 67's chunk over 4y, a quarter of phase 34's: the sharded march is
# host-bound, and the whole run stays near 1000 s beside phases 68-70
DVD_CHUNK_4Y = 1000
DVD_MAX_STEPS = 80000

# Phases 35-37: stretched grids and the consistent scheme
STRETCH_BETA = 1.5     # bench.py:run_3d_consistent / run_euler_3d
SRC_STRETCH = "cfd_tpu_torch/csrc/explicit_common.cuh"
A1_CONS = "cfd_tpu/ops/pallas/projection_kernels.py:594"  # consistent pins
A1_FACE = "cfd_tpu/ops/pallas/projection_kernels.py:658"  # face coeffs
A2_CONS = "cfd_tpu/ops/pallas/projection_kernels.py:420"  # grad pins
A5_CONS = "cfd_tpu/ops/pallas/projection_kernels.py:735"  # corr_all grad
E3_STRETCH = "cfd_tpu/ops/pallas/euler_kernels.py:104"    # stretch pins
E2_STRETCH = "cfd_tpu/ops/pallas/euler2d.py:67"
RK3_STRETCH = "cfd_tpu/ops/pallas/rk_kernels.py:106"
RK2_STRETCH = "cfd_tpu/ops/pallas/rk2d.py:82"
# the 2D consistent step: jnp in the reference (projection.py:292-293);
# the port's kernels replace its predictor / rhs / corrector sweeps there
P2_CONS = "cfd_tpu/solvers/ns/projection.py:726"
N_CONS_KRYLOV = 128    # the consistent CG / BiCGSTAB steps
CONS_RESIDUAL_BAR = 1e-3
# the consistent step at HIGH against HIGHEST: the reference's bar
# (tests/math/test_projection_consistent_fused.py:143-162)
HIGH_P_CONS = 5e-3
POISEUILLE = (40, 32, 500)

# Phases 38-41: spectral_precision="default" and the differentiable steps
N_HYBRID = 128         # bench.py:run_hybrid_adjoint(128, 10), the CG hybrid
HYBRID_STEPS = 10
N_ADJOINT = 1024       # bench.py:run_adjoint(1024, 50)
ADJOINT_STEPS = 50
N_HYBRID_FFT = 256     # the FFT_DIRECT hybrid projection rollout
POISEUILLE_BARS = {0.0: 0.05, 1.5: 0.20, 2.0: 0.30}

# Phases 42-45: the z-decomposed spectral step (cfd_tpu_torch.parallel)
SHARDS = 4             # z-shards emulated on the one card (LocalComm)
A1_SHARD = "cfd_tpu/ops/pallas/projection_kernels.py:561"     # global_nz
A5_BT_SHARD = "cfd_tpu/ops/pallas/projection_kernels.py:464"  # btilde_k
A5_CORR_SHARD = "cfd_tpu/ops/pallas/projection_kernels.py:760"  # corr_all
A4_MU = "cfd_tpu/ops/pallas/tdma.py:126"              # make_tdma_z(mu=None)
# Phases 46-49: the z-decomposed CG and BiCGSTAB steps
CG_SHARD = "cfd_tpu/ops/pallas/cg_kernels.py:437"     # make_lap_dot_sharded
CG_UPD_SHARD = "cfd_tpu/parallel/fused_cg.py:216"     # the owned-block axpy
B1_SHARD = "cfd_tpu/ops/pallas/bicgstab_kernels.py:56"    # global_nz pv/st
B1_XR_SHARD = "cfd_tpu/ops/pallas/bicgstab_kernels.py:133"  # xr, owned
A5_DIV_SHARD = "cfd_tpu/ops/pallas/projection_kernels.py:340"  # divergence
A5_CORR_XY = "cfd_tpu/ops/pallas/projection_kernels.py:516"    # corr_xy
# Phases 50-53: the (z, y)-decomposed step's global-row modes
A1_ZY = "cfd_tpu/ops/pallas/projection_kernels.py:306"    # pred_u/v/w y_off
A5_DIV_ZY = "cfd_tpu/ops/pallas/projection_kernels.py:343"  # divergence
A5_BT_ZY = "cfd_tpu/ops/pallas/projection_kernels.py:475"   # btilde_k
A5_CORR_ZY = "cfd_tpu/ops/pallas/projection_kernels.py:519"  # corr_u/v/w
CG_ZY = "cfd_tpu/ops/pallas/cg_kernels.py:483"      # global_ny lap_dot
CG_UPD_ZY = "cfd_tpu/parallel/fused_cg.py:218"      # the owned-point axpy
DOT_ZY = "cfd_tpu/ops/pallas/projection_kernels.py:240"  # x-only DST
YZ_Z = "cfd_tpu/solvers/poisson/spectral.py:645"    # the z-stage einsum

# Phases 54-57: the decomposed explicit steps (cfd_tpu_torch.parallel.
# fused_explicit) and their kernel modes
E3_ZY = "cfd_tpu/ops/pallas/euler_kernels.py:108"   # global_ny
E2_Y = "cfd_tpu/ops/pallas/euler2d.py:75"            # global_ny
RK3_Z = "cfd_tpu/ops/pallas/rk_kernels.py:183"       # global_nz
RK3_ZY = "cfd_tpu/ops/pallas/rk_kernels.py:110"      # + global_ny
RK2_Y = "cfd_tpu/ops/pallas/rk2d.py:90"              # global_ny
# Phases 58-61: the (z, y) BiCGSTAB step and the y-decomposed 2D step
B1_ZY = "cfd_tpu/ops/pallas/bicgstab_kernels.py:69"   # global_ny masks
B1_XR_ZY = "cfd_tpu/parallel/fused_bicgstab.py:229"   # xr, owned block
YS_2D = "cfd_tpu/solvers/poisson/spectral.py:386"     # slab y-eigen matmuls
# The 2D step over 4 y-shards at HIGHEST (phase 59): its dense y-eigen
# solve and the single-device step's Thomas + rescue round differently
# (the two float32 steps 2.0e-5 apart on u, 1.95e-3 = 1.8e-7·max|p| on p
# after the first 2048^2 step, on an H100), so the first step is held
# against the float64 step on the card at fixed bars about twice the
# readings (u 8.2e-4, p 0.0704 = 6.5e-6·max|p|, the single-device step's
# distance the same): a halo, transpose or shell fault moves u by 1e-2
# and more.
TOL_2D_F64_UVW = 2e-3
TOL_2D_F64_P = 1.3e-5      # of max|p| of the float64 step (10863)

# a decomposed explicit step against the single-device kernel step: the
# same arithmetic at every point and the same faces, so expected bit for
# bit; a difference is held at 2e-6 (the reference's own sharded-vs-jnp
# bar is 5e-6, tests/parallel/test_fused_sharded.py:222-224)
TOL_SHARDED_EXPLICIT = 2e-6

# The card's peaks for a kernel's bound (H100 SXM data sheet, at 700 W):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s,
# dense TF32 on the tensor cores 494.7 TFLOP/s (the 3xTF32 GEMM's rate).
# A bound is the larger of (bytes in + bytes out) / rate and flops / peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_TC_FLOPS = 494.7e12
# float32 operations per grid point, counted from the kernels' sources
# (adds, multiplies, divides and compares of one point's update)
FLOPS_PER_POINT = {"predictor_star": 90, "poisson_input": 12,
                   "corrector": 20, "tdma_fwd": 7, "tdma_bwd": 2,
                   # the 2D y-lines fed rec and t by their planes: the
                   # forward row's product, sum and product, and the back
                   # substitution's 2
                   "tdma_y2d": 5,
                   # the analytic back substitution: two products and a
                   # sum for the exponents, two expm1f (about 10 each),
                   # a product and a quotient, the update's 2
                   "tdma_bwd_analytic": 27,
                   "euler": 130, "rk_stage": 150, "poisson_rhs": 8,
                   # buoyancy: T − T_ref and a product and a sum a
                   # component; the energy update (the final RK stage):
                   # ~28 (two second differences, three advection terms)
                   "predictor_star_buoyant": 97, "euler_thermal": 165,
                   "rk_stage_thermal": 185,
                   "lap_dot": 18, "cg_update": 6,
                   # one whole-solve CG iteration: Ap, ⟨p,Ap⟩, the two
                   # α-updates, ⟨r,r⟩ and the p update
                   "cg_iter": 24,
                   # a 3D red-black sweep (each interior point updated
                   # once), the 3D residual field
                   "rb_sweep": 10, "mg_residual": 13,
                   # the 2D whole solve (mg_solve.cu), per interior point:
                   # a sweep, the residual, restriction per coarse point,
                   # prolongation and add per fine point (1, 3, 3 or 7 by
                   # parity), and each iteration's b0, E update and norm
                   "mg2d_sweep": 7, "mg2d_residual": 9, "mg2d_restrict": 20,
                   "mg2d_prolong": 3.5, "mg2d_iter": 21,
                   # the BiCGSTAB passes, a point of the interior: p' 3,
                   # -lap 13, a dot 2; s 2, -lap 13, three dots 6; the x
                   # and r updates 6, two dots 4
                   "bicg_pv": 18, "bicg_st": 21, "bicg_xr": 10,
                   # a red-black SOR sweep (nb 8, gs 3, update 3) and the
                   # residual of the mirrored iterate (lap 13, sub, abs)
                   "rbsor_sweep": 29,
                   # the 2D whole solves, a point of the interior: one
                   # BiCGSTAB iteration (p 3, v 9 and a dot 2, s 2 and a
                   # dot 2, t 9 and two dots 4, x and r 6 and two dots 4);
                   # a red-black SOR or a Jacobi sweep; a residual check
                   "bicg_iter_2d": 41, "sor_sweep_2d": 11,
                   "jacobi_sweep_2d": 8, "residual_2d": 10,
                   # the consistent scheme: each x/y first derivative 5
                   # (three products, two sums) for 3 of the uniform
                   # one, each second derivative 5 for 4; the predictor
                   # takes 9 of each, b̃ 2 first derivatives and the face
                   # weights (4 products, 4 sums), the corrector 2
                   "predictor_star_cons": 108, "poisson_input_cons": 20,
                   "predictor_star_cons_buoyant": 115,
                   "poisson_rhs_cons": 12, "corrector_cons": 24,
                   "euler_cons": 160, "rk_stage_cons": 180,
                   "euler_cons_thermal": 205, "rk_stage_cons_thermal":
                   225}

# Tolerances, kernel against plain version on identical inputs, float32:
#  * fields (u*, v*, w*, u, v, w): atol 2e-5, the reference's own
#    fused-vs-plain bar (tests/math/test_mega_kernels.py:57-60);
#  * stencil and Thomas outputs (b̃, d′, t, x̂): same operation order in
#    kernel and plain version (-fmad=false), so expected exact; bound at
#    1e-6 of the output's max magnitude;
#  * DST products and everything downstream of them (p, transformed
#    planes, the rescue columns, max p, max|p|): the SGEMM sums K terms in
#    another order than cuBLAS, so the bound scales with the magnitude —
#    2e-5 of max|ref| (≈ sqrt(512) ulps of headroom over a 512-term fp32
#    sum);
#  * max|u|²: rtol 1e-6 (tests/math/test_mega_kernels.py:63-66);
#  * the explicit kernels (Euler step, RK stage): same operation order,
#    -fmad=false and the same source vectors, so expected bit-equal; held
#    at TOL_EXACT of max|ref| (the fields and their maxima alike).
TOL_FIELD = 2e-5
TOL_EXACT = 1e-6
TOL_GEMM = 2e-5
TOL_DIAG = 1e-6
# The 3xTF32 GEMM against a float64 product of its fp32 inputs: at most
# this multiple of the SGEMM's error there (3xTF32 drops the small·small
# term, about 2⁻²² relative a product, where fp32 rounds at 2⁻²⁴)
GEMM_VS_SGEMM = 2.0
# A step at spectral_precision="default" (one TF32 pass a product) on two
# paths, or against HIGHEST: each product rounds its operands to TF32, so
# where two paths' fp32 sums differ in the last bits (the kernel and its
# plain version sum in other orders) a downstream operand can round to the
# neighbouring TF32 value, 2⁻¹⁰ of it; the transform pipeline passes that
# on to p.  A CPU run of the plain step at 128³ with only the GEMMs' sum
# order changed moved p by 4.1e-4 of max|p|, and DEFAULT differs from
# HIGHEST by 1.0e-3 there: p is held at 1e-2 of max|p| (about ten TF32
# ulps), u, v, w at what that passes on through the corrector.  The one
# GEMM alone is held at TOL_GEMM: its operands are rounded the same way.
TOL_TF32_STEP = 1e-2
# The 2048^2 DEFAULT step over 4y against the single-device DEFAULT step:
# p read 3.593e-7 of max|p| in two runs on the H100 (the same products on
# the same operands, the sums in another order), held at about thirty
# times that; TOL_TF32_STEP would pass an error 28000 times the reading.
TOL_TF32_4Y = 1e-5


# The CG kernels: fields in the plain versions' operation order
# (TOL_EXACT); the dots fold their partials in another order than
# torch.sum, 1e-5 relative; the whole solves (K3, the CG step) are held
# at the reference's own bars — ±2 iterations and x within 1e-5·max|x|
# (tests/math/test_vmem_small.py:105-120), u, v, w within atol 1e-4
# (:198-199) and p within rtol 1e-3 / atol 1e-4·max|p|
# (tests/math/test_pallas_kernels.py:118-120).
TOL_DOT = 1e-5
TOL_CG_UVW = 1e-4

# The (z, y) FFT_DIRECT step at HIGHEST (phase 52).  Its dense z stage
# and the single-device step's Thomas solve round differently, and the
# single-device float32 step is the further from float64 (on an H100:
# u 8.9e-5, p 0.127 = 2.1e-4·max|p| after the first 512³ step, where the
# (z, y) step reads u 4.9e-5, p 1.78e-3 = 2.9e-6·max|p|), so the first
# step is held against the float64 step at fixed bars about twice those
# readings: a halo, transpose or shell fault moves u by 1e-2 and more.
# After the timed steps the two float32 steps are held against each other
# (they read u 6.9e-5, p 4.1e-5·max|p| after 5 steps).
TOL_ZY_F64_UVW = 1e-4
TOL_ZY_F64_P = 1e-5        # of max|p| of the float64 step (614 after one)
TOL_ZY_DRIFT_UVW = 2e-4
TOL_ZY_DRIFT_P = 1e-4      # of max|p| of the single-device step


PROFILED_STEPS = 3


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def profile_steps(torch, label, run, n_steps):
    """Run ``run()`` (``n_steps`` steps) under torch.profiler; print each
    device kernel's ms per step, the number of device events (kernels and
    copies), and the device busy time against the CUDA-event span and the
    host wall time of the run.  Returns ({kernel: ms}, busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    span_ms = start.elapsed_time(end)
    per_kernel = {}
    n_events = 0
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        n_events += 1
        per_kernel[ev.name] = (per_kernel.get(ev.name, 0.0)
                               + ev.time_range.elapsed_us() / 1e3)
    if not per_kernel:
        fail("profile: the profiler saw no device events")
    busy_ms = sum(per_kernel.values())
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  profile {ms / n_steps:9.4f} ms/step  {name[:60]}",
              flush=True)
    print(f"{label} profile over {n_steps} steps: {n_events} device "
          f"events, device busy "
          f"{busy_ms:.3f} ms, CUDA-event span {span_ms:.3f} ms, host wall "
          f"{wall_ms:.3f} ms; idle share {1 - busy_ms / span_ms:.4f} of the "
          f"span, {1 - busy_ms / wall_ms:.4f} of the wall", flush=True)
    return per_kernel, busy_ms


def main() -> int:
    import numpy as np
    import torch

    args = sys.argv[1:]
    do_profile = "--profile" in args
    do_ghia1000 = "--ghia1000" in args

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA device", file=sys.stderr)
        return 2

    from cfd_tpu_torch import FlowField, Grid
    from cfd_tpu_torch.api import Simulation
    from cfd_tpu_torch.boundary import (BCType, DirichletValues, InletConfig,
                                        OutletConfig, ThermalBCConfig,
                                        apply_inlet, apply_noslip,
                                        apply_outlet_velocity,
                                        apply_dirichlet_scalar,
                                        apply_neumann_scalar)
    from cfd_tpu_torch.entry import entry
    from cfd_tpu_torch.ops.kernels import bicgstab_kernels as bk
    from cfd_tpu_torch.ops.kernels import cg_kernels as cgk
    from cfd_tpu_torch.ops.kernels import euler2d as e2m
    from cfd_tpu_torch.ops.kernels import euler_kernels as ekm
    from cfd_tpu_torch.ops.kernels import mg_kernels as mgk
    from cfd_tpu_torch.ops.kernels import native
    from cfd_tpu_torch.ops.kernels import projection2d as pk2m
    from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
    from cfd_tpu_torch.ops.kernels import rk2d as rk2m
    from cfd_tpu_torch.ops.kernels import rbsor_kernels as sk
    from cfd_tpu_torch.ops.kernels import rk_kernels as rkm
    from cfd_tpu_torch.ops.kernels import rolling, tdma, vmem_mg, vmem_small
    from cfd_tpu_torch.solvers.ns.common import (field_status_and_diagnostics,
                                                 source_basis)
    from cfd_tpu_torch.solvers.ns.euler import make_euler_step
    from cfd_tpu_torch.solvers.ns.params import NSParams
    from cfd_tpu_torch.solvers.ns.projection import (make_projection_step,
                                                     thermal_post_step)
    from cfd_tpu_torch.solvers.ns.rk import make_rk2_step, make_rk4_step
    from cfd_tpu_torch.solvers.ns.rollout import make_rollout, run_steps
    from cfd_tpu_torch.solvers.poisson import frontend, krylov
    from cfd_tpu_torch.solvers.poisson import multigrid as mgs
    from cfd_tpu_torch.solvers.poisson import spectral, stationary
    from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                    PoissonProblem,
                                                    PoissonStatus, Precond)
    from cfd_tpu_torch.solvers.poisson.nonuniform import (
        NonuniformPoissonProblem, make_nonuniform_direct,
        make_nonuniform_fused_pieces, nonuniform_face_coeffs)
    from cfd_tpu_torch.solvers.poisson.spectral import (
        make_dst2d_fused_pieces, make_dst_fused_pieces)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: the card -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    print(card, flush=True)
    print(f"phase 1 card: {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    native.library()
    print(f"phase 2 build: {native.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in (native.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # ---- helpers -------------------------------------------------------------
    def sync():
        torch.cuda.synchronize(dev)

    def cuda_ms(fn, reps=3):
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    sleep_rate = []     # torch.cuda._sleep cycles per ms, measured once

    def device_ms(fn, reps=5):
        """ms of device time a call of ``fn`` (every kernel and copy it
        launches): the calls are queued behind a device-side sleep
        (``torch.cuda._sleep``) that outlasts the host's enqueueing of
        them, so the CUDA events around them time the device, not the
        host's calls, which outlast a shard's kernel.  torch.profiler's
        CUDA events lost kernels late in a run (on an H100 a 260x260x512
        buoyant predictor read 0.089 ms where a fresh process profiled
        0.445 ms a call, the queued span 0.436), so they time only a call
        that waits on the device itself (the host never gets ahead of
        it), as they did before."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if not sleep_rate:
            torch.cuda._sleep(10 ** 6)
            start.record()
            torch.cuda._sleep(10 ** 7)
            end.record()
            sync()
            sleep_rate.append(10 ** 7 / start.elapsed_time(end))
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        lead_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 1.0
        sync()
        for _ in range(2):
            torch.cuda._sleep(int(lead_ms * sleep_rate[0]))
            start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            end.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
            sync()
            if queued_ms < lead_ms:
                return start.elapsed_time(end) / reps
            lead_ms *= 4.0
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type.name == "CUDA")
        if busy <= 0:
            fail("device_ms: the profiler saw no device events")
        print("  device_ms: the call waits on the device; profiler time",
              flush=True)
        return busy / 1e3 / reps

    # (path, wrapper name) -> dict of numbers (512³ / 2048² where measured)
    records = {}

    def compare(tag, name, got, ref, tol, scaled):
        """max abs error, and error relative to max|ref|; fail beyond.
        Returns both."""
        got, ref = got.double(), ref.double()
        if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
            fail(f"{tag} {name}: non-finite output")
        err = float((got - ref).abs().max())
        scale = max(float(ref.abs().max()), 1e-30)
        rel = err / scale
        bound = tol * scale if scaled else tol
        print(f"  {tag} {name}: max_abs={err:.3e} max_rel={rel:.3e} "
              f"bound={bound:.3e}", flush=True)
        if not err <= bound:
            fail(f"{tag} {name}: error {err:.3e} above bound {bound:.3e}")
        return err, rel

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if torch.is_tensor(t))

    def cons_name(fn):
        """The record name of a wrapper's consistent instantiation."""
        return f"{fn.__name__}[consistent]"

    def launches_of(wrappers):
        """{record name: launches}: a wrapper's ``launches``, or for a
        (wrapper, scheme) pair its ``<scheme>_launches`` (the stretched
        instantiations, `native.count_launch`) under the record name
        ``wrapper[scheme]``."""
        counts = {}
        for w in wrappers:
            fn, scheme = w if isinstance(w, tuple) else (w, None)
            if scheme is None:
                counts[fn.__name__] = fn.launches
            else:
                counts[f"{fn.__name__}[{scheme}]"] = getattr(
                    fn, f"{scheme}_launches")
        return counts

    def bound(n_bytes, flops, rate=FP32_FLOPS):
        """(ms, "bytes" or "operations"): the least time the card could
        take to move ``n_bytes`` and do ``flops`` operations at ``rate``
        (the fp32 CUDA-core peak, or the TF32 tensor-core one)."""
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / rate * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")

    def check(path, tag, timed, wrapper, replaces, source, kernel, plain,
              outs, tols, work=None, library=None, time_fn=None, name=None,
              rate=FP32_FLOPS, device_time=False, repeat=False):
        """Run ``kernel`` (the wrapper) and ``plain`` on the same inputs,
        compare each output; time both when ``timed``.  ``path`` names the
        main path whose launch count the record takes (the Thomas and
        SGEMM wrappers serve "3d" and "2d").  ``work`` = (input tensors,
        flops) gives the bound, with every input read once and every
        output written once; ``library`` is one PyTorch call computing the
        same function, timed beside the kernel (the port never calls
        it); ``work``'s first entry may be the bytes the kernel must
        read instead, where it reads only part of its inputs (a sharded
        block's halos); ``work`` may carry a third entry, the bytes the
        kernel writes, where its outputs hold more than it writes (a
        sharded mid stage's halos); ``time_fn``, when given, is what is timed
        for the kernel (the launch as the main path makes it).
        ``name`` keys the record where the wrapper launches more than one
        kernel (the GEMMs at each precision); ``rate`` is the
        operations' peak for the bound; ``device_time`` times kernel,
        plain and library by their device time (`device_ms`) and prints
        the kernel's and plain's CUDA-event span beside it; ``repeat``
        launches the kernel a second time and fails unless its outputs
        are the first launch's bit for bit."""
        name = name or wrapper.__name__
        got = kernel()
        ref = plain()
        sync()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if repeat:
            again = kernel()
            again = again if isinstance(again, tuple) else (again,)
            sync()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"  {tag} {name}: two launches bit-identical {same}",
                  flush=True)
            if not same:
                fail(f"{tag} {name}: two launches differ")
            del again
        rec = records.setdefault((path, name), {
            "replaces": replaces, "source": source, "max_abs_err": 0.0,
            "max_rel_err": 0.0})
        for o, gk, rk, (tol, scaled) in zip(outs, got, ref, tols):
            err, rel = compare(tag, f"{name}.{o}", gk, rk, tol, scaled)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["max_rel_err"] = max(rec["max_rel_err"], rel)
        if timed:
            rec["ms"] = cuda_ms(time_fn or kernel)
            rec["plain_ms"] = cuda_ms(plain)
            if device_time:
                print(f"  {tag} {name}: CUDA-event span kernel "
                      f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} "
                      f"ms (the host's calls)", flush=True)
                rec["ms"] = device_ms(time_fn or kernel)
                rec["plain_ms"] = device_ms(plain)
            rec["library_ms"] = None if library is None else (
                device_ms(library) if device_time else cuda_ms(library))
            ins, flops = work[:2]
            in_bytes = ins if isinstance(ins, int) else nbytes(ins)
            out_bytes = work[2] if len(work) > 2 else nbytes(got)
            rec["bound_ms"], rec["bound_by"] = bound(
                in_bytes + out_bytes, flops, rate)
            print(f"  {tag} {name}: kernel {rec['ms']:.3f} ms, plain "
                  f"{rec['plain_ms']:.3f} ms, library "
                  f"{rec['library_ms']} ms, bound {rec['bound_ms']:.3f} "
                  f"ms ({rec['bound_by']})", flush=True)
        return ref

    def gemm_flops(m, n, k, batch=1):
        return 2.0 * m * n * k * batch

    # the one-pass GEMM's plan of each DEFAULT launch checked: tag -> D(K),
    # cluster size, CTAs, chunks
    tf32_plans = {}

    def tf32_plan(tag, m, n, k, batch=1):
        """Print and keep the one-pass GEMM's plan of an m×n×k launch
        over ``batch`` (`rolling.tf32_plan`: D(K), the cluster size, the
        CTAs); fail where its chunks are not `rolling.tf32_sum_order`'s,
        the order the tests hold."""
        pl = rolling.tf32_plan(m, n, k, batch)
        tf32_plans[tag] = dict(pl, M=m, N=n, K=k, batch=batch)
        d, chunks = rolling.tf32_sum_order(k)
        print(f"  {tag}: one-pass GEMM M={m} N={n} K={k} batch={batch}: "
              f"D(K)={pl['D']}, {pl['chunks']} chunks, cluster "
              f"{pl['cluster']}, {pl['ctas']} CTAs", flush=True)
        if pl["D"] != d or pl["chunks"] != len(chunks):
            fail(f"{tag}: the kernel's chunks (D={pl['D']}, "
                 f"{pl['chunks']}) are not tf32_sum_order's ({d}, "
                 f"{len(chunks)})")
        return pl

    def ieee_matmul(fn):
        """``fn`` run with TF32 off (IEEE fp32, as the SGEMM)."""
        def run():
            with rolling.ieee_fp32_matmul():
                return fn()
        return run

    def no_element_loads(label, precision="highest"):
        """Fail where a GEMM launch of a main path at ``precision`` (the
        SGEMM at "highest", the 3xTF32 GEMM at "high") loaded its operands
        through the 4-byte copies (a factor or slab off 16 bytes) since
        the counters were last set to 0."""
        name = rolling.CP_ASYNC_COUNTERS[precision]
        n_el = {g_.__name__: getattr(g_, name)
                for g_ in (rolling.plane_dot, rolling.right_dot,
                           rolling.left_dot)}
        what = {"highest": "SGEMM", "high": "3xTF32"}[precision]
        print(f"{label}: {what} launches through the 4-byte copies {n_el}",
              flush=True)
        if max(n_el.values()) != 0:
            fail(f"{label}: a {what} launch did not load by TMA")

    fld = (TOL_FIELD, False)
    exact = (TOL_EXACT, True)
    gemm = (TOL_GEMM, True)
    bit = (0.0, False)   # bit-equal

    def noisy(f, gen_seed):
        g = torch.Generator(device=dev).manual_seed(gen_seed)

        def noise(t):
            return t + 0.1 * torch.randn(t.shape, generator=g, device=dev)

        return f.replace(u=noise(f.u), v=noise(f.v), w=noise(f.w),
                         p=noise(f.p))

    def make_inputs(n_grid, gen_seed):
        nz, ny, nx = n_grid
        grid = Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
        f = noisy(FlowField.initialize(grid, dtype=torch.float32,
                                       device=dev), gen_seed)
        problem = PoissonProblem(nx, ny, nz, grid.dx0, grid.dy0, grid.dz0)
        mats, (mu, w) = make_dst_fused_pieces(problem, torch.float32, dev)
        c = pkm.StencilConsts(nz, ny, nx, grid.dx0, grid.dy0, grid.dz0,
                              grid.xmin, grid.ymin, NSParams().mu, True)
        return f, mats, mu, w, c

    # the rescue GEMM (rolling.rescue_dot): its two products at each
    # precision, (shape, precision) -> the device ms of each, the
    # library's, the earlier path's (left_dot, then the divide) and the
    # bounds
    rescue_rec = {}
    # the sum-order contract's checks, bit for bit: tag -> held; the
    # one-pass GEMM's error at each DEFAULT depth: K -> max_rel
    contract = {}
    tf32_depths = {}

    def rescue_checks(path, tag, ysolve, a, prec, name, rate, library,
                      record, timed=True):
        """``ysolve``'s two rescue products through `rolling.rescue_dot`
        at ``prec`` against the plain version (TOL_GEMM): s = Fyp·a[:, :K]
        / λ, then Gyp·s into x̂'s first K columns in place (the other
        columns held exactly); each kernel launch twice, bit-identical
        (the fixed rank order of the cluster's sum), and the fused divide
        bit-equal to the kernel's product divided after it.  With
        ``timed``, the device time (`device_ms`: the wrapper's host calls
        outlast a 128² launch and come near a 2048² one) of both products,
        of the library call of each (``library`` wraps ``torch.matmul``;
        it leaves the divide out) and of the earlier path (`left_dot`,
        then the divide) into ``rescue_rec``; with ``record`` the first
        product's numbers are record ``name`` of ``path``."""
        fyp, gyp, k = ysolve.rescue
        lam, ak = ysolve.lam, a[:, :k]
        passes = 3 if prec == "high" else 1
        src = SRC_GEMM_TF32 if prec == "default" else SRC_RESCUE
        if prec == "default":
            tf32_plan(f"{tag} rescue Fy·a[:, :K]/λ", fyp.shape[0], k,
                      fyp.shape[1])
            tf32_plan(f"{tag} rescue Gy·s", gyp.shape[0], k, gyp.shape[1])
        flops1 = passes * gemm_flops(fyp.shape[0], k, fyp.shape[1])
        flops2 = passes * gemm_flops(gyp.shape[0], k, gyp.shape[1])

        def kern1():
            return rolling.rescue_dot(fyp, ak, lam, precision=prec)

        def plain1():
            return rolling.rescue_dot_plain(fyp, ak, lam, precision=prec)

        sp = check(path, tag, False, rolling.rescue_dot, RESCUE,
                   src, kern1, plain1, ("Fy·a[:, :K]/λ",), (gemm,),
                   name=name)[0]
        x0 = torch.randn(a.shape, generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        outk, outp = x0.clone(), x0.clone()

        def kern2():
            return rolling.rescue_dot(gyp, sp, out=outk[:, :k],
                                      precision=prec)

        check(path, tag, False, rolling.rescue_dot, RESCUE, src,
              kern2,
              lambda: rolling.rescue_dot_plain(gyp, sp, out=outp[:, :k],
                                               precision=prec),
              ("Gy·s",), (gemm,), name=name)
        compare(tag, f"{name}.untouched columns", outk[:, k:], x0[:, k:],
                0.0, False)
        s1, s2 = kern1(), kern1()
        s_nolam = rolling.rescue_dot(fyp, ak, precision=prec)
        o2 = x0.clone()
        rolling.rescue_dot(gyp, sp, out=o2[:, :k], precision=prec)
        sync()
        same = torch.equal(s1, s2) and torch.equal(outk, o2)
        fused = torch.equal(s_nolam / lam, s1)
        print(f"  {tag} {name}: two launches bit-identical {same}; fused "
              f"divide == product / λ bit for bit {fused}", flush=True)
        if not (same and fused):
            fail(f"{tag} {name}: launches differ, or the fused divide is "
                 f"not the divide after the product")
        if prec == "default":
            # the sum-order contract (check (a)): the rescue's launches,
            # their K split across a cluster, give the bits of the
            # full-width products through left_dot (the 4y step's slab
            # solve), whose launches walk the chunks in one CTA or split
            # them by their own tile count
            s_full = rolling.left_dot(fyp, a, precision=prec)
            wide = torch.randn((sp.shape[0], a.shape[1]),
                               generator=torch.Generator(
                                   device=dev).manual_seed(SEED + 1),
                               device=dev)
            wide[:, :k] = sp
            x_full = rolling.left_dot(gyp, wide, precision=prec)
            tf32_plan(f"{tag} left_dot(Fy, a)", fyp.shape[0], a.shape[1],
                      fyp.shape[1])
            tf32_plan(f"{tag} left_dot(Gy, s wide)", gyp.shape[0],
                      a.shape[1], gyp.shape[1])
            sync()
            c_s = torch.equal(s_full[:, :k] / lam, s1)
            c_x = torch.equal(x_full[:, :k], outk[:, :k])
            print(f"  {tag} {name}: contract (a): s == left_dot(Fy, a)"
                  f"[:, :K] / λ bit for bit {c_s}; Gy·s == left_dot(Gy, "
                  f"s wide)[:, :K] bit for bit {c_x}", flush=True)
            if not (c_s and c_x):
                fail(f"{tag} {name}: the rescue's products are not the "
                     f"full-width products' columns (sum-order contract)")
            contract[f"{tag} (a)"] = c_s and c_x
            del s_full, wide, x_full
        if timed:
            if prec == "default":
                clusters = [rolling.tf32_plan(m_, k, k_)["cluster"]
                            for m_, k_ in (fyp.shape, gyp.shape)]
            else:
                kind = {"highest": 0, "high": 3}[prec]
                clusters = [native.library().cfd_rescue_cluster(
                    kind, m_, k, k_) for m_, k_ in (fyp.shape, gyp.shape)]
            t = {"K": k, "M": fyp.shape[0],
                 "cluster": clusters[0], "cluster_gy": clusters[1],
                 "ms": device_ms(kern1, reps=20),
                 "ms_gy": device_ms(kern2, reps=20),
                 "library_ms": device_ms(library(
                     lambda: torch.matmul(fyp, ak)), reps=20),
                 "library_ms_gy": device_ms(library(
                     lambda: torch.matmul(gyp, sp)), reps=20),
                 "earlier_ms": device_ms(lambda: rolling.left_dot(
                     fyp, ak, precision=prec) / lam, reps=20),
                 "earlier_ms_gy": device_ms(lambda: rolling.left_dot(
                     gyp, sp, out=outk[:, :k], precision=prec), reps=20)}
            t["bound_ms"], t["bound_by"] = bound(
                nbytes((fyp, ak, lam, sp)), flops1, rate)
            t["bound_ms_gy"] = bound(nbytes((gyp, sp, sp)), flops2,
                                     rate)[0]
            rescue_rec[f"{a.shape[1]}x{a.shape[0]} {prec}"] = t
            print(f"  {tag} {name}: clusters of {t['cluster']} and "
                  f"{t['cluster_gy']} CTAs; device ms Fy·a/λ {t['ms']:.4f} "
                  f"(library {t['library_ms']:.4f}, "
                  f"{t['ms'] / t['library_ms']:.2f}x; earlier left_dot + "
                  f"divide {t['earlier_ms']:.4f}; bound "
                  f"{t['bound_ms']:.4f}), Gy·s {t['ms_gy']:.4f} (library "
                  f"{t['library_ms_gy']:.4f}, "
                  f"{t['ms_gy'] / t['library_ms_gy']:.2f}x; earlier "
                  f"{t['earlier_ms_gy']:.4f}; bound "
                  f"{t['bound_ms_gy']:.4f})", flush=True)
            if record:
                records[(path, name)].update(
                    ms=t["ms"], plain_ms=device_ms(plain1, reps=20),
                    library_ms=t["library_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"])
        del sp, x0, outk, outp, s1, s2, s_nolam, o2

    def rescue_ghia(path, prec, name, rate, library):
        """:func:`rescue_checks` at the Ghia cavity's 128² (K == mx, every
        mode rescued, no Thomas launch), its errors into ``path``'s
        record."""
        grid_g = Grid.uniform(N_GHIA, N_GHIA)
        prob_g = PoissonProblem(N_GHIA, N_GHIA, 1, grid_g.dx0, grid_g.dy0)
        fxt_g, _, ysolve_g = make_dst2d_fused_pieces(
            prob_g, torch.float32, dev, precision=prec)
        if ysolve_g.rescue[2] != N_GHIA - 2:
            fail(f"the {N_GHIA}^2 rescue is {ysolve_g.rescue[2]} wide, "
                 f"not mx")
        bt_g = noisy(FlowField.initialize(grid_g, dtype=torch.float32,
                                          device=dev), SEED).p
        a_g = rolling.right_dot_plain(bt_g, fxt_g, prec)[0]
        rescue_checks(path, f"{N_GHIA}x{N_GHIA}", ysolve_g, a_g, prec,
                      name, rate, library, False)

    y2d_rec = {}     # the y-line kernel: its plan, device ms and chain

    def y2d_line(n_y, n_x):
        """A zero-shell (ny, nx) rhs from the seed, with the 2D pieces' μ
        (λx, its two spare modes edge-padded) and w = 1/dy² on the unit
        square."""
        prob = PoissonProblem(n_x, n_y, 1, 1.0 / (n_x - 1),
                              1.0 / (n_y - 1))
        lx = spectral._dirichlet_eigenvalues(n_x - 2, prob.inv_dx2)
        mu_ = torch.tensor(spectral._edge_padded(lx, n_x).astype(np.float32),
                           device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        r_ = torch.randn(n_y, n_x, generator=gen, device=dev)
        r_[0] = 0.0
        r_[-1] = 0.0
        return r_, mu_, float(prob.inv_dy2)

    def sm_clock_during(fn, seconds=2.5):
        """nvidia-smi's SM clock (MHz), read three times while ``fn`` runs
        back to back on the card (from a second thread); fails where the
        thread raised or nvidia-smi gave no reading."""
        stop = time.perf_counter() + seconds
        raised = []

        def busy():
            try:
                while time.perf_counter() < stop:
                    for _ in range(20):
                        fn()
                    sync()
            except BaseException as exc:  # re-raised after join
                raised.append(exc)

        worker = threading.Thread(target=busy)
        worker.start()
        time.sleep(0.2)
        reads = []
        for _ in range(3):
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits", "-i", "0"],
                capture_output=True, text=True, timeout=60).stdout
            reads += [float(v) for v in out.split() if v.isdigit()]
        worker.join()
        if raised:
            raise raised[0]
        if not reads:
            fail("phase 3: nvidia-smi read no SM clock beside the y-line "
                 "kernel")
        return reads

    def y2d_lines(tag, a, mu, w, timed, planes=None):
        """``tdma_y_2d`` in the d′ variant its plan picks at this shape,
        with the rec/t planes (the main path's ``planes``, else built
        here), against the plain version bit for bit, and the t plane
        against the plain sweep's t.  ``timed``: its device ms, the chain
        probe's cycles a row and the SM clock nvidia-smi reads beside the
        kernel, and its chain floor into the 2D record."""
        n_y, n_x = a.shape
        ref = tdma.tdma_y_2d_reference(a, mu, w)
        if planes is None:
            planes = tdma.tdma_y2d_planes(mu, w, n_y)
        t_sweep = tdma.tdma_z_fwd_reference(a[:, None, :], mu[None, :],
                                            w)[1][:, 0, :]
        sync()
        if not torch.equal(planes[1], t_sweep):
            fail(f"phase 3 {tag}: the t plane is not the sweep's t")
        del t_sweep
        plan = tdma.tdma_y2d_plan(n_y, n_x)
        rec = y2d_rec.setdefault(tag, {"plan": plan})

        def run():
            return tdma.tdma_y_2d(a, mu, w, planes=planes)

        got = run()
        sync()
        compare(f"phase 3 {tag}", f"tdma_y_2d[{plan['variant']}].x^", got,
                ref, *bit)
        del got
        if not timed:
            return
        rec["ms"] = device_ms(run, reps=20)
        chain = tdma.tdma_y2d_chain(float(mu[1]), w, dev)
        reads = sm_clock_during(run)
        clock = float(np.median(reads))
        rows = n_y - 2
        # the floor of the kernel (rec and t from the planes) and of a
        # forward sweep computing rec
        floor = {k: rows * (chain[f] + chain["bwd_cycles"]) / (clock * 1e3)
                 for k, f in (("chain_ms", "fwd_planes_cycles"),
                              ("chain_divide_ms", "fwd_cycles"))}
        rec.update(chain, smi_clocks_sm_mhz=reads, clock_mhz_used=clock,
                   **floor)
        records[("2d", "tdma_y_2d")]["chain_ms"] = floor["chain_ms"]
        print(f"phase 3 y-lines {tag}: device ms {rec['ms']:.4f}; plan "
              f"{plan}; SM cycles a row: forward "
              f"{chain['fwd_planes_cycles']:.2f} (rec from its plane), "
              f"{chain['fwd_cycles']:.2f} (rec computed), backward "
              f"{chain['bwd_cycles']:.2f} (the probe's clock "
              f"{chain['clock_mhz']:.0f} MHz); nvidia-smi clocks.sm beside "
              f"the kernel {reads} MHz; chain floor over {rows} rows at "
              f"{clock:.0f} MHz {floor['chain_ms']:.4f} ms "
              f"({floor['chain_divide_ms']:.4f} ms computing rec)",
              flush=True)

    # ---- phase 3: each kernel against its plain version ----------------------
    for shape in ((16, 64, 128), (N_BIG, N_BIG, N_BIG)):
        big = shape[0] == N_BIG
        tag = "x".join(map(str, shape[::-1]))
        print(f"phase 3 kernels vs plain at {tag} (nx×ny×nz)", flush=True)
        f, (fxt, fy, gxt, gy), mu, w, c = make_inputs(shape, SEED)
        dt = torch.full((), 1e-3, device=dev)
        scal = torch.stack([dt, torch.full((), 0.1, device=dev),
                            torch.full((), 0.05, device=dev)])
        rod = 1.0 / dt
        s = dt / 1.0
        cells = f.u.numel()
        nz_, ny_, nx_ = shape

        def dot_work(x, right, left):
            return ((x, right, left),
                    gemm_flops(nz_ * ny_, nx_, nx_)
                    + gemm_flops(ny_, nx_, ny_, nz_))

        def dot_library(x, right, left):
            # one call: left · x[k] · right on every plane
            return ieee_matmul(lambda: torch.einsum("ij,kjl,lm->kim", left,
                                                    x, right))

        us, vs, ws = check(
            "3d", tag, big, pkm.predictor_star, A1, SRC,
            lambda: pkm.predictor_star(f.u, f.v, f.w, scal, c),
            lambda: pkm.predictor_star_plain(f.u, f.v, f.w, scal, c),
            ("u*", "v*", "w*"), (fld,) * 3,
            work=((f.u, f.v, f.w, scal),
                  FLOPS_PER_POINT["predictor_star"] * cells))
        bt = check(
            "3d", tag, big, pkm.poisson_input, A1, SRC,
            lambda: pkm.poisson_input(us, vs, ws, f.p, rod, c),
            lambda: pkm.poisson_input_plain(us, vs, ws, f.p, rod, c),
            ("b~",), (exact,),
            work=((us, vs, ws, f.p), FLOPS_PER_POINT["poisson_input"]
                  * cells))[0]
        bhat = check(
            "3d", tag, big, rolling.plane_dot, DOT, SRC_SGEMM,
            lambda: rolling.plane_dot(bt, fxt, fy),
            lambda: rolling.plane_dot_plain(bt, fxt, fy),
            ("forward",), (gemm,), work=dot_work(bt, fxt, fy),
            library=dot_library(bt, fxt, fy))[0]
        d, t = check(
            "3d", tag, big, tdma.tdma_z_fwd, A1, SRC,
            lambda: tdma.tdma_z_fwd(bhat, mu, w),
            lambda: tdma.tdma_z_fwd_reference(bhat, mu, w),
            ("d'", "t"), (exact, exact),
            work=((bhat, mu), FLOPS_PER_POINT["tdma_fwd"] * cells))
        xhat = check(
            "3d", tag, big, tdma.tdma_z_bwd, A2, SRC,
            lambda: tdma.tdma_z_bwd(d, t),
            lambda: tdma.tdma_z_bwd_reference(d, t),
            ("x^",), (exact,),
            work=((d, t), FLOPS_PER_POINT["tdma_bwd"] * cells))[0]
        p = check(
            "3d", tag, big, rolling.plane_dot, DOT, SRC_SGEMM,
            lambda: rolling.plane_dot(xhat, gxt, gy),
            lambda: rolling.plane_dot_plain(xhat, gxt, gy),
            ("inverse",), (gemm,), work=dot_work(xhat, gxt, gy),
            library=dot_library(xhat, gxt, gy))[0]
        check("3d", tag, big, pkm.corrector, A2, SRC,
              lambda: pkm.corrector(us, vs, ws, p, s, c),
              lambda: pkm.corrector_plain(us, vs, ws, p, s, c),
              ("u", "v", "w", "max|u|^2", "max p", "max|p|"),
              (fld,) * 3 + ((TOL_DIAG, True), gemm, gemm),
              work=((us, vs, ws, p), FLOPS_PER_POINT["corrector"] * cells))

        # the two mega kernels as the step calls them
        kern = pkm.ProjectionKernels(*shape, c.dx, c.dy, c.dz, c.xmin,
                                     c.ymin, c.nu, (fxt, fy, gxt, gy),
                                     (mu, w))
        ref = pkm.ProjectionKernels(*shape, c.dx, c.dy, c.dz, c.xmin,
                                    c.ymin, c.nu, (fxt, fy, gxt, gy),
                                    (mu, w), plain=True)
        su, sv = scal[1], scal[2]
        a1k = kern.predictor_poisson_input(f.u, f.v, f.w, f.p, dt, su, sv,
                                           rod)
        a1p = ref.predictor_poisson_input(f.u, f.v, f.w, f.p, dt, su, sv,
                                          rod)
        sync()
        for o, gk, rk, tl in zip(("u*", "v*", "w*", "d'", "t"), a1k, a1p,
                                 (fld,) * 3 + (gemm, exact)):
            compare(tag, f"A1.{o}", gk, rk, *tl)
        a2k = kern.corrector_bwd_diag(*a1p, s)
        a2p = ref.corrector_bwd_diag(*a1p, s)
        sync()
        for o, gk, rk, tl in zip(
                ("u", "v", "w", "p", "max|u|^2", "max p", "max|p|"), a2k,
                a2p, (fld,) * 3 + (gemm, (TOL_DIAG, True), gemm, gemm)):
            compare(tag, f"A2.{o}", gk, rk, *tl)
        del f, us, vs, ws, bt, bhat, d, t, xhat, p, a1k, a1p, a2k, a2p
        torch.cuda.empty_cache()

    # ---- phase 3 (2D): each 2D kernel against its plain version -------------
    for ny, nx in ((32, 128), (N_2D, N_2D)):
        big = nx == N_2D
        tag = f"{nx}x{ny}"
        print(f"phase 3 2D kernels vs plain at {tag} (nx×ny)", flush=True)
        grid = Grid.uniform(nx, ny)
        f = noisy(FlowField.initialize(grid, dtype=torch.float32,
                                       device=dev), SEED)
        problem = PoissonProblem(nx, ny, 1, grid.dx0, grid.dy0)
        fxt, gxt, ysolve = make_dst2d_fused_pieces(problem, torch.float32,
                                                   dev)
        ysolve_plain = make_dst2d_fused_pieces(problem, torch.float32, dev,
                                               plain=True)[2]
        mu, w = ysolve.line
        c = pkm.StencilConsts(1, ny, nx, grid.dx0, grid.dy0, 0.0,
                              grid.xmin, grid.ymin, NSParams().mu, True)
        dt = torch.full((), 1e-3, device=dev)
        scal = torch.stack([dt, torch.full((), 0.1, device=dev),
                            torch.full((), 0.05, device=dev)])
        rod, s = 1.0 / dt, dt / 1.0
        cells = f.u.numel()

        us, vs, ws = check(
            "2d", tag, big, pk2m.predictor_star_2d, P2, SRC_2D,
            lambda: pk2m.predictor_star_2d(f.u, f.v, f.w, scal, c),
            lambda: pkm.predictor_star_plain(f.u, f.v, f.w, scal, c),
            ("u*", "v*", "w*"), (fld,) * 3,
            work=((f.u, f.v, f.w, scal),
                  FLOPS_PER_POINT["predictor_star"] * cells))
        bt = check(
            "2d", tag, big, pk2m.poisson_input_2d, P2, SRC_2D,
            lambda: pk2m.poisson_input_2d(us, vs, f.p, rod, c),
            lambda: pk2m.poisson_input_2d_plain(us, vs, f.p, rod, c),
            ("b~",), (exact,),
            work=((us, vs, f.p), FLOPS_PER_POINT["poisson_input"]
                  * cells))[0]
        bhat = check(
            "2d", tag, big, rolling.right_dot, DOT2, SRC_SGEMM,
            lambda: rolling.right_dot(bt, fxt),
            lambda: rolling.right_dot_plain(bt, fxt),
            ("forward",), (gemm,),
            work=((bt, fxt), gemm_flops(ny, fxt.shape[1], nx)),
            library=ieee_matmul(lambda: torch.matmul(bt, fxt)))[0]
        a = bhat[0]
        # the y-lines: both sweeps in one launch with the pieces' rec and
        # t planes (built here where the rescue takes every mode), bit for
        # bit; the bound counts what make_tdma_y_2d moves, r (and μ) read
        # and x written: the planes are the design's own bytes
        pl = ysolve.planes
        if pl is None:
            pl = tdma.tdma_y2d_planes(mu, w, a.shape[0])
        check("2d", tag, big, tdma.tdma_y_2d, TDMA2, SRC_TDMA2,
              lambda: tdma.tdma_y_2d(a, mu, w, planes=pl),
              lambda: tdma.tdma_y_2d_reference(a, mu, w),
              ("x^",), (bit,),
              work=((a, mu), FLOPS_PER_POINT["tdma_y2d"] * a.numel()),
              device_time=True, repeat=True)
        y2d_lines(tag, a, mu, w, big, pl)
        rescue_checks("2d", tag, ysolve, a, "highest", "rescue_dot",
                      FP32_FLOPS, ieee_matmul, big, timed=big)
        xk = ysolve(bhat)
        xp = ysolve_plain(bhat)
        sync()
        compare(tag, "ysolve.x^", xk, xp, *gemm)
        p = check(
            "2d", tag, big, rolling.right_dot, DOT2, SRC_SGEMM,
            lambda: rolling.right_dot(xp, gxt),
            lambda: rolling.right_dot_plain(xp, gxt),
            ("inverse",), (gemm,),
            work=((xp, gxt), gemm_flops(ny, gxt.shape[1], gxt.shape[0])),
            library=ieee_matmul(lambda: torch.matmul(xp, gxt)))[0]
        check("2d", tag, big, pk2m.corrector_2d, C2, SRC_2D,
              lambda: pk2m.corrector_2d(us, vs, p, s, c),
              lambda: pk2m.corrector_2d_plain(us, vs, p, s, c),
              ("u", "v"), (fld,) * 2,
              work=((us, vs, p), FLOPS_PER_POINT["corrector"] * cells))

        # the two fused kernels as the step calls them
        kern = pk2m.Projection2DKernels(ny, nx, c.dx, c.dy, c.xmin, c.ymin,
                                        c.nu, (fxt, gxt))
        ref = pk2m.Projection2DKernels(ny, nx, c.dx, c.dy, c.xmin, c.ymin,
                                       c.nu, (fxt, gxt), plain=True)
        su, sv = scal[1], scal[2]
        pk = kern.predictor_and_poisson_input(f.u, f.v, f.w, f.p, dt, su,
                                              sv, rod)
        pp = ref.predictor_and_poisson_input(f.u, f.v, f.w, f.p, dt, su,
                                             sv, rod)
        ck = kern.corrector(pp[0], pp[1], xp, s)
        cp = ref.corrector(pp[0], pp[1], xp, s)
        sync()
        for o, gk, rk, tl in zip(("u*", "v*", "w*", "b~FxT"), pk, pp,
                                 (fld,) * 3 + (gemm,)):
            compare(tag, f"pred_bt.{o}", gk, rk, *tl)
        for o, gk, rk, tl in zip(("u", "v", "p"), ck, cp, (fld,) * 2
                                 + (gemm,)):
            compare(tag, f"corr.{o}", gk, rk, *tl)
        del f, us, vs, ws, bt, bhat, a, xk
        del xp, p
        del pk, pp, ck, cp
        torch.cuda.empty_cache()
    rescue_ghia("2d", "highest", "rescue_dot", FP32_FLOPS, ieee_matmul)
    for n_y, n_x in Y2D_SHAPES:
        print(f"phase 3 y-lines at {n_x}x{n_y} (nx×ny)", flush=True)
        y2d_lines(f"{n_x}x{n_y}", *y2d_line(n_y, n_x), False)
    torch.cuda.empty_cache()

    # ---- phase 4: the 3D main path -----------------------------------------
    pkm.reset_launch_counts()
    step, (field, dt0, it0) = entry(device="cuda")
    field3, res3 = run_steps(step, field, dt0, 3, start_iter=it0)
    sync()
    print(f"phase 4 entry(device='cuda') 3 steps: status "
          f"{int(res3.status)}, max|u| {float(res3.max_velocity):.6f}, "
          f"max p {float(res3.max_pressure):.6f}", flush=True)
    if int(res3.status) != 0 or not bool(field3.is_finite()):
        fail("entry steps: nonzero status or non-finite fields")
    grid_e = Grid.uniform(128, 64, 16, zmin=0.0, zmax=1.0)
    plain_e = make_projection_step(grid_e, NSParams(), torch.float32,
                                   Method.FFT_DIRECT, device=dev, plain=True)
    field3p, res3p = run_steps(plain_e, field, dt0, 3, start_iter=it0)
    sync()
    for name in "uvw":
        compare("entry 3 steps", name, getattr(field3, name),
                getattr(field3p, name), TOL_FIELD, False)
    compare("entry 3 steps", "p", field3.p, field3p.p, TOL_GEMM, True)

    n = N_BIG
    grid = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                      mu=0.01)

    def tg_field(shape):
        """bench.py:41-60 — Taylor-Green-like velocity, p = 1, rho = 1,
        T = 300, on an (nz, ny, nx) grid (nz = 1 in 2D)."""
        nz, ny, nx = shape
        two_pi = 2.0 * torch.pi

        def lin(m):
            return torch.linspace(0.0, 1.0, m, dtype=torch.float32,
                                  device=dev)

        uu = (torch.sin(two_pi * lin(nx))[None, None, :]
              * torch.cos(two_pi * lin(ny))[None, :, None])
        if nz > 1:
            uu = uu * torch.cos(two_pi * lin(nz))[:, None, None]
        uu = uu.expand(shape).contiguous()
        return FlowField(u=uu, v=-uu, w=torch.zeros(shape, device=dev),
                         p=torch.ones(shape, device=dev),
                         rho=torch.ones(shape, device=dev),
                         T=torch.full(shape, 300.0, device=dev))

    def timed_paths(phase, size, grid, params, shape, dt, n_steps,
                    wrappers, first_step_only=False, precision=None,
                    field_fn=None, bc_refresh=None, tol_p=TOL_GEMM):
        """Kernel path, then plain path: the first ``n_steps`` steps from
        the start field, as ``bench.py:_time_steps`` times them, once to
        warm up and once timed.  Both runs have one call pattern (the
        caller holds the start field), so the caching allocator already
        holds every block the timed steps need — a cudaMalloc inside the
        timed window costs tens of ms at 512³.  Kernel and plain are held
        against each other after the timed steps, or with
        ``first_step_only`` after one step, p and what the corrector
        passes on to u and v at ``tol_p`` (the GEMMs' bar, or
        ``TOL_TF32_STEP`` for the one-pass TF32 products).
        ``precision`` is the step's ``spectral_precision``,
        ``bc_refresh`` its hook; ``field_fn(shape)`` makes the start field
        (``tg_field`` by default).  Returns (ms/step, launch counts)."""
        label = f"phase {phase} {size}"
        field_fn = field_fn or tg_field
        finals, firsts, ms, counts = {}, {}, {}, {}
        # a 2D step solves its y-lines in one tdma_y2d_kernel launch (its
        # 16-byte copies: nx is a multiple of 4) and launches no z-line
        # Thomas kernel
        two_d = shape[0] == 1
        if two_d:
            tdma.tdma_z_fwd.launches = tdma.tdma_z_bwd.launches = 0
            tdma.tdma_y_2d.copy4_launches = 0
        cells = 1
        for m in shape:
            cells *= m
        for path in ("kernel", "plain"):
            stepf = make_projection_step(grid, params, torch.float32,
                                         Method.FFT_DIRECT, device=dev,
                                         plain=path == "plain",
                                         spectral_precision=precision,
                                         bc_refresh=bc_refresh)
            if first_step_only:
                firsts[path] = stepf(field_fn(shape), dt, 0)[0]
            f0 = field_fn(shape)
            # where the paths are held after one step, the plain path's
            # steps only time it: PLAIN_TIMED_STEPS of them
            steps = n_steps if path == "kernel" or not first_step_only \
                else min(n_steps, PLAIN_TIMED_STEPS)
            run_steps(stepf, f0, dt, steps)
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f2, r2 = run_steps(stepf, f0, dt, steps)
            end.record()
            sync()
            ms[path] = start.elapsed_time(end) / steps
            peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            mlups = cells / (ms[path] * 1e-3) / 1e6
            finite, vmax, pmax, _ = field_status_and_diagnostics(f2)
            print(f"{label} {path} path: {ms[path]:.3f} ms/step, "
                  f"{mlups:.1f} MLUPS, peak device memory "
                  f"{peak_gib:.2f} GiB, status {int(r2.status)}, "
                  f"max|u| {float(r2.max_velocity):.6f} (full-field "
                  f"{float(vmax):.6f}), max p {float(r2.max_pressure):.6f} "
                  f"(full-field {float(pmax):.6f})", flush=True)
            if not bool(finite) or int(r2.status) != 0:
                fail(f"{label} {path} path: nonzero status or non-finite "
                     f"fields")
            if path == "kernel":
                counts = launches_of(wrappers)
                print(f"{label} launch counts over the main path: "
                      f"{counts}", flush=True)
                missing = [k for k, v in counts.items() if v <= 0]
                if missing:
                    fail(f"kernels not launched on the main path: "
                         f"{missing}")
                if two_d and (tdma.tdma_z_fwd.launches
                              or tdma.tdma_z_bwd.launches
                              or tdma.tdma_y_2d.copy4_launches):
                    fail(f"{label}: the 2D step launched the z-line "
                         f"Thomas kernels, or the y-line kernel through "
                         f"its 4-byte copies")
            finals[path] = f2
            del f0
            if path == "kernel" and do_profile:
                # same call pattern as the timed run: the caller holds
                # the start field, so the allocator already has every
                # block
                profile_steps(torch, label,
                              lambda: run_steps(stepf, f2, dt,
                                                PROFILED_STEPS,
                                                start_iter=n_steps),
                              PROFILED_STEPS)
        if not first_step_only:
            tag = f"{label} {n_steps} steps"
            for name in "uvw":
                compare(tag, name, getattr(finals["kernel"], name),
                        getattr(finals["plain"], name), TOL_FIELD, False)
            compare(tag, "p", finals["kernel"].p, finals["plain"].p,
                    tol_p, True)
            if params.energy_enabled:
                compare(tag, "T", finals["kernel"].T, finals["plain"].T,
                        TOL_EXACT, True)
            return ms, counts
        # u = u* − (dt/ρ)(p₊ − p₋)·inv_2dx passes a p difference within
        # the GEMMs' bar on to u and v, at most 2·dt·inv_2dx·TOL_GEMM·max|p|
        # (ρ = 1), and to w by inv_2dz in 3D; w is not corrected in 2D
        fk, fp = firsts["kernel"], firsts["plain"]
        pmax = float(fp.p.abs().max())

        def passed_on(d):
            return TOL_FIELD + 2.0 * dt / (2.0 * d) * tol_p * pmax

        tol_uv = passed_on(grid.dx0)
        tol_w = passed_on(grid.dz0) if shape[0] > 1 else TOL_FIELD
        tag = f"{label} first step"
        for name, tol in (("u", tol_uv), ("v", tol_uv), ("w", tol_w)):
            compare(tag, name, getattr(fk, name), getattr(fp, name), tol,
                    False)
        compare(tag, "p", fk.p, fp.p, tol_p, True)
        if params.energy_enabled:
            compare(tag, "T", fk.T, fp.T, TOL_EXACT, True)
        return ms, counts

    # the counters were set to 0 before the entry steps above
    ms3, counts3 = timed_paths(4, f"{n}^3", grid, params, (n, n, n), 1e-4,
                               TIMED_STEPS, pkm.WRAPPERS)
    no_element_loads(f"phase 4 {n}^3")
    torch.cuda.empty_cache()

    # ---- phase 6: the 2D main path (bench.py:run_2d(2048)) ------------------
    # This configuration is unstable: its diffusion number 8·ν·dt/dx² is
    # 3.35, past the explicit limit 2, so a grid-scale mode grows ~2.1× a
    # step (in the reference's float64 jnp step too) and meets the ±100
    # clamps near step 24.  The 20 timed steps come before the clamps;
    # kernel and plain are held against each other one step from the
    # start, before the growth amplifies their rounding differences.
    n2 = N_2D
    pk2m.reset_launch_counts()
    ms2, counts2 = timed_paths(6, f"{n2}^2", Grid.uniform(n2, n2), params,
                               (1, n2, n2), 1e-5, TIMED_STEPS_2D,
                               pk2m.WRAPPERS, first_step_only=True)
    no_element_loads(f"phase 6 {n2}^2")

    # ---- phase 7 (and 8): the lid-driven cavity against Ghia's table -------
    spec = importlib.util.spec_from_file_location("ghia_data", GHIA)
    ghia = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ghia)           # numpy only

    def ghia_gate(label, nc, re, dt, steps, bar, method=Method.FFT_DIRECT,
                  precision=None):
        """bench.py:615-702 on the kernel path: quiescent start, p = 0;
        each step first applies the lid (u = 1 on top), no-slip v and a
        Neumann p, then one projection step with the ``method`` pressure
        solve (its spectral products at ``precision``).  Status must be 0
        on every step (folded on the device, read once).  Returns the two
        centerline RMS errors."""
        gridc = Grid.uniform(nc, nc)
        stepc = make_projection_step(
            gridc, NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                            mu=1.0 / re),
            torch.float32, method, device=dev, spectral_precision=precision)
        lid, wall = DirichletValues(top=1.0), DirichletValues()
        fc = FlowField.quiescent(nc, nc, pressure=0.0, dtype=torch.float32,
                                 device=dev)
        worst = torch.zeros((), dtype=torch.int32, device=dev)
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            fc = fc.replace(u=apply_dirichlet_scalar(fc.u, lid),
                            v=apply_dirichlet_scalar(fc.v, wall),
                            p=apply_neumann_scalar(fc.p))
            fc, rc = stepc(fc, dt, i)
            worst = torch.maximum(worst, rc.status.abs())
        sync()
        ms_step = (time.perf_counter() - t0) * 1e3 / steps
        u = fc.u[0].double().cpu().numpy()
        v = fc.v[0].double().cpu().numpy()
        h = nc // 2
        if nc % 2 == 0:
            u_prof = 0.5 * (u[:, h - 1] + u[:, h])
            v_prof = 0.5 * (v[h - 1, :] + v[h, :])
        else:
            u_prof, v_prof = u[:, h], v[h, :]
        rms_u = ghia.profile_rms_error(gridc.y, u_prof, ghia.Y_COORDS,
                                       ghia.U_TABLES[re])
        rms_v = ghia.profile_rms_error(gridc.x, v_prof, ghia.X_COORDS,
                                       ghia.V_TABLES[re])
        print(f"{label} Ghia Re={re} {nc}^2 dt={dt} {Method(method).name} "
              f"{steps} steps: "
              f"rms_u {rms_u:.5f} rms_v {rms_v:.5f} (bar {bar}), worst "
              f"status {int(worst)}, {ms_step:.4f} ms/step host wall",
              flush=True)
        if int(worst) != 0:
            fail(f"Ghia Re={re}: a step returned a nonzero status")
        if not (rms_u < bar and rms_v < bar):
            fail(f"Ghia Re={re}: centerline RMS above {bar}")
        return rms_u, rms_v

    rms_highest = ghia_gate("phase 7", 128, 100, 5e-4, 20000, 0.10)
    if do_ghia1000:
        ghia_gate("phase 8", 512, 1000, 4e-4, 150000, 0.01)

    # ---- phase 9: the explicit kernels against their plain versions --------
    names6 = ("u", "v", "w", "p", "rho", "T")
    maxima4 = ("max|u|^2", "max p", "max|p|", "max T")

    def uniform_grid(shape):
        nz, ny, nx = shape
        if nz > 1:
            return Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)
        return Grid.uniform(nx, ny)

    for shape in ((11, 23, 37), (N_EXPL,) * 3, (1, 23, 37), (1, N_2D, N_2D)):
        nz, ny, nx = shape
        three_d = nz > 1
        big = nx in (N_EXPL, N_2D)
        tag = "x".join(map(str, shape[::-1] if three_d else shape[:0:-1]))
        print(f"phase 9 explicit kernels vs plain at {tag}", flush=True)
        grid = uniform_grid(shape)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def rnd(scale, shape=shape, gen=gen):
            return scale * torch.randn(shape, generator=gen, device=dev)

        f = FlowField.initialize(grid, dtype=torch.float32, device=dev)
        u = f.u + rnd(0.3)
        u[nz // 2, ny // 3, nx // 3] = 150.0     # the clamps
        rho = f.rho + rnd(0.01)
        rho[nz // 2, ny // 2, nx // 2] = 1e-12   # the per-point ρ guard
        f = FlowField(u=u, v=f.v + rnd(0.3), w=rnd(0.3), p=f.p + rnd(0.3),
                      rho=rho, T=f.T + rnd(1.0))
        c = ekm.ExplicitConsts(nz, ny, nx, grid.dx0, grid.dy0, grid.dz0,
                               0.01, 0.1)
        sy, sx = source_basis(grid, torch.float32, dev)
        cells = f.u.numel()

        ew = ekm.euler_step if three_d else e2m.euler2d_step
        ins = (f.u, f.v, f.w, f.p, f.T, f.rho, sy, sx,
               torch.tensor([1e-4, 0.08, 0.04], device=dev))
        check("euler3d" if three_d else "euler2d", tag, big, ew,
              E3 if three_d else E2, SRC_E, lambda: ew(*ins, c),
              lambda: ekm.euler_step_plain(*ins, c), names6 + maxima4,
              (exact,) * 10, work=(ins, FLOPS_PER_POINT["euler"] * cells))

        sw = rkm.rk_stage if three_d else rk2m.rk2d_stage
        q0 = (f.u, f.v, f.w, f.p)
        st = tuple(x + rnd(0.01) for x in q0)
        acc = tuple(rnd(5.0) for _ in range(4))
        # (stage, accumulator, final, factor, acc_mix, weight): RK4's
        # first and second stages and its final stage
        for label, a, final, fac, mix, wgt in (
                ("first", None, False, 5e-5, 0.0, 1.0),
                ("mid", acc, False, 5e-5, 0.0, 2.0),
                ("final", acc, True, 1e-4 / 6.0, 1.0, 0.0)):
            sc = torch.tensor([fac, mix, wgt, 0.08, 0.04], device=dev)
            read = (*st, *q0, f.rho, *(a or ()), sy, sx, sc) + (
                (f.T,) if final else ())
            outs = (names6 + maxima4 if final else
                    tuple(f"next {n}" for n in "uvwp")
                    + tuple(f"acc {n}" for n in "uvwp"))
            check("rk3d" if three_d else "rk2d", f"{tag} {label}",
                  big and label == "mid", sw, RK3 if three_d else RK2,
                  SRC_RK,
                  lambda: sw(st, q0, f.rho, f.T, a, sy, sx, sc, c, final),
                  lambda: rkm.rk_stage_plain(st, q0, f.rho, f.T, a, sy, sx,
                                             sc, c, final),
                  outs, (exact,) * len(outs),
                  work=(read, FLOPS_PER_POINT["rk_stage"] * cells))
        del f, u, rho, ins, q0, st, acc
        torch.cuda.empty_cache()

    # ---- phase 10: the explicit main paths (bench.py's configurations) ----
    makers = {"euler": make_euler_step, "rk2": make_rk2_step,
              "rk4": make_rk4_step}
    launch_counts = {"3d": counts3, "2d": counts2}
    explicit_ms = {}

    def explicit_path(method, shape, n_steps, path_key, wrapper,
                      params=None, field_fn=None, grid=None,
                      counter="launches", name=None, phase=None):
        """bench.py:run_euler_3d / run_euler_2d / run_rk_3d / run_rk_2d:
        the Taylor-Green field, sources off, ν = 0.01, dt = 1e-5, on the
        kernel path and the plain path — one step from the start, then
        ``n_steps`` once to warm up and once timed with CUDA events.
        Kernel and plain are held against each other after the first
        step and after the timed steps.  The launch counter is set to 0
        just before the kernel path and read just after it.  ``params``
        and ``field_fn(shape)`` replace the configuration and the start
        field: phase 33's thermal steps, keyed " thermal" and not
        profiled.  ``grid`` replaces the uniform grid (phase 37's
        stretched ones), whose kernels count on the wrapper's ``counter``
        and key the record ``name``."""
        thermal = params is not None and phase is None
        nz, ny, nx = shape
        grid = grid or uniform_grid(shape)
        name = name or wrapper.__name__
        params = params or NSParams(source_amplitude_u=0.0,
                                    source_amplitude_v=0.0, mu=0.01)
        field_fn = field_fn or tg_field
        size = f"{nx}^3" if nz > 1 else f"{nx}^2"
        phase = phase or (33 if thermal else 10)
        label = f"phase {phase} {method} {size}" + (
            f" {name}" if name != wrapper.__name__ else "")
        cells = nx * ny * nz
        firsts, finals, ms = {}, {}, {}
        for path in ("kernel", "plain"):
            if path == "kernel":
                setattr(wrapper, counter, 0)
            stepf = makers[method](grid, params, torch.float32, dev,
                                   plain=path == "plain")
            firsts[path] = stepf(field_fn(shape), EXPL_DT, 0)[0]
            f0 = field_fn(shape)
            run_steps(stepf, f0, EXPL_DT, n_steps)
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f2, r2 = run_steps(stepf, f0, EXPL_DT, n_steps)
            end.record()
            sync()
            ms[path] = start.elapsed_time(end) / n_steps
            peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            print(f"{label} {path} path: {ms[path]:.4f} ms/step, "
                  f"{cells / (ms[path] * 1e-3) / 1e6:.1f} MLUPS, peak "
                  f"device memory {peak_gib:.2f} GiB, status "
                  f"{int(r2.status)}, max|u| {float(r2.max_velocity):.6f}, "
                  f"max p {float(r2.max_pressure):.6f}", flush=True)
            if int(r2.status) != 0 or not bool(f2.is_finite()):
                fail(f"{label} {path} path: nonzero status or non-finite "
                     f"fields")
            if not float(r2.max_velocity) < 100.0:
                fail(f"{label} {path} path: max|u| reached the clamp")
            if path == "kernel":
                n_launch = getattr(wrapper, counter)
                print(f"{label} launch counts over the main path: "
                      f"{{'{name}': {n_launch}}} "
                      f"({n_launch / (2 * n_steps + 1):g} a step)",
                      flush=True)
                if n_launch <= 0:
                    fail(f"{name} not launched on the main path")
                counts = launch_counts.setdefault(path_key, {})
                counts[name] = counts.get(name, 0) + n_launch
                if do_profile and phase == 10:
                    profile_steps(torch, f"phase 5 {method} {size}",
                                  lambda: run_steps(stepf, f2, EXPL_DT,
                                                    PROFILED_STEPS,
                                                    start_iter=n_steps),
                                  PROFILED_STEPS)
            finals[path] = f2
            del f0
        for field_name in names6:
            compare(f"{label} first step", field_name,
                    getattr(firsts["kernel"], field_name),
                    getattr(firsts["plain"], field_name), TOL_EXACT, True)
        # 2048² is past the explicit viscous limit (8·ν·dt/dx² = 3.35): a
        # grid-scale mode grows until the ±1000 second-derivative clamps
        # hold it, and it would amplify any rounding difference, so after
        # the timed steps the bar there is looser (1e-3 of max|ref|)
        tol_n = TOL_EXACT if nz > 1 else 1e-3
        for field_name in names6:
            compare(f"{label} {n_steps + 1} steps", field_name,
                    getattr(finals["kernel"], field_name),
                    getattr(finals["plain"], field_name), tol_n, True)
        explicit_ms[f"{method} {size}" + (" thermal" if thermal
                                          else "")
                    + (f" {name}" if name != wrapper.__name__ else "")] = ms

    n3, n2e = (N_EXPL,) * 3, (1, N_2D, N_2D)
    explicit_path("euler", n3, 10, "euler3d", ekm.euler_step)
    explicit_path("euler", n2e, 20, "euler2d", e2m.euler2d_step)
    for order in ("rk2", "rk4"):
        explicit_path(order, n3, 10, "rk3d", rkm.rk_stage)
        explicit_path(order, n2e, 10, "rk2d", rk2m.rk2d_stage)
    torch.cuda.empty_cache()

    # ---- phase 11: the facade (Simulation.create, default solver) ---------
    e2m.euler2d_step.launches = 0
    sim = Simulation.create(100, 50, device=dev)
    start_field = sim.field
    sync()
    t0 = time.perf_counter()
    for _ in range(FACADE_STEPS):
        status = sim.step()
        if status != 0:
            fail(f"phase 11 facade: step returned status {int(status)}")
    wall_ms = (time.perf_counter() - t0) * 1e3
    n_launch = e2m.euler2d_step.launches
    stats = sim.get_stats()
    print(f"phase 11 Simulation.create(100, 50) solver "
          f"{sim.solver.name}: {FACADE_STEPS} step()s in {wall_ms:.1f} ms "
          f"host wall ({wall_ms / FACADE_STEPS:.4f} ms a step, each "
          f"waiting for the card), time {sim.current_time:.4f}, max|u| "
          f"{stats.max_velocity:.6f}, max p {stats.max_pressure:.6f}, "
          f"euler2d_step launches {n_launch}", flush=True)
    if sim.solver.name != "explicit_euler" or n_launch != FACADE_STEPS:
        fail("phase 11 facade: not the fused Euler kernel once a step")
    launch_counts["facade"] = {"euler2d_step": n_launch}
    plain_step = make_euler_step(sim.grid, sim.params, torch.float32, dev,
                                 plain=True)
    fp = start_field
    for _ in range(FACADE_STEPS):
        fp, rp = plain_step(fp, 0.005, 0)      # Simulation.step's dt, iter
    sync()
    for name in names6:
        compare(f"phase 11 facade {FACADE_STEPS} steps", name,
                getattr(sim.field, name), getattr(fp, name), TOL_EXACT,
                True)

    # ---- phase 12: the CG kernels against their plain versions ------------
    dot = (TOL_DOT, True)

    def cg_problem(shape):
        nz, ny, nx = shape
        grid = uniform_grid(shape)
        return grid, PoissonProblem(nx, ny, nz, grid.dx0, grid.dy0,
                                    grid.dz0)

    for shape in ((11, 23, 37), (N_BIG,) * 3):
        big = shape[0] == N_BIG
        tag = "x".join(map(str, shape[::-1]))
        print(f"phase 12 CG kernels vs plain at {tag}", flush=True)
        grid, prob = cg_problem(shape)
        c = cgk.CGConsts(*shape, prob.inv_dx2, prob.inv_dy2, prob.inv_dz2)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        r, p, x = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
        beta = torch.full((), 0.37, device=dev)
        alpha = torch.full((), 0.61, device=dev)
        cells = r.numel()
        # timed as the solve launches them: in place on the solver's
        # buffers, scalars in a running state that never stops
        passes = cgk.CGPasses(c, dev)
        one = torch.ones((), device=dev)
        st = cgk.new_state(one, one, 0 * one, 0 * one, one > 0)
        st[cgk.BETA], st[cgk.ALPHA] = beta, alpha
        pn_t, ap_t = torch.empty_like(r), torch.empty_like(r)
        pn, ap, _ = check(
            "cg3d", tag, big, cgk.lap_dot, LAP_DOT, SRC_CG,
            lambda: cgk.lap_dot(r, p, beta, c),
            lambda: cgk.lap_dot_plain(r, p, beta, c),
            ("p'", "Ap'", "<p',Ap'>"), (exact, exact, dot),
            work=((r, p), FLOPS_PER_POINT["lap_dot"] * cells),
            time_fn=lambda: passes.lap_dot(r, p, pn_t, ap_t, st))
        x_t, r_t = x.clone(), r.clone()
        check("cg3d", tag, big, cgk.cg_update, CG_UPD, SRC_CG,
              lambda: cgk.cg_update(x, r, pn, ap, alpha, c),
              lambda: cgk.cg_update_plain(x, r, pn, ap, alpha, c),
              ("x'", "r'", "<r',r'>"), (exact, exact, dot),
              work=((x, r, pn, ap), FLOPS_PER_POINT["cg_update"] * cells),
              time_fn=lambda: passes.update(x_t, r_t, pn, ap, st))
        del pn, ap, pn_t, ap_t, x_t, r_t
        # A1's rhs form and the non-DST corr_all on the CG step's path
        sc = pkm.StencilConsts(*shape, grid.dx0, grid.dy0, grid.dz0,
                               grid.xmin, grid.ymin, 0.01, False)
        rod, s = torch.full((), 1e4, device=dev), torch.full((), 1e-4,
                                                               device=dev)
        check("cg3d", tag, big, pkm.poisson_rhs, A1_RHS, SRC,
              lambda: pkm.poisson_rhs(r, p, x, rod, sc),
              lambda: pkm.poisson_rhs_plain(r, p, x, rod, sc),
              ("rhs",), (exact,),
              work=((r, p, x), FLOPS_PER_POINT["poisson_rhs"] * cells))
        check("cg3d", tag, big, pkm.corrector, A5_CORR, SRC,
              lambda: pkm.corrector(r, p, x, r, s, sc),
              lambda: pkm.corrector_plain(r, p, x, r, s, sc),
              ("u", "v", "w", "max|u|^2", "max p", "max|p|"),
              (fld,) * 3 + ((TOL_DIAG, True),) * 3,
              work=((r, p, x, r), FLOPS_PER_POINT["corrector"] * cells))
        del r, p, x
        torch.cuda.empty_cache()

    for shape in ((1, 23, 37), (1, 50, 100)):
        tag = f"{shape[2]}x{shape[1]}"
        grid, _ = cg_problem(shape)
        sc = pkm.StencilConsts(*shape, grid.dx0, grid.dy0, 0.0, grid.xmin,
                               grid.ymin, 0.01, False)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        us, vs = (torch.randn(shape, generator=gen, device=dev)
                  for _ in range(2))
        rod = torch.full((), 200.0, device=dev)
        check("cg2d", tag, shape[2] == 100, pk2m.poisson_rhs_2d, P2_RHS,
              SRC_2D, lambda: pk2m.poisson_rhs_2d(us, vs, rod, sc),
              lambda: pk2m.poisson_rhs_2d_plain(us, vs, rod, sc),
              ("rhs",), (exact,),
              work=((us, vs), FLOPS_PER_POINT["poisson_rhs"] * us.numel()))

    # K3 in the form its plan names (vmem_small.krylov_cluster_plan): the
    # cluster kernel (K3c) at every plane of CLUSTER_PLANES, bit for bit
    # against its order model (x, r0, res, iterations, running) and two
    # launches bit-identical, each form device-timed there; then both
    # forms against make_cg (the reference's jnp loop as plain tensor
    # code), random right-hand side from seed 0, tolerance 1e-5: ±2
    # iterations, x within TOL_DOT — K3c at 100² (CG and Jacobi PCG) and
    # 512², the grid-wide K3 at GRID_SHAPES
    barrier_ns = {}     # (kind, blocks, threads) -> the probe's ns a barrier

    def barrier_floor(kind, blocks, threads):
        key = (kind, blocks, threads)
        if key not in barrier_ns:
            barrier_ns[key] = vmem_small.barrier_probe(kind, blocks,
                                                       threads, dev)["ns"]
        return barrier_ns[key]

    def grid_blocks(kind, shape):
        lib = native.library()
        return (lib.cfd_cg_solve_blocks if kind == "cg" else
                lib.cfd_bicg_solve_blocks)(*shape)

    cluster_solves = {}     # "<kind> <tag>" -> the forms' numbers

    def hold_cluster(label, kind, c, x0, rhs, tol, max_iter):
        """The wrapper at a plane its plan sends to the cluster kernel:
        bit for bit against the order model and two launches
        bit-identical; the device ms of the cluster and grid-wide forms
        on the same input, and the barrier floors (the cluster kernels'
        dot at the plan's cluster, grid.sync() at the grid-wide kernel's
        grid)."""
        cg_kind = kind == "cg"
        plan = vmem_small.krylov_cluster_plan(c.nz, c.ny, c.nx, kind)
        if plan["form"] != "cluster":
            fail(f"{label}: the {kind} plan of {c.shape} is not a cluster")
        wrap, model, grid_form = (
            (vmem_small.cg_solve, vmem_small.cg_solve_cluster_ordered,
             vmem_small.cg_solve_grid) if cg_kind else
            (vmem_small.bicgstab_solve,
             vmem_small.bicgstab_solve_cluster_ordered,
             vmem_small.bicgstab_solve_grid))
        args = (x0, rhs, c, tol, 0.0, max_iter)
        got, again, ref = wrap(*args), wrap(*args), model(*args)
        sync()
        names = ("x", "r0", "res", "iterations",
                 "running" if cg_kind else "stagnated")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        equal = {n: bool(torch.equal(a, b))
                 for n, a, b in zip(names, got, ref)}
        n_it = max(int(got[3]), 1)
        ms_c, ms_g = device_ms(lambda: wrap(*args)), \
            device_ms(lambda: grid_form(*args))
        nblk = grid_blocks(kind, c.shape)
        dot_ns = barrier_floor("dot", plan["cluster"], plan["threads"])
        sync_ns = barrier_floor("cluster", plan["cluster"], plan["threads"])
        grid_ns = barrier_floor("grid", nblk, 256)
        row = {"cluster": plan["cluster"], "threads": plan["threads"],
               "resident": list(plan["resident"]),
               "iterations": int(got[3]), "ms": ms_c, "grid_ms": ms_g,
               "us_per_iteration": ms_c / n_it * 1e3,
               "grid_us_per_iteration": ms_g / n_it * 1e3,
               "dot_ns": dot_ns, "cluster_sync_ns": sync_ns,
               "grid_blocks": nblk, "grid_sync_ns": grid_ns}
        cluster_solves[f"{kind} {label.split()[-1]}"] = row
        print(f"  {label} {kind}: plan {plan['cluster']} CTAs x "
              f"{plan['threads']} threads, {plan['rows']} rows a rank, "
              f"resident {plan['resident']}, in device memory "
              f"{plan['device']}; against its order model {equal}; two "
              f"launches bit-identical {same}; {int(got[3])} iterations: "
              f"cluster {ms_c:.4f} ms ({row['us_per_iteration']:.3f} us "
              f"an iteration), grid-wide {ms_g:.4f} ms "
              f"({row['grid_us_per_iteration']:.3f} us); the dot "
              f"{dot_ns:.1f} ns, cluster.sync() {sync_ns:.1f} ns at "
              f"{plan['cluster']} CTAs, grid.sync() {grid_ns:.1f} ns at "
              f"{nblk} blocks", flush=True)
        if not same or not all(equal.values()):
            fail(f"{label}: the cluster {kind} solve is not its order "
                 f"model bit for bit, or two launches differ")
        return plan, row

    for shape in CLUSTER_PLANES:
        tag = f"{shape[2]}x{shape[1]}"
        _, prob = cg_problem(shape)
        c = cgk.CGConsts(*shape, prob.inv_dx2, prob.inv_dy2, prob.inv_dz2)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        rhs = torch.randn(shape, generator=gen, device=dev)
        hold_cluster(f"phase 12 K3c {tag}", "cg", c, torch.zeros_like(rhs),
                     rhs, 1e-5, 2000)

    def cg_results_agree(tag, got, ref):
        it, it_ref = int(got.iterations), int(ref.iterations)
        st, st_ref = int(got.status), int(ref.status)
        print(f"  {tag}: iterations {it} vs {it_ref}, status {st} vs "
              f"{st_ref}, residual {float(got.final_residual):.4e} vs "
              f"{float(ref.final_residual):.4e}", flush=True)
        if abs(it - it_ref) > 2 or st != st_ref:
            fail(f"{tag}: iterations or status differ")
        return compare(tag, "x", got.x, ref.x, TOL_DOT, True)

    def solve_record(path, name, replaces, source, err_rel=(0.0, 0.0)):
        """The record of a whole solve, its errors the largest yet."""
        rec = records.setdefault((path, name), {
            "replaces": replaces, "source": source, "max_abs_err": 0.0,
            "max_rel_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err_rel[0])
        rec["max_rel_err"] = max(rec["max_rel_err"], err_rel[1])
        return rec

    for shape, pc in (((1, 100, 100), Precond.NONE),
                      ((1, 100, 100), Precond.JACOBI),
                      ((1, 512, 512), Precond.NONE),
                      ((9, 17, 33), Precond.NONE),
                      ((1, 700, 700), Precond.NONE)):
        big = shape[1] == 512
        plan = vmem_small.krylov_cluster_plan(*shape, "cg")
        name = "cg_solve[cluster]" if plan["form"] == "cluster" else \
            "cg_solve"
        if (shape in GRID_SHAPES) != (plan["form"] == "grid"):
            fail(f"phase 12: the CG plan of {shape} is {plan['form']}")
        tag = "x".join(map(str, shape[::-1])) + f" {pc.name}"
        print(f"phase 12 {name} vs make_cg at {tag}", flush=True)
        _, prob = cg_problem(shape)
        pp = PoissonParams(tolerance=1e-5, preconditioner=pc)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        rhs = torch.randn(shape, generator=gen, device=dev)
        x0 = torch.zeros_like(rhs)
        counts0 = (vmem_small.cg_solve.launches,
                   vmem_small.cg_solve.cluster_launches)
        got = krylov.make_cg_vmem(prob, pp, device=dev)(x0, rhs)
        ran = (vmem_small.cg_solve.launches - counts0[0],
               vmem_small.cg_solve.cluster_launches - counts0[1])
        if ran != ((0, 1) if plan["form"] == "cluster" else (1, 0)):
            fail(f"phase 12 {tag}: not the plan's form {ran}")
        ref = krylov.make_cg(prob, pp)(x0, rhs)
        solve_record("cg2d", name, CG_VMEM, SRC_CG,
                     cg_results_agree(f"{tag} {name}", got, ref))
        n_it = int(got.iterations)
        c = cgk.CGConsts(*shape, prob.inv_dx2, prob.inv_dy2, prob.inv_dz2,
                         1.0, pp.check_interval)
        args = (x0, rhs, c, pp.tolerance, pp.absolute_tolerance,
                pp.max_iterations)
        if not big:
            if plan["form"] == "grid":
                ms_g = device_ms(lambda: vmem_small.cg_solve_grid(*args))
                print(f"  {tag} cg_solve (grid-wide): {ms_g:.4f} ms, "
                      f"{ms_g / max(n_it, 1) * 1e3:.3f} us an iteration",
                      flush=True)
            continue
        # both forms' records at 512², on this input: device ms, the
        # plain path's, the bound, the barrier floor (iterations x
        # barriers an iteration x the probe's latency)
        n_interior = (shape[1] - 2) * (shape[2] - 2)
        plain_ms = cuda_ms(lambda: krylov.make_cg_vmem(
            prob, pp, device=dev, plain=True)(x0, rhs), reps=1)
        bnd = bound(nbytes((x0, rhs, got.x)),
                    n_it * FLOPS_PER_POINT["cg_iter"] * n_interior)
        nblk = grid_blocks("cg", shape)
        floors = {"cg_solve[cluster]": 2 * barrier_floor(
            "dot", plan["cluster"], plan["threads"]),
                  "cg_solve": 3 * barrier_floor("grid", nblk, 256)}
        for nm, fn in (("cg_solve[cluster]", vmem_small.cg_solve_cluster),
                       ("cg_solve", vmem_small.cg_solve_grid)):
            r2 = solve_record("cg2d", nm, CG_VMEM, SRC_CG)
            r2["ms"] = device_ms(lambda: fn(*args))
            r2["plain_ms"], r2["library_ms"] = plain_ms, None
            r2["bound_ms"], r2["bound_by"] = bnd
            r2["barrier_ms"] = n_it * floors[nm] * 1e-6
            print(f"  {tag} {nm}: {r2['ms']:.3f} ms a solve "
                  f"({r2['ms'] / n_it * 1e3:.2f} us an iteration), plain "
                  f"{plain_ms:.3f} ms, bound {r2['bound_ms']:.4f} ms "
                  f"({r2['bound_by']}), barrier floor "
                  f"{r2['barrier_ms']:.4f} ms", flush=True)

    # ---- phase 13: the 512³ CG Poisson solve (bench.py's cg_512) -------
    n = N_BIG
    _, prob = cg_problem((n, n, n))
    pp = PoissonParams(tolerance=1e-6, max_iterations=2000,
                       check_interval=10)
    gen = torch.Generator(device=dev).manual_seed(7)
    rhs = prob.zero_boundary(torch.randn((n, n, n), generator=gen,
                                         device=dev))
    x0 = torch.zeros_like(rhs)
    solve = krylov.make_cg_fused(prob, pp, device=dev)
    solve(x0, rhs)                              # warm-up, same pattern
    sync()
    cgk.lap_dot.launches = cgk.cg_update.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = solve(x0, rhs)
    end.record()
    sync()
    ms_solve = start.elapsed_time(end)
    n_it, syncs = int(res.iterations), solve.host_syncs
    # the true residual of the system the loop solved (its shell is the
    # start's, zero), in float64
    xd, rd = prob.zero_boundary(res.x.double()), rhs.double()
    true_rel = float(prob.interior(prob.laplacian(xd) - rd).norm()
                     / prob.interior(rd).norm())
    del xd, rd
    print(f"phase 13 cg_512 (512^3, tol 1e-6, check_interval 10): "
          f"{n_it} iterations, status {int(res.status)}, {ms_solve:.1f} ms "
          f"a solve, {ms_solve / n_it:.4f} ms an iteration, {syncs} host "
          f"syncs (bar {-(-n_it // krylov.CHUNK) + 2}), recursion residual "
          f"{float(res.final_residual):.4e} of {float(res.initial_residual):.4e}"
          f", true relative residual {true_rel:.4e}; lap_dot "
          f"{cgk.lap_dot.launches} and cg_update {cgk.cg_update.launches} "
          f"launches", flush=True)
    if int(res.status) != PoissonStatus.CONVERGED or not true_rel <= 1e-3:
        fail("cg_512: not converged, or true residual above 1e-3")
    if abs(n_it - CG_512_ITERS) > 0.1 * CG_512_ITERS:
        fail(f"cg_512: {n_it} iterations, outside {CG_512_ITERS} ± 10%")
    if syncs > -(-n_it // krylov.CHUNK) + 2:
        fail("cg_512: more host syncs than one a chunk")
    # a fixed budget of 20 iterations, kernel path against plain path
    pp20 = PoissonParams(tolerance=0.0, max_iterations=20,
                         check_interval=10)
    fixed = {}
    for path in ("kernel", "plain"):
        fs = krylov.make_cg_fused(prob, pp20, device=dev,
                                  plain=path == "plain")
        fixed[path] = fs(x0, rhs)
        fixed[path + "_ms"] = cuda_ms(lambda: fs(x0, rhs), reps=1)
    print(f"phase 13 cg_512, 20 iterations: kernel "
          f"{fixed['kernel_ms'] / 20:.4f} ms, plain "
          f"{fixed['plain_ms'] / 20:.4f} ms an iteration", flush=True)
    for name in ("iterations", "status"):
        if int(getattr(fixed["kernel"], name)) != int(
                getattr(fixed["plain"], name)):
            fail(f"cg_512 20 iterations: {name} differs")
    compare("cg_512 20 iterations", "x", fixed["kernel"].x,
            fixed["plain"].x, TOL_DOT, True)
    compare("cg_512 20 iterations", "residual",
            fixed["kernel"].final_residual, fixed["plain"].final_residual,
            TOL_DOT, True)
    cg512 = {"iterations": n_it, "ms": ms_solve, "host_syncs": syncs,
             "true_rel_residual": true_rel}
    del rhs, x0, res, fixed, solve
    torch.cuda.empty_cache()

    # ---- phase 14: the 3D CG projection step at 256³ ---------------------
    def close_p(tag, got, ref):
        """p within rtol 1e-3 / atol 1e-4·max|p|."""
        got, ref = got.double(), ref.double()
        scale = float(ref.abs().max())
        excess = float(((got - ref).abs() - 1e-3 * ref.abs()).max())
        print(f"  {tag} p: max_abs={float((got - ref).abs().max()):.3e} "
              f"excess over rtol 1e-3 {excess:.3e}, atol bar "
              f"{1e-4 * scale:.3e}", flush=True)
        if not excess <= 1e-4 * scale:
            fail(f"{tag} p: beyond rtol 1e-3 / atol 1e-4·max|p|")

    shape = (N_CG,) * 3
    grid_cg = uniform_grid(shape)
    params_cg = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                         mu=0.01)
    finals, cg_ms = {}, {}
    for path in ("kernel", "plain"):
        stepf = make_projection_step(grid_cg, params_cg, torch.float32,
                                     device=dev, plain=path == "plain")
        f0 = tg_field(shape)
        run_steps(stepf, f0, 1e-4, CG_STEPS)
        sync()
        if path == "kernel":
            pkm.reset_launch_counts()
            cgk.lap_dot.launches = cgk.cg_update.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        f, its, worst = f0, [], 0
        for i in range(CG_STEPS):
            f, r = stepf(f, 1e-4, i)
            its.append(stepf.last_poisson.iterations)
            worst = torch.maximum(torch.as_tensor(worst, device=dev),
                                  r.status.abs())
        end.record()
        sync()
        cg_ms[path] = start.elapsed_time(end) / CG_STEPS
        its = [int(t) for t in its]
        print(f"phase 14 CG step 256^3 {path} path: {cg_ms[path]:.3f} "
              f"ms/step, {N_CG ** 3 / (cg_ms[path] * 1e-3) / 1e6:.1f} "
              f"MLUPS, CG iterations a step {its}, "
              f"{cg_ms[path] / (sum(its) / CG_STEPS):.4f} ms an iteration, "
              f"host syncs of the last solve "
              f"{stepf.poisson_solve.host_syncs}, worst status "
              f"{int(worst)}, max|u| {float(r.max_velocity):.6f}",
              flush=True)
        if int(worst) != 0 or not bool(f.is_finite()):
            fail(f"phase 14 {path} path: nonzero status or non-finite")
        if path == "kernel":
            counts = {fn.__name__: fn.launches for fn in
                      pkm.WRAPPERS_RHS + cgk.WRAPPERS}
            print(f"phase 14 launch counts over the main path: {counts}",
                  flush=True)
            if any(v <= 0 for v in counts.values()):
                fail(f"phase 14: kernels not launched: {counts}")
            launch_counts["cg3d"] = counts
        finals[path] = f
        del f0
    for name in "uvw":
        compare(f"phase 14 {CG_STEPS} steps", name,
                getattr(finals["kernel"], name),
                getattr(finals["plain"], name), TOL_CG_UVW, False)
    close_p(f"phase 14 {CG_STEPS} steps", finals["kernel"].p,
            finals["plain"].p)
    del finals
    torch.cuda.empty_cache()

    # ---- phase 15: the facade with the reference's default projection ---
    pk2m.reset_launch_counts()
    vmem_small.cg_solve.launches = vmem_small.cg_solve.cluster_launches = 0
    sim = Simulation.create(100, 50, solver_type="projection", device=dev)
    start_field, checked, clamped = sim.field, None, None
    sync()
    t0 = time.perf_counter()
    for i in range(FACADE_STEPS):
        status = sim.step()
        if status != 0:
            fail(f"phase 15 facade: step returned status {int(status)}")
        if i + 1 == FACADE_CHECK:
            checked = sim.field
        if clamped is None and sim.get_stats().max_velocity >= 100.0:
            clamped = i + 1
    wall_cg = (time.perf_counter() - t0) * 1e3
    n_launch = vmem_small.cg_solve.cluster_launches
    stats = sim.get_stats()
    print(f"phase 15 Simulation.create(100, 50, solver_type='projection'): "
          f"{FACADE_STEPS} step()s in {wall_cg:.1f} ms host wall "
          f"({wall_cg / FACADE_STEPS:.4f} ms a step, each waiting for the "
          f"card), last CG iterations "
          f"{int(sim.solver._step_fn.last_poisson.iterations)}, max|u| "
          f"{stats.max_velocity:.6f} (the ±100 clamps reached at step "
          f"{clamped}), max p {stats.max_pressure:.6f}, cg_solve cluster "
          f"launches {n_launch}, grid-wide {vmem_small.cg_solve.launches}",
          flush=True)
    if n_launch != FACADE_STEPS or vmem_small.cg_solve.launches:
        fail("phase 15 facade: not the cluster CG kernel once a step")
    launch_counts["cg2d"] = {"cg_solve[cluster]": n_launch,
                             "poisson_rhs_2d": pk2m.poisson_rhs_2d.launches}
    plain_cg = make_projection_step(sim.grid, sim.params, torch.float32,
                                    Method.CG, device=dev, plain=True)
    fp = start_field
    for _ in range(FACADE_CHECK):
        fp, rp = plain_cg(fp, 0.005, 0)        # Simulation.step's dt, iter
    sync()
    for name in "uv":
        compare(f"phase 15 facade {FACADE_CHECK} steps", name,
                getattr(checked, name), getattr(fp, name), TOL_CG_UVW,
                False)
    close_p(f"phase 15 facade {FACADE_CHECK} steps", checked.p, fp.p)

    # ---- phase 16: Ghia Re = 100 through the CG pressure solve -----------
    def solve_forms(wrapper, label, steps, form):
        """Fail unless the main path just run launched the whole solve
        once a step in the plan's ``form``, and no other; returns the
        count."""
        counts = {"cluster": wrapper.cluster_launches,
                  "grid": wrapper.launches}
        print(f"{label} {wrapper.__name__} launches: cluster "
              f"{counts['cluster']}, grid-wide {counts['grid']}", flush=True)
        if counts[form] != steps or sum(counts.values()) != steps:
            fail(f"{label}: not the {form} form once a step {counts}")
        return steps

    def grid_cavity(label, method, wrapper):
        """GRID_CAVITY_STEPS lid-cavity steps at N_GRID_CAVITY², a plane
        past one cluster's shared memory, the solve at tolerance 1e-4:
        the main path through the grid-wide whole solve (status 0,
        finite)."""
        n = N_GRID_CAVITY
        if vmem_small.krylov_cluster_plan(
                1, n, n, "cg" if method == Method.CG else
                "bicgstab")["form"] != "grid":
            fail(f"{label}: {n}^2 is not the grid-wide form")
        stepc = make_projection_step(
            Grid.uniform(n, n), NSParams(source_amplitude_u=0.0,
                                         source_amplitude_v=0.0,
                                         mu=1.0 / 100),
            torch.float32, method,
            poisson_params=PoissonParams(tolerance=1e-4), device=dev)
        lid, wall = DirichletValues(top=1.0), DirichletValues()
        fc = FlowField.quiescent(n, n, pressure=0.0, dtype=torch.float32,
                                 device=dev)
        wrapper.launches = wrapper.cluster_launches = 0
        for i in range(GRID_CAVITY_STEPS):
            sync()
            t0 = time.perf_counter()
            fc = fc.replace(u=apply_dirichlet_scalar(fc.u, lid),
                            v=apply_dirichlet_scalar(fc.v, wall),
                            p=apply_neumann_scalar(fc.p))
            fc, rc = stepc(fc, 5e-4, i)
            status = int(rc.status)
            print(f"{label} {n}^2 cavity step {i}: "
                  f"{(time.perf_counter() - t0) * 1e3:.3f} ms host wall, "
                  f"{int(stepc.last_poisson.iterations)} iterations, status "
                  f"{status}", flush=True)
            if status != 0:
                fail(f"{label}: status {status}")
        if not bool(fc.is_finite()):
            fail(f"{label}: non-finite field")
        return solve_forms(wrapper, label, GRID_CAVITY_STEPS, "grid")

    vmem_small.cg_solve.launches = vmem_small.cg_solve.cluster_launches = 0
    ghia_gate("phase 16", 128, 100, 5e-4, GHIA_SOLVER_STEPS, 0.10, Method.CG)
    launch_counts["cg2d"]["cg_solve[cluster]"] += solve_forms(
        vmem_small.cg_solve, "phase 16", GHIA_SOLVER_STEPS, "cluster")
    launch_counts["cg2d"]["cg_solve"] = grid_cavity(
        "phase 16 grid-wide", Method.CG, vmem_small.cg_solve)

    # ---- phase 17: the multigrid kernels against their plain versions ----
    def mg_levels(shape):
        return mgs._build_levels(cg_problem(shape)[1])

    def interior(shape):
        """The points a sweep or a residual updates."""
        n = 1
        for s in shape:
            n *= max(s - 2, 1)
        return n

    def vcycle_flops_2d(levels, pre, post):
        """One 2D V-cycle's float32 operations on the interior points
        (counted from mg_solve.cu)."""
        fpp = FLOPS_PER_POINT
        f = mgk.COARSE_SWEEPS * fpp["mg2d_sweep"] * interior(
            levels[-1].shape)
        for lv, coarse in zip(levels, levels[1:]):
            f += ((pre + post) * fpp["mg2d_sweep"] + fpp["mg2d_residual"]
                  + fpp["mg2d_prolong"]) * interior(lv.shape)
            f += fpp["mg2d_restrict"] * interior(coarse.shape)
        return f

    # the record keeps the last variant timed: the red-first sweep
    variants = (("red", True), ("black", False), ("red", False))
    for shape in ((9, 33, 17), (N_MG,) * 3):
        big = shape[0] == N_MG
        tag = "x".join(map(str, shape[::-1]))
        print(f"phase 17 rb_sweep vs plain at {tag}", flush=True)
        lv = mg_levels(shape)[0]
        _, prob = cg_problem(shape)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = prob.zero_boundary(torch.randn(shape, generator=gen,
                                           device=dev))
        b = torch.randn(shape, generator=gen, device=dev)
        cells = interior(shape)
        xt, rt = x.clone(), torch.empty_like(x)
        for first, emit in variants:
            def run(sweep, first=first, emit=emit):
                xo = x.clone()
                ro = torch.empty_like(x) if emit else None
                sweep(xo, b, lv, first, ro)
                return (xo, ro) if emit else xo

            outs = ("x", "r") if emit else ("x",)
            flops = (FLOPS_PER_POINT["rb_sweep"]
                     + (FLOPS_PER_POINT["mg_residual"] if emit else 0))
            check("mg3d", f"{tag} {first}-first{' +r' if emit else ''}",
                  big, mgk.rb_sweep, MG_SWEEP, SRC_MG,
                  lambda run=run: run(mgk.rb_sweep),
                  lambda run=run: run(mgk.rb_sweep_inplace_plain),
                  outs, (exact,) * len(outs),
                  work=((x, b), flops * cells),
                  time_fn=lambda first=first, emit=emit: mgk.rb_sweep(
                      xt, b, lv, first, rt if emit else None))
        del x, b, xt, rt
        torch.cuda.empty_cache()

    def mg_agree(tag, got, ref, tol_it=1):
        it, it_ref = int(got.iterations), int(ref.iterations)
        st, st_ref = int(got.status), int(ref.status)
        print(f"  {tag}: V-cycles {it} vs {it_ref}, status {st} vs "
              f"{st_ref}, residual {float(got.final_residual):.4e} vs "
              f"{float(ref.final_residual):.4e}", flush=True)
        if abs(it - it_ref) > tol_it or st != st_ref \
                or st != PoissonStatus.CONVERGED:
            fail(f"{tag}: V-cycles or status differ, or not converged")
        return compare(tag, "x", got.x, ref.x, TOL_DOT, True)

    for n in (33, 129):
        shape = (1, n, n)
        tag = f"{n}^2"
        print(f"phase 17 mg_solve vs plain at {tag}", flush=True)
        levels = mg_levels(shape)
        _, prob = cg_problem(shape)
        pp = PoissonParams(tolerance=1e-6, max_iterations=60)
        gen = torch.Generator(device=dev).manual_seed(7)
        rhs = torch.randn(shape, generator=gen, device=dev)
        x0 = torch.zeros_like(rhs)
        kern = mgs.make_multigrid_vmem(prob, pp, device=dev)
        plain = mgs.make_multigrid_vmem(prob, pp, device=dev, plain=True)
        got, ref = kern(x0, rhs), plain(x0, rhs)
        err, rel = mg_agree(f"{tag} mg_solve", got, ref)
        rec = records.setdefault(("mg2d", "mg_solve"), {
            "replaces": MG_VMEM, "source": SRC_MGS, "max_abs_err": 0.0,
            "max_rel_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["max_rel_err"] = max(rec["max_rel_err"], rel)
        ms_k = cuda_ms(lambda: kern(x0, rhs))
        n_it = int(got.iterations)
        print(f"  {tag} mg_solve: {ms_k:.4f} ms a solve, "
              f"{ms_k / max(n_it, 1) * 1e3:.2f} us a V-cycle "
              f"({len(levels)} levels)", flush=True)
        if n == 129:
            rec["ms"], rec["plain_ms"] = ms_k, cuda_ms(lambda: plain(x0,
                                                                     rhs))
            rec["library_ms"] = None
            rec["bound_ms"], rec["bound_by"] = bound(
                nbytes((x0, rhs, got.x)),
                n_it * (vcycle_flops_2d(levels, 2, 2)
                        + FLOPS_PER_POINT["mg2d_iter"] * interior(shape)))
            mg2d = {"iterations": n_it, "ms": ms_k,
                    "plain_ms": rec["plain_ms"]}
            print(f"  {tag} mg_solve: plain {rec['plain_ms']:.3f} ms, bound "
                  f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})",
                  flush=True)

    # ---- phase 18: bench.py's multigrid_513 --------------------------------
    n = N_MG
    _, prob = cg_problem((n, n, n))
    levels = mg_levels((n, n, n))
    pp = PoissonParams(tolerance=1e-6, max_iterations=2000,
                       check_interval=10)
    gen = torch.Generator(device=dev).manual_seed(7)
    rhs = prob.zero_boundary(torch.randn((n, n, n), generator=gen,
                                         device=dev))
    x0 = torch.zeros_like(rhs)
    solve = mgs.make_multigrid(prob, pp, device=dev)
    solve(x0, rhs)                              # warm-up, same pattern
    sync()
    mgk.rb_sweep.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = solve(x0, rhs)
    end.record()
    sync()
    ms_mg = start.elapsed_time(end)
    n_it, syncs, n_sweeps = int(res.iterations), solve.host_syncs, \
        mgk.rb_sweep.launches
    xd, rd = prob.zero_boundary(res.x.double()), rhs.double()
    true_rel = float(prob.interior(prob.laplacian(xd) - rd).norm()
                     / prob.interior(rd).norm())
    del xd, rd
    print(f"phase 18 multigrid_513 (513^3, tol 1e-6, check_interval 10): "
          f"{n_it} V-cycles (reference {MG_513_ITERS}), status "
          f"{int(res.status)}, {ms_mg:.1f} ms a solve, "
          f"{ms_mg / n_it:.3f} ms a V-cycle, {syncs} host syncs, "
          f"{n_sweeps} rb_sweep launches ({len(levels)} levels), residual "
          f"{float(res.final_residual):.4e} of "
          f"{float(res.initial_residual):.4e}, true relative residual "
          f"{true_rel:.4e}", flush=True)
    if int(res.status) != PoissonStatus.CONVERGED or not true_rel <= 1e-3:
        fail("multigrid_513: not converged, or true residual above 1e-3")
    if abs(n_it - MG_513_ITERS) > 1 or n_sweeps <= 0:
        fail(f"multigrid_513: {n_it} V-cycles, outside {MG_513_ITERS} ± 1, "
             f"or no sweep launched")
    plain_solve = mgs.make_multigrid(prob, pp, device=dev, plain=True)
    sync()
    t0 = time.perf_counter()
    res_p = plain_solve(x0, rhs)
    sync()
    ms_mg_plain = (time.perf_counter() - t0) * 1e3
    print(f"phase 18 multigrid_513 plain path: {ms_mg_plain:.1f} ms",
          flush=True)
    mg_agree("multigrid_513 kernel vs plain", res, res_p, tol_it=0)
    del res, res_p
    for lv in levels:
        xs = torch.randn(lv.shape, generator=gen, device=dev)
        bs = torch.randn(lv.shape, generator=gen, device=dev)
        rs = torch.empty_like(xs)
        t_s = cuda_ms(lambda: mgk.rb_sweep(xs, bs, lv))
        t_r = cuda_ms(lambda: mgk.rb_sweep(xs, bs, lv, residual=rs))
        b_s = bound(3 * nbytes((xs,)), FLOPS_PER_POINT["rb_sweep"]
                    * interior(lv.shape))[0]
        b_r = bound(4 * nbytes((xs,)), (FLOPS_PER_POINT["rb_sweep"]
                                        + FLOPS_PER_POINT["mg_residual"])
                    * interior(lv.shape))[0]
        print(f"  level {lv.shape[2]}^3: sweep {t_s:.4f} ms (bound "
              f"{b_s:.4f}), with residual {t_r:.4f} ms (bound {b_r:.4f})",
              flush=True)
        del xs, bs, rs
    mg513 = {"iterations": n_it, "ms": ms_mg, "plain_ms": ms_mg_plain,
             "host_syncs": syncs, "true_rel_residual": true_rel}

    # ---- phase 19: MG-preconditioned CG at 513³ through the front end ---
    pp_mgcg = PoissonParams(tolerance=1e-6, max_iterations=2000,
                            preconditioner=Precond.MULTIGRID)
    mgcg = {}
    for path in ("kernel", "plain"):
        ps = frontend.create_solver(Method.CG, pp_mgcg, device=dev,
                                    plain=path == "plain")
        ps.init(n, n, n, prob.dx, prob.dy, prob.dz)
        if path == "kernel":
            ps.solve_result(x0, rhs)            # warm-up
            sync()
            mgk.rb_sweep.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mgcg[path] = ps.solve_result(x0, rhs)
        end.record()
        sync()
        mgcg[path + "_ms"] = start.elapsed_time(end)
        if path == "kernel":
            mgcg["launches"] = mgk.rb_sweep.launches
    r_k = mgcg["kernel"]
    it_k = int(r_k.iterations)
    print(f"phase 19 MG-CG 513^3 (tol 1e-6, check_interval 1, one "
          f"symmetric V-cycle a preconditioner): {it_k} iterations, "
          f"{mgcg['kernel_ms']:.1f} ms a solve "
          f"({mgcg['kernel_ms'] / max(it_k, 1):.3f} ms an iteration), "
          f"plain {mgcg['plain_ms']:.1f} ms, {mgcg['launches']} rb_sweep "
          f"launches; beside cg_512's {cg512['iterations']} iterations and "
          f"{cg512['ms']:.1f} ms (phase 13; the grids differ: 513^3 here, "
          f"512^3 there)", flush=True)
    if mgcg["launches"] <= 0:
        fail("MG-CG: the sweep kernel was not launched")
    mg_agree("MG-CG 513^3 kernel vs plain", r_k, mgcg["plain"], tol_it=0)
    mgcg_rec = {"iterations": it_k, "ms": mgcg["kernel_ms"],
                "plain_ms": mgcg["plain_ms"]}
    del rhs, x0, mgcg, r_k, solve, plain_solve
    torch.cuda.empty_cache()

    # ---- phase 20: the 3D multigrid projection step at 257³ ---------------
    shape = (N_MG_STEP,) * 3
    grid_mg = uniform_grid(shape)
    floor_step = make_projection_step(
        grid_mg, params_cg, torch.float32, Method.MULTIGRID, device=dev,
        poisson_params=PoissonParams(tolerance=0.0,
                                     max_iterations=MG_FLOOR_CYCLES))
    floor_step(tg_field(shape), 1e-4, 0)
    lp = floor_step.last_poisson
    mg_floor = float(lp.final_residual) / float(lp.initial_residual)
    print(f"phase 20 float32 residual floor of the first step's solve: "
          f"{mg_floor:.3e} relative after {MG_FLOOR_CYCLES} V-cycles; the "
          f"step runs at tolerance {MG_STEP_TOL:g}", flush=True)
    if not mg_floor < MG_STEP_TOL:
        fail("phase 20: the residual floor is above the step's tolerance")
    del floor_step, lp
    finals, mg_ms = {}, {}
    for path in ("kernel", "plain"):
        stepf = make_projection_step(
            grid_mg, params_cg, torch.float32, Method.MULTIGRID, device=dev,
            poisson_params=PoissonParams(tolerance=MG_STEP_TOL),
            plain=path == "plain")
        f0 = tg_field(shape)
        run_steps(stepf, f0, 1e-4, CG_STEPS)
        sync()
        if path == "kernel":
            pkm.reset_launch_counts()
            mgk.rb_sweep.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        f, its, worst = f0, [], 0
        for i in range(CG_STEPS):
            f, r = stepf(f, 1e-4, i)
            its.append(stepf.last_poisson.iterations)
            worst = torch.maximum(torch.as_tensor(worst, device=dev),
                                  r.status.abs())
        end.record()
        sync()
        mg_ms[path] = start.elapsed_time(end) / CG_STEPS
        its = [int(t) for t in its]
        print(f"phase 20 MG step 257^3 (tolerance {MG_STEP_TOL:g}) {path} "
              f"path: {mg_ms[path]:.3f} "
              f"ms/step, {N_MG_STEP ** 3 / (mg_ms[path] * 1e-3) / 1e6:.1f} "
              f"MLUPS, V-cycles a step {its}, host syncs of the last solve "
              f"{stepf.poisson_solve.host_syncs}, worst status "
              f"{int(worst)}, max|u| {float(r.max_velocity):.6f}",
              flush=True)
        if int(worst) != 0 or not bool(f.is_finite()):
            fail(f"phase 20 {path} path: nonzero status or non-finite")
        if path == "kernel":
            counts = {fn.__name__: fn.launches for fn in
                      pkm.WRAPPERS_RHS + mgk.WRAPPERS}
            print(f"phase 20 launch counts over the main path: {counts}",
                  flush=True)
            if any(v <= 0 for v in counts.values()):
                fail(f"phase 20: kernels not launched: {counts}")
            launch_counts["mg3d"] = {"rb_sweep": counts["rb_sweep"]}
        finals[path] = f
        del f0
    for name in "uvw":
        compare(f"phase 20 {CG_STEPS} steps", name,
                getattr(finals["kernel"], name),
                getattr(finals["plain"], name), TOL_CG_UVW, False)
    close_p(f"phase 20 {CG_STEPS} steps", finals["kernel"].p,
            finals["plain"].p)
    del finals
    # the CG step on the same grid at the same tolerance, for a like for
    # like comparison of the two solves (kernel path, not a main path)
    stepf = make_projection_step(
        grid_mg, params_cg, torch.float32, device=dev,
        poisson_params=PoissonParams(tolerance=MG_STEP_TOL))
    f0 = tg_field(shape)
    run_steps(stepf, f0, 1e-4, CG_STEPS)
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    f, its, worst = f0, [], 0
    for i in range(CG_STEPS):
        f, r = stepf(f, 1e-4, i)
        its.append(stepf.last_poisson.iterations)
        worst = torch.maximum(torch.as_tensor(worst, device=dev),
                              r.status.abs())
    end.record()
    sync()
    mg_ms["cg_same_tolerance"] = start.elapsed_time(end) / CG_STEPS
    print(f"phase 20 CG step 257^3 (tolerance {MG_STEP_TOL:g}) kernel path: "
          f"{mg_ms['cg_same_tolerance']:.3f} ms/step, CG iterations a step "
          f"{[int(t) for t in its]}, against the MG step's "
          f"{mg_ms['kernel']:.3f}", flush=True)
    if int(worst) != 0 or not bool(f.is_finite()):
        fail("phase 20 CG step: nonzero status or non-finite")
    del stepf, f0, f
    torch.cuda.empty_cache()

    # ---- phase 21: 2D — run_mg2d_vmem(129), Ghia with MG, the facade -----
    print(f"phase 21 run_mg2d_vmem(129): {mg2d['iterations']} V-cycles "
          f"(reference {MG2D_ITERS}), {mg2d['ms']:.4f} ms a solve, plain "
          f"{mg2d['plain_ms']:.3f} ms (phase 17)", flush=True)
    if abs(mg2d["iterations"] - MG2D_ITERS) > 1:
        fail(f"run_mg2d_vmem(129): outside {MG2D_ITERS} ± 1 V-cycles")
    vmem_mg.mg_solve.launches = 0
    ghia_gate("phase 21", 129, 100, 5e-4, GHIA_SOLVER_STEPS, 0.10,
              Method.MULTIGRID)
    print(f"phase 21 mg_solve launches {vmem_mg.mg_solve.launches}",
          flush=True)
    sim = Simulation.create(MG_FACADE, MG_FACADE,
                            solver_type="projection_multigrid", device=dev)
    floor_step = make_projection_step(
        sim.grid, sim.params, torch.float32, Method.MULTIGRID, device=dev,
        poisson_params=PoissonParams(tolerance=0.0,
                                     max_iterations=MG_FLOOR_CYCLES))
    floor_step(sim.field, 0.005, 0)             # Simulation.step's dt, iter
    lp = floor_step.last_poisson
    facade_floor = float(lp.final_residual) / float(lp.initial_residual)
    print(f"phase 21 facade {MG_FACADE}^2: float32 residual floor of the "
          f"first step's solve {facade_floor:.3e} relative after "
          f"{MG_FLOOR_CYCLES} V-cycles; the solver runs at tolerance "
          f"{MG_FACADE_TOL:g}", flush=True)
    if not facade_floor < MG_FACADE_TOL:
        fail("phase 21 facade: the residual floor is above the tolerance")
    del floor_step, lp
    facade_pp = PoissonParams(tolerance=MG_FACADE_TOL)
    solver = sim.registry.create("projection_multigrid")
    solver.poisson_params = facade_pp
    sim.set_solver(solver)
    pk2m.reset_launch_counts()
    vmem_mg.mg_solve.launches = 0
    start_field, checked = sim.field, None
    sync()
    t0 = time.perf_counter()
    for i in range(MG_FACADE_STEPS):
        status = sim.step()
        if status != 0:
            fail(f"phase 21 facade: step returned status {int(status)}")
        if i + 1 == FACADE_CHECK:
            checked = sim.field
    wall_mg = (time.perf_counter() - t0) * 1e3
    n_launch = vmem_mg.mg_solve.launches
    stats = sim.get_stats()
    print(f"phase 21 Simulation.create({MG_FACADE}, {MG_FACADE}, "
          f"solver_type='projection_multigrid'), tolerance "
          f"{MG_FACADE_TOL:g}: {MG_FACADE_STEPS} step()s "
          f"in {wall_mg:.1f} ms host wall ({wall_mg / MG_FACADE_STEPS:.4f} "
          f"ms a step), last V-cycles "
          f"{int(sim.solver._step_fn.last_poisson.iterations)}, max|u| "
          f"{stats.max_velocity:.6f}, max p {stats.max_pressure:.6f}, "
          f"mg_solve launches {n_launch}", flush=True)
    if n_launch != MG_FACADE_STEPS:
        fail("phase 21 facade: not the whole-solve multigrid once a step")
    launch_counts["mg2d"] = {"mg_solve": n_launch}
    plain_mg = make_projection_step(sim.grid, sim.params, torch.float32,
                                    Method.MULTIGRID, device=dev,
                                    poisson_params=facade_pp, plain=True)
    fp = start_field
    for _ in range(FACADE_CHECK):
        fp, rp = plain_mg(fp, 0.005, 0)        # Simulation.step's dt, iter
    sync()
    for name in "uv":
        compare(f"phase 21 facade {FACADE_CHECK} steps", name,
                getattr(checked, name), getattr(fp, name), TOL_CG_UVW,
                False)
    close_p(f"phase 21 facade {FACADE_CHECK} steps", checked.p, fp.p)

    # ---- phase 22: the BiCGSTAB and stationary kernels against plain -------
    def bicg_timing_state(alpha, beta, omega):
        """A running B1 state that never stops (tolerances 0), to time the
        passes as the solve launches them."""
        one = torch.ones((), device=dev)
        st = bk.new_state(one, one, 0 * one, 0 * one, one > 0)
        for slot, val in ((bk.BETA, beta), (bk.OMEGA, omega),
                          (bk.ALPHA_NEW, alpha), (bk.ALPHA_EFF, alpha),
                          (bk.OMEGA_EFF, omega), (bk.OMEGA_NEW, omega)):
            st[slot] = val
        return st

    for shape in ((11, 23, 37), (N_BIG,) * 3):
        big = shape[0] == N_BIG
        tag = "x".join(map(str, shape[::-1]))
        print(f"phase 22 BiCGSTAB passes and RB-SOR sweep vs plain at {tag}",
              flush=True)
        _, prob = cg_problem(shape)
        c = bk.BiCGConsts(*shape, prob.inv_dx2, prob.inv_dy2, prob.inv_dz2)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        r, p, v, rhat = (prob.zero_boundary(torch.randn(
            shape, generator=gen, device=dev)) for _ in range(4))
        alpha, beta, omega = (torch.full((), a, device=dev)
                              for a in (0.61, 0.37, 0.29))
        cells = interior(shape)
        ops = bk.BiCGSTABPasses(c, dev)
        st = bicg_timing_state(alpha, beta, omega)
        pn_t, vn_t, s_t, t_t = (torch.empty_like(r) for _ in range(4))
        pn, vn, _ = check(
            "bicg3d", tag, big, bk.pass_pv, B1, SRC_BICG,
            lambda: bk.pass_pv(r, p, v, rhat, beta, omega, c),
            lambda: bk.pass_pv_plain(r, p, v, rhat, beta, omega, c),
            ("p'", "v'", "<rhat,v'>"), (bit, bit, dot),
            work=((r, p, v, rhat), FLOPS_PER_POINT["bicg_pv"] * cells),
            time_fn=lambda: ops.pv(r, p, v, rhat, pn_t, vn_t, st))
        s, t, _, _, _ = check(
            "bicg3d", tag, big, bk.pass_st, B1, SRC_BICG,
            lambda: bk.pass_st(r, vn, alpha, c),
            lambda: bk.pass_st_plain(r, vn, alpha, c),
            ("s", "t", "<s,s>", "<t,s>", "<t,t>"), (bit, bit) + (dot,) * 3,
            work=((r, vn), FLOPS_PER_POINT["bicg_st"] * cells),
            time_fn=lambda: ops.st(r, vn, s_t, t_t, st))
        del s_t, t_t
        x = torch.randn(shape, generator=gen, device=dev)
        x_t, r_t = x.clone(), r.clone()
        check("bicg3d", tag, big, bk.pass_xr, B1, SRC_BICG,
              lambda: bk.pass_xr(x, pn, s, t, rhat, alpha, omega, c),
              lambda: bk.pass_xr_plain(x, pn, s, t, rhat, alpha, omega, c),
              ("x'", "r'", "<r',r'>", "<rhat,r'>"), (bit, bit, dot, dot),
              work=((x, pn, s, t, rhat), FLOPS_PER_POINT["bicg_xr"] * cells),
              time_fn=lambda: ops.xr(x_t, r_t, pn, s, t, rhat, st))
        del p, v, rhat, pn, vn, s, t, pn_t, vn_t, x_t, r_t
        torch.cuda.empty_cache()
        # S1: one sweep, timed in place on a state that never stops
        sc = sk.SORConsts(*shape, prob.inv_dx2, prob.inv_dy2, prob.inv_dz2,
                          prob.inv_factor, prob.resolve_omega(0.0))
        sor = sk.SORPasses(sc, dev)
        zero = torch.zeros((), device=dev)
        st_s = sk.new_state(zero, zero, zero, zero < 1)
        x_t = x.clone()
        check("sor3d", tag, big, sk.rbsor_sweep, S1, SRC_SOR,
              lambda: sk.rbsor_sweep(x, r, sc),
              lambda: sk.rbsor_sweep_plain(x, r, sc),
              ("x", "residual"), (bit, bit),
              work=((x, r), FLOPS_PER_POINT["rbsor_sweep"] * cells),
              time_fn=lambda: sor.sweep(x_t, r, st_s))
        x[shape[0] // 2, 3, 4] = float("nan")
        res_k = sk.rbsor_sweep(x, r, sc)[1]
        res_p = sk.rbsor_sweep_plain(x, r, sc)[1]
        print(f"  {tag} rbsor_sweep with a NaN in x: residual {float(res_k)} "
              f"(plain {float(res_p)})", flush=True)
        if not (torch.isnan(res_k) and torch.isnan(res_p)):
            fail("rbsor_sweep: a NaN in x did not give a NaN residual")
        del x, x_t, r
        torch.cuda.empty_cache()

    def whole_solve_agree(tag, got, ref, tol_it, x_tol):
        it, it_ref = int(got.iterations), int(ref.iterations)
        st_k, st_p = int(got.status), int(ref.status)
        print(f"  {tag}: iterations {it} vs {it_ref}, status {st_k} vs "
              f"{st_p}, residual {float(got.final_residual):.4e} vs "
              f"{float(ref.final_residual):.4e}", flush=True)
        if abs(it - it_ref) > tol_it or st_k != st_p:
            fail(f"{tag}: iterations or status differ")
        return compare(tag, "x", got.x, ref.x, *x_tol)

    # B2 against its plain version: the reference's BiCGSTAB bars (±3
    # iterations, x within 1e-3·max|x|, tests/math/test_fused_solvers.py:
    # 181-186) on a smooth rhs at tolerance 1e-2 — BiCGSTAB's float32
    # trajectories under two summation orders part after 20–30
    # iterations, and this solve converges in fewer — then, below, the
    # reference's own whole-solve bars on a normal rhs at 1e-5; S2
    # bit-equal (the same sweeps and residual folds)
    whole = (("bicgstab_solve", krylov.make_bicgstab_vmem, "bicg2d", B2,
              SRC_BICG, ((1, 100, 100), (1, 64, 96)) + GRID_SHAPES,
              PoissonParams(tolerance=1e-2, max_iterations=1000), 3,
              (1e-3, True)),
             ("rbsor_solve", stationary.make_redblack_sor_vmem, "sor2d",
              S2_SOR, SRC_SOR, ((1, 100, 100), (9, 17, 33)),
              PoissonParams(tolerance=1e-3, max_iterations=2000,
                            check_interval=5), 0, bit),
             ("jacobi_solve", stationary.make_jacobi_vmem, "sor2d", S2_JAC,
              SRC_SOR, ((1, 100, 100), (9, 17, 33)),
              PoissonParams(tolerance=1e-3, max_iterations=2000,
                            check_interval=5), 0, bit))
    for name, maker, path, replaces, source, shapes, pp, tol_it, x_tol \
            in whole:
        for shape in shapes:
            tag = "x".join(map(str, shape[::-1])) + f" {name}"
            _, prob = cg_problem(shape)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            rhs = torch.randn(shape, generator=gen, device=dev)
            x0 = 0.1 * torch.randn(shape, generator=gen, device=dev)
            if name == "bicgstab_solve":
                # sin·sin plus a little noise, zero start
                yy = torch.linspace(0.0, 1.0, shape[1], device=dev)
                xx = torch.linspace(0.0, 1.0, shape[2], device=dev)
                rhs = (torch.sin(math.pi * yy)[:, None]
                       * torch.sin(math.pi * xx)[None, :])[None] \
                    + 0.005 * rhs
                x0.zero_()
            rec_name = name
            if name == "bicgstab_solve":
                # B2 in the form its plan names, the record the form's
                form = vmem_small.krylov_cluster_plan(*shape,
                                                      "bicgstab")["form"]
                if (shape in GRID_SHAPES) != (form == "grid"):
                    fail(f"phase 22: the BiCGSTAB plan of {shape} is {form}")
                rec_name = name + ("[cluster]" if form == "cluster" else "")
                fn = vmem_small.bicgstab_solve
                fn.launches = fn.cluster_launches = 0
            print(f"phase 22 {tag} vs plain", flush=True)
            got = maker(prob, pp, device=dev)(x0, rhs)
            if name == "bicgstab_solve":
                solve_forms(fn, f"phase 22 {tag}", 1, form)
            ref = maker(prob, pp, device=dev, plain=True)(x0, rhs)
            solve_record(path, rec_name, replaces, source,
                         whole_solve_agree(tag, got, ref, tol_it, x_tol))
    # B2c at every plane of CLUSTER_PLANES bit for bit against its order
    # model, two launches bit-identical, each form device-timed (a normal
    # rhs from seed 0, tolerance 1e-5, at most 600 iterations)
    for shape in CLUSTER_PLANES:
        tag = f"{shape[2]}x{shape[1]}"
        _, prob = cg_problem(shape)
        c = bk.BiCGConsts(*shape, prob.inv_dx2, prob.inv_dy2, prob.inv_dz2)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        rhs = torch.randn(shape, generator=gen, device=dev)
        hold_cluster(f"phase 22 B2c {tag}", "bicgstab", c,
                     torch.zeros_like(rhs), rhs, 1e-5, 600)

    # B2 on a normal rhs at 1e-5 (tests/math/test_vmem_small.py:141-162):
    # both converged below tol·r0, at most twice the plain path's
    # iterations, x within 5e-4
    shape = (1, 100, 100)
    _, prob = cg_problem(shape)
    pp = PoissonParams(tolerance=1e-5, max_iterations=1000)
    rhs = torch.randn(shape, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    x0 = torch.zeros_like(rhs)
    got = krylov.make_bicgstab_vmem(prob, pp, device=dev)(x0, rhs)
    ref = krylov.make_bicgstab_vmem(prob, pp, device=dev, plain=True)(x0,
                                                                      rhs)
    it, it_ref = int(got.iterations), int(ref.iterations)
    print(f"  100x100 bicgstab_solve, normal rhs, tolerance 1e-5: "
          f"iterations {it} vs {it_ref}, status {int(got.status)} vs "
          f"{int(ref.status)}, residual {float(got.final_residual):.4e} "
          f"(bar {1e-5 * float(got.initial_residual):.4e})", flush=True)
    if not (int(got.status) == int(ref.status) == PoissonStatus.CONVERGED
            and 0 < it <= 2 * it_ref and float(got.final_residual)
            < 1e-5 * float(got.initial_residual)):
        fail("100x100 bicgstab_solve: not converged as the plain path")
    compare("100x100 bicgstab_solve, normal rhs", "x", got.x, ref.x, 5e-4,
            False)

    # ---- phase 23: bench.py:run_poisson_iters(100) ------------------------
    n = POISSON_N
    interior_2d = (n - 2) ** 2
    rhs_p = torch.tensor(np.random.default_rng(0).normal(0.0, 1.0,
                                                         (1, n, n)),
                         dtype=torch.float32, device=dev)
    rhs_p = rhs_p - rhs_p.mean()
    x0_p = torch.zeros_like(rhs_p)
    method_of = {"redblack_sor": Method.REDBLACK_SOR, "cg": Method.CG,
                 "bicgstab": Method.BICGSTAB}
    poisson_iters = {}
    for name, budget in POISSON_BUDGETS:
        pp = PoissonParams(tolerance=0.0, absolute_tolerance=0.0,
                           max_iterations=budget, check_interval=budget)
        solvers = {}
        for path in ("kernel", "plain"):
            solvers[path] = frontend.create_solver(
                method_of[name], pp, device=dev,
                plain=path == "plain").init(n, n, 1, 1.0 / (n - 1),
                                            1.0 / (n - 1), 0.0)
        fn = solvers["kernel"]._dispatch(x0_p)
        one = {path: s.solve_result(x0_p, rhs_p)
               for path, s in solvers.items()}
        meas = {}
        for count in POISSON_PAIR:
            eps = torch.linspace(0.0, 1e-4, count, device=dev)
            scaled = [rhs_p * (1.0 + e) for e in eps]
            best = float("inf")
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                sync()
                start.record()
                its = [fn(x0_p, rs).iterations for rs in scaled]
                end.record()
                sync()
                best = min(best, start.elapsed_time(end))
            meas[count] = (sum(int(i) for i in its), best)
        (i1, t1), (i2, t2) = meas[POISSON_PAIR[0]], meas[POISSON_PAIR[1]]
        rate = (i2 - i1) / max((t2 - t1) * 1e-3, 1e-12)
        k, pl = one["kernel"], one["plain"]
        poisson_iters[name] = {
            "iters_per_s": rate, "iterations": int(k.iterations),
            "status": int(k.status), "ms_a_solve": t2 / POISSON_PAIR[1],
            "plain_iterations": int(pl.iterations),
            "plain_status": int(pl.status)}
        print(f"phase 23 run_poisson_iters({n}) {name}: {rate:.1f} "
              f"iterations/s (Δ{i2 - i1} iterations in Δ{t2 - t1:.3f} ms, "
              f"{POISSON_PAIR} solves), {t2 / POISSON_PAIR[1]:.4f} ms a "
              f"solve; one solve: kernel {int(k.iterations)} iterations, "
              f"status {int(k.status)}, residual "
              f"{float(k.final_residual):.4e} of "
              f"{float(k.initial_residual):.4e}; plain "
              f"{int(pl.iterations)} iterations, status {int(pl.status)}, "
              f"residual {float(pl.final_residual):.4e}", flush=True)
        if not bool(torch.isfinite(k.x).all()):
            fail(f"run_poisson_iters {name}: non-finite solution")
        # at tolerance 0 BiCGSTAB's float32 trajectory may break down at
        # another iteration on the two paths (its dots differ in
        # summation order); the other two must agree
        if name != "bicgstab" and (int(k.status), int(k.iterations)) != (
                int(pl.status), int(pl.iterations)):
            fail(f"run_poisson_iters {name}: the kernel's status or "
                 f"iterations differ from the plain path's")
        if name == "redblack_sor":
            compare(f"phase 23 {name}", "x", k.x, pl.x, *bit)
        # the whole-solve kernels' records: this solve, timed
        if name == "bicgstab":
            # B2c (the form the plan names here) and the grid-wide B2 on
            # this input, device-timed; the barrier floor of each
            c_b = bk.BiCGConsts(1, n, n, (n - 1) ** 2, (n - 1) ** 2, 0.0,
                                budget)
            args = (x0_p, rhs_p, c_b, 0.0, 0.0, budget)
            plan = vmem_small.krylov_cluster_plan(1, n, n, "bicgstab")
            plain_ms = cuda_ms(
                lambda: solvers["plain"].solve_result(x0_p, rhs_p), reps=1)
            for nm, fn, floor in (
                    ("bicgstab_solve[cluster]",
                     vmem_small.bicgstab_solve_cluster,
                     3 * barrier_floor("dot", plan["cluster"],
                                       plan["threads"])),
                    ("bicgstab_solve", vmem_small.bicgstab_solve_grid,
                     5 * barrier_floor("grid", grid_blocks(
                         "bicgstab", (1, n, n)), 256))):
                n_b = int(fn(*args)[3])
                rec = records[("bicg2d", nm)]
                rec["ms"] = device_ms(lambda: fn(*args))
                rec["plain_ms"], rec["library_ms"] = plain_ms, None
                rec["bound_ms"], rec["bound_by"] = bound(
                    3 * nbytes((rhs_p,)),
                    n_b * FLOPS_PER_POINT["bicg_iter_2d"] * interior_2d)
                rec["barrier_ms"] = n_b * floor * 1e-6
                print(f"  {nm}: {n_b} iterations, {rec['ms']:.4f} ms "
                      f"({rec['ms'] / max(n_b, 1) * 1e3:.3f} us an "
                      f"iteration), plain {plain_ms:.3f} ms, barrier floor "
                      f"{rec['barrier_ms']:.4f} ms", flush=True)
        rec_name = {"redblack_sor": "rbsor_solve"}.get(name)
        if rec_name is not None:
            rec = records[("sor2d", rec_name)]
            rec["ms"] = t2 / POISSON_PAIR[1]
            rec["plain_ms"] = cuda_ms(
                lambda: solvers["plain"].solve_result(x0_p, rhs_p), reps=1)
            rec["library_ms"] = None
            flops = (budget * FLOPS_PER_POINT["sor_sweep_2d"]
                     + FLOPS_PER_POINT["residual_2d"]) * interior_2d
            rec["bound_ms"], rec["bound_by"] = bound(
                3 * nbytes((rhs_p,)), flops)
    # Jacobi's whole solve on the same 100² input, 2000 sweeps
    pp_j = PoissonParams(tolerance=0.0, absolute_tolerance=0.0,
                         max_iterations=2000, check_interval=2000)
    jk_ = stationary.make_jacobi_vmem(cg_problem((1, n, n))[1], pp_j,
                                      device=dev)
    jp_ = stationary.make_jacobi_vmem(cg_problem((1, n, n))[1], pp_j,
                                      device=dev, plain=True)
    rec = records[("sor2d", "jacobi_solve")]
    rec["ms"] = cuda_ms(lambda: jk_(x0_p, rhs_p))
    rec["plain_ms"] = cuda_ms(lambda: jp_(x0_p, rhs_p), reps=1)
    rec["library_ms"] = None
    rec["bound_ms"], rec["bound_by"] = bound(
        3 * nbytes((rhs_p,)), (2000 * FLOPS_PER_POINT["jacobi_sweep_2d"]
                               + FLOPS_PER_POINT["residual_2d"])
        * interior_2d)
    print(f"phase 23 jacobi_solve 100^2, 2000 sweeps: {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.3f} ms", flush=True)
    for name in ("bicgstab_solve[cluster]", "bicgstab_solve", "rbsor_solve",
                 "jacobi_solve"):
        rec = records[("bicg2d" if name.startswith("bicgstab") else "sor2d",
                       name)]
        print(f"  {name}: bound {rec['bound_ms']:.6f} ms "
              f"({rec['bound_by']})", flush=True)

    # ---- phase 24: 512³ — BiCGSTAB on cg_512's problem, the RB-SOR sweep --
    n = N_BIG
    _, prob = cg_problem((n, n, n))
    gen = torch.Generator(device=dev).manual_seed(7)
    rhs = prob.zero_boundary(torch.randn((n, n, n), generator=gen,
                                         device=dev))
    x0 = torch.zeros_like(rhs)
    # Float32 BiCGSTAB may not reach 1e-6 on this large rough problem: ρ =
    # ⟨r̂, r⟩ shrinks against ‖r̂‖‖r‖ until r's own rounding sets it (with
    # float32 dots the solve diverged after 1372 iterations, the plain
    # path too).  The solve runs at 1e-6 first; where it does not
    # converge it runs at the next decades up, and the first that
    # converges is timed — the rule of the stationary floors.
    def bicg_solver(tol):
        return frontend.create_solver(Method.BICGSTAB, PoissonParams(
            tolerance=tol, max_iterations=BICG_512_ITERS_MAX,
            check_interval=10), device=dev).init(n, n, n, prob.dx, prob.dy,
                                                 prob.dz)

    for bicg_tol in (1e-6, 1e-5, 1e-4, 1e-3):
        ps = bicg_solver(bicg_tol)
        res = ps.solve_result(x0, rhs)          # also the timed run's warm-up
        print(f"phase 24 BiCGSTAB 512^3 at tolerance {bicg_tol:g}: "
              f"{int(res.iterations)} iterations, status {int(res.status)}, "
              f"recursion residual {float(res.final_residual):.4e} of "
              f"{float(res.initial_residual):.4e}", flush=True)
        if int(res.status) == PoissonStatus.CONVERGED:
            break
    sync()
    for w in bk.WRAPPERS:
        w.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = ps.solve_result(x0, rhs)
    end.record()
    sync()
    ms_solve = start.elapsed_time(end)
    n_it, syncs = int(res.iterations), ps._fused_fn.host_syncs
    xd, rd = prob.zero_boundary(res.x.double()), rhs.double()
    true_rel = float(prob.interior(prob.laplacian(xd) - rd).norm()
                     / prob.interior(rd).norm())
    del xd, rd
    print(f"phase 24 BiCGSTAB on cg_512's problem (512^3, tol {bicg_tol:g}, "
          f"check_interval 10, the front end's fused passes): {n_it} "
          f"iterations, status {int(res.status)}, {ms_solve:.1f} ms a solve, "
          f"{ms_solve / max(n_it, 1):.4f} ms an iteration (bound 2.725), "
          f"{syncs} host syncs (bar {-(-n_it // krylov.CHUNK) + 2}), "
          f"recursion residual {float(res.final_residual):.4e} of "
          f"{float(res.initial_residual):.4e}, true relative residual "
          f"{true_rel:.4e}; launches pv {bk.pass_pv.launches}, st "
          f"{bk.pass_st.launches}, xr {bk.pass_xr.launches}; beside cg_512's "
          f"{cg512['iterations']} iterations and {cg512['ms']:.1f} ms at 1e-6 "
          f"(phase 13)", flush=True)
    if int(res.status) != PoissonStatus.CONVERGED or not true_rel <= 1e-3:
        fail("BiCGSTAB 512^3: not converged, or true residual above 1e-3")
    if syncs > -(-n_it // krylov.CHUNK) + 2:
        fail("BiCGSTAB 512^3: more host syncs than one a chunk")
    bicg512 = {"iterations": n_it, "ms": ms_solve, "host_syncs": syncs,
               "true_rel_residual": true_rel, "tolerance": bicg_tol}
    del res, ps
    # a fixed budget, kernel path against plain path: 10 iterations, as
    # BiCGSTAB's float32 trajectories under two summation orders part by
    # ~1e-2 of max|x| within 20 iterations of a rough rhs (the port's
    # float32 loop against the reference's on the CPU, 64³ and 96³: 1e-2
    # and 3e-2 at 20, 4e-6 and 3e-7 at 10)
    n_fix = 10
    pp_fix = PoissonParams(tolerance=0.0, max_iterations=n_fix,
                           check_interval=10)
    fixed = {}
    for path in ("kernel", "plain"):
        fs = krylov.make_bicgstab_fused(prob, pp_fix, device=dev,
                                        plain=path == "plain")
        fixed[path] = fs(x0, rhs)
        fixed[path + "_ms"] = cuda_ms(lambda: fs(x0, rhs), reps=1)
    print(f"phase 24 BiCGSTAB 512^3, {n_fix} iterations: kernel "
          f"{fixed['kernel_ms'] / n_fix:.4f} ms, plain "
          f"{fixed['plain_ms'] / n_fix:.4f} ms an iteration", flush=True)
    bicg512["plain_ms_an_iteration"] = fixed["plain_ms"] / n_fix
    whole_solve_agree(f"BiCGSTAB 512^3 {n_fix} iterations", fixed["kernel"],
                      fixed["plain"], 0, (1e-3, True))
    del fixed
    torch.cuda.empty_cache()
    # the RB-SOR sweep: 200 sweeps, tolerance 0, through the front end
    pp_s = PoissonParams(tolerance=0.0, max_iterations=SOR_512_SWEEPS,
                         check_interval=10)
    ss = frontend.create_solver(Method.REDBLACK_SOR, pp_s, device=dev).init(
        n, n, n, prob.dx, prob.dy, prob.dz)
    ss.solve_result(x0, rhs)                    # warm-up
    sync()
    sk.rbsor_sweep.launches = 0
    start.record()
    res = ss.solve_result(x0, rhs)
    end.record()
    sync()
    ms_sor = start.elapsed_time(end)
    print(f"phase 24 RB-SOR 512^3, {int(res.iterations)} sweeps (tolerance "
          f"0, check_interval 10): {ms_sor:.1f} ms, "
          f"{ms_sor / SOR_512_SWEEPS:.4f} ms a sweep (bound 0.481), "
          f"infinity-norm residual {float(res.final_residual):.4e} of "
          f"{float(res.initial_residual):.4e}, host syncs "
          f"{ss._fused_fn.host_syncs}, rbsor_sweep launches "
          f"{sk.rbsor_sweep.launches}", flush=True)
    if int(res.iterations) != SOR_512_SWEEPS or sk.rbsor_sweep.launches \
            < SOR_512_SWEEPS:
        fail("RB-SOR 512^3: not the sweep kernel once a sweep")
    sor512 = {"sweeps": SOR_512_SWEEPS, "ms": ms_sor,
              "ms_a_sweep": ms_sor / SOR_512_SWEEPS,
              "residual": float(res.final_residual)}
    del res, ss
    pp10 = PoissonParams(tolerance=0.0, max_iterations=10, check_interval=10)
    ten = {path: stationary.make_redblack_sor_fused(
        prob, pp10, device=dev, plain=path == "plain")(x0, rhs)
        for path in ("kernel", "plain")}
    whole_solve_agree("RB-SOR 512^3 10 sweeps", ten["kernel"], ten["plain"],
                      0, bit)
    compare("RB-SOR 512^3 10 sweeps", "residual",
            ten["kernel"].final_residual, ten["plain"].final_residual, *bit)
    del ten, rhs, x0
    torch.cuda.empty_cache()

    # ---- phase 25: the 3D BiCGSTAB, RB-SOR and Jacobi steps ----------------
    def iterative_step_paths(label, shape, method, pparams, wrappers,
                             steps=CG_STEPS, warm=CG_STEPS,
                             paths=("kernel", "plain")):
        """Kernel path, then plain path: ``warm`` steps from the Taylor-
        Green start, then ``steps`` timed with CUDA events from the same
        start (run_3d's physics, dt = 1e-4).  The launch counters are set
        to 0 just before the kernel path's timed steps and read just
        after.  Returns {path: (field, iterations, statuses)}, ms a step
        and the counts."""
        grid3 = uniform_grid(shape)
        out, ms, counts = {}, {}, None
        for path in paths:
            stepf = make_projection_step(grid3, params_cg, torch.float32,
                                         method, poisson_params=pparams,
                                         device=dev, plain=path == "plain")
            f0 = tg_field(shape)
            if warm:
                run_steps(stepf, f0, 1e-4, warm)
            sync()
            if path == "kernel":
                pkm.reset_launch_counts()
                for w in wrappers:
                    w.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f, its, stats = f0, [], []
            for i in range(steps):
                f, r = stepf(f, 1e-4, i)
                its.append(stepf.last_poisson.iterations)
                stats.append(r.status)
            end.record()
            sync()
            ms[path] = start.elapsed_time(end) / steps
            its, stats = [int(t) for t in its], [int(t) for t in stats]
            print(f"{label} {path} path: {ms[path]:.3f} ms/step, iterations "
                  f"a step {its}, statuses {stats}, host syncs of the last "
                  f"solve {getattr(stepf.poisson_solve, 'host_syncs', 0)}, "
                  f"max|u| {float(r.max_velocity):.6f}", flush=True)
            if not bool(f.is_finite()):
                fail(f"{label} {path} path: non-finite fields")
            if path == "kernel":
                counts = {fn.__name__: fn.launches
                          for fn in pkm.WRAPPERS_RHS + tuple(wrappers)}
                print(f"{label} launch counts over the main path: {counts}",
                      flush=True)
                if any(val <= 0 for val in counts.values()):
                    fail(f"{label}: kernels not launched: {counts}")
            out[path] = (f, its, stats)
            del f0
        return out, ms, counts

    def hold_steps(label, out, exact_paths):
        fk, fp = out["kernel"][0], out["plain"][0]
        for name in "uvw":
            compare(label, name, getattr(fk, name), getattr(fp, name),
                    *(bit if exact_paths else (TOL_CG_UVW, False)))
        if exact_paths:
            compare(label, "p", fk.p, fp.p, *bit)
        else:
            close_p(label, fk.p, fp.p)

    def stationary_floor(label, make_step, field, budget):
        """The relative residual a stationary solve reaches in ``budget``
        sweeps at tolerance 0 (its float32 floor, or the least it reaches
        in its budget), on the kernel path."""
        fstep = make_step(PoissonParams(tolerance=0.0,
                                        max_iterations=budget))
        fstep(field, 1e-4, 0)
        lp = fstep.last_poisson
        floor = float(lp.final_residual) / float(lp.initial_residual)
        tol = 1e-6 if floor < 1e-6 else 10.0 ** math.ceil(math.log10(floor))
        print(f"{label} float32 residual floor of the first step's solve: "
              f"{floor:.3e} relative after {budget} sweeps; the step runs "
              f"at tolerance {tol:g}"
              + ("" if tol == 1e-6 else " (the smallest decade above the "
                 "floor: 1e-6 is below it)"), flush=True)
        return floor, tol

    shape = (N_BICG_STEP,) * 3
    # the first step's solve at 1e-6, else at the next decades up (phase
    # 24: float32 BiCGSTAB may not reach 1e-6 on a large grid)
    for bicg_step_tol in (1e-6, 1e-5, 1e-4, 1e-3):
        probe = make_projection_step(
            uniform_grid(shape), params_cg, torch.float32, Method.BICGSTAB,
            poisson_params=PoissonParams(tolerance=bicg_step_tol),
            device=dev)
        probe(tg_field(shape), 1e-4, 0)
        lp = probe.last_poisson
        print(f"phase 25 BiCGSTAB step {N_BICG_STEP}^3, the first step's "
              f"solve at tolerance {bicg_step_tol:g}: {int(lp.iterations)} "
              f"iterations, status {int(lp.status)}", flush=True)
        if int(lp.status) == PoissonStatus.CONVERGED:
            break
    del probe, lp
    out, bicg_step_ms, counts = iterative_step_paths(
        f"phase 25 BiCGSTAB step {N_BICG_STEP}^3 (tolerance "
        f"{bicg_step_tol:g})",
        shape, Method.BICGSTAB, PoissonParams(tolerance=bicg_step_tol),
        list(bk.WRAPPERS))
    for path in ("kernel", "plain"):
        if any(s != 0 for s in out[path][2]):
            fail(f"phase 25 BiCGSTAB step {path} path: nonzero status")
    launch_counts["bicg3d"] = counts
    hold_steps(f"phase 25 BiCGSTAB {CG_STEPS} steps", out, False)
    del out
    # the CG step on the same grid at the same tolerance, kernel path
    cg_same = iterative_step_paths(
        f"phase 25 CG step {N_BICG_STEP}^3 (tolerance {bicg_step_tol:g})",
        shape, Method.CG, PoissonParams(tolerance=bicg_step_tol),
        list(cgk.WRAPPERS), paths=("kernel",))
    print(f"phase 25 BiCGSTAB step {N_BICG_STEP}^3: "
          f"{bicg_step_ms['kernel']:.3f} ms a step, beside the CG step's "
          f"{cg_same[1]['kernel']:.3f} ms there ({cg_same[0]['kernel'][1]} "
          f"iterations) and {cg_ms['kernel']:.3f} ms at 256^3 (phase 14)",
          flush=True)
    bicg_step_ms["tolerance"] = bicg_step_tol
    bicg_step_ms["cg_same_grid"] = cg_same[1]["kernel"]
    del cg_same
    torch.cuda.empty_cache()

    shape = (N_SOR_STEP,) * 3

    def sor_step(pp):
        return make_projection_step(uniform_grid(shape), params_cg,
                                    torch.float32, Method.REDBLACK_SOR,
                                    poisson_params=pp, device=dev)

    sor_floor, sor_tol = stationary_floor(
        f"phase 25 RB-SOR step {N_SOR_STEP}^3", sor_step, tg_field(shape),
        SOR_FLOOR_SWEEPS)
    out, sor_step_ms, counts = iterative_step_paths(
        f"phase 25 RB-SOR step {N_SOR_STEP}^3", shape, Method.REDBLACK_SOR,
        PoissonParams(tolerance=sor_tol), [sk.rbsor_sweep])
    if out["kernel"][1:] != out["plain"][1:]:
        fail("phase 25 RB-SOR step: sweeps or statuses differ between paths")
    launch_counts["sor3d"] = {"rbsor_sweep": counts["rbsor_sweep"]}
    hold_steps(f"phase 25 RB-SOR {CG_STEPS} steps", out, False)
    sor_step_rec = {"ms": sor_step_ms, "sweeps": out["kernel"][1],
                    "statuses": out["kernel"][2], "floor": sor_floor,
                    "tolerance": sor_tol}
    del out
    shape = (N_JAC_STEP,) * 3
    out, jac_step_ms, counts = iterative_step_paths(
        f"phase 25 Jacobi step {N_JAC_STEP}^3", shape, Method.JACOBI,
        PoissonParams(), [vmem_small.jacobi_solve], warm=0)
    if out["kernel"][1:] != out["plain"][1:]:
        fail("phase 25 Jacobi step: iterations or statuses differ")
    hold_steps(f"phase 25 Jacobi {CG_STEPS} steps", out, True)
    jac_step_rec = {"ms": jac_step_ms, "sweeps": out["kernel"][1],
                    "statuses": out["kernel"][2]}
    del out
    torch.cuda.empty_cache()

    # ---- phase 26: 2D — Ghia with BiCGSTAB, the stationary cavities ------
    bw = vmem_small.bicgstab_solve
    bw.launches = bw.cluster_launches = 0
    ghia_gate("phase 26", 128, 100, 5e-4, GHIA_SOLVER_STEPS, 0.10,
              Method.BICGSTAB)
    launch_counts["bicg2d"] = {
        "bicgstab_solve[cluster]": solve_forms(
            bw, "phase 26", GHIA_SOLVER_STEPS, "cluster"),
        "bicgstab_solve": grid_cavity("phase 26 grid-wide",
                                      Method.BICGSTAB, bw)}

    def cavity(method, pp, plain, steps=CAVITY_STEPS, nc=128):
        """The lid cavity at Re = 100 (ghia_gate's loop), ``steps`` steps
        with the ``method`` pressure solve; returns the field, the
        statuses, the solves' iterations and relative residuals, and the
        host ms a step."""
        stepc = make_projection_step(
            Grid.uniform(nc, nc), NSParams(source_amplitude_u=0.0,
                                           source_amplitude_v=0.0,
                                           mu=1.0 / 100),
            torch.float32, method, poisson_params=pp, device=dev,
            plain=plain)
        lid, wall = DirichletValues(top=1.0), DirichletValues()
        fc = FlowField.quiescent(nc, nc, pressure=0.0, dtype=torch.float32,
                                 device=dev)
        stats, its, rel = [], [], []
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            fc = fc.replace(u=apply_dirichlet_scalar(fc.u, lid),
                            v=apply_dirichlet_scalar(fc.v, wall),
                            p=apply_neumann_scalar(fc.p))
            fc, rc = stepc(fc, 5e-4, i)
            lp = stepc.last_poisson
            stats.append(rc.status)
            its.append(lp.iterations)
            rel.append(lp.final_residual / lp.initial_residual)
        sync()
        ms_step = (time.perf_counter() - t0) * 1e3 / steps
        return (fc, [int(s) for s in stats], [int(t) for t in its],
                [float(r) for r in rel], ms_step)

    cavities = {}
    for method, name, ci in ((Method.REDBLACK_SOR, "rbsor_solve", 1),
                             (Method.JACOBI, "jacobi_solve", 10)):
        label = f"phase 26 cavity 128^2 {method.name}"
        _, _, _, rel, _ = cavity(method, PoissonParams(
            tolerance=0.0, max_iterations=SOR_FLOOR_SWEEPS,
            check_interval=ci), False)
        floor = max(rel)
        tol = 1e-6 if floor < 1e-6 else 10.0 ** math.ceil(math.log10(floor))
        print(f"{label}: float32 residual floor over {CAVITY_STEPS} steps "
              f"{floor:.3e} relative (first step {rel[0]:.3e}) after "
              f"{SOR_FLOOR_SWEEPS} sweeps at tolerance 0; the cavity runs "
              f"at tolerance {tol:g}"
              + ("" if tol == 1e-6 else " (the smallest decade above the "
                 "floor: 1e-6 is below it)"), flush=True)
        pp = PoissonParams(tolerance=tol, max_iterations=SOR_FLOOR_SWEEPS,
                           check_interval=ci)
        fn = getattr(vmem_small, name)
        fn.launches = 0
        fk, stats_k, its_k, _, ms_k = cavity(method, pp, False)
        launches = fn.launches
        fp, stats_p, its_p, _, ms_p = cavity(method, pp, True)
        print(f"{label} at tolerance {tol:g}: kernel {ms_k:.3f} ms a step "
              f"(host wall), plain {ms_p:.3f}; sweeps a step {its_k[:5]} .. "
              f"{its_k[-5:]}, statuses {sorted(set(stats_k))} "
              f"({stats_k.count(0)} of {CAVITY_STEPS} at 0); {name} "
              f"launches {launches}", flush=True)
        if (stats_k, its_k) != (stats_p, its_p):
            fail(f"{label}: statuses or sweeps differ between paths")
        if launches != CAVITY_STEPS:
            fail(f"{label}: not the whole-solve kernel once a step")
        for comp in "uv":
            compare(f"{label} {CAVITY_STEPS} steps", comp,
                    getattr(fk, comp), getattr(fp, comp), TOL_CG_UVW, False)
        close_p(f"{label} {CAVITY_STEPS} steps", fk.p, fp.p)
        launch_counts.setdefault("sor2d", {})[name] = launches
        cavities[method.name] = {"floor": floor, "tolerance": tol,
                                 "ms": ms_k, "plain_ms": ms_p,
                                 "converged_steps": stats_k.count(0)}

    # the cached poisson_solve with its default preset (Red-Black SOR) on
    # the card against the plain path, 100², an interior-mean-free rhs
    n = POISSON_N
    rhs_c = torch.randn((n, n), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    rhs_c[1:-1, 1:-1] -= rhs_c[1:-1, 1:-1].mean()
    x0_c = torch.zeros_like(rhs_c)
    frontend.clear_cache()
    vmem_small.rbsor_solve.launches = 0
    xk, it_k = frontend.poisson_solve(x0_c, rhs_c, n, n, 1.0 / (n - 1),
                                      1.0 / (n - 1), device=dev)
    plain_s = frontend.create_solver(Method.REDBLACK_SOR, device=dev,
                                     plain=True).init(
        n, n, 1, 1.0 / (n - 1), 1.0 / (n - 1))
    xp, st_p = plain_s.solve(x0_c, rhs_c)
    it_p = st_p.iterations if st_p.status == PoissonStatus.CONVERGED else -1
    print(f"phase 26 poisson_solve 100^2, default preset (REDBLACK_SIMD): "
          f"iterations {it_k} (plain {it_p}; -1 is not converged; plain "
          f"status {st_p.status.name} after {st_p.iterations} sweeps, "
          f"residual {st_p.final_residual:.4e} of "
          f"{st_p.initial_residual:.4e}), rbsor_solve launches "
          f"{vmem_small.rbsor_solve.launches}", flush=True)
    if it_k != it_p or vmem_small.rbsor_solve.launches != 1:
        fail("poisson_solve: iterations differ, or not the whole-solve "
             "kernel")
    compare("phase 26 poisson_solve", "x", xk, xp, *bit)

    # ---- phase 27: the HIGH kernels against their plain versions -------
    # the 3xTF32 GEMM (plane_dot at "high") at 37×23×11 and 512³, the
    # no-t forward sweep and the analytic back substitution at 512³, and
    # the 2D step's 3xTF32 products (x-DST at 2048², the rescue GEMM at
    # 2048² and 128²); the 3xTF32 GEMM and the SGEMM against a float64
    # product at depths 512 and 2048
    gemm_truth = {}

    def vs_float64(tag, a, b):
        """``a · b`` by the 3xTF32 GEMM and by the SGEMM against the
        float64 product of the same fp32 inputs, max error over
        max|truth|; the 3xTF32 error held to GEMM_VS_SGEMM times the
        SGEMM's."""
        truth = a.double() @ b.double()
        scale = float(truth.abs().max())
        errs = {}
        for prec in ("high", "highest"):
            got = rolling.right_dot(a, b, prec)
            errs[prec] = float((got.double() - truth).abs().max()) / scale
            del got
        print(f"  {tag} vs float64: 3xTF32 {errs['high']:.3e}, SGEMM "
              f"{errs['highest']:.3e} of max|truth| (bar: 3xTF32 at most "
              f"{GEMM_VS_SGEMM} x the SGEMM's)", flush=True)
        if not errs["high"] <= GEMM_VS_SGEMM * errs["highest"]:
            fail(f"{tag}: the 3xTF32 GEMM's error against float64 above "
                 f"{GEMM_VS_SGEMM} x the SGEMM's")
        gemm_truth[tag] = {"3xtf32": errs["high"], "sgemm": errs["highest"]}
        del truth
        torch.cuda.empty_cache()

    for shape in ((11, 23, 37), (N_BIG,) * 3):
        big = shape[0] == N_BIG
        tag = "x".join(map(str, shape[::-1]))
        print(f"phase 27 HIGH kernels vs plain at {tag}", flush=True)
        f, (fxt, fy, gxt, gy), mu, w, c = make_inputs(shape, SEED)
        nz_, ny_, nx_ = shape
        x = f.p
        dot_ops = 3 * (gemm_flops(nz_ * ny_, nx_, nx_)
                       + gemm_flops(ny_, nx_, ny_, nz_))
        rolling.reset_launch_counts()
        bhat = check(
            "3d-high", tag, big, rolling.plane_dot, HP_DOT, SRC_GEMM,
            lambda: rolling.plane_dot(x, fxt, fy, "high"),
            lambda: rolling.plane_dot_plain(x, fxt, fy, "high"),
            ("forward",), (gemm,),
            work=((x, fxt, fy), dot_ops),
            library=ieee_matmul(lambda: torch.einsum("ij,kjl,lm->kim", fy,
                                                     x, fxt)),
            name="plane_dot[3xtf32]", rate=TF32_TC_FLOPS)[0]
        if not big:
            continue
        no_element_loads(f"phase 27 plane_dot at {tag}", "high")
        vs_float64(f"phase 27 x·FxT at {tag} (depth {nx_})",
                   x.view(-1, nx_), fxt)
        cells = x.numel()
        d = check(
            "3d-high", tag, big, tdma.tdma_z_fwd_d, A1, SRC,
            lambda: tdma.tdma_z_fwd_d(bhat, mu, w),
            lambda: tdma.tdma_z_fwd_d_reference(bhat, mu, w),
            ("d'",), (exact,),
            work=((bhat, mu), FLOPS_PER_POINT["tdma_fwd"] * cells))[0]
        coef = torch.as_tensor(tdma._bwd_coeff_planes(
            mu.double().cpu().numpy(), w), device=dev)
        check("3d-high", tag, big, tdma.tdma_z_bwd_analytic, A2_ANALYTIC,
              SRC, lambda: tdma.tdma_z_bwd_analytic(d, coef),
              lambda: tdma.tdma_z_bwd_analytic_reference(d, coef),
              ("x^",), ((TOL_EXACT, True),),
              work=((d, coef), FLOPS_PER_POINT["tdma_bwd_analytic"]
                    * cells))
        del f, x, bhat, d, coef
        torch.cuda.empty_cache()
    tag = f"{N_2D}x{N_2D}"
    print(f"phase 27 2D HIGH products vs plain at {tag}", flush=True)
    grid2 = Grid.uniform(N_2D, N_2D)
    prob2 = PoissonProblem(N_2D, N_2D, 1, grid2.dx0, grid2.dy0)
    fxt, _, ysolve = make_dst2d_fused_pieces(prob2, torch.float32, dev,
                                             precision="high")
    bt = noisy(FlowField.initialize(grid2, dtype=torch.float32,
                                    device=dev), SEED).p
    rolling.reset_launch_counts()
    a = check("2d-high", tag, True, rolling.right_dot, HP_DOT, SRC_GEMM,
              lambda: rolling.right_dot(bt, fxt, "high"),
              lambda: rolling.right_dot_plain(bt, fxt, "high"),
              ("forward",), (gemm,),
              work=((bt, fxt), 3 * gemm_flops(N_2D, N_2D, N_2D)),
              library=ieee_matmul(lambda: torch.matmul(bt, fxt)),
              name="right_dot[3xtf32]", rate=TF32_TC_FLOPS)[0][0]
    no_element_loads(f"phase 27 right_dot at {tag}", "high")
    vs_float64(f"phase 27 bt·FxT at {tag} (depth {N_2D})", bt, fxt)
    rescue_checks("2d-high", tag, ysolve, a, "high", "rescue_dot[3xtf32]",
                  TF32_TC_FLOPS, ieee_matmul, True)
    del bt, a, fxt, ysolve
    torch.cuda.empty_cache()
    rescue_ghia("2d-high", "high", "rescue_dot[3xtf32]", TF32_TC_FLOPS,
                ieee_matmul)

    # ---- phase 28: the HIGH steps and the nz = 3 step ---------------------
    def high_counts(label, wrappers, gemms):
        """The HIGH path's counts: its wrappers', and the 3xTF32 launches
        of the GEMM wrappers, which must launch no SGEMM there."""
        counts = launches_of(wrappers)
        counts.update({f"{g.__name__}[3xtf32]": g.high_launches
                       for g in gemms})
        sgemm = {g.__name__: g.launches for g in gemms}
        print(f"{label} launch counts over the main path: {counts}; "
              f"SGEMM launches {sgemm}", flush=True)
        if min(counts.values()) <= 0 or max(sgemm.values()) != 0:
            fail(f"{label}: a HIGH kernel not launched, or an SGEMM "
                 f"launched")
        return counts

    def high_vs_highest(label, grid_h, params_h, shape, dt, u_bar,
                        p_bar=HIGH_P):
        """One kernel-path step at HIGH against one at HIGHEST from the
        same start, at the reference's HIGH bars times max(1, max|·|),
        u, v, w with what the measured max|Δp| passes on through the
        corrector, (dt/ρ)·Δp/(2d)·2; returns max|Δp|."""
        firsts = {}
        for prec in ("high", None):
            stepf = make_projection_step(grid_h, params_h, torch.float32,
                                         Method.FFT_DIRECT, device=dev,
                                         spectral_precision=prec)
            firsts[prec] = stepf(tg_field(shape), dt, 0)[0]
        sync()
        tag = f"{label} HIGH vs HIGHEST first step"

        def held(name, bar, passed=0.0):
            ref = getattr(firsts[None], name)
            scale = max(1.0, float(ref.abs().max()))
            return compare(tag, name, getattr(firsts["high"], name), ref,
                           bar * scale + passed, False)[0]

        dp = held("p", p_bar)
        held("u", u_bar, dt / grid_h.dx0 * dp)
        held("v", u_bar, dt / grid_h.dy0 * dp)
        held("w", u_bar, dt / grid_h.dz0 * dp if shape[0] > 1 else 0.0)
        err = dp
        del firsts
        torch.cuda.empty_cache()
        return err

    n = N_BIG
    # phase 4's configuration (bench.py:run_3d), and phase 6's in 2D
    grid = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                      mu=0.01)
    pkm.reset_launch_counts()
    # kernel and plain held after one step: each step's p difference (the
    # 3xTF32 GEMM against three IEEE products) passes on into u, v and w,
    # and later steps add to it
    ms3h, _ = timed_paths(28, f"{n}^3 HIGH", grid, params, (n, n, n), 1e-4,
                          TIMED_STEPS, pkm.WRAPPERS_HIGH,
                          first_step_only=True, precision="high")
    launch_counts["3d-high"] = high_counts(f"phase 28 {n}^3 HIGH",
                                           pkm.WRAPPERS_HIGH,
                                           (rolling.plane_dot,))
    no_element_loads(f"phase 28 {n}^3 HIGH", "high")
    dp3 = high_vs_highest(f"phase 28 {n}^3", grid, params, (n, n, n), 1e-4,
                          HIGH_U)
    print(f"phase 28 {n}^3 HIGH {ms3h['kernel']:.3f} ms/step against "
          f"HIGHEST {ms3['kernel']:.3f} (phase 4); first-step max|Δp| "
          f"{dp3:.3e}", flush=True)
    torch.cuda.empty_cache()
    grid_2d = Grid.uniform(n2, n2)
    pk2m.reset_launch_counts()
    ms2h, _ = timed_paths(28, f"{n2}^2 HIGH", grid_2d, params, (1, n2, n2),
                          1e-5, TIMED_STEPS_2D, pk2m.WRAPPERS_HIGH,
                          first_step_only=True, precision="high")
    launch_counts["2d-high"] = high_counts(
        f"phase 28 {n2}^2 HIGH", pk2m.WRAPPERS_HIGH,
        (rolling.right_dot, rolling.rescue_dot))
    no_element_loads(f"phase 28 {n2}^2 HIGH", "high")
    dp2 = high_vs_highest(f"phase 28 {n2}^2", grid_2d, params, (1, n2, n2),
                          1e-5, HIGH_U_2D)
    print(f"phase 28 {n2}^2 HIGH {ms2h['kernel']:.3f} ms/step against "
          f"HIGHEST {ms2['kernel']:.3f} (phase 6); first-step max|Δp| "
          f"{dp2:.3e}", flush=True)
    # the nz = 3 step (one interior plane: the standalone back
    # substitution and corr_all's DST form), both paths, then its kernels
    # against their plain versions at that shape
    tag3 = "x".join(map(str, N_NZ3[::-1]))
    grid3 = uniform_grid(N_NZ3)
    pkm.reset_launch_counts()
    ms_nz3, counts_nz3 = timed_paths(28, tag3, grid3, params, N_NZ3, 1e-4,
                                     TIMED_STEPS, pkm.WRAPPERS)
    launch_counts["nz3"] = counts_nz3
    # ... and at HIGH: the 3xTF32 DST products, the stored back
    # substitution (the reference demotes the analytic one at nz = 3)
    nz3_high = (pkm.predictor_star, pkm.poisson_input, tdma.tdma_z_fwd,
                tdma.tdma_z_bwd, pkm.corrector)
    pkm.reset_launch_counts()
    ms_nz3h, _ = timed_paths(28, f"{tag3} HIGH", grid3, params, N_NZ3, 1e-4,
                             TIMED_STEPS, nz3_high, precision="high")
    launch_counts["nz3-high"] = high_counts(f"phase 28 {tag3} HIGH",
                                            nz3_high, (rolling.plane_dot,))
    no_element_loads(f"phase 28 {tag3} HIGH", "high")
    f, (fxt, fy, gxt, gy), mu, w, c = make_inputs(N_NZ3, SEED)
    cells = f.u.numel()
    rod = torch.full((), 1e3, device=dev)
    bt = pkm.poisson_input_plain(f.u, f.v, f.w, f.p, rod, c)
    print(f"phase 28 nz=3 kernels vs plain at {tag3}", flush=True)
    bhat = check(
        "nz3", tag3, True, rolling.plane_dot, DOT, SRC_SGEMM,
        lambda: rolling.plane_dot(bt, fxt, fy),
        lambda: rolling.plane_dot_plain(bt, fxt, fy), ("forward",),
        (gemm,), work=((bt, fxt, fy),
                       gemm_flops(3 * n, n, n) + gemm_flops(n, n, n, 3)),
        library=ieee_matmul(lambda: torch.einsum("ij,kjl,lm->kim", fy, bt,
                                                 fxt)))[0]
    check("nz3-high", tag3, True, rolling.plane_dot, HP_DOT, SRC_GEMM,
          lambda: rolling.plane_dot(bt, fxt, fy, "high"),
          lambda: rolling.plane_dot_plain(bt, fxt, fy, "high"),
          ("forward",), (gemm,),
          work=((bt, fxt, fy), 3 * (gemm_flops(3 * n, n, n)
                                    + gemm_flops(n, n, n, 3))),
          library=ieee_matmul(lambda: torch.einsum("ij,kjl,lm->kim", fy,
                                                   bt, fxt)),
          name="plane_dot[3xtf32]", rate=TF32_TC_FLOPS)
    d, t = check(
        "nz3", tag3, True, tdma.tdma_z_fwd, A1, SRC,
        lambda: tdma.tdma_z_fwd(bhat, mu, w),
        lambda: tdma.tdma_z_fwd_reference(bhat, mu, w), ("d'", "t"),
        (exact, exact),
        work=((bhat, mu), FLOPS_PER_POINT["tdma_fwd"] * cells))
    xhat = check(
        "nz3", tag3, True, tdma.tdma_z_bwd, A4_BWD, SRC,
        lambda: tdma.tdma_z_bwd(d, t),
        lambda: tdma.tdma_z_bwd_reference(d, t), ("x^",), (exact,),
        work=((d, t), FLOPS_PER_POINT["tdma_bwd"] * cells))[0]
    p3 = rolling.plane_dot_plain(xhat, gxt, gy)
    s3 = torch.full((), 1e-3, device=dev)
    check("nz3", tag3, True, pkm.corrector, A5_CORR, SRC,
          lambda: pkm.corrector(f.u, f.v, f.w, p3, s3, c),
          lambda: pkm.corrector_plain(f.u, f.v, f.w, p3, s3, c),
          ("u", "v", "w", "max|u|^2", "max p", "max|p|"),
          (fld,) * 3 + ((TOL_DIAG, True), gemm, gemm),
          work=((f.u, f.v, f.w, p3), FLOPS_PER_POINT["corrector"] * cells))
    del f, bt, bhat, d, t, xhat, p3
    torch.cuda.empty_cache()

    # ---- phase 29: Ghia Re = 100 at 128², HIGH ------------------------------
    rolling.reset_launch_counts()
    rms_high = ghia_gate("phase 29", 128, 100, 5e-4, GHIA_SOLVER_STEPS,
                         0.10, precision="high")
    print(f"phase 29 Ghia at HIGH: rms_u {rms_high[0]:.5f} rms_v "
          f"{rms_high[1]:.5f} against HIGHEST {rms_highest[0]:.5f} / "
          f"{rms_highest[1]:.5f} (phase 7); 3xTF32 launches right_dot "
          f"{rolling.right_dot.high_launches}, rescue_dot "
          f"{rolling.rescue_dot.high_launches}; SGEMM launches "
          f"{rolling.right_dot.launches + rolling.rescue_dot.launches}",
          flush=True)
    if rolling.right_dot.high_launches <= 0 \
            or rolling.rescue_dot.high_launches <= 0 \
            or rolling.right_dot.launches or rolling.rescue_dot.launches:
        fail("phase 29: the HIGH cavity did not run the 3xTF32 GEMMs")
    no_element_loads("phase 29 Ghia at HIGH", "high")
    launch_counts["ghia-high"] = {
        "right_dot[3xtf32]": rolling.right_dot.high_launches,
        "rescue_dot[3xtf32]": rolling.rescue_dot.high_launches}

    # ---- phase 30: FFT_DIRECT, SOR and Gauss-Seidel through the front end
    # FFT_DIRECT on cg_512's problem: the kernel solve (float32, the
    # SGEMM), held against the plain solve on the card (plain=True) and
    # beside the float64 solve (the plain form, which float64 takes);
    # then the eigen z-product's SGEMM against its plain version
    n = N_BIG
    _, prob = cg_problem((n, n, n))
    gen = torch.Generator(device=dev).manual_seed(7)
    rhs = prob.zero_boundary(torch.randn((n, n, n), generator=gen,
                                         device=dev))
    x0 = torch.zeros_like(rhs)
    fft = frontend.create_solver(Method.FFT_DIRECT, device=dev).init(
        n, n, n, prob.dx, prob.dy, prob.dz)
    fft.solve_result(x0, rhs)                   # warm-up, same pattern
    sync()
    rolling.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fft.solve_result(x0, rhs)
    end.record()
    sync()
    ms_fft = start.elapsed_time(end)
    fft_counts = {"plane_dot": rolling.plane_dot.launches,
                  "left_dot": rolling.left_dot.launches}
    launch_counts["fft"] = fft_counts
    # the true residual of the system the solve solved (the start's shell,
    # zero), in float64, as phase 13's
    xd, rd = prob.zero_boundary(res.x.double()), rhs.double()
    true_fft = float(prob.interior(prob.laplacian(xd) - rd).norm()
                     / prob.interior(rd).norm())
    del xd, rd
    print(f"phase 30 FFT_DIRECT on cg_512's problem (512^3) through the "
          f"front end: status {int(res.status)}, {int(res.iterations)} "
          f"iteration, {ms_fft:.3f} ms a solve (cg_512 {cg512['ms']:.1f} "
          f"ms, phase 13), CG-convention residual "
          f"{float(res.final_residual):.4e}, true relative residual "
          f"{true_fft:.4e}; SGEMM launches {fft_counts}", flush=True)
    if int(res.status) != PoissonStatus.CONVERGED or not true_fft < 1e-3:
        fail("phase 30 FFT_DIRECT: not converged, or true residual above "
             "1e-3")
    if min(fft_counts.values()) <= 0:
        fail("phase 30 FFT_DIRECT: the SGEMM did not run")
    rolling.reset_launch_counts()
    plain_fft = frontend.create_solver(Method.FFT_DIRECT, device=dev,
                                       plain=True).init(
        n, n, n, prob.dx, prob.dy, prob.dz)
    x_plain = plain_fft.solve_result(x0, rhs).x
    x_64 = fft.solve_result(x0.double(), rhs.double()).x
    sync()
    stray = rolling.plane_dot.launches + rolling.left_dot.launches
    print(f"phase 30 FFT_DIRECT plain=True and float64 on the card: "
          f"{stray} GEMM launches", flush=True)
    if stray:
        fail("phase 30 FFT_DIRECT: the plain or float64 solve launched a "
             "GEMM")
    scale64 = float(x_64.abs().max())
    fft_err64 = {k: float((v.double() - x_64).abs().max()) / scale64
                 for k, v in (("kernel", res.x), ("plain", x_plain))}
    print(f"phase 30 FFT_DIRECT against the float64 solve, of max|x|: "
          f"kernel {fft_err64['kernel']:.3e}, plain "
          f"{fft_err64['plain']:.3e}", flush=True)
    compare("phase 30 FFT_DIRECT kernel vs plain", "x", res.x, x_plain,
            *gemm)
    del x_plain, x_64, plain_fft
    torch.cuda.empty_cache()
    fz = torch.as_tensor(spectral._padded_forward(n - 2, n, np.float32),
                         device=dev)
    zin = res.x.view(n, -1)
    print(f"phase 30 eigen z-product vs plain at {n}x{n * n}", flush=True)
    check("fft", f"{n}x{n}x{n}", True, rolling.left_dot, EIGEN_Z, SRC_SGEMM,
          lambda: rolling.left_dot(fz, zin),
          lambda: rolling.left_dot_plain(fz, zin), ("Fz·x",), (gemm,),
          work=((fz, zin), gemm_flops(n, n * n, n)),
          library=ieee_matmul(lambda: torch.matmul(fz, zin)))
    fft_rec = {"ms": ms_fft, "true_rel_residual": true_fft,
               "launches": fft_counts, "vs_float64": fft_err64}
    del rhs, x0, res, fft, zin
    torch.cuda.empty_cache()
    # SOR (an SOR preset of the cached API) and Gauss-Seidel (the front
    # end) at 33² in float64: plain torch launches on the card (no kernel:
    # none exists in the reference), ~6 s a solve, against the same SOR
    # solve on the CPU
    n = SOR_N
    h = 1.0 / (n - 1)
    rhs_c = torch.randn((n, n), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev, dtype=torch.float64)
    rhs_c[1:-1, 1:-1] -= rhs_c[1:-1, 1:-1].mean()
    x0_c = torch.zeros_like(rhs_c)
    sor_rec = {}
    for label, run in (
            ("SOR_SCALAR", lambda: frontend.poisson_solve(
                x0_c, rhs_c, n, n, h, h, frontend.SolverPreset.SOR_SCALAR,
                device=dev)),
            ("GAUSS_SEIDEL", lambda: frontend.create_solver(
                Method.GAUSS_SEIDEL, device=dev).init(n, n, 1, h, h).solve(
                x0_c, rhs_c))):
        frontend.clear_cache()
        sync()
        t0 = time.perf_counter()
        x_s, out = run()
        sync()
        if label == "SOR_SCALAR":
            x_sor = x_s
        ms_s = (time.perf_counter() - t0) * 1e3
        sweeps = out if isinstance(out, int) else (
            out.iterations if out.status == PoissonStatus.CONVERGED else -1)
        sor_rec[label] = {"sweeps": sweeps, "ms": ms_s,
                          "ms_a_sweep": ms_s / max(sweeps, 1)}
        print(f"phase 30 {label} {n}^2 float64 on the card: {sweeps} "
              f"sweeps (-1 is not converged), {ms_s:.1f} ms host wall, "
              f"{ms_s / max(sweeps, 1):.3f} ms a sweep", flush=True)
        if sweeps <= 0:
            fail(f"phase 30 {label}: not converged")
    xc, it_c = frontend.poisson_solve(x0_c.cpu(), rhs_c.cpu(), n, n, h, h,
                                      frontend.SolverPreset.SOR_SCALAR,
                                      device="cpu")
    print(f"phase 30 SOR_SCALAR on the CPU: {it_c} sweeps", flush=True)
    if it_c != sor_rec["SOR_SCALAR"]["sweeps"]:
        fail("phase 30 SOR: sweeps differ between the card and the CPU")
    compare("phase 30 SOR card vs CPU", "x", x_sor.cpu(), xc, 1e-12, True)

    # ---- phase 31: the buoyant and thermal kernels against their plain
    # versions: the buoyant predictor (3D and 2D) and the Euler and RK
    # kernels with the energy update, buoyancy and mixed thermal faces
    # (Dirichlet, Neumann and periodic), bit-equal
    t_phase = time.perf_counter()

    def thermal_params(faces):
        """Energy, buoyancy and the thermal ``faces`` (BCType names)."""
        names = ("left", "right", "bottom", "top", "back", "front")
        return NSParams(
            alpha=ALPHA_EXPL, beta=BETA, T_ref=T_REF,
            gravity=(0.5, -9.81, 2.0), thermal_bc=ThermalBCConfig(
                **{k: BCType[f] for k, f in zip(names, faces)},
                dirichlet_values=DirichletValues(
                    left=T_HOT, right=T_COLD, bottom=T_HOT, top=T_COLD,
                    back=T_HOT, front=T_COLD)))

    def buoyant_check(tag, timed, u, v, w, T, scal, c):
        """The buoyant predictor (3D or 2D by u's shape) against its plain
        version on the same inputs, bit-equal; ``tag`` names the phase
        and the case."""
        print(f"{tag}: buoyant predictor vs plain", flush=True)
        three_d = u.shape[0] > 1
        pw = pkm.predictor_star if three_d else pk2m.predictor_star_2d
        check("buoy3d" if three_d else "buoy2d", tag, timed, pw,
              A1_BUOY if three_d else P2_BUOY, SRC if three_d else SRC_2D,
              lambda: pw(u, v, w, scal, c, T),
              lambda: pkm.predictor_star_plain(u, v, w, scal, c, T),
              ("u*", "v*", "w*"), (exact,) * 3,
              work=((u, v, w, T, scal),
                    FLOPS_PER_POINT["predictor_star_buoyant"] * u.numel()))

    def dvd_case():
        """bench.py:dvd_gate's configuration (`:736-776`): the grid, the
        parameters, α, and the quiescent start with T linear in x (the
        no-slip walls the march applies leave it as it is)."""
        nd = N_DVD
        nu_alpha = 9.81 * DVD_BETA * (T_HOT - T_COLD) / 1e4
        alpha_d = math.sqrt(nu_alpha / 0.71)
        params_d = NSParams(
            dt=DVD_DT, mu=0.71 * alpha_d, alpha=alpha_d, beta=DVD_BETA,
            T_ref=T_REF, gravity=(0.0, -9.81, 0.0), max_iter=1,
            source_amplitude_u=0.0, source_amplitude_v=0.0,
            thermal_bc=ThermalBCConfig(
                left=BCType.DIRICHLET, right=BCType.DIRICHLET,
                top=BCType.NEUMANN, bottom=BCType.NEUMANN,
                dirichlet_values=DirichletValues(left=T_HOT, right=T_COLD)))
        xd = torch.linspace(0.0, 1.0, nd, device=dev)
        fd = FlowField.quiescent(nd, nd, pressure=0.0, dtype=torch.float32,
                                 device=dev)
        fd = fd.replace(T=(T_HOT - (T_HOT - T_COLD) * xd)[None, None, :]
                        .expand(1, nd, nd).contiguous())
        return Grid.uniform(nd, nd), params_d, alpha_d, fd

    buoy_params = NSParams(beta=BETA, T_ref=T_REF, gravity=(0.0, -9.81, 2.0))
    for shape in ((11, 23, 37), (N_BIG,) * 3, (1, 23, 37), (1, N_2D, N_2D)):
        nz, ny, nx = shape
        three_d = nz > 1
        tag = "x".join(map(str, shape[::-1] if three_d else shape[:0:-1]))
        grid = uniform_grid(shape)
        f = noisy(FlowField.initialize(grid, dtype=torch.float32,
                                       device=dev), SEED)
        T = f.T + torch.randn(shape, generator=torch.Generator(
            device=dev).manual_seed(SEED + 1), device=dev)
        c = pkm.stencil_consts(nz, ny, nx, grid.dx0, grid.dy0, grid.dz0,
                               grid.xmin, grid.ymin, NSParams().mu, True,
                               buoy_params)
        scal = torch.tensor([1e-3, 0.1, 0.05], device=dev)
        buoyant_check(f"phase 31 {tag}", nx == N_BIG, f.u, f.v, f.w, T,
                      scal, c)
        del f, T
        torch.cuda.empty_cache()
    # the 2D one where the main path runs it, timed there: the de Vahl
    # Davis march's first step (phase 34), with the consts and the
    # scalars (dt, 0, 0) its step builds
    grid_d, params_d, _, fd0 = dvd_case()
    consts_d = pk2m.Projection2DKernels(
        N_DVD, N_DVD, grid_d.dx0, grid_d.dy0, grid_d.xmin, grid_d.ymin,
        params_d.mu, with_sources=False, emit="rhs", params=params_d).consts
    scal_d = torch.tensor([DVD_DT, 0.0, 0.0], device=dev)
    buoyant_check(f"phase 31 {N_DVD}x{N_DVD} de Vahl Davis start", True,
                  fd0.u, fd0.v, fd0.w, fd0.T, scal_d, consts_d)
    del fd0
    for shape in ((11, 23, 37), (N_EXPL,) * 3, (1, 23, 37), (1, N_2D, N_2D)):
        nz, ny, nx = shape
        three_d = nz > 1
        big = nx in (N_EXPL, N_2D)
        tag = "x".join(map(str, shape[::-1] if three_d else shape[:0:-1]))
        grid = uniform_grid(shape)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def rnd(scale, shape=shape, gen=gen):
            return scale * torch.randn(shape, generator=gen, device=dev)

        f = FlowField.initialize(grid, dtype=torch.float32, device=dev)
        rho = f.rho + rnd(0.01)
        rho[nz // 2, ny // 2, nx // 2] = 1e-12   # the per-point ρ guard
        f = FlowField(u=f.u + rnd(0.3), v=f.v + rnd(0.3), w=rnd(0.3),
                      p=f.p + rnd(0.3), rho=rho, T=f.T + rnd(1.0))
        sy, sx = source_basis(grid, torch.float32, dev)
        cells = f.u.numel()
        ew = ekm.euler_step if three_d else e2m.euler2d_step
        sw = rkm.rk_stage if three_d else rk2m.rk2d_stage
        q0 = (f.u, f.v, f.w, f.p)
        st = tuple(x + rnd(0.01) for x in q0)
        acc = tuple(rnd(5.0) for _ in range(4))
        for faces_name, faces in THERMAL_FACE_MIXES.items():
            print(f"phase 31 thermal explicit kernels vs plain at {tag}, "
                  f"faces {faces_name}", flush=True)
            timed = big and faces_name == "mixed"
            th = ekm.ThermalConsts.from_params(thermal_params(faces),
                                               torch.float32)
            c = ekm.ExplicitConsts(nz, ny, nx, grid.dx0, grid.dy0,
                                   grid.dz0, 0.01, 0.1, th)
            ins = (f.u, f.v, f.w, f.p, f.T, f.rho, sy, sx,
                   torch.tensor([1e-4, 0.08, 0.04], device=dev))
            check("euler3d-thermal" if three_d else "euler2d-thermal",
                  f"{tag} {faces_name}", timed, ew, E3 if three_d else E2,
                  SRC_E, lambda: ew(*ins, c),
                  lambda: ekm.euler_step_plain(*ins, c), names6 + maxima4,
                  (exact,) * 10,
                  work=(ins, FLOPS_PER_POINT["euler_thermal"] * cells))
            for label, a, final, fac, mix, wgt in (
                    ("first", None, False, 5e-5, 0.0, 1.0),
                    ("mid", acc, False, 5e-5, 0.0, 2.0),
                    ("final", acc, True, 1e-4 / 6.0, 1.0, 0.0)):
                sc = torch.tensor([fac, mix, wgt, 0.08, 0.04, 1e-4],
                                  device=dev)
                read = (*st, *q0, f.rho, f.T, *(a or ()), sy, sx, sc)
                outs = (names6 + maxima4 if final else
                        tuple(f"next {n}" for n in "uvwp")
                        + tuple(f"acc {n}" for n in "uvwp"))
                check("rk3d-thermal" if three_d else "rk2d-thermal",
                      f"{tag} {faces_name} {label}",
                      timed and label == "final", sw,
                      RK3 if three_d else RK2, SRC_RK,
                      lambda: sw(st, q0, f.rho, f.T, a, sy, sx, sc, c,
                                 final),
                      lambda: rkm.rk_stage_plain(st, q0, f.rho, f.T, a, sy,
                                                 sx, sc, c, final),
                      outs, (exact,) * len(outs),
                      work=(read, FLOPS_PER_POINT["rk_stage_thermal"]
                            * cells))
        del f, rho, q0, st, acc
        torch.cuda.empty_cache()
    print(f"phase 31 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 32: bc_refresh ----------------------------------------------
    # bench.py:run_bc_refresh: run_3d's / run_2d's Taylor-Green field with
    # the driven-lid hook (_lid_refresh, bench.py:162-168) at dt = 1e-4,
    # 512³ at HIGHEST and HIGH and 2048² (past the explicit viscous limit,
    # so kernel and plain are held after one step; the 20 timed steps come
    # before the clamps, status 0, as in phase 6); the launch counts show
    # predictor_star, the hook, then poisson_input on the path
    t_phase = time.perf_counter()

    def lid_refresh(u, v, w, t):
        """The driven-lid hook; it writes the predictor's own tensors in
        place (the step hands it fresh ones)."""
        u[:, 0, :] = 0.0
        u[:, -1, :] = 1.0
        v[:, 0, :] = 0.0
        v[:, -1, :] = 0.0
        return u, v, w

    def bc_counts(label, wrappers, key):
        counts = {fn.__name__: fn.launches for fn in wrappers}
        print(f"{label} launch counts over the main path: {counts}",
              flush=True)
        if min(counts.values()) <= 0:
            fail(f"{label}: a kernel of the bc_refresh path not launched")
        star = [v for k, v in counts.items() if k.startswith("predictor")]
        bt = [v for k, v in counts.items() if k.startswith("poisson")]
        if star != bt:
            fail(f"{label}: predictor and b~ launches differ")
        launch_counts[key] = counts
        return counts

    bc_ms = {}
    n = N_BIG
    grid = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    for prec, wrappers, key in ((None, pkm.WRAPPERS, "bc3d"),
                                ("high", pkm.WRAPPERS_HIGH, "bc3d-high")):
        pkm.reset_launch_counts()
        ms_bc, _ = timed_paths(32, f"{n}^3 bc_refresh {prec or 'highest'}",
                               grid, params, (n, n, n), 1e-4, TIMED_STEPS,
                               wrappers, first_step_only=True,
                               precision=prec, bc_refresh=lid_refresh)
        bc_counts(f"phase 32 {n}^3 bc_refresh {prec or 'highest'}",
                  wrappers, key)
        bc_ms[f"{n}^3 {prec or 'highest'}"] = ms_bc
    n2 = N_2D
    pk2m.reset_launch_counts()
    bc_ms[f"{n2}^2"], _ = timed_paths(
        32, f"{n2}^2 bc_refresh", Grid.uniform(n2, n2), params,
        (1, n2, n2), 1e-4, TIMED_STEPS_2D, pk2m.WRAPPERS,
        first_step_only=True, bc_refresh=lid_refresh)
    bc_counts(f"phase 32 {n2}^2 bc_refresh", pk2m.WRAPPERS, "bc2d")
    for key, ms_bc in bc_ms.items():
        cells = (N_BIG ** 3) if "^3" in key else N_2D ** 2
        base = {f"{N_BIG}^3 highest": ms3, f"{N_BIG}^3 high": ms3h,
                f"{N_2D}^2": ms2}[key]
        print(f"phase 32 bc_refresh {key}: {ms_bc['kernel']:.3f} ms/step "
              f"({cells / (ms_bc['kernel'] * 1e-3) / 1e6:.1f} MLUPS) "
              f"against {base['kernel']:.3f} without the hook", flush=True)
    # the CG step with the hook at 256³ (run_3d's physics): 3 timed steps
    # on the kernel path, its first step held against the plain path
    n = N_CG
    grid_cg = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    pkm.reset_launch_counts()
    cgk.lap_dot.launches = cgk.cg_update.launches = 0
    firsts = {}
    for path in ("kernel", "plain"):
        stepf = make_projection_step(grid_cg, params, torch.float32,
                                     Method.CG, device=dev,
                                     plain=path == "plain",
                                     bc_refresh=lid_refresh)
        firsts[path], r1 = stepf(tg_field((n, n, n)), 1e-4, 0)
        if path == "plain":
            break
        f2 = firsts[path]
        sync()
        t0 = time.perf_counter()
        for i in range(1, 1 + CG_STEPS):
            f2, r2 = stepf(f2, 1e-4, i)
            if int(r2.status) != 0:
                fail(f"phase 32 CG {n}^3 bc_refresh: status "
                     f"{int(r2.status)}")
        sync()
        ms_cgbc = (time.perf_counter() - t0) * 1e3 / CG_STEPS
        counts = {fn.__name__: fn.launches for fn in pkm.WRAPPERS_RHS}
        counts.update(lap_dot=cgk.lap_dot.launches,
                      cg_update=cgk.cg_update.launches)
        print(f"phase 32 CG {n}^3 bc_refresh kernel path: {ms_cgbc:.2f} "
              f"ms/step (phase 14 without the hook {cg_ms['kernel']:.2f}), "
              f"status {int(r2.status)}, {int(stepf.last_poisson.iterations)}"
              f" iterations in the last solve; launch counts {counts}",
              flush=True)
        if min(counts.values()) <= 0:
            fail("phase 32 CG bc_refresh: a kernel not launched")
        launch_counts["bc3d-cg"] = counts
        bc_ms[f"cg {n}^3"] = ms_cgbc
    for name in "uvw":
        compare(f"phase 32 CG {n}^3 bc_refresh first step", name,
                getattr(firsts["kernel"], name),
                getattr(firsts["plain"], name), TOL_CG_UVW, False)
    compare(f"phase 32 CG {n}^3 bc_refresh first step", "p",
            firsts["kernel"].p, firsts["plain"].p, 1e-3, True)
    del firsts, f2
    torch.cuda.empty_cache()
    # examples/pulsatile_inlet_flow.py's channel at 1024×512: sinusoidal
    # inlet, no-slip walls and a zero-gradient outlet applied before each
    # step and as the hook, the spectral solve, dt under the viscous limit
    nxp, nyp = PULSE
    grid_p = Grid.uniform(nxp, nyp, xmin=0.0, xmax=2.0, ymin=0.0, ymax=1.0)
    params_p = NSParams(dt=PULSE_DT, mu=0.05, max_iter=1,
                        source_amplitude_u=0.0, source_amplitude_v=0.0)
    inlet = InletConfig.time_sinusoidal(1.0, 0.0, frequency=2.0,
                                        amplitude=0.5, phase=0.0,
                                        offset=1.0)
    outlet = OutletConfig.zero_gradient()

    def channel_bcs(u, v, w, t):
        u, v = apply_noslip(u, v)
        u, v = apply_inlet(u, v, inlet, time=t, dt=PULSE_DT)
        u, v = apply_outlet_velocity(u, v, outlet)
        return u, v, w

    finals = {}
    for path in ("kernel", "plain"):
        pk2m.reset_launch_counts()
        tdma.tdma_z_fwd.launches = tdma.tdma_z_bwd.launches = 0
        stepf = make_projection_step(grid_p, params_p, torch.float32,
                                     Method.FFT_DIRECT, device=dev,
                                     plain=path == "plain",
                                     bc_refresh=channel_bcs)
        fc = FlowField.quiescent(nxp, nyp, pressure=0.0,
                                 dtype=torch.float32, device=dev)
        worst = torch.zeros((), dtype=torch.int32, device=dev)
        sync()
        t0 = time.perf_counter()
        for i in range(PULSE_STEPS):
            t_i = torch.full((), i * PULSE_DT, device=dev)
            u, v, _ = channel_bcs(fc.u, fc.v, fc.w, t_i)
            fc, rc = stepf(fc.replace(u=u, v=v), PULSE_DT, i)
            worst = torch.maximum(worst, rc.status.abs())
        sync()
        ms_p = (time.perf_counter() - t0) * 1e3 / PULSE_STEPS
        print(f"phase 32 pulsatile channel {nxp}x{nyp} {path} path: "
              f"{PULSE_STEPS} steps, {ms_p:.3f} ms/step host wall, worst "
              f"status {int(worst)}, inlet u at mid-height "
              f"{float(fc.u[0, nyp // 2, 0]):.4f}", flush=True)
        if int(worst) != 0 or not bool(fc.is_finite()):
            fail(f"phase 32 pulsatile channel {path}: a nonzero status")
        if path == "kernel":
            bc_counts("phase 32 pulsatile channel", pk2m.WRAPPERS,
                      "bc2d-channel")
            if tdma.tdma_z_fwd.launches or tdma.tdma_z_bwd.launches:
                fail("phase 32 pulsatile channel: the 2D step launched the "
                     "z-line Thomas kernels")
            bc_ms[f"channel {nxp}x{nyp}"] = ms_p
        finals[path] = fc
    for name in "uv":
        compare(f"phase 32 pulsatile channel {PULSE_STEPS} steps", name,
                getattr(finals["kernel"], name),
                getattr(finals["plain"], name), TOL_FIELD, False)
    compare(f"phase 32 pulsatile channel {PULSE_STEPS} steps", "p",
            finals["kernel"].p, finals["plain"].p, TOL_GEMM, True)
    del finals, fc
    torch.cuda.empty_cache()
    print(f"phase 32 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 33: buoyancy and the energy equation on the main paths ----
    # the 512³ spectral step: run_3d's field with T linear in z (hot back,
    # cold front: Dirichlet), Neumann sides, g = (0, 0, −9.81)
    t_phase = time.perf_counter()
    n = N_BIG
    grid = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    params_buoy = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                        mu=0.01, alpha=ALPHA_3D, beta=BETA, T_ref=T_REF,
                        gravity=(0.0, 0.0, -9.81),
                        thermal_bc=ThermalBCConfig(
                            left=BCType.NEUMANN, right=BCType.NEUMANN,
                            bottom=BCType.NEUMANN, top=BCType.NEUMANN,
                            back=BCType.DIRICHLET, front=BCType.DIRICHLET,
                            dirichlet_values=DirichletValues(
                                back=T_HOT, front=T_COLD)))

    def tg_field_t_z(shape):
        f = tg_field(shape)
        z = torch.linspace(0.0, 1.0, shape[0], device=dev)
        return f.replace(T=(T_HOT - (T_HOT - T_COLD) * z)[:, None, None]
                         .expand(shape).contiguous())

    pkm.reset_launch_counts()
    ms_b, counts_b = timed_paths(33, f"{n}^3 buoyant + energy", grid,
                                 params_buoy, (n, n, n), 1e-4, TIMED_STEPS,
                                 pkm.WRAPPERS, first_step_only=True,
                                 field_fn=tg_field_t_z)
    launch_counts["buoy3d"] = counts_b
    # the energy post-step alone, at the step's sizes
    post = thermal_post_step(grid, params_buoy)
    fb = tg_field_t_z((n, n, n))
    ms_post = cuda_ms(lambda: post(fb, torch.full((), 1e-4, device=dev)))
    del fb
    torch.cuda.empty_cache()
    print(f"phase 33 {n}^3 buoyant + energy: {ms_b['kernel']:.3f} ms/step "
          f"(plain {ms_b['plain']:.3f}; without either {ms3['kernel']:.3f}, "
          f"phase 4); the energy post-step {ms_post:.3f} ms, "
          f"{ms_post / ms_b['kernel']:.3f} of the step", flush=True)
    # the explicit steps at bench.py's sizes with energy, buoyancy and the
    # mixed thermal faces, from run_euler_3d's field with T linear in x

    def tg_field_t_x(shape):
        f = tg_field(shape)
        x = torch.linspace(0.0, 1.0, shape[2], device=dev)
        return f.replace(T=(T_HOT - (T_HOT - T_COLD) * x)[None, None, :]
                         .expand(shape).contiguous())

    params_e = thermal_params(THERMAL_FACE_MIXES["mixed"]).replace(
        source_amplitude_u=0.0, source_amplitude_v=0.0, mu=0.01)
    n3, n2e = (N_EXPL,) * 3, (1, N_2D, N_2D)
    for method, shape, n_steps, key, wrapper in (
            ("euler", n3, 10, "euler3d-thermal", ekm.euler_step),
            ("rk2", n3, 10, "rk3d-thermal", rkm.rk_stage),
            ("rk4", n3, 10, "rk3d-thermal", rkm.rk_stage),
            ("euler", n2e, 20, "euler2d-thermal", e2m.euler2d_step),
            ("rk2", n2e, 10, "rk2d-thermal", rk2m.rk2d_stage)):
        explicit_path(method, shape, n_steps, key, wrapper,
                      params=params_e, field_fn=tg_field_t_x)
    torch.cuda.empty_cache()
    print(f"phase 33 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 34: de Vahl Davis Ra = 1e4 at 128² (bench.py:dvd_gate) ----
    t_phase = time.perf_counter()
    nd = N_DVD
    dxd = 1.0 / (nd - 1)

    def nu_avg_of(T_field):
        """The hot wall's average Nusselt number of a de Vahl Davis T
        field (1, nd, nd): the one-sided second-order wall gradient of
        the scaled T, trapezoid-averaged along the wall."""
        Ts = (T_field[0].double().cpu().numpy() - T_COLD) / (T_HOT - T_COLD)
        nu_local = -(-3 * Ts[:, 0] + 4 * Ts[:, 1] - Ts[:, 2]) / (2 * dxd)
        wts = np.ones(nd)
        wts[0] = wts[-1] = 0.5
        return float((wts * nu_local).sum() * dxd)

    grid_d, params_d, alpha_d, fd = dvd_case()
    if not DVD_DT < dxd * dxd / (4 * alpha_d):
        fail("phase 34: dt exceeds the thermal stability bound")
    step_d = make_projection_step(grid_d, params_d, torch.float32,
                                  Method.FFT_DIRECT, device=dev)
    noslip = DirichletValues()
    pk2m.reset_launch_counts()
    worst = torch.zeros((), dtype=torch.int32, device=dev)
    prev_ke, steps_done = None, 0
    sync()
    t0 = time.perf_counter()
    while steps_done < DVD_MAX_STEPS:
        for i in range(steps_done, steps_done + DVD_CHUNK):
            fd = fd.replace(u=apply_dirichlet_scalar(fd.u, noslip),
                            v=apply_dirichlet_scalar(fd.v, noslip))
            fd, rd = step_d(fd, DVD_DT, i)
            worst = torch.maximum(worst, rd.status.abs())
        steps_done += DVD_CHUNK
        ke = float(0.5 * (fd.u.double() ** 2 + fd.v.double() ** 2).sum())
        if int(worst) != 0:
            fail(f"phase 34: a nonzero status before step {steps_done}")
        if prev_ke is not None and abs(ke - prev_ke) / (prev_ke + 1e-10) \
                < 1e-6 * DVD_CHUNK:
            break
        prev_ke = ke
    wall_d = time.perf_counter() - t0
    launch_counts["buoy2d"] = {"predictor_star_2d":
                               pk2m.predictor_star_2d.launches}
    vel_scale = 1.0 / alpha_d
    ic = nd // 2
    u_d = fd.u[0].double().cpu().numpy()
    v_d = fd.v[0].double().cpu().numpy()
    T_d = fd.T[0].double().cpu().numpy()
    umax = float(np.abs(0.5 * (u_d[:, ic - 1] + u_d[:, ic])).max()
                 * vel_scale)
    vmax = float(np.abs(0.5 * (v_d[ic - 1, :] + v_d[ic, :])).max()
                 * vel_scale)
    nu_avg = nu_avg_of(fd.T)
    dvd = {"steps": steps_done, "ms_per_step": wall_d * 1e3 / steps_done,
           "u_max": umax, "v_max": vmax, "nu_avg": nu_avg,
           "predictor_star_2d_launches": pk2m.predictor_star_2d.launches}
    print(f"phase 34 de Vahl Davis Ra=1e4 {nd}^2: KE-steady after "
          f"{steps_done} steps (reference record 36000), "
          f"{dvd['ms_per_step']:.4f} ms/step host wall, u_max* {umax:.3f} "
          f"(16.178), v_max* {vmax:.3f} (19.617), Nu_avg {nu_avg:.4f} "
          f"(2.238), worst status {int(worst)}, predictor_star_2d launches "
          f"{pk2m.predictor_star_2d.launches}", flush=True)
    for got, want in ((umax, 16.178), (vmax, 19.617), (nu_avg, 2.238)):
        if not abs(got - want) / want < 0.04:
            fail(f"phase 34: {got:.4f} not within 4% of {want}")
    if pk2m.predictor_star_2d.launches != steps_done:
        fail("phase 34: not the buoyant 2D predictor once a step")
    # the buoyant predictor against its plain version on the marched
    # field too (after the launch count was read)
    buoyant_check(f"phase 34 {nd}x{nd} after the march", False, fd.u,
                  fd.v, fd.w, fd.T, scal_d, consts_d)
    del fd
    print(f"phase 34 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 35: the stretched-grid kernels against their plain versions
    # the consistent scheme's projection kernels (the <true>
    # instantiations on the weight rows) and the eigenbasis-fused chain,
    # the parity and consistent explicit kernels, the 2D consistent
    # kernels; bit-equal, the GEMMs at 2e-5·max
    t_phase = time.perf_counter()

    def stretched_grid(shape):
        nz, ny, nx = shape
        if nz > 1:
            return Grid.stretched(nx, ny, nz, zmin=0.0, zmax=1.0,
                                  beta=STRETCH_BETA, stretch_axes="xy")
        return Grid.stretched(nx, ny, beta=STRETCH_BETA, stretch_axes="xy")

    def coords(grid):
        return (grid.dx, grid.dy, grid.x, grid.y)

    def plane_work(x, right, left, factor=1):
        nz_, ny_, nx_ = x.shape
        return ((x, right, left),
                factor * (gemm_flops(nz_ * ny_, nx_, nx_)
                          + gemm_flops(ny_, nx_, ny_, nz_)))

    def plane_library(x, right, left):
        return ieee_matmul(lambda: torch.einsum("ij,kjl,lm->kim", left, x,
                                                right))

    buoy_cons = NSParams(beta=BETA, T_ref=T_REF, gravity=(0.0, -9.81, 2.0))
    for shape in ((16, 64, 128), (N_BIG,) * 3):
        nz, ny, nx = shape
        big = nz == N_BIG
        tag = "x".join(map(str, shape[::-1])) + " stretched"
        print(f"phase 35 consistent projection kernels vs plain at {tag}",
              flush=True)
        grid = stretched_grid(shape)
        problem = NonuniformPoissonProblem.from_grid(grid)
        face = nonuniform_face_coeffs(problem)
        (fxt, fy, gxt, gy), (mu, w) = make_nonuniform_fused_pieces(
            problem, torch.float32, dev)
        f = noisy(FlowField.initialize(grid, dtype=torch.float32,
                                       device=dev), SEED)
        T = f.T + torch.randn(shape, generator=torch.Generator(
            device=dev).manual_seed(SEED + 1), device=dev)
        dt = torch.full((), 1e-3, device=dev)
        scal = torch.tensor([1e-3, 0.1, 0.05], device=dev)
        rod, s = 1.0 / dt, dt / 1.0
        cells = f.u.numel()
        weights = pkm.consistent_weights(*coords(grid), torch.float32, dev)
        xw, yw = weights
        c, cb = (pkm.stencil_consts(nz, ny, nx, grid.dx0, grid.dy0,
                                    grid.dz0, grid.xmin, grid.ymin,
                                    NSParams().mu, True, pb, torch.float32,
                                    weights, face)
                 for pb in (None, buoy_cons))
        us, vs, ws = check(
            "cons3d", tag, big, pkm.predictor_star, A1_CONS, SRC,
            lambda: pkm.predictor_star(f.u, f.v, f.w, scal, c),
            lambda: pkm.predictor_star_plain(f.u, f.v, f.w, scal, c),
            ("u*", "v*", "w*"), (exact,) * 3,
            work=((f.u, f.v, f.w, scal, xw, yw),
                  FLOPS_PER_POINT["predictor_star_cons"] * cells),
            name=cons_name(pkm.predictor_star))
        check("cons3d", f"{tag} buoyant", False, pkm.predictor_star,
              A1_CONS, SRC,
              lambda: pkm.predictor_star(f.u, f.v, f.w, scal, cb, T),
              lambda: pkm.predictor_star_plain(f.u, f.v, f.w, scal, cb, T),
              ("u*", "v*", "w*"), (exact,) * 3,
              name=cons_name(pkm.predictor_star))
        bt = check(
            "cons3d", tag, big, pkm.poisson_input, A1_FACE, SRC,
            lambda: pkm.poisson_input(us, vs, ws, f.p, rod, c),
            lambda: pkm.poisson_input_plain(us, vs, ws, f.p, rod, c),
            ("b~",), (exact,),
            work=((us, vs, ws, f.p, xw, yw),
                  FLOPS_PER_POINT["poisson_input_cons"] * cells),
            name=cons_name(pkm.poisson_input))[0]
        # the rhs form runs on the main path only in the 128³ Krylov
        # steps (phase 36), which time it; checked here, not timed
        check("cons3d-rhs", tag, False, pkm.poisson_rhs, A1_RHS, SRC,
              lambda: pkm.poisson_rhs(us, vs, ws, rod, c),
              lambda: pkm.poisson_rhs_plain(us, vs, ws, rod, c),
              ("rhs",), (exact,), name=cons_name(pkm.poisson_rhs))
        bhat = check(
            "cons3d", tag, big, rolling.plane_dot, DOT, SRC_SGEMM,
            lambda: rolling.plane_dot(bt, fxt, fy),
            lambda: rolling.plane_dot_plain(bt, fxt, fy),
            ("forward",), (gemm,), work=plane_work(bt, fxt, fy),
            library=plane_library(bt, fxt, fy))[0]
        check("cons3d-high", tag, big, rolling.plane_dot, HP_DOT, SRC_GEMM,
              lambda: rolling.plane_dot(bt, fxt, fy, "high"),
              lambda: rolling.plane_dot_plain(bt, fxt, fy, "high"),
              ("forward",), (gemm,), work=plane_work(bt, fxt, fy, 3),
              library=plane_library(bt, fxt, fy), name="plane_dot[3xtf32]",
              rate=TF32_TC_FLOPS)
        d, t = check(
            "cons3d", tag, big, tdma.tdma_z_fwd, A1, SRC,
            lambda: tdma.tdma_z_fwd(bhat, mu, w),
            lambda: tdma.tdma_z_fwd_reference(bhat, mu, w),
            ("d'", "t"), (exact, exact),
            work=((bhat, mu), FLOPS_PER_POINT["tdma_fwd"] * cells))
        xhat = check(
            "cons3d", tag, big, tdma.tdma_z_bwd, A2, SRC,
            lambda: tdma.tdma_z_bwd(d, t),
            lambda: tdma.tdma_z_bwd_reference(d, t),
            ("x^",), (exact,),
            work=((d, t), FLOPS_PER_POINT["tdma_bwd"] * cells))[0]
        p = check(
            "cons3d", tag, big, rolling.plane_dot, DOT, SRC_SGEMM,
            lambda: rolling.plane_dot(xhat, gxt, gy),
            lambda: rolling.plane_dot_plain(xhat, gxt, gy),
            ("inverse",), (gemm,), work=plane_work(xhat, gxt, gy),
            library=plane_library(xhat, gxt, gy))[0]
        check("cons3d", tag, big, pkm.corrector, A2_CONS, SRC,
              lambda: pkm.corrector(us, vs, ws, p, s, c),
              lambda: pkm.corrector_plain(us, vs, ws, p, s, c),
              ("u", "v", "w", "max|u|^2", "max p", "max|p|"), (exact,) * 6,
              work=((us, vs, ws, p, xw, yw),
                    FLOPS_PER_POINT["corrector_cons"] * cells),
              name=cons_name(pkm.corrector))
        # the fuse_fwd chain as the step calls it, HIGHEST and HIGH
        for prec in ("highest", "high"):
            kw = dict(dst_precision=prec,
                      tdma_bwd="analytic" if prec == "high" else "stored",
                      stretch_consistent=coords(grid), face_coeffs=face,
                      device=dev)
            kern = pkm.ProjectionKernels(
                *shape, grid.dx0, grid.dy0, grid.dz0, grid.xmin, grid.ymin,
                c.nu, (fxt, fy, gxt, gy), (mu, w), **kw)
            ref = pkm.ProjectionKernels(
                *shape, grid.dx0, grid.dy0, grid.dz0, grid.xmin, grid.ymin,
                c.nu, (fxt, fy, gxt, gy), (mu, w), plain=True, **kw)
            a1k = kern.predictor_poisson_input(f.u, f.v, f.w, f.p, dt,
                                               scal[1], scal[2], rod)
            a1p = ref.predictor_poisson_input(f.u, f.v, f.w, f.p, dt,
                                              scal[1], scal[2], rod)
            sync()
            for o, gk, rk, tl in zip(("u*", "v*", "w*", "d'", "t"), a1k,
                                     a1p, (exact,) * 3 + (gemm, exact)):
                if rk is not None:
                    compare(f"{tag} {prec}", f"A1 consistent.{o}", gk, rk,
                            *tl)
            a2k = kern.corrector_bwd_diag(*a1p, s)
            a2p = ref.corrector_bwd_diag(*a1p, s)
            sync()
            for o, gk, rk, tl in zip(
                    ("u", "v", "w", "p", "max|u|^2", "max p", "max|p|"),
                    a2k, a2p, (fld,) * 3 + (gemm, (TOL_DIAG, True), gemm,
                                            gemm)):
                compare(f"{tag} {prec}", f"A2 consistent.{o}", gk, rk, *tl)
            del kern, ref, a1k, a1p, a2k, a2p
        del f, T, us, vs, ws, bt, bhat, d, t, xhat, p
        torch.cuda.empty_cache()

    # the stretched explicit kernels: parity and consistent, each without
    # and with its thermal terms (parity: buoyancy; consistent: buoyancy
    # and the energy equation with the mixed faces)
    for shape in ((11, 23, 37), (N_EXPL,) * 3, (1, 23, 37), (1, N_2D, N_2D)):
        nz, ny, nx = shape
        three_d = nz > 1
        big = nx in (N_EXPL, N_2D)
        tag = "x".join(map(str, shape[::-1] if three_d else shape[:0:-1]))
        grid = stretched_grid(shape)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def rnd(scale, shape=shape, gen=gen):
            return scale * torch.randn(shape, generator=gen, device=dev)

        f = FlowField.initialize(grid, dtype=torch.float32, device=dev)
        u = f.u + rnd(0.3)
        u[nz // 2, ny // 3, nx // 3] = 150.0     # the clamps
        rho = f.rho + rnd(0.01)
        rho[nz // 2, ny // 2, nx // 2] = 1e-12   # the per-point ρ guard
        f = FlowField(u=u, v=f.v + rnd(0.3), w=rnd(0.3), p=f.p + rnd(0.3),
                      rho=rho, T=f.T + rnd(1.0))
        sy, sx = source_basis(grid, torch.float32, dev)
        cells = f.u.numel()
        ew = ekm.euler_step if three_d else e2m.euler2d_step
        sw = rkm.rk_stage if three_d else rk2m.rk2d_stage
        q0 = (f.u, f.v, f.w, f.p)
        st = tuple(x + rnd(0.01) for x in q0)
        acc = tuple(rnd(5.0) for _ in range(4))
        for scheme in ("parity", "consistent"):
            spacing = ekm.Spacing.of(coords(grid), scheme, torch.float32,
                                     dev)
            dim = "3d" if three_d else "2d"
            for thermal in (False, True):
                print(f"phase 35 stretched explicit kernels vs plain at "
                      f"{tag}, {scheme}{' thermal' if thermal else ''}",
                      flush=True)
                if thermal and scheme == "consistent":
                    th = ekm.ThermalConsts.from_params(
                        thermal_params(THERMAL_FACE_MIXES["mixed"]),
                        torch.float32)
                elif thermal:
                    th = ekm.ThermalConsts.from_params(buoy_cons,
                                                       torch.float32)
                else:
                    th = ekm.ThermalConsts()
                c = ekm.ExplicitConsts(nz, ny, nx, grid.dx0, grid.dy0,
                                       grid.dz0, 0.01, 0.1, th, spacing)
                timed = big and not thermal
                kind = "_cons" if scheme == "consistent" else ""
                ins = (f.u, f.v, f.w, f.p, f.T, f.rho, sy, sx,
                       torch.tensor([1e-4, 0.08, 0.04], device=dev))
                check(f"euler{dim}-{scheme}", f"{tag} {scheme}", timed, ew,
                      E3_STRETCH if three_d else E2_STRETCH, SRC_E,
                      lambda: ew(*ins, c),
                      lambda: ekm.euler_step_plain(*ins, c),
                      names6 + maxima4, (exact,) * 10,
                      work=(ins + (spacing.xw, spacing.yw),
                            FLOPS_PER_POINT["euler" + (kind or "")]
                            * cells),
                      name=f"{ew.__name__}[{scheme}]")
                for label, a, final, fac, mix, wgt in (
                        ("first", None, False, 5e-5, 0.0, 1.0),
                        ("mid", acc, False, 5e-5, 0.0, 2.0),
                        ("final", acc, True, 1e-4 / 6.0, 1.0, 0.0)):
                    sc = torch.tensor([fac, mix, wgt, 0.08, 0.04, 1e-4],
                                      device=dev)
                    read = (*st, *q0, f.rho, *(a or ()), sy, sx, sc,
                            spacing.xw, spacing.yw) + (
                        (f.T,) if final else ())
                    outs = (names6 + maxima4 if final else
                            tuple(f"next {n}" for n in "uvwp")
                            + tuple(f"acc {n}" for n in "uvwp"))
                    check(f"rk{dim}-{scheme}",
                          f"{tag} {scheme} {label}",
                          timed and label == "mid", sw,
                          RK3_STRETCH if three_d else RK2_STRETCH, SRC_RK,
                          lambda: sw(st, q0, f.rho, f.T, a, sy, sx, sc, c,
                                     final),
                          lambda: rkm.rk_stage_plain(st, q0, f.rho, f.T, a,
                                                     sy, sx, sc, c, final),
                          outs, (exact,) * len(outs),
                          work=(read, FLOPS_PER_POINT["rk_stage"
                                                      + (kind or "")]
                                * cells),
                          name=f"{sw.__name__}[{scheme}]")
        del f, u, rho, q0, st, acc
        torch.cuda.empty_cache()

    # the 2D consistent projection kernels
    for ny, nx in ((32, 128), (N_2D, N_2D)):
        big = nx == N_2D
        tag = f"{nx}x{ny} stretched"
        print(f"phase 35 2D consistent kernels vs plain at {tag}",
              flush=True)
        grid = stretched_grid((1, ny, nx))
        problem = NonuniformPoissonProblem.from_grid(grid)
        f = noisy(FlowField.initialize(grid, dtype=torch.float32,
                                       device=dev), SEED)
        T = f.T + torch.randn((1, ny, nx), generator=torch.Generator(
            device=dev).manual_seed(SEED + 1), device=dev)
        weights = pkm.consistent_weights(*coords(grid), torch.float32, dev)
        xw, yw = weights
        c, cb = (pkm.stencil_consts(1, ny, nx, grid.dx0, grid.dy0, 0.0,
                                    grid.xmin, grid.ymin, NSParams().mu,
                                    True, pb, torch.float32, weights,
                                    nonuniform_face_coeffs(problem))
                 for pb in (None, buoy_cons))
        scal = torch.tensor([1e-5, 0.1, 0.05], device=dev)
        rod = torch.tensor(1e5, device=dev)
        s = torch.tensor(1e-5, device=dev)
        cells = nx * ny
        us, vs, ws = check(
            "cons2d", tag, big, pk2m.predictor_star_2d, P2_CONS, SRC_2D,
            lambda: pk2m.predictor_star_2d(f.u, f.v, f.w, scal, c),
            lambda: pkm.predictor_star_plain(f.u, f.v, f.w, scal, c),
            ("u*", "v*", "w*"), (exact,) * 3,
            work=((f.u, f.v, f.w, scal, xw, yw),
                  FLOPS_PER_POINT["predictor_star_cons"] * cells),
            name=cons_name(pk2m.predictor_star_2d))
        check("cons2d", f"{tag} buoyant", False, pk2m.predictor_star_2d,
              P2_CONS, SRC_2D,
              lambda: pk2m.predictor_star_2d(f.u, f.v, f.w, scal, cb, T),
              lambda: pkm.predictor_star_plain(f.u, f.v, f.w, scal, cb, T),
              ("u*", "v*", "w*"), (exact,) * 3,
              name=cons_name(pk2m.predictor_star_2d))
        # b̃ (the 2D consistent step solves from the rhs; held, not a row)
        got = pk2m.poisson_input_2d(us, vs, f.p, rod, c)
        sync()
        compare(tag, "poisson_input_2d[consistent].b~", got,
                pk2m.poisson_input_2d_plain(us, vs, f.p, rod, c), *exact)
        check("cons2d", tag, big, pk2m.poisson_rhs_2d, P2_CONS, SRC_2D,
              lambda: pk2m.poisson_rhs_2d(us, vs, rod, c),
              lambda: pk2m.poisson_rhs_2d_plain(us, vs, rod, c),
              ("rhs",), (exact,),
              work=((us, vs, xw, yw),
                    FLOPS_PER_POINT["poisson_rhs_cons"] * cells),
              name=cons_name(pk2m.poisson_rhs_2d))
        check("cons2d", tag, big, pk2m.corrector_2d, P2_CONS, SRC_2D,
              lambda: pk2m.corrector_2d(us, vs, f.p, s, c),
              lambda: pk2m.corrector_2d_plain(us, vs, f.p, s, c),
              ("u", "v"), (exact,) * 2,
              work=((us, vs, f.p, xw, yw),
                    FLOPS_PER_POINT["corrector_cons"] * cells),
              name=cons_name(pk2m.corrector_2d))
        del f, T, us, vs, ws
        torch.cuda.empty_cache()
    print(f"phase 35 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 36: bench.py:run_3d_consistent(512), the Krylov steps ----
    t_phase = time.perf_counter()
    n = N_BIG
    grid_s = stretched_grid((n, n, n))
    params_c = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                        mu=0.01, nonuniform_scheme="consistent")
    pkm.reset_launch_counts()
    cons_3d = tuple((fn, "consistent") for fn in (
        pkm.predictor_star, pkm.poisson_input, pkm.corrector))
    ms_c, counts_c = timed_paths(
        36, f"{n}^3 consistent", grid_s, params_c, (n, n, n), 1e-4,
        TIMED_STEPS, cons_3d + (rolling.plane_dot, tdma.tdma_z_fwd,
                                tdma.tdma_z_bwd),
        first_step_only=True)
    launch_counts["cons3d"] = counts_c
    no_element_loads(f"phase 36 {n}^3 consistent")
    pkm.reset_launch_counts()
    ms_ch, _ = timed_paths(
        36, f"{n}^3 consistent HIGH", grid_s, params_c, (n, n, n), 1e-4,
        TIMED_STEPS, cons_3d + (tdma.tdma_z_fwd_d,
                                tdma.tdma_z_bwd_analytic),
        first_step_only=True, precision="high")
    launch_counts["cons3d-high"] = high_counts(
        f"phase 36 {n}^3 consistent HIGH",
        cons_3d + (tdma.tdma_z_fwd_d, tdma.tdma_z_bwd_analytic),
        (rolling.plane_dot,))
    no_element_loads(f"phase 36 {n}^3 consistent HIGH", "high")
    dp_c = high_vs_highest(f"phase 36 {n}^3 consistent", grid_s, params_c,
                           (n, n, n), 1e-4, HIGH_U, HIGH_P_CONS)

    # the float64 true residual of the system one kernel-path step solved:
    # b̃ = face·p₀ − (ρ/dt)∇·u* was solved for p on the interior, so the
    # Laplacian of p inside p₀'s mirror shells equals (ρ/dt)∇·u* there;
    # ‖r‖/‖rhs‖ volume-weighted, u* in float64 from the step's start.  On
    # this smooth rhs float32 rounding sets a floor that grows ~5× a
    # doubling of n, on a uniform grid alike (CPU runs, float32: 4.3e-6,
    # 2.4e-5, 1.3e-4 at 32³-128³ stretched, 5.3e-6-1.6e-4 uniform), so the
    # consistent step is held to twice the uniform step's value at 512³;
    # and the consistent direct solve on cg_512's rough rhs (phase 13) to
    # phase 30's bar, 1e-3
    def step_residual(grid_r, params_r, prec):
        stepf = make_projection_step(grid_r, params_r, torch.float32,
                                     Method.FFT_DIRECT, device=dev,
                                     spectral_precision=prec)
        f0 = tg_field((n, n, n))
        p1 = stepf(f0, 1e-4, 0)[0].p.double()
        w64 = None
        if not (grid_r.is_uniform("x") and grid_r.is_uniform("y")):
            w64 = pkm.consistent_weights(*coords(grid_r), torch.float64, dev)
        c64 = pkm.stencil_consts(n, n, n, grid_r.dx0, grid_r.dy0,
                                 grid_r.dz0, grid_r.xmin, grid_r.ymin, 0.01,
                                 False, None, torch.float64, w64)
        scal = torch.tensor([1e-4, 0.0, 0.0], dtype=torch.float64,
                            device=dev)
        us, vs, ws = pkm.predictor_star_plain(f0.u.double(), f0.v.double(),
                                              f0.w.double(), scal, c64)
        rhs = pkm.poisson_rhs_plain(us, vs, ws, 1.0 / scal[0], c64)
        del us, vs, ws
        prob = NonuniformPoissonProblem.from_grid(grid_r)
        xh0 = prob.set_interior(prob.neumann_bc(f0.p.double()), p1)
        del f0, p1
        r = prob.zero_boundary(prob.laplacian(xh0) - rhs)
        rel = float(torch.sqrt(prob.dot_interior(r, r)
                               / prob.dot_interior(rhs, rhs)))
        del r, rhs, xh0
        torch.cuda.empty_cache()
        return rel

    res_c = {"highest": step_residual(grid_s, params_c, None),
             "high": step_residual(grid_s, params_c, "high"),
             "uniform_highest": step_residual(
                 Grid.uniform(n, n, n, zmin=0.0, zmax=1.0),
                 NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                          mu=0.01), None)}
    prob_s = NonuniformPoissonProblem.from_grid(grid_s)
    rhs_r = prob_s.zero_boundary(torch.randn(
        (n, n, n), generator=torch.Generator(device=dev).manual_seed(7),
        device=dev))
    x_r = make_nonuniform_direct(prob_s, None, torch.float32, dev)(
        torch.zeros_like(rhs_r), rhs_r).x
    xd, rd = prob_s.zero_boundary(x_r.double()), rhs_r.double()
    rd_int = prob_s.zero_boundary(prob_s.laplacian(xd) - rd)
    res_c["rough_direct"] = float(torch.sqrt(
        prob_s.dot_interior(rd_int, rd_int) / prob_s.dot_interior(rd, rd)))
    del rhs_r, x_r, xd, rd, rd_int
    torch.cuda.empty_cache()
    print(f"phase 36 {n}^3 consistent: {ms_c['kernel']:.3f} ms/step "
          f"(plain {ms_c['plain']:.3f}), HIGH {ms_ch['kernel']:.3f} "
          f"(plain {ms_ch['plain']:.3f}); uniform {ms3['kernel']:.3f} / "
          f"HIGH {ms3h['kernel']:.3f} (phases 4, 28); HIGH's first-step "
          f"max|Δp| {dp_c:.3e}", flush=True)
    print(f"phase 36 {n}^3 float64 true residual ‖r‖/‖rhs‖ "
          f"(volume-weighted) of one step's system: consistent "
          f"{res_c['highest']:.3e}, HIGH {res_c['high']:.3e}, the uniform "
          f"step {res_c['uniform_highest']:.3e} (bar: twice it); the "
          f"consistent direct solve on cg_512's rough rhs "
          f"{res_c['rough_direct']:.3e} (bar {CONS_RESIDUAL_BAR:g})",
          flush=True)
    if not (max(res_c["highest"], res_c["high"])
            <= 2.0 * res_c["uniform_highest"]
            and res_c["rough_direct"] <= CONS_RESIDUAL_BAR):
        fail("phase 36: a consistent true residual above its bar")
    torch.cuda.empty_cache()

    # the consistent CG and BiCGSTAB steps at 128³ (run_3d's physics on
    # the stretched grid): the consistent kernels around the plain Krylov
    # loops, both paths, 3 steps each from the same start
    nk = N_CONS_KRYLOV
    grid_k = stretched_grid((nk,) * 3)
    krylov_rec = {}
    for method in (Method.CG, Method.BICGSTAB):
        out = {}
        for path in ("kernel", "plain"):
            if path == "kernel":
                pkm.reset_launch_counts()
            stepf = make_projection_step(grid_k, params_c, torch.float32,
                                         method, device=dev,
                                         plain=path == "plain")
            fk = tg_field((nk,) * 3)
            iters, syncs, statuses = [], [], []
            sync()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(3):
                fk, rk = stepf(fk, 1e-4, i)
                iters.append(int(stepf.last_poisson.iterations))
                syncs.append(stepf.poisson_solve.host_syncs)
                statuses.append(int(rk.status))
            end.record()
            sync()
            ms_k = start.elapsed_time(end) / 3
            print(f"phase 36 consistent {method.name} step {nk}^3 {path} "
                  f"path: {ms_k:.2f} ms/step, iterations {iters}, host "
                  f"syncs {syncs}, statuses {statuses}", flush=True)
            if max(map(abs, statuses)) != 0 or not bool(fk.is_finite()):
                fail(f"phase 36 consistent {method.name} {path}: nonzero "
                     f"status or non-finite")
            if path == "kernel":
                counts = launches_of(
                    (fn, "consistent") for fn in (
                        pkm.predictor_star, pkm.poisson_rhs, pkm.corrector))
                print(f"phase 36 consistent {method.name} launch counts "
                      f"over the main path: {counts}", flush=True)
                if min(counts.values()) <= 0:
                    fail(f"phase 36 consistent {method.name}: a kernel "
                         f"not launched")
                launch_counts.setdefault("cons3d-rhs", {}).update(
                    {k: launch_counts.get("cons3d-rhs", {}).get(k, 0) + v
                     for k, v in counts.items()})
                if do_profile:
                    # after the counts: one more step, traced
                    profile_steps(torch, f"phase 36 consistent "
                                  f"{method.name} {nk}^3",
                                  lambda: stepf(fk, 1e-4, 3), 1)
            out[path] = (fk, ms_k, iters, syncs)
        # the Krylov loop is the same plain code on both paths and the
        # kernels are bit-equal, so the two paths take the same iterates
        if out["kernel"][2] != out["plain"][2]:
            fail(f"phase 36 consistent {method.name}: iterations differ "
                 f"between the paths")
        for name in ("u", "v", "w", "p"):
            compare(f"phase 36 consistent {method.name} 3 steps", name,
                    getattr(out["kernel"][0], name),
                    getattr(out["plain"][0], name), TOL_EXACT, True)
        krylov_rec[method.name] = {
            "ms_per_step": out["kernel"][1], "plain_ms": out["plain"][1],
            "iterations": out["kernel"][2], "host_syncs": out["kernel"][3]}
        del out
        torch.cuda.empty_cache()

    # the rhs form of the consistent b̃ kernel runs on the main path only
    # in these Krylov steps: held bit-equal to its plain version and timed
    # on their own start field, consts and ρ/dt (the step's first
    # predictor, as make_projection_step builds it)
    prob_k = NonuniformPoissonProblem.from_grid(grid_k)
    pk_k = pkm.ProjectionKernels(
        nk, nk, nk, grid_k.dx0, grid_k.dy0, grid_k.dz0, grid_k.xmin,
        grid_k.ymin, params_c.mu, emit="rhs", with_sources=False,
        params=params_c, stretch_consistent=coords(grid_k),
        face_coeffs=nonuniform_face_coeffs(prob_k), device=dev)
    fk = tg_field((nk,) * 3)
    dt_k = torch.full((), 1e-4, device=dev)
    zero = torch.zeros((), device=dev)
    us, vs, ws = pk_k.predictor(fk.u, fk.v, fk.w, dt_k, zero, zero)
    rod_k = fk.rho[0, 0, 0] / dt_k
    ck = pk_k.consts
    check("cons3d-rhs", f"{nk}^3 Krylov start", True, pkm.poisson_rhs,
          A1_RHS, SRC, lambda: pkm.poisson_rhs(us, vs, ws, rod_k, ck),
          lambda: pkm.poisson_rhs_plain(us, vs, ws, rod_k, ck),
          ("rhs",), (exact,),
          work=((us, vs, ws, *ck.weights),
                FLOPS_PER_POINT["poisson_rhs_cons"] * us.numel()),
          name=cons_name(pkm.poisson_rhs))
    del fk, us, vs, ws, pk_k
    torch.cuda.empty_cache()

    # the 2D consistent step at 2048² (FFT_DIRECT: the eigenbasis direct
    # solve between the 2D consistent kernels)
    grid_2s = stretched_grid((1, n2, n2))
    pk2m.reset_launch_counts()
    ms_c2, counts_c2 = timed_paths(
        36, f"{n2}^2 consistent", grid_2s, params_c, (1, n2, n2), 1e-5,
        TIMED_STEPS_2D, tuple((fn, "consistent") for fn in (
            pk2m.predictor_star_2d, pk2m.poisson_rhs_2d,
            pk2m.corrector_2d)) + (rolling.plane_dot,),
        first_step_only=True)
    launch_counts["cons2d"] = counts_c2
    torch.cuda.empty_cache()
    print(f"phase 36 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 37: the stretched explicit steps, Poiseuille, the facade --
    t_phase = time.perf_counter()
    n3s, n2s = (N_EXPL,) * 3, (1, N_2D, N_2D)
    expl_params = {
        scheme: NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                         mu=0.01, nonuniform_scheme=scheme)
        for scheme in ("parity", "consistent")}
    for method, shape, n_steps, wrapper, dim in (
            ("euler", n3s, 10, ekm.euler_step, "3d"),
            ("rk2", n3s, 10, rkm.rk_stage, "3d"),
            ("rk4", n3s, 10, rkm.rk_stage, "3d"),
            ("euler", n2s, 20, e2m.euler2d_step, "2d"),
            ("rk2", n2s, 10, rk2m.rk2d_stage, "2d")):
        kind = "euler" if method == "euler" else "rk"
        for scheme in ("parity", "consistent"):
            explicit_path(method, shape, n_steps, f"{kind}{dim}-{scheme}",
                          wrapper, params=expl_params[scheme],
                          grid=stretched_grid(shape),
                          counter=f"{scheme}_launches",
                          name=f"{wrapper.__name__}[{scheme}]", phase=37)
    torch.cuda.empty_cache()

    # the stretched Poiseuille channel (the reference's harness,
    # tests/validation/test_poiseuille.py:110-165) on the card: the
    # default step (parity, CG: the whole-solve kernel), float32
    pnx, pny, psteps = POISEUILLE
    nu_p = 1.0 * 1.0 / 100.0     # U_MAX·HEIGHT / Re, Re = 100

    def analytic_u(y):
        return 4.0 * (y / 1.0) * (1.0 - y / 1.0)

    poiseuille = {}
    for beta, bar in POISEUILLE_BARS.items():
        grid_p = (Grid.stretched(pnx, pny, xmax=4.0, ymax=1.0, beta=beta)
                  if beta else Grid.uniform(pnx, pny, xmax=4.0, ymax=1.0))
        dt_p = min(5e-4, 0.25 * float(np.min(grid_p.dy)) ** 2 / nu_p)
        params_p = NSParams(dt=dt_p, mu=nu_p, max_iter=1,
                            source_amplitude_u=0.0, source_amplitude_v=0.0)
        step_p = make_projection_step(grid_p, params_p, torch.float32,
                                      device=dev)
        inlet, outlet = InletConfig.parabolic(1.0), OutletConfig.zero_gradient()
        yy = torch.as_tensor(np.asarray(grid_p.y), dtype=torch.float32,
                             device=dev)
        fp_ = FlowField.quiescent(pnx, pny, dtype=torch.float32, device=dev)
        fp_ = fp_.replace(u=analytic_u(yy)[None, :, None].expand(
            1, pny, pnx).contiguous())
        cw = vmem_small.cg_solve
        cw.launches = cw.cluster_launches = 0
        worst = torch.zeros((), dtype=torch.int32, device=dev)
        sync()
        t0 = time.perf_counter()
        for i in range(psteps):
            u_, v_ = apply_noslip(fp_.u, fp_.v)
            u_, v_ = apply_inlet(u_, v_, inlet)
            u_, v_ = apply_outlet_velocity(u_, v_, outlet)
            fp_, rp = step_p(fp_.replace(u=u_, v=v_), dt_p, i)
            worst = torch.maximum(worst, rp.status.abs())
        sync()
        wall = time.perf_counter() - t0
        u_num = fp_.u[0, 1:-1, -2].double().cpu().numpy()
        u_ana = analytic_u(np.asarray(grid_p.y))[1:-1]
        l2 = float(np.sqrt(np.mean((u_num - u_ana) ** 2)))
        n_cg = vmem_small.cg_solve.cluster_launches
        poiseuille[beta] = {"l2": l2, "ms_per_step": wall * 1e3 / psteps,
                            "cg_solve_cluster_launches": n_cg}
        print(f"phase 37 Poiseuille {pnx}x{pny} beta={beta}: outlet L2 "
              f"{l2:.5f} (bar {bar}; reference float64 record: 0.011 / "
              f"0.126 / 0.188), worst status {int(worst)}, "
              f"{wall * 1e3 / psteps:.3f} ms a step host wall", flush=True)
        if int(worst) != 0 or not l2 < bar:
            fail(f"phase 37 Poiseuille beta={beta}: status or L2 bar")
        solve_forms(vmem_small.cg_solve, f"phase 37 Poiseuille beta={beta}",
                    psteps, "cluster")
        if float(fp_.u[0, 0].abs().max()) != 0.0 or float(
                fp_.u[0, -1].abs().max()) != 0.0:
            fail("phase 37 Poiseuille: the walls are not no-slip")
    if not (poiseuille[0.0]["l2"] < poiseuille[1.5]["l2"]
            < poiseuille[2.0]["l2"]):
        fail("phase 37 Poiseuille: uniform not below stretched")

    # Simulation.from_grid on a stretched grid with the consistent scheme
    # (the reference's documented use, cfd_tpu/api/simulation.py:70-80)
    facade_s = {}
    for solver_type in ("projection", "explicit_euler"):
        sim = Simulation.from_grid(
            Grid.stretched(128, 64, beta=STRETCH_BETA, stretch_axes="xy"),
            solver_type, NSParams(dt=0.001, cfl=0.2, mu=0.01, max_iter=1,
                                  nonuniform_scheme="consistent"),
            device=dev)
        statuses = [int(sim.step()) for _ in range(20)]
        facade_s[solver_type] = statuses[-1]
        print(f"phase 37 Simulation.from_grid(stretched 128x64, "
              f"'{solver_type}', consistent) 20 steps: statuses "
              f"{sorted(set(statuses))}, finite "
              f"{bool(sim.field.is_finite())}", flush=True)
        if max(map(abs, statuses)) != 0 or not bool(sim.field.is_finite()):
            fail(f"phase 37 facade {solver_type}: a nonzero status")
    print(f"phase 37 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 38: spectral_precision="default" (one TF32 pass) ------------
    # the one-pass TF32 GEMM against its plain version (TF32-rounded
    # operands, exact products, IEEE fp32 sums) at the 512³ plane shapes and
    # the 2048² x-DST, within TOL_GEMM (only the order of the sums differs),
    # its error against float64 beside the 3xTF32 GEMM's and the SGEMM's;
    # then the DEFAULT steps (the emit-b̃ route: physical b̃, the Thomas
    # transform pipeline, the corrector on p) at 512³ and 2048² on both
    # paths, and one step of each against HIGHEST
    t_phase = time.perf_counter()

    def tf32_matmul(fn):
        """``fn`` run with TF32 on: the library call of the one-pass GEMM
        (timed beside it, never called by the port)."""
        def run():
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return fn()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
        return run

    def vs_float64_all(tag, a, b):
        """``a · b`` at each precision against the float64 product of the
        same fp32 inputs, max error over max|truth| (printed; the
        one-pass TF32 keeps about 2⁻¹¹ of each operand)."""
        truth = a.double() @ b.double()
        scale = float(truth.abs().max())
        errs = {}
        for prec in ("default", "high", "highest"):
            got = rolling.right_dot(a, b, prec)
            errs[prec] = float((got.double() - truth).abs().max()) / scale
            del got
        print(f"  {tag} vs float64: TF32 {errs['default']:.3e}, 3xTF32 "
              f"{errs['high']:.3e}, SGEMM {errs['highest']:.3e} of "
              f"max|truth|", flush=True)
        gemm_truth[tag] = {"tf32": errs["default"], "3xtf32": errs["high"],
                           "sgemm": errs["highest"]}
        del truth
        torch.cuda.empty_cache()

    n = N_BIG
    tag = f"{n}x{n}x{n}"
    print(f"phase 38 the TF32 GEMM vs plain at {tag}", flush=True)
    f, (fxt, fy, gxt, gy), mu, w, c = make_inputs((n, n, n), SEED)
    x2 = f.p.view(-1, n)
    # one launch as the 3D main path makes it: the (nz·ny, nx) × (nx, nx)
    # product of the forward xy DST
    check("3d-default", tag, True, rolling.right_dot, HP_DOT, SRC_GEMM_TF32,
          lambda: rolling.right_dot(x2, fxt, "default"),
          lambda: rolling.right_dot_plain(x2, fxt, "default"),
          ("x·FxT",), (gemm,), work=((x2, fxt), gemm_flops(n * n, n, n)),
          library=tf32_matmul(lambda: torch.matmul(x2, fxt)),
          name="gemm_tf32", rate=TF32_TC_FLOPS, device_time=True,
          repeat=True)
    tf32_plan(f"phase 38 {tag} x·FxT", n * n, n, n)
    tf32_plan(f"phase 38 {tag} Fy·t[k]", n, n, n, n)
    got = rolling.plane_dot(f.p, fxt, fy, "default")
    ref = rolling.plane_dot_plain(f.p, fxt, fy, "default")
    sync()
    compare(f"phase 38 {tag}", "plane_dot[tf32] (both launches)", got, ref,
            *gemm)
    # contract check (c): a 130-plane block (a middle z-shard's x^ block)
    # gives the bits of those planes of the 512-plane product
    nb = n // SHARDS + 2
    z0 = (SHARDS // 2) * (n // SHARDS) - 1
    tf32_plan(f"phase 38 {nb}-plane block x·FxT", nb * n, n, n)
    tf32_plan(f"phase 38 {nb}-plane block Fy·t[k]", n, n, n, nb)
    blk = rolling.plane_dot(f.p[z0:z0 + nb], fxt, fy, "default")
    sync()
    contract["(c) plane_dot block"] = torch.equal(blk, got[z0:z0 + nb])
    print(f"phase 38 contract (c): plane_dot of planes [{z0}, {z0 + nb}) "
          f"== those planes of the {n}-plane product bit for bit "
          f"{contract['(c) plane_dot block']}", flush=True)
    if not contract["(c) plane_dot block"]:
        fail("phase 38: a plane block's one-pass products differ from the "
             "whole field's (sum-order contract)")
    del got, ref, blk
    vs_float64_all(f"phase 38 x·FxT at {tag} (depth {n})", x2, fxt)
    del f, x2, fxt, fy, gxt, gy, mu
    torch.cuda.empty_cache()
    tag = f"{N_2D}x{N_2D}"
    print(f"phase 38 the 2D TF32 products vs plain at {tag}", flush=True)
    grid2 = Grid.uniform(N_2D, N_2D)
    prob2 = PoissonProblem(N_2D, N_2D, 1, grid2.dx0, grid2.dy0)
    fxt, _, ysolve = make_dst2d_fused_pieces(prob2, torch.float32, dev,
                                             precision="default")
    bt = noisy(FlowField.initialize(grid2, dtype=torch.float32,
                                    device=dev), SEED).p
    tf32_plan(f"phase 38 {tag} x-DST", N_2D, N_2D, N_2D)
    a = check("2d-default", tag, True, rolling.right_dot, HP_DOT,
              SRC_GEMM_TF32,
              lambda: rolling.right_dot(bt, fxt, "default"),
              lambda: rolling.right_dot_plain(bt, fxt, "default"),
              ("forward",), (gemm,),
              work=((bt, fxt), gemm_flops(N_2D, N_2D, N_2D)),
              library=tf32_matmul(lambda: torch.matmul(bt, fxt)),
              name="gemm_tf32", rate=TF32_TC_FLOPS, device_time=True,
              repeat=True)[0][0]
    # contract check (b): a 512-row slice's x-DST (a 4y shard's) gives the
    # bits of those rows of the 2048-row one; then every DEFAULT depth in
    # use against the plain version, two launches bit-identical
    rows = N_2D // SHARDS
    tf32_plan(f"phase 38 {tag} {rows}-row x-DST", rows, N_2D, N_2D)
    xd = rolling.right_dot(bt[0], fxt, "default")
    xs = rolling.right_dot(bt[0, rows:2 * rows], fxt, "default")
    sync()
    contract["(b) x-DST rows"] = torch.equal(xs, xd[rows:2 * rows])
    print(f"phase 38 contract (b): the x-DST of rows [{rows}, {2 * rows}) "
          f"== those rows of the {N_2D}-row x-DST bit for bit "
          f"{contract['(b) x-DST rows']}", flush=True)
    if not contract["(b) x-DST rows"]:
        fail("phase 38: a row slice's one-pass x-DST differs from the "
             "whole field's (sum-order contract)")
    del xd, xs
    for k_ in TF32_DEPTHS:
        # x[:, :K] (rows N_2D floats apart) · FxT[:K] through left_dot
        xk, rk = bt[0, :, :k_], fxt[:k_]
        tf32_plan(f"phase 38 depth {k_}", N_2D, N_2D, k_)
        kk = rolling.left_dot(xk, rk, precision="default")
        pk = rolling.left_dot_plain(xk, rk, precision="default")
        same = torch.equal(kk, rolling.left_dot(xk, rk, precision="default"))
        sync()
        err = compare(f"phase 38 depth {k_}", "x[:, :K]·FxT[:K]", kk, pk,
                      *gemm)[1]
        tf32_depths[k_] = {"max_rel_err": err, "repeat_bit_identical": same}
        if not same:
            fail(f"phase 38 depth {k_}: two launches differ")
        del kk, pk
    # the odd shapes, each product held alone (two chained TF32 roundings
    # on random data part by more than TOL_GEMM, whatever the kernel):
    # a 37x23x11 field (rows of 37 floats, planes 851 apart: both launches
    # load through cp.async, counted apart) and the 512x512x3 planes (both
    # by TMA), against the plain version
    g_odd = torch.Generator(device=dev).manual_seed(SEED + 38)
    for shape_ in ((11, 23, 37), N_NZ3):
        nz_, ny_, nx_ = shape_
        xo = torch.randn(shape_, generator=g_odd, device=dev)
        ro = torch.randn((nx_, nx_), generator=g_odd, device=dev)
        lo = torch.randn((ny_, ny_), generator=g_odd, device=dev)
        tag_ = "x".join(map(str, shape_[::-1]))
        tf32_plan(f"phase 38 {tag_} x·right", nz_ * ny_, nx_, nx_)
        tf32_plan(f"phase 38 {tag_} left·x[k]", ny_, nx_, ny_, nz_)
        rolling.reset_launch_counts()
        got_r = rolling.right_dot(xo.view(-1, nx_), ro, "default")
        got_l = rolling.left_dot(lo, xo, precision="default")
        sync()
        n_cp = (rolling.right_dot.default_cp_async_launches
                + rolling.left_dot.default_cp_async_launches)
        compare(f"phase 38 {tag_}", "x·right[tf32]", got_r,
                rolling.right_dot_plain(xo.view(-1, nx_), ro, "default"),
                *gemm)
        compare(f"phase 38 {tag_}", "left·x[k][tf32]", got_l,
                rolling.left_dot_plain(lo, xo, precision="default"), *gemm)
        print(f"phase 38 {tag_}: one-pass launches through the cp.async "
              f"loads {n_cp} of 2", flush=True)
        if n_cp != (2 if nx_ % 4 else 0):
            fail(f"phase 38 {tag_}: not the expected loads (cp.async for "
                 f"rows off 16 bytes, TMA otherwise)")
        del xo, ro, lo, got_r, got_l
    rescue_checks("2d-default", tag, ysolve, a, "default",
                  "rescue_dot[tf32]", TF32_TC_FLOPS, tf32_matmul, True)
    vs_float64_all(f"phase 38 bt·FxT at {tag} (depth {N_2D})", bt[0], fxt)
    del bt, a, fxt, ysolve
    torch.cuda.empty_cache()
    rescue_ghia("2d-default", "default", "rescue_dot[tf32]", TF32_TC_FLOPS,
                tf32_matmul)

    gemms = (rolling.plane_dot, rolling.right_dot, rolling.left_dot,
             rolling.rescue_dot)

    def default_counts(label, counts, per_step, rescues=0):
        """The DEFAULT path's counts (read by ``timed_paths`` right
        after the timed steps): its wrappers', the one-pass TF32 launches
        of the DST GEMM wrappers summed as ``gemm_tf32``, ``per_step`` a
        step (one Thomas launch a step: the 3D forward sweep, the 2D
        y-line kernel), and the rescue GEMM's as ``rescue_dot[tf32]``,
        ``rescues`` a step; no SGEMM and no 3xTF32 launch (the DST-fused
        route and the other precisions)."""
        n_rescue = counts.pop("rescue_dot[default]", 0)
        tf32 = sum(v for k, v in counts.items() if k.endswith("[default]"))
        counts = {k: v for k, v in counts.items()
                  if not k.endswith("[default]")}
        counts["gemm_tf32"] = tf32
        if rescues:
            counts["rescue_dot[tf32]"] = n_rescue
        other = {g.__name__: (g.launches, g.high_launches) for g in gemms}
        cp_async = {g.__name__: g.default_cp_async_launches for g in gemms}
        print(f"{label} launch counts over the main path: {counts}; "
              f"(SGEMM, 3xTF32) launches {other}; one-pass launches "
              f"through the cp.async loads {cp_async}", flush=True)
        steps = counts.get("tdma_y_2d", counts.get("tdma_z_fwd"))
        if (min(counts.values()) <= 0
                or counts["gemm_tf32"] != per_step * steps
                or n_rescue != rescues * steps
                or max(max(v) for v in other.values()) != 0
                or max(cp_async.values()) != 0):
            fail(f"{label}: not the emit-b̃ route (TF32 launches "
                 f"{per_step} + {rescues} a step, every operand by TMA, no "
                 f"SGEMM or 3xTF32)")
        return counts

    def default_vs_highest(label, grid_h, params_h, shape, dt):
        """One kernel-path step at DEFAULT against one at HIGHEST from the
        same start: p within TOL_TF32_STEP of max|p|, u, v, w within what
        that passes on through the corrector; returns max|Δp|/max|p| and
        max|Δu| over u, v, w."""
        firsts = {}
        for prec in ("default", None):
            stepf = make_projection_step(grid_h, params_h, torch.float32,
                                         Method.FFT_DIRECT, device=dev,
                                         spectral_precision=prec)
            firsts[prec] = stepf(tg_field(shape), dt, 0)[0]
        sync()
        fd, fh = firsts["default"], firsts[None]
        pmax = float(fh.p.abs().max())
        dp = compare(f"{label} DEFAULT vs HIGHEST first step", "p", fd.p,
                     fh.p, TOL_TF32_STEP, True)[0]
        p_rel = dp / pmax
        u_abs = 0.0
        for k, d in (("u", grid_h.dx0), ("v", grid_h.dy0),
                     ("w", grid_h.dz0 if shape[0] > 1 else None)):
            bar = TOL_FIELD + (dt / d * TOL_TF32_STEP * pmax if d else 0.0)
            u_abs = max(u_abs, compare(
                f"{label} DEFAULT vs HIGHEST first step", k,
                getattr(fd, k), getattr(fh, k), bar, False)[0])
        print(f"{label} DEFAULT vs HIGHEST after one step: max|p - "
              f"p_HIGHEST|/max|p| {p_rel:.3e}, max|u - u_HIGHEST| "
              f"{u_abs:.3e} (u, v, w)", flush=True)
        del firsts, fd, fh
        torch.cuda.empty_cache()
        return {"p_rel": p_rel, "u_abs": u_abs}

    grid = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                      mu=0.01)
    wr_default = (pkm.predictor_star, pkm.poisson_input, tdma.tdma_z_fwd,
                  tdma.tdma_z_bwd, pkm.corrector, (rolling.plane_dot,
                                                   "default"))
    pkm.reset_launch_counts()
    ms3d, counts = timed_paths(38, f"{n}^3 DEFAULT", grid, params,
                               (n, n, n), 1e-4, TIMED_STEPS, wr_default,
                               first_step_only=True, precision="default",
                               tol_p=TOL_TF32_STEP)
    launch_counts["3d-default"] = default_counts(f"phase 38 {n}^3 DEFAULT",
                                                 counts, 4)
    torch.cuda.empty_cache()
    vs_high = {"3d": default_vs_highest(f"phase 38 {n}^3", grid, params,
                                        (n, n, n), 1e-4)}
    wr_default_2d = (pk2m.predictor_star_2d, pk2m.poisson_input_2d,
                     tdma.tdma_y_2d, pk2m.corrector_2d,
                     (rolling.right_dot, "default"),
                     (rolling.rescue_dot, "default"))
    pk2m.reset_launch_counts()
    ms2d, counts = timed_paths(38, f"{n2}^2 DEFAULT", Grid.uniform(n2, n2),
                               params, (1, n2, n2), 1e-5, TIMED_STEPS_2D,
                               wr_default_2d, first_step_only=True,
                               precision="default", tol_p=TOL_TF32_STEP)
    launch_counts["2d-default"] = default_counts(f"phase 38 {n2}^2 DEFAULT",
                                                 counts, 2, 2)
    vs_high["2d"] = default_vs_highest(f"phase 38 {n2}^2",
                                       Grid.uniform(n2, n2), params,
                                       (1, n2, n2), 1e-5)
    print(f"phase 38 DEFAULT {n}^3 {ms3d['kernel']:.3f} ms/step (HIGHEST "
          f"{ms3['kernel']:.3f}, HIGH {ms3h['kernel']:.3f}); {n2}^2 "
          f"{ms2d['kernel']:.3f} ms/step (HIGHEST {ms2['kernel']:.3f}, "
          f"HIGH {ms2h['kernel']:.3f})", flush=True)
    print(f"phase 38 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phases 39-41: the differentiable steps ---------------------------
    # a rollout's loss, its value (no graph) and its value and gradient
    # w.r.t. the initial u, timed on the host clock around a sync, best of
    # ``reps`` after one warm-up

    def rollout_loss(step, n_steps, f0, dt, names, remat="step"):
        roll = make_rollout(step, n_steps, remat=remat)

        def loss(u0):
            out, _ = roll(f0.replace(u=u0), dt)
            total = 0.0
            for k in names:
                total = total + (getattr(out, k) ** 2).sum()
            return 0.5 * total

        return roll, loss

    def value_and_grad(loss, u0):
        u = u0.clone().requires_grad_()
        val = loss(u)
        (g,) = torch.autograd.grad(val, u)
        return val.detach(), g

    def host_ms(fn, reps):
        fn()
        sync()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    def adjoint_rows(label, makers, n_steps, f0, dt, names, reps):
        """Forward (no graph) and value+grad ms of each step of
        ``makers`` ({path: step}), their ratio, and the gradients."""
        rows, grads = {}, {}
        for path, step in makers.items():
            _, loss = rollout_loss(step, n_steps, f0, dt, names)

            def fwd():
                with torch.no_grad():
                    return loss(f0.u)

            fwd_ms = host_ms(fwd, reps)
            grad_ms = host_ms(lambda: value_and_grad(loss, f0.u), reps)
            val, grads[path] = value_and_grad(loss, f0.u)
            rows[path] = {"forward_ms": fwd_ms, "grad_ms": grad_ms,
                          "ratio": grad_ms / fwd_ms}
            print(f"{label} {path}: forward {fwd_ms:.3f} ms, value+grad "
                  f"{grad_ms:.3f} ms, ratio {grad_ms / fwd_ms:.2f}; loss "
                  f"{float(val):.6e}, max|grad| "
                  f"{float(grads[path].abs().max()):.6e}", flush=True)
            if not bool(torch.isfinite(grads[path]).all()):
                fail(f"{label} {path}: non-finite gradient")
        return rows, grads

    def same_fields(label, got, want):
        """The hybrid rollout's value against the kernel rollout's, bit
        for bit."""
        for k in ("u", "v", "w", "p", "rho", "T"):
            if not torch.equal(getattr(got, k), getattr(want, k)):
                err = float((getattr(got, k) - getattr(want, k)).abs()
                            .max())
                fail(f"{label}: hybrid {k} not bit-equal to the kernel "
                     f"rollout (max abs {err:.3e})")
        print(f"{label}: hybrid forward bit-equal to the kernel rollout "
              f"(u, v, w, p, rho, T)", flush=True)

    # ---- phase 39: bench.py:run_hybrid_adjoint(128, 10) -------------------
    t_phase = time.perf_counter()
    nh, steps_h, dt_h = N_HYBRID, HYBRID_STEPS, 5e-5
    grid_h = Grid.uniform(nh, nh, nh, zmin=0.0, zmax=1.0)
    params_h = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f0 = FlowField.initialize(grid_h, dtype=torch.float32, device=dev)
    f0 = f0.replace(**{k: 0.2 * torch.randn(grid_h.shape, generator=gen,
                                            device=dev) for k in "uvw"})
    hybrid = make_euler_step(grid_h, params_h, torch.float32, dev,
                             differentiable=True)
    plain_d = make_euler_step(grid_h, params_h, torch.float32, dev,
                              differentiable=True, plain=True)
    native.reset_counts(ekm.euler_step)
    with torch.no_grad():
        fh, _ = make_rollout(hybrid, steps_h, remat="step")(f0, dt_h)
    n_launch = ekm.euler_step.launches
    fk, _ = run_steps(make_euler_step(grid_h, params_h, torch.float32, dev),
                      f0, dt_h, steps_h)
    sync()
    label = f"phase 39 run_hybrid_adjoint({nh}, {steps_h})"
    print(f"{label}: euler_step launches over the hybrid rollout "
          f"{n_launch}", flush=True)
    if n_launch != steps_h:
        fail(f"{label}: the hybrid forward did not launch the Euler "
             f"kernel once a step")
    same_fields(label, fh, fk)
    launch_counts["hybrid3d"] = {"euler_step": n_launch}
    rows39, grads = adjoint_rows(label, {"hybrid": hybrid, "plain": plain_d},
                                 steps_h, f0, dt_h, "uvw", 3)
    gdiff = float((grads["hybrid"] - grads["plain"]).abs().max())
    gscale = float(grads["plain"].abs().max())
    print(f"{label}: max|grad_hybrid - grad_plain| {gdiff!r} (max|grad| "
          f"{gscale:.6e}; 0.0 expected: the Euler kernel is bit-equal to "
          f"its plain version)", flush=True)
    if not gdiff <= TOL_EXACT * gscale:
        fail(f"{label}: hybrid gradient off the plain step's")
    hybrid_rec = {"run_hybrid_adjoint": dict(rows39, grad_max_abs_diff=gdiff)}
    del f0, fh, fk, grads
    torch.cuda.empty_cache()
    print(f"phase 39 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 40: bench.py:run_adjoint(1024, 50) -------------------------
    t_phase = time.perf_counter()
    na, steps_a = N_ADJOINT, ADJOINT_STEPS
    grid_a = Grid.uniform(na, na)
    f0 = tg_field((1, na, na))
    makers = {p: make_euler_step(grid_a, params_h, torch.float32, dev,
                                 differentiable=True, plain=p == "plain")
              for p in ("hybrid", "plain")}
    label = f"phase 40 run_adjoint({na}, {steps_a})"
    rows40, grads = adjoint_rows(label, makers, steps_a, f0, 1e-4, "uv", 2)
    gdiff = float((grads["hybrid"] - grads["plain"]).abs().max())
    print(f"{label}: max|grad_hybrid - grad_plain| {gdiff!r}", flush=True)
    hybrid_rec["run_adjoint"] = dict(rows40, grad_max_abs_diff=gdiff)
    del f0, grads
    torch.cuda.empty_cache()
    print(f"phase 40 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 41: the hybrid projection steps ----------------------------
    # FFT_DIRECT at 256³ (5 steps, remat="step") and CG at 128³ (3 steps):
    # the hybrid rollout's value bit-equal to the kernel rollout; its
    # gradient against the plain differentiable step's — FFT_DIRECT at the
    # reference's bar (rtol 1e-5, atol 5e-7, tests/solvers/
    # test_hybrid_vjp.py:124-127), CG at a relative L2 of 1e-3 (the two
    # forwards differ at the solver's tolerance)
    t_phase = time.perf_counter()
    for method, nq, steps_q in ((Method.FFT_DIRECT, N_HYBRID_FFT, 5),
                                (Method.CG, N_HYBRID, 3)):
        grid_q = Grid.uniform(nq, nq, nq, zmin=0.0, zmax=1.0)
        params_q = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                            mu=0.01)
        f0 = tg_field((nq, nq, nq))
        label = f"phase 41 hybrid {method.name} {nq}^3"
        kernel_q = make_projection_step(grid_q, params_q, torch.float32,
                                        method, device=dev)
        makers = {p: make_projection_step(
            grid_q, params_q, torch.float32, method, device=dev,
            differentiable=True, plain=p == "plain")
            for p in ("hybrid", "plain")}
        pkm.reset_launch_counts()
        cgk.lap_dot.launches = cgk.cg_update.launches = 0
        with torch.no_grad():
            fh, _ = make_rollout(makers["hybrid"], steps_q,
                                 remat="step")(f0, 1e-4)
        wrappers = ((pkm.predictor_star, pkm.poisson_input,
                     rolling.plane_dot, tdma.tdma_z_fwd, tdma.tdma_z_bwd,
                     pkm.corrector) if method == Method.FFT_DIRECT else
                    (pkm.predictor_star, pkm.poisson_rhs, cgk.lap_dot,
                     cgk.cg_update, pkm.corrector))
        counts = launches_of(wrappers)
        print(f"{label}: launch counts over the hybrid forward {counts}",
              flush=True)
        if min(counts.values()) <= 0:
            fail(f"{label}: a kernel of the step not launched")
        launch_counts[f"hybrid-{method.name.lower()}"] = counts
        fk, _ = run_steps(kernel_q, f0, 1e-4, steps_q)
        sync()
        same_fields(label, fh, fk)
        rows, grads = adjoint_rows(label, makers, steps_q, f0, 1e-4, "uvw",
                                   1)
        gh, gp = grads["hybrid"], grads["plain"]
        rel_l2 = float((gh - gp).norm() / gp.norm())
        if method == Method.FFT_DIRECT:
            excess = float(((gh - gp).abs() - (5e-7 + 1e-5 * gp.abs()))
                           .max())
            print(f"{label}: gradient vs the plain step's: max abs "
                  f"{float((gh - gp).abs().max()):.3e}, relative L2 "
                  f"{rel_l2:.3e}, largest excess over atol 5e-7 + rtol "
                  f"1e-5 {excess:.3e} (must be <= 0)", flush=True)
            if not excess <= 0.0:
                fail(f"{label}: hybrid gradient outside rtol 1e-5 / atol "
                     f"5e-7")
        else:
            print(f"{label}: gradient vs the plain step's: relative L2 "
                  f"{rel_l2:.3e} (bar 1e-3)", flush=True)
            if not rel_l2 <= 1e-3:
                fail(f"{label}: hybrid gradient off the plain step's")
        hybrid_rec[f"projection_{method.name.lower()}_{nq}"] = dict(
            rows, grad_rel_l2=rel_l2)
        del f0, fh, fk, grads, gh, gp, makers, kernel_q
        torch.cuda.empty_cache()
    print(f"phase 41 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 42: the sharded step's kernels against their plain versions
    # The global_nz predictor and b~ on the blocks of the first, a middle
    # and the last of 4 z-shards (2-halo and 1-halo blocks, z_base from
    # the shard's first plane), at 37x23x16 and on the 512^3/4 slab;
    # the call-time-mu Thomas pair on a shard's (512, 128, 512) y-pencil
    # with its rows of mu; the SGEMM / 3xTF32 inverse DST and the
    # corrector on a middle shard's 1-halo x^ block.  The stencil and
    # Thomas kernels are held bit for bit (BIT: max|kernel - plain| = 0).
    t_phase = time.perf_counter()
    import dataclasses

    from cfd_tpu_torch.parallel import (LocalComm, ProcessGroupComm,
                                        ShardedField, gather_field,
                                        make_cg_fused_sharded, make_mesh,
                                        make_sharded_step, mesh_zy_sizes)

    def zpad(x, k):
        z = torch.zeros_like(x[:k])
        return torch.cat([z, x, z])

    for shape in ((16, 23, 37), (N_BIG, N_BIG, N_BIG)):
        nz_g = shape[0]
        big = nz_g == N_BIG
        nzl = nz_g // SHARDS
        tag = "x".join(map(str, shape[::-1]))
        print(f"phase 42 global_nz kernels vs plain at {tag} over {SHARDS} "
              f"z-shards", flush=True)
        f, (fxt, fy, gxt, gy), mu, w, c = make_inputs(shape, SEED + 42)
        dt = torch.full((), 1e-3, device=dev)
        scal = torch.stack([dt, torch.full((), 0.1, device=dev),
                            torch.full((), 0.05, device=dev)])
        rod, s = 1.0 / dt, dt / 1.0
        c_pred = dataclasses.replace(c, nz=nzl + 4)
        c_bt = dataclasses.replace(c, nz=nzl + 2)
        u2, v2, w2 = (zpad(x, 2) for x in (f.u, f.v, f.w))
        p1 = zpad(f.p, 1)
        for shard in (0, SHARDS // 2, SHARDS - 1):
            z_off = shard * nzl
            timed = big and shard == SHARDS // 2
            stag = f"{tag} shard {shard}"
            blk = [x[z_off:z_off + nzl + 4] for x in (u2, v2, w2)]
            cells = blk[0].numel()
            us, vs, ws = check(
                "sharded", stag, timed, pkm.predictor_star, A1_SHARD, SRC,
                lambda: pkm.predictor_star(*blk, scal, c_pred, None,
                                           z_off - 2, nz_g),
                lambda: pkm.predictor_star_plain(*blk, scal, c_pred, None,
                                                 z_off - 2, nz_g),
                ("u*", "v*", "w*"), (bit,) * 3,
                work=((*blk, scal),
                      FLOPS_PER_POINT["predictor_star"] * cells),
                name="predictor_star[global_nz]")
            pb = p1[z_off:z_off + nzl + 2]
            check("sharded", stag, timed, pkm.poisson_input, A5_BT_SHARD,
                  SRC,
                  lambda: pkm.poisson_input(us[1:-1], vs[1:-1], ws[1:-1], pb,
                                            rod, c_bt, z_off - 1, nz_g),
                  lambda: pkm.poisson_input_plain(us[1:-1], vs[1:-1],
                                                  ws[1:-1], pb, rod, c_bt,
                                                  z_off - 1, nz_g),
                  ("b~",), (bit,),
                  work=((us[1:-1], vs[1:-1], ws[1:-1], pb),
                        FLOPS_PER_POINT["poisson_input"] * pb.numel()),
                  name="poisson_input[global_nz]")
            del blk, us, vs, ws, pb
        if big:
            # the corrector's 1-halo x^ block of a middle shard: the
            # inverse DST (SGEMM, 3xTF32 at HIGH) and the corrector
            nb = nzl + 2
            z0 = (SHARDS // 2) * nzl - 1
            xb = f.p[z0:z0 + nb]
            usb, vsb, wsb = (x[z0:z0 + nb] for x in (f.u, f.v, f.w))
            cb = dataclasses.replace(c, nz=nb)
            dot_ops = (gemm_flops(nb * N_BIG, N_BIG, N_BIG)
                       + gemm_flops(N_BIG, N_BIG, N_BIG, nb))
            pbk = check(
                "sharded", f"{tag} x^ block", True, rolling.plane_dot,
                A5_CORR_SHARD, SRC_SGEMM,
                lambda: rolling.plane_dot(xb, gxt, gy),
                lambda: rolling.plane_dot_plain(xb, gxt, gy),
                ("inverse",), (gemm,), work=((xb, gxt, gy), dot_ops),
                library=ieee_matmul(lambda: torch.einsum(
                    "ij,kjl,lm->kim", gy, xb, gxt)))[0]
            check("sharded-high", f"{tag} x^ block", True,
                  rolling.plane_dot, A5_CORR_SHARD, SRC_GEMM,
                  lambda: rolling.plane_dot(xb, gxt, gy, "high"),
                  lambda: rolling.plane_dot_plain(xb, gxt, gy, "high"),
                  ("inverse",), (gemm,), work=((xb, gxt, gy), 3 * dot_ops),
                  library=ieee_matmul(lambda: torch.einsum(
                      "ij,kjl,lm->kim", gy, xb, gxt)),
                  name="plane_dot[3xtf32]", rate=TF32_TC_FLOPS)
            check("sharded", f"{tag} x^ block", True, pkm.corrector,
                  A5_CORR_SHARD, SRC,
                  lambda: pkm.corrector(usb, vsb, wsb, pbk, s, cb),
                  lambda: pkm.corrector_plain(usb, vsb, wsb, pbk, s, cb),
                  ("u", "v", "w", "max|u|^2", "max p", "max|p|"),
                  (fld,) * 3 + ((TOL_DIAG, True), gemm, gemm),
                  work=((usb, vsb, wsb, pbk),
                        FLOPS_PER_POINT["corrector"] * pbk.numel()))
            del xb, usb, vsb, wsb, pbk
        del f, u2, v2, w2, p1
        torch.cuda.empty_cache()
    # the call-time-mu Thomas pair on the 512^3 z-solve's y-pencils: a
    # middle shard's (512, 128, 512) slab with its rows of mu
    n = N_BIG
    nyl = n // SHARDS
    prob_s = PoissonProblem(n, n, n, 1.0 / (n - 1), 1.0 / (n - 1),
                            1.0 / (n - 1))
    _, zs_probe = spectral.make_dst_fused_sharded_pieces(
        prob_s, SHARDS, LocalComm([dev] * SHARDS), torch.float32)
    mu_rows, w_s = zs_probe.mu_rows[SHARDS // 2], zs_probe.w
    gen = torch.Generator(device=dev).manual_seed(SEED)
    r = torch.randn((n, nyl, n), generator=gen, device=dev)
    r[0] = 0.0
    r[-1] = 0.0
    ptag = f"{n}x{nyl}x{n} pencil"
    print(f"phase 42 call-time-mu Thomas vs plain at {ptag}", flush=True)
    d, t = check("sharded", ptag, True, tdma.tdma_z_fwd, A4_MU, SRC,
                 lambda: tdma.tdma_z_fwd(r, mu_rows, w_s),
                 lambda: tdma.tdma_z_fwd_reference(r, mu_rows, w_s),
                 ("d'", "t"), (bit, bit),
                 work=((r, mu_rows), FLOPS_PER_POINT["tdma_fwd"]
                       * r.numel()))
    check("sharded", ptag, True, tdma.tdma_z_bwd, A4_MU, SRC,
          lambda: tdma.tdma_z_bwd(d, t),
          lambda: tdma.tdma_z_bwd_reference(d, t), ("x^",), (bit,),
          work=((d, t), FLOPS_PER_POINT["tdma_bwd"] * d.numel()))
    run_mu = tdma.make_tdma_z(n, nyl, n, None, w_s)
    xk, xp = run_mu(r, mu_rows), tdma.tdma_z_reference(r, mu_rows, w_s)
    sync()
    compare(ptag, "make_tdma_z(mu=None).x^", xk, xp, *bit)
    del r, d, t, xk, xp, zs_probe
    torch.cuda.empty_cache()
    print(f"phase 42 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 43: the sharded step at full width ---------------------------
    # make_sharded_step on run_3d's 512^3 configuration over 4 z-shards
    # emulated on the one card (LocalComm), at HIGHEST and HIGH: 3 warm-up
    # and 5 timed steps each, against the single-device kernel step from
    # the same field (phase 4's, timed here in the same way).  One card
    # cannot measure scaling: what this times is the per-shard kernels at
    # their shard shapes plus the emulated collectives' copies.
    t_phase = time.perf_counter()
    shape = (n, n, n)
    cells = n ** 3
    grid = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    params = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                      mu=0.01)
    mesh4 = make_mesh([dev] * SHARDS, axes=("z",))
    sharded_rec = {}

    def timed_steps(stepf, f0):
        run_steps(stepf, f0, 1e-4, 3)
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, res = run_steps(stepf, f0, 1e-4, TIMED_STEPS)
        end.record()
        sync()
        return out, res, start.elapsed_time(end) / TIMED_STEPS

    def sharded_wrappers(high):
        counts = {"predictor_star[global_nz]":
                  pkm.predictor_star.global_nz_launches,
                  "poisson_input[global_nz]":
                  pkm.poisson_input.global_nz_launches,
                  "tdma_z_fwd": tdma.tdma_z_fwd.launches,
                  "tdma_z_bwd": tdma.tdma_z_bwd.launches,
                  "corrector": pkm.corrector.launches}
        if high:
            counts["plane_dot[3xtf32]"] = rolling.plane_dot.high_launches
        else:
            counts["plane_dot"] = rolling.plane_dot.launches
        return counts

    for prec in (None, "high"):
        label = f"phase 43 sharded {n}^3 over {SHARDS} z-shards " \
                f"{'HIGH' if prec else 'HIGHEST'}"
        step_s, place = make_sharded_step(
            grid, params, mesh4, "projection",
            poisson_method=Method.FFT_DIRECT, spectral_precision=prec)
        single = make_projection_step(grid, params, torch.float32,
                                      Method.FFT_DIRECT, device=dev,
                                      spectral_precision=prec)
        f0 = tg_field(shape)
        fs0 = place(f0)
        run_steps(step_s, fs0, 1e-4, 3)
        sync()
        pkm.reset_launch_counts()
        tdma.tdma_z_fwd.launches = tdma.tdma_z_bwd.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fs, res_s = run_steps(step_s, fs0, 1e-4, TIMED_STEPS)
        end.record()
        sync()
        ms_s = start.elapsed_time(end) / TIMED_STEPS
        counts = sharded_wrappers(prec == "high")
        print(f"{label}: launch counts over the main path {counts}",
              flush=True)
        if min(counts.values()) <= 0:
            fail(f"{label}: a kernel of the sharded step not launched")
        if prec == "high" and rolling.plane_dot.launches:
            fail(f"{label}: an SGEMM launched on the HIGH path")
        launch_counts["sharded-high" if prec else "sharded"] = counts
        no_element_loads(label, prec or "highest")
        f1, res_1, ms_1 = timed_steps(single, f0)
        g = gather_field(fs)
        print(f"{label}: {ms_s:.3f} ms/step, "
              f"{cells / (ms_s * 1e-3) / 1e6:.1f} MLUPS; single-device "
              f"kernel step {ms_1:.3f} ms/step, "
              f"{cells / (ms_1 * 1e-3) / 1e6:.1f} MLUPS; status "
              f"{int(res_s.status)}, max|u| {float(res_s.max_velocity)!r} "
              f"(single {float(res_1.max_velocity)!r})", flush=True)
        if int(res_s.status) != 0 or not bool(g.is_finite()):
            fail(f"{label}: nonzero status or non-finite fields")
        diffs = {}
        if prec is None:
            # the same arithmetic at every point and mode: expect 0.0;
            # the bar is the reference's sharded-vs-single-chip one
            # (tests/parallel/test_fused_sharded.py:83-87)
            for name, bar in (("u", 2e-6), ("v", 2e-6), ("w", 2e-6),
                              ("p", 2e-5)):
                diffs[name] = compare(f"{label} {TIMED_STEPS} steps vs "
                                      f"single-device", name,
                                      getattr(g, name), getattr(f1, name),
                                      bar, False)[0]
            for a in ("max_velocity", "max_pressure"):
                diffs[a] = abs(float(getattr(res_s, a))
                               - float(getattr(res_1, a)))
            print(f"{label}: max|sharded - single| {diffs} (0.0 expected "
                  f"at HIGHEST)", flush=True)
            if not diffs["max_velocity"] <= TOL_DIAG * float(
                    res_1.max_velocity):
                fail(f"{label}: diagnostics off the single-device step's")
        else:
            # the single-device HIGH step rebuilds t analytically, the
            # sharded z-solve stores it: held after one step at the
            # reference's HIGH bars (tests/math/test_mega_kernels.py:
            # 134-137) times max(1, max|.|), u, v, w with what the p
            # difference passes on through the corrector
            g1 = gather_field(step_s(fs0, 1e-4, 0)[0])
            s1 = single(f0, 1e-4, 0)[0]
            sync()
            tag = f"{label} first step vs single-device HIGH"

            def held(name, bar, passed=0.0):
                ref = getattr(s1, name)
                scale = max(1.0, float(ref.abs().max()))
                return compare(tag, name, getattr(g1, name), ref,
                               bar * scale + passed, False)[0]

            diffs["p"] = dp = held("p", HIGH_P)
            diffs["u"] = held("u", HIGH_U, 1e-4 / grid.dx0 * dp)
            diffs["v"] = held("v", HIGH_U, 1e-4 / grid.dy0 * dp)
            diffs["w"] = held("w", HIGH_U, 1e-4 / grid.dz0 * dp)
            del g1, s1
        sharded_rec["highest" if prec is None else "high"] = {
            "ms": ms_s, "mlups": cells / (ms_s * 1e-3) / 1e6,
            "single_ms": ms_1, "single_mlups": cells / (ms_1 * 1e-3) / 1e6,
            "max_abs_diff": diffs}
        del f0, fs0, fs, g, f1
        torch.cuda.empty_cache()
    # the emulated collectives alone, on this step's shapes: the two
    # y-pencil all_to_alls of the z-solve and the halo pads (2 planes of
    # u, v, w; 1 plane of x^) by concatenation
    comm4 = mesh4.comm
    slabs = [torch.randn((n // SHARDS, n, n), device=dev)
             for _ in range(SHARDS)]
    pencils = comm4.all_to_all(slabs, 1, 0)
    ms_a2a = (cuda_ms(lambda: comm4.all_to_all(slabs, 1, 0))
              + cuda_ms(lambda: comm4.all_to_all(pencils, 0, 1)))

    def pads():
        for k in (2, 2, 2, 1):
            [torch.cat([lo, b, hi]) for b, (lo, hi) in
             zip(slabs, comm4.halo(slabs, k))]

    ms_pad = cuda_ms(pads)
    sharded_rec["all_to_all_ms"] = ms_a2a
    sharded_rec["halo_pad_ms"] = ms_pad
    print(f"phase 43 the two emulated all_to_alls {ms_a2a:.3f} ms a step "
          f"(2 x 2 x {n}^3 x 4 bytes moved), the halo pads by "
          f"concatenation {ms_pad:.3f} ms a step", flush=True)
    del slabs, pencils
    torch.cuda.empty_cache()
    print(f"phase 43 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 44: float64 steps on the card --------------------------------
    # the plain step, on the card (the reference gates only its kernels on
    # float32): FFT_DIRECT and CG projection, Euler and RK2 at 33x17x9
    # against the same step on the CPU, 3 steps, at 1e-12; no kernel
    # wrapper may launch
    t_phase = time.perf_counter()
    g64 = Grid.uniform(33, 17, 9, zmin=0.0, zmax=1.0)
    rng64 = np.random.default_rng(SEED + 44)
    f64_cpu = FlowField.initialize(g64, dtype=torch.float64, device="cpu")
    f64_cpu = f64_cpu.replace(**{
        k: getattr(f64_cpu, k) + torch.from_numpy(
            rng64.normal(0.0, 0.05, g64.shape)) for k in "uvwp"})
    f64_dev = FlowField(*(getattr(f64_cpu, k).to(dev)
                          for k in ("u", "v", "w", "p", "rho", "T")))
    f64_makers = {
        "projection_fft_direct": lambda d: make_projection_step(
            g64, NSParams(), torch.float64, Method.FFT_DIRECT, device=d),
        "projection_cg": lambda d: make_projection_step(
            g64, NSParams(), torch.float64, Method.CG, device=d),
        "euler": lambda d: make_euler_step(g64, NSParams(), torch.float64,
                                           d),
        "rk2": lambda d: make_rk2_step(g64, NSParams(), torch.float64, d)}
    f64_rec = {}
    for name, maker in f64_makers.items():
        pkm.reset_launch_counts()
        for w_ in (ekm.euler_step, rkm.rk_stage, tdma.tdma_z_fwd,
                   tdma.tdma_z_bwd, cgk.lap_dot, cgk.cg_update):
            w_.launches = 0
        fd, rd = run_steps(maker(dev), f64_dev, 1e-4, 3)
        sync()
        touched = sum((pkm.predictor_star.launches, pkm.poisson_input.launches,
                       pkm.poisson_rhs.launches, pkm.corrector.launches,
                       rolling.plane_dot.launches, ekm.euler_step.launches,
                       rkm.rk_stage.launches, tdma.tdma_z_fwd.launches,
                       tdma.tdma_z_bwd.launches, cgk.lap_dot.launches,
                       cgk.cg_update.launches))
        fc, rc = run_steps(maker("cpu"), f64_cpu, 1e-4, 3)
        err = max(float((getattr(fd, k).cpu() - getattr(fc, k)).abs().max())
                  for k in "uvwp")
        f64_rec[name] = {"max_abs_diff": err, "status": int(rd.status),
                         "kernel_launches": touched}
        print(f"phase 44 float64 {name} 33x17x9 on {dev} vs cpu, 3 steps: "
              f"max|diff| {err!r} (bar 1e-12), status {int(rd.status)} / "
              f"{int(rc.status)}, kernel launches {touched}", flush=True)
        if fd.u.dtype != torch.float64 or fd.u.device.type != "cuda":
            fail(f"phase 44 {name}: not a float64 step on the card")
        if not err <= 1e-12 or int(rd.status) != int(rc.status):
            fail(f"phase 44 {name}: float64 on the card off the CPU step")
        if touched:
            fail(f"phase 44 {name}: a float64 step launched a kernel")
    print(f"phase 44 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 45: a one-rank NCCL group ------------------------------------
    # ProcessGroupComm on a one-rank NCCL group (file:// init) against
    # LocalComm with P = 1, 3 steps at 128x64x16 of the spectral and the
    # CG step (its dots through all_reduce(SUM)), bit for bit: shows the
    # process-group path builds and runs on CUDA; it measures nothing
    # about scaling (one rank exchanges nothing)
    t_phase = time.perf_counter()
    import tempfile

    import torch.distributed as dist

    g45 = Grid.uniform(128, 64, 16, zmin=0.0, zmax=1.0)
    f45 = noisy(FlowField.initialize(g45, dtype=torch.float32, device=dev),
                SEED + 45)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                world_size=1, rank=0)
        try:
            comm1 = ProcessGroupComm(device=dev)
            outs = {}
            for method in (Method.FFT_DIRECT, Method.CG):
                for kind, mesh1 in (
                        ("nccl", make_mesh([dev], axes=("z",), comm=comm1)),
                        ("local", make_mesh([dev], axes=("z",)))):
                    step1, place1 = make_sharded_step(
                        g45, NSParams(), mesh1, poisson_method=method)
                    fo, ro = run_steps(step1, place1(f45), 1e-3, 3)
                    outs[method.name, kind] = (gather_field(fo), ro)
            sync()
        finally:
            dist.destroy_process_group()
    nccl_diff = 0.0
    for method in ("FFT_DIRECT", "CG"):
        gn, gl = (outs[method, k][0] for k in ("nccl", "local"))
        diff = max(float((getattr(gn, k) - getattr(gl, k)).abs().max())
                   for k in "uvwp")
        status = int(outs[method, "nccl"][1].status)
        print(f"phase 45 one-rank NCCL group vs LocalComm(P=1) 128x64x16, "
              f"{method} step, 3 steps: max|diff| {diff!r}, status "
              f"{status}", flush=True)
        if diff != 0.0 or status != 0:
            fail(f"phase 45: the process-group {method} step differs from "
                 "LocalComm's")
        nccl_diff = max(nccl_diff, diff)
    del f45, outs, gn, gl
    print(f"phase 45 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 46: the sharded Krylov kernels against their plain versions
    # K1 (make_lap_dot_sharded) and the BiCGSTAB pv / st passes on the
    # halo-padded block of the first, a middle and the last of 4 z-shards
    # (z_base = z_off - 1), K2 and xr on the owned block, the rhs (A5's
    # divergence) in its global_nz mode, and the corrector on a 1-halo
    # block of a physical p (A5 corr_xy / corr_w), at 37x23x16 and on the
    # 512^3/4 slab: fields bit for bit, the shards' shares of the dots
    # at TOL_DOT (another summation order)
    t_phase = time.perf_counter()
    for shape in ((16, 23, 37), (N_BIG,) * 3):
        nz_g, ny_, nx_ = shape
        nzl = nz_g // SHARDS
        big = nz_g == N_BIG
        tag = "x".join(map(str, shape[::-1]))
        print(f"phase 46 sharded Krylov kernels vs plain at {tag} over "
              f"{SHARDS} z-shards", flush=True)
        grid, prob = cg_problem(shape)
        c_own = cgk.CGConsts(nzl, ny_, nx_, prob.inv_dx2, prob.inv_dy2,
                             prob.inv_dz2)
        c_pad = dataclasses.replace(c_own, nz=nzl + 2)
        b_own = bk.BiCGConsts(nzl, ny_, nx_, prob.inv_dx2, prob.inv_dy2,
                              prob.inv_dz2)
        b_pad = dataclasses.replace(b_own, nz=nzl + 2)
        sc_blk = pkm.StencilConsts(nzl + 2, ny_, nx_, grid.dx0, grid.dy0,
                                   grid.dz0, grid.xmin, grid.ymin, 0.01,
                                   False)
        gen = torch.Generator(device=dev).manual_seed(SEED + 46)
        r, p, v, x = (torch.randn(shape, generator=gen, device=dev)
                      for _ in range(4))
        rp, pp_, vp = (zpad(a, 1) for a in (r, p, v))
        beta = torch.full((), 0.37, device=dev)
        alpha = torch.full((), 0.61, device=dev)
        omega = torch.full((), 0.23, device=dev)
        rod, s_ = torch.full((), 1e4, device=dev), torch.full(
            (), 1e-4, device=dev)
        for shard in (0, SHARDS // 2, SHARDS - 1):
            z_off = shard * nzl
            timed = big and shard == SHARDS // 2
            stag = f"{tag} shard {shard}"
            own = slice(z_off, z_off + nzl)
            rb, pb, vb = (a[z_off:z_off + nzl + 2] for a in (rp, pp_, vp))
            xo, ro, po = x[own], r[own], p[own]
            cells = nzl * ny_ * nx_
            # timed as the solves launch them: in place, in a running state
            one = torch.ones((), device=dev)
            st_cg = cgk.new_state(one, one, 0 * one, 0 * one, one > 0)
            st_cg[cgk.BETA], st_cg[cgk.ALPHA] = beta, alpha
            st_b = bk.new_state(one, one, 0 * one, 0 * one, one > 0)
            st_b[bk.BETA], st_b[bk.OMEGA] = beta, omega
            st_b[bk.ALPHA_NEW], st_b[bk.ALPHA_EFF] = alpha, alpha
            st_b[bk.OMEGA_EFF] = omega
            cg_ops = cgk.ShardCGPasses(c_own, z_off, nz_g, dev)
            b_ops = bk.ShardBiCGSTABPasses(b_own, z_off, nz_g, dev)
            t1, t2 = torch.empty_like(ro), torch.empty_like(ro)
            pn, ap, _ = check(
                "sharded-cg", stag, timed, cgk.lap_dot, CG_SHARD, SRC_CG,
                lambda: cgk.lap_dot(rb, pb, beta, c_pad, z_off - 1, nz_g),
                lambda: cgk.lap_dot_plain(rb, pb, beta, c_pad, z_off - 1,
                                          nz_g),
                ("p'", "Ap'", "<p',Ap'>"), (bit, bit, dot),
                work=((rb, pb), FLOPS_PER_POINT["lap_dot"] * cells),
                time_fn=lambda: cg_ops.lap_dot(rb, pb, t1, t2, st_cg),
                name="lap_dot[global_nz]")
            xt, rt = xo.clone(), ro.clone()
            check("sharded-cg", stag, timed, cgk.cg_update, CG_UPD_SHARD,
                  SRC_CG,
                  lambda: cgk.cg_update(xo, ro, pn, ap, alpha, c_own, z_off,
                                        nz_g),
                  lambda: cgk.cg_update_plain(xo, ro, pn, ap, alpha, c_own,
                                              z_off, nz_g),
                  ("x'", "r'", "<r',r'>"), (bit, bit, dot),
                  work=((xo, ro, pn, ap),
                        FLOPS_PER_POINT["cg_update"] * cells),
                  time_fn=lambda: cg_ops.update(xt, rt, pn, ap, st_cg),
                  name="cg_update[global_nz]")
            check("sharded-bicgstab", stag, timed, bk.pass_pv, B1_SHARD,
                  SRC_BICG,
                  lambda: bk.pass_pv(rb, pb, vb, ro, beta, omega, b_pad,
                                     z_off - 1, nz_g),
                  lambda: bk.pass_pv_plain(rb, pb, vb, ro, beta, omega,
                                           b_pad, z_off - 1, nz_g),
                  ("p'", "v'", "<rhat,v'>"), (bit, bit, dot),
                  work=((rb, pb, vb, ro), FLOPS_PER_POINT["bicg_pv"] * cells),
                  time_fn=lambda: b_ops.pv(rb, pb, vb, ro, t1, t2, st_b),
                  name="pass_pv[global_nz]")
            sb, tb, *_ = check(
                "sharded-bicgstab", stag, timed, bk.pass_st, B1_SHARD,
                SRC_BICG,
                lambda: bk.pass_st(rb, vb, alpha, b_pad, z_off - 1, nz_g),
                lambda: bk.pass_st_plain(rb, vb, alpha, b_pad, z_off - 1,
                                         nz_g),
                ("s", "t", "<s,s>", "<t,s>", "<t,t>"),
                (bit, bit, dot, dot, dot),
                work=((rb, vb), FLOPS_PER_POINT["bicg_st"] * cells),
                time_fn=lambda: b_ops.st(rb, vb, t1, t2, st_b),
                name="pass_st[global_nz]")
            xt, rt = xo.clone(), ro.clone()
            check("sharded-bicgstab", stag, timed, bk.pass_xr, B1_XR_SHARD,
                  SRC_BICG,
                  lambda: bk.pass_xr(xo, po, sb, tb, ro, alpha, omega,
                                     b_own, z_off, nz_g),
                  lambda: bk.pass_xr_plain(xo, po, sb, tb, ro, alpha,
                                           omega, b_own, z_off, nz_g),
                  ("x'", "r'", "<r,r>", "<rhat,r>"), (bit, bit, dot, dot),
                  work=((xo, po, sb, tb, ro),
                        FLOPS_PER_POINT["bicg_xr"] * cells),
                  time_fn=lambda: b_ops.xr(xt, rt, po, sb, tb, ro, st_b),
                  name="pass_xr[global_nz]")
            check("sharded-cg", stag, timed, pkm.poisson_rhs, A5_DIV_SHARD,
                  SRC,
                  lambda: pkm.poisson_rhs(rb, pb, vb, rod, sc_blk, z_off - 1,
                                          nz_g),
                  lambda: pkm.poisson_rhs_plain(rb, pb, vb, rod, sc_blk,
                                                z_off - 1, nz_g),
                  ("rhs",), (bit,),
                  work=((rb, pb, vb),
                        FLOPS_PER_POINT["poisson_rhs"] * rb.numel()),
                  name="poisson_rhs[global_nz]")
            if shard == SHARDS // 2:
                check("sharded-cg", stag, timed, pkm.corrector, A5_CORR_XY,
                      SRC,
                      lambda: pkm.corrector(rb, pb, vb, rb, s_, sc_blk),
                      lambda: pkm.corrector_plain(rb, pb, vb, rb, s_,
                                                  sc_blk),
                      ("u", "v", "w", "max|u|^2", "max p", "max|p|"),
                      (bit,) * 6,
                      work=((rb, pb, vb, rb),
                            FLOPS_PER_POINT["corrector"] * rb.numel()))
            del rb, pb, vb, xo, ro, po, xt, rt, pn, ap, sb, tb, t1, t2
        del r, p, v, x, rp, pp_, vp
        torch.cuda.empty_cache()
    print(f"phase 46 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # the plain versions of the sharded Krylov steps' kernels: none may
    # run on their main paths (each is replaced by a tripwire meanwhile)
    PLAIN_CG = [(cgk, n) for n in ("lap_dot_plain", "cg_update_plain",
                                   "lap_dot_recur_plain",
                                   "update_recur_plain")]
    PLAIN_BICG = [(bk, n) for n in ("pass_pv_plain", "pass_st_plain",
                                    "pass_xr_plain", "pv_recur_plain",
                                    "st_recur_plain", "xr_recur_plain")]
    PLAIN_STEP = [(pkm, n) for n in ("predictor_star_plain",
                                     "poisson_rhs_plain", "corrector_plain")]

    @contextlib.contextmanager
    def no_plain(label, pairs):
        called = []
        saved = [(m, n, getattr(m, n)) for m, n in pairs]
        for m, n, fn in saved:
            def trip(*a, _n=n, _fn=fn, **k):
                called.append(_n)
                return _fn(*a, **k)
            setattr(m, n, trip)
        try:
            yield
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)
        if called:
            fail(f"{label}: plain versions ran on the main path: "
                 f"{sorted(set(called))}")

    def sharded_counts(wrappers, mode="global_nz"):
        """{record name: launches}: the ``mode`` counters (global_nz or
        global_ny) of the sharded wrappers, the plain counter of the
        corrector."""
        return {(w.__name__ if w is pkm.corrector
                 else f"{w.__name__}[{mode}]"):
                (w.launches if w is pkm.corrector
                 else getattr(w, f"{mode}_launches"))
                for w in wrappers}

    # the decomposed steps' GEMMs at each spectral precision: (precision,
    # record suffix, source, peak rate, passes, library call's matmul
    # mode), and the suffix of the main path whose counts each record takes
    GEMM_PRECISIONS = (
        ("highest", "", SRC_SGEMM, FP32_FLOPS, 1, ieee_matmul),
        ("high", "[3xtf32]", SRC_GEMM, TF32_TC_FLOPS, 3, ieee_matmul),
        ("default", "[tf32]", SRC_GEMM_TF32, TF32_TC_FLOPS, 1, tf32_matmul))
    GEMM_PATH = {"highest": "", "high": "-high", "default": "-default"}

    # ---- phase 47: bench.py's cg_512 over 4 z-shards ----------------------
    # phase 13's problem (512^3, tol 1e-6, check_interval 10) through
    # make_cg_fused_sharded on 4 shards emulated on the one card
    t_phase = time.perf_counter()
    n = N_BIG
    _, prob = cg_problem((n, n, n))
    pp = PoissonParams(tolerance=1e-6, max_iterations=2000,
                       check_interval=10)
    gen = torch.Generator(device=dev).manual_seed(7)
    rhs = prob.zero_boundary(torch.randn((n, n, n), generator=gen,
                                         device=dev))
    x0 = torch.zeros_like(rhs)
    cg_wrappers = (cgk.lap_dot, cgk.cg_update)
    make_cg_fused_sharded(prob, PoissonParams(
        tolerance=0.0, max_iterations=20), mesh4)(x0, rhs)  # warm-up
    sync()
    native.reset_counts(*cg_wrappers)
    solve = make_cg_fused_sharded(prob, pp, mesh4)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with no_plain("phase 47", PLAIN_CG):
        start.record()
        res = solve(x0, rhs)
        end.record()
        sync()
    ms_solve = start.elapsed_time(end)
    n_it, syncs = int(res.iterations), solve.host_syncs
    counts = sharded_counts(cg_wrappers)
    xd, rd = prob.zero_boundary(res.x.double()), rhs.double()
    true_rel = float(prob.interior(prob.laplacian(xd) - rd).norm()
                     / prob.interior(rd).norm())
    del xd, rd
    print(f"phase 47 cg_512 over {SHARDS} z-shards (512^3, tol 1e-6, "
          f"check_interval 10): {n_it} iterations, status "
          f"{int(res.status)}, {ms_solve:.1f} ms a solve, "
          f"{ms_solve / n_it:.4f} ms an iteration (single-device "
          f"{cg512['ms'] / cg512['iterations']:.4f}, phase 13), {syncs} "
          f"host syncs (bar {-(-n_it // krylov.CHUNK) + 2}), true relative "
          f"residual {true_rel:.4e}; launches {counts}", flush=True)
    if int(res.status) != PoissonStatus.CONVERGED or not true_rel <= 1e-3:
        fail("phase 47: not converged, or true residual above 1e-3")
    if abs(n_it - CG_512_ITERS) > 0.1 * CG_512_ITERS:
        fail(f"phase 47: {n_it} iterations, outside {CG_512_ITERS} ± 10%")
    if syncs > -(-n_it // krylov.CHUNK) + 2:
        fail("phase 47: more host syncs than one a chunk")
    if min(counts.values()) <= 0:
        fail(f"phase 47: a sharded CG kernel not launched: {counts}")
    # the halo-plane copies of one iteration alone (r and p', one plane a
    # side of each shard), against a concatenation of the same blocks
    bufs = [torch.zeros((n // SHARDS + 2, n, n), device=dev)
            for _ in range(SHARDS)]
    ms_fill = cuda_ms(lambda: [mesh4.comm.fill_halo(bufs, 1)
                               for _ in range(2)])
    owned = [b[1:-1] for b in bufs]
    ms_cat = cuda_ms(lambda: [[torch.cat([lo, b, hi]) for b, (lo, hi) in
                               zip(owned, mesh4.comm.halo(owned, 1))]
                              for _ in range(2)])
    print(f"phase 47 halo exchange of r and p' a CG iteration: plane "
          f"copies {ms_fill:.4f} ms, by concatenation {ms_cat:.4f} ms",
          flush=True)
    cg512_sharded = {"iterations": n_it, "ms": ms_solve,
                     "ms_per_iteration": ms_solve / n_it,
                     "host_syncs": syncs, "true_rel_residual": true_rel,
                     "halo_fill_ms": ms_fill, "halo_concat_ms": ms_cat}
    del rhs, x0, res, solve, bufs, owned
    torch.cuda.empty_cache()
    print(f"phase 47 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    def t_bar(tag, got, ref):
        """The reference's T bar: |got - ref| <= 1e-5 + 1e-7·|ref|."""
        got, ref = got.double(), ref.double()
        err = float((got - ref).abs().max())
        excess = float(((got - ref).abs() - 1e-7 * ref.abs()).max())
        print(f"  {tag} T: max_abs={err:.3e}, excess over rtol 1e-7 "
              f"{excess:.3e} (bar 1e-5)", flush=True)
        if not excess <= 1e-5:
            fail(f"{tag} T: beyond atol 1e-5 + rtol 1e-7")
        return err

    def krylov_step_pair(label, shape, method, pparams, wrappers, path,
                         plains, mesh=None, mode="global_nz", params=None,
                         field_fn=None):
        """The sharded step over ``mesh`` (default 4 z-shards) and the
        single-device kernel step, run_3d's physics (or ``params``) from
        the Taylor-Green start (or ``field_fn(shape)``): 3 warm-up steps,
        then 3 timed from the same start; the counters (``mode``'s) set
        to 0 just before the sharded timed steps and read just after.
        Holds the fields after the timed steps at TOL_CG_UVW and close_p
        (T, with the energy equation, at the reference's T bar), and
        prints the two first (warm-up) steps' difference; returns the
        record."""
        gridk = uniform_grid(shape)
        params_k = params or params_cg
        f0 = (field_fn or tg_field)(shape)
        step_s, place = make_sharded_step(
            gridk, params_k, mesh or mesh4, "projection",
            poisson_method=method, poisson_params=pparams)
        single = make_projection_step(gridk, params_k, torch.float32,
                                      method, poisson_params=pparams,
                                      device=dev)
        out, first = {}, {}
        for kind, stepf, start_f in (("sharded", step_s, place(f0)),
                                     ("single", single, f0)):
            f_1 = stepf(start_f, 1e-4, 0)[0]
            g_1 = f_1.gather() if kind == "sharded" else f_1
            first[kind] = {name: getattr(g_1, name) for name in "uvwp"}
            del g_1
            run_steps(stepf, f_1, 1e-4, CG_STEPS - 1, start_iter=1)
            del f_1
            sync()
            if kind == "sharded":
                pkm.reset_launch_counts()
                native.reset_counts(*wrappers)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            guard = (no_plain(label, plains) if kind == "sharded"
                     else contextlib.nullcontext())
            with guard:
                start.record()
                f, its, stats = start_f, [], []
                for i in range(CG_STEPS):
                    f, r = stepf(f, 1e-4, i)
                    its.append(stepf.last_poisson.iterations)
                    stats.append(r.status)
                end.record()
                sync()
            ms = start.elapsed_time(end) / CG_STEPS
            its, stats = [int(t) for t in its], [int(t) for t in stats]
            out[kind] = (f.gather() if kind == "sharded" else f, its,
                         stats, ms)
            print(f"{label} {kind}: {ms:.3f} ms/step, "
                  f"{math.prod(shape) / (ms * 1e-3) / 1e6:.1f} MLUPS, "
                  f"iterations a step {its}, {ms / (sum(its) / CG_STEPS):.4f}"
                  f" ms an iteration, statuses {stats}", flush=True)
            if any(st != 0 for st in stats) or not bool(out[kind][0]
                                                        .is_finite()):
                fail(f"{label} {kind}: nonzero status or non-finite")
            if kind == "sharded":
                counts = sharded_counts(wrappers, mode)
                print(f"{label} launch counts over the main path: {counts}",
                      flush=True)
                if min(counts.values()) <= 0:
                    fail(f"{label}: a kernel of the sharded step not "
                         f"launched: {counts}")
                launch_counts[path] = counts
            if do_profile:
                profile_steps(torch, f"phase 5 {label} {kind}",
                              lambda: run_steps(stepf, start_f, 1e-4, 1), 1)
        d_1 = {name: float((first["sharded"][name] - first["single"][name])
                           .abs().max()) for name in "uvwp"}
        print(f"{label} first step: max|sharded - single-device| {d_1}, "
              f"max|p| {float(first['single']['p'].abs().max())!r}",
              flush=True)
        del first
        fs, f1 = out["sharded"][0], out["single"][0]
        for name in "uvw":
            compare(f"{label} {CG_STEPS} steps vs single-device", name,
                    getattr(fs, name), getattr(f1, name), TOL_CG_UVW, False)
        close_p(f"{label} {CG_STEPS} steps vs single-device", fs.p, f1.p)
        if params_k.energy_enabled:
            t_bar(f"{label} {CG_STEPS} steps vs single-device", fs.T, f1.T)
        return {"ms": out["sharded"][3], "single_ms": out["single"][3],
                "iterations": out["sharded"][1],
                "single_iterations": out["single"][1],
                "first_step_max_abs_diff": d_1}

    # ---- phase 48: the 512^3 CG step over 4 z-shards ----------------------
    t_phase = time.perf_counter()
    step_wrappers = (pkm.predictor_star, pkm.poisson_rhs, pkm.corrector)
    cg_step_sharded = krylov_step_pair(
        f"phase 48 CG step {n}^3 over {SHARDS} z-shards (tolerance 1e-3)",
        (n, n, n), Method.CG, PoissonParams(tolerance=1e-3),
        step_wrappers + cg_wrappers, "sharded-cg", PLAIN_CG + PLAIN_STEP)
    torch.cuda.empty_cache()
    print(f"phase 48 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 49: the BiCGSTAB step over 4 z-shards -------------------------
    # phase 25's configuration (128^3, its tolerance) against the
    # single-device kernel step there
    t_phase = time.perf_counter()
    bicg_step_sharded = krylov_step_pair(
        f"phase 49 BiCGSTAB step {N_BICG_STEP}^3 over {SHARDS} z-shards "
        f"(tolerance {bicg_step_tol:g})", (N_BICG_STEP,) * 3,
        Method.BICGSTAB, PoissonParams(tolerance=bicg_step_tol),
        step_wrappers + tuple(bk.WRAPPERS), "sharded-bicgstab",
        PLAIN_BICG + PLAIN_STEP)
    torch.cuda.empty_cache()
    print(f"phase 49 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ==== the (z, y)-decomposed step (cfd_tpu_torch.parallel on a (Pz, Py)
    # mesh, its shards emulated on the one card) ===========================
    # ---- phase 50: the global-row kernel modes against their plain twins --
    # The predictor (2 planes and 2 rows a side), b~ and the CG rhs on its
    # owned window, the corrector on the owned window of a 1-padded p
    # block, and the CG passes K1 / K2 on 1-padded blocks, at 37x23x16 on
    # blocks of 4 planes and 8 rows at the first, a middle and the last
    # shard position of each axis (23 rows: the last block overlaps its
    # neighbour) and on the four (2, 2) blocks of 512^3: fields bit for
    # bit, the dots' shares at TOL_DOT.  Then the x-DST SGEMM / 3xTF32
    # GEMM and the y/z solve's z-stage products at the 512^3 (2, 2)
    # shard's shapes, at the GEMMs' 2e-5·max.
    t_phase = time.perf_counter()
    ZY = (2, 2)
    pad_zy = torch.nn.functional.pad

    def zy_blocks(a, h, shards_, nzl, nyl):
        """Each shard's block of ``a`` with h planes and h rows a side
        (zeros past the global ends)."""
        ap = pad_zy(a, (0, 0, h, h, h, h)) if h else a
        return [ap[z0:z0 + nzl + 2 * h, y0:y0 + nyl + 2 * h].contiguous()
                for z0, y0 in shards_]

    for shape in ((16, 23, 37), (N_BIG,) * 3):
        nz_g, ny_g, nx_ = shape
        big = nz_g == N_BIG
        nzl, nyl = (nz_g // ZY[0], ny_g // ZY[1]) if big else (4, 8)
        shards_ = ([(zi * nzl, yi * nyl) for zi in range(ZY[0])
                    for yi in range(ZY[1])] if big else
                   [(0, 0), (8, 8), (nz_g - nzl, ny_g - nyl)])
        tag = "x".join(map(str, shape[::-1]))
        print(f"phase 50 global-row kernels vs plain at {tag}, blocks of "
              f"{nzl} planes x {nyl} rows at {shards_}", flush=True)
        f, (fxt, fy, gxt, gy), mu, w, c = make_inputs(shape, SEED + 50)
        grid, prob = cg_problem(shape)
        dt = torch.full((), 1e-3, device=dev)
        scal = torch.stack([dt, torch.full((), 0.1, device=dev),
                            torch.full((), 0.05, device=dev)])
        rod, s = 1.0 / dt, dt / 1.0
        c_pred = dataclasses.replace(c, nz=nzl + 4, ny=nyl + 4)
        c_p = dataclasses.replace(c, nz=nzl + 2, ny=nyl + 2)
        c_cg = cgk.CGConsts(nzl + 2, nyl + 2, nx_, prob.inv_dx2,
                            prob.inv_dy2, prob.inv_dz2)
        beta = torch.full((), 0.37, device=dev)
        alpha = torch.full((), 0.61, device=dev)
        for b_i, (z0, y0) in enumerate(shards_):
            timed = big and b_i == 1
            stag = f"{tag} block ({z0}, {y0})"
            u2, v2, w2 = (zy_blocks(x, 2, [(z0, y0)], nzl, nyl)[0]
                          for x in (f.u, f.v, f.w))
            po = zy_blocks(f.p, 0, [(z0, y0)], nzl, nyl)[0]
            p1 = zy_blocks(f.p, 1, [(z0, y0)], nzl, nyl)[0]
            own_cells = po.numel()
            zb, yb = (z0 - 2, nz_g, y0 - 2, ny_g), (z0 - 1, nz_g, y0 - 1,
                                                    ny_g)
            us, vs, ws = check(
                "sharded-zy", stag, timed, pkm.predictor_star, A1_ZY, SRC,
                lambda: pkm.predictor_star(u2, v2, w2, scal, c_pred, None,
                                           *zb),
                lambda: pkm.predictor_star_plain(u2, v2, w2, scal, c_pred,
                                                 None, *zb),
                ("u*", "v*", "w*"), (bit,) * 3,
                work=((u2, v2, w2, scal),
                      FLOPS_PER_POINT["predictor_star"] * u2.numel()),
                name="predictor_star[global_ny]")
            win1 = [x[1:-1, 1:-1] for x in (us, vs, ws)]
            check("sharded-zy", stag, timed, pkm.poisson_input, A5_BT_ZY,
                  SRC,
                  lambda: pkm.poisson_input(us, vs, ws, po, rod, c_pred,
                                            *zb, 2),
                  lambda: pkm.poisson_input_plain(us, vs, ws, po, rod,
                                                  c_pred, *zb, 2),
                  ("b~",), (bit,), work=((*win1, po),
                                         FLOPS_PER_POINT["poisson_input"]
                                         * own_cells),
                  name="poisson_input[global_ny]")
            check("sharded-zy-cg", stag, timed, pkm.poisson_rhs, A5_DIV_ZY,
                  SRC,
                  lambda: pkm.poisson_rhs(us, vs, ws, rod, c_pred, *zb, 2),
                  lambda: pkm.poisson_rhs_plain(us, vs, ws, rod, c_pred,
                                                *zb, 2),
                  ("rhs",), (bit,), work=(win1, FLOPS_PER_POINT[
                      "poisson_rhs"] * own_cells),
                  name="poisson_rhs[global_ny]")
            win2 = [x[2:-2, 2:-2] for x in (us, vs, ws)]
            for path in ("sharded-zy", "sharded-zy-cg"):
                check(path, stag, timed, pkm.corrector_rows, A5_CORR_ZY,
                      SRC,
                      lambda: pkm.corrector_rows(us, vs, ws, p1, s, c_p,
                                                 *yb),
                      lambda: pkm.corrector_rows_plain(us, vs, ws, p1, s,
                                                       c_p, *yb),
                      ("u", "v", "w", "p", "max|u|^2", "max p", "max|p|"),
                      (bit,) * 7, work=((*win2, p1), FLOPS_PER_POINT[
                          "corrector"] * own_cells),
                      name="corrector_rows[global_ny]")
            rb, pb, xb = (zy_blocks(x, 1, [(z0, y0)], nzl, nyl)[0]
                          for x in (f.u, f.v, f.w))
            one = torch.ones((), device=dev)
            st_cg = cgk.new_state(one, one, 0 * one, 0 * one, one > 0)
            st_cg[cgk.BETA], st_cg[cgk.ALPHA] = beta, alpha
            cg_ops = cgk.ShardCGPasses(
                dataclasses.replace(c_cg, nz=nzl, ny=nyl), z0, nz_g, dev,
                y_off=y0, ny_g=ny_g)
            t1, t2 = torch.zeros_like(rb), torch.zeros_like(rb)
            pn, ap, _ = check(
                "sharded-zy-cg", stag, timed, cgk.lap_dot, CG_ZY, SRC_CG,
                lambda: cgk.lap_dot(rb, pb, beta, c_cg, *yb),
                lambda: cgk.lap_dot_plain(rb, pb, beta, c_cg, *yb),
                ("p'", "Ap'", "<p',Ap'>"), (bit, bit, dot),
                work=((rb, pb), FLOPS_PER_POINT["lap_dot"] * own_cells),
                time_fn=lambda: cg_ops.lap_dot(rb, pb, t1, t2, st_cg),
                name="lap_dot[global_ny]")
            pnb, apb = torch.zeros_like(rb), torch.zeros_like(rb)
            pnb[1:-1, 1:-1], apb[1:-1, 1:-1] = pn, ap
            xt, rt = xb.clone(), rb.clone()
            check("sharded-zy-cg", stag, timed, cgk.cg_update, CG_UPD_ZY,
                  SRC_CG,
                  lambda: cgk.cg_update(xb, rb, pnb, apb, alpha, c_cg, *yb),
                  lambda: cgk.cg_update_plain(xb, rb, pnb, apb, alpha, c_cg,
                                              *yb),
                  ("x'", "r'", "<r',r'>"), (bit, bit, dot),
                  work=([x[1:-1, 1:-1] for x in (xb, rb, pnb, apb)],
                        FLOPS_PER_POINT["cg_update"] * own_cells),
                  time_fn=lambda: cg_ops.update(xt, rt, pnb, apb, st_cg),
                  name="cg_update[global_ny]")
            del u2, v2, w2, po, p1, us, vs, ws, win1, win2, rb, pb, xb
            del pn, ap, pnb, apb, xt, rt, t1, t2
        if big:
            # the GEMMs of a (2, 2) shard: the x DSTs on its owned
            # (256, 256, 512) block, the z stage's (510 x 512) product on
            # its (512, 256 * 256) pencil
            gen = torch.Generator(device=dev).manual_seed(SEED + 50)
            bt = torch.randn((nzl, nyl, nx_), generator=gen, device=dev)
            pencil = torch.randn((nz_g, nyl * (nx_ // ZY[0])),
                                 generator=gen, device=dev)
            mz = nz_g - 2
            mzp = -(-mz // ZY[1]) * ZY[1]
            fz = torch.randn((mzp, nz_g), generator=gen, device=dev)
            x_ops = gemm_flops(nzl * nyl, nx_, nx_)
            z_ops = gemm_flops(mzp, pencil.shape[1], nz_g)
            tf32_plan(f"{tag} (2, 2) shard x-DST", nzl * nyl, nx_, nx_)
            tf32_plan(f"{tag} (2, 2) shard z stage", mzp, pencil.shape[1],
                      nz_g)
            for prec, suffix, src_, rate, mult, lib in GEMM_PRECISIONS:
                path = "sharded-zy" + GEMM_PATH[prec]
                check(path, f"{tag} (2, 2) shard", True, rolling.right_dot,
                      DOT_ZY, src_,
                      lambda: rolling.right_dot(bt, fxt, prec),
                      lambda: rolling.right_dot_plain(bt, fxt, prec),
                      ("x-DST",), (gemm,),
                      work=((bt, fxt), mult * x_ops),
                      library=lib(lambda: bt @ fxt),
                      name=f"right_dot{suffix}", rate=rate,
                      device_time=prec == "default",
                      repeat=prec == "default")
                check(path, f"{tag} (2, 2) shard", True, rolling.left_dot,
                      YZ_Z, src_,
                      lambda: rolling.left_dot(fz, pencil, precision=prec),
                      lambda: rolling.left_dot_plain(fz, pencil,
                                                     precision=prec),
                      ("z stage",), (gemm,),
                      work=((fz, pencil), mult * z_ops),
                      library=lib(lambda: fz @ pencil),
                      name=f"left_dot{suffix}", rate=rate,
                      device_time=prec == "default",
                      repeat=prec == "default")
            del bt, pencil, fz
        del f
        torch.cuda.empty_cache()
    print(f"phase 50 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 51: the (z, y) y/z solve against the one-device solve -----
    # The 512^3 (2, 2) pipeline (each shard's x DST, the y/z solve with
    # its four emulated all_to_alls, the inverse x DST) against the
    # one-device eigen pipeline (the same dense z stage) at 2e-5·max and,
    # printed, against the Thomas one; each stage timed.
    t_phase = time.perf_counter()
    n = N_BIG
    prob_zy = PoissonProblem(n, n, n, 1.0 / (n - 1), 1.0 / (n - 1),
                             1.0 / (n - 1))
    mesh22 = make_mesh([dev] * 4, shape=ZY)
    comm22 = mesh22.comm
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    btg = torch.zeros((n, n, n), device=dev)
    btg[1:-1, 1:-1, 1:-1] = torch.randn((n - 2,) * 3, generator=gen,
                                        device=dev)
    mats_zy, yzsolve = spectral.make_dst_fused_sharded_zy_pieces(
        prob_zy, *ZY, comm22, torch.float32)
    nzl, nyl = n // ZY[0], n // ZY[1]
    offs22 = [(zi * nzl, yi * nyl) for zi, yi in map(comm22.coords,
                                                     comm22.shards)]

    def zy_pipeline():
        xt = [rolling.right_dot(btg[z0:z0 + nzl, y0:y0 + nyl].contiguous(),
                                m[0]) for (z0, y0), m in zip(offs22, mats_zy)]
        return [rolling.right_dot(xh, m[1])
                for xh, m in zip(yzsolve(xt), mats_zy)]

    out = torch.empty_like(btg)
    for (z0, y0), blk in zip(offs22, zy_pipeline()):
        out[z0:z0 + nzl, y0:y0 + nyl] = blk
    ref_eig = spectral.make_fft_btilde_solver(prob_zy, z_mode="eigen")(btg)
    sync()
    zy_err, _ = compare("phase 51 (2, 2) y/z solve vs one-device eigen",
                        "x", out, ref_eig, TOL_GEMM, True)
    del ref_eig
    ref_td = spectral.make_fft_btilde_solver(prob_zy, z_mode="tdma")(btg)
    sync()
    td_err = float((out - ref_td).abs().max())
    td_scale = float(ref_td.abs().max())
    del ref_td, out
    print(f"phase 51 (2, 2) y/z solve vs the one-device Thomas solve: "
          f"max_abs {td_err:.3e} ({td_err / td_scale:.3e} of max|x|; the "
          f"dense z stage's rounding)", flush=True)
    # the stages alone, on the shards' shapes
    xt = [rolling.right_dot(btg[z0:z0 + nzl, y0:y0 + nyl].contiguous(),
                            m[0]) for (z0, y0), m in zip(offs22, mats_zy)]
    a1 = comm22.all_to_all(xt, 2, 0, "z")
    cx = n // ZY[0]
    mzp = -(-(n - 2) // ZY[1]) * ZY[1]
    lhs_z = torch.randn((mzp, n), generator=gen, device=dev)
    lhs_y = torch.randn((n - 2, n), generator=gen, device=dev)
    a2 = [rolling.left_dot(lhs_z, a.reshape(n, -1)).reshape(mzp, nyl, cx)
          for a in a1]
    a3 = comm22.all_to_all(a2, 0, 1, "y")
    yz_ms = {
        "solve_ms": cuda_ms(lambda: yzsolve(xt)),
        "solve_high_ms": None,
        "all_to_all_z_ms": cuda_ms(lambda: comm22.all_to_all(xt, 2, 0,
                                                              "z")),
        "all_to_all_y_ms": cuda_ms(lambda: comm22.all_to_all(a2, 0, 1,
                                                              "y")),
        "z_stage_gemm_ms": cuda_ms(lambda: [rolling.left_dot(
            lhs_z, a.reshape(n, -1)) for a in a1]),
        "y_stage_gemm_ms": cuda_ms(lambda: [rolling.left_dot(lhs_y, a)
                                            for a in a3]),
        "x_dst_gemm_ms": cuda_ms(lambda: [rolling.right_dot(
            x, m[0]) for x, m in zip(xt, mats_zy)])}
    mats_h, yz_high = spectral.make_dst_fused_sharded_zy_pieces(
        prob_zy, *ZY, comm22, torch.float32, "high")
    yz_ms["solve_high_ms"] = cuda_ms(lambda: yz_high(xt))
    yz_ms["max_abs_vs_eigen"] = zy_err
    yz_ms["max_abs_vs_thomas"] = td_err
    print(f"phase 51 (2, 2) y/z solve stages (4 shards, ms for all of "
          f"them): {yz_ms}; a step runs 2 z and 2 y all_to_alls, 2 z and 2 "
          f"y products and 2 x DSTs", flush=True)
    del btg, xt, a1, a2, a3, lhs_z, lhs_y, mats_zy, yzsolve, yz_high
    del mats_h
    torch.cuda.empty_cache()
    print(f"phase 51 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 52: the 512^3 FFT_DIRECT step over (2, 2) and (1, 4) ------
    # make_sharded_step on run_3d's 512^3 configuration, HIGHEST and HIGH,
    # against the single-device kernel step from the same field.  At
    # HIGHEST the first step is held against the float64 step on the card
    # (the plain chain, C2) at TOL_ZY_F64_*; the single-device float32
    # step's own distance from it and the two float32 steps' difference
    # are printed.  HIGH is held against the single-device HIGH step at
    # phase 43's HIGH bars.  Then 3 warm-up and 5 timed steps of each
    # (CUDA events), the counters set to 0 just before the timed sharded
    # steps and read just after, with every plain twin of the path a
    # tripwire; the two steps' difference after the timed steps is held
    # at TOL_ZY_DRIFT_*.
    t_phase = time.perf_counter()
    grid_zy = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    params_zy = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                         mu=0.01)
    shape_zy, cells_zy = (n, n, n), n ** 3
    PLAIN_ZY = ([(pkm, nm) for nm in ("predictor_star_plain",
                                       "poisson_input_plain",
                                       "poisson_rhs_plain",
                                       "corrector_rows_plain")]
                + [(rolling, nm) for nm in ("right_dot_plain",
                                            "left_dot_plain",
                                            "matmul_plain")])
    f0 = tg_field(shape_zy)
    s64 = make_projection_step(grid_zy, params_zy, torch.float64,
                               Method.FFT_DIRECT, device=dev)(
        FlowField(*(getattr(f0, nm).double() for nm in (
            "u", "v", "w", "p", "rho", "T"))), 1e-4, 0)[0]
    truth = {nm: getattr(s64, nm) for nm in "uvwp"}
    del s64, f0
    torch.cuda.empty_cache()

    def off_truth(fld):
        return {nm: float((getattr(fld, nm).double() - truth[nm]).abs()
                          .max()) for nm in "uvwp"}

    zy_rec = {}
    for mshape in (ZY, (1, 4)):
        meshz = make_mesh([dev] * 4, shape=mshape)
        for prec in (None, "high"):
            label = (f"phase 52 (z, y) {n}^3 over {mshape} "
                     f"{'HIGH' if prec else 'HIGHEST'}")
            step_s, place = make_sharded_step(
                grid_zy, params_zy, meshz, "projection",
                poisson_method=Method.FFT_DIRECT, spectral_precision=prec)
            single = make_projection_step(grid_zy, params_zy, torch.float32,
                                          Method.FFT_DIRECT, device=dev,
                                          spectral_precision=prec)
            f0 = tg_field(shape_zy)
            fs0 = place(f0)
            g1 = gather_field(step_s(fs0, 1e-4, 0)[0])
            s1 = single(f0, 1e-4, 0)[0]
            sync()
            tag = f"{label} first step"
            e_zy, e_1 = off_truth(g1), off_truth(s1)
            diffs = {nm: float((getattr(g1, nm) - getattr(s1, nm)).abs()
                               .max()) for nm in "uvwp"}
            print(f"{tag}: max|(z, y) - float64| {e_zy}, max|single-device "
                  f"- float64| {e_1}, max|(z, y) - single-device| {diffs}",
                  flush=True)
            if prec is None:
                pscale = float(truth["p"].abs().max())
                for nm in "uvwp":
                    bar = (TOL_ZY_F64_P * pscale if nm == "p"
                           else TOL_ZY_F64_UVW)
                    if not e_zy[nm] <= bar:
                        fail(f"{tag} {nm}: {e_zy[nm]:.3e} off the float64 "
                             f"step, above {bar:.3e}")
            else:
                def held(name_, bar, passed=0.0):
                    ref = getattr(s1, name_)
                    scale = max(1.0, float(ref.abs().max()))
                    return compare(tag + " vs single-device", name_,
                                   getattr(g1, name_), ref,
                                   bar * scale + passed, False)[0]

                dp = held("p", HIGH_P)
                held("u", HIGH_U, 1e-4 / grid_zy.dx0 * dp)
                held("v", HIGH_U, 1e-4 / grid_zy.dy0 * dp)
                held("w", HIGH_U, 1e-4 / grid_zy.dz0 * dp)
            del g1, s1
            run_steps(step_s, fs0, 1e-4, 3)
            sync()
            pkm.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with no_plain(label, PLAIN_ZY):
                start.record()
                fs, res_s = run_steps(step_s, fs0, 1e-4, TIMED_STEPS)
                end.record()
                sync()
            ms_s = start.elapsed_time(end) / TIMED_STEPS
            counts = sharded_counts((pkm.predictor_star, pkm.poisson_input,
                                     pkm.corrector_rows), "global_ny")
            key = "high_launches" if prec else "launches"
            sfx = "[3xtf32]" if prec else ""
            counts[f"right_dot{sfx}"] = getattr(rolling.right_dot, key)
            counts[f"left_dot{sfx}"] = getattr(rolling.left_dot, key)
            print(f"{label}: launch counts over the main path {counts}",
                  flush=True)
            if min(counts.values()) <= 0:
                fail(f"{label}: a kernel of the (z, y) step not launched")
            if prec and (rolling.right_dot.launches
                         or rolling.left_dot.launches):
                fail(f"{label}: an SGEMM launched on the HIGH path")
            no_element_loads(label, prec or "highest")
            path = "sharded-zy-high" if prec else "sharded-zy"
            if mshape == ZY:
                launch_counts[path] = counts
            f1, res_1, ms_1 = timed_steps(single, f0)
            g = gather_field(fs)
            drift = {name_: float((getattr(g, name_) - getattr(f1, name_))
                                  .abs().max()) for name_ in "uvwp"}
            print(f"{label}: {ms_s:.3f} ms/step, "
                  f"{cells_zy / (ms_s * 1e-3) / 1e6:.1f} MLUPS; single-device "
                  f"kernel step {ms_1:.3f} ms/step; status "
                  f"{int(res_s.status)}, max|u| "
                  f"{float(res_s.max_velocity)!r} (single "
                  f"{float(res_1.max_velocity)!r}); max|sharded - single| "
                  f"after {TIMED_STEPS} steps {drift}", flush=True)
            if int(res_s.status) != 0 or not bool(g.is_finite()):
                fail(f"{label}: nonzero status or non-finite fields")
            p1scale = float(f1.p.abs().max())
            for nm in "uvwp":
                bar = (TOL_ZY_DRIFT_P * p1scale if nm == "p"
                       else TOL_ZY_DRIFT_UVW)
                if not drift[nm] <= bar:
                    fail(f"{label} {nm}: {drift[nm]:.3e} from the "
                         f"single-device step after {TIMED_STEPS} steps, "
                         f"above {bar:.3e}")
            if do_profile and prec is None and mshape == ZY:
                profile_steps(torch, f"phase 5 {label}",
                              lambda: run_steps(step_s, fs0, 1e-4,
                                                PROFILED_STEPS),
                              PROFILED_STEPS)
            zy_rec[f"{mshape[0]}x{mshape[1]}_"
                   f"{'high' if prec else 'highest'}"] = {
                "ms": ms_s, "mlups": cells_zy / (ms_s * 1e-3) / 1e6,
                "single_ms": ms_1, "first_step_max_abs_diff": diffs,
                "first_step_off_float64": e_zy,
                "single_first_step_off_float64": e_1,
                f"max_abs_diff_after_{TIMED_STEPS}": drift}
            del f0, fs0, fs, g, f1
            torch.cuda.empty_cache()
    del truth
    zy_rec["yz_solve"] = yz_ms
    print(f"phase 52 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 53: cg_512 and the 512^3 CG step over (2, 2) --------------
    t_phase = time.perf_counter()
    _, prob = cg_problem((n, n, n))
    pp = PoissonParams(tolerance=1e-6, max_iterations=2000,
                       check_interval=10)
    gen = torch.Generator(device=dev).manual_seed(7)
    rhs = prob.zero_boundary(torch.randn((n, n, n), generator=gen,
                                         device=dev))
    x0 = torch.zeros_like(rhs)
    make_cg_fused_sharded(prob, PoissonParams(
        tolerance=0.0, max_iterations=20), mesh22)(x0, rhs)  # warm-up
    sync()
    native.reset_counts(*cg_wrappers)
    solve = make_cg_fused_sharded(prob, pp, mesh22)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with no_plain("phase 53", PLAIN_CG):
        start.record()
        res = solve(x0, rhs)
        end.record()
        sync()
    ms_solve = start.elapsed_time(end)
    n_it, syncs = int(res.iterations), solve.host_syncs
    counts = sharded_counts(cg_wrappers, "global_ny")
    xd, rd = prob.zero_boundary(res.x.double()), rhs.double()
    true_rel = float(prob.interior(prob.laplacian(xd) - rd).norm()
                     / prob.interior(rd).norm())
    del xd, rd
    print(f"phase 53 cg_512 over {ZY} (512^3, tol 1e-6, check_interval "
          f"10): {n_it} iterations (single-device {cg512['iterations']}, "
          f"phase 13), status {int(res.status)}, {ms_solve:.1f} ms a "
          f"solve, {ms_solve / n_it:.4f} ms an iteration (single-device "
          f"{cg512['ms'] / cg512['iterations']:.4f}), {syncs} host syncs, "
          f"true relative residual {true_rel:.4e}; launches {counts}",
          flush=True)
    if int(res.status) != PoissonStatus.CONVERGED or not true_rel <= 1e-3:
        fail("phase 53: not converged, or true residual above 1e-3")
    if n_it != cg512["iterations"]:
        fail(f"phase 53: {n_it} iterations, not the single-device "
             f"{cg512['iterations']}")
    if syncs > -(-n_it // krylov.CHUNK) + 2:
        fail("phase 53: more host syncs than one a chunk")
    if min(counts.values()) <= 0:
        fail(f"phase 53: a (z, y) CG kernel not launched: {counts}")
    cg512_zy = {"iterations": n_it, "ms": ms_solve,
                "ms_per_iteration": ms_solve / n_it, "host_syncs": syncs,
                "true_rel_residual": true_rel}
    del rhs, x0, res, solve
    torch.cuda.empty_cache()
    cg_step_zy = krylov_step_pair(
        f"phase 53 CG step {n}^3 over {ZY} (tolerance 1e-3)", (n, n, n),
        Method.CG, PoissonParams(tolerance=1e-3),
        (pkm.predictor_star, pkm.poisson_rhs, pkm.corrector_rows)
        + cg_wrappers, "sharded-zy-cg",
        PLAIN_CG + [(pkm, nm) for nm in ("predictor_star_plain",
                                         "poisson_rhs_plain",
                                         "corrector_rows_plain")],
        mesh=mesh22, mode="global_ny")
    if any(abs(a - b) > 2 for a, b in zip(cg_step_zy["iterations"],
                                          cg_step_zy["single_iterations"])):
        fail("phase 53: the (z, y) CG step's iterations a step off the "
             "single-device step's by more than 2")
    torch.cuda.empty_cache()
    print(f"phase 53 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ==== the decomposed explicit steps (cfd_tpu_torch.parallel.
    # fused_explicit: Euler, RK2 and RK4 over z, (z, y) and 2D y meshes,
    # the shards emulated on the one card) ================================
    # ---- phase 54: the explicit kernels' sharded modes against their
    # plain twins ----------------------------------------------------------
    # E3's and E2's global-row mode (euler_rows_kernel), RK3's global_nz
    # (whole rows, z pins) and global_nz + global_ny modes, RK2's global_ny
    # mode (rk_shard_kernel) on shard blocks cut from one field: at
    # 37x23x15 (37x23) the first, a middle and the last of a 3-way split
    # (5 planes, 8 rows; the last y block overlaps its neighbour), then
    # the 256^3 blocks of 4 z-shards and of (2, 2) and the 2048^2 blocks
    # of 4 y-shards.  Euler, and RK's first, mid and final stages; the
    # owned windows bit for bit (a mid stage's halos are the wrapper's).
    # One block of each mode is timed at the large sizes, by its device
    # time (a shard's kernel is shorter than its call's host work).
    t_phase = time.perf_counter()
    pad_x = torch.nn.functional.pad
    SB = ekm.ShardBlock
    explicit_shard_counts = {}

    def ex_block(a, z0, y0, nzl, nyl, hz, hy, ring):
        """The block of the global ``a`` around owned (z0, y0): hz planes
        (zeros past the z ends) and hy rows a side (zeros past the y
        ends, or the periodic ring's rows with ``ring``)."""
        if hy:
            a = (torch.cat([a[:, -hy:], a, a[:, :hy]], 1) if ring
                 else pad_x(a, (0, 0, hy, hy)))
        if hz:
            a = pad_x(a, (0, 0, 0, 0, hz, hz))
        return a[z0:z0 + nzl + 2 * hz, y0:y0 + nyl + 2 * hy].contiguous()

    def ex_field(shape, gen_seed):
        """Phase 9's inputs: noise on the initial field, one velocity at
        the clamps and one ρ below the guard."""
        nz_, ny_, nx_ = shape
        grid_ = uniform_grid(shape)
        gen_ = torch.Generator(device=dev).manual_seed(gen_seed)

        def rnd(scale):
            return scale * torch.randn(shape, generator=gen_, device=dev)

        f_ = FlowField.initialize(grid_, dtype=torch.float32, device=dev)
        u_ = f_.u + rnd(0.3)
        u_[nz_ // 2, ny_ // 3, nx_ // 3] = 150.0
        rho_ = f_.rho + rnd(0.01)
        rho_[nz_ // 2, ny_ // 2, nx_ // 2] = 1e-12
        st_ = tuple(x + rnd(0.01) for x in (u_, f_.v, f_.w, f_.p))
        acc_ = tuple(rnd(5.0) for _ in range(4))
        return (grid_, FlowField(u=u_, v=f_.v + rnd(0.3), w=rnd(0.3),
                                 p=f_.p + rnd(0.3), rho=rho_,
                                 T=f_.T + rnd(1.0)), st_, acc_)

    def mode_check(path, name, tag, timed, wrapper, replaces, source, grid_,
                   f_, st_, acc_, z0, y0, nzl, nyl, hz, hy, rows, rk):
        """One block's Euler step (``rk`` False) or RK first / mid / final
        stages against the plain twin."""
        three = f_.u.shape[0] > 1
        nz_g, ny_g, nx_ = f_.u.shape
        ring = rk and rows
        sb = SB(hz, hy, z0, nz_g if three else 1, y0, ny_g, rows)
        c_b = ekm.ExplicitConsts(nzl + 2 * hz if three else 1,
                                 nyl + 2 * hy, nx_, grid_.dx0, grid_.dy0,
                                 grid_.dz0, 0.01, 0.1)
        sy_g, sx_b = source_basis(grid_, torch.float32, dev)
        sy_b = pad_x(sy_g, (hy, hy))[y0:y0 + nyl + 2 * hy].contiguous()
        zs, ys = sb.window(c_b)

        def b(a):
            return ex_block(a, z0, y0, nzl, nyl, hz, hy, ring)

        def flat(o, window=False):
            """A sharded mode's (fields, maxima) as one tuple; a mid
            stage's fields cut to the owned window."""
            fields, m = o
            if window:
                return tuple(x[zs, ys] for x in fields.unbind())
            return (*fields.unbind(), *m.unbind())

        own = nzl * nyl * nx_
        # the points of a field the kernel must read: its owned ones, and
        # for a stencil field one halo plane (row) a side, where that side
        # is not past a global end (the faces pass through) or the halo
        # is the periodic ring (global row 1 reads its second row)
        z_sides = sum(not e for e in (z0 == 0, z0 + nzl == nz_g)) \
            if hz else 0
        y_sides = sum(ring or not e for e in (y0 == 0, y0 + nyl == ny_g)) \
            if hy else 0
        stencil = (nzl * nyl + z_sides * nyl + y_sides * nzl) * nx_

        def read_bytes(n_stencil, n_owned, small):
            return 4 * (n_stencil * stencil + n_owned * own) + nbytes(small)

        if not rk:
            ins = tuple(b(getattr(f_, n)) for n in
                        ("u", "v", "w", "p", "T", "rho")) + (
                sy_b, sx_b, torch.tensor([1e-4, 0.08, 0.04], device=dev))
            # u, v, w, p by the stencil; T (no energy equation) and ρ at
            # owned points
            check(path, tag, timed, wrapper, replaces, source,
                  lambda: flat(wrapper(*ins, c_b, sb)),
                  lambda: flat(ekm.euler_step_rows_plain(*ins, c_b, sb)),
                  names6 + maxima4, (exact,) * 10,
                  work=(read_bytes(4, 2, ins[6:]),
                        FLOPS_PER_POINT["euler"] * own), name=name,
                  device_time=True)
            return
        q0 = tuple(b(getattr(f_, n)) for n in ("u", "v", "w", "p"))
        st_b = tuple(b(x) for x in st_)
        acc_b = tuple(b(x) for x in acc_)
        rho_b, T_b = b(f_.rho), b(f_.T)
        pins = None
        if three and (z0 == 0 or z0 + nzl == nz_g):
            def plane(k):
                return torch.stack([ex_block(x[k:k + 1], 0, y0, 1, nyl, 0,
                                             hy, ring)[0] for x in st_])
            far, near = plane(nz_g - 2), plane(1)
            pins = torch.cat([far if z0 == 0 else torch.zeros_like(far),
                              near if z0 + nzl == nz_g
                              else torch.zeros_like(near)])
        for label, a, final, fac, mix, wgt in (
                ("first", None, False, 5e-5, 0.0, 1.0),
                ("mid", acc_b, False, 5e-5, 0.0, 2.0),
                ("final", acc_b, True, 1e-4 / 6.0, 1.0, 0.0)):
            sc = torch.tensor([fac, mix, wgt, 0.08, 0.04, 1e-4], device=dev)
            kw = {"pins": pins} if three else {}

            def kern(a=a, final=final, sc=sc, kw=kw):
                return flat(wrapper(st_b, q0, rho_b, T_b, a, sy_b, sx_b, sc,
                                    c_b, final, sb, **kw), not final)

            def plain(a=a, final=final, sc=sc):
                return flat(rkm.rk_stage_shard_plain(
                    st_b, q0, rho_b, T_b, a, sy_b, sx_b, sc, c_b, final, sb,
                    pins), not final)

            outs = (names6 + maxima4 if final else
                    tuple(f"next {n}" for n in "uvwp")
                    + tuple(f"acc {n}" for n in "uvwp"))
            # the state by the stencil; q0, ρ, the accumulator and (the
            # final stage's, no energy equation) T at owned points; four
            # pin planes of owned rows a z edge the block holds
            n_owned = 5 + (4 if a is not None else 0) + (1 if final else 0)
            n_pins = 0 if pins is None else 4 * (
                (z0 == 0) + (z0 + nzl == nz_g))
            read = read_bytes(4, n_owned, (sy_b, sx_b, sc)) \
                + 4 * n_pins * nyl * nx_
            check(path, f"{tag} {label}", timed and label == "mid",
                  wrapper, replaces, source, kern, plain, outs,
                  (exact,) * len(outs),
                  work=(read, FLOPS_PER_POINT["rk_stage"] * own,
                        8 * 4 * own), name=name, device_time=True)

    for shape, splits, big in (
            ((15, 23, 37), None, False), ((N_EXPL,) * 3, 4, True),
            ((1, 23, 37), None, False), ((1, N_2D, N_2D), 4, True)):
        nz_g, ny_g, nx_ = shape
        three = nz_g > 1
        tag = "x".join(map(str, shape[::-1] if three else shape[:0:-1]))
        grid_, f_, st_, acc_ = ex_field(shape, SEED + 54)
        if three:
            zsplit = ([(z, 0) for z in range(0, nz_g, nz_g // 4)] if big
                      else [(0, 0), (5, 0), (10, 0)])
            nzl = nz_g // 4 if big else 5
            zysplit = ([(zi * nz_g // 2, yi * ny_g // 2) for zi in (0, 1)
                        for yi in (0, 1)] if big
                       else [(0, 0), (5, 8), (10, 15)])
            nzl2, nyl2 = (nz_g // 2, ny_g // 2) if big else (5, 8)
            print(f"phase 54 explicit sharded modes at {tag}: z blocks of "
                  f"{nzl} planes at {zsplit}, (z, y) blocks of {nzl2} x "
                  f"{nyl2} at {zysplit}", flush=True)
            for i, (z0, y0) in enumerate(zsplit):
                stag = f"{tag} z block {z0}"
                mode_check("sharded-euler3d", "euler_step[global_ny]", stag,
                           False, ekm.euler_step, E3_ZY, SRC_E, grid_, f_,
                           st_, acc_, z0, 0, nzl, ny_g, 1, 0, True, False)
                mode_check("sharded-rk3d", "rk_stage[global_nz]", stag,
                           big and i == 1, rkm.rk_stage, RK3_Z, SRC_RK,
                           grid_, f_, st_, acc_, z0, 0, nzl, ny_g, 1, 0,
                           False, True)
            for i, (z0, y0) in enumerate(zysplit):
                stag = f"{tag} (z, y) block ({z0}, {y0})"
                mode_check("sharded-euler3d", "euler_step[global_ny]", stag,
                           big and i == 1, ekm.euler_step, E3_ZY, SRC_E,
                           grid_, f_, st_, acc_, z0, y0, nzl2, nyl2, 1, 1,
                           True, False)
                mode_check("sharded-rk3d-zy", "rk_stage[global_ny]", stag,
                           big and i == 1, rkm.rk_stage, RK3_ZY, SRC_RK,
                           grid_, f_, st_, acc_, z0, y0, nzl2, nyl2, 1, 2,
                           True, True)
        else:
            nyl = ny_g // 4 if big else 8
            ysplit = ([y * nyl for y in range(4)] if big else [0, 8, 15])
            print(f"phase 54 explicit sharded modes at {tag}: y blocks of "
                  f"{nyl} rows at {ysplit}", flush=True)
            for i, y0 in enumerate(ysplit):
                stag = f"{tag} y block {y0}"
                mode_check("sharded-euler2d", "euler2d_step[global_ny]",
                           stag, big and i == 1, e2m.euler2d_step, E2_Y,
                           SRC_E, grid_, f_, st_, acc_, 0, y0, 1, nyl, 0, 1,
                           True, False)
                mode_check("sharded-rk2d", "rk2d_stage[global_ny]", stag,
                           big and i == 1, rk2m.rk2d_stage, RK2_Y, SRC_RK,
                           grid_, f_, st_, acc_, 0, y0, 1, nyl, 0, 2, True,
                           True)
        del grid_, f_, st_, acc_
        torch.cuda.empty_cache()
    print(f"phase 54 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 55: the 256^3 explicit steps over 4 z-shards, (2, 2) and
    # (1, 4) ---------------------------------------------------------------
    # bench.py's run_euler_3d / run_rk_3d configurations (phase 10's)
    # through make_sharded_step on LocalComm over [cuda:0] * 4, against the
    # single-device kernel step from the same field: the first step, then
    # 3 warm-up and 5 timed steps of each (CUDA events), the sharded
    # counters set to 0 just before the timed steps and read just after
    # (the plain twins tripwires); the fields held after the first step
    # and after the timed ones at TOL_SHARDED_EXPLICIT (expected 0: the
    # same arithmetic per point and the same faces), the step maxima
    # printed beside the single-device ones.
    t_phase = time.perf_counter()
    PLAIN_EXPL = [(ekm, "euler_step_rows_plain"), (ekm, "euler_step_plain"),
                  (rkm, "rk_stage_shard_plain"), (rkm, "rk_stage_plain")]
    expl_wrappers = {"explicit_euler": (ekm.euler_step, e2m.euler2d_step),
                     "rk2": (rkm.rk_stage, rk2m.rk2d_stage),
                     "rk4": (rkm.rk_stage, rk2m.rk2d_stage)}
    expl_makers = {"explicit_euler": make_euler_step, "rk2": make_rk2_step,
                   "rk4": make_rk4_step}
    explicit_sharded = {}

    def timed_run(stepf, f0, n_warm, n_timed, before=None):
        run_steps(stepf, f0, EXPL_DT, n_warm)
        sync()
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, res = run_steps(stepf, f0, EXPL_DT, n_timed)
        end.record()
        sync()
        return out, res, start.elapsed_time(end) / n_timed

    def held(label, g, ref, tol=TOL_SHARDED_EXPLICIT):
        diff = {nm: float((getattr(g, nm) - getattr(ref, nm)).abs().max())
                for nm in names6}
        worst = max(diff.values())
        print(f"  {label}: max|sharded - single-device| {worst!r} "
              f"{'(bit-equal)' if worst == 0.0 else diff}", flush=True)
        if not worst <= tol:
            fail(f"{label}: {worst:.3e} from the single-device step, above "
                 f"{tol:.1e}")
        return worst

    def maxima_agree(rs, r1):
        """The step maxima within TOL_SHARDED_EXPLICIT of max(1, |·|)."""
        return all(abs(float(getattr(rs, k)) - float(getattr(r1, k)))
                   <= TOL_SHARDED_EXPLICIT * max(1.0, abs(float(
                       getattr(r1, k))))
                   for k in ("max_velocity", "max_pressure",
                             "max_temperature"))

    def sharded_vs_single(label, method, grid_, params_, mesh_, field_fn,
                          shape, n_warm, n_timed, key, profile=False):
        """The sharded and the single-device kernel step from one field:
        held after the first step and after the timed steps; returns the
        record of ms a step and differences."""
        three = shape[0] > 1
        wrapper = expl_wrappers[method][0 if three else 1]
        mode = ("global_nz" if method != "explicit_euler" and three
                and mesh_zy_sizes(mesh_)[1] == 1 else "global_ny")
        single = expl_makers[method](grid_, params_, torch.float32, dev)
        step_s, place = make_sharded_step(grid_, params_, mesh_, method)
        f0 = field_fn(shape)
        d_first = held(f"{label} first step",
                       gather_field(step_s(place(f0), EXPL_DT, 0)[0]),
                       single(f0, EXPL_DT, 0)[0])
        f1, r1, ms1 = timed_run(single, f0, n_warm, n_timed)
        fs0 = place(f0)
        counter = f"{mode}_launches"
        with no_plain(label, PLAIN_EXPL):
            fs, rs, mss = timed_run(step_s, fs0, n_warm, n_timed,
                                    lambda: setattr(wrapper, counter, 0))
        n_launch = getattr(wrapper, counter)
        name_ = f"{wrapper.__name__}[{mode}]"
        explicit_shard_counts.setdefault(key, {}).setdefault(name_, 0)
        explicit_shard_counts[key][name_] += n_launch
        cells_ = int(np.prod(shape))
        print(f"{label}: {mss:.4f} ms/step ({cells_ / (mss * 1e-3) / 1e6:.1f}"
              f" MLUPS) against the single-device kernel step's {ms1:.4f} "
              f"(ratio {mss / ms1:.3f}); status {int(rs.status)}, max|u| "
              f"{float(rs.max_velocity)!r} (single "
              f"{float(r1.max_velocity)!r}), max p "
              f"{float(rs.max_pressure)!r} (single "
              f"{float(r1.max_pressure)!r}); {name_} launches "
              f"{n_launch} over {n_timed} steps", flush=True)
        if n_launch <= 0:
            fail(f"{label}: {name_} not launched on the main path")
        if int(rs.status) != 0 or int(r1.status) != 0:
            fail(f"{label}: nonzero status")
        if not maxima_agree(rs, r1):
            fail(f"{label}: the step maxima differ from the single-device "
                 "step's")
        d_timed = held(f"{label} after {1 + 2 * n_warm + n_timed} steps "
                       f"in all", gather_field(fs), f1)
        rec = {"ms": mss, "single_ms": ms1, "ratio": mss / ms1,
               "first_step_max_abs_diff": d_first,
               "timed_max_abs_diff": d_timed, "launches": n_launch}
        if profile and do_profile:
            per, busy = profile_steps(
                torch, f"phase 5 {label}",
                lambda: run_steps(step_s, fs0, EXPL_DT, PROFILED_STEPS),
                PROFILED_STEPS)
            moves = sum(ms for nm, ms in per.items()
                        if any(k in nm for k in ("CatArray", "copy_kernel",
                                                 "Memcpy", "fill_kernel")))
            rec["halo_pad_copy_share"] = moves / busy
            print(f"{label}: halo and pad copies (concatenations, plane "
                  f"and row copies, fills) {moves / PROFILED_STEPS:.4f} "
                  f"ms/step, {moves / busy:.3f} of the device busy time",
                  flush=True)
        del f0, f1, fs0, fs
        return rec

    params_b = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                        mu=0.01)
    n3e = (N_EXPL,) * 3
    grid_e = uniform_grid(n3e)
    meshes55 = {"4z": make_mesh([dev] * 4, axes=("z",)),
                "2x2": make_mesh([dev] * 4),
                "1x4": make_mesh([dev] * 4, shape=(1, 4))}
    for method in ("explicit_euler", "rk2", "rk4"):
        for mname, mesh_ in meshes55.items():
            key = ("sharded-euler3d" if method == "explicit_euler" else
                   "sharded-rk3d" if mname == "4z" else "sharded-rk3d-zy")
            explicit_sharded[f"{method} {N_EXPL}^3 {mname}"] = \
                sharded_vs_single(
                    f"phase 55 {method} {N_EXPL}^3 over {mname}", method,
                    grid_e, params_b, mesh_, tg_field, n3e, 3, TIMED_STEPS,
                    key, profile=mname == "2x2")
        torch.cuda.empty_cache()
    print(f"phase 55 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 56: the 2048^2 steps over 4 y-shards, and the buoyant,
    # energy and stretched variants -----------------------------------------
    # run_euler_2d / run_rk_2d (phase 10's 2048^2 configurations) over 4
    # y-shards the same way; then, at 48x40x24 (z, (2, 2)) and 96x64 (y),
    # 3 steps of the buoyant + energy configuration (phase 31's face mix
    # "mixed" and "neumann_periodic", the default sources on), and of a
    # tanh-stretched grid in the parity and the consistent scheme (the
    # consistent one with the energy equation), against the single-device
    # kernel steps.
    t_phase = time.perf_counter()
    mesh_y4 = make_mesh([dev] * 4, axes=("y",))
    n2d = (1, N_2D, N_2D)
    grid_2 = uniform_grid(n2d)
    for method in ("explicit_euler", "rk2"):
        explicit_sharded[f"{method} {N_2D}^2 4y"] = sharded_vs_single(
            f"phase 56 {method} {N_2D}^2 over 4y", method, grid_2, params_b,
            mesh_y4, tg_field, n2d, 3, TIMED_STEPS,
            "sharded-euler2d" if method == "explicit_euler"
            else "sharded-rk2d")
    torch.cuda.empty_cache()

    def variant_field(shape):
        _, f_, _, _ = ex_field(shape, SEED + 56)
        return f_.replace(u=f_.u.clamp(-1.0, 1.0),
                          rho=f_.rho.clamp_min(0.5))

    var3, var2 = (24, 40, 48), (1, 64, 96)
    variants = []
    for faces in ("mixed", "neumann_periodic"):
        variants.append((f"buoyant+energy {faces}",
                         thermal_params(THERMAL_FACE_MIXES[faces]), None))
    variants.append(("stretched parity", NSParams(), "parity"))
    variants.append(("stretched consistent+energy",
                     dataclasses.replace(
                         thermal_params(THERMAL_FACE_MIXES["mixed"]),
                         beta=0.0, nonuniform_scheme="consistent"),
                     "consistent"))
    for vname, vparams, scheme in variants:
        for shape, mname, mesh_ in ((var3, "4z", meshes55["4z"]),
                                    (var3, "2x2", meshes55["2x2"]),
                                    (var2, "4y", mesh_y4)):
            three = shape[0] > 1
            if scheme is None:
                grid_v = uniform_grid(shape)
            elif three:
                grid_v = Grid.stretched(shape[2], shape[1], shape[0],
                                        zmin=0.0, zmax=1.0,
                                        beta=STRETCH_BETA,
                                        stretch_axes="xy")
            else:
                grid_v = Grid.stretched(shape[2], shape[1], 1,
                                        beta=STRETCH_BETA)
            for method in ("explicit_euler", "rk2", "rk4"):
                label = (f"phase 56 {method} {vname} "
                         f"{'x'.join(map(str, shape[::-1]))} over {mname}")
                single = expl_makers[method](grid_v, vparams, torch.float32,
                                             dev)
                step_s, place = make_sharded_step(grid_v, vparams, mesh_,
                                                  method)
                f0 = variant_field(shape)
                fs, rs = run_steps(step_s, place(f0), EXPL_DT, 3)
                f1, r1 = run_steps(single, f0, EXPL_DT, 3)
                sync()
                if int(rs.status) != 0 or not maxima_agree(rs, r1):
                    fail(f"{label}: status {int(rs.status)} or the maxima "
                         "off the single-device step's")
                explicit_sharded[label[len("phase 56 "):]] = held(
                    f"{label} 3 steps", gather_field(fs), f1)
    torch.cuda.empty_cache()
    print(f"phase 56 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 57: the facade on a mesh; a one-rank NCCL Euler step -------
    # Simulation.create(..., mesh=) against the single-device facade, 10
    # step() calls and one solve(): explicit_euler on 128x64 over 4
    # y-shards and on 64x48x24 over 4 z-shards, rk4 over (2, 2), the
    # spectral projection over 4 z-shards; then set_solver_by_name keeps
    # the mesh.  Then the Euler step at 128x64x16 on a one-rank NCCL
    # ProcessGroupComm against LocalComm with one shard, 3 steps, bit for
    # bit (the process-group path of halo, edge_swap and max on CUDA).
    t_phase = time.perf_counter()
    facade_mesh = {}
    for nz_, solver_type, mname, mesh_ in (
            (1, None, "4y", mesh_y4), (24, None, "4z", meshes55["4z"]),
            (24, "rk4", "2x2", meshes55["2x2"]),
            (24, "projection_spectral", "4z", meshes55["4z"])):
        nx_, ny_ = (128, 64) if nz_ == 1 else (64, 48)
        zmax = 1.0 if nz_ > 1 else 0.0
        label = (f"phase 57 Simulation.create({nx_}, {ny_}, {nz_}, "
                 f"{solver_type or 'explicit_euler'}) over {mname}")
        sims = {kind: Simulation.create(
            nx_, ny_, nz_, zmax=zmax, solver_type=solver_type,
            **({"mesh": mesh_} if kind == "mesh" else {"device": dev}))
            for kind in ("mesh", "single")}
        statuses = []
        t0 = time.perf_counter()
        for _ in range(10):
            statuses.append(int(sims["mesh"].step()))
        sims["mesh"].solve()
        sync()
        wall = (time.perf_counter() - t0) * 1e3 / 11
        for _ in range(10):
            sims["single"].step()
        sims["single"].solve()
        sync()
        g = sims["mesh"].field.gather()
        bar = 1e-5 if solver_type == "projection_spectral" else \
            TOL_SHARDED_EXPLICIT
        facade_mesh[label[len("phase 57 "):]] = held(
            f"{label} 11 steps", g, sims["single"].field,
            bar * max(1.0, float(sims["single"].field.p.abs().max())))
        print(f"{label}: statuses {statuses}, solve status "
              f"{int(sims['mesh'].last_stats.status)}, {wall:.3f} ms a "
              f"facade step (host wall, with its sync)", flush=True)
        if any(statuses) or int(sims["mesh"].last_stats.status) != 0:
            fail(f"{label}: a facade step failed")
        if sims["mesh"].current_time != sims["single"].current_time:
            fail(f"{label}: current_time differs")
        swap = "rk2" if solver_type != "rk2" else "explicit_euler"
        sims["mesh"].set_solver_by_name(swap)
        if sims["mesh"].solver.mesh is not mesh_ or not isinstance(
                sims["mesh"].field, ShardedField):
            fail(f"{label}: set_solver lost the mesh")
        del sims, g
    torch.cuda.empty_cache()
    g57 = Grid.uniform(128, 64, 16, zmin=0.0, zmax=1.0)
    f57 = noisy(FlowField.initialize(g57, dtype=torch.float32, device=dev),
                SEED + 57)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                world_size=1, rank=0)
        try:
            comm1 = ProcessGroupComm(device=dev)
            outs57 = {}
            for kind, mesh1 in (
                    ("nccl", make_mesh([dev], axes=("z",), comm=comm1)),
                    ("local", make_mesh([dev], axes=("z",)))):
                step1, place1 = make_sharded_step(g57, NSParams(), mesh1,
                                                  "explicit_euler")
                fo, ro = run_steps(step1, place1(f57), 1e-3, 3)
                outs57[kind] = (gather_field(fo), ro)
            sync()
        finally:
            dist.destroy_process_group()
    nccl_euler_diff = max(float((getattr(outs57["nccl"][0], k)
                                 - getattr(outs57["local"][0], k)).abs()
                                .max()) for k in names6)
    print(f"phase 57 one-rank NCCL group vs LocalComm(P=1) 128x64x16, "
          f"explicit_euler step, 3 steps: max|diff| {nccl_euler_diff!r}, "
          f"status {int(outs57['nccl'][1].status)}", flush=True)
    if nccl_euler_diff != 0.0 or int(outs57["nccl"][1].status) != 0:
        fail("phase 57: the process-group Euler step differs from "
             "LocalComm's")
    del f57, outs57
    launch_counts.update(explicit_shard_counts)
    print(f"phase 57 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ==== the (z, y) BiCGSTAB step and the y-decomposed 2D step ===========
    # ---- phase 58: the B1r and P2r kernel modes against their plain twins
    # B1r: the BiCGSTAB passes' (z, y) modes (bicg_*_kernel<true, true>) on
    # blocks padded one plane and one row a side, at 37x23x16 on every
    # block of 4 planes x 8 rows of a (4, 3) cover (23 rows: the last y
    # block overlaps its neighbour) and on the four (2, 2) blocks of 512^3
    # (258 x 258 x 512 padded); P2r: the 2D kernels' global-row modes
    # (<false, true>) on the rows of every one of 4 y-shards at 37x24 and
    # 2048^2 (the predictor's rows padded 2 a side, the corrector's p 1).
    # Fields bit for bit, the dots' shares at TOL_DOT.  One block of each
    # mode at the large size is timed by its device time; its bound counts
    # a stencil field's owned points plus the halo rows and planes it
    # reads, every other input and output at owned size.  Then the 2D
    # step's GEMMs at a 2048^2 4y shard's shapes: the x DST on its
    # (512, 2048) rows, the slab y-solve product on its (2048, 512) x-mode
    # slab (SGEMM and 3xTF32 at 2e-5·max, torch.matmul beside).
    t_phase = time.perf_counter()
    for shape in ((16, 23, 37), (N_BIG,) * 3):
        nz_g, ny_g, nx_ = shape
        big = nz_g == N_BIG
        nzl, nyl = (nz_g // ZY[0], ny_g // ZY[1]) if big else (4, 8)
        shards_ = ([(zi * nzl, yi * nyl) for zi in range(ZY[0])
                    for yi in range(ZY[1])] if big else
                   [(z0, y0) for z0 in range(0, nz_g, nzl)
                    for y0 in (0, 8, ny_g - nyl)])
        tag = "x".join(map(str, shape[::-1]))
        print(f"phase 58 B1r vs plain at {tag}, blocks of {nzl} planes x "
              f"{nyl} rows at {shards_}", flush=True)
        grid, prob = cg_problem(shape)
        b_own = bk.BiCGConsts(nzl, nyl, nx_, prob.inv_dx2, prob.inv_dy2,
                              prob.inv_dz2)
        b_pad = dataclasses.replace(b_own, nz=nzl + 2, ny=nyl + 2)
        gen = torch.Generator(device=dev).manual_seed(SEED + 58)
        r, p, v, x = (torch.randn(shape, generator=gen, device=dev)
                      for _ in range(4))
        beta = torch.full((), 0.37, device=dev)
        alpha = torch.full((), 0.61, device=dev)
        omega = torch.full((), 0.23, device=dev)
        one = torch.ones((), device=dev)
        for b_i, (z0, y0) in enumerate(shards_):
            timed = big and b_i == 1
            stag = f"{tag} block ({z0}, {y0})"
            rb, pb, vb, xb = (zy_blocks(a, 1, [(z0, y0)], nzl, nyl)[0]
                              for a in (r, p, v, x))
            base = (z0 - 1, nz_g, y0 - 1, ny_g)
            cells, pad_cells = nzl * nyl * nx_, rb.numel()
            # timed as the solve launches them: in place, a running state
            st_b = bk.new_state(one, one, 0 * one, 0 * one, one > 0)
            st_b[bk.BETA], st_b[bk.OMEGA] = beta, omega
            st_b[bk.ALPHA_NEW], st_b[bk.ALPHA_EFF] = alpha, alpha
            st_b[bk.OMEGA_EFF] = omega
            b_ops = bk.ShardBiCGSTABPasses(b_own, z0, nz_g, dev, y_off=y0,
                                           ny_g=ny_g)
            t1, t2 = torch.zeros_like(rb), torch.zeros_like(rb)
            # pv reads r, p, v around the owned points, r^ at them (x's
            # block stands for r^: any field will do)
            pn, vn, _ = check(
                "sharded-zy-bicgstab", stag, timed, bk.pass_pv, B1_ZY,
                SRC_BICG,
                lambda: bk.pass_pv(rb, pb, vb, xb, beta, omega, b_pad,
                                   *base),
                lambda: bk.pass_pv_plain(rb, pb, vb, xb, beta, omega, b_pad,
                                         *base),
                ("p'", "v'", "<rhat,v'>"), (bit, bit, dot),
                work=(4 * (3 * pad_cells + cells),
                      FLOPS_PER_POINT["bicg_pv"] * cells),
                time_fn=lambda: b_ops.pv(rb, pb, vb, xb, t1, t2, st_b),
                name="pass_pv[global_ny]", device_time=True)
            s_, t_, *_ = check(
                "sharded-zy-bicgstab", stag, timed, bk.pass_st, B1_ZY,
                SRC_BICG,
                lambda: bk.pass_st(rb, vb, alpha, b_pad, *base),
                lambda: bk.pass_st_plain(rb, vb, alpha, b_pad, *base),
                ("s", "t", "<s,s>", "<t,s>", "<t,t>"),
                (bit, bit, dot, dot, dot),
                work=(4 * 2 * pad_cells, FLOPS_PER_POINT["bicg_st"] * cells),
                time_fn=lambda: b_ops.st(rb, vb, t1, t2, st_b),
                name="pass_st[global_ny]", device_time=True)
            pnb, sb, tb = (torch.zeros_like(rb) for _ in range(3))
            pnb[1:-1, 1:-1], sb[1:-1, 1:-1], tb[1:-1, 1:-1] = pn, s_, t_
            xt, rt = xb.clone(), rb.clone()
            # xr: every owned point but the global shells (an inner
            # block's first and last owned rows too)
            check("sharded-zy-bicgstab", stag, timed, bk.pass_xr, B1_XR_ZY,
                  SRC_BICG,
                  lambda: bk.pass_xr(xb, pnb, sb, tb, rb, alpha, omega,
                                     b_pad, *base),
                  lambda: bk.pass_xr_plain(xb, pnb, sb, tb, rb, alpha,
                                           omega, b_pad, *base),
                  ("x'", "r'", "<r,r>", "<rhat,r>"), (bit, bit, dot, dot),
                  work=(4 * 5 * cells, FLOPS_PER_POINT["bicg_xr"] * cells),
                  time_fn=lambda: b_ops.xr(xt, rt, pnb, sb, tb, rb, st_b),
                  name="pass_xr[global_ny]", device_time=True)
            del rb, pb, vb, xb, pn, vn, s_, t_, pnb, sb, tb, xt, rt, t1, t2
        del r, p, v, x
        torch.cuda.empty_cache()
    rows_pad = torch.nn.functional.pad
    for ny2, nx2 in ((24, 37), (N_2D, N_2D)):
        big = ny2 == N_2D
        nyl = ny2 // 4
        tag = f"{nx2}x{ny2}"
        print(f"phase 58 P2r vs plain at {tag}, 4 y blocks of {nyl} rows",
              flush=True)
        grid2 = Grid.uniform(nx2, ny2)
        c2 = pkm.stencil_consts(1, ny2, nx2, grid2.dx0, grid2.dy0, 0.0,
                                grid2.xmin, grid2.ymin, NSParams().mu, True,
                                None, torch.float32)
        c_pred = dataclasses.replace(c2, ny=nyl + 4)
        c_p = dataclasses.replace(c2, ny=nyl + 2)
        gen = torch.Generator(device=dev).manual_seed(SEED + 581)
        u, v, w, p = (0.1 * torch.randn((1, ny2, nx2), generator=gen,
                                        device=dev) for _ in range(4))
        dt = torch.full((), 1e-3, device=dev)
        scal = torch.stack([dt, torch.full((), 0.1, device=dev),
                            torch.full((), 0.05, device=dev)])
        rod, s = 1.0 / dt, dt / 1.0

        def rows_of(a, y0, h):
            """Rows y0 .. y0 + nyl of ``a`` with h rows a side (zeros
            past the global ends)."""
            ap = rows_pad(a, (0, 0, h, h)) if h else a
            return ap[:, y0:y0 + nyl + 2 * h].contiguous()

        for yi in range(4):
            y0 = yi * nyl
            timed = big and yi == 1
            stag = f"{tag} rows {y0}..{y0 + nyl}"
            u2, v2, w2 = (rows_of(a, y0, 2) for a in (u, v, w))
            po, p1 = rows_of(p, y0, 0), rows_of(p, y0, 1)
            row = 4 * nx2       # the bytes of one float32 row
            us, vs, ws = check(
                "sharded-2d", stag, timed, pk2m.predictor_star_2d, P2,
                SRC_2D,
                lambda: pk2m.predictor_star_2d(u2, v2, w2, scal, c_pred,
                                               y_base=y0 - 2, ny_g=ny2),
                lambda: pkm.predictor_star_plain(u2, v2, w2, scal, c_pred,
                                                 y_base=y0 - 2, ny_g=ny2),
                ("u*", "v*", "w*"), (bit,) * 3,
                work=(3 * row * (nyl + 4),
                      FLOPS_PER_POINT["predictor_star"] * nx2 * (nyl + 4)),
                name="predictor_star_2d[global_ny]", device_time=True)
            check("sharded-2d", stag, timed, pk2m.poisson_input_2d, P2,
                  SRC_2D,
                  lambda: pk2m.poisson_input_2d(us, vs, po, rod, c_pred,
                                                y0 - 2, ny2, 2),
                  lambda: pk2m.poisson_input_2d_plain(us, vs, po, rod,
                                                      c_pred, y0 - 2, ny2,
                                                      2),
                  ("b~",), (bit,),
                  work=(row * (3 * nyl + 2),
                        FLOPS_PER_POINT["poisson_input"] * nx2 * nyl),
                  name="poisson_input_2d[global_ny]", device_time=True)
            check("sharded-2d", stag, timed, pk2m.corrector_2d_rows, C2,
                  SRC_2D,
                  lambda: pk2m.corrector_2d_rows(us, vs, p1, s, c_p, y0 - 1,
                                                 ny2),
                  lambda: pk2m.corrector_2d_rows_plain(us, vs, p1, s, c_p,
                                                       y0 - 1, ny2),
                  ("u", "v", "p"), (bit,) * 3,
                  work=(row * (3 * nyl + 2),
                        FLOPS_PER_POINT["corrector"] * nx2 * nyl),
                  name="corrector_2d_rows[global_ny]", device_time=True)
            del u2, v2, w2, po, p1, us, vs, ws
        if big:
            # the GEMMs of a 4y shard: the x DST on its (512, 2048) rows,
            # the slab y solve's (2046 x 2048) product on its x-mode slab
            gen = torch.Generator(device=dev).manual_seed(SEED + 582)
            bt = torch.randn((1, nyl, nx2), generator=gen, device=dev)
            fxt = torch.randn((nx2, nx2), generator=gen, device=dev)
            fy = torch.randn((ny2 - 2, ny2), generator=gen, device=dev)
            slab = torch.randn((ny2, nx2 // 4), generator=gen, device=dev)
            x_ops = gemm_flops(nyl, nx2, nx2)
            y_ops = gemm_flops(ny2 - 2, nx2 // 4, ny2)
            tf32_plan(f"{tag} 4y shard x-DST", nyl, nx2, nx2)
            tf32_plan(f"{tag} 4y shard y slab", ny2 - 2, nx2 // 4, ny2)
            for prec, suffix, src_, rate, mult, lib in GEMM_PRECISIONS:
                path = "sharded-2d" + GEMM_PATH[prec]
                check(path, f"{tag} 4y shard", True, rolling.right_dot,
                      DOT2, src_,
                      lambda: rolling.right_dot(bt, fxt, prec),
                      lambda: rolling.right_dot_plain(bt, fxt, prec),
                      ("x-DST",), (gemm,),
                      work=((bt, fxt), mult * x_ops),
                      library=lib(lambda: bt @ fxt),
                      name=f"right_dot{suffix}", rate=rate,
                      device_time=prec == "default",
                      repeat=prec == "default")
                check(path, f"{tag} 4y shard", True, rolling.left_dot,
                      YS_2D, src_,
                      lambda: rolling.left_dot(fy, slab, precision=prec),
                      lambda: rolling.left_dot_plain(fy, slab,
                                                     precision=prec),
                      ("y slab",), (gemm,),
                      work=((fy, slab), mult * y_ops),
                      library=lib(lambda: fy @ slab),
                      name=f"left_dot{suffix}", rate=rate,
                      device_time=prec == "default",
                      repeat=prec == "default")
            del bt, fxt, fy, slab
        del u, v, w, p
        torch.cuda.empty_cache()
    print(f"phase 58 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 59: the 2048^2 2D step over 4 y-shards -------------------
    # bench.py:run_2d(2048)'s configuration (phase 6's) through
    # make_sharded_step on a y mesh of [cuda:0] * 4, at HIGHEST and HIGH,
    # against the single-device kernel step from the same field.  The
    # sharded y solve is a dense eigen contraction where the single-device
    # step runs Thomas + the low-mode rescue, so the two float32 steps
    # differ by rounding: at HIGHEST the first step is held against the
    # float64 step on the card (the plain chain) at TOL_2D_F64_*, the
    # single-device step's own distance from it and the two float32
    # steps' difference printed; HIGH is held against the single-device
    # HIGH step at phase 28's 2D HIGH bars.  Then 3 warm-up and
    # TIMED_STEPS_2D timed steps of each (CUDA events; the configuration
    # meets the clamps near step 24, so the timed fields are not held
    # against each other), the counters set to 0 just before the timed
    # sharded steps and read just after, every plain twin a tripwire.
    t_phase = time.perf_counter()
    grid_2 = Grid.uniform(N_2D, N_2D)
    params_2 = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                        mu=0.01)
    shape_2, dt_2 = (1, N_2D, N_2D), 1e-5
    PLAIN_2D = ([(pkm, "predictor_star_plain")]
                + [(pk2m, nm) for nm in ("predictor_star_plain",
                                         "poisson_input_2d_plain",
                                         "corrector_2d_rows_plain")]
                + [(rolling, nm) for nm in ("right_dot_plain",
                                            "left_dot_plain",
                                            "matmul_plain")])
    f0 = tg_field(shape_2)
    s64 = make_projection_step(grid_2, params_2, torch.float64,
                               Method.FFT_DIRECT, device=dev)(
        FlowField(*(getattr(f0, nm).double() for nm in names6)), dt_2,
        0)[0]
    truth2 = {nm: getattr(s64, nm) for nm in "uvwp"}
    del s64, f0

    def off_truth2(fld):
        return {nm: float((getattr(fld, nm).double() - truth2[nm]).abs()
                          .max()) for nm in "uvwp"}

    rec_2d = {}
    for prec in (None, "high"):
        label = (f"phase 59 2D {N_2D}^2 over 4y "
                 f"{'HIGH' if prec else 'HIGHEST'}")
        step_s, place = make_sharded_step(
            grid_2, params_2, mesh_y4, "projection",
            spectral_precision=prec)
        single = make_projection_step(grid_2, params_2, torch.float32,
                                      Method.FFT_DIRECT, device=dev,
                                      spectral_precision=prec)
        f0 = tg_field(shape_2)
        fs0 = place(f0)
        g1 = gather_field(step_s(fs0, dt_2, 0)[0])
        s1 = single(f0, dt_2, 0)[0]
        sync()
        tag = f"{label} first step"
        e_y, e_1 = off_truth2(g1), off_truth2(s1)
        diffs = {nm: float((getattr(g1, nm) - getattr(s1, nm)).abs().max())
                 for nm in "uvwp"}
        print(f"{tag}: max|4y - float64| {e_y}, max|single-device - "
              f"float64| {e_1}, max|4y - single-device| {diffs}, max|p| "
              f"{float(truth2['p'].abs().max())!r}", flush=True)
        if prec is None:
            pscale = float(truth2["p"].abs().max())
            for nm in "uvwp":
                bar = (TOL_2D_F64_P * pscale if nm == "p"
                       else TOL_2D_F64_UVW)
                if not e_y[nm] <= bar:
                    fail(f"{tag} {nm}: {e_y[nm]:.3e} off the float64 "
                         f"step, above {bar:.3e}")
        else:
            def held_1(name_, bar, passed=0.0):
                ref = getattr(s1, name_)
                scale = max(1.0, float(ref.abs().max()))
                return compare(tag + " vs single-device", name_,
                               getattr(g1, name_), ref,
                               bar * scale + passed, False)[0]

            dp = held_1("p", HIGH_P)
            held_1("u", HIGH_U_2D, dt_2 / grid_2.dx0 * dp)
            held_1("v", HIGH_U_2D, dt_2 / grid_2.dy0 * dp)
            held_1("w", HIGH_U_2D)
        del g1, s1
        run_steps(step_s, fs0, dt_2, 3)
        sync()
        pk2m.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with no_plain(label, PLAIN_2D):
            start.record()
            fs, res_s = run_steps(step_s, fs0, dt_2, TIMED_STEPS_2D)
            end.record()
            sync()
        ms_s = start.elapsed_time(end) / TIMED_STEPS_2D
        counts = {f"{w_.__name__}[global_ny]": w_.global_ny_launches
                  for w_ in (pk2m.predictor_star_2d, pk2m.poisson_input_2d,
                             pk2m.corrector_2d_rows)}
        key = "high_launches" if prec else "launches"
        sfx = "[3xtf32]" if prec else ""
        counts[f"right_dot{sfx}"] = getattr(rolling.right_dot, key)
        counts[f"left_dot{sfx}"] = getattr(rolling.left_dot, key)
        print(f"{label}: launch counts over the main path {counts}",
              flush=True)
        if min(counts.values()) <= 0:
            fail(f"{label}: a kernel of the 2D sharded step not launched")
        if prec and (rolling.right_dot.launches
                     or rolling.left_dot.launches):
            fail(f"{label}: an SGEMM launched on the HIGH path")
        no_element_loads(label, prec or "highest")
        launch_counts["sharded-2d-high" if prec else "sharded-2d"] = counts
        run_steps(single, f0, dt_2, 3)
        sync()
        start.record()
        f1, res_1 = run_steps(single, f0, dt_2, TIMED_STEPS_2D)
        end.record()
        sync()
        ms_1 = start.elapsed_time(end) / TIMED_STEPS_2D
        g = gather_field(fs)
        cells_2 = N_2D * N_2D
        print(f"{label}: {ms_s:.3f} ms/step, "
              f"{cells_2 / (ms_s * 1e-3) / 1e6:.1f} MLUPS; single-device "
              f"kernel step {ms_1:.3f} ms/step; status {int(res_s.status)}, "
              f"max|u| {float(res_s.max_velocity)!r} (single "
              f"{float(res_1.max_velocity)!r}) after {TIMED_STEPS_2D} "
              f"steps", flush=True)
        if int(res_s.status) != 0 or not bool(g.is_finite()):
            fail(f"{label}: nonzero status or non-finite fields")
        if do_profile and prec is None:
            profile_steps(torch, f"phase 5 {label}",
                          lambda: run_steps(step_s, fs0, dt_2,
                                            PROFILED_STEPS),
                          PROFILED_STEPS)
        rec_2d["high" if prec else "highest"] = {
            "ms": ms_s, "mlups": cells_2 / (ms_s * 1e-3) / 1e6,
            "single_ms": ms_1, "first_step_max_abs_diff": diffs,
            "first_step_off_float64": e_y,
            "single_first_step_off_float64": e_1}
        del f0, fs0, fs, g, f1
        torch.cuda.empty_cache()
    del truth2
    print(f"phase 59 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 60: the 128^3 BiCGSTAB step over (2, 2) and (1, 4) -------
    # phase 25's / 49's configuration (128^3, its tolerance) through
    # krylov_step_pair on the (z, y) meshes, against the single-device
    # kernel step: status, iterations a step, fields at phase 49's bars
    t_phase = time.perf_counter()
    bicg_zy = {}
    for mshape in (ZY, (1, 4)):
        mesh_b = mesh22 if mshape == ZY else make_mesh([dev] * 4,
                                                       shape=mshape)
        bicg_zy[f"{mshape[0]}x{mshape[1]}"] = krylov_step_pair(
            f"phase 60 BiCGSTAB step {N_BICG_STEP}^3 over {mshape} "
            f"(tolerance {bicg_step_tol:g})", (N_BICG_STEP,) * 3,
            Method.BICGSTAB, PoissonParams(tolerance=bicg_step_tol),
            (pkm.predictor_star, pkm.poisson_rhs, pkm.corrector_rows)
            + tuple(bk.WRAPPERS), "sharded-zy-bicgstab",
            PLAIN_BICG + [(pkm, nm) for nm in ("predictor_star_plain",
                                               "poisson_rhs_plain",
                                               "corrector_rows_plain")],
            mesh=mesh_b, mode="global_ny")
        torch.cuda.empty_cache()
    print(f"phase 60 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 61: the facade on a 2D y mesh ------------------------------
    # Simulation.create(256, 128, "projection_spectral", mesh=4y) against
    # the single-device facade from the same Taylor-Green start, one
    # step() each: the fields at phase 57's spectral bar, the stats'
    # maxima beside
    t_phase = time.perf_counter()
    label = ("phase 61 Simulation.create(256, 128, projection_spectral) "
             "over 4y")
    sims = {kind: Simulation.create(
        256, 128, solver_type="projection_spectral",
        **({"mesh": mesh_y4} if kind == "mesh" else {"device": dev}))
        for kind in ("mesh", "single")}
    f61 = tg_field((1, 128, 256))
    sims["mesh"].field = sims["mesh"].solver.place(f61)
    sims["single"].field = f61
    st61 = [int(sims[k].step()) for k in ("mesh", "single")]
    sync()
    g = sims["mesh"].field.gather()
    facade_2d = held(f"{label} 1 step", g, sims["single"].field,
                     1e-5 * max(1.0, float(sims["single"].field.p.abs()
                                          .max())))
    s_m, s_1 = sims["mesh"].get_stats(), sims["single"].get_stats()
    print(f"{label}: statuses {st61}, max|u| {s_m.max_velocity!r} (single "
          f"{s_1.max_velocity!r}), max p {s_m.max_pressure!r} (single "
          f"{s_1.max_pressure!r})", flush=True)
    if any(st61) or not isinstance(sims["mesh"].field, ShardedField):
        fail(f"{label}: a facade step failed or the field left the mesh")
    if abs(s_m.max_velocity - s_1.max_velocity) > 1e-5 * max(
            1.0, s_1.max_velocity):
        fail(f"{label}: the stats' max|u| differ")
    del sims, g, f61
    torch.cuda.empty_cache()
    print(f"phase 61 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ==== the decomposed multigrid (cfd_tpu_torch.parallel.fused_mg) ======
    # ---- phase 62: the sweep's sharded modes against their plain twins ----
    # rb_sweep(..., z_off, gnz[, y_off, gny]) (mg_color_kernel /
    # mg_residual_kernel <true, false> and <true, true>) on every block of
    # the 513^3 field over 4 z-shards (138 x 513 x 513: 130 owned planes of
    # the field padded to 520, 4 halo planes a side) and over (2, 2) (266 x
    # 266 x 513), red-first with the residual, black-first and red-first:
    # x and r bit for bit against the plain twin on the same block, and
    # the owned planes and rows (the residual one plane and row past them
    # too) bit for bit against phase 17's single-device sweep of the whole
    # field.  One inner block of each mode is timed by its device time;
    # the bound counts the owned points' x, b and x_new (the record keeps
    # the last variant, red-first without the residual) and the halo
    # planes and rows of x and b it reads.
    t_phase = time.perf_counter()
    from cfd_tpu_torch.parallel import make_multigrid_sharded
    from cfd_tpu_torch.parallel.fused_mg import HALO
    MG_SWEEP_NZ = "cfd_tpu/ops/pallas/mg_kernels.py:160"   # global planes
    MG_SWEEP_NY = "cfd_tpu/ops/pallas/mg_kernels.py:114"   # global rows
    n = N_MG
    lv = mg_levels((n, n, n))[0]
    _, prob = cg_problem((n, n, n))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = prob.zero_boundary(torch.randn((n, n, n), generator=gen,
                                       device=dev))
    b = torch.randn((n, n, n), generator=gen, device=dev)

    def mg_share(m, shards):
        return -(-m // (2 * shards)) * 2

    def mg_blocks(a, pz, py):
        """Each shard's (g0, g0y, block): owned planes (rows) of ``a``
        padded to even shares, HALO planes (and rows on a (z, y) mesh) a
        side, zeros past the global ends."""
        nzl = mg_share(n, pz)
        nyl, hy = (mg_share(n, py), HALO) if py > 1 else (n, 0)
        ap = a.new_zeros((nzl * pz + 2 * HALO, nyl * py + 2 * hy, n))
        ap[HALO:HALO + n, hy:hy + n] = a
        return [(zi * nzl, yi * nyl,
                 ap[zi * nzl:(zi + 1) * nzl + 2 * HALO,
                    yi * nyl:(yi + 1) * nyl + 2 * hy].clone())
                for zi in range(pz) for yi in range(py)], nzl, nyl, hy

    mg_variants = (("red", True), ("black", False), ("red", False))
    for first, emit in mg_variants:
        xs, rs = x.clone(), torch.empty_like(x) if emit else None
        mgk.rb_sweep(xs, b, lv, first, rs)
        vtag = f"{first}-first{' +r' if emit else ''}"
        for (pz, py), mode_name, path, replaces in (
                ((SHARDS, 1), "global_nz", "sharded-mg", MG_SWEEP_NZ),
                (ZY, "global_ny", "sharded-mg-zy", MG_SWEEP_NY)):
            xbl, nzl, nyl, hy = mg_blocks(x, pz, py)
            bbl = mg_blocks(b, pz, py)[0]
            print(f"phase 62 rb_sweep[{mode_name}] {vtag} vs plain on the "
                  f"{len(xbl)} blocks of {n}^3 over ({pz}, {py}), blocks "
                  f"{tuple(xbl[0][2].shape)}", flush=True)
            for b_i, ((g0, g0y, xb), (_, _, bb)) in enumerate(zip(xbl,
                                                                  bbl)):
                mode = dict(z_off=g0 - HALO, gnz=n)
                if py > 1:
                    mode.update(y_off=g0y - hy, gny=n)

                def run(sweep, xb=xb, bb=bb, mode=mode):
                    xo = xb.clone()
                    ro = torch.empty_like(xb) if emit else None
                    sweep(xo, bb, lv, first, ro, **mode)
                    return (xo, ro) if emit else xo

                owned = nzl * nyl * n
                halo = xb.numel() - owned
                # the owned points inside the global interior
                in_z = max(0, min(g0 + nzl, n - 1) - max(g0, 1))
                in_y = (max(0, min(g0y + nyl, n - 1) - max(g0y, 1))
                        if py > 1 else n - 2)
                timed = b_i == 1 and not emit and first == "red"
                xt = xb.clone()
                got = check(
                    path, f"{n}^3 ({pz}, {py}) block ({g0}, {g0y}) {vtag}",
                    timed, mgk.rb_sweep, replaces, SRC_MG,
                    lambda run=run: run(mgk.rb_sweep),
                    lambda run=run: run(mgk.rb_sweep_inplace_plain),
                    ("x", "r") if emit else ("x",), (bit, bit)[:1 + emit],
                    work=(4 * (2 * owned + 2 * halo),
                          FLOPS_PER_POINT["rb_sweep"] * in_z * in_y
                          * (n - 2), 4 * owned),
                    time_fn=lambda xt=xt, bb=bb, mode=mode: mgk.rb_sweep(
                        xt, bb, lv, first, None, **mode),
                    name=f"rb_sweep[{mode_name}]", device_time=True)
                got = got if isinstance(got, tuple) else (got,)
                z1, z2 = g0, min(g0 + nzl, n)
                y1, y2 = (g0y, min(g0y + nyl, n)) if py > 1 else (0, n)
                if z1 >= z2:
                    continue
                windows = [(got[0], xs, z1, z2, y1, y2)]
                if emit:
                    windows.append((got[1], rs, max(z1 - 1, 0),
                                    min(z2 + 1, n),
                                    max(y1 - 1, 0) if py > 1 else 0,
                                    min(y2 + 1, n) if py > 1 else n))
                for blk, whole, a1, a2, c1, c2 in windows:
                    own_ = blk[a1 - g0 + HALO:a2 - g0 + HALO,
                               c1 - g0y + hy:c2 - g0y + hy]
                    ref_ = whole[a1:a2, c1:c2]
                    if not torch.equal(own_, ref_):
                        fail(f"phase 62 rb_sweep[{mode_name}] {vtag} block "
                             f"({g0}, {g0y}): the owned planes differ from "
                             f"the single-device sweep, max "
                             f"{float((own_ - ref_).abs().max()):.3e}")
                del got, windows, xt
            print(f"  the owned planes and rows of every block equal the "
                  f"single-device sweep bit for bit", flush=True)
            del xbl, bbl
        del xs, rs
        torch.cuda.empty_cache()
    del x, b
    torch.cuda.empty_cache()
    print(f"phase 62 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 63: bench.py's multigrid_513 over 4z and (2, 2) ------------
    # phase 18's problem (513^3, tol 1e-6, check_interval 10) through
    # make_multigrid_sharded, against the single-device kernel solve in
    # this run: status 0, the same V-cycle count, x bit for bit (the
    # owner-computed restriction), the float64 true residual below 1e-3.
    # The coarse levels (level 1 down, the single-device V-cycle) run on
    # every shard, so 4 times on the one card: one coarse V-cycle is timed
    # alone, by its device time and by its CUDA-event span (host-bound:
    # its small levels' launches), and its device time on 4 shards is
    # given as a share of a sharded V-cycle's span.
    t_phase = time.perf_counter()
    levels = mg_levels((n, n, n))
    pp = PoissonParams(tolerance=1e-6, max_iterations=2000,
                       check_interval=10)
    gen = torch.Generator(device=dev).manual_seed(7)
    rhs = prob.zero_boundary(torch.randn((n, n, n), generator=gen,
                                         device=dev))
    x0 = torch.zeros_like(rhs)
    solve = mgs.make_multigrid(prob, pp, device=dev)
    solve(x0, rhs)                              # warm-up, as the sharded
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    one = solve(x0, rhs)
    end.record()
    sync()
    ms_one = start.elapsed_time(end)
    n_one = int(one.iterations)
    r_c = torch.randn(levels[1].shape, generator=gen, device=dev)
    coarse_ms = device_ms(lambda: mgk.v_cycle(levels, 1, r_c, 2, 2, False))
    coarse_span = cuda_ms(lambda: mgk.v_cycle(levels, 1, r_c, 2, 2, False))
    print(f"phase 63 single-device multigrid_513: {n_one} V-cycles, "
          f"{ms_one:.1f} ms a solve; one coarse V-cycle (level 1 down): "
          f"{coarse_ms:.3f} ms of device time, {coarse_span:.3f} ms of "
          f"CUDA-event span", flush=True)
    del r_c
    mg513_sharded = {}
    for mshape, mesh_m, mode_name in (((SHARDS, 1), mesh4, "global_nz"),
                                      (ZY, mesh22, "global_ny")):
        label = f"phase 63 multigrid_513 over {mshape}"
        solve = make_multigrid_sharded(prob, pp, mesh_m)
        solve(x0, rhs)                          # warm-up, same pattern
        sync()
        native.reset_counts(mgk.rb_sweep)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with no_plain(label, [(mgk, "rb_sweep_inplace_plain")]):
            start.record()
            res = solve(x0, rhs)
            end.record()
            sync()
        ms_s = start.elapsed_time(end)
        n_it, syncs = int(res.iterations), solve.host_syncs
        counts = {"rb_sweep": mgk.rb_sweep.launches,
                  f"rb_sweep[{mode_name}]": getattr(
                      mgk.rb_sweep, f"{mode_name}_launches")}
        xd, rd = prob.zero_boundary(res.x.double()), rhs.double()
        true_rel = float(prob.interior(prob.laplacian(xd) - rd).norm()
                         / prob.interior(rd).norm())
        del xd, rd
        diff = float((res.x - one.x).abs().max())
        shards_ = math.prod(mshape)
        per_cycle = ms_s / max(n_it, 1)
        print(f"{label}: {n_it} V-cycles (single-device {n_one}), status "
              f"{int(res.status)}, {ms_s:.1f} ms a solve (single-device "
              f"{ms_one:.1f}), {per_cycle:.3f} ms a V-cycle (single-device "
              f"{ms_one / max(n_one, 1):.3f}); the coarse levels' device "
              f"time on {shards_} shards {shards_ * coarse_ms:.3f} ms, "
              f"{shards_ * coarse_ms / per_cycle:.3f} of it; {syncs} host "
              f"syncs, launches {counts}; max|x - single-device x| "
              f"{diff!r}, true relative residual {true_rel:.4e}",
              flush=True)
        if int(res.status) != PoissonStatus.CONVERGED or n_it != n_one \
                or not true_rel < 1e-3:
            fail(f"{label}: not converged, another V-cycle count than the "
                 f"single-device solve, or true residual above 1e-3")
        if diff != 0.0:
            fail(f"{label}: x is not the single-device solve's bit for bit")
        if min(counts.values()) <= 0:
            fail(f"{label}: a sweep mode not launched: {counts}")
        mg513_sharded[f"{mshape[0]}x{mshape[1]}"] = {
            "iterations": n_it, "ms": ms_s, "single_ms": ms_one,
            "coarse_vcycle_device_ms": coarse_ms,
            "coarse_vcycle_span_ms": coarse_span,
            "coarse_device_share": shards_ * coarse_ms / per_cycle,
            "host_syncs": syncs, "launches": counts,
            "true_rel_residual": true_rel}
        del res, solve
        torch.cuda.empty_cache()
    del rhs, x0, one, levels
    torch.cuda.empty_cache()
    print(f"phase 63 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 64: the 257^3 MG projection step over 4z and (2, 2) --------
    # phase 20's configuration (run_3d's physics from the Taylor-Green
    # start, MG_STEP_TOL) through make_sharded_step(..., MULTIGRID) against
    # the single-device kernel step, as phases 48-49 (krylov_step_pair:
    # the sharded modes' counters set to 0 just before the timed steps,
    # the fields at phase 20's bars); then Simulation.create(...,
    # "projection_multigrid", mesh=) at 65^3 over 4z, 3 steps against the
    # single-device facade (its solver at MG_STEP_TOL, as phase 21 sets
    # the facade's).
    t_phase = time.perf_counter()
    mg_step_sharded = {}
    for mshape, mesh_m, mode_name, path in (
            ((SHARDS, 1), mesh4, "global_nz", "sharded-mg"),
            (ZY, mesh22, "global_ny", "sharded-mg-zy")):
        mg_step_sharded[f"{mshape[0]}x{mshape[1]}"] = krylov_step_pair(
            f"phase 64 MG step {N_MG_STEP}^3 over {mshape} (tolerance "
            f"{MG_STEP_TOL:g})", (N_MG_STEP,) * 3, Method.MULTIGRID,
            PoissonParams(tolerance=MG_STEP_TOL), (mgk.rb_sweep,), path,
            [(mgk, "rb_sweep_inplace_plain")], mesh=mesh_m, mode=mode_name)
        torch.cuda.empty_cache()
    label = f"phase 64 Simulation.create({MG_FACADE}^3, projection_multigrid)"
    sims = {kind: Simulation.create(
        MG_FACADE, MG_FACADE, MG_FACADE, zmax=1.0,
        solver_type="projection_multigrid",
        **({"mesh": mesh4} if kind == "mesh" else {"device": dev}))
        for kind in ("mesh", "single")}
    f64_ = tg_field((MG_FACADE,) * 3)
    for kind, sim in sims.items():
        solver = sim.registry.create("projection_multigrid")
        solver.poisson_params = PoissonParams(tolerance=MG_STEP_TOL)
        sim.set_solver(solver)
        sim.field = sim.solver.place(f64_)
    sync()
    t0 = time.perf_counter()
    st64 = [int(sims["mesh"].step()) for _ in range(3)]
    sync()
    ms_facade = (time.perf_counter() - t0) * 1e3 / 3
    st64 += [int(sims["single"].step()) for _ in range(3)]
    g = sims["mesh"].field.gather()
    print(f"{label} over {SHARDS}z: statuses {st64}, {ms_facade:.3f} ms a "
          f"step (host clock)", flush=True)
    if any(st64) or not isinstance(sims["mesh"].field, ShardedField):
        fail(f"{label}: a facade step failed or the field left the mesh")
    for name in "uvw":
        compare(f"{label} 3 steps vs single-device", name, getattr(g, name),
                getattr(sims["single"].field, name), TOL_CG_UVW, False)
    close_p(f"{label} 3 steps vs single-device", g.p,
            sims["single"].field.p)
    mg_step_sharded["facade_65_ms"] = ms_facade
    del sims, g, f64_
    torch.cuda.empty_cache()
    print(f"phase 64 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 65: the buoyant sharded predictor modes against their twins
    # A1sb, A1rb, P2rb: pred_star_kernel<false, false> with z_base / nz_g,
    # <false, true> and pred_star_2d_kernel<false, true>, each with its
    # buoyancy set, on phase 31's buoyant consts (g = (0, -9.81, 2.0): all
    # three components buoyant) and a seeded noisy T: every block of the
    # 512^3 field over 4z (132x512x512) and over (2, 2) (260x260x512), and
    # of the 2048^2 field over 4y (1x516x2048), the fields and T padded as
    # the steps pad them (2 planes and 2 rows a side, zeros past the
    # global ends).  Every block bit-equal to its plain twin, its owned
    # window bit-equal to the single-device buoyant predictor on the whole
    # field (phase 31's kernel); one middle block of each mode timed by
    # its device time, its bound 7 block fields (u, v, w, T read, u*, v*,
    # w* written, each with its halo).
    t_phase = time.perf_counter()
    buoy_modes = (
        ("4z", (N_BIG,) * 3, (SHARDS, 1), "sharded-buoy",
         "predictor_star[global_nz,buoyant]", A1_BUOY_SHARD, SRC),
        ("(2, 2)", (N_BIG,) * 3, ZY, "sharded-zy-buoy",
         "predictor_star[global_ny,buoyant]", A1_BUOY_ZY, SRC),
        ("4y", (1, N_2D, N_2D), (1, 4), "sharded-2d-buoy",
         "predictor_star_2d[global_ny,buoyant]", P2_BUOY_ROWS, SRC_2D))
    for mtag, shape, (pz_, py_), path, rname, replaces, source in buoy_modes:
        t_mode = time.perf_counter()
        nz_g, ny_g, nx_ = shape
        three_d = nz_g > 1
        nzl, nyl = nz_g // pz_, ny_g // py_
        hz, hy = (2 if three_d else 0), (2 if py_ > 1 else 0)
        grid = uniform_grid(shape)
        f = noisy(FlowField.initialize(grid, dtype=torch.float32,
                                       device=dev), SEED + 65)
        T = f.T + torch.randn(shape, generator=torch.Generator(
            device=dev).manual_seed(SEED + 66), device=dev)
        c = pkm.stencil_consts(nz_g, ny_g, nx_, grid.dx0, grid.dy0,
                               grid.dz0, grid.xmin, grid.ymin, NSParams().mu,
                               True, buoy_params)
        scal = torch.tensor([1e-3, 0.1, 0.05], device=dev)
        whole = (pkm.predictor_star(f.u, f.v, f.w, scal, c, T) if three_d
                 else pk2m.predictor_star_2d(f.u, f.v, f.w, scal, c, T))
        padded = [torch.nn.functional.pad(a, (0, 0, hy, hy, hz, hz))
                  for a in (f.u, f.v, f.w, T)]
        del f, T
        cb = dataclasses.replace(c, nz=nzl + 2 * hz, ny=nyl + 2 * hy)
        print(f"phase 65 buoyant predictor over {mtag} at "
              f"{'x'.join(map(str, shape[::-1]))}: blocks of "
              f"{nzl + 2 * hz}x{nyl + 2 * hy}x{nx_}", flush=True)
        for zi in range(pz_):
            for yi in range(py_):
                z0, y0 = zi * nzl, yi * nyl
                blk = [a[z0:z0 + nzl + 2 * hz, y0:y0 + nyl + 2 * hy]
                       .contiguous() for a in padded]
                if not three_d:
                    modes = dict(y_base=y0 - hy, ny_g=ny_g)
                    kern = pk2m.predictor_star_2d
                elif py_ > 1:
                    modes = dict(z_base=z0 - hz, nz_g=nz_g, y_base=y0 - hy,
                                 ny_g=ny_g)
                    kern = pkm.predictor_star
                else:
                    modes = dict(z_base=z0 - hz, nz_g=nz_g)
                    kern = pkm.predictor_star
                timed = (zi, yi) == (pz_ // 2, py_ // 2)
                stag = f"phase 65 {mtag} block ({z0}, {y0})"
                outs = check(
                    path, stag, timed, kern, replaces, source,
                    lambda: kern(*blk[:3], scal, cb, T=blk[3], **modes),
                    lambda: pkm.predictor_star_plain(*blk[:3], scal, cb,
                                                     T=blk[3], **modes),
                    ("u*", "v*", "w*"), (bit,) * 3,
                    work=((*blk, scal), FLOPS_PER_POINT[
                        "predictor_star_buoyant"] * blk[0].numel()),
                    name=rname, device_time=True)
                for o, want, nm in zip(outs, whole, ("u*", "v*", "w*")):
                    compare(f"{stag} owned window vs single-device", nm,
                            o[hz:hz + nzl, hy:hy + nyl],
                            want[z0:z0 + nzl, y0:y0 + nyl], *bit)
                del blk, outs
        del padded, whole
        torch.cuda.empty_cache()
        print(f"phase 65 over {mtag}: {time.perf_counter() - t_mode:.1f} s",
              flush=True)
    print(f"phase 65 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 66: the buoyant + energy steps on meshes --------------------
    # phase 33's 512^3 buoyant + energy step (T linear in z, Dirichlet back
    # and front, Neumann sides) through make_sharded_step over 4z and
    # (2, 2), FFT_DIRECT at HIGHEST: the first step against the
    # single-device kernel step (4z: u, v, w, p, T bit-equal; (2, 2): u,
    # v, w, p against the float64 step on the card at phase 52's bars, T
    # against the single-device step at the reference's (z, y) bar, atol
    # 1e-5 + rtol 1e-7, tests/parallel/test_fused_sharded.py:1032-1035),
    # then 3 warm-up and 5 timed steps (CUDA events) with the counters set
    # to 0 just before the timed sharded steps and every plain twin a
    # tripwire, the fields after them held at phase 43's (4z) and phase
    # 52's drift bars (T at the reference's); the energy post-step on the
    # shards alone; the "mixed" thermal faces (periodic back and front:
    # the z faces cross shards by edge_swap) at 128^3 over 4z and (2, 2),
    # 3 steps, held the same way; the 128^3 CG and BiCGSTAB steps with
    # energy and buoyancy over 4z at phase 48 / 49's bars.
    t_phase = time.perf_counter()
    from cfd_tpu_torch.parallel.thermal import make_sharded_thermal_post

    PLAIN_Z = [(pkm, nm) for nm in ("predictor_star_plain",
                                    "poisson_input_plain",
                                    "corrector_plain")] + [
        (rolling, "plane_dot_plain"), (tdma, "tdma_z_fwd_reference"),
        (tdma, "tdma_z_bwd_reference")]

    def thermal_mesh_run(label, grid_t, params_t, field_fn, shape, mesh_t,
                         exact, n_warm, n_timed, path):
        """The sharded FFT_DIRECT step against the single-device kernel
        step from ``field_fn(shape)``, as phase 66's header sets out;
        returns its record."""
        if not (params_t.energy_enabled and params_t.buoyancy_enabled):
            fail(f"{label}: the parameters lack energy or buoyancy")
        step_s, place = make_sharded_step(grid_t, params_t, mesh_t,
                                          "projection")
        single = make_projection_step(grid_t, params_t, torch.float32,
                                      Method.FFT_DIRECT, device=dev)
        f0 = field_fn(shape)
        fs0 = place(f0)
        g1 = gather_field(step_s(fs0, 1e-4, 0)[0])
        s1 = single(f0, 1e-4, 0)[0]
        sync()
        tag = f"{label} first step"
        diffs = {nm: float((getattr(g1, nm) - getattr(s1, nm)).abs().max())
                 for nm in "uvwpT"}
        print(f"{tag}: max|sharded - single-device| {diffs}", flush=True)
        rec = {"first_step_max_abs_diff": diffs}
        if exact:
            if any(diffs.values()):
                fail(f"{tag}: not bit-equal to the single-device step")
        else:
            s64 = make_projection_step(grid_t, params_t, torch.float64,
                                       Method.FFT_DIRECT, device=dev)(
                FlowField(*(getattr(f0, nm).double() for nm in names6)),
                1e-4, 0)[0]
            e_s = {nm: float((getattr(g1, nm).double() - getattr(s64, nm))
                             .abs().max()) for nm in "uvwp"}
            e_1 = {nm: float((getattr(s1, nm).double() - getattr(s64, nm))
                             .abs().max()) for nm in "uvwp"}
            pscale = float(s64.p.abs().max())
            print(f"{tag}: max|sharded - float64| {e_s}, max|single-device "
                  f"- float64| {e_1}", flush=True)
            for nm in "uvwp":
                bar_ = TOL_ZY_F64_P * pscale if nm == "p" else TOL_ZY_F64_UVW
                if not e_s[nm] <= bar_:
                    fail(f"{tag} {nm}: {e_s[nm]:.3e} off the float64 step, "
                         f"above {bar_:.3e}")
            t_bar(tag, g1.T, s1.T)
            rec.update(first_step_off_float64=e_s,
                       single_first_step_off_float64=e_1)
            del s64
        del g1, s1
        run_steps(step_s, fs0, 1e-4, n_warm)
        sync()
        pkm.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with no_plain(label, PLAIN_Z if exact else PLAIN_ZY):
            start.record()
            fs, res_s = run_steps(step_s, fs0, 1e-4, n_timed)
            end.record()
            sync()
        ms_s = start.elapsed_time(end) / n_timed
        mode = "global_nz" if exact else "global_ny"
        star_n = getattr(pkm.predictor_star, f"{mode}_launches")
        counts = {f"predictor_star[{mode},buoyant]": star_n}
        print(f"{label}: launch counts over the main path {counts}",
              flush=True)
        if star_n != len(mesh_t.comm.shards) * n_timed:
            fail(f"{label}: not the buoyant {mode} predictor once a shard "
                 f"a step")
        if path:
            launch_counts[path] = counts
        run_steps(single, f0, 1e-4, n_warm)
        sync()
        start.record()
        f1, res_1 = run_steps(single, f0, 1e-4, n_timed)
        end.record()
        sync()
        ms_1 = start.elapsed_time(end) / n_timed
        g = gather_field(fs)
        drift = {nm: float((getattr(g, nm) - getattr(f1, nm)).abs().max())
                 for nm in "uvwpT"}
        print(f"{label}: {ms_s:.3f} ms/step, single-device kernel step "
              f"{ms_1:.3f} ms/step; status {int(res_s.status)}, max T "
              f"{float(res_s.max_temperature)!r} (single "
              f"{float(res_1.max_temperature)!r}); max|sharded - single| "
              f"after {n_timed} steps {drift}", flush=True)
        if int(res_s.status) != 0 or not bool(g.is_finite()):
            fail(f"{label}: nonzero status or non-finite fields")
        if not torch.equal(res_s.max_temperature, torch.amax(g.T)):
            fail(f"{label}: max T is not the new T's")
        p1scale = float(f1.p.abs().max())
        for nm in "uvwp":
            if exact:
                bar_ = 2e-5 if nm == "p" else 2e-6
            else:
                bar_ = (TOL_ZY_DRIFT_P * p1scale if nm == "p"
                        else TOL_ZY_DRIFT_UVW)
            if not drift[nm] <= bar_:
                fail(f"{label} {nm}: {drift[nm]:.3e} from the single-device "
                     f"step after {n_timed} steps, above {bar_:.3e}")
        t_bar(f"{label} after {n_timed} steps", g.T, f1.T)
        rec.update(ms=ms_s, single_ms=ms_1, launches=counts,
                   **{f"max_abs_diff_after_{n_timed}": drift})
        if do_profile and path:
            profile_steps(torch, f"phase 5 {label}",
                          lambda: run_steps(step_s, fs0, 1e-4,
                                            PROFILED_STEPS), PROFILED_STEPS)
        if path:
            # the energy post-step on the shards alone, on this run's blocks
            post_s = make_sharded_thermal_post(grid_t, params_t,
                                               mesh_t.comm, torch.float32)
            blocks = list(fs.blocks)
            dts = [torch.full((), 1e-4, device=dev)] * len(blocks)
            rec["energy_post_ms"] = cuda_ms(lambda: post_s(blocks, dts))
            print(f"{label}: the energy post-step on the shards "
                  f"{rec['energy_post_ms']:.3f} ms, "
                  f"{rec['energy_post_ms'] / ms_s:.3f} of the step (phase "
                  f"33 on one device: {ms_post:.3f} ms, "
                  f"{ms_post / ms_b['kernel']:.3f})", flush=True)
            del blocks
        del f0, fs0, fs, g, f1
        torch.cuda.empty_cache()
        return rec

    buoy_sharded = {}
    n = N_BIG
    grid_b = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    for mname, mesh_t, exact, path in (("4z", mesh4, True, "sharded-buoy"),
                                       ("2x2", mesh22, False,
                                        "sharded-zy-buoy")):
        buoy_sharded[f"{n}_{mname}"] = thermal_mesh_run(
            f"phase 66 {n}^3 buoyant + energy over {mname}", grid_b,
            params_buoy, tg_field_t_z, (n, n, n), mesh_t, exact, 3,
            TIMED_STEPS, path)
    print(f"phase 66 {n}^3 buoyant + energy: 4z "
          f"{buoy_sharded[f'{n}_4z']['ms']:.3f} ms/step, (2, 2) "
          f"{buoy_sharded[f'{n}_2x2']['ms']:.3f} ms/step, single-device "
          f"{ms_b['kernel']:.3f} (phase 33)", flush=True)
    nm_ = N_BICG_STEP
    grid_m = Grid.uniform(nm_, nm_, nm_, zmin=0.0, zmax=1.0)
    for mname, mesh_t, exact in (("4z", mesh4, True),
                                 ("2x2", mesh22, False)):
        buoy_sharded[f"{nm_}_mixed_{mname}"] = thermal_mesh_run(
            f"phase 66 {nm_}^3 mixed thermal faces over {mname}", grid_m,
            params_e, tg_field_t_x, (nm_,) * 3, mesh_t, exact, 1, 3, None)
    for method, pp, wrappers, path, plains in (
            (Method.CG, PoissonParams(tolerance=1e-3),
             step_wrappers + cg_wrappers, "sharded-cg-buoy",
             PLAIN_CG + PLAIN_STEP),
            (Method.BICGSTAB, PoissonParams(tolerance=bicg_step_tol),
             step_wrappers + tuple(bk.WRAPPERS), "sharded-bicgstab-buoy",
             PLAIN_BICG + PLAIN_STEP)):
        buoy_sharded[f"{method.name.lower()}_{nm_}_4z"] = krylov_step_pair(
            f"phase 66 {method.name} step {nm_}^3 buoyant + energy over "
            f"{SHARDS} z-shards (tolerance {pp.tolerance:g})", (nm_,) * 3,
            method, pp, wrappers, path, plains, params=params_buoy,
            field_fn=tg_field_t_z)
        torch.cuda.empty_cache()
    print(f"phase 66 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 67: the 2D de Vahl Davis chunk over 4y ----------------------
    # phase 34's configuration (dvd_case: Ra = 1e4 at 128^2, buoyancy, the
    # energy equation, Dirichlet left and right) through make_sharded_step
    # on the 4y mesh for one DVD_CHUNK_4Y, with phase 34's no-slip walls on
    # each block (the y walls on the edge shards), beside the single-device
    # step from the same start: status 0 every step; after the first step
    # u, v, p against the float64 step on the card at TOL_2D_F64_* (the
    # dense y solve rounds otherwise than Thomas), T against the
    # single-device step at 1e-5·(T_HOT - T_COLD); after the chunk both
    # Nu_avg (phase 34's formula) within 0.5%, the largest differences
    # printed without a bar (rounding grows along the march).
    t_phase = time.perf_counter()
    grid_d, params_d, alpha_d, fd0 = dvd_case()
    step_s, place = make_sharded_step(grid_d, params_d, mesh_y4,
                                      "projection")
    single = make_projection_step(grid_d, params_d, torch.float32,
                                  Method.FFT_DIRECT, device=dev)
    y_edges = [mesh_y4.comm.coords(s)[1] for s in mesh_y4.comm.shards]
    py_d = mesh_y4.comm.shape[1]

    def walls(sf):
        """Phase 34's no-slip walls on each block: the x walls on every
        block, the y walls on the edge shards, in place."""
        for b, yi in zip(sf.blocks, y_edges):
            for a in (b.u, b.v):
                a[..., 0] = 0.0
                a[..., -1] = 0.0
                if yi == 0:
                    a[:, 0, :] = 0.0
                if yi == py_d - 1:
                    a[:, -1, :] = 0.0
        return sf

    def march(stepf, f, start, n_steps, sharded):
        worst = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(start, start + n_steps):
            if sharded:
                f = walls(f)
            else:
                f = f.replace(u=apply_dirichlet_scalar(f.u, noslip),
                              v=apply_dirichlet_scalar(f.v, noslip))
            f, r = stepf(f, DVD_DT, i)
            worst = torch.maximum(worst, r.status.abs())
        return f, worst

    label = f"phase 67 de Vahl Davis {N_DVD}^2 over 4y"
    fs1, w_s = march(step_s, place(fd0), 0, 1, True)
    f1, w_1 = march(single, fd0, 0, 1, False)
    f64 = FlowField(*(getattr(fd0, nm).double() for nm in names6))
    f64 = f64.replace(u=apply_dirichlet_scalar(f64.u, noslip),
                      v=apply_dirichlet_scalar(f64.v, noslip))
    s64 = make_projection_step(grid_d, params_d, torch.float64,
                               Method.FFT_DIRECT, device=dev)(
        f64, DVD_DT, 0)[0]
    g1 = gather_field(fs1)
    sync()
    e_y = {nm: float((getattr(g1, nm).double() - getattr(s64, nm)).abs()
                     .max()) for nm in "uvp"}
    e_1 = {nm: float((getattr(f1, nm).double() - getattr(s64, nm)).abs()
                     .max()) for nm in "uvp"}
    d_1 = {nm: float((getattr(g1, nm) - getattr(f1, nm)).abs().max())
           for nm in "uvpT"}
    print(f"{label} first step: max|4y - float64| {e_y}, max|single-device "
          f"- float64| {e_1}, max|4y - single-device| {d_1}", flush=True)
    pscale = float(s64.p.abs().max())
    for nm in "uvp":
        bar_ = TOL_2D_F64_P * pscale if nm == "p" else TOL_2D_F64_UVW
        if not e_y[nm] <= bar_:
            fail(f"{label} first step {nm}: {e_y[nm]:.3e} off the float64 "
                 f"step, above {bar_:.3e}")
    compare(f"{label} first step vs single-device", "T", g1.T, f1.T,
            1e-5 * (T_HOT - T_COLD), False)
    del f64, s64, g1
    pk2m.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    fs_d, w_s2 = march(step_s, fs1, 1, DVD_CHUNK_4Y - 1, True)
    sync()
    ms_dvd_s = (time.perf_counter() - t0) * 1e3 / (DVD_CHUNK_4Y - 1)
    n_star = pk2m.predictor_star_2d.global_ny_launches
    launch_counts["sharded-2d-buoy"] = {
        "predictor_star_2d[global_ny,buoyant]": n_star}
    t0 = time.perf_counter()
    fd_1, w_12 = march(single, f1, 1, DVD_CHUNK_4Y - 1, False)
    sync()
    ms_dvd_1 = (time.perf_counter() - t0) * 1e3 / (DVD_CHUNK_4Y - 1)
    worst_d = int(torch.stack([w_s, w_s2, w_1, w_12]).max())
    g_d = gather_field(fs_d)
    nu_s, nu_1 = nu_avg_of(g_d.T), nu_avg_of(fd_1.T)
    d_end = {nm: float((getattr(g_d, nm) - getattr(fd_1, nm)).abs().max())
             for nm in "uvT"}
    print(f"{label}: {DVD_CHUNK_4Y} steps, {ms_dvd_s:.4f} ms/step host wall "
          f"(single-device {ms_dvd_1:.4f}), worst status {worst_d}, "
          f"Nu_avg {nu_s:.5f} (single-device {nu_1:.5f}), "
          f"predictor_star_2d[global_ny] launches {n_star}; max|4y - "
          f"single-device| after the chunk {d_end}", flush=True)
    if worst_d != 0 or not bool(g_d.is_finite()):
        fail(f"{label}: a nonzero status or non-finite fields")
    if n_star != (DVD_CHUNK_4Y - 1) * len(mesh_y4.comm.shards):
        fail(f"{label}: not the buoyant 2D row predictor once a shard a "
             f"step")
    if not abs(nu_s - nu_1) <= 0.005 * abs(nu_1):
        fail(f"{label}: Nu_avg {nu_s:.5f} not within 0.5% of the "
             f"single-device {nu_1:.5f}")
    dvd_4y = {"steps": DVD_CHUNK_4Y, "ms_per_step": ms_dvd_s,
              "single_ms_per_step": ms_dvd_1, "nu_avg": nu_s,
              "single_nu_avg": nu_1, "first_step_off_float64": e_y,
              "single_first_step_off_float64": e_1,
              "first_step_max_abs_diff": d_1,
              "max_abs_diff_after_chunk": d_end}
    del fd0, fs1, f1, fs_d, fd_1, g_d
    torch.cuda.empty_cache()
    print(f"phase 67 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ==== the consistent scheme on the z-decomposed step; DEFAULT ==========
    # ---- phase 68: the consistent global_nz kernel modes (row B3) ---------
    # pred_star_kernel<true, false> and poisson_input_kernel<true, false>
    # with the block's global plane base (z_base, nz_g) on the consistent
    # weight rows, the predictor with and without buoyancy (phase 35's
    # buoyant consts, a seeded noisy T), on the first, a middle and the
    # last block of 4 z-shards of a 37x23x16 stretched grid and on every
    # block of the 512^3 tanh beta = 1.5 grid, the fields padded as the
    # step pads them (2 planes a side for the predictor, 1 for b~, zeros
    # past the global ends); corrector_kernel<true> on the block the step
    # gives it (an edge shard's starts or ends at its global shell).
    # Every block bit-equal to its plain twin, and its owned window (the
    # predictor's owned planes and the in-domain planes +-1 that b~ reads)
    # bit-equal to phase 35's single-device consistent kernel on the whole
    # field; a middle block of each timed by its device time, its bound
    # 6 block fields (7 with T) over 132x512x512 for the predictor, 5 over
    # 130x512x512 for b~, the corrector's 7 over its 130-plane block, each
    # with the weight rows once.
    t_phase = time.perf_counter()
    maxima_rel = (TOL_EXACT, True)   # phase 66 rebinds ``exact``
    for shape in ((16, 23, 37), (N_BIG,) * 3):
        nz_g, ny, nx = shape
        big = nz_g == N_BIG
        nzl = nz_g // SHARDS
        tag = "x".join(map(str, shape[::-1])) + " stretched"
        print(f"phase 68 consistent global_nz kernels vs plain at {tag} "
              f"over {SHARDS} z-shards", flush=True)
        grid = stretched_grid(shape)
        problem = NonuniformPoissonProblem.from_grid(grid)
        weights = pkm.consistent_weights(*coords(grid), torch.float32, dev)
        c, cb = (pkm.stencil_consts(nz_g, ny, nx, grid.dx0, grid.dy0,
                                    grid.dz0, grid.xmin, grid.ymin,
                                    NSParams().mu, True, pb, torch.float32,
                                    weights, nonuniform_face_coeffs(problem))
                 for pb in (None, buoy_cons))
        f = noisy(FlowField.initialize(grid, dtype=torch.float32,
                                       device=dev), SEED + 68)
        T = f.T + torch.randn(shape, generator=torch.Generator(
            device=dev).manual_seed(SEED + 69), device=dev)
        dt = torch.full((), 1e-3, device=dev)
        scal = torch.tensor([1e-3, 0.1, 0.05], device=dev)
        rod, s = 1.0 / dt, dt / 1.0
        # phase 35's single-device kernels on the whole field
        whole = {False: pkm.predictor_star(f.u, f.v, f.w, scal, c),
                 True: pkm.predictor_star(f.u, f.v, f.w, scal, cb, T)}
        bt_whole = pkm.poisson_input(*whole[False], f.p, rod, c)
        corr_whole = pkm.corrector(*whole[False], f.p, s, c)[:3]
        padded = [zpad(x, 2) for x in (f.u, f.v, f.w, T)]
        p1 = zpad(f.p, 1)
        for shard in (range(SHARDS) if big
                      else (0, SHARDS // 2, SHARDS - 1)):
            z_off = shard * nzl
            timed = big and shard == SHARDS // 2
            stag = f"phase 68 {tag} shard {shard}"
            blk = [x[z_off:z_off + nzl + 4] for x in padded]
            lo, hi = max(z_off - 1, 0), min(z_off + nzl + 1, nz_g)
            stars = {}
            for buoy, cc, path, name in (
                    (False, c, "sharded-cons",
                     "predictor_star[consistent,global_nz]"),
                    (True, cb, "sharded-cons-buoy",
                     "predictor_star[consistent,global_nz,buoyant]")):
                c_pred = dataclasses.replace(cc, nz=nzl + 4)
                Tb = blk[3] if buoy else None
                ins = (*blk[:3], scal, *weights) + ((Tb,) if buoy else ())
                outs = check(
                    path, stag, timed, pkm.predictor_star, A1_CONS_SHARD,
                    SRC,
                    lambda: pkm.predictor_star(*blk[:3], scal, c_pred, Tb,
                                               z_off - 2, nz_g),
                    lambda: pkm.predictor_star_plain(*blk[:3], scal, c_pred,
                                                     Tb, z_off - 2, nz_g),
                    ("u*", "v*", "w*"), (bit,) * 3,
                    work=(ins, FLOPS_PER_POINT[
                        "predictor_star_cons_buoyant" if buoy
                        else "predictor_star_cons"] * blk[0].numel()),
                    name=name, device_time=True)
                for o, want, nm in zip(outs, whole[buoy], ("u*", "v*", "w*")):
                    compare(f"{stag} owned window vs single-device", nm,
                            o[lo - z_off + 2:hi - z_off + 2], want[lo:hi],
                            *bit)
                stars[buoy] = outs
            us, vs, ws = stars[False]
            pb = p1[z_off:z_off + nzl + 2]
            c_bt = dataclasses.replace(c, nz=nzl + 2)
            bt = check(
                "sharded-cons", stag, timed, pkm.poisson_input,
                A5_BT_CONS_SHARD, SRC,
                lambda: pkm.poisson_input(us[1:-1], vs[1:-1], ws[1:-1], pb,
                                          rod, c_bt, z_off - 1, nz_g),
                lambda: pkm.poisson_input_plain(us[1:-1], vs[1:-1],
                                                ws[1:-1], pb, rod, c_bt,
                                                z_off - 1, nz_g),
                ("b~",), (bit,),
                work=((us[1:-1], vs[1:-1], ws[1:-1], pb, *weights),
                      FLOPS_PER_POINT["poisson_input_cons"] * pb.numel()),
                name="poisson_input[consistent,global_nz]",
                device_time=True)[0]
            compare(f"{stag} owned window vs single-device", "b~",
                    bt[1:-1], bt_whole[z_off:z_off + nzl], *bit)
            a = 0 if shard == 0 else 1
            e = 0 if shard == SHARDS - 1 else 1
            sl = slice(2 - a, nzl + 2 + e)
            usc, vsc, wsc = (x[sl] for x in (us, vs, ws))
            pc = f.p[z_off - a:z_off + nzl + e]
            c_corr = dataclasses.replace(c, nz=nzl + a + e)
            corr = check(
                "sharded-cons", stag, timed, pkm.corrector, A5_CONS, SRC,
                lambda: pkm.corrector(usc, vsc, wsc, pc, s, c_corr),
                lambda: pkm.corrector_plain(usc, vsc, wsc, pc, s, c_corr),
                ("u", "v", "w", "max|u|^2", "max p", "max|p|"),
                (bit,) * 3 + (maxima_rel,) * 3,
                work=((usc, vsc, wsc, pc, *weights),
                      FLOPS_PER_POINT["corrector_cons"] * pc.numel()),
                name="corrector[consistent]", device_time=True)
            for o, want, nm in zip(corr, corr_whole, "uvw"):
                compare(f"{stag} owned window vs single-device", nm,
                        o[a:a + nzl], want[z_off:z_off + nzl], *bit)
            del blk, stars, us, vs, ws, pb, bt, usc, vsc, wsc, pc, corr
        del f, T, whole, bt_whole, corr_whole, padded, p1
        torch.cuda.empty_cache()
    print(f"phase 68 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 69: the consistent step over 4z ----------------------------
    # bench.py:run_3d_consistent(512)'s step (phase 36) through
    # make_sharded_step(..., "projection") over 4 z-shards: HIGHEST
    # bit-equal to the single-device consistent kernel step after 1 step
    # and after 6; 3 warm-up and 5 timed steps of each (CUDA events), the
    # counters set to 0 just before the timed sharded steps and every
    # plain twin a tripwire; HIGH (the sharded chain stores t where the
    # single-device HIGH step rebuilds it) against the single-device HIGH
    # step at phase 43's HIGH bars, timed the same way.  The wall cells
    # lie past the viscous limit (in the reference too), so the step is
    # held against the single-device step only.  Then a buoyant + energy
    # consistent step at 64x48x32 stretched (phase 31's "mixed" thermal
    # faces: periodic back and front cross the shards) over 4z, 3 steps,
    # bit-equal to the single-device step; and Simulation.from_grid on a
    # 4z mesh with a consistent stretched grid, one step against the
    # single-device facade.
    t_phase = time.perf_counter()
    n = N_BIG
    shape, cells = (n, n, n), n ** 3
    grid_cs = stretched_grid(shape)
    PLAIN_CONS = PLAIN_Z + [(rolling, "matmul_plain")]
    cons_rec = {}

    def cons_counts(high):
        """The consistent sharded step's launch counts: its stencils'
        global_nz counters, the corrector's consistent one, the Thomas
        pair and the GEMM of the precision."""
        counts = {
            "predictor_star[consistent,global_nz]":
            pkm.predictor_star.global_nz_launches,
            "poisson_input[consistent,global_nz]":
            pkm.poisson_input.global_nz_launches,
            "corrector[consistent]": pkm.corrector.consistent_launches,
            "tdma_z_fwd": tdma.tdma_z_fwd.launches,
            "tdma_z_bwd": tdma.tdma_z_bwd.launches}
        if high:
            counts["plane_dot[3xtf32]"] = rolling.plane_dot.high_launches
        else:
            counts["plane_dot"] = rolling.plane_dot.launches
        return counts

    for prec in (None, "high"):
        label = (f"phase 69 consistent {n}^3 over {SHARDS} z-shards "
                 f"{'HIGH' if prec else 'HIGHEST'}")
        step_s, place = make_sharded_step(
            grid_cs, params_c, mesh4, "projection",
            poisson_method=Method.FFT_DIRECT, spectral_precision=prec)
        single = make_projection_step(grid_cs, params_c, torch.float32,
                                      Method.FFT_DIRECT, device=dev,
                                      spectral_precision=prec)
        f0 = tg_field(shape)
        fs0 = place(f0)
        run_steps(step_s, fs0, 1e-4, 3)
        fs1 = step_s(fs0, 1e-4, 0)[0]
        g1 = gather_field(fs1)
        s1 = single(f0, 1e-4, 0)[0]
        sync()
        tag = f"{label} first step"
        diffs = {nm: float((getattr(g1, nm) - getattr(s1, nm)).abs().max())
                 for nm in "uvwp"}
        print(f"{tag}: max|sharded - single-device| {diffs}", flush=True)
        if prec is None:
            if any(diffs.values()):
                fail(f"{tag}: not bit-equal to the single-device step")
        else:
            def held_c(name_, bar, passed=0.0):
                ref = getattr(s1, name_)
                scale = max(1.0, float(ref.abs().max()))
                return compare(tag + " vs single-device HIGH", name_,
                               getattr(g1, name_), ref,
                               bar * scale + passed, False)[0]

            dp = held_c("p", HIGH_P)
            held_c("u", HIGH_U, 1e-4 / float(grid_cs.dx.min()) * dp)
            held_c("v", HIGH_U, 1e-4 / float(grid_cs.dy.min()) * dp)
            held_c("w", HIGH_U, 1e-4 / grid_cs.dz0 * dp)
        del g1
        sync()
        pkm.reset_launch_counts()
        tdma.tdma_z_fwd.launches = tdma.tdma_z_bwd.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with no_plain(label, PLAIN_CONS):
            start.record()
            fs, res_s = run_steps(step_s, fs1, 1e-4, TIMED_STEPS,
                                  start_iter=1)
            end.record()
            sync()
        ms_s = start.elapsed_time(end) / TIMED_STEPS
        counts = cons_counts(prec == "high")
        print(f"{label}: launch counts over the main path {counts}",
              flush=True)
        if min(counts.values()) <= 0 or \
                counts["predictor_star[consistent,global_nz]"] != \
                SHARDS * TIMED_STEPS:
            fail(f"{label}: a kernel of the step not launched, or not the "
                 f"consistent predictor once a shard a step")
        if prec == "high" and rolling.plane_dot.launches:
            fail(f"{label}: an SGEMM launched on the HIGH path")
        launch_counts["sharded-cons-high" if prec else "sharded-cons"] = \
            counts
        run_steps(single, s1, 1e-4, 3, start_iter=1)
        sync()
        start.record()
        f6, res_1 = run_steps(single, s1, 1e-4, TIMED_STEPS, start_iter=1)
        end.record()
        sync()
        ms_1 = start.elapsed_time(end) / TIMED_STEPS
        g = gather_field(fs)
        drift = {nm: float((getattr(g, nm) - getattr(f6, nm)).abs().max())
                 for nm in "uvwp"}
        print(f"{label}: {ms_s:.3f} ms/step, "
              f"{cells / (ms_s * 1e-3) / 1e6:.1f} MLUPS; single-device "
              f"kernel step {ms_1:.3f} ms/step, "
              f"{cells / (ms_1 * 1e-3) / 1e6:.1f} MLUPS; status "
              f"{int(res_s.status)}; max|sharded - single| after "
              f"{1 + TIMED_STEPS} steps {drift}", flush=True)
        if int(res_s.status) != 0 or not bool(g.is_finite()):
            fail(f"{label}: nonzero status or non-finite fields")
        if prec is None and any(drift.values()):
            fail(f"{label}: not bit-equal to the single-device step after "
                 f"{1 + TIMED_STEPS} steps")
        if do_profile and prec is None:
            profile_steps(torch, f"phase 5 {label}",
                          lambda: run_steps(step_s, fs0, 1e-4,
                                            PROFILED_STEPS),
                          PROFILED_STEPS)
        cons_rec["high" if prec else "highest"] = {
            "ms": ms_s, "mlups": cells / (ms_s * 1e-3) / 1e6,
            "single_ms": ms_1, "single_mlups": cells / (ms_1 * 1e-3) / 1e6,
            "first_step_max_abs_diff": diffs,
            f"max_abs_diff_after_{1 + TIMED_STEPS}": drift}
        del f0, fs0, fs1, s1, fs, g, f6
        torch.cuda.empty_cache()

    # the buoyant + energy consistent step at 64x48x32 over 4z
    shape_b = (32, 48, 64)
    grid_cb = stretched_grid(shape_b)
    params_cb = dataclasses.replace(
        thermal_params(THERMAL_FACE_MIXES["mixed"]),
        nonuniform_scheme="consistent", alpha=ALPHA_3D)
    label = (f"phase 69 consistent buoyant + energy 64x48x32 over {SHARDS} "
             f"z-shards")
    step_s, place = make_sharded_step(grid_cb, params_cb, mesh4,
                                      "projection")
    single = make_projection_step(grid_cb, params_cb, torch.float32,
                                  Method.FFT_DIRECT, device=dev)
    f0 = tg_field_t_x(shape_b)
    pkm.reset_launch_counts()
    with no_plain(label, PLAIN_CONS):
        fs, res_s = run_steps(step_s, place(f0), 1e-4, 3)
        sync()
    n_star = pkm.predictor_star.global_nz_launches
    launch_counts["sharded-cons-buoy"] = {
        "predictor_star[consistent,global_nz,buoyant]": n_star}
    f3, res_1 = run_steps(single, f0, 1e-4, 3)
    g = gather_field(fs)
    sync()
    d_b = {nm: float((getattr(g, nm) - getattr(f3, nm)).abs().max())
           for nm in "uvwpT"}
    print(f"{label}: status {int(res_s.status)}, max T "
          f"{float(res_s.max_temperature)!r} (single "
          f"{float(res_1.max_temperature)!r}), buoyant predictor launches "
          f"{n_star}; max|sharded - single-device| after 3 steps {d_b}",
          flush=True)
    if int(res_s.status) != 0 or not bool(g.is_finite()) or any(
            d_b.values()) or n_star != 3 * SHARDS:
        fail(f"{label}: a nonzero status, a difference from the "
             f"single-device step, or not the buoyant consistent predictor "
             f"once a shard a step")
    cons_rec["buoyant_energy_64x48x32_max_abs_diff"] = d_b
    del f0, fs, f3, g

    # the facade on the 4z mesh with a consistent stretched grid
    params_f = NSParams(dt=0.001, cfl=0.2, mu=0.01, max_iter=1,
                        nonuniform_scheme="consistent")
    label = "phase 69 Simulation.from_grid(64x48x32 consistent) over 4z"
    sims = {kind: Simulation.from_grid(
        grid_cb, "projection_spectral", params_f,
        **({"mesh": mesh4} if kind == "mesh" else {"device": dev}))
        for kind in ("mesh", "single")}
    f69 = tg_field(shape_b)
    sims["mesh"].field = sims["mesh"].solver.place(f69)
    sims["single"].field = f69
    st69 = [int(sims[k].step()) for k in ("mesh", "single")]
    sync()
    g = sims["mesh"].field.gather()
    d_f = {nm: float((getattr(g, nm) - getattr(sims["single"].field, nm))
                     .abs().max()) for nm in "uvwp"}
    print(f"{label}: statuses {st69}, max|mesh - single-device| {d_f}",
          flush=True)
    if any(st69) or any(d_f.values()) or not isinstance(
            sims["mesh"].field, ShardedField):
        fail(f"{label}: a facade step failed, differs from the "
             f"single-device facade, or the field left the mesh")
    cons_rec["facade_max_abs_diff"] = d_f
    del sims, g, f69
    torch.cuda.empty_cache()
    print(f"phase 69 consistent {n}^3 over 4z: HIGHEST "
          f"{cons_rec['highest']['ms']:.3f} ms/step (single-device "
          f"{cons_rec['highest']['single_ms']:.3f}), HIGH "
          f"{cons_rec['high']['ms']:.3f} (single-device "
          f"{cons_rec['high']['single_ms']:.3f})", flush=True)
    print(f"phase 69 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 70: spectral_precision="default" on the decomposed steps --
    # The one-pass TF32 GEMM on a middle shard's 130x512x512 x^ block
    # against its plain version (TOL_GEMM), then the DEFAULT steps: the
    # 512^3 step over 4z (uniform, and consistent on the tanh grid) and
    # over (2, 2), the 2048^2 step over 4y, each against the single-device
    # DEFAULT step after one step: the 4z uniform step bit for bit (the
    # same chain on every point), the 4y step with p within TOL_TF32_4Y of
    # max|p|, the others within TOL_TF32_STEP (the consistent sharded step
    # runs the eigenbasis-fused chain at DEFAULT as the reference's does,
    # the single-device one the emit-b~ route; the (2, 2) step's dense
    # z stage meets the single-device Thomas solve), u, v, w within what
    # p's bar passes on through the corrector; then 3 warm-up and 5 (2D:
    # 20) timed steps, the counters set to 0 just before them and every
    # plain twin of the path a tripwire, beside the HIGHEST steps' ms of
    # phases 43, 69, 52 and 59.
    t_phase = time.perf_counter()
    def_rec = {}
    f, (fxt, fy, gxt, gy), mu, w, c = make_inputs(shape, SEED + 70)
    nb = n // SHARDS + 2
    xb = f.p[(SHARDS // 2) * (n // SHARDS) - 1:][:nb]
    tf32_plan(f"phase 70 {n}x{n}x{nb} x^ block x·GxT", nb * n, n, n)
    tf32_plan(f"phase 70 {n}x{n}x{nb} x^ block Gy·t[k]", n, n, n, nb)
    check("sharded-default", f"phase 70 {n}x{n}x{nb} x^ block", True,
          rolling.plane_dot, HP_DOT, SRC_GEMM_TF32,
          lambda: rolling.plane_dot(xb, gxt, gy, "default"),
          lambda: rolling.plane_dot_plain(xb, gxt, gy, "default"),
          ("inverse",), (gemm,),
          work=((xb, gxt, gy), gemm_flops(nb * n, n, n)
                + gemm_flops(n, n, n, nb)),
          library=tf32_matmul(lambda: torch.einsum("ij,kjl,lm->kim", gy,
                                                   xb, gxt)),
          name="plane_dot[tf32]", rate=TF32_TC_FLOPS, device_time=True,
          repeat=True)
    del f, fxt, fy, gxt, gy, mu, xb
    torch.cuda.empty_cache()
    grid_u = Grid.uniform(n, n, n, zmin=0.0, zmax=1.0)
    params_u = NSParams(source_amplitude_u=0.0, source_amplitude_v=0.0,
                        mu=0.01)
    grid_2 = Grid.uniform(N_2D, N_2D)
    gemms_d = (rolling.plane_dot, rolling.right_dot, rolling.left_dot)

    def default_counts(key):
        """The DEFAULT step's launch counts over its main path: its
        stencils' block-mode counters, the Thomas pair of the z-only
        steps and the one-pass TF32 GEMMs it runs."""
        if key == "4y":
            counts = {f"{w_.__name__}[global_ny]": w_.global_ny_launches
                      for w_ in (pk2m.predictor_star_2d,
                                 pk2m.poisson_input_2d,
                                 pk2m.corrector_2d_rows)}
        elif key == "2x2":
            counts = sharded_counts((pkm.predictor_star, pkm.poisson_input,
                                     pkm.corrector_rows), "global_ny")
        else:
            counts = (sharded_wrappers(False) if key == "4z"
                      else cons_counts(False))
            del counts["plane_dot"]
        dots = (("plane_dot",) if key.startswith("4z")
                else ("right_dot", "left_dot"))
        counts.update({f"{d}[tf32]": getattr(rolling, d).default_launches
                       for d in dots})
        return counts

    for key, grid_d, params_d, mesh_d, shape_d, dt_d, n_timed, highest, \
            path, plains in (
            ("4z", grid_u, params_u, mesh4, shape, 1e-4, TIMED_STEPS,
             sharded_rec["highest"]["ms"], "sharded-default", PLAIN_Z),
            ("4z_consistent", grid_cs, params_c, mesh4, shape, 1e-4,
             TIMED_STEPS, cons_rec["highest"]["ms"], "sharded-cons-default",
             PLAIN_CONS),
            ("2x2", grid_u, params_u, mesh22, shape, 1e-4, TIMED_STEPS,
             zy_rec["2x2_highest"]["ms"], "sharded-zy-default", PLAIN_ZY),
            ("4y", grid_2, params_u, mesh_y4, (1, N_2D, N_2D), 1e-5,
             TIMED_STEPS_2D, rec_2d["highest"]["ms"], "sharded-2d-default",
             PLAIN_2D)):
        label = f"phase 70 DEFAULT {key}"
        step_s, place = make_sharded_step(grid_d, params_d, mesh_d,
                                          "projection",
                                          spectral_precision="default")
        single = make_projection_step(grid_d, params_d, torch.float32,
                                      Method.FFT_DIRECT, device=dev,
                                      spectral_precision="default")
        f0 = tg_field(shape_d)
        fs0 = place(f0)
        g1 = gather_field(step_s(fs0, dt_d, 0)[0])
        s1 = single(f0, dt_d, 0)[0]
        sync()
        pmax = float(s1.p.abs().max())
        tag = f"{label} first step vs single-device DEFAULT"
        tol_p = TOL_TF32_4Y if key == "4y" else TOL_TF32_STEP
        if key == "4z":
            tol_p = 0.0
        dp = compare(tag, "p", g1.p, s1.p, tol_p, True)[0]
        u_abs = 0.0
        for k, d in (("u", float(grid_d.dx.min())),
                     ("v", float(grid_d.dy.min())),
                     ("w", grid_d.dz0 if shape_d[0] > 1 else None)):
            bar = 0.0 if key == "4z" else TOL_FIELD + (
                dt_d / d * tol_p * pmax if d else 0.0)
            u_abs = max(u_abs, compare(tag, k, getattr(g1, k),
                                       getattr(s1, k), bar, False)[0])
        del g1, s1
        run_steps(step_s, fs0, dt_d, 3)
        sync()
        pkm.reset_launch_counts()
        pk2m.reset_launch_counts()
        rolling.reset_launch_counts()
        tdma.tdma_z_fwd.launches = tdma.tdma_z_bwd.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with no_plain(label, plains):
            start.record()
            fs, res_s = run_steps(step_s, fs0, dt_d, n_timed)
            end.record()
            sync()
        ms_s = start.elapsed_time(end) / n_timed
        counts = default_counts(key)
        other = {g_.__name__: (g_.launches, g_.high_launches)
                 for g_ in gemms_d}
        cp_async = {g_.__name__: g_.default_cp_async_launches
                    for g_ in gemms_d}
        print(f"{label}: launch counts over the main path {counts}; "
              f"(SGEMM, 3xTF32) launches {other}; one-pass launches "
              f"through the cp.async loads {cp_async}", flush=True)
        if min(counts.values()) <= 0 or max(max(v) for v in
                                            other.values()) != 0:
            fail(f"{label}: a kernel of the step not launched, or not the "
                 f"one-pass TF32 products alone")
        launch_counts[path] = counts
        g = gather_field(fs)
        print(f"{label}: {ms_s:.3f} ms/step (HIGHEST {highest:.3f}, "
              f"{highest / ms_s:.2f}x); status {int(res_s.status)}; first "
              f"step max|p - p_single|/max|p| {dp / pmax:.3e}, max|u - "
              f"u_single| {u_abs:.3e}", flush=True)
        if int(res_s.status) != 0 or not bool(g.is_finite()):
            fail(f"{label}: nonzero status or non-finite fields")
        def_rec[key] = {"ms": ms_s, "highest_ms": highest,
                        "first_step_p_rel": dp / pmax,
                        "first_step_u_abs": u_abs}
        del f0, fs0, fs, g
        torch.cuda.empty_cache()
    print(f"phase 70 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 71: the IEEE fp32 SGEMM at every HIGHEST launch shape ------
    # csrc/sgemm_fp32.cu at each shape the HIGHEST main paths launch (the
    # 4y shard's x-DST and y slab, the 2048² x-DST, the (2, 2) shard's x-DST
    # and z stage, the eigen z-product, a 130-plane block's and the 512³
    # planes' two plane_dot launches) and the small ones the script runs:
    # the kernel against its plain version at TOL_GEMM, two launches
    # bit-identical, one SGEMM launch a call, its plan (tile, CTAs, tiles,
    # loads), device ms beside its bound and one torch.matmul (TF32 off)
    # of the same product.  Then the sum-order contract bit for bit: a
    # row slice's x-DST, a plane block's plane_dot and a column slice
    # written in place are those rows, planes and columns of the whole
    # product, whichever tile and loads each launch takes.
    t_phase = time.perf_counter()
    print("phase 71 the SGEMM vs plain at every HIGHEST launch shape",
          flush=True)
    g71 = torch.Generator(device=dev).manual_seed(SEED + 71)

    def rand71(*shape):
        return torch.randn(shape, generator=g71, device=dev)

    sgemm_rec = {}
    # records of the table's shapes: (path, record name, the wrapper whose
    # launches on that main path the record takes)
    sgemm_alias = []

    def sgemm_case(tag, mnkb, kernel, library, ins, path=None,
                   counted=None, replaces=DOT, loads=None):
        """One launch shape: ``kernel`` (one wrapper call, one SGEMM
        launch of M x N x K over the batch ``mnkb``) against ``library``
        (one torch.matmul, TF32 off: also the plain version)."""
        m, n_, k, b = mnkb
        rolling.reset_launch_counts()
        got = kernel()
        sync()
        n_cp = sum(g_.highest_cp_async_launches for g_ in rolling.WRAPPERS)
        n_sg = sum(g_.launches for g_ in rolling.WRAPPERS)
        again = kernel()
        ref = library()
        sync()
        same = torch.equal(got, again)
        err, rel = compare(f"phase 71 {tag}", "sgemm", got, ref, *gemm)
        del got, again, ref
        if not same:
            fail(f"phase 71 {tag}: two launches differ")
        if n_sg != 1:
            fail(f"phase 71 {tag}: {n_sg} SGEMM launches a call, not 1")
        path_ = "cp.async" if n_cp else "TMA"
        if loads is not None and path_ != loads:
            fail(f"phase 71 {tag}: loads by {path_}, expected {loads}")
        pl = rolling.sgemm_plan(m, n_, k, b)
        ms = device_ms(kernel)
        lib_ms = device_ms(library)
        flops = gemm_flops(m, n_, k, b)
        b_ms, b_by = bound(nbytes(ins) + 4 * m * n_ * b, flops)
        print(f"  phase 71 {tag}: M={m} N={n_} K={k} batch={b}: tile "
              f"{pl['tile'][0]}x{pl['tile'][1]}, {pl['ctas']} CTAs over "
              f"{pl['tiles']} tiles, loads {path_}; two launches "
              f"bit-identical {same}; kernel {ms:.4f} ms, torch.matmul "
              f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x), bound {b_ms:.4f} ms "
              f"({b_by}; {flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
        sgemm_rec[tag] = {"M": m, "N": n_, "K": k, "batch": b,
                          "plan": pl, "loads": path_, "ms": ms,
                          "matmul_ms": lib_ms, "bound_ms": b_ms,
                          "max_rel_err": rel, "repeat_bit_identical": same}
        if path is not None:
            name = f"sgemm[{tag}]"
            records[(path, name)] = {
                "replaces": replaces, "source": SRC_SGEMM,
                "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                "plain_ms": lib_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                "bound_by": b_by}
            sgemm_alias.append((path, name, counted))
        return ms, lib_ms

    # the 4y shard (phase 58's shapes) and the 2048² x-DST
    nyl, n2 = N_2D // SHARDS, N_2D
    bt = rand71(nyl, n2)
    fxt = rand71(n2, n2)
    fy = rand71(n2 - 2, n2)
    slab = rand71(n2, n2 // SHARDS)
    sgemm_case("4y x-DST", (nyl, n2, n2, 1),
               lambda: rolling.right_dot(bt, fxt),
               ieee_matmul(lambda: torch.matmul(bt, fxt)), (bt, fxt),
               "sharded-2d", "right_dot", DOT2, "TMA")
    sgemm_case("4y y slab", (n2 - 2, n2 // SHARDS, n2, 1),
               lambda: rolling.left_dot(fy, slab),
               ieee_matmul(lambda: torch.matmul(fy, slab)), (fy, slab),
               "sharded-2d", "left_dot", YS_2D, "TMA")
    x2 = rand71(n2, n2)
    sgemm_case("2048^2 x-DST", (n2, n2, n2, 1),
               lambda: rolling.right_dot(x2, fxt),
               ieee_matmul(lambda: torch.matmul(x2, fxt)), (x2, fxt),
               "2d", "right_dot", DOT2, "TMA")
    # contract (b): a 512-row slice's x-DST (another tile) is those rows
    # of the 2048-row one
    whole = rolling.right_dot(x2, fxt)
    part = rolling.right_dot(x2[nyl:2 * nyl], fxt)
    sync()
    contract71 = {"(b) x-DST rows": torch.equal(part, whole[nyl:2 * nyl])}
    # contract (d): left_dot into a column slice (out=) is those columns
    # of the full product, at a 16-byte offset (TMA) and off it (4-byte
    # copies, scalar stores)
    full = rolling.left_dot(fy, x2)
    for c0, w_ in ((512, 512), (130, 384)):
        o = torch.full_like(full, float("nan"))
        rolling.reset_launch_counts()
        rolling.left_dot(fy, x2[:, c0:c0 + w_], out=o[:, c0:c0 + w_])
        sync()
        loads = ("cp.async" if rolling.left_dot.highest_cp_async_launches
                 else "TMA")
        key = f"(d) left_dot out=[:, {c0}:{c0 + w_}] ({loads})"
        contract71[key] = torch.equal(o[:, c0:c0 + w_],
                                      full[:, c0:c0 + w_])
        del o
    del bt, fxt, fy, slab, x2, whole, part, full
    torch.cuda.empty_cache()
    # the (2, 2) shard (phase 50's shapes) and the eigen z-product
    n = N_BIG
    f512 = rand71(n, n)
    xb = rand71(n // 2 * n // 2, n)
    sgemm_case("(2, 2) x-DST", (xb.shape[0], n, n, 1),
               lambda: rolling.right_dot(xb, f512),
               ieee_matmul(lambda: torch.matmul(xb, f512)), (xb, f512),
               "sharded-zy", "right_dot", DOT_ZY, "TMA")
    fz = rand71(n - 2, n)
    pencil = rand71(n, n // 2 * n // 2)
    sgemm_case("(2, 2) z stage", (n - 2, pencil.shape[1], n, 1),
               lambda: rolling.left_dot(fz, pencil),
               ieee_matmul(lambda: torch.matmul(fz, pencil)), (fz, pencil),
               "sharded-zy", "left_dot", YZ_Z, "TMA")
    del xb, fz, pencil
    zin = rand71(n, n * n)
    sgemm_case("eigen z-product", (n, n * n, n, 1),
               lambda: rolling.left_dot(f512, zin),
               ieee_matmul(lambda: torch.matmul(f512, zin)), (f512, zin),
               "fft", "left_dot", EIGEN_Z, "TMA")
    # the 512³ planes and a 130-plane block: plane_dot's two launches
    x3 = zin.view(n, n, n)
    fyl = rand71(n, n)
    nb = n // SHARDS + 2
    z0 = (SHARDS // 2) * (n // SHARDS) - 1
    pair_ms = {}
    for tag_, xs, path_, rep_ in (
            (f"{nb}-plane block", x3[z0:z0 + nb], "sharded", A5_CORR_SHARD),
            ("512^3", x3, "3d", DOT)):
        nz_ = xs.shape[0]
        t1 = rolling.right_dot(xs.reshape(-1, n), f512).view(nz_, n, n)
        # (ms_r, ms_l: not ms2, the 2048² step's times in the last line)
        ms_r, lib1 = sgemm_case(
            f"{tag_} x·right", (nz_ * n, n, n, 1),
            lambda: rolling.right_dot(xs.reshape(-1, n), f512),
            ieee_matmul(lambda: torch.matmul(xs.reshape(-1, n), f512)),
            (xs, f512), path_, "plane_dot", rep_, "TMA")
        ms_l, lib2 = sgemm_case(
            f"{tag_} left·t[k]", (n, n, n, nz_),
            lambda: rolling.left_dot(fyl, t1),
            ieee_matmul(lambda: torch.matmul(fyl, t1)), (fyl, t1), path_,
            "plane_dot", rep_, "TMA")
        pair_ms[tag_] = {"kernel": ms_r + ms_l, "matmul": [lib1, lib2]}
        del t1
    # the plane_dot records keep the einsum as their library call and
    # carry the two per-launch torch.matmul figures beside it
    for key_, tag_ in ((("3d", "plane_dot"), "512^3"),
                       (("sharded", "plane_dot"), f"{nb}-plane block"),
                       (("cons3d", "plane_dot"), "512^3")):
        if key_ in records:
            records[key_]["library_per_launch_ms"] = pair_ms[tag_]["matmul"]
    # contract (c): a 130-plane block's plane_dot is those planes of the
    # 512-plane one
    whole = rolling.plane_dot(x3, f512, fyl)
    blk = rolling.plane_dot(x3[z0:z0 + nb], f512, fyl)
    sync()
    contract71["(c) plane_dot block"] = torch.equal(blk,
                                                    whole[z0:z0 + nb])
    del whole, blk, x3, zin, f512, fyl
    torch.cuda.empty_cache()
    # the small shapes the script runs: 37x23x11's products (rows of 37
    # floats: the 4-byte copies), 128x32 and the 128² Ghia x-DST, and the
    # depths 2046 and 510 through factors stored padded (TMA) and packed
    # (the 4-byte copies), which give the same bits
    xo = rand71(11, 23, 37)
    ro, lo = rand71(37, 37), rand71(23, 23)
    sgemm_case("37x23x11 x·right", (253, 37, 37, 1),
               lambda: rolling.right_dot(xo.view(-1, 37), ro),
               ieee_matmul(lambda: torch.matmul(xo.view(-1, 37), ro)),
               (xo, ro), loads="cp.async")
    sgemm_case("37x23x11 left·x[k]", (23, 37, 23, 11),
               lambda: rolling.left_dot(lo, xo),
               ieee_matmul(lambda: torch.matmul(lo, xo)), (lo, xo),
               loads="cp.async")
    for rows_ in (32, 128):
        xs_, rs_ = rand71(rows_, 128), rand71(128, 128)
        sgemm_case(f"128x{rows_} x-DST", (rows_, 128, 128, 1),
                   lambda: rolling.right_dot(xs_, rs_),
                   ieee_matmul(lambda: torch.matmul(xs_, rs_)), (xs_, rs_),
                   loads="TMA")
    for k_, m_, n_ in ((2046, 2048, 512), (510, 512, 4096)):
        lp = spectral._tma_rows(rand71(m_, k_), "highest")
        lc = lp.contiguous()
        xk = rand71(k_, n_)
        sgemm_case(f"K={k_} padded", (m_, n_, k_, 1),
                   lambda: rolling.left_dot(lp, xk),
                   ieee_matmul(lambda: torch.matmul(lc, xk)), (lc, xk),
                   loads="TMA")
        sgemm_case(f"K={k_} packed", (m_, n_, k_, 1),
                   lambda: rolling.left_dot(lc, xk),
                   ieee_matmul(lambda: torch.matmul(lc, xk)), (lc, xk),
                   loads="cp.async")
        a_ = rolling.left_dot(lp, xk)
        b_ = rolling.left_dot(lc, xk)
        sync()
        contract71[f"(e) K={k_} TMA == 4-byte copies"] = torch.equal(a_, b_)
        del lp, lc, xk, a_, b_
    for key_, ok_ in contract71.items():
        print(f"phase 71 contract {key_}: bit for bit {ok_}", flush=True)
    # the mainloop's instruction mix, from the built library's SASS: each
    # instantiation's span from its first to its last FFMA (the unrolled
    # 32-deep stage)
    tool = Path(native._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "-sass", str(native.library_path())],
        capture_output=True, text=True, timeout=300).stdout \
        if tool.exists() else ""
    if "sgemm_fp32_kernel" not in sass:
        print(f"phase 71 SASS: not read ({tool})", flush=True)
    for fn_ in sass.split("Function : ")[1:]:
        inst = re.search(r"sgemm_fp32_kernelILi(\d)ELb(\d)", fn_)
        if not inst:
            continue
        ops = re.findall(SASS_OP, fn_)
        ffma = [i for i, o in enumerate(ops) if o == "FFMA"]
        loop = ops[ffma[0]:ffma[-1] + 1]
        mix = {o: loop.count(o) for o in sorted(set(loop))}
        tag_ = (f"sgemm_fp32_kernel<{inst.group(1)}, "
                f"{'TMA' if inst.group(2) == '1' else 'cp.async'}>")
        share = mix["FFMA"] / len(loop)
        sgemm_rec[f"SASS {tag_}"] = {"mainloop": len(loop),
                                      "ffma_share": share, "mix": mix}
        print(f"phase 71 SASS {tag_}: mainloop {len(loop)} instructions, "
              f"FFMA share {share:.3f}, {mix}", flush=True)
    if not all(contract71.values()):
        fail("phase 71: the SGEMM's sum-order contract does not hold "
             f"{contract71}")
    print(f"phase 71 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 72: the 3xTF32 GEMM at every HIGH launch shape ---------------
    # csrc/gemm_3xtf32.cu at each shape the HIGH main paths launch (the 4y
    # shard's x-DST and y slab, the 2048² x-DST, the (2, 2) shard's x-DST
    # and z stage, the two plane_dot launches of a 130-plane block, of the
    # 512³ planes — the uniform and the consistent step's — and of
    # 512×512×3, the 128² cavity's x-DST) and the small ones the script
    # runs: the kernel against its plain version at TOL_GEMM, its error
    # against a float64 product of the same inputs within GEMM_VS_SGEMM of
    # the SGEMM's, two launches bit-identical, one 3xTF32 launch a call,
    # its plan (tile, CTAs, tiles, D(K) against rolling.high_sum_order,
    # loads), device ms beside its bound, one torch.matmul (TF32 off) and
    # the SGEMM's launch of the same product.  Then the sum-order contract
    # bit for bit: a row slice's x-DST, a plane block's plane_dot and a
    # column slice written in place are those rows, planes and columns of
    # the whole product, and the TMA and 4-byte-copy launches agree.
    t_phase = time.perf_counter()
    print("phase 72 the 3xTF32 GEMM vs plain at every HIGH launch shape",
          flush=True)
    g72 = torch.Generator(device=dev).manual_seed(SEED + 72)

    def rand72(*shape):
        return torch.randn(shape, generator=g72, device=dev)

    high_rec = {}
    # records of the main paths' shapes: (path, record name, the wrapper
    # whose 3xTF32 launches on that main path the record takes)
    high_alias = []

    def high_case(tag, mnkb, call, ins, paths=(), counted=None,
                  replaces=DOT, loads="TMA"):
        """One launch shape: ``call(precision)`` is one wrapper call, at
        "high" one 3xTF32 launch of M x N x K over the batch ``mnkb``, at
        "highest" one SGEMM launch; ``ins`` the product's operands (left,
        right), whose torch.matmul is the library call and, in float64,
        the truth."""
        m, n_, k, b = mnkb
        rolling.reset_launch_counts()
        got = call("high")
        sync()
        n_cp = sum(g_.high_cp_async_launches for g_ in rolling.WRAPPERS)
        n_hi = sum(g_.high_launches for g_ in rolling.WRAPPERS)
        n_sg = sum(g_.launches for g_ in rolling.WRAPPERS)
        again = call("high")
        plain = rolling.matmul_plain(*ins, "high")
        sync()
        same = torch.equal(got, again)
        del again
        err, rel = compare(f"phase 72 {tag}", "3xtf32", got, plain, *gemm)
        del plain
        # against float64: the 3xTF32 GEMM's error at most GEMM_VS_SGEMM
        # times the SGEMM's
        truth = torch.matmul(ins[0].double(), ins[1].double())
        scale = float(truth.abs().max())
        e_hi = float((got.double() - truth).abs().max()) / scale
        del got
        sg = call("highest")
        e_sg = float((sg.double() - truth).abs().max()) / scale
        del sg, truth
        torch.cuda.empty_cache()
        if not same:
            fail(f"phase 72 {tag}: two launches differ")
        if n_hi != 1 or n_sg != 0:
            fail(f"phase 72 {tag}: {n_hi} 3xTF32 and {n_sg} SGEMM launches "
                 f"a call, not 1 and 0")
        path_ = "cp.async" if n_cp else "TMA"
        if path_ != loads:
            fail(f"phase 72 {tag}: loads by {path_}, expected {loads}")
        if not e_hi <= GEMM_VS_SGEMM * e_sg:
            fail(f"phase 72 {tag}: error against float64 {e_hi:.3e}, above "
                 f"{GEMM_VS_SGEMM} x the SGEMM's {e_sg:.3e}")
        pl = rolling.high_plan(m, n_, k, b)
        d, chunks = rolling.high_sum_order(k)
        if pl["D"] != d:
            fail(f"phase 72 {tag}: the kernel's D(K) {pl['D']} is not "
                 f"high_sum_order's {d}")
        ms = device_ms(lambda: call("high"))
        sg_ms = device_ms(lambda: call("highest"))
        lib_ms = device_ms(ieee_matmul(lambda: torch.matmul(*ins)))
        plain_ms = device_ms(lambda: rolling.matmul_plain(*ins, "high"))
        flops = 3 * gemm_flops(m, n_, k, b)
        b_ms, b_by = bound(nbytes(ins) + 4 * m * n_ * b, flops,
                           TF32_TC_FLOPS)
        print(f"  phase 72 {tag}: M={m} N={n_} K={k} batch={b}: tile "
              f"{pl['tile'][0]}x{pl['tile'][1]}, {pl['ctas']} CTAs over "
              f"{pl['tiles']} tiles, D={pl['D']} ({len(chunks)} chunks), "
              f"loads {path_}; two launches bit-identical {same}; vs "
              f"float64 {e_hi:.3e} (SGEMM {e_sg:.3e}); kernel {ms:.4f} ms, "
              f"SGEMM {sg_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.matmul {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), bound {b_ms:.4f} ms ({b_by}; "
              f"{flops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * flops / ms / 1e9 / (TF32_TC_FLOPS / 1e12):.1f}% of "
              f"the TF32 peak)", flush=True)
        high_rec[tag] = {"M": m, "N": n_, "K": k, "batch": b, "plan": pl,
                         "loads": path_, "ms": ms, "sgemm_ms": sg_ms,
                         "plain_ms": plain_ms, "matmul_ms": lib_ms,
                         "bound_ms": b_ms,
                         "max_rel_err": rel, "vs_float64": e_hi,
                         "sgemm_vs_float64": e_sg,
                         "repeat_bit_identical": same}
        for path in paths:
            name = f"gemm_3xtf32[{tag}]"
            records[(path, name)] = {
                "replaces": replaces, "source": SRC_GEMM,
                "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by}
            high_alias.append((path, name, counted))
        return ms, lib_ms

    def right72(x, f):
        return lambda prec: rolling.right_dot(x, f, prec)

    def left72(f, x, out=None):
        return lambda prec: rolling.left_dot(f, x, out, prec)

    # the 4y shard and the 2048² x-DST (the 2046-float inverse factor
    # stored padded, as the spectral pieces store it)
    nyl, n2 = N_2D // SHARDS, N_2D
    bt = rand72(nyl, n2)
    fxt = rand72(n2, n2)
    fy = spectral._tma_rows(rand72(n2 - 2, n2), "high")
    slab = rand72(n2, n2 // SHARDS)
    high_case("4y x-DST", (nyl, n2, n2, 1), right72(bt, fxt), (bt, fxt),
              ("sharded-2d-high",), "right_dot[3xtf32]", DOT2)
    high_case("4y y slab", (n2 - 2, n2 // SHARDS, n2, 1), left72(fy, slab),
              (fy, slab), ("sharded-2d-high",), "left_dot[3xtf32]", YS_2D)
    x2 = rand72(n2, n2)
    high_case("2048^2 x-DST", (n2, n2, n2, 1), right72(x2, fxt), (x2, fxt),
              ("2d-high",), "right_dot[3xtf32]", DOT2)
    # contract (b): a 512-row slice's x-DST (another tile) is those rows
    # of the 2048-row one
    whole = rolling.right_dot(x2, fxt, "high")
    part = rolling.right_dot(x2[nyl:2 * nyl], fxt, "high")
    sync()
    contract72 = {"(b) x-DST rows": torch.equal(part, whole[nyl:2 * nyl])}
    # contract (d): left_dot into a column slice (out=) is those columns
    # of the full product, at a 16-byte offset (TMA) and off it (4-byte
    # copies)
    full = rolling.left_dot(fy, x2, precision="high")
    for c0, w_ in ((512, 512), (130, 384)):
        o = torch.full_like(full, float("nan"))
        rolling.reset_launch_counts()
        rolling.left_dot(fy, x2[:, c0:c0 + w_], o[:, c0:c0 + w_], "high")
        sync()
        loads = ("cp.async" if rolling.left_dot.high_cp_async_launches
                 else "TMA")
        key = f"(d) left_dot out=[:, {c0}:{c0 + w_}] ({loads})"
        contract72[key] = torch.equal(o[:, c0:c0 + w_],
                                      full[:, c0:c0 + w_])
        del o
    del bt, fxt, fy, slab, x2, whole, part, full
    torch.cuda.empty_cache()
    # the (2, 2) shard (the 510-float inverse factor padded)
    n = N_BIG
    f512 = rand72(n, n)
    xb = rand72(n // 2 * n // 2, n)
    high_case("(2, 2) x-DST", (xb.shape[0], n, n, 1), right72(xb, f512),
              (xb, f512), ("sharded-zy-high",), "right_dot[3xtf32]",
              DOT_ZY)
    del xb
    fz = spectral._tma_rows(rand72(n - 2, n), "high")
    pencil = rand72(n, n // 2 * n // 2)
    high_case("(2, 2) z stage", (n - 2, pencil.shape[1], n, 1),
              left72(fz, pencil), (fz, pencil), ("sharded-zy-high",),
              "left_dot[3xtf32]", YZ_Z)
    del fz, pencil
    torch.cuda.empty_cache()
    # the 512³ planes (the uniform and the consistent step's), a 130-plane
    # block and 512×512×3: plane_dot's two launches
    x3 = rand72(n, n, n)
    fyl = rand72(n, n)
    nb = n // SHARDS + 2
    z0 = (SHARDS // 2) * (n // SHARDS) - 1
    pair_ms = {}
    for tag_, xs, paths_, rep_ in (
            ("512x512x3", x3[:3], ("nz3-high",), DOT),
            (f"{nb}-plane block", x3[z0:z0 + nb], ("sharded-high",),
             A5_CORR_SHARD),
            ("512^3", x3, ("3d-high", "cons3d-high"), DOT)):
        nz_ = xs.shape[0]
        x2d = xs.reshape(-1, n)
        t1 = rolling.right_dot(x2d, f512, "high").view(nz_, n, n)
        ms_r, lib1 = high_case(f"{tag_} x·right", (nz_ * n, n, n, 1),
                               right72(x2d, f512), (x2d, f512), paths_,
                               "plane_dot[3xtf32]", rep_)
        ms_l, lib2 = high_case(f"{tag_} left·t[k]", (n, n, n, nz_),
                               left72(fyl, t1), (fyl, t1), paths_,
                               "plane_dot[3xtf32]", rep_)
        pair_ms[tag_] = {"kernel": ms_r + ms_l, "matmul": [lib1, lib2]}
        del t1, x2d
        torch.cuda.empty_cache()
    # the plane_dot records keep the einsum as their library call and
    # carry the two per-launch torch.matmul figures beside it
    for key_, tag_ in ((("3d-high", "plane_dot[3xtf32]"), "512^3"),
                       (("cons3d-high", "plane_dot[3xtf32]"), "512^3"),
                       (("nz3-high", "plane_dot[3xtf32]"), "512x512x3")):
        if key_ in records:
            records[key_]["library_per_launch_ms"] = pair_ms[tag_]["matmul"]
    # contract (c): a 130-plane block's plane_dot is those planes of the
    # 512-plane one
    whole = rolling.plane_dot(x3, f512, fyl, "high")
    blk = rolling.plane_dot(x3[z0:z0 + nb], f512, fyl, "high")
    sync()
    contract72["(c) plane_dot block"] = torch.equal(blk,
                                                    whole[z0:z0 + nb])
    del whole, blk, x3, f512, fyl
    torch.cuda.empty_cache()
    # the small shapes the script runs: 37x23x11's products (rows of 37
    # floats: the 4-byte copies), 128x32 and the 128² cavity's x-DST, and
    # the depths 2046 and 510 through factors stored padded (TMA) and
    # packed (the 4-byte copies), which give the same bits
    xo = rand72(11, 23, 37)
    ro, lo = rand72(37, 37), rand72(23, 23)
    xo2 = xo.view(-1, 37)
    high_case("37x23x11 x·right", (253, 37, 37, 1), right72(xo2, ro),
              (xo2, ro), loads="cp.async")
    high_case("37x23x11 left·x[k]", (23, 37, 23, 11), left72(lo, xo),
              (lo, xo), loads="cp.async")
    for rows_ in (32, 128):
        xs_, rs_ = rand72(rows_, 128), rand72(128, 128)
        high_case(f"128x{rows_} x-DST", (rows_, 128, 128, 1),
                  right72(xs_, rs_), (xs_, rs_),
                  ("ghia-high",) if rows_ == 128 else (),
                  "right_dot[3xtf32]", DOT2)
    for k_, m_, n_ in ((2046, 2048, 512), (510, 512, 4096)):
        lp = spectral._tma_rows(rand72(m_, k_), "high")
        lc = lp.contiguous()
        xk = rand72(k_, n_)
        high_case(f"K={k_} padded", (m_, n_, k_, 1), left72(lp, xk),
                  (lc, xk))
        high_case(f"K={k_} packed", (m_, n_, k_, 1), left72(lc, xk),
                  (lc, xk), loads="cp.async")
        a_ = rolling.left_dot(lp, xk, precision="high")
        b_ = rolling.left_dot(lc, xk, precision="high")
        sync()
        contract72[f"(e) K={k_} TMA == 4-byte copies"] = torch.equal(a_, b_)
        del lp, lc, xk, a_, b_
    for key_, ok_ in contract72.items():
        print(f"phase 72 contract {key_}: bit for bit {ok_}", flush=True)
    if not all(contract72.values()):
        fail("phase 72: the 3xTF32 GEMM's sum-order contract does not hold "
             f"{contract72}")
    for tag_, pm in pair_ms.items():
        print(f"phase 72 {tag_} plane_dot at HIGH: {pm['kernel']:.4f} ms "
              f"a transform (two launches), torch.matmul "
              f"{sum(pm['matmul']):.4f}", flush=True)
    print(f"phase 72 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # a phase-71 or phase-72 record takes its wrapper's launches on its
    # main path
    for path_, name_, counted_ in sgemm_alias + high_alias:
        launch_counts[path_][name_] = launch_counts[path_][counted_]

    kernels = []
    for (path, name), rec in records.items():
        launches = launch_counts.get(path, {}).get(name)
        if launches is None:
            fail(f"{name}: no main path of {path} counted its launches")
        kernels.append({
            "name": name, "path": path, "route": "cuda",
            "source": rec["source"], "replaces": rec["replaces"],
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "max_rel_err": rec["max_rel_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        if "library_per_launch_ms" in rec:
            # (plane_dot: one torch.matmul of each of its two launches)
            kernels[-1]["library_per_launch_ms"] = \
                rec["library_per_launch_ms"]
        if "chain_ms" in rec:
            # (the y-line kernel: its dependent chain's floor, which bounds
            # it where the bytes do not)
            kernels[-1]["chain_ms"] = rec["chain_ms"]
        if "barrier_ms" in rec:
            # (the whole Krylov solves: iterations x barriers an iteration
            # x the probe's barrier latency, a floor beside bound_ms)
            kernels[-1]["barrier_ms"] = rec["barrier_ms"]
    print(json.dumps({"kernels": kernels, "step_ms": ms3,
                      "grid": f"{N_BIG}x{N_BIG}x{N_BIG}", "step_ms_2d": ms2,
                      "grid_2d": f"{n2}x{n2}", "explicit_step_ms":
                      explicit_ms, "cg_512": cg512, "cg_step_ms_256": cg_ms,
                      "facade_projection_ms": wall_cg / FACADE_STEPS,
                      "multigrid_513": mg513, "mg_cg_513": mgcg_rec,
                      "mg_step_ms_257": dict(mg_ms, tolerance=MG_STEP_TOL,
                                            floor=mg_floor), "mg2d_129": mg2d,
                      "facade_multigrid_ms": wall_mg / MG_FACADE_STEPS,
                      "facade_multigrid_floor": facade_floor,
                      "poisson_iters_100": poisson_iters,
                      "bicgstab_512": bicg512, "rbsor_512": sor512,
                      "bicgstab_step_ms_128": bicg_step_ms,
                      "rbsor_step_128": sor_step_rec,
                      "jacobi_step_33": jac_step_rec,
                      "stationary_cavities_128": cavities,
                      "step_ms_high": ms3h, "step_ms_2d_high": ms2h,
                      "step_ms_nz3": ms_nz3, "step_ms_nz3_high": ms_nz3h,
                      "grid_nz3": tag3, "gemm_vs_float64": gemm_truth,
                      "ghia_128_high_rms": rms_high,
                      "fft_direct_512": fft_rec, "sor_33": sor_rec,
                      "bc_refresh_ms": bc_ms, "buoyant_step_ms_512": ms_b,
                      "energy_post_step_ms_512": ms_post, "dvd_128": dvd,
                      "consistent_step_ms_512": ms_c,
                      "consistent_step_ms_512_high": ms_ch,
                      "consistent_residual_512": res_c,
                      "consistent_krylov_128": krylov_rec,
                      "consistent_step_ms_2d_2048": ms_c2,
                      "poiseuille_stretched": poiseuille,
                      "step_ms_default": ms3d, "step_ms_2d_default": ms2d,
                      "default_vs_highest": vs_high,
                      "differentiable": hybrid_rec,
                      "sharded_step_512": sharded_rec,
                      "float64_on_cuda": f64_rec,
                      "nccl_one_rank_max_abs_diff": nccl_diff,
                      "cg_512_sharded": cg512_sharded,
                      "cg_step_sharded_512": cg_step_sharded,
                      "bicgstab_step_sharded_128": bicg_step_sharded,
                      "zy_step_512": zy_rec, "cg_512_zy": cg512_zy,
                      "cg_step_zy_512": cg_step_zy,
                      "explicit_sharded": explicit_sharded,
                      "facade_mesh_max_abs_diff": facade_mesh,
                      "nccl_one_rank_euler_max_abs_diff": nccl_euler_diff,
                      "step_2d_4y_2048": rec_2d,
                      "bicgstab_step_zy_128": bicg_zy,
                      "facade_2d_4y_max_abs_diff": facade_2d,
                      "multigrid_513_sharded": mg513_sharded,
                      "mg_step_sharded_257": mg_step_sharded,
                      "buoyant_sharded": buoy_sharded,
                      "dvd_128_4y_chunk": dvd_4y,
                      "consistent_sharded_512": cons_rec,
                      "default_sharded": def_rec,
                      "rescue": rescue_rec, "tdma_y2d": y2d_rec,
                      "cluster_solves": cluster_solves,
                      "barrier_ns": {f"{k[0]} {k[1]}x{k[2]}": v
                                     for k, v in barrier_ns.items()},
                      "tf32_plans": tf32_plans, "tf32_depths": tf32_depths,
                      "tf32_contract": contract,
                      "sgemm_shapes": sgemm_rec,
                      "sgemm_contract": contract71,
                      "high_shapes": high_rec,
                      "high_contract": contract72,
                      "launch_counts": launch_counts,
                      "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
