// The y-line Thomas solve of the 2D spectral projection step on Hopper
// (sm_90a): both sweeps in one launch.
//
// It replaces make_tdma_y_2d (cfd_tpu/ops/pallas/tdma.py:434, its kernel
// :468-507, the pallas_call :509), which solves, after the forward x-DST,
// one tridiagonal system per x-mode column m along y:
//
//     (mu_m + 2w) x_j - w (x_{j-1} + x_{j+1}) = r_j,   j = 1..ny-2,
//     x_0 = x_{ny-1} = 0,   w = 1/dy^2,
//
// in the reference's operation order: from zero carries
//     rec = 1/((mu + 2w) - w t),  t = w rec,  d' = (r + w d') rec
// for j = 1..ny-2, then x = d' + t x for j = ny-2..1, with mirror
// y-shells x[0] = x[1], x[ny-1] = x[ny-2].  Every column is solved,
// the spare and the rescued ones too (the rescue overwrites x[:, :K]).
// Built with -fmad=false, so each multiply and add rounds on its own and
// the result is tdma_y_2d_reference's bit for bit.
//
// t and rec do not depend on the data (they are functions of mu and w),
// so they come from two (ny, nx) planes that the step's pieces build once
// by the same recurrence (tdma.tdma_y2d_planes, bit-equal to the sweep's
// values): the kernel reads r and rec going down and t going up, and a
// forward row's chain is d' alone, with no divide.
//
// What bounds it on an H100.  The bytes are few (the function reads r
// and writes x, 33.5 MB at 2048^2: 0.010 ms at 3.35 TB/s; the planes add
// two fields read, 0.020 ms in all); the time is the dependent chain of
// a column, 2046 rows long at 2048^2.  A forward row waits on the
// previous d' through a multiply, an add and a multiply (~12 SM cycles;
// ~80 where it computes rec, through an IEEE divide), a backward row on
// the previous x through a multiply and an add (~8).  No reordering helps
// without changing the rounding, so the floor is (ny - 2) x (forward +
// backward cycles a row) at the SM clock; tdma_chain_probe_kernel
// measures those cycles.  The 3D z-line kernels on one-row planes (how
// the port first ran this solve) gave 2048 threads on 8 SMs a load in
// every row's chain, 0.4 us a row.
//
// The design.  One CTA of kCols threads (one warp) owns kCols
// neighbouring columns (a 64- or 128-byte row segment, one coalesced
// access a row); each thread marches its column down and back up.
// Nothing a row waits for comes from device memory: the rows a sweep
// reads (r and rec going down; t, and d' where it is parked in x, going
// up) are copied kStages stages of kStageRows rows ahead into a ring in
// shared memory by cp.async, a stage is read into registers before its
// rows are computed, and a stage's compute refills the slot it has just
// read, one copy beside a row's arithmetic, so the copies fill the
// chain's latency instead of adding to it.  Nothing between the rows of a
// stage branches: a branch cuts the unrolled rows into blocks the
// compiler cannot interleave, so copies past nx are predicated by their
// size and lanes past nx solve the last column again rather than skip
// their stores.  kVec (nx a multiple of 4, 16-byte aligned rows): 16-byte
// copies, kCols / 4 lanes a row and 4 rows an instruction, the lanes
// meeting at __syncwarp before they read; else 4-byte copies, each lane
// its own column, any nx.  d' lives in shared memory (kSmemD: ny-2 rows
// of 16 columns, 128 KB at ny = 2048).  A column too tall for shared
// memory takes the kSmemD = false instantiation of the same kernel: d'
// parked in x, as the TPU kernel parks it in its output, and read back
// through the ring beside t (the back substitution reads a row of x
// before it overwrites it).  The plan in ops/kernels/tdma.py picks the
// variant, the column count and the copy width.
//
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "async_copy.cuh"

namespace {

constexpr int kStageRows = 32;  // rows a ring stage
constexpr int kStages = 8;      // stages a ring: kStages - 1 in flight
constexpr int kRingRows = kStageRows * kStages;
constexpr int kSmemCols = 16;    // columns a CTA with d' in shared memory
constexpr int kGlobalCols = 32;  // columns a CTA with d' parked in x
constexpr int kMaxSmem = 232448;  // a CTA's shared memory on sm_90

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// the lanes of a CTA of kCols threads (one warp)
template <int kCols>
constexpr unsigned kWarpOf = kCols == 32 ? 0xffffffffu : (1u << kCols) - 1u;

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// One field's copies, this lane's share: each stage's slot holds
// kStageRows rows of kCols floats; a copy instruction moves kRows rows,
// this lane's piece of them its row g (4-byte copies: its own column of
// one row; 16-byte copies: 4 columns of one of 4 rows).
template <int kCols, bool kVec>
struct Copies {
  static constexpr int kRows = kVec ? 4 : 1;
  static constexpr int kPieces = kStageRows / kRows;  // a stage
  uint32_t dst;      // this lane's piece of slot 0
  const float* src;  // this lane's piece of stage 0
  long long step;    // floats from one streamed row to the next (+-ld)
  int g;             // the lane's row within a copy
  int bytes;         // what a piece reads: 0 where its columns pass nx

  // `first`: the CTA's column 0 of stage 0's first row; `ring`: the
  // shared address of the ring's slot 0; `lc`: the lane's column (a lane
  // past nx takes the last one); `live`: nx less the CTA's first column.
  // A 16-byte piece past nx reads nothing (and points at column 0): the
  // copies are predicated by their size, not by a branch, which would
  // cut the unrolled rows they sit between.
  __device__ __forceinline__ Copies(uint32_t ring, const float* first,
                                    long long row_step, int lane, int lc,
                                    int live) {
    g = kVec ? lane / (kCols / 4) : 0;
    const int c = kVec ? 4 * (lane % (kCols / 4)) : lane;  // in the slot
    const bool ok = !kVec || c < live;
    dst = ring + 4u * static_cast<uint32_t>(g * kCols + c);
    src = first + g * row_step + (kVec ? (ok ? c : 0) : lc);
    step = row_step;
    bytes = ok ? (kVec ? 16 : 4) : 0;
  }

  // piece p of stage s (into slot s % kStages)
  __device__ __forceinline__ void piece(int s, int p) const {
    const uint32_t d = dst + 4u * static_cast<uint32_t>(
                                     (s % kStages) * kStageRows * kCols +
                                     p * kRows * kCols);
    const float* a =
        src + (static_cast<long long>(s) * kStageRows + p * kRows) * step;
    if (kVec)
      cp_async16(d, a, bytes);
    else
      cp_async4(d, a, bytes);
  }

  // the whole of stage s, of `rows` rows
  __device__ __forceinline__ void stage(int s, int rows) const {
    for (int p = 0; p < kPieces; ++p)
      if (p * kRows + g < rows) piece(s, p);
  }

  // beside row u of a full stage's compute: its share of the refill of
  // stage s
  __device__ __forceinline__ void refill(int s, int u) const {
    if (u % kRows == 0) piece(s, u / kRows);
  }
};

// one ring stage of the forward sweep: interior rows q0 .. q0 + rows - 1
// (row j = q + 1), r from slot ra and rec from slot rb; kFull: rows ==
// kStageRows, unrolled without checks; kRefill: refill the slots with
// stage s_next as the rows go.  The stage's rows are read into registers
// first.
template <int kCols, bool kSmemD, bool kVec, bool kFull, bool kRefill>
__device__ __forceinline__ void fwd_stage(
    const float* ra, const float* rb, const Copies<kCols, kVec>& fa,
    const Copies<kCols, kVec>& fb, int s_next, float* dsm, float* dpark,
    long long ld, float w, int q0, int rows, float& dc) {
  float rv[kStageRows], cv[kStageRows];
#pragma unroll
  for (int u = 0; u < kStageRows; ++u) {
    if (!kFull && u >= rows) break;
    rv[u] = ra[u * kCols];
    cv[u] = rb[u * kCols];
  }
  if (kVec && kRefill) __syncwarp(kWarpOf<kCols>);  // the slot is read
#pragma unroll
  for (int u = 0; u < kStageRows; ++u) {
    if (!kFull && u >= rows) break;
    const int q = q0 + u;
    dc = (rv[u] + w * dc) * cv[u];
    if (kSmemD)
      dsm[q * kCols] = dc;
    else
      dpark[(q + 1) * ld] = dc;
    if (kRefill) {
      fa.refill(s_next, u);
      fb.refill(s_next, u);
    }
  }
}

// one ring stage of the back substitution: rows j = top-q0-u, u < rows
// (top = ny-2), its d' and t read into registers first; ``first`` takes
// the stage's first x; kRefill as in fwd_stage
template <int kCols, bool kSmemD, bool kVec, bool kFull, bool kRefill>
__device__ __forceinline__ void bwd_stage(
    const float* rt, const float* rd, const Copies<kCols, kVec>& ft,
    const Copies<kCols, kVec>& fd, int s_next, const float* dsm,
    float* xcol, long long ld, int top, int q0, int rows,
    float& xc, float& first) {
  float dv[kStageRows], tv[kStageRows];
#pragma unroll
  for (int u = 0; u < kStageRows; ++u) {
    if (!kFull && u >= rows) break;
    dv[u] = kSmemD ? dsm[(top - q0 - u - 1) * kCols] : rd[u * kCols];
    tv[u] = rt[u * kCols];
  }
  if (kVec && kRefill) __syncwarp(kWarpOf<kCols>);
#pragma unroll
  for (int u = 0; u < kStageRows; ++u) {
    if (!kFull && u >= rows) break;
    xc = dv[u] + tv[u] * xc;
    xcol[(top - q0 - u) * ld] = xc;
    if (u == 0) first = xc;
    if (kRefill) {
      ft.refill(s_next, u);
      if (!kSmemD) fd.refill(s_next, u);
    }
  }
}

// r, x, and the planes recp and tp: (ny, nx) row-major.  Lanes past nx
// (in the last CTA) take part in the copies and the warp's barriers and
// solve the last column again, storing what its own lane stores: no
// store needs a guard, which would be a branch between rows.
template <int kCols, bool kSmemD, bool kVec>
__global__ void __launch_bounds__(kCols) tdma_y2d_kernel(
    const float* __restrict__ r, float w, const float* __restrict__ recp,
    const float* __restrict__ tp, float* __restrict__ x, int ny, int nx) {
  using C = Copies<kCols, kVec>;
  extern __shared__ __align__(16) float smem[];
  constexpr int kRing = kRingRows * kCols;  // floats a ring
  constexpr int kSlot = kStageRows * kCols;
  constexpr unsigned kWarp = kWarpOf<kCols>;
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kCols;
  const int lc = min(lane, nx - 1 - c0);  // this lane's column in the CTA
  const int col = c0 + lc;
  // two rings (r or t in ring 0; rec or parked d' in ring 1), then d'
  // (16-byte copies fill a row's columns across the lanes; 4-byte ones
  // each lane's own entry)
  const float* ring0 = smem + (kVec ? lc : lane);
  const float* ring1 = ring0 + kRing;
  float* dsm = smem + 2 * kRing + lane;
  const uint32_t sh0 = smem_u32(smem), sh1 = sh0 + 4u * kRing;
  const long long ld = nx;
  const int m = ny - 2;  // interior rows 1..ny-2, q = j - 1
  const int n_st = (m + kStageRows - 1) / kStageRows;
  const int n_full = m / kStageRows;  // stages of kStageRows rows
  float* xcol = x + col;  // where d' is parked when !kSmemD
  auto landed = [&]() {  // stage s of the ring, with kStages - 1 after it
    cp_async_wait<kStages - 1>();
    if (kVec) __syncwarp(kWarp);  // the other lanes' copies too
  };

  // ---- forward sweep, rows 1..ny-2 -----------------------------------------
  float dc = 0.0f;
  const C fa(sh0, r + ld + c0, ld, lane, lc, nx - c0);
  const C fb(sh1, recp + ld + c0, ld, lane, lc, nx - c0);
  for (int s = 0; s < kStages; ++s) {
    if (s < n_st) {
      fa.stage(s, min(kStageRows, m - s * kStageRows));
      fb.stage(s, min(kStageRows, m - s * kStageRows));
    }
    cp_async_commit();
  }
  for (int s = 0; s < n_st; ++s) {
    landed();
    const int q0 = s * kStageRows;
    const int rows = min(kStageRows, m - q0);
    const float* ra = ring0 + (s % kStages) * kSlot;
    const float* rb = ring1 + (s % kStages) * kSlot;
    const int sn = s + kStages;
    if (sn < n_full) {
      fwd_stage<kCols, kSmemD, kVec, true, true>(
          ra, rb, fa, fb, sn, dsm, xcol, ld, w, q0, rows, dc);
    } else {
      if (rows == kStageRows)
        fwd_stage<kCols, kSmemD, kVec, true, false>(
            ra, rb, fa, fb, sn, dsm, xcol, ld, w, q0, rows, dc);
      else
        fwd_stage<kCols, kSmemD, kVec, false, false>(
            ra, rb, fa, fb, sn, dsm, xcol, ld, w, q0, rows, dc);
      if (sn < n_st) {  // a partial stage
        if (kVec) __syncwarp(kWarp);  // every lane has read the slot
        fa.stage(sn, m - sn * kStageRows);
        fb.stage(sn, m - sn * kStageRows);
      }
    }
    cp_async_commit();
  }
  // the parked rows are read back by the copies below, 16-byte ones of
  // other lanes' columns too
  asm volatile("cp.async.wait_all;" ::: "memory");
  __threadfence_block();
  __syncwarp(kWarp);

  // ---- back substitution, rows ny-2..1, mirror shells ------------------------
  const C ft(sh0, tp + m * ld + c0, -ld, lane, lc, nx - c0);
  const C fd(sh1, x + m * ld + c0, -ld, lane, lc, nx - c0);
  for (int s = 0; s < kStages; ++s) {
    if (s < n_st) {
      ft.stage(s, min(kStageRows, m - s * kStageRows));
      if (!kSmemD) fd.stage(s, min(kStageRows, m - s * kStageRows));
    }
    cp_async_commit();
  }
  float xc = 0.0f, xtop = 0.0f, first = 0.0f;
  for (int s = 0; s < n_st; ++s) {
    landed();
    const int q0 = s * kStageRows;
    const int rows = min(kStageRows, m - q0);
    const float* rt = ring0 + (s % kStages) * kSlot;
    const float* rd = ring1 + (s % kStages) * kSlot;
    const int sn = s + kStages;
    if (sn < n_full) {
      bwd_stage<kCols, kSmemD, kVec, true, true>(rt, rd, ft, fd, sn, dsm,
                                                 xcol, ld, m, q0,
                                                 rows, xc, first);
    } else {
      if (rows == kStageRows)
        bwd_stage<kCols, kSmemD, kVec, true, false>(rt, rd, ft, fd, sn, dsm,
                                                    xcol, ld, m, q0,
                                                    rows, xc, first);
      else
        bwd_stage<kCols, kSmemD, kVec, false, false>(
            rt, rd, ft, fd, sn, dsm, xcol, ld, m, q0, rows, xc,
            first);
      if (sn < n_st) {
        if (kVec) __syncwarp(kWarp);
        ft.stage(sn, m - sn * kStageRows);
        if (!kSmemD) fd.stage(sn, m - sn * kStageRows);
      }
    }
    if (s == 0) xtop = first;  // x[ny-2]
    cp_async_commit();
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  xcol[(m + 1) * ld] = xtop;  // x[ny-1] = x[ny-2]
  xcol[0] = xc;               // x[0] = x[1]
}

// The dependent-cycle probe behind the kernel's chain floor: one thread
// runs `rows` steps of each sweep's recurrence on registers and writes
// the SM cycles (clock64) of each run: out[3] the kernel's forward row
// (rec from its plane: d' = (r + w d') rec alone), out[1] the back
// substitution's x = d' + t x, out[0] the forward rec -> t -> d' chain
// (what the planes take off a row), and out[2] the first run's
// nanoseconds (%globaltimer), whose ratio to out[0] is the SM clock it
// ran at.
__global__ void tdma_chain_probe_kernel(const float* __restrict__ mu,
                                        float w, int rows,
                                        long long* __restrict__ out,
                                        float* __restrict__ sink) {
  const float b = mu[0] + 2.0f * w;
  const float rv = mu[1];
  float tc = 0.0f, dc = 0.0f, xc = 0.0f, pc = 0.0f;
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  for (int j = 0; j < rows; ++j) {
    const float rec = 1.0f / (b - w * tc);
    tc = w * rec;
    dc = (rv + w * dc) * rec;
  }
  asm volatile("" ::"f"(tc), "f"(dc));
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  for (int j = 0; j < rows; ++j) xc = dc + tc * xc;
  asm volatile("" ::"f"(xc));
  const long long c2 = clock64();
  for (int j = 0; j < rows; ++j) pc = (rv + w * pc) * tc;
  asm volatile("" ::"f"(pc));
  const long long c3 = clock64();
  out[0] = c1 - c0;
  out[1] = c2 - c1;
  out[2] = static_cast<long long>(g1 - g0);
  out[3] = c3 - c2;
  sink[0] = xc + pc;
}

// ---- host side -------------------------------------------------------------

template <int kCols, bool kSmemD, bool kVec>
int set_smem(int dev) {
  static std::mutex mu;
  static bool done[64] = {};
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev]) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      tdma_y2d_kernel<kCols, kSmemD, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  done[dev] = true;
  return 0;
}

// shared memory of a launch: the two rings, and d' where it lives there
long long y2d_smem(int ny, bool smem_d) {
  const int cols = smem_d ? kSmemCols : kGlobalCols;
  return (2LL * kRingRows + (smem_d ? ny - 2 : 0)) * cols * 4;
}

struct Args {
  const float *r, *rec, *t;
  float w, *x;
  int ny, nx;
};

template <int kCols, bool kSmemD, bool kVec>
int launch_y2d(const Args& a, cudaStream_t stream) {
  const long long smem = y2d_smem(a.ny, kSmemD);
  if (a.ny < 3 || a.nx < 1 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = set_smem<kCols, kSmemD, kVec>(dev);
  if (rc != 0) return rc;
  tdma_y2d_kernel<kCols, kSmemD, kVec>
      <<<(a.nx + kCols - 1) / kCols, kCols, static_cast<size_t>(smem),
         stream>>>(a.r, a.w, a.rec, a.t, a.x, a.ny, a.nx);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSmemD>
int launch_copies(const Args& a, bool vec, cudaStream_t stream) {
  constexpr int kCols = kSmemD ? kSmemCols : kGlobalCols;
  return vec ? launch_y2d<kCols, kSmemD, true>(a, stream)
             : launch_y2d<kCols, kSmemD, false>(a, stream);
}

}  // namespace

extern "C" {

// Both sweeps of the (ny, nx) zero-shell rhs r into x (mirror y-shells),
// w = 1/dy^2, rec and t the (ny, nx) planes of tdma_y2d_planes.  smem_d:
// d' in shared memory (16 columns a CTA) or parked in x (32 columns a
// CTA).  vec: 16-byte copies (nx a multiple of 4, every array 16-byte
// aligned), else 4-byte ones.
int cfd_tdma_y2d(const float* r, float w, const float* rec, const float* t,
                 float* x, int ny, int nx, int smem_d, int vec,
                 cudaStream_t stream) {
  if (!r || !rec || !t || !x)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (nx % 4 != 0 || !aligned16(r) || !aligned16(x) ||
              !aligned16(rec) || !aligned16(t)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, rec, t, w, x, ny, nx};
  return smem_d ? launch_copies<true>(a, vec, stream)
                : launch_copies<false>(a, vec, stream);
}

// The chain probe: out[0], out[1], out[3] the SM cycles of `rows`
// forward, backward and plane-fed forward rows, out[2] the forward run's
// nanoseconds; mu[0], mu[1] a column's mu and a stand-in r.
int cfd_tdma_y2d_chain(const float* mu, float w, int rows, long long* out,
                       float* sink, cudaStream_t stream) {
  tdma_chain_probe_kernel<<<1, 1, 0, stream>>>(mu, w, rows, out, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
