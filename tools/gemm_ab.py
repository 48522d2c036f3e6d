"""Time the 3xTF32 GEMM of one or more checkouts of this repository on
the card, in turns, at the launch shapes of the HIGH main paths.

    python3 tools/gemm_ab.py --root OLD --root . --root . --root OLD \\
        [--check] [--out FILE]

Each ``--root`` is a checkout (a parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists will do); every root
runs in a process of its own, which imports that checkout's
``cfd_tpu_torch`` and builds its kernels there, and the roots run in the
order given, so parent, change, change, parent compares two versions on
one card.  Each shape is one launch of the 3xTF32 GEMM through the public
wrappers (``rolling.right_dot`` / ``left_dot`` at "high"), its
operands made on the card from a seed, factors whose rows are off 16
bytes stored as the checkout's spectral pieces store them
(``spectral._tma_rows``).  A launch's device ms come from CUDA events
around five launches queued behind a device-side sleep; beside it one
``torch.matmul`` with TF32 off of the same product and the SGEMM's
launch ("highest").  ``--check`` also
holds each launch against the plain version (max error over max|plain|)
and two launches bit for bit.  One JSON line a root, with the card's name
and power limit (``nvidia-smi``); ``--out`` appends them to a file.  It
needs a CUDA device and imports nothing of JAX; the process a root, the
timer and the command line are ``tools/ab.py``'s.
"""

from __future__ import annotations

import os
import sys
import time

import ab

# (tag, kind, M, N, K, batch): "right" is x (M x K) . f (K x N); "left" is
# f (M x K) . x (K x N) per batch; a factor of M or K rows off 16 bytes is
# stored as the spectral pieces store it
SHAPES = (
    ("4y x-DST", "right", 512, 2048, 2048, 1),
    ("4y y slab", "left", 2046, 512, 2048, 1),
    ("2048^2 x-DST", "right", 2048, 2048, 2048, 1),
    ("(2, 2) x-DST", "right", 65536, 512, 512, 1),
    ("(2, 2) z stage", "left", 510, 65536, 512, 1),
    ("130-plane x.right", "right", 130 * 512, 512, 512, 1),
    ("130-plane left.t[k]", "left", 512, 512, 512, 130),
    ("512^3 x.right", "right", 512 * 512, 512, 512, 1),
    ("512^3 left.t[k]", "left", 512, 512, 512, 512),
    ("512x512x3 x.right", "right", 3 * 512, 512, 512, 1),
    ("512x512x3 left.t[k]", "left", 512, 512, 512, 3),
    ("128^2 x-DST", "right", 128, 128, 128, 1),
)


def run_root(root: str, check: bool, reps: int = 5) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from cfd_tpu_torch.ops.kernels import native, rolling
    from cfd_tpu_torch.solvers.poisson import spectral

    if not torch.cuda.is_available():
        raise SystemExit("gemm_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(72)
    device_ms = ab.device_timer(reps, "gemm_ab")

    rows = {}
    for tag, kind, m, n, k, b in SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        if kind == "right":
            x, f = rnd(m, k), rnd(k, n)

            def kernel(prec="high"):
                return rolling.right_dot(x, f, prec)

            def plain():
                return rolling.right_dot_plain(x, f, "high")

            def lib():
                return torch.matmul(x, f)
        else:
            f = spectral._tma_rows(rnd(m, k), "high")
            x = rnd(b, k, n) if b > 1 else rnd(k, n)

            def kernel(prec="high"):
                return rolling.left_dot(f, x, precision=prec)

            def plain():
                return rolling.left_dot_plain(f, x, precision="high")

            def lib():
                return torch.matmul(f, x)
        row = {"M": m, "N": n, "K": k, "batch": b,
               "ms": device_ms(kernel), "matmul_ms": device_ms(lib),
               "sgemm_ms": device_ms(lambda: kernel("highest"))}
        if check:
            got, again, ref = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            row["max_rel_err"] = float((got - ref).abs().max()
                                       / ref.abs().max())
            row["repeat_bit_identical"] = bool(torch.equal(got, again))
            del got, again, ref
        rows[tag] = row
        print(f"  {root} {tag}: {row}", file=sys.stderr, flush=True)
        del x, f
        torch.cuda.empty_cache()
    return {"root": root, "card": ab.smi("name,power.limit"),
            "device": torch.cuda.get_device_name(0), "build_s": build_s,
            "shapes": rows}


if __name__ == "__main__":
    sys.exit(ab.main(__doc__, os.path.abspath(__file__), run_root))
