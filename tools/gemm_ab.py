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
needs a CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi unavailable"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


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
    sleep_rate = []

    def device_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if not sleep_rate:
            torch.cuda._sleep(10 ** 6)
            start.record()
            torch.cuda._sleep(10 ** 7)
            end.record()
            torch.cuda.synchronize()
            sleep_rate.append(10 ** 7 / start.elapsed_time(end))
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        lead_ms = 2.0 * (time.perf_counter() - t) * 1e3 + 1.0
        torch.cuda.synchronize()
        for _ in range(4):
            torch.cuda._sleep(int(lead_ms * sleep_rate[0]))
            start.record()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            end.record()
            queued_ms = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            if queued_ms < lead_ms:
                return start.elapsed_time(end) / reps
            lead_ms *= 4.0
        raise SystemExit("gemm_ab: the host did not keep ahead")

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
    return {"root": root, "card": _card(),
            "device": torch.cuda.get_device_name(0), "build_s": build_s,
            "shapes": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one is not None:
        print(json.dumps(run_root(a.one, a.check)), flush=True)
        return 0
    rc = 0
    for root in a.root:
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root,
               "--one", root] + (["--check"] if a.check else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stderr.write(proc.stderr)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
            else json.dumps({"root": root, "rc": proc.returncode})
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as fh:
                fh.write(line + "\n")
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
