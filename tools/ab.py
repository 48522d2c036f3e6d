"""The harness the A/B tools share (``tools/gemm_ab.py``,
``tools/tdma_ab.py``, ``tools/solve_ab.py``): one process a checkout, a
device timer, and the card's name read by ``nvidia-smi``.

A tool defines ``run_root(root, check) -> dict``, which imports the
checkout ``root``'s ``cfd_tpu_torch`` (``sys.path`` first) and measures
it, and calls :func:`main` with it.  ``--root`` may be given several
times; each root runs in a process of its own, in the order given, so
parent, change, change, parent compares two versions on one card.  One
JSON line a root goes to the standard output (``--out`` appends them to
a file too).  Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query>`` of card 0, or a note that it
    gave nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi unavailable"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def device_timer(reps: int, tool: str):
    """``device_ms(fn)``: the device ms of one call of ``fn``, from CUDA
    events around ``reps`` calls queued behind a device-side sleep long
    enough that the host's calls never hold the card back (the sleep
    grows until the host keeps ahead of it)."""
    import torch

    sleep_rate = []   # torch.cuda._sleep cycles a ms, measured once

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
        raise SystemExit(f"{tool}: the host did not keep ahead")

    return device_ms


def main(doc: str, script: str, run_root) -> int:
    """The command line of a tool whose file is ``script``: every
    ``--root`` through ``run_root`` in a process of its own."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
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
        cmd = [sys.executable, script, "--root", root, "--one", root] + (
            ["--check"] if a.check else [])
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
