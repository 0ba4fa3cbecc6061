#!/usr/bin/env python3
"""Time the recurrence kernels on one NVIDIA GPU over their launch plans.

    python3 scripts/rec_kernel_sweep.py [--seed 0] [--reps 20]
                                        [--tree DIR] [--baseline DIR]

Builds ``csrc/wkv6.cu`` and ``csrc/mamba_scan.cu`` of the checkout at
``--tree`` (this one by default), prints each kernel instance's registers
and spills from the ``nvcc -Xptxas -v`` log, then times each kernel at
the shapes of the serving paths in ``chip_smoke.py`` (``wkv6``:
RWKV6-3B, ``[1, 2048, 40, 64]`` prefill and ``B = 8, T = 1`` decode;
``mamba_scan``: Jamba, ``u [1, 2048, 8192]`` with ``n = 16`` and the
``B = 8, T = 1`` decode) on random inputs made from ``--seed``, over the
plan variants listed in ``VARIANTS`` (the module constants of each
wrapper that its launch plan reads; a checkout whose wrappers have no
launch plan runs its one launch). Each variant is held against the plain
version with ``chip_smoke.rec_err`` before it is timed: the median of
``--reps`` launches, each after a 256 MB write that empties the L2
(cold), and back to back (warm).

With ``--baseline DIR`` (another checkout, say the parent commit unpacked
with ``git archive``) the script runs itself on the baseline, this tree,
this tree and the baseline again, one process each, so that both are
timed in turns on the same card. One JSON object per line, each naming
its tree; the card's ``nvidia-smi`` name and power limit first. Exits 2
without a GPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# (wrapper constant -> value) overrides; the first of each is the default
VARIANTS = {
    "wkv6": [{}, {"MAX_CHUNK": 16}],
    "mamba_scan": [{}, {"MAX_CHUNK": 16}],
}


def sweep(tree: Path, seed: int, reps: int) -> int:
    import torch
    sys.path[:0] = [str(ROOT), str(tree / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import mamba_scan as sk
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.kernels.wkv6 import wkv6 as wk
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("wkv6", "mamba_scan")
    secs = _build.build_all(names)
    cs.emit({"tree": str(tree), "build_seconds": secs,
             "ptxas": {n: cs.ptxas_usage(_build.build_log(n))
                       for n in names}})
    hbm = cs.hbm_bytes_per_s(torch.cuda.get_device_name(0))
    rng = np.random.default_rng(seed)
    cases = {
        "wkv6": (wk, wkv6_ref, cs.wkv6_work, {
            "admit": cs.wkv6_inputs(torch, rng, 1, 2048, 40, 64, 64,
                                    "model"),
            "decode": cs.wkv6_inputs(torch, rng, 8, 1, 40, 64, 64,
                                     "model")}),
        "mamba_scan": (sk, mamba_scan_ref, cs.mamba_work, {
            "admit": cs.mamba_inputs(torch, rng, 1, 2048, 8192, 16),
            "decode": cs.mamba_inputs(torch, rng, 8, 1, 8192, 16)}),
    }
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda").zero_
    failed = False
    for name, (mod, plain, work, shapes) in cases.items():
        kern = getattr(mod, f"{name}_cuda")
        planned = hasattr(mod, "launch_plan")
        for shape, ins in shapes.items():
            want = plain(*ins)
            b_, f_, e_ = work(*ins)
            bound = max(b_ / hbm, f_ / cs.FP32_PEAK, e_ / cs.SFU_RATE) * 1e3
            for over in VARIANTS[name] if planned else [{}]:
                saved = {k: getattr(mod, k) for k in over}
                for k, val in over.items():
                    setattr(mod, k, val)
                if planned:
                    mod._plan.cache_clear()
                line = {"tree": str(tree), "kernel": name, "shape": shape,
                        "variant": over or "default", "bound_ms": bound}
                try:
                    if planned:
                        line["plan"] = mod.launch_plan(*ins)
                    got = kern(*ins)
                    torch.cuda.synchronize()
                    line["max_abs_err"] = cs.rec_err(
                        f"{name} {shape} {over}", got, want)
                    line["ms"] = cs.cuda_median_ms_cold(
                        lambda: kern(*ins), reps, flush)
                    line["ms_l2_warm"] = cs.cuda_median_ms(
                        lambda: kern(*ins), reps)
                    line["x_bound"] = line["ms"] / bound
                except Exception as e:           # report, go on, fail
                    failed = True
                    line["error"] = f"{type(e).__name__}: {e}"[:600]
                finally:
                    for k, val in saved.items():
                        setattr(mod, k, val)
                    if planned:
                        mod._plan.cache_clear()
                cs.emit(line)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--baseline", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("rec_kernel_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    print(cs.smi(), flush=True)
    if args.baseline is None:
        return sweep(args.tree.resolve(), args.seed, args.reps)
    rc = 0
    for tree in (args.baseline, ROOT, ROOT, args.baseline):
        rc |= subprocess.run(
            [sys.executable, __file__, "--seed", str(args.seed), "--reps",
             str(args.reps), "--tree", str(tree.resolve())],
            timeout=900).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
