#!/usr/bin/env python3
"""Does CUBLAS_WORKSPACE_CONFIG=:4096:8 change cuBLAS's timings on this
card?  Deterministic cuBLAS (``torch.use_deterministic_algorithms``)
needs the variable set before cuBLAS starts, so it can only be compared
across processes: this script runs itself in child processes, without
and with it, in turns (without, with, with, without; twice), and prints
one JSON line per child with the card's name and power limit.

    python3 tools/cublas_workspace_ab.py          # needs one CUDA device

Each child times, with CUDA events after a warm-up, the library calls
that ``chip_smoke.py`` times beside its kernels: the evalDG step's
``(x.half() @ D.half()) > 0`` at [1, 16041] x [16041, 16041], its
product alone, the fp16 squaring at [16041]^2, and the rank update's
small ``(L.half() @ R.half()) > 0`` at [16103, 64] x [64, 64].
"""
import json
import os
import subprocess
import sys

VAR = "CUBLAS_WORKSPACE_CONFIG"
ORDER = (False, True, True, False) * 2


def child() -> dict:
    import torch
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    n = 16041
    D = torch.rand((n, n), generator=g, device=dev) < 0.01
    x = torch.rand((1, n), generator=g, device=dev) < 0.01
    Ah = (torch.rand((n, n), generator=g, device=dev) < 0.01).half()
    L = torch.rand((16103, 64), generator=g, device=dev) < 0.1
    R = torch.rand((64, 64), generator=g, device=dev) < 0.1

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    return {"env": os.environ.get(VAR),
            "card": torch.cuda.get_device_name(0),
            "evaldg_library_ms": timed(lambda: (x.half() @ D.half()) > 0, 20),
            "gemv_ms": timed(lambda: x.half() @ Ah, 50),
            "squaring_fp16_ms": timed(lambda: Ah @ Ah, 3),
            "left_library_ms": timed(lambda: (L.half() @ R.half()) > 0, 50)}


def main() -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    for with_var in ORDER:
        env = dict(os.environ)
        env.pop(VAR, None)
        if with_var:
            env[VAR] = ":4096:8"
        out = subprocess.run([sys.executable, __file__, "--child"],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        print(json.dumps(child()))
        sys.exit(0)
    sys.exit(main())
