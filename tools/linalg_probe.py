#!/usr/bin/env python3
"""Probe the ``torch.linalg`` calls behind ``np.linalg`` on one CUDA card:
which batch sizes each accepts, what each costs, and which read their
error code on the host.

    python3 tools/linalg_probe.py

For each stack of symmetric positive definite ``(batch, n, n)`` f32
matrices (16384, 32768 and 65536 of 16 x 16; 32768 of 5 x 5) every call
runs once: one line with its synchronised wall
(the first call of a shape includes cuSOLVER's set-up) or the error it
raised.  Then each call on a singular ``(8, 4, 4)`` batch under
``torch.cuda.set_sync_debug_mode("error")``: whether it synchronises
(reads its error code on the host) and whether its answer is finite.
The last line is one JSON object of the batch results.  The card's name
and power limit are printed first.
"""

import json
import subprocess
import sys
import time


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("linalg_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          "numpy", np.__version__, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)

    def spd(b, n):
        g = torch.randn(b, n, n, device=dev)
        return g @ g.transpose(-1, -2) + n * torch.eye(n, device=dev)

    calls = {
        "inv_ex": lambda a: torch.linalg.inv_ex(a)[0],
        "inv": torch.linalg.inv,
        "det": torch.linalg.det,
        "slogdet": lambda a: torch.linalg.slogdet(a)[1],
        "cholesky_ex": lambda a: torch.linalg.cholesky_ex(a)[0],
        "qr": lambda a: torch.linalg.qr(a)[1],
        "qr_r": lambda a: torch.linalg.qr(a, mode="r")[1],
        "svd": lambda a: torch.linalg.svd(a)[1],
        "svdvals": torch.linalg.svdvals,
        "eigh": lambda a: torch.linalg.eigh(a)[0],
        "eigvalsh": torch.linalg.eigvalsh,
        "solve_ex": lambda a: torch.linalg.solve_ex(a, a[..., :1])[0],
        "lu_factor_ex": lambda a: torch.linalg.lu_factor_ex(a)[0],
        "matrix_power_neg": lambda a: torch.linalg.matrix_power(a, -1),
        "pinv": torch.linalg.pinv,
    }
    res = {}
    for b, n in ((16384, 16), (32768, 16), (65536, 16), (32768, 5)):
        a = spd(b, n)
        for name, fn in calls.items():
            key = "%s b=%d n=%d" % (name, b, n)
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(a)
                torch.cuda.synchronize()
                res[key] = {"finite": bool(torch.isfinite(out).all()),
                            "s": time.perf_counter() - t}
            except RuntimeError as e:
                res[key] = {"err": "%s: %s" % (
                    type(e).__name__, str(e).splitlines()[0][:160])}
                torch.cuda.synchronize()
            print(key, res[key], flush=True)
        del a
        torch.cuda.empty_cache()
    s = torch.zeros(8, 4, 4, device=dev)
    s[:, 0, 0] = 1
    for name, fn in calls.items():
        torch.cuda.synchronize()
        try:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(s)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            print("singular, no sync:", name, "finite=%s"
                  % bool(torch.isfinite(out).all()), flush=True)
        except RuntimeError as e:
            print("singular:", name, "%s: %s" % (
                type(e).__name__, str(e).splitlines()[0][:160]), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
