"""The host's cost per launch on the card (port of
``scripts/calibrate.py``): a trivial op (``x + 1`` on 480x640 float32)
with a sync after each call and chained x100, and a chained 480x640
matmul (``tanh(x @ x.T).sum()``, float32, TF32 off) x30.

Usage:  python3 -m topfusion_tpu_torch.tools.calibrate [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    import torch

    from ..utils.device_info import entry_device, nvidia_smi_name_power
    from .timing import add_device_arg, sync

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        print(nvidia_smi_name_power())

    def f(x):
        return x + 1.0

    x = f(torch.zeros((480, 640), dtype=torch.float32, device=device))
    sync(device)

    # single-call latency (sync each call)
    t0 = time.perf_counter()
    for _ in range(20):
        x = f(x)
        sync(device)
    print(f"trivial op, sync each call : {(time.perf_counter()-t0)/20*1e3:8.3f} ms")

    # chained calls, one sync
    t0 = time.perf_counter()
    for _ in range(100):
        x = f(x)
    sync(device)
    print(f"trivial op, chained x100   : {(time.perf_counter()-t0)/100*1e3:8.3f} ms")

    # a moderately heavy fused op, chained
    def g(x):
        return torch.tanh(x @ x.T).sum()  # 480x640 matmul ~ 0.4 GFLOP

    g(x)
    sync(device)
    t0 = time.perf_counter()
    outs = [g(x) for _ in range(30)]
    sync(device)
    print(f"matmul 480x640 chained x30 : {(time.perf_counter()-t0)/30*1e3:8.3f} ms")
    del outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
