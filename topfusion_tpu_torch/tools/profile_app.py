"""The chunked SLAM app's per-chunk host timeline (port of
``scripts/profile_app.py``).

``SlamSystem`` at the bench configuration (``tools/bench_config.py``)
over the 60-frame synthetic orbit in chunks of 10.  Each
``process_chunk`` call is split, by wrapping the system's own methods
on this instance, into: the chunk's dispatch (the host's time to enqueue
the steps, keyframe inserts and loop detection: on the card the replays
of the captured graphs), its execution (a sync before the fetch), the
host fetch (the chunk's one device-to-host copy), the loop-closure work
(solve and re-integration, when a loop closed) and the keyframe
bookkeeping on the host (the rest).  Then the final render.  The split
adds no sync inside a step: the fetch syncs anyway.

Usage:  python3 -m topfusion_tpu_torch.tools.profile_app [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time


def run(cfg, device, n: int = 60, chunk: int = 10) -> None:
    """``SlamSystem`` at ``cfg`` over ``n`` frames in chunks of ``chunk``:
    a line per chunk, then the render's."""
    import numpy as np
    import torch

    from ..io.synthetic import SyntheticScene, orbit_trajectory
    from ..models.slam import SlamSystem
    from .timing import sync

    cam = cfg.camera
    scene = SyntheticScene()
    gt = orbit_trajectory(n, max_angle_deg=5.0, max_shift=0.05, seed=2)
    frames = torch.stack([scene.render_depth_mm(cam, torch.as_tensor(T, dtype=torch.float32,
                                                                     device=device))
                          for T in gt])
    chunks = [frames[i:i + chunk] for i in range(0, n, chunk)]
    sync(device)

    slam = SlamSystem(cfg, device=device)
    t0 = time.perf_counter()
    slam.warmup(chunk)
    sync(device)
    print(f"warmup {time.perf_counter()-t0:.1f} s", flush=True)

    spans: dict = {}

    def timed(key, fn, fence=False):
        def call(*a, **kw):
            if fence:  # the chunk's execution, before its fetch
                t0 = time.perf_counter()
                sync(device)
                spans["exec"] = spans.get("exec", 0.0) + time.perf_counter() - t0
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if key == "loop":
                sync(device)
            spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    slam._dispatch_chunk = timed("dispatch", slam._dispatch_chunk)
    slam._fetch = timed("fetch", slam._fetch, fence=True)
    slam._solve = timed("loop", slam._solve)
    slam._reint = timed("loop", slam._reint)

    for it, dc in enumerate(chunks):
        spans.clear()
        sync(device)
        t0 = time.perf_counter()
        infos = slam.process_chunk(dc, do_kf=True)
        t_full = time.perf_counter() - t0
        parts = {k: spans.get(k, 0.0) for k in ("dispatch", "exec", "fetch", "loop")}
        book = t_full - sum(parts.values())
        print(
            f"chunk {it}: dispatch {parts['dispatch']*1e3:7.1f} ms, "
            f"exec-fence {parts['exec']*1e3:7.1f} ms, fetch {parts['fetch']*1e3:7.1f} ms, "
            f"loop closure {parts['loop']*1e3:7.1f} ms, bookkeeping {book*1e3:7.1f} ms, "
            f"full process_chunk {t_full*1e3:7.1f} ms "
            f"(loop={infos[0]['loop']})",
            flush=True,
        )

    t0 = time.perf_counter()
    img = slam.render().cpu().numpy()
    print(f"render: {time.perf_counter()-t0:.2f} s, std {np.float64(img.std()):.1f}")


def main(argv=None) -> int:
    from ..utils.device_info import entry_device, nvidia_smi_name_power
    from .bench_config import bench_config
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    if device.type == "cuda":
        print(nvidia_smi_name_power())
    run(bench_config(), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
