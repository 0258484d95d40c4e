"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and ``--seed`` in, camera poses and exact depth frames out.

Parameters:

  scene       "room" or "corridor" (``scene.SCENES``);
  trajectory  {"kind": "orbit" | "sweep", "frames": n or "window",
               and the kind's parameters}; "window" sizes one pass to the
               frames an open loop offers in the window;
  arrival     "closed" (the next chunk after the last one's results are
               on the host) or {"rate_fps": r} (open loop: frame i is due
               at i / r seconds, a chunk is handed over when its last
               frame is due);
  chunk       frames a call;
  replay      "cyclic" (the lap again, the map kept) or "laps" (each lap
               from a fresh map), for a closed loop;
  setup_laps  laps run in the set-up before the window.

Where the frames live (on the card, or on the host as a sensor delivers
them) is the driver's (``drivers/<entry>.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .scene import SCENES, TRAJECTORIES


def n_frames(mix: dict, seconds: float) -> int:
    """Frames of one pass of the trajectory."""
    n = mix["trajectory"]["frames"]
    if n == "window":
        rate = mix["arrival"]["rate_fps"]
        n = int(math.ceil(seconds * rate / mix["chunk"])) * mix["chunk"]
    return int(n)


def poses(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """[n, 4, 4] float32 camera-to-world poses of one pass."""
    tr = dict(mix["trajectory"])
    kind = tr.pop("kind")
    tr.pop("frames")
    return TRAJECTORIES[kind](n_frames(mix, seconds), seed=seed, **tr)


def render(mix: dict, cam: dict, T: np.ndarray, device) -> torch.Tensor:
    """u16 depth [n, H, W] in millimetres of the mix's scene at ``T``,
    rendered on ``device`` (and left there)."""
    scene = SCENES[mix["scene"]]()
    return scene.render_depth_mm(cam, torch.as_tensor(T, dtype=torch.float32, device=device))


def sample(seed: int, k: int, lo: int, hi: int) -> list:
    """``k`` distinct chunk indices in [lo, hi) drawn from ``seed``
    (the chunks the comparison checks)."""
    rng = np.random.default_rng([int(seed), 7])
    k = min(k, max(hi - lo, 0))
    return sorted(int(i) for i in rng.choice(np.arange(lo, hi), size=k, replace=False))
