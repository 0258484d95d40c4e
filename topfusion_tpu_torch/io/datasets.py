"""Dataset loaders: TUM RGB-D and ICL-NUIM sequences (port of
``topfusion_tpu/io/datasets.py``).

PNGs decode through the repository's native decoder
(``io/native_loader.decode_png_native``); imageio is used only where the
native library is missing and imageio is installed.  This is host IO: a
frame comes back as numpy, as in the JAX package.

Replaces the reference's OpenNI live capture (reference:
tfusion/src/capture.cpp — no TPU equivalent exists for a USB sensor) and
its hard-coded frame-file loop (reference: apps/demo.cpp:91-97) with the
standard research datasets used for evaluation.  The interface is
deliberately minimal and pluggable: a source yields (timestamp, depth_mm
uint16 [H, W], optional rgb uint8 [H, W, 3]).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..config import CameraConfig

# Published TUM RGB-D Freiburg-1 intrinsics; depth PNGs are 16-bit with
# 5000 units/meter.
TUM_FR1_CAMERA = CameraConfig(
    width=640, height=480, fx=517.3, fy=516.5, cx=318.6, cy=255.3
)
TUM_DEPTH_SCALE = 5000.0

# ICL-NUIM living-room intrinsics; depth PNGs also use 5000 units/meter.
ICL_CAMERA = CameraConfig(
    width=640, height=480, fx=481.20, fy=-480.00, cx=319.50, cy=239.50
)


@dataclasses.dataclass
class Frame:
    timestamp: float
    depth_mm: np.ndarray                 # uint16 [H, W] millimeters
    rgb: Optional[np.ndarray] = None     # uint8 [H, W, 3]


def _read_png(path: str) -> np.ndarray:
    """A PNG's pixels: u16 [H, W] or [H, W, C] from the native decoder
    (8-bit samples as their values), else imageio's array."""
    from .native_loader import decode_png_native, native_available

    if native_available():
        arr = decode_png_native(path)
        if arr is None:
            raise IOError(f"the native decoder could not read {path}")
        return arr
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise RuntimeError(
            "no PNG decoder: native/libtfnative.so is missing (make -C native) "
            "and imageio is not installed"
        ) from e
    return iio.imread(path)


def _read_rgb_png(path: str) -> np.ndarray:
    """8-bit color PNG -> uint8 [H, W, C]."""
    return _read_png(path).astype(np.uint8)


def _read_depth_png(path: str, units_per_meter: float) -> np.ndarray:
    """16-bit PNG -> uint16 millimeters (0 = invalid)."""
    raw = _read_png(path)
    if raw.dtype != np.uint16:
        raw = raw.astype(np.uint16)
    mm = raw.astype(np.float64) * (1000.0 / units_per_meter)
    return np.clip(np.round(mm), 0, 65535).astype(np.uint16)


def _read_camera_file(root: str) -> Optional[CameraConfig]:
    """Optional ``camera.txt`` (w h fx fy cx cy) in the sequence dir.

    Real TUM sequences carry no such file (the published fr1 intrinsics
    apply); synthetic TUM-format sequences written by
    scripts/make_synthetic_dataset.py record their camera here.
    """
    path = os.path.join(root, "camera.txt")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        vals = f.read().split()
    w, h = int(vals[0]), int(vals[1])
    fx, fy, cx, cy = (float(v) for v in vals[2:6])
    return CameraConfig(width=w, height=h, fx=fx, fy=fy, cx=cx, cy=cy)


def _parse_tum_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            out.append((float(ts), rel))
    return out


class TUMSequence:
    """TUM RGB-D sequence directory (depth.txt / rgb.txt / groundtruth.txt).

    Associates depth and rgb by nearest timestamp (max 20 ms apart, the
    standard association tolerance).
    """

    def __init__(self, root: str, with_rgb: bool = False):
        self.root = root
        self.camera = _read_camera_file(root) or TUM_FR1_CAMERA
        self.depth_list = _parse_tum_list(os.path.join(root, "depth.txt"))
        self.rgb_list = (
            _parse_tum_list(os.path.join(root, "rgb.txt"))
            if with_rgb and os.path.exists(os.path.join(root, "rgb.txt"))
            else []
        )
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth = None
        if os.path.exists(gt_path):
            from .trajectory import load_tum_trajectory

            self.groundtruth = load_tum_trajectory(gt_path)

    def __len__(self) -> int:
        return len(self.depth_list)

    def __iter__(self) -> Iterator[Frame]:
        rgb_ts = np.asarray([t for t, _ in self.rgb_list])
        for ts, rel in self.depth_list:
            depth = _read_depth_png(
                os.path.join(self.root, rel), TUM_DEPTH_SCALE
            )
            rgb = None
            if len(rgb_ts):
                k = int(np.argmin(np.abs(rgb_ts - ts)))
                if abs(rgb_ts[k] - ts) < 0.02:
                    rgb = _read_rgb_png(os.path.join(self.root, self.rgb_list[k][1]))
            yield Frame(timestamp=ts, depth_mm=depth, rgb=rgb)

    def gt_pose_at(self, ts: float) -> Optional[np.ndarray]:
        if self.groundtruth is None:
            return None
        stamps, poses = self.groundtruth
        k = int(np.argmin(np.abs(stamps - ts)))
        if abs(stamps[k] - ts) > 0.05:
            return None
        return poses[k]


class ICLSequence:
    """ICL-NUIM sequence in TUM-compatible format (depth.txt listing).

    The ICL camera convention has NEGATIVE fy (y axis flipped); a
    sequence-local ``camera.txt`` (synthetic ICL-format sequences from
    scripts/make_synthetic_dataset.py) overrides the published living
    room intrinsics, exactly like TUMSequence."""

    def __init__(self, root: str):
        self.root = root
        self.camera = _read_camera_file(root) or ICL_CAMERA
        self.depth_list = _parse_tum_list(os.path.join(root, "depth.txt"))
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth = None
        if os.path.exists(gt_path):
            from .trajectory import load_tum_trajectory

            self.groundtruth = load_tum_trajectory(gt_path)

    def __len__(self) -> int:
        return len(self.depth_list)

    def __iter__(self) -> Iterator[Frame]:
        for ts, rel in self.depth_list:
            yield Frame(
                timestamp=ts,
                depth_mm=_read_depth_png(
                    os.path.join(self.root, rel), TUM_DEPTH_SCALE
                ),
            )

    def gt_pose_at(self, ts: float) -> Optional[np.ndarray]:
        if self.groundtruth is None:
            return None
        stamps, poses = self.groundtruth
        k = int(np.argmin(np.abs(stamps - ts)))
        if abs(stamps[k] - ts) > 0.05:
            return None
        return poses[k]


def open_sequence(root: str, with_rgb: bool = False):
    """Auto-detect sequence flavor from directory contents: a negative
    fy in camera.txt or an icl/living-room directory name selects the
    ICL convention."""
    if os.path.exists(os.path.join(root, "depth.txt")):
        cam = _read_camera_file(root)
        if cam is not None and cam.fy < 0:
            return ICLSequence(root)
        if "icl" in root.lower() or "living" in root.lower():
            return ICLSequence(root)
        return TUMSequence(root, with_rgb=with_rgb)
    raise FileNotFoundError(f"no recognizable sequence at {root}")
