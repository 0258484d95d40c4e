"""The port's dataset writer (``python -m
topfusion_tpu_torch.tools.make_synthetic_dataset``) against
scripts/make_synthetic_dataset.py on the same arguments, the PNG writer
of ``io/png.py`` read back through the native decoder and through
imageio, and the app's ``--sequence`` path on a directory the port
wrote.

The depth pixels may differ by one unit (0.2 mm) where a float32 depth
lies within rounding of a unit's edge: the JAX script renders with a
jitted ``render_depth``, where XLA contracts multiplies and adds into
FMAs, the port with plain float32 PyTorch.  The noise draws depend only
on the image's shape and the seed, so everything else is equal."""

import filecmp
import json
import os
import subprocess
import sys

import imageio.v3 as iio
import numpy as np
import pytest
import torch

from topfusion_tpu.io import datasets as jds
from topfusion_tpu_torch.apps import run_fusion
from topfusion_tpu_torch.io import datasets as tds
from topfusion_tpu_torch.io import png
from topfusion_tpu_torch.tools import make_synthetic_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 6
ARGS = {
    "tum": ["--frames", str(FRAMES), "--noise", "1"],
    "icl": ["--frames", str(FRAMES), "--noise", "0", "--format", "icl", "--angle", "4",
            "--shift", "0.04"],
}
# Share of valid pixels allowed to differ, by one unit (measured: 48 of
# 453 864 valid pixels, 0.011%, on the noisy TUM directory).
MAX_DIFFERING = 1e-3

torch.set_num_threads(2)


def png_pixels(path):
    return tds._read_png(path)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Both writers' TUM and ICL directories: the JAX script in
    subprocesses, the port's tool in this process meanwhile."""
    base = tmp_path_factory.mktemp("datasets")
    out = {(who, kind): str(base / f"{who}_{kind}") for who in ("jax", "port")
           for kind in ARGS}
    # The script sets a shared JAX compilation cache only where none is set.
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               JAX_COMPILATION_CACHE_DIR=str(base / "jax_cache"))
    script = os.path.join(ROOT, "scripts", "make_synthetic_dataset.py")
    procs = [subprocess.Popen([sys.executable, script, "--out", out["jax", kind], *args],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for kind, args in ARGS.items()]
    try:
        for kind, args in ARGS.items():
            assert make_synthetic_dataset.main(
                ["--out", out["port", kind], *args, "--device", "cpu"]) == 0
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in procs:
            p.kill()
    return out


# ------------------------------------------------------------------- PNGs
IMAGES = {
    "grey16": lambda rng: rng.integers(0, 65536, (48, 64), dtype=np.uint16),
    "grey8": lambda rng: rng.integers(0, 256, (48, 64), dtype=np.uint8),
    "rgb8": lambda rng: rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
}


@pytest.mark.parametrize("reader", ["native", "imageio"])
@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_png_round_trip(tmp_path, kind, reader):
    """16-bit grey (big-endian samples, IHDR depth 16, colour type 0) and
    8-bit grey / RGB images read back equal."""
    img = IMAGES[kind](np.random.default_rng(3))
    path = str(tmp_path / f"{kind}.png")
    png.write_png(path, img)
    got = png_pixels(path) if reader == "native" else iio.imread(path)
    np.testing.assert_array_equal(got, img)
    if reader == "imageio":
        assert got.dtype == img.dtype


def test_png_header(tmp_path):
    path = str(tmp_path / "d.png")
    png.write_png(path, np.arange(12, dtype=np.uint16).reshape(3, 4) * 5000)
    with open(path, "rb") as f:
        head = f.read(33)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    assert int.from_bytes(head[16:20], "big") == 4 and int.from_bytes(head[20:24], "big") == 3
    assert head[24] == 16 and head[25] == 0


def test_app_writes_through_io_png():
    assert run_fusion.write_png is png.write_png


# --------------------------------------------------------------- datasets
@pytest.mark.parametrize("name", ["depth.txt", "camera.txt", "groundtruth.txt"])
@pytest.mark.parametrize("kind", sorted(ARGS))
def test_text_files_byte_equal(dirs, kind, name):
    assert filecmp.cmp(os.path.join(dirs["port", kind], name),
                       os.path.join(dirs["jax", kind], name), shallow=False)


@pytest.mark.parametrize("kind", sorted(ARGS))
def test_depth_pixels(dirs, kind):
    """Every depth PNG 16-bit, the pixels equal but for at most
    MAX_DIFFERING of the valid ones, by one unit."""
    names = sorted(os.listdir(os.path.join(dirs["jax", kind], "depth")))
    assert names == sorted(os.listdir(os.path.join(dirs["port", kind], "depth")))
    assert len(names) == FRAMES
    valid = differ = 0
    for n in names:
        want = iio.imread(os.path.join(dirs["jax", kind], "depth", n)).astype(np.int64)
        path = os.path.join(dirs["port", kind], "depth", n)
        got = iio.imread(path)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(png_pixels(path), got)
        d = np.abs(got.astype(np.int64) - want)
        assert d.max() <= 1
        valid += int((want > 0).sum())
        differ += int((d > 0).sum())
    assert valid > 0.3 * FRAMES * want.size
    assert differ <= MAX_DIFFERING * valid, (differ, valid)


@pytest.mark.parametrize("kind", sorted(ARGS))
def test_open_sequence_reads_both_alike(dirs, kind):
    """The port's loader: the same sequence type, camera, timestamps and
    ground truth from both directories, the frames within one unit; and
    the JAX loader reads the port's directory as the port's does."""
    port, ref = tds.open_sequence(dirs["port", kind]), tds.open_sequence(dirs["jax", kind])
    assert type(port) is type(ref)
    assert type(port).__name__ == ("ICLSequence" if kind == "icl" else "TUMSequence")
    assert port.camera == ref.camera and (port.camera.fy < 0) == (kind == "icl")
    for a, b, c in zip(port, ref, jds.open_sequence(dirs["port", kind])):
        assert a.timestamp == b.timestamp == c.timestamp
        assert a.depth_mm.dtype == np.uint16
        np.testing.assert_array_equal(a.depth_mm, c.depth_mm)
        assert np.abs(a.depth_mm.astype(np.int64) - b.depth_mm).max() <= 1
        np.testing.assert_array_equal(port.gt_pose_at(a.timestamp), ref.gt_pose_at(b.timestamp))


def test_app_on_port_sequence(dirs, tmp_path):
    """The port's app on the port's noisy TUM directory (``--sequence``):
    the output names that chip_smoke.py's app phase checks, and PNGs that
    both decoders read alike."""
    out = str(tmp_path / "run")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "topfusion_tpu_torch.apps.run_fusion", "--sequence",
         dirs["port", "tum"], "--out", out, "--device", "cpu", "--chunk", "2",
         "--render-every", "2", "--set", "icp.iters=4,3,2", "--set", "blockmap.capacity=8192",
         "--set", "tsdf.voxel_size=0.01", "--set", "tsdf.trunc_dist=0.04"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    names = sorted(os.listdir(out))
    for want in ("cloud.ply", "metrics.json", "metrics.jsonl", "render_final.png", "state.npz",
                 "trajectory_odom.txt", "trajectory_opt.txt"):
        assert want in names
    assert any(n.startswith("config.") for n in names)
    assert any(n.startswith("render_0") for n in names)
    with open(os.path.join(out, "metrics.json")) as f:
        summary = json.load(f)
    assert summary["frames"] == FRAMES and np.isfinite(summary["ate_odom_m"])
    path = os.path.join(out, "render_final.png")
    img = iio.imread(path)
    assert img.shape == (240, 320, 3) and img.std() > 0
    np.testing.assert_array_equal(png_pixels(path), img)
