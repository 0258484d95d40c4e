"""The port's GIF writer (``topfusion_tpu_torch/io/gif.py``) read back by
imageio (Pillow's decoder), against what the JAX package's app writes
through ``imageio.v3.imwrite(..., fps=...)``: frames of at most 256
colours losslessly, others within the writer's stated palette errors,
every frame with its delay."""

import imageio.v3 as iio
import numpy as np
import pytest

from topfusion_tpu_torch.io.gif import MAX_COLOR_ERROR, MAX_GREY_ERROR, gif_frames, write_gif


def grey_frames(n, h, w, seed):
    """n distinct grey RGB frames: a gradient with noise (Pillow merges
    identical consecutive frames, so none repeats)."""
    rng = np.random.default_rng(seed)
    base = (np.arange(h)[:, None] * 7 + np.arange(w)[None, :] * 3) % 256
    g = (base[None] + rng.integers(0, 40, size=(n, h, w))) % 256
    return np.repeat(g.astype(np.uint8)[..., None], 3, axis=-1)


@pytest.mark.parametrize("n,h,w,fps", [(1, 5, 7, 5), (10, 31, 17, 10), (2, 240, 320, 5),
                                       (3, 97, 131, 10)])
def test_grey_frames_round_trip_losslessly(tmp_path, n, h, w, fps):
    """Odd sizes, 1 and 10 frames, half VGA (a stream of ~300 clear codes
    per frame); delays of 200 ms at fps 5 and 100 ms at fps 10, as
    imageio writes them, and the same frames as imageio's file decodes
    to."""
    frames = grey_frames(n, h, w, seed=n)
    path = str(tmp_path / "port.gif")
    write_gif(path, list(frames), fps=fps)
    got = iio.imread(path, index=None, mode="RGB")
    np.testing.assert_array_equal(got, frames)
    delay_ms = 1000 // fps
    assert gif_frames(path) == [(w, h, delay_ms // 10)] * n
    assert all(iio.immeta(path, index=i)["duration"] == delay_ms for i in range(n))
    assert iio.immeta(path, index=0)["loop"] == 0
    ref = str(tmp_path / "imageio.gif")
    iio.imwrite(ref, frames, fps=fps)
    np.testing.assert_array_equal(got, iio.imread(ref, index=None, mode="RGB"))
    assert [iio.immeta(ref, index=i)["duration"] for i in range(n)] == [delay_ms] * n


def test_color_frames_within_the_palette_error(tmp_path):
    """A frame of more than 256 colours: every non-grey pixel within
    MAX_COLOR_ERROR per channel and every grey pixel grey and within
    MAX_GREY_ERROR, both bounds reached.  A frame of 200 colours and a
    grey frame beside it stay exact."""
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, size=(40, 52, 3)).astype(np.uint8)
    greys = np.concatenate([np.arange(256), rng.integers(0, 256, 40 * 52 - 256)])
    is_grey = (np.arange(40 * 52) % 3 == 0).reshape(40, 52)
    noise[is_grey] = np.repeat(greys[: is_grey.sum()].astype(np.uint8)[:, None], 3, axis=1)
    colours = rng.integers(0, 256, size=(200, 3)).astype(np.uint8)
    few = colours[rng.integers(0, 200, size=(40, 52))]
    grey = grey_frames(1, 40, 52, seed=4)[0]
    path = str(tmp_path / "c.gif")
    write_gif(path, [noise, few, grey], fps=5)
    got = iio.imread(path, index=None, mode="RGB").astype(np.int64)
    err = np.abs(got[0] - noise.astype(np.int64))
    assert err[~is_grey].max() == MAX_COLOR_ERROR
    assert err[is_grey].max() == MAX_GREY_ERROR
    g = got[0][is_grey]
    assert (g[:, 0] == g[:, 1]).all() and (g[:, 1] == g[:, 2]).all()
    np.testing.assert_array_equal(got[1], few)
    np.testing.assert_array_equal(got[2], grey)


def test_write_gif_refuses_bad_input(tmp_path):
    with pytest.raises(ValueError, match="no frames"):
        write_gif(str(tmp_path / "x.gif"), [], fps=5)
    with pytest.raises(ValueError, match="different sizes"):
        write_gif(str(tmp_path / "x.gif"), [np.zeros((4, 5), np.uint8), np.zeros((5, 4), np.uint8)],
                  fps=5)
