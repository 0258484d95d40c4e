"""The traffic generator is deterministic per seed and differs across
seeds, for every mix of the benchmark."""

import numpy as np
import pytest
import torch

from fusionbench import spec, traffic

MIXES = sorted({w["traffic"] for w in spec.benchmark()["workloads"]})
CAM = {"width": 40, "height": 32, "fx": 30.0, "fy": 30.0, "cx": 20.0, "cy": 16.0}
BIG = 2**31 + 12345


@pytest.mark.parametrize("mix", MIXES)
def test_deterministic_per_seed(mix):
    m = spec.load_json(spec.PKG / "traffic" / f"{mix}.json")
    a, b = traffic.poses(m, BIG, 2.0), traffic.poses(m, BIG, 2.0)
    assert np.array_equal(a, b)
    fa = traffic.render(m, CAM, a[:3], "cpu")
    assert torch.equal(fa, traffic.render(m, CAM, b[:3], "cpu"))
    assert fa.dtype == torch.uint16 and int((fa.to(torch.int32) > 0).sum()) > 0


@pytest.mark.parametrize("mix", MIXES)
def test_differs_across_seeds(mix):
    m = spec.load_json(spec.PKG / "traffic" / f"{mix}.json")
    a, b = traffic.poses(m, 1, 2.0), traffic.poses(m, 2, 2.0)
    assert a.shape == b.shape and not np.allclose(a, b)


def test_sample_is_seeded():
    assert traffic.sample(BIG, 2, 0, 50) == traffic.sample(BIG, 2, 0, 50)
    assert len(traffic.sample(3, 2, 8, 9)) == 1
