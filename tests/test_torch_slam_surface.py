"""tests/test_reint_ring.py's surface-quality acceptance test on the
port, free-running on the CPU: after a loop closure the ring rebuild
(every ring frame re-fused at its corrected pose) must reach the surface
quality of a full re-fusion of every frame at the same poses, and carry
more fused weight than the keyframe-only rebuild.  The surface is the
RMS of the analytic scene's SDF at the extracted point cloud."""

import dataclasses

import torch

from tests.test_slam import make_cfg, out_and_back
from tests.test_torch_slam import correcting, port_frames, surface_rms
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.io.synthetic import SyntheticScene
from topfusion_tpu_torch.models.slam import SlamSystem

torch.set_num_threads(2)


def test_port_ring_rebuild_surface_quality():
    """tests/test_reint_ring.py::test_ring_reintegration_full_rate_surface_quality
    on the port: the ring rebuild's surface is within 1.2x of a full
    re-fusion of every frame at the same poses, and carries more fused
    weight than the keyframe-only rebuild."""
    scene = SyntheticScene()
    base = config_from_reference(correcting(make_cfg()))
    cfg_ring = dataclasses.replace(base, posegraph=dataclasses.replace(
        base.posegraph, reint_ring=32))
    depths = torch.stack(port_frames(base, out_and_back(30)))

    def run(cfg):
        slam = SlamSystem(cfg, device="cpu")
        for s in range(0, 30, 3):
            slam.process_chunk(depths[s:s + 3])
        return slam

    slam_kf, slam_ring = run(base), run(cfg_ring)
    assert slam_ring.reintegrations >= 1 and slam_kf.reintegrations >= 1
    ref = SlamSystem(cfg_ring, device="cpu")
    st = ref.pipe.init()
    for d, T in zip(depths, slam_ring.optimized_trajectory()):
        st = ref._fuse_at(st, d, torch.as_tensor(T))
    rms_full = surface_rms(scene, st, cfg_ring)
    rms_ring = surface_rms(scene, slam_ring.state, cfg_ring)
    assert rms_ring <= 1.2 * rms_full + 1e-4, (rms_ring, rms_full)
    w_ring = float(slam_ring.state.weight.to(torch.float32).sum())
    w_kf = float(slam_kf.state.weight.to(torch.float32).sum())
    assert w_ring > 1.5 * w_kf, (w_ring, w_kf)


