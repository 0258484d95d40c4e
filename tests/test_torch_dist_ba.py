"""The port's distributed bundle adjustment (``parallel/dist_ba.py``)
against the JAX package's: one gloo world of 4 CPU processes against
JAX ``optimize_distributed`` on a mesh of 4 virtual CPU devices, on
tests/test_parallel.py's drifted graph (8 keyframes, a loop edge, 16
keyframe slots, 64 edge slots, 6 Gauss-Newton steps of 48 CG steps).

How the runs are compared.  The two packages sum the members' partial
sums in another order (gloo's ring against XLA's all-reduce) and the
port's segment sums are incidence products where JAX scatter-adds, so
the poses agree within 1e-5 (tests/test_torch_posegraph.py's tolerance
for the single-device solve; tests/test_parallel.py holds the JAX mesh
to the single-device solve within 1e-4), not to the bit.  The members
apply one summed update, so their poses are bit-identical.  One member
makes every sum its input: the solve is ``optimize_pcg`` bit for bit,
and a ``ShardedSlamSystem`` on one member is ``SlamSystem`` bit for bit
over a 12-frame out-and-back that closes loops and rebuilds the map.
"""

import dataclasses
import pickle

import numpy as np
import pytest

from tests.test_parallel import PG_CFG, build_drifted_graph
from tests.test_sharded_slam import make_cfg, out_and_back
from torch_sharded_world import dist_ba_world
from topfusion_tpu.parallel.dist_ba import optimize_distributed as jax_optimize_distributed
from topfusion_tpu.parallel.sharded_pipeline import make_mesh as jax_make_mesh
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.parallel import spawn_world

NS = 4
POSE_TOL = 1e-5
SLAM_FRAMES, CHUNK = 12, 3


def slam_cfg(**posegraph):
    cfg = make_cfg()
    return dataclasses.replace(cfg, posegraph=dataclasses.replace(
        cfg.posegraph, reint_ring=8, min_map_correction=0.0, **posegraph))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pg, true = build_drifted_graph()
    jd, jchi = jax_optimize_distributed(pg, PG_CFG, jax_make_mesh(NS, axis="ba"))
    cfg = slam_cfg()
    inputs = dict(
        graph={k: np.asarray(v) for k, v in pg._asdict().items()},
        pg_cfg=config_from_reference(
            dataclasses.replace(make_cfg(), posegraph=PG_CFG)).posegraph,
        slam_cfg=config_from_reference(cfg),
        slam_cfg_dense=config_from_reference(
            dataclasses.replace(make_cfg(), posegraph=dataclasses.replace(PG_CFG, solver="dense"))),
        poses=[np.asarray(T) for T in out_and_back(SLAM_FRAMES)], chunk=CHUNK,
    )
    path = tmp_path_factory.mktemp("dist_ba") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    ranks = spawn_world(dist_ba_world, NS, "gloo", "cpu", args=(str(path),), threads=1,
                        timeout_s=600)
    return dict(ranks=ranks, jax=np.asarray(jd.kf_poses), jax_chi2=float(jchi),
                true=[np.asarray(T) for T in true])


def test_matches_jax_mesh_of_four(world):
    """The live keyframes within 1e-5 of the JAX mesh's, and on the true
    trajectory within tests/test_parallel.py's 5 mm."""
    got = world["ranks"][0]["poses"]
    np.testing.assert_allclose(got[:8], world["jax"][:8], rtol=0, atol=POSE_TOL)
    np.testing.assert_array_equal(got[8:], world["jax"][8:])
    for i in range(8):
        assert np.linalg.norm(got[i][:3, 3] - world["true"][i][:3, 3]) < 5e-3
    assert np.isfinite(world["ranks"][0]["chi2"])
    assert abs(world["ranks"][0]["chi2"] - world["jax_chi2"]) <= 1e-4 * max(1.0, world["jax_chi2"])


def test_members_agree_bitwise(world):
    for r in world["ranks"][1:]:
        np.testing.assert_array_equal(r["poses"], world["ranks"][0]["poses"])
        assert r["chi2"] == world["ranks"][0]["chi2"]


@pytest.mark.parametrize("world_of", [NS, 1])
def test_collectives_per_solve(world, world_of):
    """gn_iters x (cg_iters + 3) sums per solve: per Gauss-Newton step
    cg_iters + 1 Hessian-vector products and the gradient ([K, 6] float32
    each) and the preconditioner ([K, 6, 6]); the same on one member."""
    k, gn, cg = PG_CFG.max_keyframes, PG_CFG.gn_iters, PG_CFG.cg_iters
    want_calls = gn * (cg + 3)
    want_bytes = gn * ((cg + 2) * k * 6 * 4 + k * 36 * 4)
    outs = world["ranks"] if world_of == NS else [world["ranks"][0]["world1_pcg"]]
    for out in outs:
        assert out["calls"] == want_calls
        assert out["bytes"] == want_bytes


def test_one_member_is_optimize_pcg(world):
    assert world["ranks"][0]["world1_pcg"]["same"]


def test_composed_system_solves_by_pcg_under_dense_solver(world):
    """The JAX ``ShardedSlamSystem`` solves by distributed PCG even when
    ``posegraph.solver == "dense"`` (``parallel/sharded_slam.py:123-134``);
    so does the port's: the same poses as ``optimize_distributed`` and
    its collectives."""
    k, gn, cg = PG_CFG.max_keyframes, PG_CFG.gn_iters, PG_CFG.cg_iters
    for r in world["ranks"]:
        assert r["dense_solver"]["same"]
        assert r["dense_solver"]["calls"] == gn * (cg + 3)


def test_world_of_one_slam_is_slam_system(world):
    """A ``ShardedSlamSystem`` on one member against ``SlamSystem`` over the
    12-frame out-and-back in chunks of 3 (loops close and the map is
    rebuilt from an 8-frame ring), side by side on two ranks: odometry,
    optimized trajectory, graph and every state field bit-identical, the
    same closures and rebuilds."""
    sh, ref = world["ranks"][0]["slam_run"], world["ranks"][1]["slam_run"]
    for key in ("odom", "opt"):
        np.testing.assert_array_equal(sh[key], ref[key], err_msg=key)
    for key in ("graph", "state"):
        assert len(sh[key]) == len(ref[key])
        for i, (a, b) in enumerate(zip(sh[key], ref[key])):
            np.testing.assert_array_equal(a, b, err_msg=f"{key} leaf {i}")
    assert sh["loops"] == ref["loops"] >= 1
    assert sh["reint"] == ref["reint"] >= 1
