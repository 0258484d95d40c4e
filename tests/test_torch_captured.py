"""The port's compiled step (``models/captured.CapturedStep``) and ICP's
observability ratio against the JAX package on the CPU, at the 80x64
test config of tests/test_pipeline_block.py.

One JAX run: 4 frames of the test orbit through the jitted step, then
the state carried into ``jax.jit(lambda s, f: lax.scan(pipe._step, s,
f))`` over the next 4 frames, as ``bench.py`` chunks them, and into the
port's ``CapturedStep.run`` over the same frames (on the CPU the runner
steps eagerly).  The same JAX state gives the ICP inputs of
tests/test_torch_icp.py.  And the stepping paths no longer call
``torch.linalg.eigvalsh``, the one host sync they had on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_block import make_cfg
from tests.test_torch_pipeline_block import rot_deg
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu.ops import icp as jicp
from topfusion_tpu.ops.depth import preprocess_depth as j_preprocess
from topfusion_tpu.ops.normals import build_maps_pyramid as j_maps
from topfusion_tpu_torch.convert import block_state_from_numpy, config_from_reference
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.models.captured import CapturedStep
from topfusion_tpu_torch.models.pipeline import DensePipeline
from topfusion_tpu_torch.ops import icp as ticp

torch.set_num_threads(2)

CARRY_AT = 4
CHUNK = 4


def numpy_tree(state):
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX state after CARRY_AT frames (numpy), the scanned chunk's
    final state and stacked aux, the frames, and the ICP inputs of the
    next frame."""
    cfg = make_cfg()
    scene = SyntheticScene()
    poses = orbit_trajectory(8, max_angle_deg=4.0, max_shift=0.04, seed=3)
    frames = np.stack([np.asarray(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
                       for T in poses[:CARRY_AT + CHUNK]])
    pipe = JaxPipeline(cfg)
    state = pipe.init()
    for f in frames[:CARRY_AT]:
        state, _ = pipe.step(state, jnp.asarray(f))
    carried = numpy_tree(state)
    _, pyr = j_preprocess(jnp.asarray(frames[CARRY_AT]), cfg.preproc)
    cp, cn = j_maps(cfg.camera, pyr)
    npl = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    icp_inputs = (np.asarray(state.T_wc), npl(state.model_points), npl(state.model_normals),
                  npl(cp), npl(cn))
    run_chunk = jax.jit(lambda s, f: jax.lax.scan(pipe._step, s, f))
    final, aux = run_chunk(state, jnp.asarray(frames[CARRY_AT:]))
    return dict(cfg=cfg, frames=frames, carried=carried, final=numpy_tree(final),
                aux=jax.tree.map(np.asarray, aux), icp_inputs=icp_inputs)


@pytest.fixture(scope="module")
def port_run(jax_run):
    pipe = BlockPipeline(config_from_reference(jax_run["cfg"]), device="cpu")
    runner = CapturedStep(pipe, block_state_from_numpy(jax_run["carried"], device="cpu"))
    aux = runner.run(torch.from_numpy(jax_run["frames"][CARRY_AT:]))
    return dict(runner=runner, aux=aux, state=runner.state())


def test_runner_on_the_cpu_steps_eagerly(port_run):
    runner = port_run["runner"]
    assert runner.graph is None and runner.device.type == "cpu"
    assert all(v == 0 for v in runner.per_replay.values())
    assert port_run["aux"].ok.shape == (CHUNK,)


def test_chunk_pose_follows_the_scanned_step(jax_run, port_run):
    """The pose after the chunk within 0.5 mm and 0.01 degrees of the
    scanned JAX step's (tests/test_torch_pipeline_block.py's tolerances
    for a carried step and a frame's rotation: ulp differences in ICP's
    sums feed back through the model maps).  Measured: 0.064 mm and
    0.00089 degrees."""
    Tj, Tt = jax_run["final"]["T_wc"], port_run["state"].T_wc.numpy()
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 5e-4
    assert rot_deg(Tt[:3, :3], Tj[:3, :3]) <= 0.01
    assert np.abs(Tj[:3, 3] - jax_run["carried"]["T_wc"][:3, 3]).max() > 1e-3  # it moved


@pytest.mark.parametrize("field", ["bucket_keys", "bucket_slots", "block_coords", "num_blocks",
                                   "vis_slots", "frame", "resets"])
def test_chunk_map_and_counters_equal_the_scanned_step(jax_run, port_run, field):
    np.testing.assert_array_equal(getattr(port_run["state"], field).numpy(),
                                  jax_run["final"][field])


@pytest.mark.parametrize("field", ["ok", "was_reset", "num_blocks", "blocks_allocated",
                                   "num_visible", "blocks_dropped", "integrate_skipped",
                                   "visible_overflow"])
def test_chunk_aux_equals_the_scanned_step(jax_run, port_run, field):
    """Every frame's aux, stacked as ``lax.scan`` stacks it."""
    got = getattr(port_run["aux"], field).numpy()
    want = getattr(jax_run["aux"], field)
    assert got.shape == want.shape == (CHUNK,)
    np.testing.assert_array_equal(got, want)


def test_chunk_tracking_health_follows_the_scanned_step(jax_run, port_run):
    """Inliers within 2 of ~1100 and the residual within 2% (measured: 1
    and 0.93% at the chunk's last frames): once the poses part by ulps, a
    correspondence at a gate's edge can fall either way."""
    got, want = port_run["aux"].num_inliers.numpy(), jax_run["aux"].num_inliers
    assert np.abs(got.astype(np.int64) - want).max() <= 2 and want.min() > 1000
    np.testing.assert_allclose(port_run["aux"].residual.numpy(), jax_run["aux"].residual,
                               rtol=2e-2)


def test_load_and_state_round_trip(jax_run, port_run):
    """``load`` makes a state the next step's start; ``state`` gives it
    back."""
    runner = CapturedStep(port_run["runner"].pipe,
                          block_state_from_numpy(jax_run["carried"], device="cpu"))
    runner.load(port_run["state"])
    assert runner.state() is port_run["state"]


@pytest.mark.parametrize("variant", ["flat_polish", "take_bilinear_stride1", "onehot_polish"])
def test_obs_ratio_of_the_gram_matches_jax(jax_run, variant):
    """``obs_ratio(res.gram)`` is the JAX package's ``res.obs_ratio`` for the
    ICP cases of tests/test_torch_icp.py (within 1e-4: the Gram matrices
    differ in their last bits), and the batched call, as ``detect_loop``
    makes it, gives each matrix's ratio."""
    cfg = jax_run["cfg"]
    T_model, mp, mn, cp, cn = jax_run["icp_inputs"]
    icfg = cfg.icp
    if variant == "take_bilinear_stride1":
        icfg = dataclasses.replace(icfg, gather_mode="take", bilinear=True, level0_stride=1)
    if variant == "onehot_polish":
        icfg = dataclasses.replace(icfg, gather_mode="onehot")
    tcfg = config_from_reference(dataclasses.replace(cfg, icp=icfg))
    rj = jicp.icp_track(cfg.camera, icfg, jnp.asarray(T_model), jnp.asarray(T_model),
                        [jnp.asarray(x) for x in cp], [jnp.asarray(x) for x in cn],
                        [jnp.asarray(x) for x in mp], [jnp.asarray(x) for x in mn])
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    rt = ticp.icp_track(tcfg.camera, tcfg.icp, t(T_model), t(T_model), [t(x) for x in cp],
                        [t(x) for x in cn], [t(x) for x in mp], [t(x) for x in mn])
    assert rt.gram.shape == (6, 6) and torch.equal(rt.gram, rt.gram.T)
    ratio = ticp.obs_ratio(rt.gram)
    assert 1e-6 < float(rj.obs_ratio) < 1.0
    np.testing.assert_allclose(float(ratio), float(rj.obs_ratio), rtol=1e-4)
    flat = ticp.obs_ratio(torch.eye(6)[None] * torch.tensor([1.0, 0.0])[:, None, None])
    batched = ticp.obs_ratio(torch.stack([rt.gram, torch.eye(6), 2 * rt.gram]))
    assert torch.equal(flat, torch.tensor([1.0, 0.0]))
    assert torch.equal(batched[0], ratio) and float(batched[1]) == 1.0
    np.testing.assert_allclose(float(batched[2]), float(ratio), rtol=1e-6)


def refuse_eigvalsh(*args, **kw):
    raise AssertionError("torch.linalg.eigvalsh called on a stepping path")


@pytest.mark.parametrize("kind", ["block", "dense", "slam_chunk"])
def test_steps_never_call_eigvalsh(jax_run, monkeypatch, kind):
    """The step's ICP no longer computes eigenvalues that no stepping
    caller reads (the JAX package's are dropped unread under ``jit``);
    and a SLAM chunk, whose loop detection gates on ``obs_ratio``, takes
    them from the Jacobi solver (``ops/icp.jacobi_eigvals6``, on the card
    the eig6 kernel), not from ``torch.linalg.eigvalsh``."""
    cfg = config_from_reference(jax_run["cfg"])
    cfg = dataclasses.replace(cfg, dense=dataclasses.replace(cfg.dense, dims=(64, 64, 64)))
    monkeypatch.setattr(torch.linalg, "eigvalsh", refuse_eigvalsh)
    if kind == "slam_chunk":
        from topfusion_tpu_torch.models.slam import SlamSystem

        slam = SlamSystem(dataclasses.replace(cfg, posegraph=dataclasses.replace(
            cfg.posegraph, keyframe_every=1, max_keyframes=8, max_edges=16)), device="cpu")
        calls = []
        monkeypatch.setattr(ticp, "obs_ratio_plain",
                            lambda g, f=ticp.obs_ratio_plain: calls.append(g.shape) or f(g))
        infos = slam.process_chunk(torch.from_numpy(jax_run["frames"][:2]))
        assert all(i["ok"] for i in infos) and int(slam.graph.num_kf) == 2
        assert calls == [(2, 2, 4, 6, 6)]  # one batch: 2 queries x 2 starts x 4 candidates
        return
    pipe = (BlockPipeline if kind == "block" else DensePipeline)(cfg, device="cpu")
    state = pipe.init()
    for f in jax_run["frames"][:2]:
        state, aux = pipe.step(state, torch.from_numpy(f))
        assert bool(aux.ok)
    assert int(state.frame) == 2


def test_counters_registry_reads_every_registered_count():
    """``utils/counters``: the counts ``CapturedStep`` carries over its
    replays are the registered ones, the integrate kernel's among them,
    by name; an owner that is collected leaves the registry."""
    import gc

    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda
    from topfusion_tpu_torch.utils import counters

    class Owner:
        hits = 3

    owner = Owner()
    counters.register(owner, "Owner", "hits")
    got = counters.read()
    assert got[(owner, "hits")] == 3
    assert got[(integrate_blocks_cuda, "launches")] == integrate_blocks_cuda.launches
    assert (integrate_blocks_cuda, "vector_launches") in got
    assert counters.name(owner, "hits") == "Owner.hits"
    assert counters.name(integrate_blocks_cuda, "launches") == "integrate_blocks_cuda.launches"
    del owner, got
    gc.collect()
    assert all(type(o).__name__ != "Owner" for o, _ in counters.read())
