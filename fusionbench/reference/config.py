# Frozen copy of topfusion_tpu_torch/config.py at commit 81038a6, the yardstick's plain reference.
"""Configuration dataclasses of the PyTorch port.

A field-for-field mirror of ``topfusion_tpu/config.py`` in plain Python,
so that one config tree drives both packages (``convert.config_from_reference``
carries a JAX-side config across; ``tests/test_torch_config.py`` keeps the
two trees identical).  It is a copy, not an import: importing anything
from ``topfusion_tpu`` loads jax, which the GPU machine does not have.

The only field whose meaning is port-specific is
``BlockMapConfig.use_pallas_integrate``: here it selects the hand-written
CUDA integrate kernel (``ops/cuda/integrate.py``), see its comment.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics at pyramid level 0.

    Mirrors ``Intr`` (reference: tfusion/include/tfusion/types.hpp:20-27)
    including the per-level scaling convention ``f / 2**level``
    (reference: tfusion/src/precomp.cpp:10-14).
    """

    width: int = 640
    height: int = 480
    # Live values from TopFuParams::default_params (reference: topfu.cpp:47).
    fx: float = 504.261
    fy: float = 503.905
    cx: float = 352.457
    cy: float = 272.202

    def at_level(self, level: int) -> "CameraConfig":
        div = 1 << level
        return dataclasses.replace(
            self,
            width=self.width // div,
            height=self.height // div,
            fx=self.fx / div,
            fy=self.fy / div,
            cx=self.cx / div,
            cy=self.cy / div,
        )

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass(frozen=True)
class PreprocConfig:
    """Depth preprocessing (reference: tfusion/src/cuda/imgproc.cu).

    Defaults mirror TopFuParams::default_params
    (reference: tfusion/src/topfu.cpp:28-35).
    """

    bilateral_kernel_size: int = 7
    bilateral_sigma_spatial: float = 4.5       # pixels
    bilateral_sigma_depth: float = 0.04        # meters
    depth_truncation: float = 2.0              # meters; >this -> invalid
    pyramid_levels: int = 3
    # Pyramid downsample rejects neighbours farther than 3*sigma_depth from
    # the centre (reference: imgproc.cu:118-131).
    pyramid_sigma_depth: float = 0.04
    # Max sensor range treated as valid by computeDists
    # (reference: imgproc.cu:277 — >=2047 mm -> invalid).
    max_sensor_depth: float = 2.046
    # Reference-exact bilateral/pyramid support: invalid (zero) neighbours
    # participate and the window is positional (reference:
    # imgproc.cu:25-45, 111-131).  Default False = quality fix (invalid
    # neighbours excluded).  Used by the parity A/B
    # (scripts/parity_ab.py, tests/test_parity.py).
    reference_edge_semantics: bool = False


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Projective point-to-plane ICP
    (reference: tfusion/src/projective_icp.cpp, tfusion/src/cuda/proj_icp.cu).
    """

    # Coarse-to-fine iterations, entry L = iters at pyramid level L
    # (reference: topfu.cpp:14 {10, 5, 4, 0}).
    iters: Tuple[int, ...] = (10, 5, 4)
    dist_threshold: float = 0.1                # meters (reference: topfu.cpp:32)
    angle_threshold_deg: float = 30.0          # degrees (reference: topfu.cpp:31)
    # Levenberg damping added to JtJ diagonal; the reference solves the raw
    # system with SVD instead (reference: projective_icp.cpp:205) — damping is
    # the jit-friendly way to survive near-singular systems in-graph.
    damping: float = 1e-6
    # Declare tracking failed when the determinant of JtJ falls below this
    # (reference fails on singular/NaN systems, projective_icp.cpp:197-203).
    min_det: float = 1e-14
    # Minimum number of gated correspondences for a valid solve.
    min_corresp: int = 30
    # Bilinear (sub-pixel) gather of model maps during association on ALL
    # levels; nearest is 4x fewer gathers.  On noiseless synthetic scenes
    # nearest is accuracy-neutral, but under sensor noise nearest-only
    # association measurably degrades vs the reference-semantics run
    # (parity A/B, docs/RESULTS.md) — bilinear_finest recovers it at a
    # fraction of the cost.
    bilinear: bool = False
    # Bilinear association on the LAST N iterations of the finest level
    # only (everything else stays nearest): the polish iterations set the
    # converged pose, so sub-pixel association there recovers
    # reference-run accuracy under sensor noise (parity A/B ratio 1.32 ->
    # ~1.0, docs/RESULTS.md) at ~1/3 the cost of whole-level bilinear.
    # Coarse-level bilinear measures WORSE (smears depth discontinuities
    # at low resolution) — don't turn `bilinear` on for accuracy.
    bilinear_polish_iters: int = 3
    # Extra row subsampling (on top of level0_stride) for the polish
    # iterations: sub-pixel association quality is per-row and the 6x6
    # system stays over-determined at 1/16 of VGA rows, so the polish
    # costs ~1/4 of full-stride bilinear.
    polish_stride: int = 2
    # Model-map gather implementation: "flat" = flattened 8-channel-aligned
    # row gather (fastest measured on v5e, exact), "onehot" = banded
    # one-hot matmul on the MXU (ops/gather_mm.py), "take" = plain XLA
    # fancy indexing (exact semantic reference).  onehot implies nearest
    # association and drops correspondences displaced vertically by more
    # than onehot_v_margin pixels (projective locality bound).
    gather_mode: str = "flat"
    onehot_v_margin: int = 32
    # Stride over level-0 pixels when building the normal equations; the
    # 6x6 system is massively over-determined at VGA (300k rows), so a
    # stride of 2 (4x fewer gathers) costs no accuracy.
    level0_stride: int = 2

    @property
    def angle_threshold_cos(self) -> float:
        return math.cos(math.radians(self.angle_threshold_deg))


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    """TSDF volume semantics (reference: SceneParams, tfusion/src/topfu.cpp:50).

    Fusion rule: running weighted average with weight clamp, one-sided
    truncation (skip eta < -mu)
    (reference: tfusion/include/tfusion/cuda/SceneReconstructionEngine.hpp:23-71).
    """

    voxel_size: float = 0.005                  # meters
    trunc_dist: float = 0.02                   # mu, meters
    max_weight: float = 100.0
    stop_integrating_at_max_weight: bool = False
    view_frustum_min: float = 0.2              # meters
    view_frustum_max: float = 3.0              # meters
    # Color fusion (the reference's Voxel_*_rgb trait variants become a
    # config flag; fusion rule mirrors computeUpdatedVoxelColorInfo,
    # reference: SceneReconstructionEngine.hpp:116-148).  Color voxels are
    # stored as float RGB in [0, 1] alongside the TSDF.
    use_color: bool = False


@dataclasses.dataclass(frozen=True)
class DenseVolumeConfig:
    """Fixed dense grid (BASELINE.md config 1; resurrects the reference's
    legacy kinfu dense path, reference: tfusion/src/internal.hpp:31-51)."""

    dims: Tuple[int, int, int] = (256, 256, 256)
    # World-space position of voxel (0,0,0) corner, meters.
    origin: Tuple[float, float, float] = (-0.64, -0.64, 0.0)


@dataclasses.dataclass(frozen=True)
class BlockMapConfig:
    """Block-sparse voxel map capacities.

    The reference's voxel block hash (8^3 blocks, 2^20 ordered buckets +
    2^17 excess entries, 2^16 allocatable blocks; reference:
    tfusion/include/tfusion/cuda/VoxelBlockHash.hpp:10-27) is re-designed
    as a sorted key table + slot indirection (see ops/blockmap.py); the
    only capacities that remain are the pool size and per-frame bounds.
    """

    block_size: int = 8                        # voxels per side (SDF_BLOCK_SIZE)
    capacity: int = 1 << 16                    # max live blocks (SDF_LOCAL_BLOCK_NUM)
    max_new_blocks_per_frame: int = 4096       # bound on per-frame allocation
    max_visible_blocks: int = 1 << 14          # bound on per-frame visible set
    # Packed signed block coordinates use this many bits per axis (coords in
    # [-2**(bits-1), 2**(bits-1))); 10 bits -> +-512 blocks = +-20.5 m at 5 mm.
    coord_bits: int = 10
    # Integrate through the fused CUDA kernel wrapper
    # (ops/cuda/integrate.integrate_blocks_cuda) instead of the plain
    # PyTorch gather/fuse/scatter path (ops/tsdf_block.integrate_blocks).
    # None or True: the wrapper, which launches the kernel on CUDA
    # tensors and runs the plain version on CPU tensors.  False: the
    # plain reference path everywhere (reference_exact_config).
    use_pallas_integrate: bool | None = None
    # Allocation DDA sampling: pixel stride and fixed step count over the
    # depth+-mu segment (reference marches ceil(2|p1-p0|) steps,
    # SceneReconstructionEngine.hpp:237-241; we use a fixed masked count).
    # Defaults give ~10 mm sample spacing at 2 m — 4x denser than the
    # 40 mm block size — at 1/8 the candidate volume of stride 2/steps 8
    # (the candidate sort+lookup is a top-5 per-frame cost).
    alloc_pixel_stride: int = 4
    alloc_steps: int = 4
    # Visible-set maintenance by AGING (last frame's visible list + this
    # frame's allocation-touched blocks, frustum re-checked) instead of a
    # full O(capacity) pool scan per frame — the reference's visible-list
    # shape (setToType3, SceneReconstructionEngine_host.cu:343-348).
    # Free-view renders and post-reset refreshes always full-rescan.
    visible_aging: bool = True
    # Occlusion-cull the per-frame visible set against the OBSERVED
    # depth (ops/tsdf_block._block_occlusion_mask): blocks entirely
    # beyond every valid depth sample in their footprint receive zero
    # voxel updates by the fusion rule (eta < -mu skips) and are
    # occluded for splatting, so the working set shrinks from "frustum
    # band" to "observable band" — and the PADDED max_visible_blocks
    # bound (which every integrate/splat gather/sort/scatter scales
    # with) can drop accordingly.  Exact for integration by
    # construction; conservative for model maps (max-pool + 3x3 tile
    # dilation bounds the footprint).  Default OFF: the reference keeps
    # occluded aged entries in its visible list, and at tiny test frame
    # sizes the model-map change measurably perturbs thrash-adjacent
    # loop-closure scenarios; the VGA product surfaces (bench.py,
    # apps/run_fusion.py) turn it on.
    visible_occlusion_cull: bool = False
    # The aged set structurally misses blocks that RE-ENTER the frustum
    # without being depth-touched (occluded band, truncated range,
    # alloc-stride gaps) — measured collapse on a backward dolly through
    # mapped territory (tests/test_swap.py).  A periodic in-graph full
    # rescan (lax.cond, every N frames) bounds that staleness; amortized
    # cost = O(capacity / N) per frame.
    visible_rescan_every: int = 8
    # Out-of-core block pool: spill cold blocks (LRU by last-visible
    # frame) to a host store and restore them on frustum re-entry — the
    # GlobalCache analogue (reference scaffold: GlobalCache.hpp:22-134,
    # never enabled there).  Effective scene capacity becomes host RAM;
    # ops/swap.py + models/host_cache.py; wired through SlamSystem and
    # apps/run_fusion.py (--set blockmap.out_of_core=true).
    out_of_core: bool = False
    # Voxel pool storage dtype; all arithmetic stays float32
    # (codec: ops/blockmap.decode_/encode_tsdf/weight).
    #   "float32"  — plain storage;
    #   "int16"    — FIXED-POINT tsdf/color (x32767), weights as exact
    #                integers: the reference's actual Voxel_s encoding
    #                (VoxelTypes.hpp:69-92) — halves pool HBM traffic at
    #                ~4.5 significant digits (needs max_weight <= 32767);
    #   "bfloat16" — half-width float: same bandwidth, ~2 significant
    #                digits (weights exact up to 256, so max_weight <= 256).
    pool_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    """Raycaster (reference: VisualisationEngine_Shared.hpp:99-172 castRay)."""

    max_steps: int = 192                       # bound on sphere-march iterations
    # ICP model-map generation: "splat" = forward-project surface voxels
    # (ops/splat.py, scatter-shaped — fastest on TPU), "raycast" = guided
    # sphere march (gather-shaped reference semantics).
    model_maps: str = "splat"
    # Depth-guided model-map raycast: march only a band around the depth
    # image just integrated (the TPU analogue of the reference's
    # expected-depth ranges; see ops/tsdf_block.raycast_blocks).
    guided: bool = True
    guided_max_steps: int = 24
    # Expected-depth min/max image subsample factor
    # (reference: VisualisationEngine_Shared.hpp:7 minmaximg_subsample = 8).
    range_subsample: int = 8
    # Step bound for free-view raycasts driven by the expected-depth
    # range image (ops/tsdf_block.expected_depth_ranges): rays only march
    # the occupied [zmin, zmax] band of their cell, so far fewer lockstep
    # steps cover it than the full-frustum max_steps.
    ranged_max_steps: int = 64
    # Step length multipliers in voxel units (reference: topfu.cpp:41-44
    # raycast_step_factor; castRay steps max(sdf*mu/voxel, 1)).
    min_step_voxels: float = 1.0
    refine_steps: int = 1
    # Splat model maps: surface voxels taken per 8^3 block (a plane
    # crossing a block touches ~bsz^2 * trunc_dist/voxel_size voxels —
    # 256 at the default mu/voxel = 4 band; 128 + one dilation pass is
    # measured accuracy-equivalent at 1.9 vs 1.86 mm and 6 fps faster at
    # VGA) and 3x3 min-dilation passes closing sub-pixel splat holes
    # (ops/splat.py).  Dilation is load-bearing: without it the hole
    # pixels starve ICP of correspondences (measured 200 mm ATE).
    # Round-5 v5e A/B at the VGA operating point: 96 beats 128 at 42.2
    # vs 39.4 bench fps (splat is the step's top line item; scatter/attr
    # volume scales with K) with NO accuracy cost there (40-frame VGA
    # orbit ATE 12.0 vs 12.7 mm) — the dilation pass absorbs the extra
    # sub-pixel holes; 64 is SLOWER than 96 (sub-128-lane shapes).
    # bench.py and apps/run_fusion.py run 96.  The LIBRARY default stays
    # 128: at tiny frame sizes (80x64 test cameras) the sparser maps
    # measurably amplify feedback noise (sharded-vs-single agreement
    # 0.10 -> 1.55 mm; the deliberately thrash-adjacent double-closure
    # test tips over) — choose per operating point.
    surfels_per_block: int = 128
    dilate_passes: int = 1


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """Keyframe pose graph + loop closure (new capability; absent in the
    reference — SURVEY.md section 2.2)."""

    max_keyframes: int = 256
    max_edges: int = 1024
    keyframe_every: int = 10                   # frames
    # Keyframe descriptor = downsampled vertex map level used for loop checks.
    keyframe_level: int = 1
    loop_icp_iters: int = 8
    # Relative information weight of loop edges vs odometry edges: loop
    # measurements come from a single-level keyframe-to-keyframe ICP and
    # are noisier than fused frame-to-model odometry.
    loop_edge_weight: float = 0.25
    loop_candidate_window: int = 5             # recent kfs excluded from loops
    loop_max_dist: float = 0.5                 # meters between kf positions
    # Appearance-aware candidate selection: rank candidates by keyframe
    # descriptor similarity (depth/normal histograms of the stored coarse
    # maps, posegraph.kf_descriptor) under a pose gate widened by
    # loop_appearance_dist_factor.  Pose-only ranking fails exactly when
    # accumulated drift exceeds loop_max_dist — the drifted position of a
    # true revisit falls outside the gate (tests/test_loop_appearance.py
    # constructs that failure).  ICP verification remains the arbiter.
    loop_appearance: bool = True
    loop_appearance_dist_factor: float = 4.0
    # Number of nearest candidate keyframes ICP-verified per loop check
    # (vmapped — constant compile cost); the best verified candidate by
    # inlier count wins.  Revisits at different viewing angles often fail
    # verification against the single nearest keyframe but pass against
    # the 2nd-4th nearest.
    loop_candidates: int = 4
    # Loop verification: maximum mean point-to-plane residual (meters) of
    # the converged candidate ICP.  True same-place revisits converge to
    # sensor-noise scale (mm); a similar-but-DIFFERENT place (same
    # furniture, different layout) converges with residual at the
    # layout-difference scale (~cm) — measured 14.5 mm on the two-rooms
    # false-positive construction vs ~0 on the true revisit
    # (tests/test_loop_false_positive.py).  The previous gate reused
    # huber_delta (0.1 m), far too loose to discriminate.
    loop_max_residual: float = 0.01
    # Loop verification rejects candidates whose converged ICP system is
    # rank-deficient: lambda_min/lambda_max of the 6x6 JtJ must exceed
    # this.  Degenerate geometry (a bare wall, a uniform corridor) lets
    # ICP "converge" from any start along the unobservable direction and
    # would close FALSE loops (measured ~1e-6..1e-12 there vs ~1e-2 on
    # well-constrained revisits; tests/test_loop_false_positive.py).
    loop_min_obs_ratio: float = 1e-4
    # Loop detection examines this many of the NEWEST keyframes per
    # chunk (each against its own candidate set, all vmapped): a revisit
    # the newest keyframe's viewpoint just missed can still close
    # through a slightly older keyframe instead of waiting for cadence
    # luck.  Closed keyframes are skipped (PoseGraph.kf_loop_done).
    loop_queries: int = 2
    gn_iters: int = 10
    damping: float = 1e-5
    huber_delta: float = 0.1
    # Normal-equation solver: "pcg" = matrix-free preconditioned CG on the
    # block-sparse H (cost linear in #edges, scales to K >= 512; the
    # Schur-style scalable path), "dense" = explicit [6K, 6K] solve
    # (exact reference semantics, fine at K <= 256).
    solver: str = "pcg"
    cg_iters: int = 48
    # What happens to the TSDF map after a loop closure moves the
    # keyframes: "reintegrate" = wipe the map and re-fuse the stored
    # keyframe depths at their OPTIMIZED poses (InfiniTAM-v3-style global
    # re-integration; the live pose and model maps re-anchor into the
    # corrected frame, so fusion and the optimized trajectory stay
    # consistent), "none" = map keeps raw odometry, only the exported
    # trajectory is corrected.
    map_correction: str = "reintegrate"
    # Device ring of the last N RAW depth frames (+ their odometry poses
    # and latest-keyframe index) kept for post-loop re-integration: the
    # rebuild re-fuses every ring frame at its per-frame corrected pose,
    # so recent geometry is NOT thinned to the keyframe cadence
    # (round-3 VERDICT missing #4).  Frames older than the ring fall
    # back to the keyframe store.  0 = keyframe-only rebuild.
    # Memory: N x H x W x 2 bytes (u16 depth) — 64 VGA frames = 38 MB.
    reint_ring: int = 0
    # Minimum translation correction (meters) of the newest keyframe that
    # triggers a re-integration.  Corrections smaller than ~2x the TSDF
    # truncation band (trunc_dist = 0.02 by default) are absorbed by the
    # band itself; rebuilding for them only THINS the map (keyframe-only
    # re-fusion) and measurably degrades subsequent frame-to-model
    # tracking — on the 90-frame VGA orbit, reintegrating on every ~15 mm
    # correction ghosts the map (4.9k -> 9.2k blocks) and triples odometry
    # ATE (docs/RESULTS.md round-3 A/B).  Rebuild only when the frame
    # genuinely jumped.
    min_map_correction: float = 0.04


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout for multi-chip execution (new capability)."""

    # Axis names: "map" shards the voxel map / volume, "px" shards image rows.
    map_axis: int = 1
    px_axis: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline config (reference: TopFuParams, topfu.hpp:28-60)."""

    camera: CameraConfig = CameraConfig()
    preproc: PreprocConfig = PreprocConfig()
    icp: ICPConfig = ICPConfig()
    tsdf: TSDFConfig = TSDFConfig()
    dense: DenseVolumeConfig = DenseVolumeConfig()
    blockmap: BlockMapConfig = BlockMapConfig()
    raycast: RaycastConfig = RaycastConfig()
    posegraph: PoseGraphConfig = PoseGraphConfig()
    mesh: MeshConfig = MeshConfig()
    # Reset map + trajectory when ICP diverges (reference: topfu.cpp:263-264).
    reset_on_failure: bool = True
    compute_dtype: str = "float32"

    def __post_init__(self):
        # Compact pool encodings bound the representable fusion weight
        # (ops/blockmap pool codec): int16 stores weights as exact
        # integers <= 32767; bfloat16 is exact only up to 256.  A larger
        # max_weight would silently wrap/round weights — fail loudly at
        # config construction instead (advisor round-3 finding).
        limits = {"int16": 32767.0, "bfloat16": 256.0}
        lim = limits.get(self.blockmap.pool_dtype)
        if lim is not None and self.tsdf.max_weight > lim:
            raise ValueError(
                f"pool_dtype={self.blockmap.pool_dtype!r} stores fusion "
                f"weights exactly only up to {lim:.0f}; tsdf.max_weight="
                f"{self.tsdf.max_weight} would overflow the encoding "
                f"(use float32 storage or lower max_weight)"
            )


def resolve_pallas_integrate(bm: BlockMapConfig, device) -> bool:
    """Whether integration on ``device`` (a ``torch.device`` or its name)
    goes through the CUDA kernel's wrapper
    (``ops/cuda/integrate.integrate_blocks_cuda``) rather than the plain
    ``ops/tsdf_block.integrate_blocks``.  ``use_pallas_integrate`` None
    (auto) means the kernel on a CUDA device and the plain version on the
    CPU, as the JAX package picks Pallas on an accelerator and XLA on the
    CPU.  Any other value but False means the wrapper, which runs the
    plain version on CPU tensors; a typo that the tri-state config parser
    leaves a string (``use_pallas_integrate=flase``) picks the kernel too,
    as the JAX package's ``bool()`` does."""
    if bm.use_pallas_integrate is None:
        return getattr(device, "type", str(device).split(":")[0]) == "cuda"
    return bm.use_pallas_integrate is not False


def default_config() -> PipelineConfig:
    return PipelineConfig()


def reference_exact_config(cfg: PipelineConfig) -> PipelineConfig:
    """Flip every documented fast-mode deviation to its reference-exact
    setting, keeping shapes/capacities untouched.

    This is the "reference algorithm semantics re-expressed in this
    framework" configuration that BASELINE.md's accuracy protocol measures
    against (scripts/parity_ab.py):

      * bilateral/pyramid positional windows incl. invalid neighbours
        (reference: imgproc.cu:25-45, 111-131);
      * per-pixel exact gathers + bilinear association, no level-0 stride
        (reference: proj_icp.cu:80-117, 409-412 texture gathers);
      * ICP model maps by full sphere-march raycast, not splatting
        (reference: CreateICPMaps, VisualisationEngine_CUDA.cu:323-360);
      * plain gather/fuse/scatter integration (the semantic reference
        for the CUDA integrate kernel).
    """
    return dataclasses.replace(
        cfg,
        preproc=dataclasses.replace(
            cfg.preproc, reference_edge_semantics=True
        ),
        icp=dataclasses.replace(
            cfg.icp, gather_mode="take", bilinear=True, level0_stride=1
        ),
        raycast=dataclasses.replace(
            cfg.raycast, model_maps="raycast", guided=False
        ),
        blockmap=dataclasses.replace(
            cfg.blockmap, use_pallas_integrate=False,
            visible_occlusion_cull=False,
        ),
    )


def tiny_test_config() -> PipelineConfig:
    """Small shapes for fast CPU tests."""
    cam = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    return PipelineConfig(
        camera=cam,
        icp=ICPConfig(iters=(4, 3, 2)),
        dense=DenseVolumeConfig(dims=(64, 64, 64), origin=(-0.32, -0.32, 0.3)),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=1 << 12,
            max_new_blocks_per_frame=1024,
            max_visible_blocks=1 << 11,
            alloc_pixel_stride=1,
        ),
        raycast=RaycastConfig(max_steps=96),
    )
