"""Typed configuration for the PyTorch/CUDA SLAM pipeline.

The port's own copy of `gl_slam_tpu/config.py` (the port imports nothing of
the JAX package), plus the micro and flagship pipeline presets and model
shapes of `gl_slam_tpu/train/e2e.py`.

Replaces the reference's compile-time constant blob
(`/root/reference/src/core/slam_types.cpp:5-47`) with one frozen dataclass that
is CLI/file-overridable. Defaults reproduce the reference values exactly so
parity runs are like-for-like (SURVEY.md §5.6, §7 parity checklist).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Feature extraction / matching budget.

    Reference: SuperPoint budget `src/core/slam_core.cpp:80-87` (2048 kpts,
    score thr 0.1, 376x1241 input); LightGlue dynamic N in [1, 2048]
    (`src/core/lightglue.cpp:64-74`).
    """

    image_height: int = 376
    image_width: int = 1241
    max_keypoints: int = 2048
    descriptor_dim: int = 256
    score_threshold: float = 0.1
    nms_radius: int = 4
    # LightGlue-style matcher
    match_threshold: float = 0.7          # slam_types.cpp:5 (match_thr)
    map_match_threshold: float = 0.7      # slam_types.cpp:6 (map_match_thr)
    # Matcher for the 2nd/3rd per-frame passes (map-window + covisibility
    # synthetic keypoint sets): "lightglue" = reference parity (LightGlue
    # runs 3x per frame, thread_pool.cpp:110,140 + slam_core.cpp:527);
    # "mutual_nn" = cheap approximation on raw descriptors.
    reobs_matcher: str = "lightglue"
    matcher_layers: int = 9
    # 2 heads (head_dim 128) fill the MXU's 128-wide contraction; measured
    # 28% faster than 4 heads (head_dim 64) at identical FLOPs on v5e.
    matcher_heads: int = 2
    matcher_dim: int = 256
    # Sub-pixel refinement (Keypt2Subpx-style), patch size around keypoint.
    # Source "image" = intensity-weighted centroid on the raw image patch
    # (the reference's Keypt2Subpx also consumes image patches,
    # keypt2subpx.cpp:170-245); "heat" = centroid on the detector heatmap.
    subpix_patch: int = 7
    subpix_source: str = "image"


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    """Two-view geometry / RANSAC parameters.

    Reference: essential USAC_MAGSAC p=0.9999 thr=0.5 px
    (`src/core/slam_core.cpp:146`), PnP RANSAC 1000 iters 1.8 px conf 0.999
    (`src/core/slam_core.cpp:635-638`).
    """

    essential_threshold_px: float = 0.5
    essential_confidence: float = 0.9999
    essential_hypotheses: int = 512       # vmapped hypotheses (fixed, TPU-friendly)
    essential_sample_size: int = 8        # 8-point algorithm per hypothesis
    # IRLS polish iterations on the winning hypothesis. 6 matches the
    # adaptive USAC_MAGSAC's typical local-optimization effort on automotive
    # motion (its 1000-iteration cap is rarely approached); quality at this
    # setting is pinned by the e2e ATE test, and each extra iteration costs
    # ~0.07 ms of serial latency inside the tracking scan.
    essential_refine_iters: int = 6
    pnp_threshold_px: float = 1.8
    pnp_hypotheses: int = 512
    pnp_sample_size: int = 6              # 6-point DLT per hypothesis
    # Triangulation filters (triangulate_and_filter_3d_points,
    # slam_core.cpp:173-256; thresholds thread_pool.cpp:43,230)
    max_depth: float = 100.0
    triangulation_reproj_bootstrap_px: float = 0.5
    triangulation_reproj_px: float = 0.1
    # Minimum triangulation (ray) angle; points below it have noise-
    # dominated depth that random-walks the monocular scale. 0 = reference
    # parity (no such gate); see geometry/triangulation.py.
    min_parallax_deg: float = 0.0
    # Association reprojection gate: after the pose-only solve, drop any
    # 3D-2D re-observation whose reprojection error at the SOLVED pose
    # exceeds this (px); the pose is then re-polished on the surviving set
    # (gate_refine_iters LM iterations) before map insertion. This is the
    # outlier-association firewall between the matcher and the observation
    # table: the reference relies on its matcher's precision plus Cauchy
    # losses and post-BA culling (`slam_core.cpp:977-1038`), but a
    # wrong-landmark match that enters the obs ring still drags the window
    # BA until culling catches it — gating at the solved pose removes it
    # before it is ever recorded. 0 = gate off (exact reference dataflow).
    reobs_max_reproj_px: float = 4.0
    gate_refine_iters: int = 10


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Bundle-adjustment parameters.

    Reference: pose-only BA <=30 iters Cauchy(1.0)
    (`src/core/slam_core.cpp:1092-1140`); full BA window=7 (+3 overlap),
    <=30 iters, Cauchy(1.0), first two cameras fixed
    (`src/core/slam_core.cpp:744-883`, `src/core/slam_types.cpp:8-9`).
    """

    pose_only_iters: int = 30
    pose_only_cauchy_scale: float = 1.0
    # Robust-scale annealing prologue for the pose-only LM: this many extra
    # iterations at `pose_only_cauchy_scale * pose_only_coarse_mult` before
    # the Cauchy(1.0) fine stage. Rescues ~3-5 deg-off starts (two-view
    # rotation/translation ambiguity basins) that saturate Cauchy(1.0); 0
    # disables (exact reference shape). slam/pose_ba.py.
    pose_only_coarse_iters: int = 8
    pose_only_coarse_mult: float = 8.0
    # Age-based confidence for the pose-only solve: associations to map
    # points YOUNGER than `pose_young_age` keyframes (i.e. whose depths have
    # not yet been refined by a window BA) are down-weighted by
    # `pose_young_weight`. Under every-frame keyframing, fresh points
    # otherwise dominate the association set and close a scale feedback
    # loop — LM step sets fresh depths, fresh depths set the next LM step —
    # that compounds between BA passes (round-3 diag: an 8-frame sawtooth
    # in step/gt ratios growing until divergence). 1.0 disables.
    pose_young_age: int = 8
    pose_young_weight: float = 0.2
    # Points created more than this many keyframes BEFORE the BA window's
    # first camera are held FIXED in the window solve (anchors): they still
    # constrain the window cameras through their residuals, but their
    # positions no longer move. Freely re-optimizing old points from their
    # few in-window observations drags the long-lived anchors onto the
    # newest pose epoch every pass and erases the map's drift-restoring
    # memory (measured ~7x worse end drift on the zero-noise closed
    # circle, scripts/diag_circle.py round 4). The margin lets each point
    # be depth-refined across a couple of overlapping windows first.
    point_freeze_margin: int = 8
    full_ba_window: int = 7               # slam_types.cpp:8 (Full_ba_window_size)
    full_ba_overlap: int = 3              # slam_types.cpp:9
    full_ba_iters: int = 30
    full_ba_cauchy_scale: float = 1.0
    gauge_fixed_cameras: int = 2          # slam_core.cpp:829-838
    # LM damping schedule
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 10.0
    lm_lambda_down: float = 0.1
    # Early-stop: end the solve after 2 consecutive iterations improving
    # the robust cost by less than this relative amount (Ceres-style
    # function_tolerance; the reference's 30 iters is a cap, slam_core.cpp:846)
    lm_rel_tol: float = 1e-4
    # Fixed capacities for the jitted BA step (padded shapes)
    max_window_cameras: int = 16          # window 7 + overlap 3 + slack
    max_window_points: int = 8192
    max_window_obs: int = 32768


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Map bookkeeping / covisibility / culling parameters.

    Reference: covisibility edge thr 50, K1=20, K2=50, top-5 neighbours,
    <=2048 retrieved mpids (`src/core/slam_types.cpp:16-27`); culling obs<3 or
    mean reproj > 1.0 px (`src/core/slam_types.cpp:42-43`); map re-observation
    window 20 keyframes (`src/core/slam_types.cpp` map_match_window).
    """

    map_match_window: int = 20            # get_matches_from_previous_frames
    covis_edge_threshold: int = 50
    covis_k1: int = 20                    # top-N1 observer keyframes
    covis_k2: int = 50                    # global top-N2 after neighbour expansion
    covis_top_neighbors: int = 5
    covis_max_points: int = 2048
    use_covis_retrieval: bool = True
    # Re-observation pass structure: "separate" = reference parity — the
    # map-window synthetic pass (slam_core.cpp:428-541, vs the PREVIOUS
    # pose) and the covisibility synthetic pass (slam_core.cpp:1149-1340,
    # vs the predicted pose) each run their own matcher, i.e. LightGlue 3x
    # per frame. "merged" = one union candidate pool (window ∪ covisibility
    # expansion) projected at the predicted pose and matched ONCE — 2x
    # LightGlue per frame, saving a full matcher pass of the hot loop; the
    # candidate set is the same points the two reference passes reach, so
    # re-observation coverage is preserved (asserted by the merged-mode
    # tracking test). "batched" = both passes keep their own candidate
    # pools and projection poses but run as ONE batch-2 matcher program
    # (reobserve.match_batched): same two candidate sets as "separate",
    # half the serial attention chains — the only semantic delta is that
    # the covis pool no longer excludes window-pass hits (the merge still
    # prioritizes them).
    reobs_mode: str = "separate"
    cull_min_obs: int = 3
    cull_max_reproj_px: float = 1.0
    cull_enabled: bool = True             # slam_types.cpp:15 (cull_map_points)
    # Fixed capacities for device-resident map state (SoA arrays)
    max_keyframes: int = 8192
    max_points: int = 262144
    max_obs_per_point: int = 16
    # Slot recycling (state.recycle_free_slots, run at BA cadence): culled
    # points idle for > recycle_min_age keyframes release their table slots
    # for reuse. The reference's map grows unboundedly in host RAM
    # (slam_types.h:8-127); fixed device tables recycle instead so KITTI-00
    # length sequences (4,541 frames) never starve the point table. The age
    # must exceed every backward-reaching window: map re-observation (20),
    # BA window+overlap (10), and one async-BA trigger period.
    recycle_enabled: bool = True
    recycle_min_age: int = 32
    recycle_budget: int = 16384
    # Keyframe feature database for loop-closure detection
    # (state.MapState.kf_db_*): each keyframe stores its top
    # `loop_db_keypoints` keypoints-with-3D (row index into the keyframe's
    # keypoint table, the keypoint's descriptor, and a 3D snapshot). Loop
    # detection matches the CURRENT frame against a retrieved old
    # keyframe's stored features — ordinary frame-pair matching, the
    # regime the gap-1/2-trained matcher covers — instead of the map-point
    # archive (whose aged descriptors are unmatchable by either mutual-NN
    # or the learned matcher: scripts/diag_loop_matcher.py round 5, 0 GT
    # agreements even on a true-pairs-only candidate set).
    loop_db_keypoints: int = 256
    # LRU eviction under capacity pressure (state.recycle_free_slots):
    # healthy points unobserved for this many keyframes become evictable
    # when <2x recycle_budget slots remain. Culling alone cannot sustain a
    # fixed table (it only marks window-born points, slam_core.cpp:977);
    # without eviction the round-3 soak's table filled at ~frame 330 and
    # every later insert silently dropped. 0 disables.
    recycle_stale_age: int = 64
    # Storage dtype of the (Pmax, D) map-point descriptor table; bf16 halves
    # its HBM traffic (matching matmuls still accumulate in f32)
    desc_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Host loop / parity-mode switches.

    Reference parity notes (SURVEY.md §7): GT scale injection at bootstrap
    (`thread_pool.cpp:39`), GT motion gate (`thread_pool.cpp:78-96`,
    mag 0.05 m / rot 0.3 deg), the `skip=false` override making every frame a
    keyframe (`thread_pool.cpp:237`), BA trigger every 7 new keyframes
    (`thread_pool.cpp:248-252`).
    """

    use_gt_scale: bool = True             # monocular scale from GT at bootstrap
    use_gt_motion_gate: bool = True
    gt_mag_filter: float = 0.05           # slam_types.cpp (mag_filter)
    gt_rot_filter: float = 0.3            # degrees (rot_filter)
    every_frame_keyframe: bool = True     # the skip=false override
    tracker: str = "essential"            # "essential" (C3 flow) | "pnp" (C20)
    ba_trigger_keyframes: int = 7
    run_pose_ba: bool = True              # gates per-frame pose-only BA (slam_types.cpp:14)
    run_full_ba: bool = True              # gates the sliding-window backend BA
    # Frame acceptance: reject a frame whose post-LM mean Cauchy cost per
    # 3D-2D point exceeds this (LM stalled / bad associations — inserting
    # such a pose corrupts the map; slam/frontend.py step 7). Default inf =
    # gate OFF: the reference keeps tracking through high-residual frames
    # (its only skip paths are low-count cerr+continue, slam_core.cpp:558-562)
    # and the threshold is backend-sensitive — CPU vs TPU numerics land
    # different mean costs for identical code, so a TPU-tuned finite value
    # silently drops frames on CPU. Opt in per run when a quality gate is
    # wanted; the pipeline-level NaN health check covers catastrophes.
    pose_accept_mean_cost: float = float("inf")
    # Soft-reject fallback (reference parity, thread_pool.cpp:237): when the
    # map-anchored pose solve is NOT trustworthy (too few 3D-2D points, mean
    # cost above gate, or a step wildly off the constant-velocity magnitude)
    # the frame is still inserted — with the essential-chained odometry pose
    # instead of the LM result — so tracking degrades to visual odometry
    # rather than freezing (a frozen state can never rebuild the map: the
    # round-3 tiny soak died permanently after one excursion). False =
    # reject-and-freeze (the pre-round-3 behavior, kept for ablation).
    soft_reject_fallback: bool = True
    # LM-step sanity bound for the soft trust decision: the solved step
    # magnitude must lie within [1/r, r] x the carried step magnitude.
    # 2.0: frame-to-frame speed does not double at camera rate; the round-3
    # tiny-soak divergence was a 3.9x step sneaking under a 4.0 bound.
    pose_step_max_ratio: float = 2.0
    async_ba: bool = True                 # backend BA dispatched async
    # NaN health-check + rollback at BA cadence (SURVEY §5.3) — both the
    # per-frame pipeline and the chunked driver honour it
    health_check: bool = True
    # Loop closing (C21 — the reference declared the stage but left
    # `loop_closing.h` empty; here it is built and ON by default). A
    # detection must pass covisibility-consistency voting AND PnP
    # verification before a correction is applied, so on loop-free
    # sequences the stage is inert (and before `loop_min_gap` keyframes
    # exist the host skips the check entirely). The flag is honoured by
    # the per-frame TrackingPipeline AND the chunked drivers
    # (slam/chunk_driver.py periodic host-side hook at BA cadence).
    loop_closing: bool = True
    loop_check_interval: int = 20
    loop_min_gap: int = 50
    # Detection gates: minimum REGION-consistent hit count, and the minimum
    # share of all hits that land in the winning temporal region (or its
    # covisibility neighbourhood). The vote histogram is box-smoothed over
    # +/- loop_region_radius keyframes before the argmax: the old-point
    # pool is a continuous trail, so a true revisit spreads its votes over
    # a temporal REGION, never a single keyframe (slam/loopclose.py). The
    # share floor is deliberately modest — mutual-NN over a 8192-candidate
    # pool produces aliased background hits roughly uniformly over the
    # trail — and the PnP RANSAC verification (>=30 inliers at 1.8 px on
    # region-consistent 3D points) remains the decisive geometric gate.
    # The share floor is small by design: a genuine revisit region's hits
    # are a minority of all hits (the aliasing base rate over a large stale
    # pool supplies the rest); the density-normalized region rate and the
    # PnP verification carry the discrimination.
    loop_min_votes: int = 20
    loop_consistency_frac: float = 0.05
    loop_region_radius: int = 6
    # Keyframe-database detection (detect_loop_db): candidate old keyframes
    # are retrieved by pose proximity under the current estimate — centre
    # within `loop_detect_radius` metres AND viewing direction within
    # `loop_detect_max_angle_deg` — then verified by frame-pair matching +
    # PnP on the stored 3D snapshots. The radius bounds the detectable
    # drift (a closure exists to correct drift smaller than the retrieval
    # radius); `loop_candidates` keyframes are matched per check, best PnP
    # inlier count wins.
    loop_detect_radius: float = 12.0
    loop_detect_max_angle_deg: float = 45.0
    loop_candidates: int = 2
    # Correction blast radius: the pose-graph window spans the LAST
    # `pose_graph_window` keyframes before the detection target. Short by
    # design (round-5 measurement, scripts/diag_loop_*): distributing a
    # closure over the whole revisited lap re-shapes accurately-tracked
    # mid-trajectory keyframes with drifted odometry as the only prior —
    # on the 420-frame circle the least-squares optimum OSCILLATES the
    # middle to 1.5x its pre-correction error even with an exact dense GN
    # solve (the drifted edges carry BA-cadence-correlated errors that two
    # true anchors amplify). A short window (arc << 180 deg, benign chord
    # geometry) aligns the ACTIVE segment to the old map — restoring the
    # tracking frame, which is what bounds forward drift — and repeated
    # re-detections keep the tail pinned; map-wide retro-correction is
    # global BA's job, which the reference never built either
    # (include/core/loop_closing.h empty).
    pose_graph_window: int = 64
    prefetch_depth: int = 2               # double-buffered frame feed
    dtype: str = "bfloat16"               # model compute dtype
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset description (KITTI odometry layout).

    Reference loader: `src/core/slam_core.cpp:38-76` (calib P0 -> 3x3 K,
    poses file -> 4x4 GT), frame naming `src/threading/thread_pool.cpp:6-10`.
    """

    dataset_root: Optional[str] = None
    sequence: str = "00"
    first_frame: int = 0
    last_frame: int = 4540                # slam_types.cpp:12 (max_idx)
    grayscale: bool = True


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh / multi-stream scale-out (SURVEY.md §2.3, §5.8).

    The one real parallelism axis of this workload is data-parallel over
    concurrent sequences: `num_streams` sequences are batched per chip and the
    batch is sharded over the `data` mesh axis (BASELINE configs[4]).
    """

    num_streams: int = 16
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    geometry: GeometryConfig = dataclasses.field(default_factory=GeometryConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)


def default_config() -> SLAMConfig:
    return SLAMConfig()


def tiny_test_config() -> SLAMConfig:
    """Small shapes for unit tests on the 8-device virtual CPU mesh."""
    return SLAMConfig(
        frontend=FrontendConfig(
            image_height=48, image_width=64, max_keypoints=128,
            descriptor_dim=64, matcher_layers=2, matcher_heads=2,
            matcher_dim=64,
        ),
        geometry=GeometryConfig(essential_hypotheses=64, pnp_hypotheses=64),
        ba=BAConfig(max_window_cameras=8, max_window_points=256,
                    max_window_obs=1024, full_ba_iters=10, pose_only_iters=10),
        map=MapConfig(max_keyframes=64, max_points=4096, covis_max_points=128),
    )


# ---------------------------------------------------------------------------
# Model shapes of the committed checkpoints and the pipeline presets
# (copied from gl_slam_tpu/train/e2e.py)

# The tiny-preset model shapes the committed checkpoints were trained with
# (train res 160x240; the nets are fully convolutional).
TINY_SP_CHANNELS = (16, 16, 32, 32, 32, 32, 64, 64)
TINY_DESC_DIM = 64
TINY_LG = dict(dim=64, heads=2, layers=2)

# Flagship shapes: 2048 keypoints, 256-d descriptors at 376x1241, 9 attention
# layers with 2 heads of 128 dims. Inference pads 1241 -> 1248.
FLAGSHIP_SP_CHANNELS = (64, 64, 64, 64, 128, 128, 128, 128)
FLAGSHIP_DESC_DIM = 256
FLAGSHIP_LG = dict(dim=256, heads=2, layers=9)


def micro_config(H: int, W: int, N: int, D: int) -> SLAMConfig:
    """Pipeline config tuned for the small rendered scenes (learned
    detections carry ~0.5-1 px error, so thresholds are wider than the
    reference's sub-pixel-refined settings)."""
    return SLAMConfig(
        frontend=FrontendConfig(
            image_height=H, image_width=W, max_keypoints=N,
            descriptor_dim=D, score_threshold=0.02, nms_radius=3,
            match_threshold=0.4, map_match_threshold=0.4,
            reobs_matcher="lightglue"),
        geometry=GeometryConfig(
            essential_hypotheses=128, essential_refine_iters=5,
            essential_threshold_px=0.75, max_depth=35.0,
            triangulation_reproj_px=0.5,
            triangulation_reproj_bootstrap_px=1.0),
        ba=BAConfig(max_window_cameras=12, max_window_points=2048,
                    full_ba_iters=30, pose_only_iters=30,
                    full_ba_overlap=4),
        map=MapConfig(max_keyframes=64, max_points=8192,
                      covis_max_points=256, covis_edge_threshold=10),
    )


def flagship_config(H: int = 376, W: int = 1241) -> SLAMConfig:
    """Pipeline config at the reference's deployed shapes (N=2048, D=256)
    with the geometry thresholds of the JAX flagship preset."""
    return SLAMConfig(
        frontend=FrontendConfig(
            image_height=H, image_width=W, max_keypoints=2048,
            descriptor_dim=FLAGSHIP_DESC_DIM, score_threshold=5e-4,
            nms_radius=4, match_threshold=0.6, map_match_threshold=0.6,
            reobs_matcher="lightglue"),
        geometry=GeometryConfig(
            essential_hypotheses=256, essential_refine_iters=6,
            essential_threshold_px=0.75,
            triangulation_reproj_px=1.5,
            triangulation_reproj_bootstrap_px=1.5,
            reobs_max_reproj_px=3.0),
        ba=BAConfig(max_window_cameras=12, max_window_points=4096,
                    full_ba_iters=30, pose_only_iters=30,
                    full_ba_overlap=3),
        map=MapConfig(max_keyframes=512, max_points=65536,
                      covis_max_points=1024, cull_max_reproj_px=2.0),
    )
