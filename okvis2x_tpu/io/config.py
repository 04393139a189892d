"""Configuration loaders for the okvis2.yaml and se2.yaml schemas.

Replaces the reference's `ViParametersReader` (okvis_common/src/
ViParametersReader.cpp) and `se::SubMapConfig` (okvis_mapping/include/okvis/
config_mapping.hpp:27-106): reads the same YAML schemas (OpenCV FileStorage
flavour — the leading `%YAML:x.y` directive is stripped, the rest is plain
YAML) so existing configs under the reference's config/* work unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from okvis2x_tpu.cameras import distortion as dist
from okvis2x_tpu.cameras import pinhole
from okvis2x_tpu.core import se3
from okvis2x_tpu.imu.preintegration import ImuParams

import jax.numpy as jnp

_DIST_NAMES = {
    "radialtangential": dist.RADTAN,
    "radialtangential8": dist.RADTAN8,
    "equidistant": dist.EQUIDISTANT,
    "none": dist.NONE,
    "eucm": "eucm",
}


@dataclasses.dataclass
class CameraConfig:
    """One rig camera (≙ okvis::CameraCalibration, Parameters.hpp:38-52)."""

    T_SC: np.ndarray  # (7,) [t, q_xyzw]
    camera: pinhole.Camera
    slam_use: str = "okvis"  # okvis | okvis-depth | okvis-virtual | none
    camera_type: str = "gray"  # gray | rgb | gray+depth | rgb+depth

    @property
    def is_colour(self) -> bool:
        """≙ CameraType::isColour (ViParametersReader.cpp:555-561,
        NCameraSystem.hpp:202): colour submap integration source."""
        return self.camera_type.startswith("rgb")

    @property
    def has_depth(self) -> bool:
        return "depth" in self.camera_type


@dataclasses.dataclass
class OnlineCalibrationParams:
    """≙ CameraParameters::OnlineCalibrationParameters
    (okvis_common/include/okvis/Parameters.hpp:70-80)."""

    do_extrinsics: bool = False
    do_extrinsics_final_ba: bool = False
    sigma_r: float = 0.001
    sigma_alpha: float = 0.005
    sigma_r_final_ba: float = 0.001
    sigma_alpha_final_ba: float = 0.005


@dataclasses.dataclass
class CameraParams:
    """≙ okvis::CameraParameters (Parameters.hpp:59-82)."""

    timestamp_tolerance: float = 0.005
    sync_cameras: Tuple[int, ...] = ()
    stereo_indices: Tuple[int, ...] = ()  # deep_stereo_indices
    image_delay: float = 0.0
    fov_scale: float = 1.0
    online_calibration: OnlineCalibrationParams = dataclasses.field(
        default_factory=OnlineCalibrationParams
    )


@dataclasses.dataclass
class FrontendConfig:
    """≙ okvis::FrontendParameters (Parameters.hpp:110-120)."""

    detection_threshold: float = 38.0
    absolute_threshold: float = 150.0
    matching_threshold: float = 60.0
    octaves: int = 0
    max_num_keypoints: int = 700
    keyframe_overlap: float = 0.6
    use_cnn: bool = False
    parallelise_detection: bool = True
    num_matching_threads: int = 1


@dataclasses.dataclass
class EstimatorParams:
    """≙ okvis::EstimatorParameters (Parameters.hpp:125-140)."""

    num_keyframes: int = 5
    num_loop_closure_frames: int = 3
    num_imu_frames: int = 3
    do_loop_closures: bool = True
    do_final_ba: bool = True
    enforce_realtime: bool = False
    realtime_min_iterations: int = 3
    realtime_max_iterations: int = 10
    realtime_time_limit: float = 0.035
    realtime_num_threads: int = 1
    full_graph_iterations: int = 15
    full_graph_num_threads: int = 1
    p_dbow: float = 0.4
    drift_percentage_heuristic: float = 1.35


@dataclasses.dataclass
class OutputConfig:
    """≙ okvis::OutputParameters (Parameters.hpp:145-150)."""

    display_topview: bool = False
    display_matches: bool = False
    display_overhead: bool = False
    enable_submapping: bool = False


@dataclasses.dataclass
class GpsConfig:
    """≙ okvis::GpsParameters (Parameters.hpp:154-167); parsed from the
    optional `gps_parameters:` map (ViParametersReader.cpp:358-367,632)."""

    data_type: str = "cartesian"  # cartesian | geodetic | geodetic-leica
    r_SA: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )  # IMU -> antenna lever arm [m]
    yaw_error_threshold: float = 0.0  # [deg] max yaw error for init
    robust_gps_init: bool = False


@dataclasses.dataclass
class LidarConfig:
    """≙ okvis::LidarParameters (Parameters.hpp:171-177); parsed from the
    optional `lidar:` map (ViParametersReader.cpp:224-237,613)."""

    T_SL: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, 0, 0, 0, 0, 1.0])
    )
    elevation_resolution_angle: float = 0.0
    azimuth_resolution_angle: float = 0.0


@dataclasses.dataclass
class ViConfig:
    """≙ okvis::ViParameters (Parameters.hpp:181-193)."""

    cameras: List[CameraConfig]
    imu: ImuParams
    frontend: FrontendConfig
    estimator: EstimatorParams
    T_BS: np.ndarray  # (7,)
    g0: np.ndarray  # initial gyro bias
    a0: np.ndarray  # initial accel bias
    image_delay: float = 0.0
    imu_use: bool = True
    s_a: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3)
    )  # accelerometer scale factors
    camera: CameraParams = dataclasses.field(default_factory=CameraParams)
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)
    gps: Optional[GpsConfig] = None
    lidar: Optional[LidarConfig] = None


def _T_from_mat44(vals) -> np.ndarray:
    M = np.asarray(vals, dtype=np.float64).reshape(4, 4)
    q = np.asarray(se3.matrix_to_quat(jnp.asarray(M[:3, :3])))
    return np.concatenate([M[:3, 3], q])


def _load_yaml(path: str) -> dict:
    import yaml  # only config files need PyYAML, not the pipeline

    with open(path) as f:
        text = f.read()
    lines = [l for l in text.splitlines() if not l.startswith("%YAML")]
    return yaml.safe_load("\n".join(lines))


def load(path: str, dtype=jnp.float64) -> ViConfig:
    doc = _load_yaml(path)

    cams = []
    for c in doc.get("cameras", []):
        fx, fy = c["focal_length"]
        cx, cy = c["principal_point"]
        w, h = c["image_dimension"]
        if c.get("cam_model", "pinhole") == "eucm":
            # EUCM (ViParametersReader.cpp:531-551): alpha/beta in
            # eucm_parameters, no additional distortion
            cam = pinhole.make_pinhole(
                fx, fy, cx, cy, w, h, model="eucm",
                dist_params=c["eucm_parameters"], dtype=dtype,
            )
        else:
            model = _DIST_NAMES[c.get("distortion_type", "none")]
            cam = pinhole.make_pinhole(
                fx, fy, cx, cy, w, h, model=model,
                dist_params=c.get("distortion_coefficients", []),
                dtype=dtype,
            )
        cams.append(
            CameraConfig(
                T_SC=_T_from_mat44(c["T_SC"]),
                camera=cam,
                slam_use=c.get("slam_use", "okvis"),
                camera_type=c.get("camera_type", "gray"),
            )
        )

    ip = doc.get("imu_parameters", {})
    imu = ImuParams(
        sigma_g=float(ip.get("sigma_g_c", 12e-4)),
        sigma_a=float(ip.get("sigma_a_c", 8e-3)),
        sigma_gw=float(ip.get("sigma_gw_c", 4e-6)),
        sigma_aw=float(ip.get("sigma_aw_c", 4e-5)),
        g=float(ip.get("g", 9.81007)),
        rate=float(ip.get("rate", 200.0)),
        g_max=float(ip.get("g_max", 7.8)),
        a_max=float(ip.get("a_max", 176.0)),
        sigma_bg=float(ip.get("sigma_bg", 0.03)),
        sigma_ba=float(ip.get("sigma_ba", 0.1)),
    )

    fp = doc.get("frontend_parameters", {})
    frontend = FrontendConfig(
        detection_threshold=float(fp.get("detection_threshold", 38.0)),
        absolute_threshold=float(fp.get("absolute_threshold", 150.0)),
        matching_threshold=float(fp.get("matching_threshold", 60.0)),
        octaves=int(fp.get("octaves", 0)),
        max_num_keypoints=int(fp.get("max_num_keypoints", 700)),
        keyframe_overlap=float(fp.get("keyframe_overlap", 0.6)),
        use_cnn=bool(fp.get("use_cnn", False)),
        parallelise_detection=bool(fp.get("parallelise_detection", True)),
        num_matching_threads=int(fp.get("num_matching_threads", 1)),
    )

    ep = doc.get("estimator_parameters", {})
    est = EstimatorParams(
        num_keyframes=int(ep.get("num_keyframes", 5)),
        num_loop_closure_frames=int(ep.get("num_loop_closure_frames", 3)),
        num_imu_frames=int(ep.get("num_imu_frames", 3)),
        do_loop_closures=bool(ep.get("do_loop_closures", True)),
        do_final_ba=bool(ep.get("do_final_ba", True)),
        enforce_realtime=bool(ep.get("enforce_realtime", False)),
        realtime_min_iterations=int(ep.get("realtime_min_iterations", 3)),
        realtime_max_iterations=int(ep.get("realtime_max_iterations", 10)),
        realtime_time_limit=float(ep.get("realtime_time_limit", 0.035)),
        realtime_num_threads=int(ep.get("realtime_num_threads", 1)),
        full_graph_iterations=int(ep.get("full_graph_iterations", 15)),
        full_graph_num_threads=int(ep.get("full_graph_num_threads", 1)),
        p_dbow=float(ep.get("p_dbow", 0.4)),
        drift_percentage_heuristic=float(
            ep.get("drift_percentage_heuristic", 1.35)
        ),
    )

    T_BS = (
        _T_from_mat44(ip["T_BS"]) if "T_BS" in ip
        else np.array([0, 0, 0, 0, 0, 0, 1.0])
    )

    cp = doc.get("camera_parameters", {})
    ocp = cp.get("online_calibration", {}) or {}
    online = OnlineCalibrationParams(
        do_extrinsics=bool(ocp.get("do_extrinsics", False)),
        do_extrinsics_final_ba=bool(ocp.get("do_extrinsics_final_ba", False)),
        sigma_r=float(ocp.get("sigma_r", 0.001)),
        sigma_alpha=float(ocp.get("sigma_alpha", 0.005)),
        sigma_r_final_ba=float(ocp.get("sigma_r_final_ba", 0.001)),
        sigma_alpha_final_ba=float(ocp.get("sigma_alpha_final_ba", 0.005)),
    )
    camera_params = CameraParams(
        timestamp_tolerance=float(cp.get("timestamp_tolerance", 0.005)),
        sync_cameras=tuple(int(i) for i in cp.get("sync_cameras", [])),
        stereo_indices=tuple(
            int(i) for i in cp.get("deep_stereo_indices", [])
        ),
        image_delay=float(cp.get("image_delay", 0.0)),
        fov_scale=float(cp.get("fov_scale", 1.0)),
        online_calibration=online,
    )

    op = doc.get("output_parameters", {})
    output = OutputConfig(
        display_topview=bool(op.get("display_topview", False)),
        display_matches=bool(op.get("display_matches", False)),
        display_overhead=bool(op.get("display_overhead", False)),
        enable_submapping=bool(op.get("enable_submapping", False)),
    )

    gps = None
    gp = doc.get("gps_parameters")
    if isinstance(gp, dict):
        gps = GpsConfig(
            data_type=str(gp.get("data_type", "cartesian")),
            r_SA=np.asarray(gp.get("r_SA", [0, 0, 0]), np.float64),
            yaw_error_threshold=float(gp.get("yaw_error_threshold", 0.0)),
            robust_gps_init=bool(gp.get("robust_gps_init", False)),
        )

    lidar = None
    lp = doc.get("lidar")
    if isinstance(lp, dict):
        lidar = LidarConfig(
            T_SL=(
                _T_from_mat44(lp["T_SL"]) if "T_SL" in lp
                else np.array([0, 0, 0, 0, 0, 0, 1.0])
            ),
            elevation_resolution_angle=float(
                lp.get("elevation_resolution_angle", 0.0)
            ),
            azimuth_resolution_angle=float(
                lp.get("azimuth_resolution_angle", 0.0)
            ),
        )

    return ViConfig(
        cameras=cams,
        imu=imu,
        frontend=frontend,
        estimator=est,
        T_BS=T_BS,
        g0=np.asarray(ip.get("g0", [0, 0, 0]), np.float64),
        a0=np.asarray(ip.get("a0", [0, 0, 0]), np.float64),
        image_delay=camera_params.image_delay,
        imu_use=bool(ip.get("use", True)),
        s_a=np.asarray(ip.get("s_a", [1, 1, 1]), np.float64),
        camera=camera_params,
        output=output,
        gps=gps,
        lidar=lidar,
    )


# --------------------------------------------------------------------------
# se2.yaml — submapping / occupancy-map configuration
# --------------------------------------------------------------------------


@dataclasses.dataclass
class OccupancyDataConfig:
    """Occupancy-fusion parameters (≙ se2.yaml `data:` section consumed by
    supereight2's `se::Config::readYaml`; defaults follow
    config/euroc/se2.yaml `data:`)."""

    surface_boundary: float = 0.0
    min_occupancy: float = -100.0
    max_occupancy: float = 100.0
    log_odd_min: float = -5.015
    log_odd_max: float = 5.015
    fs_integr_scale: int = 1
    const_surface_thickness: bool = False
    uncertainty_model: str = "quadratic"  # linear | quadratic
    tau_min_factor: float = 3.0
    tau_max_factor: float = 12.0
    k_tau: float = 0.02
    sigma_min_factor: float = 1.0
    sigma_max_factor: float = 20.0
    k_sigma: float = 0.05


@dataclasses.dataclass
class SubMapConfig:
    """≙ se::SubMapConfig (okvis_mapping/include/okvis/config_mapping.hpp:
    27-106) + the map geometry from the `map:` section."""

    results_directory: str = "./"
    write_mesh_output: bool = False
    sensor_measurement_downsampling: int = 1
    depth_image_res_downsampling: int = 1
    submap_kf_threshold: int = 5
    submap_overlap_ratio: float = 0.4
    submap_min_frames: int = 1
    use_map_to_map_factors: bool = False
    use_map_to_live_factors: bool = False
    num_submap_factors: int = 200
    voxel_grid_resolution: float = 0.1
    sensor_error: float = 0.01
    use_uncertainty: bool = False
    depth_scaling_factor: float = 1.0
    near_plane: float = 0.1
    far_plane: float = 5.0
    # map: section
    map_dim: Tuple[float, float, float] = (25.6, 25.6, 25.6)
    map_res: float = 0.025
    data: OccupancyDataConfig = dataclasses.field(
        default_factory=OccupancyDataConfig
    )


def load_submap_config(path: str) -> SubMapConfig:
    """Parse an se2.yaml (general/map/data sections; the same file the
    reference feeds to both `se::SubMapConfig::readYaml` and supereight2)."""
    doc = _load_yaml(path)
    g = doc.get("general", {}) or {}
    m = doc.get("map", {}) or {}
    d = doc.get("data", {}) or {}

    data = OccupancyDataConfig(
        surface_boundary=float(d.get("surface_boundary", 0.0)),
        min_occupancy=float(d.get("min_occupancy", -100.0)),
        max_occupancy=float(d.get("max_occupancy", 100.0)),
        log_odd_min=float(d.get("log_odd_min", -5.015)),
        log_odd_max=float(d.get("log_odd_max", 5.015)),
        fs_integr_scale=int(d.get("fs_integr_scale", 1)),
        const_surface_thickness=bool(
            d.get("const_surface_thickness", False)
        ),
        uncertainty_model=str(d.get("uncertainty_model", "quadratic")),
        tau_min_factor=float(d.get("tau_min_factor", 3.0)),
        tau_max_factor=float(d.get("tau_max_factor", 12.0)),
        k_tau=float(d.get("k_tau", 0.02)),
        sigma_min_factor=float(d.get("sigma_min_factor", 1.0)),
        sigma_max_factor=float(d.get("sigma_max_factor", 20.0)),
        k_sigma=float(d.get("k_sigma", 0.05)),
    )

    dim = m.get("dim", [25.6, 25.6, 25.6])
    return SubMapConfig(
        results_directory=str(g.get("results_directory", "./")),
        write_mesh_output=bool(g.get("write_mesh_output", False)),
        sensor_measurement_downsampling=int(
            g.get("sensor_measurement_downsampling", 1)
        ),
        depth_image_res_downsampling=int(
            g.get("depth_image_resolution_downsampling", 1)
        ),
        submap_kf_threshold=int(g.get("submap_kf_threshold", 5)),
        submap_overlap_ratio=float(g.get("submap_overlap_ratio", 0.4)),
        submap_min_frames=int(g.get("submap_min_frames", 1)),
        use_map_to_map_factors=bool(g.get("use_map_to_map_factors", False)),
        use_map_to_live_factors=bool(
            g.get("use_map_to_live_factors", False)
        ),
        num_submap_factors=int(g.get("n_factors_per_state", 200)),
        voxel_grid_resolution=float(g.get("voxel_grid_resolution", 0.1)),
        sensor_error=float(g.get("sensor_error", 0.01)),
        use_uncertainty=bool(g.get("use_uncertainty", False)),
        depth_scaling_factor=float(g.get("depth_scaling_factor", 1.0)),
        near_plane=float(g.get("near_plane", 0.1)),
        far_plane=float(g.get("far_plane", 5.0)),
        map_dim=tuple(float(x) for x in dim),
        map_res=float(m.get("res", 0.025)),
        data=data,
    )
