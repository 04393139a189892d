"""okvis2x_tpu — a JAX visual-inertial SLAM framework for one GPU.

A from-scratch JAX/XLA re-design of the capabilities of OKVIS2-X
(multi-sensor keyframe-based VI-SLAM with factor-graph backend, dense
submapping, LiDAR/GNSS fusion).  Not a port: state lives in fixed-capacity
struct-of-arrays, the Ceres solver is replaced by a batched Gauss-Newton /
Levenberg-Marquardt optimiser with on-device Schur-complement landmark
elimination, the frontend (detection, binary description, Hamming
matching) runs as fixed-shape XLA programs, and distribution is expressed
with `jax.sharding` meshes + collectives instead of threads.

Layer map (mirrors reference layers documented in SURVEY.md §1):
  core/      — SE(3)/quaternion math, time, dtypes           (~ okvis_kinematics, okvis_time)
  cameras/   — camera + distortion models, rigs              (~ okvis_cv)
  imu/       — IMU preintegration                            (~ okvis_ceres ImuError propagation)
  factors/   — residual/Jacobian definitions                 (~ okvis_ceres error terms)
  solver/    — batched GN/LM + Schur complement              (~ ceres-solver)
  graph/     — sliding-window estimator, marginalisation,
               pose graph                                    (~ ViGraph/ViSlamBackend)
  frontend/  — detection, description, matching, RANSAC,
               triangulation, BoW place recognition          (~ okvis_frontend, brisk, DBoW2, opengv)
  mapping/   — occupancy submaps, integration, ICP factors   (~ okvis_mapping, supereight2)
  parallel/  — meshes, shardings, distributed reduction      (new capability)
  io/        — config, dataset readers, trajectory output    (~ okvis_common, dataset readers)
  pipeline/  — per-frame orchestration                       (~ okvis_multisensor_processing)
  models/    — depth / segmentation networks                 (~ okvis_deep_learning)
  utils/     — timing, logging
"""

__version__ = "0.1.0"
