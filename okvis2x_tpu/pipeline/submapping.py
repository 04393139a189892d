"""Submapping orchestration: submap lifecycle, integration, alignment edges.

Replaces the reference's `SubmappingInterface` (okvis_multisensor_processing/
src/SubmappingInterface.cpp): consumes depth images / LiDAR sweeps plus
estimator state updates, maintains a collection of keyframe-anchored
occupancy submaps, decides when to spawn a new submap
(≙ `decideNewSubmap`:1611 — overlap fraction / keyframe count), integrates
measurements (≙ `integrateDepth`/`integrateRayBatch`), re-anchors submaps on
state updates (loop-closure correction, :739-745), and produces map-to-map
alignment edges for the estimator (≙ `addSubmapAlignmentFactors`:1703 via
the alignment callback).

The reference runs two std::threads with queues; here each operation is a
host call dispatching fixed-shape device programs — the pipeline decides
when to call (async dispatch provides the overlap).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from okvis2x_tpu.core import se3
from okvis2x_tpu.mapping import icp_factor
from okvis2x_tpu.mapping import submap as sm_mod

# best available float (f64 under x64/CPU validation runs, f32 on the GPU),
# resolved once so pose math never emits truncation warnings
_FDT = jax.dtypes.canonicalize_dtype(jnp.float64)


@dataclasses.dataclass
class SubmappingConfig:
    # grid: dense `SubmapConfig` or brick-sparse `BrickConfig` (fine res)
    submap: object = sm_mod.SubmapConfig()
    # ≙ se2.yaml submap thresholds (config/euroc/se2.yaml:15-25)
    new_submap_overlap: float = 0.1
    new_submap_kf_count: int = 20
    min_frames_integrated: int = 4
    align_points: int = 200  # alignment factor points per submap pair
    sensor_sigma: float = 0.4
    depth_stride: int = 4
    max_depth: float = 20.0

    @classmethod
    def from_se2(cls, se2, pool_bricks: int = 8192) -> "SubmappingConfig":
        """Build the runtime config from a parsed se2.yaml
        (`io.config.SubMapConfig`) honouring the requested `map_res` —
        resolutions finer than a 256^3 dense grid get the brick-sparse
        representation (the reference's 25.6 m @ 0.025 m needs 1024^3,
        config/euroc/se2.yaml:30-32)."""
        extent = max(se2.map_dim)
        res = se2.map_res
        dim = int(round(extent / res))
        lo = se2.data
        # band samples at voxel pitch so fine grids get a painted surface
        band = 0.3
        band_samples = max(8, int(1.5 * band / res) + 1)
        if dim <= 256:
            grid = sm_mod.SubmapConfig(
                dim=dim, res=res,
                log_odd_min=lo.log_odd_min, log_odd_max=lo.log_odd_max,
                surface_band=band, band_samples=band_samples,
            )
        else:
            from okvis2x_tpu.mapping import brick as brick_mod

            b = 8
            grid = brick_mod.BrickConfig(
                table_dim=-(-dim // b), brick=b, res=res,
                pool_bricks=pool_bricks,
                log_odd_min=lo.log_odd_min, log_odd_max=lo.log_odd_max,
                surface_band=band, band_samples=band_samples,
                samples_per_ray=max(48, min(192, int(0.75 * dim / 8))),
            )
        return cls(
            submap=grid,
            new_submap_overlap=se2.submap_overlap_ratio,
            new_submap_kf_count=se2.submap_kf_threshold,
            min_frames_integrated=se2.submap_min_frames,
            align_points=se2.num_submap_factors,
            sensor_sigma=max(se2.sensor_error, 0.01),
            depth_stride=max(1, se2.depth_image_res_downsampling),
            max_depth=se2.far_plane if se2.far_plane > 0 else 20.0,
        )


@dataclasses.dataclass
class SubmapEntry:
    sid: int
    anchor_fid: int  # keyframe id anchoring T_WK
    sm: sm_mod.Submap
    n_frames: int = 0
    kf_ids: set = dataclasses.field(default_factory=set)
    finished: bool = False
    # per-voxel colour accumulation (≙ se::OccupancyColIdMap, built when
    # a colour image accompanies the depth integration)
    col: object = None


class SubmappingInterface:
    """Host orchestration of occupancy submaps."""

    def __init__(
        self,
        cfg: SubmappingConfig,
        align_callback: Optional[Callable] = None,
    ):
        self.cfg = cfg
        self.maps: List[SubmapEntry] = []
        self._next_sid = 0
        self.align_callback = align_callback
        self._jit = {}

    @property
    def active(self) -> Optional[SubmapEntry]:
        return self.maps[-1] if self.maps else None

    # ------------------------------------------------------------- lifecycle
    def _overlap_fraction(self, entry: SubmapEntry, pts_K: np.ndarray) -> float:
        """Fraction of points landing in already-observed voxels of the
        submap (≙ evaluateDepthOverlap/evaluateLidarOverlap)."""
        if len(pts_K) == 0:
            return 0.0
        key = "overlap"
        if key not in self._jit:
            cfg = self.cfg.submap

            @jax.jit
            def f(sm, pts):
                seen = sm_mod.observed_mask(sm, cfg, pts)
                return jnp.sum(seen) / pts.shape[0]

            self._jit[key] = f
        return float(self._jit[key](entry.sm, jnp.asarray(pts_K, jnp.float32)))

    def decide_new_submap(
        self, kf_fid: int, T_WK: np.ndarray, pts_W: np.ndarray
    ) -> bool:
        """(≙ decideNewSubmap) — new when none, anchor changed & overlap too
        low, or too many keyframes integrated."""
        a = self.active
        if a is None:
            return True
        if a.n_frames < self.cfg.min_frames_integrated:
            return False
        if kf_fid in a.kf_ids:
            return False
        if len(a.kf_ids) > self.cfg.new_submap_kf_count:
            return True
        pts_K = self._to_submap_frame(a, pts_W)
        return self._overlap_fraction(a, pts_K) < self.cfg.new_submap_overlap

    def start_submap(self, kf_fid: int, T_WK: np.ndarray) -> SubmapEntry:
        if self.active is not None:
            self.finish_submap()
        e = SubmapEntry(
            sid=self._next_sid,
            anchor_fid=kf_fid,
            sm=sm_mod.new_submap(np.asarray(T_WK, np.float64), self.cfg.submap),
        )
        self._next_sid += 1
        self.maps.append(e)
        return e

    def finish_submap(self):
        a = self.active
        if a is None or a.finished:
            return
        a.finished = True
        if self.align_callback is not None and len(self.maps) >= 2:
            edge = self.make_alignment_edge(self.maps[-2], a)
            if edge is not None:
                self.align_callback(edge)

    def _to_submap_frame(self, entry: SubmapEntry, pts_W: np.ndarray):
        T_KW = se3.se3_inverse(entry.sm.T_WK)
        return np.asarray(
            se3.se3_apply(T_KW, jnp.asarray(pts_W, jnp.float32))
        )

    # ------------------------------------------------------------ integrate
    def integrate_lidar(
        self,
        kf_fid: int,
        T_WK: np.ndarray,
        T_WS: np.ndarray,
        pts_S: np.ndarray,
        sigma: float | np.ndarray = 0.1,
    ):
        """Integrate a (deskewed, downsampled) LiDAR sweep measured at pose
        T_WS into the active submap (spawning one if needed)."""
        pts_W = np.asarray(
            se3.se3_apply(jnp.asarray(T_WS, jnp.float32), jnp.asarray(pts_S, jnp.float32))
        )
        if self.decide_new_submap(kf_fid, T_WK, pts_W):
            self.start_submap(kf_fid, T_WK)
        a = self.active
        T_KS = np.asarray(
            se3.se3_multiply(
                se3.se3_inverse(jnp.asarray(a.sm.T_WK)), jnp.asarray(T_WS, _FDT)
            )
        )
        origin_K = jnp.asarray(T_KS[:3], jnp.float32)
        end_K = se3.se3_apply(
            jnp.asarray(T_KS, jnp.float32), jnp.asarray(pts_S, jnp.float32)
        )
        sm_new = self._integrate_rays_fn(len(pts_S))(
            a.sm, origin_K, end_K, jnp.ones(len(pts_S), bool),
            jnp.asarray(sigma, jnp.float32),
        )
        a.sm = sm_new
        a.n_frames += 1
        a.kf_ids.add(kf_fid)

    def _integrate_rays_fn(self, n: int):
        ncap = 256
        while ncap < n:
            ncap *= 2
        key = ("rays", ncap)
        if key not in self._jit:
            cfg = self.cfg.submap

            @jax.jit
            def f(sm, origin, end, valid, sigma):
                return sm_mod.integrate_rays(sm, cfg, origin, end, valid, sigma)

            self._jit[key] = f
        fn = self._jit[key]

        def run(sm, origin, end, valid, sigma):
            pad = ncap - end.shape[0]
            if pad:
                end = jnp.concatenate([end, jnp.zeros((pad, 3), end.dtype)])
                valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])
            return fn(sm, origin, end, valid, sigma)

        return run

    def integrate_depth(
        self,
        kf_fid: int,
        T_WK: np.ndarray,
        T_WC: np.ndarray,
        cam,
        depth: np.ndarray,
        sigma: Optional[np.ndarray] = None,
        colour: Optional[np.ndarray] = None,
    ):
        """Integrate a metric depth image taken at camera pose T_WC.

        `colour` (H, W) grey or (H, W, 3) rgb in [0, 1] additionally
        splats per-ray colour into the endpoint voxels (≙ the colour warp
        into se::OccupancyColIdMap integration,
        okvis_multisensor_processing/src/SubmappingInterface.cpp:848-888;
        enable per camera via okvis2.yaml camera_type rgb/rgb+depth)."""
        if sigma is None:
            sigma = 0.01 * depth * depth  # quadratic depth noise model
        # decide on sparse sample of the backprojected cloud
        from okvis2x_tpu.cameras import pinhole

        H, W = depth.shape
        s = self.cfg.depth_stride * 4
        ys, xs = np.mgrid[0:H:s, 0:W:s]
        uv = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64)
        d = depth[::s, ::s].ravel()
        ray, ok = pinhole.back_project(cam, jnp.asarray(uv))
        p_C = np.asarray(ray) / np.asarray(ray)[:, 2:3] * d[:, None]
        good = np.asarray(ok) & (d > 0.05) & (d < self.cfg.max_depth)
        pts_W = np.asarray(
            se3.se3_apply(jnp.asarray(T_WC, jnp.float32), jnp.asarray(p_C[good], jnp.float32))
        )
        if self.decide_new_submap(kf_fid, T_WK, pts_W):
            self.start_submap(kf_fid, T_WK)
        a = self.active
        T_KC = np.asarray(
            se3.se3_multiply(
                se3.se3_inverse(jnp.asarray(a.sm.T_WK)), jnp.asarray(T_WC, _FDT)
            )
        )
        key = ("depth", depth.shape)
        if key not in self._jit:
            scfg = self.cfg.submap
            stride = self.cfg.depth_stride
            maxd = self.cfg.max_depth

            @jax.jit
            def f(sm, T_KC_, depth_, sigma_):
                return sm_mod.integrate_depth_image(
                    sm, scfg, cam, T_KC_, depth_, sigma_,
                    stride=stride, max_depth=maxd,
                )

            self._jit[key] = f
        a.sm = self._jit[key](
            a.sm, jnp.asarray(T_KC, jnp.float32),
            jnp.asarray(depth, jnp.float32), jnp.asarray(sigma, jnp.float32),
        )
        a.n_frames += 1
        a.kf_ids.add(kf_fid)

        if colour is not None:
            from okvis2x_tpu.mapping import colour as col_mod

            if a.col is None:
                a.col = col_mod.new_store(self.cfg.submap)
            if colour.ndim == 2:
                colour = np.repeat(colour[..., None], 3, axis=2)
            ckey = ("colour", depth.shape)
            if ckey not in self._jit:
                scfg = self.cfg.submap
                stride = self.cfg.depth_stride
                maxd = self.cfg.max_depth

                @jax.jit
                def fc(store, sm, T_KC_, depth_, col_):
                    from okvis2x_tpu.cameras import pinhole

                    H, W = depth_.shape
                    uv = jnp.stack(
                        jnp.meshgrid(
                            jnp.arange(0, W, stride, dtype=depth_.dtype),
                            jnp.arange(0, H, stride, dtype=depth_.dtype),
                            indexing="xy",
                        ),
                        axis=-1,
                    ).reshape(-1, 2)
                    d = depth_[::stride, ::stride].reshape(-1)
                    c = col_[::stride, ::stride].reshape(-1, 3)
                    ray, bp_ok = pinhole.back_project(cam, uv)
                    p_C = ray / ray[..., 2:3] * d[:, None]
                    p_K = se3.se3_apply(T_KC_, p_C)
                    ok = bp_ok & (d > 0.05) & (d < maxd) & jnp.isfinite(d)
                    return col_mod.splat(store, sm, scfg, p_K, c, ok)

                self._jit[ckey] = fc
            a.col = self._jit[ckey](
                a.col, a.sm, jnp.asarray(T_KC, jnp.float32),
                jnp.asarray(depth, jnp.float32),
                jnp.asarray(colour, jnp.float32),
            )

    # ------------------------------------------------------------ alignment
    def make_alignment_edge(
        self, a: SubmapEntry, b: SubmapEntry
    ) -> Optional[dict]:
        """Map-to-map alignment: register submap b's occupied voxels against
        submap a's field, summarised as a relative-pose edge between the two
        anchor keyframes (≙ addSubmapAlignmentFactors + updateAlignBlocks)."""
        cfgs = self.cfg.submap
        centers, occ = sm_mod.occupied_point_list(
            b.sm, cfgs, max_points=max(4096, self.cfg.align_points)
        )
        occ_np = np.asarray(occ)
        if occ_np.sum() < 20:
            return None
        pts_Kb = np.asarray(centers)[occ_np]
        if len(pts_Kb) > self.cfg.align_points:
            sel = np.random.default_rng(0).choice(
                len(pts_Kb), self.cfg.align_points, replace=False
            )
            pts_Kb = pts_Kb[sel]
        npts = self.cfg.align_points
        pts = np.zeros((npts, 3), np.float32)
        valid = np.zeros(npts, bool)
        pts[: len(pts_Kb)] = pts_Kb
        valid[: len(pts_Kb)] = True

        key = ("align", npts)
        if key not in self._jit:
            sigma = self.cfg.sensor_sigma

            @jax.jit
            def f(sm_a, T_WA, T_WB, pts_, valid_):
                return icp_factor.make_alignment_edge(
                    sm_a, cfgs, T_WA, T_WB, pts_, valid_, sigma
                )

            self._jit[key] = f
        T_AB, sqrt_info, strength = self._jit[key](
            a.sm, jnp.asarray(a.sm.T_WK, jnp.float32),
            jnp.asarray(b.sm.T_WK, jnp.float32),
            jnp.asarray(pts), jnp.asarray(valid),
        )
        if not np.isfinite(float(strength)) or float(strength) < 1.0:
            return None
        return dict(
            i=a.anchor_fid, j=b.anchor_fid,
            T_ij=np.asarray(T_AB, np.float64),
            sqrt_info=np.asarray(sqrt_info, np.float64),
        )

    # ------------------------------------------------------------- updates
    def on_state_update(self, states: Dict[int, np.ndarray]):
        """Re-anchor submaps whose anchor keyframe moved (loop-closure
        correction, ≙ SubmappingInterface.cpp:739-745)."""
        for e in self.maps:
            if e.anchor_fid in states:
                e.sm = e.sm._replace(
                    T_WK=jnp.asarray(states[e.anchor_fid], e.sm.T_WK.dtype)
                )

    # -------------------------------------------------------------- export
    def export_occupied_ply(self, path: str, threshold: float = 1.0):
        """Write all submaps' occupied voxel centres (world frame) as PLY;
        per-vertex RGB when colour was integrated (≙ OccupancyColIdMap
        exports)."""
        all_pts, all_cols = [], []
        any_colour = any(e.col is not None for e in self.maps)
        for e in self.maps:
            centers, occ = sm_mod.occupied_point_list(
                e.sm, self.cfg.submap, threshold, max_points=65536
            )
            pts_K = np.asarray(centers)[np.asarray(occ)]
            if len(pts_K):
                pts_W = np.asarray(
                    se3.se3_apply(
                        jnp.asarray(e.sm.T_WK, jnp.float32),
                        jnp.asarray(pts_K, jnp.float32),
                    )
                )
                all_pts.append(pts_W)
                if any_colour:
                    if e.col is not None:
                        from okvis2x_tpu.mapping import colour as col_mod

                        c = np.asarray(col_mod.colour_at(
                            e.col, e.sm, self.cfg.submap,
                            jnp.asarray(pts_K, jnp.float32),
                        ))
                    else:
                        c = np.full((len(pts_K), 3), 0.5)
                    all_cols.append(c)
        pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3))
        cols = (
            np.clip(np.concatenate(all_cols) * 255, 0, 255).astype(np.uint8)
            if any_colour and all_cols else None
        )
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n" f"element vertex {len(pts)}\n"
                    "property float x\nproperty float y\nproperty float z\n")
            if cols is not None:
                f.write("property uchar red\nproperty uchar green\n"
                        "property uchar blue\n")
            f.write("end_header\n")
            for i, p in enumerate(pts):
                if cols is not None:
                    f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                            f"{cols[i,0]} {cols[i,1]} {cols[i,2]}\n")
                else:
                    f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        return len(pts)

    def export_mesh_ply(self, path: str, entry: SubmapEntry,
                        iso: float = 0.0) -> int:
        """Marching-tetrahedra mesh of one submap (world frame), with
        per-vertex RGB when colour was integrated (≙ per-submap
        map->mesh() export, SubmappingInterface.cpp:935 + colour ids)."""
        from okvis2x_tpu.mapping import mesh as mesh_mod

        tris_K = mesh_mod.submap_mesh(entry.sm, self.cfg.submap, iso)
        if len(tris_K) == 0:
            mesh_mod.write_ply_mesh(path, tris_K)
            return 0
        verts_K = tris_K.reshape(-1, 3)
        cols = None
        if entry.col is not None:
            from okvis2x_tpu.mapping import colour as col_mod

            cols = np.asarray(col_mod.colour_at(
                entry.col, entry.sm, self.cfg.submap,
                jnp.asarray(verts_K, jnp.float32),
            ))
        verts_W = np.asarray(se3.se3_apply(
            jnp.asarray(entry.sm.T_WK, jnp.float32),
            jnp.asarray(verts_K, jnp.float32),
        ))
        mesh_mod.write_ply_mesh(
            path, verts_W.reshape(-1, 3, 3), colours=cols
        )
        return len(tris_K)

    def export_vtk_bboxes(self, path: str):
        """Write submap bounding boxes as a legacy-VTK unstructured grid
        (≙ SubmappingUtils' VTK bbox export / tools okvis_to_vtk.sh):
        one hexahedron per submap, corners in world frame."""
        from okvis2x_tpu.core import se3
        import jax.numpy as jnp

        D = float(self.cfg.submap.dim) * float(self.cfg.submap.res)
        pts = []
        cells = []
        for entry in self.maps:
            T_WK = jnp.asarray(np.asarray(entry.sm.T_WK))
            base = len(pts)
            # submap-local corners: the grid is centred on the keyframe
            for dz in (-D / 2, D / 2):
                for dy in (-D / 2, D / 2):
                    for dx in (-D / 2, D / 2):
                        c = se3.se3_apply(T_WK, jnp.asarray([dx, dy, dz]))
                        pts.append(np.asarray(c))
            # VTK_HEXAHEDRON ordering
            o = base
            cells.append(
                [o + 0, o + 1, o + 3, o + 2, o + 4, o + 5, o + 7, o + 6]
            )
        with open(path, "w") as f:
            f.write("# vtk DataFile Version 3.0\n")
            f.write("okvis2x_tpu submap bounding boxes\nASCII\n")
            f.write("DATASET UNSTRUCTURED_GRID\n")
            f.write(f"POINTS {len(pts)} float\n")
            for p in pts:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
            f.write(f"CELLS {len(cells)} {len(cells) * 9}\n")
            for c in cells:
                f.write("8 " + " ".join(str(i) for i in c) + "\n")
            f.write(f"CELL_TYPES {len(cells)}\n")
            for _ in cells:
                f.write("12\n")
        return path
