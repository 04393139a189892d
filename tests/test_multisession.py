"""Multi-session mapping: component save/load + relocalisation of a new
session against a loaded map (≙ Frontend::loadComponent building per-
component DBoW databases, okvis_frontend/src/Frontend.cpp:163-201, and the
multi-session place-recognition path Frontend.cpp:813-857)."""

import jax.numpy as jnp
import numpy as np
import pytest

from okvis2x_tpu.cameras import distortion as dist
from okvis2x_tpu.cameras import pinhole
from okvis2x_tpu.core import se3
from okvis2x_tpu.graph import EstimatorConfig, FrameState, SlidingWindowEstimator
from okvis2x_tpu.pipeline.vio import PipelineConfig, VioPipeline


def _cam():
    return pinhole.make_pinhole(
        fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480,
        model=dist.NONE,
    )


def _pipe(seed=0, **cfg_kw):
    cam = _cam()
    est_cfg = EstimatorConfig(cap_frames=6, cap_landmarks=64, cap_obs=128,
                              cap_imu_links=5, cap_rel_edges=8)
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0]])
    return VioPipeline([cam], T_SC, est_cfg,
                       PipelineConfig(vocab_k=32, **cfg_kw))


def _pose(x, yaw=0.0):
    q = np.asarray(se3.delta_q(jnp.asarray([0.0, 0.0, yaw])))
    return np.concatenate([np.array([x, 0.0, 0.0]), q])


def _make_session_a(tmp_path, rng):
    """Session A: a straight 6-keyframe corridor with descriptors +
    landmark snapshots; returns (component path, per-frame data)."""
    pipe = _pipe()
    est = pipe.est
    n, n_kp = 6, 80
    frames = []
    for k in range(n):
        T = _pose(2.0 * k)
        est.archive_frames[k] = FrameState(
            fid=k, timestamp=float(k), T_WS=T.copy(), sb=np.zeros(9),
            is_keyframe=True, pose_graph_frame=True,
        )
        if k:
            T_ij = np.asarray(
                se3.se3_multiply(
                    se3.se3_inverse(jnp.asarray(_pose(2.0 * (k - 1)))),
                    jnp.asarray(T),
                )
            )
            est.archive_edges.append(
                dict(i=k - 1, j=k, T_ij=T_ij, sqrt_info=np.eye(6) * 100.0)
            )
        # landmarks ~5 m ahead of the camera (optical axis = +z, a
        # side-looking corridor as the rig moves along +x)
        pts = np.array([2.0 * k, 0, 5.0]) + rng.normal(
            scale=[2.0, 1.5, 0.8], size=(n_kp, 3)
        )
        packed = rng.integers(0, 2**32, (n_kp, 12), dtype=np.uint64).astype(
            np.uint32
        )
        cam = pipe.cameras[0]
        T_SW = se3.se3_inverse(jnp.asarray(T))
        p_C = np.asarray(
            jnp.stack([se3.se3_apply(T_SW, jnp.asarray(p)) for p in pts])
        )
        uv, ok = pinhole.project(cam, jnp.asarray(p_C))
        uv, ok = np.asarray(uv), np.asarray(ok)
        pipe.kf_records[k] = dict(
            t=float(k), packed=packed, valid=ok.copy(), uv=uv,
            lm_pos=np.where(ok[:, None], pts, np.nan),
            T_WS=T.copy(), path=2.0 * k,
        )
        frames.append(dict(T=T, pts=pts, packed=packed, ok=ok))
    path = str(tmp_path / "session_a.npz")
    pipe.save_component(path)
    return path, frames


def test_component_roundtrip_and_reloc(tmp_path):
    rng = np.random.default_rng(5)
    comp_path, frames_a = _make_session_a(tmp_path, rng)

    pipe = _pipe()
    assert pipe.load_component(comp_path)
    assert pipe.vocab is not None  # bootstrapped from the component
    assert len(pipe.components) == 1
    comp = pipe.components[0]
    assert len(comp["records"]) == 6
    # component nodes entered the pose graph as fixed negative-fid frames
    neg = [f for f in pipe.est.archive_frames if f < 0]
    assert len(neg) == 6
    assert all(pipe.est.archive_frames[f].pose_fixed for f in neg)

    # session B: starts at A's keyframe 3, but its own world frame is
    # offset by 1.5 m lateral + 0.1 rad yaw (inter-session offset)
    k_match = 3
    T_true = frames_a[k_match]["T"]  # pose in the MAP frame
    dT_off = np.asarray(
        se3.se3_multiply(
            jnp.asarray(np.concatenate([[0, 1.5, 0.3], [0, 0, 0, 1.0]])),
            jnp.asarray(
                np.concatenate(
                    [[0, 0, 0], np.asarray(se3.delta_q(jnp.asarray([0, 0, 0.1])))]
                )
            ),
        )
    )
    T_B = np.asarray(
        se3.se3_multiply(jnp.asarray(dT_off), jnp.asarray(T_true))
    )  # what session B believes its pose is
    est = pipe.est
    fid = est.add_state if False else None  # (manual state below)
    f = FrameState(fid=0, timestamp=0.0, T_WS=T_B.copy(), sb=np.zeros(9),
                   is_keyframe=True)
    est.frames.append(f)
    est._next_fid = 1

    # B observes A's frame-3 landmarks from T_true: uv from the TRUE pose,
    # descriptors identical to A's (perfect re-detection)
    rec_a = frames_a[k_match]
    cam = pipe.cameras[0]
    T_SW = se3.se3_inverse(jnp.asarray(T_true))
    p_C = np.asarray(
        jnp.stack([se3.se3_apply(T_SW, jnp.asarray(p)) for p in rec_a["pts"]])
    )
    uv, ok = pinhole.project(cam, jnp.asarray(p_C))
    rec_b = dict(
        t=0.0, packed=rec_a["packed"].copy(),
        valid=np.asarray(ok), uv=np.asarray(uv),
        lm_pos=np.full((len(rec_a["pts"]), 3), np.nan),
        T_WS=T_B.copy(), path=0.0,
    )
    pipe.kf_records[0] = rec_b

    from okvis2x_tpu.frontend import bow, descriptor

    # bow.assign handles both the flat and the (shipped) hierarchical
    # vocabulary — the pipeline now loads resources/vocab_b64l64.npz
    words = np.asarray(
        bow.assign(
            descriptor.unpack_pm1(
                jnp.asarray(rec_b["packed"]), jnp.asarray(rec_b["valid"])
            ),
            pipe.vocab,
        )
    )
    assert pipe._attempt_relocalisation(0, words, rec_b)
    assert pipe.relocalised
    assert pipe.n_relocalisations == 1

    # the session pose is now expressed in the map frame: the 1.5 m / 0.1
    # rad inter-session offset collapses to RANSAC-level accuracy
    T_after = est.get_state(0).T_WS
    err = np.linalg.norm(T_after[:3] - T_true[:3])
    assert err < 0.2, err
    q_err = 2 * np.arccos(
        np.clip(abs(np.dot(T_after[3:7], T_true[3:7])), 0, 1)
    )
    assert q_err < 0.05, q_err


def test_reloc_requires_records(tmp_path):
    pipe = _pipe()
    est = pipe.est
    est.archive_frames[0] = FrameState(
        fid=0, timestamp=0.0, T_WS=_pose(0.0), sb=np.zeros(9),
        is_keyframe=True, pose_graph_frame=True,
    )
    path = str(tmp_path / "bare.npz")
    from okvis2x_tpu.graph import component as comp_mod

    comp_mod.save_component(path, est)  # no records
    pipe_b = _pipe()
    assert not pipe_b.load_component(path)


def test_import_component_frames_remaps_negative():
    est = _pipe().est
    fid_map = est.import_component_frames(
        [0, 1], [10.0, 11.0],
        np.stack([_pose(0.0), _pose(1.0)]),
        [dict(i=0, j=1, T_ij=_pose(1.0), sqrt_info=np.eye(6))],
        fixed=True,
    )
    assert set(fid_map.values()) == {-1, -2}
    assert est.archive_frames[-1].pose_fixed
    e = est.archive_edges[-1]
    assert e["i"] == -1 and e["j"] == -2
    # timestamps shifted before the session
    assert est.archive_frames[-1].timestamp < -1e5


def _mutual_reference(q, vq, d, vd, thr):
    """numpy mutual best matches under the distance gate."""
    D = np.unpackbits(
        (q[:, None, :] ^ d[None, :, :]).view(np.uint8), axis=-1
    ).sum(-1).astype(np.int64)
    D[~vq] = 10**6
    D[:, ~vd] = 10**6
    idx = D.argmin(1)
    back = D.argmin(0)
    ok = vq & vd[idx] & (back[idx] == np.arange(len(q)))
    ok &= D[np.arange(len(q)), idx] <= thr
    return idx, ok


def test_relocalisation_matcher_matches_batched_loop_closure_matcher():
    """_geometric_verify (relocalisation, one candidate) and the batched
    loop-closure verifier (_lc_match_fn over several candidates) give the
    same mutual matches for one record pair, equal to numpy's."""
    rng = np.random.default_rng(4)
    cam = _cam()
    est_cfg = EstimatorConfig(cap_frames=6, cap_landmarks=64, cap_obs=128,
                              cap_imu_links=5, cap_rel_edges=8)
    T_SC = np.array([[-0.05, 0, 0, 0, 0, 0, 1.0], [0.05, 0, 0, 0, 0, 0, 1.0]])
    pipe = VioPipeline([cam, cam], T_SC, est_cfg,
                       PipelineConfig(vocab_k=32, max_keypoints=96))
    N, C = 96, 2
    rec = rng.integers(0, 2**32, (C, N, 12), dtype=np.uint32)
    rec_v = rng.random((C, N)) < 0.9
    # candidate: the query's descriptors with a few bits flipped, shuffled,
    # plus unrelated rows
    cand = rng.integers(0, 2**32, (C, N, 12), dtype=np.uint32)
    perm = rng.permutation(N)
    near = rec[:, perm] ^ (rng.random((C, N, 12)) < 0.03).astype(np.uint32)
    cand[:, : N // 2] = near[:, : N // 2]
    cand_v = rng.random((C, N)) < 0.9
    match = pipe._lc_match_fn()
    # _geometric_verify's call: every camera of one candidate record
    mi1, ok1 = (np.asarray(a)[0] for a in match(rec, rec_v, cand[None],
                                                  cand_v[None]))
    # _geometric_verify_batch's call: the same record among distractors
    others = rng.integers(0, 2**32, (2, C, N, 12), dtype=np.uint32)
    batch = np.concatenate([others[:1], cand[None], others[1:]])
    batch_v = np.concatenate([np.ones((1, C, N), bool), cand_v[None],
                              np.ones((1, C, N), bool)])
    miB, okB = (np.asarray(a)[1] for a in match(rec, rec_v, batch, batch_v))
    thr = pipe.cfg.matching_threshold
    for c in range(C):
        idx_ref, ok_ref = _mutual_reference(rec[c], rec_v[c], cand[c],
                                            cand_v[c], thr)
        assert ok_ref.sum() > N // 4
        np.testing.assert_array_equal(ok1[c], ok_ref)
        np.testing.assert_array_equal(okB[c], ok_ref)
        np.testing.assert_array_equal(mi1[c][ok_ref], idx_ref[ok_ref])
        np.testing.assert_array_equal(miB[c][ok_ref], idx_ref[ok_ref])
