"""Distributed bundle adjustment: Schur-complement reduction across the mesh.

The multi-device version of solver/gauss_newton.py — the capability the
reference lacks entirely (its BA is single-process Ceres with 3 CPU threads,
config/euroc/okvis2.yaml realtime_num_threads).  Layout:

  * observation table sharded along the mesh axis ("obs") — each device
    linearises its shard of reprojection factors (the dominant FLOPs);
  * per-device partial normal equations; the reduced camera system
    H_ff (P x P, P = K*15 + C*6, small) and the landmark blocks
    (H_ll, b_l, W) are `psum`'d across the mesh;
  * IMU / prior / relative-edge factors are tiny and computed redundantly
    on every device (identical inputs -> identical outputs, no collective);
  * the dense reduced solve is replicated (cheap), landmark back-substitution
    is elementwise over landmarks.

One `shard_map`ped LM loop == one compiled multi-chip program per window
capacity; no host round-trips inside the solve.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from okvis2x_tpu.parallel.mesh import OBS_AXIS
from okvis2x_tpu.solver import gauss_newton as gn
from okvis2x_tpu.solver.problem import BAProblem, apply_delta, free_mask


OBS_FIELDS = ("obs_frame", "obs_cam", "obs_lm", "obs_uv", "obs_sqrt_info", "obs_valid")


def _problem_specs(p: BAProblem):
    """PartitionSpec pytree: observation arrays sharded, everything else
    replicated."""
    def spec_for(path, leaf):
        name = path[0].name
        if name in OBS_FIELDS:
            return P(OBS_AXIS)
        return P()

    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: spec_for(path, leaf), p
    )


def _linearize_local(p: BAProblem, cams: gn.StackedCameras, cfg: gn.SolverConfig):
    """Per-device linearisation: local obs shard + replicated small factors;
    psums assemble the global normal equations."""
    from okvis2x_tpu.factors import robust

    dtype = p.T_WS.dtype
    Pdim, L = p.P, p.L

    r_o, Jrow_o, Jh_o, valid_o = gn._linearize_reprojection(p, cams)
    s = jnp.sum(r_o * r_o, axis=-1)
    w = robust.weight(cfg.reproj_loss, s, cfg.reproj_loss_scale) * valid_o
    cost_local = 0.5 * jnp.sum(
        robust.rho(cfg.reproj_loss, s, cfg.reproj_loss_scale) * valid_o
    )
    sw = jnp.sqrt(w)[:, None]
    r_o = r_o * sw
    Jrow_o = Jrow_o * sw[..., None]
    Jh_o = Jh_o * sw[..., None]

    fmask = free_mask(p).astype(dtype)
    Jrow_o = Jrow_o * fmask[None, None, :]

    lm_free = p.lm_valid & ~p.lm_fixed
    if not cfg.estimate_landmarks:
        lm_free = jnp.zeros_like(lm_free)
    Jh_o = Jh_o * lm_free.astype(dtype)[p.obs_lm][:, None, None]

    Jo = Jrow_o.reshape(-1, Pdim)
    ro = r_o.reshape(-1)
    H_ff = jax.lax.psum(Jo.T @ Jo, OBS_AXIS)
    b_f = jax.lax.psum(-(Jo.T @ ro), OBS_AXIS)
    cost = jax.lax.psum(cost_local, OBS_AXIS)

    onehot_l = jax.nn.one_hot(p.obs_lm, L, dtype=dtype)
    H_ll = jax.lax.psum(
        jnp.einsum(
            "nl,nij->lij", onehot_l, jnp.einsum("nri,nrj->nij", Jh_o, Jh_o)
        ),
        OBS_AXIS,
    )
    b_l = jax.lax.psum(
        -jnp.einsum(
            "nl,ni->li", onehot_l, jnp.einsum("nri,nr->ni", Jh_o, r_o)
        ),
        OBS_AXIS,
    )
    W = jax.lax.psum(
        jnp.einsum(
            "nl,npi->lpi", onehot_l, jnp.einsum("nrp,nri->npi", Jrow_o, Jh_o)
        ),
        OBS_AXIS,
    )

    # small factors, computed redundantly (identical on every device)
    r_i, Jrow_i, valid_i = gn._linearize_imu(p, cfg)
    mi = valid_i.astype(dtype)[:, None]
    Ji = (Jrow_i * mi[..., None] * fmask[None, None, :]).reshape(-1, Pdim)
    ri = (r_i * mi).reshape(-1)
    H_ff = H_ff + Ji.T @ Ji
    b_f = b_f - Ji.T @ ri
    cost = cost + 0.5 * jnp.sum(ri * ri)

    (r_pp, J_pp, v_pp), (r_sb, J_sb, v_sb) = gn._linearize_priors(p)
    for r_, J_, v_ in ((r_pp, J_pp, v_pp), (r_sb, J_sb, v_sb)):
        m = v_.astype(dtype)[:, None]
        Jf = (J_ * m[..., None] * fmask[None, None, :]).reshape(-1, Pdim)
        rf = (r_ * m).reshape(-1)
        H_ff = H_ff + Jf.T @ Jf
        b_f = b_f - Jf.T @ rf
        cost = cost + 0.5 * jnp.sum(rf * rf)

    if p.rel_i.shape[0]:
        r_r, Jrow_r, valid_r = gn._linearize_rel(p)
        mr = valid_r.astype(dtype)[:, None]
        Jr = (Jrow_r * mr[..., None] * fmask[None, None, :]).reshape(-1, Pdim)
        rr = (r_r * mr).reshape(-1)
        H_ff = H_ff + Jr.T @ Jr
        b_f = b_f - Jr.T @ rr
        cost = cost + 0.5 * jnp.sum(rr * rr)

    if p.gps_frame.shape[0]:
        r_g, Jrow_g, valid_g = gn._linearize_gps(p, cfg)
        mg = valid_g.astype(dtype)[:, None]
        Jg = (Jrow_g * mg[..., None] * fmask[None, None, :]).reshape(-1, Pdim)
        rg = (r_g * mg).reshape(-1)
        H_ff = H_ff + Jg.T @ Jg
        b_f = b_f - Jg.T @ rg
        cost = cost + 0.5 * jnp.sum(rg * rg)

    if cfg.use_ext_priors:
        r_e, Jrow_e, valid_e = gn._linearize_ext_priors(p)
        me = valid_e.astype(dtype)[:, None]
        Je = (Jrow_e * me[..., None] * fmask[None, None, :]).reshape(-1, Pdim)
        re = (r_e * me).reshape(-1)
        H_ff = H_ff + Je.T @ Je
        b_f = b_f - Je.T @ re
        cost = cost + 0.5 * jnp.sum(re * re)

    fmask_b = fmask > 0
    H_ff = jnp.where(
        (fmask_b[:, None] & fmask_b[None, :]), H_ff, jnp.zeros_like(H_ff)
    ) + jnp.diag((~fmask_b).astype(dtype))
    b_f = b_f * fmask

    return gn.Linearization(H_ff, b_f, H_ll, b_l, W, lm_free, cost)


def _cost_local(p, cams, cfg):
    """Distributed robust cost: obs part psum'd, small factors replicated.

    Reuses the single-device compute_cost on a problem whose small factors
    are intact but whose obs arrays are the local shard.
    """
    from okvis2x_tpu.factors import imu_factor, priors, reprojection, robust

    dtype = p.T_WS.dtype

    def obs_one(f, c, l, uv, si):
        return reprojection.residual(
            cams.at(c), p.T_WS[f], p.T_SC[c], p.hp_W[l], uv, si
        )

    r_o, valid = jax.vmap(obs_one)(
        p.obs_frame, p.obs_cam, p.obs_lm, p.obs_uv, p.obs_sqrt_info
    )
    valid = valid & p.obs_valid
    s = jnp.sum(r_o * r_o, axis=-1)
    cost = jax.lax.psum(
        0.5 * jnp.sum(robust.rho(cfg.reproj_loss, s, cfg.reproj_loss_scale) * valid),
        OBS_AXIS,
    )

    def imu_one(i, j, pre_, si):
        return imu_factor.residual(
            cfg.imu_params, pre_, si, p.T_WS[i], p.sb[i], p.T_WS[j], p.sb[j]
        )

    if p.imu_i.shape[0]:
        r_i = jax.vmap(imu_one)(p.imu_i, p.imu_j, p.imu_pre, p.imu_sqrt_info)
        cost = cost + 0.5 * jnp.sum(
            (r_i * p.imu_valid.astype(dtype)[:, None]) ** 2
        )

    ks = jnp.arange(p.K, dtype=jnp.int32)
    r_pp = jax.vmap(
        lambda k, Tp, si: priors.pose_prior_residual(Tp, p.T_WS[k], si)
    )(ks, p.pose_prior_T, p.pose_prior_sqrt_info)
    cost = cost + 0.5 * jnp.sum((r_pp * p.pose_prior_valid.astype(dtype)[:, None]) ** 2)
    r_sb = jax.vmap(
        lambda k, sbp, si: priors.speed_bias_prior_residual(sbp, p.sb[k], si)
    )(ks, p.sb_prior, p.sb_prior_sqrt_info)
    cost = cost + 0.5 * jnp.sum((r_sb * p.sb_prior_valid.astype(dtype)[:, None]) ** 2)
    if p.rel_i.shape[0]:
        r_r = jax.vmap(
            lambda i, j, Tr, si: priors.relative_pose_residual(
                Tr, p.T_WS[i], p.T_WS[j], si
            )
        )(p.rel_i, p.rel_j, p.rel_T, p.rel_sqrt_info)
        cost = cost + 0.5 * jnp.sum(
            (r_r * p.rel_valid.astype(dtype)[:, None]) ** 2
        )

    if p.gps_frame.shape[0]:
        from okvis2x_tpu.factors import gps as gps_mod

        r_g = jax.vmap(
            lambda fi, pre_, pg, si: gps_mod.residual_async(
                cfg.imu_params, pre_, p.T_GW, p.T_WS[fi], p.sb[fi], pg,
                p.gps_r_SA, si,
            )
        )(p.gps_frame, p.gps_pre, p.gps_p_G, p.gps_sqrt_info)
        cost = cost + 0.5 * jnp.sum(
            (r_g * p.gps_valid.astype(dtype)[:, None]) ** 2
        )

    if cfg.use_ext_priors:
        r_e = jax.vmap(
            lambda c, Tp, si: priors.pose_prior_residual(Tp, p.T_SC[c], si)
        )(jnp.arange(p.C, dtype=jnp.int32), p.ext_prior_T,
          p.ext_prior_sqrt_info)
        cost = cost + 0.5 * jnp.sum(
            (r_e * p.ext_prior_valid.astype(dtype)[:, None]) ** 2
        )
    return cost


def optimize_distributed(
    p: BAProblem,
    cams: gn.StackedCameras,
    cfg: gn.SolverConfig,
    mesh: Mesh,
) -> Tuple[BAProblem, jax.Array]:
    """LM loop with observation-sharded linearisation over the mesh.

    Observation capacity must be divisible by the mesh size.  Returns the
    optimised problem (fully replicated) and final cost.
    """
    specs = _problem_specs(p)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(specs,),
        out_specs=(specs, P()),
        check_vma=False,
    )
    def run(p_local):
        def body(_, carry):
            prob, lam, cost = carry
            lin = _linearize_local(prob, cams, cfg)
            dx, dl = gn.solve_normal_equations(lin, lam)
            cand = apply_delta(prob, dx, dl)
            new_cost = _cost_local(cand, cams, cfg)
            accept = new_cost < cost
            prob = jax.tree.map(lambda a, b: jnp.where(accept, a, b), cand, prob)
            lam = jnp.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up)
            lam = jnp.clip(lam, 1e-10, 1e6)
            return prob, lam, jnp.minimum(new_cost, cost)

        lam0 = jnp.asarray(cfg.init_lambda, p_local.T_WS.dtype)
        cost0 = _cost_local(p_local, cams, cfg)
        carry = (p_local, lam0, cost0)
        prob, _, cost = jax.lax.fori_loop(0, cfg.max_iterations, body, carry)
        return prob, cost

    sharding = jax.tree.map(lambda s: NamedSharding(mesh, s), specs)
    p_sh = jax.device_put(p, sharding)
    return jax.jit(run)(p_sh)
