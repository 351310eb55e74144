"""Pose trajectory metrics: Procrustes normalization, Umeyama Sim(3)
alignment, ATE RMSE, RPE translation/rotation. Port of
`rodygs_tpu/evalsuite/pose_metrics.py`, a copy: it is host-side numpy and
scipy (tiny inputs, evaluation only) and needs nothing of either framework.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg as sla


def procrustes_normalize(t1: np.ndarray, t2: np.ndarray):
    """Scale/center both translation sets and Procrustes-scale t2 toward t1
    (`PoseEvaluator.normalize_pose`). Returns (t1_norm, t2_norm)."""
    m1 = np.array(t1, dtype=np.double, copy=True)
    m2 = np.array(t2, dtype=np.double, copy=True)
    m1 -= m1.mean(0)
    m2 -= m2.mean(0)
    n1, n2 = np.linalg.norm(m1), np.linalg.norm(m2)
    if n1 == 0 or n2 == 0:
        raise ValueError("degenerate trajectories")
    m1 /= n1
    m2 /= n2
    _, s = sla.orthogonal_procrustes(m1, m2)
    return m1, m2 * s


def umeyama_sim3(model: np.ndarray, data: np.ndarray):
    """Least-squares Sim(3): model = s * R @ data + t (Umeyama 1991;
    `pose_estim_utils.py:87-139`)."""
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mz = model - mu_m
    dz = data - mu_d
    n = model.shape[0]
    C = (mz.T @ dz) / n
    sigma2 = (dz * dz).sum() / n
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt.T) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / sigma2
    t = mu_m - s * R @ mu_d
    return s, R, t


def align_trajectory_sim3(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Align estimated c2w trajectory [F,4,4] to GT with the Sim(3) fit on
    camera centers (`align_ate_c2b_use_a2b`)."""
    s, R, t = umeyama_sim3(gt[:, :3, 3], est[:, :3, 3])
    out = np.tile(np.eye(4, dtype=np.float32), (len(est), 1, 1))
    out[:, :3, :3] = (R[None] @ est[:, :3, :3]).astype(np.float32)
    out[:, :3, 3] = (s * (R[None] @ est[:, :3, 3:4])[:, :, 0] + t).astype(np.float32)
    return out


def compute_ate(gt: np.ndarray, pred: np.ndarray) -> float:
    """RMSE of camera-center distances (`compute_ATE`)."""
    err = gt[:, :3, 3] - pred[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


def compute_rpe(gt: np.ndarray, pred: np.ndarray) -> tuple[float, float]:
    """Mean relative-pose errors over consecutive frames (`compute_rpe`)."""
    trans_err, rot_err = [], []
    for i in range(len(gt) - 1):
        gt_rel = np.linalg.inv(gt[i]) @ gt[i + 1]
        pred_rel = np.linalg.inv(pred[i]) @ pred[i + 1]
        rel = np.linalg.inv(gt_rel) @ pred_rel
        trans_err.append(np.linalg.norm(rel[:3, 3]))
        d = 0.5 * (np.trace(rel[:3, :3]) - 1.0)
        rot_err.append(np.arccos(np.clip(d, -1.0, 1.0)))
    return float(np.mean(trans_err)), float(np.mean(rot_err))


class PoseEvaluator:
    """End-to-end trajectory scoring (`eval_utils.py:96-117`): Procrustes
    translation normalization -> Sim(3) alignment -> ATE / RPE.
    RPE_trans is x100, RPE_rot in degrees, as the reference reports."""

    def get_score(self, gt: np.ndarray, estim: np.ndarray) -> dict:
        gt = np.array(gt, dtype=np.float64, copy=True)
        est = np.array(estim, dtype=np.float64, copy=True)
        try:
            t_gt, t_est = procrustes_normalize(gt[:, :3, 3], est[:, :3, 3])
        except ValueError:
            # stationary trajectory: alignment undefined (the reference
            # raises here too) — report NaN instead of crashing the eval.
            return {"ATE": float("nan"), "RPE_trans": float("nan"),
                    "RPE_rot": float("nan"), "aligned": est}
        gt[:, :3, 3] = t_gt
        est[:, :3, 3] = t_est
        est_aligned = align_trajectory_sim3(est, gt)
        ate = compute_ate(gt, est_aligned)
        rpe_trans, rpe_rot = compute_rpe(gt, est_aligned)
        return {
            "ATE": ate,
            "RPE_trans": rpe_trans * 100.0,
            "RPE_rot": float(np.rad2deg(rpe_rot)),
            "aligned": est_aligned,
        }
