"""Non-differentiable collision metrics: vectorized oriented-box IoU.

Copy of ``strive_tpu/losses/metrics.py`` (numpy, host-side). The reference uses Shapely polygon loops on CPU for its success
classification (``losses/adv_gen_nusc.py:517-623``,
``losses/traffic_model.py:465-545``) — a per-pair Python loop. Here the
convex-quad intersection is a batched Sutherland–Hodgman clip in numpy, so
whole (pairs x time) grids evaluate at once with identical IoU thresholds
(IoU > 0.02 counts as a collision).
"""

from __future__ import annotations

import numpy as np

VEH_COLL_THRESH = 0.02  # reference adv_gen_nusc.py:515
ENV_COLL_THRESH = 0.05  # reference adv_gen_nusc.py:514


def box_corners(states, lw):
    """Oriented box corners (reference ``nuscenes_utils.py:416-428``).

    :param states: (..., 4) = (x, y, hx, hy)
    :param lw: (..., 2)
    :return: (..., 4, 2) corners in CCW order
    """
    states = np.asarray(states, np.float64)
    lw = np.asarray(lw, np.float64)
    l, w = lw[..., 0], lw[..., 1]
    base = np.stack(
        [
            np.stack([-l / 2, -w / 2], -1),
            np.stack([l / 2, -w / 2], -1),
            np.stack([l / 2, w / 2], -1),
            np.stack([-l / 2, w / 2], -1),
        ],
        axis=-2,
    )  # (..., 4, 2)
    c = states[..., 2] / np.maximum(
        np.hypot(states[..., 2], states[..., 3]), 1e-12
    )
    s = states[..., 3] / np.maximum(
        np.hypot(states[..., 2], states[..., 3]), 1e-12
    )
    x = base[..., 0] * c[..., None] - base[..., 1] * s[..., None]
    y = base[..., 0] * s[..., None] + base[..., 1] * c[..., None]
    return np.stack([x + states[..., None, 0], y + states[..., None, 1]], -1)


def _clip_halfplane(P, n, a, b, c):
    """Clip polygons P (B, K, 2) with counts n (B,) against a*x+b*y+c >= 0."""
    B, K, _ = P.shape
    idx = np.arange(K)[None, :]
    validv = idx < n[:, None]
    safe_n = np.maximum(n, 1)
    prev_idx = (idx - 1) % safe_n[:, None]
    Pprev = np.take_along_axis(P, prev_idx[..., None], axis=1)
    d_cur = a[:, None] * P[..., 0] + b[:, None] * P[..., 1] + c[:, None]
    d_prev = a[:, None] * Pprev[..., 0] + b[:, None] * Pprev[..., 1] + c[:, None]
    cur_in = d_cur >= 0
    prev_in = d_prev >= 0
    denom = d_prev - d_cur
    t = np.where(np.abs(denom) > 1e-12, d_prev / np.where(denom == 0, 1, denom), 0.0)
    inter = Pprev + t[..., None] * (P - Pprev)

    emit_inter = (cur_in ^ prev_in) & validv
    emit_cur = cur_in & validv
    counts = emit_inter.astype(np.int64) + emit_cur.astype(np.int64)
    offs = np.cumsum(counts, axis=1) - counts
    new_n = offs[:, -1] + counts[:, -1]

    out = np.zeros((B, K + 2, 2))
    bidx = np.arange(B)[:, None]
    # intersection point goes first, then the inside current vertex
    flat_b = np.broadcast_to(bidx, (B, K))
    pos_inter = offs
    out[flat_b[emit_inter], pos_inter[emit_inter]] = inter[emit_inter]
    pos_cur = offs + emit_inter.astype(np.int64)
    out[flat_b[emit_cur], pos_cur[emit_cur]] = P[emit_cur]
    return out[:, : K + 2], new_n


def _poly_area(P, n):
    """Shoelace area of polygons with vertex counts n."""
    B, K, _ = P.shape
    idx = np.arange(K)[None, :]
    validv = idx < n[:, None]
    safe_n = np.maximum(n, 1)
    nxt = (idx + 1) % safe_n[:, None]
    Pn = np.take_along_axis(P, nxt[..., None], axis=1)
    cross = P[..., 0] * Pn[..., 1] - Pn[..., 0] * P[..., 1]
    return 0.5 * np.abs(np.sum(np.where(validv, cross, 0.0), axis=1))


def convex_quad_intersection_area(A, B):
    """Intersection area of convex quads A, B: (N, 4, 2) each -> (N,).

    B's vertices must be consistently ordered (CW or CCW); orientation is
    normalized internally.
    """
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    N = A.shape[0]
    # ensure CCW orientation of the clip polygon
    e0 = B[:, 1] - B[:, 0]
    e1 = B[:, 2] - B[:, 1]
    cross = e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0]
    Bc = np.where(cross[:, None, None] >= 0, B, B[:, ::-1])

    P = np.zeros((N, 4, 2))
    P[:] = A
    n = np.full((N,), 4, np.int64)
    for e in range(4):
        p0 = Bc[:, e]
        p1 = Bc[:, (e + 1) % 4]
        # inside = left of edge p0->p1: a*x + b*y + c >= 0
        a = p1[:, 1] - p0[:, 1]
        b = -(p1[:, 0] - p0[:, 0])
        a, b = -a, -b  # left side for CCW
        c = -(a * p0[:, 0] + b * p0[:, 1])
        P, n = _clip_halfplane(P, n, a, b, c)
    return _poly_area(P, n)


def oriented_box_iou(statesA, lwA, statesB, lwB):
    """IoU between oriented boxes, elementwise over leading dims."""
    shape = np.broadcast_shapes(statesA.shape[:-1], statesB.shape[:-1])
    sa = np.broadcast_to(statesA, shape + (4,)).reshape(-1, 4)
    sb = np.broadcast_to(statesB, shape + (4,)).reshape(-1, 4)
    la = np.broadcast_to(lwA, shape + (2,)).reshape(-1, 2)
    lb = np.broadcast_to(lwB, shape + (2,)).reshape(-1, 2)
    inter = convex_quad_intersection_area(box_corners(sa, la), box_corners(sb, lb))
    areaA = la[:, 0] * la[:, 1]
    areaB = lb[:, 0] * lb[:, 1]
    union = areaA + areaB - inter
    return (inter / np.maximum(union, 1e-12)).reshape(shape)


def check_single_veh_coll(traj_tgt, lw_tgt, traj_others, lw_others):
    """Does the target trajectory collide with each other agent?

    :param traj_tgt: (T, 4) UNNORMALIZED
    :param traj_others: (N, T, 4) UNNORMALIZED (NaN frames skipped)
    :return: veh_coll (N,) bool, coll_time (N,) first colliding step (T if none)

    Reference ``adv_gen_nusc.py:517-565``.
    """
    traj_tgt = np.asarray(traj_tgt)
    traj_others = np.asarray(traj_others)
    N, T = traj_others.shape[:2]
    nanmask = np.isnan(traj_others).any(-1)  # (N, T)
    others = np.where(nanmask[..., None], 0.0, traj_others)
    iou = oriented_box_iou(
        traj_tgt[None], np.asarray(lw_tgt)[None],
        others, np.asarray(lw_others)[:, None],
    )  # (N, T)
    hit = (iou > VEH_COLL_THRESH) & ~nanmask
    veh_coll = hit.any(axis=1)
    coll_time = np.where(veh_coll, hit.argmax(axis=1), T)
    return veh_coll, coll_time.astype(np.int64)


def check_pairwise_veh_coll(traj, lw):
    """Pairwise collision rate (reference ``adv_gen_nusc.py:567-623``):
    each unordered pair checked once; a collision marks the lower index.

    :param traj: (N, T, 4) UNNORMALIZED
    :return: dict num_coll_veh / num_traj_veh / did_collide (N,)
    """
    traj = np.asarray(traj)
    N, T = traj.shape[:2]
    lw = np.asarray(lw)
    iu, ju = np.triu_indices(N, k=1)
    if len(iu) == 0:
        return {"num_coll_veh": 0.0, "num_traj_veh": float(N),
                "did_collide": np.zeros(N, bool)}
    iou = oriented_box_iou(traj[iu], lw[iu, None], traj[ju], lw[ju, None])
    pair_hit = (iou > VEH_COLL_THRESH).any(axis=1)
    did = np.zeros(N, bool)
    did[iu[pair_hit]] = True  # attribute to the lower index, like the reference
    return {
        "num_coll_veh": float(did.sum()),
        "num_traj_veh": float(N),
        "did_collide": did,
    }


def compute_coll_rate_veh_dense(future_pred, lw, mask):
    """Sampled vehicle-collision rate on dense batches.

    :param future_pred: (B, NS, NA, FT, 4) UNNORMALIZED numpy
    :param lw: (B, NA, 2) UNNORMALIZED
    :param mask: (B, NA) bool
    :return: did_collide (B, NS, NA) — True if agent i (the lower index of a
        colliding pair) collides in that sample.

    Mirrors reference ``losses/traffic_model.py:465-545``.
    """
    future_pred = np.asarray(future_pred)
    B, NS, NA, FT, _ = future_pred.shape
    did = np.zeros((B, NS, NA), bool)
    for b in range(B):
        n = int(np.asarray(mask[b]).sum())
        for s in range(NS):
            res = check_pairwise_veh_coll(future_pred[b, s, :n],
                                          np.asarray(lw[b, :n]))
            did[b, s, :n] = res["did_collide"]
    return did
