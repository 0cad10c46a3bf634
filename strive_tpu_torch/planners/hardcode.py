"""Rule-based lane-graph planner (host-side numpy).

Copy of ``strive_tpu/planners/hardcode.py``; its device counterpart is
``device_planner.py``. Behavioral re-implementation of reference
``planners/hardcode_goalcond_nusc.py`` (HardcodeNuscPlanner + utilities,
:65-895). The planner is intentionally kept on the host (SURVEY §7 phase A):
it is non-differentiable in the reference too — closed-loop attack
gradients flow only through the traffic model's internal prediction of the
ego node — so a host callback per optimizer iteration is semantically
faithful. All scipy interpolators are replaced with plain piecewise-linear
numpy evaluation.

Algorithm per step (reference :178-276):
1. match every vehicle to lane-graph edges by heading cosine distance and
   point-to-edge distance; greedy-cluster matches via BFS over the matched
   edge set (:298-376),
2. build candidate route splines by BFS lane expansion fwd/back, warped to
   pass exactly through the vehicle pose with a Gaussian falloff
   (lane_sig), constant-heading fallback (:477-556),
3. enumerate 2-phase ego speed profiles (:804-826), predict others along
   THEIR splines at predsfacs x predafacs speeds (:694-721),
4. score each ego profile by collision probability from 5-circle bbox
   distances with time-growing tanh weights (:724-728, :860-895); pick the
   farthest-travelling profile with p < col_plim, else min-p (:768-801),
5. step along the ego spline with an exact-speed postprocess (:642-666),
   advance others by interpolation of their observed futures (:601-621),
6. iterate at dt (default 0.2s) and linearly resample to the requested 2Hz
   output stamps (:263-270, including the reference's exact
   ``linspace(dt, dt*Tsteps, Tsteps+1)`` output timeline).
"""

from __future__ import annotations

from collections import deque
from copy import deepcopy

import numpy as np

# reference :22-63
DEF_CONFIG = {
    "dt": 0.2, "preddt": 0.2, "nsteps": 25, "cdistang": 20.0,
    "xydistmax": 2.0, "smax": 15.0, "accmax": 3.0,
    "predsfacs": [0.5, 1.0], "predafacs": [0.5], "interacdist": 70.0,
    "planaccfacs": [1.0], "plannspeeds": 5, "col_plim": 0.1,
    "score_wmin": 0.7, "score_wfac": 0.05,
}
TUNED_VAL_FINAL_1 = {
    **DEF_CONFIG, "smax": 20.0, "accmax": 4.0,
    "score_wmin": 0.3, "score_wfac": 0.02,
}
PLANNER_CONFIGS = {"default": DEF_CONFIG, "final_tuned_val_1": TUNED_VAL_FINAL_1}

LANE_DS = 0.4
LANE_SIG = 3.5
SBUFFER = 4.0


class PlannerConfig:
    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)


class PiecewiseLinear:
    """Columnwise linear interpolation over a sorted knot vector."""

    __slots__ = ("t", "vals")

    def __init__(self, t, vals):
        self.t = np.asarray(t, np.float64)
        self.vals = np.asarray(vals, np.float64)

    def __call__(self, q):
        q = np.atleast_1d(np.asarray(q, np.float64))
        out = np.empty((len(q), self.vals.shape[1]))
        for c in range(self.vals.shape[1]):
            out[:, c] = np.interp(q, self.t, self.vals[:, c])
        return out


# ---------------------------------------------------------------------------
# lane matching (reference :298-376)
# ---------------------------------------------------------------------------

def edge_closest_point(la_xy, la_h, la_l, query):
    diff = query[None, :] - la_xy
    lmag = np.clip(diff[:, 0] * la_h[:, 0] + diff[:, 1] * la_h[:, 1], 0.0, la_l)
    closest = la_xy + lmag[:, None] * la_h
    dist = np.linalg.norm(query[None, :] - closest, axis=1)
    return closest, dist


def get_lane_matches(x, y, h, lg, cdistmax, xydistmax):
    cdist = 1.0 - lg["edges"][:, 2] * np.cos(h) - lg["edges"][:, 3] * np.sin(h)
    kept = cdist < cdistmax
    if kept.sum() == 0:
        return {"closest": np.empty((0, 2)),
                "ixes": np.empty((0, 2), np.int64)}
    e = lg["edges"][kept]
    closest, dist = edge_closest_point(e[:, 0:2], e[:, 2:4], e[:, 4],
                                       np.array([x, y]))
    opt = dist < xydistmax
    return {"closest": closest[opt], "ixes": lg["edgeixes"][kept][opt]}


def _cluster_bfs(v0, v1, seen, lg, go_forward):
    qu = deque([(v0, v1)])
    while qu:
        c0, c1 = qu.popleft()
        seen[(c0, c1)] = True
        nxt = (lg["out_edges"][c1] if go_forward else lg["in_edges"][c0])
        for n in nxt:
            key = (c1, n) if go_forward else (n, c0)
            if key in seen and not seen[key]:
                qu.append(key)
    return seen


def cluster_matches_combine(x, y, matches, lg):
    """Greedy closest-first dedup of matches connected through the matched
    edge set (reference :324-347)."""
    if len(matches["closest"]) == 0:
        return matches
    seen = {(v0, v1): False for v0, v1 in matches["ixes"]}
    order = np.argsort(
        np.linalg.norm(np.array([[x, y]]) - matches["closest"], axis=1)
    )
    ixes, closest = [], []
    for (v0, v1), close in zip(matches["ixes"][order],
                               matches["closest"][order]):
        if seen[(v0, v1)]:
            continue
        ixes.append([v0, v1])
        closest.append(close)
        seen = _cluster_bfs(v0, v1, seen, lg, True)
        seen = _cluster_bfs(v0, v1, seen, lg, False)
    return {"ixes": np.array(ixes), "closest": np.array(closest)}


# ---------------------------------------------------------------------------
# route splines (reference :379-556)
# ---------------------------------------------------------------------------

def expand_verts(v0, xys, conns, mindist):
    """BFS vertex-chain expansion to at least ``mindist`` meters
    (reference :379-414). Branching spawns extra chains."""
    qu = deque([{"v": [v0], "l": 0.0}])
    lanes = []
    while qu:
        lane = qu.popleft()
        while lane["l"] <= mindist:
            v = lane["v"][-1]
            if len(conns[v]) == 0:
                break
            for outv in conns[v][1:]:
                nl = deepcopy(lane)
                nl["l"] += np.linalg.norm(xys[outv] - xys[v])
                nl["v"].append(outv)
                qu.append(nl)
            outv = conns[v][0]
            lane["l"] += np.linalg.norm(xys[outv] - xys[v])
            lane["v"].append(outv)
        lanes.append(lane)
    return lanes


def _extend(xys, le, forward):
    if forward:
        d = xys[-1] - xys[-2]
        d = d / np.linalg.norm(d)
        return np.concatenate([xys, (xys[-1] + d * le)[None]], axis=0)
    d = xys[0] - xys[1]
    d = d / np.linalg.norm(d)
    return np.concatenate([(xys[0] + d * le)[None], xys], axis=0)


def local_lane_closest(xys, ix0, egoxy):
    """Locally-closest polyline point walked out from segment ix0
    (reference :433-452)."""
    diff = xys[1:] - xys[:-1]
    dist = np.linalg.norm(diff, axis=1)
    ec, ed = edge_closest_point(xys[:-1], diff / dist[:, None], dist, egoxy)
    cix = min(ix0, len(ed) - 1)
    while cix - 1 >= 0 and ed[cix - 1] < ed[cix]:
        cix -= 1
    while cix + 1 < len(ed) and ed[cix + 1] < ed[cix]:
        cix += 1
    return cix, ec[cix]


def xy2spline(xy, ix0, egoh):
    """Arc-length-parameterized (x, y, hcos, hsin) spline through xy,
    heading at ix0 forced to the ego heading (reference :455-474)."""
    diff = xy[1:] - xy[:-1]
    dist = np.linalg.norm(diff, axis=1)
    head = diff / np.maximum(dist[:, None], 1e-12)
    head = np.concatenate([head, head[[-1]]], axis=0)
    xyhh = np.concatenate([xy, head], axis=1)
    xyhh[ix0, 2] = np.cos(egoh)
    xyhh[ix0, 3] = np.sin(egoh)
    t = np.zeros(len(xy))
    t[1:] = np.cumsum(dist)
    t = t - t[ix0]
    return PiecewiseLinear(t, xyhh)


def constant_heading_spline(egoxy, egoh, backdist, fordist):
    t = np.array([-backdist, fordist])
    c, s = np.cos(egoh), np.sin(egoh)
    vals = np.array([
        [egoxy[0] - backdist * c, egoxy[1] - backdist * s, c, s],
        [egoxy[0] + fordist * c, egoxy[1] + fordist * s, c, s],
    ])
    return PiecewiseLinear(t, vals)


def get_prediction_splines(final_matches, lg, backdist, fordist, xydistmax,
                           egoxy, egoh, lane_ds=LANE_DS, lane_sig=LANE_SIG,
                           sbuffer=SBUFFER):
    """Candidate route splines warped through the ego pose
    (reference :487-556)."""
    if final_matches["ixes"].shape[0] == 0:
        return [constant_heading_spline(egoxy, egoh, backdist, fordist)]
    out = []
    reach = fordist + sbuffer + xydistmax
    breach = backdist + sbuffer + xydistmax
    for (v0, v1), _close in zip(final_matches["ixes"],
                                final_matches["closest"]):
        fwd = expand_verts(v1, lg["xy"], lg["out_edges"], mindist=reach)
        bwd = expand_verts(v0, lg["xy"], lg["in_edges"], mindist=breach)
        for fl in fwd:
            for bl in bwd:
                xys = np.concatenate(
                    [lg["xy"][bl["v"][::-1]], lg["xy"][fl["v"]]], axis=0
                )
                ix0 = len(bl["v"]) - 1
                if fl["l"] <= reach:
                    xys = _extend(xys, 1.0 + reach - fl["l"], True)
                if bl["l"] <= breach:
                    xys = _extend(xys, 1.0 + breach - bl["l"], False)
                    ix0 += 1
                cix, cclose = local_lane_closest(xys, ix0, egoxy)
                t = np.zeros(len(xys))
                t[1:] = np.cumsum(np.linalg.norm(xys[1:] - xys[:-1], axis=1))
                t = t - t[cix] - np.linalg.norm(cclose - xys[cix])
                interp = PiecewiseLinear(t, xys)
                numback = int((backdist + sbuffer) / lane_ds) + 1
                numfor = int((fordist + sbuffer) / lane_ds) + 1
                teval = np.concatenate([
                    np.linspace(-backdist - sbuffer, 0.0, numback + 1)[:-1],
                    np.linspace(0.0, fordist + sbuffer, numfor),
                ])
                pts = interp(teval)
                pts = pts + (egoxy - cclose)[None, :] * np.exp(
                    -np.square(teval) / lane_sig ** 2
                )[:, None]
                out.append(xy2spline(pts, numback, egoh))
    return out


# ---------------------------------------------------------------------------
# speed profiles and scoring (reference :670-895)
# ---------------------------------------------------------------------------

def compute_speed_profile(s, stgt, acc, nsteps, preddt):
    if stgt > s:
        prof = s + np.arange(nsteps + 1) * acc * preddt
        return np.minimum(prof, stgt)
    if stgt < s:
        prof = s - np.arange(nsteps + 1) * acc * preddt
        return np.maximum(prof, stgt)
    return np.full(nsteps + 1, float(s))


def sprof2dists(sprof, preddt):
    d = np.zeros(len(sprof))
    d[1:] = np.cumsum(sprof[1:] * preddt)
    return d


def gen_sprofiles(s0, preddt, nsteps, planaccfacs, maxacc, smax, NS):
    """Two-phase candidate speed profiles (reference :804-826)."""
    n1 = nsteps // 2
    n2 = nsteps - n1
    out = []
    for fac in planaccfacs:
        acc = fac * maxacc
        top = min(smax, s0 + n1 * preddt * acc)
        bot = max(0.0, s0 - n1 * preddt * acc)
        for s1 in np.linspace(bot, top, NS):
            p1 = compute_speed_profile(s0, s1, acc, n1, preddt)
            top2 = min(smax, p1[-1] + n2 * preddt * acc)
            bot2 = max(0.0, p1[-1] - n2 * preddt * acc)
            for s2 in np.linspace(bot2, top2, NS):
                p2 = compute_speed_profile(p1[-1], s2, acc, n2, preddt)
                prof = np.concatenate([p1, p2[1:]])
                out.append({"sprof": prof,
                            "teval": sprof2dists(prof, preddt),
                            "acc": acc, "s1": s1, "s2": s2})
    return out


def boxes2circles(b):
    """(T, N, 5=x,y,h,l,w) -> (T, N, 5, 3=x,y,r) disc cover
    (reference :860-882)."""
    XY, Hi, Li, Wi = b[:, :, :2], b[:, :, 2], b[:, :, 3], b[:, :, 4]
    L = np.maximum(Li, Wi)
    W = np.minimum(Li, Wi)
    H = np.where(Li < Wi, Hi + np.pi / 2.0, Hi)
    v0 = ((L - W) / 2 + W / 4)[..., None] * np.stack([np.cos(H), np.sin(H)], -1)
    v1 = (W / 4)[..., None] * np.stack([-np.sin(H), np.cos(H)], -1)
    c = np.empty(b.shape[:2] + (5, 3))
    c[:, :, 0, :2] = XY + v0 + v1
    c[:, :, 1, :2] = XY - v0 + v1
    c[:, :, 2, :2] = XY - v0 - v1
    c[:, :, 3, :2] = XY + v0 - v1
    c[:, :, 4, :2] = XY
    c[:, :, 4, 2] = W / 2
    c[:, :, :4, 2] = (W / 4)[..., None]
    return c


def approx_bbox_distance(b0, b1):
    """Min circle-to-circle clearance per timestep (reference :885-895)."""
    T, N0, _ = b0.shape
    _, N1, _ = b1.shape
    c0 = boxes2circles(b0).reshape(T, N0, 5, 1, 1, 3)
    c1 = boxes2circles(b1).reshape(T, 1, 1, N1, 5, 3)
    dist = (np.linalg.norm(c1[..., :2] - c0[..., :2], axis=-1)
            - c0[..., 2] - c1[..., 2])
    return np.amin(dist, axis=(2, 3, 4))


def score_dists(dists, score_wmin, score_wfac):
    w = score_wmin + np.arange(len(dists)) * score_wfac
    probs = 1.0 + np.tanh(-dists * w)
    probs[dists < 0] = 1.0
    return probs


def xyh2speed(x0, y0, x1, y1, h1, dt):
    sabs = np.hypot(x1 - x0, y1 - y0) / dt
    sign = 1.0 if (x1 - x0) * np.cos(h1) + (y1 - y0) * np.sin(h1) >= 0 else -1.0
    return sign * sabs


def postprocess_act_for_speed(x0, y0, h0, x1, y1, h1, s1, dt):
    """Snap (x1, y1, h1) so the implied speed is exactly s1
    (reference :642-666)."""
    def const_heading():
        return x0 + np.cos(h0) * s1 * dt, y0 + np.sin(h0) * s1 * dt, h0

    sp = xyh2speed(x0, y0, x1, y1, h1, dt)
    if np.sign(sp) != np.sign(s1):
        return const_heading()
    diff = np.array([x1 - x0, y1 - y0])
    dist = np.linalg.norm(diff)
    if dist == 0.0:
        return const_heading()
    diff = diff / dist
    return x0 + diff[0] * abs(s1) * dt, y0 + diff[1] * abs(s1) * dt, h1


# ---------------------------------------------------------------------------
# world-state machinery
# ---------------------------------------------------------------------------

def compute_splines(wstate, lg, cfg):
    cdistmax = 1.0 - np.cos(np.radians(cfg.cdistang))
    tmax = cfg.nsteps * cfg.preddt
    for obj in wstate["objs"].values():
        matches = get_lane_matches(obj["x"], obj["y"], obj["h"], lg,
                                   cdistmax, cfg.xydistmax)
        obj["final_matches"] = cluster_matches_combine(obj["x"], obj["y"],
                                                       matches, lg)
        backdist = 1.0 if obj["s"] > 0 else 1.0 + abs(obj["s"]) * tmax
        fordist = (1.0 + cfg.smax * tmax if obj["s"] < 0
                   else max(1.0 + cfg.smax * tmax, 1.0 + obj["s"] * tmax))
        obj["splines"] = get_prediction_splines(
            obj["final_matches"], lg, backdist, fordist, cfg.xydistmax,
            np.array([obj["x"], obj["y"]]), obj["h"],
        )
    return wstate


def collect_other_trajs(wstate, egoid, cfg):
    """Predicted futures for nearby agents along their splines
    (reference :694-721). Returns (nsteps+1, K, 5)."""
    ego = wstate["objs"][egoid]
    trajs = []
    for oid, other in wstate["objs"].items():
        if oid == egoid:
            continue
        if np.hypot(ego["x"] - other["x"], ego["y"] - other["y"]) > cfg.interacdist:
            continue
        sprofs = [
            compute_speed_profile(other["s"], other["s"] * sf,
                                  cfg.accmax * af, cfg.nsteps, cfg.preddt)
            for sf in cfg.predsfacs for af in cfg.predafacs
        ]
        tevals = [sprof2dists(p, cfg.preddt) for p in sprofs]
        for spline in other["splines"]:
            for teval in tevals:
                xyhh = spline(teval)
                tr = np.empty((cfg.nsteps + 1, 5))
                tr[:, :2] = xyhh[:, :2]
                tr[:, 2] = np.arctan2(xyhh[:, 3], xyhh[:, 2])
                tr[:, 3] = other["l"]
                tr[:, 4] = other["w"]
                trajs.append(tr)
    if trajs:
        return np.transpose(np.array(trajs), (1, 0, 2))
    return np.empty((cfg.nsteps + 1, 0, 5))


def choose_profile(otherobjs, sprofs, ego, egospline, cfg, prefer_stop):
    """Pick the speed profile (reference plot_plan_info :768-801)."""
    if otherobjs.shape[1] == 0:
        return sprofs[int(np.argmax([p["teval"][-1] for p in sprofs]))]
    egotraj = np.empty((cfg.nsteps + 1, 1, 5))
    egotraj[:, :, 3] = ego["l"]
    egotraj[:, :, 4] = ego["w"]
    probs = []
    for p in sprofs:
        locs = egospline(p["teval"])
        egotraj[:, 0, :2] = locs[:, :2]
        egotraj[:, 0, 2] = np.arctan2(locs[:, 3], locs[:, 2])
        d = approx_bbox_distance(egotraj, otherobjs)[:, 0]
        pr = score_dists(d, cfg.score_wmin, cfg.score_wfac)
        probs.append(1.0 - np.prod(1.0 - pr))
    ok = [i for i in range(len(sprofs)) if probs[i] < cfg.col_plim]
    if not ok:
        return sprofs[int(np.argmin(probs))]
    dists = [sprofs[i]["teval"][-1] for i in ok]
    pick = int(np.argmin(dists)) if prefer_stop else int(np.argmax(dists))
    return sprofs[ok[pick]]


def compute_action(wstate, objid, cfg):
    """Plan one dt step for ``objid`` (reference :829-857)."""
    obj = wstate["objs"][objid]
    spline = obj["splines"][0]
    sprofs = gen_sprofiles(obj["s"], cfg.preddt, cfg.nsteps, cfg.planaccfacs,
                           cfg.accmax, cfg.smax, cfg.plannspeeds)
    others = collect_other_trajs(wstate, objid, cfg)
    prefer_stop = len(obj["final_matches"]["closest"]) == 0
    sprof = choose_profile(others, sprofs, obj, spline, cfg, prefer_stop)
    stgt = compute_speed_profile(obj["s"], sprof["s1"], sprof["acc"], 1,
                                 cfg.dt)[1]
    newx, newy, newhc, newhs = spline(np.array([cfg.dt * stgt]))[0]
    newh = np.arctan2(newhs, newhc)
    newx, newy, newh = postprocess_act_for_speed(
        obj["x"], obj["y"], obj["h"], newx, newy, newh, stgt, cfg.dt
    )
    obj["control"] = {"x": newx, "y": newy, "h": newh}


def update_wstate(wstate, agent_data, dt):
    """Advance the world one dt: controlled agents apply their control,
    others are interpolated from observations; out-of-horizon agents drop
    out (reference :601-621)."""
    t1 = wstate["t"] + dt
    new = {"t": t1, "objs": {}}
    for oid, obj in wstate["objs"].items():
        if "control" in obj:
            sp = xyh2speed(obj["x"], obj["y"], obj["control"]["x"],
                           obj["control"]["y"], obj["control"]["h"], dt)
            new["objs"][oid] = {"x": obj["control"]["x"],
                                "y": obj["control"]["y"],
                                "h": obj["control"]["h"], "s": sp,
                                "l": obj["l"], "w": obj["w"]}
        else:
            info = agent_data["objs"][oid]
            if info["t0"] <= t1 <= info["t1"]:
                x, y, hc, hs = info["interp"](np.array([t1]))[0]
                h = np.arctan2(hs, hc)
                sp = xyh2speed(obj["x"], obj["y"], x, y, h, dt)
                new["objs"][oid] = {"x": x, "y": y, "h": h, "s": sp,
                                    "l": obj["l"], "w": obj["w"]}
    return new


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

class RulePlanner:
    """Reference HardcodeNuscPlanner-equivalent (:65-276).

    ``lane_graphs`` maps map-name -> lane-graph dict; ``cfg`` is a
    PlannerConfig built from PLANNER_CONFIGS.
    """

    def __init__(self, lane_graphs, map_names, cfg):
        self.lane_graphs = lane_graphs
        self.map_names = list(map_names)
        self.cfg = cfg if isinstance(cfg, PlannerConfig) else PlannerConfig(**cfg)
        self.init_wstate = None
        self.B = None
        self.batch_maps = None
        self.ego_idx = 0

    @staticmethod
    def _obj_id(aidx, ego_idx):
        return "ego" if aidx == ego_idx else "%04d" % aidx

    def _state_conv(self, states, lw):
        w = {"t": 0.0, "objs": {}}
        for aidx in range(states.shape[0]):
            x, y, hc, hs, s, _ = states[aidx]
            w["objs"][self._obj_id(aidx, self.ego_idx)] = {
                "x": float(x), "y": float(y), "h": float(np.arctan2(hs, hc)),
                "s": float(s), "l": float(lw[aidx, 0]), "w": float(lw[aidx, 1]),
            }
        return w

    def reset(self, init_state, vehicle_atts, batch_mask, batch_size, map_idx,
              ego_idx=0):
        """All inputs UNNORMALIZED numpy; see reference :109-127."""
        init_state = np.asarray(init_state)
        vehicle_atts = np.asarray(vehicle_atts)
        batch_mask = np.asarray(batch_mask)
        self.ego_idx = ego_idx
        self.B = int(batch_size)
        self.init_wstate = []
        for b in range(self.B):
            m = batch_mask == b
            self.init_wstate.append(
                self._state_conv(init_state[m], vehicle_atts[m])
            )
        self.batch_maps = [self.map_names[int(np.asarray(map_idx)[b])]
                           for b in range(self.B)]

    def _agent_interp(self, wstate, agt_obs, agt_t):
        """Interpolators for other agents' observed futures
        (reference create_other_agents :140-176)."""
        data = {"objs": {}}
        for aidx in range(agt_obs.shape[0]):
            oid = "%04d" % (aidx + 1 if aidx >= self.ego_idx else aidx)
            o = wstate["objs"][oid]
            s0 = np.array([[o["x"], o["y"], np.cos(o["h"]), np.sin(o["h"])]])
            states = np.concatenate([s0, agt_obs[aidx]], axis=0)
            nan_rows = np.isnan(states.sum(axis=1))
            first_nan = (states.shape[0] if not nan_rows.any()
                         else int(np.nonzero(nan_rows)[0][0]))
            if first_nan == 1:
                data["objs"][oid] = {"t0": 0.0, "t1": 0.0, "interp": None}
                continue
            ts = np.concatenate([[0.0], agt_t[: first_nan - 1]])
            data["objs"][oid] = {
                "t0": 0.0, "t1": float(ts[-1]),
                "interp": PiecewiseLinear(ts, states[:first_nan]),
            }
        return data

    def rollout(self, agent_obs, agent_t, agent_ptr, planner_t,
                control_all=False):
        """Roll the planner through every scene (reference :178-276).

        :param agent_obs: (NA-B, T, 4) UNNORMALIZED non-ego futures
            (None when control_all)
        :param agent_t: (T,) observation timestamps from dt
        :param agent_ptr: (B+1,) scene offsets into agent_obs
        :param planner_t: (T,) output timestamps
        :return: (B, T, 4) planner trajectory (x, y, hx, hy)
        """
        assert self.init_wstate is not None, "call reset() first"
        cfg = self.cfg
        Tsteps = int(planner_t[-1] / cfg.dt)
        out_t = np.linspace(cfg.dt, cfg.dt * Tsteps, Tsteps + 1)
        outs = []
        for b in range(self.B):
            wstate = deepcopy(self.init_wstate[b])
            lg = self.lane_graphs[self.batch_maps[b]]
            agent_data = None
            if agent_obs is not None and not control_all:
                cur = agent_obs[agent_ptr[b]:agent_ptr[b + 1]]
                agent_data = self._agent_interp(wstate, cur, agent_t)

            states = []
            compute_splines(wstate, lg, cfg)
            compute_action(wstate, "ego", cfg)
            states.append(self._ego_out(wstate))
            for _ in range(Tsteps):
                wstate = update_wstate(wstate, agent_data, cfg.dt)
                compute_splines(wstate, lg, cfg)
                compute_action(wstate, "ego", cfg)
                states.append(self._ego_out(wstate))
            outs.append(np.stack(states, axis=0))

        outs = np.stack(outs, axis=0)  # (B, Tsteps+1, 4)
        # resample to the requested output timestamps per batch
        result = np.empty((self.B, len(planner_t), 4))
        for b in range(self.B):
            pl = PiecewiseLinear(out_t, outs[b])
            result[b] = pl(np.asarray(planner_t))
        return result

    @staticmethod
    def _ego_out(wstate):
        c = wstate["objs"]["ego"]["control"]
        return np.array([c["x"], c["y"], np.cos(c["h"]), np.sin(c["h"])])
