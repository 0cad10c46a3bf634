"""Plain PyTorch of STRIVE's rule-based planner ``HardcodeNuscPlanner``
(nv-tlabs/STRIVE ``src/planners/hardcode_goalcond_nusc.py:65-895``), the
reference of the closed-loop cell's planner check: float64 on the CPU, one
scene, one agent and one route at a time. It imports neither the program
nor JAX.

A rollout plans the ego of each scene every ``dt`` from t = 0 (the first
action) to the last requested time (:178-276). Each plan step:

1. every agent near the ego is matched to the edges of its scene's map
   whose heading lies within ``cdistang`` of its own and whose closest
   point lies within ``xydistmax``; the matches are clustered closest
   first, a cluster taking every match reachable from its first through
   matched edges, forward and back (:298-347);
2. from each cluster's edge the lane graph is walked forward and backward,
   breadth first, forking at every branch, until the walk is longer than
   the furthest profile's reach plus ``SBUFFER`` and ``xydistmax``
   (:379-414); each pair of a forward and a backward walk is a route,
   extended straight past a dead end (:416-431), its arc length measured
   from its locally closest point to the agent (:433-452), resampled every
   ``LANE_DS`` m and warped through the agent's pose with a Gaussian of
   ``LANE_SIG`` m, its heading at the agent forced to the agent's
   (:455-556); an agent matched to no lane gets a straight route along its
   heading (:477-485);
3. the ego's two-phase speed profiles (:804-826); each other agent within
   ``interacdist`` of the ego predicted along each of its routes at its
   speed times each of ``predsfacs``, reached at ``accmax`` times each of
   ``predafacs`` (:670-721);
4. each profile scored by the collision probability of its 5-circle cover
   against every predicted box, with weights growing in time (:724-728,
   860-895); the farthest profile under ``col_plim`` is taken, the shortest
   one when the ego matched no lane, the least likely to collide when none
   is under it (:768-801);
5. the ego steps ``dt`` along its first route (closest cluster, each walk's
   first branch) at the profile's speed after ``dt``, snapped to exactly
   that speed (:642-666, 829-857); every other agent moves to its observed
   future at the new time, its speed the signed finite difference, and
   leaves the scene after its last observation (:601-621);
6. the ego's poses lie on the published ``linspace(dt, dt * T, T + 1)``
   and are resampled linearly at the requested times (:263-270).

Departures from the published planner:

- its scipy interpolators are piecewise linear here, holding the end
  values outside their knots;
- ``T`` is the last requested time over ``dt``, rounded (not truncated);
- routes are built only for the ego and the agents within
  ``interacdist`` of it, the only ones a plan step reads, and the edges
  matched against an agent are those of its map's grid cells around it
  (cells wider than ``xydistmax`` plus the longest edge, so no edge that
  can match is left out): the same plan, for less work.
"""

from __future__ import annotations

import math
from collections import deque

import torch

LANE_DS = 0.4   # route resampling step (m)
LANE_SIG = 3.5  # Gaussian warp through the agent's pose (m)
SBUFFER = 4.0   # route length beyond the furthest reach (m)

# the two published configurations (:22-63)
CONFIGS = {
    "default": {
        "dt": 0.2, "preddt": 0.2, "nsteps": 25, "cdistang": 20.0,
        "xydistmax": 2.0, "smax": 15.0, "accmax": 3.0,
        "predsfacs": [0.5, 1.0], "predafacs": [0.5], "interacdist": 70.0,
        "planaccfacs": [1.0], "plannspeeds": 5, "col_plim": 0.1,
        "score_wmin": 0.7, "score_wfac": 0.05},
}
CONFIGS["final_tuned_val_1"] = dict(
    CONFIGS["default"], smax=20.0, accmax=4.0, score_wmin=0.3,
    score_wfac=0.02)

F64 = torch.float64


def interp(q, t, v):
    """Piecewise-linear interpolation of knots ``t`` (P,), non-decreasing,
    with values ``v`` (P, C) at queries ``q`` (Q,): (Q, C), the end
    values outside the knots."""
    i = (torch.searchsorted(t, q, right=True) - 1).clamp(0, t.shape[0] - 2)
    t0, t1 = t[i], t[i + 1]
    w = torch.where(t1 > t0, (q - t0) / (t1 - t0).clamp_min(1e-300),
                    torch.zeros_like(q)).clamp(0.0, 1.0)
    return v[i] * (1.0 - w)[:, None] + v[i + 1] * w[:, None]


class Route:
    """A route as the planner reads it: arc length ``t`` (P,) and
    (x, y, hcos, hsin) ``v`` (P, 4)."""

    def __init__(self, t, v):
        self.t, self.v = t, v

    def __call__(self, q):
        return interp(q, self.t, self.v)


def straight_route(x, y, h, back, fwd):
    c, s = math.cos(h), math.sin(h)
    return Route(torch.tensor([-back, fwd], dtype=F64),
                 torch.tensor([[x - back * c, y - back * s, c, s],
                               [x + fwd * c, y + fwd * s, c, s]], dtype=F64))


class LaneGraph:
    """One map's lane graph (the planners' dict) in float64, with its
    edges binned in square cells for the match."""

    def __init__(self, lg, cell):
        self.xy = torch.as_tensor(lg["xy"], dtype=F64)
        self.xyl = self.xy.tolist()
        self.out_edges = [list(map(int, o)) for o in lg["out_edges"]]
        self.in_edges = [list(map(int, o)) for o in lg["in_edges"]]
        self.edges = torch.as_tensor(lg["edges"], dtype=F64)
        self.ixl = [tuple(map(int, r)) for r in lg["edgeixes"]]
        self.cell = cell + float(self.edges[:, 4].max())
        key = torch.floor(self.edges[:, :2] / self.cell).to(torch.int64)
        self.bins = {}
        for e, k in enumerate(map(tuple, key.tolist())):
            self.bins.setdefault(k, []).append(e)
        self.bins = {k: torch.tensor(v) for k, v in self.bins.items()}

    def near(self, x, y):
        """Edge ids (ascending) whose start lies in the 3 x 3 cells around
        (x, y)."""
        cx, cy = math.floor(x / self.cell), math.floor(y / self.cell)
        got = [self.bins[(cx + i, cy + j)] for i in (-1, 0, 1)
               for j in (-1, 0, 1) if (cx + i, cy + j) in self.bins]
        if not got:
            return torch.zeros(0, dtype=torch.int64)
        return torch.sort(torch.cat(got)).values


def lane_matches(x, y, h, g: LaneGraph, cdistmax, xydistmax):
    """:return: matched edge ids and their closest points (n, 2) (:298-321),
    in edge order."""
    ids = g.near(x, y)
    e = g.edges[ids]
    cdist = 1.0 - e[:, 2] * math.cos(h) - e[:, 3] * math.sin(h)
    dx, dy = x - e[:, 0], y - e[:, 1]
    lmag = torch.minimum((dx * e[:, 2] + dy * e[:, 3]).clamp_min(0.0),
                         e[:, 4])
    cx, cy = e[:, 0] + lmag * e[:, 2], e[:, 1] + lmag * e[:, 3]
    dist = torch.hypot(x - cx, y - cy)
    ok = (cdist < cdistmax) & (dist < xydistmax)
    return ids[ok], torch.stack([cx[ok], cy[ok]], 1)


def cluster(x, y, ids, closest, g: LaneGraph):
    """Closest-first representatives of the matches, each removing every
    match reachable from it through matched edges (:324-347).

    :return: [(v0, v1)] of the representative edges"""
    seen = {g.ixl[e]: False for e in ids.tolist()}
    order = torch.argsort(torch.hypot(closest[:, 0] - x, closest[:, 1] - y),
                          stable=True)
    reps = []
    for k in order.tolist():
        v0, v1 = g.ixl[int(ids[k])]
        if seen[(v0, v1)]:
            continue
        reps.append((v0, v1))
        for fwd in (True, False):
            qu = deque([(v0, v1)])
            while qu:
                c0, c1 = qu.popleft()
                seen[(c0, c1)] = True
                for n in (g.out_edges[c1] if fwd else g.in_edges[c0]):
                    key = (c1, n) if fwd else (n, c0)
                    if key in seen and not seen[key]:
                        qu.append(key)
    return reps


def walks(v0, g: LaneGraph, conns, mindist):
    """Breadth-first walks from vertex ``v0`` along ``conns``, forking at
    every branch, each until it is longer than ``mindist`` or ends
    (:379-414): [(vertex ids, length)], the first branch's walk first."""
    xy = g.xyl
    qu = deque([([v0], 0.0)])
    out = []
    while qu:
        vs, ln = qu.popleft()
        while ln <= mindist:
            v = vs[-1]
            if not conns[v]:
                break
            for w in conns[v][1:]:
                qu.append((vs + [w], ln + math.dist(xy[w], xy[v])))
            w = conns[v][0]
            ln += math.dist(xy[w], xy[v])
            vs = vs + [w]
        out.append((vs, ln))
    return out


def _extend(xys, le, forward):
    """One point ``le`` m on, straight past the end (:416-431)."""
    if forward:
        d = xys[-1] - xys[-2]
        return torch.cat([xys, (xys[-1] + d / d.norm() * le)[None]])
    d = xys[0] - xys[1]
    return torch.cat([(xys[0] + d / d.norm() * le)[None], xys])


def local_closest(xys, ix0, p):
    """The locally closest segment to ``p`` walked out from segment ``ix0``
    and its closest point (:433-452)."""
    seg = xys[1:] - xys[:-1]
    ln = seg.norm(dim=1)
    u = seg / ln[:, None]
    lmag = torch.minimum(((p - xys[:-1]) * u).sum(1).clamp_min(0.0), ln)
    c = xys[:-1] + lmag[:, None] * u
    d = (p - c).norm(dim=1).tolist()
    i = min(ix0, len(d) - 1)
    while i - 1 >= 0 and d[i - 1] < d[i]:
        i -= 1
    while i + 1 < len(d) and d[i + 1] < d[i]:
        i += 1
    return i, c[i]


def route(xys, ix0, x, y, h, back, fwd):
    """The warped route through the agent of polyline ``xys`` whose
    segment ``ix0`` is the matched edge (:487-556, 455-474)."""
    p = torch.tensor([x, y], dtype=F64)
    i, cc = local_closest(xys, ix0, p)
    t = torch.cat([torch.zeros(1, dtype=F64),
                   torch.cumsum((xys[1:] - xys[:-1]).norm(dim=1), 0)])
    t = t - t[i] - (cc - xys[i]).norm()
    nb = int((back + SBUFFER) / LANE_DS) + 1
    nf = int((fwd + SBUFFER) / LANE_DS) + 1
    q = torch.cat([torch.linspace(-back - SBUFFER, 0.0, nb + 1,
                                  dtype=F64)[:-1],
                   torch.linspace(0.0, fwd + SBUFFER, nf, dtype=F64)])
    pts = interp(q, t, xys) + (p - cc)[None] * torch.exp(
        -q * q / LANE_SIG ** 2)[:, None]
    seg = pts[1:] - pts[:-1]
    ln = seg.norm(dim=1)
    head = seg / ln.clamp_min(1e-12)[:, None]
    head = torch.cat([head, head[-1:]])
    head[nb] = torch.tensor([math.cos(h), math.sin(h)], dtype=F64)
    tt = torch.cat([torch.zeros(1, dtype=F64), torch.cumsum(ln, 0)])
    return Route(tt - tt[nb], torch.cat([pts, head], 1))


def routes(a, g: LaneGraph, cfg, first=False):
    """The routes of agent ``a`` (a dict x, y, h, s), or its first alone,
    and whether it matched a lane (:224-236 compute_splines)."""
    x, y, h, s = a["x"], a["y"], a["h"], a["s"]
    tmax = cfg["nsteps"] * cfg["preddt"]
    back = 1.0 if s > 0 else 1.0 + abs(s) * tmax
    fwd = (1.0 + cfg["smax"] * tmax if s < 0
           else max(1.0 + cfg["smax"] * tmax, 1.0 + s * tmax))
    ids, closest = lane_matches(
        x, y, h, g, 1.0 - math.cos(math.radians(cfg["cdistang"])),
        cfg["xydistmax"])
    if ids.numel() == 0:
        return [straight_route(x, y, h, back, fwd)], False
    reach = fwd + SBUFFER + cfg["xydistmax"]
    breach = back + SBUFFER + cfg["xydistmax"]
    out = []
    for v0, v1 in cluster(x, y, ids, closest, g):
        fw = walks(v1, g, g.out_edges, reach)
        bw = walks(v0, g, g.in_edges, breach)
        for fv, fl in fw:
            for bv, bl in bw:
                xys = g.xy[bv[::-1] + fv]
                ix0 = len(bv) - 1
                if fl <= reach:
                    xys = _extend(xys, 1.0 + reach - fl, True)
                if bl <= breach:
                    xys = _extend(xys, 1.0 + breach - bl, False)
                    ix0 += 1
                out.append(route(xys, ix0, x, y, h, back, fwd))
                if first:
                    return out, True
    return out, True


def speed_profile(s, stgt, acc, n, dt):
    k = torch.arange(n + 1, dtype=F64)
    if stgt > s:
        return torch.minimum(s + k * acc * dt, torch.tensor(stgt, dtype=F64))
    if stgt < s:
        return torch.maximum(s - k * acc * dt, torch.tensor(stgt, dtype=F64))
    return torch.full((n + 1,), float(s), dtype=F64)


def dists(prof, dt):
    return torch.cat([torch.zeros(1, dtype=F64), torch.cumsum(prof[1:] * dt,
                                                              0)])


def ego_profiles(s0, cfg):
    """The ego's two-phase profiles, fac-major then first then second
    speed (:804-826): [(distances (nsteps+1,), first speed, acc)]."""
    n1 = cfg["nsteps"] // 2
    n2 = cfg["nsteps"] - n1
    dt, NS, smax = cfg["preddt"], cfg["plannspeeds"], cfg["smax"]
    out = []
    for fac in cfg["planaccfacs"]:
        acc = fac * cfg["accmax"]
        top = min(smax, s0 + n1 * dt * acc)
        bot = max(0.0, s0 - n1 * dt * acc)
        for s1 in torch.linspace(bot, top, NS, dtype=F64).tolist():
            p1 = speed_profile(s0, s1, acc, n1, dt)
            e1 = float(p1[-1])
            top2 = min(smax, e1 + n2 * dt * acc)
            bot2 = max(0.0, e1 - n2 * dt * acc)
            for s2 in torch.linspace(bot2, top2, NS, dtype=F64).tolist():
                p2 = speed_profile(e1, s2, acc, n2, dt)
                out.append((dists(torch.cat([p1, p2[1:]]), dt), s1, acc))
    return out


def circles(b):
    """(..., 5 = x, y, h, l, w) boxes -> (..., 5, 3 = x, y, r) discs
    (:860-882)."""
    xy, h, l, w = b[..., :2], b[..., 2], b[..., 3], b[..., 4]
    L, W = torch.maximum(l, w), torch.minimum(l, w)
    h = torch.where(l < w, h + math.pi / 2.0, h)
    c, s = torch.cos(h), torch.sin(h)
    v0 = ((L - W) / 2 + W / 4)[..., None] * torch.stack([c, s], -1)
    v1 = (W / 4)[..., None] * torch.stack([-s, c], -1)
    ctr = torch.stack([xy + v0 + v1, xy - v0 + v1, xy - v0 - v1,
                       xy + v0 - v1, xy], -2)
    r = torch.stack([W / 4] * 4 + [W / 2], -1)
    return torch.cat([ctr, r[..., None]], -1)


def fans(near, rts, cfg):
    """Every predicted box of the agents ``near`` the ego along their
    routes ``rts``, (nsteps+1, K, 5) (:694-721)."""
    out = []
    for a in near:
        tev = [dists(speed_profile(a["s"], a["s"] * sf, cfg["accmax"] * af,
                                   cfg["nsteps"], cfg["preddt"]),
                     cfg["preddt"])
               for sf in cfg["predsfacs"] for af in cfg["predafacs"]]
        for r in rts[id(a)]:
            for q in tev:
                v = r(q)
                out.append(torch.stack([
                    v[:, 0], v[:, 1], torch.atan2(v[:, 3], v[:, 2]),
                    torch.full_like(q, a["l"]), torch.full_like(q, a["w"])],
                    -1))
    if not out:
        return torch.zeros((cfg["nsteps"] + 1, 0, 5), dtype=F64)
    return torch.stack(out, 1)


def choose(ego, boxes, profs, rte, prefer_stop, cfg):
    """The chosen profile's index (:768-801)."""
    reach = [float(d[-1]) for d, _, _ in profs]
    if boxes.shape[1] == 0:
        return max(range(len(profs)), key=lambda i: (reach[i], -i))
    q = torch.stack([d for d, _, _ in profs])               # (NP, T1)
    v = rte(q.reshape(-1)).reshape(*q.shape, 4)
    eb = torch.stack([v[..., 0], v[..., 1], torch.atan2(v[..., 3], v[..., 2]),
                      torch.full_like(q, ego["l"]),
                      torch.full_like(q, ego["w"])], -1)     # (NP, T1, 5)
    ce = circles(eb)[:, :, :, None, None]                    # NP,T1,5,1,1,3
    co = circles(boxes)[None, :, None]                       # 1,T1,1,K,5,3
    d = ((ce[..., :2] - co[..., :2]).norm(dim=-1) - ce[..., 2]
         - co[..., 2]).amin(dim=(2, 3, 4))                   # (NP, T1)
    w = cfg["score_wmin"] + torch.arange(d.shape[1], dtype=F64) \
        * cfg["score_wfac"]
    pr = torch.where(d < 0, torch.ones_like(d), 1.0 + torch.tanh(-d * w))
    p = (1.0 - torch.prod(1.0 - pr, dim=1)).tolist()
    ok = [i for i in range(len(p)) if p[i] < cfg["col_plim"]]
    if not ok:
        return min(range(len(p)), key=lambda i: (p[i], i))
    if prefer_stop:
        return min(ok, key=lambda i: (reach[i], i))
    return max(ok, key=lambda i: (reach[i], -i))


def signed_speed(x0, y0, x1, y1, h1, dt):
    sp = math.hypot(x1 - x0, y1 - y0) / dt
    fwd = (x1 - x0) * math.cos(h1) + (y1 - y0) * math.sin(h1) >= 0
    return sp if fwd else -sp


def _sign(v):
    return (v > 0) - (v < 0)


def step_ego(ego, others, g, cfg):
    """The ego's control after one plan step (:224-246, 829-857, 642-666)."""
    near = [a for a in others if math.hypot(
        ego["x"] - a["x"], ego["y"] - a["y"]) <= cfg["interacdist"]]
    rte, matched = routes(ego, g, cfg, first=True)
    rts = {id(a): routes(a, g, cfg)[0] for a in near}
    profs = ego_profiles(ego["s"], cfg)
    pick = choose(ego, fans(near, rts, cfg), profs, rte[0],
                  not matched, cfg)
    _, s1, acc = profs[pick]
    dt = cfg["dt"]
    stgt = float(speed_profile(ego["s"], s1, acc, 1, dt)[1])
    x1, y1, hc, hs = rte[0](torch.tensor([dt * stgt], dtype=F64))[0].tolist()
    h1 = math.atan2(hs, hc)
    x0, y0, h0 = ego["x"], ego["y"], ego["h"]
    dist = math.hypot(x1 - x0, y1 - y0)
    if _sign(signed_speed(x0, y0, x1, y1, h1, dt)) != _sign(stgt) or \
            dist == 0.0:
        return (x0 + math.cos(h0) * stgt * dt,
                y0 + math.sin(h0) * stgt * dt, h0)
    return (x0 + (x1 - x0) / dist * abs(stgt) * dt,
            y0 + (y1 - y0) / dist * abs(stgt) * dt, h1)


class Planner:
    """The planner over scenes on the maps ``map_names`` of
    ``lane_graphs`` ({name: lane-graph dict}), with configuration ``cfg``
    (a dict as :data:`CONFIGS`' entries)."""

    def __init__(self, lane_graphs, map_names, cfg):
        self.cfg = dict(cfg)
        self.graphs = [LaneGraph(lane_graphs[m], self.cfg["xydistmax"])
                       for m in map_names]

    def rollout_scene(self, init, lw, alive, obs, obs_t, plan_t, mi):
        """One scene. :param init: (NA, 6) x, y, hx, hy, s, hdot; lw (NA,
        2); alive (NA,) bool; obs (NA, TO, 4) observed futures of the
        others (row 0, the ego's, not read; a NaN row ends an agent's
        observations); obs_t (TO,); plan_t (TQ,); all float64 tensors
        :return: (TQ, 4) the ego's x, y, hcos, hsin"""
        cfg = self.cfg
        g = self.graphs[mi]
        dt = cfg["dt"]
        T = int(round(float(plan_t[-1]) / dt))
        agents = []
        for a in range(init.shape[0]):
            if not bool(alive[a]):
                continue
            x, y, hc, hs, s, _ = init[a].tolist()
            ag = {"x": x, "y": y, "h": math.atan2(hs, hc), "s": s,
                  "l": float(lw[a, 0]), "w": float(lw[a, 1])}
            if a > 0:
                st = torch.cat([torch.tensor(
                    [[x, y, math.cos(ag["h"]), math.sin(ag["h"])]],
                    dtype=F64), obs[a]])
                bad = torch.isnan(st).any(1)
                n = int(bad.to(torch.int64).argmax()) if bool(bad.any()) \
                    else st.shape[0]
                ag["ts"] = torch.cat([torch.zeros(1, dtype=F64),
                                      obs_t[:n - 1]])
                ag["obs"] = st[:n]
            agents.append(ag)
        ego, others = agents[0], agents[1:]
        out, t = [], 0.0
        for _ in range(T + 1):
            x, y, h = step_ego(ego, others, g, cfg)
            out.append([x, y, math.cos(h), math.sin(h)])
            ego = dict(ego, x=x, y=y, h=h,
                       s=signed_speed(ego["x"], ego["y"], x, y, h, dt))
            # the published planner's clock, a sum of steps: its rounding
            # drops an agent observed to the horizon at the last step
            t += dt
            moved = []
            for a in others:
                if t > float(a["ts"][-1]):
                    continue
                nx, ny, nc, ns = interp(torch.tensor([t], dtype=F64),
                                        a["ts"], a["obs"])[0].tolist()
                nh = math.atan2(ns, nc)
                moved.append(dict(a, x=nx, y=ny, h=nh, s=signed_speed(
                    a["x"], a["y"], nx, ny, nh, dt)))
            others = moved
        out_t = torch.linspace(dt, dt * T, T + 1, dtype=F64)
        return interp(plan_t, out_t, torch.tensor(out, dtype=F64))

    def rollout(self, init, lw, alive, obs, obs_t, plan_t, map_idx):
        """Every scene of a batch: (B, NA, ...) inputs as
        :meth:`rollout_scene`'s, ``map_idx`` (B,): (B, TQ, 4)."""
        t = lambda a: torch.as_tensor(a).to(F64).cpu()
        init, lw, obs, obs_t, plan_t = map(t, (init, lw, obs, obs_t, plan_t))
        alive = torch.as_tensor(alive).cpu()
        return torch.stack([
            self.rollout_scene(init[b], lw[b], alive[b], obs[b], obs_t,
                               plan_t, int(map_idx[b]))
            for b in range(init.shape[0])])
