"""Device-side rule-based planner: the batched torch counterpart of
``strive_tpu/planners/tpu_planner.py``.

A fixed-shape reimplementation of the reference ``HardcodeNuscPlanner``
(``planners/hardcode_goalcond_nusc.py:65-276``) that keeps the closed-loop
planner on the card. Its bounded approximations are those of the JAX
planner (see that module's docstring): closest-first spatial dedupe into
MC cluster slots, greedy branch-coded edge walks of static length, a
static warp grid, and the speed >= 0 clamp of PARITY.md §16. On the CPU
the lane match is the JAX planner's dense one, every pose against every
stacked edge; on a card it is one kernel (``planners/lane_match.py``)
that scans each pose's own map's edges and picks the same
representatives.

Layout on the card:

- the lane tables are built once, when the planner is made, on its device
  (``DeviceTables.from_graphs``): torch copies of the JAX package's host
  precompute (``build_lane_tables``, ``stack_lane_tables``), the fields
  that the device functions read equal to its bit for bit. A numpy build
  took 44 s on an H100 machine's host for four maps of 376k edges at
  1 m; this one takes 0.4 s on the card;
- JAX's ``vmap``s over scenes, plan steps, agents, clusters and branch
  codes are leading batch axes here, so the planner adds launches per plan
  step, not per scene or per agent. The ego-independent half of every plan
  step (every other agent's splines, prediction fan and collision circles)
  runs as one batch over all plan steps; the ego's own plan is a Python
  loop over the plan steps;
- on a card, every call after the first of its shapes replays one CUDA
  graph of :func:`plan_rollout` (:class:`DeviceRulePlanner`): the same
  kernels, launched by one graph launch in place of ~12,500 from Python
  (nothing in a rollout reads a value back to the host);
- the lane match and its closest-first representatives
  (:func:`_match_reps`) are one launch of ``csrc/lane_match.cu`` on a
  card, in place of some thirty passes over (poses, stacked edges)
  temporaries; on the CPU the plain functions :func:`_match_edges` and
  :func:`_cluster_reps` compute them, and the card tests hold the two
  equal bit for bit;
- interpolation finds its interval with ``torch.searchsorted`` and reads
  the knots with gathers. The JAX planner's one-hot matmuls and dense
  compare-sums only avoid TPU gathers; they give the same interval
  wherever the knots are non-decreasing, which every knot vector here is.

Host and device planners agree on decisions, not bits: the host planner
interpolates in float64, this one computes in float32, like JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..maps.queries import linspace
from ..utils.spans import span
from .hardcode import LANE_DS, LANE_SIG, SBUFFER, PlannerConfig
from .lane_match import LAUNCHES as MATCH_LAUNCHES, lane_match

BIG = 1e9

# the planner's work, counted on the host where it is issued: rollouts;
# the pose-edge pairs that the lane match computes (on the CPU counted by
# ``_match_edges``, every pose against every stacked edge; on a card not
# counted but worked out per call by ``DeviceRulePlanner`` from the poses
# matched, the map ids it was reset with and each map's edge count: each
# pose against its own map's edges, as the kernel scans them); the poses
# matched (``_match_reps``), and those of them the kernel served; and the
# rollouts served by replaying a captured CUDA graph (``DeviceRulePlanner``;
# a capture is not a rollout)
COUNTS = {"calls": 0, "match_pairs": 0, "matches": 0, "kernel_matches": 0,
          "replays": 0}

# Branch codes (b1, b2): successor index taken at the first/second fork of
# a forward walk (reference expand_verts :379-414; PARITY.md §12 bounds
# the explored set to these four).
_BRANCH_CODES = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.int32)


class StaticPlanCfg(NamedTuple):
    """Static planner configuration (shapes + reference constants)."""

    dt: float
    preddt: float
    nsteps: int
    cdistmax: float
    xydistmax: float
    smax: float
    accmax: float
    predsfacs: tuple
    predafacs: tuple
    planaccfacs: tuple
    plannspeeds: int
    interacdist: float
    col_plim: float
    score_wmin: float
    score_wfac: float
    # fixed-shape bounds
    MC: int = 3            # cluster slots per agent
    NBR: int = 4           # forward branch codes per cluster
    dedupe_r: float = 2.0  # spatial cluster-dedupe radius (m)

    @classmethod
    def from_planner_config(cls, cfg: PlannerConfig):
        return cls(
            dt=float(cfg.dt), preddt=float(cfg.preddt),
            nsteps=int(cfg.nsteps),
            cdistmax=float(1.0 - np.cos(np.radians(cfg.cdistang))),
            xydistmax=float(cfg.xydistmax), smax=float(cfg.smax),
            accmax=float(cfg.accmax), predsfacs=tuple(cfg.predsfacs),
            predafacs=tuple(cfg.predafacs),
            planaccfacs=tuple(cfg.planaccfacs),
            plannspeeds=int(cfg.plannspeeds),
            interacdist=float(cfg.interacdist),
            col_plim=float(cfg.col_plim), score_wmin=float(cfg.score_wmin),
            score_wfac=float(cfg.score_wfac))

    @property
    def tmax(self):
        return self.nsteps * self.preddt

    @property
    def horizon(self):
        """Worst-case route distance FORWARD (reference :367-377 bounds)."""
        return 1.0 + self.smax * self.tmax + SBUFFER + self.xydistmax

    @property
    def NBF(self):
        """Forward warp-grid knots: cover the worst-case profile reach."""
        return int(self.horizon / LANE_DS) + 2

    @property
    def NBB(self):
        """Backward warp-grid knots: every spline query is a distance >= 0,
        so they only cover the Gaussian pose warp (4 sigma) and the match
        slack ``xydistmax``."""
        return int((self.xydistmax + 4.0 * LANE_SIG) / LANE_DS) + 2


class DeviceTables(NamedTuple):
    """What the device functions read, on one device: the lane-table arrays
    and the planner config's factor vectors (copied once, so that no plan
    step copies from the host)."""

    edges: torch.Tensor       # (E, 5) float32
    emap: torch.Tensor        # (E,) int64
    distc_f: torch.Tensor     # (E, 4) bool
    chainxy_f: torch.Tensor   # (E, 4, K+1, 2)
    chain0xy_f: torch.Tensor  # (E, K+1, 2)
    chain0xy_b: torch.Tensor  # (E, KB+1, 2)
    planaccfacs: torch.Tensor  # (F,) float32
    predsfacs: torch.Tensor    # (NSF,) float32
    predafacs: torch.Tensor    # (NAF,) float32
    edge_offsets: torch.Tensor  # (n_maps + 1,) int64: map m's first edge

    @classmethod
    def from_graphs(cls, lane_graphs, map_names, cfg: "StaticPlanCfg",
                    device):
        """The tables of the maps ``map_names``, built on ``device`` map
        by map (:func:`_map_tables`) and stacked on one edge axis, map m's
        edges contiguous from ``edge_offsets[m]``, with each edge's map id
        in ``emap``: the plain lane match masks the other maps' edges and
        the kernel scans the pose's map's range alone, so one table serves
        scenes on different maps (the walks need no offsets: they hold
        polylines, and adjacency never crosses maps)."""
        parts = [_map_tables(lane_graphs[m], device) for m in map_names]
        arrays = {f: torch.cat([p[f] for p in parts])
                  for f in ("edges", "distc_f", "chainxy_f", "chain0xy_f",
                            "chain0xy_b")}
        counts = [p["edges"].shape[0] for p in parts]
        arrays["emap"] = torch.cat([
            torch.full((n,), m, dtype=torch.int64, device=device)
            for m, n in enumerate(counts)])
        arrays["edge_offsets"] = torch.as_tensor(
            np.cumsum([0] + counts), dtype=torch.int64, device=device)
        for f in ("planaccfacs", "predsfacs", "predafacs"):
            arrays[f] = torch.as_tensor(
                np.asarray(getattr(cfg, f), np.float32), device=device)
        return cls(**arrays)


# ---------------------------------------------------------------------------
# lane tables, built on the device (torch copies of tpu_planner.py:85-439)
# ---------------------------------------------------------------------------


def _chain0(table, deg, endv, K):
    """(E, K+1) branch-0 walk vertices (always successor 0 of
    ``table``) + first fork step (K+1 = none) and the edge id there."""
    E = table.shape[0]
    dev = table.device
    chain = torch.full((E, K + 1), -1, dtype=torch.int64, device=dev)
    fork = torch.full((E,), K + 1, dtype=torch.int64, device=dev)
    forke = torch.zeros(E, dtype=torch.int64, device=dev)
    cur = torch.arange(E, device=dev)
    alive = torch.ones(E, dtype=torch.bool, device=dev)
    chain[:, 0] = endv[cur]
    for j in range(K):
        cc = torch.clamp_max(cur, E - 1)
        d = torch.where(alive, deg[cc], 0)
        at_fork = alive & (d > 1) & (fork > K)
        fork = torch.where(at_fork, j, fork)
        forke = torch.where(at_fork, cur, forke)
        nxt = torch.where(d > 0, table[cc, 0], E)
        alive = alive & (nxt < E)
        cur = torch.where(alive, nxt, cur)
        chain[:, j + 1] = torch.where(
            alive, endv[torch.clamp_max(cur, E - 1)], -1)
    return chain, fork, forke


def _chainc(chain0, fork, forke, succ, deg, codes):
    """(E, NC, K+1) branch-coded walks + (E, NC) distinctness: for
    every edge and branch code (b1, b2), the walk that takes successor
    ``b1`` at the first fork and ``b2`` at the next (reference expand_verts
    :379-414 explores these chains at runtime)."""
    E, K1 = chain0.shape
    NONE = K1
    e1 = torch.arange(E, device=chain0.device)

    def seg_after_fork(e, b):
        ec = torch.clamp_max(e, E - 1)
        f = torch.where(e < E, fork[ec], NONE)
        fe = torch.clamp_max(forke[ec], E - 1)
        b_used = torch.minimum(torch.full_like(fe, b),
                               torch.clamp_min(deg[fe] - 1, 0))
        nxt = succ[fe, b_used]
        return f, torch.where(f <= K1 - 1, nxt, E), b_used

    out = torch.empty((E, len(codes), K1), dtype=chain0.dtype,
                      device=chain0.device)
    dist = torch.empty((E, len(codes)), dtype=torch.bool,
                       device=chain0.device)
    i = torch.arange(K1, device=chain0.device)[None, :]
    for ci, (b1, b2) in enumerate(codes.tolist()):
        f1, e2, b1_used = seg_after_fork(e1, b1)
        f2, e3, b2_used = seg_after_fork(e2, b2)
        j2 = i - f1[:, None] - 1
        j3 = j2 - f2[:, None] - 1
        v = chain0[e1]
        use2 = (j2 >= 0) & (e2 < E)[:, None]
        c2 = chain0[torch.clamp_max(e2, E - 1)]
        v = torch.where(use2, torch.gather(c2, 1, j2.clamp(0, K1 - 1)), v)
        use3 = (j3 >= 0) & (e3 < E)[:, None] & use2
        c3 = chain0[torch.clamp_max(e3, E - 1)]
        v = torch.where(use3, torch.gather(c3, 1, j3.clamp(0, K1 - 1)), v)
        out[:, ci] = v
        dist[:, ci] = (((b1_used > 0) & (f1 <= K1 - 1))
                       | ((b2_used > 0) & (e2 < E) & (f2 <= K1 - 1)))
    return out, dist


def _extend_xy(chain_v, edges, vxy, edge_ids, forward):
    """Vertex-id chains -> (..., K+1, 2) polylines with dead ends
    extrapolated along the last valid direction (reference _extend
    :416-431). A walk with a SINGLE valid vertex takes the edge's own
    heading (float32 throughout, the JAX package's operations in its
    order).

    :param chain_v: (..., K+1) int vertex ids, -1 = invalid
    :param edge_ids: (...,) int edge id per chain (for the fallback dir)
    """
    E, V = edges.shape[0], vxy.shape[0]
    K1 = chain_v.shape[-1]
    i = torch.arange(K1, device=chain_v.device)
    valid = chain_v >= 0
    xy = vxy[chain_v.clamp(0, V - 1)]
    last = torch.where(valid, i, 0).amax(-1)                    # (...,)

    def at(k):
        idx = k[..., None, None].expand(*k.shape, 1, 2)
        return torch.gather(xy, -2, idx)[..., 0, :]

    p_last = at(last)
    p_prev = at(torch.clamp_min(last - 1, 0))
    d_seg = p_last - p_prev
    seg_norm = torch.sqrt((d_seg * d_seg).sum(-1))
    edge_dir = edges[torch.clamp_max(edge_ids, E - 1), 2:4]
    if not forward:
        edge_dir = -edge_dir
    d_last = torch.where((seg_norm > 1e-6)[..., None],
                         d_seg / torch.clamp_min(seg_norm, 1e-6)[..., None],
                         edge_dir)
    steps = (i - last[..., None]).to(torch.float32)
    extrap = (p_last[..., None, :]
              + torch.clamp_min(steps, 1.0)[..., None]
              * d_last[..., None, :])
    return torch.where(valid[..., None], xy, extrap)


def _adjacency(first, other):
    """For every edge e, where the edges whose ``first`` vertex is e's
    ``other`` one start in ``order`` (the edges sorted by that vertex,
    then by id), and how many there are."""
    order = torch.sort(first, stable=True).indices
    lo = torch.searchsorted(first[order], other, right=False)
    deg = torch.searchsorted(first[order], other, right=True) - lo
    return order, lo, deg


def _padded(order, lo, deg, S):
    """(E, S) of :func:`_adjacency`'s edges, padded with E."""
    E = order.shape[0]
    j = torch.arange(S, device=order.device)
    pos = torch.clamp_max(lo[:, None] + j, E - 1)
    return torch.where(j < deg[:, None], order[pos], E)


def _map_tables(lg, device, K=128, KB=32):
    """One map's share of :class:`DeviceTables`, built on ``device``:
    the fields of the JAX package's ``build_lane_tables`` that the device
    functions read, each equal to its bit for bit (the same integer walks;
    float32 subtractions, products, sums of two, divisions and square
    roots, each correctly rounded on the CPU and on the card).

    :param K: forward walk length (edges); must cover ``cfg.horizon``
        at ~1 m lane discretization.
    :param KB: backward walk length: the backward polyline only feeds the
        warp grid's ``cfg.NBB`` backward knots plus match slack."""
    edges = torch.as_tensor(np.asarray(lg["edges"]), device=device
                            ).to(torch.float32)
    ixes = torch.as_tensor(np.asarray(lg["edgeixes"], np.int64),
                           device=device)
    vxy = torch.as_tensor(np.asarray(lg["xy"]), device=device
                          ).to(torch.float32)
    E = edges.shape[0]
    src, dst = ixes[:, 0].contiguous(), ixes[:, 1].contiguous()
    fwd, bwd = _adjacency(src, dst), _adjacency(dst, src)
    S = max(1, int(fwd[2].max()), int(bwd[2].max()))
    succ, succ_deg = _padded(*fwd, S), fwd[2]
    pred, pred_deg = _padded(*bwd, S), bwd[2]
    cf, ff, fef = _chain0(succ, succ_deg, dst, K)
    cb, _, _ = _chain0(pred, pred_deg, src, KB)
    ccf, dcf = _chainc(cf, ff, fef, succ, succ_deg,
                       torch.as_tensor(_BRANCH_CODES))
    eid = torch.arange(E, device=device)
    return {"edges": edges, "distc_f": dcf,
            "chainxy_f": _extend_xy(ccf, edges, vxy,
                                    eid[:, None].expand(ccf.shape[:2]),
                                    True),
            "chain0xy_f": _extend_xy(cf, edges, vxy, eid, True),
            "chain0xy_b": _extend_xy(cb, edges, vxy, eid, False)}


# ---------------------------------------------------------------------------
# device functions: leading batch axes in place of JAX's vmaps
# ---------------------------------------------------------------------------


def _norm2(v):
    """Euclidean norm over a trailing axis of 2 (jnp.linalg.norm's form)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _interp_cols(tq, t, vals):
    """Piecewise-linear interp of knot values at queries, columnwise.

    :param tq: (..., Q) queries; t: (..., P) non-decreasing knots;
        vals: (..., P, C); leading axes broadcast
    :return: (..., Q, C)

    The interval is ``searchsorted(t, tq, right=True) - 1`` clamped to
    [0, P-2] (the count of knots <= tq, minus one: JAX's compare-sum),
    and the two knots are read with gathers."""
    lead = torch.broadcast_shapes(tq.shape[:-1], t.shape[:-1],
                                  vals.shape[:-2])
    P, Q, C = t.shape[-1], tq.shape[-1], vals.shape[-1]
    t = t.expand(*lead, P).contiguous()
    tq = tq.expand(*lead, Q).contiguous()
    i = (torch.searchsorted(t, tq, right=True) - 1).clamp(0, P - 2)
    t0 = torch.gather(t, -1, i)
    t1 = torch.gather(t, -1, i + 1)
    w = torch.where(t1 > t0, (tq - t0) / torch.clamp_min(t1 - t0, 1e-9),
                    0.0).clamp(0.0, 1.0)
    v = vals.expand(*lead, P, C)
    iv = i[..., None].expand(*lead, Q, C)
    v0 = torch.gather(v, -2, iv)
    v1 = torch.gather(v, -2, iv + 1)
    return (1.0 - w)[..., None] * v0 + w[..., None] * v1


def _match_edges(x, y, h, mid, tab: DeviceTables, cfg: StaticPlanCfg):
    """(N,) poses -> per-edge match mask, closest point and distance, each
    (N, E) (reference get_lane_matches :298-321). ``mid`` (N,) is each
    pose's map id: edges of other maps in the concatenated table never
    match."""
    e = tab.edges
    COUNTS["match_pairs"] += x.shape[0] * e.shape[0]
    cdist = (1.0 - e[:, 2] * torch.cos(h)[:, None]
             - e[:, 3] * torch.sin(h)[:, None])
    dx = x[:, None] - e[:, 0]
    dy = y[:, None] - e[:, 1]
    lmag = torch.minimum(torch.clamp_min(dx * e[:, 2] + dy * e[:, 3], 0.0),
                         e[:, 4])
    cx = e[:, 0] + lmag * e[:, 2]
    cy = e[:, 1] + lmag * e[:, 3]
    dist = torch.hypot(x[:, None] - cx, y[:, None] - cy)
    ok = ((cdist < cfg.cdistmax) & (dist < cfg.xydistmax) & (e[:, 4] > 0)
          & (tab.emap == mid[:, None]))
    return ok, cx, cy, dist


def _cluster_reps(ok, cx, cy, dist, cfg: StaticPlanCfg):
    """Closest-first representatives with spatial dedupe (stands in for
    the reference's connectivity clustering :324-347). Ties resolve to the
    first edge, as ``jnp.argmin`` does.

    :return: reps (N, MC) edge ids, rep_valid (N, MC)"""
    removed = torch.zeros_like(ok)
    reps, rep_valid = [], []
    for _ in range(cfg.MC):
        d = torch.where(ok & ~removed, dist, BIG)
        dmin, i = torch.min(d, dim=1)
        valid = dmin < BIG
        c_x = torch.gather(cx, 1, i[:, None])
        c_y = torch.gather(cy, 1, i[:, None])
        near = torch.hypot(cx - c_x, cy - c_y) < cfg.dedupe_r
        removed = removed | (near & valid[:, None])
        reps.append(i)
        rep_valid.append(valid)
    return torch.stack(reps, 1), torch.stack(rep_valid, 1)


def _match_reps(x, y, h, mid, tab: DeviceTables, cfg: StaticPlanCfg, MC):
    """The first ``MC`` closest-first representatives of (N,) poses:
    reps (N, MC) stacked edge ids, rep_valid (N, MC). On a card one launch
    of the lane-match kernel, which scans each pose's own map's edges; on
    any other device the plain :func:`_cluster_reps` of
    :func:`_match_edges`, which the kernel equals bit for bit."""
    N = x.shape[0]
    COUNTS["matches"] += N
    if not x.is_cuda:
        return _cluster_reps(*_match_edges(x, y, h, mid, tab, cfg),
                             cfg._replace(MC=MC))
    COUNTS["kernel_matches"] += N
    return lane_match(x.contiguous(), y.contiguous(), torch.cos(h),
                      torch.sin(h), mid.contiguous(), tab.edge_offsets,
                      tab.edges, cfg.cdistmax, cfg.xydistmax, cfg.dedupe_r,
                      MC)


def _route_spline(xys, ix0, x, y, h, cfg: StaticPlanCfg):
    """Polylines -> warped arc-length spline knots (reference :433-556).

    :param xys: (N, P, 2) polylines through the matched edge; ix0 = index
        of the matched edge's start vertex (static)
    :return: (t2 (N, G), vals (N, G, 4)) knots on the static warp grid
    """
    N, P, _ = xys.shape
    dev = xys.device
    ego = torch.stack([x, y], -1)[:, None]           # (N, 1, 2)
    seg = xys[:, 1:] - xys[:, :-1]
    seglen = torch.clamp_min(_norm2(seg), 1e-9)      # (N, P-1)
    segdir = seg / seglen[..., None]
    dd = ego - xys[:, :-1]
    lmag = torch.minimum(torch.clamp_min(
        dd[..., 0] * segdir[..., 0] + dd[..., 1] * segdir[..., 1], 0.0),
        seglen)
    cpts = xys[:, :-1] + lmag[..., None] * segdir
    cd = _norm2(ego - cpts)

    # local closest walk out from ix0 (reference local_lane_closest
    # :433-452): descend left while strictly smaller, then right; the walk
    # endpoints are run-length boundaries of the "moving improves"
    # predicates, found with masked reductions
    cix0 = min(ix0, P - 2)
    idx = torch.arange(P - 1, device=dev)
    cdm1 = torch.cat([cd[:, :1] + 1.0, cd[:, :-1]], 1)
    stop_l = (cdm1 >= cd) & (idx <= cix0)
    cix_l = torch.where(stop_l, idx, 0).amax(1)
    cdp1 = torch.cat([cd[:, 1:], cd[:, -1:] + 1.0], 1)
    stop_r = (cdp1 >= cd) & (idx >= cix_l[:, None])
    cix = torch.where(stop_r, idx, P - 2).amin(1)
    ic = cix[:, None, None].expand(N, 1, 2)
    cclose = torch.gather(cpts, 1, ic)[:, 0]
    xys_cix = torch.gather(xys, 1, ic)[:, 0]
    t = torch.cat([torch.zeros_like(seglen[:, :1]),
                   torch.cumsum(seglen, 1)], 1)
    t_cix = torch.gather(t, 1, cix[:, None])
    t = t - t_cix - _norm2(cclose - xys_cix)[:, None]

    # static asymmetric warp grid at lane_ds spacing, 0 at the
    # route-closest point (StaticPlanCfg.NBB: queries are all >= 0)
    NBB, NBF = cfg.NBB, cfg.NBF
    tg = (torch.arange(NBB + NBF + 1, dtype=torch.float32, device=dev)
          - NBB) * LANE_DS
    pts = _interp_cols(tg, t, xys)                   # (N, G, 2)
    # Gaussian warp through the agent pose (reference :543-549)
    pts = pts + (ego[:, 0] - cclose)[:, None] * torch.exp(
        -(tg ** 2) / LANE_SIG ** 2)[:, None]
    # arc-length + headings, heading at t=0 forced to the agent's
    # (reference xy2spline :455-474)
    d2 = pts[:, 1:] - pts[:, :-1]
    l2 = torch.clamp_min(_norm2(d2), 1e-9)
    h2 = d2 / l2[..., None]
    h2 = torch.cat([h2, h2[:, -1:]], 1)
    h2[:, NBB] = torch.stack([torch.cos(h), torch.sin(h)], -1)
    t2 = torch.cat([torch.zeros_like(l2[:, :1]), torch.cumsum(l2, 1)], 1)
    t2 = t2 - t2[:, NBB:NBB + 1]
    return t2, torch.cat([pts, h2], -1)


def _const_heading_spline(x, y, h, cfg: StaticPlanCfg):
    """Fallback when an agent matches no lane (reference :477-485)."""
    NBB, NBF = cfg.NBB, cfg.NBF
    tg = (torch.arange(NBB + NBF + 1, dtype=torch.float32, device=x.device)
          - NBB) * LANE_DS
    c, s = torch.cos(h)[:, None], torch.sin(h)[:, None]
    pts = torch.stack([x[:, None] + tg * c, y[:, None] + tg * s], -1)
    hh = torch.stack([c, s], -1).expand(-1, tg.shape[0], 2)
    return tg.expand(x.shape[0], -1), torch.cat([pts, hh], -1)


def _agent_splines(x, y, h, mid, tab: DeviceTables, cfg: StaticPlanCfg):
    """All route splines of N agents: (N, MC*NBR, G) knots + validity.

    Slot 0 is the reference's ``splines[0]`` (closest cluster, main
    branch), with the constant-heading fallback when nothing matched."""
    N = x.shape[0]
    MC, NBR = cfg.MC, cfg.NBR
    reps, rep_valid = _match_reps(x, y, h, mid, tab, cfg, MC)  # (N, MC)
    ci = torch.arange(NBR, device=x.device)
    # a representative is always an edge id (an argmin over the edges), so
    # its coded walks are row reads of the host-built polylines
    distinct = tab.distc_f[reps][..., :NBR] | (ci == 0)      # (N, MC, NBR)
    fwd = tab.chainxy_f[reps][:, :, :NBR]            # (N, MC, NBR, K+1, 2)
    bwd = tab.chain0xy_b[reps].flip(-2)              # (N, MC, KB+1, 2)
    kb = bwd.shape[-2] - 1  # matched edge = segment kb of the polyline
    xys = torch.cat([bwd[:, :, None].expand(-1, -1, NBR, -1, -1), fwd], -2)
    C = MC * NBR
    rep = lambda a: a[:, None].expand(N, C).reshape(-1)
    t2, vals = _route_spline(xys.reshape(N * C, -1, 2), kb, rep(x), rep(y),
                             rep(h), cfg)
    t2 = t2.reshape(N, C, -1)
    vals = vals.reshape(N, C, -1, 4)
    valid = (rep_valid[:, :, None] & distinct).reshape(N, C)
    tc, vc = _const_heading_spline(x, y, h, cfg)
    no_match = ~rep_valid[:, 0]
    t2[:, 0] = torch.where(no_match[:, None], tc, t2[:, 0])
    vals[:, 0] = torch.where(no_match[:, None, None], vc, vals[:, 0])
    valid[:, 0] = True
    return t2, vals, valid


def _speed_profile(s, stgt, acc, n, preddt):
    """(..., n+1) (reference compute_speed_profile :670-679); s, stgt and
    acc broadcast."""
    s, stgt, acc = s[..., None], stgt[..., None], acc[..., None]
    k = torch.arange(n + 1, dtype=torch.float32, device=s.device)
    up = torch.minimum(s + k * acc * preddt, stgt)
    dn = torch.maximum(s - k * acc * preddt, stgt)
    return torch.where(stgt > s, up, torch.where(stgt < s, dn, s))


def _sprof2dists(prof, preddt):
    return torch.cat([torch.zeros_like(prof[..., :1]),
                      torch.cumsum(prof[..., 1:] * preddt, -1)], -1)


def _gen_sprofiles(s0, facs, cfg: StaticPlanCfg):
    """(N,) speeds -> (N, NPROF, nsteps+1) profiles + dists, (N, NPROF) s1
    and (NPROF,) acc (reference gen_sprofiles :804-826); ``facs`` is the
    (F,) planaccfacs tensor. Profile order: fac-major, then s1, then s2."""
    N = s0.shape[0]
    dev = s0.device
    n1 = cfg.nsteps // 2
    n2 = cfg.nsteps - n1
    NS = cfg.plannspeeds
    acc_f = facs * cfg.accmax                                # (F,)
    top = torch.clamp_max(s0[:, None] + n1 * cfg.preddt * acc_f, cfg.smax)
    bot = torch.clamp_min(s0[:, None] - n1 * cfg.preddt * acc_f, 0.0)
    frac = torch.arange(NS, dtype=torch.float32, device=dev) / max(NS - 1, 1)
    s1 = (bot[..., None] + (top - bot)[..., None] * frac).reshape(N, -1)
    acc1 = acc_f.repeat_interleave(NS)                       # (F*NS,)
    p1 = _speed_profile(s0[:, None], s1, acc1, n1, cfg.preddt)
    end1 = p1[..., -1]                                       # (N, F*NS)
    top2 = torch.clamp_max(end1 + n2 * cfg.preddt * acc1, cfg.smax)
    bot2 = torch.clamp_min(end1 - n2 * cfg.preddt * acc1, 0.0)
    s2 = bot2[..., None] + (top2 - bot2)[..., None] * frac   # (N, F*NS, NS)
    p2 = _speed_profile(end1[..., None], s2, acc1[:, None], n2, cfg.preddt)
    profs = torch.cat([p1[:, :, None].expand(-1, -1, NS, -1), p2[..., 1:]],
                      -1).reshape(N, -1, cfg.nsteps + 1)
    return (profs, _sprof2dists(profs, cfg.preddt),
            s1.repeat_interleave(NS, dim=1), acc1.repeat_interleave(NS))


def _boxes2circles(b):
    """(..., 5=x,y,h,l,w) -> (..., 5, 3) disc cover (reference :860-882)."""
    XY, Hi, Li, Wi = b[..., :2], b[..., 2], b[..., 3], b[..., 4]
    L = torch.maximum(Li, Wi)
    W = torch.minimum(Li, Wi)
    H = torch.where(Li < Wi, Hi + np.pi / 2.0, Hi)
    ch, sh = torch.cos(H), torch.sin(H)
    v0 = ((L - W) / 2 + W / 4)[..., None] * torch.stack([ch, sh], -1)
    v1 = (W / 4)[..., None] * torch.stack([-sh, ch], -1)
    centers = torch.stack([XY + v0 + v1, XY - v0 + v1, XY - v0 - v1,
                           XY + v0 - v1, XY], -2)
    radii = torch.cat([(W / 4)[..., None].expand(*W.shape, 4),
                       (W / 2)[..., None]], -1)
    return torch.cat([centers, radii[..., None]], -1)


def _ego_spline(x, y, h, mid, tab: DeviceTables, cfg: StaticPlanCfg):
    """Ego route spline: globally closest match (first edge on a tie: the
    first round of :func:`_match_reps`), branch-0 walk — slot 0 of
    :func:`_agent_splines` — with the constant-heading fallback. (B,)
    poses -> (B, G), (B, G, 4), (B,)."""
    reps, rep_valid = _match_reps(x, y, h, mid, tab, cfg, 1)
    rep, has = reps[:, 0], rep_valid[:, 0]
    bwd = tab.chain0xy_b[rep]
    xys = torch.cat([bwd.flip(-2), tab.chain0xy_f[rep]], -2)
    t2, vals = _route_spline(xys, bwd.shape[-2] - 1, x, y, h, cfg)
    tc, vc = _const_heading_spline(x, y, h, cfg)
    return (torch.where(has[:, None], t2, tc),
            torch.where(has[:, None, None], vals, vc), has)


def _others_step_data(state, alive, lw, mid, tab, cfg: StaticPlanCfg):
    """Ego-INDEPENDENT half of the planner dt-steps of M (scene, step)
    pairs: every other agent's route splines, prediction fan and collision
    circles (reference ``:694-721``), batched over all of them.

    :param state: (M, NO, 4) x, y, h, s of the NON-ego agents
    :param alive: (M, NO); lw: (M, NO, 2); mid: (M,) map ids
    :return: (ocirc (M, T1, K, 5, 3), ovalid0 (M, K) = alive &
        spline-valid), K = NO * MC*NBR * len(predsfacs)*len(predafacs)
    """
    M, NO = state.shape[:2]
    flat = state.reshape(M * NO, 4)
    t2, vals, sp_valid = _agent_splines(
        flat[:, 0], flat[:, 1], flat[:, 2],
        mid[:, None].expand(M, NO).reshape(-1), tab, cfg)
    T1 = cfg.nsteps + 1
    s = flat[:, 3]
    tevals = _sprof2dists(_speed_profile(
        s[:, None, None], (s[:, None] * tab.predsfacs)[:, :, None],
        (cfg.accmax * tab.predafacs)[None, None], cfg.nsteps, cfg.preddt),
        cfg.preddt).reshape(M * NO, 1, -1)           # (N, 1, NTEV*T1)
    NTEV = tevals.shape[-1] // T1
    C = cfg.MC * cfg.NBR
    # fan queries are distances >= 0 (speeds are clamped >= 0, dists their
    # cumsum) and the warp grid pins t2[NBB] = 0, so the NBB backward knots
    # are never selected: slice them off the interp (exact)
    opreds = _interp_cols(tevals, t2[..., cfg.NBB:],
                          vals[..., cfg.NBB:, :])    # (N, C, NTEV*T1, 4)
    oh = torch.atan2(opreds[..., 3], opreds[..., 2])
    lwf = lw.reshape(M * NO, 1, 1, 2).expand(-1, C, NTEV * T1, 2)
    obox = torch.cat([opreds[..., :2], oh[..., None], lwf], -1)
    obox = obox.reshape(M, NO * C * NTEV, T1, 5).transpose(1, 2)
    ocirc = _boxes2circles(obox)                     # (M, T1, K, 5, 3)
    ovalid0 = (alive[:, :, None] & sp_valid.reshape(M, NO, C))
    ovalid0 = ovalid0[..., None].expand(M, NO, C, NTEV).reshape(M, -1)
    return ocirc, ovalid0


def _plan_step_ego(ego, lw0, opos, ocirc, ovalid0, mid, tab,
                   cfg: StaticPlanCfg):
    """Ego-DEPENDENT half of one planner dt-step of B scenes: ego spline,
    candidate speed profiles, collision scoring against the precomputed
    other-agent circles, profile pick, and the exact-speed step (reference
    compute_splines + compute_action, ``:224-246, 724-857``).

    :param ego: (B, 4) x, y, h, s; lw0: (B, 2)
    :param opos: (B, NO, 2) NON-ego agents' positions at this step
    :param ocirc: the other agents' circles from
        :func:`_others_step_data` as three (B, T1, 1, K*5) planes (x, y,
        radius), None when NO == 0
    :param ovalid0: (B, K) from :func:`_others_step_data`
    :return: (newx, newy, newh, stgt), each (B,)
    """
    B = ego.shape[0]
    x0, y0, h0, s0 = ego.unbind(-1)
    t2e, valse, has_match = _ego_spline(x0, y0, h0, mid, tab, cfg)
    # ego spline queries (profile dists, dt*stgt) are all >= 0: drop the
    # backward knots, same argument as _others_step_data's fan slice
    t2e, valse = t2e[:, cfg.NBB:], valse[:, cfg.NBB:]
    T1 = cfg.nsteps + 1

    # --- ego candidate profiles + scoring (reference :724-801) ------------
    profs, pdists, s1s, accs = _gen_sprofiles(s0, tab.planaccfacs, cfg)
    NP = profs.shape[1]
    NO = opos.shape[1]
    if NO > 0:
        CN = ovalid0.shape[1] // NO
        near = torch.hypot(opos[..., 0] - x0[:, None],
                           opos[..., 1] - y0[:, None]) < cfg.interacdist
        ovalid = ovalid0 & near.repeat_interleave(CN, dim=1)  # (B, K)
        elocs = _interp_cols(pdists.reshape(B, -1), t2e, valse
                             ).reshape(B, NP, T1, 4)
        ehead = torch.atan2(elocs[..., 3], elocs[..., 2])
        ebox = torch.cat([elocs[..., :2], ehead[..., None],
                          lw0[:, None, None].expand(B, NP, T1, 2)], -1)
        # every (ego circle, other circle) pair of a plan time: rows are the
        # ego's NP*5 circles, columns the others' K*5 (contiguous planes)
        e = _boxes2circles(ebox).transpose(1, 2).reshape(B, T1, NP * 5, 1, 3)
        ox, oy, orad = ocirc
        dx, dy = e[..., 0] - ox, e[..., 1] - oy
        d = torch.sqrt(dx * dx + dy * dy) - e[..., 2] - orad
        K = ovalid.shape[1]
        d = d.reshape(B, T1, NP, 5, K, 5).amin(dim=(3, 5))  # (B, T1, NP, K)
        d = torch.where(ovalid[:, None, None], d, BIG).amin(dim=3
                                                            ).transpose(1, 2)
        w = cfg.score_wmin + torch.arange(
            T1, dtype=torch.float32, device=ego.device) * cfg.score_wfac
        pr = 1.0 + torch.tanh(-d * w)
        pr = torch.where(d < 0, 1.0, pr)
        pcol = 1.0 - torch.prod(1.0 - pr, dim=2)     # (B, NP)
        any_other = ovalid.any(dim=1)
        pcol = torch.where(any_other[:, None], pcol, 0.0)
    else:
        # ego-only scenes: nothing to collide with
        pcol = torch.zeros_like(profs[..., 0])
        any_other = torch.zeros_like(has_match)

    # selection (reference choose_profile / plot_plan_info :768-801): with
    # no interacting agents the reference takes the farthest profile;
    # prefer_stop (no lane match) flips to the shortest safe profile
    reach = pdists[..., -1]
    okp = pcol < cfg.col_plim
    prefer_stop = (~has_match) & any_other
    dist_key = torch.where(okp, torch.where(prefer_stop[:, None], -reach,
                                            reach), -BIG)
    pick = torch.where(okp.any(dim=1), dist_key.argmax(dim=1),
                       pcol.argmin(dim=1))           # first index on ties

    # step along the spline (reference compute_action :829-857)
    s1p = torch.gather(s1s, 1, pick[:, None])[:, 0]
    stgt = _speed_profile(s0, s1p, accs[pick], 1, cfg.dt)[:, 1]
    loc = _interp_cols((cfg.dt * stgt)[:, None], t2e, valse)[:, 0]
    newx, newy = loc[:, 0], loc[:, 1]
    newh = torch.atan2(loc[:, 3], loc[:, 2])

    # exact-speed postprocess (reference :642-666)
    dx, dy = newx - x0, newy - y0
    dist0 = torch.sqrt(dx * dx + dy * dy)
    sp = dist0 / cfg.dt
    sgn = torch.where(dx * torch.cos(newh) + dy * torch.sin(newh) >= 0,
                      1.0, -1.0)
    sp = sgn * sp
    bad = (torch.sign(sp) != torch.sign(stgt)) | (dist0 == 0.0)
    dn = torch.clamp_min(dist0, 1e-9)
    px = torch.where(bad, x0 + torch.cos(h0) * stgt * cfg.dt,
                     x0 + dx / dn * torch.abs(stgt) * cfg.dt)
    py = torch.where(bad, y0 + torch.sin(h0) * stgt * cfg.dt,
                     y0 + dy / dn * torch.abs(stgt) * cfg.dt)
    ph = torch.where(bad, h0, newh)
    return px, py, ph, stgt


def plan_rollout(tab: DeviceTables, cfg: StaticPlanCfg, init_state, lw,
                 alive0, other_obs, obs_t, Tsteps: int, mid):
    """Roll the planner for B scenes (reference rollout :178-276).

    :param init_state: (B, NA, 4) x, y, h, s UNNORMALIZED; ego = row 0
    :param lw: (B, NA, 2); alive0: (B, NA) bool; mid: (B,) map ids
    :param other_obs: (B, NA, TO, 4) x, y, hx, hy observed futures (row 0
        ignored; NaN frames end an agent's horizon)
    :param obs_t: (TO,) observation timestamps (> 0)
    :return: (B, Tsteps+1, 4) ego x, y, hx, hy on the reference's
        ``linspace(dt, dt*Tsteps, Tsteps+1)`` timeline
    """
    B, NA, TO = other_obs.shape[:3]
    dev = init_state.device
    T_all = Tsteps + 1
    COUNTS["calls"] += 1
    # clamp initial speeds to >= 0: the static warp grid has no full
    # backward extent; ego speed then STAYS >= 0 (PARITY.md §16)
    init_state = torch.cat([init_state[..., :3],
                            torch.clamp_min(init_state[..., 3:], 0.0)], -1)
    # prepend the initial pose at t=0 (reference create_other_agents)
    hv = torch.stack([torch.cos(init_state[..., 2]),
                      torch.sin(init_state[..., 2])], -1)
    obs = torch.cat([torch.cat([init_state[..., :2], hv], -1)[:, :, None],
                     other_obs], 2)                   # (B, NA, TO+1, 4)
    ts = torch.cat([torch.zeros_like(obs_t[:1]), obs_t])
    nanrow = torch.isnan(obs).any(-1)
    first_nan = torch.cat([nanrow, torch.ones_like(nanrow[..., :1])],
                          -1).to(torch.uint8).argmax(-1)
    horizon = ts[torch.clamp_min(first_nan - 1, 0)]   # (B, NA)
    obs = torch.where(nanrow[..., None], 0.0, obs)

    with span("planner.others"):
        # --- others' states at EVERY plan time, batched (ego-independent)
        # other agents move along their observations (reference
        # update_wstate :601-621): position/heading interpolated, speed the
        # finite difference from the previous plan step
        t_grid = cfg.dt * torch.arange(1, Tsteps + 1, dtype=torch.float32,
                                       device=dev)
        o = _interp_cols(t_grid, ts, obs).transpose(1, 2)  # (B, T, NA, 4)
        pos_prev = torch.cat([init_state[:, None, :, :2], o[:, :-1, :, :2]],
                             1)
        ohd = torch.atan2(o[..., 3], o[..., 2])
        dxy = o[..., :2] - pos_prev
        osp = torch.hypot(dxy[..., 0], dxy[..., 1]) / cfg.dt
        osgn = torch.where(
            dxy[..., 0] * o[..., 2] + dxy[..., 1] * o[..., 3] >= 0, 1.0, -1.0)
        # reversing agents (osgn < 0) are predicted as STOPPING (speed
        # clamped to 0) instead of reversing: the static warp grid only
        # covers ~NBB*LANE_DS backward (PARITY.md §16)
        states_later = torch.stack([o[..., 0], o[..., 1], ohd,
                                    torch.clamp_min(osgn * osp, 0.0)], -1)
        state_all = torch.cat([init_state[:, None], states_later], 1)
        alive_later = alive0[:, None] & (t_grid[:, None]
                                         <= horizon[:, None] + 1e-6)
        alive_all = torch.cat([alive0[:, None], alive_later], 1)  # B,T,NA

        ocirc = ovalid = None
        if NA > 1:
            # ego row excluded: its fan is never scored
            NO = NA - 1
            ocirc, ovalid = _others_step_data(
                state_all[:, :, 1:].reshape(B * T_all, NO, 4),
                alive_all[:, :, 1:].reshape(B * T_all, NO),
                lw[:, None, 1:].expand(B, T_all, NO, 2).reshape(-1, NO,
                                                                  2),
                mid[:, None].expand(B, T_all).reshape(-1), tab, cfg)
            ocirc = ocirc.reshape(B, T_all, cfg.nsteps + 1, 1, -1, 3)
            ocirc = [ocirc[..., c].contiguous() for c in range(3)]
            ovalid = ovalid.reshape(B, T_all, -1)

    # first action planned from t=0 (reference records the first planned
    # control before the loop, :238-246), then one per dt step
    ego = init_state[:, 0]
    outs = []
    with span("planner.ego"):
        for j in range(T_all):
            px, py, ph, stgt = _plan_step_ego(
                ego, lw[:, 0], state_all[:, j, 1:, :2],
                None if ocirc is None else [c[:, j] for c in ocirc],
                None if ovalid is None else ovalid[:, j], mid, tab, cfg)
            ego = torch.stack([px, py, ph, stgt], -1)
            outs.append(torch.stack([px, py, torch.cos(ph), torch.sin(ph)],
                                    -1))
    return torch.stack(outs, 1)


# ---------------------------------------------------------------------------
# batch wrapper + closed-loop function
# ---------------------------------------------------------------------------


def _call(fn, tab, cfg, args, Tsteps):
    """``fn`` (:func:`plan_rollout` or what stands in its name) on ``args``
    = (init_state, lw, alive0, other_obs, obs_t, mid)."""
    init_state, lw, alive0, other_obs, obs_t, mid = args
    return fn(tab, cfg, init_state, lw, alive0, other_obs, obs_t, Tsteps,
              mid)


class _CapturedRollout:
    """One call of a rollout function captured as a CUDA graph on the
    current device: its own input buffers and output, and the work that
    the captured call counted (``COUNTS`` but its calls and replays, and
    the lane-match kernel's ``LAUNCHES``). A capture launches nothing and
    counts nothing; each replay runs, and counts, what was captured.
    Replaying reads the lane tables by the addresses they had at capture,
    so it lives no longer than their planner."""

    def __init__(self, fn, tab, cfg, args, Tsteps):
        self.inputs = [a.clone() for a in args]
        before, launched = dict(COUNTS), dict(MATCH_LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        try:
            # ``torch.cuda.graph`` synchronizes and returns the allocator's
            # cached blocks (the eager call's temporaries) to the card
            # before it captures: once a capture, never a call
            with torch.cuda.graph(self.graph):
                self.out = _call(fn, tab, cfg, self.inputs, Tsteps)
        finally:
            self.counted = {k: COUNTS[k] - before[k] for k in COUNTS
                            if k not in ("calls", "replays")}
            self.launches = {k: MATCH_LAUNCHES[k] - launched[k]
                             for k in MATCH_LAUNCHES}
            COUNTS.update(before)  # a capture is not a rollout
            MATCH_LAUNCHES.update(launched)

    def __call__(self, args):
        """Replay on ``args``; the output is overwritten by the next
        replay, so callers read it before they call again."""
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        COUNTS["calls"] += 1
        COUNTS["replays"] += 1
        for k, n in self.counted.items():
            COUNTS[k] += n
        for k, n in self.launches.items():
            MATCH_LAUNCHES[k] += n
        return self.out


def own_map_pairs(map_edges, map_idx, poses_per_scene):
    """The pose-edge pairs that the lane-match kernel computes when every
    scene b matches ``poses_per_scene`` poses, each against the edges of
    its map ``map_idx[b]`` (``map_edges``: each map's edge count; a map id
    outside them has none)."""
    return poses_per_scene * sum(map_edges[m] for m in map_idx
                                 if 0 <= m < len(map_edges))


class DeviceRulePlanner:
    """Rule planner over a batch of scenes on one device (duck-types the
    JAX package's ``TpuRulePlanner``).

    ``reset`` captures initial states; ``rollout_batch`` plans every scene
    at once; ``make_fn`` returns the one-argument closed-loop planner
    function of ``optim.adv.run_adv_gen_optim``. The lane tables go to
    ``device`` once, here; inputs on another device raise.

    On a CUDA device the planner keeps one CUDA graph of the rollout, keyed
    by the function that ``plan_rollout`` names when it is called, the
    plan steps and the inputs' shapes and dtypes (B, NA, TO). A key's first
    call runs eagerly on a side stream (the warm-up a capture needs), its
    second captures the rollout and replays it, and later calls replay,
    each after copying its inputs (``reset``'s and the call's) into the
    graph's buffers; a new key drops the graph and its memory pool and
    starts again. What a call returns is always a new tensor. On the CPU
    every call runs eagerly.

    On a card each call's lane-match pairs (``COUNTS["match_pairs"]``)
    are worked out on the host, not counted: the poses the call matched,
    as many a scene, each against its own map's edges (the map ids of
    ``reset``, each map's edge count from the tables' ``edge_offsets``),
    as the kernel scans them.
    """

    def __init__(self, lane_graphs, map_names, cfg, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.map_names = list(map_names)
        base = PlannerConfig(**cfg) if isinstance(cfg, dict) else cfg
        self.cfg = StaticPlanCfg.from_planner_config(base)
        self.tables = DeviceTables.from_graphs(lane_graphs, self.map_names,
                                               self.cfg, self.device)
        self.map_edges = np.diff(
            self.tables.edge_offsets.cpu().numpy()).tolist()
        self.state = None
        self._mids = None    # reset's map ids, on the host
        self._key = None     # the last CUDA call's key
        self._graph = None   # its _CapturedRollout, from its second call

    def _on_device(self, x, dtype=torch.float32):
        if isinstance(x, torch.Tensor) and x.device != self.device:
            raise ValueError(f"planner on {self.device}, input on {x.device}")
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, dtype=dtype, device=self.device)

    def reset(self, init_state, lw, mask, map_idx):
        """:param init_state: (B, NA, 6) UNNORMALIZED (x,y,hx,hy,s,hdot)
        :param lw: (B, NA, 2) UNNORMALIZED; mask: (B, NA); map_idx: (B,)"""
        st = self._on_device(init_state)
        self.state = {
            "init": torch.stack([st[..., 0], st[..., 1],
                                 torch.atan2(st[..., 3], st[..., 2]),
                                 st[..., 4]], -1),
            "lw": self._on_device(lw),
            "mask": self._on_device(mask, torch.bool),
            "map_idx": self._on_device(map_idx, torch.int64),
        }
        self._mids = self.state["map_idx"].tolist()

    def _plan(self, args, Tsteps):
        """:func:`plan_rollout` on ``args`` (see :func:`_call`): eager on
        the CPU, through the planner's CUDA graph on a card (class doc)."""
        fn = plan_rollout  # as the module names it now
        if self.device.type != "cuda":
            return _call(fn, self.tables, self.cfg, args, Tsteps)
        matched = COUNTS["matches"]
        out = self._plan_cuda(fn, args, Tsteps)
        # plan_rollout matches as many poses for every scene
        per_scene, rest = divmod(COUNTS["matches"] - matched,
                                 len(self._mids))
        if rest:
            raise RuntimeError(
                f"{COUNTS['matches'] - matched} poses matched over "
                f"{len(self._mids)} scenes: not as many a scene, so the "
                "own-map pairs cannot be worked out")
        COUNTS["match_pairs"] += own_map_pairs(self.map_edges, self._mids,
                                               per_scene)
        return out

    def _plan_cuda(self, fn, args, Tsteps):
        """``fn`` on ``args`` on the card: eager for a new key, else
        through the key's CUDA graph (class doc)."""
        key = (fn, Tsteps) + tuple((a.shape, a.dtype) for a in args)
        with torch.cuda.device(self.device):
            if key != self._key:
                self._key, self._graph = key, None
                cur = torch.cuda.current_stream()
                side = torch.cuda.Stream()
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    out = _call(fn, self.tables, self.cfg, args, Tsteps)
                cur.wait_stream(side)
                out.record_stream(cur)
                return out
            if self._graph is None:
                self._graph = _CapturedRollout(fn, self.tables, self.cfg,
                                               args, Tsteps)
            return self._graph(args)

    @torch.no_grad()
    def _rollout(self, other_obs, obs_t, planner_t, t_end):
        assert self.state is not None, "call reset() first"
        cfg = self.cfg
        Tsteps = int(round(t_end / cfg.dt))
        st = self.state
        out = self._plan((st["init"], st["lw"], st["mask"], other_obs, obs_t,
                          st["map_idx"]), Tsteps)
        out_t = linspace(cfg.dt, cfg.dt * Tsteps, Tsteps + 1, self.device)
        # a new tensor: ``out`` may be the graph's, which the next replay
        # overwrites
        return _interp_cols(planner_t, out_t, out)

    def rollout_batch(self, other_obs, obs_t, planner_t):
        """:param other_obs: (B, NA, TO, 4) UNNORMALIZED futures (ego row
        ignored); obs_t/planner_t: (TO,)/(TQ,)
        :return: (B, TQ, 4) ego trajectories on the planner's device"""
        planner_t = self._on_device(planner_t)
        return self._rollout(self._on_device(other_obs),
                             self._on_device(obs_t), planner_t,
                             float(planner_t[-1]))

    def make_fn(self, state_norm, dt, future_len):
        """Closed-loop planner function ``fn(future_pred_norm (B, NA, FT,
        4)) -> (B, FT, 4)`` NORMALIZED, on the prediction's device (which
        must be the planner's). The ego row of the prediction is masked out
        of the observations."""
        smean = torch.as_tensor(state_norm.mean_np[:4], device=self.device)
        sstd = torch.as_tensor(state_norm.std_np[:4], device=self.device)
        plan_t = linspace(dt, dt * future_len, future_len, self.device)
        t_end = float(dt * future_len)

        def fn(future_pred_norm):
            fp = self._on_device(future_pred_norm.detach()) * sstd + smean
            fp[:, 0] = float("nan")
            out = self._rollout(fp, plan_t, plan_t, t_end)
            return (out - smean) / sstd

        return fn
