"""The closed-loop cell's plain reference planner
(``benchmark/reference/planner.py``) on the CPU.

- It imports nothing of either package and nothing of JAX.
- On seeded random scenes of a few agents (on the straight grid,
  ``synthetic_lanegraph_forks`` and the cell's connector grid at a small
  extent): the port's ``DeviceRulePlanner`` holds it at the check's
  tolerance, 0.5 m and 5 degrees at every output step; the port's host
  planner (``planners/hardcode.py``, the same algorithm in numpy) agrees
  with it to 1e-6 m.
- The device planner's lane tables built on the device
  (``DeviceTables.from_graphs``) equal strive_tpu's host build
  (``build_lane_tables`` + ``stack_lane_tables``) bit for bit, each graph
  stacked with the ring.
"""

import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import strive_tpu.planners.tpu_planner as jtp
from benchmark.harness import BENCH, load_json
from benchmark.inputs import lanes
from benchmark.reference.planner import CONFIGS, Planner
from strive_tpu_torch.maps import lanegraph as tlg
from strive_tpu_torch.planners import (PLANNER_CONFIGS, PlannerConfig,
                                       RulePlanner)
from strive_tpu_torch.planners import device_planner as dp

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _connector_grid():
    st = copy.deepcopy(load_json(BENCH / "configs"
                                 / "strive_adv_rule_nusc.json")["store"])
    st["extents_m"] = {"boston-seaport": [256.0, 256.0]}
    st["maps"] = ["boston-seaport"]
    st["spacing_m"] = 64.0
    return lanes.graph(st, "boston-seaport")


GRAPHS = {"grid": lambda: tlg.synthetic_lanegraph(256.0, 64.0),
          "forks": tlg.synthetic_lanegraph_forks,
          "connectors": _connector_grid}


@pytest.fixture(scope="module")
def graphs():
    return {k: f() for k, f in GRAPHS.items()}


def test_reference_imports_neither_package_nor_jax():
    code = ("import sys, benchmark.reference.planner as p; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'strive_tpu', 'strive_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    src = (BENCH / "reference" / "planner.py").read_text()
    assert "import jax" not in src and "strive_tpu" not in src


def _scene(rng, lg, NA, T=12, dt=0.5):
    """An ego on a random lane edge and others on edges within 40 m of
    it, each heading along its edge and observed driving straight on at
    its own speed."""
    e = lg["edges"]
    ego = e[rng.integers(len(e))]
    near = np.nonzero(np.linalg.norm(e[:, :2] - ego[:2], axis=1) < 40.0)[0]
    pick = [ego] + [e[i] for i in rng.choice(near, NA - 1)]
    obs_t = np.arange(1, T + 1) * dt
    init = np.zeros((NA, 6), np.float32)
    obs = np.zeros((NA, T, 4), np.float32)
    for a, ed in enumerate(pick):
        xy = ed[:2] + rng.uniform(0.0, 1.0) * ed[4] * ed[2:4] \
            + rng.uniform(-0.3, 0.3, 2)
        s = rng.uniform(0.0, 9.0)
        init[a] = [*xy, *ed[2:4], s, 0.0]
        obs[a, :, :2] = xy + s * obs_t[:, None] * ed[2:4]
        obs[a, :, 2:] = ed[2:4]
    lw = np.stack([rng.uniform(4.0, 5.5, NA), rng.uniform(1.8, 2.2, NA)],
                  -1).astype(np.float32)
    return init, lw, obs, obs_t


def _reference(lg, init, lw, obs, obs_t):
    p = Planner({"m": lg}, ["m"], CONFIGS["default"])
    return p.rollout(init[None], lw[None], np.ones((1, len(init)), bool),
                     obs[None], obs_t, obs_t, [0])[0].numpy()


def _device(lg, init, lw, obs, obs_t):
    p = dp.DeviceRulePlanner({"m": lg}, ["m"], PLANNER_CONFIGS["default"],
                             device="cpu")
    p.reset(init[None], lw[None], np.ones((1, len(init)), bool),
            np.zeros(1, np.int64))
    return p.rollout_batch(obs[None], obs_t, obs_t)[0].numpy()


def _host(lg, init, lw, obs, obs_t):
    p = RulePlanner({"m": lg}, ["m"], PLANNER_CONFIGS["default"])
    NA = len(init)
    p.reset(init, lw, np.zeros(NA, np.int64), 1, np.zeros(1, np.int64))
    return p.rollout(obs[1:], obs_t, np.array([0, NA - 1]), obs_t)[0]


def _heading_deg(a, b):
    c = np.sum(a[:, 2:4] * b[:, 2:4], -1) / (
        np.linalg.norm(a[:, 2:4], axis=-1) * np.linalg.norm(b[:, 2:4],
                                                            axis=-1))
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_planner_holds_the_reference(graphs, graph, seed):
    rng = np.random.default_rng([seed, len(graph)])
    lg = graphs[graph]
    for NA in (1, 3, 5):
        init, lw, obs, obs_t = _scene(rng, lg, NA)
        want = _reference(lg, init, lw, obs, obs_t)
        got = _device(lg, init, lw, obs, obs_t)
        host = _host(lg, init, lw, obs, obs_t)
        gap = np.linalg.norm(got[:, :2] - want[:, :2], axis=-1)
        assert gap.max() < 0.5, (NA, gap)
        assert _heading_deg(got, want).max() < 5.0
        assert np.abs(host - want).max() < 1e-6


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_tables_built_on_the_device_equal_the_host_build(graphs, graph):
    cfg = dp.StaticPlanCfg.from_planner_config(
        PlannerConfig(**PLANNER_CONFIGS["default"]))
    names = [graph, "ring"]
    gs = {graph: graphs[graph], "ring": tlg.synthetic_lanegraph_ring()}
    host = jtp.stack_lane_tables([jtp.build_lane_tables(gs[n])
                                  for n in names])
    built = dp.DeviceTables.from_graphs(gs, names, cfg, "cpu")
    for f in dp.DeviceTables._fields[:6]:
        a = getattr(built, f)
        b = torch.from_numpy(np.array(getattr(host, f)))
        if f == "emap":
            b = b.long()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
