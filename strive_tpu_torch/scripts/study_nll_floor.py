"""Analytic/empirical NLL floor of the SYNTHETIC dataset, on the port.

    python -m strive_tpu_torch.scripts.study_nll_floor [--synth_scenes 96 --K 512]

Port of ``scripts/study_nll_floor.py``: the same numpy analysis on the
port's own ``data/synthetic.py`` and ``normalize.py`` (which make the same
scenes and statistics as strive_tpu's), with the same flags and the same
JSON line. It runs on the host alone; there is no ``--device``.
The JAX script's account follows.

Explains the "flat" production training curve (out/train_synth_prod: val loss
~3.73 from epoch ~20). The recon loss (strive_tpu/losses/training.py:40,
reference ``losses/traffic_model.py:34-118``) is a unit-variance Gaussian NLL
over 4 normalized dims per frame, so EVERY entry carries an additive constant

    const = 4 * 0.5 * log(2*pi) = 2 log(2*pi) = 3.6758

and the reducible part is 0.5 * ||err_normalized||^2. The synthetic generator
(strive_tpu_torch/data/synthetic.py) drives each agent's future with i.i.d.
control noise a ~ N(0.3, 0.8^2), ddh ~ N(0, 0.05^2) that is INDEPENDENT of
the past, so even the Bayes-optimal predictor — the conditional mean
E[future | state at end of past] — has irreducible residual variance. This
script measures that floor by Monte Carlo: for every val agent it re-rolls
K futures from the true end-of-past state (x, y, h, s, hdot — the full
generator state is observable in the 6-dim past frames) with fresh noise
from the generator's own distribution, uses their mean as the oracle
prediction, and evaluates the exact recon NLL on the true future.

Output: one JSON line with
  const            — the additive 2 log(2*pi) term,
  oracle_floor     — recon NLL of the Bayes predictor (K-sample MC mean;
                     the 1/K MC inflation is corrected and reported),
  mean_ctrl_nll    — recon NLL of the plug-in predictor (a=0.3, ddh=0),
  for the val split at production-eval settings (synth_scenes=96,
  max_agents=16, PT=4, FT=12 — configs/test_synth_prod.cfg).

Compare to out/test_synth_prod/test_log.txt: recon_loss = 3.7169.
"""

import argparse
import json

import numpy as np

from ..data.synthetic import synthetic_scene_list
from ..normalize import att_normalizer_for, state_normalizer_for

CONST = 2.0 * np.log(2.0 * np.pi)  # 4 dims x 0.5 log(2 pi)


def _np_stats(norm):
    """A MeanStdNormalizer's float32 mean and std."""
    return norm.mean_np, norm.std_np


def _roll_futures(state, L, FT, K, rng, dt=0.5):
    """K conditional future rollouts from full state (x, y, h, s, hdot).

    Vectorized replica of data/synthetic.py:_simulate_bicycle's
    update (same clips, same order), started mid-trajectory. K=1 with zero
    noise std gives the plug-in mean-control rollout.
    """
    x = np.full(K, state[0])
    y = np.full(K, state[1])
    h = np.full(K, state[2])
    s = np.full(K, state[3])
    hdot = np.full(K, state[4])
    out = np.zeros((K, FT, 4))
    for t in range(FT):
        ddh = rng.normal(0.0, 0.05, K) if rng is not None else 0.0
        a = rng.normal(0.3, 0.8, K) if rng is not None else 0.3
        hdot = np.clip(hdot + ddh * dt, -2 * np.pi, 2 * np.pi)
        h = h + dt * np.abs(s) / L * hdot
        s = np.clip(s + a * dt, 0.0, 50.0)
        y = y + s * np.sin(h) * dt
        x = x + s * np.cos(h) * dt
        out[:, t, 0] = x
        out[:, t, 1] = y
        out[:, t, 2] = np.cos(h)
        out[:, t, 3] = np.sin(h)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--synth_scenes", type=int, default=96)
    p.add_argument("--max_agents", type=int, default=16)
    p.add_argument("--PT", type=int, default=4)
    p.add_argument("--FT", type=int, default=12)
    p.add_argument("--K", type=int, default=512)
    p.add_argument("--split_seed", type=int, default=1,
                   help="1 = val (strive_tpu/data/loading.py:53)")
    cfg = p.parse_args(argv)

    cats = ("car", "truck")
    sm, ss = _np_stats(state_normalizer_for(cats))   # (6,), (6,)
    am, asd = _np_stats(att_normalizer_for(cats))
    scenes = synthetic_scene_list(
        num_scenes=cfg.synth_scenes, num_maps=2, map_size_px=512,
        PT=cfg.PT, FT=cfg.FT, NC=2, min_agents=2,
        max_agents=cfg.max_agents, seed=cfg.split_seed, categories=cats)

    rng = np.random.default_rng(12345)
    nll_oracle, nll_mean_ctrl, mc_corr, n = 0.0, 0.0, 0.0, 0
    pe_oracle, pe_mean = 0.0, 0.0
    ego_minade, ego_minfde, n_ego = [], [], 0
    for sc in scenes:
        past = np.asarray(sc["past"]) * ss + sm              # (na, PT, 6)
        lw = np.asarray(sc["lw"]) * asd + am                 # (na, 2)
        fut_n = np.asarray(sc["future"])[..., :4]            # normalized gt
        fut_m = fut_n * ss[:4] + sm[:4]                      # meters
        for a in range(past.shape[0]):
            x, y, cx, sy, s, hdot = past[a, -1]
            h = np.arctan2(sy, cx)
            st = (x, y, h, s, hdot)
            L = float(lw[a, 0])
            rolls = _roll_futures(st, L, cfg.FT, cfg.K, rng)  # (K, FT, 4)
            rolls_n = (rolls - sm[:4]) / ss[:4]
            oracle_n = rolls_n.mean(axis=0)                   # (FT, 4)
            mean_n = ((_roll_futures(st, L, cfg.FT, 1, None)[0]
                       - sm[:4]) / ss[:4])
            err_o = np.sum((oracle_n - fut_n[a]) ** 2, axis=-1)   # (FT,)
            err_m = np.sum((mean_n - fut_n[a]) ** 2, axis=-1)
            nll_oracle += np.sum(CONST + 0.5 * err_o)
            nll_mean_ctrl += np.sum(CONST + 0.5 * err_m)
            # the K-sample mean inflates E||err||^2 by tr(Var)/K — correct it
            mc_corr += 0.5 * np.sum(rolls_n.var(axis=0)) / cfg.K
            n += cfg.FT
            # meter-space counterparts of test_traffic's pos_err (masked
            # mean position error of the point prediction) and, ego-only,
            # the NS=10-sample minADE/minFDE (compute_disp_err protocol)
            om = oracle_n * ss[:4] + sm[:4]
            mm = mean_n * ss[:4] + sm[:4]
            pe_oracle += np.sum(np.linalg.norm(
                om[:, :2] - fut_m[a, :, :2], axis=-1))
            pe_mean += np.sum(np.linalg.norm(
                mm[:, :2] - fut_m[a, :, :2], axis=-1))
            if a == 0:
                d = np.linalg.norm(rolls[:10, :, :2] - fut_m[a, None, :, :2],
                                   axis=-1)                   # (10, FT)
                ego_minade.append(d.mean(axis=1).min())
                ego_minfde.append(d[:, -1].min())
                n_ego += 1

    out = {
        "const": round(float(CONST), 4),
        "oracle_floor": round(float((nll_oracle - mc_corr) / n), 4),
        "oracle_floor_uncorrected": round(float(nll_oracle / n), 4),
        "mean_ctrl_nll": round(float(nll_mean_ctrl / n), 4),
        "oracle_pos_err_m": round(float(pe_oracle / n), 4),
        "mean_ctrl_pos_err_m": round(float(pe_mean / n), 4),
        "oracle_ego_minADE_10samp_m": round(float(np.mean(ego_minade)), 4),
        "oracle_ego_minFDE_10samp_m": round(float(np.mean(ego_minfde)), 4),
        "K": cfg.K,
        "frames": n,
        "egos": n_ego,
        "split_seed": cfg.split_seed,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
