"""Chip smoke run of strive_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Three commands check the port on the card, each for its own part:

- ``python -m pytest --noconftest tests/test_torch_*_cuda.py``: every
  kernel and the device planner's CUDA graph against their plain versions,
  case by case (K1 and the crops bit for bit in float32 and bf16, K2's
  ``coll_pt`` within 2e-6 x the largest coordinate);
- this script: the port on the card against the same work on the CPU, end
  to end; the entry points at their configs' full widths, with the exact
  launches of the kernels, finite outputs and the files' schemas; the
  kernels against their plain versions on the inputs no card test holds
  them on, among them the main path's own; and the kernel records
  of PERF.md's kernel table (each kernel's device ms from CUDA events,
  beside its bound, its plain version's ms and one library call's ms, and
  its launches on the path that runs it);
- ``python3 -m benchmark.run --workload <cell>``: end-to-end speed.

The main path is ``TrafficModel.embed`` and then the open-loop ('ego',
replay planner) adversarial latent optimization, as ``bench.py`` drives
the JAX package: B=4 scenes x NA=8 agents, PT=4, FT=12, 256 px crops, the
default model widths, f32 with TF32 off, random weights from a seed, on a
synthetic store of 2 maps x 2048 px x 4 channels at 4 px/m. Phases, in
the order they run (the numbers are the order they were added in):

1. the card's name and power limit (nvidia-smi); fails without CUDA;
2. builds the CUDA kernels from ``strive_tpu_torch/csrc`` (nvcc, parallel);
3. K1 ``map_crop`` bit-exact against its plain version, in both layouts,
   float32 and bf16, at the main path's shape (32 poses of its scenes,
   ``kernel_cases.main_path_crop_args``), on 8 poses on and off the maps
   with non-unit headings, a NaN pose and a NaN heading (4 and 3
   channels), and on those at 64 px; its record at the main path's shape:
   its ms, its plain version's and its bound; and its library yardstick,
   never called by the port: per map one ``F.affine_grid`` +
   ``F.grid_sample(mode='nearest')`` of the map's float raster on a grid
   of all its poses' samples (``crop_library``), timed at the main path's
   32 poses and training's 128 beside K1, with the samples where it
   differs from K1 counted by cause (rounding ties, off the map, NaN
   poses), there and on the 8 edge poses;
4. K2 ``footprint_coll_point`` against its plain version (``valid`` and
   ``frac`` exact, ``coll_pt`` within 2e-6 x the largest coordinate) at
   the main path's shape (1,152 cars of its scenes) and on 48 cars on and
   off the maps with un-normalized headings (|h| 100-400) and lengths of
   3-18 m, and on ``kernel_cases.coll_point_cases`` over this store (grids
   7x5 and 64x40, cars wholly off the map or on drivable ground, one
   car); its record at the main path's shape;
5. a small run (32 px crops, 3 iterations) on the card against the same
   run on the CPU through the plain versions: loss history rtol 1e-3,
   final latents atol 1e-4;
6. the main path: embed + 20 Adam iterations with bench.py's weights, lr
   0.05, feasibility time 2: finite losses, trajectories and latents, and
   the launch counters risen by exactly 1 + 12 x 20 + 12 crops and 20 + 1
   footprints, no window, bisect or lane-match kernel;
6b. the closed loop ('hardcode' planner, re-rolled every iteration), on
   the same model, store and scenes, with ``synthetic_lanegraph(512 m,
   spacing 64 m)`` on both maps and the 'default' planner config:
   a. the scenes' own futures through the device planner on the card,
      held against the numpy (host) planner at JAX's decision-parity
      tolerance (0.5 m, 5 degrees) and against the device planner on the
      CPU from the same inputs within 1e-3 m and 1e-3 rad; a scene past
      1e-3 is printed as a decision that flipped on float error and held
      at 0.5 m / 5 degrees; the card planner's calls 2 and 3, replays of
      its CUDA graph, equal to its first bit for bit; K6 ``lane_match``
      at the poses the card planner's first call matched (the others at
      every plan time, B x 31 x (NA - 1) with MC 3, then B egos a plan
      step with MC 1, 31 steps): equal to its plain version
      (``_cluster_reps(*_match_edges(...))``) on the same card tensors,
      ids and flags bit for bit; its record at the others' call there and
      at ``adv_closed_b4``'s shape (the cell's four-map lane graph of
      ``benchmark/inputs/lanes.py``, 375,976 edges, and 465 poses a map,
      the others of one of its planner calls; equal there too, MC 3 and
      1): its ms beside its plain version's and its bound, worked out
      from the pairs of a pose and an edge of its own map;
   b. phase 5's small run in closed loop with the device planner (a 64 m
      lane graph over its 256 px store, 3 iterations): card against CPU,
      loss history rtol 1e-3, final latents atol 1e-4;
   c. ``CL_ITERS`` (10) full-width iterations on the host backend: finite
      losses, trajectories and latents, the counters risen by exactly 1 +
      12 x 10 + 12 crops and 10 + 1 footprints (no window, bisect or
      lane-match kernel);
   d. the same on the device backend, every planner call a replay of
      the graph a captured, and K6 run 32 times a call (the others once,
      the ego once a plan step; a replay counts the launches it runs);
9. the scenario-generation pipeline through the port's entry point,
   ``strive_tpu_torch.scripts.adv_scenario_gen.main``:
   a. the records of K1 at prior sampling's shape (1 scene x 20 samples x
      16 agents = 320 poses of 256 px, ``kernel_cases.sampling_crop_args``)
      and of K2 at the solution loss's (one car a scene, B=4, 48
      interpolated poses each, ``kernel_cases.solution_k2``), each held
      against its plain version first (K1 bit for bit in both layouts and
      in bf16, K2 as in phase 4);
   b. ``configs/adv_gen_synthetic.cfg`` with 3 iterations on 4 scenes,
      on the card (cuDNN deterministic, TF32 off) and on the CPU, from
      torch's default initializers seeded 0 (``torch_default_init``, the
      weights its bounds were measured with): equal
      stats, folders, attackers and attack steps, every file of the JAX
      package's schema; the optimized trajectories and latents within
      the measured bounds ``PARITY_TRAJ_M`` / ``PARITY_LATENT``;
   c. ``configs/adv_gen_synth_hc_prod.cfg`` at full width on strive_tpu's
      trained prior (``--ckpt out/train_synth_prod_torch/checkpoints/
      latest_model``, converted by ``convert_orbax_ckpt.py``), the
      config's 200 iterations with its solution stage, on the first 18
      candidates of the val split in one batch of 8 (the config's B is 4;
      this batch holds this prior's first adversarial successes on an
      H100, scenes 10 and 17): finite final losses, every
      JSON of the schema and read back by the port's ``read_adv_scenes``,
      a solution run exactly when a scene succeeded, and the K1/K2
      counters, set to 0 just before, equal to the launches worked out
      from the stages run (1 + FT a sampling, 1 + 76 FT a fit, 101 FT a
      refit, 201 FT + 201 footprints an adversarial run, 200 x 16 + FT
      crops and 200 footprints a solution run; no window or bisect
      kernel); candidates, feasible, adv_success and sol_success on the
      ``pipeline`` line;
   d. the solution optimization outside the pipeline, whatever c's batch
      reached: 3 iterations of phase 5's small run on the card against
      the CPU (loss rtol 1e-3, latents atol 1e-4), then 20 iterations at
      ``sol_future_len`` 16 on the main path's model, scenes and store
      (the scenes' futures as the adversarial result): finite, the non-ego
      rows equal to the input, 20 x 16 + 12 crops and 20 footprints;
10. refine, ``strive_tpu_torch.scripts.refine_traffic_optim``:
   a. the records of K1 at a decode step of training (B=8 x 16 agents =
      128 poses) and of refine (B=10: 160 poses), and of K2 at the refine
      loss's shape (B=10 x 16 agents x 48 interpolated poses = 7,680 cars,
      ``kernel_cases.refine_k2``) and the training loss's (the ego's 12
      prior-sample poses x B=8 = 96 cars, ``kernel_cases.training_k2``),
      held and timed as in 9a;
   b. phase 5's small run through ``run_refine_optim``, 3 Adam and 2
      L-BFGS iterations (lr 0.05, the refine config's weights), on the
      card and on the CPU: losses rtol 1e-3, latents within the measured
      ``SMALL_REFINE_Z`` (the reason beside it), L-BFGS's losses never
      rising, and the loss evaluations of each device printed (equal when
      the linesearch took the same branches);
   c. the entry point at ``configs/refine_traffic_optim.cfg``'s widths
      (without its ``ckpt`` and ``viz`` lines; synthetic, ``--max_agents``
      16, the test split's first 17 scenes, of which 10 have the
      ``feasibility_num`` of 10 agents: one batch of 10; 256 px,
      ``samp_future_len`` 16), random weights, 20 Adam iterations, then 5
      L-BFGS iterations: finite losses (L-BFGS's never rising), the stats,
      every JSON of the refine schema with finite numbers, and the K1/K2
      counters, set to 0 just before each run, equal to the launches
      worked out: 2 + samp_future_len + save_future_len crops a batch
      (the sample's embed and decode, the embed, the final decode) and
      samp_future_len crops and one footprint a loss evaluation (one an
      Adam iteration; L-BFGS's iterates and linesearch trial points,
      counted at ``avoid_coll_loss``); no window or bisect kernel;
11. training and evaluation:
   a. one train step of phase 5's small model on the card against the CPU
      (the same weights and step noise, lr 1e-4, cuDNN deterministic, TF32
      off): loss rtol 1e-4, updated parameters atol 1e-5 where the
      gradient is not float noise (an element the CPU's Adam moved by
      under 0.99 lr, |g| < 1e-6, is held within 2 lr: Adam's first step
      lr g / (|g| + 1e-8) is noise there too); and, since that step is
      about lr sign(g), the step's gradients themselves, leaf by leaf,
      within ``TRAIN_GRAD_RTOL`` of the leaf's norm;
   b. ``train_traffic`` at ``configs/train_synth_prod.cfg``'s full widths
      (B=8, NA=16, FT=12, 256 px, both collision priors) for one epoch of 5
      batches and its validation pass of 5: finite metrics, the three
      checkpoints, K1 1 + 2 FT and K2 1 launch a step exactly;
   c. ``test_traffic`` with ``configs/test_synth_prod.cfg``'s flags (its
      viz line dropped where matplotlib is missing, 16 scenes) and the
      refine entry point (5 iterations), both reading b's ``latest_model``
      through ``--ckpt``: every metric finite, the stats of 10c,
      test_traffic's K1 launches exact (2 (1 + FT) + 1 + the sample length
      a batch, no K2);
13. (run after 11, before 12) the model options of ``TrafficModel``:
   a. K1's bf16 record at the main path's 32 poses and training's 128:
      the float32 and bf16 ms beside both bounds, and the plain version's
      bf16 ms;
   b. phase 5's small run (3 iterations) with each option: bf16 compute,
      the direct state output (``output_bicycle=False``), the 'gru'
      encoders, ``map_refresh_every`` 2 and 3 (FT 6), card against CPU
      within ``SMALL_BOUNDS`` (the reason beside it); K1 launched 1 +
      (iterations + 1) x FT / k times;
   c. the main path in bf16 (phase 6's weights, TF32 off): exact launches,
      finite losses, trajectories and latents; then ``train_traffic
      --bf16`` as 11b runs it, cut to 3 + 3 batches: exact launches,
      finite metrics;
   d. the main path at ``map_refresh_every=2``: exactly 1 + 21 x 6 = 127
      K1 launches, finite losses and trajectories;
12. (run after 13) nuScenes' data format at its scale, then the tools:
   a. an ETL directory written under the temporary directory (removed at
      the end) by ``data.synthetic_etl.write_synthetic_etl`` through the
      preprocessing's own ``rasterize_maps`` and ``finalize_scene_states``:
      the four maps at nuScenes' extents at 4 px/m (4 x 4 x 14,748 x
      12,914 uint8, each map's dx = extent / round(extent x 4), Singapore
      flipped, synthetic roads over the whole extent), 850 scene names of
      40 frames with 10-40 agents and NaN gaps, lane graphs, meta.json
      (plain ``np.savez``); loaded through ``load_environment`` with
      ``configs/train_traffic.cfg`` (trainval): the store's shape and
      per-map dx as worked out, and its bytes on the card;
   b. K1 (float32 and bf16) bit-exact and K2 within 2e-6 x the largest
      coordinate against their plain versions on that store at the launch
      shapes of c (a decode step of 4 x 16 poses; the ego prior's 48 cars)
      and d (a sampling step of 20 x 16 poses; the adversarial loss's 16 x
      36 cars), each timed beside its plain version and bound;
   c. ``train_traffic -c configs/train_traffic.cfg`` on it for 5 train and
      2 val batches of one epoch: finite metrics, K1 1 + 2 FT and K2 1
      launch a step exactly;
   d. ``adv_scenario_gen -c configs/adv_gen_rule_based.cfg`` without its
      ``ckpt`` line (and its ``viz`` line where matplotlib is missing, as
      this prints), 10 iterations, the entry point stopped after its
      first optimized batch (``max_batches=1``; one scene, screened from
      the first 16 candidates), the host rule planner on the ETL lane
      graphs: K1/K2 launches as worked out from the stages, the JSONs'
      schema;
   e. ``eval_planner -c configs/eval_planner.cfg`` on d's JSONs (and the
      regular scenes among the first 40 that the config's filter keeps),
      ``cluster_scenarios`` (k = 4) over the tracked
      ``out/adv_gen_synth_hc_prod`` JSONs and d's, and ``eval_adv_gen
      --eval_quant`` with that clustering, each on the card and on the
      CPU: the CSVs within 1e-5 (flags and labels exact), the same
      k-means labels;
14. (run after 12) ``parallel/mesh.py`` on the one card (the machine has
   one, so no scaling is measured), each held at
   tests/test_torch_distributed.py's bounds (``MGPU_*``) against the same
   work in this process without a process group:
   a. one train step of phase 5's small model (2 scenes of 2-4 agents)
      through ``mesh.launch`` with NCCL at one rank: the gradients, the
      metrics and the parameters after the Adam step;
   b. the same step with gloo at two ranks, both on cuda:0 (NCCL takes one
      card a rank), and 9b's ``configs/adv_gen_synthetic.cfg`` run with
      ``--batch_size 3`` (a batch padded to 4) through
      ``adv_scenario_gen.run`` in two gloo ranks on cuda:0: equal stats,
      folders, attackers and attack steps, trajectories and latents
      within ``MGPU_TRAJ_M`` / ``MGPU_LATENT``. A collective gloo refused
      on CUDA tensors would raise here;
   c. K1 and K2 at a rank's launch shapes of the production config's B=4
      over 4 ranks (``kernel_cases.shard_args``: 16 poses, 576 cars; over
      2 they are the main path's), held and timed as in 12b;
7. the window kernels of the gather probes, K3 ``window_crop_tiles``, K4a
   ``window_extract`` and K4b ``window_take``: bit-exact against their
   plain versions on the inputs no card test holds them on (K3 at the
   edges of both probe windows; K4a at probe 2's and 3's windows and at
   its edges, K4b at probe 1's shape and on wild indices, both dtypes),
   the launch counters risen by exactly those calls and the timed ones;
   each kernel's record at its probe script's shape beside its plain
   version, one library call and its bound. Then the gather-probe path
   (``probes.onehot_crop.run``, ``probes.gather.run``) with the window
   counters set to 0: the counters equal to the launches worked out from
   the probes' ``REPS`` and steps;
8. the Mosaic-bisect kernels, K5a ``scale_rows``, K5b ``window_convert``,
   K5c ``window_sums`` and K5d ``onehot_rows``: bit-exact against their
   plain versions at the gather-probe path's shape (8192 x 1024 in groups
   of 8; 2048 windows of 64x192 on the (2048, 1024) raster; 2048 one-hot
   tiles) and at the edges of ``bisect_edge_cases``, the launch counters
   risen by exactly those calls and the timed ones; each kernel's record
   at the scripts' shape beside the launch floor (``torch.cuda._sleep(0)``)
   and one library call, and at the path's shape beside its plain
   version, one library call and its bound (K5d also beside its write
   floor, ``out.fill_(1)``).
   Then the 19 variants (``probes.mosaic_bisect.run``) with the K5
   counters set to 0: every variant correct, and the counters equal to the
   launches worked out from ``REPS`` and each variant's kernel;
15. the port's harnesses and studies, as a user runs them:
   a. ``scripts.bench`` (bench.py's workload) at 5 iterations a run, in
      this process: one JSON line with bench.py's keys, and K1 and K2
      launched exactly 1 + 6 x 12 x 6 and 6 x 6 times (the embedding, a
      warm-up run and 5 timed runs of 5 iterations and a final decode);
   b. ``scripts.bench_closed_loop`` in its device-planner mode
      (``STRIVE_BENCH_MODES=fused``) at k = 1 and 2, 5 iterations a run:
      its line, and exact K1 and K2 launches (4 runs), and K6's, 32 a
      planner call;
   c. ``scripts.study_yield`` (points closed and open loop at 20
      iterations) and ``scripts.study_refresh_quality`` (``--ks 1 2
      --skip_perf``) side by side in two processes, both on 9c's trained
      prior and config at ``--max_scenes 4``: their JSONs written with
      their keys, adv <= feasible <= candidates at each point, each k's
      scenes no more than the feasible ones, and k = 1 0 m from itself;
16. prints the probes' and the variants' JSON lines (the probes' own
   figures, as the probe scripts report them), then a JSON line a phase:
   ``closed_loop`` (6b: the parity numbers and replays of a, the final
   losses and planner calls and replays of c and d), ``pipeline`` (9:
   the stats, stage calls and launches of c, b's largest differences, the
   cuts in ``reduced``, d's result),
   ``refine`` (10), ``training`` (11), ``options`` (13), ``nuscenes``
   (12), ``multi_gpu`` (14) and ``studies`` (15: the harnesses' launches
   and the studies' counts), then the ``kernels`` line, the card's name
   and power limit, and last the device JSON line. The ``kernels`` line
   has an entry a kernel: ``max_abs_err`` over its checks here (K3-K5
   also their number, ``cases``), ``ms``, ``plain_ms``, ``bound_ms`` and
   ``library_ms`` at the shape it is timed at (K1's ``library`` the
   library yardstick's other timings and differences), and ``launches``,
   counted on the path that ``path`` names: the open-loop main path for K1
   and K2, the gather-probe path for K3 and K4, the Mosaic-bisect probes
   for K5, 6b d's closed loop for K6 (K3-K6 launch 0 times on the main
   path: ``main_path_launches``); every entry's ``closed_loop_launches``
   is its count in one closed-loop run of 6b c and d; K6's ``cell_shape``
   its record at ``adv_closed_b4``'s shape (6b a); K1's and K2's
   ``pipeline_launches`` their counts in 9c and ``pipeline_shape`` their
   9a records; ``refine_shape`` and ``training_shape`` their 10a records,
   ``refine_launches`` their counts in 10c's Adam run and
   ``training_launches_per_step`` theirs in 11b; ``nusc_train_shape`` and
   ``nusc_adv_shape`` their 12b records, ``nusc_train_launches`` and
   ``nusc_adv_launches`` their counts in 12c and 12d; ``shard_shape``
   their 14c records; K1's ``bf16_shape`` its 13a record,
   ``bf16_launches`` its count on 13c's bf16 main path and
   ``refresh2_launches`` on 13d's.

Any failure raises, and the script exits non-zero.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

ITERS = 20
B, NA, PT, FT, MAP_PX, STORE_PX = 4, 8, 4, 12, 256, 2048
# (device memory B/s, fp32 FLOP/s without tensor cores), NVIDIA data sheets
CARD_RATES = {"H100 PCIe": (2.0e12, 51.2e12), "H100": (3.35e12, 67e12),
              "H200": (4.8e12, 67e12)}
CROP_FLOPS_PER_PIXEL = 9  # 4 mul + 3 add/sub (rotation) + 2 div (to pixels)
FOOTPRINT_FLOPS_PER_SAMPLE = 13  # 2 mul (extents) + the crop's 9 + 2 adds


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def zero(counters):
    """Set every launch counter to 0."""
    for counts in counters:
        for k in counts:
            counts[k] = 0


def counted(counters):
    """{kernel: launches} over all counters."""
    return {k: v for counts in counters for k, v in counts.items()}


def card_rates(name):
    for key in sorted(CARD_RATES, key=len, reverse=True):
        if key in name:
            return CARD_RATES[key]
    raise RuntimeError(f"no data-sheet rates for {name}")


def bound_ms(rates, nbytes, flops):
    t_bytes, t_ops = nbytes / rates[0], flops / rates[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def unique_raster_bytes(torch, queries, packed, dx, xys, mapix):
    """Distinct raster bytes a gather of ``xys`` needs (this run's data)."""
    M, H, W = packed.shape
    m, py, px = queries._pixel_index(H, W, dx, xys, mapix)
    return int(torch.unique((m * H + py) * W + px).numel())


def crop_work(torch, queries, args, out_bytes=4):
    """(bytes, float ops) of one K1 call on ``args``: the distinct raster
    bytes its samples read (this run's data), its other inputs once, its
    output of ``out_bytes`` a value (4 float32, 2 bf16) once; 9 float ops
    a sample."""
    packed, dx, pos, mapix, lo, wo, C = args[:7]
    xys = queries.rotate_grid(lo[None, :, None], wo[None, None, :],
                              pos[:, :2], pos[:, 2:4])
    n_pix = pos.shape[0] * lo.numel() * wo.numel()
    nbytes = (unique_raster_bytes(torch, queries, packed, dx, xys, mapix)
              + pos.numel() * 4 + mapix.numel() * 8 + dx.numel() * 4
              + (lo.numel() + wo.numel()) * 4 + n_pix * C * out_bytes)
    return nbytes, n_pix * CROP_FLOPS_PER_PIXEL


def footprint_work(torch, queries, args):
    """(bytes, float ops) of one K2 call on ``args``: the distinct raster
    bytes its 39x16 samples read, its inputs and outputs once; 13 float ops
    a sample."""
    packed, dx, cars, lw, cmap, lin_l, lin_w = args[:7]
    P, L, W = cars.shape[0], lin_l.numel(), lin_w.numel()
    samples = queries.gen_car_coords(cars[:, :2], cars[:, 2:4], L, W,
                                     ls=lw[:, 0], ws=lw[:, 1])
    nbytes = (unique_raster_bytes(torch, queries, packed, dx, samples, cmap)
              + P * (16 + 8 + 8) + dx.numel() * 4 + (L + W) * 4
              + P * (8 + 1 + 4))
    return nbytes, P * L * W * FOOTPRINT_FLOPS_PER_SAMPLE


def build_model(torch, tm, norm, map_px, **kw):
    torch.manual_seed(0)
    return tm.TrafficModel(PT, kw.pop("FT", FT), map_px, 2, norm,
                           device=kw.pop("device", "cuda"), **kw)


def crop_library(torch, args):
    """K1's function as one library call a map computes it (a yardstick;
    the port never calls it): for the poses on map m, one
    ``F.affine_grid`` (a pose's crop is affine in the output grid) and one
    ``F.grid_sample(mode='nearest', align_corners=True)`` of map m's raster
    as float ``1 x C x H x W`` on the grid ``1 x (P 256) x 256 x 2``, so the
    map is never copied a pose. The float rasters and the poses' affine
    matrices are made beforehand.

    :return: (fn, to_crops): ``fn()`` runs the calls; ``to_crops(fn())``
        is the (P, C, L, W) result in K1's pose order"""
    import torch.nn.functional as F

    packed, dx, pos, mapix, lo, wo, C = args[:7]
    shifts = torch.arange(C, dtype=torch.uint8, device=packed.device)
    maps = ((packed[:, None] >> shifts[None, :, None, None]) & 1).float()
    H, Wm = packed.shape[1:]
    L, W = lo.numel(), wo.numel()
    # the crop's offsets are linspaces, so affine in affine_grid's [-1, 1]
    s_l, a_l = (float(lo[-1]) - float(lo[0])) / 2, (float(lo[-1])
                                                    + float(lo[0])) / 2
    s_w, a_w = (float(wo[-1]) - float(wo[0])) / 2, (float(wo[-1])
                                                    + float(wo[0])) / 2
    p = pos.double()
    hc, hs = p[:, 2], p[:, 3]
    d = dx[mapix].double()
    kx, ky = 2.0 / (d[:, 0] * (Wm - 1)), 2.0 / (d[:, 1] * (H - 1))
    theta = torch.stack([
        torch.stack([-s_w * hs * kx, s_l * hc * kx,
                     kx * (a_l * hc - a_w * hs + p[:, 0]) - 1], -1),
        torch.stack([s_w * hc * ky, s_l * hs * ky,
                     ky * (a_l * hs + a_w * hc + p[:, 1]) - 1], -1)],
        1).float()
    groups = [(m, (mapix == m).nonzero().squeeze(1))
              for m in sorted(set(mapix.tolist()))]
    per_map = [(maps[m:m + 1], theta[idx].contiguous()) for m, idx in groups]

    def fn():
        return [F.grid_sample(
            raster, F.affine_grid(th, (th.shape[0], C, L, W),
                                  align_corners=True).reshape(1, -1, W, 2),
            mode="nearest", padding_mode="zeros", align_corners=True)
            for raster, th in per_map]

    def to_crops(outs):
        crops = torch.empty((pos.shape[0], C, L, W), device=pos.device)
        for (_, idx), o in zip(groups, outs):
            crops[idx] = o.reshape(C, idx.numel(), L, W).transpose(0, 1)
        return crops

    return fn, to_crops


def crop_library_entry(torch, queries, crop_kernel, cuda_ms, args):
    """The library call of ``crop_library`` timed at ``args``, and where
    its crop differs from K1's: samples within 1e-3 px of a rounding tie
    (its grid passes through normalized coordinates), off the map (it
    reads 0, K1 pixel (0, 0)), at a NaN pose (K1 reads position 0), and
    any other."""
    fn, to_crops = crop_library(torch, args)
    ms = cuda_ms(fn, 200)
    k1 = crop_kernel.map_crop(*args[:7], "nchw")
    lib = to_crops(fn())
    packed, dx, pos, mapix, lo, wo = args[:6]
    xys = queries.rotate_grid(lo[None, :, None], wo[None, None, :],
                              pos[:, :2], pos[:, 2:4])
    q = xys / dx[mapix][:, None, None, :]
    H, W = packed.shape[1:]
    nan = torch.isnan(xys).any(-1)
    r = torch.round(q)
    off = ~nan & ((r[..., 0] < 0) | (r[..., 0] >= W) | (r[..., 1] < 0)
                  | (r[..., 1] >= H))
    tie = ~nan & ((q - torch.floor(q) - 0.5).abs() < 1e-3).any(-1)
    diff = (k1 != lib).any(1)  # (P, L, W)
    out = {"ms": ms, "samples": int(diff.numel()),
           "differ": int(diff.sum()),
           "differ_off_map": int((diff & off).sum()),
           "differ_near_tie": int((diff & tie & ~off).sum()),
           "differ_nan_pose": int((diff & nan).sum())}
    out["differ_other"] = (out["differ"] - out["differ_off_map"]
                           - out["differ_near_tie"] - out["differ_nan_pose"])
    return out


def window_args(torch, np, oc, dev):
    """K3, K4a and K4b's arguments: {kernel: args} at the probe scripts'
    shapes they are timed at (K3 at probe 1's window, K4a at probe 2's: 32
    int32 windows of 640 x 640, K4b at probe 1's: 32 int32 windows of 512
    x 512), and the (kernel, args) pairs that hold them against their plain
    versions where no card test holds them on the same inputs: K3's edges,
    K4a at probe 2's and 3's windows and its edges, K4b at probe 1's shape
    and on wild indices, each of K4 in both dtypes."""
    rng = np.random.default_rng(7)

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

    cases = []
    for window in ("dma", "quadrant"):
        probe = oc.PROBES[window]
        x = oc._inputs(probe, dev)
        N, L, W = probe["N"], probe["L"], probe["W"]
        tiles = [oc.tileize(x[k], N, L, W) for k in ("py", "px", "outside")]
        if window == "dma":
            crop = (x["flat"], *oc.tile_windows(
                *tiles, x["mapix"], probe["H"], probe["Wp"],
                x["flat"].shape[0], window), *oc.WINDOWS[window])
        # edges: windows at the last rows and columns, origins off the
        # 16-byte grid and outside the raster, indices outside the window
        flat = x["flat"]
        R, Wp = flat.shape
        WR, WC = oc.WINDOWS[window]
        row0 = i32([[R - WR, R - WR, -9, R + 50], [3, R - WR - 1, 0, 17]])
        col0 = i32([[Wp - WC, Wp - WC - 5, 5, 10 ** 6], [-40, 1, 33, 127]])
        ly = i32(rng.integers(-3, WR + 4, (2, 4, 1024)))
        lx = i32(rng.integers(-3, WC + 4, (2, 4, 1024)))
        cases.append(("window_crop_tiles", (flat, row0, col0, ly, lx, WR, WC)))

    r2 = np.random.default_rng(0)
    M, H, Wp, N, WIN = 2, 2048, 2048, 32, 640
    raster = torch.from_numpy(
        r2.integers(0, 16, (M * H, Wp)).astype(np.uint8)).to(dev)
    y0, x0 = (i32(r2.integers(0, H - WIN, N)) for _ in range(2))
    row0 = (i32(r2.integers(0, M, N)) * H + y0).int()
    extract = (raster.int(), row0, x0, WIN)
    cases += [("window_extract", extract),
              ("window_extract", (raster, row0, x0, WIN)),
              ("window_extract", (raster, row0, x0, 512))]  # probe 3
    edge_r = i32([-5, M * H - 10, M * H + 100, 0, 7])
    edge_c = i32([Wp - 3, -7, 5, 10 ** 6, 9])
    for r in (raster, raster.int()):
        cases.append(("window_extract", (r, edge_r, edge_c, WIN)))

    r1 = np.random.default_rng(0)
    wins = torch.from_numpy(
        r1.integers(0, 16, (32, 512 * 512)).astype(np.int32)).to(dev)
    idx = i32(r1.integers(0, 512 * 512, (32, 256 * 256)))
    cases += [("window_take", (wins, idx)),
              ("window_take", (wins.to(torch.uint8), idx))]
    wild = i32(rng.integers(-2 ** 31, 2 ** 31 - 1, (5, 1001)))
    wild[:, :4] = i32([-1, 0, 512 * 512 - 1, 512 * 512])
    for w in (wins[:5], wins[:5].to(torch.uint8)):
        cases.append(("window_take", (w.contiguous(), wild)))
    return {"window_crop_tiles": crop, "window_extract": extract,
            "window_take": (wins, idx)}, cases


def window_bytes(torch, wk, name, args):
    """Bytes a window function must move for ``args``: its index inputs
    and output once, and the distinct raster or window elements it reads
    (this run's data)."""
    if name == "window_crop_tiles":
        flat, row0, col0, ly, lx, WR, WC = args
        R, Wp = flat.shape
        rows = wk.slice_start(row0, R, WR)[..., None] + ly.clamp(0, WR - 1)
        cols = wk.slice_start(col0, Wp, WC)[..., None] + lx.clamp(0, WC - 1)
        distinct = torch.unique(rows * Wp + cols).numel()
        return (2 * row0.numel() * 4 + 2 * ly.numel() * 4 + ly.numel() * 4
                + distinct)
    if name == "window_extract":
        raster, row0, col0, WIN = args
        R, Wp = raster.shape
        ar = torch.arange(WIN, device=raster.device)
        rows = wk.slice_start(row0, R, WIN)[:, None] + ar
        cols = wk.slice_start(col0, Wp, WIN)[:, None] + ar
        covered = torch.zeros((R, Wp), dtype=torch.bool, device=raster.device)
        covered[rows[:, :, None], cols[:, None, :]] = True
        es = raster.element_size()
        return (2 * row0.numel() * 4 + row0.numel() * WIN * WIN * es
                + int(covered.sum()) * es)
    wins, idx = args
    N, S = wins.shape
    flat = (torch.arange(N, device=idx.device)[:, None] * S
            + idx.long().clamp(0, S - 1))
    es = wins.element_size()
    return idx.numel() * (4 + es) + torch.unique(flat).numel() * es


def library_call(torch, wk, name, args):
    """One PyTorch call that computes the kernel's function on ``args``,
    from index tensors made beforehand (a yardstick; the port never calls
    it). K3's returns the bytes as uint8, without the float32 convert
    (``library_f32_ms`` times it with the convert)."""
    if name == "window_crop_tiles":
        flat, row0, col0, ly, lx, WR, WC = args
        R, Wp = flat.shape
        idx = ((wk.slice_start(row0, R, WR)[..., None] + ly.clamp(0, WR - 1))
               * Wp + wk.slice_start(col0, Wp, WC)[..., None]
               + lx.clamp(0, WC - 1))
        return lambda: torch.take(flat, idx)
    if name == "window_extract":
        raster, row0, col0, WIN = args
        R, Wp = raster.shape
        ar = torch.arange(WIN, device=raster.device)
        rows = (wk.slice_start(row0, R, WIN)[:, None] + ar)[:, :, None]
        cols = (wk.slice_start(col0, Wp, WIN)[:, None] + ar)[:, None, :]
        return lambda: raster[rows, cols]
    wins, idx = args
    idx64 = idx.long().clamp(0, wins.shape[1] - 1)
    return lambda: torch.gather(wins, 1, idx64)


WINDOW_REPLACES = {
    "window_crop_tiles": "scripts/probe_onehot_crop.py:88",
    "window_extract": "scripts/pallas_gather_probe2.py:64",
    "window_take": "scripts/pallas_gather_probe.py:59",
}


def window_phase(torch, rates, card):
    """Phase 7: K3, K4a and K4b against their plain versions where no card
    test holds them on the same inputs, and their records at their probe
    scripts' shapes, beside their plain versions, one library call and
    their bounds; then the gather-probe path through them.

    :return: the three ``kernels`` entries, the probes' JSON line
    """
    import numpy as np

    from strive_tpu_torch.probes import gather
    from strive_tpu_torch.probes import onehot_crop as oc
    from strive_tpu_torch.probes import window_kernels as wk
    from strive_tpu_torch.utils.timing import calls, cuda_ms

    timed, cases = window_args(torch, np, oc, torch.device("cuda"))
    before = dict(wk.LAUNCHES)
    launched = dict.fromkeys(wk.LAUNCHES, 0)
    err = dict.fromkeys(wk.LAUNCHES, 0.0)
    for name, args in cases:
        got = getattr(wk, name)(*args)
        want = getattr(wk, f"{name}_plain")(*args)
        torch.cuda.synchronize()
        launched[name] += 1
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{name} differs from plain: "
                                 f"{int((got != want).sum())} values")
        err[name] = max(err[name], float(
            (got.double() - want.double()).abs().amax()))
        del got, want
    entries = {}
    for name, args in timed.items():
        kern = getattr(wk, name)
        plain = getattr(wk, f"{name}_plain")
        lib = library_call(torch, wk, name, args)
        e = entries[name] = dict(
            name=name, route="cuda",
            source="strive_tpu_torch/csrc/window.cu",
            replaces=WINDOW_REPLACES[name], max_abs_err=err[name],
            ms=cuda_ms(lambda: kern(*args), 200),
            plain_ms=cuda_ms(lambda: plain(*args), 20),
            library_ms=cuda_ms(lib, 20))
        if name == "window_crop_tiles":  # with K3's float32 out: two calls
            e["library_f32_ms"] = cuda_ms(lambda: lib().float(), 20)
        e["bound_ms"], e["bound_by"] = bound_ms(
            rates, window_bytes(torch, wk, name, args), 0)
        e["cases"] = launched[name]  # before the timed calls
        launched[name] += calls(200)
        log(f"{name} bit-exact on {e['cases']} cases; {e['ms']:.4f} ms "
            f"(plain {e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} "
            f"ms, bound {e['bound_ms']:.4f} ms by {e['bound_by']})")
    delta = {k: wk.LAUNCHES[k] - before[k] for k in wk.LAUNCHES}
    if delta != launched:
        raise AssertionError(f"window launches {delta}, expected {launched}")

    # the gather-probe path, counted from zero
    for k in wk.LAUNCHES:
        wk.LAUNCHES[k] = 0
    crop = oc.run("cuda")
    gath = gather.run("cuda")
    launches = dict(wk.LAUNCHES)
    # per crop window: K3 and K4b once each to check, then two timed paths
    # through each; per gather step: one call to check, then the timed calls
    per_window = 1 + 2 * calls(oc.REPS)
    expected = {"window_crop_tiles": per_window * len(oc.PROBES),
                "window_take": per_window * len(oc.PROBES),
                "window_extract": 0}
    for s in gath["steps"]:
        for k in ("take", "extract"):
            if k in s["step"]:
                expected[f"window_{k}"] += 1 + calls(gather.REPS)
    if launches != expected or not all(launches.values()):
        raise AssertionError(f"probe launches {launches}, expected {expected}")
    for line in oc.format_lines(crop) + gath["lines"]:
        log(line)
    for e in entries.values():
        e["launches"] = launches[e["name"]]
        e["path"] = "gather probes (probes.onehot_crop.run + gather.run)"
        e["main_path_launches"] = 0
    probes = {
        "probes": "onehot_crop + gather", "card": card,
        "onehot_crop": {w: {k: v for k, v in crop[w].items()
                            if k.endswith("gelem_s") or k.endswith("_ms")}
                        for w in oc.PROBES},
        "gather": {f"probe{s['probe']} {s['step']}": s["gelem_s"]
                   for s in gath["steps"]},
        "launches": launches,
    }
    return entries, probes


BISECT_REPLACES = {
    "scale_rows": "scripts/probe_mosaic_bisect.py:30",
    "window_convert": "scripts/probe_mosaic_bisect.py:91",
    "window_sums": "scripts/probe_mosaic_bisect.py:158",
    "onehot_rows": "scripts/probe_mosaic_bisect.py:42",
}
# the variant whose inputs each K5 kernel is timed at, at the scripts' size
BISECT_SCRIPT_SHAPE = {"scale_rows": "v_fori_when_rem",
                       "window_convert": "v_dma_dynamic",
                       "window_sums": "v_prefetch_indexmap",
                       "onehot_rows": "v_iota_compare_matmul"}
BISECT_LIBRARY = {
    "scale_rows": "torch.mul with a broadcast factor (one call)",
    "window_convert": "advanced indexing, then .to(torch.int32) (two calls)",
    "window_sums": "advanced indexing of a strided (unfold) view of every "
                   "window, then torch.sum (two calls)",
    "onehot_rows": "torch.gather over w.float().transpose(1, 2) (one call)",
}


def bisect_edge_cases(torch, np, dev):
    """(kernel, args) pairs at K5's edges that no card test holds on the
    same inputs: K5a on odd widths in both dtypes, K5b's windows at the
    last rows and columns, starts off the 16-byte grid, negative or past
    the array, in each conversion, and K5d's indices below 0 and at or
    above R."""
    rng = np.random.default_rng(9)

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

    def tensor(a):
        return torch.from_numpy(a).to(dev)

    cases = [
        ("scale_rows", (tensor(rng.standard_normal((9, 1001)).astype(
            np.float32)), tensor(rng.standard_normal(3).astype(np.float32)),
            3)),
        ("scale_rows", (i32(rng.integers(-2 ** 31, 2 ** 31, (12, 256))),
                        i32(rng.integers(-2 ** 31, 2 ** 31, 3)), 4)),
    ]
    R, C, WR = 300, 1000, 64
    u8 = tensor(rng.integers(0, 256, (R, C)).astype(np.uint8))
    f32 = tensor(rng.standard_normal((R, C)).astype(np.float32))
    for WC in (192, 61):
        row0 = i32([R - WR, R - WR - 1, -9, R + 50, 3, 0, -R - 7, 37])
        col0 = i32([C - WC, C - WC - 5, 5, 10 ** 6, -40, 1, 33, 127])
        for src, out in ((u8, torch.int32), (u8, torch.float32),
                         (f32, torch.float32)):
            for side in (False, True):
                cases.append(("window_convert",
                              (src, row0, col0, WR, WC, out, side)))
    T, Rw, Cw, P = 5, 64, 192, 1000
    w = tensor(rng.standard_normal((T, Rw, Cw)).astype(np.float32)).to(
        torch.bfloat16)
    idx = i32(rng.integers(-3, Rw + 3, (T, P)))
    idx[:, :6] = i32([-1, 0, Rw - 1, Rw, -2 ** 31, 2 ** 31 - 1])
    cases.append(("onehot_rows", (w, idx)))
    return cases


def bisect_bytes(torch, bk, name, args):
    """Bytes a K5 function must move for ``args``: its inputs and output
    once, counting only the distinct source elements its windows or indices
    touch (this run's data)."""
    if name == "scale_rows":
        x, f, _ = args
        return 2 * x.numel() * x.element_size() + f.numel() * f.element_size()
    if name == "onehot_rows":
        w, idx = args
        T, R, C = w.shape
        valid = (idx >= 0) & (idx < R)
        t = torch.arange(T, device=idx.device)[:, None].expand_as(idx)
        rows = torch.unique((t * R + idx)[valid]).numel()
        return rows * C * 2 + idx.numel() * 4 + T * C * idx.shape[1] * 4
    src, row0, col0 = args[:3]
    WR, WC = args[3:5] if name == "window_convert" else args[4:6]
    R, C = src.shape
    dev = src.device
    rows = bk.slice_start(row0.reshape(-1), R, WR)[:, None] + torch.arange(
        WR, device=dev)
    cols = bk.slice_start(col0.reshape(-1), C, WC)[:, None] + torch.arange(
        WC, device=dev)
    covered = torch.zeros((R, C), dtype=torch.bool, device=dev)
    covered[rows[:, :, None], cols[:, None, :]] = True
    nbytes = int(covered.sum()) * src.element_size() + 2 * row0.numel() * 4
    if name == "window_convert":
        return nbytes + row0.numel() * WR * WC * 4
    return nbytes + args[3].numel() * 4 + row0.shape[0] * 4


def bisect_library_call(torch, bk, name, args):
    """One PyTorch call (two where no single call exists; see
    ``BISECT_LIBRARY``) that computes the K5 function on ``args``, from
    index tensors and views made beforehand; the port never calls it."""
    if name == "scale_rows":
        x, f, G = args
        xv, fv = x.view(-1, G, x.shape[1]), f[:, None, None]
        return lambda: torch.mul(xv, fv)
    if name == "onehot_rows":
        w, idx = args
        T, R, C = w.shape
        wt = w.float().transpose(1, 2)
        index = idx.long().clamp(0, R - 1)[:, None, :].expand(T, C,
                                                               idx.shape[1])
        return lambda: torch.gather(wt, 2, index)
    src, row0, col0 = args[:3]
    WR, WC = args[3:5] if name == "window_convert" else args[4:6]
    R, C = src.shape
    r = bk.slice_start(row0.reshape(-1), R, WR)
    c = bk.slice_start(col0.reshape(-1), C, WC)
    if name == "window_convert":
        rows = (r[:, None] + torch.arange(WR, device=src.device))[:, :, None]
        cols = (c[:, None] + torch.arange(WC, device=src.device))[:, None, :]
        return lambda: src[rows, cols].to(torch.int32)
    view = src.unfold(0, WR, 1).unfold(1, WC, 1)  # every window, no copy
    return lambda: torch.sum(view[r, c], dim=(1, 2))


def bisect_phase(torch, rates, card):
    """Phase 8: K5a-K5d against their plain versions at the gather-probe
    path's shape and at the edges no card test holds on the same inputs;
    each K5 kernel's record at the scripts' shape beside the launch floor
    and one library call, and at the path's shape beside its plain
    version, one library call and its bound; then the Mosaic-bisect
    probes through them.

    :return: the four ``kernels`` entries, the variants' JSON line
    """
    import numpy as np

    from strive_tpu_torch import kernel_cases as kc
    from strive_tpu_torch.probes import bisect_kernels as bk
    from strive_tpu_torch.probes import mosaic_bisect as mb
    from strive_tpu_torch.utils.timing import calls, cuda_ms

    dev = torch.device("cuda")
    variants = {v.__name__: v for _, _, v in mb.VARIANTS}
    script_args = {k: variants[v](dev).args
                   for k, v in BISECT_SCRIPT_SHAPE.items()}
    path_args = kc.bisect_path_args(dev)
    before = dict(bk.LAUNCHES)
    launched = dict.fromkeys(bk.LAUNCHES, 0)
    err = dict.fromkeys(bk.LAUNCHES, 0.0)
    for name, args in [*path_args.items(),
                       *bisect_edge_cases(torch, np, dev)]:
        got = getattr(bk, name)(*args)
        want = getattr(bk, f"{name}_plain")(*args)
        torch.cuda.synchronize()
        launched[name] += 1
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{name} differs from plain: "
                                 f"{int((got != want).sum())} values")
        diff = (got - want) if got.is_floating_point() \
            else (got.long() - want.long())
        err[name] = max(err[name], float(diff.abs().amax()))
        del got, want, diff
    entries = {}
    floor = cuda_ms(lambda: torch.cuda._sleep(0), 200)
    for name in bk.LAUNCHES:
        kern = getattr(bk, name)
        plain = getattr(bk, f"{name}_plain")

        def bound(args):  # only K5a does float operations: one multiply
            return bound_ms(rates, bisect_bytes(torch, bk, name, args),
                            args[0].numel() if name == "scale_rows" else 0)

        e = entries[name] = dict(name=name, route="cuda",
                                 source="strive_tpu_torch/csrc/bisect.cu",
                                 replaces=BISECT_REPLACES[name],
                                 max_abs_err=err[name],
                                 cases=launched[name])
        a = script_args[name]
        e["script_shape"] = BISECT_SCRIPT_SHAPE[name]
        e["script_ms"] = cuda_ms(lambda: kern(*a), 200)
        e["script_bound_ms"] = bound(a)[0]
        e["script_library_ms"] = cuda_ms(
            bisect_library_call(torch, bk, name, a), 200)
        e["launch_floor_ms"] = floor
        a = path_args[name]
        e["ms"] = cuda_ms(lambda: kern(*a), 50)
        launched[name] += calls(200) + calls(50)
        e["plain_ms"] = cuda_ms(lambda: plain(*a), 5)
        e["library_ms"] = cuda_ms(bisect_library_call(torch, bk, name, a), 5)
        e["library_call"] = BISECT_LIBRARY[name]
        e["bound_ms"], e["bound_by"] = bound(a)
        if name == "onehot_rows":  # its 1.61 GB output written alone
            out = torch.empty((a[0].shape[0], a[0].shape[2], a[1].shape[1]),
                              device=dev)
            e["write_floor_ms"] = cuda_ms(lambda: out.fill_(1), 50)
            e["script_launch"] = bk.onehot_launch(
                *script_args[name][0].shape, script_args[name][1].shape[1],
                bk._sm_count(dev))
            e["path_launch"] = bk.onehot_launch(*a[0].shape, a[1].shape[1],
                                                bk._sm_count(dev))
            del out
        log(f"{name} bit-exact on {e['cases']} cases; path shape "
            f"{e['ms']:.4f} ms (plain {e['plain_ms']:.4f}"
            f" ms, library {e['library_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']}); script shape "
            f"({e['script_shape']}) {e['script_ms']:.4f} ms (bound "
            f"{e['script_bound_ms']:.5f} ms, library "
            f"{e['script_library_ms']:.4f} ms), launch floor {floor:.4f} ms")
        torch.cuda.empty_cache()
    delta = {k: bk.LAUNCHES[k] - before[k] for k in bk.LAUNCHES}
    if delta != launched:
        raise AssertionError(f"bisect launches {delta}, expected {launched}")

    # the Mosaic-bisect probes, counted from zero
    for k in bk.LAUNCHES:
        bk.LAUNCHES[k] = 0
    res = mb.run("cuda")
    launches = dict(bk.LAUNCHES)
    expected = dict.fromkeys(bk.LAUNCHES, 0)
    for v in res["variants"]:  # one call to check, then the timed calls
        expected[v["kernel"]] += 1 + calls(mb.REPS)
    if launches != expected or not all(launches.values()):
        raise AssertionError(f"bisect probe launches {launches}, expected "
                             f"{expected}")
    if not all(v["correct"] for v in res["variants"]) \
            or len(res["variants"]) != 19:
        raise AssertionError("a Mosaic-bisect variant is not correct")
    for line in res["lines"]:
        log(line)
    for e in entries.values():
        e["launches"] = launches[e["name"]]
        e["path"] = "mosaic-bisect probes (probes.mosaic_bisect.run)"
        e["main_path_launches"] = 0
    line = {"mosaic_bisect": "19 variants", "card": card,
            "variants_ms": {v["name"]: v["ms"] for v in res["variants"]},
            "launches": launches}
    return entries, line


# 6b's full-width closed-loop runs, a backend: half the main path's
# ITERS (the host backend's numpy planner is the slowest part)
CL_ITERS = 10
SMALL_KW = dict(map_bounds=(-4.0, -8.0, 12.0, 8.0), conv_kernels=(5, 3, 3),
                conv_strides=(2, 2, 2), conv_filters=(8, 8, 16), FT=3)


def small_setup(torch, tm, norm, device, **options):
    """Phase 5's small run on ``device``: the tiny model (32 px crops,
    FT=3, or ``options``' FT and model options), a 2 x 256 px store, 2
    scenes of 2-4 agents, and its embedding."""
    from strive_tpu_torch.data.synthetic import synthetic_scene_list
    from strive_tpu_torch.maps.store import synthetic_map_store
    from strive_tpu_torch.scene import pad_scene_arrays

    kw = {**SMALL_KW, **options}
    m = build_model(torch, tm, norm, 32, device=device, **kw)
    st = synthetic_map_store(num_maps=2, size_px=256, channels=4,
                             device=device)
    sc = pad_scene_arrays(synthetic_scene_list(
        num_scenes=2, num_maps=2, map_size_px=256, PT=PT, FT=kw["FT"],
        min_agents=2, max_agents=4), 4, 2, device=device)
    with torch.no_grad():
        emb = m.embed(sc, st)
    return m, st, sc, emb


def run_optim(run_adv_gen_optim, model, scene, store, emb, iters, **kw):
    """The adversarial optimization from the prior mean, bench.py's weights,
    lr 0.05, feasibility time 2: 'ego' unless ``kw`` names a planner fn."""
    from strive_tpu_torch.scripts.bench import WEIGHTS

    prior = emb["prior_out"]
    return run_adv_gen_optim(
        model, prior[0], 0.05, WEIGHTS, scene, store, iters, emb,
        "hardcode" if kw else "ego", (prior[0][:, 0], prior[1][:, 0]), prior,
        2, None, **kw)


def compare_futures(np, state_norm, got, want, tol_m, tol_rad, label):
    """Per-scene largest position (m) and heading (rad) difference of two
    (B, T, 4) NORMALIZED planner futures. A scene past (tol_m, tol_rad) is
    printed as a decision that flipped on float error and held at the
    decision-parity tolerance of 0.5 m and 5 degrees; past that, raises.

    :return: {max_m, max_rad, flipped_scenes}"""
    g = state_norm.unnormalize(got.detach().cpu()).numpy().astype(np.float64)
    w = state_norm.unnormalize(want.detach().cpu()).numpy().astype(np.float64)
    pos = np.linalg.norm(g[..., :2] - w[..., :2], axis=-1).max(1)
    ang = np.abs(np.angle(np.exp(1j * (np.arctan2(g[..., 3], g[..., 2])
                                       - np.arctan2(w[..., 3], w[..., 2]))))
                 ).max(1)
    if not (np.isfinite(g).all() and np.isfinite(w).all()):
        raise AssertionError(f"{label}: planner futures not finite")
    flipped = [b for b in range(len(pos))
               if pos[b] >= tol_m or ang[b] >= tol_rad]
    for b in flipped:
        log(f"{label}: scene {b} differs by {pos[b]:.4g} m / {ang[b]:.4g} "
            f"rad, past {tol_m} m / {tol_rad} rad: a planner decision that "
            f"flipped on float error; held at 0.5 m / 5 degrees")
    if (pos >= 0.5).any() or (ang >= np.radians(5.0)).any():
        raise AssertionError(f"{label}: planner futures differ by "
                             f"{pos.max():.4g} m / {ang.max():.4g} rad")
    return {"max_m": float(pos.max()), "max_rad": float(ang.max()),
            "flipped_scenes": flipped}


# the others' poses of one planner call in adv_closed_b4, a map (4 scenes
# on the four maps x 31 plan times x 15 agents = 1,860): K6's cell record
CELL_MATCH_POSES = 465


def match_launches_per_call(cfg):
    """K6 runs in one device-planner call of the closed loop (FT steps of
    ``bench_closed_loop.DT``, planner config ``cfg``): one for the other
    agents, batched over every plan time, and one an ego plan step."""
    from strive_tpu_torch.scripts.bench_closed_loop import DT

    return 1 + int(round(DT * FT / cfg.dt)) + 1


def plain_reps(x, y, h, mid, tab, cfg, MC):
    """K6's plain version: ``_cluster_reps`` of ``_match_edges``."""
    from strive_tpu_torch.planners import device_planner as dp

    return dp._cluster_reps(*dp._match_edges(x, y, h, mid, tab, cfg),
                            cfg._replace(MC=MC))


def same_reps(got, want, where):
    """Raise unless K6's (reps, rep_valid) equal the plain version's."""
    for g, w, name in zip(got, want, ("reps", "rep_valid")):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{where}: K6 {name} {g.dtype} {g.shape}, "
                                 f"plain {w.dtype} {w.shape}")
        bad = (g != w).reshape(g.shape[0], -1).any(1)
        if bool(bad.any()):
            raise AssertionError(f"{where}: K6 {name} differs from its plain "
                                 f"version at {int(bad.sum())} poses")


def lane_match_work(np, tab, mid, MC):
    """(bytes, float ops, pose-edge pairs) of one K6 call: the edges of the
    maps its poses are on read once, its poses (x, y, cos, sin, map id)
    and the offsets read once, its (N, MC) ids and flags written once; 4
    float ops a pair of a pose and an edge of its own map, the heading test
    every pair needs (the distance follows for the few that pass it)."""
    off = tab.edge_offsets.cpu().numpy()
    n_edges = np.diff(off)
    m = mid.cpu().numpy()
    m = m[(m >= 0) & (m < len(n_edges))]
    pairs = int(n_edges[m].sum())
    N = mid.shape[0]
    nbytes = (int(n_edges[np.unique(m)].sum()) * 20 + off.size * 8
              + N * (4 * 4 + 8) + N * MC * (8 + 1))
    return nbytes, 4 * pairs, pairs


def lane_match_record(torch, np, rates, tab, cfg, x, y, h, mid, MC):
    """K6 on the poses (x, y, h, mid) with ``MC`` rounds: equal to its
    plain version, then its ms (the kernel alone, cos and sin made before)
    beside the plain version's and its bound."""
    from strive_tpu_torch.planners import lane_match as lm
    from strive_tpu_torch.utils.timing import cuda_ms

    c, s = torch.cos(h), torch.sin(h)

    def kernel():
        return lm.lane_match(x, y, c, s, mid, tab.edge_offsets, tab.edges,
                             cfg.cdistmax, cfg.xydistmax, cfg.dedupe_r, MC)

    same_reps(kernel(), plain_reps(x, y, h, mid, tab, cfg, MC), "K6 record")
    nbytes, flops, pairs = lane_match_work(np, tab, mid, MC)
    out = {"poses": int(mid.shape[0]), "MC": MC,
           "edges": int(tab.edges.shape[0]), "own_map_pairs": pairs,
           "ms": cuda_ms(kernel, 200),
           "plain_ms": cuda_ms(lambda: plain_reps(x, y, h, mid, tab, cfg,
                                                  MC), 3)}
    out["bound_ms"], out["bound_by"] = bound_ms(rates, nbytes, flops)
    torch.cuda.empty_cache()  # the plain version's (N, E) temporaries
    return out


def cell_match_case(torch, np, dev):
    """The lane graph of adv_closed_b4 (``benchmark/inputs/lanes.py`` on
    its config's four maps) as device tables, and ``CELL_MATCH_POSES``
    poses a map: three in four within a few metres of a random edge with
    its heading turned by up to ~0.15 rad, the rest anywhere over the
    map's lanes with any heading.

    :return: tables, planner config, (x, y, h, mid) on ``dev``"""
    from benchmark.harness import BENCH, load_json
    from benchmark.inputs import lanes
    from strive_tpu_torch.planners import PLANNER_CONFIGS, PlannerConfig
    from strive_tpu_torch.planners import device_planner as dp

    st = load_json(BENCH / "configs" / "strive_adv_rule_nusc.json")["store"]
    gs = lanes.graphs(st)
    cfg = dp.StaticPlanCfg.from_planner_config(
        PlannerConfig(**PLANNER_CONFIGS["default"]))
    tab = dp.DeviceTables.from_graphs(gs, st["maps"], cfg, dev)
    rng = np.random.default_rng(0)
    n, near = CELL_MATCH_POSES, 3 * CELL_MATCH_POSES // 4
    xs, ys, hs = [], [], []
    for name in st["maps"]:
        e = np.asarray(gs[name]["edges"], np.float64)
        i = rng.integers(0, len(e), near)
        t = rng.uniform(0.0, 1.0, near) * e[i, 4]
        xs += [e[i, 0] + t * e[i, 2] + rng.normal(0, 1.0, near),
               rng.uniform(e[:, 0].min(), e[:, 0].max(), n - near)]
        ys += [e[i, 1] + t * e[i, 3] + rng.normal(0, 1.0, near),
               rng.uniform(e[:, 1].min(), e[:, 1].max(), n - near)]
        hs += [np.arctan2(e[i, 3], e[i, 2]) + rng.normal(0, 0.15, near),
               rng.uniform(-np.pi, np.pi, n - near)]
    x, y, h = (torch.as_tensor(np.concatenate(v), dtype=torch.float32,
                               device=dev) for v in (xs, ys, hs))
    mid = torch.arange(len(st["maps"]), device=dev).repeat_interleave(n)
    return tab, cfg, (x, y, h, mid)


def lane_match_phase(torch, np, rates, card, seen):
    """Phase 6b a's K6 checks and record (module doc): the lane match's
    inputs ``seen`` in the card planner's eager call, (x, y, h, mid, MC)
    a call, in order.

    :return: K6's ``kernels`` entry but its launches"""
    from strive_tpu_torch.planners import device_planner as dp

    cfg, tab = card.cfg, card.tables
    T_all = match_launches_per_call(cfg) - 1
    shapes = [(int(v[0].shape[0]), v[4]) for v in seen]
    want = [(B * T_all * (NA - 1), cfg.MC)] + [(B, 1)] * T_all
    if shapes != want:
        raise AssertionError(f"a. the planner matched {shapes}, expected "
                             f"{want} (N, MC) a call")
    for x, y, h, mid, MC in seen:
        same_reps(dp._match_reps(x, y, h, mid, tab, cfg, MC),
                  plain_reps(x, y, h, mid, tab, cfg, MC), "a. K6")
    x, y, h, mid, MC = seen[0]
    entry = dict(
        name="lane_match", route="cuda",
        source="strive_tpu_torch/csrc/lane_match.cu",
        replaces="no TPU kernel: strive_tpu's planner matches in plain XLA",
        max_abs_err=0.0, cases=len(seen) + 2,
        **lane_match_record(torch, np, rates, tab, cfg, x, y, h, mid, MC),
        library_ms=None,
        library="none: no library call computes a masked closest-first "
                "argmin with spatial dedupe; the plain version is torch's "
                "own elementwise and reduce kernels (plain_ms)")
    ctab, ccfg, (x, y, h, mid) = cell_match_case(torch, np, x.device)
    same_reps(dp._match_reps(x, y, h, mid, ctab, ccfg, 1),
              plain_reps(x, y, h, mid, ctab, ccfg, 1), "a. K6 cell, MC 1")
    entry["cell_shape"] = lane_match_record(torch, np, rates, ctab, ccfg, x,
                                            y, h, mid, ccfg.MC)
    del ctab
    torch.cuda.empty_cache()
    log(f"a. K6 lane_match equal to its plain version on the planner's "
        f"{len(seen)} calls ({shapes[0]} and {T_all} x {shapes[1]}) and at "
        f"the cell's shape; {entry['ms']:.4f} ms (plain "
        f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.5f} ms by "
        f"{entry['bound_by']}); cell shape {entry['cell_shape']}")
    return entry


def closed_loop_phase(torch, np, tm, model, scene, store, norm, counters,
                      rates):
    """Phase 6b: the closed loop (module doc, a-d).

    :return: the ``closed_loop`` JSON line's dict (card excluded), the
        launch counts of a full-width closed-loop run, K6's ``kernels``
        entry but its launches"""
    from strive_tpu_torch.normalize import (att_normalizer_for,
                                            state_normalizer_for)
    from strive_tpu_torch.optim.adv import run_adv_gen_optim
    from strive_tpu_torch.planners import device_planner as dp
    from strive_tpu_torch.scene import SceneBatch
    from strive_tpu_torch.scripts import bench_closed_loop as bcl

    cats = ("car", "truck")
    sn, an = state_normalizer_for(cats), att_normalizer_for(cats)
    lg = bcl.lanegraph(extent_m=STORE_PX / 4.0)
    names = store.map_names

    def device_planner(sc, lg, device):
        return bcl.device_planner(sc, lg, names, sn, an, device)
    out = {"B": B, "NA": NA, "FT": FT, "iters": CL_ITERS,
           "lanegraph": f"synthetic_lanegraph(extent_m={STORE_PX / 4.0}, "
                        "spacing_m=64.0) on both maps",
           "planner_refresh_every": 1}

    # --- a. the scenes' own futures through the planners -----------------
    card = device_planner(scene, lg, "cuda")
    scene_cpu = SceneBatch(**{k: None if v is None else v.cpu()
                              for k, v in vars(scene).items()})
    cpu = device_planner(scene_cpu, lg, "cpu")
    host_fn = bcl.host_planner_fn(scene, lg, names, sn, an)
    card_fn, cpu_fn = (p.make_fn(sn, bcl.DT, FT) for p in (card, cpu))
    fut = scene.future_gt[..., :4]
    # the first call runs eagerly: K6's inputs recorded on the way
    seen, match_reps = [], dp._match_reps

    def recording(x, y, h, mid, tab, cfg, MC):
        seen.append((x.clone(), y.clone(), h.clone(), mid.clone(), MC))
        return match_reps(x, y, h, mid, tab, cfg, MC)

    dp._match_reps = recording
    try:
        on_card = card_fn(fut)
    finally:
        dp._match_reps = match_reps
    if on_card.device.type != "cuda":
        raise AssertionError("the device planner ran off the card")
    out["card_vs_host"] = compare_futures(
        np, sn, on_card, host_fn(fut), 0.5, np.radians(5.0),
        "a. device planner on the card vs the host planner")
    out["card_vs_cpu"] = compare_futures(
        np, sn, on_card, cpu_fn(fut.cpu()), 1e-3, 1e-3,
        "a. device planner on the card vs on the CPU")
    log(f"a. planners on the scenes' futures: card vs host "
        f"{out['card_vs_host']}, card vs CPU {out['card_vs_cpu']}")
    replays = dp.COUNTS["replays"]
    for i in (2, 3):  # the graph captured and replayed, then replayed
        if not torch.equal(card_fn(fut), on_card):
            raise AssertionError(f"a. the card planner's call {i} (a replay "
                                 "of its CUDA graph) differs from its first")
    out["card_replays_equal"] = dp.COUNTS["replays"] - replays
    if out["card_replays_equal"] != 2:
        raise AssertionError(f"a. {out['card_replays_equal']} of the card "
                             "planner's calls 2-3 replayed, expected 2")
    log("a. the card planner's calls 2-3, replays of its CUDA graph, equal "
        "its first bit for bit")
    k6 = lane_match_phase(torch, np, rates, card, seen)

    # --- b. a small closed loop, card against CPU -------------------------
    small_lg = bcl.lanegraph(extent_m=64.0, spacing_m=16.0)
    runs = []
    for d in ("cpu", "cuda"):
        m, st, sc, emb = small_setup(torch, tm, norm, d)
        fn = device_planner(sc, small_lg, d).make_fn(sn, bcl.DT, 3)
        res = run_optim(run_adv_gen_optim, m, sc, st, emb, 3,
                        planner_rollout_fn=fn)
        runs.append([t.cpu() for t in (res[0], res[4], res[1][:, 0])])
    try:
        torch.testing.assert_close(runs[1][1], runs[0][1], rtol=1e-3, atol=0)
        torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=1e-4)
    except AssertionError:
        compare_futures(np, sn, runs[1][2], runs[0][2], 1e-3, 1e-3,
                        "b. small closed loop, card vs CPU, final planner")
        raise
    log("b. small closed loop (3 iterations, device planner): card agrees "
        "with the CPU")

    # --- c, d. the full-width closed loop on each backend -----------------
    launches = None
    for backend, fn in (("host", host_fn), ("device", card_fn)):
        zero(counters)
        planned = dict(dp.COUNTS)
        with torch.no_grad():
            emb = model.embed(scene, store)
        z, result, _, _, losses, _ = run_optim(
            run_adv_gen_optim, model, scene, store, emb, CL_ITERS,
            planner_rollout_fn=fn)
        torch.cuda.synchronize()
        got = counted(counters)
        calls, replays = (dp.COUNTS[k] - planned[k]
                          for k in ("calls", "replays"))
        # a's calls captured the graph at these shapes: every call replays
        if backend == "device" and not 0 < replays == calls:
            raise AssertionError(f"device closed loop: {replays} of "
                                 f"{calls} planner calls replayed its graph")
        expected = {k: 0 for k in got}
        expected.update({"map_crop": 1 + FT * CL_ITERS + FT,
                         "footprint_coll_point": CL_ITERS + 1})
        if backend == "device":  # replays count the launches they run
            expected["lane_match"] = calls * match_launches_per_call(
                card.cfg)
        if got != expected:
            raise AssertionError(f"{backend} closed loop: launches {got}, "
                                 f"expected {expected}")
        launches = got
        if (losses.shape != (CL_ITERS,)
                or not bool(torch.isfinite(losses).all())):
            raise AssertionError(f"{backend} closed loop: losses {losses}")
        if result.shape != (B, NA, FT, 4) \
                or not bool(torch.isfinite(result).all()) \
                or not bool(torch.isfinite(z).all()):
            raise AssertionError(f"{backend} closed loop: result not finite")
        out[backend] = {"losses_first_last": [float(losses[0]),
                                              float(losses[-1])],
                        "planner_calls": calls, "planner_replays": replays}
        log(f"{backend} closed loop: {CL_ITERS} iterations, losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches {got}")
    return out, launches, k6


PIPE_CFG = "configs/adv_gen_synth_hc_prod.cfg"  # the full-width pipeline
# strive_tpu's trained prior of that config (its ckpt line names the orbax
# store), converted by convert_orbax_ckpt.py
PIPE_CKPT = "out/train_synth_prod_torch/checkpoints/latest_model"
# the config's 48 candidates, cut to the first 18 of the val split, in one
# batch of 8 in place of the config's two of 4: an iteration is host-bound
# and takes about as long for 8 scenes as for 4, and scenes 10 and 17 of
# this batch are this prior's first adversarial successes on an H100, so
# the solution stage runs inside the pipeline
PIPE_SCENES, PIPE_BATCH = 18, 8
SOL_ITERS = 20  # 9d's solution run at full width
PARITY_CFG = "configs/adv_gen_synthetic.cfg"  # b: card against CPU
# b's bounds on the optimized trajectories (m) and latents. Not 1e-2 /
# 1e-3: the 75-iteration fit amplifies float noise (ROADMAP §3). Measured
# on this config between two float orders: the port against strive_tpu on
# the CPU 0.17 m / 0.55 (tests/test_torch_adv_scenario_gen.py), the card
# against the CPU 0.092 m / 0.157 (PERF.md, the pipeline findings), with
# the weights of ``torch_default_init``: the amplification depends on the
# weights, and Flax's distributions took the card to 0.64 m / 0.90
PARITY_TRAJ_M, PARITY_LATENT = 0.2, 0.6
SCHEMA = {"N", "dt", "map", "lw", "sem", "past", "fut_init", "fut_adv",
          "fut_internal_ego", "attack_agt", "attack_t", "z_adv", "z_prior"}
SOLVED_KEYS = {"fut_sol", "z_sol"}  # in adv_sol_success and sol_failed
FOLDERS = ("adv_sol_success", "sol_failed", "adv_failed")


def torch_default_init(model):
    """torch's default initializers (``reset_parameters``) seeded 0 on the
    CPU: b's weights, in place of the entry point's ``init_params``."""
    import torch

    torch.manual_seed(0)
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters()


def quiet(fn, *args, **kw):
    """``fn`` with its log lines (stdout) sent to stderr."""
    import contextlib

    with contextlib.redirect_stdout(sys.stderr):
        return fn(*args, **kw)


def read_jsons(np, path, schema):
    """{file: json dict} of the folder ``path`` (none where it is
    missing); raises unless every file has ``schema``'s keys, key for key,
    and finite numbers."""
    res = {}
    for name in sorted(os.listdir(path)) if os.path.isdir(path) else []:
        with open(os.path.join(path, name)) as f:
            js = json.load(f)
        if set(js) != schema:
            raise AssertionError(f"{path}/{name}: keys {sorted(js)}")
        for k in schema - {"map"}:
            v = js[k]
            vals = [v["mean"], v["var"]] if k == "z_prior" else [v]
            if not all(np.isfinite(np.asarray(x, float)).all()
                       for x in vals):
                raise AssertionError(f"{path}/{name}: {k} not finite")
        res[name] = js
    return res


def scenario_jsons(np, out):
    """{folder: {file: json dict}} of a run; raises unless every file has
    the JAX package's schema, key for key, and finite numbers, and the
    port's ``read_adv_scenes`` reads every folder back."""
    from strive_tpu_torch.data.scenario_json import read_adv_scenes

    res = {}
    for d in FOLDERS:
        path = os.path.join(out, "scenario_results", d)
        res[d] = read_jsons(np, path, SCHEMA | (
            SOLVED_KEYS if d != "adv_failed" else set()))
        if res[d] and len(read_adv_scenes(path)) != len(res[d]):
            raise AssertionError(f"read_adv_scenes read {path} short")
    return res


def pipeline_parity(np, card_out, cpu_out, card_stats, cpu_stats,
                    bounds=(PARITY_TRAJ_M, PARITY_LATENT), where="b"):
    """b: the same run on the card and on the CPU (14b: in two ranks and in
    one process): equal stats, folders, attackers and attack steps;
    :return: the largest trajectory (m) and latent differences, held at
    ``bounds``."""
    if card_stats != cpu_stats:
        raise AssertionError(f"{where}. stats: {card_stats} against "
                             f"{cpu_stats}")
    a, b = scenario_jsons(np, card_out), scenario_jsons(np, cpu_out)
    worst = {"traj_m": 0.0, "latent": 0.0, "scenes": 0}
    for d in FOLDERS:
        if sorted(a[d]) != sorted(b[d]):
            raise AssertionError(f"{d}: card {sorted(a[d])}, CPU "
                                 f"{sorted(b[d])}")
        for name, x in a[d].items():
            y = b[d][name]
            if (x["attack_agt"], x["attack_t"]) != (y["attack_agt"],
                                                    y["attack_t"]):
                raise AssertionError(f"{d}/{name}: attack differs")
            worst["scenes"] += 1
            for k in x:
                if k.startswith("fut_") or k in ("z_adv", "z_sol"):
                    diff = float(np.abs(np.asarray(x[k])
                                        - np.asarray(y[k])).max())
                    key = "latent" if k.startswith("z_") else "traj_m"
                    worst[key] = max(worst[key], diff)
    if not worst["scenes"]:
        raise AssertionError(f"{where}. no scene was saved")
    if worst["traj_m"] > bounds[0] or worst["latent"] > bounds[1]:
        raise AssertionError(f"{where}. differences {worst} over {bounds}")
    return worst


# the configs' sol_* weights (configs/adv_gen_*.cfg)
SOL_WEIGHTS = {"coll_veh": 10.0, "coll_env": 10.0, "motion_prior": 0.005,
               "init_z": 0.0, "motion_prior_ext": 0.001, "match_ext": 10.0}
SOL_FT = 16  # the configs' sol_future_len


def solution_stage(torch, tm, model, scene, store, norm, counters):
    """Phase 9d: the solution optimization, which random weights never
    reach through the pipeline (no adversarial success): 3 iterations of
    phase 5's small run on the card against the CPU, then SOL_ITERS
    iterations at full width on the main path's model, scenes and store,
    with the scenes' futures as the adversarial result.

    :return: the ``pipeline`` line's ``d_solution`` dict"""
    from strive_tpu_torch.optim.sol import (compute_sol_success,
                                            run_find_solution_optim)
    from strive_tpu_torch.normalize import (att_normalizer_for,
                                            state_normalizer_for)

    runs = []
    for d in ("cpu", "cuda"):
        m, st, sc, emb = small_setup(torch, tm, norm, d)
        pri = emb["prior_out"]
        out = run_find_solution_optim(m, pri[0], sc.future_gt[..., :4],
                                      SMALL_KW["FT"] + 2, 0.05, SOL_WEIGHTS,
                                      sc, st, 3, emb, pri, pri)
        runs.append([t.cpu() for t in out])
    torch.testing.assert_close(runs[1][2], runs[0][2], rtol=1e-3, atol=0)
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=1e-4)

    with torch.no_grad():
        emb = model.embed(scene, store)
    pri = emb["prior_out"]
    final = scene.future_gt[..., :4]
    zero(counters)
    z, sol, losses = run_find_solution_optim(
        model, pri[0], final, SOL_FT, 0.05, SOL_WEIGHTS, scene, store,
        SOL_ITERS, emb, pri, pri)
    torch.cuda.synchronize()
    launches = counted(counters)
    expected = dict.fromkeys(launches, 0)
    expected.update(map_crop=SOL_ITERS * SOL_FT + FT,
                    footprint_coll_point=SOL_ITERS)
    if launches != expected:
        raise AssertionError(f"d. launches {launches}, expected {expected}")
    if not (bool(torch.isfinite(losses).all())
            and bool(torch.isfinite(sol).all())
            and bool(torch.isfinite(z).all())):
        raise AssertionError("d. solution not finite")
    if not torch.equal(sol[:, 1:], final[:, 1:]):
        raise AssertionError("d. non-ego rows differ from the input")
    cats = ("car", "truck")
    solved = [compute_sol_success(sol[b], scene.take([b]), store,
                                  state_normalizer_for(cats),
                                  att_normalizer_for(cats))
              for b in range(scene.B)]
    out = {"B": scene.B, "NA": scene.NA, "sol_future_len": SOL_FT,
           "iters": SOL_ITERS, "final_loss": float(losses[-1]),
           "solved": solved,
           "launches": {k: launches[k] for k in ("map_crop",
                                                 "footprint_coll_point")},
           "small_card_vs_cpu": "loss rtol 1e-3, latents atol 1e-4"}
    log(f"d. solution optimization at full width: {out}")
    return out


def pipeline_launches(gen, pc, calls):
    """{kernel: launches} of K1 and K2 in an ``adv_scenario_gen`` run of
    config ``pc``, worked out from the stages it ran (``calls``)."""
    FT, it = pc.future_len, pc.num_iters
    n = {k: calls.get(k, 0) for k in ("sample", "init_fit", "planner_refit",
                                      "adversarial", "solution")}
    return {"map_crop": n["sample"] * (1 + FT)
            + n["init_fit"] * (1 + (gen.INIT_FIT_ITERS + 1) * FT)
            + n["planner_refit"] * (gen.PLANNER_REFIT_ITERS + 1) * FT
            + n["adversarial"] * (it + 1) * FT
            + n["solution"] * (it * pc.sol_future_len + FT),
            "footprint_coll_point": n["adversarial"] * (it + 1)
            + n["solution"] * it}


def pipeline_phase(torch, np, rates, card, counters, kernels):
    """Phase 9: the scenario-generation pipeline on the card (module doc).

    :return: the ``pipeline`` JSON line's dict"""
    from strive_tpu_torch import kernel_cases as kc
    from strive_tpu_torch.maps import crop_kernel
    from strive_tpu_torch.scripts import adv_scenario_gen as gen

    dev = torch.device("cuda")
    line = {"pipeline": PIPE_CFG, "card": card}

    # --- a. K1 and K2 at the pipeline's new shapes -------------------------
    k1_args = kc.sampling_crop_args(dev)  # NHWC, held in hold_shapes
    check_crop(torch, crop_kernel, (*k1_args[:-1], "nchw"), torch.float32,
               "9a")
    hold_shapes(torch, rates, kernels, [
        ("map_crop", "pipeline_shape", "sampling: 1 scene x 20 samples x 16 "
         "agents = 320 poses, 256 px", k1_args),
        ("footprint_coll_point", "pipeline_shape", "solution loss: 1 car a "
         "scene x B=4 x 48 interpolated poses = 192 cars",
         kc.solution_k2(dev)[1])], "9a")

    # --- b. the entry point, card against CPU ------------------------------
    build_dir = os.path.join(ROOT, "build", "chip_smoke")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # one result a run on the card
    init_params, gen.init_params = gen.init_params, torch_default_init
    runs = {}
    try:
        for d in ("cuda", "cpu"):
            out = os.path.join(build_dir, f"parity_{d}")
            stats = quiet(gen.main, ["-c", os.path.join(ROOT, PARITY_CFG),
                                     "--num_iters", "3", "--synth_scenes",
                                     "4", "--max_scenes", "4", "--device", d,
                                     "--out", out])
            runs[d] = (out, stats)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        gen.init_params = init_params
    line["b_card_vs_cpu"] = pipeline_parity(np, runs["cuda"][0],
                                            runs["cpu"][0], runs["cuda"][1],
                                            runs["cpu"][1])
    line["b_stats"] = runs["cuda"][1]
    log(f"b. {PARITY_CFG}, 3 iterations: card and CPU agree on stats "
        f"{runs['cuda'][1]}, folders and attacks; largest differences "
        f"{line['b_card_vs_cpu']}")

    # --- c. the full-width pipeline on the trained prior --------------------
    out = os.path.join(build_dir, "full_width")
    argv = ["-c", os.path.join(ROOT, PIPE_CFG), "--ckpt",
            os.path.join(ROOT, PIPE_CKPT), "--max_scenes", str(PIPE_SCENES),
            "--batch_size", str(PIPE_BATCH), "--device", "cuda", "--out",
            out]
    pc = gen.parse_cfg(argv)
    timings = {}
    zero(counters)
    stats = quiet(gen.main, argv, timings, max_batches=1)
    launches = counted(counters)
    calls = timings["calls"]
    expected = dict.fromkeys(launches, 0)
    expected.update(pipeline_launches(gen, pc, calls))
    if launches != expected:
        raise AssertionError(f"c. launches {launches}, expected {expected} "
                             f"from the stages {calls}")
    losses = timings["final_loss"]
    if not losses or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"c. final losses {losses}")
    jsons = scenario_jsons(np, out)
    n_json = sum(len(v) for v in jsons.values())
    if not calls.get("adversarial") or n_json != sum(
            b for _, b, _ in timings["batches"]):
        raise AssertionError(f"c. {n_json} scenario files for batches "
                             f"{timings['batches']}")
    if bool(stats["adv_success"]) != bool(calls.get("solution")):
        raise AssertionError(f"c. {stats['adv_success']} adversarial "
                             f"successes, {calls.get('solution', 0)} "
                             "solution runs")
    for name in ("map_crop", "footprint_coll_point"):
        kernels[name]["pipeline_launches"] = launches[name]
    batches = [{"scenes": b, "adv_success": a}
               for _, b, a in timings["batches"]]
    line.update({
        "config": f"{PIPE_CFG} with --ckpt {PIPE_CKPT}",
        "reduced": {"candidates": f"48 -> the first {PIPE_SCENES} of the "
                                  "val split",
                    "batch_size": f"4 -> {PIPE_BATCH}: one batch"},
        "B": pc.batch_size, "NA": pc.max_agents, "FT": pc.future_len,
        "sol_future_len": pc.sol_future_len, "num_samples": pc.num_samples,
        "num_iters": pc.num_iters, "stats": stats,
        "candidates": stats["candidates"], "feasible": stats["feasible"],
        "adv_success": stats["adv_success"],
        "sol_success": stats["sol_success"], "batches": batches,
        "stage_calls": calls, "final_loss": losses,
        "launches": {k: launches[k] for k in ("map_crop",
                                              "footprint_coll_point")},
    })
    log(f"c. full-width pipeline: {stats}, batches {batches}, stages {calls}, "
        f"launches {line['launches']} as worked out, JSONs read back "
        f"({n_json})")
    return line


# phase 14's bounds, tests/test_torch_distributed.py's: each leaf's gradient
# within 1e-5 of its norm or of the one-process step's own float noise
# there (its gradient against the same batch's with the rows reversed),
# the losses within 1e-6 (relative), compute_err's metrics at rtol 1e-4 /
# atol 1e-5 (ang_err atol 1e-3 deg), the parameters after the step within
# 1e-6 where |g| >= 1e-6 (within 2 lr elsewhere: Adam's first step there
# is noise), the pipeline's trajectories and latents within 9b's
# PARITY_TRAJ_M / PARITY_LATENT (two ranks on an H100 against one
# process: 0.185 m / 0.206, a rank's smaller batch rounded otherwise and
# amplified by the fits, ROADMAP §3)
MGPU_GRAD_REL, MGPU_LOSS_REL = 1e-5, 1e-6
MGPU_TRAJ_M, MGPU_LATENT = PARITY_TRAJ_M, PARITY_LATENT
MGPU_ERR_TOL = {"pos_err": (1e-4, 1e-5), "ang_err": (1e-4, 1e-3),
                "z_logprob": (1e-4, 1e-5), "z_mdist": (1e-4, 1e-5)}


def multi_gpu_train_step(reverse=False):
    """Phase 14: one ``Trainer`` step of phase 5's small model (2 scenes of
    2-4 agents; cuDNN deterministic, TF32 off) on the card, in a rank of
    ``mesh.launch`` (its rows of the batch) or, outside a process group,
    in this process (``reverse``: the batch's rows in reverse order).

    :return: (gradients, metrics, flat parameters after the step, whether
        every rank holds the same parameters), on the CPU"""
    import torch
    import torch.distributed as dist
    from strive_tpu_torch.model import traffic_model as tm
    from strive_tpu_torch.normalize import (att_normalizer_for,
                                            state_normalizer_for)
    from strive_tpu_torch.parallel import mesh
    from strive_tpu_torch.train import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = mesh.rank_device() if dist.is_initialized() else torch.device(DEV)
    cats = ("car", "truck")
    sn, an = state_normalizer_for(cats), att_normalizer_for(cats)
    m, st, sc, _ = small_setup(torch, tm, tm.NormConfig.from_normalizers(
        sn, an), dev)
    trainer = Trainer(m, TRAIN_W, sn, an, lr=1e-4)
    eps, eps_samp = trainer.draw_noise(sc)
    if reverse:
        sc, eps, eps_samp = sc.take([1, 0]), eps[[1, 0]], eps_samp[[1, 0]]
    grads, metrics = trainer.gradients(sc, st, 0.002, eps, eps_samp)
    trainer.train_step(sc, st, 0.002, eps, eps_samp)
    flat = torch.cat([p.detach().reshape(-1) for p in m.parameters()])
    same = bool((mesh.gather_rows(flat[None]) == flat).all())
    return ([g.cpu() for g in grads], {k: float(v) for k, v in
                                       metrics.items()}, flat.cpu(), same)


def multi_gpu_pipeline(argv):
    """Phase 14b: 9b's small entry-point run (``torch_default_init``'s
    weights, cuDNN deterministic, TF32 off) in this process, or in a rank
    of ``mesh.launch``: :return: the stats"""
    import torch
    import torch.distributed as dist
    from strive_tpu_torch.parallel import mesh
    from strive_tpu_torch.scripts import adv_scenario_gen as gen

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    real = gen.init_params
    gen.init_params = torch_default_init
    try:
        return quiet(gen.run, gen.parse_cfg(argv), mesh.rank_device()
                     if dist.is_initialized() else torch.device(DEV))
    finally:
        gen.init_params = real


def same_step(torch, got, want, noise, where):
    """A step of ``multi_gpu_train_step`` against the one-process step at
    phase 14's bounds; :return: the largest differences"""
    (g, m, p, same), (g1, m1, p1, _) = got, want
    if not same:
        raise AssertionError(f"{where}: the ranks' parameters differ")
    worst = {"grad_rel": 0.0, "loss_rel": 0.0, "params": 0.0}
    for i, (a, b) in enumerate(zip(g, g1)):
        err = float((a - b).abs().max())
        if err > max(MGPU_GRAD_REL * float(b.norm()), float(noise[i])):
            raise AssertionError(f"{where}: gradient leaf {i} {err:.3g} "
                                 f"apart (norm {float(b.norm()):.3g}, "
                                 f"noise {float(noise[i]):.3g})")
        worst["grad_rel"] = max(worst["grad_rel"], err / float(b.norm()))
    if sorted(m) != sorted(m1):
        raise AssertionError(f"{where}: metrics {sorted(m)}")
    for k, want_k in m1.items():
        rtol, atol = MGPU_ERR_TOL.get(k, (MGPU_LOSS_REL, 0.0))
        if abs(m[k] - want_k) > atol + rtol * abs(want_k):
            raise AssertionError(f"{where}: {k} {m[k]} against {want_k}")
        if k not in MGPU_ERR_TOL:
            worst["loss_rel"] = max(worst["loss_rel"], abs(m[k] - want_k)
                                    / max(abs(want_k), 1e-30))
    steady = torch.cat([x.reshape(-1) for x in g1]).abs() >= 1e-6
    diff = (p - p1).abs()
    worst["params"] = float(diff[steady].max())
    if worst["params"] > 1e-6 or float(diff.max()) > 2 * 1e-4:
        raise AssertionError(f"{where}: parameters {worst['params']} apart")
    return worst


def multi_gpu_phase(torch, np, rates, card, kernels):
    """Phase 14: ``parallel/mesh.py`` on the one card (module doc).

    :return: the ``multi_gpu`` JSON line's dict"""
    from strive_tpu_torch import kernel_cases as kc
    from strive_tpu_torch.parallel import mesh

    line = {"multi_gpu": "parallel/mesh.py on one card", "card": card,
            "scaling": "not measured: the machine has one card"}
    one = multi_gpu_train_step()
    rev = multi_gpu_train_step(reverse=True)
    noise = [(a - b).abs().max() for a, b in zip(rev[0], one[0])]
    nccl = quiet(mesh.launch, multi_gpu_train_step, (), ["cuda:0"], "nccl")
    line["a_nccl_1_rank_step"] = same_step(torch, nccl, one, noise, "14a")
    log("14a. a train step through NCCL at 1 rank: "
        f"{line['a_nccl_1_rank_step']}")
    gloo = quiet(mesh.launch, multi_gpu_train_step, (), ["cuda:0"] * 2,
                 "gloo")
    line["b_gloo_2_ranks_step"] = same_step(torch, gloo, one, noise, "14b")
    log(f"14b. a train step through gloo at 2 ranks on cuda:0: "
        f"{line['b_gloo_2_ranks_step']}")
    build_dir = os.path.join(ROOT, "build", "chip_smoke")
    runs = {}
    for n in (1, 2):
        out = os.path.join(build_dir, f"multi_gpu_{n}")
        argv = ["-c", os.path.join(ROOT, PARITY_CFG), "--num_iters", "3",
                "--synth_scenes", "6", "--max_scenes", "6", "--batch_size",
                "3", "--device", "cuda", "--out", out]
        stats = (multi_gpu_pipeline(argv) if n == 1 else quiet(
            mesh.launch, multi_gpu_pipeline, (argv,), ["cuda:0"] * 2,
            "gloo"))
        runs[n] = out, stats
    line["b_gloo_2_ranks_pipeline"] = pipeline_parity(
        np, runs[2][0], runs[1][0], runs[2][1], runs[1][1],
        bounds=(MGPU_TRAJ_M, MGPU_LATENT), where="14b")
    line["b_pipeline_stats"] = runs[1][1]
    log(f"14b. {PARITY_CFG} --batch_size 3 through gloo at 2 ranks on "
        f"cuda:0 against one process: stats {runs[1][1]}, largest "
        f"differences {line['b_gloo_2_ranks_pipeline']}")
    # a rank's launch shapes at PIPE_CFG's B=4 over 4 ranks (over 2 they
    # are the main path's: 32 poses, 1,152 cars)
    k1, k2 = kc.shard_args(torch.device("cuda"), 4)
    hold_shapes(torch, rates, kernels, [
        ("map_crop", "shard_shape", "a decode step of one rank of 4 at "
         "B=4: 1 scene x 16 agents = 16 poses, 256 px", k1),
        ("footprint_coll_point", "shard_shape", "the adversarial loss of "
         "one rank of 4 at B=4: 1 scene x 16 agents x 36 interpolated "
         "poses = 576 cars", k2)], "14c")
    return line


DEV = "cuda"  # phases 10 and 11 run on this device
REFINE_CFG = "configs/refine_traffic_optim.cfg"  # phase 10c's widths
REFINE_W = {"coll_veh": 100.0, "coll_env": 100.0, "init_z": 0.01,
            "motion_prior": 1.0}  # the config's loss weights
# the synthetic test split's first 17 scenes hold 10 with at least
# feasibility_num = 10 agents, the last of them among those: one batch of 10
REFINE_SCENES = 17
REFINE_ITERS = {"adam": 20, "lbfgs": 5}  # the config's 200 (Adam), cut
TRAIN_CFG = "configs/train_synth_prod.cfg"  # phase 11b's widths
TRAIN_SCENES = 40  # a split: 5 batches of 8 (the config's 96, cut)
TEST_CFG = "configs/test_synth_prod.cfg"  # phase 11c's flags
TEST_SCENES = 16  # 2 batches of 8 (the config's 96, cut)
TRAIN_W = {"recon": 1.0, "kl": 0.004, "coll_veh_prior": 0.05,
           "coll_env_prior": 0.1}  # the trainer's defaults
# 11a's bound on each leaf's gradient, card against CPU, as
# |g_card - g_cpu| / |g_cpu| over the leaf: float-order noise, 2.4e-6 at
# most between two CPU thread counts and 4.3e-6 card against CPU (H100),
# while a dropped term or a wrong scale moves a leaf by far more
TRAIN_GRAD_RTOL = 1e-4
# 10b's bound on the latents, card against CPU. Not phase 5's 1e-4: the
# first L-BFGS linesearch of this run doubles its stepsize to the 20-step
# cap on both devices (21 loss evaluations each: the same branches), and
# the step that far out carries the float noise of the direction with it.
# Measured on an H100: L-BFGS 2.4e-4 after 2 iterations, Adam 6.9e-7
SMALL_REFINE_Z = 1e-3
REFINE_SCHEMA = {"N", "dt", "map", "lw", "sem", "past", "fut_init",
                 "fut_adv", "z_adv", "z_prior"}


def cfg_copy(src, drop, name):
    """A copy of config ``src`` under build/chip_smoke without the lines
    whose keys are in ``drop``; :return: its path."""
    build_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(ROOT, src)) as f:
        lines = [l for l in f if l.split(":")[0].strip() not in drop]
    path = os.path.join(build_dir, name)
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def new_shapes(torch, rates, kernels):
    """10a: the records of K1 at a decode step of training (B=8) and
    refine (B=10), and of K2 at the refine loss's and the training loss's
    shapes, where the card tests hold them."""
    from strive_tpu_torch import kernel_cases as kc

    dev = torch.device("cuda")
    shapes = [
        ("map_crop", "training_shape", "a decode step of training: B=8 x "
         "16 agents = 128 poses, 256 px", kc.decode_crop_args(dev, 8)),
        ("map_crop", "refine_shape", "a decode step of refine: B=10 x 16 "
         "agents = 160 poses, 256 px", kc.decode_crop_args(dev, 10)),
        ("footprint_coll_point", "refine_shape", "the refine loss: B=10 x "
         "16 agents x 48 interpolated poses = 7680 cars",
         kc.refine_k2(dev)[1]),
        ("footprint_coll_point", "training_shape", "the training loss's "
         "ego prior: B=8 x 12 poses = 96 cars", kc.training_k2(dev)[1]),
    ]
    hold_shapes(torch, rates, kernels, shapes, "10a")


def hold_shapes(torch, rates, kernels, shapes, where):
    """K1 and K2 at ``shapes`` [(kernel, key, what, args)], each against
    its plain version (K1 bit-exact, also in bf16; K2 valid/frac exact,
    coll_pt within 2e-6 x the largest coordinate), timed beside it and its
    bound: ``kernels[kernel][key]``."""
    from strive_tpu_torch import kernel_cases as kc
    from strive_tpu_torch.maps import crop_kernel, queries
    from strive_tpu_torch.utils.timing import cuda_ms

    for name, key, what, args in shapes:
        kern = getattr(crop_kernel, name)
        plain = getattr(crop_kernel, f"{name}_plain")
        if name == "map_crop":
            err = check_crop(torch, crop_kernel, args, torch.float32, where)
            work = crop_work
        else:
            err = kc.coll_point_error(args)
            work = footprint_work
        entry = {"shape": what, "max_abs_err": err,
                 "ms": cuda_ms(lambda: kern(*args), 200),
                 "plain_ms": cuda_ms(lambda: plain(*args), 10)}
        entry["bound_ms"], entry["bound_by"] = bound_ms(
            rates, *work(torch, queries, args))
        if name == "map_crop":
            entry.update(bf16_crop_entry(torch, crop_kernel, queries,
                                         cuda_ms, rates, args, where))
        kernels[name][key] = entry
        log(f"{where}. {name} at {what}: {entry}")
        torch.cuda.empty_cache()


def refine_phase(torch, np, tm, norm, rates, card, counters, kernels):
    """Phase 10: refine on the card (module doc).

    :return: the ``refine`` JSON line's dict"""
    from strive_tpu_torch.optim import refine
    from strive_tpu_torch.scripts import refine_traffic_optim as rto

    line = {"refine": REFINE_CFG, "card": card}
    new_shapes(torch, rates, kernels)

    # --- b. phase 5's small run, card against CPU -------------------------
    small = {}
    real_loss = refine.avoid_coll_loss
    evals = []

    def counting_loss(*a, **k):  # one a value-and-gradient evaluation
        evals[-1] += 1
        return real_loss(*a, **k)

    refine.avoid_coll_loss = counting_loss
    try:
        for opt, iters in (("adam", 3), ("lbfgs", 2)):
            runs = []
            for d in ("cpu", DEV):
                m, st, sc, emb = small_setup(torch, tm, norm, d)
                pri = emb["prior_out"]
                evals.append(0)
                out = refine.run_refine_optim(
                    m, pri[0], 0.05, REFINE_W, sc, st, iters, emb, pri,
                    samp_future_len=SMALL_KW["FT"] + 2,
                    save_future_len=SMALL_KW["FT"], optimizer=opt)
                runs.append([t.cpu() for t in out])
            small[opt] = {
                "iters": iters, "evaluations_cpu_card": evals[-2:],
                "loss_max_rel": float(((runs[1][2] - runs[0][2]).abs()
                                       / runs[0][2].abs()).max()),
                "latent_max_abs": float((runs[1][0] - runs[0][0]).abs()
                                        .max())}
            if opt == "lbfgs" and bool((runs[1][2].diff() > 0).any()):
                raise AssertionError(f"10b. L-BFGS losses rose: {runs[1][2]}")
    finally:
        refine.avoid_coll_loss = real_loss
    line["b_card_vs_cpu"] = small
    log(f"10b. small refine run, card against CPU: {small}")
    for opt, r in small.items():
        if r["loss_max_rel"] > 1e-3 or r["latent_max_abs"] > SMALL_REFINE_Z:
            raise AssertionError(f"10b. {opt}: card against CPU {r}")

    # --- c. the entry point at the config's widths ------------------------
    cfg = cfg_copy(REFINE_CFG, {"ckpt", "viz"}, "refine_traffic_optim.cfg")
    refine.avoid_coll_loss = counting_loss
    try:
        for opt, iters in REFINE_ITERS.items():
            out = os.path.join(ROOT, "build", "chip_smoke", f"refine_{opt}")
            argv = ["-c", cfg, "--data_version", "synthetic", "--max_agents",
                    "16", "--synth_scenes", str(REFINE_SCENES),
                    "--max_scenes", str(REFINE_SCENES), "--num_iters",
                    str(iters), "--device", DEV, "--out", out]
            if opt == "lbfgs":
                argv.append("--optim_use_lbfgs")
            pc = rto.parse_cfg(argv)
            timings = {}
            evals.append(0)
            zero(counters)
            stats = quiet(rto.main, argv, timings)
            launches = counted(counters)
            n_batch = len(timings["batches"])
            expected = dict.fromkeys(launches, 0)
            expected["map_crop"] = n_batch * (
                2 + pc.samp_future_len + pc.save_future_len) \
                + evals[-1] * pc.samp_future_len
            expected["footprint_coll_point"] = evals[-1]
            if launches != expected:
                raise AssertionError(f"10c. {opt} launches {launches}, "
                                     f"expected {expected}")
            losses = np.concatenate(timings["losses"])
            if not np.isfinite(losses).all() or len(losses) != iters * n_batch:
                raise AssertionError(f"10c. {opt} losses {losses}")
            if opt == "lbfgs" and (np.diff(losses) > 0).any():
                raise AssertionError(f"10c. L-BFGS losses rose: {losses}")
            n_json = sum(len(read_jsons(np, os.path.join(
                out, "scenario_results", d), REFINE_SCHEMA))
                for d in ("success", "failed"))
            if n_json != stats["scenes"] or stats != {
                    "scenes": 10, "success": stats["success"],
                    "failed": 10 - stats["success"], "skipped": 7}:
                raise AssertionError(f"10c. {opt} stats {stats}, {n_json} "
                                     "JSONs")
            line[f"c_{opt}"] = {
                "stats": stats, "iters": iters, "evaluations": evals[-1],
                "losses_first_last": [float(losses[0]), float(losses[-1])],
                "launches": {k: launches[k] for k in ("map_crop",
                                                      "footprint_coll_point")}}
            log(f"10c. refine entry point ({opt}): {line[f'c_{opt}']}")
    finally:
        refine.avoid_coll_loss = real_loss
    line.update({"B": pc.batch_size, "NA": 16, "crop_px": pc.map_obs_size_pix,
                 "samp_future_len": pc.samp_future_len,
                 "config": f"{REFINE_CFG} without its ckpt and viz lines, "
                           "--data_version synthetic --max_agents 16",
                 "reduced": {"num_iters": "200 -> 20 (Adam), 5 (L-BFGS)",
                             "scenes": f"{REFINE_SCENES} synthetic test "
                                       "scenes (10 kept: one batch)",
                             "weights": "random (Flax's distributions, "
                                        "seed 0)"}})
    for name in ("map_crop", "footprint_coll_point"):
        kernels[name]["refine_launches"] = line["c_adam"]["launches"][name]
    return line, cfg


def training_phase(torch, np, tm, norm, card, counters, kernels, refine_cfg):
    """Phase 11: training and evaluation on the card (module doc).

    :return: the ``training`` JSON line's dict"""
    from strive_tpu_torch.normalize import (att_normalizer_for,
                                            state_normalizer_for)
    from strive_tpu_torch.scripts import refine_traffic_optim as rto
    from strive_tpu_torch.scripts import test_traffic as tt
    from strive_tpu_torch.scripts import train_traffic as trt
    from strive_tpu_torch.train import Trainer
    from strive_tpu_torch.viz import have_matplotlib

    line = {"training": TRAIN_CFG, "card": card}
    cats = ("car", "truck")

    # --- a. one train step of phase 5's small model, card against CPU ------
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    lr = 1e-4  # the config's
    try:
        res = []
        for d in ("cpu", DEV):
            m, st, sc, _ = small_setup(torch, tm, norm, d)
            before = {k: v.detach().cpu().clone()
                      for k, v in m.named_parameters()}
            trainer = Trainer(m, TRAIN_W, state_normalizer_for(cats),
                              att_normalizer_for(cats), lr=lr)
            # the step's gradients, from the noise run_epoch then draws
            eps, eps_samp = trainer.draw_noise(sc)
            trainer.generator.manual_seed(0)
            grads, _ = trainer.gradients(sc, st, 0.002, eps, eps_samp)
            grads = {k: g.detach().cpu() for (k, _), g
                     in zip(m.named_parameters(), grads)}
            met, _ = trainer.run_epoch([sc], st, 0.002)
            res.append((met, {k: v.detach().cpu()
                              for k, v in m.named_parameters()}, grads))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (cpu_m, cpu_p, cpu_g), (card_m, card_p, card_g) = res
    rel = abs(card_m["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"])
    if rel > 1e-4:
        raise AssertionError(f"11a. loss card {card_m['loss']}, CPU "
                             f"{cpu_m['loss']}")
    # Adam's first step is about lr * sign(g), blind to a gradient's size:
    # the gradients themselves are held leaf by leaf
    grad_rel = {k: float((card_g[k] - g).norm() / g.norm())
                for k, g in cpu_g.items()}
    worst_leaf = max(grad_rel, key=grad_rel.get)
    if grad_rel[worst_leaf] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"11a. gradient of {worst_leaf} "
                             f"{grad_rel[worst_leaf]:.3g} apart (relative)")
    worst, noise_worst = 0.0, 0.0
    for k, want in cpu_p.items():
        # where the CPU's first Adam step is under 0.99 lr, the gradient was
        # float noise (|g| < 1e-6), and so is the step: held within 2 lr
        noise = (want - before[k]).abs() < 0.99 * lr
        diff = (card_p[k] - want).abs()
        worst = max([worst, *diff[~noise].tolist()])
        noise_worst = max([noise_worst, *diff[noise].tolist()])
    if worst > 1e-5 or noise_worst > 2 * lr:
        raise AssertionError(f"11a. parameters {worst} apart ({noise_worst} "
                             "where the gradient is noise)")
    line["a_card_vs_cpu"] = {"loss_rel": rel, "params_max_abs": worst,
                             "noise_grad_params_max_abs": noise_worst,
                             "grad_rel_max": grad_rel[worst_leaf],
                             "grad_rel_worst_leaf": worst_leaf,
                             "grad_leaves": len(grad_rel)}
    log(f"11a. one train step, card against CPU: {line['a_card_vs_cpu']}")

    # --- b. train_traffic at full width --------------------------------------
    out = os.path.join(ROOT, "build", "chip_smoke", "train")
    argv = ["-c", os.path.join(ROOT, TRAIN_CFG), "--epochs", "1",
            "--synth_scenes", str(TRAIN_SCENES), "--device", DEV,
            "--out", out]
    pc = trt.parse_cfg(argv)
    timings = {}
    torch.cuda.empty_cache()
    zero(counters)
    quiet(trt.main, argv, timings)
    launches = counted(counters)
    n_train = len(timings["train_steps"])
    n_val = -(-TRAIN_SCENES // pc.batch_size)
    steps = n_train + n_val
    expected = dict.fromkeys(launches, 0)
    expected["map_crop"] = steps * (1 + 2 * pc.future_len)
    expected["footprint_coll_point"] = steps
    if launches != expected:
        raise AssertionError(f"11b. launches {launches}, expected {expected}")
    ms = [m_ for m_ in (timings["train"][0], timings["val"][0])]
    if not all(np.isfinite(v) for m_ in ms for v in m_.values()):
        raise AssertionError(f"11b. metrics {ms}")
    ckpt_dir = os.path.join(out, "checkpoints")
    names = sorted(os.listdir(ckpt_dir))
    if names != ["best_eval_model", "epoch_00000000_model", "latest_model"]:
        raise AssertionError(f"11b. checkpoints {names}")
    ckpt = os.path.join(ckpt_dir, "latest_model")
    line["b"] = {
        "B": pc.batch_size, "NA": pc.max_agents, "FT": pc.future_len,
        "crop_px": pc.map_obs_size_pix, "train_steps": n_train,
        "val_steps": n_val, "train": timings["train"][0],
        "val": timings["val"][0], "checkpoints": names,
        "launches": {k: launches[k] for k in ("map_crop",
                                              "footprint_coll_point")},
        "launches_per_step": {"map_crop": 1 + 2 * pc.future_len,
                              "footprint_coll_point": 1},
        "reduced": {"epochs": "400 -> 1",
                    "synth_scenes": f"96 -> {TRAIN_SCENES} a split"}}
    for name, n in line["b"]["launches_per_step"].items():
        kernels[name]["training_launches_per_step"] = n
    log(f"11b. train_traffic at full width: {line['b']}")

    # --- c. test_traffic and refine through --ckpt ------------------------
    viz = have_matplotlib()
    tcfg = cfg_copy(TEST_CFG, {"ckpt"} if viz else {"ckpt",
                                                    "test_sample_viz_multi"},
                    "test_synth_prod.cfg")
    argv = ["-c", tcfg, "--ckpt", ckpt, "--synth_scenes", str(TEST_SCENES),
            "--device", DEV, "--out", os.path.join(ROOT, "build",
                                                  "chip_smoke", "test")]
    tc = tt.parse_cfg(argv)
    zero(counters)
    metrics = quiet(tt.main, argv)
    launches = counted(counters)
    batches = -(-TEST_SCENES // tc.batch_size)
    expected = dict.fromkeys(launches, 0)
    # a batch: the posterior-mean decode, the samples, the reconstruction
    expected["map_crop"] = batches * (2 * (1 + tc.future_len) + 1
                                      + tc.test_sample_future_len)
    if launches != expected:
        raise AssertionError(f"11c. test_traffic launches {launches}, "
                             f"expected {expected}")
    if len(metrics) != 16 or not all(np.isfinite(v)
                                     for v in metrics.values()):
        raise AssertionError(f"11c. test_traffic metrics {metrics}")
    argv = ["-c", refine_cfg, "--data_version", "synthetic", "--max_agents",
            "16", "--synth_scenes", str(REFINE_SCENES), "--max_scenes",
            str(REFINE_SCENES), "--num_iters", "5", "--ckpt", ckpt,
            "--device", DEV, "--out", os.path.join(
                ROOT, "build", "chip_smoke", "refine_ckpt")]
    timings = {}
    stats = quiet(rto.main, argv, timings)
    losses = np.concatenate(timings["losses"])
    if not np.isfinite(losses).all() or stats["scenes"] != 10:
        raise AssertionError(f"11c. refine with --ckpt: {stats}, {losses}")
    line["c"] = {"test_traffic": metrics,
                 "test_launches": {k: launches[k] for k in (
                     "map_crop", "footprint_coll_point")},
                 "test_reduced": {"synth_scenes": f"96 -> {TEST_SCENES}",
                                  "test_sample_viz_multi":
                                      "on" if viz else
                                      "off: no matplotlib on this machine"},
                 "refine_stats": stats,
                 "refine_losses_first_last": [float(losses[0]),
                                              float(losses[-1])]}
    log(f"11c. test_traffic and refine from the checkpoint: {line['c']}")
    return line


NUSC_SCENES, NUSC_FRAMES, NUSC_AGENTS = 850, 40, (10, 40)  # trainval's names
NUSC_PIX_PER_M = 4.0  # the ETL's resolution
NUSC_TRAIN_CFG = "configs/train_traffic.cfg"      # 12c
NUSC_TRAIN_STEPS, NUSC_VAL_STEPS = 5, 2           # of 5,000+ a split
NUSC_ADV_CFG = "configs/adv_gen_rule_based.cfg"   # 12d
# 12d screens at most the first NUSC_ADV_SCREEN val windows and stops after
# the entry point's first optimized batch (B=1)
NUSC_ADV_SCREEN, NUSC_ADV_ITERS = 16, 10          # of 1,200 and 200
NUSC_EVAL_CFG = "configs/eval_planner.cfg"        # 12e
NUSC_EVAL_SCENES = 40  # regular scenes eval_planner reads (of 1,200)
NUSC_CLUSTER_K = 4
# per_seq / all_eval / total CSVs, card against CPU: these columns exact,
# every other number within 1e-5
EXACT_COLUMNS = {"did_collide", "adv_success", "planner_coll_atk",
                 "planner_coll_others", "planner_coll_env", "env_coll_atk",
                 "sol_coll_others", "sol_coll_env", "sol_success",
                 "cluster_label", "cluster_name", "taxonomy", "count"}


def csv_close(np, got_path, want_path, tol=1e-5):
    """Raise unless two CSVs of the tools agree: the same header, rows and
    names; flags and labels exact, numbers within ``tol``.
    :return: the largest difference of a number"""
    import csv

    with open(got_path) as f:
        got = list(csv.reader(f))
    with open(want_path) as f:
        want = list(csv.reader(f))
    if got[0] != want[0] or len(got) != len(want):
        raise AssertionError(f"{got_path}: header or rows differ")
    worst = 0.0
    for g, w in zip(got[1:], want[1:]):
        for col, a, b in zip(got[0], g, w):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                fa = fb = None
            if fa is None or col in EXACT_COLUMNS or g[0] in EXACT_COLUMNS:
                if a != b:
                    raise AssertionError(f"{got_path}: {g[0]} {col} {a} "
                                         f"!= {b}")
                continue
            if np.isnan(fa) and np.isnan(fb):
                continue
            if not np.isclose(fa, fb, rtol=tol, atol=tol):
                raise AssertionError(f"{got_path}: {g[0]} {col} {fa} != {fb}")
            worst = max(worst, abs(fa - fb))
    return worst


def out_dir(prefix):
    """The ``<prefix>_<unix time>`` directory a tool wrote."""
    import glob

    (d,) = glob.glob(prefix + "_*")
    return d


def nusc_phase(torch, np, rates, card, counters, kernels, dev):
    """Phase 12: nuScenes' format and scale, then the tools (module doc),
    on ``dev`` (the card; the CPU only to rehearse the control flow).

    :return: the ``nuscenes`` JSON line's dict"""
    import itertools
    import shutil
    import tempfile

    from strive_tpu_torch import kernel_cases as kc
    from strive_tpu_torch.data.loading import load_environment
    from strive_tpu_torch.data.synthetic_etl import write_synthetic_etl
    from strive_tpu_torch.maps import queries
    from strive_tpu_torch.maps.store import NUSC_MAP_SIZES
    from strive_tpu_torch.scripts import adv_scenario_gen as gen
    from strive_tpu_torch.scripts import cluster_scenarios as clu
    from strive_tpu_torch.scripts import eval_adv_gen as eag
    from strive_tpu_torch.scripts import eval_planner as evp
    from strive_tpu_torch.scripts import train_traffic as trt
    from strive_tpu_torch.viz import have_matplotlib

    build_dir = os.path.join(ROOT, "build", "chip_smoke", "nusc")
    shutil.rmtree(build_dir, ignore_errors=True)
    os.makedirs(build_dir)
    line = {"nuscenes": "synthetic content in the ETL format at nuScenes' "
                        "extents", "card": card}
    data_dir = tempfile.mkdtemp(prefix="strive_nusc_etl_")
    try:
        # --- a. write and load the ETL directory --------------------------
        etl_dir = write_synthetic_etl(
            data_dir, version="trainval", num_scenes=NUSC_SCENES,
            pix_per_m=NUSC_PIX_PER_M, frames=NUSC_FRAMES, agents=NUSC_AGENTS,
            device=dev)
        tcfg = trt.parse_cfg(["-c", os.path.join(ROOT, NUSC_TRAIN_CFG),
                              "--data_dir", data_dir])
        ds, store, lgs, sn, an = load_environment(tcfg, "train",
                                                  load_lanegraph=True,
                                                  device=dev)
        dx = store.dx.cpu().numpy()
        px = np.round(np.array([NUSC_MAP_SIZES[m] for m in store.map_names])
                      * NUSC_PIX_PER_M)
        want_dx = (np.array([NUSC_MAP_SIZES[m] for m in store.map_names])
                   / px).astype(np.float32)
        want_shape = (4, 4) + tuple(int(v) for v in px.max(0))
        if store.raster.shape != want_shape or not np.array_equal(
                dx, want_dx) or sorted(lgs) != sorted(store.map_names):
            raise AssertionError(f"12a. store {tuple(store.raster.shape)}, "
                                 f"dx {dx.tolist()}, lane graphs {sorted(lgs)}")
        store_bytes = (store.raster.numel() + store.packed.numel()
                       + store.dx.numel() * 4)
        files = {f: os.path.getsize(os.path.join(etl_dir, f))
                 for f in sorted(os.listdir(etl_dir))}
        line["a"] = {"etl_files_bytes": files, "scenes": NUSC_SCENES,
                     "frames": NUSC_FRAMES, "agents": list(NUSC_AGENTS),
                     "raster": list(store.raster.shape),
                     "dx": dx.tolist(), "store_bytes_on_device": store_bytes,
                     "train_windows": len(ds),
                     "lane_vertices": {m: len(lg["xy"])
                                       for m, lg in lgs.items()}}
        log(f"12a. ETL directory written ({files}) and loaded: "
            f"{store_bytes / 1e9:.2f} GB on the card, {len(ds)} train "
            f"windows, dx {dx.tolist()}")

        # --- b. K1 and K2 on this store at the launch shapes of c and d ---
        vcfg = gen.parse_cfg(["-c", os.path.join(ROOT, NUSC_ADV_CFG),
                              "--data_dir", data_dir])
        train_b = ds.get_batch(list(range(tcfg.batch_size)))
        pos_all = sn.unnormalize(train_b.past_gt[:, :, -1, :4]).reshape(-1, 4)
        lo, wo = queries.crop_offsets(tcfg.map_obs_bounds,
                                      tcfg.map_obs_size_pix,
                                      tcfg.map_obs_size_pix, dev)
        train_k1 = (store.packed, store.dx, pos_all.contiguous(),
                    train_b.map_idx.repeat_interleave(train_b.NA), lo, wo,
                    store.C, "nhwc")
        ego = sn.unnormalize(train_b.future_gt[:, 0, :, :4]).reshape(-1, 4)
        ego_lw = an.unnormalize(train_b.lw[:, 0])[:, None].expand(
            train_b.B, train_b.FT, 2).reshape(-1, 2)
        gl, gw = queries.COLL_POINT_GRID
        grid = (queries.linspace(-1.0, 1.0, gl, dev),
                queries.linspace(-1.0, 1.0, gw, dev), 0)
        train_k2 = (store.packed, store.dx, ego.contiguous(),
                    ego_lw.contiguous(),
                    train_b.map_idx.repeat_interleave(train_b.FT), *grid)
        one = ds.get_batch([0])
        p1 = sn.unnormalize(one.past_gt[0, :, -1, :4])             # (NA, 4)
        rng = np.random.default_rng(0)
        samp = p1.repeat(vcfg.num_samples, 1).clone()
        samp[:, :2] += torch.as_tensor(rng.normal(0, 2.0, (len(samp), 2)),
                                       dtype=torch.float32, device=dev)
        adv_k1 = (store.packed, store.dx, samp.contiguous(),
                  one.map_idx.repeat_interleave(len(samp)), lo, wo, store.C,
                  "nhwc")
        stats = (torch.as_tensor(sn.mean_np[:4], device=dev),
                 torch.as_tensor(sn.std_np[:4], device=dev),
                 torch.as_tensor(an.mean_np, device=dev),
                 torch.as_tensor(an.std_np, device=dev))
        adv_k2 = kc.main_path_coll_point_args(store, one, *stats)
        hold_shapes(torch, rates, kernels, [
            ("map_crop", "nusc_train_shape", "12c, a decode step of "
             f"train_traffic.cfg: B={train_b.B} x {train_b.NA} agents = "
             f"{len(pos_all)} poses, 256 px", train_k1),
            ("map_crop", "nusc_adv_shape", "12d, a sampling step of "
             f"adv_gen_rule_based.cfg: 1 scene x {vcfg.num_samples} samples "
             f"x {one.NA} agents = {len(samp)} poses, 256 px", adv_k1),
            ("footprint_coll_point", "nusc_train_shape", "12c, the training "
             f"loss's ego prior: B={train_b.B} x {train_b.FT} poses = "
             f"{len(ego)} cars", train_k2),
            ("footprint_coll_point", "nusc_adv_shape", "12d, the adversarial "
             f"loss: 1 scene x {one.NA} agents x {3 * one.FT} interpolated "
             f"poses = {adv_k2[2].shape[0]} cars", adv_k2)], "12b")
        del ds, store, train_b, one, train_k1, train_k2, adv_k1, adv_k2
        torch.cuda.empty_cache()

        # --- c. train_traffic on it ---------------------------------------
        out = os.path.join(build_dir, "train")
        argv = ["-c", os.path.join(ROOT, NUSC_TRAIN_CFG), "--data_dir",
                data_dir, "--epochs", "1", "--device", dev.type, "--out", out]
        iterate = trt.batch_iterator

        def cut(ds_, batch_size, shuffle=True, seed=0):
            n = NUSC_TRAIN_STEPS if shuffle else NUSC_VAL_STEPS
            return itertools.islice(iterate(ds_, batch_size, shuffle=shuffle,
                                            seed=seed), n)

        timings = {}
        zero(counters)
        trt.batch_iterator = cut
        try:
            quiet(trt.main, argv, timings)
        finally:
            trt.batch_iterator = iterate
        launches = counted(counters)
        steps = len(timings["train_steps"]) + NUSC_VAL_STEPS
        expected = dict.fromkeys(launches, 0)
        expected["map_crop"] = steps * (1 + 2 * tcfg.future_len)
        expected["footprint_coll_point"] = steps
        if launches != expected or len(timings["train_steps"]) != \
                NUSC_TRAIN_STEPS:
            raise AssertionError(f"12c. launches {launches}, expected "
                                 f"{expected}")
        mets = (timings["train"][0], timings["val"][0])
        if not all(np.isfinite(v) for m_ in mets for v in m_.values()):
            raise AssertionError(f"12c. metrics {mets}")
        line["c"] = {
            "config": NUSC_TRAIN_CFG, "B": tcfg.batch_size,
            "NA": tcfg.max_agents, "FT": tcfg.future_len,
            "train_steps": NUSC_TRAIN_STEPS, "val_steps": NUSC_VAL_STEPS,
            "train": mets[0], "val": mets[1],
            "launches": {k: launches[k] for k in ("map_crop",
                                                  "footprint_coll_point")},
            "reduced": {"epochs": "200 -> 1",
                        "steps": f"{NUSC_TRAIN_STEPS} train and "
                                 f"{NUSC_VAL_STEPS} val batches of the "
                                 "epoch's"}}
        for name in ("map_crop", "footprint_coll_point"):
            kernels[name]["nusc_train_launches"] = launches[name]
        log(f"12c. train_traffic on the ETL data: {line['c']}")

        # --- d. adv_scenario_gen on it ------------------------------------
        drop = {"ckpt"} if have_matplotlib() else {"ckpt", "viz"}
        if "viz" in drop:
            log("12d. matplotlib is not installed on this machine: "
                f"{NUSC_ADV_CFG} runs without its viz line")
        cfg = cfg_copy(NUSC_ADV_CFG, drop, "nusc_adv_gen.cfg")
        adv_out = os.path.join(build_dir, "adv")
        argv = ["-c", cfg, "--data_dir", data_dir, "--num_iters",
                str(NUSC_ADV_ITERS), "--max_scenes", str(NUSC_ADV_SCREEN),
                "--device", dev.type, "--out", adv_out]
        pc = gen.parse_cfg(argv)
        timings = {}
        zero(counters)
        stats = quiet(gen.main, argv, timings, max_batches=1)
        launches = counted(counters)
        calls = timings["calls"]
        expected = dict.fromkeys(launches, 0)
        expected.update(pipeline_launches(gen, pc, calls))
        if launches != expected:
            raise AssertionError(f"12d. launches {launches}, expected "
                                 f"{expected} from the stages {calls}")
        jsons = scenario_jsons(np, adv_out)
        n_json = sum(len(v) for v in jsons.values())
        if n_json != sum(b for _, b, _ in timings["batches"]) or not n_json:
            raise AssertionError(f"12d. {n_json} scenario files for batches "
                                 f"{timings['batches']}")
        if len(timings["batches"]) != 1:
            raise AssertionError(f"12d. batches {timings['batches']}, "
                                 "expected the first one only")
        line["d"] = {
            "config": f"{NUSC_ADV_CFG} without its "
                      f"{' and '.join(sorted(drop))} line"
                      + ("s" if len(drop) > 1 else ""),
            "reduced": {"num_iters": f"200 -> {NUSC_ADV_ITERS}",
                        "candidates": f"1,200 val windows -> "
                                      f"{stats['candidates']}, up to the "
                                      "first optimized batch",
                        "weights": "random, Flax's distributions seeded 0"},
            "stats": stats, "stage_calls": calls,
            "final_loss": timings["final_loss"],
            "launches": {k: launches[k] for k in ("map_crop",
                                                  "footprint_coll_point")},
            "jsons": {k: len(v) for k, v in jsons.items()}}
        for name in ("map_crop", "footprint_coll_point"):
            kernels[name]["nusc_adv_launches"] = launches[name]
        log(f"12d. adv_scenario_gen on the ETL data: {line['d']}")

        # --- e. the tools, card against CPU -------------------------------
        scen_dir = os.path.join(build_dir, "scenarios")  # all of d's JSONs
        os.makedirs(scen_dir)
        for folder in FOLDERS:
            path = os.path.join(adv_out, "scenario_results", folder)
            for name in os.listdir(path) if os.path.isdir(path) else []:
                shutil.copy(os.path.join(path, name), scen_dir)
        tracked = os.path.join(ROOT, "out", "adv_gen_synth_hc_prod",
                               "scenario_results")
        runs = {}
        for d in (dev.type, "cpu"):
            o = os.path.join(build_dir, f"tools_{d}_{len(runs)}")
            quiet(evp.main, ["-c", os.path.join(ROOT, NUSC_EVAL_CFG),
                             "--data_dir", data_dir, "--scenario_dir",
                             scen_dir, "--max_scenes", str(NUSC_EVAL_SCENES),
                             "--device", d, "--out", o + "/eval_planner"])
            clustering = quiet(clu.main, [
                "--scenario_dirs", *[os.path.join(tracked, f)
                                     for f in FOLDERS], scen_dir,
                "--k", str(NUSC_CLUSTER_K), "--device", d,
                "--out", o + "/cluster"])
            cdir = out_dir(o + "/cluster")
            quiet(eag.main, ["-c", "/dev/null", "--scenario_root",
                             os.path.join(adv_out, "scenario_results"),
                             "--eval_quant", "--data_version", "trainval",
                             "--data_dir", data_dir, "--cluster_pkl",
                             os.path.join(cdir, "cluster.pkl"),
                             "--cluster_labels",
                             os.path.join(cdir, "cluster_labels.txt"),
                             "--device", d, "--out", o + "/eval_adv_gen"])
            runs[len(runs)] = (o, clustering)
        (card_o, card_c), (cpu_o, cpu_c) = runs[0], runs[1]
        if not (np.array_equal(card_c.labels_, cpu_c.labels_)
                and np.allclose(card_c.cluster_centers_,
                                cpu_c.cluster_centers_, rtol=0, atol=1e-5)):
            raise AssertionError(f"12e. k-means: card {card_c.labels_}, CPU "
                                 f"{cpu_c.labels_}")
        diffs = {}
        for tool, name in (("eval_planner", "all_eval_results.csv"),
                           ("eval_adv_gen", "per_seq_results.csv"),
                           ("eval_adv_gen", "total_results.csv")):
            diffs[name] = csv_close(
                np, os.path.join(out_dir(f"{card_o}/{tool}"), name),
                os.path.join(out_dir(f"{cpu_o}/{tool}"), name))
        line["e"] = {"card_vs_cpu_max_diff": diffs,
                     "cluster_labels": card_c.labels_.tolist(),
                     "cluster_inertia": [card_c.inertia_, cpu_c.inertia_],
                     "scenarios": len(os.listdir(scen_dir)),
                     "regular_scenes": NUSC_EVAL_SCENES}
        log(f"12e. eval_planner, cluster_scenarios and eval_adv_gen: card "
            f"and CPU agree ({line['e']})")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    return line


# phase 13b: each option of TrafficModel on phase 5's small run (FT 6 for
# the refresh runs, so that k = 2 and 3 divide it)
OPTIONS = {"bf16": dict(compute_dtype="bfloat16"),
           "direct": dict(output_bicycle=False),
           "gru": dict(traj_encoder="gru"),
           "refresh2": dict(map_refresh_every=2, FT=6),
           "refresh3": dict(map_refresh_every=3, FT=6)}
OPTION_ITERS = 3
# 13b's bounds, card against CPU: (loss history rtol, final rollouts as a
# share of their largest magnitude, "steady" latents, every latent). Adam
# steps lr g / (|g| + 1e-8): where |g| is near 1e-7 float noise in g moves
# the step by a share of lr, and where g is noise its sign may flip (2
# lr). So the latents the CPU's run stepped a full lr the same way all
# three times ("steady") get the tight bound. Float32 options: phase 5's
# bounds (1e-3, 1e-4) and 1e-3 on every latent (measured on an H100 in
# the k = 2 run: one latent 4.7e-4 apart while the losses agreed to
# 3.3e-7 and the rollouts to 3.7e-6). bf16, as
# tests/test_torch_model_options.py holds the port's bf16 against
# strive_tpu's (bf16 rounds at other places in cuBLAS/cuDNN than on the
# CPU): every latent within the 6 lr that three opposite steps can part.
SMALL_BOUNDS = {"f32": (1e-3, 1e-4, 1e-4, 1e-3),
                "bf16": (1e-2, 3e-3, 2e-2, 6 * 0.05)}
BF16_TRAIN_SCENES = 24  # 13c's bf16 training: 3 + 3 batches of 8 (11b: 5)


def check_crop(torch, crop_kernel, args, dtype, where):
    """K1's output of ``dtype`` equals its plain version's, bit for bit (0
    and 1 are exact in float32 and bf16).

    :return: the largest difference"""
    got = crop_kernel.map_crop(*args, dtype)
    want = crop_kernel.map_crop_plain(*args, dtype)
    torch.cuda.synchronize()
    if got.dtype != dtype or not torch.equal(got, want):
        raise AssertionError(f"{where}. {dtype} map_crop differs from plain "
                             f"({args[-1]}, C {args[6]}, "
                             f"{args[2].shape[0]} poses): "
                             f"{int((got != want).sum())} values")
    return float((got.float() - want.float()).abs().amax())


def bf16_crop_entry(torch, crop_kernel, queries, cuda_ms, rates, args,
                    where):
    """K1 writing bf16 at the shape of ``args``: bit-exact against its
    plain version, then timed beside its bound (2-byte outputs)."""
    check_crop(torch, crop_kernel, args, torch.bfloat16, where)
    nbytes, flops = crop_work(torch, queries, args, out_bytes=2)
    return {"bf16_ms": cuda_ms(lambda: crop_kernel.map_crop(
        *args, torch.bfloat16), 200),
        "bf16_bound_ms": bound_ms(rates, nbytes, flops)[0]}


def options_phase(torch, np, tm, norm, rates, card, counters, kernels,
                  main_path, k1_args):
    """Phase 13: the model options on the card (module doc).

    :param main_path: (scene, store) of phase 6
    :param k1_args: K1's arguments at the main path's shape (phase 3)
    :return: the ``options`` JSON line's dict"""
    from strive_tpu_torch import kernel_cases as kc
    from strive_tpu_torch.maps import crop_kernel, queries
    from strive_tpu_torch.optim.adv import run_adv_gen_optim
    from strive_tpu_torch.scripts import train_traffic as trt
    from strive_tpu_torch.utils.timing import cuda_ms

    bf16 = torch.bfloat16
    scene, store = main_path
    line = {"options": "TrafficModel's bf16 compute, direct output, GRU "
                       "encoders and map refresh", "card": card}

    # --- a. K1 writing bf16: its record -------------------------------------
    shapes = {}
    for what, args in (("main_32", k1_args),
                       ("training_128", kc.decode_crop_args(DEV, 8))):
        entry = {"poses": int(args[2].shape[0])}
        for tag, dt, nb in (("f32", torch.float32, 4), ("bf16", bf16, 2)):
            entry[f"{tag}_ms"] = cuda_ms(
                lambda: crop_kernel.map_crop(*args, dt), 200)
            entry[f"{tag}_bound_ms"], entry["bound_by"] = bound_ms(
                rates, *crop_work(torch, queries, args, out_bytes=nb))
        entry["bf16_plain_ms"] = cuda_ms(
            lambda: crop_kernel.map_crop_plain(*args, bf16), 20)
        shapes[what] = entry
    log(f"13a. bf16 map_crop: {shapes}")

    # --- b. phase 5's small run with each option, card against CPU ---------
    small = {}
    for name, opt in OPTIONS.items():
        runs = []
        for d in ("cpu", DEV):
            zero(counters)
            m, st, sc, emb = small_setup(torch, tm, norm, d, **opt)
            out = run_optim(run_adv_gen_optim, m, sc, st, emb, OPTION_ITERS)
            torch.cuda.synchronize()
            launches = counted(counters)  # the card's: the last run
            runs.append({"z": out[0].cpu(), "result": out[1].cpu(),
                         "losses": out[4].cpu(), "z0": emb["prior_out"][0]
                         .cpu()})
        cpu, card_run = runs
        ft = opt.get("FT", SMALL_KW["FT"])
        k = opt.get("map_refresh_every", 1)
        # the embed, then a decode an iteration and the final decode
        want_k1 = 1 + (OPTION_ITERS + 1) * ft // k
        if launches["map_crop"] != want_k1:
            raise AssertionError(f"13b. {name}: map_crop launched "
                                 f"{launches['map_crop']} times, expected "
                                 f"{want_k1}")
        loss_rel = float(((card_run["losses"] - cpu["losses"]).abs()
                          / cpu["losses"].abs()).max())
        z_diff = (card_run["z"] - cpu["z"]).abs()
        res_rel = float((card_run["result"] - cpu["result"]).abs().max()
                        / cpu["result"].abs().max())
        steady = (cpu["z"] - cpu["z0"]).abs() >= 2.9 * 0.05
        entry = {"k1_launches": launches["map_crop"], "loss_rel": loss_rel,
                 "result_rel": res_rel, "z_max_abs": float(z_diff.max()),
                 "steady_z_max_abs": float(z_diff[steady].max())
                 if bool(steady.any()) else 0.0,
                 "steady_share": float(steady.float().mean())}
        loss_tol, res_tol, steady_tol, z_tol = SMALL_BOUNDS[
            "bf16" if name == "bf16" else "f32"]
        ok = (loss_rel <= loss_tol and res_rel <= res_tol
              and entry["steady_z_max_abs"] <= steady_tol
              and entry["z_max_abs"] <= z_tol)
        if not ok:
            raise AssertionError(f"13b. {name}: card against CPU {entry}")
        small[name] = entry
    line["b"] = small
    log(f"13b. the options' small runs, card against CPU: {small}")

    # --- c. the main path and training in bf16 at full width ----------------
    model = build_model(torch, tm, norm, MAP_PX, compute_dtype="bfloat16")

    def run(m, iters):
        with torch.no_grad():
            emb = m.embed(scene, store)
        out = run_optim(run_adv_gen_optim, m, scene, store, emb, iters)
        torch.cuda.synchronize()
        return out

    zero(counters)
    z, result, _, _, losses, _ = run(model, ITERS)
    launches = counted(counters)
    expected = dict.fromkeys(launches, 0)
    expected.update(map_crop=1 + FT * ITERS + FT,
                    footprint_coll_point=ITERS + 1)
    if launches != expected:
        raise AssertionError(f"13c. bf16 launches {launches}, expected "
                             f"{expected}")
    if not (bool(torch.isfinite(losses).all())
            and bool(torch.isfinite(result).all())
            and bool(torch.isfinite(z).all())):
        raise AssertionError("13c. bf16 main path not finite")
    kernels["map_crop"]["bf16_launches"] = launches["map_crop"]
    kernels["map_crop"]["bf16_shape"] = shapes
    line["c_main_path"] = {
        "B": B, "NA": NA, "FT": FT, "crop_px": MAP_PX, "iters": ITERS,
        "losses_first_last": [float(losses[0]), float(losses[-1])],
        "launches": launches}
    del model
    log(f"13c. bf16 main path: {line['c_main_path']}")

    out = os.path.join(ROOT, "build", "chip_smoke", "train_bf16")
    argv = ["-c", os.path.join(ROOT, TRAIN_CFG), "--epochs", "1",
            "--synth_scenes", str(BF16_TRAIN_SCENES), "--device", DEV,
            "--out", out, "--bf16"]
    pc = trt.parse_cfg(argv)
    timings = {}
    torch.cuda.empty_cache()
    zero(counters)
    quiet(trt.main, argv, timings)
    launches = counted(counters)
    steps = (len(timings["train_steps"])
             + -(-BF16_TRAIN_SCENES // pc.batch_size))
    expected = dict.fromkeys(launches, 0)
    expected.update(map_crop=steps * (1 + 2 * pc.future_len),
                    footprint_coll_point=steps)
    if launches != expected:
        raise AssertionError(f"13c. bf16 training launches {launches}, "
                             f"expected {expected}")
    mets = (timings["train"][0], timings["val"][0])
    if not all(np.isfinite(v) for m_ in mets for v in m_.values()):
        raise AssertionError(f"13c. bf16 training metrics {mets}")
    line["c_training"] = {
        "config": TRAIN_CFG, "flag": "--bf16",
        "train_steps": len(timings["train_steps"]),
        "val_steps": steps - len(timings["train_steps"]),
        "train": mets[0], "val": mets[1], "launches": launches,
        "reduced": {"epochs": "400 -> 1", "synth_scenes":
                    f"96 -> {BF16_TRAIN_SCENES} a split"}}
    log(f"13c. bf16 training: {line['c_training']}")

    # --- d. the main path at map_refresh_every = 2 ---------------------------
    model = build_model(torch, tm, norm, MAP_PX, map_refresh_every=2)
    zero(counters)
    _, result, _, _, losses, _ = run(model, ITERS)
    launches = counted(counters)
    want_k1 = 1 + (ITERS + 1) * FT // 2
    if launches["map_crop"] != want_k1 or not bool(
            torch.isfinite(losses).all() & torch.isfinite(result).all()):
        raise AssertionError(f"13d. refresh 2: launches {launches}, "
                             f"expected {want_k1} crops; losses {losses}")
    kernels["map_crop"]["refresh2_launches"] = launches["map_crop"]
    line["d_refresh2"] = {"launches": launches}
    log(f"13d. map_refresh_every=2: launches {launches}")
    return line


# phase 15: the harnesses' and studies' sizes (the studies on 9c's prior)
STUDY_ITERS, STUDY_SCENES = 20, 4
STUDY_POINTS = (f"closed_it{STUDY_ITERS}:--num_iters {STUDY_ITERS}",
                f"open_it{STUDY_ITERS}:--planner ego --num_iters "
                f"{STUDY_ITERS}")
HARNESS_ITERS = 5
STUDY_COUNTS = ("candidates", "feasible", "adv_success", "sol_success")
STUDY_KEYS = {*STUDY_COUNTS, "pipeline_sec", "yield_pct", "wall_sec"}


def harness_lines(fn, env):
    """Run harness ``fn`` (a ``main``) in this process with ``env`` set;
    :return: its stdout lines"""
    import contextlib
    import io

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            if fn(["--device", "cuda"]) != 0:
                raise AssertionError(f"{fn.__module__} failed")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return buf.getvalue().splitlines()


def studies_phase(card, counters):
    """Phase 15: the port's bench harnesses and studies (module doc).

    :return: the ``studies`` JSON line"""
    import re
    import shutil

    from strive_tpu_torch.planners import PLANNER_CONFIGS, PlannerConfig
    from strive_tpu_torch.planners import device_planner as dp
    from strive_tpu_torch.scripts import bench, bench_closed_loop

    line = {"studies": "bench, bench_closed_loop, study_yield, "
                       "study_refresh_quality", "card": card}
    # --- a. bench at HARNESS_ITERS iterations, its launches counted ------
    zero(counters)
    out = harness_lines(bench.main, {"STRIVE_BENCH_ITERS": str(HARNESS_ITERS)})
    launches = counted(counters)
    runs = 6  # a warm-up and 5 timed
    expected = {k: 0 for k in launches}
    expected.update({"map_crop": 1 + runs * FT * (HARNESS_ITERS + 1),
                     "footprint_coll_point": runs * (HARNESS_ITERS + 1)})
    if len(out) != 1 or launches != expected:
        raise AssertionError(f"15a. bench printed {out}, launches "
                             f"{launches}, expected {expected}")
    res = json.loads(out[0])
    if res["metric"] != "adv_latent_optim_iters_per_sec" \
            or not res["value"] > 0:
        raise AssertionError(f"15a. bench: {res}")
    line["bench"] = {"iters": HARNESS_ITERS, "launches": launches}
    log(f"15a. bench, {HARNESS_ITERS} iterations: launches {launches}")

    # --- b. the closed-loop bench, device planner, k = 1 and 2 -----------
    line["closed_loop_bench"] = {}
    cfg = dp.StaticPlanCfg.from_planner_config(
        PlannerConfig(**PLANNER_CONFIGS["default"]))
    for k in (1, 2):
        zero(counters)
        calls = dp.COUNTS["calls"]
        out = harness_lines(bench_closed_loop.main, {
            "STRIVE_BENCH_ITERS": str(HARNESS_ITERS),
            "STRIVE_BENCH_MODES": "fused", "STRIVE_BENCH_REFRESH": str(k)})
        launches = counted(counters)
        expected = {k2: 0 for k2 in launches}
        expected.update({"map_crop": 1 + 4 * FT * (HARNESS_ITERS + 1),
                         "footprint_coll_point": 4 * (HARNESS_ITERS + 1),
                         "lane_match": (dp.COUNTS["calls"] - calls)
                         * match_launches_per_call(cfg)})
        m = re.match(r"device: \d+ closed-loop iters in [\d.]+s \([\d.]+ "
                     r"it/s", out[0]) if len(out) == 1 else None
        if m is None or launches != expected:
            raise AssertionError(f"15b. closed-loop bench k={k} printed "
                                 f"{out}, launches {launches}, expected "
                                 f"{expected}")
        line["closed_loop_bench"][f"k{k}"] = {"launches": launches}
        log(f"15b. closed-loop bench, k = {k}: launches {launches}")

    # --- c. the studies on the trained prior, side by side -----------------
    base = os.path.join(ROOT, "build", "chip_smoke", "studies")
    yield_out, refresh_out = (os.path.join(base, d)
                              for d in ("yield", "refresh"))
    for d in (yield_out, refresh_out):
        if os.path.isdir(d):
            shutil.rmtree(d)
    ckpt = os.path.join(ROOT, PIPE_CKPT)
    cfg = os.path.join(ROOT, PIPE_CFG)
    cmds = {
        "yield": [sys.executable, "-m", "strive_tpu_torch.scripts.study_yield",
                  "--cfg", cfg, "--out", yield_out, "--max_scenes",
                  str(STUDY_SCENES), "--ckpt", ckpt, "--points",
                  *STUDY_POINTS],
        "refresh": [sys.executable, "-m",
                    "strive_tpu_torch.scripts.study_refresh_quality", "--cfg",
                    cfg, "--out", refresh_out, "--ks", "1", "2",
                    "--skip_perf", "--ckpt", ckpt, "--extra", "--max_scenes",
                    str(STUDY_SCENES), "--num_iters", str(STUDY_ITERS)]}
    procs = {k: subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, c in cmds.items()}
    outs = {}
    try:
        for k, proc in procs.items():
            outs[k], _ = proc.communicate(timeout=600)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, proc in procs.items():
        if proc.returncode != 0:
            raise AssertionError(f"15c. study_{k} exited {proc.returncode}:"
                                 f"\n{outs[k][-3000:]}")
    with open(os.path.join(yield_out, "yield_study.json")) as fh:
        ys = json.load(fh)
    names = [p.split(":")[0] for p in STUDY_POINTS]
    if list(ys) != names:
        raise AssertionError(f"15c. yield study points {list(ys)}")
    for name, s in ys.items():
        if not STUDY_KEYS <= set(s) or s["candidates"] != STUDY_SCENES or not (
                0 <= s["adv_success"] <= s["feasible"] <= s["candidates"]
                and s["sol_success"] <= s["adv_success"]):
            raise AssertionError(f"15c. yield study {name}: {s}")
    with open(os.path.join(refresh_out, "refresh_study.json")) as fh:
        rs = json.load(fh)
    if set(rs["taxonomy"]) != {"1", "2"} or "perf" in rs:
        raise AssertionError(f"15c. refresh study: {rs}")
    feasible = ys[names[0]]["feasible"]
    for k, tax in rs["taxonomy"].items():
        if set(tax) != set(FOLDERS) or not sum(tax.values()) <= feasible \
                or tax["adv_sol_success"] + tax["sol_failed"] > feasible:
            raise AssertionError(f"15c. refresh study k={k}: {tax}, "
                                 f"feasible {feasible}")
    div = rs.get("divergence_m", {})
    if sum(rs["taxonomy"]["1"].values()) and div.get("1", {}).get(
            "max") != 0.0:
        raise AssertionError(f"15c. k = 1 diverges from itself: {div}")
    line["yield"] = {name: {k: s[k] for k in STUDY_COUNTS}
                     for name, s in ys.items()}
    line["refresh"] = rs
    log(f"15c. yield study {line['yield']}; refresh study {rs}")
    return line


def main():
    # one card: the first of those visible, numbered as nvidia-smi numbers it
    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "-i", visible, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")

    import numpy as np

    from strive_tpu_torch import kernel_cases as kc
    from strive_tpu_torch.data.synthetic import synthetic_scene_list
    from strive_tpu_torch.maps import crop_kernel, queries
    from strive_tpu_torch.maps.store import synthetic_map_store
    from strive_tpu_torch.model import traffic_model as tm
    from strive_tpu_torch.normalize import (att_normalizer_for,
                                            state_normalizer_for)
    from strive_tpu_torch.optim.adv import run_adv_gen_optim
    from strive_tpu_torch.planners import lane_match
    from strive_tpu_torch.scene import pad_scene_arrays
    from strive_tpu_torch.scripts.bench import WEIGHTS
    from strive_tpu_torch.probes import bisect_kernels, window_kernels
    from strive_tpu_torch.utils import build
    from strive_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)

    # --- 2. build, TF32 off ------------------------------------------------
    build.build([crop_kernel.SOURCE, window_kernels.SOURCE,
                 bisect_kernels.SOURCE, lane_match.SOURCE])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cats = ("car", "truck")
    state_norm, att_norm = state_normalizer_for(cats), att_normalizer_for(cats)
    norm = tm.NormConfig.from_normalizers(state_norm, att_norm)
    store = synthetic_map_store(num_maps=2, size_px=STORE_PX, channels=4,
                                pix_per_m=4.0, device=dev)
    scenes = synthetic_scene_list(num_scenes=B, num_maps=2,
                                  map_size_px=STORE_PX, PT=PT, FT=FT,
                                  min_agents=NA, max_agents=NA)
    scene = pad_scene_arrays(scenes, NA, 2, device=dev)
    smean = torch.as_tensor(norm.state_mean[:4], device=dev)
    sstd = torch.as_tensor(norm.state_std[:4], device=dev)
    kernels = {}

    # --- 3. K1 against its plain version -----------------------------------
    k1_args = kc.main_path_crop_args(store, scene, smean, sstd)
    lo, wo = k1_args[4:6]
    # 8 poses on and off the maps with non-unit headings, a NaN pose and a
    # NaN heading: where the library yardstick differs from K1
    rng = np.random.default_rng(0)
    edge = np.concatenate([rng.uniform(-30, 540, (8, 2)),
                           rng.normal(size=(8, 2))], 1).astype(np.float32)
    edge[0] = np.nan
    edge[1, 2:] = np.nan
    edge = torch.from_numpy(edge).to(dev)
    emap = torch.from_numpy(rng.integers(0, 2, 8)).to(dev)
    small = queries.crop_offsets((-4.0, -8.0, 12.0, 8.0), 64, 64, dev)
    cases = [k1_args,
             (store.packed, store.dx, edge, emap, lo, wo, 4, "nhwc"),
             (store.packed, store.dx, edge, emap, lo, wo, 3, "nchw"),
             (store.packed, store.dx, edge, emap, *small, 4, "nhwc")]
    # each case in both layouts, float32 and bf16
    k1_err = max(check_crop(torch, crop_kernel, (*args[:-1], layout), dt, "3")
                 for args in cases for layout in ("nhwc", "nchw")
                 for dt in (torch.float32, torch.bfloat16))
    k1_ms = cuda_ms(lambda: crop_kernel.map_crop(*k1_args), 200)
    k1_plain_ms = cuda_ms(lambda: crop_kernel.map_crop_plain(*k1_args),
                          20)
    k1_bound, k1_by = bound_ms(rates, *crop_work(torch, queries, k1_args))
    # the library's nearest-neighbour resampling, beside K1 (never called
    # by the port): the main path's 32 poses, training's 128, the edge poses
    k1_128 = kc.decode_crop_args(dev, 8)
    library = {
        "call": "per map: F.affine_grid + F.grid_sample(mode='nearest', "
                "align_corners=True), grid 1 x (P 256) x 256 x 2",
        "main_path_32_poses": crop_library_entry(
            torch, queries, crop_kernel, cuda_ms, k1_args),
        "training_128_poses": {
            **crop_library_entry(torch, queries, crop_kernel, cuda_ms,
                                 k1_128),
            "k1_ms": cuda_ms(lambda: crop_kernel.map_crop(*k1_128), 200)},
        "edge_poses": crop_library_entry(torch, queries, crop_kernel,
                                         cuda_ms, cases[1])}
    del k1_128
    kernels["map_crop"] = dict(
        name="map_crop", route="cuda", source="strive_tpu_torch/csrc/crop.cu",
        replaces="strive_tpu/maps/crop_kernel.py:201", max_abs_err=k1_err,
        ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by,
        library_ms=library["main_path_32_poses"]["ms"], library=library)
    log(f"K1 map_crop bit-exact on {len(cases)} cases x 2 layouts x 2 "
        f"dtypes; {k1_ms:.4f} ms (plain {k1_plain_ms:.4f} ms, bound "
        f"{k1_bound:.4f} ms by {k1_by}); the library's affine_grid + "
        f"grid_sample {library}")

    # --- 4. K2 against its plain version -----------------------------------
    k2_args = kc.main_path_coll_point_args(  # 1152 cars: B x NA x 36 poses
        store, scene, smean, sstd,
        torch.as_tensor(norm.att_mean, device=dev),
        torch.as_tensor(norm.att_std, device=dev))
    lin_l, lin_w = k2_args[5:7]
    # 48 cars on and off the maps, un-normalized headings, lengths 3-18 m
    wild = torch.from_numpy(np.concatenate(
        [rng.uniform(-50, 560, (48, 2)), rng.uniform(100, 400, (48, 2))],
        1).astype(np.float32)).to(dev)
    wlw = torch.from_numpy(np.stack([rng.uniform(3, 18, 48),
                                     rng.uniform(1.5, 3, 48)], 1)
                           .astype(np.float32)).to(dev)
    wmap = torch.from_numpy(rng.integers(0, 2, 48)).to(dev)
    k2_cases = [k2_args,
                (store.packed, store.dx, wild, wlw, wmap, lin_l, lin_w, 0)]
    # the shared edge cases (their card test reads another store)
    k2_cases += [kc.coll_point_args(store, c, dev)
                 for c in kc.coll_point_cases(STORE_PX).values()]
    k2_err = max(kc.coll_point_error(args) for args in k2_cases)
    k2_ms = cuda_ms(lambda: crop_kernel.footprint_coll_point(*k2_args),
                    200)
    k2_plain_ms = cuda_ms(
        lambda: crop_kernel.footprint_coll_point_plain(*k2_args), 20)
    k2_bound, k2_by = bound_ms(rates, *footprint_work(torch, queries,
                                                      k2_args))
    kernels["footprint_coll_point"] = dict(
        name="footprint_coll_point", route="cuda",
        source="strive_tpu_torch/csrc/crop.cu",
        replaces="strive_tpu/maps/crop_kernel.py:298", max_abs_err=k2_err,
        ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by,
        library_ms=None)
    log(f"K2 footprint_coll_point: valid/frac exact on {len(k2_cases)} "
        f"cases, coll_pt max err {k2_err:.3g}; {k2_ms:.4f} ms (plain "
        f"{k2_plain_ms:.4f} ms, bound {k2_bound:.4f} ms by {k2_by})")

    # --- 5. small run: card (kernels) against CPU (plain versions) ---------
    runs = []
    for d in ("cpu", "cuda"):
        m, st, sc, emb = small_setup(torch, tm, norm, d)
        pri = emb["prior_out"]
        out = run_adv_gen_optim(m, pri[0], 0.05, WEIGHTS, sc, st, 3, emb,
                                "ego", (pri[0][:, 0], pri[1][:, 0]), pri, 1,
                                None)
        runs.append([t.cpu() for t in (out[0], out[4])])
    torch.testing.assert_close(runs[1][1], runs[0][1], rtol=1e-3, atol=0)
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=1e-4)
    log("small run: card agrees with the CPU plain path")

    # --- 6. the main path at full width -----------------------------------
    model = build_model(torch, tm, norm, MAP_PX)
    counters = (crop_kernel.LAUNCHES, window_kernels.LAUNCHES,
                bisect_kernels.LAUNCHES)
    # K6 counted where the device planner's runs are worked out: 6, 6b, 15
    planner_counters = counters + (lane_match.LAUNCHES,)
    zero(planner_counters)
    with torch.no_grad():
        emb = model.embed(scene, store)
    z, result, _, _, losses, _ = run_optim(run_adv_gen_optim, model, scene,
                                           store, emb, ITERS)
    torch.cuda.synchronize()
    launches = counted(planner_counters)
    expected = {"map_crop": 1 + FT * ITERS + FT,
                "footprint_coll_point": ITERS + 1,
                **dict.fromkeys(window_kernels.LAUNCHES, 0),
                **dict.fromkeys(bisect_kernels.LAUNCHES, 0), "lane_match": 0}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if losses.shape != (ITERS,) or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"losses not finite: {losses}")
    if result.shape != (B, NA, FT, 4) or not bool(torch.isfinite(result).all()):
        raise AssertionError("final trajectories not finite")
    if not bool(torch.isfinite(z).all()):
        raise AssertionError("final latents not finite")
    log(f"main path: {ITERS} iterations, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, launches {launches}")
    for k, entry in kernels.items():
        entry["launches"] = launches[k]
        entry["path"] = "main path (embed + open-loop adv optimization)"

    # --- 6b. the closed loop ------------------------------------------------
    closed_loop, cl_launches, k6 = closed_loop_phase(
        torch, np, tm, model, scene, store, norm, planner_counters, rates)
    kernels["lane_match"] = dict(
        k6, launches=cl_launches["lane_match"],
        path="closed loop (6b d: the device planner, every call a replay "
             "of its CUDA graph)", main_path_launches=launches["lane_match"])
    for k, entry in kernels.items():
        entry["closed_loop_launches"] = cl_launches[k]

    # --- 9. the scenario-generation pipeline ----------------------------------
    pipeline = pipeline_phase(torch, np, rates, card, counters, kernels)
    pipeline["d_solution"] = solution_stage(torch, tm, model, scene, store,
                                            norm, counters)

    # --- 10. refine; 11. training and evaluation ---------------------------
    refine_line, refine_cfg = refine_phase(torch, np, tm, norm, rates, card,
                                           counters, kernels)
    training = training_phase(torch, np, tm, norm, card, counters, kernels,
                              refine_cfg)

    # --- 13. the model options ------------------------------------------
    options = options_phase(torch, np, tm, norm, rates, card, counters,
                            kernels, (scene, store), k1_args)
    del model
    torch.cuda.empty_cache()

    # --- 12. nuScenes' format at its scale, then the tools -----------------
    nusc = nusc_phase(torch, np, rates, card, counters, kernels, dev)
    torch.cuda.empty_cache()

    # --- 14. parallel/mesh.py on the one card ------------------------------
    multi_gpu = multi_gpu_phase(torch, np, rates, card, kernels)

    # --- 7. K3, K4a, K4b and the gather-probe path -------------------------
    window_entries, probes = window_phase(torch, rates, card)
    kernels.update(window_entries)

    # --- 8. K5a-K5d and the Mosaic-bisect probes ---------------------------
    bisect_entries, bisect = bisect_phase(torch, rates, card)
    kernels.update(bisect_entries)

    # --- 15. the harnesses and the studies --------------------------------
    studies = studies_phase(card, planner_counters)
    print(json.dumps(probes))
    print(json.dumps(bisect))
    print(json.dumps({"closed_loop": {**closed_loop, "card": card}}))
    print(json.dumps(pipeline))
    print(json.dumps(refine_line))
    print(json.dumps(training))
    print(json.dumps(nusc))
    print(json.dumps(options))
    print(json.dumps(multi_gpu))
    print(json.dumps(studies))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
