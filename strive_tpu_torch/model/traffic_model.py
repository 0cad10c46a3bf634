"""The CVAE traffic model.

Port of ``strive_tpu/model/traffic_model.py`` (reference
``models/traffic_model.py``) on dense padded ``SceneBatch``es. The
autoregressive decoder is a Python loop over future steps; each step crops
the map at the detached new pose (reference ``.detach()`` at :694), so the
map branch carries no gradient to the latents.

A sample axis (``decode_embedding`` of (B, NS, NA, D) latents,
``sample_batched``) is folded into the batch axis: the scene's fields and
the cached features are repeated NS times, decoded as B*NS scenes, and
unfolded. This is exact, because the GNN only mixes agents of one scene,
and every rollout step crops all B*NS*NA poses in one launch.

The JAX model's options are all here:

- ``compute_dtype='bfloat16'``: the map encoder's convs and GroupNorms and
  the decoder's GNN compute in bf16 with float32 parameters, as Flax's
  ``dtype`` does (``model/common.py``); the map crop is written in bf16 by
  the crop kernel itself and feeds the conv stack with no cast pass.
  Everything else (prior and posterior nets, trajectory encoders, decoder
  memory, bicycle step) stays float32;
- ``output_bicycle=False``: the decoder emits the local pose (x, y, hx,
  hy) of the next step directly, instead of bicycle controls;
- ``traj_encoder='gru'``: 4-layer GRUs over the per-step features in
  place of the flattening MLPs;
- ``map_refresh_every=k``: the map is re-encoded after every k-th rollout
  step only (k = 1 when k does not divide the rollout length), so a
  decode crops FT / k times.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..dynamics import BikeParams, NUSC_BIKE_PARAMS, bike_step
from ..geometry import normalize_heading, transform2frame
from ..losses.common import log_normal
from ..maps.queries import get_map_crop
from ..maps.store import DEFAULT_BOUNDS
from ..scene import SceneBatch
from .cnn import MapEncoder
from .common import MLP, StackedGRU
from .interaction import SceneInteractionNet
from ..utils.spans import span


class NormConfig(NamedTuple):
    """Normalization constants (state 6-dim, attributes 2-dim)."""

    state_mean: Tuple[float, ...]
    state_std: Tuple[float, ...]
    att_mean: Tuple[float, ...]
    att_std: Tuple[float, ...]

    @classmethod
    def from_normalizers(cls, state_norm, att_norm):
        return cls(tuple(state_norm.mean_np.tolist()),
                   tuple(state_norm.std_np.tolist()),
                   tuple(att_norm.mean_np.tolist()),
                   tuple(att_norm.std_np.tolist()))


def init_model_params(model, seed=0):
    """Draw the model's weights, in place, from the distributions of
    strive_tpu's ``init_model_params`` (Flax's defaults): each Linear and
    Conv2d weight LeCun-normal (a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in), every bias 0, every
    LayerNorm and GroupNorm scale 1. The draws come from a CPU generator
    seeded ``seed``, leaf by leaf in ``named_parameters`` order, and are
    copied to the model's device, so every device gets the same weights.
    """
    gen = torch.Generator().manual_seed(seed)
    norms = (nn.LayerNorm, nn.GroupNorm)
    with torch.no_grad():
        for mod in model.modules():
            for name, p in mod.named_parameters(recurse=False):
                if name == "bias":
                    val = torch.zeros(p.shape)
                elif isinstance(mod, norms):
                    val = torch.ones(p.shape)
                elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                    fan_in = p[0].numel()
                    val = nn.init.trunc_normal_(torch.empty(p.shape),
                                                generator=gen)
                    val = val * (math.sqrt(1.0 / fan_in)
                                 / .87962566103423978)
                else:
                    raise TypeError(f"no Flax initializer for {name} of "
                                    f"{type(mod).__name__}")
                p.copy_(val)


class TrafficModel(nn.Module):
    """:param map_channels: channels of the map crop (the Flax model infers
    them from its first crop; torch needs them up front)
    :param device: where the parameters live ('cuda' by default)."""

    def __init__(self, npast, nfuture, map_obs_size_pix, nclasses,
                 norm: NormConfig, bike: BikeParams = NUSC_BIKE_PARAMS,
                 map_feat_size=64, past_feat_size=64, future_feat_size=64,
                 latent_size=32, output_bicycle=True, traj_encoder="mlp",
                 map_bounds=DEFAULT_BOUNDS,
                 conv_kernels=(7, 5, 5, 3, 3, 3),
                 conv_strides=(2, 2, 2, 2, 2, 2),
                 conv_filters=(16, 32, 64, 64, 128, 128),
                 num_memory_layers=3, compute_dtype=None,
                 map_refresh_every=1, map_channels=4, device="cuda"):
        super().__init__()
        if traj_encoder not in ("mlp", "gru"):
            raise ValueError(f"unknown traj encoder {traj_encoder}")
        cdt = None if compute_dtype is None else getattr(torch, compute_dtype)
        self.compute_dtype = cdt
        self.output_bicycle = output_bicycle
        self.traj_encoder = traj_encoder
        self.map_refresh_every = int(map_refresh_every)
        self.npast, self.nfuture = npast, nfuture
        self.map_obs_size_pix = map_obs_size_pix
        self.nclasses = nclasses
        self.norm = norm
        self.bike = bike
        self.map_feat_size = map_feat_size
        self.past_feat_size = past_feat_size
        self.latent_size = latent_size
        self.map_bounds = tuple(map_bounds)
        self.num_memory_layers = num_memory_layers
        self.map_channels = map_channels

        nc = nclasses
        self.map_encoder = MapEncoder(map_channels, map_obs_size_pix,
                                      map_feat_size, conv_kernels,
                                      conv_strides, conv_filters, dtype=cdt)
        if traj_encoder == "mlp":
            self.past_encoder = MLP(npast * 9 + nc,
                                    (128, 128, 128, past_feat_size))
            self.future_encoder = MLP(nfuture * 9 + nc,
                                      (128, 128, 128, future_feat_size))
        else:  # names of the Flax tree: past_gru, past_out, ...
            self.past_gru = StackedGRU(9 + nc, 128, 4)
            self.past_out = nn.Linear(128, past_feat_size)
            self.future_gru = StackedGRU(9 + nc, 128, 4)
            self.future_out = nn.Linear(128, future_feat_size)
        msg = 2 * past_feat_size
        self.prior_net = SceneInteractionNet(
            past_feat_size + map_feat_size + nc, nc, msg, 2 * latent_size)
        self.posterior_net = SceneInteractionNet(
            past_feat_size + future_feat_size + map_feat_size + nc, nc, msg,
            2 * latent_size)
        self.decoder_net = SceneInteractionNet(
            past_feat_size + map_feat_size + nc + latent_size + 2, nc, 64,
            2 if output_bicycle else 4, dtype=cdt)
        self.decoder_memory = StackedGRU(4, past_feat_size, num_memory_layers)

        f32 = dict(dtype=torch.float32)
        self.register_buffer("smean", torch.tensor(norm.state_mean, **f32),
                             persistent=False)
        self.register_buffer("sstd", torch.tensor(norm.state_std, **f32),
                             persistent=False)
        self.register_buffer("amean", torch.tensor(norm.att_mean, **f32),
                             persistent=False)
        self.register_buffer("astd", torch.tensor(norm.att_std, **f32),
                             persistent=False)
        self.to(device)

    # ---- normalization helpers ------------------------------------------
    def state_unnorm(self, x):
        d = x.shape[-1]
        return x * self.sstd[:d] + self.smean[:d]

    def state_norm_(self, x):
        d = x.shape[-1]
        return (x - self.smean[:d]) / self.sstd[:d]

    def att_unnorm(self, lw):
        return lw * self.astd + self.amean

    # ---- encoders --------------------------------------------------------
    def encode_map(self, pos, map_idx, map_store):
        """Local map feature around each (NORMALIZED) pose.

        :param pos: (B, NA, 4)
        :return: (B, NA, map_feat_size)
        """
        B, NA, _ = pos.shape
        pos_unnorm = self.state_unnorm(pos).reshape(B * NA, 4)
        mapixes = torch.repeat_interleave(map_idx, NA)
        # the crop comes out in the compute dtype (0/1 values: exact)
        with span("map.crop"):
            crop = get_map_crop(
                map_store.packed, map_store.dx, pos_unnorm, mapixes,
                self.map_bounds, self.map_channels, L=self.map_obs_size_pix,
                W=self.map_obs_size_pix, layout="nhwc",
                dtype=self.compute_dtype or torch.float32)
        # NCHW view of the NHWC crop: channels_last memory, no copy
        with span("map.cnn"):
            feat = self.map_encoder(crop.permute(0, 3, 1, 2))
        return feat.reshape(B, NA, self.map_feat_size)

    def _local_traj_feat(self, frame, traj, vis, lw, sem, name):
        """Transform traj into ``frame``, zero invisible steps, append
        vis + lw, then encode with the ``name`` ('past' or 'future') MLP
        (flattened) or GRU (step by step from zero states, the output layer
        on the last output)."""
        B, NA, T, _ = traj.shape
        local_kin = transform2frame(frame.reshape(B * NA, 4),
                                    traj[..., :4].reshape(B * NA, T, 4)
                                    ).reshape(B, NA, T, 4)
        local = torch.cat([local_kin, traj[..., 4:]], dim=-1)
        local = torch.where(vis[..., None] == 0.0, 0.0, local)
        local = torch.cat([local, vis[..., None]], dim=-1)
        att = lw[:, :, None, :].expand(B, NA, T, 2)
        enc_in = torch.cat([local, att], dim=-1)  # (B, NA, T, 9)
        if self.traj_encoder == "mlp":
            return getattr(self, f"{name}_encoder")(
                torch.cat([enc_in.reshape(B, NA, T * 9), sem], dim=-1))
        gru = getattr(self, f"{name}_gru")
        hs = enc_in.new_zeros((gru.num_layers, B, NA, 128))
        xs = torch.cat([enc_in, sem[:, :, None, :].expand(
            B, NA, T, sem.shape[-1])], dim=-1)
        for t in range(T):
            out, hs = gru(xs[:, :, t], hs)
        return getattr(self, f"{name}_out")(out)

    def encode_past(self, scene: SceneBatch):
        return self._local_traj_feat(scene.past[:, :, -1, :4], scene.past,
                                     scene.past_vis, scene.lw, scene.sem,
                                     "past")

    def encode_future(self, scene: SceneBatch):
        return self._local_traj_feat(scene.past[:, :, -1, :4], scene.future,
                                     scene.future_vis, scene.lw, scene.sem,
                                     "future")

    # ---- latent heads ----------------------------------------------------
    def prior(self, scene: SceneBatch, map_feat, past_feat):
        x = torch.cat([past_feat, map_feat, scene.sem], dim=-1)
        out = self.prior_net(x, scene.past[:, :, -1, :4], scene.sem,
                             scene.mask)
        mean, logvar = out.chunk(2, dim=-1)
        return mean, torch.exp(logvar)

    def encoder(self, scene: SceneBatch, map_feat, past_feat, future_feat):
        x = torch.cat([past_feat, future_feat, map_feat, scene.sem], dim=-1)
        out = self.posterior_net(x, scene.past[:, :, -1, :4], scene.sem,
                                 scene.mask)
        mean, logvar = out.chunk(2, dim=-1)
        return mean, torch.exp(logvar)

    # ---- decoder ---------------------------------------------------------
    def decoder(self, scene: SceneBatch, map_feat, past_feat, z, map_store,
                ext_future: Optional[torch.Tensor] = None,
                nfuture: Optional[int] = None, copies: int = 1):
        """Autoregressive rollout (reference :589-704).

        :param z: (B, NA, z) latents
        :param ext_future: optional (B, FT, 4) NORMALIZED planner future
            injected into agent 0 of each scene. The ego's recorded output
            stays the model's own prediction; the next step's GNN pose, map
            crop and GRU-memory input see the external future; the bicycle
            state keeps the model's own rollout (reference :667-680), the
            direct output (``output_bicycle=False``) continues from the
            injected pose.
        :param copies: the batch is ``copies`` copies of equal value of
            B / copies scenes, copy-major (every input, ``z`` included).
            Each refresh crops and encodes the map at copy 0's poses alone
            and repeats the feature to the other copies: the crop takes
            detached poses, so the map branch carries no gradient that
            could tell the copies apart (``optim/adv.py`` decodes two, one
            for each loss, and pulls both back in one pass).
        :return: (B, NA, FT, 4) NORMALIZED global-frame trajectories.
        """
        with span("model.decode"):
            B, NA = z.shape[:2]
            FT = self.nfuture if nfuture is None else nfuture
            k = self.map_refresh_every
            if FT % k != 0:
                k = 1  # per-step refresh when k does not divide FT
            sem, lw, mask = scene.sem, scene.lw, scene.mask
            veh_len = self.att_unnorm(lw)[..., 0]

            prev_state = scene.past[:, :, -1, :]  # (B, NA, 6) normalized
            pos = prev_state[..., :4]
            mem = past_feat[None].expand(self.num_memory_layers, B, NA,
                                         self.past_feat_size)
            cur_past_feat, cur_map_feat = past_feat, map_feat
            outs = []
            for t in range(FT):
                dec_in = torch.cat([cur_past_feat, cur_map_feat, sem, z, lw],
                                   dim=-1)
                with span("decode.gnn"):
                    dec_out = self.decoder_net(dec_in, pos, sem, mask)
                with span("decode.bicycle"):
                    prev_pose = prev_state[..., :4].reshape(B * NA, 4)
                    if self.output_bicycle:
                        new_bike = bike_step(self.state_unnorm(prev_state),
                                             dec_out[..., 0], dec_out[..., 1],
                                             veh_len, self.bike)
                        next_prev = self.state_norm_(new_bike)
                        cur_global = next_prev[..., :4]
                        cur_local = transform2frame(
                            prev_pose, cur_global.reshape(B * NA, 1, 4)
                        )[:, 0].reshape(B, NA, 4)
                    else:
                        cur_local = normalize_heading(dec_out)
                        cur_global = transform2frame(
                            prev_pose, cur_local.reshape(B * NA, 1, 4),
                            inverse=True)[:, 0].reshape(B, NA, 4)
                        next_prev = cur_global
                outs.append(cur_global)  # recorded BEFORE external injection

                if ext_future is not None:
                    ext_t = ext_future[:, t]
                    inj_local_ego = transform2frame(prev_state[:, 0, :4],
                                                    ext_t[:, None])[:, 0]
                    cur_global = torch.cat([ext_t[:, None],
                                            cur_global[:, 1:]], 1)
                    cur_local = torch.cat([inj_local_ego[:, None],
                                           cur_local[:, 1:]], 1)
                    if not self.output_bicycle:
                        next_prev = cur_global

                with span("decode.gru"):
                    cur_past_feat, mem = self.decoder_memory(cur_local, mem)
                if t % k == k - 1 and copies == 1:
                    cur_map_feat = self.encode_map(cur_global.detach(),
                                                   scene.map_idx, map_store)
                elif t % k == k - 1:  # copy 0's feature, to every copy
                    n = B // copies
                    cur_map_feat = self.encode_map(
                        cur_global[:n].detach(), scene.map_idx[:n],
                        map_store).repeat(copies, 1, 1)
                prev_state, pos = next_prev, cur_global
            return torch.stack(outs, dim=2)

    # ---- public API ------------------------------------------------------
    def forward(self, scene: SceneBatch, map_store, eps=None, generator=None,
                use_post_mean=False, future_sample=False, eps_samp=None):
        """Training forward pass (reference :178-225).

        :param eps: optional (B, NA, latent) posterior noise; drawn from
            ``generator`` when None
        :param eps_samp: optional prior noise for ``future_sample``
        """
        map_feat = self.encode_map(scene.past[:, :, -1, :4], scene.map_idx,
                                   map_store)
        past_feat = self.encode_past(scene)
        future_feat = self.encode_future(scene)
        prior_mu, prior_var = self.prior(scene, map_feat, past_feat)
        post_mu, post_var = self.encoder(scene, map_feat, past_feat,
                                         future_feat)

        def noise(e, like):
            if e is None:
                e = torch.randn(like.shape, generator=generator,
                                device=like.device, dtype=like.dtype)
            return e

        if use_post_mean:
            z = post_mu
        else:
            z = post_mu + noise(eps, post_mu) * torch.sqrt(post_var)
        out = {
            "prior_out": (prior_mu, prior_var),
            "posterior_out": (post_mu, post_var),
            "future_pred": self.decoder(scene, map_feat, past_feat, z,
                                        map_store),
        }
        if future_sample:
            zp = prior_mu + noise(eps_samp, prior_mu) * torch.sqrt(prior_var)
            out["future_samp"] = self.decoder(scene, map_feat, past_feat, zp,
                                              map_store)
        return out

    def reconstruct(self, scene: SceneBatch, map_store):
        """Posterior-mean reconstruction (reference :227-257)."""
        map_feat = self.encode_map(scene.past[:, :, -1, :4], scene.map_idx,
                                   map_store)
        past_feat = self.encode_past(scene)
        post_mu, post_var = self.encoder(scene, map_feat, past_feat,
                                         self.encode_future(scene))
        return {"posterior_out": (post_mu, post_var),
                "future_pred": self.decoder(scene, map_feat, past_feat,
                                            post_mu, map_store)}

    def embed(self, scene: SceneBatch, map_store):
        """Prior (+posterior if future present) embedding (reference :372-403)."""
        with span("model.embed"):
            map_feat = self.encode_map(scene.past[:, :, -1, :4],
                                       scene.map_idx, map_store)
            past_feat = self.encode_past(scene)
            out = {
                "prior_out": self.prior(scene, map_feat, past_feat),
                "map_feat": map_feat,
                "past_feat": past_feat,
            }
            if scene.future is not None:
                out["posterior_out"] = self.encoder(
                    scene, map_feat, past_feat, self.encode_future(scene))
            return out

    def decode_embedding(self, z, embed_out, scene: SceneBatch, map_store,
                         ext_future=None, nfuture=None):
        """Decode latents using cached embed() features (reference :405-414).

        :param z: (B, NA, D), or (B, NS, NA, D) with a sample axis (folded
            into the batch axis, module doc)
        :return: {'future_pred': (B, [NS,] NA, FT, 4)}
        """
        if z.dim() == 4:
            B, NS, NA, D = z.shape
            rep = torch.arange(B, device=z.device).repeat_interleave(NS)
            fp = self.decoder(
                scene.take(rep), embed_out["map_feat"][rep],
                embed_out["past_feat"][rep], z.reshape(B * NS, NA, D),
                map_store,
                ext_future=None if ext_future is None else ext_future[rep],
                nfuture=nfuture)
            return {"future_pred": fp.reshape(B, NS, *fp.shape[1:])}
        return {"future_pred": self.decoder(
            scene, embed_out["map_feat"], embed_out["past_feat"], z,
            map_store, ext_future=ext_future, nfuture=nfuture)}

    def sample_batched(self, scene: SceneBatch, map_store, num_samples,
                       include_mean=False, nfuture=None, eps=None,
                       generator=None):
        """Prior sampling, NS samples a scene (reference :319-370).

        :param eps: optional (B, NS, NA, D) standard-normal noise; drawn
            from ``generator`` when None
        :param include_mean: the last sample is the prior mean
        :return: dict with prior_out, z_samp (B, NS, NA, D), z_logprob and
            z_mdist (B, NS, NA), future_pred (B, NS, NA, FT, 4)
        """
        embed_out = self.embed(scene, map_store)
        prior_mu, prior_var = embed_out["prior_out"]
        B, NA, D = prior_mu.shape
        if eps is None:
            eps = torch.randn((B, num_samples, NA, D), generator=generator,
                              device=prior_mu.device, dtype=prior_mu.dtype)
        z = prior_mu[:, None] + eps * torch.sqrt(prior_var[:, None])
        if include_mean:
            z = torch.cat([z[:, :-1], prior_mu[:, None]], dim=1)
        dec = self.decode_embedding(z, embed_out, scene, map_store,
                                    nfuture=nfuture)
        z_logprob = log_normal(z, prior_mu[:, None], prior_var[:, None])
        z_mdist = torch.linalg.vector_norm(
            (z - prior_mu[:, None]) / torch.sqrt(prior_var[:, None]), dim=-1)
        return {
            "prior_out": (prior_mu, prior_var),
            "z_samp": z,
            "z_logprob": z_logprob,
            "z_mdist": z_mdist,
            "future_pred": dec["future_pred"],
        }
