"""Plain float32 PyTorch of STRIVE's traffic model: the check's reference.

STRIVE's CVAE traffic prior (nv-tlabs/STRIVE ``models/traffic_model.py``,
``models/interaction_net.py``, ``models/common.py``) written out as
functions of a parameter dict, with no kernel, cache or batching trick.
It imports nothing of the measured program and nothing of JAX.

- map encoder: an oriented crop of the raster around each pose (nearest
  pixel, half to even; off-map samples read pixel (0, 0)), then
  (conv VALID, GroupNorm(1), ReLU) x 6, an NHWC flatten and a Linear;
- trajectory encoders: the past / future in the frame of the last past
  pose, unseen frames zeroed, flattened into an MLP (Linear, then
  (LayerNorm, ReLU, Linear) per further layer);
- prior, posterior and decoder nets: one round of dense message passing
  (edge MLP over all ordered pairs, masked max, update MLP) between two
  MLPs;
- decoder: 12 autoregressive steps of the decoder net, a kinematic
  bicycle step, a 3-layer GRU memory of the local motion, and a fresh map
  feature at the new (detached) pose. An external ego future, when
  given, replaces the ego's pose after its step is recorded.

A model's ``precision`` selects the arithmetic of every matrix product
and convolution: 'float32' (the configuration's), or 'tf32', the
control, whose operands (and, going backward, the product's output
gradient) are rounded to TF32's 10-bit mantissa first, as the tensor
cores do when TF32 is switched on.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

def tf32(x):
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero, as ``cvt.rna.tf32.f32``)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _Round(torch.autograd.Function):
    """TF32 operands: rounded forward, the gradient passed through."""

    @staticmethod
    def forward(ctx, x):
        return tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """The product's output gradient rounded to TF32, as the backward
    products read it."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return tf32(g)


def _product(prec, fn, x, w, *args):
    if prec == "float32":
        return fn(x, w, *args)
    if prec != "tf32":
        raise ValueError(f"unknown precision {prec!r}")
    return _RoundGrad.apply(fn(_Round.apply(x), _Round.apply(w), *args))


def linear(x, w, b, prec="float32"):
    return _product(prec, F.linear, x, w, b)


def conv(x, w, b, stride, prec="float32"):
    return _product(prec, F.conv2d, x, w, b, stride)


# ---- parameters ------------------------------------------------------------

def _mlp_shapes(pre, d_in, widths):
    out = [(f"{pre}.fc0.weight", (widths[0], d_in)),
           (f"{pre}.fc0.bias", (widths[0],))]
    for i in range(1, len(widths)):
        out += [(f"{pre}.ln{i}.weight", (widths[i - 1],)),
                (f"{pre}.ln{i}.bias", (widths[i - 1],)),
                (f"{pre}.fc{i}.weight", (widths[i], widths[i - 1])),
                (f"{pre}.fc{i}.bias", (widths[i],))]
    return out


def _gnn_shapes(pre, d_in, nc, msg, d_out):
    return (_mlp_shapes(f"{pre}.mlp_in", d_in, (128, 128, msg))
            + _mlp_shapes(f"{pre}.conv0.edge_mlp", 2 * msg + 2 * nc + 4,
                          (128, 128, msg))
            + _mlp_shapes(f"{pre}.conv0.update_mlp", 2 * msg + nc,
                          (128, msg))
            + _mlp_shapes(f"{pre}.mlp_out", msg, (128, 128, d_out)))


def cnn_sizes(m):
    """[(c_in, c_out, kernel, stride, out_px)] of the map encoder's convs
    and the width of its flattened output."""
    px, cin, out = m["map_obs_size_pix"], m["map_channels"], []
    for k, s, f in zip(m["conv_kernel_list"], m["conv_stride_list"],
                       m["conv_filter_list"]):
        px = (px - k) // s + 1
        out.append((cin, f, k, s, px))
        cin = f
    return out, px * px * cin


def param_shapes(m):
    """{name: shape} of every parameter, in the order the weights are drawn.

    :param m: the configuration's ``model`` dict
    """
    nc, lat = len(m["agent_types"]), m["latent_size"]
    pf, ff, mf = m["past_feat_size"], m["future_feat_size"], m["map_feat_size"]
    convs, flat = cnn_sizes(m)
    out = []
    for i, (cin, f, k, _, _) in enumerate(convs):
        out += [(f"map_encoder.conv{i}.weight", (f, cin, k, k)),
                (f"map_encoder.conv{i}.bias", (f,)),
                (f"map_encoder.gn{i}.weight", (f,)),
                (f"map_encoder.gn{i}.bias", (f,))]
    out += [("map_encoder.out.weight", (mf, flat)),
            ("map_encoder.out.bias", (mf,))]
    out += _mlp_shapes("past_encoder", m["past_len"] * 9 + nc,
                       (128, 128, 128, pf))
    out += _mlp_shapes("future_encoder", m["future_len"] * 9 + nc,
                       (128, 128, 128, ff))
    out += _gnn_shapes("prior_net", pf + mf + nc, nc, 2 * pf, 2 * lat)
    out += _gnn_shapes("posterior_net", pf + ff + mf + nc, nc, 2 * pf,
                       2 * lat)
    out += _gnn_shapes("decoder_net", pf + mf + nc + lat + 2, nc, 64, 2)
    for l in range(m["num_memory_layers"]):
        d_in = 4 if l == 0 else pf
        out += [(f"decoder_memory.layer{l}.ih.weight", (3 * pf, d_in)),
                (f"decoder_memory.layer{l}.ih.bias", (3 * pf,)),
                (f"decoder_memory.layer{l}.hh.weight", (3 * pf, pf)),
                (f"decoder_memory.layer{l}.hh.bias", (3 * pf,))]
    return OrderedDict(out)


# ---- frames ----------------------------------------------------------------

def to_frame(frame, poses, inverse=False):
    """(B, 4) frames, (B, N, 4) poses (x, y, hx, hy) -> poses in (or, with
    ``inverse``, out of) each frame."""
    fc, fs = frame[:, 2:3], frame[:, 3:4]
    fx, fy = frame[:, 0:1], frame[:, 1:2]
    pc, ps = poses[..., 2], poses[..., 3]
    px, py = poses[..., 0], poses[..., 1]
    if inverse:
        return torch.stack([fc * px - fs * py + fx, fs * px + fc * py + fy,
                            pc * fc - ps * fs, ps * fc + pc * fs], -1)
    dx, dy = px - fx, py - fy
    return torch.stack([fc * dx + fs * dy, -fs * dx + fc * dy,
                        pc * fc + ps * fs, ps * fc - pc * fs], -1)


def pairwise(poses):
    """(B, N, 4) -> (B, N, N, 4): pose of j in the frame of i."""
    c, s = poses[..., 2], poses[..., 3]
    ci, si, cj, sj = c[:, :, None], s[:, :, None], c[:, None, :], s[:, None, :]
    x, y = poses[..., 0], poses[..., 1]
    dx = x[:, None, :] - x[:, :, None]
    dy = y[:, None, :] - y[:, :, None]
    return torch.stack([ci * dx + si * dy, -si * dx + ci * dy,
                        cj * ci + sj * si, sj * ci - cj * si], -1)


# ---- map crops ---------------------------------------------------------------

def linspace(start, stop, num, device):
    """float32 ``start * (1 - i/(num-1)) + stop * (i/(num-1))``, the last
    value exactly ``stop`` (``jnp.linspace``'s formula), on the host."""
    div = num - 1
    i = torch.arange(div, dtype=torch.float32) / torch.tensor(
        float(div), dtype=torch.float32)
    v = (torch.tensor(start, dtype=torch.float32) * (1 - i)
         + torch.tensor(stop, dtype=torch.float32) * i)
    return torch.cat([v, torch.tensor([stop], dtype=torch.float32)]).to(device)


def rotate_grid(lwise, wwise, xy, h):
    """World coords of offsets along (``lwise``) and across (``wwise``)
    each heading ``h`` from ``xy``: (B, L, W, 2)."""
    hc, hs = h[:, 0][:, None, None], h[:, 1][:, None, None]
    gx = lwise * hc - wwise * hs + xy[:, 0][:, None, None]
    gy = lwise * hs + wwise * hc + xy[:, 1][:, None, None]
    return torch.stack(torch.broadcast_tensors(gx, gy), -1)


def pixels(raster, dx, xys, mapix):
    """(map, row, col) of world coords; world x over dx[m, 0] gives the
    column, y over dx[m, 1] the row; off-map samples read (0, 0)."""
    H, W = raster.shape[-2:]
    extra = (1,) * (xys.dim() - 2)
    d = dx[mapix]
    px = torch.round(xys[..., 0] / d[:, 0].reshape((-1,) + extra))
    py = torch.round(xys[..., 1] / d[:, 1].reshape((-1,) + extra))
    inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    px = torch.where(inside, px, 0.0).long()
    py = torch.where(inside, py, 0.0).long()
    return mapix.reshape((-1,) + extra).long(), py, px


def crop(raster, dx, pos, mapix, bounds, px):
    """(N, C, px, px) float32 crops of the (M, C, H, W) raster around the
    (N, 4) unnormalized poses."""
    lo = linspace(bounds[0], bounds[2], px, pos.device)
    wo = linspace(bounds[1], bounds[3], px, pos.device)
    xys = rotate_grid(lo[None, :, None], wo[None, None, :], pos[:, :2],
                      pos[:, 2:4])
    xys = torch.where(torch.isnan(xys), 0.0, xys)
    m, py, px_ = pixels(raster, dx, xys, mapix)
    out = torch.stack([raster[:, c][m, py, px_]
                       for c in range(raster.shape[1])], 1)
    return out.float()


# ---- blocks ----------------------------------------------------------------

def mlp(p, pre, x, n, prec="float32"):
    x = linear(x, p[f"{pre}.fc0.weight"], p[f"{pre}.fc0.bias"], prec)
    for i in range(1, n):
        ln = f"{pre}.ln{i}"
        x = F.layer_norm(x, x.shape[-1:], p[f"{ln}.weight"], p[f"{ln}.bias"],
                         1e-5)
        x = linear(F.relu(x), p[f"{pre}.fc{i}.weight"],
                   p[f"{pre}.fc{i}.bias"], prec)
    return x


def map_encoder(p, m, crops, prec="float32"):
    convs, _ = cnn_sizes(m)
    x = crops
    for i, (_, _, _, s, _) in enumerate(convs):
        x = conv(x, p[f"map_encoder.conv{i}.weight"],
                 p[f"map_encoder.conv{i}.bias"], s, prec)
        x = F.relu(F.group_norm(x, 1, p[f"map_encoder.gn{i}.weight"],
                                p[f"map_encoder.gn{i}.bias"], 1e-5))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return linear(x, p["map_encoder.out.weight"], p["map_encoder.out.bias"],
                  prec)


def gnn(p, pre, x, pos, sem, mask, prec="float32"):
    x = mlp(p, f"{pre}.mlp_in", x, 3, prec)
    B, N, D = x.shape
    C = sem.shape[-1]
    rel = pairwise(pos)
    rel = torch.where(torch.isnan(rel), 0.0, rel)
    msg = mlp(p, f"{pre}.conv0.edge_mlp", torch.cat([
        x[:, :, None].expand(B, N, N, D), x[:, None].expand(B, N, N, D),
        sem[:, :, None].expand(B, N, N, C), sem[:, None].expand(B, N, N, C),
        rel], -1), 3, prec)
    eye = torch.eye(N, dtype=torch.bool, device=x.device)
    pair = mask[:, :, None] & mask[:, None, :] & ~eye
    aggr = torch.amax(torch.where(pair[..., None], msg,
                                  torch.finfo(msg.dtype).min), 2)
    aggr = torch.where(pair.any(2)[..., None], aggr, 0.0)
    x = mlp(p, f"{pre}.conv0.update_mlp", torch.cat([x, aggr, sem], -1), 2,
            prec)
    return mlp(p, f"{pre}.mlp_out", x, 3, prec)


def gru(p, m, x, hs, prec="float32"):
    """One step of the stacked GRU memory; gates (r, z, n) as torch.nn.GRU."""
    new, inp = [], x
    for l in range(m["num_memory_layers"]):
        pre = f"decoder_memory.layer{l}"
        xr, xz, xn = linear(inp, p[f"{pre}.ih.weight"],
                            p[f"{pre}.ih.bias"], prec).chunk(3, -1)
        hr, hz, hn = linear(hs[l], p[f"{pre}.hh.weight"],
                            p[f"{pre}.hh.bias"], prec).chunk(3, -1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        inp = (1.0 - z) * n + z * hs[l]
        new.append(inp)
    return inp, torch.stack(new, 0)


def bike(state, a_n, ddh_n, length, b):
    """One Euler step of the kinematic bicycle on the unnormalized
    (x, y, hx, hy, s, hdot) state; speed clamped to [0, maxs]."""
    a = a_n * b["a_std"] + b["a_mean"]
    ddh = ddh_n * b["ddh_std"] + b["ddh_mean"]
    x, y, s, hdot = state[..., 0], state[..., 1], state[..., 4], state[..., 5]
    h = torch.atan2(state[..., 3], state[..., 2])
    dt = b["dt"]
    hdot = torch.clamp(hdot + ddh * dt, -b["maxhdot"], b["maxhdot"])
    h = h + dt * torch.abs(s) / length * hdot
    s = torch.clamp(s + a * dt, 0.0, b["maxs"])
    y = y + s * torch.sin(h) * dt
    x = x + s * torch.cos(h) * dt
    return torch.stack([x, y, torch.cos(h), torch.sin(h), s, hdot], -1)


class Model:
    """The traffic model of configuration ``m`` with parameters ``p``
    (name -> float32 tensor), reading the unpacked ``raster`` (M, C, H, W)
    uint8 and ``dx`` (M, 2); its products in ``precision``."""

    def __init__(self, m, p, raster, dx, precision="float32"):
        self.m, self.p, self.raster, self.dx = m, p, raster, dx
        self.prec = precision
        dev = raster.device
        st, at = m["norm"]["state"], m["norm"]["att"]
        self.smean = torch.tensor(st["mean"], dtype=torch.float32, device=dev)
        self.sstd = torch.tensor(st["std"], dtype=torch.float32, device=dev)
        self.amean = torch.tensor(at["mean"], dtype=torch.float32, device=dev)
        self.astd = torch.tensor(at["std"], dtype=torch.float32, device=dev)

    def unnorm(self, x):
        d = x.shape[-1]
        return x * self.sstd[:d] + self.smean[:d]

    def norm(self, x):
        d = x.shape[-1]
        return (x - self.smean[:d]) / self.sstd[:d]

    def att_unnorm(self, lw):
        return lw * self.astd + self.amean

    def encode_map(self, pos, map_idx, at=None):
        """Map features of the crops around the normalized (B, N, 4)
        ``pos``, or around ``at``, (B * N, 4) unnormalized poses."""
        B, N, _ = pos.shape
        if at is None:
            at = self.unnorm(pos).reshape(B * N, 4)
        crops = crop(self.raster, self.dx, at,
                     torch.repeat_interleave(map_idx, N),
                     self.m["map_obs_bounds"], self.m["map_obs_size_pix"])
        return map_encoder(self.p, self.m, crops, self.prec).reshape(B, N, -1)

    def encode_traj(self, sc, traj, vis, name):
        frame = sc["past"][:, :, -1, :4]
        B, N, T, _ = traj.shape
        loc = to_frame(frame.reshape(B * N, 4),
                       traj[..., :4].reshape(B * N, T, 4)).reshape(B, N, T, 4)
        loc = torch.cat([loc, traj[..., 4:]], -1)
        loc = torch.where(vis[..., None] == 0.0, 0.0, loc)
        x = torch.cat([loc, vis[..., None],
                       sc["lw"][:, :, None].expand(B, N, T, 2)], -1)
        return mlp(self.p, f"{name}_encoder",
                   torch.cat([x.reshape(B, N, T * 9), sc["sem"]], -1), 4,
                   self.prec)

    def latent(self, sc, name, feats):
        out = gnn(self.p, name, torch.cat(feats + [sc["sem"]], -1),
                  sc["past"][:, :, -1, :4], sc["sem"], sc["mask"], self.prec)
        mean, logvar = out.chunk(2, -1)
        return mean, torch.exp(logvar)

    def embed(self, sc):
        """Map and past features, prior and posterior (mean, var)."""
        mapf = self.encode_map(sc["past"][:, :, -1, :4], sc["map_idx"])
        pastf = self.encode_traj(sc, sc["past"], sc["past_vis"], "past")
        futf = self.encode_traj(sc, sc["future"], sc["future_vis"], "future")
        return {"map": mapf, "past": pastf,
                "prior": self.latent(sc, "prior_net", [pastf, mapf]),
                "post": self.latent(sc, "posterior_net",
                                    [pastf, futf, mapf])}

    def decode(self, sc, emb, z, ext=None, crop_at=None):
        """(B, N, FT, 4) normalized rollout of latents ``z``; ``ext``: an
        optional (B, FT, 4) normalized ego future injected after each
        step is recorded. ``crop_at``: optional FT (B * N, 4) unnormalized
        poses to crop at in place of the rollout's own; either way the
        rollout's own crop poses are left in ``self.poses``."""
        m = self.m
        L, pf = m["num_memory_layers"], m["past_feat_size"]
        sem, lw, mask = sc["sem"], sc["lw"], sc["mask"]
        length = self.att_unnorm(lw)[..., 0]
        B, N = z.shape[:2]
        prev = sc["past"][:, :, -1, :]
        pos = prev[..., :4]
        mem = emb["past"][None].expand(L, B, N, pf)
        pastf, mapf = emb["past"], emb["map"]
        outs, self.poses = [], []
        for t in range(m["future_len"]):
            out = gnn(self.p, "decoder_net",
                      torch.cat([pastf, mapf, sem, z, lw], -1), pos, sem,
                      mask, self.prec)
            nxt = self.norm(bike(self.unnorm(prev), out[..., 0],
                                 out[..., 1], length, m["bike"]))
            glob = nxt[..., :4]
            loc = to_frame(prev[..., :4].reshape(B * N, 4),
                           glob.reshape(B * N, 1, 4))[:, 0].reshape(B, N, 4)
            outs.append(glob)
            if ext is not None:
                e = ext[:, t]
                ego_loc = to_frame(prev[:, 0, :4], e[:, None])[:, 0]
                glob = torch.cat([e[:, None], glob[:, 1:]], 1)
                loc = torch.cat([ego_loc[:, None], loc[:, 1:]], 1)
            pastf, mem = gru(self.p, m, loc, mem, self.prec)
            self.poses.append(self.unnorm(glob.detach()).reshape(B * N, 4))
            mapf = self.encode_map(glob.detach(), sc["map_idx"],
                                   None if crop_at is None else crop_at[t])
            prev, pos = nxt, glob
        return torch.stack(outs, 2)


def log_normal(x, m, v):
    return torch.sum(-torch.log(torch.sqrt(v)) - math.log(math.sqrt(2 * math.pi))
                     - (x - m) ** 2 / (2 * v), -1)


def kl_normal(qm, qv, pm, pv):
    return torch.sum(0.5 * (torch.log(pv) - torch.log(qv) + qv / pv
                            + (qm - pm) ** 2 / pv - 1.0), -1)
