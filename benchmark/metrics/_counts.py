"""Work counted from the configuration's shapes, whatever implements it.

FLOPs are those of the matrix products and convolutions (two a
multiply-add); normalizations, activations, the bicycle step, the losses
and Adam are left out, so the counts are floors of the arithmetic done.
A backward pass through a layer costs one forward for the input's
gradient, where the input carries one, and one for the weight's
gradient, where the weight is trained.

K1's bytes are what its launch must move at least: the distinct raster
bytes its samples read (this run's poses), its other inputs once, and its
output once (``chip_smoke.py``'s bound).
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12   # H100 SXM, float32 without tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3


def mlp(d_in, widths):
    f, d = 0, d_in
    for w in widths:
        f += 2 * d * w
        d = w
    return f


def mlp_first(d_in, widths):
    return 2 * d_in * widths[0]


def gnn(m, N, d_in, msg, d_out):
    """One scene of N agents through an interaction net."""
    nc = len(m["agent_types"])
    return (N * mlp(d_in, (128, 128, msg))
            + N * N * mlp(2 * msg + 2 * nc + 4, (128, 128, msg))
            + N * mlp(2 * msg + nc, (128, msg))
            + N * mlp(msg, (128, 128, d_out)))


def conv_layers(m):
    """[(FLOPs, out_px)] of each conv of one crop, and the final Linear's."""
    px, cin, out = m["map_obs_size_pix"], m["map_channels"], []
    for k, s, f in zip(m["conv_kernel_list"], m["conv_stride_list"],
                       m["conv_filter_list"]):
        px = (px - k) // s + 1
        out.append((2 * px * px * f * k * k * cin, px))
        cin = f
    return out, 2 * px * px * cin * m["map_feat_size"]


def cnn(m):
    """One crop through the map encoder."""
    convs, lin = conv_layers(m)
    return sum(f for f, _ in convs) + lin


def gru(m):
    """One agent, one step of the decoder's GRU memory."""
    H = m["past_feat_size"]
    return sum(2 * ((4 if l == 0 else H) + H) * 3 * H
               for l in range(m["num_memory_layers"]))


def _dims(m):
    nc, lat = len(m["agent_types"]), m["latent_size"]
    pf, ff, mf = m["past_feat_size"], m["future_feat_size"], m["map_feat_size"]
    return nc, lat, pf, ff, mf


def decoder_step(m, N):
    """One scene, one rollout step without the map: the decoder net and
    the GRU memory."""
    nc, lat, pf, _, mf = _dims(m)
    return gnn(m, N, pf + mf + nc + lat + 2, 64, 2) + N * gru(m)


def embed(m, N):
    """One scene's embedding: map, past and future encoders, prior and
    posterior nets."""
    nc, lat, pf, ff, mf = _dims(m)
    return (N * cnn(m)
            + N * mlp(m["past_len"] * 9 + nc, (128, 128, 128, pf))
            + N * mlp(m["future_len"] * 9 + nc, (128, 128, 128, ff))
            + gnn(m, N, pf + mf + nc, 2 * pf, 2 * lat)
            + gnn(m, N, pf + ff + mf + nc, 2 * pf, 2 * lat))


def decode(m, N):
    """One scene's forward rollout: each step's nets and a crop an agent."""
    return m["future_len"] * (decoder_step(m, N) + N * cnn(m))


def optim_iteration(m, B, N):
    """One Adam iteration of the adversarial optimization: a forward
    rollout, and two backward pulls for the latents' gradients through
    the nets and the memory (the map branch is detached and the weights
    frozen: input gradients only)."""
    return B * (decode(m, N) + 2 * m["future_len"] * decoder_step(m, N))


def optim_batch(m, B, N):
    """The work of a batch besides its iterations: the embedding and the
    final rollout."""
    return B * (embed(m, N) + decode(m, N))


def train_step(m, B, N):
    """One training step: the embedding and two rollouts forward, then the
    backward pass (weight gradients everywhere, input gradients wherever
    the input carries one: not into the crops nor the trajectory
    encoders' first layers)."""
    nc = len(m["agent_types"])
    crops = B * N * (1 + 2 * m["future_len"])
    fwd = B * (embed(m, N) + 2 * decode(m, N))
    no_dx = (crops * conv_layers(m)[0][0][0]
             + B * N * mlp_first(m["past_len"] * 9 + nc, (128,))
             + B * N * mlp_first(m["future_len"] * 9 + nc, (128,)))
    return fwd + 2 * fwd - no_dx


def crop_bytes(packed_shape, dx, pos, mapix, lo, wo, channels, out_bytes):
    """Least bytes one K1 launch moves: the distinct raster bytes its
    samples read, its inputs once, its output once.

    :param packed_shape: (M, H, W) of the bit-packed raster
    :param pos: (N, 4) unnormalized poses; ``mapix`` (N,)
    """
    import torch

    M, H, W = packed_shape
    hc, hs = pos[:, 2][:, None, None], pos[:, 3][:, None, None]
    lw, ww = lo[None, :, None], wo[None, None, :]
    gx = lw * hc - ww * hs + pos[:, 0][:, None, None]
    gy = lw * hs + ww * hc + pos[:, 1][:, None, None]
    gx = torch.where(torch.isnan(gx), 0.0, gx)
    gy = torch.where(torch.isnan(gy), 0.0, gy)
    d = dx[mapix]
    px = torch.round(gx / d[:, 0, None, None])
    py = torch.round(gy / d[:, 1, None, None])
    inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    idx = (mapix[:, None, None] * H + torch.where(inside, py, 0.0).long()) \
        * W + torch.where(inside, px, 0.0).long()
    distinct = int(torch.unique(idx).numel())
    n_pix = pos.shape[0] * lo.numel() * wo.numel()
    return (distinct + pos.numel() * 4 + mapix.numel() * 8 + dx.numel() * 4
            + (lo.numel() + wo.numel()) * 4 + n_pix * channels * out_bytes)
