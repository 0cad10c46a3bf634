"""``TrafficModel.decoder``'s ``copies`` option, on the CPU.

The adversarial iteration (``optim/adv.py``) decodes two copies of equal
value of its batch in one rollout; the map is cropped and encoded on copy
0 alone and its feature repeated. Held here, at the tiny widths of
tests/test_torch_spans.py (B=2 scenes x NA=4, FT=6), with and without an
injected ego future and at ``map_refresh_every`` 1 and 2:

- the copies equal each other bit for bit and the one-copy decode within
  1e-6 (normalized units; the CPU's GEMM takes another kernel at twice the
  rows);
- each decode crops the map FT / k times, each at the (B*NA, 4) poses of
  copy 0, the contract the benchmark's record of crop poses relies on;
- with one copy, the default, the rollout dispatches the same aten ops in
  the same order as the decoder before the option (kept below), and gives
  the same numbers bit for bit.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from strive_tpu_torch.data.synthetic import synthetic_scene_list
from strive_tpu_torch.dynamics import bike_step
from strive_tpu_torch.geometry import normalize_heading, transform2frame
from strive_tpu_torch.maps.store import synthetic_map_store
from strive_tpu_torch.model import traffic_model
from strive_tpu_torch.model.traffic_model import NormConfig, TrafficModel
from strive_tpu_torch.normalize import (att_normalizer_for,
                                        state_normalizer_for)
from strive_tpu_torch.scene import pad_scene_arrays
from strive_tpu_torch.scripts.common import init_params
from strive_tpu_torch.utils.spans import span

torch.set_num_threads(2)  # tier-1 runs several workers
FT, B, NA = 6, 2, 4
CATS = ("car", "truck")


@pytest.fixture(scope="module")
def tiny():
    sn, an = state_normalizer_for(CATS), att_normalizer_for(CATS)
    models = {}
    for k in (1, 2):
        models[k] = TrafficModel(
            npast=4, nfuture=FT, map_obs_size_pix=64, nclasses=2,
            norm=NormConfig.from_normalizers(sn, an),
            map_bounds=(-4.0, -8.0, 12.0, 8.0), conv_kernels=(5, 3, 3),
            conv_strides=(2, 2, 2), conv_filters=(8, 8, 16), map_channels=3,
            map_refresh_every=k, device="cpu")
        init_params(models[k])
        for p in models[k].parameters():
            p.requires_grad_(False)  # as in the adversarial loop
    store = synthetic_map_store(num_maps=2, size_px=512, channels=3,
                                device="cpu")
    scenes = synthetic_scene_list(num_scenes=B, num_maps=2, map_size_px=512,
                                  PT=4, FT=FT, min_agents=NA, max_agents=NA)
    scene = pad_scene_arrays(scenes, NA, 2, device="cpu")
    with torch.no_grad():
        emb = models[1].embed(scene, store)
    return models, store, scene, emb


def _inputs(tiny, k, ext, copies):
    """The decoder's arguments for ``copies`` copies, copy-major."""
    models, store, scene, emb = tiny
    rep = torch.arange(B).repeat(copies)
    fut = scene.future_gt[:, 0, :, :4] if ext else None
    z = emb["prior_out"][0][rep].clone().requires_grad_(True)
    return (models[k], scene.take(rep), emb["map_feat"][rep],
            emb["past_feat"][rep], z, store,
            None if fut is None else fut[rep])


class CropPoses:
    """The model's map crops while open: each call's (N, 4) poses."""

    def __init__(self, monkeypatch):
        self.poses = []
        orig = traffic_model.get_map_crop

        def recorded(packed, dx, pos, *a, **k):
            self.poses.append(pos)
            return orig(packed, dx, pos, *a, **k)

        monkeypatch.setattr(traffic_model, "get_map_crop", recorded)


class OpLog(TorchDispatchMode):
    """The aten ops dispatched while open, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("ext", [False, True], ids=["own", "injected"])
def test_copies_decode_and_crop_as_copy_zero(tiny, monkeypatch, ext, k):
    model, *args = _inputs(tiny, k, ext, 1)
    rec = CropPoses(monkeypatch)
    with torch.no_grad():
        one = model.decoder(*args, nfuture=FT)
    assert len(rec.poses) == FT // k
    rec.poses.clear()
    model, *args = _inputs(tiny, k, ext, 2)
    with torch.no_grad():
        two = model.decoder(*args, nfuture=FT, copies=2)
    assert torch.equal(two[:B], two[B:])
    torch.testing.assert_close(two[:B], one, rtol=0, atol=1e-6)

    # FT / k crops a decode, each at copy 0's B*NA poses, as the crop sees
    # them: the recorded pose, the injected future in the ego's slot
    assert len(rec.poses) == FT // k
    for i, pos in enumerate(rec.poses):
        t = (i + 1) * k - 1
        want = two[:B, :, t].clone()
        if ext:
            want[:, 0] = args[-1][:B, t]
        assert pos.shape == (B * NA, 4)
        assert torch.equal(pos, model.state_unnorm(want).reshape(B * NA, 4))


@pytest.mark.parametrize("ext", [False, True], ids=["own", "injected"])
def test_one_copy_decode_is_the_former_op_for_op(tiny, ext):
    model, *args = _inputs(tiny, 1, ext, 1)
    logs = []
    outs = []
    for decode in (_parent_decoder, TrafficModel.decoder):
        with OpLog() as log:
            outs.append(decode(model, *args, nfuture=FT))
        logs.append(log.ops)
    assert len(logs[0]) > 100 * FT
    assert logs[1] == logs[0]
    assert torch.equal(outs[1], outs[0])


def _parent_decoder(self, scene, map_feat, past_feat, z, map_store,
                    ext_future=None, nfuture=None):
    """``TrafficModel.decoder`` as it was before its ``copies`` option
    (docstring left out): the op sequence the one-copy decode keeps."""
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
            if t % k == k - 1:
                cur_map_feat = self.encode_map(cur_global.detach(),
                                               scene.map_idx, map_store)
            prev_state, pos = next_prev, cur_global
        return torch.stack(outs, dim=2)
