"""The port's infer path (utils/viz.py, utils/pointcloud.py,
live/transcode.py, cli.py `infer`) against the JAX package's, on the CPU.

- viz and pointcloud are host numpy code: bit-equal outputs on the same
  inputs, PLY files byte for byte.
- `infer --image` and `transcode` run make3d-encdec at width 0.25 in bf16
  (the preset's compute dtype; the CLI has no flag for it). Depth within
  3e-2 relative of the JAX package's on the same params, the serving
  tolerance (tests/test_torch_serving.py): bf16 activations are rounded
  at different places on the two sides, and the JAX transcode feeds its
  model a bf16 space-to-depth input.
- The transcoded videos are MJPG (lossy): decoded frames differ from the
  JAX package's by at most 4 levels in mean.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu.utils import pointcloud as jpc
from ann3depth_tpu.utils import viz as jviz
from ann3depth_tpu_torch import cli, convert
from ann3depth_tpu_torch.config import get_config
from ann3depth_tpu_torch.live import infer as tinfer
from ann3depth_tpu_torch.models import encdec as tenc
from ann3depth_tpu_torch.train import checkpoint as tckpt
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.utils import pointcloud as tpc
from ann3depth_tpu_torch.utils import viz as tviz

BF16_RTOL = 3e-2
VIDEO_MEAN_TOL = 4.0


# ---------------------------------------------------------------------------
# viz and pointcloud.
# ---------------------------------------------------------------------------

def _depth(hw=(12, 16), seed=0):
    return np.random.default_rng(seed).uniform(0.5, 70.0, hw).astype(
        np.float32)


@pytest.mark.parametrize("cmap", ["turbo", "viridis", "magma", "gray"])
def test_colormap_depth_matches_jax(cmap):
    d = _depth()
    np.testing.assert_array_equal(tviz.colormap_depth(d, cmap=cmap),
                                  jviz.colormap_depth(d, cmap=cmap))
    np.testing.assert_array_equal(tviz.colormap_depth(d, 2.0, 40.0, cmap),
                                  jviz.colormap_depth(d, 2.0, 40.0, cmap))


def test_denormalize_and_triple_grid_match_jax():
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(5, 12, 16, 3)).astype(np.float32)
    gt, pred = _depth((5, 6, 8), 2), _depth((5, 6, 8), 3)
    gt[0] = 0.0  # no valid pixel: the scale comes from the prediction
    np.testing.assert_array_equal(tviz.denormalize_to_u8(imgs[0]),
                                  jviz.denormalize_to_u8(imgs[0]))
    for rows in (4, 5):
        got = tviz.triple_grid(imgs, gt, pred, max_rows=rows)
        np.testing.assert_array_equal(
            got, jviz.triple_grid(imgs, gt, pred, max_rows=rows))
        assert got.shape == (rows * 12, 3 * 16, 3)


def test_save_png_and_triple_summary(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (6, 9, 3), np.uint8)
    path = tviz.save_png(str(tmp_path / "a" / "x.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    got = tviz.write_triple_summary(str(tmp_path), 7, imgs, _depth((2, 4, 4)),
                                    _depth((2, 4, 4), 6))
    assert got == str(tmp_path / "triples_step0000007.png")
    want = jviz.write_triple_summary(str(tmp_path / "j"), 7, imgs,
                                     _depth((2, 4, 4)), _depth((2, 4, 4), 6))
    np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                  np.asarray(Image.open(want)))


def test_backproject_matches_jax():
    d = _depth((10, 14), 7)
    d[0, :3] = 0.0  # invalid pixels are dropped
    rgb = np.random.default_rng(8).integers(0, 256, (10, 14, 3), np.uint8)
    for fov in (40.0, 55.0):
        (gp, gc), (wp, wc) = (tpc.backproject(d, rgb, fov_deg=fov),
                              jpc.backproject(d, rgb, fov_deg=fov))
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gc, wc)
    assert tpc.intrinsics_from_fov((10, 14)) == jpc.intrinsics_from_fov(
        (10, 14))
    with pytest.raises(ValueError, match="does not match"):
        tpc.backproject(d, rgb=rgb[:2])
    with pytest.raises(ValueError, match="fov_deg"):
        tpc.backproject(d, fov_deg=180.0)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("with_colors", [True, False])
def test_ply_bytes_match_jax(tmp_path, binary, with_colors):
    d = _depth((9, 11), 9)
    rgb = (np.random.default_rng(10).integers(0, 256, (9, 11, 3), np.uint8)
           if with_colors else None)
    got, want = tmp_path / "t.ply", tmp_path / "j.ply"
    n = tpc.depth_to_ply(str(got), d, rgb=rgb, binary=binary)
    assert n == jpc.depth_to_ply(str(want), d, rgb=rgb, binary=binary) == 99
    assert got.read_bytes() == want.read_bytes()
    (gp, gc), (wp, wc) = tpc.read_ply(str(got)), jpc.read_ply(str(want))
    np.testing.assert_array_equal(gp, wp)
    assert (gc is None) == (wc is None) == (not with_colors)
    if with_colors:
        np.testing.assert_array_equal(gc, wc)


# ---------------------------------------------------------------------------
# cli infer --image.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params():
    model = jenc.EncDecDepthNet(width_mult=0.25)
    params = jax.jit(functools.partial(jstep.init_params, model, (32, 48)))(
        seed=0)
    return jax.tree.map(np.asarray, params)


def _save_port_ckpt(ckpt_dir, cfg):
    state = tloop.create_state(cfg, torch.device("cpu"))
    state.model.load_state_dict(convert.to_state_dict(_params()))
    tckpt.CheckpointManager(str(ckpt_dir)).save(1, state)


CLI_SMALL = ["--config", "make3d-encdec", "--width-mult", "0.25",
             "--device", "cpu"]


def test_cli_infer_image_matches_jax(tmp_path, capsys):
    """npy, png and ply outputs of `infer --image` with --tta flip: the
    depth against the JAX `infer_step` on the same params, the PNG and the
    PLY against the JAX package's viz and pointcloud of the port's depth."""
    cfg = cli.resolve_config(cli.build_parser().parse_args(
        ["infer"] + CLI_SMALL))
    _save_port_ckpt(tmp_path / "c", cfg)
    img = np.random.default_rng(11).integers(0, 256, (60, 80, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "scene.png")
    out = tmp_path / "out"
    assert cli.main(["infer"] + CLI_SMALL + [
        "--ckpt-dir", str(tmp_path / "c"), "--image",
        str(tmp_path / "scene.png"), "--out-dir", str(out), "--ply",
        "--fov-deg", "60", "--tta", "flip", "--colormap", "viridis"]) == 0
    rec, = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    depth = np.load(rec["depth_npy"])
    assert depth.shape == (120, 160) and depth.dtype == np.float32

    jm = jenc.EncDecDepthNet(width_mult=0.25)
    want = np.asarray(jstep.infer_step(jm.apply, _params(),
                                       jnp.asarray(img[None]),
                                       input_hw=(240, 320), tta="flip"))[0]
    np.testing.assert_allclose(depth, want, rtol=BF16_RTOL)
    np.testing.assert_array_equal(
        np.asarray(Image.open(rec["depth_png"])),
        jviz.colormap_depth(depth, cmap="viridis"))
    colors = np.asarray(Image.fromarray(img).resize((160, 120),
                                                    Image.BILINEAR))
    jpc.depth_to_ply(str(tmp_path / "j.ply"), depth, rgb=colors,
                     fov_deg=60.0)
    assert open(rec["ply"], "rb").read() == \
        (tmp_path / "j.ply").read_bytes()
    assert rec["ply_points"] == 120 * 160


def test_cli_infer_image_without_png_or_checkpoint(tmp_path, capsys):
    img_path = tmp_path / "x.png"
    Image.fromarray(np.zeros((40, 56, 3), np.uint8)).save(img_path)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        cli.main(["infer"] + CLI_SMALL + ["--ckpt-dir", str(tmp_path / "e"),
                                          "--image", str(img_path)])
    cfg = cli.resolve_config(cli.build_parser().parse_args(
        ["infer"] + CLI_SMALL))
    _save_port_ckpt(tmp_path / "c", cfg)
    assert cli.main(["infer"] + CLI_SMALL + [
        "--ckpt-dir", str(tmp_path / "c"), "--image", str(img_path),
        "--out-dir", str(tmp_path / "o"), "--no-png"]) == 0
    rec, = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "depth_png" not in rec and os.path.exists(rec["depth_npy"])


@pytest.mark.parametrize("flags", [[], ["--image", "a.png", "--video",
                                        "b.avi"]])
def test_cli_infer_requires_exactly_one_source(tmp_path, flags):
    with pytest.raises(SystemExit, match="exactly one"):
        cli.main(["infer"] + CLI_SMALL + ["--ckpt-dir", str(tmp_path)]
                 + flags)


# ---------------------------------------------------------------------------
# The transcode device loop and the cv2 half.
# ---------------------------------------------------------------------------

def _port_model():
    tm = tenc.EncDecDepthNet(width_mult=0.25)
    tm.load_state_dict(convert.to_state_dict(_params()))
    return tm.eval()


def test_render_batches_is_live_step_per_batch():
    """The device loop returns each batch's own frames, trimmed to its
    valid count, as `live_step` renders them."""
    tm = _port_model()
    rng = np.random.default_rng(12)
    batches = [(rng.integers(0, 256, (3, 48, 64, 3), np.uint8), n)
               for n in (3, 3, 1)]
    from ann3depth_tpu_torch.live.transcode import render_batches

    out = list(render_batches(tm, iter(batches), input_hw=(32, 48),
                              colormap="gray"))
    assert len(out) == 3
    for (frames, n), (got_frames, rendered, depth) in zip(batches, out):
        assert got_frames is frames
        d, r = tinfer.live_step(tm, torch.from_numpy(frames),
                                input_hw=(32, 48), display_hw=(48, 64),
                                colormap="gray")
        np.testing.assert_array_equal(rendered, r.numpy()[:n])
        np.testing.assert_array_equal(depth, d.numpy()[:n])
    *_, no_depth = next(render_batches(tm, iter(batches[:1]),
                                       input_hw=(32, 48), with_depth=False))
    assert no_depth is None


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def _write_clip(cv2, path, n=7, hw=(48, 64), fps=15):
    h, w = hw
    wtr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                          (w, h))
    assert wtr.isOpened()
    rng = np.random.default_rng(0)
    for i in range(n):
        frame = np.full((h, w, 3), (i * 23) % 255, np.uint8)
        frame[:, : w // 2] = rng.integers(0, 255, (h, w // 2, 3), np.uint8)
        wtr.write(frame)
    wtr.release()


def _read_frames(cv2, path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f.astype(np.int32))
    cap.release()
    return frames


def _cfgs(tmp_path):
    from ann3depth_tpu.config import get_config as jget_config

    out = []
    for get in (jget_config, get_config):
        cfg = get("make3d-encdec")
        out.append(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, input_hw=(32, 48)),
            model=dataclasses.replace(cfg.model, width_mult=0.25),
            train=dataclasses.replace(cfg.train,
                                      ckpt_dir=str(tmp_path / "none"))))
    return out


@pytest.mark.parametrize("side_by_side,tta", [(False, ""), (True, "flip")])
def test_transcode_matches_jax(tmp_path, cv2, side_by_side, tta):
    """7 frames at batch 4 (a padded last batch): the depth stack and the
    written video against the JAX transcode on the same params."""
    from ann3depth_tpu.live import transcode as jtc
    from ann3depth_tpu.train import loop as jloop
    from ann3depth_tpu_torch.live import transcode as ttc

    jcfg, tcfg = _cfgs(tmp_path)
    clip = tmp_path / "clip.avi"
    _write_clip(cv2, clip)
    jstate = jloop.create_state(jcfg).replace(params=_params())
    kw = dict(batch=4, side_by_side=side_by_side, tta=tta)
    want = jtc.transcode(jcfg, str(clip), str(tmp_path / "j.avi"),
                         depth_npy=str(tmp_path / "j.npy"), state=jstate,
                         **kw)
    got = ttc.transcode(tcfg, str(clip), str(tmp_path / "t.avi"),
                        depth_npy=str(tmp_path / "t.npy"),
                        model=_port_model(), **kw)
    for k in ("frames", "frame_hw", "batch", "source_fps", "depth_hw"):
        assert got[k] == want[k], k
    assert got["frames"] == 7 and got["depth_hw"] == [16, 24]
    np.testing.assert_allclose(np.load(tmp_path / "t.npy"),
                               np.load(tmp_path / "j.npy"), rtol=BF16_RTOL)
    gv, wv = (_read_frames(cv2, tmp_path / f"{s}.avi") for s in "tj")
    assert len(gv) == len(wv) == 7
    for g, w in zip(gv, wv):
        assert g.shape == w.shape == (48, 128 if side_by_side else 64, 3)
        assert np.abs(g - w).mean() <= VIDEO_MEAN_TOL


def test_transcode_max_frames_and_missing_video(tmp_path, cv2):
    from ann3depth_tpu_torch.live import transcode as ttc

    _, tcfg = _cfgs(tmp_path)
    clip = tmp_path / "clip.avi"
    _write_clip(cv2, clip, n=9)
    stats = ttc.transcode(tcfg, str(clip), str(tmp_path / "o.avi"), batch=4,
                          max_frames=5, model=_port_model())
    assert stats["frames"] == 5
    assert len(_read_frames(cv2, tmp_path / "o.avi")) == 5
    with pytest.raises(RuntimeError, match="cannot open video"):
        ttc.transcode(tcfg, str(tmp_path / "nope.avi"),
                      str(tmp_path / "x.avi"), model=_port_model())


def test_cli_infer_video_end_to_end(tmp_path, capsys, cv2):
    clip = tmp_path / "walk.avi"
    _write_clip(cv2, clip, n=6)
    assert cli.main(["infer"] + CLI_SMALL + [
        "--ckpt-dir", str(tmp_path / "no_ckpt"), "--video", str(clip),
        "--out-dir", str(tmp_path / "out"), "--video-batch", "4",
        "--depth-npy"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 6
    assert os.path.basename(stats["out"]) == "walk_depth.avi"
    assert len(_read_frames(cv2, stats["out"])) == 6
    assert np.load(stats["depth_npy"]).shape == (6, 120, 160)
