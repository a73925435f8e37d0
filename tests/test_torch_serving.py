"""The port's serving slice (config, serving, server, cli) against the JAX
package, on the CPU.

The slice as a whole: a JAX `export_serving` artifact's params.npz loaded
by the port must serve what the JAX `make_serving_fn` (HIGHEST precision)
computes from the same params. Tolerances on linear depth: bf16 compute
3e-2 relative (bf16 activations rounded at different places, see
tests/test_torch_encdec.py); f32 compute 1e-4 relative (exact-f32
preprocess and convs on both sides, summation order only).
"""

import argparse
import dataclasses
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu import config as jcfg
from ann3depth_tpu import serving as jserving
from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import cli, convert, server, serving
from ann3depth_tpu_torch import config as tcfg
from ann3depth_tpu_torch.device import resolve_device

IN_HW = (32, 48)
RAW_HW = (40, 56)


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *RAW_HW, 3),
                                                dtype=np.uint8)


def _tiny_cfg(compute="bfloat16"):
    cfg = jcfg.get_config("make3d-encdec")
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_hw=IN_HW),
        model=dataclasses.replace(cfg.model, width_mult=0.25,
                                  compute_dtype=compute))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A JAX serving artifact of a small make3d-encdec, and its params."""
    cfg = _tiny_cfg()
    model = jenc.EncDecDepthNet(width_mult=0.25)
    params = jstep.init_params(model, IN_HW, seed=0)
    out = tmp_path_factory.mktemp("artifact")
    jserving.export_serving(cfg, params, out, raw_hw=RAW_HW,
                            platforms=("cpu",), config_name="make3d-encdec")
    return out, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_match(name):
    assert dataclasses.asdict(tcfg.get_config(name)) == \
        dataclasses.asdict(jcfg.get_config(name))


def test_unknown_preset_raises():
    with pytest.raises(KeyError, match="make3d-encdec"):
        tcfg.get_config("bogus")


def test_read_artifact(artifact):
    path, params = artifact
    meta, sd = convert.read_artifact(path)
    assert meta["model"] == "encdec" and meta["raw_hw"] == list(RAW_HW)
    assert sd.keys() == convert.to_state_dict(params).keys()
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_artifact_serving_matches_jax_serving_fn(artifact):
    """make3d-encdec computes in bf16: the port's served depth against the
    JAX serving fn on the same params."""
    path, params = artifact
    jm = jenc.EncDecDepthNet(width_mult=0.25)
    fn = jserving.make_serving_fn(jm, "encdec", IN_HW,
                                  precision=jax.lax.Precision.HIGHEST)
    x = _frames(3)
    want = np.asarray(jax.jit(fn)(params, jnp.asarray(x)))
    model = serving.load_serving(path, device="cpu")
    got = model.predict(x)
    assert got.shape == want.shape == (3, 16, 24)
    np.testing.assert_allclose(got, want, rtol=3e-2)


def test_artifact_serving_f32_matches_jax_infer_step(artifact):
    """The same artifact served in f32. The JAX serving fn hands the model
    a bf16 input even then (oracle_preprocess_s2d's out_dtype), so the
    exact-f32 reference is `infer_step`: f32 preprocess at HIGHEST, then
    the f32 model."""
    path, params = artifact
    jm = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32)
    x = _frames(3, seed=4)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jstep.infer_step(jm.apply, params, jnp.asarray(x),
                                           input_hw=IN_HW))
    meta, state_dict = convert.read_artifact(path)
    model = serving.model_from_artifact(
        {**meta, "config": "make3d-small"}, state_dict)  # an f32 preset
    assert model.compute_dtype == torch.float32
    fn = serving.make_serving_fn(model.eval(), meta["input_hw"])
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-4)


def test_artifact_compute_dtype_from_named_preset(artifact):
    model = serving.load_serving(artifact[0], device="cpu")
    assert model.model.compute_dtype == torch.bfloat16
    assert model.model.widths == [32, 32, 64]


def _f32_service(**kw):
    cfg = tcfg.get_config("make3d-encdec")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_hw=IN_HW),
        model=dataclasses.replace(cfg.model, width_mult=0.25,
                                  compute_dtype="float32"))
    return cfg, server.service_from_config(cfg, init=True, raw_hw=RAW_HW,
                                           device="cpu", **kw)


def test_batching_service_equals_direct_calls():
    cfg, svc = _f32_service(max_batch=4, max_delay_s=0.05)
    try:
        x = _frames(5, seed=1)
        futs = [svc.submit(f) for f in x]
        got = np.stack([f.result(timeout=60) for f in futs])
        assert svc.stats()["requests"] == 5
    finally:
        svc.close()
    from ann3depth_tpu_torch.models import registry
    from ann3depth_tpu_torch.train import step as tstep

    model = serving.prepare_model(
        tstep.init_params(registry.build(cfg.model), cfg.train.seed),
        torch.device("cpu"))
    fn = serving.make_serving_fn(model, IN_HW)
    want = np.concatenate([fn(torch.from_numpy(x[i:i + 1])).numpy()
                           for i in range(5)])
    assert got.shape == (5, 16, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_http_roundtrip_on_port_service():
    _, svc = _f32_service(max_batch=2, max_delay_s=0.005)
    srv = server.DepthServer(svc, port=0).serve_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        x = _frames(2, seed=2)
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(f"{base}/v1/depth",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out = np.load(io.BytesIO(r.read()))
        assert out.shape == (2, 16, 24)
        assert np.isfinite(out).all() and (out > 0).all()
        np.testing.assert_allclose(out[1], svc.predict(x[1]), rtol=1e-5)
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=10) as r:
            assert json.load(r)["requests"] == 3
    finally:
        srv.close()


def test_warmup_runs_every_bucket_in_the_dispatch_thread():
    seen = []

    def fn(frames):
        seen.append((frames.shape[0], threading.current_thread().name))
        return np.zeros((frames.shape[0], 2, 2), np.float32)

    svc = server.BatchingService(fn, RAW_HW, max_batch=8, max_delay_s=0.05)
    try:
        server.warmup(svc)
    finally:
        svc.close()
    assert seen == [(b, "depth-batcher") for b in (1, 2, 4, 8)]


def test_probe_serving_trivial_condition():
    from ann3depth_tpu_torch import probe_serving

    out = probe_serving.run_condition("trivial_fn_one_post_first", "cpu",
                                      small=True)
    assert out["one_post_ms"] > 0
    assert len(out["rounds"]) == probe_serving.ROUNDS
    assert all(r["seconds"] > 0 and r["p50_request_ms"] > 0
               for r in out["rounds"])


def test_service_from_config_refuses_what_is_not_ported():
    cfg = tcfg.get_config("make3d-encdec")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        server.service_from_config(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="dp=2"):
        server.service_from_config(cfg, init=True, dp=2, device="cpu")


def test_cuda_entry_point_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.service_from_config(tcfg.get_config("make3d-encdec"),
                                   init=True)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_serve_flags():
    args = cli.build_parser().parse_args(
        ["serve", "--config", "make3d-encdec", "--init", "--host", "0.0.0.0",
         "--port", "9000", "--max-batch", "8", "--max-delay-ms", "2",
         "--raw-hw", "240", "320", "--no-warmup", "--device", "cpu"])
    assert (args.init, args.port, args.max_batch, args.raw_hw,
            args.no_warmup, args.device) == (True, 9000, 8, [240, 320],
                                             True, "cpu")
    assert args.max_delay_ms == 2.0 and args.artifact is None


def test_cli_without_init_or_artifact_exits():
    args = cli.build_parser().parse_args(["serve", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--init"):
        cli.make_service(args)


def test_cli_serves_an_artifact(artifact):
    args = argparse.Namespace(artifact=str(artifact[0]), init=False,
                              max_batch=2, max_delay_ms=1.0, device="cpu",
                              config="make3d-encdec", raw_hw=[480, 640])
    svc = cli.make_service(args)
    try:
        assert svc.raw_hw == RAW_HW
        out = svc.predict(_frames(1, seed=3)[0])
        assert out.shape == (16, 24) and np.isfinite(out).all()
    finally:
        svc.close()
