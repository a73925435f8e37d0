"""The port's serving export (ann3depth_tpu_torch/serving.py
`export_serving` and `load_serving`, server.py `service_from_artifact`,
cli.py `export` and `serve --artifact`), on the CPU.

An exported program (`torch.export`) is the eager serving program traced:
the same registered preprocess op, the same model ops on the same
weights. So its answers equal the eager serving fn's bit for bit at every
batch it takes, polymorphic or fixed, float or int8. A port export of
converted JAX params (bf16 compute) is held against the JAX
`make_serving_fn` (HIGHEST precision) at tests/test_torch_serving.py's
bf16 serving tolerance, 3e-2 relative in linear depth.
"""

import dataclasses
import functools
import io
import json
import shutil
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu import serving as jserving
from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import cli, convert, server, serving
from ann3depth_tpu_torch import config as tcfg
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.train import step as tstep

IN_HW = (32, 48)
RAW_HW = (40, 56)
META_KEYS = {"config", "model", "quant", "input_hw", "raw_hw", "batch",
             "platforms", "out_shape", "param_count", "torch_version",
             "format"}


def _frames(n, seed=0, hw=RAW_HW):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def _cfg(name="encdec", quant="none", compute="bfloat16", input_hw=IN_HW):
    cfg = tcfg.get_config("make3d-encdec")
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_hw=input_hw),
        model=dataclasses.replace(cfg.model, name=name, width_mult=0.25,
                                  quant=quant, compute_dtype=compute))


def _model(cfg):
    return tstep.init_params(registry.build(cfg.model), cfg.data.input_hw,
                             cfg.train.seed)


def _round_trip(tmp_path, cfg, batch, batches):
    """Export `cfg`'s random-init model at `batch`; the artifact's answers
    at each of `batches` against the eager serving fn's."""
    model = _model(cfg)
    meta = serving.export_serving(cfg, model, tmp_path, batch=batch,
                                  raw_hw=RAW_HW, device="cpu")
    loaded = serving.load_serving(tmp_path, device="cpu")
    eager = serving.make_serving_fn(serving.prepare_model(model, "cpu"),
                                    cfg.data.input_hw)
    for b in batches:
        x = _frames(b, seed=b)
        got = loaded.predict(x)
        assert got.shape == (b, *registry.output_hw(cfg.model.name,
                                                    cfg.data.input_hw))
        np.testing.assert_array_equal(got, eager(torch.from_numpy(x)).numpy())
    return meta, loaded


@pytest.mark.parametrize("batch", [None, 1, 3])
def test_export_round_trip(tmp_path, batch):
    meta, loaded = _round_trip(tmp_path, _cfg(), batch,
                               (1, 2, 3) if batch is None else (batch,))
    assert meta["batch"] == batch
    assert meta["out_shape"] == ["batch" if batch is None else str(batch),
                                 "16", "24"]
    if batch is not None:
        with pytest.raises(Exception):
            loaded.predict(_frames(batch + 1))
    ops = [n.target for n in loaded.model.graph.nodes
           if n.op == "call_function"]
    assert ops.count(torch.ops.ann3depth.fused_preprocess.default) == 1


def test_meta_and_a_fixed_batch_pin_the_service(tmp_path):
    cfg = _cfg()
    meta, _ = _round_trip(tmp_path, cfg, 2, (2,))
    assert set(meta) == META_KEYS
    assert json.loads((tmp_path / "meta.json").read_text()) == meta
    assert (meta["model"], meta["quant"], meta["input_hw"], meta["raw_hw"],
            meta["platforms"], meta["format"]) == (
        "encdec", "none", list(IN_HW), list(RAW_HW), ["cpu"], "torch.export")
    assert meta["param_count"] == sum(p.numel()
                                      for p in _model(cfg).parameters())
    svc = server.service_from_artifact(tmp_path, device="cpu", max_batch=32)
    try:
        assert svc._buckets == [2] and svc.max_batch == 2
        out = svc.predict(_frames(1)[0])  # padded to the artifact's batch
        assert out.shape == (16, 24) and np.isfinite(out).all()
    finally:
        svc.close()


def test_polymorphic_artifact_keeps_the_ladder(tmp_path):
    _round_trip(tmp_path, _cfg(compute="float32"), None, (2,))
    svc = server.service_from_artifact(tmp_path, device="cpu", max_batch=4)
    try:
        assert svc._buckets == [1, 2, 4]
    finally:
        svc.close()


def test_int8_encdec_export(tmp_path):
    meta, loaded = _round_trip(tmp_path, _cfg(quant="int8"), None, (1, 3))
    assert meta["quant"] == "int8"
    # Autocast regions are submodules of the exported graph.
    ops = {n.target for m in loaded.model.modules() if hasattr(m, "graph")
           for n in m.graph.nodes if n.op == "call_function"}
    assert torch.ops.aten._int_mm.default in ops


def test_tiny_dpt_export(tmp_path):
    _round_trip(tmp_path, _cfg("dpt-small", input_hw=(32, 32)), None,
                (1, 2))


def test_artifact_runs_only_on_its_device_type(tmp_path):
    _round_trip(tmp_path, _cfg(compute="float32"), 1, (1,))
    meta = json.loads((tmp_path / "meta.json").read_text())
    other = tmp_path / "other"
    shutil.copytree(tmp_path, other, ignore=shutil.ignore_patterns("other"))
    (other / "meta.json").write_text(json.dumps(
        dict(meta, platforms=["cuda"])))
    with pytest.raises(ValueError, match="exported for"):
        serving.load_serving(other, device="cpu")


def test_port_export_of_jax_params_matches_jax_serving_fn(tmp_path):
    cfg = _cfg()
    jm = jenc.EncDecDepthNet(width_mult=0.25)
    params = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jstep.init_params, jm, IN_HW))(seed=3))
    model = registry.build(cfg.model)
    model.load_state_dict(convert.to_state_dict(params), strict=True)
    serving.export_serving(cfg, model, tmp_path, raw_hw=RAW_HW,
                           device="cpu")
    x = _frames(2, seed=4)
    fn = jserving.make_serving_fn(jm, "encdec", IN_HW,
                                  precision=jax.lax.Precision.HIGHEST)
    want = np.asarray(jax.jit(fn)(params, jnp.asarray(x)))
    got = serving.load_serving(tmp_path, device="cpu").predict(x)
    np.testing.assert_allclose(got, want, rtol=3e-2)


CLI_SMALL = ["--config", "make3d-encdec", "--datasets", "synthetic",
             "--synth-n", "4", "--synth-test-n", "2", "--synth-hw", "40",
             "56", "--synth-depth-hw", "15", "11", "--width-mult", "0.25",
             "--batch-size", "2", "--device", "cpu"]


def test_cli_export_after_train(tmp_path, capsys):
    """`export` bakes the weights the eval path would restore (latest, EMA,
    the mean of the last K saves); it needs a checkpoint unless --init."""
    ck = ["--ckpt-dir", str(tmp_path / "c")]
    assert cli.main(["train"] + CLI_SMALL + ck + [
        "--steps", "3", "--checkpoint-every", "1", "--ema-decay", "0.9",
        "--workdir", str(tmp_path / "w")]) == 0
    capsys.readouterr()
    out = str(tmp_path / "art")
    assert cli.main(["export"] + CLI_SMALL + ck + [
        "--out-dir", out, "--ema", "--avg-last", "2", "--raw-hw",
        *map(str, RAW_HW)]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["config"] == "make3d-encdec" and meta["batch"] is None
    cfg = cli.resolve_config(cli.build_parser().parse_args(
        ["export"] + CLI_SMALL + ck + ["--out-dir", out]))
    model = tloop.restore_state_for_eval(cfg, use_ema=True, avg_last=2,
                                         device="cpu").model
    eager = serving.make_serving_fn(serving.prepare_model(model, "cpu"),
                                    cfg.data.input_hw)
    x = _frames(2, seed=5)
    np.testing.assert_array_equal(
        serving.load_serving(out, device="cpu").predict(x),
        eager(torch.from_numpy(x)).numpy())
    with pytest.raises(SystemExit, match="exclusive"):
        cli.main(["export"] + CLI_SMALL + ck + [
            "--out-dir", out, "--avg-last", "2", "--ckpt-step", "1"])
    with pytest.raises(RuntimeError, match="no checkpoint"):
        cli.main(["export"] + CLI_SMALL + [
            "--ckpt-dir", str(tmp_path / "none"), "--out-dir", out])


def test_cli_serve_artifact_over_http(tmp_path, capsys):
    out = str(tmp_path / "art")
    assert cli.main(["export"] + CLI_SMALL + [
        "--init", "--out-dir", out, "--serving-batch", "2", "--raw-hw",
        *map(str, RAW_HW)]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["batch"] == 2
    args = cli.build_parser().parse_args(
        ["serve", "--artifact", out, "--device", "cpu", "--max-batch", "8"])
    svc = cli.make_service(args)
    srv = server.DepthServer(svc, port=0).serve_background()
    try:
        assert svc._buckets == [2]
        x = _frames(2, seed=6)
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/depth",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.load(io.BytesIO(r.read()))
        want = serving.load_serving(out, device="cpu").predict(x)
        np.testing.assert_array_equal(got, want)
    finally:
        srv.close()
