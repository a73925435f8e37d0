"""The plain reference against the program on the CPU at small shapes, and
the import rules of portbench/."""

import ast
import math
import sys
from pathlib import Path

import pytest
import torch

from portbench import compare, inputs
from portbench.reference import ops, reference_model, reference_models
from portbench.reference import train as reftrain

PKG = Path(__file__).resolve().parents[1]
MODELS = {
    "encdec": ("encdec", {"width_mult": 0.25}, (32, 48)),
}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "ann3depth_tpu"), (
                path, name)
            if path.is_relative_to(PKG / "reference"):
                assert top != "ann3depth_tpu_torch", (path, name)


def test_reference_models_are_found_by_file_name(monkeypatch):
    """A configuration's `reference` names a module of reference/ that sets
    MODEL; helpers and unknown names are refused with the models that are
    there."""
    import types

    assert reference_models() == ["encdec"]
    assert reference_model("encdec").forward
    have = r"the reference models are \['encdec'\]"
    for name in ("nosuch", "ops", "train", "encdec.ops", "../encdec", ""):
        with pytest.raises(KeyError, match=have):
            reference_model(name)
    lacking = types.ModuleType("portbench.reference.lacking")
    lacking.MODEL, lacking.forward = True, lambda p, x, arch: x
    monkeypatch.setitem(sys.modules, lacking.__name__, lacking)
    with pytest.raises(TypeError, match="param_shapes.*output_hw"):
        reference_model("lacking")


def _program_model(name, arch, hw, weights):
    from ann3depth_tpu_torch.config import ModelConfig
    from ann3depth_tpu_torch.models import registry

    model = registry.build(ModelConfig(
        name=name, compute_dtype="float32",
        width_mult=arch.get("width_mult", 1.0)))
    model.init_weights(torch.Generator().manual_seed(0), hw)
    model.load_state_dict(weights)
    return model


@pytest.mark.parametrize("ref_name", sorted(MODELS))
def test_reference_matches_the_program_in_f32(ref_name):
    from ann3depth_tpu_torch.pipeline import preprocess
    from ann3depth_tpu_torch.train import losses

    name, arch, hw = MODELS[ref_name]
    ref = reference_model(ref_name)
    weights = inputs.make_weights(ref.param_shapes(arch, hw), 7, "cpu")
    model = _program_model(name, arch, hw, weights)
    gen = torch.Generator().manual_seed(3)
    img = torch.randint(0, 256, (2, 48, 64, 3), generator=gen,
                        dtype=torch.uint8)
    dep = torch.rand(2, 20, 12, generator=gen) * 80
    target_hw = ref.output_hw(hw)
    x_p, d_p = preprocess.preprocess_batch(img, dep, hw, target_hw)
    x_r = reftrain.preprocess_image(img, hw)
    d_r = reftrain.preprocess_depth(dep, target_hw)
    torch.testing.assert_close(x_r, x_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d_r, d_p, rtol=1e-5, atol=1e-5)
    y_r = ref.forward(weights, x_r, arch)
    torch.testing.assert_close(y_r, model(x_p), rtol=1e-4, atol=1e-4)
    loss_p = losses.depth_loss(model(x_p), d_p, kind="si", lam=0.5)
    assert math.isclose(float(reftrain.si_loss(y_r, d_r, 0.5)),
                        float(loss_p.detach()), rel_tol=1e-5)


def test_param_counts_are_the_presets():
    from portbench import spec

    for name in ("make3d-encdec",):
        cfg = spec.config(name)
        ref = reference_model(cfg["reference"])
        shapes = ref.param_shapes(cfg["arch"],
                                  cfg["config"]["data"]["input_hw"])
        assert sum(math.prod(s) for s in shapes.values()) == \
            cfg["arch"]["params"]


def test_three_reference_steps_follow_the_program_in_f32():
    """The program's eager train step, in f32 on the CPU, from the same
    weights on the same rows: every compared number agrees to round-off."""
    from ann3depth_tpu_torch.train import step as steplib

    name, arch, hw = MODELS["encdec"]
    ref = reference_model("encdec")
    weights = inputs.make_weights(ref.param_shapes(arch, hw), 11, "cpu")
    model = _program_model(name, arch, hw, weights)
    train_cfg = dict(adam_b1=0.9, adam_b2=0.999, si_lambda=0.5, clip_norm=1.0,
                     learning_rate=1e-3, warmup_steps=2, steps=10,
                     weight_decay=0.0)
    tx = steplib.make_optimizer(1e-3, 2, 10)
    state = steplib.TrainState.create(model, tx)
    gen = torch.Generator().manual_seed(5)
    batches = [(torch.randint(0, 256, (4, 48, 64, 3), generator=gen,
                              dtype=torch.uint8),
                torch.rand(4, 20, 12, generator=gen) * 80) for _ in range(3)]
    losses, grad = [], {}
    for s, (img, dep) in enumerate(batches):
        _, m = steplib.train_step(state, img, dep, input_hw=hw,
                                  target_hw=ref.output_hw(hw))
        losses.append(float(m["loss"]))
        if s == 0:
            grad = {n: state.optimizer.state[p]["exp_avg"].clone() / 0.1
                    for n, p in model.named_parameters()}
    program = {"loss": losses, "grad": grad,
               "grad_norm": {n: float(g.double().norm())
                             for n, g in grad.items()},
               "change": {n: float((p.detach() - weights[n]).double().norm())
                          for n, p in model.named_parameters()}}
    reference = reftrain.train_readings(ref, arch, train_cfg, weights,
                                        batches, input_hw=hw,
                                        target_hw=ref.output_hw(hw))
    gaps = compare.train_gaps(program, reference)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3
    assert gaps["grad_err"] < 1e-4
    assert compare.train_gaps(reference, reference)["grad_err"] == 0.0


def test_fp8_control_moves_the_answer_and_its_gradient():
    """The control rounds the body's tensors in the forward (e4m3) and
    their gradients in the backward (e5m2), and leaves the head f32."""
    name, arch, hw = MODELS["encdec"]
    ref = reference_model("encdec")
    weights = {k: v.requires_grad_(True) for k, v in inputs.make_weights(
        ref.param_shapes(arch, hw), 2, "cpu").items()}
    x = torch.randn(2, *hw, 3)
    exact = ref.forward(weights, x, arch)
    low = ref.forward(weights, x, arch, lowp="fp8")
    assert 1e-3 < float((exact - low).detach().abs().max()) < 10.0
    g_exact = torch.autograd.grad(exact.square().sum(), list(weights.values()))
    g_low = torch.autograd.grad(low.square().sum(), list(weights.values()))
    gaps = [float((a - b).norm() / a.norm()) for a, b in zip(g_exact, g_low)
            if float(a.norm()) > 0]
    assert 1e-3 < max(gaps) < 1.0
    q = ops.Fp8.apply(torch.linspace(-3, 3, 101, requires_grad=True))
    assert len(torch.unique(q.detach())) < 101
    assert torch.equal(ops.lowp_round(None, q), q)


def test_configuration_files_hold_their_presets():
    import dataclasses
    import json

    from ann3depth_tpu_torch.config import get_config
    from portbench import spec

    for name in ("make3d-encdec",):
        cfg = spec.config(name)
        preset = json.loads(json.dumps(dataclasses.asdict(
            get_config(cfg["preset"]))))
        assert cfg["config"] == preset and cfg["reduced"] == []
