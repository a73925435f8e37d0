"""One rank of the port's parallel modes on the CPU (gloo), for
tests/test_torch_multiprocess.py. It imports torch and the port only.

    python tests/torch_parallel_worker.py RANK WORLD PORT CASE.json

CASE.json names the scenario, its config, the input npz (weights as a
state_dict, images, depths) and the output npz that rank 0 writes: the
final params in the single-device layout, the EMA, the last metrics and
the optimizer state bytes of each rank.
"""

import dataclasses
import datetime
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from ann3depth_tpu_torch.config import get_config
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.models.dpt import DPTDepthNet
from ann3depth_tpu_torch.parallel import mesh as meshlib
from ann3depth_tpu_torch.parallel import shard_step, sharding_rules, zero1
from ann3depth_tpu_torch.train import loop
from ann3depth_tpu_torch.train import step as steplib

CPU = torch.device("cpu")


def config(case):
    """The case's port config: a preset with its overrides."""
    cfg = get_config(case.get("preset", "make3d-encdec"))
    over = case.get("config", {})
    return dataclasses.replace(cfg, **{
        section: dataclasses.replace(getattr(cfg, section), **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in fields.items()})
        for section, fields in over.items()})


def update_rule(cfg):
    t = cfg.train
    return steplib.make_optimizer(
        t.learning_rate, t.warmup_steps, t.steps, b1=t.adam_b1,
        b2=t.adam_b2, weight_decay=t.weight_decay, clip_norm=t.clip_norm,
        optimizer=t.optimizer, schedule=t.schedule)


def model_of(case, cfg, sd):
    if case.get("tiny_dpt"):
        model = DPTDepthNet(**case["tiny_dpt"], compute_dtype=torch.float32,
                            remat=False)
    else:
        model = registry.build(cfg.model)
    model = steplib.init_params(model, cfg.data.input_hw, 0)
    model.load_state_dict(sd)
    return model


def main(rank, world, port, case_path):
    with open(case_path) as f:
        case = json.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    data = np.load(case["inputs"])
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd/")}
    img, dep = torch.from_numpy(data["img"]), torch.from_numpy(data["dep"])
    cfg = config(case)
    t = cfg.train
    tx = update_rule(cfg)
    ema = t.ema_decay > 0
    model = model_of(case, cfg, sd)
    kw = dict(input_hw=tuple(cfg.data.input_hw),
              target_hw=tuple(case.get("target_hw")
                              or loop.resolved_target_hw(cfg)),
              si_lambda=t.si_lambda, augment=cfg.data.augment,
              loss_kind=t.loss, ema_decay=t.ema_decay,
              grad_accum=t.grad_accum)
    kind = case["kind"]
    if kind == "tp":
        mesh = meshlib.create_mesh_2d(world // case["tp"], case["tp"])
        plan = sharding_rules.shard_params(model, mesh)
        state = steplib.TrainState.create(model, tx, ema=ema, mesh=mesh,
                                          tp_plan=plan)
    elif kind == "zero1":
        mesh = meshlib.create_mesh()
        state = zero1.create_state(model, tx, mesh, ema=ema)
    else:
        mesh = meshlib.auto_data_mesh(t.batch_size // t.grad_accum)
        state = steplib.TrainState.create(model, tx, ema=ema, mesh=mesh)
    meshlib.replicate(state.model, mesh)
    generator = torch.Generator()
    local_img, local_dep = meshlib.shard_batch((img, dep), mesh)
    dp_step = None
    if kind == "shard_step":
        dp_step = shard_step.make_dp_train_step(
            mesh, input_hw=kw["input_hw"], target_hw=kw["target_hw"],
            si_lambda=t.si_lambda, augment=False)
    sharding_rules.collectives.update(forward=0, backward=0, update=0)
    metrics = {}
    for step in range(case["steps"]):
        if dp_step is not None:
            state, metrics = dp_step(state, local_img, local_dep)
            continue
        draws = None
        if kw["augment"]:
            generator.manual_seed(loop.step_seed(t.seed, step))
            draws = steplib.shard_draws(generator, t.batch_size,
                                        t.grad_accum, mesh)
        state, metrics = steplib.train_step(state, local_img, local_dep,
                                            generator, draws=draws, **kw)
    params, _, ema_params = state.full_state()
    opt_bytes = torch.tensor([float(getattr(
        state.optimizer, "state_bytes", lambda: sum(
            v.numel() * v.element_size()
            for st in state.optimizer.state.values()
            for v in st.values() if torch.is_tensor(v)))())])
    all_bytes = torch.zeros(world)
    dist.all_gather_into_tensor(all_bytes, opt_bytes)
    if rank == 0:
        out = {f"p/{k}": v.detach().numpy() for k, v in params.items()}
        if ema_params is not None:
            out.update({f"e/{k}": v.detach().numpy()
                        for k, v in ema_params.items()})
        out.update({f"m/{k}": np.float32(float(v))
                    for k, v in metrics.items()})
        out["opt_bytes"] = all_bytes.numpy()
        out["tp_collectives"] = np.array(
            [sharding_rules.collectives["forward"],
             sharding_rules.collectives["backward"]])
        np.savez(case["output"], **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
