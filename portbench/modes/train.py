"""Training cells: the program's K=1 train step fed as `train` feeds it.

Set-up makes the scenes from the seed and hands them to the program's
feed: written as packed records (the program's record writer, into a
temporary directory under TMPDIR) and read back through `train`'s dataset
factory and host feed (`feed: "records"`), or staged in its device pool
(`feed: "pool"`, `data.cache_device`). It makes the weights from the
seed, loads them into the program's train state, and drives that state
through the program's `BlockRunner` (the first step of a batch shape
eager, then captured and replayed as a CUDA graph) for `compare_steps`
steps, noting for each which scenes it was given and the readings that
`correct` compares, then for `warm_steps` more. The same objects then
run the window: every step takes its batch from the feed and runs the
step.

Once the window has closed and the program's state is freed, the
reference follows the first steps from the same weights on the same
scenes (reference/train.py).
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import sys
import tempfile
import time

import torch

from portbench import compare, inputs, spec, trace
from portbench.counts import flops, preprocess
from portbench.reference import exact_f32, reference_model
from portbench.reference import train as reftrain

N_FEED_STEPS = 10 ** 7  # the feed's length: more than any window takes


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TrainRun:
    """One training cell's program side, from set-up to release."""

    def __init__(self, config_spec, traffic_spec, seed, device):
        self.config, self.traffic = config_spec, traffic_spec
        self.seed, self.device = seed, torch.device(device)
        self.tmp = None
        self.ref = reference_model(config_spec["reference"])
        train = config_spec["config"]["train"]
        data = config_spec["config"]["data"]
        stated = {"loss": train["loss"], "optimizer": train["optimizer"],
                  "schedule": train["schedule"],
                  "grad_accum": train["grad_accum"],
                  "ema_decay": train["ema_decay"], "augment": data["augment"]}
        followed = {"loss": "si", "optimizer": "adamw", "schedule": "cosine",
                    "grad_accum": 1, "ema_decay": 0.0, "augment": False}
        if stated != followed:
            raise ValueError(f"the reference follows {followed}, not "
                             f"{stated}")
        self.input_hw = tuple(data["input_hw"])
        self.target_hw = tuple(self.ref.output_hw(self.input_hw))
        self.batch = int(train["batch_size"])

    # -- set-up --------------------------------------------------------------

    def setup(self):
        from ann3depth_tpu_torch.data import records
        from ann3depth_tpu_torch.device import resolve_device
        from ann3depth_tpu_torch.parallel import mesh as meshlib
        from ann3depth_tpu_torch.train import dispatch, loop

        t = self.traffic
        self.phases = {}
        mark = time.perf_counter()

        def phase(name):
            nonlocal mark
            now = time.perf_counter()
            self.phases[name] = now - mark
            mark = now

        self.scenes = inputs.make_scenes(t, self.seed)
        phase("scenes")
        overrides = {"data.datasets": [t["dataset"]]}
        self.pooled = t["feed"] == "pool"
        if t["feed"] == "records":
            self.tmp = tempfile.mkdtemp(prefix="portbench-")
            records.pack(self.scenes, os.path.join(self.tmp, "records"),
                         "train")
            overrides["data.data_dir"] = self.tmp
        elif self.pooled:
            overrides["data.cache_device"] = True
        else:
            raise ValueError(f"unknown feed {t['feed']!r}")
        cfg = spec.program_config(self.config, overrides)
        dataset = (self.scenes if self.pooled
                   else loop.build_dataset(cfg, "train"))
        phase("dataset")

        shapes = self.ref.param_shapes(self.config["arch"], self.input_hw)
        self.weights = inputs.make_weights(shapes, self.seed, self.device)
        resolve_device(self.device)  # TF32 off, as `train` runs
        self.state = loop.create_state(cfg, self.device)
        self.state.model.load_state_dict(self.weights)
        phase("state")
        tr = cfg.train
        step_kwargs = dict(input_hw=self.input_hw,
                           target_hw=loop.resolved_target_hw(cfg),
                           si_lambda=tr.si_lambda, augment=cfg.data.augment,
                           loss_kind=tr.loss, ema_decay=tr.ema_decay,
                           grad_accum=tr.grad_accum)
        mesh = meshlib.auto_data_mesh(tr.batch_size // tr.grad_accum)
        self.feed = loop._make_feed(cfg, dataset, [], self.device, 0,
                                    N_FEED_STEPS, step_kwargs, mesh)
        self.runner = dispatch.BlockRunner(
            self.state, self.feed if self.pooled else None, 1,
            step_kwargs=step_kwargs, device=self.device,
            draw_seed=lambda s: loop.step_seed(tr.seed, s))
        self.items = (self.feed.index_blocks(1) if self.pooled
                      else iter(self.feed))
        self.b1 = tr.adam_b1
        phase("feed")

    def _scene_rows(self, item):
        """The scene of each row of a compared step's batch, by its first
        pixels (a pool item is the block of pool indices it draws)."""
        img = self.feed.pool_img[item[0]] if self.pooled else item[0]
        first = img[:, 0, :inputs.FINGERPRINT_PIXELS]
        return self.scenes.rows_of(first.cpu().numpy())

    def first_steps(self):
        """The compared steps: their scenes and the program's readings,
        with its first clipped gradient (AdamW's first `exp_avg` over
        1 - b1) as f32 tensors on the host."""
        losses, self.rows = [], []
        grad, grad_norm = {}, {}
        for s in range(int(self.traffic["compare_steps"])):
            item = next(self.items)
            self.rows.append(self._scene_rows(item))
            losses.append(self.runner.run(item, more=True)["loss"])
            if s == 0:
                opt = self.state.optimizer
                for name, p in self.state.model.named_parameters():
                    m = opt.state.get(p, {}).get("exp_avg")
                    if m is not None:
                        grad[name] = (m.detach().to("cpu", torch.float32)
                                      / (1.0 - self.b1))
                        grad_norm[name] = (float(m.double().norm())
                                           / (1.0 - self.b1))
        self.program = {
            "loss": [float(x) for x in losses], "grad": grad,
            "grad_norm": grad_norm,
            "change": {n: float((p.detach() - self.weights[n]).double()
                                .norm())
                       for n, p in self.state.model.named_parameters()}}
        return self.program

    def warm(self):
        for _ in range(int(self.traffic["warm_steps"])):
            self.runner.run(next(self.items), more=True)
        _sync(self.device)

    # -- the window ----------------------------------------------------------

    def window(self, seconds):
        """Steps until `seconds` have passed, then a device sync. Returns
        (steps, window seconds, seconds spent waiting for batches)."""
        _sync(self.device)
        steps, wait = 0, 0.0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            a = time.perf_counter()
            item = next(self.items)
            wait += time.perf_counter() - a
            self.last = self.runner.run(item, more=True)
            steps += 1
            if time.perf_counter() >= deadline:
                break
        _sync(self.device)
        return steps, time.perf_counter() - t0, wait

    def traced(self, steps):
        """`steps` steps under torch.profiler -> trace.TraceSummary."""
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for _ in range(3):  # the profiler's own start-up
                self.runner.run(next(self.items), more=True)
            _sync(self.device)
            with record_function("portbench.traced_window"):
                for _ in range(steps):
                    with record_function("portbench.feed_wait"):
                        item = next(self.items)
                    with record_function("portbench.step"):
                        self.last = self.runner.run(item, more=True)
                _sync(self.device)
        device, host = trace.events_of(prof)
        return trace.summarize(device, host,
                               trace.window_of(host, "traced_window"))

    def release(self):
        """Close the feed and free the program's state."""
        self.feed.close()
        self.items = self.feed = self.runner = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    # -- the reference -------------------------------------------------------

    def reference(self, lowp=None):
        """The reference's readings over the compared steps' scenes, or
        None when a compared batch held a row that is no scene."""
        if any(r < 0 for rows in self.rows for r in rows):
            return None
        exact_f32()
        batches = [(torch.from_numpy(self.scenes.images[rows]).to(self.device),
                    torch.from_numpy(self.scenes.depths[rows]).to(self.device))
                   for rows in self.rows]
        return reftrain.train_readings(
            self.ref, self.config["arch"], self.config["config"]["train"],
            self.weights, batches, input_hw=self.input_hw,
            target_hw=self.target_hw, lowp=lowp)

    def gaps(self, reference):
        if reference is None:  # a compared row was no scene
            return {}
        return compare.train_gaps(self.program, reference)


def run(ctx):
    """One run of a training cell (see run.py for `ctx` and the result)."""
    t = ctx.traffic
    r = TrainRun(ctx.config, t, ctx.seed, ctx.device)
    begin = time.perf_counter()
    r.setup()
    mark = time.perf_counter()
    r.first_steps()
    r.phases["first_steps"] = time.perf_counter() - mark
    mark = time.perf_counter()
    r.warm()
    r.phases["warm"] = time.perf_counter() - mark
    setup_s = time.perf_counter() - ctx.t_start
    r.phases["imports_and_init"] = begin - ctx.t_start
    print("set-up s: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                    r.phases.items()), file=sys.stderr)
    steps, window_s, wait = r.window(ctx.seconds)
    summary = r.traced(int(t["trace_steps"])) if ctx.trace else None
    last_loss = float(r.last["loss"])
    memory = (torch.cuda.max_memory_allocated(r.device)
              if r.device.type == "cuda" else 0)
    r.release()
    checks = r.gaps(r.reference())
    checks["last_loss_finite"] = 0.0 if math.isfinite(last_loss) else 1.0
    arch = ctx.config["arch"]
    layer = {
        "kind": "train", "batch": r.batch, "steps": steps,
        "window_s": window_s, "feed_wait_s": wait,
        "step_flops": flops.model_flops(ctx.config["reference"], arch,
                                        r.input_hw, r.batch, backward=True),
        "trace": summary, "traced_steps": int(t["trace_steps"]),
        "preprocess_bound_s": preprocess.train_step_bound_s(
            r.batch, t["image_hw"], t["depth_hw"], r.input_hw,
            r.target_hw)}
    return dict(e2e={"setup_s": setup_s,
                     "train_images_per_s": steps * r.batch / window_s},
                layer=layer, attempted=steps, failed=0, checks=checks,
                memory_peak_bytes=memory, trace=summary)
