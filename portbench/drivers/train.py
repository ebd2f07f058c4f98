"""Training: the program's step path as `Trainer.fit` feeds it, on the
configuration's training frames. Per epoch `NativePrefetcher.epoch()`
(the C++ prefetcher: std::mt19937_64(seed + epoch), a ring of 4 slots) ->
`trainer._device_prefetch` (pinned copies on a thread) -> `train_step`
(augmentation on the device, the loss with dropout on, backward,
`apply_update`: AdamW). Validation and checkpoints are not in the window.

Set-up builds the trainer (`init_state`, then the benchmark's weights,
drawn by the backbone's rule, `reference/<model_name>.py init`, loaded
into its model), runs the first epoch, whose first `checked_steps` steps
the reference follows, and hands the same trainer to the window. The
window runs epochs until the step that ends past `--seconds`;
`train_images_per_s` is the images of its steps over its time, ended by
a synchronise. `feed_wait_ms` is the harness's span around each wait for
the next batch. With `--trace 1` the window's second epoch is traced;
its FLOPs are the backbone's `train_flops` an image.

After the window the reference reads the training frames from the films
and extracts their landmarks itself (reference/landmarks.py). It finds
each frame the program fed (its image, byte for byte, among the films')
and runs the checked steps on its own images and landmarks of those
frames, from the same weights and generator seed: the loss of each step,
the first gradient (the optimizer's first moment after one step over
1 - beta1) and the parameters' change after the last checked step, by
the worst leaf. The program's extracted landmarks of every training
frame are held to the reference's (`landmark_px`), and a frame the
films do not hold is counted (`unmatched`).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from contextlib import closing

import numpy as np
import torch

from portbench import devtrace, program, work
from portbench.reference import landmarks as ref_landmarks
from portbench.reference import train as ref_train


def run(ctx, control: bool = False):
    from contouring_uncertainty_torch.data.native_loader import NativePrefetcher
    from contouring_uncertainty_torch.train.trainer import (Trainer, TrainerConfig,
                                                            _device_prefetch)

    tr = ctx.traffic
    device = torch.device(ctx.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    made = program.make_films(ctx.config, ctx.seed)
    data = program.data_source(ctx.config, made)
    backbone, m = ctx.backbone, ctx.config["model"]
    task, model, weights = program.task_and_model(ctx.config, data, ctx.seed, device,
                                                  backbone.init)
    del model
    run_seed = int(ctx.seed) % (2 ** 63)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    trainer = Trainer(task, TrainerConfig(batch_size=tr["batch_size"], lr=tr["lr"],
                                          weight_decay=tr["weight_decay"],
                                          optimizer=tr["optimizer"], augment=tr["augment"],
                                          seed=run_seed, save_path=tmp), device=device)
    trainer.init_state()
    trainer.model.load_state_dict(weights)
    arrays = data.train_arrays("train")
    prefetcher = NativePrefetcher(arrays, tr["batch_size"], seed=run_seed)
    n_checked = int(tr["checked_steps"])
    checked, state = [], {}
    step = 0
    with closing(_device_prefetch(prefetcher.epoch(), device)) as batches:
        for batch in batches:
            if step < n_checked:
                checked.append(batch["img"].cpu().numpy())
            logs = trainer.train_step(batch, step)
            if step < n_checked:
                state.setdefault("losses", []).append(float(logs["loss"]))
            if step == 0:
                state["exp_avg"] = {
                    n: trainer.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p)).clone()
                    for n, p in trainer.model.named_parameters()}
            step += 1
            if step == n_checked:
                state["params"] = {n: p.detach().clone()
                                   for n, p in trainer.model.named_parameters()}
    sync()

    ctx.setup_done()
    steps, epoch = 0, 0
    waits = ctx.spans.setdefault("feed_wait", [])
    start = time.perf_counter()
    done = False
    while not done:
        reading = None
        if ctx.trace and epoch == 1:
            reading = ctx.reading = devtrace.Reading(kind="train")
        traced_steps = 0
        with devtrace.traced(reading), closing(_device_prefetch(prefetcher.epoch(),
                                                                device)) as batches:
            while True:
                t0 = time.perf_counter()
                with devtrace.span("feed_wait"):
                    batch = next(batches, None)
                if batch is None:
                    break
                waits.append(time.perf_counter() - t0)
                with devtrace.span("train_step"):
                    trainer.train_step(batch, step)
                step += 1
                steps += 1
                traced_steps += 1
                if (time.perf_counter() - start >= ctx.seconds
                        and (not ctx.trace or epoch >= 1) and reading is None):
                    done = True
                    break
        if reading is not None:
            images = traced_steps * tr["batch_size"]
            reading.flops = images * backbone.train_flops(task.data_params.in_shape,
                                                          task.data_params.out_shape[0], m)
            size = ctx.config["data"]["size"]
            rows = tr["batch_size"] * task.data_params.out_shape[0]
            reading.launches = {"k2": [work.k2_work(rows, size * size, 4)] * traced_steps}
        epoch += 1
        if time.perf_counter() - start >= ctx.seconds and (not ctx.trace or epoch > 1):
            done = True
    sync()
    elapsed = time.perf_counter() - start
    ctx.values["train_images_per_s"] = steps * tr["batch_size"] / elapsed
    ctx.attempted = steps
    ctx.memory_peak()

    prefetcher.close()
    del trainer, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    d = ctx.config["data"]
    images, points = ref_landmarks.training_frames(made, d["fold"], 2 * d["points_per_side"] - 1)
    find = {frame.tobytes(): i for i, frame in enumerate(images)}
    fed = [np.array([find.get(row.tobytes(), -1) for row in rows]) for rows in checked]
    mine = np.array([find.get(row.tobytes(), -1) for row in arrays["img"]])
    ctx.numbers["unmatched"] = float(sum((rows < 0).sum() for rows in [mine, *fed]))
    ctx.numbers["landmark_px"] = (float(np.abs(arrays["contour"][mine >= 0]
                                               - points[mine[mine >= 0]]).max())
                                  if (mine >= 0).any() else float("inf"))
    batches = [{"img": torch.from_numpy(images[np.maximum(rows, 0)]).to(device),
                "contour": torch.from_numpy(points[np.maximum(rows, 0)]).to(device)}
               for rows in fed]

    def reference(tf32: bool):
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return ref_train.steps(weights, batches, run_seed,
                                   lambda w, x, drop: backbone.forward(w, x, m, drop),
                                   tr["lr"], tr["weight_decay"])
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    ref = reference(False)
    got = {"losses": state["losses"],
           "first_grad": {k: v / 0.1 for k, v in state["exp_avg"].items()},
           "params": state["params"]}
    ctx.numbers.update(numbers(got, ref, weights))
    if control:
        ctx.control.update(numbers(reference(True), ref, weights))


def numbers(got, ref, weights):
    change = lambda run: {k: run["params"][k] - weights[k] for k in weights}
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    return {
        **{f"loss{i}_rel": g for i, g in enumerate(gaps, start=1)},
        "grad_leaf": ref_train.leaf_gap(got["first_grad"], ref["first_grad"], ref["first_grad"]),
        "step_leaf": ref_train.leaf_gap(change(got), change(ref), ref["first_grad"]),
    }
