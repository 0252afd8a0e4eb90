"""End-to-end driver on the PyTorch port: train the REAL smollm-135m (~135M
params) with the full stack — synthetic data pipeline, the train step,
AdamW, checkpointing and fault-tolerant supervision — for a few hundred
steps.

    python examples_torch/train_100m.py --steps 200          (on the GPU)
    python examples_torch/train_100m.py --device cpu --steps 2

The counterpart of the JAX package's ``examples/train_100m.py``: one device,
no mesh, ``remat="none"``, weights drawn with numpy from seed 0
(``bridge.random_params``), the steps under ``runtime.fault.TrainSupervisor``
with an async checkpoint into --ckpt-dir every --ckpt-every steps.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (RunConfig, ShapeConfig, TrainConfig,  # noqa: E402
                                 get_model_config)
from repro_torch.data.pipeline import SyntheticPipeline  # noqa: E402
from repro_torch.device import device_of  # noqa: E402
from repro_torch.runtime.fault import StragglerMonitor, TrainSupervisor  # noqa: E402
from repro_torch.runtime.train_loop import init_state, make_train_step  # noqa: E402
from repro_torch.sharding.specs import tree_leaves  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_100m_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    model = get_model_config("smollm-135m")   # the real ~135M-param config
    run = RunConfig(
        model=model,
        shape=ShapeConfig("t", "train", args.seq, args.batch),
        train=TrainConfig(steps=args.steps, learning_rate=3e-4, warmup_steps=20,
                          remat="none"),
    )
    _, _, step = make_train_step(run, None, device=device)
    state = init_state(run, None, bridge.random_params(model, run.train.seed), device=device)
    n_params = sum(leaf.local.numel() for leaf in tree_leaves(state.params))
    print(f"[100m] smollm-135m: {n_params/1e6:.1f}M params, "
          f"B={args.batch} S={args.seq}, {args.steps} steps")

    pipe = SyntheticPipeline(model, run.shape, device=device)
    sup = TrainSupervisor(
        step_fn=step, pipeline=pipe, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, monitor=StragglerMonitor(threshold=4.0),
    )
    state, hist = sup.run(state, args.steps)
    first = sum(h["loss"] for h in hist[:10]) / max(len(hist[:10]), 1)
    last = sum(h["loss"] for h in hist[-10:]) / max(len(hist[-10:]), 1)
    for h in hist:
        if h["step"] % 25 == 0 or h["step"] == args.steps - 1:
            print(f"step {h['step']:4d}  loss {h['loss']:.4f}  dt {h['dt']:.2f}s")
    print(f"[100m] mean loss first-10 {first:.4f} -> last-10 {last:.4f} "
          f"(descended: {last < first})")


if __name__ == "__main__":
    main()
