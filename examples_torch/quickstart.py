"""Quickstart on the PyTorch port: build a model, train a few steps, then
prefill + decode.

    python examples_torch/quickstart.py [--arch smollm-135m]        (on the GPU)
    python examples_torch/quickstart.py --device cpu --steps 5

The counterpart of the JAX package's ``examples/quickstart.py``: the reduced
(tiny, f32) variant of the arch on one device, trained on the synthetic
pipeline, then a prefill of a random batch (``make_dummy_batch``) and eight
greedy decode steps from an empty cache, as the reference does.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (RunConfig, ShapeConfig, TrainConfig,  # noqa: E402
                                 get_model_config, reduced)
from repro_torch.data.pipeline import SyntheticPipeline  # noqa: E402
from repro_torch.device import device_of  # noqa: E402
from repro_torch.models import make_dummy_batch  # noqa: E402
from repro_torch.runtime.serve_loop import (ServeState, make_decode_step,  # noqa: E402
                                            make_prefill_step)
from repro_torch.runtime.train_loop import init_state, make_train_step  # noqa: E402
from repro_torch.sharding.fsdp import at_use  # noqa: E402
from repro_torch.sharding.specs import dp_axes, tree_leaves  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    model = reduced(get_model_config(args.arch))  # tiny same-family variant
    run = RunConfig(
        model=model,
        shape=ShapeConfig("t", "train", 128, 8),
        train=TrainConfig(steps=args.steps, learning_rate=1e-2, warmup_steps=2),
    )
    state = init_state(run, None, bridge.random_params(model, run.train.seed), device=device)
    n_params = sum(leaf.local.numel() for leaf in tree_leaves(state.params))
    print(f"model: {model.name} ({model.family}), {n_params:,} params")

    _, _, step = make_train_step(run, None, device=device)
    pipe = SyntheticPipeline(model, run.shape, device=device)
    t0 = time.time()
    for i in range(args.steps):
        state, m = step(state, pipe.next_batch(i))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}")
    print(f"trained {args.steps} steps in {time.time()-t0:.1f}s")

    # prefill + greedy decode a few tokens
    pshape = ShapeConfig("p", "prefill", 32, 2)
    prun = RunConfig(model=model, shape=pshape)
    params = at_use(state.params, 1, dp_axes(prun.mesh))
    batch = make_dummy_batch(model, pshape, torch.Generator(device=device).manual_seed(1),
                             device=device)
    api, _, prefill = make_prefill_step(prun, None, device=device)
    _, _, decode = make_decode_step(prun, None, device=device)
    with torch.no_grad():
        logits, _ = prefill(params, batch)
        serve = ServeState(api.init_cache(2, 48), torch.zeros(2, dtype=torch.long,
                                                              device=device))
        tok = logits.argmax(-1)
        out = [int(tok[0])]
        for _ in range(8):
            lg, serve = decode(params, serve, tok)
            tok = lg.argmax(-1)
            out.append(int(tok[0]))
    print("greedy continuation token ids:", out)


if __name__ == "__main__":
    main()
