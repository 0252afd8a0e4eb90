"""Training launcher of the port: the FSDP train step through the paper's
allgathers and their transposes, on one GPU.

    python -m repro_torch.launch.train --arch smollm-135m --steps 10
    python -m repro_torch.launch.train --arch smollm-135m --smoke --device cpu
    python -m repro_torch.launch.train --arch smollm-135m --fsdp-mode mcast --prefetch \
        --remat dots

--prefetch gathers layer i + 1 during layer i (``CollectiveConfig.prefetch``;
on the card on a side stream; the mcast modes only, as in the reference),
and --remat picks what the backward recomputes: "full" (each layer's gather
and block), "dots" (all of it but the products' outputs) or "none".

--smoke runs the reduced config of the arch (f32, two layers). Weights are
drawn from ``TrainConfig.seed`` in the reference's init scales (no
checkpoint is read); the data is the synthetic pipeline's. The ``DP``
data-parallel ranks are stacked on the one device. Checkpointing and the
restart supervisor of the reference's launcher are not ported yet.
"""
from __future__ import annotations

import argparse
import time

DP = 8   # stacked data-parallel ranks


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="reduced config (f32)")
    ap.add_argument("--fsdp-mode", default="xla",
                    choices=["xla", "mcast", "mcast_ring", "mcast_bcast"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--prefetch", action="store_true",
                    help="gather layer i + 1 during layer i (mcast modes)")
    ap.add_argument("--batch", type=int, default=0, help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch import bridge
    from repro_torch.configs import (CollectiveConfig, RunConfig, ShapeConfig, TrainConfig,
                                     get_model_config, reduced)
    from repro_torch.configs.base import SHAPES
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.device import device_of
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.runtime.train_loop import init_state, make_train_step

    device = device_of(args.device)
    model = get_model_config(args.arch)
    shape = SHAPES[args.shape]
    if args.smoke:
        model = reduced(model)
        shape = ShapeConfig(shape.name, shape.kind, args.seq or 128, args.batch or 8)
    elif args.batch or args.seq:
        shape = ShapeConfig(shape.name, shape.kind, args.seq or shape.seq_len,
                            args.batch or shape.global_batch)
    run = RunConfig(model=model, shape=shape,
                    train=TrainConfig(steps=args.steps, grad_accum=args.grad_accum,
                                      remat=args.remat),
                    collective=CollectiveConfig(fsdp_mode=args.fsdp_mode,
                                                prefetch=args.prefetch))
    mesh = StackedMesh(data=DP, model=1)

    print(f"[train] {model.name} shape={shape.name} B={shape.global_batch} "
          f"S={shape.seq_len} device={device} dp={DP} fsdp={args.fsdp_mode} "
          f"remat={args.remat} prefetch={args.prefetch}", flush=True)
    _, _, step_fn = make_train_step(run, mesh, device=device)
    state = init_state(run, mesh, bridge.random_params(model, run.train.seed), device=device)
    pipe = SyntheticPipeline(model, shape, device=device)
    for i in range(args.steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, pipe.next_batch(i))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])   # waits for the step
        dt = time.perf_counter() - t0
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {loss:.4f} gnorm {gnorm:.3f} dt {dt * 1e3:.0f}ms",
                  flush=True)
    print("[train] done", flush=True)


if __name__ == "__main__":
    main()
