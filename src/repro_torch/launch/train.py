"""Training launcher of the port: the FSDP train step through the paper's
allgathers and their transposes, on one GPU, under the checkpoint/restart
supervisor.

    python -m repro_torch.launch.train --arch smollm-135m --steps 10
    python -m repro_torch.launch.train --arch smollm-135m --smoke --device cpu
    python -m repro_torch.launch.train --arch smollm-135m --fsdp-mode mcast --prefetch \
        --remat dots
    python -m repro_torch.launch.train --arch smollm-135m --mesh production --multi-pod \
        --ckpt-dir ckpt --ckpt-every 50
    python -m repro_torch.launch.train --arch deepseek-moe-16b --layers 2 --batch 16 \
        --seq 512 --fsdp-mode mcast --steps 5
    python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke --device cpu
    python -m repro_torch.launch.train --arch rwkv6-7b --layers 2 --batch 16 --seq 512
    python -m repro_torch.launch.train --arch recurrentgemma-9b --smoke --device cpu
    python -m repro_torch.launch.train --arch phi-3-vision-4.2b --layers 2 --batch 8 \
        --seq 1536
    python -m repro_torch.launch.train --arch whisper-base --batch 16 --seq 512
    python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b --smoke --device cpu

--prefetch gathers layer i + 1 during layer i (``CollectiveConfig.prefetch``;
on the card on a side stream; the mcast modes only, as in the reference),
and --remat picks what the backward recomputes: "full" (each layer's gather
and block), "dots" (all of it but the products' outputs) or "none".

--mesh picks the stacked ranks: "local" is ``(data=8, model=1)`` (with
--multi-pod ``(pod=2, data=4, model=1)``), "production" the reference's
``(data=16, model=16)`` (with --multi-pod ``(pod=2, data=16, model=16)``):
256 or 512 ranks, every family tensor- and sequence-parallel over
``model``: MoE's experts split over it (EP), rwkv's and attention's heads
and the RG-LRU's width where they divide (whisper's 8 heads at tp = 16 run
whole on every tp rank, as the reference places them). A global batch that
does not split over the dp ranks is replicated on each.

--smoke runs the reduced config of the arch (f32, two layers); --layers cuts
the depth of the full-width one (the encdec's two stacks each to that
depth). phi-3-vision's --seq counts its 1,024 patches and the tokens after
them; whisper's frames are --seq long. Weights are drawn from
``TrainConfig.seed`` in the reference's init scales (no checkpoint is read at the start): with
--smoke by numpy on the host (``bridge.random_params``), otherwise on the
device, each rank's shards directly (``bridge.device_params``). The data is
the synthetic pipeline's. The
steps run under ``runtime.fault.TrainSupervisor``: an async checkpoint into
--ckpt-dir every --ckpt-every steps, and a restart from the latest one on a
failure.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="reduced config (f32)")
    ap.add_argument("--mesh", default="local", choices=["local", "production"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fsdp-mode", default="xla",
                    choices=["xla", "mcast", "mcast_ring", "mcast_bcast"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--prefetch", action="store_true",
                    help="gather layer i + 1 during layer i (mcast modes)")
    ap.add_argument("--batch", type=int, default=0, help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (full width)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch import bridge
    from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_model_config, reduced, replace)
    from repro_torch.configs.base import SHAPES
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.device import device_of
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.models.layers import dtype_of
    from repro_torch.runtime.fault import TrainSupervisor
    from repro_torch.runtime.train_loop import init_state, make_train_step

    device = device_of(args.device)
    model = get_model_config(args.arch)
    shape = SHAPES[args.shape]
    if args.smoke:
        model = reduced(model, layers=args.layers or None)
        shape = ShapeConfig(shape.name, shape.kind, args.seq or 128, args.batch or 8)
    else:
        if args.layers:
            model = replace(model, num_layers=args.layers)
            if model.encdec is not None:
                model = replace(model, encdec=replace(model.encdec, enc_layers=args.layers,
                                                      dec_layers=args.layers))
        if args.batch or args.seq:
            shape = ShapeConfig(shape.name, shape.kind, args.seq or shape.seq_len,
                                args.batch or shape.global_batch)
    run = RunConfig(model=model, shape=shape, mesh=MeshConfig(multi_pod=args.multi_pod),
                    train=TrainConfig(steps=args.steps, grad_accum=args.grad_accum,
                                      remat=args.remat, checkpoint_dir=args.ckpt_dir,
                                      checkpoint_every=args.ckpt_every),
                    collective=CollectiveConfig(fsdp_mode=args.fsdp_mode,
                                                prefetch=args.prefetch))
    make_mesh = make_production_mesh if args.mesh == "production" else make_local_mesh
    mesh = make_mesh(multi_pod=args.multi_pod)

    print(f"[train] {model.name} shape={shape.name} B={shape.global_batch} "
          f"S={shape.seq_len} device={device} mesh={mesh} fsdp={args.fsdp_mode} "
          f"remat={args.remat} prefetch={args.prefetch}", flush=True)
    _, _, step_fn = make_train_step(run, mesh, device=device)
    if args.smoke:
        tree = bridge.random_params(model, run.train.seed)
    else:
        tree = bridge.device_params(model, mesh, run.mesh, seed=run.train.seed,
                                    dtype=dtype_of(model.param_dtype), device=device)
    state = init_state(run, mesh, tree, device=device)
    pipe = SyntheticPipeline(model, shape, device=device)
    sup = TrainSupervisor(step_fn=step_fn, pipeline=pipe, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every)
    state, history = sup.run(state, args.steps)
    for h in history:
        if h["step"] % args.log_every == 0 or h["step"] == args.steps - 1:
            print(f"step {h['step']:5d} loss {h['loss']:.4f} "
                  f"gnorm {h.get('grad_norm', 0):.3f} dt {h['dt'] * 1e3:.0f}ms",
                  flush=True)
    print(f"[train] done; stragglers flagged: {len(sup.monitor.events)}", flush=True)


if __name__ == "__main__":
    main()
