"""Serving launcher of the port: FSDP-sharded prefill through the paper's
allgathers, then greedy decoding, on one GPU.

    python -m repro_torch.launch.serve --arch smollm-135m
    python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu

Weights are drawn from ``TrainConfig.seed`` in the reference's init scales (no
checkpoint is read). The ``DP`` data-parallel ranks are stacked on the one
device.
"""
from __future__ import annotations

import argparse
import time

DP = 8   # stacked data-parallel ranks

def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced width and depth, f32")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--fsdp-mode", default="mcast",
                    choices=["xla", "mcast", "mcast_ring", "mcast_bcast"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import bridge
    from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                     get_model_config, reduced)
    from repro_torch.device import device_of
    from repro_torch.kernels import ring_allgather
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.models.layers import dtype_of
    from repro_torch.runtime.serve_loop import (greedy_generate, make_decode_step,
                                                make_prefill_step)

    device = device_of(args.device)
    model = get_model_config(args.arch)
    if args.smoke:
        model = reduced(model)
    mesh = StackedMesh(data=DP, model=1)
    run = RunConfig(model=model,
                    shape=ShapeConfig("serve", "prefill", args.prompt_len, args.batch),
                    collective=CollectiveConfig(fsdp_mode=args.fsdp_mode))
    params = bridge.to_torch(bridge.random_params(model, run.train.seed), mesh, run.mesh,
                             dtype=dtype_of(model.param_dtype), device=device)
    _, _, prefill = make_prefill_step(run, mesh, device=device)
    _, _, decode = make_decode_step(run, mesh, device=device)
    tokens = torch.from_numpy(np.random.default_rng(run.train.seed).integers(
        0, model.vocab_size, (args.batch, args.prompt_len))).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    before = ring_allgather.allgather_launches
    t0 = time.perf_counter()
    seqs = greedy_generate(prefill, decode, params, tokens, args.new_tokens,
                           args.prompt_len + args.new_tokens)
    sync()
    dt = time.perf_counter() - t0
    total_new = args.batch * args.new_tokens
    print(f"[serve] {model.name} on {device} ({args.fsdp_mode}, dp={DP}): "
          f"{args.batch} seqs, {args.prompt_len} prompt + {args.new_tokens} new tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s, prefill included); "
          f"{ring_allgather.allgather_launches - before} ring-allgather kernel launches",
          flush=True)
    print("[serve] sample continuation token ids:",
          seqs[0, args.prompt_len:args.prompt_len + 8].tolist())


if __name__ == "__main__":
    main()
