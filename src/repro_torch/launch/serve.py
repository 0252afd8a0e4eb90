"""Serving launcher of the port: FSDP-sharded prefill through the paper's
allgathers, then greedy decoding, on one GPU.

    python -m repro_torch.launch.serve --arch smollm-135m
    python -m repro_torch.launch.serve --arch deepseek-moe-16b --batch 8 --prompt-len 128
    python -m repro_torch.launch.serve --arch deepseek-moe-16b --smoke --device cpu
    python -m repro_torch.launch.serve --arch rwkv6-7b --batch 8 --prompt-len 128
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --smoke --device cpu
    python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --batch 8 --prompt-len 128
    python -m repro_torch.launch.serve --arch whisper-base --batch 8 --prompt-len 512
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --smoke --device cpu

Weights are drawn from ``TrainConfig.seed`` in the reference's init scales (no
checkpoint is read): with --smoke by numpy on the host (``bridge.random_params``),
otherwise on the device, each rank's shards directly (``bridge.device_params``).
The local mesh's eight data-parallel ranks
(``launch.mesh.make_local_mesh``) are stacked on the one device; a batch
that does not split over them (the default, 4, as in the reference) is
replicated on every rank. The stub frontends' inputs are drawn from the
same seed, after the prompt: phi-3-vision's ``n_patches`` patch embeddings
ahead of the --prompt-len tokens (the cache holds both), whisper's
--prompt-len frames beside them.
"""
from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced width and depth, f32")
    ap.add_argument("--batch", type=int, default=4)
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
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import dtype_of
    from repro_torch.runtime.serve_loop import (greedy_generate, make_decode_step,
                                                make_prefill_step)

    device = device_of(args.device)
    model = get_model_config(args.arch)
    if args.smoke:
        model = reduced(model)
    mesh = make_local_mesh()
    patches = model.vision.n_patches if model.family == "vlm" else 0
    run = RunConfig(model=model,
                    shape=ShapeConfig("serve", "prefill", patches + args.prompt_len, args.batch),
                    collective=CollectiveConfig(fsdp_mode=args.fsdp_mode))
    if args.smoke:
        params = bridge.to_torch(bridge.random_params(model, run.train.seed), mesh, run.mesh,
                                 dtype=dtype_of(model.param_dtype), device=device)
    else:
        params = bridge.device_params(model, mesh, run.mesh, seed=run.train.seed,
                                      dtype=dtype_of(model.param_dtype), device=device)
    _, _, prefill = make_prefill_step(run, mesh, device=device)
    _, _, decode = make_decode_step(run, mesh, device=device)
    rng = np.random.default_rng(run.train.seed)
    tokens = torch.from_numpy(rng.integers(
        0, model.vocab_size, (args.batch, args.prompt_len))).to(device)
    inputs = {}
    if model.family == "vlm":
        inputs["patches"] = (args.batch, patches, model.vision.patch_dim)
    elif model.family == "encdec":
        inputs["frames"] = (args.batch, args.prompt_len, model.encdec.frame_dim)
    inputs = {k: (torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)) * 0.02).to(
        device=device, dtype=dtype_of(model.compute_dtype)) for k, shp in inputs.items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    before = ring_allgather.allgather_launches
    t0 = time.perf_counter()
    seqs = greedy_generate(prefill, decode, params, tokens, args.new_tokens,
                           patches + args.prompt_len + args.new_tokens, inputs)
    sync()
    dt = time.perf_counter() - t0
    total_new = args.batch * args.new_tokens
    print(f"[serve] {model.name} on {device} ({args.fsdp_mode}, dp={mesh.n_ranks}): "
          f"{args.batch} seqs, {f'{patches} patches + ' if patches else ''}"
          f"{args.prompt_len} prompt + {args.new_tokens} new tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s, prefill included); "
          f"{ring_allgather.allgather_launches - before} ring-allgather kernel launches",
          flush=True)
    print("[serve] sample continuation token ids:",
          seqs[0, args.prompt_len:args.prompt_len + 8].tolist())


if __name__ == "__main__":
    main()
