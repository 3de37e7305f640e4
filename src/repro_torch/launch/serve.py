"""Batched serving launcher (PyTorch port of `repro.launch.serve`).

    python -m repro_torch.launch.serve --arch starcoder2-7b --batch 4 \
        --prompt-len 4096 --new-tokens 32
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --reduced \
        --device cpu

Serves every decoder family (dense, vlm, moe, ssm, hybrid); an encoder
(hubert-xlarge) has nothing to decode and is refused. Runs on the card
unless `--device cpu` is given. Parameters are random, from `--seed`.
Full-sequence attention goes through the flash-attention kernel
(`use_flash_kernel=True`).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params, param_count
from repro_torch.serving.serve_loop import generate


def main(argv: list[str] | None = None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to decode")
    cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    dev = resolve_device(args.device)

    params = init_params(cfg, args.seed, device=dev)
    print(f"arch={cfg.name} params={param_count(params)/1e6:.2f}M")

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    timings: dict = {}
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, max_new_tokens=args.new_tokens,
                   temperature=args.temperature, seed=args.seed,
                   timings=timings)
    dt = time.perf_counter() - t0
    tput = args.batch * args.new_tokens / dt
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({tput:.1f} tok/s; "
          f"prefill {timings['prefill_s']:.2f}s, decode "
          f"{timings['decode_s']:.2f}s)")
    print("sample:", out[0, -10:].tolist())
    return out


if __name__ == "__main__":
    main()
