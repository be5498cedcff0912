"""Serving launcher: batched generation with the LM engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v0_1_52b \\
        --smoke --device cpu

Runs on the card (``--device cuda``, the default) unless told otherwise.
Weights are random, drawn from a generator seeded with 0 on the chosen
device; prompts come from ``numpy.random.default_rng(0)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models.api import Model
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.smoke_config(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(seed=0)
    eng = Engine(model, params, ServeConfig(max_new_tokens=args.max_new,
                                            temperature=args.temperature))
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = eng.generate(prompts)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "cpu")
    total = out.size
    print(f"generated {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s on {where})")
    print(out[:, :12])


if __name__ == "__main__":
    main()
