#!/usr/bin/env python3
"""Decode against teacher forcing for Jamba at full width on one NVIDIA
GPU, on every one of ``chip_smoke.LM_TF_ROWS`` prompts, in f32 compute and
in the served bf16 compute, on the same bf16 weights.

Run from the root of a checkout:

    python3 chip_lm_tf.py

``chip_smoke.py`` gates decode against teacher forcing in f32 compute on
``LM_BATCH`` rows and prints the bf16 figure over ``LM_TF_ROWS`` rows;
this script prints both computes over the ``LM_TF_ROWS`` rows, each row's
largest logit difference and top-2 gap, so that a row that stands out in
bf16 can be told apart from bf16 rounding.  It gates nothing; it exits
non-zero without a CUDA device.  The model, weights and prompts are
``chip_smoke.py``'s (``lm_config``, seeds 0 and 1).
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_lm_tf: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models.api import Model
    build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cfg = cs.lm_config()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    for label, m in (("f32 compute", Model(cfg.with_overrides(
            compute_dtype=torch.float32), device="cuda")),
                     ("bf16 compute", model)):
        cs.teacher_forcing(m, params, cs.LM_TF_ROWS, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
