#!/usr/bin/env python3
"""Times the llama decode step at llama2.c stories110M widths on the card.

    python3 llama_times.py [--rounds R] [--steps S]

Random weights from seed 0 through ``init_params`` (all 12 layers), a
128-token prefill, then R rounds of S ``decode_step`` calls in each of two
precision scopes, in turns: "per product" (the port's: each product takes
``device.exact_matmuls`` alone) and "per step" (the product scopes turned
off and one scope held around the whole step).  Each step is timed on the
host between two synchronizes; the median of each round is printed, beside
the card's name and power limit.  Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4, help="rounds of each scope")
    ap.add_argument("--steps", type=int, default=64, help="decode steps a round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("llama_times: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import LLAMA_PROMPT, STORIES110M
    from eoc_tfhe_tpu_torch.device import exact_matmuls
    from eoc_tfhe_tpu_torch.models import llama

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig(**STORIES110M)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(gen, cfg, device=dev)
    ids = torch.randint(0, cfg.vocab_size, (1, LLAMA_PROMPT + args.steps), generator=gen,
                        device=dev, dtype=torch.int32)
    _, cache = llama.prefill(params, ids[:, :LLAMA_PROMPT], cfg)

    def one_step(i, scope):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with scope():
            llama.decode_step(params, cache, LLAMA_PROMPT + i, ids[:, LLAMA_PROMPT + i], cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def per_product():
        return float(np.median([one_step(i, contextlib.nullcontext)
                                for i in range(args.steps)]))

    def per_step():
        with mock.patch.object(llama, "exact_matmuls", contextlib.nullcontext):
            return float(np.median([one_step(i, exact_matmuls) for i in range(args.steps)]))

    per_product()                                            # warm
    rows = {"per product": [], "per step": []}
    for _ in range(args.rounds):
        rows["per product"].append(per_product())
        rows["per step"].append(per_step())
    print(f"llama decode step ({smi.strip()}), stories110M, position {LLAMA_PROMPT} to "
          f"{LLAMA_PROMPT + args.steps - 1}, median ms of {args.steps} steps a round: "
          + "; ".join(f"{k} " + ", ".join(f"{1e3 * t:.3f}" for t in v) for k, v in rows.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
