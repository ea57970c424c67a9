#!/usr/bin/env python3
"""Runs the port's parallel tier across the cards of one host, one NCCL rank a card.

    python3 parallel_times.py [--seed 0]

Needs 2 or 4 cards (it takes all of them).  The parent makes a
128-bit keyset on cuda:0 and the one-rank results (the direct NAND of
B=FrameworkConfig().batch_size pairs, the "ntt_scan" rotation of random
inputs, the float32 stories110M forward), then spawns one rank a card
(NCCL) that runs ``chip_smoke.py``'s phase-19 rank body over this plan: the
dp NAND at (world, 1), (world/2, 2) and (1, world), ``scaling_report`` of
the dp NAND at B per rank, ``blind_rotate_ntt_tp`` at (world/2, 2), the
frequency-split NAND at tp=world, a ``native_keys`` round trip and the
llama forward at tp=world.  Every result is held word for word (the llama
within 1e-4) against the one-rank result; any failure exits non-zero.
Prints the cards' names and power limits and the times.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile

import torch

import chip_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of keys and data")
    args = ap.parse_args()
    world = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world not in (2, 4):
        # the plan's layouts: kpl = 6 gadget rows and 12 heads split over 2 or 4
        print(f"parallel_times: needs 2 or 4 CUDA cards, found {world}", file=sys.stderr)
        return 1
    from eoc_tfhe_tpu_torch.config import FrameworkConfig
    from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, params
    from eoc_tfhe_tpu_torch.kernels import build

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60, check=True).stdout.strip().splitlines()
    print("cards: " + "; ".join(cards), flush=True)
    smi = cards[0] if len(set(cards)) == 1 else " / ".join(cards)
    build.build_all()                      # before the ranks start: each would run nvcc

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p = params.default_128bit_params()
    B = FrameworkConfig().batch_size
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p, device=dev)
    ek = bootstrap.prepare_eval_key(ks.cloud, p)
    a, b = (torch.randint(0, 2, (B,), generator=gen, device=dev).bool() for _ in range(2))
    ca, cb = (gates.encrypt_bit(gen, x, ks.lwe_key, p) for x in (a, b))
    ref = gates.nand(ca, cb, ek, p)
    n_wrong = int((gates.decrypt_bit(ref, ks.lwe_key) != ~(a & b)).sum())
    chip_smoke.check(n_wrong == 0, f"{n_wrong} of {B} NAND outputs decrypt wrong")
    del ek
    plan = {"backend": "nccl", "rank_card": True,
            "nand": tuple(sorted({(world, 1), (world // 2, 2), (1, world)}, reverse=True)),
            "rows": (world // 2, 2), "freq": (1, world), "llama": (1, world), "scaling": B}
    with tempfile.TemporaryDirectory() as tmp:
        one_rank = chip_smoke.parallel_inputs(ks, p, gen, ca, cb, ref, tmp)
        chip_smoke.run_parallel_ranks(plan, world, tmp, B, one_rank, smi)
    print(f"parallel_times: {world} NCCL ranks, every result equal to one rank's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
