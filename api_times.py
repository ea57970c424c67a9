#!/usr/bin/env python3
"""Times the main path's NAND and the ``Tfhe.*`` API with a tree's package.

    python3 api_times.py [TREE]        (TREE defaults to the working directory)

Builds TREE's kernels, then runs TREE's ``chip_smoke.py`` timings: the
128-bit NAND over the default config's eval key at
``FrameworkConfig().batch_size`` (one warm call, then the mean of ITERS calls
by CUDA events, as phase 4) and ``api_smoke`` (phase 14: the ``Tfhe.*`` API
at batch 1, host seconds per call).  To compare two commits on one card,
unpack each into a directory and run this script on both in one call, in
turns (a, b, b, a, ...).  Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=".", help="root of the checkout to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("api_times: no CUDA device is available", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from eoc_tfhe_tpu_torch.config import FrameworkConfig
    from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, params
    from eoc_tfhe_tpu_torch.kernels import build

    build.build_all()
    print(f"tree {args.tree} ({torch.cuda.get_device_name(0)})", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = params.default_128bit_params()
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p, device=dev)
    ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    B = FrameworkConfig().batch_size
    a = torch.randint(0, 2, (B,), generator=gen, device=dev).bool()
    b = torch.randint(0, 2, (B,), generator=gen, device=dev).bool()
    ca, cb = (gates.encrypt_bit(gen, x, ks.lwe_key, p) for x in (a, b))
    gates.nand(ca, cb, ek, p)                              # warm
    ms, out = cs.cuda_ms(lambda: gates.nand(ca, cb, ek, p), cs.ITERS)
    cs.check(torch.equal(gates.decrypt_bit(out, ks.lwe_key), ~(a & b)),
             "a NAND output decrypts wrong")
    print(f"nand B={B}: {ms:.2f} ms/call", flush=True)
    del ks, ek, ca, cb, out
    cs.api_smoke(0, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
