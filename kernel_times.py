#!/usr/bin/env python3
"""Times the port's three blind-rotation kernels on one card.

    python3 kernel_times.py [--seed 0] [--label NAME] [--stages]

Imports ``eoc_tfhe_tpu_torch`` from the working directory (ahead of the
script's own), so one command can time two checkouts on the same card: run
it from the root of each.  Each checkout builds its own kernels and prepares its own
keys (from the same random TGSW rows) through its own functions.  Shapes:
the 128-bit set over all 630 steps; K1 (``blind_rotate_ntt``) at B=1 and
B=8 (the API's batches, which take its narrow tier) and B=8192 (the NAND
path's), and at the 80-bit set (500 steps) at B=1 and B=8, K2
(``blind_rotate_compact``, exact key) at B=1024 (the circuit path's) and
B=8192, K3 (``blind_rotate_ntt_v1``, over ``DEFAULT_PRIMES``) at B=1024 and
B=8192.
Times are CUDA-event means over several launches after one warm launch.
Prints the card and one JSON line.

``--stages`` also builds ``csrc/blind_rotate_ntt.cu`` and
``csrc/blind_rotate_ntt_v1.cu`` with ``-DCRT_MMA_PROFILE`` (diagnostic
libraries beside the others in ``_build/``, named by the sources' hash and
built once), runs K1 once at B=1, 8 and 8192 and at the 80-bit set at B=1
and 8, and K3 at B=1 and 8192, and prints block 0's clock cycles a step in
each stage (for K3 the pointwise stages include its key loader's transpose;
in K1's narrow tier block 0 is rank 0 of the first cluster, its stages the
wait for the accumulator on the "acc" mbarrier, the digits, the forward
with the wait for the key, the pointwise with chat's copies, the wait for
chat on the "chat" mbarrier, the inverse, the update and the accumulator's
copies).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the random rows and inputs")
    ap.add_argument("--label", default="", help="name of this checkout in the output")
    ap.add_argument("--stages", action="store_true",
                    help="also print K1's and K3's clock cycles by stage (diagnostic builds)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from eoc_tfhe_tpu_torch.core import params
    from eoc_tfhe_tpu_torch.kernels import build
    from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1, ntt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi.splitlines()[0]}", flush=True)
    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p = params.default_128bit_params()
    tg = p.tgsw_params
    N, U, n = tg.tlwe_params.N, tg.tlwe_params.k + 1, p.n

    def i32(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                             device=dev).to(torch.int32)

    rows = i32((n, tg.kpl, U, N))
    acc = i32((8192, U, N))
    bara = torch.randint(0, 2 * N, (n, 8192), generator=gen, dtype=torch.int32, device=dev)

    def ms(fn, B, iters):
        a, b = acc[:B].contiguous(), bara[:, :B].contiguous()
        fn(a, b)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(a, b)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    times = {}
    ctx = ntt.kernel_context_for_params(p, device=dev)
    key = ntt.prepare_kernel_key(rows, ctx)
    if args.stages:
        stages(build, blind_rotate, "blind_rotate_ntt", acc, bara, key, ctx, p, (1, 8, 8192))
    k1 = lambda a, b: blind_rotate.blind_rotate_ntt(a, b, key, ctx, p)  # noqa: E731
    times["blind_rotate_ntt B=1"] = ms(k1, 1, 10)
    times["blind_rotate_ntt B=8"] = ms(k1, 8, 10)
    times["blind_rotate_ntt B=8192"] = ms(k1, 8192, 2)
    del key
    p80 = params.default_80bit_params()
    tg80 = p80.tgsw_params
    ctx80 = ntt.kernel_context_for_params(p80, device=dev)
    key80 = ntt.prepare_kernel_key(i32((p80.n, tg80.kpl, U, N)), ctx80)
    if args.stages:
        stages(build, blind_rotate, "blind_rotate_ntt", acc, bara[:p80.n], key80, ctx80, p80,
               (1, 8))
    k1 = lambda a, b: blind_rotate.blind_rotate_ntt(a, b[:p80.n], key80, ctx80, p80)  # noqa: E731
    times["blind_rotate_ntt 80-bit B=1"] = ms(k1, 1, 10)
    times["blind_rotate_ntt 80-bit B=8"] = ms(k1, 8, 10)
    del key80
    ckey = blind_rotate_compact.prepare_compact_bk(rows, 4)
    k2 = lambda a, b: blind_rotate_compact.blind_rotate_compact(a, b, ckey, p)  # noqa: E731
    times["blind_rotate_compact B=1024"] = ms(k2, 1024, 3)
    times["blind_rotate_compact B=8192"] = ms(k2, 8192, 2)
    sctx = ntt.context_for_params(p, device=dev)
    skey = ntt.prepare_key_ntt(rows, sctx)
    if args.stages:
        stages(build, blind_rotate_v1, "blind_rotate_ntt_v1", acc, bara, skey, sctx, p, (1, 8192))
    k3 = lambda a, b: blind_rotate_v1.blind_rotate_ntt_v1(a, b, skey, sctx, p)  # noqa: E731
    times["blind_rotate_ntt_v1 B=1024"] = ms(k3, 1024, 3)
    times["blind_rotate_ntt_v1 B=8192"] = ms(k3, 8192, 2)
    print(json.dumps({"label": args.label, "package": os.path.dirname(build.SRC_DIR),
                      "card": smi.splitlines()[0], "ms": times}), flush=True)
    return 0


def stages(build, module, name, acc, bara, key, ctx, p, batches) -> None:
    """Clock cycles by stage of kernel ``name`` (K1 or K3, whose wrapper
    module's ``_launch`` is called), from its -DCRT_MMA_PROFILE build, at
    each of ``batches``."""
    out = build._target(name).with_name(build._target(name).name.replace(name, f"{name}-stages"))
    if not out.exists():    # named by the sources' hash, as the shipped libraries are
        cmd = build._command(name, out)
        subprocess.run(cmd[:1] + ["-DCRT_MMA_PROFILE"] + cmd[1:], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    fn_name, argtypes = build.SIGNATURES[name]
    getattr(lib, fn_name).argtypes = argtypes
    getattr(lib, fn_name).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    phase_clocks = getattr(lib, f"{name}_phase_clocks")
    phase_clocks.argtypes = [ctypes.c_void_p]
    load = build.load
    build.load = lambda _: lib
    tg = p.tgsw_params
    try:
        for B in batches:
            _, general, cluster = (module.launch_plan(B, tg.tlwe_params.k + 1, ctx, tg, acc.device)
                                   if name == "blind_rotate_ntt" else (0, True, 1))
            names = (["acc_wait", "digits", "fwd+key", "pw+send", "chat_wait", "inv", "update",
                      "push"] if cluster > 1 and not general
                     else ["digits0", "fwd0", "pw0", "inv0", "digits1", "fwd1", "pw1", "inv1"])
            clocks = (ctypes.c_ulonglong * 8)()
            phase_clocks(ctypes.addressof(clocks))
            before = list(clocks)
            module._launch(acc[:B].contiguous(), bara[:, :B].contiguous(), key, ctx, p)
            torch.cuda.synchronize()
            phase_clocks(ctypes.addressof(clocks))
            d = [x - y for x, y in zip(clocks, before)]
            print(f"{name} {p.n} steps B={B} stages: {sum(d) / p.n:.0f} clocks per step of "
                  "block 0; " + ", ".join(f"{k} {x / p.n:.0f} ({100 * x / sum(d):.1f}%)"
                                          for k, x in zip(names, d)), flush=True)
    finally:
        build.load = load


if __name__ == "__main__":
    sys.exit(main())
