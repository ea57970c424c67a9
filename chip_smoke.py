#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port end to end on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build of every CUDA kernel from ``eoc_tfhe_tpu_torch/csrc`` (nvcc, the
     seconds of each source), and the count of tensor-core MMA instructions
     in each library's SASS (``cuobjdump``: IMMA for ``mma.sync``, the GMMA
     family for ``wgmma``), which must be nonzero for all three;
  3. each kernel against its plain PyTorch version on the card, bit for bit,
     at ``test_params()`` (B=63), at the 128-bit (B=4) and 80-bit (B=4)
     shapes over all their steps, at the three shapes of ROADMAP C5
     (k=2 l=2 N=64, k=1 l=4 N=64, k=1 l=2 N=128) and at k=1 l=2 N=32 (B=7),
     at the five shapes of ROADMAP C7 (N=2048 k=1 l=3, N=1024 k=2 l=3,
     N=512 k=3 l=3, N=1024 k=1 l=5, N=1024 k=2 l=1 Bgbit=10; n=8), the
     shapes of ROADMAP C8 (N=1024 k=3 l=5, N=512 k=4 l=3, N=2048 k=3 l=3,
     N=512 k=3 l=8 Bgbit=4, N=1024 k=1 l=16 Bgbit=2; n=8; at N>=4096 K1's
     refusal by name, as in the reference), the rounded-key plans of
     ROADMAP C9 (rb > 0 where the plan rounds; n=8), the shapes of
     ROADMAP C10 (N=1024 k=3 l=9 Bgbit=3, K=288; N=256 k=5 l=3, U=6; N=16,
     F=4; n=8) and of ROADMAP C11 (N=1024 and 2048 k=4 l=32 Bgbit=1, K1's
     stream tier, each CLUSTER_REPEATS times more and then timed against
     its plain version and bound; n=8) at B=7 and B=C7_RAGGED;
  4. the main path: 128-bit keygen on the card, ``prepare_eval_key_ntt``,
     encryption of BATCH random bit pairs, one warm and ITERS timed
     batched NAND calls, decryption checked against ~(a & b);
  5. the kernel at the main path's inputs (B=BATCH) and at batch 1 (the
     API's): timed, held against its plain version, with its bound;
  6. the compact-key kernel against its plain version on the card, bit for
     bit, at ``test_params()`` (B=63) and at 128-bit B=4 over all 630 steps
     with the exact and the rounded (limbs=3) stored key, at the C5
     shapes (B=7), and at the C7, C8 and C10 shapes whose digits are int8
     (N=4096 k=1 l=3, N=8192 and 16384 k=1 l=3, N=8192 k=5 l=1 among them;
     B=7 and B=C7_RAGGED), at the C11 shapes (K2's limb sum bounded per
     pass and its staged tier), and at the ROADMAP C12 shapes (N=32768 k=1
     to 4 and N=65536 k=1 and 2 at l=3 Bgbit=8, and the rows form's exact
     key at N=32768 k=2 l=3 Bgbit=3: K2's staged tier at N=32768 k=1, its
     global tier at the others), each shape that runs in a cluster or the
     global tier CLUSTER_REPEATS times more with the same words;
  7. the circuit path: ``FrameworkConfig(eval_key_form="fused")`` over phase
     4's keyset, 8-bit ripple add and subtract (mode fast) over B=CIRCUIT_BATCH
     random byte pairs and the classic add over B=CLASSIC_BATCH, every output
     decrypted and checked; one profiled fast add splits its device time;
  8. NAND through the compact key at B=BATCH, decrypted and checked;
  9. the compact-key kernel at the circuit path's inputs (one MAJ call,
     B=CIRCUIT_BATCH) and at phase 8's (B=BATCH): timed, held against its
     plain version, with its bound;
 10. the "ntt_scan" form's kernel against its plain version on the card, bit
     for bit, at ``test_params()`` (B=63), at 128-bit B=4 over all 630 steps
     over either prime pair, at the 80-bit set (halfBg = 512) B=4 over all
     its steps, at the C5 shapes (B=7), at the C7, C8, C10 and C11 shapes
     (B=7 and B=C7_RAGGED; C11: the stream tier) over either prime pair
     (DEFAULT_PRIMES alone at
     N>=4096; each cluster shape CLUSTER_REPEATS times more with the same
     words) and at the C9 rounded plans over DEFAULT_PRIMES;
 11. NAND through the "ntt_scan" key (``prepare_eval_key_ntt(kernel=False)``)
     at B=BATCH on phase 4's keyset, decrypted and checked;
 12. the 8-bit fast add and subtract over the "ntt_scan" key on phase 7's
     ciphertexts, every output decrypted and checked;
 13. the "ntt_scan" kernel at phase 11's NAND inputs (B=BATCH) and at the
     first MAJ call of phase 12 (B=CIRCUIT_BATCH): timed, held against its
     plain version, with its bound;
 14. the ``Tfhe.*`` string API at 128-bit with the default config: keys,
     the reference's vectors, the JWT gate, and uint8 add, subtract,
     less-than, equals, select and multiply on seeded and full uploads, one
     value per call (batch 1), each decrypted and checked, with the host
     seconds of each call;
 15. the served path: ``FrameworkConfig().make_gate_server`` over phase 4's
     keyset and eval key; SERVED_REQUESTS single-ciphertext NAND requests
     (half seeded uploads, half full ones, host tensors as a client holds
     them) from CLIENTS threads, at the default pipeline chunk (128) and at
     ``pipeline_chunk=2048``; every result decrypted and held word for word
     against one direct ``gates.nand`` call on the same stacked inputs;
     flushes, requests/s, per-request p50/p99 latency (submit to the
     future's completion) and K1 launches; then UINT8_REQUESTS
     ``submit_uint8`` requests each of add, sub and mul, decrypted and
     checked, with their seconds;
 16. the process runtime: ``Process(process_id="smoke")`` on the card at the
     default params handles a message log (Info, GenerateSecretKey, and
     Eval chunks running the reference's Lua cases: integer and string round
     trips, 15 + 27, 50 - 8, and uint8 add and subtract through
     ``Tfhe.addUint8`` / ``subtractUint8``), every output checked, with the
     seconds of each message and the K1 launches; the log is then replayed
     on a fresh ``Process`` and every response must be byte-identical;
 17. the llama tier at llama2.c stories110M's published widths (all 12
     layers, random weights from seed 0 through ``init_params``): the
     weights saved as a Q8_0 v2 checkpoint, published with
     ``byte_tokenizer(32000)`` as a chunked chain, and served by
     ``Process(process_id="smoke-llama")`` on the card through
     ``Llama.load``, ``setPrompt`` (128 tokens), ``run(64)``, ``add`` and
     ``next``; every logit the backend served (prefill, then decode through
     the cache), and the bf16 ``forward`` at every prompt position, held
     against the float64 oracle ``tests/llama_oracle.py`` over the same
     dequantized weights, at a tolerance that the same forward with bf16
     weights must fail; the float32 ``forward`` held at a tolerance that
     TF32 products fail (an emulated TF32 run must fail it); every distinct
     product of the bf16 path at its own inputs against float64, with the
     caller's TF32 and reduced-precision bf16 flags on, at a bound that bf16
     weights and TF32 fail; the emitted ids equal to the argmax of the
     served logits; load s, prefill ms, decode ms a token, tokens/s, peak
     device memory, and ``generate`` at batch 8;
 18. the native codec: built on the machine (``native.available()``), the
     ``tests/data/golden_*.bin`` fixtures round-tripped byte for byte through
     the native path and through the numpy path, and base64 decoding of
     phase 14's key blob and the record functions at the 128-bit keys'
     sizes timed on both paths;
 19. the parallel tier (``parallel/``, ``io/native_keys``, the llama's tp
     plan) at 128-bit on phase 4's keyset.  (a) A one-rank NCCL group on the
     card, ``FrameworkConfig(mesh_dp=1, mesh_tp=1).make_mesh()``: the dp NAND
     (``make_sharded_nand``, K2 on the compact key) at B=BATCH, words and
     variance equal to the direct ``gates.nand`` over the same key, every
     output decrypted, timed, K2's launches counted, an NCCL all-reduce, and
     ``scaling_report``'s point (one rank: the sharded path's overhead, not
     scaling).  (b) PAR_RANKS ranks spawned on the one card under gloo (NCCL
     refuses two ranks on one GPU; gloo moves the ranks' CUDA tensors through
     the host): the dp NAND at (dp, tp) = (2, 1) and (1, 2), B=BATCH, the
     TGSW-row ``blind_rotate_ntt_tp`` and the frequency-split
     ``make_sharded_nand_freq`` at tp=2 and B=PAR_TP_BATCH over the
     "ntt_scan" key, a ``native_keys`` round trip of the row-sharded key
     (each rank writes its shard), and the stories110M-width llama forward
     at tp=2 (random weights as in phase 17, float32 compute) within the
     reference's 1e-4 of the one-rank forward; every result word-identical
     to the one-rank result the parent computed first;
 20. one NAND at full depth (n=630, B=C7_BATCH, keys made on the card) at
     two ROADMAP C7 shapes: N=2048 k=1 l=3 Bgbit=7 over the "ntt_kernel"
     (K1) and "ntt_scan" (K3) keys, N=512 k=3 l=3 over the compact key (K2)
     at Bgbit=7 (at Bgbit=6 and n=630 both packages' noise-budget rail,
     ``gates.check_noise_budget``, refuses the gate: its 18 gadget bits
     leave a worst-case rounding variance of 6.8e-4, over the set's
     1.6e-4); and at two ROADMAP C8 shapes: N=4096 k=1 l=3 Bgbit=7 (F=512)
     over the "ntt_scan" (K3) and compact (K2) keys, N=1024 k=3 l=5 Bgbit=5
     (K=160) over the "ntt_kernel" key (K1), both taken by the rail; and at
     three ROADMAP C10 shapes: N=8192 k=1 l=3 (F=1024; B=256) and N=16384
     k=1 l=3 (F=2048; B=64) over the "ntt_scan" (K3, in a cluster) and
     compact (K2) keys, at Bgbit=8 (the rail refuses Bgbit=7 there at
     n=630: ``noise_budget_bgbit`` takes the nearest Bgbit it accepts), and
     N=4096 k=2 l=6 Bgbit=4 (Kp=144 at F=512; B=256) over the
     "ntt_scan" key (K3, in a cluster); each decrypted and checked, its
     kernel's launches counted, timed, and the kernel at its inputs timed,
     held against its plain version and printed with its plan and bound;
     and at two ROADMAP C11 shapes: N=16384 k=2 l=3 Bgbit=8 (B=16) over the
     compact key (K2, one digit row a pass: the whole ring's limb sum
     reaches 2^31) and N=8192 k=2 l=8 Bgbit=4 (B=64) over the "ntt_scan"
     (K3's stream tier) and compact (K2's staged tier) keys; and at two
     ROADMAP C12 shapes over the compact key (B=C12_BATCH): N=32768 k=1 l=3
     Bgbit=8 (K2's staged tier in a cluster of 8) and N=32768 k=2 l=4
     Bgbit=8 (K2's global tier; at k=2 l=3 the rail refuses every Bgbit <= 8
     at n=630), the bound from the plain version's three-prime plan; and a
     NAND at N=65536 k=1 l=4 Bgbit=8 over K2's global tier at n=C7_STEPS,
     keys made on the card, decrypted and checked.
The three kernels are printed as one ``{"kernels": [...]}`` line.  The last
line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

#: Published H100 SXM peaks (NVIDIA data sheet), for the bounds.
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12

#: Timed calls of the main path's batch (``FrameworkConfig().batch_size``).
ITERS = 2
#: The circuit path's batch ("batches of 1k ciphertexts") and the classic adder's.
CIRCUIT_BATCH = 1024
CLASSIC_BATCH = 32
#: Batch of the ROADMAP C5 shape cases (not a multiple of a block's 8 samples).
C5_BATCH = 7
#: ROADMAP C7: a second batch of its shape cases (a ragged last block at 8
#: and at 4 samples a block), its steps, and the full-depth NANDs' batch.
C7_RAGGED, C7_STEPS, C7_BATCH = 13, 8, 1024
#: Repeats of each ROADMAP C10 cluster shape in phases 6 and 10.
CLUSTER_REPEATS = 20
#: Phase 20's batch at the ROADMAP C10 shapes (N, k): N = 8192, 16384 and
#: k = 2 at N = 4096 (cut from C7_BATCH for the run's time); and at the C11
#: shapes: one wave of the card's SMs (16 clusters of 8 blocks at N = 16384,
#: 64 of 2 at N = 8192), since a NAND there takes the time of a wave.
C10_BATCH = {(8192, 1): 256, (16384, 1): 64, (4096, 2): 256}
C11_BATCH = {(16384, 2): 16, (8192, 2): 64}
#: Phase 20's batch at the ROADMAP C12 shapes, each one wave and cut for the
#: run's time: 12 clusters of 8 blocks in K2's staged tier at k = 1 (16 of
#: them took two waves: the card holds fewer clusters of 8 at once), and 2
#: groups of 8 samples in its global tier at k = 2 (48 blocks of 4096
#: outputs of one polynomial; a wave's time whatever the groups, while the
#: plain version's grows with B).
C12_BATCH = {(32768, 1): 12, (32768, 2): 16}
#: The served path: client threads, and the chunk timed beside the default.
CLIENTS = 8
WIDE_CHUNK = 2048
#: ``submit_uint8`` requests of each op.
UINT8_REQUESTS = 64
#: llama2.c stories110M (karpathy/llama2.c README, table of models), all
#: published widths and all 12 layers.
STORIES110M = dict(dim=768, hidden_dim=2048, n_layers=12, n_heads=12, n_kv_heads=12,
                   vocab_size=32000, max_seq_len=1024)
#: Phase 17: prompt tokens, tokens of ``Llama.run``, the chain's chunk bytes,
#: and ``generate``'s batch, prompt and new tokens.
LLAMA_PROMPT, LLAMA_RUN, LLAMA_CHUNK = 128, 64, 16 << 20
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 16, 128
#: Phase 18: timed repeats of each codec function on each path.
CODEC_REPEATS = 5
#: Phase 19: ranks spawned on the one card, the tp rotations' batch, and the
#: llama forward's (batch, tokens) and tolerance (``tests/test_llama.py``'s
#: tp forward against the unsharded one).
PAR_RANKS, PAR_TP_BATCH = 2, 8
PAR_LLAMA_TOKENS, PAR_LLAMA_ATOL = (2, 16), 1e-4
#: Phase 19 (b)'s layouts: PAR_RANKS ranks share cuda:0 under gloo (NCCL
#: refuses two ranks on one GPU).  ``parallel_times.py`` runs the same rank
#: body with one NCCL rank a card and its own plan.
ONE_CARD_PLAN = {"backend": "gloo", "rank_card": False, "nand": ((2, 1), (1, 2)),
                 "rows": (1, 2), "freq": (1, 2), "llama": (1, 2), "scaling": None}


def c5_params(params):
    """The shapes of ROADMAP C5 (M = 72 with U*R = 24, K = 64, and N = 128)
    and N = 32 (U*R = 8)."""
    return (("C5 k=2 l=2 N=64", params.test_params(k=2, l=2, N=64, n=4)),
            ("C5 k=1 l=4 N=64", params.test_params(k=1, l=4, N=64)),
            ("C5 k=1 l=2 N=128", params.test_params(k=1, l=2, N=128)),
            ("k=1 l=2 N=32", params.test_params(k=1, l=2, N=32)))


def c8_params(params):
    """The shapes of ROADMAP C8 (n = C7_STEPS): N = 4096 (F = 512; no K1
    context), k = 3 l = 5 (K = 160), k = 4 (U = 5), k = 3 at N = 2048 (K2's
    row-share plan), K = 256 (k = 3 l = 8, k = 1 l = 16) and halfBg = 512 at
    F = 512 (K3 only: C1)."""
    return tuple((f"C8 N={N} k={k} l={l} Bgbit={bg}",
                  params.test_params(N=N, k=k, l=l, Bgbit=bg, n=C7_STEPS))
                 for N, k, l, bg in ((4096, 1, 3, 7), (1024, 3, 5, 5), (512, 4, 3, 7),
                                     (2048, 3, 3, 7), (512, 3, 8, 4), (1024, 1, 16, 2),
                                     (4096, 1, 1, 10)))


def c10_params(params):
    """The shapes of ROADMAP C10 (n = C7_STEPS): N = 8192 and 16384 (F = 1024
    and 2048: K3 in a cluster, K2 at one sample a block or in a cluster; no
    K1 context), N = 4096 k = 2 l = 6 (Kp = 144 at F = 512: K3 in a cluster),
    K = 288, k = 5 (U = 6; and at N = 8192, K2 and K3 in a cluster), N = 16
    and 8 (F = 4), and the shapes refused before C10 (K2 at N = 4096, k = 3 l = 3
    and k = 4 l = 1; K3 at N = 4096 k = 1 l = 9; K1 and K3 at K = 288, F = 64)."""
    return tuple((f"C10 N={N} k={k} l={l} Bgbit={bg}",
                  params.test_params(N=N, k=k, l=l, Bgbit=bg, n=C7_STEPS))
                 for N, k, l, bg in ((8192, 1, 3, 7), (16384, 1, 3, 7), (4096, 2, 6, 4),
                                     (1024, 3, 9, 3), (256, 5, 3, 7), (16, 1, 3, 7),
                                     (8, 1, 2, 8), (8192, 5, 1, 7), (4096, 3, 3, 7), (4096, 4, 1, 7),
                                     (4096, 1, 9, 3), (512, 3, 9, 3)))


def c11_params(params):
    """The shapes of ROADMAP C11 (n = C7_STEPS): K2's limb sum bounded per
    pass (N = 16384 k = 2 l = 3 Bgbit = 8 and k = 1 l = 4 Bgbit = 8), K2's
    staged tier and K3's stream tier (N = 8192 k = 2 l = 8 Bgbit = 4, N =
    16384 k = 3 l = 2, k = 2 l = 4 Bgbit = 4 and k = 4 l = 4 Bgbit = 8),
    K3's stream tier at N = 4096 (k = 2 l = 15 Bgbit = 2) and K1's and K3's
    at K = 1280 (N = 1024 and 2048 k = 4 l = 32 Bgbit = 1; K2's staged tier
    at N = 2048)."""
    return tuple((f"C11 N={N} k={k} l={l} Bgbit={bg}",
                  params.test_params(N=N, k=k, l=l, Bgbit=bg, n=C7_STEPS))
                 for N, k, l, bg in ((16384, 2, 3, 8), (16384, 1, 4, 8), (8192, 2, 8, 4),
                                     (16384, 3, 2, 7), (16384, 2, 4, 4), (16384, 4, 4, 8),
                                     (4096, 2, 15, 2), (1024, 4, 32, 1), (2048, 4, 32, 1)))


def c12_params(params):
    """The shapes of ROADMAP C12 (n = C7_STEPS) for K2: N = 32768 at k = 1
    (its staged tier in a cluster of 8) and k = 2, 3, 4, and N = 65536 at k
    = 1 and 2 (its global tier), l = 3 Bgbit = 8; and the rows form's exact
    key at N = 32768 k = 2 l = 3 Bgbit = 3, where the reference's rows scan
    takes the shape (J N halfBg 128 < 2^31)."""
    return (*((f"C12 N={N} k={k} l=3 Bgbit=8", params.test_params(N=N, k=k, l=3, Bgbit=8,
                                                                   n=C7_STEPS))
              for N, k in ((32768, 1), (32768, 2), (32768, 3), (32768, 4), (65536, 1),
                           (65536, 2))),
            ("C12 rows form N=32768 k=2 l=3 Bgbit=3",
             params.test_params(N=32768, k=2, l=3, Bgbit=3, n=C7_STEPS)))


def repeat_equal(run, out, label: str) -> None:
    """Runs a cluster shape CLUSTER_REPEATS times more; every run must give
    ``out``'s words (an ordering fault across a cluster's blocks shows only
    some of the time)."""
    for r in range(CLUSTER_REPEATS):
        got = run()
        torch.cuda.synchronize()
        check(torch.equal(got, out), f"{label}: repeat {r + 1} differs from the first run")


def c9_params(params):
    """ROADMAP C9: sets whose rounded-key plan rounds (rb = 2) on K1's and
    K3's register path (k = 1), scatter path (k = 2 l = 2) and general
    instantiation (k = 2 l = 3, and N = 4096 over DEFAULT_PRIMES); n =
    C7_STEPS."""
    return tuple((f"C9 rounded N={N} k={k} l={l} Bgbit={bg}",
                  params.test_params(N=N, k=k, l=l, Bgbit=bg, n=C7_STEPS))
                 for N, k, l, bg in ((64, 1, 3, 7), (128, 1, 3, 7), (64, 2, 2, 7), (64, 2, 3, 7),
                                     (4096, 1, 3, 7)))


def c7_params(params):
    """The shapes of ROADMAP C7 (n = C7_STEPS): N = 2048 (F = 256), k = 2 at
    N = 1024 (K = 72), k = 3 (K = 96), l = 5 (K = 80) and halfBg = 512 at
    k = 2 (the compact form refuses it: C1)."""
    return tuple((f"C7 N={N} k={k} l={l} Bgbit={bg}",
                  params.test_params(N=N, k=k, l=l, Bgbit=bg, n=C7_STEPS))
                 for N, k, l, bg in ((2048, 1, 3, 7), (1024, 2, 3, 7), (512, 3, 3, 6),
                                     (1024, 1, 5, 5), (1024, 2, 1, 10)))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int) -> tuple[float, object]:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls (CUDA events)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = None
    start.record()
    for _ in range(iters):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, out


def random_rotation_inputs(gen, p, n_steps, B, dev):
    tg = p.tgsw_params
    N, U = tg.tlwe_params.N, tg.tlwe_params.k + 1

    def i32(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                             device=dev).to(torch.int32)
    bara = torch.randint(0, 2 * N, (n_steps, B), generator=gen, dtype=torch.int32, device=dev)
    return i32((n_steps, tg.kpl, U, N)), i32((B, U, N)), bara


def ntt_macs(P: int, F: int, K: int, M: int, dl: int) -> int:
    """int8 limb MACs per sample and step of the CRT-NTT blind rotation (2
    primes; forward NTT K*F*F with 2 matrix limbs and dl digit limbs,
    pointwise F*K*M and inverse M*F*F with 2x2 limbs): the fewest-operation
    exact dataflow for a blind rotation that the repo has."""
    return P * (K * F * F * 2 * dl + F * K * M * 4 + M * F * F * 4)


def bound_ms(macs: int, nbytes: int) -> tuple[float, str]:
    """The larger of the operation time (2 ops per MAC at the int8 peak) and
    the byte time (at the HBM rate), and which one it is."""
    t_ops = 2 * macs / INT8_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rotation_bound(B: int, n: int, key: torch.Tensor, params) -> tuple[float, str]:
    """Least time (ms) for a blind rotation over the NTT-domain key on an H100
    and what bounds it.  Operations: :func:`ntt_macs` per sample and step,
    with K and M read from the key: the "ntt_kernel" byte planes (n, P, F,
    M/16, K/16, 32, 16) or the "ntt_scan" byte pairs (n, P, F, K, 2M).
    Bytes: the key, acc0, bara and the output, each moved once.
    """
    if key.dim() == 7:
        _, P, F, MT, KT = key.shape[:5]
        K, M = 16 * KT, 16 * MT
    else:
        _, P, F, K, M2 = key.shape
        M = M2 // 2
    dl = 1 if params.tgsw_params.halfBg <= 128 else 2
    acc_bytes = B * (params.k + 1) * params.N * 4
    nbytes = key.numel() * key.element_size() + 2 * acc_bytes + n * B * 4
    return bound_ms(ntt_macs(P, F, K, M, dl) * B * n, nbytes)


def compact_bound(B: int, n: int, key: torch.Tensor, ctx, params) -> tuple[float, str]:
    """Least time (ms) for a blind rotation over the stored compact key on an
    H100: the same function, exact mod 2^32, computed by the cheapest exact
    dataflow the repo has.  Operations: :func:`ntt_macs` per sample and step,
    plus the stored key's forward transform into the NTT domain once per step,
    shared by the batch (P*L*kpl*U*R*F*F MACs with 2x2 limbs; ``ctx`` gives
    the plan: K1's, or from N = 4096 the plain version's, whose three-prime
    ``ntt.wide_context`` from N = 32768 on is the repo's only exact plan
    there).  Bytes: the stored key, acc0, bara and the output, each moved
    once.
    """
    U, J = params.k + 1, params.tgsw_params.kpl
    P, F, R, L = len(ctx.primes), ctx.F, ctx.R, ctx.key_limbs
    dl = 1 if params.tgsw_params.halfBg <= 128 else 2
    key_macs = P * L * J * U * R * F * F * 4
    macs = (ntt_macs(P, F, J * R, L * U * R, dl) * B + key_macs) * n
    nbytes = key.numel() * key.element_size() + 2 * B * U * params.N * 4 + n * B * 4
    return bound_ms(macs, nbytes)


def mma_instructions(lib_path, nvcc: str) -> dict[str, int]:
    """Tensor-core MMA instructions in a library's SASS (cuobjdump beside
    nvcc): IMMA (integer mma.sync) and the GMMA family (wgmma)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    lines = sass.splitlines()
    return {"IMMA": sum(bool(re.search(r"\bIMMA\.", line)) for line in lines),
            "GMMA": sum(bool(re.search(r"\b[A-Z]*GMMA\.", line)) for line in lines)}


def timed(fn) -> tuple[float, object]:
    """Host seconds of one call of ``fn`` that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def device_breakdown(fn) -> str:
    """Device time by kernel over one call of ``fn`` (torch.profiler).  Only
    the kernels' own rows count: a CPU op's row repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s, _ = timed(fn)
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    total = sum(t for t, _ in rows)
    if not total:
        return f"profiled wall {wall_s:.3f} s; the profiler saw no device time (not measured)"
    rows.sort(reverse=True)
    top = "; ".join(f"{k[:60]} {t / 1e3:.1f} ms ({100 * t / total:.1f}%)" for t, k in rows[:6])
    return (f"profiled wall {wall_s:.3f} s, device busy {total / 1e6:.3f} s "
            f"(idle share {max(0.0, 1 - total / 1e6 / wall_s):.3f}); by kernel: {top}")


def api_smoke(seed: int, gen: torch.Generator) -> str:
    """Phase 14: ``Tfhe(seed=seed)`` at 128-bit with the default config on
    the card; every result decrypted and checked; host seconds per call.
    Returns the secret key blob (base64) that ``generateSecretKey`` gave."""
    from eoc_tfhe_tpu_torch.api.tfhe import Tfhe
    from eoc_tfhe_tpu_torch.ops import blind_rotate

    t = Tfhe(seed=seed)
    keygen_s, sk = timed(lambda: t.generateSecretKey("header.payload", ""))
    pk_s, pk = timed(t.generatePublicKey)
    print(f"api: generateSecretKey {keygen_s:.3f} s ({len(sk)} base64 chars); "
          f"generatePublicKey {pk_s:.3f} s ({len(pk)} base64 chars)", flush=True)
    tok = "e30.e30"
    check(t.decryptInteger(t.encryptInteger(42), "", tok) == 42, "api: 42 round trip")
    msg = "Hello TFHE!"
    check(t.decryptASCIIString(t.encryptASCIIString(msg, len(msg)), len(msg), "", tok) == msg,
          "api: string round trip")
    c15, c27 = t.encryptInteger(15), t.encryptInteger(27)
    check(t.decryptInteger(t.addCiphertexts(c15, c27), "", tok) == 42, "api: 15 + 27")
    c50, c8 = t.encryptInteger(50), t.encryptInteger(8)
    check(t.decryptInteger(t.subtractCiphertexts(c50, c8), "", tok) == 42, "api: 50 - 8")
    check(t.decryptInteger(t.addCiphertexts(c50, c8), "", tok) == 58, "api: 50 + 8")
    check(t.generateSecretKey("", "") is None and t.decryptInteger(c50, "", "", "") == -1,
          "api: the JWT gate let an empty token through")
    print("api: reference vectors 42, 'Hello TFHE!', 15+27, 50-8 (and 58) correct; "
          "empty token refused", flush=True)

    setup_s, api = timed(t._s.gate_api)
    print(f"api: gate API set-up ({api.eval_key.form} key) {setup_s:.3f} s", flush=True)
    blind_rotate.launches = 0
    pairs = torch.randint(0, 256, (2, 2), generator=gen, device=gen.device).tolist()
    secs: dict[str, list[float]] = {}

    def call(name, fn, *args):
        s, out = timed(lambda: fn(*args))
        secs.setdefault(name, []).append(s)
        return t.decryptUint8(out, "", tok)

    for x, y in pairs:
        cx, cy = t.encryptUint8Seeded(x), t.encryptUint8(y)
        got = {"addUint8": call("addUint8", t.addUint8, cx, cy),
               "subtractUint8": call("subtractUint8", t.subtractUint8, cx, cy),
               "lessThanUint8": call("lessThanUint8", t.lessThanUint8, cx, cy),
               "equalsUint8": call("equalsUint8", t.equalsUint8, cx, cy)}
        lt = t.lessThanUint8(cx, cy)
        got["selectUint8"] = call("selectUint8", t.selectUint8, lt, cx, cy)
        want = {"addUint8": (x + y) % 256, "subtractUint8": (x - y) % 256,
                "lessThanUint8": int(x < y), "equalsUint8": int(x == y),
                "selectUint8": min(x, y)}
        check(got == want, f"api: uint8 ops on ({x}, {y}) gave {got}, want {want}")
    x, y = pairs[0]
    prod = call("multiplyUint8", t.multiplyUint8, t.encryptUint8Seeded(x), t.encryptUint8(y))
    check(prod == x * y % 256, f"api: {x} * {y} gave {prod}")
    check(blind_rotate.launches > 0, "api: the uint8 ops never launched the NTT kernel")
    print(f"api: uint8 ops on {pairs} (seeded and full uploads) decrypt correctly; "
          f"{blind_rotate.launches} blind_rotate_ntt launches; host s per call (batch 1): " +
          ", ".join(f"{k} {sum(v) / len(v):.3f}" for k, v in secs.items()), flush=True)
    return sk


def _host(ct):
    """A ciphertext's tensors on the host, as a client holds them."""
    return type(ct)(*(x.cpu() for x in vars(ct).values()))


def served_smoke(ks, ek, p, gen) -> None:
    """Phase 15: the served path over phase 4's keyset and eval key."""
    from eoc_tfhe_tpu_torch.config import FrameworkConfig
    from eoc_tfhe_tpu_torch.core import gates, lwe
    from eoc_tfhe_tpu_torch.ops import blind_rotate

    cfg = FrameworkConfig()
    R, half = cfg.serving_max_batch, cfg.serving_max_batch // 2
    dev = gen.device
    a = torch.randint(0, 2, (R,), generator=gen, device=dev).bool()
    b = torch.randint(0, 2, (R,), generator=gen, device=dev).bool()
    full = [_host(gates.encrypt_bit(gen, x[:half], ks.lwe_key, p)) for x in (a, b)]
    seeded = [_host(gates.encrypt_bit_seeded(gen, x[half:], ks.lwe_key, p)) for x in (a, b)]
    reqs = [tuple(lwe.lwe_index(c, i) for c in full) for i in range(half)]
    reqs += [tuple(type(c)(*(x[i] for x in vars(c).values())) for c in seeded)
             for i in range(R - half)]
    stacked = [lwe.LweCiphertext(
        a=torch.cat([f.a.to(dev), lwe.lwe_seeded_expand(
            lwe.SeededLweCiphertext(*(x.to(dev) for x in vars(s).values())), p.n).a]),
        b=torch.cat([f.b, s.b]).to(dev),
        current_variance=torch.cat([f.current_variance, s.current_variance]).to(dev))
        for f, s in zip(full, seeded)]
    direct = _host(gates.nand(*stacked, ek, p))
    want = ~(a & b).cpu()

    for chunk in (cfg.serving_pipeline_chunk, WIDE_CHUNK):
        overrides = {} if chunk == cfg.serving_pipeline_chunk else {"pipeline_chunk": chunk}
        srv = cfg.make_gate_server(ek, p, **overrides)
        futs, lat, flush_log = [None] * R, [0.0] * R, []
        run_batch = srv._run_batch

        def logged_batch(qkey, batch, run_batch=run_batch, flush_log=flush_log):
            t = time.perf_counter()
            n = run_batch(qkey, batch)
            flush_log.append(f"{len(batch)} in {time.perf_counter() - t:.3f} s")
            return n
        srv._run_batch = logged_batch

        def client(t):
            for i in range(t, R, CLIENTS):
                t0 = time.perf_counter()
                futs[i] = srv.submit("nand", *reqs[i])
                futs[i].add_done_callback(
                    lambda f, i=i, t0=t0: lat.__setitem__(i, time.perf_counter() - t0))

        blind_rotate.launches = 0
        with srv:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(t,)) for t in range(CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            check(not any(th.is_alive() for th in threads), "served: a client thread hung")
            submit_s = time.perf_counter() - t0
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
        launches = blind_rotate.launches
        got = lwe.lwe_stack(outs)
        check(all(torch.equal(getattr(got, f), getattr(direct, f))
                  for f in ("a", "b", "current_variance")),
              f"served NAND (chunk {chunk}) differs from the direct call")
        n_wrong = int((gates.decrypt_bit(got, _host(ks.lwe_key)) != want).sum())
        check(n_wrong == 0, f"{n_wrong} of {R} served NAND outputs decrypt wrong")
        check(launches > 0, "served: the NAND never launched K1")
        q = torch.tensor(lat).quantile(torch.tensor([0.5, 0.99], dtype=torch.float64)
                                       .to(torch.float32)).tolist()
        print(f"served nand, chunk {chunk}: {R} requests ({half} seeded) from {CLIENTS} "
              f"clients in {wall:.3f} s, {R / wall:.1f} requests/s; latency p50 "
              f"{q[0] * 1e3:.2f} ms, p99 {q[1] * 1e3:.2f} ms; all submitted after "
              f"{submit_s:.3f} s; flushes {srv.stats['flushes']} ({', '.join(flush_log)}), "
              f"padded slots {srv.stats['padded_slots']}; K1 launches {launches}; "
              f"word-identical to the direct call, {R} of {R} decrypt correctly", flush=True)

    vals = torch.randint(0, 256, (2, UINT8_REQUESTS), generator=gen, device=dev).tolist()

    def enc8(v, seeded_upload):
        bits = torch.tensor([(v >> i) & 1 for i in range(8)], dtype=torch.bool, device=dev)
        fn = gates.encrypt_bit_seeded if seeded_upload else gates.encrypt_bit
        return _host(fn(gen, bits, ks.lwe_key, p))

    key = _host(ks.lwe_key)
    with cfg.make_gate_server(ek, p) as srv:
        for op, fn, seeded_upload in (("add", lambda x, y: x + y, False),
                                      ("sub", lambda x, y: x - y, True),
                                      ("mul", lambda x, y: x * y, False)):
            ins = [(enc8(x, seeded_upload), enc8(y, seeded_upload)) for x, y in zip(*vals)]
            blind_rotate.launches = 0
            t0 = time.perf_counter()
            outs = [f.result(timeout=600) for f in [srv.submit_uint8(op, *c) for c in ins]]
            secs = time.perf_counter() - t0
            launches = blind_rotate.launches
            got = [int(sum(int(bit) << i for i, bit in enumerate(gates.decrypt_bit(o, key))))
                   for o in outs]
            want8 = [fn(x, y) % 256 for x, y in zip(*vals)]
            check(got == want8, f"served uint8 {op}: {got} != {want8}")
            print(f"served uint8 {op}: {UINT8_REQUESTS} requests "
                  f"({'seeded' if seeded_upload else 'full'} uploads) in {secs:.3f} s; "
                  f"K1 launches {launches}; all decrypt correctly", flush=True)


#: Phase 16's Eval chunks (the reference's Lua integration cases and the
#: bootstrapped uint8 add and subtract), each with a test of its output.
PROCESS_CHUNKS = (
    ("""local tfhe = require(".tfhe")
        local info = tfhe.info()
        tfhe.testJWT();
        print(info)
        return "OK" """, lambda out: out.startswith("TFHE Library") and out.endswith("\nOK")),
    ("""local tfhe = require(".tfhe")
        tfhe.generateSecretKey("h.p", "")
        local original = 42
        local encrypted = tfhe.encryptInteger(original, '')
        local decrypted = tfhe.decryptInteger(encrypted, '', "h.p", "")
        return tostring(decrypted)""", lambda out: out == "42"),
    ("""local tfhe = require(".tfhe")
        local text = "Hello TFHE!"
        local encrypted = tfhe.encryptASCIIString(text, #text, '')
        local decrypted = tfhe.decryptASCIIString(encrypted, #text, '', "h.p", "")
        return decrypted""", lambda out: out == "Hello TFHE!"),
    ("""local tfhe = require(".tfhe")
        local enc_a = tfhe.encryptInteger(15, '')
        local enc_b = tfhe.encryptInteger(27, '')
        local enc_sum = tfhe.addCiphertexts(enc_a, enc_b, '')
        return tostring(tfhe.decryptInteger(enc_sum, '', "h.p", ""))""", lambda out: out == "42"),
    ("""local tfhe = require(".tfhe")
        local enc_a = tfhe.encryptInteger(50, '')
        local enc_b = tfhe.encryptInteger(8, '')
        local enc_diff = tfhe.subtractCiphertexts(enc_a, enc_b, '')
        return tostring(tfhe.decryptInteger(enc_diff, '', "h.p", ""))""", lambda out: out == "42"),
    ("""local a = Tfhe.encryptUint8Seeded(50, '')
        local b = Tfhe.encryptUint8(8, '')
        local d = Tfhe.subtractUint8(a, b, '')
        local s = Tfhe.addUint8(a, b, '')
        return 'diff=' .. Tfhe.decryptUint8(d, '', 'h.p', '')
            .. ' sum=' .. Tfhe.decryptUint8(s, '', 'h.p', '')""",
     lambda out: out == "diff=42 sum=58"),
)


def process_smoke(device=None) -> None:
    """Phase 16: ``Process`` at the default params on the card."""
    from eoc_tfhe_tpu_torch.ops import blind_rotate
    from eoc_tfhe_tpu_torch.process import Process

    env = json.dumps({"Process": {"Id": "smoke", "Owner": "OWNER", "Module": "M1"}})

    def message(action, data="", **tags):
        return json.dumps({"Target": "smoke", "From": "OWNER", "Block-Height": "1000",
                           "Tags": [{"name": "Action", "value": action}] +
                                   [{"name": k, "value": v} for k, v in tags.items()],
                           "Data": data})

    log = [(message("Info"), lambda out: out.startswith("TFHE Library")),
           (message("GenerateSecretKey", Token="h.p"), lambda out: len(out) > 100)]
    log += [(message("Eval", chunk), ok) for chunk, ok in PROCESS_CHUNKS]
    proc = Process(process_id="smoke", device=device)
    blind_rotate.launches = 0
    replies, secs = [], []
    for msg, ok in log:
        s, reply = timed(lambda: proc.handle(msg, env))
        replies.append(reply)
        secs.append(s)
        r = json.loads(reply)
        check(r["Error"] is None, f"process: {r['Error']}")
        out = r["Output"]["data"]["output"]
        check(ok(out), f"process: wrong output {out[:200]!r} for {msg[:300]!r}")
    launches = blind_rotate.launches
    check(launches == 18, f"process: {launches} K1 launches, want 18 (add 9, sub 9)")
    print(f"process: {len(log)} messages answered correctly; K1 launches {launches}; "
          f"seconds per message: " + ", ".join(f"{x:.3f}" for x in secs), flush=True)
    fresh = Process(process_id="smoke", device=device)
    replay_s, again = timed(lambda: [fresh.handle(m, e) for m, e in proc.log])
    check(again == replies, "process: a replayed response differs from the first run's")
    print(f"process: the log replayed on a fresh Process in {replay_s:.3f} s gave "
          f"{len(again)} byte-identical responses", flush=True)


def _oracle():
    """The independent float64 numpy decoder of the test suite."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import llama_oracle
    return llama_oracle


def _words(gen: torch.Generator, n_chars: int) -> str:
    """Seeded lowercase words and spaces, exactly ``n_chars`` long."""
    words = ("once", "upon", "a", "time", "there", "was", "little", "girl", "who",
             "liked", "to", "play", "in", "the", "park", "with", "her", "dog")
    out = ""
    while len(out) < n_chars:
        out += words[int(torch.randint(0, len(words), (1,), generator=gen))] + " "
    return out[:n_chars - 1] + "x"


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, as a TF32 tensor-core
    product rounds its inputs."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rel_err(a: torch.Tensor, b: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """|got - a @ b| / (|a| @ |b|) elementwise, in float64 over a's and b's
    values: the product's error in units of its terms' magnitudes."""
    a, b = a.double(), b.double()
    return (got.double() - a @ b).abs() / (a.abs() @ b.abs()).clamp_min(1e-300)


def _bf16_weights(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fault the llama's ``matmul`` guards against: both sides in bf16
    (torch's way to a bf16 x float32 product), in the dtype ``matmul``
    returns."""
    from eoc_tfhe_tpu_torch.device import exact_matmuls
    with exact_matmuls():
        out = torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16))
    return out.to(torch.promote_types(a.dtype, b.dtype))


def llama_products(p_dev: dict, ids: torch.Tensor, cfg, cache: torch.Tensor,
                   pos: int) -> None:
    """Every distinct product of the bf16 path at its own inputs (the 128
    prompt positions' ``forward`` and one ``decode_step``), run by
    ``llama.matmul`` on the card with the caller's TF32 and reduced-precision
    bf16 flags left on, against float64, in units of sum |a||w| of each
    output.

    bf16 activation x float32 weight: a float32 product of the bf16 values.
    The K additions' roundings (2^-24 each) have random signs and grow as
    sqrt(K) (Higham and Mary's probabilistic bound), so the bound is
    sqrt(K) 2^-24.  Two controls must exceed it: the weight cast to bf16 (the
    fault of bf16 weights, 2^-8 a term) and, wherever cuBLAS then takes
    another kernel, TF32 left on (2^-11 a term).  bf16 x bf16 (the
    classifier): the float32 sum rounded to bf16, so within 2^-8 |a @ b| plus
    twice the worst-case float32 bound (K+1) 2^-24; cuBLAS's reduced-precision
    bf16 reduction turned on is its control, reported."""
    from unittest import mock

    from eoc_tfhe_tpu_torch.device import exact_matmuls
    from eoc_tfhe_tpu_torch.models import llama

    seen = {}
    real = llama.matmul

    def recording(a, b):
        key = (tuple(a.shape[-2:]), tuple(b.shape), a.dtype, b.dtype)
        if key not in seen:
            seen[key] = (a.reshape(-1, a.shape[-1]).clone(), b.clone())
        return real(a, b)

    with mock.patch.object(llama, "matmul", recording):
        llama.forward(p_dev, ids, cfg)
        llama.decode_step(p_dev, cache.clone(), pos, ids[:, -1], cfg)
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    rows = []
    try:
        for (_, _, _, bdt), (a, b) in sorted(seen.items(), key=lambda kv: str(kv[0])):
            (M, K), N = a.shape, b.shape[1]
            flags.allow_tf32 = flags.allow_bf16_reduced_precision_reduction = True
            got = llama.matmul(a, b)
            if bdt == torch.float32:
                bound = math.sqrt(K) * 2.0 ** -24
                sound = float(_rel_err(a, b, got).max())
                tf32_out = torch.matmul(a.float(), b)          # TF32 on, no scope
                bf16w = float(_rel_err(a, b, _bf16_weights(a, b)).max())
                tf32 = (float(_rel_err(a, b, tf32_out).max())
                        if not torch.equal(tf32_out, got) else None)
                check(sound <= bound < bf16w and (tf32 is None or tf32 > bound),
                      f"llama: product {M}x{K}x{N} bf16 x float32: {sound:.3e}, bf16 weights "
                      f"{bf16w:.3e}, TF32 {tf32}, bound {bound:.3e}")
                rows.append(f"{M}x{K}x{N} bf16 x float32 {sound:.3e} (bound {bound:.3e}; bf16 "
                            f"weights {bf16w:.3e}; TF32 "
                            + ("the same bits" if tf32 is None else f"{tf32:.3e}") + ")")
            else:
                exact = a.double() @ b.double()
                mag = a.double().abs() @ b.double().abs()
                gamma = (K + 1) * 2.0 ** -24

                def excess(out):
                    return float(((out.double() - exact).abs()
                                  - 2.0 ** -8 * exact.abs() - 2 * gamma * mag).max())
                with exact_matmuls():
                    flags.allow_bf16_reduced_precision_reduction = True
                    reduced = torch.matmul(a, b)
                check(excess(got) <= 0, f"llama: product {M}x{K}x{N} bf16 x bf16 off its bound")
                rows.append(f"{M}x{K}x{N} bf16 x bf16 within its bound (reduced-precision "
                            "reduction on: "
                            + ("the same bits" if torch.equal(got, reduced) else
                               ("other bits, within" if excess(reduced) <= 0 else
                                "other bits, outside") + " the bound") + ")")
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = prev
    check(len(rows) == 8, f"llama: {len(rows)} distinct products, want 8")
    print("llama products on the card, max |err| / sum |a||w| (the caller's TF32 and "
          "reduced-precision bf16 flags on): " + "; ".join(rows), flush=True)


def llama_smoke(smi: str, device=None) -> None:
    """Phase 17: stories110M through ``Process``'s Llama table on the card."""
    import tempfile
    from unittest import mock

    from eoc_tfhe_tpu_torch.models import checkpoint, llama, publish, tokenizer
    from eoc_tfhe_tpu_torch.process import Process

    dev = torch.device("cuda") if device is None else torch.device(device)
    cfg = llama.LlamaConfig(**STORIES110M)
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        params = llama.init_params(gen, cfg, device=dev)
        n_params = sum(v.numel() for v in params.values())
        ckpt = os.path.join(tmp, "stories110M_q80.bin")
        save_s, _ = timed(lambda: checkpoint.save_llama2c(ckpt, params, cfg, version=2))
        del params
        with open(ckpt, "rb") as f:
            model_bytes = f.read()
        tok = tokenizer.byte_tokenizer(cfg.vocab_size)
        tok.save(os.path.join(tmp, "tok.bin"))
        with open(os.path.join(tmp, "tok.bin"), "rb") as f:
            tok_bytes = f.read()
        store = publish.LocalStore(os.path.join(tmp, "items"))
        head = publish.publish_model(store, model_bytes, tok_bytes, chunk_size=LLAMA_CHUNK)
        n_chunks = -(-len(model_bytes) // LLAMA_CHUNK)
        print(f"llama: stories110M {STORIES110M}, {n_params} parameters; Q8_0 v2 checkpoint "
              f"{len(model_bytes)} bytes in {save_s:.3f} s, published in {n_chunks} chunks",
              flush=True)

        text_gen = torch.Generator().manual_seed(0)
        prompt = _words(text_gen, LLAMA_PROMPT - 1)        # + the dummy-prefix space
        added = " and then"
        check(len(tok.encode(prompt)) == LLAMA_PROMPT, "llama: the prompt is not 128 tokens")
        env = json.dumps({"Process": {"Id": "smoke-llama", "Owner": "OWNER", "Module": "M1"}})

        def eval_chunk(src):
            r = json.loads(proc.handle(json.dumps({
                "Target": "smoke-llama", "From": "OWNER", "Block-Height": "1000",
                "Tags": [{"name": "Action", "value": "Eval"}], "Data": src}), env))
            check(r["Error"] is None, f"llama: {src[:80]!r} gave {r['Error']}")
            return r["Output"]["data"]["output"]

        served = []     # (kind, seconds, logits (B, V), token fed or None)

        def recording(fn, kind):
            def wrapped(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = fn(*a, **k)
                torch.cuda.synchronize()
                fed = int(a[3][0]) if kind == "decode" else None
                served.append((kind, time.perf_counter() - t0, logits[0].clone(), fed))
                return logits, cache
            return wrapped

        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        proc = Process(process_id="smoke-llama", model_store=store, device=device)
        load_s, _ = timed(lambda: eval_chunk(f'Llama.load("{head}")'))
        with mock.patch.object(llama, "prefill", recording(llama.prefill, "prefill")), \
                mock.patch.object(llama, "decode_step", recording(llama.decode_step, "decode")):
            eval_chunk(f'Llama.setPrompt("{prompt}")')
            run_s, _ = timed(lambda: eval_chunk(f"return Llama.run({LLAMA_RUN})"))
            eval_chunk(f'Llama.add("{added}")')
            eval_chunk("return Llama.next()")
        peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
        be = proc._llama_backend
        final_id = be._pending[-1]

        # the emitted ids against the argmax of the served logits (check 3)
        prompt_ids = tok.encode(prompt)
        add_ids = tok.encode(added)
        fed = [f for kind, _, _, f in served if kind == "decode"]
        emitted = fed[:LLAMA_RUN] + [final_id]
        argmax = [int(torch.argmax(lg)) for _, _, lg, _ in served]
        check([k for k, *_ in served] == ["prefill"] + ["decode"] * (len(served) - 1),
              "llama: the backend did not prefill and then decode")
        check(len(fed) == LLAMA_RUN + len(add_ids) and fed[LLAMA_RUN:] == add_ids,
              f"llama: decode fed {len(fed)} tokens, want the run's and the added")
        check(emitted == argmax[:LLAMA_RUN] + argmax[-1:],
              "llama: an emitted id is not the argmax of the card's logits")
        seq = prompt_ids + fed
        check(len(seq) == LLAMA_PROMPT + LLAMA_RUN + len(add_ids) and len(served) ==
              len(seq) - LLAMA_PROMPT + 1, "llama: served positions do not tile the stream")

        # the float64 oracle over the same dequantized weights, from its own
        # v0 parser (checks 1 and 2)
        _, np_params = checkpoint.load_llama2c(io.BytesIO(model_bytes))
        v0 = os.path.join(tmp, "dequantized_v0.bin")
        checkpoint.save_llama2c(v0, np_params, cfg, version=0)
        orc = _oracle()
        oracle_s, want = timed(lambda: orc.forward(*orc.load_v0(v0), seq))
        scale = float(np.abs(want).max())
        served_logits = torch.stack([lg for _, _, lg, _ in served]).double().cpu().numpy()
        err_served = float(np.abs(served_logits - want[LLAMA_PROMPT - 1:]).max())
        p_dev = be.model.params
        ids = torch.tensor([seq], dtype=torch.int32, device=dev)
        bf16_prompt = llama.forward(p_dev, ids[:, :LLAMA_PROMPT], cfg)[0].double().cpu().numpy()
        err_prompt = float(np.abs(bf16_prompt - want[:LLAMA_PROMPT]).max())
        f32 = llama.forward(p_dev, ids, cfg, compute_dtype=torch.float32)[0].double().cpu().numpy()
        err_f32 = float(np.abs(f32 - want).max())
        with mock.patch.object(llama, "matmul", lambda a, b: torch.matmul(_tf32(a), _tf32(b))):
            tf32 = llama.forward(p_dev, ids, cfg, compute_dtype=torch.float32)
        err_tf32 = float(np.abs(tf32[0].double().cpu().numpy() - want).max())
        with mock.patch.object(llama, "matmul", _bf16_weights):
            bf16w = llama.forward(p_dev, ids[:, :LLAMA_PROMPT], cfg)[0].double().cpu().numpy()
        err_bf16w = float(np.abs(bf16w - want[:LLAMA_PROMPT]).max())
        # bf16 (unit roundoff 2^-8): the classifier rounds its output to bf16
        # (up to 2^-8 of a logit) and both its inputs, the activation and the
        # embedding (each ~2^-8/sqrt(3) of a logit, random signs); the layers'
        # activation roundings add less, as the residual stream stays float32.
        # So 2^-7 (two roundoffs) of the largest logit bounds the path, and
        # the control with every weight in bf16 too (84 more roundings of that
        # size) must fail it.  float32: its roundoff is 2^-24, and a float32
        # path stays near 1e-6 of the largest logit; TF32 rounds every product
        # input at 2^-11, so 2^-14 of it passes float32 by ~2 orders and fails
        # TF32.
        tol_bf16, tol_f32 = scale * 2.0 ** -7, scale * 2.0 ** -14
        print(f"llama check: oracle (float64, {len(seq)} tokens) in {oracle_s:.3f} s, max |logit| "
              f"{scale:.6f}; served logits (prefill, then {len(served) - 1} decode steps) max err "
              f"{err_served:.3e}, bf16 forward at the {LLAMA_PROMPT} prompt positions "
              f"{err_prompt:.3e} (tolerance {tol_bf16:.3e}; with bf16 weights {err_bf16w:.3e}); "
              f"float32 forward {err_f32:.3e} (tolerance {tol_f32:.3e}; emulated TF32 "
              f"{err_tf32:.3e})", flush=True)
        check(err_served <= tol_bf16 and err_prompt <= tol_bf16,
              "llama: the served bf16 logits disagree with the float64 oracle")
        check(err_bf16w > tol_bf16, "llama: the bf16 tolerance does not reject bf16 weights")
        check(err_f32 <= tol_f32, "llama: the float32 forward disagrees with the float64 oracle")
        check(err_tf32 > tol_f32, "llama: the float32 tolerance does not reject TF32 products")
        llama_products(p_dev, ids[:, :LLAMA_PROMPT], cfg, be._cache, be._pos)

        prefill_ms = 1e3 * served[0][1]
        warm_s, _ = timed(lambda: be.model.prefill(ids[:, :LLAMA_PROMPT]))
        cache = be._cache.clone()
        step = device_breakdown(lambda: be.model.decode_step(cache, be._pos, ids[0, -1:]))
        decode_ms = 1e3 * float(np.median([s for k, s, _, _ in served if k == "decode"]
                                          [:LLAMA_RUN]))
        prompts = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), generator=gen,
                                device=dev, dtype=torch.int32)
        gen_s, out = timed(lambda: llama.generate(p_dev, prompts, GEN_NEW, cfg))
        check(out.shape == (GEN_BATCH, GEN_NEW) and bool(((out >= 0) & (out < cfg.vocab_size))
                                                         .all()), "llama: generate's ids")
        print(f"llama ({smi}): load {load_s:.3f} s (chain fetch, dequantization, upload); "
              f"prefill {prefill_ms:.2f} ms for {LLAMA_PROMPT} tokens (the process's first; "
              f"{1e3 * warm_s:.2f} ms again); decode {decode_ms:.2f} ms "
              f"a token (median of {LLAMA_RUN}), {1e3 / decode_ms:.1f} tokens/s; "
              f"run({LLAMA_RUN}) {run_s:.3f} s; peak device memory {peak_gb:.3f} GB above the "
              f"earlier phases'; "
              f"generate batch {GEN_BATCH}, prompt {GEN_PROMPT}, {GEN_NEW} new tokens in "
              f"{gen_s:.3f} s, {GEN_BATCH * GEN_NEW / gen_s:.1f} new tokens/s", flush=True)
        print(f"llama decode step at position {be._pos}, {step}", flush=True)
        del be, proc, p_dev, cache


def codec_smoke(key_blob: str, smi: str) -> None:
    """Phase 18: the native codec, built here, against the numpy path."""
    from eoc_tfhe_tpu_torch import native
    from eoc_tfhe_tpu_torch.core import params
    from eoc_tfhe_tpu_torch.io import tfhe_io

    build_s, ok = timed(native.available)
    check(ok, f"native: the codec did not build (g++) or load: {native.build_error}")
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
    names = sorted(f for f in os.listdir(data) if re.fullmatch(r"golden_.*\.bin", f))
    check(len(names) >= 3, f"native: golden fixtures missing ({names})")

    def numpy_path(fn):
        """fn() with the library unloaded: the path of a machine without g++."""
        saved = native._lib, native._tried
        native._lib, native._tried = None, True
        try:
            return fn()
        finally:
            native._lib, native._tried = saved

    def round_trip(name):
        with open(os.path.join(data, name), "rb") as f:
            blob = f.read()
        text = tfhe_io.b64encode(blob)
        outs = [text == base64.b64encode(blob).decode(), tfhe_io.b64decode(text) == blob]
        if name == "golden_lwesample_630.bin":
            outs.append(tfhe_io.pack_lwe_samples(*tfhe_io.unpack_lwe_samples(blob, 1, 630))
                        == blob)
            if native.available():
                outs.append(native.pack_lwe_array(*native.unpack_lwe_array(blob, 1, 630))
                            == blob)
        elif name.startswith("golden_secret_keyset"):
            ks, p = tfhe_io.import_secret_keyset(blob, device="cpu")
            outs.append(tfhe_io.export_secret_keyset(ks, p) == blob)
        return all(outs)

    for name in names:
        check(round_trip(name) and numpy_path(lambda: round_trip(name)),
              f"native: {name} does not round-trip on both paths")
    raw = tfhe_io.b64decode(key_blob)
    enc_s, enc = timed(lambda: tfhe_io.b64encode(raw))
    check(enc == key_blob, "native: the key blob's base64 differs")
    # the bulk records at the 128-bit keys' sizes: the keyswitch key's
    # 32,768 LWE records of n words, and the bootstrapping key's n (k+1) l
    # TLWE records of (k+1) N words
    p = params.default_128bit_params()
    rng = np.random.default_rng(0)
    B_ks = p.k * p.N * p.ks.t * (1 << p.ks.basebit)
    B_bk, m = p.n * (p.k + 1) * p.tgsw_params.l, (p.k + 1) * p.N
    a = rng.integers(-2**31, 2**31, (B_ks, p.n), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, B_ks, dtype=np.int64).astype(np.int32)
    polys = rng.integers(-2**31, 2**31, (B_bk, m), dtype=np.int64).astype(np.int32)
    var, var_bk = rng.random(B_ks), rng.random(B_bk)
    lwe = tfhe_io.pack_lwe_samples(a, b, var)
    tlwe = tfhe_io.pack_tlwe_samples(polys, var_bk)
    # (native, numpy): tfhe_io routes only base64 decoding through the library
    ops = {"base64 decode of the key blob": (lambda: tfhe_io.b64decode(key_blob),
                                             lambda: numpy_path(
                                                 lambda: tfhe_io.b64decode(key_blob))),
           f"pack {B_ks} LWE records": (lambda: native.pack_lwe_array(a, b, var),
                                         lambda: tfhe_io.pack_lwe_samples(a, b, var)),
           f"unpack {B_ks} LWE records": (lambda: native.unpack_lwe_array(lwe, B_ks, p.n),
                                           lambda: tfhe_io.unpack_lwe_samples(lwe, B_ks, p.n)),
           f"pack {B_bk} TLWE records": (lambda: native.pack_tlwe_array(polys, var_bk),
                                          lambda: tfhe_io.pack_tlwe_samples(polys, var_bk)),
           f"unpack {B_bk} TLWE records": (lambda: native.unpack_tlwe_array(tlwe, B_bk, m),
                                            lambda: tfhe_io.unpack_tlwe_samples(tlwe, B_bk, m))}
    rows = []
    for label, (fn_native, fn_numpy) in ops.items():
        want, got = fn_numpy(), fn_native()
        same = (got == want) if isinstance(want, bytes) else all(
            np.array_equal(x, y) for x, y in zip(got, want))
        check(same, f"native: {label} differs between the paths")
        t_native, t_numpy = [], []
        for _ in range(CODEC_REPEATS):      # alternating, median of each
            t_native.append(timed(fn_native)[0])
            t_numpy.append(timed(fn_numpy)[0])
        rows.append(f"{label} {1e3 * float(np.median(t_native)):.1f} ms native, "
                    f"{1e3 * float(np.median(t_numpy)):.1f} ms numpy")
    print(f"native ({smi}): codec built and loaded in {build_s:.3f} s; {len(names)} golden "
          f"fixtures ({', '.join(names)}) round-trip byte for byte on the native and numpy "
          f"paths; base64 encode of the {len(raw)}-byte key blob {enc_s:.3f} s (binascii); "
          f"median of {CODEC_REPEATS}: " + "; ".join(rows), flush=True)


def _llama_weights(cfg, dev):
    """Phase 17's random stories110M weights (seed 0 on the card)."""
    from eoc_tfhe_tpu_torch.models import llama
    return llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)


def _probe(weights: dict) -> torch.Tensor:
    """The last 16 values of each weight tensor: the generator's last draws."""
    return torch.cat([weights[k].flatten()[-16:] for k in sorted(weights)])


def _parallel_rank(rank: int, world: int, workdir: str, plan: dict) -> None:
    """Phase 19 (b), one rank of ``plan`` (``ONE_CARD_PLAN``, or one NCCL
    rank a card from ``parallel_times.py``).  Writes what it held against the
    parent's one-rank results to ``out<rank>.pt``; an exception ends the run."""
    from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, lwe, params
    from eoc_tfhe_tpu_torch.io import native_keys
    from eoc_tfhe_tpu_torch.models import llama
    from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1
    from eoc_tfhe_tpu_torch.parallel import distributed, mesh, sharded

    dev = torch.device("cuda", rank if plan["rank_card"] else 0)
    distributed.initialize(f"file://{workdir}/store", world, rank, backend=plan["backend"],
                           device=dev)
    host = torch.load(os.path.join(workdir, "inputs.pt"))
    p = params.default_128bit_params()
    ks = keys.keyset_from_numpy(*(host[k].numpy() for k in ("lwe_s", "tgsw_key", "bk", "bk_var",
                                                              "ks", "ks_var")), device=dev)
    inp = {k: v.to(dev) for k, v in host.items()}
    ca = [inp[f"ca_{f}"] for f in ("a", "b", "var")]
    cb = [inp[f"cb_{f}"] for f in ("a", "b", "var")]
    want = [inp[f"ref_{f}"] for f in ("a", "b", "var")]
    ks_var = ks.cloud.bk.ks.variance
    out = {}

    def same(got, ref):
        return all(torch.equal(g, r) for g, r in zip(got, ref))

    def count(fn):
        """(seconds, result, K1/K2/K3 launches) of one call after one warm call."""
        fn()
        blind_rotate.launches = blind_rotate_compact.launches = blind_rotate_v1.launches = 0
        secs, res = timed(fn)
        return secs, res, (blind_rotate.launches, blind_rotate_compact.launches,
                           blind_rotate_v1.launches)

    ek = bootstrap.prepare_eval_key(ks.cloud, p)
    for dp, tp in plan["nand"]:
        m = mesh.make_mesh(dp, tp, device=dev)
        fn = sharded.make_sharded_nand(m, p)
        secs, res, launches = count(lambda: fn(*ca, *cb, ek.bk_rows, ek.bk_variance,
                                               ek.ks_prepared, ks_var))
        out[f"nand_{dp}x{tp}"] = (same(res, want), secs, launches)
    if plan["scaling"]:
        B = ca[1].shape[0]

        def run_fn(m, batch):
            idx = torch.arange(batch, device=dev) % B
            xa, xb = ([x[idx] for x in c] for c in (ca, cb))
            if m is None:
                return lambda: gates.nand(lwe.LweCiphertext(*xa), lwe.LweCiphertext(*xb), ek, p)
            f = sharded.make_sharded_nand(m, p)
            return lambda: f(*xa, *xb, ek.bk_rows, ek.bk_variance, ek.ks_prepared, ks_var)
        out["scaling"] = distributed.scaling_report(
            run_fn, [plan["scaling"]], mesh.make_mesh(world, 1, device=dev), iters=ITERS)
    del ek

    eks = bootstrap.prepare_eval_key_ntt(ks.cloud, p, kernel=False)
    ctx = eks.ntt_ctx
    m_rows, m_freq = (mesh.make_mesh(*plan[k], device=dev) for k in ("rows", "freq"))
    rows = sharded.shard_ntt_key_rows(eks.bk_ntt, m_rows)
    key_f = sharded.shard_ntt_key_freq(eks.bk_ntt, m_freq)
    bk_var, ks_prepared = eks.bk_variance, eks.ks_prepared
    del eks
    torch.cuda.empty_cache()
    secs, res, launches = count(lambda: sharded.blind_rotate_ntt_tp(
        inp["acc0"], inp["bara"], rows, p, ctx, m_rows))
    out["rows"] = (torch.equal(res, inp["ref_rot"]), secs, launches)
    fn = sharded.make_sharded_nand_freq(m_freq, p, ctx)
    B8 = PAR_TP_BATCH
    secs, res, launches = count(lambda: fn(*(x[:B8] for x in ca), *(x[:B8] for x in cb),
                                           key_f, bk_var, ks_prepared, ks_var))
    out["freq_nand"] = (same(res, [x[:B8] for x in want]), secs, launches)

    kdir = os.path.join(workdir, "keys")
    tree = {"key": rows, "variance": bk_var}
    secs_w, man = timed(lambda: native_keys.save_pytree(kdir, tree, mesh=m_rows))
    secs_r, got = timed(lambda: native_keys.load_pytree(kdir, tree, mesh=m_rows))
    files = ["MANIFEST.json", *(f"t0.shard{k}.bin" for k in range(m_rows.tp)), "t1.shard0.bin"]
    out["native_keys"] = (man["tensors"]["t0"]["shards"] == m_rows.tp
                          and torch.equal(got["key"].local, rows.local)
                          and torch.equal(got["variance"], bk_var)
                          and sorted(os.listdir(kdir)) == files,
                          secs_w, secs_r, rows.local.numel())
    del rows, key_f, got
    torch.cuda.empty_cache()

    cfg = llama.LlamaConfig(**STORIES110M)
    weights = _llama_weights(cfg, dev)
    check(torch.equal(_probe(weights), inp["llama_probe"]),
          f"rank {rank}: the llama weights differ from the parent's")
    m = mesh.make_mesh(*plan["llama"], device=dev)
    local = llama.shard_params(weights, llama.llama_param_specs(cfg), m)
    del weights

    def forward():
        return llama.forward(local, inp["tokens"], cfg, compute_dtype=torch.float32,
                             tp_group=m.tp_group)
    forward()                                                     # warm
    secs, logits = timed(forward)
    out["llama"] = (float((logits - inp["ref_logits"]).abs().max()), secs,
                    local["wq"].shape[-1])
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    torch.distributed.destroy_process_group()


def parallel_inputs(ks, p, gen: torch.Generator, ca, cb, ref, workdir: str) -> dict:
    """Phase 19's one-rank results, written with the keys and ciphertexts to
    ``workdir/inputs.pt`` for the ranks: the "ntt_scan" rotation of random
    inputs at B=PAR_TP_BATCH (K3) and the float32 stories110M forward.
    Returns the one-rank seconds of the tp rotations (tp=1: every collective
    an identity) and of the forward."""
    from eoc_tfhe_tpu_torch.core import bootstrap
    from eoc_tfhe_tpu_torch.models import llama
    from eoc_tfhe_tpu_torch.ops import blind_rotate_v1
    from eoc_tfhe_tpu_torch.parallel import mesh, sharded

    dev = ca.a.device
    eks = bootstrap.prepare_eval_key_ntt(ks.cloud, p, kernel=False)
    tl = p.tgsw_params.tlwe_params
    acc0 = torch.randint(-2**31, 2**31, (PAR_TP_BATCH, tl.k + 1, tl.N), generator=gen,
                         dtype=torch.int64, device=dev).to(torch.int32)
    bara = torch.randint(0, 2 * tl.N, (p.n, PAR_TP_BATCH), generator=gen,
                         dtype=torch.int32, device=dev)
    ref_rot = blind_rotate_v1.blind_rotate_ntt_v1(acc0, bara, eks.bk_ntt, eks.ntt_ctx, p)
    one = mesh.make_mesh(1, 1, device=dev)
    secs = {}
    for name, rotate, cut in (
            ("blind_rotate_ntt_tp", sharded.blind_rotate_ntt_tp, sharded.shard_ntt_key_rows),
            ("blind_rotate_ntt_freq_tp", sharded.blind_rotate_ntt_freq_tp,
             sharded.shard_ntt_key_freq)):
        key1 = cut(eks.bk_ntt, one)
        rotate(acc0, bara[:2], key1, p, eks.ntt_ctx, one)         # warm, two steps
        secs[name], got = timed(lambda: rotate(acc0, bara, key1, p, eks.ntt_ctx, one))
        check(torch.equal(got, ref_rot), f"{name} on one rank differs from K3")
    del eks, key1
    cfg = llama.LlamaConfig(**STORIES110M)
    weights = _llama_weights(cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, PAR_LLAMA_TOKENS, generator=gen, device=dev)
    llama.forward(weights, toks, cfg, compute_dtype=torch.float32)   # warm
    secs["llama"], ref_logits = timed(lambda: llama.forward(weights, toks, cfg,
                                                            compute_dtype=torch.float32))
    probe = _probe(weights)
    del weights
    bk = ks.cloud.bk
    inputs = dict(lwe_s=ks.lwe_key.s, tgsw_key=ks.tgsw_key.key, bk=bk.bk,
                  bk_var=bk.bk_variance, ks=bk.ks.ks, ks_var=bk.ks.variance,
                  acc0=acc0, bara=bara, ref_rot=ref_rot, tokens=toks,
                  ref_logits=ref_logits, llama_probe=probe)
    for name, ct in (("ca", ca), ("cb", cb), ("ref", ref)):
        inputs.update({f"{name}_a": ct.a, f"{name}_b": ct.b, f"{name}_var": ct.current_variance})
    torch.save({k: v.cpu() for k, v in inputs.items()}, os.path.join(workdir, "inputs.pt"))
    torch.cuda.empty_cache()
    return secs


def run_parallel_ranks(plan: dict, world: int, workdir: str, B: int, one_rank: dict,
                       smi: str, label: str = "") -> list[dict]:
    """Spawn ``world`` ranks of ``plan`` (the kernels built already), hold
    every rank's results, print them (``label`` after "parallel"), and
    return each rank's outputs."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    mp.spawn(_parallel_rank, args=(world, workdir, plan), nprocs=world, join=True)
    ranks_s = time.perf_counter() - t0
    outs = [torch.load(os.path.join(workdir, f"out{r}.pt")) for r in range(world)]
    nands = [f"nand_{dp}x{tp}" for dp, tp in plan["nand"]]
    for r, out in enumerate(outs):
        for key in (*nands, "rows", "freq_nand"):
            ok, _, (k1, k2, k3) = out[key]
            check(ok, f"rank {r}: {key} differs from the one-rank result")
            check(k1 == 0 and k3 == 0 and (k2 == 1 if key in nands else k2 == 0),
                  f"rank {r}: {key} launches K1, K2, K3 = {k1}, {k2}, {k3}")
        check(out["native_keys"][0], f"rank {r}: the native_keys round trip differs")
        err = out["llama"][0]
        check(err <= PAR_LLAMA_ATOL, f"rank {r}: the tp llama forward is {err:.3e} off the "
              f"one-rank forward (tolerance {PAR_LLAMA_ATOL})")
    o = outs[0]
    where = ("NCCL, one a card" if plan["rank_card"] else f"{plan['backend']}, sharing cuda:0")
    (rdp, rtp), (_, ftp), (_, ltp) = plan["rows"], plan["freq"], plan["llama"]
    print(f"parallel{label} ({smi}): {world} ranks ({where}), {ranks_s:.2f} s with spawning; rank "
          f"0's host seconds: dp NAND B={B} at (dp, tp) = "
          + ", ".join(f"({dp}, {tp}) {o[f'nand_{dp}x{tp}'][1]:.3f} s" for dp, tp in plan["nand"])
          + f" (K2 once a rank); blind_rotate_ntt_tp at ({rdp}, {rtp}) B={PAR_TP_BATCH} "
          f"{o['rows'][1]:.3f} s (one rank, no collective: "
          f"{one_rank['blind_rotate_ntt_tp']:.3f} s); make_sharded_nand_freq tp={ftp} "
          f"B={PAR_TP_BATCH} {o['freq_nand'][1]:.3f} s (blind_rotate_ntt_freq_tp on one rank: "
          f"{one_rank['blind_rotate_ntt_freq_tp']:.3f} s); all word-identical to the "
          f"one-rank results on every rank", flush=True)
    print(f"parallel{label} ({smi}): native_keys of the row-sharded ntt_scan key "
          f"({o['native_keys'][3]} bytes a rank), written {o['native_keys'][1]:.3f} s, read "
          f"{o['native_keys'][2]:.3f} s, read back equal on every rank; stories110M forward "
          f"{PAR_LLAMA_TOKENS} tokens float32 at tp={ltp} ({o['llama'][2]} wq columns a rank) "
          f"{o['llama'][1]:.3f} s, max |logit - one rank| "
          f"{max(out['llama'][0] for out in outs):.3e} (tolerance {PAR_LLAMA_ATOL}; "
          f"one rank {one_rank['llama']:.3f} s)", flush=True)
    if plan["scaling"]:
        print(f"parallel{label} ({smi}): scaling_report of the dp NAND over {world} ranks: "
              f"{json.dumps(o['scaling']['points'][0])}", flush=True)
    return outs


def parallel_smoke(ks, p, gen: torch.Generator, smi: str) -> None:
    """Phase 19: the parallel tier on the card at 128-bit on phase 4's keyset."""
    import tempfile

    import torch.distributed as dist

    from eoc_tfhe_tpu_torch.config import FrameworkConfig
    from eoc_tfhe_tpu_torch.core import bootstrap, gates
    from eoc_tfhe_tpu_torch.core.lwe import LweCiphertext as lwe_ct
    from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1
    from eoc_tfhe_tpu_torch.parallel import distributed, sharded

    dev = torch.device("cuda", 0)
    B = FrameworkConfig().batch_size
    ek = bootstrap.prepare_eval_key(ks.cloud, p)
    a = torch.randint(0, 2, (B,), generator=gen, device=dev).bool()
    b = torch.randint(0, 2, (B,), generator=gen, device=dev).bool()
    ca, cb = (gates.encrypt_bit(gen, x, ks.lwe_key, p) for x in (a, b))
    ks_var = ks.cloud.bk.ks.variance
    gates.nand(ca, cb, ek, p)                                     # warm
    direct_ms, ref = cuda_ms(lambda: gates.nand(ca, cb, ek, p), ITERS)

    def counts():
        return {"blind_rotate_ntt": blind_rotate.launches,
                "blind_rotate_compact": blind_rotate_compact.launches,
                "blind_rotate_ntt_v1": blind_rotate_v1.launches}

    with tempfile.TemporaryDirectory() as tmp:
        # (a) one NCCL rank
        check(distributed.initialize(f"file://{tmp}/nccl", 1, 0) is False,
              "a one-rank group reported more ranks")
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()} on the card")
        mesh1 = FrameworkConfig(mesh_dp=1, mesh_tp=1).make_mesh()
        fn = sharded.make_sharded_nand(mesh1, p)

        def sharded_nand():
            return fn(ca.a, ca.b, ca.current_variance, cb.a, cb.b, cb.current_variance,
                      ek.bk_rows, ek.bk_variance, ek.ks_prepared, ks_var)
        blind_rotate.launches = blind_rotate_compact.launches = blind_rotate_v1.launches = 0
        sharded_nand()                                            # warm
        nccl_ms, got = cuda_ms(sharded_nand, ITERS)
        launches = counts()
        check(launches == {"blind_rotate_ntt": 0, "blind_rotate_compact": ITERS + 1,
                           "blind_rotate_ntt_v1": 0}, f"sharded NAND launches {launches}")
        for name, g, r in zip(("a", "b", "variance"), got, (ref.a, ref.b, ref.current_variance)):
            check(torch.equal(g, r), f"one-rank NCCL sharded NAND {name} differs from gates.nand")
        n_wrong = int((gates.decrypt_bit(ref, ks.lwe_key) != ~(a & b)).sum())
        check(n_wrong == 0, f"{n_wrong} of {B} sharded NAND outputs decrypt wrong")
        ones = torch.ones(4, device=dev)
        dist.all_reduce(ones)
        torch.cuda.synchronize()
        check(ones.tolist() == [1.0] * 4, "the NCCL all-reduce on one rank changed its input")

        def run_fn(m, batch):
            idx = torch.arange(batch, device=dev) % B
            xa, xb = ([c.a[idx], c.b[idx], c.current_variance[idx]] for c in (ca, cb))
            if m is None:
                return lambda: gates.nand(lwe_ct(*xa), lwe_ct(*xb), ek, p)
            f = sharded.make_sharded_nand(m, p)
            return lambda: f(*xa, *xb, ek.bk_rows, ek.bk_variance, ek.ks_prepared, ks_var)
        rep = distributed.scaling_report(run_fn, [B], mesh1, iters=ITERS)
        dist.destroy_process_group()
        print(f"parallel (a) ({smi}): one NCCL rank, FrameworkConfig(mesh_dp=1, mesh_tp=1)"
              f".make_mesh() on {mesh1.device}: make_sharded_nand B={B} {nccl_ms:.2f} ms/call "
              f"(gates.nand over the same compact key {direct_ms:.2f} ms/call); words and "
              f"variance equal to gates.nand, {B} of {B} decrypt correctly; launches "
              f"{launches}; NCCL all-reduce ran", flush=True)
        print(f"parallel (a) ({smi}): scaling_report on one rank (the sharded path's "
              f"overhead, not scaling): {json.dumps(rep['points'][0])}", flush=True)
        del ek

        # (b) ranks sharing the one card under gloo; the kernels are built already
        one_rank = parallel_inputs(ks, p, gen, ca, cb, ref, tmp)
        run_parallel_ranks(ONE_CARD_PLAN, PAR_RANKS, tmp, B, one_rank, smi, " (b)")


def noise_budget_bgbit(params, N: int, k: int, l: int, bg: int, n: int) -> int:
    """``bg``, or the nearest Bgbit that ``gates.check_noise_budget`` takes at
    (N, k, l, n) with int8 digits (Bgbit <= 8), the larger first on a tie."""
    from eoc_tfhe_tpu_torch.core import gates
    for cand in sorted(range(1, 9), key=lambda b: (abs(b - bg), -b)):
        try:
            gates.check_noise_budget(params.test_params(N=N, k=k, l=l, Bgbit=cand, n=n), -1, -1)
            return cand
        except ValueError:
            continue
    raise SmokeFailure(f"no Bgbit passes the noise budget at N={N} k={k} l={l} n={n}")


def wide_shapes_smoke(gen: torch.Generator, smi: str) -> None:
    """Phase 20: one NAND at full depth at two ROADMAP C7 shapes, two C8
    shapes, three C10 shapes, two C11 shapes and two C12 shapes, each through
    the kernel of its eval-key form, with that kernel timed at its inputs;
    and a NAND at N = 65536 over K2's global tier at C7_STEPS steps."""
    from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, params
    from eoc_tfhe_tpu_torch.core.numeric import mod_switch_to_torus32_np
    from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1, ntt

    dev = torch.device("cuda")
    modules = {"blind_rotate_ntt": blind_rotate, "blind_rotate_compact": blind_rotate_compact,
               "blind_rotate_ntt_v1": blind_rotate_v1}
    for fault, (N, k, l, bg), forms in (
            ("C7", (2048, 1, 3, 7), ("ntt_kernel", "ntt_scan")),
            ("C7", (512, 3, 3, 7), ("compact",)),
            ("C8", (4096, 1, 3, 7), ("ntt_scan", "compact")),     # F = 512; no K1 context
            ("C8", (1024, 3, 5, 5), ("ntt_kernel",)),             # K = 160
            ("C10", (8192, 1, 3, 7), ("ntt_scan", "compact")),    # F = 1024: K3 in a cluster
            ("C10", (16384, 1, 3, 7), ("ntt_scan", "compact")),   # F = 2048: both in a cluster
            ("C10", (4096, 2, 6, 4), ("ntt_scan",)),              # Kp = 144 at F = 512
            ("C11", (16384, 2, 3, 8), ("compact",)),              # K2: one digit row a pass
            ("C11", (8192, 2, 8, 4), ("ntt_scan", "compact")),    # K3 stream, K2 staged
            ("C12", (32768, 1, 3, 8), ("compact",)),              # K2's staged tier
            # K2's global tier; l = 4: at k = 2 l = 3 the rail takes no Bgbit <= 8
            ("C12", (32768, 2, 4, 8), ("compact",))):
        B = {**C10_BATCH, **C11_BATCH, **C12_BATCH}.get((N, k), C7_BATCH)
        nb = noise_budget_bgbit(params, N, k, l, bg, 630)      # the gate's rail takes the shape
        if nb != bg:
            print(f"{fault} N={N} k={k} l={l}: the noise budget refuses Bgbit={bg} at n=630; "
                  f"Bgbit={nb} (the nearest it takes)", flush=True)
        p = params.test_params(N=N, k=k, l=l, Bgbit=nb, n=630)
        shape = f"{fault} N={N} k={k} l={l} Bgbit={nb} n={p.n}"
        t0 = time.perf_counter()
        ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p, device=dev)
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        a = torch.randint(0, 2, (B,), generator=gen, device=dev).bool()
        b = torch.randint(0, 2, (B,), generator=gen, device=dev).bool()
        ca = gates.encrypt_bit(gen, a, ks.lwe_key, p)
        cb = gates.encrypt_bit(gen, b, ks.lwe_key, p)
        temp = gates.linear_input(int(mod_switch_to_torus32_np(1, 8)), ca, cb, -1, -1)
        acc0, bara = bootstrap.blind_rotate_inputs(gates.MU_BOOL, temp, p)
        for form in forms:
            t0 = time.perf_counter()
            if form == "compact":
                ek = bootstrap.prepare_eval_key_fused(ks.cloud, p)
                name, key = "blind_rotate_compact", ek.bk_compact
                run = lambda: blind_rotate_compact.blind_rotate_compact(acc0, bara, key, p)
                plain = lambda: blind_rotate_compact.blind_rotate_compact_plain(acc0, bara, key, p)
                plan6 = blind_rotate_compact.kernel_plan(k + 1, N, p.tgsw_params.kpl,
                                                         p.tgsw_params.halfBg)
                staged = blind_rotate_compact.is_staged(k + 1, N, p.tgsw_params.kpl,
                                                        p.tgsw_params.halfBg)
                in_memory = blind_rotate_compact.is_global(k + 1, N, p.tgsw_params.kpl,
                                                           p.tgsw_params.halfBg)
                plan = ("{} samples a block, {} key limb(s) and {} digit rows a pass, {} block(s)"
                        " a cluster".format(*plan6)
                        + (", global tier" if in_memory else ", general kernel"
                           if blind_rotate_compact.is_general(k + 1, N, plan6, staged) else "")
                        + (", staged tier" if staged else ""))
            else:
                ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p, kernel=form == "ntt_kernel")
                ctx = ek.ntt_ctx
                if form == "ntt_kernel":
                    name, key, stage = "blind_rotate_ntt", ek.bk_ntt_kernel, 0
                    run = lambda: blind_rotate.blind_rotate_ntt(acc0, bara, key, ctx, p)
                    plain = lambda: blind_rotate.blind_rotate_ntt_plain(acc0, bara, key, ctx, p)
                else:
                    name, key, stage = "blind_rotate_ntt_v1", ek.bk_ntt, blind_rotate_v1.STAGE_BYTES
                    run = lambda: blind_rotate_v1.blind_rotate_ntt_v1(acc0, bara, key, ctx, p)
                    plain = lambda: blind_rotate_v1.blind_rotate_ntt_v1_plain(acc0, bara, key,
                                                                              ctx, p)
                samples, general, cluster = blind_rotate.crt_mma_plan(k + 1, ctx, p.tgsw_params,
                                                                      stage)
                stream = blind_rotate.crt_mma_stream(k + 1, ctx, p.tgsw_params, stage)
                plan = (f"{samples} samples a block, "
                        f"{'general' if general else 'shipped'} instantiation"
                        + (f", {'stream tier' if stream else 'cluster instantiation'} of "
                           f"{cluster} blocks" if cluster > 1 else "")
                        + (f", {stream[1]} frequencies a sub-chunk, {stream[2]} slab(s)"
                           if stream else ""))
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            check(ek.form == form, f"{shape}: eval key form {ek.form}, wanted {form}")
            for m in modules.values():
                m.launches = 0
            gates.nand(ca, cb, ek, p)                          # warm
            nand_ms, out = cuda_ms(lambda: gates.nand(ca, cb, ek, p), 1)
            n_wrong = int((gates.decrypt_bit(out, ks.lwe_key) != ~(a & b)).sum())
            launches = {nm: m.launches for nm, m in modules.items()}
            check(n_wrong == 0, f"{shape} {form}: {n_wrong} of {B} NAND outputs decrypt wrong")
            check(launches == {nm: 2 if nm == name else 0 for nm in modules},
                  f"{shape} {form}: launches {launches}")
            k_ms, k_out = cuda_ms(run, 1)
            p_ms, p_out = cuda_ms(plain, 1)
            err = int((k_out.to(torch.int64) - p_out.to(torch.int64)).abs().max())
            check(err == 0, f"{name} differs from plain at {shape} (max {err})")
            if form == "compact":      # K1's plan up to N = 2048, then the plain version's
                bctx = (blind_rotate_compact.plain_context(p, device=dev) if N >= 4096
                        else ntt.kernel_context_for_params(p, device=dev))
                b_ms, b_by = compact_bound(B, p.n, key, bctx, p)
            else:
                b_ms, b_by = rotation_bound(B, p.n, key, p)
            print(f"{shape} ({smi}): keygen {keygen_s:.3f} s, {form} key {prep_s:.3f} s; "
                  f"nand B={B} {nand_ms:.2f} ms/call, {B} of {B} decrypt correctly, launches "
                  f"{launches}; {name} {k_ms:.2f} ms ({plan}; bound {b_ms:.2f} ms, {b_by}; "
                  f"plain {p_ms:.2f} ms), bit-identical to plain", flush=True)
            del ek, key, k_out, p_out, out
            torch.cuda.empty_cache()
        del ks
    # ROADMAP C12 at N = 65536: a NAND through K2's global tier at C7_STEPS
    # steps, as the card test test_c12_nand_at_n65536_runs_through_the_global_tier
    # (phase 6 holds the kernel against plain at N = 65536)
    p = params.test_params(N=65536, k=1, l=4, Bgbit=8, n=C7_STEPS)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p, device=dev)
    ek = bootstrap.prepare_eval_key_fused(ks.cloud, p)
    B = C7_RAGGED
    a = torch.randint(0, 2, (B,), generator=gen, device=dev).bool()
    b = torch.randint(0, 2, (B,), generator=gen, device=dev).bool()
    ca = gates.encrypt_bit(gen, a, ks.lwe_key, p)
    cb = gates.encrypt_bit(gen, b, ks.lwe_key, p)
    for m in modules.values():
        m.launches = 0
    nand_ms, out = cuda_ms(lambda: gates.nand(ca, cb, ek, p), 1)
    n_wrong = int((gates.decrypt_bit(out, ks.lwe_key) != ~(a & b)).sum())
    launches = {nm: m.launches for nm, m in modules.items()}
    check(n_wrong == 0, f"C12 N=65536 NAND: {n_wrong} of {B} outputs decrypt wrong")
    check(launches == {nm: int(nm == "blind_rotate_compact") for nm in modules},
          f"C12 N=65536 NAND: launches {launches}")
    print(f"C12 N=65536 k=1 l=4 Bgbit=8 n={p.n} ({smi}): nand B={B} {nand_ms:.2f} ms/call "
          f"(global tier), {B} of {B} decrypt correctly, launches {launches}", flush=True)
    del ks, ek, out
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of keys and data")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    run_t0 = time.perf_counter()
    from eoc_tfhe_tpu_torch.circuits import adder
    from eoc_tfhe_tpu_torch.config import FrameworkConfig
    from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, lwe, params
    from eoc_tfhe_tpu_torch.core.numeric import mod_switch_to_torus32_np
    from eoc_tfhe_tpu_torch.kernels import build
    from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1, ntt

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def encrypt_bytes(vals: torch.Tensor, ks, p):
        """(B,) integers in [0, 256) -> LWE bits (8, B), LSB first."""
        bits = torch.stack([(vals >> i) & 1 for i in range(8)]).bool()
        return gates.encrypt_bit(gen, bits, ks.lwe_key, p)

    def decrypt_word(ct, ks) -> torch.Tensor:
        bits = gates.decrypt_bit(ct, ks.lwe_key).to(torch.int64)
        return sum(bits[i] << i for i in range(bits.shape[0]))

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build_s: {time.perf_counter() - t0:.2f}", flush=True)
    for name, (secs, log) in logs.items():
        print(f"nvcc {name} ({secs:.2f} s):\n{log.strip()}", flush=True)
    for name in build.SIGNATURES:
        build.load(name)
    sass = {name: mma_instructions(build._target(name), build.nvcc())
            for name in build.SIGNATURES}
    print(f"sass tensor-core MMA instructions per library: {json.dumps(sass)}", flush=True)
    for name in build.SIGNATURES:
        check(sass[name]["IMMA"] + sass[name]["GMMA"] > 0,
              f"{name} has no tensor-core MMA instruction in its SASS")

    # 3. kernel against plain on the card
    for label, p, n_steps, B in (("test_params", params.test_params(), None, 63),
                                 ("128-bit", params.default_128bit_params(), None, 4),
                                 ("80-bit", params.default_80bit_params(), None, 4),
                                 *((lb, pc, None, C5_BATCH) for lb, pc in c5_params(params)),
                                 *((lb, pc, None, Bc)
                                   for lb, pc in (*c7_params(params), *c8_params(params),
                                                  *c9_params(params), *c10_params(params),
                                                  *c11_params(params))
                                   for Bc in (C5_BATCH, C7_RAGGED))):
        n_steps = p.n if n_steps is None else n_steps
        if p.N >= 4096:          # no context over KERNEL_PRIMES, as in the reference
            try:
                ntt.kernel_context_for_params(p, device=dev)
            except ValueError as e:
                check(f"K1 (blind_rotate_ntt) has no context at N={p.N}" in str(e), str(e))
                print(f"K1 refuses {label} by name: {e}", flush=True)
                continue
            raise SmokeFailure(f"K1 has a context at {label}")
        rows, acc0, bara = random_rotation_inputs(gen, p, n_steps, B, dev)
        ctx = ntt.kernel_context_for_params(p, label.startswith("C9"), device=dev)
        key = ntt.prepare_kernel_key(rows, ctx)
        run3 = lambda: blind_rotate.blind_rotate_ntt(acc0, bara, key, ctx, p)  # noqa: E731
        out = run3()
        plain = blind_rotate.blind_rotate_ntt_plain(acc0, bara, key, ctx, p)
        torch.cuda.synchronize()
        check(torch.equal(out, plain), f"blind_rotate_ntt differs from plain at {label}")
        samples, general, cluster = blind_rotate.crt_mma_plan(p.k + 1, ctx, p.tgsw_params)
        stream = blind_rotate.crt_mma_stream(p.k + 1, ctx, p.tgsw_params)
        check(cluster == 1 or stream is not None,   # K1's contexts end at F = 256
              f"K1 plans a cluster outside its stream tier at {label}")
        timing = ""
        if cluster > 1:
            repeat_equal(run3, out, f"blind_rotate_ntt at {label}")
            # K1's stream tier has no full-depth NAND (its key at K = 1280 is
            # 52.8 GB at n = 630): timed here, at these inputs
            k_ms, _ = cuda_ms(run3, 1)
            p_ms, _ = cuda_ms(
                lambda: blind_rotate.blind_rotate_ntt_plain(acc0, bara, key, ctx, p), 1)
            b_ms, b_by = rotation_bound(B, n_steps, key, p)
            timing = f"; {k_ms:.2f} ms (bound {b_ms:.2f} ms, {b_by}; plain {p_ms:.2f} ms)"
        print(f"kernel == plain at {label}: B={B}, n={n_steps}, {samples} samples a block"
              f"{' (general instantiation)' if general else ''}"
              + (f", stream tier in a cluster of {stream[0]} blocks, {stream[1]} frequencies "
                 f"a sub-chunk, {stream[2]} slab(s), {CLUSTER_REPEATS} repeats equal"
                 if stream else "")
              + f", key limbs {ctx.key_limbs}x{ctx.key_limb_bits}, rb={ctx.key_round_bits}, "
              f"bit-identical{timing}", flush=True)
        del rows, key, out, plain

    # 4. main path: 128-bit gate bootstrapping at full batch
    p = params.default_128bit_params()
    B = FrameworkConfig().batch_size
    t0 = time.perf_counter()
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    a = torch.randint(0, 2, (B,), generator=gen, device=dev).bool()
    b = torch.randint(0, 2, (B,), generator=gen, device=dev).bool()
    ca = gates.encrypt_bit(gen, a, ks.lwe_key, p)
    cb = gates.encrypt_bit(gen, b, ks.lwe_key, p)
    torch.cuda.synchronize()

    blind_rotate.launches = 0
    gates.nand(ca, cb, ek, p)                              # warm
    torch.cuda.synchronize()
    call_ms, out = cuda_ms(lambda: gates.nand(ca, cb, ek, p), ITERS)
    ok_bits = gates.decrypt_bit(out, ks.lwe_key) == ~(a & b)
    torch.cuda.synchronize()
    launches = {"blind_rotate_ntt": blind_rotate.launches}
    n_wrong = int((~ok_bits).sum())
    check(n_wrong == 0, f"{n_wrong} of {B} NAND outputs decrypt wrong")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    print(f"keygen_s: {keygen_s:.3f}  key_prep_s: {prep_s:.3f}  "
          f"eval_key_GB: {ek.bk_ntt_kernel.numel() / 1e9:.3f}", flush=True)   # int8
    print(f"nand B={B}: {call_ms:.2f} ms/call, {B / call_ms * 1e3:.1f} bootstraps/s, "
          f"{B} of {B} decrypt correctly; launches {launches}", flush=True)

    # 5. the kernel at the main path's inputs
    temp = gates.linear_input(int(mod_switch_to_torus32_np(1, 8)), ca, cb, -1, -1)  # NAND's
    acc0, bara = bootstrap.blind_rotate_inputs(gates.MU_BOOL, temp, p)
    key, ctx = ek.bk_ntt_kernel, ek.ntt_ctx
    kernel_ms, kout = cuda_ms(lambda: blind_rotate.blind_rotate_ntt(acc0, bara, key, ctx, p),
                              ITERS)
    plain_ms, pout = cuda_ms(lambda: blind_rotate.blind_rotate_ntt_plain(acc0, bara, key, ctx, p),
                             1)
    err = int((kout.to(torch.int64) - pout.to(torch.int64)).abs().max())
    check(err == 0, f"blind_rotate_ntt differs from plain at the main path (max {err})")
    k_bound_ms, bound_by = rotation_bound(B, p.n, key, p)
    print(f"blind_rotate_ntt: {kernel_ms:.2f} ms (bound {k_bound_ms:.2f} ms, {bound_by}; "
          f"plain {plain_ms:.2f} ms)", flush=True)
    kernels = [{
        "name": "blind_rotate_ntt", "route": "cuda",
        "source": "eoc_tfhe_tpu_torch/csrc/blind_rotate_ntt.cu",
        "replaces": "eoc_tfhe_tpu/ops/pallas_ntt_blindrot2.py:648",
        "launches": launches["blind_rotate_ntt"], "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": k_bound_ms,
        "bound_by": bound_by, "library_ms": None}]
    del kout, pout
    # the API's batch: one sample
    acc1, bara1 = acc0[:1].contiguous(), bara[:, :1].contiguous()
    one_ms, kout = cuda_ms(lambda: blind_rotate.blind_rotate_ntt(acc1, bara1, key, ctx, p), 5)
    _, pout = cuda_ms(lambda: blind_rotate.blind_rotate_ntt_plain(acc1, bara1, key, ctx, p), 1)
    check(torch.equal(kout, pout), "blind_rotate_ntt differs from plain at B=1")
    one_bound_ms, one_by = rotation_bound(1, p.n, key, p)
    print(f"blind_rotate_ntt at B=1: {one_ms:.2f} ms (bound {one_bound_ms:.2f} ms, {one_by}); "
          f"bit-identical to plain", flush=True)
    nand_ntt_ms = call_ms
    del kout, pout

    # 6. compact-key kernel against plain on the card
    phase_t0 = time.perf_counter()
    for label, pc, B6, limbs in (("test_params", params.test_params(), 63, 4),
                                 ("128-bit", params.default_128bit_params(), 4, 4),
                                 ("128-bit rounded", params.default_128bit_params(), 4, 3),
                                 *((lb, pc, C5_BATCH, 4) for lb, pc in c5_params(params)),
                                 *((lb, pc, Bc, 4)
                                   for lb, pc in (*c7_params(params), *c8_params(params),
                                                  *c10_params(params), *c11_params(params),
                                                  *c12_params(params))
                                   for Bc in (C5_BATCH, C7_RAGGED)
                                   if pc.tgsw_params.halfBg <= 128)):
        if "rows form" in label:        # the reference's rows scan takes the shape
            blind_rotate_compact.check_rows_domain(pc)
        rows, acc6, bara6 = random_rotation_inputs(gen, pc, pc.n, B6, dev)
        key6 = blind_rotate_compact.prepare_compact_bk(rows, limbs)
        run6 = lambda: blind_rotate_compact.blind_rotate_compact(acc6, bara6, key6, pc)  # noqa: E731
        out6 = run6()
        plain6 = blind_rotate_compact.blind_rotate_compact_plain(acc6, bara6, key6, pc)
        torch.cuda.synchronize()
        check(torch.equal(out6, plain6), f"blind_rotate_compact differs from plain at {label}")
        plan6 = blind_rotate_compact.kernel_plan(pc.k + 1, pc.N, pc.tgsw_params.kpl,
                                                 pc.tgsw_params.halfBg)
        samples, lp, jp, cluster = plan6
        staged = blind_rotate_compact.is_staged(pc.k + 1, pc.N, pc.tgsw_params.kpl,
                                                pc.tgsw_params.halfBg)
        in_memory = blind_rotate_compact.is_global(pc.k + 1, pc.N, pc.tgsw_params.kpl,
                                                   pc.tgsw_params.halfBg)
        if cluster > 1 or in_memory:
            repeat_equal(run6, out6, f"blind_rotate_compact at {label}")
        general = blind_rotate_compact.is_general(pc.k + 1, pc.N, plan6, staged)
        print(f"compact kernel == plain at {label}: B={B6}, n={pc.n}, limbs={limbs}, "
              f"{samples} samples a block, {lp} key limb(s) and {jp} of {pc.tgsw_params.kpl} "
              f"digit rows a pass, {cluster} block(s) a cluster"
              + (" (global tier)" if in_memory else " (general kernel)" if general else "")
              + f"{', staged tier' if staged else ''}"
              f"{f', {CLUSTER_REPEATS} repeats equal' if cluster > 1 or in_memory else ''}, "
              "bit-identical", flush=True)
        del rows, key6, out6, plain6
    print(f"phase 6: {time.perf_counter() - phase_t0:.1f} s", flush=True)

    # 7. the circuit path: 8-bit add and subtract over the compact key
    api = FrameworkConfig(param_set="128", eval_key_form="fused").make_gate_api(ks, p)
    eck = api.eval_key
    check(eck.form == "compact", f"fused config gave form {eck.form}")
    Bc = CIRCUIT_BATCH
    av = torch.randint(0, 256, (Bc,), generator=gen, device=dev)
    bv = torch.randint(0, 256, (Bc,), generator=gen, device=dev)
    ca8, cb8 = encrypt_bytes(av, ks, p), encrypt_bytes(bv, ks, p)
    torch.cuda.synchronize()
    blind_rotate.launches = blind_rotate_compact.launches = 0
    add_s, (s_bits, carry) = timed(lambda: adder.ripple_carry_add(ca8, cb8, eck, p))
    sub_s, (d_bits, borrow) = timed(lambda: adder.ripple_borrow_sub(ca8, cb8, eck, p))
    Bk = CLASSIC_BATCH
    cla8, clb8 = (lwe.lwe_index(c, (slice(None), slice(0, Bk))) for c in (ca8, cb8))
    classic_s, (k_bits, k_carry) = timed(
        lambda: adder.ripple_carry_add(cla8, clb8, eck, p, mode="classic"))
    breakdown = device_breakdown(lambda: adder.ripple_carry_add(ca8, cb8, eck, p))
    torch.cuda.synchronize()
    circuit_launches = {"blind_rotate_ntt": blind_rotate.launches,
                        "blind_rotate_compact": blind_rotate_compact.launches}
    for what, got, want in (
            ("add", decrypt_word(s_bits, ks), (av + bv) % 256),
            ("carry", gates.decrypt_bit(carry, ks.lwe_key), av + bv >= 256),
            ("sub", decrypt_word(d_bits, ks), (av - bv) % 256),
            ("borrow", gates.decrypt_bit(borrow, ks.lwe_key), av < bv),
            ("classic add", decrypt_word(k_bits, ks), (av[:Bk] + bv[:Bk]) % 256),
            ("classic carry", gates.decrypt_bit(k_carry, ks.lwe_key), av[:Bk] + bv[:Bk] >= 256)):
        n_wrong = int((got != want).sum())
        check(n_wrong == 0, f"{n_wrong} of {want.numel()} {what} outputs decrypt wrong")
    check(circuit_launches["blind_rotate_compact"] > 0,
          f"the compact kernel never launched on the circuit path: {circuit_launches}")
    check(circuit_launches["blind_rotate_ntt"] == 0,
          f"the NTT kernel launched on the compact circuit path: {circuit_launches}")
    fast_rot = 16 * Bc                  # 8 MAJ calls at B plus one refresh at 8*B
    classic_rot = 8 * 4 * Bk            # per bit: two XOR, MUX's two woKS rotations
    print(f"8-bit add (fast) B={Bc}: {add_s:.3f} s/op, {fast_rot / add_s:.1f} bootstraps/s; "
          f"sub (fast): {sub_s:.3f} s/op, {fast_rot / sub_s:.1f} bootstraps/s; "
          f"add (classic) B={Bk}: {classic_s:.3f} s/op, {classic_rot / classic_s:.1f} "
          f"bootstraps/s; all outputs decrypt correctly; launches {circuit_launches}",
          flush=True)
    print(f"8-bit add (fast) B={Bc}, {breakdown}", flush=True)

    # 8. NAND through the compact key at the main path's batch
    blind_rotate.launches = blind_rotate_compact.launches = 0
    api.nand(ca, cb)                                       # warm
    torch.cuda.synchronize()
    nand_c_ms, outc = cuda_ms(lambda: api.nand(ca, cb), ITERS)
    n_wrong = int((gates.decrypt_bit(outc, ks.lwe_key) != ~(a & b)).sum())
    nand_launches = {"blind_rotate_ntt": blind_rotate.launches,
                     "blind_rotate_compact": blind_rotate_compact.launches}
    check(n_wrong == 0, f"{n_wrong} of {B} compact-key NAND outputs decrypt wrong")
    check(nand_launches["blind_rotate_compact"] == ITERS + 1 and
          nand_launches["blind_rotate_ntt"] == 0, f"compact NAND launches {nand_launches}")
    print(f"nand (compact key) B={B}: {nand_c_ms:.2f} ms/call, "
          f"{B / nand_c_ms * 1e3:.1f} bootstraps/s (ntt_kernel key: {nand_ntt_ms:.2f} ms/call); "
          f"{B} of {B} decrypt correctly; launches {nand_launches}", flush=True)

    # 9. the compact kernel at the circuit path's inputs (the first MAJ call)
    carry0 = gates.constant(torch.zeros(Bc, dtype=torch.bool), p, device=dev)
    maj_in = lwe.lwe_add(lwe.lwe_add(lwe.lwe_index(ca8, 0), lwe.lwe_index(cb8, 0)), carry0)
    entry = None
    for label, (acc9, bara9) in (("circuit MAJ", bootstrap.blind_rotate_inputs(
            gates.MU_BOOL, maj_in, p)), ("NAND", (acc0, bara))):
        B9 = acc9.shape[0]
        k_ms, k_out = cuda_ms(lambda: blind_rotate_compact.blind_rotate_compact(
            acc9, bara9, eck.bk_compact, p), ITERS)
        p_ms, p_out = cuda_ms(lambda: blind_rotate_compact.blind_rotate_compact_plain(
            acc9, bara9, eck.bk_compact, p), 1)
        err9 = int((k_out.to(torch.int64) - p_out.to(torch.int64)).abs().max())
        check(err9 == 0, f"blind_rotate_compact differs from plain at {label} (max {err9})")
        b_ms, b_by = compact_bound(B9, p.n, eck.bk_compact, ek.ntt_ctx, p)
        print(f"blind_rotate_compact at {label} B={B9}: {k_ms:.2f} ms (bound {b_ms:.2f} ms, "
              f"{b_by}; plain {p_ms:.2f} ms)", flush=True)
        if entry is None:
            entry = {"name": "blind_rotate_compact", "route": "cuda",
                     "source": "eoc_tfhe_tpu_torch/csrc/blind_rotate_compact.cu",
                     "replaces": "eoc_tfhe_tpu/ops/pallas_blindrot.py:208",
                     "launches": circuit_launches["blind_rotate_compact"],
                     "max_abs_err": err9, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}
        del k_out, p_out
    kernels.append(entry)

    # 10. the "ntt_scan" form's kernel against plain on the card
    for label, pv, B10, primes in (
            ("test_params", params.test_params(), 63, ntt.DEFAULT_PRIMES),
            ("128-bit", params.default_128bit_params(), 4, ntt.DEFAULT_PRIMES),
            ("128-bit KERNEL_PRIMES", params.default_128bit_params(), 4, ntt.KERNEL_PRIMES),
            ("80-bit", params.default_80bit_params(), 4, ntt.DEFAULT_PRIMES),
            *((f"{lb} {tag}", pc, C5_BATCH, pr) for lb, pc in c5_params(params)
              for tag, pr in (("DEFAULT_PRIMES", ntt.DEFAULT_PRIMES),
                              ("KERNEL_PRIMES", ntt.KERNEL_PRIMES))),
            *((f"{lb} {tag}", pc, Bc, pr)
              for lb, pc in (*c7_params(params), *c8_params(params), *c10_params(params),
                             *c11_params(params))
              for Bc in (C5_BATCH, C7_RAGGED)
              for tag, pr in (("DEFAULT_PRIMES", ntt.DEFAULT_PRIMES),
                              ("KERNEL_PRIMES", ntt.KERNEL_PRIMES))
              if pc.N < 4096 or pr == ntt.DEFAULT_PRIMES),
            *((lb, pc, Bc, None) for lb, pc in c9_params(params)
              for Bc in (C5_BATCH, C7_RAGGED))):
        tg = pv.tgsw_params
        rows, acc10, bara10 = random_rotation_inputs(gen, pv, pv.n, B10, dev)
        if primes is None:       # the rounded plan over the form's DEFAULT_PRIMES
            ctx10 = ntt.context_for_params(pv, rounded=True, device=dev)
            primes = ctx10.primes
        else:
            ctx10 = ntt.make_context(tg.tlwe_params.N, tg.kpl, tg.halfBg, primes, device=dev)
        key10 = ntt.prepare_key_ntt(rows, ctx10)
        run10 = lambda: blind_rotate_v1.blind_rotate_ntt_v1(  # noqa: E731
            acc10, bara10, key10, ctx10, pv)
        out10 = run10()
        plain10 = blind_rotate_v1.blind_rotate_ntt_v1_plain(acc10, bara10, key10, ctx10, pv)
        torch.cuda.synchronize()
        check(torch.equal(out10, plain10), f"blind_rotate_ntt_v1 differs from plain at {label}")
        samples, general, cluster = blind_rotate.crt_mma_plan(pv.k + 1, ctx10, tg,
                                                              blind_rotate_v1.STAGE_BYTES)
        stream = blind_rotate.crt_mma_stream(pv.k + 1, ctx10, tg, blind_rotate_v1.STAGE_BYTES)
        if cluster > 1:
            repeat_equal(run10, out10, f"blind_rotate_ntt_v1 at {label}")
        print(f"v1 kernel == plain at {label}: B={B10}, n={pv.n}, halfBg={tg.halfBg}, "
              f"primes={primes}, key limbs {ctx10.key_limbs}x{ctx10.key_limb_bits}, "
              f"rb={ctx10.key_round_bits}, "
              f"{samples} samples a block{' (general instantiation)' if general else ''}"
              f"{f' in a cluster of {cluster} blocks, {CLUSTER_REPEATS} repeats equal' if cluster > 1 else ''}"
              f"{f', stream tier ({stream[1]} frequencies a sub-chunk, {stream[2]} slab(s))' if stream else ''}, "
              f"bit-identical", flush=True)
        del rows, key10, out10, plain10

    # 11. NAND through the "ntt_scan" key at the main path's batch
    t0 = time.perf_counter()
    eks = bootstrap.prepare_eval_key_ntt(ks.cloud, p, kernel=False)
    torch.cuda.synchronize()
    scan_prep_s = time.perf_counter() - t0
    check(eks.form == "ntt_scan", f"kernel=False gave form {eks.form}")

    def counts():
        return {"blind_rotate_ntt": blind_rotate.launches,
                "blind_rotate_compact": blind_rotate_compact.launches,
                "blind_rotate_ntt_v1": blind_rotate_v1.launches}

    blind_rotate.launches = blind_rotate_compact.launches = blind_rotate_v1.launches = 0
    gates.nand(ca, cb, eks, p)                             # warm
    torch.cuda.synchronize()
    nand_s_ms, outs = cuda_ms(lambda: gates.nand(ca, cb, eks, p), ITERS)
    n_wrong = int((gates.decrypt_bit(outs, ks.lwe_key) != ~(a & b)).sum())
    scan_nand_launches = counts()
    check(n_wrong == 0, f"{n_wrong} of {B} ntt_scan NAND outputs decrypt wrong")
    check(scan_nand_launches == {"blind_rotate_ntt": 0, "blind_rotate_compact": 0,
                                 "blind_rotate_ntt_v1": ITERS + 1},
          f"ntt_scan NAND launches {scan_nand_launches}")
    print(f"ntt_scan key_prep_s: {scan_prep_s:.3f}  eval_key_GB: {eks.bk_ntt.numel() / 1e9:.3f}",
          flush=True)
    print(f"nand (ntt_scan key) B={B}: {nand_s_ms:.2f} ms/call, "
          f"{B / nand_s_ms * 1e3:.1f} bootstraps/s; {B} of {B} decrypt correctly; "
          f"launches {scan_nand_launches}", flush=True)
    del outs

    # 12. the 8-bit fast add and subtract over the "ntt_scan" key
    blind_rotate.launches = blind_rotate_compact.launches = blind_rotate_v1.launches = 0
    sadd_s, (ss_bits, s_carry) = timed(lambda: adder.ripple_carry_add(ca8, cb8, eks, p))
    ssub_s, (sd_bits, s_borrow) = timed(lambda: adder.ripple_borrow_sub(ca8, cb8, eks, p))
    scan_circuit_launches = counts()
    for what, got, want in (
            ("add", decrypt_word(ss_bits, ks), (av + bv) % 256),
            ("carry", gates.decrypt_bit(s_carry, ks.lwe_key), av + bv >= 256),
            ("sub", decrypt_word(sd_bits, ks), (av - bv) % 256),
            ("borrow", gates.decrypt_bit(s_borrow, ks.lwe_key), av < bv)):
        n_wrong = int((got != want).sum())
        check(n_wrong == 0, f"{n_wrong} of {want.numel()} ntt_scan {what} outputs decrypt wrong")
    check(scan_circuit_launches == {"blind_rotate_ntt": 0, "blind_rotate_compact": 0,
                                    "blind_rotate_ntt_v1": 18},
          f"ntt_scan circuit launches {scan_circuit_launches}")
    print(f"8-bit add (fast, ntt_scan key) B={Bc}: {sadd_s:.3f} s/op, "
          f"{fast_rot / sadd_s:.1f} bootstraps/s; sub: {ssub_s:.3f} s/op, "
          f"{fast_rot / ssub_s:.1f} bootstraps/s; all outputs decrypt correctly; "
          f"launches {scan_circuit_launches}", flush=True)

    # 13. the "ntt_scan" kernel at the NAND's and the first MAJ call's inputs
    entry = None
    for label, (acc13, bara13) in (("NAND", (acc0, bara)), ("circuit MAJ",
                                   bootstrap.blind_rotate_inputs(gates.MU_BOOL, maj_in, p))):
        B13 = acc13.shape[0]
        k_ms, k_out = cuda_ms(lambda: blind_rotate_v1.blind_rotate_ntt_v1(
            acc13, bara13, eks.bk_ntt, eks.ntt_ctx, p), ITERS)
        p_ms, p_out = cuda_ms(lambda: blind_rotate_v1.blind_rotate_ntt_v1_plain(
            acc13, bara13, eks.bk_ntt, eks.ntt_ctx, p), 1)
        err13 = int((k_out.to(torch.int64) - p_out.to(torch.int64)).abs().max())
        check(err13 == 0, f"blind_rotate_ntt_v1 differs from plain at {label} (max {err13})")
        b_ms, b_by = rotation_bound(B13, p.n, eks.bk_ntt, p)
        print(f"blind_rotate_ntt_v1 at {label} B={B13}: {k_ms:.2f} ms (bound {b_ms:.2f} ms, "
              f"{b_by}; plain {p_ms:.2f} ms)", flush=True)
        if entry is None:
            entry = {"name": "blind_rotate_ntt_v1", "route": "cuda",
                     "source": "eoc_tfhe_tpu_torch/csrc/blind_rotate_ntt_v1.cu",
                     "replaces": "eoc_tfhe_tpu/ops/pallas_ntt_blindrot.py:321",
                     "launches": scan_nand_launches["blind_rotate_ntt_v1"],
                     "max_abs_err": err13, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}
        del k_out, p_out
    kernels.append(entry)
    del eks

    # 14. the Tfhe.* string API, one value per call
    key_blob = api_smoke(args.seed, gen)

    # 15. the served path; 16. the process runtime
    served_smoke(ks, ek, p, gen)
    process_smoke()
    del ek, ca, cb, ca8, cb8, api, eck
    torch.cuda.empty_cache()

    # 17. the llama tier at stories110M widths; 18. the native codec
    llama_smoke(smi)
    codec_smoke(key_blob, smi)

    # 19. the parallel tier on phase 4's keyset
    parallel_smoke(ks, p, gen, smi)

    # 20. full-depth NANDs at the ROADMAP C7 and C8 shapes
    del ks
    torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    wide_shapes_smoke(gen, smi)
    print(f"phase 20: {time.perf_counter() - phase_t0:.1f} s; run_s: "
          f"{time.perf_counter() - run_t0:.1f}", flush=True)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
