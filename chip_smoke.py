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
     shapes over all their steps, and at the three shapes of ROADMAP C5
     (k=2 l=2 N=64, k=1 l=4 N=64, k=1 l=2 N=128) and at k=1 l=2 N=32 (B=7);
  4. the main path: 128-bit keygen on the card, ``prepare_eval_key_ntt``,
     encryption of BATCH random bit pairs, one warm and ITERS timed
     batched NAND calls, decryption checked against ~(a & b);
  5. the kernel at the main path's inputs (B=BATCH) and at batch 1 (the
     API's): timed, held against its plain version, with its bound;
  6. the compact-key kernel against its plain version on the card, bit for
     bit, at ``test_params()`` (B=63) and at 128-bit B=4 over all 630 steps
     with the exact and the rounded (limbs=3) stored key, and at the C5
     shapes (B=7);
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
     its steps, and at the C5 shapes (B=7) over either prime pair;
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
     on a fresh ``Process`` and every response must be byte-identical.
The three kernels are printed as one ``{"kernels": [...]}`` line.  The last
line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

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
#: The served path: client threads, and the chunk timed beside the default.
CLIENTS = 8
WIDE_CHUNK = 2048
#: ``submit_uint8`` requests of each op.
UINT8_REQUESTS = 64


def c5_params(params):
    """The shapes of ROADMAP C5 (M = 72 with U*R = 24, K = 64, and N = 128)
    and N = 32 (U*R = 8)."""
    return (("C5 k=2 l=2 N=64", params.test_params(k=2, l=2, N=64, n=4)),
            ("C5 k=1 l=4 N=64", params.test_params(k=1, l=4, N=64)),
            ("C5 k=1 l=2 N=128", params.test_params(k=1, l=2, N=128)),
            ("k=1 l=2 N=32", params.test_params(k=1, l=2, N=32)))


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
    the plan).  Bytes: the stored key, acc0, bara and the output, each moved
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


def api_smoke(seed: int, gen: torch.Generator) -> None:
    """Phase 14: ``Tfhe(seed=seed)`` at 128-bit with the default config on
    the card; every result decrypted and checked; host seconds per call."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of keys and data")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
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
                                 *((lb, pc, None, C5_BATCH) for lb, pc in c5_params(params))):
        n_steps = p.n if n_steps is None else n_steps
        rows, acc0, bara = random_rotation_inputs(gen, p, n_steps, B, dev)
        ctx = ntt.kernel_context_for_params(p, device=dev)
        key = ntt.prepare_kernel_key(rows, ctx)
        out = blind_rotate.blind_rotate_ntt(acc0, bara, key, ctx, p)
        plain = blind_rotate.blind_rotate_ntt_plain(acc0, bara, key, ctx, p)
        torch.cuda.synchronize()
        check(torch.equal(out, plain), f"blind_rotate_ntt differs from plain at {label}")
        print(f"kernel == plain at {label}: B={B}, n={n_steps}, bit-identical", flush=True)
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
    for label, pc, B6, limbs in (("test_params", params.test_params(), 63, 4),
                                 ("128-bit", params.default_128bit_params(), 4, 4),
                                 ("128-bit rounded", params.default_128bit_params(), 4, 3),
                                 *((lb, pc, C5_BATCH, 4) for lb, pc in c5_params(params))):
        rows, acc6, bara6 = random_rotation_inputs(gen, pc, pc.n, B6, dev)
        key6 = blind_rotate_compact.prepare_compact_bk(rows, limbs)
        out6 = blind_rotate_compact.blind_rotate_compact(acc6, bara6, key6, pc)
        plain6 = blind_rotate_compact.blind_rotate_compact_plain(acc6, bara6, key6, pc)
        torch.cuda.synchronize()
        check(torch.equal(out6, plain6), f"blind_rotate_compact differs from plain at {label}")
        print(f"compact kernel == plain at {label}: B={B6}, n={pc.n}, limbs={limbs}, "
              f"bit-identical", flush=True)
        del rows, key6, out6, plain6

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
                              ("KERNEL_PRIMES", ntt.KERNEL_PRIMES)))):
        tg = pv.tgsw_params
        rows, acc10, bara10 = random_rotation_inputs(gen, pv, pv.n, B10, dev)
        ctx10 = ntt.make_context(tg.tlwe_params.N, tg.kpl, tg.halfBg, primes, device=dev)
        key10 = ntt.prepare_key_ntt(rows, ctx10)
        out10 = blind_rotate_v1.blind_rotate_ntt_v1(acc10, bara10, key10, ctx10, pv)
        plain10 = blind_rotate_v1.blind_rotate_ntt_v1_plain(acc10, bara10, key10, ctx10, pv)
        torch.cuda.synchronize()
        check(torch.equal(out10, plain10), f"blind_rotate_ntt_v1 differs from plain at {label}")
        print(f"v1 kernel == plain at {label}: B={B10}, n={pv.n}, halfBg={tg.halfBg}, "
              f"primes={primes}, key limbs {ctx10.key_limbs}x{ctx10.key_limb_bits}, "
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
    api_smoke(args.seed, gen)

    # 15. the served path; 16. the process runtime
    served_smoke(ks, ek, p, gen)
    process_smoke()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
