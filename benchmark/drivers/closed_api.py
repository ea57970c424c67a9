"""Closed loop of one caller on the string API's bootstrapped uint8 calls.

Traffic keys: ``cycle`` (op -> calls of it in each cycle; ops: add, sub),
``pool`` (uint8 ciphertexts encrypted in set-up, as full-form base64
records), ``trace_cycles`` (the traced run profiles cycles 1 to ``trace_cycles``,
after one untraced cycle).

Each cycle makes the same calls, in an order and on operands drawn from
the seed.  The window runs whole cycles and closes at the end of the cycle in
progress once ``--seconds`` have passed, so every window holds the same
mix; ``call_ms`` is the window's seconds over its calls.  The reference
recomputes every call of the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness as H
from ..reference import codec
from ..reference import gates as G
from ..reference import tfhe as ref

#: The session method of each op; each takes two uint8 operands.
METHODS = {"add": "add_uint8_bits", "sub": "subtract_uint8_bits"}


class ReferenceSession:
    """The control: the reference's circuits in float32 behind the session's
    method names, on the same records."""

    def __init__(self, keys, p):
        self.g, self.p = G.Gates(keys, p, torch.float32), p
        self.dev = keys.bk.device

    def _call(self, op, *blobs):
        cts = []
        for s in blobs:
            a, b = codec.unpack_samples(codec.b64decode(s), 8, self.p.n)
            cts.append((H.words(torch.from_numpy(a).to(self.dev)).unsqueeze(1),
                        H.words(torch.from_numpy(b).to(self.dev)).unsqueeze(1)))
        a, b = getattr(self.g, op)(*cts)
        return codec.b64encode(codec.pack_samples(ref.wrap(a[:, 0]).cpu().numpy(),
                                                  ref.wrap(b[:, 0]).cpu().numpy(), 0.0))

    def __getattr__(self, name):
        op = {m: o for o, m in METHODS.items()}[name]
        return lambda *blobs: self._call(op, *blobs)


def plan(traffic: dict, seed: int):
    """The calls of each cycle, cycle after cycle: (op, pool indices of its
    operands)."""
    gen = torch.Generator().manual_seed(seed)
    P, ops = traffic["pool"], [o for o, c in traffic["cycle"].items() for _ in range(c)]
    while True:
        yield [(ops[i], torch.randint(0, P, (2,), generator=gen).tolist())
               for i in torch.randperm(len(ops), generator=gen).tolist()]


def run(cell, args) -> H.Outcome:
    from eoc_tfhe_tpu_torch.api.tfhe import TfheSession
    from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1

    def launches():
        return blind_rotate.launches + blind_rotate_v1.launches + blind_rotate_compact.launches

    marks = {"start": H.process_age_s()}
    dev, tr = args.device, cell.traffic
    p = ref.Params.from_config(cell.config["params"])
    P = tr["pool"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    keys = ref.keygen(gen, p)
    values = torch.randint(0, 256, (P,), generator=gen, device=dev)
    bits = ((values[:, None] >> torch.arange(8, device=dev)) & 1).bool()
    a, b = H.encrypt_bits(gen, bits.reshape(-1), keys, p)
    a, b = a.reshape(P, 8, p.n), b.reshape(P, 8)
    var = float(torch.tensor(p.ks_stdev, dtype=torch.float32) ** 2)
    host_a, host_b = a.cpu().numpy(), b.cpu().numpy()
    blobs = [codec.b64encode(codec.pack_samples(host_a[j], host_b[j], var)) for j in range(P)]
    values = values.tolist()
    marks["keys"] = H.process_age_s()
    if args.control:
        session = ReferenceSession(keys, p)
    else:
        session = TfheSession(params=H.port_params(p), seed=args.seed,
                              config=H.framework_config(cell.config), device=dev)
        session.import_secret_key(codec.b64encode(codec.secret_keyset(
            p, *(x.cpu().numpy() for x in (keys.lwe, keys.ring, keys.bk, keys.ks)))))
        session.gate_api()
        H.device_sync(dev)
        marks["program"] = H.process_age_s()
        for op in tr["cycle"]:          # the eval key and the shapes of the cycle's ops
            getattr(session, METHODS[op])(*blobs[:2])
    setup_s = H.process_age_s()

    cycles = plan(tr, args.seed)
    trace = H.Trace(dev) if args.trace else None
    if trace is not None:
        trace.prepare()
    setup_peak = H.peak_reset(dev)
    done, launches0, traced_calls = [], launches(), 0
    t0 = time.perf_counter()
    for c, calls in enumerate(cycles):
        if trace is not None and c == 1:
            trace.start()
        for op, idx in calls:
            done.append((op, idx, getattr(session, METHODS[op])(*(blobs[j] for j in idx))))
        if trace is not None and trace.active:
            traced_calls += len(calls)
            if c == tr["trace_cycles"]:
                trace.stop()
        traced = trace is None or c >= tr["trace_cycles"]
        if traced and time.perf_counter() - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    rotations = launches() - launches0
    peaks = {"set-up": setup_peak, "window": H.peak_reset(dev)}
    t_check = time.perf_counter()
    del session
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    g = G.Gates(keys, p)
    words_off = values_off = 0
    for op in METHODS:
        mine = [(idx, out) for o, idx, out in done if o == op]
        if not mine:
            continue
        got = [codec.unpack_samples(codec.b64decode(out), 8, p.n) for _, out in mine]
        got_a = torch.from_numpy(np.stack([x for x, _ in got])).to(dev)
        got_b = torch.from_numpy(np.stack([y for _, y in got])).to(dev)
        ops = [(H.words(a[[idx[o] for idx, _ in mine]].transpose(0, 1)),
                H.words(b[[idx[o] for idx, _ in mine]].transpose(0, 1)))
               for o in range(2)]
        want_a, want_b = getattr(g, op)(*ops)
        diff = ((H.words(got_a) != want_a.transpose(0, 1)).any(-1)
                | (H.words(got_b) != want_b.transpose(0, 1)))
        words_off += int(diff.any(-1).sum())
        got_bits = ref.decrypt_bits(got_a, got_b, keys.lwe).to(torch.int64)
        got_vals = (got_bits << torch.arange(8, device=dev)).sum(-1).tolist()
        want_vals = [G.PLAIN_U8[op](*(values[j] for j in idx)) for idx, _ in mine]
        values_off += sum(x != y for x, y in zip(got_vals, want_vals))
    check_s = time.perf_counter() - t_check
    return H.Outcome(
        attempted=len(done), failed=0,
        e2e={"call_ms": window_s * 1e3 / len(done), "setup_s": setup_s},
        checks={"words_off": (words_off, 0), "values_off": (values_off, 0)},
        trace=trace, memory_peak_bytes=max(peaks.values()),
        counters={"setup_marks": marks, "memory_peaks": peaks, "calls": len(done),
                  "window_s": window_s,
                  "rotations": rotations, "calls_traced": traced_calls,
                  "check_s": check_s, "checked": len(done)})
