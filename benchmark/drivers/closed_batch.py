"""Closed loop of one batched gate.

Traffic keys: ``gate`` (a two-input gate of ``core.gates`` or ``mux``),
``batch`` (samples a call), ``pool`` (input batches encrypted in set-up,
taken in turn), ``rows_per_call`` (output samples of each call kept for
the check, drawn from the seed before the window, with replacement),
``check_rows`` (of those, the samples the reference recomputes, drawn from
the seed), ``trace_calls`` (calls in the traced sub-window, which starts
at the window's third call).

The calls go back to back with at most two in flight, so the device never
waits for the host and the window's closing ``synchronize()`` waits for
two calls at most.  Right after each call the window copies out its kept
samples on the device and lets the output go, so the allocator reuses the
output's memory as a deployment's loop would.  ``bootstraps_per_s`` counts
every sample of every call (two bootstraps a ``mux`` sample) over the
window's seconds.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from .. import harness as H
from ..reference import gates as G
from ..reference import tfhe as ref

#: Bootstraps a sample of each gate kind costs.
BOOTSTRAPS = {"mux": 2}

#: Calls with a row set of their own; later calls reuse them in turn.
CALL_ROWS = 1024


class PortProgram:
    """The system under test: ``core.gates.<gate>`` on the eval key of the
    configuration's form."""

    def __init__(self, cell, keys, p, pool, device):
        from eoc_tfhe_tpu_torch.core import gates
        from eoc_tfhe_tpu_torch.core.lwe import LweCiphertext

        self.pp = H.port_params(p)
        keyset = H.port_keyset(keys, p, device)
        self.ek = H.framework_config(cell.config).prepare_eval_key(keyset.cloud, self.pp)
        self.fn = getattr(gates, cell.traffic["gate"])
        var = float(torch.tensor(p.ks_stdev, dtype=torch.float32) ** 2)
        self.inputs = [[LweCiphertext(a=a, b=b, current_variance=torch.full(
            b.shape, var, dtype=torch.float32, device=device)) for a, b in ops]
            for ops in pool]

    def call(self, i: int):
        out = self.fn(*self.inputs[i], self.ek, self.pp)
        return out.a, out.b


class ReferenceProgram:
    """The control: the reference in the program's place, its products in
    float32."""

    def __init__(self, cell, keys, p, pool, device):
        self.g = G.Gates(keys, p, torch.float32)
        self.kind = cell.traffic["gate"]
        self.inputs = [[(H.words(a), H.words(b)) for a, b in ops] for ops in pool]

    def call(self, i: int):
        ops = self.inputs[i]
        return self.g.mux(*ops) if self.kind == "mux" else self.g.gate(self.kind, *ops)


def run(cell, args) -> H.Outcome:
    marks = {"start": H.process_age_s()}
    dev, tr = args.device, cell.traffic
    p = ref.Params.from_config(cell.config["params"])
    kind, B, P = tr["gate"], tr["batch"], tr["pool"]
    arity = 3 if kind == "mux" else 2
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    keys = ref.keygen(gen, p)
    bits = torch.randint(0, 2, (P, arity, B), generator=gen, device=dev).bool()
    pool = [[H.encrypt_bits(gen, bits[i, j], keys, p) for j in range(arity)] for i in range(P)]
    H.device_sync(dev)
    marks["keys"] = H.process_age_s()
    program = (ReferenceProgram if args.control else PortProgram)(cell, keys, p, pool, dev)
    H.device_sync(dev)
    marks["program"] = H.process_age_s()
    for i in range(min(P, 2)):          # every shape of the window, and the kernel loaded
        program.call(i)
    H.device_sync(dev)
    setup_s = H.process_age_s()

    # the samples each call keeps for the check, drawn before the window
    # (call i takes row set i mod CALL_ROWS)
    keep = torch.randint(0, B, (CALL_ROWS, tr["rows_per_call"]),
                         generator=torch.Generator().manual_seed(args.seed)).to(dev)
    trace = H.Trace(dev) if args.trace else None
    if trace is not None:
        trace.prepare()
    setup_peak = H.peak_reset(dev)
    kept, pending, calls = [], deque(), 0
    t0 = time.perf_counter()
    while True:
        if trace is not None and calls == 2:
            trace.start()
        rows = keep[calls % CALL_ROWS]
        kept.append(tuple(x.index_select(0, rows) for x in program.call(calls % P)))
        calls += 1
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.popleft().synchronize()
        if trace is not None and trace.active and calls == 2 + tr["trace_calls"]:
            trace.stop()
        traced = trace is None or calls >= 2 + tr["trace_calls"]
        if traced and time.perf_counter() - t0 >= args.seconds:
            break
    H.device_sync(dev)
    window_s = time.perf_counter() - t0
    peaks = {"set-up": setup_peak, "window": H.peak_reset(dev)}

    t_check = time.perf_counter()
    del program
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the sample, drawn from the seed, of the kept outputs of the window
    m = tr["rows_per_call"]
    pick = torch.randperm(calls * m, generator=torch.Generator().manual_seed(args.seed))
    pick = pick[:min(tr["check_rows"], calls * m)].sort().values.to(dev)
    got_a = torch.cat([a for a, _ in kept]).index_select(0, pick)
    got_b = torch.cat([b for _, b in kept]).index_select(0, pick)
    del kept
    call_of = pick // m
    row_of = keep[call_of % CALL_ROWS, pick % m]
    pool_of = call_of % P

    def take(get):
        return torch.stack([get(i) for i in range(P)])[pool_of, row_of]

    ins = [(take(lambda i: pool[i][j][0]), take(lambda i: pool[i][j][1])) for j in range(arity)]
    plain = bits[pool_of, :, row_of]
    g = G.Gates(keys, p)
    ops = [(H.words(a), H.words(b)) for a, b in ins]
    want_a, want_b = g.mux(*ops) if kind == "mux" else g.gate(kind, *ops)
    want_bits = G.PLAIN[kind](*plain.t())
    got_bits = ref.decrypt_bits(got_a, got_b, keys.lwe)
    checks = {"words_off": (H.rows_off(got_a, got_b, want_a, want_b), 0),
              "bits_off": (int((got_bits != want_bits).sum()), 0)}
    check_s = time.perf_counter() - t_check
    per_call = B * BOOTSTRAPS.get(kind, 1)
    return H.Outcome(
        attempted=calls * per_call, failed=0,
        e2e={"bootstraps_per_s": calls * per_call / window_s, "setup_s": setup_s},
        checks=checks, trace=trace, memory_peak_bytes=max(peaks.values()),
        counters={"setup_marks": marks, "memory_peaks": peaks, "calls": calls,
                  "window_s": window_s,
                  "batch": B,
                  "calls_traced": tr["trace_calls"],
                  "bootstraps_traced": tr["trace_calls"] * per_call,
                  "check_s": check_s, "checked": len(pick)})
