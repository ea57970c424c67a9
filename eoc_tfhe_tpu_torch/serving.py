"""Batching gate server: the serving tier.

Port of ``eoc_tfhe_tpu/serving.py``.  The blind-rotation kernels reach their
throughput at batches of hundreds to thousands of gates, while callers
typically hold one ciphertext.  The server gathers concurrent gate requests
into device batches, runs ONE batched bootstrapped gate per (gate kind,
flush), and scatters the results back.

Design, as in the reference:
  * plain functions on tensors underneath; the server owns only queues;
  * one background worker thread drives the device; :meth:`GateServer.flush`
    may run batches on the caller's thread, serialized with the worker;
  * flush policy: ``max_batch`` gates or ``max_delay_s`` since the oldest
    queued request, whichever comes first;
  * per-(kind, seeded) queues: a flush batch is homogeneous in its input
    representation so that it stacks into one call;
  * seeded uploads: a request may carry ``SeededLweCiphertext`` operands
    (a 16-byte mask seed in place of the n-word mask); the masks are expanded
    on the device with :func:`~.core.lwe.lwe_seeded_expand`;
  * pipelined flushes: a batch runs in chunks of ``pipeline_chunk``; on the
    card each chunk's gate runs on the server's compute stream and its
    outputs are copied into pinned host buffers on a side stream that waits
    on the chunk's event, so the download of chunk k overlaps the compute of
    chunk k+1.

What differs from the reference: the kernels take any batch, so there is no
padding of a batch to a power-of-two bucket and no compiled program per kind
(``stats["padded_slots"]`` stays 0).

Results are ``LweCiphertext`` of host tensors.  ``concurrent.futures.Future``
is the result handle.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import torch

from .circuits import adder
from .core import gates
from .core.bootstrap import EvalKey, check_rotation_impl
from .core.lwe import LweCiphertext, SeededLweCiphertext, lwe_seeded_expand
from .core.params import GateBootstrappingParams
from .device import resolve_device

#: Two-input gate kinds servable by name.
GATE_FNS = {name: getattr(gates, name)
            for name in ("nand", "and_", "or_", "nor", "xor_", "xnor",
                         "andny", "andyn", "orny", "oryn")}

#: Three-input kinds (submit(kind, c, a, b): selector first, as ``gates.mux``;
#: upstream ``bootsMUX`` is the one 3-input gate).
GATE_FNS3 = {"mux": gates.mux}

#: Whole 8-bit circuits (``submit_uint8``), mod 256.
CIRCUIT_FNS = {"add_u8": adder.ripple_carry_add, "sub_u8": adder.ripple_borrow_sub,
               "mul_u8": adder.ripple_mul}


@dataclass
class _Request:
    ca: LweCiphertext
    cb: LweCiphertext
    future: Future
    cc: LweCiphertext | None = None      # third operand (mux only)
    t_enqueue: float = field(default_factory=time.monotonic)


class GateServer:
    """Aggregates gate requests into batched bootstraps.

    Usage::

        srv = GateServer(ek, params, max_batch=1024, max_delay_s=0.005)
        srv.start()
        fut = srv.submit("nand", ca, cb)     # ca/cb: single LWE ciphertexts
        out = fut.result()                    # LweCiphertext of host tensors
        srv.stop()

    ``ek`` must live on ``device``, which is the card unless named; without a
    card the constructor raises.
    """

    def __init__(self, ek: EvalKey, params: GateBootstrappingParams,
                 max_batch: int = 1024, max_delay_s: float = 0.005,
                 rotation_impl: str = "auto", pipeline_chunk: int = 128, device=None):
        check_rotation_impl(rotation_impl)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if ek.bk_rows.device != self.device:
            raise ValueError(f"the eval key lives on {ek.bk_rows.device}, the server "
                             f"computes on {self.device}")
        self.ek = ek
        self.params = params
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.rotation_impl = rotation_impl
        #: Batches larger than this run as a pipeline of chunks whose
        #: downloads overlap the next chunk's compute.  The default, 128, is
        #: the reference's (the TPU kernel's lane tile).
        self.pipeline_chunk = pipeline_chunk
        self._queues: dict[tuple[str, bool], list[_Request]] = {
            (k, s): [] for k in (*GATE_FNS, *GATE_FNS3, *CIRCUIT_FNS)
            for s in (False, True)}
        self._lock = threading.Lock()
        # Serializes _run_batch across threads: flush() runs batches on the
        # calling thread while the worker may be mid-batch; the streams and
        # self.stats are only touched while holding this lock.
        self._exec_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None
        if self.device.type == "cuda":
            self._compute = torch.cuda.Stream(self.device)
            self._download = torch.cuda.Stream(self.device)
        self.stats = {"flushes": 0, "gates": 0, "padded_slots": 0}

    # -- client side -------------------------------------------------------

    def submit(self, kind: str, ca, cb, cc=None) -> Future:
        """Queue one gate.  Operands: single (scalar-batch) ``LweCiphertext``
        or ``SeededLweCiphertext``, all of one representation.  Two-input
        kinds take (ca, cb); ``"mux"`` takes (c, a, b), selector first, like
        ``gates.mux``."""
        if kind in GATE_FNS3:
            if cc is None:
                raise ValueError(f"gate kind {kind!r} takes three operands")
        elif kind in GATE_FNS:
            if cc is not None:
                raise ValueError(f"gate kind {kind!r} takes two operands")
        else:
            raise ValueError(f"unknown gate kind {kind!r}; one of "
                             f"{sorted(GATE_FNS) + sorted(GATE_FNS3)}")
        ops = (ca, cb) if cc is None else (ca, cb, cc)
        seeded = isinstance(ca, SeededLweCiphertext)
        if any(isinstance(o, SeededLweCiphertext) != seeded for o in ops):
            raise ValueError("operands must all be seeded or all plain")
        if any(tuple(o.b.shape) != () for o in ops):
            raise ValueError("submit() takes single (scalar-batch) ciphertexts")
        return self._enqueue((kind, seeded), _Request(ca, cb, Future(), cc=cc))

    def submit_uint8(self, op: str, ca_bits, cb_bits) -> Future:
        """Queue a whole bootstrapped 8-bit operation (``"add"``, ``"sub"`` or
        ``"mul"``, mod 256).  Operands: ``LweCiphertext`` or
        ``SeededLweCiphertext`` with batch shape (8,), one gate-encoded bit
        per slot, LSB first (the ``api.tfhe`` uint8 layout).  Requests batch
        across clients: one flush runs the circuit once over the stacked
        batch."""
        if op not in ("add", "sub", "mul"):
            raise ValueError(f"unknown uint8 op {op!r}; 'add', 'sub' or 'mul'")
        seeded = isinstance(ca_bits, SeededLweCiphertext)
        if seeded != isinstance(cb_bits, SeededLweCiphertext):
            raise ValueError("operands must both be seeded or both plain")
        if tuple(ca_bits.b.shape) != (8,) or tuple(cb_bits.b.shape) != (8,):
            raise ValueError("submit_uint8 takes (8,)-batch bit ciphertexts")
        return self._enqueue((f"{op}_u8", seeded), _Request(ca_bits, cb_bits, Future()))

    def _enqueue(self, qkey: tuple[str, bool], req: _Request) -> Future:
        with self._lock:
            if self._stop:
                raise RuntimeError("server stopped")
            self._queues[qkey].append(req)
        self._wake.set()
        return req.future

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "GateServer":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="eoc-gate-server")
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        if drain:
            self.flush()
        with self._lock:
            self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- server side -------------------------------------------------------

    def flush(self) -> int:
        """Synchronously run everything queued (any thread).  Returns the
        number of requests executed."""
        done = 0
        while True:
            batch = self._take_ready(force=True)
            if batch is None:
                return done
            done += self._run_batch(*batch)

    def _take_ready(self, force: bool) -> tuple[tuple[str, bool], list[_Request]] | None:
        now = time.monotonic()
        with self._lock:
            best = None
            for qkey, q in self._queues.items():
                if not q:
                    continue
                due = force or len(q) >= self.max_batch or \
                    (now - q[0].t_enqueue) >= self.max_delay_s
                if due and (best is None or len(q) > len(self._queues[best])):
                    best = qkey
            if best is None:
                return None
            q = self._queues[best]
            take, self._queues[best] = q[: self.max_batch], q[self.max_batch:]
            return best, take

    def _run_batch(self, qkey: tuple[str, bool], reqs: list[_Request]) -> int:
        with self._exec_lock:
            return self._run_batch_locked(qkey, reqs)

    def _gate(self, kind: str, seeded: bool, flat: list[torch.Tensor]):
        """One chunk: the operands' (mask or seed, b, variance) stacks on the
        device -> the output's (a, b, variance), contiguous."""
        n = self.params.n
        cts = []
        for o in range(0, len(flat), 3):
            m, b, v = flat[o:o + 3]
            ct = (lwe_seeded_expand(SeededLweCiphertext(m, b, v), n) if seeded
                  else LweCiphertext(m, b, v))
            if kind in CIRCUIT_FNS:
                # stacked (Bc, 8, ...) -> the circuit's (8, Bc, ...)
                ct = LweCiphertext(a=ct.a.transpose(0, 1), b=ct.b.transpose(0, 1),
                                   current_variance=ct.current_variance.transpose(0, 1))
            cts.append(ct)
        if kind in CIRCUIT_FNS:
            out, _flag = CIRCUIT_FNS[kind](*cts, self.ek, self.params, self.rotation_impl)
            return tuple(x.transpose(0, 1).contiguous()
                         for x in (out.a, out.b, out.current_variance))
        fn = GATE_FNS3.get(kind) or GATE_FNS[kind]
        out = fn(*cts, self.ek, self.params, self.rotation_impl)
        return tuple(x.contiguous() for x in (out.a, out.b, out.current_variance))

    def _run_chunks(self, kind: str, seeded: bool, flat: list[torch.Tensor],
                    B: int) -> list[torch.Tensor]:
        """Every chunk's gate; returns the outputs' (a, b, variance) as host
        tensors over all B requests."""
        chunk = max(1, self.pipeline_chunk)
        if self.device.type != "cuda":
            parts = [self._gate(kind, seeded, [x[o:o + chunk] for x in flat])
                     for o in range(0, B, chunk)]
            return [torch.cat([p[i] for p in parts]) for i in range(3)]
        compute, download = self._compute, self._download
        # the key and any inputs on the card come from the callers' streams
        compute.wait_stream(torch.cuda.current_stream(self.device))
        host = None
        with torch.cuda.stream(compute):
            flat = [x.to(self.device, non_blocking=True) for x in flat]
            for o in range(0, B, chunk):
                outs = self._gate(kind, seeded, [x[o:o + chunk] for x in flat])
                if host is None:
                    host = [torch.empty((B,) + tuple(x.shape[1:]), dtype=x.dtype,
                                        pin_memory=True) for x in outs]
                done = torch.cuda.Event()
                done.record(compute)
                with torch.cuda.stream(download):
                    download.wait_event(done)
                    for h, x in zip(host, outs):
                        h[o:o + x.shape[0]].copy_(x, non_blocking=True)
                        # the allocator must not hand x's memory to the compute
                        # stream before the download has read it
                        x.record_stream(download)
        download.synchronize()
        return host

    def _run_batch_locked(self, qkey: tuple[str, bool], reqs: list[_Request]) -> int:
        kind, seeded = qkey
        B = len(reqs)
        try:
            mask_field = "seed" if seeded else "a"
            operands = [[r.ca for r in reqs], [r.cb for r in reqs]]
            if kind in GATE_FNS3:
                operands.append([r.cc for r in reqs])
            flat = [torch.stack([torch.as_tensor(getattr(c, f)) for c in cts])
                    for cts in operands for f in (mask_field, "b", "current_variance")]
            oa, ob, ov = self._run_chunks(kind, seeded, flat, B)
        except Exception as exc:   # surface the failure on every future
            for r in reqs:
                if not r.future.cancelled():
                    r.future.set_exception(exc)
            return 0
        for i, r in enumerate(reqs):
            if not r.future.cancelled():
                r.future.set_result(LweCiphertext(a=oa[i], b=ob[i], current_variance=ov[i]))
        self.stats["flushes"] += 1
        self.stats["gates"] += B
        return B

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stop and not any(self._queues.values()):
                    return
            batch = self._take_ready(force=False)
            if batch is not None:
                self._run_batch(*batch)
                continue
            # nothing due: sleep until the next deadline or a new submit
            with self._lock:
                oldest = min((q[0].t_enqueue for q in self._queues.values() if q),
                             default=None)
                stopping = self._stop
            if oldest is None:
                if stopping:
                    return
                self._wake.wait(timeout=0.05)
            else:
                wait = self.max_delay_s - (time.monotonic() - oldest)
                if wait > 0:
                    self._wake.wait(timeout=wait)
            self._wake.clear()
