"""The program's spans in a trace (``benchmark/spans.py``) on hand-made
events, the readers of the metrics that rest on them, and the spans that
traced tiny runs hold."""

from __future__ import annotations

import collections
import json
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from benchmark import spans as S
from benchmark.harness import ROOT, Trace
from benchmark.reference.roofline import rotation_bound_ms
from benchmark.run import load

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _config(name="tfhe128-ntt"):
    return json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())


def ev(name, a, b, dev=CPU, id=0, thread=1, note=False):
    return NS(name=name, device_type=dev, id=id, thread=thread, is_user_annotation=note,
              time_range=NS(start=a * 1e6, end=b * 1e6))


def trace(events, window_s=10.0):
    t = Trace.__new__(Trace)
    t.events, t.window_s = events, window_s
    return t


ROT1 = "tfhe.bootstrap.rotate B=1 form=ntt_kernel"
ROT8 = "tfhe.bootstrap.rotate B=8 form=ntt_kernel"


@pytest.fixture
def call():
    """One API call: its spans, the runtime calls that queue device work
    (one from another thread, which no span of this thread holds), an aten
    op whose id equals a device op's, a device op no traced call queued,
    and the profiler's step and an annotation mirrored on the device."""
    return trace([
        ev("ProfilerStep*", 0, 10), ev("ProfilerStep*", 0, 10, dev=CUDA),
        ev("tfhe.api.addUint8Bits", 1, 9), ev("tfhe.api.decode", 1, 1.5),
        ev("tfhe.api.circuit", 2, 8), ev(ROT1, 2.5, 3), ev(ROT8, 5, 5.5),
        ev("tfhe.keyswitch", 6, 7), ev("tfhe.keyswitch", 6, 7, dev=CUDA, note=True),
        ev("aten::mm", 0.5, 0.6, id=13),
        ev("cudaLaunchKernel", 2.6, 2.61, id=11), ev("cudaLaunchKernel", 5.1, 5.11, id=12),
        ev("cudaLaunchKernel", 6.5, 6.51, id=13), ev("cudaLaunchKernel", 6.6, 6.61, id=16, thread=2),
        ev("cudaMemcpyAsync", 8.5, 8.51, id=14), ev("cudaLaunchKernel", 9.5, 9.51, id=15),
        ev("rotate_kernel", 2.7, 4.7, dev=CUDA, id=11),
        ev("rotate_kernel", 5.2, 5.9, dev=CUDA, id=12),
        ev("sgemm", 6.6, 6.8, dev=CUDA, id=13), ev("Memcpy DtoH", 8.6, 8.8, dev=CUDA, id=14),
        ev("gather", 9.6, 9.7, dev=CUDA, id=15), ev("fill", 0.2, 0.4, dev=CUDA, id=99),
        ev("copy", 6.8, 6.85, dev=CUDA, id=16)])


def test_span_name_and_attributes():
    s = S.Span(ROT8, 1, 0.0, 1.0)
    assert s.name == "tfhe.bootstrap.rotate" and s.attrs == {"B": "8", "form": "ntt_kernel"}


def test_ops_link_by_correlation_id_to_the_innermost_span(call):
    got = [(n, s.label if s else None)
           for n, _, _, s in sorted(S.linked_ops(call), key=lambda o: o[1])]
    assert got == [("fill", None), ("rotate_kernel", ROT1), ("rotate_kernel", ROT8),
                   ("sgemm", "tfhe.keyswitch"), ("copy", None),
                   ("Memcpy DtoH", "tfhe.api.addUint8Bits"), ("gather", None)]
    assert S.device_s(call, "tfhe.bootstrap.rotate") == pytest.approx(2.7)
    assert S.device_s(call, "tfhe.keyswitch") == pytest.approx(0.2)


def test_idle_instants_go_to_the_innermost_span(call):
    by = S.idle_by_span(call)
    want = {None: 1.7, "tfhe.api.decode": 0.5, "tfhe.api.addUint8Bits": 1.3,
            "tfhe.api.circuit": 1.9, "tfhe.bootstrap.rotate": 0.4, "tfhe.keyswitch": 0.75}
    assert by == {k: pytest.approx(v) for k, v in want.items()}
    assert sum(by.values()) == pytest.approx(10 - 3.45)    # the window less the busy union


def test_no_device_op_reads_nothing():
    t = trace([ev("ProfilerStep*", 0, 1), ev("tfhe.keyswitch", 0.1, 0.2)])
    assert S.idle_by_span(t) is None and S.linked_ops(t) == []


def test_bound_sums_each_rotation_at_its_batch():
    """An addUint8 call at the 128-bit set: 8 rotations at B = 1 (bytes,
    9.25 us) and one at B = 8 (operations, 60.09 us)."""
    t = trace([ev(ROT1, i, i + 0.5) for i in range(8)] + [ev(ROT8, 8, 8.5)])
    cfg = _config()
    want = 8 * rotation_bound_ms(cfg, 1)[0] + rotation_bound_ms(cfg, 8)[0]
    assert S.rotation_bound_s(cfg, t) * 1e3 == pytest.approx(want)
    assert want == pytest.approx(0.1341, abs=1e-4)


def _read(name, outcome, config=None):
    reader = load(ROOT / "benchmark" / "metrics" / f"{name}.py", f"metric_{name}")
    return reader.read(NS(config=config or _config()), outcome)


def test_metric_readers(call):
    out = NS(trace=call, counters={"calls_traced": 1, "bootstraps_traced": 2})
    assert _read("api_idle_ms.call", out) == pytest.approx(1.8e3)
    assert _read("gate_idle_ms.call", out) == pytest.approx(3.05e3)
    assert _read("keyswitch_us.batch", out) == pytest.approx(0.1e6)
    bound = rotation_bound_ms(_config(), 1)[0] + rotation_bound_ms(_config(), 8)[0]
    assert _read("rotate_roofline.call", out) == pytest.approx(100 * bound * 1e-3 / 2.7)
    # the CPU's trace (no device operation), and a program that opens no span
    cpu = trace([ev("ProfilerStep*", 0, 1), ev(ROT1, 0.1, 0.2)])
    parent = trace([e for e in call.events if not e.name.startswith("tfhe.")])
    for t in (cpu, parent):
        for name in ("api_idle_ms.call", "gate_idle_ms.call", "keyswitch_us.batch",
                     "rotate_roofline.call"):
            assert _read(name, NS(trace=t, counters=out.counters)) is None


@pytest.fixture
def outcomes(monkeypatch):
    """Each driver's Outcome of the runs made while the fixture lives."""
    from benchmark.drivers import closed_api, closed_batch

    got = []
    for mod in (closed_api, closed_batch):
        def run(cell, args, _run=mod.run):
            got.append(_run(cell, args))
            return got[-1]
        monkeypatch.setattr(mod, "run", run)
    return got


def _labels(outcome):
    return collections.Counter(s.label for s in S.program_spans(outcome.trace))


def test_traced_tiny_api_run_holds_nine_rotations_a_call(run_tiny, outcomes):
    line = run_tiny("tiny.tiny-api", trace=True)
    assert line["correct"]
    calls = outcomes[0].counters["calls_traced"]
    labels = _labels(outcomes[0])
    assert calls == 2
    assert {k: v for k, v in labels.items() if k.startswith("tfhe.bootstrap.rotate")} == {
        ROT1: 8 * calls, ROT8: calls}
    assert labels["tfhe.keyswitch"] == 9 * calls and labels["tfhe.api.circuit"] == calls


def test_traced_tiny_nand_run_holds_one_keyswitch_a_call(run_tiny, outcomes):
    line = run_tiny("tiny.tiny-nand", trace=True)
    assert line["correct"]
    labels = _labels(outcomes[0])
    calls = outcomes[0].counters["calls_traced"]
    assert labels["tfhe.keyswitch"] == calls == 2
    assert labels["tfhe.bootstrap.rotate B=16 form=ntt_kernel"] == calls
