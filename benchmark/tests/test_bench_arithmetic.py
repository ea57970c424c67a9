"""The roofline bound from a configuration's constants and B alone, and the
traffic that the seed fixes."""

from __future__ import annotations

import collections
import json

import pytest

from benchmark.drivers import closed_api
from benchmark.harness import ROOT
from benchmark.reference.roofline import ntt_macs, rotation_bound_ms


def _config(name):
    return json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())


def test_roofline_128_bit():
    ms, what = rotation_bound_ms(_config("tfhe128-ntt"), 8192)
    assert what == "operations" and ms == pytest.approx(61.53, abs=0.005)
    assert ntt_macs(2, 128, 48, 48, 1) == 11_796_480


def test_roofline_80_bit():
    ms, what = rotation_bound_ms(_config("tfhe80-ntt"), 8192)
    assert what == "operations" and ms == pytest.approx(60.8, abs=0.05)
    assert ntt_macs(2, 128, 32, 64, 2) == 14_680_064


def test_roofline_reads_no_key_layout():
    """The bound is the parameter set's and B's: at B = 1 the int32 key rows'
    bytes bound it (31.0 MB at 128 bits)."""
    ms, what = rotation_bound_ms(_config("tfhe128-ntt"), 1)
    assert what == "bytes" and ms == pytest.approx((30_965_760 + 2 * 8192 + 630 * 4)
                                                   / 3.35e12 * 1e3)


def test_api_cycle_is_the_seeds():
    tr = json.loads((ROOT / "benchmark/traffic/api-uint8.json").read_text())

    def cycles(seed, k=3):
        it = closed_api.plan(tr, seed)
        return [next(it) for _ in range(k)]

    a, b = cycles(2**31 + 9), cycles(12)
    assert a == cycles(2**31 + 9) and a != b
    for c in a + b:
        assert collections.Counter(op for op, _ in c) == tr["cycle"]
        assert all(len(idx) == 2 and max(idx) < tr["pool"] for _, idx in c)


def test_trace_reduction():
    """Busy time is the union of the device's operations; the profiler's
    step and user annotations mirrored on the device's timeline are none."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from benchmark.harness import Trace, breakdown, busy_s, idle_share

    def ev(name, a, b, dev=DeviceType.CUDA, note=False):
        return NS(name=name, device_type=dev, is_user_annotation=note,
                  time_range=NS(start=a * 1e6, end=b * 1e6))

    t = Trace.__new__(Trace)
    t.events = [ev("ProfilerStep#1", 0.0, 1.0), ev("region", 0.0, 0.9, note=True),
                ev("k1", 0.1, 0.5), ev("k2", 0.3, 0.6), ev("k3", 0.8, 0.9),
                ev("cudaLaunchKernel", 0.75, 0.76, dev=DeviceType.CPU)]
    assert [n for n, _, _ in t.device_ops()] == ["k1", "k2", "k3"]
    assert busy_s(t.device_ops()) == pytest.approx(0.6)
    b = breakdown(t)
    assert b["device_ops"][0][0] == "k1"
    assert b["idle_gaps"] == [["host: cudaLaunchKernel", pytest.approx(0.2)]]
    t.window_s = 1.0
    assert idle_share(t) == pytest.approx(40.0)
    t.window_s = 0.5
    with pytest.raises(ValueError, match="busy"):
        idle_share(t)
