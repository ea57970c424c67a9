"""The port's spans (``utils.profiling.span``): nothing while no profiler
records, nested profiler ranges with their attributes in the
name while one does, and the names the API, the bootstrap and the keyswitch
open on the CPU."""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eoc_tfhe_tpu_torch import config
from eoc_tfhe_tpu_torch.api.tfhe import TfheSession
from eoc_tfhe_tpu_torch.core import gates, keys, params
from eoc_tfhe_tpu_torch.utils import profiling

P = params.test_params()


class Unprintable:
    def __format__(self, spec):
        raise AssertionError("an attribute was formatted while nothing records")


def _ranges(prof, prefix="tfhe."):
    """(name, start us, end us) of the recorded ranges under ``prefix``."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(prefix)]


def test_span_is_nothing_while_no_profiler_records():
    """One shared null context, its attributes never formatted."""
    with profiling.span("tfhe.x", B=Unprintable()) as inner:
        assert inner is None
    assert profiling.span("tfhe.y") is profiling.span("tfhe.z", B=1)
    assert isinstance(profiling.span("tfhe.y"), contextlib.nullcontext)


def test_span_nests_with_attributes_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("tfhe.outer", B=8, form="ntt_kernel"):
            with profiling.span("tfhe.inner"):
                torch.ones(4).sum()
    (outer, o0, o1), = [r for r in _ranges(prof) if r[0].startswith("tfhe.outer")]
    (inner, i0, i1), = [r for r in _ranges(prof) if r[0].startswith("tfhe.inner")]
    assert outer == "tfhe.outer B=8 form=ntt_kernel" and inner == "tfhe.inner"
    assert o0 <= i0 <= i1 <= o1


def test_op_timer_counts_echoes_and_opens_its_span(capsys):
    profiling.PROFILER.reset()
    config.FrameworkConfig(profile_echo=True).apply_profiling()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.op_timer("addUint8Bits"):
                pass
        with profiling.op_timer("addUint8Bits"):
            pass
    finally:
        config.FrameworkConfig().apply_profiling()
    assert profiling.PROFILER.summary()["addUint8Bits"]["calls"] == 2
    assert capsys.readouterr().out.count("addUint8Bits completed in") == 2
    assert [r[0] for r in _ranges(prof)] == ["tfhe.api.addUint8Bits"]


@pytest.fixture(scope="module")
def keyset():
    return keys.new_random_gate_bootstrapping_secret_keyset(
        torch.Generator().manual_seed(5), P, device="cpu")


@pytest.mark.parametrize("gate, rotations, keyswitches", [("nand", 1, 1), ("mux", 2, 1)])
def test_gate_spans(keyset, gate, rotations, keyswitches):
    """A gate's bootstraps: mod switch, rotation (with its batch and form),
    extraction, in turn; the keyswitch once, ``mux``'s direct call too."""
    ek = config.FrameworkConfig(param_set="test").prepare_eval_key(keyset.cloud, P)
    bits = torch.tensor([True, False, True])
    cts = [gates.encrypt_bit(torch.Generator().manual_seed(i), bits, keyset.lwe_key, P)
           for i in range(3 if gate == "mux" else 2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        getattr(gates, gate)(*cts, ek, P)
    names = [r[0] for r in sorted(_ranges(prof), key=lambda r: r[1])]
    step = ["tfhe.bootstrap.mod_switch", f"tfhe.bootstrap.rotate B=3 form={ek.form}",
            "tfhe.bootstrap.extract"]
    assert names == step * rotations + ["tfhe.keyswitch"] * keyswitches


def test_api_call_spans():
    """One addUint8 at batch 1: its op span holds the decode, upload, circuit
    and export spans; the circuit's 9 rotations are 8 at B = 1 and the
    refresh of the 8 sum bits at B = 8."""
    s = TfheSession(params=P, seed=3, device="cpu")
    s.generate_secret_key()
    x, y = s.encrypt_uint8_bits(200), s.encrypt_uint8_bits(77)
    s.add_uint8_bits(x, y)          # the gate API and the eval key, built outside the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = s.add_uint8_bits(x, y)
    assert s.decrypt_uint8_bits(out) == (200 + 77) % 256
    ranges = _ranges(prof)
    (op, t0, t1), = [r for r in ranges if r[0] == "tfhe.api.addUint8Bits"]
    assert all(t0 <= a <= b <= t1 for _, a, b in ranges)
    count = collections.Counter(r[0] for r in ranges)
    assert {k: count[k] for k in ("tfhe.api.decode", "tfhe.api.upload", "tfhe.api.circuit",
                                  "tfhe.api.export", "tfhe.keyswitch")} == {
        "tfhe.api.decode": 2, "tfhe.api.upload": 6, "tfhe.api.circuit": 1,
        "tfhe.api.export": 1, "tfhe.keyswitch": 9}
    form = s.gate_api().eval_key.form
    assert count[f"tfhe.bootstrap.rotate B=1 form={form}"] == 8
    assert count[f"tfhe.bootstrap.rotate B=8 form={form}"] == 1


@pytest.mark.parametrize("blocks", [16, 1])
def test_rotate_span_names_k1_cluster(keyset, monkeypatch, blocks):
    """The rotate span carries ``C=<blocks a cluster>`` where K1's plan
    (``blind_rotate.cluster_blocks``; on the card, the narrow tier at small
    batches) takes a cluster, and keeps its label where it takes one block."""
    from eoc_tfhe_tpu_torch.core import bootstrap

    ek = config.FrameworkConfig(param_set="test").prepare_eval_key(keyset.cloud, P)
    assert ek.form == "ntt_kernel"
    seen = []
    monkeypatch.setattr(bootstrap, "cluster_blocks",
                        lambda acc0, ctx, params: seen.append(acc0.shape[0]) or blocks)
    cts = [gates.encrypt_bit(torch.Generator().manual_seed(i), torch.tensor([True, False]),
                             keyset.lwe_key, P) for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gates.nand(*cts, ek, P)
    rotate = [r[0] for r in _ranges(prof, "tfhe.bootstrap.rotate")]
    assert seen == [2] and rotate == ["tfhe.bootstrap.rotate B=2 form=ntt_kernel"
                                      + (f" C={blocks}" if blocks > 1 else "")]
