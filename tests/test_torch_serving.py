"""The port's batching gate server against the JAX package's.

Each case of ``tests/test_serving.py`` has a twin here: the same requests,
made by the JAX package under one keyset (the port's keygen at seed 3 and
``test_params()``, carried to the reference by ``tests/torch_reference.py``),
go to the reference's ``GateServer`` and to the port's, and the results must
be equal word for word (``current_variance`` to float32 rounding).  The port's server
runs on the CPU here (``device="cpu"``) over the default config's "ntt"
eval key, whose plain version stands in for kernel K1.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import gates as jgates
from eoc_tfhe_tpu.core.lwe import SeededLweCiphertext as JSeeded
from eoc_tfhe_tpu.core.params import test_params as make_test_params
from eoc_tfhe_tpu.serving import GateServer as JGateServer

from eoc_tfhe_tpu_torch import config
from eoc_tfhe_tpu_torch.core import gates, lwe, params
from eoc_tfhe_tpu_torch.kernels import build
from eoc_tfhe_tpu_torch.serving import GateServer

from torch_reference import keyset_pair, to_port

P = make_test_params()
CFG = config.FrameworkConfig(param_set="test")


@pytest.fixture(scope="module")
def setup():
    jk, tk = keyset_pair(P, 3)
    tek = CFG.prepare_eval_key(tk.cloud, P)
    assert tek.form == "ntt_kernel"
    return dict(jk=jk, tk=tk, jek=jboot.prepare_eval_key(jk.cloud), tek=tek)


def _enc(setup, bits, seed, seeded=False):
    fn = jgates.encrypt_bit_seeded if seeded else jgates.encrypt_bit
    return fn(jax.random.key(seed), jnp.asarray(bits), setup["jk"].lwe_key, P)


def _row(ct, i):
    """Request i of a JAX batch: (the reference's operand, the port's)."""
    if isinstance(ct, JSeeded):
        ref = JSeeded(*(np.asarray(x)[i] for x in (ct.seed, ct.b, ct.current_variance)))
    else:
        ref = jax.tree.map(lambda x: x[i], ct)
    return ref, to_port(ref)


def _serve(jsrv, tsrv, requests, flush=True):
    """Submit each (method, (kind, operands...)) request to both servers, each
    operand a (reference's, port's) pair; both servers' results."""
    jfuts, tfuts = [], []
    for method, (kind, *ops) in requests:
        jfuts.append(getattr(jsrv, method)(kind, *(r for r, _ in ops)))
        tfuts.append(getattr(tsrv, method)(kind, *(t for _, t in ops)))
    if flush:
        jsrv.flush()
        tsrv.flush()
    return ([f.result(timeout=300) for f in jfuts], [f.result(timeout=300) for f in tfuts])


def _assert_same(jouts, touts):
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        assert t.a.device.type == "cpu"
        np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
        np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))
        np.testing.assert_allclose(t.current_variance.numpy(),
                                   np.asarray(j.current_variance), rtol=1e-6)


def _bits(setup, outs):
    return np.asarray([gates.decrypt_bit(o, setup["tk"].lwe_key).numpy() for o in outs])


def test_batched_correctness_and_aggregation(setup):
    rng = np.random.default_rng(0)
    n_req = 12
    a = rng.integers(0, 2, n_req).astype(bool)
    b = rng.integers(0, 2, n_req).astype(bool)
    ca, cb = _enc(setup, a, 1), _enc(setup, b, 2)
    with JGateServer(setup["jek"], P, max_batch=16, max_delay_s=0.2) as jsrv, \
            GateServer(setup["tek"], P, max_batch=16, max_delay_s=0.2, device="cpu") as tsrv:
        jouts, touts = _serve(jsrv, tsrv, [("submit", ("nand", _row(ca, i), _row(cb, i)))
                                           for i in range(n_req)], flush=False)
    _assert_same(jouts, touts)
    np.testing.assert_array_equal(_bits(setup, touts), ~(a & b))
    assert tsrv.stats["gates"] == n_req and tsrv.stats["flushes"] <= 2
    assert tsrv.stats["padded_slots"] == 0 < jsrv.stats["padded_slots"]


def test_mixed_kinds_and_delay_flush(setup):
    a, b = np.array([0, 1], bool), np.array([1, 1], bool)
    ca, cb = _enc(setup, a, 4), _enc(setup, b, 5)
    jsrv = JGateServer(setup["jek"], P, max_batch=8, max_delay_s=0.01).start()
    tsrv = CFG.make_gate_server(setup["tek"], P, max_batch=8, max_delay_s=0.01,
                                device="cpu").start()
    try:
        # delay-based flush (no explicit flush call): each worker drains both
        jouts, touts = _serve(jsrv, tsrv, [
            ("submit", ("xor_", _row(ca, 0), _row(cb, 0))),
            ("submit", ("and_", _row(ca, 1), _row(cb, 1)))], flush=False)
    finally:
        jsrv.stop()
        tsrv.stop()
    _assert_same(jouts, touts)
    assert list(_bits(setup, touts)) == [a[0] ^ b[0], a[1] & b[1]]


def test_seeded_requests_match_plain(setup):
    rng = np.random.default_rng(7)
    n_req = 6
    a = rng.integers(0, 2, n_req).astype(bool)
    b = rng.integers(0, 2, n_req).astype(bool)
    sca, scb = _enc(setup, a, 11, seeded=True), _enc(setup, b, 12, seeded=True)
    with JGateServer(setup["jek"], P, max_batch=8, max_delay_s=0.2, pipeline_chunk=4) as jsrv, \
            GateServer(setup["tek"], P, max_batch=8, max_delay_s=0.2, pipeline_chunk=4,
                       device="cpu") as tsrv:      # more than one chunk
        jouts, touts = _serve(jsrv, tsrv, [("submit", ("nand", _row(sca, i), _row(scb, i)))
                                           for i in range(n_req)])
    _assert_same(jouts, touts)
    np.testing.assert_array_equal(_bits(setup, touts), ~(a & b))
    # the seeded uploads give the words of the same gate on the expanded masks
    expanded = [lwe.lwe_seeded_expand(to_port(c), P.n) for c in (sca, scb)]
    direct = gates.nand(*expanded, setup["tek"], P)
    assert torch.equal(lwe.lwe_stack(touts).b, direct.b)
    # mixed representations in one submit are refused
    ca = _enc(setup, a, 13)
    srv2 = GateServer(setup["tek"], P, device="cpu")
    with pytest.raises(ValueError, match="seeded"):
        srv2.submit("nand", _row(sca, 0)[1], _row(ca, 0)[1])
    srv2.stop()


def test_mux_three_operand_serving(setup):
    c = np.array([0, 1, 0, 1], bool)
    a = np.array([1, 1, 0, 0], bool)
    b = np.array([0, 0, 1, 1], bool)
    cc, ca, cb = _enc(setup, c, 21), _enc(setup, a, 22), _enc(setup, b, 23)
    with JGateServer(setup["jek"], P, max_batch=8, max_delay_s=0.2) as jsrv, \
            GateServer(setup["tek"], P, max_batch=8, max_delay_s=0.2, device="cpu") as tsrv:
        jouts, touts = _serve(jsrv, tsrv, [
            ("submit", ("mux", _row(cc, i), _row(ca, i), _row(cb, i))) for i in range(4)])
    _assert_same(jouts, touts)
    np.testing.assert_array_equal(_bits(setup, touts), np.where(c, a, b))
    srv2 = GateServer(setup["tek"], P, device="cpu")
    with pytest.raises(ValueError, match="three operands"):
        srv2.submit("mux", _row(cc, 0)[1], _row(ca, 0)[1])
    with pytest.raises(ValueError, match="two operands"):
        srv2.submit("nand", _row(cc, 0)[1], _row(ca, 0)[1], _row(cb, 0)[1])
    srv2.stop()


@pytest.mark.parametrize("kind", ["nand", "and_", "or_", "nor", "xor_", "xnor", "andny",
                                  "andyn", "orny", "oryn", "mux"])
def test_every_gate_kind_seeded_and_plain(setup, kind):
    """Every servable kind, from plain and from seeded uploads in one
    server, word for word the reference's."""
    rng = np.random.default_rng(40)
    nops = 3 if kind == "mux" else 2
    bits = [rng.integers(0, 2, 4).astype(bool) for _ in range(nops)]
    plain = [_enc(setup, x, 41 + o) for o, x in enumerate(bits)]
    seeded = [_enc(setup, x, 51 + o, seeded=True) for o, x in enumerate(bits)]
    requests = [("submit", (kind, *(_row(c, i) for c in cts)))
                for cts in (plain, seeded) for i in range(4)]
    with JGateServer(setup["jek"], P, max_batch=8, max_delay_s=0.2) as jsrv, \
            GateServer(setup["tek"], P, max_batch=8, max_delay_s=0.2, device="cpu") as tsrv:
        jouts, touts = _serve(jsrv, tsrv, requests)
    _assert_same(jouts, touts)
    ops = {"nand": lambda a, b: ~(a & b), "and_": lambda a, b: a & b,
           "or_": lambda a, b: a | b, "nor": lambda a, b: ~(a | b),
           "xor_": lambda a, b: a ^ b, "xnor": lambda a, b: ~(a ^ b),
           "andny": lambda a, b: ~a & b, "andyn": lambda a, b: a & ~b,
           "orny": lambda a, b: ~a | b, "oryn": lambda a, b: a | ~b,
           "mux": lambda c, a, b: np.where(c, a, b)}
    np.testing.assert_array_equal(_bits(setup, touts), np.tile(ops[kind](*bits), 2))
    assert tsrv.stats["gates"] == 8 and tsrv.stats["flushes"] == 2


@pytest.mark.parametrize("seeded", [(False, True, False), (True, False, True)],
                         ids=["reference_mix", "flipped_mix"])
def test_uint8_circuit_serving(setup, seeded):
    """The reference's case (add and mul plain, sub seeded) and its flip:
    each circuit is served from both upload forms."""
    vals_a, vals_b = [50, 200, 7], [8, 57, 9]

    def enc_u8(v, seed, seeded=False):
        ct = _enc(setup, np.array([(v >> i) & 1 for i in range(8)], bool), seed, seeded)
        return ct, to_port(ct)

    requests = [(op, enc_u8(a, s0 + i, rep), enc_u8(b, s0 + 10 + i, rep))
                for op, s0, rep in zip(("add", "sub", "mul"), (60, 80, 110), seeded)
                for i, (a, b) in enumerate(zip(vals_a, vals_b))]
    with JGateServer(setup["jek"], P, max_batch=8, max_delay_s=0.3) as jsrv, \
            GateServer(setup["tek"], P, max_batch=8, max_delay_s=0.3, device="cpu") as tsrv:
        jouts, touts = _serve(jsrv, tsrv, [("submit_uint8", (op, a, b))
                                           for op, a, b in requests])
    _assert_same(jouts, touts)
    got = [int(sum(int(x) << i for i, x in enumerate(bits))) for bits in _bits(setup, touts)]
    assert got == [(a + b) % 256 for a, b in zip(vals_a, vals_b)] + \
        [(a - b) % 256 for a, b in zip(vals_a, vals_b)] + \
        [(a * b) % 256 for a, b in zip(vals_a, vals_b)]
    assert tsrv.stats["flushes"] <= 3
    srv2 = GateServer(setup["tek"], P, device="cpu")
    one = enc_u8(1, 99)[1]
    with pytest.raises(ValueError, match=r"\(8,\)-batch"):
        srv2.submit_uint8("add", lwe.lwe_index(one, 0), lwe.lwe_index(one, 1))
    with pytest.raises(ValueError, match="unknown uint8 op"):
        srv2.submit_uint8("div", one, one)
    with pytest.raises(ValueError, match="both be seeded or both plain"):
        srv2.submit_uint8("add", one, enc_u8(1, 98, True)[1])
    srv2.stop()


def test_errors_and_validation(setup):
    ca = _enc(setup, np.array([1], bool), 6)
    ref, one = _row(ca, 0)
    batched = to_port(ca)
    jsrv, srv = JGateServer(setup["jek"], P), GateServer(setup["tek"], P, device="cpu")
    for s, op, many in ((jsrv, ref, ca), (srv, one, batched)):
        with pytest.raises(ValueError, match="unknown gate kind"):
            s.submit("nandy", op, op)
        with pytest.raises(ValueError, match="single"):
            s.submit("nand", many, many)
        s.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            s.submit("nand", op, op)


# --- the port's own surface ------------------------------------------------------

def test_server_defaults_to_the_card_and_checks_its_arguments(setup, monkeypatch):
    ek = setup["tek"]
    with pytest.raises(ValueError, match="rotation impl 'warp'"):
        GateServer(ek, P, rotation_impl="warp", device="cpu")
    with pytest.raises(ValueError, match="eval key lives on cpu"):
        GateServer(ek, P, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GateServer(ek, P)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CFG.make_gate_server(ek, P)


def test_make_gate_server_takes_the_config_policy_and_overrides(setup):
    cfg = config.FrameworkConfig(param_set="test", rotation_impl="gather", serving_max_batch=64,
                                 serving_max_delay_s=0.25, serving_pipeline_chunk=32)
    srv = cfg.make_gate_server(setup["tek"], device="cpu")
    assert (srv.max_batch, srv.max_delay_s, srv.pipeline_chunk, srv.rotation_impl) == \
        (64, 0.25, 32, "gather")
    assert srv.params == params.test_params() and srv.device == torch.device("cpu")
    srv = cfg.make_gate_server(setup["tek"], P, pipeline_chunk=2048, max_batch=8,
                               device="cpu")
    assert (srv.max_batch, srv.pipeline_chunk) == (8, 2048)
    default = config.DEFAULT_CONFIG
    assert (default.serving_max_batch, default.serving_max_delay_s,
            default.serving_pipeline_chunk, default.batch_size) == (2048, 0.005, 128, 8192)


def test_concurrent_clients_and_flushes(setup):
    """Eight client threads and flushes from the main thread race the worker
    (switch interval shortened); every request is answered once, with the
    words of one direct call on the stacked inputs."""
    rng = np.random.default_rng(5)
    R, clients = 64, 8
    a = rng.integers(0, 2, R).astype(bool)
    b = rng.integers(0, 2, R).astype(bool)
    ca, cb = _enc(setup, a, 31), _enc(setup, b, 32)
    reqs = [(_row(ca, i)[1], _row(cb, i)[1]) for i in range(R)]
    futs = [None] * R
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with GateServer(setup["tek"], P, max_batch=16, max_delay_s=0.001, pipeline_chunk=5,
                        device="cpu") as srv:
            def client(t):
                for i in range(t, R, clients):
                    futs[i] = srv.submit("nand", *reqs[i])
                    time.sleep(0)
            threads = [threading.Thread(target=client, args=(t,)) for t in range(clients)]
            for th in threads:
                th.start()
            srv.flush()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
            outs = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
    assert srv.stats["gates"] == R
    direct = gates.nand(to_port(ca), to_port(cb), setup["tek"], P)
    got = lwe.lwe_stack(outs)
    assert torch.equal(got.a, direct.a) and torch.equal(got.b, direct.b)
    np.testing.assert_array_equal(_bits(setup, outs), ~(a & b))


def test_build_load_builds_once_under_concurrent_first_use(tmp_path, monkeypatch):
    """The lock around ``kernels.build.load``: eight threads that load one
    kernel for the first time at once start one build and share one library
    (the compiler and the loader are stand-ins here)."""
    name = "blind_rotate_compact"
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    builds = []

    def fake_build_all():
        builds.append(threading.get_ident())
        time.sleep(0.05)                 # long enough for every thread to miss the cache
        build._target(name).write_bytes(b"")
        return {}

    class FakeLib:
        def __init__(self, path):
            self.path = path
            setattr(self, build.SIGNATURES[name][0], lambda *a: 0)
            self.kernel_error_string = lambda *a: b""

    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    build._load.cache_clear()
    barrier, libs = threading.Barrier(8), []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def first_use():
        barrier.wait()
        libs.append(build.load(name))
    threads = [threading.Thread(target=first_use) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        build._load.cache_clear()       # later loads use the package's build dir
    assert len(builds) == 1 and len(libs) == 8
    assert all(lib is libs[0] for lib in libs)


def test_keyswitch_tf32_switch_is_atomic_across_threads(setup):
    """The keyswitch's product turns TF32 off around itself through torch's
    process-wide flag; eight threads keyswitching at once must leave a
    caller's setting as they found it."""
    from eoc_tfhe_tpu_torch.ops import keyswitch
    ek = setup["tek"]
    ext = lwe.LweCiphertext(a=torch.randint(-2**31, 2**31, (4, P.k * P.N), dtype=torch.int64)
                            .to(torch.int32), b=torch.zeros(4, dtype=torch.int32),
                            current_variance=torch.zeros(4))
    want = keyswitch.keyswitch_apply(ext, ek.ks, t=P.ks.t, basebit=P.ks.basebit,
                                     prepared=ek.ks_prepared)
    outs, old_flag, old_interval = [], torch.backends.cuda.matmul.allow_tf32, \
        sys.getswitchinterval()
    torch.backends.cuda.matmul.allow_tf32 = True
    sys.setswitchinterval(1e-6)

    def worker():
        for _ in range(20):
            outs.append(keyswitch.keyswitch_apply(ext, ek.ks, t=P.ks.t, basebit=P.ks.basebit,
                                                  prepared=ek.ks_prepared))
    threads = [threading.Thread(target=worker) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        sys.setswitchinterval(old_interval)
        torch.backends.cuda.matmul.allow_tf32 = old_flag
    assert len(outs) == 160 and all(torch.equal(o.b, want.b) for o in outs)
