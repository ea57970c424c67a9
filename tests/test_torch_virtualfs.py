"""The port's VirtualFS (the WeaveDrive analog) against the reference's, case
for case with tests/test_virtualfs.py: each scenario runs on both modules
and must give the same reads, backend calls, gateway queries and errors."""

import numpy as np
import pytest

from eoc_tfhe_tpu.io import virtualfs as ref
from eoc_tfhe_tpu_torch.io import virtualfs as port

SCHED = "TEST_SCHED_ADDR"


def _tags(**kv):
    return [{"name": k.replace("_", "-"), "value": v} for k, v in kv.items()]


def _spawn(avail=None, ext=True):
    t = _tags(Scheduler=SCHED)
    if ext:
        t += _tags(Extension="WeaveDrive")
    if avail:
        t += _tags(Availability_Type=avail)
    return t


def _attempt(fn):
    """fn's result, or its exception's type name and message."""
    try:
        return fn()
    except Exception as exc:  # compared between the two modules
        return (type(exc).__name__, str(exc))


def both(scenario, *args):
    """Run the scenario on the port's module and the reference's; their
    observations must be equal.  Returns the port's."""
    got, want = scenario(port, *args), scenario(ref, *args)
    assert got == want
    return got


def test_virtualfs_roundtrip(tmp_path):
    data = np.random.default_rng(0).integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    (tmp_path / "blob.bin").write_bytes(data)

    def scenario(m):
        fs = m.VirtualFS(m.LocalBackend(str(tmp_path)), read_ahead=1024)
        fd = fs.open("blob.bin")
        obs = [fd, fs.read(fd, 10), fs.read(fd, 5000)]
        fs.seek(fd, 99_990)
        obs += [fs.read(fd, 100), fs.read(fd, 10)]
        fs.close(fd)
        return obs + [fs.read_all("blob.bin")]

    fd, a, b, tail, empty, whole = both(scenario)
    assert (a, b) == (data[:10], data[10:5010])
    assert tail == data[99_990:] and empty == b"" and whole == data


def test_virtualfs_counts_backend_calls(tmp_path):
    (tmp_path / "x").write_bytes(bytes(range(256)) * 100)

    def scenario(m):
        calls = []
        backend = m.LocalBackend(str(tmp_path))
        orig = backend.read_range
        backend.read_range = lambda i, s, e: (calls.append((s, e)), orig(i, s, e))[1]
        fs = m.VirtualFS(backend, read_ahead=4096)
        fd = fs.open("x")
        reads = b"".join(fs.read(fd, 64) for _ in range(64))
        return reads, calls

    reads, calls = both(scenario)
    assert reads == (bytes(range(256)) * 100)[:4096] and calls == [(0, 4096)]


def test_admissibility_test_mode_bypass():
    assert both(lambda m: m.Admissibility(gateway=None, mode="test").check("anything")) is True


def test_admissibility_requires_extension_tag():
    def scenario(m):
        gw = m.InProcessGateway()
        adm = m.Admissibility(gateway=gw, block_height=100, spawn_tags=_spawn(ext=False))
        obs = [adm.check("item1"), list(gw.queries)]
        adm2 = m.Admissibility(gateway=gw, block_height=100,
                               module_tags=_tags(Extension="WeaveDrive"),
                               spawn_tags=_tags(Scheduler=SCHED))
        return obs + [adm2.check("item1"), list(gw.queries)]

    first, q0, second, q1 = both(scenario)
    assert first is False and q0 == [] and second is False and len(q1) == 1


def test_admissibility_assignments_attestation():
    def scenario(m):
        gw = m.InProcessGateway()
        gw.add_transaction(SCHED, 50, {"Data-Protocol": "ao", "Type": "Attestation",
                                       "Message": "m1"})
        gw.add_transaction(SCHED, 500, {"Data-Protocol": "ao", "Type": "Attestation",
                                        "Message": "m2"})
        gw.add_transaction("other", 50, {"Data-Protocol": "ao", "Type": "Attestation",
                                         "Message": "m3"})
        adm = m.Admissibility(gateway=gw, block_height=100, spawn_tags=_spawn())
        return [adm.check(i) for i in ("m1", "m2", "m3", "m4")], gw.queries

    checks, queries = both(scenario)
    assert checks == [True, False, False, False]
    assert all(q.lstrip().startswith("query") and "transactions(" in q for q in queries)


def test_admissibility_individual_mode():
    def scenario(m):
        gw = m.InProcessGateway()
        gw.add_transaction(SCHED, 10, {"Data-Protocol": "WeaveDrive", "Type": "Available",
                                       "ID": "solo"})
        module_tags = _tags(Availability_Type="Assignments")
        adm = m.Admissibility(gateway=gw, block_height=100, module_tags=module_tags,
                              spawn_tags=_spawn(avail="Individual"))
        obs = [adm.check("solo"), len(gw.queries)]
        adm2 = m.Admissibility(gateway=gw, block_height=100, module_tags=module_tags,
                               spawn_tags=_spawn())
        return obs + [adm2.check("solo"), list(gw.queries)]

    first, n, second, _queries = both(scenario)
    assert (first, n, second) == (True, 2, False)


def test_admissibility_library_and_invalid_modes():
    def scenario(m):
        gw = m.InProcessGateway()
        return [_attempt(lambda: m.Admissibility(gateway=gw, block_height=100,
                                                 spawn_tags=_spawn(avail=mode)).check("x"))
                for mode in ("Library", "Sometimes")]

    library, invalid = both(scenario)
    assert library[0] == "NotImplementedError" and "Library" in library[1]
    assert invalid == ("ValueError", "Unsupported WeaveDrive mode: Sometimes")


def test_virtualfs_open_gated_by_admissibility(tmp_path):
    (tmp_path / "ok").write_bytes(b"payload")
    (tmp_path / "nope").write_bytes(b"secret")

    def scenario(m):
        gw = m.InProcessGateway()
        gw.add_transaction(SCHED, 10, {"Data-Protocol": "ao", "Type": "Attestation",
                                       "Message": "ok"})
        adm = m.Admissibility(gateway=gw, block_height=100, spawn_tags=_spawn())
        fs = m.VirtualFS(m.LocalBackend(str(tmp_path)), admissibility=adm)
        return fs.read_all("ok"), _attempt(lambda: fs.open("nope"))

    payload, refused = both(scenario)
    assert payload == b"payload"
    assert refused == ("PermissionError", "WeaveDrive: item id is not admissible: nope")


@pytest.mark.parametrize("tags", [
    [{"name": "Extension", "value": "WeaveDrive"}, {"key": "Extension", "value": "Other"}],
    [], None])
def test_get_tag_values_accepts_both_shapes(tags):
    got = both(lambda m: m.get_tag_values("Extension", tags))
    assert got == (["WeaveDrive", "Other"] if tags else [])
