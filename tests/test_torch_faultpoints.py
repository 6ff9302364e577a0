"""The repo's faultpoint lint (``scripts/check_faultpoints.py``: its
call-site regexes, the docs' faultpoint and flight-event catalogs and the
JAX package's ``KNOWN_KNOBS``, imported, not copied) applied to
``dmlc_tpu_torch/**/*.py``: the port plants no undocumented faultpoint
site, flight-recorder kind or ``DMLC_TPU_*`` name. Then the metric
parity: every metric name the JAX package registers, the port registers
too."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "dmlc_tpu_torch"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lint():
    """The lint, walking the port: its own ``flight.py`` defines the
    hook and ``resilience/faults.py`` the faultpoint, as in the JAX
    package."""
    mod = _load("check_faultpoints")
    mod._walk = lambda: sorted(PORT.glob("**/*.py"))
    mod.FLIGHT = PORT / "obs" / "flight.py"
    return mod


def test_the_lint_sees_the_ports_sites(lint):
    sites = lint.planted_sites()
    assert {"device.feed", "service.worker_crash", "io.read"} <= set(sites)
    assert all(p.startswith("dmlc_tpu_torch/") for ps in sites.values()
               for p in ps)
    assert len(lint.referenced_knobs()) >= 40


def test_every_faultpoint_site_is_documented(lint):
    sites = lint.planted_sites()
    bad = [s for s in sites if not lint.SITE_GRAMMAR_RE.match(s)]
    assert bad == []
    undocumented = sorted(set(sites) - lint.documented_sites())
    assert undocumented == [], {s: sites[s] for s in undocumented}


def test_every_flight_kind_is_documented(lint):
    kinds = lint.planted_flight_events()
    assert kinds, "the port plants flight-recorder events"
    undocumented = sorted(set(kinds) - lint.documented_flight_events())
    assert undocumented == [], {k: kinds[k] for k in undocumented}


def test_every_env_name_is_a_known_knob(lint):
    knobs = lint.referenced_knobs()
    unknown = sorted(set(knobs) - lint.known_knobs())
    assert unknown == [], {k: knobs[k] for k in unknown}


# every reference module that registers a metric is ported, the status
# plane and its two HTTP readers included
NOT_PORTED = ()


def _registered(pkg, skip=()):
    call_re = _load("check_metric_names").CALL_RE
    out = {}
    for path in sorted((ROOT / pkg).glob("**/*.py")):
        rel = str(path.relative_to(ROOT / pkg))
        if rel in skip:
            continue
        for _kind, name in call_re.findall(path.read_text()):
            out.setdefault(name, []).append(rel)
    return out


def test_the_port_registers_every_reference_metric():
    ref = _registered("dmlc_tpu", NOT_PORTED)
    port = _registered("dmlc_tpu_torch")
    assert len(ref) >= 60
    missing = sorted(set(ref) - set(port))
    assert missing == [], {n: ref[n] for n in missing}


def test_heartbeats_and_straggler_recoveries_count():
    """The tracker counts every heartbeat, and a flagged straggler that
    reports again once, as the JAX package's does."""
    from dmlc_tpu_torch import obs
    from dmlc_tpu_torch.tracker.rendezvous import RabitTracker

    reg = obs.registry()
    beats = reg.counter("dmlc_tracker_heartbeats_total")
    recov = reg.counter("dmlc_tracker_straggler_recoveries_total")
    b0, r0 = beats.value, recov.value
    tracker = RabitTracker("127.0.0.1", 2, port=21800, port_end=21850)
    try:
        tracker.heartbeat_gap = -1.0  # every other rank is stale
        tracker._note_heartbeat(0, "a")
        tracker._note_heartbeat(1, "b")  # flags rank 0
        tracker._note_heartbeat(0, "c")  # rank 0 recovers
        tracker._note_heartbeat(0, "d")
    finally:
        tracker.sock.close()
    assert beats.value - b0 == 4
    assert recov.value - r0 == 1


def test_reshards_count_in_the_registry(tmp_path):
    from dmlc_tpu_torch import obs
    from dmlc_tpu_torch.data import reshard_count, reshard_split
    from dmlc_tpu_torch.io import create_input_split

    path = tmp_path / "d.txt"
    path.write_bytes(b"".join(b"row-%d\n" % i for i in range(10)))
    counter = obs.registry().counter("dmlc_data_reshards_total")
    before, before_count = counter.value, reshard_count()
    split = create_input_split(str(path), 0, 2, "text")
    try:
        reshard_split(split, rank=1, world=3)
    finally:
        split.close()
    assert counter.value - before == 1
    assert reshard_count() - before_count == 1
