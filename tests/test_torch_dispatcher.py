"""The port's data-service control plane (``dmlc_tpu_torch/data/
dispatcher.py``) on the CPU: the cases of the JAX package's
``tests/test_dispatcher.py`` run on the port (the lease table's
exactly-once state machine, worker liveness, requeues, jobs, fair share,
quotas, drains, cache-aware grants, the CLIs), then the port held against
the JAX package: the wire both ways, a worker crash mid-epoch, the fleet
on the card's device rule, and ``/data`` through the status plane
(``dispatch --status-port``, the port's plane against the JAX package's).
Every socket binds port 0.
"""

import json
import time

import numpy as np
import pytest

from dmlc_tpu_torch import resilience
from dmlc_tpu_torch.data import BlockService, DataDispatcher, RemoteBlockParser
from dmlc_tpu_torch.data.dispatcher import DispatcherClient, dispatcher_address
from dmlc_tpu_torch.obs import audit as audit_mod

ROWS = 40


@pytest.fixture(autouse=True)
def _clean_faults():
    resilience.reset()
    yield
    resilience.reset()


@pytest.fixture()
def svm_file(tmp_path):
    path = tmp_path / "d.svm"
    with open(path, "w") as fh:
        for i in range(ROWS):
            fh.write(f"{i % 3} 1:{i} 2:{2 * i}\n")
    return str(path)


class TestLeaseTable:
    def test_lease_lifecycle_exactly_once(self, svm_file):
        """queued -> leased -> delivered -> acked by hand over the RPC
        surface; EOF once nothing is queued, join() once all acked."""
        with DataDispatcher(svm_file, nchunks=4) as d:
            cli = DispatcherClient(d.address)
            wid = cli.call({"op": "register",
                            "addr": ("127.0.0.1", 1)})["worker_id"]
            cid = cli.call({"op": "client"})["client_id"]
            seqs = []
            for _ in range(4):
                chunk = cli.call({"op": "lease", "worker": wid})["chunk"]
                seqs.append(chunk["seq"])
                assert chunk["uri"] == svm_file and chunk["nparts"] == 4
                assert cli.call({"op": "recv", "client": cid,
                                 "seq": chunk["seq"]})["ok"]
            assert seqs == [0, 1, 2, 3]  # lowest-seq-first determinism
            # all delivered, none acked: lease says EOF (an explicit-ack
            # consumer may hold rows arbitrarily long), join() does not
            assert cli.call({"op": "lease", "worker": wid}).get("eof")
            assert not d.join(timeout=0.05)
            for seq in seqs:
                assert cli.call({"op": "ack", "client": cid,
                                 "seq": seq})["ok"]
            assert d.join(timeout=5)
            snap = d.snapshot()
            assert snap["chunks"] == {"total": 4, "queued": 0, "leased": 0,
                                      "delivered": 0, "acked": 4}
            assert snap["requeued"] == 0 and snap["rejects"] == 0
            cli.close()

    def test_lease_expiry_requeues_to_next_worker(self, svm_file):
        """A worker that overruns its lease loses the chunk: the next
        lease hands the SAME seq to whoever asks, requeues is counted."""
        with DataDispatcher(svm_file, nchunks=1, lease_s=0.1) as d:
            cli = DispatcherClient(d.address)
            w0 = cli.call({"op": "register",
                           "addr": ("127.0.0.1", 1)})["worker_id"]
            w1 = cli.call({"op": "register",
                           "addr": ("127.0.0.1", 2)})["worker_id"]
            first = cli.call({"op": "lease", "worker": w0})["chunk"]
            time.sleep(0.25)  # let the lease expire
            again = cli.call({"op": "lease", "worker": w1})["chunk"]
            assert again["seq"] == first["seq"]
            assert again["flow"] == first["flow"]  # one flow per chunk,
            # carried through the reassignment (the trace spans workers)
            snap = d.snapshot()
            assert snap["requeued"] == 1
            assert snap["lease_table"][0]["requeues"] == 1
            assert snap["lease_table"][0]["worker"] == w1
            cli.close()

    def test_duplicate_delivery_rejected(self, svm_file):
        """Two consumers reporting the same seq: first reporter wins,
        the second is told to drop its copy (exactly-once)."""
        with DataDispatcher(svm_file, nchunks=1) as d:
            cli = DispatcherClient(d.address)
            wid = cli.call({"op": "register",
                            "addr": ("127.0.0.1", 1)})["worker_id"]
            c0 = cli.call({"op": "client"})["client_id"]
            c1 = cli.call({"op": "client"})["client_id"]
            seq = cli.call({"op": "lease",
                            "worker": wid})["chunk"]["seq"]
            assert not cli.call({"op": "recv", "client": c0,
                                 "seq": seq}).get("reject")
            # same consumer re-reporting (a hedged fetch) is fine...
            assert not cli.call({"op": "recv", "client": c0,
                                 "seq": seq}).get("reject")
            # ...a different consumer is not
            assert cli.call({"op": "recv", "client": c1,
                             "seq": seq}).get("reject")
            snap = d.snapshot()
            assert snap["rejects"] == 1
            # an ack after the fact is authoritative, a second is dup
            assert cli.call({"op": "ack", "client": c0, "seq": seq})["ok"]
            assert cli.call({"op": "ack", "client": c1,
                             "seq": seq}).get("dup")
            assert d.snapshot()["duplicate_acks"] == 1
            cli.close()

    def test_dead_worker_chunks_requeue_and_registration_revoked(
            self, svm_file):
        """Heartbeat silence past dead_after_s: the worker's leases
        requeue, it drops out of the `workers` list, and a zombie lease
        attempt is refused."""
        with DataDispatcher(svm_file, nchunks=2, lease_s=30.0,
                            dead_after_s=0.2) as d:
            cli = DispatcherClient(d.address)
            w0 = cli.call({"op": "register",
                           "addr": ("127.0.0.1", 1)})["worker_id"]
            reply = cli.call({"op": "register", "addr": ("127.0.0.1", 2)})
            w1 = reply["worker_id"]
            assert reply["heartbeat_s"] < d.dead_after_s
            cli.call({"op": "lease", "worker": w0})
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                time.sleep(0.1)
                # w1 heartbeats (each beat runs the expiry scan); w0 is
                # silent and crosses the death threshold
                cli.call({"op": "heartbeat", "worker": w1})
                if d.snapshot()["requeued"]:
                    break
            snap = d.snapshot()
            assert snap["requeued"] == 1
            assert snap["workers"][str(w0)]["live"] is False
            assert snap["workers"][str(w1)]["live"] is True
            live = cli.call({"op": "workers"})["workers"]
            assert [w[2] for w in live] == [w1]
            assert cli.call({"op": "lease", "worker": w0}).get("dead")
            cli.close()

    def test_delivered_chunk_survives_lease_expiry_while_holder_lives(
            self, svm_file):
        """A DELIVERED chunk past its deadline must NOT requeue while the
        holding client's dispatcher session is alive: the consumer
        already has the rows (it may sit in a minutes-long jit compile
        before acking), and redelivery would serve them twice. Once the
        holder disconnects, the deadline applies and the chunk requeues."""
        with DataDispatcher(svm_file, nchunks=1, lease_s=0.1) as d:
            holder = DispatcherClient(d.address)
            aux = DispatcherClient(d.address)  # stats-only: never binds a
            # client id, so it must not keep the chunk alive
            wid = holder.call({"op": "register",
                               "addr": ("127.0.0.1", 1)})["worker_id"]
            cid = holder.call({"op": "client"})["client_id"]
            seq = holder.call({"op": "lease", "worker": wid})["chunk"]["seq"]
            assert not holder.call({"op": "recv", "client": cid,
                                    "seq": seq}).get("reject")
            time.sleep(0.3)  # well past lease_s
            snap = aux.call({"op": "stats"})  # stats runs the expiry scan
            assert snap["chunks"]["delivered"] == 1
            assert snap["requeued"] == 0
            holder.close()  # the holder crashes: its session drops
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                snap = aux.call({"op": "stats"})
                if snap["requeued"]:
                    break
                time.sleep(0.05)
            assert snap["requeued"] == 1
            assert snap["chunks"]["queued"] == 1
            aux.close()

    def test_register_retry_is_idempotent_by_addr(self, svm_file):
        """register rides the retrying DispatcherClient: a re-sent
        register (lost reply) must return the SAME worker id, not mint
        an orphan that never heartbeats and later fires worker_dead."""
        with DataDispatcher(svm_file, nchunks=1) as d:
            cli = DispatcherClient(d.address)
            first = cli.call({"op": "register", "addr": ("127.0.0.1", 77)})
            again = cli.call({"op": "register", "addr": ("127.0.0.1", 77)})
            assert again["worker_id"] == first["worker_id"]
            other = cli.call({"op": "register", "addr": ("127.0.0.1", 78)})
            assert other["worker_id"] != first["worker_id"]
            snap = d.snapshot()
            assert len(snap["workers"]) == 2
            assert all(w["live"] for w in snap["workers"].values())
            cli.close()

    def test_finished_connections_are_pruned(self, svm_file):
        """Closed peer connections must not accumulate in the
        dispatcher's bookkeeping for the life of the epoch (fault storms
        reconnect DispatcherClients many times)."""
        with DataDispatcher(svm_file, nchunks=1) as d:
            for _ in range(5):
                cli = DispatcherClient(d.address)
                assert cli.call({"op": "stats"})["ok"]
                cli.close()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and (
                    d._conns or any(t.is_alive() for t in d._threads)):
                time.sleep(0.05)
            assert not d._conns
            assert not any(t.is_alive() for t in d._threads)

    def test_unknown_op_and_unknown_seq_are_errors_not_crashes(
            self, svm_file):
        with DataDispatcher(svm_file, nchunks=1) as d:
            cli = DispatcherClient(d.address)
            assert not cli.call({"op": "frobnicate"})["ok"]
            assert not cli.call({"op": "ack", "client": 0, "seq": 99})["ok"]
            # the connection survives error replies
            assert cli.call({"op": "stats"})["ok"]
            cli.close()

    def test_dispatcher_address_forms(self):
        assert dispatcher_address("10.0.0.1:9000") == ("10.0.0.1", 9000)
        assert dispatcher_address(("h", 1)) == ("h", 1)
        from dmlc_tpu_torch.utils.logging import DMLCError

        with pytest.raises(DMLCError):
            dispatcher_address("no-port-here")


class TestFleetIntegration:
    def test_device_feed_explicit_ack_drains_lease_table(self, svm_file):
        """DeviceFeed over a dispatcher-mode RemoteBlockParser switches
        the parser to explicit acks and acks every chunk as its batches
        are consumed: end of epoch, the lease table is fully acked."""
        from dmlc_tpu_torch.device import BatchSpec, DeviceFeed

        spec = BatchSpec(batch_size=8, layout="dense", num_features=3)
        with DataDispatcher(svm_file, nchunks=4) as d:
            with BlockService(dispatcher=d.address, nthread=1, device="cpu"):
                parser = RemoteBlockParser(d.address, dispatcher=True, device="cpu")
                feed = DeviceFeed(parser, spec, device="cpu")
                rows = sum(np.asarray(b["x"]).shape[0] for b in feed)
                feed.close()
                assert rows == ROWS
                assert d.join(timeout=10), d.snapshot()
            snap = d.snapshot()
        assert snap["chunks"]["acked"] == snap["chunks"]["total"] == 4
        assert snap["rejects"] == 0

    def test_slow_explicit_ack_consumer_never_served_twice(self, svm_file):
        """An explicit-ack consumer (the DeviceFeed shape) holds every
        delivered chunk far past its lease before acking. With its
        dispatcher session alive the whole time, nothing may requeue and
        nothing may arrive twice — the exactly-once guarantee the lease
        deadline must not break for slow-but-live consumers."""
        with DataDispatcher(svm_file, nchunks=4, lease_s=0.2) as d:
            with BlockService(dispatcher=d.address, nthread=1, device="cpu"):
                parser = RemoteBlockParser(d.address, dispatcher=True, device="cpu")
                parser.set_explicit_ack()
                blocks = []
                while True:
                    b = parser.next_block()
                    if b is None:
                        break
                    blocks.append(b)
                time.sleep(0.6)  # hold all chunks well past lease_s
                for b in blocks:
                    parser.ack(b.seq_id)
                parser.close()
                assert d.join(timeout=10), d.snapshot()
            snap = d.snapshot()
        vals = sorted(v for b in blocks
                      for v in np.asarray(b.value)[::2].tolist())
        assert vals == [float(i) for i in range(ROWS)]
        assert len(blocks) == 4  # one delivery per chunk, no duplicates
        assert snap["requeued"] == 0 and snap["rejects"] == 0
        assert snap["chunks"]["acked"] == 4

    def test_client_drops_duplicate_seq_redelivery(self):
        """Unit pin on the consumer half of exactly-once: a seq this
        client already accepted (a lease requeued while its dispatcher
        session blinked, then re-served to it) is receipt-reported —
        re-marking the lease table delivered-to-us — but the duplicate
        copy is dropped, never surfaced as a second block."""
        from dmlc_tpu_torch import obs

        p = RemoteBlockParser.__new__(RemoteBlockParser)
        p._ended = False
        p._closed = False
        p._inflight = False
        p._explicit_ack = True
        p._unacked = []
        p._seen = set()
        p._audit = audit_mod.NOOP_AUDITOR
        p._audit_digests = None
        p._m_redelivery = None
        p.bytes_read = 0
        p._m_read = obs.registry().counter(
            "dmlc_io_read_bytes_total", "payload bytes ingested by source",
            source="service")
        calls = []

        class _Dispatch:
            def call(self, obj, site="service.dispatch"):
                calls.append(dict(obj))
                return {"ok": True}

        p._dispatch = _Dispatch()
        p._client_id = 0
        p._jid = 0

        def frame():
            return {
                "seq": np.asarray([0], dtype=np.int64),
                "offset": np.asarray([0, 1], dtype=np.int64),
                "label": np.asarray([1.0]),
                "index": np.asarray([1], dtype=np.int64),
                "value": np.asarray([2.0]),
            }

        frames = [frame(), frame(), None]
        p._fetch_arrays = lambda: frames.pop(0)
        first = p.next_block()
        assert first is not None and first.seq_id == 0
        assert p.next_block() is None  # the duplicate is skipped, EOS
        assert p._unacked == [0]  # consumed once, owed exactly one ack
        assert [c["op"] for c in calls] == ["recv", "recv"]

    def _audit_parser(self, fresh_reg):
        """A RemoteBlockParser wired like the dispatcher path, with a
        live auditor and the redelivery digest map armed."""
        from dmlc_tpu_torch import obs

        p = RemoteBlockParser.__new__(RemoteBlockParser)
        p._ended = False
        p._closed = False
        p._inflight = False
        p._explicit_ack = True
        p._unacked = []
        p._seen = set()
        p._audit = audit_mod.Auditor(reg=fresh_reg, mode="full", rank=0)
        p._audit_digests = {}
        p._m_redelivery = fresh_reg.counter(
            "dmlc_audit_redelivery_checked_total",
            "redelivered chunks digest-checked against first delivery")
        p.bytes_read = 0
        p._m_read = obs.registry().counter(
            "dmlc_io_read_bytes_total", "payload bytes ingested by source",
            source="service")

        class _Dispatch:
            def call(self, obj, site="service.dispatch"):
                return {"ok": True}

        p._dispatch = _Dispatch()
        p._client_id = 0
        p._jid = 0
        return p

    @staticmethod
    def _frame(seq=0, label=1.0, flow=7):
        return {
            "seq": np.asarray([seq], dtype=np.int64),
            "flow": np.asarray([flow], dtype=np.int64),
            "offset": np.asarray([0, 1], dtype=np.int64),
            "label": np.asarray([label]),
            "index": np.asarray([1], dtype=np.int64),
            "value": np.asarray([2.0]),
        }

    def test_redelivered_chunk_digest_checked(self):
        """Audit satellite pin: a requeued redelivery must produce the
        same content digest as the first delivery — the duplicate is
        digest-compared (counter bumps) and a byte-identical copy raises
        nothing. The server-minted flow id legitimately differs between
        deliveries and must not fork the digest."""
        from dmlc_tpu_torch.obs.metrics import Registry

        reg = Registry()
        p = self._audit_parser(reg)
        # identical rows, different flow ids (a requeue re-sends with a
        # fresh flow)
        frames = [self._frame(flow=7), self._frame(flow=8), None]
        p._fetch_arrays = lambda: frames.pop(0)
        assert p.next_block() is not None
        assert p.next_block() is None  # duplicate dropped, EOS
        assert p._m_redelivery.value == 1
        assert reg.counter(
            "dmlc_audit_divergences_total",
            "digest-chain forks detected by the audit plane",
            stage="redelivery").value == 0

    def test_redelivered_chunk_content_fork_flagged(self, tmp_path,
                                                    monkeypatch):
        """The negative half: a redelivery whose rows differ from the
        first delivery is a divergence — counted, and the replay bundle
        lands beside the flight recorder dump."""
        from dmlc_tpu_torch.obs.metrics import Registry

        monkeypatch.chdir(tmp_path)  # bundle path falls back to cwd
        reg = Registry()
        p = self._audit_parser(reg)
        frames = [self._frame(label=1.0), self._frame(label=2.0), None]
        p._fetch_arrays = lambda: frames.pop(0)
        assert p.next_block() is not None
        assert p.next_block() is None
        assert p._m_redelivery.value == 1
        assert reg.counter(
            "dmlc_audit_divergences_total",
            "digest-chain forks detected by the audit plane",
            stage="redelivery").value == 1
        bundle = json.load(open(tmp_path / "audit-rank0.json"))
        div = bundle["divergence"]
        assert div["stage"] == "redelivery" and div["seq"] == 0
        assert div["ours"] != div["theirs"]

    def test_two_workers_share_one_epoch(self, svm_file):
        """Both registered workers take leases; the consumer sees every
        row exactly once across the fleet."""
        with DataDispatcher(svm_file, nchunks=8) as d:
            with BlockService(dispatcher=d.address, nthread=1, device="cpu"), \
                    BlockService(dispatcher=d.address, nthread=1, device="cpu"):
                parser = RemoteBlockParser(d.address, dispatcher=True, device="cpu")
                vals = []
                for block in parser:
                    vals.extend(np.asarray(block.value)[::2].tolist())
                parser.close()
                assert d.join(timeout=10), d.snapshot()
            snap = d.snapshot()
        assert sorted(vals) == [float(i) for i in range(ROWS)]
        assert snap["chunks"]["acked"] == 8
        # both workers served at least one chunk each epoch is not
        # guaranteed (one can win every race), but both must be live
        assert all(w["live"] for w in snap["workers"].values())


def test_dispatch_cli_end_to_end(svm_file):
    """python -m dmlc_tpu_torch.tools dispatch + serve --dispatcher: the CLI
    fleet drains one epoch and both processes exit cleanly."""
    import os
    import re
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ,
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    disp = subprocess.Popen(
        [sys.executable, "-m", "dmlc_tpu_torch.tools", "dispatch", svm_file,
         "--nchunks", "4", "--host", "127.0.0.1"],
        stdout=subprocess.PIPE, text=True, cwd=repo, env=env)
    serve = None
    try:
        m = re.match(r"dispatching (\S+) (\d+)", disp.stdout.readline())
        assert m, "dispatch CLI did not announce its address"
        addr = f"{m.group(1)}:{m.group(2)}"
        serve = subprocess.Popen(
            [sys.executable, "-m", "dmlc_tpu_torch.tools", "serve",
             "--dispatcher", addr, "--host", "127.0.0.1",
             "--nthread", "1", "--grace", "5", "--device", "cpu"],
            stdout=subprocess.PIPE, text=True, cwd=repo, env=env)
        m = re.match(r"serving (\S+) (\d+)", serve.stdout.readline())
        assert m, "serve CLI did not announce its address"
        p = RemoteBlockParser(addr, dispatcher=True, device="cpu")
        rows = sum(len(b) for b in p)
        p.close()
        assert rows == ROWS
        disp.wait(timeout=30)
        serve.wait(timeout=30)
        assert disp.returncode == 0 and serve.returncode == 0
        out = disp.stdout.read()
        assert "dispatched 4 chunks (4 acked, 0 requeued" in out
    finally:
        for proc in (disp, serve):
            if proc is not None and proc.poll() is None:
                proc.kill()


class TestMultiTenantFleet:
    """PR 12: per-job ledgers, fair-share admission, quotas, drain-based
    scale-down, cache-aware routing — all over the same RPC surface."""

    @pytest.fixture()
    def svm_pair(self, tmp_path):
        paths = []
        for tag, scale in (("a", 1), ("b", 3)):
            path = tmp_path / f"{tag}.svm"
            with open(path, "w") as fh:
                for i in range(ROWS):
                    fh.write(f"{i % 3} 1:{scale * i}\n")
            paths.append(str(path))
        return paths

    @staticmethod
    def _worker(cli):
        return cli.call({"op": "register",
                         "addr": ("127.0.0.1", 1)})["worker_id"]

    def test_add_job_idempotent_and_snapshot_sections(self, svm_pair):
        a, b = svm_pair
        with DataDispatcher() as d:
            info = d.add_job("jobA", a, nchunks=4)
            assert info["created"] and info["epoch"] == 1
            assert d.add_job("jobB", b, nchunks=2, weight=2.0)["jid"] != \
                info["jid"]
            # same name again: resumed, not recreated
            again = d.add_job("jobA", a, nchunks=4)
            assert not again["created"] and again["jid"] == info["jid"]
            snap = d.snapshot()
            assert set(snap["jobs"]) == {"jobA", "jobB"}
            assert snap["jobs"]["jobA"]["chunks"]["total"] == 4
            assert snap["jobs"]["jobB"]["weight"] == 2.0
            # top level aggregates across jobs (old dashboards keep working)
            assert snap["chunks"]["total"] == 6
            assert snap["chunks"]["queued"] == 6

    def test_fair_share_weighted_lease_interleaving(self, svm_pair):
        """Unrestricted (legacy worker) leases are granted min(granted /
        weight) first: a 3:1 weight split yields a 3:1 grant split."""
        a, b = svm_pair
        with DataDispatcher() as d:
            ja = d.add_job("heavy", a, nchunks=8, weight=3.0)["jid"]
            jb = d.add_job("light", b, nchunks=8, weight=1.0)["jid"]
            cli = DispatcherClient(d.address)
            wid = self._worker(cli)
            got = [cli.call({"op": "lease", "worker": wid})["chunk"]["job"]
                   for _ in range(8)]
            assert got.count(ja) == 6 and got.count(jb) == 2
            cli.close()

    def test_job_inflight_quota_backpressure(self, svm_file):
        """A job at its in-flight cap gets a typed busy reply, not a
        lease; settling a chunk reopens the window."""
        with DataDispatcher() as d:
            jid = d.add_job("q", svm_file, nchunks=4, max_inflight=2)["jid"]
            cli = DispatcherClient(d.address)
            wid = self._worker(cli)
            cid = cli.call({"op": "client", "job": "q"})["client_id"]
            seqs = [cli.call({"op": "lease", "worker": wid,
                              "job": jid})["chunk"]["seq"]
                    for _ in range(2)]
            busy = cli.call({"op": "lease", "worker": wid, "job": jid})
            assert busy.get("busy") and "chunk" not in busy
            assert cli.call({"op": "recv", "client": cid, "job": jid,
                             "seq": seqs[0]})["ok"]
            assert cli.call({"op": "ack", "client": cid, "job": jid,
                             "seq": seqs[0]})["ok"]
            third = cli.call({"op": "lease", "worker": wid, "job": jid})
            assert third["chunk"]["seq"] == 2
            assert d.snapshot()["jobs"]["q"]["busy"] >= 1
            cli.close()

    def test_job_cap_is_typed_backpressure(self, svm_pair):
        """DMLC_TPU_DATA_MAX_JOBS overflow surfaces as DataBusyError —
        an OSError, so RetryPolicy already classifies it transient."""
        from dmlc_tpu_torch.data import DataBusyError, register_job
        from dmlc_tpu_torch.resilience import classify_transient

        a, b = svm_pair
        with DataDispatcher(max_jobs=1) as d:
            d.add_job("only", a, nchunks=2)
            with pytest.raises(DataBusyError):
                d.add_job("extra", b, nchunks=2)
            cli = DispatcherClient(d.address)
            # over the wire too, via the client-side helper
            with pytest.raises(DataBusyError) as err:
                register_job(cli, "extra", b, nchunks=2)
            assert classify_transient(err.value)
            # re-registering the EXISTING job is not an admission
            assert not register_job(cli, "only", a, nchunks=2)["created"]
            cli.close()

    def test_reregistration_resumes_ack_frontier(self, svm_file):
        """Satellite: a job re-registered after a crash resumes exactly
        at its ack frontier — acked seqs come back so a restarted client
        pre-seeds its dedup set instead of re-reading chunks."""
        from dmlc_tpu_torch.data import register_job

        with DataDispatcher() as d:
            jid = d.add_job("j", svm_file, nchunks=4)["jid"]
            cli = DispatcherClient(d.address)
            wid = self._worker(cli)
            cid = cli.call({"op": "client", "job": "j"})["client_id"]
            for _ in range(2):
                seq = cli.call({"op": "lease", "worker": wid,
                                "job": jid})["chunk"]["seq"]
                cli.call({"op": "recv", "client": cid, "job": jid,
                          "seq": seq})
                cli.call({"op": "ack", "client": cid, "job": jid,
                          "seq": seq})
            # "crash": the driver comes back and re-registers the job
            again = register_job(cli, "j", svm_file, nchunks=4)
            assert not again["created"] and again["epoch"] == 1
            assert sorted(again["acked"]) == [0, 1]
            # a fresh client session sees the same frontier
            fresh = cli.call({"op": "client", "job": "j"})
            assert sorted(fresh["acked"]) == [0, 1]
            cli.close()

    def test_remove_job_releases_leases_without_cross_talk(self, svm_pair):
        a, b = svm_pair
        with DataDispatcher() as d:
            d.add_job("keep", a, nchunks=2)
            jb = d.add_job("gone", b, nchunks=2)["jid"]
            cli = DispatcherClient(d.address)
            wid = self._worker(cli)
            cid = cli.call({"op": "client", "job": "gone"})["client_id"]
            seq = cli.call({"op": "lease", "worker": wid,
                            "job": jb})["chunk"]["seq"]
            assert d.remove_job("gone")
            assert not d.remove_job("gone")  # idempotent
            snap = d.snapshot()
            assert set(snap["jobs"]) == {"keep"}
            assert snap["chunks"]["total"] == 2  # survivor only
            # late RPCs against the removed ledger are errors, not crashes
            late = cli.call({"op": "ack", "client": cid, "job": jb,
                             "seq": seq})
            assert not late.get("ok")
            # the survivor leases normally
            assert "chunk" in cli.call({"op": "lease", "worker": wid})
            cli.close()

    def test_reset_job_starts_new_epoch(self, svm_file):
        with DataDispatcher() as d:
            jid = d.add_job("e", svm_file, nchunks=2)["jid"]
            cli = DispatcherClient(d.address)
            wid = self._worker(cli)
            cid = cli.call({"op": "client", "job": "e"})["client_id"]
            for _ in range(2):
                seq = cli.call({"op": "lease", "worker": wid,
                                "job": jid})["chunk"]["seq"]
                cli.call({"op": "recv", "client": cid, "job": jid,
                          "seq": seq})
                cli.call({"op": "ack", "client": cid, "job": jid,
                          "seq": seq})
            assert d.join(timeout=5, job="e")
            assert d.reset_job("e") == 2
            snap = d.snapshot()["jobs"]["e"]
            assert snap["epoch"] == 2
            assert snap["chunks"]["queued"] == 2
            # the frontier reset too: clients start the epoch clean
            assert cli.call({"op": "client", "job": "e"})["acked"] == []
            cli.close()

    def test_drain_worker_retires_when_idle(self, svm_file):
        """Scale-down path: a draining worker finishes its leases, then
        its next idle poll is answered `retire` and it is delisted."""
        with DataDispatcher(svm_file, nchunks=2) as d:
            cli = DispatcherClient(d.address)
            w0 = self._worker(cli)
            w1 = cli.call({"op": "register",
                           "addr": ("127.0.0.1", 2)})["worker_id"]
            cid = cli.call({"op": "client"})["client_id"]
            seq = cli.call({"op": "lease", "worker": w1})["chunk"]["seq"]
            d.drain_worker(w1)
            # still holding a lease: not retired yet, but takes no new work
            snap = d.snapshot()
            assert snap["workers"][str(w1)]["draining"]
            cli.call({"op": "recv", "client": cid, "seq": seq})
            cli.call({"op": "ack", "client": cid, "seq": seq})
            assert cli.call({"op": "lease", "worker": w1}).get("retire")
            assert not d.snapshot()["workers"][str(w1)]["live"]
            # the rest of the epoch proceeds on the survivor
            seq = cli.call({"op": "lease", "worker": w0})["chunk"]["seq"]
            cli.call({"op": "recv", "client": cid, "seq": seq})
            cli.call({"op": "ack", "client": cid, "seq": seq})
            assert d.join(timeout=5)
            cli.close()

    def test_drain_worker_faultpoint(self, svm_file):
        """`scale.drain` chaos site: an injected fault aborts the drain
        (worker keeps its leases); the retry succeeds."""
        with DataDispatcher(svm_file, nchunks=1) as d:
            cli = DispatcherClient(d.address)
            wid = self._worker(cli)
            resilience.configure("scale.drain:nth=1")
            with pytest.raises(OSError):
                d.drain_worker(wid)
            assert not d.snapshot()["workers"][str(wid)]["draining"]
            d.drain_worker(wid)
            assert d.snapshot()["workers"][str(wid)]["draining"]
            cli.close()

    def test_cache_aware_routing_prefers_hot_worker(self, svm_file):
        """Two jobs over the SAME source: the lease scheduler hands a
        worker the parts it already parsed for the other job first, so
        the shared source cache hits instead of re-parsing."""
        with DataDispatcher() as d:
            ja = d.add_job("first", svm_file, nchunks=2)["jid"]
            jb = d.add_job("second", svm_file, nchunks=2)["jid"]
            cli = DispatcherClient(d.address)
            w0 = self._worker(cli)
            w1 = cli.call({"op": "register",
                           "addr": ("127.0.0.1", 2)})["worker_id"]
            cid = cli.call({"op": "client", "job": "first"})["client_id"]
            # job "first": w0 parses part 0, w1 parses part 1
            assert cli.call({"op": "lease", "worker": w0,
                             "job": ja})["chunk"]["seq"] == 0
            assert cli.call({"op": "lease", "worker": w1,
                             "job": ja})["chunk"]["seq"] == 1
            for seq in (0, 1):
                cli.call({"op": "recv", "client": cid, "job": ja,
                          "seq": seq})
                cli.call({"op": "ack", "client": cid, "job": ja,
                          "seq": seq})
            # job "second", asked by w1 FIRST: seq 1 is hot on w1, so it
            # gets part 1 even though part 0 is the lower queued seq
            assert cli.call({"op": "lease", "worker": w1,
                             "job": jb})["chunk"]["seq"] == 1
            assert cli.call({"op": "lease", "worker": w0,
                             "job": jb})["chunk"]["seq"] == 0
            cli.close()

    def test_unknown_job_client_is_rejected(self, svm_file):
        with DataDispatcher(svm_file, nchunks=1) as d:
            cli = DispatcherClient(d.address)
            reply = cli.call({"op": "client", "job": "nope"})
            assert not reply.get("ok") and "nope" in reply.get("error", "")
            cli.close()


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def _rows_file(tmp_path, rows=600):
    """A libsvm file of seeded float rows: ids 1-19, 1-5 entries a row."""
    rng = np.random.RandomState(3)
    path = tmp_path / "rows.svm"
    with open(path, "w") as fh:
        for i in range(rows):
            ids = np.sort(rng.choice(np.arange(1, 20), rng.randint(1, 6),
                                     replace=False))
            fh.write("%d %s\n" % (i % 2, " ".join(
                "%d:%.6g" % (j, rng.randn()) for j in ids)))
    return str(path)


def _local_rows(path):
    from dmlc_tpu_torch.data import RowBlockContainer, create_parser

    cont = RowBlockContainer()
    parser = create_parser(path, device="cpu")
    for block in parser:
        cont.push_block(block)
    parser.close()
    return cont.to_block()


def _concat(blocks):
    """offset / label / index / value of blocks from either package,
    joined in arrival order."""
    offsets, labels, index, value, start = [np.zeros(1, np.int64)], [], \
        [], [], 0
    for b in blocks:
        off = np.asarray(b.offset, dtype=np.int64)
        offsets.append(off[1:] - off[0] + start)
        start += int(off[-1] - off[0])
        labels.append(np.asarray(b.label))
        index.append(np.asarray(b.index))
        value.append(np.asarray(b.value))
    return {"offset": np.concatenate(offsets),
            "label": np.concatenate(labels),
            "index": np.concatenate(index),
            "value": np.concatenate(value)}


def _same_rows(got, want):
    for name in ("offset", "label", "index", "value"):
        a, b = got[name], np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _masked(snap):
    """A snapshot with its clock and socket addresses masked."""
    snap = json.loads(json.dumps(snap))
    for w in snap["workers"].values():
        w["lag_s"] = 0.0
        w["addr"] = "-"
    return snap


@pytest.fixture()
def jax_vector_parse(monkeypatch):
    # the JAX package's numpy parse (its native parser gives other dtypes)
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")


def test_wire_both_ways_rows_and_snapshots(tmp_path, jax_vector_parse):
    """The JAX dispatcher with a port worker and a JAX consumer, then the
    port's dispatcher with a JAX worker and a port consumer: the rows are
    the port's local read bit for bit, and the two dispatchers' snapshots
    are equal key for key once clocks and addresses are masked."""
    import dmlc_tpu.data as jd

    path = _rows_file(tmp_path)
    want = _local_rows(path)
    snaps = []
    for disp_cls, worker, consumer in (
            (jd.DataDispatcher,
             lambda a: BlockService(dispatcher=a, nthread=1, device="cpu"),
             lambda a: jd.RemoteBlockParser(a, dispatcher=True)),
            (DataDispatcher,
             lambda a: jd.BlockService(dispatcher=a, nthread=1),
             lambda a: RemoteBlockParser(a, dispatcher=True,
                                         device="cpu"))):
        with disp_cls(path, nchunks=5) as d:
            svc = worker(d.address)
            try:
                parser = consumer(d.address)
                blocks = list(parser)
                parser.close()
                assert d.join(timeout=10), d.snapshot()
                snaps.append(_masked(d.snapshot()))
            finally:
                svc.close()
        assert [b.seq_id for b in blocks] == list(range(5))
        _same_rows(_concat(blocks), want)
    assert snaps[0] == snaps[1]
    assert snaps[0]["chunks"]["acked"] == 5 and snaps[0]["requeued"] == 0


def test_frames_are_the_jax_packages_bytes():
    """The frame encoder and decoder of both packages: the same bytes for
    the same arrays, and each decodes the other's."""
    import socket

    from dmlc_tpu.data import service as jax_service
    from dmlc_tpu_torch.data import service as port_service

    arrays = {"offset": np.asarray([0, 2, 3], dtype=np.int64),
              "label": np.asarray([1.0, 0.0], dtype=np.float32),
              "index": np.asarray([1, 5, 2], dtype=np.uint32),
              "value": np.asarray([0.5, -1.0, 2.0], dtype=np.float32),
              "seq": np.asarray([4], dtype=np.int64)}
    data = port_service._pack_arrays(arrays)
    assert data == jax_service._pack_arrays(arrays)
    for decode in (port_service._recv_arrays, jax_service._recv_arrays):
        a, b = socket.socketpair()
        try:
            a.sendall(data)
            got = decode(b)
        finally:
            a.close()
            b.close()
        assert set(got) == set(arrays)
        for name, arr in arrays.items():
            assert got[name].dtype == arr.dtype
            assert np.array_equal(got[name], arr)


def _data_epoch(path, faults, nworkers):
    """One dispatcher epoch over ``path`` through ``nworkers`` port
    workers with ``faults`` armed: (digest of an order-insensitive row
    aggregate, the final snapshot with the faults fired under
    ``"fired"``). The aggregate sums integers in float64, exact in any
    arrival order."""
    import hashlib

    resilience.reset()
    if faults:
        resilience.configure(faults)
    try:
        with DataDispatcher(path, nchunks=8, lease_s=1.0,
                            dead_after_s=0.75) as disp:
            workers = [BlockService(dispatcher=disp.address, nthread=1,
                                    device="cpu")
                       for _ in range(nworkers)]
            try:
                parser = RemoteBlockParser(disp.address, dispatcher=True,
                                           device="cpu")
                agg = np.zeros(3)
                for block in parser:
                    agg[0] += np.sum(np.asarray(block.label))
                    agg[1] += np.sum(np.asarray(block.value))
                    agg[2] += len(block)
                parser.close()
                assert disp.join(timeout=30), disp.snapshot()
                snap = disp.snapshot()
            finally:
                for svc in workers:
                    svc.close()
        snap["fired"] = len(resilience.faults.stats()["fired"])
        return hashlib.sha256(agg.tobytes()).hexdigest(), snap
    finally:
        resilience.reset()


def test_worker_killed_mid_epoch_exactly_once(tmp_path):
    """The JAX package's ``test_chaos_data_worker_killed_mid_epoch_
    exactly_once`` on the port: two workers, one crashing at its third
    lease (sockets cut, heartbeats stopped); the dispatcher declares it
    dead and requeues its lease, the consumer fails over, and the epoch's
    aggregate equals a clean one-worker run's, every chunk acked."""
    path = tmp_path / "chaos.svm"
    with open(path, "w") as fh:
        for i in range(40):
            fh.write(f"{i % 3} 1:{i}\n")
    clean, clean_snap = _data_epoch(str(path), "", nworkers=1)
    assert clean_snap["chunks"]["acked"] == 8
    assert clean_snap["requeued"] == 0
    digest, snap = _data_epoch(str(path), "service.worker_crash:nth=3",
                               nworkers=2)
    assert digest == clean and snap["fired"] == 1
    assert snap["chunks"] == {"total": 8, "queued": 0, "leased": 0,
                              "delivered": 0, "acked": 8}
    assert snap["requeued"] >= 1
    assert any(not w["live"] for w in snap["workers"].values())
    assert any(w["live"] for w in snap["workers"].values())
    assert all(row["state"] == "acked" for row in snap["lease_table"])


def test_the_fleet_refuses_a_missing_card(svm_file, monkeypatch):
    """``device=None`` means the card: without one a worker, a consumer
    and ``serve`` raise DMLCError instead of parsing on the host. The
    dispatcher holds no tensor: ``dispatch`` takes no ``--device``."""
    import torch

    from dmlc_tpu_torch.tools import dispatch, serve
    from dmlc_tpu_torch.utils.logging import DMLCError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with DataDispatcher(svm_file, nchunks=2) as d:
        with pytest.raises(DMLCError, match="no CUDA device"):
            BlockService(dispatcher=d.address, nthread=1)
        with pytest.raises(DMLCError, match="no CUDA device"):
            BlockService(svm_file)
        with pytest.raises(DMLCError, match="no CUDA device"):
            RemoteBlockParser(d.address, dispatcher=True)
        with pytest.raises(DMLCError, match="no CUDA device"):
            serve.main(["--dispatcher", "%s:%d" % d.address])
        assert d.snapshot()["workers"] == {}
    with pytest.raises(SystemExit):
        dispatch.main([svm_file, "--host", "127.0.0.1", "--device", "cpu"])


def test_dispatch_status_port_waits_for_the_status_plane(svm_file):
    """``dispatch --status-port 0`` serves the live ``/data`` lease view
    (the status plane's other endpoints too) while it dispatches, then
    ends when every chunk is acked."""
    import os
    import pathlib
    import subprocess
    import sys
    import urllib.request

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_tpu_torch.tools", "dispatch", svm_file,
         "--nchunks", "3", "--host", "127.0.0.1", "--status-port", "0",
         "--lease-s", "1", "--dead-after-s", "1"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        status = proc.stdout.readline().split()
        addr = proc.stdout.readline().split()
        assert status[0] == "status" and addr[0] == "dispatching", (
            status, addr)
        url = f"http://127.0.0.1:{status[2]}"
        disp = (addr[1], int(addr[2]))

        def get(path):
            with urllib.request.urlopen(url + path, timeout=10) as resp:
                return resp.headers["Content-Type"], resp.read()

        ctype, body = get("/data")
        view = json.loads(body)
        assert ctype == "application/json" and view["attached"] is True
        assert view["chunks"]["total"] == 3 and view["chunks"]["queued"] == 3
        cli = DispatcherClient(disp)
        wid = cli.call({"op": "register",
                        "addr": ("127.0.0.1", 7)})["worker_id"]
        cli.call({"op": "lease", "worker": wid})
        view = json.loads(get("/data")[1])
        assert view["chunks"]["leased"] == 1
        assert view["workers"][str(wid)]["leased"] == 1
        assert len(view["lease_table"]) == 3
        assert json.loads(get("/healthz")[1])["status"] == "ok"
        cli.close()
        # a real worker and consumer finish the epoch; the silent fake
        # worker's lease requeues
        with BlockService(dispatcher=disp, nthread=1, device="cpu"):
            parser = RemoteBlockParser(disp, dispatcher=True, device="cpu")
            rows = sum(len(b.offset) - 1 for b in parser)
            parser.close()
            out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rows == ROWS
    assert proc.returncode == 0, err
    assert "dispatched 3 chunks (3 acked" in out


def test_data_endpoint_matches_the_reference_plane(svm_file):
    """One dispatcher behind a port and a reference status server: the
    two ``/data`` bodies are equal, before any attach and after a lease."""
    import urllib.request

    from dmlc_tpu.obs.plane import StatusPlane as RefPlane
    from dmlc_tpu.obs.plane import StatusServer as RefServer
    from dmlc_tpu_torch.obs.plane import StatusPlane, StatusServer

    planes = (StatusPlane(), RefPlane())
    servers = (StatusServer(planes[0], port=0), RefServer(planes[1], port=0))
    for srv in servers:
        srv.start()

    def views():
        out = []
        for srv in servers:
            url = f"http://127.0.0.1:{srv.port}/data"
            with urllib.request.urlopen(url, timeout=10) as resp:
                out.append(json.loads(resp.read()))
        return out

    try:
        assert views() == [{"attached": False}] * 2
        with DataDispatcher(svm_file, nchunks=3, plane=planes[0]) as d:
            d.attach_plane(planes[1])
            cli = DispatcherClient(d.address)
            wid = cli.call({"op": "register",
                            "addr": ("127.0.0.1", 7)})["worker_id"]
            cli.call({"op": "lease", "worker": wid})
            got, want = views()
            cli.close()
        for view in (got, want):
            for w in view["workers"].values():
                w.pop("lag_s")
        assert got == want
        assert got["chunks"] == {"total": 3, "queued": 2, "leased": 1,
                                 "delivered": 0, "acked": 0}
    finally:
        for srv in servers:
            srv.close()


def test_attach_plane_hands_over_the_snapshot(svm_file):
    """``attach_plane`` takes any object with ``set_data_provider``."""

    class Plane:
        def set_data_provider(self, fn):
            self.provider = fn

    plane = Plane()
    with DataDispatcher(svm_file, nchunks=3, plane=plane) as d:
        assert plane.provider()["chunks"] == d.snapshot()["chunks"]
        assert plane.provider()["chunks"]["queued"] == 3


@pytest.mark.parametrize("faults", ["service.lease:nth=2",
                                    "dispatch.lease_job:nth=2"])
def test_lease_faults_retry_clean(tmp_path, faults):
    """Faults on the dispatcher's lease path (the connection killed
    mid-RPC): the worker's client re-dials and the epoch completes
    exactly once, as in the JAX package's chaos cases."""
    path = tmp_path / "lease.svm"
    with open(path, "w") as fh:
        for i in range(40):
            fh.write(f"{i % 3} 1:{i}\n")
    clean, _ = _data_epoch(str(path), "", nworkers=1)
    digest, snap = _data_epoch(str(path), faults, nworkers=2)
    assert digest == clean
    assert snap["fired"] == 1
    assert snap["chunks"]["acked"] == 8 and snap["rejects"] == 0
