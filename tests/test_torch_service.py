"""The port's block service (``dmlc_tpu_torch/data/service.py``) on the
CPU: the cases of the JAX package's ``tests/test_service.py`` run on the
port (dynamic sharding over TCP, the Parser interface, DeviceFeed
composition, the pending stash, truncated frames, the serve CLI), then
fleet-fed fits held against local ones and against the JAX package's, and
the feed's exactly-once acks. Every socket binds port 0.
"""

import threading
import time

import numpy as np
import pytest

from dmlc_tpu_torch.data import BlockService, RemoteBlockParser, create_parser
from dmlc_tpu_torch.utils.logging import DMLCError

ROWS = 4000


@pytest.fixture()
def svm_file(tmp_path):
    rng = np.random.RandomState(9)
    path = tmp_path / "d.svm"
    with open(path, "w") as fh:
        for i in range(ROWS):
            fh.write(f"{i % 2} 1:{i}.25 2:{rng.rand():.4f}\n")
    return str(path)


class TestBlockService:
    def test_single_consumer_sees_every_row(self, svm_file):
        with BlockService(svm_file, nthread=1, device="cpu") as svc:
            parser = RemoteBlockParser(svc.address, device="cpu")
            vals = []
            for block in parser:
                vals.extend(np.asarray(block.value)[::2].tolist())
            parser.close()
        # feature 1 carries the row id: exactly-once, in order
        assert vals == [i + 0.25 for i in range(ROWS)]
        assert svc.blocks_served > 0

    def test_dynamic_sharding_two_consumers_exactly_once(self, svm_file):
        """Blocks are handed out first-come: the union across consumers is
        every row exactly once (the tf.data service sharding contract)."""
        with BlockService(svm_file, nthread=1, device="cpu") as svc:
            results = {}

            def consume(name):
                p = RemoteBlockParser(svc.address, device="cpu")
                got = []
                for block in p:
                    got.extend(np.asarray(block.value)[::2].tolist())
                p.close()
                results[name] = got

            threads = [
                threading.Thread(target=consume, args=(f"c{i}",))
                for i in range(3)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        all_vals = sorted(v for got in results.values() for v in got)
        assert all_vals == [i + 0.25 for i in range(ROWS)]

    def test_consumer_disconnect_does_not_kill_stream(self, svm_file):
        # small chunks so the stream spans many blocks (a single-chunk file
        # would be fully consumed by the quitter's one pull)
        from dmlc_tpu_torch.data.parsers import LibSVMParser
        from dmlc_tpu_torch.io import create_input_split

        split = create_input_split(svm_file, 0, 1, "text", threaded=False)
        split.hint_chunk_size(2048)  # threaded=False: the hint lands before
        # any chunk is pulled (the prefetch thread would otherwise grab the
        # whole small file as one default-size chunk first)
        with BlockService(LibSVMParser(split, nthread=1, device="cpu"), device="cpu") as svc:
            quitter = RemoteBlockParser(svc.address, device="cpu")
            first = quitter.next_block()
            assert first is not None and len(first) < ROWS
            quitter.close()  # mid-stream disconnect
            survivor = RemoteBlockParser(svc.address, device="cpu")
            rows = sum(len(b) for b in survivor)
            survivor.close()
        # the quitter consumed one block; the survivor gets all the rest
        assert rows == ROWS - len(first)

    def test_parser_interface_contract(self, svm_file):
        with BlockService(svm_file, nthread=1, device="cpu") as svc:
            p = RemoteBlockParser(svc.address, device="cpu")
            b = p.next_block()
            assert b is not None and p.bytes_read > 0
            with pytest.raises(DMLCError):
                p.before_first()  # one-pass stream, like Parser semantics
            p.close()

    def test_device_feed_composes(self, svm_file):
        """DeviceFeed over the remote parser == DeviceFeed over a local
        parser (same rows, same batches)."""
        from dmlc_tpu_torch.device import BatchSpec, DeviceFeed

        spec = BatchSpec(batch_size=512, layout="dense", num_features=3)
        with BlockService(svm_file, nthread=1, device="cpu") as svc:
            remote_feed = DeviceFeed(RemoteBlockParser(svc.address, device="cpu"), spec, device="cpu")
            remote = [np.asarray(b["x"]) for b in remote_feed]
            remote_feed.close()
        local_feed = DeviceFeed(create_parser(svm_file, 0, 1, nthread=1, device="cpu"), spec, device="cpu")
        local = [np.asarray(b["x"]) for b in local_feed]
        local_feed.close()
        assert len(remote) == len(local)
        for a, b in zip(remote, local):
            np.testing.assert_array_equal(a, b)

    def test_undelivered_block_is_redelivered(self, svm_file):
        """A block pulled for a consumer that died mid-send goes back into
        the stream (one-slot pending buffer) — no rows leave the epoch."""
        from dmlc_tpu_torch.data.parsers import LibSVMParser
        from dmlc_tpu_torch.io import create_input_split

        split = create_input_split(svm_file, 0, 1, "text", threaded=False)
        split.hint_chunk_size(2048)
        with BlockService(LibSVMParser(split, nthread=1, device="cpu"), device="cpu") as svc:
            # simulate _serve_conn's failure path: block pulled, send failed
            arrays = svc._next_block_arrays()
            assert arrays is not None
            svc._stash_undelivered(arrays)
            p = RemoteBlockParser(svc.address, device="cpu")
            rows = sum(len(b) for b in p)
            p.close()
        assert rows == ROWS  # the stashed block was redelivered
        assert svc.blocks_dropped == 0

    def test_two_undelivered_blocks_both_redeliver(self, svm_file):
        """Two consumers dying mid-send in the same window lose nothing:
        the pending buffer is a list, not a single slot."""
        from dmlc_tpu_torch.data.parsers import LibSVMParser
        from dmlc_tpu_torch.io import create_input_split

        split = create_input_split(svm_file, 0, 1, "text", threaded=False)
        split.hint_chunk_size(2048)
        with BlockService(LibSVMParser(split, nthread=1, device="cpu"), device="cpu") as svc:
            a = svc._next_block_arrays()
            b = svc._next_block_arrays()
            svc._stash_undelivered(a)
            svc._stash_undelivered(b)
            p = RemoteBlockParser(svc.address, device="cpu")
            rows = sum(len(blk) for blk in p)
            p.close()
        assert rows == ROWS
        assert svc.blocks_dropped == 0

    def test_close_counts_undeliverable_pending_blocks(self, svm_file):
        with BlockService(svm_file, nthread=1, device="cpu") as svc:
            a = svc._next_block_arrays()
            svc._stash_undelivered(a)
        # closed with the block still pending: the loss is counted
        assert svc.blocks_dropped == 1

    def test_parser_error_reaches_consumer_and_unblocks_wait(self):
        """A parse failure must surface as a DMLCError frame on every
        consumer and set the drained event so wait()/the serve CLI exit —
        not hang behind a swallowed exception."""

        class _BoomParser:
            bytes_read = 0

            def next_block(self):
                raise DMLCError("malformed row at byte 7")

            def close(self):
                pass

        with BlockService(_BoomParser(), device="cpu") as svc:
            p = RemoteBlockParser(svc.address, device="cpu")
            with pytest.raises(DMLCError, match="malformed row"):
                p.next_block()
            svc.wait(timeout=5)  # returns: _drained set on the error path
            # a late consumer sees the same error, not a hang
            p2 = RemoteBlockParser(svc.address, device="cpu")
            with pytest.raises(DMLCError, match="malformed row"):
                p2.next_block()

    def test_wait_does_not_hang_on_idle_consumer(self, svm_file):
        """A consumer that connects but never issues a request must not
        block wait() forever (it holds a recv until close)."""
        import socket
        import time

        with BlockService(svm_file, nthread=1, device="cpu") as svc:
            idle = socket.create_connection(svc.address)  # never requests
            p = RemoteBlockParser(svc.address, device="cpu")
            rows = sum(len(b) for b in p)
            p.close()
            assert rows == ROWS
            t0 = time.monotonic()
            svc.wait(timeout=2.0)
            assert time.monotonic() - t0 < 8
            idle.close()

    def test_serves_weights_and_qids(self, tmp_path):
        path = tmp_path / "wq.svm"
        with open(path, "w") as fh:
            fh.write("1:0.5 qid:7 1:2.5\n0:1.5 qid:8 2:3.5\n")
        with BlockService(str(path), nthread=1, device="cpu") as svc:
            p = RemoteBlockParser(svc.address, device="cpu")
            b = p.next_block()
            p.close()
        assert b.weight is not None and b.qid is not None
        np.testing.assert_allclose(b.weight, [0.5, 1.5])
        np.testing.assert_array_equal(b.qid, [7, 8])


class TestFaultTolerance:
    """Satellites of the fault-tolerant service PR: bounded pending
    stash, truncated-frame failover, graceful in-flight close."""

    @pytest.fixture(autouse=True)
    def _clean_faults(self):
        from dmlc_tpu_torch import resilience

        resilience.reset()
        yield
        resilience.reset()

    def test_pending_stash_bounded_requeues_metered_apart_from_drops(
            self, svm_file, monkeypatch):
        """The pending stash caps at DMLC_TPU_DATA_PENDING_CAP: stashes
        under the cap are requeues (rows stay in the epoch), overflow
        past the backpressure window is a drop — metered separately."""
        from dmlc_tpu_torch.data import service
        from dmlc_tpu_torch.data.parsers import LibSVMParser
        from dmlc_tpu_torch.io import create_input_split

        monkeypatch.setattr(service, "_PENDING_WAIT_S", 0.05)
        monkeypatch.setenv("DMLC_TPU_DATA_PENDING_CAP", "2")
        split = create_input_split(svm_file, 0, 1, "text", threaded=False)
        split.hint_chunk_size(2048)
        with BlockService(LibSVMParser(split, nthread=1, device="cpu"), device="cpu") as svc:
            blocks = [svc._next_block_arrays() for _ in range(3)]
            for arrays in blocks:
                svc._stash_undelivered(arrays)
            assert svc.blocks_requeued == 2
            assert svc.blocks_dropped == 1  # the third overflowed the cap
            dropped_rows = len(blocks[2]["offset"]) - 1
            p = RemoteBlockParser(svc.address, device="cpu")
            rows = sum(len(b) for b in p)
            p.close()
        # the two requeued blocks redelivered; only the drop's rows left
        assert rows == ROWS - dropped_rows

    def test_truncated_frame_fails_over_no_row_lost(self, svm_file):
        """An injected service.send fault cuts a consumer off mid-frame.
        The client classifies the truncated frame as transient transport
        failure, re-dials, and the server's redelivery stash keeps the
        half-sent block in the epoch: every row arrives exactly once."""
        from dmlc_tpu_torch import resilience

        resilience.configure("service.send:nth=1")
        with BlockService(svm_file, nthread=1, device="cpu") as svc:
            p = RemoteBlockParser(svc.address, device="cpu")
            vals = []
            for block in p:
                vals.extend(np.asarray(block.value)[::2].tolist())
            p.close()
        assert len(resilience.faults.stats()["fired"]) == 1
        assert sorted(vals) == [i + 0.25 for i in range(ROWS)]
        assert svc.blocks_requeued >= 1  # the cut-off block was stashed
        assert svc.blocks_dropped == 0

    def test_truncated_frame_raises_transient_oserror(self, svm_file):
        """The wire-level contract behind the failover: a mid-frame hangup
        surfaces as TruncatedFrame, an OSError (transient), never a
        garbled-unpack DMLCError (fatal)."""
        import socket
        import struct

        from dmlc_tpu_torch.data import TruncatedFrame
        from dmlc_tpu_torch.data.service import _recv_arrays

        server = socket.socket()
        server.bind(("127.0.0.1", 0))
        server.listen(1)
        client = socket.create_connection(server.getsockname())
        conn, _ = server.accept()
        try:
            conn.sendall(struct.pack("<I", 3))  # field count, then hangup
            conn.close()
            with pytest.raises(TruncatedFrame):
                _recv_arrays(client)
        finally:
            client.close()
            server.close()

    def test_vanished_consumer_after_full_frame_counted_unconfirmed(
            self, svm_file):
        """Legacy mode cannot prove delivery of a fully-sent frame whose
        consumer dies before its next request (TCP gives no receipt, and
        there is no ack ledger to requeue safely — redelivery could
        duplicate rows the consumer did read). The frame must be counted
        possibly-lost, NOT silently forgotten and NOT restashed."""
        import socket
        import struct
        import time

        from dmlc_tpu_torch.data.parsers import LibSVMParser
        from dmlc_tpu_torch.data.service import _recv_arrays
        from dmlc_tpu_torch.io import create_input_split

        split = create_input_split(svm_file, 0, 1, "text", threaded=False)
        split.hint_chunk_size(2048)  # many blocks: the stream outlives
        # the vanishing consumer's single pull
        with BlockService(LibSVMParser(split, nthread=1, device="cpu"), device="cpu") as svc:
            rude = socket.create_connection(svc.address)
            rude.sendall(struct.pack("<I", 1))  # _REQ_NEXT
            arrays = _recv_arrays(rude)  # read the FULL frame...
            first_rows = len(arrays["offset"]) - 1
            rude.close()  # ...then vanish without another request
            deadline = time.monotonic() + 5
            while (time.monotonic() < deadline
                   and not svc.blocks_unconfirmed):
                time.sleep(0.05)
            assert svc.blocks_unconfirmed == 1
            assert svc.blocks_requeued == 0  # delivery unknown: never
            # restashed (it could duplicate) — counted instead
            survivor = RemoteBlockParser(svc.address, device="cpu")
            rows = sum(len(b) for b in survivor)
            survivor.close()
        # the unconfirmed frame's rows are exactly the ones missing
        assert rows == ROWS - first_rows

    def test_close_with_inflight_request_no_spurious_requeue(
            self, svm_file):
        """close() during an in-flight _REQ_NEXT drains the response
        before hanging up: the server's send completes, so the block is
        counted delivered — not stashed for redelivery (where it would
        duplicate rows for the next consumer) and not dropped."""
        import struct

        from dmlc_tpu_torch.data.parsers import LibSVMParser
        from dmlc_tpu_torch.io import create_input_split

        split = create_input_split(svm_file, 0, 1, "text", threaded=False)
        split.hint_chunk_size(2048)  # many blocks, so the stream outlives
        # the quitter's pulls
        with BlockService(LibSVMParser(split, nthread=1, device="cpu"), device="cpu") as svc:
            p = RemoteBlockParser(svc.address, device="cpu")
            first = p.next_block()
            assert first is not None
            seen = set(np.asarray(first.value)[::2].tolist())
            # hand-roll the race: a request is on the wire, close() runs
            # before the response is read
            p._sock.sendall(struct.pack("<I", 1))  # _REQ_NEXT
            p._inflight = True
            p.close()
            survivor = RemoteBlockParser(svc.address, device="cpu")
            got = []
            for b in survivor:
                got.extend(np.asarray(b.value)[::2].tolist())
            survivor.close()
        assert svc.blocks_requeued == 0 and svc.blocks_dropped == 0
        # the in-flight block was consumed by the drain (counted
        # delivered), so the survivor sees each remaining row exactly
        # once and the drained block's rows exactly zero times
        assert not seen.intersection(got)
        assert len(got) == len(set(got))
        missing = set(i + 0.25 for i in range(ROWS)) - seen - set(got)
        assert 0 < len(missing) < ROWS - len(first)  # exactly the one
        # drained block's rows are absent — not redelivered


def _spawn_serve(svm_file, *extra_args):
    """Launch the serve CLI; → (proc, (host, port))."""
    import os
    import re
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_tpu_torch.tools", "serve", svm_file,
         "--host", "127.0.0.1", "--nthread", "1", "--device", "cpu",
         *extra_args],
        stdout=subprocess.PIPE, text=True, cwd=repo,
        env={**os.environ,
             "PYTHONPATH": repo + os.pathsep
             + os.environ.get("PYTHONPATH", "")},
    )
    line = proc.stdout.readline()
    m = re.match(r"serving (\S+) (\d+)", line)
    assert m, line
    return proc, (m.group(1), int(m.group(2)))


class TestServeCLI:
    def test_serve_and_consume(self, svm_file):
        """python -m dmlc_tpu_torch.tools serve <uri> → consume with
        RemoteBlockParser, server exits once the stream drains."""
        proc, addr = _spawn_serve(svm_file)
        try:
            p = RemoteBlockParser(addr, device="cpu")
            rows = sum(len(b) for b in p)
            p.close()
            assert rows == ROWS
            proc.wait(timeout=30)
            assert proc.returncode == 0
            assert "served" in proc.stdout.read()
        finally:
            if proc.poll() is None:
                proc.kill()

    def test_serve_cli_grace_bounds_exit_with_idle_consumer(self, svm_file):
        """--grace forwards to BlockService.wait: an idle consumer must
        not hold the server past the grace window after drain."""
        import socket
        import time

        proc, addr = _spawn_serve(svm_file, "--grace", "1")
        try:
            idle = socket.create_connection(addr)  # never requests
            p = RemoteBlockParser(addr, device="cpu")
            rows = sum(len(b) for b in p)
            p.close()
            assert rows == ROWS
            t0 = time.monotonic()
            proc.wait(timeout=30)
            assert proc.returncode == 0
            assert time.monotonic() - t0 < 25
            idle.close()
        finally:
            if proc.poll() is None:
                proc.kill()

    def test_serve_cli_rejects_bad_part(self, svm_file):
        import os
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, "-m", "dmlc_tpu_torch.tools", "serve", svm_file,
             "--part", "2", "--nparts", "2", "--device", "cpu"],
            capture_output=True, text=True, timeout=60, cwd=repo,
            env={**os.environ,
                 "PYTHONPATH": repo + os.pathsep
                 + os.environ.get("PYTHONPATH", "")},
        )
        assert proc.returncode != 0
        assert "bad part" in proc.stderr


    def test_serve_cli_static_parts_cover_exactly_once(self, svm_file):
        """Two serve processes with --part 0/1 --nparts 2: their streams
        union to every row exactly once (static sharding across serve
        hosts; dynamic within each)."""
        procs, vals = [], []
        try:
            for part in (0, 1):
                proc, addr = _spawn_serve(
                    svm_file, "--part", str(part), "--nparts", "2")
                procs.append(proc)
                p = RemoteBlockParser(addr, device="cpu")
                for b in p:
                    vals.extend(np.asarray(b.value)[::2].tolist())
                p.close()
            for proc in procs:
                proc.wait(timeout=30)
                assert proc.returncode == 0
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
        assert sorted(vals) == [i + 0.25 for i in range(ROWS)]


# ---------------------------------------------------------------------------
# fits fed by a fleet, and the feed's exactly-once acks
# ---------------------------------------------------------------------------

FIT_NF = 4097


def _fit_file(tmp_path, rows=480):
    """Seeded float rows over ids in [1, FIT_NF), a few entries each."""
    rng = np.random.RandomState(5)
    lines = []
    for _ in range(rows):
        n = rng.randint(1, 9)
        ids = np.sort(rng.choice(np.arange(1, FIT_NF), n, replace=False))
        lines.append("%d %s" % (rng.randint(0, 2), " ".join(
            "%d:%.6f" % (j, v) for j, v in zip(ids, rng.randn(n)))))
    path = tmp_path / "fit.svm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


HYPER = dict(objective="logistic", learning_rate=0.5, l2=0.01, momentum=0.5)


def _port_fleet_fit(path, epochs, nchunks):
    """The csr fit one dispatcher job an epoch (``e0``, ``e1``, ...)
    through one port worker: (history, params as numpy, seq orders)."""
    from dmlc_tpu_torch.data import DataDispatcher
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

    learner = LinearLearner(device="cpu", **HYPER)
    history, orders = [], []
    with DataDispatcher() as d:
        for e in range(epochs):
            d.add_job("e%d" % e, path, nchunks=nchunks)
        with BlockService(dispatcher=d.address, nthread=1, device="cpu"):
            for e in range(epochs):
                parser = RemoteBlockParser(d.address, dispatcher=True,
                                           job="e%d" % e, device="cpu")
                feed = DeviceFeed(parser, BatchSpec(
                    batch_size=64, layout="csr", num_features=FIT_NF),
                    device="cpu")
                history = learner.fit_feed(feed, epochs=e + 1,
                                           start_epoch=e, history=history)
                feed.close()
                assert d.join(timeout=10, job="e%d" % e), d.snapshot()
            snap = d.snapshot()
    assert snap["chunks"]["acked"] == epochs * nchunks
    assert snap["requeued"] == 0 and snap["rejects"] == 0
    return history, params_to_numpy(learner.params)


def test_fleet_fed_csr_fit_is_the_local_fit(tmp_path):
    """Two epochs of the csr fit fed by a one-worker fleet (one consumer:
    chunks arrive in seq order, parts cut at line breaks concatenate to
    the file's rows) equal the port's local ``fit_uri`` bit for bit."""
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

    path = _fit_file(tmp_path)
    history, params = _port_fleet_fit(path, 2, 5)
    local = LinearLearner(device="cpu", **HYPER)
    want = local.fit_uri(path, batch_size=64, epochs=2, layout="csr",
                         num_features=FIT_NF)
    assert history == want
    for k, v in params_to_numpy(local.params).items():
        assert np.array_equal(params[k], v), k


def test_fleet_fed_fit_matches_the_jax_fleet(tmp_path, monkeypatch):
    """The same fleet fit on the JAX package (its dispatcher, worker,
    consumer, feed and learner): equal within the tolerance the linear
    comparisons state (rtol 1e-5 / atol 1e-6: sums in another f32 order,
    exp/log1p from two math libraries)."""
    import jax.numpy as jnp

    import dmlc_tpu.data as jd
    from dmlc_tpu.device import BatchSpec as RefBatchSpec
    from dmlc_tpu.device import DeviceFeed as RefDeviceFeed
    from dmlc_tpu.models import LinearLearner as RefLinearLearner

    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")
    path = _fit_file(tmp_path)
    history, params = _port_fleet_fit(path, 2, 5)
    ref = RefLinearLearner(None, **HYPER)
    ref_history = []
    with jd.DataDispatcher() as d:
        for e in range(2):
            d.add_job("e%d" % e, path, nchunks=5)
        with jd.BlockService(dispatcher=d.address, nthread=1):
            for e in range(2):
                feed = RefDeviceFeed(
                    jd.RemoteBlockParser(d.address, dispatcher=True,
                                         job="e%d" % e),
                    RefBatchSpec(batch_size=64, layout="csr",
                                 num_features=FIT_NF), host_prefetch=0)
                try:
                    ref_history = ref.fit_feed(feed, epochs=e + 1,
                                               start_epoch=e,
                                               history=ref_history)
                finally:
                    feed.close()
                assert d.join(timeout=10, job="e%d" % e)
    assert len(history) == 2 and history[1] < history[0]
    np.testing.assert_allclose(history, ref_history, rtol=1e-5, atol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(params[k], np.asarray(ref.params[k]),
                                   rtol=1e-5, atol=1e-6)
    assert isinstance(ref.params["w"], jnp.ndarray)


def test_feed_closed_mid_epoch_leaves_the_rest_unacked(tmp_path):
    """A DeviceFeed over a dispatcher consumer acks a chunk once the
    consumer comes back from the first batch its rows reach. Closed
    mid-epoch, it acks nothing it did not deliver: the chunk it held
    requeues once its session is gone, and a second consumer reads every
    row the first one did not settle, exactly once."""
    from dmlc_tpu_torch.data import DataDispatcher
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed

    from dmlc_tpu_torch.data import create_parser

    path = tmp_path / "ids.svm"
    with open(path, "w") as fh:
        for i in range(400):
            fh.write(f"{i % 2} 1:{i:04d}\n")

    def part_values(k):
        parser = create_parser(str(path), k, 4, device="cpu")
        vals = [v for b in parser for v in np.asarray(b.value).tolist()]
        parser.close()
        return vals

    assert len(part_values(0)) > 100  # chunk 0 spans batches 0-2
    spec = BatchSpec(batch_size=50, layout="csr", num_features=2)
    with DataDispatcher(str(path), nchunks=4, lease_s=0.2) as d:
        with BlockService(dispatcher=d.address, nthread=1, device="cpu"):
            parser = RemoteBlockParser(d.address, dispatcher=True,
                                       device="cpu")
            feed = DeviceFeed(parser, spec, device="cpu", host_prefetch=0)
            seen = []
            for nbatch, batch in enumerate(feed):
                if nbatch == 2:
                    break  # the consumer never comes back from batch 2
                vals = batch["values"].numpy()[:batch["num_nonzero"]]
                seen.extend(vals.tolist())
            feed.close()
            snap = d.snapshot()
            assert snap["chunks"]["acked"] == 1  # batches 0-1 are chunk 0
            assert snap["chunks"]["delivered"] == 1  # held, never acked
            deadline = time.monotonic() + 10
            while d.snapshot()["requeued"] == 0:
                assert time.monotonic() < deadline, d.snapshot()
                time.sleep(0.05)
            survivor = RemoteBlockParser(d.address, dispatcher=True,
                                         device="cpu")
            rest = [v for b in survivor for v in np.asarray(b.value)]
            survivor.close()
            assert d.join(timeout=10), d.snapshot()
    # chunk 0, acked with batch 0, is settled (its rows past batch 1 were
    # in the batch the consumer never finished: a chunk is the unit)
    assert sorted(seen) == [float(i) for i in range(100)]
    assert sorted(rest) == sorted(v for k in (1, 2, 3)
                                  for v in part_values(k))


def test_chunks_without_rows_are_acked_at_once(tmp_path):
    """More chunks than lines: each empty chunk rides the next batch (or
    the epoch's end) and is acked with it, so the epoch still completes."""
    from dmlc_tpu_torch.data import DataDispatcher
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed

    path = tmp_path / "short.svm"
    path.write_text("1 1:1\n0 1:2\n1 1:3\n")
    spec = BatchSpec(batch_size=2, layout="csr", num_features=2,
                     drop_remainder=True)
    with DataDispatcher(str(path), nchunks=8) as d:
        with BlockService(dispatcher=d.address, nthread=1, device="cpu"):
            feed = DeviceFeed(RemoteBlockParser(
                d.address, dispatcher=True, device="cpu"), spec,
                device="cpu")
            rows = sum(int(b["num_rows"]) for b in feed)
            feed.close()
            assert d.join(timeout=10), d.snapshot()
    assert rows == 2  # the third row falls in the dropped remainder


def _open_sockets() -> int:
    """The process's open sockets (``/proc/self/fd`` links ``socket:``)."""
    import os

    count = 0
    for fd in os.listdir("/proc/self/fd"):
        try:
            if os.readlink(f"/proc/self/fd/{fd}").startswith("socket:"):
                count += 1
        except OSError:
            pass  # closed while listed
    return count


def _settled(before_threads, before_sockets, timeout=10.0):
    """(live threads not in ``before_threads``, open sockets) once both
    are back to ``before`` or ``timeout`` passed: closing threads may
    take a poll interval to end."""
    deadline = time.monotonic() + timeout
    while True:
        extra = [t for t in threading.enumerate()
                 if t not in before_threads and t.is_alive()]
        sockets = _open_sockets()
        if (not extra and sockets <= before_sockets) \
                or time.monotonic() > deadline:
            return extra, sockets
        time.sleep(0.05)


@pytest.mark.parametrize("with_plane", [False, True],
                         ids=["bare", "plane"])
def test_a_closed_fleet_leaves_nothing_behind(tmp_path, with_plane):
    """A dispatcher, two workers and a fleet-fed fit, all closed, leave
    no thread and no socket of theirs in the process, also with the
    status plane attached to the dispatcher and its server polled (a
    second round of fleets in one process must start from a clean
    process)."""
    import json
    import urllib.request

    from dmlc_tpu_torch.data import DataDispatcher
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import LinearLearner
    from dmlc_tpu_torch.obs.plane import StatusPlane, StatusServer

    path = _fit_file(tmp_path)
    before_threads = set(threading.enumerate())
    before_sockets = _open_sockets()
    for _round in range(2):
        status = None
        with DataDispatcher(path, nchunks=4) as d:
            if with_plane:
                plane = StatusPlane()
                d.attach_plane(plane)
                status = StatusServer(plane, port=0)
                status.start()
            workers = [BlockService(dispatcher=d.address, nthread=1,
                                    device="cpu") for _ in range(2)]
            feed = DeviceFeed(
                RemoteBlockParser(d.address, dispatcher=True, device="cpu"),
                BatchSpec(batch_size=64, layout="csr", num_features=FIT_NF),
                device="cpu")
            assert len(LinearLearner(device="cpu", **HYPER).fit_feed(
                feed)) == 1
            feed.close()
            assert d.join(timeout=30), d.snapshot()
            if status is not None:
                url = "http://127.0.0.1:%d/data" % status.port
                with urllib.request.urlopen(url, timeout=10) as resp:
                    view = json.loads(resp.read())
                assert view["attached"] and view["chunks"]["acked"] == 4
                status.close()
            for w in workers:
                w.close()
        extra, sockets = _settled(before_threads, before_sockets)
        assert extra == [], [t.name for t in extra]
        assert sockets == before_sockets
