"""The port's data service (static / fcfs tier) against the JAX package's,
all over 127.0.0.1.

- The dispatcher: static assignments (disjoint, complete, one shard per
  client, the seed-tree order), the reassignment of a dead worker's
  pieces and the stale-fencing refusal, the mismatched-piece-count
  refusal, the fcfs queue and its epoch refill, and the mode errors — the
  same replies as the JAX dispatcher's to the same requests.
- Loopback static and fcfs fleets deliver a local reader's rows; two
  static clients split the store; several epochs repeat it.
- With ``ordered=True`` under static sharding the port's fleet, fed into
  ``TorchDataLoader(device="cpu")``, gives the same batches in the same
  order, array for array, as the JAX fleet fed into
  ``JaxDataLoader(stage_to_device=False)`` (row and batch factories, with
  and without a shuffle seed).
- The credit window, the batch transform's two placements, a stream that
  errors (``ServiceError``) and the diagnostics surfaces.

Each test stops every node it starts and bounds its own waits. Tolerance:
none; everything is compared exactly.
"""

import contextlib
import socket
import time

import numpy as np
import pytest
import torch

from petastorm_tpu import service as jax_service
from petastorm_tpu.reader_impl import framed_socket as jax_wire
from petastorm_tpu_torch import service as port_service
from petastorm_tpu_torch.reader_impl.framed_socket import (
    FramedConnection,
    recv_framed,
    send_framed,
)
from petastorm_tpu_torch.service import BatchWorker, ServiceBatchSource, ServiceError


@pytest.fixture(scope="module")
def row_store(tmp_path_factory):
    """The factories' TestSchema store: 60 rows in 6 row groups of 10."""
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_dataset

    url = f"file://{tmp_path_factory.mktemp('svc')}/rows"
    create_test_dataset(url, rows_count=60, rows_per_row_group=10)
    return url


@pytest.fixture(scope="module")
def scalar_store(tmp_path_factory):
    """Plain Parquet: 60 rows in 12 row groups of 5."""
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_scalar_dataset

    url = f"file://{tmp_path_factory.mktemp('svc')}/scalar"
    create_test_scalar_dataset(url, rows_count=60, rows_per_row_group=5)
    return url


@contextlib.contextmanager
def fleet(url, package=port_service, mode="static", num_epochs=1, workers=2, batch_size=7,
          factory="row", shuffle_seed=None, **worker_kwargs):
    """A dispatcher and ``workers`` workers of ``package``, stopped on exit."""
    dispatcher = package.Dispatcher(mode=mode, num_epochs=num_epochs,
                                    shuffle_seed=shuffle_seed).start()
    started = []
    try:
        for i in range(workers):
            started.append(package.BatchWorker(
                url, dispatcher_address=dispatcher.address, batch_size=batch_size,
                reader_factory=factory, worker_id=f"w{i}",
                reader_kwargs={"workers_count": 2}, **worker_kwargs).start())
        yield dispatcher, started
    finally:
        for worker in started:
            worker.stop()
        dispatcher.stop()


def _ids(batches):
    return sorted(int(i) for batch in batches for i in np.asarray(batch["id"]))


def _local_ids(url, factory="make_reader"):
    from petastorm_tpu_torch.reader import reader as reader_mod

    with getattr(reader_mod, factory)(url, reader_pool_type="dummy",
                                      shuffle_row_groups=False) as reader:
        out = []
        for item in reader:
            out.extend(np.atleast_1d(np.asarray(item.id)).tolist())
    return sorted(out)


# ---------------------------------------------------------------------------
# the dispatcher, request for request against the JAX dispatcher
# ---------------------------------------------------------------------------

def _register(worker_id, pieces, port=1):
    return {"type": "register_worker", "worker_id": worker_id, "host": "127.0.0.1",
            "port": port, "num_pieces": pieces}


def _assignment(index, count, epoch=0, client="c"):
    return {"type": "get_assignment", "client_id": f"{client}{index}", "client_index": index,
            "num_clients": count, "epoch": epoch}


SCENARIOS = {
    "static_three_clients": (dict(mode="static"), [
        _register("w0", 11, 1), _register("w1", 11, 2), _register("w2", 11, 3),
        _assignment(0, 3), _assignment(1, 3), _assignment(2, 3), _assignment(1, 3, epoch=1),
        {"type": "list_workers"}]),
    "static_seeded_epochs": (dict(mode="static", shuffle_seed=5), [
        _register("w0", 9, 1), _register("w1", 9, 2),
        _assignment(0, 2), _assignment(1, 2), _assignment(0, 2, epoch=1),
        _assignment(0, 1, epoch=2), {"type": "list_workers"}]),
    "reassign_dead_worker": (dict(mode="static"), [
        _register("w0", 10, 1), _register("w1", 10, 2), _register("w2", 10, 3),
        _assignment(0, 1),
        {"type": "report_failure", "client_id": "c0", "worker_id": "w1",
         "pieces": [1, 4, 7], "fencing_epoch": 0},
        {"type": "report_failure", "client_id": "c0", "worker_id": "w2",
         "pieces": [2, 5, 8], "fencing_epoch": 0},
        {"type": "report_failure", "client_id": "c0", "worker_id": "w2",
         "pieces": [2, 5, 8], "fencing_epoch": 1},
        _assignment(0, 1, epoch=1), {"type": "list_workers"},
        {"type": "report_failure", "client_id": "c0", "worker_id": "w0", "pieces": [0]}]),
    "mismatched_piece_counts": (dict(mode="static"), [
        _register("w0", 10, 1), _register("w1", 12, 2), _register("w0", 10, 1),
        {"type": "list_workers"}]),
    "fcfs_refill": (dict(mode="fcfs", num_epochs=2), [
        {"type": "next_split", "client_id": "c"}, _register("w0", 3, 1)]
        + [{"type": "next_split", "client_id": "c"}] * 8),
    "static_mode_errors": (dict(mode="static"), [
        _assignment(0, 1), {"type": "next_split", "client_id": "c"}, _register("w0", 4),
        _assignment(3, 2), _assignment(-1, 2), {"type": "bogus"}, {"type": "ping"}]),
    "fcfs_mode_errors": (dict(mode="fcfs"), [
        _register("w0", 4), _assignment(0, 1), {"type": "list_workers"}]),
    "heartbeats": (dict(mode="static"), [
        {"type": "worker_heartbeat", "worker_id": "w0"}, _register("w0", 4),
        {"type": "worker_heartbeat", "worker_id": "w0", "credit_wait_s": 0.5},
        {"type": "report_failure", "client_id": "c", "worker_id": "w0", "pieces": []},
        {"type": "worker_heartbeat", "worker_id": "w0"},
        dict(_register("w0", 4), re_register=True), _assignment(0, 1)]),
}


def _replay(package, kwargs, requests):
    replies = []
    with package.Dispatcher(**kwargs).start() as dispatcher:
        for request in requests:
            with jax_wire.FramedConnection.connect(dispatcher.address, timeout=5.0) as conn:
                reply, _ = conn.request(dict(request))
            if request["type"] == "worker_heartbeat":
                reply = {k: reply[k] for k in ("type", "fencing_epoch")}
            replies.append(reply)
    return replies


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_dispatcher_replies_equal_jax(scenario):
    kwargs, requests = SCENARIOS[scenario]
    port = _replay(port_service, kwargs, requests)
    assert port == _replay(jax_service, kwargs, requests)
    assignments = [r for r in port if r.get("type") == "assignment" and "epoch" in r]
    if scenario == "static_three_clients":
        shares = [sorted(p for ps in r["assignments"].values() for p in ps)
                  for r in assignments[:3]]
        assert sorted(sum(shares, [])) == list(range(11))  # disjoint and complete
        assert shares[1] == list(range(11))[1::3]  # one shard per client
    if scenario == "static_seeded_epochs":
        from petastorm_tpu_torch.service.seedtree import piece_order

        assert assignments[2]["assignments"]["w0"] == piece_order(5, 1, [0, 4, 8])
    if scenario == "reassign_dead_worker":
        moved = port[4]
        assert moved["fencing_epoch"] == 1 and sorted(moved["assignments"]) == ["w0", "w2"]
        assert port[5]["type"] == "stale_fencing"
        assert sorted(port[6]["assignments"]) == ["w0"]
    if scenario == "mismatched_piece_counts":
        assert port[1]["type"] == "error" and "12 row-group pieces" in port[1]["error"]
    if scenario == "fcfs_refill":
        assert [r.get("piece") for r in port[2:]] == [0, 1, 2, 0, 1, 2, None, None]
        assert [r["type"] for r in port[-2:]] == ["end_of_stream"] * 2


# ---------------------------------------------------------------------------
# loopback fleets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["static", "fcfs"])
@pytest.mark.parametrize("factory", ["row", "batch"])
def test_loopback_fleet_delivers_the_local_readers_rows(row_store, scalar_store, mode,
                                                        factory):
    url = row_store if factory == "row" else scalar_store
    with fleet(url, mode=mode, factory=factory) as (dispatcher, _):
        got = _ids(ServiceBatchSource(dispatcher.address, credits=3)())
    assert got == _local_ids(url, "make_reader" if factory == "row" else "make_batch_reader")


def _ordered(package, url, factory, seed, loader_kind):
    with fleet(url, package=package, factory=factory, shuffle_seed=seed, workers=3,
               batch_size=4, num_epochs=2) as (dispatcher, _):
        if package is port_service:
            from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

            source = ServiceBatchSource(dispatcher.address, credits=2, ordered=True)
            loader = TorchDataLoader(None, source, device="cpu")
        else:
            from petastorm_tpu.jax_utils.loader import JaxDataLoader

            source = jax_service.ServiceBatchSource(dispatcher.address, credits=2,
                                                    ordered=True)
            loader = JaxDataLoader(None, 4, batch_source=source, stage_to_device=False)
        with loader:
            return [{k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
                     for k, v in batch.items()} for batch in loader]


@pytest.mark.parametrize("seed", [None, 11])
@pytest.mark.parametrize("factory", ["row", "batch"])
def test_ordered_static_batches_equal_jax_array_for_array(row_store, scalar_store, factory,
                                                          seed):
    url = row_store if factory == "row" else scalar_store
    port = _ordered(port_service, url, factory, seed, "torch")
    jax = _ordered(jax_service, url, factory, seed, "jax")
    assert len(port) == len(jax) > 12
    for got, want in zip(port, jax):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            if want[key].dtype == object:  # strings, Decimals, arrays or None
                assert len(got[key]) == len(want[key])
                for a, b in zip(got[key], want[key]):
                    assert (a is None and b is None) or np.array_equal(a, b), key
            else:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert _ids(port) == sorted(2 * list(range(60)))


def test_two_static_clients_split_the_store(scalar_store):
    with fleet(scalar_store, factory="batch") as (dispatcher, _):
        halves = [_ids(ServiceBatchSource(dispatcher.address, client_index=i,
                                          num_clients=2)()) for i in range(2)]
    assert not set(halves[0]) & set(halves[1])
    assert sorted(halves[0] + halves[1]) == list(range(60))
    assert halves[1] == sorted(i for i in range(60) if (i // 5) % 2)


@pytest.mark.parametrize("mode", ["static", "fcfs"])
def test_several_epochs_repeat_the_store(scalar_store, mode):
    with fleet(scalar_store, mode=mode, num_epochs=3, factory="batch") as (dispatcher, _):
        source = ServiceBatchSource(dispatcher.address)
        got = _ids(source())
    assert got == sorted(3 * list(range(60)))
    if mode == "static":
        assert [epoch for _, epoch in source.diagnostics["epoch_starts"]] == [0, 1, 2, 3]


@pytest.mark.parametrize("tagged", [False, True])
def test_credit_window_bounds_the_batches_in_flight(row_store, tagged):
    worker = BatchWorker(row_store, batch_size=4, reader_kwargs={"workers_count": 2}).start()
    sock = socket.create_connection(worker.address, timeout=5)
    try:
        request = {"type": "stream", "pieces": [0, 1, 2], "epoch": 0, "credits": 2}
        if tagged:
            request["tagged"] = True
        send_framed(sock, request)
        for _ in range(2):
            assert recv_framed(sock)[0]["type"] in ("batch", "piece_done")
        headers = []
        sock.settimeout(0.5)
        while True:  # a piece_done marker costs no credit: only batches stop
            try:
                headers.append(recv_framed(sock)[0]["type"])
            except socket.timeout:
                break
        assert "batch" not in headers
        send_framed(sock, {"type": "credit", "n": 1})
        sock.settimeout(5)
        header = recv_framed(sock)[0]
        while header["type"] == "piece_done":
            header = recv_framed(sock)[0]
        assert header["type"] == "batch"
        # The worker books a batch just after sending it: poll for the books.
        deadline = time.monotonic() + 5
        while True:
            flow = next(iter(worker.diagnostics_snapshot()["active_streams"].values()))
            if flow["batches_sent"] == 3 or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        assert flow["credits_window"] == 2 and flow["credits_left"] == 0
        assert flow["batches_sent"] == 3
    finally:
        sock.close()
        worker.stop()


def test_stream_without_credits_is_unbounded(row_store):
    worker = BatchWorker(row_store, batch_size=4, reader_kwargs={"workers_count": 2}).start()
    try:
        with FramedConnection.connect(worker.address, timeout=5) as conn:
            conn.send({"type": "stream", "pieces": [0, 1], "epoch": 0})
            kinds = []
            while not kinds or kinds[-1] != "end":
                kinds.append(conn.recv()[0]["type"])
        assert kinds == ["batch"] * 5 + ["end"]  # 20 rows in batches of 4, across pieces
    finally:
        worker.stop()


def test_tagged_stream_resumes_each_piece_at_its_watermark(row_store):
    worker = BatchWorker(row_store, batch_size=4, reader_kwargs={"workers_count": 2}).start()
    try:
        events = []
        with FramedConnection.connect(worker.address, timeout=5) as conn:
            conn.send({"type": "stream", "pieces": [2, 0], "epoch": 0, "tagged": True,
                       "starts": {"0": 2, "2": 1}})
            while not events or events[-1][0] != "end":
                header, payload = conn.recv()
                events.append((header["type"], header.get("piece"), header.get("ordinal"),
                               None if payload is None else payload["id"].tolist()))
        # Pieces arrive in their decode order; each piece's batches in order.
        batches = sorted(e[1:] for e in events if e[0] == "batch")
        assert batches == [(0, 2, [8, 9]), (2, 1, [24, 25, 26, 27]), (2, 2, [28, 29])]
        assert sorted(e[1] for e in events if e[0] == "piece_done") == [0, 2]
        done_at = {e[1]: i for i, e in enumerate(events) if e[0] == "piece_done"}
        assert all(i < done_at[e[1]] for i, e in enumerate(events) if e[0] == "batch")
    finally:
        worker.stop()


def _double(batch):
    return dict(batch, float_col=batch["float_col"] * 2)


@pytest.mark.parametrize("placement", ["remote", "local"])
def test_batch_transform_runs_once_in_either_placement(scalar_store, placement):
    with fleet(scalar_store, factory="batch", batch_transform=_double) as (dispatcher, _):
        source = ServiceBatchSource(dispatcher.address, transform=_double,
                                    transform_placement=placement, ordered=True)
        batches = list(source())
    assert np.concatenate([b["float_col"] for b in batches]).tolist() == \
        [i * 3.0 for i in range(60)]


def test_remote_transform_without_a_worker_transform_is_a_service_error(scalar_store):
    with fleet(scalar_store, factory="batch") as (dispatcher, _):
        source = ServiceBatchSource(dispatcher.address, transform=_double)
        with pytest.raises(ServiceError, match="no batch_transform armed"):
            list(source())


def _raise(batch):
    raise RuntimeError("transform exploded")


def test_a_stream_that_errors_is_a_service_error(row_store):
    with fleet(row_store) as (dispatcher, workers):
        with FramedConnection.connect(workers[0].address, timeout=5) as conn:
            conn.send({"type": "stream", "pieces": [99], "epoch": 0})
            header, _ = conn.recv()
        assert header["type"] == "error" and "99" in header["error"]
    with fleet(row_store, workers=1, batch_transform=_raise) as (dispatcher, _):
        with pytest.raises(ServiceError, match="transform exploded"):
            list(ServiceBatchSource(dispatcher.address)())


def test_diagnostics_surfaces(scalar_store):
    with fleet(scalar_store, factory="batch") as (dispatcher, workers):
        source = ServiceBatchSource(dispatcher.address, credits=4)
        assert len(_ids(source())) == 60
        diag = source.diagnostics
        assert sum(w["batches"] for w in diag["per_worker"].values()) == 12
        assert sum(w["pieces"] for w in diag["per_worker"].values()) == 12
        assert diag["credits_window"] == 4 and diag["ready_queue_capacity"] == 0
        remote = source.remote_diagnostics()
        assert sorted(remote) == ["w0", "w1"]
        assert all(len(d["completed_streams"]) == 1 for d in remote.values())
        assert sum(flow["batches_sent"] for d in remote.values()
                   for flow in d["completed_streams"].values()) == 12
        status = source.dispatcher_status()
        assert status["mode"] == "static" and status["num_pieces"] == 12
        assert sorted(status["workers"]) == ["w0", "w1"]
        with FramedConnection.connect(dispatcher.address, timeout=5) as conn:
            reply, payload = conn.request({"type": "worker_diagnostics"})
        assert reply["workers"] == ["w0", "w1"] and sorted(payload) == ["w0", "w1"]
        with FramedConnection.connect(workers[0].address, timeout=5) as conn:
            assert conn.request({"type": "ping"})[0] == {"type": "pong", "worker_id": "w0"}
