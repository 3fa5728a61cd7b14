"""The port's chaos fuzzer (``petastorm_tpu_torch/service/fuzz.py``)
against the JAX package's (``petastorm_tpu/service/fuzz.py``), on the CPU.

The four fast cases of ``tests/test_failpoints.py`` run through both
packages' ``fuzz`` with the same injected ``run_fn`` s and must give the
same reports. One real seed runs through both packages' ``default_run_fn``
(the loopback service under the full failpoint vocabulary): the delivered
streams' digests must be equal, every row delivered once, and the
injections of the points that every batch or control message passes (the
framed transport, the columnar encode, the shm ring, the slow peer) equal:
their call counts pass the whole fire window in every run. The points
passed a few times a run, at moments set by wall-clock ticks and reconnect
races (heartbeats, dispatcher replies, journal appends, the fleet cache's
peer traffic and hand-off, the breaker's reconnects), may stop short of a
fire index in one run and not in the next, within one package too (2 of
12 seeds for ``cache-peer-gone`` in the JAX package alone), which is why
the JAX fuzzer compares logs only on request; they are left out of that
equality. The reproducer replays through the port's CLI to the same
digest. The 20-seed soaks are ``slow``, as in JAX.
"""

import json
import shlex
import threading
import time

import pytest

from petastorm_tpu.service import fuzz as jax_fuzz
from petastorm_tpu_torch import failpoints
from petastorm_tpu_torch.benchmark import cli as port_cli
from petastorm_tpu_torch.service import fuzz
from petastorm_tpu_torch.service.shm_ring import live_shm_counts

#: The points every batch or control message passes.
BUSY_POINTS = ("transport.send", "transport.recv", "decode.columnar", "shm-detach",
               "torn-doorbell", "stale-arena", "slow-peer")


@pytest.fixture(autouse=True)
def _port_leak_guard():
    """Fail a test that leaves the port's schedule armed or a ring of its
    registry mapped (the conftest guards watch the JAX package's)."""
    rings_before = live_shm_counts()
    yield
    if failpoints.ACTIVE is not None:
        failpoints.disarm()
        pytest.fail("a port FaultSchedule outlived its test")
    assert live_shm_counts() == rings_before


@pytest.mark.parametrize("package", [fuzz, jax_fuzz], ids=["port", "jax"])
def test_fuzz_shrinker_produces_minimal_seed_stamped_reproducer(package):
    def broken_build(seed, points):
        # Any schedule holding cache.write trips the (pretend) bug.
        if points is None or "cache.write" in points:
            raise RuntimeError("invariant violated: 3 lost rows")
        return {"stream_digest": "d", "failpoint_injections": []}

    with pytest.raises(package.FuzzFailure) as err:
        package.fuzz([3], run_fn=broken_build, shrink=True, check_determinism=False,
                     timeout_s=10)
    failure = err.value.report["failures"][0]
    assert failure["seed"] == 3 and failure["points"] == ["cache.write"]
    assert "--chaos-seed 3" in failure["reproducer"]
    assert "cache.write" in failure["reproducer"]
    assert f"python -m {package.__name__.split('.')[0]}.benchmark " in failure["reproducer"]


@pytest.mark.parametrize("package", [fuzz, jax_fuzz], ids=["port", "jax"])
def test_fuzz_green_run_reports_and_checks_determinism(package):
    calls = []

    def healthy(seed, points):
        calls.append(seed)
        return {"stream_digest": f"digest-{seed}",
                "failpoint_injections": [["transport.send", 5, "reset"]]}

    report = package.fuzz([1, 2], run_fn=healthy, check_determinism=True, timeout_s=10)
    assert report == {"seeds": [1, 2], "runs": 4, "failures": []}
    assert calls == [1, 1, 2, 2]


@pytest.mark.parametrize("package", [fuzz, jax_fuzz], ids=["port", "jax"])
def test_fuzz_flags_nondeterministic_digests(package):
    state = {"n": 0}

    def flappy(seed, points):
        state["n"] += 1
        return {"stream_digest": f"digest-{state['n']}", "failpoint_injections": []}

    with pytest.raises(package.FuzzFailure) as err:
        package.fuzz([9], run_fn=flappy, shrink=False, timeout_s=10)
    assert "digest-determinism" in str(err.value)
    assert err.value.report["failures"][0]["points"] == sorted(failpoints.POINTS)


@pytest.mark.parametrize("package", [fuzz, jax_fuzz], ids=["port", "jax"])
def test_fuzz_hung_run_is_bounded_and_reported(package):
    release = threading.Event()

    def hangs(seed, points):
        release.wait(30)
        return {}

    try:
        with pytest.raises(package.FuzzFailure) as err:
            package.fuzz([4], run_fn=hangs, shrink=False, check_determinism=False,
                         timeout_s=0.3)
        assert "hung" in str(err.value)
    finally:
        release.set()  # unblock the abandoned thread so it exits
        time.sleep(0.05)


def test_reproducer_is_the_jax_command_on_the_port_cli():
    points = ["transport.send", "shm-detach"]
    assert fuzz.reproducer_command(17, points) == jax_fuzz.reproducer_command(
        17, points).replace("petastorm_tpu.benchmark", "petastorm_tpu_torch.benchmark")


def _busy(result):
    return sorted(tuple(entry) for entry in result["failpoint_injections"]
                  if entry[0] in BUSY_POINTS)


def test_one_seed_through_both_packages_default_run_fn():
    port = fuzz.default_run_fn(12, None)
    jax_result = jax_fuzz.default_run_fn(12, None)
    for result in (port, jax_result):
        assert result["lost_rows"] == 0 and result["duplicate_rows"] == 0
    assert port["stream_digest"] == jax_result["stream_digest"]
    assert _busy(port) == _busy(jax_result)
    assert {entry[0] for entry in port["failpoint_injections"]} & {
        "transport.send", "transport.recv"}, "no transport fault fired"


@pytest.mark.parametrize("seed", [0, 1])
def test_hedged_run_closes_the_streams_it_drops(seed):
    """A hedge whose stream broke is dropped closed: its shm ring is
    unmapped (the leak guard above; a broken hedge stream once stayed
    mapped, in most runs of these two seeds), and the hedged stream is the
    JAX package's, every row once."""
    port = fuzz.hedged_run_fn(seed, None)
    jax_result = jax_fuzz.hedged_run_fn(seed, None)
    # How many hedges launch races the clock (0 in some runs): not checked.
    assert port["lost_rows"] == port["duplicate_rows"] == 0
    assert port["stream_digest"] == jax_result["stream_digest"]


def test_reproducer_replays_through_the_port_cli(capsys):
    points = ["transport.send", "transport.recv", "shm-detach"]
    direct = fuzz.default_run_fn(5, points)
    argv = shlex.split(fuzz.reproducer_command(5, points))
    assert argv[:3] == ["python", "-m", "petastorm_tpu_torch.benchmark"]
    assert port_cli.main(argv[3:]) == 0
    replay = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert replay["stream_digest"] == direct["stream_digest"]
    assert replay["lost_rows"] == replay["duplicate_rows"] == 0
    assert _busy(replay) == _busy(direct)


def test_decode_columnar_fallback_serves_the_same_arrays(tmp_path):
    """Both decode.columnar sites: under a schedule firing "fallback" on
    every call the columnar worker decodes per row and the wire encode
    sends a pickle, and the arrays are the vectorized path's."""
    import numpy as np

    from petastorm_tpu_torch.benchmark.scenarios import make_image_dataset
    from petastorm_tpu_torch.reader.reader import make_columnar_reader
    from petastorm_tpu_torch.reader_impl.framed_socket import (
        PAYLOAD_COLUMNAR,
        PAYLOAD_PICKLE,
        decode_payload,
        encode_payload,
    )

    url = f"file://{tmp_path}/images"
    make_image_dataset(url, rows=24, image_shape=(8, 8, 3))

    def read():
        with make_columnar_reader(url, num_epochs=1, shuffle_row_groups=False,
                                  reader_pool_type="dummy") as reader:
            return [{k: np.asarray(v) for k, v in b._asdict().items()} for b in reader]

    batch = {"ids": np.arange(6, dtype=np.int32)}
    plain, (plain_fmt, _) = read(), encode_payload(batch)
    schedule = failpoints.FaultSchedule(
        0, points=["decode.columnar"],
        fires={"decode.columnar": {i: "fallback" for i in range(1000)}})
    with failpoints.armed(schedule):
        fallback = read()
        fmt, frames = encode_payload(batch)
    assert (plain_fmt, fmt) == (PAYLOAD_COLUMNAR, PAYLOAD_PICKLE)
    assert np.array_equal(decode_payload(fmt, frames)["ids"], batch["ids"])
    assert len(schedule.log) == len(plain) + 1
    assert len(fallback) == len(plain) > 0
    for a, b in zip(plain, fallback):
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name


@pytest.mark.slow
def test_fuzz_soak_twenty_seeds_green():
    report = fuzz.fuzz(range(20), check_determinism=True, timeout_s=fuzz.DEFAULT_RUN_TIMEOUT_S)
    assert report["failures"] == [] and report["runs"] == 40


@pytest.mark.slow
def test_fuzz_soak_twenty_seeds_green_hedged():
    report = fuzz.fuzz(range(20), run_fn=fuzz.hedged_run_fn, check_determinism=True,
                       timeout_s=fuzz.DEFAULT_RUN_TIMEOUT_S)
    assert report["failures"] == [] and report["runs"] == 40
