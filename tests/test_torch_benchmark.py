"""The port's throughput tool and scenario suite
(``petastorm_tpu_torch/benchmark/``) against the JAX package's
(``petastorm_tpu/benchmark/``), on the CPU.

Each case mirrors one of ``tests/test_scenarios.py`` or
``tests/test_cli_tools.py`` and runs the same seeded scenario through both
packages, the port at ``device="cpu"``. Counts, row groups, windows,
batches, mix ratios, utilizations and the ordered service stream's digest
are compared exactly (the same seeds draw the same data and the same
samples); rates are times and are only checked positive. The device legs
default to ``"cuda"`` and raise here.
"""

import json
import re

import jax
import numpy as np
import pytest
import torch

from petastorm_tpu.benchmark import cli as jax_cli
from petastorm_tpu.benchmark import device_scaling as jax_scaling
from petastorm_tpu.benchmark import scenarios as jax_scenarios
from petastorm_tpu.benchmark.throughput import reader_throughput as jax_reader_throughput
from petastorm_tpu_torch.benchmark import cli as port_cli
from petastorm_tpu_torch.benchmark import device_scaling as port_scaling
from petastorm_tpu_torch.benchmark import scenarios as port_scenarios
from petastorm_tpu_torch.benchmark.throughput import reader_throughput
from petastorm_tpu_torch.cache_impl import live_cache_dirs
from petastorm_tpu_torch.service.shm_ring import live_shm_counts

#: The keys of a result that are times or rates of this run.
TIMED = re.compile(r"per_sec|_speedup|_vs_|vs_baseline|wall|_s$|stall|overlap|"
                   r"time_to|^value$|telemetry|rows_per_s")


@pytest.fixture(autouse=True)
def _port_leak_guard():
    """Every ring, cache directory and schedule a port scenario opens is
    closed by its end (the conftest guards watch the JAX registries)."""
    from petastorm_tpu_torch import failpoints

    shm_before, dirs_before = live_shm_counts(), set(live_cache_dirs())
    yield
    assert failpoints.ACTIVE is None
    assert live_shm_counts() == shm_before
    assert set(live_cache_dirs()) == dirs_before


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card behavior")


def _untimed(result):
    """``result`` without its times and rates (in nested records too)."""
    if isinstance(result, list):
        return [_untimed(item) for item in result]
    if not isinstance(result, dict):
        return result
    return {k: _untimed(v) for k, v in result.items() if not TIMED.search(k)}


def _both(name, **kwargs):
    """``(port result, JAX result)`` of scenario ``name`` on ``kwargs``."""
    port_kwargs = dict(kwargs, device="cpu") if name == "image" else kwargs
    return (port_scenarios.SCENARIOS[name](**port_kwargs),
            jax_scenarios.SCENARIOS[name](**kwargs))


def test_the_packages_have_the_same_scenarios():
    assert sorted(port_scenarios.SCENARIOS) == sorted(jax_scenarios.SCENARIOS)


def test_tabular_scenario_prunes_row_groups():
    port, jax_result = _both("tabular", rows=4000, days=4, workers=2)
    assert sorted(port) == sorted(jax_result)
    assert _untimed(port) == _untimed(jax_result)
    assert port["rows"] == 4000
    assert (port["full_scan_rowgroups"], port["pushdown_rowgroups"]) == (4, 1)
    assert port["rowgroups_pruned_pct"] == 75.0
    assert port["full_scan_rows_per_sec"] > 0 and port["pushdown_rows_per_sec"] > 0


def test_ngram_scenario_counts_windows():
    port, jax_result = _both("ngram", frames=200, window=3, workers=2)
    assert _untimed(port) == _untimed(jax_result)
    assert port["windows"] == 198 and port["windows_per_sec"] > 0


def test_image_scenario_reports_both_decode_paths():
    port, jax_result = _both("image", rows=256, workers=2, batch_size=64)
    assert sorted(port) == sorted(jax_result)
    assert _untimed(port) == _untimed(jax_result)
    assert port["loader_batches"] == 256 // 64 and port["rows"] == 256
    assert port["row_decode_images_per_sec"] > 0
    assert port["columnar_decode_images_per_sec"] > 0
    assert 0 <= port["loader_input_stall_pct"] <= 100


def test_image_scenario_device_stage_leg(tmp_path):
    kwargs = dict(rows=256, workers=2, batch_size=64, device_stage="on", device_prefetch=3)
    port = port_scenarios.image_pipeline_scenario(device="cpu", json_out=str(tmp_path / "p"),
                                                  **kwargs)
    jax_result = jax_scenarios.image_pipeline_scenario(**kwargs)
    assert sorted(port) == sorted(jax_result)
    assert ({k: v for k, v in _untimed(port).items() if k != "h2d_bytes_per_image"}
            == {k: v for k, v in _untimed(jax_result).items() if k != "h2d_bytes_per_image"})
    assert (port["device_stage"], port["device_prefetch"]) == ("on", 3)
    assert port["device_stage_images_per_sec"] > 0
    assert 0 <= port["device_stage_input_stall_pct"] <= 100
    assert 0 <= port["dispatch_overlap_pct"] <= 100
    # h2d_bytes counts bytes copied to a CUDA device: none on the CPU (the
    # card's figure, ~one uint8 image a row, is chip_smoke.py's to check).
    assert port["h2d_bytes_per_image"] == 0.0
    assert json.loads((tmp_path / "p").read_text().strip()) == port


def test_image_scenario_rejects_bad_device_stage():
    with pytest.raises(ValueError, match="on|off"):
        port_scenarios.image_pipeline_scenario(rows=64, batch_size=32, device_stage="wat")


def test_weighted_scenario_tracks_target_mix():
    port, jax_result = _both("weighted", rows=2048, workers=1, weights=(0.75, 0.25))
    # One random_seed draws the same corpus sequence in both packages.
    assert _untimed(port) == _untimed(jax_result)
    assert port["rows_drawn"] == 2048 and port["rows_per_sec"] > 0
    assert abs(port["empirical_mix"][0] - 0.75) < 0.05


def test_converter_mixing_scenario_end_to_end():
    port, jax_result = _both("converter_mixing", rows=4096, weights=(0.7, 0.3),
                             batch_size=128, batches=32, workers=1)
    # Arrow tables in the port, pandas frames in JAX: the same rows, so the
    # same per-corpus counts (mix) from the same seeds.
    assert _untimed(port) == _untimed(jax_result)
    assert port["batches"] == 32 and port["rows_drawn"] == 32 * 128
    assert abs(port["empirical_mix"][0] - 0.7) < 0.15


def test_packed_delivery_scenario_beats_padded_utilization():
    port, jax_result = _both("packed", docs=256, max_len=24, slot_len=48, slots=4)
    assert _untimed(port) == _untimed(jax_result)
    for key in ("docs", "batches", "packed_utilization", "padded_utilization"):
        assert port[key] == jax_result[key], key
    assert port["batches"] > 0 and port["tokens_per_sec"] > 0
    assert port["packed_utilization"] > port["padded_utilization"]


@pytest.mark.parametrize("knobs", [{}, {"transport": "tcp"}, {"brownout": True}],
                         ids=["auto", "tcp", "brownout"])
def test_service_scenario_streams_through_loopback_fleet(tmp_path, knobs):
    kwargs = dict(rows=2000, days=4, workers=2, batch_size=128, shuffle_seed=7,
                  ordered=True, **knobs)
    port = port_scenarios.service_loopback_scenario(json_out=str(tmp_path / "p"), **kwargs)
    jax_result = jax_scenarios.service_loopback_scenario(**kwargs)
    assert sorted(port) == sorted(jax_result)
    # The ordered stream is the same bytes in both packages.
    assert port["stream_digest"] == jax_result["stream_digest"]
    assert _untimed(port) == _untimed(jax_result)
    assert port["rows"] == 2000 and port["duplicates_dropped"] == 0
    assert port["metric"] == "service_rows_per_sec" and port["unit"] == "rows/sec"
    assert port["value"] == port["service_rows_per_sec"] > 0
    assert port["vs_baseline"] == port["service_vs_local"]
    assert sorted(port["per_worker_batches"]) == ["bench-worker-0", "bench-worker-1"]
    assert sum(port["per_worker_batches"].values()) == port["batches"]
    assert json.loads((tmp_path / "p").read_text().strip()) == port


def test_service_scenario_chaos_refusals_match():
    for kwargs in ({"chaos": "wat"}, {"chaos": "worker-kill", "mode": "fcfs"},
                   {"chaos": "failpoints", "predicate": "day:eq:1"},
                   {"fleet_cache": True}, {"epochs": 0}):
        with pytest.raises(ValueError) as port_err:
            port_scenarios.service_loopback_scenario(rows=16, days=2, **kwargs)
        with pytest.raises(ValueError) as jax_err:
            jax_scenarios.service_loopback_scenario(rows=16, days=2, **kwargs)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("spec", ["sample_index:mod-eq:0:4", "day:in:1,2", "label:ge:0.5",
                                  "cat_0:ne:abc"])
def test_parse_predicate_matches(spec):
    assert (port_scenarios._parse_predicate(spec).to_wire()
            == jax_scenarios._parse_predicate(spec).to_wire())


@pytest.mark.parametrize("builder", ["tabular", "ngram", "image"])
def test_store_builders_write_equal_rows(tmp_path, builder):
    from petastorm_tpu_torch.reader.reader import make_batch_reader, make_reader

    port_url, jax_url = f"file://{tmp_path}/port", f"file://{tmp_path}/jax"
    if builder == "tabular":
        assert (port_scenarios.make_tabular_dataset(port_url, rows=800, days=4)
                == jax_scenarios.make_tabular_dataset(jax_url, rows=800, days=4) == 800)
    elif builder == "ngram":
        port_scenarios.make_ngram_dataset(port_url, frames=40)
        jax_scenarios.make_ngram_dataset(jax_url, frames=40)
    else:
        port_scenarios.make_image_dataset(port_url, rows=40)
        jax_scenarios.make_image_dataset(jax_url, rows=40)
    factory = make_batch_reader if builder == "tabular" else make_reader

    def rows(url, **kwargs):
        with factory(url, num_epochs=1, shuffle_row_groups=False,
                     reader_pool_type="dummy", **kwargs) as reader:
            if builder == "tabular":
                got = [dict(zip(b._fields, (np.asarray(c)[i] for c in b)))
                       for b in reader for i in range(len(b[0]))]
            else:
                got = [r._asdict() for r in reader]
        key = "sample_index" if builder == "tabular" else ("ts" if builder == "ngram" else "id")
        return sorted(got, key=lambda r: int(r[key]))

    port_rows, jax_rows = rows(port_url), rows(jax_url)
    assert len(port_rows) == len(jax_rows) > 0
    for a, b in zip(port_rows, jax_rows):
        assert sorted(a) == sorted(b)
        for name in a:
            assert np.array_equal(np.asarray(a[name]), np.asarray(b[name])), name
    if builder == "tabular":
        # The pushdown scan's matched rows: one day's, the same in both.
        from petastorm_tpu.reader.reader import make_batch_reader as jax_batch_reader

        def matched(open_reader, url):
            with open_reader(url, num_epochs=1, shuffle_row_groups=False,
                             reader_pool_type="dummy", filters=[("day", "=", 1)]) as reader:
                return sorted(int(i) for b in reader for i in np.asarray(b.sample_index))

        assert matched(make_batch_reader, jax_url) == matched(jax_batch_reader, jax_url) \
            == list(range(200, 400))


# -- reader_throughput and its CLI (tests/test_cli_tools.py) -------------------

def test_reader_throughput_python(petastorm_dataset):
    kwargs = dict(pool_type="dummy", warmup_cycles_count=5, measure_cycles_count=20)
    port = reader_throughput(petastorm_dataset.url, **kwargs)
    jax_result = jax_reader_throughput(petastorm_dataset.url, **kwargs)
    assert port.rows_count == jax_result.rows_count == 20
    assert port.rows_per_second > 0
    assert port.input_stall_pct is None and jax_result.input_stall_pct is None


def test_reader_throughput_torch_loader(scalar_dataset):
    kwargs = dict(pool_type="dummy", read_method="arrow", warmup_cycles_count=1,
                  measure_cycles_count=2)
    port = reader_throughput(scalar_dataset.url, apply_torch_loader=True, torch_batch_size=5,
                             device="cpu", **kwargs)
    jax_result = jax_reader_throughput(scalar_dataset.url, apply_jax_loader=True,
                                       jax_batch_size=5, **kwargs)
    assert port.rows_count == jax_result.rows_count == 10
    assert port.rows_per_second > 0
    # Read after the loader's iteration closed: a real, positive wait.
    assert port.input_stall_pct is not None and port.input_stall_pct > 0.0


@pytest.mark.parametrize("name", ["apply_jax_loader", "jax_batch_size"])
def test_reader_throughput_refuses_the_jax_spellings(scalar_dataset, name):
    with pytest.raises(NotImplementedError, match="the port's is (apply_torch_loader|torch_batch_size)$"):
        reader_throughput(scalar_dataset.url, **{name: True})


def test_benchmark_cli(petastorm_dataset, capsys):
    line = re.compile(r"^\d+\.\d rows/sec \(10 rows in \d+\.\d\ds\)$")
    argv = [petastorm_dataset.url, "-p", "dummy", "-w", "2", "-m", "10"]
    assert port_cli.main(argv) == 0
    port_out = capsys.readouterr().out.strip()
    assert jax_cli.main(argv) == 0
    jax_out = capsys.readouterr().out.strip()
    assert line.match(port_out) and line.match(jax_out), (port_out, jax_out)


def test_benchmark_cli_torch_loader_line(scalar_dataset, capsys):
    assert port_cli.main([scalar_dataset.url, "-p", "dummy", "--read-method", "arrow",
                          "-w", "1", "-m", "2", "--torch-loader", "--torch-batch-size", "5",
                          "--device", "cpu"]) == 0
    assert re.match(r"^\d+\.\d rows/sec \(10 rows in \d+\.\d\ds, input_stall=\d+\.\d\d%\)$",
                    capsys.readouterr().out.strip())


@pytest.mark.parametrize("flag,port_flag", [(["--jax-loader"], "--torch-loader"),
                                            (["--jax-batch-size", "5"], "--torch-batch-size")])
def test_benchmark_cli_refuses_the_jax_flags(capsys, flag, port_flag):
    with pytest.raises(SystemExit):
        port_cli.main(["file:///nowhere"] + flag)
    assert f"the port's is {port_flag}" in capsys.readouterr().err


# -- the scenario CLI (tests/test_scenarios.py) ---------------------------------

def test_scenario_cli_prints_json(capsys, monkeypatch):
    monkeypatch.setitem(port_scenarios.SCENARIOS, "tabular",
                        lambda dataset_url=None, workers=3: {"ok": True})
    assert port_cli.main(["scenario", "tabular"]) == 0
    out = capsys.readouterr().out.strip()
    assert len(out.splitlines()) == 1 and json.loads(out) == {"ok": True}


@pytest.mark.parametrize("argv", [["scenario", "ngram", "--batch-size", "64"],
                                  ["scenario", "tabular", "--device-stage", "on"],
                                  ["scenario", "packed", "--chaos", "failpoints"]])
def test_scenario_cli_rejects_knobs_the_scenario_lacks(capsys, argv):
    with pytest.raises(SystemExit):
        port_cli.main(argv)
    port_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit):
        jax_cli.main(argv)
    jax_err = capsys.readouterr().err.splitlines()[-1]
    assert "not a knob" in port_err
    assert port_err.split("error: ")[1] == jax_err.split("error: ")[1]


def test_scenario_cli_device_is_a_knob_of_the_image_scenario_only(capsys, monkeypatch):
    with pytest.raises(SystemExit):
        port_cli.main(["scenario", "tabular", "--device", "cpu"])
    assert "--device is not a knob of the 'tabular' scenario" in capsys.readouterr().err
    seen = {}

    def fake(dataset_url=None, workers=3, device_stage="off", device_prefetch=2,
             device="cuda"):
        seen.update(device_stage=device_stage, device_prefetch=device_prefetch, device=device)
        return {"ok": True}

    monkeypatch.setitem(port_scenarios.SCENARIOS, "image", fake)
    assert port_cli.main(["scenario", "image", "--device-stage", "on",
                          "--device-prefetch", "4", "--device", "cpu"]) == 0
    assert seen == {"device_stage": "on", "device_prefetch": 4, "device": "cpu"}
    assert json.loads(capsys.readouterr().out.strip()) == {"ok": True}


def test_scenario_cli_forwards_service_knobs(capsys, monkeypatch):
    seen = {}

    def fake(dataset_url=None, workers=3, skew_ms=0.0, credits=8, json_out=None):
        seen.update(skew_ms=skew_ms, credits=credits)
        return {"ok": True}

    monkeypatch.setitem(port_scenarios.SCENARIOS, "service", fake)
    assert port_cli.main(["scenario", "service", "--skew-ms", "250", "--credits", "4"]) == 0
    assert seen == {"skew_ms": 250.0, "credits": 4}
    assert json.loads(capsys.readouterr().out.strip()) == {"ok": True}


def test_scenario_cli_runs_a_scenario_end_to_end(capsys):
    argv = ["scenario", "service", "--rows", "600", "--days", "3", "--workers", "2",
            "--batch-size", "64", "--shuffle-seed", "7", "--ordered", "--transport", "tcp"]
    assert port_cli.main(argv) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(argv) == 0
    jax_result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port["stream_digest"] == jax_result["stream_digest"]
    assert port["rows"] == 600 and port["transport"] == "tcp"


# -- device scaling --------------------------------------------------------------

def test_device_stage_scaling_keys_at_one_device():
    kwargs = dict(device_counts=(1,), per_device_batch=8, steps=3, image_shape=(8, 8, 3),
                  repeats=1)
    port = port_scaling.measure_device_stage_scaling(device="cpu", **kwargs)
    jax_result = jax_scaling.measure_device_stage_scaling(**kwargs)
    assert sorted(port) == sorted(jax_result)
    assert port["scaling"] == 1.0 and port["decode_kernel_scaling"] == 1.0
    assert port["device_counts"] == [1] and port["device_platform"] == "cpu"
    assert port["rows_per_sec"]["1"] > 0 and port["decode_kernel_rows_per_sec"]["1"] > 0
    for key in ("per_device_batch", "steps", "image_shape", "device_counts",
                "scaling_devices", "metric"):
        assert port[key] == jax_result[key], key


def test_device_stage_scaling_refuses_more_devices_than_at_hand():
    with pytest.raises(RuntimeError, match=r"^scaling sweep needs 2 devices, have 1$"):
        port_scaling.measure_device_stage_scaling(device_counts=(1, 2), device="cpu")
    have = len(jax.devices())
    with pytest.raises(RuntimeError,
                       match=rf"^scaling sweep needs {have + 1} devices, have {have}$"):
        jax_scaling.measure_device_stage_scaling(device_counts=(1, have + 1))


# -- no silent CPU fallback --------------------------------------------------------

def test_device_entry_points_default_to_cuda_and_raise_without_it(no_cuda, scalar_dataset):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reader_throughput(scalar_dataset.url, apply_torch_loader=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_scenarios.image_pipeline_scenario(rows=64, batch_size=32, device_stage="on")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_scaling.measure_device_stage_scaling(device_counts=(1,))
