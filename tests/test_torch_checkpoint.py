"""The port's joint model + input-pipeline checkpoint: the protocol cases of
``tests/test_checkpoint.py`` against ``petastorm_tpu_torch.torch_utils.
checkpoint``, the input state of a directory the JAX package saved, and a
two-process gloo run (a ``FileStore`` under ``tmp_path``, one spawn for the
file): a save and restore over the group, and a save in which the first
rank reads a stale ``CURRENT``. There the version must be agreed on the
MAX of the ranks' next numbers, so a crash injected after the clean step
leaves the published checkpoint intact (with the first rank's number, the
JAX package's rule, that rank would clear the published version first).
Arrays are compared exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.torch_utils import checkpoint as cp
from petastorm_tpu_torch.torch_utils.checkpoint import (
    restore_input_state,
    restore_training_state,
    save_training_state,
)
from petastorm_tpu_torch.torch_utils.mesh import run_ranks


def _current_version_dir(ckpt):
    with open(os.path.join(ckpt, "CURRENT")) as f:
        return os.path.join(ckpt, f.read().strip())


def test_roundtrip_arrays_and_input_state(tmp_path, petastorm_dataset):
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    arrays = {"w": torch.arange(6.0).reshape(2, 3), "model": {"b": torch.ones(3)}}
    kw = dict(schema_fields=["id"], reader_pool_type="dummy", num_epochs=1,
              shuffle_row_groups=False)
    with make_torch_dataloader(make_reader(petastorm_dataset.url, **kw), 10,
                               device="cpu") as loader:
        consumed = [int(i) for i in next(iter(loader))["id"]]
        ckpt = save_training_state(tmp_path / "ckpt", arrays, loader=loader)
    restored, state = restore_training_state(ckpt)
    assert torch.equal(restored["w"], arrays["w"])
    assert torch.equal(restored["model"]["b"], arrays["model"]["b"])
    assert state["delivered"] == {"0:0": 1}
    with make_torch_dataloader(make_reader(petastorm_dataset.url, resume_state=state, **kw),
                               10, device="cpu") as loader:
        resumed = [int(i) for b in loader for i in b["id"]]
    assert sorted(consumed + resumed) == list(range(30))


def test_save_rejects_both_loader_and_state(tmp_path):
    with pytest.raises(ValueError, match="loader OR input_state"):
        save_training_state(tmp_path / "c", {"x": torch.zeros(2)}, loader=object(),
                            input_state={})


def test_restore_without_input_state(tmp_path):
    ckpt = save_training_state(tmp_path / "c", {"x": torch.arange(4.0)})
    arrays, state = restore_training_state(ckpt)
    assert torch.equal(arrays["x"], torch.arange(4.0)) and state is None


def test_restore_rejects_torn_checkpoint(tmp_path):
    ckpt = save_training_state(tmp_path / "c", {"x": torch.arange(4.0)},
                               input_state={"kind": "reader", "v": 1})
    vdir = _current_version_dir(ckpt)
    markers = [f for f in os.listdir(vdir) if f.startswith("COMMITTED.")]
    assert markers == ["COMMITTED.0"]
    os.remove(os.path.join(vdir, markers[0]))
    with pytest.raises(RuntimeError, match="torn"):
        restore_training_state(ckpt)


def test_restore_rejects_host_count_mismatch(tmp_path, monkeypatch):
    ckpt = save_training_state(tmp_path / "c", {"x": torch.arange(4.0)},
                               input_state={"step": 1})
    monkeypatch.setattr(cp, "_world", lambda group: 4)
    with pytest.raises(RuntimeError, match="saved by 1 rank"):
        restore_training_state(ckpt)


def test_unpublished_directory_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no published checkpoint"):
        restore_training_state(tmp_path / "nothing_here")


def test_prune_spares_user_directories(tmp_path):
    ckpt = save_training_state(tmp_path / "c", {"x": torch.arange(4.0)})
    os.makedirs(os.path.join(ckpt, "vocab"))
    os.makedirs(os.path.join(ckpt, "v1_backup"))
    save_training_state(tmp_path / "c", {"x": torch.arange(4.0) * 2})
    assert os.path.isdir(os.path.join(ckpt, "vocab"))
    assert os.path.isdir(os.path.join(ckpt, "v1_backup"))
    assert not os.path.exists(os.path.join(ckpt, "v1"))
    arrays, _ = restore_training_state(ckpt)
    assert torch.equal(arrays["x"], torch.arange(4.0) * 2)


def test_resave_over_existing_checkpoint_stays_committed(tmp_path):
    save_training_state(tmp_path / "c", {"x": torch.arange(4.0)}, input_state={"step": 1})
    ckpt = save_training_state(tmp_path / "c", {"x": torch.arange(4.0) * 2},
                               input_state={"step": 2})
    arrays, state = restore_training_state(ckpt)
    assert torch.equal(arrays["x"], torch.arange(4.0) * 2) and state == {"step": 2}
    assert _current_version_dir(ckpt).endswith("v2")


def test_refused_save_leaves_existing_checkpoint_intact(tmp_path):
    ckpt = save_training_state(tmp_path / "c", {"x": torch.arange(4.0)},
                               input_state={"step": 1})
    with pytest.raises(ValueError, match="already exists"):
        save_training_state(tmp_path / "c", {"x": torch.arange(4.0) * 2},
                            input_state={"step": 2}, force=False)
    arrays, state = restore_training_state(ckpt)
    assert torch.equal(arrays["x"], torch.arange(4.0)) and state == {"step": 1}


def test_crash_during_overwrite_preserves_last_good_checkpoint(tmp_path, monkeypatch):
    ckpt = save_training_state(tmp_path / "c", {"x": torch.arange(4.0)},
                               input_state={"step": 1})
    real_write = cp._write_checkpoint

    def crashing_write(vdir, arrays, input_state, group):
        real_write(vdir, arrays, None, group)  # the arrays land...
        raise RuntimeError("preempted")        # ...the save never completes

    monkeypatch.setattr(cp, "_write_checkpoint", crashing_write)
    with pytest.raises(RuntimeError, match="preempted"):
        save_training_state(tmp_path / "c", {"x": torch.arange(4.0) * 2},
                            input_state={"step": 2})
    monkeypatch.undo()
    arrays, state = restore_training_state(ckpt)
    assert torch.equal(arrays["x"], torch.arange(4.0)) and state == {"step": 1}
    save_training_state(tmp_path / "c", {"x": torch.arange(4.0) * 5}, input_state={"step": 3})
    arrays, state = restore_training_state(ckpt)
    assert torch.equal(arrays["x"], torch.arange(4.0) * 5) and state == {"step": 3}
    # The crashed v2 was cleared and rewritten; v1 was pruned.
    assert [n for n in os.listdir(ckpt) if os.path.isdir(os.path.join(ckpt, n))] == ["v2"]


def test_jax_saved_directory_gives_the_same_input_state(tmp_path):
    """The port reads CURRENT and the input-state file of a checkpoint the
    JAX package wrote (its arrays are orbax's and are not read across)."""
    from petastorm_tpu.jax_utils.checkpoint import (
        restore_training_state as jax_restore,
        save_training_state as jax_save,
    )

    state = {"version": 1, "delivered": {"3:0": 2}, "shard": [None, None, 7]}
    for step in (1, 2):
        ckpt = jax_save(str(tmp_path / "jax"), {"x": np.arange(4.0) * step},
                        input_state={**state, "step": step})
    vdir, got = restore_input_state(ckpt)
    _, want = jax_restore(ckpt)
    assert got == want == {**state, "step": 2}
    assert vdir == _current_version_dir(ckpt) and vdir.endswith("v2")
    os.remove(os.path.join(vdir, "COMMITTED.0"))
    with pytest.raises(RuntimeError, match="torn"):
        restore_input_state(ckpt)


# --- two processes -----------------------------------------------------------

WORLD = 2


def _rank_main(rank, out_dir, stale_dir):
    import torch.distributed as dist

    group = dist.group.WORLD
    results = {}
    # A save and restore over the group, twice (v1, then v2).
    shared = os.path.join(out_dir, "shared")
    for step in (1, 2):
        save_training_state(shared, {"w": torch.arange(4.0) * step},
                            input_state={"rank": rank, "step": step}, group=group)
    arrays, state = restore_training_state(shared, group=group)
    results["shared"] = {"w": arrays["w"].tolist(), "state": state,
                         "current": os.path.basename(_current_version_dir(shared))}
    # The first rank reads a stale CURRENT (v1 where v2 is published),
    # and the save crashes after the clean step on every rank.
    real_read, real_agree = cp._read_current, cp._agree_version
    if rank == 0:
        cp._read_current = lambda directory: "v1"
    agreed = []
    cp._agree_version = lambda n, g: agreed.append(real_agree(n, g)) or agreed[-1]

    def crash(vdir, arrays, input_state, group):
        raise RuntimeError("preempted")

    cp._write_checkpoint = crash
    try:
        save_training_state(stale_dir, {"w": torch.zeros(4)}, input_state={"step": 9},
                            group=group)
    except RuntimeError as exc:
        results["crash"] = str(exc)
    cp._read_current, cp._agree_version = real_read, real_agree
    results["agreed"] = agreed
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(results, f)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results from one spawned gloo run, and the stale run's
    directory (published v2 by one process beforehand)."""
    tmp = tmp_path_factory.mktemp("ckpt_group")
    stale_dir = str(tmp / "stale")
    for step in (1, 2):
        save_training_state(stale_dir, {"w": torch.arange(4.0) * step},
                            input_state={"step": step})
    try:
        run_ranks(_rank_main, WORLD, str(tmp), args=(str(tmp), stale_dir), timeout_s=120)
    except RuntimeError as exc:
        pytest.fail(str(exc))
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return ranks, str(tmp / "shared"), stale_dir


def test_group_save_restores_each_ranks_input_state(two_ranks):
    ranks, shared, _ = two_ranks
    for rank, results in enumerate(ranks):
        assert results["shared"] == {"w": [0.0, 2.0, 4.0, 6.0],
                                     "state": {"rank": rank, "step": 2}, "current": "v2"}
    vdir = _current_version_dir(shared)
    assert sorted(n for n in os.listdir(vdir) if not os.path.isdir(os.path.join(vdir, n))) \
        == ["COMMITTED.0", "COMMITTED.1", "input_state.0.json", "input_state.1.json"]
    with pytest.raises(RuntimeError, match="saved by 2 rank"):
        restore_training_state(shared)   # one process cannot restore two ranks' state


def test_version_is_agreed_on_the_max_of_the_ranks(two_ranks):
    ranks, _, _ = two_ranks
    # The first rank read v1 (next 2), the second v2 (next 3): both take 3.
    assert [r["agreed"] for r in ranks] == [[3], [3]]
    assert [r["crash"] for r in ranks] == ["preempted", "preempted"]


def test_published_checkpoint_survives_a_crash_after_the_clean_step(two_ranks):
    _, _, stale_dir = two_ranks
    arrays, state = restore_training_state(stale_dir)
    assert torch.equal(arrays["w"], torch.arange(4.0) * 2) and state == {"step": 2}
    assert _current_version_dir(stale_dir).endswith("v2")
