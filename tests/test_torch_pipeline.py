"""The port's pipeline (``petastorm_tpu_torch/models/pipeline.py``: GPipe
and the fused 1F1B schedule) against the JAX package's
(``petastorm_tpu/models/pipeline.py``), case for case after
``tests/test_pipeline.py``.

One spawned run of four gloo ranks (a ``FileStore`` under ``tmp_path``,
CPU tensors) runs every case at two layouts, pp = 4 and (data 2, pp 2),
the stack holding one stage a rank (4 or 2 stages), on the same seeded
numpy inputs (the JAX ``init_pipeline_params`` pytree); each rank keeps its
stage (``shard_params``). Each case is held against the JAX sharded run on
a mesh of the same shape and against the sequential stack
(``reference_forward``, ``jax.grad`` of its loss).

Tolerances are ``tests/test_pipeline.py``'s: forward rtol / atol 1e-5,
gradients rtol 1e-4 / atol 1e-5, 1F1B's loss 1e-6 relative to the
sequential one and one 1F1B step's parameters rtol 1e-5 / atol 1e-6 to
GPipe's; five train steps' losses 1e-5 and parameters at the gradients'
tolerance.
"""

import functools

import numpy as np
import pytest
import torch

WORLD = 4
#: layout -> (axis sizes, axis names, batch_axis)
LAYOUTS = {"pp4": ((4,), ("pp",), None), "dp2_pp2": ((2, 2), ("data", "pp"), "data")}
#: case -> (params seed, batch, microbatches, kind, options)
CASES = {
    "forward": (0, 8, 4, "forward", {}),
    "forward_more_microbatches": (1, 16, 8, "forward", {}),
    "gradients": (2, 8, 4, "grads", {}),
    "train_gpipe": (3, 8, 4, "train", dict(schedule="gpipe")),
    "train_1f1b": (14, 16, 8, "train", dict(schedule="1f1b")),
    "1f1b_slot_reuse": (11, 32, 16, "1f1b", {}),
    "1f1b_vs_gpipe": (13, 16, 8, "1f1b_vs_gpipe", {}),
}
TRAIN_STEPS = 5


def _stages(layout):
    sizes, names, _ = LAYOUTS[layout]
    return sizes[names.index("pp")]


def _jax_params(num_stages, seed):
    import jax

    from petastorm_tpu.models.pipeline import init_pipeline_params

    return jax.tree_util.tree_map(np.asarray, init_pipeline_params(
        jax.random.PRNGKey(seed), feature_dim=6, d_model=16, d_hidden=32,
        num_stages=num_stages, num_classes=3))


def _batch(seed, b):
    """Features, labels and a mask with a quarter of the rows padded, as
    ``tests/test_pipeline.py``'s ``_grad_case``."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 6).astype(np.float32), rng.randint(0, 3, b).astype(np.int32),
            rng.rand(b) > 0.25)


@functools.lru_cache(maxsize=None)
def _inputs():
    return {layout: {name: {"params": _jax_params(_stages(layout), seed),
                            "batch": _batch(seed, b)}
                     for name, (seed, b, _, _, _) in CASES.items()}
            for layout in LAYOUTS}


def _run_layout(layout, inputs):
    """Every case at one layout, on this rank; returns its results."""
    from petastorm_tpu_torch.models import pipeline as pl
    from petastorm_tpu_torch.models.image_classifier import masked_cross_entropy
    from petastorm_tpu_torch.torch_utils.mesh import Mesh, shard_bytes, shard_params

    sizes, names, batch_axis = LAYOUTS[layout]
    mesh = Mesh(sizes, names)
    specs = pl.pipeline_param_partition_specs()

    def local(params):
        return shard_params(pl.params_from_jax(params, device="cpu"), specs, mesh)

    out = {}
    for name, (_, _, m, kind, opts) in CASES.items():
        params = local(inputs[layout][name]["params"])
        x, labels, mask = (torch.from_numpy(a) for a in inputs[layout][name]["batch"])
        kw = dict(num_microbatches=m, batch_axis=batch_axis)
        if kind == "forward":
            out[name] = pl.apply_pipeline_model(params, x, mesh, **kw).detach()
        elif kind == "grads":
            leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
            ones = torch.ones_like(mask)
            masked_cross_entropy(pl.apply_pipeline_model(leaves, x, mesh, **kw), labels,
                                 ones).backward()
            out[name] = {k: v.grad for k, v in leaves.items()}
        elif kind == "train":
            step = pl.make_pipeline_train_step(0.1, mesh=mesh, schedule=opts["schedule"], **kw)
            losses = []
            for _ in range(TRAIN_STEPS):
                params, loss = step(params, x, labels, torch.ones_like(mask))
                losses.append(loss)
            out[name] = {"losses": torch.stack(losses), "params": params,
                         "bytes": shard_bytes(params)}
        elif kind == "1f1b":
            out[name] = pl.pipeline_1f1b_loss_and_grads(params, x, labels, mask, mesh, **kw)
        else:
            out[name] = {schedule: pl.make_pipeline_train_step(
                0.05, mesh=mesh, schedule=schedule, **kw)(params, x, labels, mask)
                for schedule in ("gpipe", "1f1b")}
    errors = []
    full = pl.params_from_jax(_jax_params(2 * _stages(layout), 0), device="cpu")
    good = local(inputs[layout]["forward"]["params"])
    for call in (lambda: local(_jax_params(_stages(layout) // 2, 0)),
                 lambda: pl.apply_pipeline_model(shard_params(full, specs, mesh),
                                                 torch.zeros(8, 6), mesh, num_microbatches=4,
                                                 batch_axis=batch_axis),
                 lambda: pl.apply_pipeline_model(good, torch.zeros(7, 6), mesh,
                                                 num_microbatches=4, batch_axis=batch_axis),
                 lambda: pl.pipeline_1f1b_loss_and_grads(
                     good, torch.zeros(12, 6), torch.zeros(12, dtype=torch.int32),
                     torch.ones(12, dtype=torch.bool), mesh, num_microbatches=4,
                     batch_axis="data" if batch_axis else None)):
        try:
            call()
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    out["errors"] = errors
    return out


def _rank_main(rank, out_dir):
    torch.set_num_threads(1)  # four ranks of tiny products: threads only contend
    inputs = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
    torch.save({layout: _run_layout(layout, inputs) for layout in LAYOUTS},
               f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every rank's results from one spawned gloo run."""
    from petastorm_tpu_torch.torch_utils.mesh import run_ranks

    tmp = tmp_path_factory.mktemp("pipeline")
    torch.save(_inputs(), tmp / "inputs.pt")
    try:
        run_ranks(_rank_main, WORLD, str(tmp), args=(str(tmp),), timeout_s=300)
    except RuntimeError as exc:
        pytest.fail(str(exc))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _mesh(layout):
    import jax
    from jax.sharding import Mesh

    sizes, names, _ = LAYOUTS[layout]
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(sizes), names)


def _seq_loss(params, feats, labels, mask):
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models.pipeline import reference_forward

    logp = jax.nn.log_softmax(reference_forward(params, feats))
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
    nll = jnp.where(mask, nll, 0.0)
    return nll.sum() / jnp.maximum(mask.sum(), 1).astype(jnp.float32)


@functools.lru_cache(maxsize=None)
def _jax_case(name, layout):
    """The JAX results of a case: ``[sharded, sequential]`` logits, loss
    and gradients, or the train step's losses and parameters."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models import pipeline as jp

    _, _, m, kind, opts = CASES[name]
    case = _inputs()[layout][name]
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    x, labels, mask = (jnp.asarray(a) for a in case["batch"])
    mesh, batch_axis = _mesh(layout), LAYOUTS[layout][2]
    kw = dict(num_microbatches=m, batch_axis=batch_axis)
    if kind == "forward":
        return [np.asarray(jax.jit(lambda p: jp.apply_pipeline_model(p, x, mesh, **kw))(params)),
                np.asarray(jp.reference_forward(params, x))]
    if kind == "grads":
        ones = jnp.ones_like(mask)

        def pp_loss(p):
            logp = jax.nn.log_softmax(jp.apply_pipeline_model(p, x, mesh, **kw))
            return -jnp.take_along_axis(logp, labels[:, None], 1).mean()

        return [jax.tree_util.tree_map(np.asarray, g) for g in (
            jax.jit(jax.grad(pp_loss))(params),
            jax.grad(_seq_loss)(params, x, labels, ones))]
    if kind == "1f1b":
        return [jax.tree_util.tree_map(np.asarray, r) for r in (
            jax.jit(lambda p: jp.pipeline_1f1b_loss_and_grads(p, x, labels, mask, mesh, **kw))(
                params),
            jax.value_and_grad(_seq_loss)(params, x, labels, mask))]
    step = jax.jit(jp.make_pipeline_train_step(0.1, mesh=mesh, schedule=opts["schedule"], **kw))
    losses, ones = [], jnp.ones_like(mask)
    for _ in range(TRAIN_STEPS):
        params, loss = step(params, x, labels, ones)
        losses.append(float(loss))
    return np.array(losses), jax.tree_util.tree_map(np.asarray, params)


def _block(full, key, layout, rank):
    """A rank's block of a whole JAX array under the pipeline specs: its
    stage of ``w1`` / ``w2``."""
    if key not in ("w1", "w2"):
        return full
    stage = rank % _stages(layout)
    return full[stage:stage + 1]


def _assert_grads(got, want, layout, rank):
    for key, value in got.items():
        np.testing.assert_allclose(value.numpy(), _block(np.asarray(want[key]), key, layout, rank),
                                   rtol=1e-4, atol=1e-5, err_msg=f"{key} rank {rank}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", ["forward", "forward_more_microbatches"])
def test_forward_matches_jax_sharded_and_sequential_stack(results, name, layout):
    for want in _jax_case(name, layout):
        for rank, res in enumerate(results):
            np.testing.assert_allclose(res[layout][name].numpy(), want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {rank}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gpipe_gradients_match_jax_sharded_and_sequential_stack(results, layout):
    """Autograd through the ticks' permutes, bubble ticks included (they
    must add nothing), against the JAX scan transpose and the sequential
    stack."""
    for want in _jax_case("gradients", layout):
        for rank, res in enumerate(results):
            _assert_grads(res[layout]["gradients"], want, layout, rank)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", ["train_gpipe", "train_1f1b"])
def test_train_step_matches_jax_and_holds_one_stage(results, name, layout):
    want_losses, want_params = _jax_case(name, layout)
    assert want_losses[-1] < want_losses[0]
    case = _inputs()[layout][name]["params"]
    stacked = case["w1"].nbytes + case["w2"].nbytes
    full = sum(v.nbytes for v in case.values())
    for rank, res in enumerate(results):
        got = res[layout][name]
        np.testing.assert_allclose(got["losses"].numpy(), want_losses, rtol=1e-5)
        _assert_grads(got["params"], want_params, layout, rank)
        assert got["bytes"] == full - stacked + stacked // _stages(layout)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_1f1b_matches_sequential_gradients_with_slot_reuse(results, layout):
    """M = 16 microbatches through a 2S-slot stash: every slot is reused,
    and a live activation overwritten would show in the gradients."""
    sharded, (seq_loss, seq_grads) = _jax_case("1f1b_slot_reuse", layout)
    for rank, res in enumerate(results):
        loss, grads = res[layout]["1f1b_slot_reuse"]
        np.testing.assert_allclose(float(loss), float(seq_loss), rtol=1e-6)
        np.testing.assert_allclose(float(loss), float(sharded[0]), rtol=1e-6)
        _assert_grads(grads, seq_grads, layout, rank)
        _assert_grads(grads, sharded[1], layout, rank)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_1f1b_step_matches_gpipe_step(results, layout):
    for res in results:
        got = res[layout]["1f1b_vs_gpipe"]
        (pg, lg), (pf, lf) = got["gpipe"], got["1f1b"]
        np.testing.assert_allclose(float(lf), float(lg), rtol=1e-6)
        for key in pg:
            np.testing.assert_allclose(pf[key].numpy(), pg[key].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stage_count_and_batch_errors(results, layout):
    for res in results:
        half, double, batch, microbatch = res[layout]["errors"]
        assert "does not split over the mesh's 'pp' axis" in half
        assert f"params stack {2 * _stages(layout)} stages" in double
        assert "does not divide into 4 microbatches" in batch
        if LAYOUTS[layout][2] is None:
            assert microbatch is None
        else:
            assert "microbatch size 3 does not shard" in microbatch


def test_unknown_schedule_raises():
    from petastorm_tpu_torch.models.pipeline import make_pipeline_train_step

    with pytest.raises(ValueError, match="schedule"):
        make_pipeline_train_step(schedule="interleaved")


def test_one_process_forward_matches_reference():
    """``mesh=None`` is one stage in one process: a one-stage stack through
    the schedule equals the sequential oracle."""
    from petastorm_tpu_torch.models import pipeline as pl

    params = pl.init_pipeline_params(0, 6, d_model=16, d_hidden=32, num_stages=1,
                                     num_classes=3, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 6).astype(np.float32))
    got = pl.apply_pipeline_model(params, x, None, num_microbatches=4)
    torch.testing.assert_close(got, pl.reference_forward(params, x), rtol=1e-5, atol=1e-5)
