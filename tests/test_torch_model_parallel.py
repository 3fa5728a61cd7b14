"""The port's mesh collectives, the image classifier's tensor-parallel split
and the DLRM's table-parallel split against the JAX package.

One spawned run of four gloo ranks (a ``FileStore`` under ``tmp_path``,
CPU tensors) runs every case and writes each rank's results:

- ``psum`` / ``pmean`` (all-reduce forward, identity backward),
  ``copy_to_group`` (identity forward, all-reduce backward) and
  ``ring_exchange`` (both directions of the ring in one batch) on a
  4-rank mesh, each value and gradient against the same function under
  ``shard_map`` on 4 devices (``lax.psum`` / ``pmean`` / an input left
  unsplit / two ``lax.ppermute``);
- the image classifier at (data 2, model 2): each rank's logits (its data
  shard's rows) and one masked SGD step against the JAX
  ``make_train_step`` with the ``param_partition_specs`` sharding on a
  (data 2, model 2) mesh, and against the port's one-process model on the
  whole batch; in f32 compute (1e-5) and in the default bf16 (logits 1e-2
  of the largest, as ``test_torch_image_classifier.py``; loss and
  parameters rtol / atol 2e-3);
- the DLRM at (data 2, model 2) on
  ``tests/test_tabular_dlrm.py::test_sharded_step_matches_unsharded``'s
  inputs and tolerances (bf16: loss 1e-3 relative, parameters rtol / atol
  2e-3) against the JAX step sharded by ``dlrm_partition_specs`` and
  unsharded and the port's one-process step; in f32 compute, 1e-5; and,
  stepped with no data group (the sparse table update), each rank against
  the port's one-process step on its data rank's rows, at the same
  tolerances;
- each rank's split tensors are ``1/model`` of the whole, in bytes, and a
  table count that does not split raises ValueError, and so does a DLRM
  batch that does not split over ``"model"`` (the exchange splits it).
"""

import functools

import numpy as np
import pytest
import torch

WORLD = 4
SHAPE, CLASSES, HIDDEN, CONV, LR = (16, 16, 3), 10, 32, 8, 0.01
IMAGE_ROWS = 8
DLRM = dict(num_dense=4, num_sparse=8, vocab_size=32, embed_dim=8)
DLRM_ROWS, DLRM_LR = 16, 0.1
COMPUTE = {"f32": (torch.float32, "float32"), "bf16": (torch.bfloat16, "bfloat16")}


@functools.lru_cache(maxsize=None)
def _inputs():
    import jax

    from petastorm_tpu.models.image_classifier import init_params
    from petastorm_tpu.models.tabular_dlrm import init_dlrm_params

    rng = np.random.RandomState(0)
    image = jax.tree_util.tree_map(np.asarray, init_params(
        jax.random.PRNGKey(1), SHAPE, CLASSES, hidden=HIDDEN, conv_features=CONV))
    for layer in image.values():  # non-zero biases, so their blocks are checked too
        layer["bias"] = (0.1 * rng.randn(*layer["bias"].shape)).astype(np.float32)
    mask = np.ones(IMAGE_ROWS, bool)
    mask[[1, 6, 7]] = False  # the data shards mask 1 and 2 rows: the mean is the whole batch's
    drng = np.random.RandomState(0)  # test_tabular_dlrm.py's _batch(rows=16, seed=0)
    return {
        "image": {"params": image,
                  "x": (2 * rng.rand(IMAGE_ROWS, *SHAPE) - 1).astype(np.float32),
                  "labels": rng.randint(0, CLASSES, IMAGE_ROWS).astype(np.int32),
                  "mask": mask},
        "dlrm": {"params": jax.tree_util.tree_map(np.asarray, init_dlrm_params(
                     jax.random.PRNGKey(0), **DLRM)),
                 "dense": drng.rand(DLRM_ROWS, DLRM["num_dense"]).astype(np.float32),
                 "ids": drng.randint(0, 10_000, (DLRM_ROWS, DLRM["num_sparse"])).astype(np.int64),
                 "labels": drng.randint(0, 2, DLRM_ROWS).astype(np.int32),
                 "mask": np.ones(DLRM_ROWS, bool)},
        "collectives": {"x": rng.randn(WORLD, 3, 5).astype(np.float32),
                        "c": rng.randn(WORLD, 3, 5).astype(np.float32),
                        "w": rng.randn(3, 5).astype(np.float32)},
    }


def _collectives(mesh, inputs):
    from petastorm_tpu_torch.torch_utils.sharding import (
        copy_to_group,
        pmean,
        psum,
        ring_exchange,
    )

    group, r = mesh.group("i"), mesh.axis_index("i")
    x, c = (torch.tensor(inputs[k][r]) for k in ("x", "c"))
    out = {}
    for name, fn in (("psum", psum), ("pmean", pmean)):
        leaf = x.clone().requires_grad_()
        y = fn(leaf, group)
        (y * torch.tensor(inputs["c"][0])).sum().backward()  # a replicated cotangent
        out[name] = (y.detach(), leaf.grad)
    w = torch.tensor(inputs["w"]).requires_grad_()
    (copy_to_group(w, group) * x * c).sum().backward()  # each rank's part of the loss
    out["copy_to_group"] = w.grad
    out["ring_exchange"] = ring_exchange(x, c, group)
    return out


def _image(mesh, inputs, compute):
    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.torch_utils.mesh import shard_bytes

    d = mesh.axis_index("data")
    rows = slice(d * IMAGE_ROWS // 2, (d + 1) * IMAGE_ROWS // 2)
    full = ic.params_from_jax(inputs["params"], SHAPE, compute_dtype=COMPUTE[compute][0],
                              device="cpu")
    model = ic.shard_image_classifier(full, mesh)
    x, labels, mask = (torch.from_numpy(inputs[k][rows]) for k in ("x", "labels", "mask"))
    with torch.no_grad():
        logits = model(x)
    loss = ic.make_image_train_step(model, LR, group=mesh.group("data"))(x, labels, mask)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return {"logits": logits, "loss": loss, "params": state, "bytes": shard_bytes(state),
            "full_bytes": shard_bytes(full.state_dict())}


def _dlrm(mesh, inputs, compute):
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.torch_utils.mesh import shard_bytes

    d = mesh.axis_index("data")
    rows = slice(d * DLRM_ROWS // 2, (d + 1) * DLRM_ROWS // 2)
    full = td.params_from_jax(inputs["params"], compute_dtype=COMPUTE[compute][0], device="cpu")
    model = td.shard_dlrm(full, mesh)
    batch = [torch.from_numpy(inputs[k][rows]) for k in ("dense", "ids", "labels", "mask")]
    with torch.no_grad():
        logits = model(*batch[:2])
    loss = td.make_dlrm_train_step(model, DLRM_LR, group=mesh.group("data"))(*batch)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    # With no data group the step takes the sparse table update, each data
    # rank on its own rows.
    alone = td.shard_dlrm(full, mesh)
    alone_loss = td.make_dlrm_train_step(alone, DLRM_LR)(*batch)
    return {"logits": logits, "loss": loss, "params": state, "bytes": shard_bytes(state),
            "full_bytes": shard_bytes(full.state_dict()), "sparse_loss": alone_loss,
            "sparse_params": {k: v.clone() for k, v in alone.state_dict().items()}}


def _rank_main(rank, out_dir):
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.torch_utils.mesh import Mesh

    torch.set_num_threads(1)  # four ranks of small products: threads only contend
    inputs = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
    ring, grid = Mesh((WORLD,), ("i",)), Mesh((2, 2), ("data", "model"))
    out = {"collectives": _collectives(ring, inputs["collectives"])}
    for compute in COMPUTE:
        out[f"image_{compute}"] = _image(grid, inputs["image"], compute)
        out[f"dlrm_{compute}"] = _dlrm(grid, inputs["dlrm"], compute)
    try:
        td.DLRM(num_sparse=7, mesh=grid)
    except ValueError as exc:
        out["odd_tables"] = str(exc)
    try:  # raised before any exchange, on every rank: no rank is left waiting
        td.DLRM(**DLRM, mesh=grid)(torch.zeros(7, DLRM["num_dense"]),
                                   torch.zeros(7, DLRM["num_sparse"], dtype=torch.long))
    except ValueError as exc:
        out["odd_batch"] = str(exc)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every rank's results from one spawned gloo run."""
    from petastorm_tpu_torch.torch_utils.mesh import run_ranks

    tmp = tmp_path_factory.mktemp("model_parallel")
    torch.save(_inputs(), tmp / "inputs.pt")
    try:
        run_ranks(_rank_main, WORLD, str(tmp), args=(str(tmp),), timeout_s=300)
    except RuntimeError as exc:
        pytest.fail(str(exc))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _coords(rank):
    return rank // 2, rank % 2  # (data, model): the mesh's row-major order


# -- the collectives -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_collectives():
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    inp = _inputs()["collectives"]
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("i",))
    x, c, w = (jnp.asarray(inp[k]) for k in ("x", "c", "w"))
    out = {}
    for name, fn in (("psum", jax.lax.psum), ("pmean", jax.lax.pmean)):
        f = shard_map(lambda v: fn(v[0], "i"), mesh=mesh, in_specs=P("i"), out_specs=P())
        out[name] = (np.asarray(f(x)),
                     np.asarray(jax.grad(lambda v: (f(v) * c[0]).sum())(x)))

    def part(w, x, c):
        return ((w * x[0] * c[0]).sum())[None]

    g = shard_map(part, mesh=mesh, in_specs=(P(), P("i"), P("i")), out_specs=P("i"))
    out["copy_to_group"] = np.asarray(jax.grad(lambda w: g(w, x, c).sum())(w))
    fwd = [(i, (i + 1) % WORLD) for i in range(WORLD)]
    bwd = [(i, (i - 1) % WORLD) for i in range(WORLD)]
    h = shard_map(lambda x, c: (jax.lax.ppermute(x, "i", fwd), jax.lax.ppermute(c, "i", bwd)),
                  mesh=mesh, in_specs=(P("i"), P("i")), out_specs=(P("i"), P("i")))
    out["ring_exchange"] = tuple(np.asarray(a) for a in h(x, c))
    return out


@pytest.mark.parametrize("name", ["psum", "pmean"])
def test_psum_and_pmean_forward_and_identity_backward_equal_jax(results, name):
    want_y, want_grad = _jax_collectives()[name]
    for rank, res in enumerate(results):
        y, grad = res["collectives"][name]
        np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grad.numpy(), want_grad[rank], rtol=1e-6, atol=1e-6)


def test_copy_to_group_sums_the_cotangent_as_jax_transposes_an_unsplit_input(results):
    want = _jax_collectives()["copy_to_group"]
    for res in results:
        np.testing.assert_allclose(res["collectives"]["copy_to_group"].numpy(), want,
                                   rtol=1e-5, atol=1e-6)


def test_ring_exchange_sends_both_ways_as_two_ppermutes(results):
    want_fwd, want_bwd = _jax_collectives()["ring_exchange"]
    for rank, res in enumerate(results):
        got_fwd, got_bwd = res["collectives"]["ring_exchange"]
        np.testing.assert_array_equal(got_fwd.numpy(), want_fwd[rank])
        np.testing.assert_array_equal(got_bwd.numpy(), want_bwd[rank])


# -- the image classifier ------------------------------------------------------------

_IMAGE_BLOCKS = {"dense1_kernel": 1, "dense1_bias": 0, "dense2_kernel": 0}


def _image_state(np_params):
    from petastorm_tpu_torch.models.image_classifier import params_from_jax

    return {k: v.numpy() for k, v in params_from_jax(np_params, SHAPE,
                                                     device="cpu").state_dict().items()}


def _block(state, blocks, model_rank):
    """The model rank's block of each whole array of ``state``."""
    out = {}
    for key, value in state.items():
        if key in blocks:
            axis = blocks[key]
            per = value.shape[axis] // 2
            value = np.take(value, np.arange(model_rank * per, (model_rank + 1) * per), axis)
        out[key] = value
    return out


@functools.lru_cache(maxsize=None)
def _jax_image(compute):
    """The JAX logits and one ``make_train_step`` step (f32 compute: the same
    loss through ``apply_model(compute_dtype=f32)``), jitted with the params
    sharded by ``param_partition_specs`` and the batch over ``data``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from petastorm_tpu.models.image_classifier import (
        apply_model,
        make_train_step,
        param_partition_specs,
    )

    inp = _inputs()["image"]
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("data", "model"))
    params = jax.tree_util.tree_map(
        lambda p, s: jax.device_put(jnp.asarray(p), NamedSharding(mesh, s)),
        inp["params"], param_partition_specs())
    batch = [jax.device_put(jnp.asarray(inp[k]), NamedSharding(mesh, P("data")))
             for k in ("x", "labels", "mask")]
    dtype = getattr(jnp, COMPUTE[compute][1])
    logits = jax.jit(lambda p, x: apply_model(p, x, compute_dtype=dtype))(params, batch[0])
    if compute == "bf16":
        step = make_train_step(LR)
    else:
        def step(p, x, labels, mask):
            def loss_fn(p):
                logp = jax.nn.log_softmax(apply_model(p, x, compute_dtype=jnp.float32))
                nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
                nll = jnp.where(mask, nll, 0.0)
                return nll.sum() / jnp.maximum(mask.sum(), 1).astype(jnp.float32)

            loss, grads = jax.value_and_grad(loss_fn)(p)
            return jax.tree_util.tree_map(lambda a, g: a - LR * g, p, grads), loss
    new, loss = jax.jit(step)(params, *batch)
    return (np.asarray(logits), float(loss),
            _image_state(jax.tree_util.tree_map(np.asarray, new)))


@functools.lru_cache(maxsize=None)
def _port_image(compute):
    """The port's one-process model: one step on the whole batch."""
    from petastorm_tpu_torch.models import image_classifier as ic

    inp = _inputs()["image"]
    model = ic.params_from_jax(inp["params"], SHAPE, compute_dtype=COMPUTE[compute][0],
                               device="cpu")
    batch = [torch.from_numpy(inp[k]) for k in ("x", "labels", "mask")]
    with torch.no_grad():
        logits = model(batch[0]).numpy()
    loss = ic.make_image_train_step(model, LR)(*batch)
    return logits, float(loss), {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("compute", sorted(COMPUTE))
@pytest.mark.parametrize("against", ["jax_sharded", "port_one_process"])
def test_image_classifier_tensor_parallel_step(results, compute, against):
    want_logits, want_loss, want_state = (_jax_image if against == "jax_sharded"
                                          else _port_image)(compute)
    tol = 1e-5 if compute == "f32" else 2e-3
    for rank, res in enumerate(results):
        d, m = _coords(rank)
        got = res[f"image_{compute}"]
        rows = want_logits[d * IMAGE_ROWS // 2:(d + 1) * IMAGE_ROWS // 2]
        logit_tol = 1e-5 if compute == "f32" else 1e-2
        assert np.abs(got["logits"].numpy() - rows).max() <= logit_tol * np.abs(rows).max()
        np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=tol)
        want = _block(want_state, _IMAGE_BLOCKS, m)
        for key, value in got["params"].items():
            np.testing.assert_allclose(value.numpy(), want[key], rtol=tol, atol=tol,
                                       err_msg=f"{key} rank {rank}")


def test_image_classifier_ranks_hold_half_of_the_split_tensors(results):
    state = _image_state(_inputs()["image"]["params"])
    split = sum(state[k].nbytes for k in _IMAGE_BLOCKS)
    for res in results:
        got = res["image_f32"]
        assert got["full_bytes"] == sum(v.nbytes for v in state.values())
        assert got["bytes"] == got["full_bytes"] - split // 2
        for key, axis in _IMAGE_BLOCKS.items():
            assert got["params"][key].shape[axis] * 2 == state[key].shape[axis]


# -- the DLRM ----------------------------------------------------------------------

def _dlrm_state(np_params):
    from petastorm_tpu_torch.models.tabular_dlrm import params_from_jax

    return {k: v.numpy() for k, v in params_from_jax(np_params, device="cpu")
            .state_dict().items()}


@functools.lru_cache(maxsize=None)
def _jax_dlrm(compute, sharded):
    """The JAX ``make_dlrm_train_step`` (with ``apply_dlrm`` at the compute
    dtype), sharded by ``dlrm_partition_specs`` on (data 2, model 2) or on
    one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from petastorm_tpu.models.tabular_dlrm import apply_dlrm, dlrm_partition_specs

    inp = _inputs()["dlrm"]
    dtype = getattr(jnp, COMPUTE[compute][1])

    def loss_fn(params, dense, ids, labels, mask):  # make_dlrm_train_step's
        logits = apply_dlrm(params, dense, ids, compute_dtype=dtype)
        losses = jnp.maximum(logits, 0) - logits * labels + jnp.log1p(jnp.exp(-jnp.abs(logits)))
        mask = mask.astype(jnp.float32)
        return jnp.sum(losses * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    def step(params, dense, ids, labels, mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, dense, ids,
                                                  labels.astype(jnp.float32), mask)
        return jax.tree_util.tree_map(lambda p, g: p - DLRM_LR * g.astype(p.dtype),
                                      params, grads), loss

    params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    batch = [jnp.asarray(inp[k]) for k in ("dense", "ids", "labels", "mask")]
    if sharded:
        mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("data", "model"))
        params = jax.tree_util.tree_map(
            lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params,
            dlrm_partition_specs())
        batch = [jax.device_put(a, NamedSharding(mesh, P("data"))) for a in batch]
    new, loss = jax.jit(step)(params, *batch)
    logits = jax.jit(lambda p, d, i: apply_dlrm(p, d, i, compute_dtype=dtype))(params, *batch[:2])
    return np.asarray(logits), float(loss), _dlrm_state(jax.tree_util.tree_map(np.asarray, new))


@functools.lru_cache(maxsize=None)
def _port_dlrm(compute):
    from petastorm_tpu_torch.models import tabular_dlrm as td

    inp = _inputs()["dlrm"]
    model = td.params_from_jax(inp["params"], compute_dtype=COMPUTE[compute][0], device="cpu")
    batch = [torch.from_numpy(inp[k]) for k in ("dense", "ids", "labels", "mask")]
    with torch.no_grad():
        logits = model(*batch[:2]).numpy()
    loss = td.make_dlrm_train_step(model, DLRM_LR)(*batch)
    return logits, float(loss), {k: v.numpy() for k, v in model.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _port_dlrm_rows(compute, d):
    """The port's one-process step (the sparse table update) on data rank
    ``d``'s rows: ``(loss, state)``."""
    from petastorm_tpu_torch.models import tabular_dlrm as td

    inp = _inputs()["dlrm"]
    rows = slice(d * DLRM_ROWS // 2, (d + 1) * DLRM_ROWS // 2)
    model = td.params_from_jax(inp["params"], compute_dtype=COMPUTE[compute][0], device="cpu")
    batch = [torch.from_numpy(inp[k][rows]) for k in ("dense", "ids", "labels", "mask")]
    loss = td.make_dlrm_train_step(model, DLRM_LR)(*batch)
    return float(loss), {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("compute", sorted(COMPUTE))
def test_dlrm_table_parallel_sparse_step(results, compute):
    """A table-parallel model stepped with no data group takes the sparse
    update on its table block: each rank ends as the one-process sparse step
    on its data rank's rows leaves that block."""
    tol = 1e-5 if compute == "f32" else 2e-3
    for rank, res in enumerate(results):
        d, m = _coords(rank)
        want_loss, want_state = _port_dlrm_rows(compute, d)
        got = res[f"dlrm_{compute}"]
        np.testing.assert_allclose(float(got["sparse_loss"]), want_loss, rtol=tol)
        want = _block(want_state, {"embeddings": 0}, m)
        for key, value in got["sparse_params"].items():
            np.testing.assert_allclose(value.numpy(), want[key], rtol=tol, atol=tol,
                                       err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("compute", sorted(COMPUTE))
@pytest.mark.parametrize("against", ["jax_sharded", "jax_unsharded", "port_one_process"])
def test_dlrm_table_parallel_step(results, compute, against):
    if against == "port_one_process":
        want_logits, want_loss, want_state = _port_dlrm(compute)
    else:
        want_logits, want_loss, want_state = _jax_dlrm(compute, against == "jax_sharded")
    loss_tol, tol = (1e-5, 1e-5) if compute == "f32" else (1e-3, 2e-3)
    # Each data rank's loss is its rows' mean; the rows split evenly, so the
    # batch's is the mean of the data ranks'.
    loss = np.mean([float(results[d * 2]["dlrm_" + compute]["loss"]) for d in range(2)])
    np.testing.assert_allclose(loss, want_loss, rtol=loss_tol)
    for rank, res in enumerate(results):
        d, m = _coords(rank)
        got = res[f"dlrm_{compute}"]
        rows = want_logits[d * DLRM_ROWS // 2:(d + 1) * DLRM_ROWS // 2]
        np.testing.assert_allclose(got["logits"].numpy(), rows, rtol=tol, atol=tol)
        want = _block(want_state, {"embeddings": 0}, m)
        for key, value in got["params"].items():
            np.testing.assert_allclose(value.numpy(), want[key], rtol=tol, atol=tol,
                                       err_msg=f"{key} rank {rank}")


def test_dlrm_ranks_hold_half_of_the_tables(results):
    state = _dlrm_state(_inputs()["dlrm"]["params"])
    for res in results:
        got = res["dlrm_bf16"]
        assert got["full_bytes"] == sum(v.nbytes for v in state.values())
        assert got["bytes"] == got["full_bytes"] - state["embeddings"].nbytes // 2
        assert got["params"]["embeddings"].shape[0] == DLRM["num_sparse"] // 2
        assert "7 tables do not split over the mesh's 'model' axis of 2" in res["odd_tables"]


def test_dlrm_batch_that_does_not_split_over_model_raises(results):
    for res in results:
        assert "a batch of 7 rows does not split over the mesh's 'model' axis of 2" \
            in res["odd_batch"]
