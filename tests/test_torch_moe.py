"""The port's expert-parallel MoE (``petastorm_tpu_torch/models/moe.py``)
against the JAX package's (``petastorm_tpu/models/moe.py``), case for case
after ``tests/test_moe.py``.

One spawned run of four gloo ranks (a ``FileStore`` under ``tmp_path``,
CPU tensors) runs every case at two layouts, ep = 4 and (data 2, ep 2), on
the same seeded numpy inputs (the JAX ``init_moe_params`` pytree); each
rank keeps its block of the params (``shard_params``) and writes its
results. Each case is then held against the JAX sharded run on a mesh of
the same shape (the suite's 8-device CPU platform) and against the JAX
``reference_forward`` with 4 token shards.

Tolerances are ``tests/test_moe.py``'s: f32 forward 1e-5 (rtol and atol),
gradients rtol 1e-4 / atol 1e-5 (top-2: 2e-4 / 2e-5); eight train steps'
losses 1e-5 and parameters at the gradients' tolerance.
"""

import functools

import numpy as np
import pytest
import torch

WORLD = 4
#: layout -> (axis sizes, axis names, batch_axis)
LAYOUTS = {"ep4": ((4,), ("ep",), None), "dp2_ep2": ((2, 2), ("data", "ep"), "data")}
#: case -> (experts, params seed, tokens, features seed, kind, options)
CASES = {
    "oracle": (8, 0, 32, 0, "forward", dict(capacity_factor=8.0)),
    "capacity_drops": (4, 1, 32, 1, "forward", dict(capacity_factor=0.5)),
    "passthrough": (4, 2, 16, 2, "forward", dict(capacity_factor=0.26)),
    "gradients": (8, 3, 32, 3, "grads", dict(capacity_factor=8.0)),
    "train_step": (8, 4, 32, 4, "train", dict(capacity_factor=4.0)),
    "pad_mask": (4, 5, 8, 5, "pad", {}),
    "top2": (8, 21, 32, 21, "forward", dict(top_k=2)),
    "top2_gradients": (8, 22, 32, 22, "grads", dict(top_k=2)),
    "top2_second_choice_top1": (8, 23, 32, 23, "forward", dict(top_k=1, capacity_factor=8.0)),
    "top2_second_choice_top2": (8, 23, 32, 23, "forward", dict(top_k=2, capacity_factor=8.0)),
    "ties_top1": (8, 25, 32, 25, "forward", dict(tie=True)),
    "ties_top2": (8, 25, 32, 25, "forward", dict(tie=True, top_k=2)),
}
TRAIN_STEPS, BALANCE_STEPS = 8, 30


def _features(n, seed):
    return np.random.RandomState(seed).randn(n, 6).astype(np.float32)


def _labels(n):
    return (np.arange(n) % 3).astype(np.int32)


def _jax_params(num_experts, seed, tie=False):
    import jax

    from petastorm_tpu.models.moe import init_moe_params

    params = jax.tree_util.tree_map(np.asarray, init_moe_params(
        jax.random.PRNGKey(seed), feature_dim=6, d_model=16, d_hidden=32,
        num_experts=num_experts, num_classes=3))
    if tie:  # every gate equal: routing is all ties
        params["router"] = np.zeros_like(params["router"])
    return params


def _collapsed_params():
    """``test_moe_aux_loss_balances_expert_load``'s router: expert 0's
    logit biased by +2, so first choices pile onto it."""
    params = _jax_params(8, 24)
    params["router"] = params["router"].copy()
    params["router"][:, 0] = np.abs(params["router"][:, 0]) + 2.0
    return params


@functools.lru_cache(maxsize=None)
def _inputs():
    inputs = {name: {"params": _jax_params(e, seed, opts.get("tie", False)),
                     "x": _features(n, xseed)}
              for name, (e, seed, n, xseed, _, opts) in CASES.items()}
    rng = np.random.RandomState(24)
    inputs["balance"] = {"params": _collapsed_params(),
                         "x": rng.randn(64, 6).astype(np.float32),
                         "labels": rng.randint(0, 3, 64).astype(np.int32)}
    inputs["bad_experts"] = {"ep4": _jax_params(6, 0), "dp2_ep2": _jax_params(3, 0)}
    return inputs


def _loss(kind, logits, aux, labels):
    """The gradient cases' losses, as ``tests/test_moe.py`` writes them."""
    if kind == "sq":
        return (logits ** 2).sum() + 0.1 * aux
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0].mean() + 0.01 * aux


def _run_layout(layout, inputs):
    """Every case at one layout, on this rank; returns its results."""
    from petastorm_tpu_torch.models import moe
    from petastorm_tpu_torch.torch_utils.mesh import Mesh, shard_bytes, shard_params

    sizes, names, batch_axis = LAYOUTS[layout]
    mesh = Mesh(sizes, names)
    specs = moe.moe_param_partition_specs()

    def local(params):
        return shard_params(moe.params_from_jax(params, device="cpu"), specs, mesh)

    out = {}
    for name, (_, _, n, _, kind, opts) in CASES.items():
        params, x = local(inputs[name]["params"]), torch.from_numpy(inputs[name]["x"])
        labels, mask = torch.from_numpy(_labels(n)), torch.ones(n, dtype=torch.bool)
        kw = dict(capacity_factor=opts.get("capacity_factor", 2.0), batch_axis=batch_axis,
                  top_k=opts.get("top_k", 1))
        if kind == "forward":
            logits, aux = moe.apply_moe_model(params, x, mesh, **kw)
            out[name] = {"logits": logits.detach(), "aux": aux.detach()}
        elif kind == "grads":
            leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
            logits, aux = moe.apply_moe_model(leaves, x, mesh, **kw)
            _loss("sq" if kw["top_k"] == 2 else "ce", logits, aux, labels).backward()
            out[name] = {k: v.grad for k, v in leaves.items()}
        elif kind == "train":
            step = moe.make_moe_train_step(mesh=mesh, **kw)
            losses = []
            for _ in range(TRAIN_STEPS):
                params, loss = step(params, x, labels, mask)
                losses.append(loss)
            out[name] = {"losses": torch.stack(losses), "params": params,
                         "bytes": shard_bytes(params)}
        elif kind == "pad":
            step = moe.make_moe_train_step(mesh=mesh, aux_weight=0.0, batch_axis=batch_axis)
            new, loss = step(params, x, torch.zeros(n, dtype=torch.int32),
                             torch.zeros(n, dtype=torch.bool))
            out[name] = {"loss": loss, "unchanged": all(torch.equal(new[k], params[k])
                                                        for k in params)}
    bal = inputs["balance"]
    x, labels = torch.from_numpy(bal["x"]), torch.from_numpy(bal["labels"])
    mask = torch.ones(64, dtype=torch.bool)

    def balance(p):
        return float(moe.apply_moe_model(p, x, mesh, top_k=2, batch_axis=batch_axis)[1])

    trained = {}
    for weight in (0.5, 0.0):
        p = local(bal["params"])
        step = moe.make_moe_train_step(0.3, aux_weight=weight, mesh=mesh, top_k=2,
                                       batch_axis=batch_axis)
        for _ in range(BALANCE_STEPS):
            p, _ = step(p, x, labels, mask)
        trained[weight] = balance(p)
    out["balance"] = {"start": balance(local(bal["params"])), "balanced": trained[0.5],
                      "unbalanced": trained[0.0]}
    errors = []
    x = torch.from_numpy(_features(32, 0))
    for params, feats in ((moe.params_from_jax(inputs["bad_experts"][layout], device="cpu"), x),
                          (local(inputs["oracle"]["params"]), torch.from_numpy(_features(30, 0))),
                          (moe.params_from_jax(inputs["oracle"]["params"], device="cpu"), x)):
        try:
            moe.apply_moe_model(params, feats, mesh, batch_axis=batch_axis)
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

    tmp = tmp_path_factory.mktemp("moe")
    inputs = _inputs()
    torch.save(inputs, tmp / "inputs.pt")
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


@functools.lru_cache(maxsize=None)
def _jax_case(name, layout):
    """The JAX sharded run and the JAX reference of a case: logits and aux,
    gradients, or the train step's losses and parameters."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models import moe as jm

    _, _, n, _, kind, opts = CASES[name]
    inputs = _inputs()[name]
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    x, labels = jnp.asarray(inputs["x"]), jnp.asarray(_labels(n))
    mesh, batch_axis = _mesh(layout), LAYOUTS[layout][2]
    kw = dict(capacity_factor=opts.get("capacity_factor", 2.0), top_k=opts.get("top_k", 1))

    def sharded(p):
        return jm.apply_moe_model(p, x, mesh, batch_axis=batch_axis, **kw)

    def reference(p):
        return jm.reference_forward(p, x, num_shards=WORLD, **kw)

    if kind == "forward":
        return [tuple(np.asarray(a) for a in jax.jit(fn)(params)) for fn in (sharded, reference)]
    if kind == "grads":
        def loss(fn):
            def value(p):
                logits, aux = fn(p)
                if kw["top_k"] == 2:
                    return (logits ** 2).sum() + 0.1 * aux
                logp = jax.nn.log_softmax(logits)
                return -jnp.take_along_axis(logp, labels[:, None], 1).mean() + 0.01 * aux
            return value

        return [jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss(fn)))(params))
                for fn in (sharded, reference)]
    step = jax.jit(jm.make_moe_train_step(mesh=mesh, batch_axis=batch_axis, **kw))
    mask, losses = jnp.ones(n, bool), []
    for _ in range(TRAIN_STEPS):
        params, loss = step(params, x, labels, mask)
        losses.append(float(loss))
    return np.array(losses), jax.tree_util.tree_map(np.asarray, params)


def _block(full, name, layout, rank):
    """A rank's block of a whole JAX array under the MoE specs."""
    if name not in ("w1", "w2"):
        return full
    sizes, names, _ = LAYOUTS[layout]
    ep = sizes[names.index("ep")]
    coord = rank % ep
    per = full.shape[0] // ep
    return full[coord * per:(coord + 1) * per]


FORWARD = [n for n, c in CASES.items() if c[4] == "forward"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_jax_sharded_and_reference(results, name, layout):
    want = _jax_case(name, layout)
    for rank, res in enumerate(results):
        got = res[layout][name]
        for w_logits, w_aux in want:
            np.testing.assert_allclose(got["logits"].numpy(), w_logits, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {rank}")
            np.testing.assert_allclose(float(got["aux"]), float(w_aux), rtol=1e-5)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dropped_tokens_pass_through_the_residual(results, layout):
    """Capacity 1 of 16 tokens: a dropped token's logits are embed → head
    with no expert contribution, exactly (the JAX test's check)."""
    params, x = _inputs()["passthrough"]["params"], _inputs()["passthrough"]["x"]
    passthrough = torch.tensor(x) @ torch.tensor(params["embed"]) @ torch.tensor(params["head"])
    for res in results:
        got = res[layout]["passthrough"]["logits"]
        assert np.isclose(got.numpy(), passthrough.numpy(), rtol=1e-6).all(axis=1).any()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", ["gradients", "top2_gradients"])
def test_gradients_match_jax_sharded_and_reference(results, name, layout):
    rtol, atol = (2e-4, 2e-5) if name.startswith("top2") else (1e-4, 1e-5)
    for want in _jax_case(name, layout):
        for rank, res in enumerate(results):
            got = res[layout][name]
            for key, value in got.items():
                np.testing.assert_allclose(value.numpy(), _block(want[key], key, layout, rank),
                                           rtol=rtol, atol=atol, err_msg=f"{key} rank {rank}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_train_step_matches_jax_and_holds_a_quarter_of_the_experts(results, layout):
    want_losses, want_params = _jax_case("train_step", layout)
    assert want_losses[-1] < want_losses[0]
    full = sum(v.nbytes for v in _inputs()["train_step"]["params"].values())
    expert = sum(_inputs()["train_step"]["params"][k].nbytes for k in ("w1", "w2"))
    sizes, names, _ = LAYOUTS[layout]
    ep = sizes[names.index("ep")]
    for rank, res in enumerate(results):
        got = res[layout]["train_step"]
        np.testing.assert_allclose(got["losses"].numpy(), want_losses, rtol=1e-5)
        for key, value in got["params"].items():
            np.testing.assert_allclose(value.numpy(), _block(want_params[key], key, layout, rank),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{key} rank {rank}")
        assert got["bytes"] == full - expert + expert // ep
        assert got["params"]["w1"].shape[0] * ep == 8


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pad_mask_zeroes_the_gradient(results, layout):
    for res in results:
        got = res[layout]["pad_mask"]
        assert float(got["loss"]) == 0.0 and got["unchanged"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bad_shapes_raise_as_jax_does(results, layout):
    for res in results:
        experts, tokens, unsharded = res[layout]["errors"]
        assert "experts do not split" in experts
        assert "30 tokens do not shard over 4 devices" in tokens
        assert "w1 holds 8 experts" in unsharded


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_top2_second_choice_contributes(results, layout):
    for res in results:
        one = res[layout]["top2_second_choice_top1"]["logits"]
        two = res[layout]["top2_second_choice_top2"]["logits"]
        assert not np.allclose(one.numpy(), two.numpy())


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_aux_loss_balances_expert_load(results, layout):
    """The JAX test's claim on the port: from a collapsed router, 30 top-2
    steps with the aux loss bring the balance metric well down, and
    without it they do not; the starting metric equals the JAX one."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models.moe import apply_moe_model

    bal = _inputs()["balance"]
    want = float(jax.jit(lambda p, f: apply_moe_model(
        p, f, _mesh(layout), top_k=2, batch_axis=LAYOUTS[layout][2])[1])(
        jax.tree_util.tree_map(jnp.asarray, bal["params"]), jnp.asarray(bal["x"])))
    for res in results:
        got = res[layout]["balance"]
        assert got["start"] == pytest.approx(want, rel=1e-5) and got["start"] > 2.0
        assert got["balanced"] < got["start"] * 0.6, got
        assert got["balanced"] < got["unbalanced"] - 0.2, got


@pytest.mark.parametrize("top_k", [1, 2])
def test_ties_route_to_the_lower_expert_as_lax_top_k(top_k):
    """Equal gates: ``torch.topk`` promises no order, ``lax.top_k`` takes
    the lower index; the port's routing equals the JAX routing on rows
    with every kind of tie."""
    import jax.numpy as jnp

    from petastorm_tpu.models.moe import _route_topk as jax_route
    from petastorm_tpu_torch.models.moe import _route_topk

    gates = np.full((6, 8), 0.125, np.float32)
    gates[1, [2, 5]] = 0.3           # a tie at the top
    gates[2, [0, 7]] = 0.05          # ties below the top
    gates[3] = np.linspace(0.2, 0.05, 8)
    gates[3, 4] = gates[3, 3]        # a tie for second place
    gates[4, [6, 3, 1]] = 0.2        # three-way tie at the top
    got = _route_topk(torch.from_numpy(gates), capacity=2, top_k=top_k)
    want = jax_route(jnp.asarray(gates), 2, top_k=top_k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
