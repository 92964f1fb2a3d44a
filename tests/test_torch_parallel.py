"""The port's mesh, sharding and lockstep against the JAX package's, on
gloo ranks on the CPU.

The ranks are spawned processes (``parallel/launch.spawn_ranks``) running
``tests/test_torch_rank_workers.py``; the JAX references run here, on the
8 virtual CPU devices of ``tests/conftest.py``, at the sizes of
``tests/test_parallel.py``: 2 layers of 16, 8 features, batch 8 in 2
microbatches of 12 frames, float32, keep probabilities 1.

Tolerances, stated per comparison (those of ``tests/test_parallel.py``):
* gradients: the same float32 sums in another association (two or four
  shards, then the all-reduce), 1e-5 relative Frobenius norm a tensor;
* ``mean_loss`` and the eval metrics: 1e-4 relative;
* parameters after one Adam step at lr 0.01: 2e-5 absolute on the data
  axis, 3e-3 with the model axis, whose reduce-scatter reorders the sums
  again: step-1 Adam is a signum, lr·g/(|g| + eps), so reorder noise on a
  gradient element near zero moves its weight by a large share of lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu.parallel import mesh as jmesh
from rnn_speech_tpu.parallel import sharding as jshard
from rnn_speech_tpu.train import step as jstep
from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu_torch.ops import _build, random_bits
from rnn_speech_tpu_torch.parallel import dryrun, launch, lockstep, sharding
from rnn_speech_tpu_torch.parallel import mesh as tmesh
from rnn_speech_tpu_torch.train import optim

import test_torch_rank_workers as workers

GRAD_RTOL, LOSS_RTOL = 1e-5, 1e-4
PARAM_ATOL = {1: 2e-5, 2: 3e-3}
SPAWN_TIMEOUT = 240


def _jax_cfg():
    return jstep.StepConfig(
        model=jac.AcousticConfig(num_layers=2, hidden_size=16, input_dim=8, num_labels=6),
        input_keep_prob=1.0, output_keep_prob=1.0)


@pytest.fixture(scope="module")
def inputs():
    batch = dryrun.tiny_batch(0)
    state0 = jstep.init_train_state(jax.random.PRNGKey(0), _jax_cfg().model, 8,
                                    workers.LR)
    return batch, jax.tree.map(np.asarray, state0)


def _jax_sharded(data, model, state_np, batch):
    cfg = _jax_cfg()
    state = jax.tree.map(jnp.asarray, state_np)
    st, put_batch, train_fn, eval_fn = jshard.make_sharded_step(
        jmesh.make_mesh(data, model), cfg, state)
    eval0 = eval_fn(cfg, st, put_batch(batch))
    st2, metrics = train_fn(cfg, st, put_batch(batch), jax.random.PRNGKey(7),
                            jnp.asarray(False))
    return st2, metrics, eval0


@pytest.fixture(scope="module", params=[(2, 1), (2, 2)], ids=["mesh2x1", "mesh2x2"])
def sharded(request, inputs):
    """Every rank's results on the mesh, and the JAX references: the
    single-device step and gradient sums, and ``make_sharded_step`` on the
    same mesh."""
    data, model = request.param
    batch, state_np = inputs
    ranks = launch.spawn_ranks(workers.sharded_step, data * model, "gloo", "cpu",
                               args=(data, model, state_np, batch), timeout=SPAWN_TIMEOUT)
    cfg = _jax_cfg()
    state = jax.tree.map(jnp.asarray, state_np)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jgrads, *_ = jstep.accumulate_grads(cfg, state["params"], state["states"], jbatch,
                                           jax.random.PRNGKey(7))
    ref_state, ref_metrics = jstep.train_step(cfg, state, jbatch, jax.random.PRNGKey(7),
                                              jnp.asarray(False))
    ref_eval = jstep.eval_step(cfg, state, jbatch)
    return {"mesh": (data, model), "ranks": ranks, "grads": jgrads,
            "single": (ref_state, ref_metrics, ref_eval),
            "jax_sharded": _jax_sharded(data, model, state_np, batch)}


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in optim.tree_leaves(tree)]


def test_sharded_gradients_match_jax_single_device(sharded):
    ref = [np.asarray(g, np.float32) for g in jax.tree.leaves(sharded["grads"])]
    for rank in sharded["ranks"]:
        got = _leaves(rank["grads"])
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert np.linalg.norm(g - r) <= GRAD_RTOL * np.linalg.norm(r)


@pytest.mark.parametrize("against", ["single", "jax_sharded"])
def test_sharded_train_step_matches_jax(sharded, against):
    """One step's loss and parameters on every rank against the JAX
    single-device step and JAX's own sharded step on the same mesh; a
    second step runs on the sharded state."""
    ref_state, ref_metrics = sharded[against][:2]
    atol = PARAM_ATOL[sharded["mesh"][1]]
    for rank in sharded["ranks"]:
        np.testing.assert_allclose(rank["metrics"]["mean_loss"],
                                   float(ref_metrics["mean_loss"]), rtol=LOSS_RTOL)
        for g, r in zip(_leaves(rank["params"]), jax.tree.leaves(ref_state["params"])):
            np.testing.assert_allclose(g, np.asarray(r), atol=atol)
        assert rank["step"] == 2
        assert all(np.isfinite(v) for v in rank["eval3"].values())


def test_model_axis_shards_the_gate_leaves(sharded):
    """On the model axis the LSTM leaves live in shards of their last
    dimension; everything else stays whole."""
    data, model = sharded["mesh"]
    full = [tuple(p.shape) for p in _leaves(sharded["ranks"][0]["params"])]
    want = [s[:-1] + (s[-1] // model,) if len(s) and s[-1] == 64 else s for s in full]
    for rank in sharded["ranks"]:
        assert rank["param_shapes"] == want
        assert rank["coords"] == (rank["shard_index"] // model, rank["shard_index"] % model)


@pytest.mark.parametrize("against", ["single", "jax_sharded"])
def test_sharded_eval_step_matches_jax(sharded, against):
    ref = sharded[against][2]
    for rank in sharded["ranks"]:
        for key in ("mean_loss", "mean_error_rate"):
            np.testing.assert_allclose(rank["eval0"][key], float(ref[key]), rtol=LOSS_RTOL,
                                       atol=1e-7)


def test_pod_dispatch_bound_of_uneven_ranks(sharded):
    world = len(sharded["ranks"])
    assert [r["bound"] for r in sharded["ranks"]] == [3 * (world - 1) + 1] * world


@pytest.mark.parametrize("data,model,world,want", [
    (4, 2, 8, (4, 2)), (0, 2, 8, (4, 2)), (0, 1, 8, (8, 1)), (1, 0, 1, (1, 1)),
    (0, 1, 1, (1, 1)), (2, 1, 2, (2, 1))])
def test_mesh_arithmetic_matches_jax(data, model, world, want):
    assert tmesh.mesh_shape(data, model, world) == want
    if world == 8:
        assert tuple(jmesh.make_mesh(data, model).shape.values()) == want


@pytest.mark.parametrize("data,model,world,words", [
    (16, 1, 8, "torch.distributed.run --nproc_per_node 16"), (2, 1, 1, "needs 2 ranks"),
    (2, 1, 4, "covers 2 of the 4 ranks"), (1, 1, 2, "every rank")])
def test_mesh_of_another_size_raises(data, model, world, words):
    """Larger than the world, as in JAX; smaller, the port's deviation."""
    with pytest.raises(ValueError, match=words):
        tmesh.mesh_shape(data, model, world)
    if world == 8:
        with pytest.raises(ValueError):
            jmesh.make_mesh(data, model)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_mesh(1, 1)


@pytest.mark.parametrize("model", [1, 2, 3, 4])
def test_param_specs_match_jax(model):
    """The leaves that shard over "model" (and on which dimension) are
    JAX's ``_param_spec`` choices, on a tree whose 4H of 64 divides by 1,
    2 and 4 but not by 3."""
    cfg = jac.AcousticConfig(num_layers=2, hidden_size=16, input_dim=8, num_labels=6)
    jparams = jac.init_params(jax.random.PRNGKey(0), cfg)

    def jax_dim(path, leaf):
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        spec = tuple(jshard._param_spec(keys, leaf.shape, model))
        return spec.index("model") if "model" in spec else None

    want = jax.tree.leaves(jax.tree_util.tree_map_with_path(jax_dim, jparams),
                           is_leaf=lambda x: x is None)
    from rnn_speech_tpu_torch import params as tparams

    got = optim.tree_leaves(sharding.param_specs(
        tparams.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"), model))
    assert got == want
    assert (model in (2, 4)) == any(d is not None for d in got)


class _Mesh(tmesh.Mesh):
    pass


def test_put_batch_rejects_a_width_that_does_not_divide(inputs):
    """A global width that does not divide the batch shards raises the JAX
    package's ``ValueError`` (the loop asks ``shard_width`` for a rank's
    rows); ``put_batch`` moves the rank's own rows as they are."""
    batch, state_np = inputs
    from rnn_speech_tpu_torch import params as tparams

    mesh = _Mesh(device_mesh=None, shape={"data": 3, "model": 1}, data_group=None,
                 model_group=None, coords=(1, 0))
    with pytest.raises(ValueError, match="Global batch width 8 must divide evenly across "
                                         "the 3 batch shards"):
        sharding.shard_width(8, mesh)
    mesh.shape = {"data": 2, "model": 2}
    assert sharding.shard_width(8, mesh) == 2 and mesh.shard_index == 2
    state = tparams.train_state_from_jax(state_np, device="cpu")
    _, put_batch, _, _ = sharding.make_sharded_step(mesh, workers.tiny_step_config(), state)
    rows = {k: v[:, 4:6] for k, v in batch.items()}          # shard 2 of 4
    got = put_batch(rows)
    for k, v in rows.items():
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_dropout_seed_words_of_each_shard():
    """Shard 0 draws exactly the unsharded step's seed words; shard 1
    draws others, the same on every call from the same seed."""
    def words(shard, n=4):
        gen = sharding.shard_generator(torch.Generator().manual_seed(1234), shard)
        return [random_bits.seed_words(gen) for _ in range(n)]

    plain = torch.Generator().manual_seed(1234)
    assert words(0) == [random_bits.seed_words(plain) for _ in range(4)]
    assert words(1) == words(1) and words(1) != words(0)
    assert words(2) != words(1)
    gen = torch.Generator().manual_seed(1234)
    assert sharding.shard_generator(gen, 0) is gen


def test_one_by_one_mesh_is_bit_equal_to_the_unsharded_step_with_dropout(inputs):
    batch, state_np = inputs
    out, = launch.spawn_ranks(workers.one_by_one_dropout, 1, "gloo", "cpu",
                              args=((0.8, 0.5), state_np, batch), timeout=SPAWN_TIMEOUT)
    assert out["sharded"]["metrics"] == out["unsharded"]["metrics"]
    for g, r in zip(_leaves(out["sharded"]["params"]), _leaves(out["unsharded"]["params"])):
        np.testing.assert_array_equal(g, r)


def test_dryrun_multichip_four_ranks():
    records = dryrun.dryrun_multichip(4, "cpu", timeout=SPAWN_TIMEOUT)
    assert [r["mesh"] for r in records] == [(4, 1), (2, 2)]
    assert all(r["step"] == 1 and np.isfinite(r["loss"]) for r in records)


def test_dryrun_on_cuda_needs_a_card_a_rank(monkeypatch):
    """On cuda the dry run is one NCCL rank a card: with fewer cards than
    ranks it raises before it starts any, and never falls back to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(launch, "spawn_ranks", lambda *a, **k: pytest.fail("spawned"))
    with pytest.raises(ValueError, match="needs 2 cards, have 1"):
        dryrun.dryrun_multichip(2)


def test_spawn_ranks_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1"):
        launch.spawn_ranks(workers.fail_on_rank_one, 2, "gloo", "cpu", timeout=60)


def test_launch_stream_refuses_a_tensor_off_the_current_device(monkeypatch):
    """The kernels launch on the current device: a CUDA input elsewhere
    raises; on the current device (or with no index) the current stream's
    handle comes back."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("Stream", (), {"cuda_stream": 42})())
    with pytest.raises(ValueError, match="cuda:1 but the current device is cuda:0"):
        _build.launch_stream(torch.device("cuda", 1))
    assert _build.launch_stream(torch.device("cuda", 0)) == 42
    assert _build.launch_stream(torch.device("cuda")) == 42


def test_collective_device_follows_the_backend(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    assert lockstep.collective_device() == torch.device("cpu")
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert lockstep.collective_device() == torch.device("cuda", 3)
