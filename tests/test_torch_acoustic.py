"""The port's acoustic forward against ``rnn_speech_tpu.models.acoustic``:
same weights, same features, the JAX scan path (use_pallas=False) as the
reference.

Tolerances: float32 compute differs only in summation order, 1e-4 on
logits of magnitude ~1 through three projections; bf16 compute rounds
the same operands on both sides and sums in float32, so a rare bf16
rounding flip is the only divergence, 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu_torch import params as tparams
from rnn_speech_tpu_torch.models import acoustic as tac

TOLS = {"f32": 1e-4, "bf16": 5e-3}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _setup(B, frame_stack, seed=0):
    D, H, L, V, T = 9, 32, 2, 7, 13
    jcfg = jac.AcousticConfig(num_layers=L, hidden_size=H, input_dim=D,
                              num_labels=V, frame_stack=frame_stack)
    jparams = jax.tree.map(np.asarray,
                           jac.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (T, B, D)).astype(np.float32)
    lens = np.asarray(([T, 5, 0, 1, 9] * 2)[:B], np.int32)
    return jcfg, jparams, x, lens


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("normalization", [False, True])
@pytest.mark.parametrize("frame_stack", [1, 2])
@pytest.mark.parametrize("B", [1, 5])
def test_forward_matches_jax(dtype, normalization, frame_stack, B):
    jd, td = DT[dtype]
    jcfg, jparams, x, lens = _setup(B, frame_stack)
    jcfg = jac.AcousticConfig(
        num_layers=jcfg.num_layers, hidden_size=jcfg.hidden_size,
        input_dim=jcfg.input_dim, num_labels=jcfg.num_labels,
        normalization=normalization, compute_dtype=jd, frame_stack=frame_stack,
    )
    tcfg = tac.AcousticConfig(
        num_layers=jcfg.num_layers, hidden_size=jcfg.hidden_size,
        input_dim=jcfg.input_dim, num_labels=jcfg.num_labels,
        normalization=normalization, compute_dtype=td, frame_stack=frame_stack,
        use_kernels=True, wavefront=True,
    )
    ref, ref_states = jac.forward(
        jax.tree.map(jnp.asarray, jparams), jcfg, jnp.asarray(x),
        jnp.asarray(lens), jac.zero_state(jcfg, B))
    tp = tparams.params_from_jax(jparams, device="cpu")
    got, states = tac.forward(tp, tcfg, torch.as_tensor(x), torch.as_tensor(lens),
                              tac.zero_state(tcfg, B))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOLS[dtype])
    for (rc, rh), (c, h) in zip(ref_states, states):
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=TOLS[dtype])
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=TOLS[dtype])
    np.testing.assert_array_equal(
        tac.output_lengths(tcfg, torch.as_tensor(lens)).numpy(),
        np.asarray(jac.output_lengths(jcfg, jnp.asarray(lens))))


def test_stack_frames_and_batch_norm_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (7, 3, 4)).astype(np.float32)
    lens = np.asarray([7, 3, 0], np.int32)
    rx, rl = jac.stack_frames(jnp.asarray(x), jnp.asarray(lens), 3)
    gx, gl = tac.stack_frames(torch.as_tensor(x), torch.as_tensor(lens), 3)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    np.testing.assert_allclose(tac._batch_norm(torch.as_tensor(x)).numpy(),
                               np.asarray(jac._batch_norm(jnp.asarray(x))),
                               atol=1e-5)
    one = torch.as_tensor(x[:, :1])
    assert torch.equal(tac._batch_norm(one), one)   # B == 1 is an identity


def test_init_params_shapes_and_count_match_jax():
    jcfg = jac.AcousticConfig(num_layers=2, hidden_size=8, input_dim=5,
                              num_labels=4, frame_stack=2)
    tcfg = tac.AcousticConfig(num_layers=2, hidden_size=8, input_dim=5,
                              num_labels=4, frame_stack=2)
    jp = jac.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tac.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda t: tuple(t.shape), tp)
    assert tac.param_count(tp) == jac.param_count(jp)
    again = tac.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert torch.equal(tp["lstm"][1]["w_h"], again["lstm"][1]["w_h"])
