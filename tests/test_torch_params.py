"""The port's checkpoint restore and parameter bridge against the JAX
package: the committed bf16 bundle must load bit-equal through both, and
``params_from_jax``/``params_to_jax`` must round-trip exactly."""

import os

import jax
import numpy as np
import pytest
import torch

from rnn_speech_tpu.models import acoustic as jacoustic
from rnn_speech_tpu.train import checkpoint as jckpt
from rnn_speech_tpu_torch import params as tparams
from rnn_speech_tpu_torch.train import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(ROOT, "trained_models", "english-syllables")


def _leaves(tree):
    return {k: np.asarray(v) for k, v in tparams.flatten(tree).items()}


def test_bundle_loads_bit_equal_through_both_packages():
    cfg = jacoustic.AcousticConfig(num_layers=3, hidden_size=1024,
                                   input_dim=120, num_labels=80)
    template = jacoustic.init_params(jax.random.PRNGKey(0), cfg)
    ref, ref_step, ref_lr = jckpt.restore(os.path.join(BUNDLE, "acoustic"),
                                          template)
    got = tparams.load_bundle(BUNDLE, device="cpu")
    ref_flat = _leaves(jax.tree.map(np.asarray, ref))
    got_flat = {k: v.numpy() for k, v in tparams.flatten(got).items()}
    assert sorted(ref_flat) == sorted(got_flat)
    for key, value in ref_flat.items():
        assert got_flat[key].dtype == value.dtype == np.float32
        np.testing.assert_array_equal(got_flat[key], value, err_msg=key)
    _, step, lr = tckpt.restore_flat(os.path.join(BUNDLE, "acoustic"))
    assert (step, lr) == (ref_step, ref_lr)


def test_restore_into_template_checks_keys_and_shapes(tmp_path):
    flat = {"input/w": np.ones((2, 3), np.float32),
            "input/b": np.zeros((3,), np.float32),
            "__step__": np.asarray(7, np.int64),
            "__learning_rate__": np.asarray(0.5, np.float64)}
    np.savez(tmp_path / "acousticmodel-7.npz", **flat)
    template = {"input": {"w": torch.zeros((2, 3)), "b": torch.zeros((3,))}}
    params, step, lr = tckpt.restore(str(tmp_path), template)
    assert step == 7 and lr == 0.5
    assert torch.equal(params["input"]["w"], torch.ones((2, 3)))
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(str(tmp_path), {"input": {"w": torch.zeros((3, 3)),
                                                "b": torch.zeros((3,))}})
    with pytest.raises(KeyError, match="missing"):
        tckpt.restore(str(tmp_path), {"output": {"w": torch.zeros((2, 3))}})
    assert tckpt.restore(str(tmp_path / "empty"), template) is None


def test_bf16_bits_decode_without_ml_dtypes():
    import ml_dtypes

    values = np.asarray([0.0, -1.5, 3.140625, 1e-30, -7e20, np.inf], np.float32)
    bits = values.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(
        tckpt.bf16_bits_to_f32(bits),
        bits.view(ml_dtypes.bfloat16).astype(np.float32),
    )


def test_params_from_and_to_jax_round_trip():
    cfg = jacoustic.AcousticConfig(num_layers=2, hidden_size=16,
                                   input_dim=6, num_labels=5)
    jparams = jax.tree.map(
        np.asarray, jacoustic.init_params(jax.random.PRNGKey(3), cfg))
    tp = tparams.params_from_jax(jparams, device="cpu")
    assert isinstance(tp["lstm"], list) and len(tp["lstm"]) == 2
    assert tp["lstm"][1]["w_h"].shape == (16, 64)
    back = tparams.params_to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
