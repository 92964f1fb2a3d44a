"""The port's checkpoint save against the JAX package's: the bf16 encode
bit-equal to ``ml_dtypes`` (tolerance 0, specials included), bundles saved
by either package restored by the other to equal arrays, the same
retention and the same ``convert_bundle`` output."""

import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu.train import checkpoint as jckpt
from rnn_speech_tpu_torch import params as params_mod
from rnn_speech_tpu_torch.models import acoustic as tac
from rnn_speech_tpu_torch.train import checkpoint as tckpt

SPECIALS = np.array([
    0x00000000, 0x80000000, 0x7F800000, 0xFF800000,      # +-0, +-inf
    0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,      # quiet/signalling NaN
    0x7FFFFFFF, 0xFFFFFFFF, 0x7FBFFFFF, 0x7F7FFFFF,      # NaN payloads, max finite
    0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x00000001,      # overflow edge, denormals
    0x80000001, 0x007FFFFF, 0x00008000, 0x00018000,
    0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F80FFFF,      # ties to even, either side
], np.uint32)


def _ml_dtypes_bits(bits):
    return bits.view(np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)


@pytest.mark.parametrize("case", ["specials", "random_bits"])
def test_bf16_encode_bit_equal_to_ml_dtypes(case):
    if case == "specials":
        bits = SPECIALS
    else:
        bits = np.random.default_rng(0).integers(0, 2 ** 32, 10 ** 6,
                                                 dtype=np.uint64).astype(np.uint32)
    with np.errstate(invalid="ignore"):
        ref = _ml_dtypes_bits(bits)
    got = tckpt.f32_to_bf16_bits(bits.view(np.float32))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tckpt.bf16_bits_to_f32(got).view(np.uint32),
                                  got.astype(np.uint32) << 16)


def _models():
    cfg = jac.AcousticConfig(num_layers=2, hidden_size=16, input_dim=20, num_labels=80)
    jparams = jax.tree.map(np.asarray, jac.init_params(jax.random.PRNGKey(3), cfg))
    tparams = params_mod.params_from_jax(jparams, device="cpu")
    template = tac.init_params(torch.Generator().manual_seed(0),
                               tac.config_for_params(tparams), device="cpu")
    return jparams, tparams, template


def _assert_same(port_params, jax_params):
    flat = {k: v.numpy() for k, v in params_mod.flatten(port_params).items()}
    ref = params_mod.flatten(jax_params)
    assert flat.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(flat[key], np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("weights_dtype", ["float32", "bfloat16"])
def test_port_save_restores_in_jax_and_back(tmp_path, weights_dtype):
    jparams, tparams, template = _models()
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tckpt.save(port_dir, tparams, 17, 2.5e-4, weights_dtype=weights_dtype)
    jckpt.save(jax_dir, jparams, 17, 2.5e-4, weights_dtype=weights_dtype)
    got_j = jckpt.restore(port_dir, jparams)
    got_t = tckpt.restore(jax_dir, template)
    assert got_j[1:] == got_t[1:] == (17, 2.5e-4)
    _assert_same(got_t[0], got_j[0])
    if weights_dtype == "float32":
        _assert_same(got_t[0], jparams)
    # The two packages wrote the same arrays under the same keys.
    with np.load(os.path.join(port_dir, "acousticmodel-17.npz")) as a, \
            np.load(os.path.join(jax_dir, "acousticmodel-17.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_retention_leaves_the_same_files(tmp_path):
    jparams, tparams, _ = _models()
    for step in (1, 3, 2, 9, 5, 7, 4):
        tckpt.save(str(tmp_path / "port"), tparams, step, 1e-3)
        jckpt.save(str(tmp_path / "jax"), jparams, step, 1e-3)
    port, ref = (sorted(os.listdir(tmp_path / d)) for d in ("port", "jax"))
    assert port == ref
    assert ref == ["acousticmodel-3.npz", "acousticmodel-4.npz", "acousticmodel-5.npz",
                   "acousticmodel-7.npz", "acousticmodel-9.npz", "checkpoint"]
    assert tckpt.latest_path(str(tmp_path / "port")).endswith("acousticmodel-4.npz")
    tckpt.save(str(tmp_path / "all"), tparams, 1, 1e-3, keep=0)
    tckpt.save(str(tmp_path / "all"), tparams, 2, 1e-3, keep=0)
    assert len(os.listdir(tmp_path / "all")) == 3
    with pytest.raises(ValueError):
        tckpt.save(str(tmp_path / "x"), tparams, 1, 1e-3, weights_dtype="float16")


@pytest.mark.parametrize("src_dtype,dst_dtype", [("float32", "bfloat16"),
                                                  ("bfloat16", "float32"),
                                                  ("float32", "float32")])
def test_convert_bundle_writes_the_same_arrays(tmp_path, src_dtype, dst_dtype):
    jparams, _, _ = _models()
    src = jckpt.save(str(tmp_path / "src"), jparams, 4, 1e-3, weights_dtype=src_dtype)
    got = tckpt.convert_bundle(src, str(tmp_path / "port"), dst_dtype)
    ref = jckpt.convert_bundle(src, str(tmp_path / "jax"), dst_dtype)
    assert os.path.basename(got) == os.path.basename(ref)
    with np.load(got) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert tckpt.latest_path(str(tmp_path / "port")) == got
