"""SpecAugment in the port against the JAX package's.

The JAX masks come from its PRNG, which torch cannot reproduce, so the
apply step is held against ``augment.spec_augment`` fed the JAX function's
own draws (its four keys split as it splits them), bit for bit (tolerance
0); the port's own draws are held to the same ranges and, by chi-square
tests at the 1e-3 level on fixed seeds, to uniform widths and starts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from rnn_speech_tpu.ops import augment as jaug
from rnn_speech_tpu_torch.ops import augment as taug

CHI2_P = 1e-3


def _jax_draws(key, B, channels, nf=2, nt=2, width=8):
    """The draws ``rnn_speech_tpu.ops.augment.spec_augment`` makes."""
    k_fs, k_fw, k_ts, k_tw = jax.random.split(key, 4)
    return {
        "f_width": np.asarray(jax.random.randint(k_fw, (B, nf), 0, min(width, channels) + 1)),
        "u_fs": np.asarray(jax.random.uniform(k_fs, (B, nf))),
        "u_w": np.asarray(jax.random.uniform(k_tw, (B, nt))),
        "u_s": np.asarray(jax.random.uniform(k_ts, (B, nt))),
    }


@pytest.mark.parametrize("groups,D", [(1, 20), (3, 120)], ids=["groups1", "groups3"])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_equals_jax_on_its_draws(groups, D, seed):
    T, B = 240, 7
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(T, B, D)).astype(np.float32)
    lengths = np.array([240, 10, 1, 0, 200, 77, 239], np.int32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jaug.spec_augment(jnp.asarray(feats), jnp.asarray(lengths), key,
                                       groups=groups))
    draws = {k: torch.from_numpy(v.copy())
             for k, v in _jax_draws(key, B, D // groups).items()}
    got = taug.apply_masks(torch.from_numpy(feats), torch.from_numpy(lengths), draws,
                           groups=groups).numpy()
    assert got.tobytes() == ref.tobytes()
    assert 0 < (got == 0).mean() < 0.5
    assert taug.groups_for_feature_dim(D) == jaug.groups_for_feature_dim(D) == groups


def test_bf16_features_keep_their_dtype():
    feats = torch.ones((50, 3, 120), dtype=torch.bfloat16)
    out = taug.spec_augment(feats, torch.tensor([50, 20, 0]), torch.Generator().manual_seed(0),
                            groups=3)
    assert out.dtype == torch.bfloat16 and out.shape == feats.shape
    assert bool(((out == 0) | (out == 1)).all())


def test_port_draws_fall_in_the_jax_ranges():
    g = torch.Generator().manual_seed(0)
    for channels in (40, 5):
        d = taug.draw_masks(g, 500, channels)
        assert d["f_width"].dtype == torch.int32
        assert int(d["f_width"].min()) == 0
        assert int(d["f_width"].max()) == min(8, channels)
        for k in ("u_fs", "u_w", "u_s"):
            assert d[k].dtype == torch.float32
            assert float(d[k].min()) >= 0.0 and float(d[k].max()) < 1.0
    # Masks stay inside the utterance and the channel axis.
    feats = torch.ones((300, 64, 40))
    lengths = torch.randint(0, 300, (64,), generator=g)
    out = taug.spec_augment(feats, lengths, g)
    masked_t = (out == 0).all(dim=2)                 # (T, B) whole-frame masks
    for b in range(64):
        assert not bool(masked_t[int(max(lengths[b], 1)):, b].any())


def _uniform_p(values, n_values):
    counts = np.bincount(np.asarray(values), minlength=n_values)
    assert len(counts) == n_values
    return chisquare(counts).pvalue


def test_widths_and_starts_are_uniform():
    """Chi-square on 40000 draws: frequency widths over [0, 8]; band starts
    at width 4 over [0, C - 4]; time widths at length 100 (max 5) over
    [0, 5]; time starts at width 3 over [0, 97]."""
    g = torch.Generator().manual_seed(1234)
    C, n = 40, 20000
    d = taug.draw_masks(g, n, C)
    f_width = d["f_width"].reshape(-1)
    f_start = (d["u_fs"] * (C - d["f_width"] + 1).float()).to(torch.int32).reshape(-1)
    assert _uniform_p(f_width, 9) > CHI2_P
    assert _uniform_p(f_start[f_width == 4], C - 3) > CHI2_P
    length, max_w = 100, 5
    t_width = (d["u_w"] * (max_w + 1)).to(torch.int32).reshape(-1)
    assert _uniform_p(t_width, max_w + 1) > CHI2_P
    t_start = (d["u_s"].reshape(-1) * (length - 3 + 1)).to(torch.int32)
    assert _uniform_p(t_start, length - 2) > CHI2_P
    # The same statistics on JAX's draws, for scale.
    j = _jax_draws(jax.random.PRNGKey(1234), n, C)
    assert _uniform_p(j["f_width"].reshape(-1), 9) > CHI2_P


def test_masked_fraction_matches_jax_on_average():
    """The expected masked share of a long batch: the port's draws and the
    JAX function's agree within 4 sigma of the per-example spread."""
    T, B, D = 400, 256, 120
    feats = np.ones((T, B, D), np.float32)
    lengths = np.full((B,), T, np.int32)
    ref = np.asarray(jaug.spec_augment(jnp.asarray(feats), jnp.asarray(lengths),
                                       jax.random.PRNGKey(0), groups=3))
    got = taug.spec_augment(torch.from_numpy(feats), torch.from_numpy(lengths),
                            torch.Generator().manual_seed(0), groups=3).numpy()
    per_ref = (ref == 0).mean(axis=(0, 2))
    per_got = (got == 0).mean(axis=(0, 2))
    sigma = np.sqrt(per_ref.var() / B + per_got.var() / B)
    assert abs(per_got.mean() - per_ref.mean()) < 4 * sigma
