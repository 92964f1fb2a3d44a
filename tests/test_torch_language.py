"""The port's character LM (``models/language.py``) against the JAX
package's, on the CPU.

A 2x32 LM over V=80 labels with the JAX package's initial weights (carried
into the port by ``params_from_jax``) and numpy-seeded inputs: the forward
logits and states, the stepper's ``init`` and ``advance``, and the masked
next-char loss agree to 1e-5 relative (max abs difference over the JAX
value's largest magnitude: the same float32 arithmetic in another
summation order); the loss's gradient at keep 1 agrees with ``jax.grad``
to 1e-4 relative, tensor by tensor.  ``generate`` on the committed 1x256
LM (``trained_models/english-syllables/language``) writes the JAX
package's string, and an LM checkpoint restores across the packages in
both directions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu.charmap import CharMap
from rnn_speech_tpu.models import language as jlang
from rnn_speech_tpu.train import checkpoint as jckpt
from rnn_speech_tpu_torch import params as tparams
from rnn_speech_tpu_torch.models import language as tlang
from rnn_speech_tpu_torch.train import checkpoint as tckpt
from rnn_speech_tpu_torch.train import optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE_LM = os.path.join(ROOT, "trained_models", "english-syllables", "language")
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
L, Hd, V = 2, 32, 80


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


@pytest.fixture(scope="module")
def lms():
    jcfg = jlang.LanguageConfig(num_layers=L, hidden_size=Hd, num_labels=V)
    jparams = jlang.init_params(jax.random.PRNGKey(3), jcfg)
    tcfg = tlang.LanguageConfig(num_layers=L, hidden_size=Hd, num_labels=V)
    tp = tparams.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tp


def _chars(T=14, B=5, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (T, B)).astype(np.int32)
    lengths = np.asarray([T, 9, 2, 1, 0], np.int32)[:B]
    ids[np.arange(T)[:, None] >= lengths[None, :]] = -1
    return ids, lengths


def _t_states(states):
    return [(torch.as_tensor(np.asarray(c)), torch.as_tensor(np.asarray(h)))
            for c, h in states]


def test_forward_matches_jax(lms):
    jcfg, jparams, tcfg, tp = lms
    ids, lengths = _chars()
    rng = np.random.default_rng(1)
    states = [(rng.normal(0, 0.5, (5, Hd)).astype(np.float32),
               rng.normal(0, 0.5, (5, Hd)).astype(np.float32)) for _ in range(L)]
    oh = np.array(jax.nn.one_hot(np.maximum(ids, 0), V, dtype=jnp.float32))
    jl, js = jlang.forward(jparams, jcfg, jnp.asarray(oh), jnp.asarray(lengths),
                           [tuple(map(jnp.asarray, s)) for s in states])
    tl, ts = tlang.forward(tp, tcfg, torch.as_tensor(oh), torch.as_tensor(lengths),
                           _t_states(states))
    assert _rel(tl.numpy(), jl) <= FWD_TOL
    for (jc, jh), (tc, th) in zip(js, ts):
        assert _rel(tc.numpy(), jc) <= FWD_TOL and _rel(th.numpy(), jh) <= FWD_TOL


def test_stepper_init_and_advance_match_jax(lms):
    jcfg, jparams, tcfg, tp = lms
    jinit, jadv = jlang.stepper(jparams, jcfg)
    tinit, tadv = tlang.stepper(tp, tcfg)
    js, jlp = jinit(6)
    ts, tlp = tinit(6)
    assert tlp.shape == (6, V)
    assert _rel(tlp.numpy(), jlp) <= FWD_TOL
    chars = np.asarray([0, 5, 79, 12, 5, 40], np.int32)
    for step in range(3):
        js, jlp = jadv(js, jnp.asarray(chars))
        ts, tlp = tadv(ts, torch.as_tensor(chars))
        assert _rel(tlp.numpy(), jlp) <= FWD_TOL, step
        chars = (chars * 7 + 3) % V
    for (jc, jh), (tc, th) in zip(js, ts):
        assert _rel(th.numpy(), jh) <= FWD_TOL


def test_next_char_loss_and_gradient_match_jax(lms):
    jcfg, jparams, tcfg, tp = lms
    ids, lengths = _chars(seed=4)
    jloss_fn = lambda p: jlang.next_char_loss(p, jcfg, jnp.asarray(ids), jnp.asarray(lengths),
                                             jlang.zero_state(jcfg, 5))
    jloss, jgrad = jax.value_and_grad(jloss_fn)(jparams)
    tree = optim.tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    leaves = tparams.flatten(tree)
    tloss = tlang.next_char_loss(tree, tcfg, torch.as_tensor(ids), torch.as_tensor(lengths),
                                 tlang.zero_state(tcfg, 5, device="cpu"))
    assert abs(float(tloss.detach()) - float(jloss)) <= FWD_TOL * abs(float(jloss))
    grads = torch.autograd.grad(tloss, list(leaves.values()))
    jflat = tparams.flatten(jax.tree.map(np.asarray, jgrad))
    for key, g in zip(leaves, grads):
        assert _rel(g.numpy(), jflat[key]) <= GRAD_TOL, key


def test_loss_masks_padding_and_short_rows(lms):
    """A row of length 0 or 1 has no target; padding past a row's length
    does not change the loss."""
    _, _, tcfg, tp = lms
    ids, lengths = _chars(seed=5)
    st = tlang.zero_state(tcfg, 5, device="cpu")
    a = tlang.next_char_loss(tp, tcfg, torch.as_tensor(ids), torch.as_tensor(lengths), st)
    ids2 = ids.copy()
    ids2[ids2 < 0] = 7
    b = tlang.next_char_loss(tp, tcfg, torch.as_tensor(ids2), torch.as_tensor(lengths), st)
    assert float(a) == float(b)
    empty = tlang.next_char_loss(tp, tcfg, torch.as_tensor(ids[:, 3:]),
                                 torch.as_tensor(lengths[3:]), tlang.zero_state(tcfg, 2, "cpu"))
    assert float(empty) == 0.0


def _bundle_lm_cfgs():
    got = tckpt.restore_flat(BUNDLE_LM)
    layers = len({k.split("/")[1] for k in got[0] if k.startswith("lstm/")})
    hidden = got[0]["lstm/0/w_h"].shape[0]
    n = len(CharMap())
    return (jlang.LanguageConfig(layers, hidden, n), tlang.LanguageConfig(layers, hidden, n))


def test_generate_on_the_committed_lm_matches_jax():
    jcfg, tcfg = _bundle_lm_cfgs()
    assert (tcfg.num_layers, tcfg.hidden_size) == (1, 256)
    jparams = jckpt.restore(BUNDLE_LM, jlang.init_params(jax.random.PRNGKey(0), jcfg))[0]
    tp = tparams.load_bundle(os.path.join(ROOT, "trained_models", "english-syllables"),
                             device="cpu", part="language")
    cm = CharMap()
    seed = cm.encode("O", add_eos=False)
    want = cm.decode(jlang.generate(jparams, jcfg, seed, 24))
    got = cm.decode(tlang.generate(tp, tcfg, seed, 24))
    assert got == want and len(got) > 0


def test_sampling_takes_the_generator():
    cfg = tlang.LanguageConfig(1, 16, 12)
    p = tlang.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    a = tlang.generate(p, cfg, [1, 2], 12, generator=torch.Generator().manual_seed(5),
                       temperature=1.0)
    b = tlang.generate(p, cfg, [1, 2], 12, generator=torch.Generator().manual_seed(5),
                       temperature=1.0)
    assert a == b and all(0 <= i < 12 for i in a)


def test_lm_checkpoints_cross_between_the_packages(tmp_path, lms):
    jcfg, jparams, tcfg, tp = lms
    # The port saves, JAX restores.
    tckpt.save(str(tmp_path / "t" / "language"), tp, 7, 1e-4)
    assert os.path.exists(tmp_path / "t" / "language" / "acousticmodel-7.npz")
    got = jckpt.restore(str(tmp_path / "t" / "language"),
                        jlang.init_params(jax.random.PRNGKey(9), jcfg))
    assert got[1] == 7
    for key, leaf in tparams.flatten(jax.tree.map(np.asarray, got[0])).items():
        np.testing.assert_array_equal(leaf, tparams.flatten(tp)[key].numpy())
    # JAX saves, the port restores.
    jckpt.save(str(tmp_path / "j" / "language"), jparams, 3, 2e-4)
    template = tlang.init_params(torch.Generator().manual_seed(1), tcfg, device="cpu")
    params, step, lr = tckpt.restore(str(tmp_path / "j" / "language"), template)
    assert step == 3 and abs(lr - 2e-4) < 1e-12
    for key, leaf in tparams.flatten(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_array_equal(tparams.flatten(params)[key].numpy(), leaf)
