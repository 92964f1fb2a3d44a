"""The float32 persistent layer backward (row 8's recompute mode, and the
gates mode of row 4's layer sweep), its GEMM tile (the float32 rebuild and
the sweep's cotangent product), the float32 persistent layer forward (row
3's layer sweep, with its input product on the same tile), the float32
skinny weight-gradient tile (row 15) and the padded, mixed-dtype routes of
rows 1-8, on the card against their plain PyTorch versions.

Shapes: one and several 64-row groups (B = 1, 70, 130), H = 128 and 256
(2 and 4 unit slices), T across a rebuild chunk edge (``REBUILD_BYTES``
patched down), drop modes 0, 1 and 2 for the sweeps; the forward sweep
also at B=64 and 129, H=1024, ragged lengths; the skinny tile at both
projections (N = 224,640) and at D=7, G=13, N=100,003; odd widths H=100,
D=72 (padded to 128) in bf16, float32 and both mixed modes.  Beside them
the planted faults that fail at these sizes: the tile with its last K
stage left out, the forward chain with a partial left out, a skinny K
slice left out.  The chains' barrier faults race with CTAs that finish
early at a few rows; chip_smoke.py plants them at the full width.

Every test carries the ``cuda`` marker and takes the ``cuda`` fixture,
which skips it, with the reason, where no NVIDIA GPU is present.  Run, on a
machine with a GPU and ``nvcc``, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda_f32_persistent.py

Tolerances, relative to each output's largest magnitude: float32 kernels
sum the plain versions' float32 products in another order, 1e-4 (the
readings are ~1e-6); bf16 and mixed modes 1e-2 (a bf16 rounding flipped
by the order, as in test_torch_cuda_kernels.py).
"""

import pytest
import torch

from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
from rnn_speech_tpu_torch.ops import lstm_recurrence as trec
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave

pytestmark = pytest.mark.cuda

f32, bf16 = torch.float32, torch.bfloat16
F32_TOL, MIXED_TOL = 1e-4, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    return torch.device("cuda")


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _close(got, ref, tol):
    for g, r in zip(got, ref):
        assert _rel(g, r) <= tol, (_rel(g, r), tol)


def _far(got, ref, tol):
    assert max(_rel(g, r) for g, r in zip(got, ref)) > tol


def _layer(T, B, H, D, seed, dev, dtype=f32):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale: torch.randn(s, generator=g) * scale
    lens = [T - (7 * b) % (T + 1) for b in range(B)]
    lens[0] = T
    lim = (6.0 / (5 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim).to(dev, dtype)
    return dict(w_x=w(D, 4 * H), w_h=w(H, 4 * H), b=r(4 * H, scale=0.1).to(dev),
                x=r(T, B, D, scale=1.0).to(dev, dtype), x_proj=r(T, B, 4 * H, scale=1.0).to(dev),
                mask=(torch.arange(T)[:, None] < torch.as_tensor(lens)[None]).float()[:, None, :]
                .to(dev),
                h0=r(B, H, scale=0.2).to(dev), c0=r(B, H, scale=0.2).to(dev),
                dout=r(T, B, H, scale=0.1).to(dev), dhn=r(B, H, scale=0.1).to(dev),
                dcn=r(B, H, scale=0.1).to(dev))


def _recompute_args(x, rd=f32):
    out, _, _, cseq = tlt.recurrence_train_lean_plain(
        (x["x"].float() @ x["w_x"].float() + x["b"]).to(rd), x["w_h"], x["mask"], x["h0"],
        x["c0"], rd)
    h_prev = torch.cat([x["h0"].to(rd)[None], out.to(rd)[:-1]])
    return (x["dout"], x["x"].to(rd), h_prev, cseq, x["c0"].to(rd).float(), x["mask"], x["w_x"],
            x["b"], x["w_h"], x["dhn"], x["dcn"])


@pytest.mark.parametrize("B,H,T,chunked", [(1, 128, 5, False), (70, 128, 17, True),
                                           (130, 256, 9, False), (64, 256, 12, True)])
def test_recompute_f32_persistent_matches_plain(cuda, monkeypatch, B, H, T, chunked):
    """Row 8 in float32 on the persistent kernel: dgates, dh0, dc0 against
    the plain version, bit for bit on repeat, and the chunks' launches and
    rebuild products counted."""
    if chunked:   # a chunk of 3 steps: T crosses chunk edges
        monkeypatch.setattr(tlt, "REBUILD_BYTES", 3 * 16 * B * H)
    args = _recompute_args(_layer(T, B, H, H, seed=B + H + T, dev=cuda))
    plan = tlt.bwd_plan(B, H, dtype=f32, recompute=True)
    assert plan["kernel"] == "persistent_f32"
    before = (tlt.recurrence_bwd_recompute.f32_persistent_launches,
              tlt.recurrence_bwd_recompute.per_step_launches)
    got = tlt.recurrence_bwd_recompute(*args)
    again = tlt.recurrence_bwd_recompute(*args)
    ref = tlt.recurrence_bwd_recompute_plain(*args)
    torch.cuda.synchronize()
    chunks = len(tlt.rebuild_chunks(T, tlt.rebuild_chunk(T, B, H)))
    assert (tlt.recurrence_bwd_recompute.f32_persistent_launches - before[0],
            tlt.recurrence_bwd_recompute.per_step_launches - before[1]) == (2 * chunks, 0)
    _close(got, ref, F32_TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,H,T", [(5, 128, 7), (70, 256, 11)])
def test_f32_chain_gates_mode_matches_plain(cuda, B, H, T):
    """The chain in gates mode (the layer sweep's): dgates over the gates,
    dh0, dc0 against ``recurrence_bwd_plain``."""
    x = _layer(T, B, H, H, seed=3 * B + T, dev=cuda)
    _, _, _, gates, cseq = tlt.recurrence_train_plain(x["x_proj"], x["w_h"], x["mask"],
                                                      x["h0"], x["c0"], f32)
    tail = (x["mask"], x["w_h"], x["dhn"], x["dcn"])
    ref = tlt.recurrence_bwd_plain(x["dout"], gates.clone(), cseq, x["c0"], *tail)
    got = tlt._bwd_f32_persistent_launch(x["dout"], gates.clone(), cseq, x["c0"], *tail,
                                         tlt.bwd_f32_plan(B, H))
    torch.cuda.synchronize()
    _close(got, ref, F32_TOL)


@pytest.mark.parametrize("rows,H,D", [(1, 64, 64), (333, 128, 64), (1000, 64, 192)])
def test_f32_rebuild_tile_matches_plain(cuda, rows, H, D):
    g = torch.Generator().manual_seed(rows)
    r = lambda *s: torch.randn(s, generator=g).to(cuda)
    args = (r(rows, D), r(rows, H), r(D, 4 * H) * 0.05, r(H, 4 * H) * 0.05, r(4 * H) * 0.1)
    got = tlt.rebuild_gates(*args)
    torch.cuda.synchronize()
    assert _rel(got, tlt.rebuild_gates_plain(*args)) <= 1e-5


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("B,H", [(5, 128), (70, 128)])
def test_layer_sweep_matches_plain(cuda, mode, B, H):
    """Row 4 in float32 as the layer sweep: dgates, dh0, dc0 and xdrop
    against ``wavefront_bwd_plain``; the cotangent product alone against
    ``sweep_dout_plain``, beside its last K stage left out."""
    L, T = 3, 9
    g = torch.Generator().manual_seed(B + mode)
    r = lambda *s, scale: torch.randn(s, generator=g) * scale
    lim = (6.0 / (5 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim).to(cuda)
    lens = torch.as_tensor([T - (5 * b) % (T + 1) for b in range(B)])
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :].to(cuda)
    keep = 0.6
    drop = {0: (0, None, 1.0, 1.0),
            1: (1, (torch.rand((L - 1, T, B, H), generator=g) < keep).float().to(cuda),
                1 / keep, 1.0),
            2: (2, (12345, 678), 1 / keep, keep)}[mode]
    x, w_x0, w_h, w_x_rest = (r(T, B, H, scale=1.0).to(cuda), w(H, 4 * H), w(L, H, 4 * H),
                              w(L - 1, H, 4 * H))
    b_all = r(L, 4 * H, scale=0.1).to(cuda)
    h0, c0 = r(L, B, H, scale=0.2).to(cuda), r(L, B, H, scale=0.2).to(cuda)
    outs, gates, cseq, _, _ = twave.wavefront_train_plain(x, w_x0, w_h, w_x_rest, b_all, mask,
                                                          h0, c0, f32, *drop)
    dout, dhn, dcn = (r(T, B, H, scale=0.1).to(cuda), r(L, B, H, scale=0.1).to(cuda),
                      r(L, B, H, scale=0.1).to(cuda))
    bargs = (dout, w_h, w_x_rest, mask)
    tail = (cseq, c0, dhn, dcn, outs, *drop)
    ref = twave.wavefront_bwd_plain(*bargs, gates.clone(), *tail)
    assert twave.wavefront_bwd_plan(B, H, L, dtype=f32)["kernel"] == "layer_sweep"
    before = twave.wavefront_bwd.sweep_launches
    got = twave.wavefront_bwd(*bargs, gates.clone(), *tail)
    torch.cuda.synchronize()
    assert twave.wavefront_bwd.sweep_launches - before == L
    assert len(got) == len(ref)
    _close(got, ref, F32_TOL)
    launch_drop = (mode, *twave._drop_launch_args(mode, drop[1], drop[3], drop[2],
                                                  (L - 1, T, B, H), dout.device))
    dg_top = ref[0][L - 1]
    ks = twave.drop_keeps(mode, drop[1], drop[3], (L - 1, T, B, H), cuda)
    ks = None if ks is None else ks[L - 2] * drop[2]
    plain = twave.sweep_dout_plain(dg_top, w_x_rest[L - 2], outs[L - 2], ks)
    for skip_k, check in ((0, _close), (1, _far)):
        d = twave.sweep_dout(dg_top, w_x_rest[L - 2], launch_drop, L - 2,
                             outs[L - 2] if mode else None, skip_k=skip_k)
        torch.cuda.synchronize()
        check([d[0]], [plain[0]], F32_TOL)
        if mode:
            _close([d[1]], [plain[1]], F32_TOL)


def _stack(L, T, B, H, D, seed, dev, mode):
    """The training forward's arguments at (L, T, B, H, D), ragged lengths
    (the first row full, one row empty), float32, drop mode ``mode`` at
    keep 0.6; ends with (drop_mode, drop_arr, drop_scale, keep_prob)."""
    g = torch.Generator().manual_seed(seed)
    lim = (6.0 / (5 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim).to(dev)
    r = lambda *s, scale: (torch.randn(s, generator=g) * scale).to(dev)
    lens = torch.as_tensor([T - (5 * b) % (T + 1) for b in range(B)])
    lens[0] = T
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :].to(dev)
    keep = 0.6
    drop = {0: (0, None, 1.0, 1.0),
            1: (1, (torch.rand((L - 1, T, B, H), generator=g) < keep).float().to(dev),
                1 / keep, keep),
            2: (2, (12345 + seed, 678), 1 / keep, keep)}[mode]
    return (r(T, B, D, scale=1.0), w(D, 4 * H), w(L, H, 4 * H), w(L - 1, H, 4 * H),
            r(L, 4 * H, scale=0.1), mask, r(L, B, H, scale=0.2), r(L, B, H, scale=0.2), f32,
            *drop)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("B,H,D", [(64, 1024, 1024), (70, 128, 40), (129, 256, 256)])
def test_forward_layer_sweep_matches_plain(cuda, mode, B, H, D):
    """Row 3 in float32 as the layer sweep: outs, gates, cseq, hn, cn
    against ``wavefront_train_plain``, bit for bit on repeat, a chain and an
    input product a layer counted; mode 2 equal to mode 1 fed the seed
    words' masks; beside the chain with the slice's last partial left out
    and the input product's last K stage left out."""
    L, T = 3, 9
    args = _stack(L, T, B, H, D, seed=B + H + mode, dev=cuda, mode=mode)
    plan = twave.wavefront_plan(B, H, L, D, dtype=f32)
    assert plan["kernel"] == "layer_sweep"
    before = (twave.wavefront_train.sweep_launches, twave.wavefront_train.sweep_xp_launches,
              twave.wavefront_train.per_diagonal_launches)
    got = twave.wavefront_train(*args)
    again = twave.wavefront_train(*args)
    ref = twave.wavefront_train_plain(*args)
    torch.cuda.synchronize()
    assert (twave.wavefront_train.sweep_launches - before[0],
            twave.wavefront_train.sweep_xp_launches - before[1],
            twave.wavefront_train.per_diagonal_launches - before[2]) == (2 * L, 2 * L, 0)
    _close(got, ref, F32_TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if mode == 2:
        masks = twave.drop_keeps(2, args[10], args[12], (L - 1, T, B, H), cuda)
        fed = twave.wavefront_train(*args[:9], 1, masks, args[11], args[12])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, fed))
    if D == H and H % 64 == 0:
        drop = (mode, *twave._drop_launch_args(mode, args[10], args[12], args[11],
                                               (L - 1, T, B, H), args[0].device))
        for kw in ({"skip_barrier": 4}, {"skip_k": 1}):
            bad = twave._fwd_layer_sweep_launch(*args[:8], drop, plan, **kw)
            torch.cuda.synchronize()
            _far(bad, ref, F32_TOL)


@pytest.mark.parametrize("Dn,N,G", [(120, 224640, 1024), (1024, 224640, 80), (7, 100003, 13)])
def test_skinny_f32_matches_plain(cuda, Dn, N, G):
    """Row 15 in float32 on the float32 skinny tile: dW and db against the
    plain version, bit for bit on repeat, beside a K slice left out."""
    from rnn_speech_tpu_torch.ops import grad_matmul as gm

    g = torch.Generator().manual_seed(Dn + G)
    x = torch.randn((N, Dn), generator=g).to(cuda)
    dg = (torch.randn((N, G), generator=g) * 0.01).to(cuda)
    assert gm.plan([Dn], N, G, f32, torch.cuda.get_device_properties(0).multi_processor_count,
                   f32, compute_dtype=f32).path == "skinny_f32"
    before = gm.weight_grad.skinny_f32_launches
    got = gm.weight_grad(x, dg, compute_dtype=f32)
    again = gm.weight_grad(x, dg, compute_dtype=f32)
    ref = gm.weight_grad_plain(x, dg, compute_dtype=f32)
    bad = gm._launch([x], dg, f32, skip_split=0)[:2]
    torch.cuda.synchronize()
    assert gm.weight_grad.skinny_f32_launches - before == 2
    _close(got, ref, F32_TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _far(bad, ref, F32_TOL)


ODD = dict(L=2, T=6, B=5, H=100, D=72)
MODES = {"bf16": (bf16, bf16), "f32": (f32, f32), "bf16_f32": (bf16, f32),
         "f32_bf16": (f32, bf16)}


@pytest.mark.parametrize("mode", list(MODES))
def test_odd_widths_run_on_the_kernels(cuda, mode):
    """Rows 1-8 at H=100, D=72 (padded to 128 inside the wrappers) in every
    compute and residual mode (rows 1 and 2, which keep no residuals, in
    the pure modes) against their plain versions."""
    cd, rd = MODES[mode]
    tol = F32_TOL if mode == "f32" else MIXED_TOL
    L, T, B, H, D = ODD["L"], ODD["T"], ODD["B"], ODD["H"], ODD["D"]
    x = _layer(T, B, H, D, seed=11, dev=cuda, dtype=cd)
    if cd == rd:
        args = (x["x_proj"], x["w_h"], x["mask"], x["h0"], x["c0"])
        _close(trec.lstm_recurrence(*args), trec.lstm_recurrence_plain(*args), tol)
        wargs = (x["x_proj"], torch.stack([x["w_h"]] * L), torch.stack([x["w_h"]] * (L - 1)),
                 x["b"].reshape(1, 1, -1).expand(L - 1, 1, -1).contiguous(), x["mask"],
                 torch.stack([x["h0"]] * L), torch.stack([x["c0"]] * L))
        _close(twave.lstm_stack_wavefront(*wargs), twave.lstm_stack_wavefront_plain(*wargs), tol)
    fargs = (x["x_proj"], x["w_h"], x["mask"], x["h0"], x["c0"], rd)
    _close(tlt.recurrence_train(*fargs), tlt.recurrence_train_plain(*fargs), tol)
    lean = (x["x_proj"].to(rd),) + fargs[1:]
    _close(tlt.recurrence_train_lean(*lean), tlt.recurrence_train_lean_plain(*lean), tol)
    _, _, _, gates, cseq = tlt.recurrence_train_plain(*fargs)
    tail = (x["mask"], x["w_h"], x["dhn"], x["dcn"])
    c0r = x["c0"].to(rd).float()
    _close(tlt.recurrence_bwd(x["dout"], gates.clone(), cseq, c0r, *tail),
           tlt.recurrence_bwd_plain(x["dout"], gates.clone(), cseq, c0r, *tail), tol)
    rargs = _recompute_args(x, rd)
    _close(tlt.recurrence_bwd_recompute(*rargs), tlt.recurrence_bwd_recompute_plain(*rargs), tol)
    g = torch.Generator().manual_seed(12)
    lim = (6.0 / (5 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim).to(cuda, cd)
    stack = (x["x"], w(D, 4 * H), w(L, H, 4 * H), w(L - 1, H, 4 * H),
             (torch.randn((L, 4 * H), generator=g) * 0.1).to(cuda), x["mask"],
             torch.stack([x["h0"]] * L), torch.stack([x["c0"]] * L), rd, 2, (7, 9), 1 / 0.6, 0.6)
    got = twave.wavefront_train(*stack)
    ref = twave.wavefront_train_plain(*stack)
    _close(got, ref, tol)
    outs, gates, cseq = ref[:3]
    bargs = (x["dout"].to(rd), stack[2], stack[3], x["mask"])
    btail = (cseq, torch.stack([c0r] * L), torch.stack([x["dhn"]] * L),
             torch.stack([x["dcn"]] * L), outs, 2, (7, 9), 1 / 0.6, 0.6)
    _close(twave.wavefront_bwd(*bargs, gates.clone(), *btail),
           twave.wavefront_bwd_plain(*bargs, gates.clone(), *btail), tol)
    torch.cuda.synchronize()
