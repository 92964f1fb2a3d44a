"""The layer backward on its persistent kernel past one 64-row group, in
both residual modes (rows 6 and 8: ``ops/lstm_layer_train.py``
``bwd_plan``, ``bwd_smem``, ``_recompute_persistent_launch``;
``csrc/lstm_layer_bwd_persistent.cu``), and the bounds-checked build
(``ops/_build.py``), on the CPU.  The kernel runs only on the card; what
decides its grid and shared memory, the order in which its CTAs and
warpgroups walk the row groups and the rebuild chunks, and what its launch
is handed, is tested here.

The order of work against the JAX package: a walk of the recompute
backward as the kernel runs it (one launch a rebuild chunk, last first;
in each, pass s forms the carry's product of dgates(t1 - s) per 64-unit
slice and eighth of K = 4H, the eight (rows, 64) partials summed in the
order of the eighths, for each 64-row group in turn, the group's
warpgroup g mod 2; then the cell of step t1-1-s from the chunk's float32
rebuild; the carries in global buffers between launches; the dh0 pass in
the launch that ends at 0), at H=128, D=128, B=70 and 130 (two and three
row groups), T=9 and T=5 with rebuild chunks of 4 steps (three launches,
the first of one step; two launches, one step past a chunk), ragged
lengths with a zero-length row, against ``_lstm_recurrence_bwd_recompute``
in TPU interpret mode and against ``recurrence_bwd_recompute_plain``.
Both sides round the same operands to bf16 and sum in float32 in another
order; where two sums straddle a bf16 rounding of a dgate the result moves
by one step (2^-8 relative) and propagates: 4e-3 relative and absolute,
the tolerance of ``tests/test_torch_persistent_plan.py``.
"""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import lstm_pallas as jpal
from rnn_speech_tpu_torch.ops import _build
from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

SMEM_OPT_IN = 232448          # bytes of shared memory a block may use on the H100
BF16 = dict(rtol=4e-3, atol=4e-3)
f32, bf16 = torch.float32, torch.bfloat16


# ------------------------------------------------------------------- the plan


@pytest.mark.parametrize("mode", ["gates", "recompute"])
@pytest.mark.parametrize("B", [400, 473])
def test_plan_sends_both_recompute_batches_to_the_persistent_kernel(B, mode):
    """The recompute step's batch (B=400) and the widest recompute batch
    (B=473) at H=1024 on the H100's 132 SMs, asked by either wrapper (one
    plan for both modes): 128 CTAs whatever the batch, ceil(B/64) row groups
    walked in turn by two consumer warpgroups, the W_h slice beside one A
    buffer a warpgroup within the shared memory; the same answer every time."""
    plan = tlt.bwd_plan(B, 1024, tlt.H100_SMS)
    assert plan["kernel"] == "persistent"
    assert plan["groups"] == -(-B // 64) and plan["rows"] == 64 * plan["groups"] >= B
    assert plan["warpgroups"] == 2
    assert plan["grid"] == plan["slices"] * tlt.BWD_SPLIT == 128 <= tlt.H100_SMS
    assert plan["smem"] == tlt.bwd_smem(1024, 2) <= tlt.SMEM_LIMIT == SMEM_OPT_IN
    assert plan["smem"] == 8 * 8192 * 3 + 8 * (1 + 2 + 2 * 8) + 1024
    assert all(tlt.bwd_plan(B, 1024) == plan for _ in range(3))


@pytest.mark.parametrize("B,H,sms", [(1, 1024, 132), (64, 1024, 132), (65, 1024, 132),
                                     (128, 1024, 132), (129, 512, 132), (4096, 128, 132)])
def test_plan_grid_does_not_grow_with_the_batch(B, H, sms):
    """One warpgroup for one row group (the layered step's B=64, as before),
    two past it; the grid is H/64 x 8 CTAs at any batch."""
    plan = tlt.bwd_plan(B, H, sms)
    assert plan["kernel"] == "persistent"
    assert plan["grid"] == H // 64 * 8
    assert plan["warpgroups"] == (1 if B <= 64 else 2)
    assert plan["smem"] == tlt.bwd_smem(H, plan["warpgroups"]) <= SMEM_OPT_IN


@pytest.mark.parametrize("B,H,sms", [(400, 1024, 114), (400, 96, 132), (473, 64, 132),
                                     (400, 1152, 132), (400, 2048, 1000), (64, 2048, 1000),
                                     (0, 1024, 132)])
def test_plan_sends_what_it_cannot_take_to_the_per_step_kernel(B, H, sms):
    """A grid larger than the card (114 SMs; 18 slices at H=1152), H not a
    multiple of 128, a W_h slice and A buffers past the shared memory (H=2048
    with one or two warpgroups, on a card of 1000 SMs), or no batch."""
    assert tlt.bwd_plan(B, H, sms) == {"kernel": "per_step"}


@pytest.mark.parametrize("B", [70, 130, 400])
@pytest.mark.parametrize("H", [128, 1024])
def test_ctas_warpgroups_and_row_groups_cover_each_row_and_unit_once(H, B):
    """CTA (u, q) holds W_h[64u .. 64u + 64, Kq .. Kq + K), K = 4H/8: every
    element of W_h once; thread wt of warpgroup w, for each row group g = w
    mod 2 (in turn), runs row 64g + wt/2, units 64u + 8q + 4(wt%2) + 0..3:
    every (row, unit) of a step exactly once, rows past B in no cell."""
    plan = tlt.bwd_plan(B, H)
    U, S, wgs = tlt.BWD_UNITS, tlt.BWD_SPLIT, plan["warpgroups"]
    K = 4 * H // S
    seen = torch.zeros((H, 4 * H), dtype=torch.int64)
    cells = torch.zeros((plan["rows"], H), dtype=torch.int64)
    for u in range(plan["slices"]):
        for q in range(S):
            seen[U * u:U * u + U, q * K:(q + 1) * K] += 1
            for w in range(wgs):
                for g in range(w, plan["groups"], wgs):
                    for wt in range(128):
                        j = U * u + 8 * q + 4 * (wt % 2)
                        cells[64 * g + wt // 2, j:j + 4] += 1
    assert bool((seen == 1).all())
    assert bool((cells == 1).all())
    assert plan["rows"] - B < 64                   # the last group holds a real row


@pytest.mark.parametrize("first", [True, False], ids=["from_T", "inner_chunk"])
@pytest.mark.parametrize("groups", [1, 2, 3, 7, 8])
def test_a_buffer_uses_agree_between_producer_and_warpgroups(groups, first):
    """The kernel's use counts of its A buffers (one a warpgroup): the
    producer loads the groups of every product pass in the order 0, 1, 2, ...
    into buffer g mod 2 (u = product passes before x the buffer's groups a
    pass + g div 2), and each warpgroup consumes its own groups in turn with
    the same u; so a buffer's uses are 0, 1, 2, ... in both orders (its full
    and release barriers alternate parities) for (s, g) alike.  A launch
    from T has no product in pass 0; a later chunk's launch has (the
    previous launch's dgates)."""
    wgs = 1 if groups == 1 else 2
    steps, skip = 5, 1 if first else 0
    passes = steps + 1
    loads = {w: [] for w in range(wgs)}
    for s in range(skip, passes):
        pi = s - skip
        for g in range(groups):
            w = g % wgs
            loads[w].append((s, g, pi * ((groups - w + wgs - 1) // wgs) + g // wgs))
    for w in range(wgs):
        mine = (groups - w + wgs - 1) // wgs
        uses = [(s, w + wgs * gi, (s - skip) * mine + gi)
                for s in range(passes) if s > 0 or not first for gi in range(mine)]
        assert loads[w] == uses
        assert [u for *_, u in uses] == list(range(len(uses)))


# ------------------------------------------------------------ the launch


class _Entry:
    """Stands in for the C entry: records its arguments, returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@contextlib.contextmanager
def _stand_ins(monkeypatch, entry):
    monkeypatch.setattr(tlt, "_lib_fn", lambda lib, name, argtypes: entry)
    monkeypatch.setattr(tlt, "_lib_count", lambda lib, name: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "launch_stream", lambda dev: 0)
    yield


def _args(T, B, H=128, D=128):
    z = lambda *s, dtype=f32: torch.zeros(s, dtype=dtype)
    return (z(T, B, H), z(T, B, D, dtype=bf16), z(T, B, H, dtype=bf16), z(T, B, H, dtype=bf16),
            z(B, H), z(T, 1, B), z(D, 4 * H, dtype=bf16), z(4 * H), z(H, 4 * H, dtype=bf16),
            z(B, H), z(B, H))


@pytest.mark.parametrize("T,B", [(9, 70), (5, 130)])
def test_recompute_launch_hands_the_kernel_the_chunks_and_the_plan(T, B, monkeypatch):
    """One call of the recompute entry: the rebuild chunks' starts last
    first (``rebuild_chunks``), the chunk's steps, the plan's row groups;
    a non-zero return raises, the planted fault is passed through."""
    H = 128
    monkeypatch.setattr(tlt, "REBUILD_BYTES", 4 * B * 4 * H * 4)
    entry = _Entry()
    args = _args(T, B, H=H, D=H)
    plan = tlt.bwd_plan(B, H)
    with _stand_ins(monkeypatch, entry):
        dgates, dh, dc, rebuilds = tlt._recompute_persistent_launch(*args, plan)
        call = entry.calls[-1]
        chunk = tlt.rebuild_chunk(T, B, H)
        starts = list(call[15])
        assert starts == [t0 for t0, _ in tlt.rebuild_chunks(T, chunk)]
        assert call[16:24] == (len(starts), chunk, T, B, H, H, plan["groups"], 0)
        assert dgates.shape == (T, B, 4 * H) and dgates.dtype == bf16
        assert rebuilds == 0
        tlt._recompute_persistent_launch(*args, plan, skip_barrier=1)
        assert entry.calls[-1][23] == 1
        entry.rc = 700
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            tlt._recompute_persistent_launch(*args, plan)
    assert isinstance(call[15], ctypes.Array)


def test_scratch_follows_the_plan():
    plan = tlt.bwd_plan(473, 1024)
    part, counter = tlt._bwd_scratch(plan, "cpu")
    assert part.shape == (8, 16, 8, 64, 64) and part.dtype == f32
    assert counter.shape == (8 * (1 + 16),) and counter.dtype == torch.int32


# ---------------------------------------------------- the order of work


def _recompute_in_kernel_order(dout, x, h_prev, cseq, c0, mask, w_x, b, w_h, dhn, dcn):
    """The recompute backward as the persistent kernel runs it (module
    docstring).  The dgates stream starts as NaN, so a read of a step no
    launch has written yet shows.  Returns (dgates, dh0, dc0, launches)."""
    T, B, H = cseq.shape
    D = x.shape[-1]
    plan = tlt.bwd_plan(B, H)
    U, S, wgs, groups = tlt.BWD_UNITS, tlt.BWD_SPLIT, plan["warpgroups"], plan["groups"]
    Kq = 4 * H // S
    w = w_h.to(f32)
    dg_stream = torch.full((T, B, 4 * H), float("nan")).to(bf16)
    dhc, dcc = dhn.to(f32).clone(), dcn.to(f32).clone()      # the carries between launches
    launches = 0
    for t0, t1 in tlt.rebuild_chunks(T, tlt.rebuild_chunk(T, B, H)):
        act = tlt.rebuild_gates_plain(x[t0:t1].reshape(-1, D), h_prev[t0:t1].reshape(-1, H),
                                      w_x, w_h, b).reshape(t1 - t0, B, 4 * H)
        launches += 1
        steps, first = t1 - t0, t1 == T
        for s in range(steps + (t0 == 0)):
            t = t1 - 1 - s
            for wg in range(wgs):
                for g in range(wg, groups, wgs):
                    rows = slice(64 * g, min(B, 64 * g + 64))
                    ph = torch.zeros((rows.stop - rows.start, H))
                    if s > 0 or not first:
                        a = dg_stream[t + 1, rows].to(f32)
                        for u in range(H // U):
                            J = slice(U * u, U * u + U)
                            acc = torch.zeros((rows.stop - rows.start, U))
                            for q in range(S):
                                K = slice(q * Kq, (q + 1) * Kq)
                                acc = acc + a[:, K] @ w[J, K].t()
                            ph[:, J] = acc
                    dh, dc = dhc[rows], dcc[rows]
                    if s == steps:                  # the dh0 pass
                        dhc[rows] = dh + ph
                        continue
                    i_a, g_a, f_a, o_a = act[t - t0, rows].split(H, dim=-1)
                    m = mask[t, 0, rows][:, None]
                    tanh_c = torch.tanh(cseq[t, rows].to(f32))
                    c_p = cseq[t - 1, rows].to(f32) if t > 0 else c0[rows].to(f32)
                    dh_carry = dh + ph
                    dh_new = m * (dout[t, rows] + dh_carry)
                    do_pre = dh_new * tanh_c * o_a * (1 - o_a)
                    dc_new = dh_new * o_a * (1 - tanh_c * tanh_c) + m * dc
                    di = dc_new * g_a * i_a * (1 - i_a)
                    dgg = dc_new * i_a * (1 - g_a * g_a)
                    df = dc_new * c_p * f_a * (1 - f_a)
                    dg_stream[t, rows] = torch.cat([di, dgg, df, do_pre], dim=-1).to(bf16)
                    dhc[rows] = (1 - m) * dh_carry
                    dcc[rows] = (1 - m) * dc + dc_new * f_a
    return dg_stream, dhc, dcc, launches


def _problem(T, B, H, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: rng.normal(0, scale, s).astype(np.float32)
    rd = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    lens = np.asarray([T if b == 0 else (0 if b == 2 else 1 + (7 * b) % T) for b in range(B)])
    return dict(dout=f(T, B, H, scale=1.0), x=rd(f(T, B, D, scale=1.0)),
                h_prev=rd(f(T, B, H, scale=0.5)), cseq=rd(f(T, B, H, scale=0.7)),
                c0=rd(f(B, H, scale=0.5)),
                mask=(np.arange(T)[:, None] < lens[None]).astype(np.float32)[:, None, :],
                w_x=rd(f(D, 4 * H, scale=0.1)), b=f(4 * H, scale=0.1),
                w_h=rd(f(H, 4 * H, scale=0.1)), dhn=f(B, H, scale=0.5),
                dcn=f(B, H, scale=0.5))


ORDER = ("dout", "x", "h_prev", "cseq", "c0", "mask", "w_x", "b", "w_h", "dhn", "dcn")
IN_BF16 = ("x", "h_prev", "cseq", "w_x", "w_h")


@pytest.mark.parametrize("T,launches", [(9, 3), (5, 2)])
@pytest.mark.parametrize("B", [70, 130])
def test_kernel_order_matches_jax_recompute_backward(B, T, launches, monkeypatch):
    H, D, chunk = 128, 128, 4
    monkeypatch.setattr(tlt, "REBUILD_BYTES", chunk * B * 4 * H * 4)
    assert tlt.rebuild_chunk(T, B, H) == chunk
    assert tlt.bwd_plan(B, H)["groups"] == -(-B // 64) in (2, 3)
    p = _problem(T, B, H, D, seed=B + T)
    args = [torch.tensor(p[k]).to(bf16 if k in IN_BF16 else f32) for k in ORDER]
    got = _recompute_in_kernel_order(*args)
    assert got[3] == launches
    dgates, dh0, dc0 = got[:3]
    assert dgates.dtype == bf16 and bool(torch.isfinite(dgates.float()).all())
    plain = tlt.recurrence_bwd_recompute_plain(*args)

    j = {k: jnp.asarray(p[k], jnp.bfloat16 if k in IN_BF16 else jnp.float32) for k in ORDER}
    c_prev = jnp.concatenate([j["c0"].astype(jnp.bfloat16)[None], j["cseq"][:-1]], axis=0)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(jpal._lstm_recurrence_bwd_recompute)(
            j["dout"], j["x"], j["h_prev"], j["cseq"], c_prev, j["mask"], j["w_x"],
            j["b"].reshape(1, -1), j["w_h"], j["dhn"], j["dcn"])
    for r, g_, pl_ in zip(ref, (dgates, dh0, dc0), plain):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g_.float().numpy(), r, **BF16)
        np.testing.assert_allclose(pl_.float().numpy(), r, **BF16)
    # The zero-length row: no dgates, dh and dc pass through.
    assert not dgates[:, 2].float().any()
    assert torch.equal(dc0[2], args[10][2])
    np.testing.assert_allclose(dh0[2].numpy(), p["dhn"][2], rtol=0, atol=0)


# ------------------------------------------------------ the checked build


def test_check_flag_changes_the_library_name_and_the_default_name_does_not(monkeypatch):
    monkeypatch.delenv(_build.CHECK_ENV, raising=False)
    default = _build.library_path("lstm_layer_bwd_persistent")
    assert "-DRST_BOUNDS_CHECK" not in _build.nvcc_flags() and not _build.checked()
    monkeypatch.setenv(_build.CHECK_ENV, "0")
    assert _build.library_path("lstm_layer_bwd_persistent") == default
    monkeypatch.setenv(_build.CHECK_ENV, "1")
    checked = _build.library_path("lstm_layer_bwd_persistent")
    assert _build.checked() and "-DRST_BOUNDS_CHECK" in _build.nvcc_flags()
    assert checked != default and "-checked-" in checked.name
    assert checked.parent == default.parent
    monkeypatch.delenv(_build.CHECK_ENV)
    assert _build.library_path("lstm_layer_bwd_persistent") == default
    assert "-checked-" not in default.name


def test_bounds_check_header_compiles_to_nothing_without_the_flag():
    """Every persistent kernel includes the header; without the flag the
    macro expands to an empty statement."""
    text = (_build.CSRC_DIR / "bounds_check.cuh").read_text()
    off = text.rsplit("#else", 1)[1]
    assert "RST_CHECK(idx, bound)" in off and "printf" not in off and "trap" not in off
    for name in ("lstm_wavefront_persistent.cu", "lstm_wavefront_eval.cu",
                 "lstm_wavefront_bwd_persistent.cu", "dwx_windows.cuh", "lstm_layer_lean.cu",
                 "lstm_layer_bwd_persistent.cu"):
        src = (_build.CSRC_DIR / name).read_text()
        assert '#include "bounds_check.cuh"' in src and "RST_CHECK(" in src


def test_tree_digest_ties_a_run_to_its_files(tmp_path):
    extra = tmp_path / "chip_smoke.py"
    extra.write_text("a")
    first = _build.tree_digest([extra])
    assert first == _build.tree_digest([extra]) and len(first) == 64
    extra.write_text("b")
    assert _build.tree_digest([extra]) != first


PERSISTENT_SOURCES = ("lstm_wavefront_persistent.cu", "lstm_wavefront_eval.cu",
                      "lstm_wavefront_bwd_persistent.cu", "lstm_layer_lean.cu",
                      "lstm_layer_bwd_persistent.cu")


@pytest.mark.parametrize("name", PERSISTENT_SOURCES)
def test_every_counter_arrival_is_bounds_checked(name):
    """Each atomic arrival on a barrier counter has its index checked in the
    lines just before it, so the checked build sees a counter past its
    buffer (the partials' indices are held the same way at their use)."""
    lines = (_build.CSRC_DIR / name).read_text().splitlines()
    arrivals = [i for i, ln in enumerate(lines) if "atomicAdd(" in ln]
    assert arrivals
    for i in arrivals:
        assert any("RST_CHECK(" in ln for ln in lines[max(0, i - 4):i]), (name, i + 1)


@pytest.mark.parametrize("skip_barrier", [1, 2, 3, 4])
def test_planted_faults_reach_the_recompute_entry(skip_barrier, monkeypatch):
    """Bits 1 and 2 leave out the step and slice waits; bit 4, the bounds
    checks' positive control, states the rebuild buffer a step short.  The
    wrapper hands each to the C entry as it is, with the dgates stream a
    check gives it."""
    T, B, H = 9, 70, 128
    entry = _Entry()
    plan = tlt.bwd_plan(B, H)
    stream = torch.full((T, B, 4 * H), float("nan"), dtype=bf16)
    with _stand_ins(monkeypatch, entry):
        dgates = tlt._recompute_persistent_launch(*_args(T, B, H=H, D=H), plan,
                                                  skip_barrier=skip_barrier, dgates=stream)[0]
    assert entry.calls[-1][23] == skip_barrier
    assert dgates is stream and entry.calls[-1][1] == stream.data_ptr()


# ----------------------------------------- the card script's bookkeeping


def _chip_smoke():
    import chip_smoke
    return chip_smoke


def test_fault_hunt_child_reports_its_trap_lines():
    """A child that prints an RST_CHECK line and exits non-zero, as the
    checked build's trap does, is recorded with its exit code and the line;
    a clean child with neither."""
    cs = _chip_smoke()
    env = {k: v for k, v in __import__("os").environ.items() if k != _build.CHECK_ENV}
    trapped = cs._hunt_child(["-c", "print('RST_CHECK a.cu:1 k: i = 9 outside [0, 8)'); "
                                    "raise SystemExit(3)"], env)
    assert trapped["rc"] == 3 and trapped["tail"]
    assert trapped["fault_lines"] == ["RST_CHECK a.cu:1 k: i = 9 outside [0, 8)"]
    clean = cs._hunt_child(["-c", "print('ok')"], env)
    assert clean["rc"] == 0 and clean["fault_lines"] == [] and clean["tail"] == ""


def test_grad_study_reads_the_seed_two_gates_earlier_phases_took(monkeypatch):
    """Seed 2 at the default keeps is the gate of train, train_layered's
    recompute route and each alt route: grad_study reads those entries from
    the record instead of taking them again, and only those."""
    cs = _chip_smoke()
    keeps = [cs.INPUT_KEEP, cs.OUTPUT_KEEP]
    gate = lambda **kw: {"seed": 2, "use_pallas_ctc": True, "keep_probs": keeps, **kw}
    monkeypatch.setattr(cs, "RECORD", {
        "train": {"grad_check": gate()},
        "train_layered": {"grad_check": {"recompute": gate(model={"residual_mode": "x"})}},
        "alt_routes": {"routes": {"seed_drop_off": {"grad_check": gate()},
                                  "other": {"grad_check": gate(seed=5)},
                                  "keep1": {"grad_check": gate(keep_probs=[1.0, 1.0])}}}})
    taken = cs._gates_taken()
    assert set(taken) == {("default", 2, tuple(keeps)), ("recompute", 2),
                          ("seed_drop_off", 2)}
    assert {k: v["read_from"] for k, v in taken.items()} == {
        ("default", 2, tuple(keeps)): "train", ("recompute", 2): "train_layered",
        ("seed_drop_off", 2): "alt_routes"}
    monkeypatch.setattr(cs, "RECORD", {})
    assert cs._gates_taken() == {}


def test_part_seconds_gathers_each_helpers_time_and_calls(monkeypatch):
    cs = _chip_smoke()
    for name in ("_rel_check", "_fault_check", "_layer_inputs"):
        monkeypatch.setattr(cs, name, getattr(cs, name))      # restored after the test
    monkeypatch.setattr(cs, "_rel_check", lambda *a: 0.5)
    parts = {}
    cs._time_parts(parts)
    assert cs._rel_check() == 0.5 and cs._rel_check() == 0.5
    assert parts["_rel_check"][1] == 2 and parts["_rel_check"][0] >= 0.0
    assert "_layer_inputs" not in parts and "main" not in parts


def test_a_planted_fault_fails_the_check_by_its_error_or_a_non_finite_output():
    """A planted fault is seen when its relative error passes the check's
    tolerance or when an output is not finite (a stale read of a stream
    nothing wrote yet), which ``_rel_check`` fails too; one within the
    tolerance stops the run."""
    cs = _chip_smoke()
    ref = (torch.ones(3, 2, 5), torch.ones(2, 5))
    checks = []
    cs._fault_check("far", (ref[0] * 2, ref[1]), ref, 1e-2, checks)
    assert checks[-1]["rel_err"] == [1.0, 0.0]
    stale = ref[0].clone()
    stale[1, 0, 3] = float("nan")
    cs._fault_check("stale", (stale, ref[1]), ref, 1e-2, checks)
    assert checks[-1]["rel_err"] == "non-finite"
    with pytest.raises(SystemExit, match="does not see"):
        cs._fault_check("near", (ref[0] * 1.001, ref[1]), ref, 1e-2, checks)
    with pytest.raises(SystemExit, match="stale: bad shape or non-finite"):
        cs._rel_check("stale", (stale, ref[1]), ref, 1e-2, checks)
