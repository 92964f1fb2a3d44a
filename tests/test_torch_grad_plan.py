"""The weight-gradient kernel's plan (``ops/grad_matmul.py``): which tile
product runs for each call site's shape, and how K is split.  Both are
decided in Python from the shapes alone, so they are tested here without a
card: the same plan on every call (the sums run in one order, so a run
repeats bit for bit), slices that cover [0, N) exactly in whole K steps,
and no partial dW buffers when K is not split (on the ``meta`` device).
"""

import pytest
import torch

from rnn_speech_tpu_torch.ops import grad_matmul as tgm

bf, f32 = torch.bfloat16, torch.float32
SMS = 132   # the H100 SXM's SMs

# (site, operand widths, N, G, dg dtype, expected path): the default step
# (T=3510, B=64), the wide step's _hgrad_only at B=394, the fused pass's
# window products at B=96 and B=394 (128 steps, and a ragged last window),
# the input and output projections with f32 and bf16 dg, and the H=64
# shapes of the CPU tests.
SITES = [
    ("dgates_weight_grads B=64", [1024, 1024], 3510 * 64, 4096, bf, "wgmma"),
    ("layer 0 dgates_weight_grads (fbank input)", [1024, 120], 3510 * 64, 4096, bf, "wmma"),
    ("_hgrad_only B=394", [1024], 3510 * 394, 4096, bf, "wgmma"),
    ("window B=96", [1024], 128 * 96, 4096, bf, "wgmma"),
    ("ragged window B=394", [1024], 54 * 394, 4096, bf, "wgmma"),
    ("input projection, f32 dg", [120], 3510 * 64, 1024, f32, "wmma"),
    ("input projection, bf16 dg", [120], 3510 * 64, 1024, bf, "wmma"),
    ("output projection", [1024], 3510 * 64, 80, f32, "wmma"),
    ("output projection, bf16 dg", [1024], 3510 * 64, 80, bf, "wmma"),
    ("LSTM, f32 dgates", [1024, 1024], 3510 * 64, 4096, f32, "wmma"),
    ("H=64 test stack", [64, 64], 9 * 5, 256, bf, "wgmma"),
    ("H=64 layer 0 (D=120)", [64, 120], 9 * 5, 256, bf, "wmma"),
    ("H=64 ragged G", [64, 64], 21, 260, bf, "wmma"),
    ("H=200 test", [200, 24], 333, 1030, bf, "wmma"),
    ("D=128, G=256", [128], 5000, 256, bf, "wgmma"),
    ("empty", [1024], 0, 4096, bf, "wgmma"),
]


@pytest.mark.parametrize("site,dims,N,G,dtype,path", SITES, ids=[s[0] for s in SITES])
def test_plan_path_and_k_partition(site, dims, N, G, dtype, path):
    pl = tgm.plan(dims, N, G, dtype, SMS)
    assert pl.path == path
    assert tgm.product_path(dims, G, dtype) == path
    step = tgm.TILES[path][2]
    assert pl.splits >= 1 and pl.rows_per_split > 0
    assert pl.rows_per_split % step == 0                    # whole K steps
    # The slices [s·rows, min(N, (s+1)·rows)) cover [0, N) without overlap
    # and none is empty (only N = 0 has one empty slice).
    bounds = [(s * pl.rows_per_split, min(N, (s + 1) * pl.rows_per_split))
              for s in range(pl.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo < hi for lo, hi in bounds) or N == 0
    if N:
        assert pl.splits == 1 or pl.rows_per_split >= 1024  # a slice keeps >= 1024 rows
    assert pl == tgm.plan(list(dims), N, G, dtype, SMS)    # the same plan every call


def test_lstm_products_fill_the_card_without_splitting_k():
    """The stacked default-step product (256 tiles) and the one-operand
    LSTM products (128 tiles) keep 97% of the last wave busy on 132 SMs,
    so K stays whole: one sum order, no partials, no second pass."""
    for dims in ([1024, 1024], [1024]):
        assert tgm.plan(dims, 3510 * 64, 4096, bf, SMS).splits == 1


def test_small_outputs_split_k_to_fill_the_card():
    pl = tgm.plan([128], 5000, 256, bf, SMS)       # one output tile
    assert pl.splits == 4 and pl.rows_per_split == 1280
    wm = tgm.plan([120], 3510 * 64, 1024, f32, SMS)
    assert wm.path == "wmma" and wm.splits == 66   # four WMMA blocks per SM


@pytest.mark.parametrize("dims,N,G,dtype", [([1024, 1024], 3510 * 64, 4096, bf),
                                            ([128], 5000, 256, bf),
                                            ([120], 3510 * 64, 1024, f32)])
def test_partial_buffers_only_when_k_is_split(dims, N, G, dtype):
    """The f32 partial dW only with more than one split.  db's partials:
    the WMMA tile's per split, the Hopper tile's db pass's one row per
    COLUMN_ROWS rows of dg whatever the split (a 3.5 MiB scratch at the
    default step, against the 32 MiB of a partial dW)."""
    pl = tgm.plan(dims, N, G, dtype, SMS)
    dw, db, partial, partial_db = tgm._buffers(pl, sum(dims), N, G, "meta")
    assert dw.shape == (sum(dims), G) and db.shape == (G,)
    assert dw.dtype == db.dtype == f32 and dw.device.type == "meta"
    if pl.splits == 1:
        assert partial is None
    else:
        assert partial.shape == (pl.splits, sum(dims), G)
    if pl.path == "wgmma":
        assert partial_db.shape == (-(-N // tgm.COLUMN_ROWS), G)
    elif pl.splits == 1:
        assert partial_db is None
    else:
        assert partial_db.shape == (pl.splits, G)


def test_no_buffers_beyond_the_outputs_for_an_empty_product():
    pl = tgm.plan([1024], 0, 4096, bf, SMS)
    assert tgm._buffers(pl, 1024, 0, 4096, "meta")[2:] == (None, None)


def test_plan_depends_on_the_card_only_through_its_sms():
    """A card with fewer SMs fills with fewer blocks: the plan changes
    with ``sms`` and nothing else of the device."""
    assert tgm.plan([128], 5000, 256, bf, 4).splits == 4
    assert tgm.plan([128], 5000, 256, bf, 1).splits == 1
