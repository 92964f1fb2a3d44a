"""The weight-gradient kernel's plan (``ops/grad_matmul.py``): which tile
product runs for each call site's shape, and how K is split.  Both are
decided in Python from the shapes alone, so they are tested here without a
card: the same plan on every call (the sums run in one order, so a run
repeats bit for bit), slices that cover [0, N) exactly in whole K steps,
and no partial dW buffers when K is not split (on the ``meta`` device).
The skinny tile's plan (the projections): which operand is the wide one,
its column chunks and K slices (each wide element in exactly one block,
about one block per SM, no slice past one accumulation chain), and the
ring's stages within the shared memory of a block.
"""

import pytest
import torch

from rnn_speech_tpu_torch.ops import grad_matmul as tgm

bf, f32 = torch.bfloat16, torch.float32
SMS = 132   # the H100 SXM's SMs

# (site, operand widths, N, G, dg dtype, expected path): the default step
# (T=3510, B=64), the wide step's _hgrad_only at B=394, the fused pass's
# window products at B=96 and B=394 (128 steps, and a ragged last window),
# the input and output projections with f32 and bf16 dg (the skinny tile),
# and the H=64 shapes of the CPU tests.
SITES = [
    ("dgates_weight_grads B=64", [1024, 1024], 3510 * 64, 4096, bf, "wgmma"),
    ("layer 0 dgates_weight_grads (fbank input)", [1024, 120], 3510 * 64, 4096, bf, "wmma"),
    ("_hgrad_only B=394", [1024], 3510 * 394, 4096, bf, "wgmma"),
    ("window B=96", [1024], 128 * 96, 4096, bf, "wgmma"),
    ("ragged window B=394", [1024], 54 * 394, 4096, bf, "wgmma"),
    ("input projection, f32 dg", [120], 3510 * 64, 1024, f32, "skinny"),
    ("input projection, bf16 dg", [120], 3510 * 64, 1024, bf, "skinny"),
    ("output projection", [1024], 3510 * 64, 80, f32, "skinny"),
    ("output projection, bf16 dg", [1024], 3510 * 64, 80, bf, "skinny"),
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
    wm = tgm.plan([1024, 120], 3510 * 64, 4096, bf, SMS)   # layer 0's stacked operands
    assert wm.path == "wmma" and wm.splits == 2    # 288 tiles: four WMMA blocks per SM
    sk = tgm.plan([120], 3510 * 64, 1024, f32, SMS, f32)   # the input projection
    assert sk.path == "skinny" and sk.chunks * sk.splits == 128   # one block per SM


# The projections of the default step (N = T·B = 224,640): the input
# projection (x the f32 features, D = 120; dg 1024 wide, f32 or bf16) and
# the output projection (x the bf16 dropped top layer, D = 1024; dg the 80
# labels, f32 or bf16): (x dtype, D, G, dg dtype, wide operand, stages).
PROJECTIONS = [
    (f32, 120, 1024, f32, "dg", 3),
    (f32, 120, 1024, bf, "dg", 4),
    (bf, 1024, 80, f32, "x", 5),
    (bf, 1024, 80, bf, "x", 6),
]


@pytest.mark.parametrize("a_dtype,D,G,dg_dtype,wide,stages", PROJECTIONS)
def test_skinny_plan_at_the_projections(a_dtype, D, G, dg_dtype, wide, stages):
    """Both projections take the skinny tile: the narrow side (120 or 80)
    whole in a block, the 1024-wide operand in 8 chunks of 128 columns,
    16 K slices of 14,080 rows (220 stages of 64): 128 blocks on 132 SMs;
    as many raw stages as fit beside the bf16 strips the product reads."""
    N = 3510 * 64
    pl = tgm.plan([D], N, G, dg_dtype, SMS, a_dtype)
    assert pl.path == "skinny" and pl.wide == wide
    assert (pl.chunks, pl.splits, pl.rows_per_split) == (8, 16, 14080)
    assert pl.stages == stages and pl.smem <= tgm.SMEM_LIMIT
    assert pl.rows_per_split <= tgm.SKINNY_CHAIN_ROWS


def test_lstm_shapes_stay_on_the_hopper_tile():
    """The LSTM-shape calls of both wrappers keep the wgmma tile: the stacked
    dgates product and _hgrad_only's one-operand product (D = 1024 and
    G = 4096 are both wide)."""
    for dims in ([1024, 1024], [1024]):
        assert tgm.plan(dims, 3510 * 64, 4096, bf, SMS).path == "wgmma"
    assert tgm.product_path([1024], 4096, f32) == "wmma"     # f32 dgates: no tile above
    assert tgm.product_path([512], 2048, f32) == "wmma"      # both sides wide


@pytest.mark.parametrize("D,N,G", [(120, 3510 * 64, 1024), (1024, 3510 * 64, 80),
                                   (1024, 3510 * 394, 80), (120, 5000, 80), (24, 333, 16),
                                   (136, 4999, 200), (256, 1, 256), (8, 70001, 1032)])
def test_skinny_reads_the_wide_operand_once(D, N, G):
    """Each element of the wide operand lies in exactly one block: the
    128-column chunks cover its width once (the last may be ragged, never
    empty) and the K slices cover [0, N) once in whole 64-row stages, none
    empty and none longer than one accumulation chain.  The narrow side
    fits one block's tile."""
    pl = tgm.plan([D], N, G, f32, SMS, f32)
    assert pl.path == "skinny"
    w, n = (G, D) if pl.wide == "dg" else (D, G)
    assert w >= n and n <= tgm.SKINNY_NARROW
    assert (pl.chunks - 1) * 128 < w <= pl.chunks * 128
    assert pl.rows_per_split % 64 == 0 and pl.rows_per_split <= tgm.SKINNY_CHAIN_ROWS
    assert (pl.splits - 1) * pl.rows_per_split < N <= pl.splits * pl.rows_per_split
    assert pl.splits == 1 or pl.rows_per_split >= 1024
    assert pl.chunks * pl.splits <= max(SMS, pl.chunks * -(-N // tgm.SKINNY_CHAIN_ROWS))


@pytest.mark.parametrize("a_dtype", [f32, bf])
@pytest.mark.parametrize("dg_dtype", [f32, bf])
@pytest.mark.parametrize("n", [8, 80, 120, 200, 248])
def test_skinny_shared_memory_stays_within_a_block(a_dtype, dg_dtype, n):
    """At narrow widths up to 248 (multiples of 64 beside a bf16 dg of 1024
    go to the Hopper tile) and every pair of dtypes the ring keeps 2 to 8
    stages and the block's shared memory stays within the 227 KB a block
    may use; the widest case (256 f32 columns beside 128 f32 ones, in
    32-row stages) still holds four 48 KiB stages."""
    for D, G in ((n, 1024), (1024, n)):
        pl = tgm.plan([D], 3510 * 64, G, dg_dtype, SMS, a_dtype)
        assert pl.path == "skinny" and 2 <= pl.stages <= tgm.SKINNY_MAX_STAGES
        assert pl.smem <= tgm.SMEM_LIMIT
        w_bytes = 4 if (dg_dtype if pl.wide == "dg" else a_dtype) == f32 else 2
        n_bytes = 4 if (a_dtype if pl.wide == "dg" else dg_dtype) == f32 else 2
        more = tgm.skinny_smem(w_bytes, n_bytes, n, pl.stages + 1)
        assert pl.stages == tgm.SKINNY_MAX_STAGES or more > tgm.SMEM_LIMIT
    widest = tgm.plan([256], 3510 * 64, 1024, f32, SMS, f32)
    assert widest.stages == 4


def test_skinny_needs_one_operand_of_whole_16_byte_rows():
    """Two stacked operands, a width that is no multiple of 8 (rows of no
    whole 16 bytes) or both sides wider than 256 go elsewhere."""
    assert tgm.product_path([120, 120], 1024, f32) == "wmma"
    assert tgm.product_path([24], 1030, bf) == "wmma"
    assert tgm.product_path([124], 80, f32) == "wmma"
    assert tgm.product_path([264], 264, f32) == "wmma"
    assert tgm.product_path([8], 8, bf) == "skinny"


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
