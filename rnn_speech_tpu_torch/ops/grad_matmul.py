"""Weight-gradient reductions of the training backward: CUDA kernel,
wrappers, plain versions.

Counterpart of ``rnn_speech_tpu/ops/grad_matmul_pallas.py``.  The
backward of an LSTM layer (and of a projection) reduces over the
flattened time-batch axis N = T·B:

    dW_h = h_prevᵀ·dgates    dW_x = xᵀ·dgates    db = Σ_N dgates

``dgates_weight_grads`` computes all three in one pass (TPU kernel
``_grad_kernel``), ``weight_grad`` the one-operand pair dW, db
(``_single_grad_kernel``; the input and output projections).  The A
operands and dg are rounded to the compute dtype for the product, which
accumulates in float32; dg keeps its caller's dtype (float32 logits'
cotangent, bf16 dgates) and db sums it UNROUNDED in float32.

Each wrapper takes the plain version for tensors on the CPU and launches
the kernel (``csrc/grad_matmul.cu``) for tensors on a CUDA device, or
raises; there is no fallback.  ``plan`` chooses, by shape alone, which of
the kernel's three tile products runs and how K is split: the Hopper tile
(``"wgmma"``: TMA loads feeding ``wgmma``, 128x256 output tiles) for bf16
dg with widths that are multiples of 64 and G of 256 (the LSTM products);
the skinny tile (``"skinny"``: one block per 128 columns of the wider of
x and dg and the narrow side whole, TMA-fed ``wgmma``, f32 operands
rounded to bf16 in the kernel, db in the same pass) for one A operand
where min(D, G) <= 256 and D, G are multiples of 8 (the input and output
projections); the WMMA tile (``"wmma"``) for every other shape.  Those
three compute in bf16.  With ``compute_dtype=float32`` (the JAX kernels'
float32 mode) nothing is rounded and no tensor core runs: one A operand
whose narrow side min(D, G) is at most 256 (the projections) runs the
float32 skinny tile (``"skinny_f32"``: a block per 128 columns of the
wider side, the narrow side whole, SIMT FMA sums, db in the same pass),
every other shape the float32 tile (``"f32"``: 128x128 output tiles).
``<wrapper>.launches`` counts the calls that launched the kernel,
``<wrapper>.wgmma_launches`` those on the Hopper tile,
``weight_grad.skinny_launches`` those on the skinny tile,
``weight_grad.skinny_f32_launches`` those on the float32 skinny tile and
``<wrapper>.f32_launches`` the float32 calls, on either float32 tile.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from rnn_speech_tpu_torch.ops import _build

Tensor = torch.Tensor
f32, bf16 = torch.float32, torch.bfloat16

#: Tile products of the kernel: their ids in the C interface (the skinny
#: tile has an entry point of its own) and their (output rows, output
#: columns, K rows per step) per block; the skinny tile's rows are columns
#: of its wide operand, its columns the narrow side.
PATH_IDS = {"wmma": 0, "wgmma": 1}
TILES = {"wmma": (128, 128, 32), "wgmma": (128, 256, 64), "skinny": (128, 256, 64),
         "f32": (128, 128, 8), "skinny_f32": (128, 256, 16)}
COLUMN_ROWS = 4096          # dg rows per db partial of the Hopper tile (kColRows in C)
_MIN_ROWS_PER_SPLIT = 1024  # K slices shorter than this cost more than they add
_MAX_SPLITS = 8             # of the Hopper tile, whose blocks fill an SM each
_FILL = 0.9                 # share of the last wave the Hopper tile's plan wants busy
SKINNY_NARROW = 256         # the widest narrow side of the skinny tile (kMaxNarrow)
SKINNY_CHAIN_ROWS = 16384   # rows of one skinny slice at most: one accumulation chain
SKINNY_MAX_STAGES = 8       # ring stages of the skinny tile (kMaxStages)
SMEM_LIMIT = 232448         # the H100's 227 KB a block may use
SKINNY_F32_STAGES = 4       # ring stages of the float32 skinny tile (kStages in C)
SKINNY_F32_BLOCKS = 2       # its blocks an SM, the narrow side up to 128 (launch bounds)


@dataclass(frozen=True)
class Plan:
    """How one product runs: the tile (``path``) and the K partition,
    ``splits`` slices of ``rows_per_split`` rows (a multiple of the tile's
    K step; the last slice ends at N).  The skinny tile adds which operand
    is the wide one (``wide``: "x" or "dg"), its 128-column ``chunks``, the
    ring's ``stages`` and the block's ``smem`` bytes."""
    path: str
    splits: int
    rows_per_split: int
    wide: str = ""
    chunks: int = 0
    stages: int = 0
    smem: int = 0


def product_path(dims: Sequence[int], G: int, dg_dtype, compute_dtype=bf16) -> str:
    """The tile product for A operands of widths ``dims`` and a dg of G
    columns in ``dg_dtype``: in float32 compute ``"skinny_f32"`` (the
    float32 skinny tile) for one operand of D columns where min(D, G) <= 256,
    else ``"f32"`` (the float32 tile); in bf16 compute ``"wgmma"`` (the
    Hopper tile) for bf16 dg, every width a positive multiple of 64 and G of
    256; ``"skinny"`` for one operand of D columns where D and G are
    positive multiples of 8 and min(D, G) <= 256; else ``"wmma"``."""
    if compute_dtype == f32:
        if len(dims) == 1 and dims[0] > 0 and G > 0 and min(dims[0], G) <= SKINNY_NARROW:
            return "skinny_f32"
        return "f32"
    if (dg_dtype == bf16 and G > 0 and G % 256 == 0
            and all(d > 0 and d % 64 == 0 for d in dims)):
        return "wgmma"
    if (len(dims) == 1 and dims[0] > 0 and G > 0 and dims[0] % 8 == 0 and G % 8 == 0
            and min(dims[0], G) <= SKINNY_NARROW):
        return "skinny"
    return "wmma"


def skinny_narrow_strips(n: int) -> int:
    """64-column bf16 strips of the skinny tile's narrow side: its wgmma N
    (64, 128 or 256) over 64."""
    return 1 if n <= 64 else 2 if n <= 128 else 4


def skinny_stage_rows(n: int) -> int:
    """K rows of a skinny stage: 64, or 32 for a narrow side past 128
    columns (``skinny::stage_rows``)."""
    return 64 if n <= 128 else 32


def skinny_smem(w_bytes: int, n_bytes: int, n: int, stages: int) -> int:
    """Shared memory of the skinny tile (``skinny::smem_bytes`` in C): 1024
    bytes of alignment slack, the bf16 strips converted from f32 operands
    (two wide, ``skinny_narrow_strips(n)`` narrow, 64 columns of a stage's
    rows each), the ring's stages (128 wide columns of ``w_bytes``; n
    narrow columns of f32, or the narrow strips of bf16) and their
    mbarriers."""
    rows = skinny_stage_rows(n)
    strip = 128 * rows
    narrow = rows * n * 4 if n_bytes == 4 else skinny_narrow_strips(n) * strip
    stage = rows * 128 * w_bytes + narrow
    return 1024 + (2 + skinny_narrow_strips(n)) * strip + stages * (stage + 8)


def _skinny_plan(D: int, N: int, G: int, dg_dtype, a_dtype, sms: int) -> Plan:
    """The wider of x (D) and dg (G) is the wide operand (dg on a tie).  The
    K slices: enough that the blocks (chunks x slices) fill ``sms``, at
    least 1024 rows each, and none longer than SKINNY_CHAIN_ROWS.  The
    ring: as many 64-row stages (at most 8) as fit the shared memory."""
    bk = TILES["skinny"][2]
    wide = "dg" if G >= D else "x"
    w, n = (G, D) if wide == "dg" else (D, G)
    size = lambda dt: 4 if dt == f32 else 2
    w_bytes, n_bytes = (size(dg_dtype), size(a_dtype)) if wide == "dg" else (
        size(a_dtype), size(dg_dtype))
    chunks = -(-w // TILES["skinny"][0])
    steps = -(-N // bk)
    least = max(1, -(-steps // (SKINNY_CHAIN_ROWS // bk)))
    splits = max(least, min(max(1, sms // chunks), max(1, N // _MIN_ROWS_PER_SPLIT)))
    per = max(1, -(-steps // splits))
    stages = SKINNY_MAX_STAGES
    while stages > 2 and skinny_smem(w_bytes, n_bytes, n, stages) > SMEM_LIMIT:
        stages -= 1
    return Plan("skinny", max(1, -(-steps // per)), per * bk, wide, chunks, stages,
                skinny_smem(w_bytes, n_bytes, n, stages))


def skinny_f32_narrow(n: int) -> int:
    """Narrow columns a thread of the float32 skinny tile sums (its NJ:
    n/16 rounded up to an instance, ``skinny_f32::narrow_per_thread``)."""
    return next(nj for lim, nj in ((32, 2), (64, 4), (80, 5), (96, 6), (128, 8), (192, 12),
                                   (256, 16)) if n <= lim)


def skinny_f32_smem(n: int) -> int:
    """Shared memory of the float32 skinny tile (``skinny_f32::smem_bytes``):
    the ring's stages of 16 rows, 128 wide columns and 16·NJ narrow ones,
    each row padded by four floats."""
    return SKINNY_F32_STAGES * TILES["skinny_f32"][2] * (132 + 16 * skinny_f32_narrow(n) + 4) * 4


def _skinny_f32_plan(D: int, N: int, G: int, sms: int) -> Plan:
    """The float32 skinny tile: the wider of x and dg is the wide operand
    (dg on a tie), in 128-column chunks; K in slices of whole 16-row stages,
    enough that the blocks (chunks x slices) fill ``sms`` at
    SKINNY_F32_BLOCKS blocks an SM (one past a narrow side of 128, whose
    threads hold more sums), at least 1024 rows each."""
    bk = TILES["skinny_f32"][2]
    wide = "dg" if G >= D else "x"
    w, n = (G, D) if wide == "dg" else (D, G)
    chunks = -(-w // TILES["skinny_f32"][0])
    per_sm = SKINNY_F32_BLOCKS if skinny_f32_narrow(n) <= 8 else 1
    splits = max(1, min(max(1, per_sm * sms // chunks), max(1, N // _MIN_ROWS_PER_SPLIT)))
    steps = -(-N // bk)
    per = max(1, -(-steps // splits))
    return Plan("skinny_f32", max(1, -(-steps // per)), per * bk, wide, chunks,
                SKINNY_F32_STAGES, skinny_f32_smem(n))


def plan(dims: Sequence[int], N: int, G: int, dg_dtype, sms: int, a_dtype=bf16,
         compute_dtype=bf16) -> Plan:
    """The product's path and K partition on a card of ``sms`` SMs, from
    the shapes and the compute dtype alone (and, for the skinny tile, the
    operands' dtypes: ``a_dtype`` float32 or bf16), so every call at one
    shape runs the same sums.  The WMMA tile splits K until there are four
    blocks per SM, the float32 tile until there are two; the Hopper tile,
    one block per SM, takes the fewest splits (at most 8) that keep 90% of
    its last wave busy, or the busiest; the skinny tile as ``_skinny_plan``
    says.  A slice keeps at least 1024 rows."""
    path = product_path(dims, G, dg_dtype, compute_dtype)
    if path == "skinny":
        return _skinny_plan(dims[0], N, G, dg_dtype, a_dtype, sms)
    if path == "skinny_f32":
        return _skinny_f32_plan(dims[0], N, G, sms)
    bm, bn, bk = TILES[path]
    tiles = sum(-(-d // bm) for d in dims) * -(-G // bn)
    steps = -(-N // bk)
    most = max(1, N // _MIN_ROWS_PER_SPLIT)
    if path in ("wmma", "f32"):
        splits = min(-(-(4 if path == "wmma" else 2) * sms // tiles), most)
    else:
        def fill(s):
            return tiles * s / (-(-tiles * s // sms) * sms)
        options = range(1, min(_MAX_SPLITS, most) + 1)
        splits = next((s for s in options if fill(s) >= _FILL), None) or max(options, key=fill)
    per = max(1, -(-steps // splits))
    return Plan(path, max(1, -(-steps // per)), per * bk)


def _buffers(pl: Plan, rows: int, N: int, G: int,
             device) -> Tuple[Tensor, Tensor, Optional[Tensor], Optional[Tensor]]:
    """(dw (rows, G), db (G,), partial, partial_db) float32.  partial
    (splits, rows, G) only when K is split.  partial_db: on the WMMA,
    skinny and float32 tiles (splits, G) when K is split; on the Hopper tile, whose db
    is a separate fixed-order column-sum pass, (ceil(N / COLUMN_ROWS), G)
    whatever the split."""
    dw = torch.zeros((rows, G), dtype=f32, device=device)
    db = torch.zeros((G,), dtype=f32, device=device)
    partial = partial_db = None
    if pl.splits > 1:
        partial = torch.empty((pl.splits, rows, G), dtype=f32, device=device)
    if pl.path == "wgmma" and N:
        partial_db = torch.empty((-(-N // COLUMN_ROWS), G), dtype=f32, device=device)
    elif pl.splits > 1:
        partial_db = torch.empty((pl.splits, G), dtype=f32, device=device)
    return dw, db, partial, partial_db


def _rows(t: Tensor) -> Tensor:
    return t.reshape(-1, t.shape[-1])


def _product(a: Tensor, dg: Tensor, cd) -> Tensor:
    """aᵀ·dg with both operands rounded to ``cd``, float32 sums."""
    return torch.matmul(a.to(cd).to(f32).t(), dg.to(cd).to(f32))


def weight_grad_plain(x: Tensor, dg: Tensor,
                      compute_dtype=bf16) -> Tuple[Tensor, Tensor]:
    """(dw (D, G), db (G,)) in plain PyTorch: einsum + float32 sum."""
    x2, dg2 = _rows(x), _rows(dg)
    return _product(x2, dg2, compute_dtype), dg2.to(f32).sum(0)


def dgates_weight_grads_plain(h_prev: Tensor, x: Tensor, dgates: Tensor,
                              compute_dtype=bf16) -> Tuple[Tensor, Tensor, Tensor]:
    """(dw_h (H, G), dw_x (D, G), db (G,)) in plain PyTorch."""
    dg2 = _rows(dgates)
    return (_product(_rows(h_prev), dg2, compute_dtype),
            _product(_rows(x), dg2, compute_dtype), dg2.to(f32).sum(0))


def _lib_fn(name: str, argtypes: List[type]):
    fn = getattr(_build.load("grad_matmul"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(operands: List[Tensor], dg: Tensor, compute_dtype,
            skip_split: int = -1) -> Tuple[Tensor, Tensor, str]:
    """Run the kernel on the (N, d) operands and the (N, G) dg; returns
    (dw (Σd, G) with the operands' rows stacked, db (G,), the path that
    ran).  In bf16 compute the skinny tile takes a float32 or bf16 operand
    as it is and rounds it in the kernel, the other tiles take it rounded to
    bf16 here; in float32 compute the float32 tiles take every operand and
    dg in float32 (a bf16 one widened exactly).  ``skip_split`` >= 0 plants
    a fault on either skinny tile for checks: that K slice is left out."""
    if compute_dtype not in (bf16, f32):
        raise TypeError(f"the weight-gradient kernel computes in bf16 or float32, got "
                        f"{compute_dtype}")
    dev = dg.device
    if dg.dtype not in (f32, bf16):
        raise TypeError(f"dg must be float32 or bfloat16, got {dg.dtype}")
    N, G = dg.shape
    path = product_path([a.shape[1] for a in operands], G, dg.dtype, compute_dtype)
    if path in ("f32", "skinny_f32"):
        ops = [a.to(f32).contiguous() for a in operands]
        dg = dg.to(f32)
    else:
        ops = [(a if path == "skinny" and a.dtype in (f32, bf16) else a.to(bf16)).contiguous()
               for a in operands]
    dg = dg.contiguous()
    for name, t in [("dg", dg)] + [(f"operand {i}", a) for i, a in enumerate(ops)]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.shape[0] != N:
            raise ValueError(f"{name} has {t.shape[0]} rows, dg has {N}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if N >= 2**31:
        raise ValueError(f"N = {N} rows exceed the kernel's int32 indexing")
    dims = [a.shape[1] for a in ops]
    with torch.cuda.device(dev):
        pl = plan(dims, N, G, dg.dtype,
                  torch.cuda.get_device_properties(dev).multi_processor_count, ops[0].dtype,
                  compute_dtype)
        dw, db, partial, partial_db = _buffers(pl, sum(dims), N, G, dev)
        if N == 0:
            return dw, db, pl.path
        ptr = lambda t: None if t is None else t.data_ptr()
        stream = _build.launch_stream(dev)
        tail = [int(dg.dtype == f32), N, G, pl.splits, pl.rows_per_split, ptr(partial),
                ptr(partial_db), dw.data_ptr(), db.data_ptr(), stream]
        P, I = ctypes.c_void_p, ctypes.c_int
        if pl.path == "f32":
            fn = _lib_fn("rst_weight_grads_f32", [P, I, P, I, P, I, I, I, I, P, P, P, P, P])
            second = ops[1] if len(ops) == 2 else None
            rc = fn(ops[0].data_ptr(), dims[0], ptr(second), dims[1] if second is not None else 0,
                    dg.data_ptr(), N, G, pl.splits, pl.rows_per_split, ptr(partial),
                    ptr(partial_db), dw.data_ptr(), db.data_ptr(), stream)
        elif pl.path == "skinny_f32":
            fn = _lib_fn("rst_weight_grad_skinny_f32", [P, I, P, I, I, I, I, I, P, P, P, P, I, P])
            rc = fn(ops[0].data_ptr(), dims[0], dg.data_ptr(), N, G, int(pl.wide == "dg"),
                    pl.splits, pl.rows_per_split, ptr(partial), ptr(partial_db),
                    dw.data_ptr(), db.data_ptr(), skip_split, stream)
        elif pl.path == "skinny":
            fn = _lib_fn("rst_weight_grad_skinny", [P, I, I, P, I, I, I, I, I, I, I, P, P, P, P,
                                                    I, P])
            rc = fn(ops[0].data_ptr(), int(ops[0].dtype == f32), dims[0], dg.data_ptr(),
                    int(dg.dtype == f32), N, G, int(pl.wide == "dg"), pl.splits,
                    pl.rows_per_split, pl.stages, ptr(partial), ptr(partial_db),
                    dw.data_ptr(), db.data_ptr(), skip_split, stream)
        elif len(ops) == 2:
            fn = _lib_fn("rst_dgates_weight_grads",
                         [I, P, I, P, I, P, I, I, I, I, I, P, P, P, P, P])
            rc = fn(PATH_IDS[pl.path], ops[0].data_ptr(), dims[0], ops[1].data_ptr(),
                    dims[1], dg.data_ptr(), *tail)
        else:
            fn = _lib_fn("rst_weight_grad", [I, P, I, P, I, I, I, I, I, P, P, P, P, P])
            rc = fn(PATH_IDS[pl.path], ops[0].data_ptr(), dims[0], dg.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"grad_matmul kernel launch ({pl.path} tile) failed: CUDA error {rc}")
    return dw, db, pl.path


def weight_grad(x: Tensor, dg: Tensor, *,
                compute_dtype=bf16) -> Tuple[Tensor, Tensor]:
    """(dw (D, G) f32, db (G,) f32) = xᵀ·dg, Σ dg over all leading axes;
    the kernel on a CUDA device (bf16 or float32 compute), the plain
    version on the CPU."""
    if not x.is_cuda:
        return weight_grad_plain(x, dg, compute_dtype)
    dw, db, path = _launch([_rows(x)], _rows(dg), compute_dtype)
    weight_grad.launches += 1
    weight_grad.wgmma_launches += path == "wgmma"
    weight_grad.skinny_launches += path == "skinny"
    weight_grad.skinny_f32_launches += path == "skinny_f32"
    if path in ("f32", "skinny_f32"):
        weight_grad.f32_launches += 1
    return dw, db


weight_grad.launches = 0
weight_grad.wgmma_launches = 0
weight_grad.skinny_launches = 0
weight_grad.skinny_f32_launches = 0
weight_grad.f32_launches = 0


def dgates_weight_grads(h_prev: Tensor, x: Tensor, dgates: Tensor, *,
                        compute_dtype=bf16) -> Tuple[Tensor, Tensor, Tensor]:
    """(dw_h (H, G), dw_x (D, G), db (G,)), all f32, in one pass over the
    three (T, B, ·) or (N, ·) streams; the kernel on a CUDA device, the
    plain version on the CPU."""
    if not dgates.is_cuda:
        return dgates_weight_grads_plain(h_prev, x, dgates, compute_dtype)
    H = h_prev.shape[-1]
    dw, db, path = _launch([_rows(h_prev), _rows(x)], _rows(dgates), compute_dtype)
    dgates_weight_grads.launches += 1
    dgates_weight_grads.wgmma_launches += path == "wgmma"
    if path == "f32":
        dgates_weight_grads.f32_launches += 1
    return dw[:H], dw[H:], db


dgates_weight_grads.launches = 0
dgates_weight_grads.wgmma_launches = 0
dgates_weight_grads.f32_launches = 0
