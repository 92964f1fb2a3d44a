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
the kernel's two tile products runs and how K is split: the Hopper tile
(``"wgmma"``: TMA loads feeding ``wgmma``, 128x256 output tiles) for bf16
dg with widths that are multiples of 64 and G of 256 (the LSTM products),
the WMMA tile (``"wmma"``) for every other shape.  ``<wrapper>.launches``
counts the calls that launched the kernel, ``<wrapper>.wgmma_launches``
those on the Hopper tile.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from rnn_speech_tpu_torch.ops import _build

Tensor = torch.Tensor
f32, bf16 = torch.float32, torch.bfloat16

#: Tile products of the kernel: their ids in the C interface and their
#: (output rows, output columns, K rows per step) per block.
PATH_IDS = {"wmma": 0, "wgmma": 1}
TILES = {"wmma": (128, 128, 32), "wgmma": (128, 256, 64)}
COLUMN_ROWS = 4096          # dg rows per db partial of the Hopper tile (kColRows in C)
_MIN_ROWS_PER_SPLIT = 1024  # K slices shorter than this cost more than they add
_MAX_SPLITS = 8             # of the Hopper tile, whose blocks fill an SM each
_FILL = 0.9                 # share of the last wave the Hopper tile's plan wants busy


@dataclass(frozen=True)
class Plan:
    """How one product runs: the tile (``path``) and the K partition,
    ``splits`` slices of ``rows_per_split`` rows (a multiple of the tile's
    K step; the last slice ends at N)."""
    path: str
    splits: int
    rows_per_split: int


def product_path(dims: Sequence[int], G: int, dg_dtype) -> str:
    """The tile product for A operands of widths ``dims`` and a dg of G
    columns in ``dg_dtype``: ``"wgmma"`` (the Hopper tile) for bf16 dg,
    every width a positive multiple of 64 and G of 256; else ``"wmma"``."""
    if (dg_dtype == bf16 and G > 0 and G % 256 == 0
            and all(d > 0 and d % 64 == 0 for d in dims)):
        return "wgmma"
    return "wmma"


def plan(dims: Sequence[int], N: int, G: int, dg_dtype, sms: int) -> Plan:
    """The product's path and K partition on a card of ``sms`` SMs, from
    the shapes alone, so every call at one shape runs the same sums.  The
    WMMA tile splits K until there are four blocks per SM; the Hopper tile,
    one block per SM, takes the fewest splits (at most 8) that keep 90% of
    its last wave busy, or the busiest.  A slice keeps at least 1024 rows."""
    path = product_path(dims, G, dg_dtype)
    bm, bn, bk = TILES[path]
    tiles = sum(-(-d // bm) for d in dims) * -(-G // bn)
    steps = -(-N // bk)
    most = max(1, N // _MIN_ROWS_PER_SPLIT)
    if path == "wmma":
        splits = min(-(-4 * sms // tiles), most)
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
    (splits, rows, G) only when K is split.  partial_db: on the WMMA tile
    (splits, G) when K is split; on the Hopper tile, whose db is a
    separate fixed-order column-sum pass, (ceil(N / COLUMN_ROWS), G)
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


def _launch(operands: List[Tensor], dg: Tensor, compute_dtype) -> Tuple[Tensor, Tensor, str]:
    """Run the kernel on the (N, d) bf16 operands and the (N, G) dg;
    returns (dw (Σd, G) with the operands' rows stacked, db (G,), the
    path that ran)."""
    if compute_dtype != bf16:
        raise TypeError(f"the weight-gradient kernel computes in bf16, got {compute_dtype}")
    dev = dg.device
    if dg.dtype not in (f32, bf16):
        raise TypeError(f"dg must be float32 or bfloat16, got {dg.dtype}")
    N, G = dg.shape
    ops = [a.to(bf16).contiguous() for a in operands]
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
                  torch.cuda.get_device_properties(dev).multi_processor_count)
        dw, db, partial, partial_db = _buffers(pl, sum(dims), N, G, dev)
        if N == 0:
            return dw, db, pl.path
        ptr = lambda t: None if t is None else t.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        tail = [int(dg.dtype == f32), N, G, pl.splits, pl.rows_per_split, ptr(partial),
                ptr(partial_db), dw.data_ptr(), db.data_ptr(), stream]
        P, I = ctypes.c_void_p, ctypes.c_int
        if len(ops) == 2:
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
    the kernel on a CUDA device (bf16 compute), the plain version on the
    CPU."""
    if not x.is_cuda:
        return weight_grad_plain(x, dg, compute_dtype)
    dw, db, path = _launch([_rows(x)], _rows(dg), compute_dtype)
    weight_grad.launches += 1
    weight_grad.wgmma_launches += path == "wgmma"
    return dw, db


weight_grad.launches = 0
weight_grad.wgmma_launches = 0


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
    return dw[:H], dw[H:], db


dgates_weight_grads.launches = 0
dgates_weight_grads.wgmma_launches = 0
