"""One LSTM layer's inference recurrence: CUDA kernel, wrapper, plain version.

Counterpart of ``lstm_recurrence_pallas`` (``_recurrence_kernel``) in
``rnn_speech_tpu/ops/lstm_pallas.py``.  Given the input pre-activations
of every step, ``x_proj = x·W_x + b`` (T, B, 4H) float32, it walks the
T steps with the recurrent weights W_h (H, 4H):

    gates = x_proj[t] + bf16(h)·W_h          (f32 accumulation)
    i, g, f, o = split(gates)                (gate order i, g, f, o)
    c' = sigmoid(f + 1)·c + sigmoid(i)·tanh(g);  h' = sigmoid(o)·tanh(c')
    c, h = m·(c', h') + (1 - m)·(c, h);  out[t] = m·h'

with ``m`` the {0, 1} validity mask (T, 1, B) of the JAX layout.

``lstm_recurrence`` takes the plain version for tensors on the CPU and
launches a kernel for tensors on a CUDA device, or raises; there is no
fallback.  ``lean_plan(B, H, sms, x_f32=True)`` picks the kernel by shape:
the persistent forward (``csrc/lstm_layer_lean.cu``, one cooperative
launch a call: W_h resident in shared memory in ``lean_column_order``, h
read by TMA, wgmma, one barrier a step, x_proj staged by TMA in float32)
or the per-step kernel (``csrc/lstm_recurrence.cu``, T launches from one
host call).  The recompute-mode training forward
(``ops/lstm_layer_train.py``) runs the same persistent kernel on bf16
x_proj; its plan and weight layout live here, beside this module's
``check_kernel_inputs``.  ``lstm_recurrence.launches`` counts the calls
that launched a kernel, ``lstm_recurrence.persistent_launches`` those of
the persistent kernel (read from its library's own count at the launch
site).

Any H runs on the card: the wrappers of the LSTM kernels zero-pad H (and
the input width D) to a multiple of 64 gate block by gate block, run the
kernel on the padded shapes and slice the results back (``HiddenPad``;
exact, see there).  Both compute modes of the JAX kernel run on the card,
chosen by W_h's dtype (``kernel_dtype``): bf16 (h rounded to bf16 for the
product) and
float32 (float32 W_h and h, no rounding: the JAX kernel's default
``compute_dtype=float32``).  The persistent kernel is bf16 only
(``lean_plan``'s ``dtype``), so float32 runs the per-step kernel's
float32 instance (``rst_lstm_recurrence_f32``); ``lstm_recurrence.
f32_launches`` counts those calls.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rnn_speech_tpu_torch.ops import _build

Tensor = torch.Tensor
f32, bf16 = torch.float32, torch.bfloat16


def kernel_dtype(w_dtype, res_dtype=None):
    """The LSTM kernels' compute mode for weights of ``w_dtype`` and, where
    the kernel stores residuals, residuals of ``res_dtype`` (default: the
    same): the pair (compute, residual), each bf16 or float32, the JAX
    kernels' compute and residual dtypes.  The mixed pairs (bf16 compute
    with float32 residuals, or the reverse) run on the per-step and
    per-diagonal kernels' mixed instances; any other dtype raises
    ``TypeError``."""
    res_dtype = w_dtype if res_dtype is None else res_dtype
    for dtype in (w_dtype, res_dtype):
        if dtype not in (bf16, f32):
            raise TypeError(f"the LSTM kernels compute and store in bfloat16 or float32, "
                            f"got {dtype}")
    return w_dtype, res_dtype


def entry_suffix(mode, res=None) -> str:
    """The C entries' suffix of a (compute, residual) mode: none for bf16,
    ``_f32`` for float32, ``_bf16_f32`` and ``_f32_bf16`` for the mixed
    pairs."""
    res = mode if res is None else res
    if res == mode:
        return "_f32" if mode == f32 else ""
    return "_bf16_f32" if mode == bf16 else "_f32_bf16"


#: The width the LSTM kernels' K chunks and unit tiles take H and D in.
PAD_TO = 64


#: How each LSTM wrapper's positional arguments and results are padded
#: (``HiddenPad`` kinds; the wavefront wrappers' trailing drop arguments
#: as they are, drop mode 1's masks padded along H).
PAD_KINDS = {
    "lstm_recurrence": (("g", "wh", None, "h", "h"), ("h", "h", "h")),
    "lstm_stack_wavefront": (("g", "wh", "wh", "g", None, "h", "h"), ("h", "h", "h")),
    "recurrence_train": (("g", "wh", None, "h", "h"), ("h", "h", "h", "g", "h")),
    "recurrence_train_lean": (("g", "wh", None, "h", "h"), ("h", "h", "h", "h")),
    "recurrence_bwd": (("h", "g", "h", "h", None, "wh", "h", "h"), ("g", "h", "h")),
    "recurrence_bwd_recompute": (("h", "d", "h", "h", "h", None, "wd", "g", "wh", "h", "h"),
                                 ("g", "h", "h")),
    "rebuild_gates": (("d", "h", "wd", "wh", "g"), ("g",)),
    "wavefront_train": (("d", "wd", "wh", "wh", "g", None, "h", "h"), ("h", "g", "h", "h", "h")),
    "wavefront_bwd": (("h", "wh", "wh", None, "g", "h", "h", "h", "h", "h"),
                      ("g", "h", "h", "h")),
}


class HiddenPad:
    """Zero padding of an LSTM's widths to the kernels' multiple of
    ``PAD_TO``: H to Hp gate block by gate block (each of the four H-wide
    gate blocks of a 4H axis grows to Hp), and the input width D to Dp.

    A padded unit has pre-activation 0 (zero weights, bias and x_proj
    columns), so i = f = o = 1/2 and g = 0 from c = h = 0: its c and h
    stay 0, and in the backward its dout, carries and dgates are 0.  Real
    units keep their index j, so the dropout bits drawn at (j/4, b, t, l)
    do not move.  The padding is exact: the kernels run on the padded
    shapes, and ``unpad`` slices their results back.

    Kinds of axes (``pad``/``unpad``): "h" the last axis H, "d" the last
    axis D, "g" the last axis 4H, "wh" a (.., H, 4H) weight, "wd" a
    (.., D, 4H) weight; None leaves a tensor as it is."""

    def __init__(self, H: int, D: int = None):
        D = H if D is None else D
        self.H, self.D = H, D
        self.Hp, self.Dp = -(-H // PAD_TO) * PAD_TO, -(-D // PAD_TO) * PAD_TO
        self.needed = (self.Hp, self.Dp) != (H, D)

    def _gates(self, t, n, n_p):
        if n_p == n:
            return t
        v = torch.nn.functional.pad(t.reshape(*t.shape[:-1], 4, n), (0, n_p - n))
        return v.reshape(*t.shape[:-1], 4 * n_p)

    def pad(self, t, kind):
        """``t`` zero-padded along the axes of ``kind``, contiguous."""
        if kind is None or t is None:
            return t
        H, Hp, D, Dp = self.H, self.Hp, self.D, self.Dp
        if kind == "h":
            t = torch.nn.functional.pad(t, (0, Hp - H))
        elif kind == "d":
            t = torch.nn.functional.pad(t, (0, Dp - D))
        elif kind == "g":
            t = self._gates(t, H, Hp)
        elif kind in ("wh", "wd"):
            k, kp = (H, Hp) if kind == "wh" else (D, Dp)
            t = torch.nn.functional.pad(self._gates(t, H, Hp), (0, 0, 0, kp - k))
        else:
            raise ValueError(f"unknown pad kind {kind!r}")
        return t.contiguous()

    def unpad(self, t, kind):
        """``t`` with the axes of ``kind`` sliced back to H and D."""
        if kind is None or t is None:
            return t
        H, D = self.H, self.D
        if kind == "h":
            return t[..., :H]
        if kind == "d":
            return t[..., :D]
        if kind == "g":
            return t.reshape(*t.shape[:-1], 4, self.Hp)[..., :H].reshape(*t.shape[:-1], 4 * H)
        if kind in ("wh", "wd"):
            return self.unpad(t, "g")[..., :H if kind == "wh" else D, :]
        raise ValueError(f"unknown pad kind {kind!r}")

    def call(self, fn, args, kinds, out_kinds, **kw):
        """``fn`` on the padded ``args`` (``kinds`` one a positional
        argument; arguments past them as they are), its results sliced back
        by ``out_kinds``; the results are contiguous copies."""
        kinds = tuple(kinds) + (None,) * (len(args) - len(kinds))
        res = fn(*[self.pad(a, k) for a, k in zip(args, kinds)], **kw)
        return tuple(None if r is None else self.unpad(r, k).contiguous()
                     for r, k in zip(res, out_kinds))


def lstm_recurrence_plain(x_proj: Tensor, w_h: Tensor, mask: Tensor,
                          h0: Tensor, c0: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The recurrence in plain PyTorch, with the kernel's casts: h is
    rounded to W_h's dtype before the product, which runs in float32 on
    the rounded values (exact products, f32 sums).
    Returns (out (T, B, H), hn (B, H), cn (B, H)), all float32."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    w = w_h.to(torch.float32)
    h = h0.to(torch.float32)
    c = c0.to(torch.float32)
    outs = []
    for t in range(T):
        gates = x_proj[t] + torch.matmul(h.to(w_h.dtype).to(torch.float32), w)
        i, g, f, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t, 0][:, None]
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        outs.append(m * h_new)
    out = torch.stack(outs) if outs else x_proj.new_zeros((0, B, H))
    return out, h, c


def _lib_fn(dtype=bf16):
    lib = _build.load("lstm_recurrence")
    fn = lib.rst_lstm_recurrence if dtype == bf16 else lib.rst_lstm_recurrence_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# The persistent forward (csrc/lstm_layer_lean.cu): hidden units a CTA
# owns, 64-row tiles a CTA computes at most, the ring's stages, the bytes of
# one 64x64 bf16 TMA box and of one step's f32 x_proj of a tile (four boxes
# of 64 rows x 16 units), a block's shared memory on the H100, and the H100
# SXM's SM count (the plans' default card).
LEAN_UNITS, LEAN_MAX_TILES, LEAN_MAX_STAGES = 16, 4, 8
_BOX = 64 * 64 * 2
_X_TILE = 4 * 64 * LEAN_UNITS * 4
SMEM_LIMIT = 232448
H100_SMS = 132


def lean_smem(H: int, tiles: int, stages: int, x_f32: bool = False) -> int:
    """Dynamic shared memory of the persistent forward: the resident W_h
    slice (H/64 boxes of 64 columns), the h ring, with f32 x_proj its two
    step buffers, the mbarriers and the 1024-byte alignment slack (the
    kernel's ``smem_bytes``)."""
    x_bytes = 2 * tiles * _X_TILE if x_f32 else 0
    bars = 1 + 2 * stages + (4 if x_f32 else 0)
    return (H // 64) * _BOX + stages * tiles * _BOX + x_bytes + 8 * bars + 1024


def lean_plan(B: int, H: int, sms: int = H100_SMS, x_f32: bool = False,
              dtype=bf16, res_dtype=None) -> dict:
    """Which kernel runs the persistent forward's recurrence at (B, H) on a
    card of ``sms`` SMs, decided by shape and compute dtype alone: the
    recompute-mode training forward (bf16 x_proj) or, with ``x_f32``, the
    inference recurrence (f32 x_proj, staged through shared memory by TMA).
    The persistent kernel computes and stores in bf16: a float32 ``dtype``
    or a ``res_dtype`` other than bf16 (a mixed mode) always answers the
    per-step kernel.

    The persistent kernel needs its whole grid co-resident, one CTA an SM:
    ``slices`` = H/16 unit slices times ``groups`` row groups of at most
    ``tiles`` <= 4 64-row tiles.  Row groups are as many as the card holds
    (fewer rows a CTA: less h to read every step), at least enough for the
    batch.  ``stages`` is the deepest h ring (<= LEAN_MAX_STAGES) that fits
    beside the resident W_h slice: the h stream's latency sets the step.
    Shapes it cannot take (H not a multiple of 64, a grid larger than the
    card, no two stages beside the W_h slice and the x_proj buffers) go to
    the per-step kernel.
    Returns {"kernel": "persistent", "groups", "tiles", "slices", "grid",
    "stages", "rows" (the padded h rows), "smem"} or {"kernel": "per_step"}."""
    per_step = {"kernel": "per_step"}
    if dtype != bf16 or res_dtype not in (None, bf16) or B < 1 or H < 64 or H % 64:
        return per_step
    slices = H // LEAN_UNITS
    m_tiles = -(-B // 64)
    groups = max(-(-m_tiles // LEAN_MAX_TILES), min(m_tiles, sms // slices))
    tiles = -(-m_tiles // groups)
    stages = next((s for s in range(LEAN_MAX_STAGES, 1, -1)
                   if lean_smem(H, tiles, s, x_f32) <= SMEM_LIMIT), 0)
    if groups * slices > sms or not stages:
        return per_step
    return {"kernel": "persistent", "groups": groups, "tiles": tiles, "slices": slices,
            "grid": groups * slices, "stages": stages, "rows": groups * tiles * 64,
            "smem": lean_smem(H, tiles, stages, x_f32)}


def lean_column_order(H: int) -> Tensor:
    """(4H,) int64: the persistent kernel's order of the 4H gate columns.
    Slot 64u + 16g + v holds column g·H + 16u + v (gate g of unit 16u + v),
    so CTA u's 64 columns, [i(16) | g(16) | f(16) | o(16)] of its units, are
    one contiguous slice."""
    slot = torch.arange(4 * H)
    u, g, v = slot // (4 * LEAN_UNITS), slot // LEAN_UNITS % 4, slot % LEAN_UNITS
    return g * H + u * LEAN_UNITS + v


def lean_weights(w_h: Tensor) -> Tensor:
    """W_h (H, 4H) as the persistent kernel reads it: its columns in
    ``lean_column_order`` as the rows of a (4H, H) array (K contiguous)."""
    H = w_h.shape[0]
    return w_h.t()[lean_column_order(H).to(w_h.device)].contiguous()


def check_kernel_inputs(named, device, H: int) -> None:
    """Raise unless every (name, tensor, dtype, shape) lies on ``device``,
    has that dtype and shape, is contiguous and 32-byte aligned (the WMMA
    tile loads), and H is a multiple of 64 (the staged K chunk: the
    wrappers pad other widths first, ``HiddenPad``)."""
    if H % PAD_TO:
        raise ValueError(f"the LSTM kernels need H % 64 == 0, got H={H}")
    for name, t, dtype, shape in named:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")


def _persistent_launch(x_proj, w_h, mask, h0, c0, plan, skip_barrier=0):
    """The persistent forward on f32 x_proj on the plan's grid;
    ``skip_barrier`` plants a fault (each CTA reads h without waiting for
    the others), for checks."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    dev = x_proj.device
    with torch.cuda.device(dev):
        hb = torch.zeros((2, plan["rows"], H), dtype=torch.bfloat16, device=dev)
        hb[0, :B] = h0.to(torch.bfloat16)
        h, c = h0.clone(), c0.clone()
        out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
        if T == 0:
            return out, h, c
        w_perm = lean_weights(w_h)
        counter = torch.zeros((plan["groups"],), dtype=torch.int32, device=dev)
        fn = _build.load("lstm_layer_lean").rst_lstm_recurrence_persistent
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(x_proj.data_ptr(), w_perm.data_ptr(), mask.data_ptr(), hb.data_ptr(),
                h.data_ptr(), c.data_ptr(), out.data_ptr(), counter.data_ptr(), T, B, H,
                plan["groups"], plan["tiles"], plan["stages"], skip_barrier,
                _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"persistent lstm_recurrence kernel launch failed: CUDA error {rc} "
                           f"(plan {plan})")
    return out, h, c


def persistent_launches() -> int:
    """Launches of the persistent forward on f32 x_proj so far, as its
    library counts them at the launch site."""
    fn = _build.load("lstm_layer_lean").rst_recurrence_persistent_launches
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


def lstm_recurrence(x_proj: Tensor, w_h: Tensor, mask: Tensor,
                    h0: Tensor, c0: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(out (T, B, H), hn, cn) of one layer; on a CUDA device (bf16 or
    float32 W_h, float32 everything else) the kernel ``lean_plan(...,
    x_f32=True, dtype)`` picks by shape and dtype, the persistent one
    (``persistent_launches`` adds the library's count of its launches) or
    the per-step one (``f32_launches`` counts its float32 calls); the plain
    version on the CPU."""
    if not x_proj.is_cuda:
        return lstm_recurrence_plain(x_proj, w_h, mask, h0, c0)
    T, B, four_h = x_proj.shape
    H = four_h // 4
    pad = HiddenPad(H)
    if pad.needed:
        return pad.call(lstm_recurrence, (x_proj, w_h, mask, h0, c0),
                        *PAD_KINDS["lstm_recurrence"])
    dev = x_proj.device
    mode, _ = kernel_dtype(w_h.dtype)
    check_kernel_inputs([
        ("x_proj", x_proj, f32, (T, B, 4 * H)),
        ("w_h", w_h, mode, (H, 4 * H)),
        ("mask", mask, f32, (T, 1, B)),
        ("h0", h0, f32, (B, H)),
        ("c0", c0, f32, (B, H)),
    ], dev, H)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = lean_plan(B, H, sms, x_f32=True, dtype=mode)
    if plan["kernel"] == "persistent":
        before = persistent_launches()
        res = _persistent_launch(x_proj, w_h, mask, h0, c0, plan)
        lstm_recurrence.persistent_launches += persistent_launches() - before
        lstm_recurrence.launches += 1
        return res
    with torch.cuda.device(dev):
        Bp = -(-B // 16) * 16
        hb = torch.zeros((2, Bp, H), dtype=mode, device=dev)
        hb[0, :B] = h0.to(mode)
        h = h0.clone()
        c = c0.clone()
        out = torch.empty((T, B, H), dtype=f32, device=dev)
        if T == 0:
            return out, h, c
        stream = _build.launch_stream(dev)
        rc = _lib_fn(mode)(x_proj.data_ptr(), w_h.data_ptr(), mask.data_ptr(),
                           hb.data_ptr(), h.data_ptr(), c.data_ptr(),
                           out.data_ptr(), T, B, H, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_recurrence kernel launch failed: CUDA error {rc}")
    lstm_recurrence.launches += 1
    if mode == f32:
        lstm_recurrence.f32_launches += 1
    return out, h, c


lstm_recurrence.launches = 0
lstm_recurrence.persistent_launches = 0
lstm_recurrence.f32_launches = 0
