"""One LSTM layer's training recurrences: CUDA kernels, wrappers, plain
versions, and the differentiable layer.

Counterpart of the training half of ``rnn_speech_tpu/ops/lstm_pallas.py``,
which trains the stack one layer at a time wherever the wavefront does not
run (wavefront off, one layer, ``remat``, recompute residuals, and inside
``time_chunk`` chunks of such stacks).  Four kernels, in two residual
modes:

* gates mode: ``recurrence_train`` (``_recurrence_train_kernel``) walks
  the T steps from ``x_proj = x·W_x + b`` (T, B, 4H) float32 and stores
  the activated gates (i, g, f, o) = (σ(i), tanh(g), σ(f + 1), σ(o)) and
  the carried c in the residual dtype.  ``lean_plan(..., x_f32=True)``
  (the inference recurrence's plan) sends it by shape to the persistent
  forward (``csrc/lstm_layer_lean.cu``'s gates instance: W_h resident,
  x_proj staged by TMA, the gates and c stored from registers; the layered
  step's B=64) or to the per-step kernel; ``recurrence_bwd``
  (``_recurrence_bwd_kernel``) walks back and writes the pre-activation
  dgates over the gates residual.  ``bwd_plan`` sends it by shape to a
  persistent kernel (``csrc/lstm_layer_bwd_persistent.cu``: W_h resident
  in shared memory, the carry's product's K split in eighths over the
  eight CTAs of a 64-unit slice, wgmma, each CTA walking the batch's
  64-row groups in turn, one barrier a step and row group; every batch at
  H=1024) or to the per-step kernel;
* recompute mode: ``recurrence_train_lean`` (``_recurrence_train_lean_kernel``)
  reads ``x_proj`` in the residual dtype and stores only c.  ``lean_plan``
  (with the persistent forward's layout, in ``ops/lstm_recurrence.py``,
  whose inference recurrence shares the kernel) sends it by shape to a
  persistent kernel (``csrc/lstm_layer_lean.cu``: W_h resident in shared
  memory in ``lean_column_order``, wgmma, one grid-wide barrier a step;
  both path shapes) or to the per-step kernel;
  ``recurrence_bwd_recompute`` (``_recurrence_bwd_recompute_kernel``)
  rebuilds the gates from the residual-dtype layer input and h_prev, then
  runs the same backward into a fresh dgates stream.  The TPU kernel
  rebuilds them inside each step; here the rebuild is one tensor-core
  product per chunk of ``rebuild_chunk`` steps (``rebuild_gates``: float32
  activated gates, at most ``REBUILD_BYTES`` of them), launched ahead of
  the chunk's serial steps, which keep only the carry's product: on the
  persistent backward, one launch a chunk, where ``bwd_plan`` sends the
  shape (both recompute batches, B=400 and 473 at H=1024), else a launch a
  step.

The forward kernels are ``csrc/lstm_layer_train.cu`` and
``csrc/lstm_layer_lean.cu``, the backward ones
``csrc/lstm_layer_bwd_persistent.cu`` and ``csrc/lstm_layer_bwd.cu`` (the
per-step kernels, for the shapes ``bwd_plan`` does not take), both with
the rebuild product ``csrc/rebuild_gates.cuh``.
Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device (bf16 weights and residuals,
float32 carries), or raises; there is no fallback.  ``<wrapper>.launches``
counts the calls that launched a kernel (the per-step kernels issue one
CUDA launch per step from one host call); ``recurrence_bwd_recompute.
rebuild_launches`` counts the rebuild products its kernels launched,
``recurrence_train.persistent_launches`` and
``recurrence_train_lean.persistent_launches`` the persistent forward's
launches, ``recurrence_bwd.persistent_launches`` and
``recurrence_bwd_recompute.persistent_launches`` the persistent
backward's (each read from its library's own count at the launch site),
and ``recurrence_bwd_recompute.per_step_launches`` the calls that ran the
per-step recompute kernel.

``lstm_layer_train`` (``lstm_layer_pallas``) is the differentiable layer:
``_LayerTrain`` (``_lstm_core``) and ``_LayerTrainRecompute``
(``_lstm_core_recompute``), whose weight gradients go through the
weight-gradient kernel (``ops/grad_matmul.py``) and dx = dgates·W_xᵀ
through a matmul.

Every compute and residual mode of the JAX kernels runs on the card,
chosen by W_h's dtype and the residuals' (``kernel_dtype``): bf16, float32
(the JAX kernels' default compute dtype: float32 operands, h buffers,
residuals and dgates, nothing rounded) and the two mixed pairs.  Any H and
D run: each wrapper zero-pads them to a multiple of 64 and slices the
results back (``HiddenPad``).  The bf16 persistent kernels and the
tensor-core rebuild take bf16 alone.  In float32 the recompute backward
runs its own persistent kernel (``csrc/lstm_layer_bwd_f32.cu``, where
``bwd_plan`` sends the shape: every batch at H=1024), with the float32
rebuild on a float32 GEMM tile (``csrc/f32_gemm.cuh``); the other float32
calls and the mixed modes run the per-step kernels' instances of their
dtypes.  ``<wrapper>.f32_launches`` counts the float32 calls.  The float32
persistent forward (``csrc/lstm_layer_fwd_f32.cu``, ``fwd_f32_plan``) runs
one layer's training forward, its input product on the same GEMM tile
into the gates residual, then its recurrence in one launch: the float32
layer sweep of the wavefront training forward
(``lstm_wavefront._fwd_layer_sweep_launch``) calls it a layer at a time;
the layered route's float32 forwards (rows 5 and 7) do not use it yet.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rnn_speech_tpu_torch import stages
from rnn_speech_tpu_torch.ops import _build
from rnn_speech_tpu_torch.ops.grad_matmul import dgates_weight_grads
from rnn_speech_tpu_torch.ops.lstm import LayerState, dot_f32, length_mask
# The persistent forward's plan and weight layout live beside the inference
# recurrence, which shares the kernel.
from rnn_speech_tpu_torch.ops.lstm_recurrence import (
    H100_SMS, PAD_KINDS, SMEM_LIMIT, HiddenPad, check_kernel_inputs, entry_suffix, kernel_dtype,
    lean_plan, lean_weights)

Tensor = torch.Tensor
f32, bf16 = torch.float32, torch.bfloat16
P, I = ctypes.c_void_p, ctypes.c_int
# Rows of the recompute forward's input projection per chunk: 2^17 rows of
# 4H = 4096 float32 are 2 GiB of transient.
_PROJ_ROWS = 1 << 17
# Bytes of the recompute backward's chunk of rebuilt gates, (C·B, 4H)
# float32: C = 40 steps at B=400, H=1024 (262 MB, 2,000 output tiles of the
# rebuild product); under the memory plan's slack for transients.
REBUILD_BYTES = 256 << 20


def _lib_fn(lib: str, name: str, argtypes):
    fn = getattr(_build.load(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _lib_count(lib: str, name: str) -> int:
    """A launch count a kernel library keeps at its launch site."""
    fn = getattr(_build.load(lib), name)
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


def _activations(pre: Tensor, H: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    i, g, f, o = pre.split(H, dim=-1)
    return torch.sigmoid(i), torch.tanh(g), torch.sigmoid(f + 1.0), torch.sigmoid(o)


def forward_plain(x_proj: Tensor, w_h: Tensor, mask: Tensor, h0: Tensor, c0: Tensor,
                  res_dtype, keep_gates: bool, keep_h: bool = False):
    """The training forward in plain PyTorch with the kernel's casts (h
    rounded to W_h's dtype, float32 sums; x_proj upcast per step).
    Returns (out f32, hn, cn, gates or None, cseq, and with ``keep_h``
    the float32 carried-h sequence)."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    w = w_h.to(f32)
    h, c = h0.to(f32), c0.to(f32)
    out = x_proj.new_zeros((T, B, H), dtype=f32)
    gates = x_proj.new_empty((T, B, four_h), dtype=res_dtype) if keep_gates else None
    cseq = x_proj.new_empty((T, B, H), dtype=res_dtype)
    hcar = x_proj.new_empty((T, B, H), dtype=f32) if keep_h else None
    for t in range(T):
        pre = x_proj[t].to(f32) + torch.matmul(h.to(w_h.dtype).to(f32), w)
        i_a, g_a, f_a, o_a = _activations(pre, H)
        c_new = f_a * c + i_a * g_a
        h_new = o_a * torch.tanh(c_new)
        m = mask[t, 0][:, None]
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        out[t] = m * h_new
        if gates is not None:
            gates[t] = torch.cat([i_a, g_a, f_a, o_a], dim=-1)
        cseq[t] = c
        if hcar is not None:
            hcar[t] = h
    res = (out, h, c, gates, cseq)
    return res + (hcar,) if keep_h else res


def recurrence_train_plain(x_proj, w_h, mask, h0, c0, res_dtype):
    """Gates-mode forward: (out (T, B, H) f32, hn, cn, gates (T, B, 4H),
    cseq (T, B, H)), the residuals in ``res_dtype``."""
    return forward_plain(x_proj, w_h, mask, h0, c0, res_dtype, True)


def recurrence_train_lean_plain(x_proj, w_h, mask, h0, c0, res_dtype):
    """Recompute-mode forward: (out f32, hn, cn, cseq in ``res_dtype``)."""
    out, h, c, _, cseq = forward_plain(x_proj, w_h, mask, h0, c0, res_dtype, False)
    return out, h, c, cseq


def _forward_launch(lib_name, x_proj, w_h, mask, h0, c0, res_dtype, keep_gates):
    """The per-step forward (csrc/lstm_layer_train.cu) in the compute mode
    of W_h's dtype: (out, hn, cn, gates or None, cseq)."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    mode, res = kernel_dtype(w_h.dtype, res_dtype)
    dev = x_proj.device
    check_kernel_inputs([
        ("x_proj", x_proj, f32 if keep_gates else res, (T, B, 4 * H)),
        ("w_h", w_h, mode, (H, 4 * H)),
        ("mask", mask, f32, (T, 1, B)),
        ("h0", h0, f32, (B, H)),
        ("c0", c0, f32, (B, H)),
    ], dev, H)
    with torch.cuda.device(dev):
        Bp = -(-B // 16) * 16
        hb = torch.zeros((2, Bp, H), dtype=mode, device=dev)
        hb[0, :B] = h0.to(mode)
        h, c = h0.clone(), c0.clone()
        out = torch.empty((T, B, H), dtype=f32, device=dev)
        gates = torch.empty((T, B, 4 * H), dtype=res, device=dev) if keep_gates else None
        cseq = torch.empty((T, B, H), dtype=res, device=dev)
        if T == 0:
            return out, h, c, gates, cseq
        stream = _build.launch_stream(dev)
        head = [x_proj.data_ptr(), w_h.data_ptr(), mask.data_ptr(), hb.data_ptr(),
                h.data_ptr(), c.data_ptr(), out.data_ptr()]
        if keep_gates:
            fn = _lib_fn("lstm_layer_train", "rst_lstm_layer_train" + entry_suffix(mode, res),
                         [P] * 9 + [I] * 3 + [P])
            rc = fn(*head, gates.data_ptr(), cseq.data_ptr(), T, B, H, stream)
        else:
            fn = _lib_fn("lstm_layer_train",
                         "rst_lstm_layer_train_lean" + entry_suffix(mode, res),
                         [P] * 8 + [I] * 3 + [P])
            rc = fn(*head, cseq.data_ptr(), T, B, H, stream)
    if rc != 0:
        raise RuntimeError(f"{lib_name} kernel launch failed: CUDA error {rc}")
    return out, h, c, gates, cseq


def _train_persistent_launch(x_proj, w_h, mask, h0, c0, plan, skip_barrier=0, stamps=None):
    """The gates-mode forward on the persistent kernel on the plan's grid:
    (out, hn, cn, gates, cseq).  ``skip_barrier`` plants a fault (each CTA
    reads h without waiting for the others), for checks; ``stamps``, a
    (T + 1, 4) int64 tensor on the device, takes CTA 0's SM clock at four
    points of each step (the kernel's ``Args::stamps``), for studies."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    dev = x_proj.device
    with torch.cuda.device(dev):
        hb = torch.zeros((2, plan["rows"], H), dtype=bf16, device=dev)
        hb[0, :B] = h0.to(bf16)
        h, c = h0.clone(), c0.clone()
        out = torch.empty((T, B, H), dtype=f32, device=dev)
        gates = torch.empty((T, B, 4 * H), dtype=bf16, device=dev)
        cseq = torch.empty((T, B, H), dtype=bf16, device=dev)
        if T == 0:
            return out, h, c, gates, cseq
        w_perm = lean_weights(w_h)
        counter = torch.zeros((plan["groups"],), dtype=torch.int32, device=dev)
        fn = _lib_fn("lstm_layer_lean", "rst_lstm_layer_train_persistent",
                     [P] * 10 + [I] * 7 + [P, P])
        rc = fn(x_proj.data_ptr(), w_perm.data_ptr(), mask.data_ptr(), hb.data_ptr(),
                h.data_ptr(), c.data_ptr(), out.data_ptr(), gates.data_ptr(), cseq.data_ptr(),
                counter.data_ptr(), T, B, H, plan["groups"], plan["tiles"], plan["stages"],
                skip_barrier, None if stamps is None else stamps.data_ptr(),
                _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"persistent lstm_layer_train kernel launch failed: CUDA error {rc} "
                           f"(plan {plan})")
    return out, h, c, gates, cseq


def train_persistent_launches() -> int:
    """Launches of the persistent gates-mode forward so far, as its
    library counts them at the launch site."""
    return _lib_count("lstm_layer_lean", "rst_train_persistent_launches")


def recurrence_train(x_proj: Tensor, w_h: Tensor, mask: Tensor, h0: Tensor, c0: Tensor,
                     res_dtype) -> Tuple[Tensor, ...]:
    """Gates-mode training forward of one layer: x_proj (T, B, 4H) float32,
    w_h (H, 4H) in the compute dtype, mask (T, 1, B), h0, c0 (B, H) float32.
    Returns (out, hn, cn, gates, cseq) as ``recurrence_train_plain``; on a
    CUDA device the kernel ``lean_plan(B, H, sms, x_f32=True, dtype)``
    picks by shape and compute dtype, the persistent one
    (``persistent_launches`` adds the library's count of its launches) or
    the per-step one (``f32_launches`` counts its float32 calls); the plain
    version on the CPU."""
    if not x_proj.is_cuda:
        return recurrence_train_plain(x_proj, w_h, mask, h0, c0, res_dtype)
    T, B, four_h = x_proj.shape
    H = four_h // 4
    pad = HiddenPad(H)
    if pad.needed:
        return pad.call(recurrence_train, (x_proj, w_h, mask, h0, c0),
                        *PAD_KINDS["recurrence_train"], res_dtype=res_dtype)
    mode, res_mode = kernel_dtype(w_h.dtype, res_dtype)
    sms = torch.cuda.get_device_properties(x_proj.device).multi_processor_count
    plan = lean_plan(B, H, sms, x_f32=True, dtype=mode, res_dtype=res_mode)
    if plan["kernel"] == "per_step":
        res = _forward_launch("lstm_layer_train", x_proj, w_h, mask, h0, c0, res_dtype, True)
        if (mode, res_mode) == (f32, f32):
            recurrence_train.f32_launches += 1
    else:
        check_kernel_inputs([
            ("x_proj", x_proj, f32, (T, B, 4 * H)),
            ("w_h", w_h, bf16, (H, 4 * H)),
            ("mask", mask, f32, (T, 1, B)),
            ("h0", h0, f32, (B, H)),
            ("c0", c0, f32, (B, H)),
        ], x_proj.device, H)
        before = train_persistent_launches()
        res = _train_persistent_launch(x_proj, w_h, mask, h0, c0, plan)
        recurrence_train.persistent_launches += train_persistent_launches() - before
    recurrence_train.launches += 1
    return res


recurrence_train.launches = 0
recurrence_train.persistent_launches = 0
recurrence_train.f32_launches = 0


def _lean_persistent_launch(x_proj, w_h, mask, h0, c0, plan, skip_barrier=0):
    """The persistent kernel on the plan's grid; ``skip_barrier`` plants a
    fault (each CTA reads h without waiting for the others), for checks."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    dev = x_proj.device
    with torch.cuda.device(dev):
        hb = torch.zeros((2, plan["rows"], H), dtype=bf16, device=dev)
        hb[0, :B] = h0.to(bf16)
        h, c = h0.clone(), c0.clone()
        out = torch.empty((T, B, H), dtype=f32, device=dev)
        cseq = torch.empty((T, B, H), dtype=bf16, device=dev)
        if T == 0:
            return out, h, c, cseq
        w_perm = lean_weights(w_h)
        counter = torch.zeros((plan["groups"],), dtype=torch.int32, device=dev)
        fn = _lib_fn("lstm_layer_lean", "rst_lstm_layer_train_lean_persistent",
                     [P] * 9 + [I] * 7 + [P])
        rc = fn(x_proj.data_ptr(), w_perm.data_ptr(), mask.data_ptr(), hb.data_ptr(),
                h.data_ptr(), c.data_ptr(), out.data_ptr(), cseq.data_ptr(),
                counter.data_ptr(), T, B, H, plan["groups"], plan["tiles"], plan["stages"],
                skip_barrier, _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"persistent lstm_layer_train_lean kernel launch failed: "
                           f"CUDA error {rc} (plan {plan})")
    return out, h, c, cseq


def persistent_launches() -> int:
    """Launches of the persistent lean forward so far, as its library
    counts them at the launch site."""
    return _lib_count("lstm_layer_lean", "rst_lean_persistent_launches")


def recurrence_train_lean(x_proj: Tensor, w_h: Tensor, mask: Tensor, h0: Tensor,
                          c0: Tensor, res_dtype) -> Tuple[Tensor, ...]:
    """Recompute-mode training forward: as ``recurrence_train`` with x_proj
    in the residual dtype; returns (out, hn, cn, cseq).  On a CUDA device
    ``lean_plan`` picks the kernel by shape and compute dtype: the
    persistent one (``persistent_launches`` adds the library's count of its
    launches), or the per-step one (``f32_launches`` counts its float32
    calls); a failed launch raises."""
    if not x_proj.is_cuda:
        return recurrence_train_lean_plain(x_proj, w_h, mask, h0, c0, res_dtype)
    T, B, four_h = x_proj.shape
    H = four_h // 4
    pad = HiddenPad(H)
    if pad.needed:
        return pad.call(recurrence_train_lean, (x_proj, w_h, mask, h0, c0),
                        *PAD_KINDS["recurrence_train_lean"], res_dtype=res_dtype)
    mode, res_mode = kernel_dtype(w_h.dtype, res_dtype)
    sms = torch.cuda.get_device_properties(x_proj.device).multi_processor_count
    plan = lean_plan(B, H, sms, dtype=mode, res_dtype=res_mode)
    if plan["kernel"] == "per_step":
        out, h, c, _, cseq = _forward_launch("lstm_layer_train_lean", x_proj, w_h, mask, h0,
                                             c0, res_dtype, False)
        if (mode, res_mode) == (f32, f32):
            recurrence_train_lean.f32_launches += 1
    else:
        check_kernel_inputs([
            ("x_proj", x_proj, bf16, (T, B, 4 * H)),
            ("w_h", w_h, bf16, (H, 4 * H)),
            ("mask", mask, f32, (T, 1, B)),
            ("h0", h0, f32, (B, H)),
            ("c0", c0, f32, (B, H)),
        ], x_proj.device, H)
        before = persistent_launches()
        out, h, c, cseq = _lean_persistent_launch(x_proj, w_h, mask, h0, c0, plan)
        recurrence_train_lean.persistent_launches += persistent_launches() - before
    recurrence_train_lean.launches += 1
    return out, h, c, cseq


recurrence_train_lean.launches = 0
recurrence_train_lean.persistent_launches = 0
recurrence_train_lean.f32_launches = 0


def _backward_plain(dout, activations, cseq, c0, mask, w_h, dhn, dcn, dgates):
    """The reverse walk in plain PyTorch: ``activations(t)`` gives step t's
    (i, g, f, o); dgates go to ``dgates[t]`` in its dtype after the last
    read of step t, and the carry's product rounds them to W_h's dtype
    (float32 sums).  Returns (dgates, dh0, dc0)."""
    T = cseq.shape[0]
    wd = w_h.dtype
    wh_t = w_h.to(f32).t()
    dh, dc = dhn.to(f32), dcn.to(f32)
    for t in reversed(range(T)):
        i_a, g_a, f_a, o_a = activations(t)
        m = mask[t, 0][:, None]
        tanh_c = torch.tanh(cseq[t].to(f32))
        c_prev = cseq[t - 1].to(f32) if t > 0 else c0.to(f32)
        dh_new = m * (dout[t].to(f32) + dh)
        do_pre = dh_new * tanh_c * o_a * (1.0 - o_a)
        dc_new = dh_new * o_a * (1.0 - tanh_c * tanh_c) + m * dc
        di_pre = dc_new * g_a * i_a * (1.0 - i_a)
        dg_pre = dc_new * i_a * (1.0 - g_a * g_a)
        df_pre = dc_new * c_prev * f_a * (1.0 - f_a)
        dg = torch.cat([di_pre, dg_pre, df_pre, do_pre], dim=-1)
        dh = (1.0 - m) * dh + torch.matmul(dg.to(wd).to(f32), wh_t)
        dc = (1.0 - m) * dc + dc_new * f_a
        dgates[t] = dg
    return dgates, dh, dc


def recurrence_bwd_plain(dout, gates, cseq, c0, mask, w_h, dhn, dcn):
    """Gates-mode backward in plain PyTorch; overwrites ``gates`` with
    dgates, as the kernel does.  Returns (dgates, dh0, dc0)."""
    H = cseq.shape[-1]
    acts = lambda t: gates[t].to(f32).split(H, dim=-1)
    return _backward_plain(dout, acts, cseq, c0, mask, w_h, dhn, dcn, gates)


def rebuild_gates_plain(x, h_prev, w_x, w_h, b):
    """The activated gates [σ(i) | tanh(g) | σ(f + 1) | σ(o)] (rows, 4H)
    float32 of x (rows, D)·W_x + h_prev (rows, H)·W_h + b, float32 sums of
    the residual-dtype operands."""
    H = w_h.shape[1] // 4
    pre = (torch.matmul(x.to(f32), w_x.to(f32)) + torch.matmul(h_prev.to(f32), w_h.to(f32))
           + b.to(f32).reshape(-1))
    return torch.cat(_activations(pre, H), dim=-1)


def recurrence_bwd_recompute_plain(dout, x, h_prev, cseq, c0, mask, w_x, b, w_h, dhn,
                                   dcn):
    """Recompute-mode backward in plain PyTorch: step t's gates are rebuilt
    as ``rebuild_gates_plain(x[t], h_prev[t], ...)``.  Returns (dgates in
    x's dtype, dh0, dc0)."""
    T, B, H = cseq.shape
    acts = lambda t: rebuild_gates_plain(x[t], h_prev[t], w_x, w_h, b).split(H, dim=-1)
    dgates = cseq.new_empty((T, B, 4 * H), dtype=x.dtype)
    return _backward_plain(dout, acts, cseq, c0, mask, w_h, dhn, dcn, dgates)


def rebuild_chunk(T: int, B: int, H: int) -> int:
    """Steps per chunk of the recompute backward's rebuild: as many (B, 4H)
    float32 steps as ``REBUILD_BYTES`` holds, at least 1, at most T."""
    return max(1, min(T, REBUILD_BYTES // (16 * max(1, B) * H)))


def rebuild_chunks(T: int, chunk: int):
    """The chunks [t0, t1) of [0, T), ``chunk`` steps each but the last,
    in the order the kernel runs them: last first.  The wrapper passes
    their starts to the kernel, which runs them in this order."""
    return [(t0, min(T, t0 + chunk)) for t0 in reversed(range(0, T, chunk))]


def _rebuild_checks(x, h_prev, w_x, b, mode=bf16, res=None):
    """The rebuild product's operands for ``check_kernel_inputs``: x and
    h_prev in the residual dtype ``res`` (default: the compute dtype
    ``mode``), w_x in ``mode``, b float32.  D is any width: the wrappers pad
    it to a multiple of 64 (``HiddenPad``) before they check."""
    D, H = x.shape[-1], h_prev.shape[-1]
    res = mode if res is None else res
    return [("x", x, res, (*x.shape[:-1], D)), ("h_prev", h_prev, res, (*x.shape[:-1], H)),
            ("w_x", w_x, mode, (D, 4 * H)), ("b", b, f32, (4 * H,))]


def rebuild_gates(x: Tensor, h_prev: Tensor, w_x: Tensor, w_h: Tensor, b: Tensor) -> Tensor:
    """The recompute backward's rebuild product alone: (rows, 4H) float32
    activated gates as ``rebuild_gates_plain`` for x (rows, D) and h_prev
    (rows, H), w_x (D, 4H), w_h (H, 4H), all bf16 or all float32 (the
    compute mode), and b (4H,) float32; the kernel on a CUDA device, the
    plain version on the CPU."""
    if not x.is_cuda:
        return rebuild_gates_plain(x, h_prev, w_x, w_h, b)
    rows, H = h_prev.shape[0], w_h.shape[0]
    D = x.shape[-1]
    pad = HiddenPad(H, D)
    if pad.needed:
        return pad.call(lambda *a: (rebuild_gates(*a),), (x, h_prev, w_x, w_h, b),
                        *PAD_KINDS["rebuild_gates"])[0]
    dev = x.device
    mode, _ = kernel_dtype(w_h.dtype)
    check_kernel_inputs(_rebuild_checks(x, h_prev, w_x, b, mode)
                        + [("w_h", w_h, mode, (H, 4 * H))], dev, H)
    with torch.cuda.device(dev):
        act = torch.empty((rows, 4 * H), dtype=f32, device=dev)
        if rows == 0:
            return act
        fn = _lib_fn("lstm_layer_bwd", "rst_rebuild_gates" + entry_suffix(mode),
                     [P] * 6 + [I] * 3 + [P])
        rc = fn(x.data_ptr(), h_prev.data_ptr(), w_x.data_ptr(), w_h.data_ptr(), b.data_ptr(),
                act.data_ptr(), rows, D, H, _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"rebuild_gates kernel launch failed: CUDA error {rc}")
    rebuild_gates.launches += 1
    return act


rebuild_gates.launches = 0


def _bwd_checks(dout, cseq, c0, mask, w_h, dhn, dcn, extra, mode=bf16, res=None):
    T, B, H = cseq.shape
    check_kernel_inputs([
        ("dout", dout, f32, (T, B, H)),
        ("cseq", cseq, mode if res is None else res, (T, B, H)),
        ("c0", c0, f32, (B, H)),
        ("mask", mask, f32, (T, 1, B)),
        ("w_h", w_h, mode, (H, 4 * H)),
        ("dhn", dhn, f32, (B, H)),
        ("dcn", dcn, f32, (B, H)),
    ] + extra, cseq.device, H)


# The persistent backward (csrc/lstm_layer_bwd_persistent.cu, both residual
# modes): CTAs of a slice (the carry product's K split), hidden units of a
# slice, rows of a row group (one wgmma tile), consumer warpgroups a CTA
# past one row group, and the bytes of its W_h box (64 units x 64 K) and
# dgates box (64 rows x 64 K), both bf16.
BWD_SPLIT, BWD_UNITS, BWD_ROWS, BWD_WARPGROUPS = 8, 64, 64, 2
_BWD_WBOX, _BWD_ABOX = BWD_UNITS * 64 * 2, BWD_ROWS * 64 * 2


def bwd_smem(H: int, warpgroups: int = 1) -> int:
    """Dynamic shared memory of the persistent backward: the resident W_h
    slice (64 units' rows, an eighth of the 4H columns), one buffer a
    consumer warpgroup for the same eighth of a row group's dgates (64
    rows), 4H/512 boxes each, the mbarriers (W_h, and a release and a
    landing a box for each buffer) and the 1024-byte alignment slack (the
    kernel's ``smem_bytes``)."""
    boxes = 4 * H // (64 * BWD_SPLIT)
    return (boxes * (_BWD_WBOX + warpgroups * _BWD_ABOX)
            + 8 * (1 + warpgroups + warpgroups * boxes) + 1024)


def bwd_plan(B: int, H: int, sms: int = H100_SMS, dtype=bf16, res_dtype=None,
             recompute: bool = False) -> dict:
    """Which kernel runs the layer backward at (B, H) on a card of ``sms``
    SMs, in either residual mode (``recurrence_bwd`` asks with
    ``recompute`` False, ``recurrence_bwd_recompute`` with True), decided by
    shape and the compute and residual dtypes alone.

    In bf16 the persistent kernel (``csrc/lstm_layer_bwd_persistent.cu``)
    needs its whole grid co-resident, one CTA an SM: ``slices`` = H/64 unit
    slices times 8 CTAs, each an eighth of K = 4H, whatever the batch.  Each
    CTA holds its eighth of the slice's W_h columns and walks the
    ``groups`` = ceil(B/64) row groups of every step in turn, streaming the
    same eighth of the group's dgates: one consumer warpgroup for one group,
    two (each with its own A buffer) past it (``bwd_smem``).  Shapes it
    cannot take (H not a multiple of 128, a grid larger than the card, a
    W_h slice and A buffers that do not fit the shared memory) go to the
    per-step kernel.  Returns {"kernel": "persistent", "groups",
    "warpgroups", "slices", "grid", "rows" (the row groups' rows), "smem"}
    or {"kernel": "per_step"}.

    In float32 the recompute backward runs the float32 persistent kernel
    (``csrc/lstm_layer_bwd_f32.cu``) where ``bwd_f32_plan`` takes the shape
    ({"kernel": "persistent_f32", ...}); the gates mode (row 6) stays on the
    per-step kernel in float32.  Mixed compute and residual dtypes run the
    per-step kernel."""
    per_step = {"kernel": "per_step"}
    if res_dtype not in (None, dtype):
        return per_step
    if dtype == f32:
        return bwd_f32_plan(B, H, sms) if recompute else per_step
    if dtype != bf16 or B < 1 or H < 128 or H % 128:
        return per_step
    groups, slices = -(-B // BWD_ROWS), H // BWD_UNITS
    warpgroups = 1 if groups == 1 else BWD_WARPGROUPS
    grid = slices * BWD_SPLIT
    if grid > sms or bwd_smem(H, warpgroups) > SMEM_LIMIT:
        return per_step
    return {"kernel": "persistent", "groups": groups, "warpgroups": warpgroups,
            "slices": slices, "grid": grid, "rows": groups * BWD_ROWS,
            "smem": bwd_smem(H, warpgroups)}


# The float32 persistent backward (csrc/lstm_layer_bwd_f32.cu): the bf16
# kernel's grid (BWD_SPLIT CTAs of a BWD_UNITS-unit slice, BWD_ROWS-row
# groups), a ring of BWD_F32_STAGES boxes of 64 rows x 64 K float32, and the
# W_h slice resident in float32, its rows padded by four floats.
BWD_F32_STAGES, BWD_F32_KBOX = 4, 64


def bwd_f32_smem(H: int) -> int:
    """Dynamic shared memory of the float32 persistent backward: the W_h
    slice (64 units x H/2 K, rows padded by 4 floats), the box ring and the
    second K half's (64, 64) sums (the kernel's ``smem_bytes``)."""
    share = 4 * H // BWD_SPLIT
    return 4 * (BWD_UNITS * (share + 4) + BWD_F32_STAGES * BWD_ROWS * (BWD_F32_KBOX + 4)
                + BWD_ROWS * BWD_UNITS)


def bwd_f32_plan(B: int, H: int, sms: int = H100_SMS) -> dict:
    """The float32 persistent backward's grid at (B, H) on a card of
    ``sms`` SMs: H/64 slices x 8 CTAs (an eighth of K = 4H each, that
    eighth of the slice's W_h rows resident in float32), the batch's
    ceil(B/64) row groups walked in turn.  H a multiple of 128, the grid
    within the card and the shared memory within a block's; else the
    per-step kernel.  Returns {"kernel": "persistent_f32", "groups",
    "slices", "grid", "stages", "smem"} or {"kernel": "per_step"}."""
    if B < 1 or H < 128 or H % 128:
        return {"kernel": "per_step"}
    slices = H // BWD_UNITS
    grid = slices * BWD_SPLIT
    if grid > sms or bwd_f32_smem(H) > SMEM_LIMIT:
        return {"kernel": "per_step"}
    return {"kernel": "persistent_f32", "groups": -(-B // BWD_ROWS), "slices": slices,
            "grid": grid, "stages": BWD_F32_STAGES, "smem": bwd_f32_smem(H)}


def _bwd_scratch(plan, dev):
    """The persistent backward's partial products (groups, slices, 8, 64,
    64) float32 and its counters (a step counter a row group, then a slice
    counter a row group and slice; zeroed at each launch), for the bf16
    kernel and the float32 one alike."""
    groups, slices = plan["groups"], plan["slices"]
    part = torch.empty((groups, slices, BWD_SPLIT, BWD_ROWS, BWD_UNITS), dtype=f32, device=dev)
    counter = torch.empty((groups * (1 + slices),), dtype=torch.int32, device=dev)
    return part, counter


def _bwd_persistent_launch(dout, gates, cseq, c0, mask, w_h, dhn, dcn, plan, skip_barrier=0,
                           stamps=None):
    """The persistent backward on the plan's grid, overwriting ``gates``
    with dgates; ``skip_barrier`` plants a fault (each CTA reads dgates
    without waiting for the others), for checks; ``stamps``, a (T + 1, 4)
    int64 tensor on the device, takes CTA 0's SM clock at four points of
    each pass (row group 0; the kernel's ``Args::stamps``), for studies.
    Returns (gates, dh0, dc0)."""
    T, B, H = cseq.shape
    dev = gates.device
    with torch.cuda.device(dev):
        dh, dc = dhn.clone(), dcn.clone()
        if T == 0:
            return gates, dh, dc
        part, counter = _bwd_scratch(plan, dev)
        fn = _lib_fn("lstm_layer_bwd_persistent", "rst_lstm_layer_bwd_persistent",
                     [P] * 10 + [I] * 5 + [P, P])
        rc = fn(dout.data_ptr(), gates.data_ptr(), cseq.data_ptr(), c0.data_ptr(),
                mask.data_ptr(), w_h.data_ptr(), dh.data_ptr(), dc.data_ptr(), part.data_ptr(),
                counter.data_ptr(), T, B, H, plan["groups"], skip_barrier,
                None if stamps is None else stamps.data_ptr(),
                _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"persistent lstm_layer_bwd kernel launch failed: CUDA error {rc} "
                           f"(plan {plan})")
    return gates, dh, dc


def bwd_persistent_launches() -> int:
    """Launches of the persistent backward in gates mode so far, as its
    library counts them at the launch site."""
    return _lib_count("lstm_layer_bwd_persistent", "rst_layer_bwd_persistent_launches")


def recompute_persistent_launches() -> int:
    """Launches of the persistent backward in recompute mode so far (one a
    rebuild chunk), as its library counts them at the launch site."""
    return _lib_count("lstm_layer_bwd_persistent", "rst_recompute_persistent_launches")


def _bwd_per_step_launch(dout, gates, cseq, c0, mask, w_h, dhn, dcn):
    """The per-step gates-mode kernel (csrc/lstm_layer_bwd.cu), whatever
    the plan says: the wrapper's choice for the shapes ``bwd_plan`` does not
    take, and the design the persistent kernel replaced, for checks and
    timings beside it.  Overwrites ``gates`` with dgates; returns (gates,
    dh0, dc0)."""
    T, B, H = cseq.shape
    dev = gates.device
    with torch.cuda.device(dev):
        dh, dc = dhn.clone(), dcn.clone()
        if T == 0:
            return gates, dh, dc
        Bp = -(-B // 16) * 16
        par = torch.zeros((2, Bp, 4 * H), dtype=w_h.dtype, device=dev)
        fn = _lib_fn("lstm_layer_bwd", "rst_lstm_layer_bwd" + entry_suffix(w_h.dtype, gates.dtype),
                     [P] * 9 + [I] * 3 + [P])
        rc = fn(dout.data_ptr(), gates.data_ptr(), cseq.data_ptr(), c0.data_ptr(),
                mask.data_ptr(), w_h.data_ptr(), par.data_ptr(), dh.data_ptr(),
                dc.data_ptr(), T, B, H, _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"lstm_layer_bwd kernel launch failed: CUDA error {rc}")
    return gates, dh, dc


def recurrence_bwd(dout: Tensor, gates: Tensor, cseq: Tensor, c0: Tensor, mask: Tensor,
                   w_h: Tensor, dhn: Tensor, dcn: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Gates-mode backward of one layer: dout (T, B, H) float32, the
    forward's gates (T, B, 4H) and cseq (T, B, H) residuals, c0 (B, H) the
    initial c as the residual stores it (rounded to the residual dtype),
    mask (T, 1, B), w_h (H, 4H), dhn, dcn (B, H) float32.  ``gates`` is
    overwritten with dgates.  Returns (dgates (the ``gates`` tensor), dh0,
    dc0); on a CUDA device the kernel ``bwd_plan`` picks by shape and
    compute dtype, the persistent one (``persistent_launches`` adds the
    library's count of its launches) or the per-step one (``f32_launches``
    counts its float32 calls); the plain version on the CPU."""
    if not gates.is_cuda:
        return recurrence_bwd_plain(dout, gates, cseq, c0, mask, w_h, dhn, dcn)
    T, B, H = cseq.shape
    pad = HiddenPad(H)
    if pad.needed:
        dg, dh0, dc0 = pad.call(recurrence_bwd, (dout, gates, cseq, c0, mask, w_h, dhn, dcn),
                                *PAD_KINDS["recurrence_bwd"])
        return gates.copy_(dg), dh0, dc0
    mode, res = kernel_dtype(w_h.dtype, gates.dtype)
    _bwd_checks(dout, cseq, c0, mask, w_h, dhn, dcn,
                [("gates", gates, res, (T, B, 4 * H))], mode, res)
    dev = gates.device
    plan = bwd_plan(B, H, torch.cuda.get_device_properties(dev).multi_processor_count, mode,
                    res)
    if plan["kernel"] == "persistent":
        before = bwd_persistent_launches()
        out = _bwd_persistent_launch(dout, gates, cseq, c0, mask, w_h, dhn, dcn, plan)
        recurrence_bwd.persistent_launches += bwd_persistent_launches() - before
    else:
        out = _bwd_per_step_launch(dout, gates, cseq, c0, mask, w_h, dhn, dcn)
        if (mode, res) == (f32, f32):
            recurrence_bwd.f32_launches += 1
    recurrence_bwd.launches += 1
    return out


recurrence_bwd.launches = 0
recurrence_bwd.persistent_launches = 0
recurrence_bwd.f32_launches = 0


def _recompute_chunks(T: int, B: int, H: int):
    """(chunk, starts): the rebuild chunk's steps and the chunks' starts in
    the order the kernels run them (last first), as a ctypes array."""
    chunk = rebuild_chunk(T, B, H)
    starts = [t0 for t0, _ in rebuild_chunks(T, chunk)]
    return chunk, (ctypes.c_int * len(starts))(*starts)


def _recompute_per_step_launch(dout, x, h_prev, cseq, c0, mask, w_x, b, w_h, dhn, dcn):
    """The per-step recompute kernel (csrc/lstm_layer_bwd.cu: a rebuild
    product a chunk, then a launch a step), whatever the plan says: the
    wrapper's choice for the shapes ``bwd_plan`` does not take and for the
    mixed compute and residual dtypes, and the design the persistent
    kernels replaced, for checks and timings beside them.  Returns (dgates,
    dh0, dc0, rebuild products launched)."""
    T, B, H = cseq.shape
    D = x.shape[-1]
    dev = cseq.device
    mode, res = w_h.dtype, cseq.dtype
    with torch.cuda.device(dev):
        dh, dc = dhn.clone(), dcn.clone()
        dgates = torch.empty((T, B, 4 * H), dtype=res, device=dev)
        if T == 0 or B == 0:
            return dgates, dh, dc, 0
        chunk, starts = _recompute_chunks(T, B, H)
        Bp = -(-B // 16) * 16
        par = torch.zeros((2, Bp, 4 * H), dtype=mode, device=dev)
        act = torch.empty((chunk * B, 4 * H), dtype=f32, device=dev)
        head = [dout.data_ptr(), dgates.data_ptr(), cseq.data_ptr(), c0.data_ptr(),
                mask.data_ptr(), w_h.data_ptr()]
        tail = [b.data_ptr(), par.data_ptr(), dh.data_ptr(), dc.data_ptr(), act.data_ptr(),
                starts, len(starts), chunk, T, B, H, D]
        before = _lib_count("lstm_layer_bwd", "rst_rebuild_launches")
        if mode == res:
            fn = _lib_fn("lstm_layer_bwd", "rst_lstm_layer_bwd_recompute" + entry_suffix(mode),
                         [P] * 15 + [I] * 6 + [P])
            rc = fn(*head, x.data_ptr(), h_prev.data_ptr(), w_x.data_ptr(), *tail,
                    _build.launch_stream(dev))
        else:
            # The JAX kernel's product of residual-dtype x with compute-dtype
            # W_x sums their float32 values: the float32 rebuild on float32
            # copies of both.
            ops32 = [t.to(f32).contiguous() for t in (x, h_prev, w_x, w_h)]
            fn = _lib_fn("lstm_layer_bwd", "rst_lstm_layer_bwd_recompute_mixed",
                         [P] * 16 + [I] * 7 + [P])
            rc = fn(*head, *[t.data_ptr() for t in ops32], *tail, int(res == f32),
                    _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"lstm_layer_bwd_recompute kernel launch failed: CUDA error {rc}")
    return dgates, dh, dc, _lib_count("lstm_layer_bwd", "rst_rebuild_launches") - before


def _recompute_persistent_launch(dout, x, h_prev, cseq, c0, mask, w_x, b, w_h, dhn, dcn,
                                 plan, skip_barrier=0, dgates=None):
    """The recompute backward on the persistent kernel on the plan's grid:
    for each rebuild chunk (``rebuild_chunks``, last first) its rebuild
    product, then one persistent launch of its steps.  ``skip_barrier``
    plants faults, for checks: bit 1, each CTA reads dgates without
    waiting for the others; bit 2, it sums the slice's partials without
    waiting for them; bit 4, the bounds checks' positive control: ``act``'s
    rows stated one step short (the checked build traps, the default one
    runs as without it).  ``dgates``, (T, B, 4H) bf16, is the stream to
    write (a fresh one by default; a check hands one filled with NaN so a
    read of a step not written yet shows).  Returns (dgates, dh0, dc0,
    rebuild products launched)."""
    T, B, H = cseq.shape
    D = x.shape[-1]
    dev = cseq.device
    with torch.cuda.device(dev):
        dh, dc = dhn.clone(), dcn.clone()
        if dgates is None:
            dgates = torch.empty((T, B, 4 * H), dtype=bf16, device=dev)
        if T == 0 or B == 0:
            return dgates, dh, dc, 0
        chunk, starts = _recompute_chunks(T, B, H)
        act = torch.empty((chunk * B, 4 * H), dtype=f32, device=dev)
        part, counter = _bwd_scratch(plan, dev)
        fn = _lib_fn("lstm_layer_bwd_persistent", "rst_lstm_layer_bwd_recompute_persistent",
                     [P] * 16 + [I] * 8 + [P])
        before = _lib_count("lstm_layer_bwd_persistent", "rst_recompute_rebuild_launches")
        rc = fn(dout.data_ptr(), dgates.data_ptr(), cseq.data_ptr(), c0.data_ptr(),
                mask.data_ptr(), w_h.data_ptr(), x.data_ptr(), h_prev.data_ptr(),
                w_x.data_ptr(), b.data_ptr(), dh.data_ptr(), dc.data_ptr(), act.data_ptr(),
                part.data_ptr(), counter.data_ptr(), starts, len(starts), chunk, T, B, H, D,
                plan["groups"], skip_barrier, _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"persistent lstm_layer_bwd_recompute kernel launch failed: "
                           f"CUDA error {rc} (plan {plan})")
    rebuilds = _lib_count("lstm_layer_bwd_persistent", "rst_recompute_rebuild_launches")
    return dgates, dh, dc, rebuilds - before


def _bwd_f32_persistent_launch(dout, gates, cseq, c0, mask, w_h, dhn, dcn, plan,
                               skip_barrier=0):
    """The float32 persistent backward in gates mode on the plan's grid
    (``bwd_f32_plan``): one launch over T, dgates written over ``gates``;
    the float32 layer sweep's chain (``lstm_wavefront._layer_sweep_launch``).
    ``skip_barrier`` plants faults, for checks: bit 1, each CTA reads
    dgates without waiting for the others; bit 2, it sums the slice's
    partials without waiting for them; bit 4, it leaves the slice's last
    partial out of the sum.  Returns (gates, dh0, dc0)."""
    T, B, H = cseq.shape
    dev = gates.device
    with torch.cuda.device(dev):
        dh, dc = dhn.clone(), dcn.clone()
        if T == 0:
            return gates, dh, dc
        part, counter = _bwd_scratch(plan, dev)
        fn = _lib_fn("lstm_layer_bwd_f32", "rst_lstm_layer_bwd_f32_persistent",
                     [P] * 10 + [I] * 5 + [P])
        rc = fn(dout.data_ptr(), gates.data_ptr(), cseq.data_ptr(), c0.data_ptr(),
                mask.data_ptr(), w_h.data_ptr(), dh.data_ptr(), dc.data_ptr(), part.data_ptr(),
                counter.data_ptr(), T, B, H, plan["groups"], skip_barrier,
                _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"float32 persistent lstm_layer_bwd kernel launch failed: CUDA error "
                           f"{rc} (plan {plan})")
    return gates, dh, dc


def bwd_f32_launches() -> int:
    """Launches of the float32 persistent backward in gates mode so far, as
    its library counts them at the launch site."""
    return _lib_count("lstm_layer_bwd_f32", "rst_layer_bwd_f32_launches")


def _recompute_f32_persistent_launch(dout, x, h_prev, cseq, c0, mask, w_x, b, w_h, dhn, dcn,
                                     plan, skip_barrier=0, dgates=None):
    """The float32 recompute backward on the persistent kernel on the plan's
    grid (``bwd_f32_plan``): for each rebuild chunk (``rebuild_chunks``,
    last first) its float32 rebuild product on the GEMM tile, then one
    persistent launch of its steps.  ``skip_barrier`` plants faults as
    ``_bwd_f32_persistent_launch`` takes them; ``dgates``, (T, B, 4H)
    float32, is the stream to write (a fresh one by default; a check hands
    one filled with NaN).  Returns (dgates, dh0, dc0, rebuild products
    launched)."""
    T, B, H = cseq.shape
    D = x.shape[-1]
    dev = cseq.device
    with torch.cuda.device(dev):
        dh, dc = dhn.clone(), dcn.clone()
        if dgates is None:
            dgates = torch.empty((T, B, 4 * H), dtype=f32, device=dev)
        if T == 0 or B == 0:
            return dgates, dh, dc, 0
        chunk, starts = _recompute_chunks(T, B, H)
        act = torch.empty((chunk * B, 4 * H), dtype=f32, device=dev)
        part, counter = _bwd_scratch(plan, dev)
        fn = _lib_fn("lstm_layer_bwd_f32", "rst_lstm_layer_bwd_recompute_f32_persistent",
                     [P] * 16 + [I] * 8 + [P])
        count = ("lstm_layer_bwd_f32", "rst_recompute_f32_rebuild_launches")
        before = _lib_count(*count)
        rc = fn(dout.data_ptr(), dgates.data_ptr(), cseq.data_ptr(), c0.data_ptr(),
                mask.data_ptr(), w_h.data_ptr(), x.data_ptr(), h_prev.data_ptr(),
                w_x.data_ptr(), b.data_ptr(), dh.data_ptr(), dc.data_ptr(), act.data_ptr(),
                part.data_ptr(), counter.data_ptr(), starts, len(starts), chunk, T, B, H, D,
                plan["groups"], skip_barrier, _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"float32 persistent lstm_layer_bwd_recompute kernel launch failed: "
                           f"CUDA error {rc} (plan {plan})")
    return dgates, dh, dc, _lib_count(*count) - before


# The float32 persistent forward (csrc/lstm_layer_fwd_f32.cu): CTAs of a
# slice (the carry product's K split in quarters), hidden units of a slice
# (its four gates' 128 columns), K columns of a streamed box of h and the
# ring's stages; BWD_ROWS-row groups.
FWD_F32_SPLIT, FWD_F32_UNITS, FWD_F32_KBOX, FWD_F32_STAGES = 4, 32, 32, 8


def fwd_f32_smem(H: int) -> int:
    """Dynamic shared memory of the float32 persistent forward: the W_h
    block (H/4 K rows of a slice's 128 gate columns, transposed, rows
    padded by 4 floats) and the ring of (64, 32) h boxes, rows padded by 4
    (the kernel's ``smem_bytes``)."""
    return 4 * (4 * FWD_F32_UNITS * (H // FWD_F32_SPLIT + 4)
                + FWD_F32_STAGES * BWD_ROWS * (FWD_F32_KBOX + 4))


def fwd_f32_plan(B: int, H: int, sms: int = H100_SMS) -> dict:
    """The float32 persistent forward's grid at (B, H) on a card of
    ``sms`` SMs: H/32 slices of 32 units x 4 CTAs (a quarter of K = H each,
    that quarter of W_h's rows for the slice's 128 gate columns resident in
    float32), the batch's ceil(B/64) row groups walked in turn.  H a
    multiple of 128, the grid within the card and the shared memory within
    a block's; else {"kernel": "per_step"}.  Returns {"kernel":
    "persistent_f32", "groups", "slices", "grid", "stages", "smem"}."""
    if B < 1 or H < 128 or H % 128:
        return {"kernel": "per_step"}
    slices = H // FWD_F32_UNITS
    grid = slices * FWD_F32_SPLIT
    if grid > sms or fwd_f32_smem(H) > SMEM_LIMIT:
        return {"kernel": "per_step"}
    return {"kernel": "persistent_f32", "groups": -(-B // BWD_ROWS), "slices": slices,
            "grid": grid, "stages": FWD_F32_STAGES, "smem": fwd_f32_smem(H)}


def _fwd_f32_persistent_launch(x_in, w_x, b, w_h, mask, h0, c0, gates, cseq, outs, xnext,
                               drop, boundary, plan, skip_barrier=0, skip_k=0):
    """One layer of the float32 layer sweep's forward on the plan's grid
    (``fwd_f32_plan``; ``lstm_wavefront._fwd_layer_sweep_launch``): the
    input product xp = x_in·w_x + b into ``gates`` on the float32 GEMM tile,
    then one persistent launch of the recurrence over T, which writes the
    activated gates over xp, ``cseq``, ``outs`` and, where ``xnext`` is
    given (below the top layer), the next layer's input h·keep·scale of
    boundary ``boundary`` (``drop`` as ``lstm_wavefront._drop_launch_args``
    gives it, the drop mode first).  x_in (T, B, K), w_x (K, 4H), b (4H,),
    w_h (H, 4H), mask (T, 1, B), h0, c0 (B, H), all float32.
    ``skip_barrier`` plants the chain's faults, for checks: bit 1, each CTA
    loads h(t-1) without the step wait; bit 2, it sums the slice's
    partials without waiting for them; bit 4, it leaves the slice's last
    partial out of the sum; ``skip_k`` leaves out the input product's last
    K stages.  Returns (hn, cn)."""
    T, B, H = cseq.shape
    K = x_in.shape[-1]
    dev = gates.device
    drop_mode, masks, seed0, seed1, thr, scale = drop
    with torch.cuda.device(dev):
        h, c = h0.clone(), c0.clone()
        if T == 0:
            return h, c
        ring = torch.empty((2, B, H), dtype=f32, device=dev)
        ring[1] = h0
        groups, slices = plan["groups"], plan["slices"]
        part = torch.empty((groups, slices, FWD_F32_SPLIT, BWD_ROWS, 4 * FWD_F32_UNITS),
                           dtype=f32, device=dev)
        counter = torch.empty((groups * (1 + slices),), dtype=torch.int32, device=dev)
        mask_l = masks[boundary] if drop_mode == 1 and xnext is not None else None
        U = ctypes.c_uint
        fn = _lib_fn("lstm_layer_fwd_f32", "rst_lstm_layer_fwd_f32",
                     [P] * 15 + [I] * 6 + [U] * 3 + [ctypes.c_float] + [I] * 3 + [P])
        rc = fn(x_in.data_ptr(), w_x.data_ptr(), b.data_ptr(), w_h.data_ptr(), mask.data_ptr(),
                gates.data_ptr(), cseq.data_ptr(), outs.data_ptr(),
                None if xnext is None else xnext.data_ptr(), h.data_ptr(), c.data_ptr(),
                ring.data_ptr(), part.data_ptr(), counter.data_ptr(),
                None if mask_l is None else mask_l.data_ptr(), T, B, H, K, groups, drop_mode,
                seed0, seed1, thr, scale, boundary, skip_barrier, skip_k,
                _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"float32 persistent lstm_layer_fwd kernel launch failed: CUDA error "
                           f"{rc} (plan {plan})")
    return h, c


def fwd_f32_xp(x_in: Tensor, w_x: Tensor, b: Tensor) -> Tensor:
    """The float32 layer sweep's input product alone on the card
    (``rst_layer_fwd_f32_xp``, uncounted; for timings of the sweep's split):
    (T, B, 4H) = b + x_in (T, B, K)·w_x (K, 4H), float32."""
    T, B, K = x_in.shape
    G = w_x.shape[1]
    dev = x_in.device
    with torch.cuda.device(dev):
        gates = torch.empty((T, B, G), dtype=f32, device=dev)
        fn = _lib_fn("lstm_layer_fwd_f32", "rst_layer_fwd_f32_xp", [P] * 4 + [I] * 3 + [P])
        rc = fn(x_in.data_ptr(), w_x.data_ptr(), b.data_ptr(), gates.data_ptr(), T * B, G // 4, K,
                _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"float32 input product launch failed: CUDA error {rc}")
    return gates


def fwd_f32_launches() -> int:
    """Launches of the float32 persistent forward's chain so far (one a
    layer), as its library counts them at the launch site."""
    return _lib_count("lstm_layer_fwd_f32", "rst_layer_fwd_f32_launches")


def fwd_f32_xp_launches() -> int:
    """Input products of the float32 layer sweep's forward so far (one a
    layer), as its library counts them at the launch site."""
    return _lib_count("lstm_layer_fwd_f32", "rst_layer_fwd_f32_xp_launches")


def recompute_f32_launches() -> int:
    """Launches of the float32 persistent backward in recompute mode so far
    (one a rebuild chunk), as its library counts them at the launch site."""
    return _lib_count("lstm_layer_bwd_f32", "rst_recompute_f32_launches")


def recurrence_bwd_recompute(dout: Tensor, x: Tensor, h_prev: Tensor, cseq: Tensor,
                             c0: Tensor, mask: Tensor, w_x: Tensor, b: Tensor, w_h: Tensor,
                             dhn: Tensor, dcn: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Recompute-mode backward of one layer: as ``recurrence_bwd`` with the
    gates rebuilt from x (T, B, D) and h_prev (T, B, H) in the residual
    dtype, w_x (D, 4H) and the bias b (4H,) float32.  Returns (dgates
    (T, B, 4H) in the residual dtype, dh0, dc0).  On a CUDA device the
    kernel ``bwd_plan`` picks by shape and the compute and residual dtypes:
    the bf16 persistent one, a launch a rebuild chunk (``persistent_launches``
    adds the library's count), the float32 persistent one, likewise
    (``f32_persistent_launches``), or the per-step one (``per_step_launches``
    counts its calls); ``f32_launches`` counts the float32 calls,
    ``rebuild_launches`` adds the rebuild products any of them launched.
    The plain version on the CPU."""
    if not cseq.is_cuda:
        return recurrence_bwd_recompute_plain(dout, x, h_prev, cseq, c0, mask, w_x, b,
                                              w_h, dhn, dcn)
    T, B, H = cseq.shape
    pad = HiddenPad(H, x.shape[-1])
    if pad.needed:
        return pad.call(recurrence_bwd_recompute,
                        (dout, x, h_prev, cseq, c0, mask, w_x, b, w_h, dhn, dcn),
                        *PAD_KINDS["recurrence_bwd_recompute"])
    dev = cseq.device
    mode, res = kernel_dtype(w_h.dtype, cseq.dtype)
    _bwd_checks(dout, cseq, c0, mask, w_h, dhn, dcn,
                _rebuild_checks(x, h_prev, w_x, b, mode, res), mode, res)
    args = (dout, x, h_prev, cseq, c0, mask, w_x, b, w_h, dhn, dcn)
    plan = bwd_plan(B, H, torch.cuda.get_device_properties(dev).multi_processor_count, mode,
                    res, recompute=True)
    if plan["kernel"] == "persistent":
        before = recompute_persistent_launches()
        *out, rebuilds = _recompute_persistent_launch(*args, plan)
        recurrence_bwd_recompute.persistent_launches += recompute_persistent_launches() - before
    elif plan["kernel"] == "persistent_f32":
        before = recompute_f32_launches()
        *out, rebuilds = _recompute_f32_persistent_launch(*args, plan)
        recurrence_bwd_recompute.f32_persistent_launches += recompute_f32_launches() - before
    else:
        *out, rebuilds = _recompute_per_step_launch(*args)
        recurrence_bwd_recompute.per_step_launches += T > 0 and B > 0
    if mode == f32 and res == f32:
        recurrence_bwd_recompute.f32_launches += 1
    recurrence_bwd_recompute.launches += 1
    recurrence_bwd_recompute.rebuild_launches += rebuilds
    return tuple(out)


recurrence_bwd_recompute.launches = 0
recurrence_bwd_recompute.rebuild_launches = 0
recurrence_bwd_recompute.persistent_launches = 0
recurrence_bwd_recompute.per_step_launches = 0
recurrence_bwd_recompute.f32_launches = 0
recurrence_bwd_recompute.f32_persistent_launches = 0


# ------------------------------------------------------- differentiable layer


def input_projection(x: Tensor, w_x: Tensor, b: Tensor, cd, out_dtype) -> Tensor:
    """x·W_x + b with float32 sums, rounded once to ``out_dtype``.  For a
    narrower ``out_dtype`` it runs a chunk of rows at a time, so no
    (T, B, 4H) float32 stream exists next to the result."""
    bias = b.to(f32)
    if out_dtype == f32:
        x_proj = dot_f32(x, w_x, cd)
        x_proj += bias
        return x_proj
    x2 = x.reshape(-1, x.shape[-1])
    out = x.new_empty((x2.shape[0], w_x.shape[1]), dtype=out_dtype)
    for r0 in range(0, x2.shape[0], _PROJ_ROWS):
        part = dot_f32(x2[r0:r0 + _PROJ_ROWS], w_x, cd)
        part += bias
        out[r0:r0 + _PROJ_ROWS] = part
    return out.reshape(*x.shape[:-1], -1)


class _LayerTrain(torch.autograd.Function):
    """One layer with gates-mode residuals (``_lstm_core`` and its VJP):
    the f32 input projection, the training forward, and a backward whose
    dgates overwrite the saved gates residual, so it runs once.  dx is cast
    to x's dtype."""

    @staticmethod
    def forward(ctx, w_x, w_h, b, x, c0, h0, mask, cd, rd):
        x_proj = input_projection(x, w_x, b, cd, f32)
        out, hn, cn, gates, cseq = recurrence_train(
            x_proj, w_h.to(cd).contiguous(), mask, h0.to(f32).contiguous(),
            c0.to(f32).contiguous(), rd)
        ctx.save_for_backward(w_x, w_h, x, c0, h0, mask, out, gates, cseq)
        ctx.cd, ctx.rd = cd, rd
        ctx.consumed = False
        return out, cn, hn

    @staticmethod
    def backward(ctx, dout, dcn, dhn):
        if ctx.consumed:
            raise RuntimeError("the layer's backward runs once: it overwrites its "
                               "gates residual with dgates")
        ctx.consumed = True
        stages.mark("stack_backward")
        w_x, w_h, x, c0, h0, mask, out, gates, cseq = ctx.saved_tensors
        cd, rd = ctx.cd, ctx.rd
        dgates, dh0, dc0 = recurrence_bwd(
            dout.to(f32).contiguous(), gates, cseq, c0.to(rd).to(f32).contiguous(), mask,
            w_h.to(cd).contiguous(), dhn.to(f32).contiguous(), dcn.to(f32).contiguous())
        stages.mark("weight_grads")
        # Contiguous-prefix masking: out[t-1] is the carried h wherever
        # dgates[t] is non-zero.
        h_prev = torch.cat([h0.to(f32)[None], out[:-1]], dim=0)
        dw_h, dw_x, db = dgates_weight_grads(h_prev, x, dgates, compute_dtype=cd)
        dx = dot_f32(dgates, w_x.t(), cd).to(x.dtype)
        return (dw_x.to(w_x.dtype), dw_h.to(w_h.dtype), db, dx, dc0.to(c0.dtype),
                dh0.to(h0.dtype), None, None, None)


class _LayerTrainRecompute(torch.autograd.Function):
    """One layer with recompute-mode residuals (``_lstm_core_recompute``):
    the projected gates narrow to the residual dtype before the lean
    forward, only x, out and c are kept (in the residual dtype), and the
    backward rebuilds the gates.  dx is cast to x's own dtype (bf16 between
    layers of the low-precision chain)."""

    @staticmethod
    def forward(ctx, w_x, w_h, b, x, c0, h0, mask, cd, rd):
        x_proj = input_projection(x, w_x, b, cd, rd)
        out, hn, cn, cseq = recurrence_train_lean(
            x_proj, w_h.to(cd).contiguous(), mask, h0.to(f32).contiguous(),
            c0.to(f32).contiguous(), rd)
        ctx.save_for_backward(w_x, w_h, b, x.to(rd), c0, h0, mask, out.to(rd), cseq)
        ctx.cd, ctx.rd, ctx.x_dtype = cd, rd, x.dtype
        return out, cn, hn

    @staticmethod
    def backward(ctx, dout, dcn, dhn):
        stages.mark("stack_backward")
        w_x, w_h, b, x_rd, c0, h0, mask, out_rd, cseq = ctx.saved_tensors
        cd, rd = ctx.cd, ctx.rd
        h_prev = torch.cat([h0.to(rd)[None], out_rd[:-1]], dim=0)
        dgates, dh0, dc0 = recurrence_bwd_recompute(
            dout.to(f32).contiguous(), x_rd.contiguous(), h_prev, cseq,
            c0.to(rd).to(f32).contiguous(), mask, w_x.to(cd).contiguous(),
            b.to(f32).contiguous(), w_h.to(cd).contiguous(), dhn.to(f32).contiguous(),
            dcn.to(f32).contiguous())
        stages.mark("weight_grads")
        dw_h, dw_x, db = dgates_weight_grads(h_prev, x_rd, dgates, compute_dtype=cd)
        dx = dot_f32(dgates, w_x.t(), cd).to(ctx.x_dtype)
        return (dw_x.to(w_x.dtype), dw_h.to(w_h.dtype), db, dx, dc0.to(c0.dtype),
                dh0.to(h0.dtype), None, None, None)


def lstm_layer_train(params, x: Tensor, seq_lengths: Tensor, state: LayerState,
                     compute_dtype=f32, residual_dtype=None,
                     residual_mode: str = "gates") -> Tuple[Tensor, LayerState]:
    """One differentiable layer (``lstm_layer_pallas``).  Returns (out
    (T, B, H) float32, (cn, hn)).  ``residual_dtype`` defaults to bf16 for
    bf16 compute, else float32; ``residual_mode`` is "gates" (store the
    activated gates: the cheapest backward) or "recompute" (store only c
    and rebuild the gates in the backward: the leanest residuals)."""
    if residual_mode not in ("gates", "recompute"):
        raise ValueError(f"residual_mode must be 'gates' or 'recompute', got "
                         f"{residual_mode!r}")
    cd = compute_dtype
    rd = residual_dtype or (bf16 if cd == bf16 else f32)
    mask = length_mask(x.shape[0], seq_lengths, x.device)
    c0, h0 = state
    core = _LayerTrain if residual_mode == "gates" else _LayerTrainRecompute
    out, cn, hn = core.apply(params["w_x"], params["w_h"], params["b"], x, c0, h0, mask,
                             cd, rd)
    return out, (cn, hn)
