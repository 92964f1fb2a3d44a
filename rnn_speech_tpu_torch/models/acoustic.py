"""Acoustic model: input projection -> stacked LSTM -> output projection.

Counterpart of ``rnn_speech_tpu/models/acoustic.py``: a per-timestep
input projection, optional batch normalisation over the batch axis, N
stacked LSTM layers, and an output projection to the char map, with the
recurrent state passed in and returned.  Time-major (T, B, D) throughout.
The projections are matmuls in the compute dtype with float32
accumulation, plus the bias; on the kernel route their weight gradients
come from the weight-gradient kernel (``_Dense``), and the top dropout
site and the output projection are one op (``_DroppedDense``) whose
backward rebuilds the dropped copy from the seed.  The training memory
plan is re-derived for the card's memory (``default_residual_budget``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from rnn_speech_tpu_torch import resolve_device, stages
from rnn_speech_tpu_torch.ops import lstm
from rnn_speech_tpu_torch.ops.dropout import dropout_kernel
from rnn_speech_tpu_torch.ops.grad_matmul import weight_grad

Tensor = torch.Tensor
Params = Dict[str, Any]
States = List[lstm.LayerState]


@dataclass(frozen=True)
class AcousticConfig:
    num_layers: int
    hidden_size: int
    input_dim: int
    num_labels: int
    normalization: bool = False
    compute_dtype: torch.dtype = torch.float32
    # Run the LSTM recurrence through the hand-written CUDA kernels (the
    # JAX package's ``use_pallas``); on CPU tensors the kernel wrappers run
    # their plain versions.
    use_kernels: bool = False
    # Whole-stack diagonal kernel (ops/lstm_wavefront.py); needs
    # use_kernels and >= 2 layers, else the layered path runs.
    wavefront: bool = False
    # Stack N adjacent frames and subsample time by N before the LSTM.
    frame_stack: int = 1
    # Training memory policies of the JAX package (``training_memory_plan``
    # picks among them): per-layer rematerialisation, chunks of time_chunk
    # steps with carried state, and "gates" or "recompute" residuals.
    remat: bool = False
    time_chunk: int = 0
    residual_mode: str = "gates"


def init_params(generator: torch.Generator, cfg: AcousticConfig,
                device=None) -> Params:
    """Xavier-uniform weights and zero biases from ``generator``, on
    ``device`` (default cuda)."""
    dev = resolve_device(device)
    in_dim = cfg.input_dim * max(cfg.frame_stack, 1)
    return {
        "input": {
            "w": lstm.xavier_uniform(generator, (in_dim, cfg.hidden_size), dev),
            "b": torch.zeros((cfg.hidden_size,), device=dev),
        },
        "lstm": lstm.init_lstm_stack(
            generator, cfg.num_layers, cfg.hidden_size, cfg.hidden_size, dev
        ),
        "output": {
            "w": lstm.xavier_uniform(generator, (cfg.hidden_size, cfg.num_labels), dev),
            "b": torch.zeros((cfg.num_labels,), device=dev),
        },
    }


def config_for_params(params: Params, **kw) -> AcousticConfig:
    """An AcousticConfig whose widths are read off a parameter dict."""
    return AcousticConfig(
        num_layers=len(params["lstm"]),
        hidden_size=params["lstm"][0]["w_h"].shape[0],
        input_dim=params["input"]["w"].shape[0] // max(kw.get("frame_stack", 1), 1),
        num_labels=params["output"]["w"].shape[1],
        **kw,
    )


def zero_state(cfg: AcousticConfig, batch_size: int, device=None) -> States:
    return lstm.zero_state(cfg.num_layers, batch_size, cfg.hidden_size,
                           device=device)


def _batch_norm(x: Tensor, eps: float = 1e-3) -> Tensor:
    """Normalise over the batch axis per (time, feature), no scale/offset.

    Deviation kept from the JAX package: with batch size 1 the reference's
    formula gives identically zero activations, so B == 1 is an identity."""
    if x.shape[1] == 1:
        return x
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def stack_frames(x: Tensor, seq_lengths: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """(T, B, D) -> (ceil(T/n), B, n*D) by concatenating adjacent frames;
    lengths become ceil(len/n); padding sub-frames are zero."""
    T, B, D = x.shape
    T_pad = -(-T // n) * n
    if T_pad != T:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, T_pad - T))
    x = x.reshape(T_pad // n, n, B, D).permute(0, 2, 1, 3).reshape(
        T_pad // n, B, n * D
    )
    lens = torch.as_tensor(seq_lengths, device=x.device)
    return x, -torch.div(-lens, n, rounding_mode="floor")


def _plain_dense(h: Tensor, w: Tensor, b: Tensor, cd) -> Tensor:
    return lstm.dot_f32(h, w, cd) + b


class _Dense(torch.autograd.Function):
    """x·W + b whose backward routes the weight and bias gradients through
    the weight-gradient kernel (``weight_grad``) and dh = g·Wᵀ through a
    matmul, cast to h's dtype.  The primal is the plain projection's."""

    @staticmethod
    def forward(ctx, h, w, b, cd):
        ctx.save_for_backward(h, w)
        ctx.cd = cd
        ctx.b_dtype = b.dtype
        return _plain_dense(h, w, b, cd)

    @staticmethod
    def backward(ctx, g):
        stages.mark("projection_backward")
        h, w = ctx.saved_tensors
        dh = None
        if ctx.needs_input_grad[0]:
            dh = lstm.dot_f32(g, w.t(), ctx.cd).to(h.dtype)
        dw, db = weight_grad(h, g, compute_dtype=ctx.cd)
        return dh, dw.to(w.dtype), db.to(ctx.b_dtype), None


class _DroppedDense(torch.autograd.Function):
    """drop(h)·W + b as one op (``_dropped_dense``): the top dropout site
    fused with the output projection.  The residual is (seed, h, W): the
    backward rebuilds the dropped copy with the dropout kernel instead of
    keeping it, then dy = g·Wᵀ (float32), dh = the same mask·scale applied
    to dy, and (dW, db) from the weight-gradient kernel on the rebuilt
    copy."""

    @staticmethod
    def forward(ctx, h, w, b, seed, keep, cd):
        ctx.save_for_backward(h, w)
        ctx.seed, ctx.keep, ctx.cd, ctx.b_dtype = seed, keep, cd, b.dtype
        return _plain_dense(dropout_kernel(h, seed, [keep]), w, b, cd)

    @staticmethod
    def backward(ctx, g):
        stages.mark("projection_backward")
        h, w = ctx.saved_tensors
        dropped = dropout_kernel(h, ctx.seed, [ctx.keep])
        dy = lstm.dot_f32(g, w.t(), ctx.cd)
        dh = dropout_kernel(dy, ctx.seed, [ctx.keep]).to(h.dtype)
        dw, db = weight_grad(dropped, g, compute_dtype=ctx.cd)
        return dh, dw.to(w.dtype), db.to(ctx.b_dtype), None, None, None


def dense(h: Tensor, w: Tensor, b: Tensor, cd, use_kernels: bool) -> Tensor:
    """The projection: ``_Dense`` on the kernel route, else plain."""
    return _Dense.apply(h, w, b, cd) if use_kernels else _plain_dense(h, w, b, cd)


def forward(params: Params, cfg: AcousticConfig, inputs: Tensor,
            seq_lengths: Tensor, states: States, *,
            dropout_rng: Optional[torch.Generator] = None,
            input_keep_prob: float = 1.0,
            output_keep_prob: float = 1.0) -> Tuple[Tensor, States]:
    """Forward -> (logits (T', B, num_labels) float32, new states),
    T' = ceil(T / frame_stack).  Pass ``dropout_rng`` (a CPU
    ``torch.Generator``) to train with the keep probabilities; without it
    they are ignored."""
    if cfg.frame_stack > 1:
        inputs, seq_lengths = stack_frames(inputs, seq_lengths, cfg.frame_stack)
    cd = cfg.compute_dtype
    proj = lambda h, p: dense(h, p["w"], p["b"], cd, cfg.use_kernels)

    def head(h):
        stages.mark("head_ctc")
        return proj(h, params["output"])

    def head_fused(seed, h):
        stages.mark("head_ctc")
        return _DroppedDense.apply(h, params["output"]["w"], params["output"]["b"],
                                   seed, float(output_keep_prob), cd)

    x = proj(inputs, params["input"])
    if cfg.normalization:
        x = _batch_norm(x)
    return lstm.lstm_stack(
        params["lstm"], x, seq_lengths, states,
        compute_dtype=cd, dropout_rng=dropout_rng,
        input_keep_prob=input_keep_prob, output_keep_prob=output_keep_prob,
        use_kernels=cfg.use_kernels, remat=cfg.remat, time_chunk=cfg.time_chunk,
        residual_mode=cfg.residual_mode, wavefront=cfg.wavefront,
        head=head, head_fused=head_fused if cfg.use_kernels else None,
    )


def output_lengths(cfg: AcousticConfig, frame_lengths: Tensor) -> Tensor:
    """Valid logit count per example of ``forward``'s output."""
    if cfg.frame_stack > 1:
        return -torch.div(-frame_lengths, cfg.frame_stack, rounding_mode="floor")
    return frame_lengths


def param_count(params: Params) -> int:
    from rnn_speech_tpu_torch.params import flatten

    return sum(int(p.numel()) for p in flatten(params).values())


# ------------------------------------------------- training memory policy

#: Share of the card's memory given to the LSTM stack's backward residuals
#: by default.  The rest holds the parameters, gradients and Adam state
#: (about 0.5 GB at 3x1024), the f32 projections, the logits and their
#: log-softmax, the CTC kernels' alpha checkpoints (one (B, 2U+1) f32 row
#: per 32 steps, 34 MB at B=64, T=3510, U=600; the scan CTC instead keeps
#: four (T, B, 2U+1) f32 arrays, about 4.3 GB), what the reverse diagonal
#: adds for the dW_x contractions, and the allocator's transients.  Below
#: the fused-dW_x threshold (``lstm_wavefront.fuse_dwx_enabled``:
#: L·T·B·6H·2 bytes of residuals under 10 GiB, B < 83 at T=3510) the pass
#: emits the (L-1, T, B, H) bf16 xdrop stream of inter-layer dropout (0.92
#: GB at B=64), held until the weight gradients; above it, as on the
#: widest batch this share admits (B=394 on an 80 GB card), it holds only
#: a (L-1, 128, B, H) bf16 ring (0.21 GB at B=394) and the (L-1, H, 4H) f32
#: dW_x (32 MiB).
RESIDUAL_SHARE = 0.6


def default_residual_budget(device=None) -> int:
    """``RESIDUAL_SHARE`` of the total memory of the CUDA ``device``
    (default cuda:0), in bytes.  Raises without a GPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the default residual budget is a share of a CUDA card's "
                         "memory; pass budget_bytes for other devices")
    return int(RESIDUAL_SHARE * torch.cuda.get_device_properties(dev).total_memory)


def _res_bytes(cfg: AcousticConfig) -> int:
    return 2 if cfg.compute_dtype == torch.bfloat16 else 4


def training_residual_bytes(cfg: AcousticConfig, T: int, B: int,
                            residual_mode: str = "gates") -> int:
    """Estimated backward-residual footprint of the whole-sequence LSTM
    stack at T frames (after frame stacking) and batch B: per layer and
    step the wavefront keeps the activated gates, the carried c and the
    output in the residual dtype (6H values; dgates overwrite the gates);
    the layered path also keeps f32 layer inputs and outputs (8H bytes);
    recompute keeps 3H values.  The JAX package's count, whose wavefront
    premise, dW_x accumulated by the reverse pass, holds here from 10 GiB
    of residuals up (``lstm_wavefront.fuse_dwx_enabled``); below that the
    unfused pass's xdrop stream, (L-1)·T·B·H more values with dropout on,
    is left to the rest of the card (``RESIDUAL_SHARE``)."""
    H, L, rb = cfg.hidden_size, cfg.num_layers, _res_bytes(cfg)
    if residual_mode == "recompute":
        per_step_layer = B * 3 * H * rb
    elif cfg.wavefront and cfg.use_kernels:
        per_step_layer = B * H * rb * 6
    else:
        per_step_layer = B * (4 * H * rb + H * rb + 8 * H)
    return int(L * T * per_step_layer)


def _stacked_T(cfg: AcousticConfig, T: int) -> int:
    return -(-T // max(cfg.frame_stack, 1))


def training_memory_plan(cfg: AcousticConfig, T: int, B: int,
                         budget_bytes: Optional[int] = None,
                         device=None) -> Tuple[int, str]:
    """(time_chunk, residual_mode) for training at these shapes, in the JAX
    package's order of preference: whole-sequence gates residuals, then
    whole-sequence recompute residuals (kernel route), then chunked remat.
    ``budget_bytes`` defaults to ``default_residual_budget(device)``."""
    if budget_bytes is None:
        budget_bytes = default_residual_budget(device)
    Ts = _stacked_T(cfg, T)
    if training_residual_bytes(cfg, Ts, B) <= budget_bytes:
        return 0, "gates"
    if cfg.use_kernels and recompute_footprint(cfg, T, B) <= budget_bytes:
        return 0, "recompute"
    return auto_time_chunk(cfg, T, B, budget_bytes), "gates"


def recompute_footprint(cfg: AcousticConfig, T: int, B: int) -> int:
    """The plan's estimate for whole-sequence recompute residuals: the
    residuals plus one layer's dgates and the float32 dout and
    activation-copy streams next to them."""
    Ts = _stacked_T(cfg, T)
    rb, H = _res_bytes(cfg), cfg.hidden_size
    return (training_residual_bytes(cfg, Ts, B, "recompute")
            + Ts * B * 4 * H * rb + Ts * B * 4 * H)


def auto_time_chunk(cfg: AcousticConfig, T: int, B: int, budget_bytes: int) -> int:
    """0 when the whole-sequence residuals fit ``budget_bytes``, else the
    largest chunk of (1024, 512, 256, 128) whose chunked footprint fits
    (interior residuals, a chunk's f32 gate projection and dgates, f32
    input/output stacks, carried states per boundary), else 128."""
    T = _stacked_T(cfg, T)
    if training_residual_bytes(cfg, T, B) <= budget_bytes:
        return 0
    H, L, rb = cfg.hidden_size, cfg.num_layers, _res_bytes(cfg)
    per_step_layer = B * (4 * H * rb + H * rb + 8 * H)
    per_step_transient = B * 4 * H * (4 + rb)
    fixed = T * B * 8 * H
    for chunk in (1024, 512, 256, 128):
        if chunk >= T:
            continue
        boundaries = -(-T // chunk) * L * 2 * B * H * 4
        if (fixed + L * chunk * per_step_layer + chunk * per_step_transient
                + boundaries) <= budget_bytes:
            return chunk
    return 128
