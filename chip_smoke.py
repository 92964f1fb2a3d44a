#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``rnn_speech_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--phases device,build,kernels,train_kernels,eval,train,train_layered,alt_routes,train_wide,grad_study,bundle,beam,cli]
    python3 chip_smoke.py --phases device,build,lean_study   # opt-in, not in the default run
    python3 chip_smoke.py --phases device,build,persistent_study [--parent DIR]   # opt-in

Drives the port's serving path and its train step on a CUDA device and
fails (non-zero exit, no result line) on any failed check.  Phases, each
printing one JSON line:

  device   card name and power limit (nvidia-smi), torch/CUDA versions;
           asserts float32 matmuls run without TF32.
  build    compiles every CUDA kernel from ``rnn_speech_tpu_torch/csrc``
           (one nvcc per source, in parallel) and prints the build time and
           each kernel's register/spill report.
  kernels  holds each kernel against its plain PyTorch version on the card
           at the serving shape (L=3, H=1024, B=128, T=1024: 10.24 s clips),
           with ragged lengths and non-zero initial state, strictly at small
           T, by logit argmax at T=1024, and at B=1 (the wavefront on its
           persistent kernel, the plan's choice at B=128 and B=1: bit for
           bit on repeat at B=128, beside the launch without its counter
           waits; the per-diagonal kernel on the same inputs in every case,
           and at B=129, past the plan); the recurrence on its
           persistent kernel at B=128, T=1024 (the plan's choice, bit for
           bit on repeat, beside the launch without its step barrier) and
           past its plan (B=400, the per-step kernel); the fbank kernel against
           its plain version at B=128 on 10.24 s clips (22050 Hz) and at 16
           kHz with a short ragged row and an empty one, each beside a
           planted fault that must fail its check.
  eval     (the peak-memory counter reset first) random weights from a
           fixed torch.Generator, then fbank frontend
           -> 3x1024 bf16 forward -> greedy decode at B=128 on 10.24 s
           clips, through the wavefront kernel and through the layered
           recurrence kernel, and one clip (B=1, the ``--file`` batch)
           through the wavefront; launch counters are zeroed before this
           phase and must be non-zero after it, the recurrence's and the
           wavefront's persistent kernels' too (the wavefront's at B=128
           and at B=1).  Times the path's stages (frontend, forward,
           decode) on the stream, and each kernel at the path's shapes
           beside its bound, its plain version and torch.nn.LSTM (the
           wavefront in turns with cuDNN's 3-layer forward and with the
           per-diagonal kernel, at B=128, and with the per-diagonal kernel
           at B=1; the
           recurrence, one call of the three a layered batch makes, in
           turns with cuDNN's one-layer forward, at B=128 and at B=1).
  train_kernels
           holds the training kernels against their plain versions on the
           card at full width (L=3, H=1024, B=64): the training forward and
           the reverse diagonal in drop modes 0, 1 and 2 with ragged lengths
           (a zero-length row), non-zero h0/c0 and upstream dh/dc, strictly
           at T=16 and looser at T=512 and the train path's T=3510; both
           weight-gradient reductions at the full N = 224,640 rows (LSTM:
           D=H=1024, G=4096, on the Hopper tile: two operands, bit for bit
           on repeat, beside the last K stage left out and the two stacked
           A operands swapped, and one operand; projections: D=120,
           G=1024 and D=1024, G=80);
           the three CTC kernels at B=64, T=3510, U=600 with labels of 250,
           a zero-length input and a label longer than its input (loss,
           checkpoints, last row, gradient; the backward bit for bit on
           repeat, beside its label sums filed one step late); the dropout kernel at
           (3510, 64, 1024) in float32 and bf16 (bit for bit, and the kept
           fraction within 4 sigma of the keep); the Bernoulli mask kernel
           at (2, 3510, 64, 1024) bf16 (bit for bit, the kept fraction
           within 4 sigma); the alpha-stream pair at the CTC shape (the
           stream's rows at every block end equal to the checkpoint
           kernel's, bit for bit, and its last row; the stream backward's
           gradient within the CTC tolerance of the checkpoint backward's);
           the reverse diagonal with its fused dW_x at T=16 and 512, B=16
           and 96, drop modes 0 and 2 (dW_x per boundary, dgates, dh0 and
           dc0 against the plain version, and dgates, dh0, dc0 bit for bit
           against the unfused pass); the training forward on its
           persistent kernel at B=64 (the plan's choice: bit for bit on
           repeat in drop modes 0 and 2, mode 2 equal to mode 1 fed
           ``random_bits.wavefront_masks``, beside the launch without its
           counter waits) and at B=70, past its plan, on the per-diagonal
           kernel, which is also held against the same plain results as
           the persistent kernel at B=64 in all three drop modes and T;
           likewise the reverse diagonal on its persistent kernel at B=64
           (the existing checks, now on it; bit for bit on repeat in drop
           modes 0 and 2, mode 2's dgates, dh0, dc0 and xdrop equal to mode
           1 fed ``wavefront_masks``, beside the launch without its layer
           counter waits), the per-diagonal reverse diagonal against the
           same plain results in every drop mode and T, and at B=70
           through the plan; the fused pass's dgates, dh0 and dc0 are held
           against the per-diagonal kernel's unfused pass.
           Planted faults stand beside the checks and must fail them.
  train    ``train_step`` with the default StepConfig (keep probabilities
           0.8 / 0.5, the CTC kernels) at the flagship train shape (B=64
           clips of 35.1 s, T=3510 frames, labels of length 250, one
           microbatch, lr 3e-4, random weights from a fixed
           torch.Generator): 2 warm-up steps, then the median and spread of
           3 reps of 3 steps on the repeated batch, then one step split
           into its stages by the step's own marks (``rnn_speech_tpu_torch.
           stages``, CUDA events); the loss must be finite and the mean of
           the last 3 of the 12 steps below the first, and all seven
           training kernels' launch counters, zeroed before the phase,
           non-zero after it, dgates_weight_grads' on the Hopper tile and
           the training forward's and the reverse diagonal's persistent
           kernels' too.  Then ``eval_step`` with the CTC kernels
           (the loss-only kernel must launch; its loss within the CTC
           tolerance of the scan CTC's), and the previous configuration
           (keep probabilities 1, scan CTC) for 3 timed steps.  Prints ms
           per step, utterances/s, peak memory, the stage split, each
           training kernel's time at the path's shapes beside its bound, its
           plain version and one PyTorch call (the training forward in
           turns with cuDNN's 3-layer training forward, the reverse
           diagonal with cuDNN's 3-layer backward without weight gradients,
           with them beside, on one graph, and with the per-diagonal
           kernel; dgates_weight_grads in turns
           with its yardstick and beside the WMMA tile, with TFLOP/s and
           the card's clocks; each CTC kernel in turns with its own half of
           F.ctc_loss, the forward or the backward alone, the pair
           beside), and one step's gradients
           through the kernels at T=256 against the same route on the
           kernels' plain versions with the same seed words, beside a
           planted fault that must fail that gate (and, for the keep-1
           configuration, against the plain route).
  train_layered
           the layered training route (``ops/lstm_layer_train.py``): its
           four kernels against their plain versions at full width (H=D=
           1024, B=64; ragged lengths with a zero-length row, non-zero
           state and upstream dh/dc), strictly at T=16 and looser at T=512
           and 3510, each beside a planted fault that must fail its check
           (the gates-mode backward on its persistent kernel, the plan's
           choice at B=64: bit for bit on repeat, beside the launch without
           its step barrier; and at B=70, past its plan, on the per-step
           kernel; the gates-mode forward likewise on its persistent kernel
           at B=64 and at B=260 on the per-step kernel, the per-step kernel
           also at B=64 and every T, on the persistent kernel's inputs);
           the recompute backward also at its route's batch (B=400 on the
           H100, T=512) and at a chunk edge of its rebuild (T one step
           past a chunk, B=70), and its rebuild product alone at one chunk
           of that batch (relative Frobenius, bit for bit on repeat,
           beside the last K stage left out); the recompute forward on its
           persistent kernel at T=3510 and the route's two batches (B=400
           and 473 on the H100: bit for bit on repeat, beside the kernel
           with its step barrier left out);
           the default StepConfig with the wavefront off at B=64, T=3510
           (12 steps as in ``train``; the gates-mode kernels, dropout, CTC
           and weight-gradient kernels must launch and the wavefront
           kernels must not); the recompute route at the smallest batch
           (a multiple of 16) at which ``training_memory_plan`` answers
           (0, "recompute") on this card, 1 warm-up and 3 timed steps and
           one split by its marks, the plan's estimate beside the
           measured peak memory (the backward must launch its rebuild
           products, the forward its persistent kernel; the layered step's
           forward and backward their persistent kernels); each layered
           kernel's time at its route's shapes
           beside its bound, its plain version and torch.nn.LSTM (one
           layer; the forwards in turns with its forward, the
           backwards in turns with its backward without weight gradients,
           its backward with them beside), the recompute
           backward's rebuild products on the
           call's own operands (every chunk, TFLOP/s; one whole chunk
           also in turns with torch.mm of the same product); and one
           step's gradients at T=256 through the kernels against the
           same route on the plain versions for the layered gates route, recompute, remat and
           time_chunk=64, each beside a planted fault.
  alt_routes
           the switches of the JAX package's other training routes, one
           train step each at B=64, T=3510 (the default StepConfig, 1
           warm-up and 3 timed steps, one split by its marks, peak memory,
           a finite loss; counters zeroed before and read after):
           RST_WAVEFRONT_BWD=0 (the mask, wavefront-train and layered
           backward kernels launch, the reverse diagonal does not),
           RST_WAVEFRONT_SEED_DROP=0 (the mask kernel launches, both
           wavefront kernels run drop mode 1) and RST_CTC_ALPHA_STREAM=1
           (both stream kernels launch, the checkpoint backward does not);
           each route's gradients at T=256 through the kernels against the
           same route on the plain versions at 1e-3, beside a planted
           fault.  Then the eval path at B=128 with DeviceFrontend(
           use_kernel=True): throughput and the frontend stage against the
           matmul frontend's; and the four kernels' times beside their
           bounds, plain versions and one PyTorch call each.
  train_wide
           the default StepConfig at the widest batch the memory plan sends
           to gates residuals on this card (B=394 on the H100, T=3510), with
           the fused dW_x chosen by its switch alone (1 warm-up, 3 timed
           steps, one split by its marks, peak memory after a reset; the
           fused pass must launch, and _hgrad_only's weight_grad and the
           window products on the Hopper tile) and the fused kernel's time
           at that batch; the B=64 step with RST_WAVEFRONT_FUSE_DWX=1 against =0 in
           turns (off, on, on, off); one step's gradients at T=256 with the
           fused pass forced against the unfused route on the same seed
           words at 1e-3, beside a planted fault; the recompute step at the
           widest batch the plan sends to recompute residuals (B=473 on the
           H100; 1 warm-up, 2 timed, peak); the fused pass alone at B=96,
           T=3510 beside its bound, the unfused pass and its plain version;
           at both batches its window products alone in turns with torch.mm
           for the same dW_x on the same operands.
  grad_study
           that gradient check, gated the same way, at three seeds and at
           keep probabilities (1, 1), (0.8, 1), (1, 0.5) and (0.8, 0.5),
           per parameter tensor and for the cotangent that reaches the
           input projection: the readings that set its limit; and the
           recompute route's check and each alt route's (its switch set
           around it) at the same three seeds.
  bundle   the committed trained bundle transcribes 32 rendered held-out
           sentences (sigma=900 noise) on the wavefront and layered kernel
           paths and through the fbank kernel at CER <= 2%, and all equal
           the plain path's transcripts.
  beam     the AM-only beam search at width 16 on the committed bundle's
           logits of the 32 held-out clips on the card: CER <= 2%, best
           beams equal to the same function's on the CPU on the same
           logits, and the decode's time at B=1 (a ``--file`` clip) and at
           the eval batch (B=128, T=1024).
  cli      ``python -m rnn_speech_tpu_torch.cli --file`` on one rendered
           clip prints its text (the default beam width, 16).
  lean_study (opt-in: only where ``--phases`` names it)
           where the persistent lean forward's step goes: at B=400 and
           B=64, T=3510, its time a call, and at B=400 the per-step design
           (forced through ``lean_plan``) and the same launch without its
           step barrier (wrong results: the barrier's share).
  persistent_study (opt-in)
           the persistent gates-mode backward (B=64, T=3510) and the
           recurrence on the persistent forward (B=128 and B=1, T=1024)
           beside the per-step designs they replace (forced through their
           plans) and without their step barriers; where the backward's
           step goes (CTA 0's SM clock at four points of each pass); how
           many clusters of 1, 2, 4 and 8 CTAs of the backward's size the
           card co-schedules; the gates-mode forward (B=64, T=3510), the
           wavefront training forward (B=64, T=3510, drop mode 2), the
           wavefront inference forward (B=128 and B=1, T=1024) and the
           reverse diagonal (B=64, T=3510, drop mode 2) beside the per-step
           and per-diagonal kernels, without their waits, and where a step
           of each goes (SM-clock stamps);
           with ``--parent DIR`` (a checkout of the previous tree) the
           recompute forward's outputs at T=512, B=400 and 473, the
           inference recurrence's at B=128, T=1024 and the two training
           forwards' at B=64, T=512 there and here, which must be equal
           bit for bit.

Then it prints the ``kernels`` JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.  It needs one card and ``nvcc``; it
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join(ROOT, "trained_models", "english-syllables")

# Serving shape of the flagship model (10.24 s clips at 22050 Hz).
SR = 22050
SECONDS = 10.24
L, H, B, V = 3, 1024, 128, 80
# Train shape of the flagship model (bench.py's train program): B=64 clips
# of 3510 frames (35.1 s), labels of length 250 in a 600-wide buffer.
TRAIN_B, TRAIN_T, MAX_LABEL, LABEL_LEN, TRAIN_LR = 64, 3510, 600, 250, 3e-4
GRAD_T = 256            # frames of the kernel-route vs plain-route check
DEVICE = "cuda"         # the train phases' device (a name, for rehearsals)
# H100 SXM dense bf16 tensor rate and HBM3 bandwidth (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel against plain version.  Both round h to bf16 before the product
# and accumulate in float32; they differ in summation order (~1e-6
# relative), which now and then flips one bf16 rounding of an h element
# (a 2^-8 relative step) and then propagates.  Strict bound at T=16;
# looser over 1024 steps, where the logits' argmax must still agree.
TOL_SHORT = 2e-3
TOL_LONG = 5e-2
# The largest mean abs error of the inference recurrence's outputs at
# T=16 (B=128, H=1024) against the plain version: the persistent kernel
# 1.2e-5 (its own sums and transcendentals flip a few bf16 roundings of h),
# the same kernel fed bf16(x_proj) 3.5e-4 (NVIDIA H100 80GB HBM3); the
# limit lies between them, about 5x from each.
XPROJ_MEAN_TOL = 6e-5
ARGMAX_AGREE = 0.999
CER_LIMIT = 2.0          # percent; the bundle's recorded greedy CER is 0.06%
# Training kernels against their plain versions: per output, max abs
# error over the plain result's own largest magnitude (for outputs with
# the four gate blocks, per block over that block's).  The bf16 residuals
# and dgates differ by a rounding flip (2^-8 relative) that then
# propagates: strict at T=16, looser at T=512 and the path's T=3510.  The
# weight gradients sum 224,640 rows of bf16 products in float32 in
# another order.  Planted faults beside each check must fail it.  On the
# H100 (run F) the largest readings were 5.1e-3 at T=16, 6.0e-3 at
# T=3510 and 1.5e-4 for the weight gradients; the mildest planted fault
# (df x 0.9) read 9.8e-2.
TRAIN_TOL_SHORT, TRAIN_TOL_LONG, WGRAD_TOL = 8e-3, 1.2e-2, 5e-4
# One step's gradients through the kernels at T=256, relative Frobenius
# error per parameter tensor: against the same route with each kernel's
# plain version in its place (both keep bf16 residuals; the gate), and
# against the plain route, the time loop under autograd with float32
# residuals (a loose gate beside the reading).  The worst tensor is the
# input projection's W: its cotangent arrives rounded to bf16 (dx in the
# compute dtype, as the JAX package casts it), where the two routes'
# summation orders flip roundings (3.0e-3 to 3.6e-3 relative), and the
# reduction over the rows averages that down, less so once dropout masks
# the rows.  On the H100 (the grad_study phase, seeds 2, 5, 8): keep 1
# read 4.45e-4 to 4.65e-4, the default keeps 8.19e-4 to 8.54e-4, and the
# backward's inter-layer scale 1% too large (the planted fault) 1.97e-2.
# 1e-3 is the acceptance bound of the default step.  Against the time
# loop the keep-1 step read up to 3.9e-2 (the W_h gradients), the cost of
# bf16 residuals.
GRAD_REL_TOL, TIME_LOOP_TOL = 1e-3, 1e-1
# The recompute route's gate: its bf16 chain (activations between layers,
# the projected gates, dx) adds rounding points where the kernel and
# plain-version routes flip roundings apart.  On the H100 (the grad_study
# phase, seeds 2, 5, 8) it read 9.33e-4 to 9.69e-4 (the layered gates
# route 7.71e-4, time_chunk=64 8.58e-4), within 3% of 1e-3; 1.5e-3 leaves
# a margin of about 1.5x, and the planted fault (dgates 1% too large)
# read 2.87e-2.
RECOMPUTE_GRAD_TOL = 1.5e-3
# The recompute backward's rebuild product against its plain version:
# relative Frobenius error of the float32 activated gates.  Both sum the
# same bf16 products (K = D + H = 2048) in float32, in another order, and
# the activations' slopes are at most 1, so the error is a few float32
# ulps of each sum (~1e-7 relative); the planted fault (the last K stage of
# 64 left out) moves every gate by a 1/32 share of its sum.
REBUILD_TOL = 1e-5
# The CTC kernels against their plain versions (the same float32
# recursion; the posteriors of a label summed in another order): losses
# and alpha rows over their own largest magnitude, the gradient over its
# largest magnitude.  On the H100 the loss, checkpoints and last row were
# bit-equal and the gradient read 4.5e-7; the skip-transition fault read
# 8.7e-3.
CTC_LOSS_TOL, CTC_GRAD_TOL = 1e-5, 1e-5
# The layered route's gradient checks: the chunk of the time_chunk route.
LAYERED_CHUNK = 64
# Dropout keeps of the default step and the f32 peak for CUDA-core work.
INPUT_KEEP, OUTPUT_KEEP = 0.8, 0.5
PEAK_F32_FLOPS = 67e12
# Operations per live lattice state and time step (log_add3: 3 max, 3
# subtractions, 3 exp, 2 additions, 1 log, plus the log-prob): the alpha
# recursion; the backward rebuilds alpha, runs beta, forms the posterior
# (add, subtract, min, exp) and adds it to its label's sum.
CTC_ALPHA_OPS, CTC_BETA_POST_OPS = 13, 31
# The fbank kernel against its plain version: max abs error of the log-mel
# banks over their largest magnitude, the JAX package's own limit for its
# kernel (both sum the float32 DFT and mel products in another order).
FBANK_TOL = 2e-3

RECORD = {}


def emit(phase: str, **data) -> None:
    line = {"phase": phase, **data}
    RECORD[phase] = line
    print(json.dumps(line), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def smi_clocks() -> str:
    """The card's SM clock, power draw and power limit now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def in_turns(library, kernel, iters: int = 3, **more) -> dict:
    """Device ms of ``library`` and ``kernel`` on the same operands in turns
    (library, kernel, kernel, library), each beside the card's clock, power
    draw and limit read right after it: the mean of each pair and the turns.
    ``more`` names further yardsticks, timed in the same turns around the
    kernel (library, *more, kernel, kernel, *reversed(more), library) and
    returned as ``<name>_ms``."""
    order = [("library", library), *more.items()]
    turns = []
    for name, fn in order + [("kernel", kernel)] * 2 + order[::-1]:
        turns.append({"fn": name, "ms": cuda_ms(fn, iters=iters), "smi": smi_clocks()})
    mean = lambda name: sum(t["ms"] for t in turns if t["fn"] == name) / 2
    return {"ms": mean("kernel"), "turns": turns, **{f"{n}_ms": mean(n) for n, _ in order}}


def cuda_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- inputs

def stack_inputs(T, Bn, n_layers, lengths, seed):
    """Random stack inputs on the card: bf16 weights (xavier-uniform),
    xp0 ~ N(0, 0.5), biases, non-zero h0/c0, the (T, 1, B) length mask."""
    import torch

    g = torch.Generator().manual_seed(seed)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim)
    dev = "cuda"
    lens = torch.as_tensor(lengths)
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :]
    return dict(
        xp0=(torch.randn((T, Bn, 4 * H), generator=g) * 0.5).to(dev),
        w_h=w(n_layers, H, 4 * H).to(dev, torch.bfloat16),
        w_x_rest=w(max(n_layers - 1, 0), H, 4 * H).to(dev, torch.bfloat16),
        b_rest=(torch.randn((max(n_layers - 1, 0), 1, 4 * H), generator=g) * 0.1).to(dev),
        mask=mask.to(dev),
        h0=(torch.randn((n_layers, Bn, H), generator=g) * 0.2).to(dev),
        c0=(torch.randn((n_layers, Bn, H), generator=g) * 0.2).to(dev),
        w_out=w(H, V).to(dev),
        lengths=lens.to(dev),
    )


def run_wavefront(inp, fn):
    return fn(inp["xp0"], inp["w_h"], inp["w_x_rest"], inp["b_rest"],
              inp["mask"], inp["h0"], inp["c0"])


def run_recurrence(inp, fn):
    out, hn, cn = fn(inp["xp0"], inp["w_h"][0], inp["mask"], inp["h0"][0],
                     inp["c0"][0])
    return out, hn[None], cn[None]


def compare(name, got, ref, inp, tol):
    """Max abs errors of (out, hn, cn) and the logit argmax agreement on
    valid steps; fails above ``tol`` or below ARGMAX_AGREE."""
    import torch

    errs = [float((g - r).abs().max()) if g.numel() else 0.0
            for g, r in zip(got, ref)]
    valid = inp["mask"][:, 0].bool()
    la = torch.argmax(got[0] @ inp["w_out"], dim=-1)[valid]
    lb = torch.argmax(ref[0] @ inp["w_out"], dim=-1)[valid]
    agree = float((la == lb).float().mean()) if la.numel() else 1.0
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    entry = {"check": name, "err_out": errs[0], "err_hn": errs[1],
             "err_cn": errs[2], "tol": tol, "argmax_agree": agree,
             "finite": finite}
    if not finite or max(errs) > tol or agree < ARGMAX_AGREE:
        fail(f"{name}: kernel disagrees with its plain version: {entry}")
    return entry


# ----------------------------------------------------------------- phases

def phase_device():
    import torch

    smi = nvidia_smi_name_power()
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("torch.backends.cuda.matmul.allow_tf32 must be False: the "
             "frontend and the plain versions need full float32 matmuls")
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision())


def phase_build():
    from rnn_speech_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in reports.items()}
    emit("build", seconds=round(seconds, 3), built=sorted(reports),
         ptxas=ptxas)


def phase_kernels():
    import torch

    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    rng_lengths = lambda T, Bn, seed: [
        max(0, T - ((seed * 7919 + 31 * b) % (T // 2 + 1))) if b % 9 else T
        for b in range(Bn)
    ]
    checks = []
    cases = [
        ("wavefront L=3 B=128 T=16", "wf", 16, B, TOL_SHORT),
        ("recurrence B=128 T=16", "rec", 16, B, TOL_SHORT),
        ("wavefront L=3 B=128 T=1024", "wf", 1024, B, TOL_LONG),
        ("recurrence B=128 T=1024", "rec", 1024, B, TOL_LONG),
        ("wavefront L=3 B=1 T=1024", "wf", 1024, 1, TOL_LONG),
        ("recurrence B=1 T=1024", "rec", 1024, 1, TOL_LONG),
    ]
    worst = {"wf": 0.0, "rec": 0.0}
    for i, (name, kind, T, Bn, tol) in enumerate(cases):
        lens = rng_lengths(T, Bn, i)
        if Bn > 2:
            lens[2] = 0          # a zero-length row
        inp = stack_inputs(T, Bn, L if kind == "wf" else 1, lens, seed=10 + i)
        if kind == "wf":
            got = run_wavefront(inp, wf.lstm_stack_wavefront)
            ref = run_wavefront(inp, wf.lstm_stack_wavefront_plain)
        else:
            got = run_recurrence(inp, rec.lstm_recurrence)
            ref = run_recurrence(inp, rec.lstm_recurrence_plain)
        torch.cuda.synchronize()
        entry = compare(name, got, ref, inp, tol)
        if T == 1024 and Bn == B:
            worst[kind] = max(entry["err_out"], entry["err_hn"], entry["err_cn"])
        checks.append(entry)
        if kind == "wf":
            _wavefront_eval_checks(name, inp, got, ref, tol, checks)
        del got, ref, inp
    _wavefront_eval_past_plan_check(checks)
    _recurrence_persistent_checks(checks)
    worst["fbank"] = _fbank_checks(checks)
    emit("kernels", checks=checks, max_abs_err=worst)


def _wavefront_eval_checks(name, inp, got, ref, tol, checks):
    """The inference forward on its persistent kernel (row 1:
    csrc/lstm_wavefront_eval.cu), where ``got`` came from: the plan's
    choice at this batch, launched (counted at its library's launch site);
    at the serving batch bit for bit on repeat, beside the same launch
    without its counter waits (stale rings), which must leave ``tol``; and
    the per-diagonal kernel (csrc/lstm_wavefront.cu), launched past the
    plan on the same inputs, against the same plain result ``ref``."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    T, Bn = inp["xp0"].shape[:2]
    plan = wf.wavefront_eval_plan(Bn, H, L, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["kernel"] != "persistent":
        fail(f"{name}: the plan does not send this batch to the persistent kernel: {plan}")
    args = [inp[k] for k in ("xp0", "w_h", "w_x_rest", "b_rest", "mask", "h0", "c0")]
    if Bn == B:
        before = wf.lstm_stack_wavefront.persistent_launches
        again = run_wavefront(inp, wf.lstm_stack_wavefront)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        checks.append({"check": f"{name} persistent (grid {plan['grid']}, {plan['groups']} row "
                                "groups): bit for bit on repeat", "equal": same,
                       "persistent_launches": wf.lstm_stack_wavefront.persistent_launches - before})
        if checks[-1]["persistent_launches"] != 1:
            fail(f"{name}: the call did not launch the persistent kernel")
        if not same:
            fail(f"{name}: two calls on the same inputs differ")
        del again
        bad = wf._eval_persistent_launch(*args, plan, skip_waits=1)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(bad, ref))
        checks.append({"planted_fault": f"{name}: counter waits left out (stale rings)",
                       "max_abs_err": err, "tol": tol})
        if err <= tol:
            fail(f"{name}: the check does not see the planted fault ({err})")
        del bad
    old = wf._eval_per_diagonal_launch(*args)
    torch.cuda.synchronize()
    checks.append(compare(f"{name} per-diagonal kernel (launched past the plan)", old, ref, inp,
                          tol))


def _wavefront_eval_past_plan_check(checks):
    """The inference forward at B=129 (past two row groups) on the
    per-diagonal kernel, the plan's choice, against its plain version at
    T=16 (ragged lengths, a zero-length row): no persistent launch."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    T, Bn = 16, 2 * 64 + 1
    plan = wf.wavefront_eval_plan(Bn, H, L, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["kernel"] != "per_diagonal":
        fail(f"wavefront B={Bn}: expected the per-diagonal kernel past the plan, got {plan}")
    lens = [0 if b == 2 else (T - (31 * b) % (T // 2 + 1) if b % 9 else T) for b in range(Bn)]
    inp = stack_inputs(T, Bn, L, lens, seed=47)
    before = wf.lstm_stack_wavefront.persistent_launches
    got = run_wavefront(inp, wf.lstm_stack_wavefront)
    ref = run_wavefront(inp, wf.lstm_stack_wavefront_plain)
    torch.cuda.synchronize()
    entry = compare(f"wavefront L={L} B={Bn} T={T} past the plan (per-diagonal kernel)", got, ref,
                    inp, TOL_SHORT)
    entry["persistent_launches"] = wf.lstm_stack_wavefront.persistent_launches - before
    checks.append(entry)
    if entry["persistent_launches"]:
        fail(f"wavefront B={Bn}: ran the persistent kernel past its plan")


def _recurrence_persistent_checks(checks):
    """The inference recurrence on the persistent forward (row 2:
    csrc/lstm_layer_lean.cu on f32 x_proj) at the serving shape (B=128,
    T=1024, ragged lengths with a zero-length row): the plan's choice,
    launched (counted at its library's launch site), bit for bit on repeat,
    within TOL_LONG of the plain version, beside the same launch without
    its step barrier (stale h), which must leave that bound; and B=400,
    past the plan (four tiles a CTA leave no room for two stages beside the
    f32 x_proj buffers), on the per-step kernel within TOL_SHORT at T=16."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = lambda T, Bn: [0 if b == 2 else (T - (31 * b) % (T // 2 + 1) if b % 9 else T)
                             for b in range(Bn)]
    T = 1024
    inp = stack_inputs(T, B, 1, lengths(T, B), seed=40)
    plan = rec.lean_plan(B, H, sms, x_f32=True)
    tag = f"recurrence persistent B={B} T={T} (grid {plan.get('grid')})"
    if plan["kernel"] != "persistent":
        fail(f"{tag}: the plan does not send the serving shape to the persistent kernel: "
             f"{plan}")
    before = rec.lstm_recurrence.persistent_launches
    got = run_recurrence(inp, rec.lstm_recurrence)
    again = run_recurrence(inp, rec.lstm_recurrence)
    torch.cuda.synchronize()
    launched = rec.lstm_recurrence.persistent_launches - before
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    checks.append({"check": f"{tag}: bit for bit on repeat", "equal": same,
                   "persistent_launches": launched, "plan": plan})
    if launched != 2:
        fail(f"{tag}: {launched} persistent launches in two calls")
    if not same:
        fail(f"{tag}: two calls on the same inputs differ")
    ref = run_recurrence(inp, rec.lstm_recurrence_plain)
    checks.append(compare(tag, got, ref, inp, TOL_LONG))
    bad = rec._persistent_launch(inp["xp0"], inp["w_h"][0], inp["mask"], inp["h0"][0],
                                 inp["c0"][0], plan, skip_barrier=1)
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max()) for g, r in zip(bad, (ref[0], ref[1][0], ref[2][0])))
    checks.append({"planted_fault": f"{tag}: step barrier left out (stale h)",
                   "max_abs_err": err, "tol": TOL_LONG})
    if err <= TOL_LONG:
        fail(f"{tag}: the check does not see the planted fault ({err})")
    del inp, got, again, ref, bad
    _x_proj_precision_check(checks, lengths)
    Bn, T = 400, 16
    plan = rec.lean_plan(Bn, H, sms, x_f32=True)
    if plan["kernel"] != "per_step":
        fail(f"recurrence B={Bn}: expected the per-step kernel past the plan, got {plan}")
    inp = stack_inputs(T, Bn, 1, lengths(T, Bn), seed=41)
    before = rec.lstm_recurrence.persistent_launches
    got = run_recurrence(inp, rec.lstm_recurrence)
    ref = run_recurrence(inp, rec.lstm_recurrence_plain)
    torch.cuda.synchronize()
    entry = compare(f"recurrence B={Bn} T={T} past the plan (per-step kernel)", got, ref, inp,
                    TOL_SHORT)
    entry["persistent_launches"] = rec.lstm_recurrence.persistent_launches - before
    checks.append(entry)
    if entry["persistent_launches"]:
        fail(f"recurrence B={Bn}: ran the persistent kernel past its plan")


def _x_proj_precision_check(checks, lengths):
    """The TPU kernel adds x_proj in float32, so must the persistent
    recurrence: at B=128, T=16 (before the steps amplify a difference) the
    mean abs error of each output against the plain version stays within
    XPROJ_MEAN_TOL, beside the same kernel fed bf16(x_proj) (what a kernel
    that rounds x_proj computes), which must leave it.  The largest error
    cannot tell the two apart: a flipped bf16 rounding of h moves a few
    outputs as far as rounding x_proj moves many."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec

    T = 16
    inp = stack_inputs(T, B, 1, lengths(T, B), seed=42)
    ref = run_recurrence(inp, rec.lstm_recurrence_plain)
    got = run_recurrence(inp, rec.lstm_recurrence)
    bad = run_recurrence(dict(inp, xp0=inp["xp0"].to(torch.bfloat16).float()),
                         rec.lstm_recurrence)
    torch.cuda.synchronize()
    mean = lambda res: max(float((g - r).abs().mean()) for g, r in zip(res, ref))
    most = lambda res: max(float((g - r).abs().max()) for g, r in zip(res, ref))
    tag = f"recurrence persistent B={B} T={T}: x_proj added in float32"
    entry = {"check": tag, "mean_abs_err": mean(got), "max_abs_err": most(got),
             "tol": XPROJ_MEAN_TOL, "bf16_x_proj_mean_abs_err": mean(bad),
             "bf16_x_proj_max_abs_err": most(bad)}
    checks.append(entry)
    if entry["mean_abs_err"] > XPROJ_MEAN_TOL:
        fail(f"{tag}: {entry}")
    if entry["bf16_x_proj_mean_abs_err"] <= XPROJ_MEAN_TOL:
        fail(f"{tag}: the check does not see x_proj rounded to bf16: {entry}")


def _fbank_case(sr, lengths, seconds, seed):
    """(frontend, pre-emphasised padding-zeroed signals, frame count) of a
    batch of noisy tones at ``sr``: rows of ``lengths`` samples in a
    buffer of ``seconds``."""
    import torch

    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    n = int(sr * seconds)
    g = torch.Generator().manual_seed(seed)
    audio = torch.randn((len(lengths), n), generator=g) * 0.1
    audio += 0.3 * torch.sin(2 * torch.pi * 300.0 * torch.arange(n) / sr)[None]
    for i, m in enumerate(lengths):
        audio[i, m:] = 0.0
    fe = DeviceFrontend("fbank", sr=sr, max_samples=n, device=DEVICE)
    audio = audio.to(DEVICE)
    pre = torch.cat([audio[:, :1], audio[:, 1:] - 0.97 * audio[:, :-1]], dim=1)
    return fe, pre, fe._frames_for_width(n)


def _fbank_checks(checks):
    """The fbank kernel against its plain version at the eval shape (B=128,
    10.24 s at 22050 Hz) and at 16 kHz with a short ragged row and an empty
    one (whose banks must equal the plain version's eps floor exactly);
    beside them the plain version with the 1/n_fft left out (22050 Hz) and
    with frames 4 samples further apart (16 kHz) must fail."""
    import torch

    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk

    worst = 0.0
    n16 = int(16000 * SECONDS)
    for tag, sr, lengths, fault in (
            (f"B={B} 10.24 s at {SR} Hz", SR, [int(SR * SECONDS)] * B, "n_fft"),
            ("B=16 10.24 s at 16000 Hz, a 2000-sample row and an empty one", 16000,
             [n16] * 3 + [2000, 0] + [n16 - 997 * i for i in range(11)], "step")):
        fe, pre, n_frames = _fbank_case(sr, lengths, SECONDS, seed=sr)
        args = (fe._basis, fe._mel, fe.frame_step, n_frames, fe.n_fft)
        got = tfk.fbank_banks(pre, *args)
        ref = tfk.fbank_banks_plain(pre, *args)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        empty = [i for i, m in enumerate(lengths) if m == 0]
        entry = {"check": f"fbank {tag}", "max_abs_err": err, "rel_err": err / scale,
                 "tol": FBANK_TOL, "frames": n_frames,
                 "finite": bool(torch.isfinite(got).all()),
                 "empty_rows_exact": all(torch.equal(got[i], ref[i]) for i in empty)}
        checks.append(entry)
        if (not entry["finite"] or err / scale > FBANK_TOL or got.shape != ref.shape
                or not entry["empty_rows_exact"]):
            fail(f"fbank: kernel disagrees with its plain version: {entry}")
        worst = max(worst, err)
        if fault == "n_fft":
            faulty = tfk.fbank_banks_plain(pre, fe._basis, fe._mel * fe.n_fft, fe.frame_step,
                                           n_frames, fe.n_fft)
        else:
            faulty = tfk.fbank_banks_plain(pre, fe._basis, fe._mel, fe.frame_step + 4,
                                           n_frames, fe.n_fft)
        rel = float((faulty - ref).abs().max()) / scale
        checks.append({"planted_fault": f"fbank {tag}: " + (
            "1/n_fft left out" if fault == "n_fft" else "frames 4 samples further apart"),
            "rel_err": rel, "tol": FBANK_TOL})
        if rel <= FBANK_TOL:
            fail(f"fbank: the check does not see the planted fault ({rel})")
        del fe, pre, got, ref, faulty
    return worst


def _eval_setup(wavefront: bool):
    import numpy as np
    import torch

    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    n = int(SR * SECONDS)
    fe = DeviceFrontend("fbank", sr=SR, max_samples=n, device="cuda")
    cfg = acoustic.AcousticConfig(
        num_layers=L, hidden_size=H, input_dim=fe.feature_size, num_labels=V,
        compute_dtype=torch.bfloat16, use_kernels=True, wavefront=wavefront,
    )
    params = acoustic.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    rng = np.random.default_rng(0)
    audio = torch.as_tensor(rng.normal(0, 0.1, (B, n)).astype(np.float32),
                            device="cuda")
    lengths = torch.full((B,), n, dtype=torch.int32, device="cuda")
    return fe, cfg, params, audio, lengths


def _throughput(run, iters=3, reps=3):
    """(median utt/s, spread %, values) over ``reps`` timed runs of
    ``iters`` batches, each ending in a device synchronize."""
    import statistics

    import torch

    vals = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        vals.append(B * iters / (time.perf_counter() - t0))
    med = statistics.median(vals)
    return med, 100.0 * (max(vals) - min(vals)) / med, vals


def _stage_ms(params, cfg, fe, audio, lengths, iters=3):
    """Mean ms on the stream of the eval path's stages (``cli.infer``
    split at its calls), by CUDA events recorded between them."""
    import torch

    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops import decode

    names = ("frontend", "forward", "decode")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    sums = [0.0] * len(names)
    for _ in range(iters):
        ev[0].record()
        feats, nf = fe(audio, lengths)
        ev[1].record()
        states = acoustic.zero_state(cfg, B, device=audio.device)
        logits, _ = acoustic.forward(params, cfg, feats.transpose(0, 1), nf, states)
        ev[2].record()
        decode.greedy_decode(logits, acoustic.output_lengths(cfg, nf))
        ev[3].record()
        torch.cuda.synchronize()
        for i in range(len(names)):
            sums[i] += ev[i].elapsed_time(ev[i + 1])
    return {n: s / iters for n, s in zip(names, sums)}


def _nn_lstm(inp, n_layers, T, Bn=B):
    """One call of torch.nn.LSTM (cuDNN, bf16) with the kernels' weights on
    Bn full-length rows, a yardstick only.  Its gate order is (i, f, g, o),
    so the (i, g, f, o) columns are permuted and the +1 goes into the
    forget bias.  It also computes layer 0's input product (random W_x0),
    which the kernels take precomputed in xp0."""
    import torch

    m = torch.nn.LSTM(H, H, num_layers=n_layers).to("cuda", torch.bfloat16)
    perm = torch.cat([torch.arange(H) + k * H for k in (0, 2, 1, 3)]).cuda()
    with torch.no_grad():
        for l in range(n_layers):
            bias = torch.zeros(4 * H, device="cuda")
            if l > 0:
                getattr(m, f"weight_ih_l{l}").copy_(inp["w_x_rest"][l - 1].t()[perm])
                bias += inp["b_rest"][l - 1, 0]
            bias[2 * H:3 * H] += 1.0
            getattr(m, f"weight_hh_l{l}").copy_(inp["w_h"][l].t()[perm])
            getattr(m, f"bias_ih_l{l}").copy_(bias[perm])
            getattr(m, f"bias_hh_l{l}").zero_()
        x = torch.randn((T, Bn, H), device="cuda", dtype=torch.bfloat16)

    def call():
        with torch.no_grad():
            return m(x)

    return call


def _bounds(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_eval():
    import torch

    from rnn_speech_tpu_torch import cli
    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    results = {}
    # The peak memory below is this phase's own, not a high-water mark of
    # the phases before it.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec.lstm_recurrence.launches = rec.lstm_recurrence.persistent_launches = 0
    wf.lstm_stack_wavefront.launches = wf.lstm_stack_wavefront.persistent_launches = 0
    persistent_b1 = 0
    for wavefront in (True, False):
        fe, cfg, params, audio, lengths = _eval_setup(wavefront)
        with torch.no_grad():
            run = lambda: cli.infer(params, cfg, fe, audio, lengths)
            labels, lab_len = run()
            torch.cuda.synchronize()
            if labels.shape[0] != B or not bool((lab_len >= 0).all()):
                fail("eval: bad decode output")
            med, spread, vals = _throughput(run)
            stages = _stage_ms(params, cfg, fe, audio, lengths)
            if wavefront:                            # one clip, the ``--file`` batch
                before = wf.lstm_stack_wavefront.persistent_launches
                labels, lab_len = cli.infer(params, cfg, fe, audio[:1], lengths[:1])
                torch.cuda.synchronize()
                if labels.shape[0] != 1 or not bool((lab_len >= 0).all()):
                    fail("eval: bad decode output at B=1")
                persistent_b1 = wf.lstm_stack_wavefront.persistent_launches - before
        results["wavefront" if wavefront else "layered"] = {
            "utt_per_s": med, "spread_pct": spread, "values": vals,
            "stage_ms": stages,
        }
    # The eval path's own peak, read before the kernels are timed alone
    # below beside their plain versions and torch.nn.LSTM.
    peak = torch.cuda.max_memory_allocated()
    launches = {"lstm_wavefront": wf.lstm_stack_wavefront.launches,
                "lstm_wavefront_persistent": wf.lstm_stack_wavefront.persistent_launches
                - persistent_b1,
                "lstm_wavefront_persistent_b1": persistent_b1,
                "lstm_recurrence": rec.lstm_recurrence.launches,
                "lstm_recurrence_persistent": rec.lstm_recurrence.persistent_launches}
    if not all(launches.values()):
        fail(f"eval: the path did not go through every kernel: {launches}")

    # Each kernel alone at the path's shapes (full-length rows), and at
    # B=1, the ``--file`` batch, where the weights' reads dominate.  The
    # recurrence is one call (one layer; a layered eval batch makes L), in
    # turns with cuDNN's one-layer forward, which also does layer 0's input
    # product.
    T = fe._frames_for_width(int(SR * SECONDS))
    timing = {}
    per_diagonal = lambda x: lambda: wf._eval_per_diagonal_launch(*[x[k] for k in (
        "xp0", "w_h", "w_x_rest", "b_rest", "mask", "h0", "c0")])   # the design row 1 replaces
    with torch.no_grad():
        one = stack_inputs(T, 1, L, [T], seed=98)
        wf_b1 = in_turns(per_diagonal(one), lambda: run_wavefront(one, wf.lstm_stack_wavefront))
        b1_turns = in_turns(_nn_lstm(one, 1, T, 1),
                            lambda: run_recurrence(one, rec.lstm_recurrence))
        inp = stack_inputs(T, B, L, [T] * B, seed=99)
        wf_turns = in_turns(_nn_lstm(inp, L, T),
                            lambda: run_wavefront(inp, wf.lstm_stack_wavefront),
                            per_diagonal=per_diagonal(inp))
        plain = cuda_ms(lambda: run_wavefront(inp, wf.lstm_stack_wavefront_plain),
                        iters=1)
        flops = 2 * T * B * H * 4 * H * (2 * L - 1)
        nbytes = (T * B * 4 * H * 4 + (2 * L - 1) * H * 4 * H * 2
                  + (L - 1) * 4 * H * 4 + T * B * 4 + 4 * L * B * H * 4
                  + T * B * H * 4)
        bound, by = _bounds(flops, nbytes)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        timing["lstm_wavefront"] = dict(
            ms=wf_turns["ms"], plain_ms=plain, bound_ms=bound, bound_by=by,
            library_ms=wf_turns["library_ms"],
            library=f"torch.nn.LSTM forward ({L} layers, in turns)", turns=wf_turns["turns"],
            per_diagonal_ms=wf_turns["per_diagonal_ms"],
            us_per_diagonal=1e3 * wf_turns["ms"] / (T + L - 1),
            plan=wf.wavefront_eval_plan(B, H, L, sms), flops=flops, bytes=nbytes,
            ms_b1=wf_b1["ms"], per_diagonal_ms_b1=wf_b1["library_ms"], turns_b1=wf_b1["turns"],
            plan_b1=wf.wavefront_eval_plan(1, H, L, sms))
        turns = in_turns(_nn_lstm(inp, 1, T), lambda: run_recurrence(inp, rec.lstm_recurrence))
        plain = cuda_ms(lambda: run_recurrence(inp, rec.lstm_recurrence_plain),
                        iters=1)
        flops = 2 * T * B * H * 4 * H
        nbytes = (T * B * 4 * H * 4 + H * 4 * H * 2 + T * B * 4
                  + 4 * B * H * 4 + T * B * H * 4)
        bound, by = _bounds(flops, nbytes)
        timing["lstm_recurrence"] = dict(
            ms=turns["ms"], plain_ms=plain, bound_ms=bound, bound_by=by,
            library_ms=turns["library_ms"], library="torch.nn.LSTM forward (1 layer, in turns)",
            calls_per_batch=L, us_per_step=1e3 * turns["ms"] / T,
            tflops=flops / turns["ms"] / 1e9, turns=turns["turns"],
            plan=rec.lean_plan(B, H, sms, x_f32=True), flops=flops, bytes=nbytes,
            ms_b1=b1_turns["ms"], library_ms_b1=b1_turns["library_ms"],
            turns_b1=b1_turns["turns"])
    emit("eval", batch=B, seconds=SECONDS, frames=T, throughput=results,
         launches=launches, timing=timing, peak_memory_gib=peak / 2**30)


def _held_out(n_clips=32, noise=900.0):
    """The bundle's held-out sentences (the first of the seed-0 draw, which
    its training run kept out of training), rendered at 22050 Hz with
    sigma=900 noise and scaled to [-1, 1) as its accuracy run does."""
    import numpy as np

    from rnn_speech_tpu_torch import synth

    texts = synth.sample_sentences(n_clips, np.random.default_rng(0))
    render_rng = np.random.default_rng(1)
    noise_rng = np.random.default_rng([0, int(noise)])
    sigs = []
    for text in texts:
        clean = synth.render_syllables_clean(text, SR, render_rng)
        sigs.append(np.clip(clean + noise_rng.normal(0, noise, len(clean)),
                            -32000, 32000).astype(np.float32) / 32768.0)
    return texts, sigs


def _edit_distance(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def phase_bundle():
    """Greedy transcripts of the held-out clips on each route (the beam
    search has its own phase)."""
    import numpy as np
    import torch

    from rnn_speech_tpu_torch import cli, params as params_mod
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    params = params_mod.load_bundle(BUNDLE, device="cuda")
    texts, sigs = _held_out()
    width = max(len(s) for s in sigs)
    audio = np.zeros((len(sigs), width), np.float32)
    for i, s in enumerate(sigs):
        audio[i, : len(s)] = s
    lengths = np.asarray([len(s) for s in sigs], np.int32)
    truth = [t.lower() for t in texts]
    out = {}
    tfk.fbank_banks.launches = 0
    for name, kw, fbank_kernel in (
            ("wavefront", dict(use_kernels=True, wavefront=True), False),
            ("layered", dict(use_kernels=True, wavefront=False), False),
            ("fbank_kernel", dict(use_kernels=True, wavefront=True), True),
            ("plain", dict(use_kernels=False), False)):
        cfg = acoustic.config_for_params(params, compute_dtype=torch.bfloat16, **kw)
        frontend = (DeviceFrontend("fbank", sr=SR, max_samples=width, device="cuda",
                                   use_kernel=True) if fbank_kernel else None)
        with torch.no_grad():
            hyps = cli.transcribe(params, cfg, audio, lengths, frontend=frontend,
                                  device="cuda", beam_width=1)
        cers = [_edit_distance(t, h.strip()) / max(len(t), 1)
                for t, h in zip(truth, hyps)]
        out[name] = {"hyps": hyps, "cer_pct": 100.0 * float(np.mean(cers))}
    if not tfk.fbank_banks.launches:
        fail("bundle: the fbank kernel did not launch")
    for name in ("wavefront", "layered", "fbank_kernel"):
        if out[name]["cer_pct"] > CER_LIMIT:
            fail(f"bundle: {name} CER {out[name]['cer_pct']:.3f}% > {CER_LIMIT}%")
        if out[name]["hyps"] != out["plain"]["hyps"]:
            fail(f"bundle: {name} transcripts differ from the plain path's")
    exact = [i for i, (t, h) in enumerate(zip(truth, out["wavefront"]["hyps"]))
             if t == h]
    emit("bundle", clips=len(texts), truth=truth,
         cer_pct={k: v["cer_pct"] for k, v in out.items()},
         exact_clips=len(exact), hyps=out["wavefront"]["hyps"],
         fbank_kernel_launches=tfk.fbank_banks.launches)
    return texts, sigs, exact


def phase_cli(texts, sigs, exact):
    from rnn_speech_tpu_torch import audio_io

    if not exact:
        fail("cli: no clip was transcribed exactly in the bundle phase")
    i = exact[0]
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "clip.wav")
        audio_io.write_wav(wav, sigs[i], SR)
        ini = os.path.join(tmp, "smoke.ini")
        with open(ini, "w") as fh:
            fh.write(f"""[acoustic_network_params]
num_layers : 3
hidden_size : 1024
dropout_input_keep_prob : 0.9
dropout_output_keep_prob : 0.6
batch_size : 32
mini_batch_size : 1
learning_rate : 0.001
lr_decay_factor : 0.33
grad_clip : 5
rnn_state_reset_ratio : 1.0
signal_processing : fbank
language : english

[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : 100
steps_per_evaluation : 100
checkpoint_dir : {BUNDLE}

[training]
max_input_seq_length : 600
max_target_seq_length : 80

[logging]
log_level : WARNING

[tpu]
compute_dtype : bfloat16
use_pallas_lstm : True
wavefront : True
bucket_count : 8
""")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rnn_speech_tpu_torch.cli", "--file", wav,
             "--config", ini], cwd=ROOT, capture_output=True, text=True,
            timeout=600,
        )
        seconds = time.perf_counter() - t0
    printed = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    want = texts[i].lower()
    if proc.returncode != 0 or printed != want:
        fail(f"cli: rc={proc.returncode} printed={printed!r} want={want!r} "
             f"stderr={proc.stderr[-2000:]}")
    emit("cli", printed=printed, expected=want, seconds=round(seconds, 3))


# ------------------------------------------------------------ train phases

def _rel_errs(got, ref):
    """(max abs errors, relative errors) of each output pair: the error
    over the plain result's own largest magnitude, gate by gate for
    outputs whose last axis holds the four gate blocks (i, g, f, o), so a
    small gate's term is held to its own scale.  Outputs of three or more
    axes are read one leading index at a time, so a float32 copy of a
    full-length dgates (15 GiB at B=96) is never formed."""
    import torch

    errs, rels = [], []
    for g, r in zip(got, ref):
        if g.shape != r.shape:
            fail("bad shape or non-finite output")
        if not g.numel():
            errs.append(0.0)
            rels.append(0.0)
            continue
        n_blocks = 4 if r.shape[-1] == 4 * H else 1
        err, scale = [0.0] * n_blocks, [0.0] * n_blocks
        for gp, rp in zip(g.unbind(0), r.unbind(0)) if g.dim() > 2 else ((g, r),):
            for i, (gb, rb) in enumerate(zip(gp.chunk(n_blocks, -1), rp.chunk(n_blocks, -1))):
                gf, rf = gb.float(), rb.float()
                if not bool(torch.isfinite(gf).all()):
                    fail("bad shape or non-finite output")
                err[i] = max(err[i], float((gf - rf).abs().max()))
                scale[i] = max(scale[i], float(rf.abs().max()))
        errs.append(max(err))
        rels.append(max(e / s if s else (0.0 if e == 0 else float("inf"))
                        for e, s in zip(err, scale)))
    return errs, rels


def _rel_check(name, got, ref, tol, checks):
    """Fails when any relative error exceeds ``tol``; returns the largest
    absolute error."""
    errs, rels = _rel_errs(got, ref)
    entry = {"check": name, "max_abs_err": errs, "rel_err": rels, "tol": tol}
    checks.append(entry)
    if max(rels) > tol:
        fail(f"{name}: kernel disagrees with its plain version: {entry}")
    return max(errs)


def _fault_check(name, faulty, ref, tol, checks):
    """A fault planted in the plain version must fail the check at ``tol``."""
    _, rels = _rel_errs(faulty, ref)
    entry = {"planted_fault": name, "rel_err": rels, "tol": tol}
    checks.append(entry)
    if max(rels) <= tol:
        fail(f"{name}: the check does not see this planted fault: {entry}")


def _train_inputs(T, Bn, lengths, seed):
    """Full-width inputs of the training kernels on the card: bf16 x and
    xavier-uniform weights, f32 biases, non-zero h0/c0, the length mask."""
    import torch

    g = torch.Generator().manual_seed(seed)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim).to(DEVICE, torch.bfloat16)
    r = lambda *s, scale: (torch.randn(s, generator=g) * scale).to(DEVICE)
    lens = torch.as_tensor(lengths)
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :].to(DEVICE)
    return dict(x=r(T, Bn, H, scale=1.0).to(torch.bfloat16), w_x0=w(H, 4 * H),
                w_h=w(L, H, 4 * H), w_x_rest=w(L - 1, H, 4 * H),
                b_all=r(L, 4 * H, scale=0.1), mask=mask, h0=r(L, Bn, H, scale=0.2),
                c0=r(L, Bn, H, scale=0.2))


FWD_ARGS = ("x", "w_x0", "w_h", "w_x_rest", "b_all", "mask", "h0", "c0")
BWD_ARGS = ("dout_top", "w_h", "w_x_rest", "mask", "gates", "cseq", "c0", "dhn", "dcn")


def _bwd_inputs(inp, outs, gates, cseq, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    r = lambda *s: (torch.randn(s, generator=g) * 0.1).to(DEVICE)
    T, Bn = inp["x"].shape[:2]
    return dict(dout_top=r(T, Bn, H).to(torch.bfloat16), w_h=inp["w_h"],
                w_x_rest=inp["w_x_rest"], mask=inp["mask"], gates=gates, cseq=cseq,
                c0=inp["c0"], dhn=r(L, Bn, H), dcn=r(L, Bn, H))


KEEP_PROB = OUTPUT_KEEP * INPUT_KEEP      # one boundary's Bernoulli (ko·ki)


def _drop(mode, T, Bn, seed):
    """wavefront_train/_bwd drop arguments: mode 1 with random {0, 1}
    masks, mode 2 with two seed words."""
    import torch

    if mode == 1:
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        masks = (torch.rand((L - 1, T, Bn, H), generator=g, device=DEVICE)
                 < KEEP_PROB).to(torch.bfloat16)
        return (1, masks, 1.0 / KEEP_PROB, 1.0)
    return (2, (seed * 7919 + 1, seed * 104729 + 3), 1.0 / KEEP_PROB, KEEP_PROB)


def _per_diagonal_check(name, args, drop, ref, tol, checks):
    """The per-diagonal training forward (csrc/lstm_wavefront_train.cu, the
    wide step's kernel) launched past the plan on the inputs the plan sends
    to the persistent kernel, against the same plain result ``ref``;
    ``drop`` is ``_drop``'s tuple, or () for drop mode 0."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    mode, arr, scale, keep = drop or (0, None, 1.0, 1.0)
    T, Bn = args[0].shape[:2]
    launch = wf._drop_launch_args(mode, arr, keep, scale, (L - 1, T, Bn, H), args[0].device)
    got = wf._per_diagonal_launch(*args, (mode, *launch))
    torch.cuda.synchronize()
    _rel_check(f"{name} per-diagonal kernel (launched past the plan)", got, ref, tol, checks)


def _bwd_per_diagonal(args, drop, fuse_dwx=False):
    """The per-diagonal reverse diagonal (csrc/lstm_wavefront_bwd.cu, the
    fused pass's and the wide step's kernel) launched whatever the plan
    says: ``args`` are BWD_ARGS' values and outs (``gates`` is overwritten
    with dgates), ``drop`` is ``_drop``'s tuple, or () for drop mode 0."""
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    mode, arr, scale, keep = drop or (0, None, 1.0, 1.0)
    T, Bn = args[0].shape[:2]
    launch = wf._drop_launch_args(mode, arr, keep, scale, (L - 1, T, Bn, H), args[4].device)
    return wf._bwd_per_diagonal_launch(*args, (mode, *launch), fuse_dwx)


def _bwd_per_diagonal_check(name, args, drop, ref, tol, checks):
    """The per-diagonal reverse diagonal launched past the plan on the
    inputs the plan sends to the persistent kernel, against the same plain
    result ``ref``."""
    import torch

    got = _bwd_per_diagonal(args, drop)
    torch.cuda.synchronize()
    _rel_check(f"{name} per-diagonal kernel (launched past the plan)", got, ref, tol, checks)


def _wavefront_bwd_persistent_checks(b_in, outs, drop, ref, tag, tol, checks):
    """The reverse diagonal on its persistent kernel (row 4:
    csrc/lstm_wavefront_bwd_persistent.cu) at the default step's batch, on
    ``_drop_mode_checks``' drop-mode-2 inputs ``b_in`` (and ``outs``) and
    plain result ``ref``: the plan's choice, launched (counted at its
    library's launch site), bit for bit on repeat in drop modes 0 and 2,
    its mode-2 results (dgates, dh0, dc0, xdrop) equal to the same
    kernel's in mode 1 fed ``random_bits.wavefront_masks`` of the same seed
    words, beside the same launch without its layer counter waits (dgates
    read before they are written), which must fail ``tol`` against
    ``ref``."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf
    from rnn_speech_tpu_torch.ops import random_bits

    T, Bn = outs.shape[1:3]
    plan = wf.wavefront_bwd_plan(Bn, H, L, False,
                                 torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["kernel"] != "persistent":
        fail(f"wavefront_bwd {tag}: the plan does not send the default step's batch to the "
             f"persistent kernel: {plan}")
    kargs = lambda: [b_in[k].clone() if k == "gates" else b_in[k] for k in BWD_ARGS] + [outs]
    before = wf.wavefront_bwd.persistent_launches
    for mode, d in ((0, ()), (2, drop)):
        got, again = wf.wavefront_bwd(*kargs(), *d), wf.wavefront_bwd(*kargs(), *d)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        checks.append({"check": f"wavefront_bwd mode {mode} {tag} persistent (grid "
                                f"{plan['grid']}): bit for bit on repeat", "equal": same})
        if not same:
            fail(f"wavefront_bwd mode {mode} {tag}: two calls on the same inputs differ")
        del again
        if mode == 2:
            masks = random_bits.wavefront_masks(drop[1], L - 1, T, Bn, H, KEEP_PROB, DEVICE)
            fed = wf.wavefront_bwd(*kargs(), 1, masks, drop[2], 1.0)
            torch.cuda.synchronize()
            same = len(got) == len(fed) == 4 and all(torch.equal(a, b) for a, b in zip(got, fed))
            checks.append({"check": f"wavefront_bwd {tag} persistent: mode 2 (dgates, dh0, dc0, "
                                    "xdrop) equal to mode 1 fed wavefront_masks", "equal": same})
            if not same:
                fail(f"wavefront_bwd {tag}: mode 2 differs from mode 1 fed its bits")
            del masks, fed
        del got
    launched = wf.wavefront_bwd.persistent_launches - before
    if launched != 5:
        fail(f"wavefront_bwd {tag}: {launched} persistent launches in five calls")
    launch = wf._drop_launch_args(2, drop[1], drop[3], drop[2], None, None)
    bad = wf._bwd_persistent_launch(*kargs(), (2, *launch), plan, skip_waits=1)
    torch.cuda.synchronize()
    _fault_check(f"wavefront_bwd {tag}: layer counter waits left out (dgates read before "
                 "they are written)", bad, ref, tol, checks)
    del bad


def _drop_mode_checks(inp, tag, tol, checks, worst, seed):
    """Both wavefront kernels in drop modes 1 and 2 against their plain
    versions, with the backward's xdrop streams, each on the plan's kernel
    and on the per-diagonal one (and in mode 2 the reverse diagonal's
    persistent checks, ``_wavefront_bwd_persistent_checks``); beside mode 2,
    the plain backward fed the neighbouring boundary's bits (boundary l+1's
    instead of l's) must fail the check."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf
    from rnn_speech_tpu_torch.ops import random_bits

    bf = torch.bfloat16
    args = [inp[k] for k in FWD_ARGS]
    T, Bn = inp["x"].shape[:2]
    for mode in (1, 2):
        drop = _drop(mode, T, Bn, seed)
        got = wf.wavefront_train(*args, bf, *drop)
        ref = wf.wavefront_train_plain(*args, bf, *drop)
        torch.cuda.synchronize()
        worst["wavefront_train"] = max(worst["wavefront_train"], _rel_check(
            f"wavefront_train mode {mode} {tag}", got, ref, tol, checks))
        del got
        _per_diagonal_check(f"wavefront_train mode {mode} {tag}", args, drop, ref, tol, checks)
        b_in = _bwd_inputs(inp, *ref[:3], seed=seed + mode)
        plain_args = lambda: [b_in[k].clone() for k in BWD_ARGS] + [ref[0]]
        ref_b = wf.wavefront_bwd_plain(*plain_args(), *drop)
        if mode == 2:
            masks = random_bits.wavefront_masks(drop[1], L - 1, T, Bn, H, KEEP_PROB,
                                                DEVICE)
            _fault_check(f"wavefront_bwd mode 2 {tag}: boundary l+1's bits for l's",
                         wf.wavefront_bwd_plain(*plain_args(), 1, masks.roll(1, 0),
                                                drop[2], 1.0), ref_b, tol, checks)
            del masks
        _bwd_per_diagonal_check(f"wavefront_bwd mode {mode} {tag}", plain_args(), drop, ref_b,
                                tol, checks)
        if mode == 2:
            _wavefront_bwd_persistent_checks(b_in, ref[0], drop, ref_b, tag, tol, checks)
        got_b = wf.wavefront_bwd(*[b_in[k] for k in BWD_ARGS], ref[0], *drop)
        torch.cuda.synchronize()
        worst["wavefront_bwd"] = max(worst["wavefront_bwd"], _rel_check(
            f"wavefront_bwd mode {mode} {tag}", got_b, ref_b, tol, checks))
        del ref, ref_b, got_b, b_in


def _wavefront_persistent_checks(inp, tag, tol, checks, worst, seed):
    """The training forward on its persistent kernel (row 3:
    csrc/lstm_wavefront_persistent.cu) at the default step's batch: the
    plan's choice, launched (counted at its library's launch site), bit for
    bit on repeat in drop modes 0 and 2, beside the same launch without its
    counter waits (stale rings), which must fail ``tol`` against the plain
    result; and its mode-2 residuals equal to the same kernel's in mode 1
    fed ``random_bits.wavefront_masks`` of the same seed words (the bits the
    backward regenerates)."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf
    from rnn_speech_tpu_torch.ops import random_bits

    bf = torch.bfloat16
    args = [inp[k] for k in FWD_ARGS]
    T, Bn = inp["x"].shape[:2]
    plan = wf.wavefront_plan(Bn, H, L, H, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["kernel"] != "persistent":
        fail(f"wavefront_train {tag}: the plan does not send the default step's batch to the "
             f"persistent kernel: {plan}")
    before = wf.wavefront_train.persistent_launches
    drop = _drop(2, T, Bn, seed)
    for mode, d in ((0, ()), (2, drop)):
        got, again = wf.wavefront_train(*args, bf, *d), wf.wavefront_train(*args, bf, *d)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        checks.append({"check": f"wavefront_train mode {mode} {tag} persistent (grid "
                                f"{plan['grid']}): bit for bit on repeat", "equal": same})
        if not same:
            fail(f"wavefront_train mode {mode} {tag}: two calls on the same inputs differ")
        del again
        if mode == 2:
            masks = random_bits.wavefront_masks(drop[1], L - 1, T, Bn, H, KEEP_PROB, DEVICE)
            fed = wf.wavefront_train(*args, bf, 1, masks, drop[2], 1.0)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, fed))
            checks.append({"check": f"wavefront_train {tag} persistent: mode 2 equal to mode 1 "
                                    "fed wavefront_masks", "equal": same})
            if not same:
                fail(f"wavefront_train {tag}: mode 2 differs from mode 1 fed its bits")
            del masks, fed
        del got
    launched = wf.wavefront_train.persistent_launches - before
    if launched != 5:
        fail(f"wavefront_train {tag}: {launched} persistent launches in five calls")
    ref = wf.wavefront_train_plain(*args, bf)
    bad = wf._persistent_launch(*args, (0, None, 0, 0, 0, 1.0), plan, skip_waits=1)
    torch.cuda.synchronize()
    _fault_check(f"wavefront_train {tag}: counter waits left out (stale rings)", bad, ref, tol,
                 checks)
    del ref, bad


def _wavefront_past_plan_check(checks, worst):
    """The training forward at B=70 (past one 64-row tile) on the
    per-diagonal kernel, the plan's choice, against its plain version at
    T=16 in drop modes 0 and 2 (ragged lengths, a zero-length row): no
    persistent launch."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    bf, T, Bn = torch.bfloat16, 16, 70
    plan = wf.wavefront_plan(Bn, H, L, H, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["kernel"] != "per_diagonal":
        fail(f"wavefront_train B={Bn}: expected the per-diagonal kernel past the plan, got {plan}")
    lens = [0 if b == 2 else (T - (31 * b) % (T // 2 + 1) if b % 9 else T) for b in range(Bn)]
    inp = _train_inputs(T, Bn, lens, seed=48)
    args = [inp[k] for k in FWD_ARGS]
    before, before_b = wf.wavefront_train.persistent_launches, wf.wavefront_bwd.persistent_launches
    if wf.wavefront_bwd_plan(Bn, H, L)["kernel"] != "per_diagonal":
        fail(f"wavefront_bwd B={Bn}: expected the per-diagonal kernel past the plan")
    for mode, d in ((0, ()), (2, _drop(2, T, Bn, 49))):
        got = wf.wavefront_train(*args, bf, *d)
        ref = wf.wavefront_train_plain(*args, bf, *d)
        torch.cuda.synchronize()
        worst["wavefront_train"] = max(worst["wavefront_train"], _rel_check(
            f"wavefront_train mode {mode} L={L} B={Bn} T={T} past the plan (per-diagonal "
            "kernel)", got, ref, TRAIN_TOL_SHORT, checks))
        b_in = _bwd_inputs(inp, *ref[:3], seed=50)
        bargs = [b_in[k] for k in BWD_ARGS] + [ref[0], *d]
        ref_b = wf.wavefront_bwd_plain(*[a.clone() if i == 4 else a for i, a in enumerate(bargs)])
        got_b = wf.wavefront_bwd(*bargs)
        torch.cuda.synchronize()
        _rel_check(f"wavefront_bwd mode {mode} L={L} B={Bn} T={T} past the plan (per-diagonal "
                   "kernel)", got_b, ref_b, TRAIN_TOL_SHORT, checks)
    if wf.wavefront_train.persistent_launches != before:
        fail(f"wavefront_train B={Bn}: ran the persistent kernel past its plan")
    if wf.wavefront_bwd.persistent_launches != before_b:
        fail(f"wavefront_bwd B={Bn}: ran the persistent kernel past its plan")


FUSED_CHECK_B = (16, 96)   # batches of the fused dW_x's checks (on from B=83 at T=3510)


def _fused_checks(checks, worst):
    """The reverse diagonal with its fused dW_x (drop modes 0 and 2, L=3)
    against its plain version at T=16 and 512, B=16 and 96, and at the
    main path's T=TRAIN_T (full windows and a ragged last one), B=96;
    ragged lengths with a zero-length row: dW_x per boundary, dgates, dh0
    and dc0, each over its own largest magnitude; and the fused pass's
    dgates, dh0 and dc0 bit for bit against the unfused pass's.  Beside
    mode 0 the plain dW_x with the steps of one window (the last W) left
    out, beside mode 2 the plain dW_x with keep·scale left out, must fail
    the check."""
    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    bf = torch.bfloat16
    split = lambda r: (*r[:3], *r[3].unbind(0))      # dW_x per boundary
    for T, tol, batches in ((16, TRAIN_TOL_SHORT, FUSED_CHECK_B),
                            (512, TRAIN_TOL_LONG, FUSED_CHECK_B),
                            (TRAIN_T, TRAIN_TOL_LONG, FUSED_CHECK_B[-1:])):
        for Bn in batches:
            lens = [max(0, T - (31 * b) % (T // 2 + 1)) if b % 9 else T for b in range(Bn)]
            lens[2] = 0
            inp = _train_inputs(T, Bn, lens, seed=140 + T + Bn)
            for mode in (0, 2):
                drop = (0, None, 1.0, 1.0) if mode == 0 else _drop(2, T, Bn, seed=T + Bn)
                outs, gates, cseq, _, _ = wf.wavefront_train(*[inp[k] for k in FWD_ARGS], bf,
                                                             *drop)
                b_in = _bwd_inputs(inp, outs, gates, cseq, seed=150 + T + Bn + mode)
                args = lambda: [b_in[k].clone() for k in BWD_ARGS] + [outs, *drop]
                ref = wf.wavefront_bwd_plain(*args(), fuse_dwx=True)
                got = wf.wavefront_bwd(*args(), fuse_dwx=True)
                unfused = _bwd_per_diagonal(args()[:10], drop)   # the same kernel, unfused
                torch.cuda.synchronize()
                tag = f"wavefront_bwd fused dW_x mode {mode} L={L} B={Bn} T={T}"
                same = all(torch.equal(a, b) for a, b in zip(got[:3], unfused[:3]))
                del unfused
                checks.append({"check": f"{tag}: dgates, dh0, dc0 of the unfused pass",
                               "bit_equal": same})
                if not same:
                    fail(f"{tag}: dgates, dh0 or dc0 differ from the unfused pass's")
                worst["wavefront_bwd_fused"] = max(worst["wavefront_bwd_fused"], _rel_check(
                    tag, split(got), split(ref), tol, checks))
                if mode == 0:
                    w = min(wf.FUSE_DWX_WINDOW, T)
                    name = f"the last {w} steps left out"
                    faulty = ref[3] - torch.stack([
                        gm.weight_grad_plain(outs[l, T - w:], ref[0][l + 1, T - w:])[0]
                        for l in range(L - 1)])
                else:
                    name = "keep·scale left out"
                    faulty = torch.stack([gm.weight_grad_plain(outs[l], ref[0][l + 1])[0]
                                          for l in range(L - 1)])
                _fault_check(f"{tag}: {name}", split((*ref[:3], faulty)), split(ref), tol,
                             checks)
                del outs, gates, cseq, b_in, ref, got, faulty
            del inp


def _ctc_batch(seed):
    """The CTC kernels' inputs at the train shape: (T, B, V) logits, input
    lengths ragged with a zero-length row and a row shorter than its
    label, labels of LABEL_LEN in a MAX_LABEL-wide buffer."""
    import torch

    g = torch.Generator().manual_seed(seed)
    T, Bn = TRAIN_T, TRAIN_B
    logits = (torch.randn((T, Bn, V), generator=g) * 2.0).to(DEVICE)
    ll = torch.as_tensor([T - (37 * b) % (T // 2) if b % 5 else T for b in range(Bn)])
    ll[3] = 0                                    # a zero-length input
    ll[5] = LABEL_LEN - 1                        # label longer than its input
    labels = torch.randint(0, V - 1, (Bn, MAX_LABEL), generator=g)
    labels[:, LABEL_LEN:] = -1
    ul = torch.full((Bn,), LABEL_LEN)
    return logits, ll.to(DEVICE), labels.to(DEVICE), ul.to(DEVICE)


def _ctc_rel(got, ref):
    """Error over the reference's largest magnitude, on the entries that
    are not the -1e30 sentinel (which must match exactly)."""
    import torch

    live = ref > -1e29
    if not torch.equal(live, got > -1e29):
        return float("inf")
    d = (got - ref)[live].abs().max() if bool(live.any()) else got.new_zeros(())
    scale = ref[live].abs().max() if bool(live.any()) else got.new_ones(())
    return float(d / scale)


def _ctc_checks(checks):
    """The three CTC kernels against their plain versions at the train
    shape; the plain recursion without its skip transition must fail."""
    import torch

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck

    logits, ll, labels, ul = _ctc_batch(81)
    log_probs, ext, skip_ok, ll, ul, valid = tck._setup(logits, ll, labels, ul, -1)
    S = ext.shape[1]
    K = tck.ctc_block(S, V)
    ck, last = tck.ctc_alpha_ckpt(log_probs, ext, skip_ok, ll, ul, K)
    last_l = tck.ctc_alpha_lossonly(log_probs, ext, skip_ok, ll, ul)
    ck_p, last_p = tck.alpha_plain(log_probs, ext, skip_ok, ll, ul, K, True)
    loss, _ = tck._loss(last, ul, valid)
    loss_l, _ = tck._loss(last_l, ul, valid)
    loss_p, logp_p = tck._loss(last_p, ul, valid)
    ones = torch.ones_like(loss)
    lists = tck.label_lists(ext, ul, V)
    post = tck.ctc_beta_post(log_probs, ext, skip_ok, ll, ul, logp_p, ck_p, K, lists)
    again = tck.ctc_beta_post(log_probs, ext, skip_ok, ll, ul, logp_p, ck_p, K, lists)
    post_p = tck.beta_post_plain(log_probs, ext, skip_ok, ll, ul, logp_p, ck_p, K)
    grad = tck.ctc_grad(log_probs, post, ll, valid, ones)
    grad_p = tck.ctc_grad(log_probs, post_p, ll, valid, ones)
    torch.cuda.synchronize()
    rels = {"loss": _ctc_rel(loss, loss_p), "ckpts": _ctc_rel(ck, ck_p),
            "last": _ctc_rel(last, last_p), "lossonly_loss": _ctc_rel(loss_l, loss_p),
            "lossonly_last": _ctc_rel(last_l, last_p), "grad": _ctc_rel(grad, grad_p)}
    tols = {k: CTC_GRAD_TOL if k == "grad" else CTC_LOSS_TOL for k in rels}
    entry = {"check": f"ctc B={TRAIN_B} T={TRAIN_T} U={MAX_LABEL} labels {LABEL_LEN} K={K}",
             "rel_err": rels, "tol": tols, "lossonly_equals_ckpt_last": torch.equal(last_l, last),
             "max_abs_err": {"loss": float((loss - loss_p).abs().max()),
                             "lossonly_loss": float((loss_l - loss_p).abs().max()),
                             "grad": float((grad - grad_p).abs().max())},
             "zero_length_loss": float(loss[3]), "label_too_long_loss": float(loss[5]),
             "grad_finite": bool(torch.isfinite(grad).all()),
             "beta_post_bit_equal_on_repeat": torch.equal(post, again)}
    checks.append(entry)
    if (any(rels[k] > tols[k] for k in rels) or not entry["lossonly_equals_ckpt_last"]
            or not entry["grad_finite"] or loss[3] != 0 or loss[5] != 0
            or not entry["beta_post_bit_equal_on_repeat"]):
        fail(f"ctc: kernels disagree with their plain versions: {entry}")
    # The backward sums a step's labels one tick after the step: the sums
    # filed one step late must fail the gradient check.
    late = _ctc_rel(tck.ctc_grad(log_probs, post_p.roll(1, 0), ll, valid, ones), grad_p)
    checks.append({"planted_fault": "ctc backward: label sums one step late",
                   "rel_err": late, "tol": CTC_GRAD_TOL})
    if late <= CTC_GRAD_TOL:
        fail(f"ctc: the check does not see the label sums one step late ({late})")
    del ck, ck_p, post, post_p, grad, grad_p, again
    _, last_f = tck.alpha_plain(log_probs, ext, torch.zeros_like(skip_ok), ll, ul, K, False)
    rel = _ctc_rel(tck._loss(last_f, ul, valid)[0], loss_p)
    checks.append({"planted_fault": "ctc: skip transition dropped", "rel_err": rel,
                   "tol": CTC_LOSS_TOL})
    if rel <= CTC_LOSS_TOL:
        fail(f"ctc: the check does not see the dropped skip transition ({rel})")
    worst = entry["max_abs_err"]
    return {"ctc_alpha_ckpt": worst["loss"], "ctc_alpha_lossonly": worst["lossonly_loss"],
            "ctc_beta_post": worst["grad"]}


def _dropout_checks(checks):
    """The dropout kernel at the top site's (3510, 64, 1024) in float32
    (keep 0.8, the input site's) and bf16 (keep 0.5, the top site's): bit
    for bit against its plain version, the kept fraction within 4 sigma;
    the plain version scaled by 1 instead of 1/keep must fail."""
    import torch

    from rnn_speech_tpu_torch.ops import dropout as tdrop

    g = torch.Generator(device=DEVICE).manual_seed(90)
    errs = []
    for dtype, keep in ((torch.float32, INPUT_KEEP), (torch.bfloat16, OUTPUT_KEEP)):
        x = torch.randn((TRAIN_T, TRAIN_B, H), generator=g, device=DEVICE).to(dtype)
        seed = (2024, 1017)
        got = tdrop.dropout_kernel(x, seed, [keep])
        ref = tdrop.dropout_plain(x, seed, [keep])
        torch.cuda.synchronize()
        n = x.numel()
        frac = float((ref != 0).float().mean())
        sigma = (keep * (1 - keep) / n) ** 0.5
        equal = torch.equal(got, ref)
        entry = {"check": f"dropout {tuple(x.shape)} {str(dtype)[6:]} keep {keep}",
                 "bit_equal": equal, "kept_fraction": frac, "sigmas": (frac - keep) / sigma,
                 "max_abs_err": float((got.float() - ref.float()).abs().max())}
        checks.append(entry)
        errs.append(entry["max_abs_err"])
        if not equal or abs(frac - keep) > 4 * sigma:
            fail(f"dropout: kernel disagrees with its plain version: {entry}")
        faulty = torch.where(ref != 0, x, torch.zeros((), dtype=dtype, device=DEVICE))
        seen = not torch.equal(faulty, ref)
        checks.append({"planted_fault": f"dropout {str(dtype)[6:]}: scaled by 1",
                       "bit_equal": not seen})
        if not seen:
            fail("dropout: the check does not see a scale of 1")
        del x, got, ref, faulty
    return max(errs)


def phase_train_kernels():
    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    checks = []
    worst = {"wavefront_train": 0.0, "wavefront_bwd": 0.0, "wavefront_bwd_fused": 0.0,
             "dgates_weight_grads": 0.0, "weight_grad": 0.0}
    bf = torch.bfloat16
    f_cols = slice(2 * H, 3 * H)                     # the forget gate's block
    cases = ((16, TRAIN_TOL_SHORT), (512, TRAIN_TOL_LONG), (TRAIN_T, TRAIN_TOL_LONG))
    for i, (T, tol) in enumerate(cases):
        lens = [max(0, T - (31 * b) % (T // 2 + 1)) if b % 9 else T
                for b in range(TRAIN_B)]
        lens[2] = 0                                  # a zero-length row
        inp = _train_inputs(T, TRAIN_B, lens, seed=40 + i)
        tag = f"L={L} B={TRAIN_B} T={T}"
        args = [inp[k] for k in FWD_ARGS]
        got = wf.wavefront_train(*args, bf)
        ref = wf.wavefront_train_plain(*args, bf)
        torch.cuda.synchronize()
        worst["wavefront_train"] = max(worst["wavefront_train"], _rel_check(
            f"wavefront_train {tag}", got, ref, tol, checks))
        del got
        _per_diagonal_check(f"wavefront_train {tag}", args, (), ref, tol, checks)
        b_nof = inp["b_all"].clone()
        b_nof[:, f_cols] -= 1.0                      # the forget gate's +1 left out
        _fault_check(f"wavefront_train {tag}: forget-gate +1 left out",
                     wf.wavefront_train_plain(*[b_nof if k == "b_all" else inp[k]
                                                for k in FWD_ARGS], bf), ref, tol, checks)
        b_in = _bwd_inputs(inp, *ref[:3], seed=50 + i)
        plain_args = lambda **kw: [kw.get(k, b_in[k]).clone() for k in BWD_ARGS]
        ref_b = wf.wavefront_bwd_plain(*plain_args())
        _fault_check(f"wavefront_bwd {tag}: dh carry dgates·W_hᵀ dropped",
                     wf.wavefront_bwd_plain(*plain_args(w_h=torch.zeros_like(inp["w_h"]))),
                     ref_b, tol, checks)
        scaled = ref_b[0].clone()
        scaled[..., f_cols] *= 0.9
        _fault_check(f"wavefront_bwd {tag}: df scaled by 0.9", (scaled, *ref_b[1:]),
                     ref_b, tol, checks)
        del scaled
        _bwd_per_diagonal_check(f"wavefront_bwd {tag}", plain_args() + [None], (), ref_b, tol,
                                checks)
        got_b = wf.wavefront_bwd(*[b_in[k] for k in BWD_ARGS])
        torch.cuda.synchronize()
        worst["wavefront_bwd"] = max(worst["wavefront_bwd"], _rel_check(
            f"wavefront_bwd {tag}", got_b, ref_b, tol, checks))
        del ref, got_b, ref_b, b_in
        _drop_mode_checks(inp, tag, tol, checks, worst, seed=60 + i)
        _wavefront_persistent_checks(inp, tag, tol, checks, worst, seed=65 + i)
        del inp
    _wavefront_past_plan_check(checks, worst)
    _fused_checks(checks, worst)

    N = TRAIN_T * TRAIN_B
    g = torch.Generator().manual_seed(60)
    r = lambda *s, scale: (torch.randn(s, generator=g) * scale).to(DEVICE)
    h_prev, x = r(N, H, scale=0.5).to(bf), r(N, H, scale=0.5).to(bf)
    dgates = r(N, 4 * H, scale=0.01).to(bf)
    path = gm.product_path([H, H], 4 * H, bf)
    if path != "wgmma":
        fail(f"train_kernels: the LSTM weight gradients plan the {path} tile, not wgmma")
    got = gm.dgates_weight_grads(h_prev, x, dgates)
    again = gm.dgates_weight_grads(h_prev, x, dgates)
    ref = gm.dgates_weight_grads_plain(h_prev, x, dgates)
    torch.cuda.synchronize()
    tag = f"dgates_weight_grads N={N} D=H={H} G={4 * H} ({path} tile)"
    worst["dgates_weight_grads"] = _rel_check(tag, got, ref, WGRAD_TOL, checks)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    checks.append({"check": f"{tag}: repeat", "bit_equal": same})
    if not same:
        fail(f"{tag}: two calls on the same inputs differ")
    step = gm.TILES[path][2]
    _fault_check(f"{tag}: the last K stage ({step} rows) left out",
                 gm.dgates_weight_grads_plain(h_prev[:-step], x[:-step], dgates[:-step]),
                 ref, WGRAD_TOL, checks)
    _fault_check(f"{tag}: the two stacked A operands swapped", (ref[1], ref[0], ref[2]), ref,
                 WGRAD_TOL, checks)
    del h_prev, x, got, again, ref
    xx = r(N, H, scale=0.5).to(bf)                   # _hgrad_only's one-operand product
    got = gm.weight_grad(xx, dgates)
    ref = gm.weight_grad_plain(xx, dgates)
    torch.cuda.synchronize()
    worst["weight_grad"] = _rel_check(
        f"weight_grad N={N} D={H} G={4 * H} dg bfloat16 ({path} tile)", got, ref, WGRAD_TOL,
        checks)
    del xx, dgates, got, ref
    for D, G, xd, gd in ((120, H, torch.float32, torch.float32),
                         (120, H, torch.float32, bf),
                         (H, V, bf, torch.float32)):
        xx, dg = r(N, D, scale=1.0).to(xd), r(N, G, scale=0.01).to(gd)
        got = gm.weight_grad(xx, dg)
        ref = gm.weight_grad_plain(xx, dg)
        torch.cuda.synchronize()
        worst["weight_grad"] = max(worst["weight_grad"], _rel_check(
            f"weight_grad N={N} D={D} G={G} dg {str(gd)[6:]}", got, ref, WGRAD_TOL,
            checks))
    del xx, dg, got, ref
    worst.update(_ctc_checks(checks))
    worst["dropout"] = _dropout_checks(checks)
    worst["bernoulli_mask"] = _mask_checks(checks)
    worst.update(_ctc_stream_checks(checks))
    emit("train_kernels", checks=checks, max_abs_err=worst)


MASK_SHAPE = (L - 1, TRAIN_T, TRAIN_B, H)     # the inter-layer masks of a train step


def _mask_checks(checks):
    """The Bernoulli mask kernel at the train step's (L-1, T, B, H) bf16
    with the boundary keep ko·ki: bit for bit against its plain version,
    the kept fraction within 4 sigma; the plain version with the seed
    words swapped must differ."""
    import torch

    from rnn_speech_tpu_torch.ops import dropout as tdrop

    seed = (2718, 2818)
    got = tdrop.bernoulli_mask(seed, MASK_SHAPE, KEEP_PROB, torch.bfloat16, DEVICE)
    ref = tdrop.bernoulli_mask_plain(seed, MASK_SHAPE, KEEP_PROB, torch.bfloat16, DEVICE)
    torch.cuda.synchronize()
    n = ref.numel()
    frac = float(ref.float().mean())
    sigma = (KEEP_PROB * (1 - KEEP_PROB) / n) ** 0.5
    entry = {"check": f"bernoulli_mask {MASK_SHAPE} bf16 keep {KEEP_PROB}",
             "bit_equal": torch.equal(got, ref), "kept_fraction": frac,
             "sigmas": (frac - KEEP_PROB) / sigma,
             "max_abs_err": float((got.float() - ref.float()).abs().max())}
    checks.append(entry)
    if not entry["bit_equal"] or abs(frac - KEEP_PROB) > 4 * sigma:
        fail(f"bernoulli_mask: kernel disagrees with its plain version: {entry}")
    del ref
    faulty = tdrop.bernoulli_mask_plain(seed[::-1], MASK_SHAPE, KEEP_PROB, torch.bfloat16,
                                        DEVICE)
    seen = not torch.equal(faulty, got)
    checks.append({"planted_fault": "bernoulli_mask: seed words swapped", "bit_equal": not seen})
    if not seen:
        fail("bernoulli_mask: the check does not see swapped seed words")
    return entry["max_abs_err"]


def _ctc_stream_checks(checks):
    """The alpha-stream pair at the CTC kernels' train shape (``_ctc_batch``):
    the stream kernel's rows at every block end and its last row equal the
    checkpoint kernel's bit for bit and its rows are within the CTC
    tolerance of the plain stream; the stream backward's gradient is
    within it of the checkpoint backward's and of its plain version's.
    Beside them the plain stream without the skip transition and the
    stream backward fed the stream one step late must fail."""
    import torch

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck

    logits, ll, labels, ul = _ctc_batch(81)
    log_probs, ext, skip_ok, ll, ul, valid = tck._setup(logits, ll, labels, ul, -1)
    args = (log_probs, ext, skip_ok, ll, ul)
    T = log_probs.shape[0]
    K = tck.ctc_block(ext.shape[1], V)
    ck, last_ck = tck.ctc_alpha_ckpt(*args, K)
    alphas, last = tck.ctc_alpha_stream(*args)
    ends = [min(T, (i + 1) * K) - 1 for i in range(ck.shape[0])]
    ones = torch.ones((TRAIN_B,), device=DEVICE)
    logp = tck._loss(last_ck, ul, valid)[1]
    lists = tck.label_lists(ext, ul, V)
    grad_ck = tck.ctc_grad(log_probs, tck.ctc_beta_post(*args, logp, ck, K, lists), ll, valid,
                           ones)
    grad = tck.ctc_grad(log_probs, tck.ctc_beta_post_stream(*args, logp, alphas, lists), ll,
                        valid, ones)
    alphas_p, _ = tck.alpha_stream_plain(*args)
    grad_p = tck.ctc_grad(log_probs, tck.beta_post_stream_plain(*args, logp, alphas), ll,
                          valid, ones)
    torch.cuda.synchronize()
    live = alphas_p > -1e29
    rels = {"alphas": _ctc_rel(alphas, alphas_p), "grad_vs_plain": _ctc_rel(grad, grad_p),
            "grad_vs_ckpt": _ctc_rel(grad, grad_ck)}
    tols = {"alphas": CTC_LOSS_TOL, "grad_vs_plain": CTC_GRAD_TOL,
            "grad_vs_ckpt": CTC_GRAD_TOL}
    entry = {"check": f"ctc alpha stream B={TRAIN_B} T={TRAIN_T} U={MAX_LABEL} K={K}",
             "block_ends_equal_ckpts": torch.equal(alphas[ends], ck),
             "last_equal": torch.equal(last, last_ck),
             "grad_equal_ckpt_route": torch.equal(grad, grad_ck),
             "rel_err": rels, "tol": tols,
             "max_abs_err": {"alphas": float((alphas - alphas_p)[live].abs().max()),
                             "grad_vs_plain": float((grad - grad_p).abs().max()),
                             "grad_vs_ckpt": float((grad - grad_ck).abs().max())}}
    checks.append(entry)
    del alphas_p, live, grad_p, ck
    if (not entry["block_ends_equal_ckpts"] or not entry["last_equal"]
            or any(rels[k] > tols[k] for k in rels)):
        fail(f"ctc alpha stream: kernels disagree: {entry}")
    _, last_f = tck.alpha_plain(log_probs, ext, torch.zeros_like(skip_ok), ll, ul, 1, False)
    rel = _ctc_rel(last_f, last)
    late = tck.ctc_grad(log_probs, tck.beta_post_stream_plain(*args, logp, alphas.roll(1, 0)),
                        ll, valid, ones)
    rel_late = _ctc_rel(late, grad)
    checks.append({"planted_fault": "ctc alpha stream: skip transition dropped",
                   "rel_err": rel, "tol": CTC_LOSS_TOL})
    checks.append({"planted_fault": "ctc beta stream: the stream one step late",
                   "rel_err": rel_late, "tol": CTC_GRAD_TOL})
    if rel <= CTC_LOSS_TOL or rel_late <= CTC_GRAD_TOL:
        fail(f"ctc alpha stream: a planted fault passes ({rel}, {rel_late})")
    return {"ctc_alpha_stream": entry["max_abs_err"]["alphas"],
            "ctc_beta_post_stream": entry["max_abs_err"]["grad_vs_plain"]}


def _train_setup(T_frames, label_width, label_len, seed,
                 keeps=(INPUT_KEEP, OUTPUT_KEEP), pallas_ctc=True, Bn=None,
                 **model_kw):
    """(step config, train state, one-microbatch batch) at the flagship
    width: fbank frontend, 3x1024 bf16 kernel route, by default the
    default StepConfig (keep probabilities 0.8 / 0.5, the CTC kernels)
    on the wavefront (``model_kw`` sets other AcousticConfig options);
    random weights from a fixed torch.Generator, audio and labels from a
    fixed numpy seed as bench.py builds them, ``Bn`` utterances (TRAIN_B
    by default)."""
    import numpy as np
    import torch

    from rnn_speech_tpu_torch.frontend import FRAME_SIZE, FRAME_STRIDE
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend
    from rnn_speech_tpu_torch.train import step

    Bn = Bn or TRAIN_B
    n = T_frames * int(round(FRAME_STRIDE * SR)) + int(round(FRAME_SIZE * SR))
    fe = DeviceFrontend("fbank", sr=SR, max_samples=n, device=DEVICE)
    cfg = acoustic.AcousticConfig(
        num_layers=L, hidden_size=H, input_dim=fe.feature_size, num_labels=V,
        compute_dtype=torch.bfloat16, use_kernels=True, **{"wavefront": True, **model_kw})
    scfg = step.StepConfig(model=cfg, frontend=fe, input_keep_prob=keeps[0],
                           output_keep_prob=keeps[1], use_pallas_ctc=pallas_ctc)
    state = step.init_train_state(torch.Generator().manual_seed(seed), cfg, Bn,
                                  TRAIN_LR, DEVICE)
    rng = np.random.default_rng(1)
    batch = {
        "audio": rng.normal(0, 0.1, (1, Bn, n)).astype(np.float32),
        "audio_lengths": np.full((1, Bn), n, np.int32),
        "labels": rng.integers(1, V - 1, (1, Bn, label_width)).astype(np.int32),
        "label_lengths": np.full((1, Bn), label_len, np.int32),
    }
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    return scfg, state, batch


def _stack_counters(route):
    """The stack's two training kernels on a route: the wavefront, or the
    layered route in gates or recompute mode."""
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    return {"wavefront": {"wavefront_train": wf.wavefront_train,
                          "wavefront_bwd": wf.wavefront_bwd},
            "gates": {"recurrence_train": tlt.recurrence_train,
                      "recurrence_bwd": tlt.recurrence_bwd},
            "recompute": {"recurrence_train_lean": tlt.recurrence_train_lean,
                          "recurrence_bwd_recompute": tlt.recurrence_bwd_recompute}}[route]


def _train_counters(default=True, route="wavefront"):
    """The wrappers whose kernels a train step launches: the stack's two on
    ``route`` and the two weight-gradient kernels (the keep-1 scan-CTC
    step), and with the default step dropout and the CTC checkpoint and
    backward kernels."""
    from rnn_speech_tpu_torch.ops import ctc_kernel as tck
    from rnn_speech_tpu_torch.ops import dropout as tdrop
    from rnn_speech_tpu_torch.ops import grad_matmul as gm

    out = {**_stack_counters(route), "dgates_weight_grads": gm.dgates_weight_grads,
           "weight_grad": gm.weight_grad}
    if default:
        out.update(dropout=tdrop.dropout_kernel, ctc_alpha_ckpt=tck.ctc_alpha_ckpt,
                   ctc_beta_post=tck.ctc_beta_post)
    return out


def _all_counters():
    from rnn_speech_tpu_torch.ops import ctc_kernel as tck
    from rnn_speech_tpu_torch.ops import dropout as tdrop
    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk

    return {**_train_counters(), **_stack_counters("gates"),
            **_stack_counters("recompute"), "ctc_alpha_lossonly": tck.ctc_alpha_lossonly,
            "bernoulli_mask": tdrop.bernoulli_mask, "ctc_alpha_stream": tck.ctc_alpha_stream,
            "ctc_beta_post_stream": tck.ctc_beta_post_stream,
            "fbank_banks": tfk.fbank_banks}


def _path_counters():
    """Products on the Hopper tile (TMA + wgmma) at its four call sites:
    ``dgates_weight_grads`` (every layer's weight gradients; the default
    step), ``weight_grad`` at the LSTM shape (``_hgrad_only`` after the
    fused pass; the wide step), the fused pass's window products and the
    recompute backward's gate rebuilds (one per chunk; the recompute
    steps); and the persistent kernels' launches (wgmma on a resident W_h):
    the lean forward (csrc/lstm_layer_lean.cu; the recompute steps), the
    gates-mode forward (its gates instance; the layered steps), the
    gates-mode backward (csrc/lstm_layer_bwd_persistent.cu; the layered
    steps), the wavefront training forward
    (csrc/lstm_wavefront_persistent.cu; the default steps) and the reverse
    diagonal (csrc/lstm_wavefront_bwd_persistent.cu; the default steps)."""
    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    return {"dgates_weight_grads": gm.dgates_weight_grads.wgmma_launches,
            "weight_grad": gm.weight_grad.wgmma_launches,
            "fused_windows": wf.wavefront_bwd.wgmma_products,
            "recompute_rebuild": tlt.recurrence_bwd_recompute.rebuild_launches,
            "lean_persistent": tlt.recurrence_train_lean.persistent_launches,
            "bwd_persistent": tlt.recurrence_bwd.persistent_launches,
            "train_persistent": tlt.recurrence_train.persistent_launches,
            "wavefront_persistent": wf.wavefront_train.persistent_launches,
            "wavefront_bwd_persistent": wf.wavefront_bwd.persistent_launches}


def _zero_path_counters():
    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    gm.dgates_weight_grads.wgmma_launches = gm.weight_grad.wgmma_launches = 0
    wf.wavefront_bwd.wgmma_products = 0
    tlt.recurrence_bwd_recompute.rebuild_launches = 0
    tlt.recurrence_train_lean.persistent_launches = 0
    tlt.recurrence_bwd.persistent_launches = 0
    tlt.recurrence_train.persistent_launches = 0
    wf.wavefront_train.persistent_launches = wf.wavefront_bwd.persistent_launches = 0


@contextlib.contextmanager
def _plain_versions():
    """The kernel route with each training kernel's plain version in its
    place, at the names the route calls (a check's yardstick only)."""
    from unittest import mock

    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops import ctc_kernel as tck
    from rnn_speech_tpu_torch.ops import dropout as tdrop
    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk
    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    alpha = lambda *a: tck.alpha_plain(*a, True)
    lossonly = lambda *a: tck.alpha_plain(*a, 1, False)[1]
    with mock.patch.object(wf, "wavefront_train", wf.wavefront_train_plain), \
            mock.patch.object(wf, "wavefront_bwd", wf.wavefront_bwd_plain), \
            mock.patch.object(wf, "dgates_weight_grads", gm.dgates_weight_grads_plain), \
            mock.patch.object(wf, "weight_grad", gm.weight_grad_plain), \
            mock.patch.object(tlt, "recurrence_train", tlt.recurrence_train_plain), \
            mock.patch.object(tlt, "recurrence_bwd", tlt.recurrence_bwd_plain), \
            mock.patch.object(tlt, "recurrence_train_lean", tlt.recurrence_train_lean_plain), \
            mock.patch.object(tlt, "recurrence_bwd_recompute",
                              tlt.recurrence_bwd_recompute_plain), \
            mock.patch.object(tlt, "dgates_weight_grads", gm.dgates_weight_grads_plain), \
            mock.patch.object(acoustic, "weight_grad", gm.weight_grad_plain), \
            mock.patch.object(acoustic, "dropout_kernel", tdrop.dropout_plain), \
            mock.patch.object(tdrop, "dropout_kernel", tdrop.dropout_plain), \
            mock.patch.object(tck, "ctc_alpha_ckpt", alpha), \
            mock.patch.object(tck, "ctc_alpha_lossonly", lossonly), \
            mock.patch.object(tck, "ctc_beta_post", lambda *a: tck.beta_post_plain(*a[:8])), \
            mock.patch.object(tdrop, "bernoulli_mask", tdrop.bernoulli_mask_plain), \
            mock.patch.object(tck, "ctc_alpha_stream", tck.alpha_stream_plain), \
            mock.patch.object(tck, "ctc_beta_post_stream",
                              lambda *a: tck.beta_post_stream_plain(*a[:7])), \
            mock.patch.object(tfk, "fbank_banks",
                              lambda *a, tables=None: tfk.fbank_banks_plain(*a)):
        yield


def _scale_fault(bwd_plain):
    """The plain reverse diagonal with its inter-layer keep scale 1% too
    large (the cotangent and the xdrop streams): a planted fault."""
    def faulty(*args, **kw):
        args = list(args)
        args[12] *= 1.01                            # drop_scale
        return bwd_plain(*args, **kw)
    return faulty


def _wavefront_fault():
    from unittest import mock

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    return mock.patch.object(wf, "wavefront_bwd", _scale_fault(wf.wavefront_bwd_plain))


def _dgates_fault(bwd_plain):
    """A plain layer backward whose emitted dgates are 1% too large: a
    planted fault."""
    def faulty(*args):
        dgates, dh0, dc0 = bwd_plain(*args)
        dgates *= 1.01
        return dgates, dh0, dc0
    return faulty


def _layer_fault(name):
    """Returns a planted-fault context for the layered backward ``name``."""
    def fault():
        from unittest import mock

        from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

        return mock.patch.object(tlt, name, _dgates_fault(getattr(tlt, name + "_plain")))
    return fault


def _capture_weight_grad(fn, seen):
    """``fn`` (a weight_grad) that keeps the cotangent of its last call:
    after a backward, that of the input projection."""
    def wrapped(h, g, **kw):
        seen["input_projection_cotangent"] = g.detach().float().clone()
        return fn(h, g, **kw)
    return wrapped


def _grad_check(keeps=(INPUT_KEEP, OUTPUT_KEEP), pallas_ctc=True, seed=2, model_kw=None,
                fault=_wavefront_fault, tol=GRAD_REL_TOL):
    """One step's gradients through the kernels at T=GRAD_T, full width,
    against the same route on the kernels' plain versions (bf16 residuals
    too; the same seed words, so the same dropout masks) and, at keep 1
    with the scan CTC, against the plain route (the time loop under
    autograd, float32 residuals).  With dropout, the plain-version route
    with a planted fault (``fault()``, a context; by default the wavefront
    backward's inter-layer keep scale 1% too large) must fail the gate.
    ``model_kw`` sets AcousticConfig options (the route), ``tol`` the
    gate's limit against the plain versions.  Per parameter
    tensor, relative Frobenius error; also that of the cotangent that
    reaches the input projection.  No yardstick may launch a kernel."""
    import dataclasses
    from unittest import mock

    import torch

    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.params import flatten
    from rnn_speech_tpu_torch.train import step

    scfg, state, batch = _train_setup(GRAD_T, 100, 50, seed=seed, keeps=keeps,
                                      pallas_ctc=pallas_ctc, **(model_kw or {}))
    counters = _all_counters()
    out = {}
    routes = [("kernels", True, False), ("plain_versions", True, True)]
    if keeps == (1.0, 1.0):
        if not pallas_ctc:
            routes.append(("time_loop", False, False))
    else:
        routes.append(("planted_fault", True, True))
    for name, kernels, swap in routes:
        sc = dataclasses.replace(scfg, model=dataclasses.replace(
            scfg.model, use_kernels=kernels))
        before = sum(fn.launches for fn in counters.values())
        seen = {}
        with contextlib.ExitStack() as stack:
            if swap:
                stack.enter_context(_plain_versions())
            if name == "planted_fault":
                stack.enter_context(fault())
            stack.enter_context(mock.patch.object(
                acoustic, "weight_grad", _capture_weight_grad(acoustic.weight_grad, seen)))
            _, grads, loss_sum, _, _ = step.accumulate_grads(
                sc, state["params"], state["states"], batch,
                torch.Generator().manual_seed(seed + 1))
        torch.cuda.synchronize()
        if name != "kernels" and sum(fn.launches for fn in counters.values()) != before:
            fail(f"train: the {name} yardstick launched a kernel")
        out[name] = (flatten(grads), float(loss_sum), seen.get("input_projection_cotangent"))
    rel = lambda a, b: float((a - b).float().norm() / b.float().norm().clamp(min=1e-30))
    entry = {"T": GRAD_T, "keep_probs": list(keeps), "use_pallas_ctc": pallas_ctc,
             "seed": seed, "model": model_kw or {},
             "mean_loss": {k: v[1] for k, v in out.items()}}
    for name, limit in (("plain_versions", tol), ("time_loop", TIME_LOOP_TOL),
                        ("planted_fault", tol)):
        if name not in out:
            continue
        ref, got = out[name][0], out["kernels"][0]
        per = {k: rel(got[k], ref[k]) for k in ref}
        worst = max(per.values())
        cot = out[name][2]
        entry[name] = {"rel_frobenius": per, "worst": worst, "worst_tensor": max(per, key=per.get),
                       "tol": limit, "input_projection_cotangent": None if cot is None else
                       rel(out["kernels"][2], cot)}
        if name == "planted_fault":
            entry[name]["over_limit"] = worst / limit
            if not worst > limit:
                fail(f"train: the gradient gate does not see the planted fault: {entry}")
        elif not all(v == v for v in per.values()) or worst > limit:
            fail(f"train: kernel-route gradients disagree with {name}: {entry}")
    return entry


# The recompute route's gradient gate: its route, planted fault and limit.
RECOMPUTE_GATE = dict(model_kw=dict(residual_mode="recompute"),
                      fault=_layer_fault("recurrence_bwd_recompute"), tol=RECOMPUTE_GRAD_TOL)


def phase_grad_study():
    """The gradient gate's readings over seeds and keep probabilities
    (input, output) of 1 and the defaults, each site alone and both, on
    the CTC kernels, with the planted fault wherever the inter-layer
    boundary drops: the readings behind GRAD_REL_TOL; the recompute
    route's at the default keeps, the readings behind RECOMPUTE_GRAD_TOL;
    and each alt route's (``_alt_route_specs``, its switch set around it)
    at the default keeps under GRAD_REL_TOL."""
    readings, recompute, alt = [], [], {}
    for seed in (2, 5, 8):
        for keeps in ((1.0, 1.0), (INPUT_KEEP, 1.0), (1.0, OUTPUT_KEEP),
                      (INPUT_KEEP, OUTPUT_KEEP)):
            readings.append(_grad_check(keeps, True, seed))
        recompute.append(_grad_check(seed=seed, **RECOMPUTE_GATE))
        for name, env, _, _, fault, _ in _alt_route_specs():
            with _environ(**env):
                alt.setdefault(name, []).append(_grad_check(seed=seed, fault=fault))
    emit("grad_study", readings=readings, recompute=recompute, alt_routes=alt)


def _nn_lstm_backward(T, Bn, n_layers=1):
    """Two calls of torch.nn.LSTM's (cuDNN, bf16, n_layers of 1024)
    backward on one forward graph at T steps and Bn rows, yardsticks only:
    (without weight gradients, with them).  The first asks
    torch.autograd.grad for the input's gradient alone, so autograd masks
    the weights' out of cuDNN's backward; it still computes
    dx = dgates·W_ihᵀ (of layer 0, which the kernels leave to a matmul;
    between layers the reverse diagonal forms it too)."""
    import torch

    m = torch.nn.LSTM(H, H, num_layers=n_layers).to(DEVICE, torch.bfloat16)
    m.flatten_parameters()
    x = torch.randn((T, Bn, H), device=DEVICE, dtype=torch.bfloat16, requires_grad=True)
    y, _ = m(x)
    dy = torch.randn_like(y)
    inputs = [x, *m.parameters()]
    return (lambda: torch.autograd.grad(y, [x], dy, retain_graph=True),
            lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True))


def _nn_lstm_forward(T, Bn, n_layers=1):
    """One call of torch.nn.LSTM's (cuDNN, bf16, n_layers of 1024) forward
    on an input that needs its gradient (cuDNN's training forward, which
    keeps its own residuals), at T steps and Bn rows: a yardstick only."""
    import torch

    m = torch.nn.LSTM(H, H, num_layers=n_layers).to(DEVICE, torch.bfloat16)
    m.flatten_parameters()
    x = torch.randn((T, Bn, H), device=DEVICE, dtype=torch.bfloat16, requires_grad=True)
    return lambda: m(x)


def _train_kernel_timing(state):
    """Each training kernel alone at the train path's shapes (full-length
    rows): ms, its plain version's ms, one PyTorch call's ms and the bound.
    Times are per train step: one call of the two wavefront kernels (drop
    mode 2, the default step's; mode 0 timed beside it as ``ms_mode0``), L
    calls of dgates_weight_grads, two calls of weight_grad (input and
    output projection).  The training forward is timed in turns with
    cuDNN's L-layer training forward and with the per-diagonal kernel the
    plan replaces at this shape (``per_diagonal_ms``), the reverse diagonal in turns with
    cuDNN's L-layer backward without weight gradients (``library_ms``; the
    kernel leaves them to dgates_weight_grads) and with them
    (``library_wgrad_ms``), both on one forward graph.  dgates_weight_grads is timed in turns with its
    library yardstick (two torch.mm with float32 results and a float32
    column sum), beside the card's clocks, and beside the WMMA tile at
    the same shape (``wmma_ms_per_call``); each product reports its
    TFLOP/s."""
    from unittest import mock

    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    T, Bn, bf, f32 = TRAIN_T, TRAIN_B, torch.bfloat16, torch.float32
    N, G = T * Bn, 4 * H
    inp = _train_inputs(T, Bn, [T] * Bn, seed=70)
    args = [inp[k] for k in FWD_ARGS]
    out = {}
    drop = _drop(2, T, Bn, 72)
    ms0 = cuda_ms(lambda: wf.wavefront_train(*args, bf), iters=2)

    def per_diagonal():                              # the design the plan replaces here
        with mock.patch.object(wf, "wavefront_plan", lambda *a: {"kernel": "per_diagonal"}):
            return wf.wavefront_train(*args, bf, *drop)

    turns = in_turns(_nn_lstm_forward(T, Bn, L), lambda: wf.wavefront_train(*args, bf, *drop),
                     iters=2, per_diagonal=per_diagonal)
    ms = turns["ms"]
    torch.cuda.empty_cache()
    plain = cuda_ms(lambda: wf.wavefront_train_plain(*args, bf, *drop), iters=1,
                    warmup=0)
    flops = 2 * T * Bn * H * G * 2 * L
    nbytes = (T * Bn * H * 2 + 2 * L * H * G * 2 + L * G * 4    # x, W_x0, W_h, W_x, b
              + T * Bn * 4 + 2 * L * Bn * H * 4            # inputs
              + L * T * Bn * (H + G + H) * 2 + 2 * L * Bn * H * 4)   # outputs
    bound, by = _bounds(flops, nbytes)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["wavefront_train"] = dict(ms=ms, ms_mode0=ms0, plain_ms=plain, bound_ms=bound,
                                  bound_by=by, library_ms=turns["library_ms"],
                                  library=f"torch.nn.LSTM training forward ({L} layers, in "
                                  "turns)", per_diagonal_ms=turns["per_diagonal_ms"],
                                  turns=turns["turns"],
                                  us_per_diagonal=1e3 * ms / (T + L - 1),
                                  plan=wf.wavefront_plan(Bn, H, L, H, sms), flops=flops,
                                  bytes=nbytes)

    outs, gates, cseq, _, _ = wf.wavefront_train(*args, bf, *drop)
    b_in = _bwd_inputs(inp, outs, gates, cseq, seed=71)
    # Each call writes dgates over its gates: the plain version gets a copy
    # of the residual, the kernel's later calls run on dgates (same work).
    pargs = [b_in[k].clone() if k == "gates" else b_in[k] for k in BWD_ARGS]
    bargs = [b_in[k] for k in BWD_ARGS]
    ms0 = cuda_ms(lambda: wf.wavefront_bwd(*bargs), iters=2)
    no_dw, with_dw = _nn_lstm_backward(T, Bn, L)
    turns = in_turns(no_dw, lambda: wf.wavefront_bwd(*bargs, outs, *drop), iters=2,
                     library_wgrad=with_dw,
                     per_diagonal=lambda: _bwd_per_diagonal(bargs + [outs], drop))
    del no_dw, with_dw
    ms = turns["ms"]
    torch.cuda.empty_cache()
    plain = cuda_ms(lambda: wf.wavefront_bwd_plain(*pargs, outs, *drop), iters=1,
                    warmup=0)
    flops = 2 * T * Bn * H * G * (2 * L - 1)
    nbytes = (T * Bn * H * 2 + (2 * L - 1) * H * G * 2 + T * Bn * 4
              + L * T * Bn * (G + H) * 2 + 3 * L * Bn * H * 4      # inputs
              + (L - 1) * T * Bn * H * 2                            # outs read
              + L * T * Bn * G * 2 + 2 * L * Bn * H * 4             # outputs
              + (L - 1) * T * Bn * H * 2)                           # xdrop
    bound, by = _bounds(flops, nbytes)
    out["wavefront_bwd"] = dict(ms=ms, ms_mode0=ms0, plain_ms=plain, bound_ms=bound,
                                bound_by=by, library_ms=turns["library_ms"],
                                library=f"torch.nn.LSTM backward ({L} layers, without weight "
                                "gradients, in turns)",
                                library_wgrad_ms=turns["library_wgrad_ms"],
                                per_diagonal_ms=turns["per_diagonal_ms"],
                                us_per_diagonal=1e3 * ms / (T + L - 1),
                                plan=wf.wavefront_bwd_plan(Bn, H, L, False, sms),
                                turns=turns["turns"], flops=flops, bytes=nbytes)

    h_prev = torch.cat([inp["h0"][0].to(bf)[None], outs[0, :-1]]).reshape(N, H)
    x2, dg2 = outs[1].reshape(N, H), pargs[BWD_ARGS.index("gates")][0].reshape(N, G)
    kernel = lambda: gm.dgates_weight_grads(h_prev, x2, dg2)
    # The library yardstick: two products and db with float32 results, no
    # float32 copy of dg.
    turns = in_turns(lambda: (torch.mm(h_prev.t(), dg2, out_dtype=f32),
                              torch.mm(x2.t(), dg2, out_dtype=f32), dg2.sum(0, dtype=f32)),
                     kernel)
    ms, lib = turns["ms"], turns["library_ms"]
    with mock.patch.object(gm, "product_path", lambda *a: "wmma"):   # the WMMA tile
        wmma = cuda_ms(kernel)
    plain = cuda_ms(lambda: gm.dgates_weight_grads_plain(h_prev, x2, dg2), iters=1)
    flops = 2 * N * 2 * H * G
    nbytes = N * (2 * H + G) * 2 + (2 * H + 1) * G * 4
    bound, by = _bounds(flops, nbytes)
    out["dgates_weight_grads"] = dict(
        ms=L * ms, plain_ms=L * plain, bound_ms=L * bound, bound_by=by, library_ms=L * lib,
        calls=L, ms_per_call=ms, tflops=flops / ms / 1e9, library_tflops=flops / lib / 1e9,
        wmma_ms_per_call=wmma, wmma_tflops=flops / wmma / 1e9,
        path=gm.product_path([H, H], G, bf), turns=turns["turns"], flops=L * flops,
        bytes=L * nbytes)
    del gates, cseq, b_in, bargs, pargs, dg2

    g = torch.Generator().manual_seed(72)
    feats = torch.randn((N, 120), generator=g).to(DEVICE)
    d_in = (torch.randn((N, H), generator=g) * 0.01).to(DEVICE)
    d_out = (torch.randn((N, V), generator=g) * 0.01).to(DEVICE)
    top = outs[-1].reshape(N, H)
    per = {}
    for name, xx, dg in (("input", feats, d_in), ("output", top, d_out)):
        D, Gs = xx.shape[1], dg.shape[1]
        ms = cuda_ms(lambda: gm.weight_grad(xx, dg))
        plain = cuda_ms(lambda: gm.weight_grad_plain(xx, dg), iters=1)
        lib = cuda_ms(lambda: (torch.mm(xx.to(bf).t(), dg.to(bf), out_dtype=f32),
                               dg.sum(0, dtype=f32)))
        nbytes = N * (D * xx.element_size() + Gs * dg.element_size()) + (D + 1) * Gs * 4
        bound, by = _bounds(2 * N * D * Gs, nbytes)
        per[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         library_ms=lib, D=D, G=Gs, dg=str(dg.dtype)[6:],
                         path=gm.product_path([D], Gs, dg.dtype),
                         tflops=2 * N * D * Gs / ms / 1e9, flops=2 * N * D * Gs,
                         bytes=nbytes)
    out["weight_grad"] = {k: sum(per[n][k] for n in per)
                          for k in ("ms", "plain_ms", "bound_ms", "library_ms", "flops")}
    out["weight_grad"]["tflops"] = out["weight_grad"]["flops"] / out["weight_grad"]["ms"] / 1e9
    out["weight_grad"].update(bound_by="bytes" if all(
        v["bound_by"] == "bytes" for v in per.values()) else "operations", calls=per)
    return out


def _ctc_timing_batch():
    """The CTC kernels' timing batch at the default step's shapes:
    full-length rows, labels of LABEL_LEN in a MAX_LABEL-wide buffer.
    Returns ``_setup``'s (log_probs, ext, skip_ok, ll, ul, valid) and the
    (B, LABEL_LEN) targets of the library call."""
    import torch

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck

    T, Bn = TRAIN_T, TRAIN_B
    g = torch.Generator().manual_seed(95)
    logits = (torch.randn((T, Bn, V), generator=g) * 2.0).to(DEVICE)
    labels = torch.randint(0, V - 1, (Bn, MAX_LABEL), generator=g)
    labels[:, LABEL_LEN:] = -1
    ll = torch.full((Bn,), T, device=DEVICE)
    ul = torch.full((Bn,), LABEL_LEN, device=DEVICE)
    return (*tck._setup(logits, ll, labels.to(DEVICE), ul, -1),
            labels[:, :LABEL_LEN].to(DEVICE))


def _ctc_library(log_probs, targets, ll, ul):
    """``torch.nn.functional.ctc_loss``'s own halves on the kernels'
    operands, each one PyTorch call: ``forward`` (``aten._ctc_loss``, what
    ``ctc_loss`` runs here: blank V-1 keeps it off cuDNN), ``backward``
    alone (``aten._ctc_loss_backward`` on that forward's saved
    neg_log_likelihood and log_alpha) and ``pair``, the two in a row."""
    import torch

    il, tl = ll.long(), ul.long()
    fwd = lambda: torch.ops.aten._ctc_loss(log_probs, targets, il, tl, V - 1, False)
    nll, log_alpha = fwd()
    grad = torch.ones_like(nll)
    bwd = lambda nl, la: torch.ops.aten._ctc_loss_backward(grad, log_probs, targets, il, tl,
                                                           nl, la, V - 1, False)
    return {"forward": fwd, "backward": lambda: bwd(nll, log_alpha),
            "pair": lambda: bwd(*fwd())}


def _ctc_row(run, plain, ops, nbytes, lib, half):
    """One CTC kernel's timing row: the kernel in turns with the library
    call of its own half (``forward`` or ``backward``, ``_ctc_library``),
    the pair's time beside, the plain version's time and the bound."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    turns = in_turns(lib[half], run)
    return dict(ms=turns["ms"], plain_ms=cuda_ms(plain, iters=1, warmup=0),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=turns["library_ms"],
                library=f"torch.nn.functional.ctc_loss {half} alone (aten._ctc_loss"
                        f"{'' if half == 'forward' else '_backward'})",
                library_pair_ms=cuda_ms(lib["pair"]), turns=turns["turns"], ops=ops,
                bytes=nbytes)


def _ctc_dropout_timing():
    """The CTC kernels and the dropout kernel alone at the default step's
    shapes (full-length rows, labels of LABEL_LEN): ms, the plain
    version's ms, one PyTorch call's ms and the bound.  The CTC bound
    counts this batch's live lattice entries (each row's T_b steps of
    2·label_length + 1 states) against the float32 rate, or the bytes of
    the log-probs, checkpoints and outputs; dropout's covers the step's
    five passes (input site forward and backward in float32, top site
    forward, rebuild and dy), bound by bytes."""
    import torch

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck
    from rnn_speech_tpu_torch.ops import dropout as tdrop

    T, Bn = TRAIN_T, TRAIN_B
    log_probs, ext, skip_ok, ll, ul, valid, targets = _ctc_timing_batch()
    K = tck.ctc_block(ext.shape[1], V)
    args = (log_probs, ext, skip_ok, ll, ul)
    ckpts, last = tck.ctc_alpha_ckpt(*args, K)
    logp = tck._loss(last, ul, valid)[1]
    lists = tck.label_lists(ext, ul, V)            # built once, as the loss's forward does
    live = int((ll * (2 * ul + 1)).sum())
    s_live = 2 * LABEL_LEN + 1
    n_ck = -(-T // K)
    lp_bytes = T * Bn * V * 4
    lib = _ctc_library(log_probs, targets, ll, ul)
    out = {}
    for name, run, plain, ops, nbytes, half in (
        ("ctc_alpha_ckpt", lambda: tck.ctc_alpha_ckpt(*args, K),
         lambda: tck.alpha_plain(*args, K, True), CTC_ALPHA_OPS * live,
         lp_bytes + (n_ck + 1) * Bn * s_live * 4, "forward"),
        ("ctc_alpha_lossonly", lambda: tck.ctc_alpha_lossonly(*args),
         lambda: tck.alpha_plain(*args, 1, False), CTC_ALPHA_OPS * live,
         lp_bytes + Bn * s_live * 4, "forward"),
        ("ctc_beta_post", lambda: tck.ctc_beta_post(*args, logp, ckpts, K, lists),
         lambda: tck.beta_post_plain(*args, logp, ckpts, K), CTC_BETA_POST_OPS * live,
         2 * lp_bytes + n_ck * Bn * s_live * 4, "backward"),
    ):
        out[name] = _ctc_row(run, plain, ops, nbytes, lib, half)
        out[name]["K"] = K
    del log_probs, ckpts, lib

    gd = torch.Generator(device=DEVICE).manual_seed(96)
    f32x = torch.randn((T, Bn, H), generator=gd, device=DEVICE)
    bf16x = f32x.to(torch.bfloat16)
    passes = ((f32x, INPUT_KEEP), (f32x, INPUT_KEEP), (bf16x, OUTPUT_KEEP),
              (bf16x, OUTPUT_KEEP), (f32x, OUTPUT_KEEP))
    seed = (31, 41)
    ms = sum(cuda_ms(lambda: tdrop.dropout_kernel(x, seed, [k])) for x, k in passes)
    plain = sum(cuda_ms(lambda: tdrop.dropout_plain(x, seed, [k]), iters=1, warmup=0)
                for x, k in passes)
    lib = sum(cuda_ms(lambda: torch.nn.functional.dropout(x, 1 - k)) for x, k in passes)
    nbytes = sum(2 * x.numel() * x.element_size() for x, _ in passes)
    out["dropout"] = dict(ms=ms, plain_ms=plain, bound_ms=nbytes / PEAK_BYTES * 1e3,
                          bound_by="bytes", library_ms=lib,
                          library="torch.nn.functional.dropout", calls=len(passes),
                          bytes=nbytes)
    return out


def _run_steps(scfg, state, batch, reps, record_stages, route="wavefront", warmup=2,
               counters=None, idle=None, per_rep=3):
    """``warmup`` steps (the first timed alone), ``reps`` reps of
    ``per_rep`` timed steps on the repeated batch, and with
    ``record_stages`` one more step split by its marks.  Counters are
    zeroed before and read after: the kernels of the stack's ``route`` (or
    ``counters``, {name: wrapper}) must launch, and off the wavefront the
    wavefront kernels (or ``idle``) must not; ``fused_launches`` counts the
    reverse passes with the fused dW_x, ``wgmma_launches`` the weight-gradient
    products on the Hopper tile at each call site (``_path_counters``).
    Returns (record, state)."""
    import statistics

    import torch

    from rnn_speech_tpu_torch import stages
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf
    from rnn_speech_tpu_torch.train import step

    Bn = batch["labels"].shape[1]
    counters = counters or _train_counters(scfg.use_pallas_ctc, route)
    if idle is None:
        idle = {} if route == "wavefront" else _stack_counters("wavefront")
    for fn in _all_counters().values():
        fn.launches = 0
    wf.wavefront_bwd.fused_launches = 0
    _zero_path_counters()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(11)
    losses = []

    def run():
        nonlocal state
        state, metrics = step.train_step(scfg, state, batch, gen, False)
        losses.append(metrics["mean_loss"])

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    for _ in range(warmup - 1):
        run()
    vals = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_rep):
            run()
        torch.cuda.synchronize()
        vals.append(1e3 * (time.perf_counter() - t0) / per_rep)
    stage_ms = {}
    if record_stages:
        with stages.record() as marks:             # one more step, split by stage
            run()
        stage_ms = stages.stage_ms(marks)
    launches = {name: fn.launches for name, fn in counters.items()}
    fused_launches = wf.wavefront_bwd.fused_launches
    path_launches = _path_counters()
    idle = {name: fn.launches for name, fn in idle.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    ms = statistics.median(vals)
    if not all(v == v and abs(v) < float("inf") for v in losses):
        fail(f"train: non-finite loss {losses}")
    if not all(launches.values()):
        fail(f"train: the step did not go through every training kernel: {launches}")
    if any(idle.values()):
        fail(f"train: the {route} route launched kernels it must not: {idle}")
    return dict(steps=len(losses), batch=Bn, train_ms_per_step=ms,
                train_utt_per_sec=Bn / (ms / 1e3),
                train_spread_pct=100.0 * (max(vals) - min(vals)) / ms, values_ms=vals,
                first_step_ms=first_ms, losses=losses, launches=launches,
                fused_launches=fused_launches, wgmma_launches=path_launches,
                idle_launches=idle,
                peak_memory_gib=peak / 2**30, stage_ms=stage_ms,
                stage_sum_ms=sum(stage_ms.values())), state


def _eval_check(scfg, state, batch):
    """``eval_step`` with the CTC kernels (the loss-only kernel must
    launch) against the same step on the scan CTC."""
    import dataclasses

    import torch

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck
    from rnn_speech_tpu_torch.train import step

    tck.ctc_alpha_lossonly.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = step.eval_step(scfg, state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = tck.ctc_alpha_lossonly.launches
    ref = step.eval_step(dataclasses.replace(scfg, use_pallas_ctc=False), state, batch)
    rel = abs(float(got["mean_loss"]) - float(ref["mean_loss"])) / abs(float(ref["mean_loss"]))
    entry = {"mean_loss": float(got["mean_loss"]), "scan_ctc_mean_loss": float(ref["mean_loss"]),
             "rel_err": rel, "tol": CTC_LOSS_TOL, "ms": ms,
             "mean_error_rate": float(got["mean_error_rate"]),
             "launches": {"ctc_alpha_lossonly": launches}}
    if not launches or rel > CTC_LOSS_TOL:
        fail(f"eval_step: the CTC kernels' loss disagrees or did not launch: {entry}")
    return entry


def phase_train():
    import torch

    from rnn_speech_tpu_torch.models import acoustic

    scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=0)
    plan = acoustic.training_memory_plan(scfg.model, TRAIN_T, TRAIN_B)
    if plan != (0, "gates"):
        fail(f"train: memory plan {plan} at B=64, T=3510; expected (0, 'gates')")
    default, state = _run_steps(scfg, state, batch, reps=3, record_stages=True)
    if not default["wgmma_launches"]["dgates_weight_grads"]:
        fail(f"train: dgates_weight_grads never ran the Hopper tile: {default['wgmma_launches']}")
    if not default["wgmma_launches"]["wavefront_persistent"]:
        fail("train: the forward never ran the persistent wavefront kernel")
    if not default["wgmma_launches"]["wavefront_bwd_persistent"]:
        fail("train: the backward never ran the persistent reverse diagonal")
    losses = default["losses"]
    if not sum(losses[-3:]) / 3 < losses[0]:
        fail(f"train: the mean of the last 3 losses is not below the first: {losses}")
    eval_entry = _eval_check(scfg, state, batch)
    del batch
    keep1_cfg, keep1_state, keep1_batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN,
                                                       seed=0, keeps=(1.0, 1.0),
                                                       pallas_ctc=False)
    keep1, _ = _run_steps(keep1_cfg, keep1_state, keep1_batch, reps=1, record_stages=False)
    if not keep1["losses"][-1] < keep1["losses"][0]:
        fail(f"train (keep 1, scan CTC): the loss did not fall: {keep1['losses']}")
    del keep1_state, keep1_batch
    torch.cuda.empty_cache()
    grad_check = _grad_check()
    keep1["grad_check"] = _grad_check((1.0, 1.0), False)
    timing = _train_kernel_timing(state)
    timing.update(_ctc_dropout_timing())
    emit("train", frames=TRAIN_T, label_length=LABEL_LEN,
         keep_probs=[scfg.input_keep_prob, scfg.output_keep_prob],
         use_pallas_ctc=scfg.use_pallas_ctc, memory_plan=list(plan), **default,
         grad_check=grad_check, eval_step=eval_entry, keep1_scan_ctc=keep1,
         timing=timing)


LAYER_KERNELS = ("recurrence_train", "recurrence_bwd", "recurrence_train_lean",
                 "recurrence_bwd_recompute")


def _layer_inputs(T, Bn, lengths, seed, proj_dtype=None):
    """One layer's kernel inputs at full width on the card: a bf16 input x,
    xavier-uniform bf16 W_x and W_h, an f32 bias, x_proj = x·W_x + b
    (f32 sums, in ``proj_dtype``, float32 by default), non-zero h0, c0,
    f32 cotangents dout, dhn, dcn and the (T, 1, B) length mask."""
    import torch

    from rnn_speech_tpu_torch.ops.lstm_layer_train import input_projection

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim).to(DEVICE, bf)
    r = lambda *s, scale: (torch.randn(s, generator=g) * scale).to(DEVICE)
    lens = torch.as_tensor(lengths)
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :].to(DEVICE)
    x, w_x, w_h, b = r(T, Bn, H, scale=1.0).to(bf), w(H, 4 * H), w(H, 4 * H), r(4 * H, scale=0.1)
    return dict(x=x, w_x=w_x, w_h=w_h, b=b, mask=mask,
                x_proj=input_projection(x, w_x, b, bf, proj_dtype or torch.float32),
                h0=r(Bn, H, scale=0.2), c0=r(Bn, H, scale=0.2), dout=r(T, Bn, H, scale=0.1),
                dhn=r(Bn, H, scale=0.1), dcn=r(Bn, H, scale=0.1))


def _layer_kernel_checks(checks, worst, rec_B):
    """The four layered kernels against their plain versions at full width
    (H=D=1024, B=64), strictly at T=16 and looser at T=512 and 3510, each
    beside a planted fault that must fail its check: both forwards with
    the forget gate's +1 left out, both backwards with df scaled by 0.9,
    the recompute backward's rebuild without the bias.  The lean forward
    fed float32 x_proj instead of bf16 is read beside its check (the bf16
    projection's share of the difference), not gated.  The recompute
    backward also at its route's batch ``rec_B`` (T=512) and at a chunk
    edge (T one step past a chunk of its rebuild, B=70: not a multiple of
    16), beside the same faults; and its rebuild product alone
    (``_rebuild_product_check``)."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf = torch.bfloat16
    f_cols = slice(2 * H, 3 * H)                     # the forget gate's block

    def df_scaled(res):
        scaled = res[0].clone()
        scaled[..., f_cols] *= 0.9
        return (scaled, *res[1:])

    cases = ((16, TRAIN_TOL_SHORT), (512, TRAIN_TOL_LONG), (TRAIN_T, TRAIN_TOL_LONG))
    for i, (T, tol) in enumerate(cases):
        lens = [max(0, T - (31 * b) % (T // 2 + 1)) if b % 9 else T for b in range(TRAIN_B)]
        lens[2] = 0                                  # a zero-length row
        inp = _layer_inputs(T, TRAIN_B, lens, seed=140 + i)
        tag = f"H={H} B={TRAIN_B} T={T}"
        tail = (inp["w_h"], inp["mask"], inp["h0"], inp["c0"], bf)
        c0r = inp["c0"].to(bf).float()
        btail = (inp["mask"], inp["w_h"], inp["dhn"], inp["dcn"])
        for lean in (False, True):
            name = "recurrence_train_lean" if lean else "recurrence_train"
            xp = inp["x_proj"].to(bf) if lean else inp["x_proj"]
            fwd, fwd_plain = getattr(tlt, name), getattr(tlt, name + "_plain")
            got = fwd(xp, *tail)
            ref = fwd_plain(xp, *tail)
            torch.cuda.synchronize()
            worst[name] = max(worst[name], _rel_check(f"{name} {tag}", got, ref, tol, checks))
            del got
            if not lean:
                _train_persistent_checks(f"{name} {tag}", xp, tail, ref, tol, checks)
            xp_nof = xp.clone()
            xp_nof[..., f_cols] -= 1.0
            _fault_check(f"{name} {tag}: forget-gate +1 left out", fwd_plain(xp_nof, *tail),
                         ref, tol, checks)
            del xp_nof
            if lean:
                checks.append({"reading": f"{name} {tag}: plain version fed float32 x_proj",
                               "rel_err": _rel_errs(fwd_plain(inp["x_proj"], *tail), ref)[1]})
                out, cseq = ref[0], ref[3]
                h_prev = torch.cat([inp["h0"].to(bf)[None], out.to(bf)[:-1]])
                args = [inp["dout"], inp["x"], h_prev, cseq, c0r, inp["mask"], inp["w_x"],
                        inp["b"], inp["w_h"], inp["dhn"], inp["dcn"]]
                name = "recurrence_bwd_recompute"
                ref_b = tlt.recurrence_bwd_recompute_plain(*args)
                no_bias = args[:7] + [torch.zeros_like(inp["b"])] + args[8:]
                _fault_check(f"{name} {tag}: bias left out of the rebuild",
                             tlt.recurrence_bwd_recompute_plain(*no_bias), ref_b, tol, checks)
                got_b = tlt.recurrence_bwd_recompute(*args)
            else:
                gates, cseq = ref[3], ref[4]
                name = "recurrence_bwd"
                ref_b = tlt.recurrence_bwd_plain(inp["dout"], gates.clone(), cseq, c0r, *btail)
                got_b = _bwd_persistent_checks(f"{name} {tag}", inp["dout"], gates, cseq, c0r,
                                               btail, ref_b, tol, checks)
            _fault_check(f"{name} {tag}: df scaled by 0.9", df_scaled(ref_b), ref_b, tol,
                         checks)
            torch.cuda.synchronize()
            worst[name] = max(worst[name], _rel_check(f"{name} {tag}", got_b, ref_b, tol,
                                                      checks))
            del ref, ref_b, got_b
        del inp

    _bwd_past_plan_check(checks)
    _train_past_plan_check(checks)
    name = "recurrence_bwd_recompute"
    edge_T = tlt.rebuild_chunk(TRAIN_T, 70, H) + 1
    for i, (T, Bn) in enumerate(((512, rec_B), (edge_T, 70))):
        lens = [max(0, T - (31 * b) % (T // 2 + 1)) if b % 9 else T for b in range(Bn)]
        lens[2] = 0                                  # a zero-length row
        inp = _layer_inputs(T, Bn, lens, seed=150 + i, proj_dtype=bf)
        tag = f"H={H} B={Bn} T={T} (rebuild chunks of {tlt.rebuild_chunk(T, Bn, H)} steps)"
        out, _, _, cseq = tlt.recurrence_train_lean_plain(
            inp["x_proj"], inp["w_h"], inp["mask"], inp["h0"], inp["c0"], bf)
        h_prev = torch.cat([inp["h0"].to(bf)[None], out.to(bf)[:-1]])
        del out
        args = [inp["dout"], inp["x"], h_prev, cseq, inp["c0"].to(bf).float(), inp["mask"],
                inp["w_x"], inp["b"], inp["w_h"], inp["dhn"], inp["dcn"]]
        ref_b = tlt.recurrence_bwd_recompute_plain(*args)
        no_bias = args[:7] + [torch.zeros_like(inp["b"])] + args[8:]
        _fault_check(f"{name} {tag}: bias left out of the rebuild",
                     tlt.recurrence_bwd_recompute_plain(*no_bias), ref_b, TRAIN_TOL_LONG, checks)
        _fault_check(f"{name} {tag}: df scaled by 0.9", df_scaled(ref_b), ref_b, TRAIN_TOL_LONG,
                     checks)
        got_b = tlt.recurrence_bwd_recompute(*args)
        torch.cuda.synchronize()
        worst[name] = max(worst[name], _rel_check(f"{name} {tag}", got_b, ref_b,
                                                  TRAIN_TOL_LONG, checks))
        del inp, args, no_bias, ref_b, got_b, h_prev, cseq
    worst["rebuild_gates"] = _rebuild_product_check(checks, rec_B)


def _train_persistent_checks(tag, xp, tail, ref, tol, checks):
    """The gates-mode forward at the layered step's batch on its persistent
    kernel (row 5: csrc/lstm_layer_lean.cu's gates instance): the plan's
    choice, launched (counted at its library's launch site), bit for bit on
    repeat, beside the same launch without its step barrier (stale h),
    which must fail ``tol`` against the plain result ``ref``; and the
    per-step kernel (csrc/lstm_layer_train.cu) launched past the plan on
    the same inputs, against ``ref``."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    B_ = xp.shape[1]
    plan = tlt.lean_plan(B_, H, torch.cuda.get_device_properties(0).multi_processor_count,
                         x_f32=True)
    if plan["kernel"] != "persistent":
        fail(f"{tag}: the plan does not send the layered step's batch to the persistent "
             f"forward: {plan}")
    before = tlt.recurrence_train.persistent_launches
    got, again = tlt.recurrence_train(xp, *tail), tlt.recurrence_train(xp, *tail)
    torch.cuda.synchronize()
    launched = tlt.recurrence_train.persistent_launches - before
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    checks.append({"check": f"{tag} persistent (grid {plan['grid']}): bit for bit on repeat",
                   "equal": same, "persistent_launches": launched})
    if launched != 2:
        fail(f"{tag}: {launched} persistent launches in two calls")
    if not same:
        fail(f"{tag}: two calls on the same inputs differ")
    del got, again
    _fault_check(f"{tag}: step barrier left out (stale h)",
                 tlt._train_persistent_launch(xp, *tail[:4], plan, skip_barrier=1), ref, tol,
                 checks)
    got = tlt._forward_launch("lstm_layer_train", xp, *tail, True)
    torch.cuda.synchronize()
    _rel_check(f"{tag} per-step kernel (launched past the plan)", got, ref, tol, checks)


def _train_past_plan_check(checks):
    """The gates-mode forward at B=260 (two row groups of three tiles: no
    ring stage fits beside the W_h slice and the f32 x_proj buffers) on the
    per-step kernel, the plan's choice, against its plain version at T=16,
    ragged lengths with a zero-length row: no persistent launch."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf, T, Bn = torch.bfloat16, 16, 260
    plan = tlt.lean_plan(Bn, H, torch.cuda.get_device_properties(0).multi_processor_count,
                         x_f32=True)
    if plan["kernel"] != "per_step":
        fail(f"recurrence_train B={Bn}: expected the per-step kernel past the plan, got {plan}")
    lens = [0 if b == 2 else (T - (31 * b) % (T // 2 + 1) if b % 9 else T) for b in range(Bn)]
    inp = _layer_inputs(T, Bn, lens, seed=148)
    tail = (inp["w_h"], inp["mask"], inp["h0"], inp["c0"], bf)
    before = tlt.recurrence_train.persistent_launches
    got = tlt.recurrence_train(inp["x_proj"], *tail)
    ref = tlt.recurrence_train_plain(inp["x_proj"], *tail)
    torch.cuda.synchronize()
    _rel_check(f"recurrence_train H={H} B={Bn} T={T} past the plan (per-step kernel)", got, ref,
               TRAIN_TOL_SHORT, checks)
    if tlt.recurrence_train.persistent_launches != before:
        fail(f"recurrence_train B={Bn}: ran the persistent kernel past its plan")


def _bwd_persistent_checks(tag, dout, gates, cseq, c0r, btail, ref, tol, checks):
    """The gates-mode backward at the layered step's batch on its persistent
    kernel (row 6: csrc/lstm_layer_bwd_persistent.cu): the plan's choice,
    launched (counted at its library's launch site), bit for bit on repeat,
    beside the same launch without its step barrier (stale dgates), which
    must fail ``tol`` against the plain result ``ref``.  Overwrites
    ``gates`` with dgates; returns the first call's (dgates, dh0, dc0)."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    B_, H_ = cseq.shape[1:]
    plan = tlt.bwd_plan(B_, H_, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["kernel"] != "persistent":
        fail(f"{tag}: the plan does not send the layered step's batch to the persistent "
             f"backward: {plan}")
    before = tlt.recurrence_bwd.persistent_launches
    again = tlt.recurrence_bwd(dout, gates.clone(), cseq, c0r, *btail)
    bad = tlt._bwd_persistent_launch(dout, gates.clone(), cseq, c0r, *btail, plan,
                                     skip_barrier=1)
    got = tlt.recurrence_bwd(dout, gates, cseq, c0r, *btail)
    torch.cuda.synchronize()
    launched = tlt.recurrence_bwd.persistent_launches - before
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    checks.append({"check": f"{tag} persistent (grid {plan['grid']}): bit for bit on repeat",
                   "equal": same, "persistent_launches": launched})
    if launched != 2:
        fail(f"{tag}: {launched} persistent launches in two calls")
    if not same:
        fail(f"{tag}: two calls on the same inputs differ")
    del again
    _fault_check(f"{tag}: step barrier left out (stale dgates)", bad, ref, tol, checks)
    return got


def _bwd_past_plan_check(checks):
    """The gates-mode backward at B=70 (two row groups: 256 CTAs, past the
    card) on the per-step kernel against its plain version at T=16, ragged
    lengths with a zero-length row: the plan's choice, no persistent launch."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf, T, Bn = torch.bfloat16, 16, 70
    plan = tlt.bwd_plan(Bn, H, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["kernel"] != "per_step":
        fail(f"recurrence_bwd B={Bn}: expected the per-step kernel past the plan, got {plan}")
    lens = [0 if b == 2 else (T - (31 * b) % (T // 2 + 1) if b % 9 else T) for b in range(Bn)]
    inp = _layer_inputs(T, Bn, lens, seed=149)
    _, _, _, gates, cseq = tlt.recurrence_train_plain(inp["x_proj"], inp["w_h"], inp["mask"],
                                                      inp["h0"], inp["c0"], bf)
    c0r = inp["c0"].to(bf).float()
    btail = (inp["mask"], inp["w_h"], inp["dhn"], inp["dcn"])
    ref = tlt.recurrence_bwd_plain(inp["dout"], gates.clone(), cseq, c0r, *btail)
    before = tlt.recurrence_bwd.persistent_launches
    got = tlt.recurrence_bwd(inp["dout"], gates, cseq, c0r, *btail)
    torch.cuda.synchronize()
    _rel_check(f"recurrence_bwd H={H} B={Bn} T={T} past the plan (per-step kernel)", got, ref,
               TRAIN_TOL_SHORT, checks)
    if tlt.recurrence_bwd.persistent_launches != before:
        fail(f"recurrence_bwd B={Bn}: ran the persistent kernel past its plan")


def _lean_persistent_checks(checks, worst, batches):
    """The persistent lean forward (csrc/lstm_layer_lean.cu) at its path's
    shapes: H=1024, T=3510 and each batch of ``batches`` (the recompute
    step's B=400 and the widest recompute batch, B=473 on the H100), with
    ragged lengths and a zero-length row, against its plain version at
    TRAIN_TOL_LONG, bit for bit on repeat, the plan's choice checked;
    beside the kernel with its grid barrier left out (each CTA reads h
    without waiting for the others: stale h), which must fail the check."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf, T, name = torch.bfloat16, TRAIN_T, "recurrence_train_lean"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lim = (6.0 / (H + 4 * H)) ** 0.5
    for i, Bn in enumerate(batches):
        plan = tlt.lean_plan(Bn, H, sms)
        if plan["kernel"] != "persistent":
            fail(f"{name}: the plan does not send B={Bn}, H={H} to the persistent kernel: "
                 f"{plan}")
        g = torch.Generator(device=DEVICE).manual_seed(180 + i)
        xp = torch.empty((T, Bn, 4 * H), dtype=bf, device=DEVICE)
        for t0 in range(0, T, 256):
            xp[t0:t0 + 256] = torch.randn(xp[t0:t0 + 256].shape, generator=g,
                                          device=DEVICE) * 0.5
        w_h = ((torch.rand((H, 4 * H), generator=g, device=DEVICE) * 2 - 1) * lim).to(bf)
        h0 = torch.randn((Bn, H), generator=g, device=DEVICE) * 0.2
        c0 = torch.randn((Bn, H), generator=g, device=DEVICE) * 0.2
        lens = torch.as_tensor([max(0, T - (31 * b) % (T // 2 + 1)) if b % 9 else T
                                for b in range(Bn)])
        lens[2] = 0                                   # a zero-length row
        mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :].to(DEVICE)
        args = (xp, w_h, mask, h0, c0)
        tag = f"{name} persistent H={H} B={Bn} T={T} (grid {plan['grid']})"
        got = tlt.recurrence_train_lean(*args, bf)
        again = tlt.recurrence_train_lean(*args, bf)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        checks.append({"check": f"{tag}: bit for bit on repeat", "equal": same})
        if not same:
            fail(f"{tag}: two calls on the same inputs differ")
        ref = tlt.recurrence_train_lean_plain(*args, bf)
        worst[name] = max(worst[name], _rel_check(tag, got, ref, TRAIN_TOL_LONG, checks))
        del got
        _fault_check(f"{tag}: grid barrier left out (stale h)",
                     tlt._lean_persistent_launch(*args, plan, skip_barrier=1), ref,
                     TRAIN_TOL_LONG, checks)
        del ref, args, xp
        torch.cuda.empty_cache()


def _rebuild_product_check(checks, rec_B):
    """The recompute backward's rebuild product alone at one chunk of the
    route's batch (C·B rows, D = H = 1024; bf16 x and h_prev, xavier-uniform
    bf16 W_x and W_h, an f32 bias) against its plain version (relative
    Frobenius, REBUILD_TOL), bit for bit on repeat, beside the last K stage
    (64 columns of h_prev and rows of W_h) left out, which must fail the
    check.  Returns the error."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf = torch.bfloat16
    chunk = tlt.rebuild_chunk(TRAIN_T, rec_B, H)
    rows = chunk * rec_B
    g = torch.Generator().manual_seed(160)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim).to(DEVICE, bf)
    r = lambda *s, scale: (torch.randn(s, generator=g) * scale).to(DEVICE)
    args = (r(rows, H, scale=1.0).to(bf), r(rows, H, scale=0.5).to(bf), w(H, 4 * H),
            w(H, 4 * H), r(4 * H, scale=0.1))
    got = tlt.rebuild_gates(*args)
    again = tlt.rebuild_gates(*args)
    ref = tlt.rebuild_gates_plain(*args)
    torch.cuda.synchronize()
    rel = lambda a: float(torch.linalg.norm(a - ref) / torch.linalg.norm(ref))
    tag = f"rebuild_gates rows={rows} ({chunk} steps x B={rec_B}) D=H={H}"
    entry = {"check": tag, "rel_frobenius": rel(got), "tol": REBUILD_TOL,
             "bit_equal_on_repeat": bool(torch.equal(got, again)),
             "finite": bool(torch.isfinite(got).all())}
    checks.append(entry)
    if not entry["finite"] or entry["rel_frobenius"] > REBUILD_TOL or got.shape != ref.shape:
        fail(f"{tag}: kernel disagrees with its plain version: {entry}")
    if not entry["bit_equal_on_repeat"]:
        fail(f"{tag}: two calls on the same inputs differ")
    x, h_prev, w_x, w_h, b = args
    faulty = rel(tlt.rebuild_gates_plain(x, h_prev[:, :-64], w_x, w_h[:-64], b))
    checks.append({"planted_fault": f"{tag}: the last K stage (64) left out",
                   "rel_frobenius": faulty, "tol": REBUILD_TOL})
    if faulty <= REBUILD_TOL:
        fail(f"{tag}: the check does not see the planted fault ({faulty})")
    return entry["rel_frobenius"]


def phase_lean_study():
    """Where the persistent lean forward's step goes (opt-in): at B=400
    and B=64, T=3510 (full-length rows), its time a call; at B=400 also the
    per-step design, forced through ``lean_plan``, and the same launch
    without its step barrier (wrong results: the barrier's share)."""
    from unittest import mock

    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf, T = torch.bfloat16, TRAIN_T
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for Bn in (400, TRAIN_B):
        inp = _layer_inputs(T, Bn, [T] * Bn, seed=170, proj_dtype=bf)
        args = (inp["x_proj"], inp["w_h"], inp["mask"], inp["h0"], inp["c0"], bf)
        plan = tlt.lean_plan(Bn, H, sms)
        ms = cuda_ms(lambda: tlt.recurrence_train_lean(*args), iters=2)
        row = dict(plan=plan, ms_per_call=ms, us_per_step=1e3 * ms / T)
        if Bn == 400:
            with mock.patch.object(tlt, "lean_plan", lambda *a: {"kernel": "per_step"}):
                row["per_step_ms_per_call"] = cuda_ms(
                    lambda: tlt.recurrence_train_lean(*args), iters=2)
            row["no_barrier_ms_per_call"] = cuda_ms(lambda: tlt._lean_persistent_launch(
                *args[:5], plan, skip_barrier=1), iters=2)
        out[f"B={Bn}"] = row
        del inp, args
        torch.cuda.empty_cache()
    emit("lean_study", **out)


# Row 7's outputs on seeded inputs at T=512 and the recompute batches, row
# 2's at B=128, T=1024, and rows 5 and 3's at B=64, T=512 (row 3 in drop
# mode 2), as a SHA-256 of their bytes, by whichever package lies in the
# working directory (run in this checkout and in ``--parent``'s by
# ``persistent_study``), each with its persistent launches.
_PERSISTENT_DIGEST = r"""
import hashlib, json, sys
import torch
sys.path.insert(0, ".")
from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
H, T, bf = 1024, 512, torch.bfloat16
for B in (400, 473):
    g = torch.Generator(device="cuda").manual_seed(B)
    xp = (torch.randn((T, B, 4 * H), generator=g, device="cuda") * 0.5).to(bf)
    w_h = ((torch.rand((H, 4 * H), generator=g, device="cuda") * 2 - 1) * 0.035).to(bf)
    h0 = torch.randn((B, H), generator=g, device="cuda") * 0.2
    c0 = torch.randn((B, H), generator=g, device="cuda") * 0.2
    lens = torch.randint(0, T + 1, (B,), generator=g, device="cuda")
    mask = (torch.arange(T, device="cuda")[:, None] < lens[None]).float()[:, None, :]
    digest = hashlib.sha256()
    for t in tlt.recurrence_train_lean(xp, w_h, mask, h0, c0, bf):
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    print(json.dumps({"B": B, "sha256": digest.hexdigest(),
                      "persistent": tlt.recurrence_train_lean.persistent_launches}))
# Row 2 (the inference recurrence on f32 x_proj) at the serving shape.
from rnn_speech_tpu_torch.ops import lstm_recurrence as rec
B, T = 128, 1024
g = torch.Generator(device="cuda").manual_seed(B)
xp = torch.randn((T, B, 4 * H), generator=g, device="cuda") * 0.5
w_h = ((torch.rand((H, 4 * H), generator=g, device="cuda") * 2 - 1) * 0.035).to(bf)
h0 = torch.randn((B, H), generator=g, device="cuda") * 0.2
c0 = torch.randn((B, H), generator=g, device="cuda") * 0.2
lens = torch.randint(0, T + 1, (B,), generator=g, device="cuda")
mask = (torch.arange(T, device="cuda")[:, None] < lens[None]).float()[:, None, :]
digest = hashlib.sha256()
for t in rec.lstm_recurrence(xp, w_h, mask, h0, c0):
    digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
print(json.dumps({"B": "row2", "sha256": digest.hexdigest(),
                  "persistent": rec.lstm_recurrence.persistent_launches}))
# Rows 5 and 3 (the training forwards) at the default steps' batch.
from rnn_speech_tpu_torch.ops import lstm_wavefront as wf
B, T, L = 64, 512, 3
g = torch.Generator(device="cuda").manual_seed(B)
w = lambda *s: ((torch.rand(s, generator=g, device="cuda") * 2 - 1) * 0.035).to(bf)
r = lambda *s: torch.randn(s, generator=g, device="cuda") * 0.2
lens = torch.randint(0, T + 1, (B,), generator=g, device="cuda")
mask = (torch.arange(T, device="cuda")[:, None] < lens[None]).float()[:, None, :]
xp = torch.randn((T, B, 4 * H), generator=g, device="cuda") * 0.5
x = torch.randn((T, B, H), generator=g, device="cuda").to(bf)
stack = (x, w(H, 4 * H), w(L, H, 4 * H), w(L - 1, H, 4 * H), r(L, 4 * H), mask,
         r(L, B, H), r(L, B, H), bf, 2, (11, 13), 1.25, 0.8)
for name, fn, args in (("row5", tlt.recurrence_train, (xp, w(H, 4 * H), mask, r(B, H),
                                                         r(B, H), bf)),
                       ("row3", wf.wavefront_train, stack)):
    digest = hashlib.sha256()
    for t in fn(*args):
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    print(json.dumps({"B": name, "sha256": digest.hexdigest(),
                      "persistent": getattr(fn, "persistent_launches", 0)}))
"""


def _persistent_digests(root):
    """{B: (sha256, persistent launches)} of ``_PERSISTENT_DIGEST`` run in ``root``."""
    res = subprocess.run([sys.executable, "-c", _PERSISTENT_DIGEST], cwd=root,
                         capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        fail(f"persistent_study: the digests in {root} failed:\n{res.stderr[-2000:]}")
    rows = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    return {r["B"]: (r["sha256"], r["persistent"]) for r in rows}


def _bwd_step_breakdown(args, plan):
    """Where the persistent backward's step goes: CTA 0's SM clock at four
    points of every pass (the kernel's ``Args::stamps``; medians over the
    passes with a product and a cell), in cycles and in µs at the SM clock
    nvidia-smi reads right after."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    T = args[2].shape[0]
    stamps = torch.zeros((T + 1, 4), dtype=torch.int64, device=DEVICE)
    tlt._bwd_persistent_launch(*args, plan, stamps=stamps)
    torch.cuda.synchronize()
    return _stamp_breakdown(stamps, ("a_stream_and_product", "partial_exchange",
                                     "partial_sum_cell_and_arrive", "step_barrier"),
                            torch.arange(1, T))


def phase_persistent_study(parent=None):
    """The persistent redesigns beside the designs they replace (opt-in):
    row 6 at B=64, T=3510 and row 2 at B=128 and B=1, T=1024 (full-length
    rows), each a call on its persistent kernel, on the per-step kernel
    (forced through its plan) and without its step barrier (wrong results:
    the barrier's share); where the backward's step goes (CTA 0's SM clock
    at four points of each pass); how many clusters of 1, 2, 4 and 8 CTAs
    of the backward's size the card co-schedules (the reason its K split
    meets through L2); and, given ``parent`` (a checkout of the previous tree),
    rows 7, 2, 5 and 3's outputs there and here (``_PERSISTENT_DIGEST``),
    which must be equal bit for bit."""
    import ctypes
    from unittest import mock

    import torch

    from rnn_speech_tpu_torch.ops import _build
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec

    bf, sms = torch.bfloat16, torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    T = TRAIN_T
    inp = _layer_inputs(T, TRAIN_B, [T] * TRAIN_B, seed=171)
    _, _, _, gates, cseq = tlt.recurrence_train(inp["x_proj"], inp["w_h"], inp["mask"],
                                                inp["h0"], inp["c0"], bf)
    args = (inp["dout"], gates, cseq, inp["c0"].to(bf).float(), inp["mask"], inp["w_h"],
            inp["dhn"], inp["dcn"])
    plan = tlt.bwd_plan(TRAIN_B, H, sms)
    row = dict(plan=plan, ms_per_call=cuda_ms(lambda: tlt.recurrence_bwd(*args), iters=2))
    with mock.patch.object(tlt, "bwd_plan", lambda *a: {"kernel": "per_step"}):
        row["per_step_ms_per_call"] = cuda_ms(lambda: tlt.recurrence_bwd(*args), iters=2)
    row["no_barrier_ms_per_call"] = cuda_ms(
        lambda: tlt._bwd_persistent_launch(*args, plan, skip_barrier=1), iters=2)
    row["us_per_step"] = 1e3 * row["ms_per_call"] / T
    row["step_breakdown"] = _bwd_step_breakdown(args, plan)
    lib = _build.load("lstm_layer_bwd_persistent")
    lib.rst_layer_bwd_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.rst_layer_bwd_max_clusters.restype = ctypes.c_int
    row["max_active_clusters"] = {c: lib.rst_layer_bwd_max_clusters(c, H) for c in (1, 2, 4, 8)}
    out[f"recurrence_bwd B={TRAIN_B} T={T}"] = row
    del inp, gates, cseq, args
    torch.cuda.empty_cache()

    T = 1024
    for Bn in (B, 1):
        x = stack_inputs(T, Bn, 1, [T] * Bn, seed=172)
        call = (x["xp0"], x["w_h"][0], x["mask"], x["h0"][0], x["c0"][0])
        plan = rec.lean_plan(Bn, H, sms, x_f32=True)
        row = dict(plan=plan, ms_per_call=cuda_ms(lambda: rec.lstm_recurrence(*call)))
        with mock.patch.object(rec, "lean_plan", lambda *a, **k: {"kernel": "per_step"}):
            row["per_step_ms_per_call"] = cuda_ms(lambda: rec.lstm_recurrence(*call))
        row["no_barrier_ms_per_call"] = cuda_ms(
            lambda: rec._persistent_launch(*call, plan, skip_barrier=1))
        row["us_per_step"] = 1e3 * row["ms_per_call"] / T
        out[f"lstm_recurrence B={Bn} T={T}"] = row
        del x, call
    torch.cuda.empty_cache()
    out.update(_forward_studies(sms))
    out.update(_wavefront_studies(sms))
    if parent is not None:
        here, there = _persistent_digests(ROOT), _persistent_digests(os.path.abspath(parent))
        out["digests_against_parent"] = {"parent": parent, "here": here,
                                         "parent_digests": there}
        if set(here) != {400, 473, "row2", "row5", "row3"} or any(
                here[b][0] != there.get(b, ("",))[0] for b in here):
            fail(f"persistent_study: rows 7, 2, 5 and 3's outputs differ from the parent's: "
                 f"{here} {there}")
        if not all(v[1] for v in list(here.values()) + list(there.values())):
            fail("persistent_study: the digests did not all run the persistent kernels")
    emit("persistent_study", **out)


def _stamp_breakdown(stamps, names, mid):
    """Medians over the steps ``mid`` of the gaps between consecutive SM
    clock stamps (``stamps`` (steps, k) int64 on the device, each step's k
    points; the last gap runs to the next step's first point), in cycles
    and in µs at the SM clock nvidia-smi reads right after."""
    smi = smi_clocks()
    st = stamps.cpu().double()
    k = st.shape[1]
    med = lambda v: float(v.median())
    cycles = {names[i]: med(st[mid, i + 1] - st[mid, i]) for i in range(k - 1)}
    cycles[names[k - 1]] = med(st[mid + 1, 0] - st[mid, k - 1])
    cycles["step"] = med(st[mid + 1, 0] - st[mid, 0])
    mhz = float(smi.split(" MHz")[0])
    return dict(cycles=cycles, smi=smi, us={n: v / mhz for n, v in cycles.items()})


def _forward_studies(sms):
    """Rows 5 and 3 beside the designs they replace (persistent_study): the
    gates-mode forward at B=64, T=3510 (one call) and the wavefront training
    forward at B=64, T=3510 in drop mode 2 (one pass), each on its
    persistent kernel, on the per-step or per-diagonal kernel (forced
    through its plan) and without its waits (wrong results: their share),
    and where a step goes by SM-clock stamps: row 5's CTA 0 at four points
    (barrier passed, product done, cell stored, arrived), row 3's top layer's
    first CTA at five (step begun, x product done, first h box landed, h
    product done, cell stored and published)."""
    from unittest import mock

    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    bf, T, Bn = torch.bfloat16, TRAIN_T, TRAIN_B
    out = {}
    inp = _layer_inputs(T, Bn, [T] * Bn, seed=173)
    args = (inp["x_proj"], inp["w_h"], inp["mask"], inp["h0"], inp["c0"])
    plan = tlt.lean_plan(Bn, H, sms, x_f32=True)
    row = dict(plan=plan, ms_per_call=cuda_ms(lambda: tlt.recurrence_train(*args, bf), iters=2))
    with mock.patch.object(tlt, "lean_plan", lambda *a, **k: {"kernel": "per_step"}):
        row["per_step_ms_per_call"] = cuda_ms(lambda: tlt.recurrence_train(*args, bf), iters=2)
    row["no_barrier_ms_per_call"] = cuda_ms(
        lambda: tlt._train_persistent_launch(*args, plan, skip_barrier=1), iters=2)
    row["us_per_step"] = 1e3 * row["ms_per_call"] / T
    stamps = torch.zeros((T + 1, 4), dtype=torch.int64, device=DEVICE)
    tlt._train_persistent_launch(*args, plan, stamps=stamps)
    torch.cuda.synchronize()
    row["step_breakdown"] = _stamp_breakdown(
        stamps[:T], ("product", "cell_and_stores", "arrive", "step_barrier"),
        torch.arange(1, T - 1))
    out[f"recurrence_train B={Bn} T={T}"] = row
    del inp, args, stamps
    torch.cuda.empty_cache()

    inp = _train_inputs(T, Bn, [T] * Bn, seed=174)
    fargs = [inp[k] for k in FWD_ARGS]
    drop = _drop(2, T, Bn, 175)
    plan = wf.wavefront_plan(Bn, H, L, H, sms)
    run = lambda: wf.wavefront_train(*fargs, bf, *drop)
    row = dict(plan=plan, ms_per_pass=cuda_ms(run, iters=2))
    with mock.patch.object(wf, "wavefront_plan", lambda *a, **k: {"kernel": "per_diagonal"}):
        row["per_diagonal_ms_per_pass"] = cuda_ms(run, iters=2)
    launch = wf._drop_launch_args(2, drop[1], drop[3], drop[2], None, None)
    row["no_waits_ms_per_pass"] = cuda_ms(
        lambda: wf._persistent_launch(*fargs, (2, *launch), plan, skip_waits=1), iters=2)
    row["us_per_diagonal"] = 1e3 * row["ms_per_pass"] / (T + L - 1)
    stamps = torch.zeros((T, 5), dtype=torch.int64, device=DEVICE)
    wf._persistent_launch(*fargs, (2, *launch), plan, stamps=stamps)
    torch.cuda.synchronize()
    row["step_breakdown"] = _stamp_breakdown(
        stamps, ("x_product", "h_first_box", "h_product", "cell_store_publish", "to_next_step"),
        torch.arange(1, T - 1))
    out[f"wavefront_train B={Bn} T={T} mode 2"] = row
    return out


def _wavefront_studies(sms):
    """Rows 1 and 4 beside the designs they replace (persistent_study): the
    inference forward at B=128 and B=1, T=1024 (one call) and the reverse
    diagonal at B=64, T=3510 in drop mode 2 (one pass; each call writes
    dgates over its gates, and the later calls run on them: the same work),
    each on its persistent kernel, on the per-diagonal kernel (forced
    through its plan) and without its waits (wrong results: their share),
    and where a step goes by SM-clock stamps: row 1's top layer's first CTA
    at five points (step begun, x product done, first h box landed, h
    product done, cell stored and published), row 4's CTA 0 (layer 0) at
    five (pass begun, dout product stored, carry product stored, the
    slice's partials all arrived, cell stored and published)."""
    from unittest import mock

    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    bf, out = torch.bfloat16, {}
    T = 1024
    names = ("x_product", "h_first_box", "h_product", "cell_store_publish", "to_next_step")
    for Bn in (B, 1):
        x = stack_inputs(T, Bn, L, [T] * Bn, seed=176)
        args = [x[k] for k in ("xp0", "w_h", "w_x_rest", "b_rest", "mask", "h0", "c0")]
        plan = wf.wavefront_eval_plan(Bn, H, L, sms)
        with torch.no_grad():
            row = dict(plan=plan, ms_per_call=cuda_ms(lambda: wf.lstm_stack_wavefront(*args)))
            with mock.patch.object(wf, "wavefront_eval_plan",
                                   lambda *a, **k: {"kernel": "per_diagonal"}):
                row["per_diagonal_ms_per_call"] = cuda_ms(lambda: wf.lstm_stack_wavefront(*args))
            row["no_waits_ms_per_call"] = cuda_ms(
                lambda: wf._eval_persistent_launch(*args, plan, skip_waits=1))
            row["us_per_diagonal"] = 1e3 * row["ms_per_call"] / (T + L - 1)
            stamps = torch.zeros((T, 5), dtype=torch.int64, device=DEVICE)
            wf._eval_persistent_launch(*args, plan, stamps=stamps)
            torch.cuda.synchronize()
        row["step_breakdown"] = _stamp_breakdown(stamps, names, torch.arange(1, T - 1))
        out[f"lstm_wavefront B={Bn} T={T}"] = row
        del x, args, stamps
    torch.cuda.empty_cache()

    T, Bn = TRAIN_T, TRAIN_B
    inp = _train_inputs(T, Bn, [T] * Bn, seed=177)
    drop = _drop(2, T, Bn, 178)
    outs, gates, cseq, _, _ = wf.wavefront_train(*[inp[k] for k in FWD_ARGS], bf, *drop)
    b_in = _bwd_inputs(inp, outs, gates, cseq, seed=179)
    bargs = [b_in[k] for k in BWD_ARGS] + [outs]
    plan = wf.wavefront_bwd_plan(Bn, H, L, False, sms)
    run = lambda: wf.wavefront_bwd(*bargs, *drop)
    row = dict(plan=plan, ms_per_pass=cuda_ms(run, iters=2))
    with mock.patch.object(wf, "wavefront_bwd_plan", lambda *a, **k: {"kernel": "per_diagonal"}):
        row["per_diagonal_ms_per_pass"] = cuda_ms(run, iters=2)
    launch = (2, *wf._drop_launch_args(2, drop[1], drop[3], drop[2], None, None))
    row["no_waits_ms_per_pass"] = cuda_ms(
        lambda: wf._bwd_persistent_launch(*bargs, launch, plan, skip_waits=1), iters=2)
    row["us_per_diagonal"] = 1e3 * row["ms_per_pass"] / (T + L - 1)
    stamps = torch.zeros((T + 1, 5), dtype=torch.int64, device=DEVICE)
    wf._bwd_persistent_launch(*bargs, launch, plan, stamps=stamps)
    torch.cuda.synchronize()
    row["step_breakdown"] = _stamp_breakdown(
        stamps, ("dout_product", "carry_product", "partial_exchange", "sum_cell_publish",
                 "to_next_pass"), torch.arange(1, T - 1))
    out[f"wavefront_bwd B={Bn} T={T} mode 2"] = row
    return out


def _layer_kernel_timing(rec_B):
    """Each layered kernel alone at its route's shapes (full-length rows,
    T=3510): the gates-mode pair at B=64 (the layered default step), the
    recompute pair at ``rec_B`` (the recompute step).  Times are per train
    step: L calls of one layer each (``ms_per_call`` beside).  The library
    yardstick is torch.nn.LSTM with one layer at the same T and B: its
    cuDNN forward for the forwards (which also computes the input
    product), in turns with each, for the backwards
    its backward without weight gradients (``library_ms``; it still
    computes dx) and with them (``library_wgrad_ms``), both on one forward
    graph in turns with the kernel."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf, T, G = torch.bfloat16, TRAIN_T, 4 * H
    out = {}
    for (fwd_name, bwd_name), Bn in ((("recurrence_train", "recurrence_bwd"), TRAIN_B),
                                     (("recurrence_train_lean", "recurrence_bwd_recompute"),
                                      rec_B)):
        lean = fwd_name.endswith("lean")
        inp = _layer_inputs(T, Bn, [T] * Bn, seed=170, proj_dtype=bf if lean else None)
        tail = (inp["w_h"], inp["mask"], inp["h0"], inp["c0"], bf)
        xp = inp["x_proj"]
        fwd, fwd_plain = getattr(tlt, fwd_name), getattr(tlt, fwd_name + "_plain")
        # The persistent kernels in turns with cuDNN's one-layer forward.
        turns = in_turns(_nn_lstm_forward(T, Bn), lambda: fwd(xp, *tail), iters=2)
        ms, lib_fwd = turns["ms"], turns["library_ms"]
        plan = tlt.lean_plan(Bn, H, torch.cuda.get_device_properties(0).multi_processor_count,
                             x_f32=not lean)
        extra = dict(turns=turns["turns"], plan=plan, us_per_step=1e3 * ms / T)
        torch.cuda.empty_cache()
        plain = cuda_ms(lambda: fwd_plain(xp, *tail), iters=1, warmup=0)
        res = fwd(xp, *tail)
        states = 2 * Bn * H * 4                      # h0 and c0, or hn and cn
        streams = T * Bn * H * (4 + 2)               # out f32, cseq bf16
        nbytes = (T * Bn * G * xp.element_size() + H * G * 2 + T * Bn * 4 + 2 * states
                  + streams + (0 if lean else T * Bn * G * 2))
        bound, by = _bounds(2 * T * Bn * H * G, nbytes)
        out[fwd_name] = dict(ms=L * ms, plain_ms=L * plain, bound_ms=L * bound, bound_by=by,
                             library_ms=L * lib_fwd,
                             library="torch.nn.LSTM forward (1 layer, in turns)",
                             calls=L, ms_per_call=ms, batch=Bn, flops=L * 2 * T * Bn * H * G,
                             bytes=L * nbytes, tflops=2 * T * Bn * H * G / ms / 1e9, **extra)
        del xp
        inp.pop("x_proj")
        c0r = inp["c0"].to(bf).float()
        if lean:
            h_prev = torch.cat([inp["h0"].to(bf)[None], res[0].to(bf)[:-1]])
            cseq = res[3]
            del res
            args = (inp["dout"], inp["x"], h_prev, cseq, c0r, inp["mask"], inp["w_x"],
                    inp["b"], inp["w_h"], inp["dhn"], inp["dcn"])
            no_dw, with_dw = _nn_lstm_backward(T, Bn)
            turns = in_turns(no_dw, lambda: tlt.recurrence_bwd_recompute(*args), iters=2,
                             library_wgrad=with_dw)
            del no_dw, with_dw
            ms = turns["ms"]
            torch.cuda.empty_cache()
            plain = cuda_ms(lambda: tlt.recurrence_bwd_recompute_plain(*args), iters=1,
                            warmup=0)
            rebuild = _rebuild_timing(inp["x"], h_prev, inp["w_x"], inp["w_h"], inp["b"])
            flops = 2 * T * Bn * G * (2 * H + H)
            nbytes = (T * Bn * H * (4 + 2 + 2 + 2) + 2 * H * G * 2 + G * 4 + T * Bn * 4
                      + 3 * Bn * H * 4 + T * Bn * G * 2 + 2 * Bn * H * 4)
        else:
            gates, cseq = res[3], res[4]
            del res
            btail = (inp["mask"], inp["w_h"], inp["dhn"], inp["dcn"])
            # Each call writes dgates over its gates: the plain version gets
            # a copy of the residual, the kernel's later calls run on dgates
            # (the same work).
            pgates = gates.clone()
            no_dw, with_dw = _nn_lstm_backward(T, Bn)
            turns = in_turns(no_dw,
                             lambda: tlt.recurrence_bwd(inp["dout"], gates, cseq, c0r, *btail),
                             iters=2, library_wgrad=with_dw)
            del no_dw, with_dw
            ms = turns["ms"]
            torch.cuda.empty_cache()
            plain = cuda_ms(lambda: tlt.recurrence_bwd_plain(inp["dout"], pgates, cseq, c0r,
                                                             *btail), iters=1, warmup=0)
            del gates, pgates
            flops = 2 * T * Bn * G * H
            nbytes = (T * Bn * H * (4 + 2) + T * Bn * G * 2 + H * G * 2 + T * Bn * 4
                      + 3 * Bn * H * 4 + T * Bn * G * 2 + 2 * Bn * H * 4)
        bound, by = _bounds(flops, nbytes)
        out[bwd_name] = dict(ms=L * ms, plain_ms=L * plain, bound_ms=L * bound, bound_by=by,
                             library_ms=L * turns["library_ms"], library="torch.nn.LSTM "
                             "backward (1 layer, without weight gradients, in turns)",
                             library_wgrad_ms=L * turns["library_wgrad_ms"], calls=L,
                             ms_per_call=ms, us_per_step=1e3 * ms / T, batch=Bn, flops=L * flops,
                             bytes=L * nbytes, turns=turns["turns"])
        out[bwd_name]["tflops"] = flops / ms / 1e9
        if lean:
            # Row 8 split: its rebuild products, all chunks of the call's
            # own operands; the chain's share is the difference (derived).
            rb = L * rebuild["call_ms"]
            out[bwd_name].update(rebuild_ms=rb, rebuild_tflops=rebuild["call_tflops"],
                                 chain_ms_derived=L * ms - rb, rebuild=rebuild)
        del inp, cseq
        torch.cuda.empty_cache()
    return out


def _rebuild_timing(x, h_prev, w_x, w_h, b):
    """The recompute backward's rebuild products alone on one call's x and
    h_prev (T, B, ·): ``call_ms``, every chunk of ``rebuild_chunks`` in the
    kernel's order between two CUDA events, and its TFLOP/s; and the
    chunk of steps [0, C) (a whole chunk, launched last) in turns with
    ``torch.mm`` of the same product ([x | h_prev] · [W_x ; W_h], float32
    result, no activations), beside the card's clocks."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    T, Bn, D = x.shape
    chunk = tlt.rebuild_chunk(T, Bn, H)
    chunks = tlt.rebuild_chunks(T, chunk)
    parts = [(x[t0:t1].reshape(-1, D), h_prev[t0:t1].reshape(-1, H)) for t0, t1 in chunks]

    def call():
        for xc, hc in parts:
            tlt.rebuild_gates(xc, hc, w_x, w_h, b)

    call_ms = cuda_ms(call, iters=2)
    x2, h2 = parts[-1]
    rows = x2.shape[0]
    a_cat, w_cat = torch.cat([x2, h2], dim=1), torch.cat([w_x, w_h])
    turns = in_turns(lambda: torch.mm(a_cat, w_cat, out_dtype=torch.float32),
                     lambda: tlt.rebuild_gates(x2, h2, w_x, w_h, b))
    flops = lambda r: 2 * r * (D + H) * 4 * H
    return dict(chunk_steps=chunk, chunks=len(chunks), call_ms=call_ms,
                call_tflops=flops(T * Bn) / call_ms / 1e9,
                whole_chunk=dict(rows=rows, ms=turns["ms"], library_ms=turns["library_ms"],
                                 tflops=flops(rows) / turns["ms"] / 1e9,
                                 library_tflops=flops(rows) / turns["library_ms"] / 1e9,
                                 turns=turns["turns"]),
                library="torch.mm([x | h_prev], [W_x ; W_h], out_dtype=float32)")


def phase_train_layered():
    import torch

    from rnn_speech_tpu_torch.models import acoustic

    # The recompute route where the default configuration's plan sends it.
    cfg = acoustic.AcousticConfig(num_layers=L, hidden_size=H, input_dim=120, num_labels=V,
                                  compute_dtype=torch.bfloat16, use_kernels=True,
                                  wavefront=True)
    rec_B = next(b for b in range(16, 4096, 16)
                 if acoustic.training_memory_plan(cfg, TRAIN_T, b) == (0, "recompute"))
    checks, worst = [], {k: 0.0 for k in LAYER_KERNELS}
    _layer_kernel_checks(checks, worst, rec_B)
    torch.cuda.empty_cache()
    wide_rec_B = _plan_edge(cfg, rec_B, "recompute")
    _lean_persistent_checks(checks, worst, (rec_B, wide_rec_B))

    scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=0, wavefront=False)
    plan = acoustic.training_memory_plan(scfg.model, TRAIN_T, TRAIN_B)
    layered, state = _run_steps(scfg, state, batch, reps=3, record_stages=True,
                                route="gates")
    losses = layered["losses"]
    if not sum(losses[-3:]) / 3 < losses[0]:
        fail(f"train_layered: the mean of the last 3 losses is not below the first: {losses}")
    if not layered["wgmma_launches"]["bwd_persistent"]:
        fail("train_layered: the backward never ran the persistent kernel")
    if not layered["wgmma_launches"]["train_persistent"]:
        fail("train_layered: the forward never ran the persistent kernel")
    layered["memory_plan"] = list(plan)
    del state, batch
    torch.cuda.empty_cache()

    scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=0, Bn=rec_B,
                                      residual_mode="recompute")
    recompute, state = _run_steps(scfg, state, batch, reps=1, record_stages=True,
                                  route="recompute", warmup=1)
    if not recompute["losses"][-1] < recompute["losses"][0]:
        fail(f"train_layered (recompute): the loss did not fall: {recompute['losses']}")
    if not recompute["wgmma_launches"]["recompute_rebuild"]:
        fail("train_layered (recompute): the backward launched no rebuild product")
    if not recompute["wgmma_launches"]["lean_persistent"]:
        fail("train_layered (recompute): the forward never ran the persistent kernel")
    recompute.update(
        memory_plan=[0, "recompute"], budget_gib=acoustic.default_residual_budget() / 2**30,
        plan_estimate_gib=acoustic.recompute_footprint(cfg, TRAIN_T, rec_B) / 2**30,
        gates_estimate_gib=acoustic.training_residual_bytes(cfg, TRAIN_T, rec_B) / 2**30)
    del state, batch
    torch.cuda.empty_cache()
    timing = _layer_kernel_timing(rec_B)

    grads = {"recompute": _grad_check(**RECOMPUTE_GATE)}
    for name, model_kw, fault in (
            ("layered", dict(wavefront=False), _layer_fault("recurrence_bwd")),
            ("remat", dict(remat=True), _layer_fault("recurrence_bwd")),
            ("time_chunk", dict(time_chunk=LAYERED_CHUNK), _wavefront_fault)):
        grads[name] = _grad_check(model_kw=model_kw, fault=fault)
    emit("train_layered", checks=checks, max_abs_err=worst, frames=TRAIN_T,
         label_length=LABEL_LEN, keep_probs=[INPUT_KEEP, OUTPUT_KEEP], layered=layered,
         recompute=recompute, timing=timing, grad_check=grads)


@contextlib.contextmanager
def _environ(**env):
    """The environment variables ``env`` set inside the block, restored
    after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _drop_modes(seen):
    """Adds to ``seen`` the drop mode of every wavefront kernel launch."""
    from unittest import mock

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    launch_args = wf._drop_launch_args

    def recording(drop_mode, *args):
        seen.add(drop_mode)
        return launch_args(drop_mode, *args)

    with mock.patch.object(wf, "_drop_launch_args", recording):
        yield


def _beta_stream_fault():
    """The plain stream backward with label_post 1% too large: a planted
    fault."""
    from unittest import mock

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck

    plain = tck.beta_post_stream_plain
    return mock.patch.object(tck, "ctc_beta_post_stream", lambda *a: plain(*a[:7]) * 1.01)


def _alt_route_specs():
    """(name, environment, kernels that must launch, kernels that must not,
    planted fault of the gradient gate, drop modes of the wavefront
    kernels) of each route the switches select."""
    from rnn_speech_tpu_torch.ops import ctc_kernel as tck
    from rnn_speech_tpu_torch.ops import dropout as tdrop
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    base = _train_counters()
    without = lambda *names: {k: v for k, v in base.items() if k not in names}
    mask = {"bernoulli_mask": tdrop.bernoulli_mask}
    return (
        ("wavefront_bwd_off", {"RST_WAVEFRONT_BWD": "0"},
         {**without("wavefront_bwd"), **mask, "recurrence_bwd": tlt.recurrence_bwd},
         {"wavefront_bwd": wf.wavefront_bwd, "recurrence_train": tlt.recurrence_train},
         _layer_fault("recurrence_bwd"), {1}),
        ("seed_drop_off", {"RST_WAVEFRONT_SEED_DROP": "0"}, {**base, **mask},
         {"recurrence_bwd": tlt.recurrence_bwd}, _wavefront_fault, {1}),
        ("ctc_alpha_stream", {"RST_CTC_ALPHA_STREAM": "1"},
         {**without("ctc_beta_post"), "ctc_alpha_stream": tck.ctc_alpha_stream,
          "ctc_beta_post_stream": tck.ctc_beta_post_stream},
         {"ctc_beta_post": tck.ctc_beta_post, **mask}, _beta_stream_fault, {2}),
    )


def _kernel_frontend_eval():
    """The eval path at B=128 on 10.24 s clips with the fbank kernel: the
    kernel must launch and its features agree with the matmul frontend's
    (FBANK_TOL of their largest magnitude); throughput, and the stage split
    against the matmul frontend's, in turns (matmul, kernel, kernel,
    matmul)."""
    import torch

    from rnn_speech_tpu_torch import cli
    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    fe, cfg, params, audio, lengths = _eval_setup(True)
    fe_k = DeviceFrontend("fbank", sr=SR, max_samples=fe.max_samples, device="cuda",
                          use_kernel=True)
    with torch.no_grad():
        feats, _ = fe_k(audio, lengths)
        feats_p, _ = fe(audio, lengths)
        torch.cuda.synchronize()
        rel = float((feats - feats_p).abs().max() / feats_p.abs().max())
        del feats, feats_p
        # Only the eval path's own launches count from here.
        tfk.fbank_banks.launches = 0
        run = lambda: cli.infer(params, cfg, fe_k, audio, lengths)
        labels, lab_len = run()
        ref_labels, ref_len = cli.infer(params, cfg, fe, audio, lengths)
        med, spread, vals = _throughput(run)
        split = [_stage_ms(params, cfg, f, audio, lengths) for f in (fe, fe_k, fe_k, fe)]
    launches = tfk.fbank_banks.launches
    same_rows = sum(int(a == b) and bool(torch.equal(x[:a], y[:b]))
                    for x, y, a, b in zip(labels, ref_labels, lab_len.tolist(),
                                          ref_len.tolist()))
    entry = {"utt_per_s": med, "spread_pct": spread, "values": vals,
             "stage_ms_kernel": [split[1], split[2]], "stage_ms_matmul": [split[0], split[3]],
             "features_rel_err": rel, "tol": FBANK_TOL,
             "launches": {"fbank_banks": launches},
             "rows_decoded_as_with_the_matmul_frontend": same_rows}
    if not launches or rel > FBANK_TOL:
        fail(f"alt_routes: the eval path with the fbank kernel: {entry}")
    return entry


def _alt_kernel_timing():
    """The four kernels of these routes alone at their paths' shapes: the
    mask at the train step's (L-1, T, B, H) bf16 (one call a step), the
    alpha-stream pair at the CTC shape with full-length rows (one call
    each a step), the fbank kernel at the eval batch (B=128, 10.24 s):
    ms, the plain version's ms, one PyTorch call's ms and the bound.  The
    stream pair's bounds are bytes: the (T, B, S) float32 stream written
    once and read once, beside the log-probs and label_post; their
    operations are counted over the live lattice entries (the beta pass
    without the rebuild's CTC_ALPHA_OPS).  The fbank bound counts what the
    function needs, not the kernel's DFT product: per frame a real FFT of
    n_fft points, 5·(n_fft/2)·log2(n_fft) operations, the window's L_eff
    multiplies, 4 per bin for the scaled power and 2·bins·n_mels for the
    mel product, in float32; its bytes are the signal, the basis and the
    mel matrix read once and the banks written once."""
    import torch

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck
    from rnn_speech_tpu_torch.ops import dropout as tdrop
    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk

    bf, out = torch.bfloat16, {}
    seed = (31, 41)
    n = 1
    for d in MASK_SHAPE:
        n *= d
    out["bernoulli_mask"] = dict(
        ms=cuda_ms(lambda: tdrop.bernoulli_mask(seed, MASK_SHAPE, KEEP_PROB, bf, DEVICE)),
        plain_ms=cuda_ms(lambda: tdrop.bernoulli_mask_plain(seed, MASK_SHAPE, KEEP_PROB, bf,
                                                            DEVICE), iters=1, warmup=0),
        bound_ms=2 * n / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=cuda_ms(lambda: (torch.rand(MASK_SHAPE, device=DEVICE)
                                    < KEEP_PROB).to(bf)),
        library="(torch.rand(...) < keep).to(bf16)", bytes=2 * n, calls=1)

    T, Bn = TRAIN_T, TRAIN_B
    log_probs, ext, skip_ok, ll, ul, valid, targets = _ctc_timing_batch()
    args = (log_probs, ext, skip_ok, ll, ul)
    S = ext.shape[1]
    alphas, last = tck.ctc_alpha_stream(*args)
    logp = tck._loss(last, ul, valid)[1]
    lists = tck.label_lists(ext, ul, V)
    live = int((ll * (2 * ul + 1)).sum())
    lp_bytes, stream_bytes = T * Bn * V * 4, T * Bn * S * 4
    lib = _ctc_library(log_probs, targets, ll, ul)
    for name, run, plain, ops, nbytes, half in (
        ("ctc_alpha_stream", lambda: tck.ctc_alpha_stream(*args),
         lambda: tck.alpha_stream_plain(*args), CTC_ALPHA_OPS * live,
         lp_bytes + stream_bytes + Bn * S * 4, "forward"),
        ("ctc_beta_post_stream", lambda: tck.ctc_beta_post_stream(*args, logp, alphas, lists),
         lambda: tck.beta_post_stream_plain(*args, logp, alphas),
         (CTC_BETA_POST_OPS - CTC_ALPHA_OPS) * live, 2 * lp_bytes + stream_bytes, "backward"),
    ):
        out[name] = _ctc_row(run, plain, ops, nbytes, lib, half)
        out[name]["live_entries"] = live
    del log_probs, alphas, lib

    fe, pre, n_frames = _fbank_case(SR, [int(SR * SECONDS)] * B, SECONDS, seed=5)
    fargs = (pre, fe._basis, fe._mel, fe.frame_step, n_frames, fe.n_fft)
    bins, n_mels = fe._mel.shape
    l_eff = min(fe.frame_length, fe.n_fft)
    window = torch.hamming_window(fe.frame_length, periodic=False, device=DEVICE)[:fe.n_fft]
    eps = torch.full((), tfk.EPS, device=DEVICE)

    def stft_banks():
        spec = torch.stft(pre, fe.n_fft, fe.frame_step, window=window, center=False,
                          return_complex=True)
        power = spec.abs().square().transpose(1, 2) / fe.n_fft
        banks = torch.matmul(power, fe._mel)
        return 10.0 * torch.log10(torch.where(banks == 0.0, eps, banks))

    fft = 5 * (fe.n_fft // 2) * math.log2(fe.n_fft)
    flops = B * n_frames * (fft + l_eff + 4 * bins + 2 * bins * n_mels)
    nbytes = (pre.numel() + B * n_frames * n_mels + l_eff * 2 * bins + bins * n_mels) * 4
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    tables = tfk.kernel_tables(fe._basis, fe._mel, fe.n_fft)   # built once, as the frontend does
    out["fbank_banks"] = dict(
        ms=cuda_ms(lambda: tfk.fbank_banks(*fargs, tables=tables)),
        plain_ms=cuda_ms(lambda: tfk.fbank_banks_plain(*fargs)),
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=cuda_ms(stft_banks),
        library="torch.stft power -> matmul mel -> log10", flops=flops, bytes=nbytes,
        frames=n_frames)
    return out


def phase_alt_routes():
    import torch

    routes = {}
    for name, env, counters, idle, fault, modes in _alt_route_specs():
        with _environ(**env):
            scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=0)
            seen = set()
            with _drop_modes(seen):
                rec, state = _run_steps(scfg, state, batch, reps=1, record_stages=True,
                                        route=name, warmup=1, counters=counters, idle=idle)
            if seen != modes:
                fail(f"alt_routes {name}: the wavefront kernels ran drop modes "
                     f"{sorted(seen)}, expected {sorted(modes)}")
            del state, batch
            torch.cuda.empty_cache()
            rec.update(environment=env, drop_modes=sorted(seen),
                       grad_check=_grad_check(fault=fault))
        routes[name] = rec
        torch.cuda.empty_cache()
    eval_entry = _kernel_frontend_eval()
    torch.cuda.empty_cache()
    emit("alt_routes", frames=TRAIN_T, label_length=LABEL_LEN,
         keep_probs=[INPUT_KEEP, OUTPUT_KEEP], routes=routes, eval_fbank_kernel=eval_entry,
         timing=_alt_kernel_timing())


def _plan_edge(cfg, start, mode):
    """The largest batch from ``start`` up for which the memory plan on
    this card answers (0, ``mode``)."""
    from rnn_speech_tpu_torch.models import acoustic

    b = start
    while acoustic.training_memory_plan(cfg, TRAIN_T, b + 1) == (0, mode):
        b += 1
    return b


def _fused_pass_timing(Bn, plain):
    """The reverse pass with its fused dW_x alone at T=TRAIN_T, batch Bn,
    full-length rows, drop mode 2 (the default step's): ms beside the
    unfused pass's (``ms_unfused``) and its bound; its window products
    alone (``lstm_wavefront.dwx_windows``) in turns with the library
    yardstick, one torch.mm (bf16 operands, f32 out) per boundary for the
    same dW_x, on the same operands, beside the card's clocks; with
    ``plain`` also its plain version's ms.  The bound counts
    2·T·B·H·4H·(2L-1 + L-1) operations, or the bytes of the unfused pass's
    inputs and outputs without the xdrop stream plus the (L-1, H, 4H) f32
    dW_x.  Each call writes dgates over its gates residual: later calls
    run on dgates (the same work), the plain version on a copy."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    T, bf, f32, G = TRAIN_T, torch.bfloat16, torch.float32, 4 * H
    N = T * Bn
    inp = _train_inputs(T, Bn, [T] * Bn, seed=170)
    drop = _drop(2, T, Bn, 172)
    outs, gates, cseq, _, _ = wf.wavefront_train(*[inp[k] for k in FWD_ARGS], bf, *drop)
    b_in = _bwd_inputs(inp, outs, gates, cseq, seed=171)
    del inp, gates
    bargs = [b_in[k] for k in BWD_ARGS]
    out = {"batch": Bn, "frames": T, "drop_mode": 2}
    if plain:
        pargs = [b_in[k].clone() if k == "gates" else b_in[k] for k in BWD_ARGS]
        out["plain_ms"] = cuda_ms(lambda: wf.wavefront_bwd_plain(*pargs, outs, *drop,
                                                                 fuse_dwx=True),
                                  iters=1, warmup=0)
        del pargs
        torch.cuda.empty_cache()
    out["ms"] = cuda_ms(lambda: wf.wavefront_bwd(*bargs, outs, *drop, fuse_dwx=True),
                        iters=2)
    out["ms_unfused"] = cuda_ms(lambda: wf.wavefront_bwd(*bargs, outs, *drop), iters=2)
    # The window products alone (as drop mode 0 runs them, on the Hopper
    # tile) and the library yardstick, on the same operands in turns.
    dg = b_in["gates"]
    turns = in_turns(lambda: [torch.mm(outs[l].reshape(N, H).t(), dg[l + 1].reshape(N, G),
                                       out_dtype=f32) for l in range(L - 1)],
                     lambda: wf.dwx_windows(outs, dg), iters=2)
    wflops = 2 * T * Bn * H * G * (L - 1)
    out.update(window_products_ms=turns["ms"], window_products_tflops=wflops / turns["ms"] / 1e9,
               library_ms=turns["library_ms"], library_tflops=wflops / turns["library_ms"] / 1e9,
               library="torch.mm (bf16, f32 out) per boundary for dW_x of layers 1..L-1",
               turns=turns["turns"])
    flops = 2 * T * Bn * H * G * (2 * L - 1 + L - 1)
    nbytes = (T * Bn * H * 2 + (2 * L - 1) * H * G * 2 + T * Bn * 4
              + L * T * Bn * (G + H) * 2 + 3 * L * Bn * H * 4         # inputs
              + (L - 1) * T * Bn * H * 2                               # outs read
              + L * T * Bn * G * 2 + 2 * L * Bn * H * 4                # outputs
              + (L - 1) * H * G * 4)                                   # dW_x
    out["bound_ms"], out["bound_by"] = _bounds(flops, nbytes)
    out.update(flops=flops, bytes=nbytes)
    return out


def _fused_grad_gate(seed=2):
    """One step's gradients at T=GRAD_T through the kernels with the fused
    dW_x forced (RST_WAVEFRONT_FUSE_DWX=1) against the unfused route (=0)
    on the same seed words: relative Frobenius error per parameter tensor
    under GRAD_REL_TOL.  Beside it the fused route with dW_x's keep·scale
    left out (each boundary's dW_x from the undropped outs, a planted
    fault) must fail the gate."""
    from unittest import mock

    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf
    from rnn_speech_tpu_torch.params import flatten
    from rnn_speech_tpu_torch.train import step

    scfg, state, batch = _train_setup(GRAD_T, 100, 50, seed=seed)
    kernel = wf.wavefront_bwd

    def keep_left_out(*args, fuse_dwx=False):
        res = kernel(*args, fuse_dwx=fuse_dwx)
        if fuse_dwx:
            outs = args[9]
            for l in range(L - 1):
                res[3][l] = gm.weight_grad(outs[l], res[0][l + 1])[0]
        return res

    # The wrapper counts its launches on the module's name, here the fault.
    keep_left_out.launches = keep_left_out.fused_launches = keep_left_out.wgmma_products = 0
    grads, fused = {}, {}
    for name, flag, patch in (("unfused", "0", None), ("fused", "1", None),
                              ("planted_fault", "1", keep_left_out)):
        with contextlib.ExitStack() as stack:
            stack.enter_context(_environ(RST_WAVEFRONT_FUSE_DWX=flag))
            if patch is not None:
                stack.enter_context(mock.patch.object(wf, "wavefront_bwd", patch))
            wf.wavefront_bwd.fused_launches = 0
            _, g, _, _, _ = step.accumulate_grads(scfg, state["params"], state["states"],
                                                  batch, torch.Generator().manual_seed(seed + 1))
            torch.cuda.synchronize()
            fused[name] = wf.wavefront_bwd.fused_launches
        grads[name] = flatten(g)
    rel = lambda a, b: float((a - b).float().norm() / b.float().norm().clamp(min=1e-30))
    entry = {"T": GRAD_T, "seed": seed, "keep_probs": [INPUT_KEEP, OUTPUT_KEEP],
             "fused_launches": fused, "tol": GRAD_REL_TOL}
    if fused != {"unfused": 0, "fused": 1, "planted_fault": 1}:
        fail(f"train_wide: the gradient gate's routes did not run as set: {fused}")
    for name in ("fused", "planted_fault"):
        per = {k: rel(grads[name][k], grads["unfused"][k]) for k in grads["unfused"]}
        worst = max(per.values())
        entry[name] = {"rel_frobenius": per, "worst": worst,
                       "worst_tensor": max(per, key=per.get)}
        if name == "fused" and not worst <= GRAD_REL_TOL:
            fail(f"train_wide: fused-route gradients disagree with the unfused route: {entry}")
        if name == "planted_fault":
            entry[name]["over_limit"] = worst / GRAD_REL_TOL
            if not worst > GRAD_REL_TOL:
                fail(f"train_wide: the gradient gate does not see the planted fault: {entry}")
    return entry


def phase_train_wide():
    """The default step at the widest batch the plan sends to gates
    residuals, with the fused dW_x by its switch alone, then forced off
    (its peak and time, or that it does not fit); the B=64 step with
    the fused pass forced on and off in turns; the fused route's gradient
    gate; the recompute step at the widest batch the plan sends to
    recompute; the fused pass's timing."""
    import torch

    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    if os.environ.get("RST_WAVEFRONT_FUSE_DWX"):
        fail("train_wide: RST_WAVEFRONT_FUSE_DWX is set; the switch must decide alone")
    torch.cuda.empty_cache()
    cfg = acoustic.AcousticConfig(num_layers=L, hidden_size=H, input_dim=120, num_labels=V,
                                  compute_dtype=torch.bfloat16, use_kernels=True,
                                  wavefront=True)
    wide_B = _plan_edge(cfg, TRAIN_B, "gates")
    if not wf.fuse_dwx_enabled(L, TRAIN_T, wide_B, H, 2, 2):
        fail(f"train_wide: the switch does not fuse dW_x at B={wide_B}")
    scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=0, Bn=wide_B)
    wide, state = _run_steps(scfg, state, batch, reps=1, record_stages=True, warmup=1)
    if not wide["fused_launches"]:
        fail(f"train_wide: the B={wide_B} step did not run the fused pass: {wide}")
    if not (wide["wgmma_launches"]["weight_grad"] and wide["wgmma_launches"]["fused_windows"]):
        fail(f"train_wide: _hgrad_only's weight_grad or the fused windows never ran the "
             f"Hopper tile at B={wide_B}: {wide['wgmma_launches']}")
    card = torch.cuda.get_device_properties(0).total_memory
    wide.update(memory_plan=[0, "gates"], budget_gib=acoustic.default_residual_budget() / 2**30,
                gates_estimate_gib=acoustic.training_residual_bytes(
                    cfg, TRAIN_T, wide_B) / 2**30,
                card_gib=card / 2**30, headroom_gib=(card / 2**30 - wide["peak_memory_gib"]))
    # The same step with the fused dW_x forced off: its peak and time say
    # what the fused mode buys at this batch.  Whether it fits is what is
    # measured, so running out of memory is recorded, not a failure.
    torch.cuda.empty_cache()
    try:
        with _environ(RST_WAVEFRONT_FUSE_DWX="0"):
            rec, state = _run_steps(scfg, state, batch, reps=1, record_stages=False,
                                    warmup=1, per_rep=1)
        if rec["fused_launches"]:
            fail(f"train_wide: RST_WAVEFRONT_FUSE_DWX=0 ran {rec['fused_launches']} "
                 f"fused passes at B={wide_B}")
        wide_unfused = {"fits": True, **{k: rec[k] for k in (
            "train_ms_per_step", "train_utt_per_sec", "values_ms", "first_step_ms",
            "peak_memory_gib", "fused_launches", "launches")}}
    except torch.cuda.OutOfMemoryError as err:
        wide_unfused = {"fits": False, "error": str(err).splitlines()[0]}
    del state, batch
    torch.cuda.empty_cache()
    fused_wide = _fused_pass_timing(wide_B, plain=False)
    torch.cuda.empty_cache()

    scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=0)
    turns = []
    for flag in ("0", "1", "1", "0"):
        with _environ(RST_WAVEFRONT_FUSE_DWX=flag):
            rec, state = _run_steps(scfg, state, batch, reps=1, record_stages=True, warmup=1)
        if bool(rec["fused_launches"]) != (flag == "1"):
            fail(f"train_wide: RST_WAVEFRONT_FUSE_DWX={flag} ran {rec['fused_launches']} "
                 f"fused passes")
        turns.append({"fuse_dwx": flag, **{k: rec[k] for k in (
            "train_ms_per_step", "values_ms", "peak_memory_gib", "stage_ms",
            "fused_launches", "launches")}})
    del state, batch
    torch.cuda.empty_cache()
    grad_check = _fused_grad_gate()
    torch.cuda.empty_cache()

    if acoustic.training_memory_plan(cfg, TRAIN_T, wide_B + 1) != (0, "recompute"):
        fail(f"train_wide: the plan does not send B={wide_B + 1} to recompute residuals")
    rec_B = _plan_edge(cfg, wide_B + 1, "recompute")
    scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=0, Bn=rec_B,
                                      residual_mode="recompute")
    recompute, state = _run_steps(scfg, state, batch, reps=1, record_stages=False,
                                  route="recompute", warmup=1, per_rep=2)
    if not recompute["wgmma_launches"]["recompute_rebuild"]:
        fail("train_wide (recompute): the backward launched no rebuild product")
    if not recompute["wgmma_launches"]["lean_persistent"]:
        fail("train_wide (recompute): the forward never ran the persistent kernel")
    recompute.update(
        memory_plan=[0, "recompute"],
        plan_estimate_gib=acoustic.recompute_footprint(cfg, TRAIN_T, rec_B) / 2**30,
        card_gib=card / 2**30)
    del state, batch
    torch.cuda.empty_cache()
    timing = {"wavefront_bwd_fuse_dwx": _fused_pass_timing(max(FUSED_CHECK_B), plain=True)}
    torch.cuda.empty_cache()
    emit("train_wide", frames=TRAIN_T, label_length=LABEL_LEN,
         keep_probs=[INPUT_KEEP, OUTPUT_KEEP], wide=wide, wide_unfused=wide_unfused,
         fused_pass_wide=fused_wide,
         b64_turns=turns, grad_check=grad_check, recompute=recompute, timing=timing)


def phase_beam():
    """The beam search at the CLI's default width on the committed bundle's
    logits of the held-out clips, on the card and on the CPU; its time at
    B=1 and at the eval batch."""
    import numpy as np
    import torch

    from rnn_speech_tpu_torch import cli, params as params_mod
    from rnn_speech_tpu_torch.charmap import get_char_map
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops import decode
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    K = cli.DEFAULT_BEAM_WIDTH
    params = params_mod.load_bundle(BUNDLE, device=DEVICE)
    cfg = acoustic.config_for_params(params, compute_dtype=torch.bfloat16, use_kernels=True,
                                     wavefront=True)
    texts, sigs = _held_out()
    width = max(len(s) for s in sigs)
    audio = np.zeros((len(sigs), width), np.float32)
    for i, sig in enumerate(sigs):
        audio[i, : len(sig)] = sig
    lengths = np.asarray([len(sig) for sig in sigs], np.int32)
    fe = DeviceFrontend("fbank", sr=SR, max_samples=width, device=DEVICE)
    with torch.no_grad():
        feats, nf = fe(torch.as_tensor(audio, device=DEVICE),
                       torch.as_tensor(lengths, device=DEVICE))
        logits, _ = acoustic.forward(params, cfg, feats.transpose(0, 1), nf,
                                     acoustic.zero_state(cfg, len(sigs), device=DEVICE))
        out_len = acoustic.output_lengths(cfg, nf)
        labels, lab_len, scores = decode.beam_search_decode(logits, out_len, K)
        cpu = decode.beam_search_decode(logits.cpu(), out_len.cpu(), K)
        hyps_cli = cli.transcribe(params, cfg, audio, lengths, device=DEVICE)
    torch.cuda.synchronize()
    char_map = get_char_map("english")
    best, best_len = labels[:, 0].cpu(), lab_len[:, 0].cpu()
    hyps = [char_map.decode(list(best[b, : int(best_len[b])].numpy()))
            for b in range(len(sigs))]
    truth = [t.lower() for t in texts]
    cer = 100.0 * float(np.mean([_edit_distance(t, h.strip()) / max(len(t), 1)
                                 for t, h in zip(truth, hyps)]))
    entry = {"clips": len(sigs), "beam_width": K, "frames": int(logits.shape[0]),
             "cer_pct": cer, "cer_limit_pct": CER_LIMIT,
             "best_equal_cpu": bool(torch.equal(best, cpu[0][:, 0])
                                    and torch.equal(best_len, cpu[1][:, 0])),
             "all_beams_equal_cpu": bool(torch.equal(labels.cpu(), cpu[0])),
             "scores_max_abs_diff_cpu": float((scores.cpu() - cpu[2]).abs().max()),
             "cli_transcribe_equal": hyps == hyps_cli,
             "exact_clips": sum(int(t == h) for t, h in zip(truth, hyps)), "hyps": hyps}
    if cer > CER_LIMIT or not entry["best_equal_cpu"] or not entry["cli_transcribe_equal"]:
        fail(f"beam: {entry}")

    # The decode's time at B=1 (one clip, the --file case) and at the eval
    # batch (B=128, 10.24 s clips, random weights), beside greedy.
    timing = {}
    with torch.no_grad():
        timing["b1"] = {"frames": int(out_len[0]),
                        "ms": cuda_ms(lambda: decode.beam_search_decode(
                            logits[: int(out_len[0]), :1], out_len[:1], K), iters=3)}
        del params, logits, feats
        fe_e, cfg_e, params_e, audio_e, lengths_e = _eval_setup(True)
        feats_e, nf_e = fe_e(audio_e, lengths_e)
        logits_e, _ = acoustic.forward(params_e, cfg_e, feats_e.transpose(0, 1), nf_e,
                                       acoustic.zero_state(cfg_e, B, device=DEVICE))
        len_e = acoustic.output_lengths(cfg_e, nf_e)
        timing["eval_batch"] = {
            "batch": B, "frames": int(logits_e.shape[0]),
            "ms": cuda_ms(lambda: decode.beam_search_decode(logits_e, len_e, K), iters=2),
            "greedy_ms": cuda_ms(lambda: decode.greedy_decode(logits_e, len_e))}
    emit("beam", **entry, timing=timing)


def kernels_line():
    """One row per kernel.  ms, plain_ms, bound_ms and library_ms cover the
    kernel's work in one pass of its path: one eval batch (the two
    inference kernels), one default train step (the training, dropout and
    CTC kernels) or one ``eval_step`` batch (the loss-only CTC kernel).
    Launches are those of the main path's run: the eval phase, the
    default train step's 12 steps, the ``eval_step`` call; for the layered
    kernels one layered default step's pass and launches of its 12 steps
    (gates mode) or the recompute step's pass and its 5 steps; for the
    mask and the alpha-stream pair one step of the routes that run them
    and the launches of their 5 steps each (the mask on two routes), for
    the fbank kernel one eval batch and the launches of its eval run (the
    recurrence: one call of the L a layered batch makes, its persistent
    launches and µs a step beside; the gates-mode forward and backward:
    their persistent launches and µs a step, the backward's cuDNN backward
    with weight gradients beside the one without, ``library_ms``; the
    wavefront training forward: its persistent launches and µs a
    diagonal; the reverse diagonal: cuDNN's backward with weight gradients
    beside the one without); for
    the fused dW_x one reverse pass at B=96, T=3510 in drop mode 2 and the
    launches of the widest gates-residual step's 5 steps (train_wide).  The
    weight-gradient rows add their TFLOP/s, the fused row its window
    products' ms and TFLOP/s (its library_ms times the same dW_x), the
    layered rows their own TFLOP/s, and the recompute backward's row the
    ms and TFLOP/s of its rebuild products (``csrc/rebuild_gates.cuh``) on
    the call's own operands, every chunk."""
    ev = RECORD.get("eval", {})
    kn = RECORD.get("kernels", {})
    tr = RECORD.get("train", {})
    tk = RECORD.get("train_kernels", {})
    launches = {**tr.get("launches", {}),
                **tr.get("eval_step", {}).get("launches", {})}
    rows = []
    for name, src, replaces, kind in (
        ("lstm_wavefront", "rnn_speech_tpu_torch/csrc/lstm_wavefront_eval.cu",
         "rnn_speech_tpu/ops/lstm_wavefront.py:90", "wf"),
        ("lstm_recurrence", "rnn_speech_tpu_torch/csrc/lstm_layer_lean.cu",
         "rnn_speech_tpu/ops/lstm_pallas.py:62", "rec"),
    ):
        t = ev.get("timing", {}).get(name, {})
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": ev.get("launches", {}).get(name),
            "max_abs_err": kn.get("max_abs_err", {}).get(kind),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
        })
        if kind == "wf":
            rows[-1].update(persistent_launches=ev.get("launches", {}).get(
                "lstm_wavefront_persistent"), persistent_launches_b1=ev.get("launches", {}).get(
                "lstm_wavefront_persistent_b1"), us_per_diagonal=t.get("us_per_diagonal"),
                ms_b1=t.get("ms_b1"))
        if kind == "rec":                            # one call of the L a batch makes
            rows[-1].update(persistent_launches=ev.get("launches", {}).get(
                "lstm_recurrence_persistent"), us_per_step=t.get("us_per_step"),
                ms_b1=t.get("ms_b1"), library_ms_b1=t.get("library_ms_b1"))
    csrc = "rnn_speech_tpu_torch/csrc/"
    for name, src, replaces in (
        ("wavefront_train", csrc + "lstm_wavefront_persistent.cu",
         "rnn_speech_tpu/ops/lstm_wavefront.py:230"),
        ("wavefront_bwd", csrc + "lstm_wavefront_bwd_persistent.cu",
         "rnn_speech_tpu/ops/lstm_wavefront.py:433"),
        ("dgates_weight_grads", csrc + "grad_matmul.cu",
         "rnn_speech_tpu/ops/grad_matmul_pallas.py:52"),
        ("weight_grad", csrc + "grad_matmul.cu",
         "rnn_speech_tpu/ops/grad_matmul_pallas.py:96"),
        ("dropout", csrc + "dropout.cu", "rnn_speech_tpu/ops/dropout_pallas.py:55"),
        ("ctc_alpha_ckpt", csrc + "ctc.cu", "rnn_speech_tpu/ops/ctc_pallas.py:144"),
        ("ctc_alpha_lossonly", csrc + "ctc.cu", "rnn_speech_tpu/ops/ctc_pallas.py:137"),
        ("ctc_beta_post", csrc + "ctc.cu", "rnn_speech_tpu/ops/ctc_pallas.py:291"),
    ):
        t = tr.get("timing", {}).get(name, {})
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(name),
            "max_abs_err": tk.get("max_abs_err", {}).get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
        })
        if "tflops" in t:                            # the weight-gradient products
            rows[-1]["tflops"] = t["tflops"]
        if "library_pair_ms" in t:                   # CTC: the library's forward + backward
            rows[-1]["library_pair_ms"] = t["library_pair_ms"]
        if "library_wgrad_ms" in t:                  # the reverse diagonal: cuDNN with dW beside
            rows[-1]["library_wgrad_ms"] = t["library_wgrad_ms"]
        if name in ("wavefront_train", "wavefront_bwd"):
            rows[-1].update(persistent_launches=tr.get("wgmma_launches", {}).get(
                "wavefront_persistent" if name == "wavefront_train" else
                "wavefront_bwd_persistent"), us_per_diagonal=t.get("us_per_diagonal"))
    tl = RECORD.get("train_layered", {})
    for name, src, replaces, run in (
        ("recurrence_train", csrc + "lstm_layer_lean.cu",
         "rnn_speech_tpu/ops/lstm_pallas.py:144", "layered"),
        ("recurrence_bwd", csrc + "lstm_layer_bwd_persistent.cu",
         "rnn_speech_tpu/ops/lstm_pallas.py:232", "layered"),
        ("recurrence_train_lean", csrc + "lstm_layer_lean.cu",
         "rnn_speech_tpu/ops/lstm_pallas.py:342", "recompute"),
        ("recurrence_bwd_recompute", csrc + "lstm_layer_bwd.cu",
         "rnn_speech_tpu/ops/lstm_pallas.py:429", "recompute"),
    ):
        t = tl.get("timing", {}).get(name, {})
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": tl.get(run, {}).get("launches", {}).get(name),
            "max_abs_err": tl.get("max_abs_err", {}).get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
        })
        rows[-1]["tflops"] = t.get("tflops")
        if "library_wgrad_ms" in t:                  # the backwards: cuDNN with dW beside
            rows[-1].update(library_wgrad_ms=t["library_wgrad_ms"],
                            us_per_step=t.get("us_per_step"))
        if name in ("recurrence_bwd", "recurrence_train"):
            rows[-1].update(persistent_launches=tl.get(run, {}).get("wgmma_launches", {}).get(
                "bwd_persistent" if name == "recurrence_bwd" else "train_persistent"),
                us_per_step=t.get("us_per_step"))
        if "rebuild_ms" in t:                        # the recompute backward's rebuild
            rows[-1].update(rebuild_ms=t["rebuild_ms"], rebuild_tflops=t["rebuild_tflops"])
    tw = RECORD.get("train_wide", {})
    t = tw.get("timing", {}).get("wavefront_bwd_fuse_dwx", {})
    rows.append({
        "name": "wavefront_bwd_fuse_dwx", "route": "cuda",
        "source": csrc + "lstm_wavefront_bwd.cu",
        "replaces": "rnn_speech_tpu/ops/lstm_wavefront.py:574",
        "launches": tw.get("wide", {}).get("fused_launches"),
        "max_abs_err": tk.get("max_abs_err", {}).get("wavefront_bwd_fused"),
        "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
        "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
        "library_ms": t.get("library_ms"),
        "window_products_ms": t.get("window_products_ms"),
        "tflops": t.get("window_products_tflops"),
    })
    alt = RECORD.get("alt_routes", {})
    routes = alt.get("routes", {})
    route_launches = lambda name, *runs: (
        sum(routes[r]["launches"][name] for r in runs)
        if all(r in routes for r in runs) else None)
    for name, src, replaces, launched, errs in (
        ("bernoulli_mask", csrc + "dropout.cu", "rnn_speech_tpu/ops/dropout_pallas.py:122",
         route_launches("bernoulli_mask", "wavefront_bwd_off", "seed_drop_off"), tk),
        ("ctc_alpha_stream", csrc + "ctc.cu", "rnn_speech_tpu/ops/ctc_pallas.py:100",
         route_launches("ctc_alpha_stream", "ctc_alpha_stream"), tk),
        ("ctc_beta_post_stream", csrc + "ctc.cu", "rnn_speech_tpu/ops/ctc_pallas.py:247",
         route_launches("ctc_beta_post_stream", "ctc_alpha_stream"), tk),
        ("fbank_banks", csrc + "fbank.cu", "rnn_speech_tpu/ops/frontend_pallas.py:58",
         alt.get("eval_fbank_kernel", {}).get("launches", {}).get("fbank_banks"), kn),
    ):
        t = alt.get("timing", {}).get(name, {})
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launched,
            "max_abs_err": errs.get("max_abs_err", {}).get(
                "fbank" if name == "fbank_banks" else name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
        })
        if "library_pair_ms" in t:
            rows[-1]["library_pair_ms"] = t["library_pair_ms"]
    return {"kernels": rows}


PHASES = ("device", "build", "kernels", "train_kernels", "eval", "train", "train_layered",
          "alt_routes", "train_wide", "grad_study", "bundle", "beam", "cli")
OPT_IN_PHASES = ("lean_study", "persistent_study")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    parser.add_argument("--parent", default=None,
                        help="persistent_study: a checkout of the previous tree, whose "
                             "row 7 outputs must equal this one's bit for bit")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import rnn_speech_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the rnn_speech_tpu_torch package is missing: {exc}",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    for phase in phases:
        if phase not in PHASES + OPT_IN_PHASES:
            fail(f"unknown phase {phase!r}")
    seconds = RECORD.setdefault("phase_seconds", {})

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    for name, fn in (("device", phase_device), ("build", phase_build),
                     ("kernels", phase_kernels), ("train_kernels", phase_train_kernels),
                     ("eval", phase_eval), ("train", phase_train),
                     ("train_layered", phase_train_layered), ("alt_routes", phase_alt_routes),
                     ("train_wide", phase_train_wide), ("grad_study", phase_grad_study),
                     ("lean_study", phase_lean_study),
                     ("persistent_study", lambda: phase_persistent_study(args.parent))):
        if name in phases:
            timed(name, fn)
    held = None
    if "bundle" in phases or "cli" in phases:
        held = timed("bundle", phase_bundle)
    if "beam" in phases:
        timed("beam", phase_beam)
    if "cli" in phases:
        timed("cli", phase_cli, *held)
    kl = kernels_line()
    RECORD["total_seconds"] = time.perf_counter() - t_start
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"phases": RECORD, **kl}, fh, indent=1)
    print(json.dumps(kl), flush=True)
    print(nvidia_smi_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
