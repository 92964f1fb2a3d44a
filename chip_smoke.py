#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``rnn_speech_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--phases device,build,kernels,eval,bundle,cli]

Drives the port's serving path on a CUDA device and fails (non-zero exit,
no result line) on any failed check.  Phases, each printing one JSON line:

  device   card name and power limit (nvidia-smi), torch/CUDA versions;
           asserts float32 matmuls run without TF32.
  build    compiles both CUDA kernels from ``rnn_speech_tpu_torch/csrc``
           (one nvcc per source, in parallel) and prints the build time and
           each kernel's register/spill report.
  kernels  holds each kernel against its plain PyTorch version on the card
           at the serving shape (L=3, H=1024, B=128, T=1024: 10.24 s clips),
           with ragged lengths and non-zero initial state, strictly at small
           T, by logit argmax at T=1024, and at B=1.
  eval     random weights from a fixed torch.Generator, then fbank frontend
           -> 3x1024 bf16 forward -> greedy decode at B=128 on 10.24 s
           clips, through the wavefront kernel and through the layered
           recurrence kernel; launch counters are zeroed before this phase
           and must be non-zero after it.  Times the path's stages
           (frontend, forward, decode) on the stream, and each kernel at
           the path's shapes beside its bound, its plain version and
           torch.nn.LSTM.
  bundle   the committed trained bundle transcribes 32 rendered held-out
           sentences (sigma=900 noise) on the wavefront and layered kernel
           paths at CER <= 2%, and both equal the plain path's transcripts.
  cli      ``python -m rnn_speech_tpu_torch.cli --file`` on one rendered
           clip prints its text.

Then it prints the ``kernels`` JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.  It needs one card and ``nvcc``; it
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
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
ARGMAX_AGREE = 0.999
CER_LIMIT = 2.0          # percent; the bundle's recorded greedy CER is 0.06%

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
    emit("kernels", checks=checks, max_abs_err=worst)


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


def _nn_lstm_ms(inp, n_layers, T):
    """torch.nn.LSTM (cuDNN, bf16) with the kernels' weights and full-length
    rows, timed as a yardstick only.  Its gate order is (i, f, g, o), so the
    (i, g, f, o) columns are permuted and the +1 goes into the forget bias.
    It also computes layer 0's input product (random W_x0), which the
    kernels take precomputed in xp0."""
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
        x = torch.randn((T, B, H), device="cuda", dtype=torch.bfloat16)
        return cuda_ms(lambda: m(x))


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
    rec.lstm_recurrence.launches = 0
    wf.lstm_stack_wavefront.launches = 0
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
        results["wavefront" if wavefront else "layered"] = {
            "utt_per_s": med, "spread_pct": spread, "values": vals,
            "stage_ms": stages,
        }
    launches = {"lstm_wavefront": wf.lstm_stack_wavefront.launches,
                "lstm_recurrence": rec.lstm_recurrence.launches}
    if not all(launches.values()):
        fail(f"eval: the path did not go through every kernel: {launches}")

    # Each kernel alone at the path's shapes (full-length rows), and at
    # B=1, the ``--file`` batch, where the weights' reads dominate.
    T = fe._frames_for_width(int(SR * SECONDS))
    timing = {}
    with torch.no_grad():
        one = stack_inputs(T, 1, L, [T], seed=98)
        b1_ms = {"lstm_wavefront": cuda_ms(lambda: run_wavefront(one, wf.lstm_stack_wavefront)),
                 "lstm_recurrence": cuda_ms(lambda: run_recurrence(one, rec.lstm_recurrence))}
        inp = stack_inputs(T, B, L, [T] * B, seed=99)
        ms = cuda_ms(lambda: run_wavefront(inp, wf.lstm_stack_wavefront))
        plain = cuda_ms(lambda: run_wavefront(inp, wf.lstm_stack_wavefront_plain),
                        iters=1)
        flops = 2 * T * B * H * 4 * H * (2 * L - 1)
        nbytes = (T * B * 4 * H * 4 + (2 * L - 1) * H * 4 * H * 2
                  + (L - 1) * 4 * H * 4 + T * B * 4 + 4 * L * B * H * 4
                  + T * B * H * 4)
        bound, by = _bounds(flops, nbytes)
        timing["lstm_wavefront"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                        bound_by=by, library_ms=_nn_lstm_ms(inp, L, T),
                                        flops=flops, bytes=nbytes)
        ms = cuda_ms(lambda: run_recurrence(inp, rec.lstm_recurrence))
        plain = cuda_ms(lambda: run_recurrence(inp, rec.lstm_recurrence_plain),
                        iters=1)
        flops = 2 * T * B * H * 4 * H
        nbytes = (T * B * 4 * H * 4 + H * 4 * H * 2 + T * B * 4
                  + 4 * B * H * 4 + T * B * H * 4)
        bound, by = _bounds(flops, nbytes)
        timing["lstm_recurrence"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                         bound_by=by, library_ms=_nn_lstm_ms(inp, 1, T),
                                         flops=flops, bytes=nbytes)
    for name, ms in b1_ms.items():
        timing[name]["ms_b1"] = ms
    emit("eval", batch=B, seconds=SECONDS, frames=T, throughput=results,
         launches=launches, timing=timing,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)


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
    import numpy as np
    import torch

    from rnn_speech_tpu_torch import cli, params as params_mod
    from rnn_speech_tpu_torch.models import acoustic

    params = params_mod.load_bundle(BUNDLE, device="cuda")
    texts, sigs = _held_out()
    width = max(len(s) for s in sigs)
    audio = np.zeros((len(sigs), width), np.float32)
    for i, s in enumerate(sigs):
        audio[i, : len(s)] = s
    lengths = np.asarray([len(s) for s in sigs], np.int32)
    truth = [t.lower() for t in texts]
    out = {}
    for name, kw in (("wavefront", dict(use_kernels=True, wavefront=True)),
                     ("layered", dict(use_kernels=True, wavefront=False)),
                     ("plain", dict(use_kernels=False))):
        cfg = acoustic.config_for_params(params, compute_dtype=torch.bfloat16, **kw)
        with torch.no_grad():
            hyps = cli.transcribe(params, cfg, audio, lengths, device="cuda")
        cers = [_edit_distance(t, h.strip()) / max(len(t), 1)
                for t, h in zip(truth, hyps)]
        out[name] = {"hyps": hyps, "cer_pct": 100.0 * float(np.mean(cers))}
    for name in ("wavefront", "layered"):
        if out[name]["cer_pct"] > CER_LIMIT:
            fail(f"bundle: {name} CER {out[name]['cer_pct']:.3f}% > {CER_LIMIT}%")
        if out[name]["hyps"] != out["plain"]["hyps"]:
            fail(f"bundle: {name} transcripts differ from the plain path's")
    exact = [i for i, (t, h) in enumerate(zip(truth, out["wavefront"]["hyps"]))
             if t == h]
    emit("bundle", clips=len(texts), truth=truth,
         cer_pct={k: v["cer_pct"] for k, v in out.items()},
         exact_clips=len(exact), hyps=out["wavefront"]["hyps"])
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


def kernels_line():
    ev = RECORD.get("eval", {})
    kn = RECORD.get("kernels", {})
    rows = []
    for name, src, replaces, kind in (
        ("lstm_wavefront", "rnn_speech_tpu_torch/csrc/lstm_wavefront.cu",
         "rnn_speech_tpu/ops/lstm_wavefront.py:90", "wf"),
        ("lstm_recurrence", "rnn_speech_tpu_torch/csrc/lstm_recurrence.cu",
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
    return {"kernels": rows}


PHASES = ("device", "build", "kernels", "eval", "bundle", "cli")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
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
        if phase not in PHASES:
            fail(f"unknown phase {phase!r}")
    if "device" in phases:
        phase_device()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels()
    if "eval" in phases:
        phase_eval()
    if "bundle" in phases or "cli" in phases:
        held = phase_bundle()
        if "cli" in phases:
            phase_cli(*held)
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
