#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``rnn_speech_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--phases device,build,kernels,train_kernels,eval,train,train_layered,alt_routes,train_wide,f32_route,odd_shapes,hw_parity,train_loop,evaluate,bundle,accuracy,beam,cli,lm,stream,multi]
    python3 chip_smoke.py --phases device,build,grad_study   # opt-in, not in the default run
    python3 chip_smoke.py --phases device,build,lean_study   # opt-in, not in the default run
    python3 chip_smoke.py --phases device,build,persistent_study [--parent DIR]   # opt-in
    python3 chip_smoke.py --phases device,build,fault_hunt [--hunt_iters N]   # opt-in
    python3 chip_smoke.py --phases device,build,flagship_accuracy   # opt-in
    python3 chip_smoke.py --phases device,build,beam_quality   # opt-in
    python3 chip_smoke.py --phases device,build,accuracy_benchmark   # opt-in
    python3 chip_smoke.py --phases device,build,f32_designs   # opt-in

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
           A operands swapped, and one operand; projections on the skinny
           tile: D=120 f32 x G=1024 and D=1024 bf16 x G=80, each with f32
           and bf16 dg, and at a ragged N=100003, bit for bit on repeat,
           counted on the skinny path, beside one K slice left out);
           the three CTC kernels at B=64, T=3510, U=600 with labels of 250,
           a zero-length input and a label longer than its input (loss,
           checkpoints, last row, gradient; the backward bit for bit on
           repeat, beside its label sums filed one step late); the
           alpha forward's three modes (one kernel): its checkpoints bit
           for bit against its stream's rows at every block end, its last
           row against the loss-only mode's and the stream's, each within
           the CTC tolerance of its plain version, on the timing batch, a
           ragged batch (input lengths 1 to T, label lengths 0 to 600) and
           a batch of 1201 live states, each mode beside step 100 reading
           step 99's log-probs; the dropout kernel at
           (3510, 64, 1024) in float32 and bf16 (bit for bit, and the kept
           fraction within 4 sigma of the keep); the Bernoulli mask kernel
           at (2, 3510, 64, 1024) bf16 (bit for bit, the kept fraction
           within 4 sigma); the alpha-stream pair at the CTC shape (the
           stream's rows at every block end equal to the checkpoint
           kernel's, bit for bit, and its last row; the stream backward's
           gradient within the CTC tolerance of the checkpoint backward's);
           the reverse diagonal with its fused dW_x on the persistent
           kernel (the plan's choice) at T=16 (B=16, 96 and 200: two row
           groups in turn), 512 (B=16, 96) and 3510 (B=96), drop modes 0
           and 2 (dW_x per boundary, dgates, dh0 and dc0 against the plain
           version; dgates, dh0, dc0 bit for bit against the persistent
           unfused pass; in mode 0 dW_x bit for bit against
           ``dwx_windows`` of that pass's dgates; at T=512 beside the
           launches that leave their carries behind at a window's end);
           the training forward on its
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
           same plain results in every drop mode and T, and at B=70 (two
           warpgroups a CTA on the persistent kernel through the plan, and
           the per-diagonal kernel past it).
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
           the card's clocks; each projection's weight_grad in turns with
           torch.mm + sum and the WMMA tile it ran before, each call
           apart; the projections must all run the skinny tile; each CTC
           kernel in turns with its own half of
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
           its step barrier; and at B=70, two row groups in turn, with the
           per-step kernel called directly beside it; the gates-mode forward likewise on its persistent kernel
           at B=64 and at B=260 on the per-step kernel, the per-step kernel
           also at B=64 and every T, on the persistent kernel's inputs);
           the recompute backward also at its route's batch (B=400 on the
           H100, T=512) and at a chunk edge of its rebuild (T one step
           past a chunk, B=70), on its persistent kernel (the plan's choice:
           one launch a rebuild chunk, no per-step launch, bit for bit on
           repeat, beside the launch without its step and slice barriers) with the
           per-step kernel called directly beside it, and its rebuild
           product alone at one chunk
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
           products and its persistent kernel and no per-step launch, the
           forward its persistent kernel; the layered step's
           forward and backward their persistent kernels); each layered
           kernel's time at its route's shapes
           beside its bound, its plain version and torch.nn.LSTM (one
           layer; the forwards in turns with its forward, the
           backwards in turns with its backward without weight gradients,
           its backward with them beside, the backwards also in turns with
           their per-step kernels, the design they replaced; the gates-mode
           backward also at B=128 and the recompute backward at the widest
           recompute batch, B=473, in turns with the per-step kernel), the
           recompute backward's rebuild products on the
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
           fused pass must launch on the persistent kernel and no reverse
           pass on the per-diagonal one, and _hgrad_only's weight_grad and
           the window products on the Hopper tile) and the fused pass's
           time at that batch; the B=64 step with RST_WAVEFRONT_FUSE_DWX=1 against =0 in
           turns (off, on, on, off); one step's gradients at T=256 with the
           fused pass forced against the unfused route on the same seed
           words at 1e-3, beside a planted fault; the recompute step at the
           widest batch the plan sends to recompute residuals (B=473 on the
           H100; 1 warm-up, 2 timed, peak); the fused pass alone at B=96,
           T=3510 beside its bound, the unfused pass and its plain version;
           at both batches in turns with the per-diagonal fused pass and
           cuDNN's 3-layer backward with weight gradients (where it fits
           beside the pass's inputs; else alone after them), and its window
           products alone in turns with torch.mm for the same dW_x on the
           same operands.
  f32_route
           the float32 compute mode (the JAX kernels' compute_dtype=float32,
           float32 residuals) at the flagship width through models/acoustic
           and train/step: the eval path at B=128 on 10.24 s clips with the
           committed bundle's weights (the 32 held-out clips four times;
           the wavefront and the layered recurrence: utt/s, stages, greedy
           texts equal to the plain path's); the default step (B=64,
           T=3510, keeps 0.8/0.5, the CTC kernels; 2 warm-up, 3 timed, one
           split; a falling finite loss, peak memory); one step's gradients
           at T=256 against the plain versions' route within 1e-4 beside
           the planted fault, and the layered and recompute routes' at
           T=512 beside theirs; rows 1-8, 14 and 15 must run their float32
           modes, rows 3 and 4 their layer sweeps (a chain and an input
           product a layer a step for row 3), row 8 its float32 persistent
           kernel, row 15 the float32 skinny tile at both projections
           every step, and no bf16 persistent kernel, tensor-core tile,
           per-step recompute, per-diagonal training forward or reverse
           pass, or plain version may run on the card.  Then each of those
           rows alone at the float32 path's shapes against its plain version
           (1e-4 of each output's largest magnitude), timed in turns with
           cuDNN or torch.mm in float32 (TF32 off), beside its bound at 67
           TFLOP/s; row 8 at B=64 and B=400, T=512; row 3 also in drop
           modes 0 and 1 and mode 2 bit-equal to mode 1 fed its bits, its
           input products timed alone (the sweep's split); rows 3, 4, 8 and
           15 beside their planted faults (a partial left out of the
           chain's sum, the GEMM tile without its last K stage, a skinny K
           slice left out; the chains without their step wait or slice
           wait read, not gated).
  f32_designs (opt-in)
           f32_route's row timings and checks with rows 3, 4, 8 and 15 also
           in the same turns with the designs they replaced (the
           per-diagonal training forward and reverse pass, the per-step
           recompute backward at B=64 and B=400, T=512, the float32 tile at
           the projections).
  odd_shapes (a few s)
           rows 1-8 at H=100, D=72 (L=3, T=40, B=24; the wrappers pad to
           128 and slice back) in bf16 and float32, rows 3-8 in both mixed
           compute and residual modes, each against its plain version
           (relative Frobenius 1e-3, float32 1e-4), on its kernel.
  hw_parity
           ``rnn_speech_tpu_torch.tools.hw_parity`` in-process on the card:
           its seven checks with each error beside its tolerance, the
           kernels they launch (rows 1-8 in float32, 9, 10, 12, 14, 16,
           18), then each check under its planted fault, which must fail.
  grad_study (opt-in)
           that gradient check, gated the same way, at three seeds and at
           keep probabilities (1, 1), (0.8, 1), (1, 0.5) and (0.8, 0.5),
           per parameter tensor and for the cotangent that reaches the
           input projection: the readings that set its limit; and the
           recompute route's check and each alt route's (its switch set
           around it) at the same three seeds.  Seed 2 at the default
           keeps is also the gate of train, train_layered (recompute) and
           alt_routes: where that phase ran in the same run, its entry is
           read (the same computation), not taken again.
  train_loop (~60-80 s)
           ``python -m rnn_speech_tpu_torch.cli --train_acoustic`` at the
           flagship width of config.ini (3x1024, fbank, bf16; batch_size 10
           x mini_batch_size 3 fused to 30 rows, max_input_seq_length 3510,
           bucket_count 8, keeps 0.8/0.5, the CTC kernels, the wavefront) on
           a LibriSpeech-layout FLAC corpus rendered by the port's synth and
           FLAC encoder (90 train and 30 test clips of ~2-15 s at 16 kHz):
           6 steps from a fresh checkpoint_dir with a checkpoint and an
           evaluation pass every 3, then a second process resuming for 3
           more.  First builds the host runtime (g++, ``runtime/
           native_build.py``), decodes the first 8 train clips natively and
           with ``flac_py`` (bit for bit, both timed on one thread) and
           times the native loader over every train clip at
           ``default_decode_threads()``.  Each run is a child process that runs the CLI module as
           ``python -m`` does (``_cli_child``), with the launch counters
           zeroed first, CUDA events around every train and eval step and
           the input pipeline's waits timed.  Fails unless
           acousticmodel-{3,6,9}.npz and the pointer are written, the resume
           restores step 6 at the saved lr, the losses are finite, both runs
           write metrics lines and a TensorBoard event file, restoring the
           last bundle gives the final parameters bit for bit, rows 3,
           4, 9, 12, 14, 15, 16 and 10 (the evaluation pass) launch, and
           every batch of both runs came through the native loader
           (``pipeline.native_batches``).  Prints the loop's median ms a
           step (host included) beside the train phase's step, the
           device's idle share of the loop (CUDA events around each step),
           the pipeline's waits, and the decode and loader speeds.
  evaluate (~20 s)
           the bundle phase's 32 held-out clips written as a FLAC corpus
           (int16), then ``--evaluate`` on the committed bundle at beam
           widths 1 and 16 (one child process, two CLI runs): CER <= 2% at
           both, the greedy WER and CER equal to those of
           ``cli.transcribe`` on the same decoded audio in the same batch,
           row 1 launches, and every clip came through the native loader
           (``loader.delivered``).
  bundle   the committed trained bundle transcribes 32 rendered held-out
           sentences (sigma=900 noise) on the wavefront and layered kernel
           paths and through the fbank kernel at CER <= 2%, and all equal
           the plain path's transcripts.
  accuracy (~40-60 s)
           the port's accuracy tools at full width, cut in size only:
           ``tools/flagship_accuracy_run.run`` (3x1024, fbank-120, B=32,
           T <= 600, lr 1e-3, keeps 0.9/0.6) on 48 rendered training clips
           and 16 held-out ones, 20 steps with a checkpoint and an
           evaluation every 10, the LM at 1x256 for 10 steps, the exported
           bf16 bundle decoded at sigma 2400 and 4800 (greedy, beam 16,
           beam 16 with the LM at 0.4), streaming on 2 clips at 1.2 s
           chunks; then the committed bundle on 64 fresh clips
           (``beam_quality_run.fresh_held_out``) at both levels in the
           three modes.  Gates, each beside a planted fault that must fail
           it: every checkpoint window of the curves is there (a window
           dropped); the exported bundle restores and holds the final
           checkpoints rounded to bf16 bit for bit (one tensor moved by a
           bf16 step); each mode scores every clip (one clip unscored);
           rows 3, 4, 9, 12, 14, 15, 16 (the training steps), 10 (the
           evaluation cadence) and 1 (the decodes) launch, 3, 4 and 1 on
           their persistent kernels (row 10 silent); the committed bundle's
           greedy texts at sigma=2400 equal the plain path's
           (``use_pallas_lstm`` off; the top layer's outputs past frame 100
           left unstored).  Prints each stage's seconds.
  beam     the AM-only beam search at width 16 on the committed bundle's
           logits of the 32 held-out clips on the card: CER <= 2%, best
           beams equal to the same function's on the CPU on the same
           logits, and the decode's time at B=1 (a ``--file`` clip) and at
           the eval batch (B=128, T=1024).
  cli      ``python -m rnn_speech_tpu_torch.cli --file`` on one rendered
           clip prints its text (the default beam width, 16).
  lm       the char LM (the bundle's ``language/``, 1x256) by shallow
           fusion at weight 0.4 in the beam-16 search over the bundle's
           logits of the 32 held-out clips on the card: CER <= 2%, best
           beams equal to the same function's on the CPU on the same
           logits, row 1 launched by the forward; the search's ms a clip
           and a frame with and without the LM at B=32 and B=1, and one LM
           step at N = 512 and 2048 rows (B·K for B=32 and 128).  Then one
           CLI child: ``--evaluate --lm_weight 0.4`` on the clips as FLAC
           (CER <= 2%, row 1 launched at B=32), ``--file --lm_weight 0.4``
           on a clip the search got exactly (prints it; row 1 launched at
           B=1), ``--train_language --max_steps 20`` at config.ini's LM
           width (2x512, B=8, T <= 128) on a text corpus of the synth's
           sentences (finite losses, the last 5 below the first 5, the
           step-20 checkpoint written; ms a step), ``--generate_text``
           on that checkpoint and on the bundle, the latter equal to the
           CPU's.
  multi (~100 s)
           the multi-GPU path (``parallel/``) on the one card, three checks.
           One NCCL rank (world 1, ``spawn_ranks``) through
           ``make_sharded_step`` on a 1x1 mesh at the default step's width
           (B=64, T=3510, 3x1024, bf16, CTC kernels): at keep 1 one step's
           parameters and metrics bit-equal to the unsharded
           ``train_step``'s; at keeps 0.8/0.5 three steps with a finite,
           falling loss; the kernels of rows 3, 4, 9, 12, 14, 15 and 16
           launched by these sharded steps (the counts set to 0 after
           the reference step); each step's ms and the all-reduce's ms of
           a tree shaped as the gradients (25.4 M float32, ~101.5 MB) by
           CUDA events.  Two gloo ranks sharing the card over CUDA
           tensors, each 32 rows of the same 64-row batch at keep 1: the
           all-reduced gradients within GRAD_REL_TOL (relative Frobenius,
           per tensor) of the one-rank B=64 step's and the losses within
           1e-5; the all-reduce's ms on those gradients; one step's ms
           and launches (rows 3 and 4 must launch on each rank); each
           rank's peak memory.  Then ``python -m
           torch.distributed.run --standalone --nproc_per_node 1 -m
           rnn_speech_tpu_torch.cli``: ``--train_acoustic --mesh_data 0
           --timeline`` for 5 steps on a rendered FLAC corpus (24 + 8
           clips, train_loop's ini), which must write one checkpoint
           directory and one trace naming rows 3 and 4's kernels and the
           spans ``train``, ``host/put_batch`` and ``host/metrics_drain``;
           the trace's top 10 device ops, the device's idle share over the
           window and its longest idle gaps with the host span covering
           each; and ``--evaluate --mesh_data 0`` on the 32 held-out clips
           (greedy), whose CER must equal the plain ``--evaluate``'s.
  stream   ``cli.StreamingTranscriber`` (the ``--record`` engine) over 4
           held-out clips on the card, fed in chunks of 1.0 s and 0.3 s,
           greedy and beam-16 with the LM: the text identical across chunk
           sizes and equal to the CPU transcriber's, within max(2, 20%)
           characters of the whole-clip text (``cli.transcribe``, the
           ``--file`` math), and row 1 launched at B=1 with the state
           carried block to block; ms a chunk and audio seconds per wall
           second.
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
           inference recurrence's at B=128, T=1024, the two training
           forwards' and the unfused reverse diagonal's at B=64, T=512,
           and the CTC alpha forward's checkpoints, last row and stream
           at B=64, T=3510 (a full-length and a ragged batch) there and
           here, which must be equal bit for bit, and the reverse diagonal
           and the three CTC forwards at B=64, T=3510 (the CTC forwards
           also at the wide step's batch) timed there and here in turns;
           the gates-mode layer backward at B=64 (one row group: equal to
           the parent's bit for bit) and the recompute backward at B=400,
           T=512 (hashed in both trees; its carry product sums in another
           order than the parent's per-step kernel, so it is held to equal
           itself across runs, not the parent).
  fault_hunt (opt-in)
           the persistent kernels rebuilt with their bounds checks
           (RST_BOUNDS_CHECK=1: every global index and TMA box coordinate
           traps with its kernel, value and bound) and run under
           CUDA_LAUNCH_BLOCKING=1, in child processes: first a positive
           control (the recompute backward told its rebuild buffer is a
           step short, ``skip_barrier`` bit 4: it must trap with an
           RST_CHECK line in the checked build and run in the default
           one), then ``--hunt_iters`` times (5 by default): the
           reverse-diagonal and fused card tests
           (``tests/test_torch_cuda_kernels.py -k "bwd or fuse"``), phase
           ``train``, the layer backwards' checks at B=70, 128 and the
           recompute batch (``_hunt_layer_checks``), the float32 card tests
           (``tests/test_torch_cuda_f32_persistent.py``), the float32
           backwards' checks (``_hunt_f32_checks``) and the float32
           training forward's sweep and skinny tile's checks
           (``_hunt_f32_fwd_checks``); each iteration's
           outcome, the first trap or device assert it printed, and the
           tree's hash are recorded; fails if any run failed.
  flagship_accuracy (opt-in)
           ``flagship_accuracy_run``'s full protocol, 3000 steps: 1100 +
           160 rendered clips, 3x1024, B=32, the
           JAX artifact's levels 900-9600 (headline 2400), beam 16, the LM
           1x256 for 400 steps, streaming on 24 clips at 0.4 and 1.2 s;
           the artifact to chiprun_out/flagship_accuracy.json, each WER
           beside the JAX artifact's CI; fails above 2% greedy WER at
           sigma=2400.
  beam_quality (opt-in)
           ``beam_quality_run``'s defaults (the committed bundle, 600 fresh
           clips, sigma 2400-6000, beam 16, LM 0.4) into
           chiprun_out/beam_quality.json, each WER beside the JAX
           artifact's CI, then each level's greedy texts on the kernels
           against the plain path's (the clips that differ listed).
  accuracy_benchmark (opt-in)
           ``accuracy_benchmark`` with the committed artifact's arguments
           (300 letters clips, 2x256, B=16, 12 rounds of 200 steps) into
           chiprun_out/accuracy_curve.json, the kernels the plans pick at
           its shapes; fails unless it reaches its 15% target.
  Each opt-in protocol prints its stages' seconds (render, train, LM,
  export, decode, streaming) and its launches by row.

Before the phases it prints the tree's hash, ``{"tree_sha256": ...}``
(every file of the package and this script: ``_build.tree_digest``), also
kept in the record.  Then it prints the ``kernels`` JSON line, the card's
name and power limit,
and last ``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.  It needs one card and ``nvcc``; it
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
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


def device_ms(fn, reps: int = 10) -> float:
    """Device milliseconds of one ``fn()``: the kernels it launches, summed
    by torch.profiler (CUPTI) over ``reps`` calls after a warm-up, without
    the host's time between them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / reps / 1e3


# ----------------------------------------------------------------- inputs

def _rng(seed, on_device):
    """(rand, randn) from a generator seeded with ``seed``: on the host (the
    checks' inputs: the same bits on every card) or, for timing-only parts,
    on the card (the same distributions, other bits, no host time spent
    drawing billions of values)."""
    import torch

    dev = DEVICE if on_device else "cpu"
    g = torch.Generator(device=dev).manual_seed(seed)
    return (lambda *s: torch.rand(s, generator=g, device=dev),
            lambda *s: torch.randn(s, generator=g, device=dev))


def stack_inputs(T, Bn, n_layers, lengths, seed, on_device=False):
    """Random stack inputs on the card: bf16 weights (xavier-uniform),
    xp0 ~ N(0, 0.5), biases, non-zero h0/c0, the (T, 1, B) length mask;
    drawn on the card with ``on_device`` (``_rng``)."""
    import torch

    rand, randn = _rng(seed, on_device)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: ((rand(*s) * 2 - 1) * lim)
    dev = DEVICE
    lens = torch.as_tensor(lengths)
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :]
    return dict(
        xp0=(randn(T, Bn, 4 * H) * 0.5).to(dev),
        w_h=w(n_layers, H, 4 * H).to(dev, torch.bfloat16),
        w_x_rest=w(max(n_layers - 1, 0), H, 4 * H).to(dev, torch.bfloat16),
        b_rest=(randn(max(n_layers - 1, 0), 1, 4 * H) * 0.1).to(dev),
        mask=mask.to(dev),
        h0=(randn(n_layers, Bn, H) * 0.2).to(dev),
        c0=(randn(n_layers, Bn, H) * 0.2).to(dev),
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


def _nn_lstm(inp, n_layers, T, Bn=B, dtype=None):
    """One call of torch.nn.LSTM (cuDNN, bf16 or ``dtype``) with the
    kernels' weights on Bn full-length rows, a yardstick only.  Its gate
    order is (i, f, g, o), so the (i, g, f, o) columns are permuted and the
    +1 goes into the forget bias.  It also computes layer 0's input product
    (random W_x0), which the kernels take precomputed in xp0."""
    import torch

    dtype = dtype or torch.bfloat16
    m = torch.nn.LSTM(H, H, num_layers=n_layers).to("cuda", dtype)
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
        x = torch.randn((T, Bn, H), device="cuda", dtype=dtype)

    def call():
        with torch.no_grad():
            return m(x)

    return call


def _bounds(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
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
        one = stack_inputs(T, 1, L, [T], seed=98, on_device=True)
        wf_b1 = in_turns(per_diagonal(one), lambda: run_wavefront(one, wf.lstm_stack_wavefront))
        b1_turns = in_turns(_nn_lstm(one, 1, T, 1),
                            lambda: run_recurrence(one, rec.lstm_recurrence))
        inp = stack_inputs(T, B, L, [T] * B, seed=99, on_device=True)
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

def _rel_errs(got, ref, name=""):
    """(max abs errors, relative errors) of each output pair: the error
    over the plain result's own largest magnitude, gate by gate for
    outputs whose last axis holds the four gate blocks (i, g, f, o), so a
    small gate's term is held to its own scale.  Outputs of three or more
    axes are read one leading index at a time, so a float32 copy of a
    full-length dgates (15 GiB at B=96) is never formed.  Fails (naming
    ``name``) on a shape that differs or a value that is not finite."""
    import torch

    errs, rels = [], []
    for g, r in zip(got, ref):
        if g.shape != r.shape:
            fail(f"{name}: bad shape or non-finite output")
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
                    fail(f"{name}: bad shape or non-finite output")
                err[i] = max(err[i], float((gf - rf).abs().max()))
                scale[i] = max(scale[i], float(rf.abs().max()))
        errs.append(max(err))
        rels.append(max(e / s if s else (0.0 if e == 0 else float("inf"))
                        for e, s in zip(err, scale)))
    return errs, rels


def _rel_check(name, got, ref, tol, checks):
    """Fails when any relative error exceeds ``tol``; returns the largest
    absolute error."""
    errs, rels = _rel_errs(got, ref, name)
    entry = {"check": name, "max_abs_err": errs, "rel_err": rels, "tol": tol}
    checks.append(entry)
    if max(rels) > tol:
        fail(f"{name}: kernel disagrees with its plain version: {entry}")
    return max(errs)


def _fault_errs(faulty, ref, name=""):
    """The relative errors (``_rel_errs``) of a planted fault's outputs, or
    "non-finite" where one holds a value that is not finite (a stale read
    of a stream nothing has written yet): a result ``_rel_check`` fails."""
    import torch

    for f in faulty:
        parts = f.unbind(0) if f.dim() > 2 else (f,)
        if f.numel() and not all(bool(torch.isfinite(p).all()) for p in parts):
            return "non-finite"
    return _rel_errs(faulty, ref, name)[1]


def _fault_check(name, faulty, ref, tol, checks):
    """A fault planted in the plain version or a launch must fail the
    check at ``tol``: a relative error past it, or an output that is not
    finite."""
    rels = _fault_errs(faulty, ref, name)
    entry = {"planted_fault": name, "rel_err": rels, "tol": tol}
    checks.append(entry)
    if rels != "non-finite" and max(rels) <= tol:
        fail(f"{name}: the check does not see this planted fault: {entry}")


def _train_inputs(T, Bn, lengths, seed, on_device=False):
    """Full-width inputs of the training kernels on the card: bf16 x and
    xavier-uniform weights, f32 biases, non-zero h0/c0, the length mask;
    drawn on the card with ``on_device`` (``_rng``)."""
    import torch

    rand, randn = _rng(seed, on_device)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: ((rand(*s) * 2 - 1) * lim).to(DEVICE, torch.bfloat16)
    r = lambda *s, scale: (randn(*s) * scale).to(DEVICE)
    lens = torch.as_tensor(lengths)
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :].to(DEVICE)
    return dict(x=r(T, Bn, H, scale=1.0).to(torch.bfloat16), w_x0=w(H, 4 * H),
                w_h=w(L, H, 4 * H), w_x_rest=w(L - 1, H, 4 * H),
                b_all=r(L, 4 * H, scale=0.1), mask=mask, h0=r(L, Bn, H, scale=0.2),
                c0=r(L, Bn, H, scale=0.2))


FWD_ARGS = ("x", "w_x0", "w_h", "w_x_rest", "b_all", "mask", "h0", "c0")
BWD_ARGS = ("dout_top", "w_h", "w_x_rest", "mask", "gates", "cseq", "c0", "dhn", "dcn")


def _bwd_inputs(inp, outs, gates, cseq, seed, on_device=False):
    import torch

    randn = _rng(seed, on_device)[1]
    r = lambda *s: (randn(*s) * 0.1).to(DEVICE)
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
    persistent launch.  The reverse diagonal at that batch on the
    persistent kernel through its plan (two warpgroups a CTA, one launch)
    and on the per-diagonal kernel past it, against the same plain
    result."""
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
    bplan = wf.wavefront_bwd_plan(Bn, H, L, False,
                                  torch.cuda.get_device_properties(0).multi_processor_count)
    if (bplan["kernel"], bplan.get("warpgroups")) != ("persistent", 2):
        fail(f"wavefront_bwd B={Bn}: expected the persistent kernel, two warpgroups: {bplan}")
    for mode, d in ((0, ()), (2, _drop(2, T, Bn, 49))):
        got = wf.wavefront_train(*args, bf, *d)
        ref = wf.wavefront_train_plain(*args, bf, *d)
        torch.cuda.synchronize()
        worst["wavefront_train"] = max(worst["wavefront_train"], _rel_check(
            f"wavefront_train mode {mode} L={L} B={Bn} T={T} past the plan (per-diagonal "
            "kernel)", got, ref, TRAIN_TOL_SHORT, checks))
        b_in = _bwd_inputs(inp, *ref[:3], seed=50)
        bargs = [b_in[k] for k in BWD_ARGS] + [ref[0], *d]
        fresh = lambda: [a.clone() if i == 4 else a for i, a in enumerate(bargs)]
        ref_b = wf.wavefront_bwd_plain(*fresh())
        _bwd_per_diagonal_check(f"wavefront_bwd mode {mode} L={L} B={Bn} T={T}", fresh()[:10],
                                d, ref_b, TRAIN_TOL_SHORT, checks)
        got_b = wf.wavefront_bwd(*bargs)
        torch.cuda.synchronize()
        worst["wavefront_bwd"] = max(worst["wavefront_bwd"], _rel_check(
            f"wavefront_bwd mode {mode} L={L} B={Bn} T={T} (persistent kernel, two warpgroups)",
            got_b, ref_b, TRAIN_TOL_SHORT, checks))
        del got_b
    if wf.wavefront_train.persistent_launches != before:
        fail(f"wavefront_train B={Bn}: ran the persistent kernel past its plan")
    if wf.wavefront_bwd.persistent_launches - before_b != 2:
        fail(f"wavefront_bwd B={Bn}: {wf.wavefront_bwd.persistent_launches - before_b} "
             "persistent launches in two calls")


FUSED_CHECK_B = (16, 96)   # batches of the fused dW_x's checks (on from B=83 at T=3510)
FUSED_GROUPS_B = 200       # and at T=16 two row-group launches (128 + 72 rows)


def _fused_checks(checks, worst):
    """The reverse diagonal with its fused dW_x (drop modes 0 and 2, L=3)
    on the persistent kernel through its plan against its plain version at
    T=16 (B=16, 96, FUSED_GROUPS_B and the wide step's batch) and 512
    (B=16, 96 and the wide step's batch), and at the main path's T=TRAIN_T
    (full windows and a ragged last one), B=96; ragged lengths with a
    zero-length row: dW_x per boundary, dgates, dh0 and dc0, each over its
    own largest magnitude.  The wide step's batch is the one
    ``phase_train_wide`` runs on this card (B=394 on the H100: three
    launches of two warpgroups and one of a single warpgroup with rows past
    B a window).  Its dgates, dh0 and dc0 bit for bit against the
    persistent unfused pass's at the same batch, that unfused pass's
    against the plain version too, and in drop mode 0 its dW_x bit for bit
    against ``dwx_windows`` (the window products alone) of that pass's
    dgates.  Beside mode 0 the plain dW_x
    with the steps of one window (the last W) left out, beside mode 2 the
    plain dW_x with keep·scale left out, and at T=512 the launches that
    leave their f32 carries behind at a window's end (each window restarts
    from dhn, dcn), must fail the check."""
    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = lambda r: (*r[:3], *r[3].unbind(0))      # dW_x per boundary
    wide_B = _plan_edge(_wide_config(), TRAIN_B, "gates")
    for T, tol, batches in ((16, TRAIN_TOL_SHORT, FUSED_CHECK_B + (FUSED_GROUPS_B, wide_B)),
                            (512, TRAIN_TOL_LONG, FUSED_CHECK_B + (wide_B,)),
                            (TRAIN_T, TRAIN_TOL_LONG, FUSED_CHECK_B[-1:])):
        for Bn in batches:
            plan = wf.wavefront_bwd_plan(Bn, H, L, True, sms)
            if plan["kernel"] != "persistent":
                fail(f"wavefront_bwd fused B={Bn}: the plan does not take the persistent "
                     f"kernel: {plan}")
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
                before = (wf.wavefront_bwd.fused_persistent_launches,
                          wf.wavefront_bwd.per_diagonal_launches)
                got = wf.wavefront_bwd(*args(), fuse_dwx=True)
                unfused = wf.wavefront_bwd(*args())           # the same kernel, unfused
                torch.cuda.synchronize()
                ran = (wf.wavefront_bwd.fused_persistent_launches - before[0],
                       wf.wavefront_bwd.per_diagonal_launches - before[1])
                tag = (f"wavefront_bwd fused dW_x mode {mode} L={L} B={Bn} T={T} (warpgroups a "
                       f"launch {[g[2] for g in wf.wavefront_bwd_row_groups(Bn)]})")
                if ran != (1, 0):
                    fail(f"{tag}: (fused persistent, per-diagonal) passes {ran}, expected (1, 0)")
                same = all(torch.equal(a, b) for a, b in zip(got[:3], unfused[:3]))
                checks.append({"check": f"{tag}: dgates, dh0, dc0 of the persistent unfused "
                                        "pass", "bit_equal": same})
                if not same:
                    fail(f"{tag}: dgates, dh0 or dc0 differ from the unfused pass's")
                if mode == 0:
                    alone = wf.dwx_windows(outs, unfused[0])
                    torch.cuda.synchronize()
                    same = torch.equal(got[3], alone)
                    checks.append({"check": f"{tag}: dW_x of dwx_windows(outs, the unfused "
                                            "pass's dgates)", "bit_equal": same})
                    if not same:
                        fail(f"{tag}: dW_x differs from the window products of the unfused "
                             "pass's dgates")
                    del alone
                _rel_check(f"{tag}: the unfused pass's dgates, dh0, dc0", unfused[:3], ref[:3], tol,
                           checks)
                del unfused
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
                if T == 512:
                    launch = wf._drop_launch_args(mode, drop[1], drop[3], drop[2],
                                                  (L - 1, T, Bn, H), DEVICE)
                    bad = wf._bwd_persistent_launch(*args()[:10], (mode, *launch), plan,
                                                    fuse_dwx=True, skip_carries=1)
                    torch.cuda.synchronize()
                    _fault_check(f"{tag}: carries left behind at each window's end (the "
                                 "kernel's skip_carries)", split(bad), split(ref), tol, checks)
                    del bad
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


# Rows of the skinny tile's ragged check: no multiple of its 32-row stage
# (nor of the other tiles' 64 and 128).
SKINNY_RAGGED_N = 100003


def _skinny_checks(checks):
    """The projections' weight gradients on the skinny tile at the default
    step's N = T·B (the input projection: f32 x, D = 120, G = 1024; the
    output projection: bf16 x, D = 1024, G = 80; each with f32 and bf16
    dg) and at a ragged N: within WGRAD_TOL of the plain version, bit for
    bit on a second call, counted on the skinny path; beside the same
    launch with one K slice left out, which must fail the check.  Returns
    the largest max abs error."""
    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm

    f32, bf = torch.float32, torch.bfloat16
    g = torch.Generator().manual_seed(61)
    worst = 0.0
    cases = [(TRAIN_T * TRAIN_B, D, G, xd, gd) for D, G, xd in ((120, H, f32), (H, V, bf))
             for gd in (f32, bf)]
    cases += [(SKINNY_RAGGED_N, 120, H, f32, f32), (SKINNY_RAGGED_N, H, V, bf, f32)]
    for N, D, G, xd, gd in cases:
        xx = torch.randn((N, D), generator=g).to(DEVICE, xd)
        dg = (torch.randn((N, G), generator=g) * 0.01).to(DEVICE, gd)
        pl = gm.plan([D], N, G, gd, torch.cuda.get_device_properties(0).multi_processor_count,
                     xd)
        tag = (f"weight_grad N={N} D={D} ({str(xd)[6:]}) G={G} dg {str(gd)[6:]} "
               f"({pl.path} tile, {pl.wide} wide, {pl.chunks} x {pl.splits} blocks)")
        if pl.path != "skinny":
            fail(f"{tag}: the projection does not plan the skinny tile")
        before = gm.weight_grad.skinny_launches
        got = gm.weight_grad(xx, dg)
        again = gm.weight_grad(xx, dg)
        ref = gm.weight_grad_plain(xx, dg)
        torch.cuda.synchronize()
        worst = max(worst, _rel_check(tag, got, ref, WGRAD_TOL, checks))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        counted = gm.weight_grad.skinny_launches - before
        checks.append({"check": f"{tag}: repeat", "bit_equal": same, "skinny_launches": counted})
        if not same or counted != 2:
            fail(f"{tag}: two calls differ ({same}) or were not counted on the skinny tile "
                 f"({counted})")
        if N == TRAIN_T * TRAIN_B and gd == f32:
            bad = gm._launch([xx], dg, bf, skip_split=pl.splits // 2)
            _fault_check(f"{tag}: K slice {pl.splits // 2} of {pl.splits} left out", bad[:2],
                         ref, WGRAD_TOL, checks)
        del xx, dg, got, again, ref
    return worst


def _ctc_ckpt_batches():
    """The checkpoint forward's batches at B=64, T=3510, V=80 in a
    MAX_LABEL-wide label buffer (S = 1201): the timing batch (full-length
    rows, labels of LABEL_LEN), a ragged batch (input lengths 1 to T, label
    lengths 0 to MAX_LABEL, rows with fewer frames than their 2U + 1 states
    among them) and a batch whose labels fill the buffer (all 1201 states
    live).  Yields (name, _setup's tuple)."""
    import torch

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck

    T, Bn = TRAIN_T, TRAIN_B
    yield "timing", _ctc_timing_batch()[:6]
    g = torch.Generator().manual_seed(97)
    logits = (torch.randn((T, Bn, V), generator=g) * 2.0).to(DEVICE)
    ll = torch.as_tensor([1 + (53 * b * b + 7 * b) % T for b in range(Bn)])
    ll[0], ll[1], ll[2] = T, 1, 2
    ul = torch.as_tensor([(97 * b) % (MAX_LABEL + 1) for b in range(Bn)])
    ul[0], ul[1], ul[3] = MAX_LABEL, 0, MAX_LABEL
    labels = torch.randint(0, V - 1, (Bn, MAX_LABEL), generator=g)
    labels[torch.arange(MAX_LABEL)[None, :] >= ul[:, None]] = -1
    if not bool((ll < 2 * ul + 1).any()):
        fail("ctc checkpoint forward: the ragged batch has no row shorter than its states")
    yield "ragged", tck._setup(logits, ll.to(DEVICE), labels.to(DEVICE), ul.to(DEVICE), -1)
    labels = torch.randint(0, V - 1, (Bn, MAX_LABEL), generator=g)
    ll = torch.full((Bn,), T)
    ul = torch.full((Bn,), MAX_LABEL)
    yield "S=1201 live", tck._setup(logits, ll.to(DEVICE), labels.to(DEVICE), ul.to(DEVICE),
                                    -1)


def _ctc_ckpt_checks(checks):
    """The alpha forward's three output modes, one kernel (the checkpoints,
    row 9; the last row, row 10; the stream, row 11), on
    ``_ctc_ckpt_batches``: the checkpoints bit for bit against the stream's
    rows at every block end and the last row against the loss-only mode's
    and the stream's; each mode within CTC_LOSS_TOL of its plain version
    (``alpha_plain``, ``alpha_stream_plain``); and on the timing batch each
    mode beside its planted fault (step 100 reads step 99's log-prob row),
    which must fail the check and end (the kernel's barrier waits trap
    rather than hang)."""
    import torch

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck

    for name, (log_probs, ext, skip_ok, ll, ul, _) in _ctc_ckpt_batches():
        args = (log_probs, ext, skip_ok, ll, ul)
        T, S = log_probs.shape[0], ext.shape[1]
        K = tck.ctc_block(S, V)
        ck, last = tck.ctc_alpha_ckpt(*args, K)
        last_l = tck.ctc_alpha_lossonly(*args)
        alphas, last_s = tck.ctc_alpha_stream(*args)
        ends = [min(T, (i + 1) * K) - 1 for i in range(ck.shape[0])]
        ck_p, last_p = tck.alpha_plain(*args, K, True)
        torch.cuda.synchronize()
        entry = {"check": f"ctc alpha forward, {name} batch: B={TRAIN_B} T={T} S={S} K={K}",
                 "geometry": tck.alpha_geometry(S, V)._asdict(),
                 "ckpts_equal_stream_rows": torch.equal(ck, alphas[ends]),
                 "last_equal_lossonly": torch.equal(last, last_l),
                 "last_equal_stream": torch.equal(last, last_s),
                 "rel_err": {"ckpts": _ctc_rel(ck, ck_p), "last": _ctc_rel(last, last_p)},
                 "tol": CTC_LOSS_TOL}
        del ck_p
        alphas_p, _ = tck.alpha_stream_plain(*args)
        entry["rel_err"]["stream"] = _ctc_rel(alphas, alphas_p)
        del alphas_p
        checks.append(entry)
        if not (entry["ckpts_equal_stream_rows"] and entry["last_equal_lossonly"]
                and entry["last_equal_stream"]) or max(entry["rel_err"].values()) > CTC_LOSS_TOL:
            fail(f"ctc alpha forward: the three modes differ from each other or from their "
                 f"plain versions: {entry}")
        if name == "timing":
            for mode, k, good in (("checkpoints", K, ck), ("last row", 0, last),
                                  ("stream", 1, alphas)):
                bad = tck._alpha_launch(*args, k, fault_step=100)[0 if k else 1]
                torch.cuda.synchronize()
                fault = {"planted_fault": f"ctc alpha forward, {mode}: step 100 reads step "
                                          "99's log-probs",
                         "bit_equal": torch.equal(bad, good), "rel_err": _ctc_rel(bad, good),
                         "tol": CTC_LOSS_TOL}
                checks.append(fault)
                if fault["bit_equal"] or fault["rel_err"] <= CTC_LOSS_TOL:
                    fail(f"ctc alpha forward: the check does not see the fault: {fault}")
                del bad
        del ck, alphas, log_probs


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
    worst["weight_grad"] = max(worst["weight_grad"], _skinny_checks(checks))
    worst.update(_ctc_checks(checks))
    _ctc_ckpt_checks(checks)
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
    random weights from a fixed torch.Generator, labels from a fixed numpy
    seed as bench.py builds them and the audio (bench.py's N(0, 0.1)) from
    a fixed generator on the card (other bits than bench.py's numpy draws,
    which took seconds a set-up at T=3510 and ~10 s at B=400), ``Bn``
    utterances (TRAIN_B by default)."""
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
        use_kernels=True, **{"compute_dtype": torch.bfloat16, "wavefront": True, **model_kw})
    scfg = step.StepConfig(model=cfg, frontend=fe, input_keep_prob=keeps[0],
                           output_keep_prob=keeps[1], use_pallas_ctc=pallas_ctc)
    state = step.init_train_state(torch.Generator().manual_seed(seed), cfg, Bn,
                                  TRAIN_LR, DEVICE)
    rng = np.random.default_rng(1)
    batch = {
        "audio_lengths": np.full((1, Bn), n, np.int32),
        "labels": rng.integers(1, V - 1, (1, Bn, label_width)).astype(np.int32),
        "label_lengths": np.full((1, Bn), label_len, np.int32),
    }
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    g = torch.Generator(device=DEVICE).manual_seed(1)
    batch["audio"] = torch.randn((1, Bn, n), generator=g, device=DEVICE) * 0.1
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
    steps); ``weight_grad`` on the skinny tile (the input and output
    projections; every train step); and the persistent kernels' launches (wgmma on a resident W_h):
    the lean forward (csrc/lstm_layer_lean.cu; the recompute steps), the
    gates-mode forward (its gates instance; the layered steps), the
    layer backward (csrc/lstm_layer_bwd_persistent.cu) in gates mode (the
    layered steps) and in recompute mode (the recompute steps: a launch a
    rebuild chunk), the recompute calls that ran the per-step kernel (none
    at the card's width), the wavefront training forward
    (csrc/lstm_wavefront_persistent.cu; the default steps) and the reverse
    diagonal (csrc/lstm_wavefront_bwd_persistent.cu; the default steps: its
    cooperative launches, one a window and row group), its fused passes
    (the wide step) and the reverse passes the plan sent to the
    per-diagonal kernel (none at the card's width); the training forwards
    the plan sent to the per-diagonal kernel (the wide step's; none in the
    float32 default step); in float32, the recompute backward's float32
    persistent launches (one a rebuild chunk), the reverse diagonal's layer
    sweeps (a persistent launch a layer) and their cotangent products on
    the float32 GEMM tile, the training forward's layer sweeps (a
    persistent launch a layer) and their input products on the same tile,
    and the projections' weight gradients on the float32 skinny tile."""
    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    return {"dgates_weight_grads": gm.dgates_weight_grads.wgmma_launches,
            "weight_grad": gm.weight_grad.wgmma_launches,
            "weight_grad_skinny": gm.weight_grad.skinny_launches,
            "fused_windows": wf.wavefront_bwd.wgmma_products,
            "recompute_rebuild": tlt.recurrence_bwd_recompute.rebuild_launches,
            "recompute_persistent": tlt.recurrence_bwd_recompute.persistent_launches,
            "recompute_per_step": tlt.recurrence_bwd_recompute.per_step_launches,
            "lean_persistent": tlt.recurrence_train_lean.persistent_launches,
            "bwd_persistent": tlt.recurrence_bwd.persistent_launches,
            "train_persistent": tlt.recurrence_train.persistent_launches,
            "wavefront_persistent": wf.wavefront_train.persistent_launches,
            "wavefront_bwd_persistent": wf.wavefront_bwd.persistent_launches,
            "wavefront_bwd_fused_persistent": wf.wavefront_bwd.fused_persistent_launches,
            "wavefront_bwd_per_diagonal": wf.wavefront_bwd.per_diagonal_launches,
            "recompute_f32_persistent": tlt.recurrence_bwd_recompute.f32_persistent_launches,
            "wavefront_bwd_sweep": wf.wavefront_bwd.sweep_launches,
            "sweep_dout": wf.sweep_dout.launches,
            "wavefront_per_diagonal": wf.wavefront_train.per_diagonal_launches,
            "wavefront_sweep": wf.wavefront_train.sweep_launches,
            "wavefront_sweep_xp": wf.wavefront_train.sweep_xp_launches,
            "weight_grad_skinny_f32": gm.weight_grad.skinny_f32_launches}


def _zero_path_counters():
    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    gm.dgates_weight_grads.wgmma_launches = gm.weight_grad.wgmma_launches = 0
    gm.weight_grad.skinny_launches = 0
    wf.wavefront_bwd.wgmma_products = 0
    tlt.recurrence_bwd_recompute.rebuild_launches = 0
    tlt.recurrence_bwd_recompute.persistent_launches = 0
    tlt.recurrence_bwd_recompute.per_step_launches = 0
    tlt.recurrence_train_lean.persistent_launches = 0
    tlt.recurrence_bwd.persistent_launches = 0
    tlt.recurrence_train.persistent_launches = 0
    wf.wavefront_train.persistent_launches = wf.wavefront_bwd.persistent_launches = 0
    wf.wavefront_bwd.fused_persistent_launches = wf.wavefront_bwd.per_diagonal_launches = 0
    tlt.recurrence_bwd_recompute.f32_persistent_launches = 0
    wf.wavefront_bwd.sweep_launches = wf.sweep_dout.launches = 0
    wf.wavefront_train.per_diagonal_launches = wf.wavefront_train.sweep_launches = 0
    wf.wavefront_train.sweep_xp_launches = gm.weight_grad.skinny_f32_launches = 0


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
                fault=_wavefront_fault, tol=GRAD_REL_TOL, T=GRAD_T):
    """One step's gradients through the kernels at T frames (GRAD_T), full width,
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

    scfg, state, batch = _train_setup(T, 100, 50, seed=seed, keeps=keeps,
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
    entry = {"T": T, "keep_probs": list(keeps), "use_pallas_ctc": pallas_ctc,
             "seed": seed, "model": {k: v if isinstance(v, (bool, int, str)) else str(v)
                                     for k, v in (model_kw or {}).items()},
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
    at the default keeps under GRAD_REL_TOL.  The gates that train,
    train_layered and alt_routes took at seed 2 in this run are read from
    their records (``_gates_taken``), not taken again."""
    readings, recompute, alt = [], [], {}
    taken = _gates_taken()
    for seed in (2, 5, 8):
        for keeps in ((1.0, 1.0), (INPUT_KEEP, 1.0), (1.0, OUTPUT_KEEP),
                      (INPUT_KEEP, OUTPUT_KEEP)):
            readings.append(taken.get(("default", seed, keeps))
                            or _grad_check(keeps, True, seed))
        recompute.append(taken.get(("recompute", seed)) or _grad_check(seed=seed,
                                                                       **RECOMPUTE_GATE))
        for name, env, _, _, fault, _ in _alt_route_specs():
            with _environ(**env):
                alt.setdefault(name, []).append(taken.get((name, seed))
                                                or _grad_check(seed=seed, fault=fault))
    emit("grad_study", readings=readings, recompute=recompute, alt_routes=alt,
         read_from_phases=sorted(e["read_from"] for e in taken.values()))


def _gates_taken():
    """The gradient gates that earlier phases of this run took with
    ``_grad_check``'s default keeps and CTC kernels at seed 2 (train: the
    default route; train_layered: the recompute route; alt_routes: each
    route with its switch set), keyed as ``phase_grad_study`` asks for
    them, each marked with the phase it was read from."""
    found = {}

    def add(key, phase, entry):
        if entry and entry.get("seed") == 2 and entry.get("use_pallas_ctc") and (
                entry.get("keep_probs") == [INPUT_KEEP, OUTPUT_KEEP]):
            found[key] = {**entry, "read_from": phase}

    add(("default", 2, (INPUT_KEEP, OUTPUT_KEEP)), "train",
        RECORD.get("train", {}).get("grad_check"))
    add(("recompute", 2), "train_layered",
        RECORD.get("train_layered", {}).get("grad_check", {}).get("recompute"))
    for name, rec in RECORD.get("alt_routes", {}).get("routes", {}).items():
        add((name, 2), "alt_routes", rec.get("grad_check"))
    return found


def _nn_lstm_backward(T, Bn, n_layers=1, dtype=None):
    """Two calls of torch.nn.LSTM's (cuDNN, bf16 or ``dtype``, n_layers of 1024)
    backward on one forward graph at T steps and Bn rows, yardsticks only:
    (without weight gradients, with them).  The first asks
    torch.autograd.grad for the input's gradient alone, so autograd masks
    the weights' out of cuDNN's backward; it still computes
    dx = dgates·W_ihᵀ (of layer 0, which the kernels leave to a matmul;
    between layers the reverse diagonal forms it too)."""
    import torch

    dtype = dtype or torch.bfloat16
    m = torch.nn.LSTM(H, H, num_layers=n_layers).to(DEVICE, dtype)
    m.flatten_parameters()
    x = torch.randn((T, Bn, H), device=DEVICE, dtype=dtype, requires_grad=True)
    y, _ = m(x)
    dy = torch.randn_like(y)
    inputs = [x, *m.parameters()]
    return (lambda: torch.autograd.grad(y, [x], dy, retain_graph=True),
            lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True))


def _nn_lstm_forward(T, Bn, n_layers=1, dtype=None):
    """One call of torch.nn.LSTM's (cuDNN, bf16 or ``dtype``, n_layers of
    1024) forward on an input that needs its gradient (cuDNN's training
    forward, which keeps its own residuals), at T steps and Bn rows: a
    yardstick only."""
    import torch

    dtype = dtype or torch.bfloat16
    m = torch.nn.LSTM(H, H, num_layers=n_layers).to(DEVICE, dtype)
    m.flatten_parameters()
    x = torch.randn((T, Bn, H), device=DEVICE, dtype=dtype, requires_grad=True)
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
    TFLOP/s.  Each projection's weight_grad (the skinny tile) is timed in
    turns with one ``torch.mm`` with a float32 result and a float32 sum,
    the WMMA tile it ran before in the same turns (``wmma_ms``), each call
    reported apart (``calls``) with its plan, bound share and GB/s, and
    its kernels' own device time (``device_ms``, torch.profiler: the
    turns' CUDA events also hold the host's time between launches)."""
    from unittest import mock

    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    T, Bn, bf, f32 = TRAIN_T, TRAIN_B, torch.bfloat16, torch.float32
    N, G = T * Bn, 4 * H
    inp = _train_inputs(T, Bn, [T] * Bn, seed=70, on_device=True)
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
    b_in = _bwd_inputs(inp, outs, gates, cseq, seed=71, on_device=True)
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

    randn = _rng(72, on_device=True)[1]
    feats = randn(N, 120)
    d_in = randn(N, H) * 0.01
    d_out = randn(N, V) * 0.01
    top = outs[-1].reshape(N, H)
    per = {}
    for name, xx, dg in (("input", feats, d_in), ("output", top, d_out)):
        D, Gs = xx.shape[1], dg.shape[1]

        def wmma():                                  # the tile the projections ran before
            with mock.patch.object(gm, "product_path", lambda *a: "wmma"):
                return gm.weight_grad(xx, dg)

        # The library yardstick: one product with a float32 result and db,
        # in turns with the kernel, the WMMA tile in the same turns.
        turns = in_turns(lambda: (torch.mm(xx.to(bf).t(), dg.to(bf), out_dtype=f32),
                                  dg.sum(0, dtype=f32)),
                         lambda: gm.weight_grad(xx, dg), wmma=wmma)
        ms = turns["ms"]
        dev = device_ms(lambda: gm.weight_grad(xx, dg))
        plain = cuda_ms(lambda: gm.weight_grad_plain(xx, dg), iters=1)
        nbytes = N * (D * xx.element_size() + Gs * dg.element_size()) + (D + 1) * Gs * 4
        bound, by = _bounds(2 * N * D * Gs, nbytes)
        pl = gm.plan([D], N, Gs, dg.dtype, sms, xx.dtype)
        per[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         library_ms=turns["library_ms"], wmma_ms=turns["wmma_ms"],
                         device_ms=dev, D=D, G=Gs,
                         x=str(xx.dtype)[6:], dg=str(dg.dtype)[6:], path=pl.path,
                         plan=dict(wide=pl.wide, chunks=pl.chunks, splits=pl.splits,
                                   rows_per_split=pl.rows_per_split, stages=pl.stages,
                                   smem=pl.smem),
                         bound_share=bound / ms, tflops=2 * N * D * Gs / ms / 1e9,
                         gbps=nbytes / ms / 1e6, flops=2 * N * D * Gs, bytes=nbytes,
                         turns=turns["turns"])
    out["weight_grad"] = {k: sum(per[n][k] for n in per)
                          for k in ("ms", "plain_ms", "bound_ms", "library_ms", "wmma_ms",
                                    "device_ms", "flops")}
    out["weight_grad"]["tflops"] = out["weight_grad"]["flops"] / out["weight_grad"]["ms"] / 1e9
    out["weight_grad"]["bound_share"] = out["weight_grad"]["bound_ms"] / out["weight_grad"]["ms"]
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
        out[name]["us_per_step"] = 1e3 * out[name]["ms"] / (T - 1)
    for name in ("ctc_alpha_ckpt", "ctc_alpha_lossonly"):       # one kernel, two modes
        out[name]["geometry"] = tck.alpha_geometry(ext.shape[1], V)._asdict()
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
    if default["wgmma_launches"]["weight_grad_skinny"] != default["launches"]["weight_grad"]:
        fail(f"train: the projections' weight gradients did not all run the skinny tile: "
             f"{default['wgmma_launches']}, {default['launches']}")
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


def _layer_inputs(T, Bn, lengths, seed, proj_dtype=None, on_device=False):
    """One layer's kernel inputs at full width on the card: a bf16 input x,
    xavier-uniform bf16 W_x and W_h, an f32 bias, x_proj = x·W_x + b
    (f32 sums, in ``proj_dtype``, float32 by default), non-zero h0, c0,
    f32 cotangents dout, dhn, dcn and the (T, 1, B) length mask; drawn on
    the card with ``on_device`` (``_rng``)."""
    import torch

    from rnn_speech_tpu_torch.ops.lstm_layer_train import input_projection

    bf = torch.bfloat16
    rand, randn = _rng(seed, on_device)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: ((rand(*s) * 2 - 1) * lim).to(DEVICE, bf)
    r = lambda *s, scale: (randn(*s) * scale).to(DEVICE)
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

    _bwd_row_groups_check(checks)
    _train_past_plan_check(checks)
    for i, (T, Bn) in enumerate(_recompute_check_shapes(rec_B)):
        worst["recurrence_bwd_recompute"] = max(
            worst["recurrence_bwd_recompute"],
            _recompute_check_at(T, Bn, 150 + i, checks, plain_faults=True))
    worst["rebuild_gates"] = _rebuild_product_check(checks, rec_B)


def _recompute_check_shapes(rec_B):
    """The recompute backward's full-width check shapes (T, B): its route's
    batch ``rec_B`` at T=512 (several row groups, several rebuild chunks)
    and a chunk edge, T one step past a chunk of its rebuild at B=70 (two
    row groups; not a multiple of 16)."""
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    return ((512, rec_B), (tlt.rebuild_chunk(TRAIN_T, 70, H) + 1, 70))


def _recompute_check_at(T, Bn, seed, checks, plain_faults):
    """The recompute backward at H=1024, T steps, Bn rows (ragged lengths
    with a zero-length row; h_prev and c from the plain lean forward) on its
    persistent kernel (``_recompute_persistent_checks``: at two row groups
    the launch without its step barrier alone is gated too) against its
    plain version at TRAIN_TOL_LONG; with ``plain_faults``, beside the plain
    rebuild without its bias and df scaled by 0.9.  Returns the relative
    error."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf, name = torch.bfloat16, "recurrence_bwd_recompute"
    lens = [max(0, T - (31 * b) % (T // 2 + 1)) if b % 9 else T for b in range(Bn)]
    lens[2] = 0                                      # a zero-length row
    inp = _layer_inputs(T, Bn, lens, seed=seed, proj_dtype=bf)
    tag = f"{name} H={H} B={Bn} T={T} (rebuild chunks of {tlt.rebuild_chunk(T, Bn, H)} steps)"
    out, _, _, cseq = tlt.recurrence_train_lean_plain(
        inp["x_proj"], inp["w_h"], inp["mask"], inp["h0"], inp["c0"], bf)
    h_prev = torch.cat([inp["h0"].to(bf)[None], out.to(bf)[:-1]])
    del out
    args = [inp["dout"], inp["x"], h_prev, cseq, inp["c0"].to(bf).float(), inp["mask"],
            inp["w_x"], inp["b"], inp["w_h"], inp["dhn"], inp["dcn"]]
    ref = tlt.recurrence_bwd_recompute_plain(*args)
    if plain_faults:
        no_bias = args[:7] + [torch.zeros_like(inp["b"])] + args[8:]
        _fault_check(f"{tag}: bias left out of the rebuild",
                     tlt.recurrence_bwd_recompute_plain(*no_bias), ref, TRAIN_TOL_LONG, checks)
        del no_bias
        scaled = ref[0].clone()
        scaled[..., 2 * H:3 * H] *= 0.9               # the forget gate's block
        _fault_check(f"{tag}: df scaled by 0.9", (scaled, *ref[1:]), ref, TRAIN_TOL_LONG,
                     checks)
        del scaled
    got = _recompute_persistent_checks(tag, args, ref, TRAIN_TOL_LONG, checks,
                                       gate_step_fault=-(-Bn // 64) == 2)
    err = _rel_check(tag, got, ref, TRAIN_TOL_LONG, checks)
    del inp, args, ref, got, h_prev, cseq
    torch.cuda.empty_cache()
    return err


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


def _bwd_row_groups_check(checks, Bn=70, T=16, seed=149):
    """The gates-mode backward past one 64-row group (B=70: two row groups
    in turn, two warpgroups a CTA) on its persistent kernel, the plan's
    choice, against its plain version at T=16, ragged lengths with a
    zero-length row, bit for bit on repeat; and the per-step kernel (the
    design it replaced, still the one for shapes the plan does not take)
    called directly on the same inputs, with no persistent launch."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf = torch.bfloat16
    plan = tlt.bwd_plan(Bn, H, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["kernel"] != "persistent" or plan["groups"] != -(-Bn // 64):
        fail(f"recurrence_bwd B={Bn}: expected the persistent kernel, row groups in turn, "
             f"got {plan}")
    lens = [0 if b == 2 else (T - (31 * b) % (T // 2 + 1) if b % 9 else T) for b in range(Bn)]
    inp = _layer_inputs(T, Bn, lens, seed=seed)
    _, _, _, gates, cseq = tlt.recurrence_train_plain(inp["x_proj"], inp["w_h"], inp["mask"],
                                                      inp["h0"], inp["c0"], bf)
    c0r = inp["c0"].to(bf).float()
    btail = (inp["mask"], inp["w_h"], inp["dhn"], inp["dcn"])
    ref = tlt.recurrence_bwd_plain(inp["dout"], gates.clone(), cseq, c0r, *btail)
    tag = f"recurrence_bwd H={H} B={Bn} T={T}"
    got = _bwd_persistent_checks(tag, inp["dout"], gates.clone(), cseq, c0r, btail, ref,
                                 TRAIN_TOL_SHORT, checks)
    _rel_check(f"{tag} persistent, {plan['groups']} row groups in turn", got, ref,
               TRAIN_TOL_SHORT, checks)
    before = tlt.bwd_persistent_launches()
    old = tlt._bwd_per_step_launch(inp["dout"], gates, cseq, c0r, *btail)
    torch.cuda.synchronize()
    _rel_check(f"{tag} per-step kernel (the parent design, called directly)", old, ref,
               TRAIN_TOL_SHORT, checks)
    if tlt.bwd_persistent_launches() != before:
        fail(f"recurrence_bwd B={Bn}: the per-step launch ran the persistent kernel")


def _recompute_persistent_checks(tag, args, ref, tol, checks, gate_step_fault):
    """The recompute backward on its persistent kernel (row 8), the plan's
    choice at these shapes: one launch and one rebuild product a rebuild
    chunk and no per-step launch (counted at the launch sites), bit for bit
    on repeat, beside the launch without its step and slice barriers
    (stale dgates and partials), which must fail ``tol`` against the plain
    result ``ref``, and the launch without its step barrier alone on a
    dgates stream filled with NaN: gated the same way where
    ``gate_step_fault`` (two row groups, as the gates-mode check at B=70),
    else a reading; and the per-step kernel (the
    design it replaced) called directly on the same inputs, against
    ``ref``.  Returns the first call's (dgates, dh0, dc0)."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    T, B_, H_ = args[3].shape
    plan = tlt.bwd_plan(B_, H_, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["kernel"] != "persistent":
        fail(f"{tag}: the plan does not send the recompute backward to the persistent "
             f"kernel: {plan}")
    fn = tlt.recurrence_bwd_recompute
    counts = lambda: (fn.persistent_launches, fn.rebuild_launches, fn.per_step_launches)
    before = counts()
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    chunks = len(tlt.rebuild_chunks(T, tlt.rebuild_chunk(T, B_, H_)))
    launched = [a - b for a, b in zip(counts(), before)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    checks.append({"check": f"{tag} persistent (grid {plan['grid']}, {plan['groups']} row "
                            f"groups, {chunks} chunks): bit for bit on repeat",
                   "equal": same, "launches": dict(zip(
                       ("persistent", "rebuild", "per_step"), launched))})
    if launched != [2 * chunks, 2 * chunks, 0]:
        fail(f"{tag}: two calls launched {launched} (persistent, rebuild, per-step), "
             f"expected {[2 * chunks, 2 * chunks, 0]}")
    if not same:
        fail(f"{tag}: two calls on the same inputs differ")
    # Without the step barrier alone a stale read returns whatever the
    # stream held: a fresh allocation may hold the previous identical
    # call's dgates (then the fault hides), so the stream is handed in
    # filled with NaN.  At two row groups it is gated; with several groups
    # in turn between a group's write and its next read it is a reading
    # beside the gated fault that also leaves out the slice barrier.
    nan_stream = torch.full((T, B_, 4 * H_), float("nan"), dtype=torch.bfloat16,
                            device=args[3].device)
    no_step = tlt._recompute_persistent_launch(*args, plan, skip_barrier=1,
                                               dgates=nan_stream)[:3]
    del nan_stream
    if gate_step_fault:
        _fault_check(f"{tag}: step barrier left out (stale dgates)", no_step, ref, tol, checks)
    else:
        checks.append({"reading": f"{tag}: step barrier left out",
                       "rel_err": _fault_errs(no_step, ref, tag)})
    del no_step
    _fault_check(f"{tag}: step and slice barriers left out (stale dgates and partials)",
                 tlt._recompute_persistent_launch(*args, plan, skip_barrier=3)[:3], ref, tol,
                 checks)
    old = tlt._recompute_per_step_launch(*args)[:3]
    torch.cuda.synchronize()
    _rel_check(f"{tag} per-step kernel (the parent design, called directly)", old, ref, tol,
               checks)
    return got


def _recompute_route_gate(phase, record):
    """A recompute step's backward ran the persistent kernel and never the
    per-step one (``_run_steps``' path counters)."""
    paths = record["wgmma_launches"]
    if not paths["recompute_persistent"] or paths["recompute_per_step"]:
        fail(f"{phase} (recompute): the backward must run the persistent kernel and no "
             f"per-step launch: {paths}")


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
# 2's at B=128, T=1024, and rows 5, 3 and 4's at B=64, T=512 (rows 3 and 4
# in drop mode 2), as a SHA-256 of their bytes, by whichever package lies in the
# working directory (run in this checkout and in ``--parent``'s by
# ``persistent_study``), each with its persistent launches; then row 4's
# unfused pass at the default step's shape (B=64, T=3510, drop mode 2,
# full-length rows), device ms by CUDA events (one warm-up, three timed);
# then the CTC alpha forward's three outputs (rows 9, 10, 11) at B=64,
# T=3510 on a full-length and a ragged batch, hashed, each with its
# wrapper's launches, and each timed on the full-length batch and on a
# full-length batch of the wide step's B (argv[1]; one warm-up, five
# timed).
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
# Row 6 (the gates-mode layer backward, one row group) at B=64 and row 8
# (the recompute backward) at B=400, T=512, on seeded residuals.
for name, B in (("row6", 64), ("row8", 400)):
    g = torch.Generator(device="cuda").manual_seed(B + 1)
    w = lambda *s: ((torch.rand(s, generator=g, device="cuda") * 2 - 1) * 0.035).to(bf)
    r = lambda *s, scale: torch.randn(s, generator=g, device="cuda") * scale
    lens = torch.randint(0, T + 1, (B,), generator=g, device="cuda")
    mask = (torch.arange(T, device="cuda")[:, None] < lens[None]).float()[:, None, :]
    w_h, h0, c0 = w(H, 4 * H), r(B, H, scale=0.2), r(B, H, scale=0.2)
    xp = (r(T, B, 4 * H, scale=0.5)).to(bf)
    tail = (r(T, B, H, scale=0.1), r(B, H, scale=0.1), r(B, H, scale=0.1))
    c0r = c0.to(bf).float()
    if name == "row6":
        _, _, _, gates, cseq = tlt.recurrence_train_plain(xp.float(), w_h, mask, h0, c0, bf)
        fn, res = tlt.recurrence_bwd, tlt.recurrence_bwd(tail[0], gates, cseq, c0r, mask, w_h,
                                                         tail[1], tail[2])
    else:
        out, _, _, cseq = tlt.recurrence_train_lean_plain(xp, w_h, mask, h0, c0, bf)
        h_prev = torch.cat([h0.to(bf)[None], out.to(bf)[:-1]])
        x = r(T, B, H, scale=1.0).to(bf)
        fn, res = tlt.recurrence_bwd_recompute, tlt.recurrence_bwd_recompute(
            tail[0], x, h_prev, cseq, c0r, mask, w(H, 4 * H), r(4 * H, scale=0.1), w_h,
            tail[1], tail[2])
    digest = hashlib.sha256()
    for t in res:
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    print(json.dumps({"B": name, "sha256": digest.hexdigest(), "persistent": fn.launches}))
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
# Row 4 (the unfused reverse diagonal, drop mode 2) on row 3's residuals.
outs, gates, cseq, _, _ = wf.wavefront_train(*stack)
dtop = (torch.randn((T, B, H), generator=g, device="cuda") * 0.1).to(bf)
digest = hashlib.sha256()
for t in wf.wavefront_bwd(dtop, stack[2], stack[3], mask, gates, cseq, stack[7], r(L, B, H),
                          r(L, B, H), outs, 2, (11, 13), 1.25, 0.8):
    digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
print(json.dumps({"B": "row4", "sha256": digest.hexdigest(),
                  "persistent": wf.wavefront_bwd.persistent_launches}))
# The bf16 per-step and per-diagonal kernels (lstm_cell.cuh's cell and the
# per-step backwards) and the weight-gradient tiles, launched directly at
# small ragged shapes ("persistent": 1 once a launch returned).
def put(name, tensors):
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    print(json.dumps({"B": name, "sha256": digest.hexdigest(), "persistent": 1}))
B, T = 70, 40
g = torch.Generator(device="cuda").manual_seed(B + T)
lens = torch.randint(0, T + 1, (B,), generator=g, device="cuda")
mask = (torch.arange(T, device="cuda")[:, None] < lens[None]).float()[:, None, :]
x = torch.randn((T, B, H), generator=g, device="cuda").to(bf)
wx0, wh, wx, ball = w(H, 4 * H), w(L, H, 4 * H), w(L - 1, H, 4 * H), r(L, 4 * H)
h0s, c0s = r(L, B, H), r(L, B, H)
put("row1_pd", wf._eval_per_diagonal_launch(torch.randn((T, B, 4 * H), generator=g,
                                                        device="cuda") * 0.5, wh, wx,
                                            ball[1:, None], mask, h0s, c0s))
drop = (2, None, 11, 13, 3435973837, 1.25)
outs, gates, cseq, hn, cn = wf._per_diagonal_launch(x, wx0, wh, wx, ball, mask, h0s, c0s, drop)
put("row3_pd", (outs, gates, cseq, hn, cn))
put("row4_pd", wf._bwd_per_diagonal_launch(
    (torch.randn((T, B, H), generator=g, device="cuda") * 0.1).to(bf), wh, wx, mask, gates,
    cseq, c0s, r(L, B, H), r(L, B, H), outs, drop))
xp = torch.randn((T, B, 4 * H), generator=g, device="cuda") * 0.5
rec.lean_plan = lambda *a, **k: {"kernel": "per_step"}
put("row2_ps", rec.lstm_recurrence(xp, wh[0], mask, h0s[0], c0s[0]))
lout, _, _, lgates, lcseq = tlt._forward_launch("row5", xp, wh[0], mask, h0s[0], c0s[0], bf,
                                                True)
put("row5_ps", (lout, lgates, lcseq))
lean = tlt._forward_launch("row7", xp.to(bf), wh[0], mask, h0s[0], c0s[0], bf, False)
put("row7_ps", (lean[0], lean[4]))
dout, dhn, dcn = r(T, B, H), r(B, H), r(B, H)
c0r = c0s[0].to(bf).float()
put("row6_ps", tlt._bwd_per_step_launch(dout, lgates, lcseq, c0r, mask, wh[0], dhn, dcn))
h_prev = torch.cat([h0s[0].to(bf)[None], lout.to(bf)[:-1]])
put("row8_ps", tlt._recompute_per_step_launch(dout, x, h_prev, lcseq, c0r, mask, wx0,
                                              ball[0], wh[0], dhn, dcn)[:3])
from rnn_speech_tpu_torch.ops import grad_matmul as gm
N = 5000
hg, xg = torch.randn((N, H), generator=g, device="cuda"), torch.randn((N, 120), generator=g,
                                                                      device="cuda")
dgf = torch.randn((N, 4 * H), generator=g, device="cuda")
put("row14_wmma", gm.dgates_weight_grads(hg, xg, dgf))
put("row14_wgmma", gm.dgates_weight_grads(hg.to(bf), hg.to(bf), dgf.to(bf)))
put("row15_skinny", gm.weight_grad(xg, dgf[:, :H]))
# Row 4's unfused pass timed at the default step's shape.
T = 3510
g = torch.Generator(device="cuda").manual_seed(B)
mask = torch.ones((T, 1, B), device="cuda")
w_h, w_x = w(L, H, 4 * H), w(L - 1, H, 4 * H)
outs, gates, cseq, _, _ = wf.wavefront_train(
    torch.randn((T, B, H), generator=g, device="cuda").to(bf), w(H, 4 * H), w_h, w_x,
    r(L, 4 * H), mask, r(L, B, H), r(L, B, H), bf, 2, (11, 13), 1.25, 0.8)
args = ((torch.randn((T, B, H), generator=g, device="cuda") * 0.1).to(bf), w_h, w_x, mask,
        gates, cseq, r(L, B, H), r(L, B, H), r(L, B, H), outs, 2, (11, 13), 1.25, 0.8)
wf.wavefront_bwd(*args)
torch.cuda.synchronize()
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(3):
    wf.wavefront_bwd(*args)
end.record()
torch.cuda.synchronize()
print(json.dumps({"B": "row4_ms", "ms": start.elapsed_time(end) / 3,
                  "persistent": wf.wavefront_bwd.persistent_launches}))
# Rows 9, 10 and 11 (the CTC alpha forward's checkpoints, last row and
# stream) at the default step's shape: the timing batch (full-length rows,
# labels of 250 in a 600-wide buffer) and a ragged one; then each timed.
from rnn_speech_tpu_torch.ops import ctc_kernel as tck
T, B, V, U = 3510, 64, 80, 600
def ctc_batch(seed, ll, ul, B=B):
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn((T, B, V), generator=g) * 2.0).cuda()
    labels = torch.randint(0, V - 1, (B, U), generator=g)
    labels[torch.arange(U)[None, :] >= ul[:, None]] = -1
    return tck._setup(logits, ll.cuda(), labels.cuda(), ul.cuda(), -1)[:5]
batches = {"full": ctc_batch(95, torch.full((B,), T), torch.full((B,), 250)),
           "ragged": ctc_batch(97, torch.as_tensor([1 + (53 * b * b + 7 * b) % T
                                                    for b in range(B)]),
                               torch.as_tensor([(97 * b) % (U + 1) for b in range(B)]))}
K = tck.ctc_block(2 * U + 1, V)
rows = {"row9": (tck.ctc_alpha_ckpt, lambda a: tck.ctc_alpha_ckpt(*a, K)),
        "row10": (tck.ctc_alpha_lossonly, lambda a: (tck.ctc_alpha_lossonly(*a),)),
        "row11": (tck.ctc_alpha_stream, lambda a: tck.ctc_alpha_stream(*a))}
for name, (fn, run) in rows.items():
    digest = hashlib.sha256()
    for args in batches.values():
        for t in run(args):
            digest.update(memoryview(t.contiguous().cpu().numpy()).cast("B"))
    print(json.dumps({"B": name, "sha256": digest.hexdigest(), "persistent": fn.launches}))
Bw = int(sys.argv[1])
batches["wide"] = ctc_batch(99, torch.full((Bw,), T), torch.full((Bw,), 250), Bw)
for batch, tag in (("full", ""), ("wide", "_wide")):
    for name, (fn, run) in rows.items():
        run(batches[batch])
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            run(batches[batch])
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({"B": f"{name}{tag}_ms", "ms": start.elapsed_time(end) / 5}))
"""


def _persistent_digests(root, wide_b):
    """({B: (sha256, launches)}, {row: ms}) of ``_PERSISTENT_DIGEST`` run
    in ``root``, a subprocess: the digests, and rows 4, 9, 10 and 11 timed
    (the last three also at batch ``wide_b``)."""
    res = subprocess.run([sys.executable, "-c", _PERSISTENT_DIGEST, str(wide_b)], cwd=root,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"persistent_study: the digests in {root} failed:\n{res.stderr[-2000:]}")
    rows = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    return ({r["B"]: (r["sha256"], r["persistent"]) for r in rows if "sha256" in r},
            {r["B"][:-3]: r["ms"] for r in rows if "ms" in r})


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
    rows 7, 2, 5, 3, 4, 9, 10 and 11's outputs there and here
    (``_PERSISTENT_DIGEST``), which must be equal bit for bit, and row 4's
    unfused pass and rows 9, 10 and 11 at the default step's shape, and
    rows 9, 10 and 11 at the wide step's batch (``phase_train_wide``'s
    B), timed there and here by the same script, in turns."""
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
        # Both trees in turns (parent, here, here, parent), each in its own
        # process: the digests, row 4's unfused pass and the CTC forwards
        # timed, the latter also at the wide step's batch.
        wide_b = _plan_edge(_wide_config(), TRAIN_B, "gates")
        turns = [(name, *_persistent_digests(root, wide_b)) for name, root in (
            ("parent", os.path.abspath(parent)), ("here", ROOT), ("here", ROOT),
            ("parent", os.path.abspath(parent)))]
        here, there = turns[1][1], turns[0][1]
        out["digests_against_parent"] = {"parent": parent, "here": here,
                                         "parent_digests": there}
        rows = {400, 473, "row2", "row5", "row3", "row4", "row9", "row10", "row11", "row6",
                "row8", "row1_pd", "row3_pd", "row4_pd", "row2_ps", "row5_ps", "row7_ps",
                "row6_ps", "row8_ps", "row14_wmma", "row14_wgmma", "row15_skinny"}
        # Row 8's carry product sums in another order than the parent's
        # per-step kernel: it must repeat here, not equal the parent's.
        same_as = lambda who, b: [d.get(b, ("",))[0] for n, d, _ in turns if n == who]
        if (set(here) != rows
                or any(d.get(b, ("",))[0] != here[b][0]
                       for _, d, _ in turns for b in here if b != "row8")
                or len(set(same_as("here", "row8"))) != 1
                or len(set(same_as("parent", "row8"))) != 1):
            fail(f"persistent_study: rows 7, 2, 5, 3, 4, 9, 10, 11 and 6's outputs (and the "
                 f"per-step, per-diagonal and weight-gradient kernels') differ from the "
                 f"parent's, or any row's between runs of one tree: {turns}")
        out["row8_equals_parent"] = same_as("here", "row8")[0] == same_as("parent", "row8")[0]
        if not all(v[1] for _, d, _ in turns for v in d.values()):
            fail("persistent_study: the digests did not all run the kernels")
        out["wide_b"] = wide_b
        for row in ("row4", "row9", "row10", "row11", "row9_wide", "row10_wide", "row11_wide"):
            mean = lambda who: sum(ms[row] for n, _, ms in turns if n == who) / 2
            out[f"{row}_against_parent"] = {
                "turns": [(n, ms[row]) for n, _, ms in turns], "ms": mean("here"),
                "parent_ms": mean("parent"), "smi": smi_clocks()}
    emit("persistent_study", **out)


HUNT_ITERS = 5
# What each iteration of the fault hunt runs, each in a child process: the
# reverse-diagonal and fused card tests, phase train, and the layer
# backwards' checks.
HUNT_RUNS = {
    "card_tests": ["-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
                   "tests/test_torch_cuda_kernels.py", "-k", "bwd or fuse"],
    "train": ["chip_smoke.py", "--phases", "train"],
    "layer_bwd": ["-c", "import chip_smoke; chip_smoke._hunt_layer_checks()"],
    "f32_card_tests": ["-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
                       "tests/test_torch_cuda_f32_persistent.py"],
    "f32_bwd": ["-c", "import chip_smoke; chip_smoke._hunt_f32_checks()"],
    "f32_fwd": ["-c", "import chip_smoke; chip_smoke._hunt_f32_fwd_checks()"],
}
# The checks' positive control, a child run before the loop: a launch that
# states a bound one step short must trap in the checked build (non-zero
# exit, an RST_CHECK line) and run to its end in the default one.
HUNT_CONTROL = ["-c", "import chip_smoke; chip_smoke._hunt_planted_overrun()"]
# Lines of a child's output that name a fault.
HUNT_SIGNS = ("RST_CHECK", "illegal memory access", "device-side assert", "index out of bounds",
              "unspecified launch failure", "CUDA error")


def _hunt_layer_checks():
    """The layer backwards' card checks alone (a fault hunt child): the
    gates-mode backward at B=70 and 128, row groups in turn, beside the
    per-step kernel; the recompute backward at the route's batch (B=400 on
    the H100), T=512, and at a chunk edge (T one step past a chunk, B=70),
    beside its planted fault and the per-step kernel."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    checks = []
    _bwd_row_groups_check(checks)
    _bwd_row_groups_check(checks, Bn=128, T=64, seed=151)
    for i, (T, Bn) in enumerate(_recompute_check_shapes(400)):
        _recompute_check_at(T, Bn, 150 + i, checks, plain_faults=False)
    print(json.dumps({"layer_bwd_checks": len(checks)}), flush=True)


def _hunt_f32_checks():
    """The float32 persistent backward's card checks alone (a fault hunt
    child): row 8 at B=400, T=512 (seven row groups, two rebuild chunks)
    and row 4's layer sweep at B=64, T=512 in drop mode 2, each against its
    plain version."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    f32, T, checks = torch.float32, F32_LAYER_T, []
    lay = _widen(_layer_inputs(T, F32_WIDE_B, [T] * F32_WIDE_B, seed=160))
    lout, _, _, lcseq = tlt.recurrence_train_lean(lay["x_proj"], lay["w_h"], lay["mask"],
                                                  lay["h0"], lay["c0"], f32)
    rargs = (lay["dout"], lay["x"], torch.cat([lay["h0"][None], lout[:-1]]), lcseq, lay["c0"],
             lay["mask"], lay["w_x"], lay["b"], lay["w_h"], lay["dhn"], lay["dcn"])
    _rel_check("hunt f32 recurrence_bwd_recompute", tlt.recurrence_bwd_recompute(*rargs),
               tlt.recurrence_bwd_recompute_plain(*rargs), F32_KERNEL_TOL, checks)
    del lay, lout, lcseq, rargs
    inp = _widen(_train_inputs(T, TRAIN_B, [T] * TRAIN_B, seed=161))
    drop = _drop(2, T, TRAIN_B, 162)
    outs, gates, cseq, _, _ = wf.wavefront_train(*[inp[k] for k in FWD_ARGS], f32, *drop)
    bargs = [_widen(_bwd_inputs(inp, outs, gates, cseq, seed=163))[k] for k in BWD_ARGS]
    gi = BWD_ARGS.index("gates")
    ref = wf.wavefront_bwd_plain(*bargs[:gi], gates.clone(), *bargs[gi + 1:], outs, *drop)
    _rel_check("hunt f32 wavefront_bwd", wf.wavefront_bwd(*bargs, outs, *drop), ref,
               F32_KERNEL_TOL, checks)
    print(json.dumps({"f32_bwd_checks": len(checks)}), flush=True)


def _hunt_f32_fwd_checks():
    """The float32 training forward's layer sweep and the float32 skinny
    tile's card checks alone (a fault hunt child): row 3 at B=64, T=512 in
    drop mode 2 and at B=129 (three row groups), T=64 in drop mode 1; row
    15 at both projections (N = 224,640); each against its plain version."""
    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    f32, checks = torch.float32, []
    for T, Bn, mode, seed in ((F32_LAYER_T, TRAIN_B, 2, 164), (64, 129, 1, 165)):
        args = [_widen(_train_inputs(T, Bn, [T - (7 * b) % T for b in range(Bn)],
                                     seed=seed))[k] for k in FWD_ARGS]
        drop = _drop(mode, T, Bn, seed)
        _rel_check(f"hunt f32 wavefront_train B={Bn}", wf.wavefront_train(*args, f32, *drop),
                   wf.wavefront_train_plain(*args, f32, *drop), F32_KERNEL_TOL, checks)
    g = torch.Generator().manual_seed(166)
    N = TRAIN_T * TRAIN_B
    for D, Gs in ((120, H), (H, V)):
        x = torch.randn((N, D), generator=g).to(DEVICE)
        dg = (torch.randn((N, Gs), generator=g) * 0.01).to(DEVICE)
        _rel_check(f"hunt f32 weight_grad D={D}", gm.weight_grad(x, dg, compute_dtype=f32),
                   gm.weight_grad_plain(x, dg, compute_dtype=f32), F32_KERNEL_TOL, checks)
    print(json.dumps({"f32_fwd_checks": len(checks)}), flush=True)


def _hunt_planted_overrun():
    """The fault hunt's positive control (a child process): the recompute
    backward at H=1024, B=70, T=16 (one rebuild chunk, two row groups)
    launched with ``skip_barrier`` bit 4, which states the rebuild buffer's
    rows one step short, so its first step's reads lie past the stated
    bound.  The checked build must trap there; the default build reads the
    buffer's real rows and runs to its end."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf, T, Bn = torch.bfloat16, 16, 70
    inp = _layer_inputs(T, Bn, [T] * Bn, seed=157, proj_dtype=bf)
    out, _, _, cseq = tlt.recurrence_train_lean_plain(
        inp["x_proj"], inp["w_h"], inp["mask"], inp["h0"], inp["c0"], bf)
    h_prev = torch.cat([inp["h0"].to(bf)[None], out.to(bf)[:-1]])
    args = [inp["dout"], inp["x"], h_prev, cseq, inp["c0"].to(bf).float(), inp["mask"],
            inp["w_x"], inp["b"], inp["w_h"], inp["dhn"], inp["dcn"]]
    plan = tlt.bwd_plan(Bn, H, torch.cuda.get_device_properties(0).multi_processor_count)
    tlt._recompute_persistent_launch(*args, plan, skip_barrier=4)
    torch.cuda.synchronize()
    print(json.dumps({"planted_overrun": "ran to its end"}), flush=True)


def _hunt_child(argv, env):
    """One fault-hunt child: its exit code, seconds, the lines that name a
    fault (``HUNT_SIGNS``) and, if it failed, the end of its output."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=1200)
    text = res.stdout + res.stderr
    signs = [ln.strip()[:300] for ln in text.splitlines() if any(k in ln for k in HUNT_SIGNS)]
    return {"rc": res.returncode, "seconds": time.perf_counter() - t0,
            "fault_lines": signs[:8], "tail": text[-1500:] if res.returncode else ""}


def phase_fault_hunt(iters=HUNT_ITERS):
    """The bounds-checked build under CUDA_LAUNCH_BLOCKING=1 (opt-in): first
    its positive control (``HUNT_CONTROL``: must exit non-zero with an
    RST_CHECK line in the checked build and 0 in the default one), then
    each of ``HUNT_RUNS`` in a child process with RST_BOUNDS_CHECK=1 (the
    checked libraries, ``<kernel>-checked-<hash>.so``, built by the first
    child), ``iters`` times; records each run's exit code, seconds and the
    lines that name a fault (``HUNT_SIGNS``), with the tree's hash.  Fails
    after the loop if any run failed or the control did not trap."""
    from rnn_speech_tpu_torch.ops import _build

    env = dict(os.environ, RST_BOUNDS_CHECK="1", CUDA_LAUNCH_BLOCKING="1")
    default_env = {k: v for k, v in env.items() if k != "RST_BOUNDS_CHECK"}
    with _environ(RST_BOUNDS_CHECK="1"):
        checked = sorted(_build.library_path(k).name for k in _build.KERNELS)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", "from rnn_speech_tpu_torch.ops import _build; "
                          "_build.build_all()"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        fail(f"fault_hunt: the checked build failed:\n{res.stderr[-3000:]}")
    build_s = time.perf_counter() - t0
    control = {"checked": _hunt_child(HUNT_CONTROL, env),
               "default": _hunt_child(HUNT_CONTROL, default_env)}
    print(json.dumps({"control": {k: {n: v[n] for n in ("rc", "seconds", "fault_lines")}
                                  for k, v in control.items()}}), flush=True)
    trapped = control["checked"]["rc"] != 0 and any(
        "RST_CHECK" in ln for ln in control["checked"]["fault_lines"])
    runs = []
    for i in range(iters):
        for name, argv in HUNT_RUNS.items():
            runs.append({"iteration": i, "run": name, **_hunt_child(argv, env)})
            print(json.dumps({k: runs[-1][k] for k in ("iteration", "run", "rc", "seconds",
                                                       "fault_lines")}), flush=True)
    failed = [r for r in runs if r["rc"] != 0]
    emit("fault_hunt", tree_sha256=RECORD.get("tree_sha256"), iterations=iters,
         checked_libraries=checked, build_seconds=build_s, control=control,
         control_trapped=trapped, runs=runs, failed=len(failed))
    if not trapped or control["default"]["rc"] != 0:
        fail(f"fault_hunt: the positive control must trap in the checked build and run in "
             f"the default one: {control}")
    if failed:
        fail(f"fault_hunt: {len(failed)} of {len(runs)} runs failed: "
             f"{[(r['iteration'], r['run'], r['rc'], r['fault_lines']) for r in failed]}")


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
    diagonal at B=64 and 96 (two warpgroups a CTA), T=3510 in drop mode 2
    (one pass; each call writes
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

    # The reverse diagonal at the default step's batch (one warpgroup a CTA)
    # and at the fused checks' B=96 (two warpgroups; its stamps are the first
    # warpgroup's).
    T = TRAIN_T
    for Bn in (TRAIN_B, max(FUSED_CHECK_B)):
        inp = _train_inputs(T, Bn, [T] * Bn, seed=177)
        drop = _drop(2, T, Bn, 178)
        outs, gates, cseq, _, _ = wf.wavefront_train(*[inp[k] for k in FWD_ARGS], bf, *drop)
        b_in = _bwd_inputs(inp, outs, gates, cseq, seed=179)
        bargs = [b_in[k] for k in BWD_ARGS] + [outs]
        plan = wf.wavefront_bwd_plan(Bn, H, L, False, sms)
        run = lambda: wf.wavefront_bwd(*bargs, *drop)
        row = dict(plan=plan, ms_per_pass=cuda_ms(run, iters=2))
        with mock.patch.object(wf, "wavefront_bwd_plan",
                               lambda *a, **k: {"kernel": "per_diagonal"}):
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
        del inp, outs, gates, cseq, b_in, bargs, stamps
        torch.cuda.empty_cache()
    return out


def _layer_kernel_timing(rec_B, wide_rec_B):
    """Each layered kernel alone at its route's shapes (full-length rows,
    T=3510): the gates-mode pair at B=64 (the layered default step), the
    recompute pair at ``rec_B`` (the recompute step).  Times are per train
    step: L calls of one layer each (``ms_per_call`` beside).  The library
    yardstick is torch.nn.LSTM with one layer at the same T and B: its
    cuDNN forward for the forwards (which also computes the input
    product), in turns with each, for the backwards
    its backward without weight gradients (``library_ms``; it still
    computes dx) and with them (``library_wgrad_ms``), both on one forward
    graph in turns with the kernel, beside the per-step kernel each
    backward replaced (``per_step_ms``, the parent design, in the same
    turns).  The gates-mode backward also at B=128 (two row groups) and the
    recompute backward at ``wide_rec_B``, each in turns with its per-step
    kernel alone (``b128``, ``wide``)."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    bf, T, G = torch.bfloat16, TRAIN_T, 4 * H
    out = {}
    for (fwd_name, bwd_name), Bn in ((("recurrence_train", "recurrence_bwd"), TRAIN_B),
                                     (("recurrence_train_lean", "recurrence_bwd_recompute"),
                                      rec_B)):
        lean = fwd_name.endswith("lean")
        inp = _layer_inputs(T, Bn, [T] * Bn, seed=170, proj_dtype=bf if lean else None,
                            on_device=True)
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
                             library_wgrad=with_dw,
                             per_step=lambda: tlt._recompute_per_step_launch(*args))
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
                             iters=2, library_wgrad=with_dw,
                             per_step=lambda: tlt._bwd_per_step_launch(inp["dout"], gates, cseq,
                                                                       c0r, *btail))
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
                             library_wgrad_ms=L * turns["library_wgrad_ms"],
                             per_step_ms=L * turns["per_step_ms"], calls=L,
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
    out["recurrence_bwd"]["b128"] = _bwd_vs_per_step(False, 128)
    out["recurrence_bwd_recompute"]["wide"] = _bwd_vs_per_step(True, wide_rec_B)
    return out


def _bwd_vs_per_step(recompute, Bn):
    """One layer backward at H=1024, T=3510, batch ``Bn`` (full-length rows)
    on the plan's kernel in turns with the per-step kernel it replaced:
    ms a call of each, µs a step, the plan."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    from rnn_speech_tpu_torch.ops.lstm_layer_train import input_projection

    bf, T = torch.bfloat16, TRAIN_T
    # Made on the card: at B=473 the host's generator would spend tens of
    # seconds on the (T, B, H) streams.
    g = torch.Generator(device=DEVICE).manual_seed(173)
    lim = (6.0 / (H + 4 * H)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g, device=DEVICE) * 2 - 1) * lim).to(bf)
    r = lambda *s, scale: torch.randn(s, generator=g, device=DEVICE) * scale
    x, w_x, b = r(T, Bn, H, scale=1.0).to(bf), w(H, 4 * H), r(4 * H, scale=0.1)
    inp = dict(x=x, w_x=w_x, w_h=w(H, 4 * H), b=b, mask=torch.ones((T, 1, Bn), device=DEVICE),
               x_proj=input_projection(x, w_x, b, bf, bf if recompute else torch.float32),
               h0=r(Bn, H, scale=0.2), c0=r(Bn, H, scale=0.2), dout=r(T, Bn, H, scale=0.1),
               dhn=r(Bn, H, scale=0.1), dcn=r(Bn, H, scale=0.1))
    tail = (inp["w_h"], inp["mask"], inp["h0"], inp["c0"], bf)
    c0r = inp["c0"].to(bf).float()
    if recompute:
        out, _, _, cseq = tlt.recurrence_train_lean(inp.pop("x_proj"), *tail)
        h_prev = torch.cat([inp["h0"].to(bf)[None], out.to(bf)[:-1]])
        del out
        args = (inp["dout"], inp["x"], h_prev, cseq, c0r, inp["mask"], inp["w_x"], inp["b"],
                inp["w_h"], inp["dhn"], inp["dcn"])
        kernel = lambda: tlt.recurrence_bwd_recompute(*args)
        per_step = lambda: tlt._recompute_per_step_launch(*args)
    else:
        _, _, _, gates, cseq = tlt.recurrence_train(inp.pop("x_proj"), *tail)
        args = (inp["dout"], gates, cseq, c0r, inp["mask"], inp["w_h"], inp["dhn"], inp["dcn"])
        kernel = lambda: tlt.recurrence_bwd(*args)
        per_step = lambda: tlt._bwd_per_step_launch(*args)
    torch.cuda.empty_cache()
    turns = in_turns(per_step, kernel, iters=1)
    del inp, args
    torch.cuda.empty_cache()
    return dict(batch=Bn, ms_per_call=turns["ms"], per_step_ms_per_call=turns["library_ms"],
                us_per_step=1e3 * turns["ms"] / T, plan=tlt.bwd_plan(Bn, H),
                turns=turns["turns"])


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
    if x.dtype == torch.float32:
        mm = lambda: torch.mm(a_cat, w_cat)
    else:
        mm = lambda: torch.mm(a_cat, w_cat, out_dtype=torch.float32)
    turns = in_turns(mm, lambda: tlt.rebuild_gates(x2, h2, w_x, w_h, b))
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
    _recompute_route_gate("train_layered", recompute)
    if not recompute["wgmma_launches"]["lean_persistent"]:
        fail("train_layered (recompute): the forward never ran the persistent kernel")
    recompute.update(
        memory_plan=[0, "recompute"], budget_gib=acoustic.default_residual_budget() / 2**30,
        plan_estimate_gib=acoustic.recompute_footprint(cfg, TRAIN_T, rec_B) / 2**30,
        gates_estimate_gib=acoustic.training_residual_bytes(cfg, TRAIN_T, rec_B) / 2**30)
    del state, batch
    torch.cuda.empty_cache()
    timing = _layer_kernel_timing(rec_B, wide_rec_B)

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
        out[name]["us_per_step"] = 1e3 * out[name]["ms"] / (T - 1)
    out["ctc_alpha_stream"]["geometry"] = tck.alpha_geometry(S, V)._asdict()
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


def _wide_config():
    """The acoustic model's configuration that ``phase_train_wide`` sizes its
    batches for (the flagship width, bf16, the kernels, the wavefront)."""
    import torch

    from rnn_speech_tpu_torch.models import acoustic

    return acoustic.AcousticConfig(num_layers=L, hidden_size=H, input_dim=120, num_labels=V,
                                   compute_dtype=torch.bfloat16, use_kernels=True,
                                   wavefront=True)


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
    full-length rows, drop mode 2 (the default step's), on the plan's
    persistent kernel: in turns with the per-diagonal fused pass it
    replaces (``per_diagonal_ms``) and cuDNN's 3-layer backward with weight
    gradients on one forward graph (``library_ms``, the whole pass's
    yardstick, ``_nn_lstm_backward``), beside the card's clocks; where
    cuDNN's graph does not fit beside the pass's inputs, cuDNN is timed
    alone once they are freed (``library_alone_ms``, not in turns).  Beside
    them the unfused pass's ms (``ms_unfused``), the bound, the launches a
    pass (windows x row groups) and the W_h bytes they load into shared
    memory, and its window products alone (``lstm_wavefront.dwx_windows``)
    in turns with one torch.mm (bf16 operands, f32 out) per boundary for the
    same dW_x on the same operands (``window_products_ms``,
    ``window_library_ms``); with ``plain`` also its plain version's ms.  The
    bound counts 2·T·B·H·4H·(2L-1 + L-1) operations, or the bytes of the
    unfused pass's inputs and outputs without the xdrop stream plus the
    (L-1, H, 4H) f32 dW_x.  Each call writes dgates over its gates
    residual: later calls run on dgates (the same work), the plain version
    on a copy."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    T, bf, f32, G = TRAIN_T, torch.bfloat16, torch.float32, 4 * H
    N = T * Bn
    plan = wf.wavefront_bwd_plan(Bn, H, L, True,
                                 torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["kernel"] != "persistent":
        fail(f"fused pass timing B={Bn}: the plan does not take the persistent kernel: {plan}")
    windows = -(-(T + L - 1) // wf.FUSE_DWX_WINDOW)
    groups = wf.wavefront_bwd_row_groups(Bn)
    inp = _train_inputs(T, Bn, [T] * Bn, seed=170, on_device=True)
    drop = _drop(2, T, Bn, 172)
    outs, gates, cseq, _, _ = wf.wavefront_train(*[inp[k] for k in FWD_ARGS], bf, *drop)
    b_in = _bwd_inputs(inp, outs, gates, cseq, seed=171, on_device=True)
    del inp, gates
    bargs = [b_in[k] for k in BWD_ARGS]
    out = {"batch": Bn, "frames": T, "drop_mode": 2, "plan": plan,
           "launches_per_pass": windows * len(groups),
           "w_h_load_bytes": windows * sum(
               plan["grid"] * wf.wavefront_bwd_resident(H, wg) * wf._WB_BOX
               for _, _, wg in groups)}
    if plain:
        pargs = [b_in[k].clone() if k == "gates" else b_in[k] for k in BWD_ARGS]
        out["plain_ms"] = cuda_ms(lambda: wf.wavefront_bwd_plain(*pargs, outs, *drop,
                                                                 fuse_dwx=True),
                                  iters=1, warmup=0)
        del pargs
        torch.cuda.empty_cache()
    kernel = lambda: wf.wavefront_bwd(*bargs, outs, *drop, fuse_dwx=True)
    per_diagonal = lambda: _bwd_per_diagonal(bargs + [outs], drop, fuse_dwx=True)
    try:
        library = _nn_lstm_backward(T, Bn, L)[1]
    except torch.cuda.OutOfMemoryError as err:
        library = None
        out["library_in_turns"] = {"fits": False, "error": str(err).splitlines()[0]}
        torch.cuda.empty_cache()
    if library is not None:
        turns = in_turns(library, kernel, iters=1, per_diagonal=per_diagonal)
        out.update(library_ms=turns["library_ms"], per_diagonal_ms=turns["per_diagonal_ms"])
    else:
        turns = in_turns(per_diagonal, kernel, iters=1)
        out["per_diagonal_ms"] = turns["library_ms"]
    out.update(ms=turns["ms"], turns=turns["turns"],
               library="torch.nn.LSTM (cuDNN, bf16, 3 x 1024) backward with weight gradients")
    del library
    torch.cuda.empty_cache()
    out["ms_unfused"] = cuda_ms(lambda: wf.wavefront_bwd(*bargs, outs, *drop), iters=2)
    # The window products alone (as drop mode 0 runs them, on the Hopper
    # tile) and their library yardstick, on the same operands in turns.
    dg = b_in["gates"]
    wturns = in_turns(lambda: [torch.mm(outs[l].reshape(N, H).t(), dg[l + 1].reshape(N, G),
                                        out_dtype=f32) for l in range(L - 1)],
                      lambda: wf.dwx_windows(outs, dg), iters=2)
    wflops = 2 * T * Bn * H * G * (L - 1)
    out.update(window_products_ms=wturns["ms"],
               window_products_tflops=wflops / wturns["ms"] / 1e9,
               window_library_ms=wturns["library_ms"],
               window_library_tflops=wflops / wturns["library_ms"] / 1e9,
               window_library="torch.mm (bf16, f32 out) per boundary for dW_x of layers 1..L-1",
               window_turns=wturns["turns"])
    flops = 2 * T * Bn * H * G * (2 * L - 1 + L - 1)
    nbytes = (T * Bn * H * 2 + (2 * L - 1) * H * G * 2 + T * Bn * 4
              + L * T * Bn * (G + H) * 2 + 3 * L * Bn * H * 4         # inputs
              + (L - 1) * T * Bn * H * 2                               # outs read
              + L * T * Bn * G * 2 + 2 * L * Bn * H * 4                # outputs
              + (L - 1) * H * G * 4)                                   # dW_x
    out["bound_ms"], out["bound_by"] = _bounds(flops, nbytes)
    out.update(flops=flops, bytes=nbytes)
    if "library_ms" not in out:                      # cuDNN alone, once the inputs are freed
        del bargs, b_in, outs, cseq, dg
        torch.cuda.empty_cache()
        try:
            out["library_alone_ms"] = cuda_ms(_nn_lstm_backward(T, Bn, L)[1], iters=1)
        except torch.cuda.OutOfMemoryError as err:
            out["library_alone"] = {"fits": False, "error": str(err).splitlines()[0]}
        torch.cuda.empty_cache()
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
    keep_left_out.persistent_launches = keep_left_out.fused_persistent_launches = 0
    keep_left_out.per_diagonal_launches = 0
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
    cfg = _wide_config()
    wide_B = _plan_edge(cfg, TRAIN_B, "gates")
    if not wf.fuse_dwx_enabled(L, TRAIN_T, wide_B, H, 2, 2):
        fail(f"train_wide: the switch does not fuse dW_x at B={wide_B}")
    scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=0, Bn=wide_B)
    wide, state = _run_steps(scfg, state, batch, reps=1, record_stages=True, warmup=1)
    if not wide["fused_launches"]:
        fail(f"train_wide: the B={wide_B} step did not run the fused pass: {wide}")
    paths = wide["wgmma_launches"]
    if (paths["wavefront_bwd_fused_persistent"] != wide["fused_launches"]
            or paths["wavefront_bwd_per_diagonal"]):
        fail(f"train_wide: the B={wide_B} step's fused passes did not all run the persistent "
             f"kernel, or a reverse pass ran the per-diagonal kernel: {paths}")
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
    _recompute_route_gate("train_wide", recompute)
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


# ------------------------------------------ the char LM and streaming phases

LM_WEIGHT = 0.4            # benchmarks/beam_quality.json's LM weight
LM_TRAIN_STEPS = 20
STREAM_CLIPS = 4
STREAM_CHUNKS = (1.0, 0.3)  # seconds of audio a chunk

# The committed bundle with its LM's widths (its hyperparams.json's ``lm``
# section, 1x256); ``{test}`` adds a test_dataset_dirs line.
BUNDLE_INI = """[acoustic_network_params]
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

[lm_network_params]
num_layers : 1
hidden_size : 256

[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : 100
steps_per_evaluation : 100
checkpoint_dir : {bundle}

[training]
{test}max_input_seq_length : 600
max_target_seq_length : 80

[logging]
log_level : WARNING

[tpu]
compute_dtype : bfloat16
use_pallas_lstm : True
wavefront : True
bucket_count : 8
prefetch_depth : 2
"""

# config.ini's LM (2x512, batch 8, lr 1e-4, keep 0.9, clip 5; rows of at
# most 128 characters) on a fresh checkpoint_dir, over a text corpus of the
# synth's sentences (the transcripts the renderer speaks).
LM_TRAIN_INI = """[acoustic_network_params]
num_layers : 3
hidden_size : 1024
dropout_input_keep_prob : 0.8
dropout_output_keep_prob : 0.5
batch_size : 10
mini_batch_size : 3
learning_rate : 0.0003
lr_decay_factor : 0.33
grad_clip : 1
batch_normalization : False
rnn_state_reset_ratio : 0.25
signal_processing : fbank
language : english

[lm_network_params]
num_layers : 2
hidden_size : 512
dropout : 0.9
batch_size : 8
learning_rate : 1e-4
lr_decay_factor : 0.97
grad_clip : 5
text_corpus : {corpus}

[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : 10
steps_per_evaluation : 0
checkpoint_dir : {ckpt}

[training]
training_dataset_dirs :
max_input_seq_length : 3510
max_target_seq_length : 600

[logging]
log_level : WARNING
"""


def _bundle_logits(params, cfg, sigs):
    """Logits (T, N, V) and valid lengths of ``sigs`` through the fbank
    frontend and the bundle's forward on ``DEVICE`` (one padded batch)."""
    import numpy as np
    import torch

    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

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
    return logits, acoustic.output_lengths(cfg, nf)


def _write_held_out_flac(tmp, texts, sigs):
    """The held-out clips as a LibriSpeech-layout FLAC corpus (int16) under
    ``tmp/held_out``; returns its root."""
    import numpy as np

    from rnn_speech_tpu_torch.runtime import flac_enc

    chapter = os.path.join(tmp, "held_out", "spk", "chap")
    os.makedirs(chapter)
    with open(os.path.join(chapter, "1-2.trans.txt"), "w") as fh:
        for i, (text, sig) in enumerate(zip(texts, sigs)):
            pcm = np.clip(np.round(sig * 32768.0), -32768, 32767).astype(np.int16)
            flac_enc.encode_flac(os.path.join(chapter, f"1-2-{i:04d}.flac"), pcm, SR)
            fh.write(f"1-2-{i:04d} {text}\n")
    return os.path.join(tmp, "held_out")


def _cer_pct(truth, hyps):
    import numpy as np

    return 100.0 * float(np.mean([_edit_distance(t, h.strip()) / max(len(t), 1)
                                  for t, h in zip(truth, hyps)]))


def _last_line(text):
    return text.strip().splitlines()[-1] if text.strip() else ""


def phase_lm():
    """The beam search with the bundle's char LM (shallow fusion at
    ``LM_WEIGHT``) on the held-out clips, card against CPU on the same
    logits, its time beside the AM-only search's and the LM step's; then
    the CLI's LM modes in one child: ``--evaluate`` and ``--file`` with
    the LM, ``--train_language`` at config.ini's LM width, and
    ``--generate_text`` on the trained LM and on the bundle's."""
    import io

    import numpy as np
    import torch

    from rnn_speech_tpu_torch import audio_io, cli, params as params_mod, synth
    from rnn_speech_tpu_torch.charmap import get_char_map
    from rnn_speech_tpu_torch.models import acoustic, language
    from rnn_speech_tpu_torch.ops import decode
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    K = cli.DEFAULT_BEAM_WIDTH
    char_map = get_char_map("english")
    params = params_mod.load_bundle(BUNDLE, device=DEVICE)
    cfg = acoustic.config_for_params(params, compute_dtype=torch.bfloat16, use_kernels=True,
                                     wavefront=True)
    lm_params = {dev: params_mod.load_bundle(BUNDLE, device=dev, part="language")
                 for dev in (DEVICE, "cpu")}
    lm_cfg = language.LanguageConfig(len(lm_params["cpu"]["lstm"]),
                                     lm_params["cpu"]["lstm"][0]["w_h"].shape[0], len(char_map))
    lm = {dev: language.stepper(p, lm_cfg) for dev, p in lm_params.items()}
    texts, sigs = _held_out()
    truth = [t.lower() for t in texts]
    wf.lstm_stack_wavefront.launches = 0
    logits, out_len = _bundle_logits(params, cfg, sigs)
    fwd_launches = wf.lstm_stack_wavefront.launches
    with torch.no_grad():
        labels, lab_len, scores = decode.beam_search_decode(logits, out_len, K, lm=lm[DEVICE],
                                                            lm_weight=LM_WEIGHT)
        cpu = decode.beam_search_decode(logits.cpu(), out_len.cpu(), K, lm=lm["cpu"],
                                        lm_weight=LM_WEIGHT)
    best, best_len = labels[:, 0].cpu(), lab_len[:, 0].cpu()
    hyps = [char_map.decode(best[b, : int(best_len[b])].tolist()) for b in range(len(sigs))]
    entry = {"clips": len(sigs), "beam_width": K, "lm_weight": LM_WEIGHT,
             "frames": int(logits.shape[0]),
             "lm": {"layers": lm_cfg.num_layers, "hidden": lm_cfg.hidden_size},
             "cer_pct": _cer_pct(truth, hyps), "cer_limit_pct": CER_LIMIT,
             "best_equal_cpu": bool(torch.equal(best, cpu[0][:, 0])
                                    and torch.equal(best_len, cpu[1][:, 0])),
             "all_beams_equal_cpu": bool(torch.equal(labels.cpu(), cpu[0])),
             "scores_max_abs_diff_cpu": float((scores.cpu() - cpu[2]).abs().max()),
             "forward_launches": fwd_launches,
             "exact_clips": sum(int(t == h) for t, h in zip(truth, hyps)), "hyps": hyps}
    if entry["cer_pct"] > CER_LIMIT or not entry["best_equal_cpu"] or not fwd_launches:
        fail(f"lm: {entry}")

    # Times on the card: the search with and without the LM at the
    # held-out batch (B=32, the bundle's --evaluate batch) and at B=1 (a
    # --file clip), and one LM step at B·K rows for B=32 and B=128.
    timing = {}
    with torch.no_grad():
        n1 = int(out_len[0])
        for tag, lg, ln in (("b32", logits, out_len), ("b1", logits[:n1, :1], out_len[:1])):
            lm_ms = cuda_ms(lambda: decode.beam_search_decode(lg, ln, K, lm=lm[DEVICE],
                                                              lm_weight=LM_WEIGHT), iters=1)
            am_ms = cuda_ms(lambda: decode.beam_search_decode(lg, ln, K), iters=1)
            rows, frames = lg.shape[1], lg.shape[0]
            timing[tag] = {"batch": rows, "frames": frames, "lm_ms": lm_ms, "am_only_ms": am_ms,
                           "lm_ms_per_clip": lm_ms / rows, "am_only_ms_per_clip": am_ms / rows,
                           "lm_ms_per_frame": lm_ms / frames,
                           "am_only_ms_per_frame": am_ms / frames}
        init, advance = lm[DEVICE]
        for n in (32 * K, B * K):
            state, _ = init(n)
            chars = torch.arange(n, device=DEVICE) % len(char_map)
            timing[f"lm_step_n{n}_ms"] = cuda_ms(lambda: advance(state, chars), iters=20)

    # The CLI's LM modes in one child process.
    exact = [i for i, (t, h) in enumerate(zip(truth, hyps)) if t == h]
    if not exact:
        fail("lm: no clip was transcribed exactly with the LM")
    clip = exact[0]
    with tempfile.TemporaryDirectory() as tmp:
        test_root = _write_held_out_flac(tmp, texts, sigs)
        ini = os.path.join(tmp, "bundle.ini")
        with open(ini, "w") as fh:
            fh.write(BUNDLE_INI.format(bundle=BUNDLE,
                                       test=f"test_dataset_dirs : {test_root}\n"))
        wav = os.path.join(tmp, "clip.wav")
        audio_io.write_wav(wav, sigs[clip], SR)
        corpus = os.path.join(tmp, "corpus.txt")
        with open(corpus, "w") as fh:
            fh.write("\n".join(synth.sample_sentences(400, np.random.default_rng(3))))
        train_ini = os.path.join(tmp, "lm_train.ini")
        with open(train_ini, "w") as fh:
            fh.write(LM_TRAIN_INI.format(corpus=corpus, ckpt=os.path.join(tmp, "lm_ckpt")))
        lw = ["--lm_weight", str(LM_WEIGHT)]
        runs = _run_cli_child([
            ["--evaluate", "--config", ini, *lw],
            ["--file", wav, "--config", ini, *lw],
            ["--train_language", "--config", train_ini, "--max_steps", str(LM_TRAIN_STEPS)],
            ["--generate_text", "--config", train_ini],
            ["--generate_text", "--config", ini],
        ], tmp, "lm")
        trained = os.path.exists(os.path.join(
            tmp, "lm_ckpt", "language", f"acousticmodel-{LM_TRAIN_STEPS}.npz"))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cpu_rc = cli.main(["--generate_text", "--config", ini, "--device", "cpu"])
    ev, file_run, train, gen_trained, gen_bundle = runs
    wer, cer = _printed_rates(ev["stdout"])
    losses = train.get("lm_losses", [])
    cli_entry = {
        "evaluate": {"wer_pct": wer, "cer_pct": cer, "wall_s": ev["wall_s"],
                     "row1_launches": ev["launches"].get("lstm_wavefront"),
                     "loader_clips": ev["loader_clips"]},
        "file": {"printed": _last_line(file_run["stdout"]), "expected": truth[clip],
                 "row1_launches": file_run["launches"].get("lstm_wavefront"),
                 "wall_s": file_run["wall_s"]},
        "train_language": {"printed": _last_line(train["stdout"]), "steps": len(losses),
                           "losses": losses, "checkpoint": trained,
                           "ms_per_step_median": train.get("lm_ms_per_step_median"),
                           "shape": {"layers": 2, "hidden": 512, "batch": 8, "T": 128},
                           "wall_s": train["wall_s"]},
        "generate_text": {"trained": _last_line(gen_trained["stdout"]),
                          "bundle": _last_line(gen_bundle["stdout"]),
                          "bundle_cpu": _last_line(printed.getvalue())},
        "process_s": ev["process_s"],
    }
    problems = [f"{' '.join(r['argv'][:1])} rc={r['rc']}" for r in runs if r["rc"] != 0]
    if cer is None or float(cer) > CER_LIMIT:
        problems.append(f"--evaluate with the LM: CER {cer}")
    if not ev["launches"].get("lstm_wavefront") or not file_run["launches"].get("lstm_wavefront"):
        problems.append("row 1 did not launch under --evaluate or --file with the LM")
    if cli_entry["file"]["printed"] != truth[clip]:
        problems.append(f"--file printed {cli_entry['file']['printed']!r}")
    if (len(losses) != LM_TRAIN_STEPS or not all(math.isfinite(x) for x in losses)
            or not np.mean(losses[-5:]) < np.mean(losses[:5]) or not trained):
        problems.append(f"--train_language: losses {losses}, checkpoint {trained}")
    gen = cli_entry["generate_text"]
    if cpu_rc != 0 or gen["bundle"] != gen["bundle_cpu"] or len(gen["trained"]) < 2:
        problems.append(f"--generate_text: {gen}")
    if problems:
        fail("lm: " + "; ".join(problems) + f" {cli_entry}")
    emit("lm", **entry, timing=timing, cli=cli_entry)


def _stream_text(tr, sig, chunk):
    """(text, ms a chunk, audio seconds per wall second) of ``sig`` fed to
    the transcriber ``tr`` in pieces of ``chunk`` samples, then reset."""
    pieces, t0 = [], time.perf_counter()
    for i in range(0, len(sig), chunk):
        pieces.append(tr.feed(sig[i:i + chunk]))
    pieces.append(tr.finish())
    seconds = time.perf_counter() - t0
    tr.reset()
    return "".join(pieces), 1e3 * seconds / -(-len(sig) // chunk), len(sig) / SR / seconds


def phase_stream():
    """``StreamingTranscriber`` (the ``--record`` engine) on the card over
    held-out clips at two chunk sizes, greedy and beam-16 with the LM,
    against the CPU transcriber and the whole-clip text."""
    import torch

    from rnn_speech_tpu_torch import cli, params as params_mod
    from rnn_speech_tpu_torch.charmap import get_char_map
    from rnn_speech_tpu_torch.config import HyperParamStore, load_config
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    texts, sigs = _held_out()
    texts, sigs = texts[:STREAM_CLIPS], sigs[:STREAM_CLIPS]
    char_map = get_char_map("english")
    with tempfile.TemporaryDirectory() as tmp:
        ini = os.path.join(tmp, "bundle.ini")
        with open(ini, "w") as fh:
            fh.write(BUNDLE_INI.format(bundle=BUNDLE, test=""))
        config = HyperParamStore(load_config(ini)).config
    lms = {dev: cli.load_lm_stepper(config, char_map, LM_WEIGHT, dev)
           for dev in (DEVICE, "cpu")}
    params = params_mod.load_bundle(BUNDLE, device=DEVICE)
    cfg = acoustic.config_for_params(params, compute_dtype=torch.bfloat16, use_kernels=True,
                                     wavefront=True)
    out, problems = {}, []
    for name, width, weight in (("greedy", 1, 0.0),
                                ("beam_lm", cli.DEFAULT_BEAM_WIDTH, LM_WEIGHT)):
        lm = lms[DEVICE] if weight else None
        whole = [cli.transcribe(params, cfg, sig[None], [len(sig)], device=DEVICE,
                                beam_width=width, lm=lm, lm_weight=weight)[0] for sig in sigs]
        runs = {}
        wf.lstm_stack_wavefront.launches = wf.lstm_stack_wavefront.persistent_launches = 0
        for seconds in STREAM_CHUNKS:
            tr = cli.StreamingTranscriber(config, char_map, chunk_seconds=seconds,
                                          beam_width=width, lm=lm, lm_weight=weight,
                                          device=DEVICE)
            got = [_stream_text(tr, sig, tr.chunk_samples) for sig in sigs]
            runs[str(seconds)] = {"texts": [g[0] for g in got], "step_frames": tr.step_frames,
                                  "ms_per_chunk": [g[1] for g in got],
                                  "audio_s_per_wall_s": [g[2] for g in got]}
        launches = {"row1": wf.lstm_stack_wavefront.launches,
                    "row1_persistent": wf.lstm_stack_wavefront.persistent_launches}
        tr_cpu = cli.StreamingTranscriber(config, char_map, chunk_seconds=STREAM_CHUNKS[0],
                                          beam_width=width, lm=lms["cpu"] if weight else None,
                                          lm_weight=weight, device="cpu")
        cpu_texts = [_stream_text(tr_cpu, sig, tr_cpu.chunk_samples)[0] for sig in sigs]
        first = runs[str(STREAM_CHUNKS[0])]["texts"]
        dist = [_edit_distance(w, s) for w, s in zip(whole, first)]
        out[name] = {"beam_width": width, "lm_weight": weight, "whole_clip": whole,
                     "cpu_texts": cpu_texts, "distance_to_whole": dist,
                     "launches": launches, "runs": runs}
        if any(run["texts"] != first for run in runs.values()):
            problems.append(f"{name}: the chunk sizes give different text")
        if cpu_texts != first:
            problems.append(f"{name}: the CPU transcriber's text differs")
        if any(d > max(2, 0.2 * len(w)) for d, w in zip(dist, whole)):
            problems.append(f"{name}: distance to the whole clip {dist}")
        if not launches["row1"]:
            problems.append(f"{name}: row 1 did not launch at B=1 ({launches})")
    if problems:
        fail("stream: " + "; ".join(problems) + f" {out}")
    emit("stream", clips=len(sigs), truth=[t.lower() for t in texts],
         chunk_seconds=list(STREAM_CHUNKS), decoders=out)


# ------------------------------------------------------ the accuracy tools

# The accuracy phase: ``tools/flagship_accuracy_run.run`` at full width
# (3x1024, fbank-120, B=32, T <= 600), cut in size only.
ACC_CUTS = {"clips": 48, "test_clips": 16, "max_steps": 20, "steps_per_checkpoint": 10,
            "lm_layers": 1, "lm_hidden": 256, "lm_steps": 10,
            "eval_noise_levels": (2400.0, 4800.0), "headline_noise": 2400.0,
            "streaming_max_clips": 2, "streaming_chunk_seconds": (1.2,)}
ACC_BUNDLE_CLIPS = 64      # fresh clips of the committed bundle's decode
ACC_DECODE_BATCH = 64      # rows a decode batch: one beam search a level and mode
ACC_BEAM = 16
# The kernels the accuracy phase must launch: the training steps' (rows 3,
# 4, 9, 12, 14, 15, 16), the evaluation cadence's (10) and the decodes' (1),
# with rows 3, 4 and 1 on their persistent kernels.
ACC_ROWS = {"row3": "wavefront_train", "row4": "wavefront_bwd", "row9": "ctc_alpha_ckpt",
            "row12": "ctc_beta_post", "row14": "dgates_weight_grads", "row15": "weight_grad",
            "row16": "dropout", "row10": "ctc_alpha_lossonly", "row1": "lstm_stack_wavefront"}
ACC_PERSISTENT = ("row3", "row4", "row1")
# The full protocols (opt-in phases) and where their artifacts go.
FLAGSHIP_STEPS = 3000
FLAGSHIP_LEVELS = (900.0, 2400.0, 4800.0, 7200.0, 9600.0)   # the JAX artifact's sweep
FLAGSHIP_WER_LIMIT = 2.0   # percent, greedy at sigma=2400 (the JAX artifact: 0.12)
# Rows a decode batch in the full protocols (the tools' defaults: 10 and
# 20).  Rows decode independently, so the batch changes no text; it cuts
# the beam searches, each a host-bound loop over 600 frames, to a fifth.
FULL_DECODE_BATCH = 100
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def _acc_counters():
    from rnn_speech_tpu_torch.ops import ctc_kernel as tck
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    return {**_train_counters(), "ctc_alpha_lossonly": tck.ctc_alpha_lossonly,
            "lstm_stack_wavefront": wf.lstm_stack_wavefront}


def _acc_persistent():
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    return {"row3": wf.wavefront_train, "row4": wf.wavefront_bwd, "row1": wf.lstm_stack_wavefront}


def _acc_launches(fn):
    """Runs ``fn()`` with every accuracy-path counter set to 0 first;
    returns (its result, {row: launches}, {row: persistent launches})."""
    counters, persistent = _acc_counters(), _acc_persistent()
    _reset_launches(counters)
    for f in persistent.values():
        f.persistent_launches = 0
    out = fn()
    counts = _launch_counts(counters)
    return (out, {row: counts[name] for row, name in ACC_ROWS.items()},
            {row: f.persistent_launches for row, f in persistent.items()})


def _acc_curve_check(result, steps, every):
    """Every checkpoint window of the session logged its train error, eval
    error and learning rate, at steps every, 2·every, ..., steps."""
    want = list(range(every, steps + 1, every))
    return [f"curve {name}: steps {[s for s, _ in curve]} != {want}"
            for name, curve in result["curves"].items() if [s for s, _ in curve] != want]


def _acc_scored_check(sweep, clips, modes):
    """Each decode mode scored every clip at every level."""
    return [f"{level}/{mode}: {table.get(mode, {}).get('clips')} of {clips} clips"
            for level, table in sweep.items() for mode in modes
            if table.get(mode, {}).get("clips") != clips]


def _acc_launch_check(counts, persistent):
    return ([f"{row} ({ACC_ROWS[row]}) did not launch" for row, n in counts.items() if not n]
            + [f"{row} never ran its persistent kernel" for row in ACC_PERSISTENT
               if not persistent.get(row)])


def _acc_bundle_check(bundle, ckpt_dir):
    """The exported bundle restores (``params.load_bundle``; the acoustic
    part into the model's template by ``checkpoint.restore``) and holds the
    session's final checkpoints rounded to bf16, bit for bit."""
    import torch

    from rnn_speech_tpu_torch import params as params_mod
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.train import checkpoint as ckpt

    problems = []
    for part in ("acoustic", "language"):
        try:
            loaded = params_mod.flatten(params_mod.load_bundle(bundle, device=DEVICE, part=part))
        except (FileNotFoundError, KeyError, ValueError) as exc:
            problems.append(f"{part}: {exc}")
            continue
        final, step, lr = ckpt.restore_flat(os.path.join(ckpt_dir, part))
        got, bstep, blr = ckpt.restore_flat(os.path.join(bundle, part))
        if (bstep, blr) != (step, lr) or sorted(got) != sorted(final):
            problems.append(f"{part}: step/lr {bstep}/{blr} against {step}/{lr}, "
                            f"{len(got)} against {len(final)} tensors")
            continue
        rounded = {k: ckpt.bf16_bits_to_f32(ckpt.f32_to_bf16_bits(v)) for k, v in final.items()}
        bad = sorted(k for k in final if got[k].tobytes() != rounded[k].tobytes()
                     or loaded[k].cpu().numpy().tobytes() != rounded[k].tobytes())
        if bad:
            problems.append(f"{part}: {bad[:4]} differ from the bf16 of the final checkpoint")
    template = acoustic.init_params(torch.Generator().manual_seed(0), acoustic.AcousticConfig(
        num_layers=L, hidden_size=H, input_dim=120, num_labels=V), DEVICE)
    try:
        ckpt.restore(os.path.join(bundle, "acoustic"), template)
    except (KeyError, ValueError) as exc:
        problems.append(f"restore into the 3x1024 model: {exc}")
    return problems


def _acc_planted_bundle(bundle, out_dir):
    """A copy of ``bundle`` whose acoustic checkpoint has one tensor's
    first element moved by one bf16 step: a planted fault."""
    import shutil

    import numpy as np

    from rnn_speech_tpu_torch.train import checkpoint as ckpt

    shutil.copytree(bundle, out_dir)
    path = ckpt.latest_path(os.path.join(out_dir, "acoustic"))
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    key = next(k for k in sorted(flat) if not k.startswith("__"))
    flat[key] = flat[key].copy()
    flat[key].flat[0] += 1
    np.savez(path, **flat)
    return out_dir


def _early_stop_fault(frames=100):
    """The inference forward whose top-layer outputs past the first
    ``frames`` steps are never stored (zero), as if the kernel left its
    diagonal loop early: a planted fault.  (Zeroing a quarter of the
    units instead changed no text: the model trained with the output
    keep 0.6 shrugs it off.)"""
    from unittest import mock

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    real = wf.lstm_stack_wavefront

    def faulty(*args):
        out, hn, cn = real(*args)
        out = out.clone()
        out[frames:] = 0
        return out, hn, cn
    faulty.launches = faulty.persistent_launches = 0   # the wrapper counts by its name
    return mock.patch.object(wf, "lstm_stack_wavefront", faulty)


def _bundle_greedy_texts(items, use_kernels=True):
    """Greedy transcripts of ``items`` by the committed bundle on the card,
    through ``flagship_accuracy_run.decode_texts`` at the bundle's
    decode batch, on the kernels or (``use_kernels=False``) on the plain
    path."""
    import dataclasses

    from rnn_speech_tpu_torch import cli
    from rnn_speech_tpu_torch.tools import beam_quality_run as bq
    from rnn_speech_tpu_torch.tools import flagship_accuracy_run as fr

    config = bq.load_bundle_config(BUNDLE)
    config = config.replace(tpu=dataclasses.replace(config.tpu, use_pallas_lstm=use_kernels))
    forward, modes = fr.decode_modes(config, _char_map(), ACC_BEAM, 0.0, DEVICE)
    return fr.decode_texts(forward, items, modes["greedy"], _char_map(), ACC_DECODE_BATCH,
                           cli.max_samples_for(config), DEVICE)


def _char_map():
    from rnn_speech_tpu_torch.charmap import get_char_map

    return get_char_map("english")


def _bundle_points(n_clips, levels):
    """Fresh held-out points of the committed bundle (``beam_quality_run.
    fresh_held_out``: sentences it never trained on) at ``levels``."""
    from rnn_speech_tpu_torch.tools import beam_quality_run as bq
    from rnn_speech_tpu_torch.tools import flagship_accuracy_run as fr

    held = bq.fresh_held_out(BUNDLE, n_clips, 0, 1100, 160, SR)
    return fr.noisy_points(held, levels, 0)


def phase_accuracy():
    """``flagship_accuracy_run.run`` at full width, cut in size
    (``ACC_CUTS``), then the committed bundle's decode on fresh clips;
    each gate beside a planted fault that must fail it."""
    from rnn_speech_tpu_torch.tools import beam_quality_run as bq
    from rnn_speech_tpu_torch.tools import flagship_accuracy_run as fr

    modes = ("greedy", f"beam{ACC_BEAM}", f"beam{ACC_BEAM}_lm")
    problems, planted = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        bundle = os.path.join(tmp, "bundle")
        t0 = time.perf_counter()
        result, counts, persistent = _acc_launches(lambda: fr.run(
            tmp, None, layers=L, hidden=H, batch=32, lr=1e-3, beam_width=ACC_BEAM,
            lm_weight=LM_WEIGHT, decode_batch=ACC_CUTS["test_clips"], artifact_dir=bundle,
            device=DEVICE, **ACC_CUTS))
        run_s = time.perf_counter() - t0
        problems += _acc_curve_check(result, ACC_CUTS["max_steps"], ACC_CUTS["steps_per_checkpoint"])
        problems += _acc_scored_check(result["noise_sweep"], ACC_CUTS["test_clips"], modes)
        problems += [f"streaming {mode}: {rec['chunks']}" for mode, rec in result["streaming"].items()
                     if any(c["clips"] != ACC_CUTS["streaming_max_clips"]
                            for c in rec["chunks"].values())]
        if set(result["streaming"]) != {"greedy", f"beam{ACC_BEAM}_lm"}:
            problems.append(f"streaming modes {sorted(result['streaming'])}")
        problems += _acc_launch_check(counts, persistent)
        ckpt_dir = os.path.join(tmp, "ckpt")
        problems += _acc_bundle_check(bundle, ckpt_dir)
        # Planted faults: each must fail its gate.
        curves = {k: v[:-1] for k, v in result["curves"].items()}
        planted["curve_window_dropped"] = _acc_curve_check(
            {"curves": curves}, ACC_CUTS["max_steps"], ACC_CUTS["steps_per_checkpoint"])
        short = json.loads(json.dumps(result["noise_sweep"]))
        short["2400.0"][modes[2]]["clips"] -= 1
        planted["clip_unscored"] = _acc_scored_check(short, ACC_CUTS["test_clips"], modes)
        planted["row10_silent"] = _acc_launch_check({**counts, "row10": 0}, persistent)
        planted["bundle_tensor_moved"] = _acc_bundle_check(
            _acc_planted_bundle(bundle, os.path.join(tmp, "planted")), ckpt_dir)

    # The committed bundle on fresh clips: every mode scores every clip,
    # and the greedy texts at sigma=2400 equal the plain path's.
    t0 = time.perf_counter()
    points = _bundle_points(ACC_BUNDLE_CLIPS, ACC_CUTS["eval_noise_levels"])
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (sweep, paired), bundle_counts, bundle_persistent = _acc_launches(lambda: fr.decode_table(
        bq.load_bundle_config(BUNDLE), _char_map(), points, ACC_BEAM, LM_WEIGHT,
        ACC_DECODE_BATCH, DEVICE))
    decode_s = time.perf_counter() - t0
    problems += _acc_scored_check(sweep, ACC_BUNDLE_CLIPS, modes)
    if not bundle_counts["row1"] or not bundle_persistent["row1"]:
        problems.append(f"the bundle decode did not launch row 1: {bundle_counts}")
    t0 = time.perf_counter()
    items = points[2400.0]
    kernel_texts = _bundle_greedy_texts(items)
    plain_texts = _bundle_greedy_texts(items, use_kernels=False)
    with _early_stop_fault():
        faulty_texts = _bundle_greedy_texts(items)
    texts_s = time.perf_counter() - t0
    differ = [i for i, (a, b) in enumerate(zip(kernel_texts, plain_texts)) if a != b]
    if differ or len(kernel_texts) != ACC_BUNDLE_CLIPS:
        problems.append(f"greedy texts at sigma=2400 differ from the plain path's on clips "
                        f"{differ}: {[(kernel_texts[i], plain_texts[i]) for i in differ[:4]]}")
    planted["stops_after_100_frames"] = [i for i, (a, b) in enumerate(zip(faulty_texts, plain_texts))
                                      if a != b]
    unfailed = [name for name, found in planted.items() if not found]
    if unfailed:
        problems.append(f"planted faults that passed their gates: {unfailed}")
    if problems:
        fail("accuracy: " + "; ".join(problems))
    greedy_wer = {level: table["greedy"]["wer"] for level, table in sweep.items()}
    emit("accuracy", shape={"layers": L, "hidden": H, "batch": 32, "max_frames": 600,
                            "features": "fbank-120"},
         cuts=dict(ACC_CUTS, eval_noise_levels=list(ACC_CUTS["eval_noise_levels"]),
                   streaming_chunk_seconds=list(ACC_CUTS["streaming_chunk_seconds"])),
         run_seconds=run_s, stage_seconds=result["stage_seconds"],
         curves=result["curves"], noise_sweep=result["noise_sweep"],
         streaming=result["streaming"], launches=counts, persistent_launches=persistent,
         bundle={"clips": ACC_BUNDLE_CLIPS, "render_s": render_s, "decode_s": decode_s,
                 "texts_s": texts_s, "noise_sweep": sweep, "paired": paired,
                 "greedy_wer": greedy_wer, "launches": bundle_counts,
                 "persistent_launches": bundle_persistent,
                 "greedy_equal_plain_at_2400": not differ},
         planted={name: len(found) for name, found in planted.items()})


def _vs_jax(sweep, artifact):
    """Each level and mode's WER beside the JAX artifact's WER and 95% CI
    (``benchmarks/<artifact>``), and whether it falls inside that CI."""
    with open(os.path.join(ROOT, "benchmarks", artifact)) as fh:
        ref = json.load(fh)["noise_sweep"]
    out = {}
    for level, table in sweep.items():
        for mode, entry in table.items():
            if level in ref and mode in ref[level]:
                lo, hi = ref[level][mode]["wer_ci95"]
                out[f"{level}/{mode}"] = {"wer": entry["wer"], "jax_wer": ref[level][mode]["wer"],
                                          "jax_ci95": [lo, hi], "inside": lo <= entry["wer"] <= hi}
    return out


def phase_flagship_accuracy():
    """The full flagship protocol (``flagship_accuracy_run``'s defaults:
    1100 + 160 clips, 3x1024, B=32, the JAX artifact's five levels, beam
    16, LM 1x256 for 400 steps, streaming 24 clips; decode batches of
    FULL_DECODE_BATCH), 3000 steps; its
    artifact to chiprun_out/flagship_accuracy.json.  Fails above
    FLAGSHIP_WER_LIMIT greedy WER at sigma=2400."""
    from rnn_speech_tpu_torch.tools import flagship_accuracy_run as fr

    out = os.path.join(OUT_DIR, "flagship_accuracy.json")
    with tempfile.TemporaryDirectory() as tmp:
        result, counts, persistent = _acc_launches(lambda: fr.run(
            tmp, out, clips=1100, test_clips=160, layers=L, hidden=H, batch=32,
            max_steps=FLAGSHIP_STEPS, steps_per_checkpoint=100, lr=1e-3, beam_width=ACC_BEAM,
            lm_weight=LM_WEIGHT, lm_steps=400, eval_noise_levels=FLAGSHIP_LEVELS,
            headline_noise=2400.0, decode_batch=FULL_DECODE_BATCH,
            artifact_dir=os.path.join(tmp, "bundle"),
            device=DEVICE))
    headline = result["noise_sweep"]["2400.0"]["greedy"]["wer"]
    emit("flagship_accuracy", max_steps=FLAGSHIP_STEPS, stage_seconds=result["stage_seconds"],
         eval_error_rate=result["curves"]["eval_error_rate"],
         lr_decays_engaged=result["lr_decays_engaged"],
         wer={level: {m: e["wer"] for m, e in t.items()} for level, t in
              result["noise_sweep"].items()},
         vs_jax=_vs_jax(result["noise_sweep"], "flagship_accuracy.json"),
         streaming=result["streaming"], launches=counts, persistent_launches=persistent,
         artifact=os.path.relpath(out, ROOT))
    if headline > FLAGSHIP_WER_LIMIT:
        fail(f"flagship_accuracy: greedy WER {headline}% at sigma=2400 > {FLAGSHIP_WER_LIMIT}%")


def phase_beam_quality():
    """``beam_quality_run`` with its defaults (the committed bundle, 600
    fresh clips, five levels, beam 16, LM 0.4; decode batches of
    FULL_DECODE_BATCH) into
    chiprun_out/beam_quality.json, each WER beside the JAX artifact's CI;
    then every level's greedy texts on the kernels against the plain
    path's (clips that differ are listed)."""
    from rnn_speech_tpu_torch.tools import beam_quality_run as bq

    out = os.path.join(OUT_DIR, "beam_quality.json")
    t0 = time.perf_counter()
    rc, counts, persistent = _acc_launches(lambda: bq.main(
        ["--bundle", BUNDLE, "--out", out, "--device", DEVICE,
         "--decode_batch", str(FULL_DECODE_BATCH)]))
    tool_s = time.perf_counter() - t0
    with open(out) as fh:
        result = json.load(fh)
    t0 = time.perf_counter()
    points = _bundle_points(result["clips"], result["levels"])
    differ = {}
    for level, items in points.items():
        kernel, plain = _bundle_greedy_texts(items), _bundle_greedy_texts(items, False)
        differ[str(level)] = [{"clip": i, "truth": items[i][1].lower(), "kernel": a, "plain": b}
                              for i, (a, b) in enumerate(zip(kernel, plain)) if a != b]
    plain_s = time.perf_counter() - t0
    emit("beam_quality", rc=rc, tool_s=tool_s, stage_seconds=result["stage_seconds"],
         clips=result["clips"], n_words=result["n_words"],
         vs_jax=_vs_jax(result["noise_sweep"], "beam_quality.json"),
         significant_levels=result["significant_levels"],
         significant_levels_lm=result["significant_levels_lm"],
         greedy_plain_differ=differ, plain_compare_s=plain_s, launches=counts,
         persistent_launches=persistent, artifact=os.path.relpath(out, ROOT))


def phase_accuracy_benchmark():
    """``accuracy_benchmark`` with the committed artifact's arguments
    (300 clips, 2x256, B=16, 12 rounds of 200 steps, the 15% target) into
    chiprun_out/accuracy_curve.json; the plans' kernels at its shapes and
    its launches.  Fails unless it reaches its target."""
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf
    from rnn_speech_tpu_torch.tools import accuracy_benchmark as ab

    out = os.path.join(OUT_DIR, "accuracy_curve.json")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        result, counts, persistent = _acc_launches(lambda: ab.run(
            tmp, out, clips=300, layers=2, hidden=256, batch=16, rounds=12, steps=200,
            wer_target=15.0, device=DEVICE))
        seconds = time.perf_counter() - t0
    emit("accuracy_benchmark", seconds=seconds, stage_seconds=result["stage_seconds"],
         kernel_plans=result["kernel_plans"], curve=result["curve"], best=result["best"],
         reached_target=result["reached_target"], launches=counts,
         persistent_launches=persistent, eval_plan_b1=wf.wavefront_eval_plan(1, 256, 2),
         artifact=os.path.relpath(out, ROOT))
    if not result["reached_target"]:
        fail(f"accuracy_benchmark: held-out WER never reached 15%: {result['curve']}")


# ----------------------------------------------- the CLI's training modes

LOOP_SR = 16000           # LibriSpeech's rate: the pipeline resamples to 22050
LOOP_CLIPS = (90, 30)     # train and test clips of the train_loop corpus
LOOP_SECONDS = (2.0, 15.0)
LOOP_STEPS, LOOP_EVERY = 6, 3   # the first run's steps; checkpoint and eval cadence
LOOP_DECODE_CLIPS = 8     # train clips decoded natively and by flac_py, one thread
# The counters of the default train step (rows 3, 4, 9, 12, 14, 15, 16 of
# PERF.md's table) and of the evaluation pass (row 10).
LOOP_TRAIN_KERNELS = ("wavefront_train", "wavefront_bwd", "ctc_alpha_ckpt",
                      "ctc_beta_post", "dgates_weight_grads", "weight_grad", "dropout")
LOOP_EVAL_KERNELS = ("ctc_alpha_lossonly",)


def _render_clip(args):
    """Worker: render sentences back to back at LOOP_SR with sigma=900
    noise as int16, write them as FLAC; returns (path, samples)."""
    import numpy as np

    from rnn_speech_tpu_torch import synth
    from rnn_speech_tpu_torch.runtime import flac_enc

    path, sentences, seed, sr = args
    rng = np.random.default_rng(seed)
    clean = np.concatenate([synth.render_syllables_clean(s, sr, rng) for s in sentences])
    pcm = np.clip(np.round(clean + rng.normal(0, 900.0, len(clean))), -32000, 32000)
    flac_enc.encode_flac(path, pcm.astype(np.int16), sr)
    return path, len(pcm)


def _flac_corpora(out_dir, corpora, sr, workers=8):
    """Write each of ``corpora`` {name: [(transcript, sentences, seed), ...]}
    as a FLAC corpus in LibriSpeech's layout, all over one process pool;
    returns {name: (corpus root, seconds of audio)}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    tasks, out = [], {}
    for name, clips in corpora.items():
        chapter = os.path.join(out_dir, name, "spk", "chap")
        os.makedirs(chapter, exist_ok=True)
        with open(os.path.join(chapter, "1-2.trans.txt"), "w") as fh:
            fh.writelines(f"1-2-{i:04d} {text}\n" for i, (text, _, _) in enumerate(clips))
        tasks += [(os.path.join(chapter, f"1-2-{i:04d}.flac"), sentences, seed, sr)
                  for i, (_, sentences, seed) in enumerate(clips)]
        out[name] = os.path.join(out_dir, name)
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        samples = dict(pool.map(_render_clip, tasks))
    return {name: (root, sum(n for path, n in samples.items()
                             if path.startswith(root + os.sep)) / sr)
            for name, root in out.items()}


def _loop_clips(n, seed):
    """n clips of back-to-back sentences, each about a duration drawn from
    LOOP_SECONDS (the renderer gives ~0.56 s a word, half a word's time
    between sentences)."""
    import numpy as np

    from rnn_speech_tpu_torch import synth

    rng = np.random.default_rng(seed)
    sentences = iter(synth.sample_sentences(40 * n, rng))
    clips = []
    for i in range(n):
        target, parts, words = rng.uniform(*LOOP_SECONDS), [], 0.0
        while words * 0.56 < target:
            parts.append(next(sentences))
            words += len(parts[-1].split()) + 0.5
        clips.append((" ".join(parts), parts, seed * 1000 + i))
    return clips


def _host_runtime_study(train_root):
    """Build the host runtime (g++), hold the native FLAC decoder against
    ``flac_py`` on the first LOOP_DECODE_CLIPS train clips (bit for bit),
    time both on one thread, and time the native loader over every train
    clip with the loop's threads, truncation and capacity (resampled to
    22.05 kHz)."""
    import glob

    from rnn_speech_tpu_torch.runtime import audiodec, flac_py, loader, native_build
    from rnn_speech_tpu_torch.train import pipeline

    t0 = time.perf_counter()
    native_build.load()
    build_s = time.perf_counter() - t0
    files = sorted(glob.glob(os.path.join(train_root, "*", "*", "*.flac")))
    head = files[:LOOP_DECODE_CLIPS]
    t0 = time.perf_counter()
    native = [audiodec.decode_flac(f)[0] for f in head]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = [flac_py.decode_flac(f)[0] for f in head]
    python_s = time.perf_counter() - t0
    unequal = [os.path.basename(f) for f, a, b in zip(head, native, python)
               if a.shape != b.shape or a.tobytes() != b.tobytes()]
    if unequal:
        fail(f"train_loop: native FLAC decode differs from flac_py on {unequal}")
    audio_s = sum(len(a) for a in native) / LOOP_SR
    threads = pipeline.default_decode_threads()
    pcfg = pipeline.PipelineConfig(batch_size=30, max_input_seq_length=3510, prefetch_batches=2)
    delivered, bad = 0, 0
    t0 = time.perf_counter()
    with loader.NativeAudioLoader(files, max_samples=pcfg.max_samples,
                                  target_rate=pcfg.sample_rate, n_threads=threads,
                                  capacity=max(30 * (pcfg.prefetch_batches + 1),
                                               threads * 2)) as ld:
        for _, audio, rc in ld:
            bad += rc != 0
            delivered += 0 if audio is None else len(audio)
    loader_s = time.perf_counter() - t0
    if bad:
        fail(f"train_loop: the native loader could not decode {bad} train clips")
    return {"build_s": build_s, "clips": len(head), "audio_s": audio_s, "bit_equal": True,
            "native_s": native_s, "python_s": python_s,
            "native_s_per_audio_s": native_s / audio_s,
            "python_s_per_audio_s": python_s / audio_s,
            "loader": {"clips": len(files), "threads": threads, "seconds": loader_s,
                       "audio_s_delivered": delivered / pcfg.sample_rate,
                       "audio_s_per_s": delivered / pcfg.sample_rate / loader_s},
            "cpu_count": os.cpu_count()}


_CLI_CHILD = r"""
import sys
sys.path.insert(0, {root!r})
import chip_smoke
sys.exit(chip_smoke._cli_child({out!r}, {runs!r}))
"""


def _cli_child(out_path, runs):
    """Run ``python -m rnn_speech_tpu_torch.cli <argv>`` for each argv of
    ``runs`` in turn in this process and write a record of each to
    ``out_path``: its exit code and standard output, each kernel's
    launches (counters zeroed before the run), every train step's host
    entry time and CUDA events around it, its loss, every eval batch's
    events, the time the loop waited on the input pipeline, the batches
    the pipeline yielded and those the native loader fed, the clips the
    loader delivered, the checkpoint it restored, whether ``checkpoint.restore`` of the last bundle
    equals the parameters the run ended with, bit for bit, and each LM
    training step's loss and host time (``--train_language``)."""
    import io
    import runpy
    import statistics

    import torch

    from rnn_speech_tpu_torch import params as params_mod
    from rnn_speech_tpu_torch.config import load_config
    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf
    from rnn_speech_tpu_torch.runtime import loader
    from rnn_speech_tpu_torch.train import checkpoint, lm_loop, loop, pipeline, step

    counters = {**_all_counters(), "lstm_wavefront": wf.lstm_stack_wavefront,
                "lstm_recurrence": rec.lstm_recurrence}
    steps, evals, waits, restored, ended, lm_steps = [], [], [], [], [], []
    in_eval = [False]

    def around(fn, into):
        def timed(*args, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            # Keep the metrics only: a train step's state would pin every
            # step's parameters and Adam moments on the card.
            into.append((t0, e0, e1, out[1] if isinstance(out, tuple) else out))
            return out
        return timed

    step.train_step = around(step.train_step, steps)
    step.eval_step = around(step.eval_step, evals)
    base_pipeline, base_eval, base_train = (pipeline.InputPipeline, loop.evaluate_dataset,
                                            loop.train_acoustic)
    base_restore = checkpoint.restore
    base_lm_train = lm_loop.train_language

    class TimedPipeline(base_pipeline):
        def __iter__(self):
            batches = super().__iter__()
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    return
                waits.append((in_eval[0], time.perf_counter() - t0))
                yield batch

    def evaluate_dataset(*args, **kw):
        in_eval[0] = True
        try:
            return base_eval(*args, **kw)
        finally:
            in_eval[0] = False

    def restore(*args, **kw):
        got = base_restore(*args, **kw)
        restored.append(None if got is None else list(got[1:]))
        return got

    def train_acoustic(*args, **kw):
        state = base_train(*args, **kw)
        ended.append(state)
        return state

    def train_language(*args, **kw):
        def hook(step, metrics):          # its loss is read on the host: a sync
            lm_steps.append((time.perf_counter(), metrics["mean_loss"]))
        return base_lm_train(*args, step_hook=hook, **kw)

    pipeline.InputPipeline, loop.evaluate_dataset = TimedPipeline, evaluate_dataset
    loop.train_acoustic, checkpoint.restore = train_acoustic, restore
    lm_loop.train_language = train_language
    records = []
    for argv in runs:
        for fn in counters.values():
            fn.launches = 0
        wf.lstm_stack_wavefront.persistent_launches = 0
        _zero_path_counters()
        pipeline.native_batches = loader.delivered = 0
        for seen in (steps, evals, waits, restored, ended, lm_steps):
            seen.clear()
        sys.argv = ["rnn_speech_tpu_torch.cli", *argv]
        printed = io.StringIO()
        t_start = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            try:
                runpy.run_module("rnn_speech_tpu_torch.cli", run_name="__main__",
                                 alter_sys=True)
                rc = 0
            except SystemExit as exc:
                rc = exc.code if isinstance(exc.code, int) else int(exc.code is not None)
        torch.cuda.synchronize()
        out = {"argv": argv, "rc": rc, "stdout": printed.getvalue(),
               "wall_s": time.perf_counter() - t_start,
               "launches": {k: fn.launches for k, fn in counters.items()},
               "wavefront_eval_persistent": wf.lstm_stack_wavefront.persistent_launches,
               "path_launches": _path_counters(), "restored": restored[:1],
               "pipeline_batches": len(waits), "native_batches": pipeline.native_batches,
               "loader_clips": loader.delivered}
        if steps:
            entries = [t for t, _, _, _ in steps]
            device_ms = [e0.elapsed_time(e1) for _, e0, e1, _ in steps]
            eval_ms = [e0.elapsed_time(e1) for _, e0, e1, _ in evals]
            last = evals[-1] if evals and evals[-1][0] > steps[-1][0] else steps[-1]
            span_ms = steps[0][1].elapsed_time(last[2])
            busy_ms = sum(device_ms) + sum(ms for (t, _, _, _), ms in zip(evals, eval_ms)
                                           if t > steps[0][0])
            host_ms = [1e3 * (b - a) for a, b in zip(entries, entries[1:])]
            out.update(
                steps=len(steps), losses=[float(m["mean_loss"]) for *_, m in steps],
                step_device_ms=device_ms, step_host_ms=host_ms,
                loop_ms_per_step_median=statistics.median(host_ms) if host_ms else None,
                device_ms_per_step_median=statistics.median(device_ms),
                eval_batches=len(evals), eval_device_ms=eval_ms,
                device_span_ms=span_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / span_ms if span_ms > 0 else None,
                pipeline_wait_s={"train": sum(w for e, w in waits if not e),
                                 "eval": sum(w for e, w in waits if e),
                                 "train_batches": sum(1 for e, _ in waits if not e)})
        if lm_steps:
            lm_ms = [1e3 * (b[0] - a[0]) for a, b in zip(lm_steps, lm_steps[1:])]
            out.update(lm_losses=[loss for _, loss in lm_steps],
                       lm_ms_per_step_median=statistics.median(lm_ms) if lm_ms else None)
        if ended:
            state = ended[0]
            config = load_config(argv[argv.index("--config") + 1])
            got = base_restore(config.checkpoint_dir + "/acoustic/", state["params"])
            final, back = params_mod.flatten(state["params"]), params_mod.flatten(got[0])
            out.update(final_step=int(state["step"]), final_lr=float(state["lr"]),
                       restore_step=got[1], restore_lr=got[2],
                       restore_equal=all(torch.equal(final[k], back[k]) for k in final))
        records.append(out)
    with open(out_path, "w") as fh:
        json.dump(records, fh)
    return max(r["rc"] for r in records)


def _run_cli_child(runs, tmp, tag, timeout=600):
    """The CLI runs ``runs`` (argv lists) in turn in one child process
    (``_cli_child``); returns their records."""
    out = os.path.join(tmp, f"{tag}.json")
    code = _CLI_CHILD.format(root=ROOT, out=out, runs=[list(r) for r in runs])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out):
        fail(f"{tag}: rc={proc.returncode} stdout={proc.stdout[-1500:]} "
             f"stderr={proc.stderr[-3000:]}")
    with open(out) as fh:
        records = json.load(fh)
    for record in records:
        record["process_s"] = seconds
    return records


LOOP_INI = """[acoustic_network_params]
num_layers : {L}
hidden_size : {H}
dropout_input_keep_prob : {ki}
dropout_output_keep_prob : {ko}
batch_size : 10
mini_batch_size : 3
learning_rate : 0.0003
lr_decay_factor : 0.33
grad_clip : 1
rnn_state_reset_ratio : 0.25
signal_processing : fbank
language : english

[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : {every}
steps_per_evaluation : {every}
checkpoint_dir : {ckpt}

[training]
training_dataset_dirs : {train}
test_dataset_dirs : {test}
max_input_seq_length : 3510
max_target_seq_length : 600
tensorboard_dir : {tb}
dataset_size_ordering : False

[logging]
log_level : WARNING

[tpu]
compute_dtype : bfloat16
use_pallas_lstm : True
use_pallas_ctc : True
wavefront : True
bucket_count : 8
prefetch_depth : 2
fuse_microbatches : True
"""


def phase_train_loop():
    """``--train_acoustic`` through the CLI at the flagship width on a
    rendered FLAC corpus: 6 steps from nothing, then a resume to step 9."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        made = _flac_corpora(tmp, {"train": _loop_clips(LOOP_CLIPS[0], 14),
                                   "test": _loop_clips(LOOP_CLIPS[1], 15)}, LOOP_SR)
        (train_root, train_s), (test_root, test_s) = made["train"], made["test"]
        corpus_s = time.perf_counter() - t0
        decode = _host_runtime_study(train_root)
        os.makedirs(os.path.join(tmp, "tb"))
        ini = os.path.join(tmp, "loop.ini")
        with open(ini, "w") as fh:
            fh.write(LOOP_INI.format(L=L, H=H, ki=INPUT_KEEP, ko=OUTPUT_KEEP, every=LOOP_EVERY,
                                     ckpt=os.path.join(tmp, "ckpt"), train=train_root,
                                     test=test_root, tb=os.path.join(tmp, "tb")))
        base = ["--train_acoustic", "--config", ini]
        first, = _run_cli_child([base + ["--max_steps", str(LOOP_STEPS), "--tb_name", "a"]],
                                tmp, "train_loop_first")
        ckpt_dir = os.path.join(tmp, "ckpt", "acoustic")
        after_first = sorted(os.listdir(ckpt_dir))
        # --max_steps counts this session's steps, as in the JAX CLI.
        resume, = _run_cli_child([base + ["--max_steps", str(LOOP_EVERY), "--tb_name", "b"]],
                                 tmp, "train_loop_resume")
        files_after = sorted(os.listdir(ckpt_dir))
        tb = {run: sorted(os.listdir(os.path.join(tmp, "tb", run))) for run in ("a", "b")}
        lines = {run: sum(1 for _ in open(os.path.join(tmp, "tb", run, "events.jsonl")))
                 for run in ("a", "b")}
    want = [f"acousticmodel-{s}.npz" for s in (3, 6, 9)] + ["checkpoint"]
    problems = []
    if files_after != want or after_first != want[:2] + ["checkpoint"]:
        problems.append(f"checkpoints {after_first} then {files_after}")
    if first["restored"] != [None] or resume["restored"] != [[6, first["final_lr"]]]:
        problems.append(f"restore {first['restored']} then {resume['restored']}")
    if (first.get("final_step"), resume.get("final_step")) != (6, 9):
        problems.append(f"final steps {first.get('final_step')}, {resume.get('final_step')}")
    for run in (first, resume):
        if not all(math.isfinite(v) for v in run.get("losses", [float("nan")])):
            problems.append(f"losses {run.get('losses')}")
        if not run.get("restore_equal"):
            problems.append("restore of the last bundle differs from the final params")
        for name in LOOP_TRAIN_KERNELS + LOOP_EVAL_KERNELS:
            if not run["launches"].get(name):
                problems.append(f"{name} did not launch: {run['launches']}")
        if run["path_launches"].get("weight_grad_skinny") != run["launches"]["weight_grad"]:
            problems.append(f"the projections' weight gradients left the skinny tile: "
                            f"{run['path_launches']}")
        if run["eval_batches"] < 1:
            problems.append("no evaluation pass ran")
        if not run["native_batches"] or run["native_batches"] != run["pipeline_batches"]:
            problems.append(f"{run['native_batches']} of {run['pipeline_batches']} batches "
                            "came through the native loader")
    for run in ("a", "b"):
        if lines[run] < 2 or not any(f.startswith("events.out.tfevents") for f in tb[run]):
            problems.append(f"metrics of run {run}: {tb[run]}, {lines[run]} lines")
    if problems:
        fail("train_loop: " + "; ".join(problems))
    train = RECORD.get("train", {})
    keep = ("rc", "wall_s", "process_s", "stdout", "steps", "losses", "step_host_ms", "step_device_ms",
            "loop_ms_per_step_median", "device_ms_per_step_median", "eval_batches",
            "eval_device_ms", "device_span_ms", "device_busy_ms", "device_idle_share",
            "pipeline_wait_s", "pipeline_batches", "native_batches", "loader_clips", "launches",
            "path_launches", "restored", "final_step", "final_lr", "restore_equal")
    emit("train_loop",
         corpus={"train_clips": LOOP_CLIPS[0], "test_clips": LOOP_CLIPS[1],
                 "train_audio_s": train_s, "test_audio_s": test_s, "sample_rate": LOOP_SR,
                 "render_and_encode_s": corpus_s},
         decode=decode,
         batch=30, checkpoints=files_after,
         first={k: first.get(k) for k in keep}, resume={k: resume.get(k) for k in keep},
         loop_ms_per_step=first["loop_ms_per_step_median"],
         loop_device_idle_share=first["device_idle_share"],
         train_phase_ms_per_step=train.get("train_ms_per_step"),
         train_phase_shape={"batch": TRAIN_B, "frames": TRAIN_T})


EVAL_INI = """[acoustic_network_params]
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
checkpoint_dir : {bundle}

[training]
test_dataset_dirs : {test}
max_input_seq_length : 600
max_target_seq_length : 80

[logging]
log_level : WARNING

[tpu]
compute_dtype : bfloat16
use_pallas_lstm : True
wavefront : True
bucket_count : 8
prefetch_depth : 2
"""


def _printed_rates(stdout):
    """(WER, CER) from the CLI's two result lines."""
    got = {}
    for line in stdout.splitlines():
        for key in ("WER", "CER"):
            if line.startswith(f"Resulting {key} : "):
                got[key] = line.split(" : ")[1].rstrip(" %")
    return got.get("WER"), got.get("CER")


def phase_evaluate():
    """``--evaluate`` through the CLI on the committed bundle over the 32
    held-out clips written as FLAC, greedy and at beam width 16."""
    import numpy as np
    import torch

    from rnn_speech_tpu_torch import cli, corpus
    from rnn_speech_tpu_torch.charmap import get_char_map
    from rnn_speech_tpu_torch.config import HyperParamStore, load_config
    from rnn_speech_tpu_torch.runtime import loader
    from rnn_speech_tpu_torch.train import metrics, pipeline

    texts, sigs = _held_out()
    with tempfile.TemporaryDirectory() as tmp:
        test_root = _write_held_out_flac(tmp, texts, sigs)
        ini = os.path.join(tmp, "eval.ini")
        with open(ini, "w") as fh:
            fh.write(EVAL_INI.format(bundle=BUNDLE, test=test_root))
        widths = (1, cli.DEFAULT_BEAM_WIDTH)
        records = _run_cli_child([["--evaluate", "--config", ini, "--beam_width", str(w)]
                                  for w in widths], tmp, "evaluate")
        runs = dict(zip(widths, records))
        for record in runs.values():
            record["wer"], record["cer"] = _printed_rates(record["stdout"])
        # The yardstick: cli.transcribe on the same decoded FLAC audio, one
        # batch in the evaluate mode's order and width, scored the same way.
        config = HyperParamStore(load_config(ini)).config
        char_map = get_char_map("english")
        test_set = sorted(corpus.DataProcessor(config.test_dataset_dirs).get_dataset(),
                          key=lambda item: item[2])
        max_samples = cli.max_samples_for(config)
        with loader.NativeAudioLoader([path for path, _, _ in test_set],
                                      max_samples=max_samples + 1, target_rate=cli.SAMPLE_RATE,
                                      n_threads=pipeline.default_decode_threads()) as ld:
            clips = [sig for _, sig, _ in ld]
        model_cfg, fe, params = cli.build_forward(config, char_map, "cuda")
        unit = -(-max_samples // max(config.tpu.bucket_count, 1))
        width = min(max(1, -(-max(len(c) for c in clips) // unit)) * unit, max_samples)
        audio = np.zeros((config.batch_size, width), np.float32)
        lengths = np.zeros((config.batch_size,), np.int32)
        for i, clip in enumerate(clips):
            audio[i, : len(clip)] = clip
            lengths[i] = len(clip)
        with torch.no_grad():
            hyps = cli.transcribe(params, model_cfg, audio, lengths, frontend=fe,
                                  char_map=char_map, device="cuda", beam_width=1)
    truths = [label for _, label, _ in test_set]
    wer_list = [metrics.calculate_wer(h, t) / float(len(t.split()))
                for h, t in zip(hyps, truths)]
    cer_list = [metrics.calculate_cer(h, t) / float(len(t.replace(" ", "")))
                for h, t in zip(hyps, truths)]
    wer = float(sum(wer_list)) * 100 / len(wer_list)       # as the CLI averages
    cer = float(sum(cer_list)) * 100 / len(cer_list)
    want = ("{0:.3g}".format(wer), "{0:.3g}".format(cer))
    problems = []
    for width, run in runs.items():
        if run["cer"] is None or float(run["cer"]) > CER_LIMIT:
            problems.append(f"beam {width}: CER {run['cer']} (limit {CER_LIMIT}%)")
        if not run["launches"].get("lstm_wavefront"):
            problems.append(f"beam {width}: row 1 did not launch: {run['launches']}")
        if run["loader_clips"] != len(test_set):
            problems.append(f"beam {width}: {run['loader_clips']} of {len(test_set)} clips "
                            "came through the native loader")
    if (runs[1]["wer"], runs[1]["cer"]) != want:
        problems.append(f"greedy printed {runs[1]['wer']}/{runs[1]['cer']}, "
                        f"transcribe gives {want}")
    if problems:
        fail("evaluate: " + "; ".join(problems))
    emit("evaluate", clips=len(test_set), batch=32, transcribe_wer_cer=want,
         process_s=runs[1]["process_s"],
         **{f"beam{w}": {"wer_pct": r["wer"], "cer_pct": r["cer"], "wall_s": r["wall_s"],
                         "loader_clips": r["loader_clips"],
                         "launches": {k: v for k, v in r["launches"].items() if v},
                         "wavefront_eval_persistent": r["wavefront_eval_persistent"]}
            for w, r in runs.items()})


# ----------------------------------------------------------- the multi phase

MULTI_KEEP_STEPS = 3      # default-keep steps through the one-rank sharded step
MULTI_CLIPS = (24, 8)     # train and test clips of the multi phase's CLI corpus
MULTI_STEPS = 5           # --train_acoustic steps under torch.distributed.run
MULTI_SPANS = ("train", "host/put_batch", "host/metrics_drain", "host/next_batch",
               "host/checkpoint", "evaluate")
# Rows 3 and 4's kernels, as their CUDA symbols name them in a trace.
MULTI_TRACE_KERNELS = {"row3": "wavefront_persistent", "row4": "wavefront_bwd_persistent"}


def _event_pair():
    import torch

    return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))


def _grad_all_reduce_ms(grads, group, reps=3):
    """ms of the data axis's gradient all-reduce of ``grads`` (one buffer
    a dtype, ``sharding.all_reduce_flat``), CUDA events around each of
    ``reps`` runs after one warm-up; the bytes it reduces."""
    import torch

    from rnn_speech_tpu_torch.parallel import sharding
    from rnn_speech_tpu_torch.train import optim

    leaves = optim.tree_leaves(grads)
    sharding.all_reduce_flat(leaves, group)
    out = []
    for _ in range(reps):
        e0, e1 = _event_pair()
        torch.cuda.synchronize()
        e0.record()
        sharding.all_reduce_flat(leaves, group)
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out, sum(g.numel() * g.element_size() for g in leaves)


def _timed_step(fn):
    """(result, device ms) of ``fn()`` between two CUDA events."""
    import torch

    e0, e1 = _event_pair()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def _launch_counts(counters):
    return {k: fn.launches for k, fn in counters.items()}


def _reset_launches(counters):
    for fn in counters.values():
        fn.launches = 0


def _multi_one_rank(rank, world, device):
    """One NCCL rank (world 1) on a 1x1 mesh at the default step's width:
    the sharded step against the unsharded ``train_step`` at keep 1 (bit
    for bit), then MULTI_KEEP_STEPS steps at the default keeps.  The launch
    counts are the sharded steps' alone (set to 0 after the reference
    step); the all-reduce is timed on the parameter tree, whose leaves and
    dtypes are the gradients'."""
    import dataclasses

    import torch

    from rnn_speech_tpu_torch.parallel import mesh as mesh_mod
    from rnn_speech_tpu_torch.parallel import sharding
    from rnn_speech_tpu_torch.train import optim, step

    torch.cuda.reset_peak_memory_stats()
    mesh = mesh_mod.make_mesh(1, 1)
    scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=3,
                                      keeps=(1.0, 1.0))
    counters = _train_counters()
    ref, ref_m = step.train_step(scfg, state, batch, torch.Generator().manual_seed(5), False)
    sstate, _, train_fn, _ = sharding.make_sharded_step(mesh, scfg, state)
    _reset_launches(counters)
    got, got_m = train_fn(scfg, sstate, batch, torch.Generator().manual_seed(5), False)
    torch.cuda.synchronize()
    unequal = [i for i, (a, b) in enumerate(zip(optim.tree_leaves(ref["params"]),
                                                optim.tree_leaves(got["params"])))
               if not torch.equal(a, b)]
    metrics_equal = all(torch.equal(ref_m[k], got_m[k]) for k in ref_m)
    del ref, got
    dcfg = dataclasses.replace(scfg, input_keep_prob=INPUT_KEEP, output_keep_prob=OUTPUT_KEEP)
    rng = torch.Generator().manual_seed(1234)
    losses, step_ms = [], []
    st = sstate
    for _ in range(MULTI_KEEP_STEPS):
        (st, m), ms = _timed_step(lambda: train_fn(dcfg, st, batch, rng, False))
        losses.append(float(m["mean_loss"]))
        step_ms.append(ms)
    launches = _launch_counts(counters)
    reduce_ms, nbytes = _grad_all_reduce_ms(st["params"], mesh.data_group)
    return {"bit_equal_params": not unequal, "unequal_leaves": unequal,
            "metrics_equal": metrics_equal, "losses": losses, "step_ms": step_ms,
            "all_reduce_ms": reduce_ms, "all_reduce_bytes": nbytes,
            "backend": torch.distributed.get_backend(), "launches": launches,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _multi_two_ranks(rank, world, device):
    """Two gloo ranks sharing the card: each takes its 32 rows of the same
    64-row batch at keep 1; the all-reduced gradients and the loss against
    the one-rank B=64 step's (rank 0 computes it), the gradient
    all-reduce's ms on those gradients, then one step's ms with its own
    launch counts, and the rank's peak memory."""
    import torch

    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.params import flatten
    from rnn_speech_tpu_torch.parallel import mesh as mesh_mod
    from rnn_speech_tpu_torch.parallel import sharding
    from rnn_speech_tpu_torch.train import step

    torch.cuda.reset_peak_memory_stats()
    mesh = mesh_mod.make_mesh(2, 1)
    scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=3,
                                      keeps=(1.0, 1.0))
    rows, s = sharding.shard_width(TRAIN_B, mesh), mesh.shard_index
    full_states = state["states"]
    state["states"] = acoustic.zero_state(scfg.model, rows, device=device)
    specs = sharding.param_specs(state["params"], 1)
    sstate, _, train_fn, _ = sharding.make_sharded_step(mesh, scfg, state)
    mine = {k: v[:, s * rows:(s + 1) * rows] for k, v in batch.items()}
    rng = torch.Generator().manual_seed(5)
    _, grads, loss, _, _ = sharding.sharded_grads(scfg, sstate["params"], specs, mesh,
                                                  sstate["states"], mine, rng)
    reduce_ms, nbytes = _grad_all_reduce_ms(grads, mesh.data_group)
    out = {"rows": int(mine["labels"].shape[1]), "loss": float(loss)}
    if rank == 0:
        # The one-rank B=64 step's gradients; per tensor, relative Frobenius.
        _, ref, ref_loss, _, cnt = step.accumulate_grads(scfg, state["params"], full_states,
                                                         batch, rng)
        errs = {k: float((g - r).float().norm() / r.float().norm().clamp(min=1e-30))
                for (k, g), r in zip(flatten(grads).items(), flatten(ref).values())}
        out.update(ref_loss=float(ref_loss / torch.clamp(cnt, min=1.0)),
                   grad_rel_err_max=max(errs.values()), grad_rel_errs=errs)
        del ref
    del grads
    torch.cuda.empty_cache()
    counters = _train_counters()
    _reset_launches(counters)
    torch.distributed.barrier()         # rank 1 would time its wait for the reference
    _, ms = _timed_step(lambda: train_fn(scfg, sstate, mine, rng, False))
    out.update(step_ms=ms, launches=_launch_counts(counters), all_reduce_ms=reduce_ms,
               all_reduce_bytes=nbytes, backend=torch.distributed.get_backend(),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def _run_group(cmd, timeout, env=None):
    """Run ``cmd`` in a session of its own from the repo root; on timeout
    kill the whole session (torchrun and its workers).  Returns
    (returncode, stdout, stderr, seconds)."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True, env=env)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail(f"multi: {' '.join(cmd[3:8])} did not end within {timeout} s: "
             f"{err[-2000:]}")
    return proc.returncode, out, err, time.perf_counter() - t0


def _trace_split(path, top=10, gaps=8):
    """The trace window of ``path`` (a torch.profiler Chrome trace): the
    ``top`` device ops by total time, the device's busy and idle time over
    the window, the ``gaps`` longest idle gaps with the innermost host span
    (annotation and operator) covering each, and the idle time split by the
    annotation that covers it."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    device = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                    key=lambda x: x[0])
    marks = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation"]
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") == "cpu_op"]
    totals = {}
    for a, b, name in device:
        t = totals.setdefault(name, [0.0, 0])
        t[0] += (b - a) / 1e3
        t[1] += 1
    busy, merged = 0.0, []
    for a, b, _ in device:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    holes = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]

    def inner(spans, t):
        covering = [s for s in spans if s[0] <= t <= s[1]]
        return min(covering, key=lambda s: s[1] - s[0])[2] if covering else None

    by_mark = {}
    for a, b in holes:
        key = inner(marks, (a + b) / 2) or "(no span)"
        by_mark[key] = by_mark.get(key, 0.0) + (b - a) / 1e3
    span = (merged[-1][1] - merged[0][0]) if merged else 0.0
    return {
        "device_events": len(device), "window_ms": span / 1e3, "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / span if span else None,
        "top_ops": [{"name": name[:120], "ms": ms, "count": n} for name, (ms, n) in
                    sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]],
        "longest_gaps": [{"ms": (b - a) / 1e3, "span": inner(marks, (a + b) / 2),
                          "op": inner(ops, (a + b) / 2)}
                         for a, b in sorted(holes, key=lambda h: h[0] - h[1])[:gaps]],
        "idle_ms_by_span": by_mark,
        "spans": {name: sum(1 for m in marks if m[2] == name) for name in MULTI_SPANS},
        "span_ms": {name: [(b - a) / 1e3 for a, b, n in marks if n == name]
                    for name in ("train", "host/next_batch", "host/checkpoint", "evaluate")},
        "profiler_step_ms": [(b - a) / 1e3 for a, b, n in sorted(marks)
                             if n.startswith("ProfilerStep#")],
        "kernels": {row: sum(1 for _, _, n in device if sym in n and
                             (row != "row3" or "bwd" not in n))
                    for row, sym in MULTI_TRACE_KERNELS.items()},
    }


def _torchrun_cli(argv, timeout=300):
    """``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    rnn_speech_tpu_torch.cli <argv>``: (rc, stdout, stderr, seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "rnn_speech_tpu_torch.cli", *argv]
    return _run_group(cmd, timeout)


def phase_multi():
    """The multi-GPU path on the one card: the sharded step at one NCCL
    rank, two gloo ranks sharing the card against one rank, and the CLI
    under ``torch.distributed.run`` (training with ``--timeline``, then
    ``--evaluate``)."""
    from rnn_speech_tpu_torch.parallel import launch

    problems = []
    t0 = time.perf_counter()
    one, = launch.spawn_ranks(_multi_one_rank, 1, "nccl", "cuda", timeout=300)
    one["process_s"] = time.perf_counter() - t0
    if not one["bit_equal_params"] or not one["metrics_equal"]:
        problems.append(f"one rank: the 1x1 sharded step differs from train_step "
                        f"(leaves {one['unequal_leaves']}, metrics equal "
                        f"{one['metrics_equal']})")
    if not all(math.isfinite(v) for v in one["losses"]) or \
            not one["losses"][-1] < one["losses"][0]:
        problems.append(f"one rank: losses {one['losses']} not finite and falling")
    for name in ("wavefront_train", "wavefront_bwd", "ctc_alpha_ckpt", "ctc_beta_post",
                 "dgates_weight_grads", "weight_grad", "dropout"):
        if not one["launches"].get(name):
            problems.append(f"one rank: {name} did not launch in the sharded steps: "
                            f"{one['launches']}")
    t0 = time.perf_counter()
    two = launch.spawn_ranks(_multi_two_ranks, 2, "gloo", "cuda", timeout=300)
    two_s = time.perf_counter() - t0
    for r, rec in enumerate(two):
        for name in ("wavefront_train", "wavefront_bwd"):      # rows 3 and 4
            if not rec["launches"].get(name):
                problems.append(f"two ranks: {name} did not launch in rank {r}'s step: "
                                f"{rec['launches']}")
    head = two[0]
    if not head["grad_rel_err_max"] <= GRAD_REL_TOL:
        problems.append(f"two ranks: all-reduced gradients {head['grad_rel_err_max']:.3e} "
                        f"from the one-rank B=64 step's (limit {GRAD_REL_TOL})")
    if [r["rows"] for r in two] != [TRAIN_B // 2] * 2 or two[0]["loss"] != two[1]["loss"] \
            or abs(head["loss"] - head["ref_loss"]) > 1e-5 * abs(head["ref_loss"]):
        problems.append(f"two ranks: rows {[r['rows'] for r in two]}, losses "
                        f"{[r['loss'] for r in two]} against {head['ref_loss']}")
    cli = _multi_cli(problems)
    if problems:
        fail("multi: " + "; ".join(problems))
    emit("multi", one_rank={**one, "shape": {"batch": TRAIN_B, "frames": TRAIN_T,
                                             "layers": L, "hidden": H}},
         two_ranks={"ranks": two, "process_s": two_s}, cli=cli)


def _multi_cli(problems):
    """--train_acoustic with --timeline and --evaluate through
    ``torch.distributed.run`` on one rank; gates appended to ``problems``."""
    import glob

    texts, sigs = _held_out()
    with tempfile.TemporaryDirectory() as tmp:
        made = _flac_corpora(tmp, {"train": _loop_clips(MULTI_CLIPS[0], 21),
                                   "test": _loop_clips(MULTI_CLIPS[1], 22)}, LOOP_SR)
        tb = os.path.join(tmp, "tb")
        os.makedirs(tb)
        ini = os.path.join(tmp, "loop.ini")
        with open(ini, "w") as fh:
            fh.write(LOOP_INI.format(L=L, H=H, ki=INPUT_KEEP, ko=OUTPUT_KEEP, every=LOOP_EVERY,
                                     ckpt=os.path.join(tmp, "ckpt"), train=made["train"][0],
                                     test=made["test"][0], tb=tb))
        rc, out, err, train_s = _torchrun_cli(
            ["--train_acoustic", "--config", ini, "--mesh_data", "0", "--timeline",
             "--max_steps", str(MULTI_STEPS), "--tb_name", "multi"])
        if rc != 0:
            fail(f"multi: torchrun --train_acoustic rc={rc}: {err[-3000:]}")
        ckpt_dirs = sorted(d for d in os.listdir(os.path.join(tmp, "ckpt"))
                           if os.path.isdir(os.path.join(tmp, "ckpt", d)))
        bundles = sorted(os.listdir(os.path.join(tmp, "ckpt", "acoustic")))
        traces = glob.glob(os.path.join(tb, "rank0.*.pt.trace.json"))
        split = _trace_split(traces[0]) if len(traces) == 1 else None
        test_root = _write_held_out_flac(tmp, texts, sigs)
        eval_ini = os.path.join(tmp, "eval.ini")
        with open(eval_ini, "w") as fh:
            fh.write(EVAL_INI.format(bundle=BUNDLE, test=test_root))
        rc_e, out_e, err_e, eval_s = _torchrun_cli(
            ["--evaluate", "--config", eval_ini, "--mesh_data", "0", "--beam_width", "1"])
        if rc_e != 0:
            fail(f"multi: torchrun --evaluate rc={rc_e}: {err_e[-3000:]}")
        plain = RECORD.get("evaluate", {}).get("beam1")
        if plain is None:
            plain_run, = _run_cli_child([["--evaluate", "--config", eval_ini,
                                          "--beam_width", "1"]], tmp, "multi_plain_eval")
            plain = dict(zip(("wer_pct", "cer_pct"), _printed_rates(plain_run["stdout"])))
    wer, cer = _printed_rates(out_e)
    if ckpt_dirs != ["acoustic"] or bundles != [f"acousticmodel-{s}.npz" for s in
                                                (LOOP_EVERY, MULTI_STEPS)] + ["checkpoint"]:
        problems.append(f"cli: checkpoints {ckpt_dirs}, {bundles}")
    if split is None:
        problems.append(f"cli: trace files {traces}")
    else:
        missing = [r for r, n in split["kernels"].items() if not n] + \
            [s for s, n in split["spans"].items() if not n and s in MULTI_SPANS[:3]]
        if missing:
            problems.append(f"cli: the trace lacks {missing}")
    if cer is None or cer != plain["cer_pct"]:
        problems.append(f"cli: --evaluate --mesh_data 0 printed CER {cer}, the plain "
                        f"--evaluate {plain['cer_pct']}")
    return {"train_s": train_s, "evaluate_s": eval_s, "checkpoints": bundles,
            "trace_files": len(traces), "trace": split, "wer_pct": wer, "cer_pct": cer,
            "plain_cer_pct": plain["cer_pct"], "train_stderr_tail": err[-600:]}


# ----------------------------------------------------------- float32 compute

# Float32 compute (the JAX kernels' compute_dtype=float32, float32
# residuals) on the card: the float32 persistent layer backward (row 8's
# recompute mode, row 4's layer sweep), the per-step and per-diagonal
# kernels' float32 instances and the float32 weight-gradient tile, no
# tensor cores.  Each
# kernel and its plain version run the same float32 arithmetic (TF32 off)
# in another summation order: F32_KERNEL_TOL bounds each output's largest
# error over its largest magnitude at the path's shapes (up to 3510
# steps); F32_GRAD_TOL one step's gradients (relative Frobenius per
# tensor) against the plain versions' route, ten times under bf16's
# GRAD_REL_TOL, since no bf16 rounding remains.  The planted fault (the
# backward's inter-layer keep scale 1% too large) read about 2e-2 in bf16.
F32_KERNEL_TOL = 1e-4
F32_GRAD_TOL = 1e-4
F32_LAYER_T = 512          # frames of the layered and recompute routes' gates and timings
F32_WIDE_B = 400           # row 8's second timed batch (the recompute step's, seven row groups)
# ``_path_counters`` entries the float32 route runs: the float32 persistent
# recompute backward with its rebuild products on the float32 GEMM tile, the
# reverse diagonal's float32 layer sweep with its cotangent products, the
# training forward's float32 layer sweep with its input products, and the
# projections' float32 skinny tile (the others count bf16 persistent
# kernels, tensor-core tiles and the per-step and per-diagonal designs these
# replace, which it must not run).
F32_PATHS = ("recompute_rebuild", "recompute_f32_persistent", "wavefront_bwd_sweep",
             "sweep_dout", "wavefront_sweep", "wavefront_sweep_xp", "weight_grad_skinny_f32")
F32_ROWS = ("lstm_wavefront", "lstm_recurrence", "wavefront_train", "wavefront_bwd",
            "recurrence_train", "recurrence_bwd", "recurrence_train_lean",
            "recurrence_bwd_recompute", "dgates_weight_grads", "weight_grad")


def _f32_counters():
    """The wrappers of rows 1-8, 14 and 15, whose ``f32_launches`` count the
    calls that ran their float32 mode."""
    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    fns = (wf.lstm_stack_wavefront, rec.lstm_recurrence, wf.wavefront_train, wf.wavefront_bwd,
           tlt.recurrence_train, tlt.recurrence_bwd, tlt.recurrence_train_lean,
           tlt.recurrence_bwd_recompute, gm.dgates_weight_grads, gm.weight_grad)
    return dict(zip(F32_ROWS, fns))


def _f32_launches(zero=False):
    """{row: float32 launches so far}; with ``zero``, sets them to 0 after
    reading them."""
    counters = _f32_counters()
    counts = {name: fn.f32_launches for name, fn in counters.items()}
    if zero:
        for fn in counters.values():
            fn.f32_launches = 0
    return counts


@contextlib.contextmanager
def _plain_guard(calls):
    """Counts in ``calls`` every call of a kernel's plain version, each at
    the name its wrapper calls it by: a kernel route on the card must run
    none."""
    from unittest import mock

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck
    from rnn_speech_tpu_torch.ops import dropout as tdrop
    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    names = ((wf, "lstm_stack_wavefront_plain"), (wf, "wavefront_train_plain"),
             (wf, "wavefront_bwd_plain"), (rec, "lstm_recurrence_plain"),
             (tlt, "recurrence_train_plain"), (tlt, "recurrence_train_lean_plain"),
             (tlt, "recurrence_bwd_plain"), (tlt, "recurrence_bwd_recompute_plain"),
             (tlt, "rebuild_gates_plain"), (gm, "weight_grad_plain"),
             (gm, "dgates_weight_grads_plain"), (tdrop, "dropout_plain"),
             (tck, "alpha_plain"), (tck, "beta_post_plain"))

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    with contextlib.ExitStack() as stack:
        for module, name in names:
            stack.enter_context(mock.patch.object(module, name,
                                                  counting(name, getattr(module, name))))
        yield


def _f32_eval():
    """The eval path in float32 at B=128 on 10.24 s clips: the committed
    bundle's weights (3x1024) on the 32 held-out sentences, four times
    over, through the wavefront (row 1) and the layered recurrence (row 2):
    utt/s, spread and the stages, and each route's greedy texts, which must
    equal the plain path's (the time loop, no kernel), at CER <= CER_LIMIT."""
    import numpy as np
    import torch

    from rnn_speech_tpu_torch import cli, params as params_mod
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    params = params_mod.load_bundle(BUNDLE, device=DEVICE)
    texts, sigs = _held_out()
    n = int(SR * SECONDS)
    reps = -(-B // len(sigs))
    truth = [t.lower() for t in texts * reps][:B]
    audio_np = np.zeros((B, n), np.float32)
    for i, sig in enumerate((sigs * reps)[:B]):
        audio_np[i, : min(len(sig), n)] = sig[:n]
    lengths_np = np.asarray([min(len(sig), n) for sig in (sigs * reps)[:B]], np.int32)
    audio = torch.as_tensor(audio_np, device=DEVICE)
    lengths = torch.as_tensor(lengths_np, device=DEVICE)
    fe = DeviceFrontend("fbank", sr=SR, max_samples=n, device=DEVICE)
    out, plain_calls = {}, {}
    for name, kw in (("wavefront", dict(use_kernels=True, wavefront=True)),
                     ("layered", dict(use_kernels=True, wavefront=False)),
                     ("plain", dict(use_kernels=False))):
        cfg = acoustic.config_for_params(params, compute_dtype=torch.float32, **kw)
        entry = {}
        with contextlib.ExitStack() as stack, torch.no_grad():
            if name != "plain":
                stack.enter_context(_plain_guard(plain_calls))
                run = lambda: cli.infer(params, cfg, fe, audio, lengths)
                run()
                torch.cuda.synchronize()
                med, spread, vals = _throughput(run, iters=2, reps=3)
                entry.update(utt_per_s=med, spread_pct=spread, values=vals,
                             stage_ms=_stage_ms(params, cfg, fe, audio, lengths, iters=2))
            hyps = cli.transcribe(params, cfg, audio_np, lengths_np, device=DEVICE,
                                  beam_width=1)
        cers = [_edit_distance(t, h.strip()) / max(len(t), 1) for t, h in zip(truth, hyps)]
        entry.update(hyps=hyps, cer_pct=100.0 * float(np.mean(cers)))
        out[name] = entry
    for name in ("wavefront", "layered"):
        if out[name]["hyps"] != out["plain"]["hyps"]:
            fail(f"f32_route eval: the {name} route's greedy texts differ from the plain path's")
        if out[name]["cer_pct"] > CER_LIMIT:
            fail(f"f32_route eval: {name} CER {out[name]['cer_pct']:.3f}% > {CER_LIMIT}%")
    if plain_calls:
        fail(f"f32_route eval: plain versions ran on the card: {plain_calls}")
    return {"clips": B, "distinct_clips": len(sigs), "frames": fe.max_frames,
            "routes": {k: {f: v for f, v in e.items() if f != "hyps"} for k, e in out.items()},
            "hyps_equal_plain": True}


def _widen(inputs):
    """A dict of inputs with its bf16 tensors in float32 (the float32 mode's
    operands); the rest as they are."""
    import torch

    return {k: v.float() if torch.is_tensor(v) and v.dtype == torch.bfloat16 else v
            for k, v in inputs.items()}


def _f32_fused_gap_check():
    """The float32 route's dW_x of layers 1..L-1 (the unfused reverse
    diagonal in drop mode 2, then the weight-gradient kernel's float32 tile
    on its xdrop stream: how the route takes them where the JAX switch
    fuses) against the plain version's fused dW_x (the JAX route past 10
    GiB of residuals) on the same residuals, at T=GRAD_T, B=64: relative
    Frobenius error per layer within F32_GRAD_TOL."""
    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    f32, T, Bn = torch.float32, GRAD_T, TRAIN_B
    inp = _widen(_train_inputs(T, Bn, [T] * Bn, seed=280))
    drop = _drop(2, T, Bn, 282)
    outs, gates, cseq, _, _ = wf.wavefront_train(*[inp[k] for k in FWD_ARGS], f32, *drop)
    b_in = _widen(_bwd_inputs(inp, outs, gates, cseq, seed=281))
    gi = BWD_ARGS.index("gates")
    bargs = [b_in[k] for k in BWD_ARGS]
    dwx_ref = wf.wavefront_bwd_plain(*bargs[:gi], gates.clone(), *bargs[gi + 1:], outs, *drop,
                                     fuse_dwx=True)[3]
    dgates, _, _, xdrop = wf.wavefront_bwd(*bargs, outs, *drop)
    rel = []
    for l in range(L - 1):
        dw = gm.weight_grad(xdrop[l], dgates[l + 1], compute_dtype=f32)[0]
        rel.append(float((dw - dwx_ref[l]).norm() / dwx_ref[l].norm()))
    entry = {"rel_frobenius": rel, "tol": F32_GRAD_TOL, "frames": T, "batch": Bn,
             "drop_mode": 2}
    if not max(rel) <= F32_GRAD_TOL:
        fail(f"f32_route: the unfused route's dW_x parts from the fused one's: {entry}")
    return entry


def _timed_once(fn):
    """(device ms, result) of one call of ``fn``, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), res


@contextlib.contextmanager
def _cudnn_f32():
    """cuDNN without TF32 (its float32 default takes TF32), for the float32
    rows' yardsticks."""
    import torch

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _f32_row(name, check, kernel, plain, library, library_name, flops, nbytes, checks,
             calls=1, designs=None, faults=None, readings=None, **more):
    """One float32 row: the kernel's result (``check()``, on fresh inputs)
    against its plain version's (``plain()``, timed once) within
    F32_KERNEL_TOL, each of ``faults`` ({name: fn}, planted faults of the
    kernel) failing that check and each of ``readings`` (faults that need
    not show, races) recorded as ``fault_readings``, then ``kernel`` in
    turns with ``library``
    (cuDNN or torch.mm in float32, TF32 off) and ``designs`` ({name: fn},
    the designs it replaced, as ``<name>_ms``) and the bound at the float32
    rate.  ``calls`` per pass of the path multiplies the times and the
    bound."""
    import torch

    plain_ms, ref = _timed_once(plain)
    err = _rel_check(f"f32 {name}", check(), ref, F32_KERNEL_TOL, checks)
    for fault, fn in (faults or {}).items():
        _fault_check(f"f32 {name} {fault}", fn(), ref, F32_KERNEL_TOL, checks)
    read = {fault: _fault_errs(fn(), ref) for fault, fn in (readings or {}).items()}
    if read:
        more["fault_readings"] = read
    del ref
    torch.cuda.empty_cache()
    with _cudnn_f32():
        turns = in_turns(library, kernel, iters=1, **(designs or {}))
    bound, by = _bounds(flops, nbytes, PEAK_F32_FLOPS)
    replaced = {f"{n}_ms": calls * turns[f"{n}_ms"] for n in designs or {}}
    return dict(ms=calls * turns["ms"], plain_ms=calls * plain_ms, bound_ms=calls * bound,
                bound_by=by, library_ms=calls * turns["library_ms"], library=library_name,
                max_abs_err=err, tol=F32_KERNEL_TOL, calls=calls, ms_per_call=turns["ms"],
                tflops=flops / turns["ms"] / 1e9, flops=calls * flops, bytes=calls * nbytes,
                turns=turns["turns"], **replaced, **more)


def _f32_kernel_timing(checks, eval_frames, designs=False):
    """Rows 1-8, 14 and 15 in float32 at the float32 path's shapes, each
    held against its plain version on the same inputs (``_f32_row``):
    row 1 at the eval batch (B=128, T=1024, the 3-layer wavefront) in
    turns with cuDNN's 3-layer forward, row 2 one call of the three a
    layered batch makes in turns with its one-layer forward; rows 3 and 4
    at the default step (B=64, T=3510, drop mode 2, the reverse diagonal
    unfused with its xdrop stream) with cuDNN's 3-layer training forward
    and backward without weight gradients; rows 5-8 one layer's call at
    B=64, T=F32_LAYER_T with cuDNN's one-layer forward and backward; row
    14 the step's three LSTM products (N = 224,640, 2 x 1024 by 4096)
    against two torch.mm and a sum each, row 15 the two projections (D=120
    by G=1024, D=1024 by G=80) against one torch.mm and a sum each.  Row 8
    also at B=F32_WIDE_B.  With ``designs`` (phase f32_designs), rows 4
    and 8 also in the same turns with the per-diagonal and per-step
    designs they replaced."""
    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    f32, G = torch.float32, 4 * H
    out = {}
    T = eval_frames                                  # the eval batch's 10.24 s clips
    with torch.no_grad():
        inp = _widen(stack_inputs(T, B, L, [T] * B, seed=199, on_device=True))
        wargs = lambda: run_wavefront(inp, wf.lstm_stack_wavefront)
        out["lstm_wavefront"] = _f32_row(
            "lstm_wavefront", wargs, wargs,
            lambda: run_wavefront(inp, wf.lstm_stack_wavefront_plain),
            _nn_lstm(inp, L, T, dtype=f32), f"torch.nn.LSTM forward ({L} layers, f32)",
            2 * T * B * H * G * (2 * L - 1),
            T * B * G * 4 + (2 * L - 1) * H * G * 4 + (L - 1) * G * 4 + T * B * 4
            + 4 * L * B * H * 4 + T * B * H * 4, checks, frames=T, batch=B)
        rargs = lambda: run_recurrence(inp, rec.lstm_recurrence)
        out["lstm_recurrence"] = _f32_row(
            "lstm_recurrence", rargs, rargs,
            lambda: run_recurrence(inp, rec.lstm_recurrence_plain),
            _nn_lstm(inp, 1, T, dtype=f32), "torch.nn.LSTM forward (1 layer, f32)",
            2 * T * B * H * G, T * B * G * 4 + H * G * 4 + T * B * 4 + 4 * B * H * 4
            + T * B * H * 4, checks, frames=T, batch=B, calls_per_batch=L)
        del inp
        torch.cuda.empty_cache()

    T, Bn = TRAIN_T, TRAIN_B
    inp = _widen(_train_inputs(T, Bn, [T] * Bn, seed=270, on_device=True))
    args = [inp[k] for k in FWD_ARGS]
    modes = _f32_fwd_mode_checks(args, checks)
    drop = _drop(2, T, Bn, 272)
    fwd = lambda: wf.wavefront_train(*args, f32, *drop)
    fplan = wf.wavefront_plan(Bn, H, L, H, dtype=f32)
    fdrop = (2, *wf._drop_launch_args(2, drop[1], drop[3], drop[2], (L - 1, T, Bn, H),
                                      args[0].device))
    fsweep = lambda **kw: wf._fwd_layer_sweep_launch(*args, fdrop, fplan, **kw)
    out["wavefront_train"] = _f32_row(
        "wavefront_train", fwd, fwd, lambda: wf.wavefront_train_plain(*args, f32, *drop),
        _nn_lstm_forward(T, Bn, L, f32), f"torch.nn.LSTM training forward ({L} layers, f32)",
        2 * T * Bn * H * G * 2 * L,
        T * Bn * H * 4 + 2 * L * H * G * 4 + L * G * 4 + T * Bn * 4 + 2 * L * Bn * H * 4
        + L * T * Bn * (H + G + H) * 4 + 2 * L * Bn * H * 4, checks, frames=T, batch=Bn,
        drop_mode=2, plan=fplan["kernel"],
        designs={"per_diagonal": lambda: wf._per_diagonal_launch(*args, fdrop, f32)}
        if designs else None,
        faults={"chain with a partial left out": lambda: fsweep(skip_barrier=4),
                "input product's last K stage left out": lambda: fsweep(skip_k=1)},
        readings={"chain without its step wait": lambda: fsweep(skip_barrier=1),
                  "chain without its slice wait": lambda: fsweep(skip_barrier=2)},
        mode1_fed_equal=_f32_fwd_fed_check(args, drop, fwd))
    row3 = out["wavefront_train"]
    row3.update(modes)
    row3["input_product"] = _f32_xp_timing(args)
    row3["chain_ms_derived"] = row3["ms"] - row3["input_product"]["ms"]
    row3["us_per_step"] = 1e3 * row3["chain_ms_derived"] / (L * T)
    torch.cuda.empty_cache()
    outs, gates, cseq, _, _ = fwd()
    b_in = _widen(_bwd_inputs(inp, outs, gates, cseq, seed=271, on_device=True))
    bargs = [b_in[k] for k in BWD_ARGS]
    gi = BWD_ARGS.index("gates")
    fresh = lambda: bargs[:gi] + [gates.clone()] + bargs[gi + 1:]
    no_dw, _ = _nn_lstm_backward(T, Bn, L, f32)
    ldrop = (2, *wf._drop_launch_args(2, drop[1], drop[3], drop[2], (L - 1, T, Bn, H),
                                      gates.device))
    plan = wf.wavefront_bwd_plan(Bn, H, L, dtype=f32)
    sweep = lambda **kw: wf._layer_sweep_launch(*fresh(), outs, ldrop, plan, **kw)
    out["wavefront_bwd"] = _f32_row(
        "wavefront_bwd", lambda: wf.wavefront_bwd(*fresh(), outs, *drop),
        lambda: wf.wavefront_bwd(*bargs, outs, *drop),
        lambda: wf.wavefront_bwd_plain(*fresh(), outs, *drop), no_dw,
        f"torch.nn.LSTM backward ({L} layers, f32, without weight gradients)",
        2 * T * Bn * H * G * (2 * L - 1),
        T * Bn * H * 4 + (2 * L - 1) * H * G * 4 + T * Bn * 4 + L * T * Bn * (G + H) * 4
        + 3 * L * Bn * H * 4 + (L - 1) * T * Bn * H * 4 + L * T * Bn * G * 4
        + 2 * L * Bn * H * 4 + (L - 1) * T * Bn * H * 4, checks, frames=T, batch=Bn,
        drop_mode=2, fused=False, plan=plan["kernel"],
        designs={"per_diagonal": lambda: wf._bwd_per_diagonal_launch(*bargs, outs, ldrop)}
        if designs else None,
        faults={"chain with a partial left out": lambda: sweep(skip_barrier=4),
                "cotangent product's last K stage left out": lambda: sweep(skip_k=1)},
        readings={"chain without its slice wait": lambda: sweep(skip_barrier=2)})
    del no_dw
    torch.cuda.empty_cache()

    N = T * Bn
    dgates = bargs[gi]                               # dgates, after the timed calls
    h_prev = torch.cat([inp["h0"][0][None], outs[0, :-1]]).reshape(N, H)
    x2, dg2 = outs[1].reshape(N, H), dgates[0].reshape(N, G)
    grads = lambda: gm.dgates_weight_grads(h_prev, x2, dg2, compute_dtype=f32)
    out["dgates_weight_grads"] = _f32_row(
        "dgates_weight_grads", grads, grads,
        lambda: gm.dgates_weight_grads_plain(h_prev, x2, dg2, compute_dtype=f32),
        lambda: (torch.mm(h_prev.t(), dg2), torch.mm(x2.t(), dg2), dg2.sum(0)),
        "torch.mm x 2 + sum (f32)", 2 * N * 2 * H * G, N * (2 * H + G) * 4 + (2 * H + 1) * G * 4,
        checks, calls=L, path=gm.product_path([H, H], G, f32, f32))
    del outs, gates, cseq, b_in, bargs, dgates, dg2, x2, inp, args
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(272)
    per = {}
    for name, D, Gs in (("input", 120, H), ("output", H, V)):
        xx = torch.randn((N, D), generator=g).to(DEVICE)
        dg = (torch.randn((N, Gs), generator=g) * 0.01).to(DEVICE)
        call = lambda: gm.weight_grad(xx, dg, compute_dtype=f32)
        per[name] = _f32_row(
            f"weight_grad {name}", call, call,
            lambda: gm.weight_grad_plain(xx, dg, compute_dtype=f32),
            lambda: (torch.mm(xx.t(), dg), dg.sum(0)), "torch.mm + sum (f32)",
            2 * N * D * Gs, N * (D + Gs) * 4 + (D + 1) * Gs * 4, checks, D=D, G=Gs,
            path=gm.product_path([D], Gs, f32, f32),
            designs={"f32_tile": lambda: _f32_tile_weight_grad(xx, dg)} if designs else None,
            faults={"a K slice left out": lambda: gm._launch([xx], dg, f32, skip_split=0)[:2]})
    out["weight_grad"] = {k: sum(per[n][k] for n in per)
                          for k in ("ms", "plain_ms", "bound_ms", "library_ms", "flops")
                          + (("f32_tile_ms",) if designs else ())}
    out["weight_grad"].update(
        bound_by="bytes" if all(v["bound_by"] == "bytes" for v in per.values())
        else "operations", max_abs_err=max(v["max_abs_err"] for v in per.values()),
        library="torch.mm + sum (f32), per projection", calls=per)
    torch.cuda.empty_cache()

    T, Bn = F32_LAYER_T, TRAIN_B
    lay = _widen(_layer_inputs(T, Bn, [T] * Bn, seed=273, on_device=True))
    tail = (lay["w_h"], lay["mask"], lay["h0"], lay["c0"], f32)
    fwd_bytes = T * Bn * G * 4 + H * G * 4 + T * Bn * 4 + 4 * Bn * H * 4
    for name, fwd, fwd_plain, res in (
            ("recurrence_train", tlt.recurrence_train, tlt.recurrence_train_plain,
             T * Bn * (H + G + H) * 4),
            ("recurrence_train_lean", tlt.recurrence_train_lean, tlt.recurrence_train_lean_plain,
             T * Bn * 2 * H * 4)):
        call = lambda fn=fwd: fn(lay["x_proj"], *tail)
        out[name] = _f32_row(
            name, call, call, lambda fn=fwd_plain: fn(lay["x_proj"], *tail),
            _nn_lstm_forward(T, Bn, 1, f32), "torch.nn.LSTM training forward (1 layer, f32)",
            2 * T * Bn * H * G, fwd_bytes + res, checks, frames=T, batch=Bn)
    lout, _, _, lgates, lcseq = tlt.recurrence_train(lay["x_proj"], *tail)
    btail = (lay["mask"], lay["w_h"], lay["dhn"], lay["dcn"])
    no_dw, _ = _nn_lstm_backward(T, Bn, 1, f32)
    out["recurrence_bwd"] = _f32_row(
        "recurrence_bwd", lambda: tlt.recurrence_bwd(lay["dout"], lgates.clone(), lcseq,
                                                     lay["c0"], *btail),
        lambda: tlt.recurrence_bwd(lay["dout"], lgates, lcseq, lay["c0"], *btail),
        lambda: tlt.recurrence_bwd_plain(lay["dout"], lgates.clone(), lcseq, lay["c0"], *btail),
        no_dw, "torch.nn.LSTM backward (1 layer, f32, without weight gradients)",
        2 * T * Bn * H * G, T * Bn * (2 * H + 2 * G) * 4 + H * G * 4 + 5 * Bn * H * 4
        + T * Bn * 4, checks, frames=T, batch=Bn)
    h_prev = torch.cat([lay["h0"][None], lout[:-1]])
    rargs = (lay["dout"], lay["x"], h_prev, lcseq, lay["c0"], lay["mask"], lay["w_x"], lay["b"],
             lay["w_h"], lay["dhn"], lay["dcn"])
    out["recurrence_bwd_recompute"] = _f32_recompute_row(rargs, no_dw, checks, designs)
    out["recurrence_bwd_recompute"]["rebuild"] = _rebuild_timing(
        lay["x"], h_prev, lay["w_x"], lay["w_h"], lay["b"])
    del no_dw, lay, lgates, lcseq, lout, rargs, h_prev
    torch.cuda.empty_cache()
    Bw = F32_WIDE_B
    lay = _widen(_layer_inputs(T, Bw, [T] * Bw, seed=274, on_device=True))
    lout, _, _, lcseq = tlt.recurrence_train_lean(lay["x_proj"], lay["w_h"], lay["mask"],
                                                  lay["h0"], lay["c0"], f32)
    rargs = (lay["dout"], lay["x"], torch.cat([lay["h0"][None], lout[:-1]]), lcseq, lay["c0"],
             lay["mask"], lay["w_x"], lay["b"], lay["w_h"], lay["dhn"], lay["dcn"])
    del lout
    no_dw, _ = _nn_lstm_backward(T, Bw, 1, f32)
    out["recurrence_bwd_recompute"]["wide"] = _f32_recompute_row(rargs, no_dw, checks, designs)
    del no_dw, lay, lcseq, rargs
    torch.cuda.empty_cache()
    return out


def _f32_fwd_mode_checks(args, checks):
    """Row 3 in float32 (the layer sweep) in drop modes 0 and 1 (masks of
    the seed words' bits) at the default step's shape: outs, gates, cseq,
    hn, cn against ``wavefront_train_plain`` within F32_KERNEL_TOL, each
    beside the chain with the slice's last partial left out.  Mode 2 is
    ``_f32_kernel_timing``'s row."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    f32, (T, Bn) = torch.float32, args[0].shape[:2]
    plan = wf.wavefront_plan(Bn, H, L, H, dtype=f32)
    out = {}
    for mode in (0, 1):
        drop = (0, None, 1.0, 1.0) if mode == 0 else _drop(mode, T, Bn, 275)
        ldrop = (mode, *wf._drop_launch_args(mode, drop[1], drop[3], drop[2], (L - 1, T, Bn, H),
                                             args[0].device))
        ref = wf.wavefront_train_plain(*args, f32, *drop)
        err = _rel_check(f"f32 wavefront_train mode {mode}", wf.wavefront_train(*args, f32, *drop),
                         ref, F32_KERNEL_TOL, checks)
        _fault_check(f"f32 wavefront_train mode {mode} chain with a partial left out",
                     wf._fwd_layer_sweep_launch(*args, ldrop, plan, skip_barrier=4), ref,
                     F32_KERNEL_TOL, checks)
        out[f"mode{mode}_max_abs_err"] = err
        del ref
        torch.cuda.empty_cache()
    return out


def _f32_fwd_fed_check(args, drop, fwd):
    """Row 3 in float32 in drop mode 2 bit-equal to mode 1 fed the seed
    words' bits (``wavefront_masks``): the chain draws the bits the
    per-diagonal kernel and the reverse diagonal draw."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    T, Bn = args[0].shape[:2]
    masks = wf.drop_keeps(2, drop[1], drop[3], (L - 1, T, Bn, H), args[0].device)
    fed = wf.wavefront_train(*args, torch.float32, 1, masks, drop[2], drop[3])
    equal = all(torch.equal(a, b) for a, b in zip(fwd(), fed))
    if not equal:
        fail("f32_route: row 3's sweep in drop mode 2 differs from mode 1 fed its bits")
    return equal


def _f32_xp_timing(args):
    """Row 3's sweep split: its L layers' input products alone on the
    float32 GEMM tile (``fwd_f32_xp``, on the sweep's operands: x for layer
    0, a (T, B, H) input for the others), device ms by CUDA events and
    TFLOP/s; the chains' share is the row's ms minus this."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    x, w_x0, _, w_x_rest, b_all = args[:5]
    T, Bn = x.shape[:2]
    h_in = torch.randn((T, Bn, H), device=x.device)
    ms, flops = 0.0, 0
    for l in range(L):
        x_in, w_x = (x, w_x0) if l == 0 else (h_in, w_x_rest[l - 1])
        ms += cuda_ms(lambda: tlt.fwd_f32_xp(x_in, w_x, b_all[l]))
        flops += 2 * T * Bn * 4 * H * x_in.shape[-1]
    del h_in
    return {"ms": ms, "tflops": flops / ms / 1e9, "flops": flops}


def _f32_tile_weight_grad(x, dg):
    """The projections' weight gradients on the float32 tile (``"f32"``,
    the design the float32 skinny tile replaced), forced by its path."""
    from unittest import mock

    import torch

    from rnn_speech_tpu_torch.ops import grad_matmul as gm

    with mock.patch.object(gm, "product_path", lambda *a: "f32"):
        return gm.weight_grad(x, dg, compute_dtype=torch.float32)


def _f32_recompute_row(rargs, no_dw, checks, designs=False):
    """Row 8 in float32 (``_f32_row``) on one layer's recompute-backward
    arguments ``rargs``: the float32 persistent kernel, in turns with cuDNN
    (``no_dw``) and, with ``designs``, the per-step design it replaced (its
    rebuild products on the same float32 tile), beside its planted fault (the slice's last
    partial left out of the sum) and, as readings, its barriers left out
    (no step wait on a dgates stream filled with NaN, no slice wait): races
    that show only now and then."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt

    f32, G = torch.float32, 4 * H
    T, Bn = rargs[3].shape[:2]
    plan = tlt.bwd_plan(Bn, H, dtype=f32, recompute=True)
    nan = lambda: torch.full((T, Bn, G), float("nan"), device=rargs[0].device)
    fault = lambda skip: tlt._recompute_f32_persistent_launch(*rargs, plan, skip_barrier=skip,
                                                              dgates=nan())[:3]
    call = lambda: tlt.recurrence_bwd_recompute(*rargs)
    return _f32_row(
        "recurrence_bwd_recompute", call, call, lambda: tlt.recurrence_bwd_recompute_plain(*rargs),
        no_dw, "torch.nn.LSTM backward (1 layer, f32, without weight gradients)",
        3 * 2 * T * Bn * H * G, T * Bn * (H + H + H + H + G) * 4 + 2 * H * G * 4
        + 5 * Bn * H * 4 + T * Bn * 4, checks, frames=T, batch=Bn, plan=plan["kernel"],
        designs={"per_step": lambda: tlt._recompute_per_step_launch(*rargs)} if designs else None,
        faults={"with a partial left out": lambda: fault(4)},
        readings={"without its step wait": lambda: fault(1),
                  "without its slice wait": lambda: fault(2)})


def phase_f32_route():
    """The float32 compute mode on the card at the flagship width, through
    ``models/acoustic`` and ``train/step``: the eval path (``_f32_eval``);
    the default step (B=64, T=3510, keeps 0.8/0.5, the CTC kernels) in
    float32, whose memory plan must answer gates residuals, 2 warm-up and
    3 timed steps and one split by its marks, a falling finite loss, the
    peak memory; one step's gradients at T=GRAD_T against the plain
    versions' route within F32_GRAD_TOL beside the planted fault (the
    backward's inter-layer scale 1% too large); the layered gates route
    and the recompute route likewise at B=64, T=F32_LAYER_T (each beside
    its layer backward's dgates 1% too large); the float32 launches of
    rows 1-8, 14 and 15; rows 4 and 8 on their float32 kernels (the layer
    sweep in the default step and its gate, the float32 persistent
    recompute backward in the recompute gate), and no bf16 persistent
    kernel, no tensor-core tile, no per-step recompute or per-diagonal
    reverse pass and no plain version on the card; then each row's float32
    time (``_f32_kernel_timing``) and the new kernels' planted faults."""
    import torch

    from rnn_speech_tpu_torch.models import acoustic

    f32 = torch.float32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _f32_launches(zero=True)
    launches = {}
    eval_entry = _f32_eval()
    launches["eval"] = _f32_launches(zero=True)
    if not (launches["eval"]["lstm_wavefront"] and launches["eval"]["lstm_recurrence"]):
        fail(f"f32_route eval: rows 1 and 2 did not run in float32: {launches['eval']}")

    scfg, state, batch = _train_setup(TRAIN_T, MAX_LABEL, LABEL_LEN, seed=0, compute_dtype=f32)
    plan = acoustic.training_memory_plan(scfg.model, TRAIN_T, TRAIN_B)
    if plan != (0, "gates"):
        fail(f"f32_route: memory plan {plan} at B=64, T=3510; expected (0, 'gates')")
    plain_calls = {}
    with _plain_guard(plain_calls):
        step, state = _run_steps(scfg, state, batch, reps=3, record_stages=True, per_rep=1)
    launches["train"] = _f32_launches(zero=True)
    del state, batch
    torch.cuda.empty_cache()
    losses = step["losses"]
    if not sum(losses[-3:]) / 3 < losses[0]:
        fail(f"f32_route: the mean of the last 3 losses is not below the first: {losses}")
    for row in ("wavefront_train", "wavefront_bwd", "dgates_weight_grads", "weight_grad"):
        if not launches["train"][row]:
            fail(f"f32_route: the float32 step did not run row {row} in float32: "
                 f"{launches['train']}")
    tensor_core = {k: v for k, v in step["wgmma_launches"].items() if v and k not in F32_PATHS}
    if tensor_core:
        fail(f"f32_route: the float32 step ran bf16 persistent kernels, tensor-core tiles or "
             f"the per-diagonal design: {tensor_core}")
    if not (step["wgmma_launches"]["wavefront_bwd_sweep"] and step["wgmma_launches"]["sweep_dout"]):
        fail(f"f32_route: the float32 step's reverse diagonal did not run the layer sweep "
             f"(row 4): {step['wgmma_launches']}")
    paths = step["wgmma_launches"]
    if not (paths["wavefront_sweep"] == paths["wavefront_sweep_xp"] == L * step["steps"]
            and not paths["wavefront_per_diagonal"]):
        fail(f"f32_route: the float32 step's training forward did not run the layer sweep "
             f"(row 3, a chain and an input product a layer a step) or ran the per-diagonal "
             f"kernel: {paths}")
    if paths["weight_grad_skinny_f32"] != 2 * step["steps"]:
        fail(f"f32_route: the float32 step's two projections did not run the float32 skinny "
             f"tile (row 15) every step: {paths}")
    if plain_calls:
        fail(f"f32_route: plain versions ran on the card: {plain_calls}")

    runs = {}
    before = _path_counters()
    gates = {"default": _grad_check(model_kw=dict(compute_dtype=f32), tol=F32_GRAD_TOL)}
    launches["grad_check"] = _f32_launches(zero=True)
    runs["default"] = {k: v - before[k] for k, v in _path_counters().items()}
    for name, kw, fault in (("layered", dict(wavefront=False), "recurrence_bwd"),
                            ("recompute", dict(residual_mode="recompute"),
                             "recurrence_bwd_recompute")):
        before = _path_counters()
        gates[name] = _grad_check(model_kw=dict(compute_dtype=f32, **kw), tol=F32_GRAD_TOL,
                                  fault=_layer_fault(fault), T=F32_LAYER_T)
        launches[name] = _f32_launches(zero=True)
        runs[name] = {k: v - before[k] for k, v in _path_counters().items()}
    if not (runs["default"]["wavefront_bwd_sweep"] and runs["default"]["wavefront_sweep"]):
        fail(f"f32_route: the default route's gate did not run rows 4 and 3's layer sweeps: "
             f"{runs}")
    if not runs["recompute"]["recompute_f32_persistent"]:
        fail(f"f32_route: the recompute route's gate did not run row 8's float32 persistent "
             f"kernel: {runs}")
    gates["fused_dwx_gap"] = _f32_fused_gap_check()
    _f32_launches(zero=True)
    for row, route in (("recurrence_train", "layered"), ("recurrence_bwd", "layered"),
                       ("recurrence_train_lean", "recompute"),
                       ("recurrence_bwd_recompute", "recompute")):
        if not launches[route][row]:
            fail(f"f32_route: the {route} route did not run row {row} in float32: "
                 f"{launches[route]}")
    paths = {k: v for k, v in _path_counters().items() if k not in F32_PATHS}
    if any(paths.values()):
        fail(f"f32_route: a bf16 persistent kernel, a tensor-core tile or a per-step or "
             f"per-diagonal design the float32 kernels replace ran: {paths}")
    torch.cuda.empty_cache()
    checks = []
    timing = _f32_kernel_timing(checks, eval_entry["frames"])
    emit("f32_route", eval=eval_entry, train=step, memory_plan=list(plan), grad_check=gates,
         launches=launches, timing=timing, checks=checks, paths=runs,
         max_abs_err={k: v["max_abs_err"] for k, v in timing.items()})


def phase_f32_designs():
    """Opt-in: ``_f32_kernel_timing`` with the designs rows 3, 4, 8 and 15
    replaced in the same turns (the per-diagonal training forward and
    reverse pass at B=64, T=3510; the per-step recompute backward at B=64
    and B=F32_WIDE_B, T=F32_LAYER_T; the float32 tile at the two
    projections), each row's checks and planted faults as in f32_route."""
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    frames = DeviceFrontend("fbank", sr=SR, max_samples=int(SR * SECONDS),
                            device=DEVICE).max_frames
    checks = []
    timing = _f32_kernel_timing(checks, frames, designs=True)
    emit("f32_designs", timing={k: timing[k] for k in ("wavefront_train", "wavefront_bwd",
                                                       "recurrence_bwd_recompute",
                                                       "weight_grad")},
         checks=checks)


# Phase odd_shapes: widths the kernels take only padded (H and D not
# multiples of 64) in every compute and residual mode.
ODD_SHAPE = dict(L=3, T=40, B=24, H=100, D=72)
ODD_TOL = {"bf16": 1e-3, "f32": 1e-4, "bf16_f32": 1e-3, "f32_bf16": 1e-3}
ODD_MODES = {"bf16": ("bfloat16", "bfloat16"), "f32": ("float32", "float32"),
             "bf16_f32": ("bfloat16", "float32"), "f32_bf16": ("float32", "bfloat16")}


def _odd_rows(cd, rd, seed):
    """{row: (kernel call, plain call)} of rows 1-8 at ODD_SHAPE in compute
    dtype ``cd`` and residual dtype ``rd`` (rows 1 and 2, which keep no
    residuals, where the two agree), on inputs drawn on the host."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    L, T, Bn, Hh, D = (ODD_SHAPE[k] for k in ("L", "T", "B", "H", "D"))
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(DEVICE)
    lim = (6.0 / (5 * Hh)) ** 0.5
    w = lambda *s: ((torch.rand(s, generator=g) * 2 - 1) * lim).to(DEVICE, cd)
    lens = torch.as_tensor([T - (7 * b) % (T + 1) for b in range(Bn)])
    mask = (torch.arange(T)[:, None] < lens[None]).float()[:, None, :].to(DEVICE)
    x_proj, w_h, w_x = r(T, Bn, 4 * Hh), w(Hh, 4 * Hh), w(D, 4 * Hh)
    h0, c0, b = r(Bn, Hh, scale=0.2), r(Bn, Hh, scale=0.2), r(4 * Hh, scale=0.1)
    dout, dhn, dcn = r(T, Bn, Hh, scale=0.1), r(Bn, Hh, scale=0.1), r(Bn, Hh, scale=0.1)
    x = r(T, Bn, D).to(cd)
    rows = {}
    if cd == rd:
        args = (x_proj, w_h, mask, h0, c0)
        rows["lstm_recurrence"] = (lambda: rec.lstm_recurrence(*args),
                                   lambda: rec.lstm_recurrence_plain(*args))
        wargs = (x_proj, w(L, Hh, 4 * Hh), w(L - 1, Hh, 4 * Hh), r(L - 1, 1, 4 * Hh, scale=0.1),
                 mask, r(L, Bn, Hh, scale=0.2), r(L, Bn, Hh, scale=0.2))
        rows["lstm_wavefront"] = (lambda: wf.lstm_stack_wavefront(*wargs),
                                  lambda: wf.lstm_stack_wavefront_plain(*wargs))
    fargs = (x_proj, w_h, mask, h0, c0, rd)
    rows["recurrence_train"] = (lambda: tlt.recurrence_train(*fargs),
                                lambda: tlt.recurrence_train_plain(*fargs))
    largs = (x_proj.to(rd),) + fargs[1:]
    rows["recurrence_train_lean"] = (lambda: tlt.recurrence_train_lean(*largs),
                                     lambda: tlt.recurrence_train_lean_plain(*largs))
    out, _, _, gates, cseq = tlt.recurrence_train_plain(*fargs)
    c0r = c0.to(rd).float()
    btail = (cseq, c0r, mask, w_h, dhn, dcn)
    rows["recurrence_bwd"] = (lambda: tlt.recurrence_bwd(dout, gates.clone(), *btail),
                              lambda: tlt.recurrence_bwd_plain(dout, gates.clone(), *btail))
    xp_lean = (x.float() @ w_x.float() + b).to(rd)
    lout, _, _, lcseq = tlt.recurrence_train_lean_plain(xp_lean, w_h, mask, h0, c0, rd)
    rargs = (dout, x.to(rd), torch.cat([h0.to(rd)[None], lout.to(rd)[:-1]]), lcseq, c0r, mask,
             w_x, b, w_h, dhn, dcn)
    rows["recurrence_bwd_recompute"] = (lambda: tlt.recurrence_bwd_recompute(*rargs),
                                        lambda: tlt.recurrence_bwd_recompute_plain(*rargs))
    drop = (2, (7, 9), 1 / KEEP_PROB, KEEP_PROB)
    stack = (x, w_x, w(L, Hh, 4 * Hh), w(L - 1, Hh, 4 * Hh), r(L, 4 * Hh, scale=0.1), mask,
             r(L, Bn, Hh, scale=0.2), r(L, Bn, Hh, scale=0.2), rd, *drop)
    rows["wavefront_train"] = (lambda: wf.wavefront_train(*stack),
                               lambda: wf.wavefront_train_plain(*stack))
    souts, sgates, scseq, _, _ = wf.wavefront_train_plain(*stack)
    bargs = (dout.to(rd), stack[2], stack[3], mask)
    bt = (scseq, r(L, Bn, Hh, scale=0.2).to(rd).float(), r(L, Bn, Hh, scale=0.1),
          r(L, Bn, Hh, scale=0.1), souts, *drop)
    rows["wavefront_bwd"] = (lambda: wf.wavefront_bwd(*bargs, sgates.clone(), *bt),
                             lambda: wf.wavefront_bwd_plain(*bargs, sgates.clone(), *bt))
    return rows


def phase_odd_shapes():
    """Rows 1-8 at H=100, D=72 (ODD_SHAPE: L=3, T=40, B=24), which the
    wrappers pad to 128 and slice back, in bf16 and float32, and rows 3-8 in
    both mixed compute and residual modes: each output within ODD_TOL
    (relative Frobenius) of the plain version on the same inputs, every
    call launching its wrapper's kernel and no plain version on the card."""
    import torch

    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_recurrence as rec
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    wrappers = {"lstm_recurrence": rec.lstm_recurrence, "lstm_wavefront": wf.lstm_stack_wavefront,
                "recurrence_train": tlt.recurrence_train,
                "recurrence_train_lean": tlt.recurrence_train_lean,
                "recurrence_bwd": tlt.recurrence_bwd,
                "recurrence_bwd_recompute": tlt.recurrence_bwd_recompute,
                "wavefront_train": wf.wavefront_train, "wavefront_bwd": wf.wavefront_bwd}
    result = {}
    for mode, (cd, rd) in ODD_MODES.items():
        cd, rd = getattr(torch, cd), getattr(torch, rd)
        entry = {}
        for name, (kernel, plain) in _odd_rows(cd, rd, seed=len(result) + 300).items():
            ref = plain()
            calls, before = {}, wrappers[name].launches
            with _plain_guard(calls):
                got = kernel()
            torch.cuda.synchronize()
            launched = wrappers[name].launches - before
            rel = []
            for gt, rt in zip(got, ref):
                if gt.shape != rt.shape or not bool(torch.isfinite(gt.float()).all()):
                    fail(f"odd_shapes {mode} {name}: bad shape or non-finite output")
                den = float(rt.float().norm())
                rel.append(float((gt.float() - rt.float()).norm()) / den if den else 0.0)
            entry[name] = {"rel_frobenius": rel, "launches": launched, "plain_calls": calls}
            if calls or launched != 1:
                fail(f"odd_shapes {mode} {name}: not on its kernel: {entry[name]}")
            if max(rel) > ODD_TOL[mode]:
                fail(f"odd_shapes {mode} {name}: {max(rel)} > {ODD_TOL[mode]}: {entry[name]}")
        result[mode] = entry
    emit("odd_shapes", shape=ODD_SHAPE, tol=ODD_TOL, modes=result)


def _hw_parity_faults():
    """{check: planted-fault context} for the parity tool's seven checks,
    each past its check's tolerance: a kernel route's output times 1.1 (the
    LSTM, wavefront, CTC, fbank and weight-gradient checks), the best beam's
    score 0.05 high, the dropout keep 0.01 low."""
    from unittest import mock

    from rnn_speech_tpu_torch.ops import ctc_kernel as tck
    from rnn_speech_tpu_torch.ops import decode as tdec
    from rnn_speech_tpu_torch.ops import dropout as tdrop
    from rnn_speech_tpu_torch.ops import frontend_kernel as tfk
    from rnn_speech_tpu_torch.ops import grad_matmul as gm
    from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
    from rnn_speech_tpu_torch.ops import lstm_wavefront as wf

    def scaled(fn, index=None):
        @functools.wraps(fn)                         # its launch counters too
        def faulty(*args, **kw):
            res = fn(*args, **kw)
            if index is None:
                return res * 1.1
            return tuple(r * 1.1 if i == index else r for i, r in enumerate(res))
        return faulty

    def beam_off(fn):
        @functools.wraps(fn)
        def faulty(*args, **kw):
            labels, lengths, scores = fn(*args, **kw)
            return labels, lengths, scores + 0.05
        return faulty

    def keep_low(fn):
        @functools.wraps(fn)
        def faulty(x, seed, keeps):
            return fn(x, seed, [k - 0.01 for k in keeps])
        return faulty
    specs = {"check_lstm": (tlt, "recurrence_train", lambda f: scaled(f, 0)),
             "check_wavefront": (wf, "wavefront_train", lambda f: scaled(f, 0)),
             "check_ctc": (tck, "ctc_alpha_lossonly", scaled),
             "check_frontend": (tfk, "fbank_banks", scaled),
             "check_beam": (tdec, "beam_search_decode", beam_off),
             "check_dropout": (tdrop, "dropout_kernel", keep_low),
             "check_grad_matmul": (gm, "dgates_weight_grads", lambda f: scaled(f, 0))}
    return {name: (lambda m=m, a=a, f=f: mock.patch.object(m, a, f(getattr(m, a))))
            for name, (m, a, f) in specs.items()}


HW_PARITY_ROWS = ("lstm_wavefront", "lstm_recurrence", "wavefront_train", "wavefront_bwd",
                  "recurrence_train", "recurrence_bwd", "recurrence_train_lean",
                  "recurrence_bwd_recompute", "dgates_weight_grads", "dropout",
                  "ctc_alpha_ckpt", "ctc_alpha_lossonly", "ctc_beta_post", "fbank_banks")


def phase_hw_parity():
    """``rnn_speech_tpu_torch.tools.hw_parity`` in-process on the card: its
    seven checks (each error beside its tolerance), the kernels they launch
    (rows 1-8 in float32, 9, 10, 12, 14, 16 and 18 must), then each check
    under its planted fault (``_hw_parity_faults``), which must fail it."""
    import torch

    from rnn_speech_tpu_torch.tools import hw_parity

    dev = torch.device(DEVICE)
    counters = {**_all_counters(), **_f32_counters()}
    for fn in counters.values():
        fn.launches = 0
    _f32_launches(zero=True)
    t0 = time.perf_counter()
    records = hw_parity.run(dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: counters[name].launches for name in HW_PARITY_ROWS}
    f32 = _f32_launches(zero=True)
    if not all(launches.values()):
        fail(f"hw_parity: the tool did not launch every kernel it drives: {launches}")
    if not all(f32[row] for row in F32_ROWS[:8]):
        fail(f"hw_parity: rows 1-8 did not run in float32: {f32}")
    faults = {}
    for check in hw_parity.CHECKS:
        with _hw_parity_faults()[check.__name__]():
            try:
                check(dev)
            except AssertionError as err:
                faults[check.__name__] = str(err)[:300]
                continue
        fail(f"hw_parity: {check.__name__} passes under its planted fault")
    emit("hw_parity", checks=records, seconds=seconds, launches=launches, f32_launches=f32,
         planted_faults=faults)


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
    beside the one without; the projections' weight gradients: their
    launches on the skinny tile, the WMMA tile's ms in the same turns and
    each call apart; the checkpoint forward: its µs a step); for
    the fused dW_x one reverse pass at B=96, T=3510 in drop mode 2 (its
    library_ms cuDNN's 3-layer backward with weight gradients, in turns)
    and the launches of the widest gates-residual step's 5 steps
    (train_wide).  The weight-gradient rows add their TFLOP/s, the fused
    row its persistent launches, the per-diagonal pass's ms in the same
    turns, the B=394 pass beside it, and its window products' ms and
    TFLOP/s (``window_library_ms`` times torch.mm for the same dW_x), the
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
            stream = RECORD.get("stream", {}).get("decoders", {})
            if stream:                               # B=1 blocks with carried state
                rows[-1]["stream_launches"] = sum(d["launches"]["row1"]
                                                  for d in stream.values())
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
        if name == "weight_grad":                    # the projections on the skinny tile
            rows[-1].update(
                skinny_launches=tr.get("wgmma_launches", {}).get("weight_grad_skinny"),
                wmma_ms=t.get("wmma_ms"), device_ms=t.get("device_ms"),
                calls={k: {f: c.get(f) for f in ("D", "G", "x", "dg", "ms", "library_ms",
                                                  "wmma_ms", "device_ms", "bound_ms")}
                       for k, c in t.get("calls", {}).items()})
        if name in ("ctc_alpha_ckpt", "ctc_alpha_lossonly"):   # the alpha forward's modes
            rows[-1].update(us_per_step=t.get("us_per_step"), geometry=t.get("geometry"))
    tl = RECORD.get("train_layered", {})
    for name, src, replaces, run in (
        ("recurrence_train", csrc + "lstm_layer_lean.cu",
         "rnn_speech_tpu/ops/lstm_pallas.py:144", "layered"),
        ("recurrence_bwd", csrc + "lstm_layer_bwd_persistent.cu",
         "rnn_speech_tpu/ops/lstm_pallas.py:232", "layered"),
        ("recurrence_train_lean", csrc + "lstm_layer_lean.cu",
         "rnn_speech_tpu/ops/lstm_pallas.py:342", "recompute"),
        ("recurrence_bwd_recompute", csrc + "lstm_layer_bwd_persistent.cu",
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
        if name in ("recurrence_bwd", "recurrence_bwd_recompute"):   # the parent design
            rows[-1]["per_step_ms"] = t.get("per_step_ms")
        if name == "recurrence_bwd_recompute":
            paths = tl.get(run, {}).get("wgmma_launches", {})
            rows[-1].update(persistent_launches=paths.get("recompute_persistent"),
                            per_step_launches=paths.get("recompute_per_step"),
                            us_per_step=t.get("us_per_step"))
    tw = RECORD.get("train_wide", {})
    t = tw.get("timing", {}).get("wavefront_bwd_fuse_dwx", {})
    wide_paths = tw.get("wide", {}).get("wgmma_launches", {})
    rows.append({
        "name": "wavefront_bwd_fuse_dwx", "route": "cuda",
        "source": csrc + "lstm_wavefront_bwd_persistent.cu",
        "replaces": "rnn_speech_tpu/ops/lstm_wavefront.py:574",
        "launches": tw.get("wide", {}).get("fused_launches"),
        "max_abs_err": tk.get("max_abs_err", {}).get("wavefront_bwd_fused"),
        "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
        "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
        "library_ms": t.get("library_ms"),
        "persistent_launches": wide_paths.get("wavefront_bwd_fused_persistent"),
        "per_diagonal_ms": t.get("per_diagonal_ms"),
        "window_products_ms": t.get("window_products_ms"),
        "window_library_ms": t.get("window_library_ms"),
        "tflops": t.get("window_products_tflops"),
        "ms_b394": tw.get("fused_pass_wide", {}).get("ms"),
        "per_diagonal_ms_b394": tw.get("fused_pass_wide", {}).get("per_diagonal_ms"),
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
        if name == "ctc_alpha_stream":                # the alpha forward's stream mode
            rows[-1].update(us_per_step=t.get("us_per_step"), geometry=t.get("geometry"))
    # The float32 modes of rows 1-8, 14 and 15 (phase f32_route): launches
    # of the float32 eval (rows 1, 2), default steps (3, 4, 14, 15) and the
    # layered and recompute routes' gradient gates (5-8); times at the
    # float32 path's shapes (rows 5-8 one layer at B=64, T=F32_LAYER_T).
    fr = RECORD.get("f32_route", {})
    fl = fr.get("launches", {})
    for name, src, replaces, run in (
        ("lstm_wavefront", "lstm_wavefront.cu", "rnn_speech_tpu/ops/lstm_wavefront.py:90", "eval"),
        ("lstm_recurrence", "lstm_recurrence.cu", "rnn_speech_tpu/ops/lstm_pallas.py:62", "eval"),
        ("wavefront_train", "lstm_layer_fwd_f32.cu", "rnn_speech_tpu/ops/lstm_wavefront.py:230",
         "train"),
        ("wavefront_bwd", "lstm_layer_bwd_f32.cu", "rnn_speech_tpu/ops/lstm_wavefront.py:433",
         "train"),
        ("recurrence_train", "lstm_layer_train.cu", "rnn_speech_tpu/ops/lstm_pallas.py:144",
         "layered"),
        ("recurrence_bwd", "lstm_layer_bwd.cu", "rnn_speech_tpu/ops/lstm_pallas.py:232",
         "layered"),
        ("recurrence_train_lean", "lstm_layer_train.cu", "rnn_speech_tpu/ops/lstm_pallas.py:342",
         "recompute"),
        ("recurrence_bwd_recompute", "lstm_layer_bwd_f32.cu",
         "rnn_speech_tpu/ops/lstm_pallas.py:429", "recompute"),
        ("dgates_weight_grads", "grad_matmul.cu", "rnn_speech_tpu/ops/grad_matmul_pallas.py:52",
         "train"),
        ("weight_grad", "grad_matmul.cu", "rnn_speech_tpu/ops/grad_matmul_pallas.py:96", "train"),
    ):
        t = fr.get("timing", {}).get(name, {})
        rows.append({
            "name": name + "_f32", "route": "cuda", "source": csrc + src, "replaces": replaces,
            "launches": fl.get(run, {}).get(name), "max_abs_err": t.get("max_abs_err"),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"), "compute_dtype": "float32",
            "tflops": t.get("tflops"),
        })
        for extra in ("per_diagonal_ms", "per_step_ms", "f32_tile_ms", "plan", "us_per_step",
                      "chain_ms_derived"):
            if extra in t:                           # rows 3, 4, 8, 15: the designs replaced
                rows[-1][extra] = t[extra]
        paths = fr.get("train", {}).get("wgmma_launches", {})
        if name == "wavefront_train":                # row 3: the layer sweep's launches
            rows[-1].update(sweep_launches=paths.get("wavefront_sweep"),
                            input_product=t.get("input_product"))
        if name == "weight_grad":                    # row 15: the float32 skinny tile's
            rows[-1]["skinny_f32_launches"] = paths.get("weight_grad_skinny_f32")
        if "wide" in t:
            rows[-1]["wide"] = {k: t["wide"].get(k) for k in (
                "batch", "ms", "per_step_ms", "library_ms", "bound_ms", "max_abs_err")}
        if "rebuild" in t:
            rows[-1]["rebuild_ms"] = t["rebuild"]["call_ms"]
            rows[-1]["rebuild_tflops"] = t["rebuild"]["call_tflops"]
    # The CLI's own paths, each counted from zero in its run: the first
    # --train_acoustic run (train steps and evaluation passes) and the
    # greedy --evaluate run.
    loop_launches = RECORD.get("train_loop", {}).get("first", {}).get("launches") or {}
    eval_launches = RECORD.get("evaluate", {}).get("beam1", {}).get("launches") or {}
    for row in rows:
        if loop_launches:
            row["train_loop_launches"] = loop_launches.get(row["name"], 0)
        if eval_launches:
            row["evaluate_launches"] = eval_launches.get(row["name"], 0)
    return {"kernels": rows}


PHASES = ("device", "build", "kernels", "train_kernels", "eval", "train", "train_layered",
          "alt_routes", "train_wide", "f32_route", "odd_shapes", "hw_parity", "train_loop",
          "evaluate",
          "bundle", "accuracy", "beam", "cli", "lm", "stream", "multi")
OPT_IN_PHASES = ("grad_study", "lean_study", "persistent_study", "fault_hunt",
                 "flagship_accuracy", "beam_quality", "accuracy_benchmark", "f32_designs")


PART_SUFFIXES = ("_check", "_checks", "_timing", "_inputs", "_setup", "_steps", "_study",
                 "_studies", "_child", "_eval")


def _time_parts(parts):
    """Wraps this module's helpers whose names end in ``PART_SUFFIXES``
    (the phases' checks, timings, set-ups and children) so that ``parts``
    gathers, for each, [seconds, calls], its callees' time included: where
    a phase's time goes, in the record's ``part_seconds``."""
    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                entry = parts.setdefault(name, [0.0, 0])
                entry[0] += time.perf_counter() - t0
                entry[1] += 1
        return timed

    module = globals()
    for name, fn in list(module.items()):
        if inspect.isfunction(fn) and name.startswith("_") and name.endswith(PART_SUFFIXES):
            module[name] = wrap(name, fn)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    parser.add_argument("--parent", default=None,
                        help="persistent_study: a checkout of the previous tree, whose "
                             "rows 7, 2, 5, 3, 4, 9, 10, 11 and 6's outputs must equal this "
                             "one's bit for bit (row 8's are recorded beside)")
    parser.add_argument("--hunt_iters", type=int, default=HUNT_ITERS,
                        help="fault_hunt: iterations of its loop")
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
    from rnn_speech_tpu_torch.ops import _build

    RECORD["tree_sha256"] = _build.tree_digest([os.path.abspath(__file__)])
    print(json.dumps({"tree_sha256": RECORD["tree_sha256"]}), flush=True)
    seconds = RECORD.setdefault("phase_seconds", {})
    _time_parts(RECORD.setdefault("part_seconds", {}))

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    for name, fn in (("device", phase_device), ("build", phase_build),
                     ("kernels", phase_kernels), ("train_kernels", phase_train_kernels),
                     ("eval", phase_eval), ("train", phase_train),
                     ("train_layered", phase_train_layered), ("alt_routes", phase_alt_routes),
                     ("train_wide", phase_train_wide), ("f32_route", phase_f32_route),
                     ("f32_designs", phase_f32_designs), ("odd_shapes", phase_odd_shapes),
                     ("hw_parity", phase_hw_parity), ("grad_study", phase_grad_study),
                     ("train_loop", phase_train_loop), ("evaluate", phase_evaluate),
                     ("lean_study", phase_lean_study),
                     ("persistent_study", lambda: phase_persistent_study(args.parent)),
                     ("fault_hunt", lambda: phase_fault_hunt(args.hunt_iters))):
        if name in phases:
            timed(name, fn)
    held = None
    if "bundle" in phases or "cli" in phases:
        held = timed("bundle", phase_bundle)
    if "accuracy" in phases:
        timed("accuracy", phase_accuracy)
    if "beam" in phases:
        timed("beam", phase_beam)
    if "cli" in phases:
        timed("cli", phase_cli, *held)
    for name, fn in (("lm", phase_lm), ("stream", phase_stream), ("multi", phase_multi),
                     ("flagship_accuracy", phase_flagship_accuracy),
                     ("beam_quality", phase_beam_quality),
                     ("accuracy_benchmark", phase_accuracy_benchmark)):
        if name in phases:
            timed(name, fn)
    kl = kernels_line()
    RECORD["total_seconds"] = time.perf_counter() - t_start
    print(json.dumps({"phase_seconds": seconds, "total_seconds": RECORD["total_seconds"]}),
          flush=True)
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
