#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. the device: name, power limit, torch and nvcc versions;
2. build the port's CUDA kernels from ``transformer_transducer_tpu_torch/
   csrc`` (timed; one ``nvcc`` a source, all at once), with ptxas's
   registers and spills, and the ``HMMA`` (tensor-core) instructions of the
   flash forward and backward at Dh = 64, float32 and bf16 forms
   (``cuobjdump -sass``; none in any fails the run, and so does a spill in
   the bf16 backward or an ``HMMA`` there that is not ``m16n8k16`` bf16),
   and the SASS instructions and ``RED``/``ATOM``
   (atomic) instructions of the banded forward, of the banded
   backward's two kernels, of the additive logZ's four kernels, of each
   band sweep's two and of the lattice sweeps' instantiations (any atomic
   fails the run; the logZ's product must have ``HMMA``; a ``BAR`` in a
   one-warp lattice sweep fails it), with the lattice sweeps' registers and
   their launch plans (cells a lane, warps, diagonals a stage, shared
   bytes), and their branch-free log1p against log1pf on every float in
   [0, 1] (one that differs fails the run);
3. each kernel against its plain PyTorch version on the same CUDA inputs
   (atol 1e-4, rtol 1e-4), at the main path's shapes and a sweep around
   them: the additive logZ at (B, T, U1, V) = (4, 410, 43, 6485) and over
   T = 1, 17, 410, 513, U1 = 1, 6, 43, V = 37, 6485, B = 1, 4, 8, and past
   one block of label rows at U1 = 65, 129, and on spiked logits (a peak
   0-1000 nats above the rest on other symbols in A and L) with the count
   of cells its exact pass took, and two launches to the bit; the band sweeps at S = 2-8 with
   ragged t_len, a zero-length row and a clamped terminal slot, and at
   S = 33, 64, 128 (several slots a lane), each at its plan's chunks and
   at 1, 2 and 7, two of its launches to the bit and its graph replay
   equal to the eager call; the lattice sweeps at T = 1, 37, 410 and U1 =
   1, 2, 43, and at T = 37 around one warp's 32 lanes of 1, 2 and 4 cells
   (U1 = 31-33, 64, 65, 128, 129) and at U1 = 1024 (16 warps), two of their
   launches to the bit and their graph replays equal to the eager calls at
   U1 = 43, 129 and 1024; the flash forward and backward
   also at the tile edges T = 15-17, 31-33, 63-65, 127-129, the banded
   backward at bands (10, 2), (0, 0), (64, 64), (3, 64), (64, 0) and at
   the edges of its 32-row blocks and 48-row cell tiles T = 31-33, 47-49,
   95-97; the banded forward's row log-sum-exp against the band-masked
   logsumexp of the plain scores at bands (10, 2), (0, 0), (3, 64),
   (64, 0), (64, 64), as the flash forward's against the full one; the
   banded forward also at the streaming sessions' shape, T = 256 (the
   pinned window) with B = 1 and 16 at band (10, 2); the
   four attention kernels at head width 32 as well as 64; the flash
   kernels' bf16 forms against their plain bf16 forms on strided bf16
   views at Dh 64 and 32 and T = 1, 15-17, 31-33, 37, 63-65, 127-129, 410,
   513, the forward also at 191-193, the backward at 95-97, 191-193 and
   255-257 (``BF16_FWD_RTOL``, ``BF16_GRAD_RTOL``: the forward's output,
   lse and float32 sums, the backward's six gradients; the backward's dk
   and dv, written once by the block that owns their keys, to the bit in
   two calls);
4. the slice at full width: ``configs/joint_streaming.yaml`` (18 layers,
   d_model 512, V 6485) with seeded random weights, 8 synthetic utterances
   of 60-410 frames through the host frontend and batched greedy
   ``recognize`` — once under the streaming band (banded kernel), once
   full-context (flash kernel) — with each kernel's launch count read around
   that run; then the same through the plain versions, comparing encoder
   states (1e-3 after 18 layers) and tokens;
5. timings (medians after warm-up; CUDA events for device work, the host
   clock around synchronised calls): each kernel alone (20 launches
   captured in a CUDA graph, replayed between two events, so the wrapper's
   host time is not read; the attention forwards also at the training
   batch B = 4 with their row log-sum-exp, and two launches of the banded
   one that must agree to the bit), its plain version, its bound, the
   end-to-end ``recognize``, and that split into the encoder and the greedy
   loop, with the device's idle share from ``torch.profiler``;
6. training at full width: the same config with dropout 0, a batch of 4
   utterances (60-410 frames, 5-42 targets), 3 SGD steps (momentum 0.9,
   clip 200) with ``flash=True`` and then ``banded=True``, each with the
   launch counts read around every step (18 attention forward and 18
   backward launches, 1 alpha and 1 beta sweep), then the same steps through
   the plain versions: losses within 1e-4 and step 1's gradient norm within
   1e-3, relative;
6b. the pruned loss at full width: the same batch, ``flash=True`` with
   ``loss_pruned_range = 5`` (simple scale 0.25), 3 steps with the kernels
   (per step 1 logZ, 1 band alpha, 1 band beta, 1 alpha and 1 beta sweep,
   18 + 18 flash launches; the cells the logZ left to its exact pass), then
   3 through the plain versions at the same tolerances.  Each step's band starts are compared between the two paths;
   the plain path is handed the kernel path's starts, so a start that
   rounds the other way (an occupancy centre at .5) cannot move its loss;
6c. head width 32 end to end: ``artifacts/tone_small/config.yaml`` (2
   encoder layers, 2 heads x 32) with seeded random weights, 3 ``--flash``
   and 3 ``--banded`` steps and a ``recognize`` under the band and at full
   context, through the kernels and then the plain versions, at the
   tolerances of phases 6 and 4;
7. the training entry point: ``apps/train.py --flash`` on a synthetic corpus
   (16 train, 8 dev utterances, a 6485-symbol vocabulary) for one epoch,
   then ``-mode continue`` for a second: two checkpoints, decode dumps and a
   finite CER; ``apps/predict.py --full-context`` on the ``epoch_1``
   directory it wrote, whose text must be the trained model's greedy
   decode; then ``--flash --pruned-range 5`` for one epoch;
8. training timings: the training kernels (alone, under a CUDA graph)
   against their plain versions and bounds (the lattice sweeps also against
   their chain bound: D - 1 dependent log-add steps, one step timed alone in
   one thread, ``ttx_rnnt_lae_chain``; the band sweeps against the same
   step times the dependent steps of their chains; the logZ, its four launches in
   one graph, also against ``torch.logsumexp`` over the whole sum, with
   each launch's share and its cells through the exact pass, and the exact
   form's bound beside its own; the flash kernels, on the tensor
   cores, also against their 3xTF32 bounds, with the count of ``HMMA``
   instructions in their SASS from phase 2; the banded backward with its
   registers and atomics from phase 2, and two launches that must agree to
   the bit), and the flagship train step (config dropout 0.5) for
   ``--flash`` with the full and the pruned loss (first in turns),
   ``--banded`` and dense attention, end to end and split into phases (encoder forward, loss
   forward, backward, optimizer; for the pruned loss the simple stage,
   bounds, banded joint and band DP in place of the loss forward), with the
   device's idle share and peak memory;
9. streaming at full width: the same config and weights with phase 4's
   blank bias, two synthetic waves (410 frames, 12.27 s, and 60 frames) fed
   100 ms a call and, again, whole in one call, each then finalized,
   through a window session (windows padded to 256 rows, the ready ones
   encoded together by ``encode_banded``: 18 banded launches a group, read
   from the counters; the long wave whole in one call must take fewer
   groups than windows), a trapezoid session (one window a group) and an
   incremental session (no kernel: its 18 layers a chunk are plain tensor
   code), then the same through the plain versions; tokens identical, or
   the first frame decided differently a tie (top-2 logit gap <= 1e-3,
   replayed from the encoder rows each session decoded there under the
   label state both share), the incremental stream equal to the window
   stream and the window session's whole-file stream equal to its 100 ms
   one likewise, at most one host read an emission plus one a window, and
   ``chunked_encode`` within 1e-3 of one ``encode_banded`` over the
   sequence padded to 512; then, on the long wave, the latency of
   each ``accept_waveform`` that decoded (host clock, median and p90), the
   whole file in one call (median of 5, warm) as a real-time factor with
   the device's idle share (``torch.profiler``), host reads a window, and
   the banded forward alone under a CUDA graph at (1, 256) and (16, 256)
   with its bound; a JSON line of these before the kernels' line;
10. multi-stream serving at full width: the same weights and blank bias;
   the main path is the serve CLI (``apps/serve.py --json``) on 4 synthetic
   waves of 1.8-12.3 s, with the counts from 0: 18 kernel-6 launches an
   encoder call, its tokens those of a ``BatchedStreamingSession`` drained
   over the same waves, which must equal the solo window sessions'; the
   incremental rounds equal to the window rounds, round by round equal to
   the drain (each round reading the card at most 1 + the most emissions
   of one stream in it), ``serve_files`` with 5 utterances through 2 slots
   in both modes equal to solo sessions, and the plain versions' drain
   equal to the kernel's (tokens identical, or the first frame decided
   differently a tie, replayed from the recorded encoder rows as in phase
   9); kernel 6 against its plain version at (8, 256) and (128, 256), two
   launches to the bit, and alone under a CUDA graph with its bound; then
   timings: 8 live streams fed one audio step (15,519 samples) a round,
   one ``process()`` a round, 30 rounds after 3 of warm-up (round latency
   p50/p95/p99, both modes), a drain of 8 x 30 s (best of 2: x real time,
   the idle share, and the host time split into features, encoder and
   decoder), and continuous against gang batching of 2 groups of one 30 s
   and seven 8 s utterances through 8 slots (x real time, utterances a
   second, the share of slot-rounds with a window, ``slot_utilization``);
   a JSON line of these before the kernels' line;
11. what the JAX package trained, at full width: (a) phase 4's weights
   and blank bias written as a JAX checkpoint directory (flax's msgpack,
   from this script's own writer, one LayerNorm scale as a bfloat16 leaf),
   which ``load_family`` must read as phase 4's weights; ``apps/predict.py
   --checkpoint <that dir>`` on two of phase 4's waves (410 and 60 frames),
   under the band and with ``--full-context``: the text of phase 4's
   models on the same wave alone, 18 launches of kernel 6 or of kernel 8 a
   call and nothing else, and on the 410-frame wave phase 4's batch tokens
   (or a tie); then ``apps/train.py --flash -mode continue`` from a
   JAX-format ``epoch_0`` holding an SGD momentum trace (count 4): epoch 1,
   step 8, optimizer count 8, a finite CER; (b) the on-device log-mel
   (``ops/features.py::extract_batch_padded``) of phase 4's 8 waves,
   int16 and float32, against the host ``features_np`` pipeline (rtol =
   atol = 2e-3, ``t_len`` exact), timed with CUDA events beside the host
   pipeline's time; (c) 3 ``--flash`` steps at B 4, dropout 0, on raw
   waves featurized in the step against the same steps on host features
   (losses within 2e-3, relative; 18 + 18 flash and 1 + 1 lattice launches a
   step), then one epoch of ``apps/train.py --flash --augment --set
   data.on_device_features=true``: a checkpoint and a finite CER; a JSON
   line of these before the kernels' line, whose launches count this
   phase's main paths too (``phase11_launches``);
12. the beam search and int8 serving at full width, on phase 4's batch,
   weights and blank bias: (a) ``recognize_beam`` (width 5) under the band
   and at full context with the counts from 0 (18 launches of kernel 6 or
   8 a call, nothing else), against the plain versions and against the
   recomputed label encoder (tokens identical, or the first iteration the
   two searches decide differently a near-tie, smallest score gap <=
   1e-3, replayed through the search's ``observe``), with its iterations
   and host reads; ``apps/predict.py --beam`` on the 410- and 60-frame
   waves, band and full context, whose text must be ``beam_search`` at B 1
   on the same encoder rows; (b) the int8 product (``torch._int_mm``,
   padded) exact against numpy's int64 product at M 1-40, K 512 and 2048,
   N 6485; ``QuantLinear`` on the card against the CPU; ``to_quant`` of
   phase 4's models, int8 ``recognize`` (18 launches) against the int8
   model through the plain versions: each encoder layer from the same
   input, kernel against plain, within a mean |error| of 1e-3 (the gate),
   and the tokens replayed on both paths' encoder rows (the replay must
   give the plain tokens; each first divergence's top-2 gap and the gaps'
   percentiles over all decoded frames are logged, not gated: see
   ``INT8_LAYER_MEAN_TOL``), and against the float tokens (share and CER,
   not gated); ``recognize_beam``, greedy and int8 greedy ``recognize``
   timed under the band, median of 5 in turns (the main paths' calls the
   warm-ups); ``apps/serve.py --int8`` on phase 10's 4 waves against the
   int8 batched session (identical) and the int8 window sessions through
   the plain versions (logged); phase 11's JAX-format checkpoint through
   the port's ``tools/quantize_checkpoint.py`` on the card, read back by
   ``load_family`` to the bit of ``to_quant`` in memory, with both sizes;
   ``apps/predict.py --int8`` on it; a JSON line of these before the
   kernels' line (``phase12_launches``).

13. the espnet family at full width: ``configs/espnet_aishell.yaml`` (8
   encoder blocks, d 512, 8 heads x 64, no input layer; 2 text blocks; V
   4233, joint 512 tanh; bands 10/2 and 2/0) with seeded random weights and
   phase 4's blank bias rule, on phase 4's batch: greedy ``recognize``
   cached and uncached, ``recognize_beam`` and int8 ``recognize`` (W8A8:
   each encoder layer from the same input within a mean |error| of 1e-3 of
   the CPU's, the tokens logged beside the float ones), against the same model on
   the CPU (encoder states within 1e-3, tokens identical or the first
   difference a tie replayed on each side's own model); a JAX-format
   checkpoint of the weights read by ``load_family`` to the bit and served
   by ``apps/predict.py`` with and without ``--beam`` on the 410- and
   60-frame waves (the model's own decode); ``apps/serve.py`` with 4
   streams on phase 10's waves (the batched session's tokens, each stream
   against a solo window session); the window, trapezoid and incremental
   sessions on phase 9's waves, 100 ms a call and whole (window and
   trapezoid against the CPU's, incremental against window); no kernel
   launches on any of these paths (the counts are read around each).
   Then training: phase 6's batch (labels 1 .. V - 2), dropout 0, 3 SGD
   steps with the full loss and 3 with the pruned loss (S 5), 1 alpha and
   1 beta launch a step, plus 1 logZ, 1 band alpha and 1 band beta pruned,
   against the plain versions (losses within 1e-4, step 1's gradient norm
   within 1e-3, relative); ``apps/train_esptt.py`` on a synthetic corpus
   for one epoch, ``-mode continue`` for a second, and ``apps/predict.py``
   on its ``epoch_1``; medians of 5 of greedy, beam and int8
   ``recognize``, a whole-file window stream and a full-loss and a pruned
   train step; a JSON line of these before the kernels' line, whose
   launches of kernels 1-5 count the phase's training paths too
   (``phase13_launches``).

14. ``--remat`` and ``--bf16`` training at flagship width on phase 6's
   batch and weights (``check_bf16_remat``).  Remat in float32: 3 banded
   steps at the config's dropout (0.5), with and without remat from the
   same state and generators, losses and raw gradient norms equal to the
   bit; the flash model's first step at that dropout and 3 flash steps at
   dropout 0 within the atomics tolerance (losses 1e-4, step 1's gradient
   norm 1e-3); the forward kernel 36 times a step, the backward 18; step
   time, device busy time and peak memory with and without, in turns.
   bf16: 3 steps each of the dense, banded, ``--banded --pruned-range 5``
   and espnet (full loss) models at dropout 0, the kernels against the
   plain versions, both bf16 (step 1 within ``BF16_LOSS_RTOL`` and
   ``BF16_NORM_RTOL`` and under the bf16-to-float32 distances of the same
   step, which 3 float32 steps print beside each step; steps 2-3 printed,
   not held: the clipped update makes them chaotic), the launches
   of kernels 1, 2, 6, 7 (3-5 pruned); the same for 3 ``--bf16 --flash``
   steps, 18 + 18 launches a step of the bf16 forms of kernels 8 and 9 and
   none of their float32 forms, and one ``--bf16 --remat --flash`` step
   (36 + 18); step time, device busy time and peak memory against the
   float32 step in turns.  Then ``apps/train.py --bf16 --remat --flash
   --nan-guard --steps-per-call 8`` for 2 epochs on the port's tone
   corpus (``tools/tone_demo.py``, 128 / 16 utterances, the small
   geometry, Dh 32), float32 checkpoints, and ``apps/predict.py`` on its
   ``epoch_1`` (kernel 6, twice); the bf16 forms alone under a CUDA graph
   with their bounds at the bf16 and TF32 rates and bf16 SDPA as
   yardstick (the backward also as its three kernels alone, without the
   wrapper's allocations, and its main kernel alone), with registers,
   ``HMMA``, shared bytes and blocks an SM; a JSON line before the kernels'
   line, whose launches count the phase's main paths
   (``phase14_launches``).
15. the host-side remainder (``check_host_remainder``): (a) the native
   runtime (``runtime/native.py``) built with g++ into an empty directory,
   its compiler, seconds and ``os.cpu_count()``; (b) ``ttx_logmel`` on
   phase 4's 8 waves, both variants, against the numpy path (rtol and atol
   2e-4), and the batch's host ms, numpy against native, median of 5, in
   one thread and in the loader's 8; (c) the native batch CER against
   numpy on 1,000 seeded pairs and on phase 4's decodes, equal; (d)
   ``apps/train.py --flash --profile DIR`` for 2 epochs of phase 7's
   corpus with ``TTX_NATIVE_FEATURES=1``, in a process of its own
   (``profiled_training``): the trace parses, its kernel
   events hold ``flash_fwd_tc``, ``flash_bwd_tc`` and both lattice sweeps
   (``wavefront``) exactly as often as their counters rose in the
   profiled epoch, the native log-mel (loader) and CER (evaluation)
   counts rose, the profiled epoch's seconds beside the unprofiled one's;
   (e) ``tools/average_checkpoints.py --nbest 2`` over the two epochs,
   every leaf the float64 mean rounded to float32, and ``apps/predict.py
   --checkpoint <average> --full-context`` giving the text of ``recognize``
   with the averaged weights; (f) a reference-layout ``.chkpt`` of phase
   4's weights through ``tools/convert_checkpoint.py``, served with phase
   4's tokens under the band and at full context.  A JSON line before the
   kernels' line, whose launches count the phase's main paths
   (``phase15_launches``).
16. export and data parallelism (``check_export_dp``): (a) the flagship
   (``flash=True``, full width and depth) through ``runtime/export.py``
   on the card, its seconds and each ``.pt2`` file's MiB; a fresh process
   loads the four programs (``run_exported``) and runs them on phase 4's
   first utterance (410 frames), random tokens and random states: the
   encoder's graph holds 18 ``ttx::flash_rel_attention_fwd`` nodes and a
   call launches the flash forward 18 times and nothing else, the other
   three launch nothing, and each output equals the live model's within
   rtol = atol = 1e-5; the exported encoder, loaded here, timed in turns
   with the live one (CUDA events), with each one's device busy time;
   (b) two ranks on the one card through gloo (``dp_rank``):
   3 ``--n_data 2 --zero --flash`` steps on their halves of phase 8's
   batch at dropout 0 with no SpecAugment, each step's launches from 0
   (18 + 18 flash, 1 + 1 lattice), the losses within 1e-4 and step 1's
   gradient norm within 1e-3 (relative) of one process on the whole
   batch, each rank's moment bytes at most 51 % of one process's, its
   peak memory beside plain dp's (the same 3 steps without ``--zero``
   first, their losses within the same bar), and the same plain dp steps
   with ``--banded`` (18 + 18 banded launches), held to one process's
   banded steps; then, the group left, ``apps/train.py --flash --n_data 2
   --zero`` for one epoch of phase 7's corpus over the two ranks, each
   joining a group from the environment itself (gloo: two local ranks on
   one card): 4 steps, a checkpoint with whole moments, one evaluation
   line;
   (c) a world-1 NCCL group (a ``FileStore``): 3 banded steps equal to the
   bit to the same steps with no group;
   (d) the split yardstick (``split_yardstick``, in rank 0's process with
   no group): step 1's gradients as the mean ``(g0 + g1) / 2`` in float32
   of one process's gradients on each rank's two rows, and on all four;
   banded dp against it equal to the bit (every leaf, the loss and the
   norm), flash dp within 1e-4 (loss) and 1e-3 (norm); leaf by leaf
   against both, the leaves equal to the bit and the largest relative
   error with its leaf, printed.  A JSON line before the kernels' line,
   whose launches count the phase's main paths (``phase16_launches``);
17. tensor parallelism at flagship width (``--n_model 2``: 18 layers,
   d_model 512, 8 heads, so 4 a rank), phase 8's B 4 batch, dropout 0,
   SGD 0.9, clip 200, SpecAugment and dropout seeded as in phase 6:
   (a) two ranks on the one card through gloo (``tp_rank``), 3 steps each
   of ``--flash`` (kernels 8/9), ``--banded`` (6/7), ``--flash
   --pruned-range 5`` (3-5 too), ``--bf16 --flash`` (8b/9b) and (c) the
   espnet family (``configs/espnet_aishell.yaml``), each held to one
   process on the same weights and batch (losses within 1e-4, step 1's
   gradient norm within 1e-3, relative; under bf16 step 1 alone, as in
   phase 14, steps 2-3 printed), each rank's launches a step
   equal to one process's; each step's ms a rank, the share of it that the
   logits' sums over the model group take (timed between
   synchronisations), the parameter and SGD-trace bytes a rank against one
   process's, the peak memory a rank above its baseline
   (``max_memory_allocated``) against one process's;
   (d) then, the group left, ``apps/train.py --flash --n_model 2`` for one
   epoch of phase 7's corpus over the two ranks (gloo from the
   environment): 4 steps, one evaluation line, an ``epoch_0`` that holds
   the whole model, which one-process ``apps/predict.py --full-context``
   serves (its text is ``recognize``'s with those weights);
   (b) dp2 x tp2 on four ranks with ``--zero``: 3 flash steps on their
   halves of the batch within the training bars of one process, each
   rank's launches one process's, moment bytes (at most 30 % of one
   process's trace) and peak memory a rank.  A JSON line before the
   kernels' line (``phase17_launches``);
18. pipeline parallelism at flagship width (``--n_pipe 2``: 9 of the 18
   layers a stage), phase 8's B 4 batch, dropout 0, SGD 0.9, clip 200,
   SpecAugment and dropout seeded as in phase 6:
   (a) two ranks on the one card through gloo (``pp_rank``), ``--pipe-micro
   4`` (B 1 microbatches, a bubble of 1/5), 3 steps each of ``--flash``,
   ``--banded``, ``--flash --pruned-range 5``, ``--bf16 --flash`` and the
   espnet family (8 blocks, 4 a stage), each held to phase 17's one
   process on the same weights, batch and seeds (losses within 1e-4, step
   1's gradient norm within 1e-3; under bf16 step 1 alone) and printed
   beside one process running the same microbatches through the encoder
   one by one (``make_pipelined_train_step`` on one stage), to which
   banded step 1's loss is equal to the bit; each stage's launches a step
   (9 layers x 4 microbatches of each attention kernel forward and
   backward, the loss kernels on the last stage alone); every hop's bytes
   on arrival equal to the bit to what its neighbour sent (SHA-256 of
   each); each step's ms a rank, the hops' ms (timed between
   synchronisations) and bytes, the parameter bytes a rank against one
   process's, the peak memory a rank above its baseline;
   (c) then, the group left, ``apps/train.py --flash --n_pipe 2`` for one
   epoch of phase 7's corpus over the two ranks (gloo from the
   environment): 4 steps, one evaluation line, an ``epoch_0`` that holds
   the whole model, which one-process ``apps/predict.py --full-context``
   serves (its text is ``recognize``'s with those weights);
   (b) dp2 x pp2 on four ranks with ``--zero --pipe-micro 2``: 3 flash
   steps within the training bars of one process, each stage's launches
   (9 x 2 a kernel), every hop equal to the bit, moment bytes (at most
   35 % of one process's trace) and peak memory a rank.  A JSON line
   before the kernels' line (``phase18_launches``).

Each phase logs the seconds since the run began.

Kernel checks in phase 3: each forward against its plain version (atol
1e-4, rtol 1e-4); the attention backward against autograd through the
plain version (atol 1e-4 * max|ref| + 1e-5, rtol 1e-4: the flash
backward's shared sums are fp32 atomics in a varying order, and where a
gradient is 0 in exact
arithmetic, as every softmax gradient at T = 1, only rounding is left); the
lattice and band sweeps against the eager scans (rtol 1e-5, atol 1e-3:
log-alphas reach thousands; the band sweeps, whose chunks reassociate the
log-sums, against their eager scans run in float64, compared with both
sides clamped at NEG, where the cells no path reaches sit, and both sides
must put the same cells at or below NEG / 2).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import os
import re
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "transformer_transducer_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM
# bytes/s, float32 FLOP/s outside the tensor cores, dense TF32 tensor-core
# FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# exponentials per SM per clock of the special function units (Hopper)
SFU_PER_SM_PER_CLOCK = 16

B, H, DH = 8, 8, 64
T_MAIN, BAND = 410, (10, 2)
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
ENC_TOL = 1e-3
GAP_TOL = 1e-3
# W8A8 turns the kernels' float32 rounding into whole int8 steps: an
# activation that moves across a rounding boundary moves its projection by
# about 1 %, and after 18 layers the int8 encoder states of the kernel and
# plain paths differ by up to about 0.1, their logits by 3-5e-2 where they
# first decide differently (an H100): as much as the median top-2 gap of
# the frames the int8 plain path decodes on random weights (4.8e-2 under
# the band, 5.4e-2 at full context).  No tie limit parts a tie from a
# typical frame there, so the int8 kernel-vs-plain tokens are a logged
# reading (each first divergence's gap beside GAP_TOL, and the gaps'
# percentiles), and the gate on the kernels under int8 is the layer check:
# one int8 layer given the same input through the kernel and the plain
# version: where the attention outputs' rounding moves an activation across
# a rounding boundary its row moves by whole steps (up to about 3e-2), but
# 0.5-4 % of the values move by more than 1e-3 and the mean stays at
# 2e-5-2e-4 (a wrong kernel moves every row)
INT8_LAYER_MEAN_TOL = 1e-3
LATTICE_TOL = dict(rtol=1e-5, atol=1e-3)
GRAD_TOL = 1e-4          # atol GRAD_TOL * max|ref| + GRAD_FLOOR, rtol GRAD_TOL
GRAD_FLOOR = 1e-5        # for gradients that are 0 in exact arithmetic (T = 1)
B_TRAIN = 4              # configs/joint_streaming.yaml data.batch_size
LOSS_RTOL, NORM_RTOL = 1e-4, 1e-3
# --bf16 step 1, kernels against the plain versions (both bf16): the
# kernels' float32 outputs may move a bf16 rounding downstream (measured on
# an H100 80GB HBM3 at 700 W, two runs: losses up to 1.2e-05, gradient
# norms up to 1.3e-04; bf16 against float32 at step 1: losses 8.8e-05 to
# 9.0e-04, norms 2.1e-04 to 4.0e-03).  Steps 2-3 are printed, not held: the
# first clipped SGD step (raw gradient norm near 5e8) turns those
# differences into others as large as bf16's own (--banded step 3: loss
# 2.8e-03 and norm 1.4e-02 apart, bf16 against float32 6.7e-03 and 3.6e-02)
BF16_LOSS_RTOL, BF16_NORM_RTOL = 1e-4, 1e-3
# the flash kernels' bf16 forms against their plain bf16 forms (the bf16
# forward's and backward's roundings, ops/cuda/flash_rel_attention.py): the
# forward's output, lse and float32 sums within BF16_FWD_RTOL of their
# largest magnitudes, the output also plus one bf16 step of the row's
# largest P times max|v| (a float32 P within a few ulps of a bf16 rounding
# boundary may round the other way in another summation order); each
# gradient within BF16_GRAD_RTOL of its leaf's largest magnitude, or one
# bf16 step of the element (the final cast), plus one rounding of a dS or P
# inside the sums (bf16_grad_allowance) and GRAD_FLOOR; the output
# and the gradients of 10,000 elements or more also nearer the plain bf16
# form than a quarter of its distance from float32 on the same bf16 values
BF16_FWD_RTOL, BF16_GRAD_RTOL = 2e-4, 2e-3
S_RANGE = 5              # the pruned loss's band (--pruned-range 5)
STREAM_T = 256           # the streaming window_len at the flagship's band
STREAM_CHUNK = 1600      # 100 ms of 16 kHz audio an accept_waveform call


def log(*args):
    print(*args, flush=True)


def require(ok: bool, what) -> None:
    """A check of the run that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def cuda_ms(fn, samples: int = 20, reps: int = 10) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, timed with CUDA events after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, samples: int = 10) -> float:
    """A kernel alone: ``launches`` back-to-back calls of its wrapper
    captured in one CUDA graph, replayed ``samples`` times between two CUDA
    events after a warm-up; the median per launch.  The wrapper's host time
    is spent at capture, so it does not read as the kernel's."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def host_ms(fns: dict, samples: int = 10, warm_up: bool = True) -> dict:
    """Wall times (ms) of calls that end in a synchronise, after a warm-up
    (``warm_up=False`` where each function has just run): ``samples``
    rounds in which every function runs once, in an order that reverses
    each round, so drift on a shared host falls on all alike."""
    import torch
    if warm_up:
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for r in range(samples):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            start = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - start) * 1e3)
    return times


def spread(ms: list) -> str:
    """Median and quartiles of host-clock samples."""
    q1, _, q3 = statistics.quantiles(ms, n=4)
    return f"{statistics.median(ms):.2f} ms [quartiles {q1:.2f}, {q3:.2f}]"


def split_ms(encode, decode, samples: int = 10):
    """Median host ms of the encoder and of the greedy loop, each phase of
    the same call timed between synchronises."""
    import torch
    enc_ms, dec_ms = [], []
    for r in range(samples + 1):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.no_grad():
            enc = encode()
        torch.cuda.synchronize()
        mid = time.perf_counter()
        decode(enc)
        torch.cuda.synchronize()
        if r:                                   # round 0 warms up
            enc_ms.append((mid - start) * 1e3)
            dec_ms.append((time.perf_counter() - mid) * 1e3)
    return statistics.median(enc_ms), statistics.median(dec_ms)


def attention_inputs(tlen, k_len, gen, b=B, dh=DH):
    """q, k, v as strided views of one fused projection (as the model hands
    them over), and tables of ``k_len`` rows sliced/front-padded to T."""
    import torch
    from transformer_transducer_tpu_torch.models.attention import slice_pos_table
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    q, k, v = mk(b, tlen, 3, H, dh).unbind(2)
    re = slice_pos_table(mk(k_len, H, dh), tlen)
    rb = slice_pos_table(mk(k_len, H), tlen)
    return q, k, v, re, mk(H, dh), rb


def band_cells(tlen, left, right):
    """(i, j) cells inside the band and the sequence, per (b, h)."""
    return sum(min(tlen - 1, i + right) - max(0, i - left) + 1
               for i in range(tlen))


def device_busy_ms(fn):
    """Summed duration of the device activities (kernels, copies) of one
    call of ``fn``, which the caller has warmed up, from ``torch.profiler``;
    0.0 when the profiler sees no device.  It sums the profiler's raw
    events: building its Python event tree costs some 80 us an event, tens
    of seconds for a call of thousands of eager operators."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6


def device_top(fn, n: int = 6, calls: int = 1, unit: str = "ms") -> str:
    """The ``n`` operators and kernels with the most device time per call of
    ``fn`` over ``calls`` calls (``torch.profiler``, self device time), as
    "name time" pairs in ``unit`` ("ms" or "us")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), reverse=True,
                  key=lambda e: getattr(e, "self_device_time_total", 0))[:n]
    name = lambda key: re.sub(r"\(.*", "", key.replace("(anonymous namespace)::", ""))
    per = {"ms": 1e3, "us": 1.0}[unit] * calls
    return ", ".join(f"{name(e.key)[:48]} {getattr(e, 'self_device_time_total', 0) / per:.2f} "
                     f"{unit}" for e in rows)


def roofline(n_bytes, n_ops):
    """(least ms, "bytes" or "operations") at the card's published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bound(tlen, cells, b=B):
    """Least time for the work: each input read once, the output written
    once; 2*Dh FLOP each for AC, BD and AV per live cell."""
    elems = 4 * b * tlen * H * DH + tlen * H * DH + H * DH + tlen * H
    return roofline(4 * elems, b * H * cells * 6 * DH)


def backward_bound(b, tlen, cells):
    """Least time for the attention backward: q, k, v, dO and the tables
    read once, dq, dk, dv and the table gradients written once; about 16*Dh
    FLOP per live cell (scores again, dp, dv, dk, dq from AC and BD, and the
    table gradient).  O and the row lse are not counted: the function does
    not need them (the Pallas kernels recompute the probabilities)."""
    elems = 7 * b * tlen * H * DH + 2 * (tlen * H * DH + H * DH + tlen * H)
    return roofline(4 * elems, b * H * cells * 16 * DH)


def backward_io_ms(b, tlen):
    """The bytes the CUDA attention backwards move as built over the memory
    rate, in ms: ``backward_bound``'s bytes and O and the row lse, which
    they read for D_i = dO_i . O_i."""
    elems = 8 * b * tlen * H * DH + b * H * tlen + 2 * (tlen * H * DH + H * DH + tlen * H)
    return 4 * elems / HBM_BYTES_PER_S * 1e3


def backward_bound_tc(b, tlen, cells):
    """The same FLOP as ``backward_bound`` done fp32-accurate as 3xTF32 (three
    TF32 tensor-core products per product) at the dense TF32 peak, in ms."""
    return 3 * b * H * cells * 16 * DH / TF32_FLOP_PER_S * 1e3


def bound_tc(cells):
    """The forward's FLOP (``bound``: 6*Dh per live cell) as 3xTF32 at the
    dense TF32 peak, in ms."""
    return 3 * B * H * cells * 6 * DH / TF32_FLOP_PER_S * 1e3


def ptxas_entries(text: str, symbol: str):
    """(registers, spill store bytes, spill load bytes) of each kernel whose
    mangled name holds ``symbol``, from ptxas's ``-v`` report."""
    out, current, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current and symbol in current:
            out.append((int(m.group(1)), *spills))
            current = None
    return out


@functools.lru_cache(maxsize=None)
def sass_by_function(lib_path, full: bool = False) -> dict:
    """The static count of each opcode in each kernel's SASS (``cuobjdump
    -sass`` on the built library, run once; a predicate guard is skipped),
    keyed by the kernel's ``Function :`` line; with ``full`` each opcode
    with its modifiers (``HMMA.16816.F32.BF16``)."""
    from transformer_transducer_tpu_torch.ops.cuda import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, count = {}, None
    op_re = re.compile(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)([.\w]*)")
    for line in sass.splitlines():
        if "Function :" in line:
            count = out.setdefault(line, collections.Counter())
        elif count is not None:
            op = op_re.match(line)
            if op:
                count[op.group(1) + (op.group(2) if full else "")] += 1
    return out


def sass_opcodes(lib_path, symbol: str, full: bool = False) -> collections.Counter:
    """The static count of each opcode (with ``full``, with its modifiers)
    in the SASS of the kernels whose mangled names hold a match of the
    pattern ``symbol``."""
    total = collections.Counter()
    for line, count in sass_by_function(lib_path, full).items():
        if re.search(symbol, line):
            total += count
    return total


def lattice_bound(b, d_total, u1, n_grids):
    """Least time for a lattice sweep: ``n_grids`` (B, D, U1) fp32 arrays
    read or written once; about 10 operations per cell (two adds and the
    log-add-exp), far below the bytes."""
    return roofline(4 * n_grids * b * d_total * u1, 10 * b * d_total * u1)


def logz_bound(b, tlen, u1, v):
    """Least time for the additive logZ in its product form: A, L read and
    logZ written once, against the product's 2 B T U1 V FLOP as 3xTF32 (three
    TF32 products a product) at the dense TF32 peak and its B (T + U1) V
    exponentials at the special function units' rate.  Beside it the exact
    form's bound, its B T U1 V exponentials, and the bytes the kernel moves
    as built over the memory rate.  All in ms, with "by" and the kernel's
    slices of V ("n_split")."""
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    exp_rate = SFU_PER_SM_PER_CLOCK * n_sm * sm_clock_hz()
    out = {"bytes": 4 * (b * tlen * v + b * u1 * v + b * tlen * u1) / HBM_BYTES_PER_S,
           "tf32": 3 * 2 * b * tlen * u1 * v / TF32_FLOP_PER_S,
           "exp": b * (tlen + u1) * v / exp_rate,
           "exact_form": b * tlen * u1 * v / exp_rate}
    # the bytes the four launches move as built: A twice (row maxima, product),
    # L once, the split q written and read, the slices' partial sums written
    # and read, logZ written
    from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import plan
    n_split = plan(0, b, tlen, u1, v)[1]
    vq = -(-v // 32) * 32
    cells = b * tlen * u1
    out["as_built"] = 4 * (2 * b * tlen * v + b * u1 * v + 4 * b * u1 * vq
                           + 2 * n_split * cells + cells) / HBM_BYTES_PER_S
    out = {k: x * 1e3 for k, x in out.items()}
    ops = max(out["tf32"], out["exp"])
    out.update(by="operations" if ops > out["bytes"] else "bytes",
               ms=max(ops, out["bytes"]), n_split=n_split)
    return out


def band_bound(b, tlen, s_range, n_arrays):
    """Least time for a band sweep: ``n_arrays`` (B, T, S) fp32 arrays and
    the (B, T) shifts read or written once; about 10 operations per cell
    and slot of the label chain, far below the bytes."""
    return roofline(4 * (n_arrays * b * tlen * s_range + b * tlen),
                    10 * b * tlen * s_range * s_range)


def band_inputs(gen, b, tlen, s_range):
    """The band sweeps' inputs as the pruned loss builds them: log-probs,
    label cells past a random u_len at NEG, monotone band starts (steps in
    [0, S)); ragged t_len with a zero-length row (when B > 1); and one row
    whose u_len the corridor cannot reach, so its terminal slot clamps at
    S - 1.  Returns (lp_b, lp_l, d_alpha, d_beta, tf, sf)."""
    import torch
    from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
    rand = lambda: torch.log(torch.rand(b, tlen, s_range, generator=gen,
                                        device="cuda") * 0.95 + 0.05)
    lp_b, lp_l = rand(), rand()
    steps = torch.randint(0, s_range, (b, tlen), generator=gen, device="cuda")
    steps[:, 0] = 0
    rs = torch.cumsum(steps, dim=1)
    u_len = rs[:, -1] + torch.randint(0, s_range, (b,), generator=gen, device="cuda")
    t_len = torch.randint(1, tlen + 1, (b,), generator=gen, device="cuda")
    t_len[0] = tlen
    if b > 1:
        t_len[1] = 0
    if b > 2:
        u_len[2] += 3 * s_range
    uidx = rs[:, :, None] + torch.arange(s_range, device="cuda")
    lp_l = torch.where(uidx < u_len[:, None, None], lp_l, torch.full_like(lp_l, -1e30))
    _, tf, sf = rp._band_terminal(lp_b, rs, t_len, u_len)
    d = rs[:, 1:] - rs[:, :-1]
    pad = torch.nn.functional.pad
    return lp_b, lp_l, pad(d, (1, 0)), pad(d, (0, 1)), tf, sf


def spiked_logits(gen, b, tlen, u1, v, margin):
    """randn * 3 logits (B, T, V) and (B, U1, V) with a peak ``margin`` nats
    above the row maximum on symbol 3 in about half the rows of A and on
    symbol 7 in about half those of L; and the cells whose rows both peak
    (on different symbols: the logZ's product form underflows there)."""
    import torch
    a = torch.randn(b, tlen, v, generator=gen, device="cuda") * 3
    l = torch.randn(b, u1, v, generator=gen, device="cuda") * 3
    sa = torch.rand(b, tlen, generator=gen, device="cuda") < 0.5
    sl = torch.rand(b, u1, generator=gen, device="cuda") < 0.5
    sa[0, 0] = sl[0, 0] = True
    a[..., 3] = torch.where(sa, a.amax(-1) + margin, a[..., 3])
    l[..., 7] = torch.where(sl, l.amax(-1) + margin, l[..., 7])
    return a, l, sa[:, :, None] & sl[:, None, :]


def check_pruned_kernels(gen):
    """Phase 3, the pruned loss's kernels: the additive logZ against its
    plain version (atol 1e-4, rtol 1e-4) at the flagship shape and a sweep
    (U1 to 129), on spiked logits (with the cells its exact pass took) and
    two launches to the bit, the band sweeps against theirs in float64 (rtol
    1e-5, atol 1e-3) at S = 2-8 and 33, 64, 128 (with both sides clamped at
    NEG and the same cells at or below NEG / 2, at the plan's chunks and at
    1, 2 and 7; two launches of each to the bit and its graph replay equal
    to the eager call); returns the largest abs error of each."""
    import torch
    from transformer_transducer_tpu_torch.ops.cuda import band_kernel as bk
    from transformer_transducer_tpu_torch.ops.cuda.band_kernel import (
        band_alpha, band_alpha_plain, band_alpha_plan, band_beta, band_beta_plain)
    from transformer_transducer_tpu_torch.ops.cuda import logz_kernel as lk
    from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import (
        additive_logz, additive_logz_plain)
    errs = {"logz": 0.0, "band_alpha": 0.0, "band_beta": 0.0}
    log("additive logZ vs plain (atol 1e-4, rtol 1e-4):")
    shapes = [(B_TRAIN, T_MAIN, 43, 6485)]
    for i, (tlen, u1, v) in enumerate((tlen, u1, v) for tlen in (1, 17, 410, 513)
                                      for u1 in (1, 6, 43) for v in (37, 6485)):
        shapes.append(((1, 4, 8)[i % 3], tlen, u1, v))
    # past one block of 64 label rows
    shapes += [(2, 37, 65, 6485), (B_TRAIN, T_MAIN, 65, 6485), (2, 17, 129, 300)]
    worst = []
    for b, tlen, u1, v in shapes:
        a = torch.randn(b, tlen, v, generator=gen, device="cuda") * 3
        l = torch.randn(b, u1, v, generator=gen, device="cuda") * 3
        with torch.no_grad():
            got, ref = additive_logz(a, l), additive_logz_plain(a, l)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, **KERNEL_TOL,
                                   msg=f"logZ B={b} T={tlen} U1={u1} V={v}")
        errs["logz"] = max(errs["logz"], err)
        worst.append((err, (b, tlen, u1, v)))
    log(f"  flagship (4, 410, 43, 6485): max|err| {worst[0][0]:.3e}; "
        f"{len(shapes)} shapes, worst {max(worst)[0]:.3e} at (B, T, U1, V) = "
        f"{max(worst)[1]}")
    log("additive logZ on spiked logits (a peak margin nats above the row's "
        "maximum on symbol 3 in about half the rows of A, on symbol 7 in half "
        "those of L), cells left to the exact pass:")
    for b, tlen, u1, v in ((B_TRAIN, T_MAIN, 43, 6485), (2, 70, 65, 37), (2, 19, 6, 131)):
        line = []
        for margin in (0, 30, 55, 62, 100, 1000):
            a, l, both = spiked_logits(gen, b, tlen, u1, v, margin)
            with torch.no_grad():
                got = additive_logz(a, l)
                marked = lk.marked_cells()
                ref = additive_logz_plain(a, l)
            torch.testing.assert_close(got, ref, **KERNEL_TOL,
                                       msg=f"spiked logZ {margin} nats B={b} T={tlen} "
                                           f"U1={u1} V={v}")
            errs["logz"] = max(errs["logz"], (got - ref).abs().max().item())
            n_both = int(both.sum())
            require(marked == 0 if margin <= 30 else marked <= n_both,
                    f"logZ at {margin} nats: {marked} cells marked, {n_both} peak twice")
            require(margin < 100 or marked == n_both > 0,
                    f"logZ at {margin} nats: {marked} cells marked, {n_both} peak twice")
            line.append(f"{margin} nats {marked}/{n_both}")
        log(f"  (B, T, U1, V) = ({b}, {tlen}, {u1}, {v}), {b * tlen * u1} cells; marked / "
            f"peaked twice: " + ", ".join(line) + f"; max|err| so far {errs['logz']:.3e}")
    a, l, _ = spiked_logits(gen, B_TRAIN, T_MAIN, 43, 6485, 100)
    with torch.no_grad():
        first, again = additive_logz(a, l), additive_logz(a, l)
    require(torch.equal(first, again), "two launches of the additive logZ differ")
    log(f"  two launches at (4, 410, 43, 6485), 100 nats ({lk.marked_cells()} cells "
        f"through the exact pass): bit-identical")
    log(f"band sweeps vs plain in float64 (rtol {LATTICE_TOL['rtol']}, atol "
        f"{LATTICE_TOL['atol']}; ragged t_len, a zero-length row, a clamped "
        f"terminal slot; both sides clamped at NEG and equal cells at or below "
        f"NEG / 2, at the plan's chunks and at 1, 2 and 7):")
    # S past 32 takes several slots a lane; its plain sweep is slow (a step
    # per slot and row), so most of those run at a short T
    sweeps = [(s_range, (1, 37, T_MAIN)) for s_range in range(2, 9)]
    sweeps += [(33, (1, 37, T_MAIN)), (64, (1, 37)), (128, (1, 37))]
    for s_range, lengths in sweeps:
        line = []
        for tlen in lengths:
            lp_b, lp_l, d_a, d_b, tf, sf = band_inputs(gen, B_TRAIN, tlen, s_range)
            # the plain sweeps in float64: in float32 their own rounding
            # grows with the log-alphas and log-betas (1.7x and 0.9x the
            # tolerance at S 128, T 410)
            refs = {"band_alpha": band_alpha_plain(lp_b.double(), lp_l.double(), d_a).float(),
                    "band_beta": band_beta_plain(lp_b.double(), lp_l.double(), d_b, tf,
                                                 sf).float()}
            plan = f"the plan's {band_alpha_plan(tlen, s_range)}"
            runs = [("band_alpha", plan, band_alpha(lp_b, lp_l, d_a, s_range)),
                    ("band_beta", plan, band_beta(lp_b, lp_l, d_b, tf, sf, s_range))]
            for n in (1, 2, 7):
                runs += [("band_alpha", str(n), bk._launch_alpha(lp_b, lp_l, d_a, n)),
                         ("band_beta", str(n), bk._launch_beta(lp_b, lp_l, d_b, tf, sf, n))]
            torch.cuda.synchronize()
            for name, chunks, got in runs:
                what = f"{name} S={s_range} T={tlen}, {chunks} chunks"
                ref = refs[name]
                # cells no path reaches sit at or below NEG: compared, and
                # the error read, with both sides clamped there
                torch.testing.assert_close(got.clamp(min=-1e30), ref.clamp(min=-1e30),
                                           **LATTICE_TOL, msg=what)
                require(torch.equal(got <= -5e29, ref <= -5e29),
                        f"{what}: the cells at or below NEG / 2 differ")
                err = (got.clamp(min=-1e30) - ref.clamp(min=-1e30)).abs().max()
                errs[name] = max(errs[name], err.item())
            line.append(f"T={tlen}")
        log(f"  S={s_range} ({', '.join(line)}): max|err| so far alpha "
            f"{errs['band_alpha']:.3e}, beta {errs['band_beta']:.3e}")
    # the chunked sweeps: two launches to the bit, a graph's replay equal to
    # the eager call
    lp_b, lp_l, d_a, d_b, tf, sf = band_inputs(gen, B_TRAIN, T_MAIN, S_RANGE)
    for name, run in (("band alpha", lambda: band_alpha(lp_b, lp_l, d_a, S_RANGE)),
                      ("band beta", lambda: band_beta(lp_b, lp_l, d_b, tf, sf, S_RANGE))):
        first, again = run(), run()
        require(torch.equal(first, again), f"two launches of the {name} differ")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = run()
        graph.replay()
        torch.cuda.synchronize()
        require(torch.equal(replayed, first), f"the {name}'s graph replay differs")
        del graph
        log(f"  {name} at ({B_TRAIN}, {T_MAIN}, {S_RANGE}), "
            f"{band_alpha_plan(T_MAIN, S_RANGE)} chunks: two launches bit-identical, the "
            f"graph replay equal to the eager call")
    return errs


def lattice_inputs(b, tlen, u, gen, with_empty=True):
    """Skewed blank/label grids and the terminal inject as the loss builds
    them (``ops/rnnt_loss.lattice_grids``, ``terminal_inject``): log-probs of
    random logits over 64 classes; row 0 at full length, row 1 with no
    frames (when ``with_empty``), the rest of random lengths."""
    import torch
    from transformer_transducer_tpu_torch.ops import rnnt_loss
    logp = torch.log_softmax(torch.randn(b, tlen, u + 1, 64, generator=gen,
                                         device="cuda") * 2, dim=-1)
    lp_b, lp_l = logp[..., 0], logp[..., 1]
    t_len = torch.randint(1, tlen + 1, (b,), generator=gen, device="cuda")
    u_len = torch.randint(0, u + 1, (b,), generator=gen, device="cuda")
    t_len[0], u_len[0] = tlen, u
    if with_empty and b > 1:
        t_len[1] = 0
    sb, sl, t_len, u_len = rnnt_loss.lattice_grids(lp_b, lp_l, t_len, u_len)
    return sb, sl, rnnt_loss.terminal_inject(sb, t_len, u_len)[1]


def attention_grads(fn, leaves, gout):
    """The output and the six gradients (q, k, v, un-sliced r_emb, r_w_bias,
    r_bias) of ``fn`` on the leaves ``(qkv, r_emb, r_w_bias, r_bias)``."""
    from transformer_transducer_tpu_torch.models.attention import slice_pos_table
    for x in leaves:
        x.grad = None
    qkv, re, u, rb = leaves
    q, k, v = qkv.unbind(2)
    tlen = q.shape[1]
    out = fn(q, k, v, slice_pos_table(re, tlen), u, slice_pos_table(rb, tlen))
    out.backward(gout)
    return [out.detach(), *qkv.grad.unbind(2), re.grad, u.grad, rb.grad]


def bf16_step(x):
    """The spacing of bf16 numbers at |x| (8 significant bits), 0 at 0."""
    import torch
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8) * (x != 0)


def hold_bf16(what, got, ref, slack, ref32=None) -> float:
    """``|got - ref| <= slack`` element by element and, with ``ref32`` (the
    float32 function on the same bf16 values), a 2-norm error within a
    quarter of ``ref``'s distance from it; returns the largest |error|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    over = int((err > slack).sum())
    require(over == 0, f"{what}: {over} elements over the bar, the worst {err.max():.3e}")
    if ref32 is not None:
        e2, dist = (got - ref).norm().item(), (ref - ref32.float()).norm().item()
        require(e2 <= 0.25 * dist, f"{what}: 2-norm error {e2:.3e} over a quarter of the "
                f"bf16-float32 distance {dist:.3e}")
    return err.max().item()


def bf16_grad_allowance(args, gout) -> float:
    """What one bf16 rounding inside the bf16 backward's sums that goes the
    other way can move a gradient by: a bf16 step of the largest |dS| or P
    (the plain bf16 form's, from ``args = (q, k, v, r_emb, r_w_bias,
    r_bias)`` and the output gradient) times the largest operand it
    multiplies.  A dS or P whose float32 value sits within a few ulps of a
    rounding boundary rounds one way in the kernel and the other in the
    plain form (measured on an H100: dq at T 513 moved by 7.8e-3, 5 of its
    1,050,624 elements over the bar without this)."""
    import torch
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    q, k, v, re, u, rb = args
    with torch.no_grad():
        qf, kf, ref, _, qu, root, _, scores = fa._bf16_parts(q, k, re, u, rb)
        prob = torch.softmax(scores, dim=-1)
        go = gout.to(torch.bfloat16).float()
        dp = torch.einsum("bind,bjnd->bnij", go, v.float())
        ds = prob * (dp - (prob * dp).sum(-1, keepdim=True)) / root
        step = max(bf16_step(ds.abs().max()).item(), bf16_step(prob.max()).item())
        return step * max(x.abs().max().item() for x in (qf, kf, v.float(), ref, qu, go))


def bf16_attention_inputs(tlen, k_len, gen, b=B, dh=DH):
    """``attention_inputs`` in bf16 at unit scale: q, k, v strided views of
    one bf16 projection, bf16 tables sliced to T."""
    import torch
    from transformer_transducer_tpu_torch.models.attention import slice_pos_table
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = mk(b, tlen, 3, H, dh).unbind(2)
    return (q, k, v, slice_pos_table(mk(k_len, H, dh), tlen), mk(H, dh),
            slice_pos_table(mk(k_len, H), tlen))


def check_bf16_forward(gen):
    """Phase 3, the bf16 forward (kernel 8's bf16 form) against the plain
    bf16 forward on strided bf16 views: output, lse and float32 sums
    (``BF16_FWD_RTOL``, the output also one P's rounding a row and under a
    quarter of the bf16-to-float32 distance), at Dh 64 and 32, at T
    around its 64-row query tiles and 64-key chunks (and 32-key ones), the
    table ring's wraps at 410 and 513; the wrapper without the lse gives
    the same output bits.  Returns the largest abs error."""
    import torch
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    worst = 0.0
    for dh in (DH, 32):
        for tlen in (1, 15, 16, 17, 31, 32, 33, 37, 63, 64, 65, 127, 128, 129, 191, 192, 193,
                     410, 513):
            args = bf16_attention_inputs(tlen, 410, gen, dh=dh)
            out, lse, sums = fa.flash_forward_bf16(*args, with_lse=True)
            without = fa.flash_rel_attention(*args)
            ref, ref_lse, ref_sums = fa.flash_bf16_forward_plain(*args)
            scores = fa._bf16_parts(*args[:2], *args[3:])[-1]
            p_max = torch.softmax(scores, -1).amax(-1).transpose(1, 2)[..., None]
            flip = bf16_step(p_max) * args[2].float().abs().max()
            ref32 = fa.flash_rel_attention_plain(*(x.float() for x in args))
            torch.cuda.synchronize()
            errs = [hold_bf16(f"bf16 flash Dh={dh} T={tlen} out", out, ref,
                              BF16_FWD_RTOL * ref.abs().max() + flip, ref32),
                    hold_bf16(f"bf16 flash Dh={dh} T={tlen} lse", lse, ref_lse,
                              BF16_FWD_RTOL * ref_lse.abs().max()),
                    hold_bf16(f"bf16 flash Dh={dh} T={tlen} sums", sums, ref_sums,
                              BF16_FWD_RTOL * ref_sums.abs().max())]
            require(torch.equal(without, out), f"bf16 flash T={tlen}: the output moved "
                    "with the lse")
            log(f"  flash bf16 Dh={dh} T={tlen:4d}: max|err| out {errs[0]:.3e}, lse "
                f"{errs[1]:.3e}, sums {errs[2]:.3e}")
            worst = max(worst, *errs)
    return worst


def check_bf16_backward(gen):
    """Phase 3, the bf16 backward (kernel 9's bf16 form) through the
    autograd function on strided bf16 views against the plain bf16
    backward: each gradient within ``BF16_GRAD_RTOL`` of its leaf's largest
    magnitude or one bf16 step of the element, plus one rounding inside the
    sums (``bf16_grad_allowance``) and ``GRAD_FLOOR``, and the
    leaves of 10,000 elements or more under a quarter of the
    bf16-to-float32 distance, at Dh 64 and 32, at T around its 64-key
    blocks and 32-row query steps (and the table ring's wraps at 410 and
    513); dk and dv, which the block that owns their keys writes once, to
    the bit in a second call.  Returns the largest abs error."""
    import torch
    from transformer_transducer_tpu_torch.models.attention import slice_pos_table
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    worst = 0.0
    names = ("dq", "dk", "dv", "d_r_emb", "d_r_w_bias", "d_r_bias")
    for dh in (DH, 32):
        for tlen in (1, 15, 16, 17, 31, 32, 33, 37, 63, 64, 65, 95, 96, 97, 127, 128, 129,
                     191, 192, 193, 255, 256, 257, 410, 513):
            mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
            leaves = [mk(B_TRAIN, tlen, 3, H, dh).requires_grad_(), mk(T_MAIN, H, dh)
                      .requires_grad_(), mk(H, dh).requires_grad_(),
                      mk(T_MAIN, H).requires_grad_()]
            gout = torch.randn(B_TRAIN, tlen, H, dh, generator=gen, device="cuda")
            got = attention_grads(fa.flash_rel_attention, leaves, gout)
            again = attention_grads(fa.flash_rel_attention, leaves, gout)
            require(torch.equal(got[2], again[2]) and torch.equal(got[3], again[3]),
                    f"bf16 flash backward Dh={dh} T={tlen}: dk or dv moved in a second call")
            ref = attention_grads(fa.flash_rel_attention_plain, leaves, gout)
            f32 = [x.detach().float().requires_grad_() for x in leaves]
            ref32 = attention_grads(fa.flash_rel_attention_plain, f32,
                                    gout.to(torch.bfloat16).float())
            qkv, re, u, rb = leaves
            inner = bf16_grad_allowance(
                (*qkv.detach().unbind(2), slice_pos_table(re.detach(), tlen), u.detach(),
                 slice_pos_table(rb.detach(), tlen)), gout)
            torch.cuda.synchronize()
            line = []
            for name, a, r, r32 in zip(names, got[1:], ref[1:], ref32[1:]):
                slack = torch.maximum(BF16_GRAD_RTOL * r.float().abs().max(), bf16_step(
                    torch.maximum(a.float().abs(), r.float().abs()))) + inner + GRAD_FLOOR
                err = hold_bf16(f"bf16 flash backward Dh={dh} T={tlen} {name}", a, r, slack,
                                r32 if tlen > 1 and r.numel() >= 10_000 else None)
                worst = max(worst, err)
                line.append(f"{name} {err:.2e}")
            log(f"  flash bf16 Dh={dh} T={tlen:3d}: " + ", ".join(line))
    return worst


def check_training_kernels(gen):
    """Phase 3, the training kernels: the lattice sweeps against the eager
    scans and the attention backward against autograd through the plain
    versions; returns the largest abs error of each kernel."""
    import torch
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
        flash_rel_attention, flash_rel_attention_plain)
    from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import (
        alpha_scan, alpha_scan_plain, beta_scan, beta_scan_plain)
    errs = {"alpha": 0.0, "beta": 0.0, "banded_bwd": 0.0, "flash_bwd": 0.0}
    log(f"lattice sweeps vs eager scans (rtol {LATTICE_TOL['rtol']}, atol "
        f"{LATTICE_TOL['atol']}):")
    shapes = [(B_TRAIN, T_MAIN, 42)] + [(B_TRAIN, t, u) for t in (1, 37, 410)
                                        for u in (0, 1, 42)]
    # around one warp's 32 lanes of 1, 2 and 4 cells, several warps, the most
    shapes += [(B_TRAIN, 37, u) for u in (30, 31, 32, 63, 64, 127, 128, 1023)]
    shapes += [(B_TRAIN, T_MAIN, 128)]
    for b, tlen, u in shapes:
        sb, sl, inject = lattice_inputs(b, tlen, u, gen)
        pairs = (("alpha", alpha_scan(sb, sl), alpha_scan_plain(sb, sl)),
                 ("beta", beta_scan(sb, sl, inject),
                  beta_scan_plain(sb, sl, inject)))
        torch.cuda.synchronize()
        line = []
        for name, got, ref in pairs:
            err = (got - ref).abs().max().item()
            torch.testing.assert_close(got, ref, **LATTICE_TOL)
            errs[name] = max(errs[name], err)
            line.append(f"{name} {err:.3e}")
        log(f"  B={b} T={tlen:3d} U={u:2d}: max|err| " + ", ".join(line))
    for tlen, u in ((T_MAIN, 42), (T_MAIN, 128), (37, 1023)):
        sb, sl, inject = lattice_inputs(B_TRAIN, tlen, u, gen)
        for name, run in (("alpha", lambda: alpha_scan(sb, sl)),
                          ("beta", lambda: beta_scan(sb, sl, inject))):
            first, again = run(), run()
            require(torch.equal(first, again), f"two launches of the {name} sweep differ")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = run()
            graph.replay()
            torch.cuda.synchronize()
            require(torch.equal(replayed, first), f"the {name} sweep's graph replay differs")
            del graph
        log(f"  T={tlen} U={u}: each sweep's two launches bit-identical, its graph replay "
            f"equal to the eager call")

    log(f"attention backward vs autograd through the plain versions (atol "
        f"{GRAD_TOL} * max|ref| + {GRAD_FLOOR}, rtol {GRAD_TOL}):")
    names = ("out", "dq", "dk", "dv", "d_r_emb", "d_r_w_bias", "d_r_bias")
    # the flash backward also at the edges of its 32-row query tiles and
    # 64-key chunks
    cases = [(tlen, band) for tlen in (1, 37, 410, 513)
             for band in (None, (10, 2), (0, 0), (64, 64))]
    cases += [(tlen, band) for tlen in (1, 37, 410, 513) for band in ((3, 64), (64, 0))]
    cases = [(tlen, band, DH) for tlen, band in cases]
    cases += [(tlen, None, DH) for tlen in (15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
                                             128, 129)]
    # the banded backward at the edges of its 32-row blocks and 48-row cell
    # tiles
    cases += [(tlen, band, DH) for tlen in (31, 32, 33, 47, 48, 49, 95, 96, 97)
              for band in ((10, 2), (3, 64), (64, 0))]
    # head width 32
    cases += [(tlen, band, 32) for tlen in (1, 33, 129, 410) for band in (None, (10, 2))]
    for tlen, band, dh in cases:
        mk = lambda *s: (torch.randn(*s, generator=gen, device="cuda")
                         * 0.5).requires_grad_()
        leaves = [mk(B_TRAIN, tlen, 3, H, dh), mk(T_MAIN, H, dh), mk(H, dh),
                  mk(T_MAIN, H)]
        gout = torch.randn(B_TRAIN, tlen, H, dh, generator=gen, device="cuda")
        if band is None:
            key, kern, plain = "flash_bwd", flash_rel_attention, \
                flash_rel_attention_plain
        else:
            key = "banded_bwd"
            kern = lambda *a, band=band: banded_attention(*a, *band)
            plain = lambda *a, band=band: banded_attention_plain(*a, *band)
        got = attention_grads(kern, leaves, gout)
        ref = attention_grads(plain, leaves, gout)
        torch.cuda.synchronize()
        line = []
        for name, a, r in zip(names, got, ref):
            err = (a - r).abs().max().item()
            torch.testing.assert_close(
                a, r, atol=GRAD_TOL * r.abs().max().item() + GRAD_FLOOR,
                rtol=GRAD_TOL, msg=f"T={tlen} band={band} {name}")
            if name != "out":
                errs[key] = max(errs[key], err)
            line.append(f"{name} {err:.2e}")
        label = "flash " if band is None else f"banded ({band[0]},{band[1]})"
        log(f"  {label} Dh={dh} T={tlen:3d}: " + ", ".join(line))
    return errs


@contextlib.contextmanager
def plain_versions():
    """Route the attention, lattice, logZ and band wrappers to their plain
    versions on the card (the comparisons' reference path; the logZ's
    gradient then comes from autograd through the plain version)."""
    from transformer_transducer_tpu_torch.ops import rnnt_loss
    from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
    from transformer_transducer_tpu_torch.ops.cuda import banded_attention as ba
    from transformer_transducer_tpu_torch.ops.cuda import band_kernel as bk
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    from transformer_transducer_tpu_torch.ops.cuda import logz_kernel as lk
    from transformer_transducer_tpu_torch.ops.cuda import rnnt_kernel as rk
    saved = (ba.banded_attention, fa.flash_rel_attention, rnnt_loss.alpha_scan,
             rnnt_loss.beta_scan, rp.additive_logz, rp.band_alpha, rp.band_beta)
    ba.banded_attention = ba.banded_attention_plain
    fa.flash_rel_attention = fa.flash_rel_attention_plain
    rnnt_loss.alpha_scan, rnnt_loss.beta_scan = rk.alpha_scan_plain, rk.beta_scan_plain
    rp.additive_logz = lambda a, l: lk.additive_logz_plain(a.float(), l.float())
    rp.band_alpha = lambda lp_b, lp_l, d, s_range: bk.band_alpha_plain(lp_b, lp_l, d)
    rp.band_beta = lambda lp_b, lp_l, d, tf, sf, s_range: bk.band_beta_plain(
        lp_b, lp_l, d, tf, sf)
    try:
        yield
    finally:
        (ba.banded_attention, fa.flash_rel_attention, rnnt_loss.alpha_scan,
         rnnt_loss.beta_scan, rp.additive_logz, rp.band_alpha, rp.band_beta) = saved


@contextlib.contextmanager
def band_starts(record, force=None):
    """Append each pruned step's band starts ``rs`` to ``record``; with
    ``force`` (another run's records), hand the loss the starts of that
    run's same step instead of its own."""
    from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
    original = rp.bounds_from_occ

    def hooked(*args):
        rs = original(*args)
        record.append(rs)
        return rs if force is None else force[len(record) - 1]

    rp.bounds_from_occ = hooked
    try:
        yield
    finally:
        rp.bounds_from_occ = original


@contextlib.contextmanager
def logz_marks(record):
    """Append, after each logZ call of the pruned loss, the cells the kernel
    left to its exact pass (a read of the device after the call)."""
    from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
    from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import marked_cells
    original = rp.additive_logz

    def hooked(a_grid, l_grid):
        z = original(a_grid, l_grid)
        record.append(marked_cells())
        return z

    rp.additive_logz = hooked
    try:
        yield
    finally:
        rp.additive_logz = original


@functools.lru_cache(maxsize=None)
def counters():
    """The launch counters of every kernel wrapper, by name (the wrappers
    themselves, read before ``plain_versions`` can swap them out)."""
    from transformer_transducer_tpu_torch.ops.cuda import banded_attention as ba
    from transformer_transducer_tpu_torch.ops.cuda import band_kernel as bk
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    from transformer_transducer_tpu_torch.ops.cuda import logz_kernel as lk
    from transformer_transducer_tpu_torch.ops.cuda import rnnt_kernel as rk
    return {"banded_fwd": ba.banded_attention, "banded_bwd": ba.banded_attention_backward,
            "flash_fwd": fa.flash_rel_attention,
            "flash_bwd": fa.flash_rel_attention_backward,
            # the bf16 forms alone (also counted in flash_fwd, flash_bwd)
            "flash_fwd_bf16": fa.flash_forward_bf16,
            "flash_bwd_bf16": fa.flash_backward_bf16,
            "alpha": rk.alpha_scan, "beta": rk.beta_scan,
            "logz": lk.additive_logz, "band_alpha": bk.band_alpha,
            "band_beta": bk.band_beta}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def training_batch(cfg, device, seed, raw=False):
    """B_TRAIN synthetic utterances of 60-410 frames through the dataset's
    host frontend (log-mel eps, stack, subsample), padded to
    max_input_length, with 5-42 random targets (1 .. V - 1, or 1 .. V - 2
    for the espnet family, whose V - 1 is sos); and its seconds of audio.
    With ``raw`` the same waves and targets as ``data.on_device_features``
    ships them: padded int16 waves and their sample counts."""
    import numpy as np
    from transformer_transducer_tpu_torch.data.dataset import pad_raw_wave
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.ops.features import padded_wave_samples
    from transformer_transducer_tpu_torch.training.train_step import batch_to_device
    from transformer_transducer_tpu_torch.utils.config import (
        stack_context, subsample_factor)
    waves = synthetic_waves(B_TRAIN, seed)
    left, right = stack_context(cfg.data)
    t_max, u_max = cfg.data.max_input_length, cfg.data.max_target_length
    if raw:
        padded = [pad_raw_wave(w, *padded_wave_samples(t_max, subsample_factor(cfg.data)))
                  for w in waves]
        x = np.stack([p[0] for p in padded])
        x_len = np.array([p[1] for p in padded])
    else:
        feats = [F.subsample(F.stack_frames(F.logmel_eps(w, 16000, cfg.data.feature_dim),
                                            left, right), subsample_factor(cfg.data))
                 for w in waves]
        x = np.zeros((B_TRAIN, t_max, feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            x[i, :min(len(f), t_max)] = f[:t_max]
        x_len = np.array([min(len(f), t_max) for f in feats])
    rng = np.random.default_rng(seed)
    u_len = np.linspace(5, u_max, B_TRAIN).astype(np.int64)
    targets = np.zeros((B_TRAIN, u_max), np.int64)
    for i, n in enumerate(u_len):
        targets[i, :n] = rng.integers(1, cfg.model.vocab_size or cfg.model.joint.vocab_size - 1,
                                      n)
    batch = {"inputs": x, "inputs_length": x_len, "targets": targets,
             "targets_length": u_len}
    return batch_to_device(batch, device), sum(len(w) for w in waves) / 16000.0


def make_trainee(model_cfg, optim_cfg, state, mode, device, pruned_range=None,
                 frontend=None, compute_dtype=None, remat=False, mesh=None, zero=False,
                 micro=0):
    """A model in train mode with ``state``, its SGD optimizer (momentum,
    clip 200 as the trainer builds it) and its train step (SpecAugment on;
    the pruned loss with simple scale 0.25 when ``pruned_range``; the
    on-device log-mel of raw waves with a ``frontend`` tuple; bf16 compute
    with ``compute_dtype``, per-layer encoder recomputation with
    ``remat``; with a ``mesh`` this rank's part of the model and of the
    batch's step, its stage's layers on a pipe axis, ZeRO-1 with ``zero``;
    ``micro`` microbatches a pipelined step, and with no pipe axis the
    pipelined step on one stage: the microbatches one by one in one
    process).  An espnet-schema block (``mask``) builds the espnet family
    (``mode`` and ``remat`` do not apply)."""
    import torch
    compute_dtype = compute_dtype or torch.float32
    from transformer_transducer_tpu_torch.models.factory import build_family
    from transformer_transducer_tpu_torch.training.optim import build_optimizer
    from transformer_transducer_tpu_torch.training.train_step import (
        TrainStepConfig, make_train_step)
    from transformer_transducer_tpu_torch.utils.config import Config
    model = build_family(Config(model=model_cfg), flash=mode == "flash",
                         banded=mode == "banded", device=device, remat=remat,
                         compute_dtype=compute_dtype)
    model.load_state_dict(state)
    model.train()
    from transformer_transducer_tpu_torch.parallel.mesh import Mesh
    from transformer_transducer_tpu_torch.parallel.sharding import (
        pipe_model, pipe_plan, shard_model, tp_plan, zero_param_shardings)
    from transformer_transducer_tpu_torch.training.train_step import (
        make_pipelined_train_step)
    if mesh is not None:
        shard_model(model, mesh)
        pipe_model(model, mesh)
    opt = build_optimizer(optim_cfg, list(model.parameters()), max_grad_norm=200.0,
                          tp=tp_plan(model), pipe=pipe_plan(model),
                          zero=(mesh, zero_param_shardings(model, mesh)) if zero else None)
    cfg = TrainStepConfig(loss_pruned_range=pruned_range, frontend=frontend, pipe_micro=micro)
    if micro and (mesh is None or not mesh.pipelined):
        return model, opt, make_pipelined_train_step(model, opt, cfg, mesh or Mesh(), micro)
    return model, opt, make_train_step(model, opt, cfg, mesh=mesh)


def train_three_steps(model_cfg, optim_cfg, state, mode, batch, device, plain,
                      pruned_range=None, hooks=(), frontend=None, compute_dtype=None,
                      remat=False, steps=3, micro=0):
    """Phases 6, 6b, 11, 14 and 18: ``steps`` steps from ``state`` with the
    SpecAugment stream and the dropout generators seeded alike, inside the
    contexts ``hooks`` (``micro``: the microbatches one by one through the
    pipelined step); per step (loss, raw gradient norm, launch counts)."""
    import torch
    model, opt, step = make_trainee(model_cfg, optim_cfg, state, mode, device,
                                    pruned_range, frontend, compute_dtype, remat, micro=micro)
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)                    # dropout, on the host and the card
    out = []
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(plain_versions())
        for hook in hooks:
            stack.enter_context(hook)
        for _ in range(steps):
            reset_counts()          # the main path: counts from 0, read after
            m = step(batch, gen)
            torch.cuda.synchronize()
            out.append((float(m["loss"]), float(m["grad_norm"]), read_counts()))
    return out


def check_streaming_shapes(gen) -> float:
    """The banded forward against its plain version at the streaming
    sessions' shape: T pinned at STREAM_T, one window or a group of 16;
    returns the largest abs error."""
    import torch
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    worst = 0.0
    for b in (1, 16):
        args = attention_inputs(STREAM_T, 410, gen, b=b)
        got = banded_attention(*args, *BAND)
        ref = banded_attention_plain(*args, *BAND)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        log(f"  banded Dh={DH} B={b} T={STREAM_T} band=({BAND[0]},{BAND[1]}): max|err| "
            f"{err:.3e}")
        torch.testing.assert_close(got, ref, **KERNEL_TOL)
        worst = max(worst, err)
    return worst


def check_kernels(gen):
    """Phase 3: the attention forward kernels against their plain versions,
    with their row log-sum-exps against the logsumexp of the plain scores
    (band-masked for the banded forward); returns the largest abs error of
    each."""
    import torch
    from transformer_transducer_tpu_torch.models.attention import rel_attention_scores
    from transformer_transducer_tpu_torch.ops.cuda import common
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
        flash_rel_attention_plain)
    from transformer_transducer_tpu_torch.ops.masks import context_mask
    errs = {"banded": 0.0, "flash": 0.0}
    # the banded forward at the edges of its 32-row blocks and of the 47
    # keys an offset chunk stages; 513 > k_len: front pad.  The wrapper
    # (no lse) and a launch with the lse must give the same output bits.
    for dh in (DH, 32):
        for tlen in (1, 33, 37, 49, 129, 410, 513):
            for band in ((10, 2), (0, 0), (3, 64), (64, 0), (64, 64)):
                args = attention_inputs(tlen, 410, gen, dh=dh)
                got = banded_attention(*args, *band)
                with_lse, lse, _ = common.launch_forward("ttx_banded_attention_fwd", args,
                                                         band, with_lse=True)
                ref = banded_attention_plain(*args, *band)
                scores = rel_attention_scores(*args[:2], *args[3:]).masked_fill(
                    context_mask(tlen, *band, device="cuda"), float("-inf"))
                lse_ref = torch.logsumexp(scores, -1)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                err_lse = (lse - lse_ref).abs().max().item()
                log(f"  banded Dh={dh} T={tlen:4d} band=({band[0]},{band[1]}): max|err| "
                    f"{err:.3e}, lse {err_lse:.3e}")
                torch.testing.assert_close(got, ref, **KERNEL_TOL)
                torch.testing.assert_close(lse, lse_ref, **KERNEL_TOL)
                require(torch.equal(got, with_lse),
                        f"banded T={tlen} band={band}: the output moved with the lse")
                errs["banded"] = max(errs["banded"], err, err_lse)
    errs["banded"] = max(errs["banded"], check_streaming_shapes(gen))
    # the flash forward (on the tensor cores) at the edges of its 128-row
    # query tiles and 32-key chunks, with its row log-sum-exp; 513 > k_len:
    # front pad
    for dh in (DH, 32):
        for tlen in (1, 15, 16, 17, 31, 32, 33, 37, 63, 64, 65, 127, 128, 129,
                     410, 513):
            args = attention_inputs(tlen, 410, gen, dh=dh)
            got, lse, _ = common.launch_forward("ttx_flash_rel_attention_fwd", args, (),
                                                with_lse=True)
            ref = flash_rel_attention_plain(*args)
            lse_ref = torch.logsumexp(rel_attention_scores(*args[:2], *args[3:]), -1)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            log(f"  flash  Dh={dh} T={tlen:4d}: max|err| {err:.3e}, lse {err_lse:.3e}")
            torch.testing.assert_close(got, ref, **KERNEL_TOL)
            torch.testing.assert_close(lse, lse_ref, **KERNEL_TOL)
            errs["flash"] = max(errs["flash"], err, err_lse)
    return errs


def synthetic_waves(n_utts, seed, frames=None):
    """int16 waves of 60..410 frames after the frontend (about 1.8-12.3 s),
    or of the given ``frames`` each: voiced chirps with pauses and noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    waves = []
    if frames is None:
        frames = np.linspace(60, T_MAIN, n_utts).astype(int)
    for n_frames in frames:
        n = 480 * (int(n_frames) - 1)     # hop 160, subsample 3
        tt = np.arange(n) / 16000.0
        f0 = rng.uniform(100, 300)
        sig = sum(np.sin(2 * np.pi * f0 * m * tt * (1 + 0.1 * np.sin(3 * tt))) / m
                  for m in (1, 2, 3))
        sig *= 0.2 + (np.sin(2 * np.pi * rng.uniform(1, 3) * tt) > -0.3)
        waves.append(((sig + 0.05 * rng.standard_normal(n)) * 4000).astype(np.int16))
    return waves


def greedy_trace(model, enc1, t_len, max_tokens, use_cache=True):
    """One utterance's greedy decode, frame by frame: (token or 0, top-2
    logit gap) per frame; from the model family's seed, its label state
    from the KV cache or, without ``use_cache``, re-encoded over the
    history under the causal mask."""
    import torch
    from transformer_transducer_tpu_torch.decoding.greedy import predict_last_state
    from transformer_transducer_tpu_torch.ops.masks import look_ahead_mask
    dev = enc1.device
    one = torch.ones(1, dtype=torch.bool, device=dev)
    init_cache, lc_step = model.label_cache()
    hist = [model.sos]

    def label_state(tok):
        nonlocal cache
        if use_cache:
            dec, cache = lc_step(torch.tensor([tok], device=dev), cache, one)
            return dec
        buf = torch.zeros((1, max_tokens), dtype=torch.long, device=dev)
        buf[0, :len(hist)] = torch.tensor(hist, device=dev)
        return predict_last_state(model, buf, torch.tensor([len(hist)], device=dev),
                                  look_ahead_mask(max_tokens, device=dev))

    with torch.no_grad():
        cache = init_cache(1, max_tokens)
        dec = label_state(hist[0])
        out = []
        for t in range(t_len):
            logits = model.joint_logits(enc1[:, t], dec)[0]
            top = logits.topk(2).values
            pred = int(logits.argmax())
            emit = pred != 0 and len(hist) < max_tokens
            out.append((pred if emit else 0, float(top[0] - top[1])))
            if emit:
                hist.append(pred)
                dec = label_state(pred)
    return out


def compare_tokens(name, got, ref, model, enc_k, enc_p, t_len, max_tokens, tol=GAP_TOL,
                   caches=(True, True), ref_model=None):
    """Tokens must be identical; where they are not, the first differing
    frame must be a tie (top-2 gap <= ``tol``), else the run fails.
    ``caches``: whether each side's replay takes the KV-cached label
    state; ``ref_model``: the model ``ref`` was decoded with (on the
    device of ``enc_p``), if not ``model``."""
    if got == ref:
        log(f"  {name}: tokens identical ({sum(map(len, got))} tokens)")
        return
    for u, (a, b) in enumerate(zip(got, ref)):
        if a == b:
            continue
        ta = greedy_trace(model, enc_k[u:u + 1], int(t_len[u]), max_tokens, caches[0])
        tb = greedy_trace(ref_model or model, enc_p[u:u + 1], int(t_len[u]), max_tokens,
                          caches[1])
        frame = next(i for i, (x, y) in enumerate(zip(ta, tb)) if x[0] != y[0])
        gap = max(ta[frame][1], tb[frame][1])
        log(f"  {name}: utterance {u} first differs at frame {frame}, "
            f"top-2 logit gap {gap:.3e}")
        if gap > tol:
            raise AssertionError(f"{name}: kernel and plain tokens diverge at "
                                 f"utterance {u}, frame {frame} (gap {gap:.3e})")


def paired_trace(model, enc_a, enc_b, t_len, max_tokens):
    """Batched greedy decode along ``enc_b``'s path, as ``greedy_decode``
    decides, with the joint also applied to ``enc_a``'s rows under the
    same label state at every frame; one read of the card at the end.
    Returns numpy (T, B) arrays: the token each path takes at each frame
    (0 for none), each path's top-2 logit gap and max|logits_a - logits_b|."""
    import torch
    b, t_max = enc_b.shape[:2]
    dev = enc_b.device
    t_len = torch.as_tensor(t_len, device=dev)
    rows = []
    init_cache, lc_step = model.label_cache()
    with torch.no_grad():
        cache = init_cache(b, max_tokens)
        dec, cache = lc_step(torch.full((b,), model.sos, dtype=torch.long,
                                        device=dev),
                             cache, torch.ones(b, dtype=torch.bool, device=dev))
        count = torch.ones(b, dtype=torch.long, device=dev)
        for t in range(t_max):
            logits = model.joint_logits(torch.cat([enc_a[:, t], enc_b[:, t]]),
                                        torch.cat([dec, dec]))
            pred = logits.argmax(-1)
            top = logits.topk(2, -1).values
            ok = ((t < t_len) & (count < max_tokens)).repeat(2)
            tok = torch.where(ok & (pred != 0), pred, 0)
            rows.append(torch.stack([tok[:b].float(), tok[b:].float(), *(
                top[:, 0] - top[:, 1]).view(2, b), (logits[:b] - logits[b:]).abs().amax(-1)]))
            emit = tok[b:] != 0
            out, cache = lc_step(tok[b:], cache, emit)
            dec = torch.where(emit[:, None], out, dec)
            count = count + emit.long()
    tok_a, tok_b, gap_a, gap_b, delta = torch.stack(rows).cpu().numpy().transpose(1, 0, 2)
    return tok_a.astype(int), tok_b.astype(int), gap_a, gap_b, delta


def compare_int8_tokens(name, got, ref, model, enc_k, enc_p, t_len, max_tokens):
    """int8 kernel tokens ``got`` against the plain path's ``ref``, replayed
    by ``paired_trace`` on the two encoders' rows: the replay must give
    ``ref``, and each utterance whose tokens differ must differ in the
    replay too.  Where they differ, the first frame the two decide
    differently is logged with its top-2 gap (the larger of the two
    paths'), the largest logit difference there and whether the gap is a
    tie by GAP_TOL; not gated (see INT8_LAYER_MEAN_TOL).  Logs and
    returns these and the percentiles of the top-2 gap over every frame
    the plain path decodes."""
    import numpy as np
    tok_k, tok_p, gap_k, gap_p, delta = paired_trace(model, enc_k, enc_p, t_len, max_tokens)
    gaps, firsts = [], []
    for u, n in enumerate(map(int, t_len)):
        require([int(v) for v in tok_p[:n, u] if v] == ref[u],
                f"{name}: the replay of utterance {u} does not give the plain path's tokens")
        gaps.append(gap_p[:n, u])
        if got[u] == ref[u]:
            continue
        frames = np.flatnonzero(tok_k[:n, u] != tok_p[:n, u])
        require(len(frames) > 0, f"{name}: utterance {u} differs, the replay nowhere")
        f = frames[0]
        gap = float(max(gap_k[f, u], gap_p[f, u]))
        firsts.append({"utterance": u, "frame": int(f), "gap": gap,
                       "max_logit_diff": float(delta[f, u])})
        log(f"  {name}: utterance {u} first differs at frame {f}, top-2 logit gap {gap:.3e} "
            f"({'a' if gap <= GAP_TOL else 'not a'} tie by {GAP_TOL}), max|logit difference| "
            f"there {delta[f, u]:.3e}")
    gaps = np.concatenate(gaps)
    q = dict(zip(("p1", "p5", "p10", "p25", "median"),
                 map(float, np.percentile(gaps, [1, 5, 10, 25, 50]))))
    same = sum(a == b for a, b in zip(got, ref))
    log(f"  {name}: {same} of {len(got)} utterances' tokens identical (not gated); top-2 "
        f"logit gap over the {len(gaps)} frames the plain path decodes: "
        + ", ".join(f"{k} {v:.3e}" for k, v in q.items())
        + f"; {100 * (gaps <= GAP_TOL).mean():.2f} % of them at or under {GAP_TOL}")
    return {"identical": same, "first_divergences": firsts, "frame_gap_quantiles": q,
            "frames": int(len(gaps))}


def load_config(*path):
    """A config of the repo (path under its root) as a port ``Config``."""
    from transformer_transducer_tpu_torch.utils.config import Config, parse_yaml
    with open(os.path.join(HERE, *path), encoding="utf-8") as fh:
        return Config(parse_yaml(fh.read()))


def load_flagship():
    """``configs/joint_streaming.yaml`` as a port ``Config``."""
    return load_config("configs", "joint_streaming.yaml")


def feed_stream(session, wave, chunk=STREAM_CHUNK):
    """Feed ``wave`` to ``session`` ``chunk`` samples a call (all of it in
    one call where ``chunk`` is None), then finalize; the host ms around
    each ``accept_waveform`` that decoded a window, and the tokens each of
    those calls emitted."""
    import torch
    lat, emitted = [], []
    chunk = chunk or len(wave)
    for i in range(0, len(wave), chunk):
        before = session.windows
        start = time.perf_counter()
        new = session.accept_waveform(wave[i:i + chunk])
        torch.cuda.synchronize()
        if session.windows > before:
            lat.append((time.perf_counter() - start) * 1e3)
            emitted.append(len(new))
    session.finalize()
    torch.cuda.synchronize()
    return lat, emitted


def record_windows(session):
    """Have ``session`` keep the encoder rows its frame decoder is given,
    as (first absolute frame, rows) in ``session.window_rows``, so that a
    tie can be replayed after the stream."""
    rows = session.window_rows = []
    decode = session._frame_decode

    def recorded(enc_eff, abs_start):
        rows.append((abs_start, enc_eff.clone()))
        return decode(enc_eff, abs_start)
    session._frame_decode = recorded
    return session


def replay_gap(session, tokens, frame) -> float:
    """The top-2 logit gap at absolute ``frame`` of ``session``'s stream,
    from the encoder row its frame decoder was given there (the last, if
    more than one) under the label state of ``tokens``: the seed and the
    last ``label_history`` of them, as the session's ring holds them."""
    import torch
    from transformer_transducer_tpu_torch.decoding.greedy import predict_last_state
    from transformer_transducer_tpu_torch.ops.masks import look_ahead_mask
    model, cfg = session.model, session.cfg
    start, rows = next((a, r) for a, r in reversed(session.window_rows)
                       if a <= frame < a + r.shape[0])
    cap = cfg.label_history + 1
    hist = [cfg.seed_token] + tokens[len(tokens) - min(len(tokens), cfg.label_history):]
    buf = torch.zeros((1, cap), dtype=torch.long, device=rows.device)
    buf[0, :len(hist)] = torch.tensor(hist, device=rows.device)
    with torch.no_grad():
        dec = predict_last_state(model, buf, len(hist), look_ahead_mask(cap, device=rows.device))
        top = model.joint_logits(rows[frame - start][None], dec)[0].topk(2).values
    return float(top[0] - top[1])


def compare_streams(name, got, ref, tol=GAP_TOL):
    """Two sessions' token streams must be identical; where they are not,
    the first frame they decide differently must be a tie under the label
    state both still share (top-2 logit gap <= ``tol`` in either, replayed
    from the rows each decoded there), else the run fails.  ``tol=None``
    logs the gap and gates nothing (the int8 paths; see
    INT8_LAYER_MEAN_TOL)."""
    a = list(zip(got.timestamps, got.result))
    b = list(zip(ref.timestamps, ref.result))
    if a == b:
        log(f"  {name}: tokens identical ({len(a)} tokens, {len(got.segments)} segments)")
        return
    u = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    frame = min(s[u][0] for s in (a, b) if u < len(s))
    gap = max(replay_gap(s, s.result[:u], frame) for s in (got, ref))
    log(f"  {name}: token {u} first differs at frame {frame}, top-2 logit gap {gap:.3e}"
        + (" (not gated)" if tol is None else ""))
    require(tol is None or gap <= tol, f"{name}: streams diverge at frame {frame} (gap {gap:.3e})")


def check_streaming(cfg, state, offset, device, smi, gen):
    """Phase 9: the streaming sessions at full width.  Returns the kernel
    record's additions for kernel 6 and the phase's summary."""
    import numpy as np
    import torch
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    from transformer_transducer_tpu_torch.streaming.session import (
        StreamingConfig, StreamingSession, TrapezoidStreamingSession, chunked_encode)
    model = build_transducer(cfg.model, device=device)
    model.load_state_dict(state)
    with torch.no_grad():
        model.joint.project_layer.bias[0] += offset       # phase 4's bias
    n_layer = cfg.model.enc.n_layer
    left, right = cfg.model.enc.left_context, cfg.model.enc.right_context
    all_waves = synthetic_waves(8, seed=0)
    waves = {"long": all_waves[-1], "short": all_waves[0]}
    feeds = {"100 ms": STREAM_CHUNK, "whole file": None}
    modes = ("window", "trapezoid", "incremental")

    def session(mode, keep=False):
        scfg = StreamingConfig.from_config(cfg)
        if mode == "trapezoid":
            return TrapezoidStreamingSession(model, scfg, device=device)
        return StreamingSession(model, scfg, device=device, keep_features=keep,
                                incremental=mode == "incremental")

    scfg = StreamingConfig.from_config(cfg)
    scfg.ensure_lengths()
    log(f"streaming sessions at full width, {STREAM_CHUNK * 1000 // 16000} ms a call "
        f"and the whole file in one call (window_len {scfg.window_len}, chunk_len "
        f"{scfg.chunk_len}):")
    # the main path, each wave, feed and mode with the counts from 0; then
    # the same sessions through the plain versions
    kern, plain, stream_launches = {}, {}, 0
    for wname, wave in waves.items():
        for fname, chunk in feeds.items():
            for mode in modes:
                s = record_windows(session(mode, keep=mode == "window"))
                reset_counts()
                feed_stream(s, wave, chunk)
                counts = read_counts()
                want = dict.fromkeys(counts, 0)
                if mode != "incremental":
                    want["banded_fwd"] = n_layer * s.window_groups
                what = f"{mode}, {wname} ({len(wave) / 16000:.2f} s), {fname}"
                log(f"  {what}: {len(s.result)} tokens, {len(s.segments)} segments, "
                    f"{s.windows} windows in {s.window_groups} groups, {s.host_reads} host "
                    f"reads ({s.host_reads / s.windows:.2f} a window); launches {counts}")
                require(counts == want, f"{what}: launches {counts}, want {want}")
                require(s.host_reads <= len(s.result) + s.windows,
                        f"{what}: {s.host_reads} host reads")
                require(s.result and 0 not in s.result and len(s.timestamps) == len(s.result)
                        and all(np.isfinite(s.confidences)), f"{what}: malformed output")
                if mode == "window" and chunk is None and wname == "long":
                    # the windows one call finds ready are encoded together
                    require(s.window_groups < s.windows,
                            f"{what}: {s.windows} windows in {s.window_groups} groups")
                stream_launches += counts["banded_fwd"]
                kern[wname, fname, mode] = s
            with plain_versions():
                for mode in modes:
                    s = record_windows(session(mode))
                    reset_counts()
                    feed_stream(s, wave, chunk)
                    require(not any(read_counts().values()), f"plain {mode} launched")
                    plain[wname, fname, mode] = s
            for mode in modes:
                compare_streams(f"{mode}, {wname}, {fname}, kernel vs plain",
                                kern[wname, fname, mode], plain[wname, fname, mode])
            compare_streams(f"incremental vs window, {wname}, {fname}",
                            kern[wname, fname, "incremental"], kern[wname, fname, "window"])
        compare_streams(f"window, {wname}, whole file vs 100 ms",
                        kern[wname, "whole file", "window"], kern[wname, "100 ms", "window"])

    # chunked_encode against one encode_banded over the padded sequence
    feats = kern["long", "100 ms", "window"].feature_log
    fixed = 512
    padded = torch.zeros((1, fixed, feats.shape[1]), device=device)
    padded[0, :len(feats)] = torch.from_numpy(feats)
    with torch.no_grad():
        full = model.encode_banded(padded, left, right)[0, :len(feats)].cpu().numpy()
    chunked = chunked_encode(model, feats, scfg, fixed_len=fixed)
    require(chunked.shape == full.shape and np.isfinite(chunked).all(),
            "chunked_encode: wrong shape or not finite")
    err = float(np.abs(chunked - full).max())
    log(f"  chunked_encode ({len(feats)} frames, windows padded to {fixed}) vs "
        f"encode_banded over the padded sequence: max|err| {err:.3e} (tolerance {ENC_TOL})")
    require(err <= ENC_TOL, f"chunked_encode differs by {err}")

    # timings: latency per decoding call at 100 ms a call, the whole file
    # in one call (median of 5, warm), the device's idle share of that
    log(f"streaming timings on {smi}:")
    summary = {}
    wave = waves["long"]
    audio_s = len(wave) / 16000.0
    for mode in modes:
        s = session(mode)
        feed_stream(s, wave)                                    # warm-up
        s.reset()
        lat, emitted = feed_stream(s, wave)

        def whole(s=s):
            s.reset()
            s.accept_waveform(wave)
            s.finalize()
        ms = host_ms({mode: whole}, samples=5)[mode]
        med = statistics.median(ms)
        busy = device_busy_ms(whole)
        checked, at_once = kern["long", "100 ms", mode], kern["long", "whole file", mode]
        summary[mode] = {
            "latency_ms_median": statistics.median(lat),
            "latency_ms_p90": float(np.percentile(lat, 90)), "decoding_calls": len(lat),
            "latency_ms_calls": [round(x, 2) for x in lat], "tokens_calls": emitted,
            "whole_file_ms": med, "rtf": med / 1e3 / audio_s,
            "device_busy_ms": busy, "idle_share": 1 - busy / med if busy > 0 else None,
            "host_reads_per_window": checked.host_reads / checked.windows,
            "windows": checked.windows, "groups": checked.window_groups,
            "windows_whole_file": at_once.windows, "groups_whole_file": at_once.window_groups}
        r = summary[mode]
        share = (f"{100 * r['idle_share']:.1f} %" if busy > 0
                 else "not measured (the profiler saw no device time)")
        log(f"  {mode}: latency per decoding call median {r['latency_ms_median']:.2f} ms, "
            f"p90 {r['latency_ms_p90']:.2f} ms (calls {r['latency_ms_calls']}, tokens "
            f"{emitted}); whole file "
            f"({audio_s:.2f} s) in one call {spread(ms)}, real-time factor {r['rtf']:.5f}; "
            f"device busy {busy:.2f} ms, idle share {share}; host reads a window "
            f"{r['host_reads_per_window']:.2f}; the whole file's {at_once.windows} windows "
            f"in {at_once.window_groups} groups")
    # kernel 6 alone at the window length, one window and a group of 16
    rec = {"streaming_launches": stream_launches}
    for b in (1, 16):
        args = attention_inputs(STREAM_T, 410, gen, b=b)
        with torch.no_grad():
            ms = graph_ms(lambda: banded_attention(*args, left, right))
        plain_ms = cuda_ms(lambda: banded_attention_plain(*args, left, right))
        bound_ms, by = bound(STREAM_T, band_cells(STREAM_T, left, right), b=b)
        rec.update({f"ms_t{STREAM_T}_b{b}": ms, f"plain_ms_t{STREAM_T}_b{b}": plain_ms,
                    f"bound_t{STREAM_T}_b{b}_ms": bound_ms})
        log(f"  banded_attention_fwd (B={b}, T={STREAM_T}): kernel {ms:.4f} ms (alone, CUDA "
            f"graph), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}), "
            f"{100 * bound_ms / ms:.1f} % of bound")
    del model
    torch.cuda.empty_cache()
    return rec, summary


def record_rounds(session):
    """Have a batched ``session`` keep the encoder rows its frame decoder is
    given, by utterance (each ``accept_waveform`` call starts one, as a
    whole-file feed or ``serve_files`` admits them), as (first absolute
    frame, rows) lists in ``session.utt_rows``."""
    rows = session.utt_rows = []
    owner = list(range(session.n))
    accept, decode = session.accept_waveform, session._decode_round

    def accepted(slot, samples):
        owner[slot] = len(rows)
        rows.append([])
        return accept(slot, samples)

    def recorded(flat, segs):
        base = 0
        for slot, n, abs_start in segs:
            rows[owner[slot]].append((abs_start, flat[base:base + n].clone()))
            base += n
        return decode(flat, segs)
    session.accept_waveform, session._decode_round = accepted, recorded
    return session


def utterance_views(session, results=None, meta=None):
    """Each utterance a recorded batched ``session`` decoded as an object
    ``compare_streams`` and ``replay_gap`` take: its tokens, timestamps and
    segments (of its stream, or from ``serve_files``' ``results`` and
    ``last_meta``) and the encoder rows it was decoded from."""
    import types
    if results is None:
        results = [st.result for st in session.streams]
        meta = [{"timestamps": st.timestamps, "segments": st.segments}
                for st in session.streams]
    return [types.SimpleNamespace(result=r, timestamps=m["timestamps"],
                                  segments=m["segments"], window_rows=rows,
                                  model=session.model, cfg=session.cfg)
            for r, m, rows in zip(results, meta, session.utt_rows)]


def serving_split(session, run) -> dict:
    """Host ms of one ``run`` of a batched ``session`` in its parts, each
    ended by a synchronise: the rounds' gathering (log-mel features and
    window geometry), the encoder calls and the frame decoder."""
    import torch
    parts = dict.fromkeys(("features", "encoder", "decoder"), 0.0)
    names = {"features": "_gather_chunk_round" if session.incremental else "_gather_round",
             "encoder": "_encode_chunks" if session.incremental else "_encode_windows",
             "decoder": "_decode_round"}
    for part, name in names.items():
        fn = getattr(session, name)

        def timed(*args, fn=fn, part=part):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            parts[part] += (time.perf_counter() - start) * 1e3
            return out
        setattr(session, name, timed)
    start = time.perf_counter()
    run()
    torch.cuda.synchronize()
    parts["total"] = (time.perf_counter() - start) * 1e3
    for name in names.values():
        delattr(session, name)
    return parts


def check_serving(cfg, state, offset, device, smi, gen):
    """Phase 10: multi-stream serving at full width.  Returns the kernel
    record's additions for kernel 6 and the phase's summary."""
    import numpy as np
    import torch
    from transformer_transducer_tpu_torch.apps import serve
    from transformer_transducer_tpu_torch.data.wav import write_wave
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    from transformer_transducer_tpu_torch.streaming.batched import BatchedStreamingSession
    from transformer_transducer_tpu_torch.streaming.session import (
        StreamingConfig, StreamingSession)
    from transformer_transducer_tpu_torch.utils.config import dump_config
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary
    model = build_transducer(cfg.model, device=device)
    model.load_state_dict(state)
    with torch.no_grad():
        model.joint.project_layer.bias[0] += offset       # phase 4's bias
    n_layer = cfg.model.enc.n_layer
    left, right = cfg.model.enc.left_context, cfg.model.enc.right_context
    scfg = lambda: StreamingConfig.from_config(cfg)
    waves = synthetic_waves(4, seed=1)                    # 60-410 frames, 1.8-12.3 s

    def batched(n, incremental=False):
        return record_rounds(BatchedStreamingSession(model, scfg(), n, device=device,
                                                     incremental=incremental))

    def fed(session, wavs):
        for i, w in enumerate(wavs):
            session.accept_waveform(i, w)
            session.finalize(i)
        return session

    def solo(wave):
        s = record_windows(StreamingSession(model, scfg(), device=device))
        feed_stream(s, wave, None)
        return s

    def drained(what, session):
        """Drain ``session`` with the counts from 0: 18 kernel-6 launches an
        encoder call (none in the incremental rounds) and nothing else."""
        reset_counts()
        session.run_to_completion()
        torch.cuda.synchronize()
        got = read_counts()
        want = dict.fromkeys(got, 0)
        want["banded_fwd"] = 0 if session.incremental else n_layer * session.encode_calls
        require(got == want, f"{what}: launches {got}, want {want}")
        require(session.host_reads <= session.read_bound,
                f"{what}: {session.host_reads} host reads, bound {session.read_bound}")
        require(sum(len(st.result) for st in session.streams) > 0, f"{what}: no tokens")
        for st in session.streams:
            require(0 not in st.result and len(st.timestamps) == len(st.result)
                    and all(np.isfinite(st.confidences)), f"{what}: malformed output")
        log(f"  {what}: {[len(st.result) for st in session.streams]} tokens, "
            f"{session.rounds} rounds, {session.windows} windows in {session.encode_calls} "
            f"encoder calls, {session.host_reads} host reads (bound {session.read_bound})")
        return session

    scfg_full = scfg()
    scfg_full.ensure_lengths()
    log(f"multi-stream serving at full width (window_len {scfg_full.window_len}, chunk_len "
        f"{scfg_full.chunk_len}, {len(waves)} streams of "
        f"{', '.join(f'{len(w) / 16000:.2f}' for w in waves)} s):")

    # the main path: the serving CLI over the 4 waves, the counts from 0
    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = os.path.join(tmp, "vocab.txt")
        Vocabulary.from_symbols([chr(0x4E00 + i) for i in range(cfg.model.vocab_size - 2)]
                                + ["<unk>"]).save(vocab_path)
        cli_cfg = load_flagship()
        cli_cfg.override("data.vocab", vocab_path)
        cfg_path = os.path.join(tmp, "config.yaml")
        dump_config(cli_cfg, cfg_path)
        torch.save(model.state_dict(), os.path.join(tmp, "model.pt"))
        paths = []
        for i, w in enumerate(waves):
            paths.append(os.path.join(tmp, f"utt{i}.wav"))
            write_wave(paths[-1], w)
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            serve.main(["--config", cfg_path, "--checkpoint", os.path.join(tmp, "model.pt"),
                        "--wavs", *paths, "--streams", str(len(paths)), "--json",
                        "--device", str(device)])
        torch.cuda.synchronize()
        cli_counts = read_counts()
    cli = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
    log(f"  serve CLI (--streams {len(paths)} --json): {[len(r['tokens']) for r in cli]} "
        f"tokens; launches {cli_counts}")

    # the same through the library: 18 kernel-6 launches an encoder call
    window = drained("window rounds, drained", fed(batched(4), waves))
    want = dict.fromkeys(cli_counts, 0)
    want["banded_fwd"] = n_layer * window.encode_calls
    require(cli_counts == want and want["banded_fwd"] > 0,
            f"serve CLI: launches {cli_counts}, want {want}")
    require([r["tokens"] for r in cli] == [st.result for st in window.streams],
            "serve CLI: tokens differ from the batched session's on the same waves")
    views = utterance_views(window)
    solos = [solo(w) for w in waves]
    for i, (got, ref) in enumerate(zip(views, solos)):
        compare_streams(f"stream {i}, batched window vs solo window", got, ref)
    inc = drained("incremental rounds, drained", fed(batched(4, incremental=True), waves))
    for i, (got, ref) in enumerate(zip(utterance_views(inc), views)):
        compare_streams(f"stream {i}, batched incremental vs batched window", got, ref)
    # round by round against the drain, with the reads of each round
    for incremental, drain in ((False, window), (True, inc)):
        s = fed(batched(4, incremental), waves)
        worst = 0
        while True:
            reads, rounds = s.host_reads, s.rounds
            new = s.process()
            if s.rounds == rounds:
                break
            worst = max(worst, s.host_reads - reads - 1 - max(map(len, new)))
        mode = "incremental" if incremental else "window"
        log(f"  {mode}, round by round: {s.rounds} rounds, {s.encode_calls} encoder calls, "
            f"host reads a round - (1 + the most emissions of one stream) at most {worst}")
        require(worst <= 0, f"{mode} round by round: a round read the card {worst} times "
                            "more than 1 + its most emissions of one stream")
        for i, (got, ref) in enumerate(zip(utterance_views(s), utterance_views(drain))):
            compare_streams(f"stream {i}, {mode} round by round vs drained", got, ref)
    # continuous batching: 5 utterances through 2 slots against solo sessions
    utts = synthetic_waves(5, seed=2)
    utt_solos = [solo(w) for w in utts]
    for incremental in (False, True):
        s = batched(2, incremental)
        results = s.serve_files(utts)
        mode = "incremental" if incremental else "window"
        log(f"  serve_files, {mode}: 5 utterances through 2 slots, {s.last_stats['rounds']} "
            f"rounds, slot utilization {s.last_stats['slot_utilization']:.3f}")
        for k, (got, ref) in enumerate(zip(utterance_views(s, results, s.last_meta),
                                           utt_solos)):
            compare_streams(f"utterance {k}, serve_files ({mode}) vs solo window", got, ref)
    # the plain versions on the same streams
    with plain_versions():
        reset_counts()
        s = fed(batched(4), waves)
        s.run_to_completion()
        require(not any(read_counts().values()), "plain batched session launched")
    for i, (got, ref) in enumerate(zip(views, utterance_views(s))):
        compare_streams(f"stream {i}, batched window kernel vs plain", got, ref)
    stream_launches = cli_counts["banded_fwd"]

    # kernel 6 at the shapes of a round (8 windows) and of a drain group
    # (16 rounds of 8): against its plain version, two launches to the bit
    rec, worst = {"serving_launches": stream_launches}, 0.0
    for b in (8, 128):
        args = attention_inputs(STREAM_T, 410, gen, b=b)
        with torch.no_grad():
            got = banded_attention(*args, left, right)
            again = banded_attention(*args, left, right)
            ref = banded_attention_plain(*args, left, right)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, **KERNEL_TOL)
        require(torch.equal(got, again), f"banded B={b} T={STREAM_T}: two launches differ")
        worst = max(worst, err)
        with torch.no_grad():
            ms = graph_ms(lambda: banded_attention(*args, left, right))
        plain_ms = cuda_ms(lambda: banded_attention_plain(*args, left, right))
        bound_ms, by = bound(STREAM_T, band_cells(STREAM_T, left, right), b=b)
        rec.update({f"ms_t{STREAM_T}_b{b}": ms, f"plain_ms_t{STREAM_T}_b{b}": plain_ms,
                    f"bound_t{STREAM_T}_b{b}_ms": bound_ms})
        log(f"  banded_attention_fwd (B={b}, T={STREAM_T}): max|err| {err:.3e}, two launches "
            f"bit-identical; kernel {ms:.4f} ms (alone, CUDA graph), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({by}), {100 * bound_ms / ms:.1f} % of bound")
    rec["max_abs_err_serving"] = worst

    # timings (host clock around work that ends in a synchronise)
    log(f"serving timings on {smi}:")
    summary = {}
    step = scfg_full.audio_step
    live = synthetic_waves(8, seed=3, frames=[1100] * 8)          # 33 s each
    for incremental in (False, True):
        mode = "incremental" if incremental else "window"
        s = BatchedStreamingSession(model, scfg(), 8, incremental=incremental, device=device)
        lat, busy_rounds = [], 0
        for r in range(33):
            for i, w in enumerate(live):
                s.accept_waveform(i, w[r * step:(r + 1) * step])
            torch.cuda.synchronize()
            rounds, start = s.rounds, time.perf_counter()
            s.process()
            torch.cuda.synchronize()
            if r >= 3:                                            # 3 rounds of warm-up
                lat.append((time.perf_counter() - start) * 1e3)
                busy_rounds += s.rounds > rounds
        p50, p95, p99 = (float(np.percentile(lat, q)) for q in (50, 95, 99))
        summary[f"live_{mode}"] = {"round_ms_p50": p50, "round_ms_p95": p95,
                                   "round_ms_p99": p99, "rounds_timed": len(lat),
                                   "rounds_with_work": busy_rounds,
                                   "round_ms": [round(x, 2) for x in lat]}
        log(f"  live cadence, {mode}: 8 streams, one audio step ({step} samples) each a "
            f"round, {len(lat)} rounds timed ({busy_rounds} decoded): round latency p50 "
            f"{p50:.2f} ms, p95 {p95:.2f} ms, p99 {p99:.2f} ms")
    long = synthetic_waves(8, seed=4, frames=[1001] * 8)          # 30 s each
    long_s = sum(len(w) for w in long) / 16000.0
    for incremental in (False, True):
        mode = "incremental" if incremental else "window"
        s = BatchedStreamingSession(model, scfg(), 8, incremental=incremental, device=device)

        def drain(s=s):
            s.reset()
            fed(s, long).run_to_completion()
        ms = host_ms({mode: drain}, samples=2)[mode]
        best = min(ms)
        busy = device_busy_ms(drain)
        parts = serving_split(s, drain)
        summary[f"drain_{mode}"] = {
            "best_ms": best, "ms": ms, "x_realtime": long_s / (best / 1e3),
            "device_busy_ms": busy, "idle_share": 1 - busy / best if busy > 0 else None,
            "rounds": s.rounds, "encode_calls": s.encode_calls,
            "host_reads": s.host_reads, "read_bound": s.read_bound, "split_ms": parts}
        share = (f"{100 * (1 - busy / best):.1f} %" if busy > 0
                 else "not measured (the profiler saw no device time)")
        log(f"  drain, {mode}: 8 streams x 30 s ({long_s:.2f} s) in {best:.2f} ms (best of "
            f"2, {[round(x, 2) for x in ms]}), {long_s / (best / 1e3):.1f}x real time; device "
            f"busy {busy:.2f} ms, idle share {share}; {s.rounds} rounds, {s.encode_calls} "
            f"encoder calls, {s.host_reads} host reads; split (synchronised) "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items()))
    # continuous batching against gang scheduling: per group of 8, one 30 s
    # utterance and seven 8 s ones
    skewed = synthetic_waves(16, seed=5, frames=([1001] + [268] * 7) * 2)
    skewed_s = sum(len(w) for w in skewed) / 16000.0
    s = BatchedStreamingSession(model, scfg(), 8, device=device)
    use = {}

    def gang():
        rounds = windows = 0
        for base in range(0, len(skewed), 8):
            s.reset()
            fed(s, skewed[base:base + 8]).run_to_completion()
            rounds, windows = rounds + s.rounds, windows + s.windows
        use["gang"] = windows / (rounds * 8)

    def continuous():
        s.serve_files(skewed)
        use["continuous"] = s.windows / (s.rounds * 8)
        use["continuous_slots"] = s.last_stats["slot_utilization"]
    times = host_ms({"gang": gang, "continuous": continuous}, samples=2)
    for name, run in (("gang", gang), ("continuous", continuous)):
        best = min(times[name])
        parts = serving_split(s, run)
        summary[name] = {"best_ms": best, "ms": times[name],
                         "x_realtime": skewed_s / (best / 1e3),
                         "utterances_per_s": len(skewed) / (best / 1e3),
                         "stream_rounds_with_work": use[name], "split_ms": parts}
        log(f"  {name}: 16 utterances ({skewed_s:.2f} s) through 8 slots in {best:.2f} ms "
            f"(best of 2), {skewed_s / (best / 1e3):.1f}x real time, "
            f"{len(skewed) / (best / 1e3):.2f} utterances/s; share of slot-rounds with a "
            f"window {use[name]:.3f}; split (synchronised) "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items()))
    summary["continuous"]["slot_utilization"] = use["continuous_slots"]
    log(f"  continuous slot_utilization (serve_files, 4 rounds a call) "
        f"{use['continuous_slots']:.3f}")
    del model
    torch.cuda.empty_cache()
    return rec, summary


def check_head_width_32(device):
    """Phase 6c: ``artifacts/tone_small/config.yaml`` (2 heads x 32) with
    seeded random weights: 3 ``--flash`` and 3 ``--banded`` steps through the
    kernels and through the plain versions (losses within 1e-4, step 1's
    gradient norm within 1e-3, relative; 2 attention forward and 2 backward
    launches a step), then ``recognize`` under the band and at full context
    against the plain path (encoder states within 1e-3, tokens identical or
    a tie)."""
    import torch
    from transformer_transducer_tpu_torch.decoding.greedy import recognize
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops.masks import context_mask
    from transformer_transducer_tpu_torch.utils.config import Config
    from transformer_transducer_tpu_torch.utils.convert import (
        from_jax_params, random_jax_params)
    cfg = load_config("artifacts", "tone_small", "config.yaml")
    require(cfg.model.enc.d_head == 32, "the tone config is not at head width 32")
    n_layer = cfg.model.enc.n_layer
    state = from_jax_params(random_jax_params(cfg.model, seed=0))
    optim_cfg = Config({"type": "sgd", "lr": cfg.optim.lr, "momentum": 0.9})
    batch, _ = training_batch(cfg, device, seed=2)
    log(f"head width 32 ({cfg.model.enc.n_layer} encoder layers, "
        f"{cfg.model.enc.n_head} heads x {cfg.model.enc.d_head}): batch of {B_TRAIN}, "
        f"frames {batch['inputs_length'].tolist()}")
    for mode in ("flash", "banded"):
        kern = train_three_steps(cfg.model, optim_cfg, state, mode, batch, device,
                                 plain=False)
        plain = train_three_steps(cfg.model, optim_cfg, state, mode, batch, device,
                                  plain=True)
        want = dict.fromkeys(read_counts(), 0)
        want.update({f"{mode}_fwd": n_layer, f"{mode}_bwd": n_layer}, alpha=1, beta=1)
        for i, ((lk, nk, ck), (lp, norm_p, cp)) in enumerate(zip(kern, plain)):
            rel = abs(lk - lp) / abs(lp)
            log(f"  Dh 32 {mode} step {i + 1}: loss kernel {lk:.6f} / plain {lp:.6f} "
                f"(rel {rel:.2e}), grad norm {nk:.5f} / {norm_p:.5f}")
            require(ck == want, f"Dh 32 {mode} step {i + 1}: launches {ck}, want {want}")
            require(not any(cp.values()), f"Dh 32 {mode} plain step launched {cp}")
            require(rel <= LOSS_RTOL, f"Dh 32 {mode} step {i + 1}: losses differ by {rel:.2e}")
        rel = abs(kern[0][1] - plain[0][1]) / abs(plain[0][1])
        log(f"  Dh 32 {mode}: step 1 grad norm rel diff {rel:.2e} (tolerance {NORM_RTOL})")
        require(rel <= NORM_RTOL, f"Dh 32 {mode}: step 1 grad norms differ by {rel:.2e}")

    models = {}
    for flash in (False, True):
        models[flash] = build_transducer(cfg.model, flash=flash, device=device)
        models[flash].load_state_dict(state)
    x, t_len = batch["inputs"], batch["inputs_length"].cpu().numpy()
    tlen = x.shape[1]
    band = (cfg.model.enc.left_context, cfg.model.enc.right_context)
    max_tokens = cfg.data.max_target_length + 1
    mask = context_mask(tlen, *band, device=device)
    reset_counts()
    toks = {"band": recognize(models[False], x, t_len, band=band, max_tokens=max_tokens),
            "full-context": recognize(models[True], x, t_len, max_tokens=max_tokens)}
    torch.cuda.synchronize()
    counts = read_counts()
    require(counts["banded_fwd"] == n_layer and counts["flash_fwd"] == n_layer,
            f"Dh 32 recognize did not run the attention kernels once a layer: {counts}")
    toks_p = {"band": recognize(models[False], x, t_len, audio_mask=mask,
                                max_tokens=max_tokens),
              "full-context": recognize(models[False], x, t_len, max_tokens=max_tokens)}
    with torch.no_grad():
        encs = {"band": (models[False].encode_banded(x, *band), models[False].encode(x, mask)),
                "full-context": (models[True].encode(x), models[False].encode(x))}
    for name, (enc_k, enc_p) in encs.items():
        err = (enc_k - enc_p).abs().max().item()
        log(f"  Dh 32 {name}: encoder states kernel vs plain max|err| {err:.3e} "
            f"(tolerance {ENC_TOL})")
        require(bool(torch.isfinite(enc_k).all()) and err <= ENC_TOL,
                f"Dh 32 {name}: encoder states differ by {err}")
        compare_tokens(f"Dh 32 {name}", toks[name], toks_p[name], models[False],
                       enc_k, enc_p, t_len, max_tokens)


def write_corpus(root, cfg, base=None) -> str:
    """16 train and 8 dev synthetic waves with random labels over a vocabulary
    of ``vocab_size`` symbols (of the espnet ``joint.vocab_size``: the labels
    never sos), and the flagship config (or ``base``) pointing at them;
    returns the config's path."""
    import numpy as np
    from transformer_transducer_tpu_torch.data.wav import write_wave
    from transformer_transducer_tpu_torch.utils.config import dump_config
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary
    chars = [chr(0x4E00 + i) for i in range((cfg.model.vocab_size
                                             or cfg.model.joint.vocab_size) - 2)]
    vocab_path = os.path.join(root, "vocab.txt")
    Vocabulary.from_symbols(chars + ["<unk>"]).save(vocab_path)
    rng = np.random.default_rng(3)
    cli_cfg = load_flagship() if base is None else base
    cli_cfg.override("data.vocab", vocab_path)
    for split, n, seed in (("train", 16, 2), ("dev", 8, 3)):
        lines = ["file_path,label"]
        for i, wave in enumerate(synthetic_waves(n, seed)):
            path = os.path.join(root, f"{split}_{i}.wav")
            write_wave(path, wave)
            n_tok = int(rng.integers(5, cfg.data.max_target_length + 1))
            lines.append(path + "," + "".join(rng.choice(chars, n_tok)))
        csv_path = os.path.join(root, f"{split}.csv")
        with open(csv_path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
        cli_cfg.override(f"data.{split}", csv_path)
    cli_cfg.override("data.test", cli_cfg.data.dev)
    cfg_path = os.path.join(root, "config.yaml")
    dump_config(cli_cfg, cfg_path)
    return cfg_path


def split_step(model, opt, batch, gen, samples: int = 5) -> dict:
    """Median host ms of a train step's phases, each ended by a synchronise:
    encoder forward (SpecAugment + ``encode_both``), loss forward (the fused
    joint and the lattice), backward, optimizer (gradient norm + update)."""
    import torch
    from transformer_transducer_tpu_torch.ops.rnnt_loss import rnnt_loss_fused
    from transformer_transducer_tpu_torch.ops.specaug import spec_augment
    from transformer_transducer_tpu_torch.training.optim import global_norm
    from transformer_transducer_tpu_torch.training.train_step import TrainStepConfig
    cfg = TrainStepConfig()
    names = ("encoder forward", "loss forward", "backward", "optimizer")
    times = {n: [] for n in names}
    for r in range(samples + 1):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        model.train()
        for p in opt.params:
            p.grad = None
        x = spec_augment(gen, batch["inputs"], cfg.max_mask_time,
                         cfg.max_mask_frequency, cfg.mask_num)
        enc, dec = model.encode_both(x, batch["targets"])
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        loss = rnnt_loss_fused(enc, dec, model.joint_params(), batch["targets"],
                               batch["inputs_length"], batch["targets_length"],
                               chunk_size=cfg.loss_chunk_size, remat=cfg.loss_remat)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in opt.params]
        global_norm(grads)
        opt.step(grads)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if r:                                   # round 0 warms up
            for name, a, b in zip(names, marks, marks[1:]):
                times[name].append((b - a) * 1e3)
    return {n: statistics.median(v) for n, v in times.items()}


def split_pruned_step(model, opt, batch, gen, samples: int = 5) -> dict:
    """Median host ms of a pruned train step's phases (``--pruned-range
    5``, simple scale 0.25), each ended by a synchronise: encoder forward,
    simple stage (linearized grids, logZ, the alpha and beta sweeps), bounds
    (the band starts' clip scan), banded joint, band DP (alpha sweep and
    loss), backward, optimizer."""
    import torch
    from transformer_transducer_tpu_torch.ops import rnnt_loss_pruned as rp
    from transformer_transducer_tpu_torch.ops.specaug import spec_augment
    from transformer_transducer_tpu_torch.training.optim import global_norm
    from transformer_transducer_tpu_torch.training.train_step import TrainStepConfig
    cfg = TrainStepConfig(loss_pruned_range=S_RANGE)
    names = ("encoder forward", "simple stage", "bounds", "banded joint",
             "band DP", "backward", "optimizer")
    times = {n: [] for n in names}
    labels = batch["targets"]
    for r in range(samples + 1):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        model.train()
        for p in opt.params:
            p.grad = None
        x = spec_augment(gen, batch["inputs"], cfg.max_mask_time,
                         cfg.max_mask_frequency, cfg.mask_num)
        enc, dec = model.encode_both(x, labels)
        mark()
        jp = model.joint_params()
        t_len = torch.clamp(batch["inputs_length"], max=enc.shape[1])
        u_len = torch.clamp(batch["targets_length"], max=dec.shape[1] - 1)
        sp_b, sp_l = rp.simple_grid_logprobs(enc, dec, jp, labels)
        simple, occ = rp.simple_loss_and_occ(sp_b, sp_l, t_len, u_len)
        mark()
        rs = rp.bounds_from_occ(occ, t_len, u_len, S_RANGE)
        mark()
        lp_b, lp_l = rp.banded_grid_logprobs(enc, dec, jp, labels, rs, u_len, S_RANGE,
                                             chunk_size=cfg.loss_chunk_size)
        mark()
        loss = (rp.rnnt_loss_banded(lp_b, lp_l, rs, t_len, u_len)
                + cfg.loss_simple_scale * simple).mean()
        mark()
        loss.backward()
        mark()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in opt.params]
        global_norm(grads)
        opt.step(grads)
        mark()
        if r:                                   # round 0 warms up
            for name, a, b in zip(names, marks, marks[1:]):
                times[name].append((b - a) * 1e3)
    return {n: statistics.median(v) for n, v in times.items()}


# ---- a msgpack writer in flax's format (the card's machine has no flax)

def _msgpack_head(out, n, fixed, fix_limit, sized):
    """A container or string header: the fix form below ``fix_limit``, else
    the first of ``sized`` ((type byte, struct format, limit), ...) that
    holds ``n``."""
    if fixed is not None and n < fix_limit:
        out.append(bytes([fixed | n]))
        return
    for code, fmt, limit in sized:
        if n < limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack length {n} too large")


def _msgpack_ext(out, code, payload):
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixext:
        out.append(bytes([fixext[len(payload)], code]))
    else:
        _msgpack_head(out, len(payload), None, 0,
                      ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32)))
        out.append(bytes([code]))
    out.append(payload)


def _msgpack_array_payload(arr) -> bytes:
    """flax's ndarray payload ``(shape, dtype name, C-order bytes)``; a
    ``torch.bfloat16`` tensor is written as flax writes a JAX bfloat16 leaf."""
    import numpy as np
    if type(arr).__module__.startswith("torch"):
        import torch
        if arr.dtype != torch.bfloat16:
            raise TypeError(f"only bfloat16 tensors are written, not {arr.dtype}")
        bits = arr.detach().cpu().contiguous().view(torch.int16).numpy()
        return msgpack_bytes([list(bits.shape), "bfloat16", bits.tobytes("C")])
    arr = np.asarray(arr)
    return msgpack_bytes([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _msgpack_pack(obj, out) -> None:
    import numpy as np
    kind = type(obj)
    if kind is int:
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out.append(struct.pack(">b" if obj < 0 else ">B", obj))
        else:
            forms = ((0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16),
                     (0xCE, ">I", 0, 1 << 32), (0xCF, ">Q", 0, 1 << 64)) if obj > 0 else \
                    ((0xD0, ">b", -(1 << 7), 0), (0xD1, ">h", -(1 << 15), 0),
                     (0xD2, ">i", -(1 << 31), 0), (0xD3, ">q", -(1 << 63), 0))
            code, fmt = next((c, f) for c, f, lo, hi in forms if lo <= obj < hi)
            out.append(bytes([code]) + struct.pack(fmt, obj))
    elif kind is str:
        raw = obj.encode("utf-8")
        _msgpack_head(out, len(raw), 0xA0, 32,
                      ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32)))
        out.append(raw)
    elif kind is bytes:
        _msgpack_head(out, len(obj), None, 0,
                      ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32)))
        out.append(obj)
    elif kind in (list, tuple):
        _msgpack_head(out, len(obj), 0x90, 16, ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)))
        for x in obj:
            _msgpack_pack(x, out)
    elif kind is dict:
        _msgpack_head(out, len(obj), 0x80, 16, ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)))
        for key, value in obj.items():
            _msgpack_pack(key, out)
            _msgpack_pack(value, out)
    elif isinstance(obj, np.ndarray) or kind.__module__.startswith("torch"):
        _msgpack_ext(out, 1, _msgpack_array_payload(obj))
    else:
        raise TypeError(f"no msgpack form for {kind.__name__}")


def msgpack_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes`` of a state dict (nested dicts with
    string keys; numpy arrays, 0-d ones too, ``torch.bfloat16`` tensors,
    ints, str, bytes, lists): the same bytes, from a pure-Python msgpack
    writer.  Leaves over 2**30 bytes (which flax chunks) are not written."""
    out = []
    _msgpack_pack(tree, out)
    return b"".join(out)


def write_jax_checkpoint(path, params, opt_state=None, meta=None) -> str:
    """A checkpoint directory as the JAX package's ``save_checkpoint``
    writes it: ``{encoder,decoder,joint}.msgpack``, optionally
    ``optimizer.msgpack``, and ``meta.json``."""
    os.makedirs(path, exist_ok=True)
    files = {f"{comp}.msgpack": params[comp] for comp in ("encoder", "decoder", "joint")}
    if opt_state is not None:
        files["optimizer.msgpack"] = opt_state
    for name, tree in files.items():
        with open(os.path.join(path, name), "wb") as fh:
            fh.write(msgpack_bytes(tree))
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump({"epoch": 0, "step": 0, **(meta or {})}, fh)
    return path


def sgd_state(params, lr, count, momentum_scale, seed):
    """The optax state tree (as flax saves it) of the JAX trainer's SGD
    with momentum and a clip: ``chain(clip, inject_hyperparams(chain(
    identity, trace, scale)))``, the trace seeded random of the
    parameters' layout."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def trace(node):
        if isinstance(node, dict):
            return {k: trace(v) for k, v in node.items()}
        return (rng.standard_normal(node.shape) * momentum_scale).astype(np.float32)

    return {"0": {}, "1": {"count": np.asarray(count, np.int32),
                           "hyperparams": {"learning_rate": np.asarray(lr, np.float32)},
                           "hyperparams_states": {},
                           "inner_state": {"0": {}, "1": {"trace": trace(params)},
                                           "2": {}}}}


def check_slice_6a(cfg, state, offset, phase4, device, smi):
    """Phase 11: what the JAX package trained, on the card.  (a) A
    flagship checkpoint in the JAX package's msgpack format through
    ``apps/predict.py`` (band and full context) and a ``-mode continue``
    epoch from a JAX ``epoch_0`` with an SGD momentum trace; (b) the
    on-device log-mel against the host pipeline, and its time; (c) 3
    ``--flash`` steps on raw waves against the host-feature steps, and an
    epoch of ``--flash --augment`` with ``data.on_device_features``.
    ``phase4`` holds phase 4's batch ``x`` and its tokens by mode.  Returns
    the launches of its main paths by kernel and the summary."""
    import numpy as np
    import torch
    from transformer_transducer_tpu_torch.apps import predict as predict_app
    from transformer_transducer_tpu_torch.apps import train as train_app
    from transformer_transducer_tpu_torch.data.dataset import pad_raw_wave
    from transformer_transducer_tpu_torch.data.wav import write_wave
    from transformer_transducer_tpu_torch.decoding.greedy import recognize
    from transformer_transducer_tpu_torch.models.factory import load_family
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.ops.features import (
        extract_batch_padded, padded_wave_samples)
    from transformer_transducer_tpu_torch.utils.config import (
        Config, load_config as load_cfg_file, stack_context, subsample_factor)
    from transformer_transducer_tpu_torch.utils.convert import random_jax_params
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary
    n_layer = cfg.model.enc.n_layer
    n_mels = cfg.data.feature_dim
    left, right = stack_context(cfg.data)
    factor = subsample_factor(cfg.data)
    band = (cfg.model.enc.left_context, cfg.model.enc.right_context)
    max_tokens = cfg.data.max_target_length + 1
    launches = collections.Counter()
    summary = {"card": smi}
    waves = synthetic_waves(8, seed=0)                  # phase 4's
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = write_corpus(tmp, cfg)
        vocab = Vocabulary.from_file(load_cfg_file(cfg_path).data.vocab)

        # (a) phase 4's weights and blank bias as the JAX package saves them;
        # a LayerNorm scale (ones, exact in bfloat16) as a bfloat16 leaf
        start = time.perf_counter()
        tree = random_jax_params(cfg.model, seed=0)
        tree["joint"]["project_layer"]["bias"][0] += offset
        ln = tree["encoder"]["layer_0"]["attn"]["ln"]
        ln["scale"] = torch.from_numpy(ln["scale"]).to(torch.bfloat16)
        ckpt = write_jax_checkpoint(os.path.join(tmp, "jax_epoch"), tree,
                                    meta={"epoch": 0, "step": 0})
        size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        write_s = time.perf_counter() - start
        models = {}
        for flash in (False, True):
            models[flash] = build_transducer(cfg.model, flash=flash, device=device).eval()
            models[flash].load_state_dict(state)
            with torch.no_grad():
                models[flash].joint.project_layer.bias[0] += offset
        start = time.perf_counter()
        loaded = load_family(load_cfg_file(cfg_path), n_mels * (1 + left + right), ckpt,
                             device=device)
        load_s = time.perf_counter() - start
        require(all(torch.equal(a, b) for a, b in zip(models[False].state_dict().values(),
                                                       loaded.state_dict().values())),
                "the JAX-format checkpoint did not restore phase 4's weights")
        del loaded
        log(f"JAX-format checkpoint ({size / 2 ** 20:.1f} MiB, one bfloat16 leaf): written "
            f"in {write_s:.1f} s, read by load_family in {load_s:.2f} s; the weights are "
            "phase 4's")
        predict_ms = []
        for u in (len(waves) - 1, 0):                   # 410 and 60 frames
            wav = os.path.join(tmp, f"phase4_{u}.wav")
            write_wave(wav, waves[u])
            feats = F.subsample(F.stack_frames(F.logmel_masked(waves[u], 16000, n_mels),
                                               left, right), factor)
            x = torch.from_numpy(feats[None]).to(device)
            for name, flash, kernel in (("band", False, "banded_fwd"),
                                        ("full-context", True, "flash_fwd")):
                reset_counts()
                start = time.perf_counter()
                text = predict_app.main(["--config", cfg_path, "--checkpoint", ckpt,
                                         "--wav", wav] + (["--full-context"] if flash else []))
                torch.cuda.synchronize()
                predict_ms.append(1e3 * (time.perf_counter() - start))
                counts = read_counts()
                want = recognize(models[flash], x, [feats.shape[0]],
                                 band=None if flash else band, max_tokens=max_tokens)[0]
                log(f"  apps/predict.py --checkpoint <JAX dir> ({name}), utterance {u} "
                    f"({feats.shape[0]} frames): {len(text)} characters, launches {counts}")
                require(text == "".join(vocab.decode(want)),
                        f"{name}: predict gave {text!r}, phase 4's model "
                        f"{''.join(vocab.decode(want))!r}")
                require(counts[kernel] == n_layer and sum(counts.values()) == n_layer,
                        f"{name}: predict launched {counts}, want {n_layer} {kernel}")
                launches[kernel] += counts[kernel]
                if u == len(waves) - 1:                 # unpadded in phase 4's batch
                    # B 1 against phase 4's B 8: the same tokens, or a tie
                    encode = (models[True].encode if flash else
                              functools.partial(models[False].encode_banded, left=band[0],
                                                right=band[1]))
                    with torch.no_grad():
                        enc_1, enc_8 = encode(x), encode(phase4["x"])[u:u + 1]
                    compare_tokens(f"{name}, B 1 against phase 4's batch", [want],
                                   [phase4[name][u]], models[False], enc_1, enc_8,
                                   [feats.shape[0]], max_tokens)
        summary["predict_ms"] = predict_ms
        del models
        torch.cuda.empty_cache()

        # a -mode continue epoch from a JAX epoch_0 with a momentum trace
        exp = os.path.join(tmp, "egs", cfg.data.name, "jax_format")
        params = random_jax_params(cfg.model, seed=0)
        opt = sgd_state(params, cfg.optim.lr, 4, 1e-4, seed=5)
        write_jax_checkpoint(os.path.join(exp, "epoch_0"), params, opt,
                             {"epoch": 0, "step": 4, "lr": cfg.optim.lr})
        del params, opt
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            start = time.perf_counter()
            cont = train_app.main(["-config", cfg_path, "--flash", "-mode", "continue",
                                   "--epochs", "2", "--set", "training.save_model=jax_format"])
            torch.cuda.synchronize()
            cont_s = time.perf_counter() - start
            counts = read_counts()
        finally:
            os.chdir(cwd)
        with open(os.path.join(exp, "metrics.jsonl"), encoding="utf-8") as fh:
            cers = [r["value"] for r in map(json.loads, fh) if r["tag"] == "cer"]
        log(f"apps/train.py --flash -mode continue from a JAX-format epoch_0 (SGD trace, "
            f"count 4): epoch 1 in {cont_s:.1f} s, step {cont.global_step}, optimizer "
            f"count {cont.optimizer.count}, CER {cers}, launches {counts}")
        require(cont.start_epoch == 1 and cont.global_step == 8 and cont.optimizer.count == 8,
                f"continue from the JAX format: epoch {cont.start_epoch}, step "
                f"{cont.global_step}, count {cont.optimizer.count}")
        require(len(cers) == 1 and all(np.isfinite(cers))
                and os.path.exists(os.path.join(exp, "epoch_1", "model.pt")),
                f"continue from the JAX format: CER {cers}, or no epoch_1")
        require(counts["flash_bwd"] == 4 * n_layer and counts["alpha"] > 0
                and counts["banded_fwd"] == 0, f"continue launched {counts}")
        summary.update(continue_s=cont_s, continue_cer=cers[0])
        launches.update(counts)
        del cont
        torch.cuda.empty_cache()

        # (b) the on-device log-mel of phase 4's 8 waves against the host
        cap, total = padded_wave_samples(cfg.data.max_input_length, factor)
        t_max = cfg.data.max_input_length
        start = time.perf_counter()
        host = [F.subsample(F.stack_frames(F.logmel_eps(w, 16000, n_mels), left, right),
                            factor)[:t_max] for w in waves]
        host_ms = 1e3 * (time.perf_counter() - start)
        frontend = {"host_ms": host_ms}
        for dtype in ("int16", "float32"):
            padded = [pad_raw_wave(w.astype(dtype), cap, total) for w in waves]
            x = torch.from_numpy(np.stack([p[0] for p in padded])).to(device)
            n = torch.tensor([int(p[1]) for p in padded], device=device)
            run = functools.partial(extract_batch_padded, x, n, t_max, n_mels=n_mels,
                                    left=left, right=right, factor=factor)
            feats, t_len = run()
            ms = cuda_ms(run)
            err, ok = 0.0, True
            for i, ref in enumerate(host):
                require(int(t_len[i]) == len(ref), f"{dtype}: t_len {int(t_len[i])} != "
                        f"{len(ref)} for utterance {i}")
                got = feats[i, :len(ref)].cpu().numpy()
                err = max(err, float(np.abs(got - ref).max()))
                ok &= bool(np.allclose(got, ref, rtol=2e-3, atol=2e-3))
                ok &= not bool(feats[i, len(ref):].any())
            log(f"  extract_batch_padded on the card, 8 {dtype} waves ({x.shape[1]} samples "
                f"each): {ms:.3f} ms (CUDA events), host pipeline {host_ms:.1f} ms for the "
                f"same batch; max|err| {err:.3e} against features_np (rtol = atol = 2e-3), "
                f"t_len exact")
            require(ok, f"{dtype}: the on-device frontend differs from the host's ({err})")
            frontend[f"{dtype}_ms"], frontend[f"{dtype}_max_abs_err"] = ms, err
        summary["frontend"] = frontend
        del x, feats

        # (c) 3 --flash steps on raw waves against the host-feature steps
        model_cfg0 = load_flagship().model
        model_cfg0.override("dropout", 0.0)
        optim_cfg = Config({"type": "sgd", "lr": cfg.optim.lr, "momentum": 0.9})
        raw_batch, _ = training_batch(cfg, device, seed=1, raw=True)
        host_batch, _ = training_batch(cfg, device, seed=1)
        fe = (n_mels, left, right, factor, t_max, "eps")
        odf = train_three_steps(model_cfg0, optim_cfg, state, "flash", raw_batch, device,
                                plain=False, frontend=fe)
        ref = train_three_steps(model_cfg0, optim_cfg, state, "flash", host_batch, device,
                                plain=False)
        want = dict.fromkeys(read_counts(), 0)
        want.update(flash_fwd=n_layer, flash_bwd=n_layer, alpha=1, beta=1)
        rels = []
        for i, ((lo, no, co), (lh, nh, _)) in enumerate(zip(odf, ref)):
            rel = abs(lo - lh) / abs(lh)
            rels.append(rel)
            log(f"  on-device features step {i + 1}: loss {lo:.6f} / host features "
                f"{lh:.6f} (rel {rel:.2e}, tolerance 2e-3), grad norm {no:.5f} / "
                f"{nh:.5f}; launches {co}")
            require(co == want, f"on-device features step {i + 1}: launches {co}")
            require(rel <= 2e-3, f"on-device features step {i + 1}: losses differ by {rel}")
            launches.update(co)
        summary["odf_loss_rel"] = rels
        torch.cuda.empty_cache()

        # an epoch of --flash --augment on raw waves through the entry point
        os.chdir(tmp)
        try:
            reset_counts()
            start = time.perf_counter()
            aug = train_app.main(["-config", cfg_path, "--flash", "--augment", "--epochs",
                                  "1", "--set", "data.on_device_features=true",
                                  "--set", "training.save_model=augment_odf"])
            torch.cuda.synchronize()
            aug_s = time.perf_counter() - start
            counts = read_counts()
        finally:
            os.chdir(cwd)
        exp = os.path.join(tmp, aug.exp_dir)
        with open(os.path.join(exp, "metrics.jsonl"), encoding="utf-8") as fh:
            rows = [r for r in map(json.loads, fh)]
        cers = [r["value"] for r in rows if r["tag"] == "cer"]
        losses = [r["value"] for r in rows if r["tag"] == "train_loss"]
        log(f"apps/train.py --flash --augment, data.on_device_features: 1 epoch in "
            f"{aug_s:.1f} s, {aug.global_step} steps, losses {losses}, CER {cers}, "
            f"launches {counts}")
        require(aug.frontend is not None and aug.global_step == 4
                and os.path.exists(os.path.join(exp, "epoch_0", "model.pt"))
                and len(cers) == 1 and all(np.isfinite(cers + losses)),
                f"--augment on raw waves: {aug.global_step} steps, CER {cers}")
        require(counts["flash_bwd"] == 4 * n_layer and counts["banded_fwd"] == 0,
                f"--augment on raw waves launched {counts}")
        summary.update(augment_s=aug_s, augment_cer=cers[0])
        launches.update(counts)
        del aug
    torch.cuda.empty_cache()
    return dict(launches), summary


def beam_gap(step, u, w=5) -> float:
    """The smallest score gap among the decisions row ``u`` took in one
    iteration of the beam search (a record of ``beam_search_batched``'s
    ``observe``): the gate's blank against best non-blank logit at each
    frame it decided, and where it expanded, the order of the top w + 1
    tokens of each beam that proposed (the best beam's alone at the first
    expansion) and of the top w + 1 of the w x w children."""
    expand = bool(step["expand"][u])
    n = int(step["emit_t"][u] - step["cur_t"][u]) + expand
    gaps = []
    if n > 0:
        gate = step["gate"][u, :n]
        gaps.append((gate[:, 1:].max(-1).values - gate[:, 0]).abs().min())
    if expand:
        first = bool(step["first"][u])
        top = step["logp"][u].topk(w + 1, -1).values           # (W, w + 1)
        if first:
            top = top[int(step["best"][u])][None]
        gaps.append((top[:, :-1] - top[:, 1:]).min())
        if not first:
            flat = step["flat"][u].topk(w + 1).values
            gaps.append((flat[:-1] - flat[1:]).min())
    return min((float(g) for g in gaps), default=float("inf"))


def beam_step_key(step, u):
    """Row ``u``'s decisions in one beam iteration."""
    if not bool(step["expand"][u]):
        return False, int(step["emit_t"][u])
    return (True, int(step["emit_t"][u]), step["parents"][u].tolist(),
            step["new_toks"][u].tolist())


def compare_beams(name, got, ref, runs):
    """Beam tokens must be identical; where an utterance's are not, the
    first iteration at which the two searches decided differently must be a
    near-tie (the smallest score gap of its decisions <= GAP_TOL in both),
    replayed through ``observe``: ``runs`` are the two searches, each a
    function of an observer."""
    if got == ref:
        log(f"  {name}: tokens identical ({sum(map(len, got))} tokens)")
        return
    traces = []
    for run in runs:
        steps = []
        run(steps.append)
        traces.append(steps)
    for u, (a, b) in enumerate(zip(got, ref)):
        if a == b:
            continue
        keys = [[beam_step_key(s, u) for s in tr] for tr in traces]
        i = next((i for i, (p, q) in enumerate(zip(*keys)) if p != q), min(map(len, keys)))
        gap = max((beam_gap(tr[i], u) for tr in traces if i < len(tr)), default=float("inf"))
        log(f"  {name}: utterance {u} first decided differently at iteration {i}, "
            f"smallest score gap {gap:.3e}")
        require(gap <= GAP_TOL, f"{name}: beams diverge at utterance {u}, iteration {i} "
                                f"(gap {gap:.3e})")


def check_beam_int8(cfg, state, offset, phase4, device, smi):
    """Phase 12: the width-5 beam search and W8A8 int8 serving at full
    width.  (a) ``recognize_beam`` on phase 4's batch under the band and at
    full context against the plain versions and against the recomputed
    label encoder, timed beside greedy ``recognize``; ``apps/predict.py
    --beam``.  (b) ``torch._int_mm`` exact, ``QuantLinear`` on the card
    against the CPU; int8 ``recognize`` against the plain versions and the
    float tokens; int8 sessions and ``apps/serve.py --int8``; a JAX-format
    checkpoint through ``tools/quantize_checkpoint.py`` read back to the
    bit; ``apps/predict.py --int8`` on it.  ``phase4`` holds phase 4's
    batch ``x``, ``t_len`` and greedy tokens by mode.  Returns the launches
    of its main paths by kernel and the summary."""
    import numpy as np
    import torch
    from transformer_transducer_tpu_torch.apps import predict as predict_app
    from transformer_transducer_tpu_torch.apps import serve
    from transformer_transducer_tpu_torch.data.wav import write_wave
    from transformer_transducer_tpu_torch.decoding.beam import (
        beam_search, beam_search_batched, recognize_beam)
    from transformer_transducer_tpu_torch.decoding.greedy import recognize
    from transformer_transducer_tpu_torch.models.factory import load_family, to_quant
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.ops import quant
    from transformer_transducer_tpu_torch.ops.masks import context_mask
    from transformer_transducer_tpu_torch.streaming.batched import BatchedStreamingSession
    from transformer_transducer_tpu_torch.streaming.session import (
        StreamingConfig, StreamingSession)
    from transformer_transducer_tpu_torch.tools import quantize_checkpoint
    from transformer_transducer_tpu_torch.utils.config import (
        dump_config, stack_context, subsample_factor)
    from transformer_transducer_tpu_torch.utils.convert import random_jax_params
    from transformer_transducer_tpu_torch.utils.metrics import batch_cer
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary
    n_layer = cfg.model.enc.n_layer
    n_mels = cfg.data.feature_dim
    left, right = stack_context(cfg.data)
    band = (cfg.model.enc.left_context, cfg.model.enc.right_context)
    max_tokens = cfg.data.max_target_length + 1
    x, t_len = phase4["x"], phase4["t_len"]
    mask = context_mask(x.shape[1], *band, device=device)
    launches = collections.Counter()
    summary = {"card": smi}
    models = {}
    for flash in (False, True):
        models[flash] = build_transducer(cfg.model, flash=flash, device=device)
        models[flash].load_state_dict(state)
        with torch.no_grad():
            models[flash].joint.project_layer.bias[0] += offset     # phase 4's bias
    qmodels = {flash: to_quant(m) for flash, m in models.items()}
    # mode -> (model flag, the encoder's keyword, its kernel, the plain path's keyword)
    modes = {"band": (False, {"band": band}, "banded_fwd", {"audio_mask": mask}),
             "full-context": (True, {}, "flash_fwd", {})}

    def main_path(what, fn, kernel):
        """``fn`` with the counts from 0: 18 launches of ``kernel``, nothing else."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict.fromkeys(counts, 0)
        want[kernel] = n_layer
        require(counts == want, f"{what}: launches {counts}, want {want}")
        launches[kernel] += n_layer
        return out

    def encodings(m, kw, plain_kw):
        with torch.no_grad():
            enc_k = m.encode_banded(x, *band) if kw else m.encode(x)
            with plain_versions():
                enc_p = m.encode(x, plain_kw.get("audio_mask"))
        return enc_k, enc_p

    def well_formed(what, toks):
        require(len(toks) == len(t_len) and all(len(r) < max_tokens and 0 not in r
                                                for r in toks), f"{what}: malformed tokens")

    with tempfile.TemporaryDirectory() as tmp:
        # a config, a vocabulary and phase 4's weights for the CLIs
        vocab_path = os.path.join(tmp, "vocab.txt")
        vocab = Vocabulary.from_symbols([chr(0x4E00 + i)
                                         for i in range(cfg.model.vocab_size - 2)] + ["<unk>"])
        vocab.save(vocab_path)
        cli_cfg = load_flagship()
        cli_cfg.override("data.vocab", vocab_path)
        cfg_path = os.path.join(tmp, "config.yaml")
        dump_config(cli_cfg, cfg_path)
        ckpt = os.path.join(tmp, "model.pt")
        torch.save(models[False].state_dict(), ckpt)
        waves = synthetic_waves(8, seed=0)                  # phase 4's
        one = {}
        for u in (len(waves) - 1, 0):                       # 410 and 60 frames
            wav = os.path.join(tmp, f"phase4_{u}.wav")
            write_wave(wav, waves[u])
            feats = F.subsample(F.stack_frames(F.logmel_masked(waves[u], 16000, n_mels),
                                               left, right), subsample_factor(cfg.data))
            one[u] = (wav, torch.from_numpy(feats[None]).to(device))

        # ---- (a) the beam
        log("width-5 beam search at full width (phase 4's batch, weights and blank bias):")
        beam_summary = {}
        for name, (flash, kw, kernel, plain_kw) in modes.items():
            m = models[flash]
            stats = {}
            toks = main_path(f"recognize_beam, {name}", lambda: recognize_beam(
                m, x, t_len, max_tokens=max_tokens, stats=stats, **kw), kernel)
            well_formed(f"recognize_beam, {name}", toks)
            require(stats["host_reads"] == stats["iterations"] <= x.shape[1],
                    f"recognize_beam, {name}: {stats}")
            enc_k, enc_p = encodings(m, kw, plain_kw)
            with plain_versions():
                reset_counts()
                toks_p = recognize_beam(models[False], x, t_len, max_tokens=max_tokens,
                                        **plain_kw)
                require(not any(read_counts().values()), f"plain beam, {name}, launched")
            run = lambda enc, cache: lambda obs: beam_search_batched(
                m, enc, t_len, 5, max_tokens, use_cache=cache, observe=obs)
            compare_beams(f"beam, {name}, kernel vs plain", toks, toks_p,
                          (run(enc_k, True), run(enc_p, True)))
            toks_nc = recognize_beam(m, x, t_len, max_tokens=max_tokens, use_cache=False,
                                     **kw)
            compare_beams(f"beam, {name}, cached vs recomputed label encoder", toks, toks_nc,
                          (run(enc_k, True), run(enc_k, False)))
            n_tok = sum(map(len, toks))
            same = sum(a == b for a, b in zip(toks, phase4[name]))
            log(f"  recognize_beam B 8 ({name}): {stats['iterations']} iterations, "
                f"{stats['host_reads']} host reads; {n_tok} tokens, {same} of 8 utterances "
                f"equal to greedy's")
            beam_summary[name] = {"iterations": stats["iterations"],
                                  "host_reads": stats["host_reads"], "tokens": n_tok,
                                  "same_as_greedy": same}
            # the entry point: its text is beam_search at B 1 on the same rows
            for u, (wav, x1) in one.items():
                text = main_path(f"predict --beam, {name}, utterance {u}",
                                 lambda: predict_app.main(
                                     ["--config", cfg_path, "--checkpoint", ckpt, "--wav", wav,
                                      "--beam", "--device", str(device)]
                                     + (["--full-context"] if flash else [])), kernel)
                with torch.no_grad():
                    enc1 = m.encode_banded(x1, *band) if kw else m.encode(x1)
                want = "".join(vocab.decode(beam_search(m, enc1[0], x1.shape[1],
                                                        max_tokens=max_tokens)))
                log(f"  apps/predict.py --beam ({name}), utterance {u} ({x1.shape[1]} "
                    f"frames): {len(text)} characters, beam_search at B 1 "
                    f"{'agrees' if text == want else 'differs'}")
                require(text == want, f"predict --beam ({name}): {text!r}, want {want!r}")
        summary["beam"] = beam_summary

        # ---- (b) int8
        log("W8A8 int8 serving at full width:")
        rng = np.random.default_rng(12)
        for m_ in (1, 5, 16, 17, 40):
            for k in (512, 2048):
                a = rng.integers(-127, 128, (m_, k), dtype=np.int8)
                w = rng.integers(-127, 128, (cfg.model.vocab_size, k), dtype=np.int8)
                got = quant.int8_matmul(torch.from_numpy(a).to(device),
                                        torch.from_numpy(w).to(device))
                ref = a.astype(np.int64) @ w.astype(np.int64).T
                require(got.dtype == torch.int32 and got.is_cuda
                        and np.array_equal(got.cpu().numpy(), ref),
                        f"torch._int_mm at M {m_}, K {k}, N {w.shape[0]} is not exact")
        log(f"  int8 product (torch._int_mm, padded): exact against numpy's int64 product at "
            f"M 1, 5, 16, 17, 40, K 512, 2048, N {cfg.model.vocab_size}")
        layer = torch.nn.Linear(2048, cfg.model.vocab_size)
        q_cpu = quant.QuantLinear.from_linear(layer)
        q_dev = quant.QuantLinear.from_linear(layer.to(device))
        xs = torch.randn(40, 2048) * 2
        ref, got = q_cpu(xs), q_dev(xs.to(device)).cpu()
        qerr = (got - ref).abs().max().item()
        same_w = torch.equal(q_cpu.weight_q, q_dev.weight_q.cpu()) and torch.equal(
            q_cpu.scale, q_dev.scale.cpu())
        log(f"  QuantLinear (2048 -> {cfg.model.vocab_size}, M 40) on the card against the "
            f"CPU: weights {'equal' if same_w else 'differ'}, max|err| {qerr:.3e} "
            f"(atol 1e-4, rtol 1e-4)")
        require(same_w and torch.allclose(got, ref, **KERNEL_TOL),
                f"QuantLinear on the card differs from the CPU ({qerr})")
        summary["quant_linear_max_abs_err"] = qerr

        int8_summary = {}
        for name, (flash, kw, kernel, plain_kw) in modes.items():
            qm = qmodels[flash]
            toks = main_path(f"int8 recognize, {name}", lambda: recognize(
                qm, x, t_len, max_tokens=max_tokens, **kw), kernel)
            well_formed(f"int8 recognize, {name}", toks)
            with plain_versions():
                reset_counts()
                toks_p = recognize(qmodels[False], x, t_len, max_tokens=max_tokens, **plain_kw)
                require(not any(read_counts().values()), f"plain int8, {name}, launched")
            enc_k, enc_p = encodings(qm, kw, plain_kw)
            diff = (enc_k - enc_p).abs()
            err = diff.max().item()
            log(f"  int8, {name}: encoder states kernel vs plain max|err| {err:.3e}, mean "
                f"{diff.mean().item():.3e}, {100 * (diff > 1e-3).float().mean().item():.2f} % "
                f"over 1e-3 (W8A8 makes rounding whole int8 steps)")
            # layer by layer from the same inputs, the kernel's share of that:
            # isolated whole int8 steps, a small mean
            h, means, maxes, shares = x, [], [], []
            with torch.no_grad():
                for layer in qm.encoder.layers:
                    out_k = layer(h, None, band) if kw else layer(h)
                    with plain_versions():
                        out_p = layer(h, plain_kw.get("audio_mask"))
                    d = (out_k - out_p).abs()
                    means.append(d.mean().item())
                    maxes.append(d.max().item())
                    shares.append((d > 1e-3).float().mean().item())
                    h = out_k
            log(f"  int8, {name}: each layer from the same input, kernel vs plain: mean|err| "
                f"at most {max(means):.3e} (limit {INT8_LAYER_MEAN_TOL}), max|err| at most "
                f"{max(maxes):.3e}, at most {100 * max(shares):.2f} % of values over 1e-3")
            require(max(means) <= INT8_LAYER_MEAN_TOL,
                    f"int8, {name}: a layer's kernel and plain outputs differ by "
                    f"{max(means):.3e} on average")
            replay = compare_int8_tokens(f"int8, {name}", toks, toks_p, qm, enc_k, enc_p,
                                         t_len, max_tokens)
            flt = phase4[name]
            same = sum(a == b for a, b in zip(toks, flt))
            dist, total = batch_cer(toks, flt)
            log(f"  int8 recognize B 8 ({name}): {same} of 8 utterances' tokens equal to the "
                f"float model's, CER between them {100.0 * dist / max(total, 1):.2f} % (random "
                f"weights: not gated)")
            int8_summary[name] = {"same_as_float": same,
                                  "cer_vs_float": dist / max(total, 1),
                                  "encoder_max_abs_err": err,
                                  "layer_mean_abs_err": max(means),
                                  "layer_max_abs_err": max(maxes),
                                  "kernel_vs_plain": replay}
        # times at the band alone, interleaved: the beam's and int8's main
        # path calls were their warm-ups, the float greedy's is one call here
        m, qm, kw = models[False], qmodels[False], modes["band"][1]
        call = lambda model, decode=recognize: lambda: decode(
            model, x, t_len, max_tokens=max_tokens, **kw)
        call(m)()
        ms = host_ms({"beam": call(m, recognize_beam), "greedy": call(m), "int8": call(qm)},
                     samples=5, warm_up=False)
        log(f"  B 8 under the band, on {smi}: recognize_beam {spread(ms['beam'])}, greedy "
            f"recognize {spread(ms['greedy'])}, int8 greedy recognize {spread(ms['int8'])}")
        beam_summary["band"].update(beam_ms=statistics.median(ms["beam"]),
                                    greedy_ms=statistics.median(ms["greedy"]))
        int8_summary["band"].update(int8_ms=statistics.median(ms["int8"]),
                                    float_ms=statistics.median(ms["greedy"]))
        summary["int8"] = int8_summary

        # the int8 sessions: serve --int8 on phase 10's 4 waves, the batched
        # session on the same waves, solo window sessions through the plain
        # versions
        scfg = lambda: StreamingConfig.from_config(cfg)
        serve_waves = synthetic_waves(4, seed=1)
        paths = []
        for i, w in enumerate(serve_waves):
            paths.append(os.path.join(tmp, f"utt{i}.wav"))
            write_wave(paths[-1], w)
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            serve.main(["--config", cfg_path, "--checkpoint", ckpt, "--wavs", *paths,
                        "--streams", str(len(paths)), "--json", "--int8",
                        "--device", str(device)])
        torch.cuda.synchronize()
        cli_counts = read_counts()
        cli = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
        batched = record_rounds(BatchedStreamingSession(qmodels[False], scfg(), len(paths),
                                                        device=device))
        for i, w in enumerate(serve_waves):
            batched.accept_waveform(i, w)
            batched.finalize(i)
        batched.run_to_completion()
        want = dict.fromkeys(cli_counts, 0)
        want["banded_fwd"] = n_layer * batched.encode_calls
        log(f"  serve --int8 (--streams 4 --json): {[len(r['tokens']) for r in cli]} tokens; "
            f"launches {cli_counts}; the int8 batched session drained: "
            f"{batched.encode_calls} encoder calls")
        require(cli_counts == want and want["banded_fwd"] > 0,
                f"serve --int8: launches {cli_counts}, want {want}")
        require([r["tokens"] for r in cli] == [st.result for st in batched.streams],
                "serve --int8: tokens differ from the int8 batched session's")
        launches["banded_fwd"] += cli_counts["banded_fwd"]
        reset_counts()
        solo = record_windows(StreamingSession(qmodels[False], scfg(), device=device))
        feed_stream(solo, serve_waves[-1], None)
        counts = read_counts()
        require(counts["banded_fwd"] == n_layer * solo.window_groups
                and sum(counts.values()) == counts["banded_fwd"],
                f"int8 window session: launches {counts}")
        launches["banded_fwd"] += counts["banded_fwd"]
        with plain_versions():
            plain = []
            for w in serve_waves:
                s = record_windows(StreamingSession(qmodels[False], scfg(), device=device))
                feed_stream(s, w, None)
                plain.append(s)
        compare_streams("int8 window session, kernel vs plain", solo, plain[-1], None)
        for i, (got, ref) in enumerate(zip(utterance_views(batched), plain)):
            compare_streams(f"int8 stream {i}, served vs plain window session", got, ref, None)

        # a JAX-format checkpoint of phase 4's weights through the port's
        # quantize tool, read back against to_quant in memory
        tree = random_jax_params(cfg.model, seed=0)
        tree["joint"]["project_layer"]["bias"][0] += offset
        jax_dir = write_jax_checkpoint(os.path.join(tmp, "jax_epoch"), tree)
        del tree
        int8_dir = os.path.join(tmp, "int8")
        start = time.perf_counter()
        sizes = quantize_checkpoint.main([jax_dir, int8_dir, "--device", str(device)])
        tool_s = time.perf_counter() - start
        loaded = load_family(cli_cfg, n_mels * (1 + left + right), int8_dir, device=device)
        ref_sd, got_sd = qmodels[False].state_dict(), loaded.state_dict()
        same = set(ref_sd) == set(got_sd) and all(
            got_sd[k].dtype == v.dtype and torch.equal(got_sd[k], v) for k, v in ref_sd.items())
        log(f"  tools/quantize_checkpoint.py on the JAX-format checkpoint in {tool_s:.1f} s: "
            f"weights {sizes['weights_in'] / 2 ** 20:.1f} -> {sizes['weights_out'] / 2 ** 20:.1f}"
            f" MiB, files {sizes['file_in'] / 2 ** 20:.1f} -> {sizes['file_out'] / 2 ** 20:.1f} "
            f"MiB ({sizes['file_out'] / sizes['file_in']:.3f}); load_family's tensors "
            f"{'equal' if same else 'differ from'} to_quant's in memory")
        require(loaded.quant and same, "the int8-baked checkpoint does not read back to the bit")
        del loaded
        summary["int8_checkpoint"] = {**sizes, "tool_s": tool_s}
        wav, x1 = one[len(waves) - 1]
        text = main_path("predict --int8 on the int8-baked checkpoint", lambda: predict_app.main(
            ["--config", cfg_path, "--checkpoint", int8_dir, "--wav", wav, "--int8",
             "--device", str(device)]), "banded_fwd")
        want = "".join(vocab.decode(recognize(qmodels[False], x1, [x1.shape[1]], band=band,
                                              max_tokens=max_tokens)[0]))
        log(f"  apps/predict.py --int8 --checkpoint <int8-baked dir>: {len(text)} characters, "
            f"the int8 model's recognize {'agrees' if text == want else 'differs'}")
        require(text == want, f"predict --int8: {text!r}, want {want!r}")
    del models, qmodels
    torch.cuda.empty_cache()
    return dict(launches), summary


def check_espnet(phase4, device, smi):
    """Phase 13: the espnet family at full width (``configs/espnet_aishell.yaml``,
    seeded random weights, phase 4's blank bias rule).  Returns the launches
    of the phase's training paths by counter name, and the phase's summary."""
    import copy
    import numpy as np
    import torch
    from transformer_transducer_tpu_torch.apps import predict as predict_app
    from transformer_transducer_tpu_torch.apps import serve, train_esptt
    from transformer_transducer_tpu_torch.data.wav import write_wave
    from transformer_transducer_tpu_torch.decoding.beam import (
        beam_search, beam_search_batched, recognize_beam)
    from transformer_transducer_tpu_torch.decoding.greedy import (
        greedy_decode, recognize, tokens_to_lists)
    from transformer_transducer_tpu_torch.models.espnet_variant import _pos_table
    from transformer_transducer_tpu_torch.models.factory import (
        build_family, load_family, to_quant)
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.ops.masks import (
        combine_masks, context_mask, padding_mask)
    from transformer_transducer_tpu_torch.streaming.batched import BatchedStreamingSession
    from transformer_transducer_tpu_torch.streaming.session import (
        StreamingConfig, StreamingSession, TrapezoidStreamingSession)
    from transformer_transducer_tpu_torch.utils.config import Config, dump_config
    from transformer_transducer_tpu_torch.utils.convert import (
        from_jax_params, random_jax_params)
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary

    cfg = load_config("configs", "espnet_aishell.yaml")
    v, n_layer = cfg.model.joint.vocab_size, cfg.model.enc.num_blocks
    max_tokens = cfg.data.max_target_length + 1
    x, t_len = phase4["x"], phase4["t_len"]
    tl = torch.as_tensor(t_len, device=device)
    tree = random_jax_params(cfg.model, seed=0)
    model = build_family(cfg, x.shape[-1], device=device)
    model.load_state_dict(from_jax_params(tree))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"espnet model (configs/espnet_aishell.yaml): {n_layer} encoder blocks, d "
        f"{cfg.model.enc.output_size}, {cfg.model.enc.attention_heads} heads, "
        f"{cfg.model.dec.num_blocks} text blocks, V {v}, joint {cfg.model.joint.joint_space_size} "
        f"{model.joint_activation}, bands {model.encoder_left_mask}/{model.encoder_right_mask} "
        f"and {model.decoder_left_mask}/0; {n_params} parameters")
    with torch.no_grad():
        enc = model.encode(x, tl)
        dec = model.predict(torch.full((len(t_len), 1), v - 1, device=device))
        logits = model.joint_logits(enc, dec)[:, :, 0]
        margin = logits[..., 1:].max(-1).values - logits[..., 0]
        valid = torch.arange(x.shape[1], device=device)[None] < tl[:, None]
        offset = torch.quantile(margin[valid], 0.85).item()
        model.joint.lin_out.bias[0] += offset
    tree["joint"]["lin_out"]["bias"] = model.joint.lin_out.bias.detach().cpu().numpy()
    log(f"  blank logit biased by {offset:.3f}")
    cpu = copy.deepcopy(model).cpu()
    x_cpu = x.cpu()
    summary = {"parameters": n_params, "blank_offset": offset, "part_s": {}}
    start = time.perf_counter()

    def mark(part):
        """The seconds each part of the phase took, logged and kept."""
        nonlocal start
        now = time.perf_counter()
        summary["part_s"][part] = now - start
        log(f"  [{part}: {now - start:.1f} s]")
        start = now

    def quiet(what, fn):
        """``fn()`` with the counts from 0, read after: no kernel launches
        on an espnet serving path (its attention is plain tensor code)."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = read_counts()
        require(not any(got.values()), f"{what}: launched {got}")
        return out

    # (a) greedy recognize, cached and uncached, against the CPU
    tok = quiet("recognize", lambda: recognize(model, x, t_len, max_tokens=max_tokens))
    with torch.no_grad():
        enc = model.encode(x, tl)
        enc_cpu = cpu.encode(x_cpu, torch.as_tensor(t_len))
    tok_unc = quiet("recognize, uncached", lambda: tokens_to_lists(*(
        a.cpu().numpy() for a in greedy_decode(model, enc, t_len, max_tokens,
                                               use_cache=False))))
    tok_cpu = recognize(cpu, x_cpu, t_len, max_tokens=max_tokens)
    n_frames = int(t_len.sum())
    require(len(tok) == len(t_len) and all(len(r) < max_tokens and 0 not in r for r in tok),
            "espnet recognize: malformed token lists")
    require(enc.shape == (len(t_len), x.shape[1], cfg.model.enc.output_size)
            and bool(torch.isfinite(enc).all()), "espnet encoder states malformed")
    err = (enc.cpu() - enc_cpu).abs().max().item()
    log(f"  recognize B {len(t_len)}: {sum(map(len, tok))} tokens over {n_frames} frames "
        f"({100.0 * sum(map(len, tok)) / n_frames:.1f} % emission), no kernel launched; "
        f"encoder states card vs CPU max|err| {err:.3e} (tolerance {ENC_TOL})")
    require(err <= ENC_TOL, f"espnet encoder states differ from the CPU's by {err}")
    compare_tokens("greedy, card vs CPU", tok, tok_cpu, model, enc, enc_cpu, t_len,
                   max_tokens, ref_model=cpu)
    compare_tokens("greedy, cached vs uncached", tok, tok_unc, model, enc, enc, t_len,
                   max_tokens, caches=(True, False))
    summary["greedy"] = {"tokens": sum(map(len, tok)), "frames": n_frames,
                         "enc_max_abs_err_vs_cpu": err}
    mark("greedy")

    # (b) the width-5 beam search against the CPU
    beam = quiet("recognize_beam", lambda: recognize_beam(model, x, t_len,
                                                          max_tokens=max_tokens))
    beam_cpu = recognize_beam(cpu, x_cpu, t_len, max_tokens=max_tokens)
    compare_beams("beam, card vs CPU", beam, beam_cpu, [
        lambda obs: beam_search_batched(model, enc, t_len, 5, max_tokens, observe=obs),
        lambda obs: beam_search_batched(cpu, enc_cpu, t_len, 5, max_tokens, observe=obs)])
    summary["beam"] = {"tokens": sum(map(len, beam)),
                       "same_as_greedy": sum(a == b for a, b in zip(beam, tok))}
    mark("beam")

    # (c) int8: each layer from the same input against the CPU's (the gate);
    # the tokens logged beside the float ones (W8A8 turns rounding into
    # whole int8 steps, see INT8_LAYER_MEAN_TOL)
    qm, qc = to_quant(model), to_quant(cpu)
    same_w = all(torch.equal(a.cpu(), b) for a, b in zip(qm.state_dict().values(),
                                                         qc.state_dict().values()))
    require(same_w, "espnet int8 weights quantised on the card differ from the CPU's")
    tok_q = quiet("int8 recognize", lambda: recognize(qm, x, t_len, max_tokens=max_tokens))
    require(len(tok_q) == len(t_len) and all(0 not in r for r in tok_q),
            "espnet int8 recognize: malformed token lists")
    t = x.shape[1]
    mask = combine_masks(context_mask(t, model.encoder_left_mask, model.encoder_right_mask,
                                      device=device)[None],
                         padding_mask(tl, t)[:, None, :])
    pos = _pos_table(t, cfg.model.enc.output_size, device)
    means = []
    with torch.no_grad():
        h = qm.encoder.input_transform(x)[0] * cfg.model.enc.output_size ** 0.5
        for lk, lc in zip(qm.encoder.encoders, qc.encoder.encoders):
            out_k = lk(h, pos, mask)
            d = (out_k.cpu() - lc(h.cpu(), pos.cpu(), mask.cpu())).abs()
            means.append(d.mean().item())
            h = out_k
    same_float = sum(a == b for a, b in zip(tok_q, tok))
    log(f"  int8 (W8A8) weights bit-equal on the card and the CPU; each encoder layer from "
        f"the same input, card vs CPU: mean|err| at most {max(means):.3e} (limit "
        f"{INT8_LAYER_MEAN_TOL}); int8 recognize {sum(map(len, tok_q))} tokens, {same_float} "
        f"of {len(tok)} utterances as the float model's (not gated)")
    require(max(means) <= INT8_LAYER_MEAN_TOL,
            f"espnet int8: a layer differs from the CPU's by {max(means):.3e} on average")
    summary["int8"] = {"layer_mean_abs_err_max": max(means), "tokens": sum(map(len, tok_q)),
                       "same_as_float": same_float}
    mark("int8")

    # (d) JAX-format checkpoint, read to the bit and served by the CLI
    waves = synthetic_waves(8, seed=0)
    pick = {"410 frames": waves[-1], "60 frames": waves[0]}
    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = os.path.join(tmp, "vocab.txt")
        Vocabulary.from_symbols([chr(0x4E00 + i) for i in range(v - 2)]
                                + ["<unk>"]).save(vocab_path)
        cli_cfg = load_config("configs", "espnet_aishell.yaml")
        cli_cfg.override("data.vocab", vocab_path)
        cfg_path = os.path.join(tmp, "config.yaml")
        dump_config(cli_cfg, cfg_path)
        ckpt = write_jax_checkpoint(os.path.join(tmp, "epoch_0"), tree)
        loaded = load_family(cli_cfg, x.shape[-1], ckpt, device=device)
        require(all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                      model.state_dict().values())),
                "the JAX-format espnet checkpoint did not load to the bit")
        del loaded
        vocab = Vocabulary.from_file(vocab_path)
        texts = {}
        for wname, wave in pick.items():
            path = os.path.join(tmp, "utt.wav")
            write_wave(path, wave)
            feats = F.subsample(F.stack_frames(F.logmel_masked(wave, 16000, 128), 3, 0), 3)
            xf = torch.from_numpy(feats[None]).to(device)
            for flags in ([], ["--beam"]):
                text = quiet(f"predict {flags}", lambda: predict_app.main(
                    ["--config", cfg_path, "--checkpoint", ckpt, "--wav", path, *flags]))
                if flags:
                    with torch.no_grad():
                        want = beam_search(model, model.encode(xf)[0], feats.shape[0],
                                           max_tokens=max_tokens)
                else:
                    want = recognize(model, xf, [feats.shape[0]], max_tokens=max_tokens)[0]
                want = "".join(vocab.decode(want))
                require(text == want, f"predict {flags} on the {wname} wave gave {text!r}, "
                                      f"the model {want!r}")
                texts[f"{wname}{' beam' if flags else ''}"] = len(text)
        log(f"  JAX-format espnet checkpoint: read by load_family to the bit; apps/predict.py "
            f"with and without --beam on the 410- and 60-frame waves: the model's own "
            f"decode ({texts} characters), no kernel launched")
        mark("checkpoint and predict")

        # (e) the serve CLI, 4 streams, against the batched session and solo sessions
        scfg = lambda: StreamingConfig.from_config(cfg)
        serve_waves = synthetic_waves(4, seed=1)
        paths = []
        for i, w in enumerate(serve_waves):
            paths.append(os.path.join(tmp, f"s{i}.wav"))
            write_wave(paths[-1], w)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            quiet("serve CLI", lambda: serve.main(
                ["--config", cfg_path, "--checkpoint", ckpt, "--wavs", *paths, "--streams",
                 str(len(paths)), "--json", "--device", str(device)]))
        cli = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
    batched = record_rounds(BatchedStreamingSession(model, scfg(), 4, device=device))
    for i, w in enumerate(serve_waves):
        batched.accept_waveform(i, w)
        batched.finalize(i)
    quiet("batched drain", batched.run_to_completion)
    require([r["tokens"] for r in cli] == [st.result for st in batched.streams],
            "espnet serve CLI: tokens differ from the batched session's")
    for i, (got, w) in enumerate(zip(utterance_views(batched), serve_waves)):
        solo = record_windows(StreamingSession(model, scfg(), device=device))
        quiet("solo session", lambda: feed_stream(solo, w, None))
        compare_streams(f"espnet stream {i}, batched vs solo window", got, solo)
    log(f"  serve CLI --streams 4: {[len(r['tokens']) for r in cli]} tokens, the batched "
        f"session's; no kernel launched")
    mark("serve")

    # (f) the sessions on phase 9's waves: window, trapezoid, incremental;
    # 100 ms a call and whole; the window and trapezoid against the CPU
    def session(mode, on=model, dev=device):
        s = (TrapezoidStreamingSession(on, scfg(), device=dev) if mode == "trapezoid"
             else StreamingSession(on, scfg(), device=dev, incremental=mode == "incremental"))
        return record_windows(s)

    streams = {}
    for wname, wave in pick.items():
        for fname, chunk in (("100 ms", STREAM_CHUNK), ("whole file", None)):
            for mode in ("window", "trapezoid", "incremental"):
                s = session(mode)
                quiet(f"{mode} session", lambda: feed_stream(s, wave, chunk))
                streams[wname, fname, mode] = s
        for mode in ("window", "trapezoid"):
            ref = session(mode, cpu, "cpu")
            feed_stream(ref, wave, None)
            compare_streams(f"{wname}, {mode} session, card vs CPU",
                            streams[wname, "whole file", mode], ref)
        compare_streams(f"{wname}, incremental vs window session",
                        streams[wname, "100 ms", "incremental"], streams[wname, "100 ms", "window"])
        compare_streams(f"{wname}, window session, 100 ms vs whole file",
                        streams[wname, "100 ms", "window"], streams[wname, "whole file", "window"])
    summary["streams"] = {f"{w}, {f}, {m}": len(s.result) for (w, f, m), s in streams.items()}
    mark("sessions")

    # (g) training: 3 full-loss then 3 pruned steps against the plain
    # versions, dropout 0, phase 6's batch with labels 1 .. V - 2
    model_cfg = copy.deepcopy(cfg.model)
    for blk in ("enc", "dec"):
        for key in ("dropout_rate", "positional_dropout_rate", "attention_dropout_rate"):
            model_cfg[blk][key] = 0.0
    state = model.state_dict()
    del cpu, qm, qc, enc_cpu
    torch.cuda.empty_cache()
    optim_cfg = Config({"type": "sgd", "lr": cfg.optim.lr, "momentum": 0.9})
    batch, _ = training_batch(cfg, device, seed=1)
    launches = dict.fromkeys(read_counts(), 0)
    summary["training"] = {}
    for pruned in (None, S_RANGE):
        rs_kern, rs_plain = [], []
        kern = train_three_steps(model_cfg, optim_cfg, state, None, batch, device,
                                 plain=False, pruned_range=pruned,
                                 hooks=(band_starts(rs_kern),) if pruned else ())
        plain = train_three_steps(model_cfg, optim_cfg, state, None, batch, device,
                                  plain=True, pruned_range=pruned,
                                  hooks=(band_starts(rs_plain, force=rs_kern),) if pruned
                                  else ())
        want = dict.fromkeys(launches, 0)
        want.update(alpha=1, beta=1)
        if pruned:
            want.update(logz=1, band_alpha=1, band_beta=1)
        name = f"pruned {pruned}" if pruned else "full"
        for i, ((lk, nk, ck), (lp, norm_p, cp)) in enumerate(zip(kern, plain)):
            rel = abs(lk - lp) / abs(lp)
            log(f"  espnet {name} loss, step {i + 1}: loss kernel {lk:.6f} / plain {lp:.6f} "
                f"(rel {rel:.2e}), grad norm {nk:.5f} / {norm_p:.5f}; launches {ck}")
            require(ck == want, f"espnet {name} step {i + 1}: launches {ck}, want {want}")
            require(not any(cp.values()), f"espnet {name} plain step launched {cp}")
            require(rel <= LOSS_RTOL, f"espnet {name} step {i + 1}: losses differ by {rel:.2e}")
            for key, n in ck.items():
                launches[key] += n
        rel = abs(kern[0][1] - plain[0][1]) / abs(plain[0][1])
        log(f"  espnet {name} loss: step 1 grad norm rel diff {rel:.2e} (tolerance {NORM_RTOL})")
        require(rel <= NORM_RTOL, f"espnet {name}: step 1 grad norms differ by {rel:.2e}")
        summary["training"][name] = {"losses": [k[0] for k in kern],
                                     "plain_losses": [p[0] for p in plain]}
    mark("training steps")

    # (h) apps/train_esptt.py: one epoch, -mode continue for a second, then
    # predict on the epoch_1 it wrote
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = write_corpus(tmp, cfg, base=load_config("configs", "espnet_aishell.yaml"))
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            first = train_esptt.main(["-config", cfg_path, "--epochs", "1"])
            second = train_esptt.main(["-config", cfg_path, "-mode", "continue",
                                       "--epochs", "2"])
            torch.cuda.synchronize()
            cli_counts = read_counts()
        finally:
            os.chdir(cwd)
        exp = os.path.join(tmp, second.exp_dir)
        with open(os.path.join(exp, "metrics.jsonl"), encoding="utf-8") as fh:
            cers = [r["value"] for r in map(json.loads, fh) if r["tag"] == "cer"]
        require(first.is_espnet and second.start_epoch == 1 and second.global_step == 8,
                f"train_esptt continue resumed at epoch {second.start_epoch}, step "
                f"{second.global_step}")
        require(len(cers) == 2 and all(np.isfinite(cers)), f"train_esptt CER {cers}")
        require(cli_counts["alpha"] >= 8 and cli_counts["beta"] == 8
                and not any(cli_counts[k] for k in ("banded_fwd", "banded_bwd", "flash_fwd",
                                                    "flash_bwd")),
                f"train_esptt launches {cli_counts}")
        for key in ("alpha", "beta"):
            launches[key] += cli_counts[key]
        from transformer_transducer_tpu_torch.utils.config import load_config as load_file
        cli_cfg = load_file(cfg_path)
        with open(cli_cfg.data.dev, encoding="utf-8") as fh:
            wav = fh.read().splitlines()[1].split(",")[0]
        text = quiet("predict on epoch_1", lambda: predict_app.main(
            ["--config", cfg_path, "--checkpoint", os.path.join(exp, "epoch_1"), "--wav", wav]))
        from transformer_transducer_tpu_torch.data.wav import read_wave
        wave, rate = read_wave(wav)
        feats = F.subsample(F.stack_frames(F.logmel_masked(wave, rate, 128), 3, 0), 3)
        second.model.eval()
        want = recognize(second.model, torch.from_numpy(feats[None]).to(device),
                         [feats.shape[0]], max_tokens=max_tokens)[0]
        want = "".join(Vocabulary.from_file(cli_cfg.data.vocab).decode(want))
        require(text == want, f"predict on epoch_1 gave {text!r}, the trained model {want!r}")
        log(f"  apps/train_esptt.py: 2 epochs (the second by -mode continue), "
            f"{second.global_step} steps, CER per epoch {cers}, launches {cli_counts}; "
            f"apps/predict.py on epoch_1 gives the trained model's greedy decode")
        summary["train_esptt"] = {"cer": cers, "steps": second.global_step}
        del first, second
    mark("train_esptt")

    # (i) timings, medians of 5, in turns
    long_wave = pick["410 frames"]
    trainees = {name: make_trainee(model_cfg, optim_cfg, state, None, device, pruned)[2]
                for name, pruned in (("full", None), (f"pruned {S_RANGE}", S_RANGE))}
    qm = to_quant(model)
    gen = torch.Generator().manual_seed(0)

    def stream_whole():
        s = StreamingSession(model, scfg(), device=device)
        s.accept_waveform(long_wave)
        s.finalize()

    runs = {"greedy recognize B 8": lambda: recognize(model, x, t_len, max_tokens=max_tokens),
            "beam recognize B 8": lambda: recognize_beam(model, x, t_len,
                                                         max_tokens=max_tokens),
            "int8 greedy recognize B 8": lambda: recognize(qm, x, t_len,
                                                           max_tokens=max_tokens),
            "window stream, whole 12.3 s file": stream_whole,
            "train step, full loss": lambda: trainees["full"](batch, gen),
            f"train step, pruned {S_RANGE}": lambda: trainees[f"pruned {S_RANGE}"](batch, gen)}
    times = host_ms(runs, samples=5)
    summary["ms"] = {}
    for name, ms in times.items():
        summary["ms"][name] = statistics.median(ms)
        log(f"  {name}: {spread(ms)} ({smi})")
    mark("timings")
    summary["nvidia_smi"] = smi
    return launches, summary


def check_bf16_remat(cfg, state, batch, device, smi):
    """Phase 14: ``--remat`` and ``--bf16`` training at flagship width on
    phase 6's batch and weights.  (a) With and without remat: 3 banded steps
    at the config's dropout, losses and raw gradient norms equal to the bit;
    flash (whose backward sums in a varying order) its first step at that
    dropout and 3 steps at dropout 0 within the atomics tolerance; the
    forward kernel twice a layer; peak memory and step time both ways in
    turns.  (b) 3 bf16 steps each of the
    dense, banded and ``--banded --pruned-range 5`` models and the espnet
    family's full loss, and of the ``--flash`` model through the bf16 forms
    of kernels 8 and 9, the kernels against the plain versions (both bf16),
    beside the bf16-to-float32 distance of step 1; the launch counts; one
    ``--bf16 --remat --flash`` step; step time, device busy time and peak
    memory against the float32 step in turns.  (c) ``apps/train.py --bf16
    --remat --flash --nan-guard --steps-per-call 8`` for 2 epochs on the
    port's tone corpus, then ``apps/predict.py`` on its checkpoint.
    Returns (the main path's launches, a summary)."""
    import copy
    import numpy as np
    import torch
    from transformer_transducer_tpu_torch.apps import predict as predict_app
    from transformer_transducer_tpu_torch.apps import train as train_app
    from transformer_transducer_tpu_torch.tools import tone_demo
    from transformer_transducer_tpu_torch.utils.config import Config, dump_config
    from transformer_transducer_tpu_torch.utils.convert import (
        from_jax_params, random_jax_params)
    bf16 = torch.bfloat16
    n_layer = cfg.model.enc.n_layer
    optim_cfg = Config({"type": "sgd", "lr": cfg.optim.lr, "momentum": 0.9})
    launches = dict.fromkeys(read_counts(), 0)
    summary = {"card": smi}
    rel = lambda a, b: abs(a - b) / abs(b)

    def add(counts):
        for key, n in counts.items():
            launches[key] += n

    def timed(name, makers):
        """Step time (medians in turns) and device busy time of the steps
        ``makers`` build (name -> () -> step), then each one's peak memory
        with only its own model on the card."""
        out = {}
        runs = {key: make() for key, make in makers.items()}
        times = host_ms(runs)
        busy = {key: device_busy_ms(run) for key, run in runs.items()}
        del runs
        for key, make in makers.items():
            torch.cuda.empty_cache()
            run = make()
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            out[key] = {"step_ms": statistics.median(times[key]),
                        "quartiles_ms": statistics.quantiles(times[key], n=4)[::2],
                        "device_busy_ms": busy[key],
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            del run
            log(f"  {name}, {key}: step {spread(times[key])}, device busy "
                f"{busy[key]:.2f} ms, peak memory {out[key]['peak_gib']:.2f} GiB ({smi})")
        torch.cuda.empty_cache()
        return out

    def stepper(mcfg, mstate, mode, mbatch, **kw):
        """() -> a fresh trainee's step on ``mbatch``, SpecAugment seeded."""
        def make():
            step = make_trainee(mcfg, optim_cfg, mstate, mode, device, **kw)[2]
            return functools.partial(step, mbatch, torch.Generator().manual_seed(0))
        return make

    # (a) --remat in float32, dropout on (the config's): banded 3 steps to
    # the bit; flash step 1 within the atomics tolerance (its backward sums
    # in a varying order, and at dropout 0.5 the clipped steps after it
    # carry that spread chaotically), then 3 flash steps at dropout 0
    model_cfg0 = copy.deepcopy(cfg.model)
    model_cfg0.override("dropout", 0.0)
    summary["remat"] = {}
    for mode in ("banded", "flash"):
        fwd, bwd = f"{mode}_fwd", f"{mode}_bwd"
        runs = [(cfg.model, 3 if mode == "banded" else 1)]
        if mode == "flash":
            runs.append((model_cfg0, 3))
        for mcfg, n_steps in runs:
            plain = train_three_steps(mcfg, optim_cfg, state, mode, batch, device, False,
                                      steps=n_steps)
            remat = train_three_steps(mcfg, optim_cfg, state, mode, batch, device, False,
                                      remat=True, steps=n_steps)
            for i, ((l0, n0, c0), (l1, n1, c1)) in enumerate(zip(plain, remat)):
                log(f"  --remat --{mode}, dropout {mcfg.dropout}, step {i + 1}: loss "
                    f"{l1:.6f} / without {l0:.6f} (rel {rel(l1, l0):.2e}), grad norm "
                    f"{n1:.5f} / {n0:.5f} (rel {rel(n1, n0):.2e}); launches {c1}")
                require(c0[fwd] == n_layer and c1[fwd] == 2 * n_layer and c1[bwd] == n_layer
                        and c1["alpha"] == c1["beta"] == 1,
                        f"--remat --{mode} step {i + 1}: launches {c1} (without remat {c0})")
                if mode == "banded":
                    require(l1 == l0 and n1 == n0, f"--remat --banded step {i + 1}: loss or "
                            f"gradient norm differs from the plain step's")
                else:     # the flash backward's atomics: losses, and step 1's norm
                    require(rel(l1, l0) <= LOSS_RTOL and (i or rel(n1, n0) <= NORM_RTOL),
                            f"--remat --flash step {i + 1}: differs beyond the atomics "
                            f"tolerance")
                add(c1)
        summary["remat"][mode] = {"losses": [r[0] for r in remat],
                                  "plain_losses": [r[0] for r in plain],
                                  **timed(f"--{mode} step B={B_TRAIN}", {
                                      "without remat": stepper(cfg.model, state, mode, batch),
                                      "remat": stepper(cfg.model, state, mode, batch,
                                                       remat=True)})}

    # (b) --bf16, dropout 0 for the comparisons
    esp = load_config("configs", "espnet_aishell.yaml")
    esp_cfg0 = copy.deepcopy(esp.model)
    for blk in ("enc", "dec"):
        for key in ("dropout_rate", "positional_dropout_rate", "attention_dropout_rate"):
            esp_cfg0[blk][key] = 0.0
    esp_state = from_jax_params(random_jax_params(esp.model, seed=0))
    esp_batch, _ = training_batch(esp, device, seed=1)
    cases = (("dense", model_cfg0, state, None, batch),
             ("banded", model_cfg0, state, None, batch),
             (f"banded, pruned {S_RANGE}", model_cfg0, state, S_RANGE, batch),
             ("flash", model_cfg0, state, None, batch),
             ("espnet, full loss", esp_cfg0, esp_state, None, esp_batch))
    summary["bf16"] = {}
    for name, mcfg, mstate, pruned, mbatch in cases:
        mode = name.split(",")[0] if name.startswith(("banded", "flash")) else "dense"
        rs_kern, rs_plain = [], []
        hooks_k = (band_starts(rs_kern),) if pruned else ()
        kern = train_three_steps(mcfg, optim_cfg, mstate, mode, mbatch, device, False,
                                 pruned, hooks=hooks_k, compute_dtype=bf16)
        plain = train_three_steps(mcfg, optim_cfg, mstate, mode, mbatch, device, True, pruned,
                                  hooks=(band_starts(rs_plain, force=rs_kern),) if pruned
                                  else (), compute_dtype=bf16)
        f32 = train_three_steps(mcfg, optim_cfg, mstate, mode, mbatch, device, False, pruned)
        want = dict.fromkeys(launches, 0)
        want.update(alpha=1, beta=1)
        if mode == "banded":
            want.update(banded_fwd=n_layer, banded_bwd=n_layer)
        if mode == "flash":     # the bf16 forms of kernels 8 and 9, never the float32 ones
            want.update(flash_fwd=n_layer, flash_bwd=n_layer, flash_fwd_bf16=n_layer,
                        flash_bwd_bf16=n_layer)
        if pruned:
            want.update(logz=1, band_alpha=1, band_beta=1)
        for i, ((lk, nk, ck), (lp, norm_p, cp), (l32, n32, _)) in enumerate(
                zip(kern, plain, f32)):
            log(f"  --bf16 {name}, step {i + 1}: loss kernel {lk:.6f} / plain {lp:.6f} "
                f"(rel {rel(lk, lp):.2e}), grad norm {nk:.5f} / {norm_p:.5f} (rel "
                f"{rel(nk, norm_p):.2e}); bf16 against float32 (kernels both): loss "
                f"{rel(lk, l32):.2e}, grad norm {rel(nk, n32):.2e}; launches {ck}")
            require(ck == want, f"--bf16 {name} step {i + 1}: launches {ck}, want {want}")
            require(not any(cp.values()), f"--bf16 {name} plain step launched {cp}")
            require(np.isfinite([lk, nk]).all(), f"--bf16 {name} step {i + 1}: not finite")
            add(ck)
        (lk, nk, _), (lp, norm_p, _), (l32, n32, _) = kern[0], plain[0], f32[0]
        log(f"  --bf16 {name}: step 1 kernel-vs-plain rel diff loss {rel(lk, lp):.2e}, grad "
            f"norm {rel(nk, norm_p):.2e} (tolerances: loss {BF16_LOSS_RTOL}, norm "
            f"{BF16_NORM_RTOL}, each under bf16 against float32: {rel(lk, l32):.2e}, "
            f"{rel(nk, n32):.2e})")
        require(rel(lk, lp) <= BF16_LOSS_RTOL,
                f"--bf16 {name}: step 1 losses differ by {rel(lk, lp):.2e}")
        require(rel(nk, norm_p) <= BF16_NORM_RTOL,
                f"--bf16 {name}: step 1 grad norms differ by {rel(nk, norm_p):.2e}")
        require(rel(lk, lp) < rel(lk, l32) and rel(nk, norm_p) < rel(nk, n32),
                f"--bf16 {name}: the kernels move step 1 as far as bf16 does")
        d_loss, d_norm = rel(lk, l32), rel(nk, n32)
        summary["bf16"][name] = {"losses": [k[0] for k in kern],
                                 "plain_losses": [p[0] for p in plain],
                                 "grad_norms": [k[1] for k in kern],
                                 "plain_grad_norms": [p[1] for p in plain],
                                 "float32_losses": [f[0] for f in f32],
                                 "float32_grad_norms": [f[1] for f in f32],
                                 "rel_to_float32_step1": [d_loss, d_norm]}
        if name in ("dense", "banded", "flash", "espnet, full loss"):
            summary["bf16"][name].update(timed(f"--bf16 {name} step B={B_TRAIN}", {
                "float32": stepper(mcfg, mstate, mode, mbatch),
                "bf16": stepper(mcfg, mstate, mode, mbatch, compute_dtype=bf16)}))
        torch.cuda.empty_cache()
    # one --bf16 --remat --flash step: the forward form twice a layer (once
    # more in the backward), the backward form once; loss and gradient norm
    # as without remat, within the bf16 tolerances of step 1
    (lr, nr, cr), = train_three_steps(model_cfg0, optim_cfg, state, "flash", batch, device,
                                      False, compute_dtype=bf16, remat=True, steps=1)
    lk, nk = summary["bf16"]["flash"]["losses"][0], summary["bf16"]["flash"]["grad_norms"][0]
    want = dict.fromkeys(launches, 0)
    want.update(alpha=1, beta=1, flash_fwd=2 * n_layer, flash_fwd_bf16=2 * n_layer,
                flash_bwd=n_layer, flash_bwd_bf16=n_layer)
    log(f"  --bf16 --remat --flash, step 1: loss {lr:.6f} / without remat {lk:.6f} (rel "
        f"{rel(lr, lk):.2e}), grad norm {nr:.5f} / {nk:.5f} (rel {rel(nr, nk):.2e}); "
        f"launches {cr}")
    require(cr == want, f"--bf16 --remat --flash: launches {cr}, want {want}")
    require(rel(lr, lk) <= BF16_LOSS_RTOL and rel(nr, nk) <= BF16_NORM_RTOL,
            "--bf16 --remat --flash: step 1 differs from the step without remat")
    add(cr)
    summary["bf16"]["flash"]["remat_step1"] = [lr, nr]
    torch.cuda.empty_cache()

    # (c) the CLI on the port's tone corpus (the small geometry), then predict
    with tempfile.TemporaryDirectory() as tmp:
        vocab, csvs = tone_demo._write_corpus(os.path.join(tmp, "tone"), 128, 16, seed=0)
        cfg_path = os.path.join(tmp, "config.yaml")
        dump_config(tone_demo._config(vocab, csvs, "small"), cfg_path)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            start = time.perf_counter()
            trainer = train_app.main(["-config", cfg_path, "--bf16", "--remat", "--flash",
                                      "--nan-guard", "--steps-per-call", "8", "--epochs", "2"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - start
            cli_counts = read_counts()
        finally:
            os.chdir(cwd)
        exp = os.path.join(tmp, trainer.exp_dir)
        with open(os.path.join(exp, "metrics.jsonl"), encoding="utf-8") as fh:
            rows = list(map(json.loads, fh))
        cers = [r["value"] for r in rows if r["tag"] == "cer"]
        losses = [r["value"] for r in rows if r["tag"] == "train_loss"]
        log(f"  apps/train.py --bf16 --remat --flash --nan-guard --steps-per-call 8: 2 epochs "
            f"of the "
            f"tone corpus (128 / 16, d 64) in {cli_s:.1f} s ({smi}), {trainer.global_step} "
            f"steps, {trainer.total_skips} skipped, first / last train loss {losses[0]:.3f} / "
            f"{losses[-1]:.3f}, CER {cers}, launches {cli_counts}")
        require(trainer.global_step == 16 and trainer.total_skips == 0 and len(cers) == 2
                and np.isfinite(cers + losses).all(), "the bf16 CLI run failed")
        # 16 steps, and the evaluation's loss once an epoch (one dev batch,
        # forward only: an alpha sweep)
        require(cli_counts["alpha"] == 18 and cli_counts["beta"] == 16,
                f"the bf16 CLI did not run the lattice kernels once a step: {cli_counts}")
        # 2 layers: the bf16 backward form twice a step, the forward form
        # four times a step (remat) and in the evaluation, no float32 form
        require(cli_counts["flash_bwd_bf16"] == cli_counts["flash_bwd"] == 32
                and cli_counts["flash_fwd_bf16"] == cli_counts["flash_fwd"] > 64
                and not cli_counts["banded_fwd"],
                f"the bf16 CLI did not run the flash kernels' bf16 forms: {cli_counts}")
        state_ckpt = torch.load(os.path.join(exp, "epoch_1", "model.pt"), map_location="cpu")
        require(all(v.dtype == torch.float32 for comp in ("encoder", "decoder", "joint")
                    for v in state_ckpt[comp].values() if v.is_floating_point()),
                "the bf16 run's checkpoint is not float32")
        with open(csvs["dev"], encoding="utf-8") as fh:
            wav = fh.read().splitlines()[1].split(",")[0]
        reset_counts()
        text = predict_app.main(["--config", cfg_path, "--checkpoint",
                                 os.path.join(exp, "epoch_1"), "--wav", wav])
        torch.cuda.synchronize()
        pred_counts = read_counts()
        log(f"  apps/predict.py on its epoch_1: {text!r}; launches {pred_counts}")
        require(pred_counts["banded_fwd"] == 2, f"predict launches {pred_counts}")
        add(cli_counts)
        add(pred_counts)
        summary["cli"] = {"seconds": cli_s, "cer": cers, "first_loss": losses[0],
                          "last_loss": losses[-1], "launches": cli_counts}
    return launches, summary


# kernel events of a torch.profiler trace, by the launch counter each
# answers to: the hand-written kernel's name, kernels a launch
TRACE_KERNELS = {
    "flash_fwd": (re.compile(r"\bflash_fwd_tc<"), 1),
    "flash_bwd": (re.compile(r"\bflash_bwd_tc<"), 1),
    "alpha": (re.compile(r"\bwavefront<\d+, (?:true|false), false>"), 1),
    "beta": (re.compile(r"\bwavefront<\d+, (?:true|false), true>"), 1),
}


@contextlib.contextmanager
def native_features(on: bool):
    """``TTX_NATIVE_FEATURES`` set to 1 (or unset) inside the block."""
    saved = os.environ.pop("TTX_NATIVE_FEATURES", None)
    if on:
        os.environ["TTX_NATIVE_FEATURES"] = "1"
    try:
        yield
    finally:
        os.environ.pop("TTX_NATIVE_FEATURES", None)
        if saved is not None:
            os.environ["TTX_NATIVE_FEATURES"] = saved


def profiled_training(argv) -> dict:
    """``apps/train.py`` with ``argv`` in this process, with
    ``TTX_NATIVE_FEATURES=1``: the seconds, the launches and whether the
    profiler ran, by epoch; the launches and native calls of the whole run;
    the experiment directory and the steps (phase 15 (d))."""
    import torch
    from transformer_transducer_tpu_torch.apps import train as train_app
    from transformer_transducer_tpu_torch.runtime import native
    from transformer_transducer_tpu_torch.training.trainer import Trainer
    epochs = {}
    train_epoch = Trainer.train_epoch

    def timed_epoch(self, epoch, loader):
        torch.cuda.synchronize()
        counts, start = read_counts(), time.perf_counter()
        out = train_epoch(self, epoch, loader)
        torch.cuda.synchronize()
        epochs[epoch] = {"s": time.perf_counter() - start,
                         "profiled": torch.autograd.profiler._is_profiler_enabled,
                         "counts": {k: n - counts[k] for k, n in read_counts().items()}}
        return out

    Trainer.train_epoch = timed_epoch
    native.reset_calls()
    reset_counts()
    try:
        start = time.perf_counter()
        with native_features(True):
            trainer = train_app.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - start
    finally:
        Trainer.train_epoch = train_epoch
    return {"cli_s": cli_s, "epochs": epochs, "counts": read_counts(),
            "calls": native.read_calls(), "exp_dir": trainer.exp_dir,
            "global_step": trainer.global_step}


def check_host_remainder(cfg, state, offset, phase4, device, smi):
    """Phase 15: the native C++ runtime, the profiled epoch, checkpoint
    averaging and conversion (see the module's docstring).  ``phase4``
    holds phase 4's batch ``x``, ``t_len`` and tokens by mode.  Returns the
    launches of its main paths by counter name, and the summary."""
    import pathlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from transformer_transducer_tpu_torch.apps import predict as predict_app
    from transformer_transducer_tpu_torch.data.loader import DataLoader
    from transformer_transducer_tpu_torch.data.wav import read_wave
    from transformer_transducer_tpu_torch.decoding.greedy import recognize
    from transformer_transducer_tpu_torch.models.factory import load_family
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.runtime import native
    from transformer_transducer_tpu_torch.tools import average_checkpoints, convert_checkpoint
    from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
    from transformer_transducer_tpu_torch.utils import metrics
    from transformer_transducer_tpu_torch.utils.config import (
        load_config as load_cfg_file, stack_context, subsample_factor)
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary
    n_layer = cfg.model.enc.n_layer
    n_mels = cfg.data.feature_dim
    left, right = stack_context(cfg.data)
    factor = subsample_factor(cfg.data)
    band = (cfg.model.enc.left_context, cfg.model.enc.right_context)
    max_tokens = cfg.data.max_target_length + 1
    launches = collections.Counter()
    summary = {"card": smi, "cpus": os.cpu_count()}

    # (a) the build, into an empty directory
    cxx = native.compiler()
    require(cxx is not None, "no C++ compiler (g++) on this machine")
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             check=True).stdout.splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        saved, native.BUILD_DIR = native.BUILD_DIR, pathlib.Path(tmp)
        try:
            start = time.perf_counter()
            native.build(cxx)
            summary["build_s"] = time.perf_counter() - start
        finally:
            native.BUILD_DIR = saved
    lib = native.library()
    log(f"native runtime: {version} ({cxx}), {' '.join(native.CXX_FLAGS)}: built in "
        f"{summary['build_s']:.2f} s; os.cpu_count() {os.cpu_count()}")

    # (b) the log-mel of phase 4's waves, native against numpy.  ttx_logmel
    # computes in float64 (float64 frames, FFT and mel sums), the numpy path
    # in float32 (pocketfft's float32 FFT): where a mel bin holds little of a
    # frame's energy, the float32 FFT's rounding moves its log by a few 1e-4
    # (phase 4's waves at 128 mels), so an element outside the bar
    # must be one where numpy's float32 is the farther from the same
    # pipeline in float64, and ttx_logmel must hold the bar against that
    waves = synthetic_waves(8, seed=0)
    mel = F.mel_filterbank(16000, F.N_FFT, n_mels)

    def logmel64(w, variant):
        frames = F.frame_signal(w).astype(np.float64) * F.hann_window()[None]
        spec = np.fft.rfft(frames, axis=-1)
        m = (spec.real ** 2 + spec.imag ** 2) @ mel.T.astype(np.float64)
        if variant == "masked":
            return np.where(m > 0, np.log(np.where(m > 0, m, 1.0)), 0.0)
        return np.log10(np.where(m == 0, np.finfo(np.float64).eps, m))

    errs = collections.defaultdict(float)
    outside = 0
    with native_features(False):
        for variant, fn in (("masked", F.logmel_masked), ("eps", F.logmel_eps)):
            for w in waves:
                got = lib.logmel(w, mel, F.N_FFT, F.HOP_LENGTH, variant)
                want = fn(w, 16000, n_mels)
                ref = logmel64(w, variant)
                require(got is not None and got.shape == want.shape == ref.shape,
                        f"ttx_logmel ({variant}) gave {None if got is None else got.shape}, "
                        f"numpy {want.shape}")
                to64, np_to64 = np.abs(got - ref), np.abs(want - ref)
                require((to64 <= 2e-4 + 2e-4 * np.abs(ref)).all(),
                        f"ttx_logmel ({variant}) off the float64 pipeline by {to64.max():.3e}")
                off = np.abs(got - want) > 2e-4 + 2e-4 * np.abs(want)
                require((np_to64[off] > to64[off]).all(),
                        f"ttx_logmel ({variant}) off numpy by {np.abs(got - want).max():.3e} "
                        "where numpy's float32 is not the farther from float64")
                outside += int(off.sum())
                errs["native_numpy"] = max(errs["native_numpy"], float(np.abs(got - want).max()))
                errs["native_f64"] = max(errs["native_f64"], float(to64.max()))
                errs["numpy_f64"] = max(errs["numpy_f64"], float(np_to64.max()))
    threads = DataLoader([], 1).num_workers

    def featurize(route, n_threads):
        def run():
            with native_features(route == "native"):
                if n_threads == 1:
                    return [F.logmel_eps(w, 16000, n_mels) for w in waves]
                with ThreadPoolExecutor(n_threads) as pool:
                    return list(pool.map(lambda w: F.logmel_eps(w, 16000, n_mels), waves))
        return run

    before = native.read_calls()["logmel"]
    ms = host_ms({f"{route} x{n}": featurize(route, n) for route in ("numpy", "native")
                  for n in (1, threads)}, samples=5)
    require(native.read_calls()["logmel"] - before == 2 * 6 * len(waves),
            "the native route did not run ttx_logmel once a wave")
    summary["logmel_ms"] = {k: statistics.median(v) for k, v in ms.items()}
    summary["logmel_max_abs_err"] = dict(errs, outside_bar=outside)
    log(f"ttx_logmel on phase 4's 8 waves ({sum(map(len, waves))} samples), both variants "
        f"(rtol 2e-4, atol 2e-4): max|err| against numpy {errs['native_numpy']:.3e} "
        f"({outside} elements outside the bar, each where numpy's float32 is the farther "
        f"from float64), against the pipeline in float64 {errs['native_f64']:.3e}; numpy "
        f"against float64 {errs['numpy_f64']:.3e}; host ms for the batch (logmel_eps, "
        f"median of 5, {smi}; 1 and {threads} threads): "
        + ", ".join(f"{k} {v:.2f}" for k, v in summary["logmel_ms"].items()))

    # (c) the batch CER, native against numpy
    rng = np.random.default_rng(1)
    v = cfg.model.vocab_size
    preds = [rng.integers(1, v, rng.integers(0, 43)).tolist() for _ in range(1000)]
    refs = [rng.integers(1, v, rng.integers(0, 43)).tolist() for _ in range(1000)]
    before = native.read_calls()["batch_levenshtein"]
    cer = {"pairs": metrics.batch_cer(preds, refs),
           "decodes": metrics.batch_cer(phase4["full-context"], phase4["band"])}
    require(native.read_calls()["batch_levenshtein"] - before == 2,
            "batch_cer did not take the native path once a batch")
    plain = {"pairs": metrics.batch_cer_numpy(preds, refs),
             "decodes": metrics.batch_cer_numpy(phase4["full-context"], phase4["band"])}
    require(cer == plain, f"native batch CER {cer}, numpy {plain}")
    ms = host_ms({"numpy": lambda: metrics.batch_cer_numpy(preds, refs),
                  "native": lambda: metrics.batch_cer(preds, refs)}, samples=5)
    summary["cer"] = cer
    summary["cer_ms"] = {k: statistics.median(v) for k, v in ms.items()}
    log(f"batch CER native = numpy: 1,000 seeded pairs {cer['pairs']}, phase 4's decodes "
        f"(full context against band) {cer['decodes']}; the 1,000 pairs in "
        f"{summary['cer_ms']['native']:.2f} ms native, {summary['cer_ms']['numpy']:.2f} ms numpy")

    with tempfile.TemporaryDirectory() as tmp:
        # (d) the training entry point with --profile, in a process of its
        # own, where the trace is the first torch.profiler session (run in
        # this process after phases 1-14, the epoch's trace once lacked a
        # few of its kernel records)
        cfg_path = write_corpus(tmp, cfg)
        trace_dir = os.path.join(tmp, "trace")
        code = (f"import json, sys\nsys.path.insert(0, {HERE!r})\nimport chip_smoke\n"
                "print(json.dumps(chip_smoke.profiled_training(sys.argv[1:])))\n")
        proc = subprocess.run([sys.executable, "-c", code, "-config", cfg_path, "--flash",
                               "--epochs", "2", "--profile", trace_dir],
                              cwd=tmp, stdout=subprocess.PIPE, text=True, timeout=600)
        require(proc.returncode == 0, f"apps/train.py --profile exited {proc.returncode}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        epochs = {int(e): v for e, v in run["epochs"].items()}
        cli_counts, calls = run["counts"], run["calls"]
        launches.update(cli_counts)
        exp = os.path.join(tmp, run["exp_dir"])
        traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
        require(len(traces) == 1, f"--profile wrote {traces}")
        trace_path = os.path.join(trace_dir, traces[0])
        with open(trace_path, encoding="utf-8") as fh:
            events = json.load(fh)["traceEvents"]
        kernels = collections.Counter()
        kernel_us = collections.Counter()
        for e in events:
            if e.get("cat") == "kernel":
                kernels[e["name"]] += 1
                kernel_us[e["name"]] += e.get("dur", 0)
        prof = epochs[0]["counts"]
        seen = {name: sum(n for k, n in kernels.items() if pattern.search(k))
                for name, (pattern, _) in TRACE_KERNELS.items()}
        summary.update(
            cli_s=run["cli_s"], trace_mib=os.path.getsize(trace_path) / 2 ** 20,
            trace_kernel_events=sum(kernels.values()), trace_kernels=seen,
            profiled_epoch_launches={k: prof[k] for k in TRACE_KERNELS},
            epoch_s=[epochs[e]["s"] for e in sorted(epochs)], native_calls=calls)
        log(f"apps/train.py --flash --profile (its own process): 2 epochs in "
            f"{run['cli_s']:.1f} s, {run['global_step']} steps; epoch seconds "
            f"{summary['epoch_s']} (profiled: {[epochs[e]['profiled'] for e in sorted(epochs)]}); "
            f"trace {summary['trace_mib']:.1f} MiB, {len(events)} events, "
            f"{summary['trace_kernel_events']} kernel events; hand-written kernels in the "
            f"trace {seen} against the profiled epoch's launches "
            f"{summary['profiled_epoch_launches']}; native calls {calls}")
        log("  the trace's kernels with the most device time: " + ", ".join(
            f"{k[:60]} {us / 1e3:.2f} ms ({kernels[k]})" for k, us in kernel_us.most_common(6)))
        require(sorted(epochs) == [0, 1] and epochs[0]["profiled"] and not epochs[1]["profiled"],
                f"profiled epochs {[(e, epochs[e]['profiled']) for e in sorted(epochs)]}")
        require(run["global_step"] == 2 * 4, f"{run['global_step']} steps")
        for name, (_, per_launch) in TRACE_KERNELS.items():
            require(prof[name] > 0 and seen[name] == prof[name] * per_launch,
                    f"{name}: {seen[name]} kernel events in the trace, {prof[name]} launches "
                    "in the profiled epoch")
        require(calls["logmel"] >= 2 * 24 and calls["batch_levenshtein"] >= 2,
                f"the native counters did not move in the loader and the evaluation: {calls}")

        # (e) average the two epochs and serve the average
        avg = average_checkpoints.main([exp, "--nbest", "2"])
        with open(os.path.join(avg, "meta.json")) as fh:
            meta = json.load(fh)
        require(sorted(meta["averaged_from"]) == ["epoch_0", "epoch_1"], f"averaged {meta}")
        eps = [ckpt_lib.load_checkpoint(os.path.join(exp, f"epoch_{e}"), "cpu") for e in (0, 1)]
        got = ckpt_lib.load_checkpoint(avg, "cpu")
        n_leaves = 0
        for comp in ckpt_lib.COMPONENTS:
            for key, leaf in got[comp].items():
                mean = ((eps[0][comp][key].double() + eps[1][comp][key].double()) / 2).float()
                require(torch.equal(leaf, mean), f"{comp}.{key} is not the float64 mean")
                n_leaves += 1
        cli_cfg = load_cfg_file(cfg_path)
        with open(cli_cfg.data.dev, encoding="utf-8") as fh:
            wav = fh.read().splitlines()[1].split(",")[0]
        reset_counts()
        text = predict_app.main(["--config", cfg_path, "--checkpoint", avg, "--wav", wav,
                                 "--full-context"])
        torch.cuda.synchronize()
        counts = read_counts()
        launches.update(counts)
        wave, rate = read_wave(wav)
        feats = F.subsample(F.stack_frames(F.logmel_masked(wave, rate, n_mels), left, right),
                            factor)
        served = load_family(cli_cfg, feats.shape[1], avg, device=device, flash=True)
        require(all(torch.equal(served.state_dict()[f"{c}.{k}"], v.to(device))
                    for c in ckpt_lib.COMPONENTS for k, v in got[c].items()),
                "load_family did not restore the averaged weights")
        tokens = recognize(served, torch.from_numpy(feats[None]).to(device), [feats.shape[0]],
                           max_tokens=max_tokens)[0]
        want = "".join(Vocabulary.from_file(cli_cfg.data.vocab).decode(tokens))
        log(f"tools/average_checkpoints.py --nbest 2: {n_leaves} leaves, each the float64 mean "
            f"of epochs 0 and 1 in float32, and load_family's; apps/predict.py --full-context "
            f"on the average (2 epochs on random labels: it may emit nothing): "
            f"{len(text)} characters, {'the text of' if text == want else 'not the text of'} "
            f"recognize with the averaged weights; launches {counts}")
        require(text == want, f"predict on the average gave {text!r}, recognize {want!r}")
        require(counts["flash_fwd"] == n_layer, f"predict launched {counts}")
        del served, eps, got
        torch.cuda.empty_cache()

        # (f) phase 4's weights as a reference .chkpt, converted and served
        model = build_transducer(cfg.model, device=device).eval()
        model.load_state_dict(state)
        with torch.no_grad():
            model.joint.project_layer.bias[0] += offset           # phase 4's bias
        opt = torch.optim.SGD(model.parameters(), lr=cfg.optim.lr, momentum=0.9)
        chkpt = os.path.join(tmp, "phase4.chkpt")
        torch.save({"encoder": model.encoder.state_dict(), "decoder": model.decoder.state_dict(),
                    "joint": model.joint.state_dict(), "optimizer": opt.state_dict(),
                    "epoch": 3, "step": 12}, chkpt)
        out = convert_checkpoint.main([chkpt, os.path.join(tmp, "converted")])
        x, t_len = phase4["x"], phase4["t_len"]
        for name, flash in (("band", False), ("full-context", True)):
            served = load_family(cfg, x.shape[-1], out, device=device, flash=flash).eval()
            require(all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                           served.state_dict().values())),
                    "the converted checkpoint did not restore phase 4's weights")
            reset_counts()
            toks = recognize(served, x, t_len, band=None if flash else band,
                             max_tokens=max_tokens)
            torch.cuda.synchronize()
            counts = read_counts()
            launches.update(counts)
            kernel = "flash_fwd" if flash else "banded_fwd"
            require(counts[kernel] == n_layer and sum(counts.values()) == n_layer,
                    f"{name}: the converted model launched {counts}")
            with torch.no_grad():
                enc = served.encode(x) if flash else served.encode_banded(x, *band)
            compare_tokens(f"converted .chkpt, {name}, against phase 4", toks, phase4[name],
                           served, enc, enc, t_len, max_tokens)
            del served
        del model
    torch.cuda.empty_cache()
    return launches, summary


EXPORTED = ("encoder", "encoder_streaming", "decoder", "joint")


def run_exported(root) -> dict:
    """Phase 16 (a), in a fresh process: ``load_exported`` of the four
    programs under ``root``, each run once on ``inputs.pt`` with the
    counts from 0 (the outputs to ``outputs.pt``), and the encoder graph's
    ``ttx::flash_rel_attention_fwd`` nodes."""
    import torch
    from transformer_transducer_tpu_torch.runtime.export import load_exported
    inputs = torch.load(os.path.join(root, "inputs.pt"))
    start = time.perf_counter()
    programs = {n: load_exported(os.path.join(root, f"{n}.pt2")) for n in EXPORTED}
    load_s = time.perf_counter() - start
    op = torch.ops.ttx.flash_rel_attention_fwd.default
    nodes = sum(1 for n in programs["encoder"].graph.nodes if n.target is op)
    args = {"encoder": ("x",), "encoder_streaming": ("x",), "decoder": ("tokens",),
            "joint": ("e", "d")}
    outputs, counts = {}, {}
    with torch.no_grad():
        for name, program in programs.items():
            reset_counts()      # each program's call: counts from 0, read after
            out = program(*(inputs[a].cuda() for a in args[name]))
            torch.cuda.synchronize()
            counts[name] = read_counts()
            outputs[name] = out.cpu()
    torch.save(outputs, os.path.join(root, "outputs.pt"))
    return {"load_s": load_s, "op_nodes": nodes, "counts": counts}


def dp_rank(job_path) -> dict:
    """Phase 16 (b), one of the ranks that ``check_export_dp`` launches
    (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_*`` set; both on the one card): in a gloo group, 3 ``--n_data
    2 --flash`` steps on its rows of phase 8's batch (dropout 0, no
    SpecAugment), then the same 3 steps with ``--zero`` (counts from 0
    around each), each run's moment bytes and peak memory; then, the group left, ``apps/train.py --flash --n_data 2
    --zero`` for one epoch of phase 7's corpus, which joins a group of its
    own from the environment (at the job's second port)."""
    import torch
    import torch.distributed as dist
    from transformer_transducer_tpu_torch.apps import train as train_app
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from transformer_transducer_tpu_torch.parallel.sharding import zero_param_shardings
    from transformer_transducer_tpu_torch.training.optim import build_optimizer
    from transformer_transducer_tpu_torch.training.train_step import (
        TrainStepConfig, make_train_step)
    from transformer_transducer_tpu_torch.utils.config import Config
    job = torch.load(job_path, weights_only=False)     # this run's own file
    dist.init_process_group("gloo", init_method="env://")
    device = torch.device("cuda", 0)
    mesh = make_mesh(n_data=2)
    batch = shard_batch({k: v.to(device) for k, v in job["batch"].items()}, mesh)

    def run(zero, mode="flash"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_transducer(Config(job["model"]), flash=mode == "flash",
                                 banded=mode == "banded", device=device)
        model.load_state_dict(job["state"])
        model.train()
        opt = build_optimizer(Config(job["optim"]), list(model.parameters()),
                              max_grad_norm=200.0,
                              zero=(mesh, zero_param_shardings(model, mesh)) if zero else None)
        step = make_train_step(model, opt, TrainStepConfig(specaug=False), mesh=mesh)
        steps, grads = [], None
        for i in range(3):
            reset_counts()
            m = step(batch, None)
            torch.cuda.synchronize()
            steps.append((float(m["loss"]), float(m["grad_norm"]), read_counts()))
            if i == 0:      # step 1's gradients after the data mean
                grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                         for p in model.parameters()]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return steps, opt.moment_bytes(), peak, grads

    # plain dp first, for its peak memory at the same rows; then ZeRO-1
    plain_steps, plain_bytes, plain_peak, flash_grads = run(False)
    steps, moment_bytes, peak, _ = run(True)
    # plain dp through the banded kernels, which sum in a fixed order
    banded_steps, _, _, banded_grads = run(False, "banded")
    out = {"rank": mesh.data_rank, "steps": steps, "moment_bytes": moment_bytes,
           "peak_gib": peak, "plain_losses": [s[0] for s in plain_steps],
           "plain_moment_bytes": plain_bytes, "plain_peak_gib": plain_peak,
           "banded_steps": banded_steps, "rows": int(batch["inputs"].shape[0])}
    if mesh.data_rank == 0:
        # the split yardstick, in this process with no group: step 1 as
        # the mean of one process's gradients on each rank's rows
        out["split"] = {mode: split_yardstick(job, mode, device, grads, dp_steps[0])
                        for mode, grads, dp_steps in (("banded", banded_grads, banded_steps),
                                                      ("flash", flash_grads, plain_steps))}
    del flash_grads, banded_grads
    dist.barrier()
    dist.destroy_process_group()
    os.environ["MASTER_PORT"] = str(job["cli_port"])
    os.chdir(job["cli_dir"])
    reset_counts()
    start = time.perf_counter()
    trainer = train_app.main(["-config", job["cli_config"], "--flash", "--epochs", "1",
                              "--n_data", "2", "--zero"])
    torch.cuda.synchronize()
    out["cli"] = {"s": time.perf_counter() - start, "counts": read_counts(),
                  "backend": dist.get_backend() if dist.is_initialized() else None,
                  "n_data": trainer.mesh.n_data, "zero": trainer.zero,
                  "global_step": trainer.global_step, "exp_dir": trainer.exp_dir,
                  "moment_bytes": trainer.optimizer.moment_bytes()}
    dist.barrier()
    dist.destroy_process_group()
    return out


def split_yardstick(job, mode, device, dp_grads, dp_step) -> dict:
    """Phase 16's split yardstick in one process: step 1's gradients on
    each of the two ranks' 2-row halves of phase 8's batch, their mean
    ``(g0 + g1) / 2`` in float32 (what the gloo all-reduce of two terms and
    ``all_reduce_mean_``'s division compute) and the gradients on all 4
    rows; ``dp_grads`` (data-parallel step 1's, leaf by leaf) against both:
    the leaves equal to the bit, and the largest relative error
    (``max|dp - ref| / max|ref|``) and its leaf; the losses and norms."""
    import torch
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.training.optim import global_norm
    from transformer_transducer_tpu_torch.training.train_step import (
        TrainStepConfig, make_loss_fn)
    from transformer_transducer_tpu_torch.utils.config import Config
    model = build_transducer(Config(job["model"]), flash=mode == "flash",
                             banded=mode == "banded", device=device)
    model.load_state_dict(job["state"])
    model.train()
    names = [n for n, _ in model.named_parameters()]
    loss_fn = make_loss_fn(model, TrainStepConfig(specaug=False))
    batch = {k: v.to(device) for k, v in job["batch"].items()}
    rows = batch["inputs"].shape[0]

    def grads(part):
        model.zero_grad(set_to_none=True)
        loss = loss_fn({k: v[part] for k, v in batch.items()}, None)
        loss.backward()
        return loss.detach(), [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                               for p in model.parameters()]
    l0, g0 = grads(slice(0, rows // 2))
    l1, g1 = grads(slice(rows // 2, rows))
    split = [(a + b) / 2 for a, b in zip(g0, g1)]
    del g0, g1
    whole_loss, whole = grads(slice(0, rows))

    def against(ref):
        rels = [float((d - r).abs().max() / r.abs().max().clamp_min(1e-30))
                for d, r in zip(dp_grads, ref)]
        worst = max(range(len(rels)), key=lambda i: rels[i])
        return {"equal_leaves": sum(torch.equal(d, r) for d, r in zip(dp_grads, ref)),
                "leaves": len(ref), "max_rel": rels[worst], "leaf": names[worst],
                "norm": float(global_norm(ref))}
    out = {"split": dict(against(split), loss=float((l0 + l1) / 2)),
           "whole": dict(against(whole), loss=float(whole_loss)),
           "dp": {"loss": dp_step[0], "norm": dp_step[1]}}
    del model, split, whole
    torch.cuda.empty_cache()
    return out


def reference_steps(cfg_model, optim_cfg, state, batch, device, mode="flash", mesh=None):
    """3 single-process steps on the whole batch (dropout 0, no SpecAugment,
    SGD as the trainer builds it): (loss, gradient norm) a step, the
    optimizer's moment bytes."""
    import torch
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.training.optim import build_optimizer
    from transformer_transducer_tpu_torch.training.train_step import (
        TrainStepConfig, make_train_step)
    model = build_transducer(cfg_model, flash=mode == "flash", banded=mode == "banded",
                             device=device)
    model.load_state_dict(state)
    model.train()
    opt = build_optimizer(optim_cfg, list(model.parameters()), max_grad_norm=200.0)
    step = make_train_step(model, opt, TrainStepConfig(specaug=False), mesh=mesh)
    out = []
    for _ in range(3):
        m = step(batch, None)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, opt.moment_bytes()


def check_export_dp(cfg, state, phase4, batch, device, smi):
    """Phase 16: the export of the flagship and data-parallel training
    with ZeRO-1 (see the module's docstring).  ``batch`` is phase 8's B 4
    batch.  The two ranks start first, so that their start-up overlaps the
    export's tracing, and the fresh process that runs the programs starts
    as soon as they are written; the timings wait until all have ended.
    Returns the main paths' launches and a summary."""
    import torch
    import torch.distributed as dist
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops.masks import context_mask, look_ahead_mask
    from transformer_transducer_tpu_torch.parallel.mesh import make_mesh
    from transformer_transducer_tpu_torch.runtime.export import (
        export_transducer, load_exported)
    from transformer_transducer_tpu_torch.utils.config import Config
    launches = collections.Counter()
    summary = {"device": smi}
    band = (cfg.model.enc.left_context, cfg.model.enc.right_context)
    n_layer, v = cfg.model.enc.n_layer, cfg.model.vocab_size
    max_tokens = cfg.data.max_target_length + 1
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, os.environ.get("PYTHONPATH", "")]))
    model_cfg = load_flagship().model
    model_cfg.override("dropout", 0.0)
    optim_cfg = Config({"type": "sgd", "lr": cfg.optim.lr, "momentum": 0.9})
    with tempfile.TemporaryDirectory() as tmp:
        # (b) two ranks on the one card through gloo (dp_rank)
        cli_dir = os.path.join(tmp, "cli")
        os.makedirs(cli_dir)
        with socket.socket() as sock, socket.socket() as sock2:
            sock.bind(("localhost", 0))
            sock2.bind(("localhost", 0))
            port, cli_port = sock.getsockname()[1], sock2.getsockname()[1]
        job = {"model": model_cfg, "state": state, "optim": optim_cfg,
               "batch": {k: v.cpu() for k, v in batch.items()},
               "cli_dir": cli_dir, "cli_config": write_corpus(cli_dir, cfg),
               "cli_port": cli_port}
        job_path = os.path.join(tmp, "dp_job.pt")
        torch.save(job, job_path)
        code = (f"import json, sys\nsys.path.insert(0, {HERE!r})\nimport chip_smoke\n"
                "print(json.dumps(chip_smoke.dp_rank(sys.argv[1])))\n")
        dp_start = time.perf_counter()
        child = None
        procs = [subprocess.Popen([sys.executable, "-c", code, job_path], stdout=subprocess.PIPE,
                                  text=True, env=dict(env, RANK=str(r), LOCAL_RANK=str(r),
                                                      WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                                                      MASTER_ADDR="localhost",
                                                      MASTER_PORT=str(port)))
                 for r in range(2)]
        try:
            # (a) the flagship (flash=True) exported on the card while they
            # start, and the live model's outputs
            model = build_transducer(cfg.model, flash=True, device=device)
            model.load_state_dict(state)
            start = time.perf_counter()
            paths = export_transducer(model, tmp, max_frames=T_MAIN, max_tokens=max_tokens,
                                      d_in=cfg.model.enc.d_model, left_context=band[0],
                                      right_context=band[1])
            summary["export_s"] = time.perf_counter() - start
            summary["mib"] = {n: os.path.getsize(p) / 2 ** 20 for n, p in paths.items()}
            g = torch.Generator().manual_seed(16)
            inputs = {"x": phase4["x"][:1].cpu(),
                      "tokens": torch.randint(1, v, (1, max_tokens), generator=g),
                      "e": torch.randn(1, cfg.model.enc.d_model, generator=g),
                      "d": torch.randn(1, cfg.model.dec.d_model, generator=g)}
            torch.save(inputs, os.path.join(tmp, "inputs.pt"))
            code = (f"import json, sys\nsys.path.insert(0, {HERE!r})\nimport chip_smoke\n"
                    "print(json.dumps(chip_smoke.run_exported(sys.argv[1])))\n")
            child = subprocess.Popen([sys.executable, "-c", code, tmp], env=env,
                                     stdout=subprocess.PIPE, text=True)
            x = inputs["x"].to(device)
            with torch.no_grad():
                reset_counts()
                live = {"encoder": model.encode(x)}
                torch.cuda.synchronize()
                live_counts = read_counts()
                live["encoder_streaming"] = model.encode(
                    x, context_mask(T_MAIN, *band, device=device))
                live["decoder"] = model.predict(inputs["tokens"].to(device),
                                                look_ahead_mask(max_tokens, device=device))
                live["joint"] = model.joint_logits(inputs["e"].to(device),
                                                   inputs["d"].to(device))
            ref, ref_bytes = reference_steps(model_cfg, optim_cfg, state, batch, device)
            outs = [p.communicate(timeout=400)[0] for p in procs]
            exported_out = child.communicate(timeout=300)[0]
        finally:
            for p in procs + [child]:
                if p is not None:
                    p.kill()
        summary["dp_s"] = time.perf_counter() - dp_start
        launches.update(live_counts)
        require(live_counts["flash_fwd"] == n_layer, f"live encode launched {live_counts}")
        require(all(p.returncode == 0 for p in procs),
                f"the data-parallel ranks exited {[p.returncode for p in procs]}")
        ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        per_step = dict.fromkeys(read_counts(), 0)
        per_step.update(flash_fwd=n_layer, flash_bwd=n_layer, alpha=1, beta=1)
        for r in ranks:
            for i, ((loss, norm, counts), (ref_loss, ref_norm)) in enumerate(
                    zip(r["steps"], ref)):
                rel = abs(loss - ref_loss) / abs(ref_loss)
                log(f"  rank {r['rank']} step {i + 1}: loss {loss:.6f} / one process "
                    f"{ref_loss:.6f} (rel {rel:.2e}), grad norm {norm:.5f} / {ref_norm:.5f}; "
                    f"launches {counts}")
                require(counts == per_step, f"rank {r['rank']} step {i + 1} launched {counts}")
                require(rel <= LOSS_RTOL, f"dp step {i + 1}: losses differ by {rel:.2e}")
                if i == 0:
                    rel_n = abs(norm - ref_norm) / ref_norm
                    require(rel_n <= NORM_RTOL, f"dp step 1: gradient norms differ by {rel_n:.2e}")
                launches.update(counts)
            cli = r["cli"]
            launches.update(cli["counts"])
            require(cli["backend"] == "gloo" and cli["n_data"] == 2 and cli["zero"]
                    and cli["global_step"] == 4
                    and all(cli["counts"][k] > 0 for k in ("flash_fwd", "flash_bwd", "alpha",
                                                           "beta")),
                    f"rank {r['rank']}: the training entry point ran {cli}")
        for r in ranks:
            rel = max(abs(a - b) / abs(b) for a, (b, _) in zip(r["plain_losses"], ref))
            require(rel <= LOSS_RTOL, f"rank {r['rank']}: plain dp losses differ by {rel:.2e}")
        share = [r["moment_bytes"] / ref_bytes for r in ranks]
        require(all(s <= 0.51 for s in share), f"moment bytes a rank {share} of one process's")
        exp = os.path.join(cli_dir, ranks[0]["cli"]["exp_dir"])
        saved = torch.load(os.path.join(exp, "epoch_0", "model.pt"), map_location="cpu")
        names = [n for n, _ in build_transducer(cfg.model, device="meta").named_parameters()]
        require(len(saved["optimizer"]["state"]["trace"]) == len(names)
                and all(t.shape == state[n].shape
                        for t, n in zip(saved["optimizer"]["state"]["trace"], names)),
                "the 2-rank run's checkpoint does not hold whole moments")
        with open(os.path.join(exp, "train.log"), encoding="utf-8") as fh:
            cer_lines = [l.strip() for l in fh if "-Validation-" in l]
        require(len(cer_lines) == 1 and "nan" not in cer_lines[0].lower(),
                f"the 2-rank run's evaluation: {cer_lines}")
        summary.update(dp_steps=[r["steps"] for r in ranks], one_process=ref,
                       moment_share=share, peak_gib=[r["peak_gib"] for r in ranks],
                       plain_peak_gib=[r["plain_peak_gib"] for r in ranks],
                       plain_moment_share=[r["plain_moment_bytes"] / ref_bytes for r in ranks],
                       cli_s=[r["cli"]["s"] for r in ranks])
        log(f"--n_data 2 --zero --flash, two gloo ranks on the one card ({summary['dp_s']:.1f} s "
            f"with their start-up, beside the export): losses and step 1's gradient norm "
            f"within {LOSS_RTOL} and {NORM_RTOL} of one process on the whole batch; moments a "
            f"rank " + ", ".join(f"{100 * s:.4f} %" for s in share)
            + " of one process's; peak memory a rank, ZeRO-1 / plain dp at the same rows "
            + ", ".join(f"{r['peak_gib']:.4f} / {r['plain_peak_gib']:.4f} GiB" for r in ranks)
            + f"; apps/train.py over the two ranks (its own {ranks[0]['cli']['backend']} "
            f"group): 4 steps in "
            + ", ".join(f"{r['cli']['s']:.1f} s" for r in ranks) + f", {cer_lines[0]}")

        # (a) the programs in the fresh process (run_exported) against the
        # live model; then, with the card to this process, the live and the
        # exported encoder timed here in turns (live, exported, exported, live)
        require(child.returncode == 0, f"the exported programs' process exited "
                f"{child.returncode}")
        run = json.loads(exported_out.strip().splitlines()[-1])
        outputs = torch.load(os.path.join(tmp, "outputs.pt"))
        errs = {}
        for name in EXPORTED:
            want = live[name].cpu()
            got = outputs[name]
            require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                    f"exported {name}: shape {tuple(got.shape)} or not finite")
            errs[name] = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"exported {name}: {m}")
        enc_counts = run["counts"]["encoder"]
        want = dict.fromkeys(enc_counts, 0)
        want["flash_fwd"] = n_layer
        require(run["op_nodes"] == n_layer and enc_counts == want,
                f"the exported encoder holds {run['op_nodes']} op nodes and launched "
                f"{enc_counts} a call (want {n_layer} flash forwards)")
        for name in ("encoder_streaming", "decoder", "joint"):
            require(not any(run["counts"][name].values()),
                    f"exported {name} launched {run['counts'][name]}")
        launches.update(enc_counts)
        program = load_exported(paths["encoder"])
        turns = {"live": [], "exported": []}
        with torch.no_grad():
            for name in ("live", "exported", "exported", "live"):
                fn = (lambda: model.encode(x)) if name == "live" else (lambda: program(x))
                turns[name].append(cuda_ms(fn, samples=10, reps=3))
            busy = {"live": device_busy_ms(lambda: model.encode(x)),
                    "exported": device_busy_ms(lambda: program(x))}
        summary.update(export_max_abs_err=errs, load_s=run["load_s"], op_nodes=run["op_nodes"],
                       encoder_ms_in_turns=turns, encoder_busy_ms=busy)
        log(f"export of the flagship (flash=True) on the card in {summary['export_s']:.1f} s "
            f"(beside the two ranks' start-up): "
            + ", ".join(f"{n} {mib:.1f} MiB" for n, mib in summary["mib"].items())
            + f"; a fresh process loaded them in {run['load_s']:.1f} s (beside the ranks); the "
            f"encoder program "
            f"holds {run['op_nodes']} ttx::flash_rel_attention_fwd nodes and launched "
            f"{enc_counts['flash_fwd']} flash forwards a call; max|exported - live| "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (rtol = atol = 1e-5); the encoder in turns here: live {turns['live'][0]:.3f}, exported "
            f"{turns['exported'][0]:.3f}, {turns['exported'][1]:.3f}, live "
            f"{turns['live'][1]:.3f} ms (CUDA events), device busy {busy['live']:.3f} ms live, "
            f"{busy['exported']:.3f} ms exported ({smi})")
        del model, live, outputs, program
        torch.cuda.empty_cache()

    # (c) a world-1 NCCL group (a FileStore) against no group: the banded
    # path, whose kernels sum in a fixed order, to the bit
    ref_banded, _ = reference_steps(model_cfg, optim_cfg, state, batch, device, "banded")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh()
            grouped, _ = reference_steps(model_cfg, optim_cfg, state, batch, device,
                                         "banded", mesh=mesh)
        finally:
            dist.destroy_process_group()
    require(mesh.n_data == 1 and grouped == ref_banded,
            f"a world-1 NCCL group: {grouped} against {ref_banded} with none")
    # plain dp through the banded kernels (no atomics) against one process
    per_step = dict.fromkeys(read_counts(), 0)
    per_step.update(banded_fwd=n_layer, banded_bwd=n_layer, alpha=1, beta=1)
    summary["banded_dp"] = {}
    for r in ranks:
        rels = []
        for i, ((loss, norm, counts), (ref_loss, ref_norm)) in enumerate(
                zip(r["banded_steps"], ref_banded)):
            rel, rel_n = abs(loss - ref_loss) / abs(ref_loss), abs(norm - ref_norm) / ref_norm
            rels.append((rel, rel_n))
            require(counts == per_step, f"banded dp rank {r['rank']} step {i + 1} launched "
                    f"{counts}")
            require(rel <= LOSS_RTOL, f"banded dp step {i + 1}: losses differ by {rel:.2e}")
            if i == 0:
                require(rel_n <= NORM_RTOL, f"banded dp step 1: norms differ by {rel_n:.2e}")
            launches.update(counts)
        summary["banded_dp"][r["rank"]] = rels
    log("--n_data 2 --banded, plain dp: losses and gradient norms against one process, "
        "relative, a step: " + "; ".join(
            f"rank {k} " + ", ".join(f"{a:.2e} / {b:.2e}" for a, b in v)
            for k, v in summary["banded_dp"].items())
        + f" (flash dp's step 1 norm: " + ", ".join(
            f"{abs(r['steps'][0][1] - ref[0][1]) / ref[0][1]:.2e}" for r in ranks) + ")")
    log(f"a world-1 NCCL group (FileStore): 3 banded steps' losses and gradient norms "
        f"equal to the bit to no group's: {[l for l, _ in grouped]}")
    # the split yardstick (rank 0's, in one process): step 1 of dp against
    # the mean of one process's gradients on the ranks' halves, and
    # against the 4-row step, leaf by leaf
    split = next(r["split"] for r in ranks if "split" in r)
    summary["split_yardstick"] = split
    for mode, res in split.items():
        for ref in ("split", "whole"):
            got = res[ref]
            log(f"  {mode} dp step 1 against the {'2 + 2-row split' if ref == 'split' else '4-row step'}"
                f": {got['equal_leaves']} of {got['leaves']} leaves equal to the bit; largest "
                f"relative error {got['max_rel']:.3e} ({got['leaf']}); loss "
                f"{res['dp']['loss']!r} / {got['loss']!r}, norm {res['dp']['norm']!r} / "
                f"{got['norm']!r}")
        rel = abs(res["dp"]["loss"] - res["split"]["loss"]) / abs(res["split"]["loss"])
        rel_n = abs(res["dp"]["norm"] - res["split"]["norm"]) / res["split"]["norm"]
        if mode == "banded":
            # no atomics: the ranks' gradients are one process's, and the
            # all-reduce of two terms and the halving are exact
            require(res["split"]["equal_leaves"] == res["split"]["leaves"] and rel == 0
                    and rel_n == 0, f"banded dp step 1 against the split: {res['split']}, "
                    f"dp {res['dp']}")
        else:
            require(rel <= LOSS_RTOL and rel_n <= NORM_RTOL,
                    f"flash dp step 1 against the split: loss {rel:.2e}, norm {rel_n:.2e}")
    return dict(launches), summary


class _TimedSums:
    """``parallel/tensor.py``'s float32 sum over the model group, timed
    (phase 17): milliseconds of every call and of the logits' (4-D: a
    joint chunk's (B, C, U1 | S, V)), between device synchronisations."""

    def __init__(self, fn, device):
        self.fn, self.device = fn, device
        self.reset()

    def reset(self):
        self.ms, self.logits_ms, self.logits_bytes = 0.0, 0.0, 0

    def __call__(self, x, group):
        sync(self.device)
        start = time.perf_counter()
        out = self.fn(x, group)
        sync(self.device)
        ms = 1e3 * (time.perf_counter() - start)
        self.ms += ms
        if x.dim() == 4:
            self.logits_ms += ms
            self.logits_bytes += x.numel() * 4
        return out


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> int:
    """Empty the allocator's cache and reset its peak; the bytes allocated
    now (0 off the card)."""
    import torch
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gib(device, base=0):
    """Peak bytes the caching allocator handed out since the last reset,
    above ``base``, in GiB (0 off the card)."""
    import torch
    if torch.device(device).type != "cuda":
        return 0.0
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def tp_steps(run, mesh, device, batch, sums, steps=3):
    """3 steps of one phase 17 run on this rank of ``mesh`` (``run``:
    model config and state, attention mode, pruned band, compute dtype,
    ZeRO-1), SpecAugment and dropout seeded as ``train_three_steps`` seeds
    them: per step (loss, norm, launch counts, step ms, all-reduce ms,
    logits all-reduce ms, logits bytes), and the rank's parameter, moment
    and peak bytes (above its baseline)."""
    import torch
    base = reset_peak(device)
    model, opt, step = make_trainee(run["model"], run["optim"], run["state"], run["mode"],
                                    device, run.get("pruned"),
                                    compute_dtype=run.get("compute_dtype"), mesh=mesh,
                                    zero=run.get("zero", False))
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    out = []
    for _ in range(steps):
        reset_counts()
        sums.reset()
        sync(device)
        start = time.perf_counter()
        m = step(batch, gen)
        sync(device)
        ms = 1e3 * (time.perf_counter() - start)
        out.append((float(m["loss"]), float(m["grad_norm"]), read_counts(), ms, sums.ms,
                    sums.logits_ms, sums.logits_bytes))
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    result = {"steps": out, "param_bytes": param_bytes, "moment_bytes": opt.moment_bytes(),
              "peak_gib": peak_gib(device, base)}
    del model, opt, step
    return result


def tp_rank(job_path) -> dict:
    """Phase 17, one of the ranks that ``check_tensor_parallel`` launches
    (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_*`` set; all on the one card): in a gloo group, the grid of
    ``make_mesh(n_data=job["n_data"], n_model=2)``; once the job's ``go``
    file exists (the one-process references are done), each of the job's
    runs (:func:`tp_steps`), the model-group sums timed; then, with a
    ``cli_config``, the group left, ``apps/train.py --flash --n_model 2``
    for one epoch of phase 7's corpus, which joins a group of its own from
    the environment (at the job's second port)."""
    import torch
    import torch.distributed as dist
    from transformer_transducer_tpu_torch.apps import train as train_app
    from transformer_transducer_tpu_torch.parallel import tensor as tensor_lib
    from transformer_transducer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    job = torch.load(job_path, weights_only=False)     # this run's own file
    device = job["device"]
    dist.init_process_group("gloo", init_method="env://")
    mesh = make_mesh(n_data=job["n_data"], n_model=2)
    sums = _TimedSums(tensor_lib._sum_over, device)
    tensor_lib._sum_over = sums
    waited = time.perf_counter()
    while not os.path.exists(job["go"]):
        require(time.perf_counter() - waited < 600, "phase 17: the references did not end")
        time.sleep(0.2)
    out = {"rank": dist.get_rank(), "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank, "runs": {}}
    for name, run in job["runs"].items():
        batch = shard_batch({k: v.to(device) for k, v in job["batches"][run["batch"]].items()},
                            mesh)
        out["runs"][name] = tp_steps(run, mesh, device, batch, sums)
        out["rows"] = int(batch["inputs"].shape[0])
    tensor_lib._sum_over = sums.fn
    dist.barrier()
    dist.destroy_process_group()
    if job.get("cli_config"):
        os.environ["MASTER_PORT"] = str(job["cli_port"])
        os.chdir(job["cli_dir"])
        reset_counts()
        start = time.perf_counter()
        trainer = train_app.main(["-config", job["cli_config"], "--flash", "--epochs", "1",
                                  "--n_model", "2", "--device", device])
        sync(device)
        out["cli"] = {"s": time.perf_counter() - start, "counts": read_counts(),
                      "backend": dist.get_backend() if dist.is_initialized() else None,
                      "n_data": trainer.mesh.n_data, "n_model": trainer.mesh.n_model,
                      "global_step": trainer.global_step, "exp_dir": trainer.exp_dir}
        dist.barrier()
        dist.destroy_process_group()
    return out


def launch_ranks(world, job, tmp, env, name, fn="tp_rank"):
    """Start ``world`` ranks of :func:`tp_rank` (or of the function named
    ``fn``) on ``job`` (saved under ``tmp``), gloo on one card; returns the
    processes."""
    import torch
    with socket.socket() as sock, socket.socket() as sock2:
        sock.bind(("localhost", 0))
        sock2.bind(("localhost", 0))
        port, job["cli_port"] = sock.getsockname()[1], sock2.getsockname()[1]
    path = os.path.join(tmp, f"{name}.pt")
    torch.save(job, path)
    code = (f"import json, sys\nsys.path.insert(0, {HERE!r})\nimport chip_smoke\n"
            f"print(json.dumps(chip_smoke.{fn}(sys.argv[1])))\n")
    return [subprocess.Popen([sys.executable, "-c", code, path], stdout=subprocess.PIPE,
                             text=True, env=dict(env, RANK=str(r), LOCAL_RANK=str(r),
                                                 WORLD_SIZE=str(world),
                                                 LOCAL_WORLD_SIZE=str(world),
                                                 MASTER_ADDR="localhost",
                                                 MASTER_PORT=str(port)))
            for r in range(world)]


def join_ranks(procs, timeout):
    """The JSON results of :func:`launch_ranks`'s processes (every process
    killed on the way out)."""
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    require(all(p.returncode == 0 for p in procs),
            f"the ranks exited {[p.returncode for p in procs]}")
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def serve_cli_checkpoint(cfg, job, ranks, device, name):
    """The ``epoch_0`` that a multi-rank ``apps/train.py`` run (its ranks'
    ``cli`` results) wrote holds the whole model and moments and one
    evaluation line, and one-process ``apps/predict.py --full-context``
    serves it with ``recognize``'s text; (predict's launches, its text,
    the evaluation line)."""
    import torch
    from transformer_transducer_tpu_torch.apps import predict as predict_app
    from transformer_transducer_tpu_torch.decoding.greedy import recognize
    from transformer_transducer_tpu_torch.data.wav import read_wave
    from transformer_transducer_tpu_torch.models.factory import load_family
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.utils import checkpoint as ckpt_lib
    from transformer_transducer_tpu_torch.utils.config import (
        load_config as load_cfg_file, stack_context, subsample_factor)
    from transformer_transducer_tpu_torch.utils.vocab import Vocabulary
    exp = os.path.join(job["cli_dir"], ranks[0]["cli"]["exp_dir"])
    ckpt = os.path.join(exp, "epoch_0")
    saved = ckpt_lib.load_checkpoint(ckpt, "cpu")
    whole = build_transducer(cfg.model, device="meta").state_dict()
    require(all(v.shape == whole[f"{c}.{k}"].shape for c in ckpt_lib.COMPONENTS
                for k, v in saved[c].items())
            and len(saved["optimizer"]["state"]["trace"]) == len(whole)
            and all(t.shape == w.shape for t, w in
                    zip(saved["optimizer"]["state"]["trace"], whole.values())),
            f"the {name} run's checkpoint does not hold the whole model")
    with open(os.path.join(exp, "train.log"), encoding="utf-8") as fh:
        cer_lines = [l.strip() for l in fh if "-Validation-" in l]
    require(len(cer_lines) == 1 and "nan" not in cer_lines[0].lower(),
            f"the {name} run's evaluation: {cer_lines}")
    cli_cfg = load_cfg_file(job["cli_config"])
    with open(cli_cfg.data.dev, encoding="utf-8") as fh:
        wav = fh.read().splitlines()[1].split(",")[0]
    reset_counts()
    text = predict_app.main(["--config", job["cli_config"], "--checkpoint", ckpt,
                             "--wav", wav, "--full-context", "--device", str(device)])
    sync(device)
    counts = read_counts()
    wave, rate = read_wave(wav)
    left, right = stack_context(cli_cfg.data)
    feats = F.subsample(F.stack_frames(F.logmel_masked(wave, rate, cli_cfg.data.feature_dim),
                                       left, right), subsample_factor(cli_cfg.data))
    served = load_family(cli_cfg, feats.shape[1], ckpt, device=device, flash=True)
    tokens = recognize(served, torch.from_numpy(feats[None]).to(device), [feats.shape[0]],
                       max_tokens=cli_cfg.data.max_target_length + 1)[0]
    want = "".join(Vocabulary.from_file(cli_cfg.data.vocab).decode(tokens))
    require(text == want, f"predict on the {name} checkpoint gave {text!r}, recognize {want!r}")
    require(counts["flash_fwd"] == cfg.model.enc.n_layer, f"predict launched {counts}")
    return counts, text, cer_lines[0]


def check_tensor_parallel(cfg, state, batch, device, smi):
    """Phase 17: tensor parallelism at flagship width (see the module's
    docstring).  ``batch`` is phase 8's B 4 batch.  Returns the main
    paths' launches and a summary, whose ``one_process`` holds the
    one-process runs (phase 18 holds its ranks to them too)."""
    import copy
    import torch
    from transformer_transducer_tpu_torch.utils.config import Config
    from transformer_transducer_tpu_torch.utils.convert import (
        from_jax_params, random_jax_params)
    launches = collections.Counter()
    summary = {"device": smi}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, os.environ.get("PYTHONPATH", "")]))
    model_cfg = load_flagship().model
    model_cfg.override("dropout", 0.0)
    optim_cfg = Config({"type": "sgd", "lr": cfg.optim.lr, "momentum": 0.9})
    esp = load_config("configs", "espnet_aishell.yaml")
    esp_cfg = copy.deepcopy(esp.model)
    for blk in ("enc", "dec"):
        for key in ("dropout_rate", "positional_dropout_rate", "attention_dropout_rate"):
            esp_cfg[blk][key] = 0.0
    esp_state = from_jax_params(random_jax_params(esp.model, seed=0))
    esp_batch, _ = training_batch(esp, device, seed=1)
    bf16 = torch.bfloat16
    runs = {"flash": dict(mode="flash"), "banded": dict(mode="banded"),
            f"flash, pruned {S_RANGE}": dict(mode="flash", pruned=S_RANGE),
            "bf16 flash": dict(mode="flash", compute_dtype=bf16),
            "espnet": dict(mode=None, model=esp_cfg, state=esp_state, batch="espnet")}
    for run in runs.values():
        run.setdefault("model", model_cfg)
        run.setdefault("state", state)
        run.setdefault("batch", "native")
        run["optim"] = optim_cfg
    batches = {"native": {k: v.cpu() for k, v in batch.items()},
               "espnet": {k: v.cpu() for k, v in esp_batch.items()}}
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli_dir = os.path.join(tmp, "cli")
        os.makedirs(cli_dir)
        go = os.path.join(tmp, "go")
        job = {"device": str(device), "n_data": 1, "runs": runs, "batches": batches,
               "go": go, "cli_dir": cli_dir, "cli_config": write_corpus(cli_dir, cfg)}
        procs = launch_ranks(2, job, tmp, env, "tp2")
        try:
            # the one-process references while the ranks start (they wait
            # for ``go`` before their timed steps)
            ref = {}
            for name, run in runs.items():
                base = reset_peak(device)
                ref[name] = train_three_steps(
                    run["model"], optim_cfg, run["state"], run["mode"],
                    batch if run["batch"] == "native" else esp_batch, device, False,
                    run.get("pruned"), compute_dtype=run.get("compute_dtype"))
                ref[name + " peak"] = peak_gib(device, base)
            one_bytes = {"params": sum(v.numel() * 4 for v in state.values())}
            one_bytes["trace"] = one_bytes["params"]
            with open(go, "w") as fh:
                fh.write("go")
            ranks = join_ranks(procs, 900)
        finally:
            for p in procs:
                p.kill()
        summary["tp2_s"] = time.perf_counter() - start
        for r in ranks:
            for name, res in r["runs"].items():
                for i, (got, want) in enumerate(zip(res["steps"], ref[name])):
                    loss, norm, counts, ms, sum_ms, logits_ms, logits_bytes = got
                    rel = abs(loss - want[0]) / abs(want[0])
                    rel_n = abs(norm - want[1]) / want[1]
                    log(f"  tp2 rank {r['rank']} {name} step {i + 1}: loss {loss:.6f} / one "
                        f"process {want[0]:.6f} (rel {rel:.2e}), grad norm {norm:.5f} / "
                        f"{want[1]:.5f} (rel {rel_n:.2e}); {ms:.2f} ms, sums over the model "
                        f"group {sum_ms:.2f} ms, of which the logits' {logits_ms:.2f} ms "
                        f"({logits_bytes / 2 ** 20:.1f} MiB); launches {counts}")
                    require(counts == want[2], f"tp2 rank {r['rank']} {name} step {i + 1} "
                            f"launched {counts}, one process {want[2]}")
                    # bf16: step 1 alone, as phase 14 holds it (the first
                    # clipped update turns roundings into bf16-sized steps)
                    require(rel <= LOSS_RTOL or (runs[name].get("compute_dtype") and i),
                            f"tp2 {name} step {i + 1}: losses differ by {rel:.2e}")
                    if i == 0:
                        require(rel_n <= NORM_RTOL, f"tp2 {name} step 1: gradient norms "
                                f"differ by {rel_n:.2e}")
                    launches.update(counts)
            cli = r["cli"]
            launches.update(cli["counts"])
            require(cli["backend"] == "gloo" and cli["n_model"] == 2 and cli["n_data"] == 1
                    and cli["global_step"] == 4
                    and all(cli["counts"][k] > 0 for k in ("flash_fwd", "flash_bwd", "alpha",
                                                           "beta")),
                    f"rank {r['rank']}: the training entry point ran {cli}")
        flash = [r["runs"]["flash"] for r in ranks]
        share = [f["param_bytes"] / one_bytes["params"] for f in flash]
        trace_share = [f["moment_bytes"] / one_bytes["trace"] for f in flash]
        step_ms = {name: [[s[3] for s in r["runs"][name]["steps"]] for r in ranks]
                   for name in runs}
        logits_share = {name: [[s[5] / s[3] for s in r["runs"][name]["steps"]] for r in ranks]
                        for name in runs}
        summary.update(
            one_process={n: ref[n] for n in runs},
            one_process_peak_gib={n: ref[n + " peak"] for n in runs},
            tp2={n: [r["runs"][n]["steps"] for r in ranks] for n in runs},
            tp2_peak_gib={n: [r["runs"][n]["peak_gib"] for r in ranks] for n in runs},
            param_share=share, trace_share=trace_share, step_ms=step_ms,
            logits_share=logits_share, cli_s=[r["cli"]["s"] for r in ranks])
        log(f"tp2, two gloo ranks on the one card ({summary['tp2_s']:.1f} s with their "
            f"start-up and the one-process references): losses (bf16: step 1's) and step 1's "
            f"gradient norms within {LOSS_RTOL} and {NORM_RTOL} of one process, each rank's "
            f"launches one process's; parameters a rank " + ", ".join(f"{100 * s:.4f} %" for s in share)
            + ", SGD trace " + ", ".join(f"{100 * s:.4f} %" for s in trace_share)
            + " of one process's; peak above the baseline, flash: ranks "
            + ", ".join(f"{r['runs']['flash']['peak_gib']:.4f}" for r in ranks)
            + f" GiB, one process {ref['flash peak']:.4f} GiB")
        for name in runs:
            log(f"  tp2 {name}: step ms a rank " + "; ".join(
                ", ".join(f"{ms:.2f}" for ms in per) for per in step_ms[name])
                + "; the logits' sums " + "; ".join(
                    ", ".join(f"{100 * s:.1f} %" for s in per) for per in logits_share[name])
                + f" of the step; one process's peak {ref[name + ' peak']:.4f} GiB, the "
                "ranks' " + ", ".join(f"{r['runs'][name]['peak_gib']:.4f}" for r in ranks))

        # (d) the 2-rank CLI's checkpoint: whole, served by one-process predict
        counts, text, cer_line = serve_cli_checkpoint(cfg, job, ranks, device, "tp2")
        launches.update(counts)
        log(f"apps/train.py --flash --n_model 2 over the two ranks (its own "
            f"{ranks[0]['cli']['backend']} group): 4 steps in "
            + ", ".join(f"{r['cli']['s']:.1f} s" for r in ranks) + f", {cer_line}; its "
            f"epoch_0 holds the whole model and moments; one-process apps/predict.py "
            f"--full-context on it: {len(text)} characters, the text of recognize with its "
            f"weights; launches {counts}")
        reset_peak(device)

        # (b) dp2 x tp2 on four ranks, ZeRO-1: moment bytes and peak a rank
        start4 = time.perf_counter()
        job4 = {"device": str(device), "n_data": 2, "go": go, "batches": batches,
                "runs": {"dp2 x tp2 zero": dict(runs["flash"], zero=True)}}
        ranks4 = join_ranks(launch_ranks(4, job4, tmp, env, "dp2tp2"), 600)
        summary["dp2tp2_s"] = time.perf_counter() - start4
    for r in ranks4:
        res = r["runs"]["dp2 x tp2 zero"]
        for i, (got, want) in enumerate(zip(res["steps"], ref["flash"])):
            loss, norm, counts = got[:3]
            rel = abs(loss - want[0]) / abs(want[0])
            require(counts == want[2], f"dp2 x tp2 rank {r['rank']} step {i + 1} launched "
                    f"{counts}")
            require(rel <= LOSS_RTOL, f"dp2 x tp2 step {i + 1}: losses differ by {rel:.2e}")
            if i == 0:
                rel_n = abs(norm - want[1]) / want[1]
                require(rel_n <= NORM_RTOL, f"dp2 x tp2 step 1: norms differ by {rel_n:.2e}")
            launches.update(counts)
    share4 = [r["runs"]["dp2 x tp2 zero"]["moment_bytes"] / one_bytes["trace"] for r in ranks4]
    summary.update(dp2tp2_moment_share=share4,
                   dp2tp2_peak_gib=[r["runs"]["dp2 x tp2 zero"]["peak_gib"] for r in ranks4],
                   dp2tp2_steps=[r["runs"]["dp2 x tp2 zero"]["steps"] for r in ranks4])
    # JAX's rule keeps the row-parallel project_layer's odd 6485 rows whole:
    # 29.88 % of one process's trace, from the shapes
    require(all(s <= 0.30 for s in share4), f"dp2 x tp2 moments a rank {share4}")
    log(f"dp2 x tp2 --zero --flash, four gloo ranks on the one card "
        f"({summary['dp2tp2_s']:.1f} s with their start-up): losses and step 1's norm within "
        f"the training bars, launches one process's; moments a rank "
        + ", ".join(f"{100 * s:.4f} %" for s in share4) + " of one process's trace; peak "
        "above the baseline " + ", ".join(f"{g:.4f}" for g in summary["dp2tp2_peak_gib"])
        + f" GiB; step ms " + "; ".join(", ".join(f"{s[3]:.2f}" for s in st)
                                       for st in summary["dp2tp2_steps"]) + f" ({smi})")
    return dict(launches), summary


class _TimedHops:
    """``parallel/pipeline.py``'s hops, timed between device
    synchronisations (phase 18): milliseconds and bytes of every hop, and
    each hop's digest (SHA-256 of its bytes as sent, or as received) with
    whether this rank sent it, in order, so that a neighbour's sends can be
    held to this rank's receives."""

    def __init__(self, fn, device):
        self.fn, self.device = fn, device
        self.reset()

    def reset(self):
        self.ms, self.bytes, self.count = 0.0, 0, 0
        self.record = []

    def __call__(self, tensor, src, group):
        import hashlib
        import torch.distributed as dist
        sent = dist.get_rank() == src
        sync(self.device)
        start = time.perf_counter()
        self.fn(tensor, src, group)
        sync(self.device)
        self.ms += 1e3 * (time.perf_counter() - start)
        self.bytes += tensor.numel() * tensor.element_size()
        self.count += 1
        digest = hashlib.sha256(tensor.detach().cpu().numpy().tobytes()).hexdigest()
        self.record.append((sent, digest))


def pp_steps(run, mesh, device, batch, hops, steps=3):
    """3 steps of one phase 18 run on this rank's stage of ``mesh``
    (``run``: model config and state, attention mode, pruned band, compute
    dtype, ZeRO-1, microbatches), SpecAugment and dropout seeded as
    ``train_three_steps`` seeds them: per step (loss, norm, launch counts,
    step ms, hop ms, hop bytes, hops), the hops' digests in order, and the
    rank's parameter, moment and peak bytes (above its baseline)."""
    import torch
    base = reset_peak(device)
    model, opt, step = make_trainee(run["model"], run["optim"], run["state"], run["mode"],
                                    device, run.get("pruned"),
                                    compute_dtype=run.get("compute_dtype"), mesh=mesh,
                                    zero=run.get("zero", False), micro=run["micro"])
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    out, record = [], []
    for _ in range(steps):
        reset_counts()
        hops.reset()
        sync(device)
        start = time.perf_counter()
        m = step(batch, gen)
        sync(device)
        ms = 1e3 * (time.perf_counter() - start)
        out.append((float(m["loss"]), float(m["grad_norm"]), read_counts(), ms, hops.ms,
                    hops.bytes, hops.count))
        record += hops.record
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    result = {"steps": out, "hops": record, "param_bytes": param_bytes,
              "moment_bytes": opt.moment_bytes(), "peak_gib": peak_gib(device, base)}
    del model, opt, step
    return result


def pp_rank(job_path) -> dict:
    """Phase 18, one of the ranks that ``check_pipeline`` launches
    (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_*`` set; all on the one card): in a gloo group, the grid of
    ``make_mesh(n_data=job["n_data"], n_pipe=2)``; once the job's ``go``
    file exists, each of the job's runs (:func:`pp_steps`), the hops timed
    and digested; then, with a ``cli_config``, the group left,
    ``apps/train.py --flash --n_pipe 2`` for one epoch of phase 7's
    corpus, which joins a group of its own from the environment (at the
    job's second port)."""
    import torch
    import torch.distributed as dist
    from transformer_transducer_tpu_torch.apps import train as train_app
    from transformer_transducer_tpu_torch.parallel import pipeline as pipeline_lib
    from transformer_transducer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    job = torch.load(job_path, weights_only=False)     # this run's own file
    device = job["device"]
    dist.init_process_group("gloo", init_method="env://")
    mesh = make_mesh(n_data=job["n_data"], n_pipe=2)
    hops = _TimedHops(pipeline_lib._hop, device)
    pipeline_lib._hop = hops
    waited = time.perf_counter()
    while not os.path.exists(job["go"]):
        require(time.perf_counter() - waited < 600, "phase 18: the references did not end")
        time.sleep(0.2)
    out = {"rank": dist.get_rank(), "data_rank": mesh.data_rank,
           "pipe_rank": mesh.pipe_rank, "runs": {}}
    for name, run in job["runs"].items():
        batch = shard_batch({k: v.to(device) for k, v in job["batches"][run["batch"]].items()},
                            mesh)
        out["runs"][name] = pp_steps(run, mesh, device, batch, hops)
        out["rows"] = int(batch["inputs"].shape[0])
    pipeline_lib._hop = hops.fn
    dist.barrier()
    dist.destroy_process_group()
    if job.get("cli_config"):
        os.environ["MASTER_PORT"] = str(job["cli_port"])
        os.chdir(job["cli_dir"])
        reset_counts()
        start = time.perf_counter()
        trainer = train_app.main(["-config", job["cli_config"], "--flash", "--epochs", "1",
                                  "--n_pipe", "2", "--device", device])
        sync(device)
        out["cli"] = {"s": time.perf_counter() - start, "counts": read_counts(),
                      "backend": dist.get_backend() if dist.is_initialized() else None,
                      "n_data": trainer.mesh.n_data, "n_pipe": trainer.mesh.n_pipe,
                      "pipe_micro": trainer.pipe_micro, "global_step": trainer.global_step,
                      "exp_dir": trainer.exp_dir}
        dist.barrier()
        dist.destroy_process_group()
    return out


PP_ATTENTION = ("banded_fwd", "banded_bwd", "flash_fwd", "flash_bwd", "flash_fwd_bf16",
                "flash_bwd_bf16")


def stage_launches(one, n_layer, micro, last) -> dict:
    """A stage's launches a step from one process's (``one``): each
    attention kernel 18 times a step there, ``n_layer / 2 * micro`` here
    (its 9 layers at each microbatch); the loss kernels on the last stage
    alone, as often as in one process."""
    out = {}
    for key, n in one.items():
        if key in PP_ATTENTION:
            out[key] = n // n_layer * (n_layer // 2) * micro if n else 0
        else:
            out[key] = n if last else 0
    return out


def check_pipeline(cfg, state, batch, device, smi, one_process):
    """Phase 18: pipeline parallelism at flagship width (see the module's
    docstring).  ``batch`` is phase 8's B 4 batch, ``one_process`` phase
    17's one-process runs on the same weights, batch and seeds.  Returns
    the main paths' launches and a summary."""
    import copy
    import torch
    from transformer_transducer_tpu_torch.utils.config import Config
    from transformer_transducer_tpu_torch.utils.convert import (
        from_jax_params, random_jax_params)
    launches = collections.Counter()
    summary = {"device": smi}
    n_layer, micro = cfg.model.enc.n_layer, 4
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, os.environ.get("PYTHONPATH", "")]))
    model_cfg = load_flagship().model
    model_cfg.override("dropout", 0.0)
    optim_cfg = Config({"type": "sgd", "lr": cfg.optim.lr, "momentum": 0.9})
    esp = load_config("configs", "espnet_aishell.yaml")
    esp_cfg = copy.deepcopy(esp.model)
    for blk in ("enc", "dec"):
        for key in ("dropout_rate", "positional_dropout_rate", "attention_dropout_rate"):
            esp_cfg[blk][key] = 0.0
    esp_state = from_jax_params(random_jax_params(esp.model, seed=0))
    esp_batch, _ = training_batch(esp, device, seed=1)
    esp_blocks = esp.model.enc.num_blocks
    bf16 = torch.bfloat16
    runs = {"flash": dict(mode="flash"), "banded": dict(mode="banded"),
            f"flash, pruned {S_RANGE}": dict(mode="flash", pruned=S_RANGE),
            "bf16 flash": dict(mode="flash", compute_dtype=bf16),
            "espnet": dict(mode=None, model=esp_cfg, state=esp_state, batch="espnet")}
    for run in runs.values():
        run.setdefault("model", model_cfg)
        run.setdefault("state", state)
        run.setdefault("batch", "native")
        run["optim"], run["micro"] = optim_cfg, micro
    batches = {"native": {k: v.cpu() for k, v in batch.items()},
               "espnet": {k: v.cpu() for k, v in esp_batch.items()}}
    one_bytes = {"native": sum(v.numel() * 4 for v in state.values()),
                 "espnet": sum(v.numel() * 4 for v in esp_state.values())}
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli_dir = os.path.join(tmp, "cli")
        os.makedirs(cli_dir)
        go = os.path.join(tmp, "go")
        job = {"device": str(device), "n_data": 1, "runs": runs, "batches": batches,
               "go": go, "cli_dir": cli_dir, "cli_config": write_corpus(cli_dir, cfg)}
        procs = launch_ranks(2, job, tmp, env, "pp2", "pp_rank")
        try:
            # the yardstick while the ranks start: one process running the
            # same microbatches through the encoder one by one
            yard = {}
            for name, run in runs.items():
                yard[name] = train_three_steps(
                    run["model"], optim_cfg, run["state"], run["mode"],
                    batch if run["batch"] == "native" else esp_batch, device, False,
                    run.get("pruned"), compute_dtype=run.get("compute_dtype"), micro=micro)
            with open(go, "w") as fh:
                fh.write("go")
            ranks = join_ranks(procs, 900)
        finally:
            for p in procs:
                p.kill()
        summary["pp2_s"] = time.perf_counter() - start
        by_stage = sorted(ranks, key=lambda r: r["pipe_rank"])
        for name, run in runs.items():
            for r in by_stage:
                res = r["runs"][name]
                layers = esp_blocks if run["batch"] == "espnet" else n_layer
                for i, (got, want, yd) in enumerate(zip(res["steps"], one_process[name],
                                                        yard[name])):
                    loss, norm, counts, ms, hop_ms, hop_bytes, n_hops = got
                    rel = abs(loss - want[0]) / abs(want[0])
                    rel_n = abs(norm - want[1]) / want[1]
                    log(f"  pp2 stage {r['pipe_rank']} {name} step {i + 1}: loss {loss!r} / one "
                        f"process {want[0]!r} (rel {rel:.2e}) / microbatched {yd[0]!r}, grad "
                        f"norm {norm:.6f} / {want[1]:.6f} (rel {rel_n:.2e}) / {yd[1]:.6f}; "
                        f"{ms:.2f} ms, {n_hops} hops {hop_ms:.2f} ms "
                        f"({hop_bytes / max(n_hops, 1):.0f} bytes each); launches {counts}")
                    expect = stage_launches(want[2], layers, micro, r["pipe_rank"] == 1)
                    require(counts == expect, f"pp2 stage {r['pipe_rank']} {name} step {i + 1} "
                            f"launched {counts}, want {expect}")
                    require(rel <= LOSS_RTOL or (run.get("compute_dtype") and i),
                            f"pp2 {name} step {i + 1}: losses differ by {rel:.2e}")
                    if i == 0:
                        require(rel_n <= NORM_RTOL, f"pp2 {name} step 1: gradient norms "
                                f"differ by {rel_n:.2e}")
                    launches.update(counts)
            # banded: no atomics, so step 1 equals the microbatched process
            # to the bit
            first = by_stage[-1]["runs"][name]["steps"][0][0]
            if name == "banded":
                require(first == yard[name][0][0], f"pp2 banded step 1: loss {first!r}, "
                        f"microbatched {yard[name][0][0]!r}")
            # every hop arrives as its neighbour sent it
            a, b = (r["runs"][name]["hops"] for r in by_stage)
            require(len(a) == len(b) and all(x[0] != y[0] and x[1] == y[1]
                                             for x, y in zip(a, b)),
                    f"pp2 {name}: a hop arrived other than it was sent")
        flash = [r["runs"]["flash"] for r in by_stage]
        share = {name: [r["runs"][name]["param_bytes"] / one_bytes[
            "espnet" if name == "espnet" else "native"] for r in by_stage] for name in runs}
        step_ms = {name: [[s[3] for s in r["runs"][name]["steps"]] for r in by_stage]
                   for name in runs}
        hop_ms = {name: [[s[4] for s in r["runs"][name]["steps"]] for r in by_stage]
                  for name in runs}
        hop_bytes = flash[0]["steps"][0][5] / flash[0]["steps"][0][6]
        summary.update(
            microbatched={n: [(l, g) for l, g, _ in yard[n]] for n in runs},
            pp2={n: [r["runs"][n]["steps"] for r in by_stage] for n in runs},
            pp2_peak_gib={n: [r["runs"][n]["peak_gib"] for r in by_stage] for n in runs},
            param_share=share, step_ms=step_ms, hop_ms=hop_ms, hop_bytes=hop_bytes,
            bubble=1 / (micro + 1), cli_s=[r["cli"]["s"] for r in by_stage])
        log(f"pp2 --pipe-micro {micro}, two gloo ranks on the one card ({summary['pp2_s']:.1f} s "
            f"with their start-up and the microbatched references): losses (bf16: step 1's) "
            f"and step 1's gradient norms within {LOSS_RTOL} and {NORM_RTOL} of one process, "
            f"banded step 1 equal to the bit to one process running the microbatches one by "
            f"one, each stage's attention launches {n_layer // 2 * micro} forward and "
            f"{n_layer // 2 * micro} backward a step and the loss kernels on the last stage "
            f"alone, every hop equal to the bit on arrival; parameters a rank, flagship "
            + ", ".join(f"{100 * s:.4f} %" for s in share["flash"]) + ", espnet "
            + ", ".join(f"{100 * s:.4f} %" for s in share["espnet"]) + f" of one process; "
            f"{hop_bytes:.0f} bytes a hop; bubble 1/{micro + 1}")
        for name in runs:
            log(f"  pp2 {name}: step ms by stage " + "; ".join(
                ", ".join(f"{ms:.2f}" for ms in per) for per in step_ms[name])
                + "; hops ms " + "; ".join(", ".join(f"{ms:.2f}" for ms in per)
                                          for per in hop_ms[name])
                + "; peak above the baseline " + ", ".join(
                    f"{r['runs'][name]['peak_gib']:.4f}" for r in by_stage) + " GiB")

        # (c) the 2-rank CLI's checkpoint: whole, served by one-process predict
        for r in by_stage:
            cli = r["cli"]
            launches.update(cli["counts"])
            require(cli["backend"] == "gloo" and cli["n_pipe"] == 2 and cli["n_data"] == 1
                    and cli["pipe_micro"] == 4 and cli["global_step"] == 4
                    and cli["counts"]["flash_fwd"] > 0 and cli["counts"]["flash_bwd"] > 0
                    and (r["pipe_rank"] == 0 or cli["counts"]["alpha"] > 0),
                    f"stage {r['pipe_rank']}: the training entry point ran {cli}")
        counts, text, cer_line = serve_cli_checkpoint(cfg, job, by_stage, device, "pp2")
        launches.update(counts)
        log(f"apps/train.py --flash --n_pipe 2 over the two ranks (its own "
            f"{by_stage[0]['cli']['backend']} group): 4 steps in "
            + ", ".join(f"{r['cli']['s']:.1f} s" for r in by_stage) + f", {cer_line}; its "
            f"epoch_0 holds the whole model and moments; one-process apps/predict.py "
            f"--full-context on it: {len(text)} characters, the text of recognize with its "
            f"weights; launches {counts}")
        reset_peak(device)

        # (b) dp2 x pp2 on four ranks, ZeRO-1, 2 microbatches
        start4 = time.perf_counter()
        job4 = {"device": str(device), "n_data": 2, "go": go, "batches": batches,
                "runs": {"dp2 x pp2 zero": dict(runs["flash"], zero=True, micro=2)}}
        ranks4 = join_ranks(launch_ranks(4, job4, tmp, env, "dp2pp2", "pp_rank"), 600)
        summary["dp2pp2_s"] = time.perf_counter() - start4
    for r in ranks4:
        res = r["runs"]["dp2 x pp2 zero"]
        for i, (got, want) in enumerate(zip(res["steps"], one_process["flash"])):
            loss, norm, counts = got[:3]
            rel = abs(loss - want[0]) / abs(want[0])
            expect = stage_launches(want[2], n_layer, 2, r["pipe_rank"] == 1)
            require(counts == expect, f"dp2 x pp2 rank {r['rank']} step {i + 1} launched "
                    f"{counts}, want {expect}")
            require(rel <= LOSS_RTOL, f"dp2 x pp2 step {i + 1}: losses differ by {rel:.2e}")
            if i == 0:
                rel_n = abs(norm - want[1]) / want[1]
                require(rel_n <= NORM_RTOL, f"dp2 x pp2 step 1: norms differ by {rel_n:.2e}")
            launches.update(counts)
    for d in range(2):
        a, b = (r["runs"]["dp2 x pp2 zero"]["hops"]
                for r in sorted((r for r in ranks4 if r["data_rank"] == d),
                                key=lambda r: r["pipe_rank"]))
        require(len(a) == len(b) and all(x[0] != y[0] and x[1] == y[1] for x, y in zip(a, b)),
                f"dp2 x pp2 data index {d}: a hop arrived other than it was sent")
    share4 = [r["runs"]["dp2 x pp2 zero"]["moment_bytes"] / one_bytes["native"] for r in ranks4]
    summary.update(dp2pp2_moment_share=share4,
                   dp2pp2_peak_gib=[r["runs"]["dp2 x pp2 zero"]["peak_gib"] for r in ranks4],
                   dp2pp2_steps=[r["runs"]["dp2 x pp2 zero"]["steps"] for r in ranks4])
    require(all(s <= 0.35 for s in share4), f"dp2 x pp2 moments a rank {share4}")
    log(f"dp2 x pp2 --zero --flash --pipe-micro 2, four gloo ranks on the one card "
        f"({summary['dp2pp2_s']:.1f} s with their start-up): losses and step 1's norm within "
        f"the training bars, each stage's attention launches {n_layer // 2 * 2} + "
        f"{n_layer // 2 * 2} a step, every hop equal to the bit; moments a rank "
        + ", ".join(f"{100 * s:.4f} %" for s in share4) + " of one process's trace; peak "
        "above the baseline " + ", ".join(f"{g:.4f}" for g in summary["dp2pp2_peak_gib"])
        + f" GiB; step ms " + "; ".join(", ".join(f"{s[3]:.2f}" for s in st)
                                       for st in summary["dp2pp2_steps"]) + f" ({smi})")
    return dict(launches), summary


def bf16_bound(n_bytes, ops):
    """(least ms at the bf16 rate, "bytes" or "operations", least ms at the
    TF32 rate) of work that moves ``n_bytes`` and does ``ops`` FLOP."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_bf16, t_tf32 = ops / BF16_FLOP_PER_S, ops / TF32_FLOP_PER_S
    by = "bytes" if t_bytes >= t_bf16 else "operations"
    return max(t_bytes, t_bf16) * 1e3, by, max(t_bytes, t_tf32) * 1e3


def bf16_flash_bytes(b, f32_outputs, bf16_io, table_passes):
    """Bytes a bf16 flash form moves at T_MAIN: ``bf16_io`` (B, T, H, Dh)
    bf16 tensors in or out, ``f32_outputs`` float32 ones, the bf16 tables
    ``table_passes`` times (read, or read and their gradients written)."""
    rows = b * T_MAIN * H * DH
    tables = T_MAIN * H * DH + H * DH + T_MAIN * H
    return 2 * bf16_io * rows + 4 * f32_outputs * rows + 2 * table_passes * tables


def bf16_occupancy(which, dh) -> dict:
    """A bf16 flash kernel's shared memory a block and blocks an SM (the
    occupancy API, ``ttx_flash_rel_attention_{which}_bf16_info``, which
    "fwd" or "bwd")."""
    import ctypes
    from transformer_transducer_tpu_torch.ops.cuda import build
    out = (ctypes.c_int * 3)()
    fn = f"ttx_flash_rel_attention_{which}_bf16_info"
    build.check(getattr(build.library(), fn)(dh, out), fn)
    return {"shared_bytes": out[0], "blocks_per_sm": out[1]}


def bf16_backward_parts(args, sums, lse, gout) -> dict:
    """The bf16 backward's kernels alone, each under a CUDA graph on
    buffers made once (none of the wrapper's allocations): the three of a
    call (the pre-pass, the main kernel, the casts), the main kernel alone,
    the pre-pass alone and the casts alone (``_stages``)."""
    import torch
    from transformer_transducer_tpu_torch.ops.cuda import build, common
    lib = build.library()
    b, t, h, dh = args[0].shape
    ptrs = common.kernel_args(*args)
    outs = [torch.empty_like(x, dtype=torch.bfloat16) for x in (sums, sums, sums, *args[3:])]
    work = torch.empty(lib.ttx_flash_rel_attention_bwd_bf16_workspace(b, t, h, dh),
                       dtype=torch.float32, device=sums.device)
    grad = gout.float().contiguous()

    def run(stages):
        build.check(lib.ttx_flash_rel_attention_bwd_bf16_stages(
            stages, *ptrs, sums.data_ptr(), lse.data_ptr(), grad.data_ptr(),
            *(o.data_ptr() for o in outs), work.data_ptr(), b, t, h, dh,
            torch.cuda.current_stream().cuda_stream), "ttx_flash_rel_attention_bwd_bf16_stages")

    run(7)
    return {"ms_kernels_alone": graph_ms(lambda: run(7)), "ms_main_kernel": graph_ms(lambda: run(2)),
            "ms_prepass": graph_ms(lambda: run(1)), "ms_casts": graph_ms(lambda: run(4))}


def time_bf16_flash(gen, errs, launches, tc, smi):
    """Phase 14, the kernels' rows of the bf16 forms: each alone under a
    CUDA graph (the forward at B 8 without the lse, as served, and at B 4
    with it, as trained; the backward at B 4), its plain bf16 form, its
    bound at the bf16 and at the TF32 rate, and as yardstick SDPA in bf16
    with BD as a precomputed additive mask, forward and backward; the
    forward's registers, ``HMMA``, shared memory and blocks an SM beside."""
    import torch
    from transformer_transducer_tpu_torch.models.attention import rel_shift
    from transformer_transducer_tpu_torch.ops.cuda import flash_rel_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    records = []

    def yard_inputs(args):
        """q, k, v as (B, H, T, Dh) and the additive bf16 mask (BD + u.k) /
        sqrt(Dh): SDPA's (q.k) / sqrt(Dh) plus it is the bf16 scores'."""
        q, k, v, re, u, rb = (x.float() for x in args)
        with torch.no_grad():
            bd = rel_shift(torch.einsum("bind,jnd->bnij", q, re) + rb.t()[None, :, None, :])
            add = (bd + torch.einsum("nd,bjnd->bnj", u, k)[:, :, None, :]) / DH ** 0.5
        heads = [x.transpose(1, 2).detach().requires_grad_() for x in args[:3]]
        return heads, add.to(torch.bfloat16)

    args = bf16_attention_inputs(T_MAIN, 410, gen)
    args4 = bf16_attention_inputs(T_MAIN, 410, gen, b=B_TRAIN)
    (qh, kh, vh), add = yard_inputs(args)
    with torch.no_grad():
        ms = graph_ms(lambda: fa.flash_forward_bf16(*args, with_lse=False))
        ms_b4 = graph_ms(lambda: fa.flash_forward_bf16(*args4, with_lse=True))
        plain_ms = cuda_ms(lambda: fa.flash_bf16_forward_plain(*args))
        yard_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=add))
    fwd_ops = lambda b: b * H * T_MAIN * T_MAIN * 6 * DH
    # q, k, v and the tables in, the float32 output out (with the lse: the
    # float32 sums and the lse too)
    bound_ms, bound_by, tf32_ms = bf16_bound(bf16_flash_bytes(B, 1, 3, 1), fwd_ops(B))
    bound_b4, _, _ = bf16_bound(bf16_flash_bytes(B_TRAIN, 2, 3, 1) + 4 * B_TRAIN * H * T_MAIN,
                                fwd_ops(B_TRAIN))
    fwd = dict(tc["flash forward bf16"], **bf16_occupancy("fwd", DH))
    records.append({
        "name": "flash_rel_attention_fwd_bf16", "route": "cuda",
        "source": f"{PKG}/csrc/flash_rel_attention_fwd.cu",
        "replaces": "transformer_transducer_tpu/ops/pallas/flash_rel_attention.py:248",
        "launches": launches["flash_fwd_bf16"], "max_abs_err": errs["flash_bf16"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "bound_tf32_ms": tf32_ms, "share_of_bound": bound_ms / ms,
        "sdpa_bf16_bd_mask_yardstick_ms": yard_ms, "ms_b4_with_lse": ms_b4,
        "bound_b4_ms": bound_b4, **fwd})
    log(f"  flash_rel_attention_fwd_bf16: kernel {ms:.4f} ms (alone, CUDA graph, B={B} "
        f"T={T_MAIN} H={H} Dh={DH}, no lse), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, bf16 rate; {tf32_ms:.4f} ms at the TF32 rate), "
        f"{100 * bound_ms / ms:.1f} % of it; at B={B_TRAIN} with the lse and sums "
        f"{ms_b4:.4f} ms (bound {bound_b4:.4f} ms); SDPA bf16 with BD as a precomputed mask "
        f"(yardstick) {yard_ms:.4f} ms; {fwd['hmma']} HMMA, {fwd['registers']} registers, "
        f"{fwd['shared_bytes']} bytes of shared memory a block, {fwd['blocks_per_sm']} blocks "
        f"an SM; {launches['flash_fwd_bf16']} launches in phase 14 ({smi})")
    del args

    out, lse, sums = fa.flash_forward_bf16(*args4, with_lse=True)
    gout = torch.randn(B_TRAIN, T_MAIN, H, DH, generator=gen, device="cuda")
    (qh, kh, vh), add = yard_inputs(args4)
    out_s = sdpa(qh, kh, vh, attn_mask=add)
    ms = graph_ms(lambda: fa.flash_rel_attention_backward(*args4, sums, lse, gout))
    plain_ms = cuda_ms(lambda: fa.flash_bf16_backward_plain(*args4, gout))
    yard_ms = cuda_ms(lambda: torch.autograd.grad(
        out_s, (qh, kh, vh), gout.transpose(1, 2).to(torch.bfloat16), retain_graph=True))
    # in: q, k, v, dO and the tables; out: dq, dk, dv and the tables'
    # gradients, all bf16 (the sums and the lse are not counted: the function
    # does not need them); about 16 Dh FLOP a cell, as backward_bound
    bound_ms, bound_by, tf32_ms = bf16_bound(bf16_flash_bytes(B_TRAIN, 0, 7, 2),
                                             B_TRAIN * H * T_MAIN * T_MAIN * 16 * DH)
    bwd = dict(tc["flash backward bf16"], **bf16_occupancy("bwd", DH),
               **bf16_backward_parts(args4, sums, lse, gout))
    records.append({
        "name": "flash_rel_attention_bwd_bf16", "route": "cuda",
        "source": f"{PKG}/csrc/flash_rel_attention_bwd.cu",
        "replaces": "transformer_transducer_tpu/ops/pallas/flash_rel_attention.py:288",
        "launches": launches["flash_bwd_bf16"], "max_abs_err": errs["flash_bwd_bf16"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "bound_tf32_ms": tf32_ms, "share_of_bound": bound_ms / ms,
        "sdpa_bf16_bd_mask_yardstick_ms": yard_ms, **bwd})
    log(f"  flash_rel_attention_bwd_bf16: kernel {ms:.4f} ms (alone, CUDA graph, the "
        f"wrapper with its buffers, B={B_TRAIN}); its three kernels {bwd['ms_kernels_alone']:.4f} "
        f"ms (the main kernel {bwd['ms_main_kernel']:.4f}, the pre-pass "
        f"{bwd['ms_prepass']:.4f}, the casts {bwd['ms_casts']:.4f}); plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}, bf16 rate; {tf32_ms:.4f} ms at the TF32 rate), "
        f"{100 * bound_ms / ms:.1f} % of it ({100 * bound_ms / bwd['ms_kernels_alone']:.1f} % "
        f"for the kernels alone); SDPA bf16 backward with BD as a precomputed mask "
        f"(yardstick) {yard_ms:.4f} ms; {bwd['hmma']} HMMA, {bwd['registers']} registers, "
        f"{bwd['shared_bytes']} bytes of shared memory a block, {bwd['blocks_per_sm']} blocks "
        f"an SM; {launches['flash_bwd_bf16']} launches in phase 14 ({smi})")
    return records


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    from transformer_transducer_tpu_torch.decoding.greedy import (
        greedy_decode, recognize)
    from transformer_transducer_tpu_torch.models.transducer import build_transducer
    from transformer_transducer_tpu_torch.ops import features_np as F
    from transformer_transducer_tpu_torch.ops.cuda import build
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention, banded_attention_plain)
    from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
        flash_rel_attention, flash_rel_attention_plain)
    from transformer_transducer_tpu_torch.data.wav import read_wave
    from transformer_transducer_tpu_torch.ops.masks import context_mask
    from transformer_transducer_tpu_torch.utils.config import (
        Config, stack_context, subsample_factor)
    from transformer_transducer_tpu_torch.utils.convert import (
        from_jax_params, random_jax_params)
    from transformer_transducer_tpu_torch.utils.device import resolve_device

    # ---- 1. device
    run_start = time.perf_counter()
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"device: {kind}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}); nvcc: {nvcc}")

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 2")
    # ---- 2. build
    start = time.perf_counter()
    lib_path = build.build()
    build.library()
    log(f"kernels built in {time.perf_counter() - start:.1f} s -> "
        f"{os.path.relpath(lib_path, HERE)}")
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt").read_text()
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            log("  ptxas:", line.strip())
    # the flash kernels' products run on the tensor cores (mma.sync); Dh 64
    tc = {}
    for name, symbol in (("flash forward", "flash_fwd_tcILi64E"),
                         ("flash backward", "flash_bwd_tcILi64EE"),
                         ("flash forward bf16", "flash_fwd_bf16ILi64E"),
                         ("flash backward bf16", "flash_bwd_bf16ILi64E")):
        ops = sass_opcodes(lib_path, symbol)
        (regs, spill_st, spill_ld), = ptxas_entries(ptxas, symbol)
        tc[name] = {"hmma": ops["HMMA"], "sass": sum(ops.values()), "registers": regs,
                    "spill_bytes": spill_st + spill_ld}
        log(f"  {name} ({symbol}): {ops['HMMA']} HMMA of {sum(ops.values())} "
            f"instructions in its SASS, {regs} registers, {spill_st} + {spill_ld} bytes "
            f"of spill stores + loads; most: "
            + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)))
        require(ops["HMMA"] > 0, f"the {name} has no tensor-core instruction")
    # the bf16 backward: no spill, every product m16n8k16 on bf16 operands
    shapes = {op: n for op, n in sass_opcodes(lib_path, "flash_bwd_bf16ILi64E", True).items()
              if op.startswith("HMMA")}
    tc["flash backward bf16"]["hmma_shapes"] = shapes
    log(f"  flash backward bf16: HMMA forms {shapes}")
    require(tc["flash backward bf16"]["spill_bytes"] == 0, "the bf16 flash backward spills")
    require(set(shapes) == {"HMMA.16816.F32.BF16"},
            f"the bf16 flash backward has products other than m16n8k16 bf16: {shapes}")
    # the banded forward and backward (SIMT, Dh 64): no atomic instruction
    # in the forward or in either of the backward's two kernels
    simt = {}
    for symbol in ("banded_fwdILi64E", "banded_bwdILi64E", "banded_bwd_tablesILi64E"):
        ops = sass_opcodes(lib_path, symbol)
        (regs, spill_st, spill_ld), = ptxas_entries(ptxas, symbol)
        atomics = sum(n for op, n in ops.items() if op.startswith(("RED", "ATOM")))
        simt[symbol] = {"sass": sum(ops.values()), "registers": regs,
                        "spill_bytes": spill_st + spill_ld, "atomics": atomics}
        log(f"  banded attention ({symbol}): {sum(ops.values())} instructions in its "
            f"SASS, {atomics} RED/ATOM, {regs} registers, {spill_st} + {spill_ld} "
            f"bytes of spill stores + loads; most: "
            + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)))
        require(atomics == 0, f"the banded attention's {symbol} has atomics")
    # the additive logZ's four kernels: no atomic in any of them, the
    # product (U1 43 -> NT 6, 16-byte copies) on the tensor cores
    ops = sass_opcodes(lib_path, "logz_")
    prod = sass_opcodes(lib_path, "logz_productILi6EE")
    (regs, spill_st, spill_ld), = ptxas_entries(ptxas, "logz_productILi6EE")
    atomics = sum(n for op, n in ops.items() if op.startswith(("RED", "ATOM")))
    logz_sass = {"hmma": prod["HMMA"], "sass": sum(prod.values()), "registers": regs,
                 "spill_bytes": spill_st + spill_ld, "atomics": atomics}
    log(f"  additive logZ (logz_*): {sum(ops.values())} SASS instructions in its four "
        f"kernels' instantiations, {atomics} RED/ATOM; the product at NT 6: "
        f"{prod['HMMA']} HMMA of {sum(prod.values())}, {regs} registers, {spill_st} + "
        f"{spill_ld} bytes of spill stores + loads")
    require(atomics == 0, "the additive logZ's kernels have atomics")
    require(prod["HMMA"] > 0, "the additive logZ's product has no tensor-core instruction")
    # each band sweep's two kernels (every slot-register count; the beta's
    # instantiations are <NS, true>): no atomic
    band_sass = {}
    for name, beta in (("band_alpha", 0), ("band_beta", 1)):
        ops = sass_opcodes(lib_path, rf"band_(transfer|rows)ILi\dELb{beta}EE")
        (regs_a, *_), (regs_c, *_) = (ptxas_entries(ptxas, f"{k}ILi1ELb{beta}EE")[0]
                                      for k in ("band_transfer", "band_rows"))
        atomics = sum(n for op, n in ops.items() if op.startswith(("RED", "ATOM")))
        band_sass[name] = {"sass": sum(ops.values()), "atomics": atomics,
                           "registers": [regs_a, regs_c]}
        log(f"  {name} (band_transfer, band_rows): {sum(ops.values())} SASS instructions "
            f"in their instantiations, {atomics} RED/ATOM; {regs_a} and {regs_c} registers "
            f"at one slot a lane")
        require(ops and atomics == 0, f"the {name}'s kernels have atomics or no SASS")

    # the lattice sweeps (wavefront<K, MULTI, BETA>): no atomic in any
    # instantiation, no barrier in the one-warp forms (MULTI false)
    ops = sass_opcodes(lib_path, "wavefront")
    one_warp = sass_opcodes(lib_path, r"wavefrontILi\dELb0E")
    atomics = sum(n for op, n in ops.items() if op.startswith(("RED", "ATOM")))
    barriers = sum(n for op, n in one_warp.items() if op.startswith("BAR"))
    lattice_sass = {"sass": sum(ops.values()), "atomics": atomics,
                    "one_warp_barriers": barriers, "registers": {}}
    for k, multi in ((1, 0), (2, 0), (4, 0), (2, 1)):      # one warp; several
        for beta in (0, 1):
            (regs, spill_st, spill_ld), = ptxas_entries(
                ptxas, f"wavefrontILi{k}ELb{multi}ELb{beta}EE")
            lattice_sass["registers"][f"K{k}{'_warps' if multi else ''}"
                                      f"{'_beta' if beta else '_alpha'}"] = regs
    from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import plan as lattice_plan
    log(f"  lattice sweeps (wavefront): {sum(ops.values())} SASS instructions in their "
        f"instantiations, {atomics} RED/ATOM, {barriers} BAR in the one-warp forms; "
        f"registers {lattice_sass['registers']}; at U1 43 alpha "
        f"{lattice_plan(43, False)}, beta {lattice_plan(43, True)}; at U1 1024 beta "
        f"{lattice_plan(1024, True)}")
    require(ops and atomics == 0, "the lattice sweeps have atomics or no SASS")
    require(one_warp and barriers == 0, "the one-warp lattice sweeps have a barrier")
    from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import log1p_mismatches
    bad = log1p_mismatches()
    log(f"  lattice sweeps' branch-free log1p against log1pf over every float in [0, 1]: "
        f"{bad} differ")
    require(bad == 0, f"the lattice sweeps' log1p differs from log1pf on {bad} floats")

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 3")
    # ---- 3. kernels vs plain versions
    log("kernels vs plain versions (atol 1e-4, rtol 1e-4):")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_kernels(gen)
    errs.update(check_training_kernels(gen))
    errs.update(check_pruned_kernels(gen))
    log(f"the flash kernels' bf16 forms vs their plain bf16 forms (forward rtol "
        f"{BF16_FWD_RTOL} of the largest magnitude + one P rounding a row; gradients "
        f"{BF16_GRAD_RTOL} of the leaf's largest magnitude or one bf16 step):")
    errs["flash_bf16"] = check_bf16_forward(gen)
    errs["flash_bwd_bf16"] = check_bf16_backward(gen)

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 4")
    # ---- 4. the slice at full width
    cfg = load_flagship()
    left_ctx, right_ctx = stack_context(cfg.data)
    n_mels = cfg.data.feature_dim
    max_tokens = cfg.data.max_target_length + 1
    band = (cfg.model.enc.left_context, cfg.model.enc.right_context)
    state = from_jax_params(random_jax_params(cfg.model, seed=0))
    models = {}
    for flash in (False, True):
        models[flash] = build_transducer(cfg.model, flash=flash, device=device)
        models[flash].load_state_dict(state)
    model, model_flash = models[False], models[True]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"flagship model: {cfg.model.enc.n_layer} encoder layers, d_model "
        f"{cfg.model.enc.d_model}, V {cfg.model.vocab_size}, {n_params} parameters")

    waves = synthetic_waves(8, seed=0)
    start = time.perf_counter()
    feats = [F.subsample(F.stack_frames(F.logmel_masked(w, 16000, n_mels),
                                        left_ctx, right_ctx),
                         subsample_factor(cfg.data)) for w in waves]
    frontend_ms = (time.perf_counter() - start) * 1e3
    t_len = np.array([f.shape[0] for f in feats])
    x_np = np.zeros((len(feats), t_len.max(), feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        x_np[i, :len(f)] = f
    x = torch.from_numpy(x_np).to(device)
    audio_s = sum(len(w) for w in waves) / 16000.0
    log(f"batch: {len(waves)} utterances, {audio_s:.2f} s of audio, frames "
        f"{t_len.tolist()}, host frontend {frontend_ms:.1f} ms")
    require(t_len.max() == T_MAIN and x.shape[-1] == cfg.model.enc.d_model,
            "the batch is not at the flagship width")

    # bias the blank logit so that about 15 % of frames emit at the seed
    # label state (untrained weights emit on nearly every frame)
    with torch.no_grad():
        enc = model.encode(x, context_mask(T_MAIN, *band, device=device))
        dec = model.predict(torch.zeros((len(waves), 1), dtype=torch.long,
                                        device=device))
        logits = model.joint_logits(enc, dec)[:, :, 0]
        margin = logits[..., 1:].max(-1).values - logits[..., 0]
        valid = torch.arange(T_MAIN, device=device)[None] < torch.from_numpy(
            t_len).to(device)[:, None]
        offset = torch.quantile(margin[valid], 0.85).item()
        for m in models.values():
            m.joint.project_layer.bias[0] += offset
    log(f"blank logit biased by {offset:.3f}")

    # the main path: counts set to 0 just before, read just after
    reset_counts()
    tok_band = recognize(model, x, t_len, band=band, max_tokens=max_tokens)
    tok_full = recognize(model_flash, x, t_len, max_tokens=max_tokens)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {"banded": counts["banded_fwd"], "flash": counts["flash_fwd"]}
    log(f"main path launches: banded {launches['banded']}, flash "
        f"{launches['flash']} (18 per encode expected)")
    n_layer = cfg.model.enc.n_layer
    want = dict.fromkeys(counts, 0)
    want.update(banded_fwd=n_layer, flash_fwd=n_layer)
    require(counts == want,
            f"the main path did not launch each kernel once a layer: {counts}")

    n_frames = int(t_len.sum())
    for name, toks in (("band", tok_band), ("full-context", tok_full)):
        require(len(toks) == len(waves)
                and all(len(r) < max_tokens and 0 not in r for r in toks),
                f"{name}: malformed token lists")
        log(f"  {name}: {sum(map(len, toks))} tokens over {n_frames} frames "
            f"({100.0 * sum(map(len, toks)) / n_frames:.1f} % emission)")

    # the same through the plain versions: the dense masked path (band) and
    # a flash=False model (full context)
    with torch.no_grad():
        mask = context_mask(T_MAIN, *band, device=device)
        enc_band_k = model.encode_banded(x, *band)
        enc_band_p = model.encode(x, mask)
        enc_full_k = model_flash.encode(x)
        enc_full_p = model.encode(x)
    tok_band_p = recognize(model, x, t_len, audio_mask=mask, max_tokens=max_tokens)
    tok_full_p = recognize(model, x, t_len, max_tokens=max_tokens)
    for name, a, b in (("band", enc_band_k, enc_band_p),
                       ("full-context", enc_full_k, enc_full_p)):
        require(a.shape == (len(waves), T_MAIN, cfg.model.enc.d_model)
                and bool(torch.isfinite(a).all()),
                f"{name}: encoder states of a wrong shape or not finite")
        err = (a - b).abs().max().item()
        log(f"  {name}: encoder states kernel vs plain max|err| {err:.3e} "
            f"(tolerance {ENC_TOL})")
        require(err <= ENC_TOL, f"{name}: encoder states differ by {err}")
    compare_tokens("band", tok_band, tok_band_p, model, enc_band_k, enc_band_p,
                   t_len, max_tokens)
    compare_tokens("full-context", tok_full, tok_full_p, model, enc_full_k,
                   enc_full_p, t_len, max_tokens)

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 5")
    # ---- 5. timings at the flagship shape (B=8, T=410, H=8, Dh=64)
    from transformer_transducer_tpu_torch.ops.cuda import common
    log(f"timings on {smi}:")
    args = attention_inputs(T_MAIN, 410, gen)
    q, k, v, re, u, rb = args
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))
    with torch.no_grad():
        # yardstick only: SDPA with the BD term precomputed as an additive
        # mask (leaves out building BD); the port never calls it
        from transformer_transducer_tpu_torch.models.attention import rel_shift
        bd = rel_shift(torch.einsum("bind,jnd->bnij", q, re) + rb.t()[None, :, None, :])
        u_k = torch.einsum("nd,bjnd->bnj", u, k)[:, :, None, :]   # (q+u).k - q.k
        add = (bd + u_k) / DH ** 0.5
        add_band = add.masked_fill(context_mask(T_MAIN, *band, device=device),
                                   float("-inf"))
        yard_err = (sdpa(qh, kh, vh, attn_mask=add).transpose(1, 2)
                    - flash_rel_attention_plain(*args)).abs().max().item()
    log(f"  SDPA yardstick vs plain full attention: max|err| {yard_err:.3e}")
    records = []
    rows = (
        ("banded_attention_fwd", "banded",
         "transformer_transducer_tpu/ops/pallas/banded_attention.py:151",
         lambda: banded_attention(*args, *band),
         lambda: banded_attention_plain(*args, *band),
         lambda: sdpa(qh, kh, vh, attn_mask=add_band),
         band_cells(T_MAIN, *band), "ttx_banded_attention_fwd", band),
        ("flash_rel_attention_fwd", "flash",
         "transformer_transducer_tpu/ops/pallas/flash_rel_attention.py:248",
         lambda: flash_rel_attention(*args),
         lambda: flash_rel_attention_plain(*args),
         lambda: sdpa(qh, kh, vh, attn_mask=add),
         T_MAIN * T_MAIN, "ttx_flash_rel_attention_fwd", ()),
    )
    args4 = attention_inputs(T_MAIN, 410, gen, b=B_TRAIN)
    for name, key, replaces, kern, plain, yard, cells, fn, extra in rows:
        with torch.no_grad():
            ms = graph_ms(kern)
        plain_ms, yard_ms = cuda_ms(plain), cuda_ms(yard)
        bound_ms, bound_by = bound(T_MAIN, cells)
        # also at the training batch, with the row lse, as a training step
        # runs it
        fwd4 = lambda: common.launch_forward(fn, args4, extra, with_lse=True)[:2]
        ms_b4 = graph_ms(fwd4)
        bound_b4, _ = bound(T_MAIN, cells, b=B_TRAIN)
        rec = {"name": name, "route": "cuda",
               "source": f"{PKG}/csrc/rel_attention.cu", "replaces": replaces,
               "launches": launches[key], "max_abs_err": errs[key], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "sdpa_bd_mask_yardstick_ms": yard_ms,
               "share_of_bound": bound_ms / ms, "ms_b4": ms_b4, "bound_b4_ms": bound_b4,
               "share_of_bound_b4": bound_b4 / ms_b4}
        note = (f"; at B={B_TRAIN} with the lse {ms_b4:.4f} ms, bound {bound_b4:.4f} ms, "
                f"{100 * bound_b4 / ms_b4:.1f} % of it")
        if key == "banded":     # SIMT, no atomics: two launches bit-identical
            first, again = fwd4(), fwd4()
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            require(same, "two launches of the banded forward differ")
            del first, again
            fwd = simt["banded_fwdILi64E"]
            rec.update(registers=fwd["registers"], spill_bytes=fwd["spill_bytes"],
                       sass=fwd["sass"], atomics=fwd["atomics"], deterministic=same)
            note += (f"; {rec['registers']} registers, {rec['spill_bytes']} bytes of "
                     f"spills, {rec['sass']} SASS instructions, {rec['atomics']} atomics, "
                     f"two launches bit-identical")
        if key == "flash":      # on the tensor cores: its 3xTF32 bound too
            rec.update(source=f"{PKG}/csrc/flash_rel_attention_fwd.cu",
                       bound_tc_ms=bound_tc(cells), **tc["flash forward"])
            rec["share_of_bound_tc"] = rec["bound_tc_ms"] / ms
            note = (f", 3xTF32 bound {rec['bound_tc_ms']:.4f} ms, "
                    f"{100 * rec['share_of_bound_tc']:.1f} % of it; "
                    f"{rec['hmma']} HMMA, {rec['registers']} registers" + note)
        log(f"  {name}: kernel {ms:.4f} ms (alone, CUDA graph), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, fp32), {100 * bound_ms / ms:.1f} % of "
            f"bound{note}; SDPA with BD as a precomputed mask (yardstick) {yard_ms:.4f} ms")
        records.append(rec)
    del args4

    runs = {
        "band, kernel": lambda: recognize(model, x, t_len, band=band,
                                          max_tokens=max_tokens),
        "band, plain": lambda: recognize(model, x, t_len, audio_mask=mask,
                                         max_tokens=max_tokens),
        "full-context, kernel": lambda: recognize(model_flash, x, t_len,
                                                  max_tokens=max_tokens),
        "full-context, plain": lambda: recognize(model, x, t_len,
                                                 max_tokens=max_tokens)}
    e2e = host_ms(runs)
    for name, ms in e2e.items():
        med = statistics.median(ms)
        log(f"  recognize B=8 ({name}): {spread(ms)}, real-time factor "
            f"{med / 1e3 / audio_s:.5f} ({audio_s * 1e3 / med:.0f}x real time)")
    # where the kernels' recognize spends its time: the encoder, then the
    # frame-by-frame greedy loop; and the device's busy share of the whole
    decode = lambda enc: greedy_decode(model, enc, t_len, max_tokens)
    for name, encode in (("band", lambda: model.encode_banded(x, *band)),
                         ("full-context", lambda: model_flash.encode(x))):
        with torch.no_grad():
            enc_dev = cuda_ms(encode, samples=10, reps=3)
        enc_ms, dec_ms = split_ms(encode, decode)
        busy = device_busy_ms(runs[f"{name}, kernel"])
        e2e_ms = statistics.median(e2e[f"{name}, kernel"])
        share = (f"{100 * (1 - busy / e2e_ms):.1f} %" if busy > 0
                 else "not measured (the profiler saw no device time)")
        log(f"  {name}, kernel: encode {enc_dev:.3f} ms on the device; in one "
            f"call, encode {enc_ms:.2f} ms + greedy loop {dec_ms:.2f} ms (host "
            f"clock); device busy {busy:.2f} ms of one recognize, idle share "
            f"{share} of the median recognize")
    log(f"[{time.perf_counter() - run_start:.1f} s] phase 6")
    # ---- 6. training at full width: kernels, then the plain versions
    del models, model, model_flash, enc, dec, logits, enc_band_k, enc_band_p, \
        enc_full_k, enc_full_p
    torch.cuda.empty_cache()
    model_cfg0 = load_flagship().model
    model_cfg0.override("dropout", 0.0)           # --set model.dropout=0
    optim_cfg = Config({"type": "sgd", "lr": cfg.optim.lr, "momentum": 0.9})
    batch, batch_audio_s = training_batch(cfg, device, seed=1)
    log(f"training batch: {B_TRAIN} utterances, {batch_audio_s:.2f} s of audio, "
        f"frames {batch['inputs_length'].tolist()}, targets "
        f"{batch['targets_length'].tolist()}; SGD lr {cfg.optim.lr}, momentum "
        f"0.9, clip 200; dropout 0 for the comparison")
    per_step = {"flash": {"flash_fwd": n_layer, "flash_bwd": n_layer},
                "banded": {"banded_fwd": n_layer, "banded_bwd": n_layer}}
    train_launches = dict.fromkeys(read_counts(), 0)
    for mode in ("flash", "banded"):
        kern = train_three_steps(model_cfg0, optim_cfg, state, mode, batch,
                                 device, plain=False)
        plain = train_three_steps(model_cfg0, optim_cfg, state, mode, batch,
                                  device, plain=True)
        want = dict.fromkeys(train_launches, 0)
        want.update(per_step[mode], alpha=1, beta=1)
        for i, ((lk, nk, ck), (lp, norm_p, cp)) in enumerate(zip(kern, plain)):
            rel = abs(lk - lp) / abs(lp)
            log(f"  {mode} step {i + 1}: loss kernel {lk:.6f} / plain {lp:.6f} "
                f"(rel {rel:.2e}), grad norm {nk:.5f} / {norm_p:.5f}; "
                f"launches {ck}")
            require(ck == want, f"{mode} step {i + 1}: launches {ck}, want {want}")
            require(not any(cp.values()), f"{mode} plain step launched {cp}")
            require(rel <= LOSS_RTOL, f"{mode} step {i + 1}: losses differ by {rel:.2e}")
            for name, n in ck.items():
                train_launches[name] += n
        rel = abs(kern[0][1] - plain[0][1]) / abs(plain[0][1])
        log(f"  {mode}: step 1 grad norm rel diff {rel:.2e} (tolerance {NORM_RTOL})")
        require(rel <= NORM_RTOL, f"{mode}: step 1 grad norms differ by {rel:.2e}")

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 6b")
    # ---- 6b. the pruned loss at full width (--flash --pruned-range 5): the
    # kernels, then the plain versions handed the kernel run's band starts
    rs_kern, rs_plain, pruned_marks = [], [], []
    kern = train_three_steps(model_cfg0, optim_cfg, state, "flash", batch, device,
                             plain=False, pruned_range=S_RANGE,
                             hooks=(band_starts(rs_kern), logz_marks(pruned_marks)))
    plain = train_three_steps(model_cfg0, optim_cfg, state, "flash", batch, device,
                              plain=True, pruned_range=S_RANGE,
                              hooks=(band_starts(rs_plain, force=rs_kern),))
    want = dict.fromkeys(train_launches, 0)
    want.update(per_step["flash"], alpha=1, beta=1, logz=1, band_alpha=1, band_beta=1)
    pruned_launches = dict.fromkeys(train_launches, 0)
    for i, ((lk, nk, ck), (lp, norm_p, cp)) in enumerate(zip(kern, plain)):
        rel = abs(lk - lp) / abs(lp)
        differ = int((rs_kern[i] != rs_plain[i]).sum())
        note = " (the plain loss used the kernel path's)" if differ else ""
        log(f"  flash, pruned {S_RANGE}, step {i + 1}: loss kernel {lk:.6f} / plain "
            f"{lp:.6f} (rel {rel:.2e}), grad norm {nk:.5f} / {norm_p:.5f}; band "
            f"starts: {differ} of {rs_kern[i].numel()} cells differ between the "
            f"paths{note}; logZ cells through its exact pass {pruned_marks[i]}; "
            f"launches {ck}")
        require(ck == want, f"pruned step {i + 1}: launches {ck}, want {want}")
        require(not any(cp.values()), f"pruned plain step launched {cp}")
        require(rel <= LOSS_RTOL, f"pruned step {i + 1}: losses differ by {rel:.2e}")
        for name, n in ck.items():
            train_launches[name] += n
            pruned_launches[name] += n
    rel = abs(kern[0][1] - plain[0][1]) / abs(plain[0][1])
    log(f"  flash, pruned {S_RANGE}: step 1 grad norm rel diff {rel:.2e} (tolerance "
        f"{NORM_RTOL})")
    require(rel <= NORM_RTOL, f"pruned: step 1 grad norms differ by {rel:.2e}")
    rs0 = rs_kern[0]
    require(bool((rs0[:, 0] == 0).all()) and bool((rs0.diff(dim=1) >= 0).all())
            and bool((rs0.diff(dim=1) < S_RANGE).all()),
            "the band starts break their invariants")
    del rs_kern, rs_plain

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 6c")
    # ---- 6c. head width 32 end to end
    check_head_width_32(device)

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 7")
    # ---- 7. the training entry point: one epoch, then -mode continue
    from transformer_transducer_tpu_torch.apps import train as train_app
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = write_corpus(tmp, cfg)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            start = time.perf_counter()
            first = train_app.main(["-config", cfg_path, "--flash", "--epochs", "1"])
            second = train_app.main(["-config", cfg_path, "--flash", "-mode",
                                     "continue", "--epochs", "2"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - start
            cli_counts = read_counts()
        finally:
            os.chdir(cwd)
        exp = os.path.join(tmp, first.exp_dir)
        with open(os.path.join(exp, "metrics.jsonl"), encoding="utf-8") as fh:
            cers = [r["value"] for r in map(json.loads, fh) if r["tag"] == "cer"]
        log(f"apps/train.py --flash: 2 epochs (the second by -mode continue) in "
            f"{cli_s:.1f} s, {second.global_step} steps, CER per epoch {cers}, "
            f"launches {cli_counts}")
        require(second.start_epoch == 1 and second.global_step == 2 * 4,
                f"continue mode resumed at epoch {second.start_epoch}, step "
                f"{second.global_step}")
        for epoch in (0, 1):
            require(os.path.exists(os.path.join(exp, f"epoch_{epoch}", "model.pt")),
                    f"no epoch_{epoch} checkpoint")
            require(os.path.getsize(os.path.join(exp, f"decode_{epoch}.txt")) > 0,
                    f"no decode dump for epoch {epoch}")
        require(len(cers) == 2 and all(np.isfinite(cers)), f"CER {cers}")
        require(all(cli_counts[k] > 0 for k in ("flash_fwd", "flash_bwd", "alpha", "beta"))
                and cli_counts["banded_fwd"] == cli_counts["banded_bwd"] == 0,
                f"the entry point did not run the flash and lattice kernels: {cli_counts}")
        # the recognition entry point on the checkpoint training wrote, and
        # its loader's weights against the trained model's
        from transformer_transducer_tpu_torch.apps import predict as predict_app
        from transformer_transducer_tpu_torch.models.factory import load_family
        from transformer_transducer_tpu_torch.utils.config import load_config as load_cfg_file
        from transformer_transducer_tpu_torch.utils.vocab import Vocabulary
        cli_cfg = load_cfg_file(cfg_path)
        with open(cli_cfg.data.dev, encoding="utf-8") as fh:
            wav = fh.read().splitlines()[1].split(",")[0]
        reset_counts()
        text = predict_app.main(["--config", cfg_path, "--checkpoint",
                                 os.path.join(exp, "epoch_1"), "--wav", wav,
                                 "--full-context"])
        torch.cuda.synchronize()
        pred_counts = read_counts()
        wave, rate = read_wave(wav)
        feats = F.subsample(F.stack_frames(F.logmel_masked(wave, rate, n_mels),
                                           left_ctx, right_ctx), subsample_factor(cfg.data))
        second.model.eval()
        loaded = load_family(cli_cfg, feats.shape[1], os.path.join(exp, "epoch_1"),
                             device=device, flash=True)
        require(all(torch.equal(a, b) for a, b in zip(second.model.state_dict().values(),
                                                      loaded.state_dict().values())),
                "predict's loader did not restore the trained weights")
        del loaded
        tokens = recognize(second.model, torch.from_numpy(feats[None]).to(device),
                           [feats.shape[0]], max_tokens=max_tokens)[0]
        want_text = "".join(Vocabulary.from_file(cli_cfg.data.vocab).decode(tokens))
        log(f"apps/predict.py --full-context on epoch_1: {len(text)} characters, "
            f"launches {pred_counts}; its loader restored the trained weights; the "
            f"trained model's greedy decode {'matches' if text == want_text else 'differs'}")
        require(text == want_text, f"predict gave {text!r}, the trained model {want_text!r}")
        require(pred_counts["flash_fwd"] == n_layer,
                f"predict did not run the flash forward once a layer: {pred_counts}")
        # the pruned loss through the entry point, one epoch
        os.chdir(tmp)
        try:
            reset_counts()
            start = time.perf_counter()
            third = train_app.main(["-config", cfg_path, "--flash", "--pruned-range",
                                    str(S_RANGE), "--epochs", "1",
                                    "--set", "training.save_model=pruned"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - start
            cli_counts = read_counts()
        finally:
            os.chdir(cwd)
        exp = os.path.join(tmp, third.exp_dir)
        with open(os.path.join(exp, "metrics.jsonl"), encoding="utf-8") as fh:
            rows = [r for r in map(json.loads, fh)]
        cers = [r["value"] for r in rows if r["tag"] == "cer"]
        losses = [r["value"] for r in rows if r["tag"] == "train_loss"]
        log(f"apps/train.py --flash --pruned-range {S_RANGE}: 1 epoch in {cli_s:.1f} s, "
            f"{third.global_step} steps, train losses {losses}, CER {cers}, "
            f"launches {cli_counts}")
        require(third.step_cfg.loss_pruned_range == S_RANGE and third.global_step == 4,
                f"pruned CLI: {third.step_cfg}, {third.global_step} steps")
        require(os.path.exists(os.path.join(exp, "epoch_0", "model.pt"))
                and len(cers) == 1 and all(np.isfinite(cers + losses)),
                f"pruned CLI: no checkpoint, or CER {cers} / losses {losses}")
        require(all(cli_counts[k] == 4 for k in ("logz", "band_alpha", "band_beta"))
                and cli_counts["flash_bwd"] == 4 * n_layer,
                f"the pruned entry point did not run its kernels once a step: {cli_counts}")
        del first, second, third
    torch.cuda.empty_cache()

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 8")
    # ---- 8. training timings (B=4, T=410, H=8, Dh=64)
    from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
        banded_attention_backward)
    from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
        flash_rel_attention_backward)
    from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import (
        alpha_scan, alpha_scan_plain, beta_scan, beta_scan_plain)
    log(f"training timings on {smi}:")
    for rec in records:          # the forward kernels ran in training too
        rec["launches"] += train_launches[f"{rec['name'].split('_')[0]}_fwd"]
    sb, sl, inject = lattice_inputs(B_TRAIN, T_MAIN, 42, gen, with_empty=False)
    d_total, u1 = sb.shape[1], sb.shape[2]
    # the chain's step alone: one thread, dependent x = lae(x + c, y)
    from transformer_transducer_tpu_torch.ops.cuda.rnnt_kernel import lae_chain
    n_chain = 20 * (d_total - 1)
    cy = torch.tensor([0.0, -0.5, -1.0], device="cuda")
    chain_step_ms = cuda_ms(lambda: lae_chain(cy, n_chain), samples=10, reps=3) / n_chain
    chain_ms = (d_total - 1) * chain_step_ms
    log(f"  the chain's step (one thread, {n_chain} dependent x = lae(x + c, y)): "
        f"{1e6 * chain_step_ms:.2f} ns; chain bound for {d_total - 1} diagonals "
        f"{chain_ms:.4f} ms")
    for name, key, replaces, kern, plain, n_grids in (
            ("rnnt_alpha", "alpha", "rnnt_kernel.py:158",
             lambda: alpha_scan(sb, sl), lambda: alpha_scan_plain(sb, sl), 3),
            ("rnnt_beta", "beta", "rnnt_kernel.py:190",
             lambda: beta_scan(sb, sl, inject),
             lambda: beta_scan_plain(sb, sl, inject), 4)):
        ms, plain_ms = graph_ms(kern), cuda_ms(plain, samples=5, reps=2)
        bound_ms, bound_by = lattice_bound(B_TRAIN, d_total, u1, n_grids)
        log(f"  {name} (B={B_TRAIN}, D={d_total}, U1={u1}): kernel {ms:.4f} ms "
            f"({1e3 * ms / (d_total - 1):.3f} us per dependent diagonal), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), chain bound "
            f"{chain_ms:.4f} ms ({100 * chain_ms / ms:.1f} % of it), "
            f"{train_launches[key] // 9} launch per step")
        records.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/rnnt_lattice.cu",
            "replaces": f"transformer_transducer_tpu/ops/pallas/{replaces}",
            "launches": train_launches[key], "max_abs_err": errs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "chain_bound_ms": chain_ms,
            "registers": {k: r for k, r in lattice_sass["registers"].items()
                          if k.endswith(key)}})

    # the pruned loss's kernels at the flagship training shapes
    from transformer_transducer_tpu_torch.ops.cuda.band_kernel import (
        band_alpha, band_alpha_plain, band_alpha_plan, band_beta, band_beta_plain,
        band_chain)
    from transformer_transducer_tpu_torch.ops.cuda.logz_kernel import (
        additive_logz, additive_logz_plain, marked_cells)
    u1, vocab = cfg.data.max_target_length + 1, cfg.model.vocab_size
    a = torch.randn(B_TRAIN, T_MAIN, vocab, generator=gen, device="cuda") * 3
    l = torch.randn(B_TRAIN, u1, vocab, generator=gen, device="cuda") * 3
    with torch.no_grad():
        # the four launches of a call in one graph, 20 calls
        ms = graph_ms(lambda: additive_logz(a, l))
        marked = marked_cells()
        launch_split = device_top(lambda: additive_logz(a, l), n=4, calls=20, unit="us")
        plain_ms = cuda_ms(lambda: additive_logz_plain(a, l), samples=5, reps=2)
        # library yardstick, never called by the port: one PyTorch call over
        # the whole (B, T, U1, V) sum (1.8 GB)
        lib_ms = cuda_ms(lambda: torch.logsumexp(a[:, :, None] + l[:, None], dim=-1),
                         samples=5, reps=2)
    # the logZ's backward (plain PyTorch, a loop over U1), as the pruned
    # step's simple-loss term runs it
    a.requires_grad_()
    l.requires_grad_()
    z = additive_logz(a, l)
    g = torch.randn_like(z)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(z, (a, l), g, retain_graph=True),
                     samples=5, reps=2)
    del z, g
    lb = logz_bound(B_TRAIN, T_MAIN, u1, vocab)
    log(f"  additive_logz (B={B_TRAIN}, T={T_MAIN}, U1={u1}, V={vocab}): kernel "
        f"{ms:.4f} ms (its four launches, alone, CUDA graph), plain {plain_ms:.4f} ms, "
        f"torch.logsumexp over the whole sum (library) {lib_ms:.4f} ms, bound "
        f"{lb['ms']:.4f} ms ({lb['by']}: bytes {lb['bytes']:.4f} ms, 3xTF32 product "
        f"{lb['tf32']:.4f} ms, exponentials {lb['exp']:.4f} ms at "
        f"{SFU_PER_SM_PER_CLOCK}/SM/clock and {sm_clock_hz() / 1e6:.0f} MHz), "
        f"{100 * lb['ms'] / ms:.1f} % of bound; its bytes as built ({lb['n_split']} "
        f"slices of V) {lb['as_built']:.4f} ms; the exact form's bound (its "
        f"exponentials) {lb['exact_form']:.4f} ms; cells through the exact pass "
        f"{marked} here, {pruned_marks} in phase 6b's steps; per launch (profiler, "
        f"eager): {launch_split}; {logz_sass['hmma']} HMMA, {logz_sass['registers']} "
        f"registers, {logz_sass['atomics']} atomics; {pruned_launches['logz'] // 3} call "
        f"per pruned step; its backward (plain, {u1} passes over (B, T, V)) "
        f"{bwd_ms:.4f} ms")
    records.append({
        "name": "additive_logz", "route": "cuda", "source": f"{PKG}/csrc/additive_logz.cu",
        "replaces": "transformer_transducer_tpu/ops/pallas/logz_kernel.py:58",
        "launches": pruned_launches["logz"], "max_abs_err": errs["logz"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": lb["ms"], "bound_by": lb["by"],
        "library_ms": lib_ms, "kernels_per_launch": 4, "share_of_bound": lb["ms"] / ms,
        "bound_tc_ms": lb["tf32"], "exact_form_bound_ms": lb["exact_form"],
        "io_as_built_ms": lb["as_built"], "n_split": lb["n_split"],
        "marked_cells": marked, "marked_cells_pruned_steps": pruned_marks,
        "backward_plain_ms": bwd_ms, **logz_sass})
    del a, l
    lp_b, lp_l, d_a, d_b, tf, sf = band_inputs(gen, B_TRAIN, T_MAIN, S_RANGE)
    n_chunks = band_alpha_plan(T_MAIN, S_RANGE)
    # the beta's chain is its longest sequence's: rows tf .. 0
    chain = {"band_alpha": band_chain(T_MAIN, n_chunks, S_RANGE),
             "band_beta": band_chain(int(tf.max()) + 1, n_chunks, S_RANGE)}
    for name, replaces, kern, plain, n_arrays in (
            ("band_alpha", "band_kernel.py:181",
             lambda: band_alpha(lp_b, lp_l, d_a, S_RANGE),
             lambda: band_alpha_plain(lp_b, lp_l, d_a), 3),
            ("band_beta", "band_kernel.py:215",
             lambda: band_beta(lp_b, lp_l, d_b, tf, sf, S_RANGE),
             lambda: band_beta_plain(lp_b, lp_l, d_b, tf, sf), 3)):
        ms, plain_ms = graph_ms(kern), cuda_ms(plain, samples=5, reps=2)
        bound_ms, bound_by = band_bound(B_TRAIN, T_MAIN, S_RANGE, n_arrays)
        rec = {"name": name, "route": "cuda", "source": f"{PKG}/csrc/rnnt_pruned.cu",
               "replaces": f"transformer_transducer_tpu/ops/pallas/{replaces}",
               "launches": pruned_launches[name], "max_abs_err": errs[name], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "chain_steps": chain[name],
               "us_per_chain_step": 1e3 * ms / chain[name], "n_chunks": n_chunks,
               # its chain bound: that many dependent log-add steps of the
               # lattice sweeps' measured step (ttx_rnnt_lae_chain)
               "chain_bound_ms": chain[name] * chain_step_ms,
               "share_of_chain_bound": chain[name] * chain_step_ms / ms,
               "kernels_per_launch": 1 + (n_chunks > 1), **band_sass[name]}
        log(f"  {name} (B={B_TRAIN}, T={T_MAIN}, S={S_RANGE}): kernel {ms:.4f} ms, "
            f"{chain[name]} dependent steps on its chain ({rec['us_per_chain_step']:.3f} "
            f"us a step; chain bound {rec['chain_bound_ms']:.5f} ms, "
            f"{100 * rec['share_of_chain_bound']:.1f} % of it), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
            f"{pruned_launches[name] // 3} call per pruned step; {n_chunks} chunks "
            f"(band_alpha_plan), {rec['atomics']} atomics, registers {rec['registers']}")
        records.append(rec)

    args = attention_inputs(T_MAIN, 410, gen, b=B_TRAIN)
    gout = torch.randn(B_TRAIN, T_MAIN, H, DH, generator=gen, device="cuda")
    leaves = [a.detach().requires_grad_() for a in args]
    q, k, v, re, u, rb = args
    qh, kh, vh = (z.transpose(1, 2).detach().requires_grad_() for z in (q, k, v))
    with torch.no_grad():
        from transformer_transducer_tpu_torch.models.attention import rel_shift
        bd = rel_shift(torch.einsum("bind,jnd->bnij", q, re) + rb.t()[None, :, None, :])
        add = (bd + torch.einsum("nd,bjnd->bnj", u, k)[:, :, None, :]) / DH ** 0.5
        add_band = add.masked_fill(context_mask(T_MAIN, *band, device=device),
                                   float("-inf"))
    for name, key, fn, bwd, plain_fn, extra, mask_add, cells, replaces, source in (
            ("banded_attention_bwd", "banded", "ttx_banded_attention_fwd",
             banded_attention_backward, banded_attention_plain, band, add_band,
             band_cells(T_MAIN, *band), "banded_attention.py:346",
             "banded_attention_bwd.cu"),
            ("flash_rel_attention_bwd", "flash", "ttx_flash_rel_attention_fwd",
             flash_rel_attention_backward, flash_rel_attention_plain, (), add,
             T_MAIN * T_MAIN, "flash_rel_attention.py:288",
             "flash_rel_attention_bwd.cu")):
        out, lse, _ = common.launch_forward(fn, args, tuple(extra), with_lse=True)
        out_p = plain_fn(*leaves, *extra)
        # yardstick only: SDPA's backward on q, k, v with BD as a
        # precomputed additive mask (no table gradients); never in the port
        out_s = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask_add)
        ms = graph_ms(lambda: bwd(*args, out, lse, gout, *extra))
        plain_ms = cuda_ms(lambda: torch.autograd.grad(out_p, leaves, gout,
                                                       retain_graph=True))
        yard_ms = cuda_ms(lambda: torch.autograd.grad(
            out_s, (qh, kh, vh), gout.transpose(1, 2), retain_graph=True))
        bound_ms, bound_by = backward_bound(B_TRAIN, T_MAIN, cells)
        rec = {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
               "replaces": f"transformer_transducer_tpu/ops/pallas/{replaces}",
               "launches": train_launches[f"{key}_bwd"],
               "max_abs_err": errs[f"{key}_bwd"], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
               "sdpa_bd_mask_yardstick_ms": yard_ms}
        note = ""
        if key == "banded":     # SIMT, no atomics: two launches bit-identical
            first = bwd(*args, out, lse, gout, *extra)
            again = bwd(*args, out, lse, gout, *extra)
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            require(same, "two launches of the banded backward differ")
            del first, again
            main, tables = simt["banded_bwdILi64E"], simt["banded_bwd_tablesILi64E"]
            rec.update(kernels_per_launch=2, io_as_built_ms=backward_io_ms(B_TRAIN, T_MAIN),
                       share_of_bound=bound_ms / ms, registers=main["registers"],
                       spill_bytes=main["spill_bytes"], sass=main["sass"],
                       atomics=main["atomics"] + tables["atomics"],
                       tables_registers=tables["registers"], tables_sass=tables["sass"],
                       deterministic=same)
            split = device_top(lambda: bwd(*args, out, lse, gout, *extra), n=2, calls=20,
                               unit="us")
            note = (f"; its bytes as built (with O and lse) {rec['io_as_built_ms']:.4f} ms; "
                    f"{rec['registers']} registers, {rec['sass']} SASS instructions, "
                    f"{rec['atomics']} atomics, two launches bit-identical; two kernels "
                    f"a launch: {split}")
        if key == "flash":      # on the tensor cores: its 3xTF32 bound too
            rec.update(bound_tc_ms=backward_bound_tc(B_TRAIN, T_MAIN, cells),
                       share_of_bound=bound_ms / ms, **tc["flash backward"])
            rec["share_of_bound_tc"] = rec["bound_tc_ms"] / ms
            note = (f", 3xTF32 bound {rec['bound_tc_ms']:.4f} ms, "
                    f"{100 * rec['share_of_bound_tc']:.1f} % of it; {rec['hmma']} HMMA, "
                    f"{rec['registers']} registers")
        log(f"  {name}: kernel {ms:.4f} ms (alone, CUDA graph), plain (autograd) "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, fp32), "
            f"{100 * bound_ms / ms:.1f} % of bound{note}; SDPA backward with BD as a "
            f"precomputed mask (yardstick) {yard_ms:.4f} ms; {n_layer} launches per step")
        records.append(rec)
    del args, leaves, out, lse, out_p, out_s, bd, add, add_band
    torch.cuda.empty_cache()

    # the flagship train step, config dropout 0.5, SpecAugment on; first the
    # full and the pruned loss with --flash in turns, then each mode alone
    pair = {}
    for name, pruned_range in (("flash", None), (f"flash, pruned {S_RANGE}", S_RANGE)):
        step = make_trainee(cfg.model, optim_cfg, state, "flash", device,
                            pruned_range)[2]
        sa = torch.Generator().manual_seed(0)
        pair[name] = functools.partial(step, batch, sa)
    for name, ms in host_ms(pair).items():
        log(f"  train step B={B_TRAIN} ({name}), the two in turns: {spread(ms)}")
    del pair, step
    torch.cuda.empty_cache()
    for mode, pruned_range in (("flash", None), ("flash", S_RANGE), ("banded", None),
                               ("dense", None)):
        model, opt, step = make_trainee(cfg.model, optim_cfg, state, mode, device,
                                        pruned_range)
        if pruned_range:
            mode = f"flash, pruned {S_RANGE}"
        sa = torch.Generator().manual_seed(0)
        run = lambda: step(batch, sa)
        ms = host_ms({mode: run})[mode]
        parts = (split_pruned_step if pruned_range else split_step)(model, opt, batch, sa)
        busy = device_busy_ms(run)
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(ms)
        share = (f"{100 * (1 - busy / med):.1f} %" if busy > 0
                 else "not measured (the profiler saw no device time)")
        log(f"  train step B={B_TRAIN} ({mode}): {spread(ms)}, "
            f"{batch_audio_s * 1e3 / med:.1f} s of audio per second; split "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
            + f"; device busy {busy:.2f} ms of one step, idle share {share}; "
            f"peak memory {peak:.2f} GiB")
        if mode.startswith("flash"):
            log(f"    most device time in one step: {device_top(run)}")
        del model, opt, step, run
        torch.cuda.empty_cache()

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 9")
    # ---- 9. streaming at full width
    stream_rec, streaming = check_streaming(cfg, state, offset, device, smi, gen)
    next(r for r in records if r["name"] == "banded_attention_fwd").update(stream_rec)
    log(json.dumps({"streaming": streaming}))

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 10")
    # ---- 10. multi-stream serving at full width
    serve_rec, serving = check_serving(cfg, state, offset, device, smi, gen)
    next(r for r in records if r["name"] == "banded_attention_fwd").update(serve_rec)
    log(json.dumps({"serving": serving}))

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 11")
    # ---- 11. what the JAX package trained: its checkpoints, the on-device
    # log-mel, augmentation
    start = time.perf_counter()
    jax_launches, slice_6a = check_slice_6a(
        cfg, state, offset, {"x": x, "band": tok_band, "full-context": tok_full},
        device, smi)
    slice_6a["phase_s"] = time.perf_counter() - start
    for rec in records:
        key = {"banded_attention_fwd": "banded_fwd", "flash_rel_attention_fwd": "flash_fwd",
               "banded_attention_bwd": "banded_bwd", "flash_rel_attention_bwd": "flash_bwd",
               "rnnt_alpha": "alpha", "rnnt_beta": "beta", "additive_logz": "logz",
               "band_alpha": "band_alpha", "band_beta": "band_beta"}[rec["name"]]
        rec["phase11_launches"] = jax_launches.get(key, 0)
        rec["launches"] += rec["phase11_launches"]
    log(json.dumps({"slice_6a": slice_6a}))

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 12")
    # ---- 12. the beam search and int8 serving
    start = time.perf_counter()
    beam_launches, slice_7_9 = check_beam_int8(
        cfg, state, offset, {"x": x, "t_len": t_len, "band": tok_band,
                             "full-context": tok_full}, device, smi)
    slice_7_9["phase_s"] = time.perf_counter() - start
    for rec in records:
        key = {"banded_attention_fwd": "banded_fwd",
               "flash_rel_attention_fwd": "flash_fwd"}.get(rec["name"])
        rec["phase12_launches"] = beam_launches.get(key, 0)
        rec["launches"] += rec["phase12_launches"]
    log(json.dumps({"slice_7_9": slice_7_9}))

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 13")
    # ---- 13. the espnet family: serving (no kernel) and training (kernels 1-5)
    start = time.perf_counter()
    torch.cuda.empty_cache()
    espnet_launches, espnet = check_espnet({"x": x, "t_len": t_len}, device, smi)
    espnet["phase_s"] = time.perf_counter() - start
    for rec in records:
        key = {"rnnt_alpha": "alpha", "rnnt_beta": "beta", "additive_logz": "logz",
               "band_alpha": "band_alpha", "band_beta": "band_beta"}.get(rec["name"])
        rec["phase13_launches"] = espnet_launches.get(key, 0)
        rec["launches"] += rec["phase13_launches"]
    log(f"  phase 13: {espnet['phase_s']:.1f} s")
    log(json.dumps({"espnet": espnet}))

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 14")
    # ---- 14. --remat and --bf16 training at flagship width
    start = time.perf_counter()
    torch.cuda.empty_cache()
    bf16_launches, slice_6b = check_bf16_remat(cfg, state, batch, device, smi)
    slice_6b["phase_s"] = time.perf_counter() - start
    for rec in records:
        key = {"banded_attention_fwd": "banded_fwd", "flash_rel_attention_fwd": "flash_fwd",
               "banded_attention_bwd": "banded_bwd", "flash_rel_attention_bwd": "flash_bwd",
               "rnnt_alpha": "alpha", "rnnt_beta": "beta", "additive_logz": "logz",
               "band_alpha": "band_alpha", "band_beta": "band_beta"}[rec["name"]]
        # the float32 flash rows count their own form's launches; the bf16
        # forms' (also on flash_fwd, flash_bwd) have rows of their own
        rec["phase14_launches"] = (bf16_launches.get(key, 0)
                                   - bf16_launches.get(f"{key}_bf16", 0))
        rec["launches"] += rec["phase14_launches"]
    records += time_bf16_flash(gen, errs, bf16_launches, tc, smi)
    slice_6b["phase_s"] = time.perf_counter() - start
    log(f"  phase 14: {slice_6b['phase_s']:.1f} s")
    log(json.dumps({"slice_6b": slice_6b}))

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 15")
    # ---- 15. the native runtime, --profile, checkpoint averaging and conversion
    start = time.perf_counter()
    torch.cuda.empty_cache()
    host_launches, host = check_host_remainder(
        cfg, state, offset, {"x": x, "t_len": t_len, "band": tok_band,
                             "full-context": tok_full}, device, smi)
    host["phase_s"] = time.perf_counter() - start
    for rec in records:
        key = {"banded_attention_fwd": "banded_fwd", "flash_rel_attention_fwd": "flash_fwd",
               "banded_attention_bwd": "banded_bwd", "flash_rel_attention_bwd": "flash_bwd",
               "rnnt_alpha": "alpha", "rnnt_beta": "beta", "additive_logz": "logz",
               "band_alpha": "band_alpha", "band_beta": "band_beta",
               "flash_rel_attention_fwd_bf16": "flash_fwd_bf16",
               "flash_rel_attention_bwd_bf16": "flash_bwd_bf16"}[rec["name"]]
        # the float32 flash rows count their own form's launches (the bf16
        # forms, also on flash_fwd and flash_bwd, have rows of their own)
        own = host_launches.get(key, 0) - (host_launches.get(f"{key}_bf16", 0)
                                           if not key.endswith("_bf16") else 0)
        rec["phase15_launches"] = own
        rec["launches"] += own
    log(f"  phase 15: {host['phase_s']:.1f} s")
    log(json.dumps({"host_remainder": host}))

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 16")
    # ---- 16. export through torch.export; data parallelism with ZeRO-1
    start = time.perf_counter()
    torch.cuda.empty_cache()
    export_launches, export_dp = check_export_dp(cfg, state, {"x": x}, batch, device, smi)
    export_dp["phase_s"] = time.perf_counter() - start
    for rec in records:
        key = {"flash_rel_attention_fwd": "flash_fwd", "flash_rel_attention_bwd": "flash_bwd",
               "banded_attention_fwd": "banded_fwd", "banded_attention_bwd": "banded_bwd",
               "rnnt_alpha": "alpha", "rnnt_beta": "beta"}.get(rec["name"])
        # the float32 forms alone (the bf16 rows count none here)
        rec["phase16_launches"] = export_launches.get(key, 0)
        rec["launches"] += rec["phase16_launches"]
    log(f"  phase 16: {export_dp['phase_s']:.1f} s")
    log(json.dumps({"export_dp": export_dp}))

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 17")
    # ---- 17. tensor parallelism (--n_model 2), alone and on a dp2 x tp2 grid
    start = time.perf_counter()
    torch.cuda.empty_cache()
    tp_launches, tensor_parallel = check_tensor_parallel(cfg, state, batch, device, smi)
    tensor_parallel["phase_s"] = time.perf_counter() - start
    for rec in records:
        key = {"banded_attention_fwd": "banded_fwd", "flash_rel_attention_fwd": "flash_fwd",
               "banded_attention_bwd": "banded_bwd", "flash_rel_attention_bwd": "flash_bwd",
               "rnnt_alpha": "alpha", "rnnt_beta": "beta", "additive_logz": "logz",
               "band_alpha": "band_alpha", "band_beta": "band_beta",
               "flash_rel_attention_fwd_bf16": "flash_fwd_bf16",
               "flash_rel_attention_bwd_bf16": "flash_bwd_bf16"}[rec["name"]]
        # the float32 flash rows count their own form's launches (the bf16
        # forms, also on flash_fwd and flash_bwd, have rows of their own)
        own = tp_launches.get(key, 0) - (tp_launches.get(f"{key}_bf16", 0)
                                         if not key.endswith("_bf16") else 0)
        rec["phase17_launches"] = own
        rec["launches"] += own
    log(f"  phase 17: {tensor_parallel['phase_s']:.1f} s")
    log(json.dumps({"tensor_parallel": tensor_parallel}))

    log(f"[{time.perf_counter() - run_start:.1f} s] phase 18")
    # ---- 18. pipeline parallelism (--n_pipe 2), alone and on a dp2 x pp2 grid
    start = time.perf_counter()
    torch.cuda.empty_cache()
    pp_launches, pipeline = check_pipeline(cfg, state, batch, device, smi,
                                           tensor_parallel["one_process"])
    pipeline["phase_s"] = time.perf_counter() - start
    for rec in records:
        key = {"banded_attention_fwd": "banded_fwd", "flash_rel_attention_fwd": "flash_fwd",
               "banded_attention_bwd": "banded_bwd", "flash_rel_attention_bwd": "flash_bwd",
               "rnnt_alpha": "alpha", "rnnt_beta": "beta", "additive_logz": "logz",
               "band_alpha": "band_alpha", "band_beta": "band_beta",
               "flash_rel_attention_fwd_bf16": "flash_fwd_bf16",
               "flash_rel_attention_bwd_bf16": "flash_bwd_bf16"}[rec["name"]]
        # the float32 flash rows count their own form's launches (the bf16
        # forms, also on flash_fwd and flash_bwd, have rows of their own)
        own = pp_launches.get(key, 0) - (pp_launches.get(f"{key}_bf16", 0)
                                         if not key.endswith("_bf16") else 0)
        rec["phase18_launches"] = own
        rec["launches"] += own
    log(f"  phase 18: {pipeline['phase_s']:.1f} s")
    log(json.dumps({"pipeline": pipeline, "phase18_launches": pp_launches}))

    log(f"[{time.perf_counter() - run_start:.1f} s] all phases passed")
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
