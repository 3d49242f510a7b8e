#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure exits non-zero; nothing is caught):

  1. build   — compile every CUDA source (csrc/*.cu) with nvcc (sm_90a), one
               process each, all at once; print the wall time and the ptxas
               report; count the int8 warpgroup MMAs (IGMMA ... S8.S8) in
               the built spike_matmul library's SASS (cuobjdump -sass: must
               be non-zero) and the TF32 ones (HGMMA ... TF32) in
               flash_attention's and flash_attention_bwd's (non-zero), and
               the atomics (ATOM, ATOMS, ATOMG, RED) in flash_attention_bwd's
               (zero: one writer an output element); compile the backward
               it replaced (scripts/baselines/flash_attention_bwd_two_walks.cu)
               beside them for phase 7; check that event_accum's kernels
               hold no shared memory (no ids staged, nothing that grows with
               E_max), that the lif and ttfs_decode kernels spill nothing,
               and that ttfs_decode's warp-per-row kernel holds no shared
               memory and no block barrier;
  2. kernels — each of the seven SNN kernels against its plain PyTorch version
               on the card, bit for bit (tolerance 0: all arithmetic is
               integer), at the MNIST serving shape (B = 64, with an all-PAD
               row) and on the eight adversarial fuzz artifacts packed from
               the golden spike times (leak_shift 31 with negative
               membranes, never-spiking rows, both decode fallbacks,
               tie-heavy rows), plus one 2,000-neuron layer (wide: four
               lanes a thread), a flood layer (N_pad 4096: eight
               lanes a thread and the shortest chunk; a row with every input
               at one tick, an all-PAD row, a row spread over all T) and a
               narrow one (N_pad 128, T 33: rows built to exit mid-chunk and
               on a chunk's last step). Kernels 1-3 are held on their launch
               plan (printed) and again on plans with chunks of 8 and of 1
               step, with the row loads each launch takes asserted (vector
               loads on every case above; bytewise on three layers whose
               N_pad, 99, 130 and 1000, is not a multiple of a lane's
               columns, and on the MNIST weights copied to an odd address);
               a plan the kernels cannot run must be refused before the
               launch by the wrapper and by the C entry point, and the
               wrapper's check_plan and the entry points' own test must
               agree on a grid of plans and altered plans. event_accum
               also takes the frames with their slots shuffled (PAD in the
               middle of a row), ttfs_decode tie-heavy rows under both
               fallbacks, and spike_matmul a random int8 product with ragged
               edges; the staged kernels' state must equal the fused
               kernels'. Rows wider than one block run on a thread-block
               cluster: flood layers at N_pad 8192 (2 blocks) and at
               MAX_N_PAD 32,768 (8 blocks), each with a row whose only
               early exit fires in a lane of the cluster's last block; a
               straddle layer (N_pad 8192) whose winning group spans the
               two blocks, with ties across them, under both fallbacks; and
               N_pad 4097 (the smallest cluster, bytewise row loads). The
               plan grid adds cluster plans and wide rows. event_accum also
               takes E_max 16,384 and the bytewise layers; spike_matmul its
               TMA and its masked route (asserted by ops.ROUTES) on ragged
               M/K/N, K 140,000 and 131,075, a misaligned raster, and an
               int8 product whose int32 sums wrap. lif_fused also takes
               windows of T 16, 31, 33, 64 and 100 at N_pad 4 to 1,024
               (chunks of 32 steps, a tail step by step or in batches of
               16, 8, 4, 2, 1) and, at T 33, a contiguous (T, B, N_pad)
               tensor, a lane stride of 2, an odd element offset and a t
               stride of N_pad + 1; ttfs_decode rows of 63, 150 and 1,024
               lanes (a warp a row) and of 1,025, 8,192 and 32,768 (a block
               a row; ops.ROUTES asserted), under both fallbacks, with
               negative first times, ties between lanes of different warp
               lanes and warps, and every membrane at INT32_MIN;
  3. main path — five serving runs over the 10,000 procedural MNIST test
               images, each with every launch counter set to 0 just before
               its requests and read just after its flush: SNNServeEngine on
               the fused kernels (full-T, latency mode) and on the staged
               CUDA kernels (kernel="cuda", full-T and latency mode), and
               ServingScheduler(spec="accelerator-batch", kernel="cuda").
               Each run must launch each kernel of its path once per served
               batch and no other kernel (batch-cuda's spike_matmul on its
               TMA route, reading the program's K-major weight copy; every
               ttfs_decode launch a warp a row), and serve the JAX
               reference's
               labels (and latency steps), exported in src/repro_torch/
               assets. Outside the counted runs, the fuzz artifacts are
               served and run through the fused and both -cuda accelerator
               specs against tests/golden/, and the staged early exit must
               equal the fused one in first spikes, v at exit and steps;
  3b. author — define, train, export and serve with the port alone, at the
               paper's width (784 -> 150, T 32, 60,000 training and 8,192
               calibration images of mnist.generate(60000, 1234), nothing
               cut): an SNN carrying mnist_ttfs.npz's w_float re-exported
               by deploy.export on the card must give JAX's artifact and
               program fingerprints (mnist_ttfs_expected.npz), every array
               byte-equal, with spike_matmul launched once and lif_fused and
               ttfs_decode once per threshold candidate (12) and nothing
               else; kernels 4, 5 and 6 held to their plain versions at the
               calibration's shapes (8,192 images, the 150 unpadded lanes,
               both leak shifts and fallbacks); train_dense_proxy (3 epochs,
               702 steps, the port's seeded init) on the card, exported the
               same way and counted the same way, then served through
               SNNServeEngine on the fused kernels over the 10,000 test
               images, full-T and latency mode (kernel 1 / kernel 2 once per
               batch, nothing else): labels equal SNNReference's on the new
               artifact for 10,000/10,000, latency steps equal the plain
               early-exit scan's, TTFS accuracy at least 0.89 (printed beside
               the JAX fixture's); train_surrogate (1 epoch of 8,192 images,
               T 16) whose loss falls and whose train accuracy exceeds 0.5;
               the pinned fuzz artifacts equal JAX's
               (assets/fuzz_seed*.npz), golden.check on tests/golden/
               clean, and run_case passing every oracle of each pinned
               seed on the card (its reports kept for phase 3d).
               The wall seconds of each export and of the training are
               printed beside the card's name and power limit, one more
               export and one epoch of training are profiled (device time
               by kernel, busy share), and the two
               exports' and two served runs' launches join the kernels
               summary;
  3c. transport — the program crosses processes without being lowered
               again: the envelopes of the MNIST program and of the eight
               fuzz programs lowered on the card must equal JAX's byte for
               byte (src/repro_torch/assets/transport_expected.npz), and every
               variant of fuzz_envelope_mutations must be refused with
               ProgramIOError; two launcher processes (python -m
               repro_torch.launch.serve --snn-artifact ... --transport
               tcp://127.0.0.1:0 --role leader --await-fetches 1, then
               --role follower at the port the leader printed) serve the
               launcher's 10,000 RandomState(0) requests on the card: both
               exit 0, the follower lowers nothing, and both label files
               equal each other and JAX's reference labels; in-process,
               distribute_program over a ProgramServer on loopback into an
               empty program cache, then SNNServeEngine on the 10,000 test
               images full-T and in latency mode, each with every launch
               counter set to 0 just before its requests: kernel 1, then
               kernel 2, once per served batch (157) and nothing else, JAX's
               labels and steps, no program lowered, transport_fetches >= 1
               and no fetch failure in stats(); run_suite on all 27 fault
               scenarios with the MNIST envelope (a fuzz envelope as the
               stale replay), every verdict ok. It prints the envelope's
               bytes, the median and p95 of 200 clean loopback fetches, each
               process's wall time from its start to its first label and the
               suite's wall time; the two in-process runs' launches join the
               kernels summary;
  3d. lanes  — worker lanes and resilience. ServingScheduler with threaded
               lanes over the 10,000 test images at max_batch 64 and the
               default max_wait_us (2,000): accelerator-event-fused at
               workers 1, 2 and 4 (full T) and at 2 in latency mode,
               accelerator-event-cuda and accelerator-batch-cuda at 2, each
               with every launch counter set to 0 before the scheduler is
               built and read after its drain: each kernel of the path
               launched once per served batch plus once per lane's warm-up
               probe, nothing else; JAX's labels (and latency steps); each
               lane on a CUDA stream of its own (none the default stream)
               and no device-wide synchronize during the run (torch.cuda.
               synchronize counted); the wall seconds, wall, system and
               accelerator us per image, p50/p95/p99 latency,
               batch_fill_mean and batches per lane printed. A closed loop
               of 8 client threads, each submit -> result() for 1,250
               requests, on workers 2 (counted the same way), JAX's labels
               and its latency percentiles. The resilience scenarios of
               tests/test_resilience.py on the card with their ledger
               checks (crash and retry, startup SEU scrubbed, watchdog
               replacing a hung lane, persistent SEU -> quarantine ->
               degrade, no-degrade refusing admission, the breaker stopping
               crash flapping on kernel 1; the stuck group caught by the
               canary and the membrane SEU caught by ECC on board-py), every
               request completing with JAX's label or an explicit error.
               board-py under each dynamic plan of src/repro_torch/assets/
               faults_expected.npz on MNIST (64 images) and the 8 fuzz
               cases, both modes: outputs, trace, tick histograms, last_ecc
               and stuck groups equal JAX's (where JAX's membrane upset
               raised, the port completes); the canaries and the corrupted
               clones of each static plan equal JAX's, each clone lowered on
               the card from its corrupted host arrays with the pristine
               program untouched; and phase 3b's run_case 25/25 oracles
               (fault-recovery included, none unported) on every pinned
               seed. The counted runs' launches join the kernels summary;
  4. overflow — the MNIST artifact with e_max = 8 must reroute rows to the
               dense path and still return the reference labels, with the
               fused and the staged kernels;
  4b. board  — the board emulator, held to the JAX board's results on the
               10,000 images (src/repro_torch/assets/mnist_board_expected.npz:
               digests and totals of every per-image trace field and output).
               Four served runs of SNNServeEngine(backend="board",
               kernel="cuda"), full-T and latency mode, with the artifact's
               E_max and with e_max 8 (the FIFO stalls), each with every
               launch counter set to 0 just before its requests and read just
               after its flush: full-T launches lif_fused once per served
               batch and nothing else (the first run is the board's main
               path, counted in the kernels summary), latency mode launches
               nothing (as in JAX); labels, steps, first spikes, membranes,
               the trace and the board_* stats must equal JAX's and the
               reference's. Kernel 5 is held to its plain version on the
               board's own (T, B, N_pad) view of its currents; board-batched-
               torch equals board-batched-cuda over 10,000 images and board-py
               (the host tick loop) equals it on the first 1,000 in both
               modes and both E_max, in every output and trace field; the
               fuzz artifacts equal tests/golden/ with their board_* arrays;
               full_agreement over the 10,000 images (accelerator-batch-cuda,
               -event-fused, -event-cuda, board-batched-cuda) must be exact
               and repeatability 0 / 50,000; the dense FP32 and INT8
               baselines' labels must equal JAX's, and one call of each on
               10,000 images is timed on the card (CUDA events, median of
               10); ten served board batches of each mode are profiled
               (device time by kernel, busy share). The board's cycles and
               nJ are the cost model's output;
               its modelled us are cycles at 80 MHz, not time on the card;
  5. attention — both flash-attention kernels against their plain version
               on the card, each case's route asserted by the per-kernel
               launch counters: every bfloat16 case of ATTN_CASES on the
               tensor-core kernel (flash_attention_sm90, tolerance 2e-2) and
               every float32 case on the split-TF32 kernel (flash_attention,
               2e-5; the tolerances of tests/test_kernels.py): the five
               shapes of that test's sweep, a ragged case, GQA group 8 with
               kv_len < Skv, a window spanning several tiles, queries that
               see no key (the mean of v), a non-causal cross case at D 128,
               a ragged case at the 128-row tile's scale (Sq = Skv = 1111)
               and Qwen3-8B's head shape, the last two read through
               (B, S, H, D) views as the model hands them over, at S 2048
               and at the prefill's own shape (B 2, S 4096), and the
               shapes phase 6b adds, as views: Mixtral's window (B 1, 32/8
               heads, S 8192, window 4096) and Qwen3-MoE's GQA group of 16
               (B 2, 64/4 heads, S 4096), and phase 6c's: Whisper's
               encoder (B 16, 6/6 heads, S 1500, D 64, non-causal: the
               kv tail of a ragged key length unmasked by causality), its
               cross-attention (Sq 448 over Skv 1500) and its decode step's
               (one query over 1,500 keys, q a view, k and v a contiguous
               cache slice), and InternVL's GQA group of 6 (B 2, 48/8
               heads, S 4096). The inputs the
               tensor-core kernel does not take go to the split-TF32 kernel,
               in both types (float32 at 2e-5, bf16 at 2e-2): the sweep at D
               16 and D 256, and D 128 q, k, v with padded rows, a misaligned
               start or a d stride of 2 (its element loads; every other case
               is read through cp.async). Besides each element, every
               128-row q tile of every head is held by its relative error
               norm (ATTN_REL_TOL),
               and the same check must catch a planted fault (the last q
               tile's first visible key tile skipped) in every case that has
               a key tile to skip. Each case runs once more with the row
               statistic asked for (return_lse=True): the output bitwise
               equal to the run without it, the statistic within
               ATTN_LSE_TOL of the plain version's on the rows that see a
               key and +inf exactly on those that see none;
  5b. backward — the backward kernel (flash_attention_bwd,
               csrc/flash_attention_bwd.cu) against flash_attention_bwd_ref
               on the card, one launch each, counted, in float32 (2e-5) and
               bf16 (2e-2), on the forward kernel's output and row statistic:
               phase 5's sweep, GQA 8 with kv_len < Skv, a window over
               several tiles, queries that see no key, Whisper's training
               cross-attention (B 4, Sq 448 over 1,500 keys, D 64,
               non-causal) and Yi-6B's training shape (B 4, 32/4 heads, S
               2048, D 128, causal), the last two as the model's views, the
               sweep at D 16 and D 256 (the CUDA-core route) and D 128 with
               a misaligned start or a d stride of 2 (element loads); each
               case's route (tensor cores or CUDA cores) asserted by
               BWD_ROUTES. dq, dk and dv are held element by element and by
               the relative error norm of each 128-row tile
               (ATTN_BWD_REL_TOL) against the plain version, which builds its
               own softmax; two launches on the same inputs must be bitwise
               equal, and the tile check must catch two planted faults:
               pass B skipping the first key tile, and the kernel run on the
               statistic with the last q tile's rows shifted by
               ATTN_LSE_FAULT;
  6. LM path — Qwen3-8B at full width and depth (36 layers, 8.19 B
               parameters drawn in bf16 on the card from a seeded generator):
               make_prefill_step on 2 x 4096 tokens of the TokenPipeline,
               with every launch counter set to 0 just before and read just
               after (flash_attention_sm90 once per layer, every other
               kernel never), and each layer's attention output in that run
               held to the plain version on the same q, k, v views (2e-2,
               bf16, and the q tiles' relative error norm, as in phase 5);
               the same model with attention on the plain version
               (max |logit difference| at most twice that between the plain
               version and SDPA on the same model, the same greedy last
               token on every row); the forward against token-by-token
               prefill at 4 layers of full width in float32 (within 2e-3, as
               tests/test_models.py holds JAX; the forward is the float32
               route's counted run: flash_attention once per layer, every
               other kernel never); and ServeEngine.generate on 8
               prompts in float32, as the launcher serves, each served token
               the forward's greedy choice within that tolerance. Then where
               the LM's time goes: the bf16 prefill's wall time on the
               kernel, the plain version and SDPA (median of 3 warm runs),
               one prefill on the kernel under torch.profiler (device time by
               kernel group, the device's busy share of the window), and the
               float32 decode step (median of 16 warm steps, 4 profiled);
  6b. families — the MoE and SSM families (a function of its own,
               families()), with TF32 off for float32 products. Mixtral-8x7B
               (16 of 32 layers at full width, 46.9 GB in bf16; 1 x 8192
               tokens, twice its window) and Qwen3-MoE-235B-A22B (8 of 94
               layers, 42.3 GB; 2 x 4096 tokens): the bf16 make_prefill_step
               counted (flash_attention_sm90 once per layer, nothing
               else), each MoE sublayer on its own inputs (loads, drops and
               aux at the served capacity factor 1.0; moe_ffn at the least
               drop-free factor against moe_ffn_dense_oracle, 2e-2 element
               by element and a relative error norm of 1e-2) and each
               attention on its own views against the plain version, as
               in phase 6; at 2 layers of full width in float32, the
               forward on a copy of the config at a drop-free factor
               (flash_attention once per layer) against token-by-token
               decode (2e-3), and ServeEngine on 8 prompts at the served
               factor, each served token the forward's greedy choice. The
               card's float32 moe_ffn against JAX's outputs
               (src/repro_torch/assets/moe_expected.npz, inputs redrawn from
               their RandomState seeds): top_i and keep equal, output within
               1e-5, aux within 1e-6. Mamba2-780M whole (48 layers): the
               bf16 prefill of 2 x 4096 tokens launches no kernel;
               ssd_chunked against ssd_naive_ref on layer 0's own float32
               inputs (1e-4); the float32 forward against decode at 4
               layers; ServeEngine on 8 prompts. For each prefill its wall
               time (median of 3 warm runs) and one run under torch.profiler
               with moe_ffn, ssd_chunked and the attention launch in
               record_function ranges: device time by group (attention,
               expert products, dispatch/combine glue, SSD, other products,
               other) and the busy share; and the float32 decode step
               (median of 16);
  6c. frontends — the audio encoder-decoder and the vision prefix (a
               function of its own, frontends()), random weights from a
               seed. Whisper-tiny whole (4 + 4 layers, d 384): the bf16
               make_prefill_step on 16 x 448 tokens with enc_frames (16,
               1500, 384) counted (flash_attention_sm90 12 times: 4 encoder,
               4 self-, 4 cross-attentions; nothing else), each attention on
               its own views against the plain version; in float32 the
               forward (flash_attention 12 times) against 256 decode steps
               with the cross cache filled from encode through
               LM._cross_kv (2e-3; flash_attention 4 times a step) and
               ServeEngine on 8 prompts against the zero cross cache, as the
               launcher serves (4 launches a decode step, each served token
               the greedy choice of the forward over the same zero keys);
               the card's float32 whisper-tiny against JAX's
               (src/repro_torch/assets/whisper_expected.npz, model and
               inputs redrawn from its recipe by draw_whisper, 1e-4).
               InternVL2-26B whole (48 layers, 19.86 B parameters, 39.7 GB
               in bf16): the bf16 prefill on 2 x 4096 tokens with
               patch_embeds (2, 256, 6144) counted (flash_attention_sm90 48
               times, nothing else), each layer's attention on its own
               views, the splice exact (the first 256 embedded positions
               the patches in bf16, other tokens under them bit-identical
               logits); at 2 layers of full width in float32 the forward
               against decode and ServeEngine. For each bf16 prefill its
               wall time (median of 3 warm runs), one profiled run
               (encode, the cross-attention and the LM head in ranges of
               their own) and the LM head's product alone; the float32
               decode step (median of 16); the peak memory of each model;
  6d. training — LM training (a function of its own, training()), float32.
               Yi-6B at full width, 8 of its 32 layers (1.91 B parameters),
               AdamW and remat as configured, 5 steps of 4 x 2048 tokens
               through the launcher's Trainer, each counted (flash_attention
               16 times: 8 forward, 8 recomputed by remat; the backward
               kernel 8 times; no other kernel, and no call of the plain
               attention, forward or backward); loss and grad norm finite;
               the step's wall time (median of 3 warm steps), tokens/s and
               peak memory; the gradients of one batch with attention's
               backward on the kernel against those with it on the plain
               version, leaf by leaf (TRAIN_GRAD_REL_TOL); one step under
               torch.profiler (forward and backward products, attention
               forward and backward, optimiser, other; busy share), the
               backward's group (kernels named flash_bwd_*) non-zero and
               its time by pass.
               Whisper-tiny whole, 4 x 448 tokens over 4 x 1,500 frames, 3
               counted steps (flash_attention 20 a step: 4 encoder, 4 self-
               and 4 cross-attentions twice under remat; the backward 12), a
               checkpoint at step 2 restored into a fresh model and
               optimiser whose step 3 equals the uninterrupted run's bit for
               bit (deterministic algorithms on around both). The reduced
               Yi-6B redrawn from src/repro_torch/assets/
               lm_train_expected.npz's recipe (draw_lm_train), two steps
               each of AdamW, Adafactor and SGD with two micro-batches and
               int8 compression, against JAX's losses and grad norms (1e-5
               relative) and parameters (1e-4);
  6e. dist    — distribution and analysis (a function of its own,
               distribution()). NCCL at world 1 (file rendezvous in a
               temporary directory), mesh (data 1, model 1) from
               make_test_mesh: Qwen3-MoE-235B-A22B's MoE sublayer at full
               width (E 128, top-8, d 4096, f 1536, capacity factor 1.0) in
               bf16 on 2 x 4096 tokens, moe_ffn_shard_map against moe_ffn
               bit for bit (output, aux, top_i, keep); Qwen3-MoE at 2 layers
               of full width with moe_buf_mode "shard_map" and the mesh's
               constrainer, its bf16 prefill counted (flash_attention_sm90
               once a layer, both MoE sublayers on moe_ffn_shard_map) and
               its logits bit for bit the mesh-less LM's. Two gloo ranks on
               the one card, spawned by this script (chip_smoke.py
               --moe-rank; NCCL refuses two ranks on one device), mesh (data
               1, model 2): the same sublayer in float32 with TF32 off, each
               rank its 64 experts (the other 64 NaN there), routing exactly
               moe_ffn's, output within 1e-5, aux within 1e-6; a rank that
               fails or a spawn past DIST_SPAWN_S fails the phase. The
               roofline (distributed/roofline.py on core.hw.H100, one card,
               no collective term) of Qwen3-8B's and phase 6b's MoE prefills
               against their measured walls (each wall at least 0.95 x the
               roofline's step), and the record's HBM size within 10 % of
               the card's. The walls of both MoE forms in both runs are
               printed, a record only;
  6f. dryrun — the port's dry-run (launch/dryrun.py; a function of its own,
               dry_run()): each cell's step on fake tensors over the fake
               process group, on "cuda". (a) World 1, mesh (data 1, model
               1): phase 6d's Yi-6B step (TRAIN_LAYERS layers, float32,
               AdamW at 3e-4), its argument bytes exactly those of the
               parameters, AdamW state and batch phase 6d allocated, fits
               true, its predicted peak (argument + output + temp) beside
               phase 6d's max_memory_allocated with their ratio (a record);
               all 32 layers fit false; phase 6's Qwen3-8B bf16 prefill's
               argument bytes exactly its real tensors'. (b) Phase 6e's
               float32 MoE sublayer on (data 1, model 2) on the fake group:
               the same collectives, op for op and byte for byte, as each
               gloo rank of phase 6e counted under CommDebugMode. (c)
               DRYRUN_CELLS at full width on the production meshes, each
               in a process of its own started with the phase
               (`tests/_torch_dryrun_fake.py OUT sites ...`: the record,
               and each collective tagged with its kind, mesh dims, call
               site and direction), each ok, with its roofline row,
               fits, collective bytes by kind and wire bytes a rank,
               local_regions, no_effect and build and run seconds, the
               sites' bytes the record's (Mamba2-780M's train cell among
               them: the tied embedding's two gradients; Qwen3-MoE's
               train cell on two pods, which must fit and read at most
               MOE_TRAIN_POD_RATIO of one pod's temp,
               MOE_TRAIN_SINGLE_TEMP). The Qwen3-8B, Qwen3-MoE and
               Mamba2 train cells and the five decode cells (Jamba,
               Mamba2 and Mixtral long_500k, one row over 16 data ranks;
               Qwen3-8B and Qwen3-MoE decode_32k) (DRYRUN_SITE_CELLS)
               print their collectives by site, pass no shard between
               tensor dims (no all-to-all); Qwen3-8B's and Mamba2's train
               cells and the decode cells on one pod read torch 2.13's
               bytes by kind (DRYRUN_2_13) within DRYRUN_RELEASE_TOL; each
               decode cell's wire and temp bytes at most JAX's record
               (DRYRUN_JAX_DECODE), each train and prefill cell's temp
               (DRYRUN_JAX_TEMP); each train cell's live bytes at the peak
               by the line that made them printed; no train
               cell on two pods moves more than a scalar over one data dim
               alone. No kernel launches; the phase within
               DRYRUN_PHASE_S;
  6g. examples — the port's five examples (examples/torch_*.py) at their
               defaults through their main(), artifacts and checkpoints
               in a temporary directory, each counted (its launches are
               the main path's): quickstart (three-way bit-exact
               agreement), train_ttfs_mnist at full scale (702 steps,
               EXAMPLE_AGREEMENT / EXAMPLE_AGREEMENT agreement, 0
               repeatability mismatches), serve_lm, train_lm and
               elastic_restart (the resumed run bit-identical); any
               failure fails the run;
  7. times   — per kernel at the serving shape: its device time alone (CUDA
               events around 20 back-to-back launches queued behind a spin
               kernel, so no host dispatch falls between them; median of 50
               such samples), the wrapper's host time per call, the time of
               one wrapper call as a caller pays it, its plain version's time
               (CUDA events around one call, median of 50), the device time
               of the one PyTorch call that computes the same function where
               there is one (torch._int_mm for spike_matmul, F.embedding_bag
               (mode "sum", padding_idx n_in, float32 weights with a zero
               row, ids remapped: exact while 127 * E_max < 2**24) for
               event_accum, scaled_dot_product_attention for attention), and
               the least time the card
               could take for the same work (bound), beside the launch floor
               (a trivial kernel, zero_ on 64 int32, timed the same way);
               then kernels 1 and 2 at a chunk of T and of 8 steps, in turns
               (both take the longest chunk that fits), and on the serving
               batch's events with random weights of N_pad 4096, 8192 and
               32,768 (one block, clusters of 2 and of 8). The tensor-core kernel
               is timed at (B 1, Hq 32, Hkv 8, S 4096, D 128, causal, bf16),
               and once more at S 32,768 (fewer samples, no plain version:
               its scores would take 137 GB) and at the prefill's own
               (B 2, the model's views), beside SDPA; the split-TF32 kernel
               at (B 1, S 4096) in float32, its bound the lesser of the CUDA
               cores' (67 TFLOP/s) and split TF32's (three TF32 products a
               multiply-add at 495 TFLOP/s), and in bf16 with a d stride of
               2 (the element loads), beside SDPA; and at phase 6c's shapes:
               Whisper's encoder and cross-attention and InternVL's prefill
               on the tensor-core kernel, Whisper's decode cross-attention
               in float32 on the split-TF32 one, each beside the plain
               version, SDPA (non-causal where the model's is) and its
               bound (all Sq x Skv pairs where nothing is masked). The
               backward kernel at Yi-6B's training shape in float32, on the
               forward's statistic computed outside the timing, beside its
               plain version, autograd through SDPA's backward (the library
               call) and its bound (five products over the causal pairs at
               kernel 8b's float32 rate; q, k, v, out, the statistic and
               dout read once, dq, dk and dv written once); then in turns
               with the design it replaced (BWD_BASELINE, built in phase 1;
               new, baseline, baseline, new), which it must beat.

The last lines are a ``kernels`` summary, one JSON object with every
kernel's numbers, the card's name and power limit, and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import hashlib
import io
import json
import math
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
ASSETS = os.path.join(SRC, "repro_torch", "assets")
GOLDEN = os.path.join(ROOT, "tests", "golden")
CSRC = "src/repro_torch/csrc"
PALLAS = "src/repro/kernels"
#: kernel -> (its CUDA source, the Pallas kernel it replaces; the backward
#: replaces none: it stands where JAX differentiates its jnp chunked_attention)
KERNELS = {
    "fused_event_lif_decode": ("fused_event_lif.cu",
                               f"{PALLAS}/fused_event_lif/kernel.py:158"),
    "fused_event_lif_early_exit": ("fused_event_lif.cu",
                                   f"{PALLAS}/fused_event_lif/kernel.py:227"),
    "fused_event_lif": ("fused_event_lif.cu",
                        f"{PALLAS}/fused_event_lif/kernel.py:85"),
    "spike_matmul": ("spike_matmul.cu",
                     f"{PALLAS}/spike_matmul/kernel.py:37"),
    "lif_fused": ("lif.cu", f"{PALLAS}/lif/kernel.py:45"),
    "ttfs_decode": ("ttfs_decode.cu", f"{PALLAS}/ttfs_decode/kernel.py:42"),
    "event_accum": ("event_accum.cu", f"{PALLAS}/event_accum/kernel.py:42"),
    "flash_attention_sm90": ("flash_attention_sm90.cu",
                             f"{PALLAS}/flash_attention/kernel.py:86"),
    "flash_attention": ("flash_attention.cu",
                        f"{PALLAS}/flash_attention/kernel.py:86"),
    "flash_attention_bwd": ("flash_attention_bwd.cu",
                            "src/repro/models/layers.py:57"),
}
#: NVIDIA H100 SXM peaks (data sheet): HBM bytes/s; the 67 T/s float32 rate
#: outside the tensor cores, against which the kernels' integer ALU
#: operations are counted (the card's int32 rate is lower: an SM has half as
#: many INT32 lanes as FP32 lanes, so the bound computed here is below the
#: true one and never flatters a kernel); the tensor cores' int8 rate, for
#: the integer matrix product
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
#: the tensor cores' dense bf16 and TF32 rates and the CUDA cores' float32
#: rate, against which attention's floating-point operations are counted
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
#: the least time float32 attention can take: on the CUDA cores, or on the
#: tensor cores in split TF32 (three TF32 products a multiply-add), whichever
#: is faster
SPLIT_TF32_FLOPS = max(FP32_FLOPS, TF32_FLOPS / 3)
SERVE_BATCH = 64
#: the launcher's SNN request stream (repro_torch.launch.serve.serve_snn),
#: whose JAX reference labels src/repro_torch/assets/transport_expected.npz
#: holds
SERVE_REQUESTS = 10_000
#: clean loopback fetches of the MNIST envelope, timed one by one
FETCH_SAMPLES = 200
#: the board's per-image trace fields and outputs that
#: src/repro_torch/assets/mnist_board_expected.npz holds digests of
BOARD_TRACE = ("cycles", "events", "stalls", "ticks", "energy_nj")
BOARD_OUTPUTS = ("labels", "steps", "first_spike", "v_final")
TIMING_RUNS = 50
BACK_TO_BACK = 20
#: cycles the spin kernel holds the stream while launches are queued behind it
SPIN_CYCLES = 20_000_000
#: flash attention against its plain version: B, Hq, Hkv, Sq, Skv, D, causal,
#: window, q_offset, kv_len, and the layout of q, k and v ("contiguous"
#: (B, H, S, D); "movedim view": drawn (B, S, H, D) as the model's
#: projections are and handed over as (B, H, S, D) views; "decode cross": q
#: such a view, k and v contiguous, as a decode step's cross-attention reads
#: a slice of the cache's xk, xv)
ATTN_CASES = {
    "sweep-1": (1, 4, 4, 128, 128, 64, True, None, 0, None, "contiguous"),
    "sweep-2 gqa+offset": (2, 8, 2, 128, 256, 64, True, None, 128, None,
                           "contiguous"),
    "sweep-3 window": (1, 4, 1, 256, 256, 128, True, 64, 0, None,
                       "contiguous"),
    "sweep-4 cross": (1, 2, 2, 128, 384, 64, False, None, 0, None,
                      "contiguous"),
    "sweep-5 short q": (2, 4, 4, 8, 128, 64, True, None, 120, None,
                        "contiguous"),
    "ragged": (1, 4, 2, 100, 200, 128, True, None, 100, None, "movedim view"),
    "group8 kv_len": (2, 8, 1, 96, 320, 128, True, None, 224, 250,
                      "contiguous"),
    "window 3 tiles": (1, 4, 2, 512, 512, 128, True, 150, 0, None,
                       "contiguous"),
    "no visible key": (1, 4, 2, 8, 8, 128, True, 2, 20, None, "contiguous"),
    "cross D128": (1, 2, 2, 128, 384, 128, False, None, 0, None,
                   "contiguous"),
    "ragged 1111": (2, 32, 8, 1111, 1111, 128, True, None, 0, None,
                    "movedim view"),
    "qwen3-8b heads": (1, 32, 8, 2048, 2048, 128, True, None, 0, None,
                       "movedim view"),
    "qwen3-8b prefill": (2, 32, 8, 4096, 4096, 128, True, None, 0, None,
                         "movedim view"),
    "mixtral window": (1, 32, 8, 8192, 8192, 128, True, 4096, 0, None,
                       "movedim view"),
    "qwen3-moe heads": (2, 64, 4, 4096, 4096, 128, True, None, 0, None,
                        "movedim view"),
    "whisper encoder": (16, 6, 6, 1500, 1500, 64, False, None, 0, None,
                        "movedim view"),
    "whisper cross": (16, 6, 6, 448, 1500, 64, False, None, 0, None,
                      "movedim view"),
    "whisper decode cross": (8, 6, 6, 1, 1500, 64, False, None, 0, None,
                             "decode cross"),
    "internvl heads": (2, 48, 8, 4096, 4096, 128, True, None, 0, None,
                       "movedim view"),
}
#: inputs the tensor-core kernel does not take, which go to the split-TF32
#: kernel in both types: the sweep at D 16 and D 256, and D 128 q, k and v
#: that no TMA map describes (a row stride of D + 1 elements, data one element
#: past a 16-byte boundary, a d stride of 2), which the split-TF32 kernel
#: reads by element loads, not bulk copies
ATTN_SPLIT_TF32_CASES = {
    **{f"{case} D{D}": (*ATTN_CASES[case][:5], D, *ATTN_CASES[case][6:])
       for case in ATTN_CASES if case.startswith("sweep") for D in (16, 256)},
    "padded row D128": (2, 8, 1, 96, 320, 128, True, None, 224, 250,
                        "padded row"),
    "misaligned D128": (1, 4, 2, 100, 200, 128, True, None, 100, None,
                        "misaligned storage_offset"),
    "d stride 2 D128": (1, 4, 2, 512, 512, 128, True, 150, 0, None,
                        "d stride 2"),
}
#: the tolerance of each input type (tests/test_kernels.py's), element by
#: element (atol = rtol), and the kernel each takes at ATTN_CASES' shapes:
#: bf16 goes to the bf16 tensor-core kernel, float32 (whose tolerance rules
#: out single TF32) to the split-TF32 one
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_ROUTE = {"float32": "flash_attention",
              "bfloat16": "flash_attention_sm90"}
#: the limit of the relative error norm ||got - want|| / ||want|| of every
#: 128-row q tile of every head, where the elementwise tolerance is loose
#: against the outputs' size (|out| ~ sqrt(e / keys), 0.03 at 4096 keys).
#: Each case also prints what the same check reads for a planted fault, the
#: plain version with the last q tile's first visible key tile (128 keys)
#: skipped, and fails if the limit would not catch it.
ATTN_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: phase 5b, the backward kernel against flash_attention_bwd_ref: phase 5's
#: sweep, GQA 8 with kv_len < Skv, a window over several tiles, queries that
#: see no key, Whisper's training cross-attention (Sq 448 over 1,500 keys,
#: non-causal, D 64) and Yi-6B's training shape (B 4, 32/4 heads, S 2048,
#: D 128, causal), both as the model's (B, S, H, D) views; in both types
ATTN_BWD_CASES = {
    **{case: ATTN_CASES[case] for case in ATTN_CASES
       if case.startswith("sweep") or case in ("group8 kv_len",
                                               "window 3 tiles",
                                               "no visible key")},
    "whisper train cross": (4, 6, 6, 448, 1500, 64, False, None, 0, None,
                            "movedim view"),
    "yi-6b train": (4, 32, 4, 2048, 2048, 128, True, None, 0, None,
                    "movedim view"),
    # the tensor cores' DP-32 tiles, the CUDA-core route (D 256), and the
    # element loads (no 16-byte row alignment, a d stride of 2)
    **{case: ATTN_SPLIT_TF32_CASES[case]
       for case in ("sweep-2 gqa+offset D16", "sweep-3 window D256",
                    "sweep-4 cross D256", "misaligned D128",
                    "d stride 2 D128")},
}
#: its tolerances, element by element (atol = rtol), and the limit of the
#: relative error norm of each 128-row tile of dq, dk and dv. The kernel sums
#: in float32 on the CUDA cores, as the plain version's cuBLAS products do,
#: in another order: float32 at kernel 8's 2e-5 (an H100 read at most
#: 5.72e-6, dv at the training shape); bf16 at kernel 8's 2e-2 (both round
#: their float32 sums to bf16 once: at most one step, 7.81e-3 at |x| ~ 2)
ATTN_BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_BWD_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: the forward kernels' row statistic (return_lse=True) against the plain
#: version's, element by element (atol = rtol) on the rows that see a key:
#: float32 sums in both input types (a few ulps of |lse| <= 20 in log2
#: units); +inf rows must be +inf on both sides
ATTN_LSE_TOL = 1e-5
#: phase 5b's planted fault of the statistic: the last 128-row q tile's
#: lse shifted by this much (log2 units), read by the backward's own check.
#: A shift s scales those rows' P by 2^-s: 1e-3 is a 6.9e-4 relative error,
#: far above float32's limit but under bf16's 1e-2, where 0.1 (6.7 %) is
#: planted instead
ATTN_LSE_FAULT = {"float32": 1e-3, "bfloat16": 0.1}
#: the backward this kernel replaced (two walks of the keys in pass 1, 32 x
#: 32 tiles on the CUDA cores), kept as its source for phase 7 to build and
#: time in the same call
BWD_BASELINE = os.path.join(ROOT, "scripts", "baselines",
                            "flash_attention_bwd_two_walks.cu")
LM_ARCH = "qwen3-8b"
PREFILL_B, PREFILL_S = 2, 4096
#: the bf16 model on the kernel against the same model on the plain
#: attention: its max |logit| difference may be at most this many times the
#: difference between two other correct attentions on the same model, the
#: plain version and SDPA. Both kernels accumulate in f32 and round their
#: bf16 outputs once; where a value lies near a rounding boundary they round
#: it apart by one step, and 36 layers carry those steps to the logits, so
#: the floor is measured on this run's model rather than fixed (a first
#: fixed bound of 0.25, eight bf16 steps at |logit| in [4, 8), was exceeded
#: at 0.297 on an H100 with the same greedy tokens).
PREFILL_FLOOR_FACTOR = 2.0
#: the forward against token-by-token decode, float32 (tests/test_models.py)
DECODE_TOL = 2e-3
#: phase 6b, the MoE models' bf16 prefill at full width, depth cut to fit one
#: 80 GB card: arch -> (layers, batch rows, tokens a row). Mixtral's 32
#: layers take 93.4 GB in bf16, 16 take 46.9 (its 8,192 tokens are twice its
#: window, so the window masks); Qwen3-MoE's 94 take 470, 8 take 42.3.
MOE_PREFILL = {"mixtral-8x7b": (16, 1, 8192),
               "qwen3-moe-235b-a22b": (8, 2, 4096)}
#: Mamba2-780M, whole (48 layers, 1.6 GB in bf16): prefill batch and tokens
SSM_ARCH, SSM_PREFILL = "mamba2-780m", (2, 4096)
#: the float32 forward against token-by-token decode (DECODE_TOL): layers
#: of full width for each family, on 2 x F32_TOKENS tokens; the MoE models
#: run it on a copy of their config at a drop-free capacity factor (at S 1
#: decode drops nothing, the forward at the served factor 1.0 does)
MOE_F32_LAYERS, SSM_F32_LAYERS, F32_TOKENS = 2, 4, 256
#: a bf16 MoE sublayer against moe_ffn_dense_oracle on its own inputs at a
#: drop-free capacity, one batch row at a time: the relative error norm
#: ||got - want|| / ||want|| of the row's output, and each token's error
#: norm over the row's mean token norm (a token routed to another expert
#: reads about 1). Not element by element: moe_ffn rounds each weighted
#: expert output to bf16 before the sum over k, as JAX's does, and the
#: oracle sums in float32, so two outputs of 8-16 that cancel differ by a
#: bf16 step of theirs (0.0625 on an H100 at Mixtral's full width)
MOE_BF16_REL_TOL, MOE_BF16_TOKEN_TOL = 1e-2, 5e-2
#: the card's float32 moe_ffn against JAX's (src/repro_torch/assets/
#: moe_expected.npz): routing exact, output and aux within these
MOE_ASSET_TOL, MOE_AUX_TOL = 1e-5, 1e-6
#: ssd_chunked against ssd_naive_ref on a full-width layer's own float32
#: inputs (JAX's bound, tests/test_models.py::test_ssd_chunked_vs_naive)
SSD_TOL = 1e-4
#: phase 6c: Whisper-tiny and InternVL2-26B whole, their bf16 prefill's
#: batch rows and decoder tokens (Whisper's encoder takes cross_len 1,500
#: frames a row; InternVL's first n_patches 256 positions are patches)
WHISPER_ARCH, WHISPER_PREFILL = "whisper-tiny", (16, 448)
VLM_ARCH, VLM_PREFILL = "internvl2-26b", (2, 4096)
#: InternVL's float32 forward against decode and ServeEngine: layers of
#: full width (its 48 would take 79 GB in float32)
VLM_F32_LAYERS = 2
#: the card's float32 whisper-tiny against JAX's
#: (src/repro_torch/assets/whisper_expected.npz): encoder rows and logits
WHISPER_ASSET_TOL = 1e-4
#: phase 6d, training on the card: Yi-6B at full width in float32 (AdamW,
#: remat as configured), TRAIN_LAYERS of its 32 layers (1.91 B parameters,
#: 30.5 GB with AdamW's moments and the gradients; all 32 would take about
#: 97 GB), TRAIN_STEPS steps of TRAIN_B x TRAIN_S tokens through the
#: launcher's Trainer; Whisper-tiny whole, WHISPER_TRAIN (batch rows,
#: decoder tokens, steps) over 1,500 frames a row, resumed from a
#: checkpoint after step 2
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_STEPS = "yi-6b", 8, 5
TRAIN_B, TRAIN_S = 4, 2048
WHISPER_TRAIN = (4, 448, 3)
#: the largest relative error norm ||g - g_plain|| / ||g_plain|| of any of
#: JAX's leaves between Yi-6B's gradients with attention's backward on the
#: kernel and on its plain version (same parameters, same batch; an H100
#: read 1.31e-6)
TRAIN_GRAD_REL_TOL = 1e-5
#: the card's training of the reduced Yi-6B against JAX's
#: (src/repro_torch/assets/lm_train_expected.npz): losses and gradient norms
#: relative, parameters element by element (atol = rtol)
TRAIN_ASSET_TOL, TRAIN_PARAM_TOL = 1e-5, 1e-4
#: phase 6e, distribution and analysis: Qwen3-MoE's MoE sublayer at full
#: width (E 128, top-8, d 4096, f 1536, capacity factor 1.0) on DIST_TOKENS
#: (batch rows, tokens a row) drawn from DIST_SEED, and its LM at
#: DIST_LM_LAYERS layers of full width; the two gloo ranks on the card must
#: both end within DIST_SPAWN_S seconds
DIST_ARCH, DIST_TOKENS, DIST_SEED = "qwen3-moe-235b-a22b", (2, 4096), 27
DIST_LM_LAYERS, DIST_SPAWN_S = 2, 300
#: phase 6f, the dry-run: the full-width cells on the production meshes
#: (arch, shape, multi-pod, variant), and the phase's time limit
DRYRUN_CELLS = (("qwen3-8b", "train_4k", False, "baseline"),
                ("qwen3-moe-235b-a22b", "prefill_32k", True, "moe_shmap"),
                ("mamba2-780m", "train_4k", False, "baseline"),
                ("qwen3-moe-235b-a22b", "train_4k", True, "baseline"),
                ("qwen3-8b", "train_4k", True, "baseline"),
                ("qwen3-moe-235b-a22b", "train_4k", False, "baseline"),
                ("jamba-1.5-large-398b", "long_500k", False, "baseline"),
                ("mamba2-780m", "long_500k", False, "baseline"),
                ("mixtral-8x7b", "long_500k", False, "baseline"),
                ("qwen3-8b", "decode_32k", False, "baseline"),
                ("qwen3-moe-235b-a22b", "decode_32k", False, "baseline"))
DRYRUN_PHASE_S = 180
#: the cells whose collectives phase 6f prints by call site
#: (tests/_torch_dryrun_fake.py's tagging: kind, mesh dims, site,
#: direction)
DRYRUN_SITE_CELLS = (("qwen3-8b", "train_4k"),
                     ("qwen3-moe-235b-a22b", "train_4k"),
                     ("mamba2-780m", "train_4k"),
                     ("jamba-1.5-large-398b", "long_500k"),
                     ("mamba2-780m", "long_500k"),
                     ("mixtral-8x7b", "long_500k"),
                     ("qwen3-8b", "decode_32k"),
                     ("qwen3-moe-235b-a22b", "decode_32k"))
#: (arch, shape, mesh) -> per-rank collectives by kind, [calls, bytes], on
#: torch 2.13 (a CPU build, the fake group on "cpu"; `python
#: tests/_torch_dryrun_fake.py OUT sites ARCH SHAPE MESH baseline cpu`);
#: the card's torch must read the same calls and bytes by kind within
#: DRYRUN_RELEASE_TOL: the record does not move with torch
DRYRUN_2_13 = {
    ("qwen3-8b", "train_4k", "single"): {
        "all-gather": [1229, 138_899_009_536],
        "all-reduce": [442, 24_754_059_280],
        "reduce-scatter": [471, 5_231_370_816]},
    ("mamba2-780m", "train_4k", "single"): {
        "all-gather": [1541, 188_991_719_424],
        "all-reduce": [726, 1_688_281_680],
        "reduce-scatter": [193, 1_223_096_832]},
    ("jamba-1.5-large-398b", "long_500k", "single"): {
        "all-gather": [198, 7_211_520],
        "all-reduce": [660, 104_486_656],
        "collective-permute": [144, 147_456]},
    ("mamba2-780m", "long_500k", "single"): {
        "all-gather": [102, 987_840],
        "all-reduce": [194, 148_852],
        "collective-permute": [48, 9_216]},
    ("mixtral-8x7b", "long_500k", "single"): {
        "all-gather": [130, 688_128],
        "all-reduce": [451, 8_492_708],
        "collective-permute": [64, 32_768]},
    ("qwen3-8b", "decode_32k", "single"): {
        "all-gather": [507, 169_036_288],
        "all-reduce": [109, 1_212_743_680],
        "reduce-scatter": [181, 1_257_856]},
    ("qwen3-moe-235b-a22b", "decode_32k", "single"): {
        "all-gather": [1225, 436_452_864],
        "all-reduce": [565, 11_057_954_816],
        "reduce-scatter": [283, 1_018_240]}}
DRYRUN_RELEASE_TOL = 1e-3
#: (arch, shape, mesh) -> JAX's record of a decode cell, per rank: (wire
#: bytes, temp bytes), read on this repo's CPU (`PYTHONPATH=src
#: JAX_PLATFORMS=cpu python -c "from repro.launch import dryrun as D;
#: D.run_cell(ARCH, SHAPE, False, OUT)"`: coll_bytes and memory_analysis'
#: temp_size_in_bytes); the port's decode step, which keeps every weight in
#: its stored shard, must read at most these
DRYRUN_JAX_DECODE = {
    ("jamba-1.5-large-398b", "long_500k", "single"):
        (1_424_375_424, 7_159_086_272),
    ("mamba2-780m", "long_500k", "single"): (1_305_224, 16_098_688),
    ("mixtral-8x7b", "long_500k", "single"): (220_953_736, 754_127_024),
    ("qwen3-8b", "decode_32k", "single"): (41_935_244_768, 6_547_305_688),
    ("qwen3-moe-235b-a22b", "decode_32k", "single"):
        (124_238_809_120, 11_829_113_600)}
#: (arch, shape, mesh, variant) -> JAX's record of phase 6f's train and
#: prefill cells: per-rank temp bytes (memory_analysis'
#: temp_size_in_bytes), read on this repo's CPU (`PYTHONPATH=src
#: JAX_PLATFORMS=cpu python -c "from repro.launch import dryrun as D;
#: D.run_cell(ARCH, SHAPE, MULTI, OUT, variant=VARIANT)"`); the port's
#: temp must read at most these, as its residual stream between sublayers
#: keeps d over "model" where the remat saves it, as JAX's scan carry
#: does (none of these cells is among ROADMAP §3's divergences kept above
#: JAX's temp)
DRYRUN_JAX_TEMP = {
    ("qwen3-8b", "train_4k", "single", "baseline"): 15_480_133_216,
    ("qwen3-moe-235b-a22b", "prefill_32k", "multi", "moe_shmap"):
        7_218_007_632,
    ("mamba2-780m", "train_4k", "single", "baseline"): 54_025_158_688,
    ("qwen3-moe-235b-a22b", "train_4k", "multi", "baseline"):
        563_434_491_480,
    ("qwen3-8b", "train_4k", "multi", "baseline"): 7_837_980_512,
    ("qwen3-moe-235b-a22b", "train_4k", "single", "baseline"):
        577_374_858_008}
#: the rows of a DRYRUN_SITE_CELLS cell printed, largest bytes first; and
#: of a train cell's live bytes at the peak by the line that made them
DRYRUN_SITE_ROWS = 16
DRYRUN_PEAK_ROWS = 8
#: Qwen3-MoE's train_4k cell on one pod (256 ranks): its per-rank temp
#: bytes on torch 2.13 (`python tests/_torch_dryrun_fake.py OUT sites
#: qwen3-moe-235b-a22b train_4k single baseline cpu`; the card's 2.11
#: reads the same, PERF.md §6); the same cell on two pods (512 ranks)
#: must fit and read at most
#: MOE_TRAIN_POD_RATIO of it, as each rank holds half the rows
MOE_TRAIN_SINGLE_TEMP = 28_887_851_900
MOE_TRAIN_POD_RATIO = 0.6
#: phase 6g, the port's examples (``examples/torch_*.py``) at their
#: defaults, each run through its ``main``; the paths (artifacts,
#: checkpoints) go under a temporary directory
EXAMPLES = ("torch_quickstart", "torch_train_ttfs_mnist", "torch_serve_lm",
            "torch_train_lm", "torch_elastic_restart")
#: the images the main experiment holds the reference and the three
#: runtimes to, label for label and spike for spike
EXAMPLE_AGREEMENT = 10_000
#: a measured prefill wall below this share of its roofline's step_s fails
#: the record or the count (the roofline is the least time the work takes)
ROOFLINE_FLOOR = 0.95
#: the H100 record's HBM size against the card's own total memory
HBM_RECORD_TOL = 0.10
ATTN_TIME_S = (4096, 32768)
#: samples and back-to-back launches of attention's times at S = 4096, whose
#: launches take up to milliseconds, not microseconds
FEW_SAMPLES = (10, 5)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def is_gemm(kernel: str) -> bool:
    return any(s in kernel.lower()
               for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass"))


def is_flash_forward(kernel: str) -> bool:
    """A launch of a forward flash kernel: ``flash_sm90_kernel`` (8a) or
    ``flash_tf32_kernel`` (8b)."""
    return "flash_sm90_kernel" in kernel or "flash_tf32_kernel" in kernel


def group_of(kernel: str) -> str:
    if "flash_sm90_kernel" in kernel:
        return "flash_attention_sm90 (csrc/flash_attention_sm90.cu)"
    if "flash_tf32_kernel" in kernel:
        return "flash_attention (csrc/flash_attention.cu)"
    if is_gemm(kernel):
        return "matrix products (cuBLAS)"
    return "other (norms, RoPE, SiLU, casts, embedding, softmax, copies)"


#: the record_function ranges phases 6b and 6c profile their prefills
#: under; the profiler also shows each as a device-side span, which is not a
#: kernel
PROFILE_RANGES = ("moe_ffn", "ssd_chunked", "flash_attention", "encode",
                  "cross_attention", "lm_head", "optimizer")


def family_group(kernel: str, ranges: list[str]) -> str:
    """The group of a kernel of phase 6b's prefills, from its name and the
    names of the ops and ``record_function`` ranges it ran under
    (``moe_ffn``, ``ssd_chunked``)."""
    if is_flash_forward(kernel):
        return "attention (flash_attention kernels)"
    if "ssd_chunked" in ranges:
        return "SSD (ssd_chunked: products, masks, exps, the recurrence)"
    if "moe_ffn" in ranges:
        return ("expert products (and the router's)" if is_gemm(kernel)
                else "MoE dispatch / combine glue (softmax, sort, cumsum, "
                     "scatter, gather)")
    if is_gemm(kernel):
        return "other matrix products (projections, LM head)"
    return "other (norms, RoPE, conv, SiLU, casts, embedding)"


def ranged(name: str, fn):
    """``fn`` run under a ``record_function`` range named ``name``."""
    import torch

    def run(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return run


def frontend_group(kernel: str, ranges: list[str]) -> str:
    """The group of a kernel of phase 6c's prefills, from its name and the
    ``record_function`` ranges it ran under (``encode``,
    ``cross_attention``, ``lm_head``)."""
    if is_flash_forward(kernel):
        return "attention (flash_attention kernels)"
    gemm = is_gemm(kernel)
    if "lm_head" in ranges:
        return ("LM head product (d x V)" if gemm
                else "LM head glue (final norm, casts)")
    if "encode" in ranges:
        return ("encoder products (projections, FFN)" if gemm
                else "encoder glue (sinusoid, norms, GELU, casts)")
    if "cross_attention" in ranges:
        return ("cross-attention products (x_wq, x_wk, x_wv, x_wo)" if gemm
                else "cross-attention glue (norm, casts)")
    return ("decoder products (projections, FFN)" if gemm
            else "decoder glue (embedding, splice, norms, RoPE, activations, "
                 "casts)")


#: phase 6d's profile group of the backward's kernels, whose names all hold
#: "flash_bwd_" (flash_bwd_dq_tf32_kernel, flash_bwd_dkdv_tf32_kernel and
#: the CUDA-core route's *_simt_kernel); the phase fails if it reads 0
BWD_GROUP = "attention backward (flash_attention_bwd)"


def train_group(kernel: str, ranges: list[str]) -> str:
    """The group of a kernel of phase 6d's training step, from its name and
    the ranges it ran under: the autograd engine's (the backward, and the
    forward remat recomputes inside it) or ``optimizer``."""
    if "flash_bwd_" in kernel:
        return BWD_GROUP
    if is_flash_forward(kernel):
        return "attention forward (flash_attention; remat runs it twice)"
    if "optimizer" in ranges:
        return "optimiser (AdamW in place, a period at a time)"
    backward = any(r.startswith("autograd::engine::evaluate_function")
                   for r in ranges)
    if is_gemm(kernel):
        return ("backward products (and remat's recomputed forward "
                "products)" if backward else "forward products")
    return ("other, backward (elementwise, reductions, remat's recomputed "
            "glue)" if backward else "other, forward (embedding, norms, "
            "RoPE, SiLU, loss, casts)")


def profile(fn, grouper=None) -> dict:
    """Device time by kernel over one call of ``fn`` under torch.profiler,
    and the device's busy share of the window (kernel time over wall).
    ``grouper(kernel, ranges)`` groups each kernel by its name and the op
    and range names it ran under (``family_group``); without it, by name
    alone (``group_of``). ``covered`` is the share of the device time tied
    to the op that launched it (above 1 if the profiler tied a kernel to
    two ops)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for ev in prof.key_averages():     # the device's own events only
        if ev.device_type != DeviceType.CUDA or ev.key in PROFILE_RANGES:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
    groups: dict[str, float] = {}
    tied: dict[str, float] = {}        # kernel name -> ms tied to an op
    if grouper is None:
        for name, ms in kernels.items():
            groups[group_of(name)] = groups.get(group_of(name), 0.0) + ms
    else:
        # each kernel under the op that launched it (its ``kernels``), an
        # op counted once by its correlation id; the rest (the kernels'
        # ctypes launches, under no op) by name alone
        seen = set()
        for ev in prof.events():
            launched = [k for k in getattr(ev, "kernels", ())
                        if k.name not in PROFILE_RANGES]
            if ev.device_type != DeviceType.CPU or not launched \
                    or ev.id in seen:
                continue
            seen.add(ev.id)
            ranges, up = [], ev
            while up is not None:
                ranges.append(up.name)
                up = up.cpu_parent
            for kern in launched:
                g = grouper(kern.name, ranges)
                groups[g] = groups.get(g, 0.0) + kern.duration / 1e3
                tied[kern.name] = tied.get(kern.name, 0.0) \
                    + kern.duration / 1e3
        for name, ms in kernels.items():
            rest = ms - tied.get(name, 0.0)
            if rest > 0:
                g = grouper(name, [])
                groups[g] = groups.get(g, 0.0) + rest
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "busy_share": busy / wall_ms, "groups_ms": groups,
            "covered": sum(tied.values()) / busy if busy else 0.0,
            "top_ms": dict(top), "kernels_ms": kernels}


def show_profile(what: str, prof: dict, card: str) -> None:
    check(prof["device_ms"] > 0, f"the profiler saw no device time in the "
          f"{what}")
    print(f"[profile] {what}: wall {prof['wall_ms']:.1f} ms, device "
          f"{prof['device_ms']:.1f} ms, busy share {prof['busy_share']:.3f} — "
          f"card: {card}")
    for g, ms in sorted(prof["groups_ms"].items(), key=lambda kv: -kv[1]):
        print(f"[profile] {what}   {ms:9.2f} ms  {g}")
    for name, ms in prof["top_ms"].items():
        print(f"[profile] {what}     {ms:9.2f} ms  {name[:100]}")


def ptxas_entries(log: str) -> dict:
    """kernel (mangled name) -> what ptxas reported on it in a build log
    (``-Xptxas -v``: spills, registers, shared memory)."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        name, _, rest = part.partition("'")
        out[name] = rest
    return out


def sass_opcode(line: str) -> str:
    """The opcode of a line of ``cuobjdump -sass`` ("/*0f80*/  @P0 HGMMA...
    ;" -> "HGMMA..."), or "" for a line that holds none."""
    m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                 r"([A-Z][A-Z0-9_.]*)", line)
    return m.group(1) if m else ""


def sha256(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def max_abs_err(got, want) -> int:
    """Largest |got - want| over tensors paired in order (0 if all empty)."""
    return max((int((g.long() - w.long()).abs().max()) if g.numel() else 0
                for g, w in zip(got, want)), default=0)


def draw_whisper(lm, meta: dict):
    """(frames (B, frames, d) float32, tokens (B, tokens) int32), numpy, of
    a src/repro_torch/assets/whisper_expected.npz recipe, with ``lm``'s
    parameters redrawn in place: the exporter's draw
    (scripts/export_torch_fixture.py::draw_whisper_case) in the port's
    layout, from ``RandomState(seed)`` in its order (the frames, the tokens,
    the top-level leaves by name, each encoder layer's, each decoder
    layer's)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(meta["seed"])
    cfg = lm.cfg
    frames = rng.randn(meta["B"], meta["frames"], cfg.d_model).astype(
        np.float32)
    tokens = rng.randint(0, cfg.vocab, (meta["B"], meta["tokens"])).astype(
        np.int32)
    groups = [lm.top] + [blk["0:attn"] for blk in lm.encoder] + \
        [blk["0:attn"] for blk in lm.layers]
    with torch.no_grad():
        for params in groups:
            for name in sorted(params):
                w = params[name]
                x = rng.randn(*w.shape)
                x = (1.0 + meta["norm_scale"] * x if name in meta["norms"]
                     else meta["scale"] * x)
                w.copy_(torch.from_numpy(x.astype(np.float32)))
    return frames, tokens


def draw_lm_train(lm, meta: dict) -> None:
    """``lm``'s parameters redrawn in place from a src/repro_torch/assets/
    lm_train_expected.npz recipe: the exporter's draw
    (scripts/export_torch_fixture.py::draw_lm_train_case), each of JAX's
    leaves drawn whole from ``RandomState(seed)`` in JAX's flatten order
    (``leaf_groups``) and written into the leaf, which holds the port's
    per-period tensors."""
    import numpy as np
    import torch
    from repro_torch.models.convert import leaf_groups
    rng = np.random.RandomState(meta["seed"])
    for g in leaf_groups(lm):
        w = rng.randn(*g.leaf.shape)
        w = (1.0 + meta["norm_scale"] * w
             if g.path.split("/")[-1] in meta["norms"] else meta["scale"] * w)
        with torch.no_grad():
            g.leaf.copy_(torch.from_numpy(w.astype(np.float32)))


def moe_inputs(job: dict, dtype, dev):
    """Phase 6e's MoE sublayer: x (B, S, d) and the weights, drawn on ``dev``
    from ``job["seed"]`` in float32 (x, router, w_gate, w_up, w_down, each
    normal times 0.02 but x) and cast to ``dtype``; the router stays
    float32, as the model holds it."""
    import torch
    d, E, f = job["d"], job["E"], job["f"]
    g = torch.Generator(dev).manual_seed(job["seed"])

    def draw(shape, scale=0.02):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32) * scale

    x = draw((job["B"], job["S"], d), 1.0).to(dtype)
    p = {"router": draw((d, E))}
    for name, shape in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                        ("w_down", (E, f, d))):
        p[name] = draw(shape).to(dtype)
    return x, p


def moe_rank(argv: list[str]) -> int:
    """One rank of phase 6e's gloo run (``chip_smoke.py --moe-rank DIR RANK
    WORLD``): it joins a gloo group of WORLD ranks through a file in DIR,
    builds the mesh ``DIR/job.json`` names on its device type, draws the
    job's sublayer in float32 (TF32 off), runs moe_ffn on all of it, then
    sets every expert it does not own to NaN and runs moe_ffn_shard_map on
    the same rows; the routing of both, the output's difference and both
    walls go to ``DIR/rank{RANK}.json``."""
    rdv, rank, world = argv[0], int(argv[1]), int(argv[2])
    sys.path.insert(0, SRC)
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    with open(os.path.join(rdv, "job.json")) as fh:
        job = json.load(fh)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if job["device"] == "cuda" \
        else torch.device("cpu")
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(rdv, "gloo"),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = make_test_mesh(tuple(job["shape"]), ("data", "model"),
                              device_type=job["device"])

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize()

        def wall(fn, runs=3):
            samples = []
            for _ in range(runs):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                samples.append(1e3 * (time.perf_counter() - t0))
            return statistics.median(samples)

        E, k, cf = job["E"], job["k"], job["cf"]
        x, p = moe_inputs(job, torch.float32, dev)
        routes, real_route = [], moe.route

        def recorded(*args, **kw):
            r = real_route(*args, **kw)
            routes.append(r)
            return r

        kw = dict(n_experts=E, top_k=k, capacity_factor=cf)
        moe.route = recorded
        try:
            want, want_aux = moe.moe_ffn(x, p, **kw)
        finally:
            moe.route = real_route
        ffn_ms = wall(lambda: moe.moe_ffn(x, p, **kw))
        m = mesh.get_local_rank("model")
        E_loc = E // mesh.size(mesh.mesh_dim_names.index("model"))
        for name in ("w_gate", "w_up", "w_down"):
            p[name][:m * E_loc] = float("nan")
            p[name][(m + 1) * E_loc:] = float("nan")
        moe.route = recorded
        try:
            got, got_aux = moe.moe_ffn_shard_map(x, p, mesh=mesh, **kw)
        finally:
            moe.route = real_route
        sync()
        # the collectives of one more call, for phase 6f's fake count
        from repro_torch.launch import dryrun as DR
        rec = DR.Recorder()
        with DR.counting(rec) as cm:
            moe.moe_ffn_shard_map(x, p, mesh=mesh, **kw)
        sync()
        nan_experts = sum(int(torch.isnan(p["w_gate"][e]).all())
                          for e in range(E))
        res = {
            "rank": rank, "backend": dist.get_backend(),
            "device": str(got.device), "dtype": str(got.dtype),
            "tf32": torch.backends.cuda.matmul.allow_tf32,
            "model_rank": m, "experts": [m * E_loc, (m + 1) * E_loc],
            "nan_experts": nan_experts,
            "top_i_equal": torch.equal(routes[0].top_i, routes[1].top_i),
            "keep_equal": torch.equal(routes[0].keep, routes[1].keep),
            "drops": int((~routes[0].keep).sum()),
            "assignments": routes[0].keep.numel(),
            "finite": bool(torch.isfinite(got).all()),
            "max_abs_err": float((got - want).abs().max()),
            "max_abs_out": float(want.abs().max()),
            "aux": [float(got_aux), float(want_aux)],
            "shard_map_ms": wall(lambda: moe.moe_ffn_shard_map(
                x, p, mesh=mesh, **kw)),
            "moe_ffn_ms": ffn_ms,
            "comm_counts": DR.comm_counts(cm), "comms": rec.comms,
        }
        with open(os.path.join(rdv, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
        print(f"[dist] rank {rank}: {json.dumps(res, sort_keys=True)}")
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, SRC)

    import dataclasses

    import torch.nn.functional as F

    from repro_torch.board.energy import BoardTrace
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core.accelerator import SNNAccelerator
    from repro_torch.core.agreement import full_agreement, repeatability
    from repro_torch.core.artifact import Artifact
    from repro_torch.core.events import pack_events_batched
    from repro_torch.configs.mnist_ttfs import SNN_CONFIG
    from repro_torch.conformance import fuzz_case, run_case
    from repro_torch.conformance import golden as conformance_golden
    from repro_torch.core import deploy, quant, snn
    from repro_torch.core.lif_dynamics import lif_scan, lif_scan_early_exit_rows
    from repro_torch.core.lowering import lower
    from repro_torch.core.reference import SNNReference, spike_currents
    from repro_torch.core.runtimes import make_runtime
    from repro_torch.core.ttfs import encode_ttfs, frames_from_times
    from repro_torch.data import mnist
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.event_accum import ops as ea, ref as ea_ref
    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref
    from repro_torch.kernels.fused_event_lif import ops, ref
    from repro_torch.kernels.lif import ops as lif, ref as lif_ref
    from repro_torch.kernels.spike_matmul import ops as smm, ref as smm_ref
    from repro_torch.kernels.ttfs_decode import ops as dec, ref as dec_ref
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import ServingScheduler
    from repro_torch.serving.snn_engine import SNNServeEngine
    from repro_torch.training import ttfs_trainer
    from repro_torch.models.convert import leaf_groups
    from repro_torch.training.lm_step import make_prefill_step

    wrappers = (ops, ea, lif, smm, dec, fa)
    # the model's attention reaches the kernels through fa.flash_attention,
    # directly when serving and inside fa.FlashAttention when training: the
    # phases below stand a recorder, a range or another attention in for
    # it, and put this one back
    attention_kernel = fa.flash_attention

    def reset_launches() -> None:
        for w in wrappers:
            w.reset_launches()

    def launch_counts() -> dict:
        return {k: n for w in wrappers for k, n in w.LAUNCHES.items()}

    check(set(launch_counts()) == set(KERNELS),
          f"launch counters {sorted(launch_counts())} are not the kernels "
          f"{sorted(KERNELS)}")

    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")

    # ---------------------------------------------------------------- 1 build
    t0 = time.perf_counter()
    # the replaced backward (phase 7's baseline) compiles beside the sources
    baseline_lib = os.path.join(build.BUILD_DIR, "baseline",
                                "libflash_attention_bwd_two_walks.so")
    os.makedirs(os.path.dirname(baseline_lib), exist_ok=True)
    baseline_nvcc = subprocess.Popen(
        [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", baseline_lib, BWD_BASELINE],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build.build(build.sources())
    baseline_log, _ = baseline_nvcc.communicate()
    check(baseline_nvcc.returncode == 0, f"nvcc failed for the baseline "
          f"backward {BWD_BASELINE}:\n{baseline_log[-4000:]}")
    print(f"[build] {len(build.sources())} sources and the baseline "
          f"backward, nvcc wall {time.perf_counter() - t0:.2f} s")
    for log in build.build_logs.values():
        print(log.rstrip())
    # spike_matmul runs on the int8 tensor cores: its SASS holds int8
    # warpgroup MMAs; event_accum stages nothing in shared memory
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path("spike_matmul"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout.splitlines()
    igmma = [ln.strip() for ln in sass if "IGMMA" in ln and "S8.S8" in ln]
    check(len(igmma) > 0, "spike_matmul's SASS holds no int8 warpgroup MMA")
    print(f"[build] spike_matmul SASS: {len(igmma)} int8 warpgroup MMA "
          f"instructions, e.g. {igmma[0].split(';')[0]}")
    # the split-TF32 attention kernel multiplies on the tensor cores
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout.splitlines()
    hgmma = [ln.strip() for ln in sass if "HGMMA" in ln and "TF32" in ln]
    check(len(hgmma) > 0, "flash_attention's SASS holds no TF32 warpgroup "
          "MMA")
    print(f"[build] flash_attention SASS: {len(hgmma)} TF32 warpgroup MMA "
          f"instructions, e.g. {hgmma[0].split(';')[0]}")
    # the backward multiplies on the tensor cores too, and adds nothing
    # atomically (one writer an output element: two runs give the same bits)
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path("flash_attention_bwd"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout.splitlines()
    hgmma = [ln.strip() for ln in sass if "HGMMA" in ln and "TF32" in ln]
    check(len(hgmma) > 0, "flash_attention_bwd's SASS holds no TF32 "
          "warpgroup MMA")
    atomics = [ln.strip() for ln in sass if sass_opcode(ln).split(".")[0]
               in ("ATOM", "ATOMS", "ATOMG", "RED", "REDG", "REDS")]
    check(not atomics, f"flash_attention_bwd's SASS holds {len(atomics)} "
          f"atomic instructions, e.g. {atomics[:3]}")
    print(f"[build] flash_attention_bwd SASS: {len(hgmma)} TF32 warpgroup "
          f"MMA instructions, e.g. {hgmma[0].split(';')[0]}; 0 ATOM/RED")
    check(re.search(r"\d+ bytes smem", build.build_logs["event_accum"])
          is None, "an event_accum kernel holds shared memory")
    print("[build] event_accum's kernels: no shared memory (ptxas; the "
          "launch asks for no dynamic shared memory either)")
    # the staged LIF and decode kernels spill nothing, and the decode's
    # warp-per-row kernel holds no shared memory (no block barrier either)
    for src in ("lif", "ttfs_decode"):
        entries = ptxas_entries(build.build_logs[src])
        check(len(entries) > 0, f"no ptxas report for {src}")
        for name, report in entries.items():
            check(" 0 bytes spill stores, 0 bytes spill loads" in report,
                  f"{src}: {name} spills registers")
            used = re.search(r"Used \d+ registers[^\n]*", report)
            print(f"[build] {src}: {name}: no spills, "
                  f"{used.group(0) if used else 'no register report'}")
    warp_rows = [r for name, r in ptxas_entries(
        build.build_logs["ttfs_decode"]).items() if "warp_rows" in name]
    check(len(warp_rows) == 1 and "smem" not in warp_rows[0]
          and "used 0 barriers" in warp_rows[0],
          "ttfs_decode's warp-per-row kernel holds shared memory or a block "
          "barrier")
    print("[build] ttfs_decode's warp-per-row kernel: no shared memory, no "
          "block barrier (ptxas)")

    # ------------------------------------------------------------ fixtures
    art = Artifact.load(os.path.join(ASSETS, "mnist_ttfs.npz"))
    exp = np.load(os.path.join(ASSETS, "mnist_ttfs_expected.npz"))
    xte, yte = mnist.load("test")
    check(sha256(xte) == str(exp["images_sha256"]),
          "procedural MNIST test images differ from the exported ones")
    check(art.fingerprint() == str(exp["artifact_fingerprint"]),
          "MNIST artifact fingerprint differs from the JAX export")
    prog = lower(art, device=dev)
    check(prog.fingerprint == str(exp["program_fingerprint"]),
          "program fingerprint differs from the JAX package's")
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        manifest = json.load(f)
    fuzz = []
    for seed in manifest["seeds"]:
        with np.load(os.path.join(ASSETS, f"fuzz_seed{seed}.npz")) as z:
            fart = Artifact.load(io.BytesIO(z["artifact"].tobytes()))
            images = z["images"]
        golden = dict(np.load(os.path.join(GOLDEN,
                                           f"conformance_seed{seed}.npz")))
        fprog = lower(fart, device=dev)
        check(fprog.fingerprint == manifest["program_fingerprints"][str(seed)],
              f"fuzz seed {seed}: program fingerprint differs from golden")
        fuzz.append((seed, fart, fprog, images, golden))

    # ------------------------------------------------------- 2 kernels vs plain
    def host_times(p, images):
        return encode_ttfs(torch.from_numpy(np.asarray(images, np.float32)),
                           p.T, p.x_min).numpy()

    def kernel_args(p):
        return dict(T=p.T, e_max=p.e_max, leak_shift=p.leak_shift,
                    n_out=p.n_out, n_groups=p.n_groups,
                    per_group=p.per_group, fallback=p.fallback,
                    w=p.w_padded, thr=p.thr_padded)

    mnist_imgs = np.array(xte[:SERVE_BATCH])
    mnist_imgs[-1] = 0.0                          # an all-PAD row
    cases = [("mnist", kernel_args(prog), host_times(prog, mnist_imgs))]
    for seed, _, fprog, _, golden in fuzz:
        cases.append((f"fuzz{seed}", kernel_args(fprog), golden["times"]))
    # a 2,000-neuron layer (N_pad 2048: 512 threads x 4 lanes per thread)
    rng = np.random.RandomState(0)
    n_in, n_out, n_pad, T = 300, 2000, 2048, 16
    w = np.zeros((n_in, n_pad), np.int8)
    w[:, :n_out] = rng.randint(-127, 128, (n_in, n_out))
    thr = np.full((n_pad,), 2**31 - 1, np.int32)
    thr[:n_out] = rng.randint(50, 4000, n_out)
    cases.append(("wide", dict(T=T, e_max=64, leak_shift=3, n_out=n_out,
                               n_groups=16, per_group=125, fallback="membrane",
                               w=torch.from_numpy(w).to(dev),
                               thr=torch.from_numpy(thr).to(dev)),
                  rng.randint(0, T + 1, (16, n_in))))
    # flood: the widest layer (N_pad 4096: 8 lanes a thread, 8 warps a step,
    # the shortest chunk) with every input at one tick in row 0 (one step of
    # 1,024 events), an all-PAD row 1 and row 2 spread evenly over all T
    n_in, n_out, n_pad, T = 1024, 4000, 4096, 32
    w = np.zeros((n_in, n_pad), np.int8)
    w[:, :n_out] = rng.randint(-127, 128, (n_in, n_out))
    thr = np.full((n_pad,), 2**31 - 1, np.int32)
    thr[:n_out] = rng.randint(2000, 60000, n_out)
    times = rng.randint(0, T + 1, (8, n_in))
    times[0], times[1], times[2] = 5, T, np.arange(n_in) % T
    cases.append(("flood", dict(T=T, e_max=n_in, leak_shift=4, n_out=n_out,
                                n_groups=16, per_group=250,
                                fallback="membrane",
                                w=torch.from_numpy(w).to(dev),
                                thr=torch.from_numpy(thr).to(dev)), times))
    # narrow: N_pad 128 and T 33, not a multiple of a chunk of 8. Input 0
    # drives only lane 5, over its threshold in one step, so a row whose only
    # spike is input 0 at t exits after step t: mid-chunk (t 10), on a
    # chunk's last step (t 15 for chunks of 8, t 32 for every chunk); row 3
    # never fires
    n_in, n_out, n_pad, T = 64, 120, 128, 33
    w = np.zeros((n_in, n_pad), np.int8)
    w[1:, :n_out] = rng.randint(-127, 128, (n_in - 1, n_out))
    w[0, 5] = 127
    thr = np.full((n_pad,), 2**31 - 1, np.int32)
    thr[:n_out] = rng.randint(300, 3000, n_out)
    thr[5] = 100
    times = rng.randint(0, T + 1, (8, n_in))
    times[:4] = T
    times[0, 0], times[1, 0], times[2, 0] = 10, 15, 32
    NARROW_STEPS = (11, 16, 33, 33)
    cases.append(("narrow", dict(T=T, e_max=n_in, leak_shift=2, n_out=n_out,
                                 n_groups=8, per_group=15, fallback="zero",
                                 w=torch.from_numpy(w).to(dev),
                                 thr=torch.from_numpy(thr).to(dev)), times))

    # wide flood layers on a thread-block cluster (N_pad 8192: 2 blocks;
    # MAX_N_PAD: 8), the flood's rows 0-2 plus row 3, whose only input
    # (input 0, at t 10) drives only lane L of the cluster's last block over
    # its threshold: the row's only early exit, after step 11, is found in
    # that block
    FLOOD_EXIT_STEPS = 11
    for n_pad, B_f, per_group in ((8192, 8, 500), (ops.MAX_N_PAD, 4, 2000)):
        n_in, n_out, T = 1024, 16 * per_group, 32
        lane_l = n_out - 5
        plan_f = ops.launch_plan(T, n_in, n_pad)
        check(lane_l >= (plan_f.cluster - 1) * ops.slice_lanes(
            n_pad, plan_f.cluster), f"flood{n_pad}: lane {lane_l} is not in "
              f"the cluster's last block")
        w = np.zeros((n_in, n_pad), np.int8)
        w[1:, :n_out] = rng.randint(-127, 128, (n_in - 1, n_out))
        w[0, lane_l] = 127
        thr = np.full((n_pad,), 2**31 - 1, np.int32)
        thr[:n_out] = rng.randint(2000, 60000, n_out)
        thr[lane_l] = 100
        times = rng.randint(0, T + 1, (B_f, n_in))
        times[0], times[1], times[2] = 5, T, np.arange(n_in) % T
        times[3] = T
        times[3, 0] = FLOOD_EXIT_STEPS - 1
        cases.append((f"flood{n_pad}", dict(
            T=T, e_max=n_in, leak_shift=4, n_out=n_out, n_groups=16,
            per_group=per_group, fallback="membrane",
            w=torch.from_numpy(w).to(dev), thr=torch.from_numpy(thr).to(dev)),
            times))
    # straddle: N_pad 8192 on 2 blocks of 4096 lanes, groups of 12, so group
    # 341 spans lanes 4092-4103 across the blocks. Input 0 drives lane 4100
    # (block 1, group 341) over its threshold, input 1 lane 4091 (block 0,
    # group 340); inputs 2 and 3 drive both below it (ties in v, and lane
    # 4100 ahead). Rows: only 4100 fires (341); both fire at one step, the
    # first lane wins (340); 4100 fires first (341); no spike, v tied across
    # the blocks (membrane: 340); no spike, 4100 ahead (membrane: 341); an
    # all-PAD row (membrane: lane 0's group). Held under both fallbacks.
    n_in, n_pad, per_group, T = 16, 8192, 12, 16
    n_out = 682 * per_group
    w = np.zeros((n_in, n_pad), np.int8)
    w[0, 4100] = w[1, 4091] = 127
    w[2, 4100] = w[2, 4091] = 50
    w[3, 4100], w[3, 4091] = 60, 50
    thr = np.full((n_pad,), 2**31 - 1, np.int32)
    thr[4091] = thr[4100] = 100
    times = np.full((6, n_in), T)
    times[0, 0] = times[1, 0] = times[1, 1] = 3
    times[2, 0], times[2, 1] = 2, 5
    times[3, 2] = times[4, 3] = 4
    STRADDLE_LABELS = {"membrane": [341, 340, 341, 340, 341, 0],
                       "zero": [341, 340, 341, 0, 0, 0]}
    for fallback in STRADDLE_LABELS:
        cases.append((f"straddle/{fallback}", dict(
            T=T, e_max=n_in, leak_shift=4, n_out=n_out, n_groups=682,
            per_group=per_group, fallback=fallback,
            w=torch.from_numpy(w).to(dev), thr=torch.from_numpy(thr).to(dev)),
            times))

    max_err = {name: 0 for name in KERNELS}

    def hold(kname: str, got, want, case: str) -> None:
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        max_err[kname] = max(max_err[kname], err)
        check(err == 0, f"{kname} differs from its plain version on {case} "
              f"(max |err| {err})")

    def same(got, want, what: str) -> None:
        check(all(torch.equal(g, x) for g, x in zip(got, want)), what)

    lib = ops._lib()

    def hold_fused(name, ids, count, wt, th, ls, dec_kw, vector):
        """Kernels 1-3 on their launch plan and on plans with chunks of at
        most 8 and of 1 step, each bit for bit against its plain version;
        ``vector`` says which row loads the launches must take (a lane's
        columns as one vector, or byte by byte). Returns the launch plan's
        (LIFResult, labels, steps)."""
        want_d = ref.fused_event_lif_decode_ref(ids, count, wt, th, ls,
                                                **dec_kw)
        want_x = ref.fused_event_lif_early_exit_ref(ids, count, wt, th, ls)
        want_f = ref.fused_event_lif_ref(ids, count, wt, th, ls)
        T_, E_, N_ = ids.shape[1], ids.shape[2], wt.shape[1]
        load = lib.fused_event_lif_row_load_bytes(wt.data_ptr(), N_)
        check((load > 1) == vector, f"{name}: rows load {load} bytes a lane "
              f"at once, expected {'a vector' if vector else 'bytewise'}")
        plan = ops.launch_plan(T_, E_, N_)
        res, labels = ops.fused_event_lif_decode(ids, count, wt, th, ls,
                                                 **dec_kw)
        hold("fused_event_lif_decode", (res.first_spike, res.v_final, labels),
             want_d, name)
        res_x, steps = ops.fused_event_lif_early_exit(ids, count, wt, th, ls)
        hold("fused_event_lif_early_exit",
             (res_x.first_spike, res_x.v_final, steps), want_x, name)
        full = ops.fused_event_lif(ids, count, wt, th, ls)
        hold("fused_event_lif", full, want_f, name)
        same(full, res, f"fused_event_lif differs from the decode kernel's "
             f"first/v on {name}")
        others = sorted({ops.launch_plan(T_, E_, N_, c) for c in (8, 1)}
                        - {plan}, key=lambda p: -p.chunk)
        for p in others:
            on = f"{name}, chunk {p.chunk}"
            r_p, l_p = ops.fused_event_lif_decode(ids, count, wt, th, ls,
                                                  **dec_kw, plan=p)
            hold("fused_event_lif_decode", (r_p.first_spike, r_p.v_final,
                                            l_p), want_d, on)
            x_p, s_p = ops.fused_event_lif_early_exit(ids, count, wt, th, ls,
                                                      plan=p)
            hold("fused_event_lif_early_exit",
                 (x_p.first_spike, x_p.v_final, s_p), want_x, on)
            hold("fused_event_lif", ops.fused_event_lif(ids, count, wt, th,
                                                        ls, plan=p),
                 want_f, on)
        print(f"[kernels] {name}: launch plan {tuple(plan)} (threads, lanes "
              f"a thread, chunk, shared bytes); kernels 1-3 also held on "
              f"{[tuple(p) for p in others]}; row loads "
              f"{f'{load}-byte vectors' if vector else 'bytewise'}; steps "
              f"{steps.tolist() if len(steps) <= 16 else '...'}")
        return res, labels, steps

    def hold_event_accum(name, ids, wt, vector):
        """event_accum bit for bit against its plain version, with the row
        loads the launch must take (``vector`` or bytewise) asserted."""
        cur = ea.event_accum(ids, wt)
        load = ea._lib().event_accum_row_load_bytes(
            wt.data_ptr(), cur.data_ptr(), wt.shape[1])
        check((load > 1) == vector, f"event_accum on {name}: rows load "
              f"{load} bytes a lane at once, expected "
              f"{'a vector' if vector else 'bytewise'}")
        hold("event_accum", (cur,), (ea_ref.event_accum_ref(ids, wt),), name)
        print(f"[kernels] event_accum on {name}: E_max={ids.shape[-1]} "
              f"N_pad={wt.shape[1]}, row loads "
              f"{f'{load}-byte vectors' if vector else 'bytewise'}: bit-exact")
        return cur

    no_spike = {"membrane": 0, "zero": 0}
    negative_v = 0
    for name, a, times in cases:
        T_ = a["T"]
        frames = pack_events_batched(times, T_, a["e_max"], device=dev)
        ids, count = frames.ids, frames.count
        wt, th, ls = a["w"], a["thr"], a["leak_shift"]
        dec_kw = dict(n_out=a["n_out"], n_groups=a["n_groups"],
                      per_group=a["per_group"], fallback=a["fallback"])
        E_, N_ = ids.shape[2], wt.shape[1]
        res, labels, steps = hold_fused(name, ids, count, wt, th, ls, dec_kw,
                                        vector=True)
        if name == "narrow":
            check(tuple(steps[:4].tolist()) == NARROW_STEPS,
                  f"narrow: rows 0-3 exit after {steps[:4].tolist()} steps, "
                  f"built to exit after {NARROW_STEPS}")
        if name.startswith("flood") and name != "flood":
            check(int(steps[3]) == FLOOD_EXIT_STEPS,
                  f"{name}: row 3 exits after {int(steps[3])} steps, built "
                  f"to exit after {FLOOD_EXIT_STEPS} in the last block")
        if name.startswith("straddle/"):
            want_l = STRADDLE_LABELS[a["fallback"]]
            check(labels.tolist() == want_l, f"{name}: labels "
                  f"{labels.tolist()}, built to be {want_l}")
        # the staged kernels (4-7)
        cur = hold_event_accum(name, ids, wt, vector=True)
        perm = torch.from_numpy(np.random.RandomState(1).permutation(
            ids.shape[2])).to(dev)
        shuffled = ids[..., perm].contiguous()        # PAD mid-row
        cur_s = ea.event_accum(shuffled, wt)
        hold("event_accum", (cur_s,),
             (ea_ref.event_accum_ref(shuffled, wt),), f"{name} shuffled")
        same((cur_s,), (cur,), f"event_accum depends on slot order on {name}")
        staged = lif.lif_fused(cur.movedim(1, 0), th, ls)
        hold("lif_fused", staged,
             lif_ref.lif_fused_ref(cur.movedim(1, 0), th, ls), name)
        same(staged, res, f"staged LIF state differs from the fused kernel's "
             f"on {name}")
        n = a["n_out"]
        first_l, v_l = staged.first_spike[:, :n], staged.v_final[:, :n]
        dkw = dict(n_groups=a["n_groups"], per_group=a["per_group"],
                   sentinel=T_, fallback=a["fallback"])
        labels_s = dec.ttfs_decode(first_l, v_l, **dkw)
        hold("ttfs_decode", (labels_s,),
             (dec_ref.ttfs_decode_ref(first_l, v_l, **dkw),), name)
        same((labels_s,), (labels,), f"staged labels differ from the fused "
             f"decode kernel's on {name}")
        raster = frames_from_times(torch.from_numpy(
            np.asarray(times, np.int32)).to(dev), T_)
        cur_b = smm.spike_matmul(raster, wt)
        hold("spike_matmul", (cur_b,), (smm_ref.spike_matmul_ref(raster, wt),),
             name)
        if not frames.overflow.any():
            same((cur_b,), (cur,), f"spike_matmul currents differ from "
                 f"event_accum's on {name}")
        negative_v += int((res.v_final[:, :n] < 0).sum())
        silent = (res.first_spike[:, :n] == T_).all(dim=1)
        no_spike[a["fallback"]] += int(silent.sum())
        print(f"[kernels] {name}: B={ids.shape[0]} T={T_} "
              f"E_max={ids.shape[2]} N_in={wt.shape[0]} N_pad={wt.shape[1]} "
              f"leak_shift={ls} fallback={a['fallback']} "
              f"events={int(count.sum())} no-spike rows={int(silent.sum())}: "
              f"all seven kernels bit-exact")
    # rows loaded byte by byte (kernels 1-3 and event_accum): an N_pad that
    # is not a multiple of the columns a lane owns (99: 4 a lane; 130: 8,
    # T 33; 1000: 16, 2 lanes a thread and 2 warps a step; 4097: the
    # smallest cluster, 2 blocks of 2064 and 2033 lanes), thresholds from
    # thr_lo up that spread the early exits over T, each with an all-PAD
    # row; and the MNIST case with its weights copied to an odd address
    for n_in, n_pad, n_groups, per_group, T_b, thr_lo in (
            (50, 99, 8, 12, 16, 250), (200, 130, 10, 13, 33, 600),
            (300, 1000, 10, 100, 32, 1000), (300, 4097, 16, 256, 32, 1000)):
        n_out = n_groups * per_group
        w = np.zeros((n_in, n_pad), np.int8)
        w[:, :n_out] = rng.randint(-127, 128, (n_in, n_out))
        thr = np.full((n_pad,), 2**31 - 1, np.int32)
        thr[:n_out] = rng.randint(thr_lo, 8 * thr_lo, n_out)
        times = rng.randint(0, T_b + 1, (12, n_in))
        times[-1] = T_b
        frames = pack_events_batched(times, T_b, n_in, device=dev)
        w_r = torch.from_numpy(w).to(dev)
        hold_fused(f"ragged{n_pad}", frames.ids, frames.count, w_r,
                   torch.from_numpy(thr).to(dev),
                   3, dict(n_out=n_out, n_groups=n_groups,
                           per_group=per_group, fallback="membrane"),
                   vector=False)
        hold_event_accum(f"ragged{n_pad}", frames.ids, w_r, vector=False)
    _, a, times = cases[0]
    frames = pack_events_batched(times, a["T"], a["e_max"], device=dev)
    odd = torch.empty(a["w"].numel() + 1, dtype=torch.int8, device=dev)
    w_odd = odd[1:].view(a["w"].shape)
    w_odd.copy_(a["w"])
    check(w_odd.is_contiguous() and w_odd.data_ptr() % 2 == 1,
          "the MNIST weights' copy is not contiguous at an odd address")
    hold_fused("mnist, w at an odd address", frames.ids, frames.count, w_odd,
               a["thr"], a["leak_shift"],
               dict(n_out=a["n_out"], n_groups=a["n_groups"],
                    per_group=a["per_group"], fallback=a["fallback"]),
               vector=False)
    hold_event_accum("mnist, w at an odd address", frames.ids, w_odd,
                     vector=False)
    # E_max 16,384 (past the 12,000 slots the first kernel staged in shared
    # memory): PAD in the middle of every row and ids at or past N_in
    ids_e = rng.randint(0, 300, (4, 2, 16_384)).astype(np.int32)
    ids_e[..., 5000:9000] = -1
    ids_e[:, 1, ::7] = 300 + 7
    hold_event_accum("E_max 16384", torch.from_numpy(ids_e).to(dev),
                     torch.from_numpy(rng.randint(-127, 128, (300, 256))
                                      .astype(np.int8)).to(dev), vector=True)
    # a plan the kernels cannot run is refused before the launch: by the
    # wrapper (ValueError), and by the C entry point (cudaErrorInvalidValue,
    # outputs untouched)
    bad = ops.launch_plan(T_, E_, N_)._replace(threads=48)
    try:
        ops.fused_event_lif_early_exit(ids, count, wt, th, ls, plan=bad)
        fail(f"the wrapper launched the plan {tuple(bad)}")
    except ValueError:
        pass
    untouched = torch.full((ids.shape[0], N_), -7, dtype=torch.int32,
                           device=dev)
    outs = [untouched.clone(), untouched.clone(),
            untouched[:, 0].clone().contiguous()]
    code = ops._lib().fused_event_lif_early_exit(
        ids.data_ptr(), count.data_ptr(), wt.data_ptr(), th.data_ptr(),
        *(o.data_ptr() for o in outs), ids.shape[0], T_, E_, wt.shape[0], N_,
        ls, *bad, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(code == 1 and all(bool((o == -7).all()) for o in outs),
          f"the C entry point took the plan {tuple(bad)} (code {code})")
    print(f"[kernels] the plan {tuple(bad)} is refused before the launch: "
          f"ValueError from the wrapper, cudaErrorInvalidValue from the "
          f"entry point, outputs untouched")
    # the host's test of a plan (ops.check_plan) and the entry points'
    # (fused_event_lif_plan_ok) agree: each launch plan is taken, and so is
    # each change of one of its fields exactly when check_plan takes it
    # (a cluster with its slice's shared memory, or with the plan's own)
    n_plans = 0
    for T_p in (1, 8, 32, 33, 64):
        for E_p in (1, 128, 1024):
            for N_p in (1, 99, 128, 130, 256, 1000, 2048, 4096, 4097, 8192,
                        12_289, ops.MAX_N_PAD):
                for c in (None, 8, 1):
                    p = ops.launch_plan(T_p, E_p, N_p, c)
                    width = ops.slice_lanes(N_p, p.cluster)
                    variants = [p] + [
                        p._replace(threads=x) for x in (
                            p.threads - 32, p.threads + 32, 48, 1024)] + [
                        p._replace(lanes_per_thread=x)
                        for x in (1, 2, 3, 4, 8, 16)] + [
                        p._replace(chunk=x, smem_bytes=4 * x * width)
                        for x in (0, T_p, T_p + 1)] + [
                        p._replace(smem_bytes=p.smem_bytes + 4)] + [
                        p._replace(cluster=k, smem_bytes=4 * p.chunk
                                   * ops.slice_lanes(N_p, k))
                        for k in (1, 2, 3, 4, 8, 16)] + [
                        p._replace(cluster=k) for k in (0, 2, 4)]
                    for q in variants:
                        try:
                            ops.check_plan(q, T_p, E_p, N_p)
                            host_ok = True
                        except ValueError:
                            host_ok = False
                        card_ok = lib.fused_event_lif_plan_ok(
                            T_p, E_p, N_p, *q) == 1
                        check(card_ok == host_ok and (card_ok or q != p),
                              f"plan {tuple(q)} for T={T_p}, E_max={E_p}, "
                              f"N_pad={N_p}: check_plan "
                              f"{'takes' if host_ok else 'refuses'} it, the "
                              f"entry points "
                              f"{'take' if card_ok else 'refuse'} it")
                        n_plans += 1
    over = ops.MAX_N_PAD + 1
    check(all(lib.fused_event_lif_plan_ok(32, 128, over, 512, 8, 1,
                                          4 * ops.slice_lanes(over, k),
                                          k) == 0 for k in (8, 16)),
          f"the entry points take N_pad {over}")
    print(f"[kernels] ops.check_plan and the entry points' test agree on "
          f"{n_plans} plans (every launch plan taken)")
    check(negative_v > 0, "no negative membrane was exercised")
    check(no_spike["membrane"] > 0 and no_spike["zero"] > 0,
          "both decode fallbacks must be exercised")
    # tie-heavy rows at the serving shape, both fallbacks
    first_t = torch.from_numpy(rng.choice([1, 2, prog.T], size=(
        SERVE_BATCH, prog.n_out)).astype(np.int32)).to(dev)
    first_t[:SERVE_BATCH // 2] = prog.T
    v_t = torch.from_numpy(rng.randint(-2, 2, (SERVE_BATCH, prog.n_out))
                           .astype(np.int32)).to(dev)
    for fallback in ("membrane", "zero"):
        dkw = dict(n_groups=prog.n_groups, per_group=prog.per_group,
                   sentinel=prog.T, fallback=fallback)
        hold("ttfs_decode", (dec.ttfs_decode(first_t, v_t, **dkw),),
             (dec_ref.ttfs_decode_ref(first_t, v_t, **dkw),),
             f"ties/{fallback}")
    # lif_fused on windows the kernel splits into chunks of 32 steps and a
    # tail it scans step by step (T 16, 31, 33, 40, 64, 100 at N_pad 4 to
    # 1,024), on the staged path's movedim view and, at T 33, on a
    # contiguous (T, B, N_pad) tensor, a lane stride of 2, an odd element
    # offset and a t stride of N_pad + 1
    for B_l, T_l, N_l in ((8, 16, 256), (8, 31, 256), (8, 33, 256),
                          (8, 100, 128), (4, 100, 1000), (4, 64, 1024),
                          (3, 40, 4)):
        cur_l = torch.from_numpy(rng.randint(-300, 400, (B_l, T_l, N_l))
                                 .astype(np.int32)).to(dev)
        thr_l = torch.from_numpy(rng.randint(300, 2000, (N_l,))
                                 .astype(np.int32)).to(dev)
        layouts = {"movedim view": cur_l.movedim(1, 0)}
        if T_l == 33:
            wide = torch.zeros((B_l, T_l, 2 * N_l), dtype=torch.int32,
                               device=dev)
            wide[..., ::2] = cur_l
            flat = torch.zeros((cur_l.numel() + 1,), dtype=torch.int32,
                               device=dev)
            flat[1:] = cur_l.reshape(-1)
            pad = torch.zeros((B_l, T_l, N_l + 1), dtype=torch.int32,
                              device=dev)
            pad[..., :N_l] = cur_l
            layouts.update({
                "contiguous (T, B, N_pad)": cur_l.movedim(1, 0).contiguous(),
                "lane stride 2": wide[..., ::2].movedim(1, 0),
                "odd offset": flat[1:].view(cur_l.shape).movedim(1, 0),
                "t stride N_pad + 1": pad[..., :N_l].movedim(1, 0)})
        for what, view_l in layouts.items():
            got = lif.lif_fused(view_l, thr_l, 3)
            want = lif_ref.lif_fused_ref(view_l, thr_l, 3)
            hold("lif_fused", got, want, f"T {T_l} N_pad {N_l}, {what}")
            fired = want.first_spike
            check(N_l < 128 or bool(((fired > T_l // 2)
                                     & (fired < T_l)).any()),
                  f"lif_fused T {T_l}: no late spike was exercised")
        print(f"[kernels] lif_fused B={B_l} T={T_l} N_pad={N_l} on "
              f"{', '.join(layouts)}: bit-exact")
    # ttfs_decode on both sides of the warp/block cut (n 63, 150, 1024 on a
    # warp a row; 1025, 8192, 32,768 on a block a row), under both
    # fallbacks: negative first times, ties between lanes folded in
    # different warp lanes (and warps), the last lane alone, tie-heavy rows,
    # every membrane at INT32_MIN, no-spike rows
    for G, Pg in ((7, 9), (10, 15), (32, 32), (25, 41), (16, 512),
                  (16, 2048)):
        n_d, T_d, B_d = G * Pg, 16, 12
        first_d = np.full((B_d, n_d + 5), T_d, np.int32)   # rows strided
        v_d = np.zeros((B_d, n_d + 5), np.int32)
        a_l, b_l = 3, n_d - 2
        first_d[0, [a_l, b_l]] = 5
        first_d[1, [b_l, n_d - 1]] = -4
        first_d[2, :n_d] = rng.choice([-2, 2, 3, T_d], size=n_d)
        first_d[3, n_d - 1] = 0
        v_d[4, [a_l, b_l]] = 9
        v_d[5, [b_l, n_d - 1]] = 9
        v_d[6] = rng.randint(-2, 2, n_d + 5)
        v_d[7] = np.iinfo(np.int32).min
        v_d[8, n_d - 1] = 1
        first_d[9, :n_d] = rng.choice([1, T_d], size=n_d)
        first_d[10, :n_d] = rng.choice([-7, T_d], size=n_d)
        first_f = torch.from_numpy(first_d).to(dev)[:, :n_d]
        v_f = torch.from_numpy(v_d).to(dev)[:, :n_d]
        how = dec.route(n_d)
        for fallback in ("membrane", "zero"):
            dkw_d = dict(n_groups=G, per_group=Pg, sentinel=T_d,
                         fallback=fallback)
            dec.reset_launches()
            got = dec.ttfs_decode(first_f, v_f, **dkw_d)
            check(dec.ROUTES[how] == 1 and sum(dec.ROUTES.values()) == 1,
                  f"ttfs_decode n {n_d}: routes {dec.ROUTES}, expected {how}")
            want = dec_ref.ttfs_decode_ref(first_f, v_f, **dkw_d)
            hold("ttfs_decode", (got,), (want,), f"n {n_d} ({how}) "
                 f"{fallback}")
            check(int(want[0]) == a_l // Pg and int(want[1]) == b_l // Pg
                  and int(want[3]) == G - 1, f"ttfs_decode n {n_d}: the "
                  f"built ties decode to {want[:4].tolist()}")
        print(f"[kernels] ttfs_decode n={n_d} ({G} x {Pg}, {how} route): "
              f"both fallbacks bit-exact")
    dec.reset_launches()
    # spike_matmul on both routes (ops.ROUTES): any int8 with ragged edges,
    # K past 131,072, a raster at a misaligned address, and sums that wrap
    def int8s(shape, lo=-128, hi=128):
        return torch.from_numpy(rng.randint(lo, hi, shape)
                                .astype(np.int8)).to(dev)

    misaligned = int8s((70 * 144 + 1,))[1:].view(70, 144)
    wrap_a = torch.full((4, 140_000), -128, dtype=torch.int8, device=dev)
    wrap_a[1] = 127
    for what, a8, b8, route in (
            ("random int8 777x129x200", int8s((7, 111, 129)),
             int8s((129, 200)), "masked"),
            ("random int8 777x144x200", int8s((7, 111, 144)),
             int8s((144, 200)), "tma"),
            ("{0,1} 100x140000x72", int8s((100, 140_000), 0, 2),
             int8s((140_000, 72)), "tma"),
            ("random int8 70x131075x24", int8s((70, 131_075)),
             int8s((131_075, 24)), "masked"),
            ("misaligned raster 70x144x40", misaligned, int8s((144, 40)),
             "masked"),
            ("int32 wrap 4x140000x16", wrap_a,
             torch.full((140_000, 16), -128, dtype=torch.int8, device=dev),
             "tma")):
        smm.reset_launches()
        got = smm.spike_matmul(a8, b8)
        check(smm.ROUTES[route] == 1 and sum(smm.ROUTES.values()) == 1,
              f"spike_matmul on {what}: routes {smm.ROUTES}, expected "
              f"{route}")
        want = smm_ref.spike_matmul_ref(a8, b8)
        if what.startswith("int32 wrap"):        # 140,000 * 128 * 128 wraps
            check(int(want[0, 0]) == 140_000 * 128 * 128 - 2**32,
                  "the plain version does not wrap the int32 sum")
        hold("spike_matmul", (got,), (want,), what)
        print(f"[kernels] spike_matmul {what}: {route} route, bit-exact")
    print(f"[kernels] negative membranes {negative_v}, no-spike rows per "
          f"fallback {no_spike}; tie-heavy decode and the int8 products "
          f"bit-exact; max |err| {max_err}")

    # ------------------------------------------------------------ 3 main path
    #: per run: how to build it, and the launches each kernel must make per
    #: served batch (every other kernel: none)
    runs = [
        ("event-fused full-T",
         lambda: SNNServeEngine(art, max_batch=SERVE_BATCH),
         {"fused_event_lif_decode": 1}),
        ("event-fused latency",
         lambda: SNNServeEngine(art, max_batch=SERVE_BATCH,
                                latency_mode=True),
         {"fused_event_lif_early_exit": 1}),
        ("event-cuda full-T",
         lambda: SNNServeEngine(art, max_batch=SERVE_BATCH, kernel="cuda"),
         {"event_accum": 1, "lif_fused": 1, "ttfs_decode": 1}),
        ("event-cuda latency",
         lambda: SNNServeEngine(art, max_batch=SERVE_BATCH, kernel="cuda",
                                latency_mode=True),
         {"event_accum": 1, "ttfs_decode": 1}),
        ("batch-cuda",
         lambda: ServingScheduler(art, spec="accelerator-batch",
                                  kernel="cuda", max_batch=SERVE_BATCH),
         {"spike_matmul": 1, "lif_fused": 1, "ttfs_decode": 1}),
    ]
    launches = {name: 0 for name in KERNELS}
    per_run = {}
    for run, make, per_batch in runs:
        eng = make()
        finish = eng.flush if hasattr(eng, "flush") else eng.drain
        eng.reset_stats()
        reset_launches()
        t0 = time.perf_counter()
        for img in xte:
            eng.submit(img)
        done = finish()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        reqs = [done[r] for r in sorted(done)]
        st = eng.stats()
        eng.close()
        batches = st["batches"]
        for kname, n in counts.items():
            want = per_batch.get(kname, 0) * batches
            check(n == want, f"{run}: {kname} launched {n} times for "
                  f"{batches} served batches, expected {want}")
            launches[kname] += n
        check(all(counts[k] > 0 for k in per_batch),
              f"{run}: a kernel of the path was never launched")
        if "ttfs_decode" in per_batch:         # a warp a row (n 150)
            check(dec.ROUTES == {"warp": counts["ttfs_decode"], "block": 0},
                  f"{run}: ttfs_decode routes {dec.ROUTES}, expected every "
                  f"launch on a warp a row")
        if "spike_matmul" in per_batch:        # the tensor maps' route
            check(smm.ROUTES == {"tma": counts["spike_matmul"], "masked": 0},
                  f"{run}: spike_matmul routes {smm.ROUTES}, expected every "
                  f"launch on TMA")
        labels = np.asarray([r.label for r in reqs], np.int32)
        steps = np.asarray([r.steps for r in reqs], np.int32)
        latency = run.endswith("latency")
        check(np.array_equal(labels, exp["labels_latency" if latency
                                         else "labels"]),
              f"{run}: served labels differ from the JAX reference's")
        check(np.array_equal(steps, exp["steps_latency"]) if latency
              else bool((steps == prog.T).all()),
              f"{run}: served steps differ from the JAX reference's")
        per_run[run] = st
        print(f"[main] {run}: {len(reqs)} images in {wall:.3f} s wall, "
              f"accuracy {np.mean(labels == yte):.4f}, mean steps "
              f"{steps.mean():.2f}, system {st['system_us_per_image']:.2f} "
              f"us/image, accelerator {st['accel_us_per_image']:.2f} "
              f"us/image, launches "
              f"{ {k: counts[k] for k in per_batch} } over {batches} batches "
              f"(1.00 per served batch each, every other kernel 0)")
        print(f"[main] {run} stats: {json.dumps(st, sort_keys=True)}")
    print("[main] staged vs fused, system / accelerator us per image — card: "
          f"{card}")
    for run, st in per_run.items():
        print(f"[main]   {run:22s} {st['system_us_per_image']:9.2f} "
              f"{st['accel_us_per_image']:9.2f}")

    # correctness only, outside the counted runs: the launches below are not
    # the main path's
    for seed, fart, fprog, images, golden in fuzz:
        eng = SNNServeEngine(fart, max_batch=SERVE_BATCH)
        check(np.array_equal(eng.classify(images), golden["labels"]),
              f"fuzz seed {seed}: served labels differ from golden")
        eng.close()
        for spec in ("accelerator-event-fused", "accelerator-event-cuda",
                     "accelerator-batch-cuda"):
            out = make_runtime(fprog, spec, device=dev).forward(images)
            for key in ("labels", "first_spike", "v_final", "steps"):
                check(np.array_equal(getattr(out, key).cpu().numpy(),
                                     golden[key]),
                      f"fuzz seed {seed}: {spec} {key} differs from golden")
        lat = {k: SNNAccelerator(fprog, mode="event", kernel=k,
                                 device=dev).forward(images, latency_mode=True)
               for k in ("fused", "cuda")}
        check(np.array_equal(lat["cuda"].labels.cpu().numpy(),
                             golden["labels"]),
              f"fuzz seed {seed}: latency-mode labels differ from golden")
        same(lat["cuda"], lat["fused"], f"fuzz seed {seed}: the staged early "
             f"exit differs from the fused one")
    print(f"[main] fuzz seeds {manifest['seeds']}: accelerator-event-fused, "
          f"-event-cuda and -batch-cuda equal tests/golden/ in labels, "
          f"first_spike, v_final, steps; the staged early exit equals the "
          f"fused one in labels, first_spike, v at exit and steps")

    ref_rt = SNNReference(art, device=dev)
    labels, first, v = [], [], []
    for i in range(0, len(xte), 1000):
        out = ref_rt.forward(xte[i:i + 1000])
        labels.append(out.labels.cpu().numpy())
        first.append(out.first_spike.cpu().numpy())
        v.append(out.v_final.cpu().numpy())
    check(np.array_equal(np.concatenate(labels), exp["labels"]),
          "SNNReference labels on the card differ from the JAX reference's")
    check(sha256(np.concatenate(first)) == str(exp["first_spike_sha256"]),
          "SNNReference first_spike differs from the JAX reference")
    check(sha256(np.concatenate(v)) == str(exp["v_final_sha256"]),
          "SNNReference v_final differs from the JAX reference")
    print("[main] SNNReference on the card: labels, first_spike and v_final "
          "equal the JAX reference on all 10,000 images")

    # ------------------------------------------------------------ 3b author
    # define -> train -> export (calibrated on kernels 4 -> 5 -> 6) -> serve
    # the new artifact on kernels 1 and 2, at the paper's width, nothing cut
    # (in a function of its own: its names stay out of the later phases)
    def author() -> None:
        def counted(fn, what: str):
            """``fn()`` with every launch counter set to 0 just before and read
            just after; returns (its result, wall s, the counts)."""
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            print(f"[author] {what}: {wall:.3f} s wall, launches "
                  f"{ {k: n for k, n in counts.items() if n} } — card: {card}")
            return out, wall, counts

        def export_counted(model, what: str, path: str):
            """One counted export on the calibration set: spike_matmul once,
            lif_fused and ttfs_decode once per threshold candidate, nothing
            else."""
            new, wall, counts = counted(lambda: deploy.export(
                model, path, calib_images=x_cal, calib_labels=y_cal,
                device=dev), what)
            tau = model.lif_layers()[0].spec.tau
            n_cand = len({quant.leak_shift_from_tau(tau), 31}) * 2 * 3
            want = {"spike_matmul": 1, "lif_fused": n_cand,
                    "ttfs_decode": n_cand}
            for kname, n in counts.items():
                check(n == want.get(kname, 0), f"{what}: {kname} launched {n} "
                      f"times, expected {want.get(kname, 0)}")
                launches[kname] += n
            print(f"[author] {what}: {n_cand} threshold candidates, chosen leak "
                  f"shift {new.meta['lif']['leak_shift']}, calibration accuracy "
                  f"{new.meta['lif']['calibration']['calib_accuracy']:.6f}, "
                  f"E_max {new.meta['events']['e_max']}")
            return new, wall

        def snn_model(w=None, generator=None):
            cfg = SNN_CONFIG
            lin = snn.Linear(cfg["n_in"], cfg["n_out"], generator=generator,
                             device=dev)
            if w is not None:
                lin.set_weight(w)
            return snn.SNN(snn.Sequential(lin, snn.LIF(tau=cfg["leak_tau"],
                                                       t_steps=cfg["T"])),
                           readout=snn.ReadoutSpec(cfg["n_groups"],
                                                   cfg["per_group"],
                                                   cfg["fallback"]),
                           encode_t=cfg["T"])

        author_dir = os.path.join(ROOT, "build", "author")
        os.makedirs(author_dir, exist_ok=True)
        t0 = time.perf_counter()
        xtr, ytr = mnist.generate(60_000, 1234)
        x_cal, y_cal = xtr[:8192], ytr[:8192]
        print(f"[author] procedural MNIST train split (60,000) generated in "
              f"{time.perf_counter() - t0:.2f} s on the host")

        # 1. the committed artifact re-exported from its float weights
        re_path = os.path.join(author_dir, "mnist_ttfs_reexport.npz")
        _, wall = export_counted(snn_model(art["w_float"]),
                                 "re-export of mnist_ttfs.npz", re_path)
        again = Artifact.load(re_path)
        check(again.fingerprint() == str(exp["artifact_fingerprint"]),
              "the re-exported artifact's fingerprint differs from the JAX "
              "export's")
        check(lower(again, device=dev, cache=False).fingerprint ==
              str(exp["program_fingerprint"]), "the re-exported artifact's "
              "program fingerprint differs from the JAX package's")
        check(all(again[k].tobytes() == art[k].tobytes() for k in art.arrays),
              "the re-exported arrays differ from mnist_ttfs.npz's")
        print(f"[author] re-export: fingerprint and program fingerprint equal "
              f"JAX's, every array byte-equal; export {wall:.3f} s wall — card: "
              f"{card}")
        # where an export's time goes: device time by kernel and the
        # device's busy share of the wall (an uncounted run)
        show_profile("export, 8,192 calibration images", profile(
            lambda: deploy.export(snn_model(art["w_float"]), None,
                                  calib_images=x_cal, calib_labels=y_cal,
                                  device=dev)), card)

        # kernels 4 -> 5 -> 6 at the calibration's own shapes, held to their
        # plain versions (outside the counted runs)
        w8 = torch.from_numpy(art["w_int8"]).to(dev)
        raster = frames_from_times(encode_ttfs(
            torch.from_numpy(x_cal).to(dev), prog.T, prog.x_min), prog.T)
        cur = smm.spike_matmul(raster, w8)
        hold("spike_matmul", [cur], [smm_ref.spike_matmul_ref(raster, w8)],
             f"the calibration's {tuple(raster.shape)} x {tuple(w8.shape)}")
        thr_c = torch.from_numpy(art["thresholds"]).to(dev)
        for ls in sorted({prog.leak_shift, 31}):
            st = lif.lif_fused(cur.movedim(1, 0), thr_c, ls)
            hold("lif_fused", tuple(st), tuple(lif_ref.lif_fused_ref(
                cur.movedim(1, 0), thr_c, ls)),
                f"the calibration's (T, B, N) = {tuple(cur.movedim(1, 0).shape)}"
                f" view, leak shift {ls}")
            for fb in ("membrane", "zero"):
                kw = dict(n_groups=prog.n_groups, per_group=prog.per_group,
                          sentinel=prog.T, fallback=fb)
                hold("ttfs_decode", [dec.ttfs_decode(*st, **kw)],
                     [dec_ref.ttfs_decode_ref(*st, **kw)],
                     f"the calibration's {prog.n_out} unpadded lanes, leak "
                     f"shift {ls}, {fb} fallback")
        print(f"[author] spike_matmul, lif_fused and ttfs_decode bit-exact with "
              f"their plain versions at the calibration's shapes (8,192 images, "
              f"N {prog.n_out} unpadded)")

        # 2. trained on the card from the port's own seeded init, exported
        res, wall_train, _ = counted(lambda: ttfs_trainer.train_dense_proxy(
            xtr, ytr, test_images=xte, test_labels=yte, epochs=3, device=dev),
            "train_dense_proxy, 3 epochs")
        check(res.steps == 702, f"{res.steps} training steps, expected 702")
        new_path = os.path.join(author_dir, "mnist_ttfs_trained.npz")
        new, wall_export = export_counted(res.model, "export of the trained "
                                          "model", new_path)
        new = Artifact.load(new_path)
        print(f"[author] trained {res.steps} steps in {wall_train:.3f} s wall "
              f"(dense train accuracy {res.train_acc:.4f}, test "
              f"{res.test_acc:.4f}), exported in {wall_export:.3f} s wall — "
              f"card: {card}")
        show_profile("train_dense_proxy, 1 epoch (234 steps)", profile(
            lambda: ttfs_trainer.train_dense_proxy(xtr, ytr, epochs=1,
                                                   device=dev)), card)

        # 3. the new artifact served on kernels 1 and 2, against the reference
        out = SNNReference(new, device=dev).forward(xte)
        ref_labels = out.labels.cpu().numpy()
        nprog = lower(new, device=dev)
        cur = spike_currents(frames_from_times(encode_ttfs(
            torch.from_numpy(xte).to(dev), nprog.T, nprog.x_min), nprog.T),
            nprog.w_int8.to(torch.float32))
        _, ref_steps = lif_scan_early_exit_rows(cur.movedim(1, 0),
                                                nprog.thresholds,
                                                nprog.leak_shift, nprog.T)
        ref_steps = ref_steps.cpu().numpy()
        del cur
        for mode, kname in (("full-T", "fused_event_lif_decode"),
                            ("latency", "fused_event_lif_early_exit")):
            eng = SNNServeEngine(new, max_batch=SERVE_BATCH, kernel="fused",
                                 latency_mode=mode == "latency")
            eng.reset_stats()

            def serve(eng=eng):
                for img in xte:
                    eng.submit(img)
                return eng.flush()
            done, wall, counts = counted(serve, f"served new artifact, {mode}")
            batches = eng.stats()["batches"]
            eng.close()
            for k, n in counts.items():
                want = batches if k == kname else 0
                check(n == want, f"new artifact {mode}: {k} launched {n} times "
                      f"for {batches} served batches, expected {want}")
            launches[kname] += counts[kname]
            reqs = [done[r] for r in sorted(done)]
            labels = np.asarray([r.label for r in reqs], np.int32)
            steps = np.asarray([r.steps for r in reqs], np.int32)
            n_same = int(np.sum(labels == ref_labels))
            check(n_same == len(xte), f"new artifact {mode}: {n_same}/"
                  f"{len(xte)} labels equal the reference's")
            check(np.array_equal(steps, ref_steps) if mode == "latency"
                  else bool((steps == nprog.T).all()),
                  f"new artifact {mode}: served steps differ from the plain "
                  f"early-exit scan's")
            acc = float(np.mean(labels == yte))
            check(acc >= 0.89, f"new artifact {mode}: TTFS accuracy {acc:.4f} "
                  f"below 0.89")
            print(f"[author] new artifact served {mode} on {kname}: "
                  f"{n_same}/{len(xte)} labels equal SNNReference's, mean steps "
                  f"{steps.mean():.2f}, TTFS accuracy {acc:.4f} (the JAX-trained "
                  f"fixture's {float(exp['accuracy']):.4f}), {counts[kname]} "
                  f"launches over {batches} batches")

        # a short surrogate-gradient run: its loss falls, it learns
        sres, wall, _ = counted(lambda: ttfs_trainer.train_surrogate(
            x_cal, y_cal, epochs=1, t_steps=16, device=dev),
            "train_surrogate, 1 epoch of 8,192 images, T 16")
        k = max(1, len(sres.losses) // 8)
        first, last = np.mean(sres.losses[:k]), np.mean(sres.losses[-k:])
        check(last < first, f"surrogate loss did not fall ({first:.4f} -> "
              f"{last:.4f})")
        check(sres.train_acc > 0.5, f"surrogate train accuracy "
              f"{sres.train_acc:.4f} not above 0.5")
        print(f"[author] train_surrogate: {sres.steps} steps in {wall:.3f} s, "
              f"loss {first:.4f} -> {last:.4f} (mean of first/last {k}), train "
              f"accuracy {sres.train_acc:.4f} — card: {card}")

        # 4. conformance on the card
        for seed, fart, _, images, _ in fuzz:
            case = fuzz_case(seed)
            check(case.artifact.fingerprint() == fart.fingerprint()
                  and np.array_equal(case.images, images),
                  f"fuzz seed {seed}: the port's fuzz_case differs from JAX's")
        print(f"[author] fuzz_case equals the JAX artifacts and images for seeds "
              f"{[s for s, *_ in fuzz]}")
        diffs = conformance_golden.check(dirpath=GOLDEN, device=dev)
        check(not diffs, f"golden drift on the card: {[str(d) for d in diffs]}")
        print(f"[author] golden.check on tests/golden/: clean "
              f"({len(fuzz)} seeds)")
        for seed, *_ in fuzz:
            rep = run_case(fuzz_case(seed), device=dev)
            check(rep.passed, rep.summary())
            print(f"[author] {rep.summary()}")
            conformance[seed] = rep

    #: seed -> the pinned seed's conformance report on the card (phase 3d
    #: holds it to 25/25 oracles)
    conformance = {}
    author()

    # --------------------------------------------------------- 3c transport
    # the program crosses processes without being lowered again: envelopes
    # equal to JAX's, every mutation refused, a leader and a follower process
    # over loopback TCP, the follower's path in-process on kernels 1 and 2,
    # and the 27 fault scenarios (a function of its own, as 3b)
    def transport() -> None:
        from repro_torch.conformance.fuzz import fuzz_envelope_mutations
        from repro_torch.conformance.transport_faults import (SCENARIOS,
                                                              run_suite)
        from repro_torch.core.lowering import ProgramCache, install
        from repro_torch.core.program_io import (ProgramIOError,
                                                 deserialize_program,
                                                 serialize_program)
        from repro_torch.distributed import transport as tp
        from repro_torch.launch.cluster import distribute_program

        texp = dict(np.load(os.path.join(ASSETS, "transport_expected.npz")))
        # 1. the envelopes of the programs lowered on the card are JAX's
        blob = serialize_program(prog)
        check(blob == texp["envelope_mnist"].tobytes(),
              "the MNIST envelope differs from the JAX package's")
        envelopes = {"mnist": (art, blob)}
        for seed, fart, fprog, _, _ in fuzz:
            fblob = serialize_program(fprog)
            check(fblob == texp[f"envelope_fuzz_seed{seed}"].tobytes(),
                  f"fuzz seed {seed}: the envelope differs from JAX's")
            envelopes[f"fuzz seed {seed}"] = (fart, fblob)
        back = deserialize_program(blob, art, device=dev, cache=False)
        check(back.fingerprint == prog.fingerprint and back.device == dev
              and all(torch.equal(getattr(back, k), getattr(prog, k))
                      for k in ("w_float", "w_int8", "thresholds",
                                "w_padded", "thr_padded")),
              "the MNIST envelope does not reconstruct the lowered program")
        print(f"[transport] envelopes equal JAX's byte for byte: MNIST "
              f"{len(blob)} bytes, fuzz seeds "
              f"{[len(b) for k, (_, b) in envelopes.items() if k != 'mnist']}"
              f" bytes; the MNIST envelope reconstructs the program on "
              f"{dev}")
        # 2. every mutation is refused (the refusal is the check)
        refused = 0
        for i, (name, (a, b)) in enumerate(envelopes.items()):
            for desc, bad in fuzz_envelope_mutations(b, i):
                try:
                    deserialize_program(bad, a, device=dev, cache=False)
                except ProgramIOError:
                    refused += 1
                    continue
                fail(f"{name}: the mutated envelope ({desc}) was accepted")
        print(f"[transport] {refused} envelope mutations "
              f"(fuzz_envelope_mutations, 5 of each of {len(envelopes)} "
              f"envelopes) refused with ProgramIOError")

        # 3. a leader and a follower process over loopback TCP
        requests = SERVE_REQUESTS
        images = np.random.RandomState(0).rand(
            requests, prog.n_in).astype(np.float32)
        check(sha256(images) == str(texp["serve_images_sha256"]),
              "the launcher's request stream differs from the exported one")
        tdir = os.path.join(ROOT, "build", "transport")
        os.makedirs(tdir, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=SRC, PYTHONUNBUFFERED="1")
        base = [sys.executable, "-m", "repro_torch.launch.serve",
                "--snn-artifact", os.path.join(ASSETS, "mnist_ttfs.npz"),
                "--requests", str(requests)]
        out = {role: os.path.join(tdir, f"{role}.npy")
               for role in ("leader", "follower")}
        for path in out.values():
            if os.path.exists(path):
                os.remove(path)

        #: role -> perf_counter at its spawn and at the end of its output
        spawned, ended = {}, {}

        def spawn(role, args):
            spawned[role] = time.perf_counter()
            proc = subprocess.Popen(base + args, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True,
                                    env=env, cwd=ROOT)
            lines: queue.Queue = queue.Queue()

            def pump():
                for line in proc.stdout:
                    lines.put(line)
                ended[role] = time.perf_counter()
                lines.put(None)
            threading.Thread(target=pump, daemon=True).start()
            return proc, lines

        def read_until(lines, pattern, timeout_s, seen):
            """Lines until one matches ``pattern`` (its match) or the
            process's output ends (None)."""
            deadline = time.monotonic() + timeout_s
            while True:
                line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
                if line is None:
                    return None
                seen.append(line)
                m = re.search(pattern, line) if pattern else None
                if m:
                    return m

        procs = []
        logs = {"leader": [], "follower": []}
        try:
            leader, leader_lines = spawn("leader", [
                "--transport", "tcp://127.0.0.1:0", "--role", "leader",
                "--await-fetches", "1", "--labels-out", out["leader"]])
            procs.append(leader)
            m = read_until(leader_lines,
                           r"\[leader\] publishing program at (tcp://\S+)",
                           300, logs["leader"])
            check(m is not None, "the leader printed no endpoint:\n"
                  + "".join(logs["leader"]))
            follower, follower_lines = spawn("follower", [
                "--transport", m.group(1), "--role", "follower",
                "--labels-out", out["follower"]])
            procs.append(follower)
            for role, proc, lines in (("follower", follower, follower_lines),
                                      ("leader", leader, leader_lines)):
                read_until(lines, None, 300, logs[role])
                check(proc.wait(timeout=60) == 0,
                      f"the {role} process exited with {proc.returncode}:\n"
                      + "".join(logs[role]))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        for role in ("leader", "follower"):
            print("".join(f"[transport] {role}| {line}"
                          for line in logs[role]), end="")
        text = {role: "".join(logs[role]) for role in logs}
        check("(cache: 0 lowered" in text["follower"],
              "the follower process lowered the program")
        check("(cache: 1 lowered" in text["leader"]
              and "served 1/1 follower fetch(es)" in text["leader"],
              "the leader did not lower once and serve one fetch")
        served = {role: np.load(path) for role, path in out.items()}
        for role, labels in served.items():
            check(labels.dtype == np.int32 and np.array_equal(
                labels, texp["serve_labels"]),
                f"the {role}'s {requests} labels differ from JAX's")
        said = {role: re.search(
            r"program after ([0-9.]+) s, first label after ([0-9.]+) s, "
            r"all labels after ([0-9.]+) s", text[role]).groups()
            for role in logs}
        print(f"[transport] two processes over loopback TCP, {requests} "
              f"requests each: labels equal to each other and to JAX's "
              f"reference; the follower lowered nothing. From each "
              f"launcher's start, program / first label / all labels: "
              + "; ".join(f"{role} {' / '.join(said[role])} s"
                          for role in ("follower", "leader"))
              + "; process walls from spawn to the end of its output: "
              + "; ".join(f"{role} {ended[role] - spawned[role]:.2f} s"
                          for role in ("follower", "leader"))
              + f" — card: {card}")

        # 4. the follower's path in-process: fetch, no lowering, kernels 1
        # and 2 once per served batch
        follower_cache = ProgramCache()
        prev = install(follower_cache)
        server = tp.ProgramServer(blob).start()
        try:
            tp.reset_metrics()
            fprog, _ = distribute_program(art, server.endpoint,
                                          role="follower", device=dev)
            check(fprog.fingerprint == prog.fingerprint,
                  "the fetched program's fingerprint differs")
            for latency, kname in ((False, "fused_event_lif_decode"),
                                   (True, "fused_event_lif_early_exit")):
                eng = SNNServeEngine(art, max_batch=SERVE_BATCH,
                                     latency_mode=latency)
                eng.reset_stats()
                torch.cuda.synchronize()
                reset_launches()
                for img in xte:
                    eng.submit(img)
                done = eng.flush()
                counts = launch_counts()
                st = eng.stats()
                eng.close()
                mode = "latency" if latency else "full-T"
                check(st["batches"] == 157, f"follower {mode}: "
                      f"{st['batches']} batches, expected 157")
                for k, n in counts.items():
                    want = st["batches"] if k == kname else 0
                    check(n == want, f"follower {mode}: {k} launched {n} "
                          f"times, expected {want}")
                launches[kname] += counts[kname]
                reqs = [done[r] for r in sorted(done)]
                labels = np.asarray([r.label for r in reqs], np.int32)
                steps = np.asarray([r.steps for r in reqs], np.int32)
                check(np.array_equal(labels, exp["labels_latency" if latency
                                                 else "labels"]),
                      f"follower {mode}: labels differ from JAX's")
                check(np.array_equal(steps, exp["steps_latency"]) if latency
                      else bool((steps == prog.T).all()),
                      f"follower {mode}: steps differ from JAX's")
                check(st["transport_fetches"] >= 1
                      and st["transport_fetch_failures"] == 0,
                      f"follower {mode}: transport stats "
                      f"{ {k: v for k, v in st.items() if 'transport' in k} }")
                print(f"[transport] follower in-process, {mode}: "
                      f"{len(reqs)} images, {kname} launched {counts[kname]} "
                      f"times over {st['batches']} batches, nothing else; "
                      f"labels and steps equal JAX's; system "
                      f"{st['system_us_per_image']:.2f} us/image; transport "
                      f"fetches {st['transport_fetches']}, failures "
                      f"{st['transport_fetch_failures']}, fetch p95 "
                      f"{st['transport_fetch_ms_p95']:.3f} ms — card: {card}")
            cs = follower_cache.stats()
            check(cs["program_misses"] == 0,
                  f"the follower lowered {cs['program_misses']} programs")
            # 5. a clean loopback fetch, timed
            fetch_ms = []
            for _ in range(FETCH_SAMPLES):
                t0 = time.perf_counter()
                got = tp.fetch_bytes(server.host, server.port)
                fetch_ms.append(1e3 * (time.perf_counter() - t0))
                check(got == blob, "a clean fetch returned other bytes")
        finally:
            server.stop()
            install(prev)
        fetch_ms.sort()
        print(f"[transport] clean loopback fetch of the {len(blob)}-byte "
              f"envelope: median {statistics.median(fetch_ms):.4f} ms, p95 "
              f"{fetch_ms[int(0.95 * len(fetch_ms))]:.4f} ms over "
              f"{FETCH_SAMPLES} fetches (host time) — card: {card}")

        # 6. the fault suite: detected or bit-exact, every scenario
        t0 = time.perf_counter()
        verdicts = run_suite(blob, art, prog.fingerprint,
                             stale_blob=envelopes["fuzz seed 0"][1],
                             device=dev)
        wall = time.perf_counter() - t0
        bad = [v for v in verdicts if not v["ok"]]
        check(len(verdicts) == len(SCENARIOS) == 27 and not bad,
              f"fault suite: {len(verdicts)} verdicts, failing: "
              + "; ".join(f"{v['scenario']}: expected {v['expect']}, got "
                          f"{v['outcome']} ({v['detail']})" for v in bad))
        n_det = sum(v["outcome"] == "detected" for v in verdicts)
        print(f"[transport] fault suite: {len(verdicts)}/27 scenarios ok "
              f"({n_det} detected, {len(verdicts) - n_det} bit-exact) in "
              f"{wall:.3f} s of wall — card: {card}")

    transport()

    # ------------------------------------------------------------- 3d lanes
    # worker lanes and resilience: threaded lanes on streams of their own at
    # full width, a closed loop, every resilience scenario on the card, the
    # board's dynamic fault plans, the canary and the static lowering pass
    # against JAX's, and 25/25 oracles (a function of its own, as 3b)
    def lanes() -> None:
        from repro_torch.core.lowering import lower_with_faults
        from repro_torch.faults import (Canary, FaultPlan, corrupt_artifact,
                                        integrity_errors)
        from repro_torch.kernels.common import KernelError

        t_phase = time.perf_counter()
        real_sync = torch.cuda.synchronize
        device_syncs = [0]

        def counting_sync(*args, **kw):
            device_syncs[0] += 1
            return real_sync(*args, **kw)

        default_stream = torch.cuda.default_stream(dev).cuda_stream
        # 1. threaded lanes at full width: every launch counter set to 0
        # before the scheduler is built (its lanes' warm-ups are launches of
        # the run) and read after its drain
        runs = [
            ("event-fused full-T", 1, "accelerator-event",
             {"kernel": "fused"}, {"fused_event_lif_decode": 1}),
            ("event-fused full-T", 2, "accelerator-event",
             {"kernel": "fused"}, {"fused_event_lif_decode": 1}),
            ("event-fused full-T", 4, "accelerator-event",
             {"kernel": "fused"}, {"fused_event_lif_decode": 1}),
            ("event-fused latency", 2, "accelerator-event",
             {"kernel": "fused", "latency_mode": True},
             {"fused_event_lif_early_exit": 1}),
            ("event-cuda full-T", 2, "accelerator-event", {"kernel": "cuda"},
             {"event_accum": 1, "lif_fused": 1, "ttfs_decode": 1}),
            ("batch-cuda", 2, "accelerator-batch", {"kernel": "cuda"},
             {"spike_matmul": 1, "lif_fused": 1, "ttfs_decode": 1}),
        ]
        for run, workers, spec, kw, per_batch in runs:
            torch.cuda.synchronize()
            reset_launches()
            device_syncs[0] = 0
            torch.cuda.synchronize = counting_sync
            try:
                t0 = time.perf_counter()
                s = ServingScheduler(art, spec=spec, workers=workers,
                                     max_batch=SERVE_BATCH, **kw)
                built = time.perf_counter() - t0
                t0 = time.perf_counter()
                rids = [s.submit(img) for img in xte]
                done = s.drain()
                wall = time.perf_counter() - t0
                counts = launch_counts()
                st = s.stats()
                streams = [lane.stream for lane in s.lanes]
                per_lane = [lane.batches_served for lane in s.lanes]
                s.close()
            finally:
                torch.cuda.synchronize = real_sync
            name = f"{run}, workers={workers}"
            check(device_syncs[0] == 0, f"{name}: the lanes synchronized the "
                  f"whole device {device_syncs[0]} times")
            handles = {x.cuda_stream for x in streams if x is not None}
            check(len(handles) == workers and default_stream not in handles,
                  f"{name}: lane streams {handles} are not {workers} streams "
                  f"of their own")
            batches = st["batches"]
            check(sum(per_lane) == batches and st["images_out"] == len(xte)
                  and st["errors"] == 0,
                  f"{name}: {st['images_out']} served in {batches} batches, "
                  f"{st['errors']} errors, per lane {per_lane}")
            for kname, n in counts.items():
                want = per_batch.get(kname, 0) * (batches + workers)
                check(n == want, f"{name}: {kname} launched {n} times for "
                      f"{batches} served batches and {workers} warm-ups, "
                      f"expected {want}")
                launches[kname] += n
            if "ttfs_decode" in per_batch:
                check(dec.ROUTES == {"warp": counts["ttfs_decode"],
                                     "block": 0},
                      f"{name}: ttfs_decode routes {dec.ROUTES}")
            if "spike_matmul" in per_batch:
                check(smm.ROUTES == {"tma": counts["spike_matmul"],
                                     "masked": 0},
                      f"{name}: spike_matmul routes {smm.ROUTES}")
            reqs = [done[r] for r in rids]
            labels = np.asarray([r.label for r in reqs], np.int32)
            steps = np.asarray([r.steps for r in reqs], np.int32)
            latency = kw.get("latency_mode", False)
            check(np.array_equal(labels, exp["labels_latency" if latency
                                             else "labels"]),
                  f"{name}: served labels differ from JAX's")
            check(np.array_equal(steps, exp["steps_latency"]) if latency
                  else bool((steps == prog.T).all()),
                  f"{name}: served steps differ from JAX's")
            print(f"[lanes] {name}: {len(reqs)} images in {wall:.3f} s wall "
                  f"({1e6 * wall / len(reqs):.2f} us/image; scheduler built "
                  f"in {built:.3f} s), system "
                  f"{st['system_us_per_image']:.2f} us/image, accelerator "
                  f"{st['accel_us_per_image']:.2f} us/image, latency p50 / "
                  f"p95 / p99 {st['p50_latency_us']:.1f} / "
                  f"{st['p95_latency_us']:.1f} / {st['p99_latency_us']:.1f} "
                  f"us, batch_fill_mean {st['batch_fill_mean']:.2f}, batches "
                  f"per lane {per_lane}, launches "
                  f"{ {k: counts[k] for k in per_batch} } (batches + "
                  f"{workers} warm-ups), {workers} streams of their own, 0 "
                  f"device-wide syncs — card: {card}")

        # 2. a closed loop: 8 clients, each submit -> result() in turn
        clients, per_client = 8, len(xte) // 8
        torch.cuda.synchronize()
        reset_launches()
        s = ServingScheduler(art, workers=2, max_batch=SERVE_BATCH,
                             kernel="fused")
        got = np.full(len(xte), -1, np.int32)
        errors = []

        def client(c):
            for i in range(c, clients * per_client, clients):
                req = s.result(s.submit(xte[i]), timeout=120.0)
                got[i] = req.label
            if got[c::clients].min() < 0:
                errors.append(c)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        alive = [t for t in threads if t.is_alive()]
        st = s.stats()
        per_lane = [lane.batches_served for lane in s.lanes]
        counts = launch_counts()
        s.close()
        check(not alive and not errors, f"closed loop: clients {errors} "
              f"failed, {len(alive)} still waiting")
        check(np.array_equal(got, exp["labels"]),
              "closed loop: labels differ from JAX's")
        want = st["batches"] + 2
        check(counts["fused_event_lif_decode"] == want
              and sum(counts.values()) == want,
              f"closed loop: launches {counts}, expected "
              f"fused_event_lif_decode {want} and nothing else")
        launches["fused_event_lif_decode"] += want
        print(f"[lanes] closed loop, {clients} clients x {per_client} "
              f"requests, workers=2: {wall:.3f} s wall, latency p50 / p95 / "
              f"p99 {st['p50_latency_us']:.1f} / {st['p95_latency_us']:.1f} "
              f"/ {st['p99_latency_us']:.1f} us, batch_fill_mean "
              f"{st['batch_fill_mean']:.2f}, batches per lane {per_lane}, "
              f"labels equal JAX's — card: {card}")

        # 3. faults on the card: every request completes with JAX's label or
        # an explicit error; the ledgers of tests/test_resilience.py
        def served(name, s, idx):
            """Serve images ``idx``; hold every request to JAX's label or
            an explicit error; returns (requests, stats)."""
            rids = [s.submit(xte[i]) for i in idx]
            done = s.drain()
            st = s.stats()
            s.close()
            reqs = [done[r] for r in rids]
            for r, i in zip(reqs, idx):
                check((r.error is None and r.label == exp["labels"][i])
                      or (r.error is not None and r.label is None),
                      f"{name}: request {r.rid} served label {r.label} "
                      f"(JAX's {exp['labels'][i]}), error {r.error}")
            print(f"[lanes] fault scenario {name}: {len(reqs)} requests, "
                  f"errors {st['errors']}, lane_faults {st['lane_faults']}, "
                  f"requeued {st['requeued']}, watchdog_timeouts "
                  f"{st['watchdog_timeouts']}, lane_restarts "
                  f"{st['lane_restarts']}, quarantines {st['quarantines']}, "
                  f"breaker_degraded {st['breaker_degraded']}, "
                  f"integrity_failures {st['integrity_failures']}, "
                  f"canary_failures {st['canary_failures']}, ecc_detected "
                  f"{st['ecc_detected']}, recovery_ms_mean "
                  f"{st['recovery_ms_mean']:.3f}, lane_health "
                  f"{st['lane_health']} — card: {card}")
            return reqs, st

        idx = np.arange(256)
        event = {"spec": "accelerator-event", "kernel": "fused",
                 "workers": 1, "max_batch": SERVE_BATCH}
        t_faults = time.perf_counter()
        reqs, st = served("crash and retry", ServingScheduler(
            art, faults="crash=0,seed=3", resilience={"backoff_s": 0.001},
            **event), idx)
        check(st["lane_faults"] >= 1 and st["requeued"] >= 1
              and st["lane_restarts"] >= 1 and st["recoveries"] >= 1
              and st["errors"] == 0 and st["recovery_ms_mean"] > 0
              and any(r.attempts > 0 for r in reqs),
              "crash and retry: the ledger shows no round trip")
        reqs, st = served("startup SEU scrubbed", ServingScheduler(
            art, faults="seu_weight=4,seed=5",
            resilience={"backoff_s": 0.001}, **event), idx)
        check(st["integrity_failures"] >= 1 and st["lane_restarts"] >= 1
              and st["errors"] == 0
              and not any(r.fallback_dense for r in reqs),
              "startup SEU: not scrubbed before service")
        reqs, st = served("watchdog replaces a hung lane", ServingScheduler(
            art, faults=FaultPlan(seed=7, hang_batches=(0,), hang_s=1.5),
            resilience={"watchdog_s": 0.2, "backoff_s": 0.001}, **event), idx)
        check(st["watchdog_timeouts"] >= 1 and st["requeued"] >= 1
              and st["lane_restarts"] >= 1 and st["errors"] == 0
              and st["images_out"] == len(idx),
              "watchdog: the hung lane was not replaced")
        persistent = {"seu_weight_flips": 4, "persistent": True, "seed": 9}
        reqs, st = served("persistent SEU degrades", ServingScheduler(
            art, faults=persistent, resilience={"backoff_s": 0.001},
            **event), idx)
        check(st["quarantines"] >= 1 and st["breaker_degraded"] >= 1
              and st["errors"] == 0 and all(r.fallback_dense for r in reqs)
              and "degraded" in st["lane_health"],
              "persistent SEU: not quarantined and degraded")
        s = ServingScheduler(art, faults=persistent,
                             resilience={"backoff_s": 0.001,
                                         "degrade": False}, **event)
        try:
            s.submit(xte[0])
            refused = None
        except RuntimeError as e:
            refused = str(e)
        quarantines = s.stats()["quarantines"]
        s.close()
        check(refused is not None and "quarantined" in refused
              and quarantines >= 1,
              f"no-degrade: admission not refused ({refused})")
        print(f"[lanes] fault scenario no-degrade: admission refused "
              f"({refused}), quarantines {quarantines}")
        reqs, st = served("breaker stops crash flapping", ServingScheduler(
            art, faults=FaultPlan(seed=11, crash_batches=(0,),
                                  persistent=True),
            resilience={"backoff_s": 0.001, "max_retries": 4,
                        "breaker_threshold": 2}, **event), idx)
        check(st["breaker_degraded"] >= 1 and st["errors"] == 0
              and any(r.fallback_dense for r in reqs),
              "breaker: the crash flapping was not stopped")
        board = {"spec": "board-py", "workers": 1, "max_batch": 8}
        reqs, st = served("stuck group caught by the canary",
                          ServingScheduler(
                              art, faults="stuck=1,seed=13",
                              canary_pool=xte[:32],
                              resilience={"startup_checks": False,
                                          "verify": True, "canary_every": 1,
                                          "backoff_s": 0.001}, **board),
                          idx[:32])
        check(st["canary_failures"] >= 1 and st["lane_faults"] >= 1
              and st["lane_restarts"] >= 1 and st["errors"] == 0,
              "stuck group: not caught by the canary")
        # seed 7 reaches the ECC readout on this artifact; at seed 15 JAX's
        # upset flips bit 31 of a negative membrane in the first batch and
        # raises (ROADMAP §3), and so does the port's: a lane fault, served
        # after the rebuild, the ledger of tests/test_torch_resilience.py
        reqs, st = served("membrane SEU caught by ECC", ServingScheduler(
            art, faults="membrane=0.9,seed=7",
            resilience={"startup_checks": False, "verify": True,
                        "backoff_s": 0.001},
            **{**board, "max_batch": 2}), idx[:4])
        check(st["ecc_detected"] >= 1 and st["lane_restarts"] >= 1
              and st["errors"] == 0, "membrane SEU: not caught by ECC")
        reqs, st = served("membrane upset raises", ServingScheduler(
            art, faults="membrane=0.9,seed=15",
            resilience={"startup_checks": False, "verify": True,
                        "backoff_s": 0.001}, **board), idx[:32])
        check(st["lane_faults"] == 1 and st["lane_restarts"] == 1
              and st["requeued"] == 8 and st["ecc_detected"] == 0
              and st["errors"] == 0, "membrane upset: not JAX's ledger")
        # a kernel that fails to launch is not a lane fault: the scheduler
        # raises, and nothing is served around it on the dense path
        real_lib = ops._lib
        failing = types.SimpleNamespace(
            fused_event_lif_decode=lambda *args: 1)   # cudaErrorInvalidValue
        s = ServingScheduler(art, **event)
        ops._lib = lambda: failing
        try:
            rids = [s.submit(xte[i]) for i in range(8)]
            done = s.drain()
            try:
                s.submit(xte[0])
                refused = None
            except RuntimeError as e:
                refused = e
            st = s.stats()
            s.close()
            try:
                ServingScheduler(art, **{**event, "workers": 0})
                inline = None
            except KernelError as e:
                inline = str(e)
        finally:
            ops._lib = real_lib
        check(all(done[r].error is not None and done[r].label is None
                  and not done[r].fallback_dense
                  and "launch failed with CUDA error 1" in done[r].error
                  for r in rids)
              and isinstance(getattr(refused, "__cause__", None), KernelError)
              and st["breaker_degraded"] == 0 and st["lane_restarts"] == 0
              and st["quarantines"] == 0 and inline is not None,
              f"kernel failure: served around or not raised ({refused!r}, "
              f"{inline!r}, {st['lane_health']})")
        print(f"[lanes] fault scenario kernel failure: {len(rids)} requests "
              f"failed with {done[rids[0]].error!r}; submit raised; inline "
              f"commission raised {inline!r}; breaker_degraded 0, "
              f"lane_restarts 0")
        print(f"[lanes] fault scenarios: {time.perf_counter() - t_faults:.3f}"
              f" s of wall — card: {card}")

        # board-py under every dynamic plan, the canary and the static
        # lowering pass, held to JAX's (src/repro_torch/assets/
        # faults_expected.npz)
        fexp = dict(np.load(os.path.join(ASSETS, "faults_expected.npz")))
        cases = {"mnist": (art, xte[:64])}
        for seed, fart, _, images, _ in fuzz:
            cases[f"fuzz{seed}"] = (fart, images)
        n_runs = n_raised = 0
        t0 = time.perf_counter()
        for case, (a, images) in cases.items():
            for i, spec in enumerate(fexp["dynamic_plans"]):
                for mode, latency in (("full", False), ("latency", True)):
                    key = f"board_{case}_{i}_{mode}"
                    rt = make_runtime(a, "board-py", latency_mode=latency,
                                      faults=str(spec), device=dev)
                    n_runs += 1
                    if f"{key}_jax_raises" in fexp:
                        # JAX's membrane upset raised here (bit 31 of a
                        # negative membrane, ROADMAP §3): the port raises the
                        # same error, naming the same word
                        n_raised += 1
                        try:
                            rt.forward(images)
                            raised = None
                        except OverflowError as e:
                            raised = str(e)
                        check(raised == str(fexp[f"{key}_jax_raises"]),
                              f"{key}: raised {raised!r}, JAX raised "
                              f"{fexp[f'{key}_jax_raises']!r}")
                        continue
                    out = rt.forward(images)
                    got = {"labels": out.labels.cpu().numpy(),
                           "steps": out.steps.cpu().numpy(),
                           "ecc": rt.last_ecc,
                           "stuck": np.asarray(rt.stuck_groups, np.int64)}
                    for k in BOARD_TRACE:
                        got[k] = getattr(rt.last_trace, k)
                    for k, v in got.items():
                        check(v.dtype == fexp[f"{key}_{k}"].dtype
                              and np.array_equal(v, fexp[f"{key}_{k}"]),
                              f"{key}: {k} differs from JAX's ({spec})")
                    for k, v in (("first_spike", out.first_spike),
                                 ("v_final", out.v_final),
                                 ("tick_counts", rt.last_tick_counts)):
                        v = v.cpu().numpy() if hasattr(v, "cpu") else v
                        check(sha256(v) == str(fexp[f"{key}_{k}_sha256"]),
                              f"{key}: {k} differs from JAX's ({spec})")
            canary = Canary.from_program(lower(a, device=dev), pool=images)
            check(canary.images.tobytes()
                  == fexp[f"canary_{case}_images"].tobytes()
                  and np.array_equal(canary.want, fexp[f"canary_{case}_want"])
                  and list(canary.covered_groups)
                  == fexp[f"canary_{case}_covered"].tolist(),
                  f"{case}: the canary differs from JAX's")
            pristine = lower(a, device=dev)
            for i, spec in enumerate(fexp["static_plans"]):
                plan = FaultPlan.parse(str(spec))
                key = f"corrupt_{case}_{i}"
                bad = corrupt_artifact(a, plan)
                check(bad.fingerprint() == str(fexp[f"{key}_fingerprint"])
                      and integrity_errors(bad) == json.loads(
                          str(fexp[f"{key}_errors"])),
                      f"{key}: the corrupted clone differs from JAX's")
                for name, arr in a.arrays.items():
                    flat = bad.arrays[name].reshape(-1)
                    diff = np.nonzero(arr.reshape(-1) != flat)[0]
                    if f"{key}_{name}_idx" in fexp:
                        check(np.array_equal(diff, fexp[f"{key}_{name}_idx"])
                              and np.array_equal(flat[diff],
                                                 fexp[f"{key}_{name}_val"]),
                              f"{key}: {name} flips differ from JAX's")
                    else:
                        check(diff.size == 0, f"{key}: {name} flipped")
                cprog = lower_with_faults(pristine, plan, device=dev)
                check(cprog.device == dev and cprog.fingerprint
                      != pristine.fingerprint
                      and all(np.array_equal(
                          getattr(cprog, n).cpu().numpy(),
                          cprog.artifact[n]) and np.array_equal(
                          getattr(pristine, n).cpu().numpy(), a[n])
                          for n in ("w_int8", "thresholds", "w_padded",
                                    "thr_padded")),
                      f"{key}: the clone's tensors are not its corrupted "
                      f"arrays, or the pristine program moved")
        print(f"[lanes] board-py under {len(fexp['dynamic_plans'])} dynamic "
              f"plans x 2 modes on {len(cases)} cases ({n_runs} runs, MNIST "
              f"on 64 images): outputs, traces, tick histograms, last_ecc "
              f"and stuck groups equal JAX's ({n_raised} runs where JAX's "
              f"membrane upset raised: the port raised JAX's error); "
              f"canaries and "
              f"{len(fexp['static_plans'])} static plans' corrupted clones "
              f"equal JAX's, each lowered on the card from its corrupted "
              f"arrays; {time.perf_counter() - t0:.3f} s — card: {card}")

        # 4. conformance: 25/25 oracles on each pinned seed (phase 3b's run)
        check(sorted(conformance) == sorted(s for s, *_ in fuzz),
              f"conformance reports for seeds {sorted(conformance)}")
        for seed, rep in conformance.items():
            check(rep.passed and not rep.not_ported
                  and len(rep.outcomes) == 25
                  and any(o.oracle == "fault-recovery" for o in rep.outcomes),
                  f"fuzz seed {seed}: {rep.summary()}")
        print(f"[lanes] run_case on the card (phase 3b): 25/25 oracles on "
              f"each of seeds {sorted(conformance)}, fault-recovery "
              f"included, none unported")
        print(f"[lanes] phase wall {time.perf_counter() - t_phase:.3f} s — "
              f"card: {card}")

    lanes()

    # ------------------------------------------------------------- 4 overflow
    meta = copy.deepcopy(art.meta)
    meta["events"]["e_max"] = 8
    small = Artifact(meta, dict(art.arrays))
    for kernel in ("fused", "cuda"):
        eng = SNNServeEngine(small, max_batch=SERVE_BATCH, kernel=kernel)
        got = eng.classify(xte[:SERVE_BATCH])
        st = eng.stats()
        eng.close()
        check(st["overflow_fallbacks"] > 0, "e_max=8 rerouted no row")
        check(np.array_equal(got, exp["labels"][:SERVE_BATCH]),
              f"rerouted labels differ from the reference ({kernel})")
        print(f"[overflow] e_max=8, kernel={kernel}: "
              f"{st['overflow_fallbacks']} of {SERVE_BATCH} rows rerouted to "
              f"the dense path, labels equal the reference")

    # ---------------------------------------------------------------- 4b board
    bexp = dict(np.load(os.path.join(ASSETS, "mnist_board_expected.npz")))
    check(str(bexp["images_sha256"]) == sha256(xte)
          and str(bexp["artifact_fingerprint"]) == art.fingerprint(),
          "mnist_board_expected.npz was not written for these images and "
          "this artifact")
    board_arts = {"": art, "_emax8": small}      # small: phase 4's e_max 8

    def board_trace_check(key: str, traces: list, what: str) -> dict:
        """The per-image trace fields of ``traces`` (BoardTraces in image
        order) against the JAX board's digests and totals."""
        fields = {}
        for f in BOARD_TRACE:
            a = np.concatenate([getattr(tr, f) for tr in traces])
            check(a.dtype == (np.float64 if f == "energy_nj" else np.int64)
                  and sha256(a) == str(bexp[f"{key}_{f}_sha256"])
                  and np.sum(a) == bexp[f"{key}_{f}_total"],
                  f"{what}: board trace {f} differs from the JAX board's")
            fields[f] = a
        return fields

    def board_outputs_check(key: str, outs: dict, what: str) -> None:
        for f in BOARD_OUTPUTS:
            check(sha256(outs[f]) == str(bexp[f"{key}_{f}_sha256"]),
                  f"{what}: board {f} differs from the JAX board's")

    def same_board(got, got_rt, want, want_rt, what: str) -> None:
        """Every output and every trace field equal."""
        same(got, want, f"{what}: outputs differ")
        for f in BOARD_TRACE + ("synops",):
            check(np.array_equal(getattr(got_rt.last_trace, f),
                                 getattr(want_rt.last_trace, f)),
                  f"{what}: trace {f} differs")

    # the served runs: SNNServeEngine(backend="board", kernel="cuda") over
    # the 10,000 images, every launch counter set to 0 just before the
    # requests and read just after the flush; the runtime's outputs and
    # trace are captured a batch at a time, the pad rows dropped
    board_runs = {}
    for suffix, a in board_arts.items():
        for mode in ("full", "latency"):
            key = mode + suffix
            eng = SNNServeEngine(a, max_batch=SERVE_BATCH, backend="board",
                                 kernel="cuda", latency_mode=mode == "latency")
            rt = eng.accel
            check(rt.kernel == "cuda" and rt.device == dev,
                  f"board {key}: the engine's runtime is not board-batched-"
                  f"cuda on the card")
            captured = []
            forward = rt.forward

            def capture(images, forward=forward, rt=rt, captured=captured):
                out = forward(images)
                captured.append((out, rt.last_trace))
                return out
            rt.forward = capture
            eng.reset_stats()
            reset_launches()
            t0 = time.perf_counter()
            for img in xte:
                eng.submit(img)
            done = eng.flush()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            st = eng.stats()
            eng.close()
            reqs = [done[r] for r in sorted(done)]
            batches = st["batches"]
            check(batches == len(captured) == -(-len(xte) // SERVE_BATCH),
                  f"board {key}: {batches} batches served, {len(captured)} "
                  f"forwards")
            want = {"lif_fused": batches if mode == "full" else 0}
            for kname, n in counts.items():
                check(n == want.get(kname, 0), f"board {key}: {kname} "
                      f"launched {n} times for {batches} served batches, "
                      f"expected {want.get(kname, 0)}")
            if key == "full":
                launches["lif_fused"] += counts["lif_fused"]
            ks = [min(SERVE_BATCH, len(xte) - i)
                  for i in range(0, len(xte), SERVE_BATCH)]
            outs = {f: np.concatenate([getattr(o, f).cpu().numpy()[:k]
                                       for (o, _), k in zip(captured, ks)])
                    for f in BOARD_OUTPUTS}
            traces = [BoardTrace(*(getattr(tr, f.name)[:k]
                                   for f in dataclasses.fields(BoardTrace)))
                      for (_, tr), k in zip(captured, ks)]
            board_outputs_check(key, outs, f"board {key}")
            fields = board_trace_check(key, traces, f"board {key}")
            labels = np.asarray([r.label for r in reqs], np.int32)
            steps = np.asarray([r.steps for r in reqs], np.int32)
            check(np.array_equal(labels, outs["labels"])
                  and np.array_equal(steps, outs["steps"]),
                  f"board {key}: served labels or steps differ from the "
                  f"runtime's")
            check(np.array_equal(labels, exp["labels_latency" if mode ==
                                             "latency" else "labels"]),
                  f"board {key}: labels differ from the JAX reference's")
            check(np.array_equal(steps, exp["steps_latency"])
                  if mode == "latency" else bool((steps == prog.T).all()),
                  f"board {key}: steps differ from the JAX reference's")
            nj = sum(float(np.sum(tr.energy_nj)) for tr in traces)
            check(st["board_cycles"] == int(fields["cycles"].sum())
                  and st["board_stalls"] == int(fields["stalls"].sum())
                  and st["board_nj_per_image"] == nj / len(xte)
                  and st["overflow_fallbacks"] == 0
                  and st["images_out"] == len(xte),
                  f"board {key}: stats differ from the served traces: "
                  f"{json.dumps(st, sort_keys=True)}")
            check((st["board_stalls"] > 0) == (suffix == "_emax8"),
                  f"board {key}: {st['board_stalls']} stalls")
            board_runs[key] = st
            print(f"[board] {key}: {len(reqs)} images in {wall:.3f} s wall, "
                  f"accuracy {np.mean(labels == yte):.4f}, launches "
                  f"{ {k: n for k, n in counts.items() if n} } over "
                  f"{batches} batches; cost model: "
                  f"{st['board_cycles_per_image']:.4f} cycles/image, "
                  f"{st['board_model_us_per_image']:.4f} modelled PL us/image "
                  f"at 80 MHz (cycles / clock, not time on the card), "
                  f"{st['board_nj_per_image']:.4f} nJ/image, "
                  f"{st['board_stalls']} stalls, "
                  f"{np.mean(fields['ticks']):.4f} ticks/image; on the card: "
                  f"system {st['system_us_per_image']:.2f} us/image, "
                  f"accelerator {st['accel_us_per_image']:.2f} us/image "
                  f"— card: {card}")
            print(f"[board] {key} stats: {json.dumps(st, sort_keys=True)}")

    # kernel 5 at the board's own call: the (T, B, N_pad) movedim view of
    # the board's currents for the first served batch
    bb = make_runtime(prog, "board-batched-cuda", device=dev)
    btimes = encode_ttfs(torch.from_numpy(xte[:SERVE_BATCH]).to(dev), prog.T,
                         prog.x_min)
    bview = spike_currents(frames_from_times(btimes, prog.T),
                           bb._w_f32).movedim(1, 0)
    check(not bview.is_contiguous(), "the board's currents view is "
          "contiguous: the strided read is not exercised")
    hold("lif_fused", lif.lif_fused(bview, prog.thr_padded, prog.leak_shift),
         lif_scan(bview, prog.thr_padded, prog.leak_shift, prog.T),
         "the board's currents view")

    # where a served board batch's time goes: ten full-T and ten latency
    # forwards of SERVE_BATCH images each under torch.profiler
    chunks = [xte[i:i + SERVE_BATCH]
              for i in range(0, 10 * SERVE_BATCH, SERVE_BATCH)]
    for mode in ("full-T", "latency"):
        rt = make_runtime(prog, "board-batched-cuda", device=dev,
                          latency_mode=mode == "latency")
        rt.forward(chunks[0])
        show_profile(f"board {mode}, 10 batches of {SERVE_BATCH}",
                     profile(lambda: [rt.forward(c) for c in chunks]), card)

    # the plain version against the kernel, every output and trace field,
    # over the 10,000 images in chunks of 1,000; the audit path (board-py,
    # the host tick loop) against the kernel on the first 1,000, in both
    # modes and with the FIFO stalling
    for suffix, a in board_arts.items():
        for mode in ("full", "latency"):
            lat = mode == "latency"
            cuda = make_runtime(a, "board-batched-cuda", device=dev,
                                latency_mode=lat)
            if suffix == "" and not lat:
                plain = make_runtime(a, "board-batched-torch", device=dev)
                for i in range(0, len(xte), 1000):
                    same_board(plain.forward(xte[i:i + 1000]), plain,
                               cuda.forward(xte[i:i + 1000]), cuda,
                               f"board-batched-torch vs -cuda, images {i}+")
            py = make_runtime(a, "board-py", device=dev, latency_mode=lat)
            t0 = time.perf_counter()
            got = py.forward(xte[:1000])
            py_s = time.perf_counter() - t0
            same_board(got, py, cuda.forward(xte[:1000]), cuda,
                       f"board-py vs board-batched-cuda, {mode}{suffix}")
            print(f"[board] board-py equals board-batched-cuda on the first "
                  f"1,000 images, {mode}{suffix}: outputs and every trace "
                  f"field ({1e3 * py_s / 1000:.2f} ms/image on the host tick "
                  f"loop)")
    print("[board] board-batched-torch equals board-batched-cuda on the "
          "card over 10,000 images, full-T: outputs and every trace field")
    for seed, fart, fprog, images, golden in fuzz:
        rt = make_runtime(fprog, "board-batched-cuda", device=dev)
        out = rt.forward(images)
        for key in ("labels", "first_spike", "v_final", "steps"):
            check(np.array_equal(getattr(out, key).cpu().numpy(), golden[key]),
                  f"fuzz seed {seed}: board-batched-cuda {key} differs from "
                  f"golden")
        for key, f in (("board_cycles", "cycles"), ("board_events", "events"),
                       ("board_stalls", "stalls"),
                       ("board_energy_nj", "energy_nj")):
            check(np.array_equal(getattr(rt.last_trace, f), golden[key]),
                  f"fuzz seed {seed}: board-batched-cuda {key} differs from "
                  f"golden")
    print(f"[board] fuzz seeds {manifest['seeds']}: board-batched-cuda "
          f"equals tests/golden/ in every output and board_* array")

    # the paper's agreement protocol on the card: four runtimes against the
    # reference over the 10,000 images, then five repeated runs
    rep = full_agreement(art, xte, yte, runtimes=(
        "accelerator-batch-cuda", "accelerator-event-fused",
        "accelerator-event-cuda", "board-batched-cuda"), device=dev)
    print("[board] " + rep.summary().replace("\n", "\n[board] "))
    check(rep.exact_match and rep.n_images == len(xte),
          "full_agreement over the 10,000 images is not exact")
    rpt = repeatability(art, xte, yte, runs=5, device=dev)
    print(f"[board] repeatability: {json.dumps(rpt)}")
    check(rpt["mismatches"] == 0 and rpt["image_run_pairs"] == 50_000
          and rpt["accuracy_stable"],
          "repeatability over 5 runs of 10,000 images is not 0 / 50,000")

    # the dense Table-3 baselines on the card: their labels against the JAX
    # reference's, and the device time of one call on all 10,000 images
    # (CUDA events, median of 10 after 3 warm calls; images on the card)
    dref = SNNReference(art, device=dev)
    xdev = torch.from_numpy(xte).to(dev)
    for mode in ("fp32", "int8"):
        labels = dref.dense_labels(xdev, mode).cpu().numpy()
        check(sha256(labels) == str(bexp[f"dense_{mode}_labels_sha256"]),
              f"dense {mode} labels differ from the JAX reference's")
        for _ in range(3):
            dref.dense_labels(xdev, mode)
        samples = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dref.dense_labels(xdev, mode)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        ms = statistics.median(samples)
        print(f"[board] dense {mode} baseline: accuracy "
              f"{np.mean(labels == yte):.4f} (JAX {float(bexp[f'dense_{mode}_accuracy']):.4f}), "
              f"labels equal the JAX reference's; one call on 10,000 images "
              f"{ms:.4f} ms on the card, {1e3 * ms / len(xte):.6f} us/image "
              f"— card: {card}")

    # ------------------------------------------------- 5 attention vs plain
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 compared below
    torch.backends.cudnn.allow_tf32 = False
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def attn_inputs(B, Hq, Hkv, Sq, Skv, D, dtype, layout, seed):
        """q, k, v on the card from a seeded generator, laid out as
        ``layout`` says (ATTN_CASES, ATTN_SPLIT_TF32_CASES)."""
        g = torch.Generator(dev).manual_seed(seed)
        out = []
        for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)):
            def draw(*shape):
                return torch.randn(shape, generator=g, device=dev).to(dtype)
            if layout == "decode cross":
                t = draw(B, S, H, D).movedim(1, 2) if not out else \
                    draw(B, H, S, D)
            elif layout == "contiguous":
                t = draw(B, H, S, D)
            elif layout == "movedim view":
                t = draw(B, S, H, D).movedim(1, 2)
            elif layout == "padded row":
                t = draw(B, H, S, D + 1)[..., :D]
            elif layout == "misaligned storage_offset":
                t = draw(B * H * S * D + 1)[1:].view(B, H, S, D)
            else:
                check(layout == "d stride 2", f"unknown layout {layout}")
                t = draw(B, H, S, 2 * D)[..., ::2]
            out.append(t)
        return out

    def tile_rel_err(got, want) -> float:
        """The largest ||got - want|| / ||want|| over the 128-row q tiles of
        every batch row and head."""
        B, H, S, D = want.shape
        pad = (0, 0, 0, -S % 128)
        diff = F.pad(got.float() - want.float(), pad).reshape(B, H, -1,
                                                             128 * D)
        want = F.pad(want.float(), pad).reshape(B, H, -1, 128 * D)
        return float((diff.norm(dim=-1)
                      / want.norm(dim=-1).clamp_min(1e-30)).max())

    def skipped_tile(q, k, v, kw, want):
        """``want`` with the rows of the last q tile recomputed by the plain
        version as if the first key tile they see (128 keys) were skipped:
        the fault the relative check must catch. None where no key would be
        left to them."""
        Sq, Skv = q.shape[2], k.shape[2]
        r = Sq - (Sq - 1) // 128 * 128              # rows of the last tile
        first_q = kw.get("q_offset", 0) + Sq - r
        window, kv_len = kw.get("window"), kw.get("kv_len")
        lo = max(0, first_q - window + 1) if window else 0
        cut = (lo // 128 + 1) * 128
        if cut >= Skv:
            return None
        out = want.clone()
        out[:, :, Sq - r:] = fa_ref.flash_attention_ref(
            q[:, :, Sq - r:], k[:, :, cut:], v[:, :, cut:],
            causal=kw.get("causal", True), window=window,
            q_offset=first_q - cut,
            kv_len=None if kv_len is None else kv_len - cut)
        return out

    def hold_attention(kname, what, dname, q, k, v, kw, got, seen) -> str:
        """``got`` against the plain version on the same inputs, element by
        element and by the relative error norm of each q tile, with the
        planted fault read by the same check; returns the readings and keeps
        the largest relative error and the smallest fault in ``seen``."""
        tol, rel_tol = ATTN_TOL[dname], ATTN_REL_TOL[dname]
        want = fa_ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(got.shape == q.shape and got.dtype == q.dtype,
              f"{kname} {what} {dname}: shape or dtype")
        err = float((got.float() - want.float()).abs().max())
        max_err[kname] = max(max_err[kname], err)
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"{kname} differs from its plain version on {what} {dname} "
              f"(max |err| {err:.3g}, tolerance {tol})")
        rel = tile_rel_err(got, want)
        seen[0] = max(seen[0], rel)
        check(rel <= rel_tol, f"{kname} differs from its plain version on "
              f"{what} {dname}: relative error norm of a q tile {rel:.3g}, "
              f"limit {rel_tol}")
        fault = skipped_tile(q, k, v, kw, want)
        fault_txt = "no fault planted (no key tile to skip)"
        if fault is not None:
            fault_rel = tile_rel_err(fault, want)
            seen[1] = min(seen[1], fault_rel)
            check(fault_rel > rel_tol, f"{what} {dname}: a skipped key tile "
                  f"reads {fault_rel:.3g}, within the limit {rel_tol}")
            fault_txt = f"a skipped key tile reads {fault_rel:.3g}"
            del fault
        return (f"max |err| {err:.3g} (tolerance {tol}), q tile relative "
                f"error norm {rel:.3g} (limit {rel_tol}; {fault_txt})")

    cases = [(case, dname, ATTN_ROUTE[dname], shape)
             for dname in ATTN_TOL for case, shape in ATTN_CASES.items()]
    cases += [(case, dname, "flash_attention", shape) for dname in ATTN_TOL
              for case, shape in ATTN_SPLIT_TF32_CASES.items()]
    for kname in ATTN_ROUTE.values():
        max_err[kname] = 0.0
    rel_seen = {dname: [0.0, float("inf")] for dname in ATTN_TOL}
    lse_seen = {kname: 0.0 for kname in ATTN_ROUTE.values()}

    def hold_lse(kname, what, q, k, v, kw, got) -> str:
        """The forward asked for its row statistic: the same output bit for
        bit, and the statistic against the plain version's (ATTN_LSE_TOL on
        the rows that see a key, +inf exactly where none is seen)."""
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        check(torch.equal(out, got), f"{kname} {what}: the output differs "
              f"when the row statistic is asked for")
        _, want = fa_ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        seen = torch.isfinite(want)
        check(lse.shape == q.shape[:3] and lse.dtype == torch.float32,
              f"{kname} {what}: statistic shape or dtype")
        check(torch.equal(torch.isposinf(lse), ~seen), f"{kname} {what}: "
              f"the statistic is not +inf exactly on the rows that see no "
              f"key")
        err = float((lse - want)[seen].abs().max()) if seen.any() else 0.0
        check(torch.allclose(lse[seen], want[seen], rtol=ATTN_LSE_TOL,
                             atol=ATTN_LSE_TOL),
              f"{kname} {what}: row statistic differs from the plain "
              f"version's by {err:.3g} (tolerance {ATTN_LSE_TOL})")
        lse_seen[kname] = max(lse_seen[kname], err)
        return (f"statistic max |err| {err:.3g} (tolerance {ATTN_LSE_TOL}), "
                f"{int((~seen).sum())} +inf rows, output bitwise equal with "
                f"it asked for")
    for case, dname, kname, (B, Hq, Hkv, Sq, Skv, D, causal, window, qoff,
                             kv_len, layout) in cases:
        q, k, v = attn_inputs(B, Hq, Hkv, Sq, Skv, D, dtypes[dname], layout,
                              Sq + Skv)
        kw = dict(causal=causal, window=window, q_offset=qoff, kv_len=kv_len)
        check(fa.route(q, k, v) == kname, f"flash_attention {case} {dname} "
              f"routes to {fa.route(q, k, v)}, not {kname}")
        reset_launches()
        got = fa.flash_attention(q, k, v, **kw)
        counts = launch_counts()
        check(counts == {**{n: 0 for n in KERNELS}, kname: 1},
              f"flash_attention {case} {dname} launched {counts}, expected "
              f"{kname} once")
        readings = hold_attention(kname, case, dname, q, k, v, kw, got,
                                  rel_seen[dname])
        readings += "; " + hold_lse(kname, f"{case} {dname}", q, k, v, kw,
                                    got)
        if case == "no visible key":
            tol = ATTN_TOL[dname]
            mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(
                Hq // Hkv, dim=1).expand(got.shape)
            check(torch.allclose(got.float(), mean, rtol=tol, atol=tol),
                  f"flash_attention {dname}: a query that sees no key must "
                  f"get the mean of v")
        print(f"[attention] {case} {dname} on {kname}: B={B} Hq={Hq} "
              f"Hkv={Hkv} Sq={Sq} Skv={Skv} D={D} causal={causal} "
              f"window={window} q_offset={qoff} kv_len={kv_len} "
              f"layout={layout}: {readings}")
        del q, k, v, got
    for dname, (worst, least_fault) in rel_seen.items():
        print(f"[attention] {dname}: largest q tile relative error norm "
              f"{worst:.3g}, smallest planted fault {least_fault:.3g}, limit "
              f"{ATTN_REL_TOL[dname]}")
    for kname, worst in lse_seen.items():
        print(f"[attention] {kname} row statistic: largest |err| "
              f"{worst:.3g} against the plain version's (tolerance "
              f"{ATTN_LSE_TOL}) on every case; outputs bitwise equal with "
              f"and without it")

    # ------------------------------------ 5b attention's backward vs plain
    def bwd_inputs(B, Hq, Hkv, Sq, Skv, D, dtype, layout, seed):
        """q, k, v as ``attn_inputs`` lays them out, and dout drawn in q's
        layout (the gradient autograd hands the kernel comes back through
        the model's views the same way)."""
        q, k, v = attn_inputs(B, Hq, Hkv, Sq, Skv, D, dtype, layout, seed)
        dout = attn_inputs(B, Hq, Hq, Sq, 1, D, dtype, layout, seed + 1)[0]
        return q, k, v, dout

    def hold_backward(what, dname, q, k, v, out, lse, dout, kw, got,
                      seen) -> str:
        """The kernel's (dq, dk, dv) against the plain version on the same
        inputs (which builds its own softmax, not reading ``lse``), element
        by element and by the relative error norm of each 128-row tile (q
        rows for dq, keys for dk and dv), with two planted faults read by
        the same check: pass B skipping the first key tile (its dk and dv
        never written), and the kernel run on the forward's statistic with
        the last q tile's rows shifted by ATTN_LSE_FAULT; keeps the largest
        relative error and the smallest fault in ``seen``."""
        tol, rel_tol = ATTN_BWD_TOL[dname], ATTN_BWD_REL_TOL[dname]
        want = fa_ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
        torch.cuda.synchronize()
        errs, rels = [], []
        for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
            check(g.shape == x.shape and g.dtype == x.dtype,
                  f"flash_attention_bwd {what} {dname}: {name} shape or dtype")
            err = float((g.float() - w.float()).abs().max())
            check(torch.allclose(g.float(), w.float(), rtol=tol, atol=tol),
                  f"flash_attention_bwd differs from its plain version on "
                  f"{what} {dname}: {name} max |err| {err:.3g}, tolerance "
                  f"{tol}")
            rel = tile_rel_err(g, w) if w.float().norm() > 0 else 0.0
            check(rel <= rel_tol, f"flash_attention_bwd differs from its "
                  f"plain version on {what} {dname}: {name} tile relative "
                  f"error norm {rel:.3g}, limit {rel_tol}")
            errs.append(err)
            rels.append(rel)
        max_err["flash_attention_bwd"] = max(max_err["flash_attention_bwd"],
                                             *errs)
        seen[0] = max(seen[0], *rels)
        fault = [w.clone() for w in want[1:]]
        for f in fault:
            f[:, :, :32] = 0
        fault_rel = max(tile_rel_err(f, w) for f, w in zip(fault, want[1:])
                        if w.float().norm() > 0)
        seen[1] = min(seen[1], fault_rel)
        check(fault_rel > rel_tol, f"{what} {dname}: a skipped key tile in "
              f"pass B reads {fault_rel:.3g}, within the limit {rel_tol}")
        # the statistic's fault: the last 128-row q tile's rows shifted
        Sq = q.shape[2]
        last = slice(Sq - (Sq - (Sq - 1) // 128 * 128), Sq)
        shifted = lse.clone()
        shifted[:, :, last] += ATTN_LSE_FAULT[dname]
        if torch.isfinite(lse[:, :, last]).any():
            bad = fa.flash_attention_bwd(q, k, v, out, shifted, dout, **kw)
            lse_rel = max(tile_rel_err(f, w) for f, w in zip(bad, want)
                          if w.float().norm() > 0)
            check(lse_rel > rel_tol, f"{what} {dname}: the statistic's last "
                  f"tile shifted by {ATTN_LSE_FAULT[dname]} reads "
                  f"{lse_rel:.3g}, within the limit {rel_tol}")
            seen[1] = min(seen[1], lse_rel)
            lse_txt = (f"the last tile's statistic shifted by "
                       f"{ATTN_LSE_FAULT[dname]} reads {lse_rel:.3g}")
            del bad
        else:
            lse_txt = "no statistic fault planted (the last tile sees no key)"
        return (f"max |err| dq {errs[0]:.3g} dk {errs[1]:.3g} dv "
                f"{errs[2]:.3g} (tolerance {tol}), tile relative error norm "
                f"{max(rels):.3g} (limit {rel_tol}; a skipped key tile in "
                f"pass B reads {fault_rel:.3g}; {lse_txt})")

    bwd_seen = {dname: [0.0, float("inf")] for dname in ATTN_BWD_TOL}
    for case, shape in ATTN_BWD_CASES.items():
        (B, Hq, Hkv, Sq, Skv, D, causal, window, qoff, kv_len,
         layout) = shape
        kw = dict(causal=causal, window=window, q_offset=qoff, kv_len=kv_len)
        for dname in ATTN_BWD_TOL:
            q, k, v, dout = bwd_inputs(B, Hq, Hkv, Sq, Skv, D, dtypes[dname],
                                       layout, Sq + Skv + 5)
            # the forward kernel's output and row statistic, as
            # FlashAttention saves them
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            how = fa.bwd_route(D)
            reset_launches()
            got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            counts = launch_counts()
            check(counts == {**{n: 0 for n in KERNELS},
                             "flash_attention_bwd": 1},
                  f"flash_attention_bwd {case} {dname} launched {counts}, "
                  f"expected the backward once")
            check(fa.BWD_ROUTES == {**{r: 0 for r in fa.BWD_ROUTES},
                                    how: 1},
                  f"flash_attention_bwd {case} {dname} took the routes "
                  f"{fa.BWD_ROUTES}, expected {how}")
            again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash_attention_bwd {case} {dname}: two launches on the "
                  f"same inputs differ")
            readings = hold_backward(case, dname, q, k, v, out, lse, dout,
                                     kw, got, bwd_seen[dname])
            print(f"[attention bwd] {case} {dname}: B={B} Hq={Hq} Hkv={Hkv} "
                  f"Sq={Sq} Skv={Skv} D={D} causal={causal} window={window} "
                  f"q_offset={qoff} kv_len={kv_len} layout={layout}, route "
                  f"{how}: {readings}; two launches bitwise equal")
            del q, k, v, dout, out, lse, got, again
        torch.cuda.empty_cache()
    for dname, (worst, least_fault) in bwd_seen.items():
        print(f"[attention bwd] {dname}: largest tile relative error norm "
              f"{worst:.3g}, smallest planted fault {least_fault:.3g}, limit "
              f"{ATTN_BWD_REL_TOL[dname]}")

    # ------------------------------------------------------- 6 LM main path
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    lm = LM(cfg, device=dev).init_params(
        torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    check(sum(p.numel() for p in lm.parameters() if p.dim() == 2)
          == cfg.param_count(), "the model's matrices are not param_count()")
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} q heads / {cfg.n_kv_heads} kv heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params} "
          f"parameters ({cfg.param_count()} in matrices) drawn in "
          f"{lm.dtype} on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=PREFILL_S, global_batch=PREFILL_B))
    toks = torch.from_numpy(pipe.global_batch_at(0)["tokens"]).to(dev)
    prefill = make_prefill_step(lm)
    seen = []                  # every layer's q, k, v views and output

    def recorded(q, k, v, **kw):
        out = attention_kernel(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out

    fa.flash_attention = recorded
    reset_launches()
    try:
        t0 = time.perf_counter()
        logits = prefill(toks)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        fa.flash_attention = attention_kernel
    check(counts["flash_attention_sm90"] == cfg.n_layers,
          f"prefill launched flash_attention_sm90 "
          f"{counts['flash_attention_sm90']} times, expected one per layer "
          f"({cfg.n_layers})")
    check(all(n == 0 for kname, n in counts.items()
              if kname != "flash_attention_sm90"),
          f"prefill launched another kernel: {counts}")
    launches["flash_attention_sm90"] += counts["flash_attention_sm90"]
    check(logits.shape == (PREFILL_B, PREFILL_S, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "prefill logits are not finite or not (B, S, V)")
    # each launch of the run against the plain version on its own inputs
    check(len(seen) == cfg.n_layers, "not one attention call per layer")
    layer_rel = [0.0, float("inf")]
    for i, (q, k, v, kw, got) in enumerate(seen):
        readings = hold_attention("flash_attention_sm90", f"prefill layer {i}",
                                  "bfloat16", q, k, v, kw, got, layer_rel)
        print(f"[lm] prefill layer {i} attention against the plain version "
              f"on its own inputs: {readings}")
    q0, k0 = seen[0][:2]
    print(f"[lm] prefill attention, all {len(seen)} layers: q "
          f"{tuple(q0.shape)} strides {q0.stride()}, k {tuple(k0.shape)}, "
          f"{q0.dtype}, {seen[0][3]}: largest q tile relative error norm "
          f"{layer_rel[0]:.3g}, smallest planted fault {layer_rel[1]:.3g}, "
          f"limit {ATTN_REL_TOL['bfloat16']}")
    del seen, q0, k0, q, k, v, got
    torch.cuda.empty_cache()
    print(f"[lm] make_prefill_step on {PREFILL_B} x {PREFILL_S} tokens: "
          f"{first_s:.3f} s (first call); launches {counts} — card: {card}")

    def sdpa_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                       kv_len=None):
        """The library's attention, a yardstick (never the port's)."""
        check(window is None and q_offset == 0 and kv_len is None,
              "SDPA was asked for more than causal or full attention")
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    def wall_ms(fn, runs=3) -> float:
        samples = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(samples)

    def tokens(vocab, B, S, seed=17):
        return torch.from_numpy(TokenPipeline(TokenPipelineConfig(
            vocab=vocab, seq_len=S, global_batch=B, seed=seed))
            .global_batch_at(0)["tokens"]).to(dev)

    def drawn(cfg, dtype, seed, tag="[families]"):
        t0 = time.perf_counter()
        lm = LM(cfg, dtype=dtype, device=dev).init_params(
            torch.Generator(dev).manual_seed(seed))
        torch.cuda.synchronize()
        n = sum(p.numel() for p in lm.parameters())
        nbytes = sum(p.numel() * p.element_size()
                     for p in lm.parameters())
        print(f"{tag} {cfg.name}: {cfg.n_layers} layers of the period "
              f"{cfg.period}, d_model {cfg.d_model}, vocab {cfg.vocab}: {n} "
              f"parameters, {nbytes / 1e9:.2f} GB in {dtype} (float32 "
              f"leaves included), drawn on the card in "
              f"{time.perf_counter() - t0:.2f} s")
        return lm

    def forward_vs_decode(lm, kname, n_launch, tag="[families]"):
        """The float32 forward (counted: ``kname`` ``n_launch`` times,
        nothing else) against token-by-token prefill, within
        DECODE_TOL."""
        cfg = lm.cfg
        toks = tokens(cfg.vocab, 2, F32_TOKENS, seed=18)
        reset_launches()
        full, aux = lm.forward(toks)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {**{n: 0 for n in KERNELS}}
        if kname:
            want[kname] = n_launch
            launches[kname] += counts[kname]
        check(counts == want, f"{cfg.name} float32 forward launched "
              f"{counts}, expected {want}")
        t0 = time.perf_counter()
        last, cache = lm.prefill(toks, s_max=F32_TOKENS)
        torch.cuda.synchronize()
        derr = float((full[:, -1] - last[:, 0]).abs().max())
        print(f"{tag} {cfg.name} at {cfg.n_layers} layers, float32, "
              f"2 x {F32_TOKENS} tokens, capacity factor "
              f"{cfg.capacity_factor}: forward (launches {counts}, aux "
              f"{float(aux):.6f}) vs prefill ({F32_TOKENS} decode "
              f"steps, {time.perf_counter() - t0:.2f} s) last logits max "
              f"|err| {derr:.3g} (tolerance {DECODE_TOL})")
        check(derr < DECODE_TOL, f"{cfg.name}: decode differs from the "
              f"forward by {derr}")

    def serve_and_time(lm, served_cfg, check_cfg, tag="[families]",
                       per_step=None, forward_kw=None):
        """ServeEngine on 8 prompts in float32 at the served config; each
        served token the greedy choice of the forward at ``check_cfg``
        (the same weights) within DECODE_TOL; then the decode step
        alone, median of 16. Decode launches nothing, or, with
        ``per_step`` (kernel, n), that kernel n times a decode step;
        ``forward_kw(rows)`` gives the checking forward its frontend."""
        lm.cfg = served_cfg
        eng = ServeEngine(lm, max_batch=4, s_max=256, device=dev)
        rng_p = np.random.RandomState(0)
        prompts = [rng_p.randint(1, served_cfg.vocab, rng_p.randint(4, 17))
                   .astype(np.int32) for _ in range(8)]
        steps, real_step = [0], lm.decode_step

        def counted_step(cache, toks):
            steps[0] += 1
            return real_step(cache, toks)

        lm.decode_step = counted_step
        reset_launches()
        try:
            outs = eng.generate(prompts, max_new=16)
        finally:
            del lm.decode_step
        counts = launch_counts()
        st = eng.stats()
        want = {n: 0 for n in KERNELS}
        if per_step is not None:
            want[per_step[0]] = per_step[1] * steps[0]
            launches[per_step[0]] += counts[per_step[0]]
        check(counts == want, f"{steps[0]} decode steps launched {counts}, "
              f"expected {want}")
        check(len(outs) == 8 and all(len(o) == 16 for o in outs)
              and all(0 <= t < served_cfg.vocab for o in outs for t in o),
              "ServeEngine did not serve 16 tokens to each of 8 prompts")
        lm.cfg = check_cfg
        gap = 0.0
        for i in range(0, 8, 4):
            chunk, served = prompts[i:i + 4], outs[i:i + 4]
            S = max(len(p) for p in chunk)
            seq = np.zeros((len(chunk), S + 16), np.int64)
            for b, (p, o) in enumerate(zip(chunk, served)):
                seq[b, S - len(p):S] = p
                seq[b, S:] = o
            lg, _ = lm.forward(torch.from_numpy(seq[:, :-1]).to(dev),
                               **(forward_kw(len(chunk)) if forward_kw
                                  else {}))
            lg = lg[:, S - 1:].float()
            got = lg.gather(-1, torch.from_numpy(seq[:, S:]).to(dev)[
                ..., None])
            gap = max(gap, float((lg.amax(dim=-1) - got[..., 0]).max()))
        lm.cfg = served_cfg
        check(gap <= DECODE_TOL, f"{served_cfg.name}: a served token is "
              f"{gap} below the forward's greedy choice")
        print(f"{tag} {served_cfg.name} ServeEngine (float32, "
              f"{served_cfg.n_layers} layers, capacity factor "
              f"{served_cfg.capacity_factor}): 8 prompts, max_new 16, "
              f"max_batch 4: accelerator {st['accelerator_s']:.3f} s, "
              f"system {st['system_s']:.3f} s, tokens_out "
              f"{st['tokens_out']}; every served token within {gap:.3g} "
              f"of the greedy logit of the forward at capacity factor "
              f"{check_cfg.capacity_factor}; launches {counts} over "
              f"{steps[0]} decode steps — card: {card}")
        print(f"{tag} ServeEngine stats: {json.dumps(st, sort_keys=True)}")
        state = {"cache": lm.init_cache(4, 256)}
        one = torch.ones((4, 1), dtype=torch.int32, device=dev)

        def decode(steps=1):
            for _ in range(steps):
                _, state["cache"] = lm.decode_step(state["cache"], one)

        decode(16)
        step_ms = wall_ms(decode, runs=16)
        nbytes = sum(p.numel() * p.element_size() for p in lm.parameters())
        print(f"{tag} {served_cfg.name} decode step, float32, "
              f"{served_cfg.n_layers} layers, 4 rows, 256-slot cache: "
              f"{step_ms:.2f} ms (median of 16); reading the "
              f"{nbytes / 1e9:.2f} GB of weights once takes "
              f"{1e3 * nbytes / HBM_BYTES_PER_S:.2f} ms — card: {card}")
        show_profile(f"{served_cfg.name} 4 decode steps",
                     profile(lambda: decode(4)), card)

    other, walls = {}, {}
    #: arch -> (config as run, batch rows, tokens a row, bf16 prefill wall
    #: ms): phases 6 and 6b's readings, which phase 6e's roofline reads
    prefill_walls = {}
    #: phase 6f's reference of the real tensors: {"prefill": bytes of phase
    #: 6's parameters and tokens, "train": (bytes of phase 6d's
    #: parameters, AdamW state and batch, its peak memory), "gloo": phase
    #: 6e's gloo ranks' collective counts}
    real_record = {"prefill": sum(
        g.leaf.numel() * g.leaf.element_size() for g in leaf_groups(lm))
        + toks.numel() * toks.element_size()}
    for name, attention in (("kernel", attention_kernel),
                            ("plain", fa_ref.flash_attention_ref),
                            ("sdpa", sdpa_attention)):
        fa.flash_attention = attention
        try:                   # the same model on another attention
            if name != "kernel":
                other[name] = prefill(toks)
            walls[name] = wall_ms(lambda: prefill(toks))
        finally:
            fa.flash_attention = attention_kernel
        rate = PREFILL_B * PREFILL_S * 1e3 / walls[name]
        if name == "kernel":
            prefill_walls[LM_ARCH] = (cfg, PREFILL_B, PREFILL_S, walls[name])
        print(f"[lm] prefill with attention on {name}: {walls[name]:.1f} ms "
              f"(median of 3 warm runs; {rate:.0f} tokens/s) — card: {card}")

    def max_diff(a, b) -> float:
        return max(float((a[i].float() - b[i].float()).abs().max())
                   for i in range(PREFILL_B))

    dlogit = max_diff(logits, other["plain"])
    floor = max_diff(other["sdpa"], other["plain"])
    bound = PREFILL_FLOOR_FACTOR * floor
    greedy = [t[:, -1].argmax(dim=-1).tolist()
              for t in (logits, other["plain"], other["sdpa"])]
    print(f"[lm] kernel vs plain attention: max |logit difference| "
          f"{dlogit:.4g}; SDPA vs plain {floor:.4g}, so the bound is "
          f"{bound:.4g} ({PREFILL_FLOOR_FACTOR} x); max |logit| "
          f"{float(logits.float().abs().max()):.3f}; last-position greedy "
          f"tokens kernel / plain / SDPA {greedy}")
    check(dlogit <= bound, f"prefill logits on the kernel differ from the "
          f"plain attention's by {dlogit}, over {bound}")
    check(greedy[0] == greedy[1], "the greedy last token differs between "
          "the kernel and the plain attention")
    del logits, other
    torch.cuda.empty_cache()
    show_profile("prefill", profile(lambda: prefill(toks)), card)
    del lm, prefill
    torch.cuda.empty_cache()

    # the forward against token-by-token prefill: 4 layers, float32
    lm4 = drawn(dataclasses.replace(cfg, n_layers=4), torch.float32, seed=1,
                tag="[lm]")
    forward_vs_decode(lm4, "flash_attention", 4, tag="[lm]")
    del lm4
    torch.cuda.empty_cache()

    # serving, float32 as the launcher serves, and the decode step alone
    lm32 = drawn(cfg, torch.float32, seed=0, tag="[lm]")
    serve_and_time(lm32, cfg, cfg, tag="[lm]")
    del lm32
    torch.cuda.empty_cache()

    # ------------------------------------------- 6b MoE and SSM families
    # Mixtral-8x7B and Qwen3-MoE (bf16 prefill at full width, depth cut to
    # fit the card) with each attention and MoE sublayer held on its own
    # inputs, their float32 forward against decode and ServeEngine, the
    # card's moe_ffn against JAX's, and Mamba2-780M whole (a function of its
    # own, as 3b)
    def families() -> None:
        from repro_torch.models import mamba2, moe

        t_phase = time.perf_counter()
        check(not torch.backends.cuda.matmul.allow_tf32,
              "TF32 is on for float32 products: the router's would round")

        def n_attn(cfg):
            return cfg.n_periods * cfg.period.count("attn")

        def timed_profile(what, fn, tokens_n):
            """Wall time of ``fn`` (median of 3 warm runs) and one run under
            torch.profiler with moe_ffn and ssd_chunked in ranges of their
            own, printed by group."""
            ms = wall_ms(fn)
            print(f"[families] {what}: {ms:.1f} ms (median of 3 warm runs; "
                  f"{tokens_n * 1e3 / ms:.0f} tokens/s) — card: {card}")
            real_moe, real_ssd = moe.moe_ffn, mamba2.ssd_chunked
            moe.moe_ffn = ranged("moe_ffn", real_moe)
            mamba2.ssd_chunked = ranged("ssd_chunked", real_ssd)
            # the kernel's ctypes launch runs under no op: a range of its
            # own ties it to one
            fa.flash_attention = ranged("flash_attention",
                                        attention_kernel)
            try:
                prof = profile(fn, family_group)
            finally:
                moe.moe_ffn, mamba2.ssd_chunked = real_moe, real_ssd
                fa.flash_attention = attention_kernel
            show_profile(what, prof, card)
            print(f"[profile] {what}: {prof['covered']:.3f} of the device "
                  f"time is tied to the op that launched it (the rest, the "
                  f"attention kernels' ctypes launches among it, is grouped "
                  f"by kernel name alone)")
            return ms, prof

        def hold_moe(name, i, x, p, out, cfg):
            """One MoE sublayer of the counted prefill on its own inputs: its
            routing at the served factor (loads, drops, aux), the served
            output recomputed, and moe_ffn at a drop-free factor against
            moe_ffn_dense_oracle."""
            E, k = cfg.n_experts, cfg.top_k
            B, S, _ = x.shape
            r = moe.route(x, p["router"], n_experts=E, top_k=k,
                          capacity_factor=cfg.capacity_factor)
            flat_e = r.top_i.reshape(B, S * k)
            loads = torch.zeros((B, E), dtype=torch.int64, device=dev)
            loads.scatter_add_(1, flat_e, torch.ones_like(flat_e))
            drops = int((~r.keep).sum())
            again, _ = moe.moe_ffn(x, p, n_experts=E, top_k=k,
                                   capacity_factor=cfg.capacity_factor)
            check(torch.equal(again, out), f"{name} MoE sublayer {i}: the "
                  f"served output is not moe_ffn's on the same inputs")
            worst = {"err": 0.0, "rel": 0.0, "token": 0.0}
            for b in range(B):          # a row at a time: the buffers of the
                xb = x[b:b + 1]         # drop-free factor are large
                # the least factor whose capacity holds the heaviest expert
                most = int(loads[b].max())
                free = most * E / (S * k)
                while moe.capacity(S, k, E, free) < most:
                    free *= 1.0 + 1e-6
                check(bool(moe.route(xb, p["router"], n_experts=E, top_k=k,
                                     capacity_factor=free).keep.all()),
                      f"{name} MoE sublayer {i}: factor {free} still drops")
                got, _ = moe.moe_ffn(xb, p, n_experts=E, top_k=k,
                                     capacity_factor=free)
                want = moe.moe_ffn_dense_oracle(xb, p, n_experts=E,
                                                top_k=k).float()
                diff = got.float() - want
                norms = want.norm(dim=-1)
                worst["err"] = max(worst["err"], float(diff.abs().max()))
                worst["rel"] = max(worst["rel"],
                                   float(diff.norm() / want.norm()))
                worst["token"] = max(worst["token"], float(
                    diff.norm(dim=-1).max() / norms.mean()))
                del got, want, diff
            check(worst["rel"] <= MOE_BF16_REL_TOL
                  and worst["token"] <= MOE_BF16_TOKEN_TOL,
                  f"{name} MoE sublayer {i} differs from the dense oracle: "
                  f"relative error norm {worst['rel']:.3g} (limit "
                  f"{MOE_BF16_REL_TOL}), a token's error norm "
                  f"{worst['token']:.3g} of the mean (limit "
                  f"{MOE_BF16_TOKEN_TOL})")
            total = loads.sum(0)
            print(f"[families] {name} MoE sublayer {i}: expert loads (both "
                  f"rows) min {int(total.min())} max {int(total.max())} of "
                  f"capacity {r.capacity} a row, {drops} of {B * S * k} "
                  f"assignments dropped at factor {cfg.capacity_factor}, aux "
                  f"{float(r.aux):.6f}; at the least drop-free factor of "
                  f"each row (last {free:.4f}, capacity "
                  f"{moe.capacity(S, k, E, free)}) against the dense "
                  f"oracle: relative error norm {worst['rel']:.3g}, a "
                  f"token's error norm at most {worst['token']:.3g} of the "
                  f"mean, max |err| {worst['err']:.3g}")
            return drops

        # 1. the MoE models: bf16 prefill, counted, every sublayer held
        for arch, (n_layers, B, S) in MOE_PREFILL.items():
            cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
            lm = drawn(cfg, torch.bfloat16, seed=0)
            toks = tokens(cfg.vocab, B, S)
            prefill = make_prefill_step(lm)
            seen_attn, seen_moe = [], []

            def rec_attn(q, k, v, **kw):
                out = attention_kernel(q, k, v, **kw)
                seen_attn.append((q, k, v, kw, out))
                return out

            real_moe = moe.moe_ffn

            def rec_moe(x, p, **kw):
                out, aux = real_moe(x, p, **kw)
                seen_moe.append((x, p, out))
                return out, aux

            fa.flash_attention, moe.moe_ffn = rec_attn, rec_moe
            reset_launches()
            try:
                t0 = time.perf_counter()
                logits = prefill(toks)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                counts = launch_counts()
            finally:
                fa.flash_attention, moe.moe_ffn = attention_kernel, \
                    real_moe
            want = {**{n: 0 for n in KERNELS},
                    "flash_attention_sm90": n_attn(cfg)}
            check(counts == want, f"{arch} prefill launched {counts}, "
                  f"expected flash_attention_sm90 once per layer and nothing "
                  f"else")
            launches["flash_attention_sm90"] += counts["flash_attention_sm90"]
            check(logits.shape == (B, S, cfg.vocab)
                  and bool(torch.isfinite(logits).all()),
                  f"{arch} prefill logits are not finite or not (B, S, V)")
            print(f"[families] {arch} make_prefill_step on {B} x {S} tokens: "
                  f"{first_s:.3f} s (first call); launches {counts} — card: "
                  f"{card}")
            del logits
            check(len(seen_moe) == n_layers and len(seen_attn) == n_layers,
                  f"{arch}: not one attention and one MoE call per layer")
            drops = sum(hold_moe(arch, i, x, p, out, cfg)
                        for i, (x, p, out) in enumerate(seen_moe))
            print(f"[families] {arch}: {drops} assignments dropped over "
                  f"{n_layers} MoE sublayers at the served capacity factor "
                  f"{cfg.capacity_factor}")
            del seen_moe
            ms, _ = timed_profile(f"{arch} bf16 prefill ({n_layers} layers, "
                                  f"{B} x {S} tokens)", lambda: prefill(toks),
                                  B * S)
            prefill_walls[arch] = (cfg, B, S, ms)
            del lm, prefill
            torch.cuda.empty_cache()
            layer_rel = [0.0, float("inf")]
            for i, (q, k, v, kw, got) in enumerate(seen_attn):
                readings = hold_attention("flash_attention_sm90",
                                          f"{arch} prefill layer {i}",
                                          "bfloat16", q, k, v, kw, got,
                                          layer_rel)
                print(f"[families] {arch} prefill layer {i} attention "
                      f"against the plain version on its own inputs: "
                      f"{readings}")
            q0, k0 = seen_attn[0][:2]
            print(f"[families] {arch} prefill attention, all {n_layers} "
                  f"layers: q {tuple(q0.shape)} strides {q0.stride()}, k "
                  f"{tuple(k0.shape)}, {seen_attn[0][3]}: largest q tile "
                  f"relative error norm {layer_rel[0]:.3g}, smallest planted "
                  f"fault {layer_rel[1]:.3g}, limit "
                  f"{ATTN_REL_TOL['bfloat16']}")
            del seen_attn, q0, k0
            torch.cuda.empty_cache()

            # 2. float32 at MOE_F32_LAYERS layers: the forward (8b once an
            # attention sublayer) against decode at a drop-free factor, then
            # ServeEngine at the served factor
            served = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS)
            free = dataclasses.replace(
                served, capacity_factor=served.n_experts / served.top_k)
            lm32 = drawn(free, torch.float32, seed=1)
            forward_vs_decode(lm32, "flash_attention", n_attn(free))
            serve_and_time(lm32, served, free)
            del lm32
            torch.cuda.empty_cache()

        # 3. the card's moe_ffn in float32 against JAX's outputs
        with np.load(os.path.join(ASSETS, "moe_expected.npz")) as z:
            expected = {name: z[name] for name in z.files}
        for case in sorted({n.rsplit("_", 1)[0] for n in expected
                            if n.endswith("_meta")}):
            meta = json.loads(str(expected[f"{case}_meta"]))
            rng = np.random.RandomState(meta["seed"])   # the exporter's draw
            d, E, f, k = meta["d"], meta["E"], meta["f"], meta["k"]
            x = rng.randn(meta["B"], meta["S"], d).astype(np.float32)
            p = {"router": (rng.randn(d, E) * meta["router_scale"]).astype(
                np.float32)}
            for name, shape in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                                ("w_down", (E, f, d))):
                p[name] = (rng.randn(*shape) / np.sqrt(shape[1])).astype(
                    np.float32)
            xt = torch.from_numpy(x).to(dev)
            pt = {n: torch.from_numpy(w).to(dev) for n, w in p.items()}
            cf = meta["capacity_factor"]
            got, aux = moe.moe_ffn(xt, pt, n_experts=E, top_k=k,
                                   capacity_factor=cf)
            r = moe.route(xt, pt["router"], n_experts=E, top_k=k,
                          capacity_factor=cf)
            want = expected[f"{case}_out"]
            err = float(np.abs(got.cpu().numpy() - want).max())
            aux_err = abs(float(aux) - float(expected[f"{case}_aux"]))
            # how far each float32 result lies from the same function in
            # float64 on the card (the two packages' roundings add)
            y64, _ = moe.moe_ffn(xt.double(), {n: w.double() for n, w in
                                               pt.items()},
                                 n_experts=E, top_k=k, capacity_factor=cf)
            y64 = y64.cpu().numpy()
            same_i = np.array_equal(r.top_i.cpu().numpy(),
                                    expected[f"{case}_top_i"])
            same_keep = np.array_equal(r.keep.cpu().numpy(),
                                       expected[f"{case}_keep"])
            print(f"[families] moe_ffn {case} (B {meta['B']}, S {meta['S']}, "
                  f"d {d}, E {E}, top-{k}, f {f}, factor {cf}) float32 on the "
                  f"card against JAX's (moe_expected.npz): top_i equal "
                  f"{same_i}, keep equal {same_keep} "
                  f"({int((~r.keep).sum())} dropped), output max |err| "
                  f"{err:.3g} (tolerance {MOE_ASSET_TOL}), aux |err| "
                  f"{aux_err:.3g} (tolerance {MOE_AUX_TOL}); from moe_ffn in "
                  f"float64 on the card: the card's float32 "
                  f"{float(np.abs(got.cpu().numpy() - y64).max()):.3g}, "
                  f"JAX's {float(np.abs(want - y64).max()):.3g}")
            check(same_i and same_keep, f"moe {case}: the card's routing "
                  f"differs from JAX's")
            check(err <= MOE_ASSET_TOL and aux_err <= MOE_AUX_TOL,
                  f"moe {case}: output {err:.3g} / aux {aux_err:.3g} from "
                  f"JAX's")

        # 4. Mamba2-780M, whole: bf16 prefill (no kernel), ssd_chunked
        # against the naive recurrence on a layer's own inputs, float32
        # forward against decode, ServeEngine
        cfg = get_config(SSM_ARCH)
        B, S = SSM_PREFILL
        lm = drawn(cfg, torch.bfloat16, seed=0)
        toks = tokens(cfg.vocab, B, S)
        prefill = make_prefill_step(lm)
        real_ssd, ssd_in = mamba2.ssd_chunked, []

        def rec_ssd(x, a, B_, C_, chunk, constrain=None, init_state=None):
            if not ssd_in:                      # the first layer's inputs
                ssd_in.append((x, a, B_, C_, chunk))
            return real_ssd(x, a, B_, C_, chunk, constrain, init_state)

        mamba2.ssd_chunked = rec_ssd
        reset_launches()
        try:
            t0 = time.perf_counter()
            logits = prefill(toks)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            mamba2.ssd_chunked = real_ssd
        check(all(n == 0 for n in counts.values()), f"{cfg.name} prefill "
              f"launched a kernel (it has no attention): {counts}")
        check(logits.shape == (B, S, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"{cfg.name} prefill logits are not finite or not (B, S, V)")
        print(f"[families] {cfg.name} make_prefill_step on {B} x {S} tokens: "
              f"{first_s:.3f} s (first call); launches {counts} — card: "
              f"{card}")
        del logits
        x, a, B_, C_, chunk = ssd_in.pop()
        y, _ = real_ssd(x, a, B_, C_, chunk)
        t0 = time.perf_counter()
        naive = mamba2.ssd_naive_ref(x, a, B_, C_)
        torch.cuda.synchronize()
        err = float((y - naive).abs().max())
        print(f"[families] {cfg.name} layer 0 ssd_chunked (chunk {chunk}) "
              f"against ssd_naive_ref ({S} steps, "
              f"{time.perf_counter() - t0:.2f} s) on its own inputs x "
              f"{tuple(x.shape)} {x.dtype}, B_ {tuple(B_.shape)} {B_.dtype}: "
              f"max |err| {err:.3g} (tolerance {SSD_TOL}), max |y| "
              f"{float(y.abs().max()):.3g}")
        check(err <= SSD_TOL, f"ssd_chunked differs from ssd_naive_ref by "
              f"{err}")
        del x, a, B_, C_, y, naive
        timed_profile(f"{cfg.name} bf16 prefill ({cfg.n_layers} layers, {B} "
                      f"x {S} tokens)", lambda: prefill(toks), B * S)
        del lm, prefill
        torch.cuda.empty_cache()
        lm4 = drawn(dataclasses.replace(cfg, n_layers=SSM_F32_LAYERS),
                    torch.float32, seed=1)
        forward_vs_decode(lm4, None, 0)
        del lm4
        lm32 = drawn(cfg, torch.float32, seed=0)
        serve_and_time(lm32, cfg, cfg)
        del lm32
        torch.cuda.empty_cache()
        print(f"[families] phase wall {time.perf_counter() - t_phase:.3f} s "
              f"— card: {card}")

    families()

    # ------------------------------------- 6c audio and vision frontends
    # Whisper-tiny and InternVL2-26B whole: the bf16 prefill counted, each
    # attention held on its own views, the splice, float32 forward against
    # decode and ServeEngine, the card's float32 Whisper against JAX's (a
    # function of its own, as 6b)
    def frontends() -> None:
        t_phase = time.perf_counter()
        tag = "[frontends]"
        g = torch.Generator(dev).manual_seed(19)

        def counted_prefill(cfg, prefill, toks, n_attn, **frontend):
            """The bf16 prefill with every launch counted
            (flash_attention_sm90 ``n_attn`` times, nothing else) and each
            attention's q, k, v, options and output recorded."""
            seen = []

            def rec(q, k, v, **kw):
                out = attention_kernel(q, k, v, **kw)
                seen.append((q, k, v, kw, out))
                return out

            fa.flash_attention = rec
            reset_launches()
            try:
                t0 = time.perf_counter()
                logits = prefill(toks, **frontend)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                counts = launch_counts()
            finally:
                fa.flash_attention = attention_kernel
            want = {**{n: 0 for n in KERNELS}, "flash_attention_sm90": n_attn}
            check(counts == want, f"{cfg.name} prefill launched {counts}, "
                  f"expected {want}")
            launches["flash_attention_sm90"] += n_attn
            B, S = toks.shape
            check(logits.shape == (B, S, cfg.vocab)
                  and bool(torch.isfinite(logits).all()),
                  f"{cfg.name} prefill logits are not finite or not (B, S, "
                  f"V)")
            check(len(seen) == n_attn, f"{cfg.name}: {len(seen)} attention "
                  f"calls, expected {n_attn}")
            stubs = ", ".join(f"{k} {tuple(v.shape)}"
                              for k, v in frontend.items())
            print(f"{tag} {cfg.name} make_prefill_step on {B} x {S} tokens "
                  f"({stubs}): {first_s:.3f} s (first call); launches "
                  f"{counts} — card: {card}")
            return logits, seen

        def hold_all(cfg, names, seen):
            """Each recorded attention against the plain version on its own
            views, as in phase 6."""
            rel = [0.0, float("inf")]
            for name, (q, k, v, kw, got) in zip(names, seen):
                readings = hold_attention("flash_attention_sm90",
                                          f"{cfg.name} {name}", "bfloat16",
                                          q, k, v, kw, got, rel)
                print(f"{tag} {cfg.name} {name} attention (q "
                      f"{tuple(q.shape)} strides {q.stride()}, k "
                      f"{tuple(k.shape)} strides {k.stride()}, causal "
                      f"{kw['causal']}) against the plain version on its "
                      f"own inputs: {readings}")
            print(f"{tag} {cfg.name}: all {len(seen)} attentions: largest q "
                  f"tile relative error norm {rel[0]:.3g}, smallest planted "
                  f"fault {rel[1]:.3g}, limit {ATTN_REL_TOL['bfloat16']}")

        def timed(cfg, lm, prefill, toks, **frontend):
            """The bf16 prefill's wall time (median of 3 warm runs), one run
            under torch.profiler by group (encode, the cross-attention and
            the LM head in ranges of their own), and the head's d x V
            product alone (CUDA events, median of 10)."""
            B, S = toks.shape
            what = (f"{cfg.name} bf16 prefill ({cfg.n_layers} layers, {B} x "
                    f"{S} tokens)")
            ms = wall_ms(lambda: prefill(toks, **frontend))
            print(f"{tag} {what}: {ms:.1f} ms (median of 3 warm runs; "
                  f"{B * S * 1e3 / ms:.0f} tokens/s) — card: {card}")
            lm.encode = ranged("encode", lm.encode)
            lm._cross_attn = ranged("cross_attention", lm._cross_attn)
            lm._head = ranged("lm_head", lm._head)
            # the kernel's ctypes launch runs under no op: a range of its
            # own ties it to one
            fa.flash_attention = ranged("flash_attention",
                                        attention_kernel)
            try:
                prof = profile(lambda: prefill(toks, **frontend),
                               frontend_group)
            finally:
                del lm.encode, lm._cross_attn, lm._head
                fa.flash_attention = attention_kernel
            show_profile(what, prof, card)
            print(f"[profile] {what}: {prof['covered']:.3f} of the device "
                  f"time is tied to the op that launched it")
            x = torch.randn((B, S, cfg.d_model), generator=g,
                            device=dev).to(lm.dtype)
            head = lm.top["lm_head"]
            samples = []
            for _ in range(11):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                x @ head
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end))
            head_ms = statistics.median(samples[1:])
            n_bytes = x.element_size() * (B * S * cfg.d_model + cfg.d_model
                                          * cfg.vocab + B * S * cfg.vocab)
            n_ops = 2 * B * S * cfg.d_model * cfg.vocab
            bound = 1e3 * max(n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS)
            print(f"{tag} {cfg.name} LM head: ({B * S}, {cfg.d_model}) x "
                  f"({cfg.d_model}, {cfg.vocab}) {lm.dtype}, head strides "
                  f"{head.stride()}: {head_ms:.4f} ms alone (CUDA events, "
                  f"median of 10), bound {bound:.4f} ms ({n_ops} FLOP at "
                  f"989 TFLOP/s, {n_bytes} B) — card: {card}")
            del x

        def attention_ab(cfg, prefill, toks, **frontend):
            """The prefill as served (``chunked_attention`` calls the
            kernel's wrapper under ``no_grad``) against the same prefill with
            each attention through ``fa.FlashAttention.apply``, as a forward
            that records gradients calls it: interleaved, 9 runs each. Remat
            is configured either way and skipped under ``no_grad``."""
            from repro_torch.models import layers as L
            direct = L.chunked_attention

            def through(q, k, v, *, causal=True, window=None, q_offset=0,
                        kv_len=None, **_):
                return fa.FlashAttention.apply(q, k, v, causal, window,
                                               q_offset, kv_len)
            runs = {"direct": [], "Function": []}
            try:
                for _ in range(9):
                    for name, fn in (("direct", direct),
                                     ("Function", through)):
                        L.chunked_attention = fn
                        runs[name].append(wall_ms(
                            lambda: prefill(toks, **frontend), runs=1))
            finally:
                L.chunked_attention = direct
            d, f = (statistics.median(runs[k]) for k in runs)
            print(f"{tag} {cfg.name} bf16 prefill, attention called directly "
                  f"(as served) {d:.3f} ms against through "
                  f"FlashAttention.apply {f:.3f} ms (interleaved, median of "
                  f"9 each; remat {cfg.remat}, skipped under no_grad) — "
                  f"card: {card}")

        def peak(what):
            print(f"{tag} {what}: peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
                  f"allocated on the card — card: {card}")
            torch.cuda.reset_peak_memory_stats()

        # 1. Whisper-tiny, whole: bf16 prefill with enc_frames, counted
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(WHISPER_ARCH)
        B, S = WHISPER_PREFILL
        lm = drawn(cfg, torch.bfloat16, seed=0, tag=tag)
        frames = torch.randn((B, cfg.cross_len, cfg.d_model), generator=g,
                             device=dev).to(torch.bfloat16)
        toks = tokens(cfg.vocab, B, S)
        prefill = make_prefill_step(lm)
        n_attn = cfg.enc_layers + 2 * cfg.n_layers
        logits, seen = counted_prefill(cfg, prefill, toks, n_attn,
                                       enc_frames=frames)
        del logits
        names = [f"encoder layer {i}" for i in range(cfg.enc_layers)] + [
            f"decoder layer {i} {part}" for i in range(cfg.n_layers)
            for part in ("self", "cross")]
        check([rec[3]["causal"] for rec in seen]
              == [False] * cfg.enc_layers + [True, False] * cfg.n_layers,
              f"{cfg.name}: the attentions are not the encoder's non-causal "
              f"ones, then causal self- and non-causal cross-attention")
        timed(cfg, lm, prefill, toks, enc_frames=frames)
        attention_ab(cfg, prefill, toks, enc_frames=frames)
        del lm, prefill, frames
        torch.cuda.empty_cache()
        hold_all(cfg, names, seen)
        del seen
        torch.cuda.empty_cache()

        # 2. float32: the forward against decode with the cross cache
        # filled from encode (LM._cross_kv, as the forward projects it)
        lm32 = drawn(cfg, torch.float32, seed=1, tag=tag)
        toks = tokens(cfg.vocab, 2, F32_TOKENS, seed=18)
        frames = torch.randn((2, cfg.cross_len, cfg.d_model), generator=g,
                             device=dev)
        reset_launches()
        full, _ = lm32.forward(toks, enc_frames=frames)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == {**{n: 0 for n in KERNELS},
                         "flash_attention": n_attn},
              f"{cfg.name} float32 forward launched {counts}")
        launches["flash_attention"] += n_attn
        cache = lm32.init_cache(2, F32_TOKENS)
        enc = lm32.encode(frames)
        for n, i, kind, p in lm32.sublayers():
            k, v = lm32._cross_kv(enc, p)
            cache["blocks"][f"{i}:{kind}"]["xk"][n] = k
            cache["blocks"][f"{i}:{kind}"]["xv"][n] = v
        xk = cache["blocks"]["0:attn"]["xk"].clone()
        reset_launches()
        t0 = time.perf_counter()
        for t in range(F32_TOKENS):
            last, cache = lm32.decode_step(cache, toks[:, t:t + 1])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        counts = launch_counts()
        want = {**{n: 0 for n in KERNELS},
                "flash_attention": cfg.n_layers * F32_TOKENS}
        check(counts == want, f"{cfg.name}: {F32_TOKENS} decode steps "
              f"launched {counts}, expected {want}")
        launches["flash_attention"] += counts["flash_attention"]
        check(torch.equal(cache["blocks"]["0:attn"]["xk"], xk),
              "decode changed the cross cache")
        derr = float((full[:, -1] - last[:, 0]).abs().max())
        print(f"{tag} {cfg.name} float32, 2 x {F32_TOKENS} tokens over "
              f"{cfg.cross_len} frames: forward (flash_attention {n_attn} "
              f"times) vs {F32_TOKENS} decode steps with the cross cache "
              f"filled from encode (launches {counts}, {decode_s:.2f} s) "
              f"last logits max |err| {derr:.3g} (tolerance {DECODE_TOL})")
        check(derr < DECODE_TOL, f"{cfg.name}: decode differs from the "
              f"forward by {derr}")
        del full, last, cache, enc, xk, frames

        # ServeEngine as the launcher serves it: text prompts against the
        # zero cross cache; the checking forward attends to the same zero
        # keys and values (a cross-attention over zeros adds nothing)
        def zero_kv(enc_out, p):
            z = torch.zeros((enc_out.shape[0], cfg.n_kv_heads, cfg.cross_len,
                             cfg.d_head), dtype=enc_out.dtype, device=dev)
            return z, z

        lm32._cross_kv = zero_kv
        try:
            serve_and_time(
                lm32, cfg, cfg, tag=tag,
                per_step=("flash_attention", cfg.n_layers),
                forward_kw=lambda rows: {"enc_frames": torch.zeros(
                    (rows, cfg.cross_len, cfg.d_model), device=dev)})
        finally:
            del lm32._cross_kv
        del lm32
        torch.cuda.empty_cache()

        # 3. the card's float32 whisper-tiny against JAX's
        with np.load(os.path.join(ASSETS, "whisper_expected.npz")) as z:
            expected = {name: z[name] for name in z.files}
        meta = json.loads(str(expected["meta"]))
        lm_a = LM(get_config(meta["arch"]), dtype=torch.float32, device=dev)
        frames_np, toks_np = draw_whisper(lm_a, meta)
        frames = torch.from_numpy(frames_np).to(dev)
        enc = lm_a.encode(frames)[:, meta["enc_rows"]].cpu().numpy()
        logits, _ = lm_a.forward(torch.from_numpy(toks_np).to(dev),
                                 enc_frames=frames)
        logits = logits[:, meta["logit_positions"]].cpu().numpy()
        e_err = float(np.abs(enc - expected["enc_out"]).max())
        l_err = float(np.abs(logits - expected["logits"]).max())
        print(f"{tag} {meta['arch']} float32 on the card against JAX's "
              f"(whisper_expected.npz: B {meta['B']}, {meta['frames']} "
              f"frames, {meta['tokens']} tokens): encoder rows "
              f"{meta['enc_rows']} max |err| {e_err:.3g}, logits at "
              f"{meta['logit_positions']} max |err| {l_err:.3g} (tolerance "
              f"{WHISPER_ASSET_TOL}; max |logit| "
              f"{float(np.abs(logits).max()):.3g})")
        check(e_err <= WHISPER_ASSET_TOL and l_err <= WHISPER_ASSET_TOL,
              f"{meta['arch']}: the card's float32 differs from JAX's "
              f"(encoder {e_err:.3g}, logits {l_err:.3g})")
        del lm_a, frames, enc, logits
        torch.cuda.empty_cache()
        peak(f"{cfg.name} (bf16 prefill, float32 models)")

        # 4. InternVL2-26B, whole: bf16 prefill with patch_embeds, counted;
        # the splice exact
        cfg = get_config(VLM_ARCH)
        B, S = VLM_PREFILL
        P = cfg.n_patches
        lm = drawn(cfg, torch.bfloat16, seed=0, tag=tag)
        patches = torch.randn((B, P, cfg.d_model), generator=g,
                              device=dev).to(torch.bfloat16)
        toks = tokens(cfg.vocab, B, S)
        prefill = make_prefill_step(lm)
        logits, seen = counted_prefill(cfg, prefill, toks, cfg.n_layers,
                                       patch_embeds=patches)
        x = lm._embed(toks, patches)
        check(x.shape == (B, S, cfg.d_model)
              and torch.equal(x[:, :P], patches.to(lm.dtype))
              and torch.equal(x[:, P:], lm.top["embed"][toks[:, P:].long()]),
              f"{cfg.name}: the embedded sequence is not the patches over "
              f"the first {P} positions, then the tokens' embeddings")
        del x
        other = toks.clone()
        other[:, :P] = (other[:, :P] + 7) % cfg.vocab
        again = prefill(other, patch_embeds=patches)
        same_logits = torch.equal(again, logits)
        print(f"{tag} {cfg.name} splice: the first {P} embedded positions "
              f"equal the patches in bf16; other tokens under the patches "
              f"give bit-identical logits: {same_logits}")
        check(same_logits, f"{cfg.name}: the tokens under the patches "
              f"changed the logits")
        del again, logits, other
        timed(cfg, lm, prefill, toks, patch_embeds=patches)
        del lm, prefill, patches
        torch.cuda.empty_cache()
        hold_all(cfg, [f"layer {i}" for i in range(cfg.n_layers)], seen)
        del seen
        torch.cuda.empty_cache()
        peak(f"{cfg.name} (bf16 prefill)")

        # 5. float32 at VLM_F32_LAYERS layers of full width, on the tokens
        # (decode has no patch input): forward against decode, ServeEngine
        cfg = dataclasses.replace(cfg, n_layers=VLM_F32_LAYERS)
        lm32 = drawn(cfg, torch.float32, seed=1, tag=tag)
        forward_vs_decode(lm32, "flash_attention", cfg.n_layers, tag=tag)
        serve_and_time(lm32, cfg, cfg, tag=tag)
        del lm32
        torch.cuda.empty_cache()
        peak(f"{cfg.name} at {cfg.n_layers} layers (float32)")
        print(f"{tag} phase wall {time.perf_counter() - t_phase:.3f} s — "
              f"card: {card}")

    frontends()

    # ------------------------------------------------------- 6d LM training
    # (in a function of its own: its names stay out of phase 7)
    def training() -> None:
        from repro_torch.launch.train import Trainer
        from repro_torch.models.convert import leaf_groups
        from repro_torch.training import lm_step, optim as O
        t_phase = time.perf_counter()
        tag = "[train]"
        real_refs = (fa_ref.flash_attention_ref,
                     fa_ref.flash_attention_bwd_ref)
        plain_calls = []

        def recording(name, real):
            def run(*args, **kw):
                plain_calls.append(name)
                return real(*args, **kw)
            return run

        def counted(what, step, want):
            """``step()`` with every launch counter at 0 just before and
            read just after: exactly the launches ``want`` names, and no
            call of the plain attention, forward or backward."""
            plain_calls.clear()
            fa_ref.flash_attention_ref = recording("flash_attention_ref",
                                                   real_refs[0])
            fa_ref.flash_attention_bwd_ref = recording(
                "flash_attention_bwd_ref", real_refs[1])
            reset_launches()
            try:
                t0 = time.perf_counter()
                m = step()
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
                counts = launch_counts()
            finally:
                fa_ref.flash_attention_ref, \
                    fa_ref.flash_attention_bwd_ref = real_refs
            check(not plain_calls, f"{what} called the plain attention: "
                  f"{sorted(set(plain_calls))}")
            check(counts == {**{n: 0 for n in KERNELS}, **want},
                  f"{what} launched {counts}, expected {want}")
            for kname, n in want.items():
                launches[kname] += n
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            check(math.isfinite(loss) and math.isfinite(gnorm),
                  f"{what}: loss {loss} or grad_norm {gnorm} not finite")
            print(f"{tag} {what}: loss {loss:.6f}, grad_norm {gnorm:.6f}, "
                  f"wall {wall:.1f} ms; launches {want}")
            return m, wall

        def grads(lm, batch):
            """Every parameter's gradient of ``lm.loss`` on ``batch``."""
            params = list(lm.parameters())
            for t in params:
                t.requires_grad_(True)
            try:
                loss, _ = lm.loss(batch)
                loss.backward()
                return [t.grad for t in params]
            finally:
                for t in params:
                    t.requires_grad_(False)
                    t.grad = None

        # 1. Yi-6B at full width, TRAIN_LAYERS layers, float32, AdamW
        cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                  n_layers=TRAIN_LAYERS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cfg, batch=TRAIN_B, seq=TRAIN_S, device=dev)
        torch.cuda.synchronize()
        # phase 6f's reference: the step's arguments as allocated here (the
        # optimiser's step, a host int, as the int32 scalar JAX holds)
        real_batch = tr.batch_at(0)
        train_args = sum(
            t.numel() * t.element_size() for t in
            [g.leaf for g in leaf_groups(tr.lm)]
            + [t for slot in ("m", "v") for t in tr.opt_state[slot].values()]
            + list(real_batch.values())) + 4
        del real_batch
        n = sum(p.numel() for p in tr.lm.parameters())
        n_blocks = sum(p.numel() for blk in tr.lm.layers
                       for p in blk.parameters())
        print(f"{tag} {cfg.name}: {cfg.n_layers} of 32 layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n} "
              f"parameters ({n_blocks} in blocks) in float32, "
              f"{cfg.optimizer}, remat {cfg.remat} ({cfg.remat_policy}); "
              f"model and optimiser state built in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        remat = 2 if cfg.remat else 1     # remat runs each forward twice
        want = {"flash_attention": remat * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
        walls = []
        for i in range(TRAIN_STEPS):
            _, wall = counted(f"{cfg.name} step {i + 1}",
                              lambda: tr.step(i), want)
            walls.append(wall)
        step_ms = statistics.median(walls[-3:])
        real_record["train"] = (train_args,
                                torch.cuda.max_memory_allocated())
        print(f"{tag} {cfg.name} train step on {TRAIN_B} x {TRAIN_S} "
              f"tokens: {step_ms:.1f} ms (median of 3 warm steps; "
              f"{TRAIN_B * TRAIN_S * 1e3 / step_ms:.0f} tokens/s); peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB — "
              f"card: {card}")
        # the same gradients with attention's backward on the plain version
        batch = tr.batch_at(TRAIN_STEPS)
        g_kernel = grads(tr.lm, batch)
        fa.flash_attention_bwd = lambda q, k, v, out, lse, dout, **kw: \
            fa_ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
        try:
            g_plain = grads(tr.lm, batch)
        finally:
            fa.flash_attention_bwd = kernel_bwd
        by_param = dict(zip((id(t) for t in tr.lm.parameters()),
                            zip(g_kernel, g_plain)))
        worst, worst_leaf = 0.0, None
        for g in leaf_groups(tr.lm):
            pairs = [by_param[id(t)] for t in g.tensors]
            diff = math.sqrt(sum(float((a - b).float().pow(2).sum())
                                 for a, b in pairs))
            ref = math.sqrt(sum(float(b.float().pow(2).sum())
                                for _, b in pairs))
            rel = diff / ref if ref else diff
            if rel >= worst:
                worst, worst_leaf = rel, g.path
        check(worst <= TRAIN_GRAD_REL_TOL, f"{cfg.name}: the gradients with "
              f"the backward kernel differ from those with its plain version "
              f"by {worst:.3g} (relative norm, {worst_leaf}), limit "
              f"{TRAIN_GRAD_REL_TOL}")
        print(f"{tag} {cfg.name} gradients, backward kernel against its "
              f"plain version on the same parameters and batch: largest "
              f"relative error norm of a leaf {worst:.3g} ({worst_leaf}), "
              f"limit {TRAIN_GRAD_REL_TOL}")
        del g_kernel, g_plain, by_param, pairs
        # one step under the profiler, the optimiser in a range of its own
        ranged_opt = tr.optimizer._replace(
            update_leaf=ranged("optimizer", tr.optimizer.update_leaf))
        step_fn = lm_step.make_train_step(tr.lm, ranged_opt)
        batch = tr.batch_at(TRAIN_STEPS + 1)
        prof = profile(lambda: step_fn(tr.opt_state, batch), train_group)
        show_profile(f"{cfg.name} train step", prof, card)
        check(prof["groups_ms"].get(BWD_GROUP, 0.0) > 0, f"the profile of "
              f"{cfg.name}'s step holds no time of the backward kernel "
              f"(group {BWD_GROUP!r}): {sorted(prof['top_ms'])}")
        # the backward's time by pass (dq, then dk and dv)
        passes = {re.search(r"flash_bwd_[a-z0-9_]+", name).group(0): ms
                  for name, ms in prof["kernels_ms"].items()
                  if "flash_bwd_" in name}
        check(len(passes) == 2, f"the profile of {cfg.name}'s step holds "
              f"the backward's kernels {sorted(passes)}, not its two passes")
        print(f"[profile] {cfg.name} train step: the backward by pass over "
              f"its {cfg.n_layers} launches: " + ", ".join(
                  f"{name} {ms:.2f} ms ({ms / cfg.n_layers:.4f} a launch)"
                  for name, ms in passes.items()) + f" — card: {card}")
        print(f"[profile] {cfg.name} train step: {prof['covered']:.3f} of "
              f"the device time tied to the op that launched it")
        del tr, step_fn, batch, ranged_opt
        torch.cuda.empty_cache()

        # 2. Whisper-tiny whole, float32: counted steps, then a checkpoint
        # at step 2 restored into a fresh model and optimiser, whose step 3
        # must equal the uninterrupted run's bit for bit
        wcfg = get_config(WHISPER_ARCH)
        B, S, steps = WHISPER_TRAIN
        remat = 2 if wcfg.remat else 1    # not the encoder's, as in JAX
        want = {"flash_attention": wcfg.enc_layers
                + remat * 2 * wcfg.n_layers,
                "flash_attention_bwd": wcfg.enc_layers + 2 * wcfg.n_layers}
        with tempfile.TemporaryDirectory() as ckdir, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                whole = Trainer(wcfg, batch=B, seq=S, ckpt=ckdir,
                                ckpt_every=2, device=dev)
                for i in range(steps):
                    counted(f"{wcfg.name} step {i + 1}",
                            lambda: whole.step(i), want)
                check(whole.mgr.all_steps() == [2],
                      f"checkpoints {whole.mgr.all_steps()}, expected [2]")
                resumed = Trainer(wcfg, batch=B, seq=S, ckpt=ckdir,
                                  ckpt_every=2, device=dev)
                check(resumed.start == 2, f"resumed at {resumed.start}")
                counted(f"{wcfg.name} step 3, resumed",
                        lambda: resumed.step(2), want)
            finally:
                torch.use_deterministic_algorithms(False)
        same = [torch.equal(a, b) for a, b in
                zip(whole.lm.parameters(), resumed.lm.parameters())]
        for slot in ("m", "v"):
            same += [torch.equal(a, resumed.opt_state[slot][k])
                     for k, a in whole.opt_state[slot].items()]
        check(all(same) and whole.opt_state["step"]
              == resumed.opt_state["step"] == 3,
              f"{wcfg.name}: step 3 after a restore differs from the "
              f"uninterrupted run in {same.count(False)} tensors")
        print(f"{tag} {wcfg.name}: {B} x {S} tokens over {B} x "
              f"{wcfg.cross_len} frames, {steps} steps; checkpoint at step 2 "
              f"restored into a fresh model and optimiser on the card: step "
              f"3's parameters and AdamW moments equal the uninterrupted "
              f"run's bit for bit ({len(same)} tensors)")
        del whole, resumed

        # 3. the reduced Yi-6B against JAX's training (the asset)
        with np.load(os.path.join(ASSETS, "lm_train_expected.npz")) as z:
            exp = {name: z[name] for name in z.files}
        meta = json.loads(str(exp["meta"]))
        rcfg = reduced(get_config(meta["arch"]))
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab=rcfg.vocab, seq_len=meta["seq"],
            global_batch=meta["batch"]))
        for run, (name, grad_accum, compress) in meta["runs"].items():
            lm = LM(rcfg, dtype=torch.float32, device=dev)
            draw_lm_train(lm, meta)
            opt = O.get(name, meta["lr"])
            step_fn = lm_step.make_train_step(lm, opt, grad_accum=grad_accum,
                                              compress_grads=compress)
            state = lm_step.make_opt_state(lm, opt, compress)
            remat = 2 if rcfg.remat else 1
            want = {"flash_attention": remat * rcfg.n_layers * grad_accum,
                    "flash_attention_bwd": rcfg.n_layers * grad_accum}
            errs = []
            for i in range(meta["steps"]):
                batch = {k: torch.from_numpy(v).to(dev) for k, v in
                         pipe.global_batch_at(i).items()}
                m, _ = counted(f"{rcfg.name} {run} step {i + 1}",
                               lambda: step_fn(state, batch)[1], want)
                for key in ("loss", "grad_norm"):
                    got, ref = float(m[key]), float(exp[f"{run}_{key}"][i])
                    errs.append(abs(got - ref) / abs(ref))
                    check(errs[-1] <= TRAIN_ASSET_TOL, f"{rcfg.name} {run} "
                          f"step {i + 1}: {key} {got} against JAX's {ref}")
            perr = 0.0
            for g in leaf_groups(lm):
                a = g.leaf.cpu().numpy()
                b = exp[f"{run}/{g.path}"]
                perr = max(perr, float(np.abs(a - b).max()))
                check(np.allclose(a, b, rtol=TRAIN_PARAM_TOL,
                                  atol=TRAIN_PARAM_TOL),
                      f"{rcfg.name} {run}: {g.path} differs from JAX's")
            print(f"{tag} {rcfg.name} {run} against JAX's asset: losses and "
                  f"grad norms within {max(errs):.3g} (limit "
                  f"{TRAIN_ASSET_TOL}, relative), parameters within "
                  f"{perr:.3g} (limit {TRAIN_PARAM_TOL})")
            del lm, state, step_fn
        print(f"{tag} phase wall {time.perf_counter() - t_phase:.3f} s — "
              f"card: {card}")

    kernel_bwd = fa.flash_attention_bwd
    training()

    # ------------------------------------ 6e distribution and analysis
    # expert parallelism over torch.distributed (NCCL at world 1, two gloo
    # ranks on the card) and the roofline on the H100 record against the
    # walls phases 6 and 6b read (a function of its own, as 6b)
    def distribution() -> None:
        import torch.distributed as dist

        from repro_torch.configs.shapes import ShapeCell
        from repro_torch.core.hw import H100
        from repro_torch.distributed import roofline
        from repro_torch.distributed.sharding import make_constrainer
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import moe

        tag = "[dist]"
        t_phase = time.perf_counter()
        cfg = get_config(DIST_ARCH)
        B, S = DIST_TOKENS
        job = {"B": B, "S": S, "seed": DIST_SEED, "d": cfg.d_model,
               "E": cfg.n_experts, "k": cfg.top_k, "f": cfg.d_ff_expert,
               "cf": cfg.capacity_factor}
        kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
                  capacity_factor=cfg.capacity_factor)

        # 1. NCCL at world 1, mesh (data 1, model 1): the sublayer and the
        # LM bit for bit moe_ffn's and the mesh-less LM's
        with tempfile.TemporaryDirectory(prefix="dist_") as rdv:
            dist.init_process_group(
                "nccl", init_method="file://" + os.path.join(rdv, "nccl"),
                rank=0, world_size=1)
            try:
                mesh = make_test_mesh((1, 1), ("data", "model"))
                check(mesh.device_type == "cuda"
                      and dist.get_backend() == "nccl",
                      f"world 1 runs on {dist.get_backend()} / "
                      f"{mesh.device_type}, not NCCL on the card")
                x, p = moe_inputs(job, torch.bfloat16, dev)
                routes, real_route = [], moe.route

                def recorded(*args, **kwargs):
                    r = real_route(*args, **kwargs)
                    routes.append(r)
                    return r

                moe.route = recorded
                try:
                    got, got_aux = moe.moe_ffn_shard_map(x, p, mesh=mesh,
                                                         **kw)
                    want, want_aux = moe.moe_ffn(x, p, **kw)
                finally:
                    moe.route = real_route
                torch.cuda.synchronize()
                same = {"output": torch.equal(got, want),
                        "aux": torch.equal(got_aux, want_aux),
                        "top_i": torch.equal(routes[0].top_i,
                                             routes[1].top_i),
                        "keep": torch.equal(routes[0].keep, routes[1].keep)}
                sm_ms = wall_ms(lambda: moe.moe_ffn_shard_map(
                    x, p, mesh=mesh, **kw))
                ffn_ms = wall_ms(lambda: moe.moe_ffn(x, p, **kw))
                print(f"{tag} NCCL world 1, mesh (data 1, model 1): "
                      f"{cfg.name}'s MoE sublayer (E {cfg.n_experts}, top-"
                      f"{cfg.top_k}, d {cfg.d_model}, f {cfg.d_ff_expert}, "
                      f"factor {cfg.capacity_factor}) bf16 on {B} x {S} "
                      f"tokens: moe_ffn_shard_map against moe_ffn bit for "
                      f"bit {same} ({int((~routes[0].keep).sum())} of "
                      f"{routes[0].keep.numel()} assignments dropped, aux "
                      f"{float(got_aux):.6f}); wall moe_ffn_shard_map "
                      f"{sm_ms:.3f} ms, moe_ffn {ffn_ms:.3f} ms (median of "
                      f"3) — card: {card}")
                check(all(same.values()), f"moe_ffn_shard_map at a model "
                      f"dim of 1 is not moe_ffn bit for bit: {same}")
                del x, p, got, want, routes
                torch.cuda.empty_cache()

                lm_cfg = dataclasses.replace(cfg, n_layers=DIST_LM_LAYERS,
                                             moe_buf_mode="shard_map")
                lm = drawn(lm_cfg, torch.bfloat16, seed=0, tag=tag)
                lm.constrain = make_constrainer(mesh)
                toks = tokens(cfg.vocab, B, S)
                prefill = make_prefill_step(lm)
                calls, real_sm = [], moe.moe_ffn_shard_map

                def counted(*args, **kwargs):
                    calls.append(1)
                    return real_sm(*args, **kwargs)

                moe.moe_ffn_shard_map = counted
                reset_launches()
                try:
                    logits = prefill(toks)
                    torch.cuda.synchronize()
                    counts = launch_counts()
                finally:
                    moe.moe_ffn_shard_map = real_sm
                n_attn = lm_cfg.n_periods * lm_cfg.period.count("attn")
                want_counts = {**{n: 0 for n in KERNELS},
                               "flash_attention_sm90": n_attn}
                check(counts == want_counts, f"the shard_map LM's prefill "
                      f"launched {counts}, expected {want_counts}")
                launches["flash_attention_sm90"] += \
                    counts["flash_attention_sm90"]
                check(len(calls) == DIST_LM_LAYERS, f"{len(calls)} MoE "
                      f"sublayers took moe_ffn_shard_map, expected "
                      f"{DIST_LM_LAYERS}")
                lm.constrain = None
                plain = prefill(toks)
                torch.cuda.synchronize()
                bitwise = torch.equal(logits, plain)
                print(f"{tag} {cfg.name} at {DIST_LM_LAYERS} layers of full "
                      f"width, moe_buf_mode shard_map, bf16 prefill of {B} "
                      f"x {S} tokens with the mesh's constrainer: "
                      f"{len(calls)} MoE sublayers on moe_ffn_shard_map, "
                      f"launches {counts}; logits bit for bit the mesh-less "
                      f"LM's {bitwise}, finite "
                      f"{bool(torch.isfinite(logits).all())} — card: {card}")
                check(bitwise and bool(torch.isfinite(logits).all()),
                      "the shard_map LM's logits are not the mesh-less LM's "
                      "bit for bit")
                del lm, prefill, logits, plain
                torch.cuda.empty_cache()
            finally:
                dist.destroy_process_group()

        # 2. two gloo ranks on the one card, mesh (data 1, model 2), float32
        # with TF32 off: each rank its 64 experts (the others NaN there)
        with tempfile.TemporaryDirectory(prefix="dist_gloo_") as rdv:
            with open(os.path.join(rdv, "job.json"), "w") as fh:
                json.dump({**job, "device": "cuda", "shape": [1, 2]}, fh)
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--moe-rank",
                 rdv, str(r), "2"], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(2)]
            deadline = time.monotonic() + DIST_SPAWN_S
            try:
                for r, proc in enumerate(procs):
                    try:
                        out, _ = proc.communicate(
                            timeout=max(deadline - time.monotonic(), 1.0))
                    except subprocess.TimeoutExpired:
                        fail(f"gloo rank {r} did not end within "
                             f"{DIST_SPAWN_S} s")
                    check(proc.returncode == 0, f"gloo rank {r} failed "
                          f"(rc {proc.returncode}):\n{out[-3000:]}")
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            spawn_s = time.perf_counter() - t0
            ranks = []
            for r in range(2):
                with open(os.path.join(rdv, f"rank{r}.json")) as fh:
                    ranks.append(json.load(fh))
        E_loc = cfg.n_experts // 2
        for r, res in enumerate(ranks):
            print(f"{tag} gloo rank {r} of 2 on {res['device']} "
                  f"({res['backend']}), mesh (data 1, model 2), "
                  f"{res['dtype']}, TF32 {res['tf32']}: experts "
                  f"{res['experts']} ({res['nan_experts']} others NaN), "
                  f"top_i equal {res['top_i_equal']}, keep equal "
                  f"{res['keep_equal']} ({res['drops']} of "
                  f"{res['assignments']} dropped), output max |err| "
                  f"{res['max_abs_err']:.3g} against moe_ffn (tolerance "
                  f"{MOE_ASSET_TOL}; max |out| {res['max_abs_out']:.3g}), "
                  f"aux {res['aux'][0]:.6f} / moe_ffn {res['aux'][1]:.6f}; "
                  f"wall moe_ffn_shard_map {res['shard_map_ms']:.3f} ms, "
                  f"moe_ffn {res['moe_ffn_ms']:.3f} ms (median of 3) — "
                  f"card: {card}")
            check(res["backend"] == "gloo" and res["device"].startswith(
                "cuda") and res["dtype"] == "torch.float32"
                and not res["tf32"], f"gloo rank {r} did not run float32 "
                f"on the card with TF32 off: {res}")
            check(res["experts"] == [r * E_loc, (r + 1) * E_loc]
                  and res["nan_experts"] == cfg.n_experts - E_loc,
                  f"gloo rank {r} does not hold only its {E_loc} experts")
            check(res["top_i_equal"] and res["keep_equal"],
                  f"gloo rank {r}: routing differs from moe_ffn's")
            check(res["finite"] and res["max_abs_err"] <= MOE_ASSET_TOL,
                  f"gloo rank {r}: output {res['max_abs_err']} from "
                  f"moe_ffn's (tolerance {MOE_ASSET_TOL})")
            check(abs(res["aux"][0] - res["aux"][1]) <= MOE_AUX_TOL,
                  f"gloo rank {r}: aux {res['aux']}")
        print(f"{tag} two gloo ranks spawned and done in {spawn_s:.1f} s")
        real_record["gloo"] = ranks

        # 3. the roofline on the H100 record against the walls phases 6
        # and 6b read (one card: no collective term)
        total = torch.cuda.get_device_properties(0).total_memory
        rel = abs(H100.hbm_bytes - total) / total
        print(f"{tag} H100 record: {H100}; the card's total memory {total} "
              f"B, the record's {H100.hbm_bytes} B ({rel:.2%} apart, limit "
              f"{HBM_RECORD_TOL:.0%}) — card: {card}")
        check(rel <= HBM_RECORD_TOL, f"the H100 record's HBM size is "
              f"{rel:.2%} from the card's")
        for arch, (run_cfg, rows, seq, wall) in prefill_walls.items():
            cell = ShapeCell(f"prefill_{rows}x{seq}", seq, rows, "prefill")
            r = roofline.analyze(arch=arch, shape=cell.name, mesh_name="1",
                                 chips=1, cfg=run_cfg, cell=cell)
            share = 1e3 * r.step_s / wall
            print(f"{tag} roofline {arch} ({run_cfg.n_layers} layers) bf16 "
                  f"prefill {rows} x {seq}: model FLOPs {r.model_flops:.4g}, "
                  f"FLOPs {r.flops_per_chip:.4g}, bytes "
                  f"{r.bytes_per_chip:.4g}; compute {1e3 * r.compute_s:.3f} "
                  f"ms, memory {1e3 * r.memory_s:.3f} ms, collective "
                  f"{1e3 * r.collective_s:.3f} ms -> {r.bottleneck}; step "
                  f"{1e3 * r.step_s:.3f} ms against the measured wall "
                  f"{wall:.3f} ms: {share:.1%} of it (MFU at the wall "
                  f"{r.model_flops / (H100.peak_bf16_flops * wall / 1e3):.1%})"
                  f" — card: {card}")
            check(wall >= ROOFLINE_FLOOR * 1e3 * r.step_s,
                  f"{arch}: the measured wall {wall:.3f} ms is under "
                  f"{ROOFLINE_FLOOR} x the roofline's {1e3 * r.step_s:.3f} "
                  f"ms: the record or the count is wrong")
        check(set(prefill_walls) == {LM_ARCH, *MOE_PREFILL},
              f"the roofline read {sorted(prefill_walls)}")
        print(f"{tag} phase wall {time.perf_counter() - t_phase:.3f} s — "
              f"card: {card}")

    distribution()

    # ------------------------------------------------------------ 6f dry-run
    # the port's dry-run (launch/dryrun.py) on fake tensors over the fake
    # process group, held to what phases 6, 6d and 6e allocated and counted
    # for real (a function of its own, as 6b)
    def dry_run() -> None:
        from repro_torch.configs.shapes import ShapeCell
        from repro_torch.core.hw import H100
        from repro_torch.launch import dryrun as DR

        tag = "[dryrun]"
        t_phase = time.perf_counter()
        reset_launches()
        # (c)'s full-width cells run in processes of their own from the
        # start (each its own fake group; the host's cores in parallel)
        # (each tags its collectives by call site: the tests' helper)
        cell_dir = tempfile.mkdtemp(prefix="dryrun_cells_")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        cells = {c: subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_torch_dryrun_fake.py"),
             cell_dir, "sites", c[0], c[1], "multi" if c[2] else "single",
             c[3], "cuda"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for c in DRYRUN_CELLS}

        def show(rec, t0):
            arch, shape, variant = rec["arch"], rec["shape"], rec["variant"]
            m = rec["memory_analysis"]
            total = sum(m.values())
            print(f"{tag} {arch} {shape} {rec['mesh']} {variant}: "
                  f"{rec['status']}, {rec['chips']} ranks; arguments "
                  f"{m['argument_size_in_bytes']} B, output "
                  f"{m['output_size_in_bytes']} B, temp "
                  f"{m['temp_size_in_bytes']} B: {total / 1e9:.2f} GB a "
                  f"rank, fits {rec['fits']} (H100 record "
                  f"{H100.hbm_bytes} B); collectives "
                  f"{json.dumps(rec['coll_by_kind'])}, wire "
                  f"{rec['coll_bytes']:.0f} B a rank "
                  f"({rec['collectives_from']}: "
                  f"{json.dumps(rec['comm_counts'])}); local_regions "
                  f"{[r.split(': ')[0] for r in rec['local_regions']]}; "
                  f"no_effect {rec['no_effect']}; build {rec['lower_s']} "
                  f"s, run {rec['compile_s']} s, "
                  f"{time.perf_counter() - t0:.1f} s in all")
            check(rec["status"] == "ok", f"{arch} {shape}: {rec}")
            calls = {k: v[0] for k, v in rec["comms"].items()}
            check(calls == rec["comm_counts"], f"{arch} {shape}: the "
                  f"recorder counted {calls}, CommDebugMode "
                  f"{rec['comm_counts']}")
            return total

        def cell(arch, shape, multi, variant="baseline", **kw):
            t0 = time.perf_counter()
            rec = DR.run_cell(arch, shape, multi, variant=variant,
                              write=False, **kw)
            return rec, show(rec, t0)

        def dryrun_sites(rec, sites, peak):
            """A full-width cell's collectives by call site: the rows of
            DRYRUN_SITE_CELLS printed; the cells of DRYRUN_2_13 held to
            torch 2.13's bytes by kind; no cell of
            DRYRUN_SITE_CELLS passes a shard between tensor dims (DTensor's
            all-to-all); on two pods no train cell moves anything larger
            than a scalar over one data dim alone. A train cell's live
            bytes at the peak by the line that made them (``peak``)
            printed; the decode cells' wire and temp held to JAX's record,
            the train and prefill cells' temp."""
            arch, shape, mesh_name = rec["arch"], rec["shape"], rec["mesh"]
            by_kind = {}
            for r in sites:
                e = by_kind.setdefault(r["kind"], [0, 0])
                e[0] += r["calls"]
                e[1] += r["bytes"]
            check(sum(n for _, n in by_kind.values()) == sum(
                rec["coll_by_kind"].values()), f"{arch} {shape} "
                f"{mesh_name}: the sites' bytes {by_kind} are not the "
                f"record's {rec['coll_by_kind']}")
            if (arch, shape) in DRYRUN_SITE_CELLS:
                print(f"{tag} {arch} {shape} {mesh_name}: collectives by "
                      f"kind [calls, bytes] {json.dumps(by_kind)} (torch "
                      f"{torch.__version__}); by call site, largest first:")
                for r in sites[:DRYRUN_SITE_ROWS]:
                    print(f"{tag}   {r['kind']} over {r['dims']} "
                          f"({r['group']} ranks) at {r['site']}, "
                          f"{'backward' if r['bwd'] else 'forward'}"
                          f"{', a shard moved' if r['shard_move'] else ''}, "
                          f"{r['dtype']} {r['shape']}: {r['calls']} calls, "
                          f"{r['bytes']} B")
            ref = DRYRUN_2_13.get((arch, shape, mesh_name))
            if ref is not None:
                for kind in sorted(set(by_kind) | set(ref)):
                    got = by_kind.get(kind, [0, 0])
                    want = ref.get(kind, [0, 0])
                    print(f"{tag} {arch} {shape} {mesh_name} {kind}: {got[0]} "
                          f"calls, {got[1]} B here (torch "
                          f"{torch.__version__}); torch 2.13 {want[0]} "
                          f"calls, {want[1]} B")
                    check(abs(got[1] - want[1]) <= DRYRUN_RELEASE_TOL *
                          want[1] and got[0] == want[0], f"{arch} {shape} "
                          f"{mesh_name}: {kind} {got[0]} calls, {got[1]} B, "
                          f"torch 2.13 {want[0]} calls, {want[1]} B (limit "
                          f"{DRYRUN_RELEASE_TOL} of the bytes)")
            if (arch, shape) in DRYRUN_SITE_CELLS:
                moved = [r for r in sites if r["shard_move"]
                         or r["kind"] == "all-to-all"]
                check(not moved, f"{arch} {shape} {mesh_name}: a shard "
                      f"passed between tensor dims: {moved}")
            if mesh_name == "multi" and shape.startswith("train"):
                one = [r for r in sites if r["dims"] in ("pod", "data")
                       and r["bytes"] > 8 * r["calls"]]
                check(not one, f"{arch} {shape} multi: moved over one "
                      f"data dim alone: {one}")
            jax = DRYRUN_JAX_DECODE.get((arch, shape, mesh_name))
            if jax is not None:
                wire, temp = rec["coll_bytes"], rec["memory_analysis"][
                    "temp_size_in_bytes"]
                print(f"{tag} {arch} {shape} {mesh_name} decode: wire "
                      f"{wire:.0f} B a rank, {wire / jax[0]:.4f} of JAX's "
                      f"record {jax[0]} B; temp {temp} B, "
                      f"{temp / jax[1]:.4f} of JAX's {jax[1]} B; step "
                      f"{rec['step_s']:.6g} s by the roofline")
                check(wire <= jax[0], f"{arch} {shape} {mesh_name}: wire "
                      f"{wire:.0f} B a rank, more than JAX's {jax[0]} B")
                check(temp <= jax[1], f"{arch} {shape} {mesh_name}: temp "
                      f"{temp} B a rank, more than JAX's {jax[1]} B")
            want = DRYRUN_JAX_TEMP.get((arch, shape, mesh_name,
                                        rec["variant"]))
            if want is not None:
                temp = rec["memory_analysis"]["temp_size_in_bytes"]
                print(f"{tag} {arch} {shape} {mesh_name} {rec['variant']}: "
                      f"temp {temp} B a rank, {temp / want:.4f} of JAX's "
                      f"record {want} B")
                check(temp <= want, f"{arch} {shape} {mesh_name}: temp "
                      f"{temp} B a rank, more than JAX's {want} B")
            if shape.startswith("train"):
                print(f"{tag} {arch} {shape} {mesh_name}: live bytes at "
                      f"the peak by the line that made them, largest "
                      f"first (and each line's most at once):")
                for r in peak[:DRYRUN_PEAK_ROWS]:
                    print(f"{tag}   {r['file']}:{r['line']} {r['function']}"
                          f": {r['bytes']} B in {r['storages']} storages "
                          f"(most {r['most']} B)")

        # (a) world 1 against the card's own runs: phase 6d's Yi-6B step
        # (TRAIN_LAYERS of 32 layers, float32, AdamW at 3e-4, remat) and
        # phase 6's Qwen3-8B bf16 prefill
        train_cell = ShapeCell("train_4k", TRAIN_S, TRAIN_B, "train")
        w1 = dict(mesh_shape=(1, 1))
        cfg8 = dataclasses.replace(get_config(TRAIN_ARCH),
                                   n_layers=TRAIN_LAYERS)
        rec, total = cell(TRAIN_ARCH, "train_4k", False, cfg=cfg8,
                          cell=train_cell, dtype=torch.float32, **w1)
        real_args, real_peak = real_record["train"]
        args = rec["memory_analysis"]["argument_size_in_bytes"]
        print(f"{tag} {TRAIN_ARCH} step at world 1 ({TRAIN_LAYERS} layers, "
              f"{TRAIN_B} x {TRAIN_S}, float32): arguments {args} B against "
              f"phase 6d's real tensors {real_args} B; predicted peak "
              f"(argument + output + temp) {total / 1e9:.2f} GB against "
              f"phase 6d's measured max_memory_allocated "
              f"{real_peak / 1e9:.2f} GB: ratio {total / real_peak:.3f} "
              f"(a record) — card: {card}")
        check(args == real_args, f"the dry-run's argument bytes {args} are "
              f"not phase 6d's {real_args}")
        check(rec["fits"], f"{TRAIN_ARCH} at {TRAIN_LAYERS} layers does "
              f"not fit by the dry-run")
        rec, total = cell(TRAIN_ARCH, "train_4k", False, cfg=dataclasses.
                          replace(cfg8, n_layers=32), cell=train_cell,
                          dtype=torch.float32, **w1)
        check(not rec["fits"], f"{TRAIN_ARCH} at 32 layers fits by the "
              f"dry-run ({total / 1e9:.2f} GB)")
        rec, _ = cell(LM_ARCH, "prefill_32k", False, cell=ShapeCell(
            "prefill_32k", PREFILL_S, PREFILL_B, "prefill"), **w1)
        args = rec["memory_analysis"]["argument_size_in_bytes"]
        check(args == real_record["prefill"], f"{LM_ARCH} prefill: the "
              f"dry-run's argument bytes {args} are not phase 6's "
              f"{real_record['prefill']}")
        print(f"{tag} {LM_ARCH} bf16 prefill {PREFILL_B} x {PREFILL_S} at "
              f"world 1: arguments {args} B, phase 6's real tensors "
              f"{real_record['prefill']} B")

        # (b) the fake count against phase 6e's real gloo count: the same
        # MoE sublayer, mesh (data 1, model 2), tokens and float32 on the
        # fake group
        import torch.distributed as dist
        from torch.distributed.tensor.experimental import \
            implicit_replication
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.distributed import sharding as SH
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import moe
        mcfg = get_config(DIST_ARCH)
        B, S = DIST_TOKENS
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=2)
        try:
            mesh = make_test_mesh((1, 2), ("data", "model"))
            fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
            E, d, f = mcfg.n_experts, mcfg.d_model, mcfg.d_ff_expert

            def fake(shape, logical):
                return DR.fake_dtensor(fake_mode, mesh, shape, torch.float32,
                                       SH.spec(mesh, shape, logical), "cuda")
            x = fake((B, S, d), ("data", None, None))
            p = {"router": fake((d, E), (None, None)),
                 "w_gate": fake((E, d, f), ("model", None, None)),
                 "w_up": fake((E, d, f), ("model", None, None)),
                 "w_down": fake((E, f, d), ("model", None, None))}
            rec_, used = DR.Recorder(), set()
            with fake_mode, implicit_replication(), DR.regions(used), \
                    DR.counting(rec_) as cm:
                moe.moe_ffn_shard_map(
                    x, p, n_experts=E, top_k=mcfg.top_k,
                    capacity_factor=mcfg.capacity_factor, mesh=mesh)
            fake_counts, fake_comms = DR.comm_counts(cm), rec_.comms
        finally:
            dist.destroy_process_group()
        for r, res in enumerate(real_record["gloo"]):
            print(f"{tag} {mcfg.name}'s MoE sublayer on (data 1, model 2), "
                  f"{B} x {S} float32: gloo rank {r} counted "
                  f"{res['comm_counts']} {res['comms']}, the fake group "
                  f"{fake_counts} {fake_comms} (regions {sorted(used)})")
            check(res["comm_counts"] == fake_counts
                  and res["comms"] == fake_comms, f"gloo rank {r}'s "
                  f"collectives differ from the fake group's")

        # (c) full width on the production meshes, from their processes
        try:
            for (arch, shape, multi, variant), proc in cells.items():
                t0 = time.perf_counter()
                left = max(DRYRUN_PHASE_S - (t0 - t_phase), 1.0)
                try:
                    log, err = proc.communicate(timeout=left)
                except subprocess.TimeoutExpired:
                    fail(f"phase 6f: {arch} {shape} did not end within "
                         f"{DRYRUN_PHASE_S} s of the phase's start")
                mesh_name = "multi" if multi else "single"
                check(proc.returncode == 0 and "RESULT " in log,
                      f"{arch} {shape} {mesh_name} {variant}: rc "
                      f"{proc.returncode}: {err[-3000:]}")
                stem = DR._stem(arch, shape, mesh_name, variant)
                with open(os.path.join(cell_dir, stem + ".json")) as f:
                    rec = json.load(f)
                got = json.loads(log.split("RESULT ", 1)[1])
                print(f"{tag} {stem}: its process ended "
                      f"{time.perf_counter() - t_phase:.1f} s into the "
                      f"phase")
                show(rec, t0)
                dryrun_sites(rec, got["sites"], got["peak"])
                if (arch, shape, multi) == ("qwen3-moe-235b-a22b",
                                            "train_4k", True):
                    temp = rec["memory_analysis"]["temp_size_in_bytes"]
                    print(f"{tag} {arch} {shape} on two pods: temp {temp} B "
                          f"a rank, {temp / MOE_TRAIN_SINGLE_TEMP:.3f} of "
                          f"one pod's {MOE_TRAIN_SINGLE_TEMP} B (torch "
                          f"2.13's reading; limit "
                          f"{MOE_TRAIN_POD_RATIO})"
                          f" — card: {card}")
                    check(rec["fits"], f"{arch} {shape} multi does not "
                          f"fit: {rec['memory_analysis']}")
                    check(temp <= MOE_TRAIN_POD_RATIO * MOE_TRAIN_SINGLE_TEMP,
                          f"{arch} {shape} multi: temp {temp} B is more "
                          f"than {MOE_TRAIN_POD_RATIO} of one pod's "
                          f"{MOE_TRAIN_SINGLE_TEMP} B")
        finally:
            for proc in cells.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            shutil.rmtree(cell_dir, ignore_errors=True)
        counts = launch_counts()
        check(not any(counts.values()), f"the dry-run launched {counts}")
        print(f"{tag} phase wall {time.perf_counter() - t_phase:.3f} s "
              f"(limit {DRYRUN_PHASE_S} s); no kernel launched — card: "
              f"{card}")
        check(time.perf_counter() - t_phase <= DRYRUN_PHASE_S,
              f"phase 6f took more than {DRYRUN_PHASE_S} s")

    dry_run()

    # ------------------------------------------------------------ 6g examples
    # the port's five examples, its entry points, at their defaults (the
    # main experiment at full scale), each counted: every launch is the
    # main path's
    def examples() -> None:
        import importlib.util
        tag = "[examples]"
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            paths = {"torch_quickstart": ["--out", tmp],
                     "torch_train_ttfs_mnist": ["--out", tmp],
                     "torch_serve_lm": [],
                     "torch_train_lm": ["--ckpt-dir",
                                        os.path.join(tmp, "lm")],
                     "torch_elastic_restart": ["--ckpt-dir",
                                               os.path.join(tmp, "el")]}
            for name in EXAMPLES:
                spec = importlib.util.spec_from_file_location(
                    name, os.path.join(ROOT, "examples", f"{name}.py"))
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                reset_launches()
                t0 = time.perf_counter()
                try:
                    got = mod.main(paths[name])
                except Exception as e:          # noqa: BLE001
                    traceback.print_exc()
                    fail(f"{tag} {name} failed: {type(e).__name__}: {e}")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = {k: n for k, n in launch_counts().items() if n}
                for kname, n in counts.items():
                    launches[kname] += n
                print(f"{tag} {name}: ok in {wall:.3f} s; launches "
                      f"{counts} — card: {card}")
                if name == "torch_train_ttfs_mnist":
                    rep = got["agreement"]
                    print(f"{tag} {name}: agreement "
                          f"{rep.n_images - max(rep.label_mismatches.values())}"
                          f"/{rep.n_images} labels, spike-time mismatches "
                          f"{rep.spike_time_mismatches}, repeatability "
                          f"{got['repeatability']['mismatches']} mismatches "
                          f"of {got['repeatability']['image_run_pairs']}, "
                          f"{got['steps']} steps")
                    check(rep.exact_match and
                          rep.n_images == EXAMPLE_AGREEMENT,
                          f"{name}: agreement {rep.summary()}")
                    check(got["steps"] == 702, f"{name}: {got['steps']} "
                          "steps, not the 702 of three epochs of 60,000")
                if name == "torch_elastic_restart":
                    check(got["bit_identical"], f"{name}: the resumed run "
                          "differs from the uninterrupted one")
        print(f"{tag} phase wall {time.perf_counter() - t_phase:.3f} s — "
              f"card: {card}")

    examples()

    # --------------------------------------------------------------- 7 times
    images = xte[:SERVE_BATCH]
    times = host_times(prog, images)
    frames = pack_events_batched(times, prog.T, prog.e_max, device=dev)
    ids, count = frames.ids, frames.count
    dec_kw = dict(n_out=prog.n_out, n_groups=prog.n_groups,
                  per_group=prog.per_group, fallback=prog.fallback)
    dkw = dict(n_groups=prog.n_groups, per_group=prog.per_group,
               sentinel=prog.T, fallback=prog.fallback)
    args = (ids, count, prog.w_padded, prog.thr_padded, prog.leak_shift)
    cur = ea.event_accum(ids, prog.w_padded)
    view = cur.movedim(1, 0)
    state = lif.lif_fused(view, prog.thr_padded, prog.leak_shift)
    first_l = state.first_spike[:, :prog.n_out]
    v_l = state.v_final[:, :prog.n_out]
    raster = frames_from_times(torch.from_numpy(times).to(dev), prog.T)
    raster_2d = raster.view(-1, prog.n_in)
    w_t = smm.k_major(prog.w_padded)      # the batch path's cached copy
    # event_accum's library call: one embedding_bag over float32 weights
    # with a zero row at n_in, the skipped slots pointing at it (exact while
    # 127 * E_max < 2**24)
    check(127 * prog.e_max < 2**24, "E_max too large for a float32 sum")
    w_bag = torch.cat([prog.w_padded.float(),
                       prog.w_padded.new_zeros((1, prog.n_pad)).float()])
    ids_bag = torch.where((ids >= 0) & (ids < prog.n_in), ids,
                          prog.n_in).view(-1, ids.shape[-1])

    def embedding_bag():
        return F.embedding_bag(ids_bag, w_bag, mode="sum",
                               padding_idx=prog.n_in)
    fns = {
        "fused_event_lif_decode": (
            lambda: ops.fused_event_lif_decode(*args, **dec_kw),
            lambda: ref.fused_event_lif_decode_ref(*args, **dec_kw), None),
        "fused_event_lif_early_exit": (
            lambda: ops.fused_event_lif_early_exit(*args),
            lambda: ref.fused_event_lif_early_exit_ref(*args), None),
        "fused_event_lif": (
            lambda: ops.fused_event_lif(*args),
            lambda: ref.fused_event_lif_ref(*args), None),
        "spike_matmul": (
            lambda: smm.spike_matmul(raster, prog.w_padded, w_t=w_t),
            lambda: smm_ref.spike_matmul_ref(raster, prog.w_padded),
            lambda: torch._int_mm(raster_2d, prog.w_padded)),
        "lif_fused": (
            lambda: lif.lif_fused(view, prog.thr_padded, prog.leak_shift),
            lambda: lif_scan(view, prog.thr_padded, prog.leak_shift, prog.T),
            None),
        "ttfs_decode": (
            lambda: dec.ttfs_decode(first_l, v_l, **dkw),
            lambda: dec_ref.ttfs_decode_ref(first_l, v_l, **dkw), None),
        "event_accum": (
            lambda: ea.event_accum(ids, prog.w_padded),
            lambda: ea_ref.event_accum_ref(ids, prog.w_padded),
            embedding_bag),
    }
    LIBRARY = {"spike_matmul": "torch._int_mm",
               "event_accum": "F.embedding_bag",
               "flash_attention_sm90": "scaled_dot_product_attention",
               "flash_attention": "scaled_dot_product_attention",
               "flash_attention_bwd": "autograd.grad through "
                                      "scaled_dot_product_attention"}
    # attention at Qwen3-8B's head shape, causal, S = 4096 (and 32,768
    # below): each kernel, its plain version, and SDPA as the library call;
    # bf16 on the tensor-core kernel, float32 on the split-TF32 kernel
    aq = {}
    for S in ATTN_TIME_S:
        aq[S] = attn_inputs(1, cfg.n_heads, cfg.n_kv_heads, S, S, cfg.d_head,
                            torch.bfloat16, "contiguous", S)
    S0 = ATTN_TIME_S[0]
    aq32 = attn_inputs(1, cfg.n_heads, cfg.n_kv_heads, S0, S0, cfg.d_head,
                       torch.float32, "contiguous", S0)
    check(fa.route(*aq[S0]) == "flash_attention_sm90"
          and fa.route(*aq32) == "flash_attention",
          "the timed inputs do not take the routes they are timed for")
    fns["flash_attention_sm90"] = (
        lambda: fa.flash_attention(*aq[S0]),
        lambda: fa_ref.flash_attention_ref(*aq[S0]),
        lambda: sdpa_attention(*aq[S0]))
    fns["flash_attention"] = (
        lambda: fa.flash_attention(*aq32),
        lambda: fa_ref.flash_attention_ref(*aq32),
        lambda: sdpa_attention(*aq32))
    # the backward at Yi-6B's training shape (phase 6d's), float32, the
    # model's views, on the forward kernel's output and row statistic
    # (computed once, outside the timing); the library call is autograd
    # through SDPA's backward (its forward run once, outside the timing)
    bq = bwd_inputs(*ATTN_BWD_CASES["yi-6b train"][:6], torch.float32,
                    "movedim view", 7)
    bout, blse = fa.flash_attention(*bq[:3], return_lse=True)
    lib_in = [t.detach().clone().requires_grad_() for t in bq[:3]]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    fns["flash_attention_bwd"] = (
        lambda: fa.flash_attention_bwd(*bq[:3], bout, blse, bq[3]),
        lambda: fa_ref.flash_attention_bwd_ref(*bq[:3], bout, bq[3]),
        lambda: torch.autograd.grad(lib_out, lib_in, bq[3],
                                    retain_graph=True))
    got = fa.flash_attention_bwd(*bq[:3], bout, blse, bq[3])
    lib = torch.autograd.grad(lib_out, lib_in, bq[3], retain_graph=True)
    print(f"[times] autograd through SDPA against flash_attention_bwd at "
          f"the training shape, float32: max |difference| dq "
          f"{float((got[0] - lib[0]).abs().max()):.3g}, dk "
          f"{float((got[1] - lib[1]).abs().max()):.3g}, dv "
          f"{float((got[2] - lib[2]).abs().max()):.3g}")
    del got, lib
    check(set(fns) == set(KERNELS), "a kernel has no timing entry")
    tol = ATTN_TOL["bfloat16"]
    for S, (q, k, v) in aq.items():
        got = fa.flash_attention(q, k, v).float()
        lib = sdpa_attention(q, k, v).float()
        check(torch.allclose(got, lib, rtol=tol, atol=tol), f"SDPA, the "
              f"yardstick, differs from flash_attention_sm90 at S {S} by "
              f"{float((got - lib).abs().max())}")
        del got, lib
    got, lib = fa.flash_attention(*aq32), sdpa_attention(*aq32)
    print(f"[times] SDPA against flash_attention in float32 at S {S0}: max "
          f"|difference| {float((got - lib).abs().max()):.3g}")
    del got, lib
    check(torch.equal(torch._int_mm(raster_2d, prog.w_padded),
                      smm.spike_matmul(raster_2d, prog.w_padded, w_t=w_t)),
          "torch._int_mm, the yardstick, differs from spike_matmul")
    check(torch.equal(embedding_bag().to(torch.int32).view(cur.shape), cur),
          "F.embedding_bag, the yardstick, differs from event_accum")

    def call_ms(fn, runs=TIMING_RUNS, warm=5) -> float:
        """One call as a caller pays it: CUDA events around the call, host
        dispatch included (median of ``runs``)."""
        for _ in range(warm):
            fn()
        samples = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        return statistics.median(samples)

    def kernel_ms(fn, runs=TIMING_RUNS, back=BACK_TO_BACK,
                  warm=5) -> tuple[float, float]:
        """(device ms of one launch alone, host ms of one wrapper call).

        A spin kernel holds the stream while ``back`` calls are queued behind
        the start event, so the events bracket kernels that run back to back
        with no host dispatch between them; a sample whose spin ended before
        the queue was full is taken again with a longer spin (median of
        ``runs`` samples)."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        spin = SPIN_CYCLES
        on_card, host = [], []
        while len(on_card) < runs:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            t0 = time.perf_counter()
            for _ in range(back):
                fn()
            queued = time.perf_counter() - t0
            primed = not start.query()
            end.record()
            end.synchronize()
            if not primed:
                check(spin < 64 * SPIN_CYCLES, "the launches could not be "
                      "queued ahead of the card")
                spin *= 2
                continue
            on_card.append(start.elapsed_time(end) / back)
            host.append(1e3 * queued / back)
        return statistics.median(on_card), statistics.median(host)

    # the work this batch needs, each input read once and each output
    # written once: executed steps, their events, the distinct weight rows
    # they touch; 5 ALU operations per lane-step of the LIF update, 4 per
    # lane of the decode comparator (two keys, a min and a max)
    cnt = count.cpu().numpy().astype(np.int64)
    ids_h = ids.cpu().numpy()
    _, steps_x = ops.fused_event_lif_early_exit(*args)
    steps_h = steps_x.cpu().numpy()
    B, T_, E = ids_h.shape
    N, K, n = prog.n_pad, prog.n_in, prog.n_out

    def gather_work(run):
        """(events, live steps, distinct weight rows) of rows that run
        ``run[b]`` steps each."""
        live = np.arange(T_)[None, :] < run[:, None]           # (B, T)
        used = np.zeros(K, bool)
        for b in range(B):
            for t in range(int(run[b])):
                used[ids_h[b, t, :cnt[b, t]]] = True
        return int((cnt * live).sum()), int(live.sum()), int(used.sum())

    work = {}
    for kname, run, label_bytes in (
            ("fused_event_lif_decode", np.full(B, T_), 4 * B),
            ("fused_event_lif_early_exit", steps_h, 4 * B),
            ("fused_event_lif", np.full(B, T_), 0)):
        events, steps_live, used_rows = gather_work(run)
        work[kname] = (4 * events + 4 * steps_live + used_rows * N + 4 * N
                       + 2 * 4 * B * N + label_bytes,
                       events * N + 5 * steps_live * N, ALU_OPS_PER_S)
    events, _, used_rows = gather_work(np.full(B, T_))
    work["event_accum"] = (4 * B * T_ * E + used_rows * N + 4 * B * T_ * N,
                           events * N, ALU_OPS_PER_S)
    work["lif_fused"] = (4 * T_ * B * N + 4 * N + 2 * 4 * B * N,
                         5 * T_ * B * N, ALU_OPS_PER_S)
    reads = 2 if prog.fallback == "membrane" else 1
    work["ttfs_decode"] = (4 * B * n * reads + 4 * B, 4 * B * n, ALU_OPS_PER_S)
    M = B * T_
    work["spike_matmul"] = (M * K + K * N + 4 * M * N, 2 * M * K * N,
                            INT8_OPS_PER_S)

    def attn_work(q, k, causal=True):
        """(bytes, operations) of attention: q, k, v read once and the
        output written once; 2 FLOPs a multiply-add in QK^T and in PV over
        the visible pairs of each head, S(S+1)/2 causal (Sq = Skv), all
        Sq * Skv without the mask."""
        B_, Hq, Sq, D_ = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        size = q.element_size()
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        return (size * B_ * D_ * (2 * Hq * Sq + 2 * Hkv * Skv),
                4 * B_ * Hq * pairs * D_)

    work["flash_attention_sm90"] = (*attn_work(*aq[S0][:2]), BF16_FLOPS)
    work["flash_attention"] = (*attn_work(*aq32[:2]), SPLIT_TF32_FLOPS)

    def attn_bwd_work(q, k, causal=True):
        """(bytes, operations) of attention's backward: q, k, v, out, the
        forward's row statistic (float32) and dout read once, dq, dk and dv
        written once; the five products a backward needs at least (Q K^T
        recomputed, dO V^T, P^T dO, dS K, dS^T Q), 2 FLOPs a multiply-add
        over the visible pairs, at the float32 rate kernel 8b's bound
        uses."""
        fwd_bytes, fwd_ops = attn_work(q, k, causal)
        lse_bytes = 4 * q.shape[0] * q.shape[1] * q.shape[2]
        return 2 * fwd_bytes + lse_bytes, 5 * fwd_ops // 2

    work["flash_attention_bwd"] = (*attn_bwd_work(*bq[:2]), SPLIT_TF32_FLOPS)

    # the practical floor of one launch: a trivial kernel (zero_ on 64
    # int32) timed the same way
    zeros64 = torch.zeros(64, dtype=torch.int32, device=dev)
    floor_ms = kernel_ms(lambda: zeros64.zero_())[0]
    print(f"[times] launch floor: zero_() on a (64,) int32 tensor alone "
          f"{floor_ms:.4f} ms — card: {card}")

    rows = []
    for kname, (kern, plain, library) in fns.items():
        n_bytes, n_ops, op_rate = work[kname]
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / op_rate
        attention = kname.startswith("flash_attention")
        runs, back = FEW_SAMPLES if attention else (TIMING_RUNS,
                                                    BACK_TO_BACK)
        (ms, host_ms) = kernel_ms(kern, runs, back)
        whole_ms, plain_ms = call_ms(kern, runs), call_ms(plain, runs)
        library_ms = (kernel_ms(library, runs, back)[0]
                      if library is not None else None)
        source, replaces = KERNELS[kname]
        rows.append({"name": kname, "route": "cuda",
                     "source": f"{CSRC}/{source}",
                     "replaces": replaces,
                     "launches": int(launches[kname]),
                     "max_abs_err": max_err[kname], "ms": ms,
                     "plain_ms": plain_ms,
                     "bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": library_ms})
        lib_txt = ("none" if library_ms is None
                   else f"{library_ms:.4f} ms ({LIBRARY[kname]}, alone)")
        B_, Hq_, Hkv_, S_, _, D_ = ATTN_BWD_CASES["yi-6b train"][:6]
        shape_txt = (f"B={B_} Hq={Hq_} Hkv={Hkv_} S={S_} D={D_} causal "
                     f"float32, (B, S, H, D) views (Yi-6B's training shape)"
                     if kname == "flash_attention_bwd" else
                     f"B=1 Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} S={S0} "
                     f"D={cfg.d_head} causal "
                     f"{'float32' if kname == 'flash_attention' else 'bf16'}"
                     if attention else
                     f"B={B} T={T_} E_max={E} N_in={K} N_pad={N} (events "
                     f"{events} in full T, {int((steps_h).sum())} steps in "
                     f"latency mode)")
        print(f"[times] {kname}: {shape_txt}: kernel alone {ms:.4f} ms, "
              f"wrapper host "
              f"{host_ms:.4f} ms per call, one call {whole_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_txt}, bound "
              f"{rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']}: "
              f"{n_bytes} B, {n_ops} ops)"
              f"{'' if attention else f', launch floor {floor_ms:.4f} ms'}, "
              f"main-path launches {launches[kname]} — card: {card}")

    # the backward against the design it replaced (BWD_BASELINE: two walks
    # of the keys in pass 1, 32 x 32 tiles on the CUDA cores), built in
    # phase 1 from its source, held once to the plain version and timed in
    # turns with this one at Yi-6B's training shape (new, baseline,
    # baseline, new)
    import ctypes
    from repro_torch.kernels.common import I, L, P, stream as cur_stream
    old = ctypes.CDLL(baseline_lib)
    old.flash_attention_bwd.argtypes = ([P] + [L] * 4) * 8 + [P, P] + \
        [I] * 11 + [P]
    old.flash_attention_bwd.restype = I
    B_, Hq_, Hkv_, S_, _, D_ = ATTN_BWD_CASES["yi-6b train"][:6]

    def baseline_bwd():
        grads = [torch.empty_like(t) for t in bq[:3]]
        stats = torch.empty((2, B_, Hq_, S_), dtype=torch.float32,
                            device=dev)
        code = old.flash_attention_bwd(
            *(x for t in (*bq[:3], bout, bq[3], *grads)
              for x in (t.data_ptr(), *t.stride())),
            stats[0].data_ptr(), stats[1].data_ptr(), B_, Hq_, Hkv_, S_, S_,
            D_, 1, 0, 0, S_, 0, cur_stream(bq[0]))
        check(code == 0, f"the baseline backward failed with CUDA error "
              f"{code}")
        return grads

    want = fa_ref.flash_attention_bwd_ref(*bq[:3], bout, bq[3])
    got = baseline_bwd()
    torch.cuda.synchronize()
    tol = ATTN_BWD_TOL["float32"]
    check(all(torch.allclose(g, w, rtol=tol, atol=tol)
              for g, w in zip(got, want)),
          "the baseline backward differs from the plain version")
    del want, got
    turns = {"flash_attention_bwd": [], "baseline": []}
    for name in ("flash_attention_bwd", "baseline", "baseline",
                 "flash_attention_bwd"):
        fn = (fns["flash_attention_bwd"][0] if name == "flash_attention_bwd"
              else baseline_bwd)
        turns[name].append(kernel_ms(fn, *FEW_SAMPLES)[0])
    new_ms, old_ms = (statistics.mean(turns[k]) for k in turns)
    print(f"[times] flash_attention_bwd against the design it replaced "
          f"({os.path.relpath(BWD_BASELINE, ROOT)}), in turns (new, "
          f"baseline, baseline, new) at B={B_} Hq={Hq_} Hkv={Hkv_} S={S_} "
          f"D={D_} causal float32, (B, S, H, D) views: this kernel "
          f"{turns['flash_attention_bwd'][0]:.4f} / "
          f"{turns['flash_attention_bwd'][1]:.4f} ms (mean {new_ms:.4f}), "
          f"baseline {turns['baseline'][0]:.4f} / {turns['baseline'][1]:.4f}"
          f" ms (mean {old_ms:.4f}): {old_ms / new_ms:.2f}x — card: {card}")
    check(new_ms < old_ms, f"flash_attention_bwd ({new_ms:.4f} ms) is not "
          f"faster than the design it replaced ({old_ms:.4f} ms)")

    # kernels 1 and 2 at a chunk of T (one gather phase, the launch plan's)
    # and of 8 steps, in turns (T, 8, T, 8)
    default = ops.launch_plan(T_, E, N)
    for kname, fn in (
            ("fused_event_lif_decode",
             lambda p: ops.fused_event_lif_decode(*args, **dec_kw, plan=p)),
            ("fused_event_lif_early_exit",
             lambda p: ops.fused_event_lif_early_exit(*args, plan=p))):
        for c in (T_, 8, T_, 8):
            p = ops.launch_plan(T_, E, N, c)
            ms = kernel_ms(lambda: fn(p))[0]
            print(f"[times] {kname} at chunk {c}, plan {tuple(p)}: kernel "
                  f"alone {ms:.4f} ms{' (its plan)' if p == default else ''}"
                  f" — card: {card}")

    # kernels 1 and 2 on rows wider than one block: the serving batch's
    # events through random weights of N_pad 4096 (one block), 8192 (a
    # cluster of 2) and MAX_N_PAD (8), each held once to its plain version
    for n_pad in (4096, 8192, ops.MAX_N_PAD):
        g = torch.Generator(dev).manual_seed(n_pad)
        w_w = torch.randint(-127, 128, (prog.n_in, n_pad), generator=g,
                            device=dev, dtype=torch.int8)
        thr_w = torch.randint(2000, 20000, (n_pad,), generator=g, device=dev,
                              dtype=torch.int32)
        args_w = (ids, count, w_w, thr_w, prog.leak_shift)
        kw_w = dict(n_out=n_pad, n_groups=16, per_group=n_pad // 16)
        p = ops.launch_plan(T_, E, n_pad)
        r_w, l_w = ops.fused_event_lif_decode(*args_w, **kw_w)
        same((r_w.first_spike, r_w.v_final, l_w),
             ref.fused_event_lif_decode_ref(*args_w, **kw_w),
             f"kernel 1 differs from the plain version at N_pad {n_pad}")
        x_w, s_w = ops.fused_event_lif_early_exit(*args_w)
        same((x_w.first_spike, x_w.v_final, s_w),
             ref.fused_event_lif_early_exit_ref(*args_w),
             f"kernel 2 differs from the plain version at N_pad {n_pad}")
        for kname, fn in (
                ("fused_event_lif_decode",
                 lambda: ops.fused_event_lif_decode(*args_w, **kw_w)),
                ("fused_event_lif_early_exit",
                 lambda: ops.fused_event_lif_early_exit(*args_w))):
            ms = kernel_ms(fn)[0]
            print(f"[times] {kname} at N_pad {n_pad}, plan {tuple(p)} "
                  f"(cluster {p.cluster}), B={B} T={T_} E_max={E} "
                  f"N_in={K}, steps in latency mode "
                  f"{int(s_w.sum())}: kernel alone {ms:.4f} ms — card: "
                  f"{card}")
        del w_w

    # lif_fused on windows other than the served one (B and N_pad served,
    # the staged path's movedim view): no chunk and a tail of 16 steps,
    # a chunk and one step, three chunks and four steps; each held once to
    # its plain version
    for T_w in (16, 33, 100):
        g = torch.Generator(dev).manual_seed(T_w)
        cur_w = torch.randint(-300, 400, (B, T_w, N), generator=g,
                              device=dev, dtype=torch.int32).movedim(1, 0)
        same(tuple(lif.lif_fused(cur_w, prog.thr_padded, prog.leak_shift)),
             tuple(lif_ref.lif_fused_ref(cur_w, prog.thr_padded,
                                         prog.leak_shift)),
             f"lif_fused differs from the plain version at T {T_w}")
        ms = kernel_ms(lambda: lif.lif_fused(cur_w, prog.thr_padded,
                                             prog.leak_shift))[0]
        print(f"[times] lif_fused at T {T_w}, B={B} N_pad={N}: kernel alone "
              f"{ms:.4f} ms — card: {card}")

    # attention at S = 32,768: a few samples, no plain version (its scores
    # would take 137 GB)
    S1 = ATTN_TIME_S[1]
    n_bytes, n_ops = attn_work(*aq[S1][:2])
    ms, host_ms = kernel_ms(lambda: fa.flash_attention(*aq[S1]), runs=5,
                            back=2, warm=1)
    library_ms = kernel_ms(lambda: sdpa_attention(*aq[S1]), runs=5, back=2,
                           warm=1)[0]
    bound = 1e3 * max(n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS)
    print(f"[times] flash_attention_sm90: B=1 Hq={cfg.n_heads} "
          f"Hkv={cfg.n_kv_heads}"
          f" S={S1} D={cfg.d_head} causal bf16: kernel alone {ms:.4f} ms, "
          f"wrapper host {host_ms:.4f} ms per call, plain not run, library "
          f"{library_ms:.4f} ms (scaled_dot_product_attention, alone), bound "
          f"{bound:.6f} ms (operations: {n_bytes} B, {n_ops} ops) — card: "
          f"{card}")
    # the prefill's own shape: B 2, q, k, v the model's (B, S, H, D) views
    qp = attn_inputs(PREFILL_B, cfg.n_heads, cfg.n_kv_heads, S0, S0,
                     cfg.d_head, torch.bfloat16, "movedim view",
                     S0 + 1)
    n_bytes, n_ops = attn_work(*qp[:2])
    ms = kernel_ms(lambda: fa.flash_attention(*qp), *FEW_SAMPLES)[0]
    library_ms = kernel_ms(lambda: sdpa_attention(*qp), *FEW_SAMPLES)[0]
    print(f"[times] flash_attention_sm90: B={PREFILL_B} Hq={cfg.n_heads} "
          f"Hkv={cfg.n_kv_heads} S={S0} D={cfg.d_head} causal bf16, (B, S, "
          f"H, D) views: kernel alone {ms:.4f} ms, library {library_ms:.4f} "
          f"ms (scaled_dot_product_attention, alone), bound "
          f"{1e3 * n_ops / BF16_FLOPS:.6f} ms (operations) — card: {card}")
    # phase 6c's shapes: Whisper's encoder and cross-attention and
    # InternVL's prefill on the tensor-core kernel, Whisper's decode
    # cross-attention in float32 on the split-TF32 kernel, each held once to
    # its plain version and to SDPA, then timed beside both and its bound
    for case, dname in (("whisper encoder", "bfloat16"),
                        ("whisper cross", "bfloat16"),
                        ("whisper decode cross", "float32"),
                        ("internvl heads", "bfloat16")):
        (B_, Hq, Hkv, Sq, Skv, D_, causal, _, _, _,
         layout) = ATTN_CASES[case]
        qkv = attn_inputs(B_, Hq, Hkv, Sq, Skv, D_, dtypes[dname], layout,
                          Sq + Skv + 3)
        kname = ATTN_ROUTE[dname]
        check(fa.route(*qkv) == kname, f"timed {case} {dname} does not take "
              f"{kname}")
        got = fa.flash_attention(*qkv, causal=causal)
        hold_attention(kname, f"timed {case}", dname, *qkv,
                       {"causal": causal}, got, [0.0, float("inf")])
        lib = sdpa_attention(*qkv, causal=causal)
        tol = ATTN_TOL[dname]
        check(torch.allclose(got.float(), lib.float(), rtol=tol, atol=tol),
              f"SDPA, the yardstick, differs from {kname} on {case} by "
              f"{float((got.float() - lib.float()).abs().max())}")
        del got, lib
        n_bytes, n_ops = attn_work(*qkv[:2], causal=causal)
        rate = BF16_FLOPS if dname == "bfloat16" else SPLIT_TF32_FLOPS
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / rate
        ms, host_ms = kernel_ms(
            lambda: fa.flash_attention(*qkv, causal=causal), *FEW_SAMPLES)
        plain_ms = call_ms(
            lambda: fa_ref.flash_attention_ref(*qkv, causal=causal),
            FEW_SAMPLES[0])
        library_ms = kernel_ms(lambda: sdpa_attention(*qkv, causal=causal),
                               *FEW_SAMPLES)[0]
        print(f"[times] {kname}: {case} B={B_} Hq={Hq} Hkv={Hkv} Sq={Sq} "
              f"Skv={Skv} D={D_} causal={causal} {dname}, layout {layout}: "
              f"kernel alone {ms:.4f} ms, wrapper host {host_ms:.4f} ms per "
              f"call, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms "
              f"(scaled_dot_product_attention, alone), bound "
              f"{1e3 * max(t_bytes, t_ops):.6f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
              f"{n_bytes} B, {n_ops} ops) — card: {card}")
        del qkv
    # the split-TF32 kernel on bf16 inputs no TMA map describes (a d stride
    # of 2: its element loads) at Qwen3-8B's head shape, S 4096
    qs2 = attn_inputs(1, cfg.n_heads, cfg.n_kv_heads, S0, S0, cfg.d_head,
                      torch.bfloat16, "d stride 2", S0 + 2)
    check(fa.route(*qs2) == "flash_attention",
          "bf16 with a d stride of 2 does not take the split-TF32 kernel")
    got = fa.flash_attention(*qs2)
    hold_attention("flash_attention", "timed d stride 2", "bfloat16", *qs2,
                   {}, got, [0.0, float("inf")])
    del got
    n_bytes, n_ops = attn_work(*qs2[:2])
    ms, host_ms = kernel_ms(lambda: fa.flash_attention(*qs2), *FEW_SAMPLES)
    plain_ms = call_ms(lambda: fa_ref.flash_attention_ref(*qs2),
                       FEW_SAMPLES[0])
    library_ms = kernel_ms(lambda: sdpa_attention(*qs2), *FEW_SAMPLES)[0]
    print(f"[times] flash_attention: B=1 Hq={cfg.n_heads} "
          f"Hkv={cfg.n_kv_heads} S={S0} D={cfg.d_head} causal bf16, d stride "
          f"2: kernel alone {ms:.4f} ms, wrapper host {host_ms:.4f} ms per "
          f"call, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms "
          f"(scaled_dot_product_attention, alone), bound "
          f"{1e3 * n_ops / BF16_FLOPS:.6f} ms (operations at the bf16 "
          f"tensor cores' 989 TFLOP/s; this kernel's own arithmetic, one "
          f"TF32 product for Q K^T and two for P V: "
          f"{1e3 * 1.5 * n_ops / TF32_FLOPS:.6f} ms) — card: {card}")
    for S in ATTN_TIME_S:
        n_bytes, n_ops = attn_work(*aq[S][:2])
        print(f"[times] flash_attention bound at S={S}: bf16 "
              f"{1e3 * n_ops / BF16_FLOPS:.4f} ms (989 TFLOP/s), float32 "
              f"{1e3 * n_ops / SPLIT_TF32_FLOPS:.4f} ms, the lesser of the "
              f"CUDA cores' {1e3 * n_ops / FP32_FLOPS:.4f} ms (67 TFLOP/s) "
              f"and split TF32's {1e3 * 3 * n_ops / TF32_FLOPS:.4f} ms (3 "
              f"products at 495 TFLOP/s), bytes "
              f"{1e3 * n_bytes / HBM_BYTES_PER_S:.4f} ms")

    print("kernels " + " ".join(f"{r['name']}={r['launches']}" for r in rows))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--moe-rank"]:
        sys.exit(moe_rank(sys.argv[2:]))
    sys.exit(main())
