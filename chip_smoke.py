"""Chip smoke test of the PyTorch port on one NVIDIA card:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions.
2. Builds every CUDA kernel of ``ddp_tpu_torch/csrc`` and prints the build
   seconds.  Its child processes share one bytecode cache in a temporary
   directory (``PYTHONPYCACHEPREFIX``).
3. Kernel phase: the ``row_gather`` kernel against its plain PyTorch version
   at the main path's shapes, with exact equality (clamped out-of-range and
   negative indices, a float32 table, row sizes that are not a multiple of
   16 bytes), and its time beside the plain version's and
   ``torch.index_select``'s (the yardstick only; the port never calls it).
4. Resident-batch phase: the ``gather_batch`` kernel (rows, crop/flip,
   u8/255, channels-first, labels in one launch) against its plain version,
   images and labels exactly, at N = 512 and the ragged 336, int32 and int64
   indices with out-of-range and negative ones, draws at both ends of the
   window with all and no flips, random draws and the eval form; every byte
   value against numpy's division.  Then at N = 512 its time by the event
   bracket and by ``torch.profiler``, its bound, the plain version's time,
   and the unfused sequence it replaced on the main path (``gather_rows``,
   ``crop_flip``, the label index and ``_as_input``): that
   sequence's device time, kernel launches and host enqueue time per call,
   beside the kernel's enqueue time.  No single PyTorch call computes this
   function, so the replaced sequence is the yardstick.  Then its bfloat16
   form (``dtype=torch.bfloat16``, the ``--bf16`` input) the same way: the
   same 24 cases bit for bit against its plain version, every byte value
   against the float32 quotient rounded to nearest even, its time by the
   event bracket and the profiler, its bound (4,737,536 bytes) and its
   yardstick, the float32 kernel followed by ``.to(torch.bfloat16)``.
5. Parity phase: three resident steps of a narrow VGG on the card
   (``gather_batch``'s kernel) against the same steps on the CPU (plain
   version), from the same weights and crop/flip draws, TF32 off.
6. Main path: the port's CLI in-process at full VGG-11 width,
   ``1 1 --batch_size 512 --resident --synthetic --synthetic_size 9040``
   (18 train steps, 5 eval steps: CIFAR-10's ragged batch and eval tail,
   336 and 212 rows, in a fifth of its epoch) with ``--snapshot_path`` in
   a temporary directory, with the kernels' launch counts read around
   it: 23 of
   ``gather_batch``, none of ``row_gather`` or ``conv3x3``.
7. Checkpoint phase: the epoch-0 checkpoint the main path wrote, loaded
   with ``load_checkpoint`` and held bit for bit against the trained
   weights, buffers and momentum; then the CLI again with ``--resume``,
   which must train no step, hold the trained weights, buffers and
   momentum bit for bit and report the same accuracy.
   bf16 main path: the CLI again with ``--bf16``, its counts zeroed just
   before and read just after: 18 finite losses, 23 launches of
   ``gather_batch``'s bfloat16 form, none of ``row_gather`` or ``conv3x3``,
   a float32 checkpoint; its ms/step and samples/s beside the float32 run's.
   Bench phase (``python -m ddp_tpu_torch.bench``, one process each, so
   this process's cuDNN and allocator state stay out of its windows):
   VGG-11, DeepNN and ResNet-18 at ``--steps 10 --repeats 3 --warmup 5``
   (each its stdout record, the resident-epoch and the bf16 records from stderr;
   VGG-11 ran the default 5 windows of 50 steps until the storage phase
   took the time), and VGG-11 ``--e2e --resident --e2e_steps 8``; VGG-11's
   fixed batch first and alone, the other three processes at once (their
   records share the card since the fleet phase took the time); each
   record printed on its own line, with every field, a finite positive
   value, an MFU in (0, 1.05] against the data sheet's peak for its
   dtype, the card's name and power limit, and the child's ``gather_batch``
   launches equal to the train steps it ran, by form; VGG's float32
   median ms/step within 3% of the main path's event median.
   Bench-modes phase (``bench_modes_phase``; the bench's modes that need no
   mesh, one after the other, each a process of its own but
   ``--stream_attr`` and ``--pipeline``, which run the bench's main in this
   process): VGG-11 ``--guard_overhead
   --steps 50 --repeats 2`` (``bench.py``'s fields, the derived K=50 audit
   overhead under 1%; 50-step windows, so each K=50 window holds one
   audit); ``--serve --fleet 2`` at buckets 1, 8, 32 and 128 (4 CUDA
   graphs an engine, nothing timed out, a router; rows/s, p99 and rows a
   batch printed beside the fleet phase's in-process figures; a fleet of
   1 is the serving phase's engine behind no router, so it has no process
   of its own); ``--batch_sweep 1024 --batch_sweep_flavors bf16_step
   --steps 10 --repeats 2`` (a child a cell, its steps and launches in the
   parent's summary; the bench phase's bf16 record is the step at 512, so
   that cell has no child of its own); ``--stream_attr
   --e2e_steps 8 --repeats 2`` (the attribution's keys, a named
   bottleneck, 0 < overlap efficiency <= 1, the streamed ``--e2e``
   record's phases); ``--pipeline`` (value > 0; the host loader with no
   device in its loop).  Every run's
   ``gather_batch`` launches equal its train steps plus its eval-form
   calls (``warm()``'s eager run and capture a bucket), by form.
   ``--sweep`` needs more than one card (ROADMAP C4) and ``--chaos`` is the
   storage phase's campaign: both run on the CPU only.
   Run-shape phase on 10,240 images: in deterministic mode
   (``repeat_check``'s), ``singlegpu 1 1 --schedule_epochs 2`` then ``2 1
   --resume --schedule_epochs 2`` against an uninterrupted ``2 1``, the
   loss histories bit for bit; then a streamed ``2 1 --metrics_path
   --log_every 5`` run in this process, its counts zeroed before and read
   after (45 ``gather_batch`` launches): each step record's lr the
   schedule's; each live record's median step (timed by CUDA events) the
   median of its window of the run's ``step_ms``, within 3% of the main
   path's event median, and its MFU in (0, 1.05].
8. DDP phase: ``python -m ddp_tpu_torch.multigpu`` with the main path's
   arguments as a subprocess, which spawns one rank per card: at world 1
   over NCCL it must launch ``gather_batch`` 23 times and neither
   ``row_gather`` nor ``conv3x3``, issue one gradient and one buffer
   all-reduce a step (plus the epoch's loss sum, the eval counters and the
   start's broadcast), match the in-process ``singlegpu`` run's first 3
   losses within ``PARITY_TOL`` (the epoch's largest difference is
   printed), and write a checkpoint ``load_checkpoint`` reads; its median
   ms/step and samples/s are printed beside ``singlegpu``'s.  Under
   deterministic mode (``ddp_tpu_torch.repeat_check``, in processes of
   their own, both at once, on 10,240 images) the world-1 run's whole
   history must equal ``singlegpu``'s bit for bit.  Then a narrow VGG's world-2 epoch of 3 steps with crop and
   flip (``ddp_tpu_torch.parallel.drill``) on the one card over gloo,
   against the same 2 ranks on the CPU, from the same weights and draws:
   losses, weights, BN buffers and momentum within ``PARITY_TOL``, and one
   ``gather_batch`` launch a step on each card rank.
   Strategy phase (the flags of ``multigpu``): the main path's arguments with
   ``--grad_accum 2 --sync_bn --shard_update`` at world 1 over NCCL as a
   subprocess: 10 optimizer steps with finite losses, ``gather_batch`` 23
   times and neither ``row_gather`` nor ``conv3x3``, the collectives equal
   to the count worked out from the code (printed beside its formula: 24
   sync-BN all-reduces a micro-batch, one buffer all-reduce, one
   reduce-scatter and one all-gather a step, no gradient all-reduce), and
   a checkpoint at step 50; its ms per optimizer step, samples/s, process
   wall time and accuracy beside the DDP phase's run.  Then each flag alone
   on a 10,240-image epoch (20 batches of 512) beside no flag, for its
   ms/step and collective counts (``multigpu`` run in this process as rank
   0 of a world-1 NCCL group, ``model_run``); under deterministic mode
   ``--shard_update`` and ``--grad_accum 1`` bit for bit against no flag;
   and a narrow world-2 epoch with the flags composed on the card over gloo
   against the CPU within ``PARITY_TOL``, one ``gather_batch`` launch a
   micro-batch on each card rank.  Then the same in bfloat16: the composed
   flags with ``--bf16`` at world 1 over NCCL (10 finite losses, 23
   bfloat16 launches, the same collectives, a float32 checkpoint, its
   ms/step beside the float32 composed run's) and the narrow world-2 epoch
   with ``compute_dtype="bfloat16"`` on the card against the CPU, within
   ``BF16_LOSS_TOL`` and ``BF16_UPDATE_TOL``.
   Streaming phase (the reference's data path, without ``--resident``):
   first ``gather_batch`` on the inputs that path gives it (train batch 0,
   the ragged 336-row batch, the 212-row eval tail and a view into a
   ``--grad_accum 2`` group, each copied by ``to_device`` and read through
   ``micro_from_batch``) against its plain version on the same tensors,
   exactly, in float32 and bfloat16, eval and augment form; then
   ``multigpu`` with the main path's other arguments, run in this process
   as rank 0 of a world-1 NCCL group with its counts set to 0 just before
   and read just after: 23 ``gather_batch`` launches (each streamed batch
   and each eval batch once), ``host_augment`` ``native`` (the C++
   crop/flip), the collectives of the DDP phase, 18 finite losses and a
   float32 checkpoint; its wall and event ms/step, samples/s and the
   prefetch engine's host, H2D-enqueue and consumer-wait ms a step beside
   the resident main path's from this process; ``--resume`` training epoch
   1 from that file; the same with ``--bf16`` (23 launches of the
   bfloat16 form, beside the resident bf16 run); ``--device_augment`` and
   the composed strategy flags on 10,240 images (launches, and the
   collectives against the formula); in deterministic mode,
   ``--device_augment`` streamed at ``--prefetch_depth`` 0 and 2, each in
   a process of its own, bit for bit against each other and against the
   strategy phase's deterministic resident run of the same arguments; a
   narrow world-2 streamed epoch over gloo on the card against the CPU
   within ``PARITY_TOL`` (lr 0.05, drill seed ``STREAM_DRILL_SEED``).
   Resilience phase (``resilience_phase``, a run that survives): the
   streamed VGG-11 at full width on 10,240 images, 2 epochs, first in this
   process unarmed and then armed (``--on_nan restore --watchdog_secs 600
   --drift_audit_every 5``), the armed event median within 1% of the
   unarmed one and each audit's excess printed (its cost a step at K =
   50); then five chains at once, in processes of their own: in
   deterministic mode the uninterrupted run, ``sigterm@step=13`` (exit 75,
   data_state epoch 0 offset 14) and ``--resume`` bit for bit on it (31
   ``gather_batch`` launches: 26 steps and 5 eval batches), and
   ``poison@step=25 --on_nan restore --keep_checkpoints 3`` (restores 1,
   its losses the uninterrupted ones), its head torn, the serve engine on
   the directory (the epoch-0 snapshot) and ``--resume`` from it bit for
   bit; and at world 2 over gloo on the card, ``flip_param_bit`` caught by
   ``--drift_audit_every 5`` (exit 1, the event naming the first leaf and
   replica 1) and a stalled rank ended by ``--watchdog_secs 20`` (124).
   Storage phase (``storage_phase``, A7b): the streamed VGG-11 at full
   width on 10,240 images, 3 epochs (``STORE_ARGS``), in deterministic
   children.  S1 alone: the asynchronous writer's main-thread ms, writer
   s and bytes per save beside the checkpoint phase's synchronous save,
   and the step median of the steps dispatched while a write ran; S3's
   ``slow_put@ms=500`` mirror run alone, its step median within 1% of
   S1's and its lag gauge above 0, then 0.  Then five chains at once:
   ``--ckpt_format sharded`` bit for bit S1's state, one shard and the
   index, served logits bit for bit the v1 lineage's; ``fail_put@n=2``
   retried; ``torn_remote_object@`` caught by the store's verification
   and skipped by the mirror walk; under ``python -m
   ddp_tpu_torch.supervise`` ``sigterm@step=25`` (75, then 0, bit for bit)
   and the local wipe resumed from the mirror alone (bit for bit).  Then
   three: a poisoned DeepNN batch under ``--keep_fault_env`` (87,
   ``diagnosis.json``, ``postmortem.json``), a repeated stall under
   ``--max_restarts 1`` (86), and ``fail_ckpt_write@epoch=1`` at world 2
   over gloo (rank 0 exits 1 with the error named, both ranks end).
   Beside both waves, from the start of the first, the chaos campaign's
   ``watchdog_stall`` and ``kill_stage`` (one campaign a drill, their
   scorecards; ``kill_stage`` on the card is mesh (1, 1, 2) as two gloo
   ranks, collapsed to (1, 1, 1) at the relaunch, bit for bit the
   pipelined control).
   The storage phase's repeated stall also checks the watchdog's stall
   line: it names the tracer's last ``dispatch`` and ``loss_flush`` spans.
   Obs phase (``obs_phase``, A8): the streamed VGG-11 at full width on
   10,240 images, 2 epochs with an eval each (``OBS_ARGS``), in
   deterministic children.  O1 runs with ``--trace_spill``,
   ``--metrics_path``, ``--log_every 10`` and ``--inspect_port 0``: read
   from the child's stderr, its port answers ``/metrics`` (through
   ``parse_exposition``, batches counted), ``/healthz`` (the step
   advancing) and ``/spans`` mid-run, and ``/debug/profile?steps=4`` arms
   a capture whose spans cover 4 steps and whose ``torch.profiler`` trace
   holds exactly 4 ``gather_batch_kernel`` launches; after it ``python -m
   ddp_tpu_torch.obs --perfetto`` exits 0 with a valid trace, the second
   epoch's serial spans sum to within 10% of its wall (the largest gaps
   printed), and the metrics stream holds one ``phase_stragglers`` record
   an epoch.  O2, the same with ``--obs_off --profile_dir``, leaves no
   spill (a planted one removed) and a trace of 50 ``gather_batch_kernel``
   launches (40 steps, 10 eval batches); beside it O3, world 2 over gloo on
   this card, writes ``.host1``, names rank 0 or 1 in each serial phase's
   record and counts one ``straggler_gather``.  O4: ``python -m
   ddp_tpu_torch.bench --inspect_overhead`` under 1%.  Each phase's end is
   printed on the smoke's clock (``smoke clock:``).
   Models phase (``--model deepnn`` and ``resnet18``, each at its full and
   only width, ``MODEL_ARGS``): ``multigpu`` in this process as rank 0 of a
   world-1 NCCL group, its counts zeroed before each run and read after,
   on 9,040 images resident in float32 (23 ``gather_batch`` launches, the
   collectives counted from the code, a float32 checkpoint that restores
   bit for bit) and with ``--bf16`` (23 of the bf16 form), each beside
   VGG-11's ms/step from this process, then ``--resume`` training epoch 1
   from the float32 file; streaming and the composed strategy flags on
   10,240 images (25 launches; all-reduces ``model_collectives``: 71 a
   ResNet-18 micro-batch under ``--sync_bn``, none for DeepNN, which has no
   buffers to average); serving the epoch-0 files at buckets 1, 8, 32 and
   128 in float32 and bfloat16 (logits bit for bit against the eager
   forward, replay ms, accuracy equal to ``evaluate_resident``'s);
   ``--export_torch`` then ``--init_from_torch`` back bit for bit through
   a strict load.  Then each model's step under the profiler, one process
   after the other (``profile_resident --model``: kernels a step, one
   ``gather_batch_kernel`` a step, as many as the wrapper launched, the
   device clock's lead over the host's); and each model's world-2 drill
   over gloo on the card (``MODEL_DRILLS``, sync-BN and the sharded
   update), after ``drill.margins`` shows every ReLU and max-pool decision
   at least 1e-6 from flipping: each card rank within ``PARITY_TOL`` of
   the drill's float64 epoch (``tests/torch_float64.py::float64_drill``).
   Tensor-parallel phase (``tp_phase``): DeepNN's plan table at m = 2;
   ``multigpu --mesh_shape 1,1`` in this process against the models
   phase's plain DeepNN run on the same arguments (the largest difference
   printed, within ``PARITY_TOL``: cuDNN is not in deterministic mode
   here); then two gloo ranks on this card at mesh (1, 2)
   (``drill.py``'s ``mesh_shape``), DeepNN at full width, batch 512,
   resident, 2,048 images (4 steps) and one eval batch, saved with
   ``--ckpt_format sharded``: the gathered weights, momentum and losses
   within ``PARITY_TOL`` of the world-1 drill from the same start run in
   this process (or of the drill's float64 epoch, computed on the card,
   where ``drill.margins`` finds a ReLU or max-pool decision within 1e-6
   of flipping), the model-axis all-reduces ``expected_collectives``'
   3 + 2 a step and 3 an eval batch, 5 ``gather_batch`` launches a rank,
   and the 2-slot file restored in this process onto world 1 bit for bit
   equal to the gathered state.  Its ms a step is gloo's host staging on
   one card, not NVLink.
   Pipeline phase (``pp_phase``): DeepNN's stage table at s = 2, A = 2;
   mesh (1, 1, 2) as two gloo ranks on this card (``drill.py``'s 3-D
   ``mesh_shape``), DeepNN at full width, batch 512, streamed, ``--grad_accum
   2`` on 2,048 images (2 steps) and 2 eval batches, under 1F1B (saved) and
   at the same time under GPipe, beside the world-1 ``--grad_accum 2``
   drill, all in deterministic mode: losses, the whole state gathered to
   rank 0 and the eval counts bit for bit; ``gather_batch`` on stage 0
   only (4 + 2), 2 handoffs a micro-batch a rank of [512, 64, 16, 16]
   float32 staged through pinned host buffers; the measured bubble beside
   (s-1)/(A+s-1); then the pipelined file resumed at (1, 1) in this
   process, bit for bit, for one more epoch.
9. Serving phase: ``ServeEngine.from_checkpoint`` on that epoch-0 file at
   full width with buckets 1, 8, 32 and 128; ``warm()`` must capture exactly
   4 CUDA graphs (the ``gather_batch`` wrapper runs once eagerly and once at
   capture per bucket).  At every bucket the served logits must equal the
   eager ``gather_batch`` + ``make_eval_apply`` forward bit for bit (and the
   kernel's eval form its plain version); each bucket's replay and eager
   device ms and ``forward()``'s host ms are printed.  Under the profiler
   five forwards at each bucket must run ``gather_batch_kernel`` five times
   and the wrapper not at all, counted forward by forward.  The profiler
   can miss the start of a session, so each serving session runs one
   forward and idles 50 ms before the forwards it counts, and a session
   whose records it lost all the same is run again, up to 3 sessions
   (ROADMAP C3).
   The 2,260 test images are served 128 at a time, each chunk's logits
   bit for bit against the eager forward of the chunk zero-padded to its
   bucket (``served_test_set``), and the served accuracy must equal
   ``evaluate_resident``'s with ``EvalLoader(test_ds, 128)``.  Then 8
   closed-loop HTTP clients send 15 requests of 1-32 rows each through
   ``DynamicBatcher`` and ``ServeHTTPServer`` on port 0 (p50/p99 latency,
   rows/s, rows per batch), and the same requests again under the profiler
   with device activity only (device busy share, and the kernel's
   launches): every answer must equal ``engine.predict`` on the same rows,
   ``/metrics`` the stats, the engine's forwards (one graph replay each)
   the batches formed, and so must the profiled ``gather_batch_kernel``
   launches, one in each forward; neither ``row_gather`` nor ``conv3x3``
   may launch on the path.  Then bf16 serving: the engine with
   ``compute_dtype=torch.bfloat16`` on the bf16 main path's epoch-0 file,
   4 graphs, each bucket's logits bit for bit against the eager bfloat16
   forward, one ``gather_batch_kernel`` in each of 5 profiled replays, its
   replay ms beside the float32 bucket's, the test set's served logits bit
   for bit against the eager bfloat16 forward, and served accuracy equal
   to ``evaluate_resident``'s in bfloat16.
   Fleet phase (``fleet_phase``, A9): F1 in process, a ``ServeFleet`` of 2
   VGG-11 replicas at buckets 1, 8, 32 and 128 on a lineage that publishes
   the main path's epoch-0 file: ``gather_batch``'s wrapper run 2 x 4
   times for each engine built, every replica's logits bit for bit the
   eager ``gather_batch`` + ``make_eval_apply`` forward at every bucket,
   each replica's replay ms, a served row's logits independent of its
   place in the batch, and one profiled window of 5 forwards on r0 with 5
   ``gather_batch_kernel``; then 8 closed-loop client threads while the
   fleet hot-swaps 3 times, to the streaming phase's ``--resume`` file and
   back (each a republish through the lineage, each swap by
   ``poll_once``): 0 failed, every answer bit for bit a forward of a
   snapshot live while it was in flight (at a bucket its batch could have
   had), both snapshots answering, rows/s and p50/p99 with and without a
   swap in progress, each swap's ``warm_s``, ``memory_allocated`` after
   swap 3 within 5% of after swap 1.  The same in bfloat16 on the bf16
   main path's file, without the load.  F2 out of process, the CI drill's
   form: ``python -m ddp_tpu_torch.serve --fleet 2 --swap_poll_s 0.5`` on
   port 0 under ``DDP_TPU_FAULT=crash_replica@requests=25,replica=0``
   with a span spill, 8 HTTP clients keeping an ok/shed/failed ledger that
   honours ``Retry-After``, a ``singlegpu --resume`` child republishing on
   10,240 images mid-load: 0 failed, an ejection and a ``swap_commit`` in
   ``/stats``, ``/metrics``' ejection and retry totals equal to
   ``/stats``', SIGTERM exit 0, and ``python -m ddp_tpu_torch.obs
   --perfetto`` on the spill holding ``eject`` and ``swap_commit``.
   Generate phase (``generate_phase``, A12), in this process: G1 ``python
   -m ddp_tpu_torch.train.lm``'s main, 30 f32 steps of the byte LM
   ``tinylm`` (16 sequences of 32 tokens), its losses descending and
   within 1e-3 relative of the CPU port's from the same seed, no
   ``gather_batch`` launch; G2 the KV-cache engine from its file (8 slots,
   prompt buckets 16 and 64): 5 CUDA graphs, the compile bound, 24 decode
   steps of a prompt in each bucket, each within 1e-4 of ``lm_forward``
   of the history on the card and the same greedy token, the cache never
   reallocated, the replay ms of the decode and prefill graphs and the
   host ms of ``decode()`` at 8 live slots; G3 8 concurrent streams of 16
   tokens through ``TokenBatcher``, each token for token the stream run
   alone; G4 a 2-replica generative ``ServeFleet`` behind
   ``ServeHTTPServer``, two sticky sessions of two turns over ``POST
   /generate``, no migration, every turn the engine's; G5 the serve-chaos
   drill (``serve_chaos.run_drill``) passing; G6 ``bench --serve
   --generate --gen_streams 1,8 --serve_secs 2`` in process (tokens/s,
   TTFT p50/p99, the
   compile bound, the card and power limit); G7 a bfloat16 stream within
   2^-5 of max |logit| of the bfloat16 forward; G8 the transformer encoder
   through ``ServeEngine`` at buckets 1, 8 and 32: ``gather_batch``'s
   wrapper counted from 0 (one eager run and one capture a bucket), five
   profiled forwards a bucket each replaying one ``gather_batch_kernel``
   with the wrapper's count unmoved, the
   kernel bit for bit its plain version at each bucket's shape, the served
   logits bit for bit the eager forward and within 1e-4 of max |logit| of
   the CPU's.
   Accuracy anchors (ROADMAP C2): the configs of
   ``tests/golden/accuracy_parity_20epoch_noise0.25_bf16.json`` and of its
   float32 twin (batch 64, lr 0.05, 768 images of ``synthetic(seed=21,
   label_noise=0.25)``, 256 held out, no augmentation, the shuffle
   ``rng(1234 + epoch)``, init from ``tests/torch_ref.py::TorchVGG`` under
   ``torch.manual_seed(2)``) for 20 epochs through the port's resident step
   at full width; each epoch's mean loss and accuracy printed beside the
   recording's, the final held-out accuracy within 2 points of it.
10. Conv kernel phase: ``conv3x3`` (``conv3x3_fused``) forward and dgrad
   against its plain version at the probe's shapes at batch 512, at every
   VGG conv shape at batch 8 and at the routes' edge cases, float32 and
   bfloat16 against a float64 result, each through the route
   ``conv3x3_route`` names (its launch counter must move, and no other);
   the autograd candidate (y, dx, dw) against autograd of the plain
   version; whether the built library's SASS holds ``HGMMA`` (wgmma)
   instructions; then the times of both dtypes at the two probe shapes and
   their dgrads beside the plain version's, cuDNN's (``conv2d_nhwc``, TF32
   off: the yardstick only) and the bound.
11. Probe path: the conv-candidate CLI in-process (``--repeats 1``, all five
   candidates at both target shapes, batch 512), once in float32 and once
   with ``--bf16``, each with the kernel's launch count and its route read
   around it, then the pool probe once.
12. Prints the kernels line (``gather_batch_bf16`` is the bfloat16 form,
    its launches those of the bf16 main path, with those of the bf16
    strategy, streaming and serving paths beside; ``gather_batch``'s entry
    adds its launches on
    the serving path: the eager runs in ``warm()`` and the launches of the
    profiled HTTP load, on the DDP path: the world-1 run's and the card
    ranks' of the world-2 run, on the strategy path: the composed
    world-1 run's and the card ranks' of its world-2 run, on the
    streaming path: every card run of the streaming phase, on the
    resilience path: the runs that report their counters (the unarmed and
    armed runs, the uninterrupted one, the resumed ones, the poisoned one),
    on the storage path: its VGG-11 children that complete (one launch a
    train step and an eval batch each),
    and on the models path: the models phase's runs, serving and drills,
    on the tensor-parallel path: the ``--mesh_shape 1,1`` run, both card
    ranks of the mesh (1, 2) drill and the world-1 drill beside it, on the
    pipeline path (``launches_pp_path``): stage 0's of both mesh (1, 1, 2)
    drills, the world-1 drill beside them and the resumed epoch,
    on the bench
    path: the train steps the bench's processes ran in that form, and on
    the run-shape path: the split, uninterrupted and streamed runs, on
    the obs path: O1's and O2's runs, on the fleet path: the eager runs
    of every engine F1 builds (its 2 at the start and 2 a swap) and the 5
    profiled replays, in the bf16 entry the bf16 fleet's, and on the
    generate path (``launches_generate_path``): the encoder engine's eager
    warm-up runs and its 15 profiled replays; both
    entries
    give ``stream_batch_cases``, the streamed-batch comparisons in their
    dtype, whose launches are not counted), the card line, and last
    ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero; without a card it
exits 1 and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import functools
import gc
import importlib.util
import io
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ddp_tpu_torch import _build, cli, interop
from ddp_tpu_torch.data import (EvalLoader, ResidentData, TrainLoader,
                                synthetic)
from ddp_tpu_torch.data.device_augment import crop_flip, make_draws
from ddp_tpu_torch.device import set_tf32
from ddp_tpu_torch.data.loader import optimizer_groups
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.models.modules import BatchNorm
from ddp_tpu_torch.models.vgg import VGG, BNReLU
from ddp_tpu_torch.ops import conv_candidates, pool_candidates
from ddp_tpu_torch.ops.conv_candidates import (ROUTES, TARGET_SHAPES,
                                               _flip_transpose, _shift9_fwd,
                                               conv2d_fused, conv3x3_fused,
                                               conv3x3_route)
from ddp_tpu_torch.ops.conv_probe import (N_LONG, N_SHORT, VGG_CONV_SHAPES,
                                          conv2d_nhwc, conv_flops)
from ddp_tpu_torch.ops.gather import (gather_batch, gather_batch_plain,
                                      gather_rows, gather_rows_plain)
from ddp_tpu_torch.obs.__main__ import main as obs_main
from ddp_tpu_torch.obs.registry import parse_exposition
from ddp_tpu_torch.optim import SGDConfig, triangular_lr
from ddp_tpu_torch.parallel import dist, drill
from ddp_tpu_torch.parallel.dist import free_port
from ddp_tpu_torch.parallel.pp.partition import (format_stage_table,
                                                 plan_stages)
from ddp_tpu_torch.parallel.tp.plan import (expected_collectives,
                                            format_plan_table,
                                            plan_for_model)
from ddp_tpu_torch.profile_resident import (_group, device_events,
                                            kernel_launches)
from ddp_tpu_torch.repeat_check import compare, run_entries
from ddp_tpu_torch.resilience import lineage
from ddp_tpu_torch.resilience.faults import FAULT_ENV
from ddp_tpu_torch.serve import (DynamicBatcher, QueueFull, ServeEngine,
                                 ServeFleet, ServeHTTPServer, percentiles)
from ddp_tpu_torch.train import ckpt_shard
from ddp_tpu_torch.train.checkpoint import (load_checkpoint, restore,
                                           save_checkpoint)
from ddp_tpu_torch.train.epoch import make_train_epoch
from ddp_tpu_torch.train.evaluate import evaluate_resident
from ddp_tpu_torch.train.step import (_as_input, init_train_state,
                                      make_eval_apply, micro_from_batch,
                                      to_device)
from ddp_tpu_torch.train.trainer import (Trainer, _stack_groups,
                                         micro_batches)

ROOT = os.path.dirname(os.path.abspath(__file__))
BF16 = torch.bfloat16

# H100 SXM peaks (NVIDIA's data sheet): memory rate, float32 on the CUDA
# cores (TF32 is another precision, not the same work), bf16 tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 66.9e12
BF16_FLOP_PER_S = 989e12
# 9,040 images: 17 full batches and a ragged one of 336 rows, and a test
# split of 2,260 (4 full batches and a tail of 212), the remainders of
# CIFAR-10's 50,000 and 12,500, so every batch shape of the full epoch runs
# in a fifth of its steps.
MAIN_ARGS = ["1", "1", "--batch_size", "512", "--resident", "--synthetic",
             "--synthetic_size", "9040"]
MAIN_TRAIN_STEPS, MAIN_EVAL_STEPS = 18, 5  # 9,040 / 512 and 2,260 / 512
# Parity of the card against the CPU, float32 with TF32 off: cuDNN and the
# CPU's convolutions sum in different orders, and three SGD steps carry
# those last-bit differences into the weights.  1e-4 is two orders above
# the ~1e-6 such rounding gives at these widths.
PARITY_TOL = 1e-4
# The conv kernel against a float64 plain result, as a share of max|y|.
# float32: K = 9*Cin products summed in another order than the reference;
# the rounding of such sums is ~1e-6..1e-5 of max|y| at K <= 4608, and
# 1e-4 leaves an order of magnitude.  bfloat16: the same fp32 sums, then
# the output rounded to bfloat16 (at most half an ulp, 2^-8 of |y|), so one
# ulp at the top of the range, 2^-7 of max|y|, bounds it with room for the
# sums.
CONV_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
# The routes' edge cases, (batch, H, Cin, Cout): a ragged last tile (3
# images of 8x8 in tiles of two), a box across 8 images (4x4), Cout = 64,
# 16x16 128->256, and channel counts that are multiples of 8 but not of 64.
CONV_EDGE_CASES = [(3, 8, 256, 512), (8, 4, 512, 512), (4, 16, 128, 64),
                   (8, 16, 128, 256), (2, 8, 40, 24), (5, 32, 64, 72)]
# The probe's timed repeats a chain: one keeps the smoke inside its limit,
# and the short and long chains still give each candidate's marginal cost.
PROBE_REPEATS = 1
# The resident-batch kernel's draw cases: random, both ends of the crop
# window with every image flipped or none, and the eval form (no draws).
BATCH_DRAWS = ("random", "0_flip", "0_noflip", "8_flip", "8_noflip", "eval")
# Serving: the JAX server's default buckets, and a closed loop of clients
# each sending requests of 1-32 rows.
SERVE_BUCKETS = (1, 8, 32, 128)
SERVE_CLIENTS, SERVE_REQUESTS_PER_CLIENT, SERVE_MAX_ROWS = 8, 15, 32
# torch.profiler can miss the start of a session's device timeline (the
# first forward's copy in and first kernel, or more: ROADMAP C3).  A
# serving session runs one forward first, then idles PROFILE_SETTLE_S, and
# counts only the forwards after that: the last ones of its timeline, cut
# after each copy out.
PROFILE_SETTLE_S = 0.05
# The serving fleet: replicas on the one card; hot swaps under the load of
# SERVE_CLIENTS closed-loop threads, each cycling through FLEET_POOL
# requests of 1-SERVE_MAX_ROWS rows, FLEET_STEADY_S before the first swap
# and FLEET_AFTER_SWAP_S after each.  F2's server runs under FLEET_FAULT
# (the CI drill's kill) and is republished by a singlegpu --resume child;
# its clients send 1-FLEET_F2_ROWS rows, as tools/ci_fleet_load.py does.
FLEET_REPLICAS, FLEET_SWAPS, FLEET_POOL = 2, 3, 16
FLEET_STEADY_S, FLEET_AFTER_SWAP_S = 1.5, 0.5
FLEET_FAULT = "crash_replica@requests=25,replica=0"
FLEET_F2_ROWS = 4
FLEET_REPUBLISH_ARGS = ["2", "1", "--batch_size", "512", "--resident",
                        "--synthetic", "--synthetic_size", "10240"]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, inputs, repeats: int = 60,
              sleep_cycles: int = 200_000) -> float:
    """Median device time of ``fn(x)`` over ``repeats`` launches after a
    warm-up, each bracketed by CUDA events.  A sleep kernel queued ahead of
    each launch keeps the card busy while the host enqueues, so the events
    time the device work and not the host's launch gap; ``sleep_cycles``
    must outlast the enqueue of ``fn``."""
    for x in inputs[:5]:
        fn(x)
    pairs = []
    for i in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn(inputs[i % len(inputs)])
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_phase(gen: torch.Generator) -> dict:
    """row_gather against its plain version (exact), then timed."""
    table = torch.randint(0, 256, (50000, 32, 32, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    max_err = 0.0
    cases = [(table, n) for n in (512, 336)]
    for shape, dtype in (((8192, 32, 32, 3), torch.float32),
                         ((4096, 5, 7, 3), torch.uint8),      # 105-byte rows
                         ((4096, 3), torch.float32)):         # 12-byte rows
        t = torch.randn(shape, device="cuda", generator=gen).to(dtype) \
            if dtype.is_floating_point else torch.randint(
                0, 256, shape, dtype=dtype, device="cuda", generator=gen)
        cases.append((t, 512))
    for t, n in cases:
        m = t.shape[0]
        for idx_dtype in (torch.int32, torch.int64):
            idx = torch.randint(-20, m + 20, (n,), dtype=idx_dtype,
                                device="cuda", generator=gen)
            idx[:4] = torch.tensor([-1, m, -(2**31) + 1, 2**31 - 1],
                                   dtype=idx_dtype)
            got, want = gather_rows(t, idx), gather_rows_plain(t, idx)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"row_gather differs from its plain version at "
                  f"{tuple(t.shape)} {t.dtype}, N={n}, {idx_dtype}")
            max_err = max(max_err, float((got.double() - want.double())
                                         .abs().max()))
    # Timing at the main path's shape: a fresh in-range index row per
    # launch, as each step gathers other rows of the 150 MB table.
    n, d = 512, 32 * 32 * 3
    idxs = [torch.randperm(50000, device="cuda", generator=gen)[:n].int()
            for _ in range(60)]
    ms = median_ms(lambda i: gather_rows(table, i), idxs)
    plain_ms = median_ms(lambda i: gather_rows_plain(table, i), idxs)
    library_ms = median_ms(lambda i: torch.index_select(table, 0, i), idxs)
    ms_again = median_ms(lambda i: gather_rows(table, i), idxs)
    bound_ms = (2 * n * d + 4 * n) / HBM_BYTES_PER_S * 1e3
    print(f"row_gather N={n} D={d}: kernel {ms:.6f} ms (again "
          f"{ms_again:.6f}), plain {plain_ms:.6f} ms, index_select "
          f"{library_ms:.6f} ms, bound {bound_ms:.6f} ms", flush=True)
    return {"name": "row_gather", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/gather.cu",
            "replaces": "ddp_tpu/ops/gather.py:37",
            "max_abs_err": max_err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def _profiled_us(events: dict, fragment: str) -> float:
    """Mean device us per launch of the kernels of ``device_events`` whose
    name holds ``fragment``."""
    hits = [v for k, v in events.items() if fragment in k]
    check(bool(hits), f"no kernel named like {fragment!r} in the profile")
    return sum(ms for ms, _ in hits) / sum(n for _, n in hits) * 1e3


def enqueue_us(fn, inputs, calls: int = 200) -> float:
    """Host microseconds per call to enqueue ``fn`` (no synchronise inside
    the timed loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(calls):
        fn(inputs[k % len(inputs)])
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _batch_draws(kind: str, n: int, gen: torch.Generator):
    if kind == "eval":
        return None
    if kind == "random":
        return make_draws(gen, n, torch.device("cuda"))
    off, flip = kind.split("_")
    full = torch.full((n,), int(off), dtype=torch.int64, device="cuda")
    return full, full.clone(), torch.full((n,), flip == "flip",
                                          device="cuda")


def _batch_cases(table: torch.Tensor, labels: torch.Tensor,
                 gen: torch.Generator, dtype: torch.dtype) -> tuple:
    """gather_batch's ``dtype`` form against its plain version, images and
    labels exactly, at N = 512 and the ragged 336, int32 and int64 indices
    with out-of-range and negative ones, and every BATCH_DRAWS kind.
    Returns the number of cases and the largest difference (0)."""
    m = table.shape[0]
    cases, max_err = 0, 0.0
    for n in (512, 336):
        for idx_dtype in (torch.int32, torch.int64):
            idx = torch.randint(-20, m + 20, (n,), dtype=idx_dtype,
                                device="cuda", generator=gen)
            idx[:4] = torch.tensor([-1, m, -(2**31) + 1, 2**31 - 1],
                                   dtype=idx_dtype)
            for kind in BATCH_DRAWS:
                draws = _batch_draws(kind, n, gen)
                images, got = gather_batch(table, labels, idx, draws,
                                           dtype=dtype)
                want_images, want = gather_batch_plain(table, labels, idx,
                                                       draws, dtype=dtype)
                torch.cuda.synchronize()
                check(images.dtype == dtype and
                      torch.equal(images, want_images) and
                      torch.equal(got, want),
                      f"gather_batch {dtype} differs from its plain version "
                      f"at N={n}, {idx_dtype}, draws {kind}")
                check(images.permute(0, 3, 1, 2).is_contiguous(),
                      "gather_batch's images are not stored channels-first")
                max_err = max(max_err, float((images.float()
                                              - want_images.float())
                                             .abs().max()))
                cases += 1
    return cases, max_err


def batch_phase(gen: torch.Generator) -> tuple:
    """gather_batch against its plain version (exact), then timed beside
    the sequence it replaced.  Returns its kernels-line entry and
    row_gather's profiled time."""
    m = 50000
    table = torch.randint(0, 256, (m, 32, 32, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    labels = torch.randint(0, 10, (m,), device="cuda", generator=gen)
    cases, max_err = _batch_cases(table, labels, gen, torch.float32)
    ramp = torch.zeros((1, 32, 32, 3), dtype=torch.uint8, device="cuda")
    ramp.view(-1)[:256] = torch.arange(256, device="cuda")
    images, _ = gather_batch(ramp, labels[:1], torch.zeros(
        1, dtype=torch.int32, device="cuda"))
    check(np.array_equal(images.cpu().numpy().reshape(-1)[:256],
                         np.arange(256, dtype=np.float32) / np.float32(255)),
          "gather_batch's u8/255 differs from numpy's float32 division")
    print(f"gather_batch: {cases} cases equal to the plain version (images "
          f"and labels), every byte value equal to numpy's u8/255", flush=True)

    n = 512
    args = [(torch.randperm(m, device="cuda", generator=gen)[:n].int(),
             make_draws(gen, n, torch.device("cuda"))) for _ in range(60)]
    fused = lambda a: gather_batch(table, labels, *a)
    replaced = lambda a: (_as_input(crop_flip(gather_rows(table, a[0]),
                                              *a[1])),
                          labels[a[0].long()])
    ms = median_ms(fused, args)
    plain_ms = median_ms(lambda a: gather_batch_plain(table, labels, *a),
                         args, sleep_cycles=2_000_000)
    replaced_ms = median_ms(replaced, args, sleep_cycles=2_000_000)
    ms_again = median_ms(fused, args)
    fused_enqueue, replaced_enqueue = (enqueue_us(fused, args),
                                       enqueue_us(replaced, args))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args[:50]:
            fused(a)
        for a in args[:50]:
            gather_rows(table, a[0])
        torch.cuda.synchronize()
    events = device_events(prof)
    kernel_us = _profiled_us(events, "gather_batch_kernel")
    row_us = _profiled_us(events, "row_gather_kernel")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args[:20]:
            replaced(a)
        torch.cuda.synchronize()
    replaced_launches = kernel_launches(device_events(prof)) / 20
    nbytes = (n * 3 * 32 * 32 * 4 + n * 3072 + n * 4 + n * (8 + 8 + 1)
              + 2 * n * 8)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    share = bound_ms * 1e3 / kernel_us
    print(f"gather_batch N={n}: kernel {ms:.6f} ms (again {ms_again:.6f}) by "
          f"the event bracket, {kernel_us:.3f} us by the profiler; bound "
          f"{bound_ms:.6f} ms ({nbytes} bytes), {share:.1%} of it by the "
          f"profiler; plain {plain_ms:.6f} ms; replaced sequence "
          f"{replaced_ms:.6f} ms, {replaced_launches:g} launches, enqueue "
          f"{replaced_enqueue:.1f} us against the kernel's "
          f"{fused_enqueue:.1f} us; row_gather {row_us:.3f} us by the "
          f"profiler", flush=True)
    entry = {"name": "gather_batch", "route": "cuda",
             "source": "ddp_tpu_torch/csrc/gather.cu",
             "replaces": "ddp_tpu/ops/gather.py:37",
             "also_replaces": ["ddp_tpu/data/device_augment.py:44",
                               "ddp_tpu/data/device_augment.py:57",
                               "ddp_tpu/train/step.py:53"],
             "max_abs_err": max_err, "ms": ms, "kernel_ms": ms,
             "ms_again": ms_again, "profiler_ms": kernel_us / 1e3,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
             "bound_share_profiler": share,
             "library_ms": None,
             "replaced_sequence": "gather_rows + crop_flip + labels[idx] + "
                                  "_as_input",
             "replaced_ms": replaced_ms,
             "replaced_launches": replaced_launches,
             "replaced_enqueue_us": replaced_enqueue,
             "enqueue_us": fused_enqueue, "cases": cases}
    return entry, row_us / 1e3


def parity_phase() -> None:
    """Three resident steps (two full batches and a ragged tail) of a
    narrow VGG on the card against the CPU, same weights and draws."""
    arch = [8, "M", 16, "M", 512, "M"]
    ds, _ = synthetic(n_train=20, n_test=8, seed=1)
    loader = TrainLoader(ds, 8, seed=0)
    full, tail = loader.epoch_index_matrix()
    check(full.shape == (2, 8) and tail.shape == (4,), "parity batches")
    rng = np.random.default_rng(0)
    draws_np = [(rng.integers(0, 9, (2, n)), rng.random(n) < 0.5)
                for n in (8, 8, 4)]
    sched = lambda s: triangular_lr(s, base_lr=0.05, num_epochs=1,
                                    steps_per_epoch=3)
    cpu_model = VGG(arch, generator=torch.Generator().manual_seed(0))
    results = {}
    launches = gather_batch.launches
    for device in ("cuda", "cpu"):
        model = copy.deepcopy(cpu_model).to(device)
        res = ResidentData(ds, torch.device(device))
        state = init_train_state(model)
        run = make_train_epoch(model, SGDConfig(lr=0.05), sched,
                               device_augment=True)

        def draws(step, n, micro=0, device=device):
            off, flip = draws_np[step]
            check(micro == 0, "parity draws of one micro-batch a step")
            check(off.shape[1] == n, "parity draw size")
            off = torch.from_numpy(off).to(device)
            return off[0], off[1], torch.from_numpy(flip).to(device)

        losses = torch.cat([
            run(state, res.images, res.labels,
                torch.from_numpy(rows).to(device), draws)
            for rows in (full, tail[None])])
        results[device] = (losses.cpu(),
                           {k: v.cpu() for k, v in
                            model.state_dict().items()})
    check(gather_batch.launches == launches + 3,
          "the card's parity steps did not run the gather_batch kernel")
    (lg, sg), (lc, sc) = results["cuda"], results["cpu"]
    loss_err = float((lg - lc).abs().max())
    param_err = max(float((sg[k] - sc[k]).abs().max()) for k in sc)
    print(f"parity (narrow VGG, 3 resident steps, cuda vs cpu): max |loss "
          f"diff| {loss_err:.3e}, max |state diff| {param_err:.3e}, "
          f"tolerance {PARITY_TOL:g}", flush=True)
    check(bool(torch.isfinite(lg).all()), "parity losses not finite")
    check(loss_err <= PARITY_TOL and param_err <= PARITY_TOL,
          "card and CPU disagree beyond the tolerance")


def checkpoint_phase(out: dict, path: str) -> float:
    """The main path's epoch-0 file, bit for bit against the trained state;
    then a resumed run of the CLI that must train no step.  Returns the
    seconds of one synchronous ``save_checkpoint`` of the trained state."""
    ckpt = load_checkpoint(path)
    state = out["state"]
    saved = interop.state_dict_from_jax("vgg", ckpt.params, ckpt.batch_stats)
    live = state.model.state_dict()
    check(set(saved) == set(live), "checkpoint keys differ from the model's")
    check(all(torch.equal(saved[k], live[k].cpu()) for k in live),
          "checkpoint weights/buffers differ from the trained model")
    momentum = interop.momentum_list_from_tree(state.model, ckpt.momentum)
    check(len(momentum) == len(state.momentum) and all(
        torch.equal(a, b.cpu()) for a, b in zip(momentum, state.momentum)),
        "checkpoint momentum differs from the trained momentum")
    check(ckpt.step == state.step == MAIN_TRAIN_STEPS and ckpt.epoch == 0
          and ckpt.data_state["epoch"] == 1 and ckpt.data_state["offset"] == 0,
          f"checkpoint meta: step {ckpt.step}, epoch {ckpt.epoch}, "
          f"data_state {ckpt.data_state}")
    t0 = time.perf_counter()  # one more write of the same state, timed
    save_checkpoint(path + ".timed", state.model, state.momentum,
                    state.step, 0)
    write_s = time.perf_counter() - t0
    print(f"checkpoint: {os.path.getsize(path)} bytes, {len(live)} "
          f"state tensors and {len(momentum)} momentum buffers equal bit "
          f"for bit; step {ckpt.step}, epoch {ckpt.epoch}; a write takes "
          f"{write_s:.3f} s", flush=True)
    accuracy = out["accuracy"]
    again = cli.main(MAIN_ARGS + ["--snapshot_path", path, "--resume"])
    check(again["loss_history"] == [],
          f"the resumed run trained {len(again['loss_history'])} steps")
    resumed = again["state"]
    check(resumed.step == state.step and all(
        torch.equal(a, b) for a, b in zip(
            resumed.model.state_dict().values(),
            state.model.state_dict().values())) and all(
        torch.equal(a, b) for a, b in zip(resumed.momentum,
                                          state.momentum)),
        "the resumed run's weights, buffers or momentum differ from the "
        "trained run's")
    check(again["accuracy"] == accuracy,
          f"resumed accuracy {again['accuracy']} != {accuracy}")
    print(f"resume: 0 steps trained, state bit for bit the trained run's, "
          f"accuracy {again['accuracy']:.2f}% (the trained run's "
          f"{accuracy:.2f}%)", flush=True)
    return write_s


DDP_ARCH = [8, "M", 16, "M", 512, "M"]


def concurrently(fns: dict) -> dict:
    """Each callable of ``fns`` on a thread of its own, all at once: their
    results by name, in ``fns``'s order; the first error is raised after
    every join."""
    results, errors = {}, []

    def body(name, fn):
        try:
            results[name] = fn()
        except BaseException as e:  # re-raised below, after the joins
            errors.append(e)

    threads = [threading.Thread(target=body, args=item)
               for item in fns.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {name: results[name] for name in fns}


def run_multigpu(args: list) -> tuple:
    """``python -m ddp_tpu_torch.multigpu args`` as a subprocess (one rank
    per card): its ``--result_json`` summary, process wall seconds and
    checkpoint."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ddp.json")
        snapshot = os.path.join(tmp, "checkpoint.pt")
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "ddp_tpu_torch.multigpu", *args,
             "--snapshot_path", snapshot, "--result_json", path],
            timeout=900)
        wall_s = time.time() - t0
        check(r.returncode == 0, f"multigpu {' '.join(args)} exited with "
              f"{r.returncode}")
        with open(path) as f:
            res = json.load(f)
        return res, wall_s, load_checkpoint(snapshot)


def ddp_phase(out: dict, card: str) -> tuple:
    """The multigpu entry at world 1 over NCCL beside the in-process
    singlegpu run ``out``, the same pair under deterministic mode, then a
    world-2 epoch on the card over gloo against the CPU.  Returns the
    path's gather_batch launches and the world-1 run's summary."""
    res, wall_s, ckpt = run_multigpu(MAIN_ARGS)
    res["wall_s"] = wall_s
    launches = res["kernel_launches"]
    check(res["world"] == 1 and res["backend"] == "nccl",
          f"multigpu ran at world {res['world']} on {res['backend']}")
    check(launches == {"gather_batch": MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS,
                       "gather_batch_bf16": 0, "row_gather": 0,
                       "conv3x3": 0},
          f"multigpu's kernel launches {launches}")
    check(res["collectives"] == {"all_reduce": 2 * MAIN_TRAIN_STEPS + 2,
                                 "broadcast": 1},
          f"multigpu's collectives {res['collectives']}")
    losses, single = res["loss_history"], out["loss_history"]
    check(len(losses) == MAIN_TRAIN_STEPS and
          all(math.isfinite(x) for x in losses), "multigpu's losses")
    first3 = max(abs(a - b) for a, b in zip(losses[:3], single[:3]))
    check(first3 <= PARITY_TOL, f"multigpu's first 3 losses differ from "
          f"singlegpu's by {first3:.3e}")
    check(ckpt.step == MAIN_TRAIN_STEPS and ckpt.epoch == 0,
          f"multigpu's checkpoint: step {ckpt.step}, epoch {ckpt.epoch}")
    step_ms = statistics.median(res["step_ms"])
    single_ms = statistics.median(out["step_ms"])
    print(f"ddp world 1 ({card}): backend {res['backend']}, median "
          f"{step_ms:.3f} ms/step ({512 / step_ms * 1e3:.1f} samples/s), "
          f"singlegpu {single_ms:.3f} ms/step "
          f"({512 / single_ms * 1e3:.1f} samples/s), ratio "
          f"{step_ms / single_ms:.4f}; train {res['training_seconds']:.2f} "
          f"s, eval {res['eval_seconds']:.2f} s, process wall {wall_s:.2f} "
          f"s; gather_batch launches "
          f"{launches['gather_batch']}, collectives {res['collectives']}; "
          f"first 3 losses within {first3:.3e} of singlegpu's, max |loss "
          f"diff| over the epoch "
          f"{max(abs(a - b) for a, b in zip(losses, single)):.3e}; accuracy "
          f"{res['accuracy']:.2f}% (singlegpu {out['accuracy']:.2f}%); "
          f"checkpoint step {ckpt.step}", flush=True)

    # Both entries at once, on the strategy phase's 10,240 images:
    # deterministic mode holds each run's arithmetic whatever else the card
    # runs.
    t0 = time.time()
    runs = concurrently({e: functools.partial(
        run_entries, [e], FLAG_ARGS, deterministic=True)
        for e in ("singlegpu", "multigpu")})
    pair, = compare([runs["singlegpu"][0], runs["multigpu"][0]])
    print(f"ddp world 1 against singlegpu, deterministic mode ({card}): "
          f"{pair} ({time.time() - t0:.1f} s)", flush=True)
    check(pair["bit_equal"], "under deterministic mode the world-1 history "
          "differs from singlegpu's")

    # World 2 on the one card: gloo, the only backend that takes two ranks
    # on one device, against the same ranks on the CPU (both at once).
    train, test = synthetic(n_train=40, n_test=24, seed=1)
    model = VGG(DDP_ARCH, generator=torch.Generator().manual_seed(0))
    runs = concurrently({device: functools.partial(
        drill.run, drill.spec(DDP_ARCH, model.state_dict(), train, test,
                              batch=8, lr=0.05, seed=0, augment=True,
                              device=device, backend="gloo"),
        2, same_device=True, timeout=300) for device in ("cuda", "cpu")})
    worst = 0.0
    for got, want in zip(runs["cuda"], runs["cpu"]):
        check(got["backend"] == "gloo" and got["device"] == "cuda:0" and
              got["steps"] == 3, f"world-2 card rank {got['rank']}: "
              f"{got['backend']} on {got['device']}, {got['steps']} steps")
        check(got["train_launches"] == 3 and got["eval_launches"] == 2,
              f"world-2 card rank {got['rank']} launched gather_batch "
              f"{got['train_launches']} + {got['eval_launches']} times")
        errs = [float((got["losses"] - want["losses"]).abs().max())]
        errs += [float((got["state_dict"][k] - v).abs().max())
                 for k, v in want["state_dict"].items()]
        errs += [float((a - b).abs().max())
                 for a, b in zip(got["momentum"], want["momentum"])]
        worst = max(worst, *errs)
        check(bool(torch.isfinite(got["losses"]).all()),
              "world-2 losses not finite")
    check(worst <= PARITY_TOL, f"world 2 on the card differs from the CPU "
          f"by {worst:.3e}")
    card_launches = sum(g["train_launches"] + g["eval_launches"]
                        for g in runs["cuda"])
    print(f"ddp world 2 on one card over gloo ({card}): 3 steps, max |diff| "
          f"against the CPU {worst:.3e} (losses, weights, BN buffers, "
          f"momentum; tolerance {PARITY_TOL:g}); correct/total card "
          f"{runs['cuda'][0]['correct']}/{runs['cuda'][0]['total']}, cpu "
          f"{runs['cpu'][0]['correct']}/{runs['cpu'][0]['total']}; "
          f"gather_batch launches on the card ranks {card_launches}",
          flush=True)
    return launches["gather_batch"] + card_launches, res


# The strategy phase: a 10,240-image epoch (20 batches of 512, 5 eval
# batches) for each flag's cost.
FLAG_ARGS = MAIN_ARGS[:-1] + ["10240"]
FLAG_TRAIN_STEPS, FLAG_EVAL_STEPS = 20, 5
STRATEGY_FLAGS = ["--grad_accum", "2", "--sync_bn", "--shard_update"]
# Every world-2 card-against-CPU drill needs each ReLU input and each
# max-pool window's top two inputs at least this far apart
# (``drill.margins``, in float64 at the start weights): float32 rounding
# moves an activation by ~1e-7 of its scale between the two devices, and a
# decision nearer than that can go either way, moving that element's whole
# cotangent.  The strategy drill's seed 0 puts a ReLU input 3.7e-7 from its
# kink (its momentum then parted by 1.5e-3 while the losses agreed to
# 2e-7); at seed 3 both margins stay above 2.1e-6.
KINK_MARGIN, STRATEGY_DRILL_SEED = 1e-6, 3


def sync_bn_all_reduces(model: torch.nn.Module) -> int:
    """The sync-BN all-reduces of one micro-batch, counted from the code: 3
    a fused BN+ReLU (2 for the statistics, 1 for dβ/dγ in its backward)
    and 4 a plain BatchNorm (its 2 statistics and, in the backward,
    ``_MeanOverRanks``'s transpose of each)."""
    return sum(3 if isinstance(m, BNReLU) else 4 if isinstance(m, BatchNorm)
               else 0 for m in model.modules())


def model_collectives(model: torch.nn.Module, steps: int, micro: int, *,
                      sync_bn: bool, zero: bool, saves: int) -> tuple:
    """The collectives of one rank of a run of ``model``, counted from the
    code, and the formula: the sync-BN all-reduces of each micro-batch
    (:func:`sync_bn_all_reduces`); per optimizer step the buffers' average
    (none for a model without buffers, DeepNN) and the gradients'
    all-reduce, or under ZeRO one reduce-scatter and one all-gather; the
    epoch's loss sum and the eval counters; the start's broadcast; under
    ZeRO ``saves`` all-gathers of the momentum (one per checkpoint; the
    drill gathers it once at its end)."""
    per_micro = sync_bn_all_reduces(model) * sync_bn
    per_step = (not zero) + bool(dist._buffers(model))
    want = {"all_reduce": per_micro * micro + per_step * steps + 2,
            "broadcast": 1}
    formula = (f"all_reduce = {per_micro}*{micro} micro + {per_step}*"
               f"{steps} steps + 2")
    if zero:
        want.update(reduce_scatter=steps, all_gather=steps + saves)
        formula += (f", reduce_scatter = {steps} steps, all_gather = "
                    f"{steps} steps + {saves} momentum gather(s)")
    return want, formula


def strategy_phase(ddp: dict, card: str) -> tuple:
    """The strategy flags: the composed flags at full width over NCCL at
    world 1 beside the DDP phase's run ``ddp``, each flag alone for its
    cost, the flags' bit-equalities under deterministic mode, and a
    world-2 epoch with the flags composed on the card over gloo against
    the CPU.  Returns the path's gather_batch launches, the composed run's
    summary, the world-2 epoch's decision margin and the unflagged
    deterministic run's summary."""
    res, wall_s, ckpt = run_multigpu(MAIN_ARGS + STRATEGY_FLAGS)
    steps = -(-(MAIN_TRAIN_STEPS - 1) // 2) + 1  # the full batches, the tail
    launches = res["kernel_launches"]
    check((res["world"], res["backend"], res["grad_accum"], res["sync_bn"],
           res["shard_update"]) == (1, "nccl", 2, True, True),
          f"the strategy run's summary {res}")
    check(launches == {"gather_batch": MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS,
                       "gather_batch_bf16": 0, "row_gather": 0,
                       "conv3x3": 0},
          f"the strategy run's kernel launches {launches}")
    vgg = get_model("vgg")
    want, formula = model_collectives(vgg, steps, MAIN_TRAIN_STEPS,
                                      sync_bn=True, zero=True, saves=1)
    check(res["collectives"] == want,
          f"the strategy run's collectives {res['collectives']}, expected "
          f"{want} ({formula})")
    losses = res["loss_history"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"the strategy run's losses: {len(losses)}, expected {steps}")
    check(ckpt.step == steps and ckpt.epoch == 0,
          f"the strategy run's checkpoint: step {ckpt.step}, epoch "
          f"{ckpt.epoch}")
    step_ms = statistics.median(res["step_ms"])
    ddp_ms = statistics.median(ddp["step_ms"])
    print(f"strategy, --grad_accum 2 --sync_bn --shard_update at world 1 "
          f"({card}): backend {res['backend']}, {steps} optimizer steps of "
          f"2 x 512 (the last two 512 and 336), median {step_ms:.3f} ms per "
          f"optimizer step ({1024 / step_ms * 1e3:.1f} samples/s); the DDP "
          f"phase's unflagged run {ddp_ms:.3f} ms/step "
          f"({512 / ddp_ms * 1e3:.1f} samples/s); train "
          f"{res['training_seconds']:.2f} s (unflagged "
          f"{ddp['training_seconds']:.2f}), process wall {wall_s:.2f} s "
          f"(unflagged {ddp['wall_s']:.2f}); accuracy {res['accuracy']:.2f}% "
          f"(unflagged {ddp['accuracy']:.2f}%); gather_batch launches "
          f"{launches['gather_batch']}; collectives {res['collectives']} "
          f"= {formula}; first/last loss {losses[0]:.4f}/{losses[-1]:.4f}; "
          f"checkpoint step {ckpt.step}", flush=True)

    # Each flag alone at full width on a 20-batch epoch, beside no flag.
    for flags, accum, sync_bn, zero in (
            ([], 1, False, False), (["--grad_accum", "2"], 2, False, False),
            (["--sync_bn"], 1, True, False),
            (["--shard_update"], 1, False, True)):
        # In this process (``model_run``): the DDP phase's subprocesses
        # already cover the spawner, and each process would add ~20 s.
        with tempfile.TemporaryDirectory() as tmp:
            one = model_run(FLAG_ARGS + flags, os.path.join(tmp, "c.pt"))
        wall_s = one["wall_s"]
        n = FLAG_TRAIN_STEPS // accum
        want, formula = model_collectives(vgg, n, FLAG_TRAIN_STEPS,
                                          sync_bn=sync_bn, zero=zero, saves=1)
        check(one["collectives"] == want and len(one["loss_history"]) == n
              and one["kernel_launches"]["gather_batch"]
              == FLAG_TRAIN_STEPS + FLAG_EVAL_STEPS and
              all(math.isfinite(x) for x in one["loss_history"]),
              f"multigpu {flags}: {len(one['loss_history'])} steps, "
              f"collectives {one['collectives']} (expected {want}), "
              f"launches {one['kernel_launches']}")
        ms = statistics.median(one["step_ms"])
        print(f"strategy, {' '.join(flags) or 'no flag'} alone at world 1 "
              f"({card}): {n} optimizer steps of {accum} x 512, median "
              f"{ms:.3f} ms per optimizer step ({512 * accum / ms * 1e3:.1f}"
              f" samples/s), train {one['training_seconds']:.2f} s, wall "
              f"{wall_s:.2f} s; collectives {one['collectives']} = "
              f"{formula}", flush=True)

    # Deterministic mode: the sharded update and A = 1 are the unflagged
    # arithmetic, bit for bit.  The three runs at once: deterministic mode
    # holds each run's arithmetic whatever else the card runs.
    t0 = time.time()
    det = concurrently({name: functools.partial(
        run_entries, ["multigpu"], FLAG_ARGS + extra, deterministic=True)
        for name, extra in (("plain", []), ("zero", ["--shard_update"]),
                            ("accum1", ["--grad_accum", "1"]))})
    plain, zero_run, accum1 = (det[k][0] for k in ("plain", "zero",
                                                    "accum1"))
    for name, other in (("--shard_update", zero_run),
                        ("--grad_accum 1", accum1)):
        pair, = compare([plain, other])
        print(f"strategy, {name} against no flag at world 1, deterministic "
              f"mode ({card}): {pair}", flush=True)
        check(pair["bit_equal"], f"under deterministic mode {name} differs "
              f"from the unflagged run")
    print(f"strategy deterministic runs: {time.time() - t0:.1f} s",
          flush=True)

    # World 2 on the one card over gloo, the flags composed, against the
    # same 2 ranks on the CPU: 20 images a rank, groups of 2 batches of 8
    # and the ragged 4.
    train, test = synthetic(n_train=40, n_test=24, seed=1)
    model = VGG(DDP_ARCH, generator=torch.Generator().manual_seed(0))
    margin = min(drill.margins(model, train, batch=8,
                               seed=STRATEGY_DRILL_SEED, world=2, accum=2))
    check(margin >= KINK_MARGIN, f"the strategy world-2 epoch has a ReLU "
          f"input or a max-pool gap {margin:.3e} from flipping")
    runs = concurrently({device: functools.partial(
        drill.run, drill.spec(DDP_ARCH, model.state_dict(), train, test,
                              batch=8, lr=0.05, seed=STRATEGY_DRILL_SEED,
                              augment=True, device=device, backend="gloo",
                              grad_accum=2, sync_bn=True,
                              shard_update=True),
        2, same_device=True, timeout=300) for device in ("cuda", "cpu")})
    want, formula = model_collectives(model, 2, 3, sync_bn=True, zero=True,
                                      saves=1)
    worst = 0.0
    for got, ref in zip(runs["cuda"], runs["cpu"]):
        check(got["backend"] == "gloo" and got["device"] == "cuda:0" and
              got["steps"] == 2 and got["collectives"] == want,
              f"strategy world-2 card rank {got['rank']}: {got['backend']} "
              f"on {got['device']}, {got['steps']} steps, collectives "
              f"{got['collectives']} (expected {want})")
        check(got["train_launches"] == 3 and got["eval_launches"] == 2,
              f"strategy world-2 card rank {got['rank']} launched "
              f"gather_batch {got['train_launches']} + "
              f"{got['eval_launches']} times")
        check(bool(torch.isfinite(got["losses"]).all()),
              "strategy world-2 losses not finite")
        errs = [float((got["losses"] - ref["losses"]).abs().max())]
        errs += [float((got["state_dict"][k] - v).abs().max())
                 for k, v in ref["state_dict"].items()]
        errs += [float((a - b).abs().max())
                 for a, b in zip(got["momentum"], ref["momentum"])]
        worst = max(worst, *errs)
    check(worst <= PARITY_TOL, f"strategy world 2 on the card differs from "
          f"the CPU by {worst:.3e}")
    card_launches = sum(g["train_launches"] + g["eval_launches"]
                        for g in runs["cuda"])
    print(f"strategy world 2 on one card over gloo, flags composed "
          f"({card}): 2 optimizer steps of 3 micro-batches, max |diff| "
          f"against the CPU {worst:.3e} (losses, weights, BN buffers, "
          f"momentum; tolerance {PARITY_TOL:g}; drill seed "
          f"{STRATEGY_DRILL_SEED}, nearest ReLU or max-pool decision "
          f"{margin:.3e} from flipping); collectives a rank "
          f"{runs['cuda'][0]['collectives']} = {formula}; momentum a rank "
          f"{runs['cuda'][0]['momentum_numel']} elements; gather_batch "
          f"launches on the card ranks {card_launches}", flush=True)
    res["wall_s"] = wall_s
    return launches["gather_batch"] + card_launches, res, margin, plain


@contextlib.contextmanager
def serving_profile(activities, engine: ServeEngine, x: np.ndarray):
    """``torch.profiler`` over the body, after a lead-in: one forward of
    ``x`` and PROFILE_SETTLE_S of idle."""
    with profile(activities=activities) as prof:
        engine.forward(x)
        time.sleep(PROFILE_SETTLE_S)
        yield prof


def profiled_forwards(engine: ServeEngine, x: np.ndarray, what: str,
                      attempts: int = 3) -> tuple:
    """Five forwards of ``x`` under ``torch.profiler`` (CPU and CUDA) after
    a lead-in (:func:`serving_profile`): ``(_seen(...), forwards run, wall
    ms)``.  The profiler can lose a session's records (none at all, or the
    first forward's copy in and kernel, late in a long process: ROADMAP
    C3); such a session says nothing about the forwards, so it is run
    again, up to ``attempts`` sessions, each said on stdout.  The session
    returned, and checked, is the first whose every forward holds its copy
    in, its copy out and its gather_batch_kernel, or else the last."""
    for attempt in range(1, attempts + 1):
        with serving_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             engine, x) as prof:
            forwards0 = engine.stats()["forward_batches"]
            t0 = time.perf_counter()
            for _ in range(5):
                engine.forward(x)
            wall_ms = (time.perf_counter() - t0) * 1e3
            replayed = engine.stats()["forward_batches"] - forwards0
        seen = _seen(prof, replayed)
        if (seen["forwards"] == replayed and not seen["short_forwards"]) \
                or attempt == attempts:
            return seen, replayed, wall_ms
        print(f"serve {what}: the profiler lost records in session "
              f"{attempt} of {attempts} ({seen['forwards']} forwards, "
              f"{seen['gather_batch_kernel']} gather_batch_kernel, "
              f"{seen['h2d']} copies in); running the session again",
              flush=True)


def _seen(prof, n: int) -> dict:
    """A session's device records forward by forward (the timeline cut
    after each copy out), for its last ``n`` forwards: how many there are,
    their gather_batch_kernel launches, kernels, copies in (H2D) and out
    (D2H), device ms (in all and by group), and which of them lack their
    copy in or their gather_batch_kernel.  ``lead_in`` says, for each
    forward recorded before those, whether it lacked them."""
    timeline = sorted(
        (e.time_range.start, e.name, e.time_range.elapsed_us() / 1e3)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    forwards, names = [], []
    for _, name, ms in timeline:
        names.append((name, ms))
        if name.startswith("Memcpy DtoH"):
            forwards.append(names)
            names = []

    def short(fwd) -> bool:
        return not (any(n.startswith("Memcpy HtoD") for n, _ in fwd)
                    and any("gather_batch_kernel" in n for n, _ in fwd))
    lead = max(len(forwards) - n, 0)
    counted = forwards[lead:]
    records = [r for fwd in counted for r in fwd]
    groups = {}
    for name, ms in records:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    return {"forwards": len(counted),
            "gather_batch_kernel": sum("gather_batch_kernel" in n
                                       for n, _ in records),
            "kernels": sum(not n.startswith(("Memcpy", "Memset"))
                           for n, _ in records),
            "h2d": sum(n.startswith("Memcpy HtoD") for n, _ in records),
            "d2h": sum(n.startswith("Memcpy DtoH") for n, _ in records),
            "busy_ms": sum(ms for _, ms in records), "groups_ms": groups,
            "short_forwards": [i for i, f in enumerate(counted) if short(f)],
            "lead_in": [short(f) for f in forwards[:lead]]}


def _post_predict(base: str, rows: np.ndarray) -> dict:
    req = urllib.request.Request(
        base + "/predict", data=json.dumps({"instances": rows.tolist()})
        .encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _scrape(base: str) -> dict:
    """``{series: value}`` of the server's ``/metrics`` text."""
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        text = r.read().decode()
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in text.splitlines() if line and line[0] != "#"}


def _http_load(engine: ServeEngine, requests: list, profiled: bool) -> dict:
    """SERVE_CLIENTS closed-loop clients, each sending its list of
    ``requests``, through DynamicBatcher and ServeHTTPServer on port 0,
    under torch.profiler (device activity only) when ``profiled``.  Every
    answer is then held against engine.forward on the same rows, /metrics
    against the stats, and the batches formed against the engine's forwards
    (one graph replay each) and, when profiled, against the
    gather_batch_kernel launches, one in each forward."""
    batcher = DynamicBatcher(engine, registry=engine.registry).start()
    httpd = ServeHTTPServer(("127.0.0.1", 0), engine, batcher)
    listener = threading.Thread(target=httpd.serve_forever, daemon=True)
    listener.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    answers = [[None] * len(reqs) for reqs in requests]
    latency_ms = [[] for _ in requests]
    errors = []

    def client(c: int) -> None:
        try:
            for k, rows in enumerate(requests[c]):
                t0 = time.perf_counter()
                answers[c][k] = _post_predict(base, rows)
                latency_ms[c].append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # reported below; the phase then fails
            errors.append(f"client {c}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(requests))]
    with (serving_profile([ProfilerActivity.CUDA], engine, requests[0][0])
          if profiled else contextlib.nullcontext()) as prof:
        fwd0 = engine.stats()["forward_batches_per_bucket"]
        bstats0 = batcher.stats()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t0
    try:
        check(not errors and not any(t.is_alive() for t in threads),
              f"HTTP load failed: {errors[:3]}")
        scraped = _scrape(base)
        bstats, estats = batcher.stats(), engine.stats()
    finally:
        drained = batcher.drain(timeout=60)
        httpd.close()
        listener.join(timeout=60)
    check(drained and not listener.is_alive(), "the server did not stop")
    n_requests = sum(len(reqs) for reqs in requests)
    rows = sum(len(r) for reqs in requests for r in reqs)
    worst = 0.0
    for reqs, outs in zip(requests, answers):
        for r, out in zip(reqs, outs):
            logits = engine.forward(r)
            check(out["predictions"] == np.argmax(logits, -1).tolist(),
                  "an HTTP /predict differs from engine.predict")
            worst = max(worst, float(np.abs(np.asarray(out["logits"])
                                            - logits).max()))
    forwards = {b: c - fwd0[b]
                for b, c in estats["forward_batches_per_bucket"].items()}
    served, submitted, batches = (bstats[k] - bstats0[k] for k in (
        "served_requests", "submitted", "batches"))
    check(served == submitted == n_requests,
          f"batcher served {served} of {n_requests}")
    check(sum(forwards.values()) == batches, f"{sum(forwards.values())} "
          f"forwards (graph replays) for {batches} batches formed")
    out = {}
    if profiled:
        seen = _seen(prof, batches)
        out = {"gather_batch_kernel_launches": seen["gather_batch_kernel"],
               "profile": seen,
               "device_busy_share": seen["busy_ms"] / (wall_s * 1e3)}
        check(seen["forwards"] == seen["gather_batch_kernel"] == batches
              and not seen["short_forwards"],
              f"{seen['gather_batch_kernel']} gather_batch_kernel launches "
              f"by the profiler for {batches} batches formed (profile: "
              f"{seen})")
    for series, want in (
            ("ddp_batcher_served_total", bstats["served_requests"]),
            ("ddp_batcher_batches_total", bstats["batches"]),
            ("ddp_engine_rows_served_total", estats["rows_served"]),
            ("ddp_engine_compiled_executables",
             estats["compiled_executables"]),
            *((f'ddp_engine_forwards_total{{bucket="{b}"}}', c)
              for b, c in estats["forward_batches_per_bucket"].items())):
        check(scraped.get(series) == want,
              f"/metrics {series} = {scraped.get(series)}, stats say {want}")
    lat = percentiles([x for c in latency_ms for x in c], (50, 99))
    return {"profiled": profiled, "clients": len(requests),
            "requests": n_requests, "rows": rows,
            "wall_s": wall_s, "rows_per_s": rows / wall_s,
            "requests_per_s": n_requests / wall_s,
            "client_p50_ms": lat["p50"], "client_p99_ms": lat["p99"],
            "server_latency_ms": bstats["latency_ms"],
            "batches": batches, "graph_replays": sum(forwards.values()),
            "forwards_per_bucket": forwards,
            "mean_batch_rows": bstats["mean_batch_rows"],
            "max_abs_logit_diff_vs_engine": worst, **out}


def serve_phase(snapshot: str) -> dict:
    """The serving path on the main path's epoch-0 file at full width: four
    graphs, each bucket bit for bit against the eager forward, accuracy
    against evaluate_resident, HTTP load, the kernel once per replay, and
    neither conv3x3 nor row_gather launched."""
    gather_batch.launches = gather_rows.launches = 0
    conv3x3_fused.launches = 0
    t0 = time.perf_counter()
    engine = ServeEngine.from_checkpoint(snapshot, "vgg",
                                         buckets=SERVE_BUCKETS)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    captured = engine.warm()
    warm_s = time.perf_counter() - t0
    wrapper_launches = gather_batch.launches
    warm_launches = wrapper_launches - captured  # the eager runs
    check(captured == engine.trace_count == len(SERVE_BUCKETS) and
          engine.stats()["compiled_executables"] == len(SERVE_BUCKETS),
          f"warm() captured {captured} graphs, expected "
          f"{len(SERVE_BUCKETS)}")
    # One eager launch per bucket before any capture, one at each capture.
    check(wrapper_launches == 2 * len(SERVE_BUCKETS),
          f"gather_batch's wrapper ran {wrapper_launches} times in warm()")
    print(f"serve: checkpoint loaded in {load_s:.3f} s; warm() captured "
          f"{captured} CUDA graphs {list(engine.buckets)} in {warm_s:.3f} s",
          flush=True)

    rng = np.random.default_rng(5)
    apply_fn = make_eval_apply(engine.model)
    per_bucket, max_err = {}, 0.0
    for b in engine.buckets:
        x = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        table = torch.from_numpy(x).cuda()
        zeros = torch.zeros(b, dtype=torch.int64, device="cuda")
        rows = torch.arange(b, dtype=torch.int32, device="cuda")
        images, _ = gather_batch(table, zeros, rows)
        want_images, _ = gather_batch_plain(table, zeros, rows)
        want = apply_fn(images).cpu().numpy()
        got = engine.forward(x)
        torch.cuda.synchronize()
        check(torch.equal(images, want_images),
              f"gather_batch's eval form differs from its plain version at "
              f"N={b}")
        check(np.array_equal(got, want), f"served logits at bucket {b} "
              f"differ from the eager forward: max|diff| "
              f"{float(np.abs(got - want).max()):.3e}")
        max_err = max(max_err, float((images - want_images).abs().max()))
        prog = engine._programs[b]
        replay_ms = median_ms(lambda _: prog.graph.replay(), [None], 30)
        # The eager forward enqueues some 70 kernels through PyTorch; the
        # sleep ahead of it (~10 ms) must outlast that enqueue.  With the
        # default sleep (~0.1 ms) the bracket times the enqueue instead,
        # wherever the device work is shorter: that reading is kept beside.
        eager_ms = median_ms(lambda _: prog.eager(), [None], 30,
                             sleep_cycles=20_000_000)
        eager_short_sleep_ms = median_ms(lambda _: prog.eager(), [None], 30)
        host = []
        for _ in range(20):
            t0 = time.perf_counter()
            engine.forward(x)
            host.append((time.perf_counter() - t0) * 1e3)
        # Five forwards under the profiler, after one it leaves out:
        # gather_batch_kernel must run once in each, between its copy in
        # and its copy out, and the wrapper not at all.
        launches = gather_batch.launches
        seen, replayed, wall_ms = profiled_forwards(engine, x, f"bucket {b}")
        in_replays = seen["gather_batch_kernel"]
        check(replayed == seen["forwards"] == seen["h2d"] == seen["d2h"]
              == in_replays == 5 and not seen["short_forwards"]
              and gather_batch.launches == launches,
              f"bucket {b}: {in_replays} gather_batch_kernel launches in "
              f"{replayed} replays under the profiler (expected one each; "
              f"profile {seen})")
        busy_ms = seen["busy_ms"]
        groups = {g: ms / 5 for g, ms in seen["groups_ms"].items()}
        per_bucket[b] = {"replay_ms": replay_ms, "eager_ms": eager_ms,
                         "eager_short_sleep_ms": eager_short_sleep_ms,
                         "forward_host_ms": statistics.median(host),
                         "gather_batch_kernel_profiled": in_replays,
                         "forwards_profiled": replayed,
                         "lead_in_short": seen["lead_in"],
                         "kernels_per_replay": seen["kernels"] / replayed,
                         "profiled_busy_ms": busy_ms / 5,
                         "profiled_idle_share": 1 - busy_ms / wall_ms,
                         "groups_ms": groups}
        print(f"serve bucket {b}: replay {replay_ms:.6f} ms (device, event "
              f"bracket), eager forward {eager_ms:.6f} ms (with the default "
              f"sleep {eager_short_sleep_ms:.6f} ms), forward() "
              f"{statistics.median(host):.3f} ms on the host (median of "
              f"20); logits equal to the eager forward bit for bit; "
              f"profiled: {seen['kernels'] / replayed:g} kernels a replay, "
              f"{in_replays} gather_batch_kernel in {replayed} replays (the "
              f"lead-in forward short: {seen['lead_in']}), "
              f"device busy "
              f"{busy_ms / 5:.3f} ms a forward, idle "
              f"{1 - busy_ms / wall_ms:.1%}, "
              + ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(
                  groups.items(), key=lambda kv: -kv[1])), flush=True)

    _, test_ds = synthetic(n_train=int(MAIN_ARGS[-1]),
                           n_test=int(MAIN_ARGS[-1]) // 4)
    served_acc = served_test_set(engine, test_ds)
    eval_acc = evaluate_resident(engine.model,
                                 ResidentData(test_ds, torch.device("cuda")),
                                 EvalLoader(test_ds, SERVE_BUCKETS[-1]))
    check(served_acc == eval_acc, f"served accuracy {served_acc} != "
          f"evaluate_resident's {eval_acc} at batch {SERVE_BUCKETS[-1]}")
    print(f"serve accuracy over {len(test_ds)} images at bucket "
          f"{SERVE_BUCKETS[-1]}: {served_acc:.4f}% (evaluate_resident "
          f"{eval_acc:.4f}%)", flush=True)

    # The same requests twice: without the profiler for the latencies, then
    # under it for the kernel's launches and the device's busy share.
    requests = [[rng.integers(0, 256, (int(rng.integers(
        1, SERVE_MAX_ROWS + 1)), 32, 32, 3), dtype=np.uint8)
        for _ in range(SERVE_REQUESTS_PER_CLIENT)]
        for _ in range(SERVE_CLIENTS)]
    gather_batch.launches = 0
    load, profiled = (_http_load(engine, requests, p) for p in (False, True))
    check(gather_batch.launches == 0, "the HTTP path called gather_batch's "
          "wrapper instead of replaying the graphs")
    check(gather_rows.launches == 0 and conv3x3_fused.launches == 0,
          f"row_gather launched {gather_rows.launches} and conv3x3 "
          f"{conv3x3_fused.launches} times on the serving path")
    for run in (load, profiled):
        print(f"serve HTTP load{' under the profiler' * run['profiled']}: "
              f"{run['clients']} clients, {run['requests']} requests of "
              f"1-{SERVE_MAX_ROWS} rows ({run['rows']} rows) in "
              f"{run['wall_s']:.3f} s: {run['rows_per_s']:.1f} rows/s, "
              f"{run['requests_per_s']:.1f} requests/s, p50 "
              f"{run['client_p50_ms']:.3f} ms, p99 {run['client_p99_ms']:.3f} "
              f"ms at the client; {run['batches']} batches, "
              f"{run['mean_batch_rows']} rows per batch, "
              f"{run['graph_replays']} graph replays"
              + (f", {run['gather_batch_kernel_launches']} gather_batch_kernel"
                 f" launches, device busy {run['device_busy_share']:.1%}"
                 if run["profiled"] else "")
              + f"; every answer equal to engine.predict (max |logit diff| "
              f"{run['max_abs_logit_diff_vs_engine']:.3e})", flush=True)

    return {"load_s": load_s, "warm_s": warm_s, "graphs": captured,
            "wrapper_launches": wrapper_launches,
            "warm_launches": warm_launches,
            "forwards": engine.stats()["forward_batches"],
            "max_abs_err": max_err, "buckets": per_bucket,
            "accuracy": served_acc, "http": load, "http_profiled": profiled,
            "row_gather_launches": gather_rows.launches,
            "conv3x3_launches": conv3x3_fused.launches}


def _conv_inputs(gen, batch, h, cin, cout):
    x = torch.randn((batch, h, h, cin), device="cuda", generator=gen)
    w = torch.randn((3, 3, cin, cout), device="cuda", generator=gen) \
        * math.sqrt(2.0 / (9 * cin))
    dy = torch.randn((batch, h, h, cout), device="cuda", generator=gen)
    return x, w, dy


def _conv_route_launch(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``conv3x3_fused(a, b)`` and the route it ran, checked: the route
    ``conv3x3_route`` names for these inputs, and exactly one launch
    counted, on that route."""
    n, h, wd, cin = a.shape
    route = conv3x3_route(n, h, wd, cin, b.shape[3], a.dtype, aligned=(
        a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0))
    before = dict(conv3x3_fused.route_launches)
    y = conv3x3_fused(a, b)
    moved = {k: v - before[k]
             for k, v in conv3x3_fused.route_launches.items()}
    check(moved == {k: int(k == route) for k in ROUTES},
          f"conv3x3 at {tuple(a.shape)} -> {b.shape[3]} {a.dtype}: route "
          f"{route} expected, the counters moved {moved}")
    return y, route


def conv_kernel_phase(gen: torch.Generator) -> dict:
    """conv3x3 forward and dgrad against the float64 plain version through
    the route each case should take, the autograd candidate against
    autograd of the plain version, the SASS check, then the times at the
    probe's two shapes and their dgrads in both dtypes."""
    cases = [(512,) + s[:3] for s in TARGET_SHAPES] + \
        [(8,) + s[:3] for s in VGG_CONV_SHAPES] + CONV_EDGE_CASES
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    conv3x3_fused.route_launches = dict.fromkeys(ROUTES, 0)
    for batch, h, cin, cout in cases:
        x, w, dy = _conv_inputs(gen, batch, h, cin, cout)
        line = []
        for dtype, tol in CONV_TOL.items():
            xd, wd, dyd = x.to(dtype), w.to(dtype), dy.to(dtype)
            for what, a, b in (("fwd", xd, wd),
                               ("dgrad", dyd,
                                _flip_transpose(wd).contiguous())):
                got, route = _conv_route_launch(a, b)
                got = got.double()
                want = _shift9_fwd(a.double(), b.double())
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                rel = err / float(want.abs().max())
                check(rel <= tol, f"conv3x3 {what} {dtype} at {batch}x{h}x"
                      f"{h} {cin}->{cout} ({route}): max|err| {err:.3e} is "
                      f"{rel:.3e} of max|y|, tolerance {tol:.3e}")
                if batch == 512 and dtype == torch.bfloat16:
                    check(route == "wgmma_bf16", f"conv3x3 {what} bf16 at "
                          f"the probe target {h}x{h} {cin}->{cout} ran on "
                          f"{route}, not on the tensor cores")
                worst[dtype] = (max(worst[dtype][0], err),
                                max(worst[dtype][1], rel))
                line.append(f"{what} {str(dtype)[6:]} {route} {rel:.2e}")
                del got, want
        print(f"conv3x3 {batch}x{h}x{h} {cin}->{cout}: " + ", ".join(line),
              flush=True)
    routes = dict(conv3x3_fused.route_launches)
    for dtype, (err, rel) in worst.items():
        print(f"conv3x3 vs float64 plain, fwd and dgrad, {len(cases)} "
              f"shapes, {dtype}: max|err| {err:.3e}, {rel:.3e} of max|y| "
              f"(tolerance {CONV_TOL[dtype]:.3e})", flush=True)
    print(f"conv3x3 check launches by route: {routes}", flush=True)

    # The autograd candidate (y, dx, dw) against autograd of the plain
    # version, float32, at the parity tests' shape.
    x, w, _ = _conv_inputs(gen, 4, 8, 16, 32)
    grads = []
    for conv in (conv2d_fused, _shift9_fwd):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = conv(xg, wg)
        dx, dw = torch.autograd.grad(y.sin().sum(), (xg, wg))
        grads.append((y.detach(), dx, dw))
    for name, a, b in zip(("y", "dx", "dw"), *grads):
        rel = float((a - b).abs().max() / b.abs().max())
        check(rel <= CONV_TOL[torch.float32],
              f"conv2d_fused {name} differs from autograd of the plain "
              f"version: {rel:.3e} of max")
    print("conv2d_fused autograd (y, dx, dw) matches the plain version's "
          "within 1e-4 of max", flush=True)

    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
         _build.library_path("conv3x3")], capture_output=True, text=True,
        check=True, timeout=120).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    print(f"conv3x3 library SASS: {hgmma} HGMMA instruction lines "
          f"(wgmma on the tensor cores: {hgmma > 0})", flush=True)
    check(hgmma > 0, "the built conv3x3 library holds no HGMMA instruction")

    # The probe's two target shapes, then their dgrads (Cout = 64 takes the
    # 64-channel tiles).
    timings = []
    for h, cin, cout in [s[:3] for s in TARGET_SHAPES] + \
            [(s[0], s[2], s[1]) for s in TARGET_SHAPES]:
        x, w, _ = _conv_inputs(gen, 512, h, cin, cout)
        flops = conv_flops(512, h, cin, cout)
        for dtype, peak in ((torch.float32, FP32_FLOP_PER_S),
                            (torch.bfloat16, BF16_FLOP_PER_S)):
            xd, wd = x.to(dtype), w.to(dtype)
            nbytes = (xd.numel() + wd.numel() + 512 * h * h * cout) \
                * xd.element_size()
            t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            route = conv3x3_route(512, h, h, cin, cout, dtype)
            ms = median_ms(lambda _: conv3x3_fused(xd, wd), [None], 20)
            plain_ms = median_ms(lambda _: _shift9_fwd(xd, wd), [None], 20)
            library_ms = median_ms(lambda _: conv2d_nhwc(xd, wd), [None], 20)
            ms_again = median_ms(lambda _: conv3x3_fused(xd, wd), [None], 20)
            row = {"shape": f"512x{h}x{h} {cin}->{cout}",
                   "dtype": str(dtype).replace("torch.", ""), "route": route,
                   "ms": ms, "ms_again": ms_again, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "tflops": flops / ms / 1e9}
            timings.append(row)
            print(f"conv3x3 {row['shape']} {row['dtype']} ({route}): kernel "
                  f"{ms:.6f} ms (again {ms_again:.6f}, {row['tflops']:.1f} "
                  f"TFLOP/s), plain {plain_ms:.6f} ms, cuDNN "
                  f"{library_ms:.6f} ms, bound {row['bound_ms']:.6f} ms "
                  f"({row['bound_by']}: ops {t_ops:.6f}, bytes "
                  f"{t_bytes:.6f})", flush=True)
    # 32x32 64->128, the first target shape: float32 and bfloat16.
    head, head_bf16 = timings[0], timings[1]
    return {"name": "conv3x3", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/conv3x3.cu",
            "replaces": "ddp_tpu/ops/conv_candidates.py:104",
            "max_abs_err": worst[torch.float32][0],
            "max_abs_err_bf16": worst[torch.bfloat16][0],
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "ms_bf16": head_bf16["ms"], "plain_ms_bf16": head_bf16["plain_ms"],
            "bound_ms_bf16": head_bf16["bound_ms"],
            "bound_by_bf16": head_bf16["bound_by"],
            "library_ms_bf16": head_bf16["library_ms"],
            "routes": list(ROUTES), "check_launches_by_route": routes,
            "hgmma_sass_lines": hgmma, "timings": timings}


def probe_phase() -> dict:
    """The conv-candidate CLI over all five candidates, in float32 and in
    bfloat16, each with the kernel's launch count and route read around
    it; then the pool probe once.  Returns the launches by route."""
    # Each chain runs once to warm up and PROBE_REPEATS times timed, at
    # N_SHORT and N_LONG links.  A link launches the kernel once forward;
    # the fused candidate's train link adds its dgrad, the hybrid's none.
    links = (1 + PROBE_REPEATS) * (N_SHORT + N_LONG) * len(TARGET_SHAPES)
    expected = links * (1 + 2) + links * (1 + 1)
    by_route = dict.fromkeys(ROUTES, 0)
    for flags, route in (([], "ffma_f32"), (["--bf16"], "wgmma_bf16")):
        t0 = time.time()
        conv3x3_fused.launches = 0
        conv3x3_fused.route_launches = dict.fromkeys(ROUTES, 0)
        records = conv_candidates.main(
            flags + ["--repeats", str(PROBE_REPEATS)])
        launches = conv3x3_fused.launches
        routes = dict(conv3x3_fused.route_launches)
        check(launches == expected and routes[route] == expected,
              f"conv3x3 launched {launches} times on the probe path "
              f"{flags}, {routes} by route; expected {expected}, all on "
              f"{route}")
        check(set(records) == set(conv_candidates.CANDIDATES),
              f"probe ran {sorted(records)}")
        for name, recs in records.items():
            check(len(recs) == 2 * len(TARGET_SHAPES) and all(
                math.isfinite(r["marginal_ms_per_call"]) and (
                    r["tflops"] is None or math.isfinite(r["tflops"]))
                for r in recs), f"probe records of {name}: {recs}")
        print(f"probe path {' '.join(flags) or '(float32)'}: "
              f"{time.time() - t0:.2f} s, conv3x3 launches {launches}, by "
              f"route {routes}", flush=True)
        for k in ROUTES:
            by_route[k] += routes[k]
    t0 = time.time()
    pool_candidates.main(["--repeats", "1"])
    print(f"pool probe: {time.time() - t0:.2f} s", flush=True)
    return by_route


# --------------------------------------------------------------- bfloat16
# The bfloat16 form of gather_batch at N = 512: 3 MiB of output, the source
# rows, and the indices, draws and labels (the f32 form's bytes with 2-byte
# outputs).
BF16_BATCH_BYTES = (512 * 3 * 32 * 32 * 2 + 512 * 3072 + 512 * 4
                    + 512 * (8 + 8 + 1) + 2 * 512 * 8)
# bf16 against the CPU or another bf16 run (tests/test_torch_bf16.py):
# losses 1e-2 relative; each tensor's change over the run within 2^-3 of
# that change's largest magnitude (bf16 rounding after sums taken in other
# orders; bf16 alone moves JAX's epoch ~5-7% of max from its f32 epoch).
BF16_LOSS_TOL, BF16_UPDATE_TOL = 1e-2, 2.0 ** -3
# The accuracy anchors of ROADMAP C2: each recording's config, run through
# the port's resident step on the card at full width.
ANCHORS = (("tests/golden/accuracy_parity_20epoch_noise0.25_bf16.json", BF16),
           ("tests/golden/accuracy_parity_20epoch_noise0.25.json", None))
ANCHOR_CONFIG = {"model": "vgg", "batch": 64, "base_lr": 0.05,
                 "steps_per_epoch": 12, "epochs": 20, "n_train": 768,
                 "n_test": 256, "label_noise": 0.25,
                 "init": "torch.manual_seed(2) TorchVGG state_dict",
                 "data": "ddp_tpu.data.synthetic(seed=21, label_noise=0.25)"}
ANCHOR_DATA_SEED, ANCHOR_INIT_SEED, ANCHOR_SHUFFLE_SEED = 21, 2, 1234
ANCHOR_TOL_POINTS = 2.0  # 5 of the 256 held-out images


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype == BF16 and torch.equal(a.view(torch.int16),
                                                      b.view(torch.int16))


def batch_bf16_phase(gen: torch.Generator) -> dict:
    """gather_batch's bfloat16 form against its plain version (exact, the
    same 24 cases as the float32 form's and every byte value), then timed
    beside the float32 kernel followed by ``.to(torch.bfloat16)``, the
    sequence it replaces.  Returns its kernels-line entry."""
    m = 50000
    table = torch.randint(0, 256, (m, 32, 32, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    labels = torch.randint(0, 10, (m,), device="cuda", generator=gen)
    cases, max_err = _batch_cases(table, labels, gen, BF16)
    ramp = torch.zeros((1, 32, 32, 3), dtype=torch.uint8, device="cuda")
    ramp.view(-1)[:256] = torch.arange(256, device="cuda")
    images, _ = gather_batch(ramp, labels[:1], torch.zeros(
        1, dtype=torch.int32, device="cuda"), dtype=BF16)
    check(_bits_equal(images.reshape(-1)[:256],
                      (torch.arange(256, device="cuda").float() / 255.0)
                      .to(BF16)),
          "gather_batch's bf16 u8/255 differs from the float32 quotient "
          "rounded to nearest even")
    print(f"gather_batch bf16: {cases} cases equal to the plain version bit "
          f"for bit (images and labels), every byte value the float32 "
          f"quotient rounded to nearest even", flush=True)

    n = 512
    args = [(torch.randperm(m, device="cuda", generator=gen)[:n].int(),
             make_draws(gen, n, torch.device("cuda"))) for _ in range(60)]
    fused = lambda a: gather_batch(table, labels, *a, dtype=BF16)
    replaced = lambda a: gather_batch(table, labels, *a)[0].to(BF16)
    ms = median_ms(fused, args)
    plain_ms = median_ms(
        lambda a: gather_batch_plain(table, labels, *a, dtype=BF16), args,
        sleep_cycles=2_000_000)
    replaced_ms = median_ms(replaced, args)
    ms_again = median_ms(fused, args)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args[:50]:
            fused(a)
        torch.cuda.synchronize()
    kernel_us = _profiled_us(device_events(prof), "gather_batch_kernel")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args[:50]:
            replaced(a)
        torch.cuda.synchronize()
    events = device_events(prof)
    replaced_us = sum(ms for ms, _ in events.values()) / 50 * 1e3
    bound_ms = BF16_BATCH_BYTES / HBM_BYTES_PER_S * 1e3
    print(f"gather_batch bf16 N={n}: kernel {ms:.6f} ms (again "
          f"{ms_again:.6f}) by the event bracket, {kernel_us:.3f} us by the "
          f"profiler; bound {bound_ms:.6f} ms ({BF16_BATCH_BYTES} bytes), "
          f"{bound_ms * 1e3 / kernel_us:.1%} of it by the profiler; plain "
          f"{plain_ms:.6f} ms; yardstick (float32 kernel + .to(bfloat16)) "
          f"{replaced_ms:.6f} ms by the event bracket, {replaced_us:.3f} us "
          f"by the profiler", flush=True)
    return {"name": "gather_batch_bf16", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/gather.cu",
            "replaces": "ddp_tpu/ops/gather.py:37",
            "also_replaces": ["ddp_tpu/data/device_augment.py:44",
                              "ddp_tpu/data/device_augment.py:57",
                              "ddp_tpu/train/step.py:53"],
            "max_abs_err": max_err, "ms": ms, "kernel_ms": ms,
            "ms_again": ms_again, "profiler_ms": kernel_us / 1e3,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share_profiler": bound_ms * 1e3 / kernel_us,
            "library_ms": None,
            "replaced_sequence": "gather_batch (float32) + .to(bfloat16)",
            "replaced_ms": replaced_ms, "replaced_profiler_ms":
                replaced_us / 1e3, "cases": cases}


def _float32_file(ckpt) -> bool:
    """Whether every weight, buffer and momentum array of a checkpoint is
    float32 as the file holds it."""
    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)
    return all(np.asarray(a).dtype == np.float32 for tree in (
        ckpt.params, ckpt.batch_stats, ckpt.momentum) for a in leaves(tree))


def bf16_main_phase(out: dict, card: str, path: str) -> dict:
    """The main path with ``--bf16``, its counts zeroed just before and read
    just after: 18 finite losses, gather_batch's bf16 form 23 times,
    neither row_gather nor conv3x3, a float32 checkpoint; its ms/step
    beside the float32 run ``out``'s."""
    gather_batch.launches = gather_batch.launches_bf16 = 0
    gather_rows.launches = conv3x3_fused.launches = 0
    res = cli.main(MAIN_ARGS + ["--bf16", "--snapshot_path", path])
    launches = {"gather_batch": gather_batch.launches,
                "gather_batch_bf16": gather_batch.launches_bf16,
                "row_gather": gather_rows.launches,
                "conv3x3": conv3x3_fused.launches}
    losses = res["loss_history"]
    check(res["compute_dtype"] == "bfloat16", f"--bf16 ran in "
          f"{res['compute_dtype']}")
    check(len(losses) == MAIN_TRAIN_STEPS and
          all(math.isfinite(x) for x in losses),
          f"bf16 main path: {len(losses)} losses, finite "
          f"{all(math.isfinite(x) for x in losses)}")
    n = MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS
    check(launches == {"gather_batch": n, "gather_batch_bf16": n,
                       "row_gather": 0, "conv3x3": 0},
          f"bf16 main path kernel launches {launches}")
    ckpt = load_checkpoint(path)
    check(ckpt.step == MAIN_TRAIN_STEPS and _float32_file(ckpt),
          f"bf16 main path checkpoint: step {ckpt.step}, float32 "
          f"{_float32_file(ckpt)}")
    step_ms = statistics.median(res["step_ms"])
    f32_ms = statistics.median(out["step_ms"])
    print(f"main path --bf16 ({card}): median {step_ms:.3f} ms/step, "
          f"{512 / step_ms * 1e3:.1f} samples/s (float32 {f32_ms:.3f} ms/step, "
          f"{512 / f32_ms * 1e3:.1f} samples/s, ratio {step_ms / f32_ms:.4f}); "
          f"train {res['training_seconds']:.2f} s, eval "
          f"{res['eval_seconds']:.2f} s; launches {launches}; first/last "
          f"loss {losses[0]:.4f}/{losses[-1]:.4f}; accuracy "
          f"{res['accuracy']:.2f}% (float32 {out['accuracy']:.2f}%); the "
          f"checkpoint float32", flush=True)
    res["launches"] = launches
    return res


def _bf16_drill_errors(got: dict, ref: dict, start: dict) -> dict:
    """A bf16 drill rank against its reference: the losses' relative
    difference, the worst tensor's change over the run and the worst
    momentum, each as a share of the reference's largest magnitude."""
    rel = lambda a, b: float((a.double() - b.double()).abs().max()
                             / b.double().abs().max().clamp_min(1e-30))
    upd = max(rel(got["state_dict"][k] - start[k], v - start[k])
              for k, v in ref["state_dict"].items())
    return {"loss": float(((got["losses"] - ref["losses"]).abs()
                           / ref["losses"].abs()).max()),
            "update": upd,
            "momentum": max(rel(a, b) for a, b in zip(got["momentum"],
                                                      ref["momentum"]))}


def bf16_strategy_phase(composed: dict, margin: float, card: str) -> int:
    """``--bf16`` with the strategy flags composed at full width over NCCL
    at world 1, beside the float32 composed run ``composed``; then the
    strategy phase's narrow world-2 epoch in bf16 on the card over gloo
    against the CPU.  Returns the path's gather_batch launches."""
    res, wall_s, ckpt = run_multigpu(MAIN_ARGS + STRATEGY_FLAGS + ["--bf16"])
    steps = -(-(MAIN_TRAIN_STEPS - 1) // 2) + 1
    n = MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS
    launches = res["kernel_launches"]
    check((res["world"], res["backend"], res["compute_dtype"]) ==
          (1, "nccl", "bfloat16"), f"the bf16 strategy run's summary {res}")
    check(launches == {"gather_batch": n, "gather_batch_bf16": n,
                       "row_gather": 0, "conv3x3": 0},
          f"the bf16 strategy run's kernel launches {launches}")
    want, formula = model_collectives(get_model("vgg"), steps,
                                      MAIN_TRAIN_STEPS, sync_bn=True,
                                      zero=True, saves=1)
    check(res["collectives"] == want, f"the bf16 strategy run's collectives "
          f"{res['collectives']}, expected {want} ({formula})")
    losses = res["loss_history"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"the bf16 strategy run's losses: {len(losses)}")
    check(ckpt.step == steps and _float32_file(ckpt),
          f"the bf16 strategy run's checkpoint: step {ckpt.step}")
    step_ms = statistics.median(res["step_ms"])
    f32_ms = statistics.median(composed["step_ms"])
    print(f"strategy --bf16 {' '.join(STRATEGY_FLAGS)} at world 1 ({card}): "
          f"{steps} optimizer steps, median {step_ms:.3f} ms per optimizer "
          f"step ({1024 / step_ms * 1e3:.1f} samples/s; float32 "
          f"{f32_ms:.3f} ms, {1024 / f32_ms * 1e3:.1f} samples/s); process "
          f"wall {wall_s:.2f} s (float32 {composed['wall_s']:.2f}); accuracy "
          f"{res['accuracy']:.2f}% (float32 {composed['accuracy']:.2f}%); "
          f"collectives = {formula}; launches {launches}; the checkpoint "
          f"float32", flush=True)

    train, test = synthetic(n_train=40, n_test=24, seed=1)
    model = VGG(DDP_ARCH, generator=torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = concurrently({device: functools.partial(
        drill.run, drill.spec(DDP_ARCH, model.state_dict(), train, test,
                              batch=8, lr=0.05, seed=STRATEGY_DRILL_SEED,
                              augment=True, device=device, backend="gloo",
                              grad_accum=2, sync_bn=True, shard_update=True,
                              compute_dtype="bfloat16"),
        2, same_device=True, timeout=300) for device in ("cuda", "cpu")})
    worst = {"loss": 0.0, "update": 0.0, "momentum": 0.0}
    for got, ref in zip(runs["cuda"], runs["cpu"]):
        check(got["device"] == "cuda:0" and got["steps"] == 2 and
              got["train_launches"] == 3 and got["eval_launches"] == 2 and
              bool(torch.isfinite(got["losses"]).all()),
              f"bf16 strategy world-2 card rank {got['rank']}: "
              f"{got['device']}, {got['steps']} steps, launches "
              f"{got['train_launches']} + {got['eval_launches']}")
        errs = _bf16_drill_errors(got, ref, start)
        worst = {k: max(worst[k], v) for k, v in errs.items()}
    check(worst["loss"] <= BF16_LOSS_TOL and
          worst["update"] <= BF16_UPDATE_TOL and
          worst["momentum"] <= BF16_UPDATE_TOL,
          f"bf16 strategy world 2 on the card differs from the CPU: {worst}")
    card_launches = sum(g["train_launches"] + g["eval_launches"]
                        for g in runs["cuda"])
    print(f"strategy world 2 --bf16 on one card over gloo, flags composed "
          f"({card}): card against the CPU, losses {worst['loss']:.3e} "
          f"relative, worst change {worst['update']:.3e} and momentum "
          f"{worst['momentum']:.3e} of max (tolerances {BF16_LOSS_TOL:g}, "
          f"{BF16_UPDATE_TOL:g}; drill seed {STRATEGY_DRILL_SEED}, float32 "
          f"decision margin {margin:.3e}); correct/total card "
          f"{runs['cuda'][0]['correct']}/{runs['cuda'][0]['total']}, cpu "
          f"{runs['cpu'][0]['correct']}/{runs['cpu'][0]['total']}; "
          f"gather_batch launches on the card ranks {card_launches}",
          flush=True)
    return launches["gather_batch_bf16"] + card_launches


# The streaming phase: the reference's command shape, without --resident.
STREAM_ARGS = [a for a in MAIN_ARGS if a != "--resident"]
STREAM_FLAG_ARGS = [a for a in FLAG_ARGS if a != "--resident"]
# The streamed world-2 drill's seed (its host crops and the loader's order;
# lr 0.05 as the other drills): along its float64 trajectory every ReLU input
# and every max-pool window's top two inputs stay at least 2.2e-6 apart
# (``python tests/stream_parity_probe.py --configs drill_seed4``).  At seed
# 0 a window's top two sit 2.9e-7 apart in the last step, within float32
# rounding, and card runs took either side of it, moving momentum by 7.2e-4
# (``--configs drill``), as a ReLU kink does at the strategy drill's seed 0.
STREAM_DRILL_SEED = 4


@contextlib.contextmanager
def world1_rendezvous():
    """The environment of rank 0 of a world-1 group on this machine, for a
    ``multigpu`` rank run in this process; the previous environment is put
    back after."""
    keys = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def stream_run(args: list, snapshot: str) -> dict:
    """:func:`model_run` of a streaming ``multigpu`` run."""
    res = model_run(args, snapshot)
    check(res["data_path"] == "streaming", f"multigpu {' '.join(args)}: "
          f"{res['data_path']}")
    return res


def _stream_line(res: dict, steps: int, batch: int) -> str:
    """Wall and event ms/step, samples/s and the prefetch engine's per-step
    host, H2D-enqueue and consumer-wait ms of one run."""
    wall = sum(res["epoch_seconds"]) * 1e3 / steps
    event = statistics.median(res["step_ms"])
    pre = res.get("prefetch") or {}
    return (f"wall {wall:.3f} ms/step ({batch / wall * 1e3:.1f} samples/s), "
            f"event median {event:.3f} ms/step "
            f"({batch / event * 1e3:.1f} samples/s)" +
            (f", prefetch host {pre['host_ms_per_step']} ms, H2D enqueue "
             f"{pre['h2d_enqueue_ms_per_step']} ms, consumer wait "
             f"{pre['consumer_wait_ms_per_step']} ms a step over "
             f"{pre['batches']} batches" if pre else ""))


def stream_batch_cases(gen: torch.Generator) -> dict:
    """gather_batch on the inputs the streaming path gives it, against its
    plain version on the same device tensors, images and labels exactly:
    host batches of the streaming runs' data (train batch 0, the ragged
    last batch of 336 rows, the eval tail of 212 and micro-batch 1 of a
    ``--grad_accum 2`` group, a view into the stacked [2, 512, 32, 32, 3]
    copy), each copied by ``to_device`` on a side stream and read through
    ``micro_batches`` and ``micro_from_batch`` as the trainer and
    ``eval_counts`` read it, in float32 and bfloat16, eval and augment
    form.  Each copy is held against its host bytes, and each case must
    launch the kernel once.  These launches compare the kernel with its
    plain version: the path's counts are the runs' of :func:`stream_run`.
    Returns the case counts by dtype."""
    n = int(STREAM_ARGS[-1])
    train, test = synthetic(n_train=n, n_test=max(n // 4, 64))
    loader = TrainLoader(train, 512, seed=0, augment=True,
                         local_replicas=[0])
    loader.set_epoch(0)
    last = len(loader) - 1
    group, = _stack_groups([loader.materialize(0), loader.materialize(1)], 2)
    *_, eval_tail = EvalLoader(test, 512, local_replicas=[0])
    hosts = {"train batch 0": (loader.materialize(0), 1, 512),
             f"train batch {last}": (loader.materialize(last), 1, 336),
             "the eval tail": (eval_tail, 1, 212),
             "micro-batch 1 of a --grad_accum 2 group": (group, 2, 512)}
    copy = torch.cuda.Stream()
    cases = {torch.float32: 0, BF16: 0}
    for name, (host, accum, rows) in hosts.items():
        batch = to_device(host, torch.device("cuda"), stream=copy).wait()
        for k, v in host.items():
            check(torch.equal(batch[k].cpu(), torch.from_numpy(v)),
                  f"the card's copy of {name} differs from the host's {k}")
        micro = micro_batches(batch, accum)[-1]
        check(micro["image"].shape == (rows, 32, 32, 3),
              f"{name}: {tuple(micro['image'].shape)}")
        for dtype in cases:
            for augment in (False, True):
                draws = make_draws(gen, rows, torch.device("cuda")) \
                    if augment else None
                before = gather_batch.launches
                images, labels = micro_from_batch(augment, dtype)(
                    lambda m: draws, micro)
                check(gather_batch.launches == before + 1,
                      f"{name}: {gather_batch.launches - before} launches")
                want_images, want = gather_batch_plain(
                    micro["image"], micro["label"],
                    torch.arange(rows, device="cuda"), draws, dtype=dtype)
                torch.cuda.synchronize()
                check(images.dtype == dtype and
                      torch.equal(images, want_images) and
                      torch.equal(labels, want),
                      f"gather_batch {dtype} on {name} ("
                      f"{'augment' if augment else 'eval'} form) differs "
                      f"from its plain version")
                cases[dtype] += 1
    print(f"streamed batches: gather_batch equal to its plain version on "
          f"the card's copies (images and labels, exactly) in "
          f"{sum(cases.values())} cases: " + ", ".join(
              f"{name} ({rows} rows)" for name, (_, _, rows) in hosts.items())
          + " × float32/bfloat16 × eval/augment form; every copy equal to "
          "its host bytes", flush=True)
    return cases


def stream_phase(out: dict, out_bf16: dict, resident_det: dict, card: str,
                 tmp: str) -> tuple:
    """The streaming data path through ``multigpu`` at world 1 over NCCL:
    the reference's command at full width in float32 and bfloat16 (beside
    the resident main path's runs ``out``/``out_bf16``), a resumed second
    epoch, ``--device_augment`` and the composed strategy flags on 10,240
    images; in deterministic mode, ``--device_augment`` streamed at depth
    0 and at depth 2 (each process's own), each bit for bit against the
    other and against the strategy phase's resident run ``resident_det``
    of the same arguments; a narrow world-2 streamed epoch over gloo on the
    card against the CPU.  First, :func:`stream_batch_cases`.  Returns the
    path's gather_batch launches in float32 and in bfloat16, the
    streamed-batch case counts by dtype, and the float32 streaming run's
    summary (the resilience phase's unarmed step)."""
    cases = stream_batch_cases(torch.Generator(device="cuda").manual_seed(9))
    n = MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS
    f32_path = os.path.join(tmp, "stream.pt")
    res = stream_run(STREAM_ARGS, f32_path)
    launches = res["kernel_launches"]
    check(launches == {"gather_batch": n, "gather_batch_bf16": 0,
                       "row_gather": 0, "conv3x3": 0},
          f"the streaming path's kernel launches {launches}")
    check(res["host_augment"] == "native" and not res["device_augment"],
          f"the streaming path augmented on the host with "
          f"{res['host_augment']}")
    check(res["collectives"] == {"all_reduce": 2 * MAIN_TRAIN_STEPS + 2,
                                 "broadcast": 1},
          f"the streaming path's collectives {res['collectives']}")
    check(len(res["loss_history"]) == MAIN_TRAIN_STEPS and
          res["prefetch"]["batches"] == MAIN_TRAIN_STEPS,
          f"the streaming path: {len(res['loss_history'])} losses, "
          f"{res['prefetch']['batches']} batches")
    ckpt = load_checkpoint(f32_path)
    check(ckpt.step == MAIN_TRAIN_STEPS and ckpt.epoch == 0 and
          _float32_file(ckpt), f"the streaming checkpoint: step "
          f"{ckpt.step}, epoch {ckpt.epoch}")
    print(f"streaming path, multigpu {' '.join(STREAM_ARGS)} ({card}): "
          f"{_stream_line(res, MAIN_TRAIN_STEPS, 512)}; the resident main "
          f"path in this process: {_stream_line(out, MAIN_TRAIN_STEPS, 512)};"
          f" host_augment {res['host_augment']}, launches {launches}, "
          f"first/last loss {res['loss_history'][0]:.4f}/"
          f"{res['loss_history'][-1]:.4f}, accuracy {res['accuracy']:.2f}% "
          f"(resident {out['accuracy']:.2f}%), train "
          f"{res['training_seconds']:.2f} s, eval {res['eval_seconds']:.2f} "
          f"s, wall {res['wall_s']:.2f} s; the checkpoint float32, step "
          f"{ckpt.step}", flush=True)
    stream_launches = launches["gather_batch"]

    again = stream_run(["2"] + STREAM_ARGS[1:] + ["--resume"], f32_path)
    ckpt = load_checkpoint(f32_path)
    check(len(again["loss_history"]) == MAIN_TRAIN_STEPS and
          ckpt.step == 2 * MAIN_TRAIN_STEPS and ckpt.epoch == 1 and
          again["kernel_launches"]["gather_batch"] == n,
          f"the resumed streaming run: {len(again['loss_history'])} steps, "
          f"checkpoint step {ckpt.step} epoch {ckpt.epoch}, launches "
          f"{again['kernel_launches']}")
    stream_launches += n
    print(f"streaming --resume ({card}): epoch 1 trained from the epoch-0 "
          f"file, {len(again['loss_history'])} steps, "
          f"{_stream_line(again, MAIN_TRAIN_STEPS, 512)}, first/last loss "
          f"{again['loss_history'][0]:.4f}/{again['loss_history'][-1]:.4f}, "
          f"accuracy {again['accuracy']:.2f}%, checkpoint step {ckpt.step}",
          flush=True)

    bf16_path = os.path.join(tmp, "stream_bf16.pt")
    res16 = stream_run(STREAM_ARGS + ["--bf16"], bf16_path)
    check(res16["kernel_launches"] == {"gather_batch": n,
                                       "gather_batch_bf16": n,
                                       "row_gather": 0, "conv3x3": 0} and
          res16["compute_dtype"] == "bfloat16" and
          len(res16["loss_history"]) == MAIN_TRAIN_STEPS,
          f"the bf16 streaming path: {res16['compute_dtype']}, launches "
          f"{res16['kernel_launches']}")
    check(_float32_file(load_checkpoint(bf16_path)),
          "the bf16 streaming checkpoint is not float32")
    print(f"streaming path --bf16 ({card}): "
          f"{_stream_line(res16, MAIN_TRAIN_STEPS, 512)}; the resident bf16 "
          f"main path: {_stream_line(out_bf16, MAIN_TRAIN_STEPS, 512)}; "
          f"launches {res16['kernel_launches']}, accuracy "
          f"{res16['accuracy']:.2f}% (resident {out_bf16['accuracy']:.2f}%)",
          flush=True)
    bf16_launches = res16["kernel_launches"]["gather_batch_bf16"]

    flag_n = FLAG_TRAIN_STEPS + FLAG_EVAL_STEPS
    aug = stream_run(STREAM_FLAG_ARGS + ["--device_augment"],
                     os.path.join(tmp, "aug.pt"))
    check(aug["device_augment"] and aug["host_augment"] is None and
          aug["kernel_launches"]["gather_batch"] == flag_n and
          len(aug["loss_history"]) == FLAG_TRAIN_STEPS,
          f"streaming --device_augment: launches {aug['kernel_launches']}")
    composed = stream_run(STREAM_FLAG_ARGS + STRATEGY_FLAGS,
                          os.path.join(tmp, "composed.pt"))
    steps = FLAG_TRAIN_STEPS // 2
    want, formula = model_collectives(get_model("vgg"), steps,
                                      FLAG_TRAIN_STEPS, sync_bn=True,
                                      zero=True, saves=1)
    check(composed["collectives"] == want and
          len(composed["loss_history"]) == steps and
          composed["kernel_launches"]["gather_batch"] == flag_n,
          f"streaming {' '.join(STRATEGY_FLAGS)}: "
          f"{len(composed['loss_history'])} steps, collectives "
          f"{composed['collectives']} (expected {want}), launches "
          f"{composed['kernel_launches']}")
    stream_launches += 2 * flag_n
    print(f"streaming --device_augment on 10,240 images ({card}): "
          f"{_stream_line(aug, FLAG_TRAIN_STEPS, 512)}; streaming "
          f"{' '.join(STRATEGY_FLAGS)}: {steps} optimizer steps, "
          f"{_stream_line(composed, steps, 1024)}, collectives "
          f"{composed['collectives']} = {formula}", flush=True)

    # The copy stream's ordering and the streamed step against the resident
    # one, in two processes: the same rows, device draws and kernel go
    # through the same step, so depth 0, depth 2 and the resident run agree
    # bit for bit.  (tests/test_torch_cuda.py holds host-augmented depths 0
    # and 2 to each other too.)
    # Both at once, as the strategy phase's deterministic runs.
    t0 = time.time()
    det = {k: v[0] for k, v in concurrently({
        f"--device_augment --prefetch_depth {d}": functools.partial(
            run_entries, ["multigpu"], STREAM_FLAG_ARGS + [
                "--device_augment", "--prefetch_depth", d],
            deterministic=True) for d in ("0", "2")}).items()}
    det["--resident"] = resident_det
    names = list(det)
    for a, b in ((names[0], names[1]), (names[1], names[2])):
        pair, = compare([det[a], det[b]])
        print(f"streaming, {a} against {b} at world 1, deterministic mode "
              f"({card}): {pair}", flush=True)
        check(pair["bit_equal"], f"under deterministic mode {a} differs "
              f"from {b}")
    print(f"streaming deterministic runs: {time.time() - t0:.1f} s; median "
          f"ms/step " + ", ".join(
              f"{k} {statistics.median(v['step_ms']):.3f}"
              for k, v in det.items()), flush=True)

    # World 2 on the one card over gloo, each rank streaming its own
    # host-augmented batches, against the same ranks on the CPU (both at
    # once).
    train, test = synthetic(n_train=40, n_test=24, seed=1)
    model = VGG(DDP_ARCH, generator=torch.Generator().manual_seed(0))
    runs = concurrently({device: functools.partial(
        drill.run, drill.spec(DDP_ARCH, model.state_dict(), train, test,
                              batch=8, lr=0.05, seed=STREAM_DRILL_SEED,
                              augment=True, device=device, backend="gloo",
                              streaming=True),
        2, same_device=True, timeout=300) for device in ("cuda", "cpu")})
    worst = 0.0
    for got, want_rank in zip(runs["cuda"], runs["cpu"]):
        check(got["backend"] == "gloo" and got["device"] == "cuda:0" and
              got["steps"] == 3 and got["train_launches"] == 3 and
              got["eval_launches"] == 2 and
              bool(torch.isfinite(got["losses"]).all()),
              f"streaming world-2 card rank {got['rank']}: "
              f"{got['device']}, {got['steps']} steps, launches "
              f"{got['train_launches']} + {got['eval_launches']}")
        errs = [float((got["losses"] - want_rank["losses"]).abs().max())]
        errs += [float((got["state_dict"][k] - v).abs().max())
                 for k, v in want_rank["state_dict"].items()]
        errs += [float((a - b).abs().max())
                 for a, b in zip(got["momentum"], want_rank["momentum"])]
        worst = max(worst, *errs)
    check(worst <= PARITY_TOL, f"streaming world 2 on the card differs "
          f"from the CPU by {worst:.3e}")
    card_launches = sum(g["train_launches"] + g["eval_launches"]
                        for g in runs["cuda"])
    stream_launches += card_launches
    print(f"streaming world 2 on one card over gloo ({card}): 3 steps at lr "
          f"0.05, drill seed {STREAM_DRILL_SEED}, max |diff| against the CPU "
          f"{worst:.3e} (losses, weights, BN buffers, momentum; tolerance "
          f"{PARITY_TOL:g}); gather_batch launches on the card ranks "
          f"{card_launches}", flush=True)
    return stream_launches, bf16_launches, cases, res


# The resilience phase's run: the streamed VGG-11 at full width, batch 512,
# 10,240 images (20 steps an epoch), 2 epochs; the world-2 drills split the
# images over two ranks (10 steps an epoch).
SURVIVE_ARGS = ["2", "1", "--batch_size", "512", "--synthetic",
                "--synthetic_size", "10240"]
SURVIVE_STEPS, SURVIVE_EVALS = 20, 5
SIGTERM_STEP, POISON_STEP = 13, 25
# The armed step's event median against the unarmed one; the audit cadence
# of the armed run (audits after steps 5, 10, 15, 25, 30 and 35 land in a
# step's span; those after 20 and 40 at an epoch's end) and the cadence
# whose cost a step is reported.
ARMED_TOL, AUDIT_PROBE, AUDIT_EVERY = 0.01, 5, 50
# One rank of a multigpu run over gloo (NCCL refuses two ranks on one card).
GLOO_RANK = ("import sys; from ddp_tpu_torch import cli; "
             "cli.main_multi(sys.argv[1:], backend='gloo')")


def survive_child(args: list, snapshot: str, name: str,
                  fault: str = "") -> tuple:
    """``singlegpu args`` in a process of its own in deterministic mode
    (``repeat_check``'s child), with ``DDP_TPU_FAULT=fault``: its exit
    code, its ``--result_json`` summary (None when it wrote none) and its
    stdout and stderr."""
    res = snapshot + f".{name}.json"
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env.pop(FAULT_ENV, None)
    if fault:
        env[FAULT_ENV] = fault
    r = subprocess.run(
        [sys.executable, "-m", "ddp_tpu_torch.repeat_check", "--child",
         "singlegpu", "--deterministic", "--", *args, "--snapshot_path",
         snapshot, "--result_json", res], env=env, capture_output=True,
        text=True, timeout=600)
    out = None
    if os.path.exists(res):
        with open(res) as f:
            out = json.load(f)
    return r.returncode, out, r.stdout, r.stderr


def _expect(got: tuple, code: int, what: str) -> dict:
    rc, out, _, err = got
    check(rc == code and (out is not None or code != 0),
          f"{what}: exit {rc}, expected {code}: {err[-3000:]}")
    return out


def _same_state(a, b) -> bool:
    """Two checkpoints' step, weights, BatchNorm buffers and momentum bit
    for bit."""
    def flat(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            yield from (flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                        else [(prefix + k, v)])
    return a.step == b.step and all(
        ka == kb and np.array_equal(x, y)
        for sect in ("params", "batch_stats", "momentum")
        for (ka, x), (kb, y) in zip(flat(getattr(a, sect)),
                                    flat(getattr(b, sect))))


def gloo_world2(args: list, fault: str, timeout: float) -> tuple:
    """``multigpu args`` as two ranks on this card over gloo with
    ``DDP_TPU_FAULT=fault``: the largest exit code and the seconds."""
    env = dict(os.environ, **{FAULT_ENV: fault})
    t0 = time.time()
    code = dist.launch_local([sys.executable, "-c", GLOO_RANK, *args], 2,
                             env=env, same_device=True, timeout=timeout)
    return code, time.time() - t0


def gpu_state() -> str:
    """The card's SM clock, temperature and power draw now."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,"
                        "power.draw", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=30)
    return r.stdout.strip() or "nvidia-smi: no answer"


def armed_step(stream: dict, card: str, tmp: str) -> int:
    """The streamed 10,240-image run in this process, unarmed, then armed
    (the preemption guard the CLI always installs, ``--on_nan restore``,
    ``--watchdog_secs 600`` and ``--drift_audit_every 5``), back to back:
    the armed event median over the steps whose span holds no audit within
    ``ARMED_TOL`` of the unarmed median (the streaming phase's 9,040-image
    median printed beside); each audit's excess over the median on the
    step that carries it, the first apart (it loads the audit's kernels)
    and the median of the rest priced a step at K = ``AUDIT_EVERY``; each
    run's counts set to 0 before it and read after.  Returns their
    gather_batch launches."""
    n = 2 * SURVIVE_STEPS
    before = gpu_state()
    plain = stream_run(SURVIVE_ARGS, os.path.join(tmp, "unarmed.pt"))
    armed = stream_run(SURVIVE_ARGS + ["--on_nan", "restore",
                                       "--watchdog_secs", "600",
                                       "--drift_audit_every",
                                       str(AUDIT_PROBE)],
                       os.path.join(tmp, "armed.pt"))
    after = gpu_state()
    audits = n // AUDIT_PROBE
    for res, extra in ((plain, {}), (armed, {"drift_audit": 2 * audits})):
        check(res["launches"] == _launches(n + SURVIVE_EVALS) and
              res["collectives"] == {"all_reduce": 2 * n + 2 + 1,
                                     "broadcast": 1, **extra} and
              len(res["step_ms"]) == n,
              f"the {'armed' if extra else 'unarmed'} run: launches "
              f"{res['launches']}, collectives {res['collectives']}")
    # step_ms holds each epoch's spans; an audit after global step s lands
    # in span s, unless s ends an epoch.
    spans = [s for s in range(AUDIT_PROBE, n, AUDIT_PROBE)
             if s % SURVIVE_STEPS]
    base = statistics.median(plain["step_ms"])
    ms = statistics.median(t for i, t in enumerate(armed["step_ms"])
                           if i not in spans)
    excess = [armed["step_ms"][i] - ms for i in spans]
    steady = statistics.median(excess[1:])
    check(abs(ms - base) <= ARMED_TOL * base,
          f"the armed streamed step {ms:.3f} ms against the unarmed "
          f"{base:.3f} ms")
    print(f"resilience, armed streamed step ({card}; clocks, temperature, "
          f"power before/after: {before} / {after}): event median "
          f"{ms:.3f} ms/step with the preemption guard, --on_nan restore and "
          f"--watchdog_secs 600, beside the unarmed run's {base:.3f} ms "
          f"({(ms / base - 1) * 100:+.2f}%) and the streaming phase's "
          f"{statistics.median(stream['step_ms']):.3f} ms "
          f"({STREAM_ARGS[-1]} images); "
          f"--drift_audit_every {AUDIT_PROBE}: the audited steps' excess "
          f"{[round(x, 3) for x in excess]} ms, the first "
          f"{excess[0]:.3f} ms, the rest's median {steady:.3f} ms, so "
          f"{steady / AUDIT_EVERY:.4f} ms a step at K = {AUDIT_EVERY} "
          f"({steady / AUDIT_EVERY / ms * 100:.3f}%), world 1", flush=True)
    return plain["launches"]["gather_batch"] + \
        armed["launches"]["gather_batch"]


def resilience_phase(unarmed: dict, card: str, tmp: str) -> int:
    """A run that survives, on the card.  Five chains at once, each in
    processes of its own (the deterministic children bit for bit whatever
    runs beside them): the uninterrupted streamed run; ``sigterm@step=13``
    (exit 75, a mid-epoch data_state) then ``--resume``, bit for bit on it
    with one ``gather_batch`` launch a streamed step; ``poison@step=25
    --on_nan restore --keep_checkpoints 3`` (completes with ``rng_folds``
    1, its losses the uninterrupted ones: host batches draw nothing the
    restore re-keys), its head torn, the serve engine on the
    directory (the epoch-0 snapshot) and ``--resume`` from the snapshot,
    bit for bit on it; and at world 2 over gloo on this card,
    ``flip_param_bit`` caught by ``--drift_audit_every 5`` (exit 1, the
    event naming the first leaf and replica 1) and ``stall`` ending in the
    watchdog's 124 under ``--watchdog_secs 20``.  First, alone in this
    process, :func:`armed_step` (``unarmed`` is the streaming phase's
    run).  Returns the launches of gather_batch the path reported."""
    from ddp_tpu_torch.resilience.drift import leaf_paths
    from ddp_tpu_torch.resilience.faults import tear_file
    from ddp_tpu_torch.resilience.lineage import lineage_name
    t0 = time.time()
    launches = armed_step(unarmed, card, tmp)
    t1 = time.time()
    total = 2 * SURVIVE_STEPS
    results, errors = {}, []

    def chain(name, fn):
        def run():
            try:
                results[name] = fn()
            except Exception as e:  # re-raised below, after the joins
                errors.append(e)
        return threading.Thread(target=run, name=name)

    def full():
        return _expect(survive_child(SURVIVE_ARGS,
                                     os.path.join(tmp, "full.pt"), "full"),
                       0, "the uninterrupted run")

    def sigterm():
        path = os.path.join(tmp, "half.pt")
        got = survive_child(SURVIVE_ARGS, path, "half",
                            f"sigterm@step={SIGTERM_STEP}")
        check(got[0] == 75 and "relaunch with --resume" in got[3],
              f"sigterm@step={SIGTERM_STEP}: exit {got[0]}: "
              f"{got[3][-3000:]}")
        ds = load_checkpoint(path).data_state
        resumed = survive_child(SURVIVE_ARGS + ["--resume"], path, "resume")
        check("fast-forwarding epoch" in resumed[2],
              "the resumed run did not fast-forward")
        return ds, _expect(resumed, 0, "--resume after the SIGTERM")

    def poison():
        path = os.path.join(tmp, "lineage", "checkpoint.pt")
        os.makedirs(os.path.dirname(path))
        out = _expect(survive_child(
            SURVIVE_ARGS + ["--on_nan", "restore", "--keep_checkpoints",
                            "3"], path, "poison",
            f"poison@step={POISON_STEP}"),
            0, f"poison@step={POISON_STEP} --on_nan restore")
        tear_file(path)
        engine = ServeEngine.from_checkpoint(os.path.dirname(path), "vgg")
        snapshot = lineage_name(path, 0)
        served = (engine.checkpoint_file, engine.checkpoint_epoch,
                  engine.checkpoint_step)
        del engine
        resumed = _expect(survive_child(
            SURVIVE_ARGS + ["--resume", "--keep_checkpoints", "3"], path,
            "torn"), 0, "--resume past a torn head")
        return out, served, snapshot, resumed, path

    def drift_drill():
        metrics = os.path.join(tmp, "drift.jsonl")
        code, secs = gloo_world2(
            SURVIVE_ARGS + ["--drift_audit_every", "5", "--metrics_path",
                            metrics, "--snapshot_path",
                            os.path.join(tmp, "drift.pt")],
            "flip_param_bit@step=6,replica=1", timeout=400)
        with open(metrics) as f:
            events = [json.loads(line) for line in f]
        return code, secs, [e for e in events
                            if e.get("event") == "drift_detected"]

    def stall_drill():
        return gloo_world2(SURVIVE_ARGS + ["--watchdog_secs", "20",
                                           "--snapshot_path",
                                           os.path.join(tmp, "stall.pt")],
                           "stall@epoch=0,rank=1,secs=600", timeout=400)

    threads = [chain(n, f) for n, f in (
        ("full", full), ("sigterm", sigterm), ("poison", poison),
        ("drift", drift_drill), ("stall", stall_drill))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    t_drills = time.time() - t1
    full_out = results["full"]
    full_ck = load_checkpoint(os.path.join(tmp, "full.pt"))

    ds, resumed = results["sigterm"]
    stop = SIGTERM_STEP + 1
    n_resumed = total - stop
    check((ds["epoch"], ds["offset"], ds["rng_folds"]) ==
          divmod(stop, SURVIVE_STEPS) + (0,),
          f"the SIGTERM's data_state {ds}")
    check(resumed["kernel_launches"]["gather_batch"] ==
          n_resumed + SURVIVE_EVALS and
          len(resumed["loss_history"]) == n_resumed,
          f"--resume: {len(resumed['loss_history'])} steps, launches "
          f"{resumed['kernel_launches']}")
    check(resumed["loss_history"] == full_out["loss_history"][stop:] and
          _same_state(load_checkpoint(os.path.join(tmp, "half.pt")),
                      full_ck),
          "the resumed run differs from the uninterrupted one")
    launches += resumed["kernel_launches"]["gather_batch"] + \
        full_out["kernel_launches"]["gather_batch"]
    print(f"resilience ({card}): sigterm@step={SIGTERM_STEP} exit 75, "
          f"data_state epoch {ds['epoch']} offset {ds['offset']}; --resume "
          f"trained {n_resumed} steps ({n_resumed + SURVIVE_EVALS} "
          f"gather_batch launches), its losses and checkpoint (weights, "
          f"BN buffers, momentum, step {full_ck.step}) bit for bit the "
          f"uninterrupted run's, deterministic mode", flush=True)

    out, served, snapshot, torn, path = results["poison"]
    check(out["restores"] == 1 and out["data_state"]["rng_folds"] == 1 and
          out["loss_history"] == full_out["loss_history"],
          f"poison@step={POISON_STEP} --on_nan restore: restores "
          f"{out['restores']}, data_state {out['data_state']}, losses equal "
          f"{out['loss_history'] == full_out['loss_history']}")
    check(served == (snapshot, 0, SURVIVE_STEPS),
          f"the serve engine on the torn lineage served {served}")
    check(len(torn["loss_history"]) == SURVIVE_STEPS and
          torn["loss_history"] == full_out["loss_history"][SURVIVE_STEPS:]
          and _same_state(load_checkpoint(path), full_ck),
          "--resume past the torn head differs from the uninterrupted run")
    launches += out["kernel_launches"]["gather_batch"] + \
        torn["kernel_launches"]["gather_batch"]
    print(f"resilience ({card}): poison@step={POISON_STEP} --on_nan restore "
          f"completed, restores 1, rng_folds 1, {total} losses bit for bit "
          f"the uninterrupted run's ({out['kernel_launches']['gather_batch']}"
          f" gather_batch launches with the discarded epoch); head torn: the "
          f"serve engine on the directory served {os.path.basename(snapshot)}"
          f" (epoch 0), --resume from it trained epoch 1 bit for bit",
          flush=True)

    code, secs, events = results["drift"]
    first = leaf_paths(get_model("vgg", device="meta"))[0]
    check(code == 1 and len(events) == 1 and events[0]["step"] <= 6 + 5 and
          events[0]["leaves"] == [first] and events[0]["replicas"] == [1],
          f"the world-2 drift drill: exit {code}, events {events}")
    code_stall, secs_stall = results["stall"]
    check(code_stall == 124 and secs_stall < 300,
          f"the world-2 stall drill: exit {code_stall} after "
          f"{secs_stall:.1f} s")
    print(f"resilience world 2 on one card over gloo ({card}): "
          f"flip_param_bit@step=6,replica=1 caught at step "
          f"{events[0]['step']} by --drift_audit_every 5 (leaf {first}, "
          f"replica 1), exit 1 after {secs:.1f} s; stall@epoch=0,rank=1 "
          f"ended by --watchdog_secs 20 with 124 after {secs_stall:.1f} s",
          flush=True)
    print(f"resilience drills: {t_drills:.1f} s", flush=True)

    print(f"resilience phase: {time.time() - t0:.1f} s", flush=True)
    return launches


# The storage phase's run: the streamed VGG-11 at full width, batch 512, on
# 10,240 images (20 steps an epoch), 3 epochs with a checkpoint after each;
# 5 eval batches.  Mirrored runs keep 2 checkpoints.  The SIGTERM lands in
# epoch 1; the poisoned step leaves the guard its 8-step history after a
# resume from epoch 0's file (steps 20-29).
STORE_ARGS = ["3", "1", "--batch_size", "512", "--synthetic",
              "--synthetic_size", "10240"]
STORE_STEPS = 3 * SURVIVE_STEPS
STORE_SIGTERM_STEP, STORE_POISON_STEP = 25, 30
# The supervised stall's watchdog: the beats of these runs come at most ~2 s
# apart, the first step's set-up included.
STORE_WATCHDOG_S = 10
# The mirrored run's step median against the unmirrored one's.
MIRROR_TOL = 0.01
SUPERVISE = [sys.executable, "-m", "ddp_tpu_torch.supervise",
             "--backoff_base", "0.2", "--backoff_max", "5", "--seed", "0"]
DETERMINISTIC_CHILD = ["-m", "ddp_tpu_torch.repeat_check", "--child",
                       "singlegpu", "--deterministic", "--"]
# S6's campaign drills, one campaign each, at once: the CI subset's stall,
# and kill_stage, whose pipelined run is preempted at step 2 and resumed
# under the supervisor bit for bit (the sigterm_step drill's check, with the
# stage-first shrink; S4 runs the supervised SIGTERM at full width).
STORE_DRILLS = ("watchdog_stall", "kill_stage")


def _load_json(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def supervised(train_args: list, fault: str = "", sup: tuple = (),
               timeout: float = 900) -> tuple:
    """``python -m ddp_tpu_torch.supervise [sup] -- <deterministic
    singlegpu train_args>`` with ``DDP_TPU_FAULT=fault``: its exit code,
    stderr and seconds."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env.pop(FAULT_ENV, None)
    if fault:
        env[FAULT_ENV] = fault
    t0 = time.time()
    r = subprocess.run(SUPERVISE + list(sup) + ["--"] + DETERMINISTIC_CHILD
                       + list(train_args), env=env, capture_output=True,
                       text=True, timeout=timeout)
    return r.returncode, r.stderr, time.time() - t0


def _store_launches(res: dict, what: str) -> int:
    """One ``gather_batch`` launch a train step and an eval batch of the
    child that wrote ``res``."""
    n = res["kernel_launches"]["gather_batch"]
    check(n == len(res["loss_history"]) + SURVIVE_EVALS,
          f"{what}: gather_batch launched {n} times for "
          f"{len(res['loss_history'])} steps and {SURVIVE_EVALS} eval "
          f"batches")
    return n


def gloo_ranks_apart(args: list, fault: str, timeout: float) -> list:
    """``multigpu args`` as two ranks on this card over gloo, each waited
    for on its own (``dist.launch_local`` would end the peer of a failed
    rank itself): each rank's exit code and its seconds."""
    port = free_port()
    procs = []
    t0 = time.time()
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(r), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", LOCAL_RANK="0",
                   **{FAULT_ENV: fault})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", GLOO_RANK, *args], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, timeout - (time.time()
                                                               - t0)))
            out.append((p.returncode, time.time() - t0, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def storage_phase(card: str, tmp: str, sync_write_s: float) -> int:
    """Storage and supervision on the card (A7b), the streamed VGG-11 of
    ``STORE_ARGS`` in deterministic children.  Alone, one after the other:
    S1, the asynchronous writer (per save the main thread's ms, the
    writer's s beside ``sync_write_s``, the synchronous save of the
    checkpoint phase, and the bytes; the step median of each epoch, and of
    the steps dispatched while a write ran against the rest); S3's
    ``slow_put@ms=500`` mirror run, its step median within ``MIRROR_TOL``
    of S1's and its lag gauge above 0, then 0 after the drain.  Then six
    chains at once: S2 ``--ckpt_format sharded`` (bit for bit S1's state,
    one shard and the index, and served logits bit for bit the v1
    lineage's on 128 rows); S3 ``fail_put@n=2`` (retried, every epoch
    uploaded) and ``torn_remote_object@`` (2 epochs: the torn object fails
    the store's verification, and the mirror walk skips it); S4 under
    ``python -m ddp_tpu_torch.supervise``: ``sigterm@step=25`` (75, then
    0, bit for bit S1's state, the recovery seconds) and the local wipe
    (``wipe_local_ckpt@epoch=0`` and the SIGTERM with ``--mirror``, the
    checkpoint directory then removed: the supervised resume restores from
    the mirror alone, bit for bit).  Then three at once: S4
    ``poison_batch@step=30`` with
    ``--guard_action abort --keep_fault_env`` on DeepNN (VGG-11's
    BatchNorm normalises a scaled input away; ``--on_nan skip`` leaves the
    verdict to the spike itself): 87, ``diagnosis.json`` naming step 30, a
    valid ``postmortem.json`` and a repeated stall with
    ``--max_restarts 1`` (86); S5 ``fail_ckpt_write@epoch=1`` at world 2
    over gloo on this card (rank 0 exits 1 with the error named, rank 1
    ends too, each waited for).  S6, the chaos campaign's
    ``watchdog_stall`` and ``kill_stage`` (``STORE_DRILLS``), one campaign
    a drill, run beside both waves from the start of the first, each
    scorecard printed.
    Every child that completes launches ``gather_batch`` once a train step
    and an eval batch.  Returns those launches."""
    from ddp_tpu_torch import chaos_campaign
    from ddp_tpu_torch.obs.blackbox import validate_postmortem
    from ddp_tpu_torch.resilience.lineage import latest_verifiable
    from ddp_tpu_torch.resilience.store import DirStore, StoreError
    from ddp_tpu_torch.train.checkpoint import CheckpointError
    t0 = time.time()
    launches = 0

    def workdir(name: str) -> str:
        d = os.path.join(tmp, name)
        os.makedirs(d, exist_ok=True)
        return d

    def child(name: str, extra=(), fault: str = "", epochs: str = "3"):
        d = workdir(name)
        path = os.path.join(d, "checkpoint.pt")
        got = survive_child([epochs] + STORE_ARGS[1:] + list(extra) + [
            "--metrics_path", os.path.join(d, "metrics.jsonl")], path, name,
            fault)
        return got, path

    def mirror(name: str) -> list:
        return ["--mirror", os.path.join(tmp, name, "mirror"),
                "--keep_checkpoints", "2"]

    # S1: the writer, alone.
    got, s1_path = child("s1")
    s1 = _expect(got, 0, "S1, the asynchronous writer")
    launches += _store_launches(s1, "S1")
    s1_ck = load_checkpoint(s1_path)
    steps = s1["step_ms"]
    saves = s1["checkpoint_saves"]
    check(len(steps) == STORE_STEPS and [s["epoch"] for s in saves] ==
          [0, 1, 2] and all("writer_s" in s for s in saves),
          f"S1: {len(steps)} step times, saves {saves}")
    beside = sorted({i for s in saves
                     for i in range(s["step"], s["step"] + s["steps_during"])
                     if i < len(steps)})
    rest = [t for i, t in enumerate(steps) if i not in beside]
    epochs_ms = [statistics.median(steps[e * SURVIVE_STEPS:
                                         (e + 1) * SURVIVE_STEPS])
                 for e in range(3)]
    for s in saves:
        print(f"storage S1 ({card}): save of epoch {s['epoch']}: main "
              f"thread {s['main_ms']:.3f} ms (snapshot and hand-off; "
              f"joining the previous write {s['join_ms']:.3f} ms), writer "
              f"{s['writer_s']:.3f} s (file, sha256, commit; the "
              f"synchronous save of the checkpoint phase, what the loop "
              f"waited for before, {sync_write_s:.3f} s), {s['bytes']} "
              f"bytes, {s['steps_during']} steps dispatched while it wrote",
              flush=True)
    print(f"storage S1 ({card}): step event median by epoch "
          f"{[round(m, 3) for m in epochs_ms]} ms (epoch 0 ran beside no "
          f"write, epochs 1 and 2 each began beside the previous epoch's); "
          + (f"the {len(beside)} steps dispatched while a write ran "
             f"{statistics.median(steps[i] for i in beside):.3f} ms against "
             f"the other {len(rest)} steps' {statistics.median(rest):.3f} "
             f"ms" if beside else "no step was dispatched while a write "
             "ran"), flush=True)

    # S3, slow_put: the mirror's cost to the steps, alone.
    got, _ = child("slow_put", mirror("slow_put"), "slow_put@ms=500")
    slow = _expect(got, 0, "S3 slow_put@ms=500")
    launches += _store_launches(slow, "S3 slow_put")
    base, ms = statistics.median(steps), statistics.median(slow["step_ms"])
    lag = slow["mirror"]["lag_epochs"]
    check(abs(ms - base) <= MIRROR_TOL * base,
          f"S3 slow_put: step median {ms:.3f} ms against S1's {base:.3f}")
    check(lag[0] > 0 and lag[-1] == 0 and slow["mirror"]["failures"] == 0,
          f"S3 slow_put: mirror {slow['mirror']}")
    print(f"storage S3 ({card}): slow_put@ms=500 with --mirror "
          f"--keep_checkpoints 2: step event median {ms:.3f} ms against "
          f"S1's {base:.3f} ms ({(ms / base - 1) * 100:+.2f}%); "
          f"ddp_mirror_lag_epochs {lag[0]} when training ended, {lag[-1]} "
          f"after the drain; {slow['mirror']['uploads']:.0f} uploads",
          flush=True)
    t_alone = time.time() - t0

    results, errors = {}, []

    def chain(name, fn):
        def run():
            try:
                results[name] = fn()
            except Exception as e:  # re-raised below, after the joins
                errors.append(e)
        return threading.Thread(target=run, name=name)

    def run_chains(fns: dict) -> None:
        threads = [chain(n, f) for n, f in fns.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def sharded():
        got, path = child("sharded", ["--ckpt_format", "sharded"])
        return _expect(got, 0, "S2 --ckpt_format sharded"), path

    def fail_put():
        got, _ = child("fail_put", mirror("fail_put"), "fail_put@n=2")
        return _expect(got, 0, "S3 fail_put@n=2")

    def torn():
        got, path = child("torn", mirror("torn"), "torn_remote_object@",
                          epochs="2")
        return _expect(got, 0, "S3 torn_remote_object@"), path

    def sup_run(name: str, fault: str, extra=(), sup=(), resume=False,
                snapshot=None):
        d = workdir(name)
        path = snapshot or os.path.join(d, "checkpoint.pt")
        res = os.path.join(d, "result.json")
        args = STORE_ARGS + list(extra) + [
            "--snapshot_path", path, "--metrics_path",
            os.path.join(d, "metrics.jsonl"), "--result_json", res] + (
            ["--resume"] if resume else [])
        rc, err, secs = supervised(args, fault, sup)
        return rc, err, secs, _load_json(res), path, d

    def sigterm():
        return sup_run("sup_sigterm", f"sigterm@step={STORE_SIGTERM_STEP}")

    def wipe():
        d = workdir("sup_wipe")
        ckdir = os.path.join(d, "ckpt")
        os.makedirs(ckdir)
        path = os.path.join(ckdir, "checkpoint.pt")
        got = survive_child(STORE_ARGS + mirror("sup_wipe"), path,
                            "stage1", f"wipe_local_ckpt@epoch=0;sigterm@"
                                      f"step={STORE_SIGTERM_STEP}")
        check(got[0] == 75 and "[fault] wiped" in got[3],
              f"S4 local wipe, stage 1: exit {got[0]}: {got[3][-3000:]}")
        shutil.rmtree(ckdir)  # the local tier is gone
        return sup_run("sup_wipe", "", mirror("sup_wipe"), resume=True,
                       snapshot=path)

    def campaign(drill: str):
        out = os.path.join(workdir(f"campaign_{drill}"), "chaos.json")
        r = subprocess.run(
            [sys.executable, "-m", "ddp_tpu_torch.chaos_campaign",
             "--drills", drill, "--out", out,
             "--workdir", workdir(f"campaign_runs_{drill}")],
            capture_output=True, text=True, timeout=900)
        check(r.returncode == 0, f"S6 the chaos campaign's {drill}: exit "
                                 f"{r.returncode}: {r.stdout[-3000:]}"
                                 f"{r.stderr[-3000:]}")
        return _load_json(out)

    def poison():
        # DeepNN: VGG-11's BatchNorm normalises a scaled input away.  With
        # --on_nan skip the NaNs after the poisoned step are logged, and
        # the guard's verdict is the spike at the poisoned step itself.
        return sup_run("sup_poison",
                       f"poison_batch@step={STORE_POISON_STEP},scale=1e4",
                       ["--model", "deepnn", "--lr", "0.05",
                        "--guard_spike_factor", "4", "--guard_action",
                        "abort", "--on_nan", "skip"], ["--keep_fault_env"])

    def stall():
        return sup_run("sup_stall", "stall@epoch=1,secs=600",
                       ["--watchdog_secs", str(STORE_WATCHDOG_S)],
                       ["--keep_fault_env", "--max_restarts", "1"])

    def world2():
        d = workdir("world2")
        return gloo_ranks_apart(STORE_ARGS + [
            "--snapshot_path", os.path.join(d, "checkpoint.pt")],
            "fail_ckpt_write@epoch=1", timeout=400)

    # S6's campaigns (~75-100 s each) run beside both waves.
    t1 = time.time()
    campaigns = [chain(f"campaign_{d}", functools.partial(campaign, d))
                 for d in STORE_DRILLS]
    for t in campaigns:
        t.start()
    try:
        run_chains({"sharded": sharded, "fail_put": fail_put, "torn": torn,
                    "sigterm": sigterm, "wipe": wipe})
        t_wave1 = time.time() - t1
        t2 = time.time()
        run_chains({"poison": poison, "stall": stall, "world2": world2})
        t_wave2 = time.time() - t2
    finally:
        for t in campaigns:
            t.join()
    if errors:
        raise errors[0]
    t_campaigns = time.time() - t1

    # S2: formats.
    sh, sh_path = results["sharded"]
    launches += _store_launches(sh, "S2")
    files = sorted(f for f in os.listdir(os.path.dirname(sh_path))
                   if f.startswith("checkpoint.pt") and not
                   f.endswith((".json", ".jsonl")))
    check(_same_state(load_checkpoint(sh_path), s1_ck) and files == [
        "checkpoint.pt", "checkpoint.pt.ep00000002.shard00000-of-00001.npz"],
        f"S2: the sharded run's state differs from S1's, or its files "
        f"{files}")
    rows = np.random.default_rng(13).integers(0, 256, (128, 32, 32, 3),
                                              dtype=np.uint8)
    logits = []
    for path in (s1_path, sh_path):
        engine = ServeEngine.from_checkpoint(path, "vgg", buckets=(128,))
        engine.warm()
        logits.append(engine.forward(rows))
        del engine
    check(np.array_equal(logits[0], logits[1]),
          "S2: the v2 lineage's served logits differ from the v1 one's")
    print(f"storage S2 ({card}): --ckpt_format sharded: the index and one "
          f"shard ({files[1]}), its final state (weights, BN buffers, "
          f"momentum, step {s1_ck.step}) bit for bit S1's; "
          f"ServeEngine.from_checkpoint on each lineage: 128 rows of "
          f"logits bit for bit", flush=True)

    # S3: fail_put and the torn object.
    fp = results["fail_put"]
    launches += _store_launches(fp, "S3 fail_put")
    m = fp["mirror"]
    check(m["retries"] >= 2 and m["failures"] == 0 and m["uploads"] == 3
          and m["lag_epochs"][-1] == 0 and m["mirrored_epochs"] == [2, 1],
          f"S3 fail_put@n=2: mirror {m}")
    tr, tr_path = results["torn"]
    launches += _store_launches(tr, "S3 torn")
    remote = DirStore(os.path.join(tmp, "torn", "mirror"))
    try:
        remote.get("checkpoint.pt.ep00000000",
                   os.path.join(tmp, "torn", "fetched"))
        verified = False
    except StoreError as e:
        verified = "sha-256 verification" in str(e)
    # The head lost too: the walk has the torn object left, and skips it.
    for f in os.listdir(os.path.dirname(tr_path)):
        if f.startswith("checkpoint.pt"):
            os.unlink(os.path.join(os.path.dirname(tr_path), f))
    remote.delete("checkpoint.pt.ep00000001")
    try:
        latest_verifiable(tr_path, store=remote)
        skipped = False
    except CheckpointError as e:
        skipped = ("<mirror>/checkpoint.pt.ep00000000" in str(e) and
                   "sha-256 verification" in str(e))
    check(verified and skipped,
          f"S3 torn_remote_object@: verified {verified}, skipped {skipped}")
    print(f"storage S3 ({card}): fail_put@n=2: {m['retries']:.0f} retries, "
          f"{m['failures']:.0f} abandoned, {m['uploads']:.0f} uploads, the "
          f"mirror holds epochs {m['mirrored_epochs']}; "
          f"torn_remote_object@: the torn epoch-0 object fails the store's "
          f"sha-256 verification, and with the newer object gone the "
          f"mirror walk skips it", flush=True)

    # S4: supervised.
    for name in ("sigterm", "wipe"):
        rc, err, secs, res, path, d = results[name]
        check(rc == 0 and res is not None, f"S4 {name}: supervisor exit "
                                           f"{rc}: {err[-3000:]}")
        n = STORE_STEPS - STORE_SIGTERM_STEP - 1
        launches += _store_launches(res, f"S4 {name}")
        check(len(res["loss_history"]) == n and _same_state(
            load_checkpoint(path), s1_ck),
            f"S4 {name}: {len(res['loss_history'])} resumed steps, or its "
            f"final state differs from S1's")
        stats = chaos_campaign.supervisor_stats(d)
        if name == "sigterm":
            check(stats["restart_reasons"] == {"preempted": 1} and
                  "the supervisor relaunches with --resume automatically"
                  in err, f"S4 sigterm: {stats}")
            print(f"storage S4 ({card}): sigterm@step={STORE_SIGTERM_STEP} "
                  f"under the supervisor: 75, relaunched with --resume, 0 "
                  f"after {secs:.1f} s; {n} resumed steps, the final state "
                  f"bit for bit S1's; recovery "
                  f"{stats['recovery_seconds_sum']} s (death to relaunch)",
                  flush=True)
        else:
            check("restored checkpoint from MIRROR object" in err,
                  "S4 local wipe: the resume did not restore from the "
                  "mirror")
            print(f"storage S4 ({card}): wipe_local_ckpt@epoch=0 and "
                  f"sigterm@step={STORE_SIGTERM_STEP} with --mirror, the "
                  f"checkpoint directory then removed: the supervised "
                  f"--resume restored from the mirror alone, 0 after "
                  f"{secs:.1f} s, bit for bit S1's state", flush=True)
    rc, err, secs, _, _, d = results["poison"]
    diag = _load_json(os.path.join(d, "diagnosis.json")) or {}
    pm = _load_json(os.path.join(d, "postmortem.json"))
    check(rc == 87 and diag.get("signature") == {
        "what": "spike_abort", "step": STORE_POISON_STEP,
        "occurrences": 2} and pm is not None and
        validate_postmortem(pm)["reason"] == "guard_abort",
        f"S4 poison: exit {rc}, diagnosis {diag.get('signature')}: "
        f"{err[-3000:]}")
    rc_stall, err_stall, secs_stall, _, _, d_stall = results["stall"]
    pm = _load_json(os.path.join(d_stall, "postmortem.json"))
    check(rc_stall == 86 and pm is not None and
          validate_postmortem(pm)["reason"] == "watchdog_stall",
          f"S4 stall: exit {rc_stall}: {err_stall[-3000:]}")
    # The stall line names the tracer's last span of each phase (A8).
    stall_lines = [x for x in err_stall.splitlines()
                   if "last completed spans on this host: " in x]
    check(stall_lines and all(
        "dispatch[step " in x and "loss_flush[step " in x
        for x in stall_lines), f"S4 stall: the stall lines {stall_lines}")
    print(f"storage S4 ({card}): poison_batch@step={STORE_POISON_STEP} "
          f"--guard_action abort --keep_fault_env: 87 after {secs:.1f} s, "
          f"diagnosis.json names spike_abort at step {STORE_POISON_STEP} "
          f"twice, postmortem.json guard_abort; stall@epoch=1 "
          f"--watchdog_secs {STORE_WATCHDOG_S} --keep_fault_env --max_restarts 1: 86 after "
          f"{secs_stall:.1f} s, postmortem.json watchdog_stall; the stall "
          f"line: {stall_lines[-1]}", flush=True)

    # S5: a failed write, at world 2.
    (rc0, s0, err0), (rc1, s1_secs, _) = results["world2"]
    check(rc0 == 1 and "async checkpoint write failed" in err0 and
          "injected checkpoint write failure at epoch 1" in err0 and
          rc1 not in (0, None) and s1_secs < 300,
          f"S5 world 2: rank 0 exit {rc0} after {s0:.1f} s, rank 1 exit "
          f"{rc1} after {s1_secs:.1f} s: {err0[-3000:]}")
    print(f"storage S5 ({card}): fail_ckpt_write@epoch=1 at world 2 over "
          f"gloo on this card: rank 0 exit 1 with the error named "
          f"after {s0:.1f} s, rank 1 ended by itself with {rc1} after "
          f"{s1_secs:.1f} s", flush=True)

    # S6: the campaign's drills, one campaign a drill, run at once.
    for d in STORE_DRILLS:
        card6 = results[f"campaign_{d}"]
        check(card6["verdict"] == "PASS", f"S6 {d}: {card6}")
        print(f"storage S6 ({card}): chaos campaign {d}: "
              f"{json.dumps(card6)}", flush=True)
    print(f"storage phase: {time.time() - t0:.1f} s (alone {t_alone:.1f} s,"
          f" five chains {t_wave1:.1f} s, three chains {t_wave2:.1f} s, the "
          f"two campaigns beside them {t_campaigns:.1f} s); "
          f"gather_batch launches {launches}", flush=True)
    return launches


# ------------------------------------------------------------ observability
# The obs phase (A8): the streamed VGG-11 at full width, batch 512, on 10,240
# images (20 steps an epoch, 5 eval batches), 2 epochs, each evaluated (so
# --profile_dir's bracket, which covers training, holds every gather_batch
# launch of the run), in deterministic children.  O3 is world 2 over gloo on
# this card at a small size: 1 epoch of 1,280 images, 64 a rank.
OBS_ARGS = ["2", "1", "--batch_size", "512", "--synthetic",
            "--synthetic_size", "10240", "--eval_every", "1"]
OBS_STEPS, OBS_EVALS, OBS_PROFILE_STEPS = 20, 5, 4
# The serial phases' sum against the spill's wall (JAX's acceptance
# identity), and the idle inspect plane's cost a step.
OBS_COVERAGE_TOL, INSPECT_OVERHEAD_MAX = 0.10, 1.0
OBS_W2_ARGS = ["1", "1", "--batch_size", "64", "--synthetic",
               "--synthetic_size", "1280"]
INSPECT_BENCH = ["--inspect_overhead", "--steps", "20", "--repeats", "3",
                 "--warmup", "5"]


def _http_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode()


def obs_child(args: list, out_dir: str, scrape=None) -> tuple:
    """``singlegpu args`` in a deterministic child writing into
    ``out_dir``; with ``scrape``, ``scrape(port)`` runs on this thread once
    the child names its inspect port on stderr.  Returns the exit code,
    the ``--result_json`` summary and the child's stderr."""
    res = os.path.join(out_dir, "result.json")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env.pop(FAULT_ENV, None)
    lines, port = [], []
    ready = threading.Event()
    with open(os.path.join(out_dir, "stdout.txt"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, *DETERMINISTIC_CHILD, *args, "--snapshot_path",
             os.path.join(out_dir, "checkpoint.pt"), "--result_json", res],
            env=env, stdout=out, stderr=subprocess.PIPE, text=True)

        def read():
            for line in proc.stderr:
                lines.append(line)
                if not port and "inspect: serving" in line:
                    port.append(int(line.rsplit(":", 1)[1]))
                    ready.set()
            ready.set()

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        try:
            if scrape is not None:
                ready.wait(timeout=300)
                check(bool(port), f"obs: the child named no inspect port: "
                                  f"{''.join(lines)[-3000:]}")
                scrape(port[0])
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            reader.join(timeout=10)
    return proc.returncode, _load_json(res), "".join(lines)


def serial_gaps(spans: list, n: int = 5) -> list:
    """The ``n`` largest stretches of a spill's timeline that no serial
    span covers: ``(ms, the span before, the span after)``."""
    serial = sorted((s for s in spans if not s["overlap"]),
                    key=lambda s: s["start_s"])
    gaps, end, prev = [], serial[0]["start_s"], None
    for s in serial:
        if s["start_s"] > end:
            gaps.append((round((s["start_s"] - end) * 1e3, 3),
                         f"{prev['phase']}[{prev['step']}]",
                         f"{s['phase']}[{s['step']}]"))
        if s["start_s"] + s["dur_s"] >= end:
            end, prev = s["start_s"] + s["dur_s"], s
    return sorted(gaps, reverse=True)[:n]


def _o1_scrape(port: int) -> dict:
    """Mid-run, against the child's inspect plane: /metrics through
    ``parse_exposition`` with batches counted, /healthz's step advancing,
    /spans holding spans, then ``/debug/profile?steps=4``."""
    got: dict = {}
    steps = []
    deadline = time.time() + 300
    while time.time() < deadline:
        step = json.loads(_http_json(port, "/healthz")).get("step", 0)
        if step >= 1 and (not steps or step > steps[-1]):
            steps.append(step)
        if len(steps) >= 2:
            break
        time.sleep(0.005)
    got["steps"] = steps
    got["metrics"] = parse_exposition(_http_json(port, "/metrics"))
    got["spans"] = json.loads(_http_json(port, "/spans"))["spans"]
    got["armed"] = json.loads(_http_json(
        port, f"/debug/profile?steps={OBS_PROFILE_STEPS}"))
    return got


def obs_phase(card: str, tmp: str) -> int:
    """Observability on the card (A8).  O1: the traced run with
    ``--trace_spill``, ``--metrics_path``, ``--log_every 10`` and
    ``--inspect_port 0``, scraped while it runs (``_o1_scrape``); after
    it, the armed capture's spans over 4 steps and its trace's 4
    ``gather_batch_kernel`` launches, ``python -m ddp_tpu_torch.obs
    --perfetto`` exiting 0 with a valid trace, the serial phases within
    ``OBS_COVERAGE_TOL`` of wall, one ``phase_stragglers`` record an epoch
    and the ``.prom`` file.  Then at once O2, the same run with
    ``--obs_off --profile_dir``: no spill left (a planted stale one
    removed), the trace's ``gather_batch_kernel`` launches the run's train
    and eval batches; and O3, world 2 over gloo on this card: rank 1's
    ``.host1`` spill, the record naming rank 0 or 1 for each phase, one
    ``straggler_gather``.  O4: ``python -m ddp_tpu_torch.bench
    --inspect_overhead`` under ``INSPECT_OVERHEAD_MAX`` %.  Returns the
    ``gather_batch`` launches of O1 and O2."""
    from ddp_tpu_torch.obs.aggregate import STRAGGLER_EXCLUDED_PHASES
    from ddp_tpu_torch.obs.export import (phase_summary, read_spill,
                                          validate_trace_events)
    from ddp_tpu_torch.obs.inspect import TRACE_FILE, trace_kernel_launches
    t0 = time.time()
    runs = {name: os.path.join(tmp, name) for name in ("o1", "o2", "o3")}
    for d in runs.values():
        os.makedirs(d)
    n_launch = 2 * (OBS_STEPS + OBS_EVALS)

    # O1.
    spill = os.path.join(runs["o1"], "spill.jsonl")
    metrics = os.path.join(runs["o1"], "metrics.jsonl")
    scraped: dict = {}
    rc, o1, err = obs_child(
        OBS_ARGS + ["--trace_spill", spill, "--metrics_path", metrics,
                    "--log_every", "10", "--inspect_port", "0"], runs["o1"],
        scrape=lambda port: scraped.update(_o1_scrape(port)))
    check(rc == 0 and o1 is not None, f"O1: exit {rc}: {err[-3000:]}")
    fams = scraped["metrics"]
    batches = fams["ddp_prefetch_batches_total"]["samples"][
        ("ddp_prefetch_batches_total", ())]
    check(batches > 0 and len(scraped["steps"]) == 2 and scraped["spans"]
          and scraped["armed"]["armed"],
          f"O1 mid-run: batches {batches}, /healthz steps "
          f"{scraped['steps']}, {len(scraped['spans'])} spans, "
          f"/debug/profile {scraped['armed']}")
    check(o1["kernel_launches"]["gather_batch"] == n_launch,
          f"O1: gather_batch launched {o1['kernel_launches']}")
    caps = sorted(f for f in os.listdir(runs["o1"])
                  if f.startswith("profile_capture_step"))
    check(len(caps) == 1, f"O1: captures {caps}")
    cap = _load_json(os.path.join(runs["o1"], caps[0]))
    cap_steps = sorted({s["step"] for s in cap["spans"]
                        if s["phase"] == "dispatch"})
    check(cap["trace_dir"] is not None, f"O1: the capture has no trace: "
          f"{err[-3000:]}")
    check(cap["end_step"] <= OBS_STEPS, f"O1: the capture ran past the "
          f"first epoch's steps, into its eval: {cap['start_step']}.."
          f"{cap['end_step']}")
    cap_launches = trace_kernel_launches(
        os.path.join(cap["trace_dir"], TRACE_FILE), "gather_batch_kernel")
    check(len(cap_steps) == OBS_PROFILE_STEPS and
          cap_launches == OBS_PROFILE_STEPS,
          f"O1: the capture from step {cap['start_step']} holds dispatch "
          f"spans of steps {cap_steps} and {cap_launches} "
          f"gather_batch_kernel launches, expected {OBS_PROFILE_STEPS}")
    perfetto = os.path.join(runs["o1"], "perfetto.json")
    r = subprocess.run([sys.executable, "-m", "ddp_tpu_torch.obs", spill,
                        "--perfetto", perfetto], capture_output=True,
                       text=True, timeout=120)
    check(r.returncode == 0, f"O1: python -m ddp_tpu_torch.obs exited "
                             f"{r.returncode}: {r.stderr[-2000:]}")
    n_events = validate_trace_events(_load_json(perfetto))
    spans = read_spill([spill])
    _, wall_s, serial_s = phase_summary(spans)
    # The identity over the second epoch, which no capture touches: the
    # trigger's profiler session starts and ends (and exports) inside the
    # step probe, which no phase covers.
    t_ep1 = min(s["start_s"] for s in spans if s["phase"] == "data_wait"
                and s["step"] >= OBS_STEPS)
    _, wall1_s, serial1_s = phase_summary(
        [s for s in spans if s["start_s"] >= t_ep1])
    coverage = serial1_s / wall1_s
    print(f"obs O1 ({card}): serial phases {serial_s:.3f} s of the whole "
          f"run's {wall_s:.3f} s wall ({serial_s / wall_s:.2%}), "
          f"{serial1_s:.3f} s of epoch 1's {wall1_s:.3f} s; the largest "
          f"gaps between serial spans: {serial_gaps(spans)}", flush=True)
    check(abs(coverage - 1.0) <= OBS_COVERAGE_TOL,
          f"O1: epoch 1's serial phases sum to {serial1_s:.3f} s of a "
          f"{wall1_s:.3f} s wall ({coverage:.1%})")
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    strag = [x for x in recs if x.get("event") == "phase_stragglers"]
    check([x["epoch"] for x in strag] == [0, 1],
          f"O1: phase_stragglers records {strag}")
    prom = parse_exposition(open(metrics + ".prom").read())
    check(prom["ddp_prefetch_batches_total"]["samples"][
        ("ddp_prefetch_batches_total", ())] == 2 * OBS_STEPS,
          "O1: the end-of-run .prom's batch count")
    o1_ms = statistics.median(o1["step_ms"])
    print(f"obs O1 ({card}): inspect port scraped mid-run (/healthz steps "
          f"{scraped['steps']}, {batches:.0f} batches on /metrics, "
          f"{len(scraped['spans'])} spans); capture of steps {cap_steps} "
          f"with {cap_launches} gather_batch_kernel launches in its "
          f"trace; spill {len(spans)} spans, Perfetto {n_events} events; "
          f"epoch 1's serial coverage {coverage:.2%}; phase_stragglers "
          f"{strag[-1]['phases']}; {o1['kernel_launches']['gather_batch']} "
          f"gather_batch launches", flush=True)
    print(r.stdout[:4000], flush=True)

    # O2 and O3 at once (O2's profiler skews its clock anyway).
    def o2():
        stale = os.path.join(runs["o2"], "spill.jsonl")
        with open(stale, "w") as f:
            f.write('{"phase": "dispatch", "stale": true}\n')
        prof_dir = os.path.join(runs["o2"], "profile")
        got = obs_child(OBS_ARGS + ["--trace_spill", stale, "--obs_off",
                                    "--profile_dir", prof_dir], runs["o2"])
        return got, os.path.exists(stale), prof_dir

    def o3():
        d = runs["o3"]
        env = dict(os.environ)
        env.pop(FAULT_ENV, None)
        t = time.time()
        code = dist.launch_local(
            [sys.executable, "-c", GLOO_RANK, *OBS_W2_ARGS,
             "--metrics_path", os.path.join(d, "m.jsonl"),
             "--trace_spill", os.path.join(d, "spill.jsonl"),
             "--snapshot_path", os.path.join(d, "checkpoint.pt"),
             "--result_json", os.path.join(d, "result.json")], 2, env=env,
            same_device=True, timeout=400)
        return code, time.time() - t

    t1 = time.time()
    results = concurrently({"o2": o2, "o3": o3})
    t_pair = time.time() - t1
    (rc, o2_out, err), stale_left, prof_dir = results["o2"]
    check(rc == 0 and o2_out is not None, f"O2: exit {rc}: {err[-3000:]}")
    trace = os.path.join(prof_dir, "trace_rank0.json")
    o2_launches = trace_kernel_launches(trace, "gather_batch_kernel")
    check(not stale_left and o2_launches == n_launch ==
          o2_out["kernel_launches"]["gather_batch"],
          f"O2: stale spill left {stale_left}; the --profile_dir trace holds "
          f"{o2_launches} gather_batch_kernel launches, the run "
          f"{o2_out['kernel_launches']}, expected {n_launch}")
    o2_ms = statistics.median(o2_out["step_ms"])
    print(f"obs O2 ({card}): --obs_off removed the planted spill; "
          f"--profile_dir trace {os.path.getsize(trace)} bytes with "
          f"{o2_launches} gather_batch_kernel launches ({2 * OBS_STEPS} "
          f"train + {2 * OBS_EVALS} eval batches); step medians (separate "
          f"processes, for information): traced O1 {o1_ms:.3f} ms, "
          f"--obs_off --profile_dir O2 {o2_ms:.3f} ms", flush=True)

    code, secs = results["o3"]
    d = runs["o3"]
    check(code == 0, f"O3: world 2 over gloo exited {code}")
    host1 = read_spill([os.path.join(d, "spill.jsonl.host1")])
    with open(os.path.join(d, "m.jsonl")) as f:
        strag = [x for x in map(json.loads, f)
                 if x.get("event") == "phase_stragglers"]
    o3 = _load_json(os.path.join(d, "result.json"))
    serial = {s["phase"] for s in host1 if not s["overlap"]} - \
        STRAGGLER_EXCLUDED_PHASES - {"eval"}
    check(host1 and {s["host"] for s in host1} == {1} and len(strag) == 1
          and set(strag[0]["phases"]) == serial
          and all(v["slowest_host"] in (0, 1)
                  for v in strag[0]["phases"].values())
          and o3["collectives"].get("straggler_gather") == 1,
          f"O3: rank 1's spill {len(host1)} spans, records {strag}, "
          f"collectives {o3['collectives']}")
    print(f"obs O3 world 2 over gloo on this card ({card}): rank 1 spilled "
          f"{len(host1)} spans to .host1; phase_stragglers "
          f"{json.dumps(strag[0]['phases'])}; collectives "
          f"{o3['collectives']} ({secs:.1f} s); O2 and O3 together "
          f"{t_pair:.1f} s", flush=True)

    # O4.
    summary = run_bench(INSPECT_BENCH)
    rec = summary["records"][0]
    check(rec["value"] < INSPECT_OVERHEAD_MAX and rec["power_limit_w"],
          f"O4: {json.dumps(rec)}")
    print(f"obs O4 ({card}): idle inspect plane {rec['value']}% a step "
          f"(median windows {json.dumps(rec['inspect_overhead'])})",
          flush=True)
    print(f"obs phase: {time.time() - t0:.1f} s", flush=True)
    return o1["kernel_launches"]["gather_batch"] + \
        o2_out["kernel_launches"]["gather_batch"]


def bf16_serve_phase(snapshot: str, f32: dict) -> dict:
    """The serving engine in bf16 on the bf16 main path's epoch-0 file:
    four graphs, each bucket bit for bit against the eager bf16 forward
    with one gather_batch_kernel a replay under the profiler, accuracy
    against evaluate_resident's in bf16; replay ms beside the float32
    serving phase's ``f32``."""
    gather_batch.launches = gather_batch.launches_bf16 = 0
    gather_rows.launches = conv3x3_fused.launches = 0
    engine = ServeEngine.from_checkpoint(snapshot, "vgg",
                                         buckets=SERVE_BUCKETS,
                                         compute_dtype=BF16)
    t0 = time.perf_counter()
    captured = engine.warm()
    warm_s = time.perf_counter() - t0
    check(captured == len(SERVE_BUCKETS) and gather_batch.launches ==
          gather_batch.launches_bf16 == 2 * len(SERVE_BUCKETS) and
          engine.stats()["compute_dtype"] == "bfloat16",
          f"bf16 warm() captured {captured} graphs, wrapper launches "
          f"{gather_batch.launches} ({gather_batch.launches_bf16} bf16), "
          f"stats {engine.stats()['compute_dtype']}")
    warm_launches = gather_batch.launches_bf16 - captured
    rng = np.random.default_rng(6)
    apply_fn = make_eval_apply(engine.model, BF16)
    per_bucket, replays_seen = {}, 0
    for b in engine.buckets:
        x = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        table = torch.from_numpy(x).cuda()
        zeros = torch.zeros(b, dtype=torch.int64, device="cuda")
        rows = torch.arange(b, dtype=torch.int32, device="cuda")
        images, _ = gather_batch(table, zeros, rows, dtype=BF16)
        want_images, _ = gather_batch_plain(table, zeros, rows, dtype=BF16)
        want = apply_fn(images).cpu().numpy()
        got = engine.forward(x)
        torch.cuda.synchronize()
        check(_bits_equal(images, want_images), f"gather_batch's bf16 eval "
              f"form differs from its plain version at N={b}")
        check(np.array_equal(got, want), f"bf16 served logits at bucket {b} "
              f"differ from the eager bf16 forward: max|diff| "
              f"{float(np.abs(got - want).max()):.3e}")
        prog = engine._programs[b]
        replay_ms = median_ms(lambda _: prog.graph.replay(), [None], 30)
        launches = gather_batch.launches
        seen, replayed, _ = profiled_forwards(engine, x, f"bf16 bucket {b}")
        check(replayed == seen["forwards"] == seen["gather_batch_kernel"] == 5
              and
              not seen["short_forwards"] and
              gather_batch.launches == launches,
              f"bf16 bucket {b}: {seen['gather_batch_kernel']} "
              f"gather_batch_kernel launches in 5 replays (profile {seen})")
        replays_seen += seen["gather_batch_kernel"]
        groups = {g: ms / 5 for g, ms in seen["groups_ms"].items()}
        per_bucket[b] = {"replay_ms": replay_ms,
                         "f32_replay_ms": f32["buckets"][b]["replay_ms"],
                         "kernels_per_replay": seen["kernels"] / 5,
                         "profiled_busy_ms": seen["busy_ms"] / 5,
                         "groups_ms": groups}
        print(f"serve bf16 bucket {b}: replay {replay_ms:.6f} ms (float32 "
              f"{f32['buckets'][b]['replay_ms']:.6f}), logits equal to the "
              f"eager bf16 forward bit for bit; profiled "
              f"{seen['kernels'] / 5:g} kernels a replay, device busy "
              f"{seen['busy_ms'] / 5:.3f} ms a forward, "
              + ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(
                  groups.items(), key=lambda kv: -kv[1])), flush=True)
    _, test_ds = synthetic(n_train=int(MAIN_ARGS[-1]),
                           n_test=int(MAIN_ARGS[-1]) // 4)
    served_acc = served_test_set(engine, test_ds, BF16)
    eval_acc = evaluate_resident(engine.model,
                                 ResidentData(test_ds, torch.device("cuda")),
                                 EvalLoader(test_ds, SERVE_BUCKETS[-1]), BF16)
    check(served_acc == eval_acc, f"bf16 served accuracy {served_acc} != "
          f"evaluate_resident's {eval_acc}")
    check(gather_rows.launches == 0 and conv3x3_fused.launches == 0,
          "row_gather or conv3x3 launched on the bf16 serving path")
    print(f"serve bf16: warm() {warm_s:.3f} s for {captured} graphs; "
          f"accuracy over {len(test_ds)} images {served_acc:.4f}% "
          f"(evaluate_resident in bf16 {eval_acc:.4f}%)", flush=True)
    return {"warm_s": warm_s, "graphs": captured, "buckets": per_bucket,
            "accuracy": served_acc, "warm_launches": warm_launches,
            "profiled_replay_launches": replays_seen}


def _republish(path: str, src: str, step: int) -> None:
    """Publish the weights of ``src`` at ``path`` through the lineage, as
    the trainer publishes a checkpoint: the head preserved, the new file
    written at ``step`` (epoch ``step - 1``), the manifest committed."""
    model = get_model("vgg")
    restore(load_checkpoint(src), model)
    lin = lineage.CheckpointLineage(path, keep=2)
    lin.preserve_head()
    sha = save_checkpoint(path, model, [torch.zeros_like(p)
                                        for p in model.parameters()],
                          step, step - 1)
    lin.commit(epoch=step - 1, step=step, sha256=sha)


def _bucket_logits(engine: ServeEngine, x: np.ndarray, b: int) -> np.ndarray:
    """``x`` in rows 0..n-1 of bucket ``b``'s program of ``engine`` (zero
    rows after it), its graph replayed: what a served batch at bucket ``b``
    answers for these rows."""
    prog = engine._programs[b]
    host = torch.zeros((b, 32, 32, 3), dtype=torch.uint8)
    host[:len(x)] = torch.from_numpy(x)
    prog.input.copy_(host.to(prog.input.device))
    return prog.run()[:len(x)].cpu().numpy()


def served_test_set(engine: ServeEngine, test_ds, dtype=None) -> float:
    """Accuracy (%) of ``test_ds`` served by ``engine`` a largest bucket at a
    time, each chunk's logits bit for bit against the eager forward of the
    chunk zero-padded to its bucket, as the engine pads it: an accuracy
    near chance compares little, the logits compare every row."""
    correct, top = 0, SERVE_BUCKETS[-1]
    for start in range(0, len(test_ds), top):
        x = test_ds.images[start:start + top]
        got = engine.forward(x)
        padded = np.zeros((engine.bucket_for(len(x)),) + x.shape[1:],
                          np.uint8)
        padded[:len(x)] = x
        want = _eager_logits(engine.model, padded, dtype)[:len(x)]
        check(np.array_equal(got, want), f"served logits of test images "
              f"{start}..{start + len(x) - 1} ({dtype}) differ from the "
              f"eager forward: max|diff| "
              f"{float(np.abs(got - want).max()):.3e}")
        correct += int((got.argmax(axis=-1)
                        == test_ds.labels[start:start + top]).sum())
    return correct / len(test_ds) * 100.0


def _eager_logits(model: torch.nn.Module, x: np.ndarray, dtype=None):
    """The eager forward of ``x``: gather_batch's eval form, then
    make_eval_apply, in ``dtype`` (float32 when None)."""
    n, dev = len(x), next(model.parameters()).device
    images, _ = gather_batch(torch.from_numpy(x).to(dev),
                             torch.zeros(n, dtype=torch.int64, device=dev),
                             torch.arange(n, dtype=torch.int32, device=dev),
                             dtype=dtype or torch.float32)
    return make_eval_apply(model, dtype)(images).cpu().numpy()


def _live(windows: list, t0: float, t1: float) -> set:
    """The snapshots live at some time in [t0, t1]: ``windows`` holds each
    swap's (start, end, snapshot after it); before the first, "A"."""
    order = ["A"] + [w[2] for w in windows]
    lo = sum(1 for ts, te, _ in windows if te < t0)
    hi = sum(1 for ts, te, _ in windows if ts <= t1)
    return set(order[lo:hi + 1])


def _fleet_built(fleet: ServeFleet, launches: int, what: str) -> None:
    check(launches == 2 * len(SERVE_BUCKETS) * FLEET_REPLICAS and all(
        r.engine.trace_count == len(SERVE_BUCKETS) for r in fleet.replicas),
        f"{what}: gather_batch's wrapper ran {launches} times building "
        f"{FLEET_REPLICAS} engines (expected 2 x {len(SERVE_BUCKETS)} "
        f"each), graphs {[r.engine.trace_count for r in fleet.replicas]}")


def _fleet_profiled(fleet: ServeFleet, x: np.ndarray, what: str) -> dict:
    """One profiled window of 5 forwards on the first replica's engine,
    after the serving phase's lead-in: 5 gather_batch_kernel, the wrapper
    not called."""
    launches = gather_batch.launches
    seen, replayed, _ = profiled_forwards(fleet.replicas[0].engine, x, what)
    check(replayed == seen["forwards"] == seen["h2d"] == seen["d2h"]
          == seen["gather_batch_kernel"] == 5 and not seen["short_forwards"]
          and gather_batch.launches == launches,
          f"{what}: {seen['gather_batch_kernel']} gather_batch_kernel "
          f"launches in {replayed} replays under the profiler (profile "
          f"{seen})")
    return seen


def _fleet_load(fleet: ServeFleet, pools: list, body) -> tuple:
    """SERVE_CLIENTS closed-loop client threads, client c cycling through
    ``pools[c]`` with ``fleet.submit``, while ``body()`` runs on this thread:
    ``(answers, shed, errors, t0, t1)``, an answer ``(k, t0, t1, logits)``
    for request k of its client's pool, times by ``time.monotonic``."""
    answers = [[] for _ in pools]
    errors, shed, lock = [], [0], threading.Lock()
    stop = threading.Event()

    def client(c: int) -> None:
        k = 0
        while not stop.is_set():
            x = pools[c][k % len(pools[c])]
            t0 = time.monotonic()
            try:
                out = fleet.submit(x, timeout=60)
            except QueueFull:  # a router shed: backpressure, not a failure
                with lock:
                    shed[0] += 1
                time.sleep(0.01)
                continue
            except Exception as e:  # reported by the caller
                errors.append(f"client {c}: {type(e).__name__}: {e}")
                continue
            answers[c].append((k % len(pools[c]), t0, time.monotonic(), out))
            k += 1

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(pools))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    try:
        body()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    check(not any(t.is_alive() for t in threads), "a fleet client hung")
    return answers, shed[0], errors, t0, time.monotonic()


def fleet_f1(snapshot: str, resume_file: str, tmp: str, card: str) -> dict:
    """F1, in process: a ServeFleet of FLEET_REPLICAS VGG-11 replicas on a
    lineage publishing the main path's epoch-0 file ("A"); every replica's
    logits bit for bit the eager forward at every bucket; then under
    SERVE_CLIENTS closed-loop threads, FLEET_SWAPS hot swaps to the
    streaming phase's --resume file ("B") and back, each a republish; every
    answer bit for bit a forward of a snapshot live while it was in flight
    (at one of the buckets its batch could have had); memory flat."""
    path = os.path.join(tmp, "f1", "checkpoint.pt")
    os.makedirs(os.path.dirname(path))
    _republish(path, snapshot, 1)
    srcs = {"A": snapshot, "B": resume_file}
    refs = {k: ServeEngine.from_checkpoint(src, "vgg", buckets=SERVE_BUCKETS)
            for k, src in srcs.items()}
    for eng in refs.values():
        eng.warm()
    torch.cuda.synchronize()
    gather_batch.launches = gather_rows.launches = 0
    conv3x3_fused.launches = 0
    t0 = time.perf_counter()
    fleet = ServeFleet(path, "vgg", n_replicas=FLEET_REPLICAS,
                       buckets=SERVE_BUCKETS)
    build_s = time.perf_counter() - t0
    _fleet_built(fleet, gather_batch.launches, "fleet f32")
    eager_warm = gather_batch.launches - FLEET_REPLICAS * len(SERVE_BUCKETS)
    rng = np.random.default_rng(15)
    replay_ms = {r.replica_id: {} for r in fleet.replicas}
    for b in SERVE_BUCKETS:
        x = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        want = _eager_logits(refs["A"].model, x)
        for rep in fleet.replicas:
            got = rep.submit(x, timeout=60)
            check(np.array_equal(got, want),
                  f"fleet replica {rep.replica_id} bucket {b}: logits differ "
                  f"from the eager forward, max|diff| "
                  f"{float(np.abs(got - want).max()):.3e}")
            prog = rep.engine._programs[b]
            replay_ms[rep.replica_id][b] = median_ms(
                lambda _: prog.graph.replay(), [None], 30)
    # Rows of a served batch answer as they would alone in the same bucket
    # (the batch is parallel work): the premise of the load check below.
    x = rng.integers(0, 256, (SERVE_BUCKETS[-1], 32, 32, 3), dtype=np.uint8)
    check(np.array_equal(np.roll(_bucket_logits(refs["A"], x, x.shape[0]),
                                 37, axis=0),
                         _bucket_logits(refs["A"], np.roll(x, 37, axis=0),
                                        x.shape[0])),
          "a served row's logits depend on its position in the batch")
    seen = _fleet_profiled(fleet, x[:8], "fleet r0 bucket 8")

    pools = [[rng.integers(0, 256, (int(rng.integers(1, SERVE_MAX_ROWS + 1)),
                                    32, 32, 3), dtype=np.uint8)
              for _ in range(FLEET_POOL)] for _ in range(SERVE_CLIENTS)]
    windows, memory = [], []

    def swaps() -> None:
        time.sleep(FLEET_STEADY_S)
        for k in range(1, FLEET_SWAPS + 1):
            key = "B" if k % 2 else "A"
            ts = time.monotonic()
            _republish(path, srcs[key], k + 1)
            event = fleet.poll_once()
            te = time.monotonic()
            check(event == "swap_commit", f"swap {k}: poll_once said {event}")
            windows.append((ts, te, key))
            gc.collect()
            torch.cuda.synchronize()
            memory.append((torch.cuda.memory_allocated(),
                           torch.cuda.memory_reserved()))
            time.sleep(FLEET_AFTER_SWAP_S)

    launches0 = gather_batch.launches
    answers, shed, errors, load_t0, load_t1 = _fleet_load(fleet, pools,
                                                          swaps)
    check(not errors, f"fleet load: {len(errors)} failed requests: "
          f"{errors[:3]}")
    swap_launches = gather_batch.launches - launches0
    check(swap_launches == FLEET_SWAPS * 2 * len(SERVE_BUCKETS)
          * FLEET_REPLICAS, f"the swaps ran gather_batch's wrapper "
          f"{swap_launches} times")
    history = fleet.stats()["swaps"]
    check([e["event"] for e in history] == ["swap_commit"] * FLEET_SWAPS
          and all(e["old_drained_clean"] for e in history)
          and [e["step"] for e in history] == list(range(2, FLEET_SWAPS + 2)),
          f"swap history {history}")
    allocated = [m[0] for m in memory]
    check(abs(allocated[-1] - allocated[0]) <= 0.05 * allocated[0],
          f"memory_allocated after swap 1 {allocated[0]} B, after swap "
          f"{FLEET_SWAPS} {allocated[-1]} B")

    cache = {}

    def ref(key, c, k, b):
        if (key, c, k, b) not in cache:
            cache[key, c, k, b] = _bucket_logits(refs[key], pools[c][k], b)
        return cache[key, c, k, b]

    by_snapshot = collections.Counter()
    steady, swapping, rows_steady, rows_swapping = [], [], 0, 0
    for c, outs in enumerate(answers):
        for k, t0, t1, out in outs:
            x = pools[c][k]
            live = _live(windows, t0, t1)
            got = [key for key in sorted(live) if any(
                np.array_equal(out, ref(key, c, k, b))
                for b in SERVE_BUCKETS if b >= len(x))]
            check(len(got) >= 1, f"client {c} request {k} ({len(x)} rows, "
                  f"live {sorted(live)}): the answer is no bucket's forward "
                  f"of a live snapshot")
            by_snapshot[got[0] if len(live) == 1 else "either"] += 1
            lat = (t1 - t0) * 1e3
            if any(t0 <= te and t1 >= ts for ts, te, _ in windows):
                swapping.append(lat)
                rows_swapping += len(x)
            elif t1 < windows[0][0]:
                steady.append(lat)
                rows_steady += len(x)
    check(by_snapshot["A"] > 0 and by_snapshot["B"] > 0,
          f"answers by snapshot {dict(by_snapshot)}: a snapshot served none")
    check(not any(np.array_equal(ref("A", c, 0, SERVE_BUCKETS[-1]),
                                 ref("B", c, 0, SERVE_BUCKETS[-1]))
                  for c in range(SERVE_CLIENTS)),
          "the two snapshots answer alike: the check would see nothing")
    clean = fleet.close()
    check(clean, "the fleet's batchers did not drain")
    # The same load on one replica of the same file, for as long as the
    # first stretch above: do two replicas on one card serve more rows/s?
    launches1 = gather_batch.launches
    one = ServeFleet(path, "vgg", n_replicas=1, buckets=SERVE_BUCKETS)
    one_launches = gather_batch.launches - launches1
    check(one_launches == 2 * len(SERVE_BUCKETS), f"one replica's engine "
          f"ran gather_batch's wrapper {one_launches} times")
    one_answers, one_shed, one_errors, one_t0, one_t1 = _fleet_load(
        one, pools, lambda: time.sleep(FLEET_STEADY_S))
    check(not one_errors and one.close(),
          f"one replica's load: {one_errors[:3]}")
    one_lat = [(t1 - t0) * 1e3 for outs in one_answers
               for _, t0, t1, _ in outs]
    one_rows = sum(len(pools[c][k]) for c, outs in enumerate(one_answers)
                   for k, *_ in outs)
    check(gather_rows.launches == 0 and conv3x3_fused.launches == 0,
          "row_gather or conv3x3 launched on the fleet path")
    swap_s = sum(te - ts for ts, te, _ in windows)
    n_answers = sum(len(a) for a in answers)
    rows = sum(len(pools[c][k]) for c, outs in enumerate(answers)
               for k, *_ in outs)
    out = {
        "build_s": build_s, "replay_ms": replay_ms,
        "answers": n_answers, "rows": rows, "shed": shed, "failed": 0,
        "by_snapshot": dict(by_snapshot),
        "rows_per_s": rows / (load_t1 - load_t0),
        "steady_rows_per_s": rows_steady / (windows[0][0] - load_t0),
        "swapping_rows_per_s": rows_swapping / swap_s,
        "steady_p50_p99_ms": percentiles(steady, (50, 99)),
        "one_replica_rows_per_s": one_rows / (one_t1 - one_t0),
        "one_replica_p50_p99_ms": percentiles(one_lat, (50, 99)),
        "one_replica_shed": one_shed,
        "swapping_p50_p99_ms": percentiles(swapping, (50, 99)),
        "swap_window_s": [te - ts for ts, te, _ in windows],
        "warm_s": [e["warm_s"] for e in history],
        "memory_allocated": allocated,
        "memory_reserved": [m[1] for m in memory],
        "profiled": {k: seen[k] for k in ("forwards", "gather_batch_kernel",
                                          "kernels", "busy_ms")},
        "launches": eager_warm + seen["gather_batch_kernel"]
        + (swap_launches + one_launches) // 2,
    }
    print(f"fleet F1 ({card}): {FLEET_REPLICAS} replicas built in "
          f"{build_s:.3f} s, every replica bit for bit the eager forward at "
          f"buckets {list(SERVE_BUCKETS)}; replay ms {json.dumps(replay_ms)}"
          f"; profiled r0: {seen['gather_batch_kernel']} gather_batch_kernel "
          f"in 5 forwards; load of {SERVE_CLIENTS} closed-loop clients: "
          f"{n_answers} answers ({rows} rows, {shed} shed, 0 failed) in "
          f"{load_t1 - load_t0:.3f} s, {out['rows_per_s']:.1f} rows/s; "
          f"steady {out['steady_rows_per_s']:.1f} rows/s p50/p99 "
          f"{out['steady_p50_p99_ms']} ms, during swaps "
          f"{out['swapping_rows_per_s']:.1f} rows/s p50/p99 "
          f"{out['swapping_p50_p99_ms']} ms; one replica under the same "
          f"load {out['one_replica_rows_per_s']:.1f} rows/s p50/p99 "
          f"{out['one_replica_p50_p99_ms']} ms; {FLEET_SWAPS} swaps, windows "
          f"{[round(w, 3) for w in out['swap_window_s']]} s (warm "
          f"{out['warm_s']} s); answers by snapshot {dict(by_snapshot)}, "
          f"each bit for bit a live snapshot's forward; memory_allocated "
          f"after each swap {allocated} B (reserved "
          f"{out['memory_reserved']} B)", flush=True)
    return out


def fleet_bf16(snapshot_bf16: str, tmp: str, card: str) -> dict:
    """F1 in bf16 on the bf16 main path's file, without the load: every
    replica bit for bit the eager bf16 forward at every bucket, the
    wrapper run 2 x 4 times an engine, one profiled window."""
    path = os.path.join(tmp, "f1_bf16", "checkpoint.pt")
    os.makedirs(os.path.dirname(path))
    shutil.copy(snapshot_bf16, path)
    model = get_model("vgg")
    restore(load_checkpoint(snapshot_bf16), model)
    model.cuda()
    gather_batch.launches = gather_batch.launches_bf16 = 0
    fleet = ServeFleet(path, "vgg", n_replicas=FLEET_REPLICAS,
                       buckets=SERVE_BUCKETS, compute_dtype=BF16)
    _fleet_built(fleet, gather_batch.launches_bf16, "fleet bf16")
    eager_warm = gather_batch.launches_bf16 - FLEET_REPLICAS * len(
        SERVE_BUCKETS)
    rng = np.random.default_rng(16)
    for b in SERVE_BUCKETS:
        x = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        want = _eager_logits(model, x, BF16)
        for rep in fleet.replicas:
            got = rep.submit(x, timeout=60)
            check(np.array_equal(got, want),
                  f"fleet bf16 replica {rep.replica_id} bucket {b}: logits "
                  f"differ from the eager bf16 forward, max|diff| "
                  f"{float(np.abs(got - want).max()):.3e}")
    launches = gather_batch.launches_bf16
    seen = _fleet_profiled(fleet, x[:8], "fleet bf16 r0 bucket 8")
    check(gather_batch.launches_bf16 == launches, "the profiled bf16 window "
          "called the wrapper")
    check(fleet.close(), "the bf16 fleet's batchers did not drain")
    print(f"fleet bf16 ({card}): {FLEET_REPLICAS} replicas, every replica "
          f"bit for bit the eager bf16 forward at buckets "
          f"{list(SERVE_BUCKETS)}; profiled r0: {seen['gather_batch_kernel']}"
          f" gather_batch_kernel in 5 forwards", flush=True)
    return {"launches": eager_warm + seen["gather_batch_kernel"]}


def fleet_f2_start(snapshot: str, tmp: str) -> tuple:
    """Start F2's server: ``python -m ddp_tpu_torch.serve --fleet 2
    --swap_poll_s 0.5`` on port 0 over a copy of the main path's file, under
    FLEET_FAULT, with a span spill."""
    d = os.path.join(tmp, "f2")
    os.makedirs(d)
    ck = os.path.join(d, "checkpoint.pt")
    shutil.copy(snapshot, ck)
    spill = os.path.join(d, "fleet_spill.jsonl")
    err = open(os.path.join(d, "serve.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddp_tpu_torch.serve", "--snapshot_path", ck,
         "--fleet", str(FLEET_REPLICAS), "--swap_poll_s", "0.5", "--port",
         "0", "--trace_spill", spill], cwd=ROOT,
        env=dict(os.environ, **{FAULT_ENV: FLEET_FAULT}),
        stdout=subprocess.PIPE, stderr=err, text=True)
    return proc, err, d


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def fleet_f2(proc, err, d: str, card: str) -> dict:
    """F2, out of process, the CI drill's form: the smoke's own HTTP clients
    keep an ok/shed/failed ledger (a 503 honours Retry-After) while the
    fault kills replica r0 and a ``singlegpu --resume`` child republishes
    the checkpoint mid-load; 0 failed, an ejection and a swap_commit in
    /stats, /metrics' router totals equal to /stats, SIGTERM exit 0, and
    the spill's Perfetto export holding eject and swap_commit."""
    ck = os.path.join(d, "checkpoint.pt")
    try:
        line = proc.stdout.readline()
        check(f"fleet of {FLEET_REPLICAS} on http://" in line,
              f"the fleet server did not start: {line!r}")
        base = line.split(" on ")[1].split(" ")[0].rstrip("/")
        health = _get_json(base + "/healthz")
        check(health["status"] == "ok" and
              health["healthy_replicas"] == FLEET_REPLICAS,
              f"fleet /healthz {health}")
        ledger = {"ok": 0, "shed": 0, "failed": 0}
        latency_ms, lock, stop = [], threading.Lock(), threading.Event()

        def client(seed: int) -> None:
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                n = int(rng.integers(1, FLEET_F2_ROWS + 1))
                req = urllib.request.Request(
                    base + "/predict", data=json.dumps({
                        "instances": rng.integers(0, 256, (n, 32, 32, 3))
                        .tolist()}).encode(),
                    headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        good = len(json.loads(r.read())["predictions"]) == n
                except urllib.error.HTTPError as e:
                    if e.code == 503:  # an explicit shed: honour the hint
                        with lock:
                            ledger["shed"] += 1
                        time.sleep(min(float(
                            e.headers.get("Retry-After", 1) or 1), 0.25))
                        continue
                    good = False
                except Exception:
                    good = False
                with lock:
                    ledger["ok" if good else "failed"] += 1
                    if good:
                        latency_ms.append((time.perf_counter() - t0) * 1e3)

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(SERVE_CLIENTS)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        # The child publishes after its start-up and 20 steps: the crash
        # fault has long fired by then, and the load runs on.
        t_pub = time.monotonic()
        child = subprocess.run(
            [sys.executable, "-m", "ddp_tpu_torch.singlegpu",
             *FLEET_REPUBLISH_ARGS, "--snapshot_path", ck, "--resume",
             "--obs_off"], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        check(child.returncode == 0, f"the republishing child exited "
              f"{child.returncode}: {child.stderr[-2000:]}")
        publish_s = time.monotonic() - t_pub
        deadline = time.monotonic() + 60
        while not any(e["event"] == "swap_commit"
                      for e in _get_json(base + "/stats")["swaps"]):
            check(time.monotonic() < deadline, "no swap_commit in /stats")
            time.sleep(0.25)
        time.sleep(0.5)  # serve on the new snapshot for a while
        stop.set()
        for t in threads:
            t.join(timeout=120)
        load_s = time.monotonic() - t0
        stats = _get_json(base + "/stats")
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            fams = parse_exposition(r.read().decode())
        router = stats["router"]
        totals = {m: sum(fams[m]["samples"].values()) for m in (
            "ddp_router_ejections_total", "ddp_router_retries_total",
            "ddp_fleet_swap_commits_total")}
        check(ledger["failed"] == 0 and ledger["ok"] > 0,
              f"fleet F2 ledger {ledger}")
        check(router["ejections"] >= 1 and router["retries"] >= 1,
              f"fleet F2 router {router}")
        check(totals["ddp_router_ejections_total"] == router["ejections"] and
              totals["ddp_router_retries_total"] == router["retries"],
              f"/metrics {totals} against /stats {router}")
        commits = [e for e in stats["swaps"] if e["event"] == "swap_commit"]
        check(totals["ddp_fleet_swap_commits_total"] == len(commits) >= 1,
              f"swap commits {totals} against {stats['swaps']}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    with open(os.path.join(d, "serve.err")) as f:
        err_text = f.read()
    check(rc == 0 and "drained=clean" in err_text,
          f"the fleet server exited {rc}: {err_text[-2000:]}")
    # python -m ddp_tpu_torch.obs's entry point, in this process (its
    # report to a buffer).
    trace_path = os.path.join(d, "trace.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = obs_main([os.path.join(d, "fleet_spill.jsonl"), "--perfetto",
                       trace_path])
    check(rc == 0, f"python -m ddp_tpu_torch.obs exited {rc} on the spill")
    with open(trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    check({"eject", "swap_commit", "route", "retry"} <= names,
          f"the Perfetto export lacks eject/swap_commit/route/retry")
    lat = percentiles(latency_ms, (50, 99))
    res = {"ledger": ledger, "load_s": load_s, "publish_s": publish_s,
           "ejections": router["ejections"], "retries": router["retries"],
           "swaps": [{k: e.get(k) for k in ("event", "step", "from_step",
                                           "warm_s")}
                     for e in stats["swaps"]],
           "client_p50_ms": lat["p50"], "client_p99_ms": lat["p99"],
           "ok_per_s": ledger["ok"] / load_s}
    print(f"fleet F2 ({card}): python -m ddp_tpu_torch.serve --fleet "
          f"{FLEET_REPLICAS} --swap_poll_s 0.5 under {FLEET_FAULT}: ledger "
          f"{ledger} over {load_s:.1f} s of {SERVE_CLIENTS} HTTP clients "
          f"(1-{FLEET_F2_ROWS} rows; p50 {lat['p50']:.3f} ms, p99 "
          f"{lat['p99']:.3f} ms), ejections {router['ejections']}, retries "
          f"{router['retries']} (equal in /metrics), the singlegpu --resume "
          f"republish {publish_s:.1f} s, swaps {res['swaps']}; SIGTERM exit "
          f"0 drained clean; the Perfetto export holds eject and "
          f"swap_commit", flush=True)
    return res


def fleet_phase(snapshot: str, resume_file: str, snapshot_bf16: str,
                card: str) -> dict:
    """The serving fleet (A9): F1 in process (float32 under load and hot
    swaps, then bf16 while F2's server starts), F2 out of process."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        f1 = fleet_f1(snapshot, resume_file, tmp, card)
        proc, err, d = fleet_f2_start(snapshot, tmp)
        try:
            bf16 = fleet_bf16(snapshot_bf16, tmp, card)
        except BaseException:
            proc.kill()
            proc.wait()
            err.close()
            raise
        f2 = fleet_f2(proc, err, d, card)
    print(f"fleet phase: {time.time() - t0:.1f} s", flush=True)
    return {"f1": f1, "f2": f2, "launches": f1["launches"],
            "launches_bf16": bf16["launches"]}


def _tests_module(name: str):
    """The module ``tests/{name}.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def anchor_phase(path: str, compute_dtype, card: str) -> dict:
    """ROADMAP C2's accuracy anchor: the recording ``path``'s config (batch
    64, lr 0.05, 768 images of synthetic(seed=21, label_noise=0.25), 256
    held out, no augmentation, the shuffle rng(1234 + epoch), init from
    TorchVGG under torch.manual_seed(2)) for 20 epochs through the port's
    resident step on the card at full width in ``compute_dtype``; the final
    held-out accuracy within ANCHOR_TOL_POINTS of the recording's."""
    with open(os.path.join(ROOT, path)) as f:
        art = json.load(f)
    cfg = art["config"]
    check({k: cfg[k] for k in ANCHOR_CONFIG} == ANCHOR_CONFIG and
          cfg.get("compute_dtype", "float32") ==
          ("bfloat16" if compute_dtype else "float32"),
          f"{path}: config {cfg}")
    batch, spe, epochs = cfg["batch"], cfg["steps_per_epoch"], cfg["epochs"]
    train, test = synthetic(n_train=cfg["n_train"], n_test=cfg["n_test"],
                            seed=ANCHOR_DATA_SEED,
                            label_noise=cfg["label_noise"])
    torch.manual_seed(ANCHOR_INIT_SEED)
    ref = _tests_module("torch_ref").TorchVGG()
    model = VGG()
    model.load_state_dict({k: v for k, v in ref.state_dict().items()
                           if not k.endswith("num_batches_tracked")})
    dev = torch.device("cuda")
    model.to(dev)
    res, tres = ResidentData(train, dev), ResidentData(test, dev)
    state = init_train_state(model)
    run = make_train_epoch(
        model, SGDConfig(lr=cfg["base_lr"]),
        functools.partial(triangular_lr, base_lr=cfg["base_lr"],
                          num_epochs=epochs, steps_per_epoch=spe),
        device_augment=False, compute_dtype=compute_dtype)
    loader = EvalLoader(test, cfg["n_test"])
    launches = gather_batch.launches
    t0 = time.time()
    rows = []
    for epoch in range(epochs):
        perm = np.random.default_rng(ANCHOR_SHUFFLE_SEED + epoch).permutation(
            cfg["n_train"])[:spe * batch].reshape(spe, batch)
        losses = run(state, res.images, res.labels,
                     torch.from_numpy(perm.astype(np.int32)).to(dev))
        acc = evaluate_resident(model, tres, loader, compute_dtype)
        rows.append((float(losses.mean()), acc))
    seconds = time.time() - t0
    check(gather_batch.launches - launches == epochs * (spe + 1),
          f"the anchor ran gather_batch {gather_batch.launches - launches} "
          f"times")
    name = "bf16" if compute_dtype else "float32"
    for (loss, acc), rec in zip(rows, art["per_epoch"]):
        print(f"anchor {name} epoch {rec['epoch']:2d}: mean loss {loss:.6f} "
              f"(JAX {rec['jax_mean_loss']:.6f}, torch reference "
              f"{rec['torch_mean_loss']:.6f}), held-out accuracy "
              f"{acc:.4f}% (JAX {rec['jax_acc']:.4f}%)", flush=True)
    final, want = rows[-1][1], art["final_jax_acc"]
    print(f"anchor {name} ({card}): {epochs} epochs of {spe} steps at batch "
          f"{batch} in {seconds:.2f} s, final held-out accuracy "
          f"{final:.4f}% against the recording's {want:.4f}% (tolerance "
          f"{ANCHOR_TOL_POINTS:g} points; empirical ceiling "
          f"{cfg['empirical_ceiling_pct']}%)", flush=True)
    check(math.isfinite(rows[-1][0]) and abs(final - want) <=
          ANCHOR_TOL_POINTS, f"anchor {path}: final accuracy {final:.4f}% "
          f"against {want:.4f}%")
    return {"path": path, "final_acc": final, "want_acc": want,
            "seconds": seconds, "mean_losses": [r[0] for r in rows],
            "accs": [r[1] for r in rows]}



# The models phase (DeepNN and ResNet-18 through --model).  Each model's
# world-2 drill (sync-BN and --shard_update composed, crop and flip, lr
# 0.05) runs on the card and on the CPU, and each run is held against the
# float64 epoch of the same drill (``tests/torch_float64.py::
# float64_drill``, written apart from the port), the card within
# PARITY_TOL; the CPU's distance is printed beside it.  The CPU is not the
# referee: on ResNet-18 its float32 stem-kernel momentum lies 3.3e-5 from
# float64 on this drill and 2.5e-4 on 64 images of 16 a rank, where the
# card and the CPU parted by 2.5e-4.  Each drill's images
# (``synthetic(n_train, seed=data)``), per-rank batch, --grad_accum and
# seed keep every ReLU input and every max-pool window's top two at least
# KINK_MARGIN apart at the start weights (``drill.margins``), so that
# float32 rounding cannot move a decision.  ResNet-18: the strategy
# drill's shape (40 images, 8 a rank in groups of 2, the ragged 4 alone)
# on data seed 1, at seed 5, the first from 0 that clears (2.6e-6).
# DeepNN has no BatchNorm and some 220,000 ReLU inputs an image: at two
# images a rank no seed pair tried clears 3.3e-7, so its drill is one step
# of one image a rank, at the data seed and seed (28, 0), the first of the
# pairs tried that clears (1.2e-6; ``tests/models_parity_probe.py
# --margins``: 2 of 120 pairs clear 1e-6).
MODELS = ("deepnn", "resnet18")
# Each model's arguments.  DeepNN has no BatchNorm: at the reference's peak
# lr 0.4 its losses left the finite range within this phase's first epoch,
# and ``singlegpu --model deepnn --batch_size 128 --synthetic_size 2560
# --lr 0.4`` spikes to 81 within 20 steps on the CPU, so it trains at 0.05,
# as the repo's other DeepNN runs do.
MODEL_ARGS = {"deepnn": ["--model", "deepnn", "--lr", "0.05"],
              "resnet18": ["--model", "resnet18"]}
MODEL_DRILLS = {
    "deepnn": {"n_train": 2, "data": 28, "batch": 1, "accum": 1,
               "seed": 0},
    "resnet18": {"n_train": 40, "data": 1, "batch": 8, "accum": 2,
                 "seed": 5}}


def model_run(args: list, snapshot: str) -> dict:
    """``python -m ddp_tpu_torch.multigpu args`` run in this process as rank
    0 of a world-1 NCCL group, every count set to 0 just before and read
    just after: its ``--result_json`` summary with ``wall_s``, ``state``
    and ``launches``."""
    gather_batch.launches = gather_batch.launches_bf16 = 0
    gather_rows.launches = conv3x3_fused.launches = 0
    dist.collective_calls.clear()
    path = snapshot + ".json"
    t0 = time.time()
    with world1_rendezvous():
        out = cli.main_multi(args + ["--snapshot_path", snapshot,
                                     "--result_json", path])
    with open(path) as f:
        res = json.load(f)
    res.update(wall_s=time.time() - t0, state=out["state"],
               launches={"gather_batch": gather_batch.launches,
                         "gather_batch_bf16": gather_batch.launches_bf16,
                         "row_gather": gather_rows.launches,
                         "conv3x3": conv3x3_fused.launches})
    check((res["world"], res["backend"]) == (1, "nccl") and
          all(math.isfinite(x) for x in res["loss_history"]) and
          math.isfinite(res["accuracy"]) and 0 <= res["accuracy"] <= 100,
          f"multigpu {' '.join(args)}: world {res['world']}, "
          f"{res['backend']}, accuracy {res['accuracy']}, a loss not finite")
    return res


def _launches(n: int, bf16: bool = False) -> dict:
    return {"gather_batch": n, "gather_batch_bf16": n if bf16 else 0,
            "row_gather": 0, "conv3x3": 0}


def _step_line(res: dict, steps: int, batch: int = 512) -> str:
    event = statistics.median(res["step_ms"])
    wall = sum(res["epoch_seconds"]) * 1e3 / steps
    return (f"event median {event:.3f} ms/step "
            f"({batch / event * 1e3:.1f} samples/s), wall {wall:.3f} ms/step "
            f"({batch / wall * 1e3:.1f} samples/s)")


def model_serve(name: str, snapshot: str, dtype, test_ds) -> dict:
    """The serving engine for ``name`` on ``snapshot`` at SERVE_BUCKETS in
    ``dtype``: four graphs (the wrapper run once eagerly and once at
    capture a bucket), each bucket's logits bit for bit against the eager
    ``gather_batch`` + eval forward, its replay ms, and the served accuracy
    equal to evaluate_resident's.  The graphs are VGG's programs
    (``EvalProgram``), whose replays the serving phase counts under the
    profiler; here, late in a long process, the profiler dropped one
    replay's kernel of five (ROADMAP C3), so the models' replays are not
    counted that way."""
    gather_batch.launches = gather_batch.launches_bf16 = 0
    engine = ServeEngine.from_checkpoint(snapshot, name,
                                         buckets=SERVE_BUCKETS,
                                         compute_dtype=dtype)
    captured = engine.warm()
    check(captured == len(SERVE_BUCKETS) and
          gather_batch.launches == 2 * len(SERVE_BUCKETS),
          f"{name} serve: {captured} graphs, {gather_batch.launches} "
          f"wrapper calls in warm()")
    warm_launches = gather_batch.launches - captured
    rng = np.random.default_rng(7)
    apply_fn = make_eval_apply(engine.model, dtype)
    replay = {}
    for b in engine.buckets:
        x = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        images, _ = gather_batch(
            torch.from_numpy(x).cuda(),
            torch.zeros(b, dtype=torch.int64, device="cuda"),
            torch.arange(b, dtype=torch.int32, device="cuda"),
            dtype=dtype or torch.float32)
        want = apply_fn(images).cpu().numpy()
        got = engine.forward(x)
        check(np.array_equal(got, want), f"{name} served logits at bucket "
              f"{b} ({dtype}) differ from the eager forward: max|diff| "
              f"{float(np.abs(got - want).max()):.3e}")
        prog = engine._programs[b]
        replay[b] = median_ms(lambda _: prog.graph.replay(), [None], 30)
    served = served_test_set(engine, test_ds, dtype)
    evaluated = evaluate_resident(engine.model,
                                  ResidentData(test_ds, torch.device("cuda")),
                                  EvalLoader(test_ds, SERVE_BUCKETS[-1]),
                                  dtype)
    check(served == evaluated, f"{name} served accuracy {served} != "
          f"evaluate_resident's {evaluated} ({dtype})")
    return {"replay_ms": replay, "accuracy": served,
            "launches": warm_launches}


def _restored_equal(ckpt, state) -> bool:
    """Whether a checkpoint restores bit for bit into a fresh model of
    ``state``'s and momentum."""
    model = copy.deepcopy(state.model)
    momentum = [torch.zeros_like(m) for m in state.momentum]
    restore(ckpt, model, momentum)
    live = state.model.state_dict()
    return all(torch.equal(v, live[k]) for k, v in
               model.state_dict().items()) and \
        all(torch.equal(a, b) for a, b in zip(momentum, state.momentum))


def model_phase(name: str, main: dict, main_bf16: dict, card: str,
                tmp: str) -> dict:
    """One model through the port's entry points on the card (world-1 NCCL
    ``multigpu`` in this process): f32 and bf16 on 9,040 images, the
    resume of the f32 file, streaming and the composed flags on 10,240,
    serving in both dtypes, the torch export round trip and the step's
    kernels by group.  Returns its launches by path and numbers."""
    margs = MODEL_ARGS[name]
    snap = os.path.join(tmp, f"{name}.pt")
    n = MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS
    f32 = model_run(MAIN_ARGS + margs, snap)
    check(f32["model"] == name and f32["launches"] == _launches(n) and
          len(f32["loss_history"]) == MAIN_TRAIN_STEPS,
          f"{name} f32: model {f32['model']}, launches {f32['launches']}, "
          f"{len(f32['loss_history'])} losses")
    want, formula = model_collectives(f32["state"].model, MAIN_TRAIN_STEPS,
                                      MAIN_TRAIN_STEPS, sync_bn=False,
                                      zero=False, saves=0)
    check(f32["collectives"] == want, f"{name} f32 collectives "
          f"{f32['collectives']}, expected {want} ({formula})")
    ckpt = load_checkpoint(snap)
    check(ckpt.step == MAIN_TRAIN_STEPS and ckpt.epoch == 0 and
          _float32_file(ckpt) and _restored_equal(ckpt, f32["state"]),
          f"{name} checkpoint: step {ckpt.step}, epoch {ckpt.epoch}, or "
          f"not float32, or it does not restore bit for bit")
    epoch0 = snap + ".epoch0"
    with open(snap, "rb") as src, open(epoch0, "wb") as dst:
        dst.write(src.read())
    n_params = sum(p.numel() for p in f32["state"].model.parameters())
    print(f"models, {name} f32 ({card}): {n_params} parameters; "
          f"{_step_line(f32, MAIN_TRAIN_STEPS)}; VGG-11 in this process "
          f"{_step_line(main, MAIN_TRAIN_STEPS)}; train "
          f"{f32['training_seconds']:.2f} s, eval {f32['eval_seconds']:.2f} "
          f"s, wall {f32['wall_s']:.2f} s; launches {f32['launches']}; "
          f"collectives {f32['collectives']} = {formula}; first/last loss "
          f"{f32['loss_history'][0]:.4f}/{f32['loss_history'][-1]:.4f}; "
          f"accuracy {f32['accuracy']:.2f}%; checkpoint float32, restores "
          f"bit for bit", flush=True)

    resumed = model_run(["2"] + MAIN_ARGS[1:] + margs + ["--resume"], snap)
    ckpt = load_checkpoint(snap)
    check(len(resumed["loss_history"]) == MAIN_TRAIN_STEPS and
          resumed["launches"] == _launches(n) and
          ckpt.step == 2 * MAIN_TRAIN_STEPS and ckpt.epoch == 1,
          f"{name} --resume: {len(resumed['loss_history'])} losses, "
          f"launches {resumed['launches']}, checkpoint step {ckpt.step} "
          f"epoch {ckpt.epoch}")
    print(f"models, {name} --resume ({card}): epoch 1 from the epoch-0 "
          f"file, {_step_line(resumed, MAIN_TRAIN_STEPS)}; first/last loss "
          f"{resumed['loss_history'][0]:.4f}/"
          f"{resumed['loss_history'][-1]:.4f}; accuracy "
          f"{resumed['accuracy']:.2f}%; checkpoint step {ckpt.step}",
          flush=True)

    snap_bf16 = os.path.join(tmp, f"{name}_bf16.pt")
    bf16 = model_run(MAIN_ARGS + margs + ["--bf16"], snap_bf16)
    ckpt = load_checkpoint(snap_bf16)
    check(bf16["compute_dtype"] == "bfloat16" and
          bf16["launches"] == _launches(n, bf16=True) and
          len(bf16["loss_history"]) == MAIN_TRAIN_STEPS and
          _float32_file(ckpt), f"{name} bf16: {bf16['compute_dtype']}, "
          f"launches {bf16['launches']}, float32 file {_float32_file(ckpt)}")
    print(f"models, {name} --bf16 ({card}): "
          f"{_step_line(bf16, MAIN_TRAIN_STEPS)}; VGG-11 --bf16 "
          f"{_step_line(main_bf16, MAIN_TRAIN_STEPS)}; launches "
          f"{bf16['launches']}; first/last loss "
          f"{bf16['loss_history'][0]:.4f}/{bf16['loss_history'][-1]:.4f}; "
          f"accuracy {bf16['accuracy']:.2f}% (f32 {f32['accuracy']:.2f}%); "
          f"checkpoint float32", flush=True)

    m = FLAG_TRAIN_STEPS + FLAG_EVAL_STEPS
    stream = model_run(STREAM_FLAG_ARGS + margs,
                       os.path.join(tmp, f"{name}_s.pt"))
    check(stream["data_path"] == "streaming" and
          stream["launches"] == _launches(m) and
          len(stream["loss_history"]) == FLAG_TRAIN_STEPS,
          f"{name} streaming: {stream['data_path']}, launches "
          f"{stream['launches']}")
    composed = model_run(FLAG_ARGS + STRATEGY_FLAGS + margs,
                         os.path.join(tmp, f"{name}_c.pt"))
    steps = FLAG_TRAIN_STEPS // 2
    want, formula = model_collectives(composed["state"].model, steps,
                                      FLAG_TRAIN_STEPS, sync_bn=True,
                                      zero=True, saves=1)
    check(composed["collectives"] == want and
          composed["launches"] == _launches(m) and
          len(composed["loss_history"]) == steps,
          f"{name} composed flags: collectives {composed['collectives']}, "
          f"expected {want} ({formula}); launches {composed['launches']}")
    print(f"models, {name} streaming on {FLAG_TRAIN_STEPS * 512} images "
          f"({card}): {_step_line(stream, FLAG_TRAIN_STEPS)}; launches "
          f"{stream['launches']}; host augment {stream['host_augment']}. "
          f"{' '.join(STRATEGY_FLAGS)}: {steps} optimizer steps of 2 x 512, "
          f"{_step_line(composed, steps, 1024)}; collectives "
          f"{composed['collectives']} = {formula}; launches "
          f"{composed['launches']}", flush=True)

    _, test_ds = synthetic(n_train=int(MAIN_ARGS[-1]),
                           n_test=int(MAIN_ARGS[-1]) // 4)
    serve = model_serve(name, epoch0, None, test_ds)
    serve_bf16 = model_serve(name, snap_bf16, BF16, test_ds)
    print(f"models, {name} serving ({card}): replay ms by bucket f32 "
          f"{serve['replay_ms']}, bf16 {serve_bf16['replay_ms']}; logits "
          f"bit for bit against the eager forward at every bucket; accuracy "
          f"{serve['accuracy']:.4f}% / {serve_bf16['accuracy']:.4f}% equal "
          f"to evaluate_resident's at batch {SERVE_BUCKETS[-1]} (the run's "
          f"eval at batch 512: {f32['accuracy']:.4f}%)", flush=True)

    exported = os.path.join(tmp, f"{name}_ref.pt")
    cli.export_torch(f32["state"].model, exported)
    ref = torch.load(exported, weights_only=True)
    fresh = get_model(name, device="cuda",
                      generator=torch.Generator().manual_seed(99))
    cli.load_torch_init(fresh, exported)
    live = f32["state"].model.state_dict()
    tracked = [k for k in ref if k.endswith("num_batches_tracked")]
    check(all(torch.equal(v, live[k]) for k, v in fresh.state_dict().items())
          and len(tracked) == len(dist._buffers(fresh)) // 2 and
          set(ref) - set(tracked) == set(live),
          f"{name} export round trip: weights differ, or keys "
          f"{sorted(set(ref) ^ set(live))[:6]}")
    print(f"models, {name} --export_torch/--init_from_torch: {len(ref)} keys "
          f"({len(tracked)} num_batches_tracked), every weight and buffer "
          f"back bit for bit through a strict load", flush=True)

    return {"launches_f32": sum(r["launches"]["gather_batch"] for r in (
                f32, resumed, stream, composed)) + serve["launches"],
            "launches_bf16": bf16["launches"]["gather_batch_bf16"]
            + serve_bf16["launches"],
            "f32_ms": statistics.median(f32["step_ms"]),
            "bf16_ms": statistics.median(bf16["step_ms"]),
            "f32_losses": list(f32["loss_history"]),
            "f32_state": {k: v.detach().cpu().clone() for k, v in
                          f32["state"].model.state_dict().items()},
            "f32_collectives": dict(f32["collectives"])}


def _profile_process(name: str, attempts: int = 3) -> dict:
    """``python -m ddp_tpu_torch.profile_resident --model name`` in a
    process of its own (late in this one the profiler loses the start of
    a session, ROADMAP C3): its JSON summary.  A session whose profile
    holds fewer ``gather_batch_kernel`` records than the wrapper launched
    lost records (C3) and says nothing of the step: it is said on stdout,
    with its clock leads, and run again, up to ``attempts`` processes.  The
    summary returned, and checked, is the first whole one, or the last."""
    for attempt in range(1, attempts + 1):
        r = subprocess.run(
            [sys.executable, "-m", "ddp_tpu_torch.profile_resident",
             "--model", name, "--steps", "10"], capture_output=True,
            text=True, timeout=600)
        check(r.returncode == 0, f"profile_resident --model {name} exited "
              f"with {r.returncode}: {r.stderr[-2000:]}")
        prof = json.loads(r.stdout.strip().splitlines()[-1])
        if prof["gather_batch_kernel_launches"] == \
                prof["gather_batch_launched"] or attempt == attempts:
            return prof
        print(f"models, {name} under the profiler: the profiler lost "
              f"records in session {attempt} of {attempts} "
              f"({prof['gather_batch_kernel_launches']} gather_batch_kernel "
              f"records of {prof['gather_batch_launched']} launches; clock "
              f"{prof['clock']}); running the session again", flush=True)


def models_processes(card: str) -> None:
    """In processes of their own, one after the other: each model's step
    under the profiler, for its kernels a step and one gather_batch_kernel
    a step, as many as the wrapper launched, and the device clock's lead
    over the host's (``clock_leads``).  The profiled processes run alone:
    beside other processes, and once beside each other, the profiler missed
    a ``gather_batch_kernel`` launch (ROADMAP C3).  The world-1
    ``multigpu`` against ``singlegpu`` pair in deterministic mode runs on
    the card for VGG-11 only (the DDP phase); the models' entry points are
    held on the CPU (``tests/test_torch_models_train.py``)."""
    t0 = time.time()
    results = {name: _profile_process(name) for name in MODELS}
    for name in MODELS:
        prof = results[name]
        print(f"models, {name} under the profiler ({card}): device clock "
              f"against the host's {prof['clock']}", flush=True)
        check(prof["gather_batch_launched"] == 10
              and prof["gather_batch_kernel_launches"] == 10,
              f"{name} profile: {prof['gather_batch_kernel_launches']} "
              f"gather_batch_kernel records of "
              f"{prof['gather_batch_launched']} launches in 10 steps")
        print(f"models, {name} under the profiler ({card}): "
              f"{prof['kernels_per_step']:g} CUDA kernels launched a step, "
              f"gather_batch_kernel 10 times in 10 steps", flush=True)
    print(f"models processes: {time.time() - t0:.1f} s", flush=True)


def models_drills(card: str) -> int:
    """Each model's world-2 epoch of MODEL_DRILLS on the one card over gloo,
    sync-BN and --shard_update composed (margins checked first; the two
    drills at once), each rank held against the drill's float64 epoch.
    Returns the card ranks' gather_batch launches.  The same drills on the
    CPU are not run here: ``tests/test_torch_models_train.py`` holds the
    CPU's world-2 epoch against the float64 epoch."""
    f64 = _tests_module("torch_float64")
    specs, models, counts, refs = {}, {}, {}, {}
    for name in MODELS:
        cfg = MODEL_DRILLS[name]
        train, test = synthetic(n_train=cfg["n_train"], n_test=24,
                                seed=cfg["data"])
        models[name] = get_model(name,
                                 generator=torch.Generator().manual_seed(0))
        kink, gap = drill.margins(models[name], train, batch=cfg["batch"],
                                  seed=cfg["seed"], world=2,
                                  accum=cfg["accum"])
        check(min(kink, gap) >= KINK_MARGIN, f"{name}'s world-2 drill "
              f"{cfg}: a ReLU input {kink:.3e} from the kink or a max-pool "
              f"gap {gap:.3e}")
        refs[name] = f64.float64_drill(
            models[name].state_dict(), train, batch=cfg["batch"], lr=0.05,
            seed=cfg["seed"], world=2, accum=cfg["accum"], sync_bn=True,
            model=name)
        loader = TrainLoader(train, cfg["batch"], 2)
        groups = optimizer_groups(*loader.rank_index_matrix(0), cfg["accum"])
        counts[name] = (sum(g.shape[0] for g in groups),
                        sum(g.shape[0] * g.shape[1] for g in groups),
                        -(-len(test) // 2 // cfg["batch"]))
        print(f"models, {name} drill {cfg}: nearest ReLU input {kink:.3e} "
              f"from the kink, smallest max-pool gap {gap:.3e}; steps, "
              f"micro-batches and eval batches a rank {counts[name]}",
              flush=True)
        specs[name] = drill.spec(
            name, models[name].state_dict(), train, test,
            batch=cfg["batch"], lr=0.05, seed=cfg["seed"], augment=True,
            device="cuda", backend="gloo", grad_accum=cfg["accum"],
            sync_bn=True, shard_update=True)
    runs, errors = {}, []

    def one(key):
        try:
            runs[key] = drill.run(specs[key], 2, same_device=True,
                                  timeout=300)
        except Exception as e:  # re-raised below, after every join
            errors.append(e)

    t0 = time.time()
    threads = [threading.Thread(target=one, args=(k,)) for k in specs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    launches = 0
    for name in MODELS:
        steps, micro, evals = counts[name]
        want, formula = model_collectives(models[name], steps, micro,
                                          sync_bn=True, zero=True, saves=1)
        on_card = (0.0, "", 0.0)
        for got in runs[name]:
            check(got["device"] == "cuda:0" and got["steps"] == steps and
                  got["collectives"] == want and
                  (got["train_launches"], got["eval_launches"]) ==
                  (micro, evals) and
                  bool(torch.isfinite(got["losses"]).all()),
                  f"{name} world-2 card rank {got['rank']}: {got['device']}, "
                  f"{got['steps']} steps, collectives {got['collectives']} "
                  f"(expected {want}), launches {got['train_launches']} + "
                  f"{got['eval_launches']}")
            on_card = max(on_card, f64.drill_distance(got, refs[name]))
            launches += got["train_launches"] + got["eval_launches"]
        check(on_card[0] <= PARITY_TOL, f"{name} world 2 on the card lies "
              f"{on_card[0]:.3e} from the float64 epoch (at {on_card[1]}, "
              f"max |value| {on_card[2]:.3e})")
        print(f"models, {name} world 2 on one card over gloo ({card}): "
              f"{steps} optimizer step(s), {micro} micro-batch(es) a rank, "
              f"sync-BN, sharded update; from the float64 epoch (losses, "
              f"weights, buffers, momentum; tolerance {PARITY_TOL:g}) the "
              f"card {on_card[0]:.3e} at {on_card[1]} (max |value| "
              f"{on_card[2]:.3e}); collectives a rank "
              f"{runs[name][0]['collectives']} = {formula}", flush=True)
    print(f"models drills: {time.time() - t0:.1f} s", flush=True)
    return launches


def models_phases(main: dict, main_bf16: dict, card: str) -> dict:
    """DeepNN and ResNet-18 through the port's entry points, their
    deterministic repeats and their world-2 drills.  Returns each model's
    numbers and the launches of gather_batch's two forms on these paths."""
    t0 = time.time()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in MODELS:
            out[name] = model_phase(name, main, main_bf16, card, tmp)
    models_processes(card)
    drill_launches = models_drills(card)
    out["launches_f32"] = drill_launches + sum(
        out[n]["launches_f32"] for n in MODELS)
    out["launches_bf16"] = sum(out[n]["launches_bf16"] for n in MODELS)
    print(f"models phase: {time.time() - t0:.1f} s", flush=True)
    return out


TP_DRILL = {"n_train": 2048, "n_test": 512, "batch": 512, "data": 0,
            "seed": 0, "lr": 0.05}


def tp_phase(models: dict, card: str) -> int:
    """The tensor-parallel path on the card (see the module docstring):
    the plan table, ``--mesh_shape 1,1`` against the plain DeepNN run, and
    the two-rank mesh (1, 2) over gloo on this card against the world-1
    drill, with its 2-slot checkpoint.  Returns the ``gather_batch``
    launches on this path."""
    t0 = time.time()
    plan = plan_for_model("deepnn", get_model("deepnn", device="meta"),
                          model_size=2)
    print(format_plan_table(plan), flush=True)
    launches = tp_mesh11(models, card) + tp_drill(plan, card)
    print(f"tp phase: {time.time() - t0:.1f} s", flush=True)
    return launches


def tp_mesh11(models: dict, card: str) -> int:
    """``--mesh_shape 1,1`` against the models phase's plain DeepNN run on
    the same arguments.  Returns its ``gather_batch`` launches."""
    with tempfile.TemporaryDirectory() as tmp:
        mesh11 = model_run(MAIN_ARGS + MODEL_ARGS["deepnn"] +
                           ["--mesh_shape", "1,1"],
                           os.path.join(tmp, "m11.pt"))
    plain = models["deepnn"]
    n = MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS
    check(mesh11["mesh_shape"] == [1, 1] and
          mesh11["launches"] == _launches(n) and
          mesh11["collectives"] == plain["f32_collectives"] and
          mesh11["model_axis_collectives"] == {"psum_model_fwd": 0,
                                               "psum_model_bwd": 0},
          f"--mesh_shape 1,1: mesh {mesh11['mesh_shape']}, launches "
          f"{mesh11['launches']}, collectives {mesh11['collectives']} "
          f"(plain {plain['f32_collectives']})")
    live = mesh11["state"].model.state_dict()
    d11 = max(max(abs(a - b) for a, b in zip(mesh11["loss_history"],
                                             plain["f32_losses"])),
              max(float((live[k].cpu() - v).abs().max())
                  for k, v in plain["f32_state"].items()))
    check(d11 <= PARITY_TOL, f"--mesh_shape 1,1 lies {d11:.3e} from the "
          f"plain DeepNN run")
    print(f"tp, --mesh_shape 1,1 ({card}): the data-parallel path, "
          f"{d11:.3e} from the plain DeepNN run on the same arguments "
          f"(losses and weights; cuDNN not in deterministic mode), "
          f"{_step_line(mesh11, MAIN_TRAIN_STEPS)}", flush=True)
    return mesh11["launches"]["gather_batch"]


def tp_drill(plan, card: str, device: str = "cuda",
             cfg: dict = TP_DRILL) -> int:
    """Two gloo ranks on this card at mesh (1, 2) against the world-1
    drill (or the float64 one), their model-axis all-reduces and launches,
    and their 2-slot checkpoint restored onto world 1 (``device`` "cpu"
    and a smaller ``cfg`` rehearse it on the CPU).  Returns the
    ``gather_batch`` launches."""
    train, test = synthetic(n_train=cfg["n_train"], n_test=cfg["n_test"],
                            seed=cfg["data"])
    model = get_model("deepnn", generator=torch.Generator().manual_seed(0))
    steps = cfg["n_train"] // cfg["batch"]
    evals = cfg["n_test"] // cfg["batch"]
    f64 = _tests_module("torch_float64")
    kink, gap = drill.margins(model, train, batch=cfg["batch"],
                              seed=cfg["seed"], world=1, accum=1,
                              device=device)
    with tempfile.TemporaryDirectory() as tmp:
        save = os.path.join(tmp, "tp.pt")
        common = dict(batch=cfg["batch"], lr=cfg["lr"], seed=cfg["seed"],
                      augment=True, device=device)
        launches = gather_batch.launches
        ranks = drill.run(drill.spec(
            "deepnn", model.state_dict(), train, test, backend="gloo",
            mesh_shape=(1, 2), save_path=save, ckpt_format="sharded",
            **common), 2, same_device=True, timeout=300)
        # The world-1 drill from the same start, in this process (no
        # rendezvous: world 1 without a process group).
        spec_path = os.path.join(tmp, "w1.pt")
        torch.save(drill.spec("deepnn", model.state_dict(), train, test,
                              **common), spec_path)
        threads = torch.get_num_threads()
        drill.rank_main(spec_path, tmp)
        torch.set_num_threads(threads)
        ref = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=True)
        launches = gather_batch.launches - launches
        names = [k for k, _ in model.named_parameters()]
        sd = interop.gather_state(plan, [r["state_dict"] for r in ranks])
        mom = interop.gather_state(plan, [dict(zip(names, r["momentum"]))
                                          for r in ranks])
        got = {"losses": ranks[0]["losses"], "state_dict": sd,
               "momentum": [mom[k] for k in names]}
        vs_w1 = f64.drill_distance(got, (
            ref["losses"].double().numpy(),
            {k: v.double() for k, v in ref["state_dict"].items()},
            [m.double() for m in ref["momentum"]]))
        held = "the world-1 drill"
        dist_held = vs_w1
        if min(kink, gap) < KINK_MARGIN:
            held = f"the float64 drill (computed on {device})"
            dist_held = f64.drill_distance(got, f64.float64_drill(
                model.state_dict(), train, batch=cfg["batch"],
                lr=cfg["lr"], seed=cfg["seed"], world=1, accum=1,
                sync_bn=False, model="deepnn", device=device))
        exp = expected_collectives(plan, backward=True)
        for r in ranks:
            check(r["device"].startswith(device) and r["steps"] == steps and
                  r["mesh_shape"] == [1, 2] and
                  (r["train_launches"], r["eval_launches"]) ==
                  ((steps, evals) if device == "cuda" else (0, 0)) and
                  r["collectives"]["psum_model_fwd"] ==
                  exp["psum_model_fwd"] * steps + 3 * evals and
                  r["collectives"]["psum_model_bwd"] ==
                  exp["psum_model_bwd"] * steps and
                  torch.equal(r["losses"], ranks[0]["losses"]),
                  f"tp rank {r['rank']}: {r['device']}, {r['steps']} steps, "
                  f"launches {r['train_launches']} + {r['eval_launches']}, "
                  f"collectives {r['collectives']}")
        check(dist_held[0] <= PARITY_TOL, f"mesh (1, 2) lies "
              f"{dist_held[0]:.3e} from {held} (at {dist_held[1]}); the "
              f"world-1 drill {vs_w1[0]:.3e}")
        index = ckpt_shard.read_shard_index(save)
        ck = load_checkpoint(save)
        whole = get_model("deepnn", device=device)
        momentum = [torch.zeros_like(p) for p in whole.parameters()]
        restore(ck, whole, momentum)
        check(index["n_slots"] == 2 and index["mesh_shape"] == [1, 2] and
              ck.step == steps and
              all(torch.equal(v.cpu(), sd[k])
                  for k, v in whole.state_dict().items()) and
              all(torch.equal(m.cpu(), mom[k])
                  for k, m in zip(names, momentum)),
              f"the 2-slot v2 file ({index['n_slots']} slots, mesh "
              f"{index['mesh_shape']}, step {ck.step}) does not restore "
              f"onto world 1 bit for bit equal to the gathered state")
    tp_ms = max(r["train_s"] for r in ranks) * 1e3 / steps
    print(f"tp, mesh (1, 2) over gloo on one card ({card}): DeepNN "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{steps} steps of {cfg['batch']} and {evals} eval batch; "
          f"nearest ReLU input "
          f"{kink:.3e} from the kink, smallest max-pool gap {gap:.3e}; "
          f"held to {held}: {dist_held[0]:.3e} at {dist_held[1]} (the "
          f"world-1 drill {vs_w1[0]:.3e} at {vs_w1[1]}; tolerance "
          f"{PARITY_TOL:g}); model-axis all-reduces a rank "
          f"{ranks[0]['collectives']['psum_model_fwd']} forward + "
          f"{ranks[0]['collectives']['psum_model_bwd']} backward = "
          f"{exp['psum_model_fwd']}+{exp['psum_model_bwd']} a step and 3 "
          f"an eval batch; gather_batch {steps} + {evals} a rank; the "
          f"2-slot v2 file restores onto world 1 bit for bit", flush=True)
    print(f"tp, mesh (1, 2) ({card}): {tp_ms:.1f} ms/step, the world-1 "
          f"drill {ref['train_s'] * 1e3 / steps:.1f} ms/step (gloo's host "
          f"staging of the model-axis all-reduces on one card, not "
          f"NVLink)", flush=True)
    return launches + sum(r["train_launches"] + r["eval_launches"]
                          for r in ranks)


# The pipeline phase: DeepNN at full width, batch 512, streamed, --grad_accum
# 2 on 2,048 images (2 optimizer steps of 2 micro-batches) and 1,024 test
# images (2 eval batches), in deterministic mode.
PP_DRILL = {"n_train": 2048, "n_test": 1024, "batch": 512, "accum": 2,
            "data": 0, "seed": 0, "lr": 0.05}


def pp_phase(card: str, device: str = "cuda", cfg: dict = PP_DRILL) -> int:
    """Pipeline parallelism on the card (see the module docstring): the
    stage table, mesh (1, 1, 2) as two gloo ranks on this card under 1F1B
    and, at the same time, under GPipe, beside the world-1 ``--grad_accum
    2`` drill from the same start (five processes at once, each in
    deterministic mode): losses, the whole state gathered to rank 0 and the
    eval counts bit for bit, ``gather_batch`` on stage 0 only, the
    handoffs, the measured bubble against ``(s-1)/(A+s-1)``; then the
    pipelined save resumed at (1, 1) in this process.  Returns the
    ``gather_batch`` launches on this path (``device`` "cpu" and a smaller
    ``cfg`` rehearse it on the CPU)."""
    t0 = time.time()
    plan = plan_stages("deepnn", 2, model=get_model("deepnn",
                                                     device="meta"))
    print(format_stage_table(plan, num_micro=cfg["accum"]), flush=True)
    train, test = synthetic(n_train=cfg["n_train"], n_test=cfg["n_test"],
                            seed=cfg["data"])
    model = get_model("deepnn", generator=torch.Generator().manual_seed(0))
    steps = cfg["n_train"] // (cfg["batch"] * cfg["accum"])
    micros, evals = steps * cfg["accum"], cfg["n_test"] // cfg["batch"]
    with tempfile.TemporaryDirectory() as tmp:
        save = os.path.join(tmp, "pp.pt")
        common = dict(batch=cfg["batch"], lr=cfg["lr"], seed=cfg["seed"],
                      augment=True, device=device, streaming=True,
                      grad_accum=cfg["accum"], deterministic=True)

        def pair(schedule, **kw):
            return drill.run(drill.spec(
                "deepnn", model.state_dict(), train, test, backend="gloo",
                mesh_shape=(1, 1, 2), pp_schedule=schedule, **common, **kw),
                2, same_device=True, timeout=300)

        runs = concurrently({
            "1f1b": functools.partial(pair, "1f1b", save_path=save),
            "gpipe": functools.partial(pair, "gpipe"),
            "w1": lambda: drill.run(drill.spec(
                "deepnn", model.state_dict(), train, test, **common), 1,
                timeout=300)})
        ref = runs["w1"][0]
        names = [k for k, _ in model.named_parameters()]

        def same(r):
            return (torch.equal(r["losses"], ref["losses"])
                    and list(r["state_dict"]) == list(ref["state_dict"])
                    and all(torch.equal(v, ref["state_dict"][k])
                            for k, v in r["state_dict"].items())
                    and all(torch.equal(a, b) for a, b in
                            zip(r["momentum"], ref["momentum"]))
                    and (r["correct"], r["total"]) ==
                    (ref["correct"], ref["total"]))

        act = cfg["batch"] * 64 * 16 * 16 * 4
        for schedule in ("1f1b", "gpipe"):
            ranks = runs[schedule]
            check(same(ranks[0]), f"pp {schedule}: mesh (1, 1, 2) is not "
                  f"bit for bit the world-1 --grad_accum 2 drill (losses "
                  f"{ranks[0]['losses'].tolist()} against "
                  f"{ref['losses'].tolist()})")
            for r in ranks:
                first = r["stage_index"] == 0
                check(r["device"].startswith(device)
                      and r["backend"] == "gloo"
                      and torch.equal(r["losses"], ref["losses"])
                      and (r["train_launches"], r["eval_launches"]) ==
                      ((micros, evals) if first and device == "cuda"
                       else (0, 0))
                      and r["collectives"]["pp_handoff"] == 2 * micros
                      and r["handoff"]["bytes_sent"] == micros * act,
                      f"pp {schedule} stage {r['stage_index']}: launches "
                      f"{r['train_launches']} + {r['eval_launches']}, "
                      f"collectives {r['collectives']}, handoff "
                      f"{r['handoff']}")
        bub = [runs[s][0]["pp_bubble"] for s in ("1f1b", "gpipe")]
        check(all(b["num_micro"] == cfg["accum"] and 0 <= b[
            "bubble_measured"] < 1 for b in bub), f"pp bubbles {bub}")
        ck = load_checkpoint(save)
        check(ck.step == steps, f"pp save: step {ck.step}")
        # The pipelined file resumed at (1, 1) in this process: its state
        # restored bit for bit, then one more epoch.
        resumed = get_model("deepnn", device=device)
        loader = TrainLoader(train, cfg["batch"], 1, seed=cfg["seed"])
        trainer = Trainer(resumed, loader, device=torch.device(device),
                          lr_schedule=functools.partial(
                              triangular_lr, base_lr=cfg["lr"], num_epochs=2,
                              steps_per_epoch=steps),
                          sgd_config=SGDConfig(lr=cfg["lr"]),
                          seed=cfg["seed"], snapshot_path=save, resume=True,
                          save_every=10 ** 9, grad_accum=cfg["accum"],
                          resident=False)
        restored = all(torch.equal(v.cpu(), ref["state_dict"][k])
                       for k, v in resumed.state_dict().items()) and all(
            torch.equal(m.cpu(), ref["momentum"][i])
            for i, m in enumerate(trainer.state.momentum))
        launches = gather_batch.launches
        trainer.train(2)
        resume_launches = gather_batch.launches - launches
        check(restored and trainer.start_epoch == 1 and
              len(trainer.loss_history) == steps and
              all(math.isfinite(x) for x in trainer.loss_history) and
              resume_launches == (micros if device == "cuda" else 0),
              f"pp resume at (1, 1): restored {restored}, start epoch "
              f"{trainer.start_epoch}, losses {trainer.loss_history}, "
              f"gather_batch {resume_launches}")
    def last_ms(r):
        # The last step's device ms (CUDA events after consecutive steps;
        # the first step holds the process's warm-up; none on the CPU).
        return r["step_ms"][-1] if r["step_ms"] else math.nan

    w1_ms = last_ms(ref)
    for schedule in ("1f1b", "gpipe"):
        r0, r1 = runs[schedule]
        b = r0["pp_bubble"]
        hs = r0["handoff"]["seconds"] + r1["handoff"]["seconds"]
        print(f"pp, mesh (1, 1, 2) {schedule} over gloo on one card "
              f"({card}): DeepNN "
              f"{sum(p.numel() for p in model.parameters())} parameters, "
              f"{steps} steps of {cfg['accum']} micro-batches of "
              f"{cfg['batch']}, {evals} eval batches; bit for bit the "
              f"world-1 --grad_accum {cfg['accum']} drill (losses, the "
              f"whole state gathered to rank 0, eval counts); the last "
              f"step {max(last_ms(r0), last_ms(r1)):.1f} ms (stage 0 "
              f"{last_ms(r0):.1f}, stage 1 {last_ms(r1):.1f}; CUDA events) "
              f"against the world-1 "
              f"drill's {w1_ms:.1f}; bubble "
              f"measured {b['bubble_measured']:.3f} against predicted "
              f"{b['bubble_predicted']:.3f} (makespan "
              f"{b['makespan_s'] * 1e3:.1f} ms, the second step under CUDA "
              f"events), peak in-flight graphs "
              f"{b['peak_inflight_acts']}; handoffs "
              f"{r0['collectives']['pp_handoff']} a rank, "
              f"{r0['handoff']['bytes_sent']} bytes each way, "
              f"{hs * 1e3:.1f} ms of host time in the calls over both "
              f"ranks (staged through pinned host buffers: gloo on one "
              f"card); gather_batch {r0['train_launches']} + "
              f"{r0['eval_launches']} on stage 0, 0 on stage 1", flush=True)
    print(f"pp: the pipelined save (step {steps}) resumed at (1, 1) in "
          f"this process bit for bit, one more epoch, {resume_launches} "
          f"gather_batch launches; pp phase: {time.time() - t0:.1f} s",
          flush=True)
    return (sum(r["train_launches"] + r["eval_launches"]
                for s in ("1f1b", "gpipe", "w1") for r in runs[s])
            + resume_launches)


BENCH_RUNS = (("vgg", ["--steps", "10", "--repeats", "3", "--warmup", "5"]),
              ("deepnn", ["--steps", "10", "--repeats", "3", "--warmup",
                          "5"]),
              ("resnet18", ["--steps", "10", "--repeats", "3", "--warmup",
                            "5"]),
              ("vgg", ["--e2e", "--resident", "--e2e_steps", "8"]))
# The bench's fixed batch, the streamed step of a live record (CUDA events)
# and the main path's resident step run the same device-bound VGG-11 work
# (2.7% idle, PERF.md section 5; within 0.7% of each other, section 6): the
# bench's median window and each live record's median against the main
# path's event median.
MAIN_MEDIAN_TOL = 0.03
MFU_MAX = 1.05


def run_bench(args: list) -> dict:
    """``python -m ddp_tpu_torch.bench args`` in a process of its own (no
    cuDNN or allocator state of this one): its ``--result_json`` summary,
    whose first record must be the one stdout line."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.json")
        r = subprocess.run(
            [sys.executable, "-m", "ddp_tpu_torch.bench", *args,
             "--result_json", path], capture_output=True, text=True,
            timeout=600)
        check(r.returncode == 0, f"bench {' '.join(args)} exited with "
              f"{r.returncode}: {r.stderr[-2000:]}")
        lines = r.stdout.strip().splitlines()
        check(len(lines) == 1, f"bench {' '.join(args)} printed "
              f"{len(lines)} stdout lines, not 1")
        with open(path) as f:
            summary = json.load(f)
    check(json.loads(lines[0]) == summary["records"][0],
          "the bench's stdout line is not its first record")
    print(f"bench {' '.join(args)}: process {time.time() - t0:.1f} s",
          flush=True)
    return summary


def bench_in_process(args: list) -> dict:
    """``ddp_tpu_torch.bench``'s main with ``args`` in this process (no
    process start-up): its summary, whose first record must be the one line
    it printed on stdout (taken here, not printed)."""
    from ddp_tpu_torch import bench as bench_mod
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = bench_mod.main(args)
    lines = buf.getvalue().strip().splitlines()
    check(len(lines) == 1 and json.loads(lines[0]) == summary["records"][0],
          f"bench {' '.join(args)} in process printed {len(lines)} stdout "
          f"lines, not its first record alone")
    print(f"bench {' '.join(args)}: in process {time.time() - t0:.1f} s",
          flush=True)
    return summary


def check_bench_record(rec: dict, fields: tuple) -> None:
    what = rec.get("metric")
    check(tuple(rec) == fields, f"bench record {what}: fields {list(rec)}")
    check(math.isfinite(rec["value"]) and rec["value"] > 0,
          f"bench record {what}: value {rec['value']}")
    check(rec["mfu_peak_source"] == "datasheet"
          and 0 < rec["mfu"] <= MFU_MAX,
          f"bench record {what}: mfu {rec['mfu']} against a "
          f"{rec['mfu_peak_source']} peak")
    check(rec["power_limit_w"] is not None and rec["power_limit_w"] > 0,
          f"bench record {what}: power limit {rec['power_limit_w']}")
    check(rec["device"] == {"name": torch.cuda.get_device_name(0),
                            "count": 1},
          f"bench record {what}: device {rec['device']}")


def bench_phase(main_ms: float, card: str) -> dict:
    """``python -m ddp_tpu_torch.bench`` for VGG-11, DeepNN and ResNet-18
    at 20 steps by 3 windows (fixed batch, resident epoch, bf16), and
    VGG-11's ``--e2e --resident``, one process each (VGG-11's first and
    alone, the other three at once, so their records share the card):
    every record's fields, value, MFU, card and power limit; one
    ``gather_batch`` launch a train step, by form; VGG's float32 median
    within ``MAIN_MEDIAN_TOL`` of the main path's.  Returns the launches of
    each form."""
    from ddp_tpu_torch.bench import E2E_FIELDS, RECORD_FIELDS
    t0 = time.time()
    launches = {"float32": 0, "bfloat16": 0}
    # VGG-11's fixed batch alone (its median is held to the main path's);
    # the other three processes at once, their records contended.
    first, *rest = BENCH_RUNS
    summaries = [run_bench(["--model", first[0], *first[1]])]
    summaries += concurrently({
        i: functools.partial(run_bench, ["--model", model, *extra])
        for i, (model, extra) in enumerate(rest)}).values()
    for (model, extra), summary in zip(BENCH_RUNS, summaries):
        e2e = "--e2e" in extra
        recs = summary["records"]
        check(len(recs) == (1 if e2e else 3), f"bench {model} {extra}: "
              f"{len(recs)} records")
        for rec in recs:
            check_bench_record(rec, E2E_FIELDS if e2e else RECORD_FIELDS)
            print(f"bench record ({card}): {json.dumps(rec)}", flush=True)
        steps, moved = summary["steps"], summary["launches"]
        check(moved == {"gather_batch": steps["float32"] + steps["bfloat16"],
                        "gather_batch_bf16": steps["bfloat16"]},
              f"bench {model} {extra}: launches {moved} for train steps "
              f"{steps}")
        launches["float32"] += moved["gather_batch"] - \
            moved["gather_batch_bf16"]
        launches["bfloat16"] += moved["gather_batch_bf16"]
        if model == "vgg" and not e2e:
            ms = recs[0]["median_ms_per_step"]
            check(abs(ms - main_ms) <= MAIN_MEDIAN_TOL * main_ms,
                  f"bench VGG f32 median {ms:.3f} ms/step against the main "
                  f"path's {main_ms:.3f}")
            print(f"bench VGG f32 median {ms:.3f} ms/step against the main "
                  f"path's event median {main_ms:.3f} ({card})", flush=True)
    print(f"bench phase: {time.time() - t0:.1f} s, gather_batch launches "
          f"{launches}", flush=True)
    return launches


# The bench's modes that need no mesh (bench_modes_phase): VGG-11, one
# command after the other, a process each but the last two (in process).
# Windows of 50 steps, JAX's default: each K=50 window holds one audit.
GUARD_RUN = ["--guard_overhead", "--steps", "50", "--repeats", "2"]
SERVE_RUN = ["--serve", "--serve_buckets", "1,8,32,128", "--serve_secs",
             "1"]
# One cell: the bench phase's bf16 record is the step at 512.
BATCH_SWEEP_RUN = ["--batch_sweep", "1024", "--batch_sweep_flavors",
                   "bf16_step", "--steps", "10", "--repeats", "2"]
STREAM_ATTR_RUN = ["--stream_attr", "--e2e_steps", "8", "--repeats", "2"]
GUARD_MAX_PCT = 1.0  # bench.py --guard_overhead's acceptance at K=50
# The fleet phase's in-process figures (PERF.md section 6: 8 closed-loop
# clients of 1-32 rows, H100 80GB HBM3, 700 W), printed beside the
# bench's.
B7_ROWS_PER_S = {1: "10,474.3-10,665.0", 2: "7,261.7-7,784.2"}


def _bench_mode_launches(summary: dict, what: str, launches: dict) -> None:
    """Hold a bench process's ``gather_batch`` launches to its train steps
    plus its eval-form calls, by form, and add them to ``launches``."""
    steps, calls, moved = (summary["steps"], summary["eval_calls"],
                           summary["launches"])
    want = {"gather_batch": sum(steps.values()) + sum(calls.values()),
            "gather_batch_bf16": steps["bfloat16"] + calls["bfloat16"]}
    check(moved == want, f"bench {what}: launches {moved} for train steps "
          f"{steps} and eval-form calls {calls}")
    launches["float32"] += moved["gather_batch"] - moved["gather_batch_bf16"]
    launches["bfloat16"] += moved["gather_batch_bf16"]


def _mode_record(summary: dict, what: str, fields: set) -> dict:
    rec, = summary["records"]
    check(set(rec) == fields, f"bench {what}: fields {sorted(rec)}")
    check(math.isfinite(rec["value"]) and rec["value"] > 0,
          f"bench {what}: value {rec['value']}")
    check(rec["power_limit_w"] is not None and rec["power_limit_w"] > 0
          and rec["device"] == {"name": torch.cuda.get_device_name(0),
                                "count": 1},
          f"bench {what}: device {rec['device']}, power limit "
          f"{rec['power_limit_w']}")
    return rec


def bench_modes_phase(card: str) -> dict:
    """``python -m ddp_tpu_torch.bench``'s modes that need no mesh on
    VGG-11, one after the other: ``--guard_overhead``, ``--serve --fleet
    2`` and ``--batch_sweep`` each a process of its own, ``--stream_attr``
    and ``--pipeline`` the bench's main in this process (see the module's
    docstring).  Returns the launches of each form."""
    t0 = time.time()
    launches = {"float32": 0, "bfloat16": 0}
    port = {"device", "power_limit_w"}

    summary = run_bench(["--model", "vgg", *GUARD_RUN])
    _bench_mode_launches(summary, "--guard_overhead", launches)
    rec = _mode_record(summary, "--guard_overhead", {
        "metric", "value", "unit", "vs_baseline", "guard_overhead",
        "audit_call_ms", "derived_audit_overhead_pct",
        "audit_payload_bytes", "audit_n_leaves"} | port)
    k50 = rec["derived_audit_overhead_pct"]["k50"]
    check(k50 < GUARD_MAX_PCT, f"--guard_overhead: the K=50 audit costs "
          f"{k50}% a step, acceptance < {GUARD_MAX_PCT}%")
    per = rec["guard_overhead"]
    print(f"bench --guard_overhead ({card}): audit call "
          f"{rec['audit_call_ms']} ms, derived overhead K=50 {k50}%, K=10 "
          f"{rec['derived_audit_overhead_pct']['k10']}%; median ms/step "
          + ", ".join(f"{k} {v['median_ms_per_step']}"
                      + (f" ({v['overhead_pct_vs_off']:+}%)"
                         if "overhead_pct_vs_off" in v else "")
                      for k, v in per.items()), flush=True)

    # A fleet of 2 (the serving phase serves one engine).
    n = 2
    what = f"--serve --fleet {n}"
    summary = run_bench(["--model", "vgg", *SERVE_RUN, "--fleet", str(n)])
    _bench_mode_launches(summary, what, launches)
    check(summary["eval_calls"]["float32"] == 2 * 4 * n,
          f"bench {what}: eval-form calls {summary['eval_calls']}")
    rec = _mode_record(summary, what, {
        "metric", "value", "unit", "vs_baseline", "serve"} | port)
    serve = rec["serve"]
    timed_out = serve["closed_loop"]["timed_out"] + sum(
        p["timed_out"] for p in serve["open_loop"])
    check(serve["compiled_executables"] == 4 * n and timed_out == 0
          and serve["router"] is not None,
          f"bench {what}: {serve['compiled_executables']} graphs, "
          f"{timed_out} timed out, router {serve['router']}")
    knee = next((p for p in serve["open_loop"]
                 if p["offered_rps"] == serve["knee_offered_rps"]),
                serve["open_loop"][-1])
    closed = serve["closed_loop"]
    print(f"bench {what} ({card}): {rec['value']} {rec['unit']}; at "
          f"that point p50/p99 {knee['latency_ms']['p50']}/"
          f"{knee['latency_ms']['p99']} ms, shed {knee['shed']}; closed "
          f"loop ({closed['clients']} clients of 1 row) "
          f"{closed['throughput_rps']} rows/s, p99 "
          f"{closed['latency_ms']['p99']} ms; r0's batcher "
          f"{serve['batcher']['mean_batch_rows']} rows a batch, "
          f"{serve['batcher']['batches']} batches; router routed "
          f"{serve['router']['routed']}, served "
          f"{[r['served'] for r in serve['router']['per_replica']]}; the "
          f"fleet phase in process (8 clients of 1-32 rows, PERF.md): "
          f"{B7_ROWS_PER_S[n]} rows/s", flush=True)

    summary = run_bench(["--model", "vgg", *BATCH_SWEEP_RUN])
    _bench_mode_launches(summary, "--batch_sweep", launches)
    check(summary["steps"]["bfloat16"] == 10 + 2 * 10,
          f"bench --batch_sweep: steps {summary['steps']}")
    rec = _mode_record(summary, "--batch_sweep", {
        "metric", "value", "unit", "vs_baseline", "batch_sweep"} | port)
    cells = {b: c["bf16_step"] for b, c in rec["batch_sweep"].items()}
    check(set(cells) == {"1024"} and all(
        0 < c["mfu"] <= MFU_MAX for c in cells.values()),
          f"bench --batch_sweep: cells {cells}")
    print(f"bench --batch_sweep ({card}): " + ", ".join(
        f"batch {b} bf16 {c['samples_per_sec_per_chip']} samples/s, "
        f"{c['median_ms_per_step']} ms/step, MFU {c['mfu']}"
        for b, c in cells.items()) + f"; headline {rec['value']} "
        f"{rec['unit']}", flush=True)

    summary = bench_in_process(["--model", "vgg", *STREAM_ATTR_RUN])
    _bench_mode_launches(summary, "--stream_attr", launches)
    rec = _mode_record(summary, "--stream_attr", {
        "metric", "value", "unit", "vs_baseline", "attribution_ms_per_step",
        "phase_ms", "prefetch", "window_epoch_s"} | port)
    attr = rec["attribution_ms_per_step"]
    stages = ("host_augment_ms", "h2d_ms", "device_step_ms")
    check(set(attr) == set(stages) | {
        "streaming_wall_ms", "bottleneck", "pipeline_floor_ms",
        "dispatch_gap_ms", "overlap_efficiency"}
          and attr["bottleneck"] in stages
          and 0 < attr["overlap_efficiency"] <= 1
          and set(rec["phase_ms"]) == {"data_wait", "dispatch", "h2d",
                                       "host_augment", "loss_flush"}
          and rec["prefetch"]["batches"] == 8 * 2,
          f"bench --stream_attr: {json.dumps(rec)}")
    print(f"bench --stream_attr ({card}): {json.dumps(attr)}, phase_ms "
          f"{json.dumps(rec['phase_ms'])}, prefetch "
          f"{json.dumps(rec['prefetch'])}", flush=True)

    summary = bench_in_process(["--pipeline"])
    rec = _mode_record(summary, "--pipeline", {
        "metric", "value", "unit", "vs_baseline"} | port)
    check(summary["launches"] == {"gather_batch": 0, "gather_batch_bf16": 0},
          f"bench --pipeline launched {summary['launches']}")
    print(f"bench --pipeline ({card}): {rec['value']} {rec['unit']}",
          flush=True)
    print(f"bench-modes phase: {time.time() - t0:.1f} s, gather_batch "
          f"launches {launches}", flush=True)
    return launches


def runshape_phase(main_ms: float, card: str) -> int:
    """The run-shape flags on 10,240 images: in deterministic mode
    (``repeat_check``'s), ``1 1 --schedule_epochs 2`` then ``2 1 --resume
    --schedule_epochs 2`` against an uninterrupted ``2 1`` (run beside
    them), the histories bit for bit; then a streamed ``2 1
    --metrics_path --log_every 5`` run in this process, its counts zeroed
    before and read after: each step's lr the schedule's; each live
    record's median step the median of its window of the run's own event
    times, within ``MAIN_MEDIAN_TOL`` of the main path's event median, and its
    MFU in (0, ``MFU_MAX``].  Returns the launches of this path."""
    t0 = time.time()
    args = FLAG_ARGS[2:]
    steps, evals = FLAG_TRAIN_STEPS, FLAG_EVAL_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        whole, errors = [], []

        def uninterrupted():
            try:
                whole.extend(run_entries(["singlegpu"], ["2", "1", *args],
                                         deterministic=True))
            except Exception as e:  # re-raised below, after the join
                errors.append(e)

        thread = threading.Thread(target=uninterrupted)
        thread.start()
        try:
            split = os.path.join(tmp, "split.pt")
            first, = run_entries(
                ["singlegpu"], ["1", "1", *args, "--schedule_epochs", "2"],
                deterministic=True, snapshot_path=split)
            second, = run_entries(
                ["singlegpu"], ["2", "1", *args, "--schedule_epochs", "2",
                                "--resume"],
                deterministic=True, snapshot_path=split)
        finally:
            thread.join()
        if errors:
            raise errors[0]
        whole, = whole
        runs = (first, second, whole)
        for res, n in zip(runs, (steps, steps, 2 * steps)):
            got = res["kernel_launches"]["gather_batch"]
            check(len(res["loss_history"]) == n and got == n + evals,
                  f"run shape: {len(res['loss_history'])} steps and {got} "
                  f"gather_batch launches, expected {n} and {n + evals}")
        pair, = compare([whole, {**second, "loss_history":
                                 first["loss_history"]
                                 + second["loss_history"]}])
        print(f"run shape, split run (1 1 --schedule_epochs 2, then 2 1 "
              f"--resume) against 2 1, deterministic mode ({card}): "
              f"{pair}", flush=True)
        check(pair["bit_equal"] and second["accuracy"] == whole["accuracy"],
              "the split run's history differs from the uninterrupted "
              "run's")

        metrics = os.path.join(tmp, "metrics.jsonl")
        argv = ["2", "1", *[a for a in args if a != "--resident"],
                "--metrics_path", metrics, "--log_every", "5",
                "--snapshot_path", os.path.join(tmp, "stream.pt")]
        gather_batch.launches = gather_batch.launches_bf16 = 0
        out = cli.main(argv)
        launches = gather_batch.launches
        check(launches == 2 * steps + evals, f"run shape: the streamed "
              f"metrics run launched gather_batch {launches} times")
        with open(metrics) as f:
            recs = [json.loads(line) for line in f]
    schedule = cli.build_schedule(
        cli.build_parser("").parse_args(argv),
        TrainLoader(synthetic(n_train=10240, n_test=1)[0], 512))
    lrs = [r["lr"] for r in recs if "loss" in r]
    check(lrs == [round(schedule(s), 8) for s in range(2 * steps)],
          "run shape: the metrics stream's lrs are not the schedule's")
    check([r["loss"] for r in recs if "loss" in r]
          == [round(x, 6) for x in out["loss_history"]],
          "run shape: the metrics stream's losses are not the run's")
    lives = [r for r in recs if r.get("event") == "live"]
    check([r["step"] for r in lives] == list(range(4, 2 * steps, 5)),
          f"run shape: live records at steps {[r['step'] for r in lives]}")
    window = 100  # max(100, --log_every)
    for r in lives:
        own = statistics.median(
            out["step_ms"][max(r["step"] + 1 - window, 0):r["step"] + 1])
        ms = r["step_ms_median"]
        check(abs(ms - own) <= 1e-3
              and abs(ms - main_ms) <= MAIN_MEDIAN_TOL * main_ms
              and 0 < r["mfu"] <= MFU_MAX and r["compute_dtype"] == "float32",
              f"run shape: live record {r} against the run's event median "
              f"{own:.3f} ms and the main path's {main_ms:.3f}")
    check(recs[-1].get("final") and recs[-1]["eval_accuracy"]
          == round(out["accuracy"], 4), f"run shape: last record {recs[-1]}")
    summary = [(r["step"], r["step_ms_median"], r["step_ms_p90"], r["mfu"],
                r["prefetch_occupancy"]) for r in lives]
    print(f"run shape, streamed --metrics_path --log_every 5 ({card}): "
          f"{len(lrs)} step records with the schedule's lrs, live records "
          f"(step, median ms, p90 ms, mfu, occupancy) {summary}", flush=True)
    print(f"run-shape phase: {time.time() - t0:.1f} s", flush=True)
    return sum(r["kernel_launches"]["gather_batch"] for r in runs) + launches


# The transformer workload (generate_phase, A12): the byte LM ``tinylm``
# trained by ``python -m ddp_tpu_torch.train.lm``'s main in this process
# (30 f32 steps of 16 sequences of 32 tokens), then served from its file.
# The card's losses against the CPU port's from the same seed: f32 with
# TF32 off, cuBLAS and the CPU sum in other orders, and 30 momentum steps
# carry those last bits; 1e-3 relative leaves two orders above the ~1e-5
# that gives.  Cached decode against the full-sequence forward of the
# history on the card: the same f32 math over other shapes, 1e-4 absolute
# (measured ~1e-6 on the CPU), and the same greedy token.  A bfloat16
# stream within 2^-5 of max |logit| of the bfloat16 full forward.  The
# encoder served through ServeEngine against its eager forward bit for bit
# (the same kernels on the same shapes) and against the CPU forward at
# 1e-4 of max |logit|.
GEN_TRAIN = ["--steps", "30", "--batch", "16", "--seq_len", "32"]
GEN_LOSS_RTOL = 1e-3
GEN_DECODE_ATOL = 1e-4
GEN_BUCKETS = (16, 64)
# One prompt for each bucket; each decoded GEN_DECODE_STEPS steps.
GEN_PROMPTS = ([5, 250, 17, 3, 99], [(7 * i + 1) % 256 for i in range(40)])
GEN_DECODE_STEPS = 24
GEN_STREAMS, GEN_NEW = 8, 16
GEN_BENCH = ["--serve", "--generate", "--gen_streams", "1,8",
             "--serve_secs", "2", "--gen_new_tokens", str(GEN_NEW)]
ENCODER_BUCKETS = (1, 8, 32)


def _gen_alone(eng, prompt: list, n: int) -> list:
    """One greedy stream of ``n`` tokens on ``eng`` alone."""
    slot, tok = eng.start_stream(prompt)
    got = [tok]
    while len(got) < n:
        got.append(eng.decode({slot: got[-1]})[slot])
    eng.release(slot)
    return got


def _post_generate(base: str, body: dict) -> dict:
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def _encoder_path(card: str) -> dict:
    """The CIFAR encoder served through ServeEngine: every serving batch
    goes through gather_batch's eval form.  Its wrapper's count is set to
    0 before warm() and read after the forwards (the eager warm-up runs;
    replays launch the kernel uncounted); then five forwards a bucket
    under torch.profiler (``profiled_forwards``, as the serving and fleet
    phases count theirs) must each replay one ``gather_batch_kernel`` and
    leave the wrapper's count as it was.  The path's launches are the
    eager runs plus the profiled replays'.  The kernel is then held against
    its plain version at each bucket's shape, and the served logits
    against the eager forward and the CPU's."""
    gather_batch.launches = gather_batch.launches_bf16 = 0
    gather_rows.launches = conv3x3_fused.launches = 0
    model = get_model("transformer",
                      generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    engine = ServeEngine(model, buckets=ENCODER_BUCKETS)
    captured = engine.warm()
    rng = np.random.default_rng(11)
    batches = {b: rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
               for b in engine.buckets}
    served = {b: engine.forward(x) for b, x in batches.items()}
    torch.cuda.synchronize()
    wrapper = gather_batch.launches
    check(captured == len(ENCODER_BUCKETS) and
          wrapper == 2 * len(ENCODER_BUCKETS) and
          gather_rows.launches == conv3x3_fused.launches == 0,
          f"encoder serving: {captured} graphs, gather_batch's wrapper "
          f"{wrapper} times (expected one eager run and one capture a "
          f"bucket), row_gather {gather_rows.launches}, conv3x3 "
          f"{conv3x3_fused.launches}")
    eager_runs = wrapper - captured
    replays = {}
    for b, x in batches.items():
        seen, replayed, _ = profiled_forwards(engine, x,
                                              f"encoder bucket {b}")
        replays[b] = seen["gather_batch_kernel"]
        check(replayed == seen["forwards"] == replays[b] == 5
              and not seen["short_forwards"]
              and gather_batch.launches == wrapper,
              f"encoder bucket {b}: {replays[b]} gather_batch_kernel "
              f"launches in {replayed} replays under the profiler (expected "
              f"one each), the wrapper {gather_batch.launches} times "
              f"(profile {seen})")
    launches = eager_runs + sum(replays.values())
    apply_fn = make_eval_apply(engine.model)
    max_err, max_cpu = 0.0, 0.0
    for b, x in batches.items():
        table = torch.from_numpy(x).cuda()
        zeros = torch.zeros(b, dtype=torch.int64, device="cuda")
        rows = torch.arange(b, dtype=torch.int32, device="cuda")
        images, _ = gather_batch(table, zeros, rows)
        want_images, _ = gather_batch_plain(table, zeros, rows)
        check(torch.equal(images, want_images),
              f"gather_batch's eval form differs from its plain version at "
              f"the encoder's bucket {b}")
        max_err = max(max_err, float((images - want_images).abs().max()))
        want = apply_fn(images).cpu().numpy()
        check(np.array_equal(served[b], want),
              f"the encoder's served logits at bucket {b} differ from its "
              f"eager forward")
        cpu = make_eval_apply(cpu_model)(torch.from_numpy(x)).numpy()
        err = float(np.abs(served[b] - cpu).max())
        max_cpu = max(max_cpu, err / max(float(np.abs(cpu).max()), 1e-30))
        check(err <= 1e-4 * float(np.abs(cpu).max()),
              f"the encoder's served logits at bucket {b} lie {err:.3e} "
              f"from the CPU's")
    print(f"generate G8 ({card}): the transformer encoder served through "
          f"ServeEngine at buckets {list(engine.buckets)}: {captured} "
          f"graphs, gather_batch launched {launches} times on its path "
          f"({eager_runs} eager warm-up runs by its wrapper, "
          f"{json.dumps(replays)} in 5 profiled replays a bucket by the "
          f"profiler), "
          f"served logits bit for bit the eager forward, {max_cpu:.3e} of "
          f"max|logit| from the CPU's, the kernel bit for bit its plain "
          f"version", flush=True)
    return {"launches": launches, "max_abs_err": max_err,
            "cpu_share": max_cpu, "replays_profiled": replays}


def generate_phase(card: str, tmp: str) -> dict:
    """The transformer workload on the card, in this process: G1
    ``python -m ddp_tpu_torch.train.lm``'s main (the losses descending and
    within GEN_LOSS_RTOL of the CPU port's); G2 the KV-cache engine from
    that file (graphs captured equal to the compile bound, decode equal to
    ``lm_forward`` at every step in both prompt buckets, replay times);
    G3 GEN_STREAMS concurrent streams through the token batcher, each
    token for token the stream run alone; G4 a 2-replica generative fleet
    behind the HTTP server with two sticky sessions; G5 the serve-chaos
    drill; G6 ``bench --serve --generate`` at 1 and 8 streams; G7 a
    bfloat16 stream; G8 the encoder through ServeEngine and
    ``gather_batch``.  Returns the encoder path's launches and the
    numbers PERF.md keeps."""
    from ddp_tpu_torch import serve_chaos
    from ddp_tpu_torch.serve import KVCacheEngine, TokenBatcher
    from ddp_tpu_torch.train import lm
    t_phase = time.time()
    gather_batch.launches = gather_batch.launches_bf16 = 0
    check(not dist.in_rendezvous(), "the smoke is inside a rendezvous")
    ck = os.path.join(tmp, "lm", "ck.npz")
    res = os.path.join(tmp, "lm.json")
    t0 = time.time()
    check(lm.main(GEN_TRAIN + ["--snapshot_path", ck, "--result_json",
                               res]) == 0, "train.lm did not exit 0")
    train_s = time.time() - t0
    with open(res) as f:
        run = json.load(f)
    losses = run["losses"]
    _, cpu_losses = lm.train_lm(steps=30, batch=16, seq_len=32,
                                device="cpu", quiet=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    check(len(losses) == 30 and all(math.isfinite(x) for x in losses) and
          run["device"].startswith("cuda") and run["world"] == 1,
          f"train.lm: {run}")
    check(losses[-1] < losses[0] and
          statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
          f"train.lm's losses do not descend: {losses}")
    check(rel <= GEN_LOSS_RTOL, f"train.lm's losses lie {rel:.3e} "
          f"(relative) from the CPU port's")
    check(gather_batch.launches == 0, "the LM path launched gather_batch")
    print(f"generate G1 ({card}): python -m ddp_tpu_torch.train.lm "
          f"{' '.join(GEN_TRAIN)}: {run['seconds']:.3f} s of steps, "
          f"{train_s:.2f} s with the save, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {rel:.3e} of the CPU port's at most",
          flush=True)

    eng = KVCacheEngine.from_checkpoint(ck, "tinylm", slots=GEN_STREAMS,
                                        prompt_buckets=GEN_BUCKETS)
    t0 = time.time()
    captured = eng.warm()
    warm_s = time.time() - t0
    check(captured == eng.trace_count == eng.compile_bound ==
          2 * len(GEN_BUCKETS) + 1 and
          eng.stats()["compiled_executables"] == captured,
          f"the KV engine captured {captured} graphs, bound "
          f"{eng.compile_bound}")
    model = eng.model
    k, v = eng.cache_buffers()
    ptrs = (k.data_ptr(), v.data_ptr())
    decode_err = 0.0
    for prompt in GEN_PROMPTS:
        slot, tok = eng.start_stream(prompt)
        hist = list(prompt)
        with torch.no_grad():
            first = model.lm_forward(torch.tensor([hist], device="cuda"))
        check(tok == int(np.argmax(first[0, -1].cpu().numpy())),
              f"the prefill's token differs from lm_forward's "
              f"(prompt of {len(prompt)})")
        for step in range(GEN_DECODE_STEPS):
            hist.append(tok)
            got = eng.decode_logits({slot: tok})[slot]
            with torch.no_grad():
                want = model.lm_forward(torch.tensor(
                    [hist], device="cuda"))[0, -1].cpu().numpy()
            err = float(np.abs(got - want).max())
            decode_err = max(decode_err, err)
            check(err <= GEN_DECODE_ATOL and
                  int(np.argmax(got)) == int(np.argmax(want)),
                  f"decode step {step} (prompt of {len(prompt)}) lies "
                  f"{err:.3e} from lm_forward")
            tok = int(np.argmax(got))
        eng.release(slot)
    check((k.data_ptr(), v.data_ptr()) == ptrs,
          "the KV cache was reallocated")
    replay_ms = {"decode": median_ms(lambda _: eng._decode.graph.replay(),
                                     [None], 30)}
    for b in GEN_BUCKETS:
        replay_ms[f"prefill{b}"] = median_ms(
            lambda _, p=eng._prefill[b]: p.graph.replay(), [None], 30)
    live = {s: 1 for s in range(GEN_STREAMS)}
    for s in live:
        eng.start_stream([s + 1])
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        eng.decode(live)
        host.append((time.perf_counter() - t0) * 1e3)
    for s in live:
        eng.release(s)
    print(f"generate G2 ({card}): KVCacheEngine from {ck}: {captured} "
          f"CUDA graphs (bound {eng.compile_bound}) in {warm_s:.3f} s; "
          f"{GEN_DECODE_STEPS} decode steps a prompt in buckets "
          f"{list(GEN_BUCKETS)}, max|decode - lm_forward| {decode_err:.3e}; "
          f"replay ms {json.dumps(replay_ms)}; decode() host ms at "
          f"{GEN_STREAMS} live slots median "
          f"{statistics.median(host):.3f}; the cache written in place",
          flush=True)

    prompts = [[(13 * i + j) % 256 for j in range(3 + i)]
               for i in range(GEN_STREAMS)]
    refs = [_gen_alone(eng, p, GEN_NEW) for p in prompts]
    batcher = TokenBatcher(eng, max_new_tokens=GEN_NEW).start()
    try:
        got = concurrently({i: functools.partial(batcher.generate, p,
                                                 timeout=60)
                            for i, p in enumerate(prompts)})
        bstats = batcher.stats()
    finally:
        check(batcher.drain(timeout=30), "the token batcher did not drain")
    check([got[i]["tokens"] for i in range(GEN_STREAMS)] == refs,
          "concurrent streams differ from the streams run alone")
    check(bstats["completed_streams"] == GEN_STREAMS and
          bstats["tokens_generated"] == GEN_STREAMS * GEN_NEW,
          f"token batcher stats {bstats}")
    ttft = [got[i]["ttft_ms"] for i in range(GEN_STREAMS)]
    print(f"generate G3 ({card}): {GEN_STREAMS} concurrent streams of "
          f"{GEN_NEW} tokens through TokenBatcher, each token for token "
          f"the stream alone; TTFT ms p50 {statistics.median(ttft):.3f} "
          f"max {max(ttft):.3f}", flush=True)

    fleet = ServeFleet(ck, "tinylm", n_replicas=2, generate=True, slots=4,
                       prompt_buckets=GEN_BUCKETS, max_new_tokens=6)
    fleet.start(poll_s=0)
    httpd = ServeHTTPServer(("127.0.0.1", 0), fleet=fleet)
    listener = threading.Thread(target=httpd.serve_forever, daemon=True)
    listener.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        hist = {"a": list(GEN_PROMPTS[0]), "b": [42, 43]}
        for _ in range(2):
            for sid, h in hist.items():
                out = _post_generate(base, {"prompt": h, "session": sid})
                check(out["tokens"] == _gen_alone(eng, h, 6),
                      f"session {sid}: the fleet's tokens differ from the "
                      f"engine's")
                h.extend(out["tokens"])
        router = fleet.router.stats()
        pins = {sid: fleet.router.session_replica(sid) for sid in hist}
        check(router["session_migrations"] == 0 and
              all(p is not None for p in pins.values()),
              f"sticky sessions: pins {pins}, router {router}")
        counts = [r.stats()["engine"]["compiled_executables"]
                  for r in fleet.replicas]
        check(counts == [5, 5], f"the fleet's engines captured {counts}")
    finally:
        httpd.close()
        listener.join(timeout=10)
        fleet.close(timeout=15)
    print(f"generate G4 ({card}): serve --generate --fleet 2 over HTTP, two "
          f"sticky sessions of two turns, pins {pins}, 0 migrations, every "
          f"turn token for token the engine's", flush=True)

    t0 = time.time()
    drill_rec = serve_chaos.run_drill(ck, device="cuda")
    check(drill_rec["pass"], f"the serve-chaos drill failed: {drill_rec}")
    print(f"generate G5 ({card}): serve-chaos drill PASS in "
          f"{time.time() - t0:.1f} s: {json.dumps(drill_rec)}", flush=True)

    summary = bench_in_process(GEN_BENCH + ["--snapshot_path", ck])
    rec = summary["records"][0]
    gen = rec["generate"]
    check(gen["compiled_executables"] == gen["compile_bound"] and
          [p["streams"] for p in gen["curve"]] == [1, 8] and
          all(p["tokens_per_sec"] > 0 and p["ttft_ms"]["p99"] is not None
              for p in gen["curve"]) and rec["power_limit_w"] and
          rec["device"]["name"] == torch.cuda.get_device_name(0),
          f"bench --generate record {rec}")
    print(f"generate G6 ({card}): bench record: {json.dumps(rec)}",
          flush=True)

    eng16 = KVCacheEngine.from_checkpoint(ck, "tinylm", slots=2,
                                          prompt_buckets=GEN_BUCKETS[:1],
                                          compute_dtype=BF16)
    check(eng16.warm() == 3, "the bf16 engine's graphs")
    hist = list(GEN_PROMPTS[0])
    slot, tok = eng16.start_stream(hist)
    bf16_share = 0.0
    for _ in range(12):
        hist.append(tok)
        got = eng16.decode_logits({slot: tok})[slot]
        with torch.no_grad():
            want = eng16.model.lm_forward(
                torch.tensor([hist], device="cuda"),
                compute_dtype=BF16)[0, -1].float().cpu().numpy()
        share = float(np.abs(got - want).max() / np.abs(want).max())
        bf16_share = max(bf16_share, share)
        check(share <= 2.0 ** -5, f"bf16 decode lies {share:.3e} of "
              f"max|logit| from the bf16 forward")
        tok = int(np.argmax(got))
    print(f"generate G7 ({card}): a bf16 stream of 12 steps, decode within "
          f"{bf16_share:.3e} of max|logit| of the bf16 lm_forward",
          flush=True)

    encoder = _encoder_path(card)
    seconds = time.time() - t_phase
    print(f"generate phase: {seconds:.1f} s", flush=True)
    curve = {p["streams"]: p for p in gen["curve"]}
    return {"launches": encoder["launches"],
            "max_abs_err": encoder["max_abs_err"], "seconds": seconds,
            "tokens_per_sec": {s: p["tokens_per_sec"]
                               for s, p in curve.items()},
            "ttft_ms": {s: p["ttft_ms"] for s, p in curve.items()},
            "decode_err": decode_err, "replay_ms": replay_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    set_tf32(False)
    # Each child process (the bench, the deterministic and drill runs)
    # would otherwise compile torch's modules from source again wherever
    # PYTHONDONTWRITEBYTECODE is set or the site's packages are read-only:
    # the children share one bytecode cache, removed at exit.
    pycache = tempfile.TemporaryDirectory(prefix="chip_smoke_pycache_")
    os.environ["PYTHONPYCACHEPREFIX"] = pycache.name
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

    t_start = time.time()

    def stamp(what: str) -> None:
        # Each phase's end on the smoke's clock: what a later slice reads
        # to choose the depth it cuts.
        print(f"smoke clock: {what} done at {time.time() - t_start:.1f} s",
              flush=True)

    t0 = time.time()
    _build.build_all()
    print(f"build: {len(_build.sources())} kernel source(s) in "
          f"{time.time() - t0:.2f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    row_gather = kernel_phase(gen)
    batch, row_gather["profiler_ms"] = batch_phase(gen)
    batch_bf16 = batch_bf16_phase(gen)
    parity_phase()
    stamp("kernel, batch and parity phases")

    snapshot_dir = tempfile.TemporaryDirectory()
    snapshot = os.path.join(snapshot_dir.name, "checkpoint.pt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_batch.launches = gather_batch.launches_bf16 = 0
    gather_rows.launches = conv3x3_fused.launches = 0
    out = cli.main(MAIN_ARGS + ["--snapshot_path", snapshot])
    launches = gather_batch.launches
    check(gather_batch.launches_bf16 == 0,
          "the float32 main path launched gather_batch's bf16 form")
    row_main_launches = gather_rows.launches
    # The training path runs cuDNN's convolutions, as the JAX package's
    # runs XLA's: the conv kernel belongs to the probe path.
    conv_main_launches = conv3x3_fused.launches
    losses = out["loss_history"]
    check(len(losses) == MAIN_TRAIN_STEPS,
          f"{len(losses)} train steps, expected {MAIN_TRAIN_STEPS}")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    check(math.isfinite(out["accuracy"]) and 0 <= out["accuracy"] <= 100,
          f"accuracy {out['accuracy']}")
    check(launches == MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS,
          f"gather_batch launched {launches} times on the main path, "
          f"expected {MAIN_TRAIN_STEPS + MAIN_EVAL_STEPS}")
    check(row_main_launches == 0,
          f"row_gather launched {row_main_launches} times on the main path")
    check(conv_main_launches == 0,
          f"conv3x3 launched {conv_main_launches} times on the main path")
    step_ms = statistics.median(out["step_ms"])
    print(f"main path ({card}): median {step_ms:.3f} ms/step, "
          f"{512 / step_ms * 1e3:.1f} samples/s, train "
          f"{out['training_seconds']:.2f} s, eval "
          f"{out['eval_seconds']:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"gather_batch launches {launches}, row_gather launches "
          f"{row_main_launches}, first/last loss "
          f"{losses[0]:.4f}/{losses[-1]:.4f}, accuracy "
          f"{out['accuracy']:.2f}%, conv3x3 launches {conv_main_launches}",
          flush=True)
    stamp("main path")
    sync_write_s = checkpoint_phase(out, snapshot)
    snapshot_bf16 = os.path.join(snapshot_dir.name, "checkpoint_bf16.pt")
    out_bf16 = bf16_main_phase(out, card, snapshot_bf16)
    stamp("checkpoint and bf16 main path")
    bench = bench_phase(step_ms, card)
    stamp("bench phase")
    bench_modes = bench_modes_phase(card)
    stamp("bench-modes phase")
    runshape_launches = runshape_phase(step_ms, card)
    stamp("run-shape phase")
    ddp_launches, ddp = ddp_phase(out, card)
    stamp("DDP phase")
    strategy_launches, composed, margin, resident_det = strategy_phase(
        ddp, card)
    strategy_bf16_launches = bf16_strategy_phase(composed, margin, card)
    stamp("strategy phases")
    t0 = time.time()
    stream_launches, stream_bf16_launches, stream_cases, unarmed = \
        stream_phase(out, out_bf16, resident_det, card, snapshot_dir.name)
    print(f"streaming phase: {time.time() - t0:.1f} s", flush=True)
    stamp("streaming phase")
    with tempfile.TemporaryDirectory() as tmp:
        survive_launches = resilience_phase(unarmed, card, tmp)
    stamp("resilience phase")
    with tempfile.TemporaryDirectory() as tmp:
        storage_launches = storage_phase(card, tmp, sync_write_s)
    stamp("storage phase")
    with tempfile.TemporaryDirectory() as tmp:
        obs_launches = obs_phase(card, tmp)
    stamp("obs phase")
    models = models_phases(out, out_bf16, card)
    stamp("models phases")
    tp_launches = tp_phase(models, card)
    stamp("tensor-parallel phase")
    pp_launches = pp_phase(card)
    stamp("pipeline phase")
    serve = serve_phase(snapshot)
    print(f"serve: {json.dumps(serve)}", flush=True)
    serve_bf16 = bf16_serve_phase(snapshot_bf16, serve)
    print(f"serve bf16: {json.dumps(serve_bf16)}", flush=True)
    stamp("serving phases")
    fleet = fleet_phase(snapshot, os.path.join(snapshot_dir.name,
                                               "stream.pt"),
                        snapshot_bf16, card)
    stamp("fleet phase")
    with tempfile.TemporaryDirectory() as tmp:
        generate = generate_phase(card, tmp)
    print(f"generate: {json.dumps(generate)}", flush=True)
    stamp("generate phase")
    snapshot_dir.cleanup()
    anchors = [anchor_phase(path, dtype, card) for path, dtype in ANCHORS]
    print(f"anchors: {json.dumps(anchors)}", flush=True)
    stamp("accuracy anchors")

    conv3x3 = conv_kernel_phase(gen)
    stamp("conv kernel phase")
    probe_routes = probe_phase()
    stamp("probe phase")

    # row_gather stays the direct counterpart of _pallas_row_gather for
    # later slices; the main path now runs gather_batch.
    row_gather.update(launches=row_main_launches,
                      launches_main_path=row_main_launches)
    # The serving path's launches of gather_batch_kernel: the eager runs in
    # warm() (the wrapper's count less the captures, where it counts but
    # does not launch) and, in the profiled HTTP load, the profiler's count
    # (one a graph replay; the wrapper is not called there).
    batch.update(launches=launches, launches_main_path=launches,
                 launches_ddp_path=ddp_launches,
                 launches_strategy_path=strategy_launches,
                 launches_stream_path=stream_launches,
                 launches_models_path=models["launches_f32"],
                 launches_tp_path=tp_launches,
                 launches_pp_path=pp_launches,
                 launches_bench_path=bench["float32"],
                 launches_bench_modes_path=bench_modes["float32"],
                 launches_runshape_path=runshape_launches,
                 launches_resilience_path=survive_launches,
                 launches_storage_path=storage_launches,
                 launches_obs_path=obs_launches,
                 launches_fleet_path=fleet["launches"],
                 launches_generate_path=generate["launches"],
                 stream_batch_cases=stream_cases[torch.float32],
                 launches_serve_path=serve["warm_launches"]
                 + serve["http_profiled"]["gather_batch_kernel_launches"],
                 serve_warm_launches=serve["warm_launches"],
                 serve_http_launches_profiled=serve["http_profiled"][
                     "gather_batch_kernel_launches"],
                 serve_graph_replays_http=[
                     serve["http"]["graph_replays"],
                     serve["http_profiled"]["graph_replays"]],
                 serve_forwards_phase=serve["forwards"],
                 serve_profiled_per_bucket={
                     b: [p["gather_batch_kernel_profiled"],
                         p["forwards_profiled"]]
                     for b, p in serve["buckets"].items()},
                 max_abs_err=max(batch["max_abs_err"], serve["max_abs_err"],
                                 generate["max_abs_err"]))
    conv3x3.update(launches=sum(probe_routes.values()),
                   launches_by_route=probe_routes,
                   path="python -m ddp_tpu_torch.ops.conv_candidates "
                        "[--bf16]",
                   launches_main_path=conv_main_launches)
    # The bf16 form: its main path is the --bf16 run; its other paths the
    # bf16 strategy run (world 1 and the card ranks of world 2) and the
    # bf16 serving phase (warm()'s eager runs and the profiled replays).
    bf16_main = out_bf16["launches"]["gather_batch_bf16"]
    batch_bf16.update(launches=bf16_main, launches_main_path=bf16_main,
                      launches_strategy_path=strategy_bf16_launches,
                      launches_stream_path=stream_bf16_launches,
                      launches_models_path=models["launches_bf16"],
                      launches_bench_path=bench["bfloat16"],
                      launches_bench_modes_path=bench_modes["bfloat16"],
                      stream_batch_cases=stream_cases[BF16],
                      launches_serve_path=serve_bf16["warm_launches"]
                      + serve_bf16["profiled_replay_launches"],
                      launches_fleet_path=fleet["launches_bf16"])
    pycache.cleanup()
    print(json.dumps({"kernels": [row_gather, batch, batch_bf16, conv3x3]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
