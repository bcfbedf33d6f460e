#!/usr/bin/env python3
"""Drives paddle_tpu_torch on one NVIDIA GPU and checks it, phase by phase:

1. device   the card's name, power limit and count; no CUDA -> exit 1
2. build    nvcc builds every kernel of ops/kernels/csrc/ from this checkout
3. kernels  each CUDA kernel against its plain PyTorch version on the card,
            fp32, bf16 and (#1-#8) fp16 at one fp16 ulp of the largest
            output, at the main paths' shapes (the flash forward
            through the fused_multihead_attention op); times from CUDA
            events beside each kernel's bound and its library yardstick
            (F.scaled_dot_product_attention, forward or backward alone;
            aten native_layer_norm_backward; the fused-block kernels'
            unfused torch twins, and torch.matmul alone beside them);
            the attention and fused-block kernels have bounds on the
            tensor cores (their fp32-FMA bounds printed beside them),
            the fused-block launches' device times read apart by
            torch.profiler, the short forward is timed beside the flash
            forward on the same inputs, and torch.profiler gives the
            device time of each of the two launches of the short backward
            at BERT's shape and of the flash backward at the long step's;
            the LayerNorm backward at six shapes (both of its paths), its
            two launches equal bit for bit and one device kernel a call;
            the short forward / backward and the LayerNorm backward at the
            Transformer's shapes too (b 256, 8 heads, s 64: causal and
            not, each with a key bias, dropout 0.1 on the backward; rows
            16384 x 512); each of #1-#7 with dropout 0.1 and its seed a
            device word (the static step's seed slot, read through a
            pointer), bit-equal to the launch with the same word by value
            and at its gate against the plain version given that word
4. serve    BERT-base (hidden 768, 12 layers, b 8, s 128, random weights
            from --seed) exported with save_inference_model and served by
            the port's InferenceServer over HTTP; every reply finite, equal
            bitwise to predictor.run and within 1e-3 of the same export run
            on the CPU; the short kernel launched 12 times per request
5. train    BERT-base masked-LM pretraining (fp32, Adam 1e-4, dropout 0.1,
            b 8, s 128, max_preds 20): every step launches 12 short
            forward, 12 short backward and 26 LayerNorm backward kernels;
            the loss falls over 5 steps on one batch; at base width with 2
            layers, 3 steps on the card agree with the same 3 steps on the
            CPU; step time, tokens/s, peak memory and one profiled step
5b amp     BERT-base as bench.py:bench_bert trains it: masked-LM, max_preds
            20, mixed_precision.decorate(Adam 1e-4) in bf16, dropout 0.1,
            s 128, at b 8 and at b 256 (halved until it fits): 5 steps a
            batch size, the loss falls, every step launches 12 short
            forward, 12 short backward and 26 LayerNorm backward kernels;
            step time, tokens/s, peak memory, one profiled step; then 2
            layers at base width and b 2, 3 steps, card against CPU from one state
5c full    full pretraining at base width, b 8, s 128: the NSP head and the
            masked-LM head over every position, attn_layout "bhsd" (kernels
            #2 and #6), bf16 AMP with dynamic loss scaling around Lamb(1e-3,
            lamb_weight_decay=0.01) with GradientClipByGlobalNorm(1.0): 5
            steps, the loss falls, the scale fetched each step, 12 short
            forward and 12 short backward launches a step; then steps with a
            non-finite mask weight until the scale shrinks by decr_ratio,
            every persistable finite; then at 2 layers and b 2 card against
            CPU, this configuration and the unfused path (use_flash_attention
            False, fused_qkv, an untied MLM projection, AdamW, an L1 decay on
            the pooler, a clip by value), which launches no attention kernel
5d fp16    BERT under mixed_precision.decorate(Adam 1e-4, amp_dtype
            "float16") with dynamic loss scaling, b 8, s 128: 1 layer at
            base width and b 2, 3 steps card vs CPU within one fp16 ulp; then 5
            steps at full depth, the loss falls, the scale fetched each
            step, the short forward / backward and LayerNorm backward
            kernels of a step all in their fp16 versions (torch.profiler)
6. long     one fused_multihead_attention training step at s 2048 through
            append_backward: one flash forward and one flash backward
            launch, dQ / dK / dV within 1e-4 of the plain backward
7. fused    the fused-block A/B (tools/fused_block_pallas.py's, ported):
            at each ResNet-50 b256 bottleneck 1x1 shape in bf16, both
            kernels against their plain versions, then each kernel's time
            against its unfused torch twin's
8. resnet   ResNet-50 training, b 128, 224x224, Momentum(0.1, 0.9), 5 steps
            on one batch, in fp32 and under bf16 AMP (contrib.
            mixed_precision.decorate), as the JAX package's bench_resnet
            runs it: finite losses that fall; step time, images/s, TFLOP/s,
            peak memory, one profiled step and the host time by op type.
            Then ResNet-50 at b 2, 3 steps, each from the same state on the
            card and on the CPU: losses and every persistable agree. Then
            the trained fp32 program's clone(for_test=True), exported with
            save_inference_model, served by AnalysisPredictor at b 8 on the
            card and on the CPU. The ResNet path runs none of the kernels
9. transformer  bench.py:bench_transformer: TransformerConfig.base() at b 256
            (an out-of-memory error fails the run), s 64, mixed_precision.decorate(Adam
            1e-4) in bf16: 5 steps, the loss falls, every step launches 18
            short forward (6 causal), 18 short backward (6 causal) and 30
            LayerNorm backward kernels; step time, target tokens/s,
            TFLOP/s, peak memory, one profiled step. Then from the trained
            scope, b 8: the encode program once (6 short forward), the
            decode step fed its cross K / V (12 short forward, 6 causal),
            its logits against the full is_test graph's; the decode step's
            p50. Then 2 layers at base width and b 2 card vs CPU, the fused
            path and the unfused one (no attention kernel)
11. recompute  BERT-base as 5b trains it, with BertConfig(recompute=True)
            (each encoder layer a recompute_scope segment) under
            mixed_precision.decorate(RecomputeOptimizer(Adam 1e-4)) in
            bf16, at b 256 and b 8 (an out-of-memory error fails the run):
            5 steps each, the loss falls, every step launches 24 short
            forward (the forward and each segment's recomputation), 12
            short backward and no LayerNorm backward; step time, tokens/s,
            peak memory beside 5b's at the same batch, one profiled step.
            Then 2 layers at base width and b 2, 3 steps: card vs CPU, and the
            recompute step vs the plain step on the card, at 5b's gates
12. scan    PADDLE_TPU_FUSE_LAYER_SCAN=1 against the default passes, from
            one state, the arms interleaved under deterministic
            algorithms: BERT fp32 b 8, BERT bf16 b 256 and Transformer-base
            b 256 s 64 bf16 (1343 -> 75 and 1755 -> 100 ops, as the JAX
            package gives). Each arm's p50, host issue, busy and idle time,
            peak memory, the scan_fused_* counters; losses and every
            persistable bit-equal over 5 steps, the same launches a step,
            no forward re-run
13. conv    VGG-16 and SE-ResNeXt-50 at b 64, 224x224, 1000 classes under
            mixed_precision.decorate(Momentum(lr, 0.9)) in bf16 (lr 0.01
            for VGG, 0.1 for SE-ResNeXt), and
            LeNet-5 at b 64, 1x28x28, fp32: 5 steps each, the loss falls,
            step time, images/s, peak memory, one profiled step; no kernel
            launched. Then VGG-11 and SE-ResNeXt-26 at b 2, 3 steps each
            from one state card vs CPU at phase 8's gates; sigmoid,
            adaptive pool2d, conv2d_transpose and conv3d, op and grads,
            card vs CPU within 1e-4
14. serving at scale  14a: BERT-base (fp32, s 128) exported with a batch
            placeholder and served in-process by a batch-of-1 server
            (max_queue 16) and a coalescing one (10 ms window, buckets 1..64,
            max_queue 256, every bucket prewarmed); 64 client threads in a
            closed loop, 128 one-row requests of seeded lengths a server
            (a shed request sent again after its Retry-After):
            requests/s, p50, p99, requests a dispatch over the run (>= 1.5
            or the run fails) beside serve_batch_size_p50, dispatches, padded rows, 12 short forward launches a
            dispatch; every coalesced reply an intact row of its merged
            dispatch, a second dispatch of each merged batch bit-equal to
            the first, every reply within 1e-4 of its batch-of-1 dispatch
            (bit-equality counted); each bucket dispatched twice (bit-equal)
            and its rows against batch-of-1; card vs CPU within 1e-3; one
            profiled bucket-64 dispatch. 14b: the server as a subprocess on
            the card with a ready-file: a PADDLE_TPU_FAULTS plan fails 3
            requests, /healthz answers 503 breaker_open, the probe recovers
            it; then 16 requests parked by a hold rule, SIGTERM, /healthz 503
            draining, a new request 503, all 16 replies 200 and whole, exit 0
            within --drain-timeout. 14c: prefill-role, decode-role and
            unified servers over the paged KV cache (default profile), 64
            concurrent /generate requests (prompts of 8-40 tokens, max_new
            16), then the same split through /prefill and /decode: every
            split reply bit-equal to the unified one; tokens/s, p50, p99,
            decode-step ms (wall over kv_decode_steps), peak kv_pages_in_use,
            one profiled decode step; at the JAX package's toy width (card
            vs CPU: the same tokens, logits within rtol 1e-5) and at
            BERT-base's attention width (12 heads of 64, vocab 30522)
16. registry  two BERT-base bundles (fp32, s 128) from two seeds behind one
            server on the card, through a model_registry.json: main, the
            built-in default, and alt@v1, each coalescing at a 10 ms window,
            QoS classes gold (weight 8, deadline_ms 500) and bulk (weight 1)
            on one DRR gate. (a) without X-Model a reply is bit-equal to a
            registry-less server's, with X-Model alt to alt's predictor.run
            and within 1e-3 of alt on the CPU; an unknown X-Model 404
            NoSuchModel. (b) 32 bulk clients on alt and 8 gold on main in two
            processes, closed loops of 64 requests a class (a shed sent
            again after its Retry-After); a first round with all 40 clients
            connecting at once, reported (replies by code, p50, slowest);
            then each class's clients started over 1 s: every reply 200,
            gold's p50 below bulk's; requests/s, p50, p99, slowest and gate
            grants a class. (c) 16 clients on alt while
            /admin/deploy swaps in alt@v2 (v1's weights exported again): every
            reply 200 and a row of a v1 or v2 dispatch (after the flip of a
            v2 one), v1's merged batches bit-equal through v2, serve_deploys
            and serve_deploy_unloads 1, memory_allocated after the unload
            within 5% of before; the deploy's wall ms and peak. Then a drifted
            alt@v3 (another seed) 409 ExportToleranceError and a
            registry.cutover fault plan's abort (500): v2 keeps serving, its
            bits, and the refused candidates' memory is back. (d) two toy
            decoders at BERT's attention width (two seeds) on the server's one
            paged pool, 32 concurrent /generate split across X-Model (prompts
            of 8-40 tokens, max_new 16): each stream bit-equal to its model on
            a server that holds only it; tokens/s, p50, p99, peak
            kv_pages_in_use, kv_decode_steps. 12 short forward launches a BERT
            dispatch on the card, every dispatch of the phase counted
17. fleet   the serving fleet (paddle_tpu_torch/inference/fleet.py): the
            failover router in this process, `--device cuda` worker
            subprocesses sharing the card, phase 16's two BERT-base bundles.
            (a) 2 replicas, no window, alt behind X-Model: 80 replies each
            bit-equal to predictor.run here, within 1e-3 of the CPU; (b)
            closed loops of 32 clients (a process of their own), 128
            requests at a 10 ms window over 1, 2 and 4 replicas: requests/s,
            p50, p99, each replica's batch p50, each worker's memory from
            nvidia-smi; (c) a fleet.kill_replica fault SIGKILLs the worker
            holding a request: it fails over bit-equal, the slot respawns;
            (d) a rolling restart under 16 clients, every reply 200 and
            bit-equal; (e) a prefill and a decode worker, 16 /generate
            streams of the BERT-width toy decoder bit-equal to a unified
            server's, fleet_handoffs >= 16; (f) backend classes gpu, gpu,
            gpu-overflow through the fleet.divert and fleet.tier_loss
            chaos sites: degraded and back, no error but 503, every 200
            bit-equal. Each live worker's /healthz kernel_launches: 12 short
            forward launches a BERT dispatch it made in (a) and (b)
18. dygraph  paddle_tpu_torch.dygraph on the card (dygraph_phase). (a)
            ResNet-50 built from the dygraph Conv2D / BatchNorm / Pool2D /
            Linear as upstream Paddle's test_imperative_resnet.py builds
            it (bottleneck blocks [3, 4, 6, 3], global average pool, 1000
            classes), b 64, 224x224, fp32, the loss a record of the
            cross-entropy, Momentum(0.1, 0.9): 5 eager steps, then 5
            dygraph.to_compiled steps (one CUDA graph replay each) from the
            same cloned state; each compiled loss within 1e-5 relative of
            its eager twin, parameters, running stats and velocities within
            1e-4 of each tensor's largest element, cache_info 1 miss and 4
            hits, and one profiled compiled step with one cudaGraphLaunch
            and no more other kernel launches than the inputs and scalars it
            copies in; each arm's step p50, host issue time, busy and idle
            (torch.profiler) and peak memory. (b) a two-stage bottleneck
            net at b 2, 3x32x32, 10 classes, 3 Momentum steps each from the
            CPU's state, eager and compiled on the card against eager on
            the CPU, at phase 8's gates. (c) every other layer class (Pool2D
            max, avg and global; the graph-op classes too): output, grads
            and state card vs CPU within 1e-4. (d) Dropout(0.1) masks on the
            card equal the CPU's and the host threefry's bit for bit; three
            calls of a compiled step each draw the host key of their call
            (two differ). (e) no kernel of ops/kernels launched
19. data    the input pipeline (data_phase), under deterministic
            algorithms. (a) BERT-base masked-LM as phase 5 trains it (fp32,
            Adam 1e-4, dropout 0.1, b 8, s 128, max_preds 20), 12 steps an
            arm from one state, each a fresh Executor, fed one seeded sample
            stream through xmap_readers and buffered, shuffled by the
            loader (shuffle_buf 64): L, DataLoader.from_generator(...,
            use_double_buffer=True) on the default place, its batches staged
            through pinned memory on the stager's copy stream; F, the same
            loader yielding numpy feeds; D, train_from_dataset over an
            InMemoryDataset of MultiSlot files MultiSlotDataGenerator wrote
            from L's batches. Every fed batch copied back after its step
            (D's cloned on the card after each step and copied after the
            loop, since train_from_dataset does not wait for the card):
            F's, L's and D's byte-equal, their losses bit-equal, D's last
            fetch L's 12th, 12 short forward, 12 short backward and 26
            LayerNorm backward launches a step in every arm,
            reader_staged_batches 12 for L and D, a staged feed passed
            through exe.run untouched; each arm's step p50, next() wait,
            peak memory, one profiled step (busy, idle, host-to-device
            copies). (b) ResNet-50 bf16 AMP as phase 8 trains it (b 128,
            224x224, Momentum(0.1, 0.9)) from a reader.cache pool of 256
            seeded images, F against L from one state, 2 warm-up and 8
            timed steps: fed batches byte-equal, losses bit-equal (or, where
            an op has no deterministic version, each step from one state
            within one bf16 ulp), no kernel launched; step p50, next() wait,
            the copy stream's host-to-device ms of a batch, peak memory, one
            profiled step. (c) L for 5 batches, its cursor, save_persistables
            and save_params with filename=; a fresh Executor (seed counter
            5) and scope from load_persistables, a fresh loader at the
            cursor: batches 6-12 and their losses bit-equal to the
            uninterrupted run's; load_params restores every parameter bit
            for bit; the eval clone exported with params_filename= and
            loaded on the card fetches bit-equal to the writing scope's.
            (d) contrib.Trainer on datasets.uci_housing (fit-a-line), 2
            epochs on the default place, losses finite and falling; a
            layers.py_reader shim's batch equal to (a)'s first
20. resil.  checkpointing, supervision and the NaN guard (resilience_phase),
            under deterministic algorithms, on phase 5's BERT-base cell fed
            by phase 19's stream through the staged DataLoader. (a) 12 steps
            in process from one state, without a manager and under
            CheckpointManager(save_interval=4, keep=2, async) with
            track_reader and attach (snapshots at steps 0, 4, 8 and the
            last, 11): losses bit-equal, every committed snapshot's records
            bit-equal to the state at its step (cloned on the card while the
            next step was dispatched, no host wait), latest_step 11 after
            drain; each arm's step p50, ckpt_* counters, the time submit
            held the caller, the copy stream's ms a snapshot, peak memory,
            free disk. (b) the same job in worker processes (this script
            with --resilience-worker) under TrainSupervisor: SIGKILLed by
            fleet.kill_trainer at step 6, resumed from the newest valid
            snapshot, stopped at step 8 (SIGTERM: PreemptionHandler commits
            a final snapshot, exit 0), finished by a second supervisor;
            every step's batch crc and loss bit-equal to (a), 12 / 12 / 26
            launches a step in every attempt, no worker left; train_mttr_ms,
            the restore ms and free memory at each start. (c), in the
            script's process while (b)'s first worker starts: NanGuard(
            max_consecutive=2) around Adam with snapshots at steps 0, 2, 4:
            two steps with a NaN mask weight, check False twice, the
            rollback bit-equal to snapshot 4, nan_steps_skipped 2 and
            nan_rollbacks 1, then two clean steps finite and falling
21. mesh    CompiledProgram and the mesh (mesh_phase), under deterministic
            algorithms, on phase 5's BERT-base cell (fp32, b 8, s 128,
            dropout 0.1, Adam). (a) 10 steps from one state in four arms:
            Executor.run; CompiledProgram(main).with_data_parallel(loss_name=
            ...) without a process group (the 1x1x1 mesh); the same under a
            one-rank NCCL process group over a file:// store (a
            DeviceMesh("cuda", 1x1x1), its grad all-reduce and fetch mean
            run); and that with zero1=True: every fetch and persistable
            bit-equal across the arms, 12 short forward, 12 short backward and
            26 LayerNorm backward launches a step; each arm's step p50; one
            mesh step's all-reduces through the NCCL group and its device
            kernels (torch.profiler): #1, #7's two launches and #8. (b) a
            snapshot under the mesh, restore(mesh=...) into a fresh scope:
            every persistable and the seed counter bit-equal, the
            manifest's mesh recorded, the next step bit-equal. (c) dygraph DataParallel on the one-rank
            group (an MLP at BERT's width on 1024 rows): grads bit-equal to
            the run without it
22. repeated  Executor.run_repeated (repeated_phase), under deterministic
            algorithms: each cell from one state three ways, 10 run() calls,
            run_repeated(steps=10) and 3 run() + run_repeated(7), every
            stacked fetch, persistable and the seed counter bit-equal. (a)
            phase 5's BERT-base cell (fp32, b 8, s 128, dropout 0.1, Adam);
            (b) phase 5c's full pretraining (bhsd, bf16 AMP, dynamic loss
            scaling, Lamb with a global-norm clip); (c) (a)'s Program as a
            CompiledProgram on a one-rank NCCL group, run_repeated(10)
            bit-equal to (a)'s run() arm; (d) phase 8's ResNet-50 b 128 bf16
            AMP, run_repeated(10) bit-equal to 10 run(), no kernel of #1-#10;
            (e) CheckpointManager(save_interval=4) across run_repeated(10):
            one snapshot, labelled 9, bit-equal to (a)'s state after step
            10. On the card each window replays one captured CUDA graph; a
            profiled replay window's device kernels a step (12 #1 or #2, 12
            of each of #6 / #7's two launches, 26 #8 for (a)); each arm's
            capture ms, the walk's step p50, the replay's per-step p50, host
            ms a step, idle share and the graph pool's memory
23. collective  fleet collective and placement (collective_phase), under
            deterministic algorithms, on phase 5's BERT-base cell (fp32, b 8,
            s 128, dropout 0.1, Adam) on a one-rank NCCL group (a file://
            store), 10 steps an arm from one state: (a) the fleet path
            (PaddleCloudRoleMaker over a one-trainer PADDLE_* env,
            fleet.init, fleet.distributed_optimizer(Adam,
            DistributedStrategy()).minimize, plain Executor.run); (b) the
            same with strategy.zero1 and PADDLE_TPU_AUTOSHARD=1, whose
            pass-cache signature differs from (a)'s; (c) CompiledProgram
            over a DistributedStrategy(tp=1) mesh: every loss, persistable
            and the seed counter bit-equal to the plain walk, #1, #7 and #8
            launched 12, 12 and 26 times a step and in a profiled fleet
            step (torch.profiler), the step's all-reduces through the
            group; each arm's step p50. (d) the autoshard planner in a
            process of its own (no CUDA context): BERT-base planned for
            H100 nodes at 8, 16 and 32 GPUs (mesh, state MB a device,
            weighted collective bytes), its plan table read back by
            TrainSupervisor(plan_table=). (e) tp=2: two processes sharing
            the card over a gloo group (CUDA tensors, a DeviceMesh("cuda")
            of batch 1 x model 2), 3 steps of the cell through
            CompiledProgram from the startup state: the Megatron weights
            Shard(d) on model, the replicated state bit-identical on both
            ranks, the losses and the gathered persistables against the
            one-device walk at 5b's card-vs-CPU gates, #1, #7 and #8
            launched 12, 12 and 26 times a step on each rank (rank 1's
            attention over heads 6-11 of 12); each rank's step p50
24. sequence  sequence and expert parallelism (sequence_phase), under
            deterministic algorithms: (a) ring attention alone (b 1, 12 heads,
            s 8192, d 64, n 4; fp32 and bf16, causal and not, a key bias,
            dropout 0 and 0.1): one pass launches #3 and #4-#5 once a chunk
            pair (10 causal), out, lse and grads against ring_attention_plain
            at phase 3's gates, with dropout 0 against one whole #3 / #4-#5
            launch, with dropout two passes bit-equal; s 1000 (chunks of 250).
            (b)-(d) on two processes sharing the card over gloo (a batch 1 x
            model 2 mesh, CUDA tensors, the ring's hops staged through pinned
            host memory; started with phase 23, they import meanwhile), 3
            steps an arm: (b) BERT-base pretraining (fp32,
            max_position 4096, b 1, s 4096, hidden dropout 0.1, Adam) with
            PADDLE_TPU_SP_MODE unset, so the auto-default takes the ring: 12
            ring dispatches a step on each rank, 24 #3, 24 #4-#5 and 26 #8;
            (c) the same under PADDLE_TPU_SP_MODE=ulysses, its losses within
            rtol 1e-4 of (b)'s; (d) the MoE model of tests/test_moe_layer.py at
            Transformer-base width (d 512, d_ff 2048, 8 experts, k 2, capacity
            2.0, 4096 tokens, Adam), 4 experts a rank. Each arm against its
            one-device walk at 5b's card-vs-CPU gates, every parameter but the
            experts replicated and bit-identical on both ranks; each arm's step
            p50 beside the walk's
25. result  a `{"kernels": [...]}` JSON line (each attention kernel with its
            seed-pointer launches and its half-head launches of phase 3, and
            the flash kernels with phase 24 (a)'s ring passes), the
            nvidia-smi line, and last `{"ok": true, "device": {...}}`

Each main path (serve, train, amp, full, fp16, long, fused, resnet,
transformer, decode, recompute, scan, conv, serve_b1, serve_coalesced,
serve_registry, serve_fleet, dygraph, data, resilience, mesh, repeated,
collective, sequence) runs with every
launch count set to 0 just before it and read just after (serve_fleet: each
worker's counts read from its /healthz before and after, the difference taken;
data: each BERT arm's counts, summed; resilience: each step's counts in every
arm and worker attempt, summed; mesh: the three mesh arms; collective: its
three arms and (e)'s two ranks, summed; sequence: (b)-(d) on both
ranks, summed; repeated: the
walks and each static step's discovery and capture, its replays read from
torch.profiler); a kernel
of the path that was not launched fails the run, and so does any launch
on a path that expects none (resnet, conv, dygraph).

Every phase runs the Program after the Executor's default passes
(paddle_tpu_torch/passes/); each training and serving phase prints its
ops before -> after, the passes' wall time at the first run, and that
the second run ran none. Phases 5, 5b (b 256), 5c, 8 (fp32, bf16 and the
served export) and 9 end with an A/B of the passes: PADDLE_TPU_PASSES=none
against the default set, from one state, each arm a fresh Executor, the
arms' steps interleaved (BERT and the Transformer under
torch.use_deterministic_algorithms, since the embedding backward's sums
are not reproducible run to run at b 256); each arm's step p50, busy time and idle share
(torch.profiler), host issue time with its top op types and optimizer
rows, and peak memory. Gates: BERT and the Transformer run free, fp32
losses within rtol 1e-6 / atol 1e-7 and AMP losses within one ulp of
their type, every persistable within 1e-6 of its largest, and the first
differing op named where the arms are not bit-equal; ResNet steps each
from one state at phase 8's card-vs-CPU gates (bf16: the loss within one
ulp); the served probabilities within 1e-4; no __auto_grad__ re-runs a
forward in any training path.

A failed phase raises and the script exits non-zero without the last line.
Run from the root of a checkout:

    python3 chip_smoke.py                  # on the card
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes on the CPU, plain
                                           # versions only; never prints ok
    python3 chip_smoke.py --only dygraph   # phases 1 and 18 alone; never
                                           # prints ok
    python3 chip_smoke.py --only data      # phases 1 and 19 alone; never
                                           # prints ok
    python3 chip_smoke.py --only resilience  # phases 1 and 20 alone;
                                             # never prints ok
    python3 chip_smoke.py --phase 21       # phases 1 and 21 alone (also
                                           # --only mesh); never prints ok
    python3 chip_smoke.py --phase 22       # phases 1 and 22 alone (also
                                           # --only repeated); never prints ok
    python3 chip_smoke.py --phase 23       # phases 1 and 23 alone (also
                                           # --only collective); never prints ok
    python3 chip_smoke.py --phase 24       # phases 1 and 24 alone (also
                                           # --only sequence); never prints ok

Imports torch, numpy, the standard library and paddle_tpu_torch only.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import multiprocessing
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# datasheet rates (dense, no sparsity) by the name nvidia-smi reports:
# (memory bytes/s, fp32 FLOP/s without tensor cores, bf16 tensor-core FLOP/s)
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),  # SXM
    "H200": (4.8e12, 67e12, 989e12),
}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # kernel vs plain, same card
KERNEL_DTYPES = ("float32", "bfloat16", "float16")  # #1-#8; #9-#10 take no fp16
REQUESTS = 4  # BERT-base /predict requests in the serving path's run
TRAIN_STEPS = 5  # BERT-base steps on one batch in the training path's run (and a A/B arm's)
PARITY_STEPS = 3  # card vs CPU steps of the 2-layer BERT at base width
# the batch of the card-vs-CPU references: 5b's and 11's (2 layers), and
# those whose vocab-wide products bind the CPU run: 5c's (the masked-LM
# head over every position), 5d's (fp16: 3 steps of 1 layer took 170 s at
# b 8 and 39.6-48.3 s at b 2 on an H100 host while the port took fp16 CPU
# products in torch's fp16 GEMM; ops/math_ops.py `_product` takes them in
# fp32 now) and 9's (the Transformer's output layer). Those products scale
# with the batch, not the depth. Two rows, so that a fault that mixes rows
# or misplaces a row's bias or padding shows against the CPU
CPU_REF_BATCH = 2
# the requests of a timed closed loop: phase 14a's (a server, 2 a client),
# 16 (b)'s (a QoS class) and 17 (b)'s (a replica count). 14a's and 16's are
# fewer than before the sequence phase, 16's and 17's than before the
# collective phase: the script's time limit, not the gates, set them
SERVE_REQUESTS, QOS_REQUESTS, FLEET_REQUESTS = 128, 64, 128
LR = 1e-4
FULL_LR = 1e-3  # Lamb's learning rate in the full-pretraining path (5c)
# card vs CPU after PARITY_STEPS Adam steps: the losses within a relative
# 1e-4; a parameter within 2 * LR * PARITY_STEPS, since Adam's first steps
# move an element by about LR * sign(grad) and a grad at rounding noise
# level may take either sign on the two devices; and all but 1e-3 of all
# elements within 1e-5
LOSS_RTOL = 1e-4
PARAM_ATOL = 2 * LR * PARITY_STEPS
CLOSE_ATOL, CLOSE_FRAC = 1e-5, 1e-3
# ResNet-50 (bench.py:bench_resnet): batch, steps on one batch, optimizer
RN_BATCH, RN_STEPS, RN_LR, RN_MOMENTUM = 128, 5, 0.1, 0.9
RN_PARITY_BATCH, RN_SERVE_BATCH = 2, 8
# ResNet-50 b 2 card vs CPU, each step from the same state. The losses
# within a relative 1e-4; the batch norms' running means and variances
# (forward statistics) within 5e-4 of each one's largest magnitude; each
# parameter and velocity within 0.15 of its norm. At b 2 the first step's
# grads are ill-conditioned in fp32: two CPU implementations of the same
# step (the JAX package's and this port's, from one state) gave losses
# within 6e-6 and running stats within 4.2e-5, but velocities apart by up
# to 5.4% of their norm (26% of their largest element) and parameters by
# 4.8%, from summation order alone
RN_LOSS_RTOL, RN_STAT_RTOL, RN_GRAD_NRTOL = 1e-4, 5e-4, 0.15
# card vs CPU softmax outputs of the served eval program
RN_SERVE_ATOL = 1e-4
# the Transformer (bench.py:bench_transformer): batch, sequence length, and
# the batch of the incremental decode and of the card-vs-CPU steps
TF_BATCH, TF_SEQ, TF_INFER_BATCH = 256, 64, 8
# the decode step's logits against the full is_test graph's, on the card:
# the JAX package's gate (tests/test_decoding.py:369-374)
DECODE_RTOL, DECODE_ATOL = 1e-5, 1e-6


# passes off (PADDLE_TPU_PASSES=none) against on, from one state: fp32
# losses within the JAX package's gate (tests/test_passes.py: rtol 1e-6,
# atol 1e-7), AMP losses within one ulp of their type; every persistable
# within 1e-6 of its largest magnitude
PASS_AB_RTOL, PASS_AB_ATOL, PASS_AB_STATE = 1e-6, 1e-7, 1e-6


@contextlib.contextmanager
def passes_env(mode):
    """PADDLE_TPU_PASSES=none for "off"; unset (the default set) for "on";
    the default set and PADDLE_TPU_FUSE_LAYER_SCAN=1 for "scan"."""
    names = ("PADDLE_TPU_PASSES", "PADDLE_TPU_FUSE_LAYER_SCAN")
    saved = {n: os.environ.pop(n, None) for n in names}
    if mode == "off":
        os.environ["PADDLE_TPU_PASSES"] = "none"
    elif mode == "scan":
        os.environ["PADDLE_TPU_FUSE_LAYER_SCAN"] = "1"
    try:
        yield
    finally:
        for n in names:
            os.environ.pop(n, None)
            if saved[n] is not None:
                os.environ[n] = saved[n]


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# significant bits and smallest normal of the 16-bit AMP types
SIG_BITS = {"bfloat16": (8, 2.0**-126), "float16": (11, 2.0**-14)}


def ulp(x, dtype):
    """One ulp of `dtype` (bfloat16 or float16) at |x|."""
    bits, tiny = SIG_BITS[dtype]
    return 2.0 ** (math.floor(math.log2(max(abs(x), tiny))) - (bits - 1))


def kernel_tol(dtype, ref):
    """A kernel's gate against its plain version: TOL[dtype]; fp16 one fp16
    ulp of the largest finite |ref|, never tighter than the fp32 gate."""
    if dtype != "float16":
        return TOL[dtype]
    top = ref.float().abs()
    top = float(top[top.isfinite()].max()) if bool(top.isfinite().any()) else 0.0
    return max(TOL["float32"], ulp(top, "float16"))


def start_kernel_build():
    """Every kernel built from csrc/ (one nvcc a source, all at once) by
    `python paddle_tpu_torch/ops/kernels/_build.py` in a process of its own,
    started before torch is imported so that the compile overlaps the
    imports; its output goes to build/kernel_build.log -> (process, start
    time)."""
    (ROOT / "build").mkdir(exist_ok=True)
    with open(ROOT / "build" / "kernel_build.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "paddle_tpu_torch" / "ops" / "kernels" / "_build.py")],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    return proc, time.perf_counter()


def card_peaks(name):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return key, peaks
    return "H100 (assumed: card not in the table)", CARD_PEAKS["H100"]


def attention_work(shape, dtype, bias, causal):
    """Bytes (q, k, v, out, lse and bias once each) and FLOPs (4 d per live
    (query, key) pair of every head: S = QK^T and PV) of the attention
    forward."""
    b, h, sq, sk, d = shape
    esz = 4 if dtype == "float32" else 2
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * esz + b * h * sq * 4
    nbytes += b * sk * 4 if bias else 0
    return nbytes, 4.0 * b * h * live_pairs(sq, sk, causal) * d


def live_pairs(sq, sk, causal):
    if causal:  # query i sees keys j <= i + sk - sq
        return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))
    return sq * sk


def attention_bwd_work(shape, dtype, bias, causal):
    """Bytes (q, k, v, dO, dQ, dK, dV, lse, delta and bias once each) and
    FLOPs (10 d per live pair of every head: S = QK^T again, dP, dV, dQ,
    dK) of the attention backward."""
    b, h, sq, sk, d = shape
    esz = 4 if dtype == "float32" else 2
    nbytes = (3 * b * h * sq * d + 4 * b * h * sk * d) * esz + 2 * b * h * sq * 4
    nbytes += b * sk * 4 if bias else 0
    return nbytes, 10.0 * b * h * live_pairs(sq, sk, causal) * d


def flash_bwd_launch_work(shape, dtype, bias, causal):
    """Each launch of csrc/flash_bwd.cu apart -> {launch: (bytes, FLOPs)}.
    Launch 1 (dK, dV) reads q, k, v, dO, lse, delta and the bias once and
    writes dK and dV: 8 d a live pair (S^T = K Q^T, dP^T = V dO^T, dV +=
    P^T dO, dK += dS^T Q). Launch 2 (dQ) reads the same and writes dQ: 6 d
    a pair (S and dP again, dQ += dS K). 14 d in all, against the
    function's 10 d (attention_bwd_work): the launches share no scratch."""
    b, h, sq, sk, d = shape
    esz = 4 if dtype == "float32" else 2
    reads = (2 * b * h * sq * d + 2 * b * h * sk * d) * esz + 2 * b * h * sq * 4
    reads += b * sk * 4 if bias else 0
    pairs = b * h * live_pairs(sq, sk, causal) * d
    return {"dkv": (reads + 2 * b * h * sk * d * esz, 8.0 * pairs),
            "dq": (reads + b * h * sq * d * esz, 6.0 * pairs)}


def bound_ms(work, dtype, peaks, tensor_cores=False):
    """Least time for `work` = (bytes, FLOPs): max(its bytes over the memory
    rate, its FLOPs over the dtype's peak) -> (ms, what bounds it). Without
    tensor cores fp32 runs at the FMA units' rate; on them bf16 runs at the
    bf16 rate and fp32 as 3xTF32, three TF32 products per fp32 one at the
    TF32 rate (half the bf16 rate on every H100 datasheet)."""
    nbytes, flops = work
    bw, fp32, bf16 = peaks
    t_bytes = nbytes / bw
    if dtype != "float32":
        t_ops = flops / bf16
    else:
        t_ops = 3 * flops / (bf16 / 2) if tensor_cores else flops / fp32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ln_bwd_bound_ms(n, k, dtype, peaks):
    """Least time for the LayerNorm backward: max(x, dy, dx, mean, rstd,
    scale, dscale, dbias once each over the memory rate, 11 FLOPs an
    element (normalize, scale, two row sums, dx, two column sums) over
    the fp32 peak)."""
    esz = 4 if dtype == "float32" else 2
    nbytes = 3 * n * k * esz + 2 * n * 4 + 3 * k * 4
    bw, fp32, _ = peaks
    t_bytes, t_ops = nbytes / bw, 11.0 * n * k / fp32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def fused_block_bound_ms(kernel, m, k, n, dtype, peaks, tensor_cores=True):
    """Least time for a fused-block kernel -> (ms, what bounds it): max(its
    inputs read once and its outputs written once over the memory rate,
    the 2 M K N FLOPs of the product over the rate of the units it runs
    on, its elementwise FLOPs over the fp32 rate). On the tensor cores
    bf16 runs at the bf16 rate and fp32 as 3xTF32 (`bound_ms`); without
    them (tensor_cores=False, printed beside) fp32 runs product and
    elementwise work at the FMA rate."""
    esz = 4 if dtype == "float32" else 2
    if kernel == "fused_prologue_conv1x1":  # x, res, w, y; scale, shift
        nbytes = (2 * m * k + k * n + m * n) * esz + 2 * k * 4
        elementwise = 4.0 * m * k
    else:  # x, w, y; sum, sumsq
        nbytes = (m * k + k * n + m * n) * esz + 2 * n * 4
        elementwise = 3.0 * m * n
    product = 2.0 * m * k * n
    bw, fp32, bf16 = peaks
    if not tensor_cores:
        t_ops = (product + elementwise) / (fp32 if dtype == "float32" else bf16)
        t_bytes = nbytes / bw
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
    ms, bound_by = bound_ms((nbytes, product), dtype, peaks, tensor_cores=True)
    t_elementwise = elementwise / fp32 * 1e3
    return (ms, bound_by) if ms >= t_elementwise else (t_elementwise, "operations")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny sizes on the CPU through the plain versions; "
                    "never prints the ok line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["dygraph", "data", "resilience", "mesh", "repeated",
                                       "collective", "sequence"],
                    help="run phase 1 and this one phase only (phase 18, dygraph; "
                    "phase 19, data; phase 20, resilience; phase 21, mesh; phase 22, "
                    "repeated; phase 23, collective; phase 24, sequence); never prints "
                    "the ok line")
    ap.add_argument("--phase", choices=["18", "19", "20", "21", "22", "23", "24"],
                    help="the same as --only, by the phase's number")
    # phase 20's supervised worker: the script re-invoked by the TrainSupervisor
    ap.add_argument("--resilience-worker", metavar="DIR", help=argparse.SUPPRESS)
    # phase 23 (e)'s tensor-parallel ranks
    ap.add_argument("--tp-worker", nargs=2, metavar=("DIR", "RANK"), help=argparse.SUPPRESS)
    # phase 24 (b)-(d)'s sequence- and expert-parallel ranks
    ap.add_argument("--seq-worker", nargs=2, metavar=("DIR", "RANK"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.phase:
        args.only = {"18": "dygraph", "19": "data", "20": "resilience", "21": "mesh",
                     "22": "repeated", "23": "collective", "24": "sequence"}[args.phase]
    # whole lines as they come: a run cut by its time limit keeps its log
    sys.stdout.reconfigure(line_buffering=True)
    t_start = time.perf_counter()

    def elapsed(what):
        print(f"[time] {time.perf_counter() - t_start:.1f} s: {what}")
    if not (ROOT / "paddle_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: no paddle_tpu_torch next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.resilience_worker:
        return resilience_worker(args.resilience_worker, args.seed, args.cpu_rehearsal)
    if args.tp_worker:
        return tp_worker(args.tp_worker[0], int(args.tp_worker[1]), args.seed,
                         args.cpu_rehearsal)
    if args.seq_worker:
        return seq_worker(args.seq_worker[0], int(args.seq_worker[1]), args.seed,
                          args.cpu_rehearsal)
    kernel_build = None if args.cpu_rehearsal else start_kernel_build()
    import numpy as np
    import torch

    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        if kernel_build is not None:
            kernel_build[0].wait()
        return 1

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
    from paddle_tpu_torch.inference.server import InferenceServer
    from paddle_tpu_torch.models.bert import (
        BertConfig, bert_encoder, bert_flops_per_token, build_bert_pretrain)
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        attention_delta, flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import lenet, se_resnext, vgg
    from paddle_tpu_torch.models.resnet import RESNET50_TRAIN_FLOPS_PER_IMG, resnet
    from paddle_tpu_torch.models.transformer import (
        TransformerConfig, build_transformer, build_transformer_decode_step,
        build_transformer_encode, transformer_flops_per_trg_token)
    from paddle_tpu_torch.ops.kernels import fused_block as fb
    from paddle_tpu_torch.ops.kernels.layer_norm import ln_bwd, ln_bwd_plain, ln_bwd_plan
    from paddle_tpu_torch.ops.kernels.mha_short import (
        short_attention, short_attention_bwd, short_attention_bwd_plain,
        short_attention_plain)
    from paddle_tpu_torch.scope import to_numpy

    # ---- 1. device ------------------------------------------------------
    if rehearsal:
        dev = torch.device("cpu")
        smi, card = "cpu rehearsal", "cpu"
    else:
        dev = torch.device("cuda", 0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        card = torch.cuda.get_device_name(0)
        # the plain versions and the fc matmuls in full fp32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    peak_name, peaks = card_peaks(card)
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{card}; count {torch.cuda.device_count() if not rehearsal else 0}; "
          f"peaks from the {peak_name} datasheet: {peaks[0] / 1e12} TB/s, "
          f"{peaks[1] / 1e12} TFLOP/s fp32, {peaks[2] / 1e12} TFLOP/s bf16")
    if kernel_build is not None:
        t0 = time.perf_counter()
        rc = kernel_build[0].wait()
        print(f"[build] the kernels' build, started before the imports, ended {rc} after "
              f"{time.perf_counter() - kernel_build[1]:.1f} s; waited {time.perf_counter() - t0:.1f} "
              f"s for it (phase 2 builds what it did not)")

    if args.only == "dygraph":
        launches, stats = dygraph_phase(args.seed, rehearsal, smi)
        print("[result] dygraph: " + json.dumps(stats, default=str))
        print(f"[result] phase 18 alone passed (no ok line); {smi}")
        return 0
    if args.only == "data":
        launches, stats = data_phase(args.seed, rehearsal, smi)
        print(f"[result] launches on the data path's run: {launches}")
        print("[result] data: " + json.dumps(stats, default=str))
        print(f"[result] phase 19 alone passed (no ok line); {smi}")
        return 0
    if args.only == "resilience":
        launches, stats = resilience_phase(args.seed, rehearsal, smi)
        print(f"[result] launches on the resilience path's run: {launches}")
        print("[result] resilience: " + json.dumps(stats, default=str))
        print(f"[result] phase 20 alone passed (no ok line); {smi}")
        return 0
    if args.only == "mesh":
        launches, stats = mesh_phase(args.seed, rehearsal, smi)
        print(f"[result] launches on the mesh path's run: {launches}")
        print("[result] mesh: " + json.dumps(stats, default=str))
        print(f"[result] phase 21 alone passed (no ok line); {smi}")
        return 0
    if args.only == "repeated":
        launches, stats = repeated_phase(args.seed, rehearsal, smi)
        print(f"[result] launches on the repeated path's run: {launches}")
        print("[result] repeated: " + json.dumps(stats, default=str))
        print(f"[result] phase 22 alone passed (no ok line); {smi}")
        return 0
    if args.only == "collective":
        launches, stats = collective_phase(args.seed, rehearsal, smi)
        print(f"[result] launches on the collective path's run: {launches}")
        print("[result] collective: " + json.dumps(stats, default=str))
        print(f"[result] phase 23 alone passed (no ok line); {smi}")
        return 0
    if args.only == "sequence":
        launches, stats, _ = sequence_phase(args.seed, rehearsal, smi)
        print(f"[result] launches on the sequence path's run: {launches}")
        print("[result] sequence: " + json.dumps(stats, default=str))
        print(f"[result] phase 24 alone passed (no ok line); {smi}")
        return 0

    # ---- the passes: notes and the A/B of passes off against on ---------
    ab_place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)

    def pass_note(tag, stats):
        """`stats`: an Executor's last_pass_stats after a program's first
        and second runs. The first ran the passes, the second none."""
        require(stats[0] is not None and stats[1] is None,
                f"[{tag}] the passes did not run once: {stats}")
        removed = {k: v for k, v in stats[0]["passes"].items() if v}
        print(f"[{tag}] passes: {stats[0]['ops_before']} -> {stats[0]['ops_after']} ops "
              f"(removed by pass {removed}) in {stats[0]['ms']:.1f} ms at the first run; "
              f"the second run ran no pass")

    def snapshot(main_p, scope):
        """The persistables of `main_p` in `scope`, copied."""
        return {v.name: scope.get(v.name).detach().clone() for v in main_p.list_vars()
                if v.persistable and scope.has(v.name)
                and isinstance(scope.get(v.name), torch.Tensor)}

    def first_diff_op(main_p, state0, feed, fetch, modes=("off", "on")):
        """One step from `state0` in each of the two pass `modes` (passes
        off and on by default), each op's outputs summarised bit for bit
        (the sums of their bits, plain and position-weighted) -> "type
        name" of the first op of the second mode's program whose output
        differs from the same name's value in the first."""
        from paddle_tpu_torch import executor as executor_mod

        base, test = modes
        sums, orders = {}, {}
        for mode in modes:
            seen, order = {}, []
            saved = executor_mod.lower_op, executor_mod.lower_forward_op

            def hooked(fn):
                def wrapper(ctx, op, *rest):
                    out = fn(ctx, op, *rest)
                    for n in op.output_arg_names():
                        t = ctx.values.get(n) if n else None
                        if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                            bits = t.detach().contiguous().view(
                                {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]).long()
                            w = torch.arange(bits.numel(), device=bits.device) % 1021 + 1
                            seen[n] = torch.stack([bits.sum(), (bits.reshape(-1) * w).sum()])
                            order.append((op.type, n))
                    return out
                return wrapper

            executor_mod.lower_op, executor_mod.lower_forward_op = (hooked(f) for f in saved)
            try:
                scope = fluid.Scope()
                for n, t in state0.items():
                    scope.set(n, t.clone())
                with passes_env(mode):
                    fluid.Executor(ab_place).run(main_p, feed=dict(feed), fetch_list=fetch,
                                              scope=scope)
            finally:
                executor_mod.lower_op, executor_mod.lower_forward_op = saved
            sums[mode], orders[mode] = seen, order
        for op_type, n in orders[test]:
            if n in sums[base] and not torch.equal(sums[test][n], sums[base][n]):
                return f"{op_type} {n}"
        return "none found"

    def on_card(exe_, scope, main_p):
        """Whether `exe_` runs on the card and every persistable of
        `main_p` in `scope` lies there (always true in the rehearsal)."""
        return rehearsal or (exe_.device.type == "cuda" and all(
            scope.get(v.name).device.type == "cuda" for v in main_p.list_vars()
            if v.persistable and scope.has(v.name)
            and isinstance(scope.get(v.name), torch.Tensor)))

    def passes_ab(tag, main_p, state0, feed, fetch, steps, want, amp_dtype=None,
                  resnet=False, per_step=False, modes=("off", "on"), exact=False):
        """`steps` steps of `main_p` from `state0` with PADDLE_TPU_PASSES=none
        ("off") and with the default passes ("on"), each arm a fresh
        Executor and scope (the same dropout keys), the arms' steps
        interleaved. BERT and the Transformer: each loss within the JAX
        package's rtol 1e-6 / atol 1e-7 (fp32) or one ulp of the AMP type,
        every persistable within 1e-6 of its largest, and the first
        differing op named where the arms are not bit-equal; they run free,
        or with `per_step` each "on" step starts from the state the "off"
        run reached before it (Lamb: fused_lamb's norms sum in another
        order, and run free those last-bit differences grow through the
        steps into tensors that are rounding noise, such as the attention K
        biases' moments, whose grads are zero but for rounding). ResNet
        (`resnet`, each step from one state too): phase 8's card-vs-CPU
        gates (the AMP loss within one bf16 ulp). Each step of each arm runs
        on the card and launches `want`, the main path's launches a step.
        Then one profiled step and one host breakdown a arm -> {arm:
        summary}; the test arm's summary holds `launches`, its timed
        steps' launches summed. `modes` names the two arms, passes_env's modes: the
        layer-scan A/B runs ("on", "scan"), where `exact` asks the arms to
        be bit-equal."""
        elapsed(f"[passes] {tag}: A/B")
        # BERT and the Transformer: deterministic algorithms in both arms.
        # Without them two runs of one program from one state are not
        # bit-equal at b 256: the embedding backward (seg_emb's, 32768 rows
        # into 2) sums in another order each run
        deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(not resnet or deterministic, warn_only=True)
        try:
            return _passes_ab(tag, main_p, state0, feed, fetch, steps, want, amp_dtype,
                              resnet, per_step or resnet, modes, exact)
        finally:
            torch.use_deterministic_algorithms(deterministic)

    def _passes_ab(tag, main_p, state0, feed, fetch, steps, want, amp_dtype, resnet,
                   per_step, modes, exact):
        base, test = modes
        arms = {}
        for mode in modes:
            scope = fluid.Scope()
            for n, t in state0.items():
                scope.set(n, t.clone())
            arms[mode] = dict(scope=scope, exe=fluid.Executor(ab_place), ms=[], losses=[],
                              stats=[], peak=0, counters={},
                              launches=dict.fromkeys(kernels.launch_counts(), 0))
        worst_loss, worst_state, worst_stat, worst_norm = 0.0, (0.0, ""), (0.0, ""), (0.0, "")
        bit_equal = True
        failed = []  # gates missed, raised after the A/B's lines are printed
        amp_worst = [(0.0, "")] * 3  # ResNet bf16: running means, variances, fc bias
        # the rehearsal's ResNet-18 at b 4 on 32x32 normalises 4 values a
        # channel in res5: one bf16 rounding flip moves its loss by more
        # than an ulp and its statistics past their gates, so there the
        # bf16 gaps are only printed
        enforce = not (rehearsal and resnet and amp_dtype)

        def state_gap(a, b):
            """-> ([(max|a-b| / max|b|, n)], [(|a-b| / |b|, n)], bit-equal)"""
            maxs, norms, same = [], [], True
            for n, tb_ in b.items():
                ta = a[n].float()
                tbf = tb_.float()
                same = same and torch.equal(a[n], tb_)
                d = (ta - tbf).abs()
                maxs.append((float(d.max()) / max(float(tbf.abs().max()), 1e-30), n))
                norms.append((float(torch.linalg.vector_norm(ta - tbf))
                              / max(float(torch.linalg.vector_norm(tbf)), 1e-30), n))
            return maxs, norms, same

        for i in range(steps):
            if per_step:
                for n, t in snapshot(main_p, arms[base]["scope"]).items():
                    arms[test]["scope"].set(n, t)
            for mode in modes:
                a = arms[mode]
                with passes_env(mode):
                    counters0 = fluid.profiler.counters()
                    if not rehearsal:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                    before = kernels.launch_counts()
                    t0 = time.perf_counter()
                    out = a["exe"].run(main_p, feed=dict(feed), fetch_list=fetch,
                                       scope=a["scope"])
                    a["ms"].append((time.perf_counter() - t0) * 1e3)
                    if not rehearsal:
                        a["peak"] = max(a["peak"], torch.cuda.max_memory_allocated())
                    got = {n: c - before[n] for n, c in kernels.launch_counts().items()}
                    for n, c in got.items():
                        a["launches"][n] += c
                if i == 0:  # the counters the passes bumped at the first run
                    a["counters"] = {k: v - counters0.get(k, 0) for k, v in
                                     fluid.profiler.counters().items()
                                     if k.startswith("scan_fused") and v != counters0.get(k, 0)}
                require(on_card(a["exe"], a["scope"], main_p),
                        f"[{tag}] {mode}: step {i + 1} did not run on the card")
                require(rehearsal or got == want, f"[{tag}] {mode}: step {i + 1} launched "
                        f"{got}, the main path {want} a step")
                a["losses"].append(float(np.asarray(out[0]).reshape(-1)[0]))
                a["stats"].append(a["exe"].last_pass_stats)
                require(a["exe"].recomputed_forwards == [],
                        f"[{tag}] {mode}: an __auto_grad__ re-ran a forward: "
                        f"{a['exe'].recomputed_forwards}")
            l_off, l_on = arms[base]["losses"][-1], arms[test]["losses"][-1]
            bit_equal = bit_equal and l_off == l_on
            if amp_dtype:
                loss_ok = abs(l_on - l_off) <= ulp(l_off, amp_dtype) or not enforce
            elif resnet:
                loss_ok = abs(l_on - l_off) <= RN_LOSS_RTOL * abs(l_off)
            else:
                loss_ok = abs(l_on - l_off) <= PASS_AB_ATOL + PASS_AB_RTOL * abs(l_off)
            if not loss_ok:
                failed.append(f"step {i + 1}: losses {l_on} (on) vs {l_off} (off)")
            worst_loss = max(worst_loss, abs(l_on - l_off) / max(abs(l_off), 1e-30))
            if per_step:
                on_state = snapshot(main_p, arms[test]["scope"])
                off_state = snapshot(main_p, arms[base]["scope"])
                maxs, norms, same = state_gap(on_state, off_state)
                bit_equal = bit_equal and same
                worst_state = max([worst_state] + maxs)
                worst_stat = max([worst_stat] + [m for m in maxs
                                                 if m[1].endswith((".mean", ".var"))])
                worst_norm = max([worst_norm] + [m for m in norms
                                                 if not m[1].endswith((".mean", ".var"))])
                if resnet and amp_dtype:
                    for n, t in off_state.items():
                        d = float((on_state[n].float() - t.float()).abs().max())
                        big = max(float(t.float().abs().max()), 1e-30)
                        for k, (ends, gap_) in enumerate((
                                (".mean", d), (".var", d / big),
                                ("fc_0.w_1_velocity_0", d / big))):
                            if n.endswith(ends):
                                amp_worst[k] = max(amp_worst[k], (gap_, n))
        if resnet and amp_dtype:
            # bf16: the gates of tests/test_torch_resnet.py's AMP step. The
            # two layouts' convolutions round to bf16 after sums in another
            # order, and the flips move the deeper grads by up to their norm
            # (the JAX package's own bf16 grads differ from its fp32 ones so),
            # so those are not compared elementwise
            if not (amp_worst[0][0] <= 1e-2 and amp_worst[1][0] <= 2e-2
                    and amp_worst[2][0] <= 5e-2 and amp_worst[2][1]) and enforce:
                failed.append(f"running means {amp_worst[0]}, variances {amp_worst[1]}, "
                              f"the fc bias's velocity {amp_worst[2]}")
            gates = (f"running means max|diff| {amp_worst[0][0]:.3e} ({amp_worst[0][1]}; "
                     f"tol 1e-2), running variances max|diff| / max|value| "
                     f"{amp_worst[1][0]:.3e} ({amp_worst[1][1]}; tol 2e-2), the fc bias's "
                     f"velocity {amp_worst[2][0]:.3e} (tol 5e-2); parameters and "
                     f"velocities |diff| / |value| {worst_norm[0]:.3e} ({worst_norm[1]}; "
                     f"not gated in bf16)")
        elif resnet:
            if not ((worst_stat[0] <= RN_STAT_RTOL and worst_norm[0] <= RN_GRAD_NRTOL)
                    or not enforce):
                failed.append(f"running stats {worst_stat}, parameters and velocities "
                              f"{worst_norm}")
            gates = (f"running stats max|diff| / max|value| {worst_stat[0]:.3e} "
                     f"({worst_stat[1]}; tol {RN_STAT_RTOL}), parameters and velocities "
                     f"|diff| / |value| {worst_norm[0]:.3e} ({worst_norm[1]}; tol "
                     f"{RN_GRAD_NRTOL})")
        else:
            if not per_step:
                maxs, _, same = state_gap(snapshot(main_p, arms[test]["scope"]),
                                          snapshot(main_p, arms[base]["scope"]))
                bit_equal = bit_equal and same
                worst_state = max(maxs)
            if worst_state[0] > PASS_AB_STATE:
                failed.append(f"persistables: {worst_state} of their largest")
            gates = (f"persistables max|diff| / max|value| {worst_state[0]:.3e} "
                     f"({worst_state[1]}; tol {PASS_AB_STATE})")
        if exact and not bit_equal:
            failed.append("the arms are not bit-equal")
        for mode in modes:
            a = arms[mode]
            with passes_env(mode):
                step = lambda: a["exe"].run(main_p, feed=dict(feed),  # noqa: E731
                                            fetch_list=fetch, scope=a["scope"])
                a["busy"], a["idle"] = 0.0, float("nan")
                if not rehearsal:
                    wall, busy, _ = profile_step(torch, step, f"{tag}, passes {mode}")
                    a["busy"], a["idle"] = busy, max(0.0, 1 - busy / wall)
                a["host"] = host_breakdown(step, f"host {tag}, passes {mode}")
        pass_note(f"{tag} A/B", arms[test]["stats"][:2])
        for mode in modes:
            a = arms[mode]
            a["p50"] = statistics.median(a["ms"][1:])
            opt_rows = {t: v for t, v in a["host"][2].items() if t in (
                "sgd", "momentum", "adam", "adamw", "lamb", "fused_sgd", "fused_momentum",
                "fused_adam", "fused_adamw", "fused_lamb")}
            top = sorted(a["host"][2].items(), key=lambda kv: -kv[1][0])[:4]
            print(f"[passes] {tag}, passes {mode}: step p50 {a['p50']:.2f} ms over steps "
                  f"2-{steps} (steps {[round(x, 2) for x in a['ms']]}); busy "
                  f"{a['busy']:.2f} ms, idle {a['idle']:.2f}; host issue "
                  f"{a['host'][1]:.2f} ms of a {a['host'][0]:.2f} ms step, top "
                  f"{[(t, round(v[0], 2), v[1]) for t, v in top]}, optimizer "
                  f"{[(t, round(v[0], 2), v[1]) for t, v in opt_rows.items()]}; "
                  f"max_memory_allocated {a['peak'] / 2**20:.0f} MiB (both arms' state "
                  f"held); card {smi}")
        diff_at = "" if bit_equal or resnet else (
            f"; first differing op {first_diff_op(main_p, state0, feed, fetch, modes)}")
        print(f"[passes] {tag}: losses {base} {arms[base]['losses']}, {test} "
              f"{arms[test]['losses']}, max rel diff {worst_loss:.3e}; {gates}; "
              f"bit-equal {bit_equal}{diff_at}")
        require(not failed, f"[{tag}] passes {test} vs {base}: {'; '.join(failed)}")
        return {m: dict(p50=arms[m]["p50"], busy=arms[m]["busy"], idle=arms[m]["idle"],
                        host=arms[m]["host"][1], peak=arms[m]["peak"],
                        ops=(arms[m]["stats"][0] or {}).get("ops_after"),
                        counters=arms[m]["counters"], launches=arms[m]["launches"])
                for m in arms}

    elapsed("phase 2")
    # ---- 2. build -------------------------------------------------------
    if not rehearsal:
        t0 = time.perf_counter()
        libs = _build.build_all()
        print(f"[build] {len(libs)} kernels built ({time.perf_counter() - t0:.1f} s here, "
              f"after the build phase 1 started) into {_build.build_dir()}")
        for line in (_build.build_dir() / "ptxas.log").read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print(f"[build] {line.strip()}")

    elapsed("phase 3")
    # ---- 3. kernels -----------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def attn_inputs(shape, layout, dtype, bias_kind):
        b, h, sq, sk, d = shape
        tdt = getattr(torch, dtype)
        qs = (b, sq, h, d) if layout == "bshd" else (b, h, sq, d)
        ks = (b, sk, h, d) if layout == "bshd" else (b, h, sk, d)
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(tdt) for s in (qs, ks, ks))
        bias = None
        if bias_kind:  # BERT's padded keys: -1e4 past a random length >= 1
            lengths = torch.randint(1, sk + 1, (b, 1), generator=gen, device=dev)
            bias = torch.where(torch.arange(sk, device=dev)[None, :] < lengths,
                               0.0, -1e4).float().contiguous()
        return q, k, v, bias

    def timed_ms(fn, iters=20):
        fn()
        if rehearsal:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        # hold the stream in a ~50 ms device-side spin while the host
        # queues every launch, so the events time the kernels back to back
        # and not the host's launch overhead
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def sdpa_ms(q, k, v, bias, causal, layout):
        """F.scaled_dot_product_attention on the same inputs (yardstick
        only: the port never calls it)."""
        if layout == "bshd":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.zeros(q.shape[0], 1, sq, sk, device=dev)
        if bias is not None:
            mask = mask + bias[:, None, None, :]
        if causal:
            live = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
            mask = mask.masked_fill(~live, -1e30)
        mask = mask.to(q.dtype)
        f = torch.nn.functional.scaled_dot_product_attention
        return timed_ms(lambda: f(q, k, v, attn_mask=mask))

    def attention_program(shape, dtype, causal):
        """q, k, v (bhsd) and a [b, sk] key bias into one
        fused_multihead_attention op -> (program, out var)."""
        b, h, sq, sk, d = shape
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()), fluid.unique_name.guard():
            q = layers.data("q", [b, h, sq, d], dtype=dtype, append_batch_size=False)
            k = layers.data("k", [b, h, sk, d], dtype=dtype, append_batch_size=False)
            v = layers.data("v", [b, h, sk, d], dtype=dtype, append_batch_size=False)
            bias = layers.data("bias", [b, sk], append_batch_size=False)
            out = layers.fused_multihead_attention(
                q, k, v, key_bias=bias, causal=causal, sm_scale=1.0 / math.sqrt(d),
                is_test=True, layout="bhsd")
        return prog, out

    exe = fluid.Executor(fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0))

    def op_runner(shape, dtype, causal, q, k, v, bias):
        prog, out = attention_program(shape, dtype, causal)
        feed = {"q": q, "k": k, "v": v, "bias": bias}
        return lambda: exe.run(prog, feed=feed, fetch_list=[out], return_numpy=False)[0]

    # (kernel, shape b h sq sk d, layout, bias, causal, via the op)
    if rehearsal:
        checks = [("mha_short_fwd", (2, 4, 32, 32, 16), "bshd", True, False, False),
                  ("mha_short_fwd", (1, 2, 20, 13, 16), "bshd", False, True, False),
                  ("flash_fwd", (1, 2, 600, 600, 16), "bhsd", True, True, True),
                  ("mha_short_fwd", (2, 4, 16, 16, 16), "bshd", True, True, False),
                  ("mha_short_fwd", (8, 4, 32, 32, 16), "bshd", True, False, False)]
    else:
        checks = [("mha_short_fwd", (8, 12, 128, 128, 64), "bshd", True, False, False),
                  ("mha_short_fwd", (8, 12, 128, 128, 64), "bhsd", True, False, False),
                  ("mha_short_fwd", (8, 12, 512, 512, 64), "bshd", True, False, False),
                  ("mha_short_fwd", (2, 12, 100, 77, 64), "bshd", False, True, False),
                  ("flash_fwd", (2, 12, 2048, 2048, 64), "bhsd", True, True, True),
                  ("flash_fwd", (2, 12, 1000, 1000, 64), "bhsd", True, False, True),
                  # the Transformer's (phase 9): the decoder's causal
                  # self-attention and the encoder's and cross-attention's,
                  # each with its [b, s] key bias from the padding masks
                  ("mha_short_fwd", (TF_BATCH, 8, TF_SEQ, TF_SEQ, 64), "bshd", True, True, False),
                  ("mha_short_fwd", (TF_BATCH, 8, TF_SEQ, TF_SEQ, 64), "bshd", True, False,
                   False),
                  # the coalesced /predict path's (phase 14): buckets 1 and 64
                  ("mha_short_fwd", (1, 12, 128, 128, 64), "bshd", True, False, False),
                  ("mha_short_fwd", (64, 12, 128, 128, 64), "bshd", True, False, False)]
    kernel_fns = {"mha_short_fwd": (short_attention, short_attention_plain),
                  "flash_fwd": (flash_attention, flash_attention_plain)}
    results = {}
    for name, shape, layout, bias_kind, causal, via_op in checks:
        wrapper, plain = kernel_fns[name]
        for dtype in KERNEL_DTYPES:
            q, k, v, bias = attn_inputs(shape, layout, dtype, bias_kind)
            kw = dict(bias=bias, causal=causal, layout=layout)
            if via_op:
                run = op_runner(shape, dtype, causal, q, k, v, bias)
            else:
                run = lambda: wrapper(q, k, v, **kw)[0]  # noqa: E731
            before = kernels.launch_counts()[name]
            out = run()
            if not rehearsal:
                torch.cuda.synchronize()
                require(kernels.launch_counts()[name] == before + 1,
                        f"{name}: the run did not launch the kernel")
            ref = plain(q, k, v, **kw)[0]
            err = float((out.float() - ref.float()).abs().max())
            tol = kernel_tol(dtype, ref)
            require(err <= tol, f"{name} {shape} {dtype}: max abs err {err} > tol {tol}")
            ms = timed_ms(run)
            plain_ms = timed_ms(lambda: plain(q, k, v, **kw))
            lib_ms = sdpa_ms(q, k, v, bias, causal, layout)
            work = attention_work(shape, dtype, bias_kind, causal)
            bound, bound_by = bound_ms(work, dtype, peaks)
            # on the tensor cores; the FMA bound for reference
            extra = f" bound_fma_ms {bound:.4f} ({bound_by})"
            bound, bound_by = bound_ms(work, dtype, peaks, tensor_cores=True)
            print(f"[kernels] {name} b,h,sq,sk,d={shape} {layout} {dtype} "
                  f"bias={bias_kind} causal={causal} via_op={via_op}: max_abs_err "
                  f"{err:.3e} (tol {tol:.3e}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {lib_ms:.4f} bound_ms {bound:.4f} ({bound_by}){extra}")
            results.setdefault(name, []).append(dict(
                shape=shape, dtype=dtype, err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=bound_by))
            if name == "mha_short_fwd" and not rehearsal:
                # where the cutover lies: the flash kernel at the same shape
                ms_flash = timed_ms(lambda: flash_attention(q, k, v, **kw)[0])
                print(f"[kernels] flash_fwd at the same shape: ms {ms_flash:.4f}")
    # dropout: the murmur mask in CUDA against the plain version's
    for name, (wrapper, plain) in kernel_fns.items():
        for dtype in KERNEL_DTYPES:
            q, k, v, bias = attn_inputs((2, 4, 100, 77, 64), "bshd", dtype, True)
            kw = dict(bias=bias, causal=True, dropout=0.2, seed=1234, layout="bshd")
            if name == "flash_fwd":
                q = q[:, :64]  # sq <= sk: every row keeps a live key
            ref = plain(q, k, v, **kw)[0]
            err = float((wrapper(q, k, v, **kw)[0].float() - ref.float()).abs().max())
            require(err <= kernel_tol(dtype, ref), f"{name} dropout {dtype}: max abs err {err}")
            print(f"[kernels] {name} dropout 0.2 {dtype}: max abs err {err:.3e}")

    def sdpa_bwd_ms(q, k, v, bias, causal, layout, dout):
        """The backward alone of F.scaled_dot_product_attention on the same
        inputs: torch.autograd.grad on its output (yardstick only)."""
        if layout == "bshd":
            q, k, v, dout = (t.transpose(1, 2) for t in (q, k, v, dout))
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.zeros(q.shape[0], 1, sq, sk, device=dev)
        if bias is not None:
            mask = mask + bias[:, None, None, :]
        if causal:
            live = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
            mask = mask.masked_fill(~live, -1e30)
        out = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask.to(q.dtype))
        return timed_ms(lambda: torch.autograd.grad(out, (q, k, v), dout,
                                                    retain_graph=True))

    # the backward kernels, each at its main path's shape: D at BERT's
    # training shape (with dropout 0.1), in bhsd and causal sq > sk too;
    # E at the long-sequence step's, then at s 1000 without causal (no
    # tile skipped, ragged tiles); C at the encoder's rows and mlm.ln's;
    # D and C at the Transformer's shapes too (phase 9)
    if rehearsal:
        bwd_checks = [("mha_short_bwd", (2, 4, 32, 32, 16), "bshd", True, False, 0.1),
                      ("mha_short_bwd", (2, 4, 32, 32, 16), "bhsd", True, False, 0.1),
                      ("mha_short_bwd", (1, 2, 20, 13, 16), "bshd", False, True, 0.0),
                      ("flash_bwd", (1, 2, 600, 600, 16), "bhsd", True, True, 0.0),
                      ("flash_bwd", (1, 2, 100, 100, 16), "bhsd", True, False, 0.0),
                      ("mha_short_bwd", (2, 4, 16, 16, 16), "bshd", True, True, 0.1)]
        ln_checks = [(64, 64), (10, 64), (10, 33), (64, 512)]
    else:
        bwd_checks = [("mha_short_bwd", (8, 12, 128, 128, 64), "bshd", True, False, 0.1),
                      ("mha_short_bwd", (8, 12, 128, 128, 64), "bhsd", True, False, 0.1),
                      ("mha_short_bwd", (2, 12, 100, 77, 64), "bshd", False, True, 0.0),
                      ("flash_bwd", (2, 12, 2048, 2048, 64), "bhsd", True, True, 0.0),
                      ("flash_bwd", (2, 12, 1000, 1000, 64), "bhsd", True, False, 0.0),
                      # the Transformer's (phase 9), with its attention dropout
                      ("mha_short_bwd", (TF_BATCH, 8, TF_SEQ, TF_SEQ, 64), "bshd", True, True,
                       0.1),
                      ("mha_short_bwd", (TF_BATCH, 8, TF_SEQ, TF_SEQ, 64), "bshd", True, False,
                       0.1)]
        # BERT's encoder rows and mlm.ln's, a ragged n, the register path's
        # widest row, a width on the general path, and the Transformer's
        # rows (b 256 x s 64 at d_model 512)
        ln_checks = [(1024, 768), (160, 768), (1100, 128), (4096, 1024), (1024, 4096),
                     (TF_BATCH * TF_SEQ, 512)]
    # the two launches of each backward kernel, read apart by torch.profiler
    bwd_launches = {"mha_short_bwd": ("short_bwd_dkv_kernel", "short_bwd_dq_kernel"),
                    "flash_bwd": ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")}
    bwd_fns = {"mha_short_bwd": (short_attention, short_attention_bwd,
                                 short_attention_bwd_plain),
               "flash_bwd": (flash_attention, flash_attention_bwd, flash_attention_bwd_plain)}
    for name, shape, layout, bias_kind, causal, dropout in bwd_checks:
        fwd, wrapper, plain = bwd_fns[name]
        for dtype in KERNEL_DTYPES:
            q, k, v, bias = attn_inputs(shape, layout, dtype, bias_kind)
            # dO scaled so the bf16 grads stay below 2, where one bf16 ulp
            # is under the 2e-2 tolerance
            dout = (0.25 * torch.randn(q.shape, generator=gen, device=dev)).to(q.dtype)
            kw = dict(causal=causal, dropout=dropout, seed=4321, layout=layout)
            out, lse = fwd(q, k, v, bias=bias, **kw)
            delta = attention_delta(out, dout, layout)
            args_ = (q, k, v, bias, dout, lse, delta)
            before = kernels.launch_counts()[name]
            got = wrapper(*args_, **kw)
            if not rehearsal:
                torch.cuda.synchronize()
                require(kernels.launch_counts()[name] == before + 1,
                        f"{name}: the run did not launch the kernel")
            ref = plain(*args_, **kw)
            # dq, dk, dv each at its own gate
            errs = [float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref)]
            tols = [kernel_tol(dtype, r) for r in ref]
            err, tol = max(errs), max(tols)
            require(all(e <= t for e, t in zip(errs, tols)),
                    f"{name} {shape} {dtype}: max abs errs {errs} > tols {tols}")
            ms = timed_ms(lambda: wrapper(*args_, **kw))
            plain_ms = timed_ms(lambda: plain(*args_, **kw))
            lib_ms = sdpa_bwd_ms(q, k, v, bias, causal, layout, dout)
            work = attention_bwd_work(shape, dtype, bias_kind, causal)
            bound, bound_by = bound_ms(work, dtype, peaks)
            # on the tensor cores; the FMA bound for reference
            extra = f" bound_fma_ms {bound:.4f} ({bound_by})"
            bound, bound_by = bound_ms(work, dtype, peaks, tensor_cores=True)
            print(f"[kernels] {name} b,h,sq,sk,d={shape} {layout} {dtype} bias={bias_kind} "
                  f"causal={causal} dropout={dropout}: max_abs_err {err:.3e} (tol "
                  f"{tol:.3e}) ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                  f"{lib_ms:.4f} (sdpa backward) bound_ms {bound:.4f} ({bound_by}){extra}")
            results.setdefault(name, []).append(dict(
                shape=shape, dtype=dtype, err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=bound_by))
            first = next(c for c in bwd_checks if c[0] == name)
            if (shape, layout) == first[1:3] and not rehearsal:
                # once at its first shape: the device time of each of the two launches
                dkv, dq = bwd_launches[name]
                per = kernel_device_ms(torch, lambda: wrapper(*args_, **kw), (dkv, dq))
                bounds = ""
                if name == "flash_bwd":  # each launch's own bound, tensor cores
                    lw = flash_bwd_launch_work(shape, dtype, bias_kind, causal)
                    bounds = "; bound_ms by launch (its own bytes and FLOPs): " + ", ".join(
                        "{} {:.4f} ({})".format(tag, *bound_ms(lw[tag], dtype, peaks,
                                                               tensor_cores=True))
                        for tag in ("dkv", "dq"))
                print(f"[kernels] {name} {shape} {layout} {dtype} by launch (torch.profiler): "
                      f"launch 1 (dK, dV) ms {per[dkv]}, launch 2 (dQ) ms {per[dq]}{bounds}")
    # the seed in device memory (the TPU kernels' seed_ref; a static step's
    # seed slot, which Executor.run_repeated's CUDA graph reads at each
    # replay): each of #1-#7 launched with a device word as its dropout
    # seed, against the launch with the same word by value (bit for bit) and
    # the plain version given the same device word (at the kernel's gate)
    word = 0x9E3779B9
    slot = torch.tensor(word - (1 << 32), dtype=torch.int32, device=dev)
    sb, ss, sl = (2, 4, 32) if rehearsal else (8, 12, 128)
    fb_, fs = (1, 2) if rehearsal else (2, 12)
    flash_s = 96 if rehearsal else 1000
    ptr_checks = [  # kernel, the TPU kernels, b h sq sk d, layout, dtype, causal
        ("mha_short_fwd", "#1", (sb, ss, sl, sl, 64), "bshd", "float32", False),
        ("mha_short_fwd", "#2", (sb, ss, sl, sl, 64), "bhsd", "bfloat16", False),
        ("flash_fwd", "#3", (fb_, fs, flash_s, flash_s, 64), "bhsd", "float32", True),
        ("flash_bwd", "#4 #5", (fb_, fs, flash_s, flash_s, 64), "bhsd", "float32", True),
        ("mha_short_bwd", "#6", (sb, ss, sl, sl, 64), "bhsd", "bfloat16", False),
        ("mha_short_bwd", "#7", (sb, ss, sl, sl, 64), "bshd", "float32", False)]
    seed_ptr = {}
    for name, which, shape, layout, dtype, causal in ptr_checks:
        q, k, v, bias = attn_inputs(shape, layout, dtype, True)
        kw = dict(causal=causal, dropout=0.1, layout=layout)
        if name in kernel_fns:
            wrapper, plain = kernel_fns[name]
            run = lambda sd: wrapper(q, k, v, bias=bias, seed=sd, **kw)[:1]  # noqa: E731
            ref = plain(q, k, v, bias=bias, seed=slot, **kw)[:1]
        else:
            fwd, wrapper, plain = bwd_fns[name]
            out, lse = fwd(q, k, v, bias=bias, seed=word, **kw)
            dout = (0.25 * torch.randn(q.shape, generator=gen, device=dev)).to(q.dtype)
            args_ = (q, k, v, bias, dout, lse, attention_delta(out, dout, layout))
            run = lambda sd: wrapper(*args_, seed=sd, **kw)  # noqa: E731
            ref = plain(*args_, seed=slot, **kw)
        before = kernels.launch_counts()[name]
        by_ptr, by_value = run(slot), run(word)
        if not rehearsal:
            torch.cuda.synchronize()
            require(kernels.launch_counts()[name] == before + 2,
                    f"{name}: the seed-pointer runs did not launch the kernel")
        bit = all(torch.equal(a, c) for a, c in zip(by_ptr, by_value))
        errs = [float((g.float() - r.float()).abs().max()) for g, r in zip(by_ptr, ref)]
        tols = [kernel_tol(dtype, r) for r in ref]
        require(bit and all(e <= tl for e, tl in zip(errs, tols)),
                f"{name} {which} seed from device memory {shape} {layout} {dtype}: bit-equal "
                f"to the by-value launch {bit}; max abs errs {errs} against tols {tols}")
        seed_ptr.setdefault(name, []).append(dict(
            kernels=which, shape=list(shape), layout=layout, dtype=dtype, launches=1,
            bit_equal_to_by_value=bit, max_abs_err=max(errs), tol=max(tols)))
        print(f"[kernels] {name} ({which}) b,h,sq,sk,d={shape} {layout} {dtype} causal={causal} "
              f"dropout 0.1, the seed a device word: bit-equal to the by-value launch; max abs "
              f"err {max(errs):.3e} against the plain version (tol {max(tols):.3e})")
        del q, k, v, bias, ref, by_ptr, by_value

    # a tensor-parallel rank's heads: each of #1-#7 launched over the second
    # half of a 12-head problem (heads_global 12, head0 6, dropout 0.1), its
    # out and lse (dQ, dK, dV with the sliced dO) bit-equal to the same heads'
    # slice of the whole launch, and within its gate of the plain version
    half_heads = {}
    HH = 4 if rehearsal else 12
    for name, which, shape, layout, dtype, causal in ptr_checks:
        b_, _, sq_, sk_, d_ = shape
        shape = (b_, HH, sq_, sk_, d_)
        h0 = HH // 2
        q, k, v, bias = attn_inputs(shape, layout, dtype, True)
        kw = dict(causal=causal, dropout=0.1, seed=word, layout=layout)

        def heads(t):
            return (t[:, :, h0:] if layout == "bshd" else t[:, h0:]).contiguous()

        fwd = kernel_fns[name][0] if name in kernel_fns else bwd_fns[name][0]
        out, lse = fwd(q, k, v, bias=bias, **kw)
        hq, hk, hv = heads(q), heads(k), heads(v)
        sub = dict(kw, heads_global=HH, head0=h0)
        before = kernels.launch_counts()[name]
        if name in kernel_fns:
            wrapper, plain = kernel_fns[name]
            got = wrapper(hq, hk, hv, bias=bias, **sub)
            want = (heads(out), lse[:, h0:])
            ref = plain(hq, hk, hv, bias=bias, **sub)
        else:
            _, wrapper, plain = bwd_fns[name]
            dout = (0.25 * torch.randn(q.shape, generator=gen, device=dev)).to(q.dtype)
            delta = attention_delta(out, dout, layout)
            want = tuple(heads(g) for g in wrapper(q, k, v, bias, dout, lse, delta, **kw))
            before = kernels.launch_counts()[name]
            args_ = (hq, hk, hv, bias, heads(dout), lse[:, h0:].contiguous(),
                     delta[:, h0:].contiguous())
            got = wrapper(*args_, **sub)
            ref = plain(*args_, **sub)
        if not rehearsal:
            torch.cuda.synchronize()
            require(kernels.launch_counts()[name] == before + 1,
                    f"{name}: the half-head run did not launch the kernel")
        bit = all(torch.equal(a, c) for a, c in zip(got, want))
        errs = [float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref)]
        tols = [kernel_tol(dtype, r) for r in ref]
        require(bit and all(e <= tl for e, tl in zip(errs, tols)),
                f"{name} {which} heads {h0}-{HH - 1} of {HH} {shape} {layout} {dtype}: "
                f"bit-equal to the whole launch's slice {bit}; max abs errs {errs} against "
                f"tols {tols}")
        half_heads.setdefault(name, []).append(dict(
            kernels=which, shape=list(shape), heads_global=HH, head0=h0, layout=layout,
            dtype=dtype, launches=1, bit_equal_to_whole_slice=bit, max_abs_err=max(errs),
            tol=max(tols)))
        print(f"[kernels] {name} ({which}) heads {h0}-{HH - 1} of {HH}, b,h,sq,sk,d="
              f"{(b_, HH - h0, sq_, sk_, d_)} {layout} {dtype} causal={causal} dropout 0.1: "
              f"bit-equal to the whole launch's slice; max abs err {max(errs):.3e} against the "
              f"plain version (tol {max(tols):.3e})")
        del q, k, v, bias, got, want, ref

    for n, k in ln_checks:
        for dtype in KERNEL_DTYPES:
            x = (2 * torch.randn(n, k, generator=gen, device=dev) + 0.5).to(getattr(torch, dtype))
            dy = torch.randn(n, k, generator=gen, device=dev).to(x.dtype)
            xf = x.float()
            mean = xf.mean(1)
            rstd = torch.rsqrt(xf.var(1, unbiased=False) + 1e-5)
            scale = torch.rand(k, generator=gen, device=dev) + 0.5
            args_ = (x, dy, mean, rstd, scale)
            before = kernels.launch_counts()["layer_norm_bwd"]
            got = ln_bwd(*args_)
            path = "plain"
            if not rehearsal:
                torch.cuda.synchronize()
                require(kernels.launch_counts()["layer_norm_bwd"] == before + 1,
                        "layer_norm_bwd: the run did not launch the kernel")
                require(all(torch.equal(a, b) for a, b in zip(got, ln_bwd(*args_))),
                        f"layer_norm_bwd n={n} k={k} {dtype}: two launches differ")
                geo, blocks = ln_bwd_plan(x, dy, scale)
                per_call, sessions = kernels.device_kernels(lambda: ln_bwd(*args_))
                require(len(per_call) == 1 and "layer_norm_bwd" in next(iter(per_call))
                        and next(iter(per_call.values())) == 1,
                        f"layer_norm_bwd n={n} k={k} {dtype}: device kernels a call "
                        f"{per_call} ({sessions} profiler sessions), want one launch "
                        "of the kernel")
                path = (f"{geo.path}, {geo.warps} warps x {blocks} blocks; device kernels "
                        f"a call (torch.profiler, {sessions} sessions) {per_call}")
            ref = ln_bwd_plain(*args_)
            # dx at the dtype's tolerance; dscale / dbias sum n rows in fp32
            err = float((got[0].float() - ref[0].float()).abs().max())
            err_sums = max(float((g - r).abs().max() / max(1.0, float(r.abs().max())))
                           for g, r in zip(got[1:], ref[1:]))
            tol = kernel_tol(dtype, ref[0])
            require(err <= tol and err_sums <= TOL["float32"],
                    f"layer_norm_bwd n={n} k={k} {dtype}: max abs err {err}, "
                    f"dscale/dbias rel err {err_sums}")
            ms = timed_ms(lambda: ln_bwd(*args_))
            plain_ms = timed_ms(lambda: ln_bwd_plain(*args_))
            # the library call with the stats its own forward saves
            w, bb = scale.to(x.dtype), torch.zeros(k, device=dev, dtype=x.dtype)
            _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [k], w, bb, 1e-5)
            lib_ms = timed_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [k], lmean, lrstd, w, bb, [True, True, True]))
            bound, bound_by = ln_bwd_bound_ms(n, k, dtype, peaks)
            print(f"[kernels] layer_norm_bwd n={n} k={k} {dtype}: max_abs_err {err:.3e} "
                  f"(tol {tol:.3e}), dscale/dbias rel err {err_sums:.3e}; ms {ms:.4f} "
                  f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
                  f"(native_layer_norm_backward) bound_ms {bound:.4f} ({bound_by}); "
                  f"bit for bit over two launches; {path}")
            results.setdefault("layer_norm_bwd", []).append(dict(
                shape=(n, k), dtype=dtype, err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=bound_by))

    # the fused-block kernels (#9, #10) at the A/B's shapes: the three
    # ResNet-50 b256 bottleneck 1x1 shapes in bf16, and stage 4 in fp32
    fb_shapes = ([(name, 1024, k, n) for name, _, k, n in fb.SHAPES] if rehearsal
                 else fb.SHAPES)
    fb_checks = [(shape, "bfloat16") for shape in fb_shapes] + [(fb_shapes[-1], "float32")]
    for (sname, m, k, n), dtype in fb_checks:
        x, scale, shift, res, w = fb.make_inputs(m, k, n, getattr(torch, dtype), dev, args.seed)
        runs = {
            "fused_prologue_conv1x1": (
                lambda: fb.fused_prologue_conv1x1(x, scale, shift, res, w),
                lambda: fb.fused_prologue_conv1x1_plain(x, scale, shift, res, w),
                lambda: fb.prologue_twin(x, scale, shift, res, w)),
            "conv1x1_with_stats": (
                lambda: fb.conv1x1_with_stats(x, w),
                lambda: fb.conv1x1_with_stats_plain(x, w),
                lambda: fb.stats_twin(x, w)),
        }
        for name, (run, plain, twin) in runs.items():
            before = kernels.launch_counts()[name]
            got = run()
            if not rehearsal:
                torch.cuda.synchronize()
                require(kernels.launch_counts()[name] == before + 1,
                        f"{name}: the run did not launch the kernel")
            ref = plain()
            got, ref = (got, ref) if name == "conv1x1_with_stats" else ((got,), (ref,))
            yerr = fb.y_err(got[0], ref[0])
            serr = max((fb.sum_err(g, r) for g, r in zip(got[1:], ref[1:])), default=0.0)
            err = float((got[0].float() - ref[0].float()).abs().max())
            require(yerr <= 0 and serr <= fb.SUM_RTOL,
                    f"{name} {sname} {dtype}: y beyond |a-b| <= {fb.Y_RTOL[x.dtype]:.2e}|b| + "
                    f"{fb.Y_ATOL[x.dtype]} by {yerr}; sums rel err {serr} (tol {fb.SUM_RTOL})")
            del got, ref
            ms = timed_ms(run)
            plain_ms = timed_ms(plain)
            lib_ms = timed_ms(twin)
            # the product alone, as a yardstick for the kernel's GEMM part
            matmul_ms = timed_ms(lambda: torch.matmul(x, w))
            bound, bound_by = fused_block_bound_ms(name, m, k, n, dtype, peaks)
            fma, fma_by = fused_block_bound_ms(name, m, k, n, dtype, peaks,
                                               tensor_cores=False)
            launches_ms = ""
            if not rehearsal:  # each launch's device time (torch.profiler)
                names = ("fused_block_gemm_kernel",) + (
                    ("fused_block_stats_reduce_kernel",) if name == "conv1x1_with_stats" else ())
                per = kernel_device_ms(torch, run, names)
                launches_ms = "; device ms by launch (torch.profiler): " + ", ".join(
                    f"{launch} {per[launch]}" for launch in names)
            print(f"[kernels] {name} {sname} M,K,N={m},{k},{n} {dtype}: max_abs_err {err:.3e} "
                  f"(each y within {fb.Y_RTOL[x.dtype]:.2e}|y| + {fb.Y_ATOL[x.dtype]}), sums "
                  f"rel err {serr:.3e} (tol {fb.SUM_RTOL}); ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {lib_ms:.4f} (unfused torch twin) torch.matmul_ms {matmul_ms:.4f} "
                  f"bound_ms {bound:.4f} ({bound_by}, tensor cores"
                  f"{f'; fp32 FMA {fma:.4f}, {fma_by}' if dtype == 'float32' else ''}); "
                  f"{bound / ms:.1%} of the bound, "
                  f"{2 * m * k * n / ms / 1e9:.1f} TFLOP/s{launches_ms}")
            results.setdefault(name, []).append(dict(
                shape=(m, k, n), dtype=dtype, err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=bound_by))
        del x, scale, shift, res, w

    elapsed("phase 4")
    # ---- 4. serve: BERT-base over HTTP ----------------------------------
    zero_launches = {name: 0 for name in kernels.LAUNCHES}
    if not rehearsal:  # peak memory of the serving path, not of phase 3
        torch.cuda.reset_peak_memory_stats()
    cfg = BertConfig.tiny() if rehearsal else BertConfig.base()
    b, s = (2, 32) if rehearsal else (8, 128)
    main_prog, startup = fluid.Program(), fluid.Program()
    main_prog.random_seed = startup.random_seed = args.seed + 1
    with fluid.program_guard(main_prog, startup), fluid.unique_name.guard():
        feeds = [layers.data(n, [b, s], dtype="int64", append_batch_size=False)
                 for n in ("src_ids", "sent_ids", "pos_ids")]
        mask = layers.data("input_mask", [b, s], append_batch_size=False)
        hidden = bert_encoder(*feeds, mask, cfg, is_test=True)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    model_dir = ROOT / "build" / "chip_smoke" / "bert"
    shutil.rmtree(model_dir, ignore_errors=True)
    feed_names = ["src_ids", "sent_ids", "pos_ids", "input_mask"]
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(model_dir), feed_names, [hidden], exe,
                                      main_program=main_prog)
    del scope
    print(f"[slice] BERT hidden {cfg.hidden_size} x {cfg.num_layers} layers, "
          f"b {b} s {s}: startup + export {time.perf_counter() - t0:.1f} s")

    srv = InferenceServer(str(model_dir), device=dev.type, port=0)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    rs = np.random.RandomState(args.seed)
    requests = []
    for _ in range(REQUESTS):
        lengths = rs.randint(s // 8, s + 1, size=b)
        requests.append({
            "src_ids": rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int64),
            "sent_ids": (np.arange(s)[None, :] >= lengths[:, None] // 2).astype(np.int64),
            "pos_ids": np.tile(np.arange(s, dtype=np.int64), (b, 1)),
            "input_mask": (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32),
        })
    long_shape = (2, 12, 2048, 2048, 64) if not rehearsal else (1, 2, 600, 600, 16)
    long_in = attn_inputs(long_shape, "bhsd", "float32", True)
    long_run = op_runner(long_shape, "float32", True, *long_in)

    # the serving path's run: every count from 0, N requests, then one
    # long-sequence program through the same op (the flash branch, which
    # BERT's max_position of 512 never reaches)
    replies, latencies = [], []
    kernels.reset_launch_counts()
    t_loop = time.perf_counter()
    for feed in requests:
        buf = io.BytesIO()
        np.savez(buf, **feed)
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/predict", data=buf.getvalue()),
                timeout=300) as r:
            require(r.status == 200, f"/predict answered {r.status}")
            replies.append(np.load(io.BytesIO(r.read()))[hidden.name])
        latencies.append(time.perf_counter() - t0)
    loop_s = time.perf_counter() - t_loop
    # startup, export, the server's warmup and the requests, nothing after
    peak_mem = torch.cuda.max_memory_allocated() if not rehearsal else 0
    long_out = long_run()
    if not rehearsal:
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    path_launches = {"serve": launches}
    srv.shutdown()
    server_thread.join(30)
    print(f"[slice] launches over {len(requests)} requests + 1 long-sequence run: {launches}")
    if not rehearsal:
        require(launches["mha_short_fwd"] == cfg.num_layers * len(requests),
                f"short kernel launched {launches['mha_short_fwd']} times, want "
                f"{cfg.num_layers} per request")
        require(launches["flash_fwd"] == 1, "the long-sequence run did not "
                "launch the flash kernel")
    ref_long = flash_attention_plain(*long_in[:3], bias=long_in[3], causal=True,
                                     layout="bhsd")[0]
    long_err = float((long_out - ref_long).abs().max())
    require(long_err <= TOL["float32"], f"long-sequence op: max abs err {long_err}")

    pred = create_paddle_predictor(AnalysisConfig(str(model_dir)) if not rehearsal
                                   else _cpu_config(AnalysisConfig, model_dir))
    cpu_pred = create_paddle_predictor(_cpu_config(AnalysisConfig, model_dir))
    worst_cpu, run_ms = 0.0, []
    for feed, reply in zip(requests, replies):
        require(reply.shape == (b, s, cfg.hidden_size) and reply.dtype == np.float32,
                f"reply shape {reply.shape} {reply.dtype}")
        require(bool(np.isfinite(reply).all()), "reply has non-finite values")
        t0 = time.perf_counter()
        direct = pred.run(dict(feed))[0]  # returns host numpy: synchronised
        run_ms.append((time.perf_counter() - t0) * 1e3)
        require(np.array_equal(reply, direct),
                "reply differs from predictor.run on the same feed")
        worst_cpu = max(worst_cpu, float(np.abs(reply - cpu_pred.run(dict(feed))[0]).max()))
    require(worst_cpu <= 1e-3, f"card vs CPU max abs diff {worst_cpu} > 1e-3")
    p50 = statistics.median(latencies) * 1e3
    print(f"[slice] {len(requests)} replies finite, bitwise equal to predictor.run; "
          f"card vs CPU max abs diff {worst_cpu:.3e} (tol 1e-3)")
    print(f"[slice] p50 request latency {p50:.2f} ms (mean "
          f"{statistics.mean(latencies) * 1e3:.2f}); p50 in-process predictor.run "
          f"{statistics.median(run_ms):.2f} ms; {b * s * len(requests) / loop_s:.0f} "
          f"tokens/s over the request loop; max_memory_allocated "
          f"{peak_mem / 2**20:.0f} MiB; card {smi}")
    if not rehearsal:
        profile_step(torch, lambda: pred.run(dict(requests[0])), "one predictor.run")
    del pred, cpu_pred

    elapsed("phase 5")
    # ---- 5. train: BERT-base masked-LM pretraining -----------------------
    tb, ts, tp = (2, 32, 5) if rehearsal else (8, 128, 20)
    train_cfg = BertConfig.tiny() if rehearsal else BertConfig.base()
    feed = bert_pretrain_feed(np, np.random.RandomState(args.seed), train_cfg, tb, ts, tp)

    def pretrain(cfg):
        main_p, startup_p = fluid.Program(), fluid.Program()
        main_p.random_seed = startup_p.random_seed = args.seed + 2
        with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
            handles = build_bert_pretrain(cfg, tb, ts, mlm_only=True, max_preds=tp)
            fluid.optimizer.Adam(LR).minimize(handles["loss"])
        return main_p, startup_p, handles["loss"]

    main_t, startup_t, loss_t = pretrain(train_cfg)
    scope_t = fluid.Scope()
    exe_t = fluid.Executor(fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe_t.run(startup_t, scope=scope_t)
    state_t0 = snapshot(main_t, scope_t)
    n_ops = len(main_t.global_block().ops)
    print(f"[train] BERT hidden {train_cfg.hidden_size} x {train_cfg.num_layers} layers, "
          f"b {tb} s {ts} max_preds {tp}, Adam({LR}), dropout "
          f"{train_cfg.hidden_dropout}: {n_ops} ops; startup {time.perf_counter() - t0:.1f} s")
    if not rehearsal:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    want = dict(zero_launches, mha_short_fwd=train_cfg.num_layers,
                mha_short_bwd=train_cfg.num_layers, layer_norm_bwd=2 * train_cfg.num_layers + 2)
    # the training path's run: every count from 0, TRAIN_STEPS steps on
    # one batch (each returns the loss to the host, which synchronises)
    losses, step_ms, per_step, train_stats = [], [], [], []
    kernels.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        loss = exe_t.run(main_t, feed=dict(feed), fetch_list=[loss_t], scope=scope_t)[0]
        step_ms.append((time.perf_counter() - t0) * 1e3)
        train_stats.append(exe_t.last_pass_stats)
        losses.append(float(loss.reshape(-1)[0]))
        per_step.append({n: c - before[n] for n, c in kernels.launch_counts().items()})
    launches = kernels.launch_counts()
    path_launches["train"] = launches
    peak_train = torch.cuda.max_memory_allocated() if not rehearsal else 0
    pass_note("train", train_stats)
    print(f"[train] losses {losses}")
    print(f"[train] launches over {TRAIN_STEPS} steps: {launches}")
    require(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    require(exe_t.recomputed_forwards == [], "an __auto_grad__ re-ran a forward: "
            f"{exe_t.recomputed_forwards}")
    if not rehearsal:
        require(all(c == want for c in per_step),
                f"launches per step {per_step}, want {want} in every step")
    tokens = tb * ts
    p50_ms = statistics.median(step_ms[1:])
    flops_step = bert_flops_per_token(train_cfg, ts, tp) * tokens
    print(f"[train] step time p50 {p50_ms:.2f} ms over steps 2-{TRAIN_STEPS} (first "
          f"{step_ms[0]:.2f} ms); {tokens / p50_ms * 1e3:.0f} tokens/s; "
          f"{flops_step / 1e12:.3f} TFLOP/step (bert_flops_per_token), "
          f"{flops_step / p50_ms / 1e9:.2f} TFLOP/s; max_memory_allocated "
          f"{peak_train / 2**20:.0f} MiB (startup state + {TRAIN_STEPS} steps); card {smi}")
    step = lambda: exe_t.run(main_t, feed=dict(feed), fetch_list=[loss_t],  # noqa: E731
                             scope=scope_t)
    if not rehearsal:
        profile_step(torch, step, "one training step")
    host_breakdown(step)
    del scope_t
    # passes off against on, from the startup state (fp32, b 8)
    pass_ab = {"train": passes_ab("train", main_t, state_t0, feed, [loss_t], TRAIN_STEPS,
                                  want)}
    del state_t0

    # card vs CPU: the same 2-layer program at base width, the same state
    # and feeds, PARITY_STEPS steps on each
    cfg2 = BertConfig.tiny() if rehearsal else BertConfig(num_layers=2)
    main_2, startup_2, loss_2 = pretrain(cfg2)
    runs = []
    for place in (fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope_2 = fluid.Scope()
        exe_2 = fluid.Executor(place)
        exe_2.run(startup_2, scope=scope_2)
        if runs:  # the CPU starts from the card's startup state
            fluid.io.set_persistables_from_numpy(scope_2, runs[0][1], "cpu")
        else:
            state0 = {v.name: to_numpy(scope_2.get(v.name)) for v in main_2.list_vars()
                      if v.persistable and scope_2.has(v.name)}
        t0 = time.perf_counter()
        ls = [float(exe_2.run(main_2, feed=dict(feed), fetch_list=[loss_2],
                              scope=scope_2)[0].reshape(-1)[0]) for _ in range(PARITY_STEPS)]
        secs = time.perf_counter() - t0
        runs.append((ls, state0 if not runs else None, scope_2, secs))
    (card_l, _, card_scope, card_s), (cpu_l, _, cpu_scope, cpu_s) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    worst, worst_name, n_far, n_all = 0.0, "", 0, 0
    for v in main_2.list_vars():
        if not v.persistable or not cpu_scope.has(v.name):
            continue
        d = np.abs(to_numpy(card_scope.get(v.name)) - to_numpy(cpu_scope.get(v.name)))
        n_far += int((d > CLOSE_ATOL).sum())
        n_all += d.size
        if d.size and float(d.max()) > worst:
            worst, worst_name = float(d.max()), v.name
    print(f"[train] card vs CPU, {cfg2.num_layers} layers at width {cfg2.hidden_size}, "
          f"{PARITY_STEPS} steps ({card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU): "
          f"losses {card_l} vs {cpu_l}, max rel diff {loss_rel:.3e} (tol {LOSS_RTOL}); "
          f"persistables max abs diff {worst:.3e} ({worst_name}; tol {PARAM_ATOL}), "
          f"{n_far} of {n_all} elements beyond {CLOSE_ATOL} (tol {CLOSE_FRAC:.0e} of them)")
    require(loss_rel <= LOSS_RTOL, f"card vs CPU losses differ by {loss_rel}")
    require(worst <= PARAM_ATOL and n_far <= CLOSE_FRAC * n_all,
            f"card vs CPU persistables: max abs diff {worst} ({worst_name}), "
            f"{n_far} of {n_all} elements beyond {CLOSE_ATOL}")
    del runs, card_scope, cpu_scope

    elapsed("phase 5b")
    # ---- 5b. amp: BERT-base pretraining under bf16 AMP ---------------------
    # bench.py:bench_bert's recipe: mlm_only, max_preds 20, mp.decorate(
    # Adam(1e-4)) in bf16 (BENCH_AMP's default), dropout 0.1, s 128; at b 8
    # and at bench.py's default b 256 (halved until it fits the card)
    def amp_pretrain(cfg, b, opt_fn=lambda: fluid.optimizer.Adam(LR), amp=None, tweak=None,
                     **kw):
        """BERT pretraining under mixed_precision.decorate(opt_fn(), **amp)
        in bf16; `tweak(main program)` runs before the optimizer ->
        (main, startup, handles, the decorated optimizer)."""
        main_p, startup_p = fluid.Program(), fluid.Program()
        main_p.random_seed = startup_p.random_seed = args.seed + 3
        with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
            handles = build_bert_pretrain(cfg, b, ts, **kw)
            if tweak:
                tweak(main_p)
            opt = mixed_precision.decorate(opt_fn(), **(amp or {}))
            opt.minimize(handles["loss"])
        return main_p, startup_p, handles, opt

    def run_steps(main_p, scope, feed, fetch, steps, exe_, tag=None):
        """`steps` steps on one batch -> (fetched values a step as floats,
        host ms a step, launches a step); with `tag`, the passes' note of
        the first two steps."""
        got, ms, per, stats = [], [], [], []
        for _ in range(steps):
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            out = exe_.run(main_p, feed=dict(feed), fetch_list=fetch, scope=scope)
            ms.append((time.perf_counter() - t0) * 1e3)
            got.append([float(np.asarray(o).reshape(-1)[0]) for o in out])
            per.append({n: c - before[n] for n, c in kernels.launch_counts().items()})
            stats.append(exe_.last_pass_stats)
        if tag:
            pass_note(tag, stats)
        return got, ms, per

    def step_report(tag, b, losses, ms, peak, flops_tok, step):
        tokens = b * ts
        p50_ = statistics.median(ms[1:])
        print(f"[{tag}] b {b}: losses {losses}; step time p50 {p50_:.2f} ms over steps "
              f"2-{len(ms)} (first {ms[0]:.2f} ms); {tokens / p50_ * 1e3:.0f} tokens/s; "
              f"{flops_tok * tokens / p50_ / 1e9:.2f} TFLOP/s (bert_flops_per_token); "
              f"max_memory_allocated {peak / 2**20:.0f} MiB; card {smi}")
        if not rehearsal:
            profile_step(torch, step, f"one {tag} step at b {b}")

    def card_vs_cpu(tag, build, feed, lr, amp_dtype="bfloat16", second=None):
        """The same program and state on the card and on the CPU,
        PARITY_STEPS steps each: each step's loss within one ulp of the
        AMP type `amp_dtype` of the CPU loss; each persistable within
        phase 5's gates (2 * lr * steps, all but CLOSE_FRAC of its elements
        within CLOSE_ATOL), each widened by one ulp of the tensor's largest
        element -> the card's launches over its steps. `second`, a
        (label, build) pair, puts another program on the card in the CPU
        run's place, from the same state, under the same gates."""
        ulp_name = {"bfloat16": "bf16", "float16": "fp16"}[amp_dtype]
        card = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)
        what = f"card vs {second[0]} on the card" if second else "card vs CPU"
        programs = [build(), second[1]() if second else None]
        runs = []
        for k, place in enumerate((card, card if second else fluid.CPUPlace())):
            main_p, startup_p, handles, _ = programs[k] or programs[0]
            scope_p = fluid.Scope()
            exe_p = fluid.Executor(place)
            exe_p.run(startup_p, scope=scope_p)
            if runs:
                fluid.io.set_persistables_from_numpy(scope_p, runs[0][1], exe_p.device)
            else:
                state = {v.name: to_numpy(scope_p.get(v.name)) for v in main_p.list_vars()
                         if v.persistable and scope_p.has(v.name)}
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            got, _, _ = run_steps(main_p, scope_p, feed, [handles["loss"]], PARITY_STEPS,
                                  exe_p)
            runs.append(([g[0] for g in got], state if not runs else None, scope_p,
                         time.perf_counter() - t0,
                         {n: c - before[n] for n, c in kernels.launch_counts().items()}))
        (card_l, _, card_scope, card_s, card_launch), (cpu_l, _, cpu_scope, cpu_s, _) = runs
        loss_ok = all(abs(a - b_) <= ulp(b_, amp_dtype) for a, b_ in zip(card_l, cpu_l))
        atol = 2 * lr * PARITY_STEPS
        worst_excess, worst_name, n_far, n_all = -1.0, "", 0, 0
        for v in main_p.list_vars():
            if not v.persistable or not cpu_scope.has(v.name):
                continue
            c = to_numpy(cpu_scope.get(v.name)).astype(np.float64)
            d = np.abs(to_numpy(card_scope.get(v.name)).astype(np.float64) - c)
            if not d.size:
                continue
            widen = ulp(float(np.abs(c).max()), amp_dtype)
            n_far += int((d > CLOSE_ATOL + widen).sum())
            n_all += d.size
            excess = float(d.max()) - (atol + widen)
            if excess > worst_excess:
                worst_excess, worst_name = excess, f"{v.name} (max abs diff {d.max():.3e})"
        print(f"[{tag}] {what}, {PARITY_STEPS} steps ({card_s:.1f} s, then {cpu_s:.1f} s): "
              f"losses {card_l} vs {cpu_l} (tol one {ulp_name} ulp "
              f"of the second loss); persistables: worst {worst_name}, {worst_excess:.3e} past "
              f"its gate {atol:.1e} + one {ulp_name} ulp of its largest element; {n_far} of "
              f"{n_all} elements beyond {CLOSE_ATOL} + that ulp (tol {CLOSE_FRAC:.0e} of "
              f"them); card launches {card_launch}")
        require(loss_ok, f"[{tag}] {what}: losses {card_l} vs {cpu_l}")
        require(worst_excess <= 0 and n_far <= CLOSE_FRAC * n_all,
                f"[{tag}] {what}: persistables: {worst_name}, {n_far} of {n_all} far")
        return card_launch

    amp_cfg = train_cfg
    amp_want = dict(zero_launches, mha_short_fwd=amp_cfg.num_layers,
                    mha_short_bwd=amp_cfg.num_layers, layer_norm_bwd=2 * amp_cfg.num_layers + 2)
    amp_batches = [2, 4] if rehearsal else [8, 256]
    amp_stats = {}  # batch -> (step p50 ms, peak bytes), beside phase 11's
    # the path's launches: the sum over its steps at each batch size (the
    # profiled and host-timed steps after them not counted)
    launches = dict(zero_launches)
    kernels.reset_launch_counts()
    for b_amp in amp_batches:
        while True:
            main_a, startup_a, h_a, _ = amp_pretrain(amp_cfg, b_amp, mlm_only=True,
                                                     max_preds=tp)
            feed_a = bert_pretrain_feed(np, np.random.RandomState(args.seed), amp_cfg,
                                        b_amp, ts, tp)
            scope_a = fluid.Scope()
            if not rehearsal:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            try:
                exe_t.run(startup_a, scope=scope_a)
                state_a0 = snapshot(main_a, scope_a)
                got, ms, per = run_steps(main_a, scope_a, feed_a, [h_a["loss"]], TRAIN_STEPS,
                                         exe_t, tag=f"amp b {b_amp}")
                break
            except torch.cuda.OutOfMemoryError:
                pass
            del scope_a
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[amp] b {b_amp} does not fit the card: trying b {b_amp // 2}")
            b_amp //= 2
        for counts in per:
            launches = {n: launches[n] + counts[n] for n in launches}
        losses_a = [g[0] for g in got]
        peak_a = torch.cuda.max_memory_allocated() if not rehearsal else 0
        amp_stats[b_amp] = (statistics.median(ms[1:]), peak_a)
        require(all(math.isfinite(x) for x in losses_a), f"[amp] non-finite loss {losses_a}")
        require(losses_a[-1] < losses_a[0], f"[amp] the loss did not fall: {losses_a}")
        require(exe_t.recomputed_forwards == [], "[amp] an __auto_grad__ re-ran a forward")
        if not rehearsal:
            require(all(c == amp_want for c in per), f"[amp] launches a step {per}, "
                    f"want {amp_want}")
        step = lambda: exe_t.run(main_a, feed=dict(feed_a),  # noqa: E731
                                 fetch_list=[h_a["loss"]], scope=scope_a)
        step_report("amp", b_amp, losses_a, ms, peak_a,
                    bert_flops_per_token(amp_cfg, ts, tp), step)
        if b_amp == amp_batches[-1]:
            host_breakdown(step)
            pass_ab["amp"] = passes_ab(f"amp b {b_amp}", main_a, state_a0, feed_a,
                                       [h_a["loss"]], TRAIN_STEPS, amp_want,
                                       amp_dtype="bfloat16")
        del scope_a, step, state_a0
    path_launches["amp"] = launches
    print(f"[amp] launches over {TRAIN_STEPS} steps at each batch size: {launches}")
    cfg2_amp = BertConfig.tiny() if rehearsal else BertConfig(num_layers=2)
    feed_2 = bert_pretrain_feed(np, np.random.RandomState(args.seed), cfg2_amp, CPU_REF_BATCH,
                                ts, tp)
    card_vs_cpu("amp", lambda: amp_pretrain(cfg2_amp, CPU_REF_BATCH, mlm_only=True,
                                            max_preds=tp), feed_2, LR)

    elapsed("phase 5c")
    # ---- 5c. full: pretraining with both heads, bhsd, Lamb, loss scaling ---
    # the NSP head and the masked-LM head over every position, attention in
    # the bhsd layout (kernels #2 and #6), bf16 AMP with dynamic loss
    # scaling around Lamb with a global-norm clip
    full_cfg = BertConfig.tiny() if rehearsal else BertConfig()
    full_cfg.attn_layout = "bhsd"
    lamb = lambda: fluid.optimizer.Lamb(  # noqa: E731
        FULL_LR, lamb_weight_decay=0.01, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0))
    full_amp = dict(use_dynamic_loss_scaling=True)
    main_f, startup_f, h_f, opt_f = amp_pretrain(full_cfg, tb, lamb, full_amp,
                                                 mlm_only=False, max_preds=None)
    layouts = {op.attr("layout") for op in main_f.global_block().ops
               if op.type == "fused_multihead_attention"}
    require(layouts == {"bhsd"}, f"[full] attention layouts {layouts}")
    found_f = next(op.output("FoundInfinite")[0] for op in main_f.global_block().ops
                   if op.type == "check_finite_and_unscale")
    scale_f = opt_f.get_loss_scaling()
    feed_f = bert_full_feed(np, np.random.RandomState(args.seed), full_cfg, tb, ts)
    scope_f = fluid.Scope()
    if not rehearsal:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    exe_t.run(startup_f, scope=scope_f)
    state_f0 = snapshot(main_f, scope_f)
    print(f"[full] BERT hidden {full_cfg.hidden_size} x {full_cfg.num_layers} layers, b {tb} "
          f"s {ts}, NSP + MLM over every position, bhsd, bf16 AMP with dynamic loss scaling, "
          f"Lamb({FULL_LR}, lamb_weight_decay=0.01) + GradientClipByGlobalNorm(1.0): "
          f"{len(main_f.global_block().ops)} ops")
    kernels.reset_launch_counts()
    got, ms, per = run_steps(main_f, scope_f, feed_f, [h_f["loss"], scale_f, found_f],
                             TRAIN_STEPS, exe_t, tag="full")
    # the scaled loss is fetched by no one: the dead-op pass drops its
    # forward op, and its __auto_grad__ runs it, once (a deferred forward)
    require(exe_t.recomputed_forwards == [], "[full] an __auto_grad__ re-ran a forward: "
            f"{exe_t.recomputed_forwards}")
    print(f"[full] forwards run in their __auto_grad__ (their op dropped as dead): "
          f"{exe_t.deferred_forwards}")
    launches = kernels.launch_counts()
    path_launches["full"] = launches
    peak_f = torch.cuda.max_memory_allocated() if not rehearsal else 0
    losses_f = [g[0] for g in got]
    print(f"[full] loss scale a step {[g[1] for g in got]}, found_infinite "
          f"{[bool(g[2]) for g in got]}; launches over {TRAIN_STEPS} steps: {launches}")
    require(all(math.isfinite(x) for x in losses_f) and not any(g[2] for g in got),
            f"[full] losses {losses_f}, found_infinite {[g[2] for g in got]}")
    require(losses_f[-1] < losses_f[0], f"[full] the loss did not fall: {losses_f}")
    if not rehearsal:
        require(all(c == amp_want for c in per), f"[full] launches a step {per}, "
                f"want {amp_want}")
    step = lambda: exe_t.run(main_f, feed=dict(feed_f),  # noqa: E731
                             fetch_list=[h_f["loss"]], scope=scope_f)
    step_report("full", tb, losses_f, ms, peak_f,
                bert_flops_per_token(full_cfg, ts), step)
    pass_ab["full"] = passes_ab("full", main_f, state_f0, feed_f, [h_f["loss"], scale_f, found_f],
                                TRAIN_STEPS, amp_want, amp_dtype="bfloat16", per_step=True)
    del state_f0

    # the overflow step: one non-finite mask weight until the decrease
    # window closes (decr_every_n_nan_or_inf steps in a row, counted
    # before the increment): found_infinite each step, the scale times
    # decr_ratio at the end, every persistable finite
    bad_feed = dict(feed_f, mask_weight=feed_f["mask_weight"].copy())
    bad_feed["mask_weight"][0, 0] = np.nan
    scale_before = float(to_numpy(scope_f.get(scale_f.name))[0])
    decr_n, decr_ratio = opt_f._decr_every_n_nan_or_inf, opt_f._decr_ratio
    bad, _, _ = run_steps(main_f, scope_f, bad_feed, [scale_f, found_f], decr_n + 1, exe_t)
    finite = all(bool(np.isfinite(to_numpy(scope_f.get(v.name))).all())
                 for v in main_f.list_vars() if v.persistable and scope_f.has(v.name))
    print(f"[full] overflow: {decr_n + 1} steps with mask_weight[0, 0] = nan: "
          f"found_infinite {[bool(g[1]) for g in bad]}, scale {scale_before} -> "
          f"{[g[0] for g in bad]} (decr_ratio {decr_ratio}); every persistable finite: {finite}")
    require(all(g[1] for g in bad), "[full] an overflow step was not found")
    shrunk = max(float(np.float32(scale_before) * np.float32(decr_ratio)), 1.0)
    require([g[0] for g in bad] == [scale_before] * decr_n + [shrunk],
            "[full] the scale did not shrink by "
            f"decr_ratio: {scale_before} -> {[g[0] for g in bad]}")
    require(finite, "[full] a persistable is not finite after the overflow steps")
    del scope_f, step

    # card vs CPU at 2 layers: the same configuration, then the unfused
    # path (use_flash_attention=False, fused_qkv, an untied MLM projection,
    # AdamW, an L1 decay on the pooler, a clip by value), which launches no
    # attention kernel
    cfg2_full = BertConfig.tiny() if rehearsal else BertConfig(num_layers=2)
    cfg2_full.attn_layout = "bhsd"
    feed_2f = bert_full_feed(np, np.random.RandomState(args.seed), cfg2_full, CPU_REF_BATCH, ts)
    card_vs_cpu("full", lambda: amp_pretrain(
        cfg2_full, CPU_REF_BATCH, lamb, full_amp, mlm_only=False, max_preds=None), feed_2f,
        FULL_LR)
    cfg2_unf = BertConfig.tiny() if rehearsal else BertConfig(num_layers=2)
    cfg2_unf.use_flash_attention, cfg2_unf.fused_qkv, cfg2_unf.tie_mlm_weights = False, True, False

    def pooler_l1(main_p):  # what ParamAttr(regularizer=L1Decay(...)) sets
        main_p.global_block().var("pooler.w_0").regularizer = fluid.regularizer.L1Decay(1e-4)

    got_launch = card_vs_cpu("unfused", lambda: amp_pretrain(
        cfg2_unf, CPU_REF_BATCH, lambda: fluid.optimizer.AdamW(
            LR, weight_decay=0.01, grad_clip=fluid.clip.GradientClipByValue(1.0)),
        full_amp, tweak=pooler_l1, mlm_only=False, max_preds=None), feed_2f, LR)
    if not rehearsal:
        require(got_launch["mha_short_fwd"] == got_launch["mha_short_bwd"] == 0
                and got_launch["flash_fwd"] == got_launch["flash_bwd"] == 0,
                f"[unfused] the unfused path launched an attention kernel: {got_launch}")

    elapsed("phase 5d")
    # ---- 5d. fp16: BERT pretraining under fp16 AMP ----------------------
    # mp.decorate(Adam(1e-4), amp_dtype="float16") with dynamic loss scaling
    # (fp16's default), bshd, b 8, s 128: at 1 layer and b CPU_REF_BATCH
    # 3 steps card vs CPU within one fp16 ulp; then 5 steps at full depth,
    # the scale fetched each step, #1, #7 and #8 launched in their fp16
    # versions
    fp16_amp = dict(amp_dtype="float16")
    cfg1_16 = BertConfig.tiny() if rehearsal else BertConfig(num_layers=1)
    feed_16 = bert_pretrain_feed(np, np.random.RandomState(args.seed), cfg1_16,
                                 CPU_REF_BATCH, ts, tp)
    t_ref = time.perf_counter()
    card_vs_cpu("fp16", lambda: amp_pretrain(cfg1_16, CPU_REF_BATCH, amp=fp16_amp,
                                             mlm_only=True, max_preds=tp),
                feed_16, LR, "float16")
    elapsed(f"phase 5d's card-vs-CPU reference, {cfg1_16.num_layers} layer(s) at b "
            f"{CPU_REF_BATCH}, took {time.perf_counter() - t_ref:.1f} s")
    cfg_16 = BertConfig.tiny() if rehearsal else BertConfig()
    main_h, startup_h, h_h, opt_h = amp_pretrain(cfg_16, tb, amp=fp16_amp, mlm_only=True,
                                                 max_preds=tp)
    require(main_h._amp_dtype == "float16", f"[fp16] AMP dtype {main_h._amp_dtype}")
    found_h = next(op.output("FoundInfinite")[0] for op in main_h.global_block().ops
                   if op.type == "check_finite_and_unscale")
    feed_h = bert_pretrain_feed(np, np.random.RandomState(args.seed), cfg_16, tb, ts, tp)
    scope_h = fluid.Scope()
    if not rehearsal:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    exe_t.run(startup_h, scope=scope_h)
    kernels.reset_launch_counts()
    got, ms, per = run_steps(main_h, scope_h, feed_h,
                             [h_h["loss"], opt_h.get_loss_scaling(), found_h], TRAIN_STEPS,
                             exe_t, tag="fp16")
    require(exe_t.recomputed_forwards == [], "[fp16] an __auto_grad__ re-ran a forward: "
            f"{exe_t.recomputed_forwards}")
    launches = kernels.launch_counts()
    path_launches["fp16"] = launches
    peak_h = torch.cuda.max_memory_allocated() if not rehearsal else 0
    losses_h = [g[0] for g in got]
    print(f"[fp16] BERT hidden {cfg_16.hidden_size} x {cfg_16.num_layers} layers, b {tb} s {ts} "
          f"max_preds {tp}, fp16 AMP with dynamic loss scaling around Adam({LR}): loss scale a "
          f"step {[g[1] for g in got]}, found_infinite {[bool(g[2]) for g in got]}; launches "
          f"over {TRAIN_STEPS} steps: {launches}")
    require(all(math.isfinite(x) for x in losses_h), f"[fp16] non-finite loss {losses_h}")
    require(losses_h[-1] < losses_h[0], f"[fp16] the loss did not fall: {losses_h}")
    step = lambda: exe_t.run(main_h, feed=dict(feed_h),  # noqa: E731
                             fetch_list=[h_h["loss"]], scope=scope_h)
    if not rehearsal:
        require(all(c == amp_want for c in per), f"[fp16] launches a step {per}, "
                f"want {amp_want}")
        # the device's kernels of one step: #1, #7 (both launches) and #8
        # in their __half instantiations, none in another type
        per_call, sessions = kernels.device_kernels(step, calls=1)
        ours = {n: c for n, c in per_call.items() if any(
            k in n for k in ("mha_short_fwd_kernel", "short_bwd_d", "layer_norm_bwd_"))}
        halves = {k: sum(c for n, c in ours.items() if k in n and "__half" in n)
                  for k in ("mha_short_fwd_kernel", "short_bwd_dkv_kernel",
                            "short_bwd_dq_kernel", "layer_norm_bwd_")}
        print(f"[fp16] one step's attention and LayerNorm kernels (torch.profiler, {sessions} "
              f"sessions): {ours}")
        require(all(n for n in halves.values()) and all("__half" in n for n in ours),
                f"[fp16] kernels of a step not all fp16: {ours}")
    step_report("fp16", tb, losses_h, ms, peak_h, bert_flops_per_token(cfg_16, ts, tp), step)
    del scope_h, step

    elapsed("phase 6")
    # ---- 6. long: one attention training step at s 2048 ------------------
    lb, lh, lsq, _, ld = long_shape
    long_prog = fluid.Program()
    with fluid.program_guard(long_prog, fluid.Program()), fluid.unique_name.guard():
        qkv = [layers.data(n, [lb, lh, lsq, ld], append_batch_size=False,
                           stop_gradient=False) for n in ("q", "k", "v")]
        lbias = layers.data("bias", [lb, lsq], append_batch_size=False)
        g = layers.data("g", [lb, lh, lsq, ld], append_batch_size=False)
        lout = layers.fused_multihead_attention(
            *qkv, key_bias=lbias, causal=True, sm_scale=1.0 / math.sqrt(ld),
            attn_dropout=0.0, is_test=False, layout="bhsd")
        lloss = layers.reduce_sum(layers.elementwise_mul(lout, g))
        fluid.append_backward(lloss)
    lq, lk, lv, lb_ = long_in
    lg = torch.randn(lq.shape, generator=gen, device=dev)
    lfetch = [lout.name] + [f"{n}@GRAD" for n in ("q", "k", "v")]
    kernels.reset_launch_counts()
    lgot = exe.run(long_prog, feed={"q": lq, "k": lk, "v": lv, "bias": lb_, "g": lg},
                   fetch_list=lfetch, return_numpy=False)
    if not rehearsal:
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    path_launches["long"] = launches
    print(f"[long] launches of one training step at b,h,s,d={lb, lh, lsq, ld}: {launches}")
    if not rehearsal:
        require(launches == dict(zero_launches, flash_fwd=1, flash_bwd=1),
                f"the long-sequence step launched {launches}")
    lkw = dict(bias=lb_, causal=True, layout="bhsd")
    pout, plse = flash_attention_plain(lq, lk, lv, **lkw)
    pgrads = flash_attention_bwd_plain(lq, lk, lv, lb_, lg, plse, attention_delta(pout, lg, "bhsd"),
                                       causal=True, layout="bhsd")
    long_errs = [float((a - b).abs().max()) for a, b in zip(lgot, (pout, *pgrads))]
    print(f"[long] max abs err against the plain forward and backward (out, dq, dk, dv): "
          f"{long_errs} (tol {TOL['float32']})")
    require(max(long_errs) <= TOL["float32"], f"long-sequence step: errors {long_errs}")

    del long_in, lgot, lq, lk, lv, lb_, lg, pout, plse, pgrads

    elapsed("phase 7")
    # ---- 7. fused: the fused-block A/B ------------------------------------
    # tools/fused_block_pallas.py:main, ported: per shape the checks first,
    # then each kernel's time against its twin's
    kernels.reset_launch_counts()
    ab_rows = []
    for row in fb.ab(fb_shapes, torch.bfloat16, dev, timer=timed_ms, seed=args.seed):
        ab_rows.append(row)
        print(f"[fused] {json.dumps(row)}")
        counts = kernels.launch_counts()
        require(counts["fused_prologue_conv1x1"] >= len(ab_rows)
                and counts["conv1x1_with_stats"] >= len(ab_rows) or rehearsal,
                f"the A/B of {row['shape']} did not launch both kernels: {counts}")
    launches = kernels.launch_counts()
    path_launches["fused"] = launches
    print(f"[fused] launches over the A/B at {len(ab_rows)} shapes: {launches}")
    if not rehearsal:
        require(launches == dict(zero_launches, fused_prologue_conv1x1=launches[
            "fused_prologue_conv1x1"], conv1x1_with_stats=launches["conv1x1_with_stats"]),
                f"the A/B launched other kernels: {launches}")
        for row in ab_rows:
            print(f"[fused] {row['shape']}: prologue {row['prologue_ms']:.4f} ms against the "
                  f"twin's {row['prologue_twin_ms']:.4f} ms ({row['prologue_twin_ms'] / row['prologue_ms']:.3f}x); "
                  f"stats {row['stats_ms']:.4f} ms against {row['stats_twin_ms']:.4f} ms "
                  f"({row['stats_twin_ms'] / row['stats_ms']:.3f}x); card {smi}")

    elapsed("phase 8")
    # ---- 8. resnet: ResNet-50 training and serving -------------------------
    rn_depth, rn_hw = (18, 32) if rehearsal else (50, 224)
    rn_b = 4 if rehearsal else RN_BATCH
    # lr 0.1 diverges at b 4 on 32x32 (tests/test_models.py:15-18); the
    # rehearsal takes 0.05, the card bench.py's 0.1
    rn_lr = 0.05 if rehearsal else RN_LR

    def resnet_programs(b, amp):
        main_p, startup_p = fluid.Program(), fluid.Program()
        main_p.random_seed = startup_p.random_seed = args.seed + 3
        with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
            img = layers.data("img", [b, 3, rn_hw, rn_hw], append_batch_size=False)
            label = layers.data("label", [b, 1], dtype="int64", append_batch_size=False)
            pred, loss, _, _ = resnet(img, label, depth=rn_depth, class_num=1000)
            opt = fluid.optimizer.Momentum(rn_lr, RN_MOMENTUM)
            if amp:
                opt = mixed_precision.decorate(opt)
            opt.minimize(loss)
        return main_p, startup_p, pred, loss

    def resnet_feed(b, seed):
        """bench.py's feed: images U[0, 1), labels in [0, 1000), on the card."""
        rs = np.random.RandomState(seed)
        return {"img": torch.from_numpy(rs.rand(b, 3, rn_hw, rn_hw).astype("float32")).to(dev),
                "label": torch.from_numpy(rs.randint(0, 1000, (b, 1)).astype("int64")).to(dev)}

    rn_feed = resnet_feed(rn_b, args.seed)
    kernels.reset_launch_counts()
    export_dir = ROOT / "build" / "chip_smoke" / "resnet50"
    for amp in (False, True):
        tag = "bf16 AMP" if amp else "fp32"
        main_r, startup_r, pred_r, loss_r = resnet_programs(rn_b, amp)
        scope_r = fluid.Scope()
        exe_r = fluid.Executor(fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0))
        exe_r.run(startup_r, scope=scope_r)
        state_r0 = snapshot(main_r, scope_r)
        if not rehearsal:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, step_ms, rn_stats = [], [], []
        for _ in range(RN_STEPS):
            t0 = time.perf_counter()
            loss = exe_r.run(main_r, feed=dict(rn_feed), fetch_list=[loss_r], scope=scope_r)[0]
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.reshape(-1)[0]))
            rn_stats.append(exe_r.last_pass_stats)
        pass_note(f"resnet {tag}", rn_stats)
        peak_rn = torch.cuda.max_memory_allocated() if not rehearsal else 0
        p50_ms = statistics.median(step_ms[1:])
        n_ops = len(main_r.global_block().ops)
        print(f"[resnet] ResNet-{rn_depth} {tag}, b {rn_b}, {rn_hw}x{rn_hw}, Momentum({rn_lr}, "
              f"{RN_MOMENTUM}), {n_ops} ops: losses {losses}")
        print(f"[resnet] {tag}: step time p50 {p50_ms:.2f} ms over steps 2-{RN_STEPS} (first "
              f"{step_ms[0]:.2f} ms); {rn_b / p50_ms * 1e3:.1f} images/s; "
              f"{RESNET50_TRAIN_FLOPS_PER_IMG * rn_b / p50_ms / 1e9:.2f} TFLOP/s "
              f"(RESNET50_TRAIN_FLOPS_PER_IMG); max_memory_allocated {peak_rn / 2**20:.0f} MiB "
              f"(startup state + {RN_STEPS} steps); card {smi}")
        require(all(math.isfinite(x) for x in losses), f"ResNet {tag}: non-finite loss {losses}")
        require(losses[-1] < losses[0], f"ResNet {tag}: the loss did not fall over "
                f"{RN_STEPS} steps: {losses}")
        require(exe_r.recomputed_forwards == [], "an __auto_grad__ re-ran a forward: "
                f"{exe_r.recomputed_forwards}")
        step = lambda: exe_r.run(main_r, feed=dict(rn_feed), fetch_list=[loss_r],  # noqa: E731
                                 scope=scope_r)
        if not rehearsal:
            profile_step(torch, step, f"one ResNet-{rn_depth} {tag} training step")
        host_breakdown(step)
        # passes off (NCHW, per-parameter momentum) against on (layout_opt's
        # NHWC as channels_last, fused_momentum), each step from one state
        pass_ab[f"resnet {tag}"] = passes_ab(
            f"resnet {tag}", main_r, state_r0, rn_feed, [loss_r], RN_STEPS, zero_launches,
            amp_dtype="bfloat16" if amp else None, resnet=True)
        del state_r0
        if not amp:
            # the trained fp32 program's eval clone; the export carries no
            # AMP tag (bench.py:728-733)
            # with the logits beside the softmax: saturated probabilities
            # would agree between any two devices
            eval_prog = main_r.clone(for_test=True)
            logits_r = next(op.input("X")[0] for op in eval_prog.global_block().ops
                            if op.type == "softmax")
            shutil.rmtree(export_dir, ignore_errors=True)
            with fluid.scope_guard(scope_r):
                fluid.io.save_inference_model(
                    str(export_dir), ["img"], [pred_r, eval_prog.global_block().var(logits_r)],
                    exe_r, main_program=eval_prog)
        del scope_r, exe_r, step

    # card vs CPU: ResNet-50 at b 2, each of 3 steps from the same state
    main_p, startup_p, _, loss_p = resnet_programs(RN_PARITY_BATCH, False)
    p_feed = resnet_feed(RN_PARITY_BATCH, args.seed + 1)
    p_feed_cpu = {n: t.cpu() for n, t in p_feed.items()}
    scopes = {"card": fluid.Scope(), "cpu": fluid.Scope()}
    exes = {"card": fluid.Executor(fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)),
            "cpu": fluid.Executor(fluid.CPUPlace())}
    exes["card"].run(startup_p, scope=scopes["card"])
    exes["cpu"].run(startup_p, scope=scopes["cpu"])
    persist = [v.name for v in main_p.list_vars() if v.persistable]
    worst_loss, worst_stat, worst_grad = 0.0, (0.0, ""), (0.0, "")
    for i in range(PARITY_STEPS):
        state = {n: to_numpy(scopes["card"].get(n)) for n in persist if scopes["card"].has(n)}
        fluid.io.set_persistables_from_numpy(scopes["cpu"], state, "cpu")
        ls = {where: float(exes[where].run(main_p, feed=dict(p_feed if where == "card"
                                                                 else p_feed_cpu),
                                           fetch_list=[loss_p], scope=scopes[where])[0]
                           .reshape(-1)[0]) for where in ("card", "cpu")}
        loss_rel = abs(ls["card"] - ls["cpu"]) / abs(ls["cpu"])
        stat, grad, grad_max = (0.0, ""), (0.0, ""), (0.0, "")
        for n in persist:
            a, c = to_numpy(scopes["card"].get(n)), to_numpy(scopes["cpu"].get(n))
            if n.endswith((".mean", ".var")):
                stat = max(stat, (float(np.abs(a - c).max() / max(float(np.abs(c).max()),
                                                                  1e-12)), n))
            else:
                grad = max(grad, (float(np.linalg.norm(a - c) / max(float(np.linalg.norm(c)),
                                                                    1e-12)), n))
                grad_max = max(grad_max, (float(np.abs(a - c).max() / max(
                    float(np.abs(c).max()), 1e-12)), n))
        print(f"[resnet] card vs CPU, ResNet-{rn_depth} b {RN_PARITY_BATCH} step {i + 1} from "
              f"the same state: losses {ls['card']} vs {ls['cpu']} (rel diff {loss_rel:.3e}, "
              f"tol {RN_LOSS_RTOL}); running stats max|diff| / max|value| {stat[0]:.3e} "
              f"({stat[1]}; tol {RN_STAT_RTOL}); parameters and velocities |diff| / |value| "
              f"{grad[0]:.3e} ({grad[1]}; tol {RN_GRAD_NRTOL}), max|diff| / max|value| "
              f"{grad_max[0]:.3e} ({grad_max[1]})")
        worst_loss = max(worst_loss, loss_rel)
        worst_stat, worst_grad = max(worst_stat, stat), max(worst_grad, grad)
    require(worst_loss <= RN_LOSS_RTOL and worst_stat[0] <= RN_STAT_RTOL
            and worst_grad[0] <= RN_GRAD_NRTOL,
            f"ResNet card vs CPU: loss rel diff {worst_loss}, running stats {worst_stat}, "
            f"parameters and velocities {worst_grad}")
    del scopes, exes, state

    # serving: the exported eval program through AnalysisPredictor at b 8
    serve_feed = {"img": np.random.RandomState(args.seed + 2).rand(
        RN_SERVE_BATCH, 3, rn_hw, rn_hw).astype("float32")}
    rn_pred = create_paddle_predictor(AnalysisConfig(str(export_dir)) if not rehearsal
                                      else _cpu_config(AnalysisConfig, export_dir))
    rn_cpu_pred = create_paddle_predictor(_cpu_config(AnalysisConfig, export_dir))
    outs, run_ms, serve_stats = None, [], []
    for _ in range(6):
        t0 = time.perf_counter()
        outs = rn_pred.run(dict(serve_feed))  # host numpy: synchronised
        run_ms.append((time.perf_counter() - t0) * 1e3)
        serve_stats.append(rn_pred._exe.last_pass_stats)
    pass_note("resnet serve", serve_stats)
    probs, logits = outs
    cpu_probs, cpu_logits = rn_cpu_pred.run(dict(serve_feed))
    serve_diff = float(np.abs(probs - cpu_probs).max())
    logit_rel = float(np.abs(logits - cpu_logits).max() / np.abs(cpu_logits).max())
    require(probs.shape == (RN_SERVE_BATCH, 1000) and bool(np.isfinite(probs).all())
            and bool(np.isfinite(logits).all()), f"ResNet predictions {probs.shape}")
    require(bool(np.allclose(probs.sum(1), 1.0, atol=1e-3)), "softmax rows do not sum to 1")
    require(serve_diff <= RN_SERVE_ATOL and logit_rel <= RN_LOSS_RTOL,
            f"ResNet serving card vs CPU: probabilities max abs diff {serve_diff}, logits "
            f"max|diff| / max|logit| {logit_rel}")
    print(f"[resnet] served the fp32 eval export at b {RN_SERVE_BATCH}: card vs CPU "
          f"probabilities max abs diff {serve_diff:.3e} (tol {RN_SERVE_ATOL}), logits "
          f"max|diff| / max|logit| {logit_rel:.3e} (tol {RN_LOSS_RTOL}; logits span "
          f"{float(logits.min()):.3g}..{float(logits.max()):.3g}, largest probability per "
          f"row {np.round(probs.max(1), 4).tolist()}); p50 predictor.run "
          f"{statistics.median(run_ms[1:]):.2f} ms (first {run_ms[0]:.2f} ms); card {smi}")
    if not rehearsal:
        profile_step(torch, lambda: rn_pred.run(dict(serve_feed)), "one ResNet predictor.run")
    # passes off against on: a second predictor of the same export, run
    # with PADDLE_TPU_PASSES=none (no fuse_conv_bn, NCHW), the runs of the
    # two interleaved
    with passes_env("off"):
        rn_pred_off = create_paddle_predictor(AnalysisConfig(str(export_dir)) if not rehearsal
                                              else _cpu_config(AnalysisConfig, export_dir))
    serve_ab = {"off": dict(pred=rn_pred_off, ms=[], peak=0),
                "on": dict(pred=rn_pred, ms=[], peak=0)}
    for _ in range(6):
        for mode, a in serve_ab.items():
            with passes_env(mode):
                if not rehearsal:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                a["out"] = a["pred"].run(dict(serve_feed))
                a["ms"].append((time.perf_counter() - t0) * 1e3)
                if not rehearsal:
                    a["peak"] = max(a["peak"], torch.cuda.max_memory_allocated())
            require(on_card(a["pred"]._exe, a["pred"]._scope, a["pred"].program()),
                    f"[passes] resnet serve, passes {mode}: the predictor ran off the card")
    serve_gap = float(np.abs(serve_ab["on"]["out"][0] - serve_ab["off"]["out"][0]).max())
    require(serve_gap <= RN_SERVE_ATOL, f"[passes] resnet serve: probabilities passes on vs "
            f"off max abs diff {serve_gap}")
    for mode, a in serve_ab.items():
        with passes_env(mode):
            run = lambda: a["pred"].run(dict(serve_feed))  # noqa: E731
            busy, idle = 0.0, float("nan")
            if not rehearsal:
                wall, busy, _ = profile_step(torch, run, f"resnet serve, passes {mode}")
                idle = max(0.0, 1 - busy / wall)
            host = host_breakdown(run, f"host resnet serve, passes {mode}")
            n_ops = len(a["pred"]._exe._passed_program(
                a["pred"].program(), serve_feed, a["pred"].get_output_names(),
                a["pred"]._scope).global_block().ops)
        top = sorted(host[2].items(), key=lambda kv: -kv[1][0])[:4]
        a["summary"] = dict(p50=statistics.median(a["ms"][1:]), busy=busy, idle=idle,
                            host=host[1], peak=a["peak"])
        print(f"[passes] resnet serve b {RN_SERVE_BATCH}, passes {mode}: {n_ops} ops; "
              f"predictor.run p50 {a['summary']['p50']:.2f} ms over runs 2-6; busy "
              f"{busy:.2f} ms, idle {idle:.2f}; host issue {host[1]:.2f} ms, top "
              f"{[(t, round(v[0], 2), v[1]) for t, v in top]}; max_memory_allocated "
              f"{a['peak'] / 2**20:.0f} MiB; card {smi}")
    print(f"[passes] resnet serve: probabilities passes on vs off max abs diff "
          f"{serve_gap:.3e} (tol {RN_SERVE_ATOL})")
    pass_ab["resnet serve"] = {m: a["summary"] for m, a in serve_ab.items()}
    del rn_pred, rn_cpu_pred, rn_pred_off, serve_ab
    launches = kernels.launch_counts()
    path_launches["resnet"] = launches
    print(f"[resnet] launches over the ResNet path (training, card vs CPU, serving): {launches}")
    require(launches == zero_launches, f"the ResNet path launched a kernel: {launches}")

    elapsed("phase 9")
    # ---- 9. transformer: bench_transformer's training and its decode ----
    # TransformerConfig.base() (d_model 512, 8 heads, d_ff 2048, 6 + 6
    # layers, vocab 30000, weight sharing, the fused attention op in bshd,
    # dropout 0.1) at b 256, s 64 under mp.decorate(Adam(1e-4)) in bf16 (no
    # loss scaling), the feed of bench.py:606-616; then the encode program
    # once and the decode step fed its cross K / V, from the trained scope
    tcfg = TransformerConfig.tiny() if rehearsal else TransformerConfig.base()
    tf_b, tf_s = (4, 16) if rehearsal else (TF_BATCH, TF_SEQ)
    inf_b = 2 if rehearsal else TF_INFER_BATCH

    def tf_programs(cfg, b, kind="train"):
        """-> (main, startup, handles, optimizer or None) of `kind`: train
        (bf16 AMP around Adam), test, encode or step."""
        main_p, startup_p = fluid.Program(), fluid.Program()
        main_p.random_seed = startup_p.random_seed = args.seed + 4
        opt = None
        with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
            if kind in ("train", "test"):
                h = build_transformer(cfg, b, tf_s, tf_s, is_test=kind == "test")
            elif kind == "encode":
                h = build_transformer_encode(cfg, b, tf_s)
            else:
                h = build_transformer_decode_step(cfg, b, tf_s, tf_s)
            if kind == "train":
                opt = mixed_precision.decorate(fluid.optimizer.Adam(LR))
                opt.minimize(h["loss"])
        return main_p, startup_p, h, opt

    def tf_feed(cfg, b, h, seed):
        """bench.py's feed: ids in [1, vocab), full masks, positions."""
        rng = np.random.RandomState(seed)
        pos = np.tile(np.arange(tf_s), (b, 1)).astype("int64")
        return {
            "src_ids": rng.randint(1, cfg.src_vocab, (b, tf_s)).astype("int64"),
            "trg_ids": rng.randint(1, cfg.trg_vocab, (b, tf_s)).astype("int64"),
            "lbl_ids": rng.randint(1, cfg.trg_vocab, (b, tf_s)).astype("int64"),
            "src_mask": np.ones((b, tf_s), "float32"),
            "trg_mask": np.ones((b, tf_s), "float32"),
            h.get("src_pos_name", f"src_emb_posids_{tf_s}"): pos,
            h.get("trg_pos_name", f"trg_emb_posids_{tf_s}"): pos,
        }

    nl = tcfg.n_layers
    tf_want = dict(zero_launches, mha_short_fwd=3 * nl, mha_short_bwd=3 * nl,
                   layer_norm_bwd=5 * nl)
    main_9, startup_9, h_9, _ = tf_programs(tcfg, tf_b)
    feed_9 = tf_feed(tcfg, tf_b, h_9, args.seed)
    scope_9 = fluid.Scope()
    if not rehearsal:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    exe_t.run(startup_9, scope=scope_9)
    state_90 = snapshot(main_9, scope_9)
    kernels.reset_launch_counts()
    got, ms, per = run_steps(main_9, scope_9, feed_9, [h_9["loss"]], TRAIN_STEPS, exe_t,
                             tag="transformer")
    launches, causal = kernels.launch_counts(), kernels.causal_launch_counts()
    path_launches["transformer"] = launches
    causal_launches = {"transformer": causal}
    peak_9 = torch.cuda.max_memory_allocated() if not rehearsal else 0
    losses_9 = [g[0] for g in got]
    tokens_9 = tf_b * tf_s
    p50_9 = statistics.median(ms[1:])
    flops_9 = transformer_flops_per_trg_token(tcfg, tf_s, tf_s) * tokens_9
    n_drop = sum(op.type == "dropout" for op in main_9.global_block().ops)
    print(f"[transformer] d_model {tcfg.d_model}, {tcfg.n_heads} heads, d_ff {tcfg.d_ff}, "
          f"{nl} + {nl} layers, vocab {tcfg.trg_vocab}, b {tf_b} s {tf_s}, bf16 AMP around "
          f"Adam({LR}), dropout {tcfg.dropout}: {len(main_9.global_block().ops)} ops, "
          f"{n_drop} dropout ops; losses {losses_9}")
    print(f"[transformer] launches over {TRAIN_STEPS} steps: {launches}; of them causal: "
          f"{causal}")
    print(f"[transformer] step time p50 {p50_9:.2f} ms over steps 2-{TRAIN_STEPS} (first "
          f"{ms[0]:.2f} ms); {tokens_9 / p50_9 * 1e3:.0f} target tokens/s; "
          f"{flops_9 / 1e12:.3f} TFLOP/step (transformer_flops_per_trg_token), "
          f"{flops_9 / p50_9 / 1e9:.2f} TFLOP/s; max_memory_allocated {peak_9 / 2**20:.0f} MiB "
          f"(startup state + {TRAIN_STEPS} steps); card {smi}")
    require(all(math.isfinite(x) for x in losses_9), f"[transformer] losses {losses_9}")
    require(losses_9[-1] < losses_9[0], f"[transformer] the loss did not fall: {losses_9}")
    require(exe_t.recomputed_forwards == [], "[transformer] an __auto_grad__ re-ran a forward")
    if not rehearsal:
        require(all(c == tf_want for c in per), f"[transformer] launches a step {per}, "
                f"want {tf_want}")
        require(causal == dict(causal, mha_short_fwd=nl * TRAIN_STEPS,
                               mha_short_bwd=nl * TRAIN_STEPS),
                f"[transformer] causal launches {causal}, want {nl} of each a step")
    step = lambda: exe_t.run(main_9, feed=dict(feed_9),  # noqa: E731
                             fetch_list=[h_9["loss"]], scope=scope_9)
    if not rehearsal:
        _, busy_9, rows_9 = profile_step(torch, step, f"one transformer step at b {tf_b}")
        int64_ms = sum(r[0] for r in rows_9 if "<long" in r[2] or "long>" in r[2])
        print(f"[transformer] int64 elementwise kernels (the dropout masks' hash): "
              f"{int64_ms:.2f} ms of {busy_9:.2f} ms busy ({int64_ms / max(busy_9, 1e-9):.2f})")
    host_breakdown(step)
    # passes off against on from the startup state: the host's issue time
    # against the busy time, and fused_adam's host time against adam's
    pass_ab["transformer"] = passes_ab("transformer", main_9, state_90, feed_9, [h_9["loss"]],
                                       TRAIN_STEPS, tf_want, amp_dtype="bfloat16")
    del state_90

    # incremental decode from the trained scope, fp32: the encode program
    # once, the decode step fed its cross K / V, against the full is_test
    # graph's logits
    main_e, _, h_e, _ = tf_programs(tcfg, inf_b, "encode")
    main_d, _, h_d, _ = tf_programs(tcfg, inf_b, "step")
    main_f9, _, h_f9, _ = tf_programs(tcfg, inf_b, "test")
    inf_feed = tf_feed(tcfg, inf_b, h_f9, args.seed + 1)
    kv_names = [n for pair in h_e["cross_kv_names"] for n in pair]
    kernels.reset_launch_counts()
    enc_out = exe_t.run(main_e, feed={"src_ids": inf_feed["src_ids"],
                                      "src_mask": inf_feed["src_mask"],
                                      h_e["src_pos_name"]: inf_feed[h_e["src_pos_name"]]},
                        fetch_list=kv_names, scope=scope_9, return_numpy=False)
    enc_launch, enc_causal = kernels.launch_counts(), kernels.causal_launch_counts()
    step_feed = {"trg_ids": inf_feed["trg_ids"], "src_mask": inf_feed["src_mask"],
                 "trg_mask": inf_feed["trg_mask"],
                 h_d["trg_pos_name"]: inf_feed[h_d["trg_pos_name"]]}
    step_feed.update({f"dec{i}.cross.{kv}_cached": enc_out[2 * i + j]
                      for i in range(nl) for j, kv in enumerate("kv")})
    kernels.reset_launch_counts()
    step_logits = exe_t.run(main_d, feed=dict(step_feed), fetch_list=[h_d["logits"]],
                            scope=scope_9)[0]
    decode_stats = [exe_t.last_pass_stats]
    step_launch, step_causal = kernels.launch_counts(), kernels.causal_launch_counts()
    path_launches["decode"] = {n: enc_launch[n] + step_launch[n] for n in enc_launch}
    causal_launches["decode"] = {n: enc_causal[n] + step_causal[n] for n in enc_causal}
    full_logits = exe_t.run(main_f9, feed=dict(inf_feed), fetch_list=[h_f9["logits"]],
                            scope=scope_9)[0]
    step_ms = []
    for _ in range(6):
        t0 = time.perf_counter()
        exe_t.run(main_d, feed=dict(step_feed), fetch_list=[h_d["logits"]], scope=scope_9)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        decode_stats.append(exe_t.last_pass_stats)
    pass_note("decode step", decode_stats)
    diff = np.abs(step_logits - full_logits)
    excess = float((diff - (DECODE_ATOL + DECODE_RTOL * np.abs(full_logits))).max())
    print(f"[decode] encode program ({len(main_e.global_block().ops)} ops) launches {enc_launch}"
          f", causal {enc_causal}; decode step ({len(main_d.global_block().ops)} ops) launches "
          f"{step_launch}, causal {step_causal}")
    print(f"[decode] decode-step logits {step_logits.shape} against the full is_test graph's: "
          f"max abs diff {float(diff.max()):.3e}, {excess:.3e} past rtol {DECODE_RTOL} + atol "
          f"{DECODE_ATOL}")
    print(f"[decode] decode step p50 {statistics.median(step_ms[1:]):.2f} ms (b {inf_b}, "
          f"target prefix {tf_s}, {nl} layers, first {step_ms[0]:.2f} ms); card {smi}")
    require(step_logits.shape == (inf_b, tf_s, tcfg.trg_vocab)
            and bool(np.isfinite(step_logits).all()), "[decode] decode-step logits")
    require(excess <= 0, "[decode] the decode step's logits differ from the full graph's")
    if not rehearsal:
        require(enc_launch == dict(zero_launches, mha_short_fwd=nl)
                and step_launch == dict(zero_launches, mha_short_fwd=2 * nl)
                and step_causal["mha_short_fwd"] == nl and enc_causal["mha_short_fwd"] == 0,
                f"[decode] launches: encode {enc_launch}, step {step_launch} "
                f"(causal {step_causal})")
    del scope_9, step, enc_out, step_feed

    # card vs CPU at 2 layers and base width, b CPU_REF_BATCH: the fused
    # path, then the unfused one (layers.assign of the causal triangle,
    # matmul, softmax), which launches no attention kernel
    cfg2_tf = TransformerConfig.tiny() if rehearsal else TransformerConfig(n_layers=2)
    feed_tf = tf_feed(cfg2_tf, CPU_REF_BATCH, {}, args.seed)
    card_vs_cpu("transformer", lambda: tf_programs(cfg2_tf, CPU_REF_BATCH), feed_tf, LR)
    cfg2_tfu = TransformerConfig.tiny() if rehearsal else TransformerConfig(n_layers=2)
    cfg2_tfu.use_flash_attention = False
    got_launch = card_vs_cpu("transformer unfused",
                             lambda: tf_programs(cfg2_tfu, CPU_REF_BATCH), feed_tf, LR)
    if not rehearsal:
        require(all(got_launch[n] == 0 for n in ("mha_short_fwd", "mha_short_bwd", "flash_fwd",
                                                 "flash_bwd")),
                f"[transformer unfused] launched an attention kernel: {got_launch}")

    elapsed("phase 11")
    # ---- 11. recompute: BERT-base under RecomputeOptimizer ----------------
    # bench.py:bench_bert's recipe with BertConfig(recompute=True), each
    # encoder layer one recompute_scope segment: mixed_precision.decorate(
    # RecomputeOptimizer(Adam(1e-4))) in bf16, dropout 0.1, s 128, max_preds
    # 20, at b 256 and b 8 (an out-of-memory error fails the run). The grads
    # come from autograd over the forward with each layer in checkpoint: the
    # short forward runs twice a layer (the forward and its recomputation),
    # the short backward once, the LayerNorm backward kernel never (that
    # grad is the autograd of the plain forward, as in the JAX step)
    def recompute_cfg(cfg):
        cfg.recompute = True
        return cfg

    rc_cfg = recompute_cfg(BertConfig.tiny() if rehearsal else BertConfig.base())
    rc_opt = lambda: fluid.optimizer.RecomputeOptimizer(fluid.optimizer.Adam(LR))  # noqa: E731
    rc_want = dict(zero_launches, mha_short_fwd=2 * rc_cfg.num_layers,
                   mha_short_bwd=rc_cfg.num_layers)
    rc_launches = dict(zero_launches)
    kernels.reset_launch_counts()
    for b_rc in reversed(amp_batches):
        main_c, startup_c, h_c, _ = amp_pretrain(rc_cfg, b_rc, rc_opt, mlm_only=True,
                                                 max_preds=tp)
        require(getattr(main_c, "_recompute_loss", None) == h_c["loss"].name,
                "[recompute] mixed_precision.decorate did not hand minimize to "
                "RecomputeOptimizer")
        segments = {op.attr("recompute_segment") for op in main_c.global_block().ops} - {None}
        feed_c = bert_pretrain_feed(np, np.random.RandomState(args.seed), rc_cfg, b_rc, ts, tp)
        scope_c = fluid.Scope()
        if not rehearsal:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        exe_t.run(startup_c, scope=scope_c)
        got, ms, per = run_steps(main_c, scope_c, feed_c, [h_c["loss"]], TRAIN_STEPS, exe_t,
                                 tag=f"recompute b {b_rc}")
        peak_c = torch.cuda.max_memory_allocated() if not rehearsal else 0
        for counts in per:
            rc_launches = {n: rc_launches[n] + counts[n] for n in rc_launches}
        losses_c = [g[0] for g in got]
        print(f"[recompute] BERT hidden {rc_cfg.hidden_size} x {rc_cfg.num_layers} layers, "
              f"b {b_rc} s {ts}, bf16 AMP around RecomputeOptimizer(Adam({LR})): "
              f"{len(main_c.global_block().ops)} ops, {len(segments)} recompute segments; "
              f"launches a step {per[-1]}")
        require(all(math.isfinite(x) for x in losses_c), f"[recompute] losses {losses_c}")
        require(losses_c[-1] < losses_c[0], f"[recompute] the loss did not fall: {losses_c}")
        require(exe_t.recomputed_forwards == [] and exe_t.deferred_forwards == [],
                "[recompute] an __auto_grad__ ran: the step must skip the backward ops")
        if not rehearsal:
            require(all(c == rc_want for c in per), f"[recompute] launches a step {per}, "
                    f"want {rc_want}")
        step = lambda: exe_t.run(main_c, feed=dict(feed_c),  # noqa: E731
                                 fetch_list=[h_c["loss"]], scope=scope_c)
        step_report("recompute", b_rc, losses_c, ms, peak_c,
                    bert_flops_per_token(rc_cfg, ts, tp), step)
        p50_5b, peak_5b = amp_stats.get(b_rc, (float("nan"), 0))
        p50_c = statistics.median(ms[1:])
        print(f"[recompute] b {b_rc}: max_memory_allocated {peak_c / 2**20:.0f} MiB with "
              f"recompute against {peak_5b / 2**20:.0f} MiB without (phase 5b, this run; "
              f"ratio {peak_c / max(peak_5b, 1):.3f}); step p50 {p50_c:.2f} ms against "
              f"{p50_5b:.2f} ms (ratio {p50_c / p50_5b:.3f}); card {smi}")
        if b_rc == amp_batches[-1]:
            host_breakdown(step, f"host recompute b {b_rc}")
        del scope_c, step
    path_launches["recompute"] = rc_launches
    print(f"[recompute] launches over {TRAIN_STEPS} steps at each batch size: {rc_launches}")
    # 2 layers at base width: the recompute step on the card against the
    # CPU, then against the plain step on the card, from one state
    cfg2_rc = recompute_cfg(BertConfig.tiny() if rehearsal else BertConfig(num_layers=2))
    cfg2_plain = BertConfig.tiny() if rehearsal else BertConfig(num_layers=2)
    build_rc = lambda: amp_pretrain(cfg2_rc, CPU_REF_BATCH, rc_opt,  # noqa: E731
                                    mlm_only=True, max_preds=tp)
    card_vs_cpu("recompute", build_rc, feed_2, LR)
    card_vs_cpu("recompute", build_rc, feed_2, LR, second=(
        "the plain step", lambda: amp_pretrain(cfg2_plain, CPU_REF_BATCH, mlm_only=True,
                                               max_preds=tp)))

    elapsed("phase 12")
    # ---- 12. scan: fuse_layer_scan against the default passes --------------
    # PADDLE_TPU_FUSE_LAYER_SCAN=1 against the default set, from one state,
    # the arms' steps interleaved, under deterministic algorithms: BERT fp32
    # b 8 (phase 5's program), BERT bf16 b 256 (phase 5b's) and the
    # Transformer-base at b 256, s 64, bf16 (phase 9's). Losses and every
    # persistable bit-equal over the steps, the same launches a step in both
    # arms, no forward re-run
    scan_cfg = BertConfig.tiny() if rehearsal else BertConfig.base()
    if rehearsal:
        scan_cfg.num_layers = 4  # a forward run to fuse
    scan_b = 4 if rehearsal else 256
    nl_s = scan_cfg.num_layers
    scan_want = dict(zero_launches, mha_short_fwd=nl_s, mha_short_bwd=nl_s,
                     layer_norm_bwd=2 * nl_s + 2)
    main_s1, startup_s1, loss_s1 = pretrain(scan_cfg)
    main_s2, startup_s2, h_s2, _ = amp_pretrain(scan_cfg, scan_b, mlm_only=True, max_preds=tp)
    main_s3, startup_s3, h_s3, _ = tf_programs(tcfg, tf_b)
    scan_cases = [
        (f"scan bert fp32 b {tb}", main_s1, startup_s1, feed, [loss_s1], None, 75),
        (f"scan bert bf16 b {scan_b}", main_s2, startup_s2,
         bert_pretrain_feed(np, np.random.RandomState(args.seed), scan_cfg, scan_b, ts, tp),
         [h_s2["loss"]], "bfloat16", 75),
        (f"scan transformer b {tf_b}", main_s3, startup_s3, feed_9, [h_s3["loss"]],
         "bfloat16", 100),
    ]
    # the scan path's launches: the fused arm's timed steps only, as
    # run_steps counts the other paths'
    path_launches["scan"] = dict(zero_launches)
    for tag, main_p, startup_p, feed_p, fetch_p, amp_dtype, ops_want in scan_cases:
        want_p = tf_want if "transformer" in tag else scan_want
        scope_p = fluid.Scope()
        exe_t.run(startup_p, scope=scope_p)
        state_p = snapshot(main_p, scope_p)
        del scope_p
        res = passes_ab(tag, main_p, state_p, feed_p, fetch_p, TRAIN_STEPS, want_p,
                        amp_dtype=amp_dtype, modes=("on", "scan"), exact=True)
        pass_ab[tag] = res
        on, sc = res["on"], res["scan"]
        for n, c in sc["launches"].items():
            path_launches["scan"][n] += c
        print(f"[scan] {tag}: ops after the passes {on['ops']} (default) -> {sc['ops']} "
              f"(with fuse_layer_scan), counters {sc['counters']}; step p50 "
              f"{on['p50']:.2f} -> {sc['p50']:.2f} ms; host issue {on['host']:.2f} -> "
              f"{sc['host']:.2f} ms; busy {on['busy']:.2f} -> {sc['busy']:.2f} ms, idle "
              f"{on['idle']:.2f} -> {sc['idle']:.2f}; max_memory_allocated "
              f"{on['peak'] / 2**20:.0f} -> {sc['peak'] / 2**20:.0f} MiB (both arms' state "
              f"held); card {smi}")
        if not rehearsal:
            require(sc["ops"] == ops_want, f"[{tag}] {sc['ops']} ops after the passes with "
                    f"fuse_layer_scan, the JAX package gives {ops_want}")
        del state_p
    print(f"[scan] launches over the scan path (the fused arm's {TRAIN_STEPS} timed steps "
          f"of each case): {path_launches['scan']}")

    elapsed("phase 13")
    # ---- 13. conv: VGG-16, SE-ResNeXt-50 and LeNet-5 training ---------------
    # VGG-16 and SE-ResNeXt-50 at b 64, 224x224, 1000 classes,
    # mixed_precision.decorate(Momentum(lr, 0.9)) in bf16; LeNet-5 at b 64,
    # 1x28x28, fp32. Then VGG-11 and SE-ResNeXt-26 at b 2, 3 steps each from
    # one state on the card and on the CPU, at phase 8's gates; then the new
    # ops and their grads card vs CPU. The conv paths launch none of the
    # kernels: their convolutions are cuDNN's, as the JAX package leaves
    # them to XLA. SE-ResNeXt takes ResNet-50's lr 0.1 (bench_resnet);
    # VGG and LeNet, whose fc stacks have no batch norm, take 0.01, the VGG
    # paper's (at 0.1 VGG-16's loss went 6.97, 6.31, 6.56, 21.75, 42.5 on
    # the card)
    cv_b, cv_hw = (4, 32) if rehearsal else (64, 224)
    cv_lrs = {"vgg": 0.01, "se_resnext": 0.01 if rehearsal else RN_LR, "lenet": 0.01}

    def conv_programs(kind, b, hw, amp, depth=None, classes=1000):
        main_p, startup_p = fluid.Program(), fluid.Program()
        main_p.random_seed = startup_p.random_seed = args.seed + 5
        with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
            img = layers.data("img", [b, 1 if kind == "lenet" else 3, hw, hw],
                              append_batch_size=False)
            label = layers.data("label", [b, 1], dtype="int64", append_batch_size=False)
            if kind == "vgg":
                out = vgg.vgg(img, label, depth=depth, class_num=classes)
            elif kind == "se_resnext":
                out = se_resnext.se_resnext(img, label, depth=depth, class_num=classes)
            else:
                out = lenet.lenet5(img, label, class_num=classes)
            opt = fluid.optimizer.Momentum(cv_lrs[kind], RN_MOMENTUM)
            (mixed_precision.decorate(opt) if amp else opt).minimize(out[1])
        return main_p, startup_p, out[1]

    def conv_feed(b, channels, hw, classes, seed, device):
        rs = np.random.RandomState(seed)
        return {"img": torch.from_numpy(rs.rand(b, channels, hw, hw).astype("float32")).to(device),
                "label": torch.from_numpy(rs.randint(0, classes, (b, 1)).astype("int64")).to(device)}

    cv_place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)
    cv_launches = dict(zero_launches)
    kernels.reset_launch_counts()
    conv_cases = [("VGG-16", "vgg", 16, cv_b, cv_hw, 1000, True),
                  (f"SE-ResNeXt-{26 if rehearsal else 50}", "se_resnext",
                   26 if rehearsal else 50, cv_b, cv_hw, 1000, True),
                  ("LeNet-5", "lenet", None, 8 if rehearsal else 64, 28, 10, False)]
    for name, kind, depth, b, hw, classes, amp in conv_cases:
        main_p, startup_p, loss_p = conv_programs(kind, b, hw, amp, depth, classes)
        feed_p = conv_feed(b, 1 if kind == "lenet" else 3, hw, classes, args.seed, dev)
        scope_p = fluid.Scope()
        exe_p = fluid.Executor(cv_place)
        if not rehearsal:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        exe_p.run(startup_p, scope=scope_p)
        got, ms, per = run_steps(main_p, scope_p, feed_p, [loss_p], TRAIN_STEPS, exe_p,
                                 tag=f"conv {name}")
        peak_p = torch.cuda.max_memory_allocated() if not rehearsal else 0
        for counts in per:
            cv_launches = {n: cv_launches[n] + counts[n] for n in cv_launches}
        losses_p = [g[0] for g in got]
        p50_p = statistics.median(ms[1:])
        print(f"[conv] {name}, b {b}, {hw}x{hw}, {'bf16 AMP around ' if amp else ''}"
              f"Momentum({cv_lrs[kind]}, {RN_MOMENTUM}), {len(main_p.global_block().ops)} ops: losses "
              f"{losses_p}; step time p50 {p50_p:.2f} ms over steps 2-{TRAIN_STEPS} (first "
              f"{ms[0]:.2f} ms); {b / p50_p * 1e3:.1f} images/s; max_memory_allocated "
              f"{peak_p / 2**20:.0f} MiB (startup state + {TRAIN_STEPS} steps); card {smi}")
        require(all(math.isfinite(x) for x in losses_p), f"[conv] {name}: losses {losses_p}")
        require(losses_p[-1] < losses_p[0], f"[conv] {name}: the loss did not fall: {losses_p}")
        require(exe_p.recomputed_forwards == [], f"[conv] {name}: an __auto_grad__ re-ran a "
                f"forward: {exe_p.recomputed_forwards}")
        step = lambda: exe_p.run(main_p, feed=dict(feed_p),  # noqa: E731
                                 fetch_list=[loss_p], scope=scope_p)
        if not rehearsal:
            profile_step(torch, step, f"one {name} training step at b {b}")
        if kind != "lenet":
            host_breakdown(step, f"host {name}")
        del scope_p, exe_p, step
    path_launches["conv"] = cv_launches
    print(f"[conv] launches over {TRAIN_STEPS} steps of each model: {cv_launches}")
    require(cv_launches == zero_launches, f"the conv path launched a kernel: {cv_launches}")

    # card vs CPU: VGG-11 and SE-ResNeXt-26 at b 2, fp32, each of 3 steps
    # from the same state, at phase 8's gates
    for name, kind, depth in (("VGG-11", "vgg", 11), ("SE-ResNeXt-26", "se_resnext", 26)):
        main_p, startup_p, loss_p = conv_programs(kind, RN_PARITY_BATCH, cv_hw, False, depth)
        feed_c = conv_feed(RN_PARITY_BATCH, 3, cv_hw, 1000, args.seed + 1, dev)
        feed_h = {n: t.cpu() for n, t in feed_c.items()}
        scopes = {"card": fluid.Scope(), "cpu": fluid.Scope()}
        exes = {"card": fluid.Executor(cv_place), "cpu": fluid.Executor(fluid.CPUPlace())}
        exes["card"].run(startup_p, scope=scopes["card"])
        exes["cpu"].run(startup_p, scope=scopes["cpu"])
        persist = [v.name for v in main_p.list_vars() if v.persistable]
        worst_loss, worst_stat, worst_grad = 0.0, (0.0, ""), (0.0, "")
        for i in range(PARITY_STEPS):
            state = {n: to_numpy(scopes["card"].get(n)) for n in persist
                     if scopes["card"].has(n)}
            fluid.io.set_persistables_from_numpy(scopes["cpu"], state, "cpu")
            ls = {w: float(exes[w].run(main_p, feed=dict(feed_c if w == "card" else feed_h),
                                       fetch_list=[loss_p], scope=scopes[w])[0].reshape(-1)[0])
                  for w in ("card", "cpu")}
            loss_rel = abs(ls["card"] - ls["cpu"]) / abs(ls["cpu"])
            stat, grad = (0.0, ""), (0.0, "")
            for n in persist:
                a, c = to_numpy(scopes["card"].get(n)), to_numpy(scopes["cpu"].get(n))
                if n.endswith((".mean", ".var")):
                    stat = max(stat, (float(np.abs(a - c).max() / max(float(np.abs(c).max()),
                                                                      1e-12)), n))
                else:
                    grad = max(grad, (float(np.linalg.norm(a - c) / max(
                        float(np.linalg.norm(c)), 1e-12)), n))
            print(f"[conv] card vs CPU, {name} b {RN_PARITY_BATCH} {cv_hw}x{cv_hw} fp32 step "
                  f"{i + 1} from the same state: losses {ls['card']} vs {ls['cpu']} (rel diff "
                  f"{loss_rel:.3e}, tol {RN_LOSS_RTOL}); running stats max|diff| / max|value| "
                  f"{stat[0]:.3e} ({stat[1]}; tol {RN_STAT_RTOL}); parameters and velocities "
                  f"|diff| / |value| {grad[0]:.3e} ({grad[1]}; tol {RN_GRAD_NRTOL})")
            worst_loss = max(worst_loss, loss_rel)
            worst_stat, worst_grad = max(worst_stat, stat), max(worst_grad, grad)
        require(worst_loss <= RN_LOSS_RTOL and worst_stat[0] <= RN_STAT_RTOL
                and worst_grad[0] <= RN_GRAD_NRTOL,
                f"{name} card vs CPU: loss rel diff {worst_loss}, running stats "
                f"{worst_stat}, parameters and velocities {worst_grad}")
        del scopes, exes, state

    # the new ops and their grads, card vs CPU on the same inputs
    def op_case(build):
        """A program of one op and the grads of its inputs -> (main, startup,
        fetch list)."""
        main_p, startup_p = fluid.Program(), fluid.Program()
        with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
            out, inputs = build()
            g = layers.data("g", list(out.shape), append_batch_size=False, stop_gradient=True)
            fetch = [out] + fluid.gradients([out], inputs, target_gradients=[g])
        return main_p, startup_p, fetch

    def data(name, shape):
        return layers.data(name, shape, append_batch_size=False, stop_gradient=False)

    def conv_t_op(groups, pads, out_shape):
        x, w = data("x", [2, 4, 5, 5]), data("w", [4, 6 // groups, 3, 3])
        out = fluid.default_main_program().global_block().create_var(
            name="conv_t_out", shape=out_shape, dtype="float32")
        fluid.default_main_program().global_block().append_op(
            "conv2d_transpose", {"Input": [x], "Filter": [w]}, {"Output": [out]},
            {"strides": [2, 2], "paddings": pads, "dilations": [1, 1], "groups": groups})
        return out, [x, w]

    rs_op = np.random.RandomState(args.seed + 6)
    op_cases = {
        "sigmoid": lambda: (lambda x: (layers.sigmoid(x), [x]))(data("x", [3, 7])),
        "adaptive_pool2d avg 4x3 of 9x7": lambda: (lambda x: (layers.adaptive_pool2d(
            x, [4, 3], pool_type="avg"), [x]))(data("x", [2, 3, 9, 7])),
        "adaptive_pool2d max 3x1 of 9x7": lambda: (lambda x: (layers.adaptive_pool2d(
            x, [3, 1], pool_type="max"), [x]))(data("x", [2, 3, 9, 7])),
        "conv2d_transpose s2 groups 2": lambda: conv_t_op(2, [1, 1], [2, 6, 9, 9]),
        "conv2d_transpose s2 pads 0,1,1,0": lambda: conv_t_op(1, [0, 1, 1, 0],
                                                              [2, 6, 10, 10]),
        "conv3d s[1,2,1] p1 groups 2": lambda: (lambda x: (layers.conv3d(
            x, 6, 3, stride=[1, 2, 1], padding=1, groups=2), [x]))(data("x", [2, 4, 5, 6, 7])),
    }
    for name, build in op_cases.items():
        main_p, startup_p, fetch = op_case(build)
        block = main_p.global_block()
        feed_o = {}
        for v in block.vars.values():
            if v.is_data:
                shape = [d if d > 0 else 1 for d in v.shape]
                feed_o[v.name] = rs_op.randn(*shape).astype("float32")
        outs = []
        for place in (cv_place, fluid.CPUPlace()):
            scope_o = fluid.Scope()
            exe_o = fluid.Executor(place)
            exe_o.run(startup_p, scope=scope_o)
            if outs:  # the CPU takes the card's parameters
                fluid.io.set_persistables_from_numpy(scope_o, outs[0][1], "cpu")
            params = {v.name: to_numpy(scope_o.get(v.name)) for v in main_p.list_vars()
                      if v.persistable and scope_o.has(v.name)}
            outs.append((exe_o.run(main_p, feed=dict(feed_o), fetch_list=fetch, scope=scope_o),
                         params))
        worst = max(float(np.abs(a - c).max() / max(1.0, float(np.abs(c).max())))
                    for a, c in zip(outs[0][0], outs[1][0]))
        print(f"[conv] {name}: op and grads card vs CPU max|diff| / max(1, max|value|) "
              f"{worst:.3e} (tol 1e-4); shapes {[tuple(o.shape) for o in outs[0][0]]}")
        require(worst <= 1e-4 and all(np.isfinite(o).all() for o in outs[0][0]),
                f"[conv] {name}: card vs CPU {worst}")

    elapsed("phase 14")
    # ---- 14. serving at scale ---------------------------------------------------
    # 14a: BERT-base exported with a batch placeholder, served in-process by
    # a batch-of-1 server (max_queue 16) and a coalescing one (10 ms window,
    # buckets 1..64, max_queue 256, every bucket prewarmed); 64 client
    # threads in a closed loop send 1-row requests of seeded lengths, a 503
    # sent again after its Retry-After (a 10 ms retry storm of 48 shed
    # clients starved the batch-of-1 server's dispatches of the GIL). Each coalesced reply: a row of its merged
    # dispatch, intact; a second dispatch of that merged batch gives the
    # same bits; within 1e-4 of its batch-of-1 dispatch (bit-equality to
    # it counted, and probed bucket by bucket)
    import hashlib

    from paddle_tpu_torch.inference.decode_model import (
        DecodeService, ToyDecodeModel, make_toy_decode_weights, save_decode_weights)
    from paddle_tpu_torch.inference.kv_cache import PagedDecodeStepBatcher, PagedKVCache

    sv_cfg = BertConfig.tiny() if rehearsal else BertConfig.base()
    sv_s = 32 if rehearsal else 128
    sv_clients, sv_total = (24, 64) if rehearsal else (64, SERVE_REQUESTS)
    buckets = [1, 2, 4, 8, 16, 32, 64]
    sv_dir = ROOT / "build" / "chip_smoke" / "bert_batch"
    sv_name = export_bert_encoder(sv_cfg, sv_s, args.seed + 14, ab_place, [sv_dir])
    sv_width = sv_cfg.hidden_size
    rs14 = np.random.RandomState(args.seed + 14)
    sv_feeds, sv_bodies = [], []
    for _ in range(16 if rehearsal else 64):  # distinct request bodies
        length = rs14.randint(sv_s // 8, sv_s + 1)
        feed = {"src_ids": rs14.randint(0, sv_cfg.vocab_size, (1, sv_s)).astype(np.int64),
                "sent_ids": (np.arange(sv_s)[None, :] >= length // 2).astype(np.int64),
                "pos_ids": np.arange(sv_s, dtype=np.int64)[None, :],
                "input_mask": (np.arange(sv_s)[None, :] < length).astype(np.float32)}
        buf = io.BytesIO()
        np.savez(buf, **feed)
        sv_feeds.append(feed)
        sv_bodies.append(buf.getvalue())

    t0 = time.perf_counter()
    srv_b1 = InferenceServer(str(sv_dir), device=dev.type, max_queue=16)
    srv_co = InferenceServer(str(sv_dir), device=dev.type, max_queue=256, batch_window_ms=10,
                             bucket_table={"default": buckets, "per_feed": {}})
    require(srv_co._batchable, "the batch-placeholder export is not batchable")
    for rows in buckets:  # one dispatch a bucket before any request
        srv_co.predict({k: np.repeat(v, rows, axis=0) for k, v in sv_feeds[0].items()})
    print(f"[serve14] two servers up, every bucket prewarmed, in "
          f"{time.perf_counter() - t0:.1f} s")
    b1_refs = [srv_b1.predict(f)[sv_name] for f in sv_feeds]
    co_predict = srv_co.predict
    dispatches = []  # (merged feeds, outputs) of every coalesced dispatch

    def spy(feeds, _deadline=None):
        outs = co_predict(feeds, _deadline)
        dispatches.append((feeds, outs[sv_name]))
        return outs

    srv_co.predict = spy
    sv_threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in (srv_b1, srv_co)]
    for t in sv_threads:
        t.start()
    serve_runs = {}
    for tag, srv in (("b1", srv_b1), ("coalesced", srv_co)):
        c0 = srv.counters()
        kernels.reset_launch_counts()
        wall, lats, replies, sheds = closed_loop(
            sv_clients, sv_total,
            lambda i, port=srv.port: http(port, "/predict", sv_bodies[i % len(sv_bodies)]))
        if not rehearsal:
            torch.cuda.synchronize()
        path_launches[f"serve_{tag}"] = launches = kernels.launch_counts()
        c1 = srv.counters()
        delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in
                 ("serve_batches", "serve_batch_members", "serve_batch_padded_rows",
                  "serve_coalesce_wait_ms", "serve_requests")}
        n_disp = delta["serve_batches"] if tag == "coalesced" else sv_total
        require(all(r[0] == 200 for r in replies.values()) and len(replies) == sv_total,
                f"[serve14] {tag}: non-200 replies "
                f"{sorted({r[0] for r in replies.values()})}")
        if not rehearsal:
            require(launches["mha_short_fwd"] == sv_cfg.num_layers * n_disp,
                    f"[serve14] {tag}: the short kernel launched {launches['mha_short_fwd']} "
                    f"times over {n_disp} dispatches, want {sv_cfg.num_layers} a dispatch")
        serve_runs[tag] = dict(
            requests_per_s=sv_total / wall, p50_ms=pctl(lats, 0.5), p99_ms=pctl(lats, 0.99),
            sheds=sheds, dispatches=n_disp, batch_size_p50=c1.get("serve_batch_size_p50"),
            padded_rows=delta["serve_batch_padded_rows"],
            coalesce_wait_ms=delta["serve_coalesce_wait_ms"],
            short_fwd_launches=launches["mha_short_fwd"])
        print(f"[serve14] {tag}: {sv_total} requests from {sv_clients} clients in {wall:.2f} s: "
              f"{sv_total / wall:.1f} requests/s, p50 {pctl(lats, 0.5):.2f} ms, p99 "
              f"{pctl(lats, 0.99):.2f} ms, {sheds} sheds retried, {n_disp} dispatches, "
              f"serve_batch_size_p50 {c1.get('serve_batch_size_p50')}, padded rows "
              f"{delta['serve_batch_padded_rows']}, launches {launches}; card {smi}")
        if tag == "coalesced":
            co_replies, co_delta = replies, delta
    srv_co.predict = co_predict
    # coalescing over the whole run: requests a dispatch from the phase's
    # counter deltas. serve_batch_size_p50 is the median of the last 64
    # batches only, so the closed loop's tail decided it. The gate is no
    # weaker: a median above 1 over 64 batches has at least half of them
    # at 2 rows or more, so their mean is at least (32 * 1 + 32 * 2) / 64
    # = 1.5, and a mean of 1.5 over the whole run asks the same of every
    # batch, the tail's too
    members_per_dispatch = co_delta["serve_batch_members"] / max(co_delta["serve_batches"], 1)
    serve_runs["coalesced"]["members_per_dispatch"] = members_per_dispatch
    print(f"[serve14] coalesced: {co_delta['serve_batch_members']} requests over "
          f"{co_delta['serve_batches']} dispatches, {members_per_dispatch:.3f} a dispatch "
          f"(gate >= 1.5); serve_batch_size_p50 {serve_runs['coalesced']['batch_size_p50']}")
    require(members_per_dispatch >= 1.5,
            f"[serve14] too little coalescing: {members_per_dispatch:.3f} requests a "
            f"dispatch over the run (gate 1.5); serve_batch_size_p50 "
            f"{serve_runs['coalesced']['batch_size_p50']}")
    # every reply an intact row of its dispatch; a second dispatch of each
    # merged batch bit-equal to the first; within 1e-4 of batch-of-1
    rows_of = {}
    for d, (feeds, out) in enumerate(dispatches):
        for j in range(len(out)):
            rows_of.setdefault(hashlib.blake2b(out[j].tobytes()).digest(), (d, j))
    redispatch_equal = all(np.array_equal(co_predict(feeds)[sv_name], out)
                           for feeds, out in dispatches)
    require(redispatch_equal, "[serve14] a second dispatch of a merged batch differs")
    co_worst, co_bitwise = 0.0, 0
    for i, (_, _, body) in co_replies.items():
        out = np.load(io.BytesIO(body))[sv_name]
        require(out.shape == (1, sv_s, sv_width) and bool(np.isfinite(out).all()),
                f"[serve14] reply {i}: shape {out.shape} or non-finite")
        require(hashlib.blake2b(out[0].tobytes()).digest() in rows_of,
                f"[serve14] reply {i} is no row of its merged dispatch")
        ref = b1_refs[i % len(sv_bodies)]
        co_worst = max(co_worst, float(np.abs(out - ref).max()))
        co_bitwise += bool(np.array_equal(out, ref))
    require(co_worst <= 1e-4, f"[serve14] coalesced vs batch-of-1 max abs diff {co_worst}")
    print(f"[serve14] {sv_total} coalesced replies: each a row of its dispatch, "
          f"{len(dispatches)} merged dispatches re-run bit-equal; vs batch-of-1 max abs diff "
          f"{co_worst:.3e} (gate 1e-4), bit-equal {co_bitwise} of {sv_total}")
    # bucket by bucket: a merged batch of distinct requests, twice
    bucket_rows = {}
    for rows in buckets:
        group = [sv_feeds[j % len(sv_feeds)] for j in range(rows)]
        merged = {k: np.concatenate([f[k] for f in group]) for k in group[0]}
        first = co_predict(merged)[sv_name]
        t0 = time.perf_counter()
        second = co_predict(merged)[sv_name]
        ms = (time.perf_counter() - t0) * 1e3
        diffs = [float(np.abs(first[j] - b1_refs[j % len(sv_feeds)][0]).max())
                 for j in range(rows)]
        bucket_rows[rows] = dict(
            deterministic=bool(np.array_equal(first, second)), dispatch_ms=ms,
            rows_bitwise_to_b1=sum(d == 0.0 for d in diffs), max_abs_diff=max(diffs))
        require(bucket_rows[rows]["deterministic"] and max(diffs) <= 1e-4,
                f"[serve14] bucket {rows}: {bucket_rows[rows]}")
        print(f"[serve14] bucket {rows:2d}: two dispatches bit-equal; rows bit-equal to "
              f"batch-of-1 {bucket_rows[rows]['rows_bitwise_to_b1']} of {rows}, max abs diff "
              f"{max(diffs):.3e}; dispatch {ms:.2f} ms (host wall, synchronised)")
    cpu_pred = create_paddle_predictor(_cpu_config(AnalysisConfig, sv_dir))
    sv_cpu = max(float(np.abs(cpu_pred.run(dict(f))[0] - b1_refs[j]).max())
                 for j, f in enumerate(sv_feeds[:2]))
    require(sv_cpu <= 1e-3, f"[serve14] card vs CPU max abs diff {sv_cpu} > 1e-3")
    print(f"[serve14] card vs CPU (2 requests): max abs diff {sv_cpu:.3e} (tol 1e-3)")
    del cpu_pred
    sv_idle = None
    if not rehearsal:
        merged64 = {k: np.concatenate([sv_feeds[j % len(sv_feeds)][k] for j in range(64)])
                    for k in sv_feeds[0]}
        wall_ms, busy_ms, _ = profile_step(torch, lambda: co_predict(merged64),
                                           "one bucket-64 dispatch")
        sv_idle = max(0.0, 1 - busy_ms / wall_ms) if busy_ms else None
    for srv, t in zip((srv_b1, srv_co), sv_threads):
        srv.shutdown()
        srv.close()
        t.join(30)
    del dispatches, co_replies

    # 14b: the breaker and the drain through a subprocess server on the card
    def subprocess_server(tag, plan, extra=()):
        ready = ROOT / "build" / "chip_smoke" / f"ready_{tag}.json"
        ready.unlink(missing_ok=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT), PADDLE_TPU_FAULTS=plan)
        log = open(ROOT / "build" / "chip_smoke" / f"server_{tag}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.server", "--model-dir",
             str(sv_dir), "--device", dev.type, "--ready-file", str(ready),
             "--batch-window-ms", "10", *extra],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        deadline = time.monotonic() + 300
        while not ready.exists():
            require(proc.poll() is None and time.monotonic() < deadline,
                    f"[serve14] {tag}: the server exited or never wrote its ready-file "
                    f"(see {log.name})")
            time.sleep(0.05)
        info = json.loads(ready.read_text())
        require(info["pid"] == proc.pid, f"[serve14] ready-file pid {info}")
        return proc, info["port"], log

    def healthz(port):
        code, _, body = http(port, "/healthz", None, timeout=60)
        return code, json.loads(body)

    def wait_for(cond, what, timeout=120):
        deadline = time.monotonic() + timeout
        while not cond():
            require(time.monotonic() < deadline, f"[serve14] timed out waiting for {what}")
            time.sleep(0.02)

    t0 = time.perf_counter()
    proc, port, log = subprocess_server(
        "breaker", "server.predict:raises=RuntimeError:times=3",
        ("--breaker-threshold", "3", "--probe-interval", "0.2"))
    try:
        codes = [http(port, "/predict", sv_bodies[0])[0] for _ in range(3)]
        require(codes == [500, 500, 500], f"[serve14] breaker: codes {codes}")
        code, health = healthz(port)
        require(code == 503 and health["status"] == "breaker_open", f"breaker: {code} {health}")
        wait_for(lambda: healthz(port)[0] == 200, "the probe to close the breaker")
        code, _, body = http(port, "/predict", sv_bodies[1])
        out = np.load(io.BytesIO(body))[sv_name] if code == 200 else None
        require(out is not None and float(np.abs(out - b1_refs[1]).max()) <= 1e-4,
                f"[serve14] breaker: the request after recovery answered {code}")
        bc = healthz(port)[1]["counters"]
        require(bc["serve_breaker_trips"] == 1 and bc["serve_breaker_recovered"] == 1,
                f"[serve14] breaker counters {bc}")
        proc.send_signal(signal.SIGTERM)
        require(proc.wait(timeout=120) == 0, "[serve14] breaker server: exit code")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    breaker_s = time.perf_counter() - t0
    print(f"[serve14] breaker: 3 failures -> /healthz 503 breaker_open -> the probe "
          f"recovered it -> 200; trips 1, recovered 1; SIGTERM exit 0 ({breaker_s:.1f} s)")

    t0 = time.perf_counter()
    gate = ROOT / "build" / "chip_smoke" / "drain_gate"
    gate.unlink(missing_ok=True)
    drain_timeout, n_parked = 120, 16
    proc, port, log = subprocess_server("drain", f"server.predict:hold={gate}",
                                        ("--max-queue", "32", "--drain-timeout",
                                         str(drain_timeout)))
    try:
        parked = [None] * n_parked

        def parked_call(i):
            parked[i] = http(port, "/predict", sv_bodies[i])

        ts = [threading.Thread(target=parked_call, args=(i,), daemon=True)
              for i in range(n_parked)]
        for t in ts:
            t.start()
        wait_for(lambda: healthz(port)[1]["queue_depth"] == n_parked, "16 parked requests")
        t_term = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        wait_for(lambda: healthz(port)[0] == 503, "/healthz 503 during the drain")
        require(healthz(port)[1]["status"] == "draining", "[serve14] drain: status")
        code, _, body = http(port, "/predict", sv_bodies[0])
        require(code == 503 and json.loads(body)["error"] == "ServerDraining",
                f"[serve14] drain: a new request answered {code}")
        gate.touch()
        for t in ts:
            t.join(timeout=drain_timeout)
        rc = proc.wait(timeout=drain_timeout)
        drain_s = time.monotonic() - t_term
        require(rc == 0 and drain_s <= drain_timeout, f"[serve14] drain: exit {rc} after "
                f"{drain_s:.1f} s")
        drain_worst = 0.0
        for i, r in enumerate(parked):
            require(r is not None and r[0] == 200, f"[serve14] drain: parked {i} -> {r and r[0]}")
            out = np.load(io.BytesIO(r[2]))[sv_name]
            require(out.shape == (1, sv_s, sv_width) and bool(np.isfinite(out).all()),
                    f"[serve14] drain: reply {i} torn")
            drain_worst = max(drain_worst, float(np.abs(out - b1_refs[i]).max()))
        require(drain_worst <= 1e-4, f"[serve14] drain: replies vs batch-of-1 {drain_worst}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    print(f"[serve14] drain: {n_parked} parked requests, SIGTERM -> /healthz 503 draining, a "
          f"new request 503 ServerDraining, all {n_parked} replies 200 and whole (vs "
          f"batch-of-1 {drain_worst:.3e}), exit 0 {drain_s:.1f} s after SIGTERM "
          f"({time.perf_counter() - t0:.1f} s with start-up)")

    # 14c: the generative roles. A prefill-role, a decode-role and a unified
    # server, the default KV profile's pool; 64 concurrent /generate requests
    # (prompts of 8-40 seeded tokens, max_new 16), then the same prompts
    # split: /prefill, the blob forwarded by this client to /decode. Every
    # split reply equals the unified reply bit for bit
    def generative(tag, weights, n_prompts=64, max_new=16):
        wpath = ROOT / "build" / "chip_smoke" / f"decode_{tag}.npz"
        save_decode_weights(str(wpath), weights)
        vocab = int(weights["E"].shape[0])
        rs_g = np.random.RandomState(args.seed + 140)
        prompts = [rs_g.randint(0, vocab, rs_g.randint(8, 41)).astype(np.int32)
                   for _ in range(n_prompts)]
        bodies = []
        for p in prompts:
            buf = io.BytesIO()
            np.savez(buf, tokens=p, max_new=np.int32(max_new))
            bodies.append(buf.getvalue())
        # the default profile's geometry; its admission window raised from
        # 0 to 30 s, so a stream the pool cannot hold yet waits on the
        # cache's condition for pages instead of a 503 the client re-sends
        srvs = {role: InferenceServer(str(sv_dir), device=dev.type, decode_weights=str(wpath),
                                      role=role, max_queue=256, warmup=False,
                                      kv_config={"admission_window_ms": 30_000})
                for role in ("prefill", "decode", "unified")}
        ths = [threading.Thread(target=s.serve_forever, daemon=True) for s in srvs.values()]
        for t in ths:
            t.start()
        try:
            uni = srvs["unified"]
            peak = [0]
            sampling = threading.Event()

            def sample():
                while not sampling.is_set():
                    peak[0] = max(peak[0], uni._decode.cache.counters.snapshot().get(
                        "kv_pages_in_use", 0))
                    time.sleep(0.0005)

            steps0 = uni.counters().get("kv_decode_steps", 0)
            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            u_wall, u_lats, u_rep, u_sheds = closed_loop(
                n_prompts, n_prompts, lambda i: http(uni.port, "/generate", bodies[i]))
            sampling.set()
            sampler.join(10)
            u_steps = uni.counters().get("kv_decode_steps", 0) - steps0
            dec = srvs["decode"]

            def split(i):
                code, headers, blob = http(srvs["prefill"].port, "/prefill", bodies[i])
                if code != 200:
                    return code, headers, blob
                return http(dec.port, "/decode", blob)

            d_steps0 = dec.counters().get("kv_decode_steps", 0)
            s_wall, s_lats, s_rep, s_sheds = closed_loop(n_prompts, n_prompts, split)
            s_steps = dec.counters().get("kv_decode_steps", 0) - d_steps0
            replies = {}
            require(len(u_rep) == len(s_rep) == n_prompts, f"[gen14] {tag}: replies lost")
            for i in range(n_prompts):
                (uc, _, ub), (sc, _, sb) = u_rep[i], s_rep[i]
                require(uc == 200 and sc == 200, f"[gen14] {tag} prompt {i}: {uc} / {sc}")
                u, s_ = np.load(io.BytesIO(ub)), np.load(io.BytesIO(sb))
                require(u["tokens"].shape == (max_new,) and u["logits"].shape == (max_new, vocab)
                        and bool(np.isfinite(u["logits"]).all()), f"[gen14] {tag} reply {i}")
                require(np.array_equal(u["tokens"], s_["tokens"])
                        and u["logits"].tobytes() == s_["logits"].tobytes(),
                        f"[gen14] {tag} prompt {i}: the split reply differs from the unified")
                replies[i] = (u["tokens"], u["logits"])
            pages_left = uni._decode.cache.free_pages(), dec._decode.cache.free_pages()
            require(pages_left == (uni._decode.cache.num_pages,) * 2,
                    f"[gen14] {tag}: pages not reclaimed {pages_left}")
            idle = None
            if not rehearsal:
                model = uni._decode_model
                c = uni._decode.cache
                pcache = PagedKVCache(c.num_pages, c.page_len, c.pages_per_seq,
                                      model.num_heads, model.head_dim,
                                      max_streams=c.max_streams, device=dev)
                for j in range(c.max_streams):
                    pcache.acquire(j, total_len=c.page_len)
                pb = PagedDecodeStepBatcher(pcache, model.decode_step)
                toks = np.arange(c.max_streams, dtype=np.int32) % vocab
                # device time from sessions that CUPTI did not empty; the
                # host wall of the same steps (each ends in its copy to
                # the host)
                with torch.no_grad():
                    per_call, _ = kernels.device_kernel_ms(lambda: pb.step(toks), calls=10)
                    t0 = time.perf_counter()
                    for _ in range(10):
                        pb.step(toks)
                    wall_ms = (time.perf_counter() - t0) * 1e2
                busy_ms = sum(per_call.values())
                idle = max(0.0, 1 - busy_ms / wall_ms)
                print(f"[profile] one decode step ({tag} toy, {c.max_streams} streams): wall "
                      f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share {idle:.2f}")
                for name, ms in sorted(per_call.items(), key=lambda kv: -kv[1])[:6]:
                    print(f"[profile]   {ms:8.4f} ms  {name[:90]}")
                del pcache, pb
            stats = dict(
                unified_tokens_per_s=n_prompts * max_new / u_wall,
                split_tokens_per_s=n_prompts * max_new / s_wall,
                unified_p50_ms=pctl(u_lats, 0.5), unified_p99_ms=pctl(u_lats, 0.99),
                split_p50_ms=pctl(s_lats, 0.5), split_p99_ms=pctl(s_lats, 0.99),
                decode_step_ms=u_wall * 1e3 / max(u_steps, 1), decode_steps=u_steps,
                split_decode_step_ms=s_wall * 1e3 / max(s_steps, 1),
                peak_pages_in_use=peak[0], sheds_retried=(u_sheds, s_sheds),
                step_idle_share=idle)
            print(f"[gen14] {tag}: {n_prompts} prompts x {max_new} new tokens, split replies "
                  f"bit-equal to unified; unified {stats['unified_tokens_per_s']:.1f} tokens/s, "
                  f"p50 {stats['unified_p50_ms']:.2f} ms, p99 {stats['unified_p99_ms']:.2f} ms, "
                  f"{u_steps} decode steps, {stats['decode_step_ms']:.3f} ms a step (wall over "
                  f"kv_decode_steps), peak kv_pages_in_use {peak[0]}, sheds retried "
                  f"{u_sheds}; split {stats['split_tokens_per_s']:.1f} tokens/s, p50 "
                  f"{stats['split_p50_ms']:.2f} ms, p99 {stats['split_p99_ms']:.2f} ms, sheds "
                  f"retried {s_sheds}; card {smi}")
            return stats, prompts, replies
        finally:
            for s, t in zip(srvs.values(), ths):
                s.shutdown()
                s.close()
                t.join(30)

    toy = make_toy_decode_weights(seed=7)
    gen_stats = {}
    gen_stats["jax_width"], toy_prompts, toy_replies = generative("jax_width", toy)
    cpu_svc = DecodeService(ToyDecodeModel(toy, device="cpu"))
    try:
        toy_worst = 0.0
        for i, p in enumerate(toy_prompts):
            toks, logits = cpu_svc.generate(p, 16)
            require(np.array_equal(toks, toy_replies[i][0]),
                    f"[gen14] JAX-width toy: card and CPU tokens differ on prompt {i}")
            np.testing.assert_allclose(toy_replies[i][1], logits, rtol=DECODE_RTOL,
                                       atol=DECODE_ATOL)
            toy_worst = max(toy_worst, float(np.abs(toy_replies[i][1] - logits).max()))
    finally:
        cpu_svc.close()
    print(f"[gen14] JAX-width toy: card vs CPU the same tokens, logits within rtol "
          f"{DECODE_RTOL} / atol {DECODE_ATOL} (max abs diff {toy_worst:.3e})")
    if not rehearsal:
        gen_stats["bert_width"], _, _ = generative(
            "bert_width", make_toy_decode_weights(seed=7, vocab=30522, num_heads=12,
                                                  head_dim=64))
    print("[result] serving at scale: " + json.dumps(
        {"serve": serve_runs, "buckets": bucket_rows, "bucket64_idle_share": sv_idle,
         "coalesced_bitwise_to_b1": co_bitwise, "coalesced_max_abs_diff": co_worst,
         "generative": gen_stats}, default=str))

    elapsed("phase 16")
    # ---- 16. registry: N models behind one server ---------------------------
    path_launches["serve_registry"], registry_stats = registry_phase(args.seed, rehearsal, smi)
    print("[result] registry: " + json.dumps(registry_stats, default=str))

    elapsed("phase 17")
    # ---- 17. fleet: N worker processes behind the failover router -------------
    path_launches["serve_fleet"], fleet_stats = fleet_phase(args.seed, rehearsal, smi)
    print("[result] fleet: " + json.dumps(fleet_stats, default=str))

    elapsed("phase 18")
    # ---- 18. dygraph: the eager tape, its layers, and the CUDA graph bridge ----
    path_launches["dygraph"], dygraph_stats = dygraph_phase(args.seed, rehearsal, smi)
    print("[result] dygraph: " + json.dumps(dygraph_stats, default=str))

    elapsed("phase 19")
    # ---- 19. data: DataLoader, train_from_dataset, the cursor, single-file io --
    path_launches["data"], data_stats = data_phase(args.seed, rehearsal, smi)
    print("[result] data: " + json.dumps(data_stats, default=str))

    elapsed("phase 20")
    # ---- 20. resilience: snapshots, the supervised job, the NaN guard ---------
    path_launches["resilience"], resilience_stats = resilience_phase(args.seed, rehearsal, smi)
    print("[result] resilience: " + json.dumps(resilience_stats, default=str))

    elapsed("phase 21")
    # ---- 21. mesh: CompiledProgram, the one-rank NCCL mesh, ZeRO-1, restore ----
    path_launches["mesh"], mesh_stats = mesh_phase(args.seed, rehearsal, smi)
    print("[result] mesh: " + json.dumps(mesh_stats, default=str))

    elapsed("phase 22")
    # ---- 22. repeated: run_repeated as captured CUDA graphs -------------------
    path_launches["repeated"], repeated_stats = repeated_phase(args.seed, rehearsal, smi)
    print("[result] repeated: " + json.dumps(repeated_stats, default=str))

    elapsed("phase 23")
    # phase 24's ranks import while phase 23 runs
    seq_started = start_seq_workers(args.seed, rehearsal)
    try:
        # ---- 23. collective: fleet, ZeRO-1 + autoshard, the model-axis mesh, the planner
        path_launches["collective"], collective_stats = collective_phase(args.seed, rehearsal,
                                                                         smi)
        print("[result] collective: " + json.dumps(collective_stats, default=str))

        elapsed("phase 24")
        # ---- 24. sequence: the ring, Ulysses, the sequence layout, the expert rule
        path_launches["sequence"], sequence_stats, ring_rows = sequence_phase(
            args.seed, rehearsal, smi, seq_started)
        print("[result] sequence: " + json.dumps(sequence_stats, default=str))
    finally:
        stop_seq_workers(seq_started)

    elapsed("phase 25")
    # ---- 25. result ------------------------------------------------------
    sources = {
        "mha_short_fwd": ("paddle_tpu_torch/ops/kernels/csrc/mha_short_fwd.cu",
                          "paddle_tpu/ops/pallas/mha_short.py:383"),
        "mha_short_bwd": ("paddle_tpu_torch/ops/kernels/csrc/mha_short_bwd.cu",
                          "paddle_tpu/ops/pallas/mha_short.py:406"),
        "flash_fwd": ("paddle_tpu_torch/ops/kernels/csrc/flash_fwd.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:79"),
        "flash_bwd": ("paddle_tpu_torch/ops/kernels/csrc/flash_bwd.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:227"),
        "layer_norm_bwd": ("paddle_tpu_torch/ops/kernels/csrc/layer_norm_bwd.cu",
                           "paddle_tpu/ops/pallas/layer_norm.py:23"),
        "fused_prologue_conv1x1": ("paddle_tpu_torch/ops/kernels/csrc/fused_block.cu",
                                   "tools/fused_block_pallas.py:51"),
        "conv1x1_with_stats": ("paddle_tpu_torch/ops/kernels/csrc/fused_block.cu",
                               "tools/fused_block_pallas.py:88"),
    }
    # the main path's row: the fused-block A/B runs bf16, the others fp32
    main_dtype = {"fused_prologue_conv1x1": "bfloat16", "conv1x1_with_stats": "bfloat16"}
    for path, counts in path_launches.items():
        print(f"[result] launches on the {path} path's run: {counts}")
    for path, counts in causal_launches.items():
        print(f"[result] causal attention launches on the {path} path's run: {counts}")
    print("[result] passes off / on, and on / scan (ms; MiB): " + json.dumps(
        {path: {mode: {k: round(v / 2**20 if k == "peak" else v, 2) for k, v in arm.items()
                       if isinstance(v, (int, float))}
                for mode, arm in arms.items()} for path, arms in pass_ab.items()}))
    line = []
    for name, rows in results.items():
        dtype = main_dtype.get(name, "float32")
        main_row = next(r for r in rows if r["dtype"] == dtype)  # main-path shape
        # the first 16-bit rows at the main row's shape (its layout), where
        # the kernel has them
        other = {}
        for tag, dt in (("bf16", "bfloat16"), ("fp16", "float16")):
            row = next((r for r in rows[rows.index(main_row):] if r["dtype"] == dt
                        and r["shape"] == main_row["shape"]), None)
            if row is not None and dt != dtype:
                other[tag] = {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "tol")} | {"max_abs_err": row["err"]}
        line.append({**other,
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": sum(c[name] for c in path_launches.values()),
            "max_abs_err": main_row["err"], "tol": TOL.get(dtype) if name not in main_dtype
            else f"{fb.Y_RTOL[getattr(torch, dtype)]}|y| + {fb.Y_ATOL[getattr(torch, dtype)]}",
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": list(main_row["shape"]), "dtype": dtype,
            "causal_launches": sum(c.get(name, 0) for c in causal_launches.values()),
            "seed_ptr": seed_ptr.get(name, []),
            "half_heads": half_heads.get(name, []),
            # phase 24: its path's launches; (a)'s ring passes of the flash kernels
            "sequence_launches": path_launches["sequence"][name],
            **({"ring": ring_rows} if name in ("flash_fwd", "flash_bwd") else {}),
        })
    require(sorted(r["name"] for r in line) == sorted(kernels.LAUNCHES),
            "the result line must list every kernel")
    print(json.dumps({"kernels": line}))
    if rehearsal:
        print("[result] cpu rehearsal passed (no ok line: nothing ran on a card)")
        return 0
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


def http(port, path, body, timeout=300, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET",
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()

def closed_loop(n_clients, total, send, ramp_s=0.0):
    """`n_clients` threads send requests 0..total-1 between them, each
    sent again after its Retry-After while it is shed (503), client k
    starting k * ramp_s / n_clients after the first -> (wall s, ms a
    request from its first send, {request: reply}, sheds)."""
    lock, nxt, lats, replies, sheds = threading.Lock(), [0], [], {}, [0]

    def client(k):
        time.sleep(k * ramp_s / n_clients)
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= total:
                return
            t0 = time.perf_counter()
            while True:
                try:
                    code, headers, body = send(i)
                except OSError as e:  # a reset connection fails the run below
                    code, headers, body = f"{type(e).__name__}: {e}", {}, b""
                if code != 503:
                    break
                with lock:
                    sheds[0] += 1
                time.sleep(float(headers.get("Retry-After", 1)))
            with lock:
                lats.append((time.perf_counter() - t0) * 1e3)
                replies[i] = (code, headers, body)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    require(not any(t.is_alive() for t in threads), "a client thread hung")
    return time.perf_counter() - t0, lats, replies, sheds[0]

def class_loop(port, n_clients, total, bodies, headers, fetch, shape, go, ramp_s):
    """One QoS class's closed loop of `total` /predict requests from
    `n_clients` threads, started at wall time `go` over `ramp_s`; run in a
    process of its own -> (wall s, ms a request from its first send,
    {final code: count}, sheds retried, replies of `shape` with finite
    values)."""
    import numpy as np

    time.sleep(max(0.0, go - time.time()))
    wall, lats, replies, sheds = closed_loop(
        n_clients, total,
        lambda i: http(port, "/predict", bodies[i % len(bodies)], headers=headers), ramp_s)
    codes, whole = {}, 0
    for code, _, body in replies.values():
        codes[code] = codes.get(code, 0) + 1
        if code == 200:
            out = np.load(io.BytesIO(body))[fetch]
            whole += out.shape == tuple(shape) and bool(np.isfinite(out).all())
    return wall, lats, codes, sheds, whole


def pctl(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


BERT_FEEDS = ("src_ids", "sent_ids", "pos_ids", "input_mask")


def export_bert_encoder(cfg, s, seed, place, dirs):
    """A BERT encoder (is_test, phases 14 and 16) with a batch placeholder on every feed,
    random weights from `seed`, exported by save_inference_model into each
    of `dirs` (the same weights in each) -> the fetch name."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models.bert import bert_encoder

    main_p, startup_p = fluid.Program(), fluid.Program()
    main_p.random_seed = startup_p.random_seed = seed
    with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
        ids = [layers.data(n, [s], dtype="int64") for n in BERT_FEEDS[:3]]
        hidden = bert_encoder(*ids, layers.data("input_mask", [s]), cfg, is_test=True)
    scope, exe = fluid.Scope(), fluid.Executor(place)
    exe.run(startup_p, scope=scope)
    with fluid.scope_guard(scope):
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
            fluid.io.save_inference_model(str(d), list(BERT_FEEDS), [hidden], exe,
                                          main_program=main_p)
    return hidden.name


def registry_phase(seed, rehearsal, smi):
    """Phase 16: the model registry at full width -> (launch counts of the
    phase's run, its result dict). Two BERT-base bundles from two seeds
    behind one server: the built-in default (main) and alt@v1 (a 10 ms
    coalescing window), QoS classes gold (weight 8, deadline_ms 500) and
    bulk (weight 1). (a) routing, (b) the classes under contention, (c) a
    hot-swap under load, a drifted deploy and a chaos abort, (d) two
    decode models on one paged KV pool."""
    import hashlib

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor, create_paddle_predictor
    from paddle_tpu_torch.inference.decode_model import (
        make_toy_decode_weights, save_decode_weights)
    from paddle_tpu_torch.inference.registry import ModelRuntime
    from paddle_tpu_torch.inference.server import InferenceServer
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import faults

    dev = "cpu" if rehearsal else "cuda"
    place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)
    cfg = BertConfig.tiny() if rehearsal else BertConfig.base()
    s = 32 if rehearsal else 128
    root = ROOT / "build" / "chip_smoke" / "registry"
    root.mkdir(parents=True, exist_ok=True)
    dirs = {k: root / k for k in ("main", "alt_v1", "alt_v2", "alt_v3")}
    t0 = time.perf_counter()
    fetch = export_bert_encoder(cfg, s, seed + 16, place, [dirs["main"]])
    # v2: v1's weights exported again; v3: another seed (the drift gate's case)
    export_bert_encoder(cfg, s, seed + 17, place, [dirs["alt_v1"], dirs["alt_v2"]])
    export_bert_encoder(cfg, s, seed + 18, place, [dirs["alt_v3"]])
    # gold's deadline: 500 ms. At 250 ms, on an H100 whose host took 30.47 ms
    # for phase 14's bucket-1 dispatch (17.09 ms on another), 97 of 256 gold
    # requests missed it (504) under the bulk flood: the host's op walk
    # bounds every dispatch, so the deadline a replica can keep depends on it
    manifest = root / "model_registry.json"
    manifest.write_text(json.dumps({
        "default": "main", "default_version": "v1",
        "models": [{"name": "alt", "version": "v1", "bundle_dir": "alt_v1",
                    "batch_window_ms": 10, "max_queue": 64}],
        "qos": {"classes": {"gold": {"weight": 8, "deadline_ms": 500},
                            "bulk": {"weight": 1}},
                "tenants": {"tenant-gold": "gold", "tenant-bulk": "bulk"},
                "default_class": "bulk"}}))
    rs = np.random.RandomState(seed + 16)
    feeds, bodies = [], []
    for _ in range(16):  # distinct one-row requests of seeded lengths
        length = rs.randint(s // 8, s + 1)
        feed = {"src_ids": rs.randint(0, cfg.vocab_size, (1, s)).astype(np.int64),
                "sent_ids": (np.arange(s)[None, :] >= length // 2).astype(np.int64),
                "pos_ids": np.arange(s, dtype=np.int64)[None, :],
                "input_mask": (np.arange(s)[None, :] < length).astype(np.float32)}
        buf = io.BytesIO()
        np.savez(buf, **feed)
        feeds.append(feed)
        bodies.append(buf.getvalue())
    print(f"[registry] 4 BERT exports (hidden {cfg.hidden_size}, {cfg.num_layers} layers, s {s}, "
          f"seeds {seed + 16} / {seed + 17} twice / {seed + 18}) in "
          f"{time.perf_counter() - t0:.1f} s")

    # every BERT dispatch on the card in this phase, counted where it runs
    runs, runs_lock, orig_run = [0], threading.Lock(), AnalysisPredictor.run

    def counted_run(self, inputs=None):
        if self._exe.device.type == "cuda":
            with runs_lock:
                runs[0] += 1
        return orig_run(self, inputs)

    servers = []

    def serve(model_dir, **kw):
        srv = InferenceServer(str(model_dir), device=dev, **kw)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        servers.append((srv, t))
        return srv

    def stop(srv):
        for i, (x, t) in enumerate(servers):
            if x is srv:
                srv.shutdown()
                srv.close()
                t.join(30)
                del servers[i]
                return

    def out_of(body):
        return np.load(io.BytesIO(body))[fetch]

    stats = {}
    AnalysisPredictor.run = counted_run
    kernels.reset_launch_counts()
    try:
        # (a) routing: no header is the registry-less server's bits; X-Model
        # alt is alt's own predictor.run's bits, and within 1e-3 of the CPU
        t0 = time.perf_counter()
        reg = serve(dirs["main"], max_queue=16, batch_window_ms=10, registry=str(manifest))
        plain = serve(dirs["main"], max_queue=16, batch_window_ms=10)
        registry = reg._registry
        alt = registry.get("alt")
        require(alt._batchable and reg._batchable and alt._lock is reg._lock is registry.gate,
                "[registry] alt and main coalesce, under the one QoS gate")
        up_s = time.perf_counter() - t0
        alt_refs = {}
        for i in range(4):
            c1, _, b1 = http(reg.port, "/predict", bodies[i])
            c0, _, b0 = http(plain.port, "/predict", bodies[i])
            require(c1 == c0 == 200 and b1 == b0,
                    f"[registry] request {i} without X-Model: {c1} / {c0}, bytes equal {b1 == b0}")
            ca, _, ba = http(reg.port, "/predict", bodies[i], headers={"X-Model": "alt"})
            alt_refs[i] = alt.predict(feeds[i])[fetch]
            require(ca == 200 and np.array_equal(out_of(ba), alt_refs[i]),
                    f"[registry] request {i} with X-Model alt: {ca}, not alt's predictor.run")
            require(not np.array_equal(out_of(ba), out_of(b1)), "[registry] alt answers as main")
        cpu = create_paddle_predictor(_cpu_config(AnalysisConfig, dirs["alt_v1"]))
        alt_cpu = max(float(np.abs(cpu.run(dict(feeds[i]))[0] - alt_refs[i]).max())
                      for i in range(2))
        del cpu
        require(alt_cpu <= 1e-3, f"[registry] alt card vs CPU max abs diff {alt_cpu}")
        cg, _, bg = http(reg.port, "/predict", bodies[0], headers={"X-Model": "ghost"})
        require(cg == 404 and json.loads(bg)["error"] == "NoSuchModel", f"[registry] ghost: {cg}")
        stop(plain)
        print(f"[registry] (a) servers up in {up_s:.1f} s; 4 requests without X-Model bit-equal to "
              f"a registry-less server's, with X-Model alt bit-equal to alt's predictor.run; alt "
              f"card vs CPU max abs diff {alt_cpu:.3e} (tol 1e-3); X-Model ghost 404 NoSuchModel")

        # (b) the classes under contention: 32 bulk clients on alt, 8 gold on
        # main, closed loops of QOS_REQUESTS a class, run together, every
        # bucket they can fill dispatched once before (a first dispatch at a
        # new row count held the first replies ~1.6 s in a CPU rehearsal)
        for rows in (1, 2, 4, 8, 16, 32):
            for srv in (reg, alt):
                srv.predict({k: np.repeat(v, rows, axis=0) for k, v in feeds[0].items()})
        # the clients run in two processes of their own, as real clients do
        # (in this one their 40 threads would share the server's GIL). A
        # first round starts all 40 at once and is reported, not gated: such
        # a connect storm held back the first dispatch and sent the first
        # gold requests past a 250 ms deadline (504) on the card. The gated
        # round starts each class's clients over 1 s
        classes = {"bulk": (32, {"X-Tenant": "tenant-bulk", "X-Model": "alt"}),
                   "gold": (8, {"X-Tenant": "tenant-gold"})}

        def both_classes(ramp_s):
            go = time.time() + 10  # both loops start together, after the spawns
            with multiprocessing.get_context("spawn").Pool(len(classes)) as pool:
                pending = {cls: pool.apply_async(class_loop, (
                    reg.port, n, QOS_REQUESTS, bodies, headers, fetch, (1, s, cfg.hidden_size), go,
                    ramp_s)) for cls, (n, headers) in classes.items()}
                return {cls: r.get(timeout=900) for cls, r in pending.items()}

        burst = {}
        for cls, (wall, lats, codes, sheds, whole) in both_classes(0.0).items():
            require(set(codes) <= {200, 504} and whole == codes.get(200),
                    f"[registry] (b) burst {cls}: replies {codes}, {whole} whole and finite")
            burst[cls] = dict(codes=codes, p50_ms=pctl(lats, 0.5), max_ms=max(lats))
        print(f"[registry] (b) all 40 clients started at once (not gated): " + "; ".join(
            f"{cls} replies {b['codes']}, p50 {b['p50_ms']:.2f} ms, slowest {b['max_ms']:.2f} ms"
            for cls, b in burst.items()) + f"; card {smi}")
        stats["qos_burst"] = burst
        grants0 = registry.gate.snapshot()
        loops = both_classes(1.0)
        grants1 = registry.gate.snapshot()
        qos = {}
        for cls, (wall, lats, codes, sheds, whole) in loops.items():
            require(codes == {200: QOS_REQUESTS} and whole == QOS_REQUESTS,
                    f"[registry] (b) {cls}: replies {codes}, {whole} whole and finite")
            qos[cls] = dict(requests_per_s=QOS_REQUESTS / wall, p50_ms=pctl(lats, 0.5),
                            p99_ms=pctl(lats, 0.99), max_ms=max(lats), sheds_retried=sheds,
                            grants=grants1[cls] - grants0[cls])
            print(f"[registry] (b) {cls}: {QOS_REQUESTS} requests from {classes[cls][0]} clients "
                  f"started over 1 s, in {wall:.2f} s: {QOS_REQUESTS / wall:.1f} requests/s, p50 "
                  f"{qos[cls]['p50_ms']:.2f} ms, p99 {qos[cls]['p99_ms']:.2f} ms, slowest "
                  f"{qos[cls]['max_ms']:.2f} ms, {sheds} sheds retried, {qos[cls]['grants']} gate "
                  f"grants; card {smi}")
        require(qos["gold"]["p50_ms"] < qos["bulk"]["p50_ms"],
                f"[registry] gold p50 {qos['gold']['p50_ms']} not below bulk's "
                f"{qos['bulk']['p50_ms']}")
        stats["qos"] = qos

        # (c) hot-swap under load: 16 clients on alt while alt@v2 (v1's
        # weights exported again) deploys; every merged dispatch recorded
        if not rehearsal:
            torch.cuda.synchronize()
        gc.collect()
        mem = lambda: torch.cuda.memory_allocated() if not rehearsal else 0  # noqa: E731
        mem_before = mem()
        dispatches, disp_lock, orig_predict = [], threading.Lock(), ModelRuntime.predict

        def recorded(self, feeds_, _deadline=None):
            outs = orig_predict(self, feeds_, _deadline)
            with disp_lock:
                dispatches.append((self.version, feeds_, outs[fetch]))
            return outs

        halt, flip, swapped = threading.Event(), [None], []
        lock = threading.Lock()

        def client(k):
            i = k
            while not halt.is_set():
                t_send = time.perf_counter()
                code, _, body = http(reg.port, "/predict", bodies[i % len(bodies)],
                                     headers={"X-Model": "alt"})
                with lock:
                    swapped.append((t_send, code, body))
                i += 16

        ModelRuntime.predict = recorded
        try:
            clients = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(16)]
            for t in clients:
                t.start()
            deadline = time.monotonic() + 120
            while len(swapped) < 32:
                require(time.monotonic() < deadline, "[registry] (c) no replies before the deploy")
                time.sleep(0.01)
            if not rehearsal:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            code, _, body = http(reg.port, "/admin/deploy", json.dumps(
                {"name": "alt", "version": "v2", "bundle_dir": str(dirs["alt_v2"]),
                 "tolerance": 0.01}).encode(), headers={"Content-Type": "application/json"})
            flip[0] = time.perf_counter()
            deploy_ms = (flip[0] - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() if not rehearsal else 0
            require(code == 200 and json.loads(body)["status"] == "active",
                    f"[registry] (c) deploy v2: {code} {body[:300]}")
            n_flip = len(swapped)
            while len(swapped) < n_flip + 64:
                require(time.monotonic() < deadline + 300, "[registry] (c) no replies after the flip")
                time.sleep(0.01)
            halt.set()
            for t in clients:
                t.join(60)
            require(not any(t.is_alive() for t in clients), "[registry] (c) a client hung")
        finally:
            ModelRuntime.predict = orig_predict
            halt.set()
        v2 = registry.get("alt")
        rows = {"v1": set(), "v2": set()}
        for version, _, out in dispatches:
            for j in range(len(out)):
                rows[version].add(hashlib.blake2b(out[j].tobytes()).digest())
        after = 0
        for t_send, code, body in swapped:
            require(code == 200, f"[registry] (c) a reply failed during the deploy: {code}")
            digest = hashlib.blake2b(out_of(body)[0].tobytes()).digest()
            if t_send > flip[0]:
                after += 1
                require(digest in rows["v2"], "[registry] (c) a reply after the flip is no row "
                        "of a v2 dispatch")
            else:
                require(digest in rows["v1"] | rows["v2"],
                        "[registry] (c) a reply is no row of a v1 or v2 dispatch")
        # v1's merged batches through v2: the same bits (the same weights)
        v1_batches = [(f, o) for version, f, o in dispatches if version == "v1"][:64]
        require(all(np.array_equal(v2.predict(f)[fetch], o) for f, o in v1_batches),
                "[registry] (c) v2 differs from v1 on one of v1's merged batches")
        if not rehearsal:
            torch.cuda.synchronize()
        mem_after = mem()
        c = reg.counters()
        require(c.get("serve_deploys") == 1 and c.get("serve_deploy_unloads") == 1,
                f"[registry] (c) deploy counters {c}")
        require(rehearsal or abs(mem_after - mem_before) <= 0.05 * mem_before,
                f"[registry] (c) memory_allocated {mem_before} before the deploy, {mem_after} "
                "after the unload")
        stats["hot_swap"] = dict(
            deploy_ms=deploy_ms, replies=len(swapped), replies_after_flip=after,
            dispatches_v1=len(v1_batches), peak_mib=peak / 2**20,
            allocated_before_mib=mem_before / 2**20, allocated_after_mib=mem_after / 2**20)
        print(f"[registry] (c) deploy alt@v2 under 16 clients: {deploy_ms:.1f} ms wall, "
              f"{len(swapped)} replies all 200 ({after} sent after the flip, each a row of a v2 "
              f"dispatch), {len(v1_batches)} of v1's merged batches bit-equal through v2; "
              f"memory_allocated {mem_before / 2**20:.1f} MiB before, peak "
              f"{peak / 2**20:.1f} MiB during, {mem_after / 2**20:.1f} MiB after the unload; "
              f"card {smi}")

        # a drifted deploy (another seed) is refused, v2 keeps serving
        deploy = lambda version, d: http(reg.port, "/admin/deploy", json.dumps(  # noqa: E731
            {"name": "alt", "version": version, "bundle_dir": str(d),
             "tolerance": 0.01}).encode(), headers={"Content-Type": "application/json"})
        code, _, body = deploy("v3", dirs["alt_v3"])
        require(code == 409 and json.loads(body)["error"] == "ExportToleranceError",
                f"[registry] drifted v3: {code} {body[:300]}")
        drift_msg = json.loads(body)["message"]
        # a chaos plan aborts a deploy at the cutover, v2 keeps serving
        faults.install(faults.FaultPlan.from_spec("registry.cutover:raises=RuntimeError:times=1"))
        try:
            code_f, _, body_f = deploy("v4", dirs["alt_v2"])
        finally:
            faults.clear()
        require(code_f == 500 and json.loads(body_f)["error"] == "RuntimeError",
                f"[registry] cutover abort: {code_f} {body_f[:300]}")
        ca, _, ba = http(reg.port, "/predict", bodies[0], headers={"X-Model": "alt"})
        require(registry.get("alt") is v2 and ca == 200
                and np.array_equal(out_of(ba), v2.predict(feeds[0])[fetch]),
                "[registry] alt does not answer with v2 after the refused deploys")
        if not rehearsal:
            torch.cuda.synchronize()
        mem_refused = mem()
        c = reg.counters()
        require((c.get("serve_deploys"), c.get("serve_deploy_failures"),
                 c.get("serve_deploy_unloads")) == (3, 2, 1), f"[registry] counters {c}")
        require(rehearsal or abs(mem_refused - mem_before) <= 0.05 * mem_before,
                f"[registry] the refused candidates kept memory: {mem_refused} vs {mem_before}")
        stats["refused"] = dict(drift=drift_msg, allocated_after_mib=mem_refused / 2**20)
        print(f"[registry] (c) alt@v3 (another seed) 409 ExportToleranceError ({drift_msg}); a "
              f"registry.cutover fault plan aborted alt@v4 with 500; alt still v2's bits; "
              f"serve_deploys 3, failures 2, unloads 1; memory_allocated "
              f"{mem_refused / 2**20:.1f} MiB")
        stop(reg)

        # (d) one KV pool, two decode models at BERT's attention width
        geom = dict(vocab=13, num_heads=4, head_dim=8) if rehearsal else dict(
            vocab=30522, num_heads=12, head_dim=64)
        wpaths = {}
        for tag, wseed in (("main", seed + 16), ("alt", seed + 17)):
            wpaths[tag] = str(save_decode_weights(
                str(root / f"decode_{tag}.npz"), make_toy_decode_weights(seed=wseed, **geom)))
        rs_g = np.random.RandomState(seed + 160)
        jobs = [("main" if i % 2 == 0 else "alt",
                 rs_g.randint(0, geom["vocab"], rs_g.randint(8, 41)).astype(np.int32))
                for i in range(32)]
        gen_bodies = []
        for _, p in jobs:
            buf = io.BytesIO()
            np.savez(buf, tokens=p, max_new=np.int32(16))
            gen_bodies.append(buf.getvalue())
        kv = {"admission_window_ms": 30_000}
        shared = serve(dirs["main"], decode_weights=wpaths["main"], max_queue=256, warmup=False,
                       kv_config=kv, registry={
                           "default": "main", "models": [
                               {"name": "alt", "version": "v1", "bundle_dir": str(dirs["alt_v2"]),
                                "decode_weights": wpaths["alt"], "max_queue": 256}]})
        pool = shared._decode.cache
        require(shared._registry.get("alt").decode.cache is pool,
                "[registry] (d) the alt decode model is not on the server's pool")
        peak_pages, sampling = [0], threading.Event()

        def sample():
            while not sampling.is_set():
                peak_pages[0] = max(peak_pages[0], pool.counters.snapshot().get(
                    "kv_pages_in_use", 0))
                time.sleep(0.0005)

        steps0 = pool.counters.snapshot().get("kv_decode_steps", 0)
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        wall, lats, replies, sheds = closed_loop(32, 32, lambda i: http(
            shared.port, "/generate", gen_bodies[i],
            headers={"X-Model": "alt"} if jobs[i][0] == "alt" else None))
        sampling.set()
        sampler.join(10)
        steps = pool.counters.snapshot().get("kv_decode_steps", 0) - steps0
        require(pool.free_pages() == pool.num_pages, "[registry] (d) pages not reclaimed")
        stop(shared)
        for tag in ("main", "alt"):
            solo = serve(dirs["main"], decode_weights=wpaths[tag], max_queue=256, warmup=False,
                         kv_config=kv)
            mine = [i for i, (t, _) in enumerate(jobs) if t == tag]
            _, _, alone, _ = closed_loop(len(mine), len(mine),
                                         lambda k: http(solo.port, "/generate", gen_bodies[mine[k]]))
            stop(solo)
            for k, i in enumerate(mine):
                (cs, _, bs), (ca_, _, ba_) = replies[i], alone[k]
                require(cs == ca_ == 200, f"[registry] (d) {tag} prompt {i}: {cs} / {ca_}")
                a, b = np.load(io.BytesIO(bs)), np.load(io.BytesIO(ba_))
                require(a["tokens"].shape == (16,) and np.array_equal(a["tokens"], b["tokens"])
                        and a["logits"].tobytes() == b["logits"].tobytes(),
                        f"[registry] (d) {tag} prompt {i}: the shared pool's stream differs from "
                        "the model alone")
        stats["shared_pool"] = dict(
            tokens_per_s=32 * 16 / wall, p50_ms=pctl(lats, 0.5), p99_ms=pctl(lats, 0.99),
            peak_pages_in_use=peak_pages[0], pages=pool.num_pages, kv_decode_steps=steps,
            sheds_retried=sheds)
        print(f"[registry] (d) 32 /generate (16 a model, prompts of 8-40 tokens, max_new 16) on "
              f"one pool of {pool.num_pages} pages, vocab {geom['vocab']}, {geom['num_heads']} "
              f"heads of {geom['head_dim']}: each stream bit-equal to its model alone; "
              f"{32 * 16 / wall:.1f} tokens/s, p50 {pctl(lats, 0.5):.2f} ms, p99 "
              f"{pctl(lats, 0.99):.2f} ms, peak kv_pages_in_use {peak_pages[0]}, kv_decode_steps "
              f"{steps}; card {smi}")
    finally:
        AnalysisPredictor.run = orig_run
        for srv, t in list(servers):
            stop(srv)
    if not rehearsal:
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(rehearsal or launches["mha_short_fwd"] == cfg.num_layers * runs[0] > 0,
            f"[registry] the short kernel launched {launches['mha_short_fwd']} times over "
            f"{runs[0]} BERT dispatches on the card, want {cfg.num_layers} a dispatch")
    stats["bert_dispatches"] = runs[0]
    print(f"[registry] {runs[0]} BERT dispatches on the card in the phase, launches {launches}")
    return launches, stats


def fleet_phase(seed, rehearsal, smi):
    """Phase 17: the serving fleet at full width -> (launch counts of the
    serve_fleet path, the phase's result dict). The router runs in this
    process; its workers are `paddle_tpu_torch.inference.server`
    subprocesses on the card (`--device cuda`; the CPU in the rehearsal),
    serving phase 16's BERT-base bundles (main, and alt@v1 behind
    X-Model). (a) routing and bits over 2 replicas, (b) throughput at 1, 2
    and 4 replicas, (c) failover of a SIGKILLed worker, (d) a rolling
    restart under load, (e) a prefill / decode role split, (f) mixed
    backend classes through the divert and tier-loss chaos sites."""
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
    from paddle_tpu_torch.inference.decode_model import (
        make_toy_decode_weights, save_decode_weights)
    from paddle_tpu_torch.inference.fleet import ServingFleet
    from paddle_tpu_torch.inference.server import InferenceServer
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.resilience import faults

    t_phase = time.perf_counter()
    dev = "cpu" if rehearsal else "cuda"
    place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)
    cfg = BertConfig.tiny() if rehearsal else BertConfig.base()
    s = 32 if rehearsal else 128
    if not rehearsal:
        torch.cuda.empty_cache()  # the workers share the card with this process
    # phase 16's bundles where they stand (the same seeds), else exported here
    root = ROOT / "build" / "chip_smoke" / "registry"
    dirs = {"main": root / "main", "alt": root / "alt_v1"}
    for (tag, d), sd in zip(dirs.items(), (seed + 16, seed + 17)):
        if not (d / "__model__.json").exists():
            root.mkdir(parents=True, exist_ok=True)
            export_bert_encoder(cfg, s, sd, place, [d])
    work = ROOT / "build" / "chip_smoke" / "fleet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    manifest = work / "model_registry.json"
    manifest.write_text(json.dumps({
        "default": "main", "default_version": "v1",
        "models": [{"name": "alt", "version": "v1", "bundle_dir": str(dirs["alt"]),
                    "max_queue": 64}]}))

    def predictor(d):
        config = AnalysisConfig(str(d))
        if rehearsal:
            config.disable_gpu()
        return create_paddle_predictor(config)

    preds = {tag: predictor(d) for tag, d in dirs.items()}
    fetch = preds["main"].get_output_names()[0]
    rs = np.random.RandomState(seed + 170)
    feeds, bodies = [], []
    for _ in range(16):  # distinct one-row requests of seeded lengths
        length = rs.randint(s // 8, s + 1)
        feed = {"src_ids": rs.randint(0, cfg.vocab_size, (1, s)).astype(np.int64),
                "sent_ids": (np.arange(s)[None, :] >= length // 2).astype(np.int64),
                "pos_ids": np.arange(s, dtype=np.int64)[None, :],
                "input_mask": (np.arange(s)[None, :] < length).astype(np.float32)}
        buf = io.BytesIO()
        np.savez(buf, **feed)
        feeds.append(feed)
        bodies.append(buf.getvalue())
    # the bits every unwindowed reply must have: predictor.run in this process
    refs = {tag: [np.asarray(p.run(dict(f))[0]) for f in feeds] for tag, p in preds.items()}
    require(refs["main"][0].shape == (1, s, cfg.hidden_size),
            f"[fleet] the bundles give {refs['main'][0].shape}, want (1, {s}, {cfg.hidden_size})")
    cpu_worst = 0.0
    if not rehearsal:
        for tag, d in dirs.items():
            cpu = create_paddle_predictor(_cpu_config(AnalysisConfig, d))
            cpu_worst = max(cpu_worst, max(float(np.abs(cpu.run(dict(feeds[i]))[0]
                                                        - refs[tag][i]).max()) for i in range(2)))
            del cpu
        require(cpu_worst <= 1e-3, f"[fleet] card vs CPU max abs diff {cpu_worst}")
    del preds

    def out_of(body):
        return np.load(io.BytesIO(body))[fetch]

    def healthz(port):
        code, _, body = http(port, "/healthz", None, timeout=60)
        return code, json.loads(body)

    def wait_for(cond, what, timeout=120):
        deadline = time.monotonic() + timeout
        while not cond():
            require(time.monotonic() < deadline, f"[fleet] timed out waiting for {what}")
            time.sleep(0.02)

    def worker_views(fleet):
        """{replica idx: (kernel launches, counters)} from each live worker."""
        out = {}
        with fleet.supervisor._lock:
            live = [(r.idx, r.port) for r in fleet.supervisor.replicas if r.status == "live"]
        for idx, port in live:
            _, h = healthz(port)
            out[idx] = (h["kernel_launches"], h["counters"])
        return out

    path = {}  # the serve_fleet path's launches: each worker's, over (a) and (b)

    def launches_since(before, after, tag, coalesced):
        """Each worker's launches over a run, held to 12 short forward
        launches a BERT dispatch it made, and added to the path's count."""
        for idx, (k1, c1) in after.items():
            k0, c0 = before[idx]
            got = {n: k1[n] - k0[n] for n in k1}
            if coalesced:
                disp = sum(c1.get(k, 0) - c0.get(k, 0)
                           for k in ("serve_batches", "serve_coalesce_bypass"))
            else:
                disp = c1.get("serve_requests", 0) - c0.get("serve_requests", 0)
            require(disp > 0 and (rehearsal or got["mha_short_fwd"] == cfg.num_layers * disp),
                    f"[fleet] {tag}: replica {idx} launched the short kernel "
                    f"{got['mha_short_fwd']} times over {disp} BERT dispatches, want "
                    f"{cfg.num_layers} a dispatch")
            for n, v in got.items():
                path[n] = path.get(n, 0) + v
            print(f"[fleet] {tag}: replica {idx}: {disp} BERT dispatches, launches {got}")

    def fleet_of(n, server_args=(), **kw):
        return ServingFleet(str(dirs["main"]), replicas=n, worker_device=dev,
                            server_args=list(server_args), ready_timeout_s=180,
                            min_uptime_s=1.0, drain_timeout_s=60, **kw)

    def booted(fleet, tag):
        t0 = time.perf_counter()
        fleet.start()
        warm = [r.warmup_ms for r in fleet.supervisor.replicas]
        print(f"[fleet] {tag}: {fleet.supervisor.n} workers live in "
              f"{time.perf_counter() - t0:.1f} s (each worker's warmup_ms from its ready-file: "
              f"{warm})")
        return fleet

    def gpu_memory():
        """nvidia-smi's compute apps (pid, used_memory) and the card's
        memory.used. In a container every app may read pid 1 and the
        card's total: then a worker's share is the rise per worker."""
        if rehearsal:
            return "cpu rehearsal", None
        q = [subprocess.run(["nvidia-smi", arg, "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60).stdout.strip().replace("\n", "; ")
             for arg in ("--query-compute-apps=pid,used_memory", "--query-gpu=memory.used")]
        return q[0], q[1]

    stats = {}
    gate = work / "predict_gate"
    gate.touch()  # the workers' hold: open, except in (c)
    fleets = []
    try:
        # (a) routing and bits: 2 unified replicas, no window, a registry
        # (alt behind X-Model); (c) and (d) then run on the same fleet
        fa = booted(fleet_of(2, ("--max-queue", "64", "--batch-window-ms", "0"),
                             registry=str(manifest),
                             extra_env={"PADDLE_TPU_FAULTS": f"server.predict:hold={gate}"}),
                    "(a)")
        fleets.append(fa)
        port = fa.router.port
        before = worker_views(fa)
        wall, lats, main_rep, _ = closed_loop(8, 64, lambda i: http(port, "/predict",
                                                                    bodies[i % 16]))
        _, _, alt_rep, _ = closed_loop(4, 16, lambda i: http(port, "/predict", bodies[i],
                                                             headers={"X-Model": "alt"}))
        launches_since(before, worker_views(fa), "(a)", coalesced=False)
        for tag, reps in (("main", main_rep), ("alt", alt_rep)):
            for i, (code, _, body) in reps.items():
                require(code == 200 and np.array_equal(out_of(body), refs[tag][i % 16]),
                        f"[fleet] (a) {tag} request {i}: {code}, not predictor.run's bits")
        require(not np.array_equal(refs["alt"][0], refs["main"][0]), "[fleet] alt is main")
        code, h = healthz(port)
        require(code == 200 and h["live"] == 2 and h["status"] == "ok", f"[fleet] (a) {h}")
        routed = [r["routed"] for r in h["replica_status"]]
        stats["a"] = dict(requests=80, routed=routed, card_vs_cpu=cpu_worst)
        print(f"[fleet] (a) 64 requests to main and 16 with X-Model alt through the router "
              f"(routed {routed}), each bit-equal to predictor.run in this process; card vs "
              f"CPU max abs diff {cpu_worst:.3e} (tol 1e-3); /healthz ok, 2 live")

        # (c) failover: the workers park a request at the closed gate, the
        # router's seeded fleet.kill_replica rule SIGKILLs the worker it just
        # sent to; the request fails over, the slot respawns
        sup = fa.supervisor
        c0 = sup.counters.snapshot()
        gate.unlink()
        faults.install(faults.FaultPlan(seed=seed + 17).add(
            "fleet.kill_replica", raises=faults.FaultError, nth=1))
        res = {}
        t = threading.Thread(target=lambda: res.update(r=http(port, "/predict", bodies[5])),
                             daemon=True)
        t.start()
        try:
            wait_for(lambda: sup.counters.snapshot().get("fleet_chaos_kills", 0)
                     > c0.get("fleet_chaos_kills", 0), "the chaos kill", timeout=120)
        finally:
            faults.clear()
            gate.touch()
        t.join(timeout=120)
        require(not t.is_alive() and res["r"][0] == 200
                and np.array_equal(out_of(res["r"][2]), refs["main"][5]),
                f"[fleet] (c) the killed replica's request: {res.get('r', [None])[0]}")
        t_kill = time.monotonic()
        wait_for(lambda: any("dead" in r.history for r in sup.replicas), "the death")
        killed = next(r for r in sup.replicas if "dead" in r.history)
        wait_for(lambda: killed.restarts >= 1 and killed.status == "live", "the respawn",
                 timeout=240)
        respawn_s = time.monotonic() - t_kill
        c1 = sup.counters.snapshot()
        failovers = c1.get("fleet_failovers", 0) - c0.get("fleet_failovers", 0)
        respawns = c1.get("fleet_respawns", 0) - c0.get("fleet_respawns", 0)
        require(failovers >= 1 and respawns >= 1,
                f"[fleet] (c) fleet_failovers {failovers}, fleet_respawns {respawns}")
        stats["c"] = dict(respawn_s=respawn_s, failovers=failovers, respawns=respawns,
                          history=killed.history[-4:])
        print(f"[fleet] (c) replica {killed.idx} SIGKILLed mid-request: the request failed "
              f"over, bit-equal; respawned live in {respawn_s:.1f} s (history "
              f"{killed.history[-4:]}); fleet_failovers +{failovers}, fleet_respawns +{respawns}")

        # (d) rolling restart under load: 16 clients, every reply 200 and the
        # bits of predictor.run
        halt, replies, lock = threading.Event(), [], threading.Lock()

        def client(k):
            i = k
            while not halt.is_set():
                code, _, body = http(port, "/predict", bodies[i % 16])
                with lock:
                    replies.append((i % 16, code, body))
                i += 16

        pids0 = [r.pid for r in sup.replicas]
        ths = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(16)]
        for th in ths:
            th.start()
        try:
            wait_for(lambda: len(replies) >= 16, "the load to ramp")
            t0 = time.perf_counter()
            rolled = fa.rolling_restart()
            roll_s = time.perf_counter() - t0
        finally:
            halt.set()
            for th in ths:
                th.join(timeout=120)
        require(not any(th.is_alive() for th in ths), "[fleet] (d) a client hung")
        bad = [(i, c) for i, c, b in replies if c != 200 or not np.array_equal(out_of(b),
                                                                                refs["main"][i])]
        require(rolled == [0, 1] and not bad and all(
            a != b for a, b in zip(pids0, (r.pid for r in sup.replicas))),
            f"[fleet] (d) rolled {rolled}, {len(bad)} replies not 200 and bit-equal: {bad[:5]}")
        stats["d"] = dict(roll_s=roll_s, replies=len(replies))
        print(f"[fleet] (d) rolling restart of both replicas in {roll_s:.1f} s under 16 clients: "
              f"{len(replies)} replies, every one 200 and bit-equal; fresh pids; card {smi}")
        fa.stop()
        fleets.remove(fa)

        # (b) throughput by replica count: closed loops of 32 clients,
        # FLEET_REQUESTS (after 32 to warm each bucket), a 10 ms window, the clients
        # in a process of their own
        tput = {}
        with multiprocessing.get_context("spawn").Pool(1) as pool:
            for n in (1, 2, 4):
                fb = booted(fleet_of(n, ("--max-queue", "64", "--batch-window-ms", "10")),
                            f"(b) {n}")
                fleets.append(fb)
                before = worker_views(fb)
                runs = [pool.apply_async(class_loop, (
                    fb.router.port, 32, total, bodies, None, fetch, (1, s, cfg.hidden_size),
                    time.time(), 0.0)).get(timeout=900) for total in (32, FLEET_REQUESTS)]
                after = worker_views(fb)
                launches_since(before, after, f"(b) {n}", coalesced=True)
                wall, lats, codes, sheds, whole = runs[1]
                require(codes == {200: FLEET_REQUESTS} and whole == FLEET_REQUESTS,
                        f"[fleet] (b) {n}: replies {codes}, {whole} whole and finite")
                tput[n] = dict(requests_per_s=FLEET_REQUESTS / wall, p50_ms=pctl(lats, 0.5),
                               p99_ms=pctl(lats, 0.99), sheds_retried=sheds,
                               batch_p50={i: c.get("serve_batch_size_p50")
                                          for i, (_, c) in after.items()},
                               pids=[r.pid for r in fb.supervisor.replicas])
                tput[n]["gpu_apps"], tput[n]["memory_used"] = gpu_memory()
                print(f"[fleet] (b) {n} replica(s): {FLEET_REQUESTS} requests from 32 clients in "
                      f"{wall:.2f} s: {FLEET_REQUESTS / wall:.1f} requests/s, p50 {tput[n]['p50_ms']:.2f} ms, p99 "
                      f"{tput[n]['p99_ms']:.2f} ms, {sheds} sheds retried; each replica's "
                      f"serve_batch_size_p50 {tput[n]['batch_p50']}; workers {tput[n]['pids']}, "
                      f"nvidia-smi compute apps (pid, used_memory): {tput[n]['gpu_apps']}, "
                      f"card memory.used {tput[n]['memory_used']}; card {smi}")
                fb.stop()
                fleets.remove(fb)
        stats["b"] = tput

        # (e) role split: one prefill and one decode worker, phase 14's toy
        # decoder at BERT's attention width; 16 /generate streams each
        # bit-equal to a unified server's in this process
        geom = dict(vocab=13, num_heads=4, head_dim=8) if rehearsal else dict(
            vocab=30522, num_heads=12, head_dim=64)
        wpath = str(work / "decode.npz")
        save_decode_weights(wpath, make_toy_decode_weights(seed=seed + 18, **geom))
        rs_g = np.random.RandomState(seed + 171)
        gen_bodies = []
        for _ in range(16):
            buf = io.BytesIO()
            np.savez(buf, tokens=rs_g.randint(0, geom["vocab"], rs_g.randint(8, 41)).astype(
                np.int32), max_new=np.int32(16))
            gen_bodies.append(buf.getvalue())
        uni = InferenceServer(str(dirs["main"]), device=dev, decode_weights=wpath, max_queue=64,
                              warmup=False, kv_config={"admission_window_ms": 30_000})
        ut = threading.Thread(target=uni.serve_forever, daemon=True)
        ut.start()
        try:
            _, _, uni_rep, _ = closed_loop(16, 16, lambda i: http(uni.port, "/generate",
                                                                  gen_bodies[i]))
        finally:
            uni.shutdown()
            uni.close()
            ut.join(30)
        fe = booted(fleet_of(2, ("--max-queue", "64", "--decode-weights", wpath,
                                 "--kv-admission-window-ms", "30000"),
                             roles=["prefill", "decode"]), "(e)")
        fleets.append(fe)
        h0 = fe.supervisor.counters.snapshot().get("fleet_handoffs", 0)
        wall, lats, split_rep, sheds = closed_loop(16, 16, lambda i: http(
            fe.router.port, "/generate", gen_bodies[i]))
        handoffs = fe.supervisor.counters.snapshot().get("fleet_handoffs", 0) - h0
        for i in range(16):
            (uc, _, ub), (sc, _, sb) = uni_rep[i], split_rep[i]
            require(uc == sc == 200, f"[fleet] (e) stream {i}: {uc} / {sc}")
            u, sp = np.load(io.BytesIO(ub)), np.load(io.BytesIO(sb))
            require(u["tokens"].shape == (16,) and np.array_equal(u["tokens"], sp["tokens"])
                    and u["logits"].tobytes() == sp["logits"].tobytes(),
                    f"[fleet] (e) stream {i}: the split reply differs from the unified server's")
        require(handoffs >= 16, f"[fleet] (e) fleet_handoffs {handoffs}")
        stats["e"] = dict(tokens_per_s=16 * 16 / wall, p50_ms=pctl(lats, 0.5),
                          p99_ms=pctl(lats, 0.99), handoffs=handoffs, sheds_retried=sheds)
        print(f"[fleet] (e) prefill + decode workers: 16 /generate streams (vocab "
              f"{geom['vocab']}, {geom['num_heads']} heads of {geom['head_dim']}, max_new 16) "
              f"each bit-equal to a unified server's; fleet_handoffs {handoffs}; "
              f"{16 * 16 / wall:.1f} tokens/s, p50 {pctl(lats, 0.5):.2f} ms, p99 "
              f"{pctl(lats, 0.99):.2f} ms; card {smi}")
        fe.stop()
        fleets.remove(fe)

        # (f) mixed classes (labels; every worker on the same device): a
        # fleet.divert fault sends one request to the overflow class, then
        # fleet.tier_loss SIGKILLs both primary workers under 4 clients:
        # degraded and back, no error but a 503, every 200 bit-equal
        ff = booted(fleet_of(3, ("--max-queue", "64", "--batch-window-ms", "0"),
                             backend_classes=["gpu", "gpu", "gpu-overflow"]), "(f)")
        fleets.append(ff)
        port, sup = ff.router.port, ff.supervisor
        for i in range(4):
            code, _, body = http(port, "/predict", bodies[i])
            require(code == 200 and np.array_equal(out_of(body), refs["main"][i]),
                    f"[fleet] (f) request {i}: {code}")
        code, h = healthz(port)
        require(h["degraded"] is False and h["backend_classes"] == {
            "gpu": {"replicas": 2, "live": 2}, "gpu-overflow": {"replicas": 1, "live": 1}},
            f"[fleet] (f) {h}")
        over = sup.replicas[2].routed
        faults.install(faults.FaultPlan(seed=seed + 19).add(
            "fleet.divert", raises=faults.FaultError, nth=1))
        try:
            code, _, body = http(port, "/predict", bodies[4])
        finally:
            faults.clear()
        snap = sup.counters.snapshot()
        require(code == 200 and np.array_equal(out_of(body), refs["main"][4])
                and snap.get("fleet_diverts.chaos") == 1 and sup.replicas[2].routed == over + 1,
                f"[fleet] (f) the chaos divert: {code}, {snap}")
        halt, replies, lock = threading.Event(), [], threading.Lock()

        def loader(k):
            i = k
            while not halt.is_set():
                try:
                    code, _, body = http(port, "/predict", bodies[i % 16], timeout=120)
                except OSError as e:
                    code, body = f"{type(e).__name__}: {e}", b""
                with lock:
                    replies.append((i % 16, code, body))
                i += 4

        faults.install(faults.FaultPlan(seed=seed + 20).add(
            "fleet.tier_loss", raises=faults.FaultError, nth=1))
        ths = [threading.Thread(target=loader, args=(k,), daemon=True) for k in range(4)]
        for th in ths:
            th.start()
        try:
            wait_for(lambda: sup.counters.snapshot().get("fleet_chaos_kills", 0) >= 2,
                     "both primary workers SIGKILLed")
            t_loss = time.monotonic()
            wait_for(lambda: healthz(port)[1].get("degraded") is True, "degraded")
            wait_for(lambda: healthz(port)[1].get("degraded") is False, "recovery", timeout=240)
            degraded_s = time.monotonic() - t_loss
            wait_for(lambda: healthz(port)[1]["backend_classes"]["gpu"]["live"] == 2,
                     "both primary respawns", timeout=240)
        finally:
            faults.clear()
            halt.set()
            for th in ths:
                th.join(timeout=120)
        codes = {}
        for i, code, body in replies:
            codes[code] = codes.get(code, 0) + 1
            require(code in (200, 503), f"[fleet] (f) a reply {code}")
            require(code != 200 or np.array_equal(out_of(body), refs["main"][i]),
                    f"[fleet] (f) a reply to request {i} is not predictor.run's bits")
        snap = sup.counters.snapshot()
        require(codes.get(200, 0) > 0 and snap.get("fleet_tier_losses", 0) >= 1
                and snap.get("fleet_diverts.tier_loss", 0) >= 1 and snap.get("fleet_degraded") == 0,
                f"[fleet] (f) replies {codes}, counters {snap}")
        stats["f"] = dict(replies=codes, degraded_s=degraded_s,
                          diverts={k: v for k, v in snap.items() if k.startswith("fleet_diverts")},
                          tier_losses=snap.get("fleet_tier_losses"))
        print(f"[fleet] (f) gpu, gpu, gpu-overflow: one chaos divert to the overflow class, "
              f"bit-equal; fleet.tier_loss SIGKILLed both gpu workers under 4 clients: degraded "
              f"true and back to false in {degraded_s:.1f} s, replies {codes} (every 200 "
              f"bit-equal), diverts {stats['f']['diverts']}; card {smi}")
        ff.stop()
        fleets.remove(ff)
    finally:
        faults.clear()
        for fl in fleets:
            fl.stop()
    stats["wall_s"] = time.perf_counter() - t_phase
    print(f"[fleet] phase 17 in {stats['wall_s']:.1f} s; serve_fleet launches {path}")
    return path, stats


# dygraph ResNet (upstream Paddle's test_imperative_resnet.py): bottleneck
# blocks [3, 4, 6, 3] of 64, 128, 256, 512 filters, global average pool,
# 1000 classes; b 64, 224x224, fp32, Momentum(0.1, 0.9), 5 eager steps and 5
# compiled ones from one state
DY_DEPTH, DY_FILTERS, DY_CLASSES, DY_BATCH, DY_HW, DY_STEPS = (
    [3, 4, 6, 3], [64, 128, 256, 512], 1000, 64, 224, 5)
# a compiled loss against its eager twin (relative), and parameters, BN
# running stats and velocities after the 5 steps, each within DY_STATE_TOL
# of its tensor's largest element
DY_LOSS_RTOL, DY_STATE_TOL = 1e-5, 1e-4
# the layer classes, output and grads, card vs CPU (phase 13's gate)
DY_LAYER_TOL = 1e-4
# (b)'s norm floor: a tensor whose norm is below it is rounding noise (see
# there); the parameters' and velocities' norms there are 1e-2 and up
DY_NORM_FLOOR = 1e-3


def dygraph_resnet(D, depth, filters, classes, stem=64):
    """The dygraph ResNet of upstream Paddle's test_imperative_resnet.py,
    from the port's Conv2D / BatchNorm / Pool2D / Linear: a 7x7 / 2 stem and
    a 3x3 / 2 max pool, bottleneck blocks (1x1, 3x3 with the stride, 1x1 to
    4x the filters, the shortcut projected where the shape changes), a
    global average pool and a Linear to the class logits."""
    import torch

    class ConvBN(D.Layer):
        def __init__(self, cin, cout, k, stride=1, act=None):
            super().__init__("conv_bn")
            self.conv = D.Conv2D(cin, cout, k, stride=stride, padding=(k - 1) // 2)
            self.bn = D.BatchNorm(cout, act=act)

        def forward(self, x):
            return self.bn(self.conv(x))

    class Bottleneck(D.Layer):
        def __init__(self, cin, f, stride, shortcut):
            super().__init__("bottleneck")
            self.conv0 = ConvBN(cin, f, 1, act="relu")
            self.conv1 = ConvBN(f, f, 3, stride, act="relu")
            self.conv2 = ConvBN(f, 4 * f, 1)
            self.short = None if shortcut else ConvBN(cin, 4 * f, 1, stride)

        def forward(self, x):
            y = self.conv2(self.conv1(self.conv0(x)))
            s = x if self.short is None else self.short(x)
            return D.record(lambda a, b: torch.relu(a + b), s, y)

    class ResNet(D.Layer):
        def __init__(self):
            super().__init__("resnet")
            self.stem = ConvBN(3, stem, 7, 2, act="relu")
            self.pool = D.Pool2D(3, "max", 2, 1)
            cin, blocks = stem, []
            for stage, (n, f) in enumerate(zip(depth, filters)):
                for i in range(n):
                    blk = Bottleneck(cin, f, 2 if i == 0 and stage > 0 else 1,
                                     shortcut=i > 0)
                    blocks.append(self.add_sublayer(f"b{stage}_{i}", blk))
                    cin = 4 * f
            self.blocks = blocks
            self.gap = D.Pool2D(pool_type="avg", global_pooling=True)
            self.out = D.Linear(cin, classes)

        def forward(self, x):
            h = self.pool(self.stem(x))
            for blk in self.blocks:
                h = blk(h)
            return self.out(self.gap(h))

    return ResNet()


def dygraph_phase(seed, rehearsal, smi):
    """Phase 18: dygraph on the card -> (launch counts of the dygraph path,
    the phase's result dict). (a) ResNet-50 at full width, 5 eager steps and
    5 to_compiled (CUDA graph) steps from one state; (b) a two-stage
    bottleneck net card vs CPU, eager and compiled; (c) every layer class,
    output and grads card vs CPU; (d) dropout masks; (e) no kernel of
    ops/kernels launched over the phase. Under deterministic algorithms:
    at lr 0.1 on one batch the ResNet's loss climbs over the 5 steps, and
    two eager runs from one state with cuDNN's atomic weight-grad sums
    parted by 4e-2 of the loss by the third step (NVIDIA H100 80GB HBM3,
    700 W)."""
    import torch

    deterministic = torch.are_deterministic_algorithms_enabled()
    # (the CPU's kernels are deterministic already, and some of its
    # deterministic fallbacks ran a step of the rehearsal 100x slower)
    torch.use_deterministic_algorithms(not rehearsal or deterministic, warn_only=True)
    try:
        return _dygraph_phase(seed, rehearsal, smi)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _dygraph_phase(seed, rehearsal, smi):
    from collections import Counter

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph as D
    from paddle_tpu_torch.ops import kernels, prng

    t_phase = time.perf_counter()
    place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)
    cpu = fluid.CPUPlace()

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    def xent(logits, label):
        return D.record(lambda z, y: F.cross_entropy(z, y.long().reshape(-1)), logits, label)

    def train_step(model, opt, x, y):
        loss = xent(model(x), y)
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        return loss

    def momentum(model):
        return fluid.optimizer.Momentum(0.1, 0.9, parameter_list=model.parameters())

    def state_of(model, opt):
        sd = model.state_dict()
        vel = {f"{n}#v": opt._dy_state[id(p)].detach().cpu().numpy()
               for n, p in model.named_parameters() if id(p) in opt._dy_state}
        return sd, vel

    kernels.reset_launch_counts()
    stats = {"card": smi}

    # (a) ResNet-50 at full width: eager, then compiled, from one state
    if rehearsal:
        depth, filters, classes, b, hw, stem = [1, 1, 1, 1], [4, 8, 8, 8], 10, 2, 32, 8
    else:
        depth, filters, classes, b, hw, stem = (DY_DEPTH, DY_FILTERS, DY_CLASSES, DY_BATCH,
                                                DY_HW, 64)
    rs = np.random.RandomState(seed + 18)
    xs = rs.randn(b, 3, hw, hw).astype("float32")
    ys = rs.randint(0, classes, (b, 1)).astype("int64")
    arms = {}
    with D.guard(place):
        models = {"eager": dygraph_resnet(D, depth, filters, classes, stem)}
        models["compiled"] = dygraph_resnet(D, depth, filters, classes, stem)
        models["compiled"].set_dict(models["eager"].state_dict())
        n_params = sum(int(np.prod(p.shape)) for p in models["eager"].parameters())
        x, y = D.to_variable(xs), D.to_variable(ys)
        opts = {k: momentum(m) for k, m in models.items()}
        m_c, o_c = models["compiled"], opts["compiled"]
        compiled = D.to_compiled(lambda xv, yv: train_step(m_c, o_c, xv, yv), layer=m_c,
                                 optimizer=o_c)
        runners = {"eager": lambda: train_step(models["eager"], opts["eager"], x, y),
                   "compiled": lambda: compiled(x, y)}
        for arm in ("eager", "compiled"):
            if not rehearsal:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            losses, ms, issue = [], [], []
            for _ in range(DY_STEPS):
                sync()
                t0 = time.perf_counter()
                loss = runners[arm]()
                t1 = time.perf_counter()
                sync()
                t2 = time.perf_counter()
                losses.append(float(loss.numpy()))
                issue.append((t1 - t0) * 1e3)
                ms.append((t2 - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() if not rehearsal else 0
            arms[arm] = dict(losses=losses, ms=ms, issue_ms=issue, peak=peak,
                             p50=statistics.median(ms[1:]),
                             issue_p50=statistics.median(issue[1:]))
            print(f"[dygraph] ResNet-50 {arm} b {b} {hw}x{hw} fp32 Momentum(0.1, 0.9): losses "
                  f"{losses}; step ms {[round(t, 2) for t in ms]} (p50 over steps 2-"
                  f"{DY_STEPS} {arms[arm]['p50']:.2f}); host issue ms "
                  f"{[round(t, 2) for t in issue]} (p50 {arms[arm]['issue_p50']:.2f}); "
                  f"max_memory_allocated {peak / 2**20:.0f} MiB; {b / arms[arm]['p50'] * 1e3:.1f} "
                  f"images/s; card {smi}")
        require(all(math.isfinite(v) for a in arms.values() for v in a["losses"]),
                f"[dygraph] non-finite ResNet losses {arms}")
        worst_loss = max(abs(c - e) / abs(e) for e, c in zip(arms["eager"]["losses"],
                                                              arms["compiled"]["losses"]))
        sd_e, v_e = state_of(models["eager"], opts["eager"])
        sd_c, v_c = state_of(m_c, o_c)
        got_c = sd_c | v_c
        worst_state = max((float(np.abs(got_c[k] - a).max() / max(float(np.abs(a).max()), 1e-12)),
                           k) for k, a in (sd_e | v_e).items())
        info = compiled.cache_info()
        print(f"[dygraph] ResNet-50 compiled vs eager over {DY_STEPS} steps: loss rel diff max "
              f"{worst_loss:.3e} (tol {DY_LOSS_RTOL}); parameters, running stats and "
              f"velocities max|diff| / max|value| {worst_state[0]:.3e} ({worst_state[1]}; tol "
              f"{DY_STATE_TOL}); {len(sd_e)} state tensors, {len(v_e)} velocities, "
              f"{n_params} parameters; cache_info {info}")
        require(worst_loss <= DY_LOSS_RTOL, f"[dygraph] compiled vs eager losses {arms}")
        require(worst_state[0] <= DY_STATE_TOL, f"[dygraph] compiled vs eager state {worst_state}")
        require(info["misses"] == 1 and info["hits"] == DY_STEPS - 1 and info["fallbacks"] == 0,
                f"[dygraph] cache_info {info}")
        require(len(v_e) == len(v_c) == len(models["eager"].parameters()),
                "[dygraph] a velocity is missing")
        if not rehearsal:
            rec, = compiled._cache.values()
            require(rec.graph is not None, "[dygraph] the compiled record holds no CUDA graph")
            # one profiled step of each arm: busy and idle time; the
            # compiled step's launches read from the runtime calls
            for arm in ("eager", "compiled"):
                wall, busy, _ = profile_step(torch, runners[arm], f"one ResNet-50 {arm} step")
                arms[arm].update(profiled_wall_ms=wall, busy_ms=busy,
                                 idle=max(0.0, 1 - busy / wall) if busy else None)
            copies_in = len(rec.bufs["leaves"]) + 2 + (1 if rec.rng_slots else 0)
            for attempt in range(3):  # CUPTI drops a short session now and then
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    compiled(x, y)
                    torch.cuda.synchronize()
                calls = Counter(e.name for e in prof.events())
                graph_launches = sum(c for n, c in calls.items()
                                     if n.startswith("cudaGraphLaunch"))
                kernel_launches = sum(c for n, c in calls.items() if n.startswith(
                    ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")))
                memcpys = sum(c for n, c in calls.items() if n.startswith("cudaMemcpy"))
                if graph_launches:
                    break
            print(f"[dygraph] one profiled compiled step: {graph_launches} cudaGraphLaunch, "
                  f"{kernel_launches} other kernel launches, {memcpys} memcpy calls (inputs "
                  f"and scalars copied in: {copies_in}, outputs copied out: "
                  f"{len(rec.result[0])})")
            require(graph_launches == 1 and kernel_launches <= copies_in,
                    f"[dygraph] the compiled step launched {graph_launches} graphs and "
                    f"{kernel_launches} other kernels; runtime calls {dict(calls)}")
            # the replay's device time by CUDA events, beside the profiler's
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            rec.graph.replay()
            end.record()
            torch.cuda.synchronize()
            arms["compiled"]["replay_event_ms"] = start.elapsed_time(end)
            stats.update(graph_launches=graph_launches, other_kernel_launches=kernel_launches,
                         memcpy_calls=memcpys, copies_in=copies_in)
        for arm, a in arms.items():
            print(f"[dygraph] ResNet-50 b {b} {arm}: step p50 {a['p50']:.2f} ms, host issue p50 "
                  f"{a['issue_p50']:.2f} ms, busy {a.get('busy_ms')} ms, idle {a.get('idle')}, "
                  f"peak {a['peak'] / 2**20:.0f} MiB"
                  + (f", one replay by CUDA events {a['replay_event_ms']:.2f} ms"
                     if "replay_event_ms" in a else "") + f"; card {smi}")
        stats["resnet50"] = {arm: {k: v for k, v in a.items() if k not in ("ms", "issue_ms")}
                             for arm, a in arms.items()}
        stats["resnet50"]["loss_rel_diff"] = worst_loss
        stats["resnet50"]["state_diff"] = worst_state
        del models, opts, compiled, runners, m_c, o_c
    gc.collect()
    if not rehearsal:
        torch.cuda.empty_cache()

    # (b) a two-stage bottleneck net card vs CPU, each of 3 steps from the
    # CPU's state and on a batch of its own (on one batch of 2 the loss
    # fell to 1e-3 by the third step, where a relative gate reads rounding):
    # eager on both, and compiled on the card
    rs = np.random.RandomState(seed + 19)
    xb = rs.randn(PARITY_STEPS, 2, 3, 32, 32).astype("float32")
    yb = rs.randint(0, 10, (PARITY_STEPS, 2, 1)).astype("int64")
    nets = {}
    for tag, pl in (("cpu", cpu), ("card", place), ("card_compiled", place)):
        with D.guard(pl):
            m = dygraph_resnet(D, [1, 1], [16, 32], 10, stem=16)
            o = momentum(m)
            run = (D.to_compiled(lambda a, c, m=m, o=o: train_step(m, o, a, c), layer=m,
                                 optimizer=o) if tag == "card_compiled"
                   else (lambda a, c, m=m, o=o: train_step(m, o, a, c)))
            nets[tag] = (m, o, pl, run)
    nets["card"][0].set_dict(nets["cpu"][0].state_dict())
    nets["card_compiled"][0].set_dict(nets["cpu"][0].state_dict())
    worst = {}
    for i in range(PARITY_STEPS):
        sd = nets["cpu"][0].state_dict()
        osd = nets["cpu"][1].state_dict()
        losses = {}
        for tag, (m, o, pl, run) in nets.items():
            with D.guard(pl):
                if tag != "cpu":
                    m.set_dict(sd)
                    o.set_state_dict(osd)
                losses[tag] = float(run(D.to_variable(xb[i]), D.to_variable(yb[i])).numpy())
        ref_sd, ref_v = state_of(nets["cpu"][0], nets["cpu"][1])
        for tag in ("card", "card_compiled"):
            sd_t, v_t = state_of(nets[tag][0], nets[tag][1])
            loss_rel = abs(losses[tag] - losses["cpu"]) / abs(losses["cpu"])
            stat = max((float(np.abs(sd_t[k] - a).max() / max(float(np.abs(a).max()), 1e-12)), k)
                       for k, a in ref_sd.items() if k.endswith(("_mean", "_variance")))
            # each parameter and velocity within 0.15 of its norm, or of
            # DY_NORM_FLOOR where its norm is smaller: every Conv2D here feeds
            # a batch norm, whose batch mean cancels the conv's bias, so the
            # bias's grad is zero but for rounding and its velocity's norm is
            # noise (norms ~1e-7 on an H100; 1.92 of one apart at a step)
            grad = max((float(np.linalg.norm((sd_t | v_t)[k] - a)
                              / max(float(np.linalg.norm(a)), DY_NORM_FLOOR)), k,
                        float(np.linalg.norm(a)))
                       for k, a in (ref_sd | ref_v).items()
                       if not k.endswith(("_mean", "_variance")))
            print(f"[dygraph] card vs CPU, two-stage net b 2 32x32, {tag} step {i + 1} from the "
                  f"CPU's state: losses {losses[tag]} vs {losses['cpu']} (rel diff "
                  f"{loss_rel:.3e}, tol {RN_LOSS_RTOL}); running stats {stat[0]:.3e} ({stat[1]}; "
                  f"tol {RN_STAT_RTOL}); parameters and velocities |diff| / max(|value|, "
                  f"{DY_NORM_FLOOR}) {grad[0]:.3e} ({grad[1]}, |value| {grad[2]:.3e}; tol "
                  f"{RN_GRAD_NRTOL})")
            w = worst.setdefault(tag, [0.0, (0.0, ""), (0.0, "", 0.0)])
            w[0], w[1], w[2] = max(w[0], loss_rel), max(w[1], stat), max(w[2], grad)
    for tag, w in worst.items():
        require(w[0] <= RN_LOSS_RTOL and w[1][0] <= RN_STAT_RTOL and w[2][0] <= RN_GRAD_NRTOL,
                f"[dygraph] {tag} vs CPU: {w}")
    info = nets["card_compiled"][3].cache_info()
    require(info["fallbacks"] == 0 and info["misses"] == 1, f"[dygraph] two-stage {info}")
    stats["card_vs_cpu"] = worst
    del nets

    # (c) every layer class, output and grads, card vs CPU
    rs = np.random.RandomState(seed + 20)

    def f(*shape):
        return rs.randn(*shape).astype("float32")

    ids = np.array([[1], [0], [3], [9]], "int64")
    edges = np.array([[[1, 2], [1, 3], [3, 4], [3, 5]]], "int32")
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], "float32")
    cases = {
        "Linear gelu": (lambda: D.Linear(6, 5, act="gelu"), [f(3, 2, 3)]),
        "FC softmax": (lambda: D.FC(4, 3, act="softmax"), [f(5, 4)]),
        "Conv2D s2 p1 relu": (lambda: D.Conv2D(3, 4, 3, stride=2, padding=1, act="relu"),
                              [f(2, 3, 9, 9)]),
        "Conv2D groups dilation": (lambda: D.Conv2D(4, 6, 3, padding=2, dilation=2, groups=2),
                                   [f(2, 4, 8, 8)]),
        "Pool2D max 3/2 p1": (lambda: D.Pool2D(3, "max", 2, 1), [f(2, 3, 9, 9)]),
        "Pool2D max 3/2 p2": (lambda: D.Pool2D(3, "max", 2, 2), [f(2, 3, 8, 8)]),
        "Pool2D avg exclusive": (lambda: D.Pool2D(3, "avg", 2, 1), [f(2, 3, 9, 9)]),
        "Pool2D avg inclusive p2": (lambda: D.Pool2D(3, "avg", 2, 2, exclusive=False),
                                    [f(2, 3, 8, 8)]),
        "Pool2D global max": (lambda: D.Pool2D(pool_type="max", global_pooling=True),
                              [f(2, 3, 5, 5)]),
        "Pool2D global avg": (lambda: D.Pool2D(pool_type="avg", global_pooling=True),
                              [f(2, 3, 5, 5)]),
        "BatchNorm": (lambda: D.BatchNorm(3, act="relu"), [3 * f(4, 3, 5, 5)]),
        "Embedding": (lambda: D.Embedding([10, 4], padding_idx=0), [ids]),
        "LayerNorm": (lambda: D.LayerNorm(4), [f(3, 4)]),
        "GRUUnit": (lambda: D.GRUUnit(12), [f(2, 12), f(2, 4)]),
        "PRelu channel": (lambda: D.PRelu("channel", channel=3), [f(2, 3, 4, 4)]),
        "NCE": (lambda: D.NCE(20, 6, num_neg_samples=5, seed=3),
                [f(4, 6), np.array([[1], [5], [19], [0]], "int64")]),
        "Conv2DTranspose": (lambda: D.Conv2DTranspose(3, 4, 3, stride=2, padding=1),
                            [f(2, 3, 5, 5)]),
        "Conv3D": (lambda: D.Conv3D(2, 3, 3, padding=1), [f(1, 2, 4, 4, 4)]),
        "Conv3DTranspose": (lambda: D.Conv3DTranspose(3, 2, 2, stride=2), [f(1, 3, 3, 3, 3)]),
        "BilinearTensorProduct": (lambda: D.BilinearTensorProduct(4, 5, 2), [f(3, 4), f(3, 5)]),
        "SequenceConv": (lambda: D.SequenceConv(4, 5, filter_size=3), [f(2, 6, 4), mask]),
        "RowConv": (lambda: D.RowConv(5, future_context_size=2), [f(2, 6, 5)]),
        "GroupNorm": (lambda: D.GroupNorm(4, groups=2), [5 * f(2, 4, 3, 3)]),
        "SpectralNorm": (lambda: D.SpectralNorm([6, 4], power_iters=3), [3 * f(6, 4)]),
        "TreeConv": (lambda: D.TreeConv(3, 5, num_filters=2, max_depth=2), [f(1, 5, 3), edges]),
    }
    worst_layer = (0.0, "")
    for name, (build, inputs) in cases.items():
        got = {}
        for tag, pl in (("cpu", cpu), ("card", place)):
            with D.guard(pl):
                layer = build()
                if tag == "card":
                    layer.set_dict(got["cpu"][0])
                sd0 = layer.state_dict()
                vs = []
                for k, a in enumerate(inputs):
                    v = D.to_variable(a)
                    # a sequence mask takes no grad
                    v.stop_gradient = a.dtype.kind != "f" or (name == "SequenceConv" and k == 1)
                    vs.append(v)
                out = layer(*vs)
                outs = out if isinstance(out, tuple) else (out,)
                crs = np.random.RandomState(5)
                loss = None
                for o in outs:
                    term = (o * D.to_variable(crs.randn(*o.shape).astype("float32"))).sum()
                    loss = term if loss is None else loss + term
                loss.backward()
                got[tag] = (sd0, [o.numpy() for o in outs],
                            [p.gradient() for p in layer.parameters()],
                            [v.gradient() for v in vs], layer.state_dict())
        diffs = []
        for a_list, c_list in zip(got["card"][1:4], got["cpu"][1:4]):
            for a, c in zip(a_list, c_list):
                if c is not None:
                    require(a is not None and np.isfinite(a).all(),
                            f"[dygraph] {name}: a grad or output missing or non-finite")
                    diffs.append(float(np.abs(a - c).max() / max(1.0, float(np.abs(c).max()))))
        diffs += [float(np.abs(got["card"][4][k] - c).max() / max(1.0, float(np.abs(c).max())))
                  for k, c in got["cpu"][4].items()]
        w = max(diffs)
        worst_layer = max(worst_layer, (w, name))
        print(f"[dygraph] {name}: output, grads and state card vs CPU max|diff| / max(1, "
              f"max|value|) {w:.3e} (tol {DY_LAYER_TOL})")
    require(worst_layer[0] <= DY_LAYER_TOL, f"[dygraph] layer classes card vs CPU {worst_layer}")
    stats["layers_worst"] = worst_layer

    # (d) dropout: eager masks card = CPU = the host threefry; replays of a
    # compiled step draw each call's host key
    shape, p = (32, 512), 0.1
    n = shape[0] * shape[1]
    ones = np.ones(shape, "float32")
    masks = {}
    for tag, pl in (("cpu", cpu), ("card", place)):
        with D.guard(pl):
            drop = D.Dropout(p)
            masks[tag] = [drop(D.to_variable(ones)).numpy() != 0 for _ in range(2)]
            seed_d = drop._seed

    def host_mask(key):
        bits = np.asarray(prng.random_bits(key, n), np.uint32)
        return ((((bits >> 9) | 0x3F800000).view(np.float32) - 1.0) < 1.0 - p).reshape(shape)

    for step in range(2):
        want = host_mask(prng.fold_in(prng.key(seed_d), step + 1))
        require(np.array_equal(masks["card"][step], masks["cpu"][step])
                and np.array_equal(masks["card"][step], want),
                f"[dygraph] eager dropout mask {step + 1}: card, CPU and host threefry differ")
    with D.guard(place):
        drop = D.Dropout(p)
        compiled_drop = D.to_compiled(lambda v: drop(v), layer=drop)
        replays = [compiled_drop(D.to_variable(ones)).numpy() != 0 for _ in range(3)]
        step_traced = drop._step
    for call, m in enumerate(replays, 1):
        key = prng.fold_in(prng.fold_in(prng.fold_in(prng.key(0), call), seed_d), step_traced)
        require(np.array_equal(m, host_mask(key)),
                f"[dygraph] compiled dropout call {call}: not the host key's mask")
    require(not np.array_equal(replays[1], replays[2]), "[dygraph] two replays drew one mask")
    print(f"[dygraph] Dropout({p}) {shape}: eager masks card = CPU = host threefry (2 steps, kept "
          f"{float(masks['card'][0].mean()):.4f}); 3 compiled calls ({compiled_drop.cache_info()}) "
          f"each the host key's mask for its call, calls 2 and 3 differ")

    # (e) no kernel of ops/kernels on the dygraph path
    sync()
    launches = kernels.launch_counts()
    require(all(c == 0 for c in launches.values()),
            f"[dygraph] the dygraph path launched a kernel: {launches}")
    print(f"[dygraph] launches over the phase: {launches} (the dygraph path expects none); "
          f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, stats


# phase 19: BERT-base as phase 5 trains it (batch, seq, max_preds, steps an
# arm), the cursor's split point, and ResNet-50 as phase 8's bf16 AMP trains
# it (batch, sample pool, warm-up and timed steps)
DATA_BERT = (8, 128, 20, 12)
DATA_CUT = 5
DATA_RN = (128, 256, 2, 8)


def data_phase(seed, rehearsal, smi):
    """Phase 19: the input pipeline on the card -> (launch counts of the
    data path's BERT arms, summed, the phase's result dict). (a) BERT-base
    masked-LM, fp32, b 8, fed three ways from one seeded, shuffled stream:
    L, a DataLoader staging through its pinned-memory copy stream onto the
    default place; F, the same loader yielding numpy feeds; D,
    train_from_dataset over an InMemoryDataset of MultiSlot files that
    MultiSlotDataGenerator wrote from L's batches. (b) ResNet-50 bf16 AMP
    at b 128, F against L from one state. (c) the cursor resume and the
    single-file io. (d) contrib.Trainer on uci_housing, and the py_reader
    shim. Under deterministic algorithms (warn_only, as phases 5's A/B and
    18 set them)."""
    import torch

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(not rehearsal or deterministic, warn_only=True)
    try:
        return _data_phase(seed, rehearsal, smi)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _data_phase(seed, rehearsal, smi):
    import warnings

    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import contrib, datasets, layers
    from paddle_tpu_torch import reader as rdr
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.executor import as_tensor
    from paddle_tpu_torch.incubate.data_generator import MultiSlotDataGenerator
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
    from paddle_tpu_torch.models.resnet import resnet
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.scope import to_numpy

    t_phase = time.perf_counter()
    place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)
    # the loaders' place: the default (CUDAPlace(0)) on the card
    places = fluid.CPUPlace() if rehearsal else None
    work = ROOT / "build" / "chip_smoke" / "data"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    stats = {"card": smi}
    zero = {name: 0 for name in kernels.LAUNCHES}
    path_launches = dict(zero)

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    start = [0]

    def reset_peak():
        if not rehearsal:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start[0] = torch.cuda.memory_allocated()

    def peak_mib():
        """(max_memory_allocated, and its rise above the arm's start) in MiB:
        the earlier arms' states stay allocated during a later arm."""
        if rehearsal:
            return 0.0, 0.0
        peak = torch.cuda.max_memory_allocated()
        return round(peak / 2**20, 1), round((peak - start[0]) / 2**20, 1)

    def host(feed):
        """A fed batch copied back to the host after its step."""
        return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in feed.items()}

    def same_batches(a, b):
        return len(a) == len(b) and all(
            sorted(x) == sorted(y) and all(x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
                                           and np.array_equal(x[k], y[k]) for k in x)
            for x, y in zip(a, b))

    def clone_state(main_p, scope):
        return {v.name: scope.get(v.name).detach().clone() for v in main_p.list_vars()
                if v.persistable and scope.has(v.name)
                and isinstance(scope.get(v.name), torch.Tensor)}

    def scope_from(state):
        scope = fluid.Scope()
        for n, t in state.items():
            scope.set(n, t.clone())
        return scope

    def pctls(xs):
        return {"p50": round(statistics.median(xs), 3), "max": round(max(xs), 3)}

    def htod(rows):
        """Host-to-device copies of a profiled step: (count, device ms)."""
        copies = [(ms, count) for ms, count, key in rows if "HtoD" in key]
        return sum(c for _, c in copies), round(sum(ms for ms, _ in copies), 4)

    # ---- (a) BERT-base, three feeds of one stream ------------------------
    b, s, p, steps = (2, 32, 5, 12) if rehearsal else DATA_BERT
    cfg = BertConfig.tiny() if rehearsal else BertConfig.base()
    main_p, startup_p = fluid.Program(), fluid.Program()
    main_p.random_seed = startup_p.random_seed = seed + 2
    with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
        handles = build_bert_pretrain(cfg, b, s, mlm_only=True, max_preds=p)
        fluid.optimizer.Adam(LR).minimize(handles["loss"])
    loss_v = handles["loss"]
    eval_p = main_p.clone(for_test=True)
    feed_names = ["src_ids", "sent_ids", "pos_ids", "input_mask", "mask_label",
                  "mask_weight", "mask_pos"]
    feed_vars = [main_p.global_block().var(n) for n in feed_names]
    scope0 = fluid.Scope()
    fluid.Executor(place).run(startup_p, scope=scope0)
    state0 = clone_state(main_p, scope0)
    del scope0

    sample_reader = bert_sample_reader(seed, cfg, s, p, steps * b)

    def bert_loader(double_buffer):
        loader = rdr.DataLoader.from_generator(feed_vars, use_double_buffer=double_buffer)
        return loader.set_sample_generator(sample_reader, b, shuffle_buf=64, shuffle_seed=seed,
                                           places=places)

    want = dict(zero, mha_short_fwd=cfg.num_layers, mha_short_bwd=cfg.num_layers,
                layer_norm_bwd=2 * cfg.num_layers + 2)

    def fetch_loss(out):
        return float(to_numpy(out[0]).reshape(-1)[0])

    def loader_arm(tag, double_buffer, n, cursor=None, exe=None, scope=None):
        """`n` steps of the loader arm from state0 (or the given executor
        and scope) -> the arm's record."""
        loader = bert_loader(double_buffer)
        if cursor is not None:
            loader.set_state_dict(cursor)
        exe = exe or fluid.Executor(place)
        scope = scope or scope_from(state0)
        rec = dict(fed=[], losses=[], ms=[], wait_ms=[], per_step=[], loader=loader, exe=exe,
                   scope=scope)
        staged0 = fluid.profiler.counters().get("reader_staged_batches", 0)
        kernels.reset_launch_counts()
        reset_peak()
        it = iter(loader)
        for i in range(n):
            t0 = time.perf_counter()
            feed = next(it)
            rec["wait_ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 0 and double_buffer:
                rec["pass_through"] = all(
                    as_tensor(t, main_p.global_block().var(k).dtype, exe.device) is t
                    for k, t in feed.items())
                rec["feed_devices"] = sorted({str(t.device) for t in feed.values()})
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            out = exe.run(main_p, feed=feed, fetch_list=[loss_v], scope=scope)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["per_step"].append({k: c - before[k] for k, c in kernels.launch_counts().items()})
            rec["losses"].append(fetch_loss(out))
            rec["fed"].append(host(feed))
        rec["launches"] = kernels.launch_counts()
        rec["peak"] = peak_mib()
        rec["staged"] = fluid.profiler.counters().get("reader_staged_batches", 0) - staged0
        rec["cursor"] = loader.state_dict()
        it.close()
        print(f"[data] {tag}: losses {rec['losses']}; step p50 "
              f"{statistics.median(rec['ms']):.2f} ms, next() wait {pctls(rec['wait_ms'])} ms, "
              f"staged {rec['staged']}, peak (and its rise in the arm) {rec['peak']} MiB; "
              f"card {smi}")
        return rec

    elapsed_a = time.perf_counter()
    arms = {"L": loader_arm("L (staged, default place)", True, steps),
            "F": loader_arm("F (numpy feeds)", False, steps)}

    # D: the same batches written as MultiSlot files, through
    # train_from_dataset, which does not wait for the card between steps:
    # each step's feed is cloned on the step's stream right after it (no
    # host wait, so a staged block handed to a later copy too early would
    # show in the clones) and copied to the host after the loop
    class Rows(MultiSlotDataGenerator):
        def generate_sample(self, line):
            bi, ri = map(int, line.split())
            row = [(n, arms["L"]["fed"][bi][n][ri].reshape(-1).tolist()) for n in feed_names]
            return lambda: iter([row])

    index = work / "rows.txt"
    index.write_text("".join(f"{bi} {ri}\n" for bi in range(steps) for ri in range(b)))
    (slot_file,) = Rows().run_from_files([str(index)], str(work / "bert_slots"))
    dataset = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    dataset.set_batch_size(b)
    dataset.set_thread(1)
    dataset.set_filelist([slot_file])
    dataset.set_use_var(feed_vars)
    dataset.load_into_memory()
    exe_d, scope_d = fluid.Executor(place), scope_from(state0)
    rec_d = dict(fed=[], losses=[], ms=[], wait_ms=[], per_step=[])
    last_end = [None]
    run_plain = exe_d.run

    def run_recorded(program, feed=None, fetch_list=None, scope=None, return_numpy=True,
                     build_strategy=None):
        t0 = time.perf_counter()
        if last_end[0] is not None:
            rec_d["wait_ms"].append((t0 - last_end[0]) * 1e3)
        before = kernels.launch_counts()
        out = run_plain(program, feed=feed, fetch_list=fetch_list, scope=scope,
                        return_numpy=return_numpy, build_strategy=build_strategy)
        rec_d["per_step"].append({k: c - before[k] for k, c in kernels.launch_counts().items()})
        rec_d["feed_devices"] = sorted({str(t.device) for t in feed.values()})
        rec_d["fed"].append({k: v.clone() for k, v in feed.items()})
        rec_d["losses"].append(out[0])
        rec_d["ms"].append((time.perf_counter() - t0) * 1e3)
        last_end[0] = time.perf_counter()
        return out

    staged0 = fluid.profiler.counters().get("reader_staged_batches", 0)
    kernels.reset_launch_counts()
    reset_peak()
    exe_d.run = run_recorded
    t0 = time.perf_counter()
    last = exe_d.train_from_dataset(main_p, dataset, scope=scope_d, thread=1,
                                    fetch_list=[loss_v])
    d_wall = (time.perf_counter() - t0) * 1e3
    del exe_d.run
    rec_d["launches"] = kernels.launch_counts()
    rec_d["peak"] = peak_mib()
    rec_d["staged"] = fluid.profiler.counters().get("reader_staged_batches", 0) - staged0
    rec_d["losses"] = [fetch_loss([v]) for v in rec_d["losses"]]
    rec_d["fed"] = [host(f) for f in rec_d["fed"]]
    rec_d["last"] = fetch_loss(last)
    arms["D"] = rec_d
    print(f"[data] D (train_from_dataset): losses {rec_d['losses']}; {d_wall:.1f} ms for "
          f"{len(rec_d['ms'])} steps ({d_wall / len(rec_d['ms']):.2f} ms a step), issue "
          f"(exe.run's return, not waiting for the card) p50 "
          f"{statistics.median(rec_d['ms']):.2f} ms, wait between steps "
          f"{pctls(rec_d['wait_ms'])} ms, staged {rec_d['staged']}, peak (and its rise) "
          f"{rec_d['peak']} MiB; card {smi}")

    for tag in "LFD":
        path_launches = {k: path_launches[k] + arms[tag]["launches"][k] for k in zero}
    L, F, D = arms["L"], arms["F"], arms["D"]
    gates = {
        "F and L fed batches byte-equal": same_batches(F["fed"], L["fed"]),
        "D fed batches byte-equal to L's": same_batches(D["fed"], L["fed"]),
        "F and L losses bit-equal": F["losses"] == L["losses"],
        "D losses bit-equal to L's": D["losses"] == L["losses"],
        "D's last loss is L's last": D["last"] == L["losses"][-1],
        "staged batches counted": L["staged"] == steps and D["staged"] == steps
        and F["staged"] == 0,
        "L and D fed from the card": rehearsal or (
            L["feed_devices"] == ["cuda:0"] and D["feed_devices"] == ["cuda:0"]),
        "staged feeds pass exe.run untouched": L["pass_through"],
        "cursor at the end of the epoch": L["cursor"] == {"epoch": 0, "batch": steps,
                                                          "shuffle_seed": seed},
    }
    if not rehearsal:
        for tag in "LFD":
            gates[f"{tag} launches a step"] = all(c == want for c in arms[tag]["per_step"])
    stats["bert"] = {tag: {"step_p50_ms": round(statistics.median(a["ms"]), 3),
                           "wait_ms": pctls(a["wait_ms"]), "peak_mib": a["peak"],
                           "staged": a["staged"], "losses": a["losses"]}
                     for tag, a in arms.items()}
    # D's steps are not waited for one by one: its step time is the loop's
    # wall over its steps, and its p50 the host's issue time
    stats["bert"]["D"].update(wall_ms=round(d_wall, 3), step_mean_ms=round(d_wall / steps, 3),
                              issue_p50_ms=stats["bert"]["D"].pop("step_p50_ms"))
    print(f"[data] (a) BERT hidden {cfg.hidden_size} x {cfg.num_layers}, b {b} s {s} "
          f"max_preds {p}, {steps} steps an arm: launches a step {L['per_step'][0]} "
          f"(want {want}); {time.perf_counter() - elapsed_a:.1f} s")

    # one profiled step an arm: L and F on the last two batches of a second
    # epoch (the stager then has nothing left to copy), D over one batch
    if not rehearsal:
        ds1_file = work / "bert_slots_one"
        ds1_file.write_text("".join(open(slot_file).readlines()[:b]))
        ds1 = fluid.DatasetFactory().create_dataset("InMemoryDataset")
        ds1.set_batch_size(b)
        ds1.set_filelist([str(ds1_file)])
        ds1.set_use_var(feed_vars)
        ds1.load_into_memory()
        profiles = {}
        for tag in "LF":
            a = arms[tag]
            a["loader"].set_state_dict({"epoch": 1, "batch": steps - 2, "shuffle_seed": seed})
            it = iter(a["loader"])
            prof = profile_step(torch, lambda: a["exe"].run(main_p, feed=next(it),  # noqa: B023
                                                            fetch_list=[loss_v],
                                                            scope=a["scope"]),
                                f"one BERT step, arm {tag}")
            it.close()
            profiles[tag] = prof
        profiles["D"] = profile_step(
            torch, lambda: exe_d.train_from_dataset(main_p, ds1, scope=scope_d,
                                                    fetch_list=[loss_v]),
            "one BERT step, arm D (a one-batch train_from_dataset)")
        for tag, (wall, busy, rows) in profiles.items():
            stats["bert"][tag].update(profile_wall_ms=round(wall, 3), busy_ms=round(busy, 3),
                                      idle=round(max(0.0, 1 - busy / wall), 4) if wall else None,
                                      htod_memcpys=htod(rows))
        print(f"[data] host-to-device copies in the profiled step (count, device ms): L "
              f"{stats['bert']['L']['htod_memcpys']}, F {stats['bert']['F']['htod_memcpys']}, "
              f"D {stats['bert']['D']['htod_memcpys']} ({len(feed_names)} feeds a batch)")

    # ---- (c) the cursor and the single files -----------------------------
    cut = DATA_CUT
    first = loader_arm(f"L, first {cut} batches", True, cut)
    cursor = first["cursor"]
    ck = work / "ckpt"
    with fluid.scope_guard(first["scope"]):
        fluid.io.save_persistables(first["exe"], str(ck), main_p, filename="ckpt")
        fluid.io.save_params(first["exe"], str(ck), main_p, filename="params")
    params_at_save = {v.name: first["scope"].get(v.name).detach().clone()
                      for v in main_p.list_vars() if isinstance(v, fluid.framework.Parameter)}
    exe_r, scope_r = fluid.Executor(place), fluid.Scope()
    with fluid.scope_guard(scope_r):
        fluid.io.load_persistables(exe_r, str(ck), main_p, filename="ckpt")
    exe_r._seed_counter = cut  # as the JAX CheckpointManager restores it
    resumed = loader_arm(f"L resumed at {cursor}", True, steps - cut, cursor=cursor,
                         exe=exe_r, scope=scope_r)
    scope_p = fluid.Scope()
    with fluid.scope_guard(scope_p):
        fluid.io.load_params(fluid.Executor(place), str(ck), main_p, filename="params")
    gates["cursor after the first batches"] = cursor == {"epoch": 0, "batch": cut,
                                                         "shuffle_seed": seed}
    gates["resumed batches byte-equal"] = same_batches(resumed["fed"], L["fed"][cut:])
    gates["resumed losses bit-equal"] = (first["losses"] == L["losses"][:cut]
                                         and resumed["losses"] == L["losses"][cut:])
    gates["load_params bit for bit"] = sorted(params_at_save) == sorted(
        n for n in params_at_save if scope_p.has(n)) and all(
        torch.equal(scope_p.get(n), t) for n, t in params_at_save.items())
    export = work / "eval_export"
    with fluid.scope_guard(scope_r):
        fluid.io.save_inference_model(str(export), feed_names,
                                      [eval_p.global_block().var(loss_v.name)], exe_r,
                                      main_program=eval_p, params_filename="params")
    probe = dict(L["fed"][0])
    want_eval = exe_r.run(eval_p, feed=dict(probe), fetch_list=[loss_v.name], scope=scope_r)[0]
    exe_x, scope_x = fluid.Executor(place), fluid.Scope()
    with fluid.scope_guard(scope_x):
        prog_x, feeds_x, fetch_x = fluid.io.load_inference_model(str(export), exe_x,
                                                                 params_filename="params")
        got_eval = exe_x.run(prog_x, feed=dict(probe), fetch_list=fetch_x)[0]
    gates["export fetch bit-equal"] = (feeds_x == feed_names
                                       and got_eval.tobytes() == want_eval.tobytes())
    stats["cursor"] = {"cursor": cursor, "export_loss": float(got_eval.reshape(-1)[0]),
                       "files": sorted(os.listdir(ck)) + sorted(os.listdir(export))}
    print(f"[data] (c) cursor {cursor}; resumed losses {resumed['losses']} vs "
          f"{L['losses'][cut:]}; files {stats['cursor']['files']}; eval export loss "
          f"{float(got_eval.reshape(-1)[0])!r} vs {float(want_eval.reshape(-1)[0])!r}")
    for rec in (first, resumed):
        path_launches = {k: path_launches[k] + rec["launches"][k] for k in zero}
        if not rehearsal:
            gates["cursor arms' launches a step"] = gates.get(
                "cursor arms' launches a step", True) and all(c == want for c in rec["per_step"])

    # ---- (d) the contrib Trainer and py_reader ---------------------------
    def fit_a_line():
        x = layers.data("x", [13], dtype="float32")
        y = layers.data("y", [1], dtype="float32")
        pred = layers.fc(x, 1)
        return layers.mean(layers.square_error_cost(pred, y))

    trainer = contrib.Trainer(fit_a_line, lambda: fluid.optimizer.SGD(0.01),
                              place=fluid.CPUPlace() if rehearsal else None)
    tr_losses = []

    def on_event(event):
        if isinstance(event, contrib.EndStepEvent):
            tr_losses.append(float(np.asarray(event.metrics[0]).reshape(-1)[0]))

    trainer.train(2, on_event, reader=rdr.batch(datasets.uci_housing.train(), 20),
                  feed_order=["x", "y"])
    half = len(tr_losses) // 2
    gates["Trainer on the card"] = rehearsal or trainer.exe.device.type == "cuda"
    gates["Trainer losses finite and falling"] = (
        all(math.isfinite(v) for v in tr_losses)
        and statistics.mean(tr_losses[half:]) < statistics.mean(tr_losses[:half])
        and tr_losses[-1] < tr_losses[0])
    stats["trainer"] = {"steps": len(tr_losses), "first": tr_losses[0], "last": tr_losses[-1],
                        "epoch_means": [statistics.mean(tr_losses[:half]),
                                        statistics.mean(tr_losses[half:])]}
    shim = layers.create_py_reader_by_data(capacity=2, feed_list=feed_vars)
    first_samples = next(iter(bert_loader(False)._epoch_batches(0)))
    shim.decorate_sample_list_generator(lambda: iter([first_samples]), places=places)
    shim.start()
    shim_feed = shim.next_feed()
    shim.reset()
    gates["py_reader batch is L's first"] = same_batches([host(shim_feed)], L["fed"][:1]) and (
        rehearsal or all(t.is_cuda for t in shim_feed.values()))
    print(f"[data] (d) Trainer on {trainer.exe.device}: {len(tr_losses)} steps, losses "
          f"{tr_losses[0]:.4f} -> {tr_losses[-1]:.4f}, epoch means "
          f"{stats['trainer']['epoch_means']}; py_reader shim batch on "
          f"{sorted({str(t.device) for t in shim_feed.values()})}")
    del arms, L, F, D, first, resumed, scope_r, scope_p, scope_x, scope_d, exe_d, state0
    del trainer, shim, shim_feed
    gc.collect()
    if not rehearsal:
        torch.cuda.empty_cache()

    # ---- (b) ResNet-50 bf16 AMP, staged against unstaged -----------------
    rb, pool_n, warm, timed = (4, 8, 2, 8) if rehearsal else DATA_RN
    depth, hw = (18, 32) if rehearsal else (50, 224)
    rn_lr = 0.05 if rehearsal else RN_LR
    main_r, startup_r = fluid.Program(), fluid.Program()
    main_r.random_seed = startup_r.random_seed = seed + 3
    with fluid.program_guard(main_r, startup_r), fluid.unique_name.guard():
        img = layers.data("img", [rb, 3, hw, hw], append_batch_size=False)
        label = layers.data("label", [rb, 1], dtype="int64", append_batch_size=False)
        _, loss_r, _, _ = resnet(img, label, depth=depth, class_num=1000)
        mixed_precision.decorate(fluid.optimizer.Momentum(rn_lr, RN_MOMENTUM)).minimize(loss_r)
    scope0 = fluid.Scope()
    fluid.Executor(place).run(startup_r, scope=scope0)
    rstate0 = clone_state(main_r, scope0)
    del scope0

    def images():
        rs = np.random.RandomState(seed + 19)
        for _ in range(pool_n):
            yield rs.rand(3, hw, hw).astype("float32"), int(rs.randint(0, 1000))

    pool = rdr.cache(images)
    n_steps = warm + timed
    rn_samples = rdr.chain(*[pool] * (n_steps * rb // pool_n))
    rn_arms, f_states = {}, []
    nondeterministic = set()
    for tag, double_buffer in (("F", False), ("L", True)):
        loader = rdr.DataLoader.from_generator([img, label], capacity=4,
                                               use_double_buffer=double_buffer)
        loader.set_sample_generator(rn_samples, rb, places=places)
        loader.time_copies = True
        exe, scope = fluid.Executor(place), scope_from(rstate0)
        rec = dict(fed=[], losses=[], ms=[], wait_ms=[], loader=loader, exe=exe, scope=scope)
        kernels.reset_launch_counts()
        reset_peak()
        it = iter(loader)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(n_steps):
                if tag == "F":  # on the host, out of the arm's memory
                    f_states.append({v.name: scope.get(v.name).detach().cpu()
                                     for v in main_r.list_vars()
                                     if v.persistable and scope.has(v.name)})
                t0 = time.perf_counter()
                feed = next(it)
                rec["wait_ms"].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                out = exe.run(main_r, feed=feed, fetch_list=[loss_r], scope=scope)
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
                rec["losses"].append(fetch_loss(out))
                rec["fed"].append(host(feed))
        nondeterministic |= {str(w.message).split(" does not have")[0] for w in caught
                             if "deterministic" in str(w.message)}
        rec["launches"] = kernels.launch_counts()
        rec["peak"] = peak_mib()
        rec["h2d_ms"] = loader.last_stager.copy_ms() if loader.last_stager else []
        it.close()
        rn_arms[tag] = rec
        print(f"[data] ResNet-{depth} bf16 AMP b {rb}, arm {tag}: losses {rec['losses']}; step "
              f"p50 {statistics.median(rec['ms'][warm:]):.2f} ms over {timed} timed steps "
              f"(first {rec['ms'][0]:.2f}), next() wait {pctls(rec['wait_ms'][warm:])} ms, "
              f"peak (and its rise in the arm) {rec['peak']} MiB; card {smi}")
    RF, RL = rn_arms["F"], rn_arms["L"]
    gates["ResNet fed batches byte-equal"] = same_batches(RF["fed"], RL["fed"])
    bit_equal = RF["losses"] == RL["losses"]
    held = "bit-equal, free-running" if bit_equal else None
    if not bit_equal:
        # each step from F's state before it, on L's fed batch: one bf16 ulp
        worst = 0.0
        for i in range(n_steps):
            exe = fluid.Executor(place)
            out = exe.run(main_r, feed=dict(RL["fed"][i]), fetch_list=[loss_r],
                          scope=scope_from(f_states[i]))
            worst = max(worst, abs(fetch_loss(out) - RF["losses"][i])
                        / ulp(RF["losses"][i], "bfloat16"))
        held = f"each step from one state, within {worst:.3f} bf16 ulp" if worst <= 1 else None
        print(f"[data] ResNet F and L free-running differ ({nondeterministic or 'no warning'}); "
              f"each step from one state: worst {worst:.3f} bf16 ulp")
    gates["ResNet losses"] = held is not None
    gates["ResNet arms launch no kernel"] = all(
        c == 0 for rec in (RF, RL) for c in rec["launches"].values())
    stats["resnet"] = {tag: {"step_p50_ms": round(statistics.median(r["ms"][warm:]), 3),
                             "wait_ms": pctls(r["wait_ms"][warm:]),
                             "peak_mib": r["peak"], "losses": r["losses"]}
                       for tag, r in rn_arms.items()}
    stats["resnet"]["losses_held"] = held
    stats["resnet"]["nondeterministic_ops"] = sorted(nondeterministic)
    if RL["h2d_ms"]:
        stats["resnet"]["L"]["h2d_ms"] = {
            "p50": round(statistics.median(RL["h2d_ms"]), 4),
            "all": [round(x, 4) for x in RL["h2d_ms"]],
            "batch_mib": round(RL["fed"][0]["img"].nbytes / 2**20, 2)}
    del f_states
    if not rehearsal:
        for tag in "FL":
            r = rn_arms[tag]
            r["loader"].set_state_dict({"epoch": 1, "batch": n_steps - 2})
            it = iter(r["loader"])
            wall, busy, rows = profile_step(
                torch, lambda: r["exe"].run(main_r, feed=next(it),  # noqa: B023
                                            fetch_list=[loss_r], scope=r["scope"]),
                f"one ResNet-{depth} bf16 step, arm {tag}")
            it.close()
            stats["resnet"][tag].update(profile_wall_ms=round(wall, 3), busy_ms=round(busy, 3),
                                        idle=round(max(0.0, 1 - busy / wall), 4) if wall else None,
                                        htod_memcpys=htod(rows))
    print(f"[data] (b) ResNet losses held: {held}; H2D of one batch "
          f"{stats['resnet']['L'].get('h2d_ms')}; {json.dumps(stats['resnet'], default=str)}")
    del rn_arms, RF, RL, rstate0
    gc.collect()
    if not rehearsal:
        torch.cuda.empty_cache()

    stats["gates"] = gates
    failed = [g for g, ok in gates.items() if not ok]
    print(f"[data] gates: {gates}")
    require(not failed, f"[data] gates failed: {failed}")
    print(f"[data] launches over the BERT arms: {path_launches}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return path_launches, stats


# phase 20: BERT-base as phase 5 trains it (batch, seq, max_preds, steps), the
# manager's cadence and retention, the step at which fleet.kill_trainer
# SIGKILLs the supervised worker and the step at which it is asked to stop,
# and NanGuard's cadence and streak
RES_BERT = (8, 128, 20, 12)
RES_INTERVAL, RES_KEEP = 4, 2
RES_KILL_AT, RES_STOP_AT = 6, 8
NAN_INTERVAL, NAN_STREAK = 2, 2
RES_FEEDS = ("src_ids", "sent_ids", "pos_ids", "input_mask", "mask_label", "mask_weight",
             "mask_pos")


def resilience_job(seed, rehearsal, guard=None):
    """Phase 20's job, built alike in the phase and in its worker processes:
    BERT-base masked-LM (fp32, Adam 1e-4, or `guard.decorate(Adam)`, dropout
    0.1) and a factory of DataLoaders over phase 19's seeded stream,
    shuffled, staged onto the default place."""
    from types import SimpleNamespace

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import reader as rdr
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    b, s, p, steps = (2, 32, 5, 12) if rehearsal else RES_BERT
    cfg = BertConfig.tiny() if rehearsal else BertConfig.base()
    main_p, startup_p = fluid.Program(), fluid.Program()
    main_p.random_seed = startup_p.random_seed = seed + 3
    with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
        handles = build_bert_pretrain(cfg, b, s, mlm_only=True, max_preds=p)
        opt = fluid.optimizer.Adam(LR)
        (guard.decorate(opt) if guard is not None else opt).minimize(handles["loss"])
    feed_vars = [main_p.global_block().var(n) for n in RES_FEEDS]

    def loader():
        return rdr.DataLoader.from_generator(feed_vars).set_sample_generator(
            bert_sample_reader(seed, cfg, s, p, steps * b), b, shuffle_buf=64,
            shuffle_seed=seed, places=fluid.CPUPlace() if rehearsal else None)

    return SimpleNamespace(
        cfg=cfg, b=b, s=s, p=p, steps=steps, main=main_p, startup=startup_p,
        loss=handles["loss"], loader=loader,
        place=fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0),
        want={"mha_short_fwd": cfg.num_layers, "mha_short_bwd": cfg.num_layers,
              "layer_norm_bwd": 2 * cfg.num_layers + 2})


def batch_crc(feed):
    """crc32 of a fed batch's bytes, its arrays in feed order."""
    import zlib

    crc = 0
    for n in RES_FEEDS:
        v = feed[n]
        crc = zlib.crc32((v.detach().cpu().numpy() if hasattr(v, "detach") else v).tobytes(),
                         crc)
    return crc


def resilience_worker(workdir, seed, rehearsal):
    """Phase 20's supervised worker (`chip_smoke.py --resilience-worker
    DIR`): resume from the newest valid snapshot under DIR/ckpt (or start
    fresh), train the job's steps under `attach` and `track_reader`, one
    JSON line a step into DIR/steps.jsonl (step, batch crc32, loss, kernel
    launches, step ms), and on SIGTERM commit a final snapshot and exit 0.
    Raises without a card."""
    t_enter = time.perf_counter()
    import torch

    # deterministic before the first CUDA call, as the phase runs
    torch.use_deterministic_algorithms(not rehearsal, warn_only=True)
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.ops import kernels

    t_import = time.perf_counter()
    job = resilience_job(seed, rehearsal)
    exe = fluid.Executor(job.place)  # CUDAPlace(0) raises without a card
    ckpt = Path(workdir) / "ckpt"
    attempt = int(os.environ.get("PADDLE_TPU_TRAINER_ATTEMPT", "0"))
    log = open(Path(workdir) / "steps.jsonl", "a")

    def emit(**rec):
        log.write(json.dumps(dict(rec, attempt=attempt, pid=os.getpid())) + "\n")
        log.flush()

    loader = job.loader()
    mgr = resilience.CheckpointManager(str(ckpt), save_interval=RES_INTERVAL, keep=RES_KEEP)
    mgr.track_reader(loader, "train")
    found = sorted(os.listdir(ckpt)) if ckpt.exists() else []
    t0 = time.perf_counter()
    restored = mgr.restore_or_initialize(exe, job.main, job.startup)
    if not rehearsal:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    emit(event="start", restored=restored, restore_ms=round((t1 - t0) * 1e3, 3),
         import_ms=round((t_import - t_enter) * 1e3, 3), build_ms=round((t0 - t_import) * 1e3, 3),
         free_mib=round(torch.cuda.mem_get_info(0)[0] / 2**20, 1) if not rehearsal else None,
         found=found, cursor=loader.state_dict(), seed_counter=exe._seed_counter)
    mgr.attach(job.main)
    with resilience.PreemptionHandler(mgr) as pre:
        it = iter(loader)
        while mgr._auto_step < job.steps:
            step = mgr._auto_step
            t0 = time.perf_counter()
            feed = next(it)
            before = kernels.launch_counts()
            (lv,) = exe.run(job.main, feed=feed, fetch_list=[job.loss])
            emit(event="step", step=step, crc=batch_crc(feed),
                 loss=float(np.asarray(lv).reshape(-1)[0]),
                 ms=round((time.perf_counter() - t0) * 1e3, 3),
                 launches={k: c - before[k] for k, c in kernels.launch_counts().items()})
            if pre.preempted:
                pre.final_save(mgr._auto_step - 1, program=job.main, executor=exe)
                emit(event="final_save", step=mgr._auto_step - 1)
                break
        it.close()
    mgr.drain()
    mgr.close()
    emit(event="exit")
    return 0


def resilience_phase(seed, rehearsal, smi):
    """Phase 20: checkpointing, supervision and the NaN guard on the card ->
    (launch counts of the resilience path, the phase's result dict). (a)
    12 BERT-base steps in process, without a manager and under
    CheckpointManager(save_interval=4, keep=2, async) with track_reader and
    attach, from one state. (b) the same job in worker processes under the
    TrainSupervisor: SIGKILLed by fleet.kill_trainer, resumed, stopped by
    SIGTERM (a final snapshot), finished by a second supervisor. (c)
    NanGuard's skip and rollback, in this process while (b)'s first worker
    starts. Under deterministic algorithms (warn_only, as phase 19 sets
    them)."""
    import torch

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(not rehearsal or deterministic, warn_only=True)
    try:
        return _resilience_phase(seed, rehearsal, smi)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _resilience_phase(seed, rehearsal, smi):
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import faults, snapshot
    from paddle_tpu_torch.resilience.trainer_fleet import TrainSupervisor
    from paddle_tpu_torch.scope import to_numpy

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "resilience"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    zero = {name: 0 for name in kernels.LAUNCHES}
    path_launches = dict(zero)
    stats = {"card": smi}
    gates = {}

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    def add_launches(per_step):
        for d in per_step:
            for k in zero:
                path_launches[k] += d[k]

    def persistables(main_p, scope):
        return {v.name: scope.get(v.name) for v in main_p.list_vars()
                if v.persistable and scope.has(v.name)}

    def counter_delta(c0):
        c1 = fluid.profiler.counters()
        return {k: c1.get(k, 0) - c0.get(k, 0) for k in
                ("ckpt_save_ms", "ckpt_bytes", "ckpt_async_overlap_ms",
                 "ckpt_snapshots_committed", "nan_steps_skipped", "nan_rollbacks")}

    def pctl(xs, q):
        xs = sorted(xs)
        return round(xs[min(len(xs) - 1, int(q * len(xs)))], 3) if xs else None

    # ---- (a) in process: no manager against the async manager -------------
    job = resilience_job(seed, rehearsal)
    want = dict(zero, **job.want)
    root_a = work / "arm_m"

    def arm(tag, with_mgr):
        loader, scope, exe = job.loader(), fluid.Scope(), fluid.Executor(job.place)
        exe.run(job.startup, scope=scope)
        start = {n: t.clone() for n, t in persistables(job.main, scope).items()}
        rec = dict(tag=tag, start=start, fed=[], losses=[], ms=[], per_step=[], clones={},
                   seen={})
        mgr = None
        if with_mgr:
            mgr = resilience.CheckpointManager(str(root_a), save_interval=RES_INTERVAL,
                                               keep=RES_KEEP, async_save=True)
            mgr.track_reader(loader, "train").attach(job.main)
        # each committed manifest as it lands (retention prunes the older
        # ones while the arm runs)
        polling = threading.Event()

        def poll():
            for st, path in snapshot.list_snapshots(str(root_a)):
                if st not in rec["seen"]:
                    m = snapshot.read_manifest(path)
                    if m is not None:
                        rec["seen"][st] = m

        def poller():  # a snapshot lives at least one flush (~1 s) past its commit
            while not polling.is_set():
                poll()
                time.sleep(0.1)

        watcher = threading.Thread(target=poller, daemon=True)
        if with_mgr:
            watcher.start()
        c0 = fluid.profiler.counters()
        sync()
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        it = iter(loader)
        t_loop = time.perf_counter()
        for i in range(job.steps):
            t0 = time.perf_counter()
            feed = next(it)
            before = kernels.launch_counts()
            (lv,) = exe.run(job.main, feed=feed, fetch_list=[job.loss], scope=scope,
                            return_numpy=False)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["per_step"].append({k: c - before[k] for k, c in kernels.launch_counts().items()})
            rec["losses"].append(lv)
            rec["fed"].append(feed)
            if mgr is not None and mgr.should_save(i):
                # the state the snapshot copies, cloned on the step's stream:
                # the next step is dispatched without a host wait
                rec["clones"][i] = {n: t.clone() for n, t in persistables(job.main, scope).items()}
        it.close()
        rec["issue_s"] = time.perf_counter() - t_loop
        if mgr is not None:
            # the end of the job: its last step's state, as a trainer keeps it
            last = job.steps - 1
            rec["clones"][last] = {n: t.clone() for n, t in persistables(job.main, scope).items()}
            t0 = time.perf_counter()
            mgr.save(last, program=job.main, scope=scope, executor=exe)
            mgr.drain()
            rec["drain_ms"] = (time.perf_counter() - t0) * 1e3
        sync()
        rec["wall_s"] = time.perf_counter() - t_loop
        polling.set()
        if with_mgr:
            watcher.join()
            poll()
            rec["latest"] = mgr.latest_step(deep=True)
            rec["submit_ms"] = list(mgr.engine.submit_ms)
            rec["copy_ms"] = list(mgr.engine.copy_ms)
            rec["kept"] = [s for s, _ in snapshot.list_snapshots(str(root_a))]
            mgr.close()
        rec["counters"] = counter_delta(c0)
        rec["peak_mib"] = round(torch.cuda.max_memory_allocated() / 2**20, 1) \
            if not rehearsal else 0.0
        rec["losses"] = [float(to_numpy(v).reshape(-1)[0]) for v in rec["losses"]]
        rec["crcs"] = [batch_crc(f) for f in rec.pop("fed")]
        rec["scope"] = scope
        add_launches(rec["per_step"])
        print(f"[resilience] (a) {tag}: losses {rec['losses']}; step p50 "
              f"{statistics.median(rec['ms']):.2f} ms (host, no wait between steps), "
              f"{job.steps} steps in {rec['wall_s']:.2f} s to the card's end; peak "
              f"{rec['peak_mib']} MiB; card {smi}")
        return rec

    N = arm("N (no manager)", False)
    M = arm(f"M (CheckpointManager(save_interval={RES_INTERVAL}, keep={RES_KEEP}, async))",
            True)
    saved = sorted(M["clones"])
    snap_ok, snap_detail = True, {}
    for st in saved:
        m = M["seen"].get(st)
        clones = M["clones"][st]
        if m is None or sorted(m["vars"]) != sorted(clones):
            snap_ok, snap_detail[st] = False, "not observed" if m is None else "vars differ"
            continue
        # every var's record crc32 is the crc of the clone's np.save bytes,
        # its dtype and shape the clone's
        bad = [n for n, t in clones.items()
               if zlib.crc32(snapshot._array_bytes(snapshot._host(t))) & 0xFFFFFFFF
               != m["vars"][n]["crc32"] or m["vars"][n]["dtype"] != str(snapshot._host(t).dtype)
               or m["vars"][n]["shape"] != list(t.shape)]
        snap_detail[st] = f"{len(clones)} vars, {len(bad)} differ"
        snap_ok = snap_ok and not bad
    for st in M["kept"]:  # the kept ones read back whole, too
        arrays, _ = resilience.load_snapshot(snapshot.snapshot_dir(str(root_a), st))
        snap_ok = snap_ok and all(np.array_equal(arrays[n], to_numpy(t))
                                  for n, t in M["clones"][st].items())
    man = M["seen"].get(saved[-1], {})
    gb = man.get("data_bytes", 0) / 1e9
    stats["a"] = {
        "step_p50_ms": {"N": round(statistics.median(N["ms"]), 3),
                        "M": round(statistics.median(M["ms"]), 3)},
        "step_ms_at_saves": [round(M["ms"][s], 3) for s in saved if s < job.steps - 1],
        "wall_s": {"N": round(N["wall_s"], 3), "M": round(M["wall_s"], 3)},
        "ckpt": M["counters"], "data_bytes": man.get("data_bytes"),
        "snapshots": saved, "kept": M["kept"],
        "submit_ms": {"p50": pctl(M["submit_ms"], 0.5), "max": pctl(M["submit_ms"], 1.0),
                      "all": [round(x, 3) for x in M["submit_ms"]]},
        "copy_ms": [round(x, 3) for x in M["copy_ms"]],
        "copy_gb_s": [round(gb / (x / 1e3), 2) for x in M["copy_ms"] if x > 0],
        "drain_ms": round(M["drain_ms"], 3),
        "peak_mib": {"N": N["peak_mib"], "M": M["peak_mib"]},
        "disk_free_gib": round(shutil.disk_usage(work).free / 2**30, 1),
        "snapshot_check": snap_detail,
    }
    gates.update({
        "(a) one start state": all(torch.equal(N["start"][n], M["start"][n])
                                   for n in N["start"]),
        "(a) losses bit-equal across the arms": N["losses"] == M["losses"],
        "(a) fed batches equal across the arms": N["crcs"] == M["crcs"],
        "(a) snapshots bit-equal to their step's state": snap_ok,
        "(a) cadence and end saves": saved == sorted(
            {s for s in range(job.steps) if s % RES_INTERVAL == 0} | {job.steps - 1}),
        "(a) latest_step is the last step's": M["latest"] == job.steps - 1,
        "(a) retention": M["kept"] == sorted(saved)[-RES_KEEP:][::-1],
        "(a) copies on the copy stream": rehearsal or len(M["copy_ms"]) == len(saved),
        "(a) the states equal at the end": all(
            torch.equal(N["scope"].get(n), M["scope"].get(n))
            for n in persistables(job.main, N["scope"])),
    })
    if not rehearsal:
        gates["(a) launches a step"] = all(c == want for c in N["per_step"] + M["per_step"])
    print(f"[resilience] (a) {json.dumps(stats['a'], default=str)}")
    ref = dict(zip(range(job.steps), zip(N["crcs"], N["losses"])))
    del N, M
    gc.collect()
    if not rehearsal:
        torch.cuda.empty_cache()

    # ---- (b) the supervised job: SIGKILL, resume, SIGTERM, finish ---------
    t_b = time.perf_counter()
    wd = work / "job"
    wd.mkdir()
    cmd = [str(ROOT / "chip_smoke.py"), "--resilience-worker", str(wd), "--seed", str(seed)] + (
        ["--cpu-rehearsal"] if rehearsal else [])

    def supervise(run, stop_at=None):
        sup = TrainSupervisor(
            cmd, device="cpu" if rehearsal else "cuda", hang_timeout_s=300.0,
            start_timeout_s=600.0, min_uptime_s=1.0, max_restarts=2, term_grace_s=120.0,
            started_port=7410 + 10 * run, workdir=str(wd / f"sup{run}"),
            log_dir=str(wd / f"logs{run}"), extra_env={"PYTHONPATH": str(ROOT)})
        done = threading.Event()

        def stopper():
            while not done.is_set():
                st = sup.stats()
                if st["attempt"] >= 1 and any(r["step"] is not None and r["step"] >= stop_at
                                              for r in st["ranks"]):
                    sup.request_stop()
                    return
                time.sleep(0.02)

        if stop_at is not None:
            threading.Thread(target=stopper, daemon=True).start()
        t0 = time.perf_counter()
        try:
            rc = sup.run()
        finally:
            done.set()
            sup.close()
        return rc, sup.stats(), time.perf_counter() - t0

    plan = faults.FaultPlan(seed=7).add("fleet.kill_trainer", raises="FaultError",
                                        nth=RES_KILL_AT)
    b_out = {}

    def job_b():
        try:
            with faults.active(plan):
                b_out["first"] = supervise(1, RES_STOP_AT)
            b_out["second"] = supervise(2)
        except BaseException as e:  # noqa: BLE001 — raised after the join
            b_out["error"] = e

    # ---- (c) NanGuard: skip, rollback, recover, beside (b)'s workers -------
    def nan_guard():
        t_c = time.perf_counter()
        root_c = work / "nan"
        mgr = resilience.CheckpointManager(str(root_c), save_interval=NAN_INTERVAL, keep=3)
        guard = resilience.NanGuard(mgr, max_consecutive=NAN_STREAK)
        job_c = resilience_job(seed, rehearsal, guard=guard)
        scope, exe = fluid.Scope(), fluid.Executor(job_c.place)
        exe.run(job_c.startup, scope=scope)
        mgr.attach(job_c.main)
        fetch = [job_c.loss, guard.found_inf_name]
        it = iter(job_c.loader())
        per_step, clean = [], []

        def step_c(feed):
            before = kernels.launch_counts()
            lv, fi = exe.run(job_c.main, feed=feed, fetch_list=fetch, scope=scope)
            per_step.append({k: c - before[k] for k, c in kernels.launch_counts().items()})
            ok = guard.check(values=lv, found_inf=fi, program=job_c.main, scope=scope, executor=exe)
            return ok, float(np.asarray(lv).reshape(-1)[0])

        warm = [step_c(next(it)) for _ in range(2 * NAN_INTERVAL + 1)]
        mgr.drain()
        host = {k: v.cpu().numpy() for k, v in next(it).items()}
        poisoned = dict(host, mask_weight=host["mask_weight"].copy())
        poisoned["mask_weight"][0, 0] = np.nan  # as phase 5c poisons its mask
        c0 = fluid.profiler.counters()
        bad = [step_c(dict(poisoned)) for _ in range(NAN_STREAK)]
        delta = counter_delta(c0)
        last = 2 * NAN_INTERVAL
        snap, _ = resilience.load_snapshot(snapshot.snapshot_dir(str(root_c), last))
        state = persistables(job_c.main, scope)
        rolled = sorted(snap) == sorted(state) and all(
            np.array_equal(to_numpy(t), snap[n]) for n, t in state.items())
        clean = [step_c(dict(host)) for _ in range(2)]
        mgr.close()
        add_launches(per_step)
        stats["c"] = {"warm": warm, "bad": bad, "clean": clean, "counters": delta,
                      "snapshots": mgr.all_steps(), "wall_s": round(time.perf_counter() - t_c, 1)}
        gates.update({
            "(c) warm steps good": all(ok for ok, _ in warm),
            "(c) check False twice": [ok for ok, _ in bad] == [False] * NAN_STREAK,
            "(c) counters": (delta["nan_steps_skipped"], delta["nan_rollbacks"]) == (NAN_STREAK, 1),
            f"(c) rolled back bit-equal to snapshot {last}": rolled,
            "(c) clean steps finite": all(ok and math.isfinite(v) for ok, v in clean),
        })
        if not rehearsal:
            # one batch twice: BERT-base falls ~1.0 a step at lr 1e-4 (phase 5);
            # the rehearsal's tiny model moves less than its dropout's noise
            gates["(c) clean steps falling"] = clean[1][1] < clean[0][1]
            gates["(c) launches a step"] = all(dict(zero, **c) == dict(zero, **job_c.want)
                                               for c in per_step)
        print(f"[resilience] (c) NanGuard: {json.dumps(stats['c'], default=str)}; card {smi}")

    # (c) in this process while (b)'s first worker imports and starts: its
    # steps end before the SIGKILL, so train_mttr_ms does not see them
    runner = threading.Thread(target=job_b, daemon=True)
    runner.start()
    try:
        nan_guard()
    finally:
        runner.join()
    if "error" in b_out:
        raise b_out["error"]
    (rc1, st1, s1), (rc2, st2, s2) = b_out["first"], b_out["second"]
    rows = [json.loads(line) for line in (wd / "steps.jsonl").read_text().splitlines()
            if line.endswith("}")]
    steps_b = [r for r in rows if r["event"] == "step"]
    starts = [r for r in rows if r["event"] == "start"]
    finals = [r for r in rows if r["event"] == "final_save"]
    pids = sorted({r["pid"] for r in rows})

    def alive(pid):
        try:
            os.kill(pid, 0)
            return True
        except OSError:
            return False

    by_step = {}
    for r in steps_b:
        by_step.setdefault(r["step"], set()).add((r["crc"], r["loss"]))
    add_launches([r["launches"] for r in steps_b])
    stats["b"] = {
        "rc": [rc1, rc2], "wall_s": [round(s1, 1), round(s2, 1)],
        "counters": st1["counters"], "restarts": [st1["restarts"], st2["restarts"]],
        "starts": [{k: r[k] for k in ("attempt", "restored", "import_ms", "build_ms",
                                      "restore_ms", "free_mib", "found", "seed_counter")}
                   for r in starts],
        "first_step_ms": [next(r["ms"] for r in steps_b if r["pid"] == st["pid"])
                          for st in starts if any(r["pid"] == st["pid"] for r in steps_b)],
        "final_saves": [r["step"] for r in finals],
        "steps_logged": len(steps_b), "replayed": len(steps_b) - len(by_step),
    }
    gates.update({
        "(b) the first supervisor stopped cleanly after one chaos kill": (
            rc1 == 0 and st1["restarts"] == 1
            and st1["counters"].get("trainer_chaos_kills") == 1),
        "(b) the second finished the job": rc2 == 0 and st2["restarts"] == 0,
        "(b) the SIGKILLed attempt resumed from a snapshot, the last from the final one": (
            len(starts) == 3 and len(finals) == 1 and starts[0]["restored"] == -1
            and starts[1]["restored"] >= 0 and starts[2]["restored"] == finals[0]["step"]),
        "(b) every step logged, each bit-equal to (a)": sorted(by_step) == list(
            range(job.steps)) and all(v == {ref[s]} for s, v in by_step.items()),
        "(b) no worker survives": len(pids) == 3 and not any(alive(p) for p in pids),
    })
    if not rehearsal:
        gates["(b) launches a step in every attempt"] = all(
            dict(zero, **r["launches"]) == want for r in steps_b)
    print(f"[resilience] (b) supervised job: {json.dumps(stats['b'], default=str)}; "
          f"{time.perf_counter() - t_b:.1f} s; card {smi}")

    shutil.rmtree(work, ignore_errors=True)
    stats["gates"] = gates
    failed = [g for g, ok in gates.items() if not ok]
    print(f"[resilience] gates: {gates}")
    require(not failed, f"[resilience] gates failed: {failed}")
    stats["wall_s"] = round(time.perf_counter() - t_phase, 1)
    print(f"[time] phase 20 took {stats['wall_s']} s; launches over the resilience path: "
          f"{path_launches}")
    return path_launches, stats


MESH_STEPS = 10  # BERT-base steps an arm in phase 21 (the p50 over the last 9)


def mesh_phase(seed, rehearsal, smi):
    """Phase 21: CompiledProgram and the mesh on the card -> (launch counts
    of the mesh path, the phase's result dict). (a) BERT-base as phase 5
    trains it, MESH_STEPS steps from one state in four arms: Executor.run;
    CompiledProgram.with_data_parallel without a process group; the same
    under a one-rank NCCL process group (a file:// store), whose
    DeviceMesh("cuda", 1x1x1) runs the grad all-reduce and the fetch
    mean; and that with zero1=True. Every fetch and persistable bit-equal
    across the arms, kernels #1, #7 and #8 launched a step on the mesh
    arms, and read from torch.profiler beside the step's all-reduces
    through the group. (b) a snapshot under the mesh, restored with restore(mesh=...)
    into a fresh scope: bit-equal, and the next step too. (c) one-rank
    dygraph DataParallel under NCCL: grads bit-equal to the run without
    it. Under deterministic algorithms (warn_only), as phase 20."""
    import torch

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(not rehearsal or deterministic, warn_only=True)
    try:
        return _mesh_phase(seed, rehearsal, smi)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _mesh_phase(seed, rehearsal, smi):
    import numpy as np
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph as D
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.resilience import snapshot
    from paddle_tpu_torch.scope import full_value

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    b, s, p = (2, 32, 5) if rehearsal else (8, 128, 20)
    cfg = BertConfig.tiny() if rehearsal else BertConfig.base()
    main_p, startup_p = fluid.Program(), fluid.Program()
    main_p.random_seed = startup_p.random_seed = seed + 2
    with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
        loss = build_bert_pretrain(cfg, b, s, mlm_only=True, max_preds=p)["loss"]
        fluid.optimizer.Adam(LR).minimize(loss)
    rs = np.random.RandomState(seed)
    feeds = [bert_pretrain_feed(np, rs, cfg, b, s, p) for _ in range(MESH_STEPS + 1)]
    exe0, scope0 = fluid.Executor(place), fluid.Scope()
    exe0.run(startup_p, scope=scope0)
    names = sorted(v.name for v in main_p.list_vars() if v.persistable and scope0.has(v.name))
    state0 = {n: scope0.get(n).detach().clone() for n in names}
    counter0 = exe0._seed_counter
    del scope0, exe0
    zero = {n: 0 for n in kernels.LAUNCHES}
    want = dict(zero, mha_short_fwd=cfg.num_layers, mha_short_bwd=cfg.num_layers,
                layer_norm_bwd=2 * cfg.num_layers + 2)
    stats = {"card": smi, "cell": f"BERT-base fp32 b {b} s {s} max_preds {p}, Adam({LR}), "
             f"dropout {cfg.hidden_dropout}"}
    gates = {}

    def arm(prog):
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe._seed_counter = counter0  # the startup's run, as in every arm
        for n, t in state0.items():
            scope.set(n, t.clone())
        return dict(exe=exe, scope=scope, prog=prog, fetched=[], ms=[], per_step=[])

    def step(a, f):
        before = kernels.launch_counts()
        sync()
        t0 = time.perf_counter()
        (lv,) = a["exe"].run(a["prog"], feed=dict(f), fetch_list=[loss], scope=a["scope"],
                             return_numpy=False)
        sync()
        a["ms"].append((time.perf_counter() - t0) * 1e3)
        a["fetched"].append(lv.detach().clone())
        a["per_step"].append({k: c - before[k] for k, c in kernels.launch_counts().items()})

    def bitwise(a, ref):
        return (all(torch.equal(x, y) for x, y in zip(a["fetched"], ref["fetched"]))
                and all(torch.equal(full_value(a["scope"].get(n)), ref["scope"].get(n))
                        for n in names))

    # ---- (a) four arms from one state, their steps interleaved -----------------
    t_a = time.perf_counter()
    unit = fluid.CompiledProgram(main_p).with_data_parallel(loss_name=loss.name)
    unit._get_mesh()  # the 1x1x1 mesh without a process group
    backend = "gloo" if rehearsal else "nccl"
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=f"file://{work / 'store'}", world_size=1,
                            rank=0)
    try:
        nccl = fluid.CompiledProgram(main_p).with_data_parallel(loss_name=loss.name)
        zero1 = fluid.CompiledProgram(main_p).with_data_parallel(loss_name=loss.name,
                                                                  zero1=True)
        mesh = nccl._get_mesh()
        zero1._get_mesh()
        stats["group_init_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        labels = {"plain": "Executor.run", "mesh": "CompiledProgram, no process group",
                  "nccl": f"CompiledProgram under a one-rank {backend} group",
                  "zero1": f"CompiledProgram(zero1=True) under the {backend} group"}
        arms = {"plain": arm(main_p), "mesh": arm(unit), "nccl": arm(nccl), "zero1": arm(zero1)}
        kernels.reset_launch_counts()  # the mesh path's run: the three mesh arms' steps
        for f in feeds[:MESH_STEPS]:
            for a in arms.values():
                step(a, f)
        path_launches = {k: sum(d[k] for tag in ("mesh", "nccl", "zero1")
                                for d in arms[tag]["per_step"]) for k in zero}
        for tag, a in arms.items():
            a["p50"] = statistics.median(a["ms"][1:])
            print(f"[mesh] (a) {labels[tag]}: losses "
                  f"{[float(x.reshape(-1)[0]) for x in a['fetched']]}; step p50 "
                  f"{a['p50']:.2f} ms over steps 2-{MESH_STEPS} (first {a['ms'][0]:.2f} ms, "
                  f"the passes' run); card {smi}")
        gates["(a) the no-group arm's mesh is 1x1x1 without a DeviceMesh"] = (
            unit._get_mesh().device_mesh is None
            and dict(unit._get_mesh().shape) == {"batch": 1, "model": 1, "pipe": 1})
        gates[f"(a) the group's mesh is a DeviceMesh on {place}"] = (
            mesh.device_mesh is not None and mesh.device_type == ("cpu" if rehearsal else "cuda")
            and zero1._get_mesh().device_mesh is mesh.device_mesh)
        for tag in ("mesh", "nccl", "zero1"):
            gates[f"(a) {tag}: every fetch and persistable bit-equal to Executor.run"] = bitwise(
                arms[tag], arms["plain"])
        if not rehearsal:
            gates["(a) #1, #7 and #8 launched every step of every arm"] = all(
                c == want for a in arms.values() for c in a["per_step"])
            gates["(a) the mesh path launched its kernels"] = all(
                path_launches[k] > 0 for k in ("mha_short_fwd", "mha_short_bwd",
                                               "layer_norm_bwd"))
        stats["a"] = {tag: dict(p50_ms=round(a["p50"], 3), ms=[round(x, 3) for x in a["ms"]])
                      for tag, a in arms.items()}
        stats["a"]["group_overhead_ms"] = round(arms["nccl"]["p50"] - arms["mesh"]["p50"], 3)
        stats["a"]["mesh_over_plain"] = round(arms["nccl"]["p50"] / arms["plain"]["p50"], 4)
        print(f"[mesh] (a) step p50: Executor.run {arms['plain']['p50']:.2f} ms, "
              f"CompiledProgram {arms['mesh']['p50']:.2f} ms, under the one-rank group "
              f"{arms['nccl']['p50']:.2f} ms (the group's collectives "
              f"{stats['a']['group_overhead_ms']:+.2f} ms), zero1 {arms['zero1']['p50']:.2f} ms; "
              f"group init {stats['group_init_ms']} ms; {time.perf_counter() - t_a:.1f} s; "
              f"card {smi}")

        # ---- (b) a snapshot under the mesh, restored onto it ----------------
        z = arms["zero1"]
        mgr = resilience.CheckpointManager(str(work / "ckpt"), keep=1)
        t0 = time.perf_counter()
        mgr.save(MESH_STEPS, program=main_p, scope=z["scope"], executor=z["exe"])
        mgr.drain()
        save_ms = (time.perf_counter() - t0) * 1e3
        manifest = snapshot.read_manifest(snapshot.list_snapshots(str(work / "ckpt"))[0][1])
        exe_r, fresh = fluid.Executor(place), fluid.Scope()
        t0 = time.perf_counter()
        got = mgr.restore(program=main_p, scope=fresh, executor=exe_r, mesh=mesh)
        sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        mgr.close()
        gates["(b) restore(mesh=...) bit-equal, the seed counter too"] = (
            got == MESH_STEPS and exe_r._seed_counter == z["exe"]._seed_counter
            and all(torch.equal(full_value(fresh.get(n)), full_value(z["scope"].get(n)))
                    for n in names))
        gates["(b) the manifest records the mesh"] = manifest.get("mesh") == dict(mesh.shape)
        nxt = [e.run(zero1, feed=dict(feeds[MESH_STEPS]), fetch_list=[loss], scope=sc,
                     return_numpy=False)[0] for e, sc in ((z["exe"], z["scope"]), (exe_r, fresh))]
        gates["(b) the next step bit-equal from the restored scope"] = torch.equal(*nxt)
        stats["b"] = dict(save_ms=round(save_ms, 1), restore_ms=round(restore_ms, 1),
                          mesh=manifest.get("mesh"), vars=len(manifest["vars"]))
        print(f"[mesh] (b) snapshot of {len(manifest['vars'])} vars under mesh "
              f"{manifest.get('mesh')}: save + drain {save_ms:.1f} ms, restore(mesh=...) "
              f"{restore_ms:.1f} ms; card {smi}")

        # one mesh step under the group: its collectives as torch.profiler's
        # host events (a one-rank NCCL all-reduce launches no device kernel),
        # and its device kernels
        from torch.profiler import ProfilerActivity, profile

        n_arm = arms["nccl"]

        def mesh_step():
            n_arm["exe"].run(nccl, feed=dict(feeds[0]), fetch_list=[loss],
                             scope=n_arm["scope"], return_numpy=False)

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            mesh_step()
            sync()
        collectives = {e.key: e.count for e in prof.key_averages()
                       if "all_reduce" in e.key or "allreduce" in e.key}
        gates[f"(a) the step's all-reduces ran through the {backend} group"] = any(
            backend in k.lower() for k in collectives)
        stats["collectives"] = collectives
        print(f"[mesh] one mesh step's collectives (torch.profiler host events): "
              f"{collectives}")
        if not rehearsal:
            per_call, sessions = kernels.device_kernels(mesh_step, calls=1)
            ours = {k: sum(c for n, c in per_call.items() if k in n)
                    for k in ("mha_short_fwd_kernel", "short_bwd_dkv_kernel",
                              "short_bwd_dq_kernel", "layer_norm_bwd_")}
            gates["(a) #1, #7 (both launches) and #8 on the device in a mesh step"] = all(
                c > 0 for c in ours.values())
            stats["device_kernels"] = dict(ours=ours, sessions=sessions)
            print(f"[mesh] one mesh step's kernels (torch.profiler, {sessions} sessions): "
                  f"{ours}")
        del arms, z, fresh, nxt

        # ---- (c) one-rank dygraph DataParallel under the group ----------------
        drs = np.random.RandomState(seed + 21)
        width, rows = (16, 8) if rehearsal else (cfg.hidden_size, b * s)
        x = drs.randn(rows, width).astype("float32")
        y = drs.randn(rows, width).astype("float32")
        grads = []
        class MLP(D.Layer):
            def __init__(self):
                super().__init__("mesh_mlp")
                self.fc1 = D.Linear(width, 4 * width, act="relu")
                self.fc2 = D.Linear(4 * width, width)

            def forward(self, v):
                return self.fc2(self.fc1(v))

        with D.guard(place):
            env = D.prepare_context()
            model = MLP()
            start = {k: v.copy() for k, v in model.state_dict().items()}
            for wrap in (False, True):
                model.set_dict(start)
                net = D.DataParallel(model) if wrap else model
                out = net(D.to_variable(x))
                dloss = ((out - D.to_variable(y)) ** 2).mean()
                (net.scale_loss(dloss) if wrap else dloss).backward()
                sync()
                t0 = time.perf_counter()
                if wrap:
                    net.apply_collective_grads()
                sync()
                ar_ms = (time.perf_counter() - t0) * 1e3
                grads.append({n: q.gradient() for n, q in model.named_parameters()})
                model.clear_gradients()
        gates["(c) DataParallel's grads bit-equal to the run without it"] = (
            env.nranks == 1 and all(np.array_equal(grads[0][n], grads[1][n]) for n in grads[0]))
        stats["c"] = dict(params=len(grads[0]), allreduce_ms=round(ar_ms, 3),
                          shape=[rows, width])
        print(f"[mesh] (c) dygraph DataParallel, MLP {width} -> {4 * width} -> {width} on "
              f"{rows} rows: grads bit-equal; apply_collective_grads {ar_ms:.2f} ms; card {smi}")
    finally:
        dist.destroy_process_group()
        mesh_mod.set_current_mesh(None)
    shutil.rmtree(work, ignore_errors=True)
    stats["gates"] = gates
    failed = [g for g, ok in gates.items() if not ok]
    print(f"[mesh] gates: {gates}")
    require(not failed, f"[mesh] gates failed: {failed}")
    stats["wall_s"] = round(time.perf_counter() - t_phase, 1)
    print(f"[time] phase 21 took {stats['wall_s']} s; launches over the mesh path: "
          f"{path_launches}")
    return path_launches, stats


COLLECTIVE_STEPS = 10  # BERT-base steps an arm in phase 23 (the p50 over the last 9)
COLLECTIVE_WORLDS = (8, 16, 32)  # phase 23 (d): the planner's H100 worlds
TP_STEPS = 3  # phase 23 (e): tp=2 steps on two processes sharing the card


def collective_phase(seed, rehearsal, smi):
    """Phase 23: fleet collective and placement on the card -> (launch
    counts of the collective path, the phase's result dict). On phase 5's
    BERT-base cell (fp32, b 8, s 128, dropout 0.1, Adam), COLLECTIVE_STEPS
    steps from one state, the arms' steps interleaved, under a one-rank
    NCCL process group (a file:// store, as phase 21): (a) the fleet path:
    PaddleCloudRoleMaker over a one-trainer PADDLE_* env, fleet.init,
    fleet.distributed_optimizer(Adam, DistributedStrategy()).minimize, then
    plain Executor.run calls, which go through the strategy's mesh; (b) the
    same with strategy.zero1 and PADDLE_TPU_AUTOSHARD=1 (the
    shard_propagation pass in the pass set: another pass-cache signature);
    (c) CompiledProgram over a DistributedStrategy(tp=1) mesh, built by the
    model-axis code. Every loss, persistable and the seed counter bit-equal
    to the plain walk; #1, #7 and #8 launched 12, 12 and 26 times a step,
    and on the device in a profiled step. (d) the planner, device-free: the
    Program planned for H100 nodes at COLLECTIVE_WORLDS devices in a
    subprocess that creates no CUDA context, its plan table read back by
    TrainSupervisor(plan_table=). (e) tp=2 on two processes sharing the
    card over a gloo group (tp_worker), after (a)-(c): the losses and the
    gathered persistables within 5b's card-vs-CPU gates of the one-device
    walk, the replicated state bit-identical across the ranks, #1, #7 and
    #8 launched 12, 12 and 26 times a step on each rank. Under
    deterministic algorithms (warn_only), as phase 21."""
    import torch

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(not rehearsal or deterministic, warn_only=True)
    try:
        return _collective_phase(seed, rehearsal, smi)
    finally:
        torch.use_deterministic_algorithms(deterministic)


# phase 23 (d)'s planner process: plans the BERT-base Program (or BERT-tiny
# in a rehearsal) for H100 nodes at each world, writes the plan table, and
# reports whether torch.cuda was ever initialized
_PLANNER_CODE = """
import json, sys, time
import torch
from paddle_tpu_torch.autoshard import Topology
from paddle_tpu_torch.autoshard.__main__ import build_program, plan_table
name, out, worlds = sys.argv[1], sys.argv[2], [int(w) for w in sys.argv[3].split(",")]
t0 = time.perf_counter()
program, feeds = build_program(name)
t1 = time.perf_counter()
table = plan_table(program, feeds, Topology(chips=max(worlds)), worlds, name)
t2 = time.perf_counter()
with open(out, "w") as f:
    json.dump(table, f, indent=2)
print(json.dumps({"build_s": round(t1 - t0, 3), "plan_s": round(t2 - t1, 3),
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def collective_cell(rehearsal):
    """Phase 23's cell: (BertConfig, b, s, max_preds) of phase 5's BERT-base
    (BERT-tiny in a rehearsal)."""
    from paddle_tpu_torch.models.bert import BertConfig

    b, s, p = (2, 32, 5) if rehearsal else (8, 128, 20)
    return (BertConfig.tiny() if rehearsal else BertConfig.base()), b, s, p


def collective_program(fluid, cfg, b, s, p, seed, minimize_with=None):
    """Phase 5's Program (main, startup, loss); `minimize_with` wraps the
    Adam optimizer (fleet.distributed_optimizer with a strategy)."""
    from paddle_tpu_torch.models.bert import build_bert_pretrain

    main_p, startup_p = fluid.Program(), fluid.Program()
    main_p.random_seed = startup_p.random_seed = seed + 2
    with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
        loss = build_bert_pretrain(cfg, b, s, mlm_only=True, max_preds=p)["loss"]
        opt = fluid.optimizer.Adam(LR)
        if minimize_with is not None:
            opt = minimize_with(opt)
        opt.minimize(loss)
    return main_p, startup_p, loss


def tp_worker(work, rank, seed, rehearsal):
    """Phase 23 (e)'s rank `rank` of 2 (`chip_smoke.py --tp-worker DIR
    RANK`), one of two processes sharing the card: joins a gloo group of 2
    (a file:// store in DIR), waits for DIR/tp_go, runs phase 5's startup
    on the card, then TP_STEPS steps of the cell through CompiledProgram
    over a batch 1 x model 2 mesh (a DeviceMesh("cuda") over the gloo
    group: the collectives take CUDA tensors), the whole batch fed to both
    ranks. Gathers every persistable, hashes the replicated ones, and on
    rank 0 runs the one-device walk from the same startup state. Writes
    DIR/tp_r{RANK}.json."""
    import datetime
    import faulthandler
    import hashlib

    faulthandler.enable()  # a crash in a collective leaves its stack in the rank's log
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)

    def say(what):
        print(f"[tp rank {rank}] {time.perf_counter() - t_enter:.1f} s: {what}", flush=True)

    t_enter = time.perf_counter()
    import numpy as np
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.scope import full_value

    work = Path(work)
    cfg, b, s, p = collective_cell(rehearsal)
    main_p, startup_p, loss = collective_program(fluid, cfg, b, s, p, seed)
    rs = np.random.RandomState(seed)
    feeds = [bert_pretrain_feed(np, rs, cfg, b, s, p) for _ in range(TP_STEPS)]
    dist.init_process_group("gloo", init_method=f"file://{work / 'tp_store'}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    say("the gloo group is up; waiting for the go file")
    t_wait = time.perf_counter()
    while not (work / "tp_go").exists():
        require(time.perf_counter() - t_wait < 600, "[tp worker] no go file in 600 s")
        time.sleep(0.05)
    place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)
    if not rehearsal:
        torch.cuda.set_device(0)

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup_p, scope=scope)
    say("startup ran")
    names = sorted(v.name for v in main_p.list_vars() if v.persistable and scope.has(v.name))
    state0 = {n: scope.get(n).detach().clone() for n in names} if rank == 0 else None
    counter0 = exe._seed_counter
    mesh = mesh_mod.build_mesh(batch=1, model=2, device_type="cpu" if rehearsal else "cuda")
    compiled = fluid.CompiledProgram(main_p).with_data_parallel(loss_name=loss.name)
    compiled._mesh = mesh
    say(f"mesh {dict(mesh.shape)} on {mesh.device_type}")

    def run(exe_, prog, scope_):
        losses, ms, per_step = [], [], []
        for f in feeds:
            before = kernels.launch_counts()
            sync()
            t0 = time.perf_counter()
            (lv,) = exe_.run(prog, feed=dict(f), fetch_list=[loss], scope=scope_,
                             return_numpy=False)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(lv.detach().clone())
            per_step.append({k: c - before[k] for k, c in kernels.launch_counts().items()})
            say(f"step {len(ms)}: {ms[-1]:.1f} ms")
        return losses, ms, per_step

    kernels.reset_launch_counts()  # (e)'s run: the tp steps of this rank
    losses, ms, per_step = run(exe, compiled, scope)
    launches = kernels.launch_counts()
    values = {n: scope.get(n) for n in names}
    sharded = {n: [repr(pl) for pl in v.placements] + [list(v.to_local().shape)]
               for n, v in values.items() if hasattr(v, "placements")}
    # the replicated state's bytes, hashed: bit-identical across the group
    hashes = {n: hashlib.sha256(v.detach().reshape(-1).cpu().view(torch.uint8).numpy()
                                ).hexdigest()
              for n, v in values.items() if n not in sharded}
    gathered = {n: full_value(v) for n, v in values.items()}  # collectives for the shards
    dist.barrier()
    say("the state gathered")
    report = dict(rank=rank, mesh=dict(mesh.shape), model_rank=mesh.local_rank("model"),
                  device_type=mesh.device_type,
                  losses=[float(x.reshape(-1)[0]) for x in losses], ms=ms, per_step=per_step,
                  launches=launches, sharded=sharded, hashes=hashes,
                  seed_counter=exe._seed_counter,
                  placed_on=str(next(iter(gathered.values())).device))
    dist.destroy_process_group()
    if rank == 0:
        # the one-device walk from the same startup state
        exe0, scope0 = fluid.Executor(place), fluid.Scope()
        exe0._seed_counter = counter0
        for n, t in state0.items():
            scope0.set(n, t)
        plain, plain_ms, _ = run(exe0, main_p, scope0)
        worst, worst_name, close, total = 0.0, None, 0, 0
        for n in names:
            d = (gathered[n].float() - scope0.get(n).float()).abs()
            require(gathered[n].shape == scope0.get(n).shape, f"[tp worker] {n}: shape")
            if float(d.max()) > worst:
                worst, worst_name = float(d.max()), n
            close += int((d <= CLOSE_ATOL).sum())
            total += d.numel()
        report.update(plain_losses=[float(x.reshape(-1)[0]) for x in plain], plain_ms=plain_ms,
                      loss_rel=max(float((x - y).abs().max() / y.abs().max())
                                   for x, y in zip(losses, plain)),
                      worst_abs=worst, worst_name=worst_name,
                      far_frac=1 - close / total, plain_seed_counter=exe0._seed_counter)
    (work / f"tp_r{rank}.json").write_text(json.dumps(report))
    return 0


def _collective_phase(seed, rehearsal, smi):
    import numpy as np
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import passes
    from paddle_tpu_torch.incubate.fleet.base.role_maker import PaddleCloudRoleMaker
    from paddle_tpu_torch.incubate.fleet.collective import DistributedStrategy, fleet
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel.api import DistributedStrategy as MeshStrategy
    from paddle_tpu_torch.resilience.trainer_fleet import TrainSupervisor
    from paddle_tpu_torch.scope import full_value

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "collective"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    # (d) starts first: its process imports torch and the port while the
    # arms run here
    table_path = work / "plans.json"
    planner = subprocess.Popen(
        [sys.executable, "-c", _PLANNER_CODE, "bert" if rehearsal else "bert-base",
         str(table_path), ",".join(map(str, COLLECTIVE_WORLDS))],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    # (e)'s two ranks start too: they import, build the Program and join
    # their gloo group, then wait for the go file, written after (a)-(c)
    tp_procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-worker", str(work), str(r),
         "--seed", str(seed)] + (["--cpu-rehearsal"] if rehearsal else []),
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=open(work / f"tp_r{r}.log", "w"), stderr=subprocess.STDOUT) for r in range(2)]
    cfg, b, s, p = collective_cell(rehearsal)

    def program(strategy=None):
        """Phase 5's Program; minimized through the fleet with `strategy`."""
        return collective_program(
            fluid, cfg, b, s, p, seed,
            None if strategy is None else lambda opt: fleet.distributed_optimizer(opt, strategy))

    main_p, startup_p, loss = program()
    rs = np.random.RandomState(seed)
    feeds = [bert_pretrain_feed(np, rs, cfg, b, s, p) for _ in range(COLLECTIVE_STEPS)]
    exe0, scope0 = fluid.Executor(place), fluid.Scope()
    exe0.run(startup_p, scope=scope0)
    names = sorted(v.name for v in main_p.list_vars() if v.persistable and scope0.has(v.name))
    state0 = {n: scope0.get(n).detach().clone() for n in names}
    counter0 = exe0._seed_counter
    del scope0, exe0
    zero = {n: 0 for n in kernels.LAUNCHES}
    want = dict(zero, mha_short_fwd=cfg.num_layers, mha_short_bwd=cfg.num_layers,
                layer_norm_bwd=2 * cfg.num_layers + 2)
    stats = {"card": smi, "cell": f"BERT-base fp32 b {b} s {s} max_preds {p}, Adam({LR}), "
             f"dropout {cfg.hidden_dropout}"}
    gates = {}
    env_keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ENDPOINTS",
                "TRAINING_ROLE", "PADDLE_TPU_AUTOSHARD")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    backend = "gloo" if rehearsal else "nccl"
    try:
        os.environ.update(PADDLE_TRAINER_ID="0", PADDLE_TRAINERS_NUM="1",
                          PADDLE_TRAINER_ENDPOINTS="127.0.0.1:6170", TRAINING_ROLE="TRAINER")
        os.environ.pop("PADDLE_TPU_AUTOSHARD", None)
        role = PaddleCloudRoleMaker()
        fleet.init(role)
        gates["(a) the role maker reads the one-trainer env"] = (
            role.worker_num() == 1 and role.worker_index() == 0 and fleet.is_first_worker())
        strat_a = DistributedStrategy()
        strat_b = DistributedStrategy()
        strat_b.zero1 = True
        prog_a = program(strat_a)[0]
        prog_b = program(strat_b)[0]
        gates["(a) minimize recorded the strategy"] = (prog_a._fleet_strategy is strat_a
                                                       and prog_b._fleet_strategy is strat_b)
        t0 = time.perf_counter()
        dist.init_process_group(backend, init_method=f"file://{work / 'store'}", world_size=1,
                                rank=0)
        stats["group_init_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        tp1 = MeshStrategy()
        tp1.tp = 1
        prog_c = fluid.CompiledProgram(main_p).with_data_parallel(loss_name=loss.name)
        prog_c._mesh = tp1.build_mesh()

        def arm(prog, autoshard=False):
            exe, scope = fluid.Executor(place), fluid.Scope()
            exe._seed_counter = counter0
            for n, t in state0.items():
                scope.set(n, t.clone())
            return dict(exe=exe, scope=scope, prog=prog, autoshard=autoshard, fetched=[],
                        ms=[], per_step=[])

        def step(a, f):
            if a["autoshard"]:
                os.environ["PADDLE_TPU_AUTOSHARD"] = "1"
            try:
                before = kernels.launch_counts()
                sync()
                t0 = time.perf_counter()
                (lv,) = a["exe"].run(a["prog"], feed=dict(f), fetch_list=[loss],
                                     scope=a["scope"], return_numpy=False)
                sync()
                a["ms"].append((time.perf_counter() - t0) * 1e3)
            finally:
                os.environ.pop("PADDLE_TPU_AUTOSHARD", None)
            a["fetched"].append(lv.detach().clone())
            a["per_step"].append({k: c - before[k] for k, c in kernels.launch_counts().items()})

        labels = {"plain": "Executor.run", "a": "the fleet path",
                  "b": "the fleet path, zero1 and PADDLE_TPU_AUTOSHARD=1",
                  "c": "CompiledProgram over DistributedStrategy(tp=1)"}
        arms = {"plain": arm(main_p), "a": arm(prog_a), "b": arm(prog_b, autoshard=True),
                "c": arm(prog_c)}
        kernels.reset_launch_counts()  # the collective path's run: arms (a)-(c)
        for f in feeds:
            for a in arms.values():
                step(a, f)
        path_launches = {k: sum(d[k] for tag in ("a", "b", "c") for d in arms[tag]["per_step"])
                         for k in zero}
        for tag, a in arms.items():
            a["p50"] = statistics.median(a["ms"][1:])
            print(f"[collective] {labels[tag]}: losses "
                  f"{[float(x.reshape(-1)[0]) for x in a['fetched']]}; step p50 "
                  f"{a['p50']:.2f} ms over steps 2-{COLLECTIVE_STEPS} (first {a['ms'][0]:.2f} "
                  f"ms, the passes' run); card {smi}")
        fleet_cp = prog_a.__dict__.get("_fleet_compiled", (None,))[-1]
        gates["(a) Executor.run went through the fleet's CompiledProgram over a DeviceMesh"] = (
            fleet_cp is not None and fleet_cp._get_mesh().device_mesh is not None
            and dict(fleet_cp._get_mesh().shape) == {"batch": 1, "model": 1, "pipe": 1})
        gates["(c) the tp=1 mesh is 1x1x1 over the group"] = (
            prog_c._get_mesh().device_mesh is not None
            and dict(prog_c._get_mesh().shape) == {"batch": 1, "model": 1, "pipe": 1})
        ref = arms["plain"]
        for tag in ("a", "b", "c"):
            a = arms[tag]
            gates[f"({tag}) every loss, persistable and the seed counter bit-equal to "
                  f"Executor.run"] = (
                all(torch.equal(x, y) for x, y in zip(a["fetched"], ref["fetched"]))
                and all(torch.equal(full_value(a["scope"].get(n)), ref["scope"].get(n))
                        for n in names)
                and a["exe"]._seed_counter == ref["exe"]._seed_counter)
        os.environ["PADDLE_TPU_AUTOSHARD"] = "1"
        sig_b = passes.cache_signature(strat_b.build_strategy)
        os.environ.pop("PADDLE_TPU_AUTOSHARD")
        sig_a = passes.cache_signature(strat_a.build_strategy)
        gates["(b) the pass-cache signature differs from (a)'s"] = (
            sig_a != sig_b and "shard_propagation" in sig_b)
        stats["signatures"] = {"a": sig_a, "b": sig_b}
        if not rehearsal:
            gates["(a)-(c) #1, #7 and #8 launched 12, 12 and 26 times every step"] = all(
                c == want for tag in ("a", "b", "c") for c in arms[tag]["per_step"])
        stats["arms"] = {tag: dict(p50_ms=round(a["p50"], 3), ms=[round(x, 3) for x in a["ms"]])
                         for tag, a in arms.items()}
        print(f"[collective] step p50: Executor.run {arms['plain']['p50']:.2f} ms, the fleet "
              f"path {arms['a']['p50']:.2f} ms, zero1 + autoshard {arms['b']['p50']:.2f} ms, "
              f"tp=1 mesh {arms['c']['p50']:.2f} ms; card {smi}")

        # a profiled fleet step: its device kernels and its collectives
        a = arms["a"]

        def fleet_step():
            a["exe"].run(prog_a, feed=dict(feeds[0]), fetch_list=[loss], scope=a["scope"],
                         return_numpy=False)

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fleet_step()
            sync()
        collectives = {e.key: e.count for e in prof.key_averages()
                       if "all_reduce" in e.key or "allreduce" in e.key}
        gates[f"(a) the fleet step's all-reduces ran through the {backend} group"] = any(
            backend in k.lower() for k in collectives)
        stats["collectives"] = collectives
        print(f"[collective] one fleet step's collectives (torch.profiler host events): "
              f"{collectives}")
        if not rehearsal:
            per_call, sessions = kernels.device_kernels(fleet_step, calls=1)
            ours = {k: sum(c for n, c in per_call.items() if k in n)
                    for k in ("mha_short_fwd_kernel", "short_bwd_dkv_kernel",
                              "short_bwd_dq_kernel", "layer_norm_bwd_")}
            gates["(a) a profiled fleet step: 12 #1, 12 of each of #7's launches, 26 #8"] = (
                ours == {"mha_short_fwd_kernel": cfg.num_layers,
                         "short_bwd_dkv_kernel": cfg.num_layers,
                         "short_bwd_dq_kernel": cfg.num_layers,
                         "layer_norm_bwd_": 2 * cfg.num_layers + 2})
            stats["device_kernels"] = dict(ours=ours, sessions=sessions)
            print(f"[collective] one fleet step's kernels (torch.profiler, {sessions} "
                  f"sessions): {ours}")
        del arms, a
        if not rehearsal:
            torch.cuda.empty_cache()
        (work / "tp_go").write_text("go")
        t_tp = time.perf_counter()
        for proc in tp_procs:
            proc.wait(timeout=600)
        stats["tp_wall_s"] = round(time.perf_counter() - t_tp, 1)
    finally:
        for proc in tp_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh_mod.set_current_mesh(None)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # ---- (e) tp=2: two processes sharing the card over a gloo group ----
    logs = [(work / f"tp_r{r}.log").read_text() for r in range(2)]
    require(all(proc.returncode == 0 for proc in tp_procs),
            "[collective] (e) a tp rank failed: "
            + " | ".join(f"rank {r} exit {proc.returncode}: {logs[r][-3000:]}"
                         for r, proc in enumerate(tp_procs)))
    tp = [json.loads((work / f"tp_r{r}.json").read_text()) for r in range(2)]
    r0 = tp[0]
    want_tp = dict(zero, mha_short_fwd=cfg.num_layers, mha_short_bwd=cfg.num_layers,
                   layer_norm_bwd=2 * cfg.num_layers + 2)
    gates["(e) a batch 1 x model 2 mesh, rank r at model coordinate r, the state on the "
          "card"] = all(
        t["mesh"] == {"batch": 1, "model": 2, "pipe": 1} and t["model_rank"] == t["rank"]
        and (rehearsal or (t["device_type"] == "cuda" and t["placed_on"].startswith("cuda")))
        for t in tp)
    gates["(e) the Megatron weights and their moments are Shard(d) on model, the same on "
          "both ranks"] = (len(r0["sharded"]) >= 6 * cfg.num_layers
                           and sorted(r0["sharded"]) == sorted(tp[1]["sharded"]))
    gates["(e) the replicated state bit-identical across the model group"] = (
        len(r0["hashes"]) > 0 and r0["hashes"] == tp[1]["hashes"])
    gates["(e) both ranks fetched the same losses"] = r0["losses"] == tp[1]["losses"]
    gates[f"(e) the losses within {LOSS_RTOL} of the one-device walk, every persistable "
          f"within {2 * LR * TP_STEPS}, all but {CLOSE_FRAC} of the elements within "
          f"{CLOSE_ATOL}"] = (r0["loss_rel"] <= LOSS_RTOL and r0["worst_abs"] <= 2 * LR * TP_STEPS
                              and r0["far_frac"] <= CLOSE_FRAC)
    gates["(e) the seed counter as the one-device walk's"] = (
        r0["seed_counter"] == r0["plain_seed_counter"] == tp[1]["seed_counter"])
    if not rehearsal:
        gates["(e) #1, #7 and #8 launched 12, 12 and 26 times every step on each rank"] = all(
            c == want_tp for t in tp for c in t["per_step"])
    for k in zero:
        path_launches[k] += sum(t["launches"][k] for t in tp)
    tp_p50 = [statistics.median(t["ms"][1:]) for t in tp]
    plain_p50 = statistics.median(r0["plain_ms"][1:])
    stats["e"] = dict(losses=r0["losses"], plain_losses=r0["plain_losses"],
                      loss_rel=r0["loss_rel"], worst_abs=r0["worst_abs"],
                      worst_name=r0["worst_name"], far_frac=r0["far_frac"],
                      sharded_vars=len(r0["sharded"]), replicated_vars=len(r0["hashes"]),
                      launches=[t["launches"] for t in tp],
                      ms=[[round(x, 3) for x in t["ms"]] for t in tp],
                      plain_ms=[round(x, 3) for x in r0["plain_ms"]],
                      p50_ms=[round(x, 3) for x in tp_p50], plain_p50_ms=round(plain_p50, 3))
    print(f"[collective] (e) tp=2 on two processes sharing the card over gloo ({TP_STEPS} "
          f"steps): losses {r0['losses']} against the one-device walk's {r0['plain_losses']} "
          f"(max rel {r0['loss_rel']:.3e}); persistables max abs diff {r0['worst_abs']:.3e} "
          f"({r0['worst_name']}), {r0['far_frac']:.3e} of the elements beyond {CLOSE_ATOL}; "
          f"{len(r0['sharded'])} state vars sharded on model, {len(r0['hashes'])} replicated "
          f"and bit-identical on both ranks; launches {[t['launches'] for t in tp]}")
    print(f"[collective] (e) step p50 over steps 2-{TP_STEPS}: rank 0 {tp_p50[0]:.2f} ms, rank "
          f"1 {tp_p50[1]:.2f} ms (both ranks on one card, the collectives staged through the "
          f"host by gloo); the one-device walk {plain_p50:.2f} ms; {stats['tp_wall_s']} s from "
          f"go to both exits; card {smi}")

    # ---- (d) the planner, device-free, and the supervisor reading its table ----
    try:
        out, err = planner.communicate(timeout=300)
    finally:
        if planner.poll() is None:
            planner.kill()
            planner.wait()
    require(planner.returncode == 0, f"[collective] (d) the planner failed: {err[-3000:]}")
    report = json.loads(out.strip().splitlines()[-1])
    table = json.loads(table_path.read_text())
    gates["(d) the planner created no CUDA context"] = report["cuda_initialized"] is False
    plans = {int(w): pl for w, pl in table["plans"].items()}
    gates["(d) a plan a world"] = sorted(plans) == sorted(COLLECTIVE_WORLDS)
    for w, pl in sorted(plans.items()):
        c = pl["cost"]
        print(f"[collective] (d) world {w} on H100 nodes ({table['topology']}): mesh "
              f"{pl['mesh']} ({pl['config']}), state {c['hbm_state_mb_per_device']} MB a "
              f"device of {c['hbm_state_mb_replicated']} MB, weighted collective bytes "
              f"{c['collective_bytes_estimate']}, feasible {c['feasible']}")
    sup = TrainSupervisor(["true"], nproc_per_node=1, elastic_world=max(COLLECTIVE_WORLDS),
                          allow_shrink=True, plan_table=str(table_path))
    try:
        w, chosen = sup._next_world()
    finally:
        sup.close()
    gates["(d) TrainSupervisor read the table back"] = (
        chosen is not None and w in plans and chosen["config"] == plans[w]["config"])
    stats["d"] = dict(report, worlds={w: dict(mesh=pl["mesh"], config=pl["config"],
                                              **pl["cost"]) for w, pl in plans.items()},
                      supervisor_pick=w)
    print(f"[collective] (d) planner process: build {report['build_s']} s, plan "
          f"{report['plan_s']} s, CUDA initialized {report['cuda_initialized']}; "
          f"TrainSupervisor's shrink pick from the table: world {w} ({chosen['config']})")
    shutil.rmtree(work, ignore_errors=True)
    stats["gates"] = gates
    failed = [g for g, ok in gates.items() if not ok]
    print(f"[collective] gates: {gates}")
    require(not failed, f"[collective] gates failed: {failed}")
    stats["wall_s"] = round(time.perf_counter() - t_phase, 1)
    print(f"[time] phase 23 took {stats['wall_s']} s; launches over the collective path: "
          f"{path_launches}")
    return path_launches, stats


# phase 24 (a): b, heads, s, head dim, chunks of the ring alone; and the
# sequence whose chunks (250) are no multiple of the flash kernels' tile
SEQ_RING, SEQ_RING_ODD = (1, 12, 8192, 64, 4), 1000
SEQ_STEPS = 3  # phase 24 (b)-(d): steps an arm on the two ranks
# phase 24 (d): d_model, d_ff, experts, k, capacity factor, tokens
SEQ_MOE = (512, 2048, 8, 2, 2.0, 4096)
# phase 24 (c) against (b): the JAX package's ring-vs-Ulysses gate
# (tests/test_ulysses.py test_fused_op_ulysses_mode_matches_ring)
ULYSSES_RTOL = 1e-4


def sequence_cells(rehearsal):
    """Phase 24's cells: (the ring alone (b, h, s, d, n), its odd sequence,
    BERT's (BertConfig, b, s, max_preds), the MoE's (d, d_ff, E, k, cf,
    tokens)); tiny on the CPU rehearsal."""
    from paddle_tpu_torch.models.bert import BertConfig

    if rehearsal:
        cfg = BertConfig.tiny()
        cfg.attention_dropout = 0.0
        return (1, 4, 64, 16, 4), 40, (cfg, 1, 32, 5), (16, 32, 4, 2, 2.0, 64)
    cfg = BertConfig.base()
    cfg.max_position, cfg.attention_dropout = 4096, 0.0
    return SEQ_RING, SEQ_RING_ODD, (cfg, 1, 4096, 640), SEQ_MOE


def moe_program(fluid, d, d_ff, experts, k, cf, seed):
    """tests/test_moe_layer.py's model at (d, d_ff, experts): fc -> moe ->
    residual, mse + 0.01 aux, Adam(LR) -> (main, startup, loss)."""
    main_p, startup_p = fluid.Program(), fluid.Program()
    main_p.random_seed = startup_p.random_seed = seed + 24
    with fluid.program_guard(main_p, startup_p), fluid.unique_name.guard():
        x = fluid.layers.data("x", [d], dtype="float32")
        y = fluid.layers.data("y", [d], dtype="float32")
        h = fluid.layers.fc(x, d, act="relu")
        m, aux = fluid.layers.moe(h, num_experts=experts, d_ff=d_ff, capacity_factor=cf, k=k)
        pred = fluid.layers.elementwise_add(h, m)
        mse = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        loss = fluid.layers.reshape(
            fluid.layers.elementwise_add(mse, fluid.layers.scale(aux, scale=0.01)), [1])
        fluid.optimizer.Adam(LR).minimize(loss)
    return main_p, startup_p, loss


def seq_worker(work, rank, seed, rehearsal):
    """Phase 24's rank `rank` of 2 (`chip_smoke.py --seq-worker DIR RANK`),
    one of two processes sharing the card over a gloo group (a file://
    store in DIR), as phase 23 (e)'s: waits for DIR/seq_go, then over a
    batch 1 x model 2 mesh (a DeviceMesh("cuda")), each arm from its
    startup state, SEQ_STEPS steps: (b) BERT-base pretraining at s 4096
    with PADDLE_TPU_SP_MODE unset (the auto ring), (c) the same under
    PADDLE_TPU_SP_MODE=ulysses, (d) the MoE model. Counts the launches and
    the dispatch counters a step, hashes the state, gathers it, and on
    rank 0 runs each one-device walk from the same state. Writes
    DIR/seq_r{RANK}.json."""
    import datetime
    import faulthandler
    import hashlib

    faulthandler.enable()
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    t_enter = time.perf_counter()

    def say(what):
        print(f"[seq rank {rank}] {time.perf_counter() - t_enter:.1f} s: {what}", flush=True)

    import numpy as np
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.scope import full_value

    work = Path(work)
    _, _, (cfg, b, s, p), (d, d_ff, experts, k, cf, tokens) = sequence_cells(rehearsal)
    bert = collective_program(fluid, cfg, b, s, p, seed)
    moe = moe_program(fluid, d, d_ff, experts, k, cf, seed)
    rs = np.random.RandomState(seed + 24)
    bert_feeds = [bert_pretrain_feed(np, rs, cfg, b, s, p) for _ in range(SEQ_STEPS)]
    moe_feeds = []
    for _ in range(SEQ_STEPS):
        xv = rs.randn(tokens, d).astype("float32")
        moe_feeds.append({"x": xv, "y": np.tanh(xv)[:, ::-1].copy()})
    dist.init_process_group("gloo", init_method=f"file://{work / 'seq_store'}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    say("the gloo group is up; waiting for the go file")
    t_wait, parent = time.perf_counter(), os.getppid()
    while not (work / "seq_go").exists():
        require(time.perf_counter() - t_wait < 900, "[seq worker] no go file in 900 s")
        require(os.getppid() == parent, "[seq worker] the script that started it is gone")
        time.sleep(0.05)
    place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)
    if not rehearsal:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    mesh = mesh_mod.build_mesh(batch=1, model=2, device_type="cpu" if rehearsal else "cuda")
    report = dict(rank=rank, mesh=dict(mesh.shape), model_rank=mesh.local_rank("model"),
                  device_type=mesh.device_type, arms={})

    def start(program):
        main_p, startup_p, _ = program
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup_p, scope=scope)
        names = sorted(v.name for v in main_p.list_vars()
                       if v.persistable and scope.has(v.name))
        return {n: scope.get(n).detach().clone() for n in names}, exe._seed_counter

    def steps(exe, prog, scope, loss, feeds):
        losses, ms, per_step, dispatch = [], [], [], []
        for f in feeds:
            before, c0 = kernels.launch_counts(), dict(profiler.counters())
            sync()
            t0 = time.perf_counter()
            (lv,) = exe.run(prog, feed=dict(f), fetch_list=[loss], scope=scope,
                            return_numpy=False)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(lv.detach().clone())
            per_step.append({n: c - before[n] for n, c in kernels.launch_counts().items()})
            c1 = profiler.counters()
            dispatch.append({n: c1.get(n, 0) - c0.get(n, 0)
                             for n in ("attn_dispatch_ring", "attn_dispatch_ulysses")})
        return losses, ms, per_step, dispatch

    def arm(tag, program, feeds, state0, counter0, mode):
        main_p, _, loss = program
        if mode is None:
            os.environ.pop("PADDLE_TPU_SP_MODE", None)
        else:
            os.environ["PADDLE_TPU_SP_MODE"] = mode
        try:
            exe, scope = fluid.Executor(place), fluid.Scope()
            exe._seed_counter = counter0
            for n, t in state0.items():
                scope.set(n, t.clone())
            compiled = fluid.CompiledProgram(main_p).with_data_parallel(loss_name=loss.name)
            compiled._mesh = mesh
            kernels.reset_launch_counts()  # this arm's run on this rank
            losses, ms, per_step, dispatch = steps(exe, compiled, scope, loss, feeds)
            launches = kernels.launch_counts()
        finally:
            os.environ.pop("PADDLE_TPU_SP_MODE", None)
        values = {n: scope.get(n) for n in state0}
        sharded = {n: [repr(pl) for pl in v.placements] + [list(v.to_local().shape)]
                   for n, v in values.items() if hasattr(v, "placements")}
        hashes = {n: hashlib.sha256(v.detach().reshape(-1).cpu().view(torch.uint8).numpy()
                                    ).hexdigest()
                  for n, v in values.items() if n not in sharded}
        gathered = {n: full_value(v) for n, v in values.items()}
        dist.barrier()
        rec = dict(losses=[float(x.reshape(-1)[0]) for x in losses], ms=ms, per_step=per_step,
                   dispatch=dispatch, launches=launches, sharded=sharded, hashes=hashes,
                   seed_counter=exe._seed_counter,
                   placed_on=str(next(iter(gathered.values())).device))
        say(f"({tag}) {rec['losses']}, {[round(x, 1) for x in ms]} ms")
        del exe, scope, values, compiled
        gc.collect()
        return rec, gathered, losses

    def walk(program, feeds, state0, counter0, gathered, arm_losses):
        """The one-device walk from the arm's state -> the comparison."""
        main_p, _, loss = program
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe._seed_counter = counter0
        for n, t in state0.items():
            scope.set(n, t.clone())
        plain, plain_ms, per_step, _ = steps(exe, main_p, scope, loss, feeds)
        worst, worst_name, close, total = 0.0, None, 0, 0
        for n in state0:
            require(gathered[n].shape == scope.get(n).shape, f"[seq worker] {n}: shape")
            diff = (gathered[n].float() - scope.get(n).float()).abs()
            if float(diff.max()) > worst:
                worst, worst_name = float(diff.max()), n
            close += int((diff <= CLOSE_ATOL).sum())
            total += diff.numel()
        out = dict(plain_losses=[float(x.reshape(-1)[0]) for x in plain], plain_ms=plain_ms,
                   plain_per_step=per_step,
                   loss_rel=max(float((x - y).abs().max() / y.abs().max())
                                for x, y in zip(arm_losses, plain)),
                   worst_abs=worst, worst_name=worst_name, far_frac=1 - close / total,
                   plain_seed_counter=exe._seed_counter)
        del exe, scope
        gc.collect()
        return out

    bert_state, bert_counter = start(bert)
    for tag, mode in (("b", "ring" if rehearsal else None), ("c", "ulysses")):
        rec, gathered, losses = arm(tag, bert, bert_feeds, bert_state, bert_counter, mode)
        if rank == 0:
            rec.update(walk(bert, bert_feeds, bert_state, bert_counter, gathered, losses))
            say(f"({tag}) the one-device walk: {rec['plain_losses']}")
        report["arms"][tag] = rec
        del gathered, losses
        if not rehearsal:
            torch.cuda.empty_cache()
        dist.barrier()
    del bert_state
    moe_state, moe_counter = start(moe)
    rec, gathered, losses = arm("d", moe, moe_feeds, moe_state, moe_counter, None)
    if rank == 0:
        rec.update(walk(moe, moe_feeds, moe_state, moe_counter, gathered, losses))
        say(f"(d) the one-device walk: {rec['plain_losses']}")
    report["arms"]["d"] = rec
    dist.barrier()
    dist.destroy_process_group()
    (work / f"seq_r{rank}.json").write_text(json.dumps(report))
    return 0


def start_seq_workers(seed, rehearsal):
    """Phase 24's two ranks (`chip_smoke.py --seq-worker DIR RANK`), started
    ahead of the phase so that they import torch and the port and build
    their Programs while earlier work runs; each waits for DIR/seq_go ->
    (DIR, processes)."""
    work = ROOT / "build" / "chip_smoke" / "sequence"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--seq-worker", str(work), str(r),
         "--seed", str(seed)] + (["--cpu-rehearsal"] if rehearsal else []),
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=open(work / f"seq_r{r}.log", "w"), stderr=subprocess.STDOUT) for r in range(2)]
    return work, procs


def stop_seq_workers(started):
    """Kill what is left of start_seq_workers' processes."""
    for proc in started[1]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def sequence_phase(seed, rehearsal, smi, started=None):
    """Phase 24: sequence and expert parallelism on the card -> (launch
    counts of the sequence path, the phase's result dict, the ring's rows
    for the kernels line). Under deterministic algorithms (warn_only).
    (a) the ring alone, in this process, while (b)-(d)'s two ranks (started
    with phase 23 in the whole script, here otherwise) import:
    b 1, 12 heads, s 8192, d 64, n 4, fp32 and bf16, causal and not, a key
    bias (the last 512 keys padded), attention dropout 0 and 0.1: out, lse
    and the grads against ring_attention_plain at phase 3's gates, with
    dropout 0 against one whole #3 / #4-#5 launch within the same gates,
    with dropout two passes bit-equal, one pass's #3 and #4-#5 launches a
    pair each (10 a pass causal); and s 1000 (chunks of 250). (b)-(d) on
    two processes sharing the card over gloo (seq_worker): BERT-base
    pretraining at s 4096 under the auto ring and under Ulysses, and the
    MoE model at Transformer-base width, each against its one-device walk
    at 5b's card-vs-CPU gates, the replicated state bit-identical on both
    ranks, 12 ring or Ulysses dispatches a step on each rank, each rank
    holding E/2 experts. `started`: start_seq_workers' result, when the
    ranks were started ahead of the phase."""
    import torch

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(not rehearsal or deterministic, warn_only=True)
    started = started or start_seq_workers(seed, rehearsal)
    try:
        return _sequence_phase(seed, rehearsal, smi, *started)
    finally:
        stop_seq_workers(started)
        torch.use_deterministic_algorithms(deterministic)


def _sequence_phase(seed, rehearsal, smi, work, procs):
    import torch

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        attention_delta, flash_attention, flash_attention_bwd)

    t_phase = time.perf_counter()
    dev = torch.device("cpu" if rehearsal else "cuda")
    (b, h, s, d, n), s_odd, (cfg, _, _, _), (_, _, me, _, _, _) = sequence_cells(rehearsal)
    gates, stats, ring_rows = {}, {"card": smi}, []

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    def timed_ms(fn, iters=3):
        fn()
        sync()
        if rehearsal:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # queue the launches behind a device-side hold
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def inputs(seq, dtype, gen_seed):
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        q, k, v = (torch.randn(b, h, seq, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        dout = (0.25 * torch.randn(b, h, seq, d, generator=gen, device=dev)).to(dtype)
        bias = torch.zeros(b, seq, device=dev)
        bias[:, seq - seq // 16:] = -1e4  # BERT's padded keys at the end
        return q, k, v, dout, bias.contiguous()

    def err(xs, ys):
        return max(float((x.float() - y.float()).abs().max()) for x, y in zip(xs, ys))

    # ---- (a) the ring alone ----
    try:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            for causal in (False, True):
                for dropout in (0.0, 0.1):
                    q, k, v, dout, bias = inputs(s, dtype, seed + 240)
                    kw = dict(causal=causal, dropout=dropout, seed=seed + 2401, n=n)
                    pairs = n * (n + 1) // 2 if causal else n * n
                    kernels.reset_launch_counts()  # one pass of the ring (a check)
                    out, lse = ra.ring_attention_fwd(q, k, v, bias, **kw)
                    grads = ra.ring_attention_bwd(q, k, v, bias, dout, out, lse, **kw)
                    sync()
                    one_pass = kernels.launch_counts()
                    tag = f"{dname} {'causal' if causal else 'full'} dropout {dropout}"
                    if not rehearsal:
                        gates[f"(a) {tag}: one pass launches #3 and #4-#5 {pairs} times"] = (
                            one_pass["flash_fwd"] == pairs and one_pass["flash_bwd"] == pairs
                            and sum(one_pass.values()) == 2 * pairs)
                    pout, plse = ra.ring_attention_plain(q, k, v, bias, **kw)
                    pgrads = ra.ring_attention_bwd_plain(q, k, v, bias, dout, out, lse, **kw)
                    got, want = (out, lse) + grads, (pout, plse) + pgrads
                    tol = max(kernel_tol(dname, w) for w in want)
                    e_plain = err(got, want)
                    gates[f"(a) {tag}: out, lse, dq, dk, dv within {tol} of the plain "
                          f"ring"] = e_plain <= tol
                    row = dict(dtype=dname, causal=causal, dropout=dropout, pairs=pairs,
                               err_plain=e_plain, tol=tol)
                    if dropout == 0.0:
                        wout, wlse = flash_attention(q, k, v, bias, causal=causal)
                        wgrads = flash_attention_bwd(q, k, v, bias, dout, wlse,
                                                     attention_delta(wout, dout, "bhsd"),
                                                     causal=causal)
                        e_whole = err((out,) + grads, (wout,) + wgrads)
                        gates[f"(a) {tag}: out and the grads within {tol} of one whole "
                              f"#3 / #4-#5 launch"] = e_whole <= tol
                        row["err_whole"] = e_whole
                        if dtype == torch.float32:
                            row["ms"] = timed_ms(lambda: ra.ring_attention_fwd(q, k, v, bias,
                                                                               **kw))
                            row["bwd_ms"] = timed_ms(lambda: ra.ring_attention_bwd(
                                q, k, v, bias, dout, out, lse, **kw))
                            row["whole_ms"] = timed_ms(lambda: flash_attention(
                                q, k, v, bias, causal=causal))
                            row["whole_bwd_ms"] = timed_ms(lambda: flash_attention_bwd(
                                q, k, v, bias, dout, wlse,
                                attention_delta(wout, dout, "bhsd"), causal=causal))
                        del wout, wlse, wgrads
                    else:
                        out2, lse2 = ra.ring_attention_fwd(q, k, v, bias, **kw)
                        grads2 = ra.ring_attention_bwd(q, k, v, bias, dout, out2, lse2, **kw)
                        gates[f"(a) {tag}: two passes bit-equal"] = all(
                            torch.equal(x, y) for x, y in zip((out, lse) + grads,
                                                               (out2, lse2) + grads2))
                        del out2, lse2, grads2
                    ring_rows.append(row)
                    against = f"{e_plain:.3e} against the plain ring (tol {tol})"
                    if "err_whole" in row:
                        against += f", {row['err_whole']:.3e} against one whole launch"
                    if "ms" in row:
                        against += (f"; fwd {row['ms']:.3f} ms (one whole #3 "
                                    f"{row['whole_ms']:.3f}), bwd {row['bwd_ms']:.3f} ms (one "
                                    f"whole #4-#5 {row['whole_bwd_ms']:.3f}); card {smi}")
                    print(f"[sequence] (a) ring b {b} h {h} s {s} d {d} n {n} {tag}: {pairs} "
                          f"pairs; max abs err {against}")
                    del q, k, v, dout, bias, out, lse, grads, pout, plse, pgrads, got, want
        # the odd sequence: chunks of s_odd / n, no multiple of the 64-row tile
        q, k, v, dout, bias = inputs(s_odd, torch.float32, seed + 242)
        kw = dict(causal=True, dropout=0.1, seed=seed + 2421, n=n)
        out, lse = ra.ring_attention_fwd(q, k, v, bias, **kw)
        grads = ra.ring_attention_bwd(q, k, v, bias, dout, out, lse, **kw)
        want = ra.ring_attention_plain(q, k, v, bias, **kw) + \
            ra.ring_attention_bwd_plain(q, k, v, bias, dout, out, lse, **kw)
        e_odd = err((out, lse) + grads, want)
        gates[f"(a) s {s_odd} (chunks of {s_odd // n}), causal, dropout 0.1: within "
              f"{TOL['float32']} of the plain ring"] = e_odd <= TOL["float32"]
        ring_rows.append(dict(dtype="float32", causal=True, dropout=0.1, s=s_odd,
                              err_plain=e_odd))
        print(f"[sequence] (a) ring s {s_odd} n {n} (chunks of {s_odd // n}) causal dropout "
              f"0.1: max abs err {e_odd:.3e} against the plain ring")
        del q, k, v, dout, bias, out, lse, grads, want
        if not rehearsal:
            torch.cuda.empty_cache()
        stats["a_wall_s"] = round(time.perf_counter() - t_phase, 1)

        # ---- (b)-(d) on the two ranks ----
        (work / "seq_go").write_text("go")
        t_go = time.perf_counter()
        for proc in procs:
            proc.wait(timeout=900)
        stats["ranks_wall_s"] = round(time.perf_counter() - t_go, 1)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logs = [(work / f"seq_r{r}.log").read_text() for r in range(2)]
    require(all(proc.returncode == 0 for proc in procs),
            "[sequence] a rank failed: " + " | ".join(
                f"rank {r} exit {proc.returncode}: {logs[r][-3000:]}"
                for r, proc in enumerate(procs)))
    reps = [json.loads((work / f"seq_r{r}.json").read_text()) for r in range(2)]
    zero = {name: 0 for name in kernels.LAUNCHES}
    layers_n = cfg.num_layers
    ln = 2 * layers_n + 2
    want_steps = {
        "b": dict(zero, flash_fwd=2 * layers_n, flash_bwd=2 * layers_n, layer_norm_bwd=ln),
        "c": dict(zero, flash_fwd=layers_n, flash_bwd=layers_n, layer_norm_bwd=ln),
        "d": dict(zero)}
    want_dispatch = {"b": {"attn_dispatch_ring": layers_n, "attn_dispatch_ulysses": 0},
                     "c": {"attn_dispatch_ring": 0, "attn_dispatch_ulysses": layers_n},
                     "d": {"attn_dispatch_ring": 0, "attn_dispatch_ulysses": 0}}
    gates["(b)-(d) a batch 1 x model 2 mesh, rank r at model coordinate r"] = all(
        rep["mesh"] == {"batch": 1, "model": 2, "pipe": 1} and rep["model_rank"] == rep["rank"]
        and (rehearsal or rep["device_type"] == "cuda") for rep in reps)
    labels = {"b": "(b) BERT-base s 4096, the auto ring", "c": "(c) the same under Ulysses",
              "d": "(d) the MoE model"}
    path = dict(zero)
    for tag, label in labels.items():
        recs = [rep["arms"][tag] for rep in reps]
        r0 = recs[0]
        gates[f"{label}: the dispatch counters a step on each rank"] = all(
            dd == want_dispatch[tag] for rec in recs for dd in rec["dispatch"])
        if not rehearsal:
            gates[f"{label}: the kernels' launches a step on each rank"] = all(
                c == want_steps[tag] for rec in recs for c in rec["per_step"])
        gates[f"{label}: the replicated state bit-identical across the model group"] = (
            len(r0["hashes"]) > 0 and r0["hashes"] == recs[1]["hashes"])
        gates[f"{label}: both ranks fetched the same losses"] = r0["losses"] == recs[1]["losses"]
        gates[f"{label}: losses within {LOSS_RTOL} of the one-device walk, every persistable "
              f"within {2 * LR * SEQ_STEPS}, all but {CLOSE_FRAC} of the elements within "
              f"{CLOSE_ATOL}"] = (r0["loss_rel"] <= LOSS_RTOL
                                  and r0["worst_abs"] <= 2 * LR * SEQ_STEPS
                                  and r0["far_frac"] <= CLOSE_FRAC)
        if tag != "d":
            gates[f"{label}: every parameter replicated (the sequence layout)"] = \
                not r0["sharded"] and not recs[1]["sharded"]
        gates[f"{label}: the seed counter as the walk's"] = (
            r0["seed_counter"] == r0["plain_seed_counter"] == recs[1]["seed_counter"])
        for name in zero:
            path[name] += sum(rec["launches"][name] for rec in recs)
        p50 = [statistics.median(rec["ms"][1:]) for rec in recs]
        plain_p50 = statistics.median(r0["plain_ms"][1:])
        stats[tag] = dict(losses=r0["losses"], plain_losses=r0["plain_losses"],
                          loss_rel=r0["loss_rel"], worst_abs=r0["worst_abs"],
                          worst_name=r0["worst_name"], far_frac=r0["far_frac"],
                          sharded=len(r0["sharded"]), replicated=len(r0["hashes"]),
                          launches=[rec["launches"] for rec in recs],
                          ms=[[round(x, 3) for x in rec["ms"]] for rec in recs],
                          plain_ms=[round(x, 3) for x in r0["plain_ms"]],
                          p50_ms=[round(x, 3) for x in p50], plain_p50_ms=round(plain_p50, 3))
        print(f"[sequence] {label} ({SEQ_STEPS} steps on two processes sharing the card over "
              f"gloo): losses {r0['losses']} against the one-device walk's "
              f"{r0['plain_losses']} (max rel {r0['loss_rel']:.3e}); persistables max abs "
              f"diff {r0['worst_abs']:.3e} ({r0['worst_name']}), {r0['far_frac']:.3e} of the "
              f"elements beyond {CLOSE_ATOL}; {len(r0['sharded'])} state vars sharded, "
              f"{len(r0['hashes'])} replicated and bit-identical on both ranks; launches "
              f"{[rec['launches'] for rec in recs]}; dispatch a step {r0['dispatch'][0]}")
        print(f"[sequence] {label}: step p50 over steps 2-{SEQ_STEPS}: rank 0 {p50[0]:.2f} ms, "
              f"rank 1 {p50[1]:.2f} ms (both ranks on one card, the hops and collectives "
              f"staged through the host by gloo); the one-device walk {plain_p50:.2f} ms; "
              f"card {smi}")
    b_rec, c_rec = reps[0]["arms"]["b"], reps[0]["arms"]["c"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(c_rec["losses"], b_rec["losses"]))
    gates[f"(c) the Ulysses losses within rtol {ULYSSES_RTOL} of the ring's"] = \
        rel <= ULYSSES_RTOL
    stats["c"]["rel_to_ring"] = rel
    experts = {n: sh for n, sh in reps[0]["arms"]["d"]["sharded"].items()}
    gates[f"(d) each rank holds {me // 2} of {me} experts (w1, b1, w2, b2 and their moments "
          f"Shard(0) on model)"] = (
        len(experts) == 12 and all(sh[:2] == ["Replicate()", "Shard(dim=0)"]
                                   and sh[-1][0] == me // 2 for sh in experts.values())
        and experts == reps[1]["arms"]["d"]["sharded"])
    if not rehearsal:
        for name in ("flash_fwd", "flash_bwd", "layer_norm_bwd"):
            gates[f"the sequence path launched {name}"] = path[name] > 0
    print(f"[sequence] launches on the sequence path (both ranks, (b)-(d)): #1 "
          f"{path['mha_short_fwd']}, #3 {path['flash_fwd']}, #4/#5 {path['flash_bwd']}, #7 "
          f"{path['mha_short_bwd']}, #8 {path['layer_norm_bwd']}")
    shutil.rmtree(work, ignore_errors=True)
    stats["gates"] = gates
    stats["ring"] = ring_rows
    failed = [g for g, ok in gates.items() if not ok]
    print(f"[sequence] gates: {gates}")
    require(not failed, f"[sequence] gates failed: {failed}")
    stats["wall_s"] = round(time.perf_counter() - t_phase, 1)
    print(f"[time] phase 24 took {stats['wall_s']} s ((a) {stats['a_wall_s']} s, the ranks "
          f"{stats['ranks_wall_s']} s from go); launches over the sequence path: {path}")
    return path, stats, ring_rows


REPEAT_STEPS, REPEAT_HEAD = 10, 3  # phase 22: steps a window; run() calls before the split one
REPEAT_TIMED = 3  # phase 22: timed windows of a recorded step (the replay's p50 over them)
REPEAT_PROFILED = 2  # phase 22: steps of the profiled replay window
# phase 22's device kernels of #1-#8, by a part of their names
REPEAT_KERNELS = {"#1/#2 mha_short_fwd": "mha_short_fwd_kernel",
                  "#6/#7 launch 1": "short_bwd_dkv_kernel",
                  "#6/#7 launch 2": "short_bwd_dq_kernel",
                  "#8 layer_norm_bwd": "layer_norm_bwd_"}
OUR_KERNEL_NAMES = ("mha_short_fwd_kernel", "short_bwd_dkv_kernel", "short_bwd_dq_kernel",
                    "flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
                    "layer_norm_bwd_", "fused_block_")


def repeated_phase(seed, rehearsal, smi):
    """Phase 22: Executor.run_repeated on the card -> (launch counts of the
    phase's run, the phase's result dict). Each cell from one state three
    ways, each a fresh Executor: REPEAT_STEPS run() calls; one
    run_repeated(REPEAT_STEPS); REPEAT_HEAD run() calls then
    run_repeated(REPEAT_STEPS - REPEAT_HEAD). Every stacked fetch, every
    persistable and the seed counter bit-equal across the three. (a) phase
    5's BERT-base cell (fp32, b 8, s 128, dropout 0.1, Adam); (b) phase 5c's
    full pretraining (both heads, bhsd, bf16 AMP with dynamic loss scaling
    around Lamb with a global-norm clip); (c) (a)'s Program as a
    CompiledProgram on a one-rank NCCL group, run_repeated bit-equal to
    (a)'s run() arm; (d) phase 8's ResNet-50 b 128 bf16 AMP, run() against
    run_repeated only, no kernel of #1-#10 launched; (e) a
    CheckpointManager(save_interval=4) attached across (a)'s
    run_repeated(REPEAT_STEPS): one snapshot, labelled REPEAT_STEPS - 1,
    its records bit-equal to (a)'s state after the last step. A profiled
    replay window of each recorded step: the device kernels a step (12 #1
    or #2, 12 of each of #6 / #7's two launches and 26 #8 for BERT). Each
    arm's capture ms, the walk's step p50, the replay's per-step p50 and
    host ms a step, the window's idle share and the graph pool's memory.
    Under deterministic algorithms (warn_only), as phase 21."""
    import torch

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(not rehearsal or deterministic, warn_only=True)
    try:
        return _repeated_phase(seed, rehearsal, smi)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _repeated_phase(seed, rehearsal, smi):
    import numpy as np
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers, resilience
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
    from paddle_tpu_torch.models.resnet import resnet
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.resilience.snapshot import list_snapshots, load_snapshot
    from paddle_tpu_torch.scope import full_value, to_numpy

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "repeated"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    place = fluid.CPUPlace() if rehearsal else fluid.CUDAPlace(0)
    n, head = REPEAT_STEPS, REPEAT_HEAD

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    stats, gates = {"card": smi}, {}
    # the repeated path's run: the walks, and each recording's discovery and
    # capture (a replay adds nothing to the Python counts: the device
    # kernels a replayed step are read from torch.profiler)
    kernels.reset_launch_counts()

    def fresh(state0, counter0):
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe._seed_counter = counter0
        for name, t in state0.items():
            scope.set(name, t.clone())
        return exe, scope

    def persistables(main_p, scope):
        return {v.name: full_value(scope.get(v.name)).detach().clone()
                for v in main_p.list_vars()
                if v.persistable and scope.has(v.name)
                and isinstance(full_value(scope.get(v.name)), torch.Tensor)}

    def same(a, b):
        return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)

    def start_state(startup_p, main_p):
        exe0, scope0 = fluid.Executor(place), fluid.Scope()
        exe0.run(startup_p, scope=scope0)
        return persistables(main_p, scope0), exe0._seed_counter

    def walk(main_p, state0, counter0, feed, fetch):
        """REPEAT_STEPS run() calls -> (fetches stacked, state, seed
        counter, ms a step)."""
        exe, scope = fresh(state0, counter0)
        got, ms = [], []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            out = exe.run(main_p, feed=dict(feed), fetch_list=fetch, scope=scope,
                          return_numpy=False)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            got.append([o.detach().clone() for o in out])
        stacked = [torch.stack([g[i] for g in got]) for i in range(len(fetch))]
        return stacked, persistables(main_p, scope), exe._seed_counter, ms

    def repeated(prog, main_p, state0, counter0, feed, fetch, head_runs=0):
        """`head_runs` run() calls, then run_repeated of the rest of the
        window -> (fetches stacked, state, seed counter, the Executor, its
        scope, the call's wall ms)."""
        exe, scope = fresh(state0, counter0)
        got = [[o.detach().clone() for o in exe.run(prog, feed=dict(feed), fetch_list=fetch,
                                                     scope=scope, return_numpy=False)]
               for _ in range(head_runs)]
        sync()
        t0 = time.perf_counter()
        outs = exe.run_repeated(prog, feed=dict(feed), fetch_list=fetch, steps=n - head_runs,
                                scope=scope, return_numpy=False)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        stacked = [torch.cat([g[i][None] for g in got] + [outs[i]]) for i in range(len(fetch))]
        return stacked, persistables(main_p, scope), exe._seed_counter, exe, scope, wall

    def replay_report(tag, exe, prog, feed, fetch, scope, want=None):
        """The recorded step of `exe` timed over REPEAT_TIMED windows of
        REPEAT_STEPS, and a window of one step issued on an idle card; a
        REPEAT_PROFILED-step window profiled: the device kernels a step
        (gated against `want` where given), busy ms and idle share."""
        step = exe.last_static_step

        def call(steps):
            exe.run_repeated(prog, feed=dict(feed), fetch_list=fetch, steps=steps, scope=scope,
                             return_numpy=False)

        per_step, host_ms = [], []
        for _ in range(REPEAT_TIMED):
            sync()
            t0 = time.perf_counter()
            call(n)
            t1 = time.perf_counter()
            sync()
            per_step.append((time.perf_counter() - t0) * 1e3 / n)
            host_ms.append((t1 - t0) * 1e3 / n)
        sync()
        t0 = time.perf_counter()
        call(1)
        issue_one = (time.perf_counter() - t0) * 1e3
        sync()
        rec = dict(replay_step_p50_ms=round(statistics.median(per_step), 3),
                   replay_step_ms=[round(x, 3) for x in per_step],
                   host_ms_a_step=round(statistics.median(host_ms), 3),
                   issue_ms_one_step=round(issue_one, 3),
                   capture_ms=None if step.capture_ms is None else round(step.capture_ms, 1),
                   graph_pool_mib=None if step.pool_bytes is None
                   else round(step.pool_bytes / 2**20, 1),
                   seed_slots=len(step.slots.specs), captured=step.graph is not None)
        if rehearsal:
            return rec
        walls = []

        def window():
            t0 = time.perf_counter()
            call(REPEAT_PROFILED)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)

        per_call, sessions = kernels.device_kernel_stats(window, calls=1)
        busy = sum(ms for _, ms in per_call.values())
        ours = {label: sum(c for name, (c, _) in per_call.items() if part in name) / REPEAT_PROFILED
                for label, part in REPEAT_KERNELS.items()}
        top = sorted(((ms, name) for name, (_, ms) in per_call.items()), reverse=True)[:3]
        rec.update(window_steps=REPEAT_PROFILED, window_wall_ms=round(walls[-1], 3),
                   window_busy_ms=round(busy, 3),
                   idle_share=round(max(0.0, 1 - busy / walls[-1]), 4) if busy else "not measured",
                   device_kernels_a_step=ours, kernel_names=len(per_call),
                   top_kernels=[[round(ms / REPEAT_PROFILED, 3), name[:60]] for ms, name in top],
                   ours_any=sorted(name for name in per_call
                                   if any(part in name for part in OUR_KERNEL_NAMES)))
        if want is not None:
            gates[f"({tag}) the replayed step's device kernels {want}"] = all(
                ours[k] == v for k, v in want.items())
        print(f"[repeated] ({tag}) a profiled replay window of {REPEAT_PROFILED} steps "
              f"(torch.profiler, {sessions} sessions): wall {walls[-1]:.2f} ms, busy "
              f"{busy:.2f} ms, idle share {rec['idle_share']}; device kernels a step {ours}; "
              f"top kernels a step {rec['top_kernels']}")
        return rec

    def three_ways(tag, main_p, startup_p, feed, fetch, want=None):
        state0, counter0 = start_state(startup_p, main_p)
        t0 = time.perf_counter()
        w_fetch, w_state, w_counter, w_ms = walk(main_p, state0, counter0, feed, fetch)
        r_fetch, r_state, r_counter, r_exe, r_scope, r_wall = repeated(
            main_p, main_p, state0, counter0, feed, fetch)
        i_fetch, i_state, i_counter, i_exe, _, _ = repeated(
            main_p, main_p, state0, counter0, feed, fetch, head)
        i_exe.close()
        del i_exe
        for arm, (f, st, c) in (("run_repeated", (r_fetch, r_state, r_counter)),
                                ("run() + run_repeated", (i_fetch, i_state, i_counter))):
            gates[f"({tag}) {arm}: every fetch, persistable and the seed counter bit-equal to "
                  f"{n} run()"] = (all(torch.equal(a, b) for a, b in zip(f, w_fetch))
                                   and same(st, w_state) and c == w_counter == counter0 + n)
        losses = [float(x) for x in w_fetch[0].float().reshape(n, -1)[:, 0]]
        gates[f"({tag}) the losses finite and not all equal"] = (
            all(math.isfinite(x) for x in losses) and len(set(losses)) > 1)
        rec = dict(walk_step_p50_ms=round(statistics.median(w_ms[1:]), 3),
                   first_call_ms=round(r_wall, 1), losses=losses)
        rec.update(replay_report(tag, r_exe, main_p, feed, fetch, r_scope, want))
        r_exe.close()
        print(f"[repeated] ({tag}) {n} run() against run_repeated({n}) and {head} run() + "
              f"run_repeated({n - head}): losses {losses}; walk step p50 "
              f"{rec['walk_step_p50_ms']} ms, replay per-step p50 {rec['replay_step_p50_ms']} "
              f"ms (host {rec['host_ms_a_step']} ms a step; one step issued on an idle card "
              f"{rec['issue_ms_one_step']} ms), capture {rec['capture_ms']} ms, first call "
              f"{rec['first_call_ms']} ms, graph pool {rec['graph_pool_mib']} MiB, "
              f"idle share {rec.get('idle_share')}, {rec['seed_slots']} seed slots; "
              f"{time.perf_counter() - t0:.1f} s; card {smi}")
        del r_exe, r_scope
        gc.collect()
        if not rehearsal:
            torch.cuda.empty_cache()
        return rec, (state0, counter0, w_fetch, w_state, w_counter)

    # ---- (a) BERT-base fp32, phase 5's cell ---------------------------------
    b, s, p = (2, 32, 5) if rehearsal else (8, 128, 20)
    cfg = BertConfig.tiny() if rehearsal else BertConfig.base()
    main_a, startup_a = fluid.Program(), fluid.Program()
    main_a.random_seed = startup_a.random_seed = seed + 2
    with fluid.program_guard(main_a, startup_a), fluid.unique_name.guard():
        loss_a = build_bert_pretrain(cfg, b, s, mlm_only=True, max_preds=p)["loss"]
        fluid.optimizer.Adam(LR).minimize(loss_a)
    feed_a = bert_pretrain_feed(np, np.random.RandomState(seed), cfg, b, s, p)
    L = cfg.num_layers
    want_bert = {"#1/#2 mha_short_fwd": L, "#6/#7 launch 1": L, "#6/#7 launch 2": L,
                 "#8 layer_norm_bwd": 2 * L + 2}
    stats["a"], ref_a = three_ways("a", main_a, startup_a, feed_a, [loss_a], want_bert)
    stats["a"]["cell"] = (f"BERT hidden {cfg.hidden_size} x {L} layers fp32 b {b} s {s} "
                          f"max_preds {p}, Adam({LR}), dropout {cfg.hidden_dropout}")

    # ---- (c) the same Program over the one-rank NCCL mesh -------------------
    state0, counter0, w_fetch, w_state, w_counter = ref_a
    backend = "gloo" if rehearsal else "nccl"
    dist.init_process_group(backend, init_method=f"file://{work / 'store'}", world_size=1,
                            rank=0)
    try:
        compiled = fluid.CompiledProgram(main_a).with_data_parallel(loss_name=loss_a.name)
        mesh = compiled._get_mesh()
        c_fetch, c_state, c_counter, c_exe, c_scope, c_wall = repeated(
            compiled, main_a, state0, counter0, feed_a, [loss_a])
        gates[f"(c) CompiledProgram run_repeated({n}) under the one-rank {backend} group "
              "bit-equal to (a)'s run() arm"] = (
            mesh.device_mesh is not None and torch.equal(c_fetch[0], w_fetch[0])
            and same(c_state, w_state) and c_counter == w_counter)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            c_exe.run_repeated(compiled, feed=dict(feed_a), fetch_list=[loss_a], steps=n,
                               scope=c_scope, return_numpy=False)
            sync()
        collectives = {e.key: e.count for e in prof.key_averages()
                       if "all_reduce" in e.key or "allreduce" in e.key}
        stats["c"] = dict(first_call_ms=round(c_wall, 1), collectives_host_events=collectives,
                          capture_ms=None if c_exe.last_static_step.capture_ms is None
                          else round(c_exe.last_static_step.capture_ms, 1))
        if rehearsal:
            # the CPU re-runs the lowering: each step's all-reduces run
            gates["(c) the grads' all-reduces ran through the group"] = any(
                backend in k.lower() for k in collectives)
        print(f"[repeated] (c) CompiledProgram over the one-rank {backend} group, "
              f"run_repeated({n}): bit-equal to (a)'s run(); first call {c_wall:.1f} ms, capture "
              f"{stats['c']['capture_ms']} ms; a further window's collectives (host events: "
              f"a replay issues none) {collectives}; card {smi}")
        c_exe.close()
        del c_exe, c_scope
    finally:
        dist.destroy_process_group()
        mesh_mod.set_current_mesh(None)

    # ---- (e) a CheckpointManager attached across the window ---------------
    mgr = resilience.CheckpointManager(str(work / "ckpt"), save_interval=4, keep=3)
    mgr.attach(main_a)
    try:
        e_fetch, e_state, e_counter, e_exe, _, e_wall = repeated(
            main_a, main_a, state0, counter0, feed_a, [loss_a])
        mgr.drain()
        snaps = list_snapshots(str(work / "ckpt"))
        arrays, _ = load_snapshot(snaps[-1][1]) if snaps else ({}, None)
        want_state = {k: to_numpy(v) for k, v in w_state.items()}
        gates[f"(e) one snapshot across run_repeated({n}), labelled {n - 1}, the final "
              "state bit for bit"] = (
            [st for st, _ in snaps] == [n - 1] and mgr._auto_step == n
            and sorted(arrays) == sorted(want_state)
            and all(np.array_equal(arrays[k], want_state[k]) for k in want_state)
            and torch.equal(e_fetch[0], w_fetch[0]))
        stats["e"] = dict(snapshots=[st for st, _ in snaps], auto_step=mgr._auto_step,
                          call_ms=round(e_wall, 1), vars=len(arrays))
        print(f"[repeated] (e) CheckpointManager(save_interval=4) across run_repeated({n}): "
              f"snapshots {stats['e']['snapshots']}, _auto_step {mgr._auto_step}, "
              f"{len(arrays)} records bit-equal to (a)'s state after step {n}; call "
              f"{e_wall:.1f} ms with the submit; card {smi}")
        e_exe.close()
        del e_exe
    finally:
        mgr.detach(main_a)
        mgr.close()
    del state0, w_fetch, w_state, ref_a
    gc.collect()

    # ---- (b) full pretraining: bhsd, bf16 AMP, Lamb, loss scaling ------------
    cfg_f = BertConfig.tiny() if rehearsal else BertConfig()
    cfg_f.attn_layout = "bhsd"
    main_b, startup_b = fluid.Program(), fluid.Program()
    main_b.random_seed = startup_b.random_seed = seed + 3
    with fluid.program_guard(main_b, startup_b), fluid.unique_name.guard():
        loss_b = build_bert_pretrain(cfg_f, b, s, mlm_only=False, max_preds=None)["loss"]
        opt = mixed_precision.decorate(
            fluid.optimizer.Lamb(FULL_LR, lamb_weight_decay=0.01,
                                 grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)),
            use_dynamic_loss_scaling=True)
        opt.minimize(loss_b)
    found_b = next(op.output("FoundInfinite")[0] for op in main_b.global_block().ops
                   if op.type == "check_finite_and_unscale")
    feed_b = bert_full_feed(np, np.random.RandomState(seed), cfg_f, b, s)
    want_full = {"#1/#2 mha_short_fwd": L, "#6/#7 launch 1": L, "#6/#7 launch 2": L}
    stats["b"], _ = three_ways("b", main_b, startup_b, feed_b,
                               [loss_b, opt.get_loss_scaling(), found_b], want_full)
    stats["b"]["cell"] = (f"BERT hidden {cfg_f.hidden_size} x {L} layers b {b} s {s}, NSP + MLM over every position, bhsd, bf16 "
                          f"AMP with dynamic loss scaling, Lamb({FULL_LR}) + "
                          "GradientClipByGlobalNorm(1.0)")
    del main_b, startup_b
    gc.collect()

    # ---- (d) ResNet-50 b 128 bf16 AMP, phase 8's cell --------------------------
    rb, depth, hw = (4, 18, 32) if rehearsal else (RN_BATCH, 50, 224)
    main_d, startup_d = fluid.Program(), fluid.Program()
    main_d.random_seed = startup_d.random_seed = seed + 3
    with fluid.program_guard(main_d, startup_d), fluid.unique_name.guard():
        img = layers.data("img", [rb, 3, hw, hw], append_batch_size=False)
        label = layers.data("label", [rb, 1], dtype="int64", append_batch_size=False)
        _, loss_d, _, _ = resnet(img, label, depth=depth, class_num=1000)
        mixed_precision.decorate(fluid.optimizer.Momentum(RN_LR, RN_MOMENTUM)).minimize(loss_d)
    rs = np.random.RandomState(seed + 22)
    feed_d = {"img": rs.rand(rb, 3, hw, hw).astype("float32"),
              "label": rs.randint(0, 1000, (rb, 1)).astype("int64")}
    state_d, counter_d = start_state(startup_d, main_d)
    before = kernels.launch_counts()
    w_fetch, w_state, w_counter, w_ms = walk(main_d, state_d, counter_d, feed_d, [loss_d])
    r_fetch, r_state, r_counter, r_exe, r_scope, r_wall = repeated(
        main_d, main_d, state_d, counter_d, feed_d, [loss_d])
    gates[f"(d) ResNet-{depth} run_repeated({n}) bit-equal to {n} run()"] = (
        torch.equal(r_fetch[0], w_fetch[0]) and same(r_state, w_state) and r_counter == w_counter)
    rec = dict(walk_step_p50_ms=round(statistics.median(w_ms[1:]), 3),
               first_call_ms=round(r_wall, 1),
               losses=[float(x) for x in w_fetch[0].float().reshape(-1)])
    rec.update(replay_report("d", r_exe, main_d, feed_d, [loss_d], r_scope))
    gates["(d) no kernel of #1-#10 launched"] = (
        all(c == before[k] for k, c in kernels.launch_counts().items())
        and not rec.get("ours_any"))
    stats["d"] = rec
    stats["d"]["cell"] = f"ResNet-{depth} b {rb} {hw}x{hw} bf16 AMP, Momentum({RN_LR}, {RN_MOMENTUM})"
    print(f"[repeated] (d) {stats['d']['cell']}: {n} run() against run_repeated({n}): losses "
          f"{rec['losses']}; walk step p50 {rec['walk_step_p50_ms']} ms, replay per-step p50 "
          f"{rec['replay_step_p50_ms']} ms (host {rec['host_ms_a_step']} ms a step), capture "
          f"{rec['capture_ms']} ms, graph pool {rec['graph_pool_mib']} MiB, idle share "
          f"{rec.get('idle_share')}; card {smi}")
    r_exe.close()
    del r_exe, r_scope, state_d, w_state, r_state
    gc.collect()
    if not rehearsal:
        torch.cuda.empty_cache()

    path_launches = kernels.launch_counts()
    if not rehearsal:
        gates["the repeated path launched #1 / #2, #6 / #7 and #8"] = all(
            path_launches[k] > 0 for k in ("mha_short_fwd", "mha_short_bwd", "layer_norm_bwd"))
    shutil.rmtree(work, ignore_errors=True)
    stats["gates"] = gates
    failed = [g for g, ok in gates.items() if not ok]
    print(f"[repeated] gates: {gates}")
    require(not failed, f"[repeated] gates failed: {failed}")
    stats["wall_s"] = round(time.perf_counter() - t_phase, 1)
    print(f"[time] phase 22 took {stats['wall_s']} s; launches over the phase's run (the "
          f"walks, and each recording's discovery and capture): {path_launches}")
    return path_launches, stats


def bert_sample_reader(seed, cfg, s, p, n):
    """Phases 19 and 20's seeded sample stream: `n` rows of
    bert_pretrain_feed's recipe, row i from RandomState(seed * 7919 + i),
    mapped on 2 threads in order (xmap_readers) and buffered."""
    import numpy as np

    from paddle_tpu_torch import reader as rdr

    def bert_row(i):
        rs = np.random.RandomState(seed * 7919 + i)
        return (rs.randint(0, cfg.vocab_size, s).astype("int64"),
                rs.randint(0, cfg.type_vocab_size, s).astype("int64"),
                np.arange(s, dtype="int64"), np.ones(s, "float32"),
                rs.randint(0, cfg.vocab_size, p).astype("int64"), np.ones(p, "float32"),
                rs.choice(s, p, replace=False).astype("int64"))

    return rdr.buffered(rdr.xmap_readers(bert_row, lambda: iter(range(n)), 2, 16, order=True), 32)


def bert_pretrain_feed(np, rs, cfg, b, s, max_preds):
    """The feed recipe of the JAX package's benchmark (`_bert_feed` with
    max_preds): random ids, a full input mask, max_preds distinct masked
    positions per row, weights 1."""
    return {
        "src_ids": rs.randint(0, cfg.vocab_size, (b, s)).astype("int64"),
        "sent_ids": rs.randint(0, cfg.type_vocab_size, (b, s)).astype("int64"),
        "pos_ids": np.tile(np.arange(s), (b, 1)).astype("int64"),
        "input_mask": np.ones((b, s), dtype="float32"),
        "mask_label": rs.randint(0, cfg.vocab_size, (b, max_preds)).astype("int64"),
        "mask_weight": np.ones((b, max_preds), "float32"),
        "mask_pos": np.stack([rs.choice(s, max_preds, replace=False)
                              for _ in range(b)]).astype("int64"),
    }


def bert_full_feed(np, rs, cfg, b, s):
    """The feed of the NSP head and the masked-LM head over every position:
    random ids, a full input mask, labels at every position with 15% of
    the weights 1, and random next-sentence labels."""
    return {
        "src_ids": rs.randint(0, cfg.vocab_size, (b, s)).astype("int64"),
        "sent_ids": rs.randint(0, cfg.type_vocab_size, (b, s)).astype("int64"),
        "pos_ids": np.tile(np.arange(s), (b, 1)).astype("int64"),
        "input_mask": np.ones((b, s), dtype="float32"),
        "mask_label": rs.randint(0, cfg.vocab_size, (b, s)).astype("int64"),
        "mask_weight": (rs.rand(b, s) < 0.15).astype("float32"),
        "nsp_label": rs.randint(0, 2, (b, 1)).astype("int64"),
    }


def profile_step(torch, fn, what):
    """`fn` once under torch.profiler: device time by kernel, and the
    device's idle share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side rows only: an aten:: row's self device time is the
        # time of the kernels it launched, which have rows of their own
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((ev.self_device_time_total / 1e3, ev.count, ev.key))
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        print("[profile] torch.profiler shows no device time here")
        return wall_ms, 0.0, rows
    print(f"[profile] {what}: wall {wall_ms:.2f} ms (under the "
          f"profiler), device busy {busy_ms:.2f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.2f}")
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        print(f"[profile]   {ms:8.3f} ms {100 * ms / busy_ms:5.1f}%  x{count:<4d} {key[:90]}")
    return wall_ms, busy_ms, rows


def kernel_device_ms(torch, fn, names, iters=20):
    """`fn` `iters` times under torch.profiler, a session that lost its
    records taken again (`kernels.device_kernel_ms`) -> {name: device ms a
    call of the kernels whose name holds it, or "not measured"}."""
    from paddle_tpu_torch.ops.kernels import device_kernel_ms

    per_call, _ = device_kernel_ms(fn, calls=iters)
    out = {}
    for name in names:
        ms = [v for key, v in per_call.items() if name in key]
        out[name] = f"{sum(ms):.4f}" if ms and sum(ms) > 0 else "not measured"
    return out


def host_breakdown(step, tag="host"):
    """One call of `step` with the host time of each op the executor
    lowers summed by op type (no device synchronisation between ops: the
    time the host spends issuing each op's work) -> (wall ms, ms issuing
    ops, {op type: (ms, count)})."""
    from paddle_tpu_torch import executor

    per_type = {}

    def timed(fn):
        def wrapper(ctx, op, *rest):
            t0 = time.perf_counter()
            try:
                return fn(ctx, op, *rest)
            finally:
                ms, n = per_type.get(op.type, (0.0, 0))
                per_type[op.type] = (ms + (time.perf_counter() - t0) * 1e3, n + 1)
        return wrapper

    saved = executor.lower_op, executor.lower_forward_op
    executor.lower_op, executor.lower_forward_op = (timed(f) for f in saved)
    try:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        executor.lower_op, executor.lower_forward_op = saved
    ops_ms = sum(ms for ms, _ in per_type.values())
    print(f"[{tag}] one step: wall {wall_ms:.2f} ms, of which {ops_ms:.2f} ms "
          f"issuing {sum(n for _, n in per_type.values())} ops; by op type:")
    for op_type, (ms, n) in sorted(per_type.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"[{tag}]   {ms:8.2f} ms {100 * ms / wall_ms:5.1f}%  x{n:<4d} {op_type}")
    return wall_ms, ops_ms, per_type


def _cpu_config(config_cls, model_dir):
    config = config_cls(str(model_dir))
    config.disable_gpu()
    return config


if __name__ == "__main__":
    sys.exit(main())
