#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase large   # the Large-width local track only
    python3 chip_smoke.py --phase base    # K1, #3, K2 and int8 legs' times
    python3 chip_smoke.py --phase k2      # the same as --phase base
    python3 chip_smoke.py --phase default # #6 and #6-int8's times
    python3 chip_smoke.py --phase f32     # the float32 plans' times at
                                          # the presets' geometry
    python3 chip_smoke.py --phase resume  # checkpoint, SIGTERM, resume
    python3 chip_smoke.py --phase serve   # the served paths and their gates
    python3 chip_smoke.py --phase serve-times  # their numbers only
    python3 chip_smoke.py --phase finetune  # fine-tune, then predict_task
    python3 chip_smoke.py --phase neighbors # map, index, /v1/neighbors;
                                            # the int8 arm at Large
    python3 chip_smoke.py --phase rollout   # blue-green trunk rollout
    python3 chip_smoke.py --phase cli       # the command line's verbs
    python3 chip_smoke.py --phase data      # data parallelism, ZeRO-1
    python3 chip_smoke.py --phase etl       # the corpus tools, the C++
                                            # tokenizer, base steps on them
    python3 chip_smoke.py --phase check     # the static analyzer, the
                                            # profiling helpers on base steps
    python3 chip_smoke.py --phase mesh      # FSDP, the GO head's tensor
                                            # parallelism, reshard, seq
                                            # on the sharded layout
    python3 chip_smoke.py --phase eval      # the trainer's eval brackets
                                            # and the drill knobs
    python3 chip_smoke.py --phase coverage  # the new head widths and
                                            # C=384; tiny, small, C=384
                                            # models on their routes
    python3 chip_smoke.py --cli-first       # the full run, with the cli
                                            # phase once more up front

Phases (any failure exits non-zero; nothing is caught and carried on):

1. build    — nvcc builds every kernel of the paths from
              `proteinbert_tpu_torch/csrc/` (one process per source, in
              parallel) for sm_90a.
2. kernels  — each kernel's wrapper against its plain PyTorch version on the
              card, in bfloat16 and float32 (TF32 off for matmul and cuDNN),
              B=8, L in {128, 512} timed and a ragged L=100:
              K1 and K2 at base width (C=G=512, H=8, k=64) with padded,
              all-pad and S=8 segment cases, plus C=128/256;
              #3 at base width with S=8 packed rows (a cross-segment pad gap,
              ids above S, an empty segment);
              #6 at C=128 (G=512, H=4, v=128) and C=256 (G=512, H=8), dense
              (a half-padded and an all-pad row) and packed (S=8, an empty
              segment that must come back +0.0), and at C=512 (G=512, H=4,
              L=128, bf16), where `fused_onepass_segments` must pick it (as
              it must for the base preset's H=8 at L=8);
              cross-segment isolation of #3, #6 and #4 bit for bit;
              #2 at ProteinBERT-Large width (C=1024, B=8) in bf16 and fp32,
              L in {128, 1024} timed, L=100 with a constant (all-<pad>) row;
              #2 and #4 in bf16 at C=640 and C=2048 (B=2, L=200);
              #4 at Large width (C=1024, B=8, S=8) in bf16 and fp32, L in
              {128, 1024} timed and L=100, with segment boundaries on and
              beside the 64-row tile edges (bf16 finish pass, fp32 conv
              pass) and the 128-row bf16 conv tile edge, inside a 32-row
              finish tile and inside a tile's 20-row halo;
              the conv pass and the finish pass of K1, #3 (B=8, L=C=512),
              #2, #4 (B=8, L=C=1024) and the prehaloed entries of K1
              (B=16, L=512+2*20) and #2 timed apart by torch.profiler's
              kernel names (`# passes`), #3-int8 with its dequantize pass
              beside its fp leg, and so K2's bf16 passes (query,
              projection, softmax; the int8 leg's dequantize pass) at base
              width (B=8, L=512) and Large width (L=1024), dense and S=8,
              and #6's bf16 passes (query, conv, finish, projection,
              softmax) at C=128, B=8, L=512, dense and S=8;
              the HGMMA and UTMALDG counts `cuobjdump -sass` finds in the
              libraries of K1, its prehaloed entry, #3, #3-int8, #2, its
              prehaloed entry, #4, both K2 entries and both #6 legs
              (`# SASS`), and an
              equal-FLOP torch.matmul GEMM yardstick (never called by the
              port);
              K2 at Large width (C=G=1024, H=16, L=1024) dense and packed
              (S=8) timed, and at value_dim 128 (C=256, G=512, H=4);
              the prehaloed entries of K1 (C=512) and #2 (C=1024)
              (`fused_local_track_valid`), bf16 and fp32: one L=2048 row
              cut into shards of 512 / 256 rows with their neighbours' 20
              rows, each shard's centre bit for bit the whole row's
              `fused_local_track`; a middle shard against the plain
              version, timed at B=16 L=512+2*20 C=512 and B=8 L=256+2*20
              C=1024; the train phases' shapes (B=4 L=2048+2*20 C=512,
              B=8 L=1024+2*20 C=1024, zero halos) against the plain
              version;
              the int8 legs (int8 weights, quantized as the int8 serving arm
              holds them): #3-int8 at base width (S=8), K2-int8 at base width
              dense and packed, at value_dim 128 and at Large width
              (L=1024, C=G=1024, H=16, bf16, dense and S=8, timed with
              its passes beside its fp leg), #6-int8 at C=128/256
              dense and packed and at C=512 (bf16, H=4, L=128), bf16 and
              fp32, L=512 timed and L=100 with an all-pad row and an empty
              segment: each exactly (max |diff| == 0.0) the fp leg's output on
              the dequantized weights, an empty segment +0.0. Prints
              max |kernel - plain| against its tolerance, kernel and plain ms
              (CUDA events, median of 25), the bound and launches per call,
              and each int8 leg's ms beside its fp leg's.
   gradients — every autograd Function (K1 and #2 through
              `fused_local_track` and `fused_local_track_valid`, #3 and #4
              through `fused_local_track_segments`, K2, #6): the grads of
              sum(out * r) through the kernel, fp32 and bf16, against
              float32 autograd of the backward reference (the port of the
              JAX XLA reference) on the same inputs cast up; then
              2-block fp32 Large-width train steps,
              dense and packed, their loss and grads on the card against the
              same steps on the CPU plain path, and each packed protein's
              loss terms against the same protein run alone as a dense row.
3. reference — a base-width float32 trunk through the kernels on the card
              against the plain path on the CPU, on a small input; then a
              float32 2-block base-width trunk served ragged and bucketed on
              the card, the answers within 1e-3; then the same trunk int8
              (`quant_entry` / `quant_packed_entry`) on the card against the
              CPU plain path, bucketed (K1 + K2-int8) and ragged (#3-int8 +
              K2-int8), within 1e-3.
4. serve    — three servers, random weights from a seeded torch.Generator,
              buckets (128, 256, 512), seq_len 512, bf16, max_batch 8; 24
              mixed requests (20-500 residues) from 4 threads, then drain:
              a. bucketed, base preset (6 blocks, C=G=512, 8943 annotations):
                 exactly 6 launches of K1 and of K2 per batch, none of #3/#6;
              b. ragged (`serve_mode="ragged"`, 8 segments a row), base
                 preset: exactly 6 of #3 and of K2 per batch, none of K1/#6;
              c. ragged at the ModelConfig default width (C=128, G=512, H=4,
                 6 blocks): exactly 6 of #6 per batch, none of the others.
              Each checks every answer and each embed against the same
              sequence run alone, prints requests/s and p50/p99, and a
              torch.profiler breakdown of one full 8x512 batch and the
              device memory after load. Each then runs again on the int8 arm
              (`quant="int8"`, quant_parity_every=0, same weights and
              traffic): a'. exactly 6 of K1 and of K2-int8 per batch; b'. 6 of
              #3-int8 and of K2-int8; c'. 6 of #6-int8 — none of the fp legs
              of K2, #3, #6 — its quant_report, and max |int8 - fp32 arm|
              over the answers (must be > 0). Then the parity shadow
              (quant_parity_every=1: parity_max equals the deviation measured
              outside) and 12 requests on the `int8_act` arm (a'.'s counts).
              Every kernel count is set to 0 just before each server's
              traffic and read just after it. Each served shape is a CUDA
              graph captured at start() (`serve/dispatch.WarmShape`), so
              the counts hold with every replay credited; each server
              prints its graphs' pool bytes after warmup, the host ms from
              submit to a full batch's replay enqueued, and when each
              request was answered. On each of the six paths: one full
              embed batch replayed equals its eager run bit for bit; the
              24 requests submitted before start() to a server at
              pipeline_depth 2 and to one at depth 1 are answered bit for
              bit alike, each future sealed once, inflight_max <= depth;
              both servers' event streams pass read_events(strict=True)
              and the schema validator (one serve_request a request, one
              serve_batch a batch, serve_start first, serve_end drained
              last); the depth-2 server answers one request of each kind
              over HTTP on 127.0.0.1 exactly as in process, a bad body
              400 and a predict_task for an unknown head the typed 404.
5. train    — `pretrain()` on the `large` preset at full depth and width
              (12 blocks, C=G=1024, H=16, 8943 annotations), bf16, seq_len
              1024, B=8, 6 steps (1 warm, 5 timed), twice:
              a. dense rows of 100-1022 residues: exactly 12 launches of #2
                 and of K2 per step and none of the others;
              b. packed rows (`make_packed_iterator`, 8 segments a row) of
                 50-500 residues: exactly 12 of #4 and of K2 per step;
              finite losses, params moved by step 2; step ms, tokens/s, MFU,
              peak memory and a split of one step (packed: also the share of
              real positions and segments a row), each printed beside the
              same step with the float32 backward (`# bf16 backward`).
              Then 2 steps each of the
              `base` preset (B=8, L=512) dense (exactly 6 of K1 and of K2
              per step) and packed (6 of #3 and of K2), and of the
              ModelConfig default width packed (6 of #6). Then sequence
              parallelism, `pretrain(..., seq_group=g)` with g a one-rank
              NCCL group made in this process:
              c. `long seq` — the `long` preset at full depth and width (6
                 blocks, C=G=512, H=8, 8943 annotations), bf16, seq_len
                 2048, B=4 (the preset's 64 rows x 2048 over 16 chips;
                 cuts: seq world 4 -> 1, data 4 -> 1), its LR 2e-4 with
                 no warmup, 6 steps: exactly 6 launches of K1's prehaloed entry per
                 step and none of the others, finite and falling loss;
                 step ms, tokens/s, MFU, peak memory, one step's split;
              d. `large seq` — the `large` preset, B=8, L=1024, 2 steps:
                 exactly 12 of #2's prehaloed entry per step.
              Counts are zeroed before each run.
6. resume   — `resume_phase`: a pretraining run that survives, through
              `pretrain(..., checkpointer=, telemetry=)`: `large` dense at
              full width and 3 of its 12 blocks (`RESUME_LARGE_BLOCKS`;
              B=8, L=1024, 6 steps, saves every 3)
              and `base` packed (B=8, L=512, 4 steps, saves every 2), each
              run at peak LR uninterrupted with synchronous saves, then
              with staged saves and SIGTERM from log_fn (step 4 / 2), then
              resumed by a fresh state and a new Checkpointer: the
              restored state bit for bit the saved one, the staged saves
              held against the synchronous ones and the final state
              (RESUME_STATE_TOL, a planted fault beyond it), two staged
              saves racing train-stream work and in-place updates read
              back bit for bit, the resumed losses within
              RESUME_LOSS_TOL of the uninterrupted run's, exact launch
              counts a step (12 #2 + 12 K2 / 6 #3 + 6 K2), a valid event
              stream; and, at Large, the boundary's cost (the walls of the
              steps holding a synchronous and a staged save against the
              median step, the stage's seconds until it landed, the
              checkpoint's bytes). The checkpoints go to a temporary
              directory under build/, removed afterwards.
   long hdf5 — `long_hdf5_phase`, `# train long hdf5`: the `long` preset
              (6 blocks, C=G=512, H=8, 8943 annotations), bf16, B=16, 8
              steps, from a seeded HDF5 corpus of 4096 proteins (lengths
              log-normal, median 350, capped at 3000) in the reference
              schema, through `HDF5PretrainingDataset`, the bucketed
              iterator (512 / 1024 / 2048) and pretrain's prefetch thread
              (depth 2); without h5py the same rows come from memory. Cuts:
              global batch 64 over 4 replicas -> 16, seq world 4 -> 1, no
              LR warmup. Gates: the prefetched stream equals the
              iterator's own byte for byte; exactly 6 K1 + 6 K2 a step;
              finite losses. Prints step ms, tokens/s and MFU by bucket,
              data_wait_s, data_batches_total, the pad fraction and peak
              memory.
7. finetune — `finetune_phase`, `# finetune base`: a float32 2-block
              base-width fine-tune step on the card against the CPU plain
              path (loss <= 1e-4, grads <= 1e-3) for both tasks; then the
              `base` trunk in bf16 fine-tuned (B=8, L=512, 4 steps) for
              token_classification (8 classes) and sequence_regression (1
              output), freeze_trunk False and True, each head registered
              in a HeadRegistry: exactly 6 K1 + 6 K2 a step, the frozen
              trunk bit for bit; step ms, tokens/s, peak memory.
              `serve_task_phase`, `# serve base predict_task`: bucketed and
              ragged servers, fp32 and int8 arms, over that trunk with the
              two frozen-trunk heads: 24 predict_task requests (exactly 6
              K1 or #3 (int8: #3-int8 ragged) + 6 K2 (int8: K2-int8) a
              batch); the fp32 bucketed answers bit for bit
              `predict_task_rows` run eagerly on the card; one full batch
              replayed bit for bit the eager trunk and tails; the int8 arm
              off the fp32 one; a hot-added third head captures no trunk
              graph; a removed head -> the typed unknown_head; a head
              fine-tuned with its trunk -> TrunkMismatchError; HTTP
              /v1/predict_task and /v1/heads* (fp32 arms). Prints each
              server's graph pool and a full batch's wall and busy share.
8. neighbors — `neighbors_phase`, `# neighbors base ...`: the `base` trunk
              in bf16 maps 8192 seeded proteins (`corpus_rows`: log-normal
              lengths, median 350, a third truncated at the 510-residue
              window) plus three poisoned records (empty, non-string, a
              control character) into a store (`mapper.run_map`: buckets
              128/256/512, rows_per_batch 8, 8 segments, 2 shards of
              256-record blocks). Gates: exactly 6 #3 + 6 K2 per packed
              batch and nothing else; `verify_store` ok and complete; a run
              stopped by `max_blocks` and resumed, and one with
              `pipeline=False`, write the uninterrupted store byte for byte
              (`store_digests`); the poisoned records quarantined with their
              typed reasons. `build_index` with its defaults (64 centroids,
              256-vector blocks, seed 0): `verify_index` ok, bytes ratio
              <= 0.30, recall@10 at nprobe 64 (a full probe) >= 0.95
              against float32 `exact_topk`. `Server(index=, nprobe=8)`
              bucketed and ragged (fp32 arm): 64 neighbours and the same 64
              embeds submitted before `start()`; each answer equals
              `lookup_one` over its own served embed vector bit for bit;
              graphs and pool equal the index-free server's; launches
              exactly the embed batches' (6 K1 or #3 + 6 K2); the outcome
              funnel; HTTP `/v1/neighbors` = in process, k=0 400; an index
              of another trunk -> TrunkMismatchError, none -> ValueError.
              Prints the map's sequences/s, residues/s, batches, busy share
              (a profiled 512-record run), commit_s and overlap_s; the
              build's host seconds, recall@10 at nprobe 8; the lookup's ms
              at Q=1 and lookups/s at Q=64 (nprobe 8 and 64); the served
              neighbours' p50 / p99 split into the embed leg and `lookup`.
              `large_int8_phase`, `# serve bucketed|ragged large[ int8]`:
              the `large` preset (12 blocks, C=G=1024, H=16) in bf16,
              buckets 256/512/1024, one batch class (max_batch 8), fp32 and
              int8 arms, 16 embed requests submitted before `start()`:
              exactly 12 #2 (ragged: #4) and 12 K2 (int8: K2-int8) per
              batch, none of the others; one full batch's replay equals its
              eager run bit for bit; the int8 answers off the fp32 ones by
              a finite nonzero amount (printed). Prints weight_bytes_ratio,
              the graphs' pool bytes and a full batch's wall and busy share.
9. rollout  — `rollout_phase`, `# rollout base ...`: the `base` trunk in
              bf16 on two bucketed replicas (buckets 128/256/512,
              max_batch 8, pipeline_depth 2), each behind
              `serve/http.make_http_server` on 127.0.0.1, a port
              `FleetRouter` over both, and a ragged and an int8 bucketed
              server in process. Candidates `near` (the trunk + 1e-6 x
              each leaf's RMS of seeded noise, kept where bf16 cannot see
              it; the literal 1e-6 trunk's parity is printed beside the
              resident trunk shadowing itself, which must be 0.0) and
              `far` (1e-1). On r0, the ragged and the int8 server
              (`arm_gates`): a lone live request and a shadow launch
              exactly 6 K1 + 6 K2 (ragged 6 #3 + 6 K2, int8 6 K1 + 6
              K2-int8); graphs, pool and every graph-read tensor's
              address unchanged across load, warm, shadows, flip and
              rollback; each shadow = its lone live request after the
              flip and each answer after the rollback = before the flip,
              bit for bit; the flip drops the whole cache. The typed
              refusals (CandidateUnfitError / HTTP 409 candidate_unfit at
              resident + candidate - 1 bytes, NoCandidateError / 409
              no_candidate, ValueError for a neighbors shadow). 256
              routed requests from 128 threads with both replicas flipped
              to `far` after 64 answers (`torn_batch_gate`): none fails,
              each answer is bit for bit one trunk's at its own bucket
              and batch class, and per replica no old answer follows a
              new one. `RolloutController(sample_every=2,
              window_requests=32, windows_required=3,
              shadow_parity_max=1e-3)` under routed traffic: `near`
              promotes (both /healthz show its fingerprint) and
              `breach()` restores the answers bit for bit; `far` is
              refused and unloaded everywhere. Launches exact at every
              step; every event stream strict. Prints the seconds of
              load, warm, flip and rollback, the weight bytes of each
              arm, a shadow's wall, the routed p50 / p99 with the mirror
              off and on, and the router's hop.
10. cli     — `cli_phase`, `# cli base ...`: the port's command line
              (`python -m proteinbert_tpu_torch`) at the `base` preset
              (`--set mesh.data=1`), seeded random weights: a flat NPZ
              through `import-weights` and back through `export-weights`
              bit for bit; `embed` and `predict-go` in this process (16
              proteins, batch 8: exactly 6 K1 + 6 K2 a batch, answers
              those of `inference.embed` / `predict_go` bit for bit);
              `map --fasta` in this process (384 proteins, buckets
              128/256/512: exactly 6 #3 + 6 K2 a packed batch) with `map
              --verify`, `index` and `index --verify` ok; `serve`
              bucketed and `--serve-mode ragged --quant int8` as
              subprocesses (36 lone HTTP requests each, answers within
              SERVE_EMBED_TOL of an in-process Server's on the same
              trunk, p50 / p99; SIGTERM -> exit 0, `serve_end{drained}`
              last); `fleet --replicas 2` (16 routed requests, SIGTERM ->
              exit 0); `embed` with CUDA_VISIBLE_DEVICES="" and no
              --device exits non-zero with the device message; `pretrain
              --set data.batch_size=8` as a subprocess alone on the card,
              SIGTERM after a few logged steps -> exit 75, resumed from
              the saved step -> exit 0, the median step ms. The
              subprocesses run from this checkout (PYTHONPATH) and load
              the kernels phase 1 built. The fleet's routed answers are
              held against the bucketed in-process Server's. A `# host
              census` opens the phase and closes the run: threads, live
              descendant processes and the CPU seconds each used over 2 s
              of idle, the machine's busy share, the card's SM clock.
11. data    — data parallelism (`data_phase`): (a) `pretrain(mesh=
              make_mesh(MeshConfig(data=1)))` over a one-rank NCCL group
              made in process, `base` at full width, dense, B=8 L=512, 6
              steps at a constant LR, in turns with the plain loop from the
              same seed (plain, data-parallel, data-parallel with
              zero_update, plain), deterministic algorithms on (cuDNN's
              default backward does not repeat itself): losses, params
              and moments bit for bit the plain loop's, exactly 6 K1 + 6 K2 launches a step, the
              step ms of each loop and the one-rank all-reduce's device ms
              from the profiler; with zero_update the JAX warning logged
              and the replicated update run; (b) `pretrain --multihost
              --preset base --set mesh.data=1 --set data.batch_size=8` as
              a subprocess with COORDINATOR_ADDRESS / NUM_PROCESSES /
              PROCESS_ID: the group forms over NCCL, 4 steps, exit 0, the
              run_start event carries the mesh and n_chips 1; `pretrain
              --preset base` alone exits 1 with the mesh message; (c) two
              spawned ranks on the one card over gloo (`data_rank`), `base`
              at MeshConfig(data=2), B=8 (4 a rank), the JAX ZeRO test's
              optimizer (LR 0, then 1e-4), 2 steps each of the
              replicated step, ZeRO-1 fp32, ZeRO-1 int8 and the replicated
              step again from one seed: the repeat bit for bit,
              ZeRO fp32 within 2e-6 and int8 within 1e-3 of the replicated
              params, int8's gradient-reduction wire bytes at most 0.27 of
              fp32's. `# data base ...` lines.
12. etl     — the corpus tools and the C++ tokenizer (`etl_phase`): (a)
              g++ builds the port's two native libraries (its version and
              each build's seconds; a library that does not build fails
              the phase); (b) a seeded UniRef90-shaped corpus of
              ETL_ENTRIES entries (lognormal lengths, median ~245, 0-7 GO
              terms a protein from a 3-level DAG of 600 terms): gzipped
              XML, OBO, FASTA wrapped at 60 columns, while a `--help`
              subprocess times a verb's start-up; (c) `create-uniref-db`
              as two task-array shards run together, `merge-uniref-dbs
              --num-shards 2 --go-meta-csv`, then a one-shard run: every
              table's rows, sorted, and the meta CSV equal; (d) the .fai
              by the C++ scanner and by the Python loop, the same bytes;
              (e) `create-h5` where h5py imports (else one line says so),
              and the join into the common-annotation columns in memory,
              equal to the HDF5 file's rows where there is one; (f) every
              row tokenized at seq_len 512 with a crop seed, C++ and numpy
              bit for bit; (g) `data-bench --preset base`, direct and
              prefetch, on the corpus where h5py imports, else the
              synthetic feed; (h) 6 base-width steps at B=8 from the
              corpus rows: exactly 6 K1 + 6 K2 launches a step, finite
              losses. Entries/s and peak RSS (each verb's VmHWM, or its
              resident size sampled every 10 ms) of each stage, ms of each
              tokenizer, batches/s, the median step ms. `# etl base ...`
              lines.
13. check   — the static analyzer and the profiling helpers
              (`check_phase`): (a) `python -m proteinbert_tpu_torch check
              --json` as a subprocess on this tree: exit 0, the six rules,
              no new finding, no stale baseline entry; its wall time from
              spawn and the analysis's own (the report's `seconds`); (b) a
              copy of the package (with tests/, chip_smoke.py and the
              observability doc) with a `time.perf_counter()` injected
              into K2's launch wrapper and a try/except falling back to
              K2's plain version in its route: the copy's own verb exits
              1 with exactly those `graph-purity` findings at those lines;
              (c) 6 base-width steps at B=8, L=512 under `TimeMeasure` and
              `Profiler.measure`: exactly 6 K1 + 6 K2 launches a step;
              then, each inside a `BoundaryStallMeter` boundary,
              `device_memory_report()` equal to torch.cuda's
              memory_allocated / max_memory_allocated and the card's total
              memory, and `monitor_memory` finding the base trunk's
              largest weight tensor at its nbytes. `# check base ...`
              lines.
14. mesh    — `large` widths (C=G=1024, H=16, A=8943, L=1024, global
              B=8) on ranks spawned on the one card, over gloo: (a) fsdp=2
              on two ranks, 3 bf16 steps at 3 of the 12 blocks
              (`MESH_BLOCKS`, as every bf16 leg here: a cut for the run's
              time) through `pretrain` (a constant LR of 2e-5 in every
              leg) (exactly 3 #2 + 3 K2 launches a step a rank; each rank's
              memory_allocated between steps within 3% + 256 MiB of
              `per_chip_state_bytes`, the fsdp share; step ms, the
              all-gather / reduce-scatter wire bytes a step), then 3
              float32 steps at depth 2 under deterministic cuDNN with a
              checkpoint at step 2, whose losses must be the one-process
              loop's on the same rows within 2e-5; the same two ranks then
              train with ZeRO-1 and the quantized reduce-scatter
              (`grad_reduce_dtype` int8, then bf16) at 3 blocks, 3
              bf16 steps through `pretrain` (the launch and state-byte
              gates of the fp32 leg; gradient-reduction wire bytes at
              most 0.27 / 0.52 of the fp32 reduce-scatter's), and at
              depth 2 in float32, 2 steps of the fp32 sharded step and of
              each payload (fp32, bf16, int8) from one seed: each
              payload's params within 1e-6 / 5e-4 / 1e-3 of the fp32
              step's, its gradient norms within 1e-6 / 2e-4 / 5e-4 and
              each leaf's first moments within 1e-6 / 5e-3 / 2.5e-2 of
              that step's (relative), the ranks alike; (b) model=3 on three
              ranks, 3 bf16 steps at 3 blocks: 2981 GO columns a rank,
              the replicated leaves' digests equal across ranks after the
              steps, the losses the one-process loop's within 5e-3, then 3
              float32 steps at depth 2 within 2e-5 of one process; (c)
              the float32 run's checkpoint through `python -m
              proteinbert_tpu_torch reshard --target-mesh 1` as a
              subprocess (exit 0, parity true, a valid `reshard` event),
              resumed by one process on the card: its step 3 the fsdp
              run's within 2e-5; (d) the sequence-parallel step on the
              sharded layout, fsdp=2 x seq=2 on four ranks: 3 bf16 steps
              at 3 blocks with the identity corruption (exactly 3
              prehaloed #2 launches a step a rank and no other kernel,
              the state-byte gate with `per_chip_state_bytes` the fsdp=2
              leg's, losses the one-process loop's within 5e-3), then 3
              float32 steps at depth 2 within 2e-5 of one process, its
              step 2 through `reshard --target-mesh 1` and resumed as in
              (c); (e) model=3 x seq=2 on six ranks, 3 float32 steps at
              depth 2 within 2e-5 of one process, 2981 GO columns stored
              a rank, one digest of the replicated leaves on the six
              ranks. One spawn of six processes runs the legs in turn,
              each on a gloo group of its own (one start-up for all), and
              the two reshards run side by side while this process runs
              the one-process references. `# mesh large ...` lines.
15. eval    — the trainer's eval bracket (`eval_phase`): `base` at full
              width, bf16, B=8 L=512, deterministic cuDNN, 30 steps logged
              every 5 with an eval of 8 batches of 8x512 every 10, the same
              seeded run on the synchronous bracket, on the overlapped one
              (its dispatch under `torch.cuda.set_sync_debug_mode("error")`),
              after one untimed eval that warms the eval shapes: the
              records and `eval` events bit for bit the synchronous run's,
              exactly 6·(30 + 3·8) K1 and K2 launches a run; each bracket's
              host seconds, wall to the next step's `timer.update()`, eval
              device ms (CUDA events) and host waits, the discounted
              seconds, the median step ms and the window rates. Drills in
              the same process: `PBT_FAULT_STALL_AT=15:2` makes the 11-15
              window the slowest, more than 1.5 s over the median;
              `PBT_FAULT_EVAL_STALL=2` leaves every window within 1.5x the
              median on either bracket. `# eval base ...` lines.
16. coverage — every model shape the JAX package runs (`coverage_phase`):
              (a) K2 at every (key_dim, value_dim) in {16, 32, 64, 128} x
              {32, 64, 128, 256} (B=8, L=512, C=G=512, dense and S=8, bf16
              timed, float32 checked, int8 legs exactly their fp legs)
              and at C=32 and 96 (L=128: the `tiny` preset's attention),
              #6 at the transfer `small` geometry (C=128, G=256, k=32, H=4),
              K1, its prehaloed entry, #3 and #6 at C=384, each against
              its plain version with its existing tolerance and exactly
              one launch a call; (b) `pretrain --preset tiny` through the
              CLI (the loss falls) and a served batch from its run: the
              local track's and one-pass decisions
              reference/unsupported_shape, the attention's pallas/dense
              (counters, stats(), the registry), K2 once a block a counted
              forward and no other kernel, the reference route inside the
              captured graph; (c) the `small` geometry:
              one served batch and one train step on #6 only; (d) a
              2-block base-like model at C=384: a served batch at the 256
              bucket on #6, a train step at L=512 on K1 + K2. `# coverage
              ...` lines.
17. report  — the kernel JSON line (each kernel's row carries its
              coverage instantiations under "widths"), the card's name and
              power limit, and the result line {"ok": true, "device":
              {...}} last.

`--phase large` runs the build, the SASS check, the Large-width kernel
phases (#2, #4, K2 at Large width with its passes, the prehaloed entries)
and the yardstick, and prints no result line. `--phase base` (or its
older name `--phase k2`) runs the build and `base_phase`: the wall, host
enqueue time and device time by pass of K1, K1's prehaloed entry, #3,
#3-int8 and K2 (and K2-int8) at the kernel table's shapes, no gate and no
result line; it also runs on the parent commit's package, so one call can
time both. `--phase default` does the same for #6 and #6-int8 in bf16
(`default_phase`: B=8, C=128, G=512, H=4, v=128 at L=512 and L=128, dense
and S=8, and C=512, H=4, L=128, S=8), each beside the composition K1 or
#3, then K2, on the same inputs. `--phase f32` does the same in float32
at the presets' geometry (`f32_phase`), for the float32 plans. `--phase
resume` runs the build and
`resume_phase` alone: its gates and the boundary's numbers, no result
line. `--phase serve` runs the build and phase 4 alone, every gate, no
result line; `--phase serve-times` runs phase 4's six servers with their
launch gates and numbers but without the replay, depth, event and HTTP
gates, which need this tree's package, so it also runs on a parent
commit's package (copy this script into its `git archive`).
`--phase finetune` runs the build and phase 7 alone, every gate, no
result line. `--phase neighbors` runs the build and phase 8 alone
(`neighbors_phase`, then `large_int8_phase`), every gate, no result
line. `--phase rollout` runs the build and phase 9 alone, every gate, no
result line. `--phase cli` runs the build and phase 10 alone, every gate,
no result line. `--phase data` runs the build and phase 11 alone, every
gate, no result line. `--phase etl` runs the build and phase 12 alone,
every gate, no result line. `--phase check` runs the build and phase 13
alone, every gate, no result line. `--phase mesh` runs the build and
phase 14 alone, every gate, no result line; `--phase eval` phase 15;
`--phase coverage` phase 16. `--cli-first` is the full run with phase 10
run once more
right after the build, its launches not counted, so that the phase's
numbers first and last in one process stand side by side.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (dense): bf16 tensor cores, float32 CUDA cores,
# HBM bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Tolerances of kernel vs plain on the card. float32: both sum the same
# float32 products in another order (thousands of terms per output, then
# LayerNorm). bfloat16: both round at the same points, but a sum that lands
# next to a rounding boundary can round the other way, and a flipped x1 or
# softmax weight moves the output by about one bf16 step of its magnitude;
# outputs are LayerNorm-scaled (|y| < 8), where a bf16 step is 2^-5.
# #3 and #6 share K1's local-track arithmetic; #6's attention reads its own
# local output, so a flipped bf16 step there moves the attention by about
# as much as a flipped step of the local track moves the track.
TOL = {("local_track", torch.float32): 1e-4,
       ("local_track", torch.bfloat16): 0.0625,
       ("global_attention", torch.float32): 1e-4,
       ("global_attention", torch.bfloat16): 0.03125,
       ("local_track_segments", torch.float32): 1e-4,
       ("local_track_segments", torch.bfloat16): 0.0625,
       ("one_pass", torch.float32): 1e-4,
       ("one_pass", torch.bfloat16): 0.0625,
       ("local_track_tiled", torch.float32): 1e-4,
       ("local_track_tiled", torch.bfloat16): 0.0625,
       ("local_track_segments_tiled", torch.float32): 1e-4,
       ("local_track_segments_tiled", torch.bfloat16): 0.0625}
# The prehaloed entries run K1's and #2's device code: their tolerances.
for _dtype in (torch.float32, torch.bfloat16):
    TOL[("local_track_valid", _dtype)] = TOL[("local_track", _dtype)]
    TOL[("local_track_tiled_valid", _dtype)] = TOL[("local_track_tiled",
                                                     _dtype)]
# An int8 leg against its plain version: the fp leg's tolerance (it must
# give exactly the fp leg's output on the dequantized weights).
for _name in ("local_track_segments", "global_attention", "one_pass"):
    for _dtype in (torch.float32, torch.bfloat16):
        TOL[(_name + "_q8", _dtype)] = TOL[(_name, _dtype)]
# Gradients through a kernel's autograd Function against float32 autograd
# of the reference its backward differentiates, on the same inputs cast up.
# fp32: the largest |diff| as a share of the largest |grad| (the same sums,
# in cuDNN's and cuBLAS's order). bf16: the largest over inputs of
# ||g_bf16 - g_fp32|| / ||g_fp32||, the measure and limit of
# tests/test_torch_grads_dtype.py (about eight bf16 ulps): a bf16 backward
# rounds its recomputed activations, products and GELU chain rule, which
# moves each grad by about 1% in norm (0.67-1.26% on the CPU at these
# shapes).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
STEP_LOSS_TOL = 1e-4   # 2-block fp32 train step, card vs CPU plain path
STEP_GRAD_TOL = 1e-3
SOLO_LOSS_TOL = 1e-4   # fp32 per-segment loss terms, packed vs alone
# A resumed run's losses against the uninterrupted run's, relative to
# max(1, |loss|): the restored state is bit for bit the saved one, but
# cuDNN's backward convolutions may pick non-deterministic algorithms, so
# two runs of the same steps may differ in the last bits of the grads.
RESUME_LOSS_TOL = 1e-3
# A resumed run's final state against the uninterrupted run's, and a
# staged checkpoint against a synchronous one of the same step in another
# run (`state_drift`: the params' update, each Adam moment, the plateau's
# loss averages, each relative). Zeroing the moments on restore lands far
# beyond it (the `resume` phase checks that too).
RESUME_STATE_TOL = 1e-2
# GPU clock cycles of `torch.cuda._sleep` that hold the train stream
# about 1 s in `staged_ordering_check` (H100 SXM: up to 1.98 GHz).
SLEEP_CYCLES = 2_000_000_000
# Device-code names of the hand-written kernels, as the profiler lists them.
KERNEL_NAMES = ("local_track_kernel", "attention_kernel", "onepass",
                "tiled_conv_kernel", "wgmma_conv_kernel",
                "wgmma_conv_any_kernel",
                "tiled_finish_kernel", "wgmma_finish_kernel",
                "dequant_track_kernel", "attn_query_kernel",
                "wgmma_attn_kernel", "attn_softmax_kernel",
                "dequant_kv_kernel")
# The passes of one call, by the profiler's kernel names: the local track
# in bf16 (K1, its prehaloed entry, #3, #2, #4: conv, finish; #3-int8 also
# its dequantize pass; K1 and #3 before their Hopper passes, and float32,
# the one-launch plan) and K2 in bf16 (query, projection, softmax; the int8
# leg also its dequantize pass; float32, and K2 before its Hopper passes,
# the one-block-per-(head, row) plan). The conv pass is `wgmma_conv_kernel`
# at the presets' taps and `wgmma_conv_any_kernel` at any other.
TRACK_PASSES = (("conv pass", "conv_"), ("finish pass", "finish_kernel"),
                ("dequantize", "dequant_track_kernel"),
                ("one-launch plan", "local_track_kernel"))
K2_PASSES = (("query", "attn_query_kernel"),
             ("projection", "wgmma_attn_kernel"),
             ("softmax", "attn_softmax_kernel"),
             ("dequant", "dequant_kv_kernel"),
             ("one-block plan", "attention_kernel"))
# #6's passes in bf16 (PR 10: the int8 leg's dequantize pass, query and
# mask ids, conv, finish, projection, softmax); before PR 10, and in
# float32, the one-launch cluster plan.
ONEPASS_PASSES = (("dequantize", "onepass_dequant_kernel"),
                  ("query", "onepass_query_kernel"),
                  ("conv", "conv_"),
                  ("finish", "finish_kernel"),
                  ("projection", "wgmma_attn_kernel"),
                  ("softmax", "attn_softmax_kernel"),
                  ("cluster plan", "onepass_kernel"))
# The Large steps, dense and packed, as this script measured them when the
# kernels' backward still recomputed in float32 (NVIDIA H100 80GB HBM3,
# 700.00 W): one profiled step's ms, its forward, backward and optimizer
# ms, the median step ms, peak GB.
F32_BACKWARD_LARGE = {"large": (539.2, 51.2, 456.8, 29.8, 531.7, 11.22),
             "large packed": (473.1, 66.2, 381.8, 23.3, 474.4, 14.90)}
REF_TOL = 1e-3        # float32 trunk, 2 blocks: kernels vs CPU plain path
RAGGED_TOL = 1e-3     # float32 trunk, 2 blocks: ragged vs bucketed answers
SERVE_EMBED_TOL = 0.05  # bf16 trunk: served batch row vs the row run alone
BUCKETS = (128, 256, 512)
# The rollout phase's candidates: the resident trunk plus this many times
# each leaf's RMS of seeded noise.
ROLLOUT_NEAR = 1e-6
ROLLOUT_FAR = 1e-1
REPS = 25
DEVICE = "cuda"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median of REPS single-call CUDA-event timings, after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_ops(B: int, L: int, C: int, G: int, S: int, H: int,
                  k: int) -> int:
    """The operations K2 needs at S segments: the TPU kernel's count
    (`attention_flops`) at S=1, whose score and weighted-sum products take
    each position once, plus each further segment's query. A position lies
    in at most one segment, so the TPU kernel's S-1 other scores a position
    are masked away: needed by no output, they are not counted."""
    from proteinbert_tpu_torch.kernels.attention import attention_flops
    return attention_flops(B, L, C, G, 1, H, k) + 2 * B * H * (S - 1) * G * k


def onepass_ops(B: int, L: int, C: int, G: int, S: int, H: int,
                k: int, narrow_taps: int = 9, wide_taps: int = 9) -> int:
    """#6's needed operations at S segments, counted as `attention_ops`
    (the track's convs at their own taps)."""
    from proteinbert_tpu_torch.kernels.one_pass import onepass_flops
    return (onepass_flops(B, L, C, G, 1, H, k, narrow_taps, wide_taps)
            + 2 * B * H * (S - 1) * G * k)


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def device_ms_by_name(fn, reps: int = 10, tries: int = 3) -> dict:
    """Device ms per call of each kernel `fn` launches, by name, from
    torch.profiler over `reps` calls after a warm one; {} where the
    profiler records no device time in `tries` attempts (it now and then
    records none for one window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms = (e.time_range.end - e.time_range.start) / 1e3 / reps
                by_name[e.name] = by_name.get(e.name, 0.0) + ms
        if by_name:
            break
    return by_name


def print_passes(card: str, label: str, fn, passes=TRACK_PASSES,
                 reps: int = 10) -> None:
    """The device ms per call of each pass of one kernel call (#2 / #4:
    conv and finish; K2: `K2_PASSES`) by the profiler's kernel names, and
    their sum, over `reps` calls."""
    by_name = device_ms_by_name(fn, reps)
    if not by_name:
        print(f"# passes {label}: the profiler recorded no device time "
              "(not measured)")
        return
    split = {}
    for name, ms in by_name.items():
        m = re.search(r"(\w+_kernel)\b", name)
        short = m.group(1) if m else name[:40]
        split[short] = split.get(short, 0.0) + ms
    got = {label_: sum(ms for n, ms in split.items() if key in n)
           for label_, key in passes}
    got = {k: v for k, v in got.items() if v > 0}
    device = sum(got.values())
    names = ", ".join(f"{n} {ms:.4f}" for n, ms in sorted(split.items()))
    shown = ", ".join(f"{k} {v:.4f} ms" for k, v in got.items())
    print(f"# passes {label} [{card}]: {shown} per call; device "
          f"{device:.4f} ms (torch.profiler, {reps} calls: {names})")


def enqueue_us(fn, n: int = 50) -> float:
    """The host's time to issue one call: n calls without a sync (the card
    is faster than the host here, so none waits on it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def output_digest(out) -> str:
    """The first 16 hex digits of the sha256 of an output's bytes (a
    tensor or a tuple of them): two packages' outputs on the same inputs
    are bit for bit equal where their digests are."""
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def print_timed(card: str, tag: str, label: str, fn, passes) -> None:
    """One call's wall ms, host enqueue time, output digest and device ms
    by pass."""
    print(f"# {tag} {label}: wall {time_ms(fn):.4f} ms, host enqueue "
          f"{enqueue_us(fn):.1f} us a call, output sha256 "
          f"{output_digest(fn())} [{card}]")
    print_passes(card, label, fn, passes)


def ptxas_functions(log: str):
    """(kernel name and template arguments, registers, spill-store bytes)
    for each entry function `nvcc -Xptxas -v` reported."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.match(r"_ZN3pbt\d+(\w+?_kernel)(I\w*?E)?", m.group(1))
            name = "".join(k.groups("")) if k else m.group(1)[:48]
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def sass_line(card: str, kernels) -> None:
    """The wgmma and TMA instructions `cuobjdump -sass` finds in each
    library; every one must have both (K1, #3, #2, #4, their prehaloed
    entries and int8 leg, both K2 entries)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("# SASS: not checked (the toolkit has no cuobjdump)")
        return
    for k in kernels:
        sass = subprocess.run([tool, "-sass", str(k.library_path())],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        hgmma, utmaldg = sass.count("HGMMA"), sass.count("UTMALDG")
        print(f"# SASS {k.name}: HGMMA {hgmma}, UTMALDG {utmaldg} [{card}]")
        check(hgmma > 0 and utmaldg > 0,
              f"{k.name}: no wgmma or no TMA load in its SASS")


def gemm_yardstick(card: str) -> None:
    """One equal-FLOP torch.matmul yardstick for #2 / #4 at B=8, L=C=1024
    bf16: (B·L, 9C)·(9C, C) twice plus (B·L, C)·(C, C). A GEMM yardstick,
    not a library time for the function: the port never calls it."""
    B, L, C = 8, 1024, 1024
    gen = torch.Generator().manual_seed(71)
    dev = torch.device(DEVICE)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    a, w, a2, w2 = rand(B * L, 9 * C), rand(9 * C, C), rand(B * L, C), \
        rand(C, C)
    ms = time_ms(lambda: (a @ w, a @ w, a2 @ w2))
    flops = 2 * B * L * C * C * 19
    print(f"# GEMM yardstick (equal FLOPs, not the function; the port "
          f"never calls it): torch.matmul (B*L, 9C)@(9C, C) x2 + (B*L, "
          f"C)@(C, C), bf16, B=8 L=C=1024: {ms:.4f} ms, "
          f"{flops / ms / 1e9:.1f} TFLOP/s [{card}]")


# ------------------------------------------------------------ phase 2

def kernel_phase(card: str):
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK, TRACK_PARAMS, attention_oh_reference,
        fused_global_attention, fused_local_track, fused_packed_attention,
        local_track_reference,
    )
    from proteinbert_tpu_torch.kernels.attention import attention_flops
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )

    cfg = get_preset("base").model
    gen = torch.Generator().manual_seed(1)
    dev = torch.device(DEVICE)
    block = to_device(block_init(gen, cfg), dev)
    C, G, H, k = cfg.local_dim, cfg.global_dim, cfg.num_heads, cfg.key_dim
    B = 8
    rows = {}
    print(f"# kernels vs plain on {card}: torch.backends.cuda.matmul."
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        # Weights in the activation dtype once, as the model's forward
        # casts them (LN vectors stay float32).
        cast = cast_block(block, dtype)
        track = {name: cast[name] for name in TRACK_PARAMS}
        attn = cast["attention"]
        for L in (128, 512):
            x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
            bc = torch.randn((B, C), generator=gen).to(dev, dtype)
            got = fused_local_track(track, x, bc, 1, cfg.wide_dilation)
            want = local_track_reference(track, x, bc, 1, cfg.wide_dilation)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(torch.isfinite(got).all().item(), "local_track non-finite")
            nbytes = (2 * B * L * C + B * C + 19 * C * C) * s + 7 * C * 4
            b_ms, b_by = bound(local_track_flops(B, L, C), nbytes, dtype)
            n0 = LOCAL_TRACK.launches
            fused_local_track(track, x, bc, 1, cfg.wide_dilation)
            per_call = LOCAL_TRACK.launches - n0
            check(per_call == 1, f"local_track launched {per_call} times "
                                 "in one call")
            ms = time_ms(lambda: fused_local_track(track, x, bc, 1,
                                                   cfg.wide_dilation))
            plain = time_ms(lambda: local_track_reference(
                track, x, bc, 1, cfg.wide_dilation))
            rows[("local_track", dtype, L, "dense")] = (
                err, ms, plain, b_ms, b_by, per_call)
            if dtype == torch.bfloat16 and L == 512:
                print_passes(card, "local_track bf16 B=8 L=512 C=512",
                             lambda: fused_local_track(track, x, bc, 1,
                                                       cfg.wide_dilation))

            g = torch.randn((B, G), generator=gen).to(dev, dtype)
            pad = torch.ones((B, L), dtype=torch.bool, device=dev)
            pad[1, L // 2:] = False   # half-padded row
            pad[2, :] = False         # all-pad row: uniform softmax
            oh = pad[..., None].float()
            got = fused_global_attention(attn, x, g, pad)
            want = attention_oh_reference(attn, x, g[:, None, :], oh,
                                          zero_empty=False).reshape(B, G)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(torch.isfinite(got).all().item(), "attention non-finite")
            nbytes = ((B * L * C + B * G * 2 + H * (G * k + 2 * C * k)) * s
                      + B * L)
            b_ms, b_by = bound(attention_flops(B, L, C, G, 1, H, k), nbytes,
                               dtype)
            n0 = ATTENTION.launches
            fused_global_attention(attn, x, g, pad)
            per_call = ATTENTION.launches - n0
            check(per_call == 1, f"global_attention launched {per_call} "
                                 "times in one call")
            ms = time_ms(lambda: fused_global_attention(attn, x, g, pad))
            plain = time_ms(lambda: attention_oh_reference(
                attn, x, g[:, None, :], oh, zero_empty=False))
            rows[("global_attention", dtype, L, "dense")] = (
                err, ms, plain, b_ms, b_by, per_call)
            if dtype == torch.bfloat16 and L == 512:
                print_passes(card, "global_attention bf16 B=8 L=512 C=G=512 "
                                   "H=8 dense",
                             lambda: fused_global_attention(attn, x, g, pad),
                             K2_PASSES)

            # S=8 packed rows, segment 8 empty everywhere: exact zeros.
            S = 8
            seg = torch.randint(0, S, (B, L), generator=gen).to(dev)
            gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
            got = fused_packed_attention(attn, x, gs, seg)
            ids = torch.arange(1, S + 1, device=dev)
            oh = (seg[..., None] == ids).float()
            want = attention_oh_reference(attn, x, gs, oh)
            torch.cuda.synchronize()
            check(bool((got[:, S - 1] == 0).all()),
                  "empty segment not exactly zero")
            err = (got.float() - want.float()).abs().max().item()
            nbytes = ((B * L * C + 2 * B * S * G + H * (G * k + 2 * C * k))
                      * s + B * L * seg.element_size())
            b_ms, b_by = bound(attention_ops(B, L, C, G, S, H, k), nbytes,
                               dtype)
            n0 = ATTENTION.launches
            fused_packed_attention(attn, x, gs, seg)
            per_call = ATTENTION.launches - n0
            check(per_call == 1, f"packed global_attention launched "
                                 f"{per_call} times in one call")
            ms = time_ms(lambda: fused_packed_attention(attn, x, gs, seg))
            plain = time_ms(lambda: attention_oh_reference(attn, x, gs, oh))
            rows[("global_attention", dtype, L, "S=8")] = (
                err, ms, plain, b_ms, b_by, per_call)
            if dtype == torch.bfloat16 and L == 512:
                print_passes(card, "global_attention bf16 B=8 L=512 C=G=512 "
                                   "H=8 S=8",
                             lambda: fused_packed_attention(attn, x, gs, seg),
                             K2_PASSES)

    # The kernels' narrower widths, with a ragged last tile (L=100 is a
    # multiple of neither kernel's row tile): correctness only.
    for width in (128, 256):
        small = dataclasses.replace(cfg, local_dim=width, global_dim=width,
                                    num_heads=width // k)
        blk = to_device(block_init(gen, small), dev)
        for dtype in (torch.bfloat16, torch.float32):
            cast = cast_block(blk, dtype)
            track = {name: cast[name] for name in TRACK_PARAMS}
            x = torch.randn((2, 100, width), generator=gen).to(dev, dtype)
            bc = torch.randn((2, width), generator=gen).to(dev, dtype)
            g = torch.randn((2, width), generator=gen).to(dev, dtype)
            pad = torch.ones((2, 100), dtype=torch.bool, device=dev)
            pad[1, 60:] = False
            got = fused_local_track(track, x, bc, 1, small.wide_dilation)
            want = local_track_reference(track, x, bc, 1, small.wide_dilation)
            got2 = fused_global_attention(cast["attention"], x, g, pad)
            want2 = attention_oh_reference(
                cast["attention"], x, g[:, None, :], pad[..., None].float(),
                zero_empty=False).reshape(2, width)
            torch.cuda.synchronize()
            for name, a, b in (("local_track", got, want),
                               ("global_attention", got2, want2)):
                err = (a.float() - b.float()).abs().max().item()
                rows[(name, dtype, 100, f"C={width}")] = (
                    err, None, None, None, None, None)

    return rows


# The head widths and the width the coverage phase checks: K2 and
# #6 at every (key_dim, value_dim) pair of their bf16 instantiations, and
# K1, its prehaloed entry, #3 and #6 at C=384.
COVER_KEY_DIMS = (16, 32, 64, 128)
COVER_VALUE_DIMS = (32, 64, 128, 256)
# Widths off those powers of two (multiples of 8: k=8, v=8 is the CPU
# tests' small geometry): the query pass's idle threads, the softmax's
# idle columns, the float32 plan's cut 32-column blocks.
COVER_EXTRA_PAIRS = ((8, 8), (48, 96), (24, 40))
COVER_TINY_STEPS = 40
# K2 below C=128 (C, G, H, key_dim): the `tiny` preset's attention and a
# width with a partial 64-channel chunk.
COVER_NARROW = ((32, 128, 4, 32), (96, 256, 4, 32))


def coverage_kernel_phase(card: str) -> dict:
    """`--phase coverage` (a): each new instantiation against its plain
    version on the same inputs, with the tolerance its existing rows use,
    exact launches (one a call), and each int8 leg exactly (0.0) its fp
    leg on the dequantized weights. K2 (B=8, L=512, C=G=512, H = 512 / v)
    at every (k, v) pair, and at C=32 and 96 (L=128, `COVER_NARROW`),
    dense and S=8, bf16 timed and float32 checked;
    #6 at the transfer `small` geometry (C=128, G=256, H=4, k=32, v=64),
    dense and S=8, L=512; K1, its prehaloed entry (L=512 + 2*20) and #3
    (S=8) at C=384, B=8, L=512, and #6 at C=384 (G=512, H=8, k=64) at
    L=256 in bf16 and L=128 in float32. Returns {(kernel, shape label):
    (err, ms, plain ms, bound ms, bound by, launches, int8 exact, int8 ms)};
    ms are None where not timed."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_Q8, LOCAL_TRACK_VALID, ONEPASS, ONEPASS_Q8,
        attention_oh_reference, fused_global_attention, fused_local_track,
        fused_local_track_segments, fused_local_track_valid,
        fused_packed_attention, local_track_reference,
        local_track_segment_oh_reference, local_track_valid_reference,
        onepass_oh_reference, segment_one_hot, track_halo,
    )
    from proteinbert_tpu_torch.kernels.attention import attention_flops
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.kernels.one_pass import fused_onepass

    base = get_preset("base").model
    gen = torch.Generator().manual_seed(41)
    dev = torch.device(DEVICE)
    bf16, f32 = torch.bfloat16, torch.float32
    wd = base.wide_dilation
    rows = {}

    def rand(*shape, dtype=f32):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def seg_ids(B, L, S):
        seg = torch.randint(0, S, (B, L), generator=gen).to(dev)
        return seg  # segment S never appears: an empty one

    def run_case(kernel, name, dtype, label, run, plain, flops, nbytes,
                 q8=None, timed=True, tpu_flops=None):
        """`run` the kernel's wrapper, `plain` its plain version; `q8` (the
        int8 leg's (kernel, run)) must give exactly `run`'s output.
        `flops` is the work the function needs; `tpu_flops`, where given,
        the TPU kernel's own count, reported beside the bound as a second
        bound of its own."""
        def tup(o):
            return o if isinstance(o, tuple) else (o,)
        got, want = tup(run()), tup(plain())
        torch.cuda.synchronize()
        tag = f"{name} {str(dtype)[6:]} {label}"
        check(all(torch.isfinite(t).all().item() for t in got),
              f"{tag}: non-finite")
        check(all(a.shape == b.shape for a, b in zip(got, want)),
              f"{tag}: shapes {[tuple(t.shape) for t in got]} vs "
              f"{[tuple(t.shape) for t in want]}")
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        tol = TOL[(kernel.name, dtype)]
        check(err <= tol, f"{tag}: max |kernel - plain| {err} > {tol}")
        n0 = kernel.launches
        run()
        per_call = kernel.launches - n0
        check(per_call == 1, f"{tag}: {per_call} launches in one call")
        exact, q_ms = None, None
        if q8 is not None:
            qk, q_run = q8
            got_q = tup(q_run())
            torch.cuda.synchronize()
            exact = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(got_q, got))
            check(exact == 0.0, f"{tag}: int8 leg vs fp leg on the "
                                f"dequantized weights max |diff| {exact}")
            n0 = qk.launches
            q_run()
            check(qk.launches - n0 == 1, f"{tag}: int8 leg launched "
                                         f"{qk.launches - n0} times")
            if timed:
                q_ms = time_ms(q_run)
        ms = plain_ms = b_ms = b_by = tpu_ms = None
        if timed:
            ms, plain_ms = time_ms(run), time_ms(plain)
            b_ms, b_by = bound(flops, nbytes, dtype)
            if tpu_flops is not None:
                tpu_ms = bound(tpu_flops, nbytes, dtype)[0]
        rows[(name, label + ("" if dtype == bf16 else " fp32"))] = (
            err, ms, plain_ms, b_ms, b_by, per_call, exact, q_ms, tpu_ms)
        print(f"# coverage {tag} [{card}]: max |kernel - plain| {err:.3g} "
              f"(tol {tol}), {per_call} launch a call"
              + ("" if ms is None else
                 f", {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                 f"{b_ms:.4f} ms by {b_by}"
                 + ("" if tpu_ms is None else
                    f"; by the TPU kernel's count {tpu_ms:.4f} ms") + ")")
              + ("" if exact is None else
                 f"; int8 leg exact {exact}"
                 + ("" if q_ms is None else f", {q_ms:.4f} ms")))

    def k2_cases(B, L, C, G, H, k, label):
        v = G // H
        cfg = dataclasses.replace(base, local_dim=C, global_dim=G,
                                  key_dim=k, num_heads=H)
        for dtype in (bf16, f32):
            _, qattn, _, attn = q8_block(gen, cfg, dtype)[:4]
            s = dtype.itemsize
            x = rand(B, L, C, dtype=dtype)
            g = rand(B, G, dtype=dtype)
            pad = torch.ones((B, L), dtype=torch.bool, device=dev)
            pad[1, L // 2:] = False
            pad[2, :] = False
            oh = pad[..., None].float()
            wbytes = H * (G * k + C * k + C * v) * s
            run_case(
                ATTENTION, "global_attention", dtype, f"{label} dense",
                lambda: fused_global_attention(attn, x, g, pad),
                lambda: attention_oh_reference(
                    attn, x, g[:, None, :], oh,
                    zero_empty=False).reshape(B, G),
                attention_flops(B, L, C, G, 1, H, k),
                (B * L * C + 2 * B * G) * s + wbytes + B * L * 4,
                q8=(ATTENTION_Q8, lambda: fused_global_attention(
                    qattn, x, g, pad)),
                timed=dtype == bf16)
            S = 8
            seg = seg_ids(B, L, S)
            gs = rand(B, S, G, dtype=dtype)
            oh8 = segment_one_hot(seg, S)
            run_case(
                ATTENTION, "global_attention", dtype, f"{label} S=8",
                lambda: fused_packed_attention(attn, x, gs, seg),
                lambda: attention_oh_reference(attn, x, gs, oh8),
                attention_ops(B, L, C, G, S, H, k),
                (B * L * C + 2 * B * S * G) * s + wbytes + B * L * 8,
                q8=(ATTENTION_Q8, lambda: fused_packed_attention(
                    qattn, x, gs, seg)),
                timed=dtype == bf16)

    # K2 at every (k, v) pair (G = 512, or H·v just below it).
    B, L, C = 8, 512, 512
    pairs = [(k, v) for k in COVER_KEY_DIMS for v in COVER_VALUE_DIMS]
    for k, v in pairs + list(COVER_EXTRA_PAIRS):
        H = 512 // v
        k2_cases(B, L, C, H * v, H, k, f"k={k} v={v} H={H}")
    # K2 at C below 128 (a multiple of 32), at tiny's bucket L=128: the
    # `tiny` preset's attention (C=32: half of one 64-channel TMA chunk,
    # zero-filled) and C=96 (one chunk and a zero-filled half).
    for C, G, H, k in COVER_NARROW:
        k2_cases(B, 128, C, G, H, k,
                 f"C={C} G={G} k={k} v={G // H} H={H} L=128")

    def onepass_cases(cfg, L, dtypes, label):
        C, G, H, k = (cfg.local_dim, cfg.global_dim, cfg.num_heads,
                      cfg.key_dim)
        v = G // H
        for dtype in dtypes:
            qtrack, qattn, track, attn = q8_block(gen, cfg, dtype)[:4]
            s = dtype.itemsize
            x = rand(B, L, C, dtype=dtype)
            for S, packed in ((1, False), (8, True)):
                bc = rand(B, S, C, dtype=dtype)
                gs = rand(B, S, G, dtype=dtype)
                seg = seg_ids(B, L, S) if packed else None
                real = torch.ones((B, L), dtype=torch.bool, device=dev)
                real[1, L // 2:] = False
                oh = (segment_one_hot(seg, S) if packed
                      else torch.ones((B, L, 1), device=dev))
                wbytes = (19 * C * C + H * (G * k + C * k + C * v)) * s

                def run(tr=track, at=attn):
                    return fused_onepass(tr, at, x, bc, gs, seg, real, 1,
                                         wd, packed)
                run_case(
                    ONEPASS, "one_pass", dtype,
                    f"{label} {'S=8' if packed else 'dense'}", run,
                    lambda: onepass_oh_reference(
                        track, attn, x, bc, gs, oh, real[..., None].float(),
                        1, wd, packed, packed),
                    onepass_ops(B, L, C, G, S, H, k),
                    (2 * B * L * C + 2 * B * S * G + B * S * C) * s + wbytes
                    + 2 * B * L * 4,
                    q8=(ONEPASS_Q8, lambda: run(qtrack, qattn)),
                    timed=dtype == bf16)

    # #6 at the transfer `small` geometry (k=32).
    small = dataclasses.replace(base, local_dim=128, global_dim=256,
                                key_dim=32, num_heads=4)
    onepass_cases(small, 512, (bf16, f32), "C=128 G=256 H=4 k=32 v=64 L=512")

    # K1, its prehaloed entry and #3 at C=384.
    C = 384
    w384 = dataclasses.replace(base, local_dim=C)
    for dtype in (bf16, f32):
        qtrack, _, track, _ = q8_block(gen, w384, dtype)[:4]
        s = dtype.itemsize
        x = rand(B, L, C, dtype=dtype)
        bc = rand(B, C, dtype=dtype)
        tbytes = 19 * C * C * s + 7 * C * 4
        run_case(LOCAL_TRACK, "local_track", dtype, "C=384 L=512 dense",
                 lambda: fused_local_track(track, x, bc, 1, wd),
                 lambda: local_track_reference(track, x, bc, 1, wd),
                 local_track_flops(B, L, C),
                 (2 * B * L * C + B * C) * s + tbytes,
                 timed=dtype == bf16)
        halo = track_halo(track, 1, wd)
        xh = rand(B, L + 2 * halo, C, dtype=dtype)
        run_case(LOCAL_TRACK_VALID, "local_track_valid", dtype,
                 "C=384 L=512+2*20 shard",
                 lambda: fused_local_track_valid(track, xh, bc, 1, wd),
                 lambda: local_track_valid_reference(track, xh, bc, 1, wd),
                 local_track_flops(B, L, C),
                 (B * (2 * L + 2 * halo) * C + B * C) * s + tbytes,
                 timed=dtype == bf16)
        S = 8
        seg = seg_ids(B, L, S)
        bs = rand(B, S, C, dtype=dtype)
        run_case(LOCAL_TRACK_SEGMENTS, "local_track_segments", dtype,
                 "C=384 L=512 S=8",
                 lambda: fused_local_track_segments(track, x, bs, seg, 1,
                                                    wd),
                 lambda: local_track_segment_oh_reference(
                     track, x, bs, segment_one_hot(seg, S), 1, wd),
                 local_track_flops(B, L, C) + 2 * B * L * S * C,
                 (2 * B * L * C + B * S * C) * s + tbytes + B * L * 4,
                 q8=(LOCAL_TRACK_SEGMENTS_Q8,
                     lambda: fused_local_track_segments(qtrack, x, bs, seg,
                                                        1, wd)),
                 timed=dtype == bf16)

    # #6 at C=384 (base-like heads): the rule's bf16 shapes reach L=384.
    onepass_cases(w384, 256, (bf16,), "C=384 G=512 H=8 k=64 v=64 L=256")
    onepass_cases(w384, 128, (f32,), "C=384 G=512 H=8 k=64 v=64 L=128")

    t0 = time.perf_counter()
    segment_cases(card, gen, run_case, rand)
    print(f"# coverage segments kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    taps_cases(card, gen, run_case, rand)
    print(f"# coverage taps kernels: {time.perf_counter() - t0:.1f} s")
    return rows


# Tap counts and dilations past the presets' 9/9 taps and wide dilation 5,
# which the kernels' general instantiations run: (narrow taps, wide taps,
# wide dilation) of K1 and #3 at base width, the odd-tap model's among
# them; the odd-tap model the coverage phase serves and trains (base
# width, 2 blocks).
COVER_TAPS = ((7, 7, 5), (11, 11, 8), (5, 9, 5), (7, 11, 8))
COVER_TAPS_MODEL = dict(narrow_kernel=7, wide_kernel=11, wide_dilation=8)


def taps_cases(card: str, gen, run_case, rand) -> None:
    """`coverage_kernel_phase`'s cases at other tap counts and dilations
    (`COVER_TAPS`): each wrapper against its plain version with its
    existing rows' tolerance, one launch a call, the int8 legs exactly
    (0.0) their fp legs, bf16 timed and float32 checked; B=8. K1 and #3
    (and #3-int8) at C=512, L=512 at each `COVER_TAPS` geometry; K1 and #3
    at a halo past the preset window (9/9 at d=40: 160 rows) and K1 at
    d=12 in float32; #2 and #4 at C=1024, L=1024, taps 7/7 at d=8 (float32
    at L=256); the prehaloed entries of K1 (C=512, L=512) and #2 (C=1024,
    L=256) at halo 40 (9/9, d=10); #6 at the default width (C=128, G=512,
    H=4, k=64, v=128, L=512), dense and S=8, taps 7/11 at d=12, and its
    int8 leg. The bound counts 2·B·L·C²·(nt + wt + 1) for the track
    (`local_track_flops`, `onepass_ops`) over 989 TFLOP/s. At the work of
    the presets' 9-tap convs, K1 (C=512, L=512, d=40) and #2 (C=1024,
    L=1024, d=6) print their device ms by pass (`# passes`), to set
    against the preset instantiations' rows of the kernel phase."""
    from proteinbert_tpu_torch.configs import ModelConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        LOCAL_TRACK, LOCAL_TRACK_SEGMENTS, LOCAL_TRACK_SEGMENTS_Q8,
        LOCAL_TRACK_SEGMENTS_TILED, LOCAL_TRACK_TILED,
        LOCAL_TRACK_TILED_VALID, LOCAL_TRACK_VALID, ONEPASS, ONEPASS_Q8,
        fused_local_track, fused_local_track_segments,
        fused_local_track_valid, local_track_reference,
        local_track_segment_oh_reference, local_track_valid_reference,
        onepass_oh_reference, segment_one_hot, track_halo,
    )
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.kernels.one_pass import fused_onepass

    base = get_preset("base").model
    dev = torch.device(DEVICE)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S = 8, 8

    def track(C, nt, wt, wd, dtype):
        cfg = dataclasses.replace(base, local_dim=C, narrow_kernel=nt,
                                  wide_kernel=wt, wide_dilation=wd)
        return q8_block(gen, cfg, dtype)

    def dense(C, L, nt, wt, wd, dtype, label, passes=False):
        kernel = LOCAL_TRACK if C <= 512 else LOCAL_TRACK_TILED
        _, _, tr, _, _ = track(C, nt, wt, wd, dtype)
        s = dtype.itemsize
        x, bc = rand(B, L, C, dtype=dtype), rand(B, C, dtype=dtype)
        run_case(kernel, kernel.name, dtype, label,
                 lambda: fused_local_track(tr, x, bc, 1, wd),
                 lambda: local_track_reference(tr, x, bc, 1, wd),
                 local_track_flops(B, L, C, nt, wt),
                 (2 * B * L * C + B * C + (nt + wt + 1) * C * C) * s
                 + 7 * C * 4, timed=dtype == bf16)
        if passes:
            print_passes(card, f"{kernel.name} {str(dtype)[6:]} {label}",
                         lambda: fused_local_track(tr, x, bc, 1, wd),
                         reps=50)

    def packed(C, L, nt, wt, wd, dtype, label):
        kernel = (LOCAL_TRACK_SEGMENTS if C <= 512
                  else LOCAL_TRACK_SEGMENTS_TILED)
        qtr, _, tr, _, _ = track(C, nt, wt, wd, dtype)
        s = dtype.itemsize
        x, bs = rand(B, L, C, dtype=dtype), rand(B, S, C, dtype=dtype)
        seg = torch.randint(0, S, (B, L), generator=gen).to(dev)
        seg[:, L // 4:L // 2] = 3   # one segment longer than any reach
        q8 = None
        if C <= 512:
            q8 = (LOCAL_TRACK_SEGMENTS_Q8,
                  lambda: fused_local_track_segments(qtr, x, bs, seg, 1, wd))
        run_case(kernel, kernel.name, dtype, label,
                 lambda: fused_local_track_segments(tr, x, bs, seg, 1, wd),
                 lambda: local_track_segment_oh_reference(
                     tr, x, bs, segment_one_hot(seg, S), 1, wd),
                 local_track_flops(B, L, C, nt, wt) + 2 * B * L * S * C,
                 (2 * B * L * C + B * S * C + (nt + wt + 1) * C * C) * s
                 + 7 * C * 4 + B * L * 4, q8=q8, timed=dtype == bf16)

    def prehaloed(C, L, wd, dtype, label):
        kernel = LOCAL_TRACK_VALID if C <= 512 else LOCAL_TRACK_TILED_VALID
        _, _, tr, _, _ = track(C, 9, 9, wd, dtype)
        s = dtype.itemsize
        halo = track_halo(tr, 1, wd)
        xh = rand(B, L + 2 * halo, C, dtype=dtype)
        bc = rand(B, C, dtype=dtype)
        run_case(kernel, kernel.name, dtype, f"{label} halo {halo}",
                 lambda: fused_local_track_valid(tr, xh, bc, 1, wd),
                 lambda: local_track_valid_reference(tr, xh, bc, 1, wd),
                 local_track_flops(B, L, C),
                 (B * (2 * L + 2 * halo) * C + B * C + 19 * C * C) * s
                 + 7 * C * 4, timed=dtype == bf16)

    for nt, wt, wd in COVER_TAPS:
        for dtype in (bf16, f32) if nt != wt or wd == 5 else (bf16,):
            label = f"C=512 L=512 taps {nt}/{wt} d={wd}"
            dense(512, 512, nt, wt, wd, dtype, label)
            packed(512, 512, nt, wt, wd, dtype, label + " S=8")
    dense(512, 512, 9, 9, 40, bf16, "C=512 L=512 taps 9/9 d=40 (halo 160)",
          passes=True)
    packed(512, 512, 9, 9, 40, bf16,
           "C=512 L=512 taps 9/9 d=40 (halo 160) S=8")
    dense(512, 512, 9, 9, 12, f32, "C=512 L=512 taps 9/9 d=12 (halo 48)")
    for dtype, L in ((bf16, 1024), (f32, 256)):
        label = f"C=1024 L={L} taps 7/7 d=8"
        dense(1024, L, 7, 7, 8, dtype, label)
        packed(1024, L, 7, 7, 8, dtype, label + " S=8")
    dense(1024, 1024, 9, 9, 6, bf16, "C=1024 L=1024 taps 9/9 d=6",
          passes=True)
    for dtype in (bf16, f32):
        prehaloed(512, 512, 10, dtype, "C=512 L=512 taps 9/9 d=10")
        prehaloed(1024, 256, 10, dtype, "C=1024 L=256 taps 9/9 d=10")

    cfg = dataclasses.replace(ModelConfig(), narrow_kernel=7, wide_kernel=11,
                              wide_dilation=12)
    C, G, H, k = cfg.local_dim, cfg.global_dim, cfg.num_heads, cfg.key_dim
    L = 512
    for dtype in (bf16, f32):
        qtr, qat, tr, at, _ = q8_block(gen, cfg, dtype)
        s = dtype.itemsize
        x = rand(B, L, C, dtype=dtype)
        for S1, pk in ((1, False), (S, True)):
            bc, gs = rand(B, S1, C, dtype=dtype), rand(B, S1, G, dtype=dtype)
            seg = (torch.randint(0, S1, (B, L), generator=gen).to(dev)
                   if pk else None)
            real = torch.ones((B, L), dtype=torch.bool, device=dev)
            real[1, L // 2:] = False
            oh = (segment_one_hot(seg, S1) if pk
                  else torch.ones((B, L, 1), device=dev))

            def run(t=tr, a=at, bc=bc, gs=gs, seg=seg, real=real, pk=pk):
                return fused_onepass(t, a, x, bc, gs, seg, real, 1, 12, pk)
            run_case(
                ONEPASS, "one_pass", dtype,
                f"default width L={L} taps 7/11 d=12 "
                f"{'S=8' if pk else 'dense'}", run,
                lambda bc=bc, gs=gs, oh=oh, real=real, pk=pk:
                    onepass_oh_reference(tr, at, x, bc, gs, oh,
                                         real[..., None].float(), 1, 12, pk,
                                         pk),
                onepass_ops(B, L, C, G, S1, H, k, 7, 11),
                (2 * B * L * C + 2 * B * S1 * G + B * S1 * C) * s
                + ((7 + 11 + 1) * C * C
                   + H * (G * k + C * k + C * (G // H))) * s
                + 2 * B * L * 4,
                q8=(ONEPASS_Q8, lambda run=run: run(qtr, qat)),
                timed=dtype == bf16)


# Segment counts past the 16 of earlier builds: K2 at base (B=8, L=512,
# C=G=512, H=8, k=64) at each S here, in bf16, its int8 leg and float32;
# at Large (L=1024, C=G=1024, H=16) at S=64 in bf16 and int8; #6 at the
# default width (C=128, G=512, H=4, k=64, v=128, L=512) at S=32 and 64
# in bf16, int8 and float32, and at S=512 in bf16 and int8.
COVER_SEGMENTS = (17, 32, 64, 512)
COVER_SEGMENTS_LARGE = (64,)
COVER_SEGMENTS_ONEPASS = ((32, True), (64, True), (512, False))


def empty_segments_zero(tag: str, out: torch.Tensor, ids: torch.Tensor,
                        S: int) -> int:
    """Every segment of `out` (B, S, G) that no position of `ids` (B, L)
    names (id s + 1) must be exactly +0.0, sign bit clear; returns how
    many there were."""
    segs = torch.arange(1, S + 1, device=ids.device)
    empty = ~(ids[..., None] == segs).any(dim=1)            # (B, S)
    vals = out[empty]
    check(bool((vals == 0).all()) and not bool(torch.signbit(vals).any()),
          f"{tag}: an empty segment is not exactly +0.0")
    return int(empty.sum())


def segment_cases(card: str, gen, run_case, rand) -> None:
    """`coverage_kernel_phase`'s cases at the segment counts
    `COVER_SEGMENTS*`: each wrapper against its plain version (the tolerance
    of its existing rows), one launch a call, the int8 leg exactly (0.0) its
    fp leg on the dequantized weights, bf16 timed; ids drawn at random over
    0..S-1, so a segment's positions lie scattered over the row and segment
    S (at S=512 most) holds none: its output must be exactly +0.0. The
    bound counts the work the function needs (`attention_ops`,
    `onepass_ops`); the TPU kernel's count, with its full (L, S) score
    table, gives a second bound reported beside it."""
    from proteinbert_tpu_torch.configs import ModelConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, ONEPASS, ONEPASS_Q8, attention_oh_reference,
        fused_packed_attention, onepass_oh_reference, segment_one_hot,
    )
    from proteinbert_tpu_torch.kernels.attention import attention_flops
    from proteinbert_tpu_torch.kernels.one_pass import (
        fused_onepass, onepass_flops,
    )

    dev = torch.device(DEVICE)
    bf16, f32 = torch.bfloat16, torch.float32
    B = 8

    def seg_ids(L, S):
        return torch.randint(0, S, (B, L), generator=gen).to(dev)

    def k2(name, L, S, dtypes):
        cfg = get_preset(name).model
        C, G, H, k = (cfg.local_dim, cfg.global_dim, cfg.num_heads,
                      cfg.key_dim)
        for dtype in dtypes:
            _, qattn, _, attn = q8_block(gen, cfg, dtype)[:4]
            s = dtype.itemsize
            x = rand(B, L, C, dtype=dtype)
            gs = rand(B, S, G, dtype=dtype)
            seg = seg_ids(L, S)
            oh = segment_one_hot(seg, S)
            tag = f"global_attention {str(dtype)[6:]} {name} S={S}"
            run_case(
                ATTENTION, "global_attention", dtype, f"{name} L={L} S={S}",
                lambda: fused_packed_attention(attn, x, gs, seg),
                lambda: attention_oh_reference(attn, x, gs, oh),
                attention_ops(B, L, C, G, S, H, k),
                (B * L * C + 2 * B * S * G) * s
                + H * (G * k + C * k + C * (G // H)) * s + B * L * 4,
                q8=(ATTENTION_Q8, lambda: fused_packed_attention(
                    qattn, x, gs, seg)),
                timed=dtype == bf16,
                tpu_flops=attention_flops(B, L, C, G, S, H, k))
            n = empty_segments_zero(tag, fused_packed_attention(
                attn, x, gs, seg), seg, S)
            n_q = empty_segments_zero(tag + " int8", fused_packed_attention(
                qattn, x, gs, seg), seg, S)
            print(f"# coverage segments {tag} [{card}]: {n} empty "
                  f"segments exactly +0.0 (int8 leg {n_q})")

    for S in COVER_SEGMENTS:
        k2("base", 512, S, (bf16, f32))
    for S in COVER_SEGMENTS_LARGE:
        k2("large", 1024, S, (bf16,))

    cfg = ModelConfig()
    C, G, H, k = cfg.local_dim, cfg.global_dim, cfg.num_heads, cfg.key_dim
    wd, L = cfg.wide_dilation, 512
    for S, with_f32 in COVER_SEGMENTS_ONEPASS:
        for dtype in (bf16, f32) if with_f32 else (bf16,):
            qtrack, qattn, track, attn = q8_block(gen, cfg, dtype)[:4]
            s = dtype.itemsize
            x = rand(B, L, C, dtype=dtype)
            bc = rand(B, S, C, dtype=dtype)
            gs = rand(B, S, G, dtype=dtype)
            seg = seg_ids(L, S)
            real = torch.ones((B, L), dtype=torch.bool, device=dev)
            real[1, L // 2:] = False
            oh = segment_one_hot(seg, S)
            wbytes = (19 * C * C + H * (G * k + C * k + C * (G // H))) * s

            def run(tr=track, at=attn):
                return fused_onepass(tr, at, x, bc, gs, seg, real, 1, wd,
                                     True)
            tag = f"one_pass {str(dtype)[6:]} default width S={S}"
            run_case(
                ONEPASS, "one_pass", dtype, f"default width L={L} S={S}",
                run,
                lambda: onepass_oh_reference(
                    track, attn, x, bc, gs, oh, real[..., None].float(), 1,
                    wd, True, True),
                onepass_ops(B, L, C, G, S, H, k),
                (2 * B * L * C + 2 * B * S * G + B * S * C) * s + wbytes
                + 2 * B * L * 4,
                q8=(ONEPASS_Q8, lambda: run(qtrack, qattn)),
                timed=dtype == bf16,
                tpu_flops=onepass_flops(B, L, C, G, S, H, k))
            seen = torch.where(real, seg, 0)
            n = empty_segments_zero(tag, run()[1], seen, S)
            n_q = empty_segments_zero(tag + " int8", run(qtrack, qattn)[1],
                                      seen, S)
            print(f"# coverage segments {tag} [{card}]: {n} empty "
                  f"segments exactly +0.0 (int8 leg {n_q})")


def route_counts() -> tuple:
    """Snapshots of the three route counters (fused, attention, one-pass)."""
    from proteinbert_tpu_torch.kernels import (
        ATTN_PATH_TOTAL, ONEPASS_PATH_TOTAL, PATH_TOTAL,
    )
    return tuple(dict(c) for c in (PATH_TOTAL, ATTN_PATH_TOTAL,
                                   ONEPASS_PATH_TOTAL))


def route_delta(before: tuple) -> tuple:
    """Each family's {(path, reason): decisions} since `before`."""
    return tuple({k: n - b.get(k, 0) for k, n in a.items()
                  if n != b.get(k, 0)}
                 for a, b in zip(route_counts(), before))


def zero_launches() -> None:
    from proteinbert_tpu_torch.kernels import KERNELS
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    from proteinbert_tpu_torch.kernels import KERNELS
    return {k.name: k.launches for k in KERNELS if k.launches}


def coverage_server(cfg, params, bucket: int, tele):
    """A bucketed Server on DEVICE holding one warm shape: embed at
    `bucket`, 8 rows (one batch class)."""
    from proteinbert_tpu_torch.serve.server import Server
    return Server(params, cfg, device=DEVICE, buckets=(bucket,),
                  batch_classes=(8,), max_batch=8, max_wait_s=0.5,
                  telemetry=tele).start()


def serve_batch(srv, n: int, length: int, seed: int) -> list:
    """`n` embed requests of `length` residues submitted together (one
    batch), their answers."""
    rng = random.Random(seed)
    seqs = ["".join(rng.choice("ACDEFGHIKLMNPQRSTVWY")
                    for _ in range(length)) for _ in range(n)]
    futs = [srv.submit("embed", q) for q in seqs]
    return [f.result(60) for f in futs]


def path_metrics(tele) -> dict:
    """The registry's route counters: {metric{labels}: value}."""
    snap = tele.metrics.snapshot()["counters"]
    return {k: v for k, v in snap.items() if "_kernel_path_total" in k}


def coverage_tiny(card: str) -> dict:
    """(b) The `tiny` preset (C=32, G=128, k=32, H=4, 2 blocks), which the
    JAX gates send to XLA everywhere, on the card through the CLI:
    `pretrain --preset tiny` (COVER_TINY_STEPS steps, the loss falls),
    then a served batch of embeds from that run through a Server whose
    graph is captured with the reference route inside (a host sync there
    would fail the capture). No port kernel covers its local track or
    its one-pass, so those decisions must be reference/unsupported_shape;
    K2 covers its attention (C a multiple of 32), so that decision must be
    pallas/dense, as many as the others, in the three counters, in
    stats() and in the server's registry. K2 launches once a block a
    counted forward and no other kernel launches. Returns K2's
    launches."""
    from proteinbert_tpu_torch import inference, obs
    from proteinbert_tpu_torch.configs import get_preset

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="coverage-", dir=build)
    try:
        ck, metrics = os.path.join(root, "ck"), os.path.join(root, "m.jsonl")
        zero_launches()
        before = route_counts()
        t0 = time.perf_counter()
        rc, _ = cli_main("pretrain", "--preset", "tiny", "--max-steps",
                         COVER_TINY_STEPS, "--checkpoint-dir", ck,
                         "--metrics-jsonl", metrics, "--set",
                         "train.log_every=1")
        train_s = time.perf_counter() - t0
        losses = [json.loads(line)["loss"] for line in open(metrics)]
        first = statistics.mean(losses[:5])
        last = statistics.mean(losses[-5:])
        train = route_delta(before)
        train_launches = launch_counts()
        print(f"# coverage tiny pretrain [{card}]: {len(losses)} steps in "
              f"{train_s:.1f} s (exit {rc}), loss {first:.4f} over the "
              f"first 5 -> {last:.4f} over the last 5; route decisions "
              f"fused {train[0]}, attention {train[1]}, one-pass "
              f"{train[2]}; kernel launches {train_launches}")
        check(rc == 0 and len(losses) == COVER_TINY_STEPS,
              f"coverage tiny pretrain: exit {rc}, {len(losses)} steps")
        check(last < first, f"coverage tiny pretrain: the loss did not "
                            f"fall ({first} -> {last})")
        ref, k2 = ("reference", "unsupported_shape"), ("pallas", "dense")
        nb = get_preset("tiny").model.num_blocks
        check(set(train[0]) == set(train[2]) == {ref}
              and set(train[1]) == {k2}
              and train[0][ref] == train[1][k2] == train[2][ref],
              f"coverage tiny pretrain: route decisions {train}")
        check(train_launches == {"global_attention": nb * train[1][k2]},
              f"coverage tiny pretrain launched {train_launches}, want "
              f"{nb} K2 a counted forward ({train[1].get(k2)})")

        cfg = get_preset("tiny")
        params, _ = inference.load_trunk(ck, cfg, device=DEVICE)
        tele = obs.Telemetry()
        before = route_counts()
        stats0 = None
        srv = coverage_server(cfg, params, 128, tele)
        try:
            zero_launches()
            got = serve_batch(srv, 8, 100, 7)
            stats0 = srv.stats()
        finally:
            srv.drain()
        served = route_delta(before)
        served_launches = launch_counts()
        reg = path_metrics(tele)
        print(f"# coverage tiny serve [{card}]: 8 embeds at bucket 128 in "
              f"one captured shape, route decisions fused {served[0]}, "
              f"attention {served[1]}, one-pass {served[2]}; stats "
              f"fused_path {stats0['fused_path']}, attention_path "
              f"{stats0['attention_path']}, onepass_path "
              f"{stats0['onepass_path']}; registry {reg}; kernel launches "
              f"{served_launches}")
        check(served == ({ref: 1}, {k2: 1}, {ref: 1}),
              f"coverage tiny serve: one captured shape should count one "
              f"decision a family (JAX: one a scanned executable), got "
              f"{served}")
        check(all(np.isfinite(a["global"]).all() for a in got),
              "coverage tiny serve: non-finite embeddings")
        check(served_launches == {"global_attention": nb},
              f"coverage tiny serve launched {served_launches}, want "
              f"{nb} K2")
        want_reg = {f'{m}{{path="{p}",reason="{r}"}}': 1.0
                    for m, (p, r) in (("fused_kernel_path_total", ref),
                                      ("attention_kernel_path_total", k2),
                                      ("onepass_kernel_path_total", ref))}
        check(reg == want_reg,
              f"coverage tiny serve: registry route counters {reg}")
        for key, label in (("fused_path", "reference/unsupported_shape"),
                           ("attention_path", "pallas/dense"),
                           ("onepass_path", "reference/unsupported_shape")):
            check(stats0[key].get(label, 0) > 0,
                  f"coverage tiny serve: stats()[{key!r}] {stats0[key]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"global_attention": train_launches.get("global_attention", 0)
            + served_launches.get("global_attention", 0)}


def coverage_model(card: str, label: str, model, serve_bucket: int,
                   train_L: int, want_serve: tuple, want_train: tuple,
                   want_launches: tuple, replay: bool = False) -> dict:
    """(c) / (d) / (f): a 2-block bf16 model on the card: one served
    bucketed batch (8 embeds at `serve_bucket`) and one train step (B=8,
    L=`train_L`: loss and grads, then the optimizer update). Each run's
    route decisions must equal `want_serve` / `want_train` (per family:
    {(path, reason): n}), and its kernel launches `want_launches` (serve,
    train) exactly. `replay`: one full embed batch through the server's
    warm shape equals its eager run bit for bit. Returns the launches."""
    from proteinbert_tpu_torch import obs
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.data.corruption import corrupt_batch
    from proteinbert_tpu_torch.models.proteinbert import init, to_device
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.schedule import make_optimizer

    tiny = get_preset("tiny")
    cfg = tiny.replace(
        model=model,
        data=dataclasses.replace(tiny.data, seq_len=serve_bucket),
        optimizer=dataclasses.replace(tiny.optimizer, warmup_steps=0,
                                      schedule="constant"))
    params = init(cfg.model, torch.Generator().manual_seed(43),
                  device=DEVICE)
    total = {}
    tele = obs.Telemetry()
    before = route_counts()
    srv = coverage_server(cfg, params, serve_bucket, tele)
    try:
        zero_launches()
        got = serve_batch(srv, 8, serve_bucket - 20, 11)
        served_launches = launch_counts()
        served = route_delta(before)
        reg = path_metrics(tele)
        if replay:
            # Its eager run counts routes and launches of its own: after
            # the served batch's are read.
            rng = np.random.default_rng(12)
            tokens = rng.integers(4, 26, (8, serve_bucket)).astype(np.int32)
            tokens[:, 0], tokens[:, -1] = 1, 2
            tokens[1, serve_bucket // 2:] = 0
            replay_equals_eager(f"coverage {label} bucketed", srv, tokens)
    finally:
        srv.drain()
    print(f"# coverage {label} serve [{card}]: 8 embeds at bucket "
          f"{serve_bucket}, route decisions fused {served[0]}, attention "
          f"{served[1]}, one-pass {served[2]}; registry "
          f"{reg}; kernel launches {served_launches}")
    check(served == want_serve, f"coverage {label} serve: route decisions "
                                f"{served}, want {want_serve}")
    check(served_launches == want_launches[0],
          f"coverage {label} serve: launches {served_launches}, want "
          f"{want_launches[0]}")
    check(all(np.isfinite(a["global"]).all() for a in got),
          f"coverage {label} serve: non-finite embeddings")
    for name, n in served_launches.items():
        total[name] = total.get(name, 0) + n

    rng = np.random.default_rng(43)
    B, L = 8, train_L
    tokens = rng.integers(4, 26, (B, L)).astype(np.int32)
    tokens[:, 0], tokens[0, L - 40], tokens[0, L - 39:] = 1, 2, 0
    ann = (rng.random((B, model.num_annotations)) < 0.01).astype(np.float32)
    X, Y, W = corrupt_batch(torch.Generator().manual_seed(44),
                            torch.from_numpy(tokens), torch.from_numpy(ann))
    dev = torch.device(DEVICE)
    on = {k: {n: t.to(dev) for n, t in d.items()} for k, d in
          (("X", X), ("Y", Y), ("W", W))}
    tx = make_optimizer(cfg.optimizer)
    zero_launches()
    before = route_counts()
    grads, m = ts.loss_and_grads(params, on["X"], on["Y"], on["W"], cfg)
    ts.gradient_update(tx, params, grads, tx.init(params))
    torch.cuda.synchronize()
    trained = route_delta(before)
    train_launches = launch_counts()
    loss = float(m["loss"])
    print(f"# coverage {label} train step [{card}]: B={B} L={L}, loss "
          f"{loss:.4f}, route decisions fused {trained[0]}, attention "
          f"{trained[1]}, one-pass {trained[2]}; kernel launches "
          f"{train_launches}")
    check(np.isfinite(loss) and all(torch.isfinite(g).all().item()
                                    for g in grads),
          f"coverage {label} train step: non-finite loss or grads")
    check(trained == want_train, f"coverage {label} train step: route "
                                 f"decisions {trained}, want {want_train}")
    check(train_launches == want_launches[1],
          f"coverage {label} train step: launches {train_launches}, want "
          f"{want_launches[1]}")
    for name, n in train_launches.items():
        total[name] = total.get(name, 0) + n
    del params, grads, srv
    gc.collect()
    torch.cuda.empty_cache()
    return total


def coverage_widths(name: str, rows: dict) -> list:
    """The kernels line's rows of the instantiations `coverage_phase` adds
    for kernel `name` (an int8 leg: its fp leg's rows, with the int8 ms
    and the exact difference): bf16 timed, float32 checked."""
    fp = name[:-3] if name.endswith("_q8") else name
    out = []
    for (kname, label), (err, ms, plain, b_ms, b_by, per_call, exact,
                         q_ms, tpu_ms) in rows.items():
        if kname != fp or (name != fp and exact is None):
            continue
        row = {"shape": label, "max_abs_err": err if name == fp else exact,
               "launches_a_call": per_call}
        if ms is not None:
            row.update({"ms": q_ms if name != fp else ms, "plain_ms": plain,
                        "bound_ms": b_ms, "bound_by": b_by})
            if tpu_ms is not None:
                row["tpu_count_bound_ms"] = tpu_ms
        out.append(row)
    return out


# The served, mapped and trained paths at more than 16 proteins a row:
# short proteins (8-14 residues, a 16-token span each) packed 32 to a
# 512-token row; the ragged graph pool read at each of SEGMENT_POOLS.
SEGMENT_SERVE = 32
SEGMENT_POOLS = (8, 32, 64)
SEGMENT_BUCKETS = (16, 32, 64, 128, 256, 512)
SEGMENT_STEP_TOL = 2e-5   # fp32 packed base step loss, card vs CPU


def short_proteins(n: int, seed: int) -> list:
    """`n` random proteins of 8-14 residues."""
    rng = random.Random(seed)
    return ["".join(rng.choice("ACDEFGHIKLMNPQRSTVWY")
                    for _ in range(rng.randint(8, 14))) for _ in range(n)]


def short_packed_batch(disp, seed: int) -> tuple:
    """One full packed embed batch of short proteins for a ragged
    dispatcher whose span rule puts each in a 16-token span: every row
    holds `max_segments` of them (or as many as its length takes)."""
    R, L, S = disp.rows_per_batch, disp.cfg.data.seq_len, disp.max_segments
    rng = np.random.default_rng(seed)
    tokens = np.zeros((R, L), np.int32)
    seg = np.zeros((R, L), np.int32)
    riders = []
    for r in range(R):
        for s in range(min(S, L // 16)):
            n, start = int(rng.integers(8, 15)), 16 * s
            tokens[r, start] = 1
            tokens[r, start + 1:start + 1 + n] = rng.integers(4, 26, n)
            tokens[r, start + 1 + n] = 2
            seg[r, start:start + 16] = s + 1
            riders.append((r, s, start, 16))
    ann = np.zeros((R, S, disp.cfg.model.num_annotations), np.float32)
    return tokens, seg, ann, riders


def segments_server(card: str, label: str, cfg, per_batch: dict,
                    want_routes: tuple, seed: int) -> tuple:
    """A ragged Server at pack_max_segments=SEGMENT_SERVE under CUDA
    graphs: its route decisions (`want_routes`, per family), 64 short
    embeds served with exactly `per_batch` launches a batch, four of them
    against the same protein alone in its batch, and one full packed batch
    (8 rows x 32 proteins) replayed against the eager run, bit for bit.
    Returns (launches, the graph pool's bytes)."""
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.server import Server

    params = init(cfg.model, torch.Generator().manual_seed(seed),
                  device=DEVICE)
    before = route_counts()
    srv = Server(params, cfg, device=DEVICE, buckets=SEGMENT_BUCKETS,
                 max_batch=8, max_wait_s=0.05, serve_mode="ragged",
                 pack_max_segments=SEGMENT_SERVE).start()
    try:
        torch.cuda.synchronize()
        pool = srv.dispatcher.graph_pool_bytes()
        seqs = short_proteins(64, seed)
        zero_launches()
        futs = [srv.submit("embed", q) for q in seqs]
        got = [f.result(60) for f in futs]
        launches = launch_counts()
        batches = srv.stats()["batches"]
        routes = route_delta(before)
        worst = 0.0
        for q, res in zip(seqs[:4], got[:4]):
            solo = embed_alone(srv, q)
            for key in ("global", "local_mean"):
                worst = max(worst, float(np.abs(solo[key] - res[key]).max()))
        print(f"# coverage segments serve ragged {label} "
              f"pack_max_segments={SEGMENT_SERVE} [{card}]: 64 embeds of "
              f"8-14 residues in {batches} batches, launches {launches}; "
              f"route decisions fused {routes[0]}, attention {routes[1]}, "
              f"one-pass {routes[2]}; {srv.dispatcher.executable_count} "
              f"CUDA graphs, pool {pool} bytes ({pool / 2**20:.2f} MiB); "
              f"served vs alone max |diff| {worst:.3e} (tol "
              f"{SERVE_EMBED_TOL})")
        check(routes == want_routes, f"segments serve {label}: route "
                                     f"decisions {routes}, want "
                                     f"{want_routes}")
        check(batches > 0 and launches == {
            k: n * batches for k, n in per_batch.items()},
            f"segments serve {label}: launches {launches} for {batches} "
            f"batches, want {per_batch} a batch")
        check(all(np.isfinite(a["global"]).all() for a in got),
              f"segments serve {label}: non-finite embeddings")
        check(worst <= SERVE_EMBED_TOL,
              f"segments serve {label}: served vs alone {worst}")
        replay_equals_eager(f"coverage segments ragged {label} "
                            f"S={SEGMENT_SERVE}", srv,
                            short_packed_batch(srv.dispatcher, seed))
    finally:
        srv.drain()
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, pool


def segments_pools(card: str, cfg, seed: int, pools: dict) -> None:
    """The base ragged dispatcher's graph pool after capturing its one
    embed shape, at each pack_max_segments of SEGMENT_POOLS not yet in
    `pools` ({S: bytes}); prints the three."""
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.dispatch import RaggedDispatcher

    params = init(cfg.model, torch.Generator().manual_seed(seed),
                  device=DEVICE)
    for S in SEGMENT_POOLS:
        if S in pools:
            continue
        disp = RaggedDispatcher(params, cfg, buckets=SEGMENT_BUCKETS,
                                rows_per_batch=8, max_segments=S,
                                device=DEVICE)
        disp.warmup(("embed",))
        torch.cuda.synchronize()
        pools[S] = disp.graph_pool_bytes()
        del disp
        gc.collect()
        torch.cuda.empty_cache()
    print(f"# coverage segments pool base ragged [{card}]: one embed graph "
          f"(8 x 512) at pack_max_segments " + ", ".join(
              f"{S}: {pools[S]} bytes ({pools[S] / 2**20:.2f} MiB)"
              for S in SEGMENT_POOLS))


def segments_map(card: str, cfg, seed: int, per_batch: dict) -> dict:
    """`run_map` over 256 short proteins at max_segments=SEGMENT_SERVE
    (rows_per_batch 8, one shard): completed, `per_batch` launches a
    packed batch, the store verified; its vectors against the same map at
    max_segments=8. Returns the first run's launches."""
    from proteinbert_tpu_torch.mapper import (
        iter_embeddings, run_map, verify_store,
    )
    from proteinbert_tpu_torch.models.proteinbert import init

    params = init(cfg.model, torch.Generator().manual_seed(seed),
                  device=DEVICE)
    seqs = short_proteins(256, seed)
    ids = [f"SP{i:04d}" for i in range(len(seqs))]
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="segments-", dir=build)
    try:
        vecs, launches = {}, None
        for S in (SEGMENT_SERVE, 8):
            store = os.path.join(root, f"s{S}")
            zero_launches()
            out = run_map(params, cfg, ids, seqs, store, num_shards=1,
                          block_size=256, rows_per_batch=8, max_segments=S,
                          buckets=SEGMENT_BUCKETS, stop_flag=lambda: False,
                          device=DEVICE)
            torch.cuda.synchronize()
            got = launch_counts()
            rep = verify_store(store)
            check(out["outcome"] == "completed" and rep["ok"]
                  and rep["complete"],
                  f"segments map S={S}: outcome {out['outcome']}, verify "
                  f"{rep}")
            check(got == {k: n * out["batches"] for k, n in
                          per_batch.items()},
                  f"segments map S={S}: launches {got} for "
                  f"{out['batches']} batches, want {per_batch} a batch")
            vecs[S] = {i: r["global"] for i, r in iter_embeddings(store)}
            if launches is None:
                launches, batches = got, out["batches"]
        check(sorted(vecs[SEGMENT_SERVE]) == sorted(ids),
              "segments map: not every protein was stored")
        diff = max(float(np.abs(vecs[SEGMENT_SERVE][i].astype(np.float64)
                                - vecs[8][i]).max()) for i in ids)
        print(f"# coverage segments map base max_segments={SEGMENT_SERVE} "
              f"[{card}]: 256 proteins of 8-14 residues in {batches} "
              f"batches, launches {launches}; store verified; global "
              f"vectors vs max_segments=8 max |diff| {diff:.3e} (tol "
              f"{SERVE_EMBED_TOL})")
        check(diff <= SERVE_EMBED_TOL, f"segments map vs S=8: {diff}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def segments_step(card: str) -> dict:
    """One fp32 PACKED train step at base width, 2 blocks, B=2, L=256, 32
    proteins of 6-8 tokens a row (the loss and every grad) on the card,
    through #3 and K2 at S=32, against the same params and corrupted batch
    on the CPU plain path: loss within SEGMENT_STEP_TOL, grads within
    STEP_GRAD_TOL. Returns its launches."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.data.corruption import corrupt_packed_batch
    from proteinbert_tpu_torch.models.proteinbert import init, to_device
    from proteinbert_tpu_torch.train import train_state as ts

    base = get_preset("base")
    cfg = base.replace(
        model=dataclasses.replace(base.model, dtype="float32", num_blocks=2))
    params = init(cfg.model, torch.Generator().manual_seed(47), device="cpu")
    rng = np.random.default_rng(47)
    B, L, S, A = 2, 256, SEGMENT_SERVE, cfg.model.num_annotations
    tokens = np.zeros((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    for r in range(B):
        pos = 0
        for sid in range(1, S + 1):
            n = int(rng.integers(6, 9))
            if pos + n > L - 2:
                break
            tokens[r, pos + 1:pos + n - 1] = rng.integers(4, 26, n - 2)
            tokens[r, pos], tokens[r, pos + n - 1] = 1, 2
            seg[r, pos:pos + n] = sid
            pos += n
    ann = (rng.random((B, S, A)) < 0.01).astype(np.float32)
    tok, sg, an = (torch.from_numpy(a) for a in (tokens, seg, ann))
    X, Y, W = corrupt_packed_batch(torch.Generator().manual_seed(48), tok,
                                   sg, an)
    t0 = time.perf_counter()
    want_g, want_m = ts.loss_and_grads(params, X, Y, W, cfg, sg)
    cpu_s = time.perf_counter() - t0
    dev = torch.device(DEVICE)
    on = {k: {n: t.to(dev) for n, t in d.items()} for k, d in
          (("X", X), ("Y", Y), ("W", W))}
    zero_launches()
    before = route_counts()
    got_g, got_m = ts.loss_and_grads(to_device(params, dev), on["X"],
                                     on["Y"], on["W"], cfg, sg.to(dev))
    torch.cuda.synchronize()
    launches, routes = launch_counts(), route_delta(before)
    loss_err = abs(float(got_m["loss"]) - float(want_m["loss"]))
    grad_err = max((a.cpu() - b).abs().max().item()
                   for a, b in zip(got_g, want_g))
    print(f"# coverage segments step base packed fp32 [{card}]: 2 blocks, "
          f"B={B} L={L} S={S}, card vs CPU plain path ({cpu_s:.1f} s): loss "
          f"{float(got_m['loss']):.6f} |diff| {loss_err:.3e} (tol "
          f"{SEGMENT_STEP_TOL}), grads max |diff| {grad_err:.3e} over "
          f"{len(got_g)} tensors (tol {STEP_GRAD_TOL}); route decisions "
          f"fused {routes[0]}, attention {routes[1]}, one-pass {routes[2]}; "
          f"launches {launches}")
    check(launches == {"local_track_segments": 2, "global_attention": 2},
          f"segments step: launches {launches}, want #3 and K2 once a block")
    check(routes[1] == {("pallas", "packed"): 1},
          f"segments step: attention route {routes[1]}")
    check(loss_err <= SEGMENT_STEP_TOL, f"segments step loss {loss_err}")
    check(grad_err <= STEP_GRAD_TOL, f"segments step grads {grad_err}")
    return launches


def coverage_segments(card: str) -> dict:
    """(e) More than 16 proteins a row on the main paths: the ragged Server
    at pack_max_segments=32 on base (#3 + K2) and at the default width
    (#6), the base ragged graph pool at 8, 32 and 64 segments, `run_map` at
    max_segments=32, and one fp32 packed base step at S=32 against the
    CPU. Returns the launches of the served, mapped and trained runs."""
    from proteinbert_tpu_torch.configs import ModelConfig, get_preset

    base = get_preset("base")
    nb = base.model.num_blocks
    composed = {"local_track_segments": nb, "global_attention": nb}
    pk = {("pallas", "packed"): 1}
    total = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    launches, pool32 = segments_server(
        card, "base", base, composed,
        (pk, pk, {("reference", "segments"): 1}), 51)
    add(launches)
    segments_pools(card, base, 51, {SEGMENT_SERVE: pool32})
    default = base.replace(model=ModelConfig())
    launches, _ = segments_server(
        card, "default width", default,
        {"one_pass": default.model.num_blocks}, ({}, {}, pk), 52)
    add(launches)
    add(segments_map(card, base, 53, composed))
    add(segments_step(card))
    return total


def coverage_taps(card: str) -> dict:
    """(f) A model at other taps and dilations on the main paths: the
    base preset cut to 2 blocks (C=G=512, H=8, k=64) with
    `COVER_TAPS_MODEL` (taps 7/11, wide dilation 8), on the general
    instantiations. A served bucketed batch (8 embeds at 512, then one
    full batch's graph replay against its eager run) and one bf16 train
    step at L=512 each launch K1 + K2 once a block, counted pallas/dense
    (the one-pass rule refuses the shape: its composition); a ragged
    server (`segments_server`: short proteins 32 to a 512 row) launches
    #3 + K2 once a block a batch, counted pallas/packed, its replay equal
    to its eager run. Returns the launches."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import budget

    base = get_preset("base")
    nb = 2
    model = dataclasses.replace(base.model, num_blocks=nb,
                                **COVER_TAPS_MODEL)
    check(not budget.onepass_supported(512, 512, 512, 1, 64, 8,
                                       torch.bfloat16, 7, 11, 8, 1),
          "coverage taps: the one-pass rule should refuse base width at "
          "L=512")
    one = {("pallas", "dense"): 1}
    composed = {("reference", "unsupported_shape"): 1}
    track = {"local_track": nb, "global_attention": nb}
    total = coverage_model(card, "taps 7/11 d=8 base", model, 512, 512,
                           (one, one, composed), (one, one, composed),
                           (track, track), replay=True)
    pk = {("pallas", "packed"): 1}
    launches, _ = segments_server(
        card, "taps 7/11 d=8 base", base.replace(model=model),
        {"local_track_segments": nb, "global_attention": nb},
        (pk, pk, {("reference", "segments"): 1}), 61)
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    return total


def coverage_phase(card: str) -> tuple:
    """`--phase coverage` (also part of the full run): (a) the new
    instantiations against their plain versions; (b) the `tiny` preset,
    its local track on the reference route and its attention on K2; (c)
    the transfer experiment's `small`
    geometry (C=128, G=256, k=32, H=4) on #6; (d) a 2-block base-like
    model at C=384 (G=512, H=8, k=64): a served batch at the 256 bucket
    on #6, a step at L=512 on the composition K1 + K2; (e) more than 16
    proteins a row (`coverage_segments`); (f) a model at taps 7/11 and
    wide dilation 8 (`coverage_taps`). Returns (rows of
    `coverage_kernel_phase`, {kernel: launches on the driven paths})."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import budget

    t0 = time.perf_counter()
    rows = coverage_kernel_phase(card)
    print(f"# coverage kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = coverage_tiny(card)
    print(f"# coverage tiny: {time.perf_counter() - t0:.1f} s")

    tiny = get_preset("tiny").model
    nb = 2
    # One decision a family per forward (scan_blocks), the kernels
    # launched once a block.
    one = {("pallas", "dense"): 1}
    composed = {("reference", "unsupported_shape"): 1}
    t0 = time.perf_counter()
    small = dataclasses.replace(tiny, local_dim=128, global_dim=256,
                                key_dim=32, num_heads=4, num_blocks=nb,
                                dtype="bfloat16")
    for name, n in coverage_model(
            card, "small C=128 G=256 k=32 H=4", small, 512, 512,
            ({}, {}, one), ({}, {}, one),
            ({"one_pass": nb}, {"one_pass": nb})).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# coverage small: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    base = get_preset("base").model
    c384 = dataclasses.replace(base, local_dim=384, num_blocks=nb,
                               dtype="bfloat16")
    check(budget.onepass_supported(384, 512, 256, 1, 64, 8)
          and not budget.onepass_supported(384, 512, 512, 1, 64, 8),
          "coverage C=384: the one-pass rule should admit L=256 and refuse "
          "L=512")
    for name, n in coverage_model(
            card, "base-like C=384 G=512 H=8", c384, 256, 512,
            ({}, {}, one), (one, one, composed),
            ({"one_pass": nb},
             {"local_track": nb, "global_attention": nb})).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# coverage C=384: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for name, n in coverage_segments(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# coverage segments paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in coverage_taps(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# coverage taps paths: {time.perf_counter() - t0:.1f} s")
    return rows, launches


def base_phase(card: str) -> None:
    """`--phase base` (also `--phase k2`): the base-width kernels at the
    kernel table's shapes, bf16 under inference mode as served — K1 (B=8,
    L=C=512), K1's prehaloed entry (B=16, L=512+2*20, C=512), #3 (B=8,
    L=C=512, S=8), #3-int8 and K2-int8 beside their fp legs, K2 at base
    (B=8 L=512 C=G=512 H=8) and Large (B=8 L=1024 C=G=1024 H=16) width,
    dense and S=8, and at Large #2 (B=8, L=C=1024), #4 (S=8) and #2's
    prehaloed entry (B=8, L=256+2*20): each call's wall ms (median of 25
    CUDA-event timings), host enqueue time, output digest and device ms by
    pass. It uses only the
    entries' public wrappers, so the same script times the parent commit's
    package in the same call (copy it into a checkout of the parent)."""
    import torch.nn.functional as F

    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        TRACK_PARAMS, dequant_params, fused_global_attention,
        fused_local_track, fused_local_track_segments,
        fused_local_track_valid, fused_packed_attention, track_halo,
    )
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )
    from proteinbert_tpu_torch.parallel.quant import quantize_params

    dev = torch.device(DEVICE)

    def timed(label, fn, passes=K2_PASSES):
        print_timed(card, "base", label, fn, passes)

    for name, L in (("base", 512), ("large", 1024)):
        cfg = get_preset(name).model
        gen = torch.Generator().manual_seed(5)
        blk = to_device(block_init(gen, cfg), dev)
        cast = cast_block(blk, torch.bfloat16)
        attn = cast["attention"]
        B, C, G, S = 8, cfg.local_dim, cfg.global_dim, 8
        x = torch.randn((B, L, C), generator=gen).to(dev, torch.bfloat16)
        g = torch.randn((B, G), generator=gen).to(dev, torch.bfloat16)
        gs = torch.randn((B, S, G), generator=gen).to(dev, torch.bfloat16)
        pad = torch.ones((B, L), dtype=torch.bool, device=dev)
        pad[1, L // 2:] = False
        seg = torch.randint(0, S + 1, (B, L), generator=gen).to(dev)
        with torch.inference_mode():
            timed(f"K2 {name} dense B=8 L={L}",
                  lambda: fused_global_attention(attn, x, g, pad))
            timed(f"K2 {name} S=8 B=8 L={L}",
                  lambda: fused_packed_attention(attn, x, gs, seg))
            wd = cfg.wide_dilation
            track = {n: cast[n] for n in TRACK_PARAMS}
            bc = torch.randn((B, C), generator=gen).to(dev, torch.bfloat16)
            bs = torch.randn((B, S, C), generator=gen).to(dev, torch.bfloat16)
            if name != "base":
                timed(f"#2 {name} dense B=8 L={L}",
                      lambda: fused_local_track(track, x, bc, 1, wd),
                      TRACK_PASSES)
                timed(f"#4 {name} S=8 B=8 L={L}",
                      lambda: fused_local_track_segments(track, x, bs, seg,
                                                         1, wd), TRACK_PASSES)
                H = track_halo(track, 1, wd)
                xh = F.pad(torch.randn((B, 256, C), generator=gen),
                           (0, 0, H, H)).to(dev, torch.bfloat16)
                timed(f"#2 prehaloed {name} B=8 L=256+2*{H}",
                      lambda: fused_local_track_valid(track, xh, bc, 1, wd),
                      TRACK_PASSES)
                continue
            timed("K1 base dense B=8 L=512",
                  lambda: fused_local_track(track, x, bc, 1, wd),
                  TRACK_PASSES)
            H = track_halo(track, 1, wd)
            xh = F.pad(torch.randn((16, L, C), generator=gen),
                       (0, 0, H, H)).to(dev, torch.bfloat16)
            bh = torch.randn((16, C), generator=gen).to(dev, torch.bfloat16)
            timed(f"K1 prehaloed base B=16 L=512+2*{H}",
                  lambda: fused_local_track_valid(track, xh, bh, 1, wd),
                  TRACK_PASSES)
            timed("#3 base S=8 B=8 L=512",
                  lambda: fused_local_track_segments(track, x, bs, seg, 1,
                                                     wd), TRACK_PASSES)
            q = cast_block(quantize_params(blk), torch.bfloat16)
            qa, fa = q["attention"], dequant_params(q["attention"])
            timed("K2-int8 base dense",
                  lambda: fused_global_attention(qa, x, g, pad))
            timed("K2-int8 fp leg base dense",
                  lambda: fused_global_attention(fa, x, g, pad))
            timed("K2-int8 base S=8",
                  lambda: fused_packed_attention(qa, x, gs, seg))
            timed("K2-int8 fp leg base S=8",
                  lambda: fused_packed_attention(fa, x, gs, seg))
            qt = {n: q[n] for n in TRACK_PARAMS}
            ft = dequant_params(qt)
            timed("#3-int8 base S=8", lambda: fused_local_track_segments(
                qt, x, bs, seg, 1, wd), TRACK_PASSES)
            timed("#3-int8 fp leg base S=8",
                  lambda: fused_local_track_segments(ft, x, bs, seg, 1, wd),
                  TRACK_PASSES)


def f32_phase(card: str) -> None:
    """`--phase f32`: the float32 plans at the presets' geometry (9/9
    taps, narrow dilation 1, wide dilation 5) under inference mode, each
    call's wall ms, host enqueue time, output digest and device ms by pass
    — at base width (C=512, B=8, L=512) K1, #3 (S=8), #3-int8 and K1's
    prehaloed entry (L=256+2·20); at Large (C=1024, B=4, L=512) #2, #4 and
    #2's prehaloed entry; at the ModelConfig default width (C=128, G=512,
    H=4, B=8, L=512) K1, #3, #6 and #6-int8, dense and S=8. It uses only
    the package's public entries, so it also times the parent commit's
    package (copy this script into its `git archive`)."""
    import torch.nn.functional as F

    from proteinbert_tpu_torch.configs import ModelConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        TRACK_PARAMS, fused_local_track, fused_local_track_segments,
        fused_local_track_valid, fused_onepass_dense, fused_onepass_segments,
        track_halo,
    )
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )
    from proteinbert_tpu_torch.parallel.quant import quantize_params

    dev, f32 = torch.device(DEVICE), torch.float32

    def block(cfg):
        gen = torch.Generator().manual_seed(5)
        blk = to_device(block_init(gen, cfg), dev)
        cast, q = cast_block(blk, f32), cast_block(quantize_params(blk), f32)
        return (gen, cast, q, {n: cast[n] for n in TRACK_PARAMS},
                {n: q[n] for n in TRACK_PARAMS})

    def rand(gen, *shape):
        return torch.randn(shape, generator=gen).to(dev, f32)

    def timed(label, fn, passes=TRACK_PASSES):
        print_timed(card, "f32", label, fn, passes)

    with torch.inference_mode():
        for name, B in (("base", 8), ("large", 4)):
            cfg = get_preset(name).model
            gen, _, _, track, qt = block(cfg)
            L, C, S, wd = 512, cfg.local_dim, 8, cfg.wide_dilation
            x, bc = rand(gen, B, L, C), rand(gen, B, C)
            bs = rand(gen, B, S, C)
            seg = torch.randint(0, S + 1, (B, L), generator=gen).to(dev)
            seg[:, L // 4:L // 2] = 3
            k1, k3 = ("K1", "#3") if C <= 512 else ("#2", "#4")
            timed(f"{k1} {name} dense B={B} L={L}",
                  lambda: fused_local_track(track, x, bc, 1, wd))
            timed(f"{k3} {name} S=8 B={B} L={L}",
                  lambda: fused_local_track_segments(track, x, bs, seg, 1,
                                                     wd))
            if C <= 512:
                timed(f"#3-int8 {name} S=8 B={B} L={L}",
                      lambda: fused_local_track_segments(qt, x, bs, seg, 1,
                                                         wd))
            H = track_halo(track, 1, wd)
            xh = F.pad(rand(gen, B, 256, C), (0, 0, H, H))
            timed(f"{k1} prehaloed {name} B={B} L=256+2*{H}",
                  lambda: fused_local_track_valid(track, xh, bc, 1, wd))
        cfg = ModelConfig()
        gen, cast, q, track, qt = block(cfg)
        B, L, C, G, S = 8, 512, cfg.local_dim, cfg.global_dim, 8
        wd = cfg.wide_dilation
        x, bc, g = rand(gen, B, L, C), rand(gen, B, C), rand(gen, B, G)
        bs, gs = rand(gen, B, S, C), rand(gen, B, S, G)
        seg = torch.randint(0, S + 1, (B, L), generator=gen).to(dev)
        pad = torch.ones((B, L), dtype=torch.bool, device=dev)
        pad[1, L // 2:] = False
        timed(f"K1 default dense B={B} L={L}",
              lambda: fused_local_track(track, x, bc, 1, wd))
        timed(f"#3 default S=8 B={B} L={L}",
              lambda: fused_local_track_segments(track, x, bs, seg, 1, wd))
        for leg, t, a in (("#6", track, cast["attention"]),
                          ("#6-int8", qt, q["attention"])):
            timed(f"{leg} default dense B={B} L={L}",
                  lambda t=t, a=a: fused_onepass_dense(t, a, x, bc, g, pad,
                                                       1, wd),
                  ONEPASS_PASSES)
            timed(f"{leg} default S=8 B={B} L={L}",
                  lambda t=t, a=a: fused_onepass_segments(
                      t, a, x, bs, gs, seg, pad, 1, wd), ONEPASS_PASSES)


def default_phase(card: str) -> None:
    """`--phase default`: #6 and #6-int8 in bf16 under inference mode as
    served, at the ModelConfig default width (B=8, C=128, G=512, H=4,
    v=128) at L=512 and L=128, dense and S=8, and at C=512, H=4, L=128,
    S=8 (the kernel table's shapes): each call's wall ms (median of 25
    CUDA-event timings), host enqueue time and device ms by pass, and
    beside it the composition the one-pass rule chooses against on the
    same inputs (K1 or #3, then K2, or their int8 legs). Then where #6
    runs six times: one full ragged 8 x 512 embed batch of a default-width
    server on the fp32 and the int8 arm, and a default-width packed train
    step (B=8, L=512), each through torch.profiler (`# profile` lines:
    wall and device busy). It uses only the package's public entries, so
    it also times the parent commit's package."""
    from proteinbert_tpu_torch.configs import ModelConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        ONEPASS, TRACK_PARAMS, fused_global_attention, fused_local_track,
        fused_local_track_segments, fused_onepass_dense,
        fused_onepass_segments, fused_packed_attention,
    )
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, init, to_device,
    )
    from proteinbert_tpu_torch.parallel.quant import quantize_params
    from proteinbert_tpu_torch.serve.server import Server

    dev = torch.device(DEVICE)
    base = get_preset("base").model
    wd = base.wide_dilation
    gen = torch.Generator().manual_seed(13)
    B, S = 8, 8
    for C, G, H, lengths in ((128, 512, 4, (512, 128)), (512, 512, 4, (128,))):
        cfg = dataclasses.replace(base, local_dim=C, global_dim=G,
                                  num_heads=H)
        blk = to_device(block_init(gen, cfg), dev)
        cast = cast_block(blk, torch.bfloat16)
        q = cast_block(quantize_params(blk), torch.bfloat16)
        legs = {"": ({n: cast[n] for n in TRACK_PARAMS}, cast["attention"]),
                "-int8": ({n: q[n] for n in TRACK_PARAMS}, q["attention"])}
        for L in lengths:
            x = torch.randn((B, L, C), generator=gen).to(dev, torch.bfloat16)
            bc = torch.randn((B, C), generator=gen).to(dev, torch.bfloat16)
            bs = torch.randn((B, S, C), generator=gen).to(dev, torch.bfloat16)
            g = torch.randn((B, G), generator=gen).to(dev, torch.bfloat16)
            gs = torch.randn((B, S, G), generator=gen).to(dev,
                                                          torch.bfloat16)
            seg = packed_ids(gen, B, L, S).to(dev)
            real = (torch.rand((B, L), generator=gen) > 0.1).to(dev)
            pad = torch.ones((B, L), dtype=torch.bool, device=dev)
            pad[1, L // 2:] = False
            cases = (("S=8", lambda t, a: fused_onepass_segments(
                          t, a, x, bs, gs, seg, real, 1, wd),
                      lambda t, a: fused_packed_attention(
                          a, fused_local_track_segments(t, x, bs, seg, 1, wd),
                          gs, seg, real)),
                     ("dense", lambda t, a: fused_onepass_dense(
                          t, a, x, bc, g, pad, 1, wd),
                      lambda t, a: fused_global_attention(
                          a, fused_local_track(t, x, bc, 1, wd), g, pad)))
            for case, onepass, composed in cases:
                if C == 512 and case == "dense":
                    continue
                shape = f"B=8 L={L} C={C} G={G} H={H} {case}"
                for leg, (track, attn) in legs.items():
                    with torch.inference_mode():
                        print_timed(card, "default", f"#6{leg} {shape}",
                                    lambda: onepass(track, attn),
                                    ONEPASS_PASSES)
                        print_timed(card, "default",
                                    f"composition{leg} {shape}",
                                    lambda: composed(track, attn),
                                    TRACK_PASSES + K2_PASSES)

    cfg = get_preset("base").replace(model=ModelConfig())
    for quant in ("fp32", "int8"):
        srv = Server(init(cfg.model, torch.Generator().manual_seed(0),
                          device=DEVICE), cfg, device=DEVICE,
                     buckets=BUCKETS, max_batch=8, serve_mode="ragged",
                     pack_max_segments=8, quant=quant, quant_parity_every=0)
        packed = full_ragged_batch(srv)
        profile_batch(card, f"default width ragged {quant}, one packed embed "
                            "batch 8x512 (24 segments)",
                      lambda: srv.dispatcher.run_packed("embed", *packed))
        check(srv.drain(timeout=300), "drain timed out")
        del srv
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=8, seq_len=512,
                                 packing=True, pack_max_segments=8),
        train=dataclasses.replace(cfg.train, max_steps=2, log_every=1,
                                  eval_every=0))
    out, _, _, _, batch, _ = train_run(card, "default width packed", cfg, 2,
                                       {ONEPASS.name: 6}, (50, 250), 1)
    profile_step(card, "train default width packed, one step B=8 L=512",
                 out["state"], batch, cfg)


def print_rows(card: str, rows: dict) -> None:
    """The kernel table, each row checked against its tolerance."""
    print(f"{'kernel':21s} {'dtype':9s} {'L':>4s} {'case':13s} "
          f"{'max_abs_err':>12s} {'tol':>8s} {'ms':>9s} {'plain_ms':>9s} "
          f"{'bound_ms':>9s}  bound_by   launches/call  [{card}]")
    for (name, dtype, L, case), (err, ms, plain, b_ms, b_by,
                                 per_call) in rows.items():
        tol = TOL[(name, dtype)]
        fmt = (lambda v: f"{v:9.4f}" if v is not None else f"{'-':>9s}")
        print(f"{name:21s} {str(dtype)[6:]:9s} {L:4d} {case:13s} "
              f"{err:12.3e} {tol:8.1e} {fmt(ms)} {fmt(plain)} {fmt(b_ms)}  "
              f"{b_by or '-':10s} {per_call if per_call is not None else '-'}")
        check(err <= tol, f"{name} {dtype} L={L} {case}: max_abs_err {err} "
                          f"> {tol}")


def packed_ids(gen, B: int, L: int, S: int) -> torch.Tensor:
    """(B, L) int32 segment ids as a packer lays them out, with the corners
    the kernels must get right: segments 1..S-1 of random lengths, a pad gap
    after segment 2, a run of ids above S (pad by contract), a pad tail, and
    segment S empty in every row."""
    seg = torch.zeros((B, L), dtype=torch.int32)
    lo, hi = max(1, L // (2 * S)), max(2, L // S)
    for b in range(B):
        pos = 0
        for sid in range(1, S):
            n = int(torch.randint(lo, hi, (1,), generator=gen))
            seg[b, pos:pos + n] = sid
            pos += n + (3 if sid == 2 else 0)
        seg[b, pos:pos + 5] = S + 1 + b % 3
    return seg


def tiled_ids(gen, B: int, L: int, S: int) -> torch.Tensor:
    """`packed_ids`, with row 0 laid over #4's tile edges: boundaries
    beside (62) and on (64) the bf16 finish pass's 64-row edge and the
    float32 conv pass's 64-row tile edge, one inside a 32-row finish tile
    (80), a boundary on the bf16 conv pass's 128-row tile edge (128) with
    boundaries beside it (126, 131), a segment that starts inside the next
    tile's 20-row halo (141, after a pad gap), and an id above S; each
    clipped to L."""
    seg = packed_ids(gen, B, L, S)
    row = torch.zeros(L, dtype=torch.int32)
    for sid, (a, b) in enumerate(((0, 62), (62, 64), (64, 80), (80, 126),
                                  (126, 128), (128, 131), (131, 138),
                                  (141, 190)), start=1):
        row[min(a, L):min(b, L)] = sid
    row[min(190, L):min(200, L)] = S + 2
    row[min(200, L):min(256, L)] = 1   # far from segment 1's first run
    seg[0] = row
    return seg


TILE_EDGE_SIDS = (2, 3, 4, 5, 6)   # row 0's segments on and beside the edges


def isolated(run, x: torch.Tensor, seg: torch.Tensor, sid: int, gen,
             outs) -> bool:
    """Cross-segment isolation, bit for bit: new inputs inside segment
    `sid` change nothing outside it. `run(x)` returns (local (B, L, C),
    attn (B, S, G) or None); `outs` is run(x) on the original input."""
    x2 = x.clone()
    sel = seg == sid
    x2[sel] = torch.randn((int(sel.sum()), x.shape[-1]),
                          generator=gen).to(x.device, x.dtype)
    local2, attn2 = run(x2)
    local, attn = outs
    keep = ~sel
    same = torch.equal(local2[keep], local[keep])
    moved = not torch.equal(local2[sel], local[sel])
    if attn is not None:
        others = [s for s in range(attn.shape[1]) if s != sid - 1]
        same = same and torch.equal(attn2[:, others], attn[:, others])
    return same and moved


def packed_kernel_phase(card: str, rows: dict) -> None:
    """#3 at base width (C=512, S=8) and #6 at C=128 (G=512, H=4, v=128)
    and C=256 (G=512, H=8), dense and packed, against their plain versions
    on the card; B=8, L in {128, 512} timed, L=100 ragged; cross-segment
    isolation bit for bit. #6 at C=512 in bf16 (G=512, H=4, L=128 timed;
    the base preset's H=8 at L=8), and the dispatch's choice of it."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS, ONEPASS, TRACK_PARAMS,
        fused_local_track_segments, local_track_segment_oh_reference,
        onepass_oh_reference, segment_one_hot,
    )
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.kernels.one_pass import (
        fused_onepass, fused_onepass_dense, fused_onepass_segments,
    )
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )

    base = get_preset("base").model
    gen = torch.Generator().manual_seed(11)
    dev = torch.device(DEVICE)
    B, S, k, wd = 8, 8, base.key_dim, base.wide_dilation

    def launches(kernel, fn):
        n0 = kernel.launches
        fn()
        return kernel.launches - n0

    # #3: the segment-masked local track at base width.
    block = to_device(block_init(gen, base), dev)
    C = base.local_dim
    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        cast = cast_block(block, dtype)
        track = {name: cast[name] for name in TRACK_PARAMS}
        for L in (128, 512, 100):
            x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
            bs = torch.randn((B, S, C), generator=gen).to(dev, dtype)
            seg = packed_ids(gen, B, L, S).to(dev)
            oh = segment_one_hot(seg, S)

            def run(xx):
                return (fused_local_track_segments(track, xx, bs, seg, 1, wd),
                        None)

            got = run(x)
            want = local_track_segment_oh_reference(track, x, bs, oh, 1, wd)
            torch.cuda.synchronize()
            check(torch.isfinite(got[0]).all().item(),
                  "local_track_segments non-finite")
            err = (got[0].float() - want.float()).abs().max().item()
            check(isolated(run, x, seg, 3, gen, got),
                  f"local_track_segments {dtype} L={L}: segments not "
                  "isolated bit for bit")
            timing = (None,) * 5
            if L != 100:
                nbytes = ((2 * B * L * C + B * S * C + 19 * C * C) * s
                          + B * L * 4 + 7 * C * 4)
                b_ms, b_by = bound(local_track_flops(B, L, C)
                                   + 2 * B * L * S * C, nbytes, dtype)
                per_call = launches(LOCAL_TRACK_SEGMENTS, lambda: run(x))
                check(per_call == 1, f"local_track_segments launched "
                                     f"{per_call} times in one call")
                timing = (time_ms(lambda: run(x)),
                          time_ms(lambda: local_track_segment_oh_reference(
                              track, x, bs, oh, 1, wd)),
                          b_ms, b_by, per_call)
                if dtype == torch.bfloat16 and L == 512:
                    print_passes(card, "local_track_segments bf16 B=8 L=512 "
                                       "C=512 S=8", lambda: run(x))
            rows[("local_track_segments", dtype, L, "S=8")] = (err,) + timing

    # #6: the one-pass trunk at the widths the reference runs it at.
    for width, G, H in ((128, 512, 4), (256, 512, 8)):
        cfg = dataclasses.replace(base, local_dim=width, global_dim=G,
                                  num_heads=H)
        blk = to_device(block_init(gen, cfg), dev)
        v = G // H
        for dtype in (torch.bfloat16, torch.float32):
            s = dtype.itemsize
            cast = cast_block(blk, dtype)
            track = {name: cast[name] for name in TRACK_PARAMS}
            attn = cast["attention"]
            for L in (128, 512, 100):
                x = torch.randn((B, L, width), generator=gen).to(dev, dtype)
                # Dense rows: a half-padded row and an all-pad row.
                bc = torch.randn((B, 1, width), generator=gen).to(dev, dtype)
                g = torch.randn((B, 1, G), generator=gen).to(dev, dtype)
                pad = torch.ones((B, L), dtype=torch.bool, device=dev)
                pad[1, L // 2:] = False
                pad[2, :] = False
                ones = torch.ones((B, L, 1), device=dev)
                # Packed rows: S=8, segment 8 empty, 10% in-span <pad>.
                bs = torch.randn((B, S, width), generator=gen).to(dev, dtype)
                gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
                seg = packed_ids(gen, B, L, S).to(dev)
                real = (torch.rand((B, L), generator=gen) > 0.1).to(dev)
                oh = segment_one_hot(seg, S)
                cases = {
                    "dense": (lambda xx: fused_onepass(
                                  track, attn, xx, bc, g, None, pad, 1, wd,
                                  False),
                              lambda: onepass_oh_reference(
                                  track, attn, x, bc, g, ones,
                                  pad[..., None].float(), 1, wd, False,
                                  False), 1),
                    "S=8": (lambda xx: fused_onepass(
                                track, attn, xx, bs, gs, seg, real, 1, wd,
                                True),
                            lambda: onepass_oh_reference(
                                track, attn, x, bs, gs, oh,
                                real[..., None].float(), 1, wd, True, True),
                            S),
                }
                for case, (run, plain, n_seg) in cases.items():
                    got = run(x)
                    want = plain()
                    torch.cuda.synchronize()
                    check(all(torch.isfinite(t).all().item() for t in got),
                          f"one_pass {case} non-finite")
                    err = max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(got, want))
                    if case == "S=8":
                        empty = got[1][:, S - 1]
                        check(bool((empty == 0).all())
                              and not torch.signbit(empty).any(),
                              "one_pass: empty segment not exactly +0.0")
                        check(isolated(run, x, seg, 3, gen, got),
                              f"one_pass C={width} {dtype} L={L}: segments "
                              "not isolated bit for bit")
                    timing = (None,) * 5
                    if L != 100 and width == 128:
                        nbytes = ((2 * B * L * width + B * n_seg * width
                                   + 2 * B * n_seg * G + 19 * width * width
                                   + H * (G * k + width * (k + v))) * s
                                  + (2 if n_seg > 1 else 1) * B * L * 4
                                  + 7 * width * 4)
                        b_ms, b_by = bound(
                            onepass_ops(B, L, width, G, n_seg, H, k),
                            nbytes, dtype)
                        per_call = launches(ONEPASS, lambda: run(x))
                        check(per_call == 1, f"one_pass launched {per_call} "
                                             "times in one call")
                        timing = (time_ms(lambda: run(x)), time_ms(plain),
                                  b_ms, b_by, per_call)
                        if dtype == torch.bfloat16 and L == 512:
                            print_passes(card, f"one_pass bf16 B=8 L=512 "
                                               f"C=128 {case}",
                                         lambda: run(x), ONEPASS_PASSES)
                    rows[("one_pass", dtype, L,
                          f"C={width} {case}")] = (err,) + timing

    # #6 at C=512 (bf16 only: the rule never admits float32 there), where
    # the one-pass rule admits G=512, H=4 up to L=128; then the dispatch
    # entries must pick it there, and for the base preset's H=8 at L=8.
    dtype, width = torch.bfloat16, 512
    for G, H, L in ((512, 4, 128), (512, 8, 8)):
        cfg = dataclasses.replace(base, local_dim=width, global_dim=G,
                                  num_heads=H)
        cast = cast_block(to_device(block_init(gen, cfg), dev), dtype)
        track = {name: cast[name] for name in TRACK_PARAMS}
        attn = cast["attention"]
        x = torch.randn((B, L, width), generator=gen).to(dev, dtype)
        bs = torch.randn((B, S, width), generator=gen).to(dev, dtype)
        gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
        seg = packed_ids(gen, B, max(L, 64), S)[:, :L].to(dev)
        real = torch.ones((B, L), dtype=torch.bool, device=dev)
        pad = real.clone()
        pad[1, L // 2:] = False
        oh = segment_one_hot(seg, S)

        def packed(xx):
            return fused_onepass(track, attn, xx, bs, gs, seg, real, 1, wd,
                                 True)

        got = packed(x)
        want = onepass_oh_reference(track, attn, x, bs, gs, oh,
                                    real[..., None].float(), 1, wd, True,
                                    True)
        got_d = fused_onepass(track, attn, x, bs[:, :1], gs[:, :1], None, pad,
                              1, wd, False)
        want_d = onepass_oh_reference(
            track, attn, x, bs[:, :1], gs[:, :1],
            torch.ones((B, L, 1), device=dev), pad[..., None].float(), 1, wd,
            False, False)
        torch.cuda.synchronize()
        for case, a, b in (("S=8", got, want), ("dense", got_d, want_d)):
            check(all(torch.isfinite(t).all().item() for t in a),
                  f"one_pass C=512 {case} non-finite")
            err = max((u.float() - v.float()).abs().max().item()
                      for u, v in zip(a, b))
            timing = (None,) * 5
            if case == "S=8" and H == 4:
                check(isolated(packed, x, seg, 3, gen, got),
                      "one_pass C=512: segments not isolated bit for bit")
                nbytes = ((2 * B * L * width + B * S * width
                           + 2 * B * S * G + 19 * width * width
                           + H * (G * k + width * (k + G // H))) * 2
                          + 2 * B * L * 4 + 7 * width * 4)
                b_ms, b_by = bound(onepass_ops(B, L, width, G, S, H, k),
                                   nbytes, dtype)
                per_call = launches(ONEPASS, lambda: packed(x))
                timing = (time_ms(lambda: packed(x)),
                          time_ms(lambda: onepass_oh_reference(
                              track, attn, x, bs, gs, oh,
                              real[..., None].float(), 1, wd, True, True)),
                          b_ms, b_by, per_call)
            rows[("one_pass", dtype, L, f"C=512 H={H} {case}")] = (
                (err,) + timing)
        counts = [k.launches for k in (ONEPASS, LOCAL_TRACK_SEGMENTS,
                                       LOCAL_TRACK, ATTENTION)]
        fused_onepass_segments(track, attn, x, bs, gs, seg)
        fused_onepass_dense(track, attn, x, bs[:, 0], gs[:, 0], pad)
        moved = [k.launches - n for k, n in zip(
            (ONEPASS, LOCAL_TRACK_SEGMENTS, LOCAL_TRACK, ATTENTION), counts)]
        check(moved == [2, 0, 0, 0],
              f"C=512 G={G} H={H} L={L}: the dispatch launched "
              f"(#6, #3, K1, K2) {moved} times, want (2, 0, 0, 0)")


def large_kernel_phase(card: str, rows: dict) -> None:
    """#2 at ProteinBERT-Large width (C=1024) against K1's plain version,
    bf16 and fp32, B=8, L in {128, 1024} timed and L=100 with a constant
    row (a row of <pad> embeddings); #4 at the same width and L on packed
    rows (S=8) against #3's plain version, with isolation bit for bit; K2
    at Large width (C=G=1024, H=16, L=1024) dense and packed (S=8), and at
    value_dim 128 (C=256, G=512, H=4)."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK_SEGMENTS_TILED, LOCAL_TRACK_TILED,
        TRACK_PARAMS, attention_oh_reference, fused_global_attention,
        fused_local_track, fused_local_track_segments,
        fused_packed_attention, local_track_reference,
        local_track_segment_oh_reference, segment_one_hot,
    )
    from proteinbert_tpu_torch.kernels.attention import attention_flops
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )

    large = get_preset("large").model
    gen = torch.Generator().manual_seed(21)
    dev = torch.device(DEVICE)
    block = to_device(block_init(gen, large), dev)
    C, G, H, k = large.local_dim, large.global_dim, large.num_heads, \
        large.key_dim
    wd = large.wide_dilation
    small = dataclasses.replace(large, local_dim=256, global_dim=512,
                                num_heads=4)
    v128 = to_device(block_init(gen, small), dev)

    def launches(kernel, fn):
        n0 = kernel.launches
        fn()
        return kernel.launches - n0

    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        cast = cast_block(block, dtype)
        track = {name: cast[name] for name in TRACK_PARAMS}
        attn = cast["attention"]
        for L in (128, 1024, 100):
            B = 8
            x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
            if L == 100:
                x[1] = x[1, :1]           # every position the same vector
            bc = torch.randn((B, C), generator=gen).to(dev, dtype)
            got = fused_local_track(track, x, bc, 1, wd)
            want = local_track_reference(track, x, bc, 1, wd)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(),
                  "local_track_tiled non-finite")
            err = (got.float() - want.float()).abs().max().item()
            timing = (None,) * 5
            if L != 100:
                nbytes = (2 * B * L * C + B * C + 19 * C * C) * s + 7 * C * 4
                b_ms, b_by = bound(local_track_flops(B, L, C), nbytes, dtype)
                per_call = launches(LOCAL_TRACK_TILED, lambda: fused_local_track(
                    track, x, bc, 1, wd))
                check(per_call == 1, f"local_track_tiled launched {per_call} "
                                     "times in one call")
                timing = (time_ms(lambda: fused_local_track(track, x, bc, 1,
                                                            wd)),
                          time_ms(lambda: local_track_reference(track, x, bc,
                                                                1, wd)),
                          b_ms, b_by, per_call)
                if L == 1024:
                    print_passes(card, f"local_track_tiled {str(dtype)[6:]} "
                                       "B=8 L=C=1024",
                                 lambda: fused_local_track(track, x, bc, 1,
                                                           wd))
            rows[("local_track_tiled", dtype, L, "dense")] = (err,) + timing

        # #4: packed rows at Large width, S=8, row 0 over the tile edges.
        S = 8
        for L in (128, 1024, 100):
            B = 8
            x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
            bs = torch.randn((B, S, C), generator=gen).to(dev, dtype)
            seg = tiled_ids(gen, B, L, S).to(dev)
            oh = segment_one_hot(seg, S)

            def run(xx):
                return (fused_local_track_segments(track, xx, bs, seg, 1, wd),
                        None)

            got = run(x)
            want = local_track_segment_oh_reference(track, x, bs, oh, 1, wd)
            torch.cuda.synchronize()
            check(torch.isfinite(got[0]).all().item(),
                  "local_track_segments_tiled non-finite")
            err = (got[0].float() - want.float()).abs().max().item()
            for sid in TILE_EDGE_SIDS:
                if not bool((seg == sid).any()):   # clipped away at L=100
                    continue
                check(isolated(run, x, seg, sid, gen, got),
                      f"local_track_segments_tiled {dtype} L={L}: segment "
                      f"{sid} not isolated bit for bit")
            timing = (None,) * 5
            if L != 100:
                nbytes = ((2 * B * L * C + B * S * C + 19 * C * C) * s
                          + B * L * 4 + 7 * C * 4)
                b_ms, b_by = bound(local_track_flops(B, L, C), nbytes, dtype)
                per_call = launches(LOCAL_TRACK_SEGMENTS_TILED,
                                    lambda: run(x))
                check(per_call == 1, f"local_track_segments_tiled launched "
                                     f"{per_call} times in one call")
                timing = (time_ms(lambda: run(x)),
                          time_ms(lambda: local_track_segment_oh_reference(
                              track, x, bs, oh, 1, wd)),
                          b_ms, b_by, per_call)
                if L == 1024:
                    print_passes(card, f"local_track_segments_tiled "
                                       f"{str(dtype)[6:]} B=8 L=C=1024 S=8",
                                 lambda: run(x))
            rows[("local_track_segments_tiled", dtype, L, "S=8")] = (
                (err,) + timing)

        # #2 and #4 at the other ends of their widths, bf16: C=640 (a last
        # 128-column round of the finish pass's 256-column rounds) and
        # C=2048 (32-row finish tiles), B=2, L=200.
        for Cw in ((640, 2048) if dtype == torch.bfloat16 else ()):
            wide = cast_block(to_device(block_init(
                gen, dataclasses.replace(large, local_dim=Cw)), dev), dtype)
            tw = {name: wide[name] for name in TRACK_PARAMS}
            x = torch.randn((2, 200, Cw), generator=gen).to(dev, dtype)
            bc = torch.randn((2, Cw), generator=gen).to(dev, dtype)
            bs = torch.randn((2, S, Cw), generator=gen).to(dev, dtype)
            seg = tiled_ids(gen, 2, 200, S).to(dev)
            for name, got, want in (
                    ("local_track_tiled", fused_local_track(tw, x, bc, 1, wd),
                     local_track_reference(tw, x, bc, 1, wd)),
                    ("local_track_segments_tiled",
                     fused_local_track_segments(tw, x, bs, seg, 1, wd),
                     local_track_segment_oh_reference(
                         tw, x, bs, segment_one_hot(seg, S), 1, wd))):
                torch.cuda.synchronize()
                check(torch.isfinite(got).all().item(), f"{name} C={Cw} "
                                                        "non-finite")
                rows[(name, dtype, 200, f"C={Cw}")] = (
                    (got.float() - want.float()).abs().max().item(),
                    None, None, None, None, None)
            del wide, tw

        # K2's packed entry at Large width: S=8, 10% in-span <pad>.
        B, L = 8, 1024
        x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
        gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
        seg = packed_ids(gen, B, L, S).to(dev)
        real = (torch.rand((B, L), generator=gen) > 0.1).to(dev)
        oh = segment_one_hot(seg, S) * real[..., None]
        got = fused_packed_attention(attn, x, gs, seg, real)
        want = attention_oh_reference(attn, x, gs, oh)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item()
              and bool((got[:, S - 1] == 0).all()),
              "Large packed attention non-finite or empty segment not zero")
        nbytes = ((B * L * C + 2 * B * S * G + H * (G * k + 2 * C * k)) * s
                  + B * L * (seg.element_size() + 1))
        b_ms, b_by = bound(attention_ops(B, L, C, G, S, H, k), nbytes, dtype)
        per_call = launches(ATTENTION, lambda: fused_packed_attention(
            attn, x, gs, seg, real))
        rows[("global_attention", dtype, L, "Large S=8")] = (
            (got.float() - want.float()).abs().max().item(),
            time_ms(lambda: fused_packed_attention(attn, x, gs, seg, real)),
            time_ms(lambda: attention_oh_reference(attn, x, gs, oh)),
            b_ms, b_by, per_call)
        if dtype == torch.bfloat16:
            print_passes(card, "global_attention bf16 B=8 L=C=G=1024 H=16 S=8",
                         lambda: fused_packed_attention(attn, x, gs, seg,
                                                        real), K2_PASSES)

        # K2 at Large width, dense rows, a half-padded and an all-pad row.
        B, L = 8, 1024
        x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
        g = torch.randn((B, G), generator=gen).to(dev, dtype)
        pad = torch.ones((B, L), dtype=torch.bool, device=dev)
        pad[1, L // 2:] = False
        pad[2, :] = False
        oh = pad[..., None].float()
        got = fused_global_attention(attn, x, g, pad)
        want = attention_oh_reference(attn, x, g[:, None, :], oh,
                                      zero_empty=False).reshape(B, G)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item(), "Large attention non-finite")
        err = (got.float() - want.float()).abs().max().item()
        nbytes = ((B * L * C + B * G * 2 + H * (G * k + 2 * C * k)) * s
                  + B * L)
        b_ms, b_by = bound(attention_flops(B, L, C, G, 1, H, k), nbytes, dtype)
        per_call = launches(ATTENTION, lambda: fused_global_attention(
            attn, x, g, pad))
        rows[("global_attention", dtype, L, "Large")] = (
            err, time_ms(lambda: fused_global_attention(attn, x, g, pad)),
            time_ms(lambda: attention_oh_reference(attn, x, g[:, None, :], oh,
                                                   zero_empty=False)),
            b_ms, b_by, per_call)
        if dtype == torch.bfloat16:
            print_passes(card, "global_attention bf16 B=8 L=C=G=1024 H=16 "
                               "dense",
                         lambda: fused_global_attention(attn, x, g, pad),
                         K2_PASSES)

        # K2 at value_dim 128 (G=512, H=4), a shape the one-pass rule sends
        # to the composition in fp32 at L=512.
        a128 = cast_block(v128, dtype)["attention"]
        x = torch.randn((B, 512, 256), generator=gen).to(dev, dtype)
        g = torch.randn((B, 512), generator=gen).to(dev, dtype)
        pad = torch.ones((B, 512), dtype=torch.bool, device=dev)
        pad[1, 200:] = False
        got = fused_global_attention(a128, x, g, pad)
        want = attention_oh_reference(a128, x, g[:, None, :],
                                      pad[..., None].float(),
                                      zero_empty=False).reshape(B, 512)
        torch.cuda.synchronize()
        rows[("global_attention", dtype, 512, "v=128")] = (
            (got.float() - want.float()).abs().max().item(),
            None, None, None, None, None)


def valid_kernel_phase(card: str, rows: dict) -> None:
    """The prehaloed entries (`fused_local_track_valid`): K1's at the
    `long` preset's width (C=512) and #2's at Large width (C=1024), bf16
    and fp32. One L=2048 row set is cut into shards of 512 (C=512) or 256
    (C=1024) rows, each with its neighbours' 20 rows (zeros at the ends):
    every shard's centre must equal the same rows of `fused_local_track`
    on the whole row bit for bit, since each output row's arithmetic reads
    only its window's rows. A middle shard (real halo rows on both sides)
    is held against the plain version and, in bf16, timed at the `long`
    preset's shard shape (B=16, L=512+2*20, C=512) and at C=1024, L=256
    (B=8). The shapes the train phases give the entries on a one-rank
    group — one whole row with `halo_exchange`'s 20 zero rows each side,
    B=4, L=2048+2*20, C=512 (`train long seq`) and B=8, L=1024+2*20,
    C=1024 (`train large seq`) — are held against the plain version too."""
    import torch.nn.functional as F

    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        LOCAL_TRACK_TILED_VALID, LOCAL_TRACK_VALID, TRACK_PARAMS,
        fused_local_track, fused_local_track_valid,
        local_track_valid_reference, track_halo,
    )
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )

    gen = torch.Generator().manual_seed(61)
    dev = torch.device(DEVICE)
    for preset, kernel, B, Ls, Bm, Lm in (
            ("long", LOCAL_TRACK_VALID, 16, 512, 4, 2048),
            ("large", LOCAL_TRACK_TILED_VALID, 8, 256, 8, 1024)):
        cfg = get_preset(preset).model
        C, wd = cfg.local_dim, cfg.wide_dilation
        block = to_device(block_init(gen, cfg), dev)
        for dtype in (torch.bfloat16, torch.float32):
            s = dtype.itemsize
            cast = cast_block(block, dtype)
            track = {name: cast[name] for name in TRACK_PARAMS}
            H = track_halo(track, 1, wd)
            x = torch.randn((B, 2048, C), generator=gen).to(dev, dtype)
            bc = torch.randn((B, C), generator=gen).to(dev, dtype)
            xp = F.pad(x, (0, 0, H, H))
            whole = fused_local_track(track, x, bc, 1, wd)
            shards = [fused_local_track_valid(
                track, xp[:, i * Ls:(i + 1) * Ls + 2 * H], bc, 1, wd)
                for i in range(2048 // Ls)]
            torch.cuda.synchronize()
            stitched = torch.cat(shards, dim=1)
            print(f"# {kernel.name} {str(dtype)[6:]}: {len(shards)} shards "
                  f"of {Ls} rows (+2*{H}) vs the whole L=2048 row: max "
                  f"|diff| {(stitched.float() - whole.float()).abs().max().item()}"
                  f" [{card}]")
            check(torch.equal(stitched, whole),
                  f"{kernel.name} {dtype}: shard centres are not the whole "
                  "row's track bit for bit")
            xh = xp[:, Ls:2 * Ls + 2 * H].contiguous()  # real halos
            got = fused_local_track_valid(track, xh, bc, 1, wd)
            want = local_track_valid_reference(track, xh, bc, 1, wd)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(),
                  f"{kernel.name} non-finite")
            err = (got.float() - want.float()).abs().max().item()
            timing = (None,) * 5
            if dtype == torch.bfloat16:
                nbytes = ((B * (Ls + 2 * H) * C + B * Ls * C + B * C
                           + 19 * C * C) * s + 7 * C * 4)
                b_ms, b_by = bound(local_track_flops(B, Ls, C), nbytes, dtype)
                n0 = kernel.launches
                fused_local_track_valid(track, xh, bc, 1, wd)
                per_call = kernel.launches - n0
                check(per_call == 1, f"{kernel.name} launched {per_call} "
                                     "times in one call")
                timing = (time_ms(lambda: fused_local_track_valid(
                              track, xh, bc, 1, wd)),
                          time_ms(lambda: local_track_valid_reference(
                              track, xh, bc, 1, wd)),
                          b_ms, b_by, per_call)
                print_passes(card, f"{kernel.name} bf16 B={B} "
                                   f"L={Ls}+2*{H} C={C}",
                             lambda: fused_local_track_valid(
                                 track, xh, bc, 1, wd))
            rows[(kernel.name, dtype, Ls, "shard")] = (err,) + timing
            xm = F.pad(torch.randn((Bm, Lm, C), generator=gen).to(dev, dtype),
                       (0, 0, H, H))   # the main path's shape, world 1
            bm = torch.randn((Bm, C), generator=gen).to(dev, dtype)
            got = fused_local_track_valid(track, xm, bm, 1, wd)
            want = local_track_valid_reference(track, xm, bm, 1, wd)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(),
                  f"{kernel.name} non-finite at the main path's shape")
            rows[(kernel.name, dtype, Lm, "main path")] = (
                (got.float() - want.float()).abs().max().item(),
                None, None, None, None, None)


# ------------------------------------------------------------ int8 legs

def q8_block(gen, cfg, dtype):
    """One block's track and attention weights as the int8 arm's forward
    holds them (`quantize_params`, then `cast_block`: quant leaves as they
    are, biases in the activation dtype, LN float32), and the same weights
    dequantized — the fp leg's operands. Returns (qtrack, qattn, track,
    attn, int8 weight bytes with their scales)."""
    from proteinbert_tpu_torch.kernels import TRACK_PARAMS, dequant_params
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )
    from proteinbert_tpu_torch.parallel.quant import (
        param_bytes, quantize_params,
    )

    q = cast_block(quantize_params(to_device(block_init(gen, cfg),
                                             torch.device(DEVICE))), dtype)
    qtrack = {name: q[name] for name in TRACK_PARAMS}
    qattn = q["attention"]
    wbytes = (param_bytes([qtrack[n]["kernel"] for n in
                           ("narrow_conv", "wide_conv", "local_dense")]),
              param_bytes(qattn))
    return qtrack, qattn, dequant_params(qtrack), dequant_params(qattn), wbytes


def q8_kernel_phase(card: str, rows: dict) -> dict:
    """The int8 legs of #3, K2 and #6 at the served shapes, bf16 and fp32:
    #3-int8 at base width (B=8, C=512, S=8); K2-int8 at base width (C=G=512,
    H=8) dense and packed (S=8) and at value_dim 128 (C=128, G=512, H=4);
    #6-int8 at C=128 (G=512, H=4) and C=256 (G=512, H=8) dense and packed,
    and at C=512 in bf16 (H=4, L=128). L=512 timed (#6 at C=512: L=128),
    and L=100 with an all-pad row and an empty segment. Each leg must give
    exactly (max |diff| == 0.0) the fp leg's output on the dequantized
    weights, lie within the fp leg's tolerance of the plain version, and
    return an empty segment as +0.0. Returns {row key: (exact diff, fp leg
    ms)}; the rows join `rows`."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_Q8, ONEPASS, ONEPASS_Q8, attention_oh_reference,
        fused_global_attention, fused_local_track_segments,
        fused_packed_attention, local_track_segment_oh_reference,
        onepass_oh_reference, segment_one_hot,
    )
    from proteinbert_tpu_torch.kernels.attention import attention_flops
    from proteinbert_tpu_torch.kernels.fused_block import local_track_flops
    from proteinbert_tpu_torch.kernels.one_pass import (
        fused_onepass, fused_onepass_segments,
    )

    base = get_preset("base").model
    gen = torch.Generator().manual_seed(31)
    dev = torch.device(DEVICE)
    B, S, k, wd = 8, 8, base.key_dim, base.wide_dilation
    fp_leg = {LOCAL_TRACK_SEGMENTS_Q8: LOCAL_TRACK_SEGMENTS,
              ATTENTION_Q8: ATTENTION, ONEPASS_Q8: ONEPASS}
    extra = {}

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    def case(kernel, dtype, L, label, q_run, f_run, plain, timed, flops,
             nbytes, empty=None):
        """One int8-leg case: `q_run` the int8 leg, `f_run` the fp leg on
        the dequantized weights, `plain` its plain version; `empty` picks
        the output of an empty segment from q_run's outputs."""
        got, fp, want = as_tuple(q_run()), as_tuple(f_run()), as_tuple(plain())
        torch.cuda.synchronize()
        tag = f"{kernel.name} {str(dtype)[6:]} L={L} {label}"
        check(all(torch.isfinite(t).all().item() for t in got),
              f"{tag}: non-finite")
        exact = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(got, fp))
        check(exact == 0.0, f"{tag}: int8 leg vs fp leg on the dequantized "
                            f"weights max |diff| {exact}, want 0.0")
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        if empty is not None:
            e = empty(got)
            check(bool((e == 0).all()) and not torch.signbit(e).any(),
                  f"{tag}: empty segment not exactly +0.0")
        timing, fp_ms = (None,) * 5, None
        if timed:
            n0, f0 = kernel.launches, fp_leg[kernel].launches
            q_run()
            per_call = kernel.launches - n0
            check(per_call == 1 and fp_leg[kernel].launches == f0,
                  f"{tag}: {per_call} int8 launches and "
                  f"{fp_leg[kernel].launches - f0} fp launches in one call")
            b_ms, b_by = bound(flops, nbytes, dtype)
            timing = (time_ms(q_run), time_ms(plain), b_ms, b_by, per_call)
            fp_ms = time_ms(f_run)
        rows[(kernel.name, dtype, L, label)] = (err,) + timing
        extra[(kernel.name, dtype, L, label)] = (exact, fp_ms)

    def pad_rows(L):
        pad = torch.ones((B, L), dtype=torch.bool, device=dev)
        pad[1, L // 2:] = False   # half-padded row
        pad[2, :] = False         # all-pad row
        return pad

    def ids(L):
        seg = packed_ids(gen, B, max(L, 64), S)[:, :L]
        if L == 100:
            seg[2] = 0            # an all-pad row
        return seg.to(dev)

    for dtype in (torch.bfloat16, torch.float32):
        s = dtype.itemsize
        # #3-int8 and K2-int8 at base width.
        qt, qa, ft, fa, (tbytes, abytes) = q8_block(gen, base, dtype)
        C, G, H = base.local_dim, base.global_dim, base.num_heads
        for L in (512, 100):
            timed = L == 512
            x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
            bs = torch.randn((B, S, C), generator=gen).to(dev, dtype)
            seg = ids(L)
            oh = segment_one_hot(seg, S)
            case(LOCAL_TRACK_SEGMENTS_Q8, dtype, L, "S=8",
                 lambda: fused_local_track_segments(qt, x, bs, seg, 1, wd),
                 lambda: fused_local_track_segments(ft, x, bs, seg, 1, wd),
                 lambda: local_track_segment_oh_reference(ft, x, bs, oh, 1,
                                                          wd),
                 timed, local_track_flops(B, L, C) + 2 * B * L * S * C,
                 (2 * B * L * C + B * S * C) * s + tbytes + B * L * 4
                 + 7 * C * 4)
            if timed and dtype == torch.bfloat16:
                print_passes(card, "local_track_segments_q8 bf16 B=8 L=512 "
                                   "C=512 S=8",
                             lambda: fused_local_track_segments(
                                 qt, x, bs, seg, 1, wd))
                print_passes(card, "local_track_segments (its fp leg) bf16 "
                                   "B=8 L=512 C=512 S=8",
                             lambda: fused_local_track_segments(
                                 ft, x, bs, seg, 1, wd))
            g = torch.randn((B, G), generator=gen).to(dev, dtype)
            pad = pad_rows(L)
            poh = pad[..., None].float()
            case(ATTENTION_Q8, dtype, L, "dense",
                 lambda: fused_global_attention(qa, x, g, pad),
                 lambda: fused_global_attention(fa, x, g, pad),
                 lambda: attention_oh_reference(
                     fa, x, g[:, None, :], poh,
                     zero_empty=False).reshape(B, G),
                 timed, attention_flops(B, L, C, G, 1, H, k),
                 (B * L * C + 2 * B * G) * s + abytes + B * L)
            gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
            case(ATTENTION_Q8, dtype, L, "S=8",
                 lambda: fused_packed_attention(qa, x, gs, seg),
                 lambda: fused_packed_attention(fa, x, gs, seg),
                 lambda: attention_oh_reference(fa, x, gs, oh),
                 timed, attention_ops(B, L, C, G, S, H, k),
                 (B * L * C + 2 * B * S * G) * s + abytes
                 + B * L * seg.element_size(),
                 empty=lambda out: out[0][:, S - 1])
            if timed and dtype == torch.bfloat16:
                for label, q_run, f_run in (
                        ("dense", lambda: fused_global_attention(qa, x, g, pad),
                         lambda: fused_global_attention(fa, x, g, pad)),
                        ("S=8", lambda: fused_packed_attention(qa, x, gs, seg),
                         lambda: fused_packed_attention(fa, x, gs, seg))):
                    print_passes(card, f"global_attention_q8 bf16 B=8 L=512 "
                                       f"C=G=512 H=8 {label}", q_run,
                                 K2_PASSES)
                    print_passes(card, f"global_attention (its fp leg) bf16 "
                                       f"B=8 L=512 C=G=512 H=8 {label}",
                                 f_run, K2_PASSES)

        # #6-int8 (and K2-int8 at value_dim 128) at the narrower widths.
        for width, G, H in ((128, 512, 4), (256, 512, 8)):
            cfg = dataclasses.replace(base, local_dim=width, global_dim=G,
                                      num_heads=H)
            qt, qa, ft, fa, (tbytes, abytes) = q8_block(gen, cfg, dtype)
            for L in ((512, 100) if width == 128 else (100,)):
                timed = L == 512
                x = torch.randn((B, L, width), generator=gen).to(dev, dtype)
                bc = torch.randn((B, 1, width), generator=gen).to(dev, dtype)
                g = torch.randn((B, 1, G), generator=gen).to(dev, dtype)
                pad = pad_rows(L)
                ones = torch.ones((B, L, 1), device=dev)
                bs = torch.randn((B, S, width), generator=gen).to(dev, dtype)
                gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
                seg = ids(L)
                real = (torch.rand((B, L), generator=gen) > 0.1).to(dev)
                oh = segment_one_hot(seg, S)
                for label, n_seg, run, plain, empty in (
                        ("dense", 1,
                         lambda w, xx=x: fused_onepass(
                             w[0], w[1], xx, bc, g, None, pad, 1, wd, False),
                         lambda: onepass_oh_reference(
                             ft, fa, x, bc, g, ones, pad[..., None].float(),
                             1, wd, False, False), None),
                        ("S=8", S,
                         lambda w, xx=x: fused_onepass(
                             w[0], w[1], xx, bs, gs, seg, real, 1, wd, True),
                         lambda: onepass_oh_reference(
                             ft, fa, x, bs, gs, oh, real[..., None].float(),
                             1, wd, True, True),
                         lambda out: out[1][:, S - 1])):
                    case(ONEPASS_Q8, dtype, L, f"C={width} {label}",
                         lambda run=run: run((qt, qa)),
                         lambda run=run: run((ft, fa)), plain, timed,
                         onepass_ops(B, L, width, G, n_seg, H, k),
                         (2 * B * L * width + B * n_seg * (width + 2 * G)) * s
                         + tbytes + abytes
                         + (2 if n_seg > 1 else 1) * B * L * 4
                         + 7 * width * 4, empty)
                if width == 128 and L == 100:
                    # K2-int8's value_dim 128 instantiation.
                    case(ATTENTION_Q8, dtype, L, "v=128 S=8",
                         lambda: fused_packed_attention(qa, x, gs, seg),
                         lambda: fused_packed_attention(fa, x, gs, seg),
                         lambda: attention_oh_reference(fa, x, gs, oh),
                         False, 0, 0, empty=lambda out: out[0][:, S - 1])

    # K2-int8 at Large width (C=G=1024, H=16, k=64), bf16: the int8 arm at
    # Large runs it (`large_int8_phase`), dense and packed.
    large = get_preset("large").model
    dtype, L = torch.bfloat16, 1024
    qt, qa, ft, fa, (tbytes, abytes) = q8_block(gen, large, dtype)
    C, G, H = large.local_dim, large.global_dim, large.num_heads
    x = torch.randn((B, L, C), generator=gen).to(dev, dtype)
    g = torch.randn((B, G), generator=gen).to(dev, dtype)
    gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
    pad = pad_rows(L)
    seg = ids(L)
    oh = segment_one_hot(seg, S)
    case(ATTENTION_Q8, dtype, L, "Large dense",
         lambda: fused_global_attention(qa, x, g, pad),
         lambda: fused_global_attention(fa, x, g, pad),
         lambda: attention_oh_reference(
             fa, x, g[:, None, :], pad[..., None].float(),
             zero_empty=False).reshape(B, G),
         True, attention_flops(B, L, C, G, 1, H, k),
         (B * L * C + 2 * B * G) * 2 + abytes + B * L)
    case(ATTENTION_Q8, dtype, L, "Large S=8",
         lambda: fused_packed_attention(qa, x, gs, seg),
         lambda: fused_packed_attention(fa, x, gs, seg),
         lambda: attention_oh_reference(fa, x, gs, oh),
         True, attention_ops(B, L, C, G, S, H, k),
         (B * L * C + 2 * B * S * G) * 2 + abytes
         + B * L * seg.element_size(),
         empty=lambda out: out[0][:, S - 1])
    for label, q_run, f_run in (
            ("dense", lambda: fused_global_attention(qa, x, g, pad),
             lambda: fused_global_attention(fa, x, g, pad)),
            ("S=8", lambda: fused_packed_attention(qa, x, gs, seg),
             lambda: fused_packed_attention(fa, x, gs, seg))):
        print_passes(card, f"global_attention_q8 bf16 B=8 L=1024 C=G=1024 "
                           f"H=16 {label}", q_run, K2_PASSES)
        print_passes(card, f"global_attention (its fp leg) bf16 B=8 L=1024 "
                           f"C=G=1024 H=16 {label}", f_run, K2_PASSES)

    # #6-int8 at C=512 (bf16 only, as the fp leg), where the one-pass rule
    # admits G=512, H=4 up to L=128; the packed dispatch entry must pick it.
    dtype, width, G, H = torch.bfloat16, 512, 512, 4
    cfg = dataclasses.replace(base, local_dim=width, global_dim=G,
                              num_heads=H)
    qt, qa, ft, fa, (tbytes, abytes) = q8_block(gen, cfg, dtype)
    for L in (128, 100):
        x = torch.randn((B, L, width), generator=gen).to(dev, dtype)
        bs = torch.randn((B, S, width), generator=gen).to(dev, dtype)
        gs = torch.randn((B, S, G), generator=gen).to(dev, dtype)
        seg = ids(L)
        real = torch.ones((B, L), dtype=torch.bool, device=dev)
        oh = segment_one_hot(seg, S)
        case(ONEPASS_Q8, dtype, L, "C=512 H=4 S=8",
             lambda: fused_onepass(qt, qa, x, bs, gs, seg, real, 1, wd, True),
             lambda: fused_onepass(ft, fa, x, bs, gs, seg, real, 1, wd, True),
             lambda: onepass_oh_reference(ft, fa, x, bs, gs, oh,
                                          real[..., None].float(), 1, wd,
                                          True, True),
             L == 128, onepass_ops(B, L, width, G, S, H, k),
             (2 * B * L * width + B * S * (width + 2 * G)) * 2 + tbytes
             + abytes + 2 * B * L * 4 + 7 * width * 4,
             empty=lambda out: out[1][:, S - 1])
    legs = (ONEPASS_Q8, LOCAL_TRACK_SEGMENTS_Q8, ATTENTION_Q8, ONEPASS,
            LOCAL_TRACK_SEGMENTS, ATTENTION, LOCAL_TRACK)
    counts = [kk.launches for kk in legs]
    fused_onepass_segments(qt, qa, x, bs, gs, seg)
    moved = [kk.launches - n for kk, n in zip(legs, counts)]
    check(moved == [1, 0, 0, 0, 0, 0, 0],
          f"int8 C=512 H=4 L=100: the packed dispatch launched (#6-int8, "
          f"#3-int8, K2-int8, #6, #3, K2, K1) {moved} times")
    return extra


def print_q8_rows(card: str, rows: dict, extra: dict) -> None:
    """The int8 legs beside their fp legs (the int8 rows of `rows` are
    checked against their tolerance by `print_rows`)."""
    print(f"# int8 legs [{card}]: int8 leg vs fp leg on the dequantized "
          "weights (must be 0.0), int8 ms beside the fp leg's")
    for key, (exact, fp_ms) in extra.items():
        name, dtype, L, label = key
        ms = rows[key][1]
        times = (f"int8 {ms:.4f} ms, fp leg {fp_ms:.4f} ms"
                 if ms is not None else "untimed")
        print(f"#   {name:24s} {str(dtype)[6:]:9s} L={L:<4d} {label:15s} "
              f"exact {exact:.1e}  {times}")


# ------------------------------------------------------------ gradients

def grad_phase(card: str) -> None:
    """Each autograd Function on the card: the grads of sum(out * r)
    (every float input: weights, activations, broadcast and global rows)
    through the kernel wrapper (K1, #2, #3, #4, K2, #6, and K1's and #2's
    prehaloed entry), fp32 and bf16, against float32 autograd of the
    function its backward differentiates (the port of the JAX XLA
    reference) on the same inputs cast up to float32. The wrapper's
    backward IS autograd of that reference at the activation dtype, so the
    fp32 cases check only the plumbing (every input gets a finite grad of
    the right value); the bf16 cases hold the bf16 backward the trainer
    runs (cuDNN's bf16 convs, bf16 GEMMs) against a float32 one, which a
    wrong bf16 backward on the card fails. The kernels' forward plays no
    part in the grads: `kernel_phase` gates it."""
    from proteinbert_tpu_torch.configs import ModelConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        TRACK_PARAMS, attention_oh_grad_reference, fused_attention,
        fused_local_track, fused_local_track_segments,
        fused_local_track_valid, local_track_grad_reference,
        local_track_segment_oh_grad_reference,
        local_track_valid_grad_reference, onepass_oh_grad_reference,
        segment_one_hot,
    )
    from proteinbert_tpu_torch.kernels.one_pass import fused_onepass
    from proteinbert_tpu_torch.models.proteinbert import (
        block_init, cast_block, to_device,
    )

    gen = torch.Generator().manual_seed(31)
    dev = torch.device(DEVICE)
    base, large = get_preset("base").model, get_preset("large").model
    default = ModelConfig()
    blocks = {name: to_device(block_init(gen, cfg), dev)
              for name, cfg in (("base", base), ("large", large),
                                ("default", default))}
    B, L, S = 2, 128, 8

    def grads(fn, inputs):
        outs = fn(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        total = sum((o.float() * rr).sum() for o, rr in zip(outs, r_of(outs)))
        return torch.autograd.grad(total, [t for t in leaves(inputs)])

    r_cache = {}

    def r_of(outs):
        key = tuple(tuple(o.shape) for o in outs)
        if key not in r_cache:
            r_cache[key] = [torch.randn(o.shape, generator=gen).to(dev)
                            for o in outs]
        return r_cache[key]

    def leaves(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in leaves(v)]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in leaves(v)]
        if torch.is_tensor(tree) and tree.requires_grad:
            return [tree]
        return []

    def rg(tree, dtype=None):
        """Fresh leaf copies that require grad (cast to dtype if given)."""
        if isinstance(tree, dict):
            return {k: rg(v, dtype) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rg(v, dtype) for v in tree)
        return tree.detach().to(dtype or tree.dtype).requires_grad_(True)

    for dtype in (torch.bfloat16, torch.float32):
        def rand(*shape):
            return torch.randn(shape, generator=gen).to(dev, dtype)

        seg = packed_ids(gen, B, L, S).to(dev)
        oh = segment_one_hot(seg, S)
        real = (torch.rand((B, L), generator=gen) > 0.1).to(dev)
        cases = {}
        for name, width in (("K1", "base"), ("#2", "large")):
            cast = cast_block(blocks[width], dtype)
            C = cast["local_ln1"]["scale"].shape[0]
            track = rg({n: cast[n] for n in TRACK_PARAMS})
            x, bc = rg(rand(B, L, C)), rg(rand(B, C))
            cases[name] = (
                lambda t, xx, bb: fused_local_track(t, xx, bb, 1, 5),
                lambda t, xx, bb: local_track_grad_reference(t, xx, bb, 1, 5),
                (track, x, bc))
            cases[name + "v"] = (   # the prehaloed entry, 20 halo rows
                lambda t, xx, bb: fused_local_track_valid(t, xx, bb, 1, 5),
                lambda t, xx, bb: local_track_valid_grad_reference(
                    t, xx, bb, 1, 5),
                (rg({n: cast[n] for n in TRACK_PARAMS}),
                 rg(rand(B, L + 40, C)), rg(rand(B, C))))
        cast = cast_block(blocks["base"], dtype)
        C, G = base.local_dim, base.global_dim
        track = rg({n: cast[n] for n in TRACK_PARAMS})
        cases["#3"] = (
            lambda t, xx, bb: fused_local_track_segments(t, xx, bb, seg, 1, 5),
            lambda t, xx, bb: local_track_segment_oh_grad_reference(
                t, xx, bb, oh, 1, 5),
            (track, rg(rand(B, L, C)), rg(rand(B, S, C))))
        cast = cast_block(blocks["large"], dtype)
        C = large.local_dim
        cases["#4"] = (
            lambda t, xx, bb: fused_local_track_segments(t, xx, bb, seg, 1, 5),
            lambda t, xx, bb: local_track_segment_oh_grad_reference(
                t, xx, bb, oh, 1, 5),
            (rg({n: cast[n] for n in TRACK_PARAMS}), rg(rand(B, L, C)),
             rg(rand(B, S, C))))
        cast = cast_block(blocks["base"], dtype)
        C = base.local_dim
        attn = rg(cast["attention"])
        cases["K2"] = (
            lambda a, xx, gg: fused_attention(a, xx, gg, oh * real[..., None]),
            lambda a, xx, gg: attention_oh_grad_reference(
                a, xx, gg, oh * real[..., None]),
            (attn, rg(rand(B, L, C)), rg(rand(B, S, G))))
        cast = cast_block(blocks["default"], dtype)
        C, G = default.local_dim, default.global_dim
        track = rg({n: cast[n] for n in TRACK_PARAMS})
        attn = rg(cast["attention"])
        cases["#6"] = (
            lambda t, a, xx, bb, gg: fused_onepass(t, a, xx, bb, gg, seg,
                                                   real, 1, 5, True),
            lambda t, a, xx, bb, gg: onepass_oh_grad_reference(
                t, a, xx, bb, gg, oh, real[..., None].float(), 1, 5, True,
                True),
            (track, attn, rg(rand(B, L, C)), rg(rand(B, S, C)),
             rg(rand(B, S, G))))
        for name, (kernel_fn, plain_fn, inputs) in cases.items():
            got = grads(kernel_fn, inputs)
            want = grads(plain_fn, rg(inputs, torch.float32))
            torch.cuda.synchronize()
            check(all(torch.isfinite(a).all().item() for a in got),
                  f"{name} grads non-finite")
            if dtype == torch.float32:
                scale = max(w.abs().max().item() for w in want)
                err = max((a - b).abs().max().item()
                          for a, b in zip(got, want)) / max(scale, 1e-30)
                metric = "max |kernel - fp32 ref| / max|grad|"
            else:
                err = max(((a.float() - b).norm()
                           / b.norm().clamp_min(1e-30)).item()
                          for a, b in zip(got, want))
                metric = "max over inputs ||bf16 - fp32 ref|| / ||fp32 ref||"
            print(f"# grad {name:4s} {str(dtype)[6:]:9s} {len(got):3d} inputs: "
                  f"{metric} {err:.3e} (tol {GRAD_TOL[dtype]:.1e}) [{card}]")
            check(err <= GRAD_TOL[dtype], f"{name} {dtype} grads: {err}")


def reference_step_phase(card: str) -> None:
    """A 2-block fp32 train step at Large width (C=G=1024, H=16, 8943
    annotations), B=2, L=128: the loss and every grad on the card (through
    #2 and K2) against the same params and corrupted batch on the CPU
    plain path; then the optimizer update on the card."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.data.corruption import corrupt_batch
    from proteinbert_tpu_torch.kernels import ATTENTION, LOCAL_TRACK_TILED
    from proteinbert_tpu_torch.models.proteinbert import init, to_device
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.schedule import make_optimizer, tree_leaves

    large = get_preset("large")
    cfg = large.replace(
        model=dataclasses.replace(large.model, dtype="float32", num_blocks=2),
        optimizer=dataclasses.replace(large.optimizer, warmup_steps=0,
                                      schedule="constant"))
    params = init(cfg.model, torch.Generator().manual_seed(41), device="cpu")
    rng = np.random.default_rng(41)
    tokens = rng.integers(4, 26, (2, 128)).astype(np.int32)
    tokens[:, 0], tokens[0, 90], tokens[0, 91:] = 1, 2, 0
    ann = (rng.random((2, cfg.model.num_annotations)) < 0.01).astype(
        np.float32)
    X, Y, W = corrupt_batch(torch.Generator().manual_seed(42),
                            torch.from_numpy(tokens), torch.from_numpy(ann))
    want_g, want_m = ts.loss_and_grads(params, X, Y, W, cfg)
    dev = torch.device(DEVICE)
    on = {k: {n: t.to(dev) for n, t in d.items()} for k, d in
          (("X", X), ("Y", Y), ("W", W))}
    card_params = to_device(params, dev)
    n0 = (LOCAL_TRACK_TILED.launches, ATTENTION.launches)
    got_g, got_m = ts.loss_and_grads(card_params, on["X"], on["Y"], on["W"],
                                     cfg)
    torch.cuda.synchronize()
    check((LOCAL_TRACK_TILED.launches - n0[0], ATTENTION.launches - n0[1])
          == (2, 2), "reference step did not run #2 and K2 once a block")
    loss_err = abs(float(got_m["loss"]) - float(want_m["loss"]))
    grad_err = max((a.cpu() - b).abs().max().item()
                   for a, b in zip(got_g, want_g))
    print(f"# reference step: 2-block fp32 Large width, B=2 L=128, card vs "
          f"CPU plain path: loss {float(got_m['loss']):.6f} |diff| "
          f"{loss_err:.3e} (tol {STEP_LOSS_TOL}), grads max |diff| "
          f"{grad_err:.3e} over {len(got_g)} tensors (tol {STEP_GRAD_TOL}) "
          f"[{card}]")
    check(loss_err <= STEP_LOSS_TOL, f"reference step loss {loss_err}")
    check(grad_err <= STEP_GRAD_TOL, f"reference step grads {grad_err}")
    tx = make_optimizer(cfg.optimizer)
    before = [t.clone() for t in tree_leaves(card_params)]
    ts.gradient_update(tx, card_params, got_g, tx.init(card_params))
    after = tree_leaves(card_params)
    check(all(torch.isfinite(t).all().item() for t in after)
          and any(not torch.equal(a, b) for a, b in zip(before, after)),
          "the optimizer update on the card did not move the params")


def packed_reference_phase(card: str) -> None:
    """A 2-block fp32 PACKED train step at Large width (C=G=1024, H=16,
    8943 annotations), B=2, L=128, S=4: the loss and every grad on the
    card (through #4 and K2) against the same params and corrupted batch
    on the CPU plain path. Then each packed protein's loss terms
    (`packed_segment_losses` on the clean batch) against the same protein
    run alone on the card as a dense row of its own length (through #2
    and K2), as the JAX test_packed_vs_solo_per_sequence_parity does."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.data.corruption import (
        corrupt_packed_batch, packed_weights, pretrain_weights,
    )
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK_SEGMENTS_TILED, LOCAL_TRACK_TILED,
    )
    from proteinbert_tpu_torch.models import proteinbert
    from proteinbert_tpu_torch.models.proteinbert import init, to_device
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.loss import (
        packed_segment_losses, pretrain_loss,
    )

    large = get_preset("large")
    cfg = large.replace(
        model=dataclasses.replace(large.model, dtype="float32", num_blocks=2))
    params = init(cfg.model, torch.Generator().manual_seed(43), device="cpu")
    rng = np.random.default_rng(43)
    B, L, S, A = 2, 128, 4, cfg.model.num_annotations
    tokens = np.zeros((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    # Row 0: three proteins and a pad tail; row 1: four, filling the row.
    for r, spans in enumerate(((40, 50, 30), (60, 20, 38, 10))):
        pos = 0
        for sid, n in enumerate(spans, start=1):
            tokens[r, pos + 1:pos + n - 1] = rng.integers(4, 26, n - 2)
            tokens[r, pos], tokens[r, pos + n - 1] = 1, 2
            seg[r, pos:pos + n] = sid
            pos += n
    ann = (rng.random((B, S, A)) < 0.01).astype(np.float32)
    tok, sg, an = (torch.from_numpy(a) for a in (tokens, seg, ann))
    X, Y, W = corrupt_packed_batch(torch.Generator().manual_seed(44), tok,
                                   sg, an)
    want_g, want_m = ts.loss_and_grads(params, X, Y, W, cfg, sg)
    dev = torch.device(DEVICE)
    on = {k: {n: t.to(dev) for n, t in d.items()} for k, d in
          (("X", X), ("Y", Y), ("W", W))}
    card_params = to_device(params, dev)
    n0 = (LOCAL_TRACK_SEGMENTS_TILED.launches, ATTENTION.launches)
    got_g, got_m = ts.loss_and_grads(card_params, on["X"], on["Y"], on["W"],
                                     cfg, sg.to(dev))
    torch.cuda.synchronize()
    check((LOCAL_TRACK_SEGMENTS_TILED.launches - n0[0],
           ATTENTION.launches - n0[1]) == (2, 2),
          "packed reference step did not run #4 and K2 once a block")
    loss_err = abs(float(got_m["loss"]) - float(want_m["loss"]))
    grad_err = max((a.cpu() - b).abs().max().item()
                   for a, b in zip(got_g, want_g))
    print(f"# reference step packed: 2-block fp32 Large width, B=2 L=128 "
          f"S=4, card vs CPU plain path: loss {float(got_m['loss']):.6f} "
          f"|diff| {loss_err:.3e} (tol {STEP_LOSS_TOL}), grads max |diff| "
          f"{grad_err:.3e} over {len(got_g)} tensors (tol {STEP_GRAD_TOL}) "
          f"[{card}]")
    check(loss_err <= STEP_LOSS_TOL, f"packed reference step loss {loss_err}")
    check(grad_err <= STEP_GRAD_TOL, f"packed reference step grads "
                                     f"{grad_err}")

    # Packed vs solo, clean tokens, on the card.
    sg = sg.to(dev)
    Yc = {"local": tok.to(dev), "global": an.to(dev)}
    with torch.no_grad():
        ll, gl = proteinbert.apply(card_params, Yc["local"], Yc["global"],
                                   cfg.model, segment_ids=sg)
        per_seg = packed_segment_losses(
            ll, gl, Yc, packed_weights(Yc["local"], sg, Yc["global"]), sg)
        worst, n, n0 = 0.0, 0, LOCAL_TRACK_TILED.launches
        for r in range(B):
            for s in range(1, S + 1):
                mask = sg[r] == s
                if not mask.any():
                    continue
                toks = Yc["local"][r][mask][None]
                a = Yc["global"][r, s - 1][None]
                ll1, gl1 = proteinbert.apply(card_params, toks, a, cfg.model)
                _, m1 = pretrain_loss(ll1, gl1, {"local": toks, "global": a},
                                      pretrain_weights(toks, a))
                for k, k1 in (("local", "local_loss"),
                              ("global", "global_loss")):
                    worst = max(worst, abs(float(per_seg[k][r, s - 1])
                                           - float(m1[k1])))
                n += 1
    check(LOCAL_TRACK_TILED.launches - n0 == 2 * n,
          "the solo rows did not run #2 once a block")
    print(f"# packed vs solo: {n} proteins, per-segment loss terms packed "
          f"(#4) vs each alone as a dense row (#2): max |diff| {worst:.3e} "
          f"(tol {SOLO_LOSS_TOL}) [{card}]")
    check(worst <= SOLO_LOSS_TOL, f"packed vs solo loss terms: {worst}")


# ------------------------------------------------------------ train

def synthetic_proteins(n: int, lo: int, hi: int, num_annotations: int,
                       seed: int):
    """n random proteins of lo..hi residues with ~0.5% positive
    annotations (the density of `make_random_proteins`)."""
    from proteinbert_tpu_torch.data.vocab import ALPHABET

    rng = np.random.default_rng(seed)
    letters = np.array(list(ALPHABET))
    seqs = ["".join(letters[rng.integers(0, len(letters),
                                         int(rng.integers(lo, hi + 1)))])
            for _ in range(n)]
    ann = (rng.random((n, num_annotations)) < 0.005).astype(np.float32)
    return seqs, ann


def train_run(card: str, label: str, cfg, steps: int, per_step: dict,
              residues: tuple, seed: int, seq_group=None, source=None,
              telemetry=None, mesh=None):
    """`pretrain()` for `steps` steps with every kernel count at 0: the
    launches of each step (exactly per_step[name], 0 for a kernel not
    named), finite losses, params moved by step 2. `source` (a callable
    returning a fresh batch iterator) feeds it when given, else
    `cfg.data.packing` picks `make_packed_iterator` (cfg.data.
    pack_max_segments a row) or `make_pretrain_iterator` over synthetic
    proteins; `seq_group` trains sequence-parallel over that group, `mesh`
    data-parallel over its data group. The
    batches come through pretrain's prefetch thread when
    cfg.data.prefetch_depth > 0. Returns (the out dict, per-step wall ms,
    launches, peak bytes, a clean batch, the batches it trained on)."""
    from proteinbert_tpu_torch.data.dataset import (
        InMemoryPretrainingDataset, make_pretrain_iterator,
    )
    from proteinbert_tpu_torch.data.packing import make_packed_iterator
    from proteinbert_tpu_torch.kernels import KERNELS
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.train.train_state import create_train_state
    from proteinbert_tpu_torch.train.trainer import pretrain

    B, L = cfg.data.batch_size, cfg.data.seq_len
    packed = cfg.data.packing
    if source is not None:
        batches = source
    else:
        seqs, ann = synthetic_proteins((40 if packed else 4) * B, *residues,
                                       cfg.model.num_annotations, seed)
        ds = InMemoryPretrainingDataset(seqs, ann, L)

        def batches():
            if packed:
                return make_packed_iterator(
                    ds, B, seed=seed,
                    max_segments=cfg.data.pack_max_segments)
            return make_pretrain_iterator(ds, B, seed=seed)

    batch = next(batches())
    trained = []

    def recorded(it):
        for b in it:
            trained.append(b)
            yield b

    state = create_train_state(torch.Generator().manual_seed(seed), cfg,
                               device=DEVICE)
    start = [t.clone() for t in tree_leaves(state.params)]
    marks = []

    def log_fn(step, m):
        # Called after the step's metrics reached the host (a sync).
        marks.append((step, time.perf_counter(), m["loss"],
                      {k.name: k.launches for k in KERNELS}))
        if step == 2:
            marks[-1] += (any(not torch.equal(a, b) for a, b in
                              zip(start, tree_leaves(state.params))),)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = pretrain(cfg, recorded(batches()), state=state, log_fn=log_fn,
                   device=DEVICE, seq_group=seq_group, telemetry=telemetry,
                   mesh=mesh)
    total = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    check(len(marks) == steps, f"{label}: {len(marks)} log points")
    prev_t, prev_n = t0, {k.name: 0 for k in KERNELS}
    walls = []
    for mark in marks:
        step, t, loss, counts = mark[:4]
        check(np.isfinite(loss), f"{label}: step {step} loss {loss}")
        for name, n in counts.items():
            got = n - prev_n[name]
            check(got == per_step.get(name, 0),
                  f"{label}: step {step} launched {name} {got} times, want "
                  f"{per_step.get(name, 0)}")
        walls.append((t - prev_t) * 1e3)
        prev_t, prev_n = t, counts
    check(marks[1][4], f"{label}: params unchanged after step 2")
    losses = ", ".join(f"{m[2]:.4f}" for m in marks)
    print(f"# train {label}: {steps} steps B={B} L={L}, losses [{losses}], "
          f"launches {total}")
    # The prefetch thread may have made batches past the last step.
    return out, walls, total, peak, batch, trained[:steps]


def profile_step(card: str, label: str, state, batch, cfg,
                 seq_group=None) -> dict:
    """Where one train step's time goes: synchronized phases (corrupt +
    copy, forward, backward, optimizer; the packed loss for a packed
    batch; with `seq_group`, the sequence-parallel forward and its
    gathered loss), then torch.profiler over one whole step for the
    device's busy share and the largest kernels. Returns the phases' ms
    and the step's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from proteinbert_tpu_torch.parallel import (
        gather_seq, make_seq_parallel_train_step, seq_parallel_apply,
    )
    from proteinbert_tpu_torch.train import train_state as ts
    from proteinbert_tpu_torch.train.loss import pretrain_loss
    from proteinbert_tpu_torch.train.schedule import (
        make_optimizer, tree_leaves,
    )

    if seq_group is None:
        def forward_loss(X, Y, W, seg):
            return ts.forward_loss(state.params, X, Y, W, cfg, seg)[0]

        def train_step():
            ts.train_step(state, batch, cfg)
    else:   # a one-rank group: the whole row is this rank's slice
        def forward_loss(X, Y, W, seg):
            ll, gl = seq_parallel_apply(seq_group, state.params, X["local"],
                                        X["global"], cfg.model)
            return pretrain_loss(gather_seq(ll, seq_group), gl, Y, W)[0]

        step_fn = make_seq_parallel_train_step(seq_group, cfg)

        def train_step():
            step_fn(state, batch)

    leaves = tree_leaves(state.params)
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mark()
    X, Y, W, seg = ts.corrupt_for_step(state, batch, cfg)
    mark()
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        loss = forward_loss(X, Y, W, seg)
        mark()
        grads = torch.autograd.grad(loss, leaves)
        mark()
    for t in leaves:
        t.requires_grad_(False)
    tx = make_optimizer(cfg.optimizer)
    ts.gradient_update(tx, state.params, grads, state.opt_state, loss, True)
    mark()
    names = ("corrupt + host->device", "forward (kernels + plain ops)",
             "backward (activation-dtype recompute + grads)", "optimizer")
    wall = marks[-1] - marks[0]
    print(f"# profile {label} [{card}]: one step {wall * 1e3:.1f} ms, "
          "phases synchronized:")
    phases = {"step": wall * 1e3}
    for name, a, b in zip(names, marks, marks[1:]):
        phases[name.split()[0]] = (b - a) * 1e3
        print(f"#   {(b - a) * 1e3:9.1f} ms {100 * (b - a) / wall:5.1f}%  "
              f"{name}")

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step()
        torch.cuda.synchronize()
    prof_wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + ms)
    if not by_name:
        print(f"# profile {label}: the profiler recorded no device time "
              "(device breakdown not measured)")
        return phases
    busy = sum(t for _, t in by_name.values())
    ours = sum(t for name, (_, t) in by_name.items()
               if any(k in name for k in KERNEL_NAMES))
    print(f"# profile {label} [{card}]: profiled step wall {prof_wall:.1f} "
          f"ms, device busy {busy:.1f} ms ({100 * busy / prof_wall:.1f}%; "
          f"host gaps {100 * (1 - busy / prof_wall):.1f}%), hand-written "
          f"forward kernels {ours:.1f} ms ({100 * ours / busy:.1f}% of busy)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"#   {t:9.3f} ms {100 * t / busy:5.1f}%  x{n:<4d} {name[:80]}")
    phases["busy"] = busy
    return phases


def train_preset(name, B, L, steps, packed=False, model=None):
    """A preset at batch B, length L, `steps` steps logged every step, no
    eval (packed: 8 segments a row)."""
    from proteinbert_tpu_torch.configs import get_preset

    p = get_preset(name)
    return p.replace(
        model=model or p.model,
        data=dataclasses.replace(p.data, batch_size=B, seq_len=L,
                                 packing=packed, pack_max_segments=8),
        train=dataclasses.replace(p.train, max_steps=steps, log_every=1,
                                  eval_every=0))


def train_phases(card: str) -> dict:
    """The trained paths: Large dense (#2 + K2) and packed (#4 + K2), each
    printed beside the same step with the float32 backward, base dense (K1 + K2) and packed (#3 + K2), the default width
    packed (#6); then sequence-parallel over a one-rank NCCL group: the
    `long` preset (K1's prehaloed entry) and Large (#2's); returns each
    kernel's launches summed over the runs."""
    from proteinbert_tpu_torch.configs import ModelConfig
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_TILED, LOCAL_TRACK_TILED,
        LOCAL_TRACK_TILED_VALID, LOCAL_TRACK_VALID, ONEPASS,
    )
    from proteinbert_tpu_torch.train.metrics import peak_flops
    from proteinbert_tpu_torch.train.schedule import tree_leaves

    totals = {}

    def add(launches):
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n

    for packed, kernel, residues in (
            (False, LOCAL_TRACK_TILED, (100, 1022)),
            (True, LOCAL_TRACK_SEGMENTS_TILED, (50, 500))):
        label = "large packed" if packed else "large"
        large = train_preset("large", 8, 1024, 6, packed)
        out, walls, launches, peak, batch, trained = train_run(
            card, label, large, 6, {kernel.name: 12, ATTENTION.name: 12},
            residues, 0)
        add(launches)
        perf = out["perf"]
        med = statistics.median(walls[1:])
        n_params = sum(t.numel() for t in tree_leaves(out["state"].params))
        m = large.model
        rows = ""
        if packed:
            seg = np.concatenate([b["segment_ids"] for b in trained])
            rows = (f"; real (segment > 0) positions "
                    f"{(seg > 0).mean():.4f} of B*L, segments a row "
                    f"{seg.max(axis=1).mean():.3f} over {len(trained)} "
                    f"batches")
        print(f"# train {label} [{card}]: {m.num_blocks} blocks "
              f"C={m.local_dim} G={m.global_dim} H={m.num_heads} "
              f"A={m.num_annotations}, {m.dtype}, B=8 L=1024, {n_params} "
              f"params; step ms median of 5 {med:.1f} (steps "
              f"{', '.join(f'{w:.1f}' for w in walls)}); pretrain perf "
              f"{perf['step_ms']:.1f} ms/step, {perf['residues_per_sec_per_chip']:.0f} "
              f"tokens/s (B*L positions), MFU "
              f"{perf.get('mfu', float('nan')):.4f} of "
              f"{peak_flops(torch.device(DEVICE), 'bfloat16') or float('nan'):.3g}"
              f" FLOP/s; max_memory_allocated {peak / 1e9:.2f} GB{rows}")
        ph = profile_step(card, f"train {label}, one step B=8 L=1024",
                          out["state"], batch, large)
        was = F32_BACKWARD_LARGE[label]
        print(f"# bf16 backward, train {label} [{card}]: one profiled step "
              f"{ph['step']:.1f} ms (float32 backward: {was[0]}), forward "
              f"{ph['forward']:.1f} ({was[1]}), backward "
              f"{ph['backward']:.1f} ({was[2]}), optimizer "
              f"{ph['optimizer']:.1f} ({was[3]}); step median "
              f"{med:.1f} ms ({was[4]}); max_memory_allocated "
              f"{peak / 1e9:.2f} GB ({was[5]})")

    default = ModelConfig()
    for label, cfg, per_step, residues in (
            ("base", train_preset("base", 8, 512, 2),
             {LOCAL_TRACK.name: 6, ATTENTION.name: 6}, (100, 510)),
            ("base packed", train_preset("base", 8, 512, 2, True),
             {LOCAL_TRACK_SEGMENTS.name: 6, ATTENTION.name: 6}, (50, 250)),
            ("default width packed",
             train_preset("base", 8, 512, 2, True, default),
             {ONEPASS.name: 6}, (50, 250))):
        out, walls, launches, peak, _, _ = train_run(
            card, label, cfg, 2, per_step, residues, 1)
        add(launches)
        m = cfg.model
        print(f"# train {label} [{card}]: {m.num_blocks} blocks "
              f"C={m.local_dim} G={m.global_dim} H={m.num_heads}, {m.dtype}, "
              f"B=8 L=512, step ms {', '.join(f'{w:.1f}' for w in walls)}; "
              f"max_memory_allocated {peak / 1e9:.2f} GB")

    # Sequence parallelism on one card: a one-rank NCCL group, so the
    # halo exchange pads and the softmax sums stay local (no collective).
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    group = dist.group.WORLD
    try:
        # `long` (configs/config.py:411-423): B=4, the preset's 64 rows x
        # 2048 over 16 chips; its LR (2e-4) from step 0, without its
        # 10,000-step warmup, so that 6 steps move the loss.
        long_cfg = train_preset("long", 4, 2048, 6)
        long_cfg = long_cfg.replace(optimizer=dataclasses.replace(
            long_cfg.optimizer, schedule="constant", warmup_steps=0))
        out, walls, launches, peak, batch, _ = train_run(
            card, "long seq", long_cfg, 6, {LOCAL_TRACK_VALID.name: 6},
            (200, 2046), 2, seq_group=group)
        add(launches)
        losses = [h["loss"] for h in out["history"]]
        check(losses[-1] < losses[0], f"long seq: loss did not fall: "
                                      f"{losses}")
        perf = out["perf"]
        m = long_cfg.model
        n_params = sum(t.numel() for t in tree_leaves(out["state"].params))
        print(f"# train long seq [{card}]: seq group of 1 (NCCL), "
              f"{m.num_blocks} blocks C={m.local_dim} G={m.global_dim} "
              f"H={m.num_heads} A={m.num_annotations}, {m.dtype}, B=4 "
              f"L=2048, {n_params} params; reported cuts: seq world 4 -> 1, "
              f"data 4 -> 1, no LR warmup; step ms median of 5 "
              f"{statistics.median(walls[1:]):.1f} (steps "
              f"{', '.join(f'{w:.1f}' for w in walls)}); pretrain perf "
              f"{perf['step_ms']:.1f} ms/step, {perf['residues_per_sec_per_chip']:.0f} "
              f"tokens/s (B*L positions), MFU "
              f"{perf.get('mfu', float('nan')):.4f}; max_memory_allocated "
              f"{peak / 1e9:.2f} GB")
        profile_step(card, "train long seq, one step B=4 L=2048",
                     out["state"], batch, long_cfg, seq_group=group)
        large_seq = train_preset("large", 8, 1024, 2)
        out, walls, launches, peak, _, _ = train_run(
            card, "large seq", large_seq, 2,
            {LOCAL_TRACK_TILED_VALID.name: 12}, (100, 1022), 3,
            seq_group=group)
        add(launches)
        m = large_seq.model
        print(f"# train large seq [{card}]: seq group of 1 (NCCL), "
              f"{m.num_blocks} blocks C={m.local_dim}, {m.dtype}, B=8 "
              f"L=1024, step ms "
              f"{', '.join(f'{w:.1f}' for w in walls)}; max_memory_allocated "
              f"{peak / 1e9:.2f} GB")
    finally:
        dist.destroy_process_group()
    return totals


# ------------------------------------------------------------ resume

def resume_run(label: str, cfg, fac, per_step: dict, ckpt=None,
               tele=None, on_log=None):
    """`pretrain()` on the iterator factory `fac`, fresh from the config's
    seed or restored from `ckpt`'s newest step, with every kernel count at
    0: exactly per_step[name] launches of each kernel a step (0 for a
    kernel not named) and finite losses. `on_log(step)` runs in log_fn
    before the step's mark is taken (a SIGTERM, a wait). Returns (out,
    {step: loss}, {step: wall ms since the previous mark}, seconds from
    the last mark to the return, the run's launches)."""
    from proteinbert_tpu_torch.kernels import KERNELS
    from proteinbert_tpu_torch.train.trainer import pretrain

    marks = []

    def log_fn(step, m):
        if on_log is not None:
            on_log(step)
        marks.append((step, time.perf_counter(), m["loss"],
                      {k.name: k.launches for k in KERNELS}))

    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = pretrain(cfg, fac, checkpointer=ckpt, log_fn=log_fn,
                   telemetry=tele, device=DEVICE)
    t_end = time.perf_counter()
    launches = {k.name: k.launches for k in KERNELS}
    prev_t, prev_n = t0, {k.name: 0 for k in KERNELS}
    losses, walls = {}, {}
    for step, t, loss, counts in marks:
        check(np.isfinite(loss), f"{label}: step {step} loss {loss}")
        for name, n in counts.items():
            got = n - prev_n[name]
            check(got == per_step.get(name, 0),
                  f"{label}: step {step} launched {name} {got} times, want "
                  f"{per_step.get(name, 0)}")
        losses[step] = loss
        walls[step] = (t - prev_t) * 1e3
        prev_t, prev_n = t, counts
    return out, losses, walls, t_end - prev_t, launches


def read_state(directory: str, step: int) -> dict:
    """The host tree of a checkpoint step, as `train.Checkpointer` wrote
    it (`train.checkpoint.state_tree`'s layout)."""
    from proteinbert_tpu_torch.train.checkpoint import STATE_FILE

    return torch.load(os.path.join(directory, str(step), STATE_FILE),
                      map_location="cpu", weights_only=True)


def host_state(state) -> dict:
    """A TrainState as the host tree a checkpoint of it holds."""
    from proteinbert_tpu_torch.train.checkpoint import state_tree

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [put(v) for v in x]
        return x.to("cpu", copy=True) if torch.is_tensor(x) else x

    return put(state_tree(state))


def tree_tensors(tree) -> list:
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def trees_equal(x, y) -> bool:
    """Two host trees bit for bit: structure, scalars, dtypes, values."""
    if isinstance(x, dict):
        return (isinstance(y, dict) and x.keys() == y.keys()
                and all(trees_equal(x[k], y[k]) for k in x))
    if isinstance(x, (list, tuple)):
        return (isinstance(y, (list, tuple)) and len(x) == len(y)
                and all(trees_equal(a, b) for a, b in zip(x, y)))
    if torch.is_tensor(x):
        return (torch.is_tensor(y) and x.dtype == y.dtype
                and torch.equal(x, y))
    return x == y


def state_drift(x: dict, y: dict, base: dict) -> float:
    """How far a checkpoint tree x lies from y, a tree of the same step from
    another run: the largest of ||x - y|| / ||y - base|| over the params
    (the update since `base`, the params both runs started from),
    ||x - y|| / ||y|| over each Adam moment, and |x - y| / max(1, |y|)
    over the plateau's two loss averages; inf where the step, the Adam
    count, the generator state or the plateau's counters and scale
    differ. 0.0 for trees bit for bit equal."""
    ox, oy = x["opt_state"], y["opt_state"]
    px, py = ox["plateau"] or {}, oy["plateau"] or {}
    losses = ("best_value", "avg_value")
    if (x["step"] != y["step"] or ox["count"] != oy["count"]
            or not torch.equal(x["generator"], y["generator"])
            or px.keys() != py.keys()
            or not all(torch.equal(px[k], py[k]) for k in px
                       if k not in losses)):
        return float("inf")

    def sq(ts):
        return sum(float(torch.linalg.vector_norm(t.float())) ** 2
                   for t in ts)

    def rel(xs, ys, zero):
        num = sq([a - b for a, b in zip(xs, ys, strict=True)])
        den = sq([b - z for b, z in zip(ys, zero, strict=True)])
        return 0.0 if num == 0 else (num / den) ** 0.5 if den else \
            float("inf")

    px_l, py_l = tree_tensors(x["params"]), tree_tensors(y["params"])
    drifts = [rel(px_l, py_l, tree_tensors(base))]
    for k in ("mu", "nu"):
        ys = tree_tensors(oy[k])
        drifts.append(rel(tree_tensors(ox[k]), ys,
                          [torch.zeros_like(t) for t in ys]))
    drifts += [abs(float(px[k]) - float(py[k])) / max(1.0, abs(float(py[k])))
               for k in losses if k in px]
    return max(drifts)


def staged_ordering_check(state, directory: str) -> str:
    """The staged save's device ordering, on `state` (modified in place):
    two stages back to back, each snapshot queued on the train stream
    behind ~1 s of `torch.cuda._sleep` (the step before the boundary still
    running) and followed at once by an in-place update of every param
    and moment (the next step). The saver thread holds stage 1 back 3 s
    before its copy to the host, and stage 2 not at all. S0 being the
    state before, stage 1 must hold -S0 and stage 2 -2 S0, bit for bit: a
    side stream that did not wait for the snapshot's event copies stage
    2's buffer before the snapshot lands (stage 2 holds -S0), a snapshot
    off the train stream races the update, and a second snapshot that did
    not wait for the first stage to land overwrites the buffer under it
    (stage 1 holds -2 S0). Returns a line for the log."""
    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train.schedule import tree_leaves

    class Held(Checkpointer):
        holds = [3.0, 0.0]

        def _snapshot(self, st):
            torch.cuda._sleep(SLEEP_CYCLES)
            return super()._snapshot(st)

        def _stage_fetch(self, snapshot):
            time.sleep(self.holds.pop(0))
            return super()._stage_fetch(snapshot)

    def moved(tree):                            # params and moments
        o = tree["opt_state"]
        return tree_tensors([tree["params"], o["mu"], o["nu"]])

    leaves = (tree_leaves(state.params) + state.opt_state.mu
              + state.opt_state.nu)
    s0 = moved(host_state(state))
    ck = Held(directory, max_to_keep=2)
    t0 = time.perf_counter()
    torch._foreach_neg_(leaves)                 # the boundary: -S0
    ck.save_staged(1, state)
    torch._foreach_mul_(leaves, 2.0)            # the next update: -2 S0
    ck.save_staged(2, state)
    torch._foreach_neg_(leaves)                 # the next update: 2 S0
    ck.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held = []
    for step, factor in ((1, -1.0), (2, -2.0)):
        tree = read_state(directory, step)
        got = moved(tree)
        held.append(all(torch.equal(g, w * factor)
                        for g, w in zip(got, s0, strict=True)))
        del tree, got
    check(held == [True, True],
          f"staged ordering: stage 1 holds -S0 {held[0]}, stage 2 holds "
          f"-2 S0 {held[1]}: a staged snapshot is torn")
    return (f"staged ordering held ({len(leaves)} tensors, two stages "
            f"behind ~1 s of train-stream work each, stage 1's host copy "
            f"held back 3 s; {wall:.1f} s)")


def sigterm_at(kill: int):
    """An on_log hook sending this process SIGTERM at step `kill`."""
    def on_log(step):
        if step == kill:
            os.kill(os.getpid(), signal.SIGTERM)
    return on_log


def timed_checkpointer(directory: str, **kw):
    """A Checkpointer that records, in `.times`, the seconds its copies to
    the host of staged snapshots (`_stage_fetch`, the first one pinning
    its buffers) and its writes (`_write_step`, fsync included) take."""
    from proteinbert_tpu_torch.train import Checkpointer

    class Timed(Checkpointer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.times = []

        def _stage_fetch(self, snapshot):
            t0 = time.perf_counter()
            out = super()._stage_fetch(snapshot)
            self.times.append(("host copy", time.perf_counter() - t0))
            return out

        def _write_step(self, step, host_tree, data_state):
            t0 = time.perf_counter()
            super()._write_step(step, host_tree, data_state)
            self.times.append((f"write {step}", time.perf_counter() - t0))

    return Timed(directory, **kw)


def span_ms(tele, name: str) -> list:
    """Durations (ms) of the host spans `name` a Telemetry(spans=True)
    collected."""
    return [e["dur"] / 1e3 for e in tele.spans.to_perfetto()["traceEvents"]
            if e.get("name") == name]


# The resume phase's `large` runs at full width but RESUME_LARGE_BLOCKS of
# its 12 blocks: a depth cut that keeps the full run inside its limit on
# the slower card machines (full depth: 1051 and 1099 s there; 6 blocks
# with the seq mesh legs: 1234 s, PERF.md).
RESUME_LARGE_BLOCKS = 3


def resume_phase(card: str) -> dict:
    """A pretraining run that survives on the card, through `pretrain` and
    `train.Checkpointer`, for `large` dense at full width and
    RESUME_LARGE_BLOCKS blocks (B=8,
    L=1024, 6 steps, saves every 3, SIGTERM at step 4; #2 + K2) and `base`
    packed (B=8, L=512, 8 segments a row, 4 steps, saves every 2, SIGTERM
    at step 2; #3 + K2, the packed iterator's skip_batches replay), each
    at the preset's peak learning rate from step 1 (no warmup):
    a. an uninterrupted run with synchronous saves (max_to_keep 2);
    b. the same run with staged saves, sent SIGTERM from log_fn: it must
       return preempted with the newest step at the kill;
    c. a fresh state and a new Checkpointer resume b to the end;
    e. c again with the Adam moments zeroed on restore (a planted fault);
    d. (Large only) 7 steps with staged saves at 3 and 6, log_fn waiting at
       step 5 for the first stage to land, so step 7 holds a steady-state
       staged boundary (buffers made, no stage in flight before it); then
       `staged_ordering_check` on its final state.
    Gates: the state restored from b's newest step is b's final state bit
    for bit; c's staged save at its last step is c's final state bit for
    bit; b's staged save at the first boundary and c's final state lie
    within RESUME_STATE_TOL of a's (`state_drift`) and e's final state
    beyond it; c's losses are finite and within RESUME_LOSS_TOL of a's
    (bit-equality of the losses and states is printed); exact launch
    counts a step in every run; the event stream of b and c validates.
    Prints the boundary's cost at
    Large (not a gate): the wall of the step holding a synchronous save
    (a), the first staged save (b) and a steady one (d) against their
    runs' median step, the boundary's time on the train thread (its span),
    the saver thread's copy to the host and write seconds, the stages'
    seconds until they landed, the preemption save's and the restore's
    seconds, and the checkpoint's bytes. The checkpoints live in a
    temporary directory under build/, removed at the end; a disk that
    cannot hold three of them fails the phase. Returns each kernel's
    launches summed over the runs."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.data.dataset import (
        InMemoryPretrainingDataset, make_pretrain_iterator,
    )
    from proteinbert_tpu_torch.data.packing import make_packed_iterator
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, LOCAL_TRACK_SEGMENTS, LOCAL_TRACK_TILED,
    )
    from proteinbert_tpu_torch.obs import Telemetry, read_events
    from proteinbert_tpu_torch.train import Checkpointer
    from proteinbert_tpu_torch.train.checkpoint import STATE_FILE
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.train.train_state import create_train_state

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="resume-", dir=build)
    totals = {}
    try:
        for (label, name, B, L, steps, every, kill, packed, per_step,
             residues, seed) in (
                ("large", "large", 8, 1024, 6, 3, 4, False,
                 {LOCAL_TRACK_TILED.name: RESUME_LARGE_BLOCKS,
                  ATTENTION.name: RESUME_LARGE_BLOCKS},
                 (100, 1022), 0),
                ("base packed", "base", 8, 512, 4, 2, 2, True,
                 {LOCAL_TRACK_SEGMENTS.name: 6, ATTENTION.name: 6},
                 (50, 250), 1)):
            # The peak learning rate from step 1 (warmup 0, the plateau
            # kept): the steps move the params, the Adam moments and the
            # loss, so the gates see the optimizer state.
            model = get_preset(name).model
            if name == "large":
                model = dataclasses.replace(model,
                                            num_blocks=RESUME_LARGE_BLOCKS)
            cfg = train_preset(name, B, L, steps, packed, model)
            cfg = cfg.replace(optimizer=dataclasses.replace(
                cfg.optimizer, warmup_steps=0))
            sync_cfg, staged_cfg = (cfg.replace(checkpoint=dataclasses.replace(
                cfg.checkpoint, every_steps=every, overlap=o))
                for o in (False, True))
            seqs, ann = synthetic_proteins((40 if packed else 4) * B,
                                           *residues,
                                           cfg.model.num_annotations, seed)
            ds = InMemoryPretrainingDataset(seqs, ann, L)

            def fac(skip, ds=ds, B=B, packed=packed, seed=seed):
                if packed:
                    return make_packed_iterator(ds, B, seed=seed,
                                                max_segments=8,
                                                skip_batches=skip)
                return make_pretrain_iterator(ds, B, seed=seed,
                                              skip_batches=skip)

            tag = label.replace(" ", "_")
            ck = timed_checkpointer(os.path.join(root, f"{tag}-a"),
                                    max_to_keep=2, async_save=False)
            out, loss_a, wall_a, _, n = resume_run(
                f"resume {label} a", sync_cfg, fac, per_step, ckpt=ck)
            ck.close()
            times_a = dict(ck.times)
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
            check(ck.all_steps() == [every, steps],
                  f"resume {label} a: steps {ck.all_steps()}")
            st = out["state"]
            leaves = (tree_leaves(st.params) + st.opt_state.mu
                      + st.opt_state.nu)
            state_bytes = sum(t.numel() * t.element_size() for t in leaves)
            file_bytes = os.path.getsize(os.path.join(
                ck.directory, str(steps), STATE_FILE))
            # a's synchronous checkpoints, held against b's and c's staged
            # ones of the same steps.
            a_every = read_state(ck.directory, every)
            a_final = read_state(ck.directory, steps)
            del leaves, ck
            shutil.rmtree(os.path.join(root, f"{tag}-a"))
            free = shutil.disk_usage(root).free
            check(free >= 3 * file_bytes,
                  f"resume {label}: {free} bytes free under {root}, the "
                  f"phase needs three checkpoints of {file_bytes} bytes")
            del out, st
            gc.collect()
            torch.cuda.empty_cache()

            events = os.path.join(root, f"{tag}-events.jsonl")
            tele = Telemetry(events_path=events, flight_dir=root, spans=True)
            ck = timed_checkpointer(os.path.join(root, f"{tag}-b"),
                                    max_to_keep=2)
            out_b, loss_b, wall_b, preempt_s, n = resume_run(
                f"resume {label} b", staged_cfg, fac, per_step, ckpt=ck,
                tele=tele, on_log=sigterm_at(kill))
            ck.close()
            times_b = ck.times
            span_b = span_ms(tele, "ckpt_boundary_staged")
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
            check(out_b["preempted"] and ck.latest_step() == kill
                  and sorted(loss_b) == list(range(1, kill + 1)),
                  f"resume {label} b: preempted {out_b['preempted']}, "
                  f"newest step {ck.latest_step()}, want {kill}")
            del ck
            gc.collect()
            torch.cuda.empty_cache()

            template = create_train_state(
                torch.Generator().manual_seed(cfg.train.seed), cfg,
                device=DEVICE)
            ck = Checkpointer(os.path.join(root, f"{tag}-b"))
            t0 = time.perf_counter()
            restored, data = ck.restore(template)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            ck.close()
            restored_host = host_state(restored)
            held = trees_equal(restored_host, host_state(out_b["state"]))
            check(held, f"resume {label}: the restored state is not the "
                        "saved one bit for bit")
            check(data == {"batches_consumed": kill},
                  f"resume {label}: data item {data}")
            # b's staged save at step `every` against a's synchronous one
            # (two runs: held within RESUME_STATE_TOL, bit-equality shown).
            init_params = host_state(template)["params"]
            kill_params = restored_host["params"]
            b_every = read_state(ck.directory, every)
            drift_b = state_drift(b_every, a_every, init_params)
            bit_b = trees_equal(b_every, a_every)
            check(drift_b <= RESUME_STATE_TOL,
                  f"resume {label}: b's staged checkpoint at step {every} "
                  f"lies {drift_b} from a's synchronous one > "
                  f"{RESUME_STATE_TOL}")
            del template, restored, restored_host, out_b, ck, b_every
            del a_every, init_params
            gc.collect()
            torch.cuda.empty_cache()

            ck = Checkpointer(os.path.join(root, f"{tag}-b"), max_to_keep=2)
            out_c, loss_c, _, _, n = resume_run(
                f"resume {label} c", staged_cfg, fac, per_step, ckpt=ck,
                tele=tele)
            ck.close()
            tele.close()
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
            check(out_c["state"].step == steps and not out_c["preempted"]
                  and sorted(loss_c) == list(range(kill + 1, steps + 1)),
                  f"resume {label} c: ended at {out_c['state'].step}, "
                  f"steps {sorted(loss_c)}")
            # c's staged save at its last step is c's final state bit for
            # bit (one run); c's final state against a's (two runs).
            c_final = read_state(ck.directory, steps)
            check(trees_equal(c_final, host_state(out_c["state"])),
                  f"resume {label}: c's staged checkpoint at step {steps} "
                  "is not c's final state bit for bit")
            drift_c = state_drift(c_final, a_final, kill_params)
            bit_c = trees_equal(c_final, a_final)
            check(drift_c <= RESUME_STATE_TOL,
                  f"resume {label}: c's final state lies {drift_c} from "
                  f"a's > {RESUME_STATE_TOL}")
            del out_c, ck, c_final
            gc.collect()
            torch.cuda.empty_cache()

            # e. the gates' power: c again, from b's step `kill`, with a
            # planted fault, the Adam moments zeroed on restore. Nothing
            # is written (the directory holds step `steps` already).
            class ZeroMoments(Checkpointer):
                def restore(self, state_like, step=None, fallback=True):
                    st, data = super().restore(state_like, step=kill)
                    for t in st.opt_state.mu + st.opt_state.nu:
                        t.zero_()
                    return st, data

            ck = ZeroMoments(os.path.join(root, f"{tag}-b"), max_to_keep=2)
            out_e, loss_e, _, _, n = resume_run(
                f"resume {label} e", staged_cfg, fac, per_step, ckpt=ck)
            ck.close()
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
            drift_e = state_drift(host_state(out_e["state"]), a_final,
                                  kill_params)
            check(drift_e > RESUME_STATE_TOL,
                  f"resume {label}: a resume with the Adam moments zeroed "
                  f"lies {drift_e} from a's final state, within "
                  f"{RESUME_STATE_TOL}: the gate cannot see the moments")
            del out_e, ck, a_final, kill_params
            shutil.rmtree(os.path.join(root, f"{tag}-b"))
            gc.collect()
            torch.cuda.empty_cache()

            def rel(x, y):
                return abs(x - y) / max(1.0, abs(y))

            worst = max(rel(loss_c[s], loss_a[s]) for s in loss_c)
            worst_e = max(rel(loss_e[s], loss_a[s]) for s in loss_e)
            check(worst <= RESUME_LOSS_TOL,
                  f"resume {label}: resumed losses {loss_c} against the "
                  f"uninterrupted {loss_a}: {worst} > {RESUME_LOSS_TOL}")
            bit = all(loss_c[s] == loss_a[s] for s in loss_c)
            before = max(rel(loss_b[s], loss_a[s]) for s in loss_b)
            recs = read_events(events, strict=True)
            kinds = {r["event"] for r in recs}
            check({"run_start", "step", "ckpt_stage", "requeue",
                   "run_end"} <= kinds, f"resume {label}: events {kinds}")
            outcomes = [r["outcome"] for r in recs if r["event"] == "run_end"]
            check(outcomes == ["preempted", "completed"],
                  f"resume {label}: run_end outcomes {outcomes}")
            landed = [r for r in recs if r["event"] == "ckpt_stage"
                      and r["phase"] == "landed"]

            def fmt(d):
                return ", ".join(f"{d[s]:.6f}" for s in sorted(d))

            print(f"# resume {label} [{card}]: B={B} L={L}, {steps} steps, "
                  f"saves every {every}; a uninterrupted (synchronous "
                  f"saves), b SIGTERM at step {kill} (staged saves), c "
                  f"resumed from step {kill} by a fresh state and a new "
                  f"Checkpointer: restored state bit for bit the saved one "
                  f"(held; restore {restore_s:.2f} s); losses a [{fmt(loss_a)}]"
                  f", b [{fmt(loss_b)}], c [{fmt(loss_c)}]; steps "
                  f"{kill + 1}-{steps} max |c - a| / max(1, |a|) {worst:.3g}"
                  f" (tol {RESUME_LOSS_TOL}), bit for bit: "
                  f"{'yes' if bit else 'no'}; steps 1-{kill} max |b - a| "
                  f"{before:.3g}; state drift (RESUME_STATE_TOL "
                  f"{RESUME_STATE_TOL}): b's staged step {every} against a's"
                  f" synchronous {drift_b:.3g} (bit for bit: "
                  f"{'yes' if bit_b else 'no'}), c's final state against "
                  f"a's {drift_c:.3g} (bit for bit: "
                  f"{'yes' if bit_c else 'no'}), c's staged step {steps} "
                  f"c's final state bit for bit (held); planted fault e "
                  f"(Adam moments zeroed on restore): drift {drift_e:.3g}"
                  f" (caught), losses [{fmt(loss_e)}], max |e - a| / "
                  f"max(1, |a|) {worst_e:.3g}; launches a step {per_step} "
                  f"in a, b, c and e; "
                  f"{len(recs)} events valid ({', '.join(sorted(kinds))})")
            if label != "large":
                continue
            # d. the steady-state staged boundary: 7 steps, stages at 3
            # and 6; log_fn waits at step 5 for the first stage to land
            # (a run's boundaries are far apart), so step 7 holds a stage
            # whose buffers exist and that no earlier stage holds back.
            steady_cfg = train_preset(name, B, L, 7, packed, model).replace(
                checkpoint=staged_cfg.checkpoint, optimizer=cfg.optimizer)
            tele_d = Telemetry(spans=True)
            ck = timed_checkpointer(os.path.join(root, f"{tag}-d"),
                                    max_to_keep=1)

            def settle(step, ck=ck):
                if step == 5:
                    ck.wait()

            out_d, _, wall_d, _, n = resume_run(
                f"resume {label} d", steady_cfg, fac, per_step, ckpt=ck,
                tele=tele_d, on_log=settle)
            ck.close()
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
            times_d = ck.times
            span_d = span_ms(tele_d, "ckpt_boundary_staged")
            # After the timed runs: its pinned buffers, once freed, stay
            # in the host allocator's cache and would make b's first
            # stage look like a steady one.
            ordering = staged_ordering_check(
                out_d["state"], os.path.join(root, f"{tag}-ordering"))
            shutil.rmtree(os.path.join(root, f"{tag}-ordering"))
            print(f"# resume {label} [{card}]: {ordering}")
            del ck, out_d
            gc.collect()
            torch.cuda.empty_cache()

            def med(walls, skip):
                return statistics.median(w for s, w in walls.items()
                                         if s not in skip)

            def fmt_walls(walls):
                return ", ".join(f"{walls[s]:.1f}" for s in sorted(walls))

            def fmt_times(times):
                return ", ".join(f"{k} {v:.3f} s" for k, v in times)

            b_step = every + 1            # the step after the boundary
            med_a = med(wall_a, (1, b_step))
            med_b = med(wall_b, (1, b_step))
            med_d = med(wall_d, (1, 4, 5, 7))
            stage_s = ", ".join(f"{r['overlap_s']:.3f}" for r in landed)
            print(f"# resume boundary {label} [{card}]: step walls ms a "
                  f"[{fmt_walls(wall_a)}], b [{fmt_walls(wall_b)}], d "
                  f"[{fmt_walls(wall_d)}]; synchronous save at step "
                  f"{every} (a): step {b_step} {wall_a[b_step]:.1f} ms "
                  f"against the median step {med_a:.1f} ms "
                  f"(+{wall_a[b_step] - med_a:.1f}; {fmt_times(times_a.items())}"
                  f"); first staged save (b): step {b_step} "
                  f"{wall_b[b_step]:.1f} ms against {med_b:.1f} ms "
                  f"(+{wall_b[b_step] - med_b:.1f}), boundary on the train "
                  f"thread {', '.join(f'{x:.1f}' for x in span_b)} ms, saver "
                  f"thread {fmt_times(times_b)}; steady staged save (d, "
                  f"step 6): step 7 {wall_d[7]:.1f} ms against "
                  f"{med_d:.1f} ms (+{wall_d[7] - med_d:.1f}), boundary on "
                  f"the train thread {', '.join(f'{x:.1f}' for x in span_d)}"
                  f" ms, saver thread {fmt_times(times_d)}; b and c's stages "
                  f"landed after {stage_s} s (overlap_s); preemption save at "
                  f"step {kill} {preempt_s:.2f} s; restore {restore_s:.2f} s;"
                  f" state {state_bytes} bytes in float32 params and Adam "
                  f"moments, state.pt {file_bytes} bytes")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return totals


# ------------------------------------------------------------ phase 3

def reference_phase():
    """A base-width float32 trunk (2 blocks) through the kernels on the
    card against the plain path on the CPU, embed on 3 short sequences."""
    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.models.proteinbert import init, to_device

    base = get_preset("base")
    cfg = base.replace(
        model=dataclasses.replace(base.model, dtype="float32", num_blocks=2),
        data=dataclasses.replace(base.data, seq_len=128))
    params = init(cfg.model, torch.Generator().manual_seed(2), device="cpu")
    seqs = ["MKTAYIAKQRQISFVKSHFSRQ", "ACDEFGHIKLMNPQRSTVWY" * 5, "GG"]
    want = inference.embed(params, cfg, seqs, batch_size=4, device="cpu")
    got = inference.embed(to_device(params, torch.device(DEVICE)), cfg,
                          seqs, batch_size=4, device=DEVICE)
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    print(f"# reference: float32 trunk C=G=512, 2 blocks, L=128, kernels on "
          f"card vs plain on CPU: max_abs_err {err:.3e} (tol {REF_TOL})")
    check(err <= REF_TOL, f"trunk vs plain CPU path: {err} > {REF_TOL}")


def traffic(n: int, seed: int):
    """`n` mixed requests of 20-500 residues, kinds in turn; each
    predict_residues request masks 3 positions with '?'."""
    from proteinbert_tpu_torch.data.vocab import ALPHABET
    from proteinbert_tpu_torch.serve.dispatch import KINDS

    rnd = random.Random(seed)
    reqs = []
    for i in range(n):
        length = rnd.randint(20, 500)
        seq = "".join(rnd.choice(ALPHABET) for _ in range(length))
        kind = KINDS[i % 3]
        if kind == "predict_residues":
            pos = rnd.sample(range(length), 3)
            seq = "".join("?" if j in pos else c for j, c in enumerate(seq))
        reqs.append((kind, seq))
    return reqs


def max_answer_diff(reqs, got, want, same_fills: bool = True) -> float:
    """Largest |difference| over two servers' answers to the same
    requests; with `same_fills` a filled residue string that differs fails
    outright (two arms of different weights may fill differently)."""
    worst = 0.0
    for (kind, _), a, b in zip(reqs, got, want):
        if kind == "embed":
            pairs = [(a[k], b[k]) for k in ("global", "local_mean")]
        elif kind == "predict_go":
            pairs = [(a, b)]
        else:
            check(a[0] == b[0] or not same_fills,
                  "predict_residues fills differ")
            pairs = [(a[1], b[1])]
        for u, v in pairs:
            check(u.shape == v.shape, f"{kind} shapes {u.shape} {v.shape}")
            worst = max(worst, float(np.abs(u - v).max()))
    return worst


def ragged_parity_phase() -> None:
    """A float32 base-width trunk (2 blocks) served ragged and bucketed on
    the card: the same requests, the answers within RAGGED_TOL."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.server import Server

    base = get_preset("base")
    cfg = base.replace(model=dataclasses.replace(
        base.model, dtype="float32", num_blocks=2))
    params = init(cfg.model, torch.Generator().manual_seed(5), device=DEVICE)
    reqs = traffic(12, seed=1)
    answers = {}
    for mode in ("bucketed", "ragged"):
        srv = Server(params, cfg, device=DEVICE, buckets=BUCKETS,
                     max_batch=8, max_wait_s=0.005, cache_size=0,
                     serve_mode=mode, warm_kinds=())
        srv.start()
        futures = [srv.submit(kind, seq) for kind, seq in reqs]
        check(srv.drain(timeout=300), f"{mode} parity server drain timed out")
        answers[mode] = [f.result(timeout=0) for f in futures]
    err = max_answer_diff(reqs, answers["ragged"], answers["bucketed"])
    print(f"# ragged vs bucketed: float32 trunk C=G=512, 2 blocks, "
          f"{len(reqs)} requests on the card: max_abs_err {err:.3e} "
          f"(tol {RAGGED_TOL})")
    check(err <= RAGGED_TOL, f"ragged vs bucketed: {err} > {RAGGED_TOL}")


def q8_reference_phase() -> None:
    """A base-width float32 int8 trunk (2 blocks, L=128) through the
    quantized entries on the card — the int8 legs on the path — against
    the same entries on the CPU plain path, bucketed (`quant_entry`: K1
    on dequantized track weights, K2-int8) and ragged
    (`quant_packed_entry`: #3-int8, K2-int8)."""
    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION_Q8, KERNELS, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS_Q8,
    )
    from proteinbert_tpu_torch.models.proteinbert import init, to_device
    from proteinbert_tpu_torch.parallel.quant import (
        quant_entry, quant_packed_entry, quantize_params,
    )

    base = get_preset("base")
    cfg = base.replace(
        model=dataclasses.replace(base.model, dtype="float32", num_blocks=2),
        data=dataclasses.replace(base.data, seq_len=128))
    qcpu = quantize_params(init(cfg.model, torch.Generator().manual_seed(2),
                                device="cpu"))
    qdev = to_device(qcpu, torch.device(DEVICE))
    seqs = ["MKTAYIAKQRQISFVKSHFSRQ", "ACDEFGHIKLMNPQRSTVWY" * 5, "GG"]
    tokens = inference._tokenize_masked(seqs, 128, "count")
    A = cfg.model.num_annotations
    ann = np.zeros((3, A), np.float32)
    # Ragged: two short sequences packed into row 0 at spans 32 and 16 (a
    # pad tail after them), the long one alone in row 1.
    ptoks = np.zeros((2, 128), np.int32)
    pseg = np.zeros((2, 128), np.int32)
    pos = 0
    for s, (seq, span) in enumerate(((seqs[0], 32), (seqs[2], 16))):
        t = inference._tokenize_masked([seq], 128, "count")[0, :span]
        ptoks[0, pos:pos + span], pseg[0, pos:pos + span] = t, s + 1
        pos += span
    ptoks[1], pseg[1] = tokens[1], 1
    pann = np.zeros((2, 2, A), np.float32)
    for label, fn, arrays, want_launch in (
            ("bucketed", quant_entry("embed"), (tokens, ann),
             {LOCAL_TRACK.name, ATTENTION_Q8.name}),
            ("ragged", quant_packed_entry("embed"), (ptoks, pseg, pann),
             {LOCAL_TRACK_SEGMENTS_Q8.name, ATTENTION_Q8.name})):
        want = inference.run_batch(fn, qcpu, cfg, *arrays, device="cpu")
        for kk in KERNELS:
            kk.launches = 0
        got = inference.run_batch(fn, qdev, cfg, *arrays, device=DEVICE)
        ran = {kk.name for kk in KERNELS if kk.launches}
        check(ran == want_launch, f"int8 reference {label}: launched {ran}, "
                                  f"want {want_launch}")
        err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        print(f"# reference int8 {label}: float32 int8 trunk C=G=512, 2 "
              f"blocks, L=128, int8 legs on card vs plain on CPU: max_abs_err "
              f"{err:.3e} (tol {REF_TOL}), kernels {sorted(ran)}")
        check(err <= REF_TOL, f"int8 trunk {label} vs plain CPU path: "
                              f"{err} > {REF_TOL}")


# ------------------------------------------------------------ phase 4

def serve_phase(card: str, label: str, cfg, mode: str, per_batch: dict,
                seed: int, quant: str = "fp32", n_requests: int = 24,
                alone: bool = True):
    """One server over random weights (seed `seed`) on the `quant` arm:
    `n_requests` mixed requests from 4 threads with every kernel count at 0,
    then drain. Checks every answer, the launches (exactly per_batch[name]
    per batch, 0 for a kernel not named) and, with `alone`, each embed
    against the same sequence run alone. Prints the device memory the
    loaded server holds (weights and all: `torch.cuda.memory_allocated()`
    before the weights are made and after the server is built, the caller's
    reference to the weights dropped) and, on an int8 arm, its
    `quant_report`. Returns (server, launches, answers)."""
    from proteinbert_tpu_torch.kernels import KERNELS
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.dispatch import KINDS
    from proteinbert_tpu_torch.serve.server import Server

    gc.collect()  # an earlier server's reference cycles
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    params = init(cfg.model, torch.Generator().manual_seed(seed),
                  device=DEVICE)
    srv = Server(params, cfg, device=DEVICE, buckets=BUCKETS, max_batch=8,
                 max_wait_s=0.005, queue_depth=64, cache_size=256,
                 warm_kinds=KINDS, serve_mode=mode, pack_max_segments=8,
                 quant=quant, quant_parity_every=0)
    del params
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - mem0
    print(f"# serve {label}: device memory after load {held} bytes "
          f"({held / 2**20:.2f} MiB) [{card}]")
    if quant != "fp32":
        report = srv.stats()["quant"]
        print(f"# serve {label}: quant_report {json.dumps(report)}")
        check(report["fp32_resident"] == "host", "fp32 tree not on the host")
    t0 = time.perf_counter()
    srv.start()
    print(f"# serve {label}: warmup {time.perf_counter() - t0:.2f} s")
    if hasattr(srv.dispatcher, "graph_pool_bytes"):
        torch.cuda.synchronize()
        pool = srv.dispatcher.graph_pool_bytes()
        print(f"# serve {label}: {srv.dispatcher.executable_count} CUDA "
              f"graphs, their pool holds {pool} bytes ({pool / 2**20:.2f} "
              f"MiB) after warmup; device memory allocated "
              f"{torch.cuda.memory_allocated() - mem0} bytes [{card}]")

    reqs = traffic(n_requests, seed=0)
    futures = [None] * len(reqs)
    submitted = [0.0] * len(reqs)
    finished = [None] * len(reqs)

    def client(idx):
        for i in idx:
            kind, seq = reqs[i]
            submitted[i] = time.perf_counter()
            futures[i] = srv.submit(kind, seq)
            futures[i].add_done_callback(
                lambda f, i=i: finished.__setitem__(i, time.perf_counter()))

    for k in KERNELS:
        k.launches = 0
    threads = [threading.Thread(target=client,
                                args=(range(j, len(reqs), 4),))
               for j in range(4)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    check(not any(t.is_alive() for t in threads), "client threads hung")
    check(srv.drain(timeout=300), "drain timed out")
    wall = time.perf_counter() - t_start
    launches = {k.name: k.launches for k in KERNELS}
    results = [f.result(timeout=0) for f in futures]
    latency = [b - a for a, b in zip(submitted, finished)]
    stats = srv.stats()
    batches = stats["batches"]
    print(f"# serve {label}: {len(reqs)} requests in {batches} batches "
          f"({stats['batched_rows']} rows), launches {launches}")
    check(stats["completed"] == len(reqs), f"completed {stats['completed']}")
    check(batches > 0, "no batch dispatched")
    for name, n in launches.items():
        want = per_batch.get(name, 0) * batches
        check(n == want, f"{label}: {name} launched {n} times for {batches} "
                         f"batches, want {want}")

    A = cfg.model.num_annotations
    worst = 0.0
    for (kind, seq), res in zip(reqs, results):
        if kind == "embed":
            check(res["global"].shape == (cfg.model.global_dim,)
                  and res["local_mean"].shape == (cfg.model.local_dim,),
                  "embed shapes")
            check(all(np.isfinite(v).all() for v in res.values()),
                  "embed non-finite")
            if alone:
                solo = embed_alone(srv, seq)
                for key in ("global", "local_mean"):
                    worst = max(worst,
                                float(np.abs(solo[key] - res[key]).max()))
        elif kind == "predict_go":
            check(res.shape == (A,) and np.isfinite(res).all()
                  and ((res >= 0) & (res <= 1)).all(), "predict_go probs")
        else:
            filled, probs = res
            L = srv.dispatcher.bucket_len(len(seq))
            check(len(filled) == len(seq) and "?" not in filled,
                  "predict_residues fill")
            check(probs.shape == (L, cfg.model.vocab_size)
                  and np.isfinite(probs).all(), "predict_residues probs")
    if alone:
        print(f"# serve {label}: embed served vs alone (same mode, one "
              f"request in the batch) max_abs_err {worst:.3e} "
              f"(tol {SERVE_EMBED_TOL})")
        check(worst <= SERVE_EMBED_TOL, f"served embed vs alone: {worst}")

    done_ms = sorted(round((f - t_start) * 1e3, 1) for f in finished)
    print(f"# serve {label}: requests done at (ms after the clients "
          f"started) {done_ms}; queue wait {stats.get('queue_wait')}; "
          f"pipeline {stats.get('pipeline')}; graphs "
          f"{stats.get('executables')}")
    lat = sorted(latency)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]
    print(f"# serve {label} [{card}]: {len(reqs) / wall:.2f} requests/s, "
          f"p50 {p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms "
          f"(client-side, {len(reqs)} requests, 4 threads)")
    return srv, launches, results


def embed_alone(srv, seq: str) -> dict:
    """`seq` embedded through the server's own dispatcher as the only
    request of its batch: a bucketed batch of one row, or a packed batch
    whose first row holds it at position 0 (every other row empty)."""
    from proteinbert_tpu_torch import inference

    disp = srv.dispatcher
    span = disp.bucket_len(len(seq))
    toks = inference._tokenize_masked([seq], disp.cfg.data.seq_len,
                                      "count")[:, :span]
    if srv.serve_mode == "bucketed":
        return {k: v[0] for k, v in disp.run("embed", toks).items()}
    R, L = disp.rows_per_batch, disp.cfg.data.seq_len
    tokens = np.zeros((R, L), np.int32)
    seg = np.zeros((R, L), np.int32)
    tokens[0, :span], seg[0, :span] = toks[0], 1
    ann = np.zeros((R, disp.max_segments, disp.cfg.model.num_annotations),
                   np.float32)
    return disp.run_packed("embed", tokens, seg, ann, [(0, 0, 0, span)])[0]


def full_ragged_batch(srv):
    """One full packed embed batch for a ragged server: 8 rows x 512
    tokens, each row three segments at spans 256, 128, 128 filled to
    <sos> residues <eos>."""
    disp = srv.dispatcher
    R, L, S = disp.rows_per_batch, disp.cfg.data.seq_len, disp.max_segments
    rng = np.random.default_rng(4)
    tokens = np.zeros((R, L), np.int32)
    seg = np.zeros((R, L), np.int32)
    riders = []
    for r in range(R):
        start = 0
        for s, span in enumerate((256, 128, 128)):
            tokens[r, start] = 1
            tokens[r, start + 1:start + span - 1] = rng.integers(4, 26,
                                                                 span - 2)
            tokens[r, start + span - 1] = 2
            seg[r, start:start + span] = s + 1
            riders.append((r, s, start, span))
            start += span
    ann = np.zeros((R, S, disp.cfg.model.num_annotations), np.float32)
    return tokens, seg, ann, riders


def profile_batch(card: str, label: str, run) -> None:
    """Where one full served batch's time goes: torch.profiler over one
    call of `run` (a dispatcher call that ends in a device→host copy) —
    device time by kernel name, and the device's busy share of the wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(5):  # unprofiled: the profiler slows the host side
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + ms)
    busy = sum(t for _, t in by_name.values())
    if not by_name:
        print(f"# profile {label}: the profiler recorded no device time "
              "(device breakdown not measured)")
        return
    print(f"# profile {label} [{card}]: wall {wall_ms:.3f} ms (median of 5, "
          f"unprofiled), device busy {busy:.3f} ms (profiled run; "
          f"{100 * busy / wall_ms:.1f}% of wall)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"#   {t:9.3f} ms {100 * t / busy:5.1f}%  x{n:<4d} {name[:80]}")
    print(f"# profile {label}: host ops by self CPU time (profiled, so "
          "inflated; shares only)")
    for e in sorted(prof.key_averages(),
                    key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"#   host {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<4d} {e.key[:70]}")


def enqueue_ms(srv, batch) -> float:
    """Median host ms from submit to the batch's replay enqueued (the
    async entry's return; each batch is finalized after), over 10 full
    embed batches."""
    disp = srv.dispatcher
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        if srv.serve_mode == "bucketed":
            handle = disp.run_timed_async("embed", batch, timed=False)
        else:
            handle = disp.run_packed_timed_async("embed", *batch,
                                                 timed=False)
        times.append((time.perf_counter() - t0) * 1e3)
        handle.finalize()
    return statistics.median(times)


def replay_equals_eager(label: str, srv, batch) -> None:
    """One full embed batch through the server's warm shape (a graph
    replay) against the same batch run eagerly through the same batch
    function on the same weights: bit for bit (the kernels are
    deterministic)."""
    from proteinbert_tpu_torch import inference

    disp = srv.dispatcher
    quantized = disp.quant != "fp32"
    with disp._arm_snapshot() as (params, _):
        pass
    graphs = disp.executable_count
    if srv.serve_mode == "bucketed":
        got = disp.run("embed", batch)
        ann = np.zeros((batch.shape[0], disp.cfg.model.num_annotations),
                       np.float32)
        want = inference.run_batch(disp._fn("embed", quantized), params,
                                   disp.cfg, batch, ann, device=DEVICE)
        pairs = [(got[k], want[k]) for k in want]
    else:
        tokens, seg, ann, riders = batch
        got = disp.run_packed("embed", tokens, seg, ann, riders)
        host = inference.run_batch(disp._packed_fn("embed", quantized),
                                   params, disp.cfg, tokens, seg, ann,
                                   device=DEVICE)
        pairs = [(g[k], host[k][r, s]) for g, (r, s, _, _) in
                 zip(got, riders) for k in ("global", "local_mean")]
    check(disp.executable_count == graphs, f"{label}: a warm shape was "
                                           "captured again")
    diff = max(float(np.abs(a.astype(np.float64) - b).max())
               for a, b in pairs)
    exact = all(np.array_equal(a, b) for a, b in pairs)
    print(f"# serve {label}: graph replay vs eager run of one full embed "
          f"batch: max |diff| {diff:.3e}, bit for bit {exact}")
    check(exact, f"{label}: graph replay differs from the eager run "
                 f"({diff})")


def http_post(url: str, payload) -> tuple:
    """(status, JSON body) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_round_trips(label: str, srv) -> tuple:
    """One round trip of each kind through `serve/http.py` over
    127.0.0.1, each answer held against the same request submitted in
    process right after it (cache off, so both ran on the card, each
    alone in its batch: exact), then a bad body (400) and a predict_task
    for a head the server does not hold (the typed 404). Returns (the
    requests answered, two a kind; the requests rejected, one)."""
    import urllib.request

    from proteinbert_tpu_torch.serve.http import make_http_server

    httpd = make_http_server(srv, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    worst = 0.0
    try:
        for kind, seq in traffic(3, seed=7):  # one of each kind
            status, body = http_post(f"{base}/v1/{kind}", {"seq": seq})
            check(status == 200, f"{label}: HTTP {kind} answered {status}: "
                                 f"{body}")
            want = srv.submit(kind, seq).result(timeout=120)
            if kind == "embed":
                for key in ("global", "local_mean"):
                    worst = max(worst, float(np.abs(np.asarray(
                        body[key], np.float32) - want[key]).max()))
            elif kind == "predict_go":
                worst = max(worst, float(np.abs(np.asarray(
                    body["probs"], np.float32) - want).max()))
            else:
                check(body["filled"] == want[0],
                      f"{label}: HTTP predict_residues fill differs")
        bad, _ = http_post(f"{base}/v1/embed", {"nope": 1})
        route, body = http_post(f"{base}/v1/predict_task",
                                {"seq": "MKT", "head_id": "nope"})
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(30)
    print(f"# serve {label}: HTTP round trip of each kind over 127.0.0.1 vs "
          f"in process: max |diff| {worst:.3e} (tol 0), fills equal; bad "
          f"body {bad}, /v1/predict_task of an unknown head {route} "
          f"{body.get('type')}, /healthz ok {health.get('ok')}")
    check(worst == 0.0, f"{label}: HTTP answers differ by {worst}")
    check(bad == 400 and route == 404 and body.get("type") == "unknown_head"
          and health.get("ok") is True,
          f"{label}: HTTP status mapping {bad}/{route}/{health.get('ok')}")
    return 6, 1


def same_answer(kind: str, a, b) -> bool:
    if kind == "embed":
        return all(np.array_equal(a[k], b[k]) for k in ("global",
                                                         "local_mean"))
    if kind == "predict_go":
        return np.array_equal(a, b)
    return a[0] == b[0] and np.array_equal(a[1], b[1])


def depth_parity(card: str, label: str, cfg, mode: str, seed: int,
                 quant: str) -> None:
    """The 24-request traffic at pipeline_depth 2 and then 1, on fresh
    servers over the same weights, every request submitted before
    start() so both form the same batches: the answers bit for bit the
    same, every future sealed once, inflight_max at most the depth. Both
    servers carry telemetry: the event stream passes
    read_events(strict=True) and the schema validator, one serve_request
    a request and one serve_batch a batch. The depth-2 server also
    answers `http_round_trips` while it is live."""
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.obs import Telemetry, read_events
    from proteinbert_tpu_torch.obs.events import validate_record
    from proteinbert_tpu_torch.serve.dispatch import KINDS
    from proteinbert_tpu_torch.serve.server import Server

    reqs = traffic(24, seed=0)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="serve-", dir=build)
    answers = {}
    try:
        for depth in (2, 1):
            gc.collect()
            params = init(cfg.model, torch.Generator().manual_seed(seed),
                          device=DEVICE)
            path = os.path.join(root, f"events-{depth}.jsonl")
            tele = Telemetry(events_path=path)
            srv = Server(params, cfg, device=DEVICE, buckets=BUCKETS,
                         max_batch=8, max_wait_s=0.005, queue_depth=64,
                         cache_size=0, warm_kinds=KINDS, serve_mode=mode,
                         pack_max_segments=8, quant=quant,
                         quant_parity_every=0, telemetry=tele,
                         pipeline_depth=depth)
            del params
            sealed = [0] * len(reqs)
            futures = []
            for i, (kind, seq) in enumerate(reqs):
                f = srv.submit(kind, seq)
                f.add_done_callback(
                    lambda f, i=i: sealed.__setitem__(i, sealed[i] + 1))
                futures.append(f)
            srv.start()
            answers[depth] = [f.result(timeout=300) for f in futures]
            extra, rejected = (http_round_trips(label, srv) if depth == 2
                               else (0, 0))
            check(srv.drain(timeout=300), f"{label}: depth {depth} drain "
                                          "timed out")
            tele.close()
            stats = srv.stats()
            pipe = stats["pipeline"]
            recs = read_events(path, strict=True)
            for rec in recs:
                validate_record(rec)
            events = [r["event"] for r in recs]
            print(f"# serve {label} depth {depth}: {stats['batches']} "
                  f"batches, inflight_max {pipe['inflight_max']}, overlap "
                  f"ratio {pipe['overlap_ratio']}, finalize "
                  f"{pipe['finalize_seconds_total']} s; {len(recs)} events "
                  f"valid ({events.count('serve_request')} serve_request, "
                  f"{events.count('serve_batch')} serve_batch)")
            check(sealed == [1] * len(reqs), f"{label}: depth {depth} "
                                             f"sealed {sealed}")
            check(stats["completed"] == len(reqs) + extra,
                  f"{label}: depth {depth} completed {stats['completed']}")
            check(1 <= pipe["inflight_max"] <= depth,
                  f"{label}: inflight_max {pipe['inflight_max']} at depth "
                  f"{depth}")
            check(events[0] == "serve_start" and events[-1] == "serve_end"
                  and recs[-1]["outcome"] == "drained",
                  f"{label}: event stream {events[0]} .. {events[-1]}")
            check(events.count("serve_request")
                  == len(reqs) + extra + rejected
                  and events.count("serve_batch") == stats["batches"]
                  and stats["rejected"]["unknown_head"] == rejected,
                  f"{label}: {events.count('serve_request')} serve_request, "
                  f"{events.count('serve_batch')} serve_batch events")
            del srv
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = all(same_answer(kind, a, b) for (kind, _), a, b in
               zip(reqs, answers[2], answers[1]))
    print(f"# serve {label}: depth 2 answers bit for bit depth 1's: {same} "
          f"({len(reqs)} requests) [{card}]")
    check(same, f"{label}: pipelining changed an answer")


def serve_phases(card: str, gates: bool = True) -> dict:
    """The three served paths (bucketed base, ragged base, ragged at the
    ModelConfig default width), each on the fp32 arm and then on the int8
    arm (same weights and traffic): the traffic with its launch gates and
    numbers, the profile of one full batch and, with warm shapes, the
    host time to enqueue one. With `gates`, each also holds a graph
    replay against the eager run (`replay_equals_eager`) and depth 2
    against depth 1 with the event stream and HTTP (`depth_parity`);
    then the int8 arm's parity shadow, the `int8_act` arm and serving
    over a two-lane mesh (`serve_mesh_phase`). Without
    (`--phase serve-times`, which also runs on the parent commit's
    package), only the numbers. Returns each kernel's launches summed
    over the traffic runs."""
    from proteinbert_tpu_torch.configs import ModelConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_Q8, ONEPASS, ONEPASS_Q8,
    )

    base = get_preset("base")
    default = base.replace(model=ModelConfig())
    rng = np.random.default_rng(3)
    tokens = rng.integers(4, 26, (8, 512)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 1, 2
    totals = {}
    # (label, config, mode, fp32 launches per batch, int8 launches per batch)
    servers = (
        ("bucketed base", base, "bucketed",
         {LOCAL_TRACK.name: 6, ATTENTION.name: 6},
         {LOCAL_TRACK.name: 6, ATTENTION_Q8.name: 6}),
        ("ragged base", base, "ragged",
         {LOCAL_TRACK_SEGMENTS.name: 6, ATTENTION.name: 6},
         {LOCAL_TRACK_SEGMENTS_Q8.name: 6, ATTENTION_Q8.name: 6}),
        ("ragged default width", default, "ragged",
         {ONEPASS.name: 6}, {ONEPASS_Q8.name: 6}),
    )
    reqs = traffic(24, seed=0)
    for label, cfg, mode, per_fp, per_q8 in servers:
        answers = {}
        for quant, per_batch in (("fp32", per_fp), ("int8", per_q8)):
            name = label if quant == "fp32" else f"{label} int8"
            srv, launches, answers[quant] = serve_phase(
                card, name, cfg, mode, per_batch, seed=0, quant=quant)
            for kname, n in launches.items():
                totals[kname] = totals.get(kname, 0) + n
            if mode == "bucketed":
                batch = tokens
                profile_batch(card, f"{name}, one embed batch 8x512",
                              lambda: srv.dispatcher.run("embed", tokens))
            else:
                batch = full_ragged_batch(srv)
                profile_batch(card, f"{name}, one packed embed batch 8x512 "
                              "(24 segments)",
                              lambda: srv.dispatcher.run_packed("embed",
                                                                *batch))
            if hasattr(srv.dispatcher, "graph_pool_bytes"):
                print(f"# serve {name} [{card}]: host ms from submit to the "
                      f"replay enqueued, one full embed batch "
                      f"{enqueue_ms(srv, batch):.3f} (median of 10)")
            if gates:
                replay_equals_eager(name, srv, batch)
            del srv
            if gates:
                depth_parity(card, name, cfg, mode, seed=0, quant=quant)
        diff = max_answer_diff(reqs, answers["int8"], answers["fp32"],
                               same_fills=False)
        print(f"# serve {label} int8: max |int8 - fp32 arm| over the "
              f"{len(reqs)} answers {diff:.6e}")
        check(diff > 0, f"{label}: the int8 arm answered exactly as the fp32 "
                        "arm (were the int8 weights used?)")
    if not gates:
        return totals
    q8_parity_phase(card, base)
    srv, launches, answers = serve_phase(
        card, "bucketed base int8_act", base, "bucketed",
        {LOCAL_TRACK.name: 6, ATTENTION_Q8.name: 6}, seed=0,
        quant="int8_act", n_requests=12, alone=False)
    for kname, n in launches.items():
        totals[kname] = totals.get(kname, 0) + n
    del srv
    t0 = time.perf_counter()
    for kname, n in serve_mesh_phase(card).items():
        totals[kname] = totals.get(kname, 0) + n
    print(f"# serve mesh base: {time.perf_counter() - t0:.1f} s")
    return totals


def q8_parity_phase(card: str, base) -> None:
    """The int8 arm's fp32 parity shadow: a bucketed base dispatcher with
    quant_parity_every=1 runs 3 embed batches (4 rows, L=128 and 256); each
    runs the shadow, and `quant_report["parity_max"]` must equal the worst
    deviation measured outside against an fp32 dispatcher on the same
    weights."""
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.dispatch import (
        BucketDispatcher, parity_max,
    )

    params = init(base.model, torch.Generator().manual_seed(0),
                  device=DEVICE)
    disp = BucketDispatcher(params, base, buckets=BUCKETS, max_batch=4,
                            device=DEVICE, quant="int8",
                            quant_parity_every=1)
    fp32 = BucketDispatcher(params, base, buckets=BUCKETS, max_batch=4,
                            device=DEVICE)
    disp.warmup(("embed",))
    check(disp._quant_batches == 0, "warmup consumed the parity cadence")
    rng = np.random.default_rng(9)
    worst = 0.0
    for L in (128, 256, 128):
        toks = rng.integers(4, 26, (4, L)).astype(np.int32)
        toks[:, 0], toks[:, -1] = 1, 2
        toks[3, L // 2:] = 0
        toks[3, L // 2 - 1] = 2
        out = disp.run("embed", toks)
        worst = max(worst, parity_max(out, fp32.run("embed", toks)))
    report = disp.quant_report
    print(f"# serve parity: bucketed base int8, quant_parity_every=1, 3 "
          f"batches: parity_samples {report.get('parity_samples')}, "
          f"parity_max {report.get('parity_max')}, measured outside "
          f"{worst:.9f}, fp32 tree {report['fp32_resident']} [{card}]")
    check(report.get("parity_samples") == 3, "parity samples != 3")
    check(report["fp32_resident"] == "device", "shadow tree not on device")
    check(report["parity_max"] == round(worst, 9) and worst > 0,
          f"parity_max {report['parity_max']} != measured {worst}")


LANE_BUCKETS = (256, 512)
LANE_FLIPS = 40           # flips and rollbacks racing the batches
LANE_RACE_BATCHES = 2000  # at most, while the flips run


def lane_device() -> str:
    """The one card named by index (a serving mesh's lanes), or the CPU."""
    return "cuda:0" if DEVICE == "cuda" else DEVICE


def lane_batches(srv, tokens) -> list:
    """The leg's direct batches for a server's dispatcher: bucketed, one
    full embed batch 8x512 and one of 4x256; ragged, one full packed
    batch (`full_ragged_batch`)."""
    if srv.serve_mode == "bucketed":
        return [tokens, tokens[:4, :256]]
    return [full_ragged_batch(srv)]


def lane_run(srv, batch):
    """One embed batch through a server's dispatcher → its host outputs
    as one list of arrays."""
    disp = srv.dispatcher
    if srv.serve_mode == "bucketed":
        out = disp.run("embed", batch)
        return [out[k] for k in sorted(out)]
    return [o[k] for o in disp.run_packed("embed", *batch)
            for k in sorted(o)]


def lane_torn_gate(card: str, label: str, srv, params, batch,
                   tally: "LaunchTally", per_batch: dict) -> None:
    """A candidate loaded on both lanes, then LANE_FLIPS flips and
    rollbacks on another thread while this one runs `batch` through the
    two-lane dispatcher: every batch equals, bit for bit, its whole
    output under the resident trunk or under the candidate — never one
    lane of each. Launches: exactly per_batch a batch (the flips launch
    nothing)."""
    disp = srv.dispatcher
    t0 = time.perf_counter()
    srv.load_candidate(params=perturbed(params, ROLLOUT_FAR, seed=41))
    load_s = time.perf_counter() - t0
    old = lane_run(srv, batch)
    srv.flip()
    new = lane_run(srv, batch)
    srv.rollback_trunk()
    back = lane_run(srv, batch)
    check(all(np.array_equal(a, b) for a, b in zip(old, back)),
          f"{label}: rollback did not give the resident outputs back")
    check(not any(np.array_equal(a, b) for a, b in zip(old, new)),
          f"{label}: the candidate answered as the resident trunk")
    tally.take()
    ops = []

    def flipper():
        for i in range(LANE_FLIPS):
            ops.append((srv.flip if i % 2 == 0 else srv.rollback_trunk)())

    thread = threading.Thread(target=flipper)
    seen = {"old": 0, "new": 0}
    n = 0
    t0 = time.perf_counter()
    thread.start()
    while thread.is_alive() and n < LANE_RACE_BATCHES:
        got = lane_run(srv, batch)
        n += 1
        arms = [arm for arm, want in (("old", old), ("new", new))
                if all(np.array_equal(a, b) for a, b in zip(got, want))]
        check(len(arms) == 1, f"{label}: batch {n} during the flips is "
                              "torn (it equals neither trunk's whole batch)")
        seen[arms[0]] += 1
    thread.join(300)
    race_s = time.perf_counter() - t0
    check(not thread.is_alive(), f"{label}: the flips hung")
    got = tally.take()
    tally.expect(f"{label} torn", got,
                 {k: v * n for k, v in per_batch.items()})
    srv.unload_candidate()
    print(f"# serve {label} torn [{card}]: candidate loaded on both lanes "
          f"in {load_s:.2f} s; {LANE_FLIPS} flips and rollbacks "
          f"({[round(o['seconds'], 4) for o in ops]} s) on another thread "
          f"while {n} batches ran ({race_s:.2f} s): every batch bit for "
          f"bit one trunk's whole output, old {seen['old']} / new "
          f"{seen['new']}; launches { {k: c for k, c in got.items() if c} }")


def serve_mesh_phase(card: str) -> dict:
    """`# serve mesh base ...`: serving over a mesh, two lanes on the one
    card (a `ServeMesh` of data=2 over cuda:0 twice: each lane its own
    copy of the trunk, CUDA graphs, pool and stream), beside a one-lane
    server on the same seeded weights: the bucketed base path (fp32 and
    int8) and the ragged base path, buckets 256 / 512, the embed kind.
    Each pair of Servers answers 16 requests (exactly twice the one-lane
    launches a batch on the mesh); then the direct batches
    (`lane_batches`): the two-lane outputs within SERVE_EMBED_TOL of the
    one lane's (cuBLAS may pick another algorithm for the lanes' smaller
    products; the max difference printed), the launches exactly the
    one-lane counts x 2 a batch; each lane's graphs and pool bytes. On
    the bucketed fp32 pair, `lane_torn_gate`. One card cannot place the
    lanes on two cards: the split over different cards is unchecked.
    Returns the launches counted."""
    from proteinbert_tpu_torch.configs import MeshConfig, get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
    )
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.parallel.mesh import serve_mesh
    from proteinbert_tpu_torch.serve.server import Server

    base = get_preset("base")
    nb = base.model.num_blocks
    rng = np.random.default_rng(3)
    tokens = rng.integers(4, 26, (8, 512)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 1, 2
    seqs = rollout_seqs(16, seed=43)
    tally = LaunchTally()
    legs = (("bucketed", "fp32", {LOCAL_TRACK.name: nb, ATTENTION.name: nb}),
            ("bucketed", "int8", {LOCAL_TRACK.name: nb,
                                  ATTENTION_Q8.name: nb}),
            ("ragged", "fp32", {LOCAL_TRACK_SEGMENTS.name: nb,
                                ATTENTION.name: nb}))
    for mode, quant, per in legs:
        label = f"mesh base {mode}" + ("" if quant == "fp32" else " int8")
        gc.collect()
        params = init(base.model, torch.Generator().manual_seed(0),
                      device=DEVICE)
        servers, answers = {}, {}
        for lanes in (1, 2):
            mesh = (None if lanes == 1 else serve_mesh(
                MeshConfig(data=2), devices=[lane_device()] * 2))
            # Each server its own trunk: a flip writes into the tree.
            srv = Server(perturbed(params, 0, 0), base, device=DEVICE,
                         buckets=LANE_BUCKETS, max_batch=8,
                         max_wait_s=0.005, cache_size=0,
                         warm_kinds=("embed",), serve_mode=mode,
                         quant=quant, quant_parity_every=0, mesh=mesh)
            t0 = time.perf_counter()
            srv.start()
            warm_s = time.perf_counter() - t0
            tally.take()
            futures = [srv.submit("embed", seq) for seq in seqs]
            answers[lanes] = [f.result(timeout=120) for f in futures]
            batches = settled_batches(srv)
            got = tally.take()
            tally.expect(f"{label} {lanes} lane(s) traffic", got,
                         {k: v * lanes * batches for k, v in per.items()})
            torch.cuda.synchronize()
            by_lane = srv.dispatcher.lane_report()
            stats = srv.stats()
            print(f"# serve {label}, {lanes} lane(s) [{card}]: warmup "
                  f"{warm_s:.2f} s; 16 requests in {batches} batches, "
                  f"launches { {k: n for k, n in got.items() if n} } (want "
                  f"{lanes} x {per} a batch); stats()['mesh'] "
                  f"{stats['mesh']}, executables {stats['executables']}, "
                  f"graphs {stats['graphs']}; by lane {by_lane}")
            servers[lanes] = srv
        served = max(embed_diff(a, b)
                     for a, b in zip(answers[1], answers[2]))
        worst, exact, counts = 0.0, True, {1: [], 2: []}
        for batch in lane_batches(servers[1], tokens):
            got = {}
            for lanes, srv in servers.items():
                got[lanes] = lane_run(srv, batch)
                counts[lanes].append(tally.take())
                tally.expect(f"{label} {lanes} lane(s) batch",
                             counts[lanes][-1],
                             {k: v * lanes for k, v in per.items()})
            for a, b in zip(got[1], got[2]):
                worst = max(worst, float(np.abs(
                    a.astype(np.float64) - b).max()))
                exact = exact and np.array_equal(a, b)
        print(f"# serve {label}: two lanes vs one, the 16 served answers "
              f"max |diff| {served:.3e}; the direct batches max |diff| "
              f"{worst:.3e}, bit for bit {exact} (tol {SERVE_EMBED_TOL}); "
              f"launches a direct batch, one lane "
              f"{[{k: n for k, n in c.items() if n} for c in counts[1]]}, "
              f"two {[{k: n for k, n in c.items() if n} for c in counts[2]]}")
        check(served <= SERVE_EMBED_TOL and worst <= SERVE_EMBED_TOL,
              f"{label}: two lanes differ from one by {max(served, worst)}")
        if mode == "bucketed" and quant == "fp32":
            lane_torn_gate(card, label, servers[2], params, tokens,
                           tally, {k: 2 * v for k, v in per.items()})
        for srv in servers.values():
            check(srv.drain(timeout=120), f"{label}: drain timed out")
        del servers, params
    tally.take()
    gc.collect()
    torch.cuda.empty_cache()
    return tally.totals


# ---------------------------------------------------- corpus to task head

def corpus_rows(n: int, num_annotations: int, seed: int):
    """n seeded proteins, lengths log-normal with a median of 350 residues
    (sigma 0.9) capped at 3000, so that the `long` preset's buckets 512,
    1024 and 2048 all fill, and (n, A) annotation masks at ~0.5%."""
    from proteinbert_tpu_torch.data.vocab import ALPHABET

    rng = np.random.default_rng(seed)
    lengths = np.clip(np.round(rng.lognormal(np.log(350), 0.9, n)), 1,
                      3000).astype(np.int64)
    letters = np.frombuffer("".join(ALPHABET).encode(), np.uint8)
    seqs = [letters[rng.integers(0, len(letters), int(L))].tobytes().decode()
            for L in lengths]
    masks = rng.random((n, num_annotations)) < 0.005
    return seqs, lengths, masks


def write_corpus(path: str, seqs, lengths, masks) -> None:
    """The reference's HDF5 corpus schema: `seqs`, `seq_lengths`,
    `annotation_masks` (bool), `included_annotations`, `uniprot_ids`."""
    import h5py

    str_dt = h5py.string_dtype()
    with h5py.File(path, "w") as f:
        f.create_dataset(
            "included_annotations", dtype=str_dt,
            data=np.array([f"GO:{i:07d}".encode()
                           for i in range(masks.shape[1])], dtype=object))
        f.create_dataset("uniprot_ids", dtype=str_dt,
                         data=np.array([f"R{i}".encode()
                                        for i in range(len(seqs))],
                                       dtype=object))
        f.create_dataset("seqs", dtype=str_dt, chunks=(1024,),
                         data=np.array(seqs, dtype=object))
        f.create_dataset("seq_lengths", data=lengths.astype(np.int32))
        f.create_dataset("annotation_masks", data=masks,
                         chunks=(256, masks.shape[1]))


def long_hdf5_phase(card: str) -> dict:
    """`# train long hdf5`: the `long` preset (6 blocks, C=G=512, H=8,
    8943 annotations) in bf16 pretrains from a seeded HDF5 corpus of 4096
    proteins (4 blocks of 1024 rows) through `HDF5PretrainingDataset`,
    `make_bucketed_iterator` (buckets 512 / 1024 / 2048) and pretrain's
    prefetch thread (depth 2): B=16, 8 steps, the LR without warmup. Cuts:
    global batch 64 over 4 data replicas -> one replica's 16 rows, seq
    world 4 -> 1 (the whole row on one card), no LR warmup. Without h5py
    the same rows come from `InMemoryPretrainingDataset` (one printed
    line says so). Gates: the prefetched stream equals the iterator's own
    byte for byte and in order; exactly 6 launches of K1 and of K2 a step
    and none of the others; finite losses. Returns the launches."""
    from proteinbert_tpu_torch.data.dataset import (
        HDF5PretrainingDataset, InMemoryPretrainingDataset,
        make_bucketed_iterator,
    )
    from proteinbert_tpu_torch.data.prefetch import prefetch
    from proteinbert_tpu_torch.kernels import ATTENTION, LOCAL_TRACK
    from proteinbert_tpu_torch.obs import Telemetry, read_events
    from proteinbert_tpu_torch.train.metrics import peak_flops, train_flops

    cfg = train_preset("long", 16, 2048, 8)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, prefetch_depth=2),
        optimizer=dataclasses.replace(cfg.optimizer, schedule="constant",
                                      warmup_steps=0))
    B, buckets = cfg.data.batch_size, cfg.data.buckets
    t0 = time.perf_counter()
    seqs, lengths, masks = corpus_rows(4096, cfg.model.num_annotations, 13)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="corpus-", dir=build)
    try:
        try:
            import h5py  # noqa: F401
            path = os.path.join(root, "corpus.h5")
            write_corpus(path, seqs, lengths, masks)
            mb = os.path.getsize(path) / 1e6
            print(f"# train long hdf5: corpus of {len(seqs)} proteins "
                  f"(median {int(np.median(lengths))}, max {lengths.max()} "
                  f"residues), {mb:.1f} MB HDF5, written in "
                  f"{time.perf_counter() - t0:.1f} s")

            def dataset():
                return HDF5PretrainingDataset(path, cfg.data.seq_len,
                                              crop_seed=7)
        except ImportError:
            print(f"# train long hdf5: h5py absent on {card}, rows fed from "
                  "InMemoryPretrainingDataset")
            mem = InMemoryPretrainingDataset(seqs, masks, cfg.data.seq_len,
                                             crop_seed=7)

            def dataset():
                return mem

        def stream():
            return make_bucketed_iterator(dataset(), B, buckets, seed=0)

        direct = [b for _, b in zip(range(8), stream())]
        it = prefetch(stream(), 2)
        ahead = [next(it) for _ in range(8)]
        it.close()
        same = all(a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
            for k in a) for a, b in zip(direct, ahead))
        events = os.path.join(root, "events.jsonl")
        tele = Telemetry(events_path=events)
        try:
            out, walls, launches, peak, _, trained = train_run(
                card, "long hdf5", cfg, 8,
                {LOCAL_TRACK.name: 6, ATTENTION.name: 6}, (0, 0), 0,
                source=stream, telemetry=tele)
        finally:
            tele.close()
        steps = [r for r in read_events(events, strict=True)
                 if r["event"] == "step"]
        wait = [r.get("data_wait_s") for r in steps]
        gauges = tele.metrics.snapshot()["gauges"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = same and all(
        a["tokens"].tobytes() == b["tokens"].tobytes()
        and a["annotations"].tobytes() == b["annotations"].tobytes()
        for a, b in zip(trained, direct))
    Ls = [b["tokens"].shape[1] for b in trained]
    print(f"# train long hdf5: the prefetched stream equals the iterator's "
          f"own, byte for byte and in order ({len(direct)} batches, pretrain "
          f"trained on the same): {same}; bucket of each step {Ls}")
    check(same and len(trained) == 8, "long hdf5: the prefetched stream "
                                      "differs from the iterator's")
    pad = float(np.mean([(b["tokens"] == 0).mean() for b in trained]))
    peak_rate = peak_flops(torch.device(DEVICE), cfg.model.dtype)
    by_bucket = []
    for L in buckets:
        ms = [w for w, l in zip(walls, Ls) if l == L]
        if not ms:
            by_bucket.append(f"L={L}: not run")
            continue
        med = statistics.median(ms)
        mfu = train_flops(cfg.model, B, L) / (med / 1e3) / peak_rate
        by_bucket.append(f"L={L}: median {med:.1f} ms of {len(ms)} "
                         f"({', '.join(f'{w:.1f}' for w in ms)}), "
                         f"{B * L / (med / 1e3):.0f} tokens/s, MFU "
                         f"{mfu:.4f}")
    for L in buckets:   # where one step's time goes, per bucket
        batch = next((b for b in trained if b["tokens"].shape[1] == L), None)
        if batch is not None:
            profile_step(card, f"train long hdf5, one step B={B} L={L}",
                         out["state"], batch, cfg)
    m = cfg.model
    print(f"# train long hdf5 [{card}]: {m.num_blocks} blocks C={m.local_dim} "
          f"G={m.global_dim} H={m.num_heads} A={m.num_annotations}, "
          f"{m.dtype}, B={B}, buckets {list(buckets)}; reported cuts: global "
          f"batch 64 over 4 data replicas -> 16 rows, seq world 4 -> 1, no "
          f"LR warmup; step ms by bucket (the first step of a shape "
          f"included): {'; '.join(by_bucket)}; data_wait_s at each log "
          f"point {wait}; data_batches_total "
          f"{gauges.get('data_batches_total')}; pad fraction of the B*L "
          f"grid {pad:.4f}; max_memory_allocated {peak / 1e9:.2f} GB")
    return launches


def finetune_phase(card: str, registry_dir: str) -> tuple:
    """`# finetune base`: the `base` trunk (the paper's 6 x 512 model,
    8943 annotations) in bf16, seeded random weights, fine-tuned through
    `train.finetune.finetune` on seeded task data (B=8, L=512, 4 steps)
    for token_classification with 8 classes and sequence_regression with
    1 output, each with freeze_trunk False and True; each trained head is
    registered in a `HeadRegistry` at `registry_dir`. First a float32
    2-block base-width step on the card against the same step on the CPU
    plain path (loss <= STEP_LOSS_TOL, grads <= STEP_GRAD_TOL) for both
    tasks. Gates: exactly 6 K1 + 6 K2 launches a step (the backward is
    the recompute of the XLA reference, no kernel); under freeze_trunk
    the trunk bit for bit the pretrained one; finite losses. Returns
    (the launches, the resident trunk's params, {(kind, frozen): head
    id})."""
    from proteinbert_tpu_torch.configs import (
        FinetuneConfig, OptimizerConfig, TaskConfig, get_preset,
    )
    from proteinbert_tpu_torch.data.synthetic import make_task_batches
    from proteinbert_tpu_torch.heads import HeadRegistry
    from proteinbert_tpu_torch.kernels import ATTENTION, KERNELS, LOCAL_TRACK
    from proteinbert_tpu_torch.models.proteinbert import init, to_device
    from proteinbert_tpu_torch.train import finetune as ft

    KERNELS_BY_NAME = {k.name: k for k in KERNELS}
    from proteinbert_tpu_torch.train.schedule import tree_leaves

    base = get_preset("base")
    opt = OptimizerConfig(learning_rate=1e-4, warmup_steps=0,
                          schedule="constant")
    tasks = (("token_classification", 8), ("sequence_regression", 1))

    # float32, 2 blocks, card vs CPU (the Large fp32 gate's limits)
    small = dataclasses.replace(base.model, dtype="float32", num_blocks=2)
    params = init(small, torch.Generator().manual_seed(51), device="cpu")
    for kind, n_out in tasks:
        cfg = FinetuneConfig(model=small, optimizer=opt,
                             task=TaskConfig(kind=kind, num_outputs=n_out))
        (batch,) = make_task_batches(8, np.random.default_rng(52), kind,
                                     n_out, 512, 8)
        state = ft.create_finetune_state(torch.Generator().manual_seed(53),
                                         cfg, params, device="cpu")
        want_g, want_m = ft.loss_and_grads(
            state.params, {k: torch.from_numpy(v) for k, v in batch.items()},
            cfg)
        card_params = to_device(state.params, torch.device(DEVICE))
        n0 = (LOCAL_TRACK.launches, ATTENTION.launches)
        got_g, got_m = ft.loss_and_grads(
            card_params, {k: torch.from_numpy(v).to(DEVICE)
                          for k, v in batch.items()}, cfg)
        torch.cuda.synchronize()
        check((LOCAL_TRACK.launches - n0[0], ATTENTION.launches - n0[1])
              == (2, 2), "finetune reference step did not run K1 and K2 "
                         "once a block")
        loss_err = abs(float(got_m["loss"]) - float(want_m["loss"]))
        grad_err = max((a.cpu() - b).abs().max().item()
                       for a, b in zip(got_g, want_g))
        print(f"# finetune reference step {kind}: 2-block fp32 base width, "
              f"B=8 L=512, card vs CPU plain path: loss "
              f"{float(got_m['loss']):.6f} |diff| {loss_err:.3e} (tol "
              f"{STEP_LOSS_TOL}), grads max |diff| {grad_err:.3e} over "
              f"{len(got_g)} tensors (tol {STEP_GRAD_TOL}) [{card}]")
        check(loss_err <= STEP_LOSS_TOL, f"finetune step loss {loss_err}")
        check(grad_err <= STEP_GRAD_TOL, f"finetune step grads {grad_err}")

    trunk = init(base.model, torch.Generator().manual_seed(61),
                 device=DEVICE)
    registry = HeadRegistry(registry_dir)
    totals = {}
    heads = {}
    B, L = 8, 512
    for kind, n_out in tasks:
        batches = make_task_batches(32, np.random.default_rng(62), kind,
                                    n_out, L, B)
        for frozen in (False, True):
            label = f"{kind} freeze_trunk={frozen}"
            cfg = FinetuneConfig(
                model=base.model, optimizer=opt,
                task=TaskConfig(kind=kind, num_outputs=n_out,
                                freeze_trunk=frozen, epochs=1))
            marks = []

            def timed(batches=batches):
                # A step is the wall between two marks, the card synced:
                # one before each batch, one when the loop asks for more.
                for b in batches:
                    torch.cuda.synchronize()
                    marks.append((time.perf_counter(),
                                  {k.name: k.launches for k in KERNELS}))
                    yield b
                torch.cuda.synchronize()
                marks.append((time.perf_counter(),
                              {k.name: k.launches for k in KERNELS}))

            for k in KERNELS:
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = ft.finetune(cfg, lambda epoch: timed(),
                              pretrained_trunk=trunk, device=DEVICE,
                              registry=registry,
                              register_name=f"{kind}-{frozen}")
            peak = torch.cuda.max_memory_allocated()
            walls = []
            for (t0, n0), (t1, n1) in zip(marks, marks[1:]):
                walls.append((t1 - t0) * 1e3)
                for name in n1:
                    want = {LOCAL_TRACK.name: 6, ATTENTION.name: 6}.get(name,
                                                                        0)
                    check(n1[name] - n0[name] == want,
                          f"finetune {label}: a step launched {name} "
                          f"{n1[name] - n0[name]} times, want {want}")
            check(len(walls) == 4, f"finetune {label}: {len(walls)} steps")
            for name, n in marks[-1][1].items():
                check(n == KERNELS_BY_NAME[name].launches,
                      f"finetune {label}: {name} launched after the steps")
                totals[name] = totals.get(name, 0) + n
            hist = out["history"][-1]
            check(all(np.isfinite(v) for k, v in hist.items()
                      if k.startswith("train_")), f"finetune {label}: "
                                                  f"{hist}")
            if frozen:
                same = all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(out["state"].params["trunk"]),
                    tree_leaves({k: v for k, v in trunk.items()
                                 if k not in ("local_head", "global_head")})))
                print(f"# finetune {label}: trunk after 4 steps bit for bit "
                      f"the pretrained one: {same}")
                check(same, f"finetune {label}: the frozen trunk moved")
            heads[(kind, frozen)] = out["head_id"]
            profile_finetune_step(card, f"finetune base {label}, one step "
                                  f"B={B} L={L}", out["state"], batches[0],
                                  cfg)
            med = statistics.median(walls[1:])
            m = cfg.model
            print(f"# finetune base {label} [{card}]: {m.num_blocks} blocks "
                  f"C={m.local_dim} G={m.global_dim} H={m.num_heads}, "
                  f"{m.dtype}, B={B} L={L}, 4 steps, train metrics "
                  f"{ {k: round(v, 4) for k, v in hist.items()} }; step ms "
                  f"median of 3 {med:.1f} (steps "
                  f"{', '.join(f'{w:.1f}' for w in walls)}), "
                  f"{B * L / (med / 1e3):.0f} tokens/s; max_memory_allocated "
                  f"{peak / 1e9:.2f} GB; registered head {out['head_id']}")
    return totals, trunk, heads


def profile_finetune_step(card: str, label: str, state, batch, cfg) -> None:
    """Where one fine-tune step's time goes: synchronized phases (host ->
    device, forward + task loss, backward, optimizer), then
    `profile_batch` over a whole synchronized step (its wall and the
    device's busy share, the largest kernels)."""
    from proteinbert_tpu_torch.train import finetune as ft
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.train.train_state import (
        _to_device, gradient_update,
    )

    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mark()
    b = _to_device(batch, torch.device(DEVICE))
    mark()
    trained = ft.trained_params(state.params, cfg)
    leaves = tree_leaves(trained)
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = ft.task_loss(ft._outputs(state.params, b, cfg,
                                           cfg.task.freeze_trunk), b,
                               cfg.task.kind)
        mark()
        # A token head reads no global track: the last block's global
        # weights get no gradient (zeros, as `grads_of` gives them).
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        mark()
    for t in leaves:
        t.requires_grad_(False)
    gradient_update(ft.make_finetune_optimizer(cfg), trained, grads,
                    state.opt_state, loss)
    mark()
    wall = marks[-1] - marks[0]
    print(f"# profile {label} [{card}]: one step {wall * 1e3:.1f} ms, "
          "phases synchronized:")
    for name, a, c in zip(("host -> device", "forward + task loss",
                           "backward", "optimizer"), marks, marks[1:]):
        print(f"#   {(c - a) * 1e3:9.1f} ms {100 * (c - a) / wall:5.1f}%  "
              f"{name}")

    def step():
        ft.finetune_step(state, batch, cfg)
        torch.cuda.synchronize()

    profile_batch(card, label, step)


def predict_task_traffic(srv, reqs):
    """Warm every trunk shape, set every kernel count to 0, submit
    `reqs` ((head id, sequence) pairs) before `start()`, so the batches
    form from the whole queue in order — per bucket, FIFO chunks of
    max_batch (bucketed), or first-fit packed rows (ragged) — then start
    and return the answers in order."""
    from proteinbert_tpu_torch.kernels import KERNELS

    srv.dispatcher.warmup(("predict_task",))
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    futures = [srv.submit("predict_task", seq, head_id=hid)
               for hid, seq in reqs]
    srv.start()
    return [f.result(timeout=300) for f in futures]


def bucketed_batches(srv, reqs):
    """The bucketed batches `predict_task_traffic` forms: per bucket
    length, FIFO chunks of max_batch → [(L, [request index, ...])]."""
    groups = {}
    for i, (_, seq) in enumerate(reqs):
        groups.setdefault(srv.dispatcher.bucket_len(len(seq)), []).append(i)
    n = srv.scheduler.max_batch
    return [(L, idx[j:j + n]) for L, idx in groups.items()
            for j in range(0, len(idx), n)]


def task_batch_equals_eager(label: str, srv, heads) -> tuple:
    """One full predict_task batch mixing `heads` row by row (bucketed:
    8 x 512; ragged: 8 rows of three segments) through the server's trunk
    graph and tails, against the same trunk entry and tails run eagerly
    on the same card: bit for bit. Returns (the dispatcher call, its
    outputs)."""
    from proteinbert_tpu_torch.heads import apply as heads_apply

    disp = srv.dispatcher
    quantized = disp.quant != "fp32"
    with disp._arm_snapshot() as (params, _):
        pass
    fn = disp._trunk_fn(quantized)
    graphs = disp.trunk_executable_count
    if srv.serve_mode == "bucketed":
        rng = np.random.default_rng(3)
        tokens = rng.integers(4, 26, (8, 512)).astype(np.int32)
        tokens[:, 0], tokens[:, -1] = 1, 2
        ann = np.zeros((8, disp.cfg.model.num_annotations), np.float32)
        rows = [heads[i % len(heads)] for i in range(8)]

        def run():
            return disp.run("predict_task", tokens, heads=rows)

        got = run()
        trunk_out = fn(params, torch.from_numpy(tokens).to(DEVICE),
                       torch.from_numpy(ann).to(DEVICE), disp.cfg.model)
        want = heads_apply.apply_heads(trunk_out, rows)
    else:
        tokens, seg, ann, riders = full_ragged_batch(srv)
        rows = [heads[i % len(heads)] for i in range(len(riders))]

        def run():
            return disp.run_packed("predict_task", tokens, seg, ann, riders,
                                   heads=rows)

        got = run()
        trunk_out = fn(params, *(torch.from_numpy(a).to(DEVICE)
                                 for a in (tokens, seg, ann)),
                       disp.cfg.model)
        want = heads_apply.apply_heads_packed(
            trunk_out, [(h,) + tuple(r) for h, r in zip(rows, riders)])
    check(disp.trunk_executable_count == graphs,
          f"{label}: a trunk graph was captured again")
    exact = all(np.array_equal(a, b) for a, b in zip(got, want))
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    print(f"# serve {label}: graph replay of one full predict_task batch "
          f"({len(got)} requests, {len(heads)} heads) vs the eager trunk and "
          f"tails: max |diff| {diff:.3e}, bit for bit {exact}")
    check(exact, f"{label}: replay differs from the eager run ({diff})")
    return run, got


def serve_task_phase(card: str, trunk, registry_dir: str,
                     heads: dict) -> dict:
    """`# serve base predict_task`: four servers over the base trunk of
    `finetune_phase` (bf16, buckets 128/256/512, max_batch 8): bucketed
    and ragged (8 segments a row), fp32 and int8 arms, each carrying the
    two frozen-trunk heads from the registry. Each answers 24
    predict_task requests (20-500 residues, the two heads mixed) from 4
    threads with every kernel count at 0, then drains. Gates: exactly 6
    launches of K1 (bucketed; ragged: #3; int8: #3-int8 ragged) and of K2
    (int8: K2-int8) per batch and none of the others; every answer finite
    and shaped by its head; on the fp32 bucketed arm each answer equals
    `heads/apply.predict_task_rows` run eagerly on the same card with the
    row alone in a batch of the served shape, bit for bit; one full
    predict_task batch replayed equals the eager trunk entry and tails
    bit for bit (`task_batch_equals_eager`); the int8 arm's answers lie
    off the fp32 arm's (> 0, printed); hot-adding a third head leaves
    `trunk_executable_count` flat; a removed head gives the typed
    `unknown_head` rejection; a head trained with an unfrozen trunk
    raises TrunkMismatchError; over HTTP (fp32 arms) `/v1/predict_task`
    equals in process bit for bit and `/v1/heads*` answer. Prints the
    per-batch wall and busy share of one full predict_task batch with two
    heads and the graph pool's bytes. Returns the launches."""
    import urllib.request

    from proteinbert_tpu_torch import inference
    from proteinbert_tpu_torch.configs import TaskConfig, get_preset
    from proteinbert_tpu_torch.data.vocab import ALPHABET
    from proteinbert_tpu_torch.heads import (
        HeadRegistry, TrunkMismatchError, UnknownHeadError,
        trunk_fingerprint,
    )
    from proteinbert_tpu_torch.heads import apply as heads_apply
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, KERNELS, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_Q8,
    )
    from proteinbert_tpu_torch.models import finetune as ft_model
    from proteinbert_tpu_torch.serve.http import make_http_server
    from proteinbert_tpu_torch.serve.server import Server

    base = get_preset("base")
    registry = HeadRegistry(registry_dir)
    served = [heads[("token_classification", True)],
              heads[("sequence_regression", True)]]
    fp = trunk_fingerprint(trunk, base.model.scan_blocks)
    third = TaskConfig(kind="sequence_classification", num_outputs=3,
                       freeze_trunk=True)
    third_id = registry.save(ft_model.head_init(
        torch.Generator().manual_seed(71), base.model, third, device="cpu"),
        third, fp, name="third")
    rnd = random.Random(5)
    reqs = [(served[i % 2], "".join(rnd.choice(ALPHABET)
                                    for _ in range(rnd.randint(20, 500))))
            for i in range(24)]
    totals = {}
    answers = {}
    for mode, quant, per_batch in (
            ("bucketed", "fp32", {LOCAL_TRACK.name: 6, ATTENTION.name: 6}),
            ("bucketed", "int8", {LOCAL_TRACK.name: 6,
                                  ATTENTION_Q8.name: 6}),
            ("ragged", "fp32", {LOCAL_TRACK_SEGMENTS.name: 6,
                                ATTENTION.name: 6}),
            ("ragged", "int8", {LOCAL_TRACK_SEGMENTS_Q8.name: 6,
                                ATTENTION_Q8.name: 6})):
        label = f"{mode} base predict_task{'' if quant == 'fp32' else ' int8'}"
        gc.collect()
        torch.cuda.synchronize()
        srv = Server(trunk, base, device=DEVICE, buckets=BUCKETS,
                     max_batch=8, max_wait_s=0.005, cache_size=0,
                     warm_kinds=(), serve_mode=mode, pack_max_segments=8,
                     quant=quant, quant_parity_every=0, registry=registry,
                     heads=served)
        check(srv.trunk_fp() == fp, f"{label}: trunk fingerprint")
        t0 = time.perf_counter()
        got = predict_task_traffic(srv, reqs)
        check(srv.drain(timeout=300), f"{label}: drain timed out")
        launches = {k.name: k.launches for k in KERNELS}
        pool = srv.dispatcher.graph_pool_bytes()
        n_trunk = srv.dispatcher.trunk_executable_count
        print(f"# serve {label}: warmup and {len(reqs)} requests in "
              f"{time.perf_counter() - t0:.2f} s; {n_trunk} trunk graphs "
              f"shared by {len(served)} heads, their pool holds {pool} bytes "
              f"({pool / 2**20:.2f} MiB); head tails warmed in "
              f"{srv.dispatcher.warmup_report['heads']} s [{card}]")
        batches = srv.stats()["batches"]
        for name, n in launches.items():
            want = per_batch.get(name, 0) * batches
            check(n == want, f"{label}: {name} launched {n} times for "
                             f"{batches} batches, want {want}")
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        for (hid, seq), out in zip(reqs, got):
            L = srv.dispatcher.bucket_len(len(seq))
            shape = (L, 8) if hid == served[0] else (1,)
            check(out.shape == shape and np.isfinite(out).all(),
                  f"{label}: answer {out.shape}, want {shape}")
        print(f"# serve {label}: {len(reqs)} requests over {len(served)} "
              f"heads in {batches} batches, launches {launches}")
        answers[(mode, quant)] = got
        if (mode, quant) == ("bucketed", "fp32"):
            by_id = {h: srv.dispatcher.get_head(h) for h in served}
            exact = True
            chunks = bucketed_batches(srv, reqs)
            for L, idx in chunks:
                toks = np.zeros((srv.dispatcher.batch_class(len(idx)), L),
                                np.int32)
                toks[:len(idx)] = inference._tokenize_masked(
                    [reqs[i][1] for i in idx], 512, "count")[:, :L]
                for row, i in enumerate(idx):
                    want = heads_apply.predict_task_rows(
                        srv.dispatcher.params, base.model,
                        by_id[reqs[i][0]], toks)[row]
                    exact &= np.array_equal(got[i], want)
            print(f"# serve {label}: each answer vs predict_task_rows run "
                  f"eagerly on the card on its batch ({len(chunks)} "
                  f"batches rebuilt): bit for bit {exact}")
            check(len(chunks) == batches and exact,
                  f"{label}: an answer differs from predict_task_rows")
        run, _ = task_batch_equals_eager(
            label, srv, [srv.dispatcher.get_head(h) for h in served])
        profile_batch(card, f"{label}, one full batch, {len(served)} heads",
                      run)
        del srv
        gc.collect()
        # Hot add, remove, a head of another trunk, on a live server.
        srv = Server(trunk, base, device=DEVICE, buckets=BUCKETS,
                     max_batch=8, max_wait_s=0.005, cache_size=0,
                     warm_kinds=(), serve_mode=mode, pack_max_segments=8,
                     quant=quant, quant_parity_every=0, registry=registry,
                     heads=served).start()
        n_trunk = srv.dispatcher.trunk_executable_count
        srv.add_head(third_id)
        out = srv.predict_task(third_id, reqs[0][1], timeout=120)
        check(out.shape == (3,) and srv.dispatcher.trunk_executable_count
              == n_trunk, f"{label}: hot add captured a trunk graph "
                          f"({srv.dispatcher.trunk_executable_count} vs "
                          f"{n_trunk})")
        srv.remove_head(third_id)
        try:
            srv.predict_task(third_id, reqs[0][1], timeout=120)
            check(False, f"{label}: a removed head answered")
        except UnknownHeadError:
            pass
        check(srv.stats()["rejected"]["unknown_head"] == 1,
              f"{label}: unknown_head rejections "
              f"{srv.stats()['rejected']}")
        try:
            srv.add_head(heads[("token_classification", False)])
            check(False, f"{label}: a head of another trunk was added")
        except TrunkMismatchError:
            pass
        print(f"# serve {label}: hot add of a third head kept "
              f"{n_trunk} trunk graphs; the removed head -> typed "
              f"unknown_head; a head fine-tuned with its trunk -> "
              f"TrunkMismatchError")
        if quant == "fp32":
            httpd = make_http_server(srv, host="127.0.0.1", port=0)
            thread = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            thread.start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                worst = 0.0
                for hid, seq in reqs[:2]:
                    status, body = http_post(f"{url}/v1/predict_task",
                                             {"head_id": hid, "seq": seq})
                    check(status == 200, f"{label}: HTTP {status} {body}")
                    want = srv.predict_task(hid, seq, timeout=120)
                    worst = max(worst, float(np.abs(np.asarray(
                        body["outputs"], np.float32) - want).max()))
                with urllib.request.urlopen(url + "/v1/heads",
                                            timeout=60) as r:
                    listed = json.loads(r.read())["heads"]
                added, _ = http_post(f"{url}/v1/heads/add",
                                     {"head_id": third_id})
                removed, _ = http_post(f"{url}/v1/heads/remove",
                                       {"head_id": third_id})
                gone, body = http_post(f"{url}/v1/predict_task",
                                       {"head_id": third_id, "seq": "MKT"})
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=60) as r:
                    health = json.loads(r.read())
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(30)
            print(f"# serve {label}: HTTP /v1/predict_task vs in process "
                  f"max |diff| {worst:.3e} (tol 0); /v1/heads lists "
                  f"{len(listed)}; add {added}, remove {removed}, then "
                  f"{gone} {body.get('type')}; /healthz fingerprint "
                  f"{health.get('trunk_fingerprint') == fp}")
            check(worst == 0.0 and listed == srv.list_heads()
                  and (added, removed, gone) == (200, 200, 404)
                  and body.get("type") == "unknown_head"
                  and health.get("trunk_fingerprint") == fp,
                  f"{label}: HTTP routes")
        check(srv.drain(timeout=300), f"{label}: drain timed out")
        del srv
    for mode in ("bucketed", "ragged"):
        diff = max(float(np.abs(a - b).max()) for a, b in zip(
            answers[(mode, "int8")], answers[(mode, "fp32")]))
        print(f"# serve {mode} base predict_task int8: max |int8 - fp32 arm| "
              f"over the {len(reqs)} answers {diff:.6e}")
        check(0 < diff < float("inf"), f"{mode}: the int8 arm answered as "
                                       "the fp32 arm (int8 weights unused?)")
    return totals


def task_phases(card: str) -> dict:
    """`finetune_phase`, then `serve_task_phase` on its trunk and heads
    (the registry in a temporary directory under build/, removed after);
    returns the launches of both."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="heads-", dir=build)
    try:
        launches, trunk, heads = finetune_phase(card, root)
        for name, n in serve_task_phase(card, trunk, root, heads).items():
            launches[name] = launches.get(name, 0) + n
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ------------------------------------------- corpus to a served neighbour

def map_corpus(n: int, num_annotations: int):
    """`n` proteins of `corpus_rows` (log-normal lengths, median 350: about
    a third longer than the 510-residue window, truncated and counted)
    with three poisoned records inserted — an empty one, a non-string and
    one with a control character — and their ids."""
    seqs, lengths, _ = corpus_rows(n, num_annotations, seed=14)
    seqs = list(seqs)
    for pos, bad in ((17, ""), (4100, 12345), (8000, "MKT\x01AVLV")):
        seqs.insert(pos, bad)
    ids = [f"UP{i:05d}" for i in range(len(seqs))]
    return ids, seqs, lengths


def map_profile(card: str, params, cfg, ids, seqs, root: str) -> float:
    """The device's busy share of a short map run (the first 512 records,
    one shard, the phase's settings) under torch.profiler: device busy
    seconds over the run's wall. Prints the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from proteinbert_tpu_torch.mapper import run_map

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run_map(params, cfg, ids[:512], seqs[:512],
                      os.path.join(root, "profiled"), num_shards=1,
                      block_size=256, rows_per_batch=8, max_segments=8,
                      buckets=BUCKETS, stop_flag=lambda: False,
                      device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + ms)
    busy = sum(t for _, t in by_name.values()) / 1e3
    if not by_name:
        print("# neighbors base map profile: the profiler recorded no "
              "device time (busy share not measured)")
        return float("nan")
    print(f"# neighbors base map profile [{card}]: {out['seqs']} sequences "
          f"in {out['batches']} batches, wall {wall:.3f} s (profiled), "
          f"device busy {busy:.3f} s, {100 * busy / wall:.1f}% of wall")
    for name, (n, t) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:8]:
        print(f"#   {t:9.3f} ms {100 * t / (busy * 1e3):5.1f}%  x{n:<5d} "
              f"{name[:80]}")
    return busy / wall


def map_phase(card: str, params, cfg, root: str) -> tuple:
    """`# neighbors base map`: `run_map` over 8192 proteins plus three
    poisoned records (`map_corpus`), `base` preset, buckets `BUCKETS`,
    rows_per_batch 8, max_segments 8, 2 shards of 256-record blocks.
    Gates: exactly 6 #3 + 6 K2 per packed batch and nothing else;
    `verify_store` ok and complete; a run stopped by `max_blocks` and
    resumed, and a run with `pipeline=False`, write stores equal to the
    uninterrupted one's byte for byte (`store_digests`); the poisoned
    records quarantined with their typed reasons. Returns (the store, the
    launches, the fp32 vectors in index order)."""
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, KERNELS, LOCAL_TRACK_SEGMENTS,
    )
    from proteinbert_tpu_torch.mapper import (
        ShardCursor, run_map, store_digests, verify_store,
    )

    ids, seqs, lengths = map_corpus(8192, cfg.model.num_annotations)
    kw = dict(num_shards=2, block_size=256, rows_per_batch=8,
              max_segments=8, buckets=BUCKETS, stop_flag=lambda: False,
              device=DEVICE)
    store = os.path.join(root, "store")
    # A short run first: it builds and loads #3 and K2 (the card's first
    # calls of them in this process may be a phase earlier) and settles
    # the allocator, so the timed run measures the map.
    run_map(params, cfg, ids[:64], seqs[:64], os.path.join(root, "warm"),
            **dict(kw, num_shards=1))
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    out = run_map(params, cfg, ids, seqs, store, **kw)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    batches = out["batches"]
    check(out["outcome"] == "completed", f"map: outcome {out['outcome']}")
    nb = cfg.model.num_blocks
    for name, n in launches.items():
        want = nb * batches if name in (LOCAL_TRACK_SEGMENTS.name,
                                        ATTENTION.name) else 0
        check(n == want, f"map: {name} launched {n} times for {batches} "
                         f"packed batches, want {want}")
    residues = int(np.minimum(lengths, cfg.data.seq_len - 2).sum())
    truncated = int((lengths > cfg.data.seq_len - 2).sum())
    print(f"# neighbors base map [{card}]: {out['seqs']} sequences "
          f"({residues} residues, {truncated} truncated at the "
          f"{cfg.data.seq_len - 2}-residue window) in {out['blocks']} blocks, "
          f"{batches} packed batches of 8 x {cfg.data.seq_len}, wall "
          f"{out['wall_s']} s: {out['seqs'] / out['wall_s']:.1f} sequences/s, "
          f"{residues / out['wall_s']:.0f} residues/s; commit_s "
          f"{out['commit_s']}, overlap_s {out['overlap_s']} (overlap_ratio "
          f"{out['overlap_ratio']}); launches {launches}")
    check(out["overlap_s"] > 0, "map: the pipelined run overlapped nothing")
    rep = verify_store(store)
    quarantine = {}
    for shard in range(2):
        quarantine.update({r["id"]: r["reason"] for r in
                           ShardCursor(store, shard).read_quarantine()})
    print(f"# neighbors base map: verify_store ok {rep['ok']}, complete "
          f"{rep['complete']}, embedded {rep['embedded']}, quarantined "
          f"{quarantine}")
    check(rep["ok"] and rep["complete"] and rep["embedded"] == 8192
          and rep["quarantined"] == 3, f"map: verify_store {rep}")
    check(quarantine == {"UP00017": "empty", "UP04100": "non_string",
                         "UP08000": "invalid_char"},
          f"map: quarantine {quarantine}")
    want = store_digests(store)
    resumed = os.path.join(root, "resumed")
    first = run_map(params, cfg, ids, seqs, resumed,
                    **dict(kw, max_blocks=5))
    second = run_map(params, cfg, ids, seqs, resumed, **kw)
    serial = os.path.join(root, "serial")
    off = run_map(params, cfg, ids, seqs, serial, **dict(kw, pipeline=False))
    same_resumed = store_digests(resumed) == want
    same_serial = store_digests(serial) == want
    print(f"# neighbors base map: stopped after {first['blocks']} blocks "
          f"({first['outcome']}), resumed ({second['outcome']}): store "
          f"digests equal the uninterrupted run's {same_resumed}; "
          f"pipeline=False ({off['outcome']}, wall {off['wall_s']} s, "
          f"overlap_s {off['overlap_s']}): equal {same_serial}")
    check(first["outcome"] == "preempted" and first["blocks"] == 5
          and second["outcome"] == "completed" and same_resumed,
          "map: the resumed store differs from the uninterrupted one")
    check(off["outcome"] == "completed" and same_serial
          and off["overlap_s"] == 0.0,
          "map: the pipeline-off store differs from the pipelined one")
    map_profile(card, params, cfg, ids, seqs, root)
    return store, launches


def index_phase(card: str, store: str, root: str):
    """`# neighbors base index`: `build_index` with its defaults (64
    centroids, 256-vector blocks, seed 0) timed on the host; gates:
    `verify_index` ok, bytes ratio <= 0.30, recall@10 at nprobe 64 (a
    full probe) >= 0.95 against float32 `exact_topk`; records recall@10
    at nprobe 8, the lookup's ms at Q=1 and lookups/s at Q=64 (nprobe 8
    and 64). Returns the index loaded on the card."""
    from proteinbert_tpu_torch.index import build_index, verify_index
    from proteinbert_tpu_torch.index.scorer import (
        NeighborIndex, exact_topk, recall_at_k, store_vectors_in_index_order,
    )

    index_dir = os.path.join(root, "index")
    t0 = time.perf_counter()
    stats = build_index(store, index_dir)
    build_s = time.perf_counter() - t0
    rep = verify_index(index_dir)
    index = NeighborIndex.load(index_dir, device=DEVICE)
    vectors = store_vectors_in_index_order(store)
    lists = np.bincount(index.assign, minlength=index.centroids.shape[0])
    print(f"# neighbors base index [{card}]: build_index {build_s:.2f} s on "
          f"the host ({stats['vectors']} vectors, {stats['blocks']} blocks, "
          f"{index.centroids.shape[0]} centroids, lists {int(lists.min())}-"
          f"{int(lists.max())}), bytes_ratio {stats['bytes_ratio']:.4f}, "
          f"verify_index ok {rep['ok']}; resident on the card "
          f"{index.resident_bytes()} bytes")
    check(rep["ok"], f"index: verify_index {rep}")
    check(stats["bytes_ratio"] <= 0.30,
          f"index: bytes ratio {stats['bytes_ratio']} > 0.30")
    queries = vectors[::32]
    exact = exact_topk(vectors, queries, k=10)
    # Chunks of 8 queries: a full probe gathers every vector per query.
    recall = {}
    for nprobe in (64, 8):
        rows = np.concatenate([index.lookup_rows(queries[i:i + 8], k=10,
                                                 nprobe=nprobe)[1]
                               for i in range(0, len(queries), 8)])
        recall[nprobe] = recall_at_k(rows, exact)
    print(f"# neighbors base index: recall@10 over {len(queries)} queries "
          f"against float32 exact_topk: nprobe 64 (full probe) "
          f"{recall[64]:.4f}, nprobe 8 {recall[8]:.4f}")
    check(recall[64] >= 0.95, f"index: recall@10 at a full probe "
                              f"{recall[64]} < 0.95")
    q1 = vectors[:1]
    t = []
    for _ in range(50):
        t0 = time.perf_counter()
        index.lookup_rows(q1, k=10, nprobe=8)
        t.append((time.perf_counter() - t0) * 1e3)
    line = (f"# neighbors base lookup [{card}]: Q=1 k=10 nprobe 8 "
            f"{statistics.median(t):.3f} ms (median of 50, host wall "
            f"through the answer on the host)")
    q64 = vectors[:64]
    width = index.members.shape[1]
    for nprobe in (8, 64):
        need = 64 * min(nprobe, len(lists)) * width * index.dim * 5
        if need > 24e9:
            # The JAX lookup's gather of every candidate's residual.
            line += (f"; Q=64 nprobe {nprobe} not measured (its gather "
                     f"needs {need / 1e9:.1f} GB)")
            continue
        index.lookup_rows(q64, k=10, nprobe=nprobe)
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            index.lookup_rows(q64, k=10, nprobe=nprobe)
            t.append(time.perf_counter() - t0)
        line += (f"; Q=64 nprobe {nprobe} {64 / statistics.median(t):.0f} "
                 f"lookups/s ({statistics.median(t) * 1e3:.2f} ms a call)")
    print(line)
    return index


def served_neighbors_phase(card: str, params, cfg, index, other,
                           root: str) -> dict:
    """`# neighbors base served`: `Server(index=, nprobe=8)` bucketed and
    ragged on the fp32 arm, telemetry on. 64 `neighbors` requests for
    corpus sequences and the same 64 as `embed` requests are submitted
    before `start()` with every kernel count at 0, so the neighbours and
    the embeds form the same batches. Gates: each served answer equals
    `lookup_one` over that request's own served embed vector, bit for
    bit; the graphs and their pool equal those of the same server without
    an index; the launches are exactly those of the embed batches (6 K1
    or #3 + 6 K2 a batch); `stats()["neighbors"]` counts each outcome;
    HTTP `/v1/neighbors` gives the in-process answer and an invalid `k`
    400; a server whose trunk differs (`other`) raises TrunkMismatchError;
    one without an index, ValueError. Records the neighbours' wall, p50
    and p99 split by trace stage into the embed leg and `lookup`. Returns
    the launches."""
    from proteinbert_tpu_torch import obs
    from proteinbert_tpu_torch.heads import TrunkMismatchError
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, KERNELS, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
    )
    from proteinbert_tpu_torch.serve.http import make_http_server
    from proteinbert_tpu_torch.serve.server import Server

    seqs, _, _ = corpus_rows(64, cfg.model.num_annotations, seed=15)
    totals = {}
    kw = dict(device=DEVICE, buckets=BUCKETS, max_batch=8, max_wait_s=0.005,
              queue_depth=256, cache_size=0, warm_kinds=("embed",),
              pack_max_segments=8)
    nb = cfg.model.num_blocks
    for mode, per_batch in (("bucketed", {LOCAL_TRACK.name: nb,
                                          ATTENTION.name: nb}),
                            ("ragged", {LOCAL_TRACK_SEGMENTS.name: nb,
                                        ATTENTION.name: nb})):
        label = f"{mode} base neighbors"
        gc.collect()
        plain = Server(params, cfg, serve_mode=mode, **kw).start()
        torch.cuda.synchronize()
        want_graphs = plain.dispatcher.executable_count
        want_pool = plain.dispatcher.graph_pool_bytes()
        plain.drain(timeout=300)
        try:
            plain.submit("neighbors", seqs[0])
            check(False, f"{label}: a server without an index answered")
        except ValueError:
            pass
        del plain
        gc.collect()
        events = os.path.join(root, f"events-{mode}.jsonl")
        tele = obs.Telemetry(events_path=events)
        srv = Server(params, cfg, serve_mode=mode, index=index, nprobe=8,
                     telemetry=tele, trace_sample_rate=1.0, **kw)
        srv.dispatcher.warmup(("embed",))
        torch.cuda.synchronize()
        graphs = srv.dispatcher.executable_count
        pool = srv.dispatcher.graph_pool_bytes()
        for k in KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        nf = [srv.submit("neighbors", s) for s in seqs]
        ef = [srv.submit("embed", s) for s in seqs]
        srv.start()
        got = [f.result(timeout=300) for f in nf]
        embeds = [f.result(timeout=300) for f in ef]
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in KERNELS}
        batches = settled_batches(srv)
        stats = srv.stats()
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
            want = per_batch.get(name, 0) * batches
            check(n == want, f"{label}: {name} launched {n} times for "
                             f"{batches} batches, want {want}")
        check(srv.dispatcher.executable_count == graphs == want_graphs
              and pool == want_pool
              and srv.dispatcher.graph_pool_bytes() == pool,
              f"{label}: graphs {graphs} / {want_graphs}, pool {pool} / "
              f"{want_pool}")
        exact = all(g["neighbors"] == index.lookup_one(e["global"], k=10,
                                                        nprobe=8)
                    for g, e in zip(got, embeds))
        sizes = {len(g["neighbors"]) for g in got}
        print(f"# serve {label} [{card}]: 64 neighbors + 64 embed requests "
              f"in {batches} batches, {wall:.3f} s; launches {launches}; "
              f"{graphs} CUDA graphs, pool {pool} bytes (without an index: "
              f"{want_graphs}, {want_pool}); each answer vs lookup_one over "
              f"its own served embed vector: bit for bit {exact}; answer "
              f"sizes {sorted(sizes)}")
        check(exact and sizes == {10}, f"{label}: a served answer differs "
                                       "from the offline lookup")
        by = stats["neighbors"]["by_outcome"]
        check(by["ok"] == 64 and sum(by.values()) == 64,
              f"{label}: by_outcome {by}")
        httpd = make_http_server(srv, host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/neighbors"
        try:
            status, body = http_post(url, {"seq": seqs[3], "k": 5})
            want = srv.neighbors(seqs[3], k=5, timeout=120)
            bad, bad_body = http_post(url, {"seq": seqs[3], "k": 0})
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(30)
        same = status == 200 and body["neighbors"] == [
            [i, s] for i, s in want["neighbors"]]
        by = srv.stats()["neighbors"]["by_outcome"]
        print(f"# serve {label}: HTTP /v1/neighbors {status}, equals in "
              f"process {same}; k=0 {bad} {bad_body.get('type')}; "
              f"by_outcome {by}")
        check(same and bad == 400 and by["ok"] == 66
              and sum(by.values()) == 66, f"{label}: HTTP or the funnel")
        check(srv.drain(timeout=300), f"{label}: drain timed out")
        tele.close()
        recs = [r for r in obs.read_events(events, strict=True)
                if r["event"] == "serve_request"
                and r.get("kind") == "neighbors"]
        e2e = sorted(r["e2e_s"] for r in recs)
        lookup = sorted(r["stages"].get("lookup", 0.0) for r in recs)
        embed_leg = sorted(r["e2e_s"] - r["stages"].get("lookup", 0.0)
                           - r["stages"].get("finalize", 0.0) for r in recs)

        def pct(xs, q):
            return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] * 1e3

        print(f"# serve {label} [{card}]: {len(recs)} traced neighbours: "
              f"e2e p50 {pct(e2e, .5):.3f} / p99 {pct(e2e, .99):.3f} ms = "
              f"embed leg p50 {pct(embed_leg, .5):.3f} / p99 "
              f"{pct(embed_leg, .99):.3f} ms + lookup p50 "
              f"{pct(lookup, .5):.3f} / p99 {pct(lookup, .99):.3f} ms (+ "
              f"finalize); wall {wall:.3f} s for 128 requests submitted "
              "before start()")
        check(len(recs) == 66 and all("lookup" in r["stages"]
                                      for r in recs),
              f"{label}: {len(recs)} traced neighbours with a lookup stage")
        del srv
    try:
        Server(other, cfg, serve_mode="ragged", index=index, **kw)
        check(False, "a server of another trunk took the index")
    except TrunkMismatchError:
        pass
    print("# serve base neighbors: a server of another trunk -> "
          "TrunkMismatchError; without an index -> ValueError")
    return totals


def neighbors_phase(card: str) -> dict:
    """`# neighbors base`: the `base` trunk in bf16 (random weights from a
    seeded generator) maps a corpus into a store (`map_phase`), the store
    gets its int8 IVF index (`index_phase`), and servers answer
    neighbours from it (`served_neighbors_phase`). The stores and the
    index go to a temporary directory under build/, removed after.
    Returns the launches."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.models.proteinbert import init

    base = get_preset("base")
    params = init(base.model, torch.Generator().manual_seed(14),
                  device=DEVICE)
    other = init(base.model, torch.Generator().manual_seed(15),
                 device=DEVICE)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="neighbors-", dir=build)
    try:
        store, launches = map_phase(card, params, base, root)
        index = index_phase(card, store, root)
        for name, n in served_neighbors_phase(card, params, base, index,
                                              other, root).items():
            launches[name] = launches.get(name, 0) + n
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def large_int8_phase(card: str) -> dict:
    """`# serve large int8`: the `large` preset (12 blocks, C=G=1024,
    H=16, 8943 annotations) in bf16, random weights, served bucketed and
    ragged on the fp32 and the int8 arm: buckets 256 / 512 / 1024, one
    batch class (max_batch 8), 8 segments a packed row; 16 embed requests
    of 100-1000 residues submitted before `start()` with every count at
    0. Gates: exactly 12 #2 (bucketed; ragged #4) and 12 K2 (int8:
    K2-int8) per batch, none of the others — on the int8 arm #2 / #4 run
    on track weights dequantized inside the graph and K2-int8 at H=16,
    G=1024; one full batch replayed equals its eager run bit for bit;
    the int8 answers lie off the fp32 ones by a finite, nonzero amount
    (printed). Records `weight_bytes_ratio`, the graph pool's bytes and a
    full batch's wall and busy share. Returns the launches."""
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.data.vocab import ALPHABET
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, KERNELS, LOCAL_TRACK_SEGMENTS_TILED,
        LOCAL_TRACK_TILED,
    )
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.server import Server

    large = get_preset("large")
    params = init(large.model, torch.Generator().manual_seed(16),
                  device=DEVICE)
    rnd = random.Random(16)
    seqs = ["".join(rnd.choice(ALPHABET) for _ in range(rnd.randint(100,
                                                                   1000)))
            for _ in range(16)]
    rng = np.random.default_rng(16)
    tokens = rng.integers(4, 26, (8, 1024)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 1, 2
    totals, answers = {}, {}
    for mode, track in (("bucketed", LOCAL_TRACK_TILED),
                        ("ragged", LOCAL_TRACK_SEGMENTS_TILED)):
        for quant, attn in (("fp32", ATTENTION), ("int8", ATTENTION_Q8)):
            label = f"{mode} large{'' if quant == 'fp32' else ' int8'}"
            gc.collect()
            torch.cuda.synchronize()
            srv = Server(params, large, device=DEVICE,
                         buckets=(256, 512, 1024), max_batch=8,
                         batch_classes=((8,) if mode == "bucketed"
                                        else None),
                         max_wait_s=0.005, cache_size=0,
                         warm_kinds=("embed",), serve_mode=mode,
                         pack_max_segments=8, quant=quant,
                         quant_parity_every=0)
            t0 = time.perf_counter()
            srv.dispatcher.warmup(("embed",))
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            pool = srv.dispatcher.graph_pool_bytes()
            for k in KERNELS:
                k.launches = 0
            futures = [srv.submit("embed", s) for s in seqs]
            srv.start()
            got = [f.result(timeout=300) for f in futures]
            check(srv.drain(timeout=300), f"{label}: drain timed out")
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in KERNELS}
            batches = srv.stats()["batches"]
            for name, n in launches.items():
                totals[name] = totals.get(name, 0) + n
                want = (large.model.num_blocks * batches
                        if name in (track.name, attn.name) else 0)
                check(n == want, f"{label}: {name} launched {n} times for "
                                 f"{batches} batches, want {want}")
            check(all(np.isfinite(g["global"]).all()
                      and np.isfinite(g["local_mean"]).all() for g in got),
                  f"{label}: non-finite embeddings")
            answers[(mode, quant)] = got
            report = srv.stats()["quant"]
            ratio = (f"weight_bytes_ratio {report['weight_bytes_ratio']}"
                     if report else "fp32 arm")
            print(f"# serve {label} [{card}]: {ratio}; "
                  f"{srv.dispatcher.executable_count} CUDA graphs captured "
                  f"in {warm_s:.2f} s, their pool holds {pool} bytes "
                  f"({pool / 2**20:.2f} MiB); {len(seqs)} requests in "
                  f"{batches} batches, launches {launches}")
            if mode == "bucketed":
                batch = tokens
                run = lambda: srv.dispatcher.run("embed", tokens)  # noqa
                what = "one embed batch 8x1024"
            else:
                batch = full_ragged_batch(srv)
                run = lambda: srv.dispatcher.run_packed(  # noqa
                    "embed", *batch)
                what = "one packed embed batch 8x1024 (24 segments)"
            replay_equals_eager(label, srv, batch)
            profile_batch(card, f"{label}, {what}", run)
            del srv
    for mode in ("bucketed", "ragged"):
        diff = max(float(np.abs(a[key] - b[key]).max())
                   for a, b in zip(answers[(mode, "int8")],
                                   answers[(mode, "fp32")])
                   for key in ("global", "local_mean"))
        print(f"# serve {mode} large int8: max |int8 - fp32 arm| over the "
              f"{len(seqs)} embeddings {diff:.6e}")
        check(0 < diff < float("inf"), f"{mode} large: the int8 arm "
                                       "answered as the fp32 arm")
    return totals


def perturbed(params, scale: float, seed: int, keep_bf16: bool = False):
    """A copy of `params` with every float leaf plus scale x its own RMS x
    seeded N(0, 1) noise (scale 0: a plain copy). With `keep_bf16` only leaves of two or more dims
    move, and only where the move leaves the value's bf16 rounding as it
    was: a trunk that differs from `params` in float32 but not at the
    precision a bf16 server computes in."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def leaf(t):
        if (scale == 0 or not t.is_floating_point()
                or (keep_bf16 and t.dim() < 2)):
            return t.clone()
        rms = t.float().pow(2).mean().sqrt()
        w = t + scale * rms * torch.randn(t.shape, generator=gen,
                                          device=t.device, dtype=t.dtype)
        if keep_bf16:
            w = torch.where(w.to(torch.bfloat16) == t.to(torch.bfloat16),
                            w, t)
        return w

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return leaf(x)

    return walk(params)


def rollout_seqs(n: int, seed: int) -> list:
    """`n` distinct proteins of 20-500 residues."""
    from proteinbert_tpu_torch.data.vocab import ALPHABET

    rnd = random.Random(seed)
    return ["".join(rnd.choice(ALPHABET)
                    for _ in range(rnd.randint(20, 500))) for _ in range(n)]


def embeds_equal(a: dict, b: dict) -> bool:
    """Two embed answers bit for bit (a JSON answer's floats are exact
    copies of the float32 values)."""
    return all(np.array_equal(np.asarray(a[k], np.float32),
                              np.asarray(b[k], np.float32))
               for k in ("global", "local_mean"))


def embed_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[k], np.float32)
                            - np.asarray(b[k], np.float32)).max())
               for k in ("global", "local_mean"))


def pct_ms(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] * 1e3


def settled_batches(srv, timeout_s: float = 30.0) -> int:
    """A server's sealed batches, read once every request it has answered
    is in the count. The completer answers a batch's requests first and
    counts the batch after them, so a read right after the last answer
    can miss that batch; `batched_rows` catches up with `completed` when
    the count is whole."""
    t_end = time.perf_counter() + timeout_s
    while True:
        st = srv.stats()
        if st["batched_rows"] == st["completed"]:
            return st["batches"]
        check(time.perf_counter() < t_end,
              f"batched rows {st['batched_rows']} never reached the "
              f"{st['completed']} completed requests")
        time.sleep(0.002)


class LaunchTally:
    """Every kernel's launches since the last `take()`, which zeroes the
    counts and adds them to `totals`."""

    def __init__(self):
        from proteinbert_tpu_torch.kernels import KERNELS

        self.kernels = KERNELS
        self.totals = {}
        self.take()

    def take(self) -> dict:
        got = {}
        for k in self.kernels:
            got[k.name] = k.launches
            self.totals[k.name] = self.totals.get(k.name, 0) + k.launches
            k.launches = 0
        return got

    def expect(self, label: str, got: dict, want: dict) -> None:
        for name, n in got.items():
            check(n == want.get(name, 0),
                  f"{label}: {name} launched {n} times, want "
                  f"{want.get(name, 0)}")


def flat_state(srv) -> tuple:
    """(graphs, their pool's bytes) of a server's dispatcher."""
    torch.cuda.synchronize()
    return srv.dispatcher.executable_count, srv.dispatcher.graph_pool_bytes()


def graph_read_ptrs(srv) -> list:
    """The addresses of every tensor a server's graphs read: the fp32
    arm's params, the int8 arm's quantized tree."""
    disp = srv.dispatcher
    return [t.data_ptr() for t in tree_tensors(
        disp.qparams if disp.quant != "fp32" else disp.params)]


def arm_gates(card: str, label: str, srv, cand, probes, per_request: dict,
              tally: "LaunchTally") -> dict:
    """One server's candidate arm (`cand`, far from its trunk, so the two
    answer differently): a lone live request and a shadow launch exactly
    `per_request`; graphs, pool and the graph-read addresses stay as they
    were across load, warm, shadows, flip and rollback; each probe's
    shadow equals its lone live request after the flip bit for bit, and
    after the rollback its pre-flip answer; the flip drops the whole
    cache and the probes asked before it are computed again. Returns the
    numbers PERF.md records."""
    flat0, ptrs0 = flat_state(srv), graph_read_ptrs(srv)
    pre = [srv.embed(p, timeout=120) for p in probes]
    extra = rollout_seqs(1, seed=29)[0]
    tally.take()
    srv.embed(extra, timeout=120)
    live = tally.take()
    tally.expect(f"{label}: a lone live request", live, per_request)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    report = srv.load_candidate(params=cand)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    check(flat_state(srv) == flat0, f"{label}: load_candidate moved the "
                                    f"graphs or pool {flat_state(srv)}")
    tally.take()
    srv.shadow_submit("embed", extra)
    shadow = tally.take()
    tally.expect(f"{label}: a shadow request", shadow, per_request)
    shadows, walls = [], []
    for p in probes:
        t0 = time.perf_counter()
        shadows.append(srv.shadow_submit("embed", p))
        walls.append(time.perf_counter() - t0)
    check(flat_state(srv) == flat0, f"{label}: shadows moved the graphs")
    size = srv.cache.stats()["size"]
    hits = srv.stats()["cache_hit_returns"]
    flip = srv.flip()
    torch.cuda.synchronize()
    mem2 = torch.cuda.memory_allocated()
    check(flip["cache_dropped"] == size >= len(probes),
          f"{label}: flip dropped {flip['cache_dropped']} of {size} cached")
    check(graph_read_ptrs(srv) == ptrs0, f"{label}: flip moved a tensor "
                                         "the graphs read")
    check(flat_state(srv) == flat0, f"{label}: flip moved the graphs")
    post = [srv.embed(p, timeout=120) for p in probes]
    check(srv.stats()["cache_hit_returns"] == hits,
          f"{label}: a probe asked before the flip hit the cache after it")
    same = all(embeds_equal(a, b) for a, b in zip(post, shadows))
    moved = min(embed_diff(a, b) for a, b in zip(post, pre))
    check(same and moved > 0, f"{label}: post-flip live != shadow "
                              f"({same}) or = pre-flip ({moved})")
    back_report = srv.rollback_trunk()
    check(graph_read_ptrs(srv) == ptrs0, f"{label}: rollback moved a "
                                         "tensor the graphs read")
    check(flat_state(srv) == flat0, f"{label}: rollback moved the graphs")
    back = [srv.embed(p, timeout=120) for p in probes]
    restored = all(embeds_equal(a, b) for a, b in zip(back, pre))
    check(restored, f"{label}: rollback answers differ from pre-flip")
    check(srv.unload_candidate(), f"{label}: no demoted trunk to unload")
    torch.cuda.synchronize()
    mem3 = torch.cuda.memory_allocated()
    check(mem2 <= mem1 - report["weight_bytes_candidate"] * 0.9,
          f"{label}: flip kept the candidate's memory ({mem1} -> {mem2})")
    tally.take()
    print(f"# rollout base {label} [{card}]: load_candidate {load_s:.3f} s "
          f"(warm_candidate {report['warm_seconds']:.3f} s, eager at "
          f"{flat0[0]} warm shapes), flip {flip['seconds']:.4f} s (park + "
          f"copy), rollback {back_report['seconds']:.4f} s; weight bytes "
          f"resident {report['weight_bytes_resident']} candidate "
          f"{report['weight_bytes_candidate']} (budget "
          f"{report['hbm_budget_bytes']}); device memory before load "
          f"{mem0}, loaded {mem1}, flipped {mem2}, unloaded {mem3}")
    print(f"# rollout base {label}: graphs {flat0[0]}, pool {flat0[1]} "
          f"bytes, unchanged across load, warm, {len(probes) + 1} shadows, "
          f"flip and rollback; graph-read addresses unchanged; a lone live "
          f"request {live}, a shadow {shadow}; shadow = post-flip live bit "
          f"for bit {same} (probes moved by up to {moved:.4g} and more); "
          f"rollback = pre-flip bit for bit {restored}; flip dropped "
          f"{flip['cache_dropped']} cached answers; shadow wall p50 "
          f"{pct_ms(walls, 0.5):.3f} ms")
    return {"load_s": load_s, "flip_s": flip["seconds"],
            "rollback_s": back_report["seconds"], "pre": pre}


def serve_events(path: str) -> list:
    from proteinbert_tpu_torch import obs

    return [r for r in obs.read_events(path)
            if r["event"] == "serve_request"]


def drive(router, seqs, latencies=None) -> None:
    """Send `seqs` through the router one after another, each a 200."""
    for s in seqs:
        t0 = time.perf_counter()
        status, body, headers = router.route(
            "/v1/embed", json.dumps({"seq": s}).encode())
        if latencies is not None:
            latencies.append((time.perf_counter() - t0,
                              headers.get("X-PBT-Fleet-Request-Id")))
        check(status == 200, f"a routed request answered {status}: "
                              f"{body[:200]!r}")


def drive_until_terminal(router, ctl, seq_iter, latencies, timeout_s=300):
    t_end = time.perf_counter() + timeout_s
    while not ctl.terminal() and time.perf_counter() < t_end:
        drive(router, [next(seq_iter)], latencies)
    check(ctl.terminal(), f"rollout still {ctl.state} after {timeout_s} s")
    ctl._worker.join(30)
    check(not ctl._worker.is_alive(), "the shadow worker did not stop")


def hop_ms(latencies, events) -> tuple:
    """p50 of the router's e2e minus the replica's (joined by trace id)."""
    e2e = {r.get("trace_id"): r["e2e_s"] for r in events}
    hops = [wall - e2e[rid] for wall, rid in latencies if rid in e2e]
    return pct_ms(hops, 0.5), len(hops)


def torn_batch_gate(card: str, router, reps: dict, tally, per_batch: dict):
    """256 routed requests from 128 threads (two each); once 64 are
    answered both replicas flip to the far candidate while about half are
    queued or in flight. Every answer is a 200 and equals, bit for bit,
    the old or the new trunk's answer for its sequence at its own bucket
    and batch class (from the replica's `serve_request` event); per
    replica no old answer is sealed after the first new one. Then the
    fleet rolls back through the router and unloads. Launches: exactly
    per_batch a live batch."""
    from proteinbert_tpu_torch import inference

    seqs = rollout_seqs(256, seed=31)
    batches0 = {n: settled_batches(r["srv"]) for n, r in reps.items()}
    tally.take()
    results = [None] * len(seqs)
    answered = [0]
    lock = threading.Lock()
    half = threading.Event()

    def client(i):
        for j in (i, i + 128):
            results[j] = router.route(
                "/v1/embed", json.dumps({"seq": seqs[j]}).encode())
            with lock:
                answered[0] += 1
                if answered[0] == 64:
                    half.set()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(128)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    check(half.wait(300), "64 routed requests never came back")
    with lock:
        at_flip = answered[0]
    flips = {}
    for name in reps:
        status, body = router.control_forward(name, "/v1/rollout/flip")
        check(status == 200, f"flip of {name}: {status} {body[:200]!r}")
        flips[name] = json.loads(body)["seconds"]
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "router clients hung")
    launches = tally.take()
    batches = sum(settled_batches(r["srv"]) - batches0[n]
                  for n, r in reps.items())
    tally.expect("torn-batch traffic", launches,
                 {k: v * batches for k, v in per_batch.items()})
    check(all(r[0] == 200 for r in results),
          f"failed: {[r[0] for r in results if r[0] != 200]}")
    ids = {r[2]["X-PBT-Fleet-Request-Id"]: i for i, r in enumerate(results)}
    where = {}
    t_end = time.perf_counter() + 60
    while len(where) < len(ids) and time.perf_counter() < t_end:
        for name, rep in reps.items():
            for rec in serve_events(rep["events"]):
                i = ids.get(rec.get("trace_id"))
                if i is not None:
                    where[i] = (name, rec["seq"], rec["bucket_len"],
                                rec["batch_class"])
        time.sleep(0.05)
    check(len(where) == len(ids), f"{len(where)} of {len(ids)} requests "
                                  "found in the replicas' events")

    def references():
        refs = {}
        groups = {}
        for i, (name, _, L, cls) in where.items():
            groups.setdefault((name, L, cls), []).append(i)
        for (name, L, cls), idx in groups.items():
            disp = reps[name]["srv"].dispatcher
            for lo in range(0, len(idx), cls):
                chunk = idx[lo:lo + cls]
                rows = chunk + [chunk[0]] * (cls - len(chunk))
                toks = inference._tokenize_masked(
                    [seqs[i] for i in rows], disp.cfg.data.seq_len,
                    "count")[:, :L]
                out = disp.run("embed", toks)
                for r, i in enumerate(chunk):
                    refs[i] = {k: v[r] for k, v in out.items()}
        return refs

    new = references()
    for name in reps:
        status, body = router.control_forward(name, "/v1/rollout/rollback")
        check(status == 200, f"rollback of {name}: {status}")
    old = references()
    state = {}
    for i, (_, body, _) in enumerate(results):
        ans = json.loads(body)
        is_old, is_new = embeds_equal(ans, old[i]), embeds_equal(ans, new[i])
        check(is_old or is_new, f"request {i} is a torn batch: it equals "
                                "neither trunk's answer")
        check(not (is_old and is_new), f"request {i}: the trunks agree")
        state[i] = "new" if is_new else "old"
    counts = {}
    for name in reps:
        order = sorted((where[i][1], state[i]) for i in where
                       if where[i][0] == name)
        seen_new = False
        for _, s in order:
            check(not (seen_new and s == "old"),
                  f"{name}: an old answer sealed after a new one")
            seen_new = seen_new or s == "new"
        counts[name] = {s: sum(1 for _, x in order if x == s)
                        for s in ("old", "new")}
    for name in reps:
        status, body = router.control_forward(name, "/v1/rollout/unload")
        check(status == 200 and json.loads(body)["unloaded"],
              f"unload of {name}: {status}")
    classes = sorted({w[3] for w in where.values()})
    print(f"# rollout base torn [{card}]: 256 routed requests (128 "
          f"threads) in {wall:.3f} s over {batches} batches (classes "
          f"{classes}); flips issued after {at_flip} answers, "
          f"{ {n: round(s, 4) for n, s in flips.items()} } s; none failed; "
          f"old / new answers by replica {counts}, each bit for bit one "
          f"trunk's at its bucket and batch class, none old after a new; "
          f"launches {launches}")


def rollout_phase(card: str) -> dict:
    """`# rollout base`: the blue-green rollout of the `base` trunk (bf16)
    across a fleet on one card. Replicas r0 and r1 (bucketed, buckets 128
    / 256 / 512, max_batch 8, pipeline_depth 2, embed graphs warmed) each
    behind `serve/http.make_http_server` on 127.0.0.1, a port
    `FleetRouter` over both; a ragged and an int8 bucketed server in
    process. Candidates: `near` (the trunk + 1e-6 x each leaf's RMS x
    seeded noise, kept only where a bf16 server cannot see it: the
    controller's default parity bound, 1e-3, is far under one bf16 step
    of an answer) and `far` (1e-1). Gates: `arm_gates` on r0, the ragged
    and the int8 server; the typed refusals; `torn_batch_gate`; the
    controller green on `near` (promotes; both /healthz show its
    fingerprint), `breach()` back to the pre-flip answers bit for bit,
    and red on `far` (refused, unloaded everywhere, answers unchanged);
    exact launches at each step; flat graphs on r0 and r1 throughout;
    every event stream strict. Returns the launches."""
    import urllib.request

    from proteinbert_tpu_torch import obs
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.heads.registry import trunk_fingerprint
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
    )
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.parallel.quant import param_bytes
    from proteinbert_tpu_torch.rollout import RolloutController
    from proteinbert_tpu_torch.serve.errors import (
        CandidateUnfitError, NoCandidateError,
    )
    from proteinbert_tpu_torch.serve.fleet import FleetRouter
    from proteinbert_tpu_torch.serve.http import make_http_server
    from proteinbert_tpu_torch.serve.server import Server

    base = get_preset("base")
    nb = base.model.num_blocks
    params = init(base.model, torch.Generator().manual_seed(16),
                  device=DEVICE)

    def own():
        return perturbed(params, 0.0, 0)

    near = perturbed(params, ROLLOUT_NEAR, 17, keep_bf16=True)
    literal = perturbed(params, ROLLOUT_NEAR, 17)
    far = perturbed(params, ROLLOUT_FAR, 18)
    fp = {name: trunk_fingerprint(t, base.model.scan_blocks) for name, t in
          (("resident", params), ("near", near), ("far", far))}
    check(len(set(fp.values())) == 3, "the candidates' fingerprints agree")
    loader = {"near": near, "far": far}.__getitem__
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="rollout-", dir=build)
    tally = LaunchTally()
    dense = {LOCAL_TRACK.name: nb, ATTENTION.name: nb}
    kw = dict(device=DEVICE, buckets=BUCKETS, max_batch=8, max_wait_s=0.005,
              queue_depth=512, cache_size=256, warm_kinds=("embed",),
              pipeline_depth=2, trace_sample_rate=1.0,
              candidate_loader=loader)
    probes = rollout_seqs(8, seed=23)
    teles, httpds, reps = {}, [], {}
    try:
        for name in ("r0", "r1"):
            events = os.path.join(root, f"{name}.jsonl")
            teles[name] = obs.Telemetry(events_path=events)
            srv = Server(own(), base, telemetry=teles[name],
                         replica_id=name, **kw).start()
            httpd = make_http_server(srv, host="127.0.0.1", port=0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            httpds.append(httpd)
            reps[name] = {"srv": srv, "events": events,
                          "url": f"http://127.0.0.1:"
                                 f"{httpd.server_address[1]}"}
        flat = {n: flat_state(r["srv"]) for n, r in reps.items()}
        r0 = reps["r0"]["srv"]

        # The resident trunk shadowing itself, and the literal 1e-6
        # candidate: what the parity gate sees at bf16.
        own_params = own()
        r0.load_candidate(params=own_params)
        self_par = max(embed_diff(r0.shadow_submit("embed", p),
                                  r0.embed(p, timeout=120))
                       for p in probes)
        r0.unload_candidate()
        parities = {}
        for name, cand in (("literal 1e-6", literal), ("near", near)):
            r0.load_candidate(params=cand)
            parities[name] = max(embed_diff(r0.shadow_submit("embed", p),
                                            r0.embed(p, timeout=120))
                                 for p in probes)
            r0.unload_candidate()
        del own_params, literal
        print(f"# rollout base parity [{card}]: shadow vs live over "
              f"{len(probes)} probes at bf16: the resident trunk against "
              f"itself {self_par}, the trunk + 1e-6 x RMS noise on every "
              f"leaf {parities['literal 1e-6']}, `near` (that noise where "
              f"bf16 cannot see it) {parities['near']}; the controller's "
              "bound 1e-3")
        check(self_par == 0.0, "the resident trunk's shadow differs from "
                               "its live answer")

        # Each mode's arm.
        arms = {"fp32 bucketed": arm_gates(card, "fp32 bucketed", r0, far,
                                          probes, dense, tally)}
        for label, extra, per_request in (
                ("ragged", dict(serve_mode="ragged", pack_max_segments=8),
                 {LOCAL_TRACK_SEGMENTS.name: nb, ATTENTION.name: nb}),
                ("int8 bucketed", dict(quant="int8", quant_parity_every=0),
                 {LOCAL_TRACK.name: nb, ATTENTION_Q8.name: nb})):
            events = os.path.join(root, f"{label.replace(' ', '-')}.jsonl")
            teles[label] = obs.Telemetry(events_path=events)
            srv = Server(own(), base, telemetry=teles[label], **kw,
                         **extra).start()
            arms[label] = arm_gates(card, label, srv, far, probes,
                                   per_request, tally)
            check(srv.drain(timeout=300), f"{label}: drain timed out")
            del srv
            gc.collect()

        # The typed refusals.
        wb = param_bytes(r0.dispatcher.params)
        try:
            r0.load_candidate(params=near, hbm_budget_bytes=2 * wb - 1)
            check(False, "a candidate over budget was loaded")
        except CandidateUnfitError:
            pass
        try:
            r0.flip()
            check(False, "a flip with an empty slot went through")
        except NoCandidateError:
            pass
        try:
            r0.shadow_submit("neighbors", probes[0])
            check(False, "a neighbours shadow went through")
        except ValueError:
            pass
        tele = obs.Telemetry(events_path=os.path.join(root, "router.jsonl"))
        teles["router"] = tele
        router = FleetRouter([(n, r["url"]) for n, r in reps.items()],
                             telemetry=tele, health_interval_s=0.2,
                             request_timeout_s=120.0, cache_size=0).start()
        unfit = router.control_forward("r0", "/v1/rollout/load",
                                       {"source": "near",
                                        "hbm_budget_bytes": 2 * wb - 1})
        empty = router.control_forward("r0", "/v1/rollout/flip")
        types = [(s, json.loads(b).get("type")) for s, b in (unfit, empty)]
        print(f"# rollout base refusals: budget {2 * wb - 1} (resident + "
              f"candidate - 1) -> CandidateUnfitError, HTTP {types[0]}; "
              f"flip with an empty slot -> NoCandidateError, HTTP "
              f"{types[1]}; a neighbors shadow -> ValueError")
        check(types == [(409, "candidate_unfit"), (409, "no_candidate")],
              f"refusals over HTTP: {types}")

        # Mirror off: live latency through the router.
        seq_iter = iter(rollout_seqs(4000, seed=37))
        lat_off = []
        drive(router, [next(seq_iter) for _ in range(96)], lat_off)

        # No torn batch across a flip under load.
        for name in reps:
            status, body = router.control_forward(name, "/v1/rollout/load",
                                                  {"source": "far"})
            check(status == 200, f"load far on {name}: {status}")
        tally.take()
        torn_batch_gate(card, router, reps, tally, dense)
        pre = {n: [r["srv"].embed(p, timeout=120) for p in probes]
               for n, r in reps.items()}
        check(all(embeds_equal(a, b) for a, b in
                  zip(pre["r0"], arms["fp32 bucketed"]["pre"])),
              "r0's answers moved across the torn-batch rollback")

        def controller_run(source: str, want: str, lat: list):
            batches0 = {n: settled_batches(r["srv"])
                        for n, r in reps.items()}
            tally.take()
            ctl = RolloutController(
                router, telemetry=tele, source=source, sample_every=2,
                window_requests=32, windows_required=3,
                shadow_parity_max=1e-3)
            router.attach_rollout(ctl)
            t0 = time.perf_counter()
            ctl.start()
            drive_until_terminal(router, ctl, seq_iter, lat)
            wall = time.perf_counter() - t0
            st = ctl.status()
            launches = tally.take()
            batches = sum(settled_batches(r["srv"]) - batches0[n]
                          for n, r in reps.items())
            warm = sum(flat[n][0] for n in reps)
            runs = batches + st["shadow_ok"] + warm
            tally.expect(f"controller {source}", launches,
                         {k: v * runs for k, v in dense.items()})
            check(st["state"] == want, f"controller {source}: "
                                       f"{st['state']}, want {want}")
            print(f"# rollout base controller {source} [{card}]: "
                  f"{st['state']} after {st['window']} windows in "
                  f"{wall:.3f} s; {st['mirrored']} live mirrored, "
                  f"{st['sampled']} sampled, {st['shadow_ok']} shadows ok, "
                  f"{st['shadow_failed']} failed, {st['dropped']} dropped; "
                  f"flip {st['flip_seconds']} s; launches {launches} = "
                  f"{nb} x ({batches} live batches + {st['shadow_ok']} "
                  f"shadows + {warm} warm runs)")
            return ctl

        lat_on = []
        ctl = controller_run("near", "promoted", lat_on)
        fps = {}
        for n, r in reps.items():
            with urllib.request.urlopen(r["url"] + "/healthz",
                                        timeout=60) as resp:
                fps[n] = json.loads(resp.read())["trunk_fingerprint"]
        check(all(f == fp["near"] for f in fps.values()),
              f"after the promote /healthz shows {fps}")
        ctl.breach()
        back = {n: [r["srv"].embed(p, timeout=120) for p in probes]
                for n, r in reps.items()}
        check(all(embeds_equal(a, b) for n in reps
                  for a, b in zip(back[n], pre[n])),
              "breach(): answers differ from the pre-flip ones")
        for name in reps:
            router.control_forward(name, "/v1/rollout/unload")
        print(f"# rollout base controller near: both /healthz showed the "
              f"candidate's fingerprint {fp['near'][:12]}; breach() -> "
              f"{ctl.state}, every replica's answers = pre-flip bit for bit")
        controller_run("far", "refused", [])
        idle = all(not r["srv"].dispatcher.candidate_status()["loaded"]
                   and r["srv"].rollout_status()["candidate_fingerprint"]
                   is None for r in reps.values())
        after = {n: [r["srv"].embed(p, timeout=120) for p in probes]
                 for n, r in reps.items()}
        check(idle and all(embeds_equal(a, b) for n in reps
                           for a, b in zip(after[n], pre[n])),
              f"refusal: unloaded {idle}, or answers moved")
        print("# rollout base controller far: refused, the candidate "
              "unloaded on every replica, the answers unchanged")
        for n, r in reps.items():
            check(flat_state(r["srv"]) == flat[n],
                  f"{n}: graphs or pool moved over the rollouts "
                  f"{flat_state(r['srv'])} vs {flat[n]}")
        router.drain()
        for httpd in httpds:
            httpd.shutdown()
            httpd.server_close()
        for r in reps.values():
            check(r["srv"].drain(timeout=300), "replica drain timed out")
        events = serve_events(reps["r0"]["events"]) + serve_events(
            reps["r1"]["events"])
        off_hop, n_off = hop_ms(lat_off, events)
        on_hop, n_on = hop_ms(lat_on, events)
        print(f"# rollout base router [{card}]: live through the router, "
              f"one client: mirror off p50 {pct_ms([w for w, _ in lat_off], .5):.3f}"
              f" / p99 {pct_ms([w for w, _ in lat_off], .99):.3f} ms "
              f"({len(lat_off)} requests), mirror on (sample_every 2) p50 "
              f"{pct_ms([w for w, _ in lat_on], .5):.3f} / p99 "
              f"{pct_ms([w for w, _ in lat_on], .99):.3f} ms "
              f"({len(lat_on)}); router hop (its e2e minus the replica's) "
              f"p50 {off_hop:.3f} ms off ({n_off}), {on_hop:.3f} ms on "
              f"({n_on}); graphs {flat} unchanged on both replicas")
        windows = [r for r in obs.read_events(
            os.path.join(root, "router.jsonl")) if r["event"] ==
            "rollout_window"]
        print("# rollout base windows: " + "; ".join(
            f"{r['window']} {r['verdict']} parity {r.get('parity_max')}"
            for r in windows))
        for t in teles.values():
            t.close()
        for name in teles:
            recs = obs.read_events(os.path.join(
                root, name.replace(" ", "-") + ".jsonl"), strict=True)
            check(bool(recs), f"{name}: empty event stream")
        kinds = sorted({r["event"] for r in obs.read_events(
            os.path.join(root, "r0.jsonl"), strict=True)
            if r["event"].startswith("rollout")})
        print(f"# rollout base events: {len(teles)} streams pass "
              f"read_events(strict=True); r0 emitted {kinds}")
    finally:
        for t in teles.values():
            t.close()
        shutil.rmtree(root, ignore_errors=True)
    return tally.totals


# The cli phase's preset: `base` on the card (a CPU rehearsal may name
# `tiny`), run on one card (`--set mesh.data=1`).
CLI_PRESET = "base"
CLI_TIMEOUT = 300     # seconds a CLI subprocess may take to boot or finish
CLI_SERVED = 36       # timed lone requests per served arm


def cli_main(*argv) -> tuple:
    """(exit code, stdout) of `cli.main.main` in this process, on DEVICE.
    The log handler is attached to the real stdout first (`start_log`), so
    only the verb's own prints are captured."""
    import contextlib
    import io

    from proteinbert_tpu_torch.cli.main import main
    from proteinbert_tpu_torch.utils.logging import start_log

    start_log()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--device", DEVICE, *map(str, argv)])
    return rc, buf.getvalue()


def cli_spawn(argv, log_path: str, device: bool = True, **env):
    """`python -m proteinbert_tpu_torch [--device DEVICE] <argv>` from this
    checkout, its output into `log_path`."""
    repo = os.path.dirname(os.path.abspath(__file__))
    head = ["--device", DEVICE] if device else []
    with open(log_path, "wb") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "proteinbert_tpu_torch", *head,
             *map(str, argv)], cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo, **env), stdout=log,
            stderr=subprocess.STDOUT)


def cli_wait_file(path: str, proc, label: str, lines: int = 1) -> str:
    """The text of `path` once it holds `lines` lines (the process still
    running), within CLI_TIMEOUT."""
    deadline = time.monotonic() + CLI_TIMEOUT
    while True:
        text = open(path).read() if os.path.exists(path) else ""
        if text.strip() and len(text.splitlines()) >= lines:
            return text
        check(proc.poll() is None, f"cli {label}: exited {proc.returncode} "
                                   "before writing " + path)
        check(time.monotonic() < deadline, f"cli {label}: no {path} within "
                                           f"{CLI_TIMEOUT} s")
        time.sleep(0.1)


def cli_exit(proc, label: str, sig=None) -> int:
    if sig is not None:
        proc.send_signal(sig)
    try:
        return proc.wait(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        check(False, f"cli {label}: did not exit within {CLI_TIMEOUT} s")


def cli_served(card: str, label: str, url: str, srv, reqs) -> None:
    """Warm each request kind once, then `reqs` one at a time over HTTP
    to the served CLI process at `url`: every answer 200 and within
    SERVE_EMBED_TOL of the same request alone on the in-process `srv` (same
    trunk, same arm), fills equal. Prints the lone request's p50 / p99."""
    for kind, seq in traffic(3, seed=61):
        status, _ = http_post(f"{url}/v1/{kind}", {"seq": seq})
        check(status == 200, f"cli {label}: warm {kind} answered {status}")
        srv.submit(kind, seq).result(timeout=120)
    walls, worst = [], 0.0
    for kind, seq in reqs:
        t0 = time.perf_counter()
        status, body = http_post(f"{url}/v1/{kind}", {"seq": seq})
        walls.append(time.perf_counter() - t0)
        check(status == 200, f"cli {label}: {kind} answered {status}: {body}")
        want = srv.submit(kind, seq).result(timeout=120)
        if kind == "embed":
            for key in ("global", "local_mean"):
                worst = max(worst, float(np.abs(np.asarray(
                    body[key], np.float32) - want[key]).max()))
        elif kind == "predict_go":
            worst = max(worst, float(np.abs(np.asarray(
                body["probs"], np.float32) - want).max()))
        else:
            check(body["filled"] == want[0],
                  f"cli {label}: predict_residues fill differs")
    print(f"# cli {CLI_PRESET} serve {label} [{card}]: {len(reqs)} lone "
          f"HTTP requests (20-500 residues, the three kinds in turn) to "
          f"`serve` started from the command line: p50 "
          f"{pct_ms(walls, 0.5):.2f} ms, p99 {pct_ms(walls, 0.99):.2f} ms "
          f"(host wall per request, 127.0.0.1); answers vs the same "
          f"requests on an in-process Server: max |diff| {worst:.3e} (tol "
          f"{SERVE_EMBED_TOL}), fills equal")
    check(worst <= SERVE_EMBED_TOL, f"cli {label}: answers differ by {worst}")


def cli_serve_mesh(url: str, log_path: str) -> None:
    """`serve --mesh` from the command line on the run's one-device mesh:
    its log line and `stats()["mesh"]` (GET /healthz) are JAX's."""
    import urllib.request

    with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
        mesh = json.loads(resp.read())["stats"]["mesh"]
    want = {"data": 1, "fsdp": 1, "model": 1, "seq": 1}
    line = f"serving with batch-dim sharding over {want} (1 devices)"
    logged = line in open(log_path).read()
    print(f"# cli {CLI_PRESET} serve bucketed --mesh: stats()['mesh'] "
          f"{mesh}, the log line '{line}' {logged}")
    check(mesh == want and logged,
          f"cli serve --mesh: stats mesh {mesh}, log line {logged}")


def host_census(label: str, window_s: float = 2.0) -> None:
    """`# host census <label>`: what runs beside the next phase. This
    process's threads (their Python names) and live descendant processes,
    the CPU seconds each used over `window_s` of sleep here, the
    machine's busy share over the same window (/proc/stat), and the
    card's SM clock, temperature and power draw. A thread or process
    that an earlier phase left running shows here."""
    tick = os.sysconf("SC_CLK_TCK")

    def stat(path):  # (ppid, CPU seconds) of a /proc stat file, or None
        try:
            with open(path) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            return None
        return int(fields[1]), (int(fields[11]) + int(fields[12])) / tick

    def machine():  # (busy, total) jiffies of all cores
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        return sum(v) - v[3] - v[4], sum(v)

    def descendants():
        kids = {}
        for d in os.listdir("/proc"):
            if d.isdigit() and (got := stat(f"/proc/{d}/stat")):
                kids.setdefault(got[0], []).append(int(d))
        out, todo = [], [os.getpid()]
        while todo:
            for kid in kids.get(todo.pop(), []):
                out.append(kid)
                todo.append(kid)
        return out

    def snapshot():
        tids = {int(t): stat(f"/proc/self/task/{t}/stat")
                for t in os.listdir("/proc/self/task")}
        return ({t: v[1] for t, v in tids.items() if v},
                {p: v[1] for p in kids if (v := stat(f"/proc/{p}/stat"))},
                machine())

    names = {t.native_id: t.name for t in threading.enumerate()}
    kids = descendants()
    t0, k0, (b0, n0) = snapshot()
    time.sleep(window_s)
    t1, k1, (b1, n1) = snapshot()
    busy = sorted(((t1[t] - t0.get(t, 0.0), t) for t in t1), reverse=True)
    hot = [f"{names.get(t, 'native')} {dt:.2f} s" for dt, t in busy[:4]
           if dt > 0.0]
    cmds = []
    for p in kids:
        try:
            with open(f"/proc/{p}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()[:120]
        except OSError:
            continue
        cmds.append(f"{p} [{k1.get(p, 0.0) - k0.get(p, 0.0):.2f} s] {cmd}")
    try:
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,"
             "power.draw", "--format=csv,noheader"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        gpu = f"not read ({e})"
    cpu = os.times()
    print(f"# host census {label}: {len(t1)} threads ({len(names)} Python: "
          f"{', '.join(sorted(names.values()))}); over {window_s:.1f} s of "
          f"sleep this process used {sum(busy_s for busy_s, _ in busy):.2f}"
          f" CPU s (busiest: {', '.join(hot) or 'none'}), the machine "
          f"{100.0 * (b1 - b0) / max(n1 - n0, 1):.1f}% busy of "
          f"{os.cpu_count()} cores; this process's CPU so far "
          f"{cpu.user + cpu.system:.1f} s; {len(cmds)} live descendant "
          f"processes{': ' if cmds else ''}{'; '.join(cmds)}; card SM "
          f"clock, temperature, power: {gpu}")


def cli_phase(card: str) -> dict:
    """`# cli base ...`: the port's command line (`python -m
    proteinbert_tpu_torch`) on the card at the `base` preset (6 blocks,
    C=G=512, H=8, 8943 annotations, bf16), `--set mesh.data=1`, seeded
    random weights, synthetic proteins.

    1. `import-weights` of a flat NPZ of seeded params, then
       `export-weights` of the run: the NPZ back bit for bit.
    2. `embed` and `predict-go` in this process over 16 proteins, batch 8:
       exactly 6 K1 + 6 K2 a batch and nothing else; the answers those of
       `inference.embed` / `predict_go` on the loaded trunk, bit for bit.
    3. `map --fasta` in this process over 384 proteins (buckets
       128/256/512, 2 shards of 64-record blocks): exactly 6 #3 + 6 K2 a
       packed batch; `map --verify`, `index`, `index --verify` ok.
    4. `serve` as a subprocess, bucketed with `--mesh` (the run's one-device
       mesh: its log line and `stats()["mesh"]`) and `--serve-mode ragged
       --quant int8`: CLI_SERVED lone HTTP requests each, answers against an
       in-process Server on the same trunk and arm; SIGTERM → exit 0, the
       stream ending `serve_end{drained}`. `fleet --replicas 2`: 16 routed
       embeds answered within SERVE_EMBED_TOL of the bucketed in-process
       Server's, SIGTERM → exit 0.
    5. With CUDA_VISIBLE_DEVICES="" and no --device, `embed` exits
       non-zero with the device message.
    6. `pretrain --set data.batch_size=8` as a subprocess, alone on the
       card: SIGTERM after a few logged steps → exit 75; the same command
       with --max-steps 4 past the saved step → exit 0, its steps
       continuing from the saved one. Prints the median step ms.
    The servers, the fleet and the no-card check boot while steps 1-3
    run. A `host_census` opens the phase. Returns the launches of steps 2
    and 3."""
    from proteinbert_tpu_torch import inference, obs
    from proteinbert_tpu_torch.cli.main import NO_CARD
    from proteinbert_tpu_torch.configs import load_config
    from proteinbert_tpu_torch.configs import get_preset
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, KERNELS, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
    )
    from proteinbert_tpu_torch.models.proteinbert import init
    from proteinbert_tpu_torch.serve.server import Server
    from proteinbert_tpu_torch.weights import params_to_flat

    nb = get_preset(CLI_PRESET).model.num_blocks
    sets = ["--set", "mesh.data=1"]
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="cli-", dir=build)
    run = os.path.join(root, "run")
    path = lambda name: os.path.join(root, name)  # noqa: E731
    procs = {}
    totals = {}
    host_census("cli start")

    def take() -> dict:
        got = {k.name: k.launches for k in KERNELS}
        for k in KERNELS:
            totals[k.name] = totals.get(k.name, 0) + k.launches
            k.launches = 0
        return got

    def zero() -> None:
        for k in KERNELS:
            k.launches = 0

    def expect(label: str, got: dict, want: dict) -> None:
        print(f"# cli {CLI_PRESET} {label} launches: "
              + ", ".join(f"{n} {c}" for n, c in got.items() if c))
        for name, n in got.items():
            check(n == want.get(name, 0), f"cli {label}: {name} launched "
                                          f"{n} times, want "
                                          f"{want.get(name, 0)}")

    try:
        # 1. Weights in and out.
        flat = params_to_flat(init(get_preset(CLI_PRESET).model,
                                   torch.Generator().manual_seed(16),
                                   device="cpu"))
        np.savez(path("w.npz"), **flat)
        t0 = time.perf_counter()
        rc, _ = cli_main("import-weights", "--weights", path("w.npz"),
                         "--output", run, "--preset", CLI_PRESET, *sets)
        import_s = time.perf_counter() - t0
        check(rc == 0, f"cli import-weights exited {rc}")
        t0 = time.perf_counter()
        rc, _ = cli_main("export-weights", "--pretrained", run,
                         "--output", path("back.npz"))
        export_s = time.perf_counter() - t0
        check(rc == 0, f"cli export-weights exited {rc}")
        with np.load(path("back.npz")) as z:
            back = {k: z[k] for k in z.files}
        same = sorted(back) == sorted(flat) and all(
            back[k].dtype == np.float32 and np.array_equal(back[k], flat[k])
            for k in flat)
        print(f"# cli {CLI_PRESET} weights [{card}]: import-weights "
              f"{import_s:.2f} s ({len(flat)} arrays, "
              f"{sum(a.nbytes for a in flat.values()) / 1e6:.1f} MB float32,"
              f" the run directory written with its Adam state), "
              f"export-weights {export_s:.2f} s; the NPZ back bit for bit: "
              f"{same}")
        check(same, "cli: export-weights did not give the imported NPZ back")
        del flat, back

        # The served processes and the no-card check boot meanwhile; the
        # bucketed one serves over the run's one-device mesh.
        for label, extra in (("bucketed", ["--mesh"]),
                             ("ragged int8", ["--serve-mode", "ragged",
                                              "--quant", "int8"])):
            tag = label.replace(" ", "-")
            procs[label] = cli_spawn(
                ["serve", "--pretrained", run, "--port", 0, "--port-file",
                 path(f"{tag}.port"), "--events-jsonl",
                 path(f"{tag}.jsonl"), *extra], path(f"{tag}.log"))
        procs["fleet"] = cli_spawn(
            ["fleet", "--pretrained", run, "--replicas", 2, "--port", 0,
             "--port-file", path("fleet.port"), "--boot-timeout-s",
             CLI_TIMEOUT], path("fleet.log"))
        procs["no card"] = cli_spawn(
            ["embed", "--pretrained", run, "--output", path("nocard.npz"),
             "MKTAYIAKQR"], path("nocard.log"), device=False,
            CUDA_VISIBLE_DEVICES="")

        # 2. embed and predict-go in this process.
        cfg = load_config(os.path.join(run, "config.json"))
        trunk, _ = inference.load_trunk(run, cfg, DEVICE)
        seqs = [seq.replace("?", "A") for _, seq in traffic(16, seed=62)]
        zero()
        rc, _ = cli_main("embed", "--pretrained", run, "--output",
                         path("e.npz"), "--batch-size", 8, *seqs)
        check(rc == 0, f"cli embed exited {rc}")
        expect("embed (2 batches)", take(),
               {LOCAL_TRACK.name: 2 * nb, ATTENTION.name: 2 * nb})
        want = inference.embed(trunk, cfg, seqs, batch_size=8,
                               device=DEVICE)
        zero()   # the reference's launches are not the verb's
        got = np.load(path("e.npz"))
        check(all(np.array_equal(got[k], want[k]) for k in want),
              "cli embed differs from inference.embed on the same trunk")
        rc, _ = cli_main("predict-go", "--pretrained", run, "--output",
                         path("g.tsv"), "--batch-size", 8, "--top-k", 10,
                         *seqs)
        check(rc == 0, f"cli predict-go exited {rc}")
        expect("predict-go (2 batches)", take(),
               {LOCAL_TRACK.name: 2 * nb, ATTENTION.name: 2 * nb})
        top = inference.predict_go(trunk, cfg, seqs, batch_size=8, top_k=10,
                                   device=DEVICE)
        zero()
        rows = "".join(f"seq{i}\t{col}\t\t\t{prob:.4f}\n"
                       for i, row in enumerate(top) for col, prob in row)
        check(open(path("g.tsv")).read() == rows,
              "cli predict-go differs from inference.predict_go")
        print(f"# cli {CLI_PRESET} embed, predict-go [{card}]: 16 "
              "proteins, batch 8, in process: answers those of "
              "inference.embed / predict_go on the loaded trunk bit for bit")

        # 3. map, index and their audits in this process.
        corpus = traffic(384, seed=63)
        with open(path("corpus.fasta"), "w") as f:
            for i, (_, seq) in enumerate(corpus):
                f.write(f">P{i:04d} synthetic\n{seq.replace('?', 'A')}\n")
        store, index = path("store"), path("index")
        t0 = time.perf_counter()
        rc, _ = cli_main("map", "--pretrained", run, "--store", store,
                         "--fasta", path("corpus.fasta"), "--num-shards", 2,
                         "--block-size", 64, "--buckets", json.dumps(
                             list(BUCKETS)), "--events-jsonl",
                         path("map.jsonl"))
        map_s = time.perf_counter() - t0
        check(rc == 0, f"cli map exited {rc}")
        end = obs.read_events(path("map.jsonl"))[-1]
        check(end["event"] == "map_end", "cli map: no map_end last")
        batches = end["stats"]["batches"]
        expect(f"map ({batches} packed batches)", take(),
               {LOCAL_TRACK_SEGMENTS.name: batches * nb,
                ATTENTION.name: batches * nb})
        audits = {}
        for label, argv in (("map --verify", ["map", "--store", store,
                                              "--verify"]),
                            ("index", ["index", "--store", store, "--index",
                                       index, "--json"]),
                            ("index --verify", ["index", "--index", index,
                                                "--verify"])):
            rc, out = cli_main(*argv)
            audits[label] = (rc, json.loads(out.strip().splitlines()[-1]))
        verify, built, iverify = (audits[k][1] for k in audits)
        print(f"# cli {CLI_PRESET} map, index [{card}]: map of 384 "
              f"proteins {map_s:.2f} s ({batches} packed batches, "
              f"{end['stats']['seqs_per_s']} seqs/s); map --verify ok "
              f"{verify['ok']} complete {verify['complete']}; index "
              f"{built['outcome']} ({built['vectors']} vectors); index "
              f"--verify ok {iverify['ok']}")
        check(all(rc == 0 for rc, _ in audits.values()) and verify["ok"]
              and verify["complete"] and verify["embedded"] == 384
              and built["outcome"] == "completed"
              and built["vectors"] == 384 and iverify["ok"],
              f"cli map/index audits: {audits}")

        # 4. The served processes against in-process servers: the
        # bucketed one also holds the fleet's routed answers.
        bucketed = Server(trunk, cfg, device=DEVICE).start()
        try:
            for label, kw in (("bucketed", None),
                              ("ragged int8", dict(serve_mode="ragged",
                                                   quant="int8"))):
                tag = label.replace(" ", "-")
                port = cli_wait_file(path(f"{tag}.port"), procs[label],
                                     f"serve {label}").strip()
                srv = bucketed if kw is None else Server(
                    trunk, cfg, device=DEVICE, **kw).start()
                try:
                    cli_served(card, label, f"http://127.0.0.1:{port}", srv,
                               traffic(CLI_SERVED, seed=64))
                finally:
                    if srv is not bucketed:
                        srv.drain(timeout=60)
                if label == "bucketed":
                    cli_serve_mesh(f"http://127.0.0.1:{port}",
                                   path(f"{tag}.log"))
                rc = cli_exit(procs.pop(label), f"serve {label}",
                              signal.SIGTERM)
                last = obs.read_events(path(f"{tag}.jsonl"))[-1]
                print(f"# cli {CLI_PRESET} serve {label}: SIGTERM -> exit "
                      f"{rc}, the stream ends "
                      f"{last['event']}{{{last.get('outcome')}}}")
                check(rc == 0 and last["event"] == "serve_end"
                      and last.get("outcome") == "drained",
                      f"cli serve {label}: exit {rc}, last event {last}")
            port = cli_wait_file(path("fleet.port"), procs["fleet"],
                                 "fleet").strip()
            walls, worst = [], 0.0
            for _, seq in traffic(16, seed=65):
                seq = seq.replace("?", "A")
                t0 = time.perf_counter()
                status, body = http_post(
                    f"http://127.0.0.1:{port}/v1/embed", {"seq": seq})
                walls.append(time.perf_counter() - t0)
                check(status == 200,
                      f"cli fleet: routed embed answered {status}: {body}")
                want = bucketed.submit("embed", seq).result(timeout=120)
                for key in ("global", "local_mean"):
                    worst = max(worst, float(np.abs(np.asarray(
                        body[key], np.float32) - want[key]).max()))
        finally:
            bucketed.drain(timeout=60)
        zero()
        rc = cli_exit(procs.pop("fleet"), "fleet", signal.SIGTERM)
        drained = [line for line in open(path("fleet.log"))
                   if "fleet drained" in line]
        print(f"# cli {CLI_PRESET} fleet [{card}]: 2 replicas, 16 routed "
              f"embeds answered (p50 {pct_ms(walls, 0.5):.2f} ms, first "
              f"{walls[0] * 1e3:.1f} ms), vs the same requests on an "
              f"in-process bucketed Server: max |diff| {worst:.3e} (tol "
              f"{SERVE_EMBED_TOL}); SIGTERM -> exit {rc}; "
              + (drained[-1].split("] ", 1)[-1].strip() if drained else ""))
        check(worst <= SERVE_EMBED_TOL,
              f"cli fleet: routed answers differ by {worst}")
        check(rc == 0, f"cli fleet exited {rc}")

        # 5. No card, no --device: the device message, a non-zero exit.
        rc = cli_exit(procs.pop("no card"), "no card")
        said = open(path("nocard.log")).read()
        print(f"# cli no card: CUDA_VISIBLE_DEVICES='' and no --device -> "
              f"exit {rc}, the device message {NO_CARD in said}")
        check(rc != 0 and NO_CARD in said, f"cli no card: exit {rc}")

        # 6. Pretrain, preempt, resume — alone on the card.
        del trunk
        gc.collect()
        torch.cuda.empty_cache()
        ck, metrics = path("ck"), path("m.jsonl")
        argv = ["pretrain", "--preset", CLI_PRESET, *sets, "--set",
                "data.batch_size=8", "--set", "train.log_every=1",
                "--checkpoint-dir", ck, "--metrics-jsonl", metrics,
                "--events-jsonl", path("train.jsonl")]
        t0 = time.perf_counter()
        proc = procs["pretrain"] = cli_spawn(argv + ["--max-steps", 1000],
                                             path("train1.log"))
        cli_wait_file(metrics, proc, "pretrain", lines=5)
        preempt_rc = cli_exit(procs.pop("pretrain"), "pretrain",
                              signal.SIGTERM)
        first_s = time.perf_counter() - t0
        saved = max(int(n) for n in os.listdir(ck) if n.isdigit())
        logged = [json.loads(line)["step"] for line in open(metrics)]
        check(preempt_rc == 75 and logged == list(range(1, saved + 1)),
              f"cli pretrain: SIGTERM -> exit {preempt_rc}, saved {saved}, "
              f"logged {logged}")
        t0 = time.perf_counter()
        proc = procs["pretrain"] = cli_spawn(
            argv + ["--max-steps", saved + 4], path("train2.log"))
        rc = cli_exit(procs.pop("pretrain"), "pretrain resume")
        resume_s = time.perf_counter() - t0
        lines = [json.loads(line) for line in open(metrics)]
        steps = [m["step"] for m in lines]
        check(rc == 0 and steps == list(range(1, saved + 5)),
              f"cli pretrain resume: exit {rc}, steps {steps}")
        # Each run's first step holds its warm-up; the rest are steady.
        step_ms = [m["window_step_ms"] for m in lines
                   if m["step"] not in (1, saved + 1)
                   and m.get("window_step_ms")]
        check(all(np.isfinite(m["loss"]) for m in lines),
              "cli pretrain: a loss is not finite")
        print(f"# cli {CLI_PRESET} pretrain [{card}]: B=8 L="
              f"{get_preset(CLI_PRESET).data.seq_len} synthetic, log every "
              f"step: SIGTERM after step "
              f"{saved} -> exit {preempt_rc}, run {first_s:.1f} s from "
              f"spawn; resumed at step {saved + 1} -> 4 steps, exit 0, "
              f"{resume_s:.1f} s from spawn; median step "
              f"{statistics.median(step_ms):.2f} ms over {len(step_ms)} "
              f"steps (min {min(step_ms):.2f}, max {max(step_ms):.2f})")
    finally:
        # SIGTERM first: a fleet drains and stops its replicas itself.
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs.values():
            try:
                proc.wait(timeout=CLI_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    return totals


# ----------------------------------------------------------- data parallel

DATA_STEPS = 6
DATA_RANK_TIMEOUT = 300   # seconds for the two spawned ranks of (c)
ZERO_TOL = 2e-6           # ZeRO-1 fp32 against the replicated params
INT8_TOL = 1e-3           # ZeRO-1 int8 against the replicated params
INT8_WIRE = 0.27          # int8 / fp32 gradient-reduction wire bytes


def data_cfg(B: int, steps: int):
    """`base` at full width, dense, B rows of 512 (the preset's 128 rows
    over 16 replicas at B=8), a constant LR from step 0 so that a few
    steps move the params, on a one-replica mesh."""
    from proteinbert_tpu_torch.configs import MeshConfig

    cfg = train_preset("base", B, 512, steps)
    return cfg.replace(
        optimizer=dataclasses.replace(cfg.optimizer, schedule="constant",
                                      warmup_steps=0),
        mesh=MeshConfig(data=1))


def data_rank(rank: int, world: int, store: str, out: str,
              device: str) -> None:
    """One of two ranks on the one card over gloo: `base` at data=2, 2
    steps of the replicated step, ZeRO-1 fp32, ZeRO-1 int8 and the
    replicated step again, on this rank's 4 of 8 rows from one seed;
    rank 0 writes the params' max differences from the first run, the
    losses, grad norms and wire bytes to `<out>/data.json`."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from proteinbert_tpu_torch.configs import MeshConfig
    from proteinbert_tpu_torch.data.dataset import (
        InMemoryPretrainingDataset, make_pretrain_iterator,
    )
    from proteinbert_tpu_torch.obs import Telemetry
    from proteinbert_tpu_torch.parallel.mesh import make_mesh
    from proteinbert_tpu_torch.parallel.zero import (
        comm_bytes, grad_reduce_wire_bytes,
    )
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.train.train_state import create_train_state
    from proteinbert_tpu_torch.train.trainer import pretrain

    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        # The runs are compared with each other: they must repeat
        # themselves (as in `data_one_rank`).
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        # The JAX ZeRO and quantization tests' optimizer (tests/
        # test_zero.py:45): LR 0 at step 1, 1e-4 at step 2, so the two
        # steps make one update. With an update at step 1 as well, Adam
        # turns the clip norm's last bit (summed over shards, not leaves)
        # into up to 2.5e-5 on a few near-zero gradients by step 2.
        base = train_preset("base", 8, 512, 2)
        base = base.replace(
            optimizer=dataclasses.replace(base.optimizer,
                                          learning_rate=1e-3,
                                          warmup_steps=10),
            mesh=MeshConfig(data=2))
        mesh = make_mesh(base.mesh)
        seqs, ann = synthetic_proteins(32, 100, 510,
                                       base.model.num_annotations, 4)
        ds = InMemoryPretrainingDataset(seqs, ann, 512)
        runs = {}
        for name, parallel in (("replicated", {}),
                               ("zero fp32", {"zero_update": True}),
                               ("zero int8", {"zero_update": True,
                                              "grad_reduce_dtype": "int8"}),
                               ("replicated again", {})):
            cfg = base.replace(parallel=dataclasses.replace(
                base.parallel, **parallel))
            state = create_train_state(torch.Generator().manual_seed(4), cfg,
                                       device=device)
            tele = Telemetry(flight_dir=out)
            t0 = time.perf_counter()
            out_run = pretrain(cfg, make_pretrain_iterator(
                ds, 4, seed=4, process_index=mesh.data_index,
                process_count=mesh.data_extent), state=state, device=device,
                mesh=mesh, telemetry=tele)
            float(tree_leaves(state.params)[0].sum())   # waits for the card
            runs[name] = (tree_leaves(state.params),
                          grad_reduce_wire_bytes(comm_bytes(tele.metrics)[1]),
                          (time.perf_counter() - t0) * 1e3,
                          [(h["loss"], h["grad_norm"])
                           for h in out_run["history"]])
        ref = runs["replicated"][0]
        res = {}
        for name, (p, wire, ms, hist) in runs.items():
            diffs = [float((a - b).abs().max()) for a, b in zip(ref, p)]
            worst = int(np.argmax(diffs))
            res[name] = {
                "max_diff": diffs[worst], "wire_bytes": wire, "run_ms": ms,
                "loss_grad_norm": hist, "worst_leaf": worst,
                "over_2e-6": int(sum(int(((a - b).abs() > ZERO_TOL).sum())
                                     for a, b in zip(ref, p)))}
        if rank == 0:
            with open(os.path.join(out, "data.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def data_phase(card: str) -> dict:
    """Phase 11 (module docstring): (a) the data-parallel loop over a
    one-rank NCCL group against the plain loop, (b) `pretrain --multihost`
    as a subprocess, (c) two ranks on the one card over gloo; returns each
    kernel's launches in the loops of (a)."""
    totals = data_one_rank(card)
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="data_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        data_cli(card, root)
        data_two_ranks(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return totals


def data_one_rank(card: str) -> dict:
    """(a): plain, data-parallel, data-parallel with zero_update, plain,
    over a one-rank NCCL group made in process; returns the launches."""
    import logging

    import torch.distributed as dist

    from proteinbert_tpu_torch.configs import MeshConfig
    from proteinbert_tpu_torch.kernels import ATTENTION, LOCAL_TRACK
    from proteinbert_tpu_torch.parallel.mesh import make_mesh
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.train.train_state import (
        make_data_parallel_train_step,
    )

    totals = {}
    per_step = {LOCAL_TRACK.name: 6, ATTENTION.name: 6}
    cfg = data_cfg(8, DATA_STEPS)
    zcfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                    zero_update=True))

    # (a) One rank, NCCL, in process: every collective runs over one rank.
    warned = []

    class Catch(logging.Handler):
        def emit(self, record):
            if "zero_update requested" in record.getMessage():
                warned.append(record.getMessage())

    catch = Catch()
    logging.getLogger("proteinbert_tpu_torch.train.trainer").addHandler(
        catch)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    # Bit for bit needs a plain loop that repeats itself: with cuDNN's
    # default backward algorithms two plain runs part from step 2 on the
    # H100. warn_only names any op left.
    was = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_mesh(MeshConfig(data=1))
        check(mesh.data_group is dist.group.WORLD,
              "data base: the one-rank mesh has no data group")
        runs = {}
        for label, c, m in (("plain", cfg, None), ("data-parallel", cfg, mesh),
                            ("data-parallel zero_update", zcfg, mesh),
                            ("plain again", cfg, None)):
            out, walls, launches, peak, batch, _ = train_run(
                card, f"data base {label}", c, DATA_STEPS, per_step,
                (100, 510), 5, mesh=m)
            for name, n in launches.items():
                totals[name] = totals.get(name, 0) + n
            runs[label] = (out, walls, peak)
        check(len(warned) == 1, f"data base: zero_update at data 1 logged "
                                f"{len(warned)} warnings, want 1")
        ref = runs["plain"][0]
        for label in ("data-parallel", "data-parallel zero_update",
                      "plain again"):
            got = runs[label][0]
            same_loss = ([h["loss"] for h in got["history"]]
                         == [h["loss"] for h in ref["history"]])
            a, b = ref["state"], got["state"]
            same_state = all(torch.equal(x, y) for x, y in zip(
                tree_leaves(a.params) + a.opt_state.mu + a.opt_state.nu,
                tree_leaves(b.params) + b.opt_state.mu + b.opt_state.nu))
            drift = max(float((x - y).abs().max()) for x, y in zip(
                tree_leaves(a.params), tree_leaves(b.params)))
            check(same_loss and same_state,
                  f"data base {label}: losses {same_loss}, params and "
                  "moments bit for bit the plain loop's "
                  f"{same_state} (max |param diff| {drift}; losses "
                  f"{[h['loss'] for h in got['history']]} against "
                  f"{[h['loss'] for h in ref['history']]})")
        # The one-rank all-reduce: device time of one step by kernel name.
        state = runs["data-parallel"][0]["state"]
        step = make_data_parallel_train_step(mesh, cfg)
        by_name = device_ms_by_name(lambda: step(state, batch), reps=3)
        comm = {n: ms for n, ms in by_name.items()
                if "nccl" in n.lower() or "memcpy" in n.lower()}
        n_grad = sum(t.numel() for t in tree_leaves(state.params))
        m = cfg.model
        med = {k: statistics.median(v[1][1:]) for k, v in runs.items()}
        print(f"# data base one-rank NCCL [{card}]: {m.num_blocks} blocks "
              f"C={m.local_dim} G={m.global_dim} H={m.num_heads} "
              f"A={m.num_annotations}, {m.dtype}, B=8 L=512, "
              f"{DATA_STEPS} steps, constant LR, deterministic algorithms "
              "(cudnn.deterministic); losses, params and moments "
              "bit for bit the plain loop's (data-parallel, and with "
              "zero_update at data 1: the JAX warning logged, the "
              "replicated update run); launches a step "
              f"{per_step}; step ms median of 5: "
              + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
              + f"; all-reduce of {n_grad * 4 / 1e6:.1f} MB of fp32 "
              "gradients, device ms a step by kernel: "
              + (", ".join(f"{n} {ms:.3f}" for n, ms in sorted(comm.items()))
                 or "none recorded")
              + f"; step device ms total {sum(by_name.values()):.2f}")
    finally:
        dist.destroy_process_group()
        logging.getLogger("proteinbert_tpu_torch.train.trainer") \
            .removeHandler(catch)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            was[:2]
        torch.use_deterministic_algorithms(was[2])
    # The plain loop again under cuDNN's default algorithms (two such runs
    # part from step 2, so it is timed, not compared): what the
    # deterministic setting above costs a step, in this call.
    _, walls, launches, _, _, _ = train_run(
        card, "data base plain cuDNN default", cfg, DATA_STEPS, per_step,
        (100, 510), 5)
    for name, n in launches.items():
        totals[name] = totals.get(name, 0) + n
    print(f"# data base cuDNN [{card}]: plain step ms median of 5, "
          f"deterministic {med['plain']:.2f} / {med['plain again']:.2f}, "
          f"cuDNN default {statistics.median(walls[1:]):.2f}")
    return totals


def data_cli(card: str, root: str) -> None:
    """(b): `pretrain --multihost` over a one-process NCCL group, then the
    unsplit `base` preset refused."""
    events = os.path.join(root, "ev.jsonl")
    env = dict(COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
               NUM_PROCESSES="1", PROCESS_ID="0")
    t0 = time.perf_counter()
    proc = cli_spawn(["pretrain", "--multihost", "--preset", "base",
                      "--set", "mesh.data=1", "--set",
                      "data.batch_size=8", "--set", "train.log_every=1",
                      "--max-steps", 4, "--checkpoint-dir",
                      os.path.join(root, "ck"), "--events-jsonl",
                      events], os.path.join(root, "mh.log"), **env)
    rc = cli_exit(proc, "pretrain --multihost")
    run_s = time.perf_counter() - t0
    said = open(os.path.join(root, "mh.log")).read()
    recs = [json.loads(line) for line in open(events)] \
        if os.path.exists(events) else []
    start = [r for r in recs if r["event"] == "run_start"]
    steps = [r["step"] for r in recs if r["event"] == "step"]
    nccl = "torch distributed (nccl): process 0/1" in said
    check(rc == 0 and nccl and steps == [1, 2, 3, 4] and len(start) == 1
          and start[0]["mesh"] == {"data": 1, "fsdp": 1, "model": 1,
                                   "seq": 1}
          and start[0]["n_chips"] == 1,
          f"data base cli: exit {rc}, NCCL group {nccl}, steps {steps}, "
          f"run_start {start[:1]}; log tail {said[-2000:]}")
    proc = cli_spawn(["pretrain", "--preset", "base", "--max-steps", 1,
                      "--checkpoint-dir", os.path.join(root, "ck2")],
                     os.path.join(root, "mesh.log"))
    rc2 = cli_exit(proc, "pretrain --preset base")
    refused = open(os.path.join(root, "mesh.log")).read()
    check(rc2 == 1 and "wants 16 devices, have 1" in refused,
          f"data base cli: the unsplit base preset exited {rc2}: "
          f"{refused[-500:]}")
    print(f"# data base cli [{card}]: pretrain --multihost (COORDINATOR_"
          f"ADDRESS, NUM_PROCESSES=1, PROCESS_ID=0) --preset base --set "
          f"mesh.data=1 data.batch_size=8: the group formed over NCCL, "
          f"steps {steps}, exit {rc}, {run_s:.1f} s from spawn; "
          f"run_start mesh {start[0]['mesh']} n_chips "
          f"{start[0]['n_chips']}; pretrain --preset base alone -> exit "
          f"{rc2}: {refused.strip().splitlines()[-1]}")



def data_two_ranks(card: str, root: str) -> None:
    """(c): two spawned ranks on the one card over gloo (`data_rank`)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=data_rank,
                         args=(r, 2, os.path.join(root, "store"), root,
                               DEVICE))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + DATA_RANK_TIMEOUT
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(codes == [0, 0], f"data base two ranks: exit codes {codes}")
    res = json.load(open(os.path.join(root, "data.json")))
    zero_diff = res["zero fp32"]["max_diff"]
    int8_diff = res["zero int8"]["max_diff"]
    ratio = (res["zero int8"]["wire_bytes"]
             / res["zero fp32"]["wire_bytes"])
    check(res["replicated again"]["max_diff"] == 0.0
          and zero_diff <= ZERO_TOL and 0 < int8_diff <= INT8_TOL
          and ratio <= INT8_WIRE,
          f"data base two ranks: ZeRO fp32 {zero_diff}, int8 "
          f"{int8_diff} from the replicated params; int8 / fp32 wire "
          f"{ratio}; {json.dumps(res)}")
    print(f"# data base two ranks [{card}]: gloo on one card, data=2, "
          f"B=8 (4 a rank) L=512, lr 1e-3 warmup 10 (LR 0 at step 1), 2 "
          f"steps each from one seed, "
          f"{time.perf_counter() - t0:.1f} s with start-up; max |param "
          f"- replicated|: ZeRO fp32 {zero_diff:.3g} (<= {ZERO_TOL}), "
          f"ZeRO int8 {int8_diff:.3g} (<= {INT8_TOL}); gradient-"
          "reduction wire bytes a rank over the 2 steps: "
          + ", ".join(f"{k} {v['wire_bytes']:.0f}"
                      for k, v in res.items())
          + f"; int8 / fp32 {ratio:.4f} (<= {INT8_WIRE}); (loss, grad "
          "norm) a step: "
          + "; ".join(f"{k} {v['loss_grad_norm']}" for k, v in res.items())
          + "; run ms " + ", ".join(f"{k} {v['run_ms']:.0f}"
                                   for k, v in res.items()))


# The corpus phase: entries (50,000 of UniRef90's ~1.5e8, a cut for the
# full run's time), the GO DAG's size, UniRef90's element layout.
ETL_ENTRIES = 50_000
ETL_GO_TERMS = 600
ETL_CATEGORIES = ("GO Molecular Function", "GO Biological Process",
                  "GO Cellular Component")
ETL_SEED = 18
ETL_MIN_RECORDS = 100     # create-h5's default --min-records


def write_uniref_corpus(root: str, n: int, seed: int) -> dict:
    """A seeded UniRef90-shaped corpus under `root`: `go.txt` (OBO, a
    3-level DAG of ETL_GO_TERMS terms: a root, 39 children, the rest
    grandchildren), `uniref90.xml.gz` (n entries in UniRef90's element
    layout, 0-7 GO terms each among the grandchildren, every 97th also
    an id the ontology lacks) and `uniref90.fasta` (the representatives, lengths
    lognormal with a median of ~245 residues, wrapped at 60 columns).
    Returns their paths."""
    import gzip

    from proteinbert_tpu_torch.data.vocab import ALPHABET

    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(root, v) for k, v in (
        ("go", "go.txt"), ("xml", "uniref90.xml.gz"),
        ("fasta", "uniref90.fasta"))}
    with open(paths["go"], "w") as f:
        for i in range(1, ETL_GO_TERMS + 1):
            f.write(f"[Term]\nid: GO:{i:07d}\nname: term{i}\n"
                    "namespace: molecular_function\n")
            parent = 1 if i <= 40 else 2 + i % 39
            if i > 1:
                f.write(f"is_a: GO:{parent:07d} ! term{parent}\n")
            f.write("\n")
    lengths = np.clip(rng.lognormal(5.5, 0.6, n), 30, 2000).astype(np.int64)
    letters = np.frombuffer("".join(ALPHABET[:20]).encode(), np.uint8)
    residues = letters[rng.integers(0, 20, int(lengths.sum()))].tobytes()
    n_go = rng.integers(0, 8, n)
    terms = rng.integers(41, ETL_GO_TERMS + 1, int(n_go.sum()))
    tax = rng.integers(1, 99999, n)
    ends = np.cumsum(lengths)
    go_ends = np.cumsum(n_go)
    with gzip.open(paths["xml"], "wt", compresslevel=1) as xf, \
            open(paths["fasta"], "w") as ff:
        xf.write('<?xml version="1.0" encoding="ISO-8859-1"?>\n'
                 '<UniRef90 xmlns="http://uniprot.org/uniref" '
                 'releaseDate="2026-01-01">\n')
        for p in range(n):
            acc = f"P{p:07d}"
            seq = residues[ends[p] - lengths[p]:ends[p]].decode()
            ff.write(f">UniRef90_{acc} cluster member\n")
            ff.write("".join(seq[j:j + 60] + "\n"
                             for j in range(0, len(seq), 60)))
            props = "".join(
                f'        <property type="{ETL_CATEGORIES[int(g) % 3]}" '
                f'value="GO:{int(g):07d}"/>\n'
                for g in terms[go_ends[p] - n_go[p]:go_ends[p]])
            if p % 97 == 0:
                props += ('        <property type="GO Molecular Function" '
                          'value="GO:9999999"/>\n')
            xf.write(
                f'  <entry id="UniRef90_{acc}" updated="2026-01-01">\n'
                f'    <name>Cluster: protein {acc}</name>\n'
                f'    <representativeMember>\n'
                f'      <dbReference type="UniProtKB ID" id="{acc}_SYNTH">\n'
                f'        <property type="NCBI taxonomy" '
                f'value="{int(tax[p])}"/>\n'
                f'{props}'
                f'      </dbReference>\n'
                f'      <sequence length="{int(lengths[p])}">IGNORED'
                f'</sequence>\n'
                f'    </representativeMember>\n'
                f'  </entry>\n')
        xf.write("</UniRef90>\n")
    return paths


def sqlite_rows(path: str) -> dict:
    """Every table of a SQLite file, its rows sorted (the files' bytes
    are not stable; their rows are)."""
    import sqlite3

    conn = sqlite3.connect(path)
    try:
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        return {t: sorted(conn.execute(f"SELECT * FROM {t}")) for t in tables}
    finally:
        conn.close()


# A corpus verb as `python -m proteinbert_tpu_torch` runs it, then, at
# exit, its own peak RSS: VmHWM of the memory map exec gave it, or where
# /proc has no VmHWM the largest resident size /proc/self/statm showed,
# sampled every 10 ms (rusage would also count the pages of this process,
# which the child maps between fork and exec).
ETL_BOOT = """\
import atexit, os, runpy, sys, threading, time

peak = [0]

def sample():
    page_kb = os.sysconf("SC_PAGE_SIZE") // 1024
    while True:
        try:
            with open("/proc/self/statm") as f:
                peak[0] = max(peak[0], int(f.read().split()[1]) * page_kb)
        except (OSError, ValueError, IndexError):
            return
        time.sleep(0.01)

def report():
    try:
        with open("/proc/self/status") as f:
            hwm = [ln.split()[1] for ln in f if ln.startswith("VmHWM:")]
    except OSError:
        hwm = []
    how = ("VmHWM", hwm[0]) if hwm else ("statm", peak[0] or "none")
    print("# peak RSS kB (%s) %s" % how, file=sys.stderr)

threading.Thread(target=sample, daemon=True).start()
atexit.register(report)
sys.argv[0] = "proteinbert_tpu_torch"
runpy.run_module("proteinbert_tpu_torch", run_name="__main__",
                 alter_sys=True)
"""


def etl_verb(root: str, label: str, argv) -> "subprocess.Popen":
    """A corpus verb (no --device: they touch no tensor), started now, its
    output into `<root>/<label>.log`."""
    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, label + ".log"), "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", ETL_BOOT, *map(str, argv)], cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo), stdout=log,
            stderr=subprocess.STDOUT)
    proc.t0, proc.label = time.perf_counter(), label
    proc.log = os.path.join(root, label + ".log")
    return proc


def etl_wait(proc) -> tuple:
    """(seconds from spawn to exit, (peak RSS MB, how it was read) or
    None) of a corpus verb; fails the phase on a non-zero exit."""
    try:
        proc.wait(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        check(False, f"etl {proc.label}: did not exit within {CLI_TIMEOUT} s")
    seconds = time.perf_counter() - proc.t0
    said = open(proc.log).read()
    check(proc.returncode == 0,
          f"etl {proc.label}: exit {proc.returncode}: {said[-2000:]}")
    kb = re.findall(r"# peak RSS kB \((\w+)\) (\d+)", said)
    return seconds, (int(kb[-1][1]) / 1024, kb[-1][0]) if kb else None


def mb(peak) -> str:
    return "not measured" if peak is None else f"{peak[0]:.0f} MB ({peak[1]})"


def etl_phase(card: str) -> dict:
    """Phase 12 (module docstring): the corpus tools on ETL_ENTRIES
    entries, the C++ tokenizer against numpy on every row, data-bench, and
    6 base-width steps on the corpus rows; returns each kernel's launches
    in those steps."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="etl_", dir=build)
    try:
        return etl_run(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def etl_run(card: str, root: str) -> dict:
    from proteinbert_tpu_torch import native
    from proteinbert_tpu_torch.data.dataset import (
        HDF5PretrainingDataset, InMemoryPretrainingDataset,
        make_pretrain_iterator,
    )
    from proteinbert_tpu_torch.data.transforms import tokenize_batch
    from proteinbert_tpu_torch.etl import load_seqs_and_annotations
    from proteinbert_tpu_torch.etl.fasta import build_index
    from proteinbert_tpu_torch.etl.go_ontology import load_meta_csv
    from proteinbert_tpu_torch.kernels import ATTENTION, LOCAL_TRACK
    from proteinbert_tpu_torch.native import build as native_build

    n = ETL_ENTRIES
    # (a) the native libraries, with this machine's g++.
    gxx = subprocess.run([native_build._CXX, "--version"],
                         capture_output=True, text=True, timeout=60)
    built = []
    for name in ("tokenizer", "fasta_index"):
        # A build of its own (the package's may be cached from an earlier
        # phase), with load_library's command, timed.
        t0 = time.perf_counter()
        cc = subprocess.run(
            [native_build._CXX, *native_build._FLAGS, os.path.join(
                native_build._SRC_DIR, name + ".cpp"), "-o",
             os.path.join(root, name + ".so")],
            capture_output=True, text=True, timeout=120)
        built.append(f"{name} {time.perf_counter() - t0:.2f} s")
        check(cc.returncode == 0 and native.native_available(name),
              f"etl base: the native {name} library did not build with "
              f"{native_build._CXX}: {cc.stderr[-2000:]}")
    print(f"# etl base native [{card}]: {gxx.stdout.splitlines()[0]}; "
          f"builds: {', '.join(built)}; native_available() True for both")
    # A verb's start-up (`--help`), beside (b), which runs in this process.
    help_proc = etl_verb(root, "help", ["--help"])

    # (b) the corpus.
    t0 = time.perf_counter()
    paths = write_uniref_corpus(root, n, ETL_SEED)
    gen_s = time.perf_counter() - t0
    boot_s, boot_rss = etl_wait(help_proc)
    print(f"# etl base start-up [{card}]: python -m proteinbert_tpu_torch "
          f"--help {boot_s:.2f} s from spawn, peak RSS {mb(boot_rss)} "
          f"(the verbs' times below include it; 'net' takes it out)")

    def rate(seconds):
        net = (f"{n / (seconds - boot_s):.0f} net" if seconds > boot_s
               else "within the start-up")
        return f"{seconds:.2f} s, {n / seconds:.0f} entries/s from spawn, {net}"
    sizes = {k: os.path.getsize(v) / 2**20 for k, v in paths.items()}
    print(f"# etl base corpus [{card}]: {n} entries, {ETL_GO_TERMS} GO "
          f"terms, written in {gen_s:.1f} s ({n / gen_s:.0f} entries/s); "
          f"xml.gz {sizes['xml']:.1f} MiB, fasta {sizes['fasta']:.1f} MiB")

    # (c) two task-array shards together, their merge, one shard alone.
    db = os.path.join(root, "uniref.db")
    one_db = os.path.join(root, "one.db")
    one_meta = os.path.join(root, "one_meta.csv")
    parse = ["create-uniref-db", "--uniref-xml", paths["xml"], "--go-meta",
             paths["go"], "--output-db"]
    shards = [etl_wait(p) for p in [
        etl_verb(root, f"shard{k}", parse + [db, "--task-count", 2,
                                             "--task-index", k])
        for k in (0, 1)]]
    meta = os.path.join(root, "go_meta.csv")
    merge_s, merge_rss = etl_wait(etl_verb(root, "merge", [
        "merge-uniref-dbs", "--output-db", db, "--num-shards", 2,
        "--go-meta", paths["go"], "--go-meta-csv", meta]))
    one_s, one_rss = etl_wait(etl_verb(root, "one", parse + [
        one_db, "--go-meta-csv", one_meta]))
    merged, alone = sqlite_rows(db), sqlite_rows(one_db)
    same_meta = open(meta).read() == open(one_meta).read()
    check(merged == alone and same_meta and
          len(alone["protein_annotations"]) == n,
          f"etl base: merged shards vs one shard: tables "
          f"{ {t: len(r) for t, r in merged.items()} } vs "
          f"{ {t: len(r) for t, r in alone.items()} }, equal "
          f"{merged == alone}, meta CSV equal {same_meta}")
    stats = dict(alone["etl_stats"])
    wall = max(s for s, _ in shards)
    print(f"# etl base create-uniref-db [{card}]: two task-array shards "
          f"together {rate(wall)} (peak RSS "
          f"{', '.join(mb(r) for _, r in shards)}); merge-uniref-dbs "
          f"{rate(merge_s)} ({mb(merge_rss)}); one shard alone "
          f"{rate(one_s)} ({mb(one_rss)}); every table's rows and the meta "
          f"CSV equal; {stats}")

    # (d) the .fai, C++ and Python.
    fai = {}
    for label, use_native in (("C++", True), ("Python", False)):
        calls = native.calls["fasta_index"]
        t0 = time.perf_counter()
        out = build_index(paths["fasta"], os.path.join(root, f"{label}.fai"),
                          use_native=use_native)
        fai[label] = (time.perf_counter() - t0, open(out, "rb").read())
        check((native.calls["fasta_index"] > calls) == use_native,
              f"etl base fai {label}: native calls {calls} -> "
              f"{native.calls['fasta_index']}")
    check(fai["C++"][1] == fai["Python"][1]
          and fai["C++"][1].count(b"\n") == n,
          f"etl base: the .fai differs between C++ and Python "
          f"({len(fai['C++'][1])} vs {len(fai['Python'][1])} bytes)")
    print(f"# etl base fai [{card}]: C++ {fai['C++'][0]:.3f} s "
          f"({n / fai['C++'][0]:.0f} entries/s), Python "
          f"{fai['Python'][0]:.3f} s ({n / fai['Python'][0]:.0f} "
          f"entries/s), {len(fai['C++'][1])} bytes identical")
    os.replace(os.path.join(root, "C++.fai"), paths["fasta"] + ".fai")

    # (e) the HDF5 file where h5py imports; the join in memory always.
    t0 = time.perf_counter()
    common = sorted((r for r in load_meta_csv(meta)
                     if r["count"] >= ETL_MIN_RECORDS), key=lambda r: r["id"])
    column = {r["index"]: i for i, r in enumerate(common)}
    join_stats = {}
    ids, seqs, cols = [], [], []
    for uid, seq, idx in load_seqs_and_annotations(
            db, paths["fasta"], shuffle=True, seed=0, verbose=False,
            stats=join_stats):
        ids.append(uid)
        seqs.append(seq)
        cols.append([column[i] for i in idx if i in column])
    masks = np.zeros((len(ids), len(common)), bool)
    for r, c in enumerate(cols):
        masks[r, c] = True
    join_s = time.perf_counter() - t0
    check(join_stats == {"n_yielded": n, "n_unjoinable": 0},
          f"etl base join: {join_stats}")
    try:
        import h5py
    except ImportError:
        h5py = None
    h5 = None
    if h5py is None:
        print(f"# etl base create-h5 [{card}]: h5py is not installed on "
              f"this machine, so create-h5 cannot run; the join "
              f"(load_seqs_and_annotations into the {len(common)} common "
              f"annotation columns, as create_h5_dataset maps them) fills "
              f"an InMemoryPretrainingDataset with the same rows: {n} rows "
              f"in {join_s:.2f} s ({n / join_s:.0f} entries/s)")
    else:
        h5 = os.path.join(root, "corpus.h5")
        h5_s, h5_rss = etl_wait(etl_verb(root, "h5", [
            "create-h5", "--db", db, "--fasta", paths["fasta"],
            "--go-meta-csv", meta, "--output", h5]))
        with h5py.File(h5, "r") as f:
            same = ([x.decode() for x in f["uniprot_ids"][:]] == ids
                    and [x.decode() for x in f["seqs"][:]] == seqs
                    and np.array_equal(f["annotation_masks"][:], masks))
        check(same, "etl base: the HDF5 file's rows differ from the join")
        print(f"# etl base create-h5 [{card}]: {rate(h5_s)} (peak RSS "
              f"{mb(h5_rss)}), "
              f"{len(common)} annotation columns; the join in memory "
              f"{join_s:.2f} s, the same rows")

    # (f) every row through both tokenizers.
    rows = np.arange(n, dtype=np.int64)
    calls = native.calls["tokenizer"]
    t0 = time.perf_counter()
    got = tokenize_batch(seqs, 512, crop_seed=ETL_SEED, row_ids=rows)
    native_ms = (time.perf_counter() - t0) * 1e3
    moved = native.calls["tokenizer"] - calls
    t0 = time.perf_counter()
    want = tokenize_batch(seqs, 512, crop_seed=ETL_SEED, row_ids=rows,
                          use_native=False)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    check(moved == 1 and native.calls["tokenizer"] == calls + 1
          and np.array_equal(got, want),
          f"etl base tokenize: native calls moved {moved}, bit for bit "
          f"{np.array_equal(got, want)}")
    cropped = int(sum(len(s) > 510 for s in seqs))
    print(f"# etl base tokenize [{card}]: {n} rows at seq_len 512, crop "
          f"seed {ETL_SEED} ({cropped} rows cropped): C++ {native_ms:.1f} "
          f"ms, numpy {numpy_ms:.1f} ms ({numpy_ms / native_ms:.1f}x), bit "
          f"for bit; native tokenizer calls {calls} -> "
          f"{native.calls['tokenizer']}")

    # (g) data-bench --preset base.
    bench = ["data-bench", "--preset", "base", "--batches", 200]
    bench_s, bench_rss = etl_wait(etl_verb(
        root, "bench", bench + (["--data", h5] if h5 else [])))
    lines = [json.loads(ln) for ln in open(os.path.join(root, "bench.log"))
             if ln.startswith("{")]
    check([ln["variant"] for ln in lines] == ["direct", "prefetch"],
          f"etl base data-bench: {lines}")
    feed = "the corpus HDF5 file" if h5 else (
        "the synthetic feed (no h5py here, so no HDF5 file to read)")
    print(f"# etl base data-bench [{card}]: --preset base (B=128, "
          f"seq_len 512) on {feed}: " + "; ".join(
              f"{ln['variant']} {ln['batches_per_sec']} batches/s "
              f"{ln['residues_per_sec']} residues/s over {ln['batches']} "
              f"batches" for ln in lines)
          + f"; {bench_s:.1f} s from spawn, peak RSS {mb(bench_rss)}")

    # (h) base-width steps from the corpus rows.
    calls = native.calls["tokenizer"]
    if h5:
        ds = HDF5PretrainingDataset(h5, 512, crop_seed=ETL_SEED + 1)
    else:
        ds = InMemoryPretrainingDataset(seqs, masks, 512,
                                        crop_seed=ETL_SEED + 1)
    base = train_preset("base", 8, 512, 6)
    cfg = base.replace(model=dataclasses.replace(
        base.model, num_annotations=len(common)))
    gc.collect()
    torch.cuda.empty_cache()
    out, walls, total, peak, _, _ = train_run(
        card, "etl base", cfg, 6, {LOCAL_TRACK.name: 6, ATTENTION.name: 6},
        (0, 0), ETL_SEED, source=lambda: make_pretrain_iterator(
            ds, 8, seed=ETL_SEED))
    feed_calls = native.calls["tokenizer"] - calls
    check(feed_calls > 0, "etl base train: the feed never ran the C++ "
                          "tokenizer")
    losses = [h["loss"] for h in out["history"]]
    check(all(np.isfinite(losses)), f"etl base train: losses {losses}")
    print(f"# etl base train [{card}]: 6 steps B=8 L=512 from the corpus "
          f"rows ({'HDF5' if h5 else 'in memory'}, {len(common)} "
          f"annotations), exactly 6 K1 + 6 K2 launches a step, losses "
          f"{[round(x, 4) for x in losses]}, median step "
          f"{statistics.median(walls[1:]):.1f} ms, peak "
          f"{peak / 2**30:.2f} GB; native tokenizer calls in the feed "
          f"{feed_calls}")
    return total

CHECK_STEPS = 6
# K2's launch wrapper's first statement, and its entries' route.
CHECK_CLOCK_AT = "    check_attention_shapes(params, local, global_seg, ids)"
CHECK_ROUTE_AT = "def _attention_ids("


def check_verb(cwd: str) -> "subprocess.Popen":
    """`python -m proteinbert_tpu_torch check --json` in `cwd`, on that
    tree's own package, started now."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "proteinbert_tpu_torch", "check", "--json"],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=cwd), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    proc.t0 = time.perf_counter()
    return proc


def check_wait(proc, label: str) -> tuple:
    """(exit code, the report, seconds from spawn) of a `check_verb`."""
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"check {label}: did not exit within {CLI_TIMEOUT} s")
    wall = time.perf_counter() - proc.t0
    try:
        report = json.loads(out)
    except ValueError:
        report = None
    check(report is not None, f"check {label}: exit {proc.returncode}, no "
                              f"JSON report: {out[-2000:]} {err[-2000:]}")
    return proc.returncode, report, wall


def inject_violations(root: str) -> set:
    """A host clock in K2's launch wrapper and a try/except that falls
    back to K2's plain version in its route, written into the copy of
    `kernels/attention.py` under `root`; returns the (rule, path, line)
    findings the analyzer must give for them."""
    rel = "proteinbert_tpu_torch/kernels/attention.py"
    path = os.path.join(root, rel)
    lines = open(path).read().split("\n")
    i = lines.index(CHECK_CLOCK_AT)
    lines.insert(i, "    _t0 = time.perf_counter()")
    clock = i + 1
    start = next(k for k, ln in enumerate(lines)
                 if ln.startswith(CHECK_ROUTE_AT))
    j = lines.index('    if local.device.type == "cpu":', start)
    lines[j:j] = [
        "    try:",
        "        check_attention_shapes(params, local, global_seg, ids)",
        "    except ValueError:",
        "        return _ids_reference(params, local, global_seg, ids, "
        "zero_empty)"]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return {("graph-purity", rel, clock), ("graph-purity", rel, j + 3),
            ("graph-purity", rel, j + 4)}


def check_phase(card: str) -> dict:
    """Phase 13 (module docstring): the `check` verb on this tree and on
    an injected copy, then 6 base steps under the profiling helpers and
    the memory reports; returns each kernel's launches in those steps."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="check_", dir=build)
    try:
        return check_run(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_run(card: str, root: str) -> dict:
    from proteinbert_tpu_torch.kernels import ATTENTION, LOCAL_TRACK
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.utils import (
        BoundaryStallMeter, Profiler, TimeMeasure, device_memory_report,
        monitor_memory,
    )

    repo = os.path.dirname(os.path.abspath(__file__))
    six = {"graph-purity", "lock-discipline", "durability-protocol",
           "event-schema", "obs-doc-drift", "dead-export"}
    # (a) the verb on this tree, and (b) on a copy with two violations
    # injected, the two processes side by side.
    copy = os.path.join(root, "tree")
    ignore = shutil.ignore_patterns("__pycache__", "_build", "*.so")
    for name in ("proteinbert_tpu_torch", "tests"):
        shutil.copytree(os.path.join(repo, name), os.path.join(copy, name),
                        ignore=ignore)
    os.makedirs(os.path.join(copy, "docs"))
    for name in ("chip_smoke.py", "docs/observability.md"):
        shutil.copy(os.path.join(repo, name), os.path.join(copy, name))
    want = inject_violations(copy)
    procs = [check_verb(repo), check_verb(copy)]
    rc, report, wall = check_wait(procs[0], "tree")
    check(rc == 0 and report["ok"] and report["findings"] == []
          and report["stale_baseline"] == [] and report["errors"] == []
          and set(report["rules"]) == six,
          f"check tree: exit {rc}, findings {report['findings']}, stale "
          f"{report['stale_baseline']}, errors {report['errors']}, rules "
          f"{report['rules']}")
    print(f"# check base verb [{card}]: python -m proteinbert_tpu_torch "
          f"check --json on this tree: exit 0, rules "
          f"{sorted(report['rules'])}, 0 new, "
          f"{report['counts']['baselined']} baselined, 0 stale; wall "
          f"{wall:.2f} s from spawn, analysis {report['seconds']:.2f} s "
          f"(start-up and imports {wall - report['seconds']:.2f} s; the "
          f"injected copy's verb ran beside it)")
    rc, report, wall = check_wait(procs[1], "injected")
    got = {(f["rule"], f["path"], f["line"]) for f in report["findings"]}
    check(rc == 1 and got == want,
          f"check injected: exit {rc}, findings {sorted(got)}, want "
          f"{sorted(want)}")
    print(f"# check base injected [{card}]: a clock in _attention_launch "
          f"and an except falling back to _ids_reference in "
          f"_attention_ids: exit 1, exactly the graph-purity findings "
          + ", ".join(f"attention.py:{f['line']} {f['symbol']}"
                      for f in sorted(report["findings"],
                                      key=lambda f: f["line"]))
          + f"; wall {wall:.2f} s, analysis {report['seconds']:.2f} s")
    # (c) base steps under the profiling helpers, then the memory reports.
    prof, meter = Profiler(), BoundaryStallMeter()
    cfg = train_preset("base", 8, 512, CHECK_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    with TimeMeasure("check base steps", verbose=False) as tm:
        with prof.measure("pretrain"):
            out, walls, total, peak, _, _ = train_run(
                card, "check base", cfg, CHECK_STEPS,
                {LOCAL_TRACK.name: 6, ATTENTION.name: 6}, (100, 510), 13)
    print(f"# check base steps [{card}]: {CHECK_STEPS} steps B=8 L=512, "
          f"exactly 6 K1 + 6 K2 launches a step; TimeMeasure "
          f"{tm.elapsed:.3f} s, Profiler {prof.report()}; median step "
          f"{statistics.median(walls[1:]):.1f} ms, peak "
          f"{peak / 2**30:.2f} GB")
    torch.cuda.synchronize()
    with meter.boundary():
        mem = device_memory_report()
    allocated = torch.cuda.memory_allocated(0)
    peak_alloc = torch.cuda.max_memory_allocated(0)
    limit = torch.cuda.get_device_properties(0).total_memory
    entry = mem.get("cuda:0", {})
    check(list(mem) == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
          and entry.get("bytes_in_use") == allocated
          and entry.get("peak_bytes_in_use") == peak_alloc
          and entry.get("bytes_limit") == limit,
          f"check base: device_memory_report {entry.get('bytes_in_use')} / "
          f"{entry.get('peak_bytes_in_use')} / {entry.get('bytes_limit')} "
          f"vs torch.cuda {allocated} / {peak_alloc} / {limit}")
    largest = max(tree_leaves(out["state"].params), key=lambda t: t.nbytes)
    want = (type(largest).__name__, largest.nbytes)
    with meter.boundary():
        found = monitor_memory(threshold_bytes=largest.nbytes, verbose=False)
    check(want in found, f"check base: monitor_memory found {found[:8]}, "
                         f"not the largest weight {want}")
    stalls = meter.summary()
    print(f"# check base memory [{card}]: device_memory_report cuda:0 "
          f"bytes_in_use {allocated}, peak_bytes_in_use {peak_alloc}, "
          f"bytes_limit {limit} = torch.cuda's; monitor_memory found the "
          f"largest weight ({want[0]} {tuple(largest.shape)} "
          f"{largest.dtype}, {want[1]} bytes) among {len(found)} buffers "
          f"of at least its size; boundary stalls: report "
          f"{meter.stalls[0] * 1e3:.3f} ms, walker "
          f"{meter.stalls[1] * 1e3:.1f} ms (max {stalls['max_s']:.3f} s)")
    return total


# The mesh phase: `large` widths on ranks spawned on the one card, over
# gloo (as the data phase's two ranks).
MESH_STEPS = 3
MESH_RANK_TIMEOUT = 720   # seconds for the spawn of every leg, start-up included
MESH_FP32_TOL = 2e-5      # float32 losses against the one-process loop (rel)
MESH_BF16_TOL = 5e-3      # bf16 losses against the one-process loop (rel)
MESH_STATE_MARGIN = (0.03, 256 << 20)   # (share, bytes) over the rule's
# A constant LR of a tenth of `large`'s peak: at the peak (2e-4) from
# step 0, without its warmup, a bf16 Large run's loss climbs (4.50, 4.85,
# 5.91) and amplifies the rounding of the split GO head into the losses.
MESH_LR = 2e-5
# The bf16 legs' depth: 3 of `large`'s 12 blocks (as the resume phase's
# `RESUME_LARGE_BLOCKS`), a cut for the full run's time: the model=3 leg
# ran at 6 since PR 20, the fsdp, quantized and seq fsdp legs at 12 until
# PR 24 (PERF.md §4).
MESH_BLOCKS = 3
MESH_IDENTITY = dict(token_randomize_prob=0.0, annotation_corrupt_prob=1.0,
                     annotation_drop_prob=0.0, annotation_add_prob=0.0)


def mesh_cfg(mesh: dict, dtype: str = "bfloat16", blocks: int = MESH_BLOCKS,
             identity: bool = False):
    """`large` at B=8 L=1024, the constant MESH_LR from step 0, `blocks`
    blocks (full depth: 12), on `mesh`; `identity` turns the corruption
    off (the runs compared with one process draw alike then)."""
    from proteinbert_tpu_torch.configs import MeshConfig

    cfg = train_preset("large", 8, 1024, MESH_STEPS)
    data = dataclasses.replace(cfg.data, prefetch_depth=0,
                               **(MESH_IDENTITY if identity else {}))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dtype=dtype, num_blocks=blocks),
        data=data, mesh=MeshConfig(**mesh),
        optimizer=dataclasses.replace(cfg.optimizer, schedule="constant",
                                      learning_rate=MESH_LR, warmup_steps=0))


def mesh_batches(cfg, seed: int) -> list:
    """The run's global batches, the same in every process."""
    from proteinbert_tpu_torch.data.dataset import (
        InMemoryPretrainingDataset, make_pretrain_iterator,
    )

    B, L = cfg.data.batch_size, cfg.data.seq_len
    seqs, ann = synthetic_proteins(4 * B, min(100, L // 2), L - 2,
                                   cfg.model.num_annotations, seed)
    it = make_pretrain_iterator(InMemoryPretrainingDataset(seqs, ann, L), B,
                                seed=seed)
    return [next(it) for _ in range(cfg.train.max_steps)]


def deterministic(on: bool = True) -> None:
    """cuDNN's deterministic algorithms (two runs on the same rows repeat
    each other; the default conv backward does not on the H100), or its
    defaults; never its benchmark search."""
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(on, warn_only=True)


def mesh_train(cfg, batches, mesh=None, checkpointer=None):
    """`pretrain` on this process's rows of `batches` (its replica's, on a
    mesh) → (the out dict, per-step (wall ms, loss, launches by kernel,
    memory_allocated after the step), the telemetry, the run's peak
    memory_allocated)."""
    from proteinbert_tpu_torch.kernels import KERNELS
    from proteinbert_tpu_torch.obs import Telemetry
    from proteinbert_tpu_torch.train.trainer import pretrain

    i, n = (0, 1) if mesh is None else (mesh.data_index, mesh.data_extent)
    rows = [{k: v[i * len(v) // n:(i + 1) * len(v) // n]
             for k, v in b.items()} for b in batches]
    marks = []

    def log_fn(step, m):
        marks.append((time.perf_counter(), m["loss"],
                      {k.name: k.launches for k in KERNELS},
                      torch.cuda.memory_allocated()))

    tele = Telemetry()
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pretrain(cfg, lambda skip: iter(rows[skip:]), device=DEVICE,
                   mesh=mesh, checkpointer=checkpointer, telemetry=tele,
                   log_fn=log_fn)
    steps, prev_t, prev = [], t0, {k.name: 0 for k in KERNELS}
    for t, loss, counts, alloc in marks:
        steps.append(((t - prev_t) * 1e3, loss,
                      {k: counts[k] - prev[k] for k in counts}, alloc))
        prev_t, prev = t, counts
    return out, steps, tele, torch.cuda.max_memory_allocated()


def replicated_digest(state) -> str:
    """A digest of this rank's stored tensors that the model axis does not
    shard (the ones every model rank must hold bit for bit)."""
    import hashlib

    from proteinbert_tpu_torch.train.schedule import tree_leaves

    h = hashlib.sha256()
    lay = state.layout
    for t, p in zip(tree_leaves(state.params), lay.plans):
        if not (p.store and p.store[0] == "model"):
            h.update(t.detach().float().cpu().numpy().tobytes())
    for i, t in enumerate(state.opt_state.mu):
        p = lay.plans[i]
        if not (p.store and p.store[0] == "model"):
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


# The mesh phase's legs, in the order one spawn of max(world) processes
# runs them: (leg, ranks, mesh axes).
MESH_LEGS = (("fsdp", 2, {"fsdp": 2}), ("model", 3, {"model": 3}),
             ("seqfsdp", 4, {"fsdp": 2, "seq": 2}),
             ("seqmodel", 6, {"model": 3, "seq": 2}))


def mesh_rank(rank: int, out: str, device: str) -> None:
    """One process of the mesh phase's spawn: for each leg of MESH_LEGS
    in turn, the processes below the leg's rank count join the leg's own
    gloo group (a FileStore of its own) and run it (`mesh_leg`); the
    others go on to the next leg's rendezvous. One start-up serves every
    leg. Writes `<out>/<leg><rank>.json` for each leg it ran."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    global DEVICE
    DEVICE = device
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for leg, world, axes in MESH_LEGS:
        if rank >= world:
            continue
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out, f"{leg}_store"),
                                         world),
            rank=rank, world_size=world)
        try:
            t0 = time.perf_counter()
            res = mesh_leg(leg, axes, out)
            res["wall_s"] = time.perf_counter() - t0
            with open(os.path.join(out, f"{leg}{rank}.json"), "w") as f:
                json.dump(res, f)
        finally:
            deterministic(False)
            dist.destroy_process_group()


def mesh_leg(leg: str, axes: dict, out: str) -> dict:
    """This rank's runs of `leg` on the joined group: "fsdp" ((a) bf16 at
    MESH_BLOCKS blocks, then float32 at depth 2 with a checkpoint, the
    quantized legs), "model" ((b) bf16 at MESH_BLOCKS blocks, then float32
    at depth 2), "seqfsdp" ((d) bf16 at MESH_BLOCKS blocks with the
    identity corruption, then float32 at depth 2 with a checkpoint) or
    "seqmodel"
    ((e) float32 at depth 2) → {run: its numbers}."""
    from proteinbert_tpu_torch.parallel.mesh import make_mesh
    from proteinbert_tpu_torch.parallel.zero import (
        comm_bytes, per_chip_state_bytes,
    )
    from proteinbert_tpu_torch.train import Checkpointer

    res = {}
    runs = [("bf16", mesh_cfg(axes, identity=leg == "seqfsdp")),
            ("fp32", mesh_cfg(axes, "float32", 2, True))]
    if leg == "seqmodel":
        runs = runs[1:]
    if leg == "fsdp":
        # The quantized reduce-scatter through `pretrain` (ZeRO-1 on).
        runs += [(f"q_{p}", quant_cfg(mesh_cfg(axes), p))
                 for p in ("int8", "bf16")]
    for name, cfg in runs:
        deterministic(name == "fp32" or leg == "model")
        mesh = make_mesh(cfg.mesh)
        ck = None
        if name == "fp32" and leg in ("fsdp", "seqfsdp"):
            cfg = cfg.replace(checkpoint=dataclasses.replace(
                cfg.checkpoint, every_steps=2, async_save=False))
            ck = Checkpointer(os.path.join(out, f"ck_{leg}"),
                              async_save=False, mesh=mesh)
        run, steps, tele, peak = mesh_train(cfg, mesh_batches(cfg, 14),
                                            mesh, ck)
        if ck is not None:
            ck.close()
        state = run["state"]
        byte_out, wire = comm_bytes(tele.metrics)
        rules = per_chip_state_bytes(
            mesh, state, zero_update=cfg.parallel.zero_update)
        res[name] = {
            "steps": steps, "wire": wire, "out_bytes": byte_out,
            "peak": peak,
            "per_chip": rules,
            "whole": per_chip_state_bytes(single_mesh(), state),
            "stored": sum(t.nbytes for t in
                          tree_tensors(state.params)
                          + list(state.opt_state.mu)
                          + list(state.opt_state.nu)
                          + list((state.opt_state.plateau
                                  or {}).values())),
            "tp_cols": (None if state.layout.tp is None
                        else state.layout.tp.cols),
            "digest": replicated_digest(state)}
        del run, state, ck
        gc.collect()
        torch.cuda.empty_cache()
    if leg == "fsdp":
        deterministic(True)
        res["quant2"] = quant_depth2(mesh_cfg(axes, "float32", 2, True))
    return res


def quant_cfg(cfg, payload: str):
    """`cfg` with ZeRO-1 and the quantized gradient reduction."""
    return cfg.replace(parallel=dataclasses.replace(
        cfg.parallel, zero_update=True, grad_reduce_dtype=payload))


def quant_depth2(cfg) -> dict:
    """Two float32 steps at depth 2 from one seed on this rank's rows,
    with the JAX quantization test's optimizer (LR 0, then 1e-4), of the
    fp32 sharded step (the reference) and of the quantized step at each
    payload: each payload's max |param - reference| over the gathered
    params, the reference's own max update, each step's gradient norm
    (the quantized steps': of the dequantized sum), each leaf's
    ||mu - mu_ref|| / ||mu_ref|| over the gathered first moments (linear
    in the reduced gradients: step 1 leaves the params), the losses, the
    gradient-reduction wire bytes and the launches."""
    from proteinbert_tpu_torch.kernels import KERNELS
    from proteinbert_tpu_torch.obs.metrics import MetricsRegistry
    from proteinbert_tpu_torch.parallel.fsdp import make_sharded_train_step
    from proteinbert_tpu_torch.parallel.mesh import make_mesh
    from proteinbert_tpu_torch.parallel.quant import (
        make_quant_fsdp_train_step,
    )
    from proteinbert_tpu_torch.parallel.zero import (
        comm_bytes, grad_reduce_wire_bytes,
    )
    from proteinbert_tpu_torch.train.schedule import tree_leaves
    from proteinbert_tpu_torch.train.train_state import create_train_state

    cfg = quant_cfg(cfg.replace(
        optimizer=dataclasses.replace(cfg.optimizer,
                                      schedule="warmup_plateau",
                                      learning_rate=1e-3, warmup_steps=10),
        train=dataclasses.replace(cfg.train, max_steps=2)), "int8")
    mesh = make_mesh(cfg.mesh)
    i, n = mesh.data_index, mesh.data_extent
    rows = [{k: v[i * len(v) // n:(i + 1) * len(v) // n]
             for k, v in b.items()} for b in mesh_batches(cfg, 14)]
    init = create_train_state(torch.Generator().manual_seed(14), cfg,
                              device=DEVICE)
    start = [t.clone() for t in tree_leaves(init.params)]
    out, ref = {}, None
    for name in ("ref", "fp32", "bf16", "int8"):
        reg = MetricsRegistry()
        step = (make_sharded_train_step(mesh, cfg.replace(
            parallel=dataclasses.replace(cfg.parallel, zero_update=False,
                                         grad_reduce_dtype="fp32")), reg)
                if name == "ref" else
                make_quant_fsdp_train_step(mesh, cfg, name, reg))
        state = create_train_state(torch.Generator().manual_seed(14), cfg,
                                   device=DEVICE)
        for k in KERNELS:
            k.launches = 0
        losses, norms = [], []
        for b in rows:
            # Each step's metrics reach the host before the next starts:
            # the rows are the same on both ranks' steps.
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        launches = {k.name: k.launches for k in KERNELS if k.launches}
        whole = state.layout.full_state(state)
        full, mu = tree_leaves(whole.params), list(whole.opt_state.mu)
        if ref is None:
            ref, ref_mu = full, mu
            out["ref_update"] = max(float((a - b).abs().max())
                                    for a, b in zip(full, start))
        out[name] = {
            "losses": losses, "norms": norms, "launches": launches,
            "wire": grad_reduce_wire_bytes(comm_bytes(reg)[1]),
            "err": max(float((a - b).abs().max())
                       for a, b in zip(full, ref)),
            "mu_rel": [float((a.double() - b.double()).norm()
                             / b.double().norm())
                       for a, b in zip(mu, ref_mu)]}
        del state, whole, full, mu
        gc.collect()
    del ref, ref_mu, init, start
    torch.cuda.empty_cache()
    return out


def single_mesh():
    """A one-device layout (for the whole state's bytes)."""
    from proteinbert_tpu_torch.parallel.mesh import AXES, Mesh

    return Mesh(shape={ax: 1 for ax in AXES}, rank=0,
                coords={ax: 0 for ax in AXES})


def mesh_spawn(root: str) -> dict:
    """`mesh_rank` on as many spawned processes as the largest leg has
    ranks → {leg: each rank's results}."""
    import multiprocessing

    world = max(n for _, n, _ in MESH_LEGS)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(r, root, DEVICE))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + MESH_RANK_TIMEOUT
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(codes == [0] * world, f"mesh large: exit codes {codes}")
    return {leg: [json.load(open(os.path.join(root, f"{leg}{r}.json")))
                  for r in range(n)] for leg, n, _ in MESH_LEGS}


def mesh_phase(card: str) -> dict:
    """Phase 14 (module docstring) → each kernel's launches on the ranks
    and in the one-process loops."""
    from proteinbert_tpu_torch.kernels import ATTENTION, LOCAL_TRACK_TILED

    root = tempfile.mkdtemp(prefix="mesh_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    totals: dict = {}

    def add(launches):
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n

    per_step = {LOCAL_TRACK_TILED.name: MESH_BLOCKS,
                ATTENTION.name: MESH_BLOCKS}
    reshards: dict = {}
    try:
        t0 = time.perf_counter()
        legs = mesh_spawn(root)
        spawn_s = time.perf_counter() - t0
        fsdp, model = legs["fsdp"], legs["model"]
        print(f"# mesh large spawn [{card}]: one spawn of "
              f"{len(legs['seqmodel'])} processes ran the legs in turn, each "
              f"on its own gloo group: " + ", ".join(
                  f"{leg} {len(r)} ranks {r[0]['wall_s']:.1f} s"
                  for leg, r in legs.items()) + f"; {spawn_s:.1f} s in all")
        for leg, ranks in (("fsdp", fsdp), ("model", model)):
            for r, res in enumerate(ranks):
                for name, run in res.items():
                    if name in ("quant2", "wall_s"):
                        continue
                    for i, (_, loss, launches, _) in enumerate(run["steps"]):
                        n = (2 if name not in ("bf16", "q_int8", "q_bf16")
                             else MESH_BLOCKS)
                        want = {LOCAL_TRACK_TILED.name: n, ATTENTION.name: n}
                        got = {k: v for k, v in launches.items() if v}
                        check(got == want and np.isfinite(loss),
                              f"mesh large {leg} {name} rank {r} step "
                              f"{i + 1}: launches {got}, want {want}, "
                              f"loss {loss}")
                        add(launches)
        # (a) the fsdp share of the state on each rank (the moments at
        # their ZeRO piece on the quantized legs).
        for r, res in enumerate(fsdp):
            for name in ("bf16", "q_int8", "q_bf16"):
                a = res[name]
                want = a["per_chip"]["params"] + a["per_chip"]["opt_state"]
                allocs = [s[3] for s in a["steps"]]
                share, extra = MESH_STATE_MARGIN
                check(a["stored"] == want
                      and all(want <= x <= want * (1 + share) + extra
                              for x in allocs)
                      and want < 0.55 * a["whole"]["total"],
                      f"mesh large fsdp {name} rank {r}: stored "
                      f"{a['stored']}, allocated between steps {allocs}, "
                      f"per_chip_state_bytes {a['per_chip']}, whole "
                      f"{a['whole']}")
        a = fsdp[0]["bf16"]
        ms = [s[0] for s in a["steps"]]
        print(f"# mesh large fsdp [{card}]: fsdp=2 on two ranks of one card "
              f"over gloo, {MESH_BLOCKS} of 12 blocks C=G=1024 H=16 A=8943 "
              f"bf16, B=8 (4 a rank) L=1024, {MESH_STEPS} steps; "
              f"{MESH_BLOCKS} #2 + {MESH_BLOCKS} K2 launches a "
              f"step a rank; step ms rank 0 {[round(x, 1) for x in ms]} "
              f"(rank 1 {[round(s[0], 1) for s in fsdp[1]['bf16']['steps']]}"
              f"); losses {[round(s[1], 5) for s in a['steps']]}; state "
              f"bytes a rank: per_chip_state_bytes {a['per_chip']}, the "
              f"whole state {a['whole']['total']}, stored {a['stored']}, "
              f"memory_allocated after each step "
              f"{[s[3] for s in a['steps']]} (rank 1 "
              f"{[s[3] for s in fsdp[1]['bf16']['steps']]}), peak "
              f"{a['peak']} (rank 1 {fsdp[1]['bf16']['peak']}; the params "
              f"gathered once a step); wire bytes a "
              f"step a rank: " + ", ".join(
                  f"{k} {v / MESH_STEPS:.0f}" for k, v in a["wire"].items()
                  if v) + f"; leg {fsdp[0]['wall_s']:.1f} s")
        mesh_quant(card, fsdp, per_step, add)
        # (c) both float32 runs' step 2 resharded while this process runs
        # the one-process references.
        deterministic(True)
        cfg = mesh_cfg({"fsdp": 2}, "float32", 2, True)
        one_cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, fsdp=1))
        reshards.update((leg, reshard_start(root, one_cfg, leg))
                        for leg in ("fsdp", "seqfsdp"))
        # (a) float32 against one process on the same rows.
        batches = mesh_batches(cfg, 14)
        ref, ref_steps, _, _ = mesh_train(one_cfg, batches)
        add({k: sum(s[2][k] for s in ref_steps) for k in ref_steps[0][2]})
        got = [s[1] for s in fsdp[0]["fp32"]["steps"]]
        want = fp32_ref = [s[1] for s in ref_steps]
        worst = max(abs(x - y) / abs(y) for x, y in zip(got, want))
        check(worst <= MESH_FP32_TOL,
              f"mesh large fsdp fp32: losses {got} against one process "
              f"{want} (rel {worst})")
        print(f"# mesh large fsdp fp32 [{card}]: 2 blocks, float32, "
              f"deterministic cuDNN, identity corruption: losses {got} "
              f"against one process {want}, max rel {worst:.3g} (<= "
              f"{MESH_FP32_TOL}); one-process step ms "
              f"{[round(s[0], 1) for s in ref_steps]}, fsdp rank 0 "
              f"{[round(s[0], 1) for s in fsdp[0]['fp32']['steps']]}")
        del ref
        fsdp_fp32 = got
        # (b) the GO head split three ways; float32 against one process.
        digests = {r["bf16"]["digest"] for r in model}
        cols = {r[k]["tp_cols"] for r in model for k in ("bf16", "fp32")}
        check(len(digests) == 1 and cols == {2981},
              f"mesh large model=3: digests {digests}, columns {cols}")
        got, want = [s[1] for s in model[0]["fp32"]["steps"]], fp32_ref
        worst = max(abs(x - y) / abs(y) for x, y in zip(got, want))
        check(worst <= MESH_FP32_TOL and len(
            {r["fp32"]["digest"] for r in model}) == 1,
              f"mesh large model=3 fp32: losses {got} against one process "
              f"{want} (rel {worst}), digests "
              f"{[r['fp32']['digest'] for r in model]}")
        print(f"# mesh large model=3 fp32 [{card}]: 2 blocks, float32, "
              f"deterministic cuDNN, identity corruption, 2981 columns a "
              f"rank: losses {got} against one process {want}, max rel "
              f"{worst:.3g} (<= {MESH_FP32_TOL}); digests equal")
        cfg = mesh_cfg({"model": 3})
        ref, ref_steps, _, ref_peak = mesh_train(
            cfg.replace(mesh=dataclasses.replace(cfg.mesh, model=1)),
            mesh_batches(cfg, 14))
        add({k: sum(s[2][k] for s in ref_steps) for k in ref_steps[0][2]})
        got = [s[1] for s in model[0]["bf16"]["steps"]]
        want = [s[1] for s in ref_steps]
        worst = max(abs(x - y) / abs(y) for x, y in zip(got, want))
        check(worst <= MESH_BF16_TOL,
              f"mesh large model=3: losses {got} against one process "
              f"{want} (rel {worst})")
        b = model[0]["bf16"]
        print(f"# mesh large model=3 [{card}]: three ranks of one card over "
              f"gloo, {MESH_BLOCKS} of 12 blocks bf16 B=8 L=1024 "
              f"(every rank the 8 rows, "
              f"the default corruption: one replica's draws), "
              f"deterministic cuDNN: 2981 GO columns a rank; the replicated "
              f"leaves' digest after {MESH_STEPS} steps equal on the three "
              f"ranks; losses {got} against one process {want}, max rel "
              f"{worst:.3g} (<= {MESH_BF16_TOL}); step ms rank 0 "
              f"{[round(s[0], 1) for s in b['steps']]}, one process "
              f"{[round(s[0], 1) for s in ref_steps]}; state bytes a rank "
              f"{b['per_chip']}; peak memory_allocated rank 0 {b['peak']}, "
              f"one process {ref_peak}; wire bytes a step a rank: "
              + ", ".join(
                  f"{k} {v / MESH_STEPS:.0f}" for k, v in b["wire"].items()
                  if v) + f"; leg {model[0]['wall_s']:.1f} s")
        del ref
        seq_fp32 = mesh_seq(card, legs["seqfsdp"], legs["seqmodel"], add,
                            fsdp[0]["bf16"]["per_chip"], one_cfg, fp32_ref)
        # (c) the reshards' ends, each resumed for step 3 by one process.
        mesh_reshard(card, root, one_cfg, batches, fsdp_fp32, "fsdp",
                     reshards.pop("fsdp"))
        mesh_reshard(card, root, one_cfg, batches, seq_fp32, "seqfsdp",
                     reshards.pop("seqfsdp"))
    finally:
        for proc in reshards.values():   # left running by a failed gate
            proc.kill()
            proc.wait()
        deterministic(False)
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def mesh_seq(card: str, seqf: list, seqm: list, add, fsdp_per_chip: dict,
             one_cfg, fp32_ref: list) -> list:
    """(d), (e): the sequence-parallel step on the sharded layout through
    `pretrain` — the four ranks at fsdp=2 x seq=2 (bf16 at MESH_BLOCKS with
    the identity corruption against one process, the launch and
    state-byte gates; float32 at depth 2 against one process) and the six
    at model=3 x seq=2 (float32 at depth 2 against one process, the
    replicated leaves alike on every rank) → the fsdp x seq float32
    losses (its step 2 is resharded in `mesh_phase`)."""
    from proteinbert_tpu_torch.kernels import LOCAL_TRACK_TILED_VALID

    for leg, ranks in (("seq fsdp", seqf), ("seq model", seqm)):
        for r, res in enumerate(ranks):
            for name, run in res.items():
                if name == "wall_s":
                    continue
                want = {LOCAL_TRACK_TILED_VALID.name:
                        MESH_BLOCKS if name == "bf16" else 2}
                for i, (_, loss, launches, _) in enumerate(run["steps"]):
                    got = {k: v for k, v in launches.items() if v}
                    check(got == want and np.isfinite(loss),
                          f"mesh large {leg} {name} rank {r} step {i + 1}: "
                          f"launches {got}, want {want}, loss {loss}")
                    add(launches)
    share, extra = MESH_STATE_MARGIN
    for r, res in enumerate(seqf):
        a = res["bf16"]
        want = a["per_chip"]["params"] + a["per_chip"]["opt_state"]
        allocs = [st[3] for st in a["steps"]]
        check(a["stored"] == want and a["per_chip"] == fsdp_per_chip
              and all(want <= x <= want * (1 + share) + extra
                      for x in allocs),
              f"mesh large seq fsdp rank {r}: stored {a['stored']}, "
              f"allocated between steps {allocs}, per_chip_state_bytes "
              f"{a['per_chip']} (fsdp=2 alone: {fsdp_per_chip})")
    # (d) bf16 at MESH_BLOCKS blocks against one process on the same rows.
    cfg = mesh_cfg({"fsdp": 2, "seq": 2}, identity=True)
    ref, ref_steps, _, ref_peak = mesh_train(
        cfg.replace(mesh=one_cfg.mesh), mesh_batches(cfg, 14))
    add({k: sum(st[2][k] for st in ref_steps) for k in ref_steps[0][2]})
    del ref
    a = seqf[0]["bf16"]
    got, want = [st[1] for st in a["steps"]], [st[1] for st in ref_steps]
    worst = max(abs(x - y) / abs(y) for x, y in zip(got, want))
    check(worst <= MESH_BF16_TOL,
          f"mesh large seq fsdp: losses {got} against one process {want} "
          f"(rel {worst})")
    print(f"# mesh large seq fsdp [{card}]: fsdp=2 x seq=2 on four ranks of "
          f"one card over gloo, {MESH_BLOCKS} of 12 blocks C=G=1024 H=16 "
          f"A=8943 bf16, B=8 (4 a replica) L=1024 (512 a seq rank + 2*20 "
          f"halo rows), identity corruption, {MESH_STEPS} steps; "
          f"{MESH_BLOCKS} "
          f"{LOCAL_TRACK_TILED_VALID.name} launches a step a rank and no "
          f"other kernel; losses {got} against one process {want}, max rel "
          f"{worst:.3g} (<= {MESH_BF16_TOL}); step ms "
          + "; ".join(f"rank {r} "
                      f"{[round(st[0], 1) for st in x['bf16']['steps']]}"
                      for r, x in enumerate(seqf))
          + f"; one process {[round(st[0], 1) for st in ref_steps]}; state "
          f"bytes a rank: per_chip_state_bytes {a['per_chip']} (the fsdp=2 "
          f"leg's), stored {a['stored']}, memory_allocated after each step "
          f"{[st[3] for st in a['steps']]}, peak "
          f"{[x['bf16']['peak'] for x in seqf]} (one process {ref_peak}); "
          f"wire bytes a step a rank of the counted collectives (params, "
          f"gradients, loss masses, norm; not the halo and softmax "
          f"exchanges): " + ", ".join(
              f"{k} {v / MESH_STEPS:.0f}" for k, v in a["wire"].items()
              if v) + f"; leg {seqf[0]['wall_s']:.1f} s")
    # float32 at depth 2 against one process, then resharded and resumed.
    got = [st[1] for st in seqf[0]["fp32"]["steps"]]
    worst = max(abs(x - y) / abs(y) for x, y in zip(got, fp32_ref))
    check(worst <= MESH_FP32_TOL
          and all([st[1] for st in x["fp32"]["steps"]] == got for x in seqf),
          f"mesh large seq fsdp fp32: losses "
          f"{[[st[1] for st in x['fp32']['steps']] for x in seqf]} against "
          f"one process {fp32_ref} (rel {worst})")
    print(f"# mesh large seq fsdp fp32 [{card}]: 2 blocks, float32, "
          f"deterministic cuDNN, identity corruption: losses {got} against "
          f"one process {fp32_ref}, max rel {worst:.3g} (<= "
          f"{MESH_FP32_TOL}); step ms rank 0 "
          f"{[round(st[0], 1) for st in seqf[0]['fp32']['steps']]}")
    seq_fp32 = got
    # (e) model=3 x seq=2, float32 at depth 2.
    digests = {x["fp32"]["digest"] for x in seqm}
    cols = {x["fp32"]["tp_cols"] for x in seqm}
    got = [st[1] for st in seqm[0]["fp32"]["steps"]]
    worst = max(abs(x - y) / abs(y) for x, y in zip(got, fp32_ref))
    check(worst <= MESH_FP32_TOL and len(digests) == 1 and cols == {2981},
          f"mesh large seq model: losses {got} against one process "
          f"{fp32_ref} (rel {worst}), digests {digests}, columns {cols}")
    b = seqm[0]["fp32"]
    print(f"# mesh large seq model [{card}]: model=3 x seq=2 on six ranks of "
          f"one card over gloo, 2 blocks, float32, deterministic cuDNN, "
          f"identity corruption, every rank the 8 rows (512 positions a "
          f"seq rank): 2981 GO columns stored a rank, gathered whole for "
          f"the seq step's forward; the replicated leaves' digest after "
          f"{MESH_STEPS} steps equal on the six ranks; losses {got} against "
          f"one process {fp32_ref}, max rel {worst:.3g} (<= "
          f"{MESH_FP32_TOL}); step ms rank 0 "
          f"{[round(st[0], 1) for st in b['steps']]}; state bytes a rank "
          f"{b['per_chip']}; wire bytes a step a rank: " + ", ".join(
              f"{k} {v / MESH_STEPS:.0f}" for k, v in b["wire"].items()
              if v) + f"; leg {seqm[0]['wall_s']:.1f} s")
    return seq_fp32


QUANT_BOUNDS = {"fp32": 1e-6, "bf16": 5e-4, "int8": 1e-3}
# The reduction's own error, relative: the gradient norm against the fp32
# step's, and each leaf's first moment against the fp32 step's (the
# bounds of tests/test_torch_fsdp.py). The params' bound alone cannot
# fail: the first Adam update is lr·sign(g), ~2·lr apart at most.
QUANT_NORM_REL = {"fp32": 1e-6, "bf16": 2e-4, "int8": 5e-4}
QUANT_MU_REL = {"fp32": 1e-6, "bf16": 5e-3, "int8": 2.5e-2}
QUANT_WIRE = {"int8": 0.27, "bf16": 0.52}   # of the fp32 reduction's wire


def mesh_quant(card: str, fsdp: list, per_step: dict, add) -> None:
    """(a'): the fsdp ranks' quantized legs — at MESH_BLOCKS in bf16 through
    `pretrain` (launches and state bytes gated with the other legs), their
    gradient-reduction wire bytes against the fp32 reduce-scatter of the
    bf16 leg; at depth 2 in float32, each payload's params after 2 steps
    against the fp32 sharded step's within the JAX quantization test's
    bounds, its gradient norms and first moments within QUANT_NORM_REL
    and QUANT_MU_REL of that step's, the ranks alike."""
    from proteinbert_tpu_torch.kernels import ATTENTION, LOCAL_TRACK_TILED
    from proteinbert_tpu_torch.parallel.zero import (
        grad_reduce_wire_bytes as grad_wire,
    )

    a = fsdp[0]
    fp32_wire = grad_wire(a["bf16"]["wire"])
    ratios = {p: grad_wire(a[f"q_{p}"]["wire"]) / fp32_wire
              for p in QUANT_WIRE}
    check(all(ratios[p] <= QUANT_WIRE[p] for p in QUANT_WIRE),
          f"mesh large fsdp quant: gradient-reduction wire ratios {ratios}")
    errs, norm_rel, mu_rel = {}, {}, {}
    for r, res in enumerate(fsdp):
        q = res["quant2"]
        for p in QUANT_BOUNDS:
            norm_rel[p] = max(abs(a / b - 1) for a, b in
                              zip(q[p]["norms"], q["ref"]["norms"]))
            mu_rel[p] = max(q[p]["mu_rel"])
            check(norm_rel[p] <= QUANT_NORM_REL[p]
                  and mu_rel[p] <= QUANT_MU_REL[p]
                  and (p == "fp32" or min(q[p]["mu_rel"]) > 0)
                  and q[p]["norms"] == fsdp[0]["quant2"][p]["norms"],
                  f"mesh large fsdp quant {p} rank {r}: gradient norms "
                  f"{q[p]['norms']} against the fp32 step's "
                  f"{q['ref']['norms']} (rel {norm_rel[p]:.3g}, bound "
                  f"{QUANT_NORM_REL[p]}; rank 0 "
                  f"{fsdp[0]['quant2'][p]['norms']}); first moments max "
                  f"leaf rel {mu_rel[p]:.3g} (bound {QUANT_MU_REL[p]})")
            got = q[p]["launches"]
            want = {LOCAL_TRACK_TILED.name: 4, ATTENTION.name: 4}
            check(got == want, f"mesh large fsdp quant {p} rank {r}: "
                               f"launches {got}, want {want}")
            add(got)
            check(q[p]["err"] <= QUANT_BOUNDS[p]
                  and (p == "fp32" or q[p]["err"] > 0)
                  and q[p]["err"] == fsdp[0]["quant2"][p]["err"],
                  f"mesh large fsdp quant {p} rank {r}: max |param - fp32 "
                  f"step| {q[p]['err']} (bound {QUANT_BOUNDS[p]}; rank 0 "
                  f"{fsdp[0]['quant2'][p]['err']})")
            errs[p] = q[p]["err"]
        add(q["ref"]["launches"])
    q = a["quant2"]
    print(f"# mesh large fsdp quant [{card}]: fsdp=2 on two ranks of one "
          f"card over gloo, ZeRO-1, the quantized reduce-scatter over "
          f"data·fsdp; {MESH_BLOCKS} of 12 blocks bf16 ({MESH_BLOCKS} #2 + "
          f"{MESH_BLOCKS} K2 a step a rank), "
          f"{MESH_STEPS} steps: losses int8 "
          f"{[round(s[1], 5) for s in a['q_int8']['steps']]}, bf16 "
          f"{[round(s[1], 5) for s in a['q_bf16']['steps']]} (fp32 "
          f"reduction {[round(s[1], 5) for s in a['bf16']['steps']]}); "
          f"step ms int8 {[round(s[0], 1) for s in a['q_int8']['steps']]}, "
          f"bf16 {[round(s[0], 1) for s in a['q_bf16']['steps']]}; "
          f"gradient-reduction wire bytes a step a rank: fp32 "
          f"reduce-scatter {fp32_wire / MESH_STEPS:.0f}, int8 "
          f"{grad_wire(a['q_int8']['wire']) / MESH_STEPS:.0f} "
          f"({ratios['int8']:.4f}), bf16 "
          f"{grad_wire(a['q_bf16']['wire']) / MESH_STEPS:.0f} "
          f"({ratios['bf16']:.4f}); state bytes a rank (ZeRO-1) "
          f"{a['q_int8']['per_chip']}, stored {a['q_int8']['stored']}, "
          f"memory_allocated after each step "
          f"{[s[3] for s in a['q_int8']['steps']]}, peak "
          f"{a['q_int8']['peak']}; all wire a step a rank (int8): "
          + ", ".join(f"{k} {v / MESH_STEPS:.0f}"
                      for k, v in a["q_int8"]["wire"].items() if v)
          + f". Depth 2 float32, 2 steps (LR 0, then 1e-4), against the "
          f"fp32 sharded step (its max update {q['ref_update']:.3g}): max "
          f"|param diff| " + ", ".join(
              f"{p} {errs[p]:.3g} (<= {QUANT_BOUNDS[p]})"
              for p in QUANT_BOUNDS)
          + "; gradient norm rel " + ", ".join(
              f"{p} {norm_rel[p]:.3g} (<= {QUANT_NORM_REL[p]})"
              for p in QUANT_BOUNDS)
          + "; first moments max leaf rel " + ", ".join(
              f"{p} {mu_rel[p]:.3g} (<= {QUANT_MU_REL[p]})"
              for p in QUANT_BOUNDS)
          + "; wire a step a rank " + ", ".join(
              f"{p} {q[p]['wire'] / 2:.0f}" for p in QUANT_BOUNDS)
          + f" (int8 / fp32 payload {q['int8']['wire'] / q['fp32']['wire']:.4f})")


def reshard_source(leg: str) -> dict:
    """The mesh axes of the `leg` run whose step 2 is resharded."""
    return {"fsdp": 2, "seq": 2 if leg == "seqfsdp" else 1}


def reshard_start(root: str, cfg, leg: str):
    """(c): `reshard --target-mesh 1` of the `leg` run's step 2 (fsdp=2,
    or fsdp=2 x seq=2 for "seqfsdp") started as a subprocess; a thread
    notes when it exits (`proc.t0`, `proc.ended`)."""
    from proteinbert_tpu_torch.configs import save_config

    src = os.path.join(root, f"ck_{leg}")
    save_config(cfg.replace(mesh=dataclasses.replace(
        cfg.mesh, **reshard_source(leg))), os.path.join(src, "config.json"))
    proc = cli_spawn(["reshard", "--src", src, "--output",
                      os.path.join(root, f"one_{leg}"), "--target-mesh", "1",
                      "--step", 2, "--events-jsonl",
                      os.path.join(root, f"reshard_{leg}.jsonl")],
                     os.path.join(root, f"reshard_{leg}.log"))
    proc.t0, proc.ended = time.perf_counter(), []
    proc.waiter = threading.Thread(
        target=lambda: (proc.wait(), proc.ended.append(time.perf_counter())),
        daemon=True)
    proc.waiter.start()
    return proc


def mesh_reshard(card: str, root: str, cfg, batches, fsdp_losses,
                 leg: str, proc) -> None:
    """(c): the `reshard_start` subprocess's exit, summary and event, then
    one process resumes the resharded step 2 for step 3."""
    from proteinbert_tpu_torch.train import Checkpointer

    dst = os.path.join(root, f"one_{leg}")
    events = os.path.join(root, f"reshard_{leg}.jsonl")
    log = os.path.join(root, f"reshard_{leg}.log")
    label = {"fsdp": "mesh large reshard",
             "seqfsdp": "mesh large seq fsdp reshard"}[leg]
    source = reshard_source(leg)
    rc = cli_exit(proc, "reshard")
    proc.waiter.join()
    wall = proc.ended[0] - proc.t0
    said = open(log).read()
    summary = json.loads([t for t in said.splitlines()
                          if t.startswith("{")][-1]) if "{" in said else {}
    from proteinbert_tpu_torch.obs import read_events

    recs = [e for e in read_events(events, strict=True)
            if e["event"] == "reshard"] if os.path.exists(events) else []
    check(rc == 0 and summary.get("parity") is True and len(recs) == 1
          and summary["schedule"] == "host_staged"
          and summary["source_mesh"] == {"data": 1, "model": 1, **source},
          f"{label}: exit {rc}, summary {summary}, events "
          f"{recs}; log tail {said[-2000:]}")
    ck = Checkpointer(dst, async_save=False)
    run, steps, _, _ = mesh_train(cfg, batches, checkpointer=ck)
    ck.close()
    check(len(steps) == 1 and abs(steps[0][1] - fsdp_losses[2])
          <= MESH_FP32_TOL * abs(fsdp_losses[2]),
          f"{label}: resumed step losses {[s[1] for s in steps]}"
          f" against the {leg} run's step 3 {fsdp_losses[2]}")
    nbytes = os.path.getsize(os.path.join(dst, "2", "state.pt"))
    print(f"# {label} [{card}]: python -m proteinbert_tpu_torch "
          f"reshard --target-mesh 1 --step 2 of the {source} float32 run "
          f"(depth 2): exit {rc}, {wall:.1f} s from spawn (both reshards "
          f"side by side, beside the one-process references), parity "
          f"{summary['parity']}, schedule {summary['schedule']}, wire bytes "
          f"{summary['wire_bytes']['total']}, state.pt {nbytes} bytes, the "
          f"event valid; one process resumed it on the card: step 3 loss "
          f"{steps[0][1]} against the {leg} run's {fsdp_losses[2]}")


# The eval phase: `base` at full width, bf16, deterministic cuDNN (the
# two brackets must repeat each other bit for bit), B=8 L=512.
EVAL_STEPS = 30
EVAL_EVERY = 10
EVAL_BATCHES = 8          # eval batches of 8 x 512 a bracket
EVAL_LOG_EVERY = 5
EVAL_STALL_S = 2.0        # seconds each drill injects
EVAL_STALL_OVER = 1.5     # the stalled window's wall over the median (s)
EVAL_WINDOW_RATIO = 1.5   # eval-stall drill: every window within x median
RECORD_TIMING = ("steps_per_sec", "step_ms", "residues_per_sec_per_chip",
                 "mfu", "overlap_s", "ckpt_in_flight")


def eval_cfg(overlap: bool):
    """`base` at B=8 L=512 for EVAL_STEPS steps at a constant LR, logged
    every EVAL_LOG_EVERY, an eval every EVAL_EVERY on `overlap`'s
    bracket; batches made inline (no prefetch thread)."""
    cfg = train_preset("base", 8, 512, EVAL_STEPS)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, prefetch_depth=0),
        optimizer=dataclasses.replace(cfg.optimizer, schedule="constant",
                                      warmup_steps=0),
        train=dataclasses.replace(cfg.train, log_every=EVAL_LOG_EVERY,
                                  eval_every=EVAL_EVERY,
                                  overlap_eval=overlap))


class EvalProbe:
    """One run's eval brackets measured from outside the trainer: its
    StepTimer replaced by a subclass that stamps every `update()` and
    adds up `discount()`; the bracket's entry points wrapped (the
    synchronous `evaluate`, or the overlapped `dispatch_eval` and
    `resolve_eval`) to time each call on the host and on the card (CUDA
    events around it) and to count its host waits: the synchronizing
    calls torch's sync-debug mode flags plus `torch.cuda.Event.
    synchronize` calls. The overlapped dispatch runs under
    `set_sync_debug_mode("error")`: a synchronizing op in it raises."""

    def __init__(self, overlap: bool):
        self.overlap = overlap
        self.updates, self.discounted = [], 0.0
        self.brackets, self.resolves = [], []
        self._waits = 0

    def _measured(self, fn, strict: bool, out: list):
        import warnings

        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            waits0 = self._waits
            t0 = time.perf_counter()
            start.record()
            with warnings.catch_warnings(record=True) as flagged:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("error" if strict else "warn")
                try:
                    result = fn(*a, **kw)
                except RuntimeError as e:
                    check(not strict, f"eval base: the overlapped dispatch "
                                      f"synchronized: {e}")
                    raise
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            end.record()
            syncs = sum("synchroniz" in str(w.message) for w in flagged)
            out.append({"t0": t0, "t1": time.perf_counter(),
                        "events": (start, end),
                        "syncs": syncs + self._waits - waits0})
            return result

        return run

    def __enter__(self):
        from proteinbert_tpu_torch.train import trainer as tr

        self.tr = tr
        self.saved = (tr.StepTimer, tr.evaluate, tr.dispatch_eval,
                      tr.resolve_eval, torch.cuda.Event.synchronize)
        probe, base = self, tr.StepTimer

        class Timer(base):
            def update(self):
                super().update()
                probe.updates.append(time.perf_counter())

            def discount(self, seconds):
                probe.discounted += seconds
                super().discount(seconds)

        wait = torch.cuda.Event.synchronize

        def counted(event):
            probe._waits += 1
            return wait(event)

        tr.StepTimer = Timer
        torch.cuda.Event.synchronize = counted
        if self.overlap:
            tr.dispatch_eval = self._measured(tr.dispatch_eval, True,
                                              self.brackets)
            tr.resolve_eval = self._measured(tr.resolve_eval, False,
                                             self.resolves)
        else:
            tr.evaluate = self._measured(tr.evaluate, False, self.brackets)
        return self

    def __exit__(self, *exc):
        tr = self.tr
        (tr.StepTimer, tr.evaluate, tr.dispatch_eval, tr.resolve_eval,
         torch.cuda.Event.synchronize) = self.saved
        torch.cuda.set_sync_debug_mode(0)

    def summary(self) -> dict:
        """Per bracket: host s of the boundary call, its wall to the next
        step's update (s), the eval's device ms, the resolve's host s and
        the host waits of each."""
        torch.cuda.synchronize()
        rows = []
        for i, b in enumerate(self.brackets):
            nxt = next((t for t in self.updates if t > b["t1"]), None)
            row = {"call_s": b["t1"] - b["t0"],
                   "to_next_update_s": (nxt - b["t0"]) if nxt else None,
                   "device_ms": b["events"][0].elapsed_time(b["events"][1]),
                   "syncs": b["syncs"]}
            if i < len(self.resolves):
                r = self.resolves[i]
                row.update(resolve_s=r["t1"] - r["t0"],
                           resolve_syncs=r["syncs"])
            rows.append(row)
        gaps = np.diff(self.updates[2:]) * 1e3
        # Step intervals with no bracket or resolve inside them.
        marks = [b["t0"] for b in self.brackets + self.resolves]
        plain = [g for g, a, z in zip(gaps, self.updates[2:-1],
                                      self.updates[3:])
                 if not any(a <= t <= z for t in marks)]
        return {"brackets": rows, "discounted_s": self.discounted,
                "median_step_ms": float(np.median(plain))}


def eval_run(card: str, label: str, overlap: bool, ds, evals, root: str,
             env=None) -> dict:
    """One seeded `pretrain` of `eval_cfg(overlap)` under an `EvalProbe`
    (and the drill knobs of `env`): exactly 6·(T + E·N) K1 and K2
    launches; → the history, the eval events, the probe's summary."""
    from proteinbert_tpu_torch.data.dataset import make_pretrain_iterator
    from proteinbert_tpu_torch.kernels import ATTENTION, KERNELS, LOCAL_TRACK
    from proteinbert_tpu_torch.obs import Telemetry, read_events
    from proteinbert_tpu_torch.train.trainer import pretrain

    cfg = eval_cfg(overlap)
    events = os.path.join(root, f"{label.replace(' ', '_')}.jsonl")
    tele = Telemetry(events_path=events)
    for k, v in (env or {}).items():
        os.environ[k] = v
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    try:
        with EvalProbe(overlap) as probe:
            out = pretrain(cfg, make_pretrain_iterator(ds, 8, seed=21),
                           eval_batches=lambda: iter(evals), telemetry=tele,
                           device=DEVICE)
    finally:
        for k in env or {}:
            os.environ.pop(k, None)
        tele.close()
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    n = 6 * (EVAL_STEPS + (EVAL_STEPS // EVAL_EVERY) * EVAL_BATCHES)
    check(launches == {LOCAL_TRACK.name: n, ATTENTION.name: n},
          f"eval base {label}: launches {launches}, want {n} K1 and {n} K2")
    evs = [e for e in read_events(events, strict=True)
           if e["event"] == "eval"]
    check([e["step"] for e in evs] == [10, 20, 30]
          and all(bool(e.get("overlapped")) == overlap for e in evs),
          f"eval base {label}: eval events {[e['step'] for e in evs]}")
    return {"history": out["history"], "events": evs,
            "probe": probe.summary(), "launches": launches}


def eval_windows(history) -> list:
    """(last step, window step ms, window wall s) of each log point."""
    out = []
    prev = 2   # the timer's two warm-up steps
    for h in history:
        if "window_step_ms" in h:
            out.append((h["step"], h["window_step_ms"],
                        h["window_step_ms"] * (h["step"] - prev) / 1e3))
            prev = h["step"]
    return out


def eval_phase(card: str) -> dict:
    """Phase 15 (module docstring) → each kernel's launches."""
    from proteinbert_tpu_torch.data.dataset import InMemoryPretrainingDataset
    from proteinbert_tpu_torch.train.train_state import create_train_state
    from proteinbert_tpu_torch.train.trainer import evaluate

    cfg = eval_cfg(False)
    seqs, ann = synthetic_proteins(4 * 8 + EVAL_BATCHES * 8, 100, 510,
                                   cfg.model.num_annotations, 21)
    ds = InMemoryPretrainingDataset(seqs[:32], ann[:32], 512)
    held = InMemoryPretrainingDataset(seqs[32:], ann[32:], 512)
    evals = [held.get_batch(np.arange(8 * b, 8 * b + 8))
             for b in range(EVAL_BATCHES)]
    root = tempfile.mkdtemp(prefix="eval_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    totals: dict = {}
    runs = {}
    deterministic(True)
    try:
        # One untimed eval first, so that the first timed bracket of the
        # first route does not also pay the eval shapes' warm-up.
        warm = create_train_state(torch.Generator().manual_seed(21), cfg,
                                  device=DEVICE)
        evaluate(warm, evals, cfg, 0)
        torch.cuda.synchronize()
        del warm
        for label, overlap, kw in (
                ("sync", False, {}), ("overlapped", True, {}),
                ("drill stall", True, {"env": {
                    "PBT_FAULT_STALL_AT": f"15:{EVAL_STALL_S}"}}),
                ("drill eval stall sync", False, {"env": {
                    "PBT_FAULT_EVAL_STALL": str(EVAL_STALL_S)}}),
                ("drill eval stall overlapped", True, {"env": {
                    "PBT_FAULT_EVAL_STALL": str(EVAL_STALL_S)}})):
            runs[label] = r = eval_run(card, label, overlap, ds, evals, root,
                                       **kw)
            for name, n in r["launches"].items():
                totals[name] = totals.get(name, 0) + n
    finally:
        deterministic(False)
        shutil.rmtree(root, ignore_errors=True)

    def values(history):
        return [{k: v for k, v in h.items() if not k.startswith("window_")
                 and k not in RECORD_TIMING} for h in history]

    sync, over = runs["sync"], runs["overlapped"]
    same = values(over["history"]) == values(sync["history"])
    same_events = ([(e["step"], e["metrics"]) for e in over["events"]]
                   == [(e["step"], e["metrics"]) for e in sync["events"]])
    check(same and same_events,
          f"eval base: overlapped records {values(over['history'])[-3:]} "
          f"against synchronous {values(sync['history'])[-3:]}")
    for label in ("sync", "overlapped"):
        p = runs[label]["probe"]
        b = p["brackets"]
        print(f"# eval base {label} [{card}]: 6 blocks C=G=512 H=8 bf16, "
              f"B=8 L=512, {EVAL_STEPS} steps, an eval of {EVAL_BATCHES} "
              f"batches of 8x512 every {EVAL_EVERY}, deterministic cuDNN; "
              f"median step ms {p['median_step_ms']:.2f}; a boundary: "
              f"boundary call s {[round(x['call_s'], 4) for x in b]}, "
              f"wall to the next step's update s "
              f"{[x['to_next_update_s'] and round(x['to_next_update_s'], 4) for x in b]}, eval "
              f"device ms {[round(x['device_ms'], 2) for x in b]}, host "
              f"waits {[x['syncs'] for x in b]}"
              + (f", resolve s {[round(x['resolve_s'], 4) for x in b]} "
                 f"(waits {[x['resolve_syncs'] for x in b]})"
                 if "resolve_s" in b[0] else "")
              + f"; discounted s {p['discounted_s']:.4f}; windows (step, "
              f"window step ms) "
              f"{[(w[0], round(w[1], 2)) for w in eval_windows(runs[label]['history'])]}"
              + ("; records bit for bit the synchronous run's"
                 if label != "sync" else ""))
    # The drills: a stall at step 15 is the 11-15 window's; an eval stall
    # moves no window, on either bracket.
    wins = eval_windows(runs["drill stall"]["history"])
    walls = [w[2] for w in wins]
    slow = max(wins, key=lambda w: w[1])
    over_med = dict((w[0], w[2]) for w in wins)[15] - statistics.median(walls)
    check(slow[0] == 15 and over_med > EVAL_STALL_OVER,
          f"eval base drill stall: windows {wins}; the slowest ends at "
          f"{slow[0]}, the 11-15 window {over_med:.3f} s over the median")
    lines = [f"stall {EVAL_STALL_S} s at step 15: the 11-15 window the "
             f"slowest, {over_med:.3f} s over the median window wall"]
    for label in ("drill eval stall sync", "drill eval stall overlapped"):
        wins = eval_windows(runs[label]["history"])
        med = statistics.median(w[1] for w in wins)
        worst = max(w[1] for w in wins) / med
        check(worst <= EVAL_WINDOW_RATIO,
              f"eval base {label}: windows {wins}, worst {worst:.3f}x the "
              f"median")
        lines.append(f"eval stall {EVAL_STALL_S} s, "
                     f"{label.split()[-1]}: worst window {worst:.3f}x the "
                     f"median, discounted s "
                     f"{runs[label]['probe']['discounted_s']:.3f}")
    print(f"# eval base drills [{card}]: " + "; ".join(lines))
    return totals


def main() -> int:
    args = sys.argv[1:]
    if args not in ([], ["--phase", "large"], ["--phase", "base"],
                    ["--phase", "k2"], ["--phase", "default"],
                    ["--phase", "f32"],
                    ["--phase", "resume"], ["--phase", "serve"],
                    ["--phase", "serve-times"], ["--phase", "finetune"],
                    ["--phase", "neighbors"], ["--phase", "rollout"],
                    ["--phase", "cli"], ["--phase", "data"],
                    ["--phase", "etl"], ["--phase", "check"],
                    ["--phase", "mesh"], ["--phase", "eval"],
                    ["--phase", "coverage"], ["--cli-first"]):
        print("usage: chip_smoke.py [--cli-first | --phase large|base|k2|"
              "default|f32|resume|serve|serve-times|finetune|neighbors|"
              "rollout|cli|data|etl|check|mesh|eval|coverage]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from proteinbert_tpu_torch.kernels import (
        ATTENTION, ATTENTION_Q8, KERNELS, LOCAL_TRACK, LOCAL_TRACK_SEGMENTS,
        LOCAL_TRACK_SEGMENTS_Q8, LOCAL_TRACK_SEGMENTS_TILED,
        LOCAL_TRACK_TILED, LOCAL_TRACK_TILED_VALID, LOCAL_TRACK_VALID,
        ONEPASS, ONEPASS_Q8,
    )
    from proteinbert_tpu_torch.kernels.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build_all(KERNELS)
    print(f"# build: {time.perf_counter() - t0:.1f} s")
    for k in KERNELS:
        regs = [int(w) for w in re.findall(r"Used (\d+) registers",
                                           k.ptxas_log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             k.ptxas_log)]
        print(f"#   {k.name}: {len(regs)} instantiations, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores "
              f"max {max(spills, default=0)} bytes")
        for name, regs, spill in ptxas_functions(k.ptxas_log):
            if "wgmma" in name or spill:
                print(f"#     {name}: {regs} registers, spill stores "
                      f"{spill} bytes")
        for line in k.ptxas_log.splitlines():
            if "serialized" in line or "arning" in line:
                print(f"#     ptxas: {line.strip()}")   # e.g. wgmma waits
    if args in (["--phase", "base"], ["--phase", "k2"]):
        base_phase(card)
        return 0
    if args == ["--phase", "default"]:
        default_phase(card)
        return 0
    if args == ["--phase", "f32"]:
        f32_phase(card)
        return 0
    if args == ["--phase", "resume"]:
        resume_phase(card)
        return 0
    if args == ["--phase", "finetune"]:
        t0 = time.perf_counter()
        task_phases(card)
        print(f"# finetune and predict_task: {time.perf_counter() - t0:.1f} s")
        return 0
    if args == ["--phase", "neighbors"]:
        t0 = time.perf_counter()
        neighbors_phase(card)
        print(f"# neighbors: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        large_int8_phase(card)
        print(f"# serve large int8: {time.perf_counter() - t0:.1f} s")
        return 0
    if args == ["--phase", "rollout"]:
        t0 = time.perf_counter()
        rollout_phase(card)
        print(f"# rollout: {time.perf_counter() - t0:.1f} s")
        return 0
    if args == ["--phase", "cli"]:
        t0 = time.perf_counter()
        cli_phase(card)
        print(f"# cli: {time.perf_counter() - t0:.1f} s")
        return 0
    if args == ["--phase", "data"]:
        t0 = time.perf_counter()
        data_phase(card)
        print(f"# data: {time.perf_counter() - t0:.1f} s")
        return 0
    if args == ["--phase", "etl"]:
        t0 = time.perf_counter()
        etl_phase(card)
        print(f"# etl: {time.perf_counter() - t0:.1f} s")
        return 0
    if args == ["--phase", "check"]:
        t0 = time.perf_counter()
        check_phase(card)
        print(f"# check: {time.perf_counter() - t0:.1f} s")
        return 0
    if args == ["--phase", "mesh"]:
        t0 = time.perf_counter()
        mesh_phase(card)
        print(f"# mesh: {time.perf_counter() - t0:.1f} s")
        return 0
    if args == ["--phase", "eval"]:
        t0 = time.perf_counter()
        eval_phase(card)
        print(f"# eval: {time.perf_counter() - t0:.1f} s")
        return 0
    if args == ["--phase", "coverage"]:
        t0 = time.perf_counter()
        coverage_phase(card)
        print(f"# coverage: {time.perf_counter() - t0:.1f} s")
        return 0
    if args in (["--phase", "serve"], ["--phase", "serve-times"]):
        t0 = time.perf_counter()
        serve_phases(card, gates=args[1] == "serve")
        print(f"# serve: {time.perf_counter() - t0:.1f} s")
        return 0
    sass_line(card, (LOCAL_TRACK, LOCAL_TRACK_VALID, LOCAL_TRACK_SEGMENTS,
                     LOCAL_TRACK_SEGMENTS_Q8, LOCAL_TRACK_TILED,
                     LOCAL_TRACK_SEGMENTS_TILED, LOCAL_TRACK_TILED_VALID,
                     ATTENTION, ATTENTION_Q8, ONEPASS, ONEPASS_Q8))
    if args == ["--phase", "large"]:
        # The Large-width local-track kernels alone: gates, times, passes.
        rows = {}
        large_kernel_phase(card, rows)
        valid_kernel_phase(card, rows)
        print_rows(card, rows)
        gemm_yardstick(card)
        return 0

    if args == ["--cli-first"]:
        # The CLI phase once more before everything else, its launches not
        # counted: its numbers beside the last phase's on one card.
        t0 = time.perf_counter()
        cli_phase(card)
        print(f"# cli first: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows = kernel_phase(card)
    packed_kernel_phase(card, rows)
    large_kernel_phase(card, rows)
    valid_kernel_phase(card, rows)
    q8_extra = q8_kernel_phase(card, rows)
    print_rows(card, rows)
    print_q8_rows(card, rows, q8_extra)
    gemm_yardstick(card)
    print(f"# kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grad_phase(card)
    reference_phase()
    reference_step_phase(card)
    packed_reference_phase(card)
    ragged_parity_phase()
    q8_reference_phase()
    print(f"# gradients and references: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = serve_phases(card)
    print(f"# serve: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in train_phases(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in long_hdf5_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# train long hdf5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in resume_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# resume: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in task_phases(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# finetune and predict_task: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in neighbors_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# neighbors: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in large_int8_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# serve large int8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in rollout_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# rollout: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in cli_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# cli: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in data_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# data: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in etl_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# etl: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in check_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# check: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in mesh_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# mesh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in eval_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"# eval: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cover_rows, cover_launches = coverage_phase(card)
    for name, n in cover_launches.items():
        launches[name] = launches.get(name, 0) + n
    print(f"# coverage: {time.perf_counter() - t0:.1f} s")
    host_census("end of run")

    # (source, TPU launch site, the served shape its row was timed at)
    ported = {
        LOCAL_TRACK.name: (
            "proteinbert_tpu_torch/csrc/local_track.cu",
            "proteinbert_tpu/kernels/fused_block.py:804", 512, "dense",
            "B=8 L=512 C=512 bf16"),
        LOCAL_TRACK_SEGMENTS.name: (
            "proteinbert_tpu_torch/csrc/local_track_segments.cu",
            "proteinbert_tpu/kernels/fused_block.py:1134", 512, "S=8",
            "B=8 L=512 C=512 S=8 bf16"),
        ATTENTION.name: (
            "proteinbert_tpu_torch/csrc/global_attention.cu",
            "proteinbert_tpu/kernels/attention.py:319", 512, "dense",
            "B=8 L=512 C=G=512 H=8 k=64 S=1 bf16"),
        ONEPASS.name: (
            "proteinbert_tpu_torch/csrc/one_pass.cu",
            "proteinbert_tpu/kernels/one_pass.py:380", 512, "C=128 S=8",
            "B=8 L=512 C=128 G=512 H=4 k=64 v=128 S=8 bf16"),
        LOCAL_TRACK_TILED.name: (
            "proteinbert_tpu_torch/csrc/local_track_tiled.cu",
            "proteinbert_tpu/kernels/fused_block.py:881", 1024, "dense",
            "B=8 L=1024 C=1024 bf16"),
        LOCAL_TRACK_SEGMENTS_TILED.name: (
            "proteinbert_tpu_torch/csrc/local_track_segments_tiled.cu",
            "proteinbert_tpu/kernels/fused_block.py:1220", 1024, "S=8",
            "B=8 L=1024 C=1024 S=8 bf16"),
        LOCAL_TRACK_SEGMENTS_Q8.name: (
            "proteinbert_tpu_torch/csrc/local_track_segments_q8.cu",
            "proteinbert_tpu/kernels/fused_block.py:1134", 512, "S=8",
            "B=8 L=512 C=512 S=8 bf16, int8 weights"),
        ATTENTION_Q8.name: (
            "proteinbert_tpu_torch/csrc/global_attention_q8.cu",
            "proteinbert_tpu/kernels/attention.py:319", 512, "dense",
            "B=8 L=512 C=G=512 H=8 k=64 S=1 bf16, int8 weights"),
        ONEPASS_Q8.name: (
            "proteinbert_tpu_torch/csrc/one_pass_q8.cu",
            "proteinbert_tpu/kernels/one_pass.py:380", 512, "C=128 S=8",
            "B=8 L=512 C=128 G=512 H=4 k=64 v=128 S=8 bf16, int8 weights"),
        LOCAL_TRACK_VALID.name: (
            "proteinbert_tpu_torch/csrc/local_track_valid.cu",
            "proteinbert_tpu/kernels/fused_block.py:804", 512, "shard",
            "B=16 L=512+2*20 C=512 bf16, prehaloed"),
        LOCAL_TRACK_TILED_VALID.name: (
            "proteinbert_tpu_torch/csrc/local_track_tiled_valid.cu",
            "proteinbert_tpu/kernels/fused_block.py:881", 256, "shard",
            "B=8 L=256+2*20 C=1024 bf16, prehaloed"),
    }
    report = []
    for k in KERNELS:
        src, tpu, L, case, shape = ported[k.name]
        err, ms, plain, b_ms, b_by, _ = rows[(k.name, torch.bfloat16, L,
                                              case)]
        check(launches[k.name] > 0, f"{k.name} never launched on a served "
                                    "or trained path")
        row = {"name": k.name, "route": "cuda", "source": src,
               "replaces": tpu, "launches": launches[k.name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "status": "ported", "shape": shape}
        key = (k.name, torch.bfloat16, L, case)
        if key in q8_extra:  # an int8 leg: its fp leg's time on the same call
            row["fp_leg_ms"] = q8_extra[key][1]
        row["widths"] = coverage_widths(k.name, cover_rows)
        report.append(row)
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())


